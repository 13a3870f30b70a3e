// The v3 backward of the training-mode fused stage on Hopper (sm_90a): the
// port of the TPU kernels of ssunet_gan_tpu/ops/train_bwd.py, which run the
// backward's pointwise and BatchNorm chains inside the convs next to them:
//
//   fused_conv3  <- fused_conv3_call (:167, body _make_fused_kernel :60)
//       out = epilogue(conv3x3(prologue(src))), stat rows of the epilogue's
//       values. The TPU kernel takes Python callables for the prologue and
//       epilogue; here each chain is a mode of the conv core
//       (stage_common.cuh ConvMode), one instantiation each:
//         gamma   CONV_STD      round(conv(actv) + b)
//         modgrad CONV_MODGRAD  input [round(g0*y) ; g0] as two K-segments of
//                               g0, the first multiplied by y at the same
//                               pixel; out = where(actv > 0, round(acc), 0), sum
//         seg     CONV_STD      round(acc), (sum, sum of squares), sum kept
//         pre     CONV_PRE      gp = where(y > 0, g0*(1+gamma) + round(acc));
//                               out round(gp); sums of gp, gp*xhat2 (unrounded),
//                               g0*y, g0 over the bands g0, gamma, y, f2
//         bn2     CONV_BN2      input round(p*(g - q - (f*r' - m'))) from g_pre
//                               and f2; gn = where(f1*a1 + b1 > 0, round(acc), 0);
//                               sums of gn, gn*xhat1
//         bn1     CONV_BN1      input as bn2 from g_n1 and f1 (3x3 segment),
//                               then g_pre through the 1x1 shortcut's weight as
//                               a second K-segment added to the rounded 3x3 sum;
//                               each part's gradient through its own pointer
//   fused_wgrad  <- fused_wgrad_call (:374, body _make_wgrad_fused_kernel :291)
//       dW of a 3x3 conv whose input is the saved tensor (optionally
//       relu(x*a + b), conv2's input) and whose cotangent is rebuilt in the
//       loader: as it is (G_RAW), [round(g0*y) ; g0] (G_MODGRAD) or the
//       BN-backward chain (G_BN); train_common.cuh's core, one instantiation
//       each.
//
// What bounds them on the H100: the backward-data convs and the weight
// gradients carry the backward's multiply-adds at an arithmetic intensity
// far above the bf16 ridge point (~295 FLOP/byte), so they are bound by
// tensor-core operations; the chains themselves are bytes (the f32 tensors
// the v2 backward wrote and read between the convs). The design keeps every
// chain out of device memory: prologues run in the loaders on the values
// that go into shared memory, epilogues on the accumulators, and the stat
// rows are reduced per block and summed by stats_reduce_kernel, so the
// backward writes only the bf16 tensors the next conv reads. The conv and
// weight-gradient cores are the train stage's mma.sync m16n8k16 implicit
// GEMMs (the 64-wide N tile is wasteful on the 3/4/8/16-channel convs);
// wgmma/TMA pipelines come later (ROADMAP.md). Each chain is rebuilt
// wherever its input is read (per tap and per 64-channel output block in
// the conv, per 64-column block of dW in the weight gradient), which makes
// the BN-chain modes 2-3x the plain modes on the same products.
//
// Numerics follow the TPU kernels and the port's plain versions
// (ops/train_bwd.py): each conv zero-pads its own input at the image
// border, so a prologue runs on in-image pixels only and padded channels
// stay 0; the f32 chain arithmetic rounds each operation (no fused
// multiply-adds) as the plain version does; bf16 roundings at the JAX
// package's points; masks compare f32 values of bf16 tensors.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "train_common.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(CONV_THREADS)
fused_conv3_kernel(const ConvArgs args, const ChainArgs chain) {
  conv_body<MODE>(args, chain);
}

template <int GM>
__global__ void __launch_bounds__(WG_THREADS)
fused_wgrad_kernel(const WgradArgs args, const WgradChain chain) {
  wgrad_body<GM>(args, chain);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// ssu_fused_conv3's pointer and integer arguments, by position
// (ops/train_bwd.py _CONV_PTRS, _CONV_INTS)
enum {
  P_SRC0, P_SRC1, P_W, P_BIAS, P_PRO_F, P_CST, P_BAND = P_CST + 8,
  P_OUT0 = P_BAND + 4, P_OUT1, P_PARTIAL, P_STATS
};
enum { I_C0, I_K0, I_C1, I_K1, I_KP, I_N, I_H, I_W, I_COUT, I_SPLIT };

template <int MODE>
cudaError_t launch_conv3(const ConvArgs& a, const ChainArgs& ch, dim3 grid,
                         cudaStream_t stream) {
  fused_conv3_kernel<MODE><<<grid, CONV_THREADS, 0, stream>>>(a, ch);
  return cudaGetLastError();
}

template <int GM>
cudaError_t launch_wgrad(const WgradArgs& a, const WgradChain& wc, dim3 grid,
                         cudaStream_t stream) {
  fused_wgrad_kernel<GM><<<grid, WG_THREADS, 0, stream>>>(a, wc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the per-block partial sums of ssu_fused_conv3 (blocks along M).
long long ssu_conv3_blocks(long long m) { return (m + BM - 1) / BM; }

// One chain-mode conv (mode: a ConvMode). p and d hold the pointers and
// integers named by P_* and I_*; a pointer that a mode does not use may be
// null. With stats (and partial, [rows][cout][ssu_conv3_blocks(m)] f32),
// stats[r][c] is the mode's r-th sum over the pixels.
int ssu_fused_conv3(int mode, void* const* p, const int* d, void* stream) {
  ConvArgs a = {};
  ChainArgs ch = {};
  const void* ptrs[MAX_SRC] = {p[P_SRC0], p[P_SRC1], nullptr};
  const int chans[MAX_SRC] = {d[I_C0], d[I_C1], 0};
  const int ks[MAX_SRC] = {d[I_K0], d[I_K1], 0};
  const int ksum = fill_sources(a.src, MAX_SRC, a.nsrc, ptrs, chans, ks);
  const int cout = d[I_COUT];
  const bool two_src = mode == CONV_MODGRAD || mode == CONV_BN1;
  const bool pro = mode == CONV_MODGRAD || mode == CONV_BN2 || mode == CONV_BN1;
  const int nbands = mode == CONV_PRE ? 4 : (mode == CONV_MODGRAD || mode == CONV_BN2) ? 1 : 0;
  const int ncst = mode == CONV_PRE ? 2 : mode == CONV_BN2 ? 8 : mode == CONV_BN1 ? 4 : 0;
  bool ok = ksum >= 0 && ksum == d[I_KP] && cout >= 1 && aligned16(p[P_W]) &&
            d[I_N] > 0 && d[I_H] > 0 && d[I_W] > 0 && mode >= CONV_STD && mode <= CONV_BN1 &&
            a.nsrc == (two_src ? 2 : 1) && (!pro || p[P_PRO_F] != nullptr) &&
            p[P_OUT0] != nullptr && (p[P_STATS] == nullptr) == (p[P_PARTIAL] == nullptr);
  if (mode == CONV_BN1)
    ok = ok && d[I_SPLIT] >= 1 && d[I_SPLIT] <= cout &&
         (d[I_SPLIT] == cout || p[P_OUT1] != nullptr) && p[P_STATS] == nullptr &&
         a.src[1].ksize == 1 && a.src[1].c == a.src[0].c;
  else
    ok = ok && d[I_SPLIT] == cout;
  if (mode == CONV_MODGRAD) ok = ok && a.src[1].ptr == a.src[0].ptr;
  if (mode == CONV_BN2 || mode == CONV_BN1) ok = ok && a.src[0].cpad <= CHAIN_MAX_C;
  for (int i = 0; i < nbands; ++i) ok = ok && p[P_BAND + i] != nullptr;
  for (int i = 0; i < ncst; ++i) ok = ok && p[P_CST + i] != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;

  a.wt = static_cast<const bf16*>(p[P_W]);
  a.kp = d[I_KP];
  a.bias = static_cast<const float*>(p[P_BIAS]);
  a.out = static_cast<bf16*>(p[P_OUT0]);
  a.partial = static_cast<float*>(p[P_PARTIAL]);
  a.h = d[I_H];
  a.w = d[I_W];
  a.cout = cout;
  a.m = (long long)d[I_N] * d[I_H] * d[I_W];
  ch.pro_f = static_cast<const bf16*>(p[P_PRO_F]);
  ch.pro_vec = a.src[0].c % 8 == 0 && aligned16(p[P_PRO_F]);
  for (int i = 0; i < 8; ++i) ch.cst[i] = static_cast<const float*>(p[P_CST + i]);
  for (int i = 0; i < 4; ++i) ch.band[i] = static_cast<const bf16*>(p[P_BAND + i]);
  ch.out1 = static_cast<bf16*>(p[P_OUT1]);
  ch.split = d[I_SPLIT];
  ch.k_round = (a.src[0].cpad / BK) * 9;

  const long long nb = ssu_conv3_blocks(a.m);
  const dim3 grid((unsigned)nb, (unsigned)((cout + BN - 1) / BN));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  int rows = 0;
  switch (mode) {
    case CONV_STD: e = launch_conv3<CONV_STD>(a, ch, grid, s); rows = 2; break;
    case CONV_MODGRAD: e = launch_conv3<CONV_MODGRAD>(a, ch, grid, s); rows = 1; break;
    case CONV_PRE: e = launch_conv3<CONV_PRE>(a, ch, grid, s); rows = 4; break;
    case CONV_BN2: e = launch_conv3<CONV_BN2>(a, ch, grid, s); rows = 2; break;
    default: e = launch_conv3<CONV_BN1>(a, ch, grid, s); break;
  }
  if (e != cudaSuccess || p[P_STATS] == nullptr) return (int)e;
  stats_reduce_kernel<<<dim3((unsigned)cout, (unsigned)rows), RED_THREADS, 0, s>>>(
      a.partial, nb, cout, static_cast<float*>(p[P_STATS]));
  return (int)cudaGetLastError();
}

// dw[cout][kp] += sum over pixels of cot[p][c] * taps(x)[p][k] (dw zeroed
// by the caller), x = up to two 3x3 sources, the first optionally
// relu(x*a + b); the cotangent (gmode: a GMode) from g and g2, [m][c_g]
// each, and cst (four pointers; G_BN: p, q, r', m').
int ssu_fused_wgrad(int gmode, const void* s0, int c0, const void* s1, int c1,
                    const void* pro_a, const void* pro_b, const void* g, const void* g2,
                    const void* const* cst, int cout, int c_g, void* dw, int kp, int n,
                    int h, int wd, void* stream) {
  WgradArgs a;
  WgradChain wc = {};
  dim3 grid;
  if (!wgrad_setup(a, grid, s0, c0, s1, c1, pro_a, pro_b, cout, kp, n, h, wd) ||
      gmode < G_RAW || gmode > G_BN || g == nullptr ||
      (gmode != G_RAW && g2 == nullptr) ||
      (gmode == G_RAW && c_g != cout) || (gmode == G_MODGRAD && 2 * c_g != cout) ||
      (gmode == G_BN && (c_g != cout || cst[0] == nullptr || cst[1] == nullptr ||
                         cst[2] == nullptr || cst[3] == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.g = static_cast<const bf16*>(g);
  a.gvec = (cout % 8 == 0) && aligned16(g);
  a.dw = static_cast<float*>(dw);
  wc.g2 = static_cast<const bf16*>(g2);
  for (int i = 0; i < 4; ++i) wc.cst[i] = static_cast<const float*>(cst[i]);
  wc.c_g = c_g;
  wc.vec = c_g % 8 == 0 && aligned16(g) && aligned16(g2);
  cudaStream_t s = (cudaStream_t)stream;
  switch (gmode) {
    case G_RAW: return (int)launch_wgrad<G_RAW>(a, wc, grid, s);
    case G_MODGRAD: return (int)launch_wgrad<G_MODGRAD>(a, wc, grid, s);
    default: return (int)launch_wgrad<G_BN>(a, wc, grid, s);
  }
}

}  // extern "C"
