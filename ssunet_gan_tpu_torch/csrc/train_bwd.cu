// The train kernels on the Hopper cores of bwd_core.cuh (sm_90a): the
// v3 backward of the training-mode fused stage, the TPU kernels of
// ssunet_gan_tpu/ops/train_bwd.py, which run the backward's pointwise and
// BatchNorm chains inside the convs next to them, and the forward's convs
// and the v2 weight gradient of ssunet_gan_tpu/ops/stage_kernel_train.py:
//
//   fused_conv3  <- fused_conv3_call (:167, body _make_fused_kernel :60)
//       out = epilogue(conv3x3(prologue(src))), stat rows of the epilogue's
//       values. The TPU kernel takes Python callables for the prologue and
//       epilogue; here each chain is a mode of the conv core
//       (bwd_core.cuh ConvMode), one instantiation each:
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
//   conv_stats   <- stage_kernel_train.py _conv_stats_call (:232, body
//                   _make_conv_kernel :159)
//       out = round(conv3x3(parts; W) [+ b]), one or two parts of any widths
//       as K-segments (CONV_STD), or a single part through relu(x*a + b)
//       first (CONV_AFF: conv2's BN1 + ReLU, applied once per window value,
//       the image border's padding left 0); (sum, sum of squares) of the
//       rounded output. The forward's conv1 and conv2 (12 launches per
//       flagship step, ~1.2e12 multiply-adds: 2.437 ms at 989 TFLOP/s),
//       and the v2 backward's gamma|beta recompute and backward-data convs.
//   fused_wgrad  <- fused_wgrad_call (:374, body _make_wgrad_fused_kernel :291)
//       dW of a 3x3 conv whose input is the saved tensor (optionally
//       relu(x*a + b), conv2's input) and whose cotangent is rebuilt in the
//       cotangent tile: as it is (G_RAW), [round(g0*y) ; g0] (G_MODGRAD) or
//       the BN-backward chain (G_BN); one instantiation each. G_RAW is also
//       the v2 weight gradient, stage_kernel_train.py _wgrad_w (:766, body
//       _make_wgrad_kernel :664): dW of up to two parts, the cotangent as
//       it is.
//
// What bounds them on the H100: the convs and the weight gradients carry
// the train step's multiply-adds at an arithmetic intensity far above the
// bf16 ridge point (~295 FLOP/byte), so they are bound by tensor-core
// operations; the chains themselves are bytes. The design (bwd_core.cuh)
// keeps every chain out of device memory and evaluates each chain value
// once per block that reads it: a block owns a spatial tile of one image,
// its input window arrives through a cp.async ring, the chain runs once
// over the window in shared memory, and the nine taps are shifted ldmatrix
// reads of that window, so each input value is read once per N block (not
// once per tap). The conv covers up to 256 output channels per block; the
// weight gradient covers the nine taps of one input chunk per block, with
// narrow dW rows on the MMA's 8-wide side and narrow inputs packed as (tap,
// 8 channels) groups. Epilogues run on the accumulators; stat rows are
// reduced per block in shared memory and summed by stats_reduce_kernel.
//
// Numerics follow the TPU kernels and the port's plain versions
// (ops/train_bwd.py, ops/stage_kernel_train.py): each conv zero-pads its
// own input at the image border, so a prologue runs on in-image pixels only
// and padded channels stay 0; the f32 chain arithmetic rounds each
// operation (no fused multiply-adds) as the plain version does; bf16
// roundings at the JAX package's points; masks compare f32 values of bf16
// tensors; the stat rows' block partials are summed in a fixed order, the
// blocks' in f64 (the batch statistics come out the same from run to run);
// the weight gradient moves its MMA sums into round-to-nearest f32 sums
// every 4 steps and sums its blocks' partials with f64 atomics.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "bwd_core.cuh"

namespace {

template <int MODE, int NT>
__global__ void __launch_bounds__(CORE_THREADS)
fused_conv3_kernel(const Conv3Args args) {
  conv3_body<MODE, NT>(args);
}

template <int GM, int NT>
__global__ void __launch_bounds__(CORE_THREADS)
fused_wgrad_kernel(const Wg3Args args) {
  wgrad3_body<GM, NT>(args);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Launch one instantiation with its dynamic shared memory (the attribute is
// set once per instantiation).
template <typename Args>
cudaError_t launch(void (*kernel)(Args), bool& attr_set, const Args& a, dim3 grid,
                   int smem, cudaStream_t stream) {
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  kernel<<<grid, CORE_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int NT>
cudaError_t launch_conv3(const Conv3Args& a, dim3 grid, int smem, cudaStream_t s) {
  static bool attr = false;
  return launch(fused_conv3_kernel<MODE, NT>, attr, a, grid, smem, s);
}

template <int GM, int NT>
cudaError_t launch_wgrad(const Wg3Args& a, dim3 grid, int smem, cudaStream_t s) {
  static bool attr = false;
  return launch(fused_wgrad_kernel<GM, NT>, attr, a, grid, smem, s);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The N tile of a conv3 mode for cout output channels: the smallest the
// mode is built for that covers cout / ceil(cout / widest) channels, so a
// wide output splits into equal N blocks (384 = 2 x 192). "pre" (K = its 3
// labels' taps) always takes 64, the width whose four bands fit in shared
// memory beside a second block.
int conv3_nt(int mode, int cout) {
  if (mode == CONV_PRE) return 64;
  static const int plain_nt[] = {8, 16, 64, 128, 192, 256};
  static const int narrow_nt[] = {8, 16, 64};
  static const int wide_nt[] = {64, 128, 192, 256};
  const bool plain = conv3_plain(mode);
  const int* nts = plain ? plain_nt : mode == CONV_MODGRAD ? narrow_nt : wide_nt;
  const int k = plain ? 6 : mode == CONV_MODGRAD ? 3 : 4;
  const int per = cdiv(cout, cdiv(cout, nts[k - 1]));
  for (int i = 0; i < k; ++i)
    if (per <= nts[i]) return nts[i];
  return nts[k - 1];
}

template <int MODE>
cudaError_t conv3_by_nt(int nt, const Conv3Args& a, dim3 grid, int smem, cudaStream_t s) {
  if constexpr (conv3_plain(MODE) || MODE == CONV_MODGRAD) {
    if (nt == 8) return launch_conv3<MODE, 8>(a, grid, smem, s);
    if (nt == 16) return launch_conv3<MODE, 16>(a, grid, smem, s);
  }
  if (nt == 64) return launch_conv3<MODE, 64>(a, grid, smem, s);
  if constexpr (MODE != CONV_MODGRAD && MODE != CONV_PRE) {
    if (nt == 128) return launch_conv3<MODE, 128>(a, grid, smem, s);
    if (nt == 192) return launch_conv3<MODE, 192>(a, grid, smem, s);
    if (nt == 256) return launch_conv3<MODE, 256>(a, grid, smem, s);
  }
  return cudaErrorInvalidValue;
}

// The N tile of a weight gradient with cout dW rows: 8 or 16 for the narrow
// ones (x2map's labels, mlp's hidden), else 32 (G_MODGRAD's 2 x c_g rows
// always).
int wgrad_nt(int gmode, int cout) {
  return gmode == G_MODGRAD || cout > 16 ? 32 : cout > 8 ? 16 : 8;
}

template <int GM>
cudaError_t wgrad_by_nt(int nt, const Wg3Args& a, dim3 grid, int smem, cudaStream_t s) {
  if constexpr (GM != G_MODGRAD) {
    if (nt == 8) return launch_wgrad<GM, 8>(a, grid, smem, s);
    if (nt == 16) return launch_wgrad<GM, 16>(a, grid, smem, s);
  }
  return launch_wgrad<GM, 32>(a, grid, smem, s);
}

// ssu_fused_conv3's pointer and integer arguments, by position
// (ops/train_bwd.py _CONV_PTRS, _CONV_INTS)
enum {
  P_SRC0, P_SRC1, P_W, P_BIAS, P_PRO_F, P_CST, P_BAND = P_CST + 8,
  P_OUT0 = P_BAND + 4, P_OUT1, P_PARTIAL, P_STATS
};
enum { I_C0, I_K0, I_C1, I_K1, I_KP, I_N, I_H, I_W, I_COUT, I_SPLIT };

// A conv segment of c channels and kernel size k in chunks of cc channels,
// in K stages of ks; returns its K (a multiple of 32).
int fill_seg(Seg3& sg, const void* p, int c, int k, int cc, int ks, bool vec) {
  sg.ptr = static_cast<const bf16*>(p);
  sg.c = c;
  sg.ksize = k;
  sg.vec = vec && c % 8 == 0 && aligned16(p);
  sg.nchunk = cdiv(c, cc);
  sg.spc = cdiv((k == 3 ? 9 : 1) * cc, ks);
  return sg.nchunk * sg.spc * ks;
}

}  // namespace

extern "C" {

// Rows of the per-block partial sums of ssu_fused_conv3 (one block per
// output tile of conv3_th(mode, N tile) x 16 pixels).
long long ssu_conv3_blocks(int mode, int cout, int n, int h, int w) {
  return (long long)n * cdiv(h, conv3_th(mode, conv3_nt(mode, cout))) * cdiv(w, TW);
}

// One conv of the core (mode: a ConvMode). p and d hold the pointers and
// integers named by P_* and I_*; a pointer that a mode does not use may be
// null. CONV_STD takes one or two 3x3 parts of any widths, CONV_AFF one part
// with its prologue's a and b in cst[0], cst[1]. With stats (and partial,
// [rows][cout][ssu_conv3_blocks(n, h, w)] f32), stats[r][c] is the mode's
// r-th sum over the pixels.
int ssu_fused_conv3(int mode, void* const* p, const int* d, void* stream) {
  Conv3Args a = {};
  const int cout = d[I_COUT];
  const bool two_src = mode == CONV_MODGRAD || mode == CONV_BN1;  // required
  const bool chain = conv3_chain(mode);
  const int nbands = conv3_nbands(mode);
  const int ncst = mode == CONV_PRE ? 2 : mode == CONV_BN2 ? 8 : mode == CONV_BN1 ? 4
                 : mode == CONV_AFF ? 2 : 0;
  const int c0 = d[I_C0], c1 = d[I_C1];
  const bool has1 = c1 > 0;
  bool ok = mode >= CONV_STD && mode <= CONV_AFF && c0 > 0 && c1 >= 0 &&
            (two_src ? has1 && c1 == c0 : !has1 || mode == CONV_STD) && cout >= 1 &&
            aligned16(p[P_W]) && d[I_N] > 0 && d[I_H] > 0 && d[I_W] > 0 && (d[I_K0] == 3) &&
            (!has1 || d[I_K1] == (mode == CONV_BN1 ? 1 : 3)) &&
            (!chain || p[P_PRO_F] != nullptr) && p[P_SRC0] != nullptr &&
            p[P_OUT0] != nullptr && (p[P_STATS] == nullptr) == (p[P_PARTIAL] == nullptr);
  if (mode == CONV_BN1)
    ok = ok && d[I_SPLIT] >= 1 && d[I_SPLIT] <= cout &&
         (d[I_SPLIT] == cout || p[P_OUT1] != nullptr) && p[P_STATS] == nullptr;
  else
    ok = ok && d[I_SPLIT] == cout;
  if (mode == CONV_MODGRAD) ok = ok && p[P_SRC1] == p[P_SRC0];
  if (conv3_cs_rows(mode) > 0) ok = ok && c0 <= CHAIN_MAX_C;
  for (int i = 0; i < nbands; ++i) ok = ok && p[P_BAND + i] != nullptr;
  for (int i = 0; i < ncst; ++i) ok = ok && p[P_CST + i] != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;

  // the parts share the chunk width: the wider part's
  a.cc = chain ? CC_WIDE : chunk_channels(c0);
  if (!chain && has1 && chunk_channels(c1) > a.cc) a.cc = chunk_channels(c1);
  a.wst = win_stride(a.cc);
  const bool pro_vec = !chain || aligned16(p[P_PRO_F]);
  int kp = fill_seg(a.seg[0], p[P_SRC0], c0, 3, a.cc, conv3_ks(mode), pro_vec);
  a.nseg = 1;
  if (has1) {
    const int k1 = d[I_K1];
    kp += fill_seg(a.seg[1], p[P_SRC1], c1, k1, a.cc, k1 == 3 ? conv3_ks(mode) : KS, true);
    a.nseg = 2;
  }
  if (kp != d[I_KP]) return (int)cudaErrorInvalidValue;
  a.wt = static_cast<const bf16*>(p[P_W]);
  a.kp = kp;
  a.bias = static_cast<const float*>(p[P_BIAS]);
  a.out = static_cast<bf16*>(p[P_OUT0]);
  a.partial = static_cast<float*>(p[P_PARTIAL]);
  a.n = d[I_N];
  a.h = d[I_H];
  a.w = d[I_W];
  a.cout = cout;
  const int nt = conv3_nt(mode, cout);
  a.tiles_w = cdiv(a.w, TW);
  a.tiles_h = cdiv(a.h, conv3_th(mode, nt));
  a.pro_f = static_cast<const bf16*>(p[P_PRO_F]);
  for (int i = 0; i < 8; ++i) a.cst[i] = static_cast<const float*>(p[P_CST + i]);
  for (int i = 0; i < 4; ++i) a.band[i] = static_cast<const bf16*>(p[P_BAND + i]);
  a.out1 = static_cast<bf16*>(p[P_OUT1]);
  a.split = d[I_SPLIT];
  a.k_round = a.seg[0].nchunk * a.seg[0].spc;
  a.bvec = cout % 8 == 0;
  for (int i = 0; i < nbands; ++i) a.bvec = a.bvec && aligned16(p[P_BAND + i]);

  const long long nb = ssu_conv3_blocks(mode, cout, a.n, a.h, a.w);
  const dim3 grid((unsigned)nb, (unsigned)cdiv(cout, nt));
  const int rows = conv3_plain(mode) ? 2 : mode == CONV_MODGRAD ? 1 : mode == CONV_PRE ? 4
                 : mode == CONV_BN2 ? 2 : 0;
  const int smem = conv3_smem(mode, nt, rows, c0, a.cc, a.wst);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (mode) {
    case CONV_STD: e = conv3_by_nt<CONV_STD>(nt, a, grid, smem, s); break;
    case CONV_MODGRAD: e = conv3_by_nt<CONV_MODGRAD>(nt, a, grid, smem, s); break;
    case CONV_PRE: e = conv3_by_nt<CONV_PRE>(nt, a, grid, smem, s); break;
    case CONV_BN2: e = conv3_by_nt<CONV_BN2>(nt, a, grid, smem, s); break;
    case CONV_BN1: e = conv3_by_nt<CONV_BN1>(nt, a, grid, smem, s); break;
    default: e = conv3_by_nt<CONV_AFF>(nt, a, grid, smem, s); break;
  }
  if (e != cudaSuccess || p[P_STATS] == nullptr) return (int)e;
  stats_reduce_kernel<<<dim3((unsigned)cout, (unsigned)rows), RED_THREADS, 0, s>>>(
      a.partial, nb, cout, static_cast<float*>(p[P_STATS]));
  return (int)cudaGetLastError();
}

// dw[cout][cin][3][3] += sum over pixels of cot[p][o] * x[p + tap][i] (dw
// f64, zeroed by the caller, cin the parts' channels summed); x = up to two
// parts, a single one optionally relu(x*a + b); the cotangent (gmode: a
// GMode) from g and g2, [m][c_g] each, and cst (four pointers; G_BN: p, q,
// r', m'). G_RAW with c_g == cout is conv_stats's weight gradient (wgrad).
int ssu_fused_wgrad(int gmode, const void* s0, int c0, const void* s1, int c1,
                    const void* pro_a, const void* pro_b, const void* g, const void* g2,
                    const void* const* cst, int cout, int c_g, void* dw, int n, int h,
                    int wd, void* stream) {
  Wg3Args a = {};
  const int nparts = c1 > 0 ? 2 : 1;
  if (gmode < G_RAW || gmode > G_BN || s0 == nullptr || c0 <= 0 || g == nullptr ||
      (nparts == 2 && s1 == nullptr) || (pro_a != nullptr && (nparts != 1 || pro_b == nullptr)) ||
      (gmode != G_RAW && g2 == nullptr) || (gmode == G_RAW && c_g != cout) ||
      (gmode == G_MODGRAD && 2 * c_g != cout) ||
      (gmode == G_BN && (c_g != cout || cst[0] == nullptr || cst[1] == nullptr ||
                         cst[2] == nullptr || cst[3] == nullptr)) ||
      cout < 1 || n <= 0 || h <= 0 || wd <= 0 || dw == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* xs[2] = {s0, s1};
  const int xcs[2] = {c0, c1};
  a.cc = chunk_channels(c0);
  if (nparts == 2 && chunk_channels(c1) > a.cc) a.cc = chunk_channels(c1);
  a.wst = win_stride(a.cc);
  int colblocks = 0, off = 0;
  for (int i = 0; i < nparts; ++i) {
    a.x[i] = static_cast<const bf16*>(xs[i]);
    a.xc[i] = xcs[i];
    a.xvec[i] = xcs[i] % 8 == 0 && aligned16(xs[i]);
    a.xoff[i] = off;
    a.nchunk[i] = cdiv(xcs[i], a.cc);
    off += xcs[i];
    colblocks += a.nchunk[i];
  }
  if (nparts == 1) a.nchunk[1] = 0;
  a.pro_a = static_cast<const float*>(pro_a);
  a.pro_b = static_cast<const float*>(pro_b);
  a.g = static_cast<const bf16*>(g);
  a.g2 = static_cast<const bf16*>(g2);
  for (int i = 0; i < 4; ++i) a.cst[i] = static_cast<const float*>(cst[i]);
  a.c_g = c_g;
  a.gvec = c_g % 8 == 0 && aligned16(g) && (g2 == nullptr || aligned16(g2));
  a.cout = cout;
  a.cin = off;
  a.dw = static_cast<double*>(dw);
  a.n = n;
  a.h = h;
  a.w = wd;
  a.tiles_w = cdiv(wd, TW);
  a.tiles_h = cdiv(h, TH);
  a.ntiles = n * a.tiles_w * a.tiles_h;
  const int nt = wgrad_nt(gmode, cout);
  const int nblocks = cdiv(cout, nt);
  // the pixels split so that ~8 blocks per SM are in flight, each with at
  // least 4 tiles
  int splits = cdiv(132 * 8, colblocks * nblocks);
  const int max_splits = cdiv(a.ntiles, 4);
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  a.tiles_per_split = cdiv(a.ntiles, splits);
  splits = cdiv(a.ntiles, a.tiles_per_split);
  const dim3 grid((unsigned)colblocks, (unsigned)nblocks, (unsigned)splits);
  const int smem = wg3_smem(nt, a.wst);
  cudaStream_t s = (cudaStream_t)stream;
  switch (gmode) {
    case G_RAW: return (int)wgrad_by_nt<G_RAW>(nt, a, grid, smem, s);
    case G_MODGRAD: return (int)wgrad_by_nt<G_MODGRAD>(nt, a, grid, smem, s);
    default: return (int)wgrad_by_nt<G_BN>(nt, a, grid, smem, s);
  }
}

}  // extern "C"
