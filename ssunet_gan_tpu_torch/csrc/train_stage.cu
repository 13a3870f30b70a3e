// Training-mode fused stage of the ss-UNet family on Hopper (sm_90a): the
// port of the TPU kernels of ssunet_gan_tpu/ops/stage_kernel_train.py that
// the v2 analytic backward runs:
//
//   conv_stats  <- _conv_stats_call (:232, body _make_conv_kernel :159)
//       out = conv3x3(parts; K) [+ b], optional prologue relu(x*a + b) on a
//       single input, per-channel sums (sum, sum of squares, f32) of the
//       bf16-rounded output. Also the backward-data conv (the cotangent
//       convolved with the 180-degree-rotated, I/O-swapped weight) and the
//       gamma|beta recompute of the backward.
//   train_tail  <- _tail_call (:435, body _make_tail_kernel :314)
//       y = relu(f2*a2 + b2 + conv1x1(parts; Ws)), then the self-SPADE tail
//       seg, actv, gamma|beta, out = y*(1+gamma) + beta [+ head], saving y,
//       seg and actv for the backward. Two launches: the conv kernel in its
//       residual mode writes y, then spade_tail_kernel.
//   wgrad       <- _wgrad_w (:766, body _make_wgrad_kernel :664)
//       dW[c][k] = sum over pixels of g[p][c] * x9[p][k], x9 the 3x3 taps of
//       the (optionally relu(x*a+b)-prologued) input, in f32.
//
// What bounds them on the H100: the convs and weight gradients carry nearly
// all of a train step's multiply-adds at an arithmetic intensity far above
// the bf16 ridge point (~295 FLOP/byte), so they are bound by tensor-core
// operations. Both run on mma.sync m16n8k16 bf16 tensor cores with f32
// sums: the conv as the implicit GEMM of stage_common.cuh (M = pixels,
// N = output channels, K = parts x taps x input channels, each part read
// through its own pointer; shared with fused_stage.cu), the weight gradient
// as a GEMM over the pixels (M = output channels, N = taps x input
// channels, K = N*H*W) split across blocks and summed with f32 atomics. The
// per-channel sums of conv_stats are reduced in the block, written as
// per-block partials, and summed by a second small kernel (no same-address
// atomics from thousands of blocks). The SPADE tail is stage_common.cuh's
// (f32 FMAs on a 16x16 output tile) with the seg and actv saves.
// wgmma/TMA pipelines come later (ROADMAP.md).
//
// Numerics follow the TPU kernels: each conv zero-pads its own input at the
// image border (a prologue is applied to in-image values only, so the
// padding stays 0), sums run in f32, outputs are rounded to bf16, the stats
// are sums of the rounded outputs, and the weight gradient is f32.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "train_common.cuh"

namespace {

__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const WgradArgs args) {
  wgrad_body(args);
}

}  // namespace

extern "C" {

// Rows of the per-block partial sums of ssu_conv_stats (blocks along M).
long long ssu_conv_stats_blocks(long long m) { return (m + BM - 1) / BM; }

// out = conv(sources; w) [+ bias]; with pro_a: relu(x*a + b) on source 0
// first (one source only); with res: out = relu(res*res_a + res_b + conv).
// With stats (and partial, [2][cout][ssu_conv_stats_blocks(m)] f32):
// stats[0][c] = sum of out[..., c], stats[1][c] = sum of its squares.
// A source with c == 0 is absent; ksize is 3 (pad 1) or 1 (pad 0).
int ssu_conv_stats(const void* s0, int c0, int k0, const void* s1, int c1,
                   int k1, const void* s2, int c2, int k2, const void* w,
                   int kp, const void* bias, const void* pro_a,
                   const void* pro_b, const void* res, const void* res_a,
                   const void* res_b, void* out, void* partial, void* stats,
                   int n, int h, int wd, int cout, void* stream) {
  ConvArgs a = {};
  const void* ptrs[MAX_SRC] = {s0, s1, s2};
  const int chans[MAX_SRC] = {c0, c1, c2};
  const int ks[MAX_SRC] = {k0, k1, k2};
  const int ksum = fill_sources(a.src, MAX_SRC, a.nsrc, ptrs, chans, ks);
  if (ksum < 0 || ksum != kp || cout < 1 || (uintptr_t)w % 16 != 0 || n <= 0 ||
      h <= 0 || wd <= 0 || (pro_a != nullptr && (a.nsrc != 1 || pro_b == nullptr)) ||
      (res != nullptr && (res_a == nullptr || res_b == nullptr)) ||
      ((stats == nullptr) != (partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.wt = static_cast<const bf16*>(w);
  a.kp = kp;
  a.bias = static_cast<const float*>(bias);
  a.pro_a = static_cast<const float*>(pro_a);
  a.pro_b = static_cast<const float*>(pro_b);
  a.res = static_cast<const bf16*>(res);
  a.res_a = static_cast<const float*>(res_a);
  a.res_b = static_cast<const float*>(res_b);
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.m = (long long)n * h * wd;
  const long long nb = ssu_conv_stats_blocks(a.m);
  const dim3 grid((unsigned)nb, (unsigned)((cout + BN - 1) / BN));
  conv_kernel<<<grid, CONV_THREADS, 0, (cudaStream_t)stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || stats == nullptr) return (int)e;
  stats_reduce_kernel<<<dim3((unsigned)cout, 2), RED_THREADS, 0, (cudaStream_t)stream>>>(
      a.partial, nb, cout, static_cast<float*>(stats));
  return (int)cudaGetLastError();
}

// dw[cout][kp] += sum over pixels of g[p][c] * taps(x)[p][k] (dw zeroed by
// the caller); x = up to two 3x3 sources, the first optionally prologued.
int ssu_wgrad(const void* s0, int c0, const void* s1, int c1, const void* pro_a,
              const void* pro_b, const void* g, int cout, void* dw, int kp,
              int n, int h, int wd, void* stream) {
  WgradArgs a;
  dim3 grid;
  if (!wgrad_setup(a, grid, s0, c0, s1, c1, pro_a, pro_b, cout, kp, n, h, wd))
    return (int)cudaErrorInvalidValue;
  a.g = static_cast<const bf16*>(g);
  a.gvec = (cout % 8 == 0) && ((uintptr_t)g % 16 == 0);
  a.dw = static_cast<float*>(dw);
  wgrad_kernel<<<grid, WG_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The train tail's SPADE half (+ folded head when kf != null) on y; saves
// seg and actv.
int ssu_spade_tail_train(const void* y, int n, int h, int wd, int c,
                         const void* k1s, const void* b1s, int lab,
                         const void* k2s, const void* b2s, int nh,
                         const void* kgb, const void* bgb, const void* kf,
                         const void* bf, int ncls, void* out, void* seg,
                         void* act, void* stream) {
  if (seg == nullptr || act == nullptr) return (int)cudaErrorInvalidValue;
  return launch_spade_tail(y, n, h, wd, c, k1s, b1s, lab, k2s, b2s, nh, kgb, bgb,
                           kf, bf, ncls, out, seg, act, stream);
}

}  // extern "C"
