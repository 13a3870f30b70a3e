// The training-mode fused stage's tail on Hopper (sm_90a): the port of the
// TPU kernel ssunet_gan_tpu/ops/stage_kernel_train.py
//
//   train_tail  <- _tail_call (:435, body _make_tail_kernel :314)
//       y = relu(f2*a2 + b2 + conv1x1(parts; Ws)), then the self-SPADE tail
//       seg, actv, gamma|beta, out = y*(1+gamma) + beta [+ head], saving y,
//       seg and actv for the backward. Two launches: the conv kernel in its
//       residual mode writes y, then spade_tail_kernel.
//
// (The stage's other TPU kernels, conv_stats and the weight gradient, run
// on the cores of bwd_core.cuh: train_bwd.cu.)
//
// What bounds it on the H100: device-memory bytes (the 1x1 shortcut and the
// tail's narrow convs are far below the bf16 ridge point). The residual
// conv is the implicit GEMM of stage_common.cuh on mma.sync m16n8k16 bf16
// tensor cores with f32 sums (M = pixels, N = output channels, K = parts x
// input channels, each part read through its own pointer; shared with
// fused_stage.cu); the SPADE tail is stage_common.cuh's (f32 FMAs on a
// 16x16 output tile) with the seg and actv saves.
//
// Numerics follow the TPU kernel: sums run in f32, y and the tail's
// intermediates are rounded to bf16.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "stage_common.cuh"

extern "C" {

// y = relu(res*res_a + res_b + conv1x1(sources; w)) over up to three 1x1
// sources (a source with c == 0 is absent), the train tail's first launch.
int ssu_conv_res(const void* s0, int c0, const void* s1, int c1, const void* s2, int c2,
                 const void* w, int kp, const void* res, const void* res_a,
                 const void* res_b, void* out, int n, int h, int wd, int cout,
                 void* stream) {
  ConvArgs a = {};
  const void* ptrs[MAX_SRC] = {s0, s1, s2};
  const int chans[MAX_SRC] = {c0, c1, c2};
  const int ks[MAX_SRC] = {1, 1, 1};
  const int ksum = fill_sources(a.src, MAX_SRC, a.nsrc, ptrs, chans, ks);
  if (ksum < 0 || ksum != kp || cout < 1 || (uintptr_t)w % 16 != 0 || n <= 0 ||
      h <= 0 || wd <= 0 || res == nullptr || res_a == nullptr || res_b == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  a.wt = static_cast<const bf16*>(w);
  a.kp = kp;
  a.res = static_cast<const bf16*>(res);
  a.res_a = static_cast<const float*>(res_a);
  a.res_b = static_cast<const float*>(res_b);
  a.out = static_cast<bf16*>(out);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.m = (long long)n * h * wd;
  const dim3 grid((unsigned)((a.m + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  conv_kernel<<<grid, CONV_THREADS, 0, (cudaStream_t)stream>>>(a);
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
