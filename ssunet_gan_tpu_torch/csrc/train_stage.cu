// The training-mode fused stage's tail on Hopper (sm_90a): the port of the
// TPU kernel ssunet_gan_tpu/ops/stage_kernel_train.py
//
//   train_tail  <- _tail_call (:435, body _make_tail_kernel :314)
//       y = relu(f2*a2 + b2 + conv1x1(parts; Ws)), then the self-SPADE tail
//       seg, actv, gamma|beta, out = y*(1+gamma) + beta [+ head], saving y,
//       seg and actv for the backward. Two launches: eval_conv_core in its
//       residual epilogue writes y, then spade_tail_kernel.
//
// (The stage's other TPU kernels, conv_stats and the weight gradient, run
// on the cores of bwd_core.cuh: train_bwd.cu.)
//
// What bounds it on the H100: device-memory bytes (the 1x1 shortcut and the
// tail's narrow convs are far below the bf16 ridge point). The residual
// conv is the eval conv core (eval_conv.cuh, shared with fused_stage.cu and
// bneck_stage.cu) over 1x1 segments alone: no halo, each part's pixel read
// once per block with all output channels, f2 and y in 16-byte pieces; the
// weight is packed at every call (training changes it). The SPADE tail is
// stage_common.cuh's (seg and g|b on mma.sync tensor cores, a 16x16 output
// tile) with the seg and actv saves.
//
// Numerics follow the TPU kernel: sums run in f32, the residual affine
// rounds each operation in f32, y and the tail's intermediates are rounded
// to bf16.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "eval_conv.cuh"

extern "C" {

// y = relu(res*res_a + res_b + conv1x1(parts; w)) over one or two 1x1
// parts, the train tail's first launch: the eval conv core
// (eval_conv.cuh) in its residual epilogue.
int ssu_conv_res(int nseg, const void* const* ptrs, const int* chans, int nt, const void* w,
                 int nsteps, const void* res, const void* res_a, const void* res_b, void* out,
                 int n, int h, int wd, int cout, void* stream) {
  if (nseg < 1 || nseg > 2 || res == nullptr) return (int)cudaErrorInvalidValue;
  const int ks[2] = {1, 1};
  return launch_eval_conv(nseg, ptrs, chans, ks, nt, w, nsteps, nullptr, res, res_a, res_b, out,
                          n, h, wd, cout, (cudaStream_t)stream);
}

// The train tail's SPADE half (+ folded head when kft != null) on y; saves
// seg and actv.
int ssu_spade_tail_train(const void* y, int n, int h, int wd, int c,
                         const void* k1t, const void* b1s, int lab,
                         const void* k2s, const void* b2s, int nh,
                         const void* kgbt, const void* bgb, const void* kft,
                         const void* bf, int ncls, void* out, void* seg,
                         void* act, void* stream) {
  if (seg == nullptr || act == nullptr) return (int)cudaErrorInvalidValue;
  return launch_spade_tail(y, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb,
                           kft, bf, ncls, out, seg, act, stream);
}

}  // extern "C"
