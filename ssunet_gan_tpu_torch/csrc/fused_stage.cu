// Fused eval stage of the ss-UNet family on Hopper (sm_90a): the port of
// the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py fused_eval_stage
// (_stage_call -> pl.pallas_call, body _make_kernel with the SPADE tail of
// ops/spade_kernel.py _spade_tail).
//
// One stage (BasicBlock + self-SPADE, BatchNorm folded into the weights)
// runs as three launches:
//   1. conv_kernel:          h1 = relu(conv3x3(x; K1*s1) + t1)
//   2. conv_kernel:          y  = relu(conv3x3(h1; K2*s2) + conv1x1(x; Ks) + t2)
//   3. spade_tail_kernel:    seg = conv3x3(y) + b, act = relu(conv3x3(seg) + b),
//                            g|b = conv3x3(act) + b, out = y*(1+g) + b,
//                            optionally logits = conv1x1(out; Kf) + bf.
// h1 and y go through device memory; seg, act and g|b stay on chip.
//
// What bounds it on the H100: the two big convs are ~95% of the stage's
// multiply-adds and sit far above the bf16 ridge point (~295 FLOP/byte), so
// the stage is bound by tensor-core operations. Launches 1 and 2 are an
// implicit GEMM on mma.sync m16n8k16 bf16 tensor cores with f32
// accumulation (M = pixels, N = output channels, K = taps x input
// channels); the split-concat parts and the 1x1 shortcut are extra
// K-segments of the same GEMM, read through their own pointers, so no
// concatenated tensor is ever built. The SPADE tail (stage_common.cuh) runs
// seg and g|b as mma.sync GEMMs on a 16x16 output tile with a 3-pixel halo
// staged in shared memory, act as f32 FMAs. wgmma/TMA pipelines and
// one-pass fusion of the stage are later work (see ROADMAP.md).
//
// Numerics follow the TPU kernel: every conv zero-pads its own input at the
// image border (intermediates outside the image are zeroed, never
// computed from the halo), sums run in f32, h1, y, seg, act and g|b are
// rounded to bf16, and the modulate runs in bf16 one operation at a time.
// The conv core and the tail are stage_common.cuh's, shared with the train
// kernels (train_stage.cu).
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include "stage_common.cuh"

extern "C" {

// conv3x3 over up to two parts (+ an optional third K-segment) + bias + ReLU.
// A source with c == 0 is absent. ksize is 3 (pad 1) or 1 (pad 0).
int ssu_conv_bn_relu(const void* s0, int c0, int k0, const void* s1, int c1,
                     int k1, const void* s2, int c2, int k2, const void* w,
                     int kp, const void* bias, void* out, int n, int h, int wd,
                     int cout, void* stream) {
  ConvArgs a = {};
  const void* ptrs[MAX_SRC] = {s0, s1, s2};
  const int chans[MAX_SRC] = {c0, c1, c2};
  const int ks[MAX_SRC] = {k0, k1, k2};
  const int ksum = fill_sources(a.src, MAX_SRC, a.nsrc, ptrs, chans, ks);
  if (ksum < 0 || ksum != kp || cout % 2 != 0 || (uintptr_t)w % 16 != 0 ||
      n <= 0 || h <= 0 || wd <= 0)
    return (int)cudaErrorInvalidValue;
  a.wt = static_cast<const bf16*>(w);
  a.kp = kp;
  a.bias = static_cast<const float*>(bias);
  a.relu = 1;
  a.out = static_cast<bf16*>(out);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.m = (long long)n * h * wd;
  const dim3 grid((unsigned)((a.m + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  conv_kernel<<<grid, CONV_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Self-SPADE tail (+ folded head when kft != null) of one stage; the
// operands as ops/stage_kernel.py pack_spade lays them out.
int ssu_spade_tail(const void* y, int n, int h, int wd, int c, const void* k1t,
                   const void* b1s, int lab, const void* k2s, const void* b2s,
                   int nh, const void* kgbt, const void* bgb, const void* kft,
                   const void* bf, int ncls, void* out, void* stream) {
  return launch_spade_tail(y, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb,
                           kft, bf, ncls, out, nullptr, nullptr, stream);
}

}  // extern "C"
