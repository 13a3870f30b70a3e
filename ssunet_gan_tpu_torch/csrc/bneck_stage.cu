// Fused eval Bottleneck stage of UNet_B_SS on Hopper (sm_90a): the port of
// the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py fused_eval_stage_bneck
// (_bneck_call -> pl.pallas_call, body _make_bneck_kernel with the SPADE
// tail of ops/spade_kernel.py _spade_tail).
//
// One stage (Bottleneck + self-SPADE, every BatchNorm folded into its
// weights) runs as four launches from one host call:
//   A. conv_kernel:        h1 = relu(conv1x1(x; K1*s1) + t1)
//   B. conv_kernel:        h2 = relu(conv3x3(h1; K2*s2) + t2)
//   C. conv_kernel:        y  = relu(conv1x1(h2; K3*s3) + shortcut(x) + (t3+ts))
//   D. spade_tail_kernel:  seg, act, g|b on chip, out = y*(1+g) + b,
//                          optionally logits = conv1x1(out; Kf) + bf.
// h1, h2 and y go through device memory (buffers the caller owns); seg, act
// and g|b stay on chip.
//
// What bounds it on the H100: only conv2 (9*C*C multiply-adds a pixel) sits
// above the bf16 ridge point; the 1x1 convs carry C*C and Cin*C and are
// bound by the bytes of their inputs and outputs, so at 64-256 planes the
// stage as a whole is bound by the activations it moves. All three convs
// are the shared implicit GEMM on mma.sync m16n8k16 bf16 tensor cores with
// f32 sums (stage_common.cuh): a 1x1 conv is a K-segment with one tap. In
// launch C the conv3 product and the shortcut are K-segments of ONE GEMM
// ([h2 | part 0 | part 1], each read through its own pointer), so they
// share one f32 accumulator, one bias (t3 + ts) and one rounding, as in the
// TPU kernel's single deep contraction. An identity shortcut arrives as a
// unit-matrix K-segment over the input (exact in bf16). Fusing A into B and
// C into D (recomputing the cheap 1x1 products from staged tiles) is later
// work (see ROADMAP.md).
//
// Numerics follow the TPU kernel: each conv zero-pads its own input at the
// image border, so h1 outside the image is 0 and not relu(t1); sums run in
// f32; weights and biases arrive rounded to bf16 values; h1, h2, y, seg,
// act and g|b are rounded to bf16; the modulate runs in bf16 one operation
// at a time.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// first launch that failed, or 0.

#include "stage_common.cuh"

namespace {

// One conv launch over up to three K-segments with bias and ReLU.
int launch_conv(const void* const* ptrs, const int* chans, const int* ks,
                const void* w, int kp, const void* bias, void* out, int n, int h,
                int wd, int cout, cudaStream_t stream) {
  ConvArgs a = {};
  const int ksum = fill_sources(a.src, MAX_SRC, a.nsrc, ptrs, chans, ks);
  if (ksum < 0 || ksum != kp || cout % 2 != 0 || (uintptr_t)w % 16 != 0)
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
  conv_kernel<<<grid, CONV_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole stage. x0/x1: the parts (c1 == 0: one part). k1: [c][pad32(c0) +
// pad32(c1)]; k2: [c][9*c]; k3: [c][c + pad32(c0) + pad32(c1)] (conv3, then
// the shortcut's or the identity's columns); b1, b2, b3: f32 [c]. h1, h2, y:
// scratch [n, h, w, c] bf16. The tail's operands as in fused_stage.cu.
int ssu_bneck_stage(const void* x0, int c0, const void* x1, int c1, int n, int h,
                    int wd, int c, const void* k1, int kp1, const void* b1,
                    const void* k2, int kp2, const void* b2, const void* k3, int kp3,
                    const void* b3, void* h1, void* h2, void* y, const void* k1t,
                    const void* b1s, int lab, const void* k2s, const void* b2s, int nh,
                    const void* kgbt, const void* bgb, const void* kft, const void* bf,
                    int ncls, void* out, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c0 <= 0 || c1 < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  {
    const void* ptrs[MAX_SRC] = {x0, x1, nullptr};
    const int chans[MAX_SRC] = {c0, c1, 0};
    const int ks[MAX_SRC] = {1, 1, 1};
    const int e = launch_conv(ptrs, chans, ks, k1, kp1, b1, h1, n, h, wd, c, st);
    if (e != 0) return e;
  }
  {
    const void* ptrs[MAX_SRC] = {h1, nullptr, nullptr};
    const int chans[MAX_SRC] = {c, 0, 0};
    const int ks[MAX_SRC] = {3, 1, 1};
    const int e = launch_conv(ptrs, chans, ks, k2, kp2, b2, h2, n, h, wd, c, st);
    if (e != 0) return e;
  }
  {
    const void* ptrs[MAX_SRC] = {h2, x0, x1};
    const int chans[MAX_SRC] = {c, c0, c1};
    const int ks[MAX_SRC] = {1, 1, 1};
    const int e = launch_conv(ptrs, chans, ks, k3, kp3, b3, y, n, h, wd, c, st);
    if (e != 0) return e;
  }
  return launch_spade_tail(y, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb, kft, bf,
                           ncls, out, nullptr, nullptr, st);
}

}  // extern "C"
