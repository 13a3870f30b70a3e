// Fused eval Bottleneck stage of UNet_B_SS on Hopper (sm_90a): the port of
// the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py fused_eval_stage_bneck
// (_bneck_call -> pl.pallas_call, body _make_bneck_kernel with the SPADE
// tail of ops/spade_kernel.py _spade_tail).
//
// One stage (Bottleneck + self-SPADE, every BatchNorm folded into its
// weights) runs as four launches from one host call:
//   A. eval_conv_core:   h1 = relu(conv1x1(x; K1*s1) + t1)
//   B. eval_conv_core:   h2 = relu(conv3x3(h1; K2*s2) + t2)
//   C. eval_conv_core:   y  = relu(conv1x1(h2; K3*s3) + shortcut(x) + (t3+ts))
//   D. spade_tail_kernel:  seg, act, g|b on chip, out = y*(1+g) + b,
//                          optionally logits = conv1x1(out; Kf) + bf.
// h1, h2 and y go through device memory (buffers the caller owns); seg, act
// and g|b stay on chip.
//
// What bounds it on the H100: only B (9*C*C multiply-adds a pixel) sits
// above the bf16 ridge point and is bound by tensor-core operations; A and
// C carry C*C and Cin*C and are bound by the bytes of their inputs and
// outputs. All three run on the eval conv core (eval_conv.cuh: a block owns
// a spatial tile and all output channels, wgmma m64nNk16 with both operands
// in shared memory, A a matrix descriptor per (tap, channel group) pair
// straight into the tile's window, B the packed weights by bulk copy): B
// reads each h1 value once per block and chunk; A and C load no halo, so
// each input pixel is read once and each output written once, in 16-byte
// pieces. A part that is the decoder's upsample seam (m0/m1 = 1) arrives
// as the half-height tensor after its W-interpolation and is interpolated
// along H while launch A's and launch C's windows load (eval_conv.cuh read
// mode 1, the TPU kernel's _upsample_on_read), so the full-resolution up
// tensor is never written; launch B reads h1 plainly. In launch C the
// conv3 product and the shortcut are K-segments of ONE sum ([h2 | part 0 |
// part 1], each read through its own pointer), so they share one f32
// accumulator, one bias (t3 + ts) and one rounding, as in the TPU kernel's
// single deep contraction. An identity shortcut arrives as a unit-matrix
// K-segment over the input (exact in bf16). Fusing A into B and C into D
// is later work (see ROADMAP.md).
//
// Numerics follow the TPU kernel: each conv zero-pads its own input at the
// image border, so h1 outside the image is 0 and not relu(t1); sums run in
// f32; weights and biases arrive rounded to bf16 values; h1, h2, y, seg,
// act and g|b are rounded to bf16; the modulate runs in bf16 one operation
// at a time.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// first launch that failed, or 0.

#include "eval_conv.cuh"

extern "C" {

// The whole stage over n images of h x wd. x0/x1: the parts (c1 == 0: one
// part), read in modes m0/m1 (0 plain, 1 up: an (h/2) x wd source). k1,
// k2, k3: the packed weights of the three convs for an N of nt
// (ops/stage_kernel.py eval_conv_weight: conv1 over the parts, conv2 over
// h1, conv3 over h2 then the shortcut's or the identity's parts), of s1,
// s2, s3 k16 steps; b1, b2, b3: f32 [c]. h1, h2, y: scratch [n, h, w, c]
// bf16. The tail's operands as in fused_stage.cu.
int ssu_bneck_stage(const void* x0, int c0, int m0, const void* x1, int c1, int m1, int n,
                    int h, int wd, int c, int nt, const void* k1, int s1, const void* b1,
                    const void* k2, int s2, const void* b2, const void* k3, int s3, const void* b3, void* h1, void* h2,
                    void* y, const void* k1t, const void* b1s, int lab, const void* k2s,
                    const void* b2s, int nh, const void* kgbt, const void* bgb, const void* kft,
                    const void* bf, int ncls, void* out, void* stream) {
  if (c0 <= 0 || c1 < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int np = c1 > 0 ? 2 : 1;
  {
    const void* ptrs[2] = {x0, x1};
    const int chans[2] = {c0, c1};
    const int ks[2] = {1, 1};
    const int modes[2] = {m0, m1};
    const int e = launch_eval_conv(np, ptrs, chans, ks, modes, nt, k1, s1, b1, nullptr, nullptr,
                                   nullptr, h1, n, h, wd, c, st);
    if (e != 0) return e;
  }
  {
    const void* ptrs[1] = {h1};
    const int chans[1] = {c};
    const int ks[1] = {3};
    const int e = launch_eval_conv(1, ptrs, chans, ks, nullptr, nt, k2, s2, b2, nullptr, nullptr,
                                   nullptr, h2, n, h, wd, c, st);
    if (e != 0) return e;
  }
  {
    const void* ptrs[3] = {h2, x0, x1};
    const int chans[3] = {c, c0, c1};
    const int ks[3] = {1, 1, 1};
    const int modes[3] = {0, m0, m1};
    const int e = launch_eval_conv(1 + np, ptrs, chans, ks, modes, nt, k3, s3, b3, nullptr,
                                   nullptr, nullptr, y, n, h, wd, c, st);
    if (e != 0) return e;
  }
  return launch_spade_tail(y, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb, kft, bf,
                           ncls, out, nullptr, nullptr, st);
}

}  // extern "C"
