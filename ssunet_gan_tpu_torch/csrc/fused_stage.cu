// Fused eval stage of the ss-UNet family on Hopper (sm_90a): the port of
// the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py fused_eval_stage
// (_stage_call -> pl.pallas_call, body _make_kernel with the SPADE tail of
// ops/spade_kernel.py _spade_tail).
//
// One stage (BasicBlock + self-SPADE, BatchNorm folded into the weights)
// runs as three launches:
//   1. eval_conv_core:     h1 = relu(conv3x3(x; K1*s1) + t1)
//   2. eval_conv_core:     y  = relu(conv3x3(h1; K2*s2) + conv1x1(x; Ks) + t2)
//   3. spade_tail_kernel:    seg = conv3x3(y) + b, act = relu(conv3x3(seg) + b),
//                            g|b = conv3x3(act) + b, out = y*(1+g) + b,
//                            optionally logits = conv1x1(out; Kf) + bf.
// h1 and y go through device memory; seg, act and g|b stay on chip.
//
// What bounds it on the H100: the two 3x3 convs are ~95% of the stage's
// multiply-adds and sit far above the bf16 ridge point (~295 FLOP/byte), so
// launches 1 and 2 are bound by tensor-core operations. They run on the
// eval conv core (eval_conv.cuh): a block owns a spatial tile and all
// output channels, each chunk's halo window arrives once in shared memory
// as 8-channel planes, and wgmma m64nNk16 reads both operands from there:
// A, the pixels, through one matrix descriptor per (tap, channel group)
// pair straight into the window (each tap a shifted view, no copy), B, the
// weights, packed once per model in the descriptor's order and brought by
// one bulk copy per stage. The split-concat parts (of unequal widths) and
// the 1x1 shortcut are K-segments of the same sum, each read through its
// own pointer, so no concatenated tensor is ever built. A part that is a
// seam is read through it (eval_conv.cuh read modes, the TPU kernel's
// _upsample_on_read and _pool_on_read): the decoder's up part arrives as
// the half-height tensor after its W-interpolation and is interpolated
// along H while the window loads (mode 1), an encoder stage's single part
// arrives as its producer's full-resolution output and is max-pooled 2x2
// while the window loads (mode 2); launch 1's segments and launch 2's
// shortcut segments both read it so, and neither the full-resolution up
// tensor nor the pooled tensor is written.
// The tail (stage_common.cuh) is bound by its bytes: seg and g|b on
// mma.sync tensor cores over a 16 x 16 tile, act as f32 FMAs.
//
// Numerics follow the TPU kernel: every conv zero-pads its own input at the
// image border (intermediates outside the image are zeroed, never
// computed from the halo), sums run in f32, conv2's 3x3 sum and its
// shortcut share one accumulator, h1, y, seg, act and g|b are rounded to
// bf16, and the modulate runs in bf16 one operation at a time.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include "eval_conv.cuh"

extern "C" {

// One conv launch of the eval conv core (eval_conv.cuh launch_eval_conv):
// conv1 over the parts, conv2 over h1 and the shortcut's parts; modes: each
// segment's read mode (0 plain, 1 up, 2 pool), h and wd the output's.
int ssu_eval_conv(int nseg, const void* const* ptrs, const int* chans, const int* ks,
                  const int* modes, int nt, const void* w, int nsteps, const void* bias, void* out,
                  int n, int h, int wd, int cout, void* stream) {
  return launch_eval_conv(nseg, ptrs, chans, ks, modes, nt, w, nsteps, bias, nullptr, nullptr,
                          nullptr, out, n, h, wd, cout, (cudaStream_t)stream);
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
