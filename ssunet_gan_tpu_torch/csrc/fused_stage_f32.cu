// Fused eval stage of the ss-UNet family in float32 on Hopper (sm_90a):
// the f32 route of the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py
// fused_eval_stage (_stage_call -> pl.pallas_call), which takes the
// activation dtype: the JAX package runs it in f32 where a model's
// activations are f32, as in the trainers' val / test evaluations.
//
// One stage (BasicBlock + self-SPADE, BatchNorm folded into the weights)
// runs as five launches of one conv kernel (six with the folded head):
//   conv:      h1  = relu(conv3x3(x; K1*s1) + t1)
//   conv:      y   = relu(conv3x3(h1; K2*s2) + conv1x1(x; Ks) + t2)
//   conv:      seg = conv3x3(y; Kx) + bx
//   conv:      act = relu(conv3x3(seg; Km) + bm)
//   conv + modulate, in its epilogue:
//              out = y * (1 + (conv3x3(act; Kg) + bg)) + (conv3x3(act; Kb) + bb)
//   conv:      logits = conv1x1(out; Kf) + bf           (folded head only)
// h1, y, seg, act and out go through device memory; the 2C-wide g|b map
// does not (its columns are interleaved, g_c beside b_c, so the thread that
// holds one holds the other).
//
// What bounds it on the H100: a 3x3 conv at 64-256 channels does 9*C
// multiply-adds per input value, far above either ridge point, so the
// stage is bound by its operations. On the CUDA cores f32 runs at 67
// TFLOP/s; the tensor cores take TF32 (10 explicit mantissa bits) at 495.
// So the products run as 3xTF32 on the tensor cores: each f32 operand x is
// split into big = tf32(x) (rounded to nearest, ties away) and small =
// tf32(x - big), and each product is big*big + big*small + small*big,
// summed in the f32 accumulators (the small*small term, ~2^-22 of the
// product, is dropped). big + small is x to within ~2^-22 relative, so the
// sums agree with f32 products summed in another order. Three tensor-core
// products per f32 product put the ceiling at 495 / 3 = 165 TFLOP/s, above
// the CUDA cores' 67. The weights are split once, at pack time
// (ops/stage_kernel.py pack_f32_conv); the activations as each chunk's
// window lands in shared memory, once per element and chunk (the nine taps
// and both warp columns read the split window).
//
// The design, per block of eight warps (256 threads):
//   - the block owns a TH x 16 output tile of one image and BN output
//     channels (BN 64 for a wide conv, in N blocks; 8 or 16 for the narrow
//     seg, act and head convs, whose N is the labels, the hidden width or
//     the classes); each warp holds 4 m16 tiles (4 tile rows of 16 pixels)
//     by 4 n8 tiles (1 or 2 for the narrow convs) of mma.sync m16n8k8 tf32;
//   - K runs over up to three segments (split-concat parts of unequal
//     widths, the 1x1 shortcut, each read through its own pointer), each in
//     chunks of 8 channels (4 for a source of <= 4 channels: the input
//     image, the labels, a narrow hidden map), channels past the source's
//     width zero. A chunk's (TH+2) x 18 window (one-pixel halo, the image
//     border's zero padding written into it; a 1x1 segment reads its centre)
//     arrives once through 16-byte cp.async (channels innermost, as 4-channel
//     planes [pixel][4]) and the chunk's weight slice (big and small) beside
//     it, double-buffered: the next chunk's copies run while this one's
//     products do;
//   - a k8 step is two (tap, 4-channel quad) pairs of the chunk, so the nine
//     taps are shifted ldmatrix reads of the one window (a row of an 8x4
//     f32 matrix is one pixel's quad, 16 bytes; eight neighbouring pixels
//     are 128 contiguous bytes, free of bank conflicts); a chunk with an odd
//     number of pairs pads one with zero weights that reads a zero piece;
//   - no integer division by a runtime value in the loads: the window's
//     row and column come from divisions by compile-time constants.
// A SIMT f32 design tops out at the CUDA cores' 39.19 ms for the flagship's
// six stages at batch 8; 3xTF32's bound is 15.9 ms.
//
// Non-finite inputs keep the plain version's output classes (finite, NaN,
// +inf, -inf): an inf would make small = inf - inf = NaN, and a product
// big*small of an inf with a weight's small part of the other sign would
// turn a sum that f32 takes to +-inf into NaN. So an inf or NaN window
// element is split as big = itself, small = 0, and a chunk whose window
// holds one (found by the block as it splits the window) runs its big x
// small products with that element as 0: the element then contributes only
// big(x) * big(w) (an infinity of the product's sign, or NaN where w = 0 or
// x is NaN), as x * w does in f32. Finite values near the f32 limit split
// without overflow (big rounds toward zero where rounding up would pass
// it).
//
// Numerics, as the plain versions (ops/stage_kernel.py f32_conv_reference):
// every segment of a conv in one f32 sum, then the bias, then ReLU (a NaN
// stays, as torch.relu keeps it); the modulate adds 1 to g, multiplies by y
// and then adds b, each rounded in f32, with no fused multiply-add.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

// The kernel (f32_conv_kernel in its modes FM_EVAL and FM_MOD) and its
// launch are f32_conv.cuh's, shared with the f32 train kernels.
#include "f32_conv.cuh"

extern "C" {

// One conv over nseg (<= 3) segments: ptrs, chans and ks (3 or 1) per
// segment; w the weight packed by ops/stage_kernel.py pack_f32_conv
// ([2][nb][kq][bn][4], kq K quads per N block); bias (or null) in its
// column order; relu 0/1; with y (not null) the modulate epilogue, cout
// then the 2C interleaved g|b columns and out [n*h*w][C], else out
// [n*h*w][cout].
int ssu_f32_conv(int nseg, const void* const* ptrs, const int* chans, const int* ks,
                 const void* w, int kq, int bn, const void* bias, int relu, const void* y,
                 void* out, int n, int h, int wd, int cout, void* stream) {
  if (y && (cout & 1)) return (int)cudaErrorInvalidValue;
  F32ConvArgs a{};
  const cudaError_t e = f32_conv_args(a, nseg, ptrs, chans, ks, w, kq, bn, cout, true);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (cout + bn - 1) / bn;
  a.bias = (const float*)bias;
  a.y = (const float*)y;
  a.out = (float*)out;
  a.h = h;
  a.w = wd;
  a.relu = relu;
  return (int)(y ? f32_launch_bn<FM_MOD>(a, n, bn, nblocks, (cudaStream_t)stream)
                 : f32_launch_bn<FM_EVAL>(a, n, bn, nblocks, (cudaStream_t)stream));
}

}  // extern "C"
