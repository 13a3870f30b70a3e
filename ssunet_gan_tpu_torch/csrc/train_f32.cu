// The train kernels of the training-mode fused stage in float32 on Hopper
// (sm_90a): the f32 dtype of the TPU kernels that take the activation
// dtype, so a model trained in f32 (mixed_precision "False") runs them as
// the JAX package's Pallas kernels do there:
//
//   kernel 2  conv_stats   <- ssunet_gan_tpu/ops/stage_kernel_train.py
//             _conv_stats_call (:232): conv3x3 of one or two parts [+ bias],
//             or of one part through relu(x*a + b) first; (sum, sum of
//             squares) rows. Modes FM_STD, FM_AFF of the f32 conv core.
//   kernel 3  train_tail   <- _tail_call (:435): y = relu(f2*a2 + b2 +
//             conv1x1(parts; Ws)) (FM_RES), then seg, act and gamma|beta
//             with the modulate [+ the head] (FM_SEG, FM_GB: the eval
//             route's launches with the flush), seg and act kept for the
//             backward.
//   kernel 5  fused_conv3  <- ssunet_gan_tpu/ops/train_bwd.py
//             fused_conv3_call (:167): the chain modes of ops/train_bwd.py
//             (gamma FM_STD with a bias, modgrad FM_MODGRAD, seg FM_STD, pre
//             FM_PRE, bn2 FM_BN2, bn1 FM_BN1).
//
// Kernels 4 and 6 in f32 (the weight gradient) are csrc/wgrad_f32.cu's.
//
// What bounds them on the H100: their multiply-adds. At 64-256 channels a
// 3x3 conv does hundreds of multiply-adds per byte it must move, far past
// the ridge points, and in f32 the tensor cores take TF32 only. So the
// products run as 3xTF32: each f32 operand is split into big = tf32(x) and
// small = tf32(x - big), each product is small*big + big*small + big*big in
// f32 sums, at most 495 / 3 = 165 TFLOP/s against the CUDA cores' 67.
//
// Two conv cores, by the launch plan conv_plan below (ops/train_f32.py asks
// for it through ssu_train_f32_plan):
// - f32_wgmma_conv.cuh: the wide modes (FM_STD, FM_AFF, FM_MODGRAD,
//   FM_BN2, FM_BN1 at N blocks of 64, more than 16 output channels) on
//   wgmma, the weights in registers and the windows read by descriptors, a
//   producer warpgroup running the chains and the split ahead of two
//   consumer warpgroups (its header gives the design);
// - f32_conv.cuh's mma.sync core for the rest: those modes at N <= 16 (seg,
//   the flagship's modgrad), FM_PRE (K = labels x 9) and the tail's FM_RES,
//   FM_SEG, FM_GB (the eval route's launches with the flush).
// Both take each K chunk's halo window into shared memory, run segment 0's
// chain once per window value and split it there; the nine taps are shifted
// ldmatrix reads of the split window. The weights change every step:
// ops/train_f32.py packs and splits them at every call (no pack is kept per
// model, unlike the eval route's). The chains run in f32 before the split.
//
// Numerics follow the plain versions (ops/stage_kernel_train.py,
// ops/train_bwd.py) in f32, where every rounding to the activation dtype is
// the identity: the chains round each operation in f32 (no fused
// multiply-add); the tensor cores' sums go into round-to-nearest f32 sums
// (every k8 step on mma.sync, every few on wgmma); the stat rows are summed
// per block in f32 and over the blocks in f64 in a fixed order
// (stats_reduce_kernel).
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "f32_conv.cuh"
#include "f32_wgmma_conv.cuh"
#include "train_common.cuh"

namespace {

// ssu_train_f32_conv's pointer and integer arguments, by position
// (ops/train_f32.py _CONV_PTRS, _CONV_INTS)
enum {
  P_SEG0, P_SEG1, P_SEG2, P_W, P_BIAS, P_Y, P_PRO_F, P_PC, P_EC = P_PC + 4, P_BAND = P_EC + 4,
  P_OUT0 = P_BAND + 4, P_OUT1, P_PARTIAL, P_STATS
};
enum {
  I_NSEG, I_C, I_K = I_C + 3, I_KQ = I_K + 3, I_BN, I_N, I_H, I_W, I_COUT, I_SPLIT, I_RELU
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The launch of one conv in mode at the N tile bn over n images of h x w:
// the wgmma kernel (wide) takes its modes at N blocks of 64 in tiles of
// WC_TH x WC_TW pixels; the mma.sync core the rest, in tiles of f32_th(bn) x
// F_TW. blocks: the tiles along the pixels, the columns of the stat rows'
// per-block partial sums.
struct ConvPlan {
  bool wide;
  int tiles_h, tiles_w;
  long long blocks;
};

ConvPlan conv_plan(int mode, int bn, int n, int h, int w) {
  ConvPlan p;
  p.wide = wc_mode(mode) && bn == WC_BN;
  p.tiles_h = cdiv(h, p.wide ? WC_TH : f32_th(bn));
  p.tiles_w = cdiv(w, p.wide ? WC_TW : F_TW);
  p.blocks = (long long)n * p.tiles_h * p.tiles_w;
  return p;
}

// The wgmma kernel's modes at N <= 16 on the mma.sync core (its narrow N
// tiles; the wide ones are the wgmma kernel's)
template <int MODE>
cudaError_t f32_launch_narrow(F32ConvArgs& a, int n, int bn, int nblocks, cudaStream_t s) {
  if (bn == 8) return f32_launch<8, 1, MODE>(a, n, nblocks, s);
  if (bn == 16) return f32_launch<8, 2, MODE>(a, n, nblocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The plan of ssu_train_f32_conv for a conv of cout columns in mode (the N
// tile as pack_f32_conv packs it, f32_bn): returns 1 for the wgmma kernel,
// 0 for the mma.sync core, and sets *blocks to the columns of its partial
// sums.
int ssu_train_f32_plan(int mode, int cout, int n, int h, int w, long long* blocks) {
  const ConvPlan p = conv_plan(mode, f32_bn(cout), n, h, w);
  *blocks = p.blocks;
  return p.wide ? 1 : 0;
}

// One conv in mode (an F32Mode). p and d hold the pointers and integers
// named by P_* and I_*; a pointer a mode does not use may be null. Segments
// as ssu_f32_conv's (w packed by pack_f32_conv); FM_SEG and FM_GB as its
// FM_EVAL and FM_MOD (bias, relu; y for the modulate); the train modes read
// segment 0's chain tensor pro_f and constants pc, the epilogue's constants
// ec and bands; FM_BN1 writes columns < split to out0 and the rest to out1.
// With stats (and partial, [rows][cout][the plan's blocks] f32),
// stats[r][c] is the mode's r-th sum over the pixels.
int ssu_train_f32_conv(int mode, void* const* p, const int* d, void* stream) {
  if (mode < FM_STD || mode > FM_GB) return (int)cudaErrorInvalidValue;
  const int cout = d[I_COUT], bn = d[I_BN];
  const int rows = fm_rows(mode);
  const ConvPlan plan = conv_plan(mode, bn, d[I_N], d[I_H], d[I_W]);
  bool ok = p[P_OUT0] != nullptr && (p[P_STATS] == nullptr) == (p[P_PARTIAL] == nullptr) &&
            (p[P_STATS] == nullptr || rows > 0) && d[I_N] > 0 && d[I_H] > 0 && d[I_W] > 0 &&
            (p[P_Y] != nullptr) == fm_mod(mode) && !(fm_mod(mode) && (cout & 1)) &&
            (!fm_chain(mode) || p[P_PRO_F] != nullptr);
  for (int i = 0; i < fm_pcst(mode); ++i) ok = ok && p[P_PC + i] != nullptr;
  for (int i = 0; i < fm_ecst(mode); ++i) ok = ok && p[P_EC + i] != nullptr;
  for (int i = 0; i < fm_bands(mode); ++i) ok = ok && p[P_BAND + i] != nullptr;
  if (mode == FM_BN1)
    ok = ok && d[I_NSEG] == 2 && d[I_SPLIT] >= 1 && d[I_SPLIT] <= cout &&
         (d[I_SPLIT] == cout || p[P_OUT1] != nullptr);
  if (!ok) return (int)cudaErrorInvalidValue;
  F32ConvArgs a{};
  const void* segs[3] = {p[P_SEG0], p[P_SEG1], p[P_SEG2]};
  const bool pro_aligned = !fm_chain(mode) || ((uintptr_t)p[P_PRO_F] & 15) == 0;
  cudaError_t e = f32_conv_args(a, d[I_NSEG], segs, d + I_C, d + I_K, p[P_W], d[I_KQ], bn,
                                cout, pro_aligned);
  if (e != cudaSuccess) return (int)e;
  a.bias = (const float*)p[P_BIAS];
  a.y = (const float*)p[P_Y];
  a.out = (float*)p[P_OUT0];
  a.h = d[I_H];
  a.w = d[I_W];
  a.relu = d[I_RELU];
  a.pro_f = (const float*)p[P_PRO_F];
  for (int i = 0; i < 4; ++i) {
    a.pc[i] = (const float*)p[P_PC + i];
    a.ec[i] = (const float*)p[P_EC + i];
    a.band[i] = (const float*)p[P_BAND + i];
  }
  a.out1 = (float*)p[P_OUT1];
  a.split = d[I_SPLIT];
  a.partial = (float*)p[P_PARTIAL];
  a.tiles_h = plan.tiles_h;
  a.tiles_w = plan.tiles_w;
  a.pixel_blocks = (int)plan.blocks;
  const int n = d[I_N], nblocks = cdiv(cout, bn);
  cudaStream_t s = (cudaStream_t)stream;
  if (plan.wide) {
    switch (mode) {
      case FM_STD: e = f32_wgmma_launch<FM_STD>(a, s); break;
      case FM_AFF: e = f32_wgmma_launch<FM_AFF>(a, s); break;
      case FM_MODGRAD: e = f32_wgmma_launch<FM_MODGRAD>(a, s); break;
      case FM_BN2: e = f32_wgmma_launch<FM_BN2>(a, s); break;
      default: e = f32_wgmma_launch<FM_BN1>(a, s); break;
    }
  } else {
    switch (mode) {
      case FM_SEG: e = f32_launch_bn<FM_SEG>(a, n, bn, nblocks, s); break;
      case FM_GB: e = f32_launch_bn<FM_GB>(a, n, bn, nblocks, s); break;
      case FM_STD: e = f32_launch_narrow<FM_STD>(a, n, bn, nblocks, s); break;
      case FM_AFF: e = f32_launch_narrow<FM_AFF>(a, n, bn, nblocks, s); break;
      case FM_MODGRAD: e = f32_launch_narrow<FM_MODGRAD>(a, n, bn, nblocks, s); break;
      case FM_PRE: e = f32_launch_bn<FM_PRE>(a, n, bn, nblocks, s); break;
      case FM_BN2: e = f32_launch_narrow<FM_BN2>(a, n, bn, nblocks, s); break;
      case FM_BN1: e = f32_launch_narrow<FM_BN1>(a, n, bn, nblocks, s); break;
      default: e = f32_launch_bn<FM_RES>(a, n, bn, nblocks, s); break;
    }
  }
  if (e != cudaSuccess || p[P_STATS] == nullptr) return (int)e;
  stats_reduce_kernel<<<dim3((unsigned)cout, (unsigned)rows), RED_THREADS, 0, s>>>(
      a.partial, a.pixel_blocks, cout, static_cast<float*>(p[P_STATS]));
  return (int)cudaGetLastError();
}

}  // extern "C"
