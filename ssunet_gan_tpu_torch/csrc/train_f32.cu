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
//   kernel 4  wgrad        <- _wgrad_w (:766): dW of a 3x3 conv, the
//             cotangent as it is (the v2 backward; G_RAW below).
//   kernel 5  fused_conv3  <- ssunet_gan_tpu/ops/train_bwd.py
//             fused_conv3_call (:167): the chain modes of ops/train_bwd.py
//             (gamma FM_STD with a bias, modgrad FM_MODGRAD, seg FM_STD, pre
//             FM_PRE, bn2 FM_BN2, bn1 FM_BN1).
//   kernel 6  fused_wgrad  <- fused_wgrad_call (:374): dW with the x side
//             (optionally relu(x*a + b)) and the cotangent (as it is,
//             [g*y ; g], or the BN-backward chain) rebuilt in the kernel.
//
// What bounds them on the H100: their multiply-adds. At 64-256 channels a
// 3x3 conv or weight gradient does hundreds of multiply-adds per byte it
// must move, far past the ridge points, and in f32 the tensor cores take
// TF32 only. So the products run as 3xTF32 on mma.sync m16n8k8 (as the
// eval route, fused_stage_f32.cu, whose header sets out the split): each
// f32 operand is split into big = tf32(x) and small = tf32(x - big), each
// product is small*big + big*small + big*big in f32 sums, at most 495 / 3 =
// 165 TFLOP/s against the CUDA cores' 67.
//
// The convs (kernels 2, 3 and 5) are f32_conv.cuh's core: a block owns a
// tile of one image and an N block of output channels, each K chunk's halo
// window arrives through cp.async, segment 0's chain runs once per window
// value in shared memory and the window is split in place, the nine taps are
// shifted ldmatrix reads of the split window. The weights change every step:
// ops/train_f32.py packs and splits them at every call (no pack is kept per
// model, unlike the eval route's). The chains run in f32 before the split.
//
// The weight gradient (kernels 4 and 6): dW^T = x-taps^T . cot over the
// pixels. A block owns one input chunk (16 or 32 channels: M = the nine taps
// x the chunk, 9 or 18 m16 tiles), an N block of up to 32 dW rows and a run
// of 8 x 16 pixel tiles (K, eight pixels per k8 step); its 8 warps split M
// four ways and each tile row's two 8-pixel halves two ways, every warp
// with all the block's dW rows (each fragment read from shared memory feeds
// more products; the two halves' sums meet in dW). Per tile the x window
// (one-pixel halo) and the cotangent's sources arrive through cp.async,
// double-buffered; the x prologue and the cotangent chain run once per value
// and both are split in shared memory (big in place, small beside); the
// fragments are read as 32-bit values, the row strides chosen so that a
// warp's 32 reads hit 32 banks (tf32 fragments cannot be transposed by
// ldmatrix). The tensor cores' f32 sums are moved into round-to-nearest f32
// sums every two k8 steps (f32_conv.cuh says why), and the warps' sums into
// dW (f64) by atomics.
//
// Numerics follow the plain versions (ops/stage_kernel_train.py,
// ops/train_bwd.py) in f32, where every rounding to the activation dtype is
// the identity: the chains round each operation in f32 (no fused
// multiply-add); the stat rows are summed per block in f32 and over the
// blocks in f64 in a fixed order (stats_reduce_kernel). A non-finite input
// of the weight gradient gives a non-finite dW (the plain version's inf may
// come out as NaN: no per-chunk flag as in the conv core).
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches.

#include "f32_conv.cuh"
#include "train_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The weight gradient
// ---------------------------------------------------------------------------

enum WgMode {
  WG_RAW = 0,      // the cotangent g as it is
  WG_MODGRAD = 1,  // rows [0, c_g): g*g2; rows [c_g, 2 c_g): g
  WG_BN = 2,       // p*(g - q - (g2*r' - m')), the BN-backward chain
};

constexpr int W_TH = 8, W_TW = 16, W_WW = W_TW + 2;
constexpr int W_WPIX = (W_TH + 2) * W_WW;  // window pixels (180)
constexpr int W_TPIX = W_TH * W_TW;        // tile pixels (128)
constexpr int W_MT = 18;                   // m16 tiles of 9 taps x 32 channels

// x window row stride for a chunk of cc (16 or 32) channels, and the
// cotangent tile's for NT rows: 8 mod 32 floats (or 24 for 16), so the
// lanes' (pixel t, channel g) reads fall on distinct banks
__host__ __device__ constexpr int wg_xs(int cc) { return cc + 8; }
__host__ __device__ constexpr int wg_gs(int nt) { return nt == 8 ? 8 : nt + 8; }

__host__ __device__ inline int wg_smem(int gmode, int nt, int cc) {
  const int x = 3 * W_WPIX * wg_xs(cc);  // two raw windows, one of small parts
  const int g = (gmode == WG_RAW ? 3 : 5) * W_TPIX * wg_gs(nt);
  return 4 * (x + g);
}

struct WgArgs {
  const float* x[2];  // the input parts, [m][xc]
  int xc[2], xvec[2], xoff[2], nchunk[2];
  int cc;             // channels per chunk (16 or 32), shared by the parts
  const float* pro_a;  // relu(x*a + b) on the single part, or null
  const float* pro_b;
  const float* g;     // [m][c_g]
  const float* g2;    // [m][c_g]: y (WG_MODGRAD) or f (WG_BN)
  const float* cst[4];  // WG_BN: p, q, r', m' per dW row
  int c_g, gvec;
  int cout, cin;      // dW rows; input channels over the parts
  double* dw;         // [cout][cin][3][3], summed into
  int n, h, w, tiles_w, tiles_h, ntiles, tiles_per_split;
};

template <int GM, int NT>
__global__ void __launch_bounds__(F_THREADS, 1) wgrad_f32_kernel(const WgArgs a) {
  // warps: 4 along M (the (tap, channel) tiles) x 2 along K (the two
  // 8-pixel halves of each tile row), each with every dW row of the block
  constexpr int WARPS_M = 4, WARPS_K = 2;
  constexpr int MI = (W_MT + WARPS_M - 1) / WARPS_M;  // m16 tiles per warp, at most
  constexpr int NI = NT / 8;
  constexpr int GS = wg_gs(NT);
  extern __shared__ __align__(16) float wsm[];
  const int cc = a.cc, xs = wg_xs(cc);
  float* xraw = wsm;                          // [2][W_WPIX][xs]
  float* xsm = xraw + 2 * W_WPIX * xs;        // [W_WPIX][xs] small parts
  float* graw = xsm + W_WPIX * xs;            // [2][W_TPIX][GS]
  float* gsm = graw + 2 * W_TPIX * GS;        // [W_TPIX][GS] small parts
  float* g2raw = gsm + W_TPIX * GS;           // [2][W_TPIX][GS] (not WG_RAW)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wk = warp / WARPS_M;
  const int H = a.h, W = a.w;
  const int r0 = blockIdx.y * NT;
  const int part = (int)blockIdx.x >= a.nchunk[0];
  const int chunk = part ? blockIdx.x - a.nchunk[0] : blockIdx.x;
  const float* xp = part ? a.x[1] : a.x[0];
  const int xc = part ? a.xc[1] : a.xc[0];
  const int xvec = part ? a.xvec[1] : a.xvec[0];
  const int xoff = part ? a.xoff[1] : a.xoff[0];
  const float* pa = part ? nullptr : a.pro_a;
  const float* pb = a.pro_b;
  const int cb = chunk * cc;
  const int mtn = 9 * (cc / 16);  // m16 tiles of this block
  const int t_begin = blockIdx.z * a.tiles_per_split;
  int t_end = t_begin + a.tiles_per_split;
  if (t_end > a.ntiles) t_end = a.ntiles;
  const int nstage = t_end - t_begin;
  if (nstage <= 0) return;
  const int C = a.c_g;

  auto tile_at = [&](int T, long long& img_base, int& oh0, int& ow0) {
    const int tw_i = T % a.tiles_w;
    const int rest = T / a.tiles_w;
    const int th_i = rest % a.tiles_h;
    img_base = (long long)(rest / a.tiles_h) * H * W;
    oh0 = th_i * W_TH;
    ow0 = tw_i * W_TW;
  };

  // tile s's x window and cotangent sources into buffer s & 1
  auto issue = [&](int s) {
    long long img_base;
    int oh0, ow0;
    tile_at(t_begin + s, img_base, oh0, ow0);
    const int buf = s & 1;
    float* xb = xraw + buf * W_WPIX * xs;
    const int pieces = cc / 4;
    for (int i = tid; i < W_WPIX * pieces; i += F_THREADS) {
      const int px = i / pieces, piece = i - px * pieces;
      const int wr = px / W_WW, wc = px - wr * W_WW;
      const int ih = oh0 - 1 + wr, iw = ow0 - 1 + wc;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const int c0 = cb + piece * 4;
      const long long pix = img_base + (long long)ih * W + iw;
      float* d = xb + px * xs + piece * 4;
      if (xvec) {
        const bool ok = in && c0 < xc;
        cp16(d, ok ? xp + pix * xc + c0 : xp, ok);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) d[k] = (in && c0 + k < xc) ? __ldg(xp + pix * xc + c0 + k) : 0.f;
      }
    }
    float* gb = graw + buf * W_TPIX * GS;
    float* g2b = g2raw + buf * W_TPIX * GS;
    for (int i = tid; i < W_TPIX * (NT / 4); i += F_THREADS) {
      const int px = i / (NT / 4), piece = i - px * (NT / 4);
      const int oh = oh0 + px / W_TW, ow = ow0 + px % W_TW;
      const bool in = oh < H && ow < W;
      const long long pix = img_base + (long long)oh * W + ow;
      const int row = r0 + piece * 4;
      float* d = gb + px * GS + piece * 4;
      float* d2 = g2b + px * GS + piece * 4;
      if (a.gvec) {  // c_g % 4 == 0: a piece lies in one half of WG_MODGRAD's rows
        const bool ok = in && row < a.cout;
        const int col = (GM == WG_MODGRAD && row >= C) ? row - C : row;
        cp16(d, ok ? a.g + pix * C + col : a.g, ok);
        if (GM != WG_RAW) {
          const bool two = ok && (GM != WG_MODGRAD || row < C);
          cp16(d2, two ? a.g2 + pix * C + col : a.g2, two);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rq = row + k;
          const bool ok = in && rq < a.cout;
          const int col = (GM == WG_MODGRAD && rq >= C) ? rq - C : rq;
          d[k] = ok ? __ldg(a.g + pix * C + col) : 0.f;
          if (GM != WG_RAW)
            d2[k] = (ok && (GM != WG_MODGRAD || rq < C)) ? __ldg(a.g2 + pix * C + col) : 0.f;
        }
      }
    }
  };

  float acc[MI][NI][4], sum[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ni][e] = sum[i][ni][e] = 0.f;

  const int g = lane >> 2, t = lane & 3;
  // the lane's A base of each of its m16 tiles: (tap, 16 channels) rows
  int a_base[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int mt = wm + i * WARPS_M;
    const int tap = mt / (cc / 16), h16 = mt - tap * (cc / 16);
    a_base[i] = ((tap / 3) * W_WW + tap % 3) * xs + h16 * 16 + g;
  }

  issue(0);
  cp_commit();
#pragma unroll 1
  for (int s = 0; s < nstage; ++s) {
    const int buf = s & 1;
    if (s + 1 < nstage) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    long long img_base;
    int oh0, ow0;
    tile_at(t_begin + s, img_base, oh0, ow0);
    // the x side: the prologue (in-image values of real channels), the split
    float* xb = xraw + buf * W_WPIX * xs;
    for (int i = tid; i < W_WPIX * cc; i += F_THREADS) {
      const int px = i / cc, c = i - px * cc;
      float v = xb[px * xs + c];
      if (pa != nullptr) {
        const int wr = px / W_WW, wc = px - wr * W_WW;
        const int ih = oh0 - 1 + wr, iw = ow0 - 1 + wc;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W && cb + c < xc)
          v = relu_nan(__fadd_rn(__fmul_rn(v, __ldg(pa + cb + c)), __ldg(pb + cb + c)));
      }
      float big, small;
      bool bad = false;
      split_tf32(v, big, small, bad);
      xb[px * xs + c] = big;
      xsm[px * xs + c] = small;
    }
    // the cotangent: the chain (0 outside the image and past the rows), the split
    float* gb = graw + buf * W_TPIX * GS;
    const float* g2b = g2raw + buf * W_TPIX * GS;
    for (int i = tid; i < W_TPIX * NT; i += F_THREADS) {
      const int px = i / NT, rl = i - px * NT;
      const int row = r0 + rl;
      float v = gb[px * GS + rl];
      if constexpr (GM != WG_RAW) {
        const int oh = oh0 + px / W_TW, ow = ow0 + px % W_TW;
        if (oh >= H || ow >= W || row >= a.cout) {
          v = 0.f;
        } else if (GM == WG_MODGRAD) {
          if (row < C) v = __fmul_rn(v, g2b[px * GS + rl]);
        } else {
          v = bn_chain_f32(v, g2b[px * GS + rl], __ldg(a.cst[0] + row), __ldg(a.cst[1] + row),
                           __ldg(a.cst[2] + row), __ldg(a.cst[3] + row));
        }
      }
      float big, small;
      bool bad = false;
      split_tf32(v, big, small, bad);
      gb[px * GS + rl] = big;
      gsm[px * GS + rl] = small;
    }
    __syncthreads();
    // 16 k8 steps, 8 per warp: tile row r, pixel columns c8..c8+7
    const int c8 = wk * 8;
#pragma unroll 1
    for (int r = 0; r < W_TH; r += 2) {
#pragma unroll
      for (int rr = r; rr < r + 2; ++rr) {
        const int px0 = (rr * W_WW + c8 + t) * xs;  // the lane's pixel in the window, tap (0, 0)
        const int gp0 = (rr * W_TW + c8 + t) * GS;  // and in the cotangent tile
        uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int col = ni * 8 + g;
          bb[ni][0] = __float_as_uint(gb[gp0 + col]);
          bb[ni][1] = __float_as_uint(gb[gp0 + 4 * GS + col]);
          bs[ni][0] = __float_as_uint(gsm[gp0 + col]);
          bs[ni][1] = __float_as_uint(gsm[gp0 + 4 * GS + col]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (wm + i * WARPS_M >= mtn) continue;  // uniform across the warp
          const int o = a_base[i] + px0;
          uint32_t ah[4], al[4];
          ah[0] = __float_as_uint(xb[o]);
          ah[1] = __float_as_uint(xb[o + 8]);
          ah[2] = __float_as_uint(xb[o + 4 * xs]);
          ah[3] = __float_as_uint(xb[o + 4 * xs + 8]);
          al[0] = __float_as_uint(xsm[o]);
          al[1] = __float_as_uint(xsm[o + 8]);
          al[2] = __float_as_uint(xsm[o + 4 * xs]);
          al[3] = __float_as_uint(xsm[o + 4 * xs + 8]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            mma_tf32(acc[i][ni], al, bb[ni]);
            mma_tf32(acc[i][ni], ah, bs[ni]);
            mma_tf32(acc[i][ni], ah, bb[ni]);
          }
        }
      }
      // the tensor cores' sums into round-to-nearest f32 sums every two k8 steps
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[i][ni][e] += acc[i][ni][e];
            acc[i][ni][e] = 0.f;
          }
    }
    __syncthreads();
  }
  cp_wait0();

  // dW[row][ch][tap]: M rows of a tile are (tap, channel) pairs, N the dW rows
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int mt = wm + i * WARPS_M;
    if (mt >= mtn) continue;
    const int tap = mt / (cc / 16), h16 = mt - tap * (cc / 16);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ch = cb + h16 * 16 + g + 8 * hh;
      if (ch >= xc) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + ni * 8 + 2 * t + e;
          if (row < a.cout)
            atomicAdd(a.dw + ((long long)row * a.cin + xoff + ch) * 9 + tap,
                      (double)sum[i][ni][2 * hh + e]);
        }
    }
  }
}

template <int GM, int NT>
cudaError_t wgrad_launch(const WgArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_f32_kernel<GM, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg_smem(GM, NT, 32));  // the widest chunk's
    if (e != cudaSuccess) return e;
    attr = true;
  }
  wgrad_f32_kernel<GM, NT><<<grid, F_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int GM>
cudaError_t wgrad_by_nt(int nt, const WgArgs& a, dim3 grid, int smem, cudaStream_t s) {
  if (nt == 8) return wgrad_launch<GM, 8>(a, grid, smem, s);
  if (nt == 16) return wgrad_launch<GM, 16>(a, grid, smem, s);
  return wgrad_launch<GM, 32>(a, grid, smem, s);
}

// ssu_train_f32_conv's pointer and integer arguments, by position
// (ops/train_f32.py _CONV_PTRS, _CONV_INTS)
enum {
  P_SEG0, P_SEG1, P_SEG2, P_W, P_BIAS, P_Y, P_PRO_F, P_PC, P_EC = P_PC + 4, P_BAND = P_EC + 4,
  P_OUT0 = P_BAND + 4, P_OUT1, P_PARTIAL, P_STATS
};
enum { I_NSEG, I_C, I_K = I_C + 3, I_KQ = I_K + 3, I_BN, I_N, I_H, I_W, I_COUT, I_SPLIT, I_RELU };

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Blocks along the pixels of ssu_train_f32_conv for cout columns: the
// columns of its per-block partial sums.
long long ssu_train_f32_blocks(int cout, int n, int h, int w) {
  return f32_pixel_blocks(cout, n, h, w);
}

// One conv of the f32 core in mode (an F32Mode). p and d hold the pointers
// and integers named by P_* and I_*; a pointer a mode does not use may be
// null. Segments as ssu_f32_conv's (w packed by pack_f32_conv); FM_SEG
// and FM_GB as its FM_EVAL and FM_MOD (bias, relu; y for the modulate); the
// train modes
// read segment 0's chain tensor pro_f and constants pc, the epilogue's
// constants ec and bands; FM_BN1 writes columns < split to out0 and the
// rest to out1. With stats (and partial, [rows][cout][ssu_train_f32_blocks]
// f32), stats[r][c] is the mode's r-th sum over the pixels.
int ssu_train_f32_conv(int mode, void* const* p, const int* d, void* stream) {
  if (mode < FM_STD || mode > FM_GB) return (int)cudaErrorInvalidValue;
  const int cout = d[I_COUT], bn = d[I_BN];
  const int rows = fm_rows(mode);
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
  const int n = d[I_N], nblocks = cdiv(cout, bn);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case FM_SEG: e = f32_launch_bn<FM_SEG>(a, n, bn, nblocks, s); break;
    case FM_GB: e = f32_launch_bn<FM_GB>(a, n, bn, nblocks, s); break;
    case FM_STD: e = f32_launch_bn<FM_STD>(a, n, bn, nblocks, s); break;
    case FM_AFF: e = f32_launch_bn<FM_AFF>(a, n, bn, nblocks, s); break;
    case FM_MODGRAD: e = f32_launch_bn<FM_MODGRAD>(a, n, bn, nblocks, s); break;
    case FM_PRE: e = f32_launch_bn<FM_PRE>(a, n, bn, nblocks, s); break;
    case FM_BN2: e = f32_launch_bn<FM_BN2>(a, n, bn, nblocks, s); break;
    case FM_BN1: e = f32_launch_bn<FM_BN1>(a, n, bn, nblocks, s); break;
    default: e = f32_launch_bn<FM_RES>(a, n, bn, nblocks, s); break;
  }
  if (e != cudaSuccess || p[P_STATS] == nullptr) return (int)e;
  const long long nb = f32_pixel_blocks(cout, n, a.h, a.w);
  stats_reduce_kernel<<<dim3((unsigned)cout, (unsigned)rows), RED_THREADS, 0, s>>>(
      a.partial, nb, cout, static_cast<float*>(p[P_STATS]));
  return (int)cudaGetLastError();
}

// dw[cout][cin][3][3] += sum over pixels of cot[p][o] * x[p + tap][i] (dw
// f64, zeroed by the caller, cin the parts' channels summed); x = up to two
// parts, a single one optionally relu(x*a + b); the cotangent (gmode: a
// WgMode) from g and g2, [m][c_g] each, and cst (four pointers; WG_BN: p,
// q, r', m').
int ssu_train_f32_wgrad(int gmode, const void* s0, int c0, const void* s1, int c1,
                        const void* pro_a, const void* pro_b, const void* g, const void* g2,
                        const void* const* cst, int cout, int c_g, void* dw, int n, int h,
                        int wd, void* stream) {
  WgArgs a = {};
  const int nparts = c1 > 0 ? 2 : 1;
  if (gmode < WG_RAW || gmode > WG_BN || s0 == nullptr || c0 <= 0 || g == nullptr ||
      (nparts == 2 && s1 == nullptr) || (pro_a != nullptr && (nparts != 1 || pro_b == nullptr)) ||
      (gmode != WG_RAW && g2 == nullptr) || (gmode == WG_RAW && c_g != cout) ||
      (gmode == WG_MODGRAD && 2 * c_g != cout) ||
      (gmode == WG_BN && (c_g != cout || cst[0] == nullptr || cst[1] == nullptr ||
                          cst[2] == nullptr || cst[3] == nullptr)) ||
      cout < 1 || n <= 0 || h <= 0 || wd <= 0 || dw == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* xs[2] = {s0, s1};
  const int xcs[2] = {c0, c1};
  a.cc = c0 <= 16 && (nparts == 1 || c1 <= 16) ? 16 : 32;
  int colblocks = 0, off = 0;
  for (int i = 0; i < nparts; ++i) {
    a.x[i] = static_cast<const float*>(xs[i]);
    a.xc[i] = xcs[i];
    a.xvec[i] = xcs[i] % 4 == 0 && (uintptr_t)xs[i] % 16 == 0;
    a.xoff[i] = off;
    a.nchunk[i] = cdiv(xcs[i], a.cc);
    off += xcs[i];
    colblocks += a.nchunk[i];
  }
  if (nparts == 1) a.nchunk[1] = 0;
  a.pro_a = static_cast<const float*>(pro_a);
  a.pro_b = static_cast<const float*>(pro_b);
  a.g = static_cast<const float*>(g);
  a.g2 = static_cast<const float*>(g2);
  for (int i = 0; i < 4; ++i) a.cst[i] = static_cast<const float*>(cst[i]);
  a.c_g = c_g;
  a.gvec = c_g % 4 == 0 && (uintptr_t)g % 16 == 0 && (g2 == nullptr || (uintptr_t)g2 % 16 == 0);
  a.cout = cout;
  a.cin = off;
  a.dw = static_cast<double*>(dw);
  a.n = n;
  a.h = h;
  a.w = wd;
  a.tiles_w = cdiv(wd, W_TW);
  a.tiles_h = cdiv(h, W_TH);
  a.ntiles = n * a.tiles_w * a.tiles_h;
  const int nt = cout > 16 ? 32 : cout > 8 ? 16 : 8;
  const int nblocks = cdiv(cout, nt);
  // the pixels split so that ~4 blocks per SM (one resident) are in
  // flight, each with at least 4 tiles
  int splits = cdiv(132 * 4, colblocks * nblocks);
  const int max_splits = cdiv(a.ntiles, 4);
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  a.tiles_per_split = cdiv(a.ntiles, splits);
  splits = cdiv(a.ntiles, a.tiles_per_split);
  const dim3 grid((unsigned)colblocks, (unsigned)nblocks, (unsigned)splits);
  const int smem = wg_smem(gmode, nt, a.cc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (gmode) {
    case WG_RAW: return (int)wgrad_by_nt<WG_RAW>(nt, a, grid, smem, s);
    case WG_MODGRAD: return (int)wgrad_by_nt<WG_MODGRAD>(nt, a, grid, smem, s);
    default: return (int)wgrad_by_nt<WG_BN>(nt, a, grid, smem, s);
  }
}

}  // extern "C"
