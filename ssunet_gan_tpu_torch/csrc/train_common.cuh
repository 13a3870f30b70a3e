// Shared device code of the port's train kernels (train_stage.cu,
// train_bwd.cu), on top of stage_common.cuh: the reduction of the conv
// cores' per-block sums, and the v2 backward's weight-gradient core, a GEMM
// over the pixels (M = dW rows, N = taps x input channels, K = N*H*W)
// split across blocks and summed into dW with f32 atomics. Everything is in
// an anonymous namespace.

#pragma once

#include "stage_common.cuh"

namespace {

// stats[s][c] = sum over blocks of partial[s][c][b]; one block per (c, s).
constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(RED_THREADS)
stats_reduce_kernel(const float* partial, long long nb, int cout, float* stats) {
  __shared__ float sm[RED_THREADS];
  const int c = blockIdx.x, s = blockIdx.y;
  const float* p = partial + ((long long)s * cout + c) * nb;
  float v = 0.f;
  for (long long b = threadIdx.x; b < nb; b += RED_THREADS) v += p[b];
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int k = RED_THREADS / 2; k > 0; k >>= 1) {
    if ((int)threadIdx.x < k) sm[threadIdx.x] += sm[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[s * cout + c] = sm[0];
}

// ---------------------------------------------------------------------------
// wgrad: dW[cout][kp] = sum_p g[p][c] * x9[p][k], split over the pixels.
// ---------------------------------------------------------------------------

constexpr int WM = 64;               // output channels (rows of dW) per block
constexpr int WN = 64;               // dW columns per block (two K chunks)
constexpr int WG_THREADS = 128;      // 4 warps, 2 x 2, 32 x 32 each
// The tensor cores' f32 accumulation truncates, so its error grows with the
// number of MMAs chained into one accumulator (thousands per block at level
// 0, where a weight gradient can cancel to a few thousandths of its terms'
// magnitude). Each block therefore moves its MMA sums into a second f32
// accumulator with round-to-nearest adds every WG_FLUSH steps (8 MMAs).
constexpr int WG_FLUSH = 4;

struct WgradArgs {
  Src src[2];
  int nsrc;
  const float* pro_a;  // [src0.c] prologue on source 0, or null
  const float* pro_b;
  const bf16* g;       // [m][cout]
  int cout;
  int gvec;            // 16-byte loads of g allowed
  float* dw;           // [cout][kp], summed into with atomics
  int kp;
  int h, w;
  long long m;
  long long per_split;  // pixels per blockIdx.z, a multiple of BK
};

__device__ __forceinline__ void wgrad_body(const WgradArgs& args) {
  // operands stored transposed (row = dW row or column, col = pixel), so
  // the MMA fragments read pixel pairs as in the conv kernel
  __shared__ __align__(16) unsigned short As[2][WM][LDS];
  __shared__ __align__(16) unsigned short Bs[2][WN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int r0 = blockIdx.x * WM;
  const int k0 = blockIdx.y * WN;
  const long long p_begin = (long long)blockIdx.z * args.per_split;
  long long p_end = p_begin + args.per_split;
  if (p_end > args.m) p_end = args.m;
  if (p_begin >= p_end) return;
  const int H = args.h, W = args.w;
  const long long hw = (long long)H * W;
  // each thread loads one pixel row (pl) of the step: 8 channels of g at
  // two offsets, 8 channels of each of the two K chunks
  const int pl = tid >> 2, grp = tid & 3;
  int c_s[2], c_tap[2], c_c0[2];
  bool c_ok[2];
  Src c_src[2];  // each chunk's source, copied once (no indexed parameter reads in the loop)
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int kb = k0 + q * BK;
    c_ok[q] = kb < args.kp;
    k_step(args.src, args.nsrc, c_ok[q] ? kb / BK : 0, c_s[q], c_tap[q], c_c0[q]);
    c_c0[q] += grp * 8;
    c_src[q] = args.src[c_s[q]];
  }

  const int ktiles = (int)((p_end - p_begin + BK - 1) / BK);
  uint4 ra[2], rb[2];

  auto load_tile = [&](int kt) {
    const long long p = p_begin + (long long)kt * BK + pl;
    const bool ok = p < p_end;
    long long img = 0;
    int oh = 0, ow = 0;
    if (ok) {
      img = p / hw;
      const long long rem = p - img * hw;
      oh = (int)(rem / W);
      ow = (int)(rem - (long long)oh * W);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = r0 + grp * 8 + 32 * i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok && c < args.cout) {
        const bf16* gp = args.g + (p * args.cout + c);
        if (args.gvec && c + 8 <= args.cout) {
          v = *reinterpret_cast<const uint4*>(gp);
        } else {
          const unsigned short* ps = reinterpret_cast<const unsigned short*>(gp);
          unsigned short e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = (c + j < args.cout) ? ps[j] : 0;
          v.x = e[0] | ((uint32_t)e[1] << 16);
          v.y = e[2] | ((uint32_t)e[3] << 16);
          v.z = e[4] | ((uint32_t)e[5] << 16);
          v.w = e[6] | ((uint32_t)e[7] << 16);
        }
      }
      ra[i] = v;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const Src& S = c_src[q];
      const int ih = oh + c_tap[q] / 3 - 1, iw = ow + c_tap[q] % 3 - 1;
      if (ok && c_ok[q] && ih >= 0 && ih < H && iw >= 0 && iw < W && c_c0[q] < S.c)
        v = load8(S, img * hw + (long long)ih * W + iw, c_c0[q],
                  c_s[q] == 0 ? args.pro_a : nullptr,
                  c_s[q] == 0 ? args.pro_b : nullptr);
      rb[q] = v;
    }
  };

  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t u[4] = {ra[i].x, ra[i].y, ra[i].z, ra[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        As[buf][grp * 8 + 32 * i + 2 * j][pl] = (unsigned short)(u[j] & 0xffffu);
        As[buf][grp * 8 + 32 * i + 2 * j + 1][pl] = (unsigned short)(u[j] >> 16);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t u[4] = {rb[q].x, rb[q].y, rb[q].z, rb[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Bs[buf][q * BK + grp * 8 + 2 * j][pl] = (unsigned short)(u[j] & 0xffffu);
        Bs[buf][q * BK + grp * 8 + 2 * j + 1][pl] = (unsigned short)(u[j] >> 16);
      }
    }
  };

  float acc[2][4][4], sum[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = sum[mi][ni][e] = 0.f;

  load_tile(0);
  store_tile(0);
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load_tile(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + 2 * t]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + 2 * t]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + 8 + 2 * t]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cur][nn][kk + 2 * t]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cur][nn][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < ktiles) store_tile(cur ^ 1);
    if (kt % WG_FLUSH == WG_FLUSH - 1 || kt + 1 == ktiles) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[mi][ni][e] += acc[mi][ni][e];
            acc[mi][ni][e] = 0.f;
          }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wm * 32 + mi * 16 + g + 8 * half;
        if (row >= args.cout) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + wn * 32 + ni * 8 + 2 * t + e;
          if (col < args.kp)
            atomicAdd(args.dw + (long long)row * args.kp + col, sum[mi][ni][2 * half + e]);
        }
      }
}

// Fill a weight gradient's sources, pixel split and grid: about eight
// blocks per SM in flight, with at least eight steps (256 pixels) per
// block. Returns false for arguments the kernel does not take.
bool wgrad_setup(WgradArgs& a, dim3& grid, const void* s0, int c0, const void* s1,
                 int c1, const void* pro_a, const void* pro_b, int cout, int kp,
                 int n, int h, int wd) {
  const void* ptrs[2] = {s0, s1};
  const int chans[2] = {c0, c1};
  const int ks[2] = {3, 3};
  const int ksum = fill_sources(a.src, 2, a.nsrc, ptrs, chans, ks);
  if (ksum < 0 || ksum != kp || cout < 1 || n <= 0 || h <= 0 || wd <= 0 ||
      (pro_a != nullptr && (a.nsrc != 1 || pro_b == nullptr)))
    return false;
  a.pro_a = static_cast<const float*>(pro_a);
  a.pro_b = static_cast<const float*>(pro_b);
  a.cout = cout;
  a.kp = kp;
  a.h = h;
  a.w = wd;
  a.m = (long long)n * h * wd;
  const long long tiles = (long long)((cout + WM - 1) / WM) * ((kp + WN - 1) / WN);
  const long long steps = (a.m + BK - 1) / BK;
  long long splits = (132 * 8 + tiles - 1) / tiles;
  const long long max_splits = (steps + 7) / 8;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  a.per_split = (steps + splits - 1) / splits * BK;
  splits = (a.m + a.per_split - 1) / a.per_split;
  grid = dim3((unsigned)((cout + WM - 1) / WM), (unsigned)((kp + WN - 1) / WN),
              (unsigned)splits);
  return true;
}

}  // namespace
