// Shared device code of the port's stage kernels (every csrc/*.cu includes
// it, directly or through conv_tile.cuh): the bf16 helpers, the mma.sync
// and PTX helpers (cp.async, ldmatrix), and the self-SPADE tail with its
// launcher (kernels 1, 3, 7, 8 and 9 end in it). The convs run on the cores
// of eval_conv.cuh (the eval stages, the train tail's residual) and
// bwd_core.cuh (the train kernels). Everything is in an anonymous
// namespace, so each source gets its own copy and nothing is exported.
// Numerics: sums run in f32, outputs are rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(u[j] << 16);
    f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// PTX helpers: cp.async (zero-fill), ldmatrix (the tail's and bwd_core.cuh's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// ---------------------------------------------------------------------------
// The self-SPADE tail (+ an optional folded 1x1 head, or the output as s8),
// optionally saving seg and act (the train tail), on a 16 x 16 output tile:
//   seg = conv3x3(y) + b    on the 20 x 20 window: an implicit GEMM on
//       mma.sync m16n8k16 bf16 (f32 sums), M = the window's 400 pixels (25
//       m16 tiles, none padded), N = labels padded to 8, K = 9 taps x C. y
//       arrives in 32-channel chunks (the 22 x 22 window, bf16) through
//       cp.async, double-buffered with the chunk's weights; the nine taps
//       are shifted ldmatrix rows of the window; each chunk's MMA sums are
//       added into f32 sums.
//   act = relu(conv3x3(seg) + b)    on the 18 x 18 window: 9 x labels
//       multiply-adds an output, f32 FMAs from seg in shared memory; act
//       is kept in shared memory as bf16, hidden padded to 8-channel groups.
//   g|b = conv3x3(act) + b    as an MMA GEMM: M = the tile's 256 pixels, K =
//       (tap, 8-channel group) pairs, two per k16 step, N = 2C in chunks of
//       64 columns streamed through cp.async (double-buffered), so hidden
//       widths up to TAIL_MAX_NH fit. The columns interleave g and b per
//       8-channel group, so the thread that holds g[c] of a pixel holds
//       b[c] in the paired accumulator and the modulate runs on the
//       fragments: out = y*(1+g) + b in bf16 one operation at a time, y read
//       at the fragment's (pixel, channel).
//   head    the bf16 out fragments are the A operand of a second MMA against
//       Kf (classes padded to 8), summed over C in registers.
// Warps: 8; seg m16 tiles w, w+8, w+16, w+24; g|b as 4 (64 pixels) x 2
// (16 channels of g and of b) warps per N chunk.
// ---------------------------------------------------------------------------

constexpr int TAIL_T = 16;                            // output tile side
constexpr int TAIL_SW = TAIL_T + 4;                   // seg window side
constexpr int TAIL_AW = TAIL_T + 2;                   // act window side
constexpr int TAIL_YW = TAIL_T + 6;                   // y window side
constexpr int TAIL_SEG_PIX = TAIL_SW * TAIL_SW;       // 400
constexpr int TAIL_SEG_TILES = TAIL_SEG_PIX / 16;     // 25 m16 tiles
constexpr int TAIL_ACT_PIX = TAIL_AW * TAIL_AW;       // 324
constexpr int TAIL_Y_PIX = TAIL_YW * TAIL_YW;         // 484
constexpr int TAIL_CC = 32;                           // y channels per seg K chunk
constexpr int TAIL_YS = TAIL_CC + 8;                  // y / seg-weight row (halves)
constexpr int TAIL_LABP = 8;                          // labels padded (seg's and the head's N)
constexpr int TAIL_NB = 64;                           // g|b columns per N chunk
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_MAX_LAB = 8, TAIL_MAX_NH = 64, TAIL_MAX_CLS = 8;
static_assert(TAIL_SEG_PIX % 16 == 0, "seg window rows must fill m16 tiles");

enum TailOut { TAIL_BF16 = 0, TAIL_HEAD = 1, TAIL_S8 = 2 };

struct TailArgs {
  const bf16* y;       // [n, h, w, c]
  int h, w, c;
  const bf16* k1t;     // [8][9][c]: x2map, labels padded to 8
  const float* b1s;    // [lab]
  int lab;
  const float* k2s;    // [9][lab][nh]: mlp_shared
  const float* b2s;    // [nh]
  int nh;
  const bf16* kgbt;    // [2c][16 * tail_gb_steps(nh)]: mlp_gamma | mlp_beta interleaved
  const float* bgb;    // [2c]: gamma bias, then beta bias
  const bf16* kft;     // [8][c]: folded final 1x1 conv, classes padded to 8 (TAIL_HEAD)
  const float* bf;     // [ncls]
  int ncls;
  bf16* out;           // [n, h, w, c] or [n, h, w, ncls]
  signed char* out_q;  // [n, h, w, c] s8: clip(round(out * q_inv)) (TAIL_S8)
  float q_inv;
  bf16* seg_out;       // [n, h, w, lab] or null
  bf16* act_out;       // [n, h, w, nh] or null
};

// hidden channels in 8-channel groups; k16 steps of the g|b GEMM over the
// (tap, group) pairs; act's row stride and the g|b weight stage's (halves):
// an odd count of 16-byte pieces, so eight consecutive rows of an ldmatrix
// fall on distinct pieces of a 128-byte line
__host__ __device__ inline int tail_groups(int nh) { return (nh + 7) / 8; }
__host__ __device__ inline int tail_gb_steps(int nh) { return (9 * tail_groups(nh) + 1) / 2; }
__host__ __device__ inline int tail_act_stride(int nh) { return 8 * (tail_groups(nh) | 1); }
__host__ __device__ inline int tail_w_stride(int nh) { return 16 * tail_gb_steps(nh) + 8; }

// shared memory: region A (the y chunks and seg weights, then the g|b
// weight stages, then the head's partial sums), seg (f32), act (bf16), the
// (tap, group) offsets of the g|b A operand
__host__ __device__ inline int tail_region_a(int nh) {
  const int ybytes = 2 * (TAIL_Y_PIX + 9 * TAIL_LABP) * TAIL_YS * 2;
  const int wbytes = 2 * TAIL_NB * tail_w_stride(nh) * 2;
  const int hbytes = 4 * 4 * 4 * 32 * 4;
  const int m = ybytes > wbytes ? ybytes : wbytes;
  return m > hbytes ? m : hbytes;
}

__host__ inline size_t tail_smem_bytes(int lab, int nh) {
  return (size_t)tail_region_a(nh) + (size_t)TAIL_SEG_PIX * (lab | 1) * 4 +
         (size_t)TAIL_ACT_PIX * tail_act_stride(nh) * 2 + (size_t)2 * tail_gb_steps(nh) * 4;
}

template <int OUT>
__global__ void __launch_bounds__(TAIL_THREADS, 2)
spade_tail_kernel(const TailArgs a) {
  extern __shared__ __align__(16) unsigned char tail_smem[];
  const int lab = a.lab, nh = a.nh, C = a.c, H = a.h, W = a.w;
  const int ls = lab | 1, ngrp = tail_groups(nh), steps = tail_gb_steps(nh);
  const int as = tail_act_stride(nh), ws = tail_w_stride(nh);
  bf16* ybuf = reinterpret_cast<bf16*>(tail_smem);            // [2][Y_PIX][YS]
  bf16* kbuf = ybuf + 2 * TAIL_Y_PIX * TAIL_YS;                 // [2][9 x 8][YS]
  bf16* wbuf = reinterpret_cast<bf16*>(tail_smem);            // [2][NB][ws]
  float* red = reinterpret_cast<float*>(tail_smem);           // [4][4][4][32]
  float* seg = reinterpret_cast<float*>(tail_smem + tail_region_a(nh));  // [SEG_PIX][ls]
  bf16* act = reinterpret_cast<bf16*>(seg + TAIL_SEG_PIX * ls);          // [ACT_PIX][as]
  int* goff = reinterpret_cast<int*>(act + TAIL_ACT_PIX * as);          // [2 steps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int oh0 = blockIdx.y * TAIL_T, ow0 = blockIdx.x * TAIL_T;
  const long long img = (long long)blockIdx.z * H * W;

  // act offset of each k8 group of the g|b GEMM: (tap, group); the pad
  // group past the last reads the centre tap's first group (finite values,
  // zero weights)
  for (int q = tid; q < 2 * steps; q += TAIL_THREADS) {
    int tap = 4, gi = 0;
    if (q < 9 * ngrp) {
      tap = q / ngrp;
      gi = q - tap * ngrp;
    }
    goff[q] = ((tap / 3) * TAIL_AW + tap % 3) * as + gi * 8;
  }

  // ---- seg: the 22 x 22 y window and the chunk's weights per 32 channels
  auto load_chunk = [&](int c0, int buf) {
    bf16* yd = ybuf + buf * TAIL_Y_PIX * TAIL_YS;
    for (int i = tid; i < TAIL_Y_PIX * 4; i += TAIL_THREADS) {
      const int p = i >> 2, piece = i & 3;
      const int gh = oh0 - 3 + p / TAIL_YW, gw = ow0 - 3 + p % TAIL_YW;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const bf16* src = in ? a.y + (img + (long long)gh * W + gw) * C + c0 + piece * 8 : a.y;
      cp16(yd + p * TAIL_YS + piece * 8, src, in);
    }
    bf16* kd = kbuf + buf * 9 * TAIL_LABP * TAIL_YS;
    for (int i = tid; i < 9 * TAIL_LABP * 4; i += TAIL_THREADS) {
      const int row = i >> 2, piece = i & 3;  // row = tap * 8 + label
      cp16(kd + row * TAIL_YS + piece * 8,
           a.k1t + ((long long)(row & 7) * 9 + (row >> 3)) * C + c0 + piece * 8, true);
    }
    cp_commit();
  };

  // this lane's ldmatrix row of each of its seg m16 tiles: a window pixel
  int abase[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int p = (warp + 8 * i) * 16 + (lane & 15);
    p = p < TAIL_SEG_PIX ? p : 0;
    abase[i] = ((p / TAIL_SW) * TAIL_YW + p % TAIL_SW) * TAIL_YS + (lane >> 4) * 8;
  }
  float sacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[i][e] = 0.f;

  const int nch = C / TAIL_CC;
  load_chunk(0, 0);
  for (int ci = 0; ci < nch; ++ci) {
    if (ci + 1 < nch) {
      load_chunk((ci + 1) * TAIL_CC, (ci + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* yd = ybuf + (ci & 1) * TAIL_Y_PIX * TAIL_YS;
    const bf16* kd = kbuf + (ci & 1) * 9 * TAIL_LABP * TAIL_YS;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * TAIL_YW + tap % 3) * TAIL_YS;
#pragma unroll
      for (int kk = 0; kk < TAIL_CC; kk += 16) {
        const bf16* kr = kd + (tap * TAIL_LABP + g) * TAIL_YS + kk + 2 * t;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                               *reinterpret_cast<const uint32_t*>(kr + 8)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (warp + 8 * i >= TAIL_SEG_TILES) continue;  // warp-uniform
          uint32_t af[4];
          ldsm_x4<false>(af, yd + abase[i] + toff + kk);
          mma_bf16_16816(acc[i], af, b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] += acc[i][e];
    __syncthreads();
  }

  // seg + b, rounded; 0 outside the image (the next conv's zero padding)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (warp + 8 * i >= TAIL_SEG_TILES) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (warp + 8 * i) * 16 + g + 8 * h;
      const int sr = p / TAIL_SW, sc = p % TAIL_SW;
      const int gh = oh0 - 2 + sr, gw = ow0 - 2 + sc;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const bool centre = a.seg_out != nullptr && in && sr >= 2 && sr < TAIL_SW - 2 &&
                          sc >= 2 && sc < TAIL_SW - 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = 2 * t + e;
        if (l >= lab) continue;
        const float v = in ? bf16r(sacc[i][2 * h + e] + a.b1s[l]) : 0.f;
        seg[p * ls + l] = v;
        if (centre)
          a.seg_out[(img + (long long)gh * W + gw) * lab + l] = __float2bfloat16_rn(v);
      }
    }
  }
  __syncthreads();

  // g|b weights: 64 columns x K per stage, the first stage in flight
  // during act
  const int kp = 16 * steps;
  auto load_w = [&](int nc, int buf) {
    bf16* wd = wbuf + buf * TAIL_NB * ws;
    const int pieces = kp / 8;
    for (int i = tid; i < TAIL_NB * pieces; i += TAIL_THREADS) {
      const int row = i / pieces, piece = i - row * pieces;
      cp16(wd + row * ws + piece * 8, a.kgbt + (long long)(nc * TAIL_NB + row) * kp + piece * 8,
           true);
    }
    cp_commit();
  };
  load_w(0, 0);

  // ---- act = relu(conv3x3(seg) + b) on the 18 x 18 window, bf16; the
  // groups' pad channels 0
  const int nhp = 8 * ngrp;
  for (int i = tid; i < TAIL_ACT_PIX * nhp; i += TAIL_THREADS) {
    const int ap = i / nhp, j = i - ap * nhp;
    const int ar = ap / TAIL_AW, ac = ap - ar * TAIL_AW;
    const int gh = oh0 - 1 + ar, gw = ow0 - 1 + ac;
    const bool in = j < nh && gh >= 0 && gh < H && gw >= 0 && gw < W;
    float v = 0.f;
    if (in) {
      float s = a.b2s[j];
      for (int tap = 0; tap < 9; ++tap) {
        const float* sr = seg + ((ar + tap / 3) * TAIL_SW + ac + tap % 3) * ls;
        const float* kr = a.k2s + tap * lab * nh + j;
        for (int l = 0; l < lab; ++l) s += sr[l] * __ldg(kr + l * nh);
      }
      v = bf16r(fmaxf(s, 0.f));
      if (a.act_out != nullptr && ar >= 1 && ar < TAIL_AW - 1 && ac >= 1 && ac < TAIL_AW - 1)
        a.act_out[(img + (long long)gh * W + gw) * nh + j] = __float2bfloat16_rn(v);
    }
    act[ap * as + j] = __float2bfloat16_rn(v);
  }

  // ---- g|b = conv3x3(act) + b, out = y*(1+g) + b [, logits]
  const int wm = warp >> 1, wn = warp & 1;
  // this lane's A row (output pixel) of m16 tile i: arow + i * TAIL_AW * as
  const bf16* arow = act + (wm * 4 * TAIL_AW + (lane & 15)) * as;
  const int khalf = lane >> 4;
  const int brow = (wn * 32 + (lane >> 4) * 8 + (lane & 7)) * ws + ((lane >> 3) & 1) * 8;
  float hacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[i][e] = 0.f;

  const int nchunks = 2 * C / TAIL_NB;
  for (int nc = 0; nc < nchunks; ++nc) {
    if (nc + 1 < nchunks) {
      load_w(nc + 1, (nc + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* wd = wbuf + (nc & 1) * TAIL_NB * ws;
    // this warp's 16 channels: groups q = 0, 1 at cq + 8q
    const int cq = nc * (TAIL_NB / 2) + wn * 16;
    float bgv[2][2], bbv[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bgv[q][e] = a.bgb[cq + 8 * q + 2 * t + e];
        bbv[q][e] = a.bgb[C + cq + 8 * q + 2 * t + e];
      }
    // the warp's 4 m16 tiles in passes of MH (the head's registers hold
    // its logit sums besides, so it takes two passes of 2)
    constexpr int MH = OUT == TAIL_HEAD ? 2 : 4;
#pragma unroll
    for (int m0 = 0; m0 < 4; m0 += MH) {
      float acc[MH][4][4];
#pragma unroll
      for (int i = 0; i < MH; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int s = 0; s < steps; ++s) {
        uint32_t bfr[2][4];
        ldsm_x4<false>(bfr[0], wd + brow + s * 16);
        ldsm_x4<false>(bfr[1], wd + brow + 16 * ws + s * 16);
        const int off = goff[2 * s + khalf];
#pragma unroll
        for (int i = 0; i < MH; ++i) {
          uint32_t af[4];
          ldsm_x4<false>(af, arow + (m0 + i) * TAIL_AW * as + off);
          mma_bf16_16816(acc[i][0], af, &bfr[0][0]);
          mma_bf16_16816(acc[i][1], af, &bfr[0][2]);
          mma_bf16_16816(acc[i][2], af, &bfr[1][0]);
          mma_bf16_16816(acc[i][3], af, &bfr[1][2]);
        }
      }

      // acc[i][2q] is g, acc[i][2q + 1] b, of group q at pixel rows g and
      // g + 8, channels 2t, 2t + 1
#pragma unroll
      for (int i = 0; i < MH; ++i) {
        const int oh = oh0 + wm * 4 + m0 + i;
        float o[2][2][2];  // [group][row half][channel]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ow = ow0 + g + 8 * h;
          const bool valid = oh < H && ow < W;
          const long long pix = img + (long long)oh * W + ow;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c = cq + 8 * q + 2 * t;
            float2 yv = make_float2(0.f, 0.f);
            if (valid) yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                a.y + pix * C + c));
            const float yy[2] = {yv.x, yv.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // modulate in bf16, one rounding per operation
              const float one_g = bf16r(1.f + bf16r(acc[i][2 * q][2 * h + e] + bgv[q][e]));
              const float b = bf16r(acc[i][2 * q + 1][2 * h + e] + bbv[q][e]);
              o[q][h][e] = valid ? bf16r(bf16r(yy[e] * one_g) + b) : 0.f;
            }
            if (!valid) continue;
            if (OUT == TAIL_BF16) {
              *reinterpret_cast<__nv_bfloat162*>(a.out + pix * C + c) =
                  __floats2bfloat162_rn(o[q][h][0], o[q][h][1]);
            } else if (OUT == TAIL_S8) {
              // the stage output as s8 at the calibrated output scale
              // (round half to even of the bf16 value times the inverse scale)
              uint32_t v = 0;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float r =
                    fminf(fmaxf(rintf(__fmul_rn(o[q][h][e], a.q_inv)), -127.f), 127.f);
                v |= ((uint32_t)(uint8_t)(signed char)(int)r) << (8 * e);
              }
              *reinterpret_cast<uint16_t*>(a.out_q + pix * C + c) = (uint16_t)v;
            }
          }
        }
        if (OUT == TAIL_HEAD) {
          // the out fragments of 16 channels are one k16 A fragment
          const uint32_t af[4] = {pack2(o[0][0][0], o[0][0][1]), pack2(o[0][1][0], o[0][1][1]),
                                  pack2(o[1][0][0], o[1][0][1]), pack2(o[1][1][0], o[1][1][1])};
          const bf16* kr = a.kft + g * C + cq + 2 * t;
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                 *reinterpret_cast<const uint32_t*>(kr + 8)};
          mma_bf16_16816(hacc[m0 + i], af, b);
        }
      }
    }
    __syncthreads();  // this stage is refilled two chunks on
  }

  if (OUT == TAIL_HEAD) {
    // logits = the two channel halves' sums + bf
    if (wn == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((wm * 4 + i) * 4 + e) * 32 + lane] = hacc[i][e];
    }
    __syncthreads();
    if (wn == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int oh = oh0 + wm * 4 + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ow = ow0 + g + 8 * h;
          if (oh >= H || ow >= W) continue;
          const long long pix = img + (long long)oh * W + ow;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * t + e;
            if (k < a.ncls)
              a.out[pix * a.ncls + k] = __float2bfloat16_rn(
                  hacc[i][2 * h + e] + red[((wm * 4 + i) * 4 + 2 * h + e) * 32 + lane] + a.bf[k]);
          }
        }
      }
    }
  }
}

template <int OUT>
cudaError_t launch_tail(const TailArgs& a, int n, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(spade_tail_kernel<OUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.w + TAIL_T - 1) / TAIL_T), (unsigned)((a.h + TAIL_T - 1) / TAIL_T),
                  (unsigned)n);
  spade_tail_kernel<OUT><<<grid, TAIL_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Validate and launch the tail; seg and act may be null (no saves). With
// kft the output is the folded head's logits; with out_q the stage output
// leaves as s8 (out is then unused and may be null; no head).
int launch_spade_tail_q(const void* y, int n, int h, int wd, int c, const void* k1t,
                        const void* b1s, int lab, const void* k2s, const void* b2s,
                        int nh, const void* kgbt, const void* bgb, const void* kft,
                        const void* bf, int ncls, void* out, void* out_q, float q_inv,
                        void* seg, void* act, void* stream) {
  if (c % TAIL_CC != 0 || c <= 0 || lab < 1 || lab > TAIL_MAX_LAB || nh < 1 ||
      nh > TAIL_MAX_NH || (kft != nullptr && (ncls < 1 || ncls > TAIL_MAX_CLS)) || n <= 0 ||
      h <= 0 || wd <= 0 || (uintptr_t)y % 16 != 0 || (uintptr_t)k1t % 16 != 0 ||
      (uintptr_t)kgbt % 16 != 0 || (uintptr_t)kft % 4 != 0 ||
      (out_q != nullptr ? (kft != nullptr || (uintptr_t)out_q % 2 != 0)
                        : (out == nullptr || (uintptr_t)out % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.y = static_cast<const bf16*>(y);
  a.h = h;
  a.w = wd;
  a.c = c;
  a.k1t = static_cast<const bf16*>(k1t);
  a.b1s = static_cast<const float*>(b1s);
  a.lab = lab;
  a.k2s = static_cast<const float*>(k2s);
  a.b2s = static_cast<const float*>(b2s);
  a.nh = nh;
  a.kgbt = static_cast<const bf16*>(kgbt);
  a.bgb = static_cast<const float*>(bgb);
  a.kft = static_cast<const bf16*>(kft);
  a.bf = static_cast<const float*>(bf);
  a.ncls = kft != nullptr ? ncls : 0;
  a.out = static_cast<bf16*>(out);
  a.out_q = static_cast<signed char*>(out_q);
  a.q_inv = q_inv;
  a.seg_out = static_cast<bf16*>(seg);
  a.act_out = static_cast<bf16*>(act);
  const size_t smem = tail_smem_bytes(lab, nh);
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = kft != nullptr   ? launch_tail<TAIL_HEAD>(a, n, smem, st)
                        : out_q != nullptr ? launch_tail<TAIL_S8>(a, n, smem, st)
                                           : launch_tail<TAIL_BF16>(a, n, smem, st);
  return (int)e;
}

int launch_spade_tail(const void* y, int n, int h, int wd, int c, const void* k1t,
                      const void* b1s, int lab, const void* k2s, const void* b2s,
                      int nh, const void* kgbt, const void* bgb, const void* kft,
                      const void* bf, int ncls, void* out, void* seg, void* act,
                      void* stream) {
  return launch_spade_tail_q(y, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb, kft, bf,
                             ncls, out, nullptr, 0.f, seg, act, stream);
}

}  // namespace
