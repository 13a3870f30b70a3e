// int8 fused eval stage of the ss-UNet family on Hopper (sm_90a): the port
// of the TPU kernel ssunet_gan_tpu/ops/stage_kernel_int8.py
// fused_eval_stage_int8 (_stage_call_int8 -> pl.pallas_call, body
// _make_kernel_int8 with the SPADE tail of ops/spade_kernel.py _spade_tail).
//
// One stage (BasicBlock + self-SPADE, BatchNorm and the input scales folded
// into per-output-channel s8 weights) runs as four launches:
//   A. q_conv_kernel<H1>:  h1 = relu(f32(conv3x3_s8(qx; Wq1)) * d1 + t1), bf16,
//                          and the maximum of each image row of h1 (rowmax)
//   Q. q_band_kernel:      per image and band of th rows, the scale
//                          s = max(max(h1 rows i*th-4 .. i*th+th+3) / 127, 1e-12)
//                          and q(h1) = clip(round(h1 / s)) for rows i*th-1 ..
//                          i*th+th of the band, into a band-local s8 buffer
//   B. q_conv_kernel<Y>:   y = relu(f32(conv3x3_s8(q(h1); Wq2)) * (d2 * s)
//                                   + f32(conv1x1_s8(qx; Wqs)) * ds + t2), bf16
//   C. spade_tail_kernel:  the bf16 self-SPADE tail of stage_common.cuh, with
//                          the folded head or the output emitted as s8.
// A band's halo rows of h1 are quantized once for each of the two bands that
// read them, with each band's own scale, which is why q(h1) lives in a
// band-local buffer (th + 2 rows per band) and not in one s8 image. A row of
// y is computed once, with the scale of the band that owns it.
//
// What bounds it on the H100: conv1 and conv2 + shortcut carry ~95% of the
// stage's multiply-adds at an intensity far above the s8 ridge point, so the
// stage is bound by tensor-core operations. Launches A and B are an
// implicit GEMM on mma.sync m16n8k32 s8 tensor cores with exact s32 sums
// (M = 128 pixels, N = 64 output channels per block, K = sources x taps x
// channels in 16-byte groups, 64 bytes of K per pipeline step, a register
// double buffer feeding two shared-memory stages). The split-concat parts
// are K segments read through their own pointers. The 3x3 sum over q(h1) and
// the 1x1 shortcut over the s8 inputs have different dequantization vectors,
// so launch B keeps two s32 accumulators; eight warps of 32 x 32 keep that
// within the register file. Zero-points are zero, so the zero padding of the
// convs and of K stays exact. wgmma/TMA pipelines, quantizing the inputs in
// launch A's loader and the on-read seams are later work (see ROADMAP.md).
//
// Numerics: s32 sums are exact; every f32 dequantization step is a separate
// rounding (no fused multiply-add), in the TPU kernel's order; h1 and y are
// rounded to bf16; h1 is quantized by an IEEE division and round half to
// even. The plain PyTorch version (ops/stage_kernel_int8.py) repeats these
// steps, so h1 and y agree with it bit for bit.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include "stage_common.cuh"

namespace {

constexpr int QBM = 128;        // pixels per block
constexpr int QBN = 64;         // output channels per block
constexpr int QBK = 64;         // bytes (s8 values) of K per pipeline step
constexpr int QLD = QBK + 16;   // padded shared row (bytes): conflict-free 4-byte fragment reads
constexpr int QG = 16;          // channels per 16-byte group
constexpr int Q_THREADS = 256;  // 8 warps, 4 x 2, 32 x 32 each
constexpr int Q_MAX_SRC = 3;

enum QMode { Q_H1 = 0, Q_Y = 1 };

struct QSrc {
  const signed char* ptr;
  int c;     // channels
  int cg;    // 16-channel groups per tap
  int taps;  // 9 (3x3, pad 1) or 1
  int g0;    // first group of this source in K
  int vec;   // 16-byte loads allowed
  int band;  // ptr is the band-local q(h1) buffer [n][nb][th + 2][w][c]
};

struct QConvArgs {
  QSrc src[Q_MAX_SRC];
  int nsrc;
  const signed char* wt;   // [cout][kp]
  int kp;                  // a multiple of QBK
  int ksplit;              // Q_Y: K steps of the 3x3 sum; the rest are the shortcut's
  const float* v0;         // Q_H1: d1      Q_Y: d2
  const float* v1;         // Q_H1: t1      Q_Y: ds
  const float* v2;         //               Q_Y: t2
  const float* bandscale;  // Q_Y: [n][nb]
  int* rowmax;             // Q_H1: [n][h], the bits of non-negative floats, zeroed by the caller
  bf16* out;               // [m][cout]
  int h, w, cout, th, nb;
  long long m;             // n * h * w
};

__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Sixteen channels c0..c0+15 of one pixel (zeros past c).
__device__ __forceinline__ uint4 q_load16(const QSrc& S, long long pix, int c0) {
  const signed char* p = S.ptr + (pix * S.c + c0);
  if (S.vec && c0 + QG <= S.c) return *reinterpret_cast<const uint4*>(p);
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < QG; ++j)
    if (c0 + j < S.c) u[j >> 2] |= ((uint32_t)(uint8_t)p[j]) << (8 * (j & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void q_mma_step(int (&acc)[2][4][4], const uint32_t (&af)[2][4],
                                           const uint32_t (&bfr)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8_16832(acc[mi][ni], af[mi], bfr[ni]);
}

template <int MODE>
__global__ void __launch_bounds__(Q_THREADS) q_conv_kernel(const QConvArgs args) {
  __shared__ __align__(16) signed char As[2][QBM][QLD];
  __shared__ __align__(16) signed char Bs[2][QBN][QLD];
  __shared__ int pmax[QBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.x * QBM;
  const int n0 = blockIdx.y * QBN;
  const int H = args.h, W = args.w;
  const long long hw = (long long)H * W;

  if (MODE == Q_H1 && tid < QBM) pmax[tid] = 0;  // read after the K loop's barriers

  // This thread loads one 16-byte group (kg) of two A rows and one B row
  // per step; the rows stay fixed across K.
  const int kg = tid & 3;
  long long a_img[2];
  int a_oh[2], a_ow[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    a_ok[i] = m < args.m;
    const long long img = a_ok[i] ? m / hw : 0;
    const long long rem = a_ok[i] ? m - img * hw : 0;
    a_img[i] = img;
    a_oh[i] = (int)(rem / W);
    a_ow[i] = (int)(rem - (long long)a_oh[i] * W);
  }

  const int ktiles = args.kp / QBK;
  uint4 ra[2], rb;

  auto load_tile = [&](int kt) {
    const int gi = kt * (QBK / QG) + kg;
    int s = -1;
#pragma unroll
    for (int i = 0; i < Q_MAX_SRC; ++i)
      if (i < args.nsrc && gi >= args.src[i].g0 &&
          gi < args.src[i].g0 + args.src[i].taps * args.src[i].cg)
        s = i;
    ra[0] = ra[1] = make_uint4(0u, 0u, 0u, 0u);
    if (s >= 0) {
      const QSrc S = args.src[s];
      const int r = gi - S.g0;
      const int tap = r / S.cg;
      const int c0 = (r - tap * S.cg) * QG;
      const int pad = S.taps == 9 ? 1 : 0;
      const int dy = S.taps == 9 ? tap / 3 : 0;
      const int dx = S.taps == 9 ? tap % 3 : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ih = a_oh[i] + dy - pad, iw = a_ow[i] + dx - pad;
        if (a_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
          long long pix;
          if (S.band) {
            const int b = a_oh[i] / args.th;
            pix = ((a_img[i] * args.nb + b) * (args.th + 2) + (ih - b * args.th + 1)) * W + iw;
          } else {
            pix = a_img[i] * hw + (long long)ih * W + iw;
          }
          ra[i] = q_load16(S, pix, c0);
        }
      }
    }
    const int n = n0 + (tid >> 2);
    rb = n < args.cout ? *reinterpret_cast<const uint4*>(args.wt + (long long)n * args.kp +
                                                         kt * QBK + kg * QG)
                       : make_uint4(0u, 0u, 0u, 0u);
  };

  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 2) + 64 * i][kg * QG]) = ra[i];
    *reinterpret_cast<uint4*>(&Bs[buf][tid >> 2][kg * QG]) = rb;
  };

  int acc0[2][4][4], acc1[MODE == Q_Y ? 2 : 1][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[mi][ni][e] = 0;
        if constexpr (MODE == Q_Y) acc1[mi][ni][e] = 0;
      }

  load_tile(0);
  store_tile(0);
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load_tile(kt + 1);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + 4 * t]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + 4 * t]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + 16 + 4 * t]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cur][nn][kk + 4 * t]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cur][nn][kk + 16 + 4 * t]);
      }
      if constexpr (MODE == Q_Y) {
        if (kt < args.ksplit) {
          q_mma_step(acc0, af, bfr);
        } else {
          q_mma_step(acc1, af, bfr);
        }
      } else {
        q_mma_step(acc0, af, bfr);
      }
    }
    if (kt + 1 < ktiles) store_tile(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: per-channel dequantization, bias, ReLU, round to bf16.
  float mx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // Q_H1: the largest h1 of this thread's pixels
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int ch0 = n0 + wn * 32 + ni * 8 + 2 * t;
    float k0[2] = {0.f, 0.f}, k1[2] = {0.f, 0.f}, k2[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (ch0 + e >= args.cout) continue;
      k0[e] = args.v0[ch0 + e];
      k1[e] = args.v1[ch0 + e];
      if constexpr (MODE == Q_Y) k2[e] = args.v2[ch0 + e];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 32 + mi * 16 + g + 8 * half;
        if (m >= args.m || ch0 >= args.cout) continue;
        float sc = 0.f;
        if constexpr (MODE == Q_Y) {
          const long long img = m / hw;
          const int oh = (int)((m - img * hw) / W);
          sc = args.bandscale[img * args.nb + oh / args.th];
        }
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v;
          if constexpr (MODE == Q_Y) {
            const float a2 = __fmul_rn(__int2float_rn(acc0[mi][ni][2 * half + e]),
                                       __fmul_rn(k0[e], sc));
            const float as = __fmul_rn(__int2float_rn(acc1[mi][ni][2 * half + e]), k1[e]);
            v = __fadd_rn(__fadd_rn(a2, as), k2[e]);
          } else {
            v = __fadd_rn(__fmul_rn(__int2float_rn(acc0[mi][ni][2 * half + e]), k0[e]), k1[e]);
          }
          o[e] = ch0 + e < args.cout ? bf16r(fmaxf(v, 0.f)) : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(args.out + m * args.cout + ch0) =
            __floats2bfloat162_rn(o[0], o[1]);
        if constexpr (MODE == Q_H1) mx[mi][half] = fmaxf(mx[mi][half], fmaxf(o[0], o[1]));
      }
    }
  }

  if constexpr (MODE == Q_H1) {
    // rowmax[image row] = max(h1): h1 >= 0, so its float bits order as ints.
    // First per pixel of the block (the four lanes and two warps that share
    // a pixel), then one atomic per warp where its 32 pixels share a row.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = mx[mi][half];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t == 0) atomicMax(&pmax[wm * 32 + mi * 16 + g + 8 * half], __float_as_int(v));
      }
    __syncthreads();
    if (tid < QBM) {
      const long long m = m0 + tid;
      const long long row = m < args.m ? m / W : -1;
      int v = m < args.m ? pmax[tid] : 0;
      const long long row0 = __shfl_sync(0xffffffffu, row, 0);
      if (__all_sync(0xffffffffu, row == row0)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == 0 && row >= 0 && v > 0) atomicMax(args.rowmax + row, v);
      } else if (row >= 0 && v > 0) {
        atomicMax(args.rowmax + row, v);
      }
    }
  }
}

// Per (image, band): the band's scale from rowmax, and q(h1) for the rows
// i*th-1 .. i*th+th (zeros outside the image) into the band-local buffer.
constexpr int BAND_THREADS = 256;

__global__ void __launch_bounds__(BAND_THREADS)
q_band_kernel(const bf16* h1, const float* rowmax, signed char* qh1, float* bandscale, int h,
              int w, int c, int th, int nb) {
  __shared__ float red[BAND_THREADS / 32];
  __shared__ float s_sh;
  const int tid = threadIdx.x;
  const int b = blockIdx.y % nb;
  const long long img = blockIdx.y / nb;
  const int r0 = max(b * th - 4, 0), r1 = min(b * th + th + 4, h);
  float mval = 0.f;
  for (int r = r0 + tid; r < r1; r += BAND_THREADS) mval = fmaxf(mval, rowmax[img * h + r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mval = fmaxf(mval, __shfl_xor_sync(0xffffffffu, mval, off));
  if ((tid & 31) == 0) red[tid >> 5] = mval;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
#pragma unroll
    for (int i = 1; i < BAND_THREADS / 32; ++i) v = fmaxf(v, red[i]);
    const float s = fmaxf(__fdiv_rn(v, 127.f), 1e-12f);
    s_sh = s;
    if (blockIdx.x == 0) bandscale[img * nb + b] = s;
  }
  __syncthreads();
  const float s = s_sh;

  const long long rowlen = (long long)w * c;          // elements per image row
  const long long groups = (long long)(th + 2) * rowlen / 8;
  signed char* qb = qh1 + (img * nb + b) * (long long)(th + 2) * rowlen;
  for (long long i = (long long)blockIdx.x * BAND_THREADS + tid; i < groups;
       i += (long long)gridDim.x * BAND_THREADS) {
    const long long e = i * 8;
    const int row = (int)(e / rowlen);
    const long long rem = e - (long long)row * rowlen;
    const int ih = b * th - 1 + row;
    uint2 o = make_uint2(0u, 0u);
    if (ih >= 0 && ih < h) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(h1 + (img * h + ih) * rowlen + rem), f);
      uint32_t u[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(f[j], s)), -127.f), 127.f);
        u[j >> 2] |= ((uint32_t)(uint8_t)(signed char)(int)q) << (8 * (j & 3));
      }
      o = make_uint2(u[0], u[1]);
    }
    *reinterpret_cast<uint2*>(qb + e) = o;
  }
}

// Lay the sources out in K (16-byte groups, source-major, tap-major); the
// sources from `align_from` on start at a pipeline-step boundary. Returns
// the K they span rounded up to QBK, or -1.
int q_fill_sources(QSrc* src, int& nsrc, const void* const* ptrs, const int* chans,
                   const int* taps, const int* band, int align_from) {
  nsrc = 0;
  int g = 0;
  const int per_step = QBK / QG;
  for (int i = 0; i < Q_MAX_SRC; ++i) {
    if (chans[i] <= 0) continue;
    if (taps[i] != 1 && taps[i] != 9) return -1;
    if (i == align_from) g = (g + per_step - 1) / per_step * per_step;
    QSrc& s = src[nsrc++];
    s.ptr = static_cast<const signed char*>(ptrs[i]);
    s.c = chans[i];
    s.cg = (chans[i] + QG - 1) / QG;
    s.taps = taps[i];
    s.g0 = g;
    s.vec = (chans[i] % QG == 0) && ((uintptr_t)ptrs[i] % 16 == 0);
    s.band = band[i];
    g += s.taps * s.cg;
  }
  if (nsrc == 0) return -1;
  return (g + per_step - 1) / per_step * per_step * QG;
}

}  // namespace

extern "C" {

// Launch A: conv3x3 over up to two s8 parts -> h1 (bf16) and rowmax. A part
// with c == 0 is absent. rowmax ([n][h] f32) must be zero on entry.
int ssu_q_conv1(const void* s0, int c0, const void* s1, int c1, const void* wq, int kp,
                const void* d1, const void* t1, void* h1, void* rowmax, int n, int h, int wd,
                int cout, void* stream) {
  QConvArgs a = {};
  const void* ptrs[Q_MAX_SRC] = {s0, s1, nullptr};
  const int chans[Q_MAX_SRC] = {c0, c1, 0};
  const int taps[Q_MAX_SRC] = {9, 9, 9};
  const int band[Q_MAX_SRC] = {0, 0, 0};
  const int ksum = q_fill_sources(a.src, a.nsrc, ptrs, chans, taps, band, -1);
  if (ksum < 0 || ksum != kp || cout % 2 != 0 || (uintptr_t)wq % 16 != 0 ||
      (uintptr_t)h1 % 4 != 0 || n <= 0 || h <= 0 || wd <= 0)
    return (int)cudaErrorInvalidValue;
  a.wt = static_cast<const signed char*>(wq);
  a.kp = kp;
  a.v0 = static_cast<const float*>(d1);
  a.v1 = static_cast<const float*>(t1);
  a.rowmax = static_cast<int*>(rowmax);
  a.out = static_cast<bf16*>(h1);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.th = h;
  a.nb = 1;
  a.m = (long long)n * h * wd;
  const dim3 grid((unsigned)((a.m + QBM - 1) / QBM), (unsigned)((cout + QBN - 1) / QBN));
  q_conv_kernel<Q_H1><<<grid, Q_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch Q: band scales ([n][nb] f32) and the band-local q(h1)
// ([n][nb][th + 2][w][c] s8) from h1 and rowmax.
int ssu_q_band(const void* h1, const void* rowmax, void* qh1, void* bandscale, int n, int h,
               int wd, int c, int th, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c % 8 != 0 || th <= 0 || h % th != 0 ||
      (uintptr_t)h1 % 16 != 0 || (uintptr_t)qh1 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int nb = h / th;
  const long long groups = (long long)(th + 2) * wd * c / 8;
  long long chunks = (groups + BAND_THREADS * 4 - 1) / (BAND_THREADS * 4);
  if (chunks > 2048) chunks = 2048;
  if (chunks < 1) chunks = 1;
  const dim3 grid((unsigned)chunks, (unsigned)(n * nb));
  q_band_kernel<<<grid, BAND_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h1), static_cast<const float*>(rowmax),
      static_cast<signed char*>(qh1), static_cast<float*>(bandscale), h, wd, c, th, nb);
  return (int)cudaGetLastError();
}

// Launch B: conv3x3 over the band-local q(h1) and the 1x1 shortcut over up
// to two s8 parts, two s32 sums -> y (bf16).
int ssu_q_conv2(const void* qh1, int c, int th, const void* s0, int c0, const void* s1, int c1,
                const void* wq, int kp, const void* d2, const void* ds, const void* t2,
                const void* bandscale, void* y, int n, int h, int wd, int cout, void* stream) {
  QConvArgs a = {};
  const void* ptrs[Q_MAX_SRC] = {qh1, s0, s1};
  const int chans[Q_MAX_SRC] = {c, c0, c1};
  const int taps[Q_MAX_SRC] = {9, 1, 1};
  const int band[Q_MAX_SRC] = {1, 0, 0};
  const int ksum = q_fill_sources(a.src, a.nsrc, ptrs, chans, taps, band, 1);
  if (ksum < 0 || ksum != kp || c % QG != 0 || c0 <= 0 || cout % 2 != 0 ||
      (uintptr_t)wq % 16 != 0 || (uintptr_t)qh1 % 16 != 0 || (uintptr_t)y % 4 != 0 ||
      n <= 0 || h <= 0 || wd <= 0 || th <= 0 || h % th != 0)
    return (int)cudaErrorInvalidValue;
  a.wt = static_cast<const signed char*>(wq);
  a.kp = kp;
  a.ksplit = a.src[1].g0 / (QBK / QG);
  a.v0 = static_cast<const float*>(d2);
  a.v1 = static_cast<const float*>(ds);
  a.v2 = static_cast<const float*>(t2);
  a.bandscale = static_cast<const float*>(bandscale);
  a.out = static_cast<bf16*>(y);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.th = th;
  a.nb = h / th;
  a.m = (long long)n * h * wd;
  const dim3 grid((unsigned)((a.m + QBM - 1) / QBM), (unsigned)((cout + QBN - 1) / QBN));
  q_conv_kernel<Q_Y><<<grid, Q_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch C: the self-SPADE tail on y: the stage output in bf16 (out), the
// folded head's logits (out, kft != null), or the output as s8 (out_q,
// clip(round(out * q_inv))).
int ssu_q_spade_tail(const void* y, int n, int h, int wd, int c, const void* k1t,
                     const void* b1s, int lab, const void* k2s, const void* b2s, int nh,
                     const void* kgbt, const void* bgb, const void* kft, const void* bf,
                     int ncls, void* out, void* out_q, float q_inv, void* stream) {
  return launch_spade_tail_q(y, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb, kft, bf,
                             ncls, out, out_q, q_inv, nullptr, nullptr, stream);
}

}  // extern "C"
