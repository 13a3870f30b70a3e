// The f32 conv core on Hopper (sm_90a): 3xTF32 on mma.sync, shared by the
// f32 route of the eval stage (fused_stage_f32.cu, whose header gives the
// design: the products, the tiles, the windows, non-finite inputs) and the
// f32 train kernels (train_f32.cu; their wide modes run on
// f32_wgmma_conv.cuh's wgmma kernel, which takes this mode table, the
// arguments and the helpers below). One kernel template, f32_conv_kernel<WMW,
// WN, MODE>: the main loop is the same for every mode; MODE picks a
// prologue, applied once per window value of segment 0 as its window is
// split (before the split: the split is taken of the chain's f32 result),
// and an epilogue on the accumulators, with stat rows summed per block:
//
//   FM_EVAL     acc [+ bias] [, ReLU]            the eval route's convs
//   FM_MOD      y * (1 + g) + b                  the gamma|beta conv (interleaved)
//   FM_STD      acc [+ bias]; (sum, sum of squares)
//   FM_AFF      prologue relu(x*a + b), then as FM_STD
//   FM_MODGRAD  prologue x*f; where(band0 > 0, acc, 0); sum
//   FM_PRE      gp = where(y > 0, g*(1 + gamma) + acc, 0); sums of gp,
//               gp*(f2*r - m), g*y, g over the bands (g, gamma, y, f2)
//   FM_BN2      prologue p*(x - q - (f*r' - m')); where(f1*a + b > 0, acc, 0);
//               sums of the output and of it times f1*r - m
//   FM_BN1      the same prologue on segment 0; acc (the 3x3 segment and the
//               1x1 shortcut segment in one sum), written in two parts
//   FM_RES      relu(band0*a + b + acc): the train tail's y (1x1 segments)
//   FM_SEG      as FM_EVAL, FM_GB as FM_MOD, in the train tail (the flush below)
//
// Each operation of the chains is rounded in f32 (no fused multiply-add), as
// the plain versions (ops/train_bwd.py, ops/stage_kernel_train.py) compute
// them; outside the image a window keeps its zero padding (the prologue runs
// on in-image values only).
//
// The train modes also move the tensor cores' f32 sums into round-to-nearest
// f32 sums after every k8 step (fm_flush): the tensor cores add each step's
// products to the accumulator without rounding to nearest, an error that
// grows with K and leans one way, and a batch statistic or a bias gradient
// sums it over every pixel (without the flush the flagship's f32 step-1
// gradients sat further from an f64 step than the plain f32 path's; with
// it each call sits closer to an f64 sum than cuDNN's f32 call, chip_smoke.py
// phase 21's "from an f64 sum" lines). It costs a register set (one
// resident block per SM). Everything is in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int F_THREADS = 256;  // eight warps
constexpr int F_MAX_SEG = 3;
constexpr int F_TW = 16;        // tile columns: one m16 tile is one tile row
constexpr int F_WW = F_TW + 2;  // window columns
constexpr int F_QMAX = 2;       // 4-channel quads per chunk
constexpr int F_PMAX = 18;      // (tap, quad) pairs per chunk: 9 taps x 2 quads
constexpr int F_MT = 4;         // m16 tiles (tile rows) per warp

enum F32Mode {
  FM_EVAL = 0,
  FM_MOD = 1,
  FM_STD = 2,
  FM_AFF = 3,
  FM_MODGRAD = 4,
  FM_PRE = 5,
  FM_BN2 = 6,
  FM_BN1 = 7,
  FM_RES = 8,
  FM_SEG = 9,
  FM_GB = 10,
};

// segment 0's prologue: 0 none, 1 relu(x*a + b), 2 x*f, 3 the BN-backward chain
__host__ __device__ constexpr int fm_pro(int m) {
  return m == FM_AFF ? 1 : m == FM_MODGRAD ? 2 : (m == FM_BN2 || m == FM_BN1) ? 3 : 0;
}
// whether the prologue reads a second tensor f beside segment 0's window
__host__ __device__ constexpr bool fm_chain(int m) { return fm_pro(m) >= 2; }
__host__ __device__ constexpr int fm_rows(int m) {
  return (m == FM_STD || m == FM_AFF || m == FM_BN2) ? 2 : m == FM_MODGRAD ? 1
       : m == FM_PRE ? 4 : 0;
}
__host__ __device__ constexpr int fm_bands(int m) {
  return m == FM_PRE ? 4 : (m == FM_MODGRAD || m == FM_BN2 || m == FM_RES) ? 1 : 0;
}
__host__ __device__ constexpr int fm_pcst(int m) {
  return fm_pro(m) == 1 ? 2 : fm_pro(m) == 3 ? 4 : 0;
}
__host__ __device__ constexpr int fm_ecst(int m) {
  return m == FM_PRE || m == FM_RES ? 2 : m == FM_BN2 ? 4 : 0;
}
// the train modes: f32 sums rounded to nearest after every k8 step
__host__ __device__ constexpr bool fm_flush(int m) { return m >= FM_STD; }
// the epilogues of the eval route's launches: bias [and ReLU], or the modulate
__host__ __device__ constexpr bool fm_mod(int m) { return m == FM_MOD || m == FM_GB; }
__host__ __device__ constexpr bool fm_plain(int m) {
  return m == FM_EVAL || m == FM_SEG || fm_mod(m);
}

// A block's shape: WMW warps along the pixels, 8 / WMW along the channels,
// WN n8 tiles per warp. Shared memory in 16-byte pieces: two windows (raw,
// then big in place) and one window of small parts, each with a zero piece
// at its end, and two weight stages of big then small slices; the chain
// modes add two windows of their second tensor.
template <int WMW, int WN>
struct FCfg {
  static constexpr int BN = (8 / WMW) * WN * 8;
  static constexpr int TH = WMW * F_MT;
  static constexpr int WPIX = (TH + 2) * F_WW;
  static constexpr int WIN = F_QMAX * WPIX + 1;
  static constexpr int WT = F_PMAX * BN;
  static constexpr int SMEM = (3 * WIN + 4 * WT) * 16;
  static constexpr int smem(int mode) { return SMEM + (fm_chain(mode) ? 2 * WIN * 16 : 0); }
};

struct F32Seg {
  const float* ptr;  // [n][h][w][c]
  int c, ksize;      // channels, 3 or 1
  int q;             // quads per chunk: 1 when c <= 4, else 2
  int nchunk;        // chunks of 4q channels
  int pairs;         // (tap, quad) pairs per chunk, padded to even
  int kq0;           // first K quad of the segment in the packed weight
  int vec;           // 16-byte copies (c % 4 == 0, aligned)
};

struct F32ConvArgs {
  F32Seg seg[F_MAX_SEG];
  int nseg, nchunk;
  const float* wk;    // [2][nb][kq][BN][4]: the big parts, then the small
  long long wpart;    // 16-byte pieces of one part (nb * kq * BN)
  int kq;             // K quads of one N block
  const float* bias;  // [nb * BN] in the packed column order, or null
  const float* y;     // the modulate's y [m][cout / 2], or null
  float* out;         // [m][cout], with the modulate [m][cout / 2], FM_BN1 [m][split]
  int h, w, cout;     // cout: the conv's columns (2C with the modulate)
  int relu;
  int tiles_w, tiles_h;
  int pixel_blocks;  // the wgmma kernel's: n * tiles_h * tiles_w
  // the train modes
  const float* pro_f;    // segment 0's chain tensor [m][seg[0].c] (FM_MODGRAD, FM_BN*)
  const float* pc[4];    // segment 0's per-channel prologue constants
  const float* ec[4];    // per-output-channel epilogue constants
  const float* band[4];  // output-aligned [m][cout] bands of the epilogue
  float* out1;           // FM_BN1: columns >= split, [m][cout - split]
  int split;
  float* partial;        // [rows][cout][gridDim.x] per-block sums, or null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tf32(x) rounded to nearest, ties away from zero (cvt.rna.tf32.f32), for
// |x| below the f32 limit's rounding boundary
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

// x -> (big, small); an inf or NaN -> (x, 0) and *bad set
__device__ __forceinline__ void split_tf32(float x, float& big, float& small, bool& bad) {
  const uint32_t u = __float_as_uint(x), m = u & 0x7fffffffu;
  if (m >= 0x7f800000u) {
    big = x;
    small = 0.f;
    bad = true;
    return;
  }
  // past 0x7f7ff000 rounding up would give inf: round toward zero there
  big = __uint_as_float(m < 0x7f7ff000u ? tf32_rna(u) : (u & 0xffffe000u));
  small = __uint_as_float(tf32_rna(__float_as_uint(__fsub_rn(x, big))));  // x - big is exact
}

// the register of a big part with an inf or NaN as 0 (a flagged chunk's
// operand of the big x small(weight) products)
__device__ __forceinline__ uint32_t finite_or_zero(uint32_t u) {
  return (u & 0x7f800000u) == 0x7f800000u ? 0u : u;
}

// ReLU that keeps a NaN, as torch.relu does
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

// p*(g - q - (f*r' - m')) with the f32 roundings of the plain version
__device__ __forceinline__ float bn_chain_f32(float g, float f, float p, float q, float r,
                                              float m) {
  const float t = __fsub_rn(g, q);
  const float u = __fsub_rn(__fmul_rn(f, r), m);
  return __fmul_rn(p, __fsub_rn(t, u));
}

// segment 0's prologue on one window value x of channel c (f: the chain
// tensor's value at the same place)
template <int MODE>
__device__ __forceinline__ float prologue(const F32ConvArgs& a, float x, float f, int c) {
  if constexpr (fm_pro(MODE) == 1) {
    return relu_nan(__fadd_rn(__fmul_rn(x, __ldg(a.pc[0] + c)), __ldg(a.pc[1] + c)));
  } else if constexpr (fm_pro(MODE) == 2) {
    return __fmul_rn(x, f);
  } else {
    return bn_chain_f32(x, f, __ldg(a.pc[0] + c), __ldg(a.pc[1] + c), __ldg(a.pc[2] + c),
                        __ldg(a.pc[3] + c));
  }
}

__device__ __forceinline__ F32Seg seg_at(const F32ConvArgs& a, int i) {
  return i == 0 ? a.seg[0] : i == 1 ? a.seg[1] : a.seg[2];
}

// chunk i of the conv: its segment s and its index j within the segment
__device__ __forceinline__ void chunk_of(const F32ConvArgs& a, int i, int& s, int& j) {
  s = 0;
  j = i;
  if (a.nseg > 1 && j >= a.seg[0].nchunk) {
    j -= a.seg[0].nchunk;
    s = 1;
    if (a.nseg > 2 && j >= a.seg[1].nchunk) {
      j -= a.seg[1].nchunk;
      s = 2;
    }
  }
}

template <int WMW, int WN, int MODE>
__global__ void __launch_bounds__(F_THREADS, fm_flush(MODE) ? 1 : 2)
    f32_conv_kernel(const F32ConvArgs a) {
  using C = FCfg<WMW, WN>;
  constexpr int PRO = fm_pro(MODE);
  constexpr bool CHAIN = fm_chain(MODE);
  constexpr bool FLUSH = fm_flush(MODE);
  extern __shared__ __align__(16) float4 sm[];
  float4* const lowin = sm + 2 * C::WIN;  // the small parts of the current window
  float4* const wts = sm + 3 * C::WIN;    // stage b: big slice, then small slice
  float4* const prowin = wts + 4 * C::WT;  // CHAIN: the chain tensor's raw windows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WMW, wn = warp / WMW;
  int t = blockIdx.x;
  const int tx = t % a.tiles_w;
  t /= a.tiles_w;
  const int ty = t % a.tiles_h;
  const int img = t / a.tiles_h;
  const int y0 = ty * C::TH, x0 = tx * F_TW;
  const int nb = blockIdx.y;

  if (tid < 3) sm[tid * C::WIN + C::WIN - 1] = make_float4(0.f, 0.f, 0.f, 0.f);

  // chunk i's window into window buffer b and its weight slices into stage b
  auto load = [&](int i, int b) {
    int s, j;
    chunk_of(a, i, s, j);
    const F32Seg S = seg_at(a, s);
    float4* win = sm + b * C::WIN;
    float4* pwin = prowin + b * C::WIN;
    const bool ch = CHAIN && s == 0;
    const int ch0 = j * 4 * S.q;
    for (int e = tid; e < S.q * C::WPIX; e += F_THREADS) {
      const int q = e >= C::WPIX ? 1 : 0;
      const int p = e - q * C::WPIX;
      const int r = p / F_WW, col = p - r * F_WW;
      const int ih = y0 - 1 + r, iw = x0 - 1 + col, c0 = ch0 + 4 * q;
      const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w && c0 < S.c;
      const long long off = (((long long)img * a.h + ih) * a.w + iw) * S.c + c0;
      const float* src = S.ptr + off;
      if (S.vec) {
        cp16(win + e, in ? src : S.ptr, in);
        if (ch) cp16(pwin + e, in ? a.pro_f + off : a.pro_f, in);
      } else {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = (in && c0 + k < S.c) ? __ldg(src + k) : 0.f;
        win[e] = make_float4(v[0], v[1], v[2], v[3]);
        if (ch) {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = (in && c0 + k < S.c) ? __ldg(a.pro_f + off + k) : 0.f;
          pwin[e] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    const float4* wsrc = reinterpret_cast<const float4*>(a.wk) +
                         ((long long)nb * a.kq + S.kq0 + (long long)j * S.pairs) * C::BN;
    float4* wdst = wts + b * 2 * C::WT;
    for (int e = tid; e < S.pairs * C::BN; e += F_THREADS) {
      cp16(wdst + e, wsrc + e, true);
      cp16(wdst + C::WT + e, wsrc + a.wpart + e, true);
    }
  };

  float acc[F_MT][WN][4];
  float tot[FLUSH ? F_MT : 1][FLUSH ? WN : 1][4];  // FLUSH: the rounded sums
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[mt][nt][k] = 0.f;
        if (FLUSH) tot[mt][nt][k] = 0.f;
      }

  // the products of one chunk (window buffer b): FLAG, a chunk whose window
  // holds an inf or NaN
  auto compute = [&](auto flag, int b, const F32Seg& S) {
    constexpr bool FLAG = decltype(flag)::value;
    const uint32_t hib = smem_u32(sm + b * C::WIN), lob = smem_u32(lowin);
    const uint32_t wbig = smem_u32(wts + b * 2 * C::WT), wsmall = wbig + C::WT * 16;
    const int mi = lane >> 3, row = lane & 7;
    const int acol = (mi & 1) * 8 + row;  // A: the lane's pixel in its m16 row
    const int real = S.ksize * S.ksize * S.q;
#pragma unroll 1
    for (int st = 0; st < S.pairs / 2; ++st) {
      const int p = 2 * st + (mi >> 1);  // A: the lane's pair
      int off = C::WIN - 1, mstride = 0;  // a padded pair reads the zero piece
      if (p < real) {
        const int tap = S.q == 2 ? p >> 1 : p, qq = p - tap * S.q;
        const int dy = S.ksize == 3 ? tap / 3 : 1, dx = S.ksize == 3 ? tap - 3 * dy : 1;
        off = qq * C::WPIX + (wm * F_MT + dy) * F_WW + dx + acol;
        mstride = F_WW;
      }
      uint32_t bb[WN][2], bs[WN][2];
      if (WN == 1) {
        const uint32_t o = ((2 * st + (mi & 1)) * C::BN + wn * 8 + row) * 16;
        ldsm_x2(bb[0], wbig + o);
        ldsm_x2(bs[0], wsmall + o);
      } else {
#pragma unroll
        for (int jj = 0; jj < WN / 2; ++jj) {
          const uint32_t o =
              ((2 * st + (mi & 1)) * C::BN + (wn * WN + 2 * jj + (mi >> 1)) * 8 + row) * 16;
          uint32_t r[4];
          ldsm_x4(r, wbig + o);
          bb[2 * jj][0] = r[0];
          bb[2 * jj][1] = r[1];
          bb[2 * jj + 1][0] = r[2];
          bb[2 * jj + 1][1] = r[3];
          ldsm_x4(r, wsmall + o);
          bs[2 * jj][0] = r[0];
          bs[2 * jj][1] = r[1];
          bs[2 * jj + 1][0] = r[2];
          bs[2 * jj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < F_MT; ++mt) {
        uint32_t ah[4], al[4], ah2[4];
        ldsm_x4(ah, hib + (off + mt * mstride) * 16);
        ldsm_x4(al, lob + (off + mt * mstride) * 16);
#pragma unroll
        for (int k = 0; k < 4; ++k) ah2[k] = FLAG ? finite_or_zero(ah[k]) : ah[k];
#pragma unroll
        for (int nt = 0; nt < WN; ++nt) {
          mma_tf32(acc[mt][nt], al, bb[nt]);
          mma_tf32(acc[mt][nt], ah2, bs[nt]);
          mma_tf32(acc[mt][nt], ah, bb[nt]);
        }
      }
      if constexpr (FLUSH) {
#pragma unroll
        for (int mt = 0; mt < F_MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < WN; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              tot[mt][nt][k] += acc[mt][nt][k];
              acc[mt][nt][k] = 0.f;
            }
      }
    }
  };

  load(0, 0);
  cp_commit();
#pragma unroll 1
  for (int i = 0; i < a.nchunk; ++i) {
    const int b = i & 1;
    if (i + 1 < a.nchunk) load(i + 1, b ^ 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    int s, j;
    chunk_of(a, i, s, j);
    const F32Seg S = seg_at(a, s);
    // split the window in place: big over the raw values, small beside;
    // segment 0's prologue first, on the values inside the image
    bool bad = false;
    float4* win = sm + b * C::WIN;
    const float4* pwin = prowin + b * C::WIN;
    for (int e = tid; e < S.q * C::WPIX; e += F_THREADS) {
      float4 v = win[e];
      if (PRO != 0 && s == 0) {
        const int q = e >= C::WPIX ? 1 : 0;
        const int p = e - q * C::WPIX;
        const int r = p / F_WW, col = p - r * F_WW;
        const int ih = y0 - 1 + r, iw = x0 - 1 + col, c0 = j * 4 * S.q + 4 * q;
        if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w) {
          const float4 f = CHAIN ? pwin[e] : make_float4(0.f, 0.f, 0.f, 0.f);
          if (c0 < S.c) v.x = prologue<MODE>(a, v.x, f.x, c0);
          if (c0 + 1 < S.c) v.y = prologue<MODE>(a, v.y, f.y, c0 + 1);
          if (c0 + 2 < S.c) v.z = prologue<MODE>(a, v.z, f.z, c0 + 2);
          if (c0 + 3 < S.c) v.w = prologue<MODE>(a, v.w, f.w, c0 + 3);
        }
      }
      float4 hi, lo;
      split_tf32(v.x, hi.x, lo.x, bad);
      split_tf32(v.y, hi.y, lo.y, bad);
      split_tf32(v.z, hi.z, lo.z, bad);
      split_tf32(v.w, hi.w, lo.w, bad);
      win[e] = hi;
      lowin[e] = lo;
    }
    if (__syncthreads_or(bad))
      compute(std::integral_constant<bool, true>(), b, S);
    else
      compute(std::integral_constant<bool, false>(), b, S);
    __syncthreads();
  }

  // epilogue: c0, c1 of an m16 x n8 tile are row g, columns 2t and 2t+1;
  // c2, c3 row g + 8
  const int g = lane >> 2, tq = lane & 3;
  if constexpr (fm_plain(MODE)) {
#pragma unroll
    for (int mt = 0; mt < F_MT; ++mt) {
      const int ih = y0 + wm * F_MT + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int iw = x0 + g + 8 * half;
        if (ih >= a.h || iw >= a.w) continue;
        const long long pix = ((long long)img * a.h + ih) * a.w + iw;
#pragma unroll
        for (int nt = 0; nt < WN; ++nt) {
          const int n = nb * C::BN + (wn * WN + nt) * 8 + 2 * tq;
          float v0 = FLUSH ? tot[mt][nt][2 * half] : acc[mt][nt][2 * half];
          float v1 = FLUSH ? tot[mt][nt][2 * half + 1] : acc[mt][nt][2 * half + 1];
          if (a.bias) {
            v0 = __fadd_rn(v0, a.bias[n]);
            v1 = __fadd_rn(v1, a.bias[n + 1]);
          }
          if (fm_mod(MODE)) {  // columns (2c, 2c + 1) are (g_c, b_c)
            const int cc = a.cout >> 1, c = n >> 1;
            if (c < cc)
              a.out[pix * cc + c] =
                  __fadd_rn(__fmul_rn(a.y[pix * cc + c], __fadd_rn(1.f, v0)), v1);
          } else {
            if (a.relu) {  // a NaN stays, as torch.relu keeps it
              v0 = relu_nan(v0);
              v1 = relu_nan(v1);
            }
            if (n < a.cout) a.out[pix * a.cout + n] = v0;
            if (n + 1 < a.cout) a.out[pix * a.cout + n + 1] = v1;
          }
        }
      }
    }
  } else {
    // the train modes: columns are output channels (no interleave); per n8
    // tile, the mode's output and its stat rows over the block's pixels
    constexpr int NS = fm_rows(MODE);
    float* red = reinterpret_cast<float*>(sm);  // [WMW][NS][BN], after the main loop
    cp_wait0();
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
      const int cl = (wn * WN + nt) * 8 + 2 * tq;  // the thread's first column in the block
      const int n = nb * C::BN + cl;
      float st[NS > 0 ? NS : 1][2];
#pragma unroll
      for (int r = 0; r < NS; ++r) st[r][0] = st[r][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < F_MT; ++mt) {
        const int ih = y0 + wm * F_MT + mt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int iw = x0 + g + 8 * half;
          if (ih >= a.h || iw >= a.w) continue;
          const long long pix = ((long long)img * a.h + ih) * a.w + iw;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n + e;
            if (c >= a.cout) continue;
            const float v = tot[mt][nt][2 * half + e];
            const long long m = pix * a.cout + c;
            float o;
            if constexpr (MODE == FM_STD || MODE == FM_AFF) {
              o = a.bias ? __fadd_rn(v, a.bias[c]) : v;
              st[0][e] += o;
              st[1][e] += o * o;
            } else if constexpr (MODE == FM_MODGRAD) {
              o = __ldg(a.band[0] + m) > 0.f ? v : 0.f;
              st[0][e] += o;
            } else if constexpr (MODE == FM_PRE) {
              const float gf = __ldg(a.band[0] + m), gm = __ldg(a.band[1] + m);
              const float yf = __ldg(a.band[2] + m), f2 = __ldg(a.band[3] + m);
              const float gy = __fadd_rn(__fmul_rn(gf, __fadd_rn(1.f, gm)), v);
              o = yf > 0.f ? gy : 0.f;
              const float xh = __fsub_rn(__fmul_rn(f2, __ldg(a.ec[0] + c)), __ldg(a.ec[1] + c));
              st[0][e] += o;
              st[1][e] += o * xh;
              st[2][e] += gf * yf;
              st[3][e] += gf;
            } else if constexpr (MODE == FM_BN2) {
              const float f1 = __ldg(a.band[0] + m);
              const float pre = __fadd_rn(__fmul_rn(f1, __ldg(a.ec[0] + c)), __ldg(a.ec[1] + c));
              const float xh = __fsub_rn(__fmul_rn(f1, __ldg(a.ec[2] + c)), __ldg(a.ec[3] + c));
              o = pre > 0.f ? v : 0.f;
              st[0][e] += o;
              st[1][e] += o * xh;
            } else if constexpr (MODE == FM_RES) {
              o = relu_nan(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(a.band[0] + m),
                                                         __ldg(a.ec[0] + c)),
                                               __ldg(a.ec[1] + c)),
                                     v));
            } else {  // FM_BN1
              o = v;
            }
            if constexpr (MODE == FM_BN1) {
              if (c < a.split)
                a.out[pix * a.split + c] = o;
              else
                a.out1[pix * (a.cout - a.split) + c - a.split] = o;
            } else {
              a.out[m] = o;
            }
          }
        }
      }
      if constexpr (NS > 0) {
        // over the 8 row groups of the warp, then each warp row's sums in
        // its own slots, added in a fixed order below
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int r = 0; r < NS; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) st[r][e] += __shfl_xor_sync(0xffffffffu, st[r][e], off);
        if (g == 0 && a.partial != nullptr) {
#pragma unroll
          for (int r = 0; r < NS; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) red[(wm * NS + r) * C::BN + cl + e] = st[r][e];
        }
      }
    }
    if constexpr (NS > 0) {
      if (a.partial == nullptr) return;  // uniform across the block
      __syncthreads();
      const long long nbx = gridDim.x;
      for (int i = tid; i < NS * C::BN; i += F_THREADS) {
        const int r = i / C::BN, c = i - r * C::BN;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WMW; ++w) v += red[w * NS * C::BN + i];
        if (nb * C::BN + c < a.cout)
          a.partial[((long long)r * a.cout + nb * C::BN + c) * nbx + blockIdx.x] = v;
      }
    }
  }
}

template <int WMW, int WN, int MODE>
cudaError_t f32_launch(const F32ConvArgs& a, int n, int nblocks, cudaStream_t stream) {
  using C = FCfg<WMW, WN>;
  static bool attr = false;  // the shared-memory limit is set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(f32_conv_kernel<WMW, WN, MODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               C::smem(MODE));
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((unsigned)(a.tiles_w * a.tiles_h * n), (unsigned)nblocks);
  f32_conv_kernel<WMW, WN, MODE><<<grid, F_THREADS, C::smem(MODE), stream>>>(a);
  return cudaGetLastError();
}

// N tile of a conv of cout columns: 8, 16 or 64 (in N blocks); the weight
// packer (ops/stage_kernel.py f32_bn) packs by the same rule
int f32_bn(int cout) { return cout <= 8 ? 8 : cout <= 16 ? 16 : 64; }

// tile rows of a block for the N tile bn
int f32_th(int bn) { return bn == 64 ? FCfg<4, 4>::TH : FCfg<8, 1>::TH; }

template <int MODE>
cudaError_t f32_launch_bn(F32ConvArgs& a, int n, int bn, int nblocks, cudaStream_t stream) {
  a.tiles_w = (a.w + F_TW - 1) / F_TW;
  a.tiles_h = (a.h + f32_th(bn) - 1) / f32_th(bn);
  if (bn == 8) return f32_launch<8, 1, MODE>(a, n, nblocks, stream);
  if (bn == 16) return f32_launch<8, 2, MODE>(a, n, nblocks, stream);
  return f32_launch<4, 4, MODE>(a, n, nblocks, stream);
}

// The segments and weight of one conv into a: nseg (<= 3) segments, ptrs,
// chans and ks (3 or 1) per segment; w the weight packed by
// ops/stage_kernel.py pack_f32_conv ([2][nb][kq][bn][4]); pro_aligned: the
// chain tensor beside segment 0 (if any) allows 16-byte copies. Returns
// cudaErrorInvalidValue where they do not fit.
cudaError_t f32_conv_args(F32ConvArgs& a, int nseg, const void* const* ptrs, const int* chans,
                          const int* ks, const void* w, int kq, int bn, int cout,
                          bool pro_aligned) {
  if (nseg < 1 || nseg > F_MAX_SEG || bn != f32_bn(cout)) return cudaErrorInvalidValue;
  int k = 0, chunks = 0;
  for (int s = 0; s < nseg; ++s) {
    const int c = chans[s];
    if ((ks[s] != 1 && ks[s] != 3) || c < 1 || ptrs[s] == nullptr) return cudaErrorInvalidValue;
    F32Seg S{};
    S.ptr = (const float*)ptrs[s];
    S.c = c;
    S.ksize = ks[s];
    S.q = c <= 4 ? 1 : 2;
    S.nchunk = (c + 4 * S.q - 1) / (4 * S.q);
    S.pairs = ks[s] * ks[s] * S.q;
    S.pairs += S.pairs & 1;
    S.kq0 = k;
    S.vec = c % 4 == 0 && ((uintptr_t)ptrs[s] & 15) == 0 && (s > 0 || pro_aligned);
    a.seg[s] = S;
    k += S.nchunk * S.pairs;
    chunks += S.nchunk;
  }
  if (k != kq || ((uintptr_t)w & 15)) return cudaErrorInvalidValue;
  const int nblocks = (cout + bn - 1) / bn;
  a.nseg = nseg;
  a.nchunk = chunks;
  a.wk = (const float*)w;
  a.wpart = (long long)nblocks * kq * bn;
  a.kq = kq;
  a.cout = cout;
  return cudaSuccess;
}

}  // namespace
