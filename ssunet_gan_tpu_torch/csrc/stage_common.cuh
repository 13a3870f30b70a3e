// Shared device code of the port's fused-stage kernels (fused_stage.cu,
// bneck_stage.cu, train_stage.cu; its bf16 helpers also serve the others):
// bf16 helpers, the implicit-GEMM conv core on mma.sync m16n8k16 bf16
// tensor cores with f32 sums, and the self-SPADE tail with its launcher.
// Everything is in an anonymous namespace, so each source gets its own copy
// and nothing is exported. The conv core: M = pixels (128 per block), N =
// output channels (64 per block), K = sources x taps x input channels
// padded to 32, each split-concat part or 1x1 shortcut read through its own
// pointer, a register double buffer feeding two shared-memory stages.
// Numerics: each conv zero-pads its own input at the image border, sums run
// in f32, outputs are rounded to bf16.

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

constexpr int BK = 32;        // K (conv) or pixels (wgrad) per pipeline step
constexpr int LDS = BK + 8;   // padded shared row (halves)
constexpr int MAX_SRC = 3;

struct Src {
  const bf16* ptr;
  int c;      // channels
  int cpad;   // channels rounded up to BK (weight / dW layout)
  int ksize;  // 3 or 1
  int vec;    // 16-byte loads allowed
};

// Eight channels c0..c0+7 of one pixel of a source (zeros past S.c).
__device__ __forceinline__ uint4 load8(const Src& S, long long pix, int c0) {
  const bf16* p = S.ptr + (pix * S.c + c0);
  if (S.vec && c0 + 8 <= S.c) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
  unsigned short e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = (c0 + j < S.c) ? ps[j] : 0;
  return make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                    e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
}

// Map a K step of 32 to (source, tap, first channel) for sources laid out
// source-major, tap-major, channel (padded to BK).
__device__ __forceinline__ void k_step(const Src* src, int nsrc, int kt, int& s,
                                       int& tap, int& c0) {
  s = 0;
  int rem = kt;
  while (s < nsrc - 1) {
    const int steps = (src[s].cpad / BK) * src[s].ksize * src[s].ksize;
    if (rem < steps) break;
    rem -= steps;
    ++s;
  }
  const int nchunk = src[s].cpad / BK;
  tap = rem / nchunk;
  c0 = (rem - tap * nchunk) * BK;
}

// ---------------------------------------------------------------------------
// The conv core: implicit-GEMM conv3x3/1x1 over up to three sources, with a
// bias [+ ReLU] or residual epilogue: the eval stages' convs and the train
// tail's residual conv. (The train convs have their own core, bwd_core.cuh.)
// ---------------------------------------------------------------------------

constexpr int BM = 128;            // pixels per block
constexpr int BN = 64;             // output channels per block
constexpr int CONV_THREADS = 128;  // 4 warps, 2 x 2, 64 x 32 each

struct ConvArgs {
  Src src[MAX_SRC];
  int nsrc;
  const bf16* wt;      // [cout][kp], K = sources x taps x cpad
  int kp;
  const float* bias;   // [cout] or null
  const bf16* res;     // [m][cout]: out = relu(res*res_a + res_b + acc), or null
  const float* res_a;
  const float* res_b;
  bf16* out;           // [m][cout]
  int relu;            // ReLU after the bias (the eval stage's folded BN + ReLU)
  int h, w, cout;
  long long m;         // n * h * w
};

__global__ void __launch_bounds__(CONV_THREADS)
conv_kernel(const ConvArgs args) {
  __shared__ __align__(16) bf16 As[2][BM][LDS];
  __shared__ __align__(16) bf16 Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int H = args.h, W = args.w;
  const long long hw = (long long)H * W;

  // This thread loads 8 consecutive K values (one 16-byte group kg) of four
  // A rows and two B rows per step; the rows stay fixed across K.
  const int kg = tid & 3;
  long long a_img[4];
  int a_oh[4], a_ow[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 2) + 32 * i;
    a_ok[i] = m < args.m;
    const long long img = a_ok[i] ? m / hw : 0;
    const long long rem = a_ok[i] ? m - img * hw : 0;
    a_img[i] = img * hw;
    a_oh[i] = (int)(rem / W);
    a_ow[i] = (int)(rem - (long long)a_oh[i] * W);
  }

  const int ktiles = args.kp / BK;
  uint4 ra[4], rb[2];

  auto load_tile = [&](int kt) {
    int s, tap, cb;
    k_step(args.src, args.nsrc, kt, s, tap, cb);
    const Src S = args.src[s];
    const int c0 = cb + kg * 8;
    const int pad = S.ksize == 3 ? 1 : 0;
    const int dy = S.ksize == 3 ? tap / 3 : 0;
    const int dx = S.ksize == 3 ? tap % 3 : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_oh[i] + dy - pad, iw = a_ow[i] + dx - pad;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (a_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W && c0 < S.c)
        v = load8(S, a_img[i] + (long long)ih * W + iw, c0);
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = n0 + (tid >> 2) + 32 * i;
      rb[i] = n < args.cout
                  ? *reinterpret_cast<const uint4*>(
                        args.wt + (long long)n * args.kp + kt * BK + kg * 8)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 2) + 32 * i][kg * 8]) = ra[i];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&Bs[buf][(tid >> 2) + 32 * i][kg * 8]) = rb[i];
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_tile(0);
  store_tile(0);
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load_tile(kt + 1);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
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
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < ktiles) store_tile(cur ^ 1);
    __syncthreads();
  }

  const bool pair_store = (args.cout & 1) == 0;

  // [+ bias | residual affine + ReLU], round to bf16, NHWC store
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int ch0 = n0 + wn * 32 + ni * 8 + 2 * t;
    float bv[2] = {0.f, 0.f}, rav[2] = {0.f, 0.f}, rbv[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (ch0 + e >= args.cout) continue;
      if (args.bias != nullptr) bv[e] = args.bias[ch0 + e];
      if (args.res != nullptr) {
        rav[e] = args.res_a[ch0 + e];
        rbv[e] = args.res_b[ch0 + e];
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 64 + mi * 16 + g + 8 * half;
        if (m >= args.m || ch0 >= args.cout) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[mi][ni][2 * half + e] + bv[e];
          if (args.relu) v = fmaxf(v, 0.f);
          if (args.res != nullptr && ch0 + e < args.cout) {
            const float r = __bfloat162float(args.res[m * args.cout + ch0 + e]);
            v = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(r, rav[e]), rbv[e]),
                                acc[mi][ni][2 * half + e]), 0.f);
          }
          o[e] = bf16r(v);
        }
        bf16* op = args.out + m * args.cout + ch0;
        if (pair_store) {
          *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(o[0], o[1]);
        } else {
          op[0] = __float2bfloat16_rn(o[0]);
          if (ch0 + 1 < args.cout) op[1] = __float2bfloat16_rn(o[1]);
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// The self-SPADE tail on a 16x16 output tile (+ an optional folded 1x1
// head), optionally saving seg and actv (the train tail). y is staged with
// a 3-pixel halo, seg on 20x20, actv on 18x18. The narrow convs (3 labels,
// <= 16 hidden channels) would waste tensor-core tiles; they run as f32
// FMAs, and the modulate runs in bf16 one operation at a time.
// ---------------------------------------------------------------------------

constexpr int TT = 16;           // output tile side
constexpr int YT = TT + 6;       // y window side (3 conv rings)
constexpr int ST = TT + 4;       // seg window side
constexpr int AT = TT + 2;       // act window side
constexpr int SEG_CC = 16;       // y channels per seg pass
constexpr int YS = SEG_CC + 1;   // padded y row (floats)
constexpr int GB_CC = 32;        // output channels per g|b pass
constexpr int TAIL_THREADS = 256;
constexpr int MAX_LAB = 8, MAX_NH = 16, MAX_CLS = 8;

struct TailArgs {
  const bf16* y;  // [n, h, w, c]
  int h, w, c;
  const float* k1s;  // [9][c][lab]   (x2map)
  const float* b1s;  // [lab]
  int lab;
  const float* k2s;  // [9][lab][nh]  (mlp_shared)
  const float* b2s;  // [nh]
  int nh;
  const float* kgb;  // [9*nh][2c]    (mlp_gamma | mlp_beta)
  const float* bgb;  // [2c]
  const float* kf;   // [c][ncls] or null (folded final 1x1 conv)
  const float* bf;   // [ncls]
  int ncls;
  bf16* out;         // [n, h, w, c] or [n, h, w, ncls]
  signed char* out_q;  // [n, h, w, c] s8: clip(round(out * q_inv)) instead of out, or null
  float q_inv;
  bf16* seg_out;     // [n, h, w, lab] or null
  bf16* act_out;     // [n, h, w, nh] or null
};

__host__ __device__ inline int odd_stride(int x) { return x | 1; }

__host__ __device__ inline int tail_union_floats(int nh) {
  const int ybuf = YT * YT * YS;
  const int wgb = 9 * nh * 2 * GB_CC;
  return ybuf > wgb ? ybuf : wgb;
}

__host__ inline size_t tail_smem_bytes(int lab, int nh, int ncls) {
  const size_t floats = (size_t)tail_union_floats(nh) + 9 * SEG_CC * lab +
                        ST * ST * odd_stride(lab) + AT * AT * odd_stride(nh) +
                        9 * lab * nh + nh + 2 * GB_CC + GB_CC * ncls;
  return floats * sizeof(float);
}

__global__ void __launch_bounds__(TAIL_THREADS)
spade_tail_kernel(const TailArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lab = a.lab, nh = a.nh, C = a.c, H = a.h, W = a.w;
  const int ls = odd_stride(lab), as = odd_stride(nh);
  float* ubuf = smem;                                 // y chunk | g|b weights
  float* k1buf = ubuf + tail_union_floats(nh);        // [9][SEG_CC][lab]
  float* seg = k1buf + 9 * SEG_CC * lab;              // [ST*ST][ls]
  float* act = seg + ST * ST * ls;                    // [AT*AT][as]
  float* k2buf = act + AT * AT * as;                  // [9][lab][nh]
  float* b2buf = k2buf + 9 * lab * nh;                // [nh]
  float* bgbuf = b2buf + nh;                          // [2*GB_CC]
  float* kfbuf = bgbuf + 2 * GB_CC;                   // [GB_CC][ncls]

  const int tid = threadIdx.x;
  const int oh0 = blockIdx.y * TT, ow0 = blockIdx.x * TT;
  const long long img = (long long)blockIdx.z * H * W;

  for (int i = tid; i < 9 * lab * nh; i += TAIL_THREADS) k2buf[i] = a.k2s[i];
  for (int i = tid; i < nh; i += TAIL_THREADS) b2buf[i] = a.b2s[i];

  // ---- seg = conv3x3(y) + b on the 20x20 window, y streamed by channel
  float sacc[2][MAX_LAB];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int l = 0; l < MAX_LAB; ++l) sacc[p][l] = 0.f;

  for (int c0 = 0; c0 < C; c0 += SEG_CC) {
    __syncthreads();
    for (int i = tid; i < YT * YT * 2; i += TAIL_THREADS) {
      const int pos = i >> 1, half = i & 1;
      const int gh = oh0 - 3 + pos / YT, gw = ow0 - 3 + pos % YT;
      float f[8];
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        unpack8(*reinterpret_cast<const uint4*>(
                    a.y + (img + (long long)gh * W + gw) * C + c0 + half * 8),
                f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ubuf[pos * YS + half * 8 + j] = f[j];
    }
    for (int i = tid; i < 9 * SEG_CC * lab; i += TAIL_THREADS) {
      const int tap = i / (SEG_CC * lab);
      const int r = i - tap * SEG_CC * lab;
      const int c = r / lab, l = r - (r / lab) * lab;
      k1buf[i] = a.k1s[((long long)tap * C + c0 + c) * lab + l];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int sp = tid + p * TAIL_THREADS;
      if (sp >= ST * ST) continue;
      const int sr = sp / ST, sc = sp % ST;
      for (int tap = 0; tap < 9; ++tap) {
        const float* yr = ubuf + ((sr + tap / 3) * YT + sc + tap % 3) * YS;
        const float* kr = k1buf + tap * SEG_CC * lab;
        for (int c = 0; c < SEG_CC; ++c) {
          const float v = yr[c];
#pragma unroll
          for (int l = 0; l < MAX_LAB; ++l)
            if (l < lab) sacc[p][l] += v * kr[c * lab + l];
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int sp = tid + p * TAIL_THREADS;
    if (sp >= ST * ST) continue;
    const int sr = sp / ST, sc = sp % ST;
    const int gh = oh0 - 2 + sr, gw = ow0 - 2 + sc;
    const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const bool centre = a.seg_out != nullptr && in && sr >= 2 && sr < ST - 2 &&
                        sc >= 2 && sc < ST - 2;
    const long long pix = img + (long long)gh * W + gw;
#pragma unroll
    for (int l = 0; l < MAX_LAB; ++l) {
      if (l >= lab) continue;
      const float v = in ? bf16r(sacc[p][l] + a.b1s[l]) : 0.f;
      seg[sp * ls + l] = v;
      if (centre) a.seg_out[pix * lab + l] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  // ---- act = relu(conv3x3(seg) + b) on the 18x18 window
  for (int i = tid; i < AT * AT * nh; i += TAIL_THREADS) {
    const int ap = i / nh, j = i - ap * nh;
    const int ar = ap / AT, ac = ap % AT;
    float s = b2buf[j];
    for (int tap = 0; tap < 9; ++tap) {
      const float* sr = seg + ((ar + tap / 3) * ST + ac + tap % 3) * ls;
      const float* kr = k2buf + tap * lab * nh + j;
      for (int l = 0; l < lab; ++l) s += sr[l] * kr[l * nh];
    }
    const int gh = oh0 - 1 + ar, gw = ow0 - 1 + ac;
    const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const float v = in ? bf16r(fmaxf(s, 0.f)) : 0.f;
    act[ap * as + j] = v;
    if (a.act_out != nullptr && in && ar >= 1 && ar < AT - 1 && ac >= 1 && ac < AT - 1)
      a.act_out[(img + (long long)gh * W + gw) * nh + j] = __float2bfloat16_rn(v);
  }

  // ---- g|b = conv3x3(act) + b, out = y*(1+g) + b [, logits]
  const int tr = tid / TT, tc = tid % TT;
  const int oh = oh0 + tr, ow = ow0 + tc;
  const bool valid = oh < H && ow < W;
  const long long pix = img + (long long)oh * W + ow;
  const bool head = a.kf != nullptr;
  float lg[MAX_CLS];
#pragma unroll
  for (int k = 0; k < MAX_CLS; ++k) lg[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += GB_CC) {
    __syncthreads();
    for (int i = tid; i < 9 * nh * 2 * GB_CC; i += TAIL_THREADS) {
      const int k = i / (2 * GB_CC), cc = i % (2 * GB_CC);
      const int col = cc < GB_CC ? c0 + cc : C + c0 + cc - GB_CC;
      ubuf[i] = a.kgb[(long long)k * 2 * C + col];
    }
    if (tid < 2 * GB_CC)
      bgbuf[tid] = a.bgb[tid < GB_CC ? c0 + tid : C + c0 + tid - GB_CC];
    if (head)
      for (int i = tid; i < GB_CC * a.ncls; i += TAIL_THREADS)
        kfbuf[i] = a.kf[(long long)c0 * a.ncls + i];
    __syncthreads();

    float ga[GB_CC], ba[GB_CC];
#pragma unroll
    for (int c = 0; c < GB_CC; ++c) {
      ga[c] = bgbuf[c];
      ba[c] = bgbuf[GB_CC + c];
    }
    for (int tap = 0; tap < 9; ++tap) {
      const float* ar = act + ((tr + tap / 3) * AT + tc + tap % 3) * as;
      for (int j = 0; j < nh; ++j) {
        const float v = ar[j];
        const float4* wr =
            reinterpret_cast<const float4*>(ubuf + (tap * nh + j) * 2 * GB_CC);
#pragma unroll
        for (int q = 0; q < GB_CC / 4; ++q) {
          const float4 wg = wr[q];
          ga[4 * q] += v * wg.x;
          ga[4 * q + 1] += v * wg.y;
          ga[4 * q + 2] += v * wg.z;
          ga[4 * q + 3] += v * wg.w;
          const float4 wb = wr[GB_CC / 4 + q];
          ba[4 * q] += v * wb.x;
          ba[4 * q + 1] += v * wb.y;
          ba[4 * q + 2] += v * wb.z;
          ba[4 * q + 3] += v * wb.w;
        }
      }
    }
    if (!valid) continue;
    const uint4* yp = reinterpret_cast<const uint4*>(a.y + pix * C + c0);
#pragma unroll
    for (int q = 0; q < GB_CC / 8; ++q) {
      float yv[8];
      unpack8(yp[q], yv);
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * q + j;
        // modulate in bf16, one rounding per operation
        const float one_g = bf16r(1.f + bf16r(ga[c]));
        o[j] = bf16r(bf16r(yv[j] * one_g) + bf16r(ba[c]));
      }
      if (head) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int k = 0; k < MAX_CLS; ++k)
            if (k < a.ncls) lg[k] += o[j] * kfbuf[(8 * q + j) * a.ncls + k];
      } else if (a.out_q != nullptr) {
        // the stage output as s8 at the calibrated output scale (round
        // half to even of the bf16 value times the inverse scale)
        uint32_t w2[2];
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          uint32_t v = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float r = fminf(fmaxf(rintf(__fmul_rn(o[4 * hq + j], a.q_inv)), -127.f), 127.f);
            v |= ((uint32_t)(uint8_t)(signed char)(int)r) << (8 * j);
          }
          w2[hq] = v;
        }
        *reinterpret_cast<uint2*>(a.out_q + pix * C + c0 + 8 * q) = make_uint2(w2[0], w2[1]);
      } else {
        reinterpret_cast<uint4*>(a.out + pix * C + c0)[q] =
            make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                       pack2(o[6], o[7]));
      }
    }
  }
  if (head && valid) {
#pragma unroll
    for (int k = 0; k < MAX_CLS; ++k)
      if (k < a.ncls)
        a.out[pix * a.ncls + k] = __float2bfloat16_rn(lg[k] + a.bf[k]);
  }
}

// Validate and launch the tail; seg and act may be null (no saves). With
// out_q the stage output leaves as s8 (out is then unused and may be null;
// no folded head).
int launch_spade_tail_q(const void* y, int n, int h, int wd, int c, const void* k1s,
                        const void* b1s, int lab, const void* k2s, const void* b2s,
                        int nh, const void* kgb, const void* bgb, const void* kf,
                        const void* bf, int ncls, void* out, void* out_q, float q_inv,
                        void* seg, void* act, void* stream) {
  if (c % GB_CC != 0 || lab < 1 || lab > MAX_LAB || nh < 1 || nh > MAX_NH ||
      (kf != nullptr && (ncls < 1 || ncls > MAX_CLS)) || n <= 0 || h <= 0 ||
      wd <= 0 || (uintptr_t)y % 16 != 0 ||
      (out_q != nullptr ? (kf != nullptr || (uintptr_t)out_q % 8 != 0)
                        : (out == nullptr || (uintptr_t)out % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.y = static_cast<const bf16*>(y);
  a.h = h;
  a.w = wd;
  a.c = c;
  a.k1s = static_cast<const float*>(k1s);
  a.b1s = static_cast<const float*>(b1s);
  a.lab = lab;
  a.k2s = static_cast<const float*>(k2s);
  a.b2s = static_cast<const float*>(b2s);
  a.nh = nh;
  a.kgb = static_cast<const float*>(kgb);
  a.bgb = static_cast<const float*>(bgb);
  a.kf = static_cast<const float*>(kf);
  a.bf = static_cast<const float*>(bf);
  a.ncls = kf != nullptr ? ncls : 0;
  a.out = static_cast<bf16*>(out);
  a.out_q = static_cast<signed char*>(out_q);
  a.q_inv = q_inv;
  a.seg_out = static_cast<bf16*>(seg);
  a.act_out = static_cast<bf16*>(act);
  const size_t smem = tail_smem_bytes(lab, nh, a.ncls);
  cudaError_t e = cudaFuncSetAttribute(
      spade_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((wd + TT - 1) / TT), (unsigned)((h + TT - 1) / TT),
                  (unsigned)n);
  spade_tail_kernel<<<grid, TAIL_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_spade_tail(const void* y, int n, int h, int wd, int c, const void* k1s,
                      const void* b1s, int lab, const void* k2s, const void* b2s,
                      int nh, const void* kgb, const void* bgb, const void* kf,
                      const void* bf, int ncls, void* out, void* seg, void* act,
                      void* stream) {
  return launch_spade_tail_q(y, n, h, wd, c, k1s, b1s, lab, k2s, b2s, nh, kgb, bgb, kf, bf,
                             ncls, out, nullptr, 0.f, seg, act, stream);
}

// Fill the sources of a conv or wgrad; returns the K they span, or -1.
int fill_sources(Src* src, int max_src, int& nsrc, const void* const* ptrs,
                 const int* chans, const int* ks) {
  nsrc = 0;
  int ksum = 0;
  for (int i = 0; i < max_src; ++i) {
    if (chans[i] <= 0) continue;
    if (ks[i] != 1 && ks[i] != 3) return -1;
    Src& s = src[nsrc++];
    s.ptr = static_cast<const bf16*>(ptrs[i]);
    s.c = chans[i];
    s.cpad = (chans[i] + BK - 1) / BK * BK;
    s.ksize = ks[i];
    s.vec = (chans[i] % 8 == 0) && ((uintptr_t)ptrs[i] % 16 == 0);
    ksum += s.cpad * ks[i] * ks[i];
  }
  return nsrc == 0 ? -1 : ksum;
}

}  // namespace
