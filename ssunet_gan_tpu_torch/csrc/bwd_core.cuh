// The conv and weight-gradient cores of the train kernels (train_bwd.cu),
// built for Hopper around the TPU kernels' structure (ssunet_gan_tpu/ops/
// train_bwd.py _make_fused_kernel :60, _make_wgrad_fused_kernel :291): a
// block owns a spatial tile of one image, brings the tile's (TH+2) x (TW+2)
// input window into shared memory with cp.async, applies the chain to each
// value of the window once, and reads the nine taps as nine shifted views of
// that window through ldmatrix, whose per-lane row addresses take any pixel
// shift.
//
//   conv3 (kernels 2 and 5): M = the 8 x 16 (16 x 16 for N tiles <= 16,
//     and <= 64 in the plain modes) output pixels of the tile, N = up to
//     256 output channels (NT), K = segments x chunks x (tap, 8-channel
//     group). Per K chunk (32 channels, or the whole 8/16 of a narrow
//     source) the window and, for a chain segment, the chain's second
//     tensor arrive through cp.async into a ring of window slots; the
//     weights stream in a 4-deep ring of 32-wide K slices (the chain modes:
//     two slots of 96, a row of three taps). The epilogue's bands come with
//     the last K stage (pre, modgrad).
//   wgrad (kernels 4 and 6): dW^T = x-taps^T . cot over the pixels: M = 9
//     taps x one input chunk (the (tap, group) pairs of the window), N = up
//     to 32 dW rows, K = the block's pixels, walked one 8 x 16 tile per
//     stage (a 3-deep ring of x windows and cotangent tiles). The cotangent
//     chain and the x-side prologue run once per value in shared memory;
//     narrow dW rows (3 labels, 4-16 hidden) sit on the MMA's 8-wide N side.
//
// Narrow sources pack taps x channels into K (or M): the k8 groups are
// (tap, 8-channel group) pairs, so 3 labels take 9 groups (80 K values with
// the padding to 16), not 9 x 32. mma.sync m16n8k16 bf16 with f32 sums;
// wgmma, as eval_conv.cuh runs it for the eval convs, is the next step
// here (ROADMAP.md 2b.6). Everything is in an anonymous
// namespace.

#pragma once

#include "conv_tile.cuh"
#include "train_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The chains (the v3 backward's prologues and cotangents)
// ---------------------------------------------------------------------------

enum ConvMode {
  CONV_STD = 0,      // round(acc [+ bias]); (sum, sum of squares) when asked
  CONV_MODGRAD = 1,  // K-segments [round(g*y) ; g]; where(band0 > 0, round(acc), 0); sum
  CONV_PRE = 2,      // gp = where(y > 0, g*(1+gamma) + round(acc)); 4 sums
  CONV_BN2 = 3,      // BN-backward prologue; where(f1*a + b > 0, round(acc), 0); 2 sums
  CONV_BN1 = 4,      // BN-backward prologue; round(round(acc3x3) + acc1x1), two outputs
  CONV_AFF = 5,      // prologue relu(x*a + b) (BN + ReLU), then as CONV_STD
};

// The plain modes: conv_stats's convs, and gamma and seg.
__host__ __device__ constexpr bool conv3_plain(int mode) {
  return mode == CONV_STD || mode == CONV_AFF;
}

template <int MODE>
__host__ __device__ constexpr int conv_stat_rows() {
  return conv3_plain(MODE) ? 2 : MODE == CONV_MODGRAD ? 1 : MODE == CONV_PRE ? 4
       : MODE == CONV_BN2 ? 2 : 0;
}

// How the weight gradient's cotangent rows are built.
enum GMode {
  G_RAW = 0,      // g as it is
  G_MODGRAD = 1,  // rows [0, c_g): round(g*g2); rows [c_g, 2c_g): g
  G_BN = 2,       // round(p*(g - q - (g2*r' - m'))), the BN-backward chain
};

// The prologues' per-channel constants (the BN chains', the affine's),
// staged per block: at most this many channels.
constexpr int CHAIN_MAX_C = 512;

// p*(g - q - (f*r' - m')) with the f32 roundings of the plain version.
__device__ __forceinline__ float bn_chain(float g, float f, float p, float q, float r,
                                          float m) {
  const float t = __fsub_rn(g, q);
  const float u = __fsub_rn(__fmul_rn(f, r), m);
  return __fmul_rn(p, __fsub_rn(t, u));
}

// Eight bf16 values (16 bytes of shared memory) as floats, and back.
__device__ __forceinline__ void sload8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void sstore8(bf16* p, const float* o) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                                            pack2(o[4], o[5]), pack2(o[6], o[7]));
}

// Channels ch0 and ch0 + 1 (ch0 even) of an output-aligned [m][cout] band at
// pixel m as floats, one 4-byte load when cout is even; 0 past cout.
__device__ __forceinline__ void band2(const bf16* b, long long m, int cout, int ch0, float* v) {
  const bf16* p = b + m * cout + ch0;
  if ((cout & 1) == 0) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __bfloat162float(p[0]);
    v[1] = ch0 + 1 < cout ? __bfloat162float(p[1]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Tile geometry shared by both cores (the chunk widths and the element-wise
// window loader are conv_tile.cuh's, shared with eval_conv.cuh)
// ---------------------------------------------------------------------------

constexpr int TH = 8;                       // tile rows
constexpr int TW = 16;                      // tile columns (one m16 / k16 fragment)
constexpr int WW = TW + 2;                  // window columns
constexpr int WPIX = (TH + 2) * WW;         // window pixels (180)
constexpr int TPIX = TH * TW;               // tile pixels (128)
constexpr int RING = 3;                     // cp.async stages in flight + 1
constexpr int FLUSH_ROWS = 4;               // wgrad: MMA steps per f32 accumulator flush
constexpr int KS = 32;                      // conv K per weight stage
constexpr int CORE_THREADS = 256;           // 8 warps

// Window row stride (halves) for a chunk of cc channels: consecutive pixels
// land on distinct 16-byte slots of a 128-byte line (conflict-free ldmatrix).
__host__ __device__ inline int win_stride(int cc) { return cc == 8 ? 8 : cc + 8; }

// (tap, 8-channel group) of k8 group q of a chunk with ngrp groups per tap;
// groups past the last real one read the centre tap's first group (finite
// values; their weights, or their dW rows, are zero or dropped).
__device__ __forceinline__ int group_offset(int q, int ngrp, int ksize, int wst) {
  const int taps = ksize == 3 ? 9 : 1;
  int tap = 4, grp = 0;
  if (q < taps * ngrp) {
    const int t = q / ngrp;
    grp = q - t * ngrp;
    tap = ksize == 3 ? t : 4;
  }
  return ((tap / 3) * WW + tap % 3) * wst + grp * 8;
}

// ---------------------------------------------------------------------------
// conv3: the backward-data conv with its chain (kernel 5)
// ---------------------------------------------------------------------------

// K stages: one row of three taps of a 32-channel chunk (96 K values) in
// the chain modes, 32 K values otherwise (a tap of a 32-channel chunk, or
// four (tap, 8-channel) groups of a narrow one). The weights (and the bn1
// shortcut's tile) stream through a ring of RING_NARROW slots, issued
// ring - 1 stages ahead; the chain modes' 96-wide stages through two (a
// third slot measured slower on the H100 for bn2 and bn1); a 3x3
// chunk's window (and its chain tensor's) through a ring deep enough that a
// chunk's window is issued after the chunk that last used its slot is done
// (conv3_wring).
constexpr int RING_NARROW = 4;
// Output tiles of 16 rows (256 pixels) for the narrow N tiles (up to
// TALL_NT: modgrad, seg), which halves the weight bytes per multiply-add;
// 8 rows for N tiles of 64 and more, where 256 pixels' accumulators cost a
// block of the SM's two (bn2 measured slower at 16 rows on the H100), and
// for "pre", whose epilogue stages four bands.
constexpr int TALL_NT = 16;
// The plain modes (conv_stats, gamma, seg) take 16-row tiles up to an N
// tile of 64: at 64 channels a 16 x 16 tile with 2 x 4 warps measured
// faster than an 8 x 16 one on the H100 (the flagship's level-0 convs),
// while 16-row tiles at 128 channels measured slower; a deeper weight ring
// and other warp layouts changed nothing.
constexpr int TALL_PLAIN_NT = 64;
constexpr int CC_WIDE = 32;                 // the chain modes' chunk (sources of planes)
constexpr int WST_WIDE = CC_WIDE + 8;
constexpr int KS_ROW = 3 * CC_WIDE;         // a chain mode's 3x3 stage

// The modes with a chain prologue read sources of `planes` channels, in
// chunks of 32; the others (narrow sources) take their chunk from c.
__host__ __device__ constexpr bool conv3_chain(int mode) {
  return mode == CONV_MODGRAD || mode == CONV_BN2 || mode == CONV_BN1;
}
__host__ __device__ constexpr int conv3_ring(int mode) {
  return conv3_chain(mode) ? 2 : RING_NARROW;
}
__host__ __device__ constexpr int conv3_ks(int mode) { return conv3_chain(mode) ? KS_ROW : KS; }
__host__ __device__ constexpr int conv3_th(int mode, int nt) {
  return mode != CONV_PRE && nt <= (conv3_plain(mode) ? TALL_PLAIN_NT : TALL_NT) ? 16 : 8;
}
__host__ __device__ constexpr int conv3_wpix(int mode, int nt) {
  return (conv3_th(mode, nt) + 2) * WW;
}
// The 8 warps of a block as WARPS_M (tile rows) x WARPS_N (output channels).
__host__ __device__ constexpr int conv3_warps_m(int mode, int nt) {
  return 8 / (nt < 64 ? 1 : conv3_th(mode, nt) == 16 ? 2 : 4);
}

struct Seg3 {
  const bf16* ptr;  // [m][c]
  int c;
  int ksize;        // 3, or 1 (the bn1 shortcut, read at the output pixels)
  int vec;          // 16-byte async copies allowed
  int nchunk;       // chunks of cc channels
  int spc;          // K stages per chunk (3 taps or 32 K values each)
};

struct Conv3Args {
  Seg3 seg[2];
  int nseg;
  int cc, wst;          // channels per chunk, window row stride (the chain modes: 32, 40)
  const bf16* wt;       // [cout][kp], segment, chunk, (tap, channel) padded to KS
  int kp;
  const float* bias;    // [cout] or null (CONV_STD)
  bf16* out;            // [m][cout] ([m][split] for BN1)
  float* partial;       // [rows][cout][gridDim.x] per-block sums, or null
  int n, h, w, cout;
  int tiles_w, tiles_h;
  const bf16* pro_f;    // [m][seg0.c]: y (MODGRAD), f (BN2, BN1) at the source pixel
  const float* cst[8];  // per-channel f32 constants (BN2, BN1: p, q, r', m' first)
  const bf16* band[4];  // [m][cout] output-aligned: actv | g, gamma, y, f2 | f1
  bf16* out1;           // BN1: channels >= split go here, [m][cout - split]
  int split;
  int k_round;          // BN1: K stages of the 3x3 segment; acc is rounded after them
  int bvec;             // 16-byte async copies of the bands allowed
};

// Window slots: a chunk of spc stages frees its slot spc stages after the
// one before it, and windows are issued ring - 1 stages ahead; every 3x3
// chunk has at least 3 stages.
__host__ __device__ constexpr int conv3_wring(int mode) {
  return 1 + (conv3_ring(mode) + 1) / 3;
}

// The output-aligned bands of a mode's epilogue, and whether they are
// staged in shared memory (brought with the last K stage's copies, so they
// arrive while the MMAs run): "pre" (four bands, N tile 64) and "modgrad"
// (one band, N tile <= 16).
__host__ __device__ constexpr int conv3_nbands(int mode) {
  return mode == CONV_PRE ? 4 : (mode == CONV_MODGRAD || mode == CONV_BN2) ? 1 : 0;
}
__host__ __device__ constexpr bool conv3_band_smem(int mode) {
  return mode == CONV_PRE || mode == CONV_MODGRAD;
}

// Dynamic shared memory of a conv3 launch (bytes): prologue constants
// (rows of c0 rounded up to 32), stat rows (one set per warp row), the
// window ring, the chain tensor's window ring, the bn1 shortcut's tile
// ring, the weight ring, the staged bands.
__host__ __device__ constexpr int conv3_cs_rows(int mode) {
  return (mode == CONV_BN2 || mode == CONV_BN1) ? 4 : mode == CONV_AFF ? 2 : 0;
}
__host__ __device__ inline int conv3_cs_floats(int mode, int c0) {
  return conv3_cs_rows(mode) * ((c0 + 31) / 32 * 32);
}

__host__ __device__ inline int conv3_smem(int mode, int nt, int ns, int c0, int cc, int wst) {
  const int wr = conv3_wring(mode), wpix = conv3_wpix(mode, nt), tpix = conv3_th(mode, nt) * TW;
  const int ring = conv3_ring(mode);
  return 4 * conv3_cs_floats(mode, c0) + 4 * conv3_warps_m(mode, nt) * ns * nt +
         2 * wr * wpix * wst +
         (conv3_chain(mode) ? 2 * wr * wpix * cc : 0) +
         (mode == CONV_BN1 ? 2 * ring * tpix * WST_WIDE : 0) +
         2 * ring * nt * (conv3_ks(mode) + 8) +
         (conv3_band_smem(mode) ? 2 * conv3_nbands(mode) * tpix * (nt + 8) : 0);
}

// A walk over the K stages: segment, chunk, stage within the chunk, the
// chunk's running index (its window slot) and the stage's first K column,
// advanced stage by stage.
struct StageCursor {
  int s, sg, chunk, j, gchunk;
  long long k;
};

template <int N>
struct Steps {
  static constexpr int value = N;
};

// A weight slice [NT][PIECES x 8] at K column k into a stage slot whose
// rows are STRIDE halves apart (the slot's widest stage + 8).
template <int NT, int PIECES, int STRIDE>
__device__ __forceinline__ void load_wslice(bf16* wd, const bf16* wt, long long kp, long long k,
                                            int n0, int cout) {
  for (int i = threadIdx.x; i < NT * PIECES; i += CORE_THREADS) {
    const int r = i / PIECES, piece = i - r * PIECES, n = n0 + r;
    const bool ok = n < cout;
    cp16(wd + r * STRIDE + piece * 8, ok ? wt + (long long)n * kp + k + piece * 8 : wt, ok);
  }
}

template <int MODE, int NT>
__device__ __forceinline__ void conv3_body(const Conv3Args& a) {
  constexpr int NS = conv_stat_rows<MODE>();
  constexpr bool BN_PRO = MODE == CONV_BN2 || MODE == CONV_BN1;
  constexpr bool CHAIN = BN_PRO || MODE == CONV_MODGRAD;
  constexpr bool AFF = MODE == CONV_AFF;  // a prologue without a chain tensor
  constexpr bool PLAIN = conv3_plain(MODE);  // round(acc [+ bias]); 2 sums
  constexpr int NCS = conv3_cs_rows(MODE);
  constexpr int THc = conv3_th(MODE, NT);
  constexpr int WPIXc = conv3_wpix(MODE, NT);
  constexpr int TPIXc = THc * TW;
  constexpr int WR = conv3_wring(MODE);
  constexpr int RW = conv3_ring(MODE);
  constexpr int KSW = conv3_ks(MODE);  // the widest stage
  constexpr int WSTGc = KSW + 8;
  constexpr int WARPS_M = conv3_warps_m(MODE, NT);
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int MI = THc / WARPS_M;  // tile rows per warp, one m16 fragment each
  constexpr int WN = NT / WARPS_N;
  constexpr int NI = WN / 8;
  static_assert(NI >= 1 && (NI == 1 || NI % 2 == 0), "n8 tiles per warp");
  constexpr int NB = conv3_nbands(MODE);
  constexpr bool BSM = conv3_band_smem(MODE);
  constexpr int BST = NT + 8;  // a staged band's row stride (halves)

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  // the chain modes' chunk geometry is fixed at compile time
  const int cc = CHAIN ? CC_WIDE : a.cc;
  const int wst = CHAIN ? WST_WIDE : a.wst;
  const int ngrp = cc / 8;
  const int c0ch = a.seg[0].c;
  float* cs = reinterpret_cast<float*>(bwd_smem);  // [NCS][csn]
  const int csn = NCS > 0 ? (c0ch + 31) / 32 * 32 : 0;
  float* red = cs + NCS * csn;                                // [WARPS_M][NS][NT]
  bf16* win = reinterpret_cast<bf16*>(red + WARPS_M * NS * NT);  // [WR][WPIXc][wst]
  bf16* pro = win + WR * WPIXc * wst;                       // [WR][WPIXc][cc]
  bf16* sct = pro + (CHAIN ? WR * WPIXc * cc : 0);          // [RW][TPIXc][WST_WIDE]
  bf16* wts = sct + (MODE == CONV_BN1 ? RW * TPIXc * WST_WIDE : 0);  // [RW][NT][WSTGc]
  bf16* bnd = wts + RW * NT * WSTGc;                        // [NB][TPIXc][BST] (BSM)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int H = a.h, W = a.w;
  const int tw_i = blockIdx.x % a.tiles_w;
  const int rest = blockIdx.x / a.tiles_w;
  const int th_i = rest % a.tiles_h;
  const long long img_base = (long long)(rest / a.tiles_h) * H * W;
  const int oh0 = th_i * THc, ow0 = tw_i * TW;
  const int n0 = blockIdx.y * NT;

  if constexpr (NCS > 0) {
    for (int i = tid; i < NCS * csn; i += CORE_THREADS) {
      const int k = i / csn, c = i - k * csn;
      cs[i] = c < c0ch ? a.cst[k][c] : 0.f;
    }
  }

  const int nstage = a.seg[0].nchunk * a.seg[0].spc +
                     (a.nseg > 1 ? a.seg[1].nchunk * a.seg[1].spc : 0);
  // the K width of stage u: a row of taps for a chain mode's 3x3 chunk
  auto stage_k = [&](const StageCursor& u) {
    return (CHAIN && !(MODE == CONV_BN1 && u.sg == 1)) ? KS_ROW : KS;
  };
  auto advance = [&](StageCursor& u) {
    u.k += stage_k(u);
    ++u.s;
    if (++u.j == (u.sg ? a.seg[1].spc : a.seg[0].spc)) {
      u.j = 0;
      ++u.gchunk;
      if (++u.chunk == a.seg[0].nchunk && u.sg == 0) {
        u.chunk = 0;
        u.sg = 1;
      }
    }
  };

  // loads of stage u: its weight slice; at a chunk's first stage, the
  // chunk's window (3x3) or, for the 1x1 shortcut, its tile at the output
  // pixels (one stage per chunk)
  auto issue = [&](const StageCursor& u) {
    if (u.s < nstage) {
      bf16* wd = wts + (u.s % RW) * NT * WSTGc;
      if (stage_k(u) == KS_ROW)
        load_wslice<NT, KS_ROW / 8, WSTGc>(wd, a.wt, a.kp, u.k, n0, a.cout);
      else
        load_wslice<NT, KS / 8, WSTGc>(wd, a.wt, a.kp, u.k, n0, a.cout);
      const bf16* ptr = u.sg ? a.seg[1].ptr : a.seg[0].ptr;
      const int c = u.sg ? a.seg[1].c : a.seg[0].c;
      const int vec = u.sg ? a.seg[1].vec : a.seg[0].vec;
      const int cb = u.chunk * cc;
      if (MODE == CONV_BN1 && u.sg == 1) {
        bf16* sd = sct + (u.s % RW) * TPIXc * WST_WIDE;
        for (int i = tid; i < TPIXc * (CC_WIDE / 8); i += CORE_THREADS) {
          const int px = i >> 2, piece = i & 3;
          const int oh = oh0 + px / TW, ow = ow0 + px % TW;
          const int c0 = cb + piece * 8;
          const long long pix = img_base + (long long)oh * W + ow;
          const bool in = oh < H && ow < W;
          if (vec) {
            const bool ok = in && c0 < c;
            cp16(sd + px * WST_WIDE + piece * 8, ok ? ptr + pix * c + c0 : ptr, ok);
          } else {
            scalar8(sd + px * WST_WIDE + piece * 8, ptr, c, pix, c0, in);
          }
        }
      } else if (u.j == 0) {
        const bool ch = CHAIN && u.sg == 0;
        bf16* wb = win + (u.gchunk % WR) * WPIXc * wst;
        bf16* pb = pro + (u.gchunk % WR) * WPIXc * cc;
        for (int i = tid; i < WPIXc * ngrp; i += CORE_THREADS) {
          const int px = i / ngrp, piece = i - px * ngrp;
          const int wr = px / WW, wc = px - wr * WW;
          const int ih = oh0 - 1 + wr, iw = ow0 - 1 + wc;
          const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
          const int c0 = cb + piece * 8;
          const long long pix = img_base + (long long)ih * W + iw;
          if (vec) {
            const bool ok = in && c0 < c;
            cp16(wb + px * wst + piece * 8, ok ? ptr + pix * c + c0 : ptr, ok);
            if (ch)
              cp16(pb + px * cc + piece * 8, ok ? a.pro_f + pix * c + c0 : a.pro_f, ok);
          } else {
            scalar8(wb + px * wst + piece * 8, ptr, c, pix, c0, in);
            if (ch) scalar8(pb + px * cc + piece * 8, a.pro_f, c, pix, c0, in);
          }
        }
      }
      if (BSM && u.s == nstage - 1) {
        // the epilogue's bands at the tile's pixels, channels n0..n0+NT
        for (int i = tid; i < NB * TPIXc * (NT / 8); i += CORE_THREADS) {
          const int k = i / (TPIXc * (NT / 8)), r = i - k * (TPIXc * (NT / 8));
          const int px = r / (NT / 8), piece = r - px * (NT / 8);
          const int oh = oh0 + px / TW, ow = ow0 + px % TW;
          const bool in = oh < H && ow < W;
          const int c0 = n0 + piece * 8;
          const long long pix = img_base + (long long)oh * W + ow;
          bf16* d = bnd + (k * TPIXc + px) * BST + piece * 8;
          if (a.bvec) {
            const bool ok = in && c0 < a.cout;
            cp16(d, ok ? a.band[k] + pix * a.cout + c0 : a.band[k], ok);
          } else {
            scalar8(d, a.band[k], a.cout, pix, c0, in);
          }
        }
      }
    }
    cp_commit();  // an empty group past the end keeps the wait counts uniform
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // per-lane rows of the fragments: A pixel (lane & 7) + 8 * ((lane >> 3) & 1)
  // of each of the warp's tile rows, k8 group lane >> 4 of a k16 step; B row
  const int a_col = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int hi = lane >> 4;
  const int b_row = wn * WN + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;

  StageCursor cur = {0, 0, 0, 0, 0, 0}, ahead = cur;
  for (int i = 0; i < RW - 1; ++i) {
    issue(ahead);
    advance(ahead);
  }
  for (; cur.s < nstage; advance(cur)) {
    cp_wait<RW - 2>();
    __syncthreads();
    issue(ahead);
    advance(ahead);
    bf16* wb = win + (cur.gchunk % WR) * WPIXc * wst;
    const bool one = MODE == CONV_BN1 && cur.sg == 1;
    if constexpr (CHAIN || AFF) {
      if (cur.j == 0 && cur.sg == 0) {
        // the chain (the affine), once per window value; outside the image
        // the window keeps its 0 (a zero-padded conv input), as do channels
        // past c (their constants are 0)
        const bf16* pb = pro + (cur.gchunk % WR) * WPIXc * cc;
        const int cb = cur.chunk * cc;
        for (int i = tid; i < WPIXc * ngrp; i += CORE_THREADS) {
          const int px = i / ngrp, piece = i - px * ngrp;
          const int wr = px / WW, wc = px - wr * WW;
          const int ih = oh0 - 1 + wr, iw = ow0 - 1 + wc;
          const int c0 = cb + piece * 8;
          if (ih < 0 || ih >= H || iw < 0 || iw >= W || c0 >= c0ch) continue;
          float g[8], f[8], o[8];
          sload8(wb + px * wst + piece * 8, g);
          if constexpr (CHAIN) sload8(pb + px * cc + piece * 8, f);
          if constexpr (AFF) {  // relu(x*a + b), each operation rounded
#pragma unroll
            for (int h4 = 0; h4 < 8; h4 += 4) {
              const float4 pa = *reinterpret_cast<const float4*>(cs + c0 + h4);
              const float4 pb4 = *reinterpret_cast<const float4*>(cs + csn + c0 + h4);
              o[h4] = relu(__fadd_rn(__fmul_rn(g[h4], pa.x), pb4.x));
              o[h4 + 1] = relu(__fadd_rn(__fmul_rn(g[h4 + 1], pa.y), pb4.y));
              o[h4 + 2] = relu(__fadd_rn(__fmul_rn(g[h4 + 2], pa.z), pb4.z));
              o[h4 + 3] = relu(__fadd_rn(__fmul_rn(g[h4 + 3], pa.w), pb4.w));
            }
          } else if constexpr (MODE == CONV_MODGRAD) {
#pragma unroll
            for (int q = 0; q < 8; ++q) o[q] = __fmul_rn(g[q], f[q]);
          } else {
#pragma unroll
            for (int h4 = 0; h4 < 8; h4 += 4) {
              const float4 p = *reinterpret_cast<const float4*>(cs + c0 + h4);
              const float4 q = *reinterpret_cast<const float4*>(cs + csn + c0 + h4);
              const float4 r = *reinterpret_cast<const float4*>(cs + 2 * csn + c0 + h4);
              const float4 m = *reinterpret_cast<const float4*>(cs + 3 * csn + c0 + h4);
              o[h4] = bn_chain(g[h4], f[h4], p.x, q.x, r.x, m.x);
              o[h4 + 1] = bn_chain(g[h4 + 1], f[h4 + 1], p.y, q.y, r.y, m.y);
              o[h4 + 2] = bn_chain(g[h4 + 2], f[h4 + 2], p.z, q.z, r.z, m.z);
              o[h4 + 3] = bn_chain(g[h4 + 3], f[h4 + 3], p.w, q.w, r.w, m.w);
            }
          }
          sstore8(wb + px * wst + piece * 8, o);
        }
        __syncthreads();
      }
    }
    // the stage's MMAs: KST k16 steps, A rows at abase + tile row * astride
    // + off[kk] (this lane's (tap, group) or shortcut channel group)
    const bf16* wtb = wts + (cur.s % RW) * NT * WSTGc;
    auto mma_steps = [&](auto steps, const bf16* abase, int astride, const int* off) {
      constexpr int KST = decltype(steps)::value;
#pragma unroll
      for (int kk = 0; kk < KST; ++kk) {
        uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4<false>(af[mi], abase + (wm * MI + mi) * astride + off[kk]);
        if constexpr (NI == 1) {
          ldsm_x2<false>(bfr[0], wtb + b_row * WSTGc + kk * 16 + b_k);
        } else {
#pragma unroll
          for (int nj = 0; nj < NI; nj += 2) {
            uint32_t r[4];
            ldsm_x4<false>(r, wtb + (b_row + nj * 8) * WSTGc + kk * 16 + b_k);
            bfr[nj][0] = r[0];
            bfr[nj][1] = r[1];
            bfr[nj + 1][0] = r[2];
            bfr[nj + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
      }
    };
    int off[KS_ROW / 16];
    if (one) {
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) off[kk] = (2 * kk + hi) * 8;
      mma_steps(Steps<KS / 16>{}, sct + (cur.s % RW) * TPIXc * WST_WIDE + a_col * WST_WIDE,
                TW * WST_WIDE, off);
    } else if constexpr (CHAIN) {
      // stage j is tap row j of a 32-channel chunk: k16 step kk is tap
      // (j, kk / 2), channel groups 2 (kk % 2) and 2 (kk % 2) + 1
#pragma unroll
      for (int kk = 0; kk < KS_ROW / 16; ++kk)
        off[kk] = (cur.j * WW + kk / 2) * WST_WIDE + (2 * (kk & 1) + hi) * 8;
      mma_steps(Steps<KS_ROW / 16>{}, wb + a_col * WST_WIDE, WW * WST_WIDE, off);
    } else {
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        off[kk] = group_offset(cur.j * 4 + kk * 2 + hi, ngrp, 3, wst);
      mma_steps(Steps<KS / 16>{}, wb + a_col * wst, WW * wst, off);
    }
    if constexpr (MODE == CONV_BN1) {
      // the 3x3 sum is rounded before the 1x1 shortcut segment adds to it
      if (cur.s == a.k_round - 1) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = bf16r(acc[mi][ni][e]);
      }
    }
  }
  cp_wait<0>();

  // ---- epilogue: per output element, the mode's mask / BN terms from the
  // bands and constants at the output pixel; stat rows summed per block
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int cl = wn * WN + ni * 8 + 2 * t;  // this thread's first column in the block
    const int ch0 = n0 + cl;
    float k0[2] = {0.f, 0.f}, k1[2] = {0.f, 0.f}, k2[2] = {0.f, 0.f}, k3[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (ch0 + e >= a.cout) continue;
      if (PLAIN) {
        if (a.bias != nullptr) k0[e] = a.bias[ch0 + e];
      } else if (MODE == CONV_PRE) {  // r2, mean2 * r2
        k0[e] = a.cst[0][ch0 + e];
        k1[e] = a.cst[1][ch0 + e];
      } else if (MODE == CONV_BN2) {  // a1, b1, r1, mean1 * r1
        k0[e] = a.cst[4][ch0 + e];
        k1[e] = a.cst[5][ch0 + e];
        k2[e] = a.cst[6][ch0 + e];
        k3[e] = a.cst[7][ch0 + e];
      }
    }
    float st[NS > 0 ? NS : 1][2];
#pragma unroll
    for (int r = 0; r < NS; ++r) st[r][0] = st[r][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int oh = oh0 + wm * MI + mi, ow = ow0 + g + 8 * half;
        if (oh >= H || ow >= W || ch0 >= a.cout) continue;
        const long long m = img_base + (long long)oh * W + ow;
        float bv[NB > 0 ? NB : 1][2];
        if constexpr (BSM) {
          // staged by the last K stage's copies (visible past its barrier)
          const int px = (wm * MI + mi) * TW + g + 8 * half;
#pragma unroll
          for (int k = 0; k < NB; ++k) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bnd + (k * TPIXc + px) * BST + cl));
            bv[k][0] = f.x;
            bv[k][1] = f.y;
          }
        } else {
#pragma unroll
          for (int k = 0; k < NB; ++k) band2(a.band[k], m, a.cout, ch0, bv[k]);
        }
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[e] = 0.f;
          if (ch0 + e >= a.cout) continue;
          const float v = acc[mi][ni][2 * half + e];
          if constexpr (PLAIN) {
            o[e] = bf16r(v + k0[e]);
            st[0][e] += o[e];
            st[1][e] += o[e] * o[e];
          } else if constexpr (MODE == CONV_MODGRAD) {
            o[e] = bv[0][e] > 0.f ? bf16r(v) : 0.f;
            st[0][e] += o[e];
          } else if constexpr (MODE == CONV_PRE) {
            const float gf = bv[0][e], gm = bv[1][e], yf = bv[2][e], f2 = bv[3][e];
            const float gy = __fadd_rn(__fmul_rn(gf, __fadd_rn(1.f, gm)), bf16r(v));
            const float gp = yf > 0.f ? gy : 0.f;
            const float xh = __fsub_rn(__fmul_rn(f2, k0[e]), k1[e]);
            o[e] = bf16r(gp);
            st[0][e] += gp;
            st[1][e] += gp * xh;
            st[2][e] += gf * yf;
            st[3][e] += gf;
          } else if constexpr (MODE == CONV_BN2) {
            const float f1 = bv[0][e];
            const float pre = __fadd_rn(__fmul_rn(f1, k0[e]), k1[e]);
            const float xh = __fsub_rn(__fmul_rn(f1, k2[e]), k3[e]);
            o[e] = pre > 0.f ? bf16r(v) : 0.f;
            st[0][e] += o[e];
            st[1][e] += o[e] * xh;
          } else {  // CONV_BN1: acc = round(3x3 sum) + the 1x1 shortcut's
            o[e] = bf16r(v);
          }
        }
        if constexpr (MODE == CONV_BN1) {
          if (((a.split | a.cout) & 1) == 0) {
            // even widths: ch0 (even) and ch0 + 1 lie in one part
            bf16* op = ch0 < a.split ? a.out + m * a.split + ch0
                                     : a.out1 + m * (a.cout - a.split) + ch0 - a.split;
            *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(o[0], o[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = ch0 + e;
              if (c >= a.cout) continue;
              if (c < a.split)
                a.out[m * a.split + c] = __float2bfloat16_rn(o[e]);
              else
                a.out1[m * (a.cout - a.split) + c - a.split] = __float2bfloat16_rn(o[e]);
            }
          }
        } else {
          bf16* op = a.out + m * a.cout + ch0;
          if ((a.cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(o[0], o[1]);
          } else {
            op[0] = __float2bfloat16_rn(o[0]);
            if (ch0 + 1 < a.cout) op[1] = __float2bfloat16_rn(o[1]);
          }
        }
      }
    }
    if constexpr (NS > 0) {
      // over the 8 row groups of the warp; each warp row's sums get their
      // own slots, added in a fixed order below (the batch statistics come
      // out the same from run to run)
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
          for (int e = 0; e < 2; ++e) red[(wm * NS + r) * NT + cl + e] = st[r][e];
      }
    }
  }
  if constexpr (NS > 0) {
    if (a.partial == nullptr) return;  // uniform across the block
    __syncthreads();
    const long long nb = gridDim.x;
    for (int i = tid; i < NS * NT; i += CORE_THREADS) {
      const int r = i / NT, c = i - r * NT;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS_M; ++w) v += red[w * NS * NT + i];
      if (n0 + c < a.cout) a.partial[((long long)r * a.cout + n0 + c) * nb + blockIdx.x] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: the weight gradient with the rebuilt cotangent (kernel 6)
// ---------------------------------------------------------------------------

struct Wg3Args {
  const bf16* x[2];     // the input parts, [m][xc]
  int xc[2];
  int xvec[2];
  int xoff[2];          // a part's first channel in dW's input channels
  int nchunk[2];        // chunks of cc channels per part
  int cc, wst;          // channels per chunk (shared by the parts), window row stride
  const float* pro_a;   // [xc[0]] prologue relu(x*a + b) on the single part, or null
  const float* pro_b;
  const bf16* g;        // [m][c_g]
  const bf16* g2;       // [m][c_g]: y (G_MODGRAD) or f (G_BN)
  const float* cst[4];  // G_BN: p, q, r', m'
  int c_g;
  int gvec;             // 16-byte async copies of g and g2 allowed
  int cout, cin;        // dW rows; input channels summed over the parts
  double* dw;           // [cout][cin][3][3], summed into with f64 atomics
  int n, h, w, tiles_w, tiles_h;
  int ntiles, tiles_per_split;
};

__host__ __device__ inline int wg3_gstride(int nt) { return nt == 8 ? 8 : nt + 8; }

__host__ __device__ inline int wg3_smem(int nt, int wst) {
  return 4 * 4 * nt + 2 * RING * WPIX * wst + 2 * RING * TPIX * wg3_gstride(nt) +
         2 * RING * TPIX * nt;
}

template <int GM, int NT>
__device__ __forceinline__ void wgrad3_body(const Wg3Args& a) {
  constexpr int WARPS_N = NT == 32 ? 2 : 1;
  constexpr int WARPS_M = 8 / WARPS_N;
  constexpr int MT_MAX = 18;                                  // m16 tiles of 9 x 32
  constexpr int MI = (MT_MAX + WARPS_M - 1) / WARPS_M;        // per warp, at most
  constexpr int WN = NT / WARPS_N;
  constexpr int NI = WN / 8;
  constexpr int GST = NT == 8 ? 8 : NT + 8;
  static_assert(NI == 1 || NI == 2, "n8 tiles per warp");

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int cc = a.cc, wst = a.wst;
  float* cs = reinterpret_cast<float*>(bwd_smem);                // [4][NT]
  bf16* xw = reinterpret_cast<bf16*>(cs + 4 * NT);           // [RING][WPIX][wst]
  bf16* gt = xw + RING * WPIX * wst;                          // [RING][TPIX][GST]
  bf16* g2t = gt + RING * TPIX * GST;                         // [RING][TPIX][NT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int H = a.h, W = a.w;
  const int r0 = blockIdx.y * NT;
  // this block's input chunk: (part, chunk)
  const int part = (int)blockIdx.x >= a.nchunk[0];
  const int chunk = part ? blockIdx.x - a.nchunk[0] : blockIdx.x;
  const bf16* xp = part ? a.x[1] : a.x[0];
  const int xc = part ? a.xc[1] : a.xc[0];
  const int xvec = part ? a.xvec[1] : a.xvec[0];
  const int xoff = part ? a.xoff[1] : a.xoff[0];
  const float* pa = part ? nullptr : a.pro_a;
  const float* pb = a.pro_b;
  const int cb = chunk * cc;
  const int ngrp = cc / 8;
  const int ngroups = 9 * ngrp;
  const int mt = (ngroups + 1) / 2;
  const int t_begin = blockIdx.z * a.tiles_per_split;
  int t_end = t_begin + a.tiles_per_split;
  if (t_end > a.ntiles) t_end = a.ntiles;
  const int nstage = t_end - t_begin;
  if (nstage <= 0) return;
  const int C = a.c_g;

  if constexpr (GM == G_BN) {
    for (int i = tid; i < 4 * NT; i += CORE_THREADS) {
      const int k = i / NT, r = r0 + i - k * NT;
      cs[i] = r < a.cout ? a.cst[k][r] : 0.f;
    }
  }

  // tile index -> (image base, first row, first column)
  auto tile_at = [&](int T, long long& img_base, int& oh0, int& ow0) {
    const int tw_i = T % a.tiles_w;
    const int rest = T / a.tiles_w;
    const int th_i = rest % a.tiles_h;
    img_base = (long long)(rest / a.tiles_h) * H * W;
    oh0 = th_i * TH;
    ow0 = tw_i * TW;
  };

  // the g-side source columns of dW rows row..row+7 (G_MODGRAD: the second
  // half reads g again, without g2)
  auto issue = [&](int s) {
    if (s < nstage) {
      long long img_base;
      int oh0, ow0;
      tile_at(t_begin + s, img_base, oh0, ow0);
      const int buf = s % RING;
      // x window (the chunk's channels), zeros outside the image
      bf16* wb = xw + buf * WPIX * wst;
      for (int i = tid; i < WPIX * ngrp; i += CORE_THREADS) {
        const int px = i / ngrp, piece = i - px * ngrp;
        const int wr = px / WW, wc = px - wr * WW;
        const int ih = oh0 - 1 + wr, iw = ow0 - 1 + wc;
        const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
        const int c0 = cb + piece * 8;
        const long long pix = img_base + (long long)ih * W + iw;
        if (xvec) {
          const bool ok = in && c0 < xc;
          cp16(wb + px * wst + piece * 8, ok ? xp + pix * xc + c0 : xp, ok);
        } else {
          scalar8(wb + px * wst + piece * 8, xp, xc, pix, c0, in);
        }
      }
      // cotangent sources at the tile's pixels, rows r0..r0+NT
      bf16* gb = gt + buf * TPIX * GST;
      bf16* g2b = g2t + buf * TPIX * NT;
      for (int i = tid; i < TPIX * (NT / 8); i += CORE_THREADS) {
        const int px = i / (NT / 8), piece = i - px * (NT / 8);
        const int oh = oh0 + px / TW, ow = ow0 + px % TW;
        const bool in = oh < H && ow < W;
        const long long pix = img_base + (long long)oh * W + ow;
        const int row = r0 + piece * 8;
        int col = row;       // g's column of this row
        bool two = GM != G_RAW;  // g2 read at the same column
        if (GM == G_MODGRAD && row >= C) {
          col = row - C;
          two = false;
        }
        const bool ok = in && row < a.cout;
        if (a.gvec) {
          cp16(gb + px * GST + piece * 8, ok ? a.g + pix * C + col : a.g, ok);
          if (GM != G_RAW)
            cp16(g2b + px * NT + piece * 8, (ok && two) ? a.g2 + pix * C + col : a.g2,
                 ok && two);
        } else if (GM == G_MODGRAD) {
          // rows may straddle C: element by element
          unsigned short e[8], e2[8];
          const unsigned short* gs = reinterpret_cast<const unsigned short*>(a.g);
          const unsigned short* ys = reinterpret_cast<const unsigned short*>(a.g2);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int rq = row + q;
            const bool v = in && rq < a.cout;
            e[q] = v ? gs[pix * C + (rq < C ? rq : rq - C)] : 0;
            e2[q] = (v && rq < C) ? ys[pix * C + rq] : 0;
          }
          *reinterpret_cast<uint4*>(gb + px * GST + piece * 8) =
              make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                         e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
          *reinterpret_cast<uint4*>(g2b + px * NT + piece * 8) =
              make_uint4(e2[0] | ((uint32_t)e2[1] << 16), e2[2] | ((uint32_t)e2[3] << 16),
                         e2[4] | ((uint32_t)e2[5] << 16), e2[6] | ((uint32_t)e2[7] << 16));
        } else {
          scalar8(gb + px * GST + piece * 8, a.g, C, pix, col, in && row < a.cout);
          if (GM != G_RAW)
            scalar8(g2b + px * NT + piece * 8, a.g2, C, pix, col, in && row < a.cout);
        }
      }
    }
    cp_commit();
  };

  float acc[MI][NI][4], sum[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ni][e] = sum[i][ni][e] = 0.f;

  // per-lane rows of the fragments: A (x taps, transposed) pixel column and
  // group; B (cotangent, transposed) pixel and n8 tile
  const int a_px = (lane & 7) + ((lane >> 4) << 3);
  const int a_grp = (lane >> 3) & 1;
  const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = wn * WN + ((lane >> 4) << 3);
  int a_off[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int tile = wm + i * WARPS_M;
    a_off[i] = group_offset(2 * tile + a_grp, ngrp, 3, wst) + a_px * wst;
  }

  issue(0);
  issue(1);
  for (int s = 0; s < nstage; ++s) {
    cp_wait<RING - 2>();
    __syncthreads();
    issue(s + RING - 1);
    const int buf = s % RING;
    bf16* wb = xw + buf * WPIX * wst;
    bf16* gb = gt + buf * TPIX * GST;
    if (pa != nullptr || GM != G_RAW) {
      long long img_base;
      int oh0, ow0;
      tile_at(t_begin + s, img_base, oh0, ow0);
      if (pa != nullptr) {
        // the x-side prologue relu(x*a + b), once per window value; outside
        // the image the window keeps its 0
        for (int i = tid; i < WPIX * ngrp; i += CORE_THREADS) {
          const int px = i / ngrp, piece = i - px * ngrp;
          const int wr = px / WW, wc = px - wr * WW;
          const int ih = oh0 - 1 + wr, iw = ow0 - 1 + wc;
          const int c0 = cb + piece * 8;
          if (ih < 0 || ih >= H || iw < 0 || iw >= W || c0 >= xc) continue;
          float f[8];
          sload8(wb + px * wst + piece * 8, f);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = c0 + q;
            f[q] = c < xc ? relu(__fadd_rn(__fmul_rn(f[q], pa[c]), pb[c])) : 0.f;
          }
          sstore8(wb + px * wst + piece * 8, f);
        }
      }
      if constexpr (GM != G_RAW) {
        // the cotangent chain, once per value; 0 outside the image
        const bf16* g2b = g2t + buf * TPIX * NT;
        for (int i = tid; i < TPIX * (NT / 8); i += CORE_THREADS) {
          const int px = i / (NT / 8), piece = i - px * (NT / 8);
          const int oh = oh0 + px / TW, ow = ow0 + px % TW;
          const int rl = piece * 8;
          float gv[8], fv[8], o[8];
          sload8(gb + px * GST + rl, gv);
          sload8(g2b + px * NT + rl, fv);
          const bool in = oh < H && ow < W;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int row = r0 + rl + q;
            if (!in || row >= a.cout) {
              o[q] = 0.f;
            } else if (GM == G_MODGRAD) {
              o[q] = row < C ? __fmul_rn(gv[q], fv[q]) : gv[q];
            } else {
              o[q] = bn_chain(gv[q], fv[q], cs[rl + q], cs[NT + rl + q],
                              cs[2 * NT + rl + q], cs[3 * NT + rl + q]);
            }
          }
          sstore8(gb + px * GST + rl, o);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < TH; ++r) {  // one k16 step per tile row
      uint32_t bfr[NI][2];
      if constexpr (NI == 1) {
        ldsm_x2<true>(bfr[0], gb + (r * TW + b_px) * GST + wn * WN);
      } else {
        uint32_t q4[4];
        ldsm_x4<true>(q4, gb + (r * TW + b_px) * GST + b_col);
        bfr[0][0] = q4[0];
        bfr[0][1] = q4[1];
        bfr[1][0] = q4[2];
        bfr[1][1] = q4[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (wm + i * WARPS_M >= mt) continue;  // uniform across the warp
        uint32_t af[4];
        ldsm_x4<true>(af, wb + r * WW * wst + a_off[i]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[i][ni], af, bfr[ni]);
      }
      // the tensor cores' f32 sums truncate: move them into round-to-nearest
      // f32 sums every FLUSH_ROWS MMA steps (the error of a cancelling
      // gradient grows with the steps between flushes)
      if (r % FLUSH_ROWS == FLUSH_ROWS - 1) {
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
    }
  }
  cp_wait<0>();

  // dW[row][ch][tap]: M rows of a tile are (tap, channel) pairs, N the dW rows
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int tile = wm + i * WARPS_M;
    if (tile >= mt) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int grp_i = 2 * tile + hh;
      if (grp_i >= ngroups) continue;
      const int tap = grp_i / ngrp;
      const int ch = cb + (grp_i - tap * ngrp) * 8 + g;
      if (ch >= xc) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + wn * WN + ni * 8 + 2 * t + e;
          if (row < a.cout)
            atomicAdd(a.dw + ((long long)row * a.cin + xoff + ch) * 9 + tap,
                      (double)sum[i][ni][2 * hh + e]);
        }
    }
  }
}

}  // namespace
