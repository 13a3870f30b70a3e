// The f32 weight gradient on Hopper (sm_90a): kernels 4 and 6 in float32,
// the dtype of the TPU kernels that take the activation dtype, so a model
// trained in f32 (mixed_precision "False") runs them as the JAX package's
// Pallas kernels do there:
//
//   kernel 4  wgrad        <- ssunet_gan_tpu/ops/stage_kernel_train.py
//             _wgrad_w (:766): dW of a 3x3 conv, the cotangent as it is
//             (the v2 backward; WG_RAW below).
//   kernel 6  fused_wgrad  <- ssunet_gan_tpu/ops/train_bwd.py
//             fused_wgrad_call (:374): dW with the x side optionally
//             relu(x*a + b) and the cotangent as it is, [g*y ; g]
//             (WG_MODGRAD) or the BN-backward chain (WG_BN).
//
// dW^T[(tap, c)][o] = sum over the N*H*W pixels p of x[p + tap][c] *
// cot[p][o]: a GEMM with M = 9 taps x the input channels, N = the dW rows,
// K = the pixels. What bounds it on the H100: its multiply-adds (hundreds per
// byte at 64-640 channels), which in f32 the tensor cores take in TF32 only.
// So the products run as 3xTF32 (each f32 operand split into big = tf32(v)
// and small = tf32(v - big); small*big + big*small + big*big), at most
// 495 / 3 = 165 TFLOP/s against the CUDA cores' 67.
//
// Two launches per call, so that no value is rebuilt:
//
//   wgrad_prep_kernel  the cotangent's chain and split, once per value: g
//     (and y or f with the per-row constants) -> the planes big and small,
//     laid out as the product reads them: per pixel tile (WG_TH x WG_TW) and
//     N block of nb dW rows, [big | small][nb / 8][WG_TP / 4][8 rows][4
//     pixels], pixels contiguous per dW row (K-major: for 32-bit types wgmma
//     takes B from shared memory K-major only) in the core matrices of a
//     descriptor without swizzle, so one tile's B operand is one contiguous
//     bulk copy; pixels of a tile outside the image and rows past cout are 0.
//     With conv2's prologue the same launch also writes relu(x*a + b), the
//     product's input (in the product, each warpgroup would stall on it).
//     Memory-bound: it reads g [and y or f] and writes 8 bytes per value.
//
//   wgrad_f32_kernel<NB, MT>  the product on wgmma m64nNBk8 tf32: three
//     warpgroups; a block owns one input chunk of cc channels (the rows
//     (tap, c) of the chunk, a row block of 3 * MT m64 tiles), an N block of
//     NB dW rows and a run of pixel tiles. A (the x taps) comes from
//     registers: shifted reads of the tile's halo window in shared memory,
//     split into big and small as they are loaded (integer rounding, at the
//     full issue rate); B (the planes) arrives by one bulk copy per tile.
//     Both through a ring of WG_RING slots on full / empty mbarriers, so the
//     next tiles' loads run under the products and the warpgroups run up to
//     a tile apart (one's products while another waits). MT = 1: a row block
//     is one tap row (3 taps x 64 channels), wide N (64: the A registers feed
//     twice the columns of N = 32 over nine taps, which the card ran slower);
//     MT = 3: all nine taps of the chunk, narrow N (8-32). A chunk whose rows
//     fill one m64 tile (cc <= 7) has the three warpgroups split its k8 steps.
//
// Numerics: the tensor cores add each k8 step's products into the f32
// accumulator without rounding to nearest (f32_conv.cuh says why that
// matters), so each group of k8 steps (wg_group) runs in a fresh accumulator
// (the group's first wgmma with scale-d 0) that is added into round-to-
// nearest f32 sums after wgmma.wait_group; the blocks' sums go into dW (f64)
// by atomics. The chains round each operation in f32 (no fused
// multiply-add), as the plain versions (ops/train_bwd.py _cotangent,
// ops/stage_kernel_train.py _prologued) compute them. A non-finite input
// gives a non-finite dW (an inf may come out as NaN).
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launches. The launch plan (chunk width, N block, row
// blocks, tiles and pixel splits) comes from ops/train_f32.py wgrad_plan.

#include "f32_conv.cuh"
#include "wgmma.cuh"

namespace {

enum WgMode {
  WG_RAW = 0,      // the cotangent g as it is
  WG_MODGRAD = 1,  // rows [0, c_g): g*g2; rows [c_g, 2 c_g): g
  WG_BN = 2,       // p*(g - q - (g2*r' - m')), the BN-backward chain
};

constexpr int WG_THREADS = 384;       // three warpgroups
constexpr int WG_TH = 4, WG_TW = 16;  // the pixel tile: K = 64 pixels a stage
constexpr int WG_TP = WG_TH * WG_TW;
constexpr int WG_WW = WG_TW + 2;      // window columns
constexpr int WG_WR = WG_TH + 2;      // window rows, at most
constexpr int WG_KSTEPS = WG_TP / 8;  // k8 steps a stage: tile row k / 2, half k % 2
constexpr int WG_RING = 4;            // three tiles' loads in flight
constexpr int WG_XS_MAX = 72;         // window row stride (floats) at 64 channels
// a slot's window: window rows x row stride floats, at most; NB = 64 takes
// either one tap row of 64 channels (4 rows x 72) or all nine taps of at most
// 32 (6 rows x 40), the narrow N blocks nine taps of 64 (6 x 72)
__host__ __device__ constexpr int wg_xfloats(int nb) { return nb == 64 ? 4 * 72 : WG_WR * 72; }
__host__ __device__ constexpr int wg_xbytes(int nb) { return WG_WW * wg_xfloats(nb) * 4; }
__host__ __device__ constexpr int wg_slot_bytes(int nb) { return wg_xbytes(nb) + nb * WG_TP * 8; }
static_assert(wg_xbytes(64) % 128 == 0 && wg_xbytes(8) % 128 == 0, "B's 128-byte alignment");
static_assert(WG_RING * wg_slot_bytes(64) <= 232448 && WG_RING * wg_slot_bytes(32) <= 232448,
              "the ring fits the 227 KB of shared memory");

// ---------------------------------------------------------------------------
// The pre-pass: the cotangent's chain and split
// ---------------------------------------------------------------------------

struct PrepArgs {
  const float* g;       // [m][c_g]
  const float* g2;      // [m][c_g]: y (WG_MODGRAD) or f (WG_BN)
  const float* cst[4];  // WG_BN: p, q, r', m' per dW row
  int c_g, cout, coutp, nb;
  int h, w, tiles_w, tiles_h;
  long long ntiles;
  float* planes;        // [ntiles][coutp / nb][2][nb / 8][WG_TP / 4][8][4]
  // the x side's prologue (conv2's relu(x*a + b)), or x null: xout = the
  // prologue of x ([m][xc]), quads of consecutive values
  const float* x;
  const float* pro_a;
  const float* pro_b;
  float* xout;
  long long xquads;     // m * xc / 4 (xc % 4 == 0) or m * xc (one value a thread)
  int xc, xvec;
  long long cot_threads;  // the cotangent's threads; the x side's follow
};

__device__ __forceinline__ void wg_tile_at(long long T, int tiles_w, int tiles_h, int h, int w,
                                           long long& img_base, int& oh0, int& ow0) {
  const int tw_i = (int)(T % tiles_w);
  const long long rest = T / tiles_w;
  const int th_i = (int)(rest % tiles_h);
  img_base = (rest / tiles_h) * h * w;
  oh0 = th_i * WG_TH;
  ow0 = tw_i * WG_TW;
}

// one thread: one dW row and four pixels of a tile; a warp's threads are 32
// consecutive rows (or all coutp < 32 of them, for 32 / coutp pixel
// quads), so each pixel's g (and y or f) is one coalesced read and each
// plane's stores are whole 128-byte core matrices
template <int GM>
__global__ void __launch_bounds__(256) wgrad_prep_kernel(const PrepArgs a) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= a.cot_threads) {  // the x side: relu(x*a + b), each operation rounded
    const long long i = e - a.cot_threads;
    if (i >= a.xquads) return;
    if (a.xvec) {
      const int c = (int)(i * 4 % a.xc);
      const float4 v = __ldg(reinterpret_cast<const float4*>(a.x) + i);
      const float4 pa = __ldg(reinterpret_cast<const float4*>(a.pro_a + c));
      const float4 pb = __ldg(reinterpret_cast<const float4*>(a.pro_b + c));
      reinterpret_cast<float4*>(a.xout)[i] = make_float4(
          relu_nan(__fadd_rn(__fmul_rn(v.x, pa.x), pb.x)), relu_nan(__fadd_rn(__fmul_rn(v.y, pa.y), pb.y)),
          relu_nan(__fadd_rn(__fmul_rn(v.z, pa.z), pb.z)), relu_nan(__fadd_rn(__fmul_rn(v.w, pa.w), pb.w)));
    } else {
      const int c = (int)(i % a.xc);
      a.xout[i] = relu_nan(__fadd_rn(__fmul_rn(__ldg(a.x + i), __ldg(a.pro_a + c)), __ldg(a.pro_b + c)));
    }
    return;
  }
  const int rows = a.coutp < 32 ? a.coutp : 32;  // divides coutp and 32
  long long q = e / rows;
  const int row = (int)(q % (a.coutp / rows)) * rows + (int)(e % rows);
  q /= a.coutp / rows;
  const int kq = (int)(q % (WG_TP / 4));
  const long long T = q / (WG_TP / 4);
  if (T >= a.ntiles) return;
  const int blk = row / a.nb, rib = row - blk * a.nb;
  long long img_base;
  int oh0, ow0;
  wg_tile_at(T, a.tiles_w, a.tiles_h, a.h, a.w, img_base, oh0, ow0);
  const int C = a.c_g;
  float cp = 0.f, cq = 0.f, cr = 0.f, cm = 0.f;
  if (GM == WG_BN && row < a.cout) {
    cp = __ldg(a.cst[0] + row);
    cq = __ldg(a.cst[1] + row);
    cr = __ldg(a.cst[2] + row);
    cm = __ldg(a.cst[3] + row);
  }
  float big[4], small[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kq * 4 + kk;
    const int oh = oh0 + k / WG_TW, ow = ow0 + k % WG_TW;
    float v = 0.f;
    if (oh < a.h && ow < a.w && row < a.cout) {
      const long long pix = img_base + (long long)oh * a.w + ow;
      if (GM == WG_RAW) {
        v = __ldg(a.g + pix * C + row);
      } else if (GM == WG_MODGRAD) {
        v = row < C ? __fmul_rn(__ldg(a.g + pix * C + row), __ldg(a.g2 + pix * C + row))
                    : __ldg(a.g + pix * C + row - C);
      } else {
        v = bn_chain_f32(__ldg(a.g + pix * C + row), __ldg(a.g2 + pix * C + row), cp, cq, cr, cm);
      }
    }
    bool bad = false;
    split_tf32(v, big[kk], small[kk], bad);
  }
  float* dst = a.planes + (T * (a.coutp / a.nb) + blk) * 2LL * a.nb * WG_TP +
               ((rib >> 3) * (WG_TP / 4) + kq) * 32 + (rib & 7) * 4;
  *reinterpret_cast<float4*>(dst) = make_float4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<float4*>(dst + a.nb * WG_TP) =
      make_float4(small[0], small[1], small[2], small[3]);
}

// ---------------------------------------------------------------------------
// The product: wgmma m64nNk8, f32 += tf32 x tf32, A from registers, B K-major
// in shared memory (matrix descriptors of wgmma.cuh)
// ---------------------------------------------------------------------------

// v -> (big, small) in integer and f32 adds at the full rate (cvt.rna.tf32
// issues at a fraction of it): as split_tf32 for finite v below the f32
// limit's rounding boundary; an inf or NaN gives a non-finite big part
__device__ __forceinline__ void split_fast(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(__float_as_uint(v));
  small = tf32_rna(__float_as_uint(__fsub_rn(v, __uint_as_float(big))));
}

// 4 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

struct WgArgs {
  const float* x[2];  // the input parts, [m][xc]
  int xc[2], xvec[2], xoff[2], nchunk[2];
  int cc, xs;         // channels per chunk (shared by the parts), window row stride
  int nrb, nblk;      // row blocks per chunk, N blocks
  const float* planes;  // wgrad_prep_kernel's
  int cout, cin;
  double* dw;           // [cout][cin][3][3], summed into
  int h, w, tiles_w, tiles_h;
  long long ntiles;
  int tiles_per_split;
};

// k8 steps a group (a fresh accumulator): a whole tile's eight where the
// registers hold their A fragments, else four (NB = 32 over three m64 tiles)
__host__ __device__ constexpr int wg_group(int nb, int mt) { return nb * mt <= 64 ? 8 : 4; }

template <int NB, int MT>
__global__ void __launch_bounds__(WG_THREADS, 1) wgrad_f32_kernel(const WgArgs a) {
  constexpr int G = wg_group(NB, MT);  // k8 steps a group
  constexpr int NA = NB / 2;  // accumulator registers a thread per m64 tile
  constexpr int SLOT = wg_slot_bytes(NB);
  constexpr int ROWS = 64 * 3 * MT;  // (tap, channel) rows of a row block
  extern __shared__ __align__(128) unsigned char wsm[];
  __shared__ __align__(8) uint64_t bars[2 * WG_RING];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across the warp (the wgmma below run on branches of it)
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0), wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int H = a.h, W = a.w, cc = a.cc, xs = a.xs;

  // the block: (chunk, row block, N block) along x, N blocks fastest (they
  // share the x windows), the pixel split along y
  const int nbi = blockIdx.x % a.nblk;
  const int rest = blockIdx.x / a.nblk;
  const int rb = rest % a.nrb;
  const int chunk_all = rest / a.nrb;
  const int part = chunk_all >= a.nchunk[0];
  const int chunk = part ? chunk_all - a.nchunk[0] : chunk_all;
  const float* xp = part ? a.x[1] : a.x[0];
  const int xc = part ? a.xc[1] : a.xc[0];
  const int xvec = part ? a.xvec[1] : a.xvec[0];
  const int xoff = part ? a.xoff[1] : a.xoff[0];
  const int cb = chunk * cc;
  const int n0 = nbi * NB;
  const int r0 = rb * ROWS;                       // the block's first row
  const int rend = min(9 * cc, r0 + ROWS);        // past its last
  const int nmt = (rend - r0 + 63) / 64;          // its m64 tiles with rows
  const int dlo = (r0 / cc) / 3, dhi = ((rend - 1) / cc) / 3;  // tap rows
  const int wrows = WG_TH + dhi - dlo;            // window rows loaded
  const bool ksplit = nmt == 1;                   // the warpgroups split K

  const long long t_begin = (long long)blockIdx.y * a.tiles_per_split;
  long long t_end = t_begin + a.tiles_per_split;
  if (t_end > a.ntiles) t_end = a.ntiles;
  const int nstage = (int)(t_end - t_begin);
  if (nstage <= 0) return;

  // this thread's A rows in each of its m64 tiles: window offsets of (tap,
  // channel) rows g and g + 8 at pixel (0, 0); a row past the block's reads
  // the window's first value (its products land in dW rows never written)
  int off[MT][2];
  bool act[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = ksplit ? 0 : wgi + 3 * i;
    act[i] = ksplit ? i == 0 : mt < nmt;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + mt * 64 + wi * 16 + g + 8 * hh;
      const int tap = r / cc, c = r - tap * cc;
      off[i][hh] = r < rend ? ((tap / 3 - dlo) * WG_WW + tap % 3) * xs + c : 0;
    }
  }

  auto slot_x = [&](int s) { return reinterpret_cast<float*>(wsm + (s % WG_RING) * SLOT); };
  // full[slot]: every thread's share of the window landed (cp.async) and the
  // B tile's bytes; empty[slot]: every thread done with it
  uint64_t* full = bars;
  uint64_t* empty = bars + WG_RING;

  // this thread's share of tile s's x window (cp.async, zeros outside the
  // image and past the part's channels) and, from thread 0, its B operand
  // (one bulk copy) into slot s % ring; the share reports to full[slot]
  // when its copies land
  auto issue = [&](int s) {
    long long img_base;
    int oh0, ow0;
    const long long T = t_begin + s;
    wg_tile_at(T, a.tiles_w, a.tiles_h, H, W, img_base, oh0, ow0);
    float* xb = slot_x(s);
    uint64_t* bar = &full[s % WG_RING];
    const int pieces = cc >> 2;
    for (int i = tid; i < wrows * WG_WW * pieces; i += WG_THREADS) {
      const int px = i / pieces, piece = i - px * pieces;
      const int wr = px / WG_WW, wc = px - wr * WG_WW;
      const int ih = oh0 - 1 + dlo + wr, iw = ow0 - 1 + wc;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const int c0 = cb + piece * 4;
      const long long pix = img_base + (long long)ih * W + iw;
      float* d = xb + px * xs + piece * 4;
      if (xvec) {
        const bool ok = in && c0 < xc;
        cp16(d, ok ? xp + pix * xc + c0 : xp, ok);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = in && c0 + k < xc;
          cp4(d + k, ok ? xp + pix * xc + c0 + k : xp, ok);
        }
      }
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
    if (tid == 0) {
      const uint32_t bytes = NB * WG_TP * 8;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
      const float* src = a.planes + (T * a.nblk + nbi) * (long long)(NB * WG_TP * 2);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(wsm + (s % WG_RING) * SLOT + wg_xbytes(NB))), "l"(src), "r"(bytes),
             "r"(smem_u32(bar)) : "memory");
    }
  };

  float acc[NA], sum[MT][NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < NA; ++e) sum[i][e] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < WG_RING; ++i) {
      mbar_init_count(&full[i], WG_THREADS + 1);
      mbar_init_count(&empty[i], WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  for (int s = 0; s < WG_RING - 1 && s < nstage; ++s) issue(s);

  // one group: k8 steps ks[0..G) (those < WG_KSTEPS) of m64 tile i into a
  // fresh accumulator, then into the sums
  auto group = [&](const float* xb, uint32_t bbig, int i, const int* ks) {
    uint32_t ah[G][4], al[G][4];
    const int o0 = off[i][0], o1 = off[i][1];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int k = ks[j];
      if (k < WG_KSTEPS) {
        const int pbase = ((k >> 1) * WG_WW + (k & 1) * 8 + t) * xs;
        const float v[4] = {xb[o0 + pbase], xb[o1 + pbase], xb[o0 + pbase + 4 * xs],
                            xb[o1 + pbase + 4 * xs]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_fast(v[e], ah[j][e], al[j][e]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int k = ks[j];
      if (k < WG_KSTEPS) {
        // the step's B: core matrices of 8 rows x 4 pixels, the two K
        // halves 128 bytes apart, 8-row groups WG_TP * 32 bytes apart
        const uint64_t db = ec_desc(bbig + k * 256, 128, WG_TP * 32);
        const uint64_t ds = ec_desc(bbig + NB * WG_TP * 4 + k * 256, 128, WG_TP * 32);
        wgmma_tf32<NB>(acc, al[j], db, j > 0);
        wgmma_tf32<NB>(acc, ah[j], ds, 1);
        wgmma_tf32<NB>(acc, ah[j], db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        keep(ah[j][e]);
        keep(al[j][e]);
      }
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      reg_fence(acc[e]);
      sum[i][e] += acc[e];
    }
  };

  // The warpgroups run apart: each waits only for its tile's data (full),
  // and after its products, before refilling the slot of the tile before,
  // for every thread to be done with that one (empty); so one warpgroup's
  // products run while another waits, up to a tile apart.
#pragma unroll 1
  for (int s = 0; s < nstage; ++s) {
    mbar_wait(&full[s % WG_RING], (s / WG_RING) & 1);
    const float* xb = slot_x(s);
    const uint32_t bbig = smem_u32(wsm + (s % WG_RING) * SLOT + wg_xbytes(NB));
    if (ksplit) {  // one m64 tile: warpgroup w takes k8 steps w, w + 3, w + 6
      int ks[G];
#pragma unroll
      for (int j = 0; j < G; ++j) ks[j] = j < 3 ? wgi + 3 * j : WG_KSTEPS;
      group(xb, bbig, 0, ks);
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!act[i]) continue;  // uniform across the warpgroup
#pragma unroll
        for (int q = 0; q < WG_KSTEPS / G; ++q) {
          int ks[G];
#pragma unroll
          for (int j = 0; j < G; ++j) ks[j] = q * G + j;
          group(xb, bbig, i, ks);
        }
      }
    }
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(&empty[s % WG_RING])) : "memory");
    const int t = s + WG_RING - 1;  // into the slot of tile s - 1
    if (t < nstage) {
      if (s > 0) mbar_wait(&empty[t % WG_RING], ((s - 1) / WG_RING) & 1);
      issue(t);
    }
  }

  // dW[row][ch][tap]: rows g, g + 8 of the warp's 16 are (tap, channel)
  // pairs; accumulator 4 j + 2 hh + e is column 8 j + 2 t + e
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (!act[i]) continue;
    const int mt = ksplit ? 0 : wgi + 3 * i;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + mt * 64 + wi * 16 + g + 8 * hh;
      const int tap = r / cc, ch = cb + r - tap * cc;
      if (r >= rend || ch >= xc) continue;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = n0 + 8 * j + 2 * t + e;
          if (row < a.cout)
            atomicAdd(a.dw + ((long long)row * a.cin + xoff + ch) * 9 + tap,
                      (double)sum[i][4 * j + 2 * hh + e]);
        }
    }
  }
}

template <int NB, int MT>
cudaError_t wgrad_launch(const WgArgs& a, dim3 grid, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(wgrad_f32_kernel<NB, MT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               WG_RING * wg_slot_bytes(NB));
    if (e != cudaSuccess) return e;
    attr = true;
  }
  wgrad_f32_kernel<NB, MT><<<grid, WG_THREADS, WG_RING * wg_slot_bytes(NB), s>>>(a);
  return cudaGetLastError();
}

cudaError_t wgrad_by_nb(int nb, int mt, const WgArgs& a, dim3 grid, cudaStream_t s) {
  if (nb == 64) return mt == 1 ? wgrad_launch<64, 1>(a, grid, s) : cudaErrorInvalidValue;
  if (mt != 3) return cudaErrorInvalidValue;
  if (nb == 32) return wgrad_launch<32, 3>(a, grid, s);
  if (nb == 16) return wgrad_launch<16, 3>(a, grid, s);
  return wgrad_launch<8, 3>(a, grid, s);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the plan's integers, by position (ops/train_f32.py _PLAN_INTS)
enum { L_CC, L_XS, L_NB, L_MT, L_NRB, L_NBLK, L_COUTP, L_TILES_H, L_TILES_W, L_NTILES, L_TPS,
       L_SPLITS, L_COUNT };

}  // namespace

extern "C" {

// The pre-pass: the cotangent of gmode (a WgMode) from g and g2 ([m][c_g]
// each; WG_BN's constants cst: p, q, r', m') split into the planes of
// plan (wgrad_prep_kernel's layout; planes holds ntiles * coutp * WG_TP * 2
// floats); with x (m pixels of xc channels), xout = relu(x*pro_a + pro_b),
// the product's input, in the same launch.
int ssu_wgrad_f32_prep(int gmode, const void* g, const void* g2, const void* const* cst,
                       int cout, int c_g, void* planes, int h, int wd, const int* plan,
                       const void* x, int xc, const void* pro_a, const void* pro_b, void* xout,
                       long long m, void* stream) {
  if (gmode < WG_RAW || gmode > WG_BN || g == nullptr || planes == nullptr ||
      (gmode != WG_RAW && g2 == nullptr) || (gmode == WG_RAW && c_g != cout) ||
      (gmode == WG_MODGRAD && 2 * c_g != cout) ||
      (gmode == WG_BN && (c_g != cout || cst[0] == nullptr || cst[1] == nullptr ||
                          cst[2] == nullptr || cst[3] == nullptr)) ||
      cout < 1 || h <= 0 || wd <= 0 || plan[L_NB] % 8 != 0 || plan[L_COUTP] % plan[L_NB] != 0 ||
      plan[L_COUTP] < cout || plan[L_TILES_H] != cdiv(h, WG_TH) ||
      plan[L_TILES_W] != cdiv(wd, WG_TW) || ((uintptr_t)planes & 15) != 0 ||
      (x != nullptr && (xc < 1 || m < 1 || pro_a == nullptr || pro_b == nullptr ||
                        xout == nullptr)))
    return (int)cudaErrorInvalidValue;
  PrepArgs a = {};
  a.g = static_cast<const float*>(g);
  a.g2 = static_cast<const float*>(g2);
  for (int i = 0; i < 4; ++i) a.cst[i] = static_cast<const float*>(cst[i]);
  a.c_g = c_g;
  a.cout = cout;
  a.coutp = plan[L_COUTP];
  a.nb = plan[L_NB];
  a.h = h;
  a.w = wd;
  a.tiles_w = plan[L_TILES_W];
  a.tiles_h = plan[L_TILES_H];
  a.ntiles = plan[L_NTILES];
  a.planes = static_cast<float*>(planes);
  a.cot_threads = a.ntiles * (WG_TP / 4) * a.coutp;
  if (x != nullptr) {
    a.x = static_cast<const float*>(x);
    a.pro_a = static_cast<const float*>(pro_a);
    a.pro_b = static_cast<const float*>(pro_b);
    a.xout = static_cast<float*>(xout);
    a.xc = xc;
    a.xvec = xc % 4 == 0 && ((uintptr_t)x | (uintptr_t)xout | (uintptr_t)pro_a |
                             (uintptr_t)pro_b) % 16 == 0;
    a.xquads = a.xvec ? m * xc / 4 : m * xc;
  }
  const long long threads = a.cot_threads + a.xquads;
  const dim3 grid((unsigned)((threads + 255) / 256));
  cudaStream_t s = (cudaStream_t)stream;
  switch (gmode) {
    case WG_RAW: wgrad_prep_kernel<WG_RAW><<<grid, 256, 0, s>>>(a); break;
    case WG_MODGRAD: wgrad_prep_kernel<WG_MODGRAD><<<grid, 256, 0, s>>>(a); break;
    default: wgrad_prep_kernel<WG_BN><<<grid, 256, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

// The product: dw[cout][cin][3][3] += sum over pixels of cot[p][o] *
// x[p + tap][i] (dw f64, zeroed by the caller, cin the parts' channels
// summed), the cotangent from the pre-pass's planes; x = up to two parts
// (n*h*wd pixels of c0 and c1 channels). plan: ops/train_f32.py
// wgrad_plan's integers.
int ssu_wgrad_f32(const void* s0, int c0, const void* s1, int c1, const void* planes, int cout,
                  void* dw, int n, int h, int wd, const int* plan, void* stream) {
  const int nparts = c1 > 0 ? 2 : 1;
  const int cc = plan[L_CC], nb = plan[L_NB], mt = plan[L_MT];
  if (s0 == nullptr || c0 <= 0 || (nparts == 2 && s1 == nullptr) ||
      planes == nullptr ||
      cout < 1 || n <= 0 || h <= 0 || wd <= 0 || dw == nullptr ||
      cc < 4 || cc > 64 || cc % 4 != 0 || plan[L_XS] < cc || plan[L_XS] > WG_XS_MAX ||
      plan[L_XS] % 4 != 0 || !(nb == 8 || nb == 16 || nb == 32 || nb == 64) ||
      (nb == 64 && (mt != 1 || (cc == 64 ? 4 : WG_WR) * plan[L_XS] > wg_xfloats(64))) ||
      plan[L_NRB] != cdiv(9 * cc, 64 * 3 * mt) || plan[L_NBLK] != cdiv(cout, nb) ||
      plan[L_COUTP] != plan[L_NBLK] * nb || plan[L_TILES_H] != cdiv(h, WG_TH) ||
      plan[L_TILES_W] != cdiv(wd, WG_TW) ||
      plan[L_NTILES] != n * plan[L_TILES_H] * plan[L_TILES_W] || plan[L_TPS] < 1 ||
      (long long)plan[L_SPLITS] * plan[L_TPS] < plan[L_NTILES] || ((uintptr_t)planes & 15) != 0)
    return (int)cudaErrorInvalidValue;
  WgArgs a = {};
  const void* xs[2] = {s0, s1};
  const int xcs[2] = {c0, c1};
  a.cc = cc;
  a.xs = plan[L_XS];
  int chunks = 0, off = 0;
  for (int i = 0; i < nparts; ++i) {
    a.x[i] = static_cast<const float*>(xs[i]);
    a.xc[i] = xcs[i];
    a.xvec[i] = xcs[i] % 4 == 0 && (uintptr_t)xs[i] % 16 == 0;
    a.xoff[i] = off;
    a.nchunk[i] = cdiv(xcs[i], cc);
    off += xcs[i];
    chunks += a.nchunk[i];
  }
  if (nparts == 1) a.nchunk[1] = 0;
  a.nrb = plan[L_NRB];
  a.nblk = plan[L_NBLK];
  a.planes = static_cast<const float*>(planes);
  a.cout = cout;
  a.cin = off;
  a.dw = static_cast<double*>(dw);
  a.h = h;
  a.w = wd;
  a.tiles_w = plan[L_TILES_W];
  a.tiles_h = plan[L_TILES_H];
  a.ntiles = plan[L_NTILES];
  a.tiles_per_split = plan[L_TPS];
  const dim3 grid((unsigned)(chunks * a.nrb * a.nblk), (unsigned)plan[L_SPLITS]);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)wgrad_by_nb(nb, mt, a, grid, s);
}

}  // extern "C"
