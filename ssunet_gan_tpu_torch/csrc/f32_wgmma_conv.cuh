// The wide f32 train convs on Hopper (sm_90a), on wgmma tf32: the modes of
// the f32 conv core (f32_conv.cuh's mode table) that run at N blocks of 64
// output channels, for the TPU kernels
//
//   kernel 2  conv_stats   <- ssunet_gan_tpu/ops/stage_kernel_train.py
//             _conv_stats_call (:232, the call at :276): conv1 of one or two
//             parts (FM_STD), conv2 through relu(x*a + b) (FM_AFF);
//   kernel 5  fused_conv3  <- ssunet_gan_tpu/ops/train_bwd.py
//             fused_conv3_call (:167, the call at :259): kappa1 gamma /
//             gamma|beta (FM_STD with a bias), kappa3 (FM_MODGRAD), kappa6
//             (FM_BN2), kappa7 (FM_BN1: the 3x3 segment and the 1x1 shortcut
//             segment in one sum, written in two parts at split).
//
// Both take the activation dtype there, so a model trained in f32 runs them
// in f32. The narrow modes stay on f32_conv.cuh's mma.sync kernel: N <= 16
// (seg, and modgrad at the flagship's hidden 4-16) and FM_PRE (K = labels x
// 9, its bytes bound it).
//
// What bounds these convs on the H100: their multiply-adds (hundreds per
// byte at 64-256 channels), which in f32 the tensor cores take in TF32 only.
// The products run as 3xTF32 (each operand split into big = tf32(v) and
// small = tf32(v - big); small*big + big*small + big*big), at most 495 / 3 =
// 165 TFLOP/s, which only wgmma reaches. The design:
//
// - The product is transposed: D[output channel][pixel] = W[channel][K] x
//   X[K][pixel], so that the weights, the same for every pixel, are wgmma's
//   A operand in registers (a warp's m16k8 fragment is one ldmatrix of the
//   weight slice) and the windows its B operand in shared memory, read by
//   descriptors with no instruction per tap or pixel: a tap's 8 pixels of a
//   tile row are one core matrix (eight 16-byte pieces of 4 channels),
//   consecutive tile rows a window row (160 bytes) apart, the two K halves
//   of a k8 step the two 4-channel planes of the chunk (or, at <= 4
//   channels, two taps; a padded pair reads a zero region).
// - A tile is 32 x 8 pixels of one image and an N block of 64 output
//   channels (wgmma m64n128k8: M the channels; each consumer warpgroup 16
//   tile rows, N = 128 pixels). The kernel is persistent (a block per SM,
//   each walking its share of the tiles, so one tile's loads run under the
//   last one's epilogue), with three warpgroups: a producer and two
//   consumers.
// - K runs in chunks of 8 channels of one segment (f32_conv.cuh's chunks;
//   the weight is ops/stage_kernel.py pack_f32_conv's, [2][N blocks][K
//   quads][64][4]), through a ring of WC_RING slots on full / empty
//   mbarriers. A slot holds the chunk's weight slices (big, small: two bulk
//   copies) and its halo window (34 x 10 pixels) as three planes: the big
//   parts, the small parts, and the big parts with an inf or NaN as 0 (the
//   big x small(weight) products' operand, so that output classes are the
//   plain version's).
// - The producer warpgroup fills the slots: it copies a chunk's window (and
//   the chain tensor beside segment 0) by cp.async, then runs segment 0's
//   chain on the values inside the image and the split, in place, with two
//   chunks' loads in flight, so both run under the consumers' products. Its
//   split stores are generic and wgmma reads them through the async proxy,
//   so each producer thread fences them (fence.proxy.async) before it
//   arrives on the slot's full barrier.
//
// Numerics as f32_conv.cuh's train modes: the chains round each operation
// in f32 (no fused multiply-add) before the split; the tensor cores' sums
// run in a fresh accumulator per group of WC_G k8 steps (scale-d 0 on its
// first product), added into round-to-nearest f32 sums after
// wgmma.wait_group; the stat rows are summed per block in f32, in a fixed
// order, and over the blocks in f64 by stats_reduce_kernel. Everything is in
// an anonymous namespace.

#pragma once

#include "f32_conv.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WC_THREADS = 384;       // the producer warpgroup, then two consumers
constexpr int WC_TH = 32, WC_TW = 8;  // the pixel tile: 16 rows a consumer
constexpr int WC_BN = 64;             // output channels of an N block
constexpr int WC_WW = WC_TW + 2;      // window columns
constexpr int WC_WPIX = (WC_TH + 2) * WC_WW;
constexpr int WC_QP = WC_WPIX * 16;                // bytes of a 4-channel plane
constexpr int WC_PLANE = F_QMAX * WC_QP;           // bytes of a chunk's window plane
constexpr int WC_WT = F_PMAX * WC_BN * 16;         // bytes of one part of a weight slice
constexpr int WC_SLOT = 2 * WC_WT + 3 * WC_PLANE;  // weights big, small; three planes
constexpr int WC_RING = 3;
// the zero region: a B operand's 16 rows of 8 pixels, a window row apart
constexpr int WC_ZERO = ((WC_TH / 2 - 1) * WC_WW * 16 + 128 + 127) / 128 * 128;
constexpr int WC_G = 3;                    // k8 steps a group: the fresh accumulator's length
constexpr int WC_RED = 2 * 2 * WC_BN * 4;  // the stat rows' per-warpgroup sums
constexpr int WC_SMEM = WC_RING * WC_SLOT + WC_ZERO + WC_RED;
static_assert(WC_WT % 128 == 0 && WC_PLANE % 128 == 0 && WC_SLOT % 128 == 0, "alignment");
static_assert(WC_SMEM + 128 <= 232448, "the ring fits the 227 KB of shared memory");

// the modes the wgmma kernel takes (at N blocks of 64)
__host__ __device__ constexpr bool wc_mode(int m) {
  return m == FM_STD || m == FM_AFF || m == FM_MODGRAD || m == FM_BN2 || m == FM_BN1;
}

// f32_conv.cuh's split_tf32 without a branch: x -> (big, small); an inf or
// NaN -> (x, 0)
__device__ __forceinline__ void split_sel(float x, float& big, float& small) {
  const uint32_t u = __float_as_uint(x), m = u & 0x7fffffffu;
  const bool fin = m < 0x7f800000u;
  big = fin ? __uint_as_float(m < 0x7f7ff000u ? tf32_rna(u) : (u & 0xffffe000u)) : x;
  small = fin ? __uint_as_float(tf32_rna(__float_as_uint(__fsub_rn(x, big)))) : 0.f;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// segment 0's prologue on four window values of channels c0..c0 + 3 (f: the
// chain tensor's), f32_conv.cuh's prologue with its constants read as
// 16-byte pieces (16-byte aligned rows of the constants)
template <int MODE>
__device__ __forceinline__ float4 prologue4(const F32ConvArgs& a, float4 v, float4 f, int c0) {
  if constexpr (fm_pro(MODE) == 1) {
    const float4 s = ldg4(a.pc[0] + c0), b = ldg4(a.pc[1] + c0);
    return make_float4(relu_nan(__fadd_rn(__fmul_rn(v.x, s.x), b.x)),
                       relu_nan(__fadd_rn(__fmul_rn(v.y, s.y), b.y)),
                       relu_nan(__fadd_rn(__fmul_rn(v.z, s.z), b.z)),
                       relu_nan(__fadd_rn(__fmul_rn(v.w, s.w), b.w)));
  } else if constexpr (fm_pro(MODE) == 2) {
    return make_float4(__fmul_rn(v.x, f.x), __fmul_rn(v.y, f.y), __fmul_rn(v.z, f.z),
                       __fmul_rn(v.w, f.w));
  } else {
    const float4 p = ldg4(a.pc[0] + c0), q = ldg4(a.pc[1] + c0);
    const float4 r = ldg4(a.pc[2] + c0), m = ldg4(a.pc[3] + c0);
    return make_float4(bn_chain_f32(v.x, f.x, p.x, q.x, r.x, m.x),
                       bn_chain_f32(v.y, f.y, p.y, q.y, r.y, m.y),
                       bn_chain_f32(v.z, f.z, p.z, q.z, r.z, m.z),
                       bn_chain_f32(v.w, f.w, p.w, q.w, r.w, m.w));
  }
}

__device__ __forceinline__ float finite_or_zero_f(float v) {
  return __uint_as_float(finite_or_zero(__float_as_uint(v)));
}

template <int MODE>
__global__ void __launch_bounds__(WC_THREADS, 1) f32_wgmma_conv_kernel(const F32ConvArgs a) {
  static_assert(wc_mode(MODE), "a mode of the wgmma kernel");
  constexpr bool CHAIN = fm_chain(MODE);
  constexpr int NS = fm_rows(MODE);
  extern __shared__ __align__(128) unsigned char wsm[];
  __shared__ __align__(8) uint64_t bars[2 * WC_RING];
  uint64_t* const full = bars;             // the slot's window split and its weights landed
  uint64_t* const empty = bars + WC_RING;  // every consumer warp done with the slot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across the warp (the wgmma below run on branches of it)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  // The block's tiles (a tile: 32 x 8 pixels of one image and an N block of
  // WC_BN output channels, N blocks fastest) are first + k stride, k <
  // mine; their chunks, in that order, are one sequence c = k * nchunk + i
  // through the ring, so the producer loads the next tile's chunks while
  // the consumers finish a tile.
  const int nblk = (a.cout + WC_BN - 1) / WC_BN;
  const int ntiles = a.pixel_blocks * nblk;
  const int first = blockIdx.x, stride = gridDim.x;
  const int mine = first < ntiles ? (ntiles - 1 - first) / stride + 1 : 0;
  const int nseq = mine * a.nchunk;
  struct Tile {
    int img, y0, x0, nb, pb;  // pb: the pixel block, a column of the stat rows' partials
  };
  auto tile = [&](int k) {
    const int t = first + k * stride;
    Tile u;
    u.nb = t % nblk;
    u.pb = t / nblk;
    const int tx = u.pb % a.tiles_w, r = u.pb / a.tiles_w;
    u.y0 = (r % a.tiles_h) * WC_TH;
    u.x0 = tx * WC_TW;
    u.img = r / a.tiles_h;
    return u;
  };

  // plane 0 of a slot holds the big parts (the raw window until the split),
  // plane 1 the small parts (segment 0's chain tensor until the split),
  // plane 2 the big parts with an inf or NaN as 0
  auto plane = [&](int s, int part) {
    return reinterpret_cast<float4*>(wsm + s * WC_SLOT + 2 * WC_WT + part * WC_PLANE);
  };
  unsigned char* const zero = wsm + WC_RING * WC_SLOT;  // read for a padded pair
  for (int i = tid; i < WC_ZERO / 16; i += WC_THREADS)
    reinterpret_cast<float4*>(zero)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_proxy_async();  // the zero region is read by wgmma (the async proxy)
  if (tid == 0) {
    for (int s = 0; s < WC_RING; ++s) {
      mbar_init_count(&full[s], 128 + 2);  // the producers, and two weight copies
      mbar_init_count(&empty[s], 8);       // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n" ::: "memory");
    // the prologue's constants as 16-byte pieces where every row of them is
    // 16-byte aligned (uniform across the block)
    bool pc_vec = true;
    for (int k = 0; k < fm_pcst(MODE); ++k) pc_vec = pc_vec && ((uintptr_t)a.pc[k] & 15) == 0;

    // chunk c's weight slices (bulk copies) and window (cp.async) into its
    // slot, once the consumers are done with the slot's previous chunk; one
    // cp.async group a call (empty past the last chunk)
    auto issue = [&](int c) {
      if (c < nseq) {
        const int s = c % WC_RING;
        if (c >= WC_RING) mbar_wait(&empty[s], ((c / WC_RING) - 1) & 1);
        const Tile u = tile(c / a.nchunk);
        int sg, j;
        chunk_of(a, c % a.nchunk, sg, j);
        const F32Seg S = seg_at(a, sg);
        if (tid == 0) {
          const uint32_t bytes = S.pairs * WC_BN * 16;
          const float4* src = reinterpret_cast<const float4*>(a.wk) +
                              ((long long)u.nb * a.kq + S.kq0 + (long long)j * S.pairs) * WC_BN;
          unsigned char* dst = wsm + s * WC_SLOT;
          bulk_load(dst, src, bytes, &full[s]);
          bulk_load(dst + WC_WT, src + a.wpart, bytes, &full[s]);
        }
        if (S.vec) {
          float4* xw = plane(s, 0);
          float4* fw = plane(s, 1);
          const bool ch = CHAIN && sg == 0;
          for (int e = tid; e < S.q * WC_WPIX; e += 128) {
            const int q = e >= WC_WPIX ? 1 : 0;
            const int p = e - q * WC_WPIX;
            const int r = p / WC_WW, col = p - r * WC_WW;
            const int ih = u.y0 - 1 + r, iw = u.x0 - 1 + col, c0 = j * 4 * S.q + 4 * q;
            const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w && c0 < S.c;
            const long long off = (((long long)u.img * a.h + ih) * a.w + iw) * S.c + c0;
            cp16(xw + e, in ? S.ptr + off : S.ptr, in);
            if (ch) cp16(fw + e, in ? a.pro_f + off : a.pro_f, in);
          }
        }
      }
      cp_commit();
    };

    // chunk c's window: segment 0's chain on the values inside the image,
    // then the split in place (each thread on the pieces it copied); the
    // slot is then full for the consumers
    auto split = [&](int c) {
      const int s = c % WC_RING;
      const Tile u = tile(c / a.nchunk);
      int sg, j;
      chunk_of(a, c % a.nchunk, sg, j);
      const F32Seg S = seg_at(a, sg);
      float4* xw = plane(s, 0);
      float4* fw = plane(s, 1);
      float4* zw = plane(s, 2);
      const bool ch = CHAIN && sg == 0;
      const int ne = S.q * WC_WPIX;
      // two pieces an iteration, both read before either is computed
#pragma unroll 1
      for (int e0 = tid; e0 < ne; e0 += 256) {
        float4 v[2], f[2];
        int c0[2];
        bool inimg[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + 128 * h;
          const int q = e >= WC_WPIX ? 1 : 0;
          const int p = e - q * WC_WPIX;
          const int r = p / WC_WW, col = p - r * WC_WW;
          const int ih = u.y0 - 1 + r, iw = u.x0 - 1 + col;
          c0[h] = j * 4 * S.q + 4 * q;
          inimg[h] = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
          f[h] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (e >= ne) {
            v[h] = f[h];
          } else if (S.vec) {
            v[h] = xw[e];
            if (ch) f[h] = fw[e];
          } else {  // rows that are not 16-byte pieces: element by element
            const long long off = (((long long)u.img * a.h + ih) * a.w + iw) * S.c + c0[h];
            float x4[4], w4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const bool ok = inimg[h] && c0[h] + k < S.c;
              x4[k] = ok ? __ldg(S.ptr + off + k) : 0.f;
              w4[k] = ch && ok ? __ldg(a.pro_f + off + k) : 0.f;
            }
            v[h] = make_float4(x4[0], x4[1], x4[2], x4[3]);
            f[h] = make_float4(w4[0], w4[1], w4[2], w4[3]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + 128 * h, cc = c0[h];
          if (e >= ne) break;
          float4 x = v[h];
          if (fm_pro(MODE) != 0 && sg == 0 && inimg[h]) {
            if (S.vec && pc_vec) {  // c % 4 == 0: the four channels are real
              if (cc < S.c) x = prologue4<MODE>(a, x, f[h], cc);
            } else {
              if (cc < S.c) x.x = prologue<MODE>(a, x.x, f[h].x, cc);
              if (cc + 1 < S.c) x.y = prologue<MODE>(a, x.y, f[h].y, cc + 1);
              if (cc + 2 < S.c) x.z = prologue<MODE>(a, x.z, f[h].z, cc + 2);
              if (cc + 3 < S.c) x.w = prologue<MODE>(a, x.w, f[h].w, cc + 3);
            }
          }
          float4 hi, lo;
          split_sel(x.x, hi.x, lo.x);
          split_sel(x.y, hi.y, lo.y);
          split_sel(x.z, hi.z, lo.z);
          split_sel(x.w, hi.w, lo.w);
          xw[e] = hi;
          fw[e] = lo;
          zw[e] = make_float4(finite_or_zero_f(hi.x), finite_or_zero_f(hi.y),
                              finite_or_zero_f(hi.z), finite_or_zero_f(hi.w));
        }
      }
      // the planes were written by this thread's generic stores; wgmma reads
      // them through the async proxy
      fence_proxy_async();
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(&full[s]))
                   : "memory");
    };

    // two chunks' loads in flight: chunk c's window is split while chunk
    // c + 1's lands and the consumers run chunk c - 1; then chunk c + 2's
    // loads go into the slot of chunk c - 1
    issue(0);
    issue(1);
#pragma unroll 1
    for (int c = 0; c < nseq; ++c) {
      cp_wait1();
      split(c);
      issue(c + 2);
    }
    return;
  }

  // ---- the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  const int cg = wg - 1;    // consumer warpgroup: tile rows 16 cg .. 16 cg + 15
  const int wi = warp & 3;  // its warp: output channels 16 wi .. 16 wi + 15
  const int g = lane >> 2, t = lane & 3;
  // A: the lane's row of the ldmatrix that gives its warp's m16k8 weight
  // fragment (channel 16 wi + the lane's row, K quad 2 st + the lane's half)
  const uint32_t arow = ((lane >> 4) * WC_BN + 16 * wi + (lane & 7) + ((lane >> 3) & 1) * 8) * 16;

  float acc[WC_BN], sum[WC_BN];
#pragma unroll
  for (int e = 0; e < WC_BN; ++e) acc[e] = 0.f;

  // One group: k8 steps g0 .. g0 + GS of the chunk in slot s into a fresh
  // accumulator, then into the sums. GS and everything that decides which
  // wgmma run are compile-time constants, so the products run as one
  // straight sequence (a wgmma under a branch costs a warpgroup fence).
  auto group = [&](auto gsize, int s, int g0, int real, int q, int ksize) {
    constexpr int GS = decltype(gsize)::value;
    const uint32_t wbig = smem_u32(wsm + s * WC_SLOT), wsmall = wbig + WC_WT;
    const uint32_t xbig = wbig + 2 * WC_WT, xsmall = xbig + WC_PLANE, xfz = xsmall + WC_PLANE;
    const uint32_t zaddr = smem_u32(zero);
    // a (tap, quad) pair's byte offset in a plane for this warpgroup's rows,
    // or -1 for a padded pair
    auto pair_off = [&](int p) {
      const int tap = q == 2 ? p >> 1 : p, qq = p - tap * q;
      const int dy = ksize == 3 ? tap / 3 : 1, dx = ksize == 3 ? tap - 3 * dy : 1;
      return p < real ? qq * WC_QP + ((16 * cg + dy) * WC_WW + dx) * 16 : -1;
    };
    // the steps' A fragments and B descriptors, all before the products: a
    // step's B takes pairs 2 st and 2 st + 1 as its two K halves, the tile
    // rows a window row apart
    uint32_t wb[GS][4], ws[GS][4];
    uint64_t db[GS][3];  // small, finite-or-zero, big
#pragma unroll
    for (int jj = 0; jj < GS; ++jj) {
      const int st = g0 + jj;
      const uint32_t o = st * 2 * WC_BN * 16 + arow;
      ldsm_x4(wb[jj], wbig + o);
      ldsm_x4(ws[jj], wsmall + o);
      const int o0 = pair_off(2 * st), o1 = pair_off(2 * st + 1);
      const uint32_t bases[3] = {xsmall, xfz, xbig};
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        const uint32_t lbo = o1 >= 0 ? (uint32_t)(o1 - o0) : zaddr - (bases[pl] + o0);
        db[jj][pl] = ec_desc(bases[pl] + o0, lbo, WC_WW * 16);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < GS; ++jj) {
      wgmma_tf32<2 * WC_BN>(acc, wb[jj], db[jj][0], jj > 0);
      wgmma_tf32<2 * WC_BN>(acc, ws[jj], db[jj][1], 1);
      wgmma_tf32<2 * WC_BN>(acc, wb[jj], db[jj][2], 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int jj = 0; jj < GS; ++jj)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        keep(wb[jj][k]);
        keep(ws[jj][k]);
      }
#pragma unroll
    for (int e = 0; e < WC_BN; ++e) {
      reg_fence(acc[e]);
      sum[e] += acc[e];
    }
  };

  // the products of the chunk in slot s, of NST k8 steps (9: a 3x3 segment
  // of 8-channel chunks; 5: of 4 channels, its tenth pair padded; 1: a 1x1
  // segment), in groups of WC_G
  auto products = [&](auto nsteps, int s, const F32Seg& S) {
    constexpr int NST = decltype(nsteps)::value;
    constexpr int G = WC_G < NST ? WC_G : NST;
    const int real = S.ksize * S.ksize * S.q;
#pragma unroll 1
    for (int g0 = 0; g0 + G <= NST; g0 += G)
      group(std::integral_constant<int, G>(), s, g0, real, S.q, S.ksize);
    if constexpr (NST % G != 0)
      group(std::integral_constant<int, NST % G>(), s, NST - NST % G, real, S.q, S.ksize);
  };

  float* red = reinterpret_cast<float*>(zero + WC_ZERO);  // [2 warpgroups][NS][WC_BN]
#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    const Tile u = tile(k);
#pragma unroll
    for (int e = 0; e < WC_BN; ++e) sum[e] = 0.f;
#pragma unroll 1
    for (int i = 0; i < a.nchunk; ++i) {
      const int c = k * a.nchunk + i;
      const int s = c % WC_RING;
      mbar_wait(&full[s], (c / WC_RING) & 1);
      int sg, j;
      chunk_of(a, i, sg, j);
      const F32Seg S = seg_at(a, sg);
      const int nsteps = S.pairs / 2;  // f32_conv_args: 9, 5 or 1
      if (nsteps == 9)
        products(std::integral_constant<int, 9>(), s, S);
      else if (nsteps == 5)
        products(std::integral_constant<int, 5>(), s, S);
      else
        products(std::integral_constant<int, 1>(), s, S);
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(&empty[s]))
                     : "memory");
    }

    // the tile's epilogue: accumulator 4 jr + 2 hh + e is output channel
    // 16 wi + g + 8 hh of the N block at tile row 16 cg + jr, column 2 t + e;
    // each thread's two channels' stat rows over its pixels
    const int cl = 16 * wi + g;  // the thread's first channel in the block
    float st[NS > 0 ? NS : 1][2], ev[4][2];
#pragma unroll
    for (int r = 0; r < NS; ++r) st[r][0] = st[r][1] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = u.nb * WC_BN + cl + 8 * hh;
        ev[kk][hh] = MODE == FM_BN2 && c < a.cout ? __ldg(a.ec[kk] + c) : 0.f;
      }
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {  // four tile rows at a time
      // the band at the thread's sixteen outputs first, all in flight together
      constexpr bool BAND = MODE == FM_MODGRAD || MODE == FM_BN2;
      float bv[4][2][2];
#pragma unroll
      for (int jr = 0; jr < 4; ++jr)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ih = u.y0 + 16 * cg + 4 * j4 + jr, iw = u.x0 + 2 * t + e;
            const int c = u.nb * WC_BN + cl + 8 * hh;
            const bool ok = BAND && ih < a.h && iw < a.w && c < a.cout;
            const long long m = (((long long)u.img * a.h + ih) * a.w + iw) * a.cout + c;
            bv[jr][hh][e] = ok ? __ldg(a.band[0] + m) : 0.f;
          }
#pragma unroll
      for (int jr = 0; jr < 4; ++jr) {
        const int ih = u.y0 + 16 * cg + 4 * j4 + jr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int iw = u.x0 + 2 * t + e;
          if (ih >= a.h || iw >= a.w) continue;
          const long long pix = ((long long)u.img * a.h + ih) * a.w + iw;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = u.nb * WC_BN + cl + 8 * hh;
            if (c >= a.cout) continue;
            const float v = sum[4 * (4 * j4 + jr) + 2 * hh + e];
            const long long m = pix * a.cout + c;
            if constexpr (MODE == FM_STD || MODE == FM_AFF) {
              const float o = a.bias ? __fadd_rn(v, a.bias[c]) : v;
              st[0][hh] += o;
              st[1][hh] += o * o;
              a.out[m] = o;
            } else if constexpr (MODE == FM_MODGRAD) {
              const float o = bv[jr][hh][e] > 0.f ? v : 0.f;
              st[0][hh] += o;
              a.out[m] = o;
            } else if constexpr (MODE == FM_BN2) {
              const float f1 = bv[jr][hh][e];
              const float pre = __fadd_rn(__fmul_rn(f1, ev[0][hh]), ev[1][hh]);
              const float xh = __fsub_rn(__fmul_rn(f1, ev[2][hh]), ev[3][hh]);
              const float o = pre > 0.f ? v : 0.f;
              st[0][hh] += o;
              st[1][hh] += o * xh;
              a.out[m] = o;
            } else {  // FM_BN1
              if (c < a.split)
                a.out[pix * a.split + c] = v;
              else
                a.out1[pix * (a.cout - a.split) + c - a.split] = v;
            }
          }
        }
      }
    }
    if constexpr (NS > 0) {
      if (a.partial != nullptr) {  // uniform across the block
        // over the warp's four pixel columns, then each warpgroup's sums in
        // its own slots, added in a fixed order below
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int r = 0; r < NS; ++r)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              st[r][hh] += __shfl_xor_sync(0xffffffffu, st[r][hh], off);
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < NS; ++r)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) red[(cg * NS + r) * WC_BN + cl + 8 * hh] = st[r][hh];
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers
        for (int i = tid - 128; i < NS * WC_BN; i += 256) {
          const int c = i % WC_BN;
          const float v = red[i] + red[NS * WC_BN + i];
          if (u.nb * WC_BN + c < a.cout)
            a.partial[((long long)(i / WC_BN) * a.cout + u.nb * WC_BN + c) * a.pixel_blocks +
                      u.pb] = v;
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // red is free for the next tile
      }
    }
  }
}

template <int MODE>
cudaError_t f32_wgmma_launch(const F32ConvArgs& a, cudaStream_t stream) {
  static bool attr = false;  // the shared-memory limit is set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        f32_wgmma_conv_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, WC_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  // persistent: one block per SM, each walking its share of the tiles
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long ntiles = (long long)a.pixel_blocks * ((a.cout + WC_BN - 1) / WC_BN);
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  f32_wgmma_conv_kernel<MODE><<<grid, WC_THREADS, WC_SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
