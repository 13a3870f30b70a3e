// Fused eval stage of the ss-UNet family in float32 on Hopper (sm_90a):
// the f32 route of the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py
// fused_eval_stage (_stage_call -> pl.pallas_call), which takes the
// activation dtype: the JAX package runs it in f32 where a model's
// activations are f32, as in the trainers' val / test evaluations.
//
// One stage (BasicBlock + self-SPADE, BatchNorm folded into the weights)
// runs as five launches of one conv kernel (six with the folded head):
//   conv:      h1  = relu(conv3x3(x; K1*s1) + t1)
//   conv:      y   = relu(conv3x3(h1; K2*s2) + conv1x1(x; Ks) + t2)
//   conv:      seg = conv3x3(y; Kx) + bx
//   conv:      act = relu(conv3x3(seg; Km) + bm)
//   conv + modulate, in its epilogue:
//              out = y * (1 + (conv3x3(act; Kg) + bg)) + (conv3x3(act; Kb) + bb)
//   conv:      logits = conv1x1(out; Kf) + bf           (folded head only)
// h1, y, seg, act and out go through device memory; the 2C-wide g|b map
// does not (its columns are interleaved, g_c beside b_c, so the thread that
// holds one holds the other).
//
// What bounds it on the H100: a 3x3 conv at 64-256 channels does 9*C
// multiply-adds per input value, far above either ridge point, so the
// stage is bound by its operations. On the CUDA cores f32 runs at 67
// TFLOP/s; the tensor cores take TF32 (10 explicit mantissa bits) at 495.
// So the products run as 3xTF32 on the tensor cores: each f32 operand x is
// split into big = tf32(x) (rounded to nearest, ties away) and small =
// tf32(x - big), and each product is big*big + big*small + small*big,
// summed in the f32 accumulators (the small*small term, ~2^-22 of the
// product, is dropped). big + small is x to within ~2^-22 relative, so the
// sums agree with f32 products summed in another order. Three tensor-core
// products per f32 product put the ceiling at 495 / 3 = 165 TFLOP/s, above
// the CUDA cores' 67. The weights are split once, at pack time
// (ops/stage_kernel.py pack_f32_conv); the activations as each chunk's
// window lands in shared memory, once per element and chunk (the nine taps
// and both warp columns read the split window).
//
// The design, per block of eight warps (256 threads):
//   - the block owns a TH x 16 output tile of one image and BN output
//     channels (BN 64 for a wide conv, in N blocks; 8 or 16 for the narrow
//     seg, act and head convs, whose N is the labels, the hidden width or
//     the classes); each warp holds 4 m16 tiles (4 tile rows of 16 pixels)
//     by 4 n8 tiles (1 or 2 for the narrow convs) of mma.sync m16n8k8 tf32;
//   - K runs over up to three segments (split-concat parts of unequal
//     widths, the 1x1 shortcut, each read through its own pointer), each in
//     chunks of 8 channels (4 for a source of <= 4 channels: the input
//     image, the labels, a narrow hidden map), channels past the source's
//     width zero. A chunk's (TH+2) x 18 window (one-pixel halo, the image
//     border's zero padding written into it; a 1x1 segment reads its centre)
//     arrives once through 16-byte cp.async (channels innermost, as 4-channel
//     planes [pixel][4]) and the chunk's weight slice (big and small) beside
//     it, double-buffered: the next chunk's copies run while this one's
//     products do;
//   - a k8 step is two (tap, 4-channel quad) pairs of the chunk, so the nine
//     taps are shifted ldmatrix reads of the one window (a row of an 8x4
//     f32 matrix is one pixel's quad, 16 bytes; eight neighbouring pixels
//     are 128 contiguous bytes, free of bank conflicts); a chunk with an odd
//     number of pairs pads one with zero weights that reads a zero piece;
//   - no integer division by a runtime value in the loads: the window's
//     row and column come from divisions by compile-time constants.
// A SIMT f32 design tops out at the CUDA cores' 39.19 ms for the flagship's
// six stages at batch 8; 3xTF32's bound is 15.9 ms.
//
// Non-finite inputs keep the plain version's output classes (finite, NaN,
// +inf, -inf): an inf would make small = inf - inf = NaN, and a product
// big*small of an inf with a weight's small part of the other sign would
// turn a sum that f32 takes to +-inf into NaN. So an inf or NaN window
// element is split as big = itself, small = 0, and a chunk whose window
// holds one (found by the block as it splits the window) runs its big x
// small products with that element as 0: the element then contributes only
// big(x) * big(w) (an infinity of the product's sign, or NaN where w = 0 or
// x is NaN), as x * w does in f32. Finite values near the f32 limit split
// without overflow (big rounds toward zero where rounding up would pass
// it).
//
// Numerics, as the plain versions (ops/stage_kernel.py f32_conv_reference):
// every segment of a conv in one f32 sum, then the bias, then ReLU (a NaN
// stays, as torch.relu keeps it); the modulate adds 1 to g, multiplies by y
// and then adds b, each rounded in f32, with no fused multiply-add.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

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

// A block's shape: WMW warps along the pixels, 8 / WMW along the channels,
// WN n8 tiles per warp. Shared memory in 16-byte pieces: two windows (raw,
// then big in place) and one window of small parts, each with a zero piece
// at its end, and two weight stages of big then small slices.
template <int WMW, int WN>
struct FCfg {
  static constexpr int BN = (8 / WMW) * WN * 8;
  static constexpr int TH = WMW * F_MT;
  static constexpr int WPIX = (TH + 2) * F_WW;
  static constexpr int WIN = F_QMAX * WPIX + 1;
  static constexpr int WT = F_PMAX * BN;
  static constexpr int SMEM = (3 * WIN + 4 * WT) * 16;
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
  float* out;         // [m][cout], or with the modulate [m][cout / 2]
  int h, w, cout;     // cout: the conv's columns (2C with the modulate)
  int relu;
  int tiles_w, tiles_h;
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

template <int WMW, int WN, bool MOD>
__global__ void __launch_bounds__(F_THREADS, 2) f32_conv_kernel(const F32ConvArgs a) {
  using C = FCfg<WMW, WN>;
  extern __shared__ __align__(16) float4 sm[];
  float4* const lowin = sm + 2 * C::WIN;  // the small parts of the current window
  float4* const wts = sm + 3 * C::WIN;    // stage b: big slice, then small slice
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
    const int ch0 = j * 4 * S.q;
    for (int e = tid; e < S.q * C::WPIX; e += F_THREADS) {
      const int q = e >= C::WPIX ? 1 : 0;
      const int p = e - q * C::WPIX;
      const int r = p / F_WW, col = p - r * F_WW;
      const int ih = y0 - 1 + r, iw = x0 - 1 + col, c0 = ch0 + 4 * q;
      const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w && c0 < S.c;
      const float* src = S.ptr + (((long long)img * a.h + ih) * a.w + iw) * S.c + c0;
      if (S.vec) {
        cp16(win + e, in ? src : S.ptr, in);
      } else {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = (in && c0 + k < S.c) ? __ldg(src + k) : 0.f;
        win[e] = make_float4(v[0], v[1], v[2], v[3]);
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
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

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
    // split the window in place: big over the raw values, small beside
    bool bad = false;
    float4* win = sm + b * C::WIN;
    for (int e = tid; e < S.q * C::WPIX; e += F_THREADS) {
      const float4 v = win[e];
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
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (a.bias) {
          v0 = __fadd_rn(v0, a.bias[n]);
          v1 = __fadd_rn(v1, a.bias[n + 1]);
        }
        if (MOD) {  // columns (2c, 2c + 1) are (g_c, b_c)
          const int cc = a.cout >> 1, c = n >> 1;
          if (c < cc)
            a.out[pix * cc + c] =
                __fadd_rn(__fmul_rn(a.y[pix * cc + c], __fadd_rn(1.f, v0)), v1);
        } else {
          if (a.relu) {  // a NaN stays, as torch.relu keeps it
            if (v0 < 0.f) v0 = 0.f;
            if (v1 < 0.f) v1 = 0.f;
          }
          if (n < a.cout) a.out[pix * a.cout + n] = v0;
          if (n + 1 < a.cout) a.out[pix * a.cout + n + 1] = v1;
        }
      }
    }
  }
}

template <int WMW, int WN, bool MOD>
cudaError_t launch(const F32ConvArgs& a, int n, int nblocks, cudaStream_t stream) {
  using C = FCfg<WMW, WN>;
  static bool attr = false;  // the shared-memory limit is set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        f32_conv_kernel<WMW, WN, MOD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((unsigned)(a.tiles_w * a.tiles_h * n), (unsigned)nblocks);
  f32_conv_kernel<WMW, WN, MOD><<<grid, F_THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// N tile of a conv of cout columns: 8, 16 or 64 (in N blocks); the weight
// packer (ops/stage_kernel.py f32_bn) packs by the same rule
int f32_bn(int cout) { return cout <= 8 ? 8 : cout <= 16 ? 16 : 64; }

template <bool MOD>
cudaError_t launch_bn(F32ConvArgs& a, int n, int bn, int nblocks, cudaStream_t stream) {
  const int th = bn == 64 ? FCfg<4, 4>::TH : FCfg<8, 1>::TH;
  a.tiles_w = (a.w + F_TW - 1) / F_TW;
  a.tiles_h = (a.h + th - 1) / th;
  if (bn == 8) return launch<8, 1, MOD>(a, n, nblocks, stream);
  if (bn == 16) return launch<8, 2, MOD>(a, n, nblocks, stream);
  return launch<4, 4, MOD>(a, n, nblocks, stream);
}

}  // namespace

extern "C" {

// One conv over nseg (<= 3) segments: ptrs, chans and ks (3 or 1) per
// segment; w the weight packed by ops/stage_kernel.py pack_f32_conv
// ([2][nb][kq][bn][4], kq K quads per N block); bias (or null) in its
// column order; relu 0/1; with y (not null) the modulate epilogue, cout
// then the 2C interleaved g|b columns and out [n*h*w][C], else out
// [n*h*w][cout].
int ssu_f32_conv(int nseg, const void* const* ptrs, const int* chans, const int* ks,
                 const void* w, int kq, int bn, const void* bias, int relu, const void* y,
                 void* out, int n, int h, int wd, int cout, void* stream) {
  if (nseg < 1 || nseg > F_MAX_SEG || bn != f32_bn(cout) || (y && (cout & 1)))
    return (int)cudaErrorInvalidValue;
  F32ConvArgs a{};
  int k = 0, chunks = 0;
  for (int s = 0; s < nseg; ++s) {
    const int c = chans[s];
    if ((ks[s] != 1 && ks[s] != 3) || c < 1) return (int)cudaErrorInvalidValue;
    F32Seg S{};
    S.ptr = (const float*)ptrs[s];
    S.c = c;
    S.ksize = ks[s];
    S.q = c <= 4 ? 1 : 2;
    S.nchunk = (c + 4 * S.q - 1) / (4 * S.q);
    S.pairs = ks[s] * ks[s] * S.q;
    S.pairs += S.pairs & 1;
    S.kq0 = k;
    S.vec = c % 4 == 0 && ((uintptr_t)ptrs[s] & 15) == 0;
    a.seg[s] = S;
    k += S.nchunk * S.pairs;
    chunks += S.nchunk;
  }
  if (k != kq || ((uintptr_t)w & 15)) return (int)cudaErrorInvalidValue;
  const int nblocks = (cout + bn - 1) / bn;
  a.nseg = nseg;
  a.nchunk = chunks;
  a.wk = (const float*)w;
  a.wpart = (long long)nblocks * kq * bn;
  a.kq = kq;
  a.bias = (const float*)bias;
  a.y = (const float*)y;
  a.out = (float*)out;
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.relu = relu;
  return (int)(y ? launch_bn<true>(a, n, bn, nblocks, (cudaStream_t)stream)
                 : launch_bn<false>(a, n, bn, nblocks, (cudaStream_t)stream));
}

}  // extern "C"
