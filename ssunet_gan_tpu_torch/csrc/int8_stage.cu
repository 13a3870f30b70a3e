// int8 fused eval stage of the ss-UNet family on Hopper (sm_90a): the port
// of the TPU kernel ssunet_gan_tpu/ops/stage_kernel_int8.py
// fused_eval_stage_int8 (_stage_call_int8 -> pl.pallas_call, body
// _make_kernel_int8 with the SPADE tail of ops/spade_kernel.py _spade_tail).
//
// One stage (BasicBlock + self-SPADE, BatchNorm and the input scales folded
// into per-output-channel s8 weights) runs as four launches, after the bf16
// inputs are quantized in one pass each (launch P):
//   P. q_quant_kernel:   q = clip(rint(x / s), +-127) as s8, bf16 or f32 in;
//                        under a dynamic scale q_absmax_kernel first writes
//                        s = max(max|x| / 127, 1e-12) to device memory
//   A. s8_conv_core<N, QC_H1>:  h1 = relu(f32(conv3x3_s8(qx; Wq1)) * d1 + t1),
//                        bf16, and the maximum of each image row of h1 (rowmax)
//   Q. q_band_kernel:    per image and band of th rows, the scale
//                        s = max(max(h1 rows i*th-4 .. i*th+th+3) / 127, 1e-12)
//                        and q(h1) = clip(round(h1 / s)) for rows i*th-1 ..
//                        i*th+th of the band, into a band-local s8 buffer
//   B. s8_conv_core<N, QC_Y>:   y = relu(f32(conv3x3_s8(q(h1); Wq2)) * (d2 * s)
//                                    + f32(conv1x1_s8(qx; Wqs)) * ds + t2), bf16
//   C. spade_tail_kernel: the bf16 self-SPADE tail of stage_common.cuh, with
//                        the folded head or the output emitted as s8.
// A band's halo rows of h1 are quantized once for each of the two bands that
// read them, with each band's own scale, which is why q(h1) lives in a
// band-local buffer (th + 2 rows per band) and not in one s8 image. A row of
// y is computed once, with the scale of the band that owns it.
//
// What bounds it on the H100: conv1 and conv2 + shortcut carry ~95% of the
// stage's multiply-adds at an intensity far above the s8 ridge point, so the
// stage is bound by tensor-core operations. Launches A and B run on the s8
// conv core of int8_conv.cuh (wgmma m64nNk32 with both operands in shared
// memory, exact s32 sums; the split-concat parts and the shortcut are
// K-segments read through their own pointers). Launch P and Q are bound by
// their bytes: one read of the input and one write of s8. The decoder's
// upsample seams and the encoder's pool seams are read in s8 by launches A
// and B (int8_conv.cuh read modes 1 and 2): a stage quantizes the half-height
// tensor, or the full-resolution one, and the full-resolution up tensor and
// the pooled tensor are never written. Quantizing the inputs inside launch
// A's loader (the windows arrive by cp.async, which cannot convert) is later
// work (see ROADMAP.md).
//
// Numerics: s32 sums are exact; every f32 dequantization step is a separate
// rounding (no fused multiply-add), in the TPU kernel's order; h1 and y are
// rounded to bf16; inputs and h1 are quantized by an IEEE division and round
// half to even. The plain PyTorch versions (ops/stage_kernel_int8.py) repeat
// these steps, so the s8 inputs, h1 and y agree with them bit for bit.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include "int8_conv.cuh"

namespace {

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

// Launch P: elements i..i+7 of x (bf16, or f32 with F32) as floats, zeros
// past n; vec: the group is read in 16-byte pieces.
template <bool F32>
__device__ __forceinline__ void q_load8(const void* x, long long i, long long n, bool vec,
                                        float* f) {
  if (vec && i + 8 <= n) {
    if constexpr (F32) {
      const float4 u0 = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + i);
      const float4 u1 = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + i + 4);
      f[0] = u0.x, f[1] = u0.y, f[2] = u0.z, f[3] = u0.w;
      f[4] = u1.x, f[5] = u1.y, f[6] = u1.z, f[7] = u1.w;
    } else {
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + i), f);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    f[e] = 0.f;
    if (i + e < n)
      f[e] = F32 ? static_cast<const float*>(x)[i + e]
                 : __bfloat162float(static_cast<const bf16*>(x)[i + e]);
  }
}

constexpr int QT_THREADS = 256;

// The abs-max of x (as the bits of |x|, which order as unsigned ints, a NaN
// above every number) into work[0], then, in the last block to finish
// (work[1] counts them; both zero on entry), s = max(amax / 127, 1e-12).
template <bool F32>
__global__ void __launch_bounds__(QT_THREADS)
q_absmax_kernel(const void* x, long long n, int vec, unsigned* work, float* scale) {
  __shared__ unsigned red[QT_THREADS / 32];
  unsigned m = 0u;
  const long long groups = (n + 7) / 8;
  for (long long gi = (long long)blockIdx.x * QT_THREADS + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * QT_THREADS) {
    float f[8];
    q_load8<F32>(x, gi * 8, n, vec, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = max(m, __float_as_uint(f[e]) & 0x7fffffffu);
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < QT_THREADS / 32; ++i) m = max(m, red[i]);
    atomicMax(&work[0], m);
    __threadfence();
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      const float amax = __uint_as_float(atomicMax(&work[0], 0u));
      *scale = amax != amax ? amax : fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
    }
  }
}

// q = clip(rint(x / s), +-127) as s8, s from *sp (dynamic) or sv (static).
template <bool F32>
__global__ void __launch_bounds__(QT_THREADS)
q_quant_kernel(const void* x, long long n, int vec, const float* sp, float sv, signed char* q) {
  const float s = sp != nullptr ? *sp : sv;
  const long long groups = (n + 7) / 8;
  for (long long gi = (long long)blockIdx.x * QT_THREADS + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * QT_THREADS) {
    const long long i = gi * 8;
    float f[8];
    q_load8<F32>(x, i, n, vec, f);
    uint32_t u[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = fminf(fmaxf(rintf(__fdiv_rn(f[e], s)), -127.f), 127.f);
      u[e >> 2] |= ((uint32_t)(uint8_t)(signed char)(int)v) << (8 * (e & 3));
    }
    if (vec && i + 8 <= n) {
      *reinterpret_cast<uint2*>(q + i) = make_uint2(u[0], u[1]);
    } else {
      for (int e = 0; e < 8 && i + e < n; ++e) q[i + e] = (signed char)(u[e >> 2] >> (8 * (e & 3)));
    }
  }
}

// blocks of a grid-stride pass over n elements, 8 a thread
unsigned qt_blocks(long long n) {
  const long long b = ((n + 7) / 8 + QT_THREADS - 1) / QT_THREADS;
  return (unsigned)(b < 1 ? 1 : b > 4096 ? 4096 : b);
}

}  // namespace

extern "C" {

// Launch P, dynamic scale: the abs-max of x (n elements, bf16 or f32) and
// the scale into *scale (f32); work: two zeroed 32-bit words.
int ssu_q_absmax(const void* x, long long n, int f32, void* work, void* scale, void* stream) {
  if (x == nullptr || n <= 0 || work == nullptr || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  const int vec = (uintptr_t)x % 16 == 0;
  const unsigned blocks = qt_blocks(n);
  if (f32)
    q_absmax_kernel<true><<<blocks, QT_THREADS, 0, (cudaStream_t)stream>>>(
        x, n, vec, static_cast<unsigned*>(work), static_cast<float*>(scale));
  else
    q_absmax_kernel<false><<<blocks, QT_THREADS, 0, (cudaStream_t)stream>>>(
        x, n, vec, static_cast<unsigned*>(work), static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

// Launch P: x (n elements, bf16 or f32) as s8 at the scale *scale_ptr
// (device memory) or, when scale_ptr is null, scale.
int ssu_q_quant(const void* x, long long n, int f32, const void* scale_ptr, float scale, void* q,
                void* stream) {
  if (x == nullptr || q == nullptr || n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)q % 8 == 0;
  const unsigned blocks = qt_blocks(n);
  const float* sp = static_cast<const float*>(scale_ptr);
  if (f32)
    q_quant_kernel<true><<<blocks, QT_THREADS, 0, (cudaStream_t)stream>>>(
        x, n, vec, sp, scale, static_cast<signed char*>(q));
  else
    q_quant_kernel<false><<<blocks, QT_THREADS, 0, (cudaStream_t)stream>>>(
        x, n, vec, sp, scale, static_cast<signed char*>(q));
  return (int)cudaGetLastError();
}

// Launch A: conv3x3 over up to two s8 parts, each read in its mode (m0, m1:
// 0 plain, 1 up, 2 pool; int8_conv.cuh) -> h1 (bf16, n x h x wd) and rowmax,
// on the s8 conv core: nblk N blocks of nt channels (one block up to 256
// channels, the deep stages' 384-768 in blocks of <= 256). A part with c ==
// 0 is absent. w: nsteps k32 steps per N block packed in the descriptor's
// order. rowmax ([n][h] f32) must be zero on entry; every N block adds its
// channels' row maxima to it.
int ssu_s8_conv1(const void* s0, int c0, int m0, const void* s1, int c1, int m1, int nt,
                 const void* w, int nsteps, int nblk, const void* d1, const void* t1, void* h1,
                 void* rowmax, int n, int h, int wd, int cout, void* stream) {
  const void* ptrs[2] = {s0, s1};
  const int chans[2] = {c0, c1}, ks[2] = {3, 3}, modes[2] = {m0, m1}, band[2] = {0, 0};
  const int nseg = c1 > 0 ? 2 : 1;
  return launch_s8_conv(QC_H1, nseg, ptrs, chans, ks, modes, band, nseg, nt, w, nsteps, nblk, d1,
                        t1, nullptr, nullptr, rowmax, h1, n, h, wd, cout, h,
                        (cudaStream_t)stream);
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

// Launch B: the 1x1 shortcut over up to two s8 parts, each read in its mode
// (m0, m1 as in launch A), and conv3x3 over the band-local q(h1) (c
// channels, bands of th rows, read plain), two s32 sums -> y (bf16), on the
// s8 conv core: nblk N blocks of nt channels, w packed per block (the
// shortcut's k32 steps first).
int ssu_s8_conv2(const void* s0, int c0, int m0, const void* s1, int c1, int m1,
                 const void* qh1, int c, int th, int nt, const void* w, int nsteps, int nblk,
                 const void* d2, const void* ds, const void* t2, const void* bandscale, void* y,
                 int n, int h, int wd, int cout, void* stream) {
  const int np = c1 > 0 ? 2 : 1;
  const void* ptrs[3] = {s0, np == 2 ? s1 : qh1, qh1};
  const int chans[3] = {c0, np == 2 ? c1 : c, c}, ks[3] = {1, np == 2 ? 1 : 3, 3};
  const int modes[3] = {m0, np == 2 ? m1 : 0, 0}, band[3] = {0, np == 2 ? 0 : 1, 1};
  return launch_s8_conv(QC_Y, np + 1, ptrs, chans, ks, modes, band, np, nt, w, nsteps, nblk, d2,
                        ds, t2, bandscale, nullptr, y, n, h, wd, cout, th, (cudaStream_t)stream);
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
