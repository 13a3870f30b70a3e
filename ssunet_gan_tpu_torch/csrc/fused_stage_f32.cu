// Fused eval stage of the ss-UNet family in float32 on Hopper (sm_90a):
// the f32 route of the TPU kernel ssunet_gan_tpu/ops/stage_kernel.py
// fused_eval_stage (_stage_call -> pl.pallas_call), which takes the
// activation dtype: the JAX package runs it in f32 where a model's
// activations are f32, as in the trainers' val / test evaluations.
//
// One stage (BasicBlock + self-SPADE, BatchNorm folded into the weights)
// runs as launches of one f32 conv kernel and one modulate kernel:
//   conv:      h1  = relu(conv3x3(x; K1*s1) + t1)
//   conv:      y   = relu(conv3x3(h1; K2*s2) + conv1x1(x; Ks) + t2)
//   conv:      seg = conv3x3(y; Kx) + bx
//   conv:      act = relu(conv3x3(seg; Km) + bm)
//   conv:      g|b = conv3x3(act; Kg|Kb) + bg|bb        (2C outputs)
//   modulate:  out = y * (1 + g) + b
//   conv:      logits = conv1x1(out; Kf) + bf           (folded head only)
// Each intermediate goes through device memory: this is the simple route,
// not yet fused as the bf16 kernel (fused_stage.cu) is.
//
// The conv kernel (f32_conv_kernel) is an implicit GEMM on the CUDA cores:
// M the output pixels (N*H*W, NHWC), N the output channels, K the sum over
// up to three segments of taps x channels, each segment a source of its
// own width read through its own pointer (split-concat parts, the 1x1
// shortcut), so no concatenated tensor is built. A block of 256 threads
// owns 64 pixels x 64 output channels; K runs in steps of 16: the A tile
// (16 K values x 64 pixels) is gathered from the sources with the conv's
// zero padding at the image border, the B tile (16 x 64) comes from the
// weight packed as [K][cout] (ops/stage_kernel.py pack_f32_conv), both
// double-buffered in shared memory; each thread sums 4 pixels x 4 channels
// in f32 FMAs. The epilogue adds the bias, applies ReLU where asked and
// writes 4 consecutive channels per pixel.
//
// What bounds it on the H100: a 3x3 conv at 64-256 channels does 9*C
// multiply-adds per input value, far above the f32 ridge point (67 TFLOP/s
// over 3.35 TB/s, ~20 FLOP/byte), so the stage is bound by its f32
// operations.
//
// Numerics, as the plain version (ops/stage_kernel.py fused_stage_reference
// in f32): products of f32 values summed in f32 (another order than
// cuDNN's), every segment of a conv in one sum, then the bias, then ReLU;
// the modulate rounds y*(1+g) and then adds b, with no fused multiply-add.
//
// Plain C interface (loaded with ctypes); every entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int F_THREADS = 256;
constexpr int F_BM = 64;  // pixels per block
constexpr int F_BN = 64;  // output channels per block
constexpr int F_BK = 16;  // K values per step
constexpr int F_MAX_SEG = 3;
constexpr int F_LDA = F_BM + 4;  // A rows padded: a thread's K stores fall on 2 banks, not 1

struct F32Seg {
  const float* ptr;  // [n][h][w][c]
  int c, ksize;      // channels, 3 or 1
  int k0;            // first K index of the segment
};

struct F32ConvArgs {
  F32Seg seg[F_MAX_SEG];
  int nseg;
  int k;              // K in all
  const float* w;     // [k][cout]
  const float* bias;  // [cout] or null
  float* out;         // [n][h][w][cout]
  int m, h, wd, cout;
  int relu;
};

// The A value of pixel p and K index kk: the segment's source at the tap's
// shifted position, 0 outside the image.
__device__ __forceinline__ float gather(const F32ConvArgs& a, int p, int kk) {
  if (p >= a.m || kk >= a.k) return 0.f;
  int s = 0;
#pragma unroll
  for (int i = 1; i < F_MAX_SEG; ++i)
    if (i < a.nseg && kk >= a.seg[i].k0) s = i;
  const F32Seg& sg = a.seg[s];
  const int r = kk - sg.k0;
  const int tap = r / sg.c, c = r - tap * sg.c;
  const int hw = a.h * a.wd;
  const int n = p / hw, rem = p - n * hw;
  int y = rem / a.wd, x = rem - (rem / a.wd) * a.wd;
  if (sg.ksize == 3) {
    y += tap / 3 - 1;
    x += tap % 3 - 1;
    if (y < 0 || y >= a.h || x < 0 || x >= a.wd) return 0.f;
  }
  return __ldg(sg.ptr + ((size_t)(n * a.h + y) * a.wd + x) * sg.c + c);
}

__global__ void __launch_bounds__(F_THREADS) f32_conv_kernel(const F32ConvArgs a) {
  __shared__ __align__(16) float As[2][F_BK][F_LDA];
  __shared__ __align__(16) float Bs[2][F_BK][F_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4 channels, 4 pixels each
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN;
  float acc[4][4] = {};
  float ra[4], rb[4];

  // this thread's loads: A element e = tid + 256 i is (pixel e / 16, K e % 16),
  // so a warp reads 16 consecutive channels of two pixels; B element e is
  // (K e / 64, channel e % 64)
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + F_THREADS * i;
      ra[i] = gather(a, m0 + e / F_BK, k0 + e % F_BK);
      const int kk = k0 + e / F_BN, nn = n0 + e % F_BN;
      rb[i] = (kk < a.k && nn < a.cout) ? __ldg(a.w + (size_t)kk * a.cout + nn) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + F_THREADS * i;
      As[buf][e % F_BK][e / F_BK] = ra[i];
      Bs[buf][e / F_BN][e % F_BN] = rb[i];
    }
  };

  const int steps = (a.k + F_BK - 1) / F_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * F_BK);  // the next step's loads in flight
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + ty * 4 + i;
    if (p >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= a.cout) continue;
      float v = acc[i][j];
      if (a.bias) v = __fadd_rn(v, a.bias[n]);
      if (a.relu && v < 0.f) v = 0.f;  // a NaN stays, as torch.relu keeps it
      a.out[(size_t)p * a.cout + n] = v;
    }
  }
}

// out = y * (1 + g) + b over [m][c], g and b the halves of gb's [m][2c].
__global__ void f32_modulate_kernel(const float* __restrict__ y, const float* __restrict__ gb,
                                    float* __restrict__ out, long long m, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * c) return;
  const long long p = i / c;
  const int ch = (int)(i - p * c);
  const float g = gb[p * 2 * c + ch], b = gb[p * 2 * c + c + ch];
  out[i] = __fadd_rn(__fmul_rn(y[i], __fadd_rn(1.f, g)), b);
}

}  // namespace

extern "C" {

// One conv over nseg (<= 3) segments: ptrs, chans and ks (3 or 1) per
// segment, the weight packed as [K][cout] in segment order, (tap, channel)
// within a segment; bias (or null), relu 0/1; out [n*h*w][cout].
int ssu_f32_conv(int nseg, const void* const* ptrs, const int* chans, const int* ks,
                 const void* w, const void* bias, int relu, void* out, int n, int h, int wd,
                 int cout, void* stream) {
  if (nseg < 1 || nseg > F_MAX_SEG) return (int)cudaErrorInvalidValue;
  F32ConvArgs a{};
  int k = 0;
  for (int s = 0; s < nseg; ++s) {
    if ((ks[s] != 1 && ks[s] != 3) || chans[s] < 1) return (int)cudaErrorInvalidValue;
    a.seg[s] = F32Seg{(const float*)ptrs[s], chans[s], ks[s], k};
    k += ks[s] * ks[s] * chans[s];
  }
  a.nseg = nseg;
  a.k = k;
  a.w = (const float*)w;
  a.bias = (const float*)bias;
  a.out = (float*)out;
  a.m = n * h * wd;
  a.h = h;
  a.wd = wd;
  a.cout = cout;
  a.relu = relu;
  dim3 grid((a.m + F_BM - 1) / F_BM, (cout + F_BN - 1) / F_BN);
  f32_conv_kernel<<<grid, F_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out = y * (1 + g) + b: y and out [m][c], gb [m][2c].
int ssu_f32_modulate(const void* y, const void* gb, void* out, long long m, int c,
                     void* stream) {
  const long long total = m * c;
  const int threads = 256;
  f32_modulate_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>((const float*)y, (const float*)gb,
                                                (float*)out, m, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
