// The eval conv core on Hopper (sm_90a): every conv launch of the fused
// eval stages (fused_stage.cu, TPU kernel 1; bneck_stage.cu, TPU kernel 8)
// and the train tail's residual conv (train_stage.cu, TPU kernel 3). It
// computes what those TPU kernels compute inside their bodies
// (ssunet_gan_tpu/ops/stage_kernel.py _make_kernel :820 and
// _make_bneck_kernel :1335, ops/stage_kernel_train.py _make_tail_kernel
// :314): one conv over up to three K-segments, each a source of its own
// width read through its own pointer (split-concat parts of unequal widths,
// a 1x1 shortcut over the parts, an identity shortcut as a unit matrix), 3x3
// (zero-padded at the image border) or 1x1, summed into one f32 accumulator,
// then
//   bias + ReLU -> bf16                      (kernels 1 and 8), or
//   relu(res*a + b + acc) -> bf16            (kernel 3's residual).
// A segment's source is read in one of three modes, the TPU kernels'
// on-read seams (ssunet_gan_tpu/ops/stage_kernel.py _upsample_on_read :744,
// _pool_on_read :789):
//   0  plain: the H x W image itself;
//   1  up: an (H/2) x W source, the decoder's bilinear x2 seam after its
//      W-interpolation; each window row p is the lerp of source rows
//      j0 = floor((p-1)/2) and j0+1 (zero outside the source) with the
//      weights w1 = f32(p(hh-1) - j0(2hh-1)) / f32(2hh-1) and
//      w0 = f32((j0+1)(2hh-1) - p(hh-1)) / f32(2hh-1), each rounded to
//      bf16, summed in f32 and rounded once (IEEE division: no fast math);
//   2  pool: a 2H x 2W source, the encoder's 2x2 max-pool seam;
//      max(max(TL, TR), max(BL, BR)), a NaN winning as in torch.maximum.
// The full-resolution up tensor and the pooled tensor are never written.
// The conv's zero padding applies at the H x W (logical) border in every
// mode.
//
// What bounds it on the H100: a 3x3 conv at 64-256 channels does 9*C
// multiply-adds per input value read, far above the bf16 ridge point
// (~295 FLOP/byte), so those launches are bound by tensor-core operations;
// a launch of 1x1 segments alone does C, below it, and is bound by the
// bytes of its input and output.
//
// The design, per block of two warpgroups (256 threads):
//   - the block owns a TH x 8 output tile of one image (TH = 32 for N <= 128,
//     16 for wider N: 128 f32 sums per thread at most) and ALL output
//     channels, so each input value comes from device memory once per block
//     and chunk, not once per tap and N block;
//   - a source arrives in chunks of cc channels (8 or 16 whole for a narrow
//     source, else 32) as the tile's window in shared memory through
//     cp.async: (TH+2) x 10 pixels for a 3x3 source, TH x 8 (no halo) for a
//     1x1 one, stored as 8-channel planes of [pixel][8 channels];
//   - K runs over (tap, 8-channel group) pairs of a chunk, two per k16 step,
//     so 3 input channels take 5 k16 steps, not 9 x 2;
//   - wgmma.mma_async m64nNk16 (N = the output channels padded to 128,
//     192 or 256) with both operands in shared memory: A, the pixels,
//     through a matrix descriptor straight into the window, because a tile
//     row of 8 pixels of one 8-channel plane is one K-major core matrix (8
//     rows of 16 bytes), the next tile row one window row further (the
//     descriptor's 8-row stride), the pair's second k8 group its "leading"
//     offset: each tap's shifted view is one descriptor, no copy; B, the
//     weights, packed once per model in exactly the order its descriptor
//     reads ([k16 step][N/8][k half][8 channels][8 K values]), so a stage's
//     slice lands in place with one bulk copy (the TMA engine; one thread
//     issues it, an mbarrier per slot reports it). At 64 output channels
//     (fewer are padded to 64) the roles swap, m64n128k16 with the weights
//     as A and 128 pixels as B (ec_swap);
//   - stages of up to 6-9 k16 steps in a 3-deep ring of weight slices and
//     windows: a stage's wgmmas are issued back to back, then the loads of
//     the stage two on while they run, then the stage's wgmmas are waited
//     for (its slots are refilled by the next stage; four slots, to keep a
//     stage's wgmmas running across the next barrier, measured slower on
//     the H100);
//   - the epilogue stages the f32 sums in shared memory and writes each
//     pixel's channels as 16-byte pieces.
// A from registers (ldmatrix of the shifted window) measured slower on the
// H100: every k16 step then waits for an ldmatrix and for the wgmma two
// steps back before it can issue. A seam segment (modes 1 and 2) loads its
// window pieces into registers (two or four 16-byte loads), computes them
// and stores them into the same 8-channel planes with ordinary stores; the
// fence to the async proxy before each stage's barrier covers them as it
// covers the cp.async copies, and the MMA side does not change.
//
// Numerics, as the TPU kernels and the plain versions (ops/stage_kernel.py
// eval_conv_reference): each conv zero-pads its own input at the image
// border; products of bf16 values summed in f32; every segment in one
// accumulator (conv2's 3x3 and its shortcut share one rounding); bias,
// then ReLU (or the residual affine, each operation rounded in f32), then
// one rounding to bf16. Everything is in an anonymous namespace.

#pragma once

#include "conv_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int EC_THREADS = 256;  // two warpgroups
constexpr int EC_RING = 3;       // stages: one being computed, two being loaded
constexpr int EC_MAX_SEG = 3;
constexpr int EC_TW = 8;         // tile columns: a tile row is one core matrix of A
constexpr int EC_SMEM = SMEM_MAX - 1024;  // dynamic shared memory (the mbarriers are static)

// At N = 64 the operands swap roles: the weights (64 output channels) are
// wgmma's A and the warpgroup's 128 pixels its B, an m64n128k16 that reads
// 6 KB of shared memory per 131k multiply-adds instead of two m64n64k16
// reading 8 KB (shared-memory bandwidth bounds the small-N launches).
__host__ __device__ constexpr bool ec_swap(int nt) { return nt <= 64; }
// m64 pixel tiles per warpgroup (eight tile rows each; the accumulators of
// MT x N / 2 f32 registers per thread stay at <= 128); tile rows, half per
// warpgroup; blocks per SM (two where registers and shared memory allow, so
// one block's loads and epilogue overlap the other's MMAs)
__host__ __device__ constexpr int ec_mt(int nt) { return nt <= 128 ? 2 : 1; }
__host__ __device__ constexpr int ec_th(int nt) { return 16 * ec_mt(nt); }
__host__ __device__ constexpr int ec_blocks(int nt) { return nt <= 64 ? 2 : 1; }
// k16 steps of a stage, at most (a weight slot is this x N x 32 bytes)
__host__ __device__ constexpr int ec_max_sps(int nt) { return nt <= 64 ? 6 : nt <= 128 ? 9 : 6; }

// k16 steps of a chunk of cc channels: its (tap, 8-channel group) pairs,
// two per step
__host__ __device__ inline int ec_chunk_steps(int cc, int ksize) {
  return ((ksize == 3 ? 9 : 1) * (cc / 8) + 1) / 2;
}
// stages of a chunk (each stage ends in a block barrier): a 32-channel 3x3
// chunk (18 steps) in 2 or 3, a 16-channel one (9) in 1 or 3, the rest in 1
__host__ __device__ inline int ec_chunk_stages(int cc, int ksize, int nt) {
  const int steps = ec_chunk_steps(cc, ksize), m = ec_max_sps(nt);
  return steps <= m ? 1 : steps == 9 ? 3 : steps / m;
}
// bytes of one 8-channel plane of a window of wpix pixels: 16 bytes a
// pixel, the planes 16 bytes off a 128-byte line apart (a pixel's pieces
// land on distinct banks)
__host__ __device__ inline int ec_plane_bytes(int wpix) { return (wpix * 16 + 127) / 128 * 128 + 16; }

struct EcSeg {
  const bf16* ptr;  // [m][c] of the source's own H x W (mode 1: H/2 x W; 2: 2H x 2W)
  int c, ksize;
  int mode;         // 0 plain, 1 up (H-interpolation on read), 2 pool (2x2 max on read)
  int cc, lg;       // channels per chunk, log2 of its 8-channel groups
  int vec;          // 16-byte async copies allowed
  int nchunk, spc, sps;  // chunks, stages per chunk, k16 steps per stage
};

struct EcArgs {
  EcSeg seg[EC_MAX_SEG];
  int nseg;
  const bf16* wt;      // [steps][NT/8][2][8][8]: per k16 step, K-major core matrices
  const float* bias;   // [cout] or null
  const bf16* res;     // [m][cout]: out = relu(res*res_a + res_b + acc), or null
  const float* res_a;
  const float* res_b;
  bf16* out;           // [m][cout]
  int h, w, cout;
  int tiles_w, tiles_h;
  int wslot, winslot;  // bytes of a weight stage slot, of a window slot
};

__device__ __forceinline__ EcSeg ec_seg(const EcArgs& a, int i) {
  return i == 0 ? a.seg[0] : i == 1 ? a.seg[1] : a.seg[2];
}

// ---------------------------------------------------------------------------
// The seam reads (modes 1 and 2): one window piece, 8 channels of one pixel
// ---------------------------------------------------------------------------

// Channels c0..c0+7 of pixel pix of a [pix][c] source as one 16-byte piece:
// one 16-byte load when its rows are 16-byte pieces (vec), else element by
// element; zeros past c.
__device__ __forceinline__ uint4 ld_piece(const bf16* base, int c, long long pix, int c0,
                                          bool vec) {
  if (vec)
    return c0 < c ? *reinterpret_cast<const uint4*>(base + pix * c + c0) : make_uint4(0, 0, 0, 0);
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(base) + pix * c + c0;
  unsigned short e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = c0 + j < c ? ps[j] : 0;
  return make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                    e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
}

// two packed bf16 values: a*w0 + b*w1 per value (the products exact in f32,
// one rounding of the sum, then one to bf16)
__device__ __forceinline__ uint32_t lerp2(uint32_t a, uint32_t b, float w0, float w1) {
  const float lo = __fadd_rn(__fmul_rn(__uint_as_float(a << 16), w0),
                             __fmul_rn(__uint_as_float(b << 16), w1));
  const float hi = __fadd_rn(__fmul_rn(__uint_as_float(a & 0xffff0000u), w0),
                             __fmul_rn(__uint_as_float(b & 0xffff0000u), w1));
  return pack2(lo, hi);
}

// torch.maximum of two floats: a NaN on either side wins
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// two packed bf16 values: max(max(a, b), max(c, d)) per value (exact)
__device__ __forceinline__ uint32_t max4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  auto lo = [](uint32_t u) { return __uint_as_float(u << 16); };
  auto hi = [](uint32_t u) { return __uint_as_float(u & 0xffff0000u); };
  return pack2(nan_max(nan_max(lo(a), lo(b)), nan_max(lo(c), lo(d))),
               nan_max(nan_max(hi(a), hi(b)), nan_max(hi(c), hi(d))));
}

// Channels c0..c0+7 of the seam segment S at pixel (ih, iw), inside the
// H x W image img: mode 1 interpolates rows j0 and j0+1 of its (H/2) x W
// source, mode 2 takes the 2x2 max of its 2H x 2W source.
__device__ __forceinline__ uint4 seam_piece(const EcSeg& S, int img, int ih, int iw, int c0,
                                            int H, int W) {
  if (S.mode == 1) {
    const int hh = H >> 1, den = 2 * hh - 1;
    const int j0 = (ih + 1) / 2 - 1, j1 = j0 + 1;  // floor((ih - 1) / 2) for ih >= 0
    const float w1 = bf16r(__fdiv_rn((float)(ih * (hh - 1) - j0 * den), (float)den));
    const float w0 = bf16r(__fdiv_rn((float)(j1 * den - ih * (hh - 1)), (float)den));
    const long long row = (long long)img * hh * W + iw;
    const uint4 z = make_uint4(0, 0, 0, 0);
    const uint4 a = j0 >= 0 ? ld_piece(S.ptr, S.c, row + (long long)j0 * W, c0, S.vec) : z;
    const uint4 b = j1 < hh ? ld_piece(S.ptr, S.c, row + (long long)j1 * W, c0, S.vec) : z;
    return make_uint4(lerp2(a.x, b.x, w0, w1), lerp2(a.y, b.y, w0, w1),
                      lerp2(a.z, b.z, w0, w1), lerp2(a.w, b.w, w0, w1));
  }
  const long long tl = ((long long)img * 2 * H + 2 * ih) * (2 * W) + 2 * iw;
  const uint4 a = ld_piece(S.ptr, S.c, tl, c0, S.vec);
  const uint4 b = ld_piece(S.ptr, S.c, tl + 1, c0, S.vec);
  const uint4 c = ld_piece(S.ptr, S.c, tl + 2 * W, c0, S.vec);
  const uint4 d = ld_piece(S.ptr, S.c, tl + 2 * W + 1, c0, S.vec);
  return make_uint4(max4(a.x, b.x, c.x, d.x), max4(a.y, b.y, c.y, d.y),
                    max4(a.z, b.z, c.z, d.z), max4(a.w, b.w, c.w, d.w));
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk16, f32 += bf16 x bf16, A and B K-major in shared memory
// (matrix descriptors of wgmma.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a, uint64_t desc_b) {
  if constexpr (N == 128) wgmma_n128(d, desc_a, desc_b);
  else if constexpr (N == 192) wgmma_n192(d, desc_a, desc_b);
  else wgmma_n256(d, desc_a, desc_b);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(EC_THREADS, ec_blocks(NT))
eval_conv_core(const EcArgs a) {
  constexpr bool SWAP = ec_swap(NT);
  constexpr int MT = SWAP ? 1 : ec_mt(NT);
  constexpr int THc = ec_th(NT);
  constexpr int TPIXc = THc * EC_TW;
  constexpr int NACC = SWAP ? 64 : NT / 2;  // f32 sums of one wgmma tile per thread
  constexpr int SST = NT + 8;    // f32 row stride of the staged sums
  extern __shared__ __align__(128) unsigned char ec_smem[];
  __shared__ uint64_t wbar[EC_RING];              // a weight slot's bulk copy landed
  unsigned char* wts = ec_smem;                   // [RING][wslot bytes]
  unsigned char* win = wts + EC_RING * a.wslot;   // [RING][winslot bytes]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.h, W = a.w;
  const int tw_i = blockIdx.x % a.tiles_w;
  const int rest = blockIdx.x / a.tiles_w;
  const int th_i = rest % a.tiles_h;
  const int img = rest / a.tiles_h;
  const long long img_base = (long long)img * H * W;
  const int oh0 = th_i * THc, ow0 = tw_i * EC_TW;

  // a walk over the stages: segment, chunk, stage of the chunk, the chunk's
  // running index (its window slot) and the stage's first k16 step
  struct Cursor {
    int s, sg, chunk, j, gchunk, k;
  };
  int nstage = 0;
#pragma unroll
  for (int i = 0; i < EC_MAX_SEG; ++i)
    if (i < a.nseg) nstage += a.seg[i].nchunk * a.seg[i].spc;
  auto advance = [&](Cursor& u) {
    const EcSeg S = ec_seg(a, u.sg);
    u.k += S.sps;
    ++u.s;
    if (++u.j == S.spc) {
      u.j = 0;
      ++u.gchunk;
      if (++u.chunk == S.nchunk && u.sg + 1 < a.nseg) {
        u.chunk = 0;
        ++u.sg;
      }
    }
  };
  // loads of stage u: its weight slice (one bulk copy); at a chunk's first
  // stage, the chunk's window as 8-channel planes of [pixel][8] (zeros
  // outside the image and past the source's channels), a seam segment's
  // pieces computed on the way
  auto issue = [&](const Cursor& u) {
    if (u.s < nstage) {
      const EcSeg S = ec_seg(a, u.sg);
      if (tid == 0)
        bulk_load(wts + (u.s % EC_RING) * a.wslot, a.wt + (long long)u.k * (NT * 16),
                  S.sps * NT * 32, &wbar[u.s % EC_RING]);
      if (u.j == 0) {
        const int hl = S.ksize == 3 ? 1 : 0;
        const int ww = EC_TW + 2 * hl, wpix = (THc + 2 * hl) * ww;
        const int plane = ec_plane_bytes(wpix) / 2;  // halves
        unsigned char* wb = win + (u.gchunk % EC_RING) * a.winslot;
        const int cb = u.chunk * S.cc;
        const int gmask = (1 << S.lg) - 1;
        for (int i = tid; i < wpix << S.lg; i += EC_THREADS) {
          const int px = i >> S.lg, grp = i & gmask;
          const int wr = px / ww, wc = px - wr * ww;
          const int ih = oh0 - hl + wr, iw = ow0 - hl + wc;
          const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
          bf16* dst = reinterpret_cast<bf16*>(wb) + grp * plane + px * 8;
          if (S.mode == 0)
            copy_piece(dst, S.ptr, S.c, img_base + (long long)ih * W + iw, cb + grp * 8, in,
                       S.vec);
          else
            *reinterpret_cast<uint4*>(dst) =
                in ? seam_piece(S, img, ih, iw, cb + grp * 8, H, W) : make_uint4(0, 0, 0, 0);
        }
      }
    }
    cp_commit();  // an empty group past the end keeps the wait counts uniform
  };

  float acc[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.f;

  const int wg = warp >> 2, wi = warp & 3;
  if (tid == 0) {
    for (int i = 0; i < EC_RING; ++i) mbar_init(&wbar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  Cursor cur = {0, 0, 0, 0, 0, 0}, ahead = cur;
  for (int i = 0; i < EC_RING - 1; ++i) {
    issue(ahead);
    advance(ahead);
  }
  for (; cur.s < nstage; advance(cur)) {
    cp_wait<EC_RING - 2>();
    fence_proxy_async();
    mbar_wait(&wbar[cur.s % EC_RING], (cur.s / EC_RING) & 1);
    __syncthreads();
    const EcSeg S = ec_seg(a, cur.sg);
    const int ksz = S.ksize, hl = ksz == 3 ? 1 : 0;
    const int ww = EC_TW + 2 * hl;
    const uint32_t plane = ec_plane_bytes((THc + 2 * hl) * ww);
    const uint32_t wbase = smem_u32(win + (cur.gchunk % EC_RING) * a.winslot) +
                           (uint32_t)(wg * (THc / 2) * ww * 16);
    const uint32_t wd = smem_u32(wts + (cur.s % EC_RING) * a.wslot);
    const int ngrp = 1 << S.lg, groups = (ksz == 3 ? 9 : 1) << S.lg;
    // the window offset (bytes) of k8 group q: (tap, group)
    auto goff = [&](int q) -> uint32_t {
      const int tap = q >> S.lg, grp = q & (ngrp - 1);
      return grp * plane + (uint32_t)(((tap / 3) * ww + tap % 3) * 16);
    };
    const int q0 = cur.j * S.sps * 2;  // the stage's first k8 group
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < ec_max_sps(NT); ++i) {
      if (i < S.sps) {  // uniform across the block
        const int qa = q0 + 2 * i;
        const uint32_t oa = goff(qa);
        // the second k8 half: the next group, or (past the chunk's last)
        // the first half's own core matrix again: finite window values
        // against zero weights (a read past the window could meet a NaN)
        const uint32_t lbo = qa + 1 < groups ? goff(qa + 1) - oa : 0;
        const uint64_t db = ec_desc(wd + i * NT * 32, 128, 256);
        if constexpr (SWAP) {  // A: 64 output channels; B: 16 tile rows of 8 pixels
          wgmma_ss<128>(acc[0], db, ec_desc(wbase + oa, lbo, ww * 16));
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_ss<NT>(acc[mt], ec_desc(wbase + mt * 8 * ww * 16 + oa, lbo, ww * 16), db);
        }
      }
    }
    wgmma_commit();
    // the loads of the stage two on, while the tensor cores run (its slots
    // were last read by the previous stage, done before the barrier)
    issue(ahead);
    advance(ahead);
    wgmma_wait<0>();  // the next stage refills this stage's slots
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) reg_fence(acc[mt][i]);
  cp_wait<0>();
  __syncthreads();  // every warp is done with the rings: the sums go there

  // ---- epilogue: the f32 sums through shared memory, then per pixel and
  // 8 channels: + bias, ReLU (or the residual affine), bf16, 16-byte stores
  float* stg = reinterpret_cast<float*>(ec_smem);  // [TPIXc][SST]
  const int g = lane >> 2, t = lane & 3;
  if constexpr (SWAP) {
    // rows: output channels 16 wi + g (+ 8); columns: pixels 8 j + 2 t (+ 1)
    // of the warpgroup's 128, i.e. tile row j, columns 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          stg[((wg * 16 + j) * EC_TW + 2 * t + e) * SST + 16 * wi + g + 8 * half] =
              acc[0][4 * j + 2 * half + e];
  } else {
    // this thread's rows of m64 tile mt: M rows 16 wi + g (+ 8), i.e. tile
    // rows 2 wi (+ 1) of the tile, column g
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int px0 = ((wg * MT + mt) * 8 + 2 * wi) * EC_TW + g;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(stg + (px0 + half * EC_TW) * SST + 8 * j + 2 * t) =
              make_float2(acc[mt][4 * j + 2 * half], acc[mt][4 * j + 2 * half + 1]);
    }
  }
  __syncthreads();
  const int npc = a.cout / 8;
  for (int i = tid; i < TPIXc * npc; i += EC_THREADS) {
    const int px = i / npc, c0 = (i - px * npc) * 8;
    const int oh = oh0 + px / EC_TW, ow = ow0 + px % EC_TW;
    if (oh >= H || ow >= W) continue;
    const long long pix = img_base + (long long)oh * W + ow;
    const float4 s0 = *reinterpret_cast<const float4*>(stg + px * SST + c0);
    const float4 s1 = *reinterpret_cast<const float4*>(stg + px * SST + c0 + 4);
    const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float o[8];
    if (a.res != nullptr) {
      float r[8];
      unpack8(*reinterpret_cast<const uint4*>(a.res + pix * a.cout + c0), r);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = relu(__fadd_rn(__fadd_rn(__fmul_rn(r[e], a.res_a[c0 + e]), a.res_b[c0 + e]), v[e]));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = relu(v[e] + (a.bias != nullptr ? a.bias[c0 + e] : 0.f));
    }
    *reinterpret_cast<uint4*>(a.out + pix * a.cout + c0) =
        make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]), pack2(o[6], o[7]));
  }
}

template <int NT>
cudaError_t ec_launch(const EcArgs& a, unsigned blocks, int smem, cudaStream_t stream) {
  static bool attr = false;  // the shared-memory limit is set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        eval_conv_core<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, EC_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  eval_conv_core<NT><<<blocks, EC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One conv launch of the core over n images of h x wd (the output's, and
// the convs' zero-padding border). nseg K-segments: ptrs[i] [pixels][chans[i]]
// bf16 with kernel size ks[i] (3 or 1) and read mode modes[i] (null: all
// 0; 1: the source is (h/2) x wd, h even and >= 4; 2: it is 2h x 2wd); w:
// the packed weight of nsteps k16 steps for an N of nt (64, 128, 192 or
// 256; >= cout, cout a multiple of 8); bias f32 [cout] or null; res (with
// res_a, res_b) selects the residual epilogue. Returns the launch's
// cudaError_t.
int launch_eval_conv(int nseg, const void* const* ptrs, const int* chans, const int* ks,
                     const int* modes, int nt, const void* w, int nsteps, const void* bias,
                     const void* res, const void* res_a, const void* res_b, void* out, int n,
                     int h, int wd, int cout, cudaStream_t stream) {
  const bool residual = res != nullptr;
  if (nseg < 1 || nseg > EC_MAX_SEG || n <= 0 || h <= 0 || wd <= 0 || cout <= 0 ||
      cout % 8 != 0 || cout > nt || w == nullptr || (uintptr_t)w % 16 != 0 || out == nullptr ||
      (uintptr_t)out % 16 != 0 ||
      (residual && ((uintptr_t)res % 16 != 0 || res_a == nullptr || res_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (nt != 64 && nt != 128 && nt != 192 && nt != 256) return (int)cudaErrorInvalidValue;
  EcArgs a = {};
  const int th = ec_th(nt);
  int steps = 0, max_sps = 1, winslot = 0;
  for (int i = 0; i < nseg; ++i) {
    const int mode = modes == nullptr ? 0 : modes[i];
    if (ptrs[i] == nullptr || chans[i] <= 0 || (ks[i] != 1 && ks[i] != 3) || mode < 0 ||
        mode > 2 || (mode == 1 && (h % 2 != 0 || h < 4)))
      return (int)cudaErrorInvalidValue;
    EcSeg& s = a.seg[i];
    s.ptr = static_cast<const bf16*>(ptrs[i]);
    s.c = chans[i];
    s.ksize = ks[i];
    s.mode = mode;
    s.cc = chunk_channels(s.c);
    s.lg = s.cc == 8 ? 0 : s.cc == 16 ? 1 : 2;
    s.vec = s.c % 8 == 0 && (uintptr_t)ptrs[i] % 16 == 0;
    s.nchunk = (s.c + s.cc - 1) / s.cc;
    s.spc = ec_chunk_stages(s.cc, s.ksize, nt);
    s.sps = ec_chunk_steps(s.cc, s.ksize) / s.spc;
    steps += s.nchunk * s.spc * s.sps;
    if (s.sps > max_sps) max_sps = s.sps;
    const int hl = s.ksize == 3 ? 1 : 0;
    const int wsz = (s.cc / 8) * ec_plane_bytes((th + 2 * hl) * (EC_TW + 2 * hl));
    if (wsz > winslot) winslot = wsz;
  }
  if (steps != nsteps) return (int)cudaErrorInvalidValue;
  a.nseg = nseg;
  a.wt = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.res_a = static_cast<const float*>(res_a);
  a.res_b = static_cast<const float*>(res_b);
  a.out = static_cast<bf16*>(out);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.tiles_w = (wd + EC_TW - 1) / EC_TW;
  a.tiles_h = (h + th - 1) / th;
  a.wslot = max_sps * nt * 32;
  a.winslot = (winslot + 127) / 128 * 128;
  const long long blocks = (long long)n * a.tiles_h * a.tiles_w;
  const int main_bytes = EC_RING * (a.wslot + a.winslot);
  const int stage_bytes = th * EC_TW * (nt + 8) * 4;
  const int smem = main_bytes > stage_bytes ? main_bytes : stage_bytes;
  if (blocks > 0x7fffffffLL || smem > EC_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (nt) {
    case 64: e = ec_launch<64>(a, (unsigned)blocks, smem, stream); break;
    case 128: e = ec_launch<128>(a, (unsigned)blocks, smem, stream); break;
    case 192: e = ec_launch<192>(a, (unsigned)blocks, smem, stream); break;
    default: e = ec_launch<256>(a, (unsigned)blocks, smem, stream); break;
  }
  return (int)e;
}

}  // namespace
