// The s8 conv core on Hopper (sm_90a): launches A and B of the int8 fused
// eval stage (int8_stage.cu), the convs inside TPU kernel 7
// (ssunet_gan_tpu/ops/stage_kernel_int8.py fused_eval_stage_int8, body
// _make_kernel_int8):
//   A (QC_H1): h1 = relu(f32(conv3x3_s8(qx; Wq1)) * d1 + t1) -> bf16 over up
//              to two s8 parts, and the maximum of each image row of h1;
//   B (QC_Y):  y = relu(f32(conv3x3_s8(q_b(h1); Wq2)) * (d2 * s_b)
//                       + f32(conv1x1_s8(qx; Wqs)) * ds + t2) -> bf16, the
//              3x3 over the band-local q(h1) buffer that launch Q writes, the
//              1x1 shortcut over the parts.
//
// What bounds it on the H100: a 3x3 conv at 64-256 channels does 9 * C
// multiply-adds per s8 value read, far above the s8 ridge point (~590
// operations per byte), so both launches are bound by tensor-core
// operations; only the first stage's 3-channel conv is bound by bytes.
//
// The design is eval_conv.cuh's (the bf16 core) with bytes for elements:
//   - a block of two warpgroups (256 threads) owns a TH x 8 output tile of
//     one image and all output channels of its N block (launch A: one block
//     of up to 256 channels, the deep stages' 384-768 in blocks of <= 256,
//     as the bf16 core; launch B: blocks of <= 128). In launch B the tile
//     lies inside one band of h1's requantization (tiles are laid out band
//     by band), so a band shorter than TH (8 rows, or one band of H < TH
//     rows) leaves the tile's last rows idle;
//   - a source arrives in chunks of cc channels (16 or 32 whole for a narrow
//     source, else 64) as the tile's window in shared memory through
//     cp.async: (TH+2) x 10 pixels for a 3x3 source, TH x 8 for a 1x1 one,
//     stored as 16-channel planes of [pixel][16 bytes];
//   - a part may be a seam, read in its mode (QcSeg.mode, the TPU kernel's
//     _upsample_on_read_s8 and _pool_on_read_s8): mode 1 takes the decoder's
//     s8 half-height tensor, each window row the lerp of half rows
//     floor((p-1)/2) and the next with f32 weights (integer numerators over
//     one IEEE division), the two products and their sum rounded apart (no
//     FMA), rounded half to even and clipped to +-127; mode 2 an encoder's
//     full-resolution s8 input, each window pixel the byte-wise maximum of
//     its 2x2 window (exact). Both launches read them so: launch A's 3x3
//     windows with their halo, launch B's 1x1 shortcut windows. A seam piece
//     is plain loads that the thread waits on, then one 16-byte store into
//     the plane, before the stage's barrier;
//   - K runs over (tap, 16-channel group) pairs of a chunk, two per k32 step
//     of wgmma.mma_async m64nNk32.s32.s8.s8 (N 64, 128, 192 or 256), both
//     operands in shared memory and K-major, as 8-bit wgmma requires: A, the
//     pixels, a descriptor straight into the window (a tile row of 8 pixels
//     of one plane is one core matrix of 8 rows x 16 bytes, the next tile
//     row one window row further); B, the weights, packed once per model in
//     the order its descriptor reads ([N block][k32 step][N/8][k half][8
//     rows][16 K values]), a stage's slice landing with one bulk copy in a
//     3-slot ring. (The bf16 core's operand swap at N = 64 measured slower
//     here and is not used.);
//   - the sums are exact in s32. A zero weight times any window byte is 0,
//     but no descriptor may read past the window: a padded k32 half re-reads
//     the first half's core matrix;
//   - launch B needs two s32 sums, the shortcut's (dequantized by ds; its
//     segments come first in K) and the 3x3's (by d2 * s_b), in two
//     accumulators. Its N blocks are at most 128 wide (256 output channels
//     run as two blocks of 128, each loading the windows), so both take at
//     most 128 registers a thread. (Parking the shortcut's sums in shared
//     memory and running the 3x3 in the same registers measured 2-7% slower
//     on the H100.);
//   - the epilogue stages the s32 sums in shared memory, then per pixel and 8
//     channels dequantizes in f32, each step rounded on its own in the TPU
//     kernel's order (no FMA contraction), rounds to bf16 and stores 16
//     bytes. Launch A reduces each tile row's h1 (>= 0, so its float bits
//     order as ints) in shared memory and issues one atomicMax per tile row
//     and block into rowmax (zero on entry): the N blocks of one tile add
//     their channels to the same row maxima, so launch Q reads each row's
//     maximum over every channel.
// Everything is in an anonymous namespace.

#pragma once

#include "conv_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int QC_THREADS = 256;  // two warpgroups
constexpr int QC_RING = 3;       // stages: one being computed, two being loaded
constexpr int QC_MAX_SEG = 3;
constexpr int QC_TW = 8;         // tile columns: a tile row is one core matrix of A
constexpr int QC_SMEM = SMEM_MAX - 1024;  // dynamic shared memory (the mbarriers are static)

enum QcMode { QC_H1 = 0, QC_Y = 1 };

// The configuration of an instantiation, by N (the block's output channels,
// padded) and the launch: m64 pixel tiles per warpgroup (launch A at N <=
// 128: two; else one, so launch B's two accumulators fit); tile rows; blocks
// per SM (two where the accumulators take at most 64 registers); k32 steps
// of a stage, at most (a weight slot is this x N x 32 bytes).
__host__ __device__ constexpr int qc_mt(int nt, int mode) {
  return mode == QC_H1 && nt <= 128 ? 2 : 1;
}
__host__ __device__ constexpr int qc_th(int nt, int mode) { return 16 * qc_mt(nt, mode); }
__host__ __device__ constexpr int qc_blocks(int nt, int mode) {
  return qc_mt(nt, mode) * nt * (mode == QC_Y ? 2 : 1) <= 128 ? 2 : 1;
}
__host__ __device__ constexpr int qc_max_sps(int nt) { return nt <= 64 ? 6 : nt <= 128 ? 9 : 6; }

// 16-channel groups of a chunk: 16 or 32 channels whole for a narrow
// source, else 64
__host__ __device__ inline int qc_chunk_channels(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : 64; }
// k32 steps of a chunk of cc channels: its (tap, 16-channel group) pairs,
// two per step
__host__ __device__ inline int qc_chunk_steps(int cc, int ksize) {
  return ((ksize == 3 ? 9 : 1) * (cc / 16) + 1) / 2;
}
// stages of a chunk (each ends in a block barrier): a 64-channel 3x3 chunk
// (18 steps) in 2 or 3, a 32-channel one (9) in 1 or 3, the rest in 1
__host__ __device__ inline int qc_chunk_stages(int cc, int ksize, int nt) {
  const int steps = qc_chunk_steps(cc, ksize), m = qc_max_sps(nt);
  return steps <= m ? 1 : steps == 9 ? 3 : steps / m;
}
// bytes of one 16-channel plane of a window of wpix pixels: 16 bytes a
// pixel, the planes 16 bytes off a 128-byte line apart
__host__ __device__ inline int qc_plane_bytes(int wpix) { return (wpix * 16 + 127) / 128 * 128 + 16; }

struct QcSeg {
  const signed char* ptr;  // [m][c] of the source's own H x W (mode 1: H/2 x W; 2: 2H x 2W),
                           // or launch B's band-local q(h1) [n][nb][th + 2][w][c]
  int c, ksize;
  int mode;                // 0 plain, 1 up (s8 H-interpolation on read), 2 pool (s8 2x2 max)
  int cc, lg;              // channels per chunk, log2 of its 16-channel groups
  int vec;                 // 16-byte async copies allowed
  int band;                // ptr is the band-local buffer
  int nchunk, spc, sps;    // chunks, stages per chunk, k32 steps per stage
};

struct QcArgs {
  QcSeg seg[QC_MAX_SEG];
  int nseg;
  int nsplit;              // launch B: the 3x3's segment (the shortcut's come first)
  const signed char* wt;   // [N blocks][steps][NT/8][2][8][16]
  long long wblock;        // bytes of one N block's weight
  const float* v0;         // A: d1      B: d2
  const float* v1;         // A: t1      B: ds
  const float* v2;         //            B: t2
  const float* bandscale;  // B: [n][nb]
  int* rowmax;             // A: [n][h], the bits of non-negative floats
  bf16* out;               // [m][cout]
  int h, w, cout;
  int th, nb;              // rows per band (launch A: h), bands
  int tiles_w, tiles_b;    // tiles across W, tiles down one band
  int wslot, winslot;      // bytes of a weight stage slot, of a window slot
};

__device__ __forceinline__ QcSeg qc_seg(const QcArgs& a, int i) {
  return i == 0 ? a.seg[0] : i == 1 ? a.seg[1] : a.seg[2];
}

// Channels c0..c0+15 of pixel pix of a [pix][c] s8 tensor as one 16-byte
// piece: one 16-byte load when its rows are 16-byte pieces (vec), else byte
// by byte; zeros past c.
__device__ __forceinline__ uint4 qc_load(const signed char* base, int c, long long pix, int c0,
                                         bool vec) {
  if (vec)
    return c0 < c ? *reinterpret_cast<const uint4*>(base + pix * c + c0) : make_uint4(0, 0, 0, 0);
  uint32_t u[4] = {0u, 0u, 0u, 0u};
  const signed char* p = base + pix * c + c0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c0 + j < c) u[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// One window piece: channels c0..c0+15 of pixel pix of a [pix][c] s8 tensor
// into shared memory, through cp.async when the rows are 16-byte pieces
// (vec), else byte by byte; zeros past c and when !in.
__device__ __forceinline__ void qc_piece(signed char* dst, const signed char* base, int c,
                                         long long pix, int c0, bool in, bool vec) {
  if (vec) {
    const bool ok = in && c0 < c;
    cp16(dst, ok ? base + pix * c + c0 : base, ok);
    return;
  }
  *reinterpret_cast<uint4*>(dst) = in ? qc_load(base, c, pix, c0, false) : make_uint4(0, 0, 0, 0);
}

// four packed s8 values: clip(rint(a * w0 + b * w1), +-127) per byte, the
// products and the sum each rounded in f32
__device__ __forceinline__ uint32_t qc_lerp4(uint32_t a, uint32_t b, float w0, float w1) {
  uint32_t r = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x = (float)(signed char)(uint8_t)(a >> (8 * j));
    const float y = (float)(signed char)(uint8_t)(b >> (8 * j));
    const float v = fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(x, w0), __fmul_rn(y, w1))), -127.f), 127.f);
    r |= (uint32_t)(uint8_t)(signed char)(int)v << (8 * j);
  }
  return r;
}

// Channels c0..c0+15 of the seam segment S at pixel (ih, iw), inside the
// H x W image img: mode 1 interpolates rows j0 and j0 + 1 of its (H/2) x W
// source, mode 2 takes the 2x2 maximum of its 2H x 2W source.
__device__ __forceinline__ uint4 qc_seam_piece(const QcSeg& S, int img, int ih, int iw, int c0,
                                               int H, int W) {
  if (S.mode == 1) {
    const int hh = H >> 1, den = 2 * hh - 1;
    const int j0 = (ih + 1) / 2 - 1, j1 = j0 + 1;  // floor((ih - 1) / 2) for ih >= 0
    const float w1 = __fdiv_rn((float)(ih * (hh - 1) - j0 * den), (float)den);
    const float w0 = __fdiv_rn((float)(j1 * den - ih * (hh - 1)), (float)den);
    const long long row = (long long)img * hh * W + iw;
    const uint4 z = make_uint4(0, 0, 0, 0);
    const uint4 a = j0 >= 0 ? qc_load(S.ptr, S.c, row + (long long)j0 * W, c0, S.vec) : z;
    const uint4 b = j1 < hh ? qc_load(S.ptr, S.c, row + (long long)j1 * W, c0, S.vec) : z;
    return make_uint4(qc_lerp4(a.x, b.x, w0, w1), qc_lerp4(a.y, b.y, w0, w1),
                      qc_lerp4(a.z, b.z, w0, w1), qc_lerp4(a.w, b.w, w0, w1));
  }
  const long long tl = ((long long)img * 2 * H + 2 * ih) * (2 * W) + 2 * iw;
  const uint4 a = qc_load(S.ptr, S.c, tl, c0, S.vec);
  const uint4 b = qc_load(S.ptr, S.c, tl + 1, c0, S.vec);
  const uint4 c = qc_load(S.ptr, S.c, tl + 2 * W, c0, S.vec);
  const uint4 d = qc_load(S.ptr, S.c, tl + 2 * W + 1, c0, S.vec);
  return make_uint4(__vmaxs4(__vmaxs4(a.x, b.x), __vmaxs4(c.x, d.x)),
                    __vmaxs4(__vmaxs4(a.y, b.y), __vmaxs4(c.y, d.y)),
                    __vmaxs4(__vmaxs4(a.z, b.z), __vmaxs4(c.z, d.z)),
                    __vmaxs4(__vmaxs4(a.w, b.w), __vmaxs4(c.w, d.w)));
}

// Eight f32 values at p (16-byte aligned) as two 16-byte loads.
__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 u0 = *reinterpret_cast<const float4*>(p);
  const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
  f[0] = u0.x, f[1] = u0.y, f[2] = u0.z, f[3] = u0.w;
  f[4] = u1.x, f[5] = u1.y, f[6] = u1.z, f[7] = u1.w;
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk32, s32 += s8 x s8, A and B K-major in shared memory (matrix
// descriptors of wgmma.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n192(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t desc_a, uint64_t desc_b) {
  if constexpr (N == 64) wgmma_s8_n64(d, desc_a, desc_b);
  else if constexpr (N == 128) wgmma_s8_n128(d, desc_a, desc_b);
  else if constexpr (N == 192) wgmma_s8_n192(d, desc_a, desc_b);
  else wgmma_s8_n256(d, desc_a, desc_b);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int NT, int MODE>
__global__ void __launch_bounds__(QC_THREADS, qc_blocks(NT, MODE))
s8_conv_core(const QcArgs a) {
  constexpr int MT = qc_mt(NT, MODE);
  constexpr int THc = qc_th(NT, MODE);
  constexpr int TPIXc = THc * QC_TW;
  constexpr int NACC = NT / 2;  // s32 sums of one wgmma tile per thread
  constexpr int SST = NT + 8;   // s32 row stride of the staged sums
  static_assert(MODE == QC_H1 || NT <= 128, "launch B's N blocks are at most 128 wide");
  extern __shared__ __align__(128) unsigned char qc_smem[];
  __shared__ uint64_t wbar[QC_RING];              // a weight slot's bulk copy landed
  __shared__ int rmax[THc];                       // launch A: each tile row's max of h1
  unsigned char* wts = qc_smem;                   // [RING][wslot bytes]
  unsigned char* win = wts + QC_RING * a.wslot;   // [RING][winslot bytes]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.h, W = a.w;
  // the tile: column tile, tile within its band, band, image
  int rest = blockIdx.x;
  const int tw_i = rest % a.tiles_w;
  rest /= a.tiles_w;
  const int tb_i = rest % a.tiles_b;
  rest /= a.tiles_b;
  const int band = rest % a.nb;
  const int img = rest / a.nb;
  const long long img_base = (long long)img * H * W;
  const int oh0 = band * a.th + tb_i * THc, ow0 = tw_i * QC_TW;
  const int row_end = min(band * a.th + a.th, H);  // the tile's rows end here
  const int n0 = blockIdx.y * NT;                  // the N block's first output channel
  const signed char* wt = a.wt + blockIdx.y * a.wblock;

  // a walk over the stages: segment, chunk, stage of the chunk, the chunk's
  // running index (its window slot) and the stage's first k32 step
  struct Cursor {
    int s, sg, chunk, j, gchunk, k;
  };
  int nstage = 0;
#pragma unroll
  for (int i = 0; i < QC_MAX_SEG; ++i)
    if (i < a.nseg) nstage += a.seg[i].nchunk * a.seg[i].spc;
  auto advance = [&](Cursor& u) {
    const QcSeg S = qc_seg(a, u.sg);
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
  // stage, the chunk's window as 16-channel planes of [pixel][16] (zeros
  // outside the image, outside the band's rows and past the source's
  // channels)
  auto issue = [&](const Cursor& u) {
    if (u.s < nstage) {
      const QcSeg S = qc_seg(a, u.sg);
      if (tid == 0)
        bulk_load(wts + (u.s % QC_RING) * a.wslot, wt + (long long)u.k * (NT * 32),
                  S.sps * NT * 32, &wbar[u.s % QC_RING]);
      if (u.j == 0) {
        const int hl = S.ksize == 3 ? 1 : 0;
        const int ww = QC_TW + 2 * hl, wpix = (THc + 2 * hl) * ww;
        const int plane = qc_plane_bytes(wpix);
        signed char* wb = reinterpret_cast<signed char*>(win + (u.gchunk % QC_RING) * a.winslot);
        const int cb = u.chunk * S.cc;
        const int gmask = (1 << S.lg) - 1;
        for (int i = tid; i < wpix << S.lg; i += QC_THREADS) {
          const int px = i >> S.lg, grp = i & gmask;
          const int wr = px / ww, wc = px - wr * ww;
          const int ih = oh0 - hl + wr, iw = ow0 - hl + wc;
          bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
          signed char* dst = wb + grp * plane + px * 16;
          if (S.mode != 0) {
            *reinterpret_cast<uint4*>(dst) =
                in ? qc_seam_piece(S, img, ih, iw, cb + grp * 16, H, W) : make_uint4(0, 0, 0, 0);
            continue;
          }
          long long pix;
          if (S.band) {  // band row ih - band * th + 1 of [th + 2]
            const int r = ih - band * a.th + 1;
            in = in && r <= a.th + 1;
            pix = ((long long)(img * a.nb + band) * (a.th + 2) + r) * W + iw;
          } else {
            pix = img_base + (long long)ih * W + iw;
          }
          qc_piece(dst, S.ptr, S.c, pix, cb + grp * 16, in, S.vec);
        }
      }
    }
    cp_commit();  // an empty group past the end keeps the wait counts uniform
  };

  int acc[MT][NACC];
  int acc_s[MT][NACC];  // launch B: the shortcut's sums (unused in launch A)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      acc[mt][i] = 0;
      if constexpr (MODE == QC_Y) acc_s[mt][i] = 0;
    }

  const int wg = warp >> 2, wi = warp & 3;
  if (tid == 0) {
    for (int i = 0; i < QC_RING; ++i) mbar_init(&wbar[i]);
    mbar_init_fence();
  }
  if (MODE == QC_H1 && tid < THc) rmax[tid] = 0;  // read after the main loop's barriers
  __syncthreads();
  Cursor cur = {0, 0, 0, 0, 0, 0}, ahead = cur;
  for (int i = 0; i < QC_RING - 1; ++i) {
    issue(ahead);
    advance(ahead);
  }
  // one stage's k32 steps into the sums d (uniform across the block)
  auto run_stage = [&](int (&d)[MT][NACC], const QcSeg& S, uint32_t wbase, uint32_t wd) {
    const int ksz = S.ksize, hl = ksz == 3 ? 1 : 0;
    const int ww = QC_TW + 2 * hl;
    const uint32_t plane = qc_plane_bytes((THc + 2 * hl) * ww);
    const int ngrp = 1 << S.lg, groups = (ksz == 3 ? 9 : 1) << S.lg;
    // the window offset (bytes) of (tap, 16-channel group) pair q
    auto goff = [&](int q) -> uint32_t {
      const int tap = q >> S.lg, grp = q & (ngrp - 1);
      return grp * plane + (uint32_t)(((tap / 3) * ww + tap % 3) * 16);
    };
    const int q0 = cur.j * S.sps * 2;  // the stage's first pair
#pragma unroll
    for (int i = 0; i < qc_max_sps(NT); ++i) {
      if (i < S.sps) {
        const int qa = q0 + 2 * i;
        const uint32_t oa = goff(qa);
        // the second K half: the next pair, or (past the chunk's last) the
        // first half's own core matrix again, against zero weights
        const uint32_t lbo = qa + 1 < groups ? goff(qa + 1) - oa : 0;
        const uint64_t db = ec_desc(wd + i * NT * 32, 128, 256);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_s8<NT>(d[mt], ec_desc(wbase + mt * 8 * ww * 16 + oa, lbo, ww * 16), db);
      }
    }
  };
  for (; cur.s < nstage; advance(cur)) {
    cp_wait<QC_RING - 2>();
    fence_proxy_async();
    mbar_wait(&wbar[cur.s % QC_RING], (cur.s / QC_RING) & 1);
    __syncthreads();
    const QcSeg S = qc_seg(a, cur.sg);
    const int ww = QC_TW + 2 * (S.ksize == 3 ? 1 : 0);
    const uint32_t wbase = smem_u32(win + (cur.gchunk % QC_RING) * a.winslot) +
                           (uint32_t)(wg * (THc / 2) * ww * 16);
    const uint32_t wd = smem_u32(wts + (cur.s % QC_RING) * a.wslot);
    wgmma_fence();
    if (MODE == QC_Y && cur.sg < a.nsplit)
      run_stage(acc_s, S, wbase, wd);
    else
      run_stage(acc, S, wbase, wd);
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
    for (int i = 0; i < NACC; ++i) {
      reg_fence(acc[mt][i]);
      if constexpr (MODE == QC_Y) reg_fence(acc_s[mt][i]);
    }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the rings: the sums go there

  // ---- epilogue: the s32 sums through shared memory ([sums][TPIXc][SST]),
  // then per pixel and 8 channels: dequantize, ReLU, bf16, 16-byte stores
  const int g = lane >> 2, t = lane & 3;
  // this thread's sums d into a [TPIXc][SST] area: rows of m64 tile mt are M
  // rows 16 wi + g (+ 8), i.e. tile rows 2 wi (+ 1) of the tile, column g
  auto stage_sums = [&](int* st, const int (&d)[MT][NACC]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int px0 = ((wg * MT + mt) * 8 + 2 * wi) * QC_TW + g;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<int2*>(st + (px0 + half * QC_TW) * SST + 8 * j + 2 * t) =
              make_int2(d[mt][4 * j + 2 * half], d[mt][4 * j + 2 * half + 1]);
    }
  };
  int* stg = reinterpret_cast<int*>(qc_smem);  // over the rings: [the 3x3's, the shortcut's]
  stage_sums(stg, acc);
  if constexpr (MODE == QC_Y) stage_sums(stg + TPIXc * SST, acc_s);
  __syncthreads();
  const int nout = min(NT, a.cout - n0);  // this N block's output channels
  const int npc = nout / 8;
  const float sc = MODE == QC_Y ? a.bandscale[img * a.nb + band] : 0.f;
  const int total = TPIXc * npc;
  for (int base = 0; base < total; base += QC_THREADS) {
    const int i = base + tid;
    const int px = i / npc, c0 = (i - px * npc) * 8;
    const int oh = oh0 + px / QC_TW, ow = ow0 + px % QC_TW;
    const bool valid = i < total && oh < row_end && ow < W;
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const int* s0 = stg + px * SST + c0;
      const int4 u0 = *reinterpret_cast<const int4*>(s0);
      const int4 u1 = *reinterpret_cast<const int4*>(s0 + 4);
      const int v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const int ch = n0 + c0;
      float k0[8], k1[8];
      load8f(a.v0 + ch, k0);
      load8f(a.v1 + ch, k1);
      if constexpr (MODE == QC_Y) {
        const int* s1 = s0 + TPIXc * SST;
        const int4 w0 = *reinterpret_cast<const int4*>(s1);
        const int4 w1 = *reinterpret_cast<const int4*>(s1 + 4);
        const int vs[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        float k2[8];
        load8f(a.v2 + ch, k2);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a2 = __fmul_rn(__int2float_rn(v[e]), __fmul_rn(k0[e], sc));
          const float as = __fmul_rn(__int2float_rn(vs[e]), k1[e]);
          o[e] = relu(__fadd_rn(__fadd_rn(a2, as), k2[e]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = relu(__fadd_rn(__fmul_rn(__int2float_rn(v[e]), k0[e]), k1[e]));
      }
      const long long pix = img_base + (long long)oh * W + ow;
      const uint4 packed =
          make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]), pack2(o[6], o[7]));
      *reinterpret_cast<uint4*>(a.out + pix * a.cout + ch) = packed;
      if constexpr (MODE == QC_H1) {  // the stored (bf16-rounded) values
        float f[8];
        unpack8(packed, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = f[e];
      }
    }
    if constexpr (MODE == QC_H1) {
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, o[e]);
      // one shared atomic per warp where its pieces share a tile row
      const int row = valid ? px / QC_TW : -1;
      const int row0 = __shfl_sync(0xffffffffu, row, 0);
      int bits = __float_as_int(m);
      if (__all_sync(0xffffffffu, row == row0)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
        if (lane == 0 && row0 >= 0 && bits > 0) atomicMax(&rmax[row0], bits);
      } else if (row >= 0 && bits > 0) {
        atomicMax(&rmax[row], bits);
      }
    }
  }
  if constexpr (MODE == QC_H1) {
    __syncthreads();
    if (tid < THc) {
      const int oh = oh0 + tid;
      if (oh < row_end && rmax[tid] > 0) atomicMax(a.rowmax + (long long)img * H + oh, rmax[tid]);
    }
  }
}

template <int NT, int MODE>
cudaError_t qc_launch(const QcArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  static bool attr = false;  // the shared-memory limit is set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        s8_conv_core<NT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, QC_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  s8_conv_core<NT, MODE><<<grid, QC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One launch of the core over n images of h x wd (the output's). nseg
// K-segments: ptrs[i] s8 [m][chans[i]] (or, with band[i], the band-local
// buffer [n][nb][th + 2][w][chans[i]]) with kernel size ks[i] and read mode
// modes[i] (0; 1: the source is (h/2) x wd, h even and >= 4; 2: it is 2h x
// 2wd; a band segment reads in mode 0); in launch B the segments before
// nsplit (the shortcut's) are summed apart from the rest (the 3x3's). w: the
// packed weight, nblk N blocks of nsteps k32 steps for an N of nt; v0..v2,
// bandscale, rowmax, out as in QcArgs. Returns the launch's cudaError_t.
int launch_s8_conv(int mode, int nseg, const void* const* ptrs, const int* chans, const int* ks,
                   const int* modes, const int* band, int nsplit, int nt, const void* w, int nsteps,
                   int nblk, const void* v0, const void* v1, const void* v2,
                   const void* bandscale, void* rowmax, void* out, int n, int h, int wd,
                   int cout, int th, cudaStream_t stream) {
  if (nseg < 1 || nseg > QC_MAX_SEG || n <= 0 || h <= 0 || wd <= 0 || cout <= 0 ||
      cout % 8 != 0 || nblk < 1 || cout > nt * nblk || cout <= nt * (nblk - 1) ||
      w == nullptr || (uintptr_t)w % 16 != 0 || out == nullptr || (uintptr_t)out % 16 != 0 ||
      v0 == nullptr || v1 == nullptr || th <= 0 || h % th != 0 ||
      ((uintptr_t)v0 | (uintptr_t)v1 | (uintptr_t)v2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bool y = mode == QC_Y;
  if (mode != QC_H1 && mode != QC_Y) return (int)cudaErrorInvalidValue;
  if (y ? (v2 == nullptr || bandscale == nullptr || nsplit < 1 || nsplit != nseg - 1 ||
           (nt != 64 && nt != 128))
        : (rowmax == nullptr || th != h ||
           (nt != 64 && nt != 128 && nt != 192 && nt != 256)))
    return (int)cudaErrorInvalidValue;
  QcArgs a = {};
  const int tile_h = qc_th(nt, mode);
  int steps = 0, max_sps = 1, winslot = 0;
  for (int i = 0; i < nseg; ++i) {
    if (ptrs[i] == nullptr || chans[i] <= 0 || (ks[i] != 1 && ks[i] != 3) ||
        (band[i] != (y && i == nsplit)) || (y && (i < nsplit) != (ks[i] == 1)) ||
        modes[i] < 0 || modes[i] > 2 || (band[i] && modes[i] != 0) ||
        (modes[i] == 1 && (h % 2 != 0 || h < 4)))
      return (int)cudaErrorInvalidValue;
    QcSeg& s = a.seg[i];
    s.ptr = static_cast<const signed char*>(ptrs[i]);
    s.c = chans[i];
    s.ksize = ks[i];
    s.mode = modes[i];
    s.band = band[i];
    s.cc = qc_chunk_channels(s.c);
    s.lg = s.cc == 16 ? 0 : s.cc == 32 ? 1 : 2;
    s.vec = s.c % 16 == 0 && (uintptr_t)ptrs[i] % 16 == 0;
    s.nchunk = (s.c + s.cc - 1) / s.cc;
    s.spc = qc_chunk_stages(s.cc, s.ksize, nt);
    s.sps = qc_chunk_steps(s.cc, s.ksize) / s.spc;
    steps += s.nchunk * s.spc * s.sps;
    if (s.sps > max_sps) max_sps = s.sps;
    const int hl = s.ksize == 3 ? 1 : 0;
    const int wsz = (s.cc / 16) * qc_plane_bytes((tile_h + 2 * hl) * (QC_TW + 2 * hl));
    if (wsz > winslot) winslot = wsz;
  }
  if (steps != nsteps) return (int)cudaErrorInvalidValue;
  a.nseg = nseg;
  a.nsplit = y ? nsplit : nseg;
  a.wt = static_cast<const signed char*>(w);
  a.wblock = (long long)nsteps * nt * 32;
  a.v0 = static_cast<const float*>(v0);
  a.v1 = static_cast<const float*>(v1);
  a.v2 = static_cast<const float*>(v2);
  a.bandscale = static_cast<const float*>(bandscale);
  a.rowmax = static_cast<int*>(rowmax);
  a.out = static_cast<bf16*>(out);
  a.h = h;
  a.w = wd;
  a.cout = cout;
  a.th = th;
  a.nb = h / th;
  a.tiles_w = (wd + QC_TW - 1) / QC_TW;
  a.tiles_b = (th + tile_h - 1) / tile_h;
  a.wslot = max_sps * nt * 32;
  a.winslot = (winslot + 127) / 128 * 128;
  const long long blocks = (long long)n * a.nb * a.tiles_b * a.tiles_w;
  const int main_bytes = QC_RING * (a.wslot + a.winslot);
  const int stage_bytes = tile_h * QC_TW * (nt + 8) * 4 * (y ? 2 : 1);
  const int smem = main_bytes > stage_bytes ? main_bytes : stage_bytes;
  if (blocks > 0x7fffffffLL || smem > QC_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)nblk);
  cudaError_t e;
  if (y) {
    e = nt == 128 ? qc_launch<128, QC_Y>(a, grid, smem, stream)
                  : qc_launch<64, QC_Y>(a, grid, smem, stream);
  } else {
    switch (nt) {
      case 64: e = qc_launch<64, QC_H1>(a, grid, smem, stream); break;
      case 128: e = qc_launch<128, QC_H1>(a, grid, smem, stream); break;
      case 192: e = qc_launch<192, QC_H1>(a, grid, smem, stream); break;
      default: e = qc_launch<256, QC_H1>(a, grid, smem, stream); break;
    }
  }
  return (int)e;
}

}  // namespace
