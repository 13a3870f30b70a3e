// What the port's two Hopper conv cores share, bwd_core.cuh (the train
// kernels, mma.sync) and eval_conv.cuh (the eval stages' convs and the
// train tail's residual conv, wgmma): a block owns a spatial tile of one
// image and a source arrives in chunks of channels as the tile's window in
// shared memory (with a one-pixel halo for a 3x3 conv), its K dimension
// running over (tap, 8-channel group) pairs of a chunk, so the nine taps
// are shifted reads of one window and a narrow source packs its taps into
// K. Here: the chunk widths, the element-wise window loader for sources
// whose rows are not 16-byte pieces, and the shared-memory limit.
// Everything is in an anonymous namespace.

#pragma once

#include "stage_common.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block (227 KB)

// Eight channels c0..c0+7 of pixel pix of a [pix][c] tensor into shared
// memory element by element (sources whose rows are not 16-byte pieces);
// zeros past c and when !valid.
__device__ __forceinline__ void scalar8(bf16* dst, const bf16* base, int c, long long pix,
                                        int c0, bool valid) {
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(base) + pix * c + c0;
  unsigned short e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = (valid && c0 + j < c) ? ps[j] : 0;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                 e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
}

// One window piece: channels c0..c0+7 of pixel pix of a [pix][c] tensor
// into shared memory, through cp.async when the rows are 16-byte pieces
// (vec), else element by element; zeros past c and when !in (outside the
// image: the conv's zero padding).
__device__ __forceinline__ void copy_piece(bf16* dst, const bf16* base, int c, long long pix,
                                           int c0, bool in, bool vec) {
  if (vec) {
    const bool ok = in && c0 < c;
    cp16(dst, ok ? base + pix * c + c0 : base, ok);
  } else {
    scalar8(dst, base, c, pix, c0, in);
  }
}

// Channels per chunk of a source of c channels: 8 or 16 for a narrow one
// (taps x channels packed), else 32.
__host__ __device__ inline int chunk_channels(int c) { return c <= 8 ? 8 : c <= 16 ? 16 : 32; }

}  // namespace
