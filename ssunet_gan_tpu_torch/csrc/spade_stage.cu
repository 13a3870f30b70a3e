// Standalone self-SPADE stage on Hopper (sm_90a): the port of the TPU
// kernel ssunet_gan_tpu/ops/spade_kernel.py fused_spade_stage (_stage_core
// -> pl.pallas_call, body _stage_kernel, a halo assembly around
// _spade_tail).
//
// On one NHWC tensor x, in one launch:
//   seg  = conv3x3(x; K1) + b1          (C -> labels)
//   act  = relu(conv3x3(seg; K2) + b2)  (labels -> hidden)
//   g|b  = conv3x3(act; Kg|Kb) + bg|bb  (hidden -> 2C)
//   out  = x*(1 + g) + b
// x is read twice (the 22x22 halo window for seg, the 16x16 tile for the
// modulate) and out written once; seg, act and g|b stay in shared memory
// and registers. The TPU kernel's own body is the same tail the fused
// stages end with, and so is this one: spade_tail_kernel of
// stage_common.cuh without a head and without saves.
//
// What bounds it on the H100: 2*(9*C*labels + 9*labels*hidden +
// 18*hidden*C) operations a pixel over 4*C bytes a pixel is about 40 FLOP
// a byte at C = 64, hidden = 4, far under the ridge point: bound by bytes.
// seg and g|b run on mma.sync tensor cores, act on f32 FMAs (see
// stage_common.cuh).
//
// Numerics follow the TPU kernel: each conv zero-pads its own input at the
// image border, sums run in f32, seg, act and g|b are rounded to bf16, the
// modulate runs in bf16 one operation at a time.
//
// Plain C interface (loaded with ctypes); returns the launch's cudaError_t.

#include "stage_common.cuh"

extern "C" {

// The operands as ops/stage_kernel.py pack_spade lays them out: k1t bf16
// [8][9][c], k2s f32 [9][lab][nh], kgbt bf16 [2c][K] (g and b interleaved per
// 8 channels), biases f32.
int ssu_spade_stage(const void* x, int n, int h, int wd, int c, const void* k1t,
                    const void* b1s, int lab, const void* k2s, const void* b2s, int nh,
                    const void* kgbt, const void* bgb, void* out, void* stream) {
  return launch_spade_tail(x, n, h, wd, c, k1t, b1s, lab, k2s, b2s, nh, kgbt, bgb, nullptr,
                           nullptr, 0, out, nullptr, nullptr, stream);
}

}  // extern "C"
