// Shared device code of the port's train kernels (train_bwd.cu through
// bwd_core.cuh, and train_f32.cu): the reduction of the conv cores'
// per-block sums (one block per channel and stat row, no same-address
// atomics from thousands of blocks). It needs nothing of stage_common.cuh,
// whose bf16 helpers the f32 sources do not take. Everything is in an
// anonymous namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

// stats[s][c] = sum over blocks of partial[s][c][b]; one block per (c, s).
// The block partials are summed in f64, in a fixed order: the batch
// statistics and bias gradients built from these sums (up to ~16k block
// partials of a sum that may cancel) keep f32 accuracy and come out the same
// from run to run.
constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(RED_THREADS)
stats_reduce_kernel(const float* partial, long long nb, int cout, float* stats) {
  __shared__ double sm[RED_THREADS];
  const int c = blockIdx.x, s = blockIdx.y;
  const float* p = partial + ((long long)s * cout + c) * nb;
  double v = 0.0;
  for (long long b = threadIdx.x; b < nb; b += RED_THREADS) v += p[b];
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int k = RED_THREADS / 2; k > 0; k >>= 1) {
    if ((int)threadIdx.x < k) sm[threadIdx.x] += sm[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[s * cout + c] = (float)sm[0];
}

}  // namespace
