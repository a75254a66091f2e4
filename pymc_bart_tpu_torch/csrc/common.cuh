// Shared device helpers of the PGBART kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bart {

constexpr int kThreads = 256;

// Block-wide sum in a FIXED order: a shuffle tree inside each warp, then the
// warp partials added in warp order by thread 0.  Every thread gets the
// total.  ``scratch`` holds 32 floats of shared memory.  The same inputs
// always give the same bits, so the discrete decisions that depend on the
// sum (ESS gate, Metropolis accept) do not flip from run to run.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read from a previous call
  if (l == 0) scratch[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    const int nw = (blockDim.x + 31) >> 5;
    for (int i = 0; i < nw; ++i) tot += scratch[i];
    scratch[0] = tot;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace bart
