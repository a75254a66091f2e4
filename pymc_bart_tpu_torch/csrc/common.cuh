// Shared device helpers of the PGBART kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
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

// order-preserving key of (value, row): larger value wins, then lower row
__device__ __forceinline__ unsigned long long pack_key(float v, int i) {
  unsigned int b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32)
      | (unsigned long long)(0xFFFFFFFFu - (unsigned int)i);
}

// Split decision for one row (ops/trees.py decide_left, with the kernel
// route's own-category test by float equality): NaN routes RIGHT.
__device__ __forceinline__ bool go_left(float x, float v, int salt, int rule) {
  const bool xnan = isnan(x);
  const bool anynan = xnan || isnan(v);
  const float xv = xnan ? 0.f : x;
  const bool cont = !anynan && xv <= v;
  const bool eq = !anynan && xv == v;
  if (rule == 0) return cont;
  if (rule == 1) return eq;
  const int cat = __float2int_rz(xv);  // saturating, as XLA's convert
  uint32_t h = (uint32_t)salt ^ ((uint32_t)cat * 1103515245u);
  h = (h ^ (h >> 15)) * 73244475u;
  h ^= h >> 13;
  return (eq || (h & 1u)) && !xnan;
}

}  // namespace bart
