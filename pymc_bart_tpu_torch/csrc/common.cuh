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

// ---------------------------------------------------------------------------
// float64 sums in a fixed order
// ---------------------------------------------------------------------------

// Sum over the lanes of a warp by a shuffle tree; every lane gets the total.
__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// sums and maxima keyed by node, taken by warps
// ---------------------------------------------------------------------------

// Sums keyed by node are taken in FIXED POINT: a value v becomes the integer
// round(v * 2^k), with k chosen so that the largest |v| of its kind has 38
// bits (row counts below 2^24 then fit 63 bits).  Integer addition has no
// order, so the sums are the same bits from run to run whatever the order of
// the atomics, and the same bits as the plain version's
// (ops/sums.py::keyed_sum_fixed, keyed_isum: the same scales); their error
// (2^-39 of the largest value per row) is far below a float32 sum's in any
// order.  ``v`` is a float32 value, or an exact float64 product of two.
__device__ __forceinline__ long long to_fixed(double v, double scale) {
  return __double2ll_rn(v * scale);
}

// Sum of q over the lanes of ``peers`` (every lane of the group calls it with
// the same mask): two 32-bit warp reductions of the high and low 20 bits.
__device__ __forceinline__ long long group_sum(unsigned int peers, long long q) {
  const int hi = __reduce_add_sync(peers, (int)(q >> 20));
  const unsigned int lo = __reduce_add_sync(peers, (unsigned int)(q & 0xFFFFF));
  return (long long)hi * (1LL << 20) + (long long)lo;
}

// Adds q to acc[key] (and 1 to cnt[key]) for every lane with key >= 0: the
// lanes with one key are found by a match, their values added by group_sum,
// and the lowest lane of the group makes one atomic add.  All 32 lanes call.
__device__ __forceinline__ void keyed_add(int key, long long q, long long* acc,
                                          int* cnt, int lane) {
  const unsigned int peers = __match_any_sync(0xffffffffu, key);
  const long long sum = group_sum(peers, q);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd((unsigned long long*)&acc[key], (unsigned long long)sum);
    if (cnt) atomicAdd(&cnt[key], __popc(peers));
  }
}

// Raises best[node] to the largest key among the lanes with that node
// (node < 0: no key): a match, one 32-bit warp maximum of the value word, and
// one atomic by the lowest lane that holds it (the lowest row of the warp).
__device__ __forceinline__ void keyed_max(int node, unsigned long long key,
                                          unsigned long long* best, int lane) {
  const unsigned int peers = __match_any_sync(0xffffffffu, node);
  const unsigned int hi = (unsigned int)(key >> 32);
  const unsigned int top = __reduce_max_sync(peers, hi);
  const unsigned int win = __ballot_sync(0xffffffffu, node >= 0 && hi == top) & peers;
  if (node >= 0 && lane == __ffs(win) - 1) atomicMax(&best[node], key);
}

// ---------------------------------------------------------------------------
// row Gumbels generated in the kernel
// ---------------------------------------------------------------------------

// Philox-4x32-10, first output word.
__device__ __forceinline__ unsigned int philox(unsigned int c0, unsigned int c1,
                                               unsigned int k0, unsigned int k1) {
  unsigned int c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned int hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0; c1 = lo1; c2 = hi0 ^ c3 ^ k1; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return c0;
}

// Gumbel of (row, stream): u = (bits >> 9 + 0.5) 2^-23, exact in float32 and
// inside [2^-24, 1 - 2^-24].  (With 24 bits the top value plus one half rounds
// to 2^24, u becomes 1 and the Gumbel +inf once in 2^24 draws.)
__device__ __forceinline__ float gen_gumbel(unsigned int k0, unsigned int k1,
                                            int row, unsigned int stream) {
  const unsigned int bits = philox((unsigned int)row, stream, k0, k1);
  const float u = ((float)(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
  return -logf(-logf(u));
}

// Stream of the row Gumbels of tree b, level d, particle q = c * P + pi; the
// counter of one draw is (row, stream), so a value depends on neither the
// grid nor the kernel that asks for it.
__device__ __forceinline__ unsigned int gumbel_stream(int b, int d, int D,
                                                      int CP, int q) {
  return (unsigned int)((b * D + d) * CP + q);
}

// ---------------------------------------------------------------------------
// SMC bookkeeping of one chain between two growth rounds, on ONE warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// log_w += ll - ll_prev; then, when `gate` (every level but the last): the
// softmax over the non-frozen particles 1..P-1, the ESS < (P-1)/2 gate, the
// systematic ancestors with the +1 frozen offset, the reset to the log-mean
// weight and ll gathered at the ancestors.  lw, llp, take are updated in
// place; cdf and prob are scratch; all arrays hold P entries that the warp
// can read and write (shared or global memory).  Called by all 32 lanes.
// Up to 32 particles sit one to a lane and every lane takes the three running
// sums (softmax total, sum of squares, CDF) over broadcasts of the lanes'
// values; more particles go through memory.  Either way the sums are float32
// additions in INDEX order, the order of the plain PyTorch version
// (ops/sums.py::seq_sum, seq_cumsum), so every warp and the plain version get
// the same bits from the same inputs.  Products are rounded before they are
// added (no fused multiply-add), as PyTorch rounds them.
__device__ __forceinline__ void smc_warp(float* __restrict__ lw,
                                         float* __restrict__ llp,
                                         const float* __restrict__ ll,
                                         float* __restrict__ cdf,
                                         float* __restrict__ prob,
                                         int* __restrict__ take, int P,
                                         float uu, bool gate) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (P <= 32) {
    const bool in = lane < P, free = lane >= 1 && in;
    const float ll_i = in ? ll[lane] : 0.f;
    float lw_i = in ? lw[lane] + ll_i - llp[lane] : 0.f;
    int tk = lane;
    if (gate) {
      const float mx = warp_max_f(free ? lw_i : -INFINITY);
      const float e = free ? expf(lw_i - mx) : 0.f;
      // (short unrolling: a fully unrolled loop keeps its 31 broadcasts in
      // registers, which costs the row kernels that inline this function
      // their occupancy)
      float tot = 0.f;
#pragma unroll 4
      for (int j = 1; j < P; ++j) tot += __shfl_sync(full, e, j);
      const float pr = e / tot;
      float sumsq = 0.f, run = 0.f, run_i = 0.f;
#pragma unroll 4
      for (int j = 1; j < P; ++j) {
        const float p_j = __shfl_sync(full, pr, j);
        sumsq = __fadd_rn(sumsq, __fmul_rn(p_j, p_j));
        run += p_j;
        if (lane == j) run_i = run;
      }
      const float c_i = run_i / run;  // lane 0: 0, as the CDF starts
      const float log_mean = mx + logf(tot / (float)(P - 1));
      const float ess = 1.f / fmaxf(sumsq, 1e-38f);
      if (ess < 0.5f * (float)(P - 1)) {  // the same in every lane
        const float pos = (uu + (float)(lane - 1)) / (float)(P - 1);
        int cnt = 0;  // searchsorted 'left' into the non-frozen CDF
#pragma unroll
        for (int j = 1; j < 32; ++j) {
          const float c_j = __shfl_sync(full, c_i, j);
          cnt += (j < P && c_j < pos) ? 1 : 0;
        }
        if (free) {
          tk = min(max(cnt + 1, 1), P - 1);
          lw_i = log_mean;
        }
      }
    }
    const float llp_i = __shfl_sync(full, ll_i, tk);
    if (in) {
      lw[lane] = lw_i;
      take[lane] = tk;
      if (gate) llp[lane] = llp_i;
    }
    __syncwarp();
    return;
  }
  for (int i = lane; i < P; i += 32) {
    lw[i] = lw[i] + ll[i] - llp[i];
    take[i] = i;
  }
  __syncwarp();
  if (!gate) return;
  float mx = -INFINITY;
  for (int i = 1 + lane; i < P; i += 32) mx = fmaxf(mx, lw[i]);
  mx = warp_max_f(mx);
  for (int i = 1 + lane; i < P; i += 32) prob[i] = expf(lw[i] - mx);
  __syncwarp();
  float tot = 0.f;
#pragma unroll 4
  for (int i = 1; i < P; ++i) tot += prob[i];
  __syncwarp();
  for (int i = 1 + lane; i < P; i += 32) prob[i] = prob[i] / tot;
  __syncwarp();
  float sumsq = 0.f, run = 0.f;
#pragma unroll 4
  for (int i = 1; i < P; ++i) {
    const float pr = prob[i];
    sumsq = __fadd_rn(sumsq, __fmul_rn(pr, pr));
    run += pr;
    if (lane == 0) cdf[i] = run;
  }
  const float last = run;
  __syncwarp();
  for (int i = lane; i < P; i += 32) cdf[i] = (i == 0 ? 0.f : cdf[i]) / last;
  __syncwarp();
  const float log_mean = mx + logf(tot / (float)(P - 1));
  const float ess = 1.f / fmaxf(sumsq, 1e-38f);
  if (ess < 0.5f * (float)(P - 1)) {
    for (int i = 1 + lane; i < P; i += 32) {
      const float pos = (uu + (float)(i - 1)) / (float)(P - 1);
      int cnt = 0;  // searchsorted 'left' into the non-frozen CDF
#pragma unroll 4
      for (int j = 1; j < P; ++j) cnt += (cdf[j] < pos) ? 1 : 0;
      take[i] = min(max(cnt + 1, 1), P - 1);
      lw[i] = log_mean;
    }
  }
  __syncwarp();
  for (int i = lane; i < P; i += 32) llp[i] = ll[take[i]];
  __syncwarp();
}

// Winner of a chain by inverse CDF over exp(log_w - max): the number of
// prefix sums below u times the total, clamped to a particle.  One warp,
// every lane returns it; prob is scratch of P entries.
__device__ __forceinline__ int winner_warp(const float* __restrict__ lw,
                                           float* __restrict__ prob, int P,
                                           float u) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  if (P <= 32) {
    const bool in = lane < P;
    const float mx = warp_max_f(in ? lw[lane] : -INFINITY);
    const float e = in ? expf(lw[lane] - mx) : 0.f;
    float tot = 0.f;
#pragma unroll 4
    for (int j = 0; j < P; ++j) tot += __shfl_sync(full, e, j);
    const float uu = u * tot;
    float run = 0.f;
#pragma unroll 4
    for (int j = 0; j < P; ++j) {  // prefix sums in index order, in every lane
      run += __shfl_sync(full, e, j);
      cnt += (run < uu) ? 1 : 0;
    }
  } else {
    float mx = -INFINITY;
    for (int i = lane; i < P; i += 32) mx = fmaxf(mx, lw[i]);
    mx = warp_max_f(mx);
    for (int i = lane; i < P; i += 32) prob[i] = expf(lw[i] - mx);
    __syncwarp();
    float tot = 0.f;
#pragma unroll 4
    for (int i = 0; i < P; ++i) tot += prob[i];
    const float uu = u * tot;
    float run = 0.f;
#pragma unroll 4
    for (int i = 0; i < P; ++i) {
      run += prob[i];
      cnt += (run < uu) ? 1 : 0;
    }
    __syncwarp();
  }
  return min(max(cnt, 0), P - 1);
}

}  // namespace bart
