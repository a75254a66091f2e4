// smc_resample: the SMC bookkeeping between two growth rounds, for all chains.
//
// Replaces the TPU kernel pymc_bart_tpu/ops/smc_pallas.py::smc_resample_pallas:
// log_w += ll - ll_prev; softmax over the non-frozen particles 1..P-1; the
// ESS < (P-1)/2 gate; systematic ancestors with the +1 frozen offset; reset
// to the log-mean weight; ll gathered at the ancestors.
//
// Bound: launch latency (a few hundred bytes per chain).  Design: one warp
// per chain runs bart::smc_warp, the device function the whole-step kernels
// use, on a copy of the chain's weights in shared memory: its sums over the
// particles are float32 additions in index order, as the plain version's.
#include "common.cuh"

namespace {

extern __shared__ float smem_f[];

__global__ void smc_resample_kernel(const float* ll, const float* llp,
                                    const float* lw, const float* u,
                                    float* lw_o, int* take_o, float* llp_o,
                                    int P) {
  const int c = blockIdx.x, lane = threadIdx.x;
  ll += (size_t)c * P; llp += (size_t)c * P; lw += (size_t)c * P;
  lw_o += (size_t)c * P; take_o += (size_t)c * P; llp_o += (size_t)c * P;
  float* lw1 = smem_f;        // P log-weights, updated in place
  float* llp1 = lw1 + P;      // P previous log-likelihoods, likewise
  float* cdf = llp1 + P;      // P scratch
  float* prob = cdf + P;      // P scratch
  int* take = (int*)(prob + P);

  for (int i = lane; i < P; i += 32) { lw1[i] = lw[i]; llp1[i] = llp[i]; }
  __syncwarp();
  bart::smc_warp(lw1, llp1, ll, cdf, prob, take, P, u[c], true);
  for (int i = lane; i < P; i += 32) {
    lw_o[i] = lw1[i];
    take_o[i] = take[i];
    llp_o[i] = llp1[i];
  }
}

}  // namespace

extern "C" int smc_resample_launch(const float* ll, const float* llp,
                                   const float* lw, const float* u,
                                   float* lw_o, int* take_o, float* llp_o,
                                   int C, int P, void* stream) {
  const size_t bytes = sizeof(float) * 5 * (size_t)P;
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  smc_resample_kernel<<<C, 32, bytes, (cudaStream_t)stream>>>(
      ll, llp, lw, u, lw_o, take_o, llp_o, P);
  return (int)cudaGetLastError();
}
