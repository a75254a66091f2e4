// smc_resample: the SMC bookkeeping between two growth rounds, for all chains.
//
// Replaces the TPU kernel pymc_bart_tpu/ops/smc_pallas.py::smc_resample_pallas:
// log_w += ll - ll_prev; softmax over the non-frozen particles 1..P-1; the
// ESS < (P-1)/2 gate; systematic ancestors with the +1 frozen offset; reset
// to the log-mean weight; ll gathered at the ancestors.
//
// Bound: launch latency (a few hundred bytes per chain).  Design: one warp
// per chain; lanes do the element-wise parts, lane 0 does the max, the sum
// and the prefix sum sequentially in index order so that the CDF matches a
// plain cumsum and never changes from run to run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

extern __shared__ float smem_f[];

__global__ void smc_resample_kernel(const float* ll, const float* llp,
                                    const float* lw, const float* u,
                                    float* lw_o, int* take_o, float* llp_o,
                                    int P) {
  const int c = blockIdx.x, lane = threadIdx.x;
  ll += (size_t)c * P; llp += (size_t)c * P; lw += (size_t)c * P;
  lw_o += (size_t)c * P; take_o += (size_t)c * P; llp_o += (size_t)c * P;
  float* lw1 = smem_f;        // P updated log-weights
  float* cdf = lw1 + P;       // P normalized CDF over slots 1..P-1 (cdf[0]=0)
  float* sc = cdf + P;        // [0] log_mean, [1] do-resample flag

  for (int i = lane; i < P; i += 32) lw1[i] = lw[i] + ll[i] - llp[i];
  __syncwarp();
  if (lane == 0) {
    float mx = -INFINITY;
    for (int i = 1; i < P; ++i) mx = fmaxf(mx, lw1[i]);
    float tot = 0.f;
    for (int i = 1; i < P; ++i) { const float e = expf(lw1[i] - mx); cdf[i] = e; tot += e; }
    float sumsq = 0.f, run = 0.f;
    cdf[0] = 0.f;
    for (int i = 1; i < P; ++i) {
      const float pr = cdf[i] / tot;
      sumsq += pr * pr;
      run += pr;
      cdf[i] = run;
    }
    const float last = cdf[P - 1];
    for (int i = 0; i < P; ++i) cdf[i] = cdf[i] / last;
    sc[0] = mx + logf(tot / (float)(P - 1));
    const float ess = 1.f / fmaxf(sumsq, 1e-38f);
    sc[1] = (ess < 0.5f * (float)(P - 1)) ? 1.f : 0.f;
  }
  __syncwarp();
  const bool resample = sc[1] != 0.f;
  const float log_mean = sc[0];
  const float uu = u[c];
  for (int i = lane; i < P; i += 32) {
    int tk = i;
    float w = lw1[i];
    if (resample && i >= 1) {
      const float pos = (uu + (float)i - 1.f) / (float)(P - 1);
      int cnt = 0;  // searchsorted 'left' into the non-frozen CDF
      for (int j = 1; j < P; ++j) cnt += (cdf[j] < pos) ? 1 : 0;
      tk = min(max(cnt + 1, 1), P - 1);
      w = log_mean;
    }
    take_o[i] = tk;
    lw_o[i] = w;
    llp_o[i] = ll[tk];
  }
}

}  // namespace

extern "C" int smc_resample_launch(const float* ll, const float* llp,
                                   const float* lw, const float* u,
                                   float* lw_o, int* take_o, float* llp_o,
                                   int C, int P, void* stream) {
  const size_t bytes = sizeof(float) * (2 * (size_t)P + 2);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  smc_resample_kernel<<<C, 32, bytes, (cudaStream_t)stream>>>(
      ll, llp, lw, u, lw_o, take_o, llp_o, P);
  return (int)cudaGetLastError();
}
