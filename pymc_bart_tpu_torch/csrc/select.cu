// select_refine: pick the winning particle of a tree update and refine its
// leaf values by Metropolis sweeps, for all chains.
//
// Replaces the TPU kernel
// pymc_bart_tpu/ops/select_pallas.py::select_refine_pallas: inverse-CDF winner
// over log_w; extraction of the winner's arrays; per-leaf residual sums; R
// Metropolis sweeps on the leaf values under likelihood x
// N(leaf residual mean / m, leaf_sd) prior.  n_outputs == 1, constant
// response only, as the TPU kernel.
//
// Bound: bytes (the winner's leaf_idx and pred rows, resid and llw, read once
// and written once; the R sweeps re-read them from L1/L2).  Design: one
// block per chain; the winner by a sequential prefix sum on thread 0 (P is
// tens) so it matches a plain cumsum; leaf values, mask and prior centres in
// shared memory; each sweep is a gather pred[i] = lf[leaf_idx[i]] fused with
// a fixed-order block reduction of the weighted squared error, so the accept
// decision never changes from run to run.
#include "common.cuh"

#include <math.h>

namespace {

using bart::kThreads;

extern __shared__ float smem_f[];

__global__ void __launch_bounds__(kThreads) select_refine_kernel(
    const int* sv, const float* sl, const int* st, const float* lf,
    const float* ct, const int* li, const float* pred, const float* lw,
    const float* resid, const float* llw, const float* eps, const float* uacc,
    const float* usel, const float* hiv, int* sv_o, float* sl_o, int* st_o,
    float* lf_o, float* ct_o, int* li_o, float* pred_o, int P, int S, int n,
    int R, int m) {
  const int c = blockIdx.x, T = blockDim.x, t = threadIdx.x;
  int nchunks = T / S;
  if (nchunks < 1) nchunks = 1;
  float* s_lfw = smem_f;            // S current leaf values
  float* s_lfp = s_lfw + S;         // S proposed leaf values
  float* s_mask = s_lfp + S;        // S 1 on occupied leaves
  float* s_ctr = s_mask + S;        // S prior centres
  float* s_part = s_ctr + S;        // S*nchunks
  float* s_red = s_part + (size_t)S * nchunks;  // 32
  __shared__ int s_widx;

  // ---- winner by inverse CDF over exp(log_w - max) ----
  if (t == 0) {
    const float* w = lw + (size_t)c * P;
    float mx = -INFINITY;
    for (int i = 0; i < P; ++i) mx = fmaxf(mx, w[i]);
    float tot = 0.f;
    for (int i = 0; i < P; ++i) tot += expf(w[i] - mx);
    const float uu = usel[c] * tot;
    float run = 0.f;
    int cnt = 0;
    for (int i = 0; i < P; ++i) { run += expf(w[i] - mx); cnt += (run < uu) ? 1 : 0; }
    s_widx = min(max(cnt, 0), P - 1);
  }
  __syncthreads();
  const size_t wp = (size_t)c * P + s_widx;
  sv += wp * S; sl += wp * S; st += wp * S; lf += wp * S; ct += wp * S;
  li += wp * n; pred += wp * n;
  sv_o += (size_t)c * S; sl_o += (size_t)c * S; st_o += (size_t)c * S;
  lf_o += (size_t)c * S; ct_o += (size_t)c * S;
  li_o += (size_t)c * n; pred_o += (size_t)c * n;
  resid += (size_t)c * n; llw += (size_t)c * n;
  eps += (size_t)c * R * S; uacc += (size_t)c * R;

  for (int s = t; s < S; s += T) {
    const int v = sv[s];
    const float cn = ct[s];
    sv_o[s] = v; sl_o[s] = sl[s]; st_o[s] = st[s]; ct_o[s] = cn;
    s_lfw[s] = lf[s];
    s_mask[s] = (v < 0 && cn > 0.f) ? 1.f : 0.f;
  }
  for (int i = t; i < n; i += T) li_o[i] = li[i];
  __syncthreads();

  // ---- per-leaf residual sums in a fixed order -> prior centres ----
  for (int w = t; w < S * nchunks; w += T) {
    const int s = w % S, q = w / S;
    const int r0 = (int)((long long)n * q / nchunks);
    const int r1 = (int)((long long)n * (q + 1) / nchunks);
    float acc = 0.f;
    for (int i = r0; i < r1; ++i)
      if (li_o[i] == s) acc += resid[i];
    s_part[w] = acc;
  }
  __syncthreads();
  for (int s = t; s < S; s += T) {
    float tot = 0.f;
    for (int q = 0; q < nchunks; ++q) tot += s_part[q * S + s];
    s_ctr[s] = tot / fmaxf(ct[s], 1.f) / (float)m;
  }
  __syncthreads();

  const float h = hiv[c];
  float acc = 0.f;
  for (int i = t; i < n; i += T) {
    const float df = resid[i] - pred[i];
    acc += llw[i] * df * df;
  }
  float sse = bart::block_sum(acc, s_red);
  acc = 0.f;
  for (int s = t; s < S; s += T) {
    const float dv = s_lfw[s] - s_ctr[s];
    acc += s_mask[s] * dv * dv;
  }
  float ll_c = -0.5f * sse - h * bart::block_sum(acc, s_red);

  // ---- R Metropolis sweeps with pre-drawn noise ----
  bool any = false;
  for (int r = 0; r < R; ++r) {
    for (int s = t; s < S; s += T)
      s_lfp[s] = s_lfw[s] + eps[(size_t)r * S + s] * s_mask[s];
    __syncthreads();
    acc = 0.f;
    for (int i = t; i < n; i += T) {
      const float df = resid[i] - s_lfp[li_o[i]];
      acc += llw[i] * df * df;
    }
    sse = bart::block_sum(acc, s_red);
    acc = 0.f;
    for (int s = t; s < S; s += T) {
      const float dv = s_lfp[s] - s_ctr[s];
      acc += s_mask[s] * dv * dv;
    }
    const float ll_p = -0.5f * sse - h * bart::block_sum(acc, s_red);
    if (logf(uacc[r]) < ll_p - ll_c) {  // the same value in every thread
      for (int s = t; s < S; s += T) s_lfw[s] = s_lfp[s];
      ll_c = ll_p;
      any = true;
    }
    __syncthreads();
  }

  for (int s = t; s < S; s += T) lf_o[s] = s_lfw[s];
  for (int i = t; i < n; i += T)
    pred_o[i] = any ? s_lfw[li_o[i]] : pred[i];
}

}  // namespace

extern "C" int select_refine_launch(
    const int* sv, const float* sl, const int* st, const float* lf,
    const float* ct, const int* li, const float* pred, const float* lw,
    const float* resid, const float* llw, const float* eps, const float* uacc,
    const float* usel, const float* hiv, int* sv_o, float* sl_o, int* st_o,
    float* lf_o, float* ct_o, int* li_o, float* pred_o, int C, int P, int S,
    int n, int R, int m, void* stream) {
  int nchunks = kThreads / S;
  if (nchunks < 1) nchunks = 1;
  const size_t bytes = sizeof(float) * (4 * (size_t)S + (size_t)S * nchunks + 32);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        select_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  select_refine_kernel<<<C, kThreads, bytes, (cudaStream_t)stream>>>(
      sv, sl, st, lf, ct, li, pred, lw, resid, llw, eps, uacc, usel, hiv, sv_o,
      sl_o, st_o, lf_o, ct_o, li_o, pred_o, P, S, n, R, m);
  return (int)cudaGetLastError();
}
