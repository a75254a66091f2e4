// grow_round: one depth-d growth round of the PGBART conditional SMC for all
// particles of all chains.
//
// Replaces the TPU kernel pymc_bart_tpu/ops/grow_pallas.py::grow_round_pallas
// (body _grow_math).  It computes what that kernel computes; the one-hot
// matmuls, selection matmuls and bit-pattern blends of the Pallas body are
// gathers, scatters and segmented sums here.
//
// Bound: bytes.  A launch reads leaf_idx, pred and row_gum and writes
// leaf_idx and pred, each (C*P*n) 4-byte words, plus X once; the arithmetic
// per row is a handful of compares.  Design: one block per (chain, particle),
// threads stride over the n rows, node-level state (G = 2^d nodes, 2G
// children) lives in shared memory, row-level state stays in global memory
// (L2-resident at these sizes).  Phases are separated by __syncthreads():
//   0  copy the ancestor's S-vectors (read through `take`) to the output
//   a  per node: grow decision, split variable by inverse CDF
//   b  per node: Gumbel arg-max over member rows (64-bit atomicMax on an
//      order-preserving key; ties go to the lowest row, as jnp.argmax)
//   c  route rows to tentative children, integer child counts (atomics)
//   c2 child sums of the residual (and x, x^2, x*r for linear/mix) in a FIXED
//      order: thread (child, row-chunk) scans its chunk, chunks are added in
//      order.  No float atomics: the SMC compares weights with thresholds,
//      so run-to-run float noise would flip discrete decisions.
//   d  validate (both children non-empty), revert, commit level and children,
//      draw leaf values and slopes
//   e  write leaf_idx and pred, reduce the Gaussian log-likelihood
#include "common.cuh"

#include <math.h>

namespace {

using bart::kThreads;

struct GrowArgs {
  const int* take; const int* frozen;
  const int* sv; const float* sl; const int* st; const float* lf;
  const float* ct; const float* sp; const int* li; const float* pred;
  const float* X; const float* resid; const float* llw; const int* rules;
  const float* cdf; const float* lsd;
  const float* u_grow; const float* u_var; const int* set_bits; int ld_g;
  const float* row_gum;
  const float* eps; int ld_e;
  const float* u_mix; int ld_m;
  int* sv_o; float* sl_o; int* st_o; float* lf_o; float* ct_o; float* sp_o;
  int* li_o; float* pred_o; float* ll_o;
  int C, P, S, n, p, k, d, m;
  float p_grow;
  int response;  // 0 constant, 1 linear, 2 mix
};

__host__ __device__ inline int n_stats(int k, int response) {
  return response != 0 ? 2 * k + 2 : k;
}

__host__ __device__ inline int n_chunks(int G2, int nstat) {
  int c = kThreads / (nstat * G2);
  return c < 1 ? 1 : c;
}

inline size_t smem_bytes(int G, int k, int response) {
  const int G2 = 2 * G, nstat = n_stats(k, response);
  const size_t words = 4 * (size_t)G          // varx, vars, setx, flags
      + G2                                     // child counts
      + 2 * (size_t)G                          // valx, valraw
      + 2 * (size_t)k * G2                     // child leaf values, slopes
      + (size_t)nstat * G2                     // child statistics
      + (size_t)nstat * G2 * n_chunks(G2, nstat)  // chunk partials
      + 32;                                    // reduction scratch
  return 8 * (size_t)G + 4 * words;
}

using bart::go_left;
using bart::pack_key;

extern __shared__ unsigned long long smem_u64[];

__global__ void __launch_bounds__(kThreads) grow_round_kernel(const GrowArgs a) {
  const int P = a.P, S = a.S, n = a.n, p = a.p, k = a.k, d = a.d;
  const int c = blockIdx.x / P, pi = blockIdx.x % P;
  const int T = blockDim.x, t = threadIdx.x;
  const int lo = (1 << d) - 1, hi = (1 << (d + 1)) - 1;
  const int G = hi - lo, G2 = 2 * G;
  const bool lin = a.response != 0;
  const int nstat = n_stats(k, a.response);
  const int nchunks = n_chunks(G2, nstat);
  const int nwork = nstat * G2 * nchunks;

  unsigned long long* s_best = smem_u64;            // G
  int* s_varx = (int*)(s_best + G);                 // G  clipped effective var
  int* s_vars = s_varx + G;                         // G  sampled var
  int* s_setx = s_vars + G;                         // G  effective salt
  int* s_flags = s_setx + G;                        // G  1 want 2 active 4 grow_ok 8 final
  int* s_cnt = s_flags + G;                         // 2G child counts
  float* s_valx = (float*)(s_cnt + G2);             // G  effective split value
  float* s_valraw = s_valx + G;                     // G  sampled split value
  float* s_clf = s_valraw + G;                      // k*2G child leaf values
  float* s_csp = s_clf + k * G2;                    // k*2G child slopes
  float* s_stat = s_csp + k * G2;                   // nstat*2G
  float* s_part = s_stat + nstat * G2;              // nwork
  float* s_red = s_part + nwork;                    // 32

  const int anc = a.take[c * P + pi];
  const bool frozen = a.frozen[c * P + anc] != 0;
  const size_t ip = (size_t)c * P + anc, op = (size_t)c * P + pi;
  const int* sv = a.sv + ip * S;
  const float* sl = a.sl + ip * S;
  const int* st = a.st + ip * S;
  const float* ct = a.ct + ip * S;
  const float* lf = a.lf + ip * k * S;
  const float* sp = a.sp + ip * k * S;
  const int* li = a.li + ip * n;
  const float* pred = a.pred + ip * k * n;
  int* sv_o = a.sv_o + op * S;
  float* sl_o = a.sl_o + op * S;
  int* st_o = a.st_o + op * S;
  float* ct_o = a.ct_o + op * S;
  float* lf_o = a.lf_o + op * k * S;
  float* sp_o = a.sp_o + op * k * S;
  int* li_o = a.li_o + op * n;
  float* pred_o = a.pred_o + op * k * n;
  const float* X = a.X;
  const float* resid = a.resid + (size_t)c * k * n;
  const float* llw = a.llw + (size_t)c * k * n;
  const float* cdf = a.cdf + (size_t)c * p;
  const float* lsd = a.lsd + (size_t)c * k;
  const float* ug = a.u_grow + op * a.ld_g;
  const float* uv = a.u_var + op * a.ld_g;
  const int* sb = a.set_bits + op * a.ld_g;
  const float* gum = a.row_gum + op * n;
  const float* eps = a.eps + op * k * a.ld_e;
  const float* umix = a.u_mix ? a.u_mix + op * a.ld_m : nullptr;

  // ---- phase 0: the ancestor's node arrays become this particle's ----
  for (int s = t; s < S; s += T) {
    sv_o[s] = sv[s]; sl_o[s] = sl[s]; st_o[s] = st[s]; ct_o[s] = ct[s];
  }
  for (int s = t; s < k * S; s += T) { lf_o[s] = lf[s]; sp_o[s] = sp[s]; }

  // ---- phase a: grow decision and split variable per node ----
  for (int g = t; g < G; g += T) {
    const int node_sv = sv[lo + g];
    const bool want = (ug[g] < a.p_grow) && node_sv < 0 && ct[lo + g] >= 2.f
        && !frozen;
    const float u_v = uv[g] * cdf[p - 1];
    int l = 0, r = p;  // number of cdf entries < u_v (cdf is non-decreasing)
    while (l < r) {
      const int mid = (l + r) >> 1;
      if (cdf[mid] < u_v) l = mid + 1; else r = mid;
    }
    const int var_s = min(max(l, 0), p - 1);
    const int varx = frozen ? node_sv : var_s;
    const bool active = frozen ? (node_sv >= 0) : want;
    s_varx[g] = min(max(varx, 0), p - 1);
    s_vars[g] = var_s;
    s_flags[g] = (want ? 1 : 0) | (active ? 2 : 0);
    s_best[g] = 0ull;
    s_cnt[2 * g] = 0;
    s_cnt[2 * g + 1] = 0;
  }
  __syncthreads();

  // ---- phase b: uniform member row per node by Gumbel arg-max ----
  for (int i = t; i < n; i += T) {
    const int l = li[i];
    if (l >= lo && l < hi) atomicMax(&s_best[l - lo], pack_key(gum[i], i));
  }
  __syncthreads();
  for (int g = t; g < G; g += T) {
    const unsigned long long key = s_best[g];
    // a node with no member row keeps row 0, as an arg-max over -inf does
    const int r = key ? (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull)) : 0;
    // the value is read at the ROW's node's variable (equal to this node's
    // for a member row; kept for a memberless node to match the reference)
    const int lr = li[r];
    const int col = (lr >= lo && lr < hi) ? s_varx[lr - lo] : 0;
    const float val_raw = X[(size_t)r * p + col];
    s_valraw[g] = val_raw;
    s_valx[g] = frozen ? sl[lo + g] : val_raw;
    s_setx[g] = frozen ? st[lo + g] : sb[g];
  }
  __syncthreads();

  // ---- phase c: tentative routing and child counts ----
  for (int i = t; i < n; i += T) {
    const int l = li[i];
    int tent = l;
    if (l >= lo && l < hi) {
      const int g = l - lo;
      if (s_flags[g] & 2) {
        const int col = s_varx[g];
        const bool left = go_left(X[(size_t)i * p + col], s_valx[g], s_setx[g],
                                  a.rules[col]);
        tent = 2 * l + 1 + (left ? 0 : 1);
        atomicAdd(&s_cnt[tent - hi], 1);
      }
    }
    li_o[i] = tent;
  }
  __syncthreads();

  // ---- phase c2: child statistics in a fixed order (not needed by the
  // frozen particle, which commits nothing) ----
  if (!frozen) {
    for (int w = t; w < nwork; w += T) {
      const int ch = w % G2;
      const int s = (w / G2) % nstat;
      const int q = w / (G2 * nstat);
      const int r0 = (int)((long long)n * q / nchunks);
      const int r1 = (int)((long long)n * (q + 1) / nchunks);
      const int slot = hi + ch;
      float acc = 0.f;
      if (s < k) {
        const float* rk = resid + (size_t)s * n;
        for (int i = r0; i < r1; ++i)
          if (li_o[i] == slot) acc += rk[i];
      } else {
        const int col = s_varx[ch >> 1];
        for (int i = r0; i < r1; ++i) {
          if (li_o[i] != slot) continue;
          float x = X[(size_t)i * p + col];
          x = isnan(x) ? 0.f : x;
          if (s == k) acc += x;
          else if (s == k + 1) acc += x * x;
          else acc += resid[(size_t)(s - k - 2) * n + i] * x;
        }
      }
      s_part[w] = acc;
    }
    __syncthreads();
    for (int w = t; w < nstat * G2; w += T) {
      float tot = 0.f;
      for (int q = 0; q < nchunks; ++q) tot += s_part[q * nstat * G2 + w];
      s_stat[w] = tot;
    }
    __syncthreads();
  }

  // ---- phase d: validate, commit the level and the children ----
  for (int g = t; g < G; g += T) {
    const bool grow_ok = (s_flags[g] & 1) && s_cnt[2 * g] > 0
        && s_cnt[2 * g + 1] > 0;
    const bool fin = frozen ? (sv[lo + g] >= 0) : grow_ok;
    s_flags[g] |= (grow_ok ? 4 : 0) | (fin ? 8 : 0);
    if (grow_ok) {
      sv_o[lo + g] = s_vars[g];
      sl_o[lo + g] = s_valraw[g];
      st_o[lo + g] = sb[g];
    }
  }
  __syncthreads();
  const float fm = (float)a.m;
  for (int w = t; w < G2 * k; w += T) {
    const int ch = w % G2, kk = w / G2;
    float new_lf = lf[(size_t)kk * S + hi + ch];
    float new_sp = sp[(size_t)kk * S + hi + ch];
    if (s_flags[ch >> 1] & 4) {
      const float cnt = (float)s_cnt[ch];
      const float c_safe = fmaxf(cnt, 1.f);
      const float csum = s_stat[kk * G2 + ch];
      float mu_base = csum / c_safe / fm;
      if (lin) {
        // least-squares slope of the child residual on the split covariate
        const float sx = s_stat[k * G2 + ch];
        const float sx2 = s_stat[(k + 1) * G2 + ch];
        const float sxr = s_stat[(k + 2 + kk) * G2 + ch];
        const float var_x = sx2 - sx * sx / c_safe;
        bool usable = cnt >= 3.f && var_x > 1e-6f;
        if (a.response == 2) usable = usable && (umix ? umix[ch] : 1.f) < 0.5f;
        const float slope_hat = usable
            ? (sxr - (sx / c_safe) * csum) / fmaxf(var_x, 1e-6f) : 0.f;
        if (usable) mu_base = ((csum - slope_hat * sx) / c_safe) / fm;
        new_sp = slope_hat / fm;
        sp_o[(size_t)kk * S + hi + ch] = new_sp;
      }
      new_lf = mu_base + eps[(size_t)kk * a.ld_e + ch] * lsd[kk];
      lf_o[(size_t)kk * S + hi + ch] = new_lf;
      if (kk == 0) ct_o[hi + ch] = cnt;
    }
    s_clf[kk * G2 + ch] = new_lf;
    s_csp[kk * G2 + ch] = new_sp;
  }
  __syncthreads();

  // ---- phase e: final routing, incremental prediction, log-likelihood ----
  float acc = 0.f;
  for (int i = t; i < n; i += T) {
    const int l = li[i];
    const int tent = li_o[i];
    const bool moved = (l >= lo && l < hi) && (s_flags[l - lo] & 8);
    li_o[i] = moved ? tent : l;
    float xv = 0.f;
    if (moved && lin) {
      const float x = X[(size_t)i * p + s_varx[l - lo]];
      xv = isnan(x) ? 0.f : x;
    }
    for (int kk = 0; kk < k; ++kk) {
      float v;
      if (moved) {
        const int ch = tent - hi;
        v = s_clf[kk * G2 + ch];
        if (lin) v += s_csp[kk * G2 + ch] * xv;
      } else {
        v = pred[(size_t)kk * n + i];
      }
      pred_o[(size_t)kk * n + i] = v;
      const float df = resid[(size_t)kk * n + i] - v;
      acc += llw[(size_t)kk * n + i] * df * df;
    }
  }
  const float tot = bart::block_sum(acc, s_red);
  if (t == 0) a.ll_o[c * P + pi] = -0.5f * tot;
}

}  // namespace

extern "C" int grow_round_launch(
    const int* take, const int* frozen, const int* sv, const float* sl,
    const int* st, const float* lf, const float* ct, const float* sp,
    const int* li, const float* pred, const float* X, const float* resid,
    const float* llw, const int* rules, const float* cdf, const float* lsd,
    const float* u_grow, const float* u_var, const int* set_bits, int ld_g,
    const float* row_gum, const float* eps, int ld_e, const float* u_mix,
    int ld_m, int* sv_o, float* sl_o, int* st_o, float* lf_o, float* ct_o,
    float* sp_o, int* li_o, float* pred_o, float* ll_o, int C, int P, int S,
    int n, int p, int k, int d, int m, float p_grow, int response,
    void* stream) {
  GrowArgs a{take, frozen, sv, sl, st, lf, ct, sp, li, pred, X, resid, llw,
             rules, cdf, lsd, u_grow, u_var, set_bits, ld_g, row_gum, eps,
             ld_e, u_mix, ld_m, sv_o, sl_o, st_o, lf_o, ct_o, sp_o, li_o,
             pred_o, ll_o, C, P, S, n, p, k, d, m, p_grow, response};
  const size_t bytes = smem_bytes(1 << d, k, response);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grow_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  grow_round_kernel<<<C * P, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
