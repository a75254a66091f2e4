// pgbart_step: one WHOLE PGBART step for all chains in one launch.
//
// Replaces the TPU kernel
// pymc_bart_tpu/ops/draw_pallas.py::pgbart_step_fused (body _draw_kernel).
// For each of the batch's B trees it runs the full conditional SMC (D growth
// rounds, D-1 ESS-gated systematic resamplings, the categorical winner, R
// Metropolis leaf refinements), commits the winner to the forest, tree_pred
// and sum_trees, adapts the split prior and the Welford leaf_sd while tuning,
// and ends with the variable-inclusion histogram.  The SMC weights follow a
// likelihood code: gauss, bernoulli, het_abs, het_exp, cat_logit.  The
// sampler state is updated IN PLACE; the random numbers are arguments.
//
// Bound: bytes.  The row-Gumbel block (B*D*C*P*n floats) is read once and
// dominates; the forest, tree_pred and the other blocks follow.  At the main
// shapes the kernel is far from that bound: it is a chain of short phases
// separated by barriers, so latency sets its time.
//
// Design.  One block per (chain, particle), launched cooperatively so that
// every block is resident (the launcher refuses a grid that is not).  The
// tree loop and the depth loop run inside the kernel.  The particles of one
// chain meet at a per-chain barrier (an arrival counter in global memory;
// chains never wait for each other):
//   * once per tree after the leader block (particle 0, the frozen particle)
//     has prepared the tree: sum_noi, the residual, the root mean and the
//     split-weight CDF;
//   * once per level after every particle has written its state and its
//     log-likelihood.
// Per-particle state (node arrays, leaf_idx, pred) lives in global scratch in
// TWO buffers: at level d a particle reads its ancestor `take[q]` from one
// buffer and writes itself to the other, so no particle overwrites state
// another one still has to read; the barrier separates "everyone has
// written" from "anyone reads an ancestor".  After the barrier every block
// of the chain computes the same SMC bookkeeping (weights, ESS, ancestors)
// redundantly from the same P log-likelihoods: the same code on the same
// inputs, so all blocks hold the same `take`.  After the last level the
// leader block selects the winner, refines, commits and adapts while the
// others wait at the next tree's barrier.
//
// Order of float sums (discrete decisions must not flip from run to run):
// row sums are fixed-order block sums (common.cuh) or chunk scans added in
// chunk order; the softmax, the resampling CDF and the winner CDF are
// sequential in index order on one thread; only integer counts use atomics.
// The split-weight CDF over the p columns is accumulated in float64 in index
// order and rounded to float32 once per entry, which the plain version
// reproduces with a float64 cumsum.
// NaN-able values (split values) are selected, never blended.
#include "common.cuh"

namespace {

using bart::go_left;
using bart::kThreads;
using bart::pack_key;

constexpr int kMaxDepth = 16;
constexpr long long kSpinLimit = 4000000000LL;  // cycles, about two seconds

enum Lik { kGauss = 0, kBernoulli = 1, kHetAbs = 2, kHetExp = 3, kCatLogit = 4 };

// Mirrored field by field by ops/draw.py::_DrawArgs (ctypes).
struct DrawArgs {
  // sampler state, updated in place
  int* f_sv; float* f_sl; int* f_st; float* f_lf; float* f_ct; float* f_sp;
  float* tree_pred; float* sum_trees; float* alpha_vec; float* leaf_sd;
  float* wf_count; float* wf_mean; float* wf_m2;
  int* batch_offset; int* iteration;
  // data
  const float* X; const float* y; const int* rules; const float* lik_row;
  // random blocks of the step
  const float* ug; const float* uv; const float* rg; const float* eps;
  const int* sb; const float* ures; const float* usel; const float* epsr;
  const float* uacc;
  // scratch
  int* ps_sv; float* ps_sl; int* ps_st; float* ps_lf; float* ps_ct;
  int* ps_li; float* ps_pred;
  float* ll_buf; float* cdf; float* resid; float* noi; float* root_mu;
  int* vi_cnt; unsigned int* bar; int* status;
  // output
  float* vi;
  int C, P, S, n, p, m, B, D, R, lik, tuning;
  float lik_const, decay;
  float p_grow[kMaxDepth];
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of one block, in bytes (mirrored by ops/draw.py).
inline size_t smem_bytes(int D, int P, int S) {
  const int Gm = 1 << (D - 1);
  const size_t words = 5 * (size_t)Gm + 2 * Gm   // varx vars setx flags (+pad), cnt
      + 2 * (size_t)Gm + 2 * (size_t)(2 * Gm)    // valx valraw, clf stat
      + imax(kThreads, 2 * Gm) + 32              // chunk partials, reduction
      + 5 * (size_t)P + 4                        // chain vectors, scalars
      + 4 * (size_t)S + imax(kThreads, S);       // leader: leaves and partials
  return 8 * (size_t)Gm + 4 * words;
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// One row's term of the log-likelihood sum.  For gauss the caller multiplies
// the sum by -1/2; for the other codes the sum is the log-likelihood.
__device__ __forceinline__ float row_ll(int lik, float c0, float y, float noi,
                                        float resid, float w, float pred) {
  if (lik == kGauss) {
    const float df = resid - pred;
    return w * df * df;
  }
  const float F = noi + pred;
  if (lik == kBernoulli) return y * F - softplusf(F);
  if (lik == kHetAbs) {
    const float sg = fabsf(F) + c0;
    return -0.5f * w / (sg * sg) - logf(sg);
  }
  if (lik == kHetExp) return -0.5f * w * expf(-2.f * F) - F;
  const float lse = fmaxf(F, w) + log1pf(expf(-fabsf(F - w)));
  return (y > 0.f ? 1.f : 0.f) * F - lse;
}

// Barrier of the P blocks of chain c.  `epoch` counts the arrivals expected
// so far.  A wait that outlasts kSpinLimit sets `status` and gives up, and so
// does every later wait: a fault ends as an error, not as a hung card.
__device__ __forceinline__ void chain_barrier(const DrawArgs& a, int c,
                                              unsigned int& epoch) {
  epoch += (unsigned int)a.P;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(a.bar + c, 1u);
    volatile unsigned int* vb = a.bar + c;
    volatile int* vs = a.status;
    const long long t0 = clock64();
    while (*vb < epoch) {
      if (*vs != 0) break;
      if (clock64() - t0 > kSpinLimit) { atomicExch(a.status, 1); break; }
    }
    __threadfence();
  }
  __syncthreads();
}

extern __shared__ unsigned long long smem_u64[];

__global__ void __launch_bounds__(kThreads, 2) pgbart_step_kernel(const DrawArgs a) {
  const int C = a.C, P = a.P, S = a.S, n = a.n, p = a.p, m = a.m, D = a.D;
  const int R = a.R, lik = a.lik;
  const int c = blockIdx.x / P, pi = blockIdx.x % P;
  const int T = blockDim.x, t = threadIdx.x;
  const bool leader = pi == 0;  // the frozen particle; also the chain's serial work
  const int Gm = 1 << (D - 1), Gtot = (1 << D) - 1;
  const float c0 = a.lik_const;

  unsigned long long* s_best = smem_u64;            // Gm
  int* s_varx = (int*)(s_best + Gm);                // Gm clipped effective var
  int* s_vars = s_varx + Gm;                        // Gm sampled var
  int* s_setx = s_vars + Gm;                        // Gm effective salt
  int* s_flags = s_setx + Gm;                       // Gm 1 want 2 active 4 grow_ok 8 final
  int* s_widx = s_flags + Gm;                       // Gm (slot 0: winner index)
  int* s_cnt = s_widx + Gm;                         // 2Gm child counts
  float* s_valx = (float*)(s_cnt + 2 * Gm);         // Gm effective split value
  float* s_valraw = s_valx + Gm;                    // Gm sampled split value
  float* s_clf = s_valraw + Gm;                     // 2Gm child leaf values
  float* s_stat = s_clf + 2 * Gm;                   // 2Gm child residual sums
  float* s_part = s_stat + 2 * Gm;                  // max(T, 2Gm) chunk partials
  float* s_red = s_part + imax(kThreads, 2 * Gm);   // 32
  float* c_lw = s_red + 32;                         // P log-weights of the chain
  float* c_llp = c_lw + P;                          // P ll at the last weight update
  float* c_ll = c_llp + P;                          // P ll after this level
  float* c_cdf = c_ll + P;                          // P resampling CDF
  int* c_take = (int*)(c_cdf + P);                  // P ancestors
  float* c_sc = (float*)(c_take + P);               // 4 scalars
  float* s_lfw = c_sc + 4;                          // S winner's leaf values
  float* s_lfp = s_lfw + S;                         // S proposed leaf values
  float* s_mask = s_lfp + S;                        // S 1 on occupied leaves
  float* s_ctr = s_mask + S;                        // S prior centres
  float* s_part2 = s_ctr + S;                       // max(T, S)

  const size_t CP = (size_t)C * P;
  const size_t q = (size_t)c * P + pi;
  float* resid = a.resid + (size_t)c * n;
  float* noi = a.noi + (size_t)c * n;
  const float* y = a.y;
  const float* wrow = a.lik_row ? a.lik_row + (size_t)c * n : nullptr;
  const float* X = a.X;
  const float* cdf = a.cdf + (size_t)c * p;
  const int off0 = a.batch_offset[c];
  unsigned int epoch = 0;

  for (int b = 0; b < a.B; ++b) {
    const int jt = (off0 + b) % m;
    const size_t fr = ((size_t)c * m + jt) * S;     // forest row of the tree
    float* tp = a.tree_pred + ((size_t)c * m + jt) * n;

    // ---- the leader prepares the tree ----
    if (leader) {
      float acc = 0.f;
      for (int i = t; i < n; i += T) {
        const float ni = a.sum_trees[(size_t)c * n + i] - tp[i];
        const float r = y[i] - ni;
        noi[i] = ni;
        resid[i] = r;
        acc += r;
      }
      const float tot = bart::block_sum(acc, s_red);
      if (t == 0) {
        a.root_mu[c] = tot / (float)n / (float)m;
        double run = 0.0;
        for (int j = 0; j < p; ++j) {
          run += (double)fmaxf(a.alpha_vec[(size_t)c * p + j], 1e-12f);
          a.cdf[(size_t)c * p + j] = (float)run;
        }
      }
    }
    chain_barrier(a, c, epoch);

    // ---- this block's particle: the current tree (frozen) or a root leaf ----
    int cur = 0;
    const float lsd = a.leaf_sd[c];
    {
      int* sv_o = a.ps_sv + q * S; float* sl_o = a.ps_sl + q * S;
      int* st_o = a.ps_st + q * S; float* lf_o = a.ps_lf + q * S;
      float* ct_o = a.ps_ct + q * S;
      int* li_o = a.ps_li + q * n; float* pred_o = a.ps_pred + q * n;
      const float rmu = a.root_mu[c];
      for (int s = t; s < S; s += T) {
        if (leader) {
          sv_o[s] = a.f_sv[fr + s]; sl_o[s] = a.f_sl[fr + s];
          st_o[s] = a.f_st[fr + s]; lf_o[s] = a.f_lf[fr + s];
          ct_o[s] = a.f_ct[fr + s];
        } else {
          sv_o[s] = -1; sl_o[s] = 0.f; st_o[s] = 0;
          lf_o[s] = s == 0 ? rmu : 0.f;
          ct_o[s] = s == 0 ? (float)n : 0.f;
        }
      }
      const float pred0 = leader ? a.f_lf[fr] : rmu;
      float acc = 0.f;
      for (int i = t; i < n; i += T) {
        li_o[i] = 0;
        pred_o[i] = pred0;
        acc += row_ll(lik, c0, y[i], noi[i], resid[i], wrow ? wrow[i] : 0.f,
                      pred0);
      }
      const float tot = bart::block_sum(acc, s_red);
      if (t == 0) a.ll_buf[q] = lik == kGauss ? -0.5f * tot : tot;
      for (int i = t; i < P; i += T) c_take[i] = i;
    }
    __syncthreads();

    for (int d = 0; d < D; ++d) {
      const int lo = (1 << d) - 1, hi = (1 << (d + 1)) - 1;
      const int G = hi - lo, G2 = 2 * G;
      const int nchunks = imax(1, T / G2);
      const int nwork = G2 * nchunks;
      const int anc = c_take[pi];
      const bool frozen = leader;  // particle 0 keeps ancestor 0, the others never take it
      const size_t ip = (size_t)cur * CP + (size_t)c * P + anc;
      const size_t op = (size_t)(1 - cur) * CP + q;
      const int* sv = a.ps_sv + ip * S; const float* sl = a.ps_sl + ip * S;
      const int* st = a.ps_st + ip * S; const float* lf = a.ps_lf + ip * S;
      const float* ct = a.ps_ct + ip * S;
      const int* li = a.ps_li + ip * n; const float* pred = a.ps_pred + ip * n;
      int* sv_o = a.ps_sv + op * S; float* sl_o = a.ps_sl + op * S;
      int* st_o = a.ps_st + op * S; float* lf_o = a.ps_lf + op * S;
      float* ct_o = a.ps_ct + op * S;
      int* li_o = a.ps_li + op * n; float* pred_o = a.ps_pred + op * n;
      const size_t rq = ((size_t)b * C + c) * P + pi;
      const float* ug = a.ug + rq * Gtot + lo;
      const float* uv = a.uv + rq * Gtot + lo;
      const int* sb = a.sb + rq * Gtot + lo;
      const float* eps = a.eps + rq * 2 * Gtot + 2 * lo;
      const float* gum = a.rg + ((((size_t)b * D + d) * C + c) * P + pi) * n;
      const float p_grow = a.p_grow[d];

      // phase 0: the ancestor's node arrays become this particle's
      for (int s = t; s < S; s += T) {
        sv_o[s] = sv[s]; sl_o[s] = sl[s]; st_o[s] = st[s]; ct_o[s] = ct[s];
        lf_o[s] = lf[s];
      }

      // phase a: grow decision and split variable per node
      for (int g = t; g < G; g += T) {
        const int node_sv = sv[lo + g];
        const bool want = (ug[g] < p_grow) && node_sv < 0
            && ct[lo + g] >= 2.f && !frozen;
        const float u_v = uv[g] * cdf[p - 1];
        int l = 0, r = p;  // number of cdf entries < u_v
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

      // phase b: uniform member row per node by Gumbel arg-max (ties to the
      // lowest row)
      for (int i = t; i < n; i += T) {
        const int l = li[i];
        if (l >= lo && l < hi) atomicMax(&s_best[l - lo], pack_key(gum[i], i));
      }
      __syncthreads();
      for (int g = t; g < G; g += T) {
        const unsigned long long key = s_best[g];
        const int r = key ? (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull)) : 0;
        const int lr = li[r];
        const int col = (lr >= lo && lr < hi) ? s_varx[lr - lo] : 0;
        const float val_raw = X[(size_t)r * p + col];
        s_valraw[g] = val_raw;
        s_valx[g] = frozen ? sl[lo + g] : val_raw;
        s_setx[g] = frozen ? st[lo + g] : sb[g];
      }
      __syncthreads();

      // phase c: tentative routing and integer child counts
      for (int i = t; i < n; i += T) {
        const int l = li[i];
        int tent = l;
        if (l >= lo && l < hi) {
          const int g = l - lo;
          if (s_flags[g] & 2) {
            const int col = s_varx[g];
            const bool left = go_left(X[(size_t)i * p + col], s_valx[g],
                                      s_setx[g], a.rules[col]);
            tent = 2 * l + 1 + (left ? 0 : 1);
            atomicAdd(&s_cnt[tent - hi], 1);
          }
        }
        li_o[i] = tent;
      }
      __syncthreads();

      // phase c2: child residual sums, chunk scans added in chunk order
      if (!frozen) {
        for (int w = t; w < nwork; w += T) {
          const int ch = w % G2, qq = w / G2;
          const int r0 = (int)((long long)n * qq / nchunks);
          const int r1 = (int)((long long)n * (qq + 1) / nchunks);
          const int slot = hi + ch;
          float acc = 0.f;
          for (int i = r0; i < r1; ++i)
            if (li_o[i] == slot) acc += resid[i];
          s_part[w] = acc;
        }
        __syncthreads();
        for (int w = t; w < G2; w += T) {
          float tot = 0.f;
          for (int qq = 0; qq < nchunks; ++qq) tot += s_part[qq * G2 + w];
          s_stat[w] = tot;
        }
        __syncthreads();
      }

      // phase d: validate, commit the level and the children
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
      for (int ch = t; ch < G2; ch += T) {
        float new_lf = lf[hi + ch];
        if (s_flags[ch >> 1] & 4) {
          const float cnt = (float)s_cnt[ch];
          const float mu_base = s_stat[ch] / fmaxf(cnt, 1.f) / (float)m;
          new_lf = mu_base + eps[ch] * lsd;
          lf_o[hi + ch] = new_lf;
          ct_o[hi + ch] = cnt;
        }
        s_clf[ch] = new_lf;
      }
      __syncthreads();

      // phase e: final routing, incremental prediction, log-likelihood
      float acc = 0.f;
      for (int i = t; i < n; i += T) {
        const int l = li[i];
        const int tent = li_o[i];
        const bool moved = (l >= lo && l < hi) && (s_flags[l - lo] & 8);
        li_o[i] = moved ? tent : l;
        const float v = moved ? s_clf[tent - hi] : pred[i];
        pred_o[i] = v;
        acc += row_ll(lik, c0, y[i], noi[i], resid[i], wrow ? wrow[i] : 0.f, v);
      }
      const float tot = bart::block_sum(acc, s_red);
      if (t == 0)
        a.ll_buf[(size_t)(d + 1) * CP + q] = lik == kGauss ? -0.5f * tot : tot;
      chain_barrier(a, c, epoch);

      // ---- SMC bookkeeping, the same in every block of the chain ----
      for (int i = t; i < P; i += T) {
        c_ll[i] = a.ll_buf[(size_t)(d + 1) * CP + (size_t)c * P + i];
        if (d == 0) {
          const float l0 = a.ll_buf[(size_t)c * P + i];
          c_lw[i] = l0;
          c_llp[i] = l0;
        }
      }
      __syncthreads();
      if (t < 32) {
        const int lane = t;
        for (int i = lane; i < P; i += 32) c_lw[i] = c_lw[i] + c_ll[i] - c_llp[i];
        __syncwarp();
        if (d < D - 1) {
          if (lane == 0) {
            float mx = -INFINITY;
            for (int i = 1; i < P; ++i) mx = fmaxf(mx, c_lw[i]);
            float tot2 = 0.f;
            for (int i = 1; i < P; ++i) {
              const float e = expf(c_lw[i] - mx);
              c_cdf[i] = e;
              tot2 += e;
            }
            float sumsq = 0.f, run = 0.f;
            c_cdf[0] = 0.f;
            for (int i = 1; i < P; ++i) {
              const float prob = c_cdf[i] / tot2;
              sumsq += prob * prob;
              run += prob;
              c_cdf[i] = run;
            }
            const float last = c_cdf[P - 1];
            for (int i = 0; i < P; ++i) c_cdf[i] = c_cdf[i] / last;
            c_sc[0] = mx + logf(tot2 / (float)(P - 1));
            const float ess = 1.f / fmaxf(sumsq, 1e-38f);
            c_sc[1] = (ess < 0.5f * (float)(P - 1)) ? 1.f : 0.f;
          }
          __syncwarp();
          const bool resample = c_sc[1] != 0.f;
          const float log_mean = c_sc[0];
          const float uu = a.ures[((size_t)b * D + d) * C + c];
          for (int i = lane; i < P; i += 32) {
            int tk = i;
            float w = c_lw[i];
            if (resample && i >= 1) {
              const float pos = (uu + (float)i - 1.f) / (float)(P - 1);
              int cnt = 0;  // searchsorted 'left' into the non-frozen CDF
              for (int j = 1; j < P; ++j) cnt += (c_cdf[j] < pos) ? 1 : 0;
              tk = min(max(cnt + 1, 1), P - 1);
              w = log_mean;
            }
            c_take[i] = tk;
            c_lw[i] = w;
            c_llp[i] = c_ll[tk];
          }
        } else {
          for (int i = lane; i < P; i += 32) c_take[i] = i;
        }
      }
      __syncthreads();
      cur ^= 1;
    }

    if (!leader) continue;

    // ---- winner by inverse CDF over exp(log_w - max) ----
    if (t == 0) {
      float mx = -INFINITY;
      for (int i = 0; i < P; ++i) mx = fmaxf(mx, c_lw[i]);
      float tot = 0.f;
      for (int i = 0; i < P; ++i) tot += expf(c_lw[i] - mx);
      const float uu = a.usel[(size_t)b * C + c] * tot;
      float run = 0.f;
      int cnt = 0;
      for (int i = 0; i < P; ++i) {
        run += expf(c_lw[i] - mx);
        cnt += (run < uu) ? 1 : 0;
      }
      s_widx[0] = min(max(cnt, 0), P - 1);
    }
    __syncthreads();
    const size_t wp = (size_t)cur * CP + (size_t)c * P + s_widx[0];
    const int* sv = a.ps_sv + wp * S; const float* sl = a.ps_sl + wp * S;
    const int* st = a.ps_st + wp * S; const float* lf = a.ps_lf + wp * S;
    const float* ct = a.ps_ct + wp * S;
    const int* li = a.ps_li + wp * n; const float* pred = a.ps_pred + wp * n;
    const int nch2 = imax(1, T / S);

    // structure and counts go to the forest now; the leaves after refinement
    for (int s = t; s < S; s += T) {
      const int v = sv[s];
      const float cn = ct[s];
      a.f_sv[fr + s] = v; a.f_sl[fr + s] = sl[s]; a.f_st[fr + s] = st[s];
      a.f_ct[fr + s] = cn; a.f_sp[fr + s] = 0.f;
      s_lfw[s] = lf[s];
      s_mask[s] = (v < 0 && cn > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();

    // per-leaf residual sums in a fixed order -> prior centres
    for (int w = t; w < S * nch2; w += T) {
      const int s = w % S, qq = w / S;
      const int r0 = (int)((long long)n * qq / nch2);
      const int r1 = (int)((long long)n * (qq + 1) / nch2);
      float acc = 0.f;
      for (int i = r0; i < r1; ++i)
        if (li[i] == s) acc += resid[i];
      s_part2[w] = acc;
    }
    __syncthreads();
    for (int s = t; s < S; s += T) {
      float tot = 0.f;
      for (int qq = 0; qq < nch2; ++qq) tot += s_part2[qq * S + s];
      s_ctr[s] = tot / fmaxf(ct[s], 1.f) / (float)m;
    }
    __syncthreads();

    const float h = 0.5f / (lsd * lsd);
    const float eps_scale = 0.3f * lsd;
    float acc = 0.f;
    for (int i = t; i < n; i += T)
      acc += row_ll(lik, c0, y[i], noi[i], resid[i], wrow ? wrow[i] : 0.f,
                    pred[i]);
    float tot = bart::block_sum(acc, s_red);
    float ll_x = lik == kGauss ? -0.5f * tot : tot;
    acc = 0.f;
    for (int s = t; s < S; s += T) {
      const float dv = s_lfw[s] - s_ctr[s];
      acc += s_mask[s] * dv * dv;
    }
    float ll_c = ll_x - h * bart::block_sum(acc, s_red);

    // R Metropolis sweeps on the leaf values with pre-drawn noise
    bool any = false;
    const float* epsr = a.epsr + ((size_t)b * C + c) * R * S;
    const float* uacc = a.uacc + ((size_t)b * C + c) * R;
    for (int r = 0; r < R; ++r) {
      for (int s = t; s < S; s += T) {
        const float e = epsr[(size_t)r * S + s] * eps_scale;
        s_lfp[s] = s_lfw[s] + e * s_mask[s];
      }
      __syncthreads();
      acc = 0.f;
      for (int i = t; i < n; i += T)
        acc += row_ll(lik, c0, y[i], noi[i], resid[i], wrow ? wrow[i] : 0.f,
                      s_lfp[li[i]]);
      tot = bart::block_sum(acc, s_red);
      ll_x = lik == kGauss ? -0.5f * tot : tot;
      acc = 0.f;
      for (int s = t; s < S; s += T) {
        const float dv = s_lfp[s] - s_ctr[s];
        acc += s_mask[s] * dv * dv;
      }
      const float ll_p = ll_x - h * bart::block_sum(acc, s_red);
      if (logf(uacc[r]) < ll_p - ll_c) {  // the same value in every thread
        for (int s = t; s < S; s += T) s_lfw[s] = s_lfp[s];
        ll_c = ll_p;
        any = true;
      }
      __syncthreads();
    }

    // ---- commit: leaves, tree_pred, sum_trees; adaptation while tuning ----
    for (int s = t; s < S; s += T) a.f_lf[fr + s] = s_lfw[s];
    const float wc = a.wf_count[c] + 1.f;
    float sd_acc = 0.f;
    for (int i = t; i < n; i += T) {
      const float pv = any ? s_lfw[li[i]] : pred[i];
      tp[i] = pv;
      a.sum_trees[(size_t)c * n + i] = noi[i] + pv;
      if (a.tuning) {
        const size_t wi = (size_t)c * n + i;
        const float delta = pv - a.wf_mean[wi];
        const float mean = a.wf_mean[wi] + delta / wc;
        const float m2 = a.wf_m2[wi] + delta * (pv - mean);
        a.wf_mean[wi] = mean;
        a.wf_m2[wi] = m2;
        sd_acc += sqrtf(fmaxf(m2 / fmaxf(wc, 1.f), 1e-12f));
      }
    }
    const int iter = a.iteration[c] + 1;
    if (a.tuning) {
      // split prior: the old weights times the decay, plus one per SPLIT NODE
      for (int j = t; j < p; j += T) a.vi_cnt[(size_t)c * p + j] = 0;
      __syncthreads();
      for (int s = t; s < S; s += T) {
        const int v = sv[s];
        if (v >= 0) atomicAdd(&a.vi_cnt[(size_t)c * p + v], 1);
      }
      __syncthreads();
      for (int j = t; j < p; j += T)
        a.alpha_vec[(size_t)c * p + j] = a.alpha_vec[(size_t)c * p + j] * a.decay
            + (float)a.vi_cnt[(size_t)c * p + j];
      const float sd = bart::block_sum(sd_acc, s_red) / (float)n;
      if (t == 0) {
        a.wf_count[c] = wc;
        if (iter > m) a.leaf_sd[c] = fmaxf(sd, 1e-6f);
      }
    }
    __syncthreads();
    if (t == 0) a.iteration[c] = iter;
    __syncthreads();
  }

  // ---- after the last tree: rotate the batch, count the split variables ----
  if (leader) {
    for (int j = t; j < p; j += T) a.vi_cnt[(size_t)c * p + j] = 0;
    __syncthreads();
    const int* fsv = a.f_sv + (size_t)c * m * S;
    for (int s = t; s < m * S; s += T) {
      const int v = fsv[s];
      if (v >= 0) atomicAdd(&a.vi_cnt[(size_t)c * p + v], 1);
    }
    __syncthreads();
    for (int j = t; j < p; j += T)
      a.vi[(size_t)c * p + j] = (float)a.vi_cnt[(size_t)c * p + j];
    if (t == 0) a.batch_offset[c] = (off0 + a.B) % m;
  }
}

}  // namespace

extern "C" int pgbart_step_args_size() { return (int)sizeof(DrawArgs); }

// Largest number of blocks of this kernel the card keeps resident at once.
extern "C" int pgbart_step_capacity(int D, int P, int S) {
  const size_t bytes = smem_bytes(D, P, S);
  if (bytes > 48 * 1024) {
    if (cudaFuncSetAttribute(pgbart_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
  }
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pgbart_step_kernel, kThreads, bytes) != cudaSuccess
      || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm * sms;
}

// Returns 0, a CUDA error code, or -1 when the C*P blocks cannot all be
// resident (`capacity` comes from pgbart_step_capacity).
// `args` points to a DrawArgs (an untyped pointer: the struct is local to this
// file, and a function that names it in its signature is not exported).
extern "C" int pgbart_step_launch(const void* args, int capacity,
                                  void* stream) {
  DrawArgs a = *static_cast<const DrawArgs*>(args);
  if (a.D < 1 || a.D > kMaxDepth || a.P < 2) return (int)cudaErrorInvalidValue;
  if (a.C * a.P > capacity) return -1;
  const size_t bytes = smem_bytes(a.D, a.P, a.S);
  void* params[] = {(void*)&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)pgbart_step_kernel, dim3(a.C * a.P), dim3(kThreads), params,
      bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
