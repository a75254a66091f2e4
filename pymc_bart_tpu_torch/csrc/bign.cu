// pgbart_step_bign: one whole PGBART step for LARGE n, rows spread over the card.
//
// Replaces the TPU kernel pymc_bart_tpu/ops/bign_pallas.py::pgbart_step_bign
// (body _bign_kernel).  For each of the batch's B trees it runs the full
// conditional SMC over C chains x P particles, commits the winner to the
// forest, tree_pred and sum_trees, adapts the split prior and the Welford
// leaf_sd while tuning, and ends with the variable-inclusion histogram.  The
// sampler state is updated IN PLACE.  Two regimes, as on the TPU:
//   * gauss: SMC weights, winner and R Metropolis leaf refinements are
//     node-space algebra on per-node (count, sum r, sum r^2); the only
//     per-particle row state is the row -> node array li (C*P, n);
//   * bernoulli / het_abs / het_exp / cat_logit: a per-particle prediction
//     row (C*P, n) is carried and the exact row log-likelihood is summed in
//     the routing pass; no refinement.
//
// Bound: bytes.  Per tree and level the three row passes read and write li
// (and the prediction row), read X at one column per row, the residual and,
// in pass 1, the row Gumbels.  Below some ten thousand rows a pass is shorter
// than the gap between two kernels, and the step costs its LAUNCHES; the
// node-space phases between the passes move a few kilobytes and are latency.
//
// Design.  Where draw.cu gives a cluster to a chain and keeps a particle's
// rows on one SM, this file spreads ROWS over the grid: every row pass is a
// grid over (row tile, chain*particle).  The serial node-space bookkeeping
// between two passes is NOT a kernel of its own: every block of a pass writes
// its partial sums, fences, and draws a ticket; the block that draws the last
// ticket (of a particle, or of a chain) adds the tiles IN TILE ORDER and does
// the node-space work in its tail, so the next pass finds it done.  One
// launcher call enqueues the whole step on the caller's stream (per tree: 2
// set-up launches, 3 per level, 2 to select and commit; one more per step);
// nothing returns to the host between them.  Per level d:
//   pass 1  k_argmax  a particle copies its ANCESTOR's li (and prediction)
//                     row from one buffer into its own row of the other (the
//                     resampling gather: two particles may share an ancestor
//                     and then diverge) and finds, per growing node, the row
//                     with the largest Gumbel, ties to the lowest row, by a
//                     64-bit atomicMax on an order-preserving key;
//   pass 2  k_stats   prologue (every block, for its particle): split value
//                     = X[winner row, split variable]; rows: left-child
//                     (count, sum r, sum r^2) per (particle, node); tail (the
//                     particle's last block): empty-child revert, child
//                     leaves and statistics;
//   pass 3  k_route   rows move to the committed children only (no tentative
//                     routing, so nothing is healed later); row regime: the
//                     prediction row and the row log-likelihood; tail (the
//                     chain's last block): log-likelihood, ESS gate and
//                     systematic ancestors on one warp (bart::smc_warp, the
//                     function draw.cu uses), node state gathered at the
//                     ancestors, next level prepared.
// The residual pass k_resid ends likewise with the tree's node-space set-up.
//
// Order of float sums.  Every sum that reaches a discrete decision (ESS gate,
// ancestors, winner, Metropolis accept, empty-child test) is accumulated in
// float64 in a FIXED order (lanes of a warp by a shuffle tree, warps in warp
// order, tiles in tile order) and rounded to float32 once; counts are
// integers.  Element-wise float32 arithmetic is compiled without fused
// multiply-add (-fmad=false) so that it rounds where the plain PyTorch
// version rounds.  No float atomics anywhere; the only atomics are the
// arg-max keys and the tickets.
//
// Row Gumbels are either read from a pre-drawn block (B, D, C, P, n) or
// generated (common.cuh): Philox-4x32-10 keyed by a 64-bit seed (two words on
// the card), counter (row, stream of (tree, level, chain, particle)), so a
// row's value does not depend on the grid.  pgbart_bign_gumbel_block writes
// the block the generator would produce.
#include "common.cuh"

namespace {

using bart::gen_gumbel;
using bart::kThreads;
using bart::pack_key;
using bart::warp_sum_d;

constexpr int kMaxDepth = 8;               // per-block node accumulators
constexpr int kMaxG = 1 << (kMaxDepth - 1);
constexpr int kMaxS = (1 << (kMaxDepth + 1)) - 1;
constexpr int kWarps = kThreads / 32;

enum Lik { kGauss = 0, kBernoulli = 1, kHetAbs = 2, kHetExp = 3, kCatLogit = 4 };
enum Flag { kWant = 1, kActive = 2, kGrowOk = 4, kFinal = 8 };

// Mirrored field by field by ops/bign.py::_BignArgs (ctypes).
struct BignArgs {
  // sampler state, updated in place
  int* f_sv; float* f_sl; float* f_lf; float* f_ct;
  float* tree_pred; float* sum_trees; float* alpha_vec; float* leaf_sd;
  float* wf_count; float* wf_mean; float* wf_m2;
  int* batch_offset; int* iteration;
  // data
  const float* X; const float* y; const float* llw; const float* w_chain;
  // random blocks of the step (rg may be null: generated from the seed)
  const float* ug; const float* uv; const float* rg; const float* eps;
  const float* ures; const float* usel; const float* epsr; const float* uacc;
  const unsigned int* seed;  // two words, read when rg is null
  // per-particle node state, two buffers of (C*P, S)
  int* ns_sv; float* ns_sl; float* ns_lf; float* ns_ct; float* ns_rs;
  float* ns_rq; int* ns_lm;
  // per-(particle, node of the level) arrays (C*P, Gm)
  int* lv_var; int* lv_flags; float* lv_val; float* lv_raw;
  unsigned long long* lv_best;
  // row state: li, pred two buffers of (C*P, n); resid, noi (C, n)
  int* li; float* pred; float* resid; float* noi;
  // per-tile partial sums
  double* part_stat; int* part_cnt; double* part_ll; double* part_root;
  double* part_sd;
  // per chain / per particle scalars
  float* cdf; float* root; float* ll; float* ll_prev; float* log_w;
  float* cdfp; float* prob; float* w_lf; int* take; int* widx; int* vi_cnt;
  // tickets of the passes' last blocks: C (residual), C*P (pass 2), C (pass 3)
  int* tickets;
  // output
  float* vi;
  int C, P, S, n, p, m, B, D, R, lik, tuning, tile, ntiles;
  int y_stride;  // y is one row vector for every chain (0) or one a chain (n)
  // the row Gumbels' streams are those of chains c0 ... c0 + C - 1 of Cg and
  // their counters those of rows row0 ... row0 + n - 1 (a rank of a mesh)
  int Cg, c0, row0;
  float lik_const, decay;
  float p_grow[kMaxDepth];
};

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

// Block-wide float64 sum in a fixed order; every thread gets the total.
__device__ __forceinline__ double block_sum_d(double v, double* scratch) {
  v = warp_sum_d(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) scratch[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int i = 0; i < kWarps; ++i) tot += scratch[i];
    scratch[0] = tot;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// One row's log-likelihood term of a non-Gaussian code at F = noi + pred.
__device__ __forceinline__ float row_ll(int lik, float c0, float y, float F,
                                        float w) {
  if (lik == kBernoulli) return y * F - softplusf(F);
  if (lik == kHetAbs) {
    const float sg = fabsf(F) + c0;
    return -0.5f * w / (sg * sg) - logf(sg);
  }
  if (lik == kHetExp) return -0.5f * w * expf(-2.f * F) - F;
  const float lse = fmaxf(F, w) + log1pf(expf(-fabsf(F - w)));
  return (y > 0.f ? 1.f : 0.f) * F - lse;
}

__device__ __forceinline__ unsigned int gumbel_stream(const BignArgs& a, int b,
                                                      int d, int q) {
  return bart::gumbel_stream(b, d, a.D, a.Cg * a.P, a.c0 * a.P + q);
}

// Every kernel of the step is launched with programmatic stream
// serialization: it may be scheduled while its predecessor still runs, waits
// here until that one has completed and its writes are visible, and lets its
// own successor be scheduled at once.
__device__ __forceinline__ void after_predecessor() {
  cudaGridDependencySynchronize();
  cudaTriggerProgrammaticLaunchCompletion();
}

// One block of a pass has written its partial sums; `count` blocks share the
// ticket.  True in exactly one of them, the last to arrive, which then sees
// every block's partials (and leaves the ticket at zero for the next pass).
__device__ __forceinline__ bool last_block(int* ticket, int count) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1) == count - 1;
    if (s_last) *ticket = 0;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last != 0;
}

struct NodeBuf {
  int* sv; float* sl; float* lf; float* ct; float* rs; float* rq; int* lm;
};

__device__ __forceinline__ NodeBuf node_buf(const BignArgs& a, int buf, int q) {
  const size_t o = ((size_t)buf * a.C * a.P + q) * a.S;
  return {a.ns_sv + o, a.ns_sl + o, a.ns_lf + o, a.ns_ct + o, a.ns_rs + o,
          a.ns_rq + o, a.ns_lm + o};
}

// Exact Gaussian log-likelihood of particle q from its node statistics; one
// warp, every lane returns it.
__device__ __forceinline__ float stats_ll(const BignArgs& a, const NodeBuf& nb,
                                          float w) {
  double acc = 0.0;
  for (int s = threadIdx.x & 31; s < a.S; s += 32) {
    if (nb.lm[s]) {
      const float lf = nb.lf[s];
      acc += (double)(nb.rq[s] - 2.f * lf * nb.rs[s] + lf * lf * nb.ct[s]);
    }
  }
  return (-0.5f * w) * (float)warp_sum_d(acc);
}

// Grow decision, split variable and activity of every (particle, node) of
// level d of chain c, from node buffer `buf`; clears the arg-max keys.
__device__ void prepare_level(const BignArgs& a, int b, int c, int d, int buf) {
  const int P = a.P, p = a.p, Gm = 1 << (a.D - 1), Gtot = (1 << a.D) - 1;
  const int lo = (1 << d) - 1, G = 1 << d;
  const float* cdf = a.cdf + (size_t)c * p;
  const float total = cdf[p - 1];
  for (int it = threadIdx.x; it < P * G; it += blockDim.x) {
    const int pi = it / G, g = it % G, q = c * P + pi;
    const NodeBuf nb = node_buf(a, buf, q);
    const size_t rq = ((size_t)b * a.C + c) * P + pi;
    const bool frozen = pi == 0;
    const int node_sv = nb.sv[lo + g];
    const bool want = (a.ug[rq * Gtot + lo + g] < a.p_grow[d]) && node_sv < 0
        && nb.ct[lo + g] >= 2.f && !frozen;
    const float u_v = a.uv[rq * Gtot + lo + g] * total;
    int l = 0, r = p;  // number of cdf entries < u_v
    while (l < r) {
      const int mid = (l + r) >> 1;
      if (cdf[mid] < u_v) l = mid + 1; else r = mid;
    }
    const int var_s = min(max(l, 0), p - 1);
    const int var = frozen ? min(max(node_sv, 0), p - 1) : var_s;
    const bool active = frozen ? (node_sv >= 0) : want;
    const size_t o = (size_t)q * Gm + g;
    a.lv_var[o] = var;
    a.lv_flags[o] = (want ? kWant : 0) | (active ? kActive : 0);
    a.lv_best[o] = 0ull;
  }
}

// leaf_sd of chain c from the Welford partials of the tree just committed
__device__ void update_leaf_sd(const BignArgs& a, int c) {
  if (!a.tuning || threadIdx.x != 0) return;
  double tot = 0.0;
  for (int t = 0; t < a.ntiles; ++t) tot += a.part_sd[(size_t)t * a.C + c];
  const float sd = (float)tot / (float)a.n;
  if (a.iteration[c] > a.m) a.leaf_sd[c] = fmaxf(sd, 1e-6f);
}

// ---------------------------------------------------------------------------
// per tree: residual, root statistics, particle state
// ---------------------------------------------------------------------------

__device__ void node_init(const BignArgs& a, int b, int c);

// residual pass; its last block of a chain sets up the tree's node space
__global__ void __launch_bounds__(kThreads) k_resid(const BignArgs a, int b) {
  after_predecessor();
  __shared__ double s_red[kWarps];
  const int c = blockIdx.y, n = a.n;
  const int jt = (a.batch_offset[c] + b) % a.m;
  const float* tp = a.tree_pred + ((size_t)c * a.m + jt) * n;
  const int r0 = blockIdx.x * a.tile, r1 = min(n, r0 + a.tile);
  double sr = 0.0, sq = 0.0;
  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
    const float ni = a.sum_trees[(size_t)c * n + i] - tp[i];
    const float r = a.y[(size_t)c * a.y_stride + i] - ni;
    a.noi[(size_t)c * n + i] = ni;
    a.resid[(size_t)c * n + i] = r;
    sr += (double)r;
    sq += (double)(r * r);
  }
  sr = block_sum_d(sr, s_red);
  sq = block_sum_d(sq, s_red);
  if (threadIdx.x == 0) {
    a.part_root[((size_t)blockIdx.x * a.C + c) * 2] = sr;
    a.part_root[((size_t)blockIdx.x * a.C + c) * 2 + 1] = sq;
  }
  if (last_block(a.tickets + c, a.ntiles)) node_init(a, b, c);
}

// the tree's node space of chain c: leaf_sd of the last tree, root statistics,
// split-weight CDF, particle state, level 0 (one block)
__device__ void node_init(const BignArgs& a, int b, int c) {
  const int P = a.P, S = a.S, p = a.p;
  if (b > 0) update_leaf_sd(a, c);
  if (threadIdx.x == 0) {
    double sr = 0.0, sq = 0.0;
    for (int t = 0; t < a.ntiles; ++t) {
      sr += a.part_root[((size_t)t * a.C + c) * 2];
      sq += a.part_root[((size_t)t * a.C + c) * 2 + 1];
    }
    const float root_r = (float)sr;
    a.root[c * 3] = root_r;
    a.root[c * 3 + 1] = (float)sq;
    a.root[c * 3 + 2] = root_r / (float)a.n / (float)a.m;
    double run = 0.0;
    for (int j = 0; j < p; ++j) {
      run += (double)fmaxf(a.alpha_vec[(size_t)c * p + j], 1e-12f);
      a.cdf[(size_t)c * p + j] = (float)run;
    }
  }
  __syncthreads();
  const int jt = (a.batch_offset[c] + b) % a.m;
  const size_t fr = ((size_t)c * a.m + jt) * S;
  const float root_r = a.root[c * 3], root_q = a.root[c * 3 + 1];
  const float root_mu = a.root[c * 3 + 2];
  for (int it = threadIdx.x; it < P * S; it += blockDim.x) {
    const int pi = it / S, s = it % S;
    const NodeBuf nb = node_buf(a, 0, c * P + pi);
    if (pi == 0) {
      nb.sv[s] = a.f_sv[fr + s]; nb.sl[s] = a.f_sl[fr + s];
      nb.lf[s] = a.f_lf[fr + s]; nb.ct[s] = a.f_ct[fr + s];
    } else {
      nb.sv[s] = -1; nb.sl[s] = 0.f;
      nb.lf[s] = s == 0 ? root_mu : 0.f;
      nb.ct[s] = s == 0 ? (float)a.n : 0.f;
    }
    nb.rs[s] = s == 0 ? root_r : 0.f;
    nb.rq[s] = s == 0 ? root_q : 0.f;
    nb.lm[s] = s == 0 ? 1 : 0;
  }
  __syncthreads();
  // gauss: the root's log-likelihood; the row regime sums it in k_rows_init
  if (a.lik == kGauss) {
    const float w = a.w_chain[c];
    for (int pi = threadIdx.x >> 5; pi < P; pi += kWarps) {
      const int q = c * P + pi;
      const float ll = stats_ll(a, node_buf(a, 0, q), w);
      if ((threadIdx.x & 31) == 0) {
        a.ll[q] = ll; a.log_w[q] = ll; a.ll_prev[q] = ll;
      }
    }
  }
  for (int pi = threadIdx.x; pi < P; pi += blockDim.x) a.take[c * P + pi] = pi;
  prepare_level(a, b, c, 0, 0);
}

// li = 0; row regime: the prediction row and the root's row log-likelihood
__global__ void __launch_bounds__(kThreads) k_rows_init(const BignArgs a) {
  after_predecessor();
  __shared__ double s_red[kWarps];
  const int q = blockIdx.y, c = q / a.P, n = a.n;
  int* li = a.li + (size_t)q * n;
  const int r0 = blockIdx.x * a.tile, r1 = min(n, r0 + a.tile);
  if (a.lik == kGauss) {
    for (int i = r0 + threadIdx.x; i < r1; i += kThreads) li[i] = 0;
    return;
  }
  float* pred = a.pred + (size_t)q * n;
  const float pred0 = node_buf(a, 0, q).lf[0];
  const float* noi = a.noi + (size_t)c * n;
  const float* llw = a.llw ? a.llw + (size_t)c * n : nullptr;
  const float* yc = a.y + (size_t)c * a.y_stride;
  double acc = 0.0;
  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
    li[i] = 0;
    pred[i] = pred0;
    acc += (double)row_ll(a.lik, a.lik_const, yc[i], noi[i] + pred0,
                          llw ? llw[i] : 0.f);
  }
  acc = block_sum_d(acc, s_red);
  if (threadIdx.x == 0) a.part_ll[(size_t)blockIdx.x * a.C * a.P + q] = acc;
}

// ---------------------------------------------------------------------------
// per level: the three row passes
// ---------------------------------------------------------------------------

// pass 1: ancestor gather of the row state, Gumbel arg-max per growing node
__global__ void __launch_bounds__(kThreads) k_argmax(const BignArgs a, int b,
                                                     int d, int lbuf) {
  after_predecessor();
  __shared__ unsigned long long s_best[kMaxG];
  __shared__ int s_grow[kMaxG];
  const int q = blockIdx.y, P = a.P, c = q / P, pi = q % P, n = a.n;
  const int lo = (1 << d) - 1, G = 1 << d, Gm = 1 << (a.D - 1);
  const size_t CPn = (size_t)a.C * P * n;
  const int anc = c * P + a.take[q];
  const int* li_s = a.li + (size_t)lbuf * CPn + (size_t)anc * n;
  int* li_d = a.li + (size_t)(1 - lbuf) * CPn + (size_t)q * n;
  const bool rowll = a.lik != kGauss;
  const float* pr_s = a.pred + (size_t)lbuf * CPn + (size_t)anc * n;
  float* pr_d = a.pred + (size_t)(1 - lbuf) * CPn + (size_t)q * n;
  int any = 0;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const int grow = (pi != 0) && (a.lv_flags[(size_t)q * Gm + g] & kWant);
    s_grow[g] = grow;
    s_best[g] = 0ull;
    any |= grow;
  }
  any = __syncthreads_or(any);
  const float* rg = a.rg
      ? a.rg + ((((size_t)b * a.D + d) * a.C + c) * P + pi) * n : nullptr;
  const unsigned int stream = gumbel_stream(a, b, d, q);
  const unsigned int k0 = rg ? 0u : a.seed[0], k1 = rg ? 0u : a.seed[1];
  const int r0 = blockIdx.x * a.tile, r1 = min(n, r0 + a.tile);
  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
    const int l = li_s[i];
    li_d[i] = l;
    if (rowll) pr_d[i] = pr_s[i];
    const int g = l - lo;
    if (any && g >= 0 && g < G && s_grow[g]) {
      const float gum = rg ? rg[i] : gen_gumbel(k0, k1, i, stream);
      atomicMax(&s_best[g], pack_key(gum, i));
    }
  }
  if (!any) return;
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads)
    if (s_best[g]) atomicMax(&a.lv_best[(size_t)q * Gm + g], s_best[g]);
}

__device__ void node_b(const BignArgs& a, int b, int d, int nbuf, int q);

// pass 2: the split value of every active node of the particle (prologue),
// left-child (count, sum r, sum r^2) of every active (particle, node), and in
// the particle's last block the node-space commit of the level
__global__ void __launch_bounds__(kThreads) k_stats(const BignArgs a, int b,
                                                    int d, int lbuf, int nbuf) {
  after_predecessor();
  __shared__ double s_sr[kWarps][kMaxG];
  __shared__ double s_sq[kWarps][kMaxG];
  __shared__ int s_cn[kWarps][kMaxG];
  __shared__ int s_var[kMaxG];
  __shared__ float s_val[kMaxG];
  const int q = blockIdx.y, P = a.P, c = q / P, n = a.n, p = a.p;
  const int lo = (1 << d) - 1, G = 1 << d, Gm = 1 << (a.D - 1);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int any = 0;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const size_t o = (size_t)q * Gm + g;
    const int act = a.lv_flags[o] & kActive;
    const int var = a.lv_var[o];
    // the split value: X at the arg-max row; the frozen particle replays its own
    const unsigned long long key = a.lv_best[o];
    float raw = 0.f;
    if (key) {
      const int r = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
      raw = a.X[(size_t)r * p + var];
    }
    const float val = q % P == 0 ? node_buf(a, nbuf, q).sl[lo + g] : raw;
    if (blockIdx.x == 0) {  // kept for the tail and for pass 3
      a.lv_raw[o] = raw;
      a.lv_val[o] = val;
    }
    s_var[g] = act ? var : -1;
    s_val[g] = val;
    any |= act;
  }
  for (int g = lane; g < G; g += 32) {
    s_sr[w][g] = 0.0; s_sq[w][g] = 0.0; s_cn[w][g] = 0;
  }
  any = __syncthreads_or(any);
  const size_t po = ((size_t)blockIdx.x * a.C * P + q) * Gm;
  if (any) {
    const int* li = a.li + ((size_t)lbuf * a.C * P + q) * n;
    const float* resid = a.resid + (size_t)c * n;
    const int r0 = blockIdx.x * a.tile, r1 = min(n, r0 + a.tile);
    for (int base = r0; base < r1; base += kThreads) {
      const int i = base + threadIdx.x;
      int key = -1;
      float r = 0.f;
      if (i < r1) {
        const int g = li[i] - lo;
        if (g >= 0 && g < G && s_var[g] >= 0
            && a.X[(size_t)i * p + s_var[g]] <= s_val[g]) {
          key = g;
          r = resid[i];
        }
      }
      unsigned int todo = __ballot_sync(0xffffffffu, key >= 0);
      while (todo) {
        const int leader = __ffs(todo) - 1;
        const int gk = __shfl_sync(0xffffffffu, key, leader);
        const bool mine = key == gk;
        const unsigned int mm = __ballot_sync(0xffffffffu, mine);
        const double sr = warp_sum_d(mine ? (double)r : 0.0);
        const double sq = warp_sum_d(mine ? (double)(r * r) : 0.0);
        if (lane == 0) {
          s_sr[w][gk] += sr; s_sq[w][gk] += sq; s_cn[w][gk] += __popc(mm);
        }
        todo &= ~mm;
      }
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    double sr = 0.0, sq = 0.0;
    int cn = 0;
    if (any)
      for (int k = 0; k < kWarps; ++k) {
        sr += s_sr[k][g]; sq += s_sq[k][g]; cn += s_cn[k][g];
      }
    a.part_stat[(po + g) * 2] = sr;
    a.part_stat[(po + g) * 2 + 1] = sq;
    a.part_cnt[po + g] = cn;
  }
  if (last_block(a.tickets + a.C + q, a.ntiles)) node_b(a, b, d, nbuf, q);
}

// node b of particle q: empty-child revert, split commit, child leaves and
// statistics, the tiles added in tile order (one block)
__device__ void node_b(const BignArgs& a, int b, int d, int nbuf, int q) {
  const int P = a.P, c = q / P, pi = q % P, G = 1 << d, Gm = 1 << (a.D - 1);
  const int lo = G - 1, hi = 2 * G - 1, Gtot = (1 << a.D) - 1;
  const float lsd = a.leaf_sd[c], mf = (float)a.m;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const size_t o = (size_t)q * Gm + g;
    int flags = a.lv_flags[o];
    if (!(flags & kActive)) continue;
    const NodeBuf nb = node_buf(a, nbuf, q);
    double sr = 0.0, sq = 0.0;
    int cn = 0;
    for (int t = 0; t < a.ntiles; ++t) {
      const size_t po = ((size_t)t * a.C * P + q) * Gm + g;
      sr += a.part_stat[po * 2]; sq += a.part_stat[po * 2 + 1];
      cn += a.part_cnt[po];
    }
    const float cl = (float)cn, rl = (float)sr, ql = (float)sq;
    const float cr = nb.ct[lo + g] - cl;
    const float rr = nb.rs[lo + g] - rl, qr = nb.rq[lo + g] - ql;
    const bool frozen = pi == 0;
    const bool grow_ok = (flags & kWant) && cl > 0.5f && cr > 0.5f;
    const bool fin = frozen ? true : grow_ok;  // an active frozen node replays
    flags |= (grow_ok ? kGrowOk : 0) | (fin ? kFinal : 0);
    a.lv_flags[o] = flags;
    if (!fin) continue;
    const int cs = hi + 2 * g;
    if (grow_ok) {
      const float* eps = a.eps + (((size_t)b * a.C + c) * P + pi) * 2 * Gtot
          + 2 * lo + 2 * g;
      nb.sv[lo + g] = a.lv_var[o];
      nb.sl[lo + g] = a.lv_raw[o];
      nb.lf[cs] = rl / fmaxf(cl, 1.f) / mf + eps[0] * lsd;
      nb.lf[cs + 1] = rr / fmaxf(cr, 1.f) / mf + eps[1] * lsd;
      nb.ct[cs] = cl;
      nb.ct[cs + 1] = cr;
    }
    nb.rs[cs] = rl; nb.rs[cs + 1] = rr;
    nb.rq[cs] = ql; nb.rq[cs + 1] = qr;
    nb.lm[cs] = 1; nb.lm[cs + 1] = 1;
    nb.lm[lo + g] = 0;
  }
}

__device__ void node_c(const BignArgs& a, int b, int c, int d, int nbuf);

// pass 3: rows move to the committed children; row regime: prediction row
// and row log-likelihood; in the chain's last block the SMC step of the level
__global__ void __launch_bounds__(kThreads) k_route(const BignArgs a, int b,
                                                    int d, int lbuf, int nbuf) {
  after_predecessor();
  __shared__ double s_red[kWarps];
  __shared__ int s_var[kMaxG];
  __shared__ float s_val[kMaxG];
  __shared__ float s_lfc[2 * kMaxG];
  const int q = blockIdx.y, P = a.P, c = q / P, n = a.n, p = a.p;
  const int lo = (1 << d) - 1, G = 1 << d, hi = 2 * G - 1, Gm = 1 << (a.D - 1);
  const bool rowll = a.lik != kGauss;
  const NodeBuf nb = node_buf(a, nbuf, q);
  int any = 0;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const size_t o = (size_t)q * Gm + g;
    const int fin = a.lv_flags[o] & kFinal;
    s_var[g] = fin ? a.lv_var[o] : -1;
    s_val[g] = a.lv_val[o];
    s_lfc[2 * g] = nb.lf[hi + 2 * g];
    s_lfc[2 * g + 1] = nb.lf[hi + 2 * g + 1];
    any |= fin;
  }
  any = __syncthreads_or(any);
  const size_t ro = ((size_t)lbuf * a.C * P + q) * n;
  int* li = a.li + ro;
  float* pred = a.pred + ro;
  const float* noi = a.noi + (size_t)c * n;
  const float* llw = a.llw ? a.llw + (size_t)c * n : nullptr;
  const float* yc = a.y + (size_t)c * a.y_stride;
  const int r0 = blockIdx.x * a.tile, r1 = min(n, r0 + a.tile);
  double acc = 0.0;
  for (int i = r0 + threadIdx.x; (any || rowll) && i < r1; i += kThreads) {
    const int l = li[i];
    const int g = l - lo;
    float v = rowll ? pred[i] : 0.f;
    if (g >= 0 && g < G && s_var[g] >= 0) {
      const bool left = a.X[(size_t)i * p + s_var[g]] <= s_val[g];
      const int nl = 2 * l + 1 + (left ? 0 : 1);
      li[i] = nl;
      if (rowll) {
        v = s_lfc[nl - hi];
        pred[i] = v;
      }
    }
    if (rowll)
      acc += (double)row_ll(a.lik, a.lik_const, yc[i], noi[i] + v,
                            llw ? llw[i] : 0.f);
  }
  if (rowll) {
    acc = block_sum_d(acc, s_red);
    if (threadIdx.x == 0)
      a.part_ll[((size_t)a.ntiles + blockIdx.x) * a.C * P + q] = acc;
  }
  if (last_block(a.tickets + a.C + a.C * P + c, a.ntiles * P))
    node_c(a, b, c, d, nbuf);
}

// node c of chain c: log-likelihood (tiles in tile order), weights, ESS gate,
// ancestors, node-state gather, next level (one block)
__device__ void node_c(const BignArgs& a, int b, int c, int d, int nbuf) {
  const int P = a.P, S = a.S, D = a.D;
  const size_t CP = (size_t)a.C * P;
  if (a.lik == kGauss) {
    const float w = a.w_chain[c];
    for (int pi = threadIdx.x >> 5; pi < P; pi += kWarps) {
      const float ll = stats_ll(a, node_buf(a, nbuf, c * P + pi), w);
      if ((threadIdx.x & 31) == 0) a.ll[c * P + pi] = ll;
    }
  } else {
    for (int pi = threadIdx.x; pi < P; pi += blockDim.x) {
      const int q = c * P + pi;
      double tot = 0.0;
      for (int t = 0; t < a.ntiles; ++t)
        tot += a.part_ll[((size_t)a.ntiles + t) * CP + q];
      a.ll[q] = (float)tot;
      if (d == 0) {  // the root's log-likelihood starts the weights
        double t0 = 0.0;
        for (int t = 0; t < a.ntiles; ++t) t0 += a.part_ll[(size_t)t * CP + q];
        a.log_w[q] = (float)t0;
        a.ll_prev[q] = (float)t0;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 32)
    bart::smc_warp(a.log_w + c * P, a.ll_prev + c * P, a.ll + c * P,
                   a.cdfp + c * P, a.prob + c * P, a.take + c * P, P,
                   a.ures[((size_t)b * D + d) * a.C + c], d < D - 1);
  if (d == D - 1) return;
  __syncthreads();
  // every particle continues from its ancestor's node state
  for (int it = threadIdx.x; it < P * S; it += blockDim.x) {
    const int pi = it / S, s = it % S;
    const NodeBuf src = node_buf(a, nbuf, c * P + a.take[c * P + pi]);
    const NodeBuf dst = node_buf(a, 1 - nbuf, c * P + pi);
    dst.sv[s] = src.sv[s]; dst.sl[s] = src.sl[s]; dst.lf[s] = src.lf[s];
    dst.ct[s] = src.ct[s]; dst.rs[s] = src.rs[s]; dst.rq[s] = src.rq[s];
    dst.lm[s] = src.lm[s];
  }
  __syncthreads();
  prepare_level(a, b, c, d + 1, 1 - nbuf);
}

// ---------------------------------------------------------------------------
// per tree: winner, refinement, commit, adaptation
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) k_select(const BignArgs a, int b,
                                                     int nbuf) {
  after_predecessor();
  __shared__ double s_red[kWarps];
  __shared__ float s_lfw[kMaxS];
  __shared__ float s_lfp[kMaxS];
  __shared__ int s_widx;
  const int c = blockIdx.x, P = a.P, S = a.S, p = a.p, R = a.R, T = blockDim.x;
  const int t = threadIdx.x;
  if (t == 0) {
    const float* lw = a.log_w + c * P;
    float mx = -INFINITY;
    for (int i = 0; i < P; ++i) mx = fmaxf(mx, lw[i]);
    float tot = 0.f;
    for (int i = 0; i < P; ++i) tot += expf(lw[i] - mx);
    const float uu = a.usel[(size_t)b * a.C + c] * tot;
    float run = 0.f;
    int cnt = 0;
    for (int i = 0; i < P; ++i) {
      run += expf(lw[i] - mx);
      cnt += (run < uu) ? 1 : 0;
    }
    s_widx = min(max(cnt, 0), P - 1);
    a.widx[c] = s_widx;
  }
  __syncthreads();
  const NodeBuf nb = node_buf(a, nbuf, c * P + s_widx);
  const int jt = (a.batch_offset[c] + b) % a.m;
  const size_t fr = ((size_t)c * a.m + jt) * S;
  for (int s = t; s < S; s += T) {
    a.f_sv[fr + s] = nb.sv[s]; a.f_sl[fr + s] = nb.sl[s];
    a.f_ct[fr + s] = nb.ct[s];
    s_lfw[s] = nb.lf[s];
  }
  __syncthreads();
  if (a.lik == kGauss) {
    // R Metropolis sweeps on the leaf values, on the node statistics
    const float lsd = a.leaf_sd[c], w = a.w_chain[c], mf = (float)a.m;
    const float hiv = 0.5f / (lsd * lsd), eps_scale = 0.3f * lsd;
    const float* epsr = a.epsr + ((size_t)b * a.C + c) * R * S;
    const float* uacc = a.uacc + ((size_t)b * a.C + c) * R;
    float ll_c = 0.f;
    for (int r = -1; r < R; ++r) {  // r = -1 scores the current leaves
      double q_acc = 0.0, p_acc = 0.0;
      for (int s = t; s < S; s += T) {
        const bool mask = nb.sv[s] < 0 && nb.ct[s] > 0.f;
        float lf = s_lfw[s];
        if (r >= 0) {
          lf = lf + epsr[(size_t)r * S + s] * eps_scale * (mask ? 1.f : 0.f);
          s_lfp[s] = lf;
        }
        if (nb.lm[s])
          q_acc += (double)(nb.rq[s] - 2.f * lf * nb.rs[s] + lf * lf * nb.ct[s]);
        if (mask) {
          const float dv = lf - nb.rs[s] / fmaxf(nb.ct[s], 1.f) / mf;
          p_acc += (double)(dv * dv);
        }
      }
      const float qs = (float)block_sum_d(q_acc, s_red);
      const float ps = (float)block_sum_d(p_acc, s_red);
      const float ll_x = (-0.5f * w) * qs + (-hiv) * ps;
      if (r < 0) {
        ll_c = ll_x;
      } else if (logf(uacc[r]) < ll_x - ll_c) {  // the same in every thread
        for (int s = t; s < S; s += T) s_lfw[s] = s_lfp[s];
        ll_c = ll_x;
      }
      __syncthreads();
    }
  }
  for (int s = t; s < S; s += T) {
    a.f_lf[fr + s] = s_lfw[s];
    a.w_lf[(size_t)c * S + s] = s_lfw[s];
  }
  if (a.tuning) {
    // split prior: the old weights times the decay, plus one per split node
    for (int j = t; j < p; j += T) a.vi_cnt[(size_t)c * p + j] = 0;
    __syncthreads();
    for (int s = t; s < S; s += T) {
      const int v = nb.sv[s];
      if (v >= 0) atomicAdd(&a.vi_cnt[(size_t)c * p + v], 1);
    }
    __syncthreads();
    for (int j = t; j < p; j += T)
      a.alpha_vec[(size_t)c * p + j] = a.alpha_vec[(size_t)c * p + j] * a.decay
          + (float)a.vi_cnt[(size_t)c * p + j];
    if (t == 0) a.wf_count[c] = a.wf_count[c] + 1.f;
  }
  if (t == 0) a.iteration[c] = a.iteration[c] + 1;
}

// final row pass: the winner's prediction row into tree_pred and sum_trees,
// the Welford accumulators while tuning
__global__ void __launch_bounds__(kThreads) k_final(const BignArgs a, int b,
                                                    int lbuf) {
  after_predecessor();
  __shared__ double s_red[kWarps];
  __shared__ float s_lfw[kMaxS];
  const int c = blockIdx.y, P = a.P, n = a.n, S = a.S;
  const bool rowll = a.lik != kGauss;
  if (!rowll) {
    for (int s = threadIdx.x; s < S; s += kThreads)
      s_lfw[s] = a.w_lf[(size_t)c * S + s];
    __syncthreads();
  }
  const size_t ro = ((size_t)lbuf * a.C * P + c * P + a.widx[c]) * n;
  const int* li = a.li + ro;
  const float* pred = a.pred + ro;
  const int jt = (a.batch_offset[c] + b) % a.m;
  float* tp = a.tree_pred + ((size_t)c * a.m + jt) * n;
  const float* noi = a.noi + (size_t)c * n;
  const float wc = a.wf_count[c];  // already counts this tree
  const int r0 = blockIdx.x * a.tile, r1 = min(n, r0 + a.tile);
  double acc = 0.0;
  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
    const float pv = rowll ? pred[i] : s_lfw[li[i]];
    tp[i] = pv;
    a.sum_trees[(size_t)c * n + i] = noi[i] + pv;
    if (a.tuning) {
      const size_t wi = (size_t)c * n + i;
      const float delta = pv - a.wf_mean[wi];
      const float mean = a.wf_mean[wi] + delta / wc;
      const float m2 = a.wf_m2[wi] + delta * (pv - mean);
      a.wf_mean[wi] = mean;
      a.wf_m2[wi] = m2;
      acc += (double)sqrtf(fmaxf(m2 / fmaxf(wc, 1.f), 1e-12f));
    }
  }
  if (!a.tuning) return;
  acc = block_sum_d(acc, s_red);
  if (threadIdx.x == 0) a.part_sd[(size_t)blockIdx.x * a.C + c] = acc;
}

// after the last tree: leaf_sd, the batch pointer, the split-variable histogram
__global__ void __launch_bounds__(kThreads) k_finish(const BignArgs a) {
  after_predecessor();
  const int c = blockIdx.x, p = a.p, T = blockDim.x, t = threadIdx.x;
  update_leaf_sd(a, c);
  for (int j = t; j < p; j += T) a.vi_cnt[(size_t)c * p + j] = 0;
  __syncthreads();
  const int* fsv = a.f_sv + (size_t)c * a.m * a.S;
  for (int s = t; s < a.m * a.S; s += T) {
    const int v = fsv[s];
    if (v >= 0) atomicAdd(&a.vi_cnt[(size_t)c * p + v], 1);
  }
  __syncthreads();
  for (int j = t; j < p; j += T)
    a.vi[(size_t)c * p + j] = (float)a.vi_cnt[(size_t)c * p + j];
  if (t == 0) a.batch_offset[c] = (a.batch_offset[c] + a.B) % a.m;
}

// the block of row Gumbels the generator produces, (B, D, C, P, n): block
// row blockIdx.y = (b D + d) C P + q of this block, the stream of its tree,
// level and global chain
__global__ void __launch_bounds__(kThreads) k_gumbel_block(const BignArgs a,
                                                           float* out) {
  const int CP = a.C * a.P, bd = blockIdx.y / CP, q = blockIdx.y % CP;
  const unsigned int stream =
      bart::gumbel_stream(bd / a.D, bd % a.D, a.D, a.Cg * a.P, a.c0 * a.P + q);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n)
    out[(size_t)blockIdx.y * a.n + i] =
        gen_gumbel(a.seed[0], a.seed[1], a.row0 + i, stream);
}

bool valid(const BignArgs& a) {
  return a.D >= 1 && a.D <= kMaxDepth && a.P >= 2 && a.C >= 1 && a.n >= 1
      && a.S == (1 << (a.D + 1)) - 1 && a.tile >= 1
      && a.ntiles == (a.n + a.tile - 1) / a.tile && (a.rg || a.seed)
      && a.c0 >= 0 && a.c0 + a.C <= a.Cg && a.row0 == 0
      && a.tickets != nullptr;
}

}  // namespace

#define BIGN_LAUNCH(...)                                   \
  do {                                                     \
    __VA_ARGS__;                                           \
    const cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return (int)e_;                 \
  } while (0)

namespace {

// one kernel of the step, allowed to be scheduled before its predecessor ends
template <class... Params, class... Args>
cudaError_t launch_step(void (*kernel)(Params...), dim3 grid, cudaStream_t st,
                        bool overlap, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, Params(args)...);
}

}  // namespace

#define BIGN_STEP(kernel, grid, overlap, ...)                                  \
  do {                                                                         \
    const cudaError_t e_ = launch_step(kernel, grid, st, overlap, __VA_ARGS__); \
    if (e_ != cudaSuccess) return (int)e_;                                     \
    ++*launched;                                                               \
  } while (0)

extern "C" int pgbart_bign_args_size() { return (int)sizeof(BignArgs); }
extern "C" int pgbart_bign_max_depth() { return kMaxDepth; }

// Enqueues one whole step on `stream`: B * (4 + 3 D) + 1 kernels (the count
// ops/bign.py::launches_per_step predicts) after one memset of the tickets;
// returns 0 or a CUDA error code, and leaves in `*launched` the kernels it
// enqueued.
// `args` points to a BignArgs (an untyped pointer: the struct is local to this
// file, and a function that names it in its signature is not exported).
extern "C" int pgbart_bign_launch(const void* args, void* stream_,
                                  int* launched) {
  *launched = 0;
  const BignArgs a = *static_cast<const BignArgs*>(args);
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_;
  const dim3 rows_c(a.ntiles, a.C), rows_q(a.ntiles, a.C * a.P);
  const cudaError_t e0 = cudaMemsetAsync(
      a.tickets, 0, sizeof(int) * (size_t)(2 * a.C + a.C * a.P), st);
  if (e0 != cudaSuccess) return (int)e0;
  const dim3 chains(a.C);
  for (int b = 0; b < a.B; ++b) {
    int lbuf = 0, nbuf = 0;
    // (the step's first kernel follows a memset, not a kernel)
    BIGN_STEP(k_resid, rows_c, b > 0, a, b);
    BIGN_STEP(k_rows_init, rows_q, true, a);
    for (int d = 0; d < a.D; ++d) {
      BIGN_STEP(k_argmax, rows_q, true, a, b, d, lbuf);
      lbuf ^= 1;
      BIGN_STEP(k_stats, rows_q, true, a, b, d, lbuf, nbuf);
      BIGN_STEP(k_route, rows_q, true, a, b, d, lbuf, nbuf);
      if (d < a.D - 1) nbuf ^= 1;
    }
    BIGN_STEP(k_select, chains, true, a, b, nbuf);
    BIGN_STEP(k_final, rows_c, true, a, b, lbuf);
  }
  BIGN_STEP(k_finish, chains, true, a);
  return 0;
}

// Writes the (B, D, C, P, n) block of generated row Gumbels to `out`.
extern "C" int pgbart_bign_gumbel_block(const void* args, float* out,
                                        void* stream_) {
  const BignArgs a = *static_cast<const BignArgs*>(args);
  if (a.n < 1 || !a.seed || a.c0 < 0 || a.c0 + a.C > a.Cg || a.row0 < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.n + kThreads - 1) / kThreads, a.B * a.D * a.C * a.P);
  BIGN_LAUNCH(k_gumbel_block<<<grid, kThreads, 0, (cudaStream_t)stream_>>>(a, out));
  return 0;
}
