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
// sampler state is updated IN PLACE; the random numbers are arguments, except
// the row Gumbels, which are generated here when no block is given (the TPU
// kernel's rng_mode="kernel").
//
// Bound: bytes by the count (the small random blocks, the forest rows and
// tree_pred rows of the B updated trees, X, y: about 1 MB at the main shapes
// once the Gumbels are generated), but the step is a chain of about 70 short
// dependent phases per tree, so LATENCY sets its time: how long a phase
// takes to fetch its operands, and how long the particles of a chain take to
// meet.  The design keeps both on the SM.
//
// Design.
//   * One thread-block CLUSTER per chain (cudaLaunchKernelEx with a cluster
//     dimension): chains never wait for each other, and the blocks of a
//     cluster are co-scheduled by the hardware, so nothing has to be resident
//     beyond it.  The chain's P particles are spread over the cluster's CS
//     blocks, PB to a block (idle slots where P does not divide), each
//     particle worked by a team of WP warps.  The particles meet once per
//     level and a few times per tree at the hardware cluster barrier; the P
//     log-likelihoods and all partial sums are exchanged by stores into the
//     other blocks' shared memory (distributed shared memory).
//   * Per-particle state lives in shared memory (form "shared"): the five
//     node arrays and the row -> node array li (16 bits a row) in TWO
//     buffers.  At level d a particle copies its ancestor take[q] from one
//     buffer (another block's, through distributed shared memory, or its own)
//     into its slot of the other and then works there, so no particle
//     overwrites state another one still has to read; the cluster barrier
//     separates "everyone has written" from "anyone copies an ancestor".
//     The prediction row is not stored: pred[i] == leaf[li[i]] at all times.
//     y, the row data, the residual base of the tree, the tree's random
//     blocks, the split-weight CDF and, where it fits, X are staged in every
//     block, so that no phase of a level waits for device memory.  Where a
//     chain's rows or node arrays do not fit (large n, deep trees) the same
//     kernel keeps the node arrays and li in global memory (form "global"),
//     reads the tree's random blocks where they are, and takes the child
//     sums and the blocks' leaf sums in global scratch, so that a block's
//     shared memory holds one level's decisions and the winner only;
//     ops/draw.py chooses the form from the shapes alone.
//   * A row pass costs what the data needs: rows are touched only in nodes
//     that grow (the Gumbel arg-max, generated Gumbels included), only in
//     active nodes (child counts and residual sums) or final ones (routing),
//     and a particle none of whose nodes changed at a level inherits its
//     ancestor's log-likelihood instead of summing it again.
//   * Sums keyed by node (child residual sums, the winner's leaf sums): no
//     serial scan.  A residual becomes a fixed-point integer; the lanes of a
//     warp that hold one node are found by a match, their values added by
//     32-bit warp reductions, and one lane adds the group's sum to the
//     block's accumulator with an integer atomic.  The Gumbel arg-max
//     likewise: one warp maximum and one 64-bit atomicMax per warp and node.
//   * The SMC bookkeeping (bart::smc_warp) runs on one warp in every block of
//     the chain on the same P log-likelihoods: the same code on the same
//     inputs, so all blocks hold the same ancestors without another barrier.
//   * The whole cluster works on the tree's preparation and commit (rows
//     split over the blocks) and on its tail: in the global form the leaf
//     sums and the R + 1 refinement row passes are split by rows, partial
//     sums meeting in every block and added in block order; in the shared
//     form a pass over the rows costs less than a cluster barrier, so every
//     block makes it whole and all hold the same sums without meeting.
//
// Order of float sums (discrete decisions must not flip from run to run):
// the log-likelihood, prior and Welford sums are accumulated in float64 in a
// FIXED order (lanes by a shuffle tree, warps in warp order, blocks in rank
// order) and rounded to float32 once; the sums keyed by node (child residual
// sums, the winner's leaf sums) are taken in fixed point, where addition has
// no order; the sums of the resampling step and the winner's CDF are shuffle
// trees and ladders of a fixed shape (bart::smc_warp); the split-weight CDF
// over the p columns is a float64 running sum rounded once per entry (the
// plain version reproduces it with a float64 cumsum); counts are popcounts.
// NaN-able values (split values) are selected, never blended.
// The plain version (sampler/pgbart.py::step_rounds with ops/grow.py,
// ops/select.py) takes the same sums the same way (ops/sums.py: float64
// rounded once, and the same fixed point with the same per-tree scale), and
// this file is compiled without fused multiply-add (ops/_build.py), so every
// float32 product is rounded before it is added, as PyTorch rounds it: the
// two then round the same numbers and agree in every discrete decision.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bart::gen_gumbel;
using bart::go_left;
using bart::keyed_add;
using bart::keyed_max;
using bart::pack_key;
using bart::to_fixed;
using bart::warp_sum_d;

constexpr int kMaxDepth = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr unsigned int kFull = 0xffffffffu;

enum Lik { kGauss = 0, kBernoulli = 1, kHetAbs = 2, kHetExp = 3, kCatLogit = 4 };
enum Flag { kWant = 1, kFinal = 2 };  // a node wants to grow; its rows move

// Mirrored field by field by ops/draw.py::_DrawArgs (ctypes).
struct DrawArgs {
  // sampler state, updated in place
  int* f_sv; float* f_sl; int* f_st; float* f_lf; float* f_ct; float* f_sp;
  float* tree_pred; float* sum_trees; float* alpha_vec; float* leaf_sd;
  float* wf_count; float* wf_mean; float* wf_m2;
  int* batch_offset; int* iteration;
  // data
  const float* X; const float* y; const int* rules; const float* lik_row;
  // random blocks of the step (rg may be null: generated from the seed)
  const float* ug; const float* uv; const float* rg; const float* eps;
  const int* sb; const float* ures; const float* usel; const float* epsr;
  const float* uacc;
  const unsigned int* seed;  // two words, read when rg is null
  // scratch; the per-particle arrays and the per-node sums only in the
  // global form
  int* ps_sv; float* ps_sl; int* ps_st; float* ps_lf; float* ps_ct;
  int* ps_li; float* noi;
  long long* g_acc; int* g_cnt;  // child sums and counts (2 Gm a particle)
  long long* g_leaf;             // a block's leaf sums (S a block)
  float* cdf; int* vi_cnt;
  // output
  float* vi;
  int C, P, S, n, p, m, B, D, R, lik, tuning;
  // the launch plan of ops/draw.py: cluster size, particle slots of a block,
  // warps of a particle's team, the form, whether X and the CDF are staged
  int CS, PB, WP, shared_form, x_staged, cdf_staged;
  // y is one row vector for every chain (0) or one a chain (n)
  int y_stride;
  // the row Gumbels' streams are those of chains c0 ... c0 + C - 1 of Cg
  // (a rank of a mesh runs its block of the chains)
  int Cg, c0;
  float lik_const, decay;
  float p_grow[kMaxDepth];
};

struct Plan { int D, P, S, n, p, R, CS, PB, WP, shared_form, x_staged, cdf_staged; };

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

// ---------------------------------------------------------------------------
// dynamic shared memory of one block (mirrored by ops/draw.py::smem_bytes)
// ---------------------------------------------------------------------------

struct Smem {
  // per particle slot, per node of the level (PB x Gm)
  unsigned long long* best;
  int *varx, *vars, *setx, *flags;
  float *valx;
  // shared form, per particle slot: the tree's random blocks (Gtot each,
  // eps 2 Gtot); the global form reads them where they are
  float *r_ug, *r_uv, *r_eps; int* r_sb;
  // fixed-point residual sums and counts per particle slot and child
  // (PB x 2Gm; shared form, else in global scratch), fixed-point residual
  // sums per leaf of the winner (S)
  long long* acc_ch; int* cnt_ch; long long* acc_lf;
  double* wpart;            // 4 W: two buffers of two warp partials
  int* any;                 // PB team flags: 1 a node wants to grow, 2 a node is final
  // the chain's particles (P each; ll holds two levels)
  float *lw, *llp, *ll, *ll0, *cdfp, *prob; int* take; int* widx;
  // partial sums of the cluster's blocks, written by their owners (the
  // leaf sums of the global form meet in global scratch)
  double *x_prep, *x_ll; long long* x_leaf;
  // the winner (S each), the tree's refinement noise (R x S; shared form),
  // its uniforms
  float *lfw, *lfp, *mask, *ctr, *wct; int* wsv;
  float *r_epsr, *r_misc;
  float* cdf;               // p, when staged
  float* X; int* rules;     // n x p and p, when staged
  // shared form: staged rows and sum_trees (n each); per buffer and slot one record of the
  // five node arrays (S4 words each) and li (n8 x 16 bits); the winner's li
  float *y, *noi, *w, *st;
  unsigned int* rec;
  unsigned short* wli;
};

template <class T>
__host__ __device__ inline T* carve(unsigned char* base, size_t& off, size_t count) {
  off = (off + 15) & ~(size_t)15;
  T* r = reinterpret_cast<T*>(base + off);
  off += count * sizeof(T);
  return r;
}

// 32-bit words of one particle's record in the shared form
__host__ __device__ inline int record_words(int S, int n) {
  return 5 * round4(S) + round8(n) / 2;
}

__host__ __device__ inline size_t layout(Smem& s, unsigned char* base, const Plan& q) {
  const size_t Gm = (size_t)1 << (q.D - 1), Gtot = ((size_t)1 << q.D) - 1;
  const size_t PB = q.PB, W = PB * q.WP, S = q.S, P = q.P, CS = q.CS;
  size_t off = 0;
  s.best = carve<unsigned long long>(base, off, PB * Gm);
  s.varx = carve<int>(base, off, PB * Gm);
  s.vars = carve<int>(base, off, PB * Gm);
  s.setx = carve<int>(base, off, PB * Gm);
  s.flags = carve<int>(base, off, PB * Gm);
  s.valx = carve<float>(base, off, PB * Gm);
  if (q.shared_form) {
    s.r_ug = carve<float>(base, off, PB * Gtot);
    s.r_uv = carve<float>(base, off, PB * Gtot);
    s.r_eps = carve<float>(base, off, PB * 2 * Gtot);
    s.r_sb = carve<int>(base, off, PB * Gtot);
    s.acc_ch = carve<long long>(base, off, PB * 2 * Gm);
    s.cnt_ch = carve<int>(base, off, PB * 2 * Gm);
  }
  s.acc_lf = carve<long long>(base, off, S);
  s.wpart = carve<double>(base, off, 4 * W);
  s.any = carve<int>(base, off, PB);
  s.lw = carve<float>(base, off, P);
  s.llp = carve<float>(base, off, P);
  s.ll = carve<float>(base, off, 2 * P);
  s.ll0 = carve<float>(base, off, P);
  s.cdfp = carve<float>(base, off, P);
  s.prob = carve<float>(base, off, P);
  s.take = carve<int>(base, off, P);
  s.widx = carve<int>(base, off, 4);
  s.x_prep = carve<double>(base, off, 3 * CS);
  s.x_ll = carve<double>(base, off, 2 * CS);
  if (q.shared_form) s.x_leaf = carve<long long>(base, off, S);
  s.lfw = carve<float>(base, off, S);
  s.lfp = carve<float>(base, off, S);
  s.mask = carve<float>(base, off, S);
  s.ctr = carve<float>(base, off, S);
  s.wct = carve<float>(base, off, S);
  s.wsv = carve<int>(base, off, S);
  if (q.shared_form) s.r_epsr = carve<float>(base, off, (size_t)q.R * S);
  s.r_misc = carve<float>(base, off, (size_t)q.D + 1 + q.R);
  if (q.cdf_staged) s.cdf = carve<float>(base, off, q.p);
  if (q.x_staged) {
    s.X = carve<float>(base, off, (size_t)q.n * q.p);
    s.rules = carve<int>(base, off, q.p);
  }
  if (q.shared_form) {
    s.y = carve<float>(base, off, q.n);
    s.noi = carve<float>(base, off, q.n);
    s.w = carve<float>(base, off, q.n);
    s.st = carve<float>(base, off, q.n);
    s.rec = carve<unsigned int>(base, off, 2 * PB * (size_t)record_words(q.S, q.n));
    s.wli = carve<unsigned short>(base, off, round8(q.n));
  }
  return (off + 15) & ~(size_t)15;
}

inline Plan plan_of(const DrawArgs& a) {
  return Plan{a.D, a.P, a.S, a.n, a.p, a.R, a.CS, a.PB, a.WP, a.shared_form,
              a.x_staged, a.cdf_staged};
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// One row's term of the log-likelihood sum.  For gauss the caller multiplies
// the sum by -1/2; for the other codes the sum is the log-likelihood.
__device__ __forceinline__ float row_ll(int lik, float c0, float y, float noi,
                                        float w, float pred) {
  if (lik == kGauss) {
    const float df = (y - noi) - pred;
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

// Sums keyed by node: fixed point, bart::to_fixed / keyed_add (common.cuh),
// with the tree's residual scale.

// the row of the largest Gumbel from its packed key (row 0 for no key)
__device__ __forceinline__ int key_row(unsigned long long key) {
  return key ? (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull)) : 0;
}

// pointers to one particle's state in one buffer
template <class LiT>
struct Part {
  int* sv; float* sl; int* st; float* lf; float* ct; LiT* li;
};

// Phase clocks (compiled in with -DDRAW_PHASE_CLOCKS, as
// scripts/draw_phase_clocks.py builds the file; the package never does):
// cycles that thread 0 of one block of chain 0's cluster spends up to each
// stamp, summed over the launches since the last reset.
#ifdef DRAW_PHASE_CLOCKS
__device__ long long g_clock[16];
__device__ int g_clock_rank;
#define STAMP(k)                                                 \
  do {                                                           \
    if (clock_on) {                                              \
      const long long now_ = clock64();                          \
      atomicAdd((unsigned long long*)&g_clock[k],                \
                (unsigned long long)(now_ - clock_prev));        \
      clock_prev = now_;                                         \
    }                                                            \
  } while (0)
#else
#define STAMP(k) do { } while (0)
#endif

extern __shared__ __align__(16) unsigned char smem_raw[];

// kSh: per-particle state in shared memory (li in 16 bits), else in global
template <bool kSh>
__global__ void __launch_bounds__(kMaxThreads, 1) pgbart_step_kernel(const DrawArgs a) {
  using LiT = typename std::conditional<kSh, unsigned short, int>::type;
  using PartT = Part<LiT>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, P = a.P, S = a.S, n = a.n, p = a.p, m = a.m, D = a.D;
  const int R = a.R, lik = a.lik, CS = a.CS, PB = a.PB, WP = a.WP;
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / CS;
  const int T = blockDim.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int W = T >> 5;
  const int slot = warp / WP, tw = warp % WP, tt = tw * 32 + lane, TT = WP * 32;
  const int pi = rank * PB + slot;
  const bool valid = pi < P;
  const bool frozen = pi == 0;  // the frozen particle replays the current tree
  const int q = c * P + pi;
  const int Gm = 1 << (D - 1), Gtot = (1 << D) - 1;
  const int S4 = round4(S), RW = record_words(S, n);
  const float c0 = a.lik_const;
  const size_t CP = (size_t)C * P;
  // the tail's sums: the global form splits the rows over the cluster and
  // adds the blocks' partials; the shared form sums all rows in every block
  constexpr bool kSplit = !kSh;
  const int TR = kSplit ? CS : 1, my = kSplit ? rank : 0;
#ifdef DRAW_PHASE_CLOCKS
  const bool clock_on = t == 0 && c == 0 && rank == min(g_clock_rank, CS - 1);
  long long clock_prev = clock64();
#endif

  Smem s = {};
  layout(s, smem_raw, Plan{D, P, S, n, p, R, CS, PB, WP, kSh ? 1 : 0, a.x_staged,
                           a.cdf_staged});

  // this team's level arrays, random blocks and this warp's accumulators
  unsigned long long* t_best = s.best + (size_t)slot * Gm;
  int* t_varx = s.varx + (size_t)slot * Gm;
  int* t_vars = s.vars + (size_t)slot * Gm;
  int* t_setx = s.setx + (size_t)slot * Gm;
  int* t_flags = s.flags + (size_t)slot * Gm;
  float* t_valx = s.valx + (size_t)slot * Gm;
  // (the tree's random blocks: staged per tree in the shared form, read
  // where they are in the global form; the child sums likewise in shared
  // memory or in global scratch)
  const float *t_ug = nullptr, *t_uv = nullptr, *t_eps = nullptr;
  const int* t_sb = nullptr;
  const float* t_epsr = nullptr;
  long long* t_acc = kSh ? s.acc_ch + (size_t)slot * 2 * Gm
                         : a.g_acc + (size_t)(valid ? q : 0) * 2 * Gm;
  int* t_cnt = kSh ? s.cnt_ch + (size_t)slot * 2 * Gm
                   : a.g_cnt + (size_t)(valid ? q : 0) * 2 * Gm;
  // a value that atomics of this block wrote to t_acc / t_cnt or that another
  // block wrote to g_leaf: past the L1 cache when it lies in global memory
  auto fresh = [](const auto* ptr) { return kSh ? *ptr : __ldcg(ptr); };

  // rows of the chain: y, the row data, the residual base of the tree
  const float* yc = a.y + (size_t)c * a.y_stride;
  const float* yv = kSh ? s.y : yc;
  const float* wv = kSh ? s.w : (a.lik_row ? a.lik_row + (size_t)c * n : nullptr);
  float* noiv = kSh ? s.noi : a.noi + (size_t)c * n;
  const float* Xv = a.x_staged ? s.X : a.X;
  const int* rules = a.x_staged ? s.rules : a.rules;
  const float* cdf = a.cdf_staged ? s.cdf : a.cdf + (size_t)c * p;
  if (kSh) {
    const float* wrow = a.lik_row ? a.lik_row + (size_t)c * n : nullptr;
    for (int i = t; i < n; i += T) {
      s.y[i] = yc[i];
      s.w[i] = wrow ? wrow[i] : 0.f;
    }
  }
  if (a.x_staged) {
    for (int i = t; i < n * p; i += T) s.X[i] = a.X[i];
    for (int j = t; j < p; j += T) s.rules[j] = a.rules[j];
  }

  // particle pp of this chain in buffer buf (shared form: its owner's memory)
  auto part = [&](int buf, int pp) -> PartT {
    if (kSh) {
      unsigned int* rec = s.rec + ((size_t)buf * PB + pp % PB) * RW;
      const int r = pp / PB;
      if (r != rank) rec = cluster.map_shared_rank(rec, r);
      return PartT{(int*)rec, (float*)(rec + S4), (int*)(rec + 2 * S4),
                   (float*)(rec + 3 * S4), (float*)(rec + 4 * S4),
                   (LiT*)(rec + 5 * S4)};
    }
    const size_t o = ((size_t)buf * CP + (size_t)c * P + pp) * S;
    return PartT{a.ps_sv + o, a.ps_sl + o, a.ps_st + o, a.ps_lf + o, a.ps_ct + o,
                 (LiT*)(a.ps_li + ((size_t)buf * CP + (size_t)c * P + pp) * n)};
  };

  // this team's sum of the row log-likelihood terms at pred[i] = lf[li[i]];
  // `route` first moves the rows of final nodes to their children.  The warp
  // partials go to wpart, the team's thread 0 adds them in warp order.
  auto team_ll = [&](LiT* li, const float* lf, bool route, int lo, int G) {
    double acc = 0.0;
    for (int i = tt; i < n; i += TT) {
      int l = (int)li[i];
      const int g = l - lo;
      if (route && g >= 0 && g < G && (t_flags[g] & kFinal)) {
        const int col = t_varx[g];
        const bool left = go_left(Xv[(size_t)i * p + col], t_valx[g], t_setx[g],
                                  rules[col]);
        l = 2 * l + 1 + (left ? 0 : 1);
        li[i] = (LiT)l;
      }
      acc += (double)row_ll(lik, c0, yv[i], noiv[i], wv ? wv[i] : 0.f, lf[l]);
    }
    acc = warp_sum_d(acc);
    if (lane == 0) s.wpart[warp] = acc;
  };
  auto team_total = [&]() {  // after a __syncthreads
    double tot = 0.0;
    for (int k = 0; k < WP; ++k) tot += s.wpart[slot * WP + k];
    return lik == kGauss ? -0.5f * (float)tot : (float)tot;
  };
  // one value into slot `idx` of array `arr` of every block of the cluster
  auto push = [&](auto* arr, int idx, auto v) {
    for (int r = 0; r < CS; ++r)
      (r == rank ? arr : cluster.map_shared_rank(arr, r))[idx] = v;
  };
  auto ranks_sum = [&](const double* x, int count) {
    double tot = 0.0;
    for (int r = 0; r < count; ++r) tot += x[r];
    return tot;
  };
  // Block-wide float64 sums of two values in a fixed order; every thread gets
  // both totals.  One barrier: calls alternate between two buffers (`flip`).
  int flip = 0;
  auto block_sum2 = [&](double& u, double& v) {
    u = warp_sum_d(u);
    v = warp_sum_d(v);
    double* buf = s.wpart + (size_t)flip * 2 * W;
    flip ^= 1;
    if (lane == 0) { buf[warp] = u; buf[W + warp] = v; }
    __syncthreads();
    u = 0.0; v = 0.0;
    for (int k = 0; k < W; ++k) { u += buf[k]; v += buf[W + k]; }
  };

  const int off0 = a.batch_offset[c];
  const int iter0 = a.iteration[c];
  float lsd = a.leaf_sd[c];
  float wc = a.wf_count[c];
  // the rows this block takes of every pass that the whole cluster shares
  const int chunk = (n + CS - 1) / CS;
  const int r0 = min(n, rank * chunk), r1 = min(n, r0 + chunk);
  const int t0r = kSplit ? r0 : 0, t1r = kSplit ? r1 : n;  // rows of the tail's sums
  const unsigned int k0 = a.rg ? 0u : a.seed[0], k1 = a.rg ? 0u : a.seed[1];
  // the split-weight CDF: a float64 running sum rounded once per entry
  auto write_cdf = [&]() {
    double run = 0.0;
    for (int j = 0; j < p; ++j) {
      run += (double)fmaxf(a.alpha_vec[(size_t)c * p + j], 1e-12f);
      a.cdf[(size_t)c * p + j] = (float)run;
    }
    __threadfence();
  };
  if (rank == 0 && t == 0) write_cdf();
  if (kSh) for (int i = t; i < n; i += T) s.st[i] = a.sum_trees[(size_t)c * n + i];
  cluster.sync();  // every block of the cluster runs before one writes to another

  for (int b = 0; b < a.B; ++b) {
    const int jt = (off0 + b) % m;
    const size_t fr = ((size_t)c * m + jt) * S;     // forest row of the tree
    float* tp = a.tree_pred + ((size_t)c * m + jt) * n;

    // ---- prepare the tree: residual base, root sum, fixed-point scale ----
    // The global form splits the rows over the cluster and meets; the shared
    // form keeps sum_trees in every block and prepares all rows locally, so
    // its blocks only wait for the last tree's winner to have been read.
    float rmu;
    double fx_scale, fx_inv;
    {
      const int p0 = kSh ? 0 : r0, p1 = kSh ? n : r1;
      // the tree's refinement noise and uniforms: their loads start before
      // the row loop waits for its own
      const size_t bc = (size_t)b * C + c;
      auto misc = [&](int k) {
        return k < D ? a.ures[((size_t)b * D + k) * C + c]
            : k == D ? a.usel[bc] : a.uacc[bc * R + (k - D - 1)];
      };
      const int RS = R * S, NM = D + 1 + R;
      t_epsr = kSh ? s.r_epsr : a.epsr + bc * RS;
      const float e0 = kSh && t < RS ? a.epsr[bc * RS + t] : 0.f;
      const float e1 = kSh && t + T < RS ? a.epsr[bc * RS + t + T] : 0.f;
      const float m0 = t < NM ? misc(t) : 0.f;
      double acc = 0.0;
      float amax = 0.f;
      for (int i = p0 + t; i < p1; i += T) {
        const float ni = (kSh ? s.st[i] : a.sum_trees[(size_t)c * n + i]) - tp[i];
        const float r = yv[i] - ni;
        acc += (double)r;
        amax = fmaxf(amax, fabsf(r));
        noiv[i] = ni;
      }
      if (kSh) {
        if (t < RS) s.r_epsr[t] = e0;
        if (t + T < RS) s.r_epsr[t + T] = e1;
        for (int k = t + 2 * T; k < RS; k += T) s.r_epsr[k] = a.epsr[bc * RS + k];
      }
      if (t < NM) s.r_misc[t] = m0;
      for (int k = t + T; k < NM; k += T) s.r_misc[k] = misc(k);
      acc = warp_sum_d(acc);
      amax = bart::warp_max_f(amax);
      if (lane == 0) { s.wpart[warp] = acc; s.wpart[W + warp] = (double)amax; }
      __syncthreads();
      double tot = 0.0, top = 0.0;
      if (kSh || t == 0) {
        for (int k = 0; k < W; ++k) {
          tot += s.wpart[k];
          top = fmax(top, s.wpart[W + k]);
        }
      }
      if (kSh) {
        if (b > 0) cluster.barrier_wait();
        if (a.tuning && b > 0) cluster.sync();  // Welford sums, the new CDF
      } else {
        if (t == 0) {
          push(s.x_prep, rank, tot);
          push(s.x_prep, 2 * CS + rank, top);
        }
        __threadfence();
        cluster.sync();
        tot = ranks_sum(s.x_prep, CS);
        top = 0.0;
        for (int r = 0; r < CS; ++r) top = fmax(top, s.x_prep[2 * CS + r]);
      }
      rmu = (float)tot / (float)n / (float)m;
      // the tree's fixed-point scale: the largest |residual| gets 38 bits
      int e = 0;
      if (top > 0.0 && top < 1e300) frexp(top, &e);
      fx_scale = ldexp(1.0, 38 - e);
      fx_inv = ldexp(1.0, e - 38);
    }
    if (a.tuning && b > 0) {  // leaf_sd from the Welford sums of the last tree
      const float sd = (float)ranks_sum(s.x_prep + CS, CS) / (float)n;
      if (iter0 + b > m) lsd = fmaxf(sd, 1e-6f);
    }
    if (a.cdf_staged && (b == 0 || a.tuning))
      for (int j = t; j < p; j += T) s.cdf[j] = a.cdf[(size_t)c * p + j];
    STAMP(0);

    // ---- this team's particle: the current tree (frozen) or a root leaf ----
    int cur = 0;
    if (valid) {
      const PartT o = part(0, pi);
      // the tree's random blocks of this particle (first loads started
      // before the forest row's are waited for)
      const size_t rq = ((size_t)b * C + c) * P + pi;
      float* w_ug = s.r_ug + (size_t)slot * Gtot;
      float* w_uv = s.r_uv + (size_t)slot * Gtot;
      int* w_sb = s.r_sb + (size_t)slot * Gtot;
      float* w_eps = s.r_eps + (size_t)slot * 2 * Gtot;
      auto stage_rands = [&](int g, float ug, float uv, int sb, float ea, float eb) {
        w_ug[g] = ug; w_uv[g] = uv; w_sb[g] = sb;
        w_eps[2 * g] = ea; w_eps[2 * g + 1] = eb;
      };
      t_ug = kSh ? w_ug : a.ug + rq * Gtot;
      t_uv = kSh ? w_uv : a.uv + rq * Gtot;
      t_sb = kSh ? w_sb : a.sb + rq * Gtot;
      t_eps = kSh ? w_eps : a.eps + 2 * rq * Gtot;
      const bool hg = kSh && tt < Gtot;
      const size_t g0 = rq * Gtot + (hg ? tt : 0);
      const float ug0 = a.ug[g0], uv0 = a.uv[g0];
      const int sb0 = a.sb[g0];
      const float ea0 = a.eps[2 * g0], eb0 = a.eps[2 * g0 + 1];
      for (int sn = tt; sn < S; sn += TT) {
        if (frozen) {
          o.sv[sn] = a.f_sv[fr + sn]; o.sl[sn] = a.f_sl[fr + sn];
          o.st[sn] = a.f_st[fr + sn]; o.lf[sn] = a.f_lf[fr + sn];
          o.ct[sn] = a.f_ct[fr + sn];
        } else {
          o.sv[sn] = -1; o.sl[sn] = 0.f; o.st[sn] = 0;
          o.lf[sn] = sn == 0 ? rmu : 0.f;
          o.ct[sn] = sn == 0 ? (float)n : 0.f;
        }
      }
      for (int i = tt; i < n; i += TT) o.li[i] = 0;
      if (hg) stage_rands(tt, ug0, uv0, sb0, ea0, eb0);
      for (int g = tt + TT; kSh && g < Gtot; g += TT) {
        const size_t gi = rq * Gtot + g;
        stage_rands(g, a.ug[gi], a.uv[gi], a.sb[gi], a.eps[2 * gi], a.eps[2 * gi + 1]);
      }
      if (tt == 0) s.any[slot] = 0;
    }
    __syncthreads();
    if (valid) {
      const PartT o = part(0, pi);
      team_ll(o.li, o.lf, false, 0, 0);
    }
    __syncthreads();
    if (valid && tt == 0) push(s.ll0, pi, team_total());
    STAMP(1);

    for (int d = 0; d < D; ++d) {
      const int lo = (1 << d) - 1, hi = (1 << (d + 1)) - 1;
      const int G = hi - lo;
      const float p_grow = a.p_grow[d];
      const PartT o = part(1 - cur, valid ? pi : 0);  // this level's own state

      // phase 0: the ancestor's state becomes this particle's; phase a: grow
      // decision and split variable per node
      if (valid) {
        const int anc = d == 0 ? pi : s.take[pi];
        const PartT in = part(cur, anc);
        if (kSh) {  // one record of 16-byte words
          const uint4* __restrict__ src = (const uint4*)in.sv;
          uint4* __restrict__ dst = (uint4*)o.sv;
          for (int k = tt; k < RW / 4; k += TT) dst[k] = src[k];
        } else {
          for (int sn = tt; sn < S; sn += TT) {
            o.sv[sn] = in.sv[sn]; o.sl[sn] = in.sl[sn]; o.st[sn] = in.st[sn];
            o.lf[sn] = in.lf[sn]; o.ct[sn] = in.ct[sn];
          }
          for (int i = tt; i < n; i += TT) o.li[i] = in.li[i];
        }
      }
      __syncthreads();
      STAMP(13);
      if (valid) {
        int any = 0;
        for (int g = tt; g < G; g += TT) {
          const int node_sv = o.sv[lo + g];
          const bool want = (t_ug[lo + g] < p_grow) && node_sv < 0
              && o.ct[lo + g] >= 2.f && !frozen;
          const float u_v = t_uv[lo + g] * cdf[p - 1];
          int l = 0, r = p;  // number of cdf entries < u_v
          while (l < r) {
            const int mid = (l + r) >> 1;
            if (cdf[mid] < u_v) l = mid + 1; else r = mid;
          }
          const int var_s = min(max(l, 0), p - 1);
          const bool replay = frozen && node_sv >= 0;
          t_varx[g] = min(max(frozen ? node_sv : var_s, 0), p - 1);
          t_vars[g] = var_s;
          t_flags[g] = (want ? kWant : 0) | (replay ? kFinal : 0);
          t_best[g] = 0ull;
          if (frozen) {  // the stored split is replayed
            t_valx[g] = o.sl[lo + g];
            t_setx[g] = o.st[lo + g];
          }
          any |= (want ? 1 : 0) | (replay ? 2 : 0);
        }
        any = __reduce_or_sync(kFull, any);
        if (any && lane == 0) atomicOr(&s.any[slot], any);
        for (int k = tt; k < 2 * G; k += TT) { t_acc[k] = 0; t_cnt[k] = 0; }
      }
      __syncthreads();
      STAMP(2);
      const bool growing = valid && (s.any[slot] & 1);

      // phase b: uniform member row per growing node by Gumbel arg-max (ties
      // to the lowest row)
      if (growing) {
        const float* gum = a.rg
            ? a.rg + ((((size_t)b * D + d) * C + c) * P + pi) * n : nullptr;
        const unsigned int stream =
            bart::gumbel_stream(b, d, D, a.Cg * P, a.c0 * P + q);
        for (int base = tw * 32; base < n; base += TT) {
          const int i = base + lane;
          int node = -1;
          unsigned long long key = 0ull;
          if (i < n) {
            const int g = (int)o.li[i] - lo;
            if (g >= 0 && g < G && (t_flags[g] & kWant)) {
              node = g;
              key = pack_key(gum ? gum[i] : gen_gumbel(k0, k1, i, stream), i);
            }
          }
          keyed_max(node, key, t_best, lane);
        }
      }
      __syncthreads();
      STAMP(3);

      // phase c: child counts and residual sums of the growing nodes; the
      // split value of a node is X at its arg-max row
      if (growing) {
        for (int base = tw * 32; base < n; base += TT) {
          const int i = base + lane;
          int key = -1;
          long long r = 0;
          if (i < n) {
            const int g = (int)o.li[i] - lo;
            if (g >= 0 && g < G && (t_flags[g] & kWant)) {
              const int col = t_varx[g];
              const float val = Xv[(size_t)key_row(t_best[g]) * p + col];
              const bool left = go_left(Xv[(size_t)i * p + col], val,
                                        t_sb[lo + g], rules[col]);
              key = 2 * g + (left ? 0 : 1);
              r = to_fixed(yv[i] - noiv[i], fx_scale);
            }
          }
          keyed_add(key, r, t_acc, t_cnt, lane);
        }
      }
      __syncthreads();
      STAMP(4);

      // phase d: validate, commit the level and the children
      if (growing) {
        int any = 0;
        for (int g = tt; g < G; g += TT) {
          if (!(t_flags[g] & kWant)) continue;
          const int cn[2] = {fresh(&t_cnt[2 * g]), fresh(&t_cnt[2 * g + 1])};
          if (cn[0] > 0 && cn[1] > 0) {
            const float val_raw = Xv[(size_t)key_row(t_best[g]) * p + t_varx[g]];
            t_flags[g] |= kFinal;
            t_valx[g] = val_raw;
            t_setx[g] = t_sb[lo + g];
            any = 2;
            o.sv[lo + g] = t_vars[g];
            o.sl[lo + g] = val_raw;
            o.st[lo + g] = t_sb[lo + g];
            for (int k = 0; k < 2; ++k) {
              const float cnt = (float)cn[k];
              const float sum = (float)((double)fresh(&t_acc[2 * g + k]) * fx_inv);
              const float mu_base = sum / fmaxf(cnt, 1.f) / (float)m;
              o.lf[hi + 2 * g + k] = mu_base + t_eps[2 * lo + 2 * g + k] * lsd;
              o.ct[hi + 2 * g + k] = cnt;
            }
          }
        }
        any = __reduce_or_sync(kFull, any);
        if (any && lane == 0) atomicOr(&s.any[slot], any);
      }
      __syncthreads();
      STAMP(5);

      // phase e: rows move to the final children; the log-likelihood (a
      // particle without a final node keeps its ancestor's)
      const bool moving = valid && (s.any[slot] & 2);
      if (moving) team_ll(o.li, o.lf, true, lo, G);
      __syncthreads();
      if (valid && tt == 0) {
        const float ll = moving ? team_total()
            : (d == 0 ? s.ll0[pi] : s.ll[((d - 1) & 1) * P + s.take[pi]]);
        push(s.ll, (d & 1) * P + pi, ll);
        s.any[slot] = 0;
      }
      STAMP(6);
      cluster.sync();
      STAMP(7);

      // ---- SMC bookkeeping, the same in every block of the chain ----
      if (warp == 0) {
        if (d == 0) {
          for (int i = lane; i < P; i += 32) { s.lw[i] = s.ll0[i]; s.llp[i] = s.ll0[i]; }
          __syncwarp();
        }
        bart::smc_warp(s.lw, s.llp, s.ll + (d & 1) * P, s.cdfp, s.prob, s.take, P,
                       s.r_misc[d], d < D - 1);
        if (d == D - 1) {
          const int w = bart::winner_warp(s.lw, s.prob, P, s.r_misc[D]);
          if (lane == 0) s.widx[0] = w;
        }
      }
      __syncthreads();
      cur ^= 1;
      STAMP(8);
    }

    // ---- the tail: the winner's leaves ----
    const int wpi = s.widx[0];
    const LiT* li_w;
    {
      const PartT win = part(cur, wpi);
      // (all loads from the winner's block start before the first is
      // waited for)
      const uint4* __restrict__ src = (const uint4*)win.li;
      const int nw = kSh ? round8(n) / 8 : 0;
      uint4 w0 = make_uint4(0u, 0u, 0u, 0u);
      if (t < nw) w0 = src[t];
      for (int sn = t; sn < S; sn += T) {
        const int v = win.sv[sn], stv = win.st[sn];
        const float cn = win.ct[sn], lfv = win.lf[sn], slv = win.sl[sn];
        s.wsv[sn] = v; s.wct[sn] = cn; s.lfw[sn] = lfv;
        s.mask[sn] = (v < 0 && cn > 0.f) ? 1.f : 0.f;
        if (rank == 0) {  // structure and counts go to the forest now
          a.f_sv[fr + sn] = v; a.f_sl[fr + sn] = slv; a.f_st[fr + sn] = stv;
          a.f_ct[fr + sn] = cn; a.f_sp[fr + sn] = 0.f;
        }
      }
      if (kSh) {  // the winner's rows, staged as 16-byte words
        uint4* __restrict__ dst = (uint4*)s.wli;
        if (t < nw) dst[t] = w0;
        for (int k = t + T; k < nw; k += T) dst[k] = src[k];
        li_w = (const LiT*)s.wli;
      } else {
        li_w = win.li;
      }
      for (int sn = t; sn < S; sn += T) s.acc_lf[sn] = 0;
    }
    __syncthreads();
    if (kSh) cluster.barrier_arrive();  // this block has read the winner

    // per-leaf residual sums -> prior centres; the current log-likelihood
    {
      double acc = 0.0;
      for (int base = t0r + warp * 32; base < t1r; base += T) {
        const int i = base + lane;
        int key = -1;
        long long r = 0;
        if (i < t1r) {
          key = (int)li_w[i];
          const float ni = noiv[i], yy = yv[i];
          r = to_fixed(yy - ni, fx_scale);
          acc += (double)row_ll(lik, c0, yy, ni, wv ? wv[i] : 0.f, s.lfw[key]);
        }
        keyed_add(key, r, s.acc_lf, nullptr, lane);
      }
      acc = warp_sum_d(acc);
      if (lane == 0) s.wpart[warp] = acc;
      __syncthreads();
      for (int sn = t; sn < S; sn += T) {
        if (kSplit) a.g_leaf[((size_t)c * CS + rank) * S + sn] = s.acc_lf[sn];
        else s.x_leaf[sn] = s.acc_lf[sn];
      }
      if (t == 0) {
        double tot = 0.0;
        for (int k = 0; k < W; ++k) tot += s.wpart[k];
        if (kSplit) push(s.x_ll, my, tot); else s.x_ll[0] = tot;
      }
      if (kSplit) {
        __threadfence();  // the leaf sums in global scratch
        cluster.sync();
      } else {
        __syncthreads();
      }
    }
    const float h = 0.5f / (lsd * lsd);
    const float eps_scale = 0.3f * lsd;
    float ll_c;
    {
      double pr = 0.0, none = 0.0;
      for (int sn = t; sn < S; sn += T) {
        long long tot = 0;
        for (int r = 0; r < TR; ++r)
          tot += kSplit ? fresh(&a.g_leaf[((size_t)c * CS + r) * S + sn])
                        : s.x_leaf[sn];
        const float ctr = (float)((double)tot * fx_inv) / fmaxf(s.wct[sn], 1.f)
            / (float)m;
        s.ctr[sn] = ctr;
        const float dv = s.lfw[sn] - ctr;
        pr += (double)(s.mask[sn] * dv * dv);
      }
      const float tot = (float)ranks_sum(s.x_ll, TR);
      block_sum2(pr, none);
      ll_c = (lik == kGauss ? -0.5f * tot : tot) - h * (float)pr;
    }
    STAMP(9);

    // R Metropolis sweeps on the leaf values with pre-drawn noise; a thread
    // keeps the same leaves in every sweep
    for (int r = 0; r < R; ++r) {
      double* x = s.x_ll + ((r + 1) & 1) * CS;
      double pr = 0.0, acc = 0.0;
      for (int sn = t; sn < S; sn += T) {
        const float lf = s.lfw[sn] + t_epsr[(size_t)r * S + sn] * eps_scale * s.mask[sn];
        s.lfp[sn] = lf;
        const float dv = lf - s.ctr[sn];
        pr += (double)(s.mask[sn] * dv * dv);
      }
      __syncthreads();
      for (int i = t0r + t; i < t1r; i += T)
        acc += (double)row_ll(lik, c0, yv[i], noiv[i], wv ? wv[i] : 0.f,
                              s.lfp[li_w[i]]);
      block_sum2(acc, pr);
      if (kSplit) {
        if (t == 0) push(x, rank, acc);
        cluster.sync();
        acc = ranks_sum(x, CS);
      }
      const float tot = (float)acc;
      const float ll_p = (lik == kGauss ? -0.5f * tot : tot) - h * (float)pr;
      if (logf(s.r_misc[D + 1 + r]) < ll_p - ll_c) {  // the same in every thread
        for (int sn = t; sn < S; sn += T) s.lfw[sn] = s.lfp[sn];
        ll_c = ll_p;
      }
    }
    __syncthreads();
    STAMP(10);

    // ---- commit: leaves, tree_pred, sum_trees; adaptation while tuning ----
    if (rank == 0)
      for (int sn = t; sn < S; sn += T) a.f_lf[fr + sn] = s.lfw[sn];
    if (a.tuning) wc = wc + 1.f;
    double sd_acc = 0.0, none = 0.0;
    for (int i = (kSh ? 0 : r0) + t; i < (kSh ? n : r1); i += T) {
      const float pv = s.lfw[li_w[i]];
      const float st = noiv[i] + pv;
      if (kSh) s.st[i] = st;  // every block keeps all of sum_trees
      if (i < r0 || i >= r1) continue;
      tp[i] = pv;
      a.sum_trees[(size_t)c * n + i] = st;
      if (a.tuning) {
        const size_t wi = (size_t)c * n + i;
        const float delta = pv - a.wf_mean[wi];
        const float mean = a.wf_mean[wi] + delta / wc;
        const float m2 = a.wf_m2[wi] + delta * (pv - mean);
        a.wf_mean[wi] = mean;
        a.wf_m2[wi] = m2;
        sd_acc += (double)sqrtf(fmaxf(m2 / fmaxf(wc, 1.f), 1e-12f));
      }
    }
    if (a.tuning) {
      block_sum2(sd_acc, none);
      if (t == 0) push(s.x_prep, CS + rank, sd_acc);
      if (rank == 0) {
        // split prior: the old weights times the decay, plus one per SPLIT NODE
        for (int j = t; j < p; j += T) a.vi_cnt[(size_t)c * p + j] = 0;
        __syncthreads();
        for (int sn = t; sn < S; sn += T) {
          const int v = s.wsv[sn];
          if (v >= 0) atomicAdd(&a.vi_cnt[(size_t)c * p + v], 1);
        }
        __syncthreads();
        for (int j = t; j < p; j += T)
          a.alpha_vec[(size_t)c * p + j] = a.alpha_vec[(size_t)c * p + j] * a.decay
              + (float)a.vi_cnt[(size_t)c * p + j];
        __syncthreads();
        if (t == 0) write_cdf();
      }
    }
    __syncthreads();
    STAMP(11);
  }

  // ---- after the last tree: leaf_sd, the counters, the split histogram ----
  if (kSh) cluster.barrier_wait();
  cluster.sync();
  if (a.tuning) {
    const float sd = (float)ranks_sum(s.x_prep + CS, CS) / (float)n;
    if (iter0 + a.B > m) lsd = fmaxf(sd, 1e-6f);
  }
  if (rank == 0) {
    for (int j = t; j < p; j += T) a.vi_cnt[(size_t)c * p + j] = 0;
    __syncthreads();
    const int* fsv = a.f_sv + (size_t)c * m * S;
    for (int sn = t; sn < m * S; sn += T) {
      const int v = fsv[sn];
      if (v >= 0) atomicAdd(&a.vi_cnt[(size_t)c * p + v], 1);
    }
    __syncthreads();
    for (int j = t; j < p; j += T)
      a.vi[(size_t)c * p + j] = (float)a.vi_cnt[(size_t)c * p + j];
    if (t == 0) {
      a.batch_offset[c] = (off0 + a.B) % m;
      a.iteration[c] = iter0 + a.B;
      if (a.tuning) {
        a.wf_count[c] = wc;
        a.leaf_sd[c] = lsd;
      }
    }
  }
  STAMP(12);
#ifdef DRAW_PHASE_CLOCKS
  for (int k = 0; k < 16; ++k) cluster.sync();
  STAMP(14);
  for (int k = 0; k < 16; ++k) __syncthreads();
  STAMP(15);
#endif
}

bool valid_args(const DrawArgs& a) {
  return a.D >= 1 && a.D <= kMaxDepth && a.P >= 2 && a.C >= 1 && a.n >= 1
      && a.p >= 1 && a.R >= 1 && a.S == (1 << (a.D + 1)) - 1 && a.CS >= 1
      && a.CS <= kMaxCluster && a.PB >= 1 && a.WP >= 1
      && a.PB * a.WP * 32 <= kMaxThreads && a.CS * a.PB >= a.P
      && (a.rg || a.seed) && a.c0 >= 0 && a.c0 + a.C <= a.Cg
      && (a.shared_form ? a.S <= 65535
                        : a.ps_li && a.g_acc && a.g_cnt && a.g_leaf);
}

// launch configuration of `a`; `attr` must outlive the use of `cfg`
cudaError_t configure(const DrawArgs& a, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr, cudaStream_t stream) {
  Smem s;
  const size_t bytes = layout(s, nullptr, plan_of(a));
  const void* fn = a.shared_form ? (const void*)pgbart_step_kernel<true>
                                 : (const void*)pgbart_step_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  if (a.CS > 8) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(a.C * a.CS);
  cfg.blockDim = dim3(a.PB * a.WP * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int pgbart_step_args_size() { return (int)sizeof(DrawArgs); }

// Dynamic shared memory of one block of the plan in `args`, in bytes.
// `args` points to a DrawArgs (an untyped pointer: the struct is local to this
// file, and a function that names it in its signature is not exported).
extern "C" long long pgbart_step_smem_bytes(const void* args) {
  Smem s;
  return (long long)layout(s, nullptr, plan_of(*static_cast<const DrawArgs*>(args)));
}

// Clusters of this configuration the card runs at once (0: it cannot be
// launched), or minus a CUDA error code.
extern "C" int pgbart_step_max_clusters(const void* args) {
  const DrawArgs a = *static_cast<const DrawArgs*>(args);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(a, cfg, attr, nullptr);
  if (e != cudaSuccess) { cudaGetLastError(); return -(int)e; }
  int clusters = 0;
  e = a.shared_form
      ? cudaOccupancyMaxActiveClusters(&clusters, pgbart_step_kernel<true>, &cfg)
      : cudaOccupancyMaxActiveClusters(&clusters, pgbart_step_kernel<false>, &cfg);
  if (e != cudaSuccess) { cudaGetLastError(); return -(int)e; }
  return clusters;
}

// Launches one whole step: C clusters of CS blocks.  Returns 0 or a CUDA
// error code.
extern "C" int pgbart_step_launch(const void* args, void* stream) {
  const DrawArgs a = *static_cast<const DrawArgs*>(args);
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(a, cfg, attr, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  e = a.shared_form ? cudaLaunchKernelEx(&cfg, pgbart_step_kernel<true>, a)
                    : cudaLaunchKernelEx(&cfg, pgbart_step_kernel<false>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef DRAW_PHASE_CLOCKS
// Phase clocks of the launches since the last reset: 16 cycle counts into
// `out`, or (reset > 0) set them to 0 and let block reset - 1 of chain 0's
// cluster stamp from now on.
extern "C" int pgbart_step_clocks(long long* out, int reset) {
  if (reset) {
    const long long zero[16] = {0};
    const int rank = reset - 1;
    cudaMemcpyToSymbol(g_clock_rank, &rank, sizeof(rank));
    return (int)cudaMemcpyToSymbol(g_clock, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(long long) * 16);
}
#endif
