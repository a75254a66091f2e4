// grow_round: one depth-d growth round of the PGBART conditional SMC for all
// particles of all chains.
//
// Replaces the TPU kernel pymc_bart_tpu/ops/grow_pallas.py::grow_round_pallas
// (body _grow_math), for the constant, linear and mix responses and k <= 8
// outputs.  It computes what that kernel computes; the one-hot matmuls,
// selection matmuls and bit-pattern blends of the Pallas body are gathers,
// warp-keyed sums and selects here.
//
// Bound: bytes.  A launch reads leaf_idx, pred and row_gum and writes
// leaf_idx and pred, each (C*P*n) 4-byte words, plus X once; the arithmetic
// per row is a handful of compares and adds.  At the main shapes that is a
// fraction of a microsecond of traffic, so LATENCY sets the time: how many
// dependent steps a block takes between its barriers.
//
// Design.  One block of 1024 threads per (chain, particle); node-level
// state (G = 2^d nodes, 2G children) in shared memory, and the row -> node
// array of the particle too (16 bits a row; where n rows do not fit, the
// block works in its own output row li_o instead).  Four passes over the
// rows, no serial scan: a thread never walks more than n / blockDim rows in
// any phase, and every global load of a row is issued at the top of its
// iteration, before the decisions that read shared memory.
//   a  per node: split variable by inverse CDF (its loads first: they do not
//      depend on the ancestor), grow decision (and the ancestor's S-vectors
//      copied to this particle's outputs)
//   A  per row: the ancestor's li staged; the chain's largest |r|; Gumbel
//      arg-max per growing node by warp-keyed 64-bit atomicMax (ties go to
//      the lowest row, as jnp.argmax)
//   A2 per node: the split value, and the fixed-point scales of the sums
//   B  per row: route the rows of active nodes to their tentative children;
//      child counts and sums KEYED BY CHILD in fixed point (a match,
//      bart::group_sum's 32-bit warp reductions, and one shared-memory add
//      per warp and child by two native 32-bit atomics, add64): sum r per
//      output, and for linear / mix sum x, x^2 and x r per output, x the
//      parent's split covariate
//   d  per child: validate (both children non-empty), commit the level and
//      the children, draw leaf values and least-squares slopes
//   C  per row: final routing, incremental prediction, the Gaussian
//      log-likelihood in float64 rounded to float32 once
// (Block size, atomics and the order of loads: scripts/grow_variants.py
// times the alternatives; scripts/grow_phase_clocks.py the phases.)
// The frozen particle replays its stored splits and sums nothing.
//
// Order of sums: every sum that reaches a discrete decision is taken by the
// rule of ops/sums.py, which the plain version (ops/grow.py) follows too:
// keyed sums in fixed point (the residual on the chain's scale, x on its
// column's, x^2 on the square, x r on the product; ops/sums.py
// keyed_linear_sums), the log-likelihood in float64 rounded once, quotients as
// true divisions; the file is compiled without fused multiply-add
// (ops/_build.py), so every float32 product is rounded before it is added, as
// PyTorch rounds it.  Kernel and plain version then agree bit for bit.
#include "common.cuh"

#include <math.h>

namespace {

using bart::go_left;
using bart::group_sum;
using bart::keyed_max;
using bart::pack_key;
using bart::to_fixed;

constexpr int kThreads = 1024;
constexpr int kMaxK = 8;
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kFixedBits = 38;

enum Flag { kWant = 1, kActive = 2, kFinal = 4 };

// Mirrored field by field by ops/grow.py::_GrowArgs (ctypes).
struct GrowArgs {
  const int* take; const int* frozen;
  const int* sv; const float* sl; const int* st; const float* lf;
  const float* ct; const float* sp; const int* li; const float* pred;
  const float* X; const float* resid; const float* llw; const int* rules;
  const float* cdf; const float* lsd;
  const float* u_grow; const float* u_var; const int* set_bits;
  const float* row_gum; const float* eps; const float* u_mix;
  const int* x_exp;  // per column: exponent of its largest non-NaN |x|
  int* sv_o; float* sl_o; int* st_o; float* lf_o; float* ct_o; float* sp_o;
  int* li_o; float* pred_o; float* ll_o;
  int ld_g, ld_e, ld_m;
  int C, P, S, n, p, k, d, m;
  int response;     // 0 constant, 1 linear, 2 mix
  int shared_rows;  // the row -> node array in shared memory
  float p_grow;
};

__host__ __device__ inline int n_sums(int k, int response) {
  return response != 0 ? 2 * k + 2 : k;  // r per output [, x, x^2, x r per output]
}

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// Dynamic shared memory of one block (mirrored by ops/grow.py::smem_bytes).
struct Smem {
  unsigned long long* best;  // G   arg-max keys
  long long* acc;            // nsum x 2G fixed-point child sums
  double* scl;               // 3 x G  scales of x, x^2, x r per node
  double* part;              // 32  warp partials of the log-likelihood
  int* cnt;                  // 2G  child counts
  int *varx, *vars, *setx, *flags;  // G
  unsigned int* rtop;        // 1   bits of the chain's largest |r|
  float *valx, *valraw;      // G
  float *clf, *csp;          // k x 2G  child leaf values and slopes
  unsigned short* rows;      // n   row -> node (shared_rows)
};

__host__ __device__ inline size_t layout(Smem& s, unsigned char* base, int G,
                                         int k, int response, int n,
                                         int shared_rows) {
  const size_t G2 = 2 * (size_t)G, ns = n_sums(k, response);
  size_t off = 0;
  s.best = (unsigned long long*)(base + off); off += 8 * (size_t)G;
  s.acc = (long long*)(base + off);           off += 8 * ns * G2;
  s.scl = (double*)(base + off);              off += 8 * 3 * (size_t)G;
  s.part = (double*)(base + off);             off += 8 * 32;
  s.cnt = (int*)(base + off);                 off += 4 * G2;
  s.varx = (int*)(base + off);                off += 4 * (size_t)G;
  s.vars = (int*)(base + off);                off += 4 * (size_t)G;
  s.setx = (int*)(base + off);                off += 4 * (size_t)G;
  s.flags = (int*)(base + off);               off += 4 * (size_t)G;
  s.rtop = (unsigned int*)(base + off);       off += 4;
  s.valx = (float*)(base + off);              off += 4 * (size_t)G;
  s.valraw = (float*)(base + off);            off += 4 * (size_t)G;
  s.clf = (float*)(base + off);               off += 4 * (size_t)k * G2;
  s.csp = (float*)(base + off);               off += 4 * (size_t)k * G2;
  off = align16(off);
  s.rows = (unsigned short*)(base + off);
  if (shared_rows) off += 2 * (size_t)n;
  return align16(off);
}

// Adds v to a 64-bit shared-memory accumulator by two native 32-bit atomics,
// the low word's carry added to the high word (a 64-bit shared atomicAdd
// compiles to a compare-and-swap loop, which costs 4 % of a launch here).
__device__ __forceinline__ void add64(long long* acc, long long v) {
  unsigned int* w = (unsigned int*)acc;
  const unsigned int lo = (unsigned int)v;
  const unsigned int hi = (unsigned int)((unsigned long long)v >> 32);
  const unsigned int old = atomicAdd(w, lo);
  atomicAdd(w + 1, hi + (old + lo < old ? 1u : 0u));
}

extern __shared__ unsigned long long smem_u64[];

// Row state: the particle's row -> node array, 16 bits a row in shared
// memory or the block's own int32 output row.
template <typename Row>
__global__ void __launch_bounds__(kThreads) grow_round_kernel(const GrowArgs a) {
  const int P = a.P, S = a.S, n = a.n, p = a.p, k = a.k, d = a.d;
  const int c = blockIdx.x / P, pi = blockIdx.x % P;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int lo = (1 << d) - 1, hi = (1 << (d + 1)) - 1;
  const int G = hi - lo, G2 = 2 * G;
  const bool lin = a.response != 0;
  const int ns = n_sums(k, a.response);

  Smem s;
  layout(s, (unsigned char*)smem_u64, G, k, a.response, n, a.shared_rows);

  {  // ---- phase a, first half: the split variable of every node by
     // inverse CDF (independent of the ancestor, so its loads are issued
     // before the chain take -> frozen -> node arrays) ----
    const float* __restrict__ cdf = a.cdf + (size_t)c * p;
    const float* __restrict__ uv = a.u_var + ((size_t)c * P + pi) * a.ld_g;
    for (int g = t; g < G; g += T) {
      const float u_v = uv[g] * cdf[p - 1];
      int l = 0;  // number of cdf entries < u_v (cdf is non-decreasing)
      if (p <= 32) {  // independent loads: one round trip
        for (int j = 0; j < p; ++j) l += cdf[j] < u_v ? 1 : 0;
      } else {
        int r = p;
        while (l < r) {
          const int mid = (l + r) >> 1;
          if (cdf[mid] < u_v) l = mid + 1; else r = mid;
        }
      }
      s.vars[g] = min(max(l, 0), p - 1);
    }
  }
  const int anc = a.take[c * P + pi];
  const bool frozen = a.frozen[c * P + anc] != 0;
  const size_t ip = (size_t)c * P + anc, op = (size_t)c * P + pi;
  const int* __restrict__ sv = a.sv + ip * S;
  const float* __restrict__ sl = a.sl + ip * S;
  const int* __restrict__ st = a.st + ip * S;
  const float* __restrict__ ct = a.ct + ip * S;
  const float* __restrict__ lf = a.lf + ip * k * S;
  const float* __restrict__ sp = a.sp + ip * k * S;
  const int* __restrict__ li = a.li + ip * n;
  const float* __restrict__ pred = a.pred + ip * k * n;
  int* __restrict__ sv_o = a.sv_o + op * S;
  float* __restrict__ sl_o = a.sl_o + op * S;
  int* __restrict__ st_o = a.st_o + op * S;
  float* __restrict__ ct_o = a.ct_o + op * S;
  float* __restrict__ lf_o = a.lf_o + op * k * S;
  float* __restrict__ sp_o = a.sp_o + op * k * S;
  int* __restrict__ li_o = a.li_o + op * n;
  float* __restrict__ pred_o = a.pred_o + op * k * n;
  const float* __restrict__ X = a.X;
  const float* __restrict__ resid = a.resid + (size_t)c * k * n;
  const float* __restrict__ llw = a.llw + (size_t)c * k * n;
  const float* __restrict__ ug = a.u_grow + op * a.ld_g;
  const int* __restrict__ sb = a.set_bits + op * a.ld_g;
  const float* __restrict__ gum = a.row_gum + op * n;
  const float* __restrict__ eps = a.eps + op * k * a.ld_e;
  const float* __restrict__ umix = a.u_mix ? a.u_mix + op * a.ld_m : nullptr;
  Row* rows = a.shared_rows ? (Row*)s.rows : (Row*)li_o;

  // ---- phase a: the ancestor's node arrays become this particle's; grow
  // decision per node ----
  for (int q = t; q < S; q += T) {
    sv_o[q] = sv[q]; sl_o[q] = sl[q]; st_o[q] = st[q]; ct_o[q] = ct[q];
  }
  for (int q = t; q < k * S; q += T) { lf_o[q] = lf[q]; sp_o[q] = sp[q]; }
  for (int g = t; g < G; g += T) {
    const int node_sv = sv[lo + g];
    const bool want = (ug[g] < a.p_grow) && node_sv < 0 && ct[lo + g] >= 2.f
        && !frozen;
    const int var_s = s.vars[g];
    const bool active = frozen ? (node_sv >= 0) : want;
    s.varx[g] = min(max(frozen ? node_sv : var_s, 0), p - 1);
    s.flags[g] = (want ? kWant : 0) | (active ? kActive : 0);
    s.best[g] = 0ull;
    if (frozen) {  // the stored split is replayed
      s.valx[g] = sl[lo + g];
      s.setx[g] = st[lo + g];
    }
  }
  for (int q = t; q < ns * G2; q += T) s.acc[q] = 0;
  for (int q = t; q < G2; q += T) s.cnt[q] = 0;
  if (t == 0) *s.rtop = 0u;
  __syncthreads();

  // ---- pass A: stage the ancestor's rows; the chain's largest |r|; the
  // member row of every growing node by Gumbel arg-max ----
  {
    float top = 0.f;
    for (int base = warp * 32; base < n; base += T) {
      const int i = base + lane;
      int node = -1;
      unsigned long long key = 0ull;
      if (i < n) {
        // every load of the row first: one round trip to L2
        const int l = li[i];
        const float gv = frozen ? 0.f : gum[i];
        rows[i] = (Row)l;
        if (!frozen) {
          for (int kk = 0; kk < k; ++kk) top = fmaxf(top, fabsf(resid[(size_t)kk * n + i]));
          const int g = l - lo;
          if (g >= 0 && g < G && (s.flags[g] & kWant)) {
            node = g;
            key = pack_key(gv, i);
          }
        }
      }
      if (!frozen) keyed_max(node, key, s.best, lane);
    }
    if (!frozen) {  // non-negative floats order as their bit patterns
      for (int o = 16; o > 0; o >>= 1)
        top = fmaxf(top, __shfl_xor_sync(kFull, top, o));
      if (lane == 0) atomicMax(s.rtop, __float_as_uint(top));
    }
  }
  __syncthreads();

  // ---- phase A2: split values; fixed-point scales (ops/sums.py) ----
  int e_r = 0;
  if (!frozen) {
    const double rt = (double)__uint_as_float(*s.rtop);
    if (rt > 0.0 && rt < 1e300) frexp(rt, &e_r);
  }
  for (int g = t; g < G; g += T) {
    if (!(s.flags[g] & kWant)) continue;
    const unsigned long long key = s.best[g];
    // a node with no member row keeps row 0, as an arg-max over -inf does
    // (such a node never grows: its children are empty)
    const int r = key ? (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull)) : 0;
    const int col = s.varx[g];
    const float val_raw = X[(size_t)r * p + col];
    s.valraw[g] = val_raw;
    s.valx[g] = val_raw;
    s.setx[g] = sb[g];
    if (lin) {
      const int e_x = a.x_exp[col];
      s.scl[g] = ldexp(1.0, kFixedBits - e_x);
      s.scl[G + g] = ldexp(1.0, kFixedBits - 2 * e_x);
      s.scl[2 * G + g] = ldexp(1.0, kFixedBits - e_x - e_r);
    }
  }
  const double r_scale = ldexp(1.0, kFixedBits - e_r);
  __syncthreads();

  // ---- pass B: tentative routing; child counts and sums keyed by child ----
  for (int base = warp * 32; base < n; base += T) {
    const int i = base + lane;
    int key = -1, g = -1;
    float x = 0.f;
    const float r0 = (i < n && !frozen) ? resid[i] : 0.f;
    if (i < n) {
      const int l = (int)rows[i];
      g = l - lo;
      if (g >= 0 && g < G && (s.flags[g] & kActive)) {
        const int col = s.varx[g];
        x = X[(size_t)i * p + col];
        const bool left = go_left(x, s.valx[g], s.setx[g], a.rules[col]);
        const int tent = 2 * l + 1 + (left ? 0 : 1);
        rows[i] = (Row)tent;
        key = tent - hi;
      }
    }
    if (frozen) continue;  // (uniform over the block)
    const unsigned int peers = __match_any_sync(kFull, key);
    const bool leader = key >= 0 && lane == __ffs(peers) - 1;
    if (leader) atomicAdd(&s.cnt[key], __popc(peers));
    for (int kk = 0; kk < k; ++kk) {
      const float r = key < 0 ? 0.f : kk == 0 ? r0 : resid[(size_t)kk * n + i];
      const long long sum = group_sum(peers, to_fixed(r, r_scale));
      if (leader) add64(&s.acc[kk * G2 + key], sum);
    }
    if (lin) {
      const double xd = isnan(x) ? 0.0 : (double)x;
      const double sx = key >= 0 ? s.scl[g] : 0.0;
      const double sx2 = key >= 0 ? s.scl[G + g] : 0.0;
      const double sxr = key >= 0 ? s.scl[2 * G + g] : 0.0;
      long long sum = group_sum(peers, to_fixed(xd, sx));
      if (leader) add64(&s.acc[k * G2 + key], sum);
      sum = group_sum(peers, to_fixed(xd * xd, sx2));
      if (leader) add64(&s.acc[(k + 1) * G2 + key], sum);
      for (int kk = 0; kk < k; ++kk) {
        const float r = key < 0 ? 0.f : kk == 0 ? r0 : resid[(size_t)kk * n + i];
        sum = group_sum(peers, to_fixed((double)r * xd, sxr));
        if (leader) add64(&s.acc[(k + 2 + kk) * G2 + key], sum);
      }
    }
  }
  __syncthreads();

  // ---- phase d: validate, commit the level and the children ----
  const float fm = (float)a.m;
  const double r_inv = ldexp(1.0, e_r - kFixedBits);
  for (int w = t; w < G2 * k; w += T) {
    const int ch = w % G2, kk = w / G2, g = ch >> 1;
    const bool grow_ok = (s.flags[g] & kWant) && s.cnt[2 * g] > 0
        && s.cnt[2 * g + 1] > 0;
    float new_lf = lf[(size_t)kk * S + hi + ch];
    float new_sp = sp[(size_t)kk * S + hi + ch];
    if (grow_ok) {
      const float cnt = (float)s.cnt[ch];
      const float c_safe = fmaxf(cnt, 1.f);
      const float csum = (float)((double)s.acc[kk * G2 + ch] * r_inv);
      float mu_base = csum / c_safe / fm;
      if (lin) {
        // least-squares slope of the child residual on the split covariate
        const int e_x = a.x_exp[s.varx[g]];
        const float sx = (float)((double)s.acc[k * G2 + ch]
                                 * ldexp(1.0, e_x - kFixedBits));
        const float sx2 = (float)((double)s.acc[(k + 1) * G2 + ch]
                                  * ldexp(1.0, 2 * e_x - kFixedBits));
        const float sxr = (float)((double)s.acc[(k + 2 + kk) * G2 + ch]
                                  * ldexp(1.0, e_x + e_r - kFixedBits));
        const float var_x = sx2 - sx * sx / c_safe;
        bool usable = cnt >= 3.f && var_x > 1e-6f;
        if (a.response == 2) usable = usable && (umix ? umix[ch] : 1.f) < 0.5f;
        const float slope_hat = usable
            ? (sxr - (sx / c_safe) * csum) / fmaxf(var_x, 1e-6f) : 0.f;
        if (usable) mu_base = ((csum - slope_hat * sx) / c_safe) / fm;
        new_sp = slope_hat / fm;
        sp_o[(size_t)kk * S + hi + ch] = new_sp;
      }
      new_lf = mu_base + eps[(size_t)kk * a.ld_e + ch] * a.lsd[(size_t)c * k + kk];
      lf_o[(size_t)kk * S + hi + ch] = new_lf;
      if (kk == 0) {
        ct_o[hi + ch] = cnt;
        if (!(ch & 1)) {  // the node's commit, once
          sv_o[lo + g] = s.vars[g];
          sl_o[lo + g] = s.valraw[g];
          st_o[lo + g] = sb[g];
          s.flags[g] |= kFinal;
        }
      }
    } else if (frozen && kk == 0 && !(ch & 1) && sv[lo + g] >= 0) {
      s.flags[g] |= kFinal;  // a replayed split moves its rows
    }
    s.clf[kk * G2 + ch] = new_lf;
    s.csp[kk * G2 + ch] = new_sp;
  }
  __syncthreads();

  // ---- pass C: final routing, incremental prediction, log-likelihood ----
  double acc = 0.0;
  for (int i = t; i < n; i += T) {
    const int tent = (int)rows[i];
    const int l = tent >= hi ? (tent - 1) >> 1 : tent;
    const bool moved = tent >= hi && (s.flags[l - lo] & kFinal);
    li_o[i] = moved ? tent : l;
    float xv = 0.f;
    if (moved && lin) {
      const float x = X[(size_t)i * p + s.varx[l - lo]];
      xv = isnan(x) ? 0.f : x;
    }
    for (int kk = 0; kk < k; ++kk) {
      const size_t q = (size_t)kk * n + i;
      const float pv = pred[q], rv = resid[q], wv = llw[q];
      float v = pv;
      if (moved) {
        const int ch = tent - hi;
        v = s.clf[kk * G2 + ch];
        if (lin) v += s.csp[kk * G2 + ch] * xv;
      }
      pred_o[q] = v;
      const float df = rv - v;
      acc += (double)(wv * df * df);
    }
  }
  acc = bart::warp_sum_d(acc);
  if (lane == 0) s.part[warp] = acc;
  __syncthreads();
  if (t == 0) {
    double tot = 0.0;
    for (int q = 0; q < (T + 31) / 32; ++q) tot += s.part[q];
    a.ll_o[c * P + pi] = -0.5f * (float)tot;
  }
}

}  // namespace

extern "C" int grow_round_args_size() { return (int)sizeof(GrowArgs); }

extern "C" long long grow_round_smem_bytes(const void* args) {
  const GrowArgs& a = *(const GrowArgs*)args;
  Smem s;
  return (long long)layout(s, nullptr, 1 << a.d, a.k, a.response, a.n,
                           a.shared_rows);
}

extern "C" int grow_round_launch(const void* args, void* stream) {
  const GrowArgs& a = *(const GrowArgs*)args;
  if (a.k < 1 || a.k > kMaxK) return (int)cudaErrorInvalidValue;
  Smem s;
  const size_t bytes = layout(s, nullptr, 1 << a.d, a.k, a.response, a.n,
                              a.shared_rows);
  cudaError_t e = cudaSuccess;
  if (a.shared_rows) {
    auto* kern = grow_round_kernel<unsigned short>;
    if (bytes > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<a.C * a.P, kThreads, bytes, (cudaStream_t)stream>>>(a);
  } else {
    auto* kern = grow_round_kernel<int>;
    if (bytes > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<a.C * a.P, kThreads, bytes, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
