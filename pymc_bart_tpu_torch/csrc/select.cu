// select_refine: pick the winning particle of a tree update and refine its
// leaf values by Metropolis sweeps, for all chains.
//
// Replaces the TPU kernel
// pymc_bart_tpu/ops/select_pallas.py::select_refine_pallas (body _kernel):
// the winner over log_w; extraction of the winner's arrays; per-leaf
// residual sums into prior centres; R Metropolis sweeps on the leaf values
// under likelihood x N(leaf residual mean / m, leaf_sd) prior.  One output,
// Gaussian likelihood.  Besides the constant response of the TPU kernel it
// takes the linear and mix responses, which the JAX package runs in XLA
// (sampler/pgbart.py::_update_one_tree): the winner by arg-max of log_w plus
// Gumbels, the prediction with the winner's slope term, and the slopes
// extracted too.
//
// Bound: bytes, and far from them.  A launch reads the winner's node arrays
// and rows (leaf_idx, pred), resid, llw and the noise, and writes the
// winner's arrays: 127 KB at the main shapes (147 KB linear), 38 ns at
// 3.35 TB/s.  What sets the time is LATENCY: the chain of dependent steps
// of one chain's block.
//
// Design.  One block of 512 threads per chain (two rows a thread at n=1000;
// 1024 threads were 8-11 % slower, 256 17-19 %: scripts/select_variants.py),
// no serial scan anywhere, two barriers before the sweeps:
//   A  warp 0 finds the winner: inverse CDF on u_sel (bart::winner_warp)
//      for the constant response, arg-max of log_w + g_sel
//      (bart::argmax_warp) for linear and mix; the other warps stage the
//      rows' resid and llw (winner-independent) and take the chain's largest
//      |r|
//   B  the loads of the winner's node slot and rows go out together; per row
//      its leaf (16 bits in shared memory), for linear / mix sx =
//      slope[leaf] * x[row, parent's split variable] (0 at the root, where
//      the parent has no split, and where x is NaN, as
//      ops/predict.py::leaf_values_at), the winner's own log-likelihood; per
//      slot the outputs and the first proposal; then the leaf sums of the
//      residual in fixed point (a warp match, 32-bit warp reductions, one
//      shared-memory add per warp and leaf by bart::add64)
//   then per sweep one pass over the rows in shared memory, pred =
//   proposal[leaf] (+ sx), the log-likelihood; in the warps that hold node
//   slots only (4 of 16 at S=127), the accept test, the same in each, and
//   the next proposal, its noise loaded during the row pass.  Two barriers a
//   sweep; sweep 0's row pass runs beside the centres sum / max(count, 1) /
//   m and the priors of the winner and of the first proposal.
// (Cycles per phase: scripts/select_phase_clocks.py.)
// Rows that do not fit in shared memory (the wrapper decides: about 16,000
// at the linear response) stay in global memory: leaf_idx in the block's own
// li_o, sx in pred_o until the end.  Slower, the same numbers.
//
// Order of sums (ops/sums.py, the rule the plain version follows too): leaf
// sums in fixed point on the chain's exponent, row and leaf sums of the
// log-likelihood and the prior in float64 rounded to float32 once (a
// butterfly in each warp, then the warp partials by a butterfly that every
// deciding warp runs alike), quotients as true divisions, every float32 product
// rounded before it is added (__fmul_rn / __fadd_rn; the file is built without
// fused multiply-add, ops/_build.py).  Kernel and plain version then agree
// bit for bit.
#include "common.cuh"

#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFixedBits = 38;
static_assert(kWarps <= 32, "total() reads one partial per lane");

// Mirrored field by field by ops/select.py::_SelectArgs (ctypes).
struct SelectArgs {
  const int* sv; const float* sl; const int* st; const float* lf;
  const float* ct; const float* sp; const int* li; const float* pred;
  const float* lw; const float* resid; const float* llw; const float* X;
  const float* eps; const float* uacc; const float* usel; const float* gsel;
  const float* hiv;
  int* sv_o; float* sl_o; int* st_o; float* lf_o; float* ct_o; float* sp_o;
  int* li_o; float* pred_o;
  int C, P, S, n, p, R, ld_r, m;
  int lin;          // 1: linear or mix response (slopes), 0: constant
  int shared_rows;  // the rows in shared memory
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// warp partials of the float64 sums: the winner's log-likelihood and prior,
// then the proposals' by the parity of the sweep
enum Part { kLikC = 0, kPriC = 1, kLikP = 2, kPriP = 4, kParts = 6 };

// Dynamic shared memory of one block (mirrored by ops/select.py::smem_bytes).
struct Smem {
  double* part;            // kParts x 32
  long long* acc;          // S  fixed-point leaf sums
  float* wmax;             // 32 warp maxima of |r|
  float* prob;             // P  scratch of the winner's CDF
  float *lfw, *lfp, *mask, *ctr;  // S
  float *r, *w, *sx;       // n  rows (shared_rows; sx for linear / mix)
  unsigned short* li;      // n
};

__host__ __device__ inline size_t layout(Smem& s, unsigned char* base, int S,
                                         int P, int n, int lin,
                                         int shared_rows) {
  size_t off = 0;
  s.part = (double*)(base + off);     off += 8 * kParts * 32;
  s.acc = (long long*)(base + off);   off += 8 * (size_t)S;
  s.wmax = (float*)(base + off);      off += 4 * 32;
  s.prob = (float*)(base + off);      off += 4 * (size_t)P;
  s.lfw = (float*)(base + off);       off += 4 * (size_t)S;
  s.lfp = (float*)(base + off);       off += 4 * (size_t)S;
  s.mask = (float*)(base + off);      off += 4 * (size_t)S;
  s.ctr = (float*)(base + off);       off += 4 * (size_t)S;
  off = align16(off);
  if (shared_rows) {
    s.r = (float*)(base + off);       off += 4 * (size_t)n;
    s.w = (float*)(base + off);       off += 4 * (size_t)n;
    s.sx = (float*)(base + off);      if (lin) off += 4 * (size_t)n;
    s.li = (unsigned short*)(base + off); off += 2 * (size_t)n;
  }
  return align16(off);
}

// Sum of the warp partials part[0..kWarps-1], by a butterfly that each warp
// calling it runs on the same numbers: the same bits in every such thread.
__device__ __forceinline__ double total(const double* part) {
  const int lane = threadIdx.x & 31;
  return bart::warp_sum_d(lane < kWarps ? part[lane] : 0.0);
}

// The prior term of one leaf: mask * dv * dv (constant: the sum is scaled by
// -hiv afterwards) or hiv * mask * dv * dv (linear / mix), each product
// rounded, in the order of the plain versions.
__device__ __forceinline__ double prior_term(bool lin, float h, float mk, float dv) {
  const float a = lin ? __fmul_rn(h, mk) : mk;
  return (double)__fmul_rn(__fmul_rn(a, dv), dv);
}

__device__ __forceinline__ float prior_of(bool lin, float h, double sum) {
  const float s = __double2float_rn(sum);
  return lin ? -s : __fmul_rn(-h, s);
}

__device__ __forceinline__ float lik_term(float r, float w, float pv) {
  const float df = __fsub_rn(r, pv);
  return __fmul_rn(__fmul_rn(w, df), df);
}

extern __shared__ unsigned long long smem_u64[];

template <bool kSh>
__global__ void __launch_bounds__(kThreads) select_refine_kernel(const SelectArgs a) {
  const int c = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int P = a.P, S = a.S, n = a.n, p = a.p, R = a.R;
  const bool lin = a.lin != 0;
  Smem s;
  layout(s, (unsigned char*)smem_u64, S, P, n, a.lin, kSh);
  __shared__ int s_widx, s_any;
  // the warps that hold node slots decide the sweeps; the others only sum
  // rows (S <= kThreads: one slot a thread at most)
  const bool slot_warp = warp * 32 < S, one_slot = S <= kThreads;
  const float h = a.hiv[c];  // (every load that does not wait for the
                             // winner is issued before it is known)
  const float* __restrict__ eps = a.eps + (size_t)c * a.ld_r * S;
  const float* __restrict__ uacc = a.uacc + (size_t)c * a.ld_r;
  const float* __restrict__ resid = a.resid + (size_t)c * n;
  const float* __restrict__ llw = a.llw + (size_t)c * n;
  int* __restrict__ li_o = a.li_o + (size_t)c * n;
  float* __restrict__ pred_o = a.pred_o + (size_t)c * n;

  // ---- A: the winner on warp 0; the rows' winner-independent loads and
  // the chain's largest |r| on the other warps ----
  if (warp == 0) {
    const float* lw = a.lw + (size_t)c * P;
    const int w = lin ? bart::argmax_warp(lw, a.gsel + (size_t)c * P, P)
                      : bart::winner_warp(lw, s.prob, P, a.usel[c]);
    if (lane == 0) {
      s_widx = w;
      s.wmax[0] = 0.f;
    }
  } else {
    float top = 0.f;
    for (int i = t - 32; i < n; i += kThreads - 32) {
      const float r = resid[i];
      top = fmaxf(top, fabsf(r));
      if (kSh) { s.r[i] = r; s.w[i] = llw[i]; }
    }
    top = bart::warp_max_f(top);
    if (lane == 0) s.wmax[warp] = top;
  }
  for (int q = t; q < S; q += kThreads) s.acc[q] = 0;
  if (!slot_warp && lane == 0) {  // their prior partials stay 0
    s.part[kPriC * 32 + warp] = 0.0;
    s.part[kPriP * 32 + warp] = 0.0;
    s.part[(kPriP + 1) * 32 + warp] = 0.0;
  }
  if (t == 0) s_any = 0;
  __syncthreads();

  // ---- B: the winner's node arrays and rows (its slot's loads issued
  // first, then its rows': one round trip for both); per row its leaf, sx
  // and the winner's log-likelihood; the first proposal; the fixed-point
  // leaf sums ----
  const size_t wp = (size_t)c * P + s_widx;
  const int* __restrict__ sv = a.sv + wp * S;
  const float* __restrict__ ct = a.ct + wp * S;
  const float* __restrict__ lf = a.lf + wp * S;
  const float* __restrict__ sp = lin ? a.sp + wp * S : nullptr;
  const int* __restrict__ li = a.li + wp * n;
  const float* __restrict__ pred = a.pred + wp * n;
  int v0 = -1, st0 = 0;
  float ct0 = 0.f, lf0 = 0.f, sl0 = 0.f, sp0 = 0.f, e0 = 0.f;
  if (one_slot && t < S) {
    v0 = sv[t]; ct0 = ct[t]; lf0 = lf[t]; sl0 = a.sl[wp * S + t];
    st0 = a.st[wp * S + t];
    if (lin) sp0 = sp[t];
    if (R > 0) e0 = eps[t];
  }
  int e_r = 0;
  {
    float top = 0.f;
    for (int q = 0; q < kWarps; ++q) top = fmaxf(top, s.wmax[q]);
    const double rt = (double)top;
    if (rt > 0.0 && rt < 1e300) frexp(rt, &e_r);
  }
  {
    double acc = 0.0;
#pragma unroll 2
    for (int i = t; i < n; i += kThreads) {
      const int l = li[i];
      const float pv = pred[i];
      li_o[i] = l;
      if (kSh) s.li[i] = (unsigned short)l;
      acc += (double)lik_term(kSh ? s.r[i] : resid[i], kSh ? s.w[i] : llw[i], pv);
      if (lin) {
        const int pvar = sv[l > 0 ? (l - 1) >> 1 : 0];
        float xp = 0.f;
        if (l > 0 && pvar >= 0) {
          // NaN as 0 and +-inf as the largest finite value: torch.nan_to_num
          const float x = a.X[(size_t)i * p + min(pvar, p - 1)];
          xp = isnan(x) ? 0.f : fminf(fmaxf(x, -FLT_MAX), FLT_MAX);
        }
        const float sx = __fmul_rn(sp[l], xp);
        if (kSh) s.sx[i] = sx; else pred_o[i] = sx;
      }
    }
    acc = bart::warp_sum_d(acc);
    if (lane == 0) s.part[kLikC * 32 + warp] = acc;
  }
  for (int q = t; q < S; q += kThreads) {
    const int v = one_slot ? v0 : sv[q];
    const float cn = one_slot ? ct0 : ct[q];
    const float lfv = one_slot ? lf0 : lf[q];
    const float mk = (v < 0 && cn > 0.f) ? 1.f : 0.f;
    a.sv_o[(size_t)c * S + q] = v;
    a.sl_o[(size_t)c * S + q] = one_slot ? sl0 : a.sl[wp * S + q];
    a.st_o[(size_t)c * S + q] = one_slot ? st0 : a.st[wp * S + q];
    a.ct_o[(size_t)c * S + q] = cn;
    if (lin) a.sp_o[(size_t)c * S + q] = one_slot ? sp0 : sp[q];
    s.lfw[q] = lfv;
    s.mask[q] = mk;
    s.ctr[q] = cn;  // the count, until sweep 0 makes it the centre
    if (R > 0) s.lfp[q] = __fadd_rn(lfv, __fmul_rn(one_slot ? e0 : eps[q], mk));
  }
  {
    const double r_scale = ldexp(1.0, kFixedBits - e_r);
    for (int base = warp * 32; base < n; base += kThreads) {
      const int i = base + lane;  // the rows this thread staged above
      int key = -1;
      long long q = 0;
      if (i < n) {
        key = kSh ? (int)s.li[i] : li_o[i];
        q = bart::to_fixed(kSh ? s.r[i] : resid[i], r_scale);
      }
      bart::keyed_add_shared(key, q, s.acc, lane);
    }
  }
  __syncthreads();

  // ---- R Metropolis sweeps: one pass over the rows each, then the slot
  // warps decide (the same in each) and make the next proposal.  Sweep 0's
  // row pass runs beside the centres and the priors of the winner and of
  // the first proposal ----
  const float fm = (float)a.m;
  float ll_c = 0.f;
  for (int r = 0; r < R; ++r) {
    const int par = r & 1;
    const bool next = r + 1 < R;
    // this sweep's uniform and the next proposal's noise, loaded ahead
    const float u_r = slot_warp ? uacc[r] : 1.f;
    const float e_next = (one_slot && t < S && next) ? eps[(size_t)(r + 1) * S + t] : 0.f;
    if (r == 0 && slot_warp) {
      const double r_inv = ldexp(1.0, e_r - kFixedBits);
      double pc = 0.0, pp = 0.0;
      for (int q = t; q < S; q += kThreads) {
        const float sum = __double2float_rn((double)s.acc[q] * r_inv);
        const float ctr = __fdiv_rn(__fdiv_rn(sum, fmaxf(s.ctr[q], 1.f)), fm);
        const float mk = s.mask[q];
        s.ctr[q] = ctr;
        pc += prior_term(lin, h, mk, __fsub_rn(s.lfw[q], ctr));
        pp += prior_term(lin, h, mk, __fsub_rn(s.lfp[q], ctr));
      }
      pc = bart::warp_sum_d(pc);
      pp = bart::warp_sum_d(pp);
      if (lane == 0) {
        s.part[kPriC * 32 + warp] = pc;
        s.part[kPriP * 32 + warp] = pp;
      }
    }
    double acc = 0.0;
    for (int i = t; i < n; i += kThreads) {
      const int l = kSh ? (int)s.li[i] : li_o[i];
      float pv = s.lfp[l];
      if (lin) pv = __fadd_rn(pv, kSh ? s.sx[i] : pred_o[i]);
      acc += (double)lik_term(kSh ? s.r[i] : resid[i], kSh ? s.w[i] : llw[i], pv);
    }
    acc = bart::warp_sum_d(acc);
    if (lane == 0) s.part[(kLikP + par) * 32 + warp] = acc;
    __syncthreads();
    if (slot_warp) {
      if (r == 0)  // the winner's log-likelihood + prior
        ll_c = __fadd_rn(
            __fmul_rn(-0.5f, __double2float_rn(total(s.part + kLikC * 32))),
            prior_of(lin, h, total(s.part + kPriC * 32)));
      const float ll_p = __fadd_rn(
          __fmul_rn(-0.5f, __double2float_rn(total(s.part + (kLikP + par) * 32))),
          prior_of(lin, h, total(s.part + (kPriP + par) * 32)));
      const bool take = logf(u_r) < __fsub_rn(ll_p, ll_c);
      if (take) {
        ll_c = ll_p;
        if (t == 0) s_any = 1;
      }
      double pp = 0.0;
      for (int q = t; q < S; q += kThreads) {
        float lw = s.lfw[q];
        if (take) { lw = s.lfp[q]; s.lfw[q] = lw; }
        if (next) {
          const float mk = s.mask[q];
          const float e = one_slot ? e_next : eps[(size_t)(r + 1) * S + q];
          const float lp = __fadd_rn(lw, __fmul_rn(e, mk));
          s.lfp[q] = lp;
          pp += prior_term(lin, h, mk, __fsub_rn(lp, s.ctr[q]));
        }
      }
      if (next) {
        pp = bart::warp_sum_d(pp);
        if (lane == 0) s.part[(kPriP + (par ^ 1)) * 32 + warp] = pp;
      }
    }
    __syncthreads();
  }

  // ---- outputs: the leaves, and the prediction of the last accepted
  // proposal (the winner's own where none was accepted) ----
  const bool any = s_any != 0;
  for (int q = t; q < S; q += kThreads) a.lf_o[(size_t)c * S + q] = s.lfw[q];
  for (int i = t; i < n; i += kThreads) {
    float v;
    if (any) {
      v = s.lfw[kSh ? (int)s.li[i] : li_o[i]];
      if (lin) v = __fadd_rn(v, kSh ? s.sx[i] : pred_o[i]);
    } else {
      v = pred[i];
    }
    pred_o[i] = v;
  }
}

}  // namespace

extern "C" int select_refine_args_size() { return (int)sizeof(SelectArgs); }

extern "C" long long select_refine_smem_bytes(const void* args) {
  const SelectArgs& a = *(const SelectArgs*)args;
  Smem s;
  return (long long)layout(s, nullptr, a.S, a.P, a.n, a.lin, a.shared_rows);
}

extern "C" int select_refine_launch(const void* args, void* stream) {
  const SelectArgs& a = *(const SelectArgs*)args;
  Smem s;
  const size_t bytes = layout(s, nullptr, a.S, a.P, a.n, a.lin, a.shared_rows);
  cudaError_t e = cudaSuccess;
  if (a.shared_rows) {
    auto* kern = select_refine_kernel<true>;
    if (bytes > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<a.C, kThreads, bytes, (cudaStream_t)stream>>>(a);
  } else {
    auto* kern = select_refine_kernel<false>;
    if (bytes > 48 * 1024)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<a.C, kThreads, bytes, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
