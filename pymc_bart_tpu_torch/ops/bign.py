"""One whole PGBART step for LARGE n: CUDA kernel wrapper, plain version and
the gate that admits a configuration (``sampler.pgbart.resolve_route`` says
when the sampler takes this route).

Counterpart of ``pymc_bart_tpu/ops/bign_pallas.py`` (``pgbart_step_bign``,
``bign_supported_reason``); the kernel is ``csrc/bign.cu``.  The step computes
what ``ops/draw.py`` computes, in the formulation that scales with the number
of rows: the only per-particle row state is the row -> node array ``li``
(C*P, n), and every row pass is spread over the whole card.

* ``"gauss"`` (``y ~ Normal(F, sigma)`` with ONE precision per chain): the
  log-likelihood of a particle is an exact function of per-node
  ``(count, sum r, sum r^2)``,
  ``ll = -w/2 * sum_leaves (Q - 2 lf R + lf^2 N)``, so the SMC weights, the
  winner and the Metropolis leaf refinements are node-space algebra.  Per level
  one pass finds each growing node's split row (Gumbel arg-max, ties to the
  lowest row), one sums the left child's statistics (the right child is the
  parent minus the left), one routes the rows.
* ``"bernoulli"``, ``"het_abs"``, ``"het_exp"``, ``"cat_logit"``: the
  likelihood does not collapse onto node statistics, so a per-particle
  prediction row (C*P, n) is carried and the routing pass also sums the exact
  row log-likelihood (the closed forms of ``sampler.pgbart.closed_form_ll``).
  No leaf refinement in this regime (``num_refinements == 0``).

Sums that reach a discrete decision (empty-child test, ESS gate, ancestors,
winner, Metropolis accept) are accumulated in float64 and rounded to float32
once, in the kernel and in the plain version alike, so the two agree in every
integer although they add in different orders.

The state (``sampler.pgbart.PgbartState``) is UPDATED IN PLACE; ``split_set``
and ``slope`` are left as they are (all-continuous rules, constant response).
The random numbers (``StepRands``) are an argument.  The row Gumbels are
either the pre-drawn block ``rands.rg`` (B, D, C, P, n) or, with
``rands.rg is None``, generated inside the kernel from ``rands.seed`` (two
int32 words on the card: no host synchronisation to draw them;
Philox-4x32-10 counted by tree, level, chain, particle and row, 23 bits
mapped to ``u = (k + 0.5) 2^-23``, which float32 holds exactly inside (0, 1));
``gumbel_block`` writes out the block the generator produces.  The plain
version has no generator and needs the block.

Dispatch: the kernel runs when the state lies on a CUDA device, the plain
version when it lies on the CPU; ``impl="kernel"|"plain"`` forces one.
Nothing falls back: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import tracing
from ..config import BartConfig, PgbartConfig
from . import _build
from .draw import LIK_CODES, target_rows
from .smc import smc_resample_plain
from .sums import seq_cumsum, sum64 as _sum64, true_div

_ROWLL_LIKS = ("bernoulli", "het_abs", "het_exp", "cat_logit")
_MAX_DEPTH = 8            # node accumulators of a block (mirrors csrc/bign.cu)
_TILE_ROWS = 1024         # rows of one block of a row pass, at least
_MAX_TILES = 64           # tiles a node-space phase adds up, at most


def tiling(n: int):
    """``(rows per tile, tiles)`` of the row passes for ``n`` rows."""
    tile = max(_TILE_ROWS, -(-n // _MAX_TILES))
    tile = -(-tile // 256) * 256
    return tile, -(-n // tile)


def step_bytes(C: int, B: int, P: int, D: int, S: int, n: int, p: int,
               R: int, rowll: bool, pre_drawn: bool) -> int:
    """Bytes of one step's scratch, random blocks and covariates."""
    CP, Gm, Gtot = C * P, 2 ** (D - 1), 2**D - 1
    _tile, ntiles = tiling(n)
    rows = 4 * (2 * CP * n * (2 if rowll else 1) + 2 * C * n)
    nodes = 4 * (2 * CP * S * 7 + CP * Gm * 6)
    parts = ntiles * (CP * Gm * 20 + 2 * CP * 8 + C * 24)
    rands = 4 * (B * C * P * 4 * Gtot + B * D * C + B * C + B * C * R * S
                 + B * C * R + (B * D * CP * n if pre_drawn else 0))
    return rows + nodes + parts + rands + 4 * n * p


def bign_unsupported_reason(cfg: BartConfig, pg: PgbartConfig, X, lik: str,
                            w_scalar: bool, all_cont: bool, x_nan: bool,
                            chains: Optional[int] = None):
    """None when the large-n function covers this configuration, else why not.

    The semantic conditions are the reference's.  The size limits apply to a
    CUDA ``X`` only and are this card's: the depth a block's node accumulators
    cover, and the row state, the covariates and the sampler state within half
    of the card's memory.
    """
    if lik not in LIK_CODES:
        return ("the large-n function covers the gauss/bernoulli/het/cat_logit "
                f"likelihood codes (lik={lik!r})")
    if lik == "gauss" and not w_scalar:
        return ("the large-n function needs a scalar per-chain noise precision "
                "(sigma must be a scalar random variable)")
    if lik in _ROWLL_LIKS and pg.num_refinements != 0:
        return ("the large-n function covers non-Gaussian likelihoods only "
                "with num_refinements=0 (leaf refinement does not collapse to "
                "node statistics)")
    if cfg.response != "constant":
        return (f"response={cfg.response!r} (the large-n function covers "
                "'constant')")
    if cfg.n_outputs != 1:
        return f"n_outputs={cfg.n_outputs} (the large-n function covers 1)"
    if not all_cont:
        return "the large-n function covers all-continuous split rules"
    if x_nan:
        return "the large-n function covers NaN-free X"
    if not (isinstance(X, torch.Tensor) and X.is_cuda):
        return None
    if cfg.max_depth > _MAX_DEPTH:
        return (f"max_depth={cfg.max_depth}: a block's node accumulators "
                f"cover {_MAX_DEPTH} levels")
    if chains is not None:
        n, p = X.shape
        total = torch.cuda.get_device_properties(X.device).total_memory
        B = max(pg.batch_size(cfg.m, True), pg.batch_size(cfg.m, False))
        need = memory_bytes(cfg, pg, n, p, chains, lik, B)
        if need > total // 2:
            return (f"row state, covariates and sampler state take {need} "
                    f"bytes, more than half of the card's {total}")
    return None


def memory_bytes(cfg: BartConfig, pg: PgbartConfig, n: int, p: int,
                 chains: int, lik: str, B: int) -> int:
    """Device bytes the route needs: one step's scratch and blocks (generated
    Gumbels) plus the sampler state (tree_pred dominates)."""
    state = 4 * chains * (cfg.m * n + 4 * n + 6 * cfg.m * cfg.n_nodes + p)
    return state + step_bytes(
        chains, B, pg.num_particles, cfg.max_depth, cfg.n_nodes, n, p,
        max(pg.num_refinements, 1), lik in _ROWLL_LIKS, pre_drawn=False)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def pgbart_step_bign_plain(state, rands, X, Y_target, cfg: BartConfig,
                           pg: PgbartConfig, w_chain, tuning: bool, *,
                           lik: str = "gauss", lik_const: float = 0.0,
                           llw=None):
    """Plain PyTorch version of this formulation (same arguments and outputs
    as the kernel, state updated in place).  ``w_chain`` (C,): the Gaussian
    precision of each chain; ``llw`` (C, n): row data of het/cat codes."""
    from ..sampler.pgbart import (alpha_cdf_of, closed_form_ll,
                                  split_var_counts)

    if rands.rg is None:
        raise ValueError(
            "pgbart_step_bign: the plain version has no generator of its own "
            "and needs the pre-drawn row Gumbels rands.rg (B, D, C, P, n); "
            "draw them with draw_rands(row_gumbels=True) or write them out "
            "with ops.bign.gumbel_block")
    f = state.forest
    C, m, S = f.split_var.shape
    n, p = X.shape
    P, D = pg.num_particles, cfg.max_depth
    B = pg.batch_size(m, tuning)
    R = max(pg.num_refinements, 1)
    CP, Gtot = C * P, 2**D - 1
    rowll = lik != "gauss"
    dev = X.device
    f32, f64, i64 = torch.float32, torch.float64, torch.int64
    y = Y_target.reshape(-1, n)           # (1, n), or (C, n): one a chain
    ar = torch.arange(C, device=dev)
    q_ar = torch.arange(CP, device=dev)
    chain_of = q_ar // P
    frozen = (q_ar % P == 0)[:, None]                            # (CP, 1)
    base = (ar * P)[:, None]                                     # (C, 1)
    rows = torch.arange(n, device=dev)
    off0 = state.batch_offset.to(i64)
    w_c = w_chain.reshape(C).to(f32)
    w_q = w_c[chain_of]
    row_q = None if llw is None else llw.reshape(C, n)[chain_of]
    y_q = y[chain_of] if y.shape[0] > 1 else y                   # (CP|1, n)
    mf = float(m)

    def stats_ll(lf, ct, rs, rq, lm):
        q = torch.where(lm, rq - 2.0 * lf * rs + lf * lf * ct,
                        torch.zeros_like(lf))
        return -0.5 * w_q * _sum64(q)

    for b in range(B):
        jt = (off0 + b) % m
        noi = state.sum_trees[:, :, 0] - state.tree_pred[ar, jt, :, 0]
        resid = y - noi                                          # (C, n)
        root_r = _sum64(resid)
        root_q = _sum64(resid * resid)
        root_mu = true_div(true_div(root_r, n), mf)
        cdf = alpha_cdf_of(state.alpha_vec)[chain_of]            # (CP, p)
        total = cdf[:, -1:]
        lsd = state.leaf_sd[:, 0]
        resid_q, noi_q = resid[chain_of], noi[chain_of]          # (CP, n)

        def fresh(old, root, fill=0):
            """Particle 0 = the current tree, the others = a root leaf."""
            a = torch.full((C, P, S), fill, dtype=old.dtype, device=dev)
            a[:, :, 0] = root
            a[:, 0] = old
            return a.reshape(CP, S)

        sv = fresh(f.split_var[ar, jt], -1, fill=-1)
        sl = fresh(f.split_val[ar, jt], 0.0)
        lf = fresh(f.leaf[ar, jt, :, 0], root_mu[:, None])
        ct = fresh(f.count[ar, jt], float(n))
        rs = torch.zeros((CP, S), dtype=f32, device=dev)
        rq = torch.zeros((CP, S), dtype=f32, device=dev)
        rs[:, 0], rq[:, 0] = root_r[chain_of], root_q[chain_of]
        lm = torch.zeros((CP, S), dtype=torch.bool, device=dev)
        lm[:, 0] = True
        li = torch.zeros((CP, n), dtype=i64, device=dev)

        def rows_ll(pred):
            terms = closed_form_ll(lik, lik_const, noi_q + pred, y_q, row_q)
            return _sum64(terms)

        pred = lf[:, 0:1].expand(CP, n).contiguous() if rowll else None
        ll = rows_ll(pred) if rowll else stats_ll(lf, ct, rs, rq, lm)
        log_w, ll_prev = ll, ll

        ug = rands.ug[b].reshape(CP, Gtot)
        uv = rands.uv[b].reshape(CP, Gtot)
        eps = rands.eps[b].reshape(CP, 2 * Gtot)
        for d in range(D):
            lo, hi, G = 2**d - 1, 2 ** (d + 1) - 1, 2**d
            p_grow = float(cfg.alpha * (1.0 + d) ** (-cfg.beta))
            sv_l, ct_l = sv[:, lo:hi], ct[:, lo:hi]
            want = ((ug[:, lo:hi] < p_grow) & (sv_l < 0) & (ct_l >= 2.0)
                    & ~frozen)
            u_node = (uv[:, lo:hi] * total).contiguous()
            var_draw = torch.searchsorted(cdf.contiguous(), u_node).clamp(
                0, p - 1)
            var_eff = torch.where(frozen, sv_l.clamp(0, p - 1).to(i64),
                                  var_draw)
            active = torch.where(frozen, sv_l >= 0, want)        # (CP, G)

            # pass 1: the row with the largest Gumbel of every growing node,
            # ties to the lowest row; the split value is X there
            g_cl = (li - lo).clamp(0, G - 1)
            in_lvl = (li >= lo) & (li < hi)
            act_row = in_lvl & active.gather(1, g_cl)
            grow_row = act_row & ~frozen
            rg = rands.rg[b, d].reshape(CP, n)
            idx = torch.where(grow_row, g_cl, torch.full_like(g_cl, G))
            mx = torch.full((CP, G + 1), -torch.inf, dtype=f32, device=dev)
            mx = mx.scatter_reduce(1, idx, rg, "amax")
            win = grow_row & (rg == mx.gather(1, idx))
            ridx = torch.full((CP, G + 1), n, dtype=i64, device=dev)
            ridx = ridx.scatter_reduce(
                1, idx, torch.where(win, rows[None, :], n), "amin")[:, :G]
            val_raw = torch.where(ridx < n,
                                  X[ridx.clamp_max(n - 1), var_eff],
                                  torch.zeros((), dtype=f32, device=dev))
            valx = torch.where(frozen, sl[:, lo:hi], val_raw)

            # pass 2: left-child statistics (float64 sums, integer counts)
            left = (X[rows[None, :], var_eff.gather(1, g_cl)]
                    <= valx.gather(1, g_cl))
            idx = torch.where(act_row & left, g_cl, torch.full_like(g_cl, G))
            cl = torch.zeros((CP, G + 1), dtype=i64, device=dev).scatter_add(
                1, idx, torch.ones_like(idx))[:, :G].to(f32)
            z64 = torch.zeros((CP, G + 1), dtype=f64, device=dev)
            rl = z64.scatter_add(1, idx, resid_q.to(f64))[:, :G].to(f32)
            ql = z64.scatter_add(1, idx, (resid_q * resid_q).to(f64)
                                 )[:, :G].to(f32)

            # node space: empty-child revert, child leaves and statistics
            cr = ct_l - cl
            rr, qr = rs[:, lo:hi] - rl, rq[:, lo:hi] - ql
            grow_ok = want & (cl > 0.5) & (cr > 0.5)
            act_fin = torch.where(frozen, sv_l >= 0, grow_ok)

            def pair(a_l, a_r):
                return torch.stack([a_l, a_r], dim=2).reshape(CP, 2 * G)

            c_ch, r_ch, q_ch = pair(cl, cr), pair(rl, rr), pair(ql, qr)
            mu_ch = (true_div(r_ch / c_ch.clamp_min(1.0), mf)
                     + eps[:, 2 * lo:2 * lo + 2 * G] * lsd[chain_of][:, None])
            grow_rep, act_rep = pair(grow_ok, grow_ok), pair(act_fin, act_fin)
            ch = slice(hi, hi + 2 * G)
            sv[:, lo:hi] = torch.where(grow_ok, var_eff.to(sv.dtype), sv_l)
            sl[:, lo:hi] = torch.where(grow_ok, val_raw, sl[:, lo:hi])
            lf[:, ch] = torch.where(grow_rep, mu_ch, lf[:, ch])
            ct[:, ch] = torch.where(grow_rep, c_ch, ct[:, ch])
            rs[:, ch] = torch.where(act_rep, r_ch, rs[:, ch])
            rq[:, ch] = torch.where(act_rep, q_ch, rq[:, ch])
            lm[:, ch] = lm[:, ch] | act_rep
            lm[:, lo:hi] = lm[:, lo:hi] & ~act_fin

            # pass 3: rows move to the committed children
            move = in_lvl & act_fin.gather(1, g_cl)
            li = torch.where(move, 2 * li + 1 + (~left).to(i64), li)
            if rowll:
                pred = torch.where(move, lf.gather(1, li), pred)
                ll = rows_ll(pred)
            else:
                ll = stats_ll(lf, ct, rs, rq, lm)

            if d < D - 1:
                lw, take, llp = smc_resample_plain(
                    ll.reshape(C, P), ll_prev.reshape(C, P),
                    log_w.reshape(C, P), rands.ures[b, d])
                log_w, ll_prev = lw.reshape(CP), llp.reshape(CP)
                src = (base + take.to(i64)).reshape(CP)
                sv, sl, lf, ct, rs, rq, lm, li = (
                    a[src] for a in (sv, sl, lf, ct, rs, rq, lm, li))
                if rowll:
                    pred = pred[src]
            else:
                log_w = log_w + ll - ll_prev

        # winner by inverse CDF over exp(log_w - max)
        lw = log_w.reshape(C, P)
        cdf_w = seq_cumsum(torch.exp(lw - lw.max(dim=1, keepdim=True).values))
        u = rands.usel[b] * cdf_w[:, -1]
        wq = (base[:, 0] + (cdf_w < u[:, None]).sum(dim=1).clamp(0, P - 1))
        sv_w, sl_w, lf_w, ct_w, rs_w, rq_w, lm_w = (
            a[wq] for a in (sv, sl, lf, ct, rs, rq, lm))
        if rowll:
            pred_w = pred[wq]
        else:
            # R Metropolis sweeps on the leaf values, on the node statistics
            mask = (sv_w < 0) & (ct_w > 0)
            center = true_div(rs_w / ct_w.clamp_min(1.0), mf)
            hiv = 0.5 / (lsd * lsd)
            zero = torch.zeros_like(lf_w)

            def score(lf_x):
                q = torch.where(lm_w, rq_w - 2.0 * lf_x * rs_w
                                + lf_x * lf_x * ct_w, zero)
                dv = lf_x - center
                return (-0.5 * w_c * _sum64(q)
                        + (-hiv) * _sum64(torch.where(mask, dv * dv, zero)))

            ll_c = score(lf_w)
            eps_scale = (0.3 * lsd)[:, None]
            for r in range(R):
                lf_p = lf_w + rands.epsr[b, :, r, 0, :] * eps_scale * mask.to(f32)
                ll_p = score(lf_p)
                acc = torch.log(rands.uacc[b, :, r]) < (ll_p - ll_c)
                lf_w = torch.where(acc[:, None], lf_p, lf_w)
                ll_c = torch.where(acc, ll_p, ll_c)
            pred_w = lf_w.gather(1, li[wq])

        # commit, adaptation
        f.split_var[ar, jt] = sv_w
        f.split_val[ar, jt] = sl_w
        f.leaf[ar, jt] = lf_w[:, :, None]
        f.count[ar, jt] = ct_w
        state.tree_pred[ar, jt] = pred_w[:, :, None]
        state.sum_trees = (noi + pred_w)[:, :, None]
        state.iteration = state.iteration + 1
        if tuning:
            p_range = torch.arange(p, dtype=sv_w.dtype, device=dev)
            tcounts = (sv_w[:, :, None] == p_range).to(f32).sum(dim=1)
            state.alpha_vec = (state.alpha_vec * pg.split_prior_decay
                               + tcounts)
            state.wf_count = state.wf_count + 1.0
            wc = state.wf_count[:, None]
            wf_mean, wf_m2 = state.wf_mean[:, :, 0], state.wf_m2[:, :, 0]
            delta = pred_w - wf_mean
            wf_mean = wf_mean + delta / wc
            wf_m2 = wf_m2 + delta * (pred_w - wf_mean)
            state.wf_mean, state.wf_m2 = wf_mean[:, :, None], wf_m2[:, :, None]
            sd = true_div(_sum64(torch.sqrt(
                (wf_m2 / wc.clamp_min(1.0)).clamp_min(1e-12))), n)
            state.leaf_sd = torch.where(
                (state.iteration > m)[:, None], sd.clamp_min(1e-6)[:, None],
                state.leaf_sd)

    state.batch_offset = ((off0 + B) % m).to(torch.int32)
    return state, split_var_counts(f, p)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_POINTERS = (
    "f_sv", "f_sl", "f_lf", "f_ct", "tree_pred", "sum_trees", "alpha_vec",
    "leaf_sd", "wf_count", "wf_mean", "wf_m2", "batch_offset", "iteration",
    "X", "y", "llw", "w_chain",
    "ug", "uv", "rg", "eps", "ures", "usel", "epsr", "uacc", "seed",
    "ns_sv", "ns_sl", "ns_lf", "ns_ct", "ns_rs", "ns_rq", "ns_lm",
    "lv_var", "lv_flags", "lv_val", "lv_raw", "lv_best",
    "li", "pred", "resid", "noi",
    "part_stat", "part_cnt", "part_ll", "part_root", "part_sd",
    "cdf", "root", "ll", "ll_prev", "log_w", "cdfp", "prob", "w_lf", "take",
    "widx", "vi_cnt", "tickets", "vi")
_INTS = ("C", "P", "S", "n", "p", "m", "B", "D", "R", "lik", "tuning", "tile",
         "ntiles", "y_stride", "Cg", "c0", "row0")


class _BignArgs(ctypes.Structure):
    """Field by field the ``BignArgs`` of csrc/bign.cu."""

    _fields_ = ([(name, _P) for name in _POINTERS]
                + [(name, _I) for name in _INTS]
                + [("lik_const", _F), ("decay", _F),
                   ("p_grow", _F * _MAX_DEPTH)])


def _lib():
    lib = _build.load("bign")
    fn = lib.pgbart_bign_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_BignArgs), _P, ctypes.POINTER(_I)]
        fn.restype = _I
        lib.pgbart_bign_gumbel_block.argtypes = [ctypes.POINTER(_BignArgs),
                                                 _P, _P]
        lib.pgbart_bign_gumbel_block.restype = _I
        lib.pgbart_bign_args_size.restype = _I
        lib.pgbart_bign_max_depth.restype = _I
        if lib.pgbart_bign_args_size() != ctypes.sizeof(_BignArgs):
            raise RuntimeError(
                "pgbart_step_bign: the argument block of csrc/bign.cu has "
                f"{lib.pgbart_bign_args_size()} bytes, the wrapper's "
                f"{ctypes.sizeof(_BignArgs)}")
        if lib.pgbart_bign_max_depth() != _MAX_DEPTH:
            raise RuntimeError("pgbart_step_bign: csrc/bign.cu covers "
                               f"{lib.pgbart_bign_max_depth()} levels, the "
                               f"wrapper {_MAX_DEPTH}")
    return lib


def launches_per_step(B: int, D: int) -> int:
    """CUDA kernels one call of the wrapper should enqueue, as csrc/bign.cu
    is designed: per tree 2 to set up, 3 a level (the node-space work
    between two row passes runs in the tail of the pass's last block), 2 to
    select and commit; 1 a step.  The launcher reports the kernels it did
    enqueue (the counter ``bign_launches``)."""
    return B * (4 + 3 * D) + 1


def _check(t, name, dtype, shape, dev):
    if (not isinstance(t, torch.Tensor) or t.device != dev
            or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"pgbart_step_bign: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)} on {dev}")


def _check_seed(seed, dev):
    _check(seed, "rands.seed", torch.int32, (2,), dev)
    return seed.data_ptr()


def _mul_hi_lo(const: int, x: torch.Tensor):
    """High and low 32-bit words of ``const * x`` for 32-bit values held in
    int64 tensors (the product itself would not fit 63 bits)."""
    t1, t2 = x * (const & 0xFFFF), x * (const >> 16)
    hi = (t2 + (t1 >> 16)) >> 16
    lo = (((t2 & 0xFFFF) << 16) + (t1 & 0xFFFFFFFF)) & 0xFFFFFFFF
    return hi, lo


def gumbel_streams(B: int, D: int, C: int, P: int, chains: Optional[int],
                   chain0: int, device) -> torch.Tensor:
    """int64 (B * D * C * P,): the generator's stream of each (tree, level,
    chain, particle) of a block for the ``C`` chains from ``chain0`` of
    ``chains`` (``csrc/common.cuh::gumbel_stream`` of the global chain)."""
    Cg = C if chains is None else chains
    i64 = torch.int64
    bd = torch.arange(B * D, dtype=i64, device=device)[:, None, None]
    c = torch.arange(C, dtype=i64, device=device)[None, :, None]
    pi = torch.arange(P, dtype=i64, device=device)[None, None, :]
    return (bd * (Cg * P) + (chain0 + c) * P + pi).reshape(-1)


def gumbel_block_plain(seed: torch.Tensor, *, B: int, C: int, P: int, D: int,
                       n: int, chains: Optional[int] = None, chain0: int = 0,
                       row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernels' generator (``csrc/common.cuh``):
    Philox-4x32-10 keyed by ``seed``, counter (row, stream of (tree, level,
    chain, particle)), the first output word's top 23 bits mapped to
    ``u = (k + 0.5) 2^-23`` and ``-log(-log(u))``.  The block of ``C`` chains
    from ``chain0`` of ``chains`` and of the rows from ``row0``: the values
    those chains and rows get in the block of all of them."""
    dev = seed.device
    i64 = torch.int64
    key = seed.to(i64) & 0xFFFFFFFF
    k0, k1 = key[0], key[1]
    c0 = torch.arange(row0, row0 + n, dtype=i64,
                      device=dev).expand(B * D * C * P, n)
    c1 = gumbel_streams(B, D, C, P, chains, chain0, dev)[:, None].expand(
        B * D * C * P, n)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(0xD2511F53, c0)
        hi1, lo1 = _mul_hi_lo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
        k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
    u = ((c0 >> 9).to(torch.float32) + 0.5) * 2.0**-23
    return (-torch.log(-torch.log(u))).reshape(B, D, C, P, n)


def gumbel_block(seed: torch.Tensor, *, B: int, C: int, P: int, D: int,
                 n: int, chains: Optional[int] = None, chain0: int = 0,
                 row0: int = 0) -> torch.Tensor:
    """The (B, D, C, P, n) row Gumbels the kernels generate from ``seed``
    (``StepRands.seed``: two int32 words): written out by the kernels' own
    generator for a seed on a CUDA device, by its plain version for one on
    the CPU (the same uniforms; the logarithms are each device's).  The
    chains are ``chain0 ... chain0 + C - 1`` of ``chains`` (default ``C``)
    and the rows ``row0 ... row0 + n - 1``: a rank of a mesh writes out its
    part of the block of all chains and rows."""
    if not (isinstance(seed, torch.Tensor) and seed.dtype == torch.int32
            and tuple(seed.shape) == (2,)):
        raise ValueError("gumbel_block: seed must be an int32 tensor of "
                         "shape (2,)")
    if not seed.is_cuda:
        return gumbel_block_plain(seed, B=B, C=C, P=P, D=D, n=n,
                                  chains=chains, chain0=chain0, row0=row0)
    device = seed.device
    out = torch.empty((B, D, C, P, n), dtype=torch.float32, device=device)
    a = _BignArgs()
    a.seed = _check_seed(seed, device)
    a.B, a.C, a.P, a.D, a.n = B, C, P, D, n
    a.Cg, a.c0, a.row0 = C if chains is None else chains, chain0, row0
    with torch.cuda.device(device):
        err = _lib().pgbart_bign_gumbel_block(ctypes.byref(a), out.data_ptr(),
                                              _build.current_stream())
    _build.check_launch(err, "pgbart_step_bign (gumbel_block)")
    return out


def pgbart_step_bign_kernel(state, rands, X, Y_target, cfg: BartConfig,
                            pg: PgbartConfig, w_chain, tuning: bool, *,
                            lik: str = "gauss", lik_const: float = 0.0,
                            llw=None):
    """Enqueue ``csrc/bign.cu`` on the current stream (no synchronisation).
    Raises on what the kernel does not take."""
    f = state.forest
    if not f.split_var.is_cuda:
        raise ValueError("pgbart_step_bign kernel needs CUDA tensors")
    dev = f.split_var.device
    C, m, S = f.split_var.shape
    n, p = X.shape
    P, D = pg.num_particles, cfg.max_depth
    B = pg.batch_size(m, tuning)
    R = max(pg.num_refinements, 1)
    Gtot, Gm, CP = 2**D - 1, 2 ** (D - 1), C * P
    rowll = lik in _ROWLL_LIKS
    reason = bign_unsupported_reason(cfg, pg, X, lik, True, True, False,
                                     chains=C)
    if reason is not None:
        raise ValueError(f"pgbart_step_bign: {reason}")
    if m != cfg.m or S != cfg.n_nodes:
        raise ValueError(f"pgbart_step_bign: the forest is ({m}, {S}), the "
                         f"configuration wants ({cfg.m}, {cfg.n_nodes})")
    if rands.rg is None and rands.seed is None:
        raise ValueError("pgbart_step_bign: rands holds neither the row "
                         "Gumbels (rg) nor a seed to generate them from")
    f32, i32 = torch.float32, torch.int32
    Y, y_stride = target_rows(Y_target, C, n)
    checks = [
        (f.split_var, "forest.split_var", i32, (C, m, S)),
        (f.split_val, "forest.split_val", f32, (C, m, S)),
        (f.leaf, "forest.leaf", f32, (C, m, S, 1)),
        (f.count, "forest.count", f32, (C, m, S)),
        (state.tree_pred, "tree_pred", f32, (C, m, n, 1)),
        (state.sum_trees, "sum_trees", f32, (C, n, 1)),
        (state.alpha_vec, "alpha_vec", f32, (C, p)),
        (state.leaf_sd, "leaf_sd", f32, (C, 1)),
        (state.wf_count, "wf_count", f32, (C,)),
        (state.wf_mean, "wf_mean", f32, (C, n, 1)),
        (state.wf_m2, "wf_m2", f32, (C, n, 1)),
        (state.batch_offset, "batch_offset", i32, (C,)),
        (state.iteration, "iteration", i32, (C,)),
        (X, "X", f32, (n, p)),
        (Y, "Y_target", f32, (C, n) if y_stride else (n,)),
        (rands.ug, "rands.ug", f32, (B, C, P, Gtot)),
        (rands.uv, "rands.uv", f32, (B, C, P, Gtot)),
        (rands.eps, "rands.eps", f32, (B, C, P, 1, 2 * Gtot)),
        (rands.ures, "rands.ures", f32, (B, D, C)),
        (rands.usel, "rands.usel", f32, (B, C)),
        (rands.epsr, "rands.epsr", f32, (B, C, R, 1, S)),
        (rands.uacc, "rands.uacc", f32, (B, C, R))]
    if rands.rg is not None:
        checks.append((rands.rg, "rands.rg", f32, (B, D, C, P, n)))
    if lik == "gauss":
        checks.append((w_chain, "w_chain", f32, (C,)))
    elif lik != "bernoulli":
        checks.append((llw, "llw", f32, (C, n)))
    for t, name, dt, shape in checks:
        _check(t, name, dt, shape, dev)

    lib = _lib()
    tile, ntiles = tiling(n)
    # scratch: one workspace per element size, carved by offset; the kernels
    # write every word before they read it
    n_i = 2 * CP * S * 2 + CP * Gm * 2 + 2 * CP * n + ntiles * CP * Gm \
        + 3 * CP + 3 * C + C * p
    n_f = (2 * CP * S * 5 + CP * Gm * 2 + (2 * CP * n if rowll else 0)
           + 2 * C * n + C * p + 3 * C + 5 * CP + C * S)
    n_d = CP * Gm + ntiles * (CP * Gm * 2 + 2 * CP + 3 * C)
    ws_i = torch.empty((n_i,), dtype=i32, device=dev)
    ws_f = torch.empty((n_f,), dtype=f32, device=dev)
    ws_d = torch.empty((n_d,), dtype=torch.float64, device=dev)
    vi = torch.empty((C, p), dtype=f32, device=dev)

    a = _BignArgs()
    ptr = torch.Tensor.data_ptr
    for name, t in (
            ("f_sv", f.split_var), ("f_sl", f.split_val), ("f_lf", f.leaf),
            ("f_ct", f.count), ("tree_pred", state.tree_pred),
            ("sum_trees", state.sum_trees), ("alpha_vec", state.alpha_vec),
            ("leaf_sd", state.leaf_sd), ("wf_count", state.wf_count),
            ("wf_mean", state.wf_mean), ("wf_m2", state.wf_m2),
            ("batch_offset", state.batch_offset),
            ("iteration", state.iteration), ("X", X), ("y", Y),
            ("ug", rands.ug), ("uv", rands.uv), ("eps", rands.eps),
            ("ures", rands.ures), ("usel", rands.usel), ("epsr", rands.epsr),
            ("uacc", rands.uacc), ("vi", vi)):
        setattr(a, name, ptr(t))
    a.rg = ptr(rands.rg) if rands.rg is not None else None
    a.w_chain = ptr(w_chain) if lik == "gauss" else None
    a.llw = ptr(llw) if lik not in ("gauss", "bernoulli") else None

    def carve(ws, size, fields):
        base, off = ptr(ws), 0
        for name, count in fields:
            setattr(a, name, base + size * off)
            off += count
        if off > ws.numel():
            raise RuntimeError("pgbart_step_bign: scratch workspace too small")

    carve(ws_i, 4, (("ns_sv", 2 * CP * S), ("ns_lm", 2 * CP * S),
                    ("lv_var", CP * Gm), ("lv_flags", CP * Gm),
                    ("li", 2 * CP * n), ("part_cnt", ntiles * CP * Gm),
                    ("take", CP), ("widx", C), ("vi_cnt", C * p),
                    ("tickets", 2 * C + CP)))
    carve(ws_f, 4, (("ns_sl", 2 * CP * S), ("ns_lf", 2 * CP * S),
                    ("ns_ct", 2 * CP * S), ("ns_rs", 2 * CP * S),
                    ("ns_rq", 2 * CP * S), ("lv_val", CP * Gm),
                    ("lv_raw", CP * Gm),
                    ("pred", 2 * CP * n if rowll else 0),
                    ("resid", C * n), ("noi", C * n), ("cdf", C * p),
                    ("root", 3 * C), ("ll", CP), ("ll_prev", CP),
                    ("log_w", CP), ("cdfp", CP), ("prob", CP),
                    ("w_lf", C * S)))
    carve(ws_d, 8, (("lv_best", CP * Gm), ("part_stat", ntiles * CP * Gm * 2),
                    ("part_ll", 2 * ntiles * CP), ("part_root", ntiles * C * 2),
                    ("part_sd", ntiles * C)))
    a.seed = _check_seed(rands.seed, dev) if rands.rg is None else None
    a.C, a.P, a.S, a.n, a.p, a.m, a.B, a.D, a.R = C, P, S, n, p, m, B, D, R
    a.lik, a.tuning = LIK_CODES[lik], int(bool(tuning))
    a.tile, a.ntiles, a.y_stride = tile, ntiles, y_stride
    a.Cg, a.c0 = rands.chains or C, rands.chain0
    a.lik_const, a.decay = float(lik_const), float(pg.split_prior_decay)
    for d in range(D):
        a.p_grow[d] = float(cfg.alpha * (1.0 + d) ** (-cfg.beta))

    launched = _I(0)
    with torch.cuda.device(dev):
        err = lib.pgbart_bign_launch(ctypes.byref(a), _build.current_stream(),
                                     ctypes.byref(launched))
    _build.check_launch(err, "pgbart_step_bign")
    tracing.count("bign_launches", launched.value)
    pgbart_step_bign.launches += 1
    return state, vi


def pgbart_step_bign(state, rands, X, Y_target, cfg: BartConfig,
                     pg: PgbartConfig, w_chain, tuning: bool, *,
                     lik: str = "gauss", lik_const: float = 0.0, llw=None,
                     impl: Optional[str] = None):
    """One whole PGBART step for all chains, in the large-n formulation.

    ``state``: ``PgbartState`` with a leading chain axis, updated in place;
    ``rands``: ``StepRands`` (``rg`` may be None on the kernel: the row
    Gumbels are then generated from ``rands.seed``); ``X`` (n, p) is shared
    by the chains, ``Y_target`` (n, 1) too or is (C, n, 1), one target a
    chain; ``w_chain`` (C,) is each
    chain's Gaussian precision (``"gauss"`` only); ``llw`` (C, n) the row data
    of ``"het_abs"`` / ``"het_exp"`` / ``"cat_logit"``.  Returns
    ``(state, variable_inclusion (C, p))``.  Runs the CUDA kernels for a
    state on a CUDA device and the plain version for one on the CPU; ``impl``
    forces ``"kernel"`` or ``"plain"``.  ``pgbart_step_bign.launches`` counts
    the wrapper's calls of the launcher, as the other wrappers count theirs.

    Under ``tracing.recording`` the call is the span ``bign_step`` and counts
    ``bign_launches``: the CUDA kernels the launcher reports it enqueued, 0
    on the plain version.
    """
    if impl is None:
        impl = "kernel" if state.forest.split_var.is_cuda else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    with tracing.span("bign_step"):
        if impl == "kernel":
            return pgbart_step_bign_kernel(state, rands, X, Y_target, cfg, pg,
                                           w_chain, tuning, lik=lik,
                                           lik_const=lik_const, llw=llw)
        reason = bign_unsupported_reason(cfg, pg, None, lik, True, True, False)
        if reason is not None:
            raise ValueError(f"pgbart_step_bign: {reason}")
        if lik == "gauss" and w_chain is None:
            raise ValueError("pgbart_step_bign: gauss needs w_chain (C,)")
        if lik in ("het_abs", "het_exp", "cat_logit") and llw is None:
            raise ValueError(f"pgbart_step_bign: {lik!r} needs its row data "
                             "llw (C, n)")
        if w_chain is None:
            w_chain = torch.zeros((state.sum_trees.shape[0],),
                                  dtype=torch.float32,
                                  device=state.sum_trees.device)
        out = pgbart_step_bign_plain(state, rands, X, Y_target, cfg, pg,
                                     w_chain, tuning, lik=lik,
                                     lik_const=lik_const, llw=llw)
        tracing.count("bign_launches", 0)
        return out


pgbart_step_bign.launches = 0
