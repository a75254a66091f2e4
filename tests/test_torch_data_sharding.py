"""Row ("data" axis) sharding of the port's PGBART step, over gloo ranks on
the CPU: the counterpart of ``tests/test_data_sharding.py``.

Two ranks split the rows unevenly (37 and 27 of 64: ``RowShard`` built by
hand, not by ``row_bounds``) and run, in one world:

* the growth round ``grow_round_plain(rows=...)`` on the inputs of a depth-2
  particle state (particle 0 replays stored splits), against the JAX
  package's ``_grow_round_const(..., data_axis="data")`` under ``shard_map``
  on the 8-device CPU mesh of ``tests/conftest.py``, same random blocks:
  tree structure, counts and row routing exact, leaf values and split
  values at rtol 1e-5 (the JAX sums are float, the port's fixed point);
* four tuning steps of ``pgbart_step`` in the node-space Gaussian mode, two
  of the Bernoulli code (row space: every sum reduced over the group) and a
  rejuvenation sweep, each against the unsharded run on the same state and
  random numbers: bit for bit (the integers are order-free and the float64
  partial sums round alike).

Without ranks, the node-space mode against the JAX package's ``suff_gauss``
formulation (``test_node_space_rounds_and_selection_match_jax``): its
rounds, node log-likelihood and selection on the same NumPy blocks.

The row Gumbels of the sharded step are keyed by the GLOBAL row (each rank
keeps its rows of the one block), where the JAX package folds the shard
index into the key: a deliberate difference that makes the sharded step
independent of the split; the bit-for-bit tests pin it.  Without ranks:
the node-space mode against the row-space per-round step
(``test_suffstats_unsharded_matches_rowspace``'s counterpart), split
variables equal, leaves and sums of trees at 2e-4.  All tensors are tiny:
one intra-op thread in every process.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

N, SPLIT = 64, 37          # rows, and the first row of rank 1
C, P_COLS, M, DEPTH, PARTICLES = 2, 3, 6, 4, 6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# inputs, made from NumPy seeds (the parent and the ranks make the same)
# ---------------------------------------------------------------------------

def _grow_case(seed=5, d=2, P=5, n=N, p=P_COLS):
    """A depth-``d`` particle state (the construction of
    tests/test_torch_grow.py) whose frozen particle 0 also holds stored
    splits at level ``d``, and one round's random blocks; NumPy, k = 1."""
    rng = np.random.default_rng(seed)
    S = 2 ** (DEPTH + 1) - 1
    G = 2**d
    X = rng.normal(size=(n, p)).astype(np.float32)
    resid = rng.normal(size=(n, 1)).astype(np.float32)
    sv = np.full((P, S), -1, np.int32)
    sl = np.zeros((P, S), np.float32)
    lf = rng.normal(size=(P, S, 1)).astype(np.float32)
    ct = np.zeros((P, S), np.float32)
    li = np.zeros((P, n), np.int32)
    for pi in range(P):
        ct[pi, 0] = n
        for lev in range(d + (pi == 0)):
            for node in range(2**lev - 1, 2 ** (lev + 1) - 1):
                rows = np.where(li[pi] == node)[0]
                if rows.size < 4 or (pi > 0 and rng.random() < 0.3):
                    continue
                var = int(rng.integers(0, p))
                val = float(np.median(X[rows, var]))
                goleft = X[rows, var] <= val
                sv[pi, node], sl[pi, node] = var, val
                if lev < d:
                    li[pi, rows[goleft]] = 2 * node + 1
                    li[pi, rows[~goleft]] = 2 * node + 2
                ct[pi, 2 * node + 1] = goleft.sum()
                ct[pi, 2 * node + 2] = (~goleft).sum()
    at = np.take_along_axis(lf[:, :, 0], li, axis=1)          # (P, n)
    return dict(
        d=d, X=X, resid=resid, sv=sv, sl=sl, lf=lf, ct=ct, li=li,
        pred=at[:, :, None].astype(np.float32),
        alpha_cdf=np.cumsum(rng.uniform(0.5, 2.0, size=p)).astype(np.float32),
        leaf_sd=np.full((1,), 0.3, np.float32),
        u_grow=(rng.random((P, G)) * 0.12).astype(np.float32),
        u_var=rng.random((P, G)).astype(np.float32),
        row_gum=rng.gumbel(size=(P, n)).astype(np.float32),
        eps=rng.normal(size=(P, 2 * G, 1)).astype(np.float32))


def _grow_torch(c, rows=None, part=slice(None)):
    """``grow_round_plain`` on case ``c`` (one chain), on the rows
    ``part`` with ``rows``; NumPy outputs ``(sv, sl, lf (P, S), ct,
    leaf_idx (P, n_part))``."""
    from pymc_bart_tpu_torch.config import BartConfig
    from pymc_bart_tpu_torch.ops.grow import grow_round_plain

    P, S = c["sv"].shape
    G = 2 ** c["d"]

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a))[None].to(dtype)

    i32 = torch.int32
    out = grow_round_plain(
        T(np.arange(P), i32), T((np.arange(P) == 0).astype(np.int32), i32),
        T(c["sv"], i32), T(c["sl"]), torch.zeros((1, P, S), dtype=i32),
        T(c["lf"].transpose(0, 2, 1)), T(c["ct"]),
        torch.zeros((1, P, 1, S)), T(c["li"][:, part], i32),
        T(c["pred"][:, part].transpose(0, 2, 1)),
        torch.from_numpy(np.ascontiguousarray(c["X"][part])),
        T(c["resid"][part].T), torch.zeros(P_COLS, dtype=i32),
        T(c["alpha_cdf"]), T(c["leaf_sd"]),
        torch.ones((1, 1, c["X"][part].shape[0])), T(c["u_grow"]),
        T(c["u_var"]), T(c["row_gum"][:, part]),
        T(c["eps"].transpose(0, 2, 1)), torch.zeros((1, P, G), dtype=i32),
        d=c["d"], cfg=BartConfig(m=5, max_depth=DEPTH), rows=rows)
    sv, sl, _st, lf, ct, _sp, li = (o[0].numpy() for o in out[:7])
    return sv, sl, lf[:, 0], ct, li


def _step_inputs(lik):
    """Data, a state grown by two unsharded steps and the configuration of
    the step tests (C chains, full rows)."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    rng = np.random.default_rng(7)
    X = rng.uniform(size=(N, P_COLS)).astype(np.float32)
    f = np.where(X[:, 0] > 0.5, 1.5, -1.5)
    if lik == "bernoulli":
        Y = (rng.random(N) < 1 / (1 + np.exp(-f))).astype(np.float32)
    else:
        Y = (f + 0.4 * rng.normal(size=N)).astype(np.float32)
    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5),
                      num_refinements=2)
    Xt = torch.from_numpy(X)
    Yt = torch.from_numpy(Y)[:, None]
    rules = torch.zeros(P_COLS, dtype=torch.int32)
    w = (torch.full((C, N, 1), 1.0 / 0.4**2) if lik == "gauss" else None)
    state = pgbart.init_state(Xt, Yt, cfg, chains=C, device="cpu")
    gen = torch.Generator().manual_seed(11)
    for _ in range(2):
        state, _ = pgbart.pgbart_step(
            state, _rands(gen, cfg, pg, True), Xt, Yt, rules, cfg, pg, True,
            w, lik=lik, w_scalar=w is not None)
    return dict(X=Xt, Y=Yt, rules=rules, w=w, cfg=cfg, pg=pg, state=state,
                gen=gen, lik=lik)


def _rands(gen, cfg, pg, tuning):
    from pymc_bart_tpu_torch.sampler import pgbart

    return pgbart.draw_rands(
        gen, B=pg.batch_size(cfg.m, tuning), C=C, P=pg.num_particles,
        D=cfg.max_depth, n=N, k=1, S=cfg.n_nodes,
        num_refinements=pg.num_refinements, device="cpu")


def _shard_state(state, part):
    from pymc_bart_tpu_torch.sampler.pgbart import PgbartState

    out = state.clone()
    for name, ax in PgbartState.ROW_AXES.items():
        setattr(out, name, getattr(out, name).narrow(
            ax, part.start, part.stop - part.start).contiguous())
    return out


def _run_steps(inp, steps, rows=None, part=None, **kw):
    """``steps`` tuning steps of the per-round route from the input state;
    with ``rows`` on the rows ``part``.  Returns the state's tensors as NumPy (forest fields
    prefixed ``forest.``)."""
    from pymc_bart_tpu_torch.sampler import pgbart

    state = inp["state"].clone()
    gen = torch.Generator()
    gen.set_state(inp["gen"].get_state())
    X, Y, w = inp["X"], inp["Y"], inp["w"]
    if rows is not None:
        state = _shard_state(state, part)
        X, Y = X[part].contiguous(), Y[part].contiguous()
        w = None if w is None else w[:, part].contiguous()
    for _ in range(steps):
        rands = _rands(gen, inp["cfg"], inp["pg"], True)
        if rows is not None:
            rands = rands.shard(slice(0, C), part)
        state, vi = pgbart.pgbart_step(
            state, rands, X, Y, inp["rules"], inp["cfg"], inp["pg"], True, w,
            lik=inp["lik"], w_scalar=w is not None, route="rounds",
            rows=rows, **kw)
    out = {f"forest.{f.name}": getattr(state.forest, f.name).numpy()
           for f in dataclasses.fields(state.forest)}
    out.update({f.name: getattr(state, f.name).numpy()
                for f in dataclasses.fields(state) if f.name != "forest"})
    out["vi"] = vi.numpy()
    return out


def _rejuvenate(inp, rows=None, part=None):
    """One rejuvenation sweep (every tree, every move kind) from the input
    state, on the rows ``part`` with ``rows``."""
    from pymc_bart_tpu_torch.config import PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart, rejuvenate

    state = inp["state"].clone()
    X, Y, w = inp["X"], inp["Y"], inp["w"]
    gen = torch.Generator().manual_seed(3)
    rj = rejuvenate.draw_rejuv_rands(gen, moves=M, C=C,
                                     S=inp["cfg"].n_nodes, n=N, k=1,
                                     device="cpu")
    if rows is not None:
        state = _shard_state(state, part)
        X, Y, w = X[part], Y[part], w[:, part]
        rj = rj.shard(slice(0, C), part)
    Yc = Y.reshape(1, -1, 1)
    rejuvenate.rejuvenate_forest(
        state, rj, X, Yc, inp["rules"], inp["cfg"],
        PgbartConfig(num_particles=PARTICLES, ancestor_sampling=True),
        pgbart.make_ll_of("gauss", 0.0, w, Yc, rows=rows), True, rows=rows)
    return {"sv": state.forest.split_var.numpy(),
            "sl": state.forest.split_val.numpy(),
            "lf": state.forest.leaf.numpy(), "ct": state.forest.count.numpy(),
            "sum_trees": state.sum_trees.numpy()}


# ---------------------------------------------------------------------------
# the world: two ranks, rows split 37 / 27
# ---------------------------------------------------------------------------

def _rank(rank, init_file, outdir, case_file):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pymc_bart_tpu_torch.parallel.mesh import (RowShard,
                                                   initialize_distributed)

    initialize_distributed(f"file://{init_file}", 2, rank, device="cpu")
    part = slice(0, SPLIT) if rank == 0 else slice(SPLIT, N)
    rows = RowShard(dist.group.WORLD, part.start, part.stop - part.start, N)
    with np.load(case_file) as z:
        case = dict(z)
        case["d"] = int(case["d"])
    out = {}
    for name, a in zip(("sv", "sl", "lf", "ct", "li"),
                       _grow_torch(case, rows, part)):
        out[f"grow/{name}"] = a
    for tag, lik, kw in (("node", "gauss", dict(suff_stats=True)),
                         ("bern", "bernoulli", {})):
        inp = _step_inputs(lik)
        for k_, v in _run_steps(inp, 4 if tag == "node" else 2, rows, part,
                                **kw).items():
            out[f"{tag}/{k_}"] = v
    for k_, v in _rejuvenate(_step_inputs("gauss"), rows, part).items():
        out[f"rejuv/{k_}"] = v
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from pymc_bart_tpu_torch.parallel.mesh import run_local_world

    d = tmp_path_factory.mktemp("data_world")
    case = _grow_case()
    np.savez(d / "case.npz", **case)
    run_local_world(_rank, 2, args=(str(d / "init"), str(d),
                                    str(d / "case.npz")), timeout=240)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return case, ranks


def _joined(ranks, prefix):
    """One rank's replicated arrays, the per-row ones joined over ranks."""
    from pymc_bart_tpu_torch.sampler.pgbart import PgbartState

    row_axes = {"grow/li": 1, **PgbartState.ROW_AXES}
    out = {}
    for k_ in ranks[0]:
        if not k_.startswith(prefix):
            continue
        name = k_[len(prefix):]
        ax = row_axes.get(name, row_axes.get(k_))
        if ax is None:
            np.testing.assert_array_equal(ranks[0][k_], ranks[1][k_],
                                          err_msg=f"{k_}: shards disagree")
            out[name] = ranks[0][k_]
        else:
            out[name] = np.concatenate([r[k_] for r in ranks], axis=ax)
    return out


def _assert_equal(want, got, tag):
    assert set(want) == set(got), tag
    for k_ in want:
        np.testing.assert_array_equal(want[k_], got[k_],
                                      err_msg=f"{tag}: {k_}")


def test_grow_round_sharded_matches_jax_data_axis(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as Ps

    from pymc_bart_tpu.config import BartConfig
    from pymc_bart_tpu.sampler.pgbart import _grow_round_const

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    c, ranks = world
    P, S = c["sv"].shape
    G = 2 ** c["d"]
    cfg = BartConfig(m=5, max_depth=DEPTH)
    J = jnp.asarray
    rands = {"u_grow": J(c["u_grow"]), "u_var": J(c["u_var"]),
             "row_gum": J(c["row_gum"]), "eps": J(c["eps"]),
             "set_bits": jnp.zeros((P, G), jnp.uint32),
             "u_mix": jnp.zeros((P, 2 * G), jnp.float32)}
    X = J(c["X"])

    def shard(rands_s, li_s, pred_s, X_s, resid_s):
        def one(r_, fz, a, b, st, lf, ct, li, pr):
            return _grow_round_const(
                r_, fz, a, b, st, lf, ct, li, pr, c["d"], X_s,
                jnp.isnan(X_s), jnp.zeros(P_COLS, jnp.int32),
                J(c["alpha_cdf"]), J(c["leaf_sd"]), resid_s, cfg,
                data_axis="data", all_cont=True, x_nan=False)
        return jax.vmap(one)(
            rands_s, jnp.arange(P) == 0, J(c["sv"]), J(c["sl"]),
            jnp.zeros((P, S), jnp.uint32), J(c["lf"]), J(c["ct"]), li_s,
            pred_s)

    row = Ps(None, "data")
    specs = {k_: (row if k_ == "row_gum" else Ps()) for k_ in rands}
    got_jax = jax.jit(jax.shard_map(
        shard, mesh=Mesh(np.array(jax.devices()[:8]), ("data",)),
        in_specs=(specs, row, row, Ps("data"), Ps("data")),
        out_specs=(Ps(), Ps(), Ps(), Ps(), Ps(), row, row),
        check_vma=False))(rands, J(c["li"]), J(c["pred"]), X, J(c["resid"]))
    sv, sl, _st, lf, ct, li, _pred = (np.asarray(a) for a in got_jax)

    port = _joined(ranks, "grow/")
    np.testing.assert_array_equal(port["sv"], sv)
    np.testing.assert_array_equal(port["ct"], ct)
    np.testing.assert_array_equal(port["li"], li)
    internal = sv >= 0
    np.testing.assert_allclose(port["sl"][internal], sl[internal], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port["lf"], lf[:, :, 0], rtol=1e-5, atol=1e-6)
    # some particle grew, and the frozen one replayed a stored split
    assert (sv >= 0).sum() > (c["sv"] >= 0).sum()
    lo, hi = 2 ** c["d"] - 1, 2 ** (c["d"] + 1) - 1
    assert (li[0] >= hi).any() and (c["sv"][0, lo:hi] >= 0).any()


def test_grow_round_sharded_equals_unsharded(world):
    c, ranks = world
    want = dict(zip(("sv", "sl", "lf", "ct", "li"), _grow_torch(c)))
    _assert_equal(want, _joined(ranks, "grow/"), "grow round")


def test_node_space_step_sharded_equals_unsharded(world):
    _c, ranks = world
    want = _run_steps(_step_inputs("gauss"), 4, suff_stats=True)
    got = _joined(ranks, "node/")
    _assert_equal(want, got, "node-space steps")
    # the adaptation ran: leaf_sd moved from its initial value
    first = _step_inputs("gauss")["state"].leaf_sd.numpy()
    assert not np.array_equal(got["leaf_sd"], first)


def test_bernoulli_row_sharded_equals_unsharded(world):
    _c, ranks = world
    _assert_equal(_run_steps(_step_inputs("bernoulli"), 2),
                  _joined(ranks, "bern/"), "bernoulli steps")


def test_rejuvenation_row_sharded_equals_unsharded(world):
    _c, ranks = world
    inp = _step_inputs("gauss")
    want = _rejuvenate(inp)
    got = _joined(ranks, "rejuv/")
    _assert_equal(want, got, "rejuvenation sweep")
    # the sweep changed some tree
    assert not np.array_equal(got["sv"], inp["state"].forest.split_var.numpy()) \
        or not np.array_equal(got["lf"], inp["state"].forest.leaf.numpy())


def _node_case(seed=9, P=5, n=N, p=P_COLS):
    """A stored tree of full depth (the frozen particle 0's), the residuals
    and the random blocks of the ``DEPTH`` growth rounds of one tree update;
    NumPy, k = 1."""
    rng = np.random.default_rng(seed)
    S = 2 ** (DEPTH + 1) - 1
    X = rng.normal(size=(n, p)).astype(np.float32)
    resid = (0.7 * rng.normal(size=(n, 1)) + X[:, :1]).astype(np.float32)
    sv = np.full(S, -1, np.int32)
    sl = np.zeros(S, np.float32)
    ct = np.zeros(S, np.float32)
    ct[0] = n
    node_of = np.zeros(n, np.int64)
    for node in range(2**DEPTH - 1):
        rows = np.where(node_of == node)[0]
        if rows.size < 4 or (node > 0 and rng.random() < 0.25):
            continue
        var = int(rng.integers(0, p))
        sv[node], sl[node] = var, float(np.median(X[rows, var]))
        goleft = X[rows, var] <= sl[node]
        node_of[rows[goleft]], node_of[rows[~goleft]] = 2 * node + 1, \
            2 * node + 2
        ct[2 * node + 1], ct[2 * node + 2] = goleft.sum(), (~goleft).sum()
    rounds = [dict(u_grow=(rng.random((P, 2**d)) * 0.12).astype(np.float32),
                   u_var=rng.random((P, 2**d)).astype(np.float32),
                   row_gum=rng.gumbel(size=(P, n)).astype(np.float32),
                   eps=rng.normal(size=(P, 2 ** (d + 1), 1)).astype(
                       np.float32))
              for d in range(DEPTH)]
    R = 3
    return dict(
        X=X, resid=resid, sv=sv, sl=sl, ct=ct, P=P, R=R, w=np.float32(2.5),
        lf=rng.normal(size=(S, 1)).astype(np.float32),
        alpha_cdf=np.cumsum(rng.uniform(0.5, 2.0, size=p)).astype(np.float32),
        leaf_sd=np.full((1,), 0.3, np.float32), rounds=rounds,
        # the frozen particle (the deepest tree) weighted up: its refinement
        # weighs several leaves against their prior centres
        log_w=(rng.normal(size=P) + 4.0 * (np.arange(P) == 0)).astype(
            np.float32),
        eps_r=(0.3 * 0.3 * rng.normal(size=(R, 1, S))).astype(np.float32),
        u_acc=rng.uniform(0.2, 1.0, size=R).astype(np.float32),
        u_sel=np.float32(rng.random()))


def test_node_space_rounds_and_selection_match_jax():
    """The node-space Gaussian mode against the JAX package's ``suff_gauss``
    formulation, one tree update from the root on the same NumPy blocks
    (the frozen particle 0 replays a stored tree of full depth):

    * every round of ``grow_round_plain(node_stats=...)`` against JAX's
      ``_grow_round_const(..., suff=...)``: tree structure, counts, row
      routing, node counts N and occupancy exact; split values, leaves and
      the node sums R (sum r) and Q (sum r^2) at rtol 1e-5 (JAX adds floats,
      the port fixed-point integers);
    * ``grow.node_ll`` of each round's statistics against the Gaussian
      log-likelihood of the depth-truncated prediction that JAX's row-space
      round (``suff=None``) carries, rtol 1e-5;
    * ``select.select_refine_nodes`` on the last round's statistics against
      JAX's winner-and-refinement kernel (``select_refine_pallas``, interpret
      mode) on the row-space particles, same weights and uniforms: structure
      exact, leaves and prediction at rtol 1e-4 (the tolerance of
      tests/test_torch_select.py)."""
    import jax.numpy as jnp

    from pymc_bart_tpu.config import BartConfig
    from pymc_bart_tpu.ops.select_pallas import select_refine_pallas
    from pymc_bart_tpu.sampler.pgbart import _grow_round_const
    from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
    from pymc_bart_tpu_torch.ops.grow import (fixed_moments,
                                              grow_round_plain, node_ll)
    from pymc_bart_tpu_torch.ops.select import select_refine_nodes
    from pymc_bart_tpu_torch.ops.sums import (FIXED_BITS, chain_exponent,
                                              from_fixed, pow2)

    c = _node_case()
    P, n, S = c["P"], N, 2 ** (DEPTH + 1) - 1
    cfg, tcfg = BartConfig(m=5, max_depth=DEPTH), TBartConfig(m=5,
                                                              max_depth=DEPTH)
    J = jnp.asarray
    X, resid = c["X"], c["resid"]
    root_mu = resid.sum() / n / cfg.m
    fresh = np.zeros((P - 1, S), np.float32)
    sv = np.concatenate([c["sv"][None], np.full((P - 1, S), -1, np.int32)])
    sl = np.concatenate([c["sl"][None], fresh])
    lf = np.concatenate([c["lf"][None], fresh[..., None]])
    lf[1:, 0, 0] = root_mu
    ct = np.concatenate([c["ct"][None], fresh])
    ct[1:, 0] = n
    frozen = np.arange(P) == 0

    # JAX: the node-space rounds and the row-space rounds side by side
    def jax_round(d, state, suff):
        r = c["rounds"][d]
        rands = {"u_grow": J(r["u_grow"]), "u_var": J(r["u_var"]),
                 "row_gum": J(r["row_gum"]), "eps": J(r["eps"]),
                 "set_bits": jnp.zeros((P, 2**d), jnp.uint32),
                 "u_mix": jnp.zeros((P, 2 ** (d + 1)), jnp.float32)}

        def one(r_, fz, a, b, st, lf_, ct_, li, pr, *sf):
            return _grow_round_const(
                r_, fz, a, b, st, lf_, ct_, li, pr, d, J(X), jnp.isnan(J(X)),
                jnp.zeros(P_COLS, jnp.int32), J(c["alpha_cdf"]),
                J(c["leaf_sd"]), J(resid), cfg, all_cont=True, x_nan=False,
                suff=sf or None)
        return [np.asarray(a) for a in jax.jit(jax.vmap(one))(
            rands, J(frozen), *(J(a) for a in state), *(J(a) for a in suff))]

    import jax

    pred0 = np.broadcast_to(lf[:, 0:1, :], (P, n, 1)).astype(np.float32)
    rowsp = [sv, sl, np.zeros((P, S), np.uint32), lf, ct,
             np.zeros((P, n), np.int32), pred0]
    node = list(rowsp)
    suff = [np.zeros((P, S), np.float32) for _ in range(3)] + [
        np.zeros((P, S), bool)]
    suff[0][:, 0] = n
    suff[1][:, 0] = resid.sum()
    suff[2][:, 0] = (resid * resid).sum()
    suff[3][:, 0] = True

    # the port, one chain
    def T(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))[None]
        return t if dtype is None else t.to(dtype)

    i32 = torch.int32
    residT = T(resid.T)
    e_r = chain_exponent(residT)
    q_r, q_q = fixed_moments(residT, e_r)
    stats = [torch.zeros((1, P, S)), torch.zeros((1, P, S), dtype=torch.int64),
             torch.zeros((1, P, S), dtype=torch.int64),
             torch.zeros((1, P, S), dtype=torch.bool)]
    stats[0][:, :, 0] = n
    stats[1][:, :, 0] = q_r.sum()
    stats[2][:, :, 0] = q_q.sum()
    stats[3][:, :, 0] = True
    t_sv, t_sl, t_lf, t_ct = (T(sv), T(sl), T(lf.transpose(0, 2, 1)), T(ct))
    t_st = torch.zeros((1, P, S), dtype=i32)
    t_li = torch.zeros((1, P, n), dtype=i32)
    w = torch.full((1, 1, n), float(c["w"]))
    unit_r, unit_q = pow2(e_r - FIXED_BITS), pow2(2 * e_r - FIXED_BITS)
    for d in range(DEPTH):
        node = jax_round(d, node, suff)
        node, suff = node[:7], node[7:]
        rowsp = jax_round(d, rowsp, ())
        r = c["rounds"][d]
        out = grow_round_plain(
            torch.arange(P, dtype=i32)[None], T(frozen, i32), t_sv, t_sl,
            t_st, t_lf, t_ct, torch.zeros((1, P, 1, S)), t_li, None,
            torch.from_numpy(X), residT, torch.zeros(P_COLS, dtype=i32),
            T(c["alpha_cdf"]), T(c["leaf_sd"]), w, T(r["u_grow"]),
            T(r["u_var"]), T(r["row_gum"]), T(r["eps"].transpose(0, 2, 1)),
            torch.zeros((1, P, 2**d), dtype=i32), d=d, cfg=tcfg,
            node_stats=tuple(stats))
        t_sv, t_sl, t_st, t_lf, t_ct, _sp, t_li, _pred, ll, stats = out
        stats = list(stats)
        tag = f"round {d}"
        for want, got, name in ((node[0], t_sv, "sv"), (node[4], t_ct, "ct"),
                                (node[5], t_li, "leaf_idx"),
                                (suff[0], stats[0], "N"),
                                (suff[3], stats[3], "occ")):
            np.testing.assert_array_equal(want, got[0].numpy(),
                                          err_msg=f"{tag}: {name}")
        for want_a, got_a in zip(rowsp[:6], node[:6]):
            np.testing.assert_array_equal(want_a, got_a, err_msg=tag)
        internal = node[0] >= 0
        np.testing.assert_allclose(t_sl[0].numpy()[internal],
                                   node[1][internal], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{tag}: split values")
        np.testing.assert_allclose(t_lf[0, :, 0].numpy(), node[3][:, :, 0],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{tag}: leaves")
        for want, unit, got, name in ((suff[1], unit_r, stats[1], "R"),
                                      (suff[2], unit_q, stats[2], "Q")):
            np.testing.assert_allclose(
                from_fixed(got, unit[:, None, None])[0].numpy(), want,
                rtol=1e-5, atol=1e-4, err_msg=f"{tag}: {name}")
        diff = resid[None] - rowsp[6]
        want_ll = -0.5 * c["w"] * (diff * diff).sum(axis=(1, 2))
        np.testing.assert_allclose(ll[0].numpy(), want_ll, rtol=1e-5,
                                   err_msg=f"{tag}: node_ll")
        np.testing.assert_allclose(
            node_ll(t_lf, *stats, torch.tensor([float(c["w"])]), e_r).numpy(),
            ll.numpy(), rtol=0, atol=0)
    # the rounds grew trees and the frozen particle replayed to full depth
    assert (node[0][1:] >= 0).sum() > 0
    assert (node[5][0] >= 2**DEPTH - 1).any()

    hiv = np.float32(0.5 / c["leaf_sd"][0] ** 2)
    want = [np.asarray(a) for a in select_refine_pallas(
        J(rowsp[0]), J(rowsp[1]), J(rowsp[2]),
        J(rowsp[3].transpose(0, 2, 1)), J(rowsp[4]), J(rowsp[5]),
        J(rowsp[6].transpose(0, 2, 1)), J(c["log_w"]), J(resid.T),
        jnp.full((1, n), c["w"]), J(c["eps_r"]), J(c["u_acc"]),
        J(c["u_sel"]), J(hiv), num_refinements=c["R"], m=cfg.m)]
    got = [a[0].numpy() for a in select_refine_nodes(
        t_sv, t_sl, t_st, t_lf, t_ct, t_li, tuple(stats), T(c["log_w"]),
        torch.tensor([float(c["w"])]), e_r, T(c["eps_r"]), T(c["u_acc"]),
        torch.tensor([c["u_sel"]]), torch.tensor([hiv]),
        num_refinements=c["R"], m=tcfg.m)]
    for i, name in ((0, "split_var"), (4, "count"), (5, "leaf_idx")):
        np.testing.assert_array_equal(want[i], got[i], err_msg=name)
    np.testing.assert_array_equal(want[2].view(np.int32), got[2])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(want[6], got[6], rtol=1e-4, atol=1e-5)
    # the winner's refinement moved some leaf
    widx = int(np.where((rowsp[0] == want[0]).all(axis=1))[0][0])
    assert not np.allclose(want[3][0], rowsp[3][widx, :, 0])


def test_suffstats_unsharded_matches_rowspace():
    """The node-space mode and the row-space per-round step take the same
    random numbers; their likelihoods are equal algebraically, so every SMC
    decision agrees: equal split variables, leaves and sums of trees at
    2e-4 after 15 steps (as the JAX package's test)."""
    inp = _step_inputs("gauss")
    node = _run_steps(inp, 15, suff_stats=True)
    rowspace = _run_steps(inp, 15, suff_stats=False)
    np.testing.assert_array_equal(node["forest.split_var"],
                                  rowspace["forest.split_var"])
    np.testing.assert_allclose(node["forest.leaf"], rowspace["forest.leaf"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(node["sum_trees"], rowspace["sum_trees"],
                               rtol=2e-4, atol=2e-4)
    y = inp["Y"].numpy()[:, 0]
    rmse0 = np.sqrt(np.mean((y - y.mean()) ** 2))
    rmse1 = np.sqrt(np.mean((node["sum_trees"][:, :, 0] - y) ** 2))
    assert rmse1 < 0.7 * rmse0, (rmse1, rmse0)


def test_node_space_gate():
    """The per-round route takes the node-space mode by itself under row
    sharding and on the plain route from NODE_SPACE_ROWS rows, never for a
    per-row precision, another code or response; forcing it there raises."""
    from pymc_bart_tpu_torch.config import BartConfig
    from pymc_bart_tpu_torch.sampler.pgbart import (NODE_SPACE_ROWS,
                                                    node_space_mode)

    cfg = BartConfig(m=M, max_depth=DEPTH)
    big = NODE_SPACE_ROWS
    assert node_space_mode(None, cfg, "gauss", True, big, True, None)
    assert not node_space_mode(None, cfg, "gauss", True, big - 1, True, None)
    assert not node_space_mode(None, cfg, "gauss", True, big, False, None)
    assert node_space_mode(None, cfg, "gauss", True, 10, False, object())
    assert not node_space_mode(None, cfg, "gauss", False, big, True, None)
    assert not node_space_mode(None, cfg, "bernoulli", False, big, True, None)
    lin = BartConfig(m=M, max_depth=DEPTH, response="linear")
    assert not node_space_mode(None, lin, "gauss", True, big, True, None)
    with pytest.raises(ValueError, match="node-space"):
        node_space_mode(True, cfg, "gauss", False, 10, True, None)
