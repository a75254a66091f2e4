"""``separate_trees`` in the port: the heteroscedastic and separate-trees
Categorical models, each output its own forest.

The likelihood-pattern detection (``_fused_likelihood(out=j)``) and the
Categorical growth target are held to the JAX package's on the same model
built in each DSL; the per-step row data and scale targets to the JAX
package's formulas (``pymc_bart_tpu/sampler/compound.py``, ``one_step``) on
the same NumPy inputs; a tiny port ``sample()`` of each model on the CPU
gives the JAX layout (posterior (chains, draws, k, n), a list of k
``PosteriorForests``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jax_logsumexp

import pymc_bart_tpu as jpmb
import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu.sampler import compound as jcompound
from pymc_bart_tpu_torch.ops.predict import forest_predict
from pymc_bart_tpu_torch.sampler import compound as tcompound
from pymc_bart_tpu_torch.utils.posterior import PosteriorForests

N = 60


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _het_data(seed=3, n=N):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    mu_true = 3 * np.sin(2 * X[:, 0])
    sd_true = 0.2 + 1.5 * (X[:, 1] > 0)
    return X, rng.normal(mu_true, sd_true).astype(np.float32), mu_true


def _cat_data(seed=4, n=N, k=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    X = np.stack([labels + rng.normal(0, 0.4, n), rng.uniform(size=n)],
                 axis=1).astype(np.float32)
    return X, labels.astype(np.float32)


SCALE_LINKS = {
    "abs_plus_c": lambda pmb, w: pmb.math.abs(w[1]) + 0.05,
    "c_plus_abs": lambda pmb, w: 0.3 + pmb.math.abs(w[1]),
    "abs": lambda pmb, w: pmb.math.abs(w[1]),
    "exp": lambda pmb, w: pmb.math.exp(w[1]),
}
SOFTMAX_FORMS = {
    "T_last_axis": lambda pmb, w: pmb.math.softmax(w.T, axis=-1),
    "T_default_axis": lambda pmb, w: pmb.math.softmax(w.T),
    "axis0_T": lambda pmb, w: pmb.math.softmax(w, axis=0).T,
    "deterministic": lambda pmb, w: pmb.Deterministic(
        "pr", pmb.math.softmax(w.T, axis=-1)),
}


def _het_model(pmb, link, X, Y):
    model = pmb.Model()
    with model:
        w = pmb.BART("w", X, Y, m=5, shape=(2, len(Y)), separate_trees=True)
        pmb.Normal("y", w[0], SCALE_LINKS[link](pmb, w), observed=Y)
    return model, w


def _cat_model(pmb, form, X, labels, k=3):
    model = pmb.Model()
    with model:
        w = pmb.BART("w", X, labels, m=5, shape=(k, len(labels)),
                     separate_trees=True)
        pmb.Categorical("y", p=SOFTMAX_FORMS[form](pmb, w), observed=labels)
    return model, w


def _kinds(compound, model, brv):
    return [None if f is None else (f["kind"], f.get("const", 0.0))
            for f in (compound._fused_likelihood(model, brv, out=j)
                      for j in range(brv.config.n_outputs))]


@pytest.mark.parametrize("link", sorted(SCALE_LINKS))
def test_scale_pattern_matches_jax(link):
    X, Y, _ = _het_data()
    got = _kinds(tcompound, *_het_model(tpmb, link, X, Y))
    want = _kinds(jcompound, *_het_model(jpmb, link, X, Y))
    assert got == want
    assert got[0] == ("gauss", 0.0) and got[1][0] in ("het_abs", "het_exp")


@pytest.mark.parametrize("form", sorted(SOFTMAX_FORMS))
def test_softmax_pattern_and_growth_target_match_jax(form):
    X, labels = _cat_data()
    t_model, t_w = _cat_model(tpmb, form, X, labels)
    j_model, j_w = _cat_model(jpmb, form, X, labels)
    got = _kinds(tcompound, t_model, t_w)
    assert got == _kinds(jcompound, j_model, j_w)
    assert got == [("cat_logit", 0.0)] * 3
    target = tcompound._bart_growth_target(t_model, t_w)
    if form != "deterministic":
        # (the JAX package does not look through the Deterministic and
        # centres those class forests on the raw labels: a reference fault
        # the port does not copy)
        np.testing.assert_array_equal(
            target, jcompound._bart_growth_target(j_model, j_w))
    np.testing.assert_array_equal(target, 4.0 * np.eye(3)[labels.astype(int)]
                                  - 2.0)


def test_patterns_that_have_no_closed_form_match_jax():
    """A scale link the kernels do not know, and a mean that reads its own
    output in sigma: no fused code in either package."""
    X, Y, _ = _het_data()
    for pkg in (tpmb, jpmb):
        with pkg.Model() as model:
            w = pkg.BART("w", X, Y, m=5, shape=(2, N), separate_trees=True)
            pkg.Normal("y", w[0], 2.0 * pkg.math.abs(w[1]), observed=Y)
        assert _kinds(tcompound if pkg is tpmb else jcompound, model,
                      w)[1] is None
        with pkg.Model() as model:
            w = pkg.BART("w", X, Y, m=5, shape=(2, N), separate_trees=True)
            pkg.Normal("y", w[0], pkg.math.abs(w[0]) + 1.0, observed=Y)
        assert _kinds(tcompound if pkg is tpmb else jcompound, model,
                      w)[0] is None


@pytest.mark.parametrize("kind, const", [("het_abs", 0.05), ("het_abs", 0.0),
                                         ("het_exp", 0.0)])
def test_scale_forest_row_data_and_target_match_jax_formulas(kind, const):
    rng = np.random.default_rng(8)
    y = rng.normal(size=N).astype(np.float32)
    mu0 = rng.normal(size=(3, N)).astype(np.float32)
    mu0[0, :5] = y[:5]                   # |y - mu0| = 0: the 1e-3 floor
    row, target = tcompound.scale_forest_data(
        kind, const, torch.from_numpy(y), torch.from_numpy(mu0))
    # the JAX package's one_step, one chain at a time
    for c in range(3):
        yj, mj = jnp.asarray(y), jnp.asarray(mu0[c])
        gauss_w = ((yj - mj) ** 2).reshape(N, 1)
        s_hat = (jnp.abs(yj - mj) / 0.7978845608).reshape(N, 1)
        want = (s_hat - const if kind == "het_abs"
                else jnp.log(jnp.maximum(s_hat, 1e-3)))
        np.testing.assert_allclose(row[c].numpy(), np.asarray(gauss_w),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(target[c].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # the initial target: scale evidence around the global mean
    s0 = np.abs(y - y.mean()) / 0.7978845608
    want0 = (s0 - const if kind == "het_abs"
             else np.log(np.maximum(s0, 1e-3)))
    np.testing.assert_allclose(tcompound._scale_target(kind, const, s0),
                               want0, rtol=1e-12)


def test_class_forest_row_data_matches_jax_formula():
    rng = np.random.default_rng(9)
    W = (3.0 * rng.normal(size=(2, N, 4))).astype(np.float32)
    for j in range(4):
        got = tcompound.class_forest_data(torch.from_numpy(W), j)
        for c in range(2):
            Wj = jnp.asarray(W[c])
            others = jnp.concatenate([Wj[:, :j], Wj[:, j + 1:]], axis=1)
            want = jax_logsumexp(others, axis=1).reshape(N, 1)
            np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def _check_layout(idata, w, k, draws, chains=2, m=5):
    post = idata.posterior["w"].values
    assert post.shape == (chains, draws, k, N)
    assert idata.posterior["w"].dims == ("chain", "draw", "w_dim_0",
                                         "w_dim_1")
    assert np.isfinite(post).all()
    trees = w.all_trees
    assert isinstance(trees, list) and len(trees) == k
    for j, pf in enumerate(trees):
        assert isinstance(pf, PosteriorForests)
        assert pf.n_outputs == 1 and pf.config.n_outputs == 1
        assert pf.split_var.shape == (chains, draws, m, pf.config.n_nodes)
        # the stored forests predict every draw of their output
        sv, sl, ss, lf, ct, sp = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (pf.split_var, pf.split_val,
                                            pf.split_set.view(np.int32),
                                            pf.leaf, pf.count, pf.slope))
        from pymc_bart_tpu_torch.ops.trees import Forest
        pred = forest_predict(Forest(sv, sl, ss, lf, ct, sp),
                              torch.from_numpy(pf.X_train),
                              torch.from_numpy(pf.rules), pf.config.max_depth)
        np.testing.assert_allclose(pred[..., 0].numpy(), post[:, :, j],
                                   rtol=1e-4, atol=1e-4)
    vi = idata["sample_stats"]["variable_inclusion"].values
    assert vi.shape == (chains, draws, 1, 2)
    recount = sum((pf.split_var[..., None] == np.arange(2)).sum(axis=(2, 3))
                  for pf in trees)
    np.testing.assert_array_equal(vi[:, :, 0], recount)


@pytest.mark.parametrize("link", ["abs_plus_c", "exp"])
def test_heteroscedastic_sample_on_the_cpu(link):
    X, Y, mu_true = _het_data()
    model, w = _het_model(tpmb, link, X, Y)
    with model:
        idata = tpmb.sample(tune=20, draws=20, chains=2, random_seed=1,
                            device="cpu", ancestor_sampling=True,
                            convergence_checks=False)
    _check_layout(idata, w, 2, 20)
    w_hat = idata.posterior["w"].values.mean(axis=(0, 1))
    assert np.corrcoef(w_hat[0], mu_true)[0, 1] > 0.8


def test_categorical_sample_on_the_cpu():
    X, labels = _cat_data()
    model, w = _cat_model(tpmb, "T_last_axis", X, labels)
    with model:
        idata = tpmb.sample(tune=20, draws=20, chains=2, random_seed=2,
                            device="cpu", convergence_checks=False)
    _check_layout(idata, w, 3, 20)
    lo_hat = idata.posterior["w"].values.mean(axis=(0, 1))
    assert (lo_hat.argmax(axis=0) == labels).mean() > 0.8


@pytest.mark.parametrize("route", ["fused", "bign"])
def test_a_target_per_chain_gives_each_chain_its_own_step(route):
    """A scale forest's growth target follows its chain's mean forest: a
    (C, n, 1) target.  Each chain of the batched step then takes exactly the
    step it takes alone with its own target and random numbers."""
    import dataclasses

    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    rng = np.random.default_rng(21)
    n, C = 80, 3
    X = torch.from_numpy(rng.uniform(size=(n, 2)).astype(np.float32))
    Yc = torch.from_numpy(rng.normal(size=(C, n, 1)).astype(np.float32))
    row = torch.from_numpy(rng.uniform(0.5, 2.0, (C, n, 1)).astype(
        np.float32))
    cfg = BartConfig(m=4, max_depth=3)
    pgc = PgbartConfig(num_particles=5, batch=(0.5, 0.5), num_refinements=0)
    rules = torch.zeros(2, dtype=torch.int32)
    state = pgbart.init_state(X, Yc[0], cfg, chains=C, device="cpu")
    rands = pgbart.draw_rands(torch.Generator().manual_seed(4), B=2, C=C,
                              P=5, D=3, n=n, k=1, S=cfg.n_nodes,
                              num_refinements=0, device="cpu")
    batched, _ = pgbart.pgbart_step(state.clone(), rands, X, Yc, rules, cfg,
                                    pgc, True, row, lik="het_abs",
                                    lik_const=0.05, route=route)

    def chain(obj, c, axis):
        return type(obj)(**{
            f.name: (v if not isinstance(v, torch.Tensor)
                     and not dataclasses.is_dataclass(v) else
                     chain(v, c, axis) if dataclasses.is_dataclass(v) else
                     v.narrow(axis(f.name), c, 1).contiguous())
            for f in dataclasses.fields(obj)
            for v in (getattr(obj, f.name),)})

    def rands_axis(name):
        return 2 if name in ("rg", "ures") else 1

    for c in range(C):
        alone, _ = pgbart.pgbart_step(
            chain(state, c, lambda _: 0), chain(rands, c, rands_axis), X,
            Yc[c:c + 1], rules, cfg, pgc, True, row[c:c + 1],
            lik="het_abs", lik_const=0.05, route=route)
        for f in dataclasses.fields(alone.forest):
            assert torch.equal(getattr(alone.forest, f.name)[0],
                               getattr(batched.forest, f.name)[c]), f.name
        assert torch.equal(alone.sum_trees[0], batched.sum_trees[c])
