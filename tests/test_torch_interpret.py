"""The interpretability suite of the port (``utils/{stats,codec,interpret,
importance,plots}.py``, ``utils/posterior.py::predict_draw_indices`` with
exclusion masks)
against the JAX package's on the CPU.

Both sides see the same forests: NumPy-built trees (splits on the first
three of five covariates far more often than on the other two, counts from
routing the training rows) put into each package's ``PosteriorForests``, and
the same ``variable_inclusion``.  Both draw their indices from the same
NumPy seed: predictions agree to rtol 1e-5 and rankings exactly.  The
port's Savitzky-Golay filter is held to ``scipy.signal.savgol_filter``
(atol 1e-9), and every plot renders under the Agg backend with the same
curves as the JAX package's figure."""

import types

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.signal  # noqa: E402
import torch  # noqa: E402

from pymc_bart_tpu import utils as jutils  # noqa: E402
from pymc_bart_tpu.config import BartConfig as JBartConfig  # noqa: E402
from pymc_bart_tpu.models.inference_data import (  # noqa: E402
    DataArray as JDataArray, Dataset as JDataset,
    InferenceData as JInferenceData)
from pymc_bart_tpu.utils import interpret as jint  # noqa: E402
from pymc_bart_tpu.utils import plots as jplots  # noqa: E402
from pymc_bart_tpu.utils import posterior as jpost  # noqa: E402
from pymc_bart_tpu_torch import utils as tutils  # noqa: E402
from pymc_bart_tpu_torch.config import BartConfig  # noqa: E402
from pymc_bart_tpu_torch.models.inference_data import (  # noqa: E402
    DataArray, Dataset, InferenceData)
from pymc_bart_tpu_torch.utils import interpret as tint  # noqa: E402
from pymc_bart_tpu_torch.utils import plots as tplots  # noqa: E402
from pymc_bart_tpu_torch.utils import posterior as tpost  # noqa: E402

N, P_COLS, M, DEPTH, CHAINS, DRAWS = 40, 5, 6, 3, 2, 5
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _forest_arrays(X, k, seed):
    """(chains, draws, m, S[, k]) trees of depth <= DEPTH: each node splits
    with probability 0.6 (depth-limited) on a covariate drawn with weights
    (6, 5, 4, 1, 1), at the value of one of its training rows; counts by
    routing X; leaves N(0, 1) (the slope zero)."""
    rng = np.random.default_rng(seed)
    S = 2 ** (DEPTH + 1) - 1
    shape = (CHAINS, DRAWS, M, S)
    sv = np.full(shape, -1, np.int32)
    sl = np.zeros(shape, np.float32)
    ct = np.zeros(shape, np.float32)
    lf = rng.normal(0, 1, shape + (k,)).astype(np.float32)
    wts = np.array([6, 5, 4, 1, 1], float)
    for c in range(CHAINS):
        for d in range(DRAWS):
            for t in range(M):
                node = np.zeros(N, np.int64)
                ct[c, d, t, 0] = N
                for s in range(2 ** DEPTH - 1):
                    rows = node == s
                    if rows.sum() < 2 or rng.uniform() > 0.6:
                        continue
                    var = rng.choice(P_COLS, p=wts / wts.sum())
                    val = X[rng.choice(np.flatnonzero(rows)), var]
                    left = rows & (X[:, var] <= val)
                    if left.sum() in (0, rows.sum()):
                        continue
                    sv[c, d, t, s], sl[c, d, t, s] = var, val
                    node[left] = 2 * s + 1
                    node[rows & ~left] = 2 * s + 2
                    ct[c, d, t, 2 * s + 1] = left.sum()
                    ct[c, d, t, 2 * s + 2] = (rows & ~left).sum()
    return dict(split_var=sv, split_val=sl,
                split_set=np.zeros(shape, np.uint32), leaf=lf, count=ct,
                slope=np.zeros_like(lf))


def _stores(fields, X, k):
    cfg = dict(m=M, max_depth=DEPTH, n_outputs=k)
    rules = np.zeros(P_COLS, np.int32)
    return (tpost.PosteriorForests(**fields, config=BartConfig(**cfg),
                                   rules=rules, X_train=X),
            jpost.PosteriorForests(**fields, config=JBartConfig(**cfg),
                                   rules=rules, X_train=X))


@pytest.fixture(scope="module")
def world():
    """Covariates, one store (k=1) in each package, a separate-trees list
    of two stores in each, and InferenceData with the stores' inclusion."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (N, P_COLS)).astype(np.float32)
    fields = _forest_arrays(X, 1, 1)
    t_one, j_one = _stores(fields, X, 1)
    t_two, j_two = zip(*(_stores(_forest_arrays(X, 1, s), X, 1)
                         for s in (2, 3)))
    sv = fields["split_var"]
    vi = np.stack([(sv == j).sum(axis=(2, 3)) for j in range(P_COLS)],
                  -1)[:, :, None, :].astype(np.int64)     # (c, d, 1, p)
    dims = ["chain", "draw", "variable_inclusion_dim_0",
            "variable_inclusion_dim_1"]
    tid = InferenceData(sample_stats=Dataset(
        {"variable_inclusion": DataArray(vi, dims)}))
    jid = JInferenceData(sample_stats=JDataset(
        {"variable_inclusion": JDataArray(vi, dims)}))
    return dict(X=X.astype(np.float64), t=t_one, j=j_one, t2=list(t_two),
                j2=list(j_two), tid=tid, jid=jid)


def _rv(store, name="mu"):
    shape = (N,) if not isinstance(store, list) else (len(store), N)
    cfg = (store[0] if isinstance(store, list) else store).config
    return types.SimpleNamespace(all_trees=store, name=name, shape=shape,
                                 config=cfg)


def test_hdi_pearsonr2_and_codec_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(300, 3, 2))
    for prob in (0.5, 0.94):
        np.testing.assert_allclose(tutils.hdi(a, prob, axis=0),
                                   jutils.hdi(a, prob, axis=0))
    np.testing.assert_allclose(tutils.hdi(a), jutils.hdi(a))
    b = a + rng.normal(size=a.shape)
    assert tutils.pearsonr2(a, b) == jutils.pearsonr2(a, b)
    assert tutils.pearsonr2(np.ones(4), b[:4, 0, 0]) == 0.0
    vec = [0, 1, 127, 128, 300, 2**20 + 5]
    code = tutils.encode_vi(vec)
    assert code == jutils.encode_vi(vec)
    assert tutils.decode_vi(code, len(vec)) == vec
    assert tutils._decode_vi(code, 3) == jutils._decode_vi(code, 3)
    with pytest.raises(ValueError):
        tutils.encode_vi([-1])


@pytest.mark.parametrize("strategy, spec", [
    ("insample", None), ("linear", None), ("linear", 7), ("quantiles", None),
    ("quantiles", [0.1, 0.5, 0.9])])
def test_evaluation_grid_matches_jax(world, strategy, spec):
    X = world["X"].copy()
    X[2, 1] = np.nan
    np.testing.assert_array_equal(tint.evaluation_grid(X, strategy, spec),
                                  jint.evaluation_grid(X, strategy, spec))


def test_multimask_matches_jax(world):
    masks = np.ones((4, P_COLS), bool)
    masks[np.arange(4), [0, 1, 2, 4]] = False
    masks[3] = False                                     # nothing excluded
    idx = np.random.default_rng(2).integers(0, CHAINS * DRAWS, 7)
    got = tpost.predict_draw_indices(world["t"], world["X"], idx,
                                     masks=masks, **CPU)
    want = jpost.predict_draw_indices_multimask(world["j"], world["X"], idx,
                                                masks)
    assert got.shape == (4, 7, N, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # one pass a mask and draw chunk: the same numbers as one big pass
    old = tpost._PASS_ELEMENTS
    try:
        tpost._PASS_ELEMENTS = 1
        small = tpost.predict_draw_indices(
            world["t"], world["X"], idx, masks=masks, **CPU)
    finally:
        tpost._PASS_ELEMENTS = old
    np.testing.assert_allclose(small, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("store", ["one", "list"])
def test_partial_dependence_matches_jax(world, store):
    t, j = (world["t"], world["j"]) if store == "one" else (world["t2"],
                                                            world["j2"])
    got = tint.partial_dependence(t, world["X"], [0, 2, 4], samples=9,
                                  rng=np.random.default_rng(5), **CPU)
    want = jint.partial_dependence(j, world["X"], [0, 2, 4], samples=9,
                                   rng=np.random.default_rng(5))
    for g, w in zip(got, want):
        assert g.var == w.var
        np.testing.assert_array_equal(g.xs, w.xs)
        np.testing.assert_allclose(g.curves, w.curves, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("centered", [False, True])
def test_ice_matches_jax(world, centered):
    got = tint.ice(world["t"], world["X"], [1, 3], instances=4, samples=5,
                   rng=np.random.default_rng(6), centered=centered, **CPU)
    want = jint.ice(world["j"], world["X"], [1, 3], instances=4, samples=5,
                    rng=np.random.default_rng(6), centered=centered)
    for g, w in zip(got, want):
        assert g.curves.shape == (4, N, 1)
        np.testing.assert_array_equal(g.xs, w.xs)
        np.testing.assert_allclose(g.curves, w.curves, rtol=1e-5, atol=1e-6)


def test_submodel_scorer_matches_jax(world):
    ts = tint.SubmodelScorer(world["t"], world["X"], 6,
                             np.random.default_rng(8), **CPU)
    js = jint.SubmodelScorer(world["j"], world["X"], 6,
                             np.random.default_rng(8))
    np.testing.assert_allclose(ts.full, js.full, rtol=1e-5, atol=1e-6)
    for kept in ([0], [0, 1, 2], [3, 4]):
        g, w = ts.score(kept), js.score(kept)
        np.testing.assert_allclose(g.preds, w.preds, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.r2, w.r2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["VI", "backward", "backward_VI"])
def test_variable_importance_matches_jax(world, method):
    kw = dict(method=method, samples=8, random_seed=9,
              fixed=2 if method == "backward_VI" else 0)
    got = tutils.compute_variable_importance(world["tid"], _rv(world["t"]),
                                             world["X"], **kw, **CPU)
    want = jutils.compute_variable_importance(world["jid"], _rv(world["j"]),
                                              world["X"], **kw)
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["r2_mean"], want["r2_mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["r2_hdi"], want["r2_hdi"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=1e-5,
                               atol=1e-6)
    if method == "VI":      # the trees split on the first three most often
        assert set(got["indices"][:3]) == {0, 1, 2}
    assert tutils.vi_to_kulprit(got) == jutils.vi_to_kulprit(want)


def test_inclusion_export_matches_jax(world):
    t = tutils.get_variable_inclusion(world["tid"], world["X"])
    j = jutils.get_variable_inclusion(world["jid"], world["X"])
    np.testing.assert_allclose(t[0], j[0])
    assert t[1] == j[1]
    assert (tutils.get_variable_inclusion(world["tid"], world["X"],
                                          to_kulprit=True)
            == jutils.get_variable_inclusion(world["jid"], world["X"],
                                             to_kulprit=True))
    enc = tutils.export_variable_inclusion(world["tid"], inplace=True)
    assert (enc == jutils.export_variable_inclusion(world["jid"])).all()
    assert "variable_inclusion_encoded" in world["tid"]["sample_stats"]


@pytest.mark.parametrize("window, order, shape", [
    (55, 2, (200,)), (55, 2, (200, 9)), (7, 3, (40, 2)), (5, 0, (12,)),
    (55, 4, (120,)), (55, 3, (80, 3)), (31, 4, (80, 3))])
def test_savgol_matches_scipy(window, order, shape):
    """Windows up to the default 55: beyond, SciPy's own coefficients lose
    digits (window 201, order 4: its centre value off by 8e-8 against a
    50-digit least-squares solution, the port's by less than 1e-14)."""
    x = np.random.default_rng(window + order).normal(size=shape).cumsum(0)
    got = tplots.savgol_filter(x, window_length=window, polyorder=order)
    want = scipy.signal.savgol_filter(x, window, order, axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    xt = np.ascontiguousarray(x.T) if x.ndim == 2 else x
    np.testing.assert_allclose(
        tplots.savgol_filter(xt, window, order, axis=-1),
        scipy.signal.savgol_filter(xt, window, order, axis=-1), atol=1e-9)
    with pytest.raises(ValueError):
        tplots.savgol_filter(x, window_length=window + 1, polyorder=order)


def _curves(axes):
    """Every line and filled band of each axes: their data points."""
    out = []
    for ax in np.ravel(axes):
        out += [ln.get_xydata() for ln in ax.get_lines()]
        out += [np.concatenate([p.vertices for p in c.get_paths()])
                for c in ax.collections]
    return out


def _same_figure(t_axes, j_axes):
    got, want = _curves(t_axes), _curves(j_axes)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    plt.close("all")


@pytest.mark.parametrize("smooth", [True, False])
def test_plot_pdp_and_ice_draw_jax_curves(world, smooth):
    kw = dict(samples=8, random_seed=3, smooth=smooth, var_discrete=[4])
    _same_figure(tplots.plot_pdp(_rv(world["t"]), world["X"], **kw, **CPU),
                 jplots.plot_pdp(_rv(world["j"]), world["X"], **kw))
    kw = dict(samples=4, instances=3, random_seed=4, smooth=smooth,
              var_idx=[0, 4], var_discrete=[4])
    _same_figure(tplots.plot_ice(_rv(world["t"]), world["X"], **kw, **CPU),
                 jplots.plot_ice(_rv(world["j"]), world["X"], **kw))
    kw = dict(samples=8, random_seed=3, smooth=smooth, var_idx=[1, 2],
              grid=(1, 2))
    _same_figure(tplots.plot_pdp(_rv(world["t2"]), world["X"], **kw, **CPU),
                 jplots.plot_pdp(_rv(world["j2"]), world["X"], **kw))


def test_importance_plots_draw_jax_curves(world):
    kw = dict(method="VI", samples=8, random_seed=9)
    t = tutils.compute_variable_importance(world["tid"], _rv(world["t"]),
                                           world["X"], **kw, **CPU)
    j = jutils.compute_variable_importance(world["jid"], _rv(world["j"]),
                                           world["X"], **kw)
    _same_figure(tutils.plot_variable_importance(t),
                 jutils.plot_variable_importance(j))
    _same_figure(tutils.plot_scatter_submodels(t, submodels=[0, 2]),
                 jutils.plot_scatter_submodels(j, submodels=[0, 2]))
    _same_figure(tutils.plot_variable_inclusion(world["tid"], world["X"]),
                 jutils.plot_variable_inclusion(world["jid"], world["X"]))
    with pytest.warns(FutureWarning):
        tutils.plot_convergence(world["tid"])
