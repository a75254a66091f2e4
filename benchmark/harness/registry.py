"""Finds a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and traffic mixes, and the metrics.  Each cell is
``workloads/<cell>.json``, each configuration ``configs/<config>.json``,
each traffic mix ``traffic/<traffic>.json``, each model (its builder, the
draws a fit keeps, the name of its check) ``models/<model>.py``, each data
generator (with its true function) and each model's check
``reference/<name>.py``, and each metric's reader ``metrics/<metric>.py``
(a function ``read(run)``), all under the benchmark's folder.  A cell,
configuration, mix, model or metric is added by adding its files."""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _module(path, name):
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


class Registry:
    """The benchmark's files in the checkout at ``root``."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / BENCH_DIR.name

    def spec(self):
        """``BENCHMARK.json``."""
        return load_json(self.root / "BENCHMARK.json")

    def _named(self, kind, name, suffix):
        path = self.bench_dir / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} "
                                    "is missing")
        return path

    def cell(self, name):
        """The cell ``name`` with its configuration and traffic mix
        resolved: ``{"name", "config": {...}, "traffic": {...}, "chips",
        ...}``.  Where ``BENCHMARK.json`` lists the cell, its configuration,
        traffic and chips have to be the cell file's."""
        c = load_json(self._named("workloads", name, ".json"))
        c["name"] = name
        entry = next((w for w in self.spec()["workloads"]
                      if w["name"] == name), None)
        if entry is not None:
            for key in ("config", "traffic", "chips"):
                if entry[key] != c[key]:
                    raise ValueError(f"cell {name!r}: BENCHMARK.json gives "
                                     f"{key}={entry[key]!r}, its file "
                                     f"{c[key]!r}")
        cfg = load_json(self._named("configs", c["config"], ".json"))
        cfg["name"] = c["config"]
        traffic = load_json(self._named("traffic", c["traffic"], ".json"))
        traffic["name"] = c["traffic"]
        return dict(c, config=cfg, traffic=traffic)

    def metric_reader(self, name):
        """The ``read(run)`` function of the metric ``name``."""
        path = self._named("metrics", name, ".py")
        return _module(path, f"_bench_metric_{name.replace('.', '_')}").read

    def model(self, name):
        """The model ``models/<name>.py``: ``build(pmb, config, X, Y)`` ->
        ``(model, bart_rv)``, ``DRAWS`` (the posterior variables a fit
        keeps) and ``CHECK`` (the name of its check in ``reference/``)."""
        return _module(self._named("models", name, ".py"),
                       f"_bench_model_{name}")

    def reference(self, name):
        """The plain NumPy module ``reference/<name>.py``: a data generator
        (``generate``, ``true_f``) or a model's check (``numbers(out, data,
        kw, sizes, rng)``).  It loads as a module of the reference package,
        so it may import its siblings (``from . import forest``)."""
        return _module(self._named("reference", name, ".py"),
                       f"{BENCH_DIR.name}.reference.{name}")

    def metrics_of(self, cell_name, trace):
        """``[(name, unit)]`` the cell reports: the end-to-end metrics with
        ``trace`` 0, the per-layer ones with 1, each where its
        ``workloads`` names the cell or it has none."""
        spec_ = self.spec()
        group = spec_["per_layer"] if trace else spec_["end_to_end"]
        return [(m["name"], m["unit"]) for m in group
                if cell_name in m.get("workloads", [cell_name])]
