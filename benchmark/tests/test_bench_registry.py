"""The harness finds every file by name, and picks up added files."""

import json
import re

from conftest import ROOT, add_cell, copy_benchmark

from benchmark.harness.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_named_file_is_found():
    reg = Registry(ROOT)
    spec = reg.spec()
    for w in spec["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        check = reg.reference(reg.model(cell["config"]["model"]).CHECK)
        assert set(cell["limits"]) == set(check.NUMBERS)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert callable(reg.reference(cfg["generator"]).generate)
        model = reg.model(cfg["model"])
        assert callable(model.build) and model.DRAWS
        check = reg.reference(model.CHECK)
        assert callable(check.numbers) and "structure_errors" in check.NUMBERS
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(reg.metric_reader(m["name"]))


def test_spec_keeps_to_the_contract():
    spec = Registry(ROOT).spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in spec["workloads"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(cells) // 4)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    assert "setup_s" in names
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert set(m.get("workloads", [])) <= cells


def test_an_added_cell_and_metric_are_picked_up(tmp_path):
    root = copy_benchmark(tmp_path)
    add_cell(root, "dummy.fit", "dummy", "refit")
    (root / "benchmark" / "metrics" / "dummy_count.py").write_text(
        "def read(run):\n    return 7 * run.chips\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "dummy_count", "unit": "1",
                              "better": "lower", "source": "program_counter",
                              "layer": "compound step", "moves": "fit_s",
                              "workloads": ["dummy.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(root)
    cell = reg.cell("dummy.fit")
    assert cell["config"]["n"] == 200 and cell["traffic"]["name"] == "refit"
    assert ("dummy_count", "1") in reg.metrics_of("dummy.fit", 1)
    assert ("dummy_count", "1") not in reg.metrics_of(
        "friedman1_n1000.fit", 1)

    class Run:
        chips = 4
    assert reg.metric_reader("dummy_count")(Run()) == 28
