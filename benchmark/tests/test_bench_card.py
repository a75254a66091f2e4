"""On the card, each cell at its own size: the program's fit passes the
check, and the control (the same fits with float16 draws) fails it on three
seeds.  Run with ``python -m pytest benchmark/tests -q -m card``."""

import json

import pytest

from conftest import ROOT

from benchmark.readings import readings

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _needs(card, name):
    import torch

    chips = [w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == name][0]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{name} needs {chips} cards")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_at_the_cells_size(card, name):
    _needs(card, name)
    (row,) = readings(name, [5100000001])
    assert row["correct"], row


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_float16_control_fails_at_the_cells_size(card, name):
    _needs(card, name)
    rows = readings(name, [5100000002, 5100000003, 5100000004], "float16")
    assert not any(r["correct"] for r in rows), rows
