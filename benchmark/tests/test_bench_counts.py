"""The work counts of the yardstick on shapes counted by hand."""

import pytest

from benchmark.counts import pgbart
from benchmark.harness.peaks import peak_of


def test_tree_update_on_hand_shapes():
    # C=1, P=2, n=10, p=1, m=1, D=1 (S=3, G=1), R=0
    flops, nbytes = pgbart.tree_update(1, 2, 10, 1, 1, 1, 0)
    assert flops == 1 * 2 * 10 * 7 + 2 * 10 * 5 == 240
    # node arrays 2*6*3, prediction row 2*10, the particles' numbers 2*1*5,
    # resampling D=1, selection 1, one refinement's noise S=3 and its draw
    assert nbytes == 4 * (36 + 20 + 10 + 1 + 1 + 3 + 1)


def test_step_counts_on_hand_shapes():
    assert pgbart.batch_trees(50, 0.1) == 5 and pgbart.batch_trees(20, 0.1) == 2
    assert pgbart.batch_trees(5, 0.1) == 1
    f1, b1 = pgbart.tree_update(2, 3, 8, 4, 10, 2, 1)
    flops, nbytes = pgbart.pgbart_tree_updates(2, 3, 8, 4, 10, 2, 1, 0.2)
    assert flops == 2 * f1
    assert nbytes == 2 * b1 + pgbart.step_shared_bytes(2, 8, 4, 10, 2)
    assert pgbart.step_shared_bytes(2, 8, 4, 10, 2) == 4 * (
        32 + 8 + 16 + 32 + 2 * 10 * 7 + 16 + 2)
    assert pgbart.rejuvenation_move(2, 8, 2) == 2 * 8 * 17
    assert pgbart.draw_step_flops(2, 3, 8, 4, 10, 2, 1, 0.2, 10) == (
        flops + 10 * 2 * 8 * 17)


def test_floor_of_the_n1000_step_is_byte_bound():
    # chip_smoke.py's bound of the whole-step kernel at the same shapes:
    # 0.000308 ms, by the bytes
    peak = peak_of("NVIDIA H100 80GB HBM3")
    flops, nbytes = pgbart.pgbart_tree_updates(4, 20, 1000, 10, 50, 6, 5, 0.1)
    assert nbytes / peak["hbm_bytes_per_s"] > flops / peak["fp32_flops"]
    assert pgbart.floor_seconds(flops, nbytes, peak) * 1e3 == pytest.approx(
        0.000308, rel=0.01)
    assert peak_of("a card the table does not list") is None
