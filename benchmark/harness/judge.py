"""Holds the fits of a window to the reference (``reference/check.py``):
every fit is an answer, and each number compared is the worst over them."""

import numpy as np

from ..reference import check
from .fits import derive

NUMBERS = ("structure_errors", "mu_gap", "sigma_gap", "rmse_f")


def judge(outputs, data, cell, kw, seed):
    """``(numbers, failed)``: each number's worst reading over the fits and
    its limit, ``{name: {"value", "limit"}}``, and the count of fits that
    fail a limit.  ``data`` holds the run's data sets ``(X, Y, f)``, each
    output names its own (``out["data"]``).  A fit whose outputs have the
    wrong shape reads no other number and fails."""
    limits = cell["limits"]
    rng = np.random.default_rng(derive(seed, 2))
    per_fit = []
    for out in outputs:
        X, Y, f = data[out["data"]]
        n, p = X.shape
        nums = {"structure_errors": check.structure_errors(
            out, kw["chains"], kw["draws"], n, p)}
        if check.shape_errors(out, kw["chains"], kw["draws"], n) == 0:
            idx = check.sample_draws(rng, kw["chains"], kw["draws"],
                                     cell["check"]["draws_per_fit"])
            rows = check.sample_rows(rng, n, cell["check"]["rows_per_fit"])
            nums.update(check.fit_numbers(out, X, Y, f, idx, rows))
        per_fit.append(nums)
    numbers = {}
    for name in NUMBERS:
        vals = [nums[name] for nums in per_fit if name in nums]
        numbers[name] = {"value": max(vals) if vals else None,
                         "limit": limits[name]}
    failed = sum(
        any(nums.get(k) is None or nums[k] > limits[k] for k in NUMBERS)
        for nums in per_fit)
    return numbers, failed


def lines(numbers):
    """One line a number, for the end of standard error."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in numbers.items()]
