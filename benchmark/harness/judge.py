"""Holds the fits of a window to the reference, the check of the cell's
model (``reference/<check>.py``): every fit is an answer, and each number
that the cell's ``limits`` name is the worst over them."""

import numpy as np

from .fits import derive


def judge(outputs, data, cell, kw, seed, check):
    """``(numbers, failed)``: each number's worst reading over the fits and
    its limit, ``{name: {"value", "limit"}}``, and the count of fits that
    fail a limit.  ``data`` holds the run's data sets ``(X, Y, f)``, each
    output names its own (``out["data"]``); ``check`` is the model's check,
    whose ``numbers`` reads one fit and whose ``NUMBERS`` names all it
    reads: the cell's ``limits`` have to give each of them a limit, and no
    other.  A fit that reads no value of a number fails."""
    limits = cell["limits"]
    if set(limits) != set(check.NUMBERS):
        raise ValueError(f"cell {cell['name']!r}: its limits name "
                         f"{sorted(limits)}, its model's check reads "
                         f"{sorted(check.NUMBERS)}")
    rng = np.random.default_rng(derive(seed, 2))
    per_fit = [check.numbers(out, data[out["data"]], kw, cell["check"], rng)
               for out in outputs]
    numbers = {}
    for name, limit in limits.items():
        vals = [nums[name] for nums in per_fit if name in nums]
        numbers[name] = {"value": max(vals) if vals else None,
                         "limit": limit}
    failed = sum(
        any(nums.get(k) is None or nums[k] > limits[k] for k in limits)
        for nums in per_fit)
    return numbers, failed


def lines(numbers):
    """One line a number, for the end of standard error."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in numbers.items()]
