"""Minimal lazy expression graph for model definitions (PyTorch).

Counterpart of ``pymc_bart_tpu/models/expr.py``: enough symbolic structure
for the model idioms ``Normal("y", mu, sigma, observed=Y)``, ``w[0]``,
``math.abs(w[1])``, ``math.softmax(lo.T, axis=-1)``, evaluated with torch
ops inside the sampler.  An expression is evaluated per chain; the sampler
batches chains with ``torch.func.vmap``.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict

import numpy as np
import torch


def _transpose(x):
    return x.transpose(-1, -2) if x.dim() > 1 else x


class Expr:
    """Base of all lazy nodes; overloads arithmetic to build the graph."""

    def __add__(self, other):
        return Op(operator.add, self, other)

    def __radd__(self, other):
        return Op(operator.add, other, self)

    def __sub__(self, other):
        return Op(operator.sub, self, other)

    def __rsub__(self, other):
        return Op(operator.sub, other, self)

    def __mul__(self, other):
        return Op(operator.mul, self, other)

    def __rmul__(self, other):
        return Op(operator.mul, other, self)

    def __truediv__(self, other):
        return Op(operator.truediv, self, other)

    def __rtruediv__(self, other):
        return Op(operator.truediv, other, self)

    def __pow__(self, other):
        return Op(operator.pow, self, other)

    def __neg__(self):
        return Op(operator.neg, self)

    def __abs__(self):
        return Op(torch.abs, self)

    def __getitem__(self, key):
        op = Op(lambda x: x[key], self)
        op.tag = ("getitem", key)  # structured form for pattern matching
        return op

    @property
    def T(self):
        op = Op(_transpose, self)
        op.tag = ("transpose",)
        return op

    def exp(self):
        return Op(torch.exp, self)

    def log(self):
        return Op(torch.log, self)


class Const(Expr):
    def __init__(self, value):
        self.value = value


class Op(Expr):
    def __init__(self, fn: Callable, *args, **kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.tag = None  # optional structured description (e.g. getitem)


def _env_device(env: Dict[str, Any]):
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def evaluate(x: Any, env: Dict[str, Any]):
    """Evaluate an expression (or plain value) against ``env``.

    ``env`` maps RV/Data names to tensors.  Named leaves (FreeRV / BARTRV /
    Data / Deterministic) are looked up by name; NumPy arrays and lists
    become float32 tensors on the device of the environment's tensors;
    Python scalars stay scalars.
    """
    if isinstance(x, Op):
        args = [evaluate(a, env) for a in x.args]
        return x.fn(*args, **x.kwargs)
    if isinstance(x, Const):
        return evaluate(x.value, env)
    if isinstance(x, Expr):
        name = getattr(x, "name", None)
        if name is None or name not in env:
            raise KeyError(f"expression leaf {name!r} not found in environment")
        return env[name]
    if isinstance(x, (np.ndarray, np.generic, list, tuple)):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=_env_device(env))
    return x


# ---------------------------------------------------------------------------
# math namespace (mirrors the pm.math idioms used by the reference tests)
# ---------------------------------------------------------------------------


def _tensor_args(args):
    return [torch.as_tensor(a, dtype=torch.float32)
            if isinstance(a, (np.ndarray, np.generic, list, tuple, int, float))
            else a for a in args]


def _lift(fn):
    def wrapper(*args, **kwargs):
        if any(isinstance(a, Expr) for a in args):
            return Op(fn, *args, **kwargs)
        return fn(*_tensor_args(args), **kwargs)

    return wrapper


def _softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def _logsumexp(x, axis=-1, keepdims=False):
    return torch.logsumexp(x, dim=axis, keepdim=keepdims)


def _sum(x, axis=None, keepdims=False):
    return x.sum() if axis is None else x.sum(dim=axis, keepdim=keepdims)


def _mean(x, axis=None, keepdims=False):
    return x.mean() if axis is None else x.mean(dim=axis, keepdim=keepdims)


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _binary(fn):
    def wrapped(a, b):
        a, b = (torch.as_tensor(v, dtype=torch.float32)
                if not isinstance(v, torch.Tensor) else v for v in (a, b))
        return fn(a, b)
    return wrapped


class math:  # noqa: N801 — namespace, mirrors pm.math
    exp = _lift(torch.exp)
    log = _lift(torch.log)
    sqrt = _lift(torch.sqrt)
    abs = _lift(torch.abs)
    tanh = _lift(torch.tanh)
    sigmoid = _lift(torch.sigmoid)
    invlogit = _lift(torch.sigmoid)
    softmax = _lift(_softmax)
    logsumexp = _lift(_logsumexp)
    floor = _lift(torch.floor)
    clip = _lift(_clip)
    maximum = _lift(_binary(torch.maximum))
    minimum = _lift(_binary(torch.minimum))
    sum = _lift(_sum)
    mean = _lift(_mean)
    where = _lift(torch.where)
    dot = _lift(torch.matmul)
    constant = staticmethod(lambda x: Const(np.asarray(x, np.float32)))
