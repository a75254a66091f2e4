"""State carried across the NumPy boundary.

The port never sees a JAX type: tests build plain dicts of NumPy arrays from
the JAX package's objects (``np.asarray`` on each field) and these functions
turn them into the port's dataclasses and back.  Field names are those of
``pymc_bart_tpu/sampler/pgbart.py::PgbartState``,
``pymc_bart_tpu/ops/trees.py::Forest`` and
``pymc_bart_tpu/sampler/hmc.py::HmcState``.  The JAX objects hold ONE chain;
the port's hold all chains on a leading axis, which is added or stripped
here.  ``split_set`` crosses as ``uint32`` <-> ``int32`` bit patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Union

import numpy as np
import torch

from .ops.trees import Forest
from .sampler.hmc import HmcState
from .sampler.pgbart import PgbartState, StepRands

_FOREST_FIELDS = tuple(f.name for f in dataclasses.fields(Forest))
_INT_FIELDS = {"split_var": np.int32, "batch_offset": np.int32,
               "iteration": np.int32}

StateDict = Dict[str, np.ndarray]


def _bits_to_i32(a) -> np.ndarray:
    return np.array(a, dtype=np.uint32, order="C", copy=True).view(np.int32)


def _to_tensor(name: str, a, device) -> torch.Tensor:
    if name == "split_set":
        arr = _bits_to_i32(a)
    else:
        arr = np.asarray(a, _INT_FIELDS.get(name, np.float32))
    # a writable C-ordered copy (np.array keeps 0-d arrays 0-d)
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)


def _stack(dicts: Sequence[StateDict], name: str, device) -> torch.Tensor:
    return torch.stack([_to_tensor(name, d[name], device) for d in dicts])


def state_from_numpy(d: Union[StateDict, Sequence[StateDict]], device,
                     kind: str = "pgbart"):
    """Dict(s) of NumPy arrays -> ``PgbartState`` / ``Forest`` / ``HmcState``.

    ``d`` is one chain's dict (a chain axis of length 1 is added) or a
    sequence of them, one per chain.  A ``pgbart`` dict holds the forest
    fields flat beside the others (``split_var`` ... ``slope``).
    """
    dicts = [d] if isinstance(d, dict) else list(d)
    device = torch.device(device)
    if kind == "forest":
        return Forest(*(_stack(dicts, n, device) for n in _FOREST_FIELDS))
    if kind == "hmc":
        return HmcState(**{f.name: _stack(dicts, f.name, device)
                           for f in dataclasses.fields(HmcState)})
    if kind != "pgbart":
        raise ValueError(f"unknown kind {kind!r}")
    rest = {f.name: _stack(dicts, f.name, device)
            for f in dataclasses.fields(PgbartState) if f.name != "forest"}
    return PgbartState(forest=state_from_numpy(dicts, device, "forest"),
                       **rest)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name == "split_set" else a


def state_to_numpy(state, chain: Union[int, None] = None) -> StateDict:
    """The inverse of ``state_from_numpy``: a flat dict of NumPy arrays, with
    the chain axis kept (``chain=None``) or one chain sliced out."""
    out: StateDict = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, Forest):
            out.update(state_to_numpy(v, chain))
        else:
            a = _to_numpy(f.name, v)
            out[f.name] = a if chain is None else a[chain]
    return out


def rands_from_numpy(per_chain: Sequence[Sequence[np.ndarray]],
                     device) -> StepRands:
    """Random blocks of one step, one 9-tuple per chain in the layout of
    ``draw_pallas._rands_reference``:
    ``(ug (B,P,Gtot), uv, rg (B,D,P,n), eps (B,P,2Gtot,k), sb uint32 (B,P,Gtot),
    ures (B,D), usel (B,), epsr (B,R,k,S), uacc (B,R))`` -> ``StepRands``
    (tree axis first, chain axis second, ``eps`` K-major).  ``rg`` may be
    ``None`` (the large-n route then generates the row Gumbels itself).  An
    11-tuple adds the blocks of the linear and mix responses, ``umix``
    (B,P,2Gtot) and ``gsel`` (B,P)."""
    device = torch.device(device)

    def stack(i, axis, bits=False, perm=None):
        arrs = []
        for chain in per_chain:
            a = np.asarray(chain[i])
            a = _bits_to_i32(a) if bits else a.astype(np.float32)
            arrs.append(a if perm is None else a.transpose(perm))
        return torch.from_numpy(
            np.ascontiguousarray(np.stack(arrs, axis=axis))).to(device)

    no_rg = any(chain[2] is None for chain in per_chain)
    linear = len(per_chain[0]) == 11
    return StepRands(
        ug=stack(0, 1), uv=stack(1, 1), rg=None if no_rg else stack(2, 2),
        eps=stack(3, 1, perm=(0, 1, 3, 2)), sb=stack(4, 1, bits=True),
        ures=stack(5, 2), usel=stack(6, 1), epsr=stack(7, 1),
        uacc=stack(8, 1), umix=stack(9, 1) if linear else None,
        gsel=stack(10, 1) if linear else None)
