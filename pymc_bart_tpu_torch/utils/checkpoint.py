"""Checkpoint / resume of sampler state (PyTorch).

Counterpart of ``pymc_bart_tpu/utils/checkpoint.py`` with its function
names.  The carry of ``sample()`` (every field of each forest entry's
``PgbartState``, every field of ``HmcState`` and the ``torch.Generator``'s
state, from which every random number of a step is drawn) is a flat dict of
named tensors, saved as one ``.npz`` of named arrays;
``sample(..., checkpoint_dir=...)`` writes one after every tuning and draw
chunk and ``resume=True`` continues from the latest.  Draw chunks are
``.npz`` files of named arrays too (no pickles).  Every file is written to a
temporary name first and moved into place with ``os.replace``.

The JAX package's checkpoints hold threefry keys, which no Philox generator
can continue: ``check_format`` refuses them by the package stamped in
``meta.json``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# Bump when the stored-state semantics change, not just shapes.  Version 1:
# the carry as named arrays (``sampler/compound.py::_carry``), hash-salted
# Subset split words as int32 bit patterns, the generator state as uint8.
FORMAT_VERSION = 1
PACKAGE = "pymc_bart_tpu_torch"


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _write_npz(path: str, arrays: Dict[str, Any]) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _to_numpy(v) for k, v in arrays.items()})
    os.replace(tmp, path)


def save_checkpoint(directory: str, state: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None,
                    step: int = 0) -> str:
    """Save a flat dict of named tensors / arrays as ``ckpt_<step>.npz`` and
    stamp ``meta.json``; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _write_npz(path, state)
    from .. import __version__

    _write_json(os.path.join(directory, "meta.json"),
                {"step": step, "format_version": FORMAT_VERSION,
                 "package": PACKAGE, "package_version": __version__,
                 **(meta or {})})
    return path


def load_meta(directory: str) -> Dict[str, Any]:
    """The meta.json written next to the checkpoints ({} if absent)."""
    path = os.path.join(directory, "meta.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def check_format(directory: str) -> None:
    """Refuse to resume from a checkpoint this package did not write in its
    current format: an unstamped one, another ``format_version``, or one
    stamped by another package (the JAX package's carry holds threefry
    keys)."""
    meta = load_meta(directory)
    found = meta.get("format_version")
    if found is None:
        raise ValueError(
            f"checkpoint in {directory!r} has no format stamp (meta.json "
            "missing or without format_version): its stored-state semantics "
            "are unknown, so it cannot be resumed")
    package = meta.get("package")
    if package != PACKAGE:
        writer = package or "the JAX package pymc_bart_tpu"
        raise ValueError(
            f"checkpoint in {directory!r} was written by {writer} "
            f"(format_version={found!r}, package "
            f"{meta.get('package_version', '<unknown>')}), not by "
            f"{PACKAGE}: its random state is a JAX threefry key, which a "
            "torch Philox generator cannot continue.  Restart the run.")
    if found != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint in {directory!r} has format_version={found!r} "
            f"(this build writes {FORMAT_VERSION}; package "
            f"{meta.get('package_version', '<unknown>')}): its stored-state "
            "semantics differ, so resuming would silently alter the "
            "sampler.  Restart the run.")


def latest_checkpoint(directory: str) -> Optional[Tuple[str, int]]:
    """``(path, step)`` of the checkpoint with the most steps, or None."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(
        f for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
        and not f.endswith(".tmp.npz"))
    if not ckpts:
        return None
    path = os.path.join(directory, ckpts[-1])
    return path, int(ckpts[-1][5:-4])


def save_draw_chunk(directory: str, step: int,
                    outs: Dict[str, Any]) -> str:
    """Persist one collected draw chunk (a flat dict of named host arrays)
    next to the state checkpoints, so ``resume=True`` keeps the draws
    already sampled instead of only the carry."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"draws_{step:08d}.npz")
    _write_npz(path, outs)
    return path


def load_draw_chunks(directory: str,
                     upto_step: Optional[int] = None) -> List[Dict[str, Any]]:
    """Draw chunks saved by ``save_draw_chunk``, in step order, each a dict
    of named NumPy arrays."""
    if not os.path.isdir(directory):
        return []
    out = []
    for fname in sorted(os.listdir(directory)):
        if not (fname.startswith("draws_") and fname.endswith(".npz")
                and not fname.endswith(".tmp.npz")):
            continue
        if upto_step is not None and int(fname[6:-4]) > upto_step:
            continue
        with np.load(os.path.join(directory, fname)) as data:
            out.append({k: data[k] for k in data.files})
    return out


def load_checkpoint(path: str,
                    like_state: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Restore a dict saved by ``save_checkpoint`` into tensors shaped, typed
    and placed as ``like_state``'s (each on its own tensor's device).  A
    missing or extra name, another shape or another dtype raises
    ``ValueError`` naming the array."""
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    missing = sorted(set(like_state) - set(saved))
    extra = sorted(set(saved) - set(like_state))
    if missing or extra:
        raise ValueError(f"checkpoint {path!r} does not hold this run's "
                         f"carry: missing {missing}, not expected {extra}")
    out = {}
    for name, like in like_state.items():
        a = saved[name]
        want_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        if tuple(a.shape) != tuple(like.shape) or a.dtype != want_dtype:
            raise ValueError(
                f"checkpoint {path!r}: array {name!r} is {a.dtype} "
                f"{tuple(a.shape)}, this run's carry holds {want_dtype} "
                f"{tuple(like.shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(like.device)
    return out
