"""Fixed-depth structure-of-arrays tree tensors (PyTorch).

Counterpart of ``pymc_bart_tpu/ops/trees.py``.  A forest (m trees x node
slots) is one dataclass of dense tensors with a complete-binary-tree slot
layout, so every sampler and prediction operation has a fixed shape.

Node slot layout (complete binary tree of depth D, S = 2^(D+1)-1 slots):

* root = slot 0; children of slot i are ``2i+1`` (left) and ``2i+2`` (right)
* level d occupies slots [2^d - 1, 2^(d+1) - 1)

Tensors (any leading batch axes, then the ``m`` tree axis):

* ``split_var  : int32[..., m, S]``   splitting covariate; ``-1`` marks a leaf
* ``split_val  : float32[..., m, S]`` threshold (continuous) / category
* ``split_set  : int32[..., m, S]``   32-bit salt of the subset rule.  The
  JAX package stores it as ``uint32``; torch's ``uint32`` support is thin,
  so the port keeps the same BIT PATTERN in ``int32`` and converts at the
  NumPy boundary with ``.view`` (see ``convert.py``).
* ``leaf       : float32[..., m, S, k]`` leaf values; values of internal
  nodes are retained (depth-truncated predictions stay well defined)
* ``slope      : float32[..., m, S, k]`` linear-response slopes
* ``count      : float32[..., m, S]``  training rows that reached the node
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class Forest:
    """A batch of m fixed-depth trees as dense tensors (see module docstring)."""

    split_var: torch.Tensor  # int32[..., m, S]
    split_val: torch.Tensor  # float32[..., m, S]
    split_set: torch.Tensor  # int32[..., m, S] (uint32 bit pattern)
    leaf: torch.Tensor       # float32[..., m, S, k]
    count: torch.Tensor      # float32[..., m, S]
    slope: torch.Tensor      # float32[..., m, S, k]

    @property
    def n_trees(self) -> int:
        return self.split_var.shape[-2]

    @property
    def n_nodes(self) -> int:
        return self.split_var.shape[-1]

    @property
    def n_outputs(self) -> int:
        return self.leaf.shape[-1]

    def tree(self, j) -> "Forest":
        """Slice out tree j (the tree axis is dropped)."""
        return Forest(
            self.split_var[..., j, :],
            self.split_val[..., j, :],
            self.split_set[..., j, :],
            self.leaf[..., j, :, :],
            self.count[..., j, :],
            self.slope[..., j, :, :],
        )

    def clone(self) -> "Forest":
        return Forest(*(getattr(self, f.name).clone()
                        for f in dataclasses.fields(self)))


def init_forest(m: int, n_nodes: int, n_outputs: int, init_leaf_value,
                n_rows: int, device) -> Forest:
    """All-root-leaf forest predicting ``init_leaf_value`` per tree."""
    init_leaf_value = torch.as_tensor(
        init_leaf_value, dtype=torch.float32, device=device).reshape(-1)
    leaf = torch.zeros((m, n_nodes, n_outputs), dtype=torch.float32,
                       device=device)
    leaf[:, 0, :] = init_leaf_value
    count = torch.zeros((m, n_nodes), dtype=torch.float32, device=device)
    count[:, 0] = float(n_rows)
    return Forest(
        split_var=torch.full((m, n_nodes), -1, dtype=torch.int32,
                             device=device),
        split_val=torch.zeros((m, n_nodes), dtype=torch.float32,
                              device=device),
        split_set=torch.zeros((m, n_nodes), dtype=torch.int32, device=device),
        leaf=leaf,
        count=count,
        slope=torch.zeros((m, n_nodes, n_outputs), dtype=torch.float32,
                          device=device),
    )


def depth_of_slot(slot: int) -> int:
    """Tree depth of node slot ``slot`` (the root is depth 0)."""
    d = 0
    while 2 ** (d + 1) - 1 <= slot:
        d += 1
    return d


def level_slots(d: int) -> Tuple[int, int]:
    """[start, end) slot range of level d."""
    return 2**d - 1, 2 ** (d + 1) - 1


_M32 = 0xFFFFFFFF
# float32 -> int32 conversion saturates in XLA and in CUDA; torch's CPU cast
# of an out-of-range float is undefined, so clamp first (2147483520 is the
# largest float32 below 2^31).
_I32_LO, _I32_HI = -2147483648.0, 2147483520.0


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Saturating, NaN -> 0, truncating float32 -> int32 (as XLA's convert)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**31, neginf=_I32_LO)
    i = x.clamp(_I32_LO, _I32_HI).to(torch.int32)
    return torch.where(x >= 2.0**31, torch.full_like(i, 2**31 - 1), i)


def hash_bit(cat_i32: torch.Tensor, salt_i32: torch.Tensor) -> torch.Tensor:
    """The salt-keyed hash bit of a category (bool).

    The JAX package mixes in wrapping ``int32`` arithmetic with logical
    right shifts.  Here the arithmetic runs in ``int64`` masked to 32 bits
    after every step, which gives the same bits on every device.
    """
    c = cat_i32.to(torch.int64) & _M32
    s = salt_i32.to(torch.int64) & _M32
    h = s ^ ((c * 1103515245) & _M32)
    h = ((h ^ (h >> 15)) * 73244475) & _M32
    h = h ^ (h >> 13)
    return (h & 1) > 0


def subset_member(cat_i32: torch.Tensor, split_val: torch.Tensor,
                  salt_i32: torch.Tensor) -> torch.Tensor:
    """Hash-salted random-subset membership for the Subset split rule.

    ``split_set`` stores a 32-bit SALT: category c is in the node's subset
    iff a salt-keyed hash bit of c is set, and the stored split value's own
    category is always a member.  Bit for bit the function of
    ``pymc_bart_tpu/ops/trees.py::subset_member``.
    """
    own = cat_i32 == float_to_int32(
        torch.nan_to_num(split_val, nan=-(2.0 ** 30)))
    return own | hash_bit(cat_i32, salt_i32)


def decide_left(xv: torch.Tensor, split_val, split_set, rule,
                all_cont: bool = False) -> torch.Tensor:
    """Vectorized split decision: does row value ``xv`` go LEFT?

    * continuous: left iff ``x <= v`` (NaN compares False -> RIGHT)
    * one-hot:    left iff ``x == v``
    * subset:     left iff ``int(x)`` is in the node's hash-salted subset

    ``all_cont``: the caller knows every split rule is continuous, so the
    first case alone decides (the same bits, without the one-hot test and the
    subset hash).  Decide it once per call (``rules_all_continuous``), never
    per descent round: on the card that would synchronise every round.
    """
    cont = xv <= split_val
    if all_cont:
        return cont
    onehot = xv == split_val
    cat = float_to_int32(xv)
    subset = subset_member(cat, split_val, split_set)
    subset = subset & ~torch.isnan(xv)
    return torch.where(rule == 0, cont, torch.where(rule == 1, onehot, subset))


def rules_all_continuous(rules) -> bool:
    """True iff every split rule is continuous (code 0): the ``all_cont``
    flag of ``decide_left``.  One host read of ``rules``."""
    return bool((rules == 0).all())
