"""Varint + base64 codec for variable-inclusion counts.

Counterpart of ``pymc_bart_tpu/utils/codec.py`` (copied: the port imports
nothing of the JAX package).

The reference stores per-draw inclusion counts as LEB128-style varints
(7 data bits + continuation bit) wrapped in base64, because PyMC sampler
stats must be scalars/strings (reference ``pymc_bart/utils.py:1343-1373``
and SURVEY 2.2).  The sampler stores plain int arrays natively; this
codec exists for wire compatibility with reference-produced
InferenceData and for exporting reference-readable stats.
"""

from __future__ import annotations

import base64
from typing import List, Sequence


def encode_vi(vec: Sequence[int]) -> str:
    """Encode a vector of non-negative ints to a base64 varint string."""
    out = bytearray()
    for num in vec:
        n = int(num)
        if n < 0:
            raise ValueError("variable-inclusion counts must be non-negative")
        while n > 0x7F:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        out.append(n & 0x7F)
    return base64.b64encode(bytes(out)).decode("ascii")


def decode_vi(s: str, length: int) -> List[int]:
    """Decode a base64 varint string back to a list of ``length`` ints."""
    data = base64.b64decode(s)
    result: List[int] = []
    pos = 0
    while len(result) < length and pos < len(data):
        num = 0
        shift = 0
        while pos < len(data):
            byte = data[pos]
            pos += 1
            num |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        result.append(num)
    return result


# reference-style private aliases (reference utils.py:1343,1362)
_encode_vi = encode_vi
_decode_vi = decode_vi
