"""Lightweight InferenceData: named groups of dimension-labelled arrays.

Counterpart of ``pymc_bart_tpu/models/inference_data.py`` (NumPy only, copied).

The reference returns arviz/xarray ``InferenceData`` from PyMC
(reference SURVEY 3.2 end state: "idata: posterior[...],
sample_stats[variable_inclusion]").  xarray is not part of this image, so
this is a small numpy-backed stand-in supporting the access patterns the
reference's own code and tests rely on:

* ``idata["sample_stats"]["variable_inclusion"]`` (reference utils.py:750)
* ``.values``, ``.values.ravel()`` (reference utils.py:759-761)
* ``da.sel({dim: index})`` and ``da.<dim_name>.size`` (reference
  utils.py:751-759)
* ``idata.posterior["mu"].shape``, ``idata.posterior.coords[...]`` data
  (reference tests/test_bart.py:121-123)
* ``idata.predictions.y.median(["chain", "draw"])``
  (reference tests/test_bart.py:163)
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Coord:
    def __init__(self, values: np.ndarray):
        self.data = np.asarray(values)

    @property
    def size(self) -> int:
        return self.data.size

    def __len__(self):
        return self.data.size

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data, dtype=dtype)


class DataArray:
    def __init__(self, values: np.ndarray, dims: Sequence[str],
                 coords: Optional[Dict[str, np.ndarray]] = None, name=None):
        self.values = np.asarray(values)
        self.dims = tuple(dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError(
                f"dims {self.dims} incompatible with shape {self.values.shape}"
            )
        self.coords = {
            d: Coord(coords[d]) if coords and d in coords else Coord(np.arange(s))
            for d, s in zip(self.dims, self.values.shape)
        }
        self.name = name

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.ndim

    def __getattr__(self, item):
        coords = self.__dict__.get("coords", {})
        if item in coords:
            return coords[item]
        raise AttributeError(item)

    def sel(self, indexers: Optional[Dict[str, int]] = None, **kwargs):
        indexers = dict(indexers or {}, **kwargs)
        out = self.values
        dims: List[str] = list(self.dims)
        for dim, val in indexers.items():
            ax = dims.index(dim)
            idx = int(val)
            out = np.take(out, idx, axis=ax)
            dims.pop(ax)
        coords = {d: self.coords[d].data for d in dims}
        return DataArray(out, dims, coords, name=self.name)

    def _reduce(self, fn, dim=None):
        if dim is None:
            return fn(self.values)
        dims = [dim] if isinstance(dim, str) else list(dim)
        axes = tuple(self.dims.index(d) for d in dims)
        out = fn(self.values, axis=axes)
        rem = [d for d in self.dims if d not in dims]
        coords = {d: self.coords[d].data for d in rem}
        return DataArray(out, rem, coords, name=self.name)

    def median(self, dim=None):
        return self._reduce(np.median, dim)

    def mean(self, dim=None):
        return self._reduce(np.mean, dim)

    def std(self, dim=None):
        return self._reduce(np.std, dim)

    def ravel(self):
        return self.values.ravel()

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __eq__(self, other):
        other = np.asarray(other)
        return self.values == other

    # __eq__ returns an array (xarray-style), so identity-hash explicitly
    # to keep DataArray objects usable in sets/dicts
    __hash__ = object.__hash__

    def all(self):
        return self.values.all()

    def __repr__(self):
        return f"<DataArray {self.name or ''} {dict(zip(self.dims, self.shape))}>"


class Dataset:
    def __init__(self, variables: Dict[str, DataArray]):
        self._variables = dict(variables)

    @property
    def coords(self) -> Dict[str, Coord]:
        out: Dict[str, Coord] = {}
        for da in self._variables.values():
            out.update(da.coords)
        return out

    def __getitem__(self, name) -> DataArray:
        return self._variables[name]

    def __setitem__(self, name, da: DataArray):
        self._variables[name] = da

    def __contains__(self, name) -> bool:
        return name in self._variables

    def __iter__(self) -> Iterable[str]:
        return iter(self._variables)

    def keys(self):
        return self._variables.keys()

    def items(self):
        return self._variables.items()

    def __getattr__(self, item):
        variables = self.__dict__.get("_variables", {})
        if item in variables:
            return variables[item]
        raise AttributeError(item)

    def __repr__(self):
        return f"<Dataset {list(self._variables)}>"


class InferenceData:
    """Groups: posterior, sample_stats, posterior_predictive, predictions,
    observed_data, ..."""

    def __init__(self, **groups: Dataset):
        self._groups: Dict[str, Dataset] = {}
        for name, ds in groups.items():
            self.add_group(name, ds)

    def add_group(self, name: str, ds: Dataset):
        self._groups[name] = ds
        setattr(self, name, ds)

    def __getitem__(self, name) -> Dataset:
        return self._groups[name]

    def __contains__(self, name) -> bool:
        return name in self._groups

    def groups(self):
        return list(self._groups)

    def __repr__(self):
        return f"<InferenceData groups={list(self._groups)}>"
