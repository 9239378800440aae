"""Carry the JAX package's parameters and results into the port.

The JAX side hands over plain numpy arrays (a dict of a dataclass's fields,
e.g. ``{f.name: np.asarray(getattr(m, f.name)) for f in
dataclasses.fields(m)}``), so this module needs no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gradus_tpu_torch.geometry.discs import DatumPlane, ThinDisc
from gradus_tpu_torch.integrate.points import GeodesicPoint
from gradus_tpu_torch.metrics.kerr import KerrMetric
from gradus_tpu_torch.transfer.cunningham import TransferBranchGrid

__all__ = ["from_numpy", "geodesic_points_from_numpy", "transfer_grid_from_numpy"]

_KINDS = {
    "KerrMetric": (KerrMetric, ("M", "a")),
    "ThinDisc": (ThinDisc, ("inner_r", "outer_r")),
    "DatumPlane": (DatumPlane, ("height",)),
}


def from_numpy(kind: str, params: dict, *, dtype=torch.float64, device=None):
    """Build the port's ``kind`` object ("KerrMetric", "ThinDisc" or
    "DatumPlane") from a dict of numpy parameters named as the JAX
    dataclass's fields (a DatumPlane's height may be 0-d or (N,))."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {sorted(_KINDS)}")
    cls, names = _KINDS[kind]
    missing = set(names) - set(params)
    if missing:
        raise ValueError(f"{kind} needs parameters {sorted(missing)}")
    return cls(*(np.asarray(params[k], np.float64) for k in names), dtype=dtype, device=device)


def geodesic_points_from_numpy(d: dict, *, device=None) -> GeodesicPoint:
    """A `GeodesicPoint` of tensors from a dict of numpy arrays keyed by the
    field names (``aux`` may be missing or None)."""
    fields = {}
    for f in dataclasses.fields(GeodesicPoint):
        v = d.get(f.name)
        fields[f.name] = None if v is None else torch.as_tensor(np.asarray(v), device=device)
    return GeodesicPoint(**fields)


def transfer_grid_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> TransferBranchGrid:
    """A `TransferBranchGrid` of tensors from a dict of numpy arrays keyed by
    the field names."""
    return TransferBranchGrid(
        **{
            f.name: torch.as_tensor(np.asarray(d[f.name]), dtype=dtype, device=device)
            for f in dataclasses.fields(TransferBranchGrid)
        }
    )
