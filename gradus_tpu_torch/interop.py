"""Carry the JAX package's parameters and results into the port.

The JAX side hands over plain numpy arrays (a dict of a dataclass's fields,
e.g. ``{f.name: np.asarray(getattr(m, f.name)) for f in
dataclasses.fields(m)}``), so this module needs no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gradus_tpu_torch.camera.render import EndpointRenderCache
from gradus_tpu_torch.config import default_device
from gradus_tpu_torch.corona.models import BeamedPointSource, DiscCorona, LampPostModel, RingCorona
from gradus_tpu_torch.corona.extended import (
    DiscCoronaProfile,
    NearFieldBlendedProfile,
    RingCoronaProfile,
    TimeDependentRadialDiscProfile,
)
from gradus_tpu_torch.corona.profiles import RadialDiscProfile
from gradus_tpu_torch.geometry.discs import (
    CompositeGeometry,
    DatumPlane,
    EllipticalDisc,
    PolishDoughnut,
    PolishDoughnutFW,
    PrecessingDisc,
    ShakuraSunyaev,
    ThickDisc,
    ThinDisc,
    WarpedThinDisc,
)
from gradus_tpu_torch.geometry.meshes import MeshAccretionGeometry
from gradus_tpu_torch.integrate.points import GeodesicPoint
from gradus_tpu_torch.integrate.tracing import PoloidalShape
from gradus_tpu_torch.metrics import (
    BumblebeeMetric,
    CartesianMetric,
    DilatonAxion,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    KerrDarkMatter,
    KerrMetric,
    KerrNewmanMetric,
    KerrRefractive,
    KerrSpacetimeFirstOrder,
    MorrisThorneWormhole,
    NoZMetric,
    SphericalMetric,
)
from gradus_tpu_torch.transfer.cunningham import TransferBranchGrid

__all__ = [
    "corona_model_from_numpy",
    "disc_corona_profile_from_numpy",
    "from_numpy",
    "geometry_from_numpy",
    "geodesic_points_from_numpy",
    "mesh_from_numpy",
    "poloidal_shape_from_numpy",
    "near_field_profile_from_numpy",
    "radial_profile_from_numpy",
    "render_cache_from_numpy",
    "ring_corona_profile_from_numpy",
    "time_dependent_profile_from_numpy",
    "transfer_grid_from_numpy",
]

_CORONA_KINDS = {
    "LampPostModel": (LampPostModel, ("h", "theta", "phi")),
    "BeamedPointSource": (BeamedPointSource, ("r", "beta")),
    "RingCorona": (RingCorona, ("r", "h")),
    "DiscCorona": (DiscCorona, ("r", "h")),
}

_KINDS = {
    "KerrMetric": (KerrMetric, ("M", "a")),
    "JohannsenMetric": (JohannsenMetric, ("M", "a", "alpha13", "alpha22", "alpha52", "eps3")),
    "JohannsenPsaltisMetric": (JohannsenPsaltisMetric, ("M", "a", "eps3")),
    "NoZMetric": (NoZMetric, ("M", "a", "eps")),
    "BumblebeeMetric": (BumblebeeMetric, ("M", "a", "l")),
    "DilatonAxion": (DilatonAxion, ("M", "a", "beta", "b")),
    "KerrNewmanMetric": (KerrNewmanMetric, ("M", "a", "Q")),
    "MorrisThorneWormhole": (MorrisThorneWormhole, ("b",)),
    "KerrRefractive": (KerrRefractive, ("M", "a", "n", "corona_radius")),
    "KerrDarkMatter": (KerrDarkMatter, ("M", "a", "M_dark_matter", "delta_r", "r_s")),
    "SphericalMetric": (SphericalMetric, ()),
    "CartesianMetric": (CartesianMetric, ()),
    "KerrSpacetimeFirstOrder": (KerrSpacetimeFirstOrder, ("M", "a")),
    "ThinDisc": (ThinDisc, ("inner_r", "outer_r")),
    "DatumPlane": (DatumPlane, ("height",)),
    "ShakuraSunyaev": (ShakuraSunyaev, ("mdot_over_edd", "inv_eta", "inner_r")),
    "EllipticalDisc": (EllipticalDisc, ("inner_r", "semi_major", "semi_minor")),
    "PolishDoughnutFW": (PolishDoughnutFW, ("rs", "zs", "r_k", "n")),
}

# the geometries that hold another object: a callable cross-section, an inner
# disc, a tuple of geometries, or a metric (`geometry_from_numpy`)
_NESTED_GEOMETRIES = {
    "WarpedThinDisc": (WarpedThinDisc, ("inner_r", "outer_r")),
    "ThickDisc": (ThickDisc, ("inner_r", "outer_r")),
    "PrecessingDisc": (PrecessingDisc, ("beta", "gamma")),
    "PolishDoughnut": (PolishDoughnut, ("M", "ell", "r_cusp", "inner_r", "outer_r", "z_max")),
    "CompositeGeometry": (CompositeGeometry, ()),
}


def from_numpy(kind: str, params: dict, *, dtype=torch.float64, device=None):
    """Build the port's ``kind`` object (a metric, or a geometry that holds
    numbers only; the keys of ``_KINDS``) from a dict of numpy parameters
    named as the JAX dataclass's fields (a DatumPlane's height may be 0-d or
    (N,)), in ``dtype`` on ``device`` (the card when None)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {sorted(_KINDS)}")
    cls, names = _KINDS[kind]
    missing = set(names) - set(params)
    if missing:
        raise ValueError(f"{kind} needs parameters {sorted(missing)}")
    return cls(*(np.asarray(params[k], np.float64) for k in names), dtype=dtype, device=device)


def geometry_from_numpy(kind: str, params: dict, *, dtype=torch.float64, device=None):
    """Build the port's geometry ``kind`` (a class name of
    `gradus_tpu_torch.geometry.discs`) from a dict of numpy parameters named
    as the JAX dataclass's fields, in ``dtype`` on ``device`` (the card when
    None). What a field holds besides numbers comes as: ``f``, the
    cross-section of a `ThickDisc` or `WarpedThinDisc`, a callable of torch
    tensors; ``disc``, the inner disc of a `PrecessingDisc`, and
    ``metric``, a `PolishDoughnut`'s (or None), each a ``(kind, params)``
    pair; ``geometries``, a `CompositeGeometry`'s, a sequence of such
    pairs."""
    kw = dict(dtype=dtype, device=device)
    if kind in _KINDS:
        return from_numpy(kind, params, **kw)
    if kind not in _NESTED_GEOMETRIES:
        raise ValueError(f"unknown geometry {kind!r}; expected one of {sorted(set(_KINDS) | set(_NESTED_GEOMETRIES))}")
    cls, names = _NESTED_GEOMETRIES[kind]
    missing = set(names) - set(params)
    if missing:
        raise ValueError(f"{kind} needs parameters {sorted(missing)}")
    numbers = {k: np.asarray(params[k], np.float64) for k in names}
    if kind in ("WarpedThinDisc", "ThickDisc"):
        return cls(params["f"], **numbers, **kw)
    if kind == "PrecessingDisc":
        return cls(geometry_from_numpy(*params["disc"], **kw), **numbers, **kw)
    if kind == "CompositeGeometry":
        return cls([geometry_from_numpy(*g, **kw) for g in params["geometries"]])
    metric = params.get("metric")
    metric = None if metric is None else from_numpy(*metric, **kw)
    return cls(**numbers, metric=metric, **kw)


def mesh_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> MeshAccretionGeometry:
    """A `MeshAccretionGeometry` from a dict of the JAX dataclass's fields
    (``triangles`` (T, 3, 3), ``bbox_min``, ``bbox_max``, and
    ``proximity2``, 9 when missing), in ``dtype`` on ``device`` (the card
    when None)."""
    return MeshAccretionGeometry(
        np.asarray(d["triangles"], np.float64),
        np.asarray(d["bbox_min"], np.float64),
        np.asarray(d["bbox_max"], np.float64),
        float(d.get("proximity2", 9.0)),
        dtype=dtype,
        device=device,
    )


def poloidal_shape_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> PoloidalShape:
    """A `PoloidalShape` (a θ-dependent inner chart) from a dict with its
    ``rs`` and ``thetas``, in ``dtype`` on ``device`` (the card when
    None)."""
    device = default_device(device)
    return PoloidalShape(
        *(torch.as_tensor(np.asarray(d[k], np.float64), dtype=dtype, device=device) for k in ("rs", "thetas"))
    )


def geodesic_points_from_numpy(d: dict, *, device=None) -> GeodesicPoint:
    """A `GeodesicPoint` of tensors from a dict of numpy arrays keyed by the
    field names (``aux`` may be missing or None), on ``device`` (the card
    when None)."""
    device = default_device(device)
    fields = {}
    for f in dataclasses.fields(GeodesicPoint):
        v = d.get(f.name)
        fields[f.name] = None if v is None else torch.as_tensor(np.asarray(v), device=device)
    return GeodesicPoint(**fields)


def render_cache_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> EndpointRenderCache:
    """An `EndpointRenderCache` from the JAX package's one, handed over as a
    dict: ``metric`` (a kind of `from_numpy`), ``metric_params`` (its dict
    of numpy parameters), ``max_time``, ``height``, ``width`` and
    ``points`` (the dict of numpy arrays `geodesic_points_from_numpy`
    takes); the metric and ``max_time`` in ``dtype``, all on ``device``
    (the card when None)."""
    device = default_device(device)
    return EndpointRenderCache(
        m=from_numpy(d["metric"], d["metric_params"], dtype=dtype, device=device),
        max_time=torch.as_tensor(np.asarray(d["max_time"]), dtype=dtype, device=device),
        height=int(d["height"]),
        width=int(d["width"]),
        points=geodesic_points_from_numpy(d["points"], device=device),
    )


def transfer_grid_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> TransferBranchGrid:
    """A `TransferBranchGrid` of tensors from a dict of numpy arrays keyed by
    the field names, on ``device`` (the card when None)."""
    device = default_device(device)
    return TransferBranchGrid(
        **{
            f.name: torch.as_tensor(np.asarray(d[f.name]), dtype=dtype, device=device)
            for f in dataclasses.fields(TransferBranchGrid)
        }
    )


def corona_model_from_numpy(kind: str, params: dict):
    """Build the port's corona model ``kind`` (a key of ``_CORONA_KINDS``)
    from a dict of its JAX dataclass's fields as numpy scalars; a ring's or
    disc's ``vf`` is carried as it is."""
    if kind not in _CORONA_KINDS:
        raise ValueError(f"unknown corona model {kind!r}; expected one of {sorted(_CORONA_KINDS)}")
    cls, names = _CORONA_KINDS[kind]
    missing = set(names) - set(params)
    if missing:
        raise ValueError(f"{kind} needs parameters {sorted(missing)}")
    extra = {"vf": str(params["vf"])} if "vf" in params else {}
    return cls(*(float(np.asarray(params[k], np.float64)) for k in names), **extra)


def radial_profile_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> RadialDiscProfile:
    """A `RadialDiscProfile` from a dict of numpy arrays keyed by its field
    names (``radii``, ``eps``, ``t`` and the valid count ``n``), on
    ``device`` (the card when None)."""
    device = default_device(device)
    return RadialDiscProfile(
        **{k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device) for k in ("radii", "eps", "t")},
        n=torch.as_tensor(int(np.asarray(d["n"])), device=device),
    )


def time_dependent_profile_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> TimeDependentRadialDiscProfile:
    """A `TimeDependentRadialDiscProfile` from a dict of numpy arrays keyed by
    its field names (``radii``, ``t``, ``eps`` and the valid counts ``n``,
    with or without a leading ring axis), on ``device`` (the card when
    None)."""
    device = default_device(device)
    return TimeDependentRadialDiscProfile(
        **{k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device) for k in ("radii", "t", "eps")},
        n=torch.as_tensor(np.asarray(d["n"]).astype(np.int64), device=device),
    )


def ring_corona_profile_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> RingCoronaProfile:
    """A `RingCoronaProfile` from ``{"left": ..., "right": ...}``, each the
    dict `time_dependent_profile_from_numpy` takes."""
    return RingCoronaProfile(
        **{arm: time_dependent_profile_from_numpy(d[arm], dtype=dtype, device=device) for arm in ("left", "right")}
    )


def disc_corona_profile_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> DiscCoronaProfile:
    """A `DiscCoronaProfile` from ``radii``, ``delays`` (numpy arrays) and
    ``rings`` (the dict `ring_corona_profile_from_numpy` takes, its arrays
    with a leading ring axis)."""
    device = default_device(device)
    return DiscCoronaProfile(
        radii=torch.as_tensor(np.asarray(d["radii"]), dtype=dtype, device=device),
        rings=ring_corona_profile_from_numpy(d["rings"], dtype=dtype, device=device),
        delays=torch.as_tensor(np.asarray(d["delays"]), dtype=dtype, device=device),
    )


def near_field_profile_from_numpy(d: dict, *, dtype=torch.float64, device=None) -> NearFieldBlendedProfile:
    """A `NearFieldBlendedProfile` from ``fan`` (the dict
    `ring_corona_profile_from_numpy` takes) and the numpy arrays
    ``r_nodes``, ``eps_nodes``, ``lo0``, ``lo1``, ``hi0`` and ``hi1``."""
    device = default_device(device)
    return NearFieldBlendedProfile(
        fan=ring_corona_profile_from_numpy(d["fan"], dtype=dtype, device=device),
        **{
            k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device)
            for k in ("r_nodes", "eps_nodes", "lo0", "lo1", "hi0", "hi1")
        },
    )
