"""Relativistic line profiles (counterpart of `gradus_tpu/lineprofile.py`).

Reference: `src/line-profiles.jl`. Two methods:
- `TransferFunctionMethod` (default): Cunningham transfer functions +
  `integrate_lineprofile` (defaults: bins 0.1:1.5 ×180, minrₑ = isco+1e-2,
  maxrₑ = 50, numrₑ = 100, h = 2e-8). Pass ``backend="cuda"``: on CUDA
  tensors its offset solves run the hand-written CUDA integrator.
- `BinningMethod`: trace a polar image plane, filter disc hits in
  [minrₑ, maxrₑ], flux = ε(r)·g³·area bucketed into g bins. `binned_flux` is
  ported; trace the plane with `CudaTracer` (the JAX package's
  `bench.py::bench_binning` does so with `PallasTracer`).

Not ported yet, and raising `NotImplementedError`: the BinningMethod branch
of `lineprofile`, which traces with `trace_geodesics` and its
`domain_upper_hemisphere` terminator (ROADMAP queue A, item 2); ``profile=``,
which needs the corona's emissivity profiles (item 9); and
`binned_flux(axis_name=...)`, which needs the multi-device port (item 12).
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.transfer import integrate_lineprofile, transferfunctions
from gradus_tpu_torch.transfer.cunningham import _as_observer
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = ["lineprofile", "TransferFunctionMethod", "BinningMethod", "binned_flux"]


class TransferFunctionMethod:
    pass


class BinningMethod:
    pass


def _default_emissivity(r):
    return r**-3.0


def lineprofile(
    m: AbstractMetric,
    x,
    d,
    *,
    bins=None,
    emissivity=None,
    profile=None,
    method=None,
    min_re=None,
    max_re: float = 50.0,
    num_re: int = 100,
    h: float = 2e-8,
    n_radii: int = 1000,
    **kwargs,
):
    """Returns (bins, flux). Emissivity defaults to ε(r) = r⁻³; ``kwargs``
    go to `cunningham_transfer_function` (``backend="cuda"``, ``N``, ...)."""
    if profile is not None:
        raise NotImplementedError(
            "profile= needs the corona's emissivity profiles, which are not ported "
            "yet (ROADMAP queue A, item 9)"
        )
    if method is not None and not isinstance(method, TransferFunctionMethod):
        raise NotImplementedError(
            "the BinningMethod branch of lineprofile traces with trace_geodesics "
            "and domain_upper_hemisphere, which wait for the plain solver "
            "(ROADMAP queue A, item 2); trace a PolarPlane with CudaTracer and "
            "call binned_flux instead"
        )
    x = _as_observer(x, m)
    if bins is None:
        bins = torch.linspace(0.1, 1.5, 180, dtype=x.dtype, device=x.device)
    else:
        bins = torch.as_tensor(bins, dtype=x.dtype, device=x.device)
    if emissivity is None:
        emissivity = _default_emissivity

    tfs = transferfunctions(m, x, d, min_re=min_re, max_re=max_re, num_re=num_re, **kwargs)
    flux = integrate_lineprofile(emissivity, tfs, bins, h=h, n_radii=n_radii)
    return bins, flux


def binned_flux(
    m,
    gps,
    areas,
    emissivity,
    bins,
    *,
    min_re,
    max_re,
    lam_max,
    redshift_pf,
    axis_name: str | None = None,
):
    """g-binned flux histogram f = ε(r)·g³·area over disc hits (reference
    line-profiles.jl:157-198), normalised to Σ = 1."""
    if axis_name is not None:
        raise NotImplementedError(
            "binned_flux(axis_name=...) reduces over a device mesh, which is not "
            "ported yet (ROADMAP queue A, item 12)"
        )
    r_em = equatorial_project(gps.x)
    hit = (
        (gps.status == StatusCodes.IntersectedWithGeometry)
        & (r_em >= min_re)
        & (r_em <= max_re)
    )
    g = redshift_pf(m, gps, lam_max)
    f = torch.where(hit, emissivity(r_em) * g**3 * areas, 0.0)
    g_safe = torch.where(hit, g, -1.0)
    idx = torch.searchsorted(bins, g_safe.contiguous()) - 1
    valid = hit & (idx >= 0) & (idx < bins.shape[0] - 1)
    idx = torch.clamp(idx, 0, bins.shape[0] - 2)
    flux = f.new_zeros(bins.shape[0]).index_add_(0, idx, torch.where(valid, f, 0.0))
    total = flux.sum()
    return torch.where(total > 0, flux / total, flux)
