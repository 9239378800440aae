"""Relativistic line profiles (counterpart of `gradus_tpu/lineprofile.py`).

Reference: `src/line-profiles.jl`. Two methods:
- `TransferFunctionMethod` (default): Cunningham transfer functions +
  `integrate_lineprofile` (defaults: bins 0.1:1.5 ×180, minrₑ = isco+1e-2,
  maxrₑ = 50, numrₑ = 100, h = 2e-8). The default ``backend="xla"`` is the
  jvp Newton through the lockstep solver, which takes every disc, thick
  ones too; ``backend="cuda"`` (thin discs) runs the offset solves on the
  hand-written CUDA integrator, minutes faster a profile on the card.
- `BinningMethod`: trace a polar image plane with `trace_geodesics` (the
  lockstep solver, on the observer position's device) and its
  `domain_upper_hemisphere` terminator, filter disc hits in [minrₑ, maxrₑ],
  flux = ε(r)·g³·area bucketed into g bins (`binned_flux`).

With ``profile=`` (an emissivity profile such as `emissivity_profile`'s),
ε is the profile's ``emissivity_at`` and the default method is
`BinningMethod`. `binned_flux(axis_name=mesh)` sums the histogram over a
ray mesh (`gradus_tpu_torch.parallel`) before normalising.
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.camera.grids import GeometricGrid
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.camera.planes import PolarPlane
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.orbits.special_radii import isco
from gradus_tpu_torch.parallel.mesh import psum
from gradus_tpu_torch.redshift import redshift_pointfunction
from gradus_tpu_torch.transfer import integrate_lineprofile, transferfunctions
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
    lam_max=None,
    plane=None,
    redshift_pf=None,
    **kwargs,
):
    """Returns (bins, flux). Emissivity defaults to ε(r) = r⁻³. With the
    default `TransferFunctionMethod`, ``kwargs`` go to
    `cunningham_transfer_function` (``backend``, ``N``, ...); with
    `BinningMethod`, to `trace_geodesics`, and ``lam_max`` (default 2·r_obs),
    ``plane`` (default a 450×1300 geometric `PolarPlane` to 5·max_re),
    ``redshift_pf`` (default `redshift_pointfunction`) and ``min_re``
    (default the ISCO) shape the binning. A ``profile`` (anything with
    ``emissivity_at``, such as `emissivity_profile`'s) gives ε where
    ``emissivity`` is None, and makes `BinningMethod` the default."""
    x = _as_observer(x, m)
    if bins is None:
        bins = torch.linspace(0.1, 1.5, 180, dtype=x.dtype, device=x.device)
    else:
        bins = torch.as_tensor(bins, dtype=x.dtype, device=x.device)
    if emissivity is None:
        emissivity = _default_emissivity if profile is None else profile.emissivity_at
    if method is None:
        method = TransferFunctionMethod() if profile is None else BinningMethod()

    if isinstance(method, TransferFunctionMethod):
        tfs = transferfunctions(m, x, d, min_re=min_re, max_re=max_re, num_re=num_re, **kwargs)
        flux = integrate_lineprofile(emissivity, tfs, bins, h=h, n_radii=n_radii)
        return bins, flux

    # --- BinningMethod (reference line-profiles.jl:157-198) ---------------
    if min_re is None:
        min_re = isco(m)
    if lam_max is None:
        lam_max = 2.0 * x[1]
    if plane is None:
        plane = PolarPlane(
            GeometricGrid(), Nr=450, Ntheta=1300, r_max=5 * max_re, dtype=x.dtype, device=x.device
        )
    if redshift_pf is None:
        redshift_pf = redshift_pointfunction(m, x)

    alpha, beta = plane.impact_parameters()
    areas = plane.unnormalized_areas()
    v = map_impact_parameters(m, x, alpha, beta)
    xs = torch.broadcast_to(x, v.shape)
    gps = trace_geodesics(
        m,
        xs,
        v,
        (0.0, lam_max),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        **kwargs,
    )
    flux = binned_flux(
        m,
        gps,
        areas,
        emissivity,
        bins,
        min_re=min_re,
        max_re=max_re,
        lam_max=lam_max,
        redshift_pf=redshift_pf,
    )
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
    axis_name=None,
):
    """g-binned flux histogram f = ε(r)·g³·area over disc hits (reference
    line-profiles.jl:157-198), normalised to Σ = 1. With ``axis_name`` (the
    port's ray mesh, `parallel.ray_mesh()`, or its process group; each rank
    holding its shard of the rays) the histogram is summed over the ranks
    before the normalisation, so every rank returns the same profile."""
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
    if axis_name is not None:
        flux = psum(flux, axis_name)
    total = flux.sum()
    return torch.where(total > 0, flux / total, flux)
