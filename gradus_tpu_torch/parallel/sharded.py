"""Sharded tracing, rendering and product pipelines over a ray mesh
(counterpart of `gradus_tpu/parallel/sharded.py`).

Rays never interact, so the trace shards trivially: each rank integrates its
contiguous shard of the (padded) ray batch to completion, and its loop ends
as soon as its own rays finish. Every rank builds the full inputs, as the
reference does, traces its shard, and returns what the reference returns.
Collectives appear only at reduction points, as in the reference:

- `sharded_trace`, `sharded_pallas_trace`, `sharded_render`: an
  `all_gather` of the traced points into the full batch on every rank;
- `sharded_lineprofile`: `psum` of the g-binned flux histogram;
- `sharded_emissivity`: `pmin`/`pmax` of the radial bin range and `psum`
  of the (count, g, t) bin sums.

``mesh`` defaults to ``ray_mesh(device=<the inputs' device>)``.
"""

from __future__ import annotations

import dataclasses

import torch

from gradus_tpu_torch.integrate.points import GeodesicPoint
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import _as_observer
from gradus_tpu_torch.parallel.mesh import all_gather, ray_mesh, shard_rows

__all__ = [
    "sharded_trace",
    "sharded_render",
    "sharded_lineprofile",
    "sharded_emissivity",
    "sharded_pallas_trace",
    "pad_to_multiple",
]


def pad_to_multiple(arr, k, axis=0):
    """Pad axis length up to a multiple of k, repeating the last element so
    that padded rays integrate something harmless; returns (padded, n)."""
    n = arr.shape[axis]
    rem = (-n) % k
    if rem == 0:
        return arr, n
    pad = arr.narrow(axis, n - 1, 1).repeat_interleave(rem, dim=axis)
    return torch.cat([arr, pad], dim=axis), n


def local_rows(arr, mesh):
    """This rank's shard of ``arr`` padded to a multiple of the mesh."""
    return shard_rows(pad_to_multiple(arr, mesh.size)[0], mesh).contiguous()


def real_rows(n, mesh, device):
    """Of this rank's shard of a batch of n padded to a multiple of the
    mesh: True for a row of the batch, False for padding."""
    return shard_rows(torch.arange(n + (-n) % mesh.size, device=device) < n, mesh)


def _gathered(gp: GeodesicPoint, mesh, n) -> GeodesicPoint:
    """The ranks' points as the full batch of n rays on every rank."""
    return GeodesicPoint(
        **{
            f.name: None if getattr(gp, f.name) is None else all_gather(getattr(gp, f.name), mesh)[:n]
            for f in dataclasses.fields(gp)
        }
    )


def sharded_trace(m, x, v, lam_span, mesh=None, **trace_kwargs):
    """`trace_geodesics` with the ray axis sharded over the mesh: the full
    GeodesicPoint batch on every rank."""
    x, v = torch.broadcast_tensors(torch.atleast_2d(x), torch.atleast_2d(v))
    mesh = mesh or ray_mesh(device=x.device)
    gp = trace_geodesics(m, local_rows(x, mesh), local_rows(v, mesh), lam_span, **trace_kwargs)
    return _gathered(gp, mesh, x.shape[0])


def sharded_pallas_trace(tracer, y0, lam_span, mesh=None):
    """B1 under the mesh: each rank runs ``tracer`` (a `CudaTracer`, the
    counterpart of the reference's `PallasTracer`; the name is kept) on its
    shard of the constrained (N, 8) batch ``y0``. One thread integrates one
    ray, so the gathered batch is the unsharded trace's, bit for bit.
    Returns the full GeodesicPoint batch on every rank."""
    mesh = mesh or ray_mesh(device=y0.device)
    gp, _aux = tracer.trace(local_rows(y0, mesh), lam_span)
    return _gathered(gp, mesh, y0.shape[0])


def sharded_render(
    m,
    position,
    geometry=None,
    lam_max: float = 2000.0,
    *,
    image_width: int = 1024,
    image_height: int = 1024,
    alpha_lims=(-60.0, 60.0),
    beta_lims=(-40.0, 40.0),
    pf=None,
    mesh=None,
    **trace_kwargs,
):
    """Distributed `rendergeodesics`: (α axis, β axis, image) on every rank,
    the pixels traced in shards."""
    from gradus_tpu_torch.camera.pointfns import ConstPointFunctions
    from gradus_tpu_torch.camera.render import EndpointRenderCache, _pixel_velocities, apply

    x = _as_observer(position, m)
    alphas, betas, v = _pixel_velocities(m, x, image_width, image_height, alpha_lims, beta_lims)
    xs = torch.broadcast_to(x, v.shape)
    gps = sharded_trace(m, xs, v, (0.0, lam_max), mesh=mesh, geometry=geometry, **trace_kwargs)
    cache = EndpointRenderCache(
        m=m,
        max_time=torch.as_tensor(lam_max, dtype=x.dtype, device=x.device),
        height=image_height,
        width=image_width,
        points=gps,
    )
    if pf is None:
        pf = ConstPointFunctions.shadow()
    return alphas, betas, apply(pf, cache)


def sharded_lineprofile(
    m,
    x,
    d,
    *,
    bins=None,
    emissivity=None,
    profile=None,
    min_re=None,
    max_re: float = 50.0,
    lam_max=None,
    plane=None,
    mesh=None,
    **trace_kwargs,
):
    """Distributed BinningMethod line profile (reference
    line-profiles.jl:157-198): each rank traces its shard of the polar
    plane and bins its flux histogram, which `binned_flux` sums over the
    mesh before normalising, so every rank returns the same (bins, flux).
    Padded rays carry zero area."""
    from gradus_tpu_torch.camera.grids import GeometricGrid
    from gradus_tpu_torch.camera.impact import map_impact_parameters
    from gradus_tpu_torch.camera.planes import PolarPlane
    from gradus_tpu_torch.lineprofile import _default_emissivity, binned_flux
    from gradus_tpu_torch.orbits.special_radii import isco
    from gradus_tpu_torch.redshift import redshift_pointfunction

    x = _as_observer(x, m)
    mesh = mesh or ray_mesh(device=x.device)
    if bins is None:
        bins = torch.linspace(0.1, 1.5, 180, dtype=x.dtype, device=x.device)
    else:
        bins = torch.as_tensor(bins, dtype=x.dtype, device=x.device)
    if emissivity is None:
        emissivity = _default_emissivity if profile is None else profile.emissivity_at
    if min_re is None:
        min_re = isco(m)
    if lam_max is None:
        lam_max = 2.0 * x[1]
    if plane is None:
        plane = PolarPlane(
            GeometricGrid(), Nr=450, Ntheta=1300, r_max=5 * max_re, dtype=x.dtype, device=x.device
        )
    redshift_pf = redshift_pointfunction(m, x)

    alpha, beta = plane.impact_parameters()
    areas = plane.unnormalized_areas()
    v = map_impact_parameters(m, x, alpha, beta)
    xs = torch.broadcast_to(x, v.shape)
    areas_loc = torch.where(real_rows(areas.shape[0], mesh, areas.device), local_rows(areas, mesh), 0.0)
    gps = trace_geodesics(
        m,
        local_rows(xs, mesh),
        local_rows(v, mesh),
        (0.0, lam_max),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        **trace_kwargs,
    )
    flux = binned_flux(
        m,
        gps,
        areas_loc,
        emissivity,
        bins,
        min_re=min_re,
        max_re=max_re,
        lam_max=lam_max,
        redshift_pf=redshift_pf,
        axis_name=mesh,
    )
    return bins, flux


def sharded_emissivity(
    m,
    d,
    model,
    spectrum=None,
    *,
    sampler=None,
    n_samples: int = 1024,
    lam_max: float = 10000.0,
    n_bins: int = 100,
    mesh=None,
):
    """Distributed Monte-Carlo emissivity profile (reference `tracecorona`
    and `RadialDiscProfile`'s binning): the sky samples shard over the
    mesh; `bin_corona_hits` agrees the radial bin range with `pmin`/`pmax`
    and sums the photon-count, redshift and time bins, so every rank
    returns the same `RadialDiscProfile`. Padded samples are masked out."""
    from gradus_tpu_torch.corona.emissivity import bin_corona_hits
    from gradus_tpu_torch.corona.samplers import BothHemispheres, EvenSampler, sky_angles_to_velocity
    from gradus_tpu_torch.corona.spectra import PowerLawSpectrum
    from gradus_tpu_torch.integrate.status import StatusCodes

    if spectrum is None:
        spectrum = PowerLawSpectrum(2.0)
    if sampler is None:
        sampler = EvenSampler(domain=BothHemispheres())

    x, v_src = model.sample_position_velocity(m)
    mesh = mesh or ray_mesh(device=x.device)
    idx = torch.arange(1, n_samples + 1, dtype=x.dtype, device=x.device)
    elev, az = sampler.sample_angles(idx, n_samples)
    v = sky_angles_to_velocity(m, x, v_src, elev, az)
    xs = torch.broadcast_to(x, v.shape)
    gps = trace_geodesics(
        m,
        local_rows(xs, mesh),
        local_rows(v, mesh),
        (0.0, lam_max),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        constrain=False,
    )
    hit = (gps.status == StatusCodes.IntersectedWithGeometry) & real_rows(v.shape[0], mesh, x.device)
    return bin_corona_hits(m, spectrum, gps, v_src, hit, n_bins=n_bins, axis_name=mesh)
