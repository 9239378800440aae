"""Corona → disc illumination: emissivity profiles (counterpart of
`gradus_tpu/corona/emissivity.py`).

Reference: `src/corona/emissivity.jl`, `src/corona/models/lamp-post.jl:77-154`
(point-source sweep, Dauser et al. 2013 emissivity) and `src/corona/radial.jl`
(Monte-Carlo photon-count binning). Both paths are one batched trace with
`trace_geodesics` (the lockstep solver, plain torch on the metric's device);
the radial binning is a fixed-size `index_add_`.

Ring and disc coronae without a sampler dispatch to the β-slice profiles of
`corona/extended.py`. Not ported yet, and raising `NotImplementedError`:
`bin_corona_hits(axis_name=...)` (ROADMAP queue A, item 12).
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import LinearGrid
from gradus_tpu_torch.corona.models import BeamedPointSource, DiscCorona, LampPostModel, RingCorona
from gradus_tpu_torch.corona.profiles import RadialDiscProfile
from gradus_tpu_torch.corona.samplers import BothHemispheres, EvenSampler, sky_angles_to_velocity
from gradus_tpu_torch.corona.spectra import PowerLawSpectrum
from gradus_tpu_torch.geodesics.tetrads import dotproduct, lnrbasis
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.redshift import keplerian_velocity_projector
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = [
    "proper_area",
    "energy_ratio",
    "lorentz_factor",
    "local_velocity",
    "emissivity_profile",
    "tracecorona",
    "tracecorona_profile",
    "point_source_emissivity_profile",
    "bin_corona_hits",
]


def proper_area(m: AbstractMetric, x):
    """2π√(g_rr g_φφ) — proper area element of an annulus
    (reference `_proper_area`, emissivity.jl:170-175)."""
    g = m.components(x[..., 1], x[..., 2])
    return 2 * math.pi * torch.sqrt(g[..., 1] * g[..., 3])


def local_velocity(m: AbstractMetric, x, v, component: int):
    """LNRF velocity component (Bardeen+73 eq. 3.9; reference
    flux-calculations.jl:13-29)."""
    basis = lnrbasis(m, x)
    vt = (basis[0] * v).sum(-1)
    vi = (basis[component] * v).sum(-1)
    return vi / vt


def lorentz_factor(m: AbstractMetric, x, v):
    """γ = (1 − (𝒱^φ)²)^(-1/2) (reference flux-calculations.jl:39-44)."""
    vphi = local_velocity(m, x, v, 3)
    return 1.0 / torch.sqrt(1.0 - vphi**2)


def energy_ratio(m: AbstractMetric, gp, v_src, v_disc):
    """g = E_src / E_disc (reference `energy_ratio`,
    flux-calculations.jl:100-112 — note the reference's inverted convention)."""
    e_src = dotproduct(m.metric(gp.x_init), gp.v_init, v_src)
    e_disc = dotproduct(m.metric(gp.x), gp.v, v_disc)
    return e_src / e_disc


def _trace_sky(m, d, x, v, lam_max, **kw):
    """The rays ``v`` from the source ``x`` to the disc, stopped below the
    equatorial plane."""
    return trace_geodesics(
        m,
        x.expand_as(v),
        v,
        (0.0, lam_max),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        constrain=False,
        **kw,
    )


def point_source_emissivity_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_samples: int = 1000,
    delta_min: float = 0.01,
    delta_max: float = 179.99,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
) -> RadialDiscProfile:
    """1D polar-angle sweep from an on-axis point source; Dauser et al. (2013)
    emissivity ε = weight·sin(δ)·g^(−Γ)/(A·γ) per annulus
    (reference `_point_source_symmetric_emissivity_profile`,
    lamp-post.jl:77-154)."""
    x, v_src = model.sample_position_velocity(m)
    deltas = torch.deg2rad(LinearGrid()(delta_min, delta_max, n_samples, device=x.device)).to(x.dtype)
    v = sky_angles_to_velocity(m, x, v_src, deltas, 0.0)
    gps = _trace_sky(m, d, x, v, lam_max, chart_outer=chart_outer)
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    r = equatorial_project(gps.x)
    t = gps.x[..., 0]

    disc_velocity = keplerian_velocity_projector(m)
    v_disc = disc_velocity(gps.x)
    g = energy_ratio(m, gps, v_src, v_disc)
    gam = lorentz_factor(m, gps.x, v_disc)

    # sort hits by radius (invalid → +inf tail)
    key = torch.where(hit, r, math.inf)
    order = torch.argsort(key, stable=True)
    r_s = key[order]
    t_s = t[order]
    d_s = deltas[order]
    g_s = g[order]
    gam_s = gam[order]
    n = hit.sum()

    # neighbour differences with the reference's edge handling
    # (lamp-post.jl:128-141): interior uses centred |Δ|, edges one-sided
    N = n_samples
    i = torch.arange(N, device=x.device)
    ip = torch.minimum(torch.clamp(i + 1, min=0), n - 1)
    im = torch.clamp(i - 1, min=0)
    first = i == 0
    last = i == n - 1

    def diffs(a):
        d_int = (torch.abs(a[i] - a[ip]) + torch.abs(a[i] - a[im])) / 2.0
        d_first = torch.abs(a[min(0, N - 1)] - a[min(1, N - 1)])
        d_last = torch.abs(a[i] - a[im])
        return torch.where(first, d_first, torch.where(last, d_last, d_int))

    dr = diffs(r_s)
    dd = diffs(d_s) / 2.0  # reference divides angle weight by 4 (two sums of 2)

    A = proper_area(m, gps.x[order]) * dr
    A = torch.where(A <= 0, 1.0, A)
    eps = dd * torch.abs(torch.sin(d_s)) * spectrum(g_s) / (A * gam_s)
    eps = torch.where(i < n, eps, 0.0)
    return RadialDiscProfile(radii=r_s, eps=eps, t=t_s, n=n)


def tracecorona_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    sampler=None,
    n_samples: int = 1024,
    lam_max: float = 10000.0,
    n_bins: int = 100,
) -> RadialDiscProfile:
    """Monte-Carlo sky sampling + radial photon-count binning
    (reference `tracecorona` corona-models.jl:164-190 + `RadialDiscProfile`
    binning radial.jl:39-125): ε = N·I(g)/(A·γ) per radial bin."""
    if sampler is None:
        sampler = EvenSampler(domain=BothHemispheres())
    x, v_src = model.sample_position_velocity(m)
    idx = torch.arange(1, n_samples + 1, dtype=x.dtype, device=x.device)
    elev, az = sampler.sample_angles(idx, n_samples)
    v = sky_angles_to_velocity(m, x, v_src, elev, az)
    gps = _trace_sky(m, d, x, v, lam_max)
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    return bin_corona_hits(m, spectrum, gps, v_src, hit, n_bins=n_bins)


def bin_corona_hits(
    m: AbstractMetric,
    spectrum,
    gps,
    v_src,
    hit,
    *,
    n_bins: int,
    axis_name: str | None = None,
) -> RadialDiscProfile:
    """Radial photon-count binning of corona-trace hits into a
    `RadialDiscProfile` (reference `_build_radial_profile`, radial.jl:39-93),
    over geometric bins spanning the hits' radii."""
    if axis_name is not None:
        raise NotImplementedError(
            "bin_corona_hits(axis_name=...) reduces over a device mesh, which is not "
            "ported yet (ROADMAP queue A, item 12)"
        )
    r = equatorial_project(gps.x)
    t = gps.x[..., 0]

    disc_velocity = keplerian_velocity_projector(m)
    v_disc_pt = disc_velocity(gps.x)
    g_pt = energy_ratio(m, gps, v_src, v_disc_pt)

    r_lo = torch.where(hit, r, math.inf).min()
    r_hi = torch.where(hit, r, -math.inf).max()
    K = (r_hi / r_lo) ** (1.0 / (n_bins - 1))
    bins = r_lo * K ** torch.arange(n_bins, dtype=r.dtype, device=r.device)

    bi = torch.clamp(torch.searchsorted(bins, r.contiguous()), 0, n_bins - 1)
    counts = r.new_zeros(n_bins).index_add_(0, bi, hit.to(r.dtype))
    g_sum = r.new_zeros(n_bins).index_add_(0, bi, torch.where(hit, g_pt, 0.0))
    t_sum = r.new_zeros(n_bins).index_add_(0, bi, torch.where(hit, t, 0.0))
    cnt_safe = torch.clamp(counts, min=1.0)
    g_mean = g_sum / cnt_safe
    t_mean = t_sum / cnt_safe

    R = bins
    dr = R - torch.cat([bins.new_zeros(1), bins[:-1]])
    x_eq = torch.stack([torch.zeros_like(R), R, torch.full_like(R, math.pi / 2), torch.zeros_like(R)], dim=-1)
    v_disc = disc_velocity(x_eq)
    gam = lorentz_factor(m, x_eq, v_disc)
    A = dr * proper_area(m, x_eq)
    eps = counts * spectrum(g_mean) / (A * gam)
    valid = counts > 0
    key = torch.where(valid, bins, math.inf)
    order = torch.argsort(key, stable=True)
    return RadialDiscProfile(
        radii=key[order],
        eps=torch.where(valid, eps, 0.0)[order],
        t=t_mean[order],
        n=valid.sum(),
    )


tracecorona = tracecorona_profile


def emissivity_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    sampler=None,
    n_samples: int = 1000,
    **kwargs,
) -> RadialDiscProfile:
    """Dispatch: the 1D sweep for on-axis point sources when no sampler is
    given; the β-slice arm tracing for ring and disc coronae; else
    Monte-Carlo (reference `emissivity_profile`, emissivity.jl:133-168 +
    extended.jl:133-143,186-200).

    A ring defaults to ``near_field="hybrid"`` (the β-slice fan with the
    adaptive sky's near field, `ring_corona_profile_hybrid`), ``"fan"``
    opting out; a disc to ``"fan"`` (the ring-stack fan,
    `disc_corona_profile`), ``"hybrid"`` running one adaptive sky a ring.
    As in the JAX package, ``near_field`` is taken out of ``kwargs`` only on
    these branches: on every other branch it reaches the profile function,
    which refuses it."""
    if sampler is None and isinstance(model, (LampPostModel, BeamedPointSource)):
        return point_source_emissivity_profile(m, d, model, spectrum, n_samples=n_samples, **kwargs)
    if sampler is None and isinstance(model, RingCorona):
        from gradus_tpu_torch.corona.extended import ring_corona_profile, ring_corona_profile_hybrid

        # the plain β-slice fan estimates ε through fold caustics with an
        # O(√Δβ) error that wobbles ±25% at |r − r_ring| ≲ 1 r_g; the hybrid
        # serves that band from the slice-free adaptive sky
        if kwargs.pop("near_field", "hybrid") == "hybrid":
            return ring_corona_profile_hybrid(m, d, model, spectrum, **kwargs)
        return ring_corona_profile(m, d, model, spectrum, **kwargs)
    if sampler is None and isinstance(model, DiscCorona):
        from gradus_tpu_torch.corona.extended import disc_corona_profile, disc_corona_profile_hybrid

        # each ring's near-field wobble is diluted by the flux-weighted
        # stack average; a per-ring hybrid runs n_rings adaptive skies
        if kwargs.pop("near_field", "fan") == "hybrid":
            return disc_corona_profile_hybrid(m, d, model, spectrum, **kwargs)
        return disc_corona_profile(m, d, model, spectrum, **kwargs)
    return tracecorona_profile(m, d, model, spectrum, sampler=sampler, n_samples=n_samples, **kwargs)
