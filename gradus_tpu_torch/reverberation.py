"""Reverberation: lag-frequency spectra from the 2D (g, t) lag transfer
(counterpart of `gradus_tpu/reverberation.py`).

Reference: `src/reverberation.jl`. The impulse response ψ(t) = Σ_g flux(g, t)
is zero-padded to 1/flo, Fourier transformed, and the lag is
τ(f) = -atan(Im𝔉ψ/(1+Re𝔉ψ))/(2πf) (reverberation.jl:17-45).
`binflux(axis_name=mesh)` reduces its flux, bin range and histogram over a
ray mesh (`gradus_tpu_torch.parallel`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from gradus_tpu_torch.camera.grids import GeometricGrid, LinearGrid
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.camera.planes import PolarPlane
from gradus_tpu_torch.corona.emissivity import emissivity_profile
from gradus_tpu_torch.corona.models import DiscCorona, RingCorona
from gradus_tpu_torch.corona.profiles import AnalyticRadialDiscProfile
from gradus_tpu_torch.corona.samplers import BothHemispheres, EvenSampler, sky_angles_to_velocity
from gradus_tpu_torch.corona.spectra import PowerLawSpectrum
from gradus_tpu_torch.geometry.discs import DatumPlane
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.orbits.special_radii import isco as _isco
from gradus_tpu_torch.parallel.mesh import pmax, pmin, psum
from gradus_tpu_torch.redshift import redshift_pointfunction
from gradus_tpu_torch.transfer.cunningham import transferfunctions
from gradus_tpu_torch.transfer.integration import integrate_lagtransfer, integrate_lagtransfer_timedep
from gradus_tpu_torch.transfer.solvers import find_offset_for_radius
from gradus_tpu_torch.transfer.targets import optimize_for_target, refine_for_target
from gradus_tpu_torch.utils.interp import masked_sorted_interp
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = ["lag_frequency", "continuum_time", "lagtransfer", "binflux"]


def continuum_time(m: AbstractMetric, x, model, rho_factor: float = 1e-3):
    """Coordinate arrival time of the direct corona → observer ray.

    The reference Nelder-Meads (α, β) to minimise the closest approach to the
    source (`optimize_for_target`, precision-solvers.jl:453-546). For an
    on-axis source this is equivalent to root-finding the ray that crosses the
    source's height plane at the source's cylindrical radius, which is
    `find_offset_for_radius` on one ray (a jvp Newton through the lockstep
    solver). Off-axis sources (ring and disc coronae) go through the
    batched pattern search `optimize_for_target`, then two Gauss-Newton
    steps of `refine_for_target`, whose arrival time is differentiable with
    respect to the source's position."""
    x = _as_observer(x, m)
    x_src, _ = model.sample_position_velocity(m)
    x_src = x_src.to(x.dtype)
    if isinstance(model, (RingCorona, DiscCorona)):
        al, be, _, _ = optimize_for_target(x_src[1:4], m, x)
        _, t_star, _ = refine_for_target(x_src[1:4], m, x, torch.stack([al, be]), iters=2)
        return t_star
    z_src = x_src[1] * torch.cos(x_src[2])
    rho_src = torch.maximum(x_src[1] * torch.sin(x_src[2]), rho_factor * x_src[1])
    plane = DatumPlane(z_src, dtype=x.dtype, device=x.device)
    _, gp, _ = find_offset_for_radius(
        m,
        x,
        plane,
        rho_src.reshape(1),
        torch.full((1,), math.pi / 2, dtype=x.dtype, device=x.device),
    )
    return gp.x[0, 0]


def lag_frequency(*args, **kwargs):
    """Two dispatches (reference parity):

    - lag_frequency(t, flux2d, flo=5e-5) → (freq, τ)
    - lag_frequency(m, x, d, model; ...) → (tbins, bins, flux2d)
    """
    if isinstance(args[0], AbstractMetric):
        return _lag_frequency_model(*args, **kwargs)
    return _lag_frequency_fft(*args, **kwargs)


def _lag_frequency_fft(t, f, flo: float = 5e-5, R: float = 1.0, n_ext: int | None = None):
    """FFT lag spectrum of the impulse response (reverberation.jl:17-45), on
    the device of ``f``. The padded length is worked out on the host with
    numpy, as the JAX package does, unless ``n_ext`` is given."""
    f = torch.as_tensor(f)
    t = torch.as_tensor(t, dtype=f.dtype, device=f.device)
    # impulse response: NaN-tolerant sum over the energy axis
    psi = torch.nansum(f, dim=0) if f.dim() == 2 else f
    if n_ext is None:
        # padded-grid length: len(arange(t₀, 1/flo + dt, dt))
        t_host = t.detach().cpu().numpy()
        dt_host = float(t_host[1] - t_host[0])
        n_ext = len(np.arange(float(t_host.min()), 1.0 / flo + dt_host, dt_host))
    dt = t[1] - t[0]
    psi_ext = psi.new_zeros(n_ext)
    psi_ext[: psi.shape[0]] = psi

    # jnp.fft.fftfreq's k / (d·n)
    k = torch.cat(
        [
            torch.arange(0, (n_ext - 1) // 2 + 1, dtype=f.dtype, device=f.device),
            torch.arange(-(n_ext // 2), 0, dtype=f.dtype, device=f.device),
        ]
    )
    freq = k / (dt * n_ext)
    F = R * torch.fft.fft(psi_ext)
    half = n_ext // 2
    phase = torch.arctan(F.imag[:half] / (1.0 + F.real[:half]))
    tau = phase / (2 * math.pi * freq[:half])
    return freq[:half], -tau


def _lag_frequency_model(
    m: AbstractMetric,
    x,
    d,
    model,
    *,
    n_radii: int = 6000,
    bins=None,
    tbins=None,
    spectrum=PowerLawSpectrum(2.0),
    radii=None,
    n_samples: int = 1000,
    profile_kwargs: dict | None = None,
    **kwargs,
):
    """Emissivity profile, continuum time, transfer functions
    (``kwargs`` go to `transferfunctions`: pass ``backend="cuda"``) and
    `integrate_lagtransfer`, or for a time-dependent profile (ring and disc
    coronae) `integrate_lagtransfer_timedep`, with ``n_radii`` clamped to
    400, loudly; returns (tbins, bins, flux) with zero flux as NaN."""
    x = _as_observer(x, m)
    if bins is None:
        bins = LinearGrid()(0.0, 1.5, 500, dtype=x.dtype, device=x.device)
    if tbins is None:
        tbins = LinearGrid()(0.0, 1000.0, 2000, dtype=x.dtype, device=x.device)
    if radii is None:
        radii = LinearGrid()(_isco(m) + 1e-2, 300.0, 100, dtype=x.dtype, device=x.device)

    prof = emissivity_profile(m, d, model, spectrum, n_samples=n_samples, **(profile_kwargs or {}))
    t0 = continuum_time(m, x, model)
    tfs = transferfunctions(m, x, d, radii=radii, **kwargs)
    if hasattr(prof, "time_emissivity_curve"):
        # ring / disc corona: the flux spread over the ε(t | rₑ) light curve.
        # The time-dependent integrator materialises an (n_radii × n_tbins ×
        # n_bins) tensor, so large n_radii requests are clamped, loudly.
        if n_radii > 400:
            warnings.warn(
                f"integrate_lagtransfer_timedep: clamping n_radii {n_radii} → 400 "
                "(the time-dependent path materialises an n_radii × n_tbins × "
                "n_bins tensor); pass n_radii <= 400 to silence",
                stacklevel=2,
            )
        flux = integrate_lagtransfer_timedep(prof, tfs, bins, tbins, t0=t0, n_radii=min(n_radii, 400))
    else:
        flux = integrate_lagtransfer(prof, tfs, bins, tbins, t0=t0, n_radii=n_radii)
    flux = torch.where(flux == 0, math.nan, flux)
    return tbins, bins, flux


def lagtransfer(m, x, d, model, **kwargs):
    """Observer-to-disc + corona-to-disc combination; binning-method analogue
    of the lag transfer (reference transfer-functions-2d.jl:160-216).
    Returns a dict with the traced components for `binflux`. Keywords:
    ``plane`` (default an 800×800 geometric `PolarPlane` to r = 50),
    ``max_t`` (default 2·r_obs), ``n_samples`` (10⁴) and ``sampler``;
    others are ignored, as in the JAX package."""
    x = _as_observer(x, m)
    plane = kwargs.pop(
        "plane", PolarPlane(GeometricGrid(), Nr=800, Ntheta=800, r_max=50.0, dtype=x.dtype, device=x.device)
    )
    max_t = kwargs.pop("max_t", 2.0 * x[1])
    n_samples = kwargs.pop("n_samples", 10000)
    # sampler=None gives the 1D δ-sweep point-source emissivity profile
    sampler = kwargs.pop("sampler", None)
    prof = emissivity_profile(m, d, model, n_samples=n_samples, sampler=sampler)

    # raw coronal (r, t) hit samples: the reference's `binflux` interpolates
    # arrival times over the traced coronal geodesic points directly
    # (AnalyticRadialDiscProfile(cg), corona/analytic.jl:11-16), not over a
    # binned profile. Without a sampler they come from the golden spiral over
    # both hemispheres, as in the JAX package (whose comment cites the
    # reference's random sampler).
    corona_sampler = sampler or EvenSampler(domain=BothHemispheres())
    x_src, v_src = model.sample_position_velocity(m)
    idx = torch.arange(1, n_samples + 1, dtype=x.dtype, device=x.device)
    elev, az = corona_sampler.sample_angles(idx, n_samples)
    v_c = sky_angles_to_velocity(m, x_src, v_src, elev, az)
    gps_c = trace_geodesics(
        m,
        x_src.expand_as(v_c),
        v_c,
        (0.0, max_t),
        geometry=d,
        terminate_fns=(domain_upper_hemisphere(),),
        constrain=False,
    )
    hit_c = gps_c.status == StatusCodes.IntersectedWithGeometry
    r_c = torch.where(hit_c, equatorial_project(gps_c.x), math.inf)
    order = torch.argsort(r_c, stable=True)
    corona_r = r_c[order]
    corona_t = gps_c.x[..., 0][order]
    corona_n = hit_c.sum()

    alpha, beta = plane.impact_parameters()
    areas = plane.unnormalized_areas()
    v = map_impact_parameters(m, x, alpha, beta)
    gps = trace_geodesics(
        m,
        x.expand_as(v),
        v,
        (0.0, max_t),
        geometry=d,
        chart_outer=1.1 * float(x[1]),
        terminate_fns=(domain_upper_hemisphere(),),
    )
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    return dict(
        max_t=max_t,
        x=x,
        areas=areas,
        profile=prof,
        points=gps,
        hit=hit,
        metric=m,
        corona_r=corona_r,
        corona_t=corona_t,
        corona_n=corona_n,
    )


def binflux(
    tf: dict,
    profile=None,
    E0: float = 6.4,
    N_E: int = 300,
    N_t: int = 300,
    e_bins=None,
    t_bins=None,
    axis_name=None,
):
    """Bin the lag transfer into (t, E) flux (reference `binflux`,
    transfer-functions-2d.jl:218-241): f = g³·ε·area, normalised to ΣF = 1
    and divided by the bin area, with empty bins NaN. Bin edges come from
    the data unless ``e_bins``/``t_bins`` are given.

    With ``axis_name`` (the port's ray mesh, `parallel.ray_mesh()`, or its
    process group; each rank holding its shard of the plane's rays) the
    flux total, the bin range and the histogram are reduced over the
    ranks, so every rank returns the same bins and histogram."""
    m = tf["metric"]
    gps = tf["points"]
    hit = tf["hit"]
    if profile is None:
        # reference default (transfer-functions-2d.jl:217-220): ε(r) = r⁻³
        # with coordinate times interpolated over the raw traced coronal
        # geodesic points, clamped outside their radial range
        # (AnalyticRadialDiscProfile(cg), corona/analytic.jl:11-33)
        def t_fn(r):
            return masked_sorted_interp(r, tf["corona_r"], tf["corona_t"], tf["corona_n"])

        prof = AnalyticRadialDiscProfile(lambda r: r**-3.0, t_fn)
    else:
        prof = profile
    r = equatorial_project(gps.x)
    t = prof.coordtime_at(r) + gps.x[..., 0]
    eps = prof.emissivity_at(r)
    pf = redshift_pointfunction(m, tf["x"])
    g = pf(m, gps, tf["max_t"])
    f = torch.where(hit, g**3 * eps * tf["areas"], 0.0)
    total = f.sum()
    if axis_name is not None:
        total = psum(total, axis_name)
    F = f / total

    E = g * E0
    msk = hit & torch.isfinite(t) & torch.isfinite(E)

    def _linspace_over(v, n):
        lo = torch.where(msk, v, math.inf).min()
        hi = torch.where(msk, v, -math.inf).max()
        if axis_name is not None:
            lo, hi = pmin(lo, axis_name), pmax(hi, axis_name)
        return LinearGrid()(lo, hi, n)

    if e_bins is None:
        e_bins = _linspace_over(E, N_E)
    else:
        e_bins = torch.as_tensor(e_bins, dtype=E.dtype, device=E.device)
        N_E = e_bins.shape[0]
    if t_bins is None:
        t_bins = _linspace_over(t, N_t)
    else:
        t_bins = torch.as_tensor(t_bins, dtype=t.dtype, device=t.device)
        N_t = t_bins.shape[0]

    ie = torch.clamp(torch.searchsorted(e_bins, E.contiguous(), right=True) - 1, 0, N_E - 2)
    it = torch.clamp(torch.searchsorted(t_bins, t.contiguous(), right=True) - 1, 0, N_t - 2)
    flat = (ie * (N_t - 1) + it).reshape(-1)
    w = torch.where(msk, F, 0.0).reshape(-1)
    H = w.new_zeros((N_E - 1) * (N_t - 1)).index_add_(0, flat, w).reshape(N_E - 1, N_t - 1)
    if axis_name is not None:
        H = psum(H, axis_name)
    de = e_bins[1] - e_bins[0]
    dt = t_bins[1] - t_bins[0]
    H = H / (de * dt)
    H = torch.where(H == 0, math.nan, H)
    return t_bins - tf["x"][1], e_bins, H
