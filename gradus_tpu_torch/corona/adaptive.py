"""Corona adaptive sampling: emissivity from a refined sky (counterpart of
`gradus_tpu/corona/adaptive.py`).

Reference: `src/corona/adaptive-sample.jl`: the `CoronaGridValues` payload
(:1-28), the dual-number emissivity Jacobian (:42-81), `check_refine` on the
g/J disparity (:123-140), `bin_emissivity_grid!` / `bin_redshift_grid!` /
`bin_time_grid!` (:312-440) and the `step_block!` refinement loop (:603+).
As in the JAX package, the quadtree is host numpy (`camera/adaptive.py`)
and each refinement round is one trace on the metric's device.

Per sky cell (cosθ, φ) of the corona's local sky the tracer records

    t, r, φ_disc : hit coordinates on the disc (NaN when the ray missed)
    g            : source→disc energy ratio
    J            : |∂(r, φ_disc)/∂(θ, φ)| / sinθ, the area magnification,
                   from forward-mode tangents through the integrator
    γ, √(g_rr g_φφ) : disc-frame Lorentz factor and proper-area element at
                   the hit radius (so that binning is host numpy)

The JAX package takes the two columns of the Jacobian from two `jax.jvp`
passes through the loop. Rays are independent in the lockstep loop, so
here one trace of 2N rays carries them: the N cells' rays twice, the first
copy with the tangent ∂/∂θ, the second with ∂/∂φ (`trace_geodesics(...,
v_dot=...)`, whose loop on the card replays a CUDA graph). Each ray's
arithmetic is that of its own pass.

Refinement (reference `check_refine`): a cell splits while any neighbour
disagrees in g or J by more than ``rtol`` (2% by default), unless both cells
missed the disc.

Emissivity normalisation: an isotropic unit-luminosity source emits
dN/dΩ = 1/4π in its rest frame, so

    ε(r) = Σ_cells ΔΩ/(4π) · I(g) / (A_proper(bin) · γ),

the form of the Monte-Carlo photon-count binning
(`emissivity.bin_corona_hits`, ε = N·I(g)/(A·γ)) with photon counts replaced
by exact solid-angle weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gradus_tpu_torch.camera.adaptive import AdaptiveGrid2D
from gradus_tpu_torch.corona.spectra import PowerLawSpectrum
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.redshift import keplerian_velocity_projector
from gradus_tpu_torch.utils.jvp import jvp
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = [
    "CoronaSkyTracer",
    "corona_adaptive_sky",
    "bin_emissivity_grid",
    "bin_redshift_grid",
    "bin_time_grid",
    "adaptive_emissivity_profile",
]


class CoronaSkyTracer:
    """Batched (cosθ, φ) → CoronaGridValues tracer for one (metric, disc,
    corona) triple: numpy in, numpy out, one trace of 2N rays a call (the
    JAX package pads each call to a power-of-two bucket for its compile
    cache; the port traces the N cells' rays alone)."""

    def __init__(self, m: AbstractMetric, d, model, *, lam_max: float = 10000.0, chart_outer: float = 12000.0):
        self.m, self.d = m, d
        self.lam_max, self.chart_outer = lam_max, chart_outer
        self.x_src, self.v_src = model.sample_position_velocity(m)
        self.disc_velocity = keplerian_velocity_projector(m)
        self.n_traced = 0

    def _eval(self, th, ph):
        """The cells' values (tensors, NaN off the disc) and statuses."""
        from gradus_tpu_torch.corona.emissivity import energy_ratio, lorentz_factor
        from gradus_tpu_torch.corona.samplers import sky_angles_to_velocity

        m, x_src, v_src = self.m, self.x_src, self.v_src
        n = th.shape[0]
        one, zero = torch.ones_like(th), torch.zeros_like(th)
        v, v_dot = jvp(
            lambda a, b: sky_angles_to_velocity(m, x_src, v_src, a, b),
            (torch.cat([th, th]), torch.cat([ph, ph])),
            (torch.cat([one, zero]), torch.cat([zero, one])),
        )
        gp, gp_dot = trace_geodesics(
            m,
            x_src.expand_as(v),
            v,
            (0.0, self.lam_max),
            geometry=self.d,
            chart_outer=self.chart_outer,
            terminate_fns=(domain_upper_hemisphere(),),
            constrain=False,
            v_dot=v_dot,
        )
        r2, dr2 = jvp(equatorial_project, (gp.x,), (gp_dot.x,))
        # the first copy carries ∂/∂θ, the second ∂/∂φ (the JAX package's
        # two passes, adaptive-sample.jl:42-81)
        r, phid = r2[:n], gp.x[:n, 3]
        dr_dth, dr_dph = dr2[:n], dr2[n:]
        dphi_dth, dphi_dph = gp_dot.x[:n, 3], gp_dot.x[n:, 3]
        gp = gp[:n]
        v_disc = self.disc_velocity(gp.x)
        g = energy_ratio(m, gp, v_src, v_disc)
        gam = lorentz_factor(m, gp.x, v_disc)
        det = torch.abs(dr_dth * dphi_dph - dr_dph * dphi_dth)
        J = det / torch.sin(th)
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        comp = m.components(r, torch.full_like(r, math.pi / 2))
        area_el = torch.sqrt(comp[..., 1] * comp[..., 3])
        out = dict(
            t=gp.x[..., 0],
            r=r,
            phi=phid,
            g=g,
            J=J,
            gamma=gam,
            area_el=area_el,
            # radial footprint derivatives: each sky cell's image on the
            # disc spans ≈ |∂r/∂θ|Δθ + |∂r/∂φ|Δφ in radius, which smears the
            # deposited flux across radial bins
            dr_dth=torch.abs(dr_dth),
            dr_dph=torch.abs(dr_dph),
        )
        return {k: torch.where(hit, v, math.nan) for k, v in out.items()}, gp.status

    def __call__(self, cos_th, phi):
        cos_th = np.asarray(cos_th, dtype=np.float64)
        phi = np.asarray(phi, dtype=np.float64)
        self.n_traced += cos_th.shape[0]
        like = dict(dtype=self.x_src.dtype, device=self.x_src.device)
        th = torch.as_tensor(np.arccos(np.clip(cos_th, -1.0, 1.0)), **like)
        out, status = self._eval(th, torch.as_tensor(phi, **like))
        vals = {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}
        vals["status"] = status.cpu().numpy()
        return vals


def _merge(kept: dict, new: dict) -> dict:
    return {k: np.concatenate([kept[k], new[k]]) for k in kept}


def corona_adaptive_sky(
    m: AbstractMetric,
    d,
    model,
    *,
    n0: int = 24,
    rounds: int = 4,
    max_depth: int = 8,
    rtol: float = 0.02,
    max_refine: int | None = None,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
    tracer: CoronaSkyTracer | None = None,
    progress=None,
):
    """Adaptively sample the corona's local sky (reference `AdaptiveSky`
    specialisation + the `step_block!` loop, adaptive-sample.jl:140-178, 603+).

    Returns ``(grid, vals, n_traced)``: the leaf-cell quadtree over
    (cosθ ∈ (−1,1), φ ∈ (−π,π)), the per-cell CoronaGridValues dict, and the
    number of cells traced (the adaptive budget; each is two rays of one
    trace)."""
    if tracer is None:
        tracer = CoronaSkyTracer(m, d, model, lam_max=lam_max, chart_outer=chart_outer)
    eps = 1e-6
    grid = AdaptiveGrid2D((-1.0 + eps, 1.0 - eps), (-np.pi, np.pi), n0)
    vals = tracer(grid.cx, grid.cy)

    for rnd in range(rounds):
        score = np.zeros(grid.cx.shape[0])
        # reference check_refine: too coarse when g or J disagree with a
        # neighbour by > rtol (both-miss pairs never refine: NaN vs NaN
        # disparity is 0 in neighbour_disparity, NaN vs finite is +inf)
        for field in ("g", "J"):
            grid.values = vals[field]
            disp = grid.neighbour_disparity()
            scale = np.abs(vals[field])
            scale = np.where(np.isfinite(scale), scale, 0.0)
            rel = disp / np.maximum(rtol * np.maximum(scale, 1e-30), 1e-300)
            score = np.maximum(score, rel)
        refine = (score > 1.0) & (grid.depth < max_depth)
        if max_refine is not None and refine.sum() > max_refine:
            # budget cap (reference `limit` on step_block!): split exactly the
            # max_refine worst offenders (ties, e.g. the +inf hit/miss
            # boundary scores, broken by `argpartition` as in the JAX
            # package; later rounds catch the rest)
            masked = np.where(refine, score, -np.inf)
            top = np.argpartition(-masked, max_refine - 1)[:max_refine]
            refine = np.zeros_like(refine)
            refine[top[masked[top] > 1.0]] = True
        if progress is not None:
            progress(
                dict(round=rnd, cells=int(grid.cx.shape[0]), refining=int(refine.sum()), traced=int(tracer.n_traced))
            )
        if not refine.any():
            break
        keep = ~refine
        kept_vals = {k: v[keep] for k, v in vals.items()}
        n_new = grid.refine(refine)
        new_vals = tracer(grid.cx[-n_new:], grid.cy[-n_new:])
        vals = _merge(kept_vals, new_vals)

    grid.values = vals["g"]
    return grid, vals, tracer.n_traced


def _bin_weighted(grid, vals, r_bins, phi_bins, quantity):
    """ΔΩ-weighted scatter of a per-cell quantity into (r, φ) bins; returns
    (sum, solid_angle) grids (reference bin_*_grid! accumulate/normalise
    split, adaptive-sample.jl:312-440)."""
    r = vals["r"]
    hit = np.isfinite(r) & np.isfinite(quantity)
    d_omega = grid.w * grid.h  # the grid is over (cosθ, φ): Δcosθ·Δφ = ΔΩ
    r_i = np.searchsorted(r_bins, r[hit], side="right") - 1
    p_i = np.searchsorted(phi_bins, np.mod(vals["phi"][hit], 2 * np.pi), side="right") - 1
    nr, np_ = len(r_bins) - 1, len(phi_bins) - 1
    ok = (r_i >= 0) & (r_i < nr) & (p_i >= 0) & (p_i < np_)
    flat = r_i[ok] * np_ + p_i[ok]
    w = d_omega[hit][ok]
    acc = np.bincount(flat, weights=w * quantity[hit][ok], minlength=nr * np_)
    sa = np.bincount(flat, weights=w, minlength=nr * np_)
    return acc.reshape(nr, np_), sa.reshape(nr, np_)


def _proper_area_element(m, r):
    """√(g_rr g_φφ) in the equatorial plane at the numpy radii ``r``."""
    b = next(m.buffers(), None)
    dtype = torch.float64 if b is None else b.dtype
    rt = torch.as_tensor(r, dtype=dtype, device=m.device)
    comp = m.components(rt, torch.full_like(rt, math.pi / 2)).cpu().numpy()
    return np.sqrt(comp[..., 1] * comp[..., 3])


def bin_emissivity_grid(m: AbstractMetric, grid, vals, r_bins, phi_bins, spectrum=PowerLawSpectrum(2.0)):
    """(r, φ) emissivity grid from the adaptive sky (reference
    `bin_emissivity_grid!`, adaptive-sample.jl:312-360).

    Flux deposition with footprint smearing: each cell carries the photon
    flux ΔΩ/(4π)·I(g)/γ onto a disc patch centred at (r, φ_disc) of radial
    extent ≈ |∂r/∂θ|Δθ + |∂r/∂φ|Δφ (the forward-mode derivatives through the
    integrator), deposited in proportion over the radial bins it overlaps;
    contributions of several sky branches to the same radii add up.
    ε = deposited flux / proper bin area √(g_rr g_φφ)·Δr·Δφ."""
    r_bins = np.asarray(r_bins)
    phi_bins = np.asarray(phi_bins)
    r = vals["r"]
    hit = np.isfinite(r)
    spec = np.asarray(spectrum(np.nan_to_num(vals["g"], nan=1.0)))
    gam = np.where(np.isfinite(vals["gamma"]), vals["gamma"], 1.0)
    d_omega = grid.w * grid.h  # (cosθ, φ) grid: Δcosθ·Δφ = ΔΩ
    flux = d_omega * spec / (4.0 * np.pi * gam)

    # radial footprint half-span from the derivatives and the cell size
    sin_th = np.sqrt(np.maximum(1.0 - grid.cx**2, 1e-12))
    d_theta = grid.w / sin_th
    span = 0.5 * (np.nan_to_num(vals["dr_dth"]) * d_theta + np.nan_to_num(vals["dr_dph"]) * grid.h)
    span = np.clip(span, 1e-8, (r_bins[-1] - r_bins[0]))

    nr, np_ = len(r_bins) - 1, len(phi_bins) - 1
    p_i = np.searchsorted(phi_bins, np.mod(np.nan_to_num(vals["phi"]), 2 * np.pi), side="right") - 1
    sel = hit & (p_i >= 0) & (p_i < np_) & np.isfinite(flux)
    rc, sc, fc, pc = r[sel], span[sel], flux[sel], p_i[sel]
    lo, hi = rc - sc, rc + sc
    # (cells, bins) proportional overlap of [lo, hi] with each radial bin
    ov = (
        np.clip(np.minimum(hi[:, None], r_bins[None, 1:]) - np.maximum(lo[:, None], r_bins[None, :-1]), 0.0, None)
        / (hi - lo)[:, None]
    )
    acc = np.zeros((nr, np_))
    for j in range(np_):
        msk = pc == j
        if msk.any():
            acc[:, j] = (fc[msk][:, None] * ov[msk]).sum(axis=0)

    # solid-angle coverage map (diagnostic and valid-bin mask)
    _, sa = _bin_weighted(grid, vals, r_bins, phi_bins, np.ones_like(r))

    r_mid = 0.5 * (r_bins[:-1] + r_bins[1:])
    area = (_proper_area_element(m, r_mid) * np.diff(r_bins))[:, None] * np.diff(phi_bins)[None, :]
    return acc / area, sa


def bin_redshift_grid(grid, vals, r_bins, phi_bins):
    """ΔΩ-weighted mean redshift per (r, φ) bin (adaptive-sample.jl:363-405)."""
    acc, sa = _bin_weighted(grid, vals, np.asarray(r_bins), np.asarray(phi_bins), vals["g"])
    return np.where(sa > 0, acc / np.maximum(sa, 1e-300), np.nan), sa


def bin_time_grid(grid, vals, r_bins, phi_bins):
    """ΔΩ-weighted mean arrival time per (r, φ) bin (adaptive-sample.jl:408-450)."""
    acc, sa = _bin_weighted(grid, vals, np.asarray(r_bins), np.asarray(phi_bins), vals["t"])
    return np.where(sa > 0, acc / np.maximum(sa, 1e-300), np.nan), sa


def adaptive_emissivity_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_bins: int = 60,
    r_lims=None,
    **sky_kwargs,
):
    """φ-integrated radial emissivity profile ε(r), t(r) from the adaptive
    sky: the counterpart of the dense Monte-Carlo `tracecorona_profile` at a
    fraction of the ray budget.

    Returns ``(RadialDiscProfile, n_traced)``, the profile on the metric's
    device."""
    from gradus_tpu_torch.corona.profiles import RadialDiscProfile

    grid, vals, n_traced = corona_adaptive_sky(m, d, model, **sky_kwargs)
    r = vals["r"]
    if r_lims is None:
        r_lims = (np.nanmin(r), np.nanmax(r))
    r_bins = np.geomspace(max(r_lims[0], 1e-8), r_lims[1], n_bins + 1)
    phi_bins = np.asarray([0.0, 2 * np.pi])
    eps, sa = bin_emissivity_grid(m, grid, vals, r_bins, phi_bins, spectrum)
    tmean, _ = bin_time_grid(grid, vals, r_bins, phi_bins)
    # profile abscissae are the ΔΩ-weighted mean radii of each bin's cells
    # (bin mid-points would misattribute a steep ε(r) by up to the bin width)
    racc, _ = _bin_weighted(grid, vals, r_bins, phi_bins, vals["r"])
    valid = sa[:, 0] > 0
    r_mid = 0.5 * (r_bins[:-1] + r_bins[1:])
    rbar = np.where(valid, racc[:, 0] / np.maximum(sa[:, 0], 1e-300), r_mid)
    radii = np.where(valid, rbar, np.inf)
    order = np.argsort(radii, kind="stable")
    like = dict(dtype=torch.float64, device=m.device)
    prof = RadialDiscProfile(
        radii=torch.as_tensor(radii[order], **like),
        eps=torch.as_tensor(np.where(valid, eps[:, 0], 0.0)[order], **like),
        t=torch.as_tensor(np.nan_to_num(tmean[:, 0], nan=0.0)[order], **like),
        n=torch.as_tensor(int(valid.sum()), device=m.device),
    )
    return prof, n_traced
