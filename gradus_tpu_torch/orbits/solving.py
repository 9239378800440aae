"""Numerical orbit solving for metrics where the analytic circular-orbit
assumptions break (counterpart of `gradus_tpu/orbits/solving.py`).

Reference: `src/orbits/orbit-solving.jl:1-97` (golden-section over v^φ
minimising the radial deviation of a traced orbit), the NoZ off-equatorial
orbit angle (`src/metrics/noz-metric.jl:124-199`) and the charged circular
orbits of Kerr-Newman (`kerr-newman-ad.jl:113-147`). Every function is
elementwise over a tensor of radii; each golden-section probe is one
batched `trace_geodesics` of all of them.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.geodesics.equation import metric_jacobian
from gradus_tpu_torch.integrate.tracing import trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.orbits.circular import CircularOrbits

__all__ = [
    "solve_equatorial_circular_orbit",
    "solve_orbit_theta",
    "charged_circular_orbit_omega",
]

_GR = 0.6180339887498949


def _radii(m, r):
    """``r`` as a float tensor in the metric's dtype on its device."""
    b = next(m.buffers(), None)
    if torch.is_tensor(r) and r.is_floating_point():
        return r
    return torch.as_tensor(r, dtype=torch.float64 if b is None else b.dtype, device=m.device)


def _orbit_deviation(m, r, vphi, lam: float, chart_outer):
    """Endpoint radial deviation of a timelike orbit launched tangentially."""
    z = torch.zeros_like(r)
    x = torch.stack([z, r, torch.full_like(r, math.pi / 2), z], dim=-1)
    v = torch.stack([z, z, z, vphi], dim=-1)
    gp = trace_geodesics(m, x, v, (0.0, lam), mu=1.0, chart_outer=chart_outer)
    return torch.abs(gp.x[..., 1] - r) + torch.abs(gp.x[..., 2] - math.pi / 2) * r


def solve_equatorial_circular_orbit(m: AbstractMetric, r, lam: float = 100.0, iters: int = 30, window: float = 0.1):
    """Golden-section over v^φ minimising the traced orbit's radial deviation
    (reference `solve_equatorial_circular_orbit`), from a bracket of ±
    ``window`` around the analytic Ω-derived v^φ; one batched trace of all
    the radii a probe."""
    r = torch.atleast_1d(_radii(m, r))
    chart_outer = 10.0 * (float(r.max()) + 100.0)
    v_analytic = CircularOrbits.fourvelocity(m, (r, torch.full_like(r, math.pi / 2)))[..., 3]
    a = v_analytic * (1.0 - window)
    b = v_analytic * (1.0 + window)
    c = b - _GR * (b - a)
    e = a + _GR * (b - a)
    fc = _orbit_deviation(m, r, c, lam, chart_outer)
    fe = _orbit_deviation(m, r, e, lam, chart_outer)
    for _ in range(iters):
        left = fc < fe
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, e, b)
        c2 = torch.where(left, b2 - _GR * (b2 - a2), e)
        e2 = torch.where(left, c, a2 + _GR * (b2 - a2))
        fp = _orbit_deviation(m, r, torch.where(left, c2, e2), lam, chart_outer)
        fc, fe = torch.where(left, fp, fe), torch.where(left, fc, fp)
        a, b, c, e = a2, b2, c2, e2
    return 0.5 * (a + b)


def solve_orbit_theta(m: AbstractMetric, r, bisect_iters: int = 60):
    """Off-equatorial circular orbit angle θ(r): root of
    ∂_θ g_tt + 2Ω ∂_θ g_tφ + Ω² ∂_θ g_φφ = 0 (reference `_solve_orbit_θ`,
    noz-metric.jl:124-137). Vectorised bisection over θ ∈ (0.3, π−0.3)."""
    r = _radii(m, r)

    def objective(theta):
        _, dgr, dgth = metric_jacobian(m, r, theta)
        om = CircularOrbits.omega_analytic(dgr)
        return dgth[..., 0] + 2.0 * dgth[..., 4] * om + dgth[..., 3] * om * om

    a = torch.full_like(r, 0.3)
    b = torch.full_like(r, math.pi - 0.3)
    for _ in range(bisect_iters):
        mid = 0.5 * (a + b)
        same = torch.signbit(objective(mid)) == torch.signbit(objective(a))
        a, b = torch.where(same, mid, a), torch.where(same, b, mid)
    return 0.5 * (a + b)


def charged_circular_orbit_omega(
    m, r, q: float = 0.0, mu: float = 1.0, contra_rotating: bool = False, newton_iters: int = 40
):
    """Charged circular orbit angular velocity for Kerr-Newman: root of
    ½(ω²∂ᵣg_φφ + 2ω∂ᵣg_tφ + ∂ᵣg_tt) + (F^r_φ ω + F^r_t)·g_rr·(q/u^t) = 0
    (reference `CircularOrbits.Ω` override, kerr-newman-ad.jl:113-147), by
    Newton's method, elementwise over ``r``: each radius its own root,
    its derivative by forward mode (the JAX package's ``jax.grad`` of one
    radius)."""
    from gradus_tpu_torch.metrics.kerr_newman import faraday_tensor

    r = _radii(m, r)
    theta = torch.full_like(r, math.pi / 2)
    g, dgr, _ = metric_jacobian(m, r, theta)
    if q == 0.0:
        return CircularOrbits.omega_analytic(dgr, contra_rotating)

    z = torch.zeros_like(r)
    F = faraday_tensor(m, torch.stack([z, r, theta, z], dim=-1))

    def f(om):
        delta = om * om * dgr[..., 3] + 2.0 * om * dgr[..., 4] + dgr[..., 0]
        arg = -(om * om * g[..., 3] + 2.0 * om * g[..., 4] + g[..., 0]) / mu**2
        inv_ut = torch.sign(arg) * torch.sqrt(torch.abs(arg))
        return 0.5 * delta + (F[..., 1, 3] * om + F[..., 1, 0]) * g[..., 1] * q * inv_ut

    om = (-1.0 if contra_rotating else 1.0) * r / 100.0
    ones = torch.ones_like(om)
    for _ in range(newton_iters):
        val, dval = torch.func.jvp(f, (om,), (ones,))
        om = om - val / torch.where(torch.abs(dval) < 1e-30, 1.0, dval)
    return om
