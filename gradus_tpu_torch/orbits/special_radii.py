"""Special radii: ISCO, event horizon, ergosphere (counterpart of
`gradus_tpu/orbits/special_radii.py`; reference `src/special-radii.jl`).

The generic ISCO solves dE/dr = 0 with a derivative from AD: a bracketing
scan, bisection and a Newton polish, in the metric's dtype. ``jax.grad``
becomes `torch.func.grad`; the Newton step differentiates dE/dr once more
(a nested grad over the jvp of `metric_jacobian`).

The horizon and the ergosphere are, for each θ of a grid, the outermost
root of a condition in r: the reference's ``jax.vmap`` over θ becomes one
scan over a (θ, 512) grid of radii and one bisection of all the θ at once.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import _linspace
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.orbits.circular import CircularOrbits

__all__ = ["isco", "event_horizon", "ergosphere", "is_naked_singularity"]


def _dE_dr(m: AbstractMetric, r):
    """dE/dr of the equatorial circular orbit, elementwise over ``r``."""

    def E(r_):
        return CircularOrbits.energy(m, (r_, torch.full_like(r_, math.pi / 2))).sum()

    return torch.func.grad(E)(r)


def isco(
    m: AbstractMetric,
    lower_bound=None,
    upper_bound=None,
    n_scan: int = 512,
    max_upper_bound: float = 100.0,
    bisect_iters: int = 60,
    newton_iters: int = 3,
):
    """ISCO radius via dE/dr = 0 (reference special-radii.jl:14-40).

    Metrics with an analytic ISCO (Kerr) override `m.isco()`; this generic
    path scans (inner_radius, max_upper_bound] for the last sign change of
    dE/dr, bisects, then Newton-polishes."""
    if type(m).isco is not AbstractMetric.isco:
        return m.isco()

    r_in = m.inner_radius()
    kw = dict(dtype=r_in.dtype, device=r_in.device)
    lo = r_in * 1.02 if lower_bound is None else torch.as_tensor(lower_bound, **kw)
    hi = torch.as_tensor(max_upper_bound if upper_bound is None else upper_bound, **kw)

    rs = _linspace(lo, hi, n_scan)
    dE = _dE_dr(m, rs)
    dE = torch.where(torch.isfinite(dE), dE, 1.0)
    # the LAST sign change (outermost stable boundary): scan from outside
    change = torch.signbit(dE[:-1]) != torch.signbit(dE[1:])
    last = n_scan - 2 - change.flip(0).to(torch.uint8).argmax()
    idx = torch.where(change.any(), last, 0)
    a, b = rs[idx], rs[idx + 1]

    for _ in range(bisect_iters):
        mid = 0.5 * (a + b)
        d_mid, d_a = _dE_dr(m, torch.stack([mid, a]))
        same = torch.signbit(d_mid) == torch.signbit(d_a)
        a, b = torch.where(same, mid, a), torch.where(same, b, mid)
    r = 0.5 * (a + b)

    slope_and_value = torch.func.grad_and_value(lambda rr: _dE_dr(m, rr))
    for _ in range(newton_iters):
        df, f = slope_and_value(r)
        r = r - f / torch.where(torch.abs(df) < 1e-30, 1.0, df)
    return r


def _horizon_condition(m: AbstractMetric, r, theta):
    """g^rr = 1/g_rr crosses zero at the horizon. Equivalent to the
    reference's g_tφ² − g_tt·g_φφ condition (special-radii.jl:60-100) —
    both ∝ Δ for Kerr — but stays regular at the poles where g_φφ → 0."""
    return 1.0 / m.components(r, theta)[..., 1]


def _ergosphere_condition(m: AbstractMetric, r, theta):
    return m.components(r, theta)[..., 0]


def _root_over_theta(m, cond_fn, thetas, r_max, bisect_iters=60):
    """For each θ of ``thetas`` (T,), the outermost root of cond(r, θ) in
    (0, r_max] by bisection (NaN where the scan finds no sign change)."""
    kw = dict(dtype=thetas.dtype, device=thetas.device)
    n = 512
    rs = _linspace(torch.tensor(1e-3, **kw), torch.tensor(float(r_max), **kw), n)
    c = cond_fn(m, rs[None, :], thetas[:, None])  # (T, n)
    change = torch.signbit(c[:, :-1]) != torch.signbit(c[:, 1:])
    found = change.any(dim=1)
    last = n - 2 - change.flip(1).to(torch.uint8).argmax(dim=1)
    idx = torch.where(found, last, 0)
    a, b = rs[idx], rs[idx + 1]
    for _ in range(bisect_iters):
        mid = 0.5 * (a + b)
        same = torch.signbit(cond_fn(m, mid, thetas)) == torch.signbit(cond_fn(m, a, thetas))
        a, b = torch.where(same, mid, a), torch.where(same, b, mid)
    return torch.where(found, 0.5 * (a + b), math.nan)


def _theta_grid(m, resolution):
    """θ ∈ [0, π] at ``resolution`` points, in the metric's dtype (f64 for
    a metric without parameters) on its device."""
    b = next(m.buffers(), None)
    kw = dict(dtype=torch.float64, device=m.device) if b is None else dict(dtype=b.dtype, device=b.device)
    return _linspace(torch.tensor(0.0, **kw), torch.tensor(math.pi, **kw), resolution)


def event_horizon(m: AbstractMetric, resolution: int = 100, r_max: float = 10.0):
    """(r(θ), θ) shape of the event horizon (reference `event_horizon`,
    special-radii.jl:102-131), in the metric's dtype on its device."""
    thetas = _theta_grid(m, resolution)
    return _root_over_theta(m, _horizon_condition, thetas, r_max), thetas


def ergosphere(m: AbstractMetric, resolution: int = 100, r_max: float = 10.0):
    """(r(θ), θ) of the ergosphere surface g_tt = 0
    (reference special-radii.jl:133-147)."""
    thetas = _theta_grid(m, resolution)
    return _root_over_theta(m, _ergosphere_condition, thetas, r_max), thetas


def is_naked_singularity(m: AbstractMetric, resolution: int = 100) -> bool:
    """True if the horizon condition has no root for some θ
    (reference special-radii.jl:149-157): one read on the host."""
    rs, _ = event_horizon(m, resolution)
    return bool(torch.isnan(rs).any())
