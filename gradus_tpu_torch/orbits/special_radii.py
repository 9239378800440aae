"""Special radii (counterpart of `gradus_tpu/orbits/special_radii.py`, the
ISCO).

The generic ISCO solves dE/dr = 0 with a derivative from AD: a bracketing
scan, bisection and a Newton polish, in the metric's dtype. ``jax.grad``
becomes `torch.func.grad`; the Newton step differentiates dE/dr once more
(a nested grad over the jvp of `metric_jacobian`).
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import _linspace
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.orbits.circular import CircularOrbits

__all__ = ["isco"]


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
