"""First-order Kerr geodesics via Carter constants (counterpart of
`gradus_tpu/metrics/kerr_first_order.py`; reference
`src/metrics/kerr-metric-first-order.jl`).

The reference integrates the 4-position with velocities reconstructed from
(E, L, Q) and flips the radial/angular signs with callbacks at the turning
points. The JAX package, and this port, integrate in **Mino time** τ
(dλ = Σ dτ), where the Carter equations separate and the second-order form

    d²r/dτ² = ½ R'(r),    d²θ/dτ² = ½ Θ'(θ),
    dt/dτ = (r²+a²)/Δ·[E(r²+a²) − aL] + a(L − aE sin²θ),
    dφ/dτ = a/Δ·[E(r²+a²) − aL] + L/sin²θ − aE,

is smooth through turning points: no sign logic, no callbacks, no AD in
the loop. The affine parameter is carried as an extra state component
(dλ/dτ = Σ), so λ-domain semantics match the second-order tracer.

State: u = (t, r, θ, φ, p_r, p_θ, λ) with p = d(r, θ)/dτ, on the lockstep
solver (`integrate/solver.py::integrate_rays`); on the card its loop
replays a CUDA graph.
"""

from __future__ import annotations

import torch

from gradus_tpu_torch import config as _config
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.metrics.kerr import KerrMetric, kerr_isco

__all__ = ["KerrSpacetimeFirstOrder", "carter_constants", "trace_geodesics_first_order"]


class KerrSpacetimeFirstOrder(AbstractMetric):
    """Kerr via the first-order Carter formalism; shares the Boyer-Lindquist
    components with `KerrMetric`.

    Its Jacobian is the AD one of those components, as in the JAX package,
    so the plain right-hand side differentiates them. The CUDA integrator
    runs it as Kerr, with Kerr's hand-derived Jacobian: the two agree to
    5e-12 relative (`tests/test_metrics.py:118-134`), far inside the
    integrator's tolerance, and the dual-number path would cost ~2× per
    step for the same geodesics."""

    def __init__(self, M=1.0, a=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a)

    def components5(self, r, theta):
        return KerrMetric.components5(self, r, theta)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)

    def isco(self):
        return kerr_isco(self.M, self.a)


def carter_constants(m, x, v, mu=0.0):
    """(E, L, Q) from a position/velocity pair (reference `calc_lq` and the
    conserved quantities, kerr-metric-first-order.jl:228-310)."""
    g = m.metric(x)
    E = -(g[..., 0, 0] * v[..., 0] + g[..., 0, 3] * v[..., 3])
    L = g[..., 3, 3] * v[..., 3] + g[..., 0, 3] * v[..., 0]
    theta = x[..., 2]
    p_theta = g[..., 2, 2] * v[..., 2]  # = Σ v^θ (g_θθ = Σ)
    cos2 = torch.cos(theta) ** 2
    Q = p_theta**2 + cos2 * (m.a**2 * (mu**2 - E**2) + L**2 / torch.sin(theta) ** 2)
    return E, L, Q


def _potential_R(m, E, L, Q, mu, r):
    a = m.a
    delta = r * r - 2.0 * m.M * r + a * a
    P = E * (r * r + a * a) - a * L
    return P * P - delta * ((L - a * E) ** 2 + Q + mu * mu * r * r)


def _potential_Theta(m, E, L, Q, mu, theta):
    a = m.a
    cos2 = torch.cos(theta) ** 2
    sin2 = torch.sin(theta) ** 2
    return Q - cos2 * (a * a * (mu * mu - E * E) + L * L / sin2)


def make_first_order_rhs(m: KerrSpacetimeFirstOrder, E, L, Q, mu=0.0):
    """RHS over (..., 7) Mino-time states; ``E``, ``L``, ``Q`` per ray."""
    a = m.a

    def f(u):
        r = u[..., 1]
        theta = u[..., 2]
        pr = u[..., 4]
        pth = u[..., 5]
        sin2 = torch.sin(theta) ** 2
        cos2 = 1.0 - sin2
        sigma = r * r + a * a * cos2
        delta = r * r - 2.0 * m.M * r + a * a
        P = E * (r * r + a * a) - a * L

        dt = (r * r + a * a) / delta * P + a * (L - a * E * sin2)
        dphi = a / delta * P + L / sin2 - a * E

        # d/dr R(r): analytic derivative of the quartic
        dRdr = (
            4.0 * E * r * P
            - (2.0 * r - 2.0 * m.M) * ((L - a * E) ** 2 + Q + mu * mu * r * r)
            - delta * 2.0 * mu * mu * r
        )
        # d/dθ Θ(θ)
        sincos = torch.sin(theta) * torch.cos(theta)
        dThdth = 2.0 * sincos * (a * a * (mu * mu - E * E) + L * L / sin2) + cos2 * (
            2.0 * L * L * torch.cos(theta) / (sin2 * torch.sin(theta))
        )
        return torch.stack([dt, pr, pth, dphi, 0.5 * dRdr, 0.5 * dThdth, sigma], dim=-1)

    return f


def trace_geodesics_first_order(
    m: KerrSpacetimeFirstOrder,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    mu: float = 0.0,
    geometry=None,
    gtol: float = 1e-2,
    chart_outer: float = 12000.0,
    abstol: float | None = None,
    reltol: float | None = None,
    max_steps: int = 40000,
    mino_span_factor: float = 10.0,
    constrain: bool = True,
):
    """Trace Kerr geodesics with the separated first-order equations, on
    the device of ``x``.

    A ray ends at the chart's bounds, at a geometry hit, or once its
    carried affine parameter reaches ``lam_span[1]`` (a step-end
    terminate function that leaves ``NoStatus``, as a second-order trace
    that reaches λ1 does). Returns a `GeodesicPoint` batch with
    reconstructed 4-velocities (dx/dλ) and ``lam_max`` the carried λ."""
    from gradus_tpu_torch.geodesics.equation import constrain_all
    from gradus_tpu_torch.integrate.points import GeodesicPoint
    from gradus_tpu_torch.integrate.solver import integrate_rays
    from gradus_tpu_torch.integrate.status import StatusCodes
    from gradus_tpu_torch.integrate.tracing import _geometry_events, _rays

    single, x, v = _rays(m, geometry, x, v)
    if constrain:
        v = constrain_all(m, x, v, mu=mu)
    a_tol, r_tol = _config.default_tols(x.dtype)

    E, L, Q = carter_constants(m, x, v, mu)
    f = make_first_order_rhs(m, E, L, Q, mu)

    sigma0 = x[..., 1] ** 2 + m.a**2 * torch.cos(x[..., 2]) ** 2
    lam0 = torch.full(x.shape[:-1], float(lam_span[0]), dtype=x.dtype, device=x.device)
    u0 = torch.cat([x, (sigma0 * v[..., 1])[..., None], (sigma0 * v[..., 2])[..., None], lam0[..., None]], dim=-1)

    # λ-domain termination via the carried affine parameter
    lam_max = float(lam_span[1])

    def lam_done(y, lam):
        return y[..., 6] >= lam_max

    # Mino-time span: a hard upper bound only — every ray ends on its own
    # (chart exit, geometry hit, or λ ≥ λ_max), and the adaptive dτ makes
    # unused span free. dλ = Σ dτ with Σ ≥ r_horizon² ≳ 1 along any
    # escaping-or-plunging trajectory, so factor·Δλ/r_h² is the per-ray-safe
    # bound (gradus_tpu/metrics/kerr_first_order.py:187-200).
    r_h = torch.clamp(m.inner_radius(), min=1.0)
    tau_max = mino_span_factor * (lam_span[1] - lam_span[0]) / (r_h * r_h) + 1.0

    result = integrate_rays(
        f,
        u0,
        (0.0, tau_max),
        abstol=a_tol if abstol is None else abstol,
        reltol=r_tol if reltol is None else reltol,
        r_inner=m.inner_radius() * 1.01,
        r_outer=chart_outer,
        terminate_fns=((lam_done, StatusCodes.NoStatus),),
        max_steps=max_steps,
        **({} if geometry is None else _geometry_events(geometry, gtol)),
    )

    y = result.y
    r_f = y[..., 1]
    th_f = y[..., 2]
    sigma = r_f**2 + m.a**2 * torch.cos(th_f) ** 2
    delta = r_f**2 - 2.0 * m.M * r_f + m.a**2
    P = E * (r_f**2 + m.a**2) - m.a * L
    sin2 = torch.sin(th_f) ** 2
    v_f = torch.stack(
        [
            ((r_f**2 + m.a**2) / delta * P + m.a * (L - m.a * E * sin2)) / sigma,
            y[..., 4] / sigma,
            y[..., 5] / sigma,
            (m.a / delta * P + L / sin2 - m.a * E) / sigma,
        ],
        dim=-1,
    )
    gp = GeodesicPoint(
        status=result.status,
        lam_min=torch.full_like(r_f, float(lam_span[0])),
        lam_max=y[..., 6],
        x_init=x,
        v_init=v,
        x=y[..., 0:4],
        v=v_f,
        aux=None,
    )
    return gp[0] if single else gp
