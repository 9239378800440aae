"""Geodesic acceleration from the metric Jacobian, and the null/timelike
constraint (counterpart of `gradus_tpu/geodesics/equation.py`).

For a static axis-symmetric metric (∂_t g = ∂_φ g = 0) the geodesic equation

    a^μ = -Γ^μ_{νσ} v^ν v^σ,
    Γ^μ_{νσ} = ½ g^{μρ} (∂_ν g_{ρσ} + ∂_σ g_{ρν} − ∂_ρ g_{νσ})

reduces (using the v↔v symmetry) to

    a^μ = -g^{μρ} [ (v^r ∂_r g_{ρσ} + v^θ ∂_θ g_{ρσ}) v^σ
                    − ½ δ_ρ∈{r,θ} (v ∂_ρ g v) ].
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = [
    "metric_jacobian",
    "metric_jacobian5",
    "geodesic_equation",
    "geodesic_acceleration",
    "constrain_time",
    "constrain",
    "constrain_all",
]


def _float_rtheta(r, theta):
    """``r`` and ``theta`` as float tensors (f64 unless given), broadcast."""
    r, theta = (
        v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=torch.float64)
        for v in (r, theta)
    )
    dtype = torch.result_type(r, theta)
    if not dtype.is_floating_point:
        dtype = torch.float64
    return torch.broadcast_tensors(r.to(dtype), theta.to(dtype))


def metric_jacobian(m: AbstractMetric, r, theta):
    """Value + (∂_r, ∂_θ) of the 5 metric components, each stacked on a
    trailing axis of 5, in two forward-mode passes (reference
    `metric_jacobian`, auto-diff.jl:206-211)."""
    r, theta = _float_rtheta(r, theta)
    ones, zeros = torch.ones_like(r), torch.zeros_like(r)
    g, dg_dr = torch.func.jvp(m.components, (r, theta), (ones, zeros))
    _, dg_dtheta = torch.func.jvp(m.components, (r, theta), (zeros, ones))
    return g, dg_dr, dg_dtheta


def metric_jacobian5(m: AbstractMetric, r, theta):
    """Component-tuple form of `metric_jacobian`: three 5-tuples of tensors
    (values, ∂_r, ∂_θ), from the metric's own (possibly hand-derived)
    `components5_jac`."""
    r, theta = _float_rtheta(r, theta)
    return m.components5_jac(r, theta)


def metric_jacobian_r(m: AbstractMetric, r, theta):
    """Value + ∂_r of the 5 metric components: `metric_jacobian`'s first
    forward-mode pass alone (the same bits), for the callers that need no
    ∂_θ."""
    r, theta = _float_rtheta(r, theta)
    return torch.func.jvp(m.components, (r, theta), (torch.ones_like(r), torch.zeros_like(r)))


def geodesic_equation(m: AbstractMetric, x, v):
    """Four-acceleration a^μ = -Γ^μ_{νσ} v^ν v^σ at position ``x`` with
    velocity ``v`` (both (..., 4))."""
    acc = geodesic_acceleration(
        m, x[..., 1], x[..., 2], v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    )
    return torch.stack(acc, dim=-1)


def geodesic_acceleration(m: AbstractMetric, r, th, vt, vr, vth, vph):
    """Component-form four-acceleration: 4-tuple of tensors from 6 coordinate /
    velocity tensors. Shared by the array API above and the plain version of
    the integrator kernel (state-major layout, `integrate/cuda_solver.py`)."""
    g, dgr, dgth = m.components5_jac(r, th)

    g_tt, g_rr, g_thth, g_phph, g_tph = g
    det = g_tt * g_phph - g_tph * g_tph
    inv_det = 1.0 / det
    gi_tt = g_phph * inv_det
    gi_phph = g_tt * inv_det
    gi_tph = -g_tph * inv_det
    gi_rr = 1.0 / g_rr
    gi_thth = 1.0 / g_thth

    def Av(J):
        """(J v)_ρ for a 5-component symmetric matrix J."""
        J_tt, J_rr, J_thth, J_phph, J_tph = J
        Jv_t = J_tt * vt + J_tph * vph
        Jv_r = J_rr * vr
        Jv_th = J_thth * vth
        Jv_ph = J_tph * vt + J_phph * vph
        q = vt * Jv_t + vr * Jv_r + vth * Jv_th + vph * Jv_ph
        return Jv_t, Jv_r, Jv_th, Jv_ph, q

    J1v_t, J1v_r, J1v_th, J1v_ph, q1 = Av(dgr)
    J2v_t, J2v_r, J2v_th, J2v_ph, q2 = Av(dgth)

    A_t = vr * J1v_t + vth * J2v_t
    A_r = vr * J1v_r + vth * J2v_r - 0.5 * q1
    A_th = vr * J1v_th + vth * J2v_th - 0.5 * q2
    A_ph = vr * J1v_ph + vth * J2v_ph

    a_t = -(gi_tt * A_t + gi_tph * A_ph)
    a_r = -gi_rr * A_r
    a_th = -gi_thth * A_th
    a_ph = -(gi_tph * A_t + gi_phph * A_ph)
    return a_t, a_r, a_th, a_ph


def constrain_time(g_comps, v, mu=0.0, positive: bool = True):
    """Solve g_{σν} v^σ v^ν = -μ² for v^t."""
    g1, g2, g3, g4, g5 = g_comps.unbind(-1)
    disc = (
        -g1 * g2 * v[..., 1] ** 2
        - g1 * g3 * v[..., 2] ** 2
        - g1 * mu**2
        - (g1 * g4 - g5 * g5) * v[..., 3] ** 2
    )
    root = torch.sqrt(disc)
    if positive:
        return -(g5 * v[..., 3] + root) / g1
    return -(g5 * v[..., 3] - root) / g1


def constrain(m: AbstractMetric, x, v, mu=0.0):
    """v^t such that the velocity satisfies the norm constraint at ``x``."""
    g = m.components(x[..., 1], x[..., 2])
    return constrain_time(g, v, mu)


def constrain_all(m: AbstractMetric, x, v, mu=0.0):
    """Replace the time component of ``v`` with the constrained value."""
    vt = constrain(m, x, v, mu)
    return torch.cat([vt[..., None], v[..., 1:]], dim=-1)
