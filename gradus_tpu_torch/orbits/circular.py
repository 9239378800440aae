"""Analytic equatorial circular orbits for any static axis-symmetric metric
(counterpart of `gradus_tpu/orbits/circular.py`): Ω from the radial metric
Jacobian, then the covariant (u_t, u_φ), energy, angular momentum,
four-velocity, and the ISCO plunging four-velocity.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.geodesics.equation import metric_jacobian_r
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.utils.linalg import sym4x4_inverse_components

__all__ = ["CircularOrbits"]


def _rtheta(rtheta):
    if isinstance(rtheta, (tuple, list)):
        return rtheta[0], rtheta[1]
    if not isinstance(rtheta, torch.Tensor):
        rtheta = torch.as_tensor(rtheta, dtype=torch.float64)
    if rtheta.dim() == 0 or rtheta.shape[-1] != 2:
        return rtheta, torch.full_like(rtheta, math.pi / 2)
    return rtheta[..., 0], rtheta[..., 1]


class CircularOrbits:
    """Namespace matching the reference's `CircularOrbits` module."""

    @staticmethod
    def omega_analytic(dg_dr, contra_rotating=False):
        """Ω = (−∂_r g_tφ ± √((∂_r g_tφ)² − ∂_r g_tt ∂_r g_φφ))/∂_r g_φφ
        (reference `_Ω_analytic`, circular-orbits.jl:11-18)."""
        disc = torch.sqrt(dg_dr[..., 4] ** 2 - dg_dr[..., 0] * dg_dr[..., 3])
        if contra_rotating:
            return -(dg_dr[..., 4] + disc) / dg_dr[..., 3]
        return -(dg_dr[..., 4] - disc) / dg_dr[..., 3]

    @staticmethod
    def Omega(m: AbstractMetric, rtheta, contra_rotating=False):
        r, theta = _rtheta(rtheta)
        _, dgr = metric_jacobian_r(m, r, theta)
        return CircularOrbits.omega_analytic(dgr, contra_rotating)

    @staticmethod
    def ut_uphi(m: AbstractMetric, rtheta, contra_rotating=False):
        """Covariant (u_t, u_φ) of the circular orbit
        (reference `ut_uϕ`, circular-orbits.jl:26-38)."""
        r, theta = _rtheta(rtheta)
        Om = CircularOrbits.Omega(m, (r, theta), contra_rotating)
        ginv = sym4x4_inverse_components(m.components(r, theta))
        A = -(Om * ginv[..., 0] - ginv[..., 4])
        B = Om * ginv[..., 4] - ginv[..., 3]
        denom = B * B * ginv[..., 0] + 2 * A * B * ginv[..., 4] + A * A * ginv[..., 3]
        d = -torch.sign(denom) * torch.sqrt(1.0 / torch.abs(denom))
        return B * d, A * d

    @staticmethod
    def energy(m: AbstractMetric, rtheta, contra_rotating=False, **kw):
        ut, _ = CircularOrbits.ut_uphi(m, rtheta, contra_rotating)
        return -ut

    @staticmethod
    def angmom(m: AbstractMetric, rtheta, contra_rotating=False, **kw):
        _, uphi = CircularOrbits.ut_uphi(m, rtheta, contra_rotating)
        return uphi

    @staticmethod
    def energy_angmom(m: AbstractMetric, rtheta, contra_rotating=False):
        ut, uphi = CircularOrbits.ut_uphi(m, rtheta, contra_rotating)
        return -ut, uphi

    @staticmethod
    def vt(m: AbstractMetric, rtheta, contra_rotating=False):
        return CircularOrbits.fourvelocity(m, rtheta, contra_rotating)[..., 0]

    @staticmethod
    def vphi(m: AbstractMetric, rtheta, contra_rotating=False):
        return CircularOrbits.fourvelocity(m, rtheta, contra_rotating)[..., 3]

    @staticmethod
    def fourvelocity(m: AbstractMetric, rtheta, contra_rotating=False):
        """(v^t, 0, 0, v^φ) from one (u_t, u_φ) raised by the inverse metric."""
        r, theta = _rtheta(rtheta)
        ginv = sym4x4_inverse_components(m.components(r, theta))
        ut, uphi = CircularOrbits.ut_uphi(m, (r, theta), contra_rotating)
        vt = ginv[..., 0] * ut + ginv[..., 4] * uphi
        vphi = ginv[..., 4] * ut + ginv[..., 3] * uphi
        z = torch.zeros_like(vt)
        return torch.stack([vt, z, z, vphi], dim=-1)

    @staticmethod
    def plunging_fourvelocity(m: AbstractMetric, rtheta, contra_rotating=False):
        """Four-velocity with inward radial component from the norm constraint
        — valid **at the ISCO** (reference circular-orbits.jl:127-147)."""
        r, theta = _rtheta(rtheta)
        g = m.components(r, theta)
        ginv = sym4x4_inverse_components(g)
        ut, uphi = CircularOrbits.ut_uphi(m, (r, theta), contra_rotating)
        E, L = -ut, uphi
        vt = ginv[..., 0] * ut + ginv[..., 4] * uphi
        vphi = ginv[..., 4] * ut + ginv[..., 3] * uphi
        nom = (
            ginv[..., 0] * E * E
            - 2.0 * ginv[..., 4] * E * L
            + ginv[..., 3] * L * L
            + 1.0
        )
        vr = -torch.sqrt(torch.abs(nom / (-g[..., 1])))
        z = torch.zeros_like(vt)
        return torch.stack([vt, vr, z, vphi], dim=-1)
