"""Plunging-region four-velocities inside the ISCO (counterpart of
`gradus_tpu/orbits/plunging.py`).

For an equatorial plunge in a static axis-symmetric metric, E and L are
frozen at their ISCO values, so

    u_t = -E_isco,  u_φ = L_isco,
    v^t = g^tt u_t + g^tφ u_φ,   v^φ = g^tφ u_t + g^φφ u_φ,
    v^r = -√( (-1 − g^tt u_t² − 2 g^tφ u_t u_φ − g^φφ u_φ²) / g_rr ),

in closed form, where the reference integrates a timelike geodesic and
interpolates it (`src/orbits/orbit-solving.jl:99-171`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.orbits.circular import CircularOrbits
from gradus_tpu_torch.orbits.special_radii import isco as _isco
from gradus_tpu_torch.utils.linalg import sym4x4_inverse_components

__all__ = ["PlungingInterpolation", "interpolate_plunging_velocities"]


@dataclasses.dataclass(frozen=True)
class PlungingInterpolation:
    """Callable v(r) → (v^t, v^r, v^θ=0, v^φ) for r ≤ r_isco."""

    m: Any
    E: Any
    L: Any
    r_isco: Any

    def __call__(self, r):
        theta = torch.full_like(r, math.pi / 2)
        g = self.m.components(r, theta)
        ginv = sym4x4_inverse_components(g)
        ut = -self.E
        uphi = self.L
        vt = ginv[..., 0] * ut + ginv[..., 4] * uphi
        vphi = ginv[..., 4] * ut + ginv[..., 3] * uphi
        nrm = (
            ginv[..., 0] * ut * ut
            + 2.0 * ginv[..., 4] * ut * uphi
            + ginv[..., 3] * uphi * uphi
        )
        vr2 = (-1.0 - nrm) / g[..., 1]
        vr = -torch.sqrt(torch.clamp(vr2, min=0.0))
        return torch.stack([vt, vr, torch.zeros_like(vt), vphi], dim=-1)


def interpolate_plunging_velocities(m: AbstractMetric, contra_rotating=False):
    r_isco = _isco(m)
    E, L = CircularOrbits.energy_angmom(
        m, (r_isco, torch.full_like(r_isco, math.pi / 2)), contra_rotating=contra_rotating
    )
    return PlungingInterpolation(m=m, E=E, L=L, r_isco=r_isco)
