"""Coronal source models (counterpart of `gradus_tpu/corona/models.py`).

Reference: `src/corona/models/lamp-post.jl` (LampPostModel,
BeamedPointSource) and `src/corona/models/extended.jl` (RingCorona,
DiscCorona). A model is a frozen dataclass of numbers; its
``sample_position_velocity(m)`` gives the source's position and
four-velocity in the metric's dtype, on the metric's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gradus_tpu_torch.geodesics.equation import constrain_all
from gradus_tpu_torch.geodesics.tetrads import propernorm
from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = [
    "LampPostModel",
    "BeamedPointSource",
    "RingCorona",
    "DiscCorona",
    "stationary_velocity",
    "co_rotating_velocity",
    "source_velocity",
]


def _vector(m: AbstractMetric, values):
    """A 4-vector of numbers or 0-d tensors in the metric's dtype (float64
    for a metric without parameters) on its device."""
    b = next(m.buffers(), None)
    dtype = torch.float64 if b is None else b.dtype
    return torch.stack([torch.as_tensor(v, dtype=dtype, device=m.device) for v in values])


def stationary_velocity(m: AbstractMetric, x):
    """v = (1,0,0,0)/√(-g_tt) (reference `SourceVelocities.stationary`)."""
    g = m.components(x[1], x[2])
    v = torch.zeros_like(x)
    v[0] = 1.0
    return v / torch.sqrt(-g[0])


def co_rotating_velocity(m: AbstractMetric, x, isco_r=None):
    """Keplerian co-rotation of the cylinder through x (reference
    `SourceVelocities.co_rotating`, extended.jl:20-25): the circular-orbit
    four-velocity at max(isco, r sinθ) scaled by sinθ, unit-normalised, then
    re-constrained to g_μν v^μ v^ν = −1."""
    from gradus_tpu_torch.orbits.circular import CircularOrbits
    from gradus_tpu_torch.orbits.special_radii import isco as _isco

    if isco_r is None:
        isco_r = _isco(m)
    sin_t = torch.sin(x[2])
    r_kep = torch.maximum(torch.as_tensor(isco_r, dtype=x.dtype, device=x.device), x[1] * sin_t)
    v = CircularOrbits.fourvelocity(m, r_kep) * sin_t
    v = v / torch.sqrt(torch.abs(propernorm(m.metric(x), v)))
    return constrain_all(m, x, v, mu=1.0)


def source_velocity(m: AbstractMetric, x, vf: str):
    if vf == "co_rotating":
        return co_rotating_velocity(m, x)
    if vf == "stationary":
        return stationary_velocity(m, x)
    raise ValueError(f"unknown source velocity function {vf!r}")


@dataclasses.dataclass(frozen=True)
class LampPostModel:
    """Static on-axis point source at height h
    (reference lamp-post.jl:1-13)."""

    h: float = 5.0
    theta: float = 0.01
    phi: float = 0.0

    def sample_position_velocity(self, m: AbstractMetric):
        x = _vector(m, (0.0, self.h, self.theta, self.phi))
        g = m.components(x[1], x[2])
        v = torch.zeros_like(x)
        v[0] = 1.0
        return x, v / torch.sqrt(-g[0])


@dataclasses.dataclass(frozen=True)
class BeamedPointSource:
    """Outflowing on-axis point source at radius r with speed β
    (reference lamp-post.jl:25-45): dr/dt = β √(-g_tt/g_rr)."""

    r: float = 5.0
    beta: float = 0.0

    def sample_position_velocity(self, m: AbstractMetric):
        x = _vector(m, (0.0, self.r, 1e-4, 0.0))
        g = m.components(x[1], x[2])
        drdt = self.beta * torch.sqrt(-g[0] / g[1])
        vbar = torch.stack([torch.ones_like(drdt), drdt, torch.zeros_like(drdt), torch.zeros_like(drdt)])
        # normalise to timelike: first constrain v^t, then unit-norm
        v = constrain_all(m, x, vbar, mu=1.0)
        nrm = torch.sqrt(torch.abs(propernorm(m.metric(x), v)))
        return x, v / nrm


@dataclasses.dataclass(frozen=True)
class RingCorona:
    """Off-axis ring source (reference `src/corona/models/extended.jl:61-84`):
    an infinitely thin ring of cylindrical radius r at height h. The source
    point sits at spherical (√(r²+h²), atan2(r, h)); its velocity is either
    Keplerian co-rotation of the cylinder (the reference default,
    `SourceVelocities.co_rotating`) or stationary."""

    r: float = 5.0
    h: float = 5.0
    vf: str = "co_rotating"

    def sample_position_velocity(self, m: AbstractMetric):
        x = _vector(m, (0.0, math.sqrt(self.r**2 + self.h**2), math.atan2(self.r, self.h), 0.0))
        return x, source_velocity(m, x, self.vf)


@dataclasses.dataclass(frozen=True)
class DiscCorona:
    """Extended disc corona of radius r at height h — a stack of rings
    (reference extended.jl:164-200)."""

    r: float = 10.0
    h: float = 5.0
    vf: str = "co_rotating"

    def sample_position_velocity(self, m: AbstractMetric):
        """Representative source point for Monte-Carlo sampling. The reference
        draws a uniform random cylindrical radius (extended.jl:178-184); here,
        as in the JAX package, the deterministic area-median radius r/√2."""
        rho = self.r / math.sqrt(2.0)
        x = _vector(m, (0.0, math.sqrt(rho**2 + self.h**2), math.atan2(rho, self.h), 0.0))
        return x, source_velocity(m, x, self.vf)
