"""Shared integrator pieces: PI controller constants, the result record and
the post-kernel Newton polish of disc hits (counterpart of the matching parts
of `gradus_tpu/integrate/solver.py`; the lockstep `integrate_rays` solver is
not ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tsit5 import tsit5_step

__all__ = ["IntegrationResult"]

# PI step-size controller constants (standard Gustafsson / OrdinaryDiffEq-style)
_GAMMA = 0.9
_BETA1 = 7.0 / 50.0
_BETA2 = 2.0 / 25.0
_QMAX_FACTOR = 10.0
_QMIN_FACTOR = 0.2
_QOLD_INIT = 1e-4


@dataclasses.dataclass(frozen=True)
class IntegrationResult:
    """Struct-of-tensors solver output over the ray batch."""

    y: Any  # (N, S) final state
    lam: Any  # (N,) final affine parameter
    y0: Any  # (N, S) initial state
    lam0: Any  # (N,) initial affine parameter
    status: Any  # (N,) int32 StatusCodes
    steps: Any  # (N,) int32 accepted step count
    failed: Any  # (N,) bool — dt underflow (should never fire)


@dataclasses.dataclass(frozen=True)
class _Problem:
    """What the post-kernel polish needs of an integration problem."""

    f: Callable
    crossing_fn: Callable
    newton_iters: int = 3


def _polish_hits(p: _Problem, cf: dict, y_f, lam_f):
    """Newton polish on the exact trajectory: one 5th-order RK substep from
    the hit step's start to λ*, then λ* ← λ* − c(y*)/(∇c·f)(y*).

    ``cf`` holds the integrator's raw outputs: for a hit ray ``y``, ``k1`` and
    ``lam`` are the hit step's start and ``dt`` its span."""
    hit = cf["status"] == StatusCodes.IntersectedWithGeometry
    y_s, k_s = cf["y"], cf["k1"]
    dt_safe = torch.where(hit, cf["dt"], torch.ones_like(cf["dt"]))

    th = cf["hit_theta"]
    for _ in range(p.newton_iters):
        ystar, _, _, _ = tsit5_step(p.f, y_s, th * dt_safe, k_s)
        cval, cdot = torch.func.jvp(p.crossing_fn, (ystar,), (p.f(ystar),))
        cdot = torch.where(torch.abs(cdot) < 1e-30, torch.ones_like(cdot), cdot)
        th = torch.clamp(th - cval / (cdot * dt_safe), 0.0, 1.0)
    dt_star = th * dt_safe
    y_star, _, _, _ = tsit5_step(p.f, y_s, dt_star, k_s)
    y_f = torch.where(hit[..., None], y_star, y_f)
    lam_f = torch.where(hit, cf["lam"] + dt_star, lam_f)
    return y_f, lam_f
