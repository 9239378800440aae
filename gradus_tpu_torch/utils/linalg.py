"""Small linear-algebra utilities on 4-vectors (counterpart of
`gradus_tpu/utils/linalg.py`, the subset the port's modules use)."""

from __future__ import annotations

import math

import torch

__all__ = [
    "sym4x4",
    "sym4x4_inverse_components",
    "equatorial_project",
    "spinaxis_project",
    "spherical_to_cartesian",
    "smooth_step_interpolate",
]


def sym4x4(comps):
    """Assemble the symmetric 4x4 metric from its 5 non-zero components
    ``(g_tt, g_rr, g_θθ, g_φφ, g_tφ)``."""
    tt, rr, hh, pp, tp = comps.unbind(-1)
    z = torch.zeros_like(tt)
    return torch.stack(
        [
            torch.stack([tt, z, z, tp], dim=-1),
            torch.stack([z, rr, z, z], dim=-1),
            torch.stack([z, z, hh, z], dim=-1),
            torch.stack([tp, z, z, pp], dim=-1),
        ],
        dim=-2,
    )


def sym4x4_inverse_components(comps):
    """Closed-form inverse of the 5-component symmetric metric, as the 5
    inverse components ``(g^tt, g^rr, g^θθ, g^φφ, g^tφ)``."""
    g1, g2, g3, g4, g5 = comps.unbind(-1)
    det = g1 * g2 * g3 * g4 - (g5 * g5) * g2 * g3
    inv_det = 1.0 / det
    return torch.stack(
        [
            (g2 * g3 * g4) * inv_det,
            (g1 * g3 * g4 - (g5 * g5) * g3) * inv_det,
            (g1 * g2 * g4 - (g5 * g5) * g2) * inv_det,
            (g1 * g2 * g3) * inv_det,
            (-g2 * g3 * g5) * inv_det,
        ],
        dim=-1,
    )


def equatorial_project(x, signed: bool = False):
    """ρ = r·|sin θ| — cylindrical radius."""
    r, th = x[..., 1], x[..., 2]
    s = torch.sin(th)
    return r * (s if signed else torch.abs(s))


def spinaxis_project(x, signed: bool = False):
    """z = r·|cos θ| — height above the equatorial plane."""
    r, th = x[..., 1], x[..., 2]
    c = torch.cos(th)
    return r * (c if signed else torch.abs(c))


def spherical_to_cartesian(x):
    """(r, θ, φ) 3-vector (or the spatial part of a 4-vector) → cartesian
    (x, y, z) (reference `src/utils.jl:79-88`)."""
    if x.shape[-1] == 4:
        x = x[..., 1:]
    r, th, ph = x[..., 0], x[..., 1], x[..., 2]
    sth = torch.sin(th)
    return torch.stack([r * torch.cos(ph) * sth, r * torch.sin(ph) * sth, r * torch.cos(th)], dim=-1)


def smooth_step_interpolate(x, x0, dx=2.5, smoothing_offset=1e4):
    """Smoothed 1→0 step centred at ``x0`` over width ``dx``; used by the
    refractive-index and dark-matter metrics so the boundary has a gradient
    (reference `_smooth_interpolate`, `src/utils.jl:159-169`). ``x`` may be
    a dual number of `metrics/base.py`."""
    t = (x - x0) / dx
    v = torch.arctan(smoothing_offset * t) / math.pi + 0.5
    mid = 1.0 - v
    return torch.where(x <= x0 - dx / 2, 1.0, torch.where(x >= x0 + dx / 2, 0.0, mid))
