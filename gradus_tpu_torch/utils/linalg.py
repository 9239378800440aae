"""Small linear-algebra and coordinate utilities on 4-vectors (counterpart
of `gradus_tpu/utils/linalg.py`)."""

from __future__ import annotations

import math

import torch

__all__ = [
    "sym4x4",
    "sym4x4_inverse_components",
    "equatorial_project",
    "spinaxis_project",
    "spherical_to_cartesian",
    "cartesian_to_spherical",
    "cartesian_squared_distance",
    "cartesian_distance",
    "smooth_step_interpolate",
    "oblate_spheroid_to_spherical",
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


def cartesian_to_spherical(x):
    """(x, y, z) → (r, θ, φ)."""
    r = torch.sqrt(torch.sum(x * x, dim=-1))
    theta = torch.arccos(torch.clamp(x[..., 2] / r, -1.0, 1.0))
    phi = torch.atan2(x[..., 1], x[..., 0])
    return torch.stack([r, theta, phi], dim=-1)


def cartesian_squared_distance(x1, x2):
    """Flat-space squared distance between two BL-coordinate positions
    (reference `src/utils.jl:90-98`)."""
    d = spherical_to_cartesian(x2) - spherical_to_cartesian(x1)
    return torch.sum(d * d, dim=-1)


def cartesian_distance(x1, x2):
    return torch.sqrt(cartesian_squared_distance(x1, x2))


def smooth_step_interpolate(x, x0, dx=2.5, smoothing_offset=1e4):
    """Smoothed 1→0 step centred at ``x0`` over width ``dx``; used by the
    refractive-index and dark-matter metrics so the boundary has a gradient
    (reference `_smooth_interpolate`, `src/utils.jl:159-169`). ``x`` may be
    a dual number of `metrics/base.py`."""
    t = (x - x0) / dx
    v = torch.arctan(smoothing_offset * t) / math.pi + 0.5
    mid = 1.0 - v
    return torch.where(x <= x0 - dx / 2, 1.0, torch.where(x >= x0 + dx / 2, 0.0, mid))


def oblate_spheroid_to_spherical(x, h, a):
    """Point (``x`` along the x-axis, ``h`` along the z-axis) → (r, θ) in
    Boyer-Lindquist, accounting for the oblate spheroidal coordinates of
    spinning spacetimes (reference `src/utils.jl:186-200`). Numbers or
    tensors; the flat-space branch where |a| < 1e-12."""
    x, h = (v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=torch.float64) for v in (x, h))
    dtype = torch.promote_types(x.dtype, h.dtype)
    dtype = dtype if dtype.is_floating_point else torch.float64
    x, h = x.to(dtype), h.to(dtype)
    a = torch.as_tensor(a, dtype=dtype, device=x.device)
    r_flat = torch.sqrt(x * x + h * h)
    theta_flat = torch.atan2(x, h)
    a2 = torch.where(torch.abs(a) < 1e-12, 1.0, a * a)  # guarded; branch selected below
    cos2 = (torch.sqrt(4 * a2 * h * h + (h * h + x * x - a2) ** 2) + a2 - h * h - x * x) / (2 * a2)
    cos_t = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    r_sph = h / torch.where(cos_t == 0, 1.0, cos_t)
    theta_sph = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    flat = torch.abs(a) < 1e-12
    return torch.where(flat, r_flat, r_sph), torch.where(flat, theta_flat, theta_sph)
