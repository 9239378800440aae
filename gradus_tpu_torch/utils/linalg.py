"""Small linear-algebra utilities on 4-vectors (counterpart of
`gradus_tpu/utils/linalg.py`, the main-path subset)."""

from __future__ import annotations

import torch

__all__ = [
    "sym4x4",
    "sym4x4_inverse_components",
    "equatorial_project",
    "spinaxis_project",
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
