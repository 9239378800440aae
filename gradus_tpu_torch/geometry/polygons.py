"""Polygon utilities: shoelace area, orientation, in-polygon, barycenter
(counterpart of `gradus_tpu/geometry/polygons.py`; reference
`src/geometry/geometry.jl:55-123`). Polygons are (V, 2) vertex tensors;
query points broadcast over leading axes."""

from __future__ import annotations

import torch

__all__ = [
    "polygon_area",
    "polygon_barycenter",
    "orientation",
    "in_polygon",
]


def _tensor(p):
    return p if isinstance(p, torch.Tensor) else torch.as_tensor(p, dtype=torch.float64)


def polygon_area(poly):
    """Shoelace area of a (V, 2) vertex loop (reference `getarea`,
    geometry.jl:97-107)."""
    p = _tensor(poly)
    q = torch.roll(p, -1, dims=-2)
    cross = p[..., 0] * q[..., 1] - q[..., 0] * p[..., 1]
    return torch.abs(0.5 * torch.sum(cross, dim=-1))


def polygon_barycenter(poly):
    """Vertex centroid (reference `getbarycenter`, geometry.jl:109-121)."""
    return torch.mean(_tensor(poly), dim=-2)


def orientation(p1, p2, p):
    """Side of the directed line p1→p2 the point p lies on: +1 / −1
    (reference branchless `getorientation`, geometry.jl:51-61)."""
    o = _tensor(p) - _tensor(p1)
    b = _tensor(p1) - _tensor(p2)
    t = b[..., 1] * o[..., 0] - b[..., 0] * o[..., 1]
    return torch.where(t < 0, 1, -1)


def in_polygon(poly, p):
    """True where the point(s) ``p`` (..., 2) lie inside the CONVEX polygon
    ``poly`` (V, 2): every edge sees the point on the same side (reference
    `inpolygon`, geometry.jl:86-95, with the same convexity contract)."""
    poly, p = _tensor(poly), _tensor(p)
    lead = p.shape[:-1]
    pf = p.reshape(-1, 2)  # (N, 2): any number of leading batch axes
    b = torch.roll(poly, -1, dims=0)  # edge ends
    sides = orientation(poly[:, None, :], b[:, None, :], pf[None, :, :])  # (V, N)
    return torch.all(sides == sides[0], dim=0).reshape(lead)
