"""Per-geodesic status codes (counterpart of `gradus_tpu/integrate/status.py`;
the reference's `StatusCodes` enum, Gradus.jl `src/Gradus.jl:59-64`)."""

from __future__ import annotations

__all__ = ["StatusCodes"]


class StatusCodes:
    NoStatus = 0
    OutOfDomain = 1
    WithinInnerBoundary = 2
    IntersectedWithGeometry = 3
