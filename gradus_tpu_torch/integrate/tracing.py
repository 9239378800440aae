"""Trace descriptions and the geodesic right-hand side (counterpart of the
main-path part of `gradus_tpu/integrate/tracing.py`; `trace_geodesics` and
its plain lockstep solver are not ported yet).

The 8-component state is u = (x, v); the RHS is
``du/dλ = (v, geodesic_equation(m, x, v))``.
"""

from __future__ import annotations

import dataclasses

import torch

from gradus_tpu_torch.geodesics.equation import geodesic_equation
from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["TraceGeodesic", "make_geodesic_rhs"]


@dataclasses.dataclass(frozen=True)
class TraceGeodesic:
    """Null (μ=0) / timelike (μ=1) trace. A charge q ≠ 0 (Lorentz force) is
    not ported yet."""

    mu: float = 0.0
    q: float = 0.0


def make_geodesic_rhs(m: AbstractMetric, trace: TraceGeodesic | None = None):
    """RHS over (..., 8) states (uncharged traces)."""
    if trace is not None and float(trace.q) != 0.0:
        raise NotImplementedError(
            "charged traces (Kerr-Newman Lorentz force) are not ported yet "
            "(ROADMAP queue A, remaining metrics)"
        )

    def f(y):
        x, v = y[..., 0:4], y[..., 4:8]
        return torch.cat([v, geodesic_equation(m, x, v)], dim=-1)

    return f
