"""Special radii (counterpart of `gradus_tpu/orbits/special_radii.py`, the
analytic ISCO fast path only)."""

from __future__ import annotations

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["isco"]


def isco(m: AbstractMetric):
    """ISCO radius. Metrics with an analytic ISCO (Kerr) override `m.isco()`;
    the generic dE/dr = 0 scan/bisect/Newton search is not ported yet."""
    if type(m).isco is not AbstractMetric.isco:
        return m.isco()
    raise NotImplementedError(
        f"generic ISCO search for {type(m).__name__} is not ported yet "
        "(ROADMAP queue A item 6, orbits/special_radii.py::isco)"
    )
