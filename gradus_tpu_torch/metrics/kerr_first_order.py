"""Kerr for the first-order Carter formalism: the metric class and the
Carter constants (counterpart of `gradus_tpu/metrics/kerr_first_order.py`'s
`KerrSpacetimeFirstOrder` and `carter_constants`; reference
`src/metrics/kerr-metric-first-order.jl`). Its Mino-time tracer,
`trace_geodesics_first_order`, runs on the plain solver and is not ported
yet (ROADMAP A10).
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.metrics.kerr import KerrMetric, kerr_isco

__all__ = ["KerrSpacetimeFirstOrder", "carter_constants"]


class KerrSpacetimeFirstOrder(AbstractMetric):
    """Kerr via the first-order Carter formalism; shares the Boyer-Lindquist
    components with `KerrMetric`.

    Its Jacobian is the AD one of those components, as in the JAX package,
    so the plain right-hand side differentiates them. The CUDA integrator
    runs it as Kerr, with Kerr's hand-derived Jacobian: the two agree to
    5e-12 relative (`tests/test_metrics.py:118-134`), far inside the
    integrator's tolerance, and the dual-number path would cost ~2× per
    step for the same geodesics."""

    def __init__(self, M=1.0, a=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a)

    def components5(self, r, theta):
        return KerrMetric.components5(self, r, theta)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)

    def isco(self):
        return kerr_isco(self.M, self.a)


def carter_constants(m, x, v, mu=0.0):
    """(E, L, Q) from a position/velocity pair (reference `calc_lq` and the
    conserved quantities, kerr-metric-first-order.jl:228-310)."""
    g = m.metric(x)
    E = -(g[..., 0, 0] * v[..., 0] + g[..., 0, 3] * v[..., 3])
    L = g[..., 3, 3] * v[..., 3] + g[..., 0, 3] * v[..., 0]
    theta = x[..., 2]
    p_theta = g[..., 2, 2] * v[..., 2]  # = Σ v^θ (g_θθ = Σ)
    cos2 = torch.cos(theta) ** 2
    Q = p_theta**2 + cos2 * (m.a**2 * (mu**2 - E**2) + L**2 / torch.sin(theta) ** 2)
    return E, L, Q
