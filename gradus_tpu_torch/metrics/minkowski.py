"""Flat-space (Minkowski) metrics in spherical and cartesian coordinates
(counterpart of `gradus_tpu/metrics/minkowski.py`; reference
`src/metrics/minkowski.jl:1-43`).

Neither has a parameter. The CUDA integrator takes both through its dual
numbers (`csrc/metrics.cuh`). Like the JAX kernel, it reads the state's
second component as ``r`` for the chart bounds whatever the coordinates:
for `CartesianMetric` that is ``x`` (ROADMAP C).
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["SphericalMetric", "CartesianMetric", "minkowski_matrix"]


class SphericalMetric(AbstractMetric):
    def __init__(self, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device)

    def components5(self, r, theta):
        one = torch.ones_like(r)
        return (-one, one, r * r, (r * torch.sin(theta)) ** 2, torch.zeros_like(r))

    def inner_radius(self):
        return 1e-12

    def isco(self):
        return 0.0


class CartesianMetric(AbstractMetric):
    def __init__(self, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device)

    def components5(self, r, theta):
        # diag(-1, 1, 1, 1); the 5th slot (tφ) is zero
        one = torch.ones_like(r)
        return (-one, one, one, one, torch.zeros_like(r))

    def inner_radius(self):
        return 1e-12

    def isco(self):
        return 0.0


def minkowski_matrix(dtype=torch.float64, device=None):
    return torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=dtype, device=device))
