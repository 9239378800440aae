"""1D spacing generators for image planes and radial discretisations
(counterpart of `gradus_tpu/camera/grids.py`).

Each grid is a callable ``grid(lo, hi, N) -> (N,) tensor``. The dtype and
device follow ``lo``/``hi`` where either is a tensor, else float64 on the
CPU; ``dtype=``/``device=`` override them.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "LinearGrid",
    "GeometricGrid",
    "InverseGrid",
    "SinGrid",
    "CosGrid",
    "LogisticGrid",
]


def _like(lo, hi, dtype, device):
    """(lo, hi) as 0-d tensors of one dtype and device."""
    ref = next((v for v in (lo, hi) if isinstance(v, torch.Tensor)), None)
    if dtype is None:
        dtype = torch.float64 if ref is None else ref.dtype
    if device is None and ref is not None:
        device = ref.device
    return (
        torch.as_tensor(lo, dtype=dtype, device=device),
        torch.as_tensor(hi, dtype=dtype, device=device),
    )


def _linspace(lo, hi, N):
    """``jnp.linspace`` with its formula, ``lo·(1 − k/(N−1)) + hi·k/(N−1)``
    with the end point appended, for 0-d tensors ``lo`` and ``hi``."""
    if N == 1:
        return lo.reshape(1)
    step = torch.arange(N - 1, dtype=lo.dtype, device=lo.device) / (N - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def _const_linspace(lo, hi, N, like):
    return _linspace(*_like(lo, hi, like.dtype, like.device), N)


class LinearGrid:
    def __call__(self, lo, hi, N, *, dtype=None, device=None):
        lo, hi = _like(lo, hi, dtype, device)
        return _linspace(lo, hi, N)


class GeometricGrid:
    def __call__(self, lo, hi, N, *, dtype=None, device=None):
        lo, hi = _like(lo, hi, dtype, device)
        K = (hi / lo) ** (1.0 / (N - 1))
        return lo * K ** torch.arange(N, dtype=lo.dtype, device=lo.device)


class InverseGrid:
    def __call__(self, lo, hi, N, *, dtype=None, device=None):
        lo, hi = _like(lo, hi, dtype, device)
        return 1.0 / torch.flip(_linspace(1.0 / hi, 1.0 / lo, N), dims=(0,))


class SinGrid:
    def __call__(self, lo, hi, N, *, dtype=None, device=None):
        lo, hi = _like(lo, hi, dtype, device)
        p = _const_linspace(-math.pi / 2, math.pi / 2, N, lo)
        return ((torch.sin(p) + 1.0) / 2.0) * (hi - lo) + lo


class CosGrid:
    def __call__(self, lo, hi, N, *, dtype=None, device=None):
        lo, hi = _like(lo, hi, dtype, device)
        x = _const_linspace(0.0, 4 * math.pi, N, lo)
        return (torch.cos(x - math.pi / 2) + x) / (4 * math.pi) * (hi - lo) + lo


class LogisticGrid:
    def __init__(self, k=0.5):
        self.k = k

    def __call__(self, lo, hi, N, *, dtype=None, device=None):
        lo, hi = _like(lo, hi, dtype, device)
        y = _const_linspace(-10.0, 10.0, N, lo)
        return (hi - lo) / (1.0 + torch.exp(-self.k * y)) + lo
