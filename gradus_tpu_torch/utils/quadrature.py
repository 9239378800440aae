"""Gauss-Legendre quadrature nodes and weights (counterpart of
`gradus_tpu/utils/quadrature.py`), computed on the host with numpy."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gauss_legendre"]


def gauss_legendre(n: int, dtype=torch.float64, device=None):
    """Nodes and weights on [-1, 1], as two (n,) tensors."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (
        torch.as_tensor(x, dtype=dtype, device=device),
        torch.as_tensor(w, dtype=dtype, device=device),
    )
