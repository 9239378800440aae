"""Metric interface: an `nn.Module` holding its parameters as buffers, plus
pure component functions (counterpart of `gradus_tpu/metrics/base.py`).

Every static, axis-symmetric spacetime is described by its 5 non-zero metric
components ``(g_tt, g_rr, g_θθ, g_φφ, g_tφ)`` as functions of ``(r, θ)``.
"""

from __future__ import annotations

import torch
from torch import nn

from gradus_tpu_torch.utils.linalg import sym4x4, sym4x4_inverse_components

__all__ = ["AbstractMetric", "unpack_rtheta"]


class AbstractMetric(nn.Module):
    """Shared behaviour for static axis-symmetric metrics.

    Subclasses implement ``components5(r, θ)`` (a 5-tuple of tensors) and
    ``inner_radius()``."""

    def components5(self, r, theta):  # pragma: no cover - interface
        raise NotImplementedError

    def components(self, r, theta):
        """The 5 components stacked on a trailing axis."""
        r, theta = torch.broadcast_tensors(r, theta)
        return torch.stack(self.components5(r, theta), dim=-1)

    def components5_jac(self, r, theta):
        """Value + (∂_r, ∂_θ) of the 5 components: three 5-tuples of tensors.
        The default is two forward-mode passes through ``components5``; hot
        metrics (Kerr) override with hand-derived closed forms."""
        return _ad_components5_jac(self, r, theta)

    def inner_radius(self):  # pragma: no cover - interface
        raise NotImplementedError

    def metric(self, x):
        """Full 4x4 covariant metric at position ``x`` ((r,θ) pair or 4-vector)."""
        r, theta = unpack_rtheta(x)
        return sym4x4(self.components(r, theta))

    def inverse_components(self, r, theta):
        return sym4x4_inverse_components(self.components(r, theta))

    def inverse_metric(self, x):
        r, theta = unpack_rtheta(x)
        return sym4x4(self.inverse_components(r, theta))

    def isco(self):
        from gradus_tpu_torch.orbits.special_radii import isco as _isco

        return _isco(self)


def _ad_components5_jac(m, r, theta):
    """Generic value + (∂_r, ∂_θ) of ``components5`` via two jvp passes."""
    r, theta = torch.broadcast_tensors(r, theta)
    ones = torch.ones_like(r)
    zeros = torch.zeros_like(r)
    g, dg_dr = torch.func.jvp(m.components5, (r, theta), (ones, zeros))
    _, dg_dtheta = torch.func.jvp(m.components5, (r, theta), (zeros, ones))
    return g, dg_dr, dg_dtheta


def unpack_rtheta(x):
    """Accept a 4-position ``(t, r, θ, φ)``, an ``(r, θ)`` pair or tuple."""
    if isinstance(x, (tuple, list)):
        if len(x) == 2:
            return x[0], x[1]
        return x[1], x[2]
    if x.shape[-1] == 2:
        return x[..., 0], x[..., 1]
    return x[..., 1], x[..., 2]
