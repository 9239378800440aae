"""Accretion-disc geometry consumed by the integrator's event layer
(counterpart of `gradus_tpu/geometry/discs.py`, the ThinDisc and DatumPlane
subset).

`distance_to_disc(x4, gtol)` is positive away from the disc, ≤ 0 on it; the
surface thickening is ``gtol·|r|``. Out-of-annulus queries return 1.
"""

from __future__ import annotations

import torch
from torch import nn

from gradus_tpu_torch.utils.linalg import equatorial_project, spinaxis_project

__all__ = ["AbstractAccretionGeometry", "ThinDisc", "DatumPlane"]


class AbstractAccretionGeometry(nn.Module):
    def distance_to_disc(self, x4, gtol=1e-2):  # pragma: no cover - interface
        raise NotImplementedError

    def crossing_indicator(self, x4):
        """Smooth signed function whose zero crossings include every possible
        surface hit; defaults to the distance function."""
        return self.distance_to_disc(x4, gtol=0.0)

    def is_hit(self, x4, gtol=1e-2):
        """Whether a located zero crossing is a real surface hit."""
        return torch.ones(x4.shape[:-1], dtype=torch.bool, device=x4.device)

    # component form: the event interface of the integrator's plain version
    def crossing_indicator_c(self, t, r, th, ph):
        return self.crossing_indicator(torch.stack([t, r, th, ph], dim=-1))

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        return self.is_hit(torch.stack([t, r, th, ph], dim=-1), gtol=gtol)


def _gtol_error(gtol, x4):
    return gtol * torch.abs(x4[..., 1])


class ThinDisc(AbstractAccretionGeometry):
    """Geometrically-thin equatorial annulus; ``inner_r`` and ``outer_r`` are
    registered 0-d buffers."""

    def __init__(self, inner_r=0.0, outer_r=500.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self.register_buffer(
            "inner_r", torch.as_tensor(inner_r, dtype=dtype, device=device)
        )
        self.register_buffer(
            "outer_r", torch.as_tensor(outer_r, dtype=dtype, device=device)
        )

    def distance_to_disc(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        inside = (rho >= self.inner_r) & (rho <= self.outer_r)
        d = spinaxis_project(x4) - _gtol_error(gtol, x4)
        return torch.where(inside, d, torch.ones_like(d))

    def crossing_indicator(self, x4):
        return spinaxis_project(x4, signed=True)

    def is_hit(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        return (rho >= self.inner_r) & (rho <= self.outer_r)

    def crossing_indicator_c(self, t, r, th, ph):
        return r * torch.cos(th)

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        rho = r * torch.abs(torch.sin(th))
        return (rho >= self.inner_r) & (rho <= self.outer_r)


class DatumPlane(AbstractAccretionGeometry):
    """Plane at constant height; no underside, no gtol widening. ``height``
    is a registered buffer: 0-d for one plane, or (N,) for one plane per ray
    (the thick-disc transfer functions, which the CUDA integrator does not
    take)."""

    def __init__(self, height=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self.register_buffer("height", torch.as_tensor(height, dtype=dtype, device=device))

    def inner_radius(self):
        return 0.0

    def distance_to_disc(self, x4, gtol=1e-2):
        return spinaxis_project(x4, signed=True) - self.height

    def crossing_indicator(self, x4):
        return spinaxis_project(x4, signed=True) - self.height

    def crossing_indicator_c(self, t, r, th, ph):
        return r * torch.cos(th) - self.height

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        return torch.ones_like(r, dtype=torch.bool)
