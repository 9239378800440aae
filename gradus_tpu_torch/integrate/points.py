"""GeodesicPoint — struct-of-tensors endpoint record (counterpart of
`gradus_tpu/integrate/points.py`)."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["GeodesicPoint", "unpack_solution"]


@dataclasses.dataclass(frozen=True)
class GeodesicPoint:
    status: Any  # (N,) int32 StatusCodes
    lam_min: Any  # (N,) start affine parameter
    lam_max: Any  # (N,) end affine parameter
    x_init: Any  # (N, 4)
    v_init: Any  # (N, 4)
    x: Any  # (N, 4) endpoint position
    v: Any  # (N, 4) endpoint velocity
    aux: Any = None  # (N, K) extra integrated state

    def __getitem__(self, idx):
        return GeodesicPoint(
            **{
                f.name: (None if getattr(self, f.name) is None else getattr(self, f.name)[idx])
                for f in dataclasses.fields(self)
            }
        )


def unpack_solution(result) -> GeodesicPoint:
    """Endpoint extraction from an `IntegrationResult`."""
    y, y0 = result.y, result.y0
    return GeodesicPoint(
        status=result.status,
        lam_min=result.lam0,
        lam_max=result.lam,
        x_init=y0[..., 0:4],
        v_init=y0[..., 4:8],
        x=y[..., 0:4],
        v=y[..., 4:8],
        aux=y[..., 8:] if y.shape[-1] > 8 else None,
    )
