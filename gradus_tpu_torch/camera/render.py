"""Pixel-grid rendering: trace one geodesic per pixel, apply a point function
(counterpart of `gradus_tpu/camera/render.py`).

Reference: `src/rendering/rendering.jl` (`rendergeodesics`,
`prerendergeodesics`, `EndpointRenderCache`): defaults 375×250 pixels,
α ∈ (-60, 60), β ∈ (-40, 40), a 1e-6 impact-parameter offset to avoid the
coordinate singularity at α = 0. The pixels are one batch traced by
`trace_geodesics` on the observer position's device; the point function is
one vectorized evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from gradus_tpu_torch.camera.grids import _const_linspace
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.camera.pointfns import ConstPointFunctions
from gradus_tpu_torch.integrate.tracing import trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer

__all__ = [
    "rendergeodesics",
    "prerendergeodesics",
    "EndpointRenderCache",
    "apply",
]


@dataclasses.dataclass(frozen=True)
class EndpointRenderCache:
    """Precomputed endpoints so point functions can be re-applied without
    re-tracing (reference `src/rendering/cache.jl:1-59`)."""

    m: Any
    max_time: Any
    height: int
    width: int
    points: Any = None  # GeodesicPoint batch, flattened (W·H,)

    def __repr__(self):
        # the reference's show method (rendering/cache.jl:40-59)
        return (
            "EndpointRenderCache\n"
            f"  . metric      : {type(self.m).__name__}\n"
            f"  . dimensions  : {self.width} x {self.height}\n"
            f"  . max time    : {self.max_time}"
        )


def _pixel_velocities(m, x, image_width, image_height, alpha_lims, beta_lims, offset=1e-6):
    """(α axis, β axis, unconstrained velocities) of the pixels, α-major."""
    alphas = _const_linspace(alpha_lims[0], alpha_lims[1], image_width, x) + offset
    betas = _const_linspace(beta_lims[0], beta_lims[1], image_height, x) + offset
    A = alphas[:, None].expand(image_width, image_height).reshape(-1)
    B = betas[None, :].expand(image_width, image_height).reshape(-1)
    v = map_impact_parameters(m, x, A, B)
    return alphas, betas, v


def prerendergeodesics(
    m: AbstractMetric,
    position,
    geometry=None,
    lam_max: float = 2000.0,
    *,
    image_width: int = 375,
    image_height: int = 250,
    alpha_lims=(-60.0, 60.0),
    beta_lims=(-40.0, 40.0),
    **trace_kwargs,
):
    """Trace the pixel grid and return (α, β, EndpointRenderCache)."""
    x = _as_observer(position, m)
    alphas, betas, v = _pixel_velocities(m, x, image_width, image_height, alpha_lims, beta_lims)
    xs = torch.broadcast_to(x, v.shape)
    gps = trace_geodesics(m, xs, v, (0.0, lam_max), geometry=geometry, **trace_kwargs)
    cache = EndpointRenderCache(
        m=m,
        max_time=torch.as_tensor(lam_max, dtype=x.dtype, device=x.device),
        height=image_height,
        width=image_width,
        points=gps,
    )
    return alphas, betas, cache


def apply(pf, cache: EndpointRenderCache, **kwargs):
    """Apply a point function to a render cache → (height, width) image
    (reference `apply`, point-functions.jl:92-100)."""
    values = pf(cache.m, cache.points, cache.max_time, **kwargs)
    return values.reshape(cache.width, cache.height).T


def rendergeodesics(
    m: AbstractMetric,
    position,
    geometry=None,
    lam_max: float = 2000.0,
    *,
    image_width: int = 375,
    image_height: int = 250,
    alpha_lims=(-60.0, 60.0),
    beta_lims=(-40.0, 40.0),
    pf=None,
    **trace_kwargs,
):
    """Render an image: returns (α axis, β axis, image[height, width]).

    Default point function is the shadow (affine time, early-terminators
    only): the reference `render_into_image!` default (rendering.jl:89-101).
    """
    if pf is None:
        pf = ConstPointFunctions.shadow()
    alphas, betas, cache = prerendergeodesics(
        m,
        position,
        geometry,
        lam_max,
        image_width=image_width,
        image_height=image_height,
        alpha_lims=alpha_lims,
        beta_lims=beta_lims,
        **trace_kwargs,
    )
    return alphas, betas, apply(pf, cache)
