"""NaN-tolerant linear interpolation as fixed-shape tensor ops (counterpart
of `gradus_tpu/utils/interp.py`).

The reference's workhorse interpolator (`src/interpolations.jl:1-53`,
`NaNLinearInterpolator` + `_make_interpolation`) skips NaN values and clamps
out-of-bounds queries. Here: `searchsorted` on a sorted knot vector with
masked NaN handling, differentiable with respect to the values.
"""

from __future__ import annotations

import warnings
from functools import partial

import torch

__all__ = [
    "linear_interp",
    "nan_tolerant_interp",
    "masked_sorted_interp",
    "make_interpolator",
    "enforce_interpolation_bounds",
    "gaussian_kernel",
    "constant_kernel",
    "kernel_interpolate",
]


def linear_interp(xq, xs, ys):
    """Piecewise-linear interpolation of ``ys(xs)`` at ``xq``; clamps to the
    boundary values outside the domain (reference clamp semantics:
    `src/interpolations.jl:47-53`)."""
    xq = torch.as_tensor(xq, dtype=xs.dtype, device=xs.device)
    idx = torch.clamp(torch.searchsorted(xs, xq.contiguous(), right=True) - 1, 0, xs.shape[0] - 2)
    x0 = xs[idx]
    x1 = xs[idx + 1]
    y0 = ys[..., idx]
    y1 = ys[..., idx + 1]
    w = torch.where(x1 == x0, 0.0, (xq - x0) / torch.where(x1 == x0, 1.0, x1 - x0))
    w = torch.clamp(w, 0.0, 1.0)
    return y0 + w * (y1 - y0)


def _fill_forward(ys, valid):
    """Each knot's value, or the last valid one before it (the first valid
    value before any): the reference's forward-fill scan."""
    n = ys.shape[0]
    pos = torch.arange(n, device=ys.device)
    first = torch.argmax(valid.to(torch.int32))
    last_valid = torch.cummax(torch.where(valid, pos, -1), dim=0).values
    return ys[torch.where(last_valid < 0, first, last_valid)]


def nan_tolerant_interp(xq, xs, ys):
    """Linear interpolation that skips NaN knots: at a query point, walks to the
    nearest non-NaN knots on either side (reference `_interpolate`,
    `src/interpolations.jl:12-30`).

    Knots with NaN values take the mean of the forward and the backward fill
    of the valid values; valid knots keep theirs."""
    valid = ~torch.isnan(ys)
    fwd = _fill_forward(ys, valid)
    bwd = torch.flip(_fill_forward(torch.flip(ys, (0,)), torch.flip(valid, (0,))), (0,))
    ys_filled = torch.where(valid, ys, 0.5 * (fwd + bwd))
    return linear_interp(xq, xs, ys_filled)


def masked_sorted_interp(xq, xs, ys, n):
    """Linear interpolation on a sorted knot array whose valid prefix has
    length ``n`` (invalid tail is +inf). Queries clamp to the valid range.

    As in the reference, the index's upper clip ``n − 2`` is negative when
    fewer than 2 knots are valid, and the index then wraps to the tail."""
    xq = torch.as_tensor(xq, dtype=xs.dtype, device=xs.device)
    idx = torch.searchsorted(xs, xq.contiguous(), right=True) - 1
    idx = torch.minimum(torch.clamp(idx, min=0), torch.as_tensor(n, device=xs.device) - 2)
    x0, x1 = xs[idx], xs[idx + 1]
    w = torch.clamp((xq - x0) / torch.where(x1 <= x0, 1.0, x1 - x0), 0.0, 1.0)
    return ys[idx] * (1 - w) + ys[idx + 1] * w


def make_interpolator(xs, ys, nan_tolerant: bool = False):
    """Closure form mirroring the reference's `_make_interpolation`
    (`src/interpolations.jl:39-45`)."""
    if nan_tolerant:
        return partial(nan_tolerant_interp, xs=xs, ys=ys)
    return partial(linear_interp, xs=xs, ys=ys)


_bounds_warned = [False]


def enforce_interpolation_bounds(r, r_min, r_max, warn: bool = True):
    """Clamp queries to the interpolation domain; warn once on out-of-bounds
    inputs (reference `_enforce_interpolation_bounds`,
    `src/interpolations.jl:47-53`)."""
    r = torch.as_tensor(r)
    if warn and not _bounds_warned[0] and bool(((r < r_min) | (r > r_max)).any()):
        warnings.warn(
            f"Interpolation out of bounds: query ∉ [{r_min}, {r_max}]. "
            "Additional geodesic samples may be required (will not warn again).",
            stacklevel=2,
        )
        _bounds_warned[0] = True
    return torch.clamp(r, r_min, r_max)


def gaussian_kernel(kernel_size=(5, 5), sigma: float = 1.0, domain=(-5.0, 5.0), *, dtype=torch.float64):
    """Normalised 2D Gaussian stencil (reference `gaussian_kernel`,
    `src/interpolations.jl:55-67`)."""
    from gradus_tpu_torch.camera.grids import LinearGrid

    xi = LinearGrid()(domain[0], domain[1], kernel_size[0], dtype=dtype)
    yj = LinearGrid()(domain[0], domain[1], kernel_size[1], dtype=dtype)
    k = torch.exp(-((xi[None, :] / sigma) ** 2 + (yj[:, None] / sigma) ** 2))
    return k / k.sum()


def constant_kernel(kernel_size=(5, 5), *, dtype=torch.float64):
    """Normalised box stencil (reference `constant_kernel`,
    `src/interpolations.jl:69-73`)."""
    k = torch.ones(kernel_size, dtype=dtype)
    return k / k.sum()


def kernel_interpolate(data, kernel_size=(5, 5), kf=gaussian_kernel, **kwargs):
    """Fill interior NaN pixels with the kernel-weighted mean of their non-NaN
    neighbours (reference `kernel_interpolate!`,
    `src/interpolations.jl:75-117`): one pair of 'same'-padded
    cross-correlations; border rows and columns are left untouched, as the
    reference's interior-only sweep leaves them."""
    data = torch.as_tensor(data)
    kernel = kf(kernel_size, **kwargs).to(dtype=data.dtype, device=data.device)
    valid = ~torch.isnan(data)
    data0 = torch.where(valid, data, 0.0)
    k4 = kernel[None, None, :, :]

    def conv(img):
        return torch.nn.functional.conv2d(img[None, None].to(data.dtype), k4, padding="same")[0, 0]

    num = conv(data0)
    den = conv(valid.to(data.dtype))
    filled = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)

    hx, hy = kernel_size[0] // 2, kernel_size[1] // 2
    ii = torch.arange(data.shape[0], device=data.device)[:, None]
    jj = torch.arange(data.shape[1], device=data.device)[None, :]
    interior = (ii >= hx) & (ii < data.shape[0] - hx) & (jj >= hy) & (jj < data.shape[1] - hy)
    return torch.where(valid | ~interior, data, filled)
