"""Point functions: maps GeodesicPoint batch → per-ray values, with a
composition algebra (counterpart of `gradus_tpu/camera/pointfns.py`).

``pf2 @ pf1`` evaluates pf1 first, like the reference's ``pf2 ∘ pf1``.
Filters replace the value by their default (NaN) where the predicate fails.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.integrate.status import StatusCodes

__all__ = [
    "PointFunction",
    "FilterPointFunction",
    "FilterStatusCode",
    "ConstPointFunctions",
]


class AbstractPointFunction:
    def __call__(self, m, gp, max_time, **kwargs):
        raise NotImplementedError

    def __matmul__(self, other):
        """self @ other — evaluate `other` first, pass its value on."""
        return _ComposedPointFunction(self, other)


class PointFunction(AbstractPointFunction):
    def __init__(self, f):
        self.f = f

    def __call__(self, m, gp, max_time, **kwargs):
        return self.f(m, gp, max_time, **kwargs)


class FilterPointFunction(AbstractPointFunction):
    """Boolean predicate; where it is False the chain output is `default`."""

    def __init__(self, f, default=math.nan):
        self.f = f
        self.default = default

    def __call__(self, m, gp, max_time, **kwargs):
        return self.f(m, gp, max_time, **kwargs)


class _ComposedPointFunction(AbstractPointFunction):
    def __init__(self, outer, inner):
        self.outer = outer
        self.inner = inner

    def __call__(self, m, gp, max_time, **kwargs):
        if isinstance(self.inner, FilterPointFunction):
            mask = self.inner(m, gp, max_time, **kwargs)
            value = self.outer(m, gp, max_time, **kwargs)
            return torch.where(mask, value, self.inner.default)
        value = self.inner(m, gp, max_time, **kwargs)
        return self.outer(m, gp, max_time, value=value, **kwargs)


def FilterStatusCode(code, default=math.nan):
    return FilterPointFunction(lambda m, gp, t, **kw: gp.status == code, default)


class ConstPointFunctions:
    """Default point functions (reference `src/const-point-functions.jl`)."""

    @staticmethod
    def filter_early_term(default=math.nan):
        """Keep only geodesics that terminated before λmax."""
        return FilterPointFunction(
            lambda m, gp, max_time, **kw: gp.lam_max < max_time, default
        )

    @staticmethod
    def filter_intersected(default=math.nan):
        return FilterStatusCode(StatusCodes.IntersectedWithGeometry, default)

    @staticmethod
    def affine_time():
        return PointFunction(lambda m, gp, max_time, **kw: gp.lam_max)

    @staticmethod
    def shadow():
        """Affine time where the geodesic terminated early, NaN elsewhere."""
        return ConstPointFunctions.affine_time() @ ConstPointFunctions.filter_early_term()

    @staticmethod
    def redshift(m, x_obs):
        from gradus_tpu_torch.redshift import redshift_pointfunction

        return redshift_pointfunction(m, x_obs)
