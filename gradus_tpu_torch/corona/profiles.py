"""Radial disc profiles: ε(r) and t(r) built from corona traces
(counterpart of `gradus_tpu/corona/profiles.py`).

Reference: `src/corona/radial.jl` (`RadialDiscProfile` with r→ε and r→t
interpolants) and `src/corona/analytic.jl`. Fixed-shape tensors with a
valid prefix count replace the reference's ragged filtered vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from gradus_tpu_torch.utils.interp import masked_sorted_interp

__all__ = ["RadialDiscProfile", "AnalyticRadialDiscProfile"]


@dataclasses.dataclass(frozen=True)
class RadialDiscProfile:
    """Sorted (radii, ε, t) tensors with valid prefix length ``n`` (a 0-d
    integer tensor; the invalid tail's radii are +inf). Queries are taken
    in the profile's dtype, on its device."""

    radii: Any
    eps: Any
    t: Any
    n: Any

    def emissivity_at(self, r):
        return masked_sorted_interp(r, self.radii, self.eps, self.n)

    def coordtime_at(self, r):
        return masked_sorted_interp(r, self.radii, self.t, self.n)

    def __repr__(self):
        # reference show method (radial.jl:279-287)
        n = int(self.n)
        r = self.radii[:n]
        if n == 0:
            return "RadialDiscProfile\n  . N samples    : 0"
        return (
            "RadialDiscProfile\n"
            f"  . N samples    : {n}\n"
            f"  . r (min, max) : ({float(r.min()):.4g}, {float(r.max()):.4g})"
        )


def _zero_time(r):
    return torch.zeros_like(r)


@dataclasses.dataclass(frozen=True)
class AnalyticRadialDiscProfile:
    """Wrap analytic ε(r) (and optionally t(r)) callables
    (reference `src/corona/analytic.jl`)."""

    eps_fn: Callable
    t_fn: Callable = _zero_time

    def emissivity_at(self, r):
        return self.eps_fn(torch.as_tensor(r))

    def coordtime_at(self, r):
        return self.t_fn(torch.as_tensor(r))
