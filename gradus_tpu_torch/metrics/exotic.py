"""Exotic spacetimes: Morris-Thorne wormhole, Kerr in a refractive medium,
Kerr with a dark-matter shell (counterpart of `gradus_tpu/metrics/exotic.py`,
the same expressions; reference `src/metrics/{morris-thorne-ad,
kerr-refractive-ad, kerr-dark-matter}.jl`).

None has a hand-derived Jacobian: the plain right-hand side takes the AD
`components5_jac`, the CUDA integrator evaluates each ``components5`` on
dual numbers (`csrc/metrics.cuh`).
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.metrics.kerr import kerr_isco
from gradus_tpu_torch.utils.linalg import smooth_step_interpolate

__all__ = ["MorrisThorneWormhole", "KerrRefractive", "KerrDarkMatter"]


class MorrisThorneWormhole(AbstractMetric):
    """Morris-Thorne wormhole with throat size ``b``; the radial coordinate
    is the proper length ``l`` (reference `src/metrics/morris-thorne-ad.jl:26-37`).
    Its inner radius is 0: a ray that crosses the throat to l ≤ 0 ends
    `WithinInnerBoundary`, as in the JAX kernel."""

    def __init__(self, b=1.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, b=b)

    def components5(self, r, theta):
        l = r  # noqa: E741
        one = torch.ones_like(l)
        hh = self.b**2 + l * l
        # the reference writes (b² + l²)·sin(θ) (morris-thorne-ad.jl:10),
        # reproduced for parity, where sin²θ is the textbook form
        pp = (self.b**2 + l * l) * torch.sin(theta)
        return (-one, one, hh, pp, torch.zeros_like(l))

    def inner_radius(self):
        return torch.zeros_like(self.b)


class KerrRefractive(AbstractMetric):
    """Kerr with a refractive-index ansatz ``n`` inside ``corona_radius``,
    the index boundary smoothed so it has a gradient (reference
    `src/metrics/kerr-refractive-ad.jl:44-64`)."""

    def __init__(self, M=1.0, a=0.0, n=1.0, corona_radius=20.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, n=n, corona_radius=corona_radius)

    def components5(self, r, theta):
        M, a = self.M, self.a
        R = 2.0 * M
        sin2 = torch.sin(theta) ** 2
        sigma = r * r + a * a * torch.cos(theta) ** 2
        delta = r * r - R * r + a * a

        tt = -(1.0 - (R * r) / sigma)
        rr = sigma / delta
        hh = sigma
        pp = sin2 * (r * r + a * a + (sin2 * R * r * a * a) / sigma)
        tp = (-R * r * a * sin2) / sigma

        t = smooth_step_interpolate(r, self.corona_radius)
        n = t + (1.0 - t) * self.n
        return (tt / (n * n), rr, hh, pp, tp / n)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)

    def isco(self):
        return kerr_isco(self.M, self.a)


class KerrDarkMatter(AbstractMetric):
    """Kerr plus a smoothed dark-matter mass shell between ``r_s`` and
    ``r_s + delta_r`` (reference `src/metrics/kerr-dark-matter.jl:1-72`,
    arXiv:2003.06829). The piecewise mass selects on the value of r and
    differentiates the branch it selects, as jax.jvp does."""

    def __init__(
        self, M=1.0, a=0.0, M_dark_matter=2.0, delta_r=20.0, r_s=10.0, *, dtype=torch.float64, device=None
    ):
        super().__init__()
        self._register_params(
            dtype, device, M=M, a=a, M_dark_matter=M_dark_matter, delta_r=delta_r, r_s=r_s
        )

    def dark_matter_mass(self, r):
        dr = (r - self.r_s) / self.delta_r
        G = (3.0 - 2.0 * dr) * dr * dr
        return torch.where(
            r < self.r_s,
            0.0,
            torch.where(r < self.r_s + self.delta_r, self.M_dark_matter * G, self.M_dark_matter),
        )

    def components5(self, r, theta):
        M = self.M + self.dark_matter_mass(r)
        a = self.a
        R = 2.0 * M
        sin2 = torch.sin(theta) ** 2
        cos2 = 1.0 - sin2
        sigma = r * r + a * a * cos2
        delta = r * r + a * a - R * r

        tt = -(1.0 - (R * r) / sigma)
        rr = sigma / delta
        hh = sigma
        pp = sin2 * (r * r + a * a + (sin2 * R * r * a * a) / sigma)
        tp = (-R * r * a * sin2) / sigma
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)
