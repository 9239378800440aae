"""Kerr-Newman charged black hole, with its electromagnetic potential and
Faraday tensor (counterpart of `gradus_tpu/metrics/kerr_newman.py`; reference
`src/metrics/kerr-newman-ad.jl:1-61`, `src/tracing/utility.jl:89-99`).

The CUDA integrator takes the metric through its dual numbers
(`csrc/metrics.cuh`) for uncharged rays, as the JAX kernel does. Charged
traces run on the lockstep solver: `integrate/tracing.py::make_geodesic_rhs`
adds the Lorentz force through `faraday_tensor`.
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["KerrNewmanMetric", "faraday_tensor"]


class KerrNewmanMetric(AbstractMetric):
    def __init__(self, M=1.0, a=0.0, Q=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, Q=Q)

    def components5(self, r, theta):
        M, a, Q = self.M, self.a, self.Q
        R = 2.0 * M
        sin2 = torch.sin(theta) ** 2
        sigma = r * r + (a * torch.cos(theta)) ** 2
        delta = r * r - R * r + a * a + Q * Q
        r2a2 = r * r + a * a

        tt = (a * a * sin2 - delta) / sigma
        rr = sigma / delta
        hh = sigma
        pp = (sin2 / sigma) * (r2a2**2 - a * a * sin2 * delta)
        tp = (a * sin2 / sigma) * (delta - r2a2)
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2 - self.Q**2)

    def electromagnetic_potential(self, r, theta):
        """A_μ = (rQ/Σ)·(1, 0, 0, -a sin²θ) (reference
        `kerr-newman-ad.jl:28-33`)."""
        sigma = r * r + (self.a * torch.cos(theta)) ** 2
        pref = r * self.Q / sigma
        z = torch.zeros_like(r)
        return torch.stack([pref, z, z, -pref * self.a * torch.sin(theta) ** 2], dim=-1)

    def ergosphere_radius(self, theta, positive=True):
        d = self.M**2 - self.a**2 * torch.cos(theta) ** 2 - self.Q**2
        s = torch.sqrt(d)
        return self.M + s if positive else self.M - s


def faraday_tensor(m: AbstractMetric, x):
    """F^μ_κ = g^{μσ}(∂_σ A_κ − ∂_κ A_σ) at positions ``x`` (..., 4), as
    (..., 4, 4), with ∂A from two forward-mode passes of the potential
    along r and θ (the reference's `jacfwd` of A_μ(r, θ),
    `src/tracing/utility.jl:89-99`) and the index sums written as
    elementwise products and sums: a batch of rays in one pass, with no
    host read, so the charged right-hand side captures in a CUDA graph."""
    r, th = x[..., 1], x[..., 2]
    ones, zeros = torch.ones_like(r), torch.zeros_like(r)
    _, dA_dr = torch.func.jvp(m.electromagnetic_potential, (r, th), (ones, zeros))
    _, dA_dth = torch.func.jvp(m.electromagnetic_potential, (r, th), (zeros, ones))
    z = torch.zeros_like(dA_dr)
    dA = torch.stack([z, dA_dr, dA_dth, z], dim=-1)  # dA[..., κ, σ] = ∂_σ A_κ
    F_low = dA.transpose(-1, -2) - dA  # F_{σκ} = ∂_σ A_κ − ∂_κ A_σ
    return (m.inverse_metric(x)[..., :, :, None] * F_low[..., None, :, :]).sum(dim=-2)
