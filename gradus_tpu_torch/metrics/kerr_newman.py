"""Kerr-Newman charged black hole, with its electromagnetic potential and
Faraday tensor (counterpart of `gradus_tpu/metrics/kerr_newman.py`; reference
`src/metrics/kerr-newman-ad.jl:1-61`, `src/tracing/utility.jl:89-99`).

The CUDA integrator takes the metric through its dual numbers
(`csrc/metrics.cuh`) for uncharged rays, as the JAX kernel does. The
charged right-hand side that reads `faraday_tensor`, for the lockstep
solver, is not ported yet (ROADMAP A10).
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
    """F^μ_κ = g^{μσ}(∂_σ A_κ − ∂_κ A_σ) at one position ``x`` (4,), with ∂A
    from `torch.func.jacfwd` of the potential w.r.t. (r, θ) (reference
    `src/tracing/utility.jl:89-99`)."""
    rtheta = torch.stack([x[..., 1], x[..., 2]])

    def pot(rt):
        return m.electromagnetic_potential(rt[0], rt[1])

    dA_rt = torch.func.jacfwd(pot)(rtheta)  # (4, 2): ∂A_κ/∂(r, θ)
    dA = torch.zeros((4, 4), dtype=dA_rt.dtype, device=dA_rt.device)
    dA[:, 1] = dA_rt[:, 0]
    dA[:, 2] = dA_rt[:, 1]
    # dA[κ, σ] = ∂_σ A_κ ⇒ F_{σκ} = ∂_σ A_κ − ∂_κ A_σ = dA.T − dA
    return m.inverse_metric(x) @ (dA.T - dA)
