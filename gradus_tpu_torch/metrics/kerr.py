"""Kerr metric in Boyer-Lindquist coordinates (counterpart of
`gradus_tpu/metrics/kerr.py`); analytic ISCO from Bardeen, Press & Teukolsky
(1972)."""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["KerrMetric", "SchwarzschildMetric", "kerr_isco", "convert_angles"]


class KerrMetric(AbstractMetric):
    """Kerr spacetime; ``M`` and ``a`` are registered 0-d buffers."""

    def __init__(self, M=1.0, a=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a)

    def components5(self, r, theta):
        M, a = self.M, self.a
        R = 2.0 * M
        sin2 = torch.sin(theta) ** 2
        cos2 = 1.0 - sin2
        sigma = r * r + a * a * cos2
        inv_sigma = 1.0 / sigma
        delta = r * r + a * a - R * r
        gamma = sin2 * R * r * a

        tt = -(1.0 - (R * r) * inv_sigma)
        rr = sigma / delta
        hh = sigma
        pp = sin2 * (r * r + a * a + (gamma * a) * inv_sigma)
        tp = -gamma * inv_sigma
        return (tt, rr, hh, pp, tp)

    def components5_jac(self, r, theta):
        """Hand-derived value + (∂_r, ∂_θ) of the 5 Kerr components (the same
        closed forms as the CUDA kernel's `kerr_components5_jac`)."""
        M, a = self.M, self.a
        R = 2.0 * M
        s = torch.sin(theta)
        c = torch.cos(theta)
        sin2 = s * s
        ds2 = 2.0 * s * c  # d(sin²θ)/dθ
        cos2 = 1.0 - sin2
        a2 = a * a
        r2 = r * r

        sigma = r2 + a2 * cos2
        sig_r = 2.0 * r
        sig_th = -a2 * ds2
        inv_sigma = 1.0 / sigma
        inv_sig2 = inv_sigma * inv_sigma
        delta = r2 + a2 - R * r
        del_r = 2.0 * r - R
        inv_delta = 1.0 / delta
        gamma = sin2 * R * r * a
        gam_r = sin2 * R * a
        gam_th = ds2 * R * r * a

        tt = -(1.0 - (R * r) * inv_sigma)
        tt_r = R * (sigma - r * sig_r) * inv_sig2
        tt_th = -(R * r) * sig_th * inv_sig2

        rr = sigma * inv_delta
        rr_r = (sig_r * delta - sigma * del_r) * inv_delta * inv_delta
        rr_th = sig_th * inv_delta

        hh = sigma
        hh_r = sig_r
        hh_th = sig_th

        u = gamma * a * inv_sigma
        u_r = a * (gam_r * sigma - gamma * sig_r) * inv_sig2
        u_th = a * (gam_th * sigma - gamma * sig_th) * inv_sig2
        w = r2 + a2 + u
        pp = sin2 * w
        pp_r = sin2 * (2.0 * r + u_r)
        pp_th = ds2 * w + sin2 * u_th

        tp = -gamma * inv_sigma
        tp_r = -(gam_r * sigma - gamma * sig_r) * inv_sig2
        tp_th = -(gam_th * sigma - gamma * sig_th) * inv_sig2

        return (
            (tt, rr, hh, pp, tp),
            (tt_r, rr_r, hh_r, pp_r, tp_r),
            (tt_th, rr_th, hh_th, pp_th, tp_th),
        )

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)

    def isco(self):
        return kerr_isco(self.M, self.a)


def SchwarzschildMetric(M=1.0, *, dtype=torch.float64, device=None):
    """Schwarzschild = Kerr with a = 0."""
    return KerrMetric(M, 0.0, dtype=dtype, device=device)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def kerr_isco(M, a):
    """Bardeen-Press-Teukolsky analytic ISCO radius (prograde for a>0)."""
    M = torch.as_tensor(M)
    x = a / M
    z1 = 1.0 + _cbrt(1.0 - x * x) * (_cbrt(1.0 + x) + _cbrt(1.0 - x))
    z2 = torch.sqrt(3.0 * x * x + z1 * z1)
    return M * (
        3.0 + z2 - torch.sign(x + 1e-300) * torch.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))
    )


def convert_angles(a, r, theta, phi, theta_obs, phi_obs):
    """Map a global direction at (r, θ, φ) onto the local sky of an observer
    at (θ_obs, φ_obs), for disc-profile models (reference
    `src/metrics/kerr-metric.jl:75-87`). Tensors, or numbers as f64."""
    a, r, theta, phi, theta_obs, phi_obs = (
        v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=torch.float64)
        for v in (a, r, theta, phi, theta_obs, phi_obs)
    )
    dphi = phi - phi_obs
    R = torch.sqrt(r * r + a * a)
    o1 = r * R * torch.sin(theta) * torch.sin(theta_obs) * torch.cos(dphi) + R * R * torch.cos(theta) * torch.cos(theta_obs)
    o2 = R * torch.cos(theta) * torch.sin(theta_obs) * torch.cos(dphi) - r * torch.sin(theta) * torch.cos(theta_obs)
    o3 = torch.sin(theta_obs) * torch.sin(dphi) / torch.sin(theta)
    sigma = r * r + a * a * torch.cos(theta) ** 2
    return -o1 / sigma, -o2 / sigma, o3 / R
