"""Deformed/parametrized non-Kerr metrics: Johannsen, Johannsen-Psaltis, NoZ,
bumblebee, and dilaton-axion (counterpart of `gradus_tpu/metrics/deformed.py`,
the same expressions).

None has a hand-derived Jacobian: the geodesic right-hand side takes the
AD `components5_jac` of `AbstractMetric`, and the CUDA integrator evaluates
each ``components5`` on forward-mode dual numbers (`csrc/metrics.cuh`).
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = [
    "JohannsenMetric",
    "JohannsenPsaltisMetric",
    "NoZMetric",
    "BumblebeeMetric",
    "DilatonAxion",
]


def _kerr_horizon(m):
    return m.M + torch.sqrt(m.M**2 - m.a**2)


class JohannsenMetric(AbstractMetric):
    """Johannsen (2013) deformation metric: spin ``a`` + deviation parameters
    ``α13, α22, α52, ϵ3`` (reference `src/metrics/johannsen-ad.jl:49-67`)."""

    def __init__(
        self,
        M=1.0,
        a=0.0,
        alpha13=0.0,
        alpha22=0.0,
        alpha52=0.0,
        eps3=0.0,
        *,
        dtype=torch.float64,
        device=None,
    ):
        super().__init__()
        self._register_params(
            dtype, device, M=M, a=a, alpha13=alpha13, alpha22=alpha22, alpha52=alpha52, eps3=eps3
        )

    def components5(self, r, theta):
        M, a = self.M, self.a
        A1 = 1.0 + self.alpha13 * (M / r) ** 3
        A2 = 1.0 + self.alpha22 * (M / r) ** 2
        A5 = 1.0 + self.alpha52 * (M / r) ** 2
        f = self.eps3 * M**3 / r
        sin2 = torch.sin(theta) ** 2
        sigma = r * r + a * a * (1.0 - sin2) + f
        delta = r * r - 2.0 * M * r + a * a
        r2a2 = r * r + a * a

        denom = (r2a2 * A1 - a * a * A2 * sin2) ** 2
        tt = -sigma * (delta - a * a * A2 * A2 * sin2)
        rr = sigma / (delta * A5)
        hh = sigma
        pp = sigma * sin2 * (r2a2**2 * A1**2 - a * a * delta * sin2)
        tp = -a * sigma * sin2 * (r2a2 * A1 * A2 - delta)
        return (tt / denom, rr, hh, pp / denom, tp / denom)

    def inner_radius(self):
        return _kerr_horizon(self)


class JohannsenPsaltisMetric(AbstractMetric):
    """Johannsen & Psaltis (2011) deformed Kerr with deviation ``ϵ3``
    (reference `src/metrics/johannsen-psaltis-ad.jl`)."""

    def __init__(self, M=1.0, a=0.0, eps3=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, eps3=eps3)

    def components5(self, r, theta):
        M, a = self.M, self.a
        sin2 = torch.sin(theta) ** 2
        sigma = r * r + a * a * (1.0 - sin2)
        h = self.eps3 * M**3 * r / sigma**2
        delta = r * r - 2.0 * M * r + a * a

        tt = -(1.0 + h) * (1.0 - 2.0 * M * r / sigma)
        rr = sigma * (1.0 + h) / (delta + a * a * sin2 * h)
        hh = sigma
        term1 = sin2 * (r * r + a * a + 2.0 * a * a * M * r * sin2 / sigma)
        term2 = h * a * a * (sigma + 2.0 * M * r) * sin2**2 / sigma
        pp = term1 + term2
        tp = -2.0 * a * M * r * sin2 * (1.0 + h) / sigma
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        return _kerr_horizon(self)


class NoZMetric(AbstractMetric):
    """"No-Z" parametrized non-Kerr metric with deviation ``ϵ``
    (reference `src/metrics/noz-metric.jl:55-120`; note the dy² = sin²θ dθ²
    coordinate factor folded into g_θθ)."""

    def __init__(self, M=1.0, a=0.0, eps=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, eps=eps)

    def components5(self, r, theta):
        M, a = self.M, self.a
        sin2 = torch.sin(theta) ** 2
        y = torch.cos(theta)
        e = self.eps * M * a * y

        sig = r * r + a * a * y * y
        den = sig * sig + (r * r - 2.0 * M * r + a * a * y * y) * e

        tt = -1.0 + (2.0 * M * r * sig) / den
        pp = (
            (1.0 - y * y)
            * (sig + e)
            * (
                r**4
                + a**4 * y * y
                + r * r * (a * a + a * a * y * y + e)
                + a * a * e
                + 2.0 * M * r * (a * a - a * a * y * y - e)
            )
        ) / den
        rr = (sig + e) / (r * r - 2.0 * M * r + a * a)
        yy = (sig + e) / (1.0 - y * y)
        tp = -(2.0 * M * r * a * (1.0 - y * y) * (sig + e)) / den
        return (tt, rr, yy * sin2, pp, tp)

    def inner_radius(self):
        return _kerr_horizon(self)


class BumblebeeMetric(AbstractMetric):
    """Lorentz-violating bumblebee-gravity black hole, slow-rotation
    approximation (|a| < 0.3), LSB parameter ``l``
    (reference `src/metrics/bumblebee-ad.jl:25-52`)."""

    def __init__(self, M=1.0, a=0.0, l=0.0, *, dtype=torch.float64, device=None):  # noqa: E741
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, l=l)

    def components5(self, r, theta):
        M, a, l = self.M, self.a, self.l  # noqa: E741
        sin2 = torch.sin(theta) ** 2
        delta = (r * r - 2.0 * M * r) / (l + 1.0)
        tt = -(1.0 - 2.0 * M / r)
        rr = r * r / delta
        hh = r * r
        pp = r * r * sin2
        tp = -2.0 * M * a * sin2 / r
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        return _kerr_horizon(self)


class DilatonAxion(AbstractMetric):
    """Einstein-Maxwell-dilaton-axion black hole, García et al. (1995)
    (reference `src/metrics/dilaton-axion-ad.jl:57-76`)."""

    def __init__(self, M=1.0, a=0.5, beta=0.0, b=1.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, beta=beta, b=b)

    def guarded_ratios(self):
        """(β/b, β/a, β/(ab)), each 0 where β = 0 and with a zero divisor
        replaced by 1 (β = 0 ⇒ all β-ratios 0, matching the reference)."""
        beta, a, b = self.beta, self.a, self.b

        def ratio(d):
            return torch.where(beta == 0.0, 0.0, beta / torch.where(d == 0.0, 1.0, d))

        return ratio(b), ratio(a), ratio(a * b)

    def components5(self, r, theta):
        M, a, beta, b = self.M, self.a, self.beta, self.b
        R = M
        bb, ba, bab = self.guarded_ratios()

        sin2 = torch.sin(theta) ** 2
        csc2 = 1.0 / sin2
        sigma = r * r + a * a * torch.cos(theta) ** 2
        delta = r * r + a * a - 2.0 * R * r
        delta_hat = delta - (beta * beta + 2.0 * b * r) - R * (R + 2.0 * b) * bb * bb
        sigma_hat = (
            sigma
            - (beta * beta + 2.0 * b * r)
            + R * R * bb * (bb - 2.0 * a * torch.cos(theta))
        )
        dlt = r * r - 2.0 * b * r + a * a
        W = 1.0 + (bab * (2.0 * torch.cos(theta) - bab) + ba * ba) * csc2
        A = dlt * dlt - delta_hat * (W * a * torch.sin(theta)) ** 2

        tt = -(delta_hat - a * a * sin2) / sigma_hat
        rr = sigma_hat / delta_hat
        hh = sigma_hat
        pp = A * sin2 / sigma_hat
        tp = -a * (dlt - delta_hat * W) * sin2 / sigma_hat
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        bb, _, _ = self.guarded_ratios()
        return (
            self.M
            + self.b
            + torch.sqrt(
                (self.M + self.b) ** 2
                - self.a**2
                + self.beta**2
                - (self.M - 2 * self.b) * self.M * bb**2
            )
        )
