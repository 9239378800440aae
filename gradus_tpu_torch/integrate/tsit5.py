"""Tsitouras 5(4) Runge-Kutta step, batched over the ray axis (counterpart of
`gradus_tpu/integrate/tsit5.py`). Coefficients from Tsitouras (2011); the CUDA
kernel `csrc/geodesic_tsit5.cu` carries the same tableau."""

from __future__ import annotations

import torch

__all__ = ["tsit5_step", "hermite_interp", "initial_dt", "TSIT5_C"]

# the tableau's nodes
TSIT5_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)

_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (
        5.86145544294642,
        -12.92096931784711,
        8.159367898576159,
        -0.071584973281401,
        -0.028269050394068383,
    ),
    (
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
    ),
)

# b - bhat: error-estimate weights (embedded 4th-order comparison)
_BTILDE = (
    -0.00178001105222577714,
    -0.0008164344596567469,
    0.007880878010261995,
    -0.1447110071732629,
    0.5823571654525552,
    -0.45808210592918697,
    0.015151515151515152,
)


def _lin(coeffs, ks):
    acc = coeffs[0] * ks[0]
    for c, k in zip(coeffs[1:], ks[1:]):
        acc = acc + c * k
    return acc


def tsit5_step(f, y, dt, k1=None):
    """One Tsit5 step for every ray: ``f(y) -> dy`` over (..., S) states, ``dt``
    per ray. Returns ``(y_new, err_vec, k1, k7)`` with ``k7 = f(y_new)``."""
    dt_ = dt[..., None]
    if k1 is None:
        k1 = f(y)
    ks = [k1]
    for row in _A[:5]:
        ks.append(f(y + dt_ * _lin(row, ks)))
    y_new = y + dt_ * _lin(_A[5], ks)
    k7 = f(y_new)
    ks.append(k7)
    err_vec = dt_ * _lin(_BTILDE, ks)
    return y_new, err_vec, k1, k7


def hermite_interp(theta, y0, y1, f0, f1, dt):
    """Cubic Hermite interpolation on one step: θ ∈ [0, 1] → y(λ0 + θ·dt)."""
    th = theta[..., None] if theta.dim() == dt.dim() else theta
    dt_ = dt[..., None]
    h00 = (1 + 2 * th) * (1 - th) ** 2
    h10 = th * (1 - th) ** 2
    h01 = th * th * (3 - 2 * th)
    h11 = th * th * (th - 1)
    return h00 * y0 + h10 * dt_ * f0 + h01 * y1 + h11 * dt_ * f1


def initial_dt(f, y, abstol, reltol, order: int = 5):
    """Hairer-Nørsett-Wanner automatic initial step size (II.4), batched."""
    sc = abstol + torch.abs(y) * reltol
    f0 = f(y)
    d0 = torch.sqrt(torch.mean((y / sc) ** 2, dim=-1))
    d1 = torch.sqrt(torch.mean((f0 / sc) ** 2, dim=-1))
    h0 = torch.where(
        (d0 < 1e-5) | (d1 < 1e-5),
        torch.full_like(d0, 1e-6),
        0.01 * d0 / torch.clamp(d1, min=1e-30),
    )
    y1 = y + h0[..., None] * f0
    f1 = f(y1)
    d2 = torch.sqrt(torch.mean(((f1 - f0) / sc) ** 2, dim=-1)) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / dmax) ** (1.0 / order),
    )
    return torch.minimum(100.0 * h0, h1)
