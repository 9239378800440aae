"""Impact-parameter pinhole camera: (α, β) ↦ initial velocity (counterpart
of `gradus_tpu/camera/impact.py`).

The observer is stationary in the LNRF; the local momentum for impact
parameters (α, β) at observer radius r_obs is

    p̄_(ν) = (1, p_r, p_θ, p_φ),  p_r = -1/√(1 + a² + b²),
    p_θ = (β/r)·p_r,  p_φ = (α/r)·p_r,

mapped to the global frame via v^μ = g^{μσ} e^{(ν)}_σ p̄_(ν). Both
contractions are elementwise sums (no matmul, so no TF32 on the card).
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.geodesics.tetrads import lnrbasis_matrix
from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["local_momentum", "map_impact_parameters", "lnr_momentum_transform"]


def local_momentum(r_obs, alpha, beta):
    a = alpha / r_obs
    b = beta / r_obs
    pr = -1.0 / torch.sqrt(1.0 + a * a + b * b)
    return torch.stack([torch.ones_like(pr), pr, b * pr, a * pr], dim=-1)


def lnr_momentum_transform(m: AbstractMetric, x):
    """Matrix T with v = T @ p̄: ginv · lnrbasis."""
    ginv = m.inverse_metric(x)
    Tx = lnrbasis_matrix(m, x)
    return (ginv[..., :, :, None] * Tx[..., None, :, :]).sum(dim=-2)


def map_impact_parameters(m: AbstractMetric, x, alpha, beta):
    """Velocity (unconstrained v^t scale) for impact parameters (α, β), which
    broadcast against each other; ``x`` is one observer 4-position."""
    T = lnr_momentum_transform(m, x)
    alpha, beta = torch.broadcast_tensors(
        torch.as_tensor(alpha, dtype=x.dtype, device=x.device),
        torch.as_tensor(beta, dtype=x.dtype, device=x.device),
    )
    p = local_momentum(x[..., 1], alpha, beta)
    return (T * p[..., None, :]).sum(dim=-1)
