"""Precision-solver helpers (counterpart of the closed-form parts of
`gradus_tpu/transfer/solvers.py`).

The batched jvp Newton of the JAX module (`find_offset_for_radius`,
`offset_workhorse`/`probe`/`jacobian_at`, `_post_solve`,
`impact_parameters_for_radius`) differentiates through the plain lockstep
solver, which is not ported yet (ROADMAP queue A, item 2). The CUDA
transfer-function path (`transfer/cuda_ctf.py`) needs only what is here.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["rtheta_to_alphabeta"]


def rtheta_to_alphabeta(r, theta, alpha0=0.0, beta0=0.0):
    """(r, θ) polar image-plane coordinates → (α, β)
    (reference `_rθ_to_αβ`, transfer-functions/utils.jl:114-118)."""
    return r * torch.cos(theta) + alpha0, r * torch.sin(theta) + beta0


def _p_t_p_phi(m: AbstractMetric, x, v):
    """Covariant (p_t, p_φ) = g·v, written as the two non-zero products of
    each row so that no reduced-precision matmul can reach it."""
    g_tt, _, _, g_pp, g_tp = m.components(x[..., 1], x[..., 2]).unbind(-1)
    return g_tt * v[..., 0] + g_tp * v[..., 3], g_tp * v[..., 0] + g_pp * v[..., 3]


def _conserved_g_helpers(m: AbstractMetric):
    """Closed-form redshift from conserved photon quantities.

    λ = p_φ/(−p_t) is exact in any static axis-symmetric metric; the disc
    four-velocity is Keplerian at exactly rₑ. Returns ``(_lam_of(gp),
    _g_conserved(λ, r_disc))``."""
    from gradus_tpu_torch.orbits.circular import CircularOrbits
    from gradus_tpu_torch.orbits.special_radii import isco as _isco

    r_kep_min = _isco(m) + 1e-6

    def _lam_of(gp_):
        """λ = p_φ/(−p_t) from the (constrained) initial conditions."""
        p_t, p_phi = _p_t_p_phi(m, gp_.x_init, gp_.v_init)
        return p_phi / (-p_t)

    def _g_conserved(lam, r_disc):
        u = CircularOrbits.fourvelocity(
            m,
            (
                torch.maximum(r_disc, r_kep_min.to(r_disc.dtype)),
                torch.full_like(r_disc, math.pi / 2),
            ),
        )
        return 1.0 / (u[..., 0] - lam * u[..., 3])

    return _lam_of, _g_conserved
