"""Metric dot products and the locally non-rotating frame (LNRF) co-basis
(counterpart of `gradus_tpu/geodesics/tetrads.py`, the main-path subset).

Contractions are written as elementwise products and sums, never as a
matmul: on the card a float32 matmul may run in TF32, which keeps about three
decimal digits and breaks these 4×4 contractions.
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["dotproduct", "lnrbasis", "lnrbasis_matrix"]


def dotproduct(g, v1, v2):
    """g_{μν} v1^μ v2^ν for a (..., 4, 4) metric matrix ``g``."""
    return (g * v1[..., :, None] * v2[..., None, :]).sum(dim=(-2, -1))


def _lnrf_quantities(g):
    g_tt, g_rr, g_hh, g_pp, g_tp = (
        g[..., 0, 0],
        g[..., 1, 1],
        g[..., 2, 2],
        g[..., 3, 3],
        g[..., 0, 3],
    )
    omega = -g_tp / g_pp
    # norm of (1,0,0,ω): g_tt + 2ω g_tφ + ω² g_φφ = g_tt + ω g_tφ  (< 0)
    nrm2 = g_tt + omega * g_tp
    alpha = torch.sqrt(-nrm2)  # lapse
    return omega, alpha, g_rr, g_hh, g_pp, g_tp


def lnrbasis(m: AbstractMetric, x):
    """LNRF dual co-basis one-forms e^{(ν)}_μ (indices down): the map from
    local momentum components p_{(ν)} to global covariant p_μ.

    e^{(t)} = α dt, e^{(r)} = √g_rr dr, e^{(θ)} = √g_θθ dθ,
    e^{(φ)} = (g_tφ/√g_φφ) dt + √g_φφ dφ."""
    g = m.metric(x)
    _, alpha, g_rr, g_hh, g_pp, g_tp = _lnrf_quantities(g)
    z = torch.zeros_like(alpha)
    et = torch.stack([alpha, z, z, z], dim=-1)
    er = torch.stack([z, torch.sqrt(g_rr), z, z], dim=-1)
    eh = torch.stack([z, z, torch.sqrt(g_hh), z], dim=-1)
    ep = torch.stack([g_tp / torch.sqrt(g_pp), z, z, torch.sqrt(g_pp)], dim=-1)
    return et, er, eh, ep


def lnrbasis_matrix(m: AbstractMetric, x):
    return torch.stack(lnrbasis(m, x), dim=-1)
