"""Metric dot products, the Gram-Schmidt tetrad frame and the locally
non-rotating frame (LNRF) co-basis (counterpart of
`gradus_tpu/geodesics/tetrads.py`).

Contractions are written as elementwise products and sums, never as a
matmul: on the card a float32 matmul may run in TF32, which keeps about three
decimal digits and breaks these 4×4 contractions.
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = [
    "dotproduct",
    "propernorm",
    "mproject",
    "gramschmidt",
    "tetradframe",
    "tetradframe_matrix",
    "lnrbasis",
    "lnrbasis_matrix",
    "lnrframe",
    "lnrframe_matrix",
    "lowerindices",
    "raiseindices",
]


def dotproduct(g, v1, v2):
    """g_{μν} v1^μ v2^ν for a (..., 4, 4) metric matrix ``g``."""
    return (g * v1[..., :, None] * v2[..., None, :]).sum(dim=(-2, -1))


def propernorm(g, v):
    return dotproduct(g, v, v)


def mproject(g, v, u):
    """Project ``v`` onto ``u`` under ``g`` (reference
    `orthonormalization.jl:20-26`)."""
    return dotproduct(g, v, u) / propernorm(g, u)


def gramschmidt(v, basis, g, passes: int = 2):
    """Orthonormalise ``v`` against the (already orthonormal-ish) ``basis``
    under metric ``g``, with a fixed number of re-projection passes in place
    of the reference's tolerance loop (`orthonormalization.jl:37-48`)."""
    for _ in range(passes):
        p = torch.zeros_like(v)
        for e in basis:
            p = p + mproject(g, v, e)[..., None] * e
        v = v - p
    norm = torch.sqrt(torch.abs(propernorm(g, v)))
    return v / norm[..., None]


def _basis_vec(i, like):
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def tetradframe(m: AbstractMetric, x, v):
    """Orthonormal tetrad (e_t, e_r, e_θ, e_φ) whose first leg is ``v``
    (timelike, with v^t ≠ 0; reference `tetradframe`,
    `orthonormalization.jl:75-104`)."""
    g = m.metric(x)
    v1 = v / torch.sqrt(torch.abs(propernorm(g, v)))[..., None]
    v2 = gramschmidt(_basis_vec(1, v), (v1,), g)
    v3 = gramschmidt(_basis_vec(2, v), (v1, v2), g)
    v4 = gramschmidt(_basis_vec(3, v), (v1, v2, v3), g)
    return v1, v2, v3, v4


def tetradframe_matrix(m: AbstractMetric, x, v):
    """Columns are the tetrad legs."""
    return torch.stack(tetradframe(m, x, v), dim=-1)


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


def lnrframe(m: AbstractMetric, x):
    """LNRF tetrad vectors (indices up): the zero-angular-momentum
    observer's frame (Bardeen 1972; reference `lnrframe`,
    orthonormalization.jl:108-115)."""
    g = m.metric(x)
    omega, alpha, g_rr, g_hh, g_pp, _ = _lnrf_quantities(g)
    z = torch.zeros_like(alpha)
    et = torch.stack([1.0 / alpha, z, z, omega / alpha], dim=-1)
    er = torch.stack([z, 1.0 / torch.sqrt(g_rr), z, z], dim=-1)
    eh = torch.stack([z, z, 1.0 / torch.sqrt(g_hh), z], dim=-1)
    ep = torch.stack([z, z, z, 1.0 / torch.sqrt(g_pp)], dim=-1)
    return et, er, eh, ep


def lnrframe_matrix(m: AbstractMetric, x):
    """Columns are the LNRF legs."""
    return torch.stack(lnrframe(m, x), dim=-1)


def lowerindices(m: AbstractMetric, x, v):
    """g_{μν} v^ν at ``x``."""
    return (m.metric(x) * v[..., None, :]).sum(dim=-1)


def raiseindices(m: AbstractMetric, x, v):
    """g^{μν} v_ν at ``x``."""
    return (m.inverse_metric(x) * v[..., None, :]).sum(dim=-1)
