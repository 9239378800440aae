"""Precision solvers: inverse ray tracing (counterpart of
`gradus_tpu/transfer/solvers.py`).

Reference: `src/tracing/precision-solvers.jl`. `find_offset_for_radius`
finds the image-plane offset r₀ along direction θₒ such that the traced
geodesic hits the disc at emission radius rₑ: a batched safeguarded Newton
whose derivative dρ/dr₀ comes from one `torch.func.jvp` through
`trace_geodesics` (the lockstep solver, plain torch on the observer's
device; `utils/jvp.py` lifts its constants to duals, which keeps every bit
and saves PyTorch's slow zero-tangent path), with a per-ray bisection
bracket kept by masks.

The rest of the JAX module (`offset_workhorse`, `offset_probe`,
`offset_jacobian_at`, `_post_solve`), which the `xla` transfer-function
backend runs, is not ported yet (ROADMAP queue A, item 2.1). The CUDA
transfer-function path (`transfer/cuda_ctf.py`) needs only
`rtheta_to_alphabeta` and the conserved-quantity redshift.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import LinearGrid
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.integrate.tracing import trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.utils.jvp import jvp
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = ["rtheta_to_alphabeta", "find_offset_for_radius", "impact_parameters_for_radius"]


def rtheta_to_alphabeta(r, theta, alpha0=0.0, beta0=0.0):
    """(r, θ) polar image-plane coordinates → (α, β)
    (reference `_rθ_to_αβ`, transfer-functions/utils.jl:114-118)."""
    return r * torch.cos(theta) + alpha0, r * torch.sin(theta) + beta0


def _make_trace_to_disc(m, x, d, lam_max, thetas, alpha0, beta0, gtol, trace_kwargs):
    """Returns offsets → GeodesicPoint batch (traced against geometry d)."""

    def trace(r_off):
        al, be = rtheta_to_alphabeta(r_off, thetas, alpha0, beta0)
        v = map_impact_parameters(m, x, al, be)
        # reference CTF chart: outer boundary at 2·r_obs
        # (cunningham-transfer-functions.jl:352 `chart_for_metric(m, 2x[2])`)
        return trace_geodesics(
            m,
            x.expand_as(v),
            v,
            (0.0, lam_max),
            geometry=d,
            gtol=gtol,
            chart_outer=2.0 * x[1],
            **trace_kwargs,
        )

    return trace


def find_offset_for_radius(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    *,
    lam_max=None,
    zero_atol: float = 1e-7,
    worst_accuracy_factor: float = 1e-4,
    max_iter: int = 30,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    gtol: float = 1e-2,
    offset_max: float = 4.0,
    r_init=None,
):
    """Batched safeguarded Newton for the image-plane offset.

    r_targets, thetas: broadcastable tensors. Returns (r_offset,
    GeodesicPoint, residual); non-converged entries have r_offset = NaN
    (reference returns NaN likewise, precision-solvers.jl:223-236).

    ``r_init``: optional warm-start offsets; non-finite entries fall back to
    the cold start ``max(20, rₑ)``. The loop reads whether every lane is
    done once an iteration, on the host.
    """
    x = _as_observer(x, m)
    r_targets, thetas = torch.broadcast_tensors(
        torch.as_tensor(r_targets, dtype=x.dtype, device=x.device),
        torch.as_tensor(thetas, dtype=x.dtype, device=x.device),
    )
    if lam_max is None:
        lam_max = 2.0 * x[1]

    # dtype-aware tolerances: the f64 default zero_atol = 1e-7 sits below
    # float32 resolution of ρ ~ r_target, so both scale with the dtype
    eps = torch.finfo(x.dtype).eps
    zero_atol_eff = torch.clamp(32.0 * eps * torch.clamp(r_targets, min=1.0), min=zero_atol)
    accept_tol = torch.maximum(worst_accuracy_factor * r_targets, 10 * zero_atol_eff)

    trace = _make_trace_to_disc(m, x, d, lam_max, thetas, alpha0, beta0, gtol, {})

    def rho_of(r_off):
        return equatorial_project(trace(r_off).x)

    # initial guess (reference: initial_r = max(20, r_target))
    r0 = torch.clamp(r_targets, min=20.0)
    if r_init is not None:
        r_init = torch.as_tensor(r_init, dtype=x.dtype, device=x.device).expand(r0.shape)
        r0 = torch.where(torch.isfinite(r_init) & (r_init > 0.0), r_init, r0)
    lo = torch.zeros_like(r0)  # maps inside the event horizon: y(lo) < 0
    hi = torch.full_like(r0, math.inf)
    have_hi = torch.zeros(r0.shape, dtype=torch.bool, device=x.device)
    upper_limit = offset_max * (r_targets + 20.0)
    # best-seen iterate (reference `best` tracking, precision-solvers.jl:1-10)
    best_r = r0
    best_y = torch.full_like(r0, math.inf)
    # stall exit, f32 only: a lane that has not halved its best |y| in 6
    # iterations is finished and reports its best-seen iterate; in f64 every
    # lane runs to convergence or max_iter, as in the JAX package
    stall_iters = 6 if x.dtype == torch.float32 else max_iter

    r = r0
    done = torch.zeros(r0.shape, dtype=torch.bool, device=x.device)
    since = torch.zeros(r0.shape, dtype=torch.int32, device=x.device)
    it = 0
    while it < max_iter and not bool(done.all()):
        rho, drho = jvp(rho_of, (r,), (torch.ones_like(r),))
        y = rho - r_targets
        improved = torch.abs(y) < best_y
        progressed = torch.abs(y) < 0.5 * best_y
        best_r = torch.where(improved, r, best_r)
        best_y = torch.where(improved, torch.abs(y), best_y)
        since = torch.where(progressed, 0, since + 1)
        # ρ(r₀) is monotone increasing along the primary image direction:
        # update the bracket
        lo = torch.where(y < 0, torch.maximum(lo, r), lo)
        hi = torch.where(y > 0, torch.minimum(hi, r), hi)
        have_hi = have_hi | (y > 0)

        drho_safe = torch.where(torch.abs(drho) < 1e-30, 1.0, drho)
        newton = r - y / drho_safe
        bad = ~torch.isfinite(newton) | (newton <= lo) | (have_hi & (newton >= hi)) | (newton > upper_limit)
        grow = torch.minimum(2.0 * r, upper_limit)
        fallback = torch.where(have_hi, 0.5 * (lo + hi), grow)
        converged = torch.abs(y) < zero_atol_eff
        done = converged | (since >= stall_iters)
        r = torch.where(converged, r, torch.where(bad, fallback, newton))
        it += 1
    # f32: every lane reports its best-seen iterate; f64: converged lanes
    # report the frozen converged iterate and only the others fall back to
    # the best one, as in the JAX package
    r_off = best_r if x.dtype == torch.float32 else torch.where(done, r, best_r)
    gp = trace(r_off)
    resid = equatorial_project(gp.x) - r_targets
    ok = torch.abs(resid) < accept_tol
    return torch.where(ok, r_off, math.nan), gp, resid


def impact_parameters_for_radius(m: AbstractMetric, x, d, r_e, N: int = 500, **kwargs):
    """(α, β) ring tracing to emission radius rₑ
    (reference precision-solvers.jl:298-344)."""
    x = _as_observer(x, m)
    thetas = LinearGrid()(0.0, 2 * math.pi, N, dtype=x.dtype, device=x.device)
    r_off, _, _ = find_offset_for_radius(m, x, d, torch.full((N,), float(r_e), dtype=x.dtype, device=x.device), thetas, **kwargs)
    return rtheta_to_alphabeta(r_off, thetas)


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
