"""Precision solvers: inverse ray tracing (counterpart of
`gradus_tpu/transfer/solvers.py`).

Reference: `src/tracing/precision-solvers.jl`. `find_offset_for_radius`
finds the image-plane offset r₀ along direction θₒ such that the traced
geodesic hits the disc at emission radius rₑ: a batched safeguarded Newton
whose derivative dρ/dr₀ is a forward-mode trace through the lockstep solver
(plain torch on the observer's device), with a per-ray bisection bracket
kept by masks. `offset_workhorse`, `offset_probe` and `offset_jacobian_at`
add the redshift, the thick-disc visibility re-trace and the Jacobian
|∂(α,β)/∂(ρ,g)| from two more forward-mode traces (`_post_solve`): the
`xla` transfer-function backend.

Every derivative is `trace_geodesics(..., v_dot=...)`: the tangent is
carried through the lockstep loop explicitly, so on the card the loop
replays a CUDA graph, and the camera before the trace and the projection
after it are lifted jvps (`utils/jvp.py`, which keeps every bit and saves PyTorch's slow
zero-tangent path). The bits are those of one `torch.func.jvp` around the
whole trace.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gradus_tpu_torch.camera.grids import LinearGrid
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.utils.jvp import jvp
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = [
    "rtheta_to_alphabeta",
    "find_offset_for_radius",
    "impact_parameters_for_radius",
    "offset_workhorse",
    "offset_probe",
    "offset_jacobian_at",
]


def rtheta_to_alphabeta(r, theta, alpha0=0.0, beta0=0.0):
    """(r, θ) polar image-plane coordinates → (α, β)
    (reference `_rθ_to_αβ`, transfer-functions/utils.jl:114-118)."""
    return r * torch.cos(theta) + alpha0, r * torch.sin(theta) + beta0


def _make_trace_to_disc(m, x, d, lam_max, thetas, alpha0, beta0, gtol, trace_kwargs):
    """Returns offsets → GeodesicPoint batch (traced against geometry d);
    with ``r_dot``, a tangent of the offsets, the pair of the trace and its
    tangent (`trace_geodesics(..., v_dot=...)`)."""

    def velocity(r_off):
        al, be = rtheta_to_alphabeta(r_off, thetas, alpha0, beta0)
        return map_impact_parameters(m, x, al, be)

    def trace(r_off, r_dot=None):
        if r_dot is None:
            v, v_dot = velocity(r_off), None
        else:
            v, v_dot = jvp(velocity, (r_off,), (r_dot,))
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
            v_dot=v_dot,
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

    def rho_and_slope(r_off):
        """ρ(r₀) and dρ/dr₀, the tangent carried through the trace."""
        gp, gp_dot = trace(r_off, torch.ones_like(r_off))
        return jvp(equatorial_project, (gp.x,), (gp_dot.x,))

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
        rho, drho = rho_and_slope(r)
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


# the float fields of a GeodesicPoint: what a jvp after the trace reads
_GP_FLOATS = ("lam_min", "lam_max", "x_init", "v_init", "x", "v")


def _jvp_after_trace(post, gp, gp_dot):
    """(post(gp), its tangent), ``post`` a function of a `GeodesicPoint`
    whose float fields carry the tangents of ``gp_dot`` (a dual may not be
    a broadcast view)."""
    return jvp(
        lambda fields: post(dataclasses.replace(gp, **fields)),
        ({k: getattr(gp, k).contiguous() for k in _GP_FLOATS},),
        ({k: getattr(gp_dot, k).contiguous() for k in _GP_FLOATS},),
    )


def _post_solve(
    m,
    x,
    d,
    r_targets,
    thetas,
    r_off,
    gp,
    ok,
    *,
    redshift_pf,
    jacobian_disc,
    verify_disc,
    lam_max,
    alpha0,
    beta0,
    gtol,
):
    """(g, J, t, ok, cond) at already-solved offsets: redshift, thick-disc
    visibility re-trace, and the |∂(α,β)/∂(ρ,g)| Jacobian from two
    forward-mode traces."""
    conserved_g = redshift_pf is None
    if conserved_g:
        _lam_of, _g_conserved = _conserved_g_helpers(m)
    if jacobian_disc is None:
        jacobian_disc = d

    r_safe = torch.where(ok, r_off, torch.clamp(r_targets, min=20.0))
    if conserved_g:
        # evaluate at exactly rₑ (not the achieved ρ): the Newton residual
        # (≤ zero_atol) would otherwise re-introduce θ-jitter in g
        g = _g_conserved(_lam_of(gp), r_targets)
    else:
        g = redshift_pf(m, gp, lam_max)
    t = gp.x[..., 0]

    alpha, beta = rtheta_to_alphabeta(r_safe, thetas, alpha0, beta0)

    thick = verify_disc is not None
    if thick:
        # thick-disc visibility: re-trace the solved ray against the real
        # disc; if the hit moved (occluded by the disc's own bulge) the
        # sample is invisible (reference `_thick_workhorse`,
        # cunningham-transfer-functions.jl:251-300)
        gp2 = trace_geodesics(
            m,
            gp.x_init,
            gp.v_init,
            (0.0, lam_max),
            geometry=verify_disc,
            gtol=gtol,
            chart_outer=2.0 * x[1],
            constrain=False,
        )
        dx = gp2.x - gp.x
        rel = torch.sqrt(torch.sum(dx * dx, dim=-1)) / torch.sqrt(torch.sum(gp.x * gp.x, dim=-1))
        ok = ok & (gp2.status == gp.status) & (rel < 1e-3)
        jac_terminators = (domain_upper_hemisphere(),)
    else:
        jac_terminators = ()

    def velocity(ab):
        return map_impact_parameters(m, x, ab[..., 0], ab[..., 1])

    def rho_g(gp_):
        rho_ = equatorial_project(gp_.x)
        if conserved_g:
            # the redshift field over the image plane: λ(α,β) analytic,
            # ρ(α,β) through the trace
            g_ = _g_conserved(_lam_of(gp_), rho_)
        else:
            g_ = redshift_pf(m, gp_, lam_max)
        if thick:
            # inside the disc inner edge the redshift is ill-defined: zero it
            # so the Jacobian diverges and the sample filters out (reference
            # jacobian_∂αβ_∂gr, precision-solvers.jl:419-434)
            g_ = torch.where(rho_ < verify_disc.inner_radius(), 0.0, g_)
        return torch.stack([rho_, g_], dim=-1)

    def slope(ab, e):
        """∂(ρ, g)/∂(α, β) along ``e``."""
        v, v_dot = jvp(velocity, (ab,), (e,))
        gp_, gp_dot = trace_geodesics(
            m,
            x.expand_as(v),
            v,
            (0.0, lam_max),
            geometry=jacobian_disc,
            chart_outer=2.0 * x[1],
            terminate_fns=jac_terminators,
            v_dot=v_dot,
        )
        return _jvp_after_trace(rho_g, gp_, gp_dot)[1]

    ab = torch.stack([alpha, beta], dim=-1)
    e_a = torch.zeros_like(ab)
    e_a[..., 0] = 1.0
    e_b = torch.zeros_like(ab)
    e_b[..., 1] = 1.0
    d_da = slope(ab, e_a)
    d_db = slope(ab, e_b)
    det = d_da[..., 0] * d_db[..., 1] - d_da[..., 1] * d_db[..., 0]
    J = torch.abs(1.0 / det)
    # conditioning of the determinant: |det| against the magnitude of the
    # cancelling terms (a diagnostic, surfaced through return_samples)
    cond = torch.abs(det) / (torch.abs(d_da[..., 0] * d_db[..., 1]) + torch.abs(d_da[..., 1] * d_db[..., 0]) + 1e-300)
    return g, J, t, ok & torch.isfinite(J), cond


def offset_workhorse(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    *,
    redshift_pf=None,
    jacobian_disc=None,
    verify_disc=None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    zero_atol: float = 1e-7,
    max_iter: int = 30,
    gtol: float = 1e-2,
    r_init=None,
    return_r_off: bool = False,
):
    """(g, J, t, ok) for each (rₑ, θ) pair: redshift, Jacobian
    |∂(α,β)/∂(g,rₑ)| and coordinate arrival time at the solved offset
    (reference `_rear_workhorse`, cunningham-transfer-functions.jl:226-249,
    and `jacobian_∂αβ_∂gr`, precision-solvers.jl:401-451).

    With ``redshift_pf=None`` g comes from the conserved photon quantities
    E = −p_t, L = p_φ and the Keplerian disc four-velocity at exactly rₑ,
    g = 1 / (uᵗ(rₑ) − λ uᶲ(rₑ)) with λ = L/E: no integration noise, which
    the near-extremal samples of the transfer function need. An explicit
    ``redshift_pf`` gives the endpoint dot product instead.

    ``r_init`` warm-starts the Newton solve; ``return_r_off=True`` appends
    the solved offsets and the conditioning ``cond`` to the output."""
    x = _as_observer(x, m)
    if lam_max is None:
        lam_max = 2.0 * x[1]
    r_off, gp, _ = find_offset_for_radius(
        m,
        x,
        d,
        r_targets,
        thetas,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        zero_atol=zero_atol,
        max_iter=max_iter,
        gtol=gtol,
        r_init=r_init,
    )
    g, J, t, ok, cond = _post_solve(
        m,
        x,
        d,
        r_targets,
        thetas,
        r_off,
        gp,
        torch.isfinite(r_off),
        redshift_pf=redshift_pf,
        jacobian_disc=jacobian_disc,
        verify_disc=verify_disc,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        gtol=gtol,
    )
    if return_r_off:
        return g, J, t, ok, r_off, cond
    return g, J, t, ok


def offset_probe(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    *,
    redshift_pf=None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    zero_atol: float = 1e-7,
    max_iter: int = 30,
    gtol: float = 1e-2,
    r_init=None,
):
    """g-only workhorse for the extremal search: offset solve, redshift and
    arrival time, no Jacobian. Returns (r_off, g, t, ok); the golden-section
    search evaluates `offset_jacobian_at` once, batched, at the end."""
    x = _as_observer(x, m)
    if lam_max is None:
        lam_max = 2.0 * x[1]
    r_off, gp, _ = find_offset_for_radius(
        m,
        x,
        d,
        r_targets,
        thetas,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        zero_atol=zero_atol,
        max_iter=max_iter,
        gtol=gtol,
        r_init=r_init,
    )
    if redshift_pf is None:
        _lam_of, _g_conserved = _conserved_g_helpers(m)
        g = _g_conserved(_lam_of(gp), torch.as_tensor(r_targets, dtype=x.dtype, device=x.device).expand_as(r_off))
    else:
        g = redshift_pf(m, gp, lam_max)
    return r_off, g, gp.x[..., 0], torch.isfinite(r_off)


def offset_jacobian_at(
    m: AbstractMetric,
    x,
    d,
    r_targets,
    thetas,
    r_off,
    *,
    redshift_pf=None,
    jacobian_disc=None,
    verify_disc=None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    gtol: float = 1e-2,
):
    """(g, J, t, ok, cond) at already-solved offsets: one re-trace for the
    endpoint and two forward-mode traces for the Jacobian, no Newton loop;
    ``cond`` is the determinant's conditioning (see `_post_solve`)."""
    x = _as_observer(x, m)
    kw = dict(dtype=x.dtype, device=x.device)
    r_targets, thetas, r_off = torch.broadcast_tensors(
        torch.as_tensor(r_targets, **kw), torch.as_tensor(thetas, **kw), torch.as_tensor(r_off, **kw)
    )
    if lam_max is None:
        lam_max = 2.0 * x[1]
    ok = torch.isfinite(r_off)
    r_safe = torch.where(ok, r_off, torch.clamp(r_targets, min=20.0))
    gp = _make_trace_to_disc(m, x, d, lam_max, thetas, alpha0, beta0, gtol, {})(r_safe)
    return _post_solve(
        m,
        x,
        d,
        r_targets,
        thetas,
        r_off,
        gp,
        ok,
        redshift_pf=redshift_pf,
        jacobian_disc=jacobian_disc,
        verify_disc=verify_disc,
        lam_max=lam_max,
        alpha0=alpha0,
        beta0=beta0,
        gtol=gtol,
    )
