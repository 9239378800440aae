"""Target optimisation and visibility testing (counterpart of
`gradus_tpu/transfer/targets.py`).

Reference: `src/tracing/precision-solvers.jl:384-546`: `optimize_for_target`
(NelderMead over (α, β) minimising the closest approach of the traced
geodesic to a target 3-position) and `_is_visible` (re-trace against the
occluding geometry and check that the endpoint has not moved).

As in the JAX package, each refinement round traces a full (n_grid × n_grid)
fan of impact-parameter candidates in one dense trace, keeps the argmin and
shrinks the window around it; a candidate's closest approach is the masked
minimum of its saved trajectory's distance to the target. The rounds are a
host loop between traces. `refine_for_target` polishes the winner by
Gauss-Newton, its Jacobian from the tangent carried through the dense trace
(``v_dot=``, so that on the card the loop still replays a CUDA graph), and
gives the arrival time the exact eikonal derivative under `torch.func.jvp`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.camera.grids import LinearGrid
from gradus_tpu_torch.integrate.tracing import trace_geodesics, trace_geodesics_dense
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.utils.jvp import jvp
from gradus_tpu_torch.utils.linalg import spherical_to_cartesian

__all__ = [
    "closest_approach",
    "refine_for_target",
    "optimize_for_target",
    "impact_parameters_for_target",
    "is_visible",
]


def _take(a, i):
    """``a[..., i]`` row by row: ``i`` has ``a``'s leading shape."""
    return torch.gather(a, -1, i[..., None])[..., 0]


def _masked_sq_dist(traj, nsteps, target_cart):
    """Squared cartesian distance of each saved point to the target, +inf
    past the saved prefix: (..., n_save)."""
    cart = spherical_to_cartesian(traj[..., 0:4])
    dd = ((cart - target_cart) ** 2).sum(-1)
    k = torch.arange(traj.shape[-2], device=traj.device)
    return torch.where(k < nsteps[..., None], dd, math.inf)


def _approach(traj, nsteps, target):
    """(distance, coordinate time) of each trajectory's closest approach to
    the target: the minimum over the saved samples, refined by the parabola
    in d² through the three samples that bracket it."""
    pts = traj[..., 0:4]
    dd = torch.sqrt(_masked_sq_dist(traj, nsteps, spherical_to_cartesian(target)))
    i_min = torch.argmin(dd, dim=-1)
    # parabolic refinement over the three samples bracketing the minimum:
    # removes the O(trajectory-spacing) quantisation of both the distance
    # and the closest-approach time (the reference's continuous distance
    # callback terminates exactly at the approach point)
    n_samp = pts.shape[-2]
    i_c = torch.clamp(i_min, 1, n_samp - 2)
    dm, d0, dp = _take(dd, i_c - 1), _take(dd, i_c), _take(dd, i_c + 1)
    ts = pts[..., 0]
    tm, t0, tp = _take(ts, i_c - 1), _take(ts, i_c), _take(ts, i_c + 1)
    # vertex of the quadratic in d² over the actual (adaptive) abscissae t
    sm, s0, sp = dm * dm, d0 * d0, dp * dp
    am = tm - t0
    ap = tp - t0
    num = am * am * (s0 - sp) - ap * ap * (s0 - sm)
    den = am * (s0 - sp) - ap * (s0 - sm)
    # refine only genuine interior minima with a well-separated bracket
    interior = (
        (i_min == i_c)
        & torch.isfinite(dm)
        & torch.isfinite(dp)
        & (d0 <= dm)
        & (d0 <= dp)
        & (torch.abs(den) > 1e-30)
        & (am < 0)
        & (ap > 0)
    )
    den_safe = torch.where(interior, den, 1.0)
    dt_star = torch.minimum(
        torch.maximum(torch.where(interior, 0.5 * num / den_safe, 0.0), torch.clamp(am, max=0.0)),
        torch.clamp(ap, min=0.0),
    )
    # the quadratic's value at the vertex, by Lagrange evaluation
    lm = (dt_star - 0.0) * (dt_star - ap) / torch.where(interior, am * (am - ap), 1.0)
    l0 = (dt_star - am) * (dt_star - ap) / torch.where(interior, (-am) * (-ap), 1.0)
    lp = (dt_star - am) * (dt_star - 0.0) / torch.where(interior, ap * (ap - am), 1.0)
    s_ref = lm * sm + l0 * s0 + lp * sp
    dist_ref = torch.sqrt(torch.clamp(s_ref, min=0.0))
    # the raw sample where the bracket is invalid (an endpoint minimum)
    dist = torch.where(interior, torch.minimum(dist_ref, d0), _take(dd, i_min))
    t_closest = torch.where(interior, t0 + dt_star, _take(ts, i_min))
    return dist, t_closest


def _dense(m, x0, alphas, betas, lam_max, n_save, mu, chart_outer, ab_dot=None):
    """The dense traces of the impact parameters (α, β) from ``x0``; with
    ``ab_dot``, a pair of tangents of (α, β), also their tangent."""
    if ab_dot is None:
        v = map_impact_parameters(m, x0, alphas, betas)
        return trace_geodesics_dense(m, x0.expand_as(v), v, (0.0, lam_max), mu=mu, n_save=n_save, chart_outer=chart_outer)
    v, v_dot = jvp(lambda a, b: map_impact_parameters(m, x0, a, b), (alphas, betas), ab_dot)
    return trace_geodesics_dense(
        m, x0.expand_as(v), v, (0.0, lam_max), mu=mu, n_save=n_save, chart_outer=chart_outer, v_dot=v_dot
    )


def closest_approach(
    m: AbstractMetric,
    x0,
    alphas,
    betas,
    target,
    *,
    lam_max: float | None = None,
    n_save: int = 256,
    mu: float = 0.0,
    chart_outer: float | None = None,
):
    """Minimum cartesian distance between each traced geodesic and the target
    3-position (r, θ, φ), over the saved trajectory (reference distance
    callback, precision-solvers.jl:473-486). Returns (dist, t_closest, gp)."""
    x0 = _as_observer(x0, m)
    if lam_max is None:
        lam_max = 2.0 * float(x0[1])
    if chart_outer is None:
        chart_outer = 2.0 * float(x0[1])
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    betas = torch.broadcast_to(torch.as_tensor(betas, dtype=x0.dtype, device=x0.device), alphas.shape)
    gp, traj, _, nsteps = _dense(m, x0, alphas, betas, lam_max, n_save, mu, chart_outer)
    dist, t_closest = _approach(traj, nsteps, torch.as_tensor(target, dtype=x0.dtype, device=x0.device))
    return dist, t_closest, gp


def optimize_for_target(
    target,
    m: AbstractMetric,
    x0,
    *,
    n_grid: int = 9,
    n_rounds: int = 8,
    span0: float | None = None,
    center0=(0.0, 0.0),
    lam_max: float | None = None,
    n_save: int = 256,
    mu: float = 0.0,
):
    """Find the image-plane (α, β) whose geodesic passes closest to the
    target 3-position (reference `optimize_for_target`,
    precision-solvers.jl:518-535). Returns (α, β, GeodesicPoint at the hit,
    accuracy).

    Each round traces an n_grid × n_grid candidate fan in one batch and zooms
    the window onto the argmin; the window shrinks by n_grid/2 a round, so 8
    rounds at the default span resolve the target to ~1e-3 r_g."""
    x0 = _as_observer(x0, m)
    target = torch.as_tensor(target, dtype=x0.dtype, device=x0.device)
    if span0 is None:
        # the target's cylindrical radius bounds the impact parameter scale
        span0 = float(4.0 * (abs(float(target[0])) + 10.0))

    ca, cb = (torch.as_tensor(c, dtype=x0.dtype, device=x0.device) for c in center0)
    span = torch.as_tensor(span0, dtype=x0.dtype, device=x0.device)
    off = LinearGrid()(-0.5, 0.5, n_grid, dtype=x0.dtype, device=x0.device)

    best = None
    for _ in range(n_rounds):
        al_g = torch.broadcast_to((ca + span * off)[:, None], (n_grid, n_grid)).reshape(-1)
        be_g = torch.broadcast_to((cb + span * off)[None, :], (n_grid, n_grid)).reshape(-1)
        dist, t_closest, gp = closest_approach(m, x0, al_g, be_g, target, lam_max=lam_max, n_save=n_save, mu=mu)
        i = torch.argmin(dist)
        ca, cb = al_g[i], be_g[i]
        gp_i = gp[i]
        # report the closest-approach time (the reference's distance
        # callback terminates there, so its gp.x[1] is exactly this)
        gp_i = dataclasses.replace(gp_i, x=torch.cat([t_closest[i].reshape(1), gp_i.x[1:]]))
        best = (ca, cb, gp_i, dist[i])
        # the window shrinks to ±1 grid cell around the winner
        span = span * (2.0 / (n_grid - 1))
    return best


def _miss_vector(traj, nsteps, target_cart, temp_floor):
    """Softmin-weighted closest point of each trajectory minus the target:
    smooth in (α, β) between samples, so the Gauss-Newton Jacobian is well
    defined; the temperature floor keeps the weights finite-width even at
    near-exact hits.

    The samples past the saved prefix get the logit −∞ after the division
    by the temperature, not before: the JAX package divides their +∞
    distance by it, whose tangent is then ∞ and the softmax's 0·∞, so its
    Jacobian, and the polished (α, β), are NaN whenever a ray saves fewer
    than ``n_save`` states (ROADMAP C). The weights are the same."""
    dd = _masked_sq_dist(traj, nsteps, target_cart)
    saved = torch.isfinite(dd)
    temp = dd.min(dim=-1, keepdim=True).values + temp_floor
    logits = torch.where(saved, -torch.where(saved, dd, 0.0) / temp, -math.inf)
    w = torch.softmax(logits, dim=-1)
    p_star = (w[..., None] * spherical_to_cartesian(traj[..., 0:4])).sum(-2)
    return p_star - target_cart


class _RefinedArrival(torch.autograd.Function):
    """The Gauss-Newton polish of (α, β) onto the target and the arrival
    time there. Its forward runs the traces (on plain tensors, so a loop on
    the card replays a CUDA graph even within `torch.func.jvp`); its jvp is
    the eikonal derivative of the arrival time from the saved covariant
    photon momentum k_μ alone, and zero for (α, β) and the distance."""

    @staticmethod
    def forward(target, ab0, m, x0, iters, lam_max, n_save, mu, damping, chart_outer):
        tgt_cart = spherical_to_cartesian(target)
        temp_floor = (1e-3 * target[0]) ** 2
        ab = torch.as_tensor(ab0, dtype=x0.dtype, device=x0.device)
        # one trace of the ray twice, each copy with its own tangent: the
        # two columns of the Jacobian
        eye = torch.eye(2, dtype=x0.dtype, device=x0.device)
        for _ in range(iters):
            (_, traj, _, nsteps), (_, traj_dot, _, _) = _dense(
                m, x0, ab[0].repeat(2), ab[1].repeat(2), lam_max, n_save, mu, chart_outer, (eye[0], eye[1])
            )
            r_vec, cols = jvp(lambda tr: _miss_vector(tr, nsteps, tgt_cart, temp_floor), (traj,), (traj_dot,))
            r_vec = r_vec[0]
            # the 2×2 normal equations, solved in closed form
            a = (cols[0] * cols[0]).sum() + damping
            b = (cols[0] * cols[1]).sum()
            c = (cols[1] * cols[1]).sum() + damping
            g0, g1 = (cols[0] * r_vec).sum(), (cols[1] * r_vec).sum()
            det = a * c - b * b
            ab = ab - torch.stack([(c * g0 - b * g1) / det, (a * g1 - b * g0) / det])

        _, traj, _, nsteps = _dense(m, x0, ab[0:1], ab[1:2], lam_max, n_save, mu, chart_outer)
        dist, t = _approach(traj, nsteps, target)
        # photon 4-momentum (covariant) at the closest-approach sample
        i = torch.argmin(_masked_sq_dist(traj, nsteps, tgt_cart), dim=-1)[0]
        x_c, k_up = traj[0, i, 0:4], traj[0, i, 4:8]
        k_dn = (m.metric(x_c) * k_up).sum(-1)
        return ab, t[0], dist[0], k_dn

    @staticmethod
    def setup_context(ctx, inputs, output):
        ab, _, dist, k_dn = output
        ctx.mark_non_differentiable(ab, dist, k_dn)
        ctx.save_for_forward(k_dn)

    @staticmethod
    def jvp(ctx, target_dot, *_):
        (k_dn,) = ctx.saved_tensors
        # phase conservation along the connecting null ray: k_μ δx^μ = 0 at
        # the arrival event → δt* = −(k_r δr + k_θ δθ + k_φ δφ)/k_t
        dt = -(k_dn[1] * target_dot[0] + k_dn[2] * target_dot[1] + k_dn[3] * target_dot[2]) / k_dn[0]
        return None, dt, None, None


def refine_for_target(
    target,
    m: AbstractMetric,
    x0,
    ab0,
    *,
    iters: int = 3,
    lam_max: float | None = None,
    n_save: int = 256,
    mu: float = 0.0,
    damping: float = 1e-10,
):
    """Differentiable polish of the image-plane (α, β) onto a target
    3-position, from a pattern-search seed ``ab0``.

    Two pieces:

    - a Gauss-Newton loop on the softmin-smoothed 3D miss vector, whose
      (3×2) Jacobian comes from forward mode through the integrator (the
      tangent carried through the dense trace);
    - the returned arrival time carries the exact eikonal derivative
      ∂t*/∂p = −k_i/k_t under `torch.func.jvp` with respect to the target
      (phase conservation along the null ray, k the photon 4-momentum at
      the approach point), so derivatives with respect to the target, and
      hence the corona's (r, h), are free of sample-quantisation noise. The
      traces run on plain tensors within the transform.

    Returns ``(ab, t_closest, dist)``."""
    x0 = _as_observer(x0, m)
    target = torch.as_tensor(target, dtype=x0.dtype, device=x0.device)
    if lam_max is None:
        lam_max = 2.0 * float(x0[1])
    chart_outer = 2.0 * float(x0[1])
    ab, t, dist, _ = _RefinedArrival.apply(target, ab0, m, x0, iters, lam_max, n_save, mu, damping, chart_outer)
    return ab, t, dist


def impact_parameters_for_target(target, m: AbstractMetric, x0, **kwargs):
    """(α, β, accuracy) convenience wrapper (reference
    precision-solvers.jl:537-546)."""
    a, b, _, acc = optimize_for_target(target, m, x0, **kwargs)
    return a, b, acc


def is_visible(
    m: AbstractMetric,
    d,
    gp,
    *,
    lam_max: float,
    atol: float = 1e-6,
    gtol: float = 1e-2,
    chart_outer: float | None = None,
):
    """Re-trace each geodesic from its initial conditions against geometry
    ``d``; the original endpoint is visible if the re-trace ends at (within
    ``atol`` of, in squared cartesian distance) the same point, i.e. nothing
    occludes it (reference `_is_visible`, precision-solvers.jl:384-398).
    Batched over ``gp``."""
    kwargs = {} if chart_outer is None else dict(chart_outer=chart_outer)
    gp2 = trace_geodesics(m, gp.x_init, gp.v_init, (0.0, lam_max), geometry=d, gtol=gtol, constrain=False, **kwargs)
    dist2 = ((spherical_to_cartesian(gp.x) - spherical_to_cartesian(gp2.x)) ** 2).sum(-1)
    return dist2 < atol
