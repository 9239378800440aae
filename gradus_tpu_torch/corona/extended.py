"""Extended coronae: ring and disc coronae with time-dependent emissivity
profiles (counterpart of `gradus_tpu/corona/extended.py`).

Reference: `src/corona/models/ring.jl` (β-slice "beachball" arm tracing:
`corona_arms` :456, `_ring_arm!` :388, `_split_arms_indices` :346,
`split_into_branches` :566) and `src/corona/radial.jl:165-325`
(`TimeDependentRadialDiscProfile`, `RingCoronaProfile`, `DiscCoronaProfile`).

As in the JAX package, every (ring, β slice, local angle) triple is one ray
of one batched trace (`trace_geodesics`, the lockstep solver on the
metric's device; on the card its loop replays a CUDA graph): a disc
corona's whole ring stack is one flat batch. Each slice's extremal-radius
directions are then refined by a golden-section search whose probes, all
slices and rings at once, are one trace each. The arm split, the per-arm
radial sort and the Dauser emissivity are row-wise tensor programs over
(ring, slice) rows; the host reads nothing between the traces.

The profiles' methods take a radius ``r`` of any shape. A profile whose
fields carry a leading ring axis (a disc corona's stack) returns that axis
first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from gradus_tpu_torch.camera.grids import LinearGrid
from gradus_tpu_torch.corona.models import (
    RingCorona,
    co_rotating_velocity,
    source_velocity,
    stationary_velocity,
)
from gradus_tpu_torch.corona.spectra import PowerLawSpectrum
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.utils.interp import linear_interp
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = [
    "stationary_velocity",
    "co_rotating_velocity",
    "source_velocity",
    "default_beta_angles",
    "rodrigues_rotate",
    "rotated_sky_angles",
    "TimeDependentRadialDiscProfile",
    "RingCoronaProfile",
    "DiscCoronaProfile",
    "NearFieldBlendedProfile",
    "ring_corona_profile",
    "ring_corona_profile_hybrid",
    "disc_corona_profile",
    "disc_corona_profile_hybrid",
    "DiscCoronaHybridProfile",
]


def default_beta_angles(n: int = 100, dtype=torch.float64, device=None):
    """Default β slice angles (reference `DEFAULT_β_ANGLES`, extended.jl:49-53):
    n angles evenly in [0, π)."""
    return LinearGrid()(0.0, math.pi - math.pi / n, n, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Slice geometry: rotate the poloidal fan around the local radial axis
# ---------------------------------------------------------------------------


def rodrigues_rotate(k, v, theta):
    """Rodrigues rotation of v by theta about unit axis k
    (reference emissivity.jl:220)."""
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    k = torch.broadcast_to(k, torch.broadcast_shapes(k.shape, v.shape))
    v = torch.broadcast_to(v, k.shape)
    kxv = torch.linalg.cross(k, v, dim=-1)
    kdv = (k * v).sum(-1, keepdim=True)
    return v * c + kxv * s + k * kdv * (1.0 - c)


def _cart_local_direction(theta, phi):
    phi = torch.as_tensor(phi, dtype=theta.dtype, device=theta.device)
    return torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )


def _sky_angles(b):
    """Local-sky (θ, φ) of cartesian directions ``b`` (..., 3)."""
    ph = torch.atan2(b[..., 1], b[..., 0])
    th = torch.atan2(torch.sqrt(b[..., 0] ** 2 + b[..., 1] ** 2), b[..., 2])
    return th, ph


def rotated_sky_angles(theta0, deltas, betas):
    """Local-sky (θ, φ) of the fan directions: poloidal angles `deltas` offset
    from the axis direction θ₀, rotated by each slice angle β about the axis
    (reference `rotatorfunctor`, ring.jl:104-119). Returns (th, ph) of shape
    (n_beta, n_delta)."""
    k = _cart_local_direction(theta0, 0.0)
    q = _cart_local_direction(deltas + theta0, 0.0)  # (n_delta, 3)
    return _sky_angles(rodrigues_rotate(k, q[None, :, :], betas[:, None]))


# ---------------------------------------------------------------------------
# Time-dependent radial disc profile
# ---------------------------------------------------------------------------


def _rowwise_interp(xq, xs, ys, n):
    """`utils.interp.masked_sorted_interp` row by row: ``xs``, ``ys`` (..., P)
    sorted rows whose valid prefixes have lengths ``n`` (...), queries ``xq``
    (..., Q). As there, the index's upper clip n − 2 is negative with fewer
    than 2 valid knots, and the index then wraps to the row's tail."""
    P = xs.shape[-1]
    idx = torch.searchsorted(xs.contiguous(), xq.contiguous(), right=True) - 1
    idx = torch.minimum(torch.clamp(idx, min=0), (n - 2)[..., None])
    i0, i1 = torch.remainder(idx, P), torch.remainder(idx + 1, P)
    x0, x1 = torch.gather(xs, -1, i0), torch.gather(xs, -1, i1)
    w = torch.clamp((xq - x0) / torch.where(x1 <= x0, 1.0, x1 - x0), 0.0, 1.0)
    return torch.gather(ys, -1, i0) * (1 - w) + torch.gather(ys, -1, i1) * w


@dataclasses.dataclass(frozen=True)
class TimeDependentRadialDiscProfile:
    """Stack of (radii, t, ε) branches, one per β slice and arm, each sorted
    by radius with a valid prefix count (+inf tail), in place of the
    reference's ragged Vector{Vector} (radial.jl:165-230). Fields: ``radii``,
    ``t``, ``eps`` of shape L + (P,) and ``n`` of shape L, where L is
    (S,) for one ring and (R, S) for a ring stack; the branch axis is L's
    last.

    `emissivity_at` is the time-integrated ε(ρ) (the sum of the branch
    interpolants); `time_points_at` gives the branch-wise (t, ε) samples at
    ρ from which the ε(t | ρ) light curve is interpolated (reference
    `emissivity_interp`)."""

    radii: Any
    t: Any
    eps: Any
    n: Any

    def _branch_at(self, values, r):
        """(values at r, in range) per branch: L + r.shape."""
        r = torch.as_tensor(r, dtype=self.radii.dtype, device=self.radii.device)
        lead = self.n.shape
        xq = r.reshape(-1).expand(lead + (r.numel(),))
        val = _rowwise_interp(xq, self.radii, values, self.n)
        P = self.radii.shape[-1]
        r_hi = torch.gather(self.radii, -1, torch.clamp(self.n - 1, 0, P - 1)[..., None].long())
        ok = (self.n >= 2)[..., None] & (xq >= self.radii[..., :1]) & (xq <= r_hi)
        return val.reshape(lead + r.shape), ok.reshape(lead + r.shape)

    @property
    def _axis(self):
        return self.n.dim() - 1

    def emissivity_at(self, r):
        """Σ over branches of the in-range ε(ρ) interpolant
        (reference radial.jl:180-189)."""
        vals, ok = self._branch_at(self.eps, r)
        return torch.where(ok, vals, 0.0).sum(self._axis)

    def coordtime_at(self, r):
        """Branch-averaged arrival time (earliest-to-latest mean), used when a
        time-dependent profile is consumed by the time-averaged integrators."""
        vals, ok = self._branch_at(self.t, r)
        w = ok.to(vals.dtype)
        return (vals * w).sum(self._axis) / torch.clamp(w.sum(self._axis), min=1.0)

    def time_points_at(self, r):
        """(t_s, ε_s, valid_s) per branch at radius r (reference
        `emissivity_interp` body, radial.jl:191-209)."""
        ts, ok_t = self._branch_at(self.t, r)
        es, _ = self._branch_at(self.eps, r)
        return ts, es, ok_t

    def time_limits_at(self, r):
        ts, _, ok = self.time_points_at(r)
        b = self._axis
        tmin = torch.where(ok, ts, math.inf).amin(b)
        tmax = torch.where(ok, ts, -math.inf).amax(b)
        has = ok.any(b)
        return torch.where(has, tmin, 0.0), torch.where(has, tmax, 0.0)

    def time_emissivity_curve(self, r, tq):
        """ε(tq | ρ=r): interpolate the branch (t, ε) samples sorted by t;
        zero outside the sampled time support (reference radial.jl:191-209).
        ``tq`` has shape L[:-1] + r.shape + (any trailing shape)."""
        ts, es, ok = (a.movedim(self._axis, -1) for a in self.time_points_at(r))
        batch = ts.shape[:-1]
        tq = torch.as_tensor(tq, dtype=ts.dtype, device=ts.device)
        tqf = tq.reshape(tuple(batch) + (-1,))
        key = torch.where(ok, ts, math.inf)
        order = torch.argsort(key, dim=-1, stable=True)
        ts_s = torch.gather(key, -1, order)
        es_s = torch.gather(torch.where(ok, es, 0.0), -1, order)
        nv = ok.sum(-1)
        val = _rowwise_interp(tqf, ts_s, es_s, nv)
        t_hi = torch.gather(ts_s, -1, torch.clamp(nv - 1, 0, ts_s.shape[-1] - 1)[..., None])
        in_t = (nv >= 2)[..., None] & (tqf >= ts_s[..., :1]) & (tqf <= t_hi)
        return torch.where(in_t, val, 0.0).reshape(tq.shape)


@dataclasses.dataclass(frozen=True)
class RingCoronaProfile:
    """Left + right longitudinal arms (reference radial.jl:232-279)."""

    left: TimeDependentRadialDiscProfile
    right: TimeDependentRadialDiscProfile

    def emissivity_at(self, r):
        return self.left.emissivity_at(r) + self.right.emissivity_at(r)

    def coordtime_at(self, r):
        return 0.5 * (self.left.coordtime_at(r) + self.right.coordtime_at(r))

    def time_limits_at(self, r):
        l0, l1 = self.left.time_limits_at(r)
        r0, r1 = self.right.time_limits_at(r)
        return torch.minimum(l0, r0), torch.maximum(l1, r1)

    def time_emissivity_curve(self, r, tq):
        """Sum of the two arm light curves (reference `_add_arms`,
        radial.jl:253-271)."""
        return self.left.time_emissivity_curve(r, tq) + self.right.time_emissivity_curve(r, tq)


@dataclasses.dataclass(frozen=True)
class NearFieldBlendedProfile:
    """RingCoronaProfile with the near-field emissivity served by the
    adaptive-sky estimator.

    Any β-slice fan estimates ε near the source ring through fold caustics
    (each slice's hit-radius support edge has dρ/dδ = 0, so its contribution
    to the β-sum is an integrable 1/√(r − ρ_min(β)) singularity whose
    Riemann-sum error decays only as O(√Δβ)). The adaptive sky
    (corona/adaptive.py) has no slice structure: it refines 2D sky cells at
    exactly those caustics and deposits footprint-smeared flux into radial
    bins. This wrapper blends the two with a smooth window: adaptive inside
    the near field, fan outside. The time-dependent machinery stays
    fan-based throughout: the blend affects `emissivity_at` only."""

    fan: RingCoronaProfile
    r_nodes: Any  # (K,) radial nodes of the adaptive near-field ε
    eps_nodes: Any  # (K,)
    lo0: Any  # window: fan below lo0, adaptive within [lo1, hi0], fan above hi1
    lo1: Any
    hi0: Any
    hi1: Any

    def _window(self, r):
        def sstep(u):
            u = torch.clamp(u, 0.0, 1.0)
            return u * u * (3.0 - 2.0 * u)

        up = sstep((r - self.lo0) / torch.clamp(self.lo1 - self.lo0, min=1e-12))
        dn = sstep((self.hi1 - r) / torch.clamp(self.hi1 - self.hi0, min=1e-12))
        return up * dn

    def emissivity_at(self, r):
        r = torch.as_tensor(r, dtype=self.r_nodes.dtype, device=self.r_nodes.device)
        e_fan = self.fan.emissivity_at(r)
        e_near = linear_interp(r, self.r_nodes, self.eps_nodes)
        w = self._window(r)
        return w * e_near + (1.0 - w) * e_fan

    def coordtime_at(self, r):
        return self.fan.coordtime_at(r)

    def time_limits_at(self, r):
        return self.fan.time_limits_at(r)

    def time_emissivity_curve(self, r, tq):
        return self.fan.time_emissivity_curve(r, tq)


def _ring_weights(r):
    """Trapezoidal r·δr weights of the actual ring spacing (the reference's
    `_ring_weighting`, radial.jl:289-292, assumes uniform spacing; the same
    for linspace stacks up to half-weighted end rings); a single ring has
    no spacing and a unit area weight."""
    if r.shape[0] == 1:
        return r
    dr = 0.5 * torch.cat([r[1:2] - r[0:1], r[2:] - r[:-2], r[-1:] - r[-2:-1]])
    return r * dr


def _along_rings(a, like):
    """(R,) → (R, 1, ...) against ``like``."""
    return a.reshape((-1,) + (1,) * (like.dim() - 1))


def _delays_of(func, radii):
    """Delays dt_i = func(r_i), ring by ring."""
    return torch.stack([torch.as_tensor(func(r), dtype=radii.dtype, device=radii.device) for r in radii])


@dataclasses.dataclass(frozen=True)
class DiscCoronaProfile:
    """Ring stack with r·δr area weights and per-ring propagation delays
    (reference radial.jl:281-325). `rings` is a RingCoronaProfile whose
    fields carry a leading ring axis."""

    radii: Any  # (R,)
    rings: RingCoronaProfile  # fields (R, S, P)
    delays: Any  # (R,) propagation-time offsets

    def _weights(self):
        return _ring_weights(self.radii)

    def emissivity_at(self, r):
        vals = self.rings.emissivity_at(r)
        return (_along_rings(self._weights(), vals) * vals).sum(0)

    def coordtime_at(self, r):
        """Flux-weighted mean arrival time over the ring stack (reference
        flux weights via `emissivity_interp` products, radial.jl:298-305):
        rings that barely illuminate ρ must not drag the mean."""
        t_vals = self.rings.coordtime_at(r)
        e_vals = self.rings.emissivity_at(r)
        fw = _along_rings(self._weights(), e_vals) * e_vals
        t_shift = t_vals + _along_rings(self.delays, t_vals)
        num = (fw * t_shift).sum(0)
        den = fw.sum(0)
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), t_shift.mean(0))

    def time_limits_at(self, r):
        lo, hi = self.rings.time_limits_at(r)
        dt = _along_rings(self.delays, lo)
        return (lo + dt).amin(0), (hi + dt).amax(0)

    def time_emissivity_curve(self, r, tq):
        tq = torch.as_tensor(tq, dtype=self.radii.dtype, device=self.radii.device)
        tq_rings = tq[None] - _along_rings(self.delays, tq[None])
        curves = self.rings.time_emissivity_curve(r, tq_rings)
        return (_along_rings(self._weights(), curves) * curves).sum(0)

    def with_propagation_velocity(self, func):
        """Reference `with_propagation_velocity` (radial.jl:287-289): delays
        dt_i = func(r_i)."""
        return dataclasses.replace(self, delays=_delays_of(func, self.radii))


# ---------------------------------------------------------------------------
# Ring-arm tracing and emissivity
# ---------------------------------------------------------------------------


def _sorted_point_emissivity(m, spectrum, r_s, d_s, g_s, gam_s, n):
    """Dauser emissivity on radius-sorted rows: ε = Δδ·|sinδ|·I(g)/(A·γ)
    with centred interior / one-sided edge differences (reference
    `_point_source_emissivity`, lamp-post.jl:118-154). Rows along the last
    axis, ``n`` their valid counts."""
    N = r_s.shape[-1]
    i = torch.arange(N, device=r_s.device)
    nn = n[..., None]
    ip = torch.minimum(torch.clamp(i + 1, min=0), torch.clamp(nn - 1, min=0)).expand(r_s.shape)
    im = torch.clamp(i - 1, min=0)
    first = i == 0
    last = i == nn - 1

    def diffs(a):
        d_int = (torch.abs(a - torch.gather(a, -1, ip)) + torch.abs(a - a[..., im])) / 2.0
        d_first = torch.abs(a[..., :1] - a[..., min(1, N - 1) : min(1, N - 1) + 1])
        d_last = torch.abs(a - a[..., im])
        return torch.where(first, d_first, torch.where(last, d_last, d_int))

    dr = diffs(r_s)
    dd = diffs(d_s) / 2.0
    g = m.components(r_s, torch.full_like(r_s, math.pi / 2))
    area = 2 * math.pi * torch.sqrt(torch.abs(g[..., 1] * g[..., 3])) * dr
    area = torch.where(area <= 0, 1.0, area)
    eps = dd * torch.abs(torch.sin(d_s)) * spectrum(g_s) / (area * gam_s)
    return torch.where((i < nn) & (nn >= 2), eps, 0.0)


def _arm_branch(m, spectrum, rho, t, delta, g, gam, arm_mask):
    """One (slice, arm) row → a sorted (radii, t, ε, n) branch row (rows
    along the last axis)."""
    key = torch.where(arm_mask, rho, math.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    r_s = torch.gather(key, -1, order)
    t_s, d_s, g_s, gam_s = (torch.gather(a, -1, order) for a in (t, delta, g, gam))
    n = arm_mask.sum(-1)
    eps = _sorted_point_emissivity(m, spectrum, r_s, d_s, g_s, gam_s, n)
    return r_s, t_s, eps, n


def _split_arms(hit, rho):
    """Two-arm split of each slice row: samples between the (angle-ordered)
    minimum- and maximum-radius hits form one monotonic arm, the cyclic
    remainder the other (reference `_split_arms_indices`, ring.jl:346-386).
    Ties take the first index."""
    idx = torch.arange(hit.shape[-1], device=hit.device)
    imin = torch.argmin(torch.where(hit, rho, math.inf), dim=-1, keepdim=True)
    imax = torch.argmax(torch.where(hit, rho, -math.inf), dim=-1, keepdim=True)
    lo = torch.minimum(imin, imax)
    hi = torch.maximum(imin, imax)
    arm_a = hit & (idx > lo) & (idx <= hi)
    return arm_a, hit & ~arm_a


def _mod_2pi(a):
    """``a`` mod 2π, with the sign of 2π (numpy's and JAX's `mod`)."""
    two_pi = 2.0 * np.pi
    r = torch.fmod(a, two_pi)
    return torch.where((r != 0) & (r < 0), r + two_pi, r)


def _fan_profiles(m, d, rings, spectrum, betas, n_beta, n_angles, lam_max, chart_outer, n_refine):
    """The β-slice fans of ``rings`` (RingCorona models), all in one trace,
    and their golden-section refinement, each probe one trace of every
    ring's 2·n_beta rays. Returns ``(left, right)``
    `TimeDependentRadialDiscProfile`s with fields (R, n_beta, P)."""
    from gradus_tpu_torch.corona.emissivity import energy_ratio, lorentz_factor
    from gradus_tpu_torch.corona.samplers import sky_angles_to_velocity
    from gradus_tpu_torch.redshift import keplerian_velocity_projector

    srcs = [ring.sample_position_velocity(m) for ring in rings]
    x_src = torch.stack([x for x, _ in srcs])  # (R, 4)
    v_src = torch.stack([v for _, v in srcs])
    R = len(rings)
    dtype, device = x_src.dtype, x_src.device
    if betas is None:
        betas = default_beta_angles(n_beta, dtype, device)
    else:
        betas = torch.as_tensor(betas, dtype=dtype, device=device)
    n_beta = betas.shape[0]
    h = 1e-4
    deltas = LinearGrid()(h, 2 * math.pi - h, n_angles, dtype=dtype, device=device)
    disc_velocity = keplerian_velocity_projector(m)

    def eval_directions(th, ph):
        """(hit, ρ, t, g, γ), each (R, K), for K local-sky directions a ring."""
        K = th.shape[-1]
        v = torch.cat([sky_angles_to_velocity(m, x_src[k], v_src[k], th[k], ph[k]) for k in range(R)])
        xs = x_src[:, None, :].expand(R, K, 4).reshape(-1, 4)
        vs = v_src[:, None, :].expand(R, K, 4).reshape(-1, 4)
        gps = trace_geodesics(
            m,
            xs,
            v,
            (0.0, lam_max),
            geometry=d,
            chart_outer=chart_outer,
            terminate_fns=(domain_upper_hemisphere(),),
            constrain=False,
        )
        hit = gps.status == StatusCodes.IntersectedWithGeometry
        v_disc = disc_velocity(gps.x)
        out = (hit, equatorial_project(gps.x), gps.x[..., 0], energy_ratio(m, gps, vs, v_disc), lorentz_factor(m, gps.x, v_disc))
        return tuple(o.reshape(R, K) for o in out)

    th, ph = (torch.stack(a).reshape(R, -1) for a in zip(*(rotated_sky_angles(x[2], deltas, betas) for x in x_src)))
    fan = tuple(a.reshape(R, n_beta, n_angles) for a in eval_directions(th, ph))
    delta_grid = deltas.expand(R, n_beta, n_angles)
    fields = (delta_grid,) + fan  # δ, hit, ρ, t, g, γ

    if n_refine > 0:
        # ---- per-slice extremal refinement (fold caustics at the support
        # edges; reference `_golden_bracket!`, ring.jl:140-236) -------------
        gr = 0.6180339887498949
        hit, rho = fan[0], fan[1]
        sign = torch.tensor([1.0, -1.0], dtype=dtype, device=device)[:, None]  # (min, max) targets

        def masked_rho(h_, r_):
            return torch.where(h_, r_, math.inf)  # non-hits are "worse" for min

        # extremal hit indices per slice, both targets: (R, 2, n_beta)
        i_min = torch.argmin(masked_rho(hit, rho), dim=-1)
        i_max = torch.argmax(torch.where(hit, rho, -math.inf), dim=-1)
        d_ext = torch.stack([deltas[i_min], deltas[i_max]], dim=1)
        spacing = deltas[1] - deltas[0]
        a = d_ext - 2.0 * spacing
        b = d_ext + 2.0 * spacing
        c = b - gr * (b - a)
        e = a + gr * (b - a)
        theta0 = x_src[:, 2].reshape(R, 1, 1)
        axis = _cart_local_direction(theta0, 0.0)  # (R, 1, 1, 3)

        def probe_eval(delta_probe):
            """δ (R, 2, n_beta) → fan samples at those directions."""
            q = _cart_local_direction(delta_probe + theta0, 0.0)
            thp, php = _sky_angles(rodrigues_rotate(axis, q, betas.expand(R, 2, n_beta)))
            out = eval_directions(thp.reshape(R, -1), php.reshape(R, -1))
            return tuple(o.reshape(R, 2, n_beta) for o in out)

        def objective(h_, r_):
            return sign * masked_rho(h_, r_) * torch.where(h_, 1.0, sign)

        pc, pe = probe_eval(c), probe_eval(e)
        fc, fe = objective(pc[0], pc[1]), objective(pe[0], pe[1])
        probes = [(_mod_2pi(c),) + pc, (_mod_2pi(e),) + pe]
        for _ in range(n_refine):
            left = fc < fe
            a2 = torch.where(left, a, c)
            b2 = torch.where(left, e, b)
            c2 = torch.where(left, b2 - gr * (b2 - a2), e)
            e2 = torch.where(left, c, a2 + gr * (b2 - a2))
            probe = torch.where(left, c2, e2)
            pp = probe_eval(probe)
            fp = objective(pp[0], pp[1])
            fc, fe = torch.where(left, fp, fe), torch.where(left, fc, fp)
            a, b, c, e = a2, b2, c2, e2
            # probe δ can step outside [0, 2π) (the bracket d_ext ± 2·spacing
            # at the fan seam): wrapped, so that the cyclic sort below keeps δ
            # ordered and _split_arms sees correctly ordered arms
            probes.append((_mod_2pi(probe),) + pp)

        def merge(fan_field, extra):
            # (R, n_beta, n_angles) ++ (R, K+2, 2, n_beta) → (R, n_beta, n_angles + 2(K+2))
            extra = torch.stack(extra, dim=1).permute(0, 3, 1, 2).reshape(R, n_beta, -1)
            return torch.cat([fan_field, extra], dim=-1)

        fields = tuple(merge(f, [p[k] for p in probes]) for k, f in enumerate(fields))
        # re-establish cyclic δ ordering for the arm split
        order = torch.argsort(fields[0], dim=-1, stable=True)
        fields = tuple(torch.gather(f, -1, order) for f in fields)

    delta_grid, hit, rho, t, g, gam = fields
    arm_a, arm_b = _split_arms(hit, rho)

    # Slice normalisation: the reference's `emissivity_at` sums arm branches
    # over β slices without weighting (radial.jl:180-189), so its raw ε
    # scales with length(βs); each slice's 2π fan also covers the sky twice
    # relative to the lamp post's (0,π)+axisymmetry convention. Dividing by
    # 2·n_beta makes ε slice-count independent and equal to the lamp-post
    # profile in the r → 0 limit; normalised products (line profiles, lag
    # spectra) are unaffected.
    scale = 1.0 / (2.0 * n_beta)

    def branches(mask):
        r_s, t_s, e_s, n = _arm_branch(m, spectrum, rho, t, delta_grid, g, gam, mask)
        return TimeDependentRadialDiscProfile(radii=r_s, t=t_s, eps=scale * e_s, n=n)

    return branches(arm_b), branches(arm_a)


def _ring(model, vf):
    return model if vf is None else dataclasses.replace(model, vf=vf)


def _first_ring(profile: TimeDependentRadialDiscProfile):
    return TimeDependentRadialDiscProfile(*(f[0] for f in (profile.radii, profile.t, profile.eps, profile.n)))


def ring_corona_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    betas=None,
    n_beta: int = 20,
    n_angles: int = 256,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
    vf: str | None = None,
    n_refine: int = 16,
) -> RingCoronaProfile:
    """Emissivity profile of a `RingCorona` (reference `emissivity_profile`
    for RingCorona, extended.jl:133-143 + `corona_arms` ring.jl:456-484).

    All (β slice, local angle) pairs trace in one batch; per slice the hits
    split into two monotonic arms and each arm becomes a time-dependent
    emissivity branch. ``vf`` overrides the model's source velocity function
    ('co_rotating' / 'stationary').

    ``n_refine`` > 0 runs a batched golden-section refinement of each slice's
    extremal-ρ fan directions (reference `_golden_bracket!` toward :minima
    and :maxima, ring.jl:140-236): each slice's hit-radius support edges are
    fold caustics (dρ/dδ = 0) where the fan under-resolves, the dominant
    error of the near-field emissivity |r − r_ring| ≲ 1.5 r_g. The
    refinement probes all slices (both targets) together: ``n_refine`` + 2
    traces of 2·n_beta rays, whose samples join the fan before the arm
    split."""
    left, right = _fan_profiles(
        m, d, [_ring(model, vf)], spectrum, betas, n_beta, n_angles, lam_max, chart_outer, n_refine
    )
    return RingCoronaProfile(left=_first_ring(left), right=_first_ring(right))


def _near_field_nodes(m: AbstractMetric, r_ring: float, grid, vals, spectrum, near_outer: float, n_r_nodes: int):
    """The adaptive sky's cells binned into the near field's radial nodes,
    which span from just outside the horizon to r_ring + near_outer + 0.5:
    (node radii, ε at them, whether the sky reached each node's bin)."""
    from gradus_tpu_torch.corona.adaptive import bin_emissivity_grid

    r_lo = max(1.05 * float(m.inner_radius()), 1.0)
    r_bins = np.geomspace(r_lo, r_ring + near_outer + 0.5, n_r_nodes + 1)
    eps, sa = bin_emissivity_grid(m, grid, vals, r_bins, np.array([0.0, 2 * np.pi]), spectrum)
    return np.sqrt(r_bins[:-1] * r_bins[1:]), eps[:, 0], sa[:, 0] > 0


def ring_corona_profile_hybrid(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    near_inner: float = 1.2,
    near_outer: float = 1.8,
    n0: int = 24,
    rounds: int = 5,
    max_refine: int = 256,
    n_r_nodes: int = 24,
    **fan_kwargs,
):
    """Ring-corona emissivity profile with the adaptive sky's near field.

    Host-driven (the adaptive quadtree's decisions sit between
    traces): runs the dense-fan profile and `corona_adaptive_sky`, bins the
    adaptive flux into radial nodes spanning [just outside the horizon,
    r_ring + near_outer], and returns a `NearFieldBlendedProfile`. The
    reference covers this regime with 2×80 extra golden-section solves per
    slice (ring.jl:169-236) and 100 slices; the adaptive sky reaches it with
    slice-free caustic refinement."""
    from gradus_tpu_torch.corona.adaptive import corona_adaptive_sky

    fan = ring_corona_profile(m, d, model, spectrum, **fan_kwargs)
    grid, vals, _ = corona_adaptive_sky(m, d, model, n0=n0, rounds=rounds, max_refine=max_refine)
    rr = float(model.r)
    hi1 = rr + near_outer
    centers, eps, covered = _near_field_nodes(m, rr, grid, vals, spectrum, near_outer, n_r_nodes)
    ref = fan.left.radii
    like = dict(dtype=ref.dtype, device=ref.device)
    # bins the adaptive sampling never reached fall back to the fan estimate
    fan_vals = fan.emissivity_at(torch.as_tensor(centers, **like)).cpu().numpy()
    eps_nodes = np.where(covered, eps, fan_vals)
    lo0 = centers[0]
    lo1 = min(lo0 + 0.5, rr)
    return NearFieldBlendedProfile(
        fan=fan,
        r_nodes=torch.as_tensor(centers, **like),
        eps_nodes=torch.as_tensor(eps_nodes, **like),
        lo0=torch.as_tensor(lo0, **like),
        lo1=torch.as_tensor(lo1, **like),
        hi0=torch.as_tensor(rr + near_inner, **like),
        hi1=torch.as_tensor(hi1, **like),
    )


class DiscCoronaHybridProfile:
    """Disc-corona ring stack whose rings' near fields come from the
    adaptive-sky hybrid (a host-level aggregate of `NearFieldBlendedProfile`s:
    the hybrid profile is built on the host, so the stack is a list).

    Mirrors `DiscCoronaProfile`: trapezoidal r·δr ring weights,
    flux-weighted mean arrival times, summed time-emissivity curves, and
    `with_propagation_velocity` delays (reference radial.jl:281-325)."""

    def __init__(self, radii, profiles, delays=None):
        self.radii = radii
        self.profiles = list(profiles)
        self.delays = torch.zeros_like(radii) if delays is None else delays

    def _weights(self):
        return _ring_weights(self.radii)

    def emissivity_at(self, r):
        return sum(wi * p.emissivity_at(r) for wi, p in zip(self._weights(), self.profiles))

    def coordtime_at(self, r):
        num = den = t_sum = 0.0
        for wi, p, dt in zip(self._weights(), self.profiles, self.delays):
            e = wi * p.emissivity_at(r)
            t = p.coordtime_at(r) + dt
            num, den, t_sum = num + e * t, den + e, t_sum + t
        t_mean = t_sum / len(self.profiles)
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), t_mean)

    def time_limits_at(self, r):
        los, his = zip(*[p.time_limits_at(r) for p in self.profiles])
        lo, hi = torch.stack(los), torch.stack(his)
        dt = _along_rings(self.delays, lo)
        return (lo + dt).amin(0), (hi + dt).amax(0)

    def time_emissivity_curve(self, r, tq):
        tq = torch.as_tensor(tq, dtype=self.radii.dtype, device=self.radii.device)
        return sum(
            wi * p.time_emissivity_curve(r, tq - dt) for wi, p, dt in zip(self._weights(), self.profiles, self.delays)
        )

    def with_propagation_velocity(self, func):
        return DiscCoronaHybridProfile(self.radii, self.profiles, _delays_of(func, self.radii))


def _ring_radii(model, n_rings, m):
    """The stack's ring radii, range(1e-2, r, n_rings) (reference
    extended.jl:186-200)."""
    b = next(m.buffers(), None)
    dtype = torch.float64 if b is None else b.dtype
    return LinearGrid()(1e-2, model.r, n_rings, dtype=dtype, device=m.device)


def disc_corona_profile_hybrid(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_rings: int = 10,
    vf: str | None = None,
    **hybrid_kwargs,
):
    """`disc_corona_profile` with each ring served by the near-field hybrid
    (`ring_corona_profile_hybrid`). Host-driven: n_rings adaptive skies, so
    for final production profiles; the fan stack (`disc_corona_profile`) is
    the cheap default."""
    radii = _ring_radii(model, n_rings, m)
    profiles = [
        ring_corona_profile_hybrid(
            m, d, RingCorona(r=float(rc), h=model.h, vf=vf if vf is not None else model.vf), spectrum, **hybrid_kwargs
        )
        for rc in radii.tolist()
    ]
    return DiscCoronaHybridProfile(radii, profiles)


def disc_corona_profile(
    m: AbstractMetric,
    d,
    model,
    spectrum=PowerLawSpectrum(2.0),
    *,
    n_rings: int = 10,
    n_beta: int = 20,
    n_angles: int = 256,
    lam_max: float = 10000.0,
    chart_outer: float = 12000.0,
    vf: str | None = None,
    n_refine: int = 16,
) -> DiscCoronaProfile:
    """Emissivity profile of a `DiscCorona` as a stack of concentric rings
    (reference extended.jl:186-200): radii = range(1e-2, r, n_rings), delays
    initially zero (the reference's `_ -> 0` propagation velocity). Every
    ring's fan is one flat batch of n_rings·n_beta·n_angles rays, and each
    refinement probe one of n_rings·2·n_beta."""
    radii = _ring_radii(model, n_rings, m)
    vf = vf if vf is not None else model.vf
    rings = [RingCorona(r=float(rc), h=model.h, vf=vf) for rc in radii.tolist()]
    left, right = _fan_profiles(m, d, rings, spectrum, None, n_beta, n_angles, lam_max, chart_outer, n_refine)
    return DiscCoronaProfile(radii=radii, rings=RingCoronaProfile(left=left, right=right), delays=torch.zeros_like(radii))
