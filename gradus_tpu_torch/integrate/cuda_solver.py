"""The adaptive geodesic integrator as one CUDA kernel, its plain PyTorch
version, and the tracer built on them (counterpart of
`gradus_tpu/integrate/pallas_solver.py`).

`cuda_integrate_rays` integrates a (N, 8) batch of constrained states: on a
CUDA tensor it launches `csrc/geodesic_tsit5.cu` (one thread per ray, the
whole adaptive solve in registers); on a CPU tensor it runs
`integrate_rays_plain`, a lockstep masked loop over the same arithmetic.
The kernel takes every metric of the port: `KerrMetric` and
`KerrSpacetimeFirstOrder` through Kerr's hand-derived Jacobian, the others
through forward-mode dual numbers (`csrc/metrics.cuh`); the plain version
reaches ``m.components5_jac`` for any metric.
`CudaTracer` wraps it the way `PallasTracer` wraps the Pallas kernel:
constrain, integrate (in one pass, or in a capped pass and a resumed tail
pass), unpack. The Newton polish of the disc hits, which `PallasTracer`
runs over every ray after its kernel, runs in the kernel on the hits alone,
as a hit ray's last loop iterations (``newton_iters``); the plain version
runs the loop and then `_polish_hits`.

Per-ray semantics match `pallas_solver._make_kernel`: HNW initial step, FSAL
Tsit5, RMS error norm, log-space PI controller, cubic-Hermite or sampled
crossing events against no geometry, a `ThinDisc` or a `DatumPlane` of one
height, or the geometries of `_KERNEL_GEOMETRIES` beside them
(`csrc/geometry.cuh`: their indicators' slopes with jax.jvp's rules at
kinks, the events interpolating φ too; a `WarpedThinDisc`'s or
`ThickDisc`'s cross-section callable compiled into a kernel built at its
first use, `geometry/codegen.py`), chart exits at step end, hit rays that do not commit their step (or,
with ``terminate_on_hit=False``, crossings counted and the flight going on),
and a resumable carry. Divergences: a ray that is done keeps its outputs,
where the TPU kernel's lockstep tile kept rewriting the finished rays'
``dt``; ``iter_cap`` caps each ray's loop iterations, where the TPU kernel
caps a tile's; crossings are counted in an output of their own,
``crossings``, where the TPU kernel adds 1 to the last state slot (v^φ of a
geodesic, a fault of the reference: ROADMAP C).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gradus_tpu_torch import config as _config
from gradus_tpu_torch.geodesics.equation import constrain_all, geodesic_acceleration
from gradus_tpu_torch.geometry import codegen
from gradus_tpu_torch.geometry.discs import (
    CompositeGeometry,
    DatumPlane,
    EllipticalDisc,
    PolishDoughnut,
    PolishDoughnutFW,
    PrecessingDisc,
    ShakuraSunyaev,
    ThickDisc,
    ThinDisc,
    WarpedThinDisc,
)
from gradus_tpu_torch.integrate.events import cubic_first_crossing
from gradus_tpu_torch.integrate.points import unpack_solution
from gradus_tpu_torch.integrate.solver import (
    IntegrationResult,
    _BETA1,
    _BETA2,
    _GAMMA,
    _Problem,
    _QMAX_FACTOR,
    _QMIN_FACTOR,
    _QOLD_INIT,
    _polish_hits,
    _run_loop,
)
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import make_geodesic_rhs
from gradus_tpu_torch.integrate.tsit5 import _A, _BTILDE
from gradus_tpu_torch.metrics import (
    BumblebeeMetric,
    CartesianMetric,
    DilatonAxion,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    KerrDarkMatter,
    KerrMetric,
    KerrNewmanMetric,
    KerrRefractive,
    KerrSpacetimeFirstOrder,
    MorrisThorneWormhole,
    NoZMetric,
    SphericalMetric,
)

__all__ = [
    "cuda_integrate_rays",
    "integrate_rays_plain",
    "CudaTracer",
    "KERNEL_LAUNCHES",
]

# Launches of the CUDA kernel in this process; the wrapper adds one per launch.
KERNEL_LAUNCHES = 0

_WARP = 32
_LN_QOLD_INIT = math.log(_QOLD_INIT)
# The carry a capped pass returns and a resumed one reads: the TPU kernel's
# ten fields (pallas_solver.py:485-496) and the port's crossing count.
_STATE_KEYS = (
    "k1",
    "lam",
    "dt",
    "ln_qold",
    "status",
    "steps",
    "failed",
    "c_prev",
    "dc_prev",
    "hit_theta",
    "crossings",
)
# The kernel's outputs, in the order of csrc/tsit5.cuh::Outputs.
_OUTPUT_KEYS = ("y",) + _STATE_KEYS[:-1] + ("attempts", "crossings")
_EVENT_METHODS = ("cubic", "sampled")


def _warp_iters(attempts):
    """Loop iterations each ray's warp executed: the max of ``attempts`` over
    each 32 consecutive rays, broadcast back to those rays."""
    n = attempts.shape[0]
    pad = (-n) % _WARP
    a = torch.nn.functional.pad(attempts, (0, pad)).view(-1, _WARP)
    return a.amax(dim=1).repeat_interleave(_WARP)[:n]


# --- the plain version ----------------------------------------------------------


def _f_cm(m, ys):
    t, r, th, ph, vt, vr, vth, vph = ys
    return (vt, vr, vth, vph) + geodesic_acceleration(m, r, th, vt, vr, vth, vph)


def _lc(coeffs, ks):
    """Σ_j coeffs[j]·ks[j], componentwise over tuples of tensors."""
    out = []
    for i in range(len(ks[0])):
        if len(ks) == 1:
            acc = coeffs[0] * ks[0][i]
        else:
            acc = torch.add(coeffs[1] * ks[1][i], ks[0][i], alpha=coeffs[0])
        for c, k in zip(coeffs[2:], ks[2:]):
            acc = torch.add(acc, k[i], alpha=c)
        out.append(acc)
    return tuple(out)


def _axpy(y, dt, d):
    return tuple(torch.addcmul(yi, dt, di) for yi, di in zip(y, d))


def _tsit5_step_cm(f, y, dt, k1):
    """One Tsit5 step in component form. Returns (y_new, err_vec, k7)."""
    ks = [k1]
    for row in _A[:5]:
        ks.append(f(_axpy(y, dt, _lc(row, ks))))
    y_new = _axpy(y, dt, _lc(_A[5], ks))
    k7 = f(y_new)
    err = tuple(dt * e for e in _lc(_BTILDE, ks + [k7]))
    return y_new, err, k7


def _error_norm_cm(err, y, y_new, abstol, reltol):
    acc = 0.0
    for ei, yi, yn in zip(err, y, y_new):
        e = ei / (abstol + torch.maximum(torch.abs(yi), torch.abs(yn)) * reltol)
        acc = acc + e * e
    return torch.sqrt(acc / len(y))


def _initial_dt_cm(f, y, abstol, reltol, order: int = 5):
    """Hairer-Nørsett-Wanner automatic initial step (II.4), component form.
    Returns (dt0, f(y))."""
    S = len(y)
    f0 = f(y)
    d0sq = d1sq = 0.0
    for yi, fi in zip(y, f0):
        sc = abstol + torch.abs(yi) * reltol
        d0sq = d0sq + (yi / sc) ** 2
        d1sq = d1sq + (fi / sc) ** 2
    d0 = torch.sqrt(d0sq / S)
    d1 = torch.sqrt(d1sq / S)
    h0 = torch.where(
        (d0 < 1e-5) | (d1 < 1e-5),
        torch.full_like(d0, 1e-6),
        0.01 * d0 / torch.clamp(d1, min=1e-30),
    )
    f1 = f(tuple(yi + h0 * fi for yi, fi in zip(y, f0)))
    d2sq = 0.0
    for yi, fi, gi in zip(y, f0, f1):
        d2sq = d2sq + ((gi - fi) / (abstol + torch.abs(yi) * reltol)) ** 2
    d2 = torch.sqrt(d2sq / S) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / dmax) ** (1.0 / order),
    )
    return torch.minimum(100.0 * h0, h1), f0


def _hermite_pos(theta, y, y_new, f0, f1, dt):
    """Cubic-Hermite interpolation of the 4 position components."""
    h00 = (1 + 2 * theta) * (1 - theta) ** 2
    h10 = theta * (1 - theta) ** 2
    h01 = theta * theta * (3 - 2 * theta)
    h11 = theta * theta * (theta - 1)
    return tuple(
        h00 * y[i] + h10 * dt * f0[i] + h01 * y_new[i] + h11 * dt * f1[i]
        for i in range(4)
    )


def _mid_flight(out, lam1):
    """The rays a capped pass left mid-flight (pallas_solver.py:236-240)."""
    return (out["status"] == StatusCodes.NoStatus) & (out["failed"] == 0) & (out["lam"] < lam1 - 1e-12)


def integrate_rays_plain(
    m,
    y0,
    lam_span,
    *,
    geometry=None,
    abstol: float,
    reltol: float,
    r_inner: float,
    r_outer: float,
    max_steps: int = 40000,
    dt_min: float = 1e-10,
    event_method: str = "cubic",
    n_interp: int = 8,
    bisect_iters: int = 10,
    terminate_on_hit: bool = True,
    iter_cap: int | None = None,
    state: dict | None = None,
    newton_iters: int = 0,
):
    """Plain PyTorch version of the integrator kernel, on any device.

    All rays advance in lockstep over state-major tuples of (N,) tensors,
    each masked by its own ``alive`` flag, until no ray is alive or
    ``iter_cap`` (else ``max_steps``) iterations have run. With ``state``
    (the `_STATE_KEYS` of a capped pass, ``y0`` its ``y``) the rays resume
    where that pass stopped. With ``newton_iters > 0``, `_polish_hits`
    then polishes the hits this call made, as the kernel does. On a CUDA
    tensor the loop body is captured once as a CUDA graph and replayed an
    iteration (`solver._run_loop`; `cuda_graphs(False)` runs it
    uncaptured, with the same outputs bit for bit).
    Returns the kernel's 13 outputs, ``warp_iters`` and ``polished``."""
    lam0, lam1 = float(lam_span[0]), float(lam_span[1])
    if event_method not in _EVENT_METHODS:
        raise ValueError(f"event_method must be one of {_EVENT_METHODS}, not {event_method!r}")
    sampled = event_method == "sampled"

    def f(ys):
        return _f_cm(m, ys)

    def crossing_jvp(pos, vel):
        return torch.func.jvp(geometry.crossing_indicator_c, pos, vel)

    y = tuple(y0.unbind(-1))
    zero = torch.zeros_like(y[0])
    if state is not None:
        k1 = tuple(state["k1"].unbind(-1))
        lam, dt, ln_qold = state["lam"], state["dt"], state["ln_qold"]
        status, steps, crossings = state["status"], state["steps"], state["crossings"]
        failed = state["failed"] != 0
        c_prev, dc_prev, hit_th = state["c_prev"], state["dc_prev"], state["hit_theta"]
        alive = _mid_flight(state, lam1)
    else:
        lam = torch.full_like(y[0], lam0)
        dt, k1 = _initial_dt_cm(f, y, abstol, reltol)
        dt = torch.minimum(dt, lam1 - lam)
        finite0 = torch.isfinite(dt)
        for yi, ki in zip(y, k1):
            finite0 = finite0 & torch.isfinite(yi) & torch.isfinite(ki)
        alive = finite0
        failed = ~finite0
        status = steps = crossings = torch.zeros_like(y[0], dtype=torch.int32)
        ln_qold = torch.full_like(y[0], _LN_QOLD_INIT)
        hit_th = zero
        if geometry is None:
            c_prev, dc_prev = zero, zero
        elif sampled:
            c_prev, dc_prev = geometry.crossing_indicator_c(*y[0:4]), zero
        else:
            c_prev, dc_prev = crossing_jvp(y[0:4], k1[0:4])
    attempts = torch.zeros_like(y[0], dtype=torch.int32)
    theta_grid = [torch.tensor(t, dtype=y[0].dtype, device=y[0].device) for t in np.linspace(0.0, 1.0, n_interp + 1)]

    def step(c):
        y = tuple(c[f"y{i}"] for i in range(8))
        k1 = tuple(c[f"k{i}"] for i in range(8))
        lam, dt, ln_qold, alive, failed = c["lam"], c["dt"], c["ln_qold"], c["alive"], c["failed"]
        c_prev, dc_prev, hit_th = c["c_prev"], c["dc_prev"], c["hit_theta"]
        dt_eff = torch.minimum(torch.clamp(lam1 - lam, min=dt_min), dt)
        y_new, err_vec, k7 = _tsit5_step_cm(f, y, dt_eff, k1)
        err = torch.clamp(_error_norm_cm(err_vec, y, y_new, abstol, reltol), min=1e-12)
        step_ok = torch.isfinite(err)
        for yi in y_new:
            step_ok = step_ok & torch.isfinite(yi)
        err = torch.where(step_ok, err, 2.0)
        accept = (err <= 1.0) & alive

        # PI controller, log-space powers
        ln_err = torch.log(err)
        q = torch.exp(_BETA1 * ln_err - _BETA2 * ln_qold) / _GAMMA
        fac_acc = 1.0 / torch.clamp(q, 1.0 / _QMAX_FACTOR, 1.0 / _QMIN_FACTOR)
        fac_rej = 1.0 / torch.clamp(
            torch.exp(0.2 * ln_err) / _GAMMA, 1.0, 1.0 / _QMIN_FACTOR
        )
        dt_next = torch.where(accept, dt_eff * fac_acc, dt_eff * fac_rej)
        failed = failed | (
            alive & ~step_ok & ((dt_next < dt_min) | ~torch.isfinite(dt_next))
        )
        ln_qold = torch.where(accept, torch.clamp(ln_err, min=_LN_QOLD_INIT), ln_qold)
        lam_new = lam + dt_eff

        def crossing_at(theta):
            return geometry.crossing_indicator_c(*_hermite_pos(theta, y, y_new, k1, k7, dt_eff))

        # disc event: on the cubic model of the crossing indicator, or on
        # n_interp samples of its interpolant, then bisections
        if geometry is None:
            hit_now = torch.zeros_like(accept)
        elif sampled:
            found = torch.zeros_like(accept)
            th_lo, th_hi = zero, torch.ones_like(zero)
            c_lo = c_left = c_prev
            for k in range(n_interp):
                c_right = crossing_at(theta_grid[k + 1])
                sc = ((c_left < 0) != (c_right < 0)) & ~found
                th_lo = torch.where(sc, theta_grid[k], th_lo)
                th_hi = torch.where(sc, theta_grid[k + 1], th_hi)
                c_lo = torch.where(sc, c_left, c_lo)
                found = found | sc
                c_left = c_right
            for _ in range(bisect_iters):
                mid = 0.5 * (th_lo + th_hi)
                cm = crossing_at(mid)
                same = (cm < 0) == (c_lo < 0)
                th_lo, th_hi = torch.where(same, mid, th_lo), torch.where(same, th_hi, mid)
                c_lo = torch.where(same, cm, c_lo)
            th_c = 0.5 * (th_lo + th_hi)
            pos_c = _hermite_pos(th_c, y, y_new, k1, k7, dt_eff)
            hit_now = found & accept & geometry.is_hit_c(*pos_c)
            c_prev = torch.where(accept, c_left, c_prev)
            hit_th = torch.where(hit_now, th_c, hit_th)
        else:
            c1v, dc1v = crossing_jvp(y_new[0:4], k7[0:4])
            found, th_c = cubic_first_crossing(
                c_prev, dt_eff * dc_prev, c1v, dt_eff * dc1v
            )
            pos_c = _hermite_pos(th_c, y, y_new, k1, k7, dt_eff)
            hit_now = found & accept & geometry.is_hit_c(*pos_c)
            c_prev = torch.where(accept, c1v, c_prev)
            dc_prev = torch.where(accept, dc1v, dc_prev)
            hit_th = torch.where(hit_now, th_c, hit_th)

        # chart bounds and span end, at step end
        r_new = y_new[1]
        inner = accept & ~hit_now & (r_new <= r_inner)
        outer = accept & ~hit_now & (r_new > r_outer)
        finished = accept & (lam_new >= lam1 - 1e-12)
        status = torch.where(inner, StatusCodes.WithinInnerBoundary, c["status"])
        status = torch.where(outer, StatusCodes.OutOfDomain, status)
        crossings = c["crossings"] + hit_now.to(torch.int32)

        # a hit that ends the ray does not commit: (y, k1, lam) stay at the
        # step start and dt records the step span; rays that are done keep
        # their outputs
        stop_at_hit = hit_now & terminate_on_hit
        status = torch.where(stop_at_hit, StatusCodes.IntersectedWithGeometry, status)
        sel = accept & ~stop_at_hit
        out = dict(
            lam=torch.where(sel, lam_new, lam),
            dt=torch.where(stop_at_hit, dt_eff, torch.where(alive, dt_next, dt)),
            ln_qold=ln_qold,
            status=status,
            steps=c["steps"] + accept.to(torch.int32),
            crossings=crossings,
            failed=failed,
            c_prev=c_prev,
            dc_prev=dc_prev,
            hit_theta=hit_th,
            attempts=c["attempts"] + alive.to(torch.int32),
            alive=alive & ~(stop_at_hit | inner | outer | finished | failed),
        )
        for i in range(8):
            out[f"y{i}"] = torch.where(sel, y_new[i], y[i])
            out[f"k{i}"] = torch.where(sel, k7[i], k1[i])
        return out

    carry = dict(
        lam=lam,
        dt=dt,
        ln_qold=ln_qold,
        status=status,
        steps=steps,
        crossings=crossings,
        failed=failed,
        c_prev=c_prev,
        dc_prev=dc_prev,
        hit_theta=hit_th,
        attempts=attempts,
        alive=alive,
    )
    for i in range(8):
        carry[f"y{i}"], carry[f"k{i}"] = y[i], k1[i]
    cf = _run_loop(step, carry, max_steps if iter_cap is None else iter_cap)

    out = dict(
        y=torch.stack([cf[f"y{i}"] for i in range(8)], dim=-1),
        k1=torch.stack([cf[f"k{i}"] for i in range(8)], dim=-1),
        lam=cf["lam"],
        dt=cf["dt"],
        ln_qold=cf["ln_qold"],
        status=cf["status"],
        steps=cf["steps"],
        failed=cf["failed"].to(torch.int32),
        c_prev=cf["c_prev"],
        dc_prev=cf["dc_prev"],
        hit_theta=cf["hit_theta"],
        warp_iters=_warp_iters(cf["attempts"]),
        attempts=cf["attempts"],
        crossings=cf["crossings"],
        polished=torch.tensor(newton_iters > 0),
    )
    if newton_iters > 0 and geometry is not None:
        out = _polish_plain(m, geometry, out, newton_iters)
    return out


def _polish_plain(m, geometry, out, newton_iters):
    """``out`` (`integrate_rays_plain`'s outputs without the polish) with
    the hits that call made polished by `_polish_hits`, ``newton_iters``
    Newton iterations: a carry that arrived with a hit took no step."""
    status = out["status"]
    here = (status == StatusCodes.IntersectedWithGeometry) & (out["attempts"] > 0)
    problem = _Problem(
        f=make_geodesic_rhs(m),
        crossing_fn=lambda ys: geometry.crossing_indicator(ys[..., 0:4]),
        newton_iters=newton_iters,
    )
    cf = {**out, "status": torch.where(here, status, StatusCodes.NoStatus)}
    y, lam = _polish_hits(problem, cf, out["y"], out["lam"])
    return {**out, "y": y, "lam": lam, "polished": torch.tensor(True)}


# --- the kernel -----------------------------------------------------------------

# The kernel's metric kinds (csrc/tsit5.cuh, kMetric*) and the parameters
# each passes besides M and a, in the kernel's order (csrc/metrics.cuh).
# The first-order Kerr class runs as Kerr (its docstring says why).
_KERNEL_METRICS = {
    KerrMetric: (0, lambda m: ()),
    KerrSpacetimeFirstOrder: (0, lambda m: ()),
    JohannsenMetric: (1, lambda m: (m.alpha13, m.alpha22, m.alpha52, m.eps3)),
    JohannsenPsaltisMetric: (2, lambda m: (m.eps3,)),
    NoZMetric: (3, lambda m: (m.eps,)),
    BumblebeeMetric: (4, lambda m: (m.l,)),
    DilatonAxion: (5, lambda m: (m.beta, m.b, *m.guarded_ratios())),
    KerrNewmanMetric: (6, lambda m: (m.Q,)),
    MorrisThorneWormhole: (7, lambda m: (m.b,)),
    KerrRefractive: (8, lambda m: (m.n, m.corona_radius)),
    KerrDarkMatter: (9, lambda m: (m.M_dark_matter, m.delta_r, m.r_s)),
    SphericalMetric: (10, lambda m: ()),
    CartesianMetric: (11, lambda m: ()),
}
_N_METRIC_PARAMS = 5


def _metric_args(m):
    """(kind, M, a, the other parameters as a ctypes double[5]); M and a are
    0 for a metric without them."""
    kind, params = _KERNEL_METRICS[type(m)]
    q = [float(v) for v in params(m)]
    M, a = (float(getattr(m, k, 0.0)) for k in ("M", "a"))
    return kind, M, a, (ctypes.c_double * _N_METRIC_PARAMS)(*q)


# The kernel's geometry kinds (csrc/geometry.cuh): a geometry, or a part of
# a CompositeGeometry (kinds 1-6, at most _MAX_PARTS of them)
_KERNEL_GEOMETRIES = {
    ThinDisc: 1,
    DatumPlane: 2,
    ShakuraSunyaev: 3,
    EllipticalDisc: 4,
    PolishDoughnut: 5,
    PrecessingDisc: 6,
    CompositeGeometry: 7,
    WarpedThinDisc: 8,
    ThickDisc: 9,
}
_PRECESSED = (ThinDisc, DatumPlane, ShakuraSunyaev, EllipticalDisc, PolishDoughnut, WarpedThinDisc, ThickDisc)
_MAX_PARTS = 4
_PART_VALUES = 20
_GEOMETRY_VALUES = 2 + _MAX_PARTS * (2 + _PART_VALUES)


def _check_geometry(m, g, composite_ok=True):
    """Raises `NotImplementedError` unless the kernel takes the geometry
    ``g`` (a part of a CompositeGeometry when not ``composite_ok``)."""
    kind = type(g)
    if kind is PolishDoughnutFW or (kind is DatumPlane and g.height.dim() != 0):
        what = "a PolishDoughnutFW" if kind is PolishDoughnutFW else "a DatumPlane of per-ray heights"
        raise NotImplementedError(
            f"the CUDA integrator does not take {what}: it holds arrays, which the TPU kernel "
            "refuses too (a captured constant); trace_geodesics and "
            "cunningham_transfer_function(backend='xla') take it"
        )
    if kind not in _KERNEL_GEOMETRIES or (kind is CompositeGeometry and not composite_ok):
        raise NotImplementedError(
            "the CUDA integrator takes no geometry, ThinDisc, DatumPlane, ShakuraSunyaev, "
            "EllipticalDisc, PolishDoughnut, WarpedThinDisc, ThickDisc, PrecessingDisc or a "
            f"CompositeGeometry of up to {_MAX_PARTS} of the others, not {kind.__name__} here; "
            "trace_geodesics takes every geometry"
        )
    if kind is PolishDoughnut and g.metric is not None and type(g.metric) is not type(m):
        raise NotImplementedError(
            "the CUDA integrator evaluates a PolishDoughnut's potential with the traced metric's "
            f"components: its metric is a {type(g.metric).__name__}, the traced one a {type(m).__name__}"
        )
    if kind is PrecessingDisc:
        if type(g.disc) not in _PRECESSED:
            raise NotImplementedError(
                "the CUDA integrator takes a PrecessingDisc of a ThinDisc, DatumPlane, ShakuraSunyaev, "
                f"EllipticalDisc, PolishDoughnut, WarpedThinDisc or ThickDisc, not of a {type(g.disc).__name__}"
            )
        _check_geometry(m, g.disc, False)
    if kind is CompositeGeometry:
        if not 1 <= len(g.geometries) <= _MAX_PARTS:
            raise NotImplementedError(
                f"the CUDA integrator takes a CompositeGeometry of 1 to {_MAX_PARTS} parts, not {len(g.geometries)}"
            )
        for part in g.geometries:
            _check_geometry(m, part, False)


def _check_kernel_config(m, geometry, dtype):
    if type(m) not in _KERNEL_METRICS:
        raise NotImplementedError(
            f"the CUDA integrator takes the metrics of gradus_tpu_torch.metrics, "
            f"not {type(m).__name__}"
        )
    if geometry is not None:
        _check_geometry(m, geometry)
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"the CUDA integrator takes f32 or f64, not {dtype}")
    _kernel_unit(m, geometry, dtype)  # traces the cross-sections: raises for what it cannot compile


def _kernel_unit(m, geometry, dtype):
    """The generated unit of a launch against a geometry with cross-section
    callables (`geometry.codegen.kernel_unit`), else None."""
    return codegen.kernel_unit(_KERNEL_METRICS[type(m)][0], geometry, dtype)


def _part_values(g):
    """A part's values in the kernel's order (csrc/geometry.cuh), the
    constants folded as the plain version folds them: in the geometry's
    buffers."""
    if type(g) is ThinDisc:
        return [g.inner_r, g.outer_r]
    if type(g) is DatumPlane:
        return [g.height]
    if type(g) is WarpedThinDisc:
        return [g.inner_r, g.outer_r]
    if type(g) is ThickDisc:
        return []
    if type(g) is ShakuraSunyaev:
        return [3.0 * g.inv_eta * g.mdot_over_edd, g.inner_r]
    if type(g) is EllipticalDisc:
        return [g.inner_r, g.semi_major, g.semi_minor**2]
    if type(g) is PolishDoughnut:
        w_s = g._potential(g.r_cusp, torch.zeros_like(g.r_cusp))
        metric = [0.0] * (3 + _N_METRIC_PARAMS)
        if g.metric is not None:
            _, M, a, q = _metric_args(g.metric)
            metric = [1.0, M, a, *q]
        return [2.0 * g.M, 2.2 * g.M, 0.0, g.ell**2, 2.0 * g.ell, g.z_max, w_s, *metric]
    # a PrecessingDisc: its disc's values, then cos(-β), sin(-β) and γ at 17-19
    values = _part_values(g.disc)
    b = -g.beta
    return values + [0.0] * (17 - len(values)) + [torch.cos(b), torch.sin(b), g.gamma]


def _geometry_args(geometry):
    """The kernel's geometry arguments: (kind, inner_r, outer_r, height, and
    for kinds 3-7 its block, the ``_GEOMETRY_VALUES`` numbers of
    csrc/geometry.cuh, else None)."""
    if geometry is None:
        return 0, 0.0, 0.0, 0.0, None
    kind = _KERNEL_GEOMETRIES[type(geometry)]
    if kind == 1:
        return 1, float(geometry.inner_r), float(geometry.outer_r), 0.0, None
    if kind == 2:
        return 2, 0.0, 0.0, float(geometry.height), None
    parts = list(geometry.geometries) if kind == 7 else [geometry]
    block = [float(kind), float(len(parts))]
    for g in parts:
        inner = _KERNEL_GEOMETRIES[type(g.disc)] if type(g) is PrecessingDisc else 0
        values = [float(v) for v in _part_values(g)]
        block += [float(_KERNEL_GEOMETRIES[type(g)]), float(inner)] + values + [0.0] * (_PART_VALUES - len(values))
    block += [0.0] * (_GEOMETRY_VALUES - len(block))
    return kind, 0.0, 0.0, 0.0, block


def _launch_kernel(m, y0, lam_span, geometry, kw):
    global KERNEL_LAUNCHES
    from gradus_tpu_torch._build import load_callable_library, load_library

    if y0.dim() != 2 or y0.shape[1] != 8:
        raise ValueError(f"y0 must be (N, 8), got {tuple(y0.shape)}")
    unit = _kernel_unit(m, geometry, y0.dtype)
    if unit is None:
        lib = load_library()
        fn = lib.geodesic_tsit5_f64 if y0.dtype == torch.float64 else lib.geodesic_tsit5_f32
    else:
        fn = getattr(load_callable_library(unit), unit.entry)
    n = y0.shape[0]
    y0t = y0.t().contiguous()
    ints = dict(dtype=torch.int32, device=y0.device)
    outs = dict(
        y=torch.empty_like(y0t),
        k1=torch.empty_like(y0t),
        lam=y0t.new_empty(n),
        dt=y0t.new_empty(n),
        ln_qold=y0t.new_empty(n),
        status=torch.empty(n, **ints),
        steps=torch.empty(n, **ints),
        failed=torch.empty(n, **ints),
        c_prev=y0t.new_empty(n),
        dc_prev=y0t.new_empty(n),
        hit_theta=y0t.new_empty(n),
        attempts=torch.empty(n, **ints),
        crossings=torch.empty(n, **ints),
    )
    if n > 0:
        state = kw["state"]
        carry = None
        if state is not None:
            # the carry, on the device in the kernel's layout: k1 state-major
            # like y0, the rest (n,) in the output's dtypes
            carry_t = [state["k1"].t().contiguous()] + [
                state[k].to(dtype=outs[k].dtype).contiguous() for k in _STATE_KEYS[1:]
            ]
            if any(t.device != y0.device or t.shape[-1] != n for t in carry_t):
                raise ValueError("state must hold one value per ray of y0, on its device")
            carry = (ctypes.c_void_p * len(_STATE_KEYS))(*(t.data_ptr() for t in carry_t))
        kind, inner_r, outer_r, height, block = _geometry_args(geometry)
        # the block on the device, in the rays' dtype; the stream orders its
        # copy before the launch and its reuse after it
        geo = None if block is None else torch.tensor(block, dtype=y0.dtype, device=y0.device)
        metric_kind, M, a, q = _metric_args(m)
        modes = (ctypes.c_int * 5)(
            int(kw["event_method"] == "sampled"),
            int(kw["n_interp"]),
            int(kw["bisect_iters"]),
            int(bool(kw["terminate_on_hit"])),
            int(kw["newton_iters"]),
        )
        out_ptrs = (ctypes.c_void_p * len(_OUTPUT_KEYS))(*(outs[k].data_ptr() for k in _OUTPUT_KEYS))
        cap = kw["max_steps"] if kw["iter_cap"] is None else kw["iter_cap"]
        with torch.cuda.device(y0.device):
            rc = fn(
                y0t.data_ptr(),
                n,
                metric_kind,
                M,
                a,
                q,
                kind,
                inner_r,
                outer_r,
                height,
                None if geo is None else geo.data_ptr(),
                float(kw["abstol"]),
                float(kw["reltol"]),
                float(kw["r_inner"]),
                float(kw["r_outer"]),
                float(lam_span[0]),
                float(lam_span[1]),
                int(cap),
                float(kw["dt_min"]),
                modes,
                carry,
                out_ptrs,
                torch.cuda.current_stream(y0.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"geodesic_tsit5 kernel launch failed: cudaError {rc}")
        KERNEL_LAUNCHES += 1
    outs["y"] = outs["y"].t()
    outs["k1"] = outs["k1"].t()
    outs["warp_iters"] = _warp_iters(outs["attempts"])
    outs["polished"] = torch.tensor(kw["newton_iters"] > 0)
    return outs


def cuda_integrate_rays(
    m,
    y0,
    lam_span,
    *,
    geometry=None,
    abstol: float,
    reltol: float,
    r_inner: float,
    r_outer: float,
    max_steps: int = 40000,
    dt_min: float = 1e-10,
    event_method: str = "cubic",
    n_interp: int = 8,
    bisect_iters: int = 10,
    terminate_on_hit: bool = True,
    iter_cap: int | None = None,
    state: dict | None = None,
    newton_iters: int = 0,
):
    """Integrate a constrained (N, 8) batch; returns the raw per-ray outputs
    (``y``/``k1`` (N, 8); ``lam``, ``dt``, ``ln_qold``, ``c_prev``,
    ``dc_prev``, ``hit_theta`` float (N,); ``status``, ``steps``, ``failed``,
    ``warp_iters``, ``attempts``, ``crossings`` int32 (N,)) and
    ``polished``, a 0-d bool on the CPU. For a ray that a hit ended, ``k1``
    is the hit step's start, ``dt`` its span and ``hit_theta`` the event's
    fraction of it; ``y`` and ``lam`` are the step's start too with
    ``newton_iters=0``, and the Newton-polished crossing
    (`_polish_hits`'s arithmetic) with ``newton_iters > 0``, which polishes
    the hits this call makes. ``crossings`` counts the validated crossings
    (0 or 1 when a hit ends the ray).

    ``event_method`` is "cubic" or "sampled" (``n_interp`` samples of the
    indicator's interpolant a step, ``bisect_iters`` bisections);
    ``terminate_on_hit=False`` counts the crossings and flies on.
    ``iter_cap`` stops each ray after that many loop iterations; the
    returned `_STATE_KEYS`, gathered or reordered as the caller likes, go
    back in as ``state`` (with ``y`` as ``y0``) to resume exactly where the
    capped pass stopped. A timelike ray is one whose ``y0`` was constrained
    with ``mu``: the right-hand side of an uncharged ray does not read it.

    A CUDA tensor launches the kernel, and raises `NotImplementedError` for
    a configuration the kernel does not take; a CPU tensor runs
    `integrate_rays_plain`."""
    kw = dict(
        geometry=geometry,
        abstol=abstol,
        reltol=reltol,
        r_inner=r_inner,
        r_outer=r_outer,
        max_steps=max_steps,
        dt_min=dt_min,
        event_method=event_method,
        n_interp=n_interp,
        bisect_iters=bisect_iters,
        terminate_on_hit=terminate_on_hit,
        iter_cap=iter_cap,
        state=state,
        newton_iters=newton_iters,
    )
    if event_method not in _EVENT_METHODS:
        raise ValueError(f"event_method must be one of {_EVENT_METHODS}, not {event_method!r}")
    if newton_iters < 0:
        raise ValueError(f"newton_iters must be >= 0, not {newton_iters}")
    if y0.device.type == "cpu":
        return integrate_rays_plain(m, y0, lam_span, **kw)
    if y0.device.type != "cuda":
        raise NotImplementedError(f"no integrator for device {y0.device}")
    _check_kernel_config(m, geometry, y0.dtype)
    return _launch_kernel(m, y0, lam_span, geometry, kw)


class CudaTracer:
    """Tracer over a fixed (metric, geometry) pair, running the per-ray CUDA
    integrator (counterpart of `PallasTracer`; not differentiable).

    Takes `PallasTracer`'s arguments except those that shape the TPU
    kernel's tiles, which have no counterpart (one thread integrates one
    ray) and raise `TypeError`: ``tile_rows``, ``steps_per_check``,
    ``tail_tile_rows`` and ``interpret``. With a geometry, ``newton_iters``
    must be at least 1: the integrator polishes the hits itself, and reads
    0 as no polish, where `PallasTracer` would still move each hit along
    the trajectory to the event's θ."""

    def __init__(
        self,
        m,
        *,
        mu: float = 0.0,
        geometry=None,
        gtol: float = 1e-2,
        chart_inner: float | None = None,
        chart_outer: float = 12000.0,
        closest_approach: float = 1.01,
        abstol: float | None = None,
        reltol: float | None = None,
        max_steps: int = 40000,
        n_interp: int = 8,
        bisect_iters: int = 10,
        newton_iters: int = 3,
        event_method: str = "cubic",
        segment_iters: int | None = None,
        tail_bucket: int = 16384,
        dtype=None,
    ):
        if event_method not in _EVENT_METHODS:
            raise ValueError(f"event_method must be one of {_EVENT_METHODS}, not {event_method!r}")
        if geometry is not None and newton_iters < 1:
            raise ValueError(f"with a geometry, newton_iters must be at least 1, not {newton_iters}")
        self.m = m
        self.geometry = geometry
        self.mu = mu
        self.gtol = gtol
        self.abstol = abstol
        self.reltol = reltol
        self.dtype = dtype
        if chart_inner is None:
            chart_inner = float(m.inner_radius()) * closest_approach
        self.r_inner = float(chart_inner)
        self.r_outer = float(chart_outer)
        self.max_steps = max_steps
        self.n_interp = n_interp
        self.bisect_iters = bisect_iters
        self.newton_iters = newton_iters
        self.event_method = event_method
        self.segment_iters = segment_iters
        self.tail_bucket = tail_bucket
        self.last_aux = None

    def _constrain(self, x, v):
        return torch.cat([x, constrain_all(self.m, x, v, mu=self.mu)], dim=-1)

    def _integrate_kwargs(self, dtype):
        a_tol, r_tol = _config.default_tols(self.dtype or dtype)
        return dict(
            geometry=self.geometry,
            abstol=a_tol if self.abstol is None else self.abstol,
            reltol=r_tol if self.reltol is None else self.reltol,
            r_inner=self.r_inner,
            r_outer=self.r_outer,
            max_steps=self.max_steps,
            event_method=self.event_method,
            n_interp=self.n_interp,
            bisect_iters=self.bisect_iters,
            newton_iters=self.newton_iters,
        )

    def _finish(self, out, y0, lam0):
        """Unpack the integrator's outputs, whose hits the integrator has
        polished (`_integrate_kwargs` asks it to)."""
        if self.geometry is not None and not bool(out["polished"]):
            raise ValueError(
                "the hits are not polished: integrate with newton_iters > 0, which polishes "
                "them in the kernel (in the plain version, after its loop)"
            )
        res = IntegrationResult(
            y=out["y"],
            lam=out["lam"],
            y0=y0,
            lam0=torch.full_like(out["lam"], lam0),
            status=out["status"],
            steps=out["steps"],
            failed=out["failed"].bool(),
        )
        return unpack_solution(res)

    def _integrate(self, y0, lam_span):
        """The raw outputs of `cuda_integrate_rays` for a constrained batch:
        one pass, or, with ``segment_iters`` and more rays than
        ``tail_bucket``, a pass capped at ``segment_iters`` loop iterations
        and a resumed pass over its survivors (pallas_solver.py:861-913).

        The survivors are compacted by a cumulative sum into a
        ``tail_bucket``-sized index (a slot left over, or a survivor past
        the bucket, points at ray N: gathers clip it to ray N-1, scatters
        drop it), ordered by their estimated remaining steps (λ1 − λ)/dt,
        most first, so that a warp's rays end together. The resumed pass
        runs the same instantiation of the kernel, so a ray's result is
        bit for bit the single pass's; each pass polishes its own hits.
        ``warp_iters`` and ``attempts`` add up over the passes."""
        kw = self._integrate_kwargs(y0.dtype)
        N = y0.shape[0]
        if self.segment_iters is None or N <= self.tail_bucket:
            return cuda_integrate_rays(self.m, y0, lam_span, **kw)
        lam1 = float(lam_span[1])
        st1 = cuda_integrate_rays(self.m, y0, lam_span, iter_cap=self.segment_iters, **kw)
        alive = _mid_flight(st1, lam1)
        K = self.tail_bucket
        dest = torch.cumsum(alive.to(torch.int64), 0) - 1
        dest = torch.where(alive & (dest < K), dest, K)
        idx = torch.full((K + 1,), N, dtype=torch.int64, device=y0.device)
        idx = idx.scatter(0, dest, torch.arange(N, device=y0.device))[:K]
        est = (lam1 - st1["lam"]) / torch.clamp(st1["dt"], min=1e-30)
        key = torch.where(alive, -est, torch.inf)
        idx = idx[torch.argsort(key[idx.clamp(max=N - 1)], stable=True)]
        gather = idx.clamp(max=N - 1)
        st2 = cuda_integrate_rays(
            self.m, st1["y"][gather], lam_span, state={k: st1[k][gather] for k in _STATE_KEYS}, **kw
        )
        valid = idx < N
        dst, src = idx[valid], valid.nonzero().squeeze(-1)
        out = {}
        for k in ("y",) + _STATE_KEYS:
            out[k] = st1[k].index_copy(0, dst, st2[k][src])
        for k in ("warp_iters", "attempts"):
            out[k] = st1[k].index_add(0, dst, st2[k][src])
        out["polished"] = st2["polished"]
        return out

    def _passes(self, y0, lam_span, lengths, progress, min_bucket: int):
        """The raw outputs of `cuda_integrate_rays` in capped passes, the
        k-th capped at ``lengths[k]`` loop iterations (the last length for
        every later pass, ``max_steps`` in all), each resuming the rays in
        flight where the last stopped: bit for bit one pass. A pass keeps
        its width (a finished ray's thread exits at once) until the least
        bucket of ``min_bucket`` · 4^k rays that holds the survivors is
        narrower: then they resume alone, gathered (the reference
        `CompactedIntegrator`'s rule). ``progress``, if given, is called
        after each pass with a dict of ``segment``, ``width`` (the rays
        the pass ran), ``executed_iters`` (loop iterations so far),
        ``alive`` (rays still in flight) and ``total``."""
        kw = self._integrate_kwargs(y0.dtype)
        lam1 = float(lam_span[1])
        n = y0.shape[0]
        idx = torch.arange(n, device=y0.device)  # pass row → ray
        out, work, iters, segment = None, None, 0, 0
        while iters < self.max_steps:
            cap = min(lengths[min(segment, len(lengths) - 1)], self.max_steps - iters)
            if work is None:
                step = out = cuda_integrate_rays(self.m, y0, lam_span, iter_cap=cap, **kw)
            else:
                state = {k: work[k] for k in _STATE_KEYS}
                step = cuda_integrate_rays(self.m, work["y"], lam_span, iter_cap=cap, state=state, **kw)
                out = dict(out, polished=step["polished"])
                for k in ("y",) + _STATE_KEYS:
                    out[k] = out[k].index_copy(0, idx, step[k])
                for k in ("warp_iters", "attempts"):
                    out[k] = out[k].index_add(0, idx, step[k])
            iters += cap
            segment += 1
            flying = _mid_flight(step, lam1)
            n_alive = int(flying.sum())
            if progress is not None:
                progress(dict(segment=segment, width=idx.shape[0], executed_iters=iters, alive=n_alive, total=n))
            if n_alive == 0:
                break
            rows = slice(None)
            if _next_bucket(n_alive, min_bucket) < idx.shape[0]:
                rows = flying.nonzero().squeeze(-1)
                idx = idx[rows]
            work = {k: step[k][rows] for k in ("y",) + _STATE_KEYS}
        return out

    def trace(self, y0, lam_span, *, segments=None, progress=None, min_bucket: int = 8192):
        """Trace a constrained (N, 8) batch: in one pass, or with
        ``segments`` (pass lengths) in capped passes (`_passes`, with its
        ``progress`` and ``min_bucket``).

        Returns ``(GeodesicPoint, aux)``; aux holds per-ray ``warp_iters``
        (loop iterations the ray's warp executed, summed over the passes),
        ``steps`` (accepted steps), ``attempts`` (iterations the ray was
        alive) and the count of rays still mid-flight at exit,
        ``unfinished`` (0 unless ``max_steps`` was reached or a
        ``tail_bucket`` was too small for the survivors of a capped pass)."""
        lam0, lam1 = float(lam_span[0]), float(lam_span[1])
        if segments is None:
            out = self._integrate(y0, (lam0, lam1))
        else:
            out = self._passes(y0, (lam0, lam1), tuple(segments), progress, min_bucket)
        unfinished = torch.sum(_mid_flight(out, lam1))
        gp = self._finish(out, y0, lam0)
        aux = {
            "warp_iters": out["warp_iters"],
            "steps": out["steps"],
            "attempts": out["attempts"],
            "unfinished": unfinished,
        }
        return gp, aux

    def __call__(self, x, v, lam_span, constrain: bool = True, **passes):
        """Trace rays from (``x``, ``v``); ``passes``: `trace`'s
        ``segments``, ``progress`` and ``min_bucket``."""
        x, v = torch.broadcast_tensors(torch.atleast_2d(x), torch.atleast_2d(v))
        y0 = self._constrain(x, v) if constrain else torch.cat([x, v], dim=-1)
        gp, self.last_aux = self.trace(y0, lam_span, **passes)
        return gp


def _next_bucket(n: int, min_bucket: int) -> int:
    """Smallest power-of-4 multiple of ``min_bucket`` that is ≥ n
    (reference `solver._next_bucket`)."""
    b = min_bucket
    while b < n:
        b *= 4
    return b
