"""The adaptive geodesic integrator as one CUDA kernel, its plain PyTorch
version, and the tracer built on them (counterpart of
`gradus_tpu/integrate/pallas_solver.py`).

`cuda_integrate_rays` integrates a (N, 8) batch of constrained states: on a
CUDA tensor it launches `csrc/geodesic_tsit5.cu` (one thread per ray, the
whole adaptive solve in registers); on a CPU tensor it runs
`integrate_rays_plain`, a lockstep masked loop over the same arithmetic.
`CudaTracer` wraps it the way `PallasTracer` wraps the Pallas kernel:
constrain, integrate, Newton-polish the disc hits, unpack.

Per-ray semantics match `pallas_solver._make_kernel` in the modes the
flagship render and the line profiles use: HNW initial step, FSAL Tsit5, RMS
error norm, log-space PI controller, cubic-Hermite crossing events against no
geometry, a `ThinDisc` or a `DatumPlane` of one height, chart exits at step
end, and hit rays that do not commit their step. One difference: a ray that
is done keeps its outputs, where the TPU kernel's lockstep tile kept
rewriting the finished rays' ``dt``.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch import config as _config
from gradus_tpu_torch.geodesics.equation import constrain_all, geodesic_acceleration
from gradus_tpu_torch.geometry.discs import DatumPlane, ThinDisc
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
)
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import TraceGeodesic, make_geodesic_rhs
from gradus_tpu_torch.integrate.tsit5 import _A, _BTILDE
from gradus_tpu_torch.metrics.kerr import KerrMetric

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
_OUTPUT_KEYS = (
    "y",
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
    "attempts",
)


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


def integrate_rays_plain(
    m,
    y0,
    lam_span,
    *,
    geometry=None,
    mu: float = 0.0,
    abstol: float,
    reltol: float,
    r_inner: float,
    r_outer: float,
    max_steps: int = 40000,
    dt_min: float = 1e-10,
):
    """Plain PyTorch version of the integrator kernel, on any device.

    All rays advance in lockstep over state-major tuples of (N,) tensors,
    each masked by its own ``alive`` flag, until no ray is alive or
    ``max_steps`` iterations have run. ``mu`` enters only through the
    constraint of ``y0``. Returns the kernel's 13 outputs."""
    lam0, lam1 = float(lam_span[0]), float(lam_span[1])

    def f(ys):
        return _f_cm(m, ys)

    def crossing_jvp(pos, vel):
        return torch.func.jvp(geometry.crossing_indicator_c, pos, vel)

    y = tuple(y0.unbind(-1))
    lam = torch.full_like(y[0], lam0)
    dt, k1 = _initial_dt_cm(f, y, abstol, reltol)
    dt = torch.minimum(dt, lam1 - lam)
    finite0 = torch.isfinite(dt)
    for yi, ki in zip(y, k1):
        finite0 = finite0 & torch.isfinite(yi) & torch.isfinite(ki)
    alive = finite0
    failed = ~finite0
    int_zeros = torch.zeros_like(y[0], dtype=torch.int32)
    status, steps, attempts = int_zeros, int_zeros, int_zeros
    ln_qold = torch.full_like(y[0], _LN_QOLD_INIT)
    zero = torch.zeros_like(y[0])
    hit_th = zero
    if geometry is not None:
        c_prev, dc_prev = crossing_jvp(y[0:4], k1[0:4])
    else:
        c_prev, dc_prev = zero, zero

    for it in range(max_steps):
        # the any() is a device→host sync: check it every 8 iterations
        if it % 8 == 0 and not bool(alive.any()):
            break
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

        # disc event on the cubic model of the crossing indicator
        if geometry is not None:
            c1v, dc1v = crossing_jvp(y_new[0:4], k7[0:4])
            found, th_c = cubic_first_crossing(
                c_prev, dt_eff * dc_prev, c1v, dt_eff * dc1v
            )
            pos_c = _hermite_pos(th_c, y, y_new, k1, k7, dt_eff)
            hit_now = found & accept & geometry.is_hit_c(*pos_c)
            c_prev = torch.where(accept, c1v, c_prev)
            dc_prev = torch.where(accept, dc1v, dc_prev)
            hit_th = torch.where(hit_now, th_c, hit_th)
        else:
            hit_now = torch.zeros_like(accept)

        # chart bounds and span end, at step end
        r_new = y_new[1]
        inner = accept & ~hit_now & (r_new <= r_inner)
        outer = accept & ~hit_now & (r_new > r_outer)
        finished = accept & (lam_new >= lam1 - 1e-12)
        status = torch.where(inner, StatusCodes.WithinInnerBoundary, status)
        status = torch.where(outer, StatusCodes.OutOfDomain, status)
        status = torch.where(hit_now, StatusCodes.IntersectedWithGeometry, status)

        # hit rays do not commit: (y, k1, lam) stay at the step start and dt
        # records the step span; rays that are done keep their outputs
        sel = accept & ~hit_now
        dt = torch.where(hit_now, dt_eff, torch.where(alive, dt_next, dt))
        y = tuple(torch.where(sel, a, b) for a, b in zip(y_new, y))
        k1 = tuple(torch.where(sel, a, b) for a, b in zip(k7, k1))
        lam = torch.where(sel, lam_new, lam)
        steps = steps + accept.to(torch.int32)
        attempts = attempts + alive.to(torch.int32)
        alive = alive & ~(hit_now | inner | outer | finished | failed)

    return dict(
        y=torch.stack(y, dim=-1),
        k1=torch.stack(k1, dim=-1),
        lam=lam,
        dt=dt,
        ln_qold=ln_qold,
        status=status,
        steps=steps,
        failed=failed.to(torch.int32),
        c_prev=c_prev,
        dc_prev=dc_prev,
        hit_theta=hit_th,
        warp_iters=_warp_iters(attempts),
        attempts=attempts,
    )


# --- the kernel -----------------------------------------------------------------


def _check_kernel_config(m, geometry, mu, dtype):
    if type(m) is not KerrMetric:
        raise NotImplementedError(
            f"the CUDA integrator takes KerrMetric only, not {type(m).__name__} "
            "(other metrics' device Jacobians are on the ROADMAP)"
        )
    if geometry is not None and type(geometry) not in (ThinDisc, DatumPlane):
        raise NotImplementedError(
            f"the CUDA integrator takes no geometry, ThinDisc or DatumPlane, not "
            f"{type(geometry).__name__}"
        )
    if type(geometry) is DatumPlane and geometry.height.dim() != 0:
        raise NotImplementedError(
            "the CUDA integrator takes a DatumPlane of one height; per-ray heights "
            "(thick-disc transfer functions) are not ported yet (ROADMAP queue B)"
        )
    if float(mu) != 0.0:
        raise NotImplementedError("the CUDA integrator takes null rays (mu = 0) only")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"the CUDA integrator takes f32 or f64, not {dtype}")


def _launch_kernel(
    m, y0, lam_span, geometry, abstol, reltol, r_inner, r_outer, max_steps, dt_min
):
    global KERNEL_LAUNCHES
    from gradus_tpu_torch._build import load_library

    if y0.dim() != 2 or y0.shape[1] != 8:
        raise ValueError(f"y0 must be (N, 8), got {tuple(y0.shape)}")
    lib = load_library()
    fn = lib.geodesic_tsit5_f64 if y0.dtype == torch.float64 else lib.geodesic_tsit5_f32
    n = y0.shape[0]
    y0t = y0.t().contiguous()
    outs = dict(
        y=torch.empty_like(y0t),
        k1=torch.empty_like(y0t),
        lam=y0t.new_empty(n),
        dt=y0t.new_empty(n),
        ln_qold=y0t.new_empty(n),
        status=torch.empty(n, dtype=torch.int32, device=y0.device),
        steps=torch.empty(n, dtype=torch.int32, device=y0.device),
        failed=torch.empty(n, dtype=torch.int32, device=y0.device),
        c_prev=y0t.new_empty(n),
        dc_prev=y0t.new_empty(n),
        hit_theta=y0t.new_empty(n),
        attempts=torch.empty(n, dtype=torch.int32, device=y0.device),
    )
    if n > 0:
        inner_r = outer_r = height = 0.0
        if geometry is None:
            kind = 0
        elif type(geometry) is ThinDisc:
            kind, inner_r, outer_r = 1, float(geometry.inner_r), float(geometry.outer_r)
        else:
            kind, height = 2, float(geometry.height)
        with torch.cuda.device(y0.device):
            rc = fn(
                y0t.data_ptr(),
                n,
                float(m.M),
                float(m.a),
                kind,
                inner_r,
                outer_r,
                height,
                float(abstol),
                float(reltol),
                float(r_inner),
                float(r_outer),
                float(lam_span[0]),
                float(lam_span[1]),
                int(max_steps),
                float(dt_min),
                *(outs[k].data_ptr() for k in _OUTPUT_KEYS),
                torch.cuda.current_stream(y0.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"geodesic_tsit5 kernel launch failed: cudaError {rc}")
        KERNEL_LAUNCHES += 1
    outs["y"] = outs["y"].t()
    outs["k1"] = outs["k1"].t()
    outs["warp_iters"] = _warp_iters(outs["attempts"])
    return outs


def cuda_integrate_rays(
    m,
    y0,
    lam_span,
    *,
    geometry=None,
    mu: float = 0.0,
    abstol: float,
    reltol: float,
    r_inner: float,
    r_outer: float,
    max_steps: int = 40000,
    dt_min: float = 1e-10,
):
    """Integrate a constrained (N, 8) batch; returns the 13 raw per-ray
    outputs (``y``/``k1`` (N, 8); ``lam``, ``dt``, ``ln_qold``, ``c_prev``,
    ``dc_prev``, ``hit_theta`` float (N,); ``status``, ``steps``, ``failed``,
    ``warp_iters``, ``attempts`` int32 (N,)). For a hit ray ``y``, ``k1`` and
    ``lam`` are the hit step's start and ``dt`` its span.

    A CUDA tensor launches the kernel, and raises `NotImplementedError` for
    a configuration the kernel does not take; a CPU tensor runs
    `integrate_rays_plain`."""
    kw = dict(
        geometry=geometry,
        mu=mu,
        abstol=abstol,
        reltol=reltol,
        r_inner=r_inner,
        r_outer=r_outer,
        max_steps=max_steps,
        dt_min=dt_min,
    )
    if y0.device.type == "cpu":
        return integrate_rays_plain(m, y0, lam_span, **kw)
    if y0.device.type != "cuda":
        raise NotImplementedError(f"no integrator for device {y0.device}")
    _check_kernel_config(m, geometry, mu, y0.dtype)
    return _launch_kernel(
        m, y0, lam_span, geometry, abstol, reltol, r_inner, r_outer, max_steps, dt_min
    )


class CudaTracer:
    """Tracer over a fixed (metric, geometry) pair, running the per-ray CUDA
    integrator (counterpart of `PallasTracer`; not differentiable).

    Takes `PallasTracer`'s arguments. ``tile_rows``, ``steps_per_check``,
    ``tail_tile_rows`` and ``interpret`` shape the TPU kernel's tiles and have
    no counterpart here: one thread integrates one ray. The modes of the TPU
    kernel that are not ported yet raise `NotImplementedError`:
    ``event_method="sampled"`` (and with it ``n_interp``/``bisect_iters``)
    and segmented tail passes (``segment_iters``, ``tail_bucket``)."""

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
        tile_rows: int = 8,
        steps_per_check: int = 8,
        event_method: str = "cubic",
        segment_iters: int | None = None,
        tail_bucket: int = 16384,
        tail_tile_rows: int = 8,
        dtype=None,
        interpret: bool | None = None,
    ):
        if event_method != "cubic":
            raise NotImplementedError(
                "event_method='sampled' is not ported yet (ROADMAP queue B)"
            )
        if segment_iters is not None:
            raise NotImplementedError(
                "segmented tail passes are not ported yet (ROADMAP queue B)"
            )
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
        self.last_aux = None

        self._polish_problem = None
        if geometry is not None:
            self._polish_problem = _Problem(
                f=make_geodesic_rhs(m, TraceGeodesic(mu=mu)),
                crossing_fn=lambda y: geometry.crossing_indicator(y[..., 0:4]),
                newton_iters=newton_iters,
            )

    def _constrain(self, x, v):
        return torch.cat([x, constrain_all(self.m, x, v, mu=self.mu)], dim=-1)

    def _integrate_kwargs(self, dtype):
        a_tol, r_tol = _config.default_tols(self.dtype or dtype)
        return dict(
            geometry=self.geometry,
            mu=self.mu,
            abstol=a_tol if self.abstol is None else self.abstol,
            reltol=r_tol if self.reltol is None else self.reltol,
            r_inner=self.r_inner,
            r_outer=self.r_outer,
            max_steps=self.max_steps,
        )

    def _finish(self, out, y0, lam0):
        y_f, lam_f = out["y"], out["lam"]
        if self._polish_problem is not None:
            y_f, lam_f = _polish_hits(self._polish_problem, out, y_f, lam_f)
        res = IntegrationResult(
            y=y_f,
            lam=lam_f,
            y0=y0,
            lam0=torch.full_like(lam_f, lam0),
            status=out["status"],
            steps=out["steps"],
            failed=out["failed"].bool(),
        )
        return unpack_solution(res)

    def trace(self, y0, lam_span):
        """Trace a constrained (N, 8) batch.

        Returns ``(GeodesicPoint, aux)``; aux holds per-ray ``warp_iters``
        (loop iterations the ray's warp executed), ``steps`` (accepted
        steps), ``attempts`` (iterations the ray was alive) and the count of
        rays still mid-flight at exit, ``unfinished`` (0 unless ``max_steps``
        was reached)."""
        lam0, lam1 = float(lam_span[0]), float(lam_span[1])
        out = cuda_integrate_rays(
            self.m, y0, (lam0, lam1), **self._integrate_kwargs(y0.dtype)
        )
        unfinished = torch.sum(
            (out["status"] == StatusCodes.NoStatus)
            & (out["failed"] == 0)
            & (out["lam"] < lam1 - 1e-12)
        )
        gp = self._finish(out, y0, lam0)
        aux = {
            "warp_iters": out["warp_iters"],
            "steps": out["steps"],
            "attempts": out["attempts"],
            "unfinished": unfinished,
        }
        return gp, aux

    def __call__(self, x, v, lam_span, constrain: bool = True):
        x, v = torch.broadcast_tensors(torch.atleast_2d(x), torch.atleast_2d(v))
        y0 = self._constrain(x, v) if constrain else torch.cat([x, v], dim=-1)
        gp, self.last_aux = self.trace(y0, lam_span)
        return gp
