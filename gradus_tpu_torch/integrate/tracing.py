"""Front-door tracing API (counterpart of `gradus_tpu/integrate/tracing.py`):
trace descriptions, the geodesic right-hand side, `trace_geodesics` over the
lockstep solver `integrate_rays`, and `tracegeodesics`.

The 8-component state is u = (x, v); the RHS is
``du/dλ = (v, geodesic_equation(m, x, v))``. Charged traces add the
Lorentz force ``(q/μ)·F·v`` (reference `src/metrics/kerr-newman-ad.jl:74-102`).

`trace_geodesics_dense` also records each ray's accepted steps;
`trace_radiative_transfer` integrates the invariant intensity along the ray
(10 slots: x, k, I, crossings); `trace_windings` counts crossings of a
plane of constant θ (9 slots). `PoloidalShape` and `event_horizon_chart`
give a θ-dependent inner chart bound.

`trace_geodesics(..., checkpointed=True)` runs the reverse-mode segment
ladder (`solver.integrate_rays_checkpointed`); under a `torch.func`
transform on a CUDA tensor a trace is `_LiftedTrace`, whose loop carries
the parameters' tangents (`lifting`). `Tracer` traces in segments with a
progress hook: on the CUDA integrator where it takes the configuration,
elsewhere through `solver.CompactedIntegrator`, as the reference's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch

from gradus_tpu_torch import config as _config
from gradus_tpu_torch.geodesics.equation import constrain_all, geodesic_equation
from gradus_tpu_torch.integrate.points import GeodesicPoint, unpack_solution
from gradus_tpu_torch.integrate import lifting, solver
from gradus_tpu_torch.integrate.lifting import slot_values, tensor_slots
from gradus_tpu_torch.integrate.solver import (
    CompactedIntegrator,
    _segment_schedule,
    integrate_rays,
    integrate_rays_checkpointed,
)
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.utils.jvp import jvp

_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor

__all__ = [
    "TraceGeodesic",
    "TraceRadiativeTransfer",
    "make_geodesic_rhs",
    "make_radiative_transfer_rhs",
    "domain_upper_hemisphere",
    "trace_geodesics",
    "trace_geodesics_dense",
    "trace_radiative_transfer",
    "trace_windings",
    "tracegeodesics",
    "PoloidalShape",
    "event_horizon_chart",
    "Tracer",
]


@dataclasses.dataclass(frozen=True)
class TraceGeodesic:
    """Null (μ=0) / timelike (μ=1) / charged (q≠0) trace
    (reference `src/tracing/tracing.jl:1-8`)."""

    mu: float = 0.0
    q: float = 0.0


@dataclasses.dataclass(frozen=True)
class TraceRadiativeTransfer:
    """Covariant radiative-transfer trace: the 9th state component
    integrates the invariant intensity (reference
    `src/tracing/radiative-transfer-problem.jl`)."""

    mu: float = 0.0
    q: float = 0.0
    nu: float = 1.0
    I0: float = 1.0


def make_geodesic_rhs(m: AbstractMetric, trace: TraceGeodesic | None = None):
    """RHS over (..., 8) states. With a charge q ≠ 0 it adds the Lorentz
    force (q/μ)·F^μ_ν v^ν (μ = 1 for a null trace), F from the metric's
    `electromagnetic_potential` (`metrics/kerr_newman.py::faraday_tensor`,
    batched over the rays, its index sums elementwise). A q or μ that
    cannot be read as a number, because it is under a `torch.func`
    transform or requires grad, counts as nonzero, as the reference's
    `_is_nonzero` counts a traced one."""
    charged = trace is not None and _is_nonzero(trace.q)
    return _geodesic_rhs(m, trace, charged, charged and _is_nonzero(trace.mu))


def _geodesic_rhs(m, trace, charged: bool, mu_nonzero: bool):
    """`make_geodesic_rhs` with its branches chosen: the RHS reads the
    metric's buffers and the trace's q and μ when it is called."""
    if charged:
        from gradus_tpu_torch.metrics.kerr_newman import faraday_tensor

        def f(y):
            x, v = y[..., 0:4], y[..., 4:8]
            q_over_mu = trace.q / (trace.mu if mu_nonzero else 1.0)
            lorentz = q_over_mu * (faraday_tensor(m, x) * v[..., None, :]).sum(dim=-1)
            return torch.cat([v, geodesic_equation(m, x, v) + lorentz], dim=-1)

        return f

    def f(y):
        x, v = y[..., 0:4], y[..., 4:8]
        return torch.cat([v, geodesic_equation(m, x, v)], dim=-1)

    return f


def _is_nonzero(val) -> bool:
    """Whether ``val`` may be nonzero: a tensor under a `torch.func`
    transform or one that requires grad may be (reference `_is_nonzero`)."""
    if isinstance(val, torch.Tensor) and (_is_wrapped(val) or val.requires_grad):
        return True
    return float(val) != 0.0


@functools.lru_cache(maxsize=None)
def domain_upper_hemisphere(delta: float = 1e-4):
    """Terminate (OutOfDomain) once the ray crosses below the equatorial plane
    (reference `src/tracing/callbacks.jl:31-41`). Cached, so one ``delta``
    gives one callback tuple."""

    def pred(y, lam):
        r, th = y[..., 1], y[..., 2]
        return r * torch.cos(th) < delta

    return (pred, StatusCodes.OutOfDomain)


def _device_of(d):
    """``d`` as a `torch.device` with its index (a bare "cuda" is the
    current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _check_devices(m, geometry, x, v):
    """A metric, geometry or ``v`` off the device of ``x`` raises."""
    found = {
        "v": [v.device],
        "metric": [] if m.device is None else [m.device],
        "geometry": [t.device for t in geometry.buffers()] if isinstance(geometry, torch.nn.Module) else [],
    }
    device = _device_of(x.device)
    wrong = {k: sorted({str(d) for d in ds}) for k, ds in found.items() if any(_device_of(d) != device for d in ds)}
    if wrong:
        raise ValueError(f"trace_geodesics runs on the device of x, {device}; found {wrong}")


def trace_geodesics(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    mu: float = 0.0,
    q: float = 0.0,
    trace=None,
    geometry=None,
    gtol: float = 1e-2,
    chart_inner=None,
    chart_outer: float = 12000.0,
    closest_approach: float = 1.01,
    abstol: float | None = None,
    reltol: float | None = None,
    max_steps: int = 40000,
    terminate_fns: tuple = (),
    constrain: bool = True,
    n_interp: int = 8,
    checkpointed: bool = False,
    n_segments: int = 64,
    seg_steps: int = 32,
    v_dot=None,
) -> GeodesicPoint:
    """Trace a batch (or a single) geodesic; returns endpoint `GeodesicPoint`s.

    ``x``, ``v``: (..., 4) position / unconstrained velocity. The time
    component of ``v`` is solved from the norm constraint unless
    ``constrain=False``. The trace runs `integrate_rays` on the device of
    ``x``; a metric, geometry or ``v`` on another device raises
    `ValueError`. On a CPU tensor it is differentiable in forward mode
    (`torch.func.jvp`) with respect to the inputs and the metric's
    parameters. With ``v_dot``, a tangent of ``v`` (``x`` and the metric
    held fixed), it returns the pair of the trace and its tangent (the
    float fields tangents, ``status`` the trace's), the tangent carried
    through the lockstep loop explicitly (`integrate_rays(..., y0_dot=...)`):
    the bits of `torch.func.jvp` around the trace, and on a CUDA tensor the
    derivative whose loop replays a CUDA graph.

    Under a `torch.func` transform (`torch.func.jvp`, `jacfwd`, and so
    `diff.fwd_adjoint`) on a CUDA tensor, the trace is `_LiftedTrace`: the
    loop replays a captured body whose carry holds the metric's and the
    geometry's tensors and the trace's fields (`lifting`) with their
    tangents, K tangents of a `jacfwd` in one pass. A tensor under the
    transform that the trace reads from elsewhere (a user's callable's
    closure, say) raises there.

    A charge ``q`` ≠ 0 adds the Lorentz force (`make_geodesic_rhs`), and
    ``chart_inner`` may be a θ-dependent `PoloidalShape`
    (`event_horizon_chart`).

    ``checkpointed=True`` runs `integrate_rays_checkpointed` instead, the
    reverse-differentiable ladder of ``n_segments`` segments of
    ``seg_steps`` steps (``max_steps`` does not apply); a segment-based
    geometry (`MeshAccretionGeometry`) raises with it, as in the reference.
    """
    if trace is None:
        trace = TraceGeodesic(mu=mu, q=q)
    kw = dict(
        r_inner=chart_inner, closest_approach=closest_approach, r_outer=chart_outer,
        terminate_fns=terminate_fns, max_steps=max_steps, n_interp=n_interp,
    )  # fmt: skip
    if checkpointed:
        if geometry is not None and getattr(geometry, "segment_based", False):
            raise NotImplementedError(
                "checkpointed=True does not support segment-based geometry "
                "(MeshAccretionGeometry): the segment ladder has no per-step "
                "segment test. Use checkpointed=False."
            )
        del kw["max_steps"]
        kw.update(n_segments=n_segments, seg_steps=seg_steps)
    single, res, res_dot = _integrate(
        m, x, v, lam_span, trace, geometry, gtol, constrain, abstol, reltol, v_dot, kw, checkpointed
    )
    out = tuple(unpack_solution(r) for r in ((res,) if res_dot is None else (res, res_dot)))
    if single:
        out = tuple(gp[0] for gp in out)
    return out[0] if res_dot is None else out


def _rays(m, geometry, x, v):
    """``(single, x, v)``: the rays as (N, 4) tensors broadcast together on
    the device of ``x`` (a metric, geometry or ``v`` elsewhere raises),
    ``single`` when ``x`` and ``v`` are one ray."""
    x, v = _as_observer(x, m), _as_observer(v, m)
    _check_devices(m, geometry, x, v)
    single = x.dim() == 1 and v.dim() == 1
    return (single, *torch.broadcast_tensors(torch.atleast_2d(x), torch.atleast_2d(v)))


def _geometry_events(geometry, gtol):
    """The event keywords of `integrate_rays` for ``geometry``: none without
    one, ``segment_fn`` for a segment-based one (a mesh's chord test), else
    ``crossing_fn`` and ``hit_fn`` for its continuous events."""
    if geometry is None:
        return {}
    if getattr(geometry, "segment_based", False):

        def segment_fn(xa, xb):
            return geometry.segment_hit(xa, xb)

        return dict(segment_fn=segment_fn)

    def crossing_fn(y):
        return geometry.crossing_indicator(y[..., 0:4])

    def hit_fn(y):
        return geometry.is_hit(y[..., 0:4], gtol=gtol)

    return dict(crossing_fn=crossing_fn, hit_fn=hit_fn)


def _integrate(m, x, v, lam_span, trace, geometry, gtol, constrain, abstol, reltol, v_dot, kw, checkpointed=False):
    """`integrate_rays` of the geodesics from (``x``, ``v``) on the device of
    ``x``, with ``geometry``'s events and the dtype's tolerances unless
    given; ``kw`` its other keywords (``r_inner`` None: the metric's inner
    radius times ``closest_approach``). ``checkpointed``: the segment
    ladder (`integrate_rays_checkpointed`). Returns ``(single, result,
    tangent result or None)``, ``single`` when ``x`` and ``v`` are one
    ray."""
    single, x, v = _rays(m, geometry, x, v)
    a_tol, r_tol = _config.default_tols(x.dtype)
    kw = dict(kw, abstol=a_tol if abstol is None else abstol, reltol=r_tol if reltol is None else reltol)
    kw.update(_geometry_events(geometry, gtol))
    run = _Run(m, trace, geometry, constrain, lam_span, kw, checkpointed)
    if v_dot is None and not checkpointed and _lift_route(x.device):
        if run.under_transform(x, v):
            return single, run.lifted(x, v), None
        try:
            return single, run.primal(x, v), None
        except RuntimeError as err:
            # a transform reached the loop through a tensor no slot holds
            run.refuse_unlifted([], err)
            raise
    if v_dot is None:
        return single, run.primal(x, v), None
    with run.resolved() as (f, kw):
        y0, y0_dot = jvp(
            lambda v: run.start(x, v), (v,), (torch.broadcast_to(_as_observer(v_dot, m), v.shape),)
        )
        res, res_dot = integrate_rays(f, y0, lam_span, y0_dot=y0_dot, **kw)
    return single, res, res_dot


def _lift_route(device) -> bool:
    """Whether a trace under a `torch.func` transform on ``device`` takes
    the lifted route (`_LiftedTrace`): where the loop replays a CUDA graph."""
    return device.type == "cuda" and solver._CUDA_GRAPHS


class _Run:
    """One trace's problem: the metric, trace record and geometry whose
    tensors (`lifting.tensor_slots`, the floating ones) a lifted trace
    binds, and the keywords of the solver."""

    def __init__(self, m, trace, geometry, constrain, lam_span, kw, checkpointed):
        self.m, self.trace, self.geometry = m, trace, geometry
        self.constrain, self.lam_span, self.kw, self.checkpointed = constrain, lam_span, kw, checkpointed
        self.charged = _is_nonzero(trace.q)
        self.mu_nonzero = self.charged and _is_nonzero(trace.mu)

    @functools.cached_property
    def slots(self):
        slots = tensor_slots(self.m, self.geometry, self.trace)
        return [s for s, t in zip(slots, slot_values(slots)) if t.is_floating_point()]

    def start(self, x, v):
        if self.constrain:
            v = constrain_all(self.m, x, v, mu=self.trace.mu)
        return torch.cat([x, v], dim=-1)

    @contextlib.contextmanager
    def resolved(self, params=None):
        """Within the block, with ``params`` bound into the slots when
        given: the RHS and the solver's keywords, ``r_inner`` resolved."""
        with lifting.bound(self.slots, params) if params is not None else contextlib.nullcontext():
            kw = dict(self.kw)
            closest = kw.pop("closest_approach")
            if kw["r_inner"] is None:
                kw["r_inner"] = self.m.inner_radius() * closest
            yield _geodesic_rhs(self.m, self.trace, self.charged, self.mu_nonzero), kw

    def primal(self, x, v):
        with self.resolved() as (f, kw):
            y0 = self.start(x, v)
            if not self.checkpointed:
                return integrate_rays(f, y0, self.lam_span, **kw)
            return integrate_rays_checkpointed(f, y0, self.lam_span, slots=self.slots, **kw)

    def under_transform(self, x, v) -> bool:
        """Whether the rays or a tensor of the slots is under a `torch.func`
        transform."""
        return any(_is_wrapped(t) for t in (x, v, *lifting.slot_values(self.slots)))

    def refuse_unlifted(self, lifted, cause=None):
        """Raises, naming it, if a tensor the trace reads from outside
        ``lifted`` is under a `torch.func` transform."""
        roots = dict(metric=self.m, geometry=self.geometry, trace=self.trace, lam_span=self.lam_span, keywords=self.kw)
        leak = lifting.find_unlifted(roots, lifted, _is_wrapped)
        if leak is not None:
            raise RuntimeError(
                f"{leak} is under a torch.func transform, and the trace's captured loop lifts only x, v, "
                "the metric's and the geometry's tensors and the trace's fields: make it one of "
                "those, or run uncaptured within cuda_graphs(False)"
            ) from cause

    def lifted(self, x, v):
        """`_LiftedTrace` of the rays, after a check that nothing else the
        trace reads is under the transform."""
        params = lifting.slot_values(self.slots)
        self.refuse_unlifted([x, v, *params])
        # a dual may not be a broadcast view
        x, v = x.contiguous(), v.contiguous()
        y, lam, y0, lam0, status, steps, failed = _LiftedTrace.apply(self, x, v, *params)
        return solver.IntegrationResult(y=y, lam=lam, y0=y0, lam0=lam0, status=status, steps=steps, failed=failed)

    def tangents(self, primals, dots, batched: bool):
        """The tangents (y, λ, y0, λ0) of the trace from ``primals`` = (x,
        v, *params) along ``dots``, carried through the loop."""
        # r_inner from the primal parameters; the loop binds them again
        with self.resolved(primals[2:]) as (f, kw):
            pass
        with torch.no_grad():
            res, res_dot = solver.integrate_rays_lifted(
                f, self.start, primals, dots, self.lam_span, slots=self.slots, batched=batched, **kw
            )
        return res_dot.y, res_dot.lam, res_dot.y0, res_dot.lam0


class _LiftedTrace(torch.autograd.Function):
    """A trace whose inputs are the rays and the slots' tensors (`_Run`),
    so that a `torch.func` transform reaches its captured loop through the
    rules here: the forward is the captured primal trace; the jvp is
    `_LiftedTangent`, the captured explicit-tangent loop; under a vmap
    (`jacfwd`'s), the primal is unbatched and the K tangents ride in one
    pass. Outputs: y, λ, y0, λ0, status, steps, failed."""

    @staticmethod
    def forward(run, x, v, *params):
        # reverse mode does not pass through (the function has no backward)
        with torch.no_grad(), lifting.bound(run.slots, params):
            res = run.primal(x, v)
        # an output may not be a broadcast view
        return tuple(t.contiguous() for t in (res.y, res.lam, res.y0, res.lam0, res.status, res.steps, res.failed))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_forward(*inputs[1:])
        ctx.mark_non_differentiable(*output[4:])

    @staticmethod
    def vmap(info, in_dims, run, x, v, *params):
        if any(d is not None for d in in_dims[1:]):
            raise RuntimeError("a batch of traces under vmap: the captured trace takes one batch of rays")
        return _LiftedTrace.apply(run, x, v, *params), (None,) * 7

    @staticmethod
    def jvp(ctx, _run, *dots):
        primals = ctx.saved_tensors
        dots = [torch.zeros_like(p) if d is None else d for p, d in zip(primals, dots)]
        return (*_LiftedTangent.apply(ctx.run, len(primals), *primals, *dots), None, None, None)


class _LiftedTangent(torch.autograd.Function):
    """The tangents of `_LiftedTrace` from its primals and their tangents
    (``n`` of each): one explicit-tangent pass, and under a vmap of the
    tangents one pass for all K (`integrate_rays_lifted`)."""

    @staticmethod
    def forward(run, n, *tensors):
        return run.tangents(tensors[:n], tensors[n:], batched=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, run, n, *tensors):
        if any(d is not None for d in in_dims[2 : 2 + n]):
            raise RuntimeError("a batch of traces under vmap: the captured trace takes one batch of rays")
        k = info.batch_size
        dots = [t.expand(k, *t.shape) if d is None else t.movedim(d, 0) for t, d in zip(tensors[n:], in_dims[2 + n :])]
        return run.tangents(tensors[:n], dots, batched=True), (0, 0, 0, 0)


def trace_geodesics_dense(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    mu: float = 0.0,
    q: float = 0.0,
    geometry=None,
    gtol: float = 1e-2,
    chart_outer: float = 12000.0,
    abstol: float | None = None,
    reltol: float | None = None,
    max_steps: int = 40000,
    constrain: bool = True,
    n_save: int = 512,
    v_dot=None,
):
    """Like `trace_geodesics`, and also records each ray's trajectory at its
    accepted steps (reference ``save_on=true`` solutions). Returns
    ``(gp, traj (N, n_save, 8), traj_lam (N, n_save), n_steps)``, where
    ``n_steps`` counts the saved states (the initial one and the accepted
    steps, at most ``n_save``; a ray of more steps overwrites the last
    slot).

    With ``v_dot``, a tangent of ``v`` (``x`` and the metric held fixed),
    it returns the pair of that tuple and its tangent ``(gp_dot, traj_dot,
    traj_lam_dot, n_steps)``, the tangent carried through the lockstep loop
    as `trace_geodesics(..., v_dot=...)` carries it: on a CUDA tensor the
    loop still replays a CUDA graph."""
    kw = dict(r_inner=None, closest_approach=1.01, r_outer=chart_outer, max_steps=max_steps, n_save=n_save)
    single, res, res_dot = _integrate(
        m, x, v, lam_span, TraceGeodesic(mu=mu, q=q), geometry, gtol, constrain, abstol, reltol, v_dot, kw
    )
    nsteps = torch.clamp(res.steps + 1, max=n_save)

    def unpack(r):
        out = (unpack_solution(r), r.traj, r.traj_lam, nsteps)
        return tuple(o[0] for o in out) if single else out

    return unpack(res) if res_dot is None else (unpack(res), unpack(res_dot))


def tracegeodesics(m, x, v=None, lam_span=(0.0, 2000.0), **kwargs):
    """Reference-parity front door. Two dispatches:

    - ``tracegeodesics(m, x, v, lam_span, ...)`` — positions/velocities,
      exactly `trace_geodesics`;
    - ``tracegeodesics(m, model, lam_max_or_span; n_samples=64,
      sampler=None, ...)`` — sample a corona model's local sky and trace the
      emitted rays (reference corona-models.jl:143-153). As in the JAX
      package, ``n_samples`` defaults to 64 here where the reference's
      default is 1024.
    """
    if hasattr(x, "sample_position_velocity"):
        from gradus_tpu_torch.corona.samplers import BothHemispheres, EvenSampler, sky_angles_to_velocity

        model = x
        span = v if v is not None else lam_span
        if not isinstance(span, (tuple, list)) and torch.as_tensor(span).dim() == 0:
            span = (0.0, float(span))
        n_samples = kwargs.pop("n_samples", 64)
        sampler = kwargs.pop("sampler", None) or EvenSampler(domain=BothHemispheres())
        x_src, v_src = model.sample_position_velocity(m)
        idx = torch.arange(1, n_samples + 1, dtype=x_src.dtype, device=x_src.device)
        elev, az = sampler.sample_angles(idx, n_samples)
        vs = sky_angles_to_velocity(m, x_src, v_src, elev, az)
        kwargs.setdefault("constrain", False)
        return trace_geodesics(m, x_src.expand_as(vs), vs, span, **kwargs)
    return trace_geodesics(m, x, v, lam_span, **kwargs)


class Tracer:
    """Reusable tracer over a fixed (metric, geometry) pair (counterpart of
    the reference's `Tracer`, with the same constructor).

    Where the CUDA integrator takes the configuration (a CUDA tensor, a
    geodesic trace without charge, no ``terminate_fns``, a metric and a
    geometry that `CudaTracer` takes) it traces in segments, `CudaTracer.trace` with
    ``segments``: a pass of the integrator capped at each segment's length,
    after which the rays still in flight resume where they stopped (bit for
    bit a single pass). They resume alone, compacted, once the least
    bucket of ``min_bucket`` · 4^k rays that holds them is narrower than
    the pass (the reference's rule); until then the next pass keeps its
    width. Elsewhere (a CPU tensor, a charge, ``terminate_fns``, any
    other geometry, a metric the kernel cannot compile) it runs the
    lockstep solver through `CompactedIntegrator`, as the reference's
    `Tracer` does: one integrator per dtype and device, built at first use,
    whose working set shrinks by the same rule (on the card one captured
    graph a width); each ray's result is `trace_geodesics`'s.

    ``segment_iters`` and ``segment_schedule`` give the segments' lengths:
    the schedule's entries, then ``segment_iters`` each (by default the
    reference's growing schedule, `solver._segment_schedule`). ``progress``, if
    given, is called after each segment with a dict of ``segment``,
    ``width`` (the rays the segment ran), ``executed_iters`` (loop
    iterations so far), ``alive`` (rays still in flight) and ``total``.
    Not differentiable: use `trace_geodesics` under a transform.
    """

    def __init__(
        self,
        m: AbstractMetric,
        *,
        mu: float = 0.0,
        q: float = 0.0,
        trace=None,
        geometry=None,
        gtol: float = 1e-2,
        chart_inner=None,
        chart_outer: float = 12000.0,
        closest_approach: float = 1.01,
        abstol: float | None = None,
        reltol: float | None = None,
        max_steps: int = 40000,
        terminate_fns: tuple = (),
        n_interp: int = 8,
        segment_iters: int = 96,
        min_bucket: int = 8192,
        segment_schedule: tuple | None = None,
        dtype=None,
        progress=None,
    ):
        self.m = m
        self.trace = TraceGeodesic(mu=mu, q=q) if trace is None else trace
        self.geometry = geometry
        self.kw = dict(
            gtol=gtol, chart_inner=chart_inner, chart_outer=chart_outer, closest_approach=closest_approach,
            abstol=abstol, reltol=reltol, max_steps=max_steps, terminate_fns=terminate_fns, n_interp=n_interp,
        )  # fmt: skip
        self.dtype = dtype
        self.segment_iters = segment_iters
        self.min_bucket = min_bucket
        self.segment_schedule = _segment_schedule(segment_iters, segment_schedule)
        self.progress = progress
        self._integrators = {}  # (dtype, device) → CompactedIntegrator

    def _on_kernel(self, device, dtype) -> bool:
        from gradus_tpu_torch.integrate import cuda_solver

        if device.type != "cuda" or self.kw["terminate_fns"] or type(self.trace) is not TraceGeodesic:
            return False
        if _is_nonzero(self.trace.q):
            return False
        try:
            cuda_solver._check_kernel_config(self.m, self.geometry, dtype)
        except (NotImplementedError, ValueError):  # what the kernel cannot compile: captured arrays too
            return False
        return True

    def __call__(self, x, v, lam_span, constrain: bool = True) -> GeodesicPoint:
        _, x, v = _rays(self.m, self.geometry, x, v)
        if self._on_kernel(x.device, x.dtype):
            return self._kernel(x, v, lam_span, constrain)
        return self._lockstep(x, v, lam_span, constrain)

    def _lockstep(self, x, v, lam_span, constrain):
        if constrain:
            v = constrain_all(self.m, x, v, mu=self.trace.mu)
        integrator = self._integrator(x.dtype, x.device)
        return unpack_solution(integrator(torch.cat([x, v], dim=-1), lam_span))

    def _integrator(self, dtype, device):
        """The `CompactedIntegrator` of the rays' dtype and device: the
        right-hand side, events, chart and tolerances of `trace_geodesics`."""
        key = (dtype, device)
        if key not in self._integrators:
            kw = self.kw
            a_tol, r_tol = _config.default_tols(self.dtype or dtype)
            chart_inner = kw["chart_inner"]
            if chart_inner is None:
                chart_inner = self.m.inner_radius() * kw["closest_approach"]
            self._integrators[key] = CompactedIntegrator(
                make_geodesic_rhs(self.m, self.trace),
                abstol=a_tol if kw["abstol"] is None else kw["abstol"],
                reltol=r_tol if kw["reltol"] is None else kw["reltol"],
                r_inner=chart_inner,
                r_outer=kw["chart_outer"],
                terminate_fns=kw["terminate_fns"],
                max_steps=kw["max_steps"],
                n_interp=kw["n_interp"],
                segment_iters=self.segment_iters,
                min_bucket=self.min_bucket,
                segment_schedule=self.segment_schedule,
                progress=self.progress,
                **_geometry_events(self.geometry, kw["gtol"]),
            )
        return self._integrators[key]

    def _kernel(self, x, v, lam_span, constrain):
        from gradus_tpu_torch.integrate import cuda_solver

        kw = self.kw
        tracer = cuda_solver.CudaTracer(
            self.m, mu=self.trace.mu, geometry=self.geometry, gtol=kw["gtol"], chart_inner=kw["chart_inner"],
            chart_outer=kw["chart_outer"], closest_approach=kw["closest_approach"], abstol=kw["abstol"],
            reltol=kw["reltol"], max_steps=kw["max_steps"], n_interp=kw["n_interp"], dtype=self.dtype,
        )  # fmt: skip
        schedule = (*self.segment_schedule, self.segment_iters)
        gp = tracer(x, v, lam_span, constrain, segments=schedule, progress=self.progress, min_bucket=self.min_bucket)
        self.last_aux = tracer.last_aux
        return gp


def make_radiative_transfer_rhs(m: AbstractMetric, trace, geometry, r_isco=None):
    """RHS over (..., 10) states u = (x, k, I, n_crossings): covariant
    radiative transfer dI/dλ = ds/dλ·(−a_ν I + j_ν/ν³), integrated only
    while inside the (optically thick) geometry volume, that is while the
    crossing count is odd.

    Reference: `radiative_transfer` + `radiative_transfer_ode_problem`,
    `src/tracing/radiative-transfer-problem.jl:1-34, 147-189`. The fluid
    velocity is Keplerian outside the ISCO and the exact frozen-(E, L)
    plunge inside (`redshift.keplerian_velocity_projector`). ``r_isco`` is
    unused, as in the JAX package. ds/dλ = −g_μν k^μ u^ν as an elementwise
    sum."""
    from gradus_tpu_torch.geodesics.tetrads import dotproduct
    from gradus_tpu_torch.redshift import keplerian_velocity_projector

    project = keplerian_velocity_projector(m)

    def f(y):
        x, k, I = y[..., 0:4], y[..., 4:8], y[..., 8]
        acc = geodesic_equation(m, x, k)
        dsdlam = -dotproduct(m.metric(x), k, project(x))
        nu = trace.nu * dsdlam
        a_nu = geometry.absorption_coefficient(x, nu)
        j_nu = geometry.emission_coefficient(x, nu)
        within = torch.remainder(y[..., 9], 2.0) >= 1.0
        dI = torch.where(within, dsdlam * (-a_nu * I + j_nu / torch.clamp(nu, min=1e-30) ** 3), 0.0)
        return torch.cat([k, acc, dI[..., None], torch.zeros_like(dI)[..., None]], dim=-1)

    return f


def trace_radiative_transfer(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    trace: TraceRadiativeTransfer | None = None,
    geometry=None,
    gtol: float = 1e-2,
    chart_outer: float = 12000.0,
    abstol: float | None = None,
    reltol: float | None = None,
    max_steps: int = 40000,
    constrain: bool = True,
) -> GeodesicPoint:
    """Radiative-transfer trace: integrates the invariant intensity along
    the ray. An optically thin geometry ends the ray at its surface; an
    optically thick one runs the solver's crossing count
    (``terminate_on_hit=False``: each located crossing adds 1 to the last
    slot) and integrates the transfer equation through the volume.

    The endpoint's ``aux`` carries (I, n_crossings)."""
    if geometry is None:
        raise ValueError("radiative transfer requires geometry")
    if trace is None:
        trace = TraceRadiativeTransfer()
    single, x, v = _rays(m, geometry, x, v)
    if constrain:
        v = constrain_all(m, x, v, mu=trace.mu)
    a_tol, r_tol = _config.default_tols(x.dtype)
    extra = torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)
    extra[..., 0] = trace.I0
    result = integrate_rays(
        make_radiative_transfer_rhs(m, trace, geometry),
        torch.cat([x, v, extra], dim=-1),
        lam_span,
        abstol=a_tol if abstol is None else abstol,
        reltol=r_tol if reltol is None else reltol,
        r_inner=m.inner_radius() * 1.01,
        r_outer=chart_outer,
        max_steps=max_steps,
        terminate_on_hit=geometry.optically_thin,
        **_geometry_events(geometry, gtol),
    )
    gp = unpack_solution(result)
    return gp[0] if single else gp


class _WindingPlane:
    """Plane of constant θ used for winding counts."""

    optically_thin = False

    def __init__(self, inc):
        self.inc = inc

    def crossing_indicator(self, x4):
        return x4[..., 2] - self.inc

    def is_hit(self, x4, gtol=1e-2):
        return torch.ones(x4.shape[:-1], dtype=torch.bool, device=x4.device)


def trace_windings(
    m: AbstractMetric,
    x,
    v,
    lam_span=(0.0, 2000.0),
    *,
    plane_inc: float = math.pi / 2,
    mu: float = 0.0,
    **kwargs,
):
    """Count crossings of the θ = plane_inc plane along each geodesic
    (photon rings / higher-order images; reference `TraceWindings`,
    `src/tracing/photon-rings.jl`): a 9-slot state whose last slot the
    solver's crossing count (``terminate_on_hit=False``) increments.
    Returns ``(GeodesicPoint, windings)``, the windings as int32. Of the
    keywords only ``chart_outer`` and ``max_steps`` are read, as in the JAX
    package."""
    single, x, v = _rays(m, None, x, v)
    v = constrain_all(m, x, v, mu=mu)
    a_tol, r_tol = _config.default_tols(x.dtype)
    f8 = make_geodesic_rhs(m, TraceGeodesic(mu=mu))

    def f(y):
        return torch.cat([f8(y[..., :8]), torch.zeros_like(y[..., 8:9])], dim=-1)

    y0 = torch.cat([x, v, torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], dim=-1)
    result = integrate_rays(
        f,
        y0,
        lam_span,
        abstol=a_tol,
        reltol=r_tol,
        r_inner=m.inner_radius() * 1.01,
        r_outer=kwargs.get("chart_outer", 12000.0),
        terminate_on_hit=False,
        max_steps=kwargs.get("max_steps", 40000),
        **_geometry_events(_WindingPlane(plane_inc), 1e-2),
    )
    gp = unpack_solution(result)
    windings = result.y[..., 8].to(torch.int32)
    return (gp[0], windings[0]) if single else (gp, windings)


class PoloidalShape(NamedTuple):
    """θ-dependent inner chart boundary r_min(θ) (reference
    `PoloidalShapeChart`, `src/tracing/charts.jl:26-48`): ``rs`` at the
    increasing ``thetas``, tensors on the rays' device. Pass as
    ``chart_inner=`` to `trace_geodesics`; the solver interpolates r_min at
    each ray's current θ, clamped to the end values outside ``thetas``
    (as ``jnp.interp``: θ leaves [0, π] where a ray passes over a pole)."""

    rs: Any
    thetas: Any


def event_horizon_chart(m: AbstractMetric, closest_approach: float = 1.01, resolution: int = 128) -> PoloidalShape:
    """Shaped inner boundary from the θ-dependent event horizon (reference
    `event_horizon_chart`, charts.jl:60-69) — matters for near-extremal
    spins and deformed metrics where the horizon is not a coordinate
    sphere. A θ without a horizon takes the metric's inner radius."""
    from gradus_tpu_torch.orbits.special_radii import event_horizon

    rs, thetas = event_horizon(m, resolution=resolution)
    rs = torch.nan_to_num(rs, nan=float(m.inner_radius()))
    return PoloidalShape(rs=rs * closest_approach, thetas=thetas)
