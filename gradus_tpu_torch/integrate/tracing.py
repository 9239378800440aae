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

Not ported yet, and raising `NotImplementedError`: ``checkpointed=True``
(ROADMAP queue A, item 11). `Tracer`, which wraps the reference's
`CompactedIntegrator`, is not here (item 13).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch

from gradus_tpu_torch import config as _config
from gradus_tpu_torch.geodesics.equation import constrain_all, geodesic_equation
from gradus_tpu_torch.integrate.points import GeodesicPoint, unpack_solution
from gradus_tpu_torch.integrate.solver import integrate_rays
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.utils.jvp import jvp

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
    batched over the rays, its index sums elementwise)."""
    if trace is not None and float(trace.q) != 0.0:
        from gradus_tpu_torch.metrics.kerr_newman import faraday_tensor

        q_over_mu = trace.q / (trace.mu if float(trace.mu) != 0.0 else 1.0)

        def f(y):
            x, v = y[..., 0:4], y[..., 4:8]
            lorentz = q_over_mu * (faraday_tensor(m, x) * v[..., None, :]).sum(dim=-1)
            return torch.cat([v, geodesic_equation(m, x, v) + lorentz], dim=-1)

        return f

    def f(y):
        x, v = y[..., 0:4], y[..., 4:8]
        return torch.cat([v, geodesic_equation(m, x, v)], dim=-1)

    return f


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

    A charge ``q`` ≠ 0 adds the Lorentz force (`make_geodesic_rhs`), and
    ``chart_inner`` may be a θ-dependent `PoloidalShape`
    (`event_horizon_chart`). ``checkpointed=True`` (the
    reverse-differentiable segment ladder) is not ported yet;
    ``n_segments`` and ``seg_steps`` belong to it.
    """
    if checkpointed:
        raise NotImplementedError(
            "checkpointed=True (integrate_rays_checkpointed) is not ported yet "
            "(ROADMAP queue A, item 11)"
        )
    if trace is None:
        trace = TraceGeodesic(mu=mu, q=q)
    if chart_inner is None:
        chart_inner = m.inner_radius() * closest_approach
    kw = dict(r_inner=chart_inner, r_outer=chart_outer, terminate_fns=terminate_fns, max_steps=max_steps, n_interp=n_interp)
    single, res, res_dot = _integrate(m, x, v, lam_span, trace, geometry, gtol, constrain, abstol, reltol, v_dot, kw)
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
    """The ``crossing_fn`` and ``hit_fn`` keywords of `integrate_rays` for a
    geometry's continuous events."""

    def crossing_fn(y):
        return geometry.crossing_indicator(y[..., 0:4])

    def hit_fn(y):
        return geometry.is_hit(y[..., 0:4], gtol=gtol)

    return dict(crossing_fn=crossing_fn, hit_fn=hit_fn)


def _integrate(m, x, v, lam_span, trace, geometry, gtol, constrain, abstol, reltol, v_dot, kw):
    """`integrate_rays` of the geodesics from (``x``, ``v``) on the device of
    ``x``, with ``geometry``'s events and the dtype's tolerances unless
    given; ``kw`` its other keywords. Returns ``(single, result, tangent
    result or None)``, ``single`` when ``x`` and ``v`` are one ray."""
    single, x, v = _rays(m, geometry, x, v)

    def start(v):
        if constrain:
            v = constrain_all(m, x, v, mu=trace.mu)
        return torch.cat([x, v], dim=-1)

    a_tol, r_tol = _config.default_tols(x.dtype)
    kw = dict(kw, abstol=a_tol if abstol is None else abstol, reltol=r_tol if reltol is None else reltol)
    if geometry is not None and getattr(geometry, "segment_based", False):

        def segment_fn(xa, xb):
            return geometry.segment_hit(xa, xb)

        kw["segment_fn"] = segment_fn
    elif geometry is not None:
        kw.update(_geometry_events(geometry, gtol))
    f = make_geodesic_rhs(m, trace)
    if v_dot is None:
        return single, integrate_rays(f, start(v), lam_span, **kw), None
    y0, y0_dot = jvp(start, (v,), (torch.broadcast_to(_as_observer(v_dot, m), v.shape),))
    res, res_dot = integrate_rays(f, y0, lam_span, y0_dot=y0_dot, **kw)
    return single, res, res_dot


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
    kw = dict(r_inner=m.inner_radius() * 1.01, r_outer=chart_outer, max_steps=max_steps, n_save=n_save)
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
