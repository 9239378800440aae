"""Front-door tracing API (counterpart of `gradus_tpu/integrate/tracing.py`):
trace descriptions, the geodesic right-hand side, `trace_geodesics` over the
lockstep solver `integrate_rays`, and `tracegeodesics`.

The 8-component state is u = (x, v); the RHS is
``du/dλ = (v, geodesic_equation(m, x, v))``.

Not ported yet, and raising `NotImplementedError`: charged traces (the
Kerr-Newman Lorentz force, ROADMAP queue A, item 10) and
``checkpointed=True`` (item 11). `Tracer`, which wraps the reference's
`CompactedIntegrator`, is not here (item 2).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gradus_tpu_torch import config as _config
from gradus_tpu_torch.geodesics.equation import constrain_all, geodesic_equation
from gradus_tpu_torch.integrate.points import GeodesicPoint, unpack_solution
from gradus_tpu_torch.integrate.solver import integrate_rays
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer

__all__ = [
    "TraceGeodesic",
    "make_geodesic_rhs",
    "domain_upper_hemisphere",
    "trace_geodesics",
    "tracegeodesics",
]


@dataclasses.dataclass(frozen=True)
class TraceGeodesic:
    """Null (μ=0) / timelike (μ=1) trace. A charge q ≠ 0 (Lorentz force) is
    not ported yet."""

    mu: float = 0.0
    q: float = 0.0


def make_geodesic_rhs(m: AbstractMetric, trace: TraceGeodesic | None = None):
    """RHS over (..., 8) states (uncharged traces)."""
    if trace is not None and float(trace.q) != 0.0:
        raise NotImplementedError(
            "charged traces (Kerr-Newman Lorentz force) are not ported yet "
            "(ROADMAP queue A, remaining metrics)"
        )

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
) -> GeodesicPoint:
    """Trace a batch (or a single) geodesic; returns endpoint `GeodesicPoint`s.

    ``x``, ``v``: (..., 4) position / unconstrained velocity. The time
    component of ``v`` is solved from the norm constraint unless
    ``constrain=False``. The trace runs `integrate_rays` on the device of
    ``x``; a metric, geometry or ``v`` on another device raises
    `ValueError`. It is differentiable in forward mode (`torch.func.jvp`)
    with respect to the inputs and the metric's parameters.

    ``checkpointed=True`` (the reverse-differentiable segment ladder) is not
    ported yet; ``n_segments`` and ``seg_steps`` belong to it.
    """
    if checkpointed:
        raise NotImplementedError(
            "checkpointed=True (integrate_rays_checkpointed) is not ported yet "
            "(ROADMAP queue A, item 11)"
        )
    if trace is None:
        trace = TraceGeodesic(mu=mu, q=q)
    x, v = _as_observer(x, m), _as_observer(v, m)
    _check_devices(m, geometry, x, v)
    single = x.dim() == 1 and v.dim() == 1
    x, v = torch.broadcast_tensors(torch.atleast_2d(x), torch.atleast_2d(v))

    if constrain:
        v = constrain_all(m, x, v, mu=trace.mu)

    a_tol, r_tol = _config.default_tols(x.dtype)
    abstol = a_tol if abstol is None else abstol
    reltol = r_tol if reltol is None else reltol

    if chart_inner is None:
        chart_inner = m.inner_radius() * closest_approach

    crossing_fn = hit_fn = segment_fn = None
    if geometry is not None:
        if getattr(geometry, "segment_based", False):

            def segment_fn(xa, xb):
                return geometry.segment_hit(xa, xb)

        else:

            def crossing_fn(y):
                return geometry.crossing_indicator(y[..., 0:4])

            def hit_fn(y):
                return geometry.is_hit(y[..., 0:4], gtol=gtol)

    f = make_geodesic_rhs(m, trace)
    y0 = torch.cat([x, v], dim=-1)
    result = integrate_rays(
        f,
        y0,
        lam_span,
        abstol=abstol,
        reltol=reltol,
        r_inner=chart_inner,
        r_outer=chart_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        segment_fn=segment_fn,
        terminate_fns=terminate_fns,
        max_steps=max_steps,
        n_interp=n_interp,
    )
    gp = unpack_solution(result)
    return gp[0] if single else gp


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
