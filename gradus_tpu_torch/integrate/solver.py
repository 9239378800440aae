"""Batched adaptive geodesic integration with event detection: the lockstep
solver `integrate_rays` (counterpart of `gradus_tpu/integrate/solver.py`).

The whole ray batch advances in lockstep; each ray carries its own (dt,
error, status, alive) state, and every iteration is a fixed sequence of
masked array operations over the batch. On a CUDA tensor those operations
run on the card: this is plain torch, not the CUDA integrator kernel
(`integrate/cuda_solver.py`), which it does not call. Events:

- chart bounds at step end: r ≤ r_inner (a number, or r_min(θ) of a
  `PoloidalShape`) → WithinInnerBoundary, r > r_outer → OutOfDomain;
- a geometry's signed crossing indicator, located on the step's cubic
  Hermite interpolant (the cubic model of the indicator, or ``n_interp``
  samples and an in-loop bisection), validated by ``hit_fn``, and polished
  after the loop by Newton iterations on the exact trajectory
  (`_polish_carry_hits`);
- a ``segment_fn`` chord test on the interpolant, or user ``terminate_fns``,
  at step end.

Forward-mode differentiation by `torch.func.jvp` flows through the whole
loop on a CPU tensor: nothing in it writes in place, and the only value read
on the host is the tangent-free ``alive`` mask. (`torch.autograd.forward_ad`
does not: the loop nests `torch.func.jvp` of the crossing indicator, and
torch refuses nested forward-mode levels.) ``y0_dot`` carries the tangent
explicitly instead: the carry holds plain primal and tangent tensors, and
each iteration is the lifted jvp (`utils/jvp.py`) of one loop body, which
gives the same bits as a jvp around the whole loop.

On a CUDA tensor the loop is replayed as a CUDA graph: one loop body
(primal, or with the explicit tangent) is captured once per call, with the
carry in static buffers that the body writes back, and each block of
``_ALIVE_CHECK_EVERY`` iterations is that many replays, until no ray is
alive or ``max_steps`` is reached; ``alive.any()`` is read on the host
between blocks, as in the uncaptured loop, so the iteration count and every
output are the same. (A graph of a whole block of 16 bodies runs the same
kernels, but its capture costs 16 bodies of Python: ~2 s for a
forward-mode body, which a Newton of short traces pays once a trace.)
`cuda_graphs(False)` runs the uncaptured loop
on the card, the bit-for-bit reference. A capture that fails raises, and a
carry under a `torch.func` transform on the card raises rather than run
uncaptured: pass the tangent as ``y0_dot`` (`trace_geodesics(..., v_dot=...)`),
or trace through `trace_geodesics`, which lifts a transform into the loop
(`integrate_rays_lifted`: the metric's and geometry's tensors ride in the
carry with their tangents, K tangents of a `jacfwd` vmapped in one pass).
A carry that requires grad raises there too: autograd does not record a
replay. Reverse mode goes through `integrate_rays_checkpointed`, the
segment ladder, whose backward on the card replays a captured graph of one
body's vjp.

`CompactedIntegrator` runs the same loop body in segments and, between
them, gathers the rays still alive into a narrower working set (the
reference's compaction); on a CUDA tensor one body is captured a width.

Also here: the PI controller constants, the result record, and the Newton
polish of the integrator kernel's hits in its output layout (`_polish_hits`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch

from gradus_tpu_torch.integrate.events import cubic_first_crossing
from gradus_tpu_torch.integrate.lifting import bound, find_unlifted, slot_values
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tsit5 import hermite_interp, initial_dt, tsit5_step
from gradus_tpu_torch.utils.interp import linear_interp
from gradus_tpu_torch.utils.jvp import jvp

__all__ = [
    "CompactedIntegrator",
    "integrate_rays",
    "integrate_rays_checkpointed",
    "integrate_rays_lifted",
    "IntegrationResult",
    "cuda_graphs",
    "observe_loops",
]

# PI step-size controller constants (standard Gustafsson / OrdinaryDiffEq-style)
_GAMMA = 0.9
_BETA1 = 7.0 / 50.0
_BETA2 = 2.0 / 25.0
_QMAX_FACTOR = 10.0
_QMIN_FACTOR = 0.2
_QOLD_INIT = 1e-4

# Lockstep iterations between two reads of ``alive.any()`` (a device→host
# sync). An iteration after the last ray died changes only ``dt``, which is
# not an output, so every output is the same whatever this is.
_ALIVE_CHECK_EVERY = 16

# Whether the loop on a CUDA tensor replays a captured body: set by `cuda_graphs`.
_CUDA_GRAPHS = True
# The observers of the lockstep loops: set by `observe_loops`.
_OBSERVERS = ()


@contextlib.contextmanager
def cuda_graphs(enabled: bool = True):
    """Within the block, the lockstep loop on a CUDA tensor replays a CUDA
    graph (``enabled``) or runs uncaptured."""
    global _CUDA_GRAPHS
    before, _CUDA_GRAPHS = _CUDA_GRAPHS, bool(enabled)
    try:
        yield
    finally:
        _CUDA_GRAPHS = before


@contextlib.contextmanager
def observe_loops(observer: Callable):
    """Within the block, every lockstep loop reports to ``observer(event,
    **info)``: ``"loop"`` as it starts (``tangent``: whether it carries a
    tangent, ``graphed``: whether it replays a CUDA graph), ``"block"``
    before each block of iterations and ``"end"`` after the last
    (``iterations``: those the loop has run so far; ``alive``: the rays
    alive then), and ``"capture"`` once
    its graph is captured (``seconds`` of host time for the warm-up, the
    capture and the instantiation; ``reserved_bytes``, the card memory the
    capture reserved). Instrumentation for measurements: nothing the loop
    computes depends on it. Observers nest."""
    global _OBSERVERS
    before = _OBSERVERS
    _OBSERVERS = before + (observer,)
    try:
        yield observer
    finally:
        _OBSERVERS = before


def _tell(event: str, **info):
    for observer in _OBSERVERS:
        observer(event, **info)


@dataclasses.dataclass(frozen=True)
class IntegrationResult:
    """Struct-of-tensors solver output over the ray batch."""

    y: Any  # (N, S) final state
    lam: Any  # (N,) final affine parameter
    y0: Any  # (N, S) initial state
    lam0: Any  # (N,) initial affine parameter
    status: Any  # (N,) int32 StatusCodes
    steps: Any  # (N,) int32 accepted step count
    failed: Any  # (N,) bool — dt underflow (should never fire)
    traj: Any = None  # (N, n_save, S) accepted-step states (n_save mode)
    traj_lam: Any = None  # (N, n_save) affine parameters of saved states


def _error_norm(err_vec, y, y_new, abstol, reltol):
    sc = abstol + torch.maximum(torch.abs(y), torch.abs(y_new)) * reltol
    return torch.sqrt(torch.mean((err_vec / sc) ** 2, dim=-1))


@dataclasses.dataclass(frozen=True)
class _Problem:
    """Static description of one integration problem (everything that shapes
    the loop body; the per-ray state lives in the carry dict). The polish
    of the integrator kernel's hits (`_polish_hits`) reads only ``f``,
    ``crossing_fn`` and ``newton_iters``."""

    f: Callable
    abstol: float | None = None
    reltol: float | None = None
    r_inner: Any = None
    r_outer: Any = None
    crossing_fn: Callable | None = None
    hit_fn: Callable | None = None
    segment_fn: Callable | None = None
    terminate_fns: tuple = ()
    max_steps: int = 40000
    n_interp: int = 8
    dt_min: float = 1e-10
    bisect_iters: int = 10
    newton_iters: int = 3
    terminate_on_hit: bool = True
    n_save: int = 0
    # "cubic": first crossing of the Hermite cubic of the signed indicator
    # (events.py). Anything else: n_interp samples of the interpolant and an
    # in-loop bisection.
    event_method: str = "cubic"


def _init_carry(p: _Problem, y0, lam_span):
    N = y0.shape[:-1]
    dtype, device = y0.dtype, y0.device
    lam0 = torch.broadcast_to(torch.as_tensor(lam_span[0], dtype=dtype, device=device), N)
    lam1 = torch.broadcast_to(torch.as_tensor(lam_span[1], dtype=dtype, device=device), N)

    dt0 = torch.minimum(initial_dt(p.f, y0, p.abstol, p.reltol), lam1 - lam0)
    k1_0 = p.f(y0)

    # rays whose initial state or RHS is non-finite (e.g. physically
    # impossible initial velocities) are dead on arrival: flagged failed,
    # not integrated
    bad0 = ~(
        torch.all(torch.isfinite(y0), dim=-1)
        & torch.isfinite(dt0)
        & torch.all(torch.isfinite(k1_0), dim=-1)
    )
    zeros = torch.zeros(N, dtype=dtype, device=device)
    if p.crossing_fn is None:
        c_prev0, dc_prev0 = zeros, zeros
    elif p.event_method == "cubic":
        c_prev0, dc_prev0 = torch.func.jvp(p.crossing_fn, (y0,), (k1_0,))
    else:
        c_prev0, dc_prev0 = p.crossing_fn(y0), zeros

    carry0 = dict(
        y=y0,
        lam=lam0,
        lam1=lam1,
        dt=dt0,
        k1=k1_0,
        qold=torch.full(N, _QOLD_INIT, dtype=dtype, device=device),
        status=torch.full(N, StatusCodes.NoStatus, dtype=torch.int32, device=device),
        alive=~bad0,
        steps=torch.zeros(N, dtype=torch.int32, device=device),
        failed=bad0,
        c_prev=c_prev0,
        dc_prev=dc_prev0,
        hit_y=y0,
        hit_k=k1_0,
        hit_dt=zeros,
        hit_lam=lam0,
        hit_theta=zeros,
    )
    if p.n_save > 0:
        # trajectory buffers: slot 0 holds the initial state
        rest = N + (p.n_save - 1,)
        carry0["traj"] = torch.cat(
            [y0.unsqueeze(-2), torch.zeros(rest + y0.shape[-1:], dtype=dtype, device=device)], dim=-2
        )
        carry0["traj_lam"] = torch.cat(
            [lam0.unsqueeze(-1), torch.zeros(rest, dtype=dtype, device=device)], dim=-1
        )
    return carry0, lam0


def _make_body(p: _Problem, dtype, device):
    """The loop body: one adaptive Tsit5 step + event handling for every ray."""
    f = p.f
    have_geometry = p.crossing_fn is not None
    thetas = torch.as_tensor(np.linspace(0.0, 1.0, p.n_interp + 1)[1:], dtype=dtype, device=device)
    theta_grid = torch.cat([torch.zeros(1, dtype=dtype, device=device), thetas])

    def body(c):
        y, lam, dt = c["y"], c["lam"], c["dt"]
        lam1 = c["lam1"]
        alive = c["alive"]
        dt_eff = torch.minimum(torch.clamp(lam1 - lam, min=p.dt_min), dt)
        y_new, err_vec, _, k7 = tsit5_step(f, y, dt_eff, c["k1"])
        err = _error_norm(err_vec, y, y_new, p.abstol, p.reltol)
        err = torch.clamp(err, min=1e-12)
        step_ok = torch.isfinite(err) & torch.all(torch.isfinite(y_new), dim=-1)
        err = torch.where(step_ok, err, 2.0)  # treat NaN steps as rejected
        accept = (err <= 1.0) & alive

        # --- PI controller ---------------------------------------------------
        q = (err**_BETA1) / (c["qold"] ** _BETA2) / _GAMMA
        fac_acc = 1.0 / torch.clamp(q, 1.0 / _QMAX_FACTOR, 1.0 / _QMIN_FACTOR)
        fac_rej = 1.0 / torch.clamp((err**0.2) / _GAMMA, 1.0, 1.0 / _QMIN_FACTOR)
        dt_next = torch.where(accept, dt_eff * fac_acc, dt_eff * fac_rej)
        failed = c["failed"] | (
            alive & ~step_ok & ((dt_next < p.dt_min) | ~torch.isfinite(dt_next))
        )
        qold_new = torch.where(accept, torch.clamp(err, min=_QOLD_INIT), c["qold"])

        lam_new = lam + dt_eff

        def interp_at(theta):
            return hermite_interp(torch.broadcast_to(theta, lam.shape), y, y_new, c["k1"], k7, dt_eff)

        # --- geometry event (continuous) --------------------------------------
        dc_prev_new = c["dc_prev"]
        if have_geometry and p.event_method == "cubic":
            c1v, dc1v = torch.func.jvp(p.crossing_fn, (y_new,), (k7,))
            found, th_c = cubic_first_crossing(c["c_prev"], dt_eff * c["dc_prev"], c1v, dt_eff * dc1v)
            candidate = found & accept
            valid = p.hit_fn(interp_at(th_c)) if p.hit_fn is not None else torch.ones_like(accept)
            hit_now = candidate & valid
            c_prev_new = torch.where(accept, c1v, c["c_prev"])
            dc_prev_new = torch.where(accept, dc1v, c["dc_prev"])
        elif have_geometry:
            cs = torch.stack([p.crossing_fn(interp_at(t)) for t in thetas])  # (K, N)
            c_all = torch.cat([c["c_prev"][None], cs], dim=0)
            sign_change = (torch.signbit(c_all[:-1]) != torch.signbit(c_all[1:])) & accept[None]
            candidate = torch.any(sign_change, dim=0)
            first = torch.argmax(sign_change.to(torch.uint8), dim=0)
            th_a = theta_grid[first]
            th_b = theta_grid[first + 1]
            ca = torch.gather(c_all, 0, first[None])[0]

            # in-loop bisection on the interpolant: the left-end sign is
            # tracked so each iteration costs ONE crossing evaluation (the
            # post-loop Newton polish restores full 5th-order accuracy)
            for _ in range(p.bisect_iters):
                mid = 0.5 * (th_a + th_b)
                cm = p.crossing_fn(interp_at(mid))
                same = torch.signbit(cm) == torch.signbit(ca)
                th_a, th_b, ca = (
                    torch.where(same, mid, th_a),
                    torch.where(same, th_b, mid),
                    torch.where(same, cm, ca),
                )
            th_c = 0.5 * (th_a + th_b)
            valid = p.hit_fn(interp_at(th_c)) if p.hit_fn is not None else torch.ones_like(accept)
            hit_now = candidate & valid
            c_prev_new = torch.where(accept, c_all[-1], c["c_prev"])
        elif p.segment_fn is not None:
            # segment-based geometry (meshes): test each interpolant chord;
            # terminate at step end
            pts = [interp_at(t)[..., 0:4] for t in theta_grid]
            seg_hits = torch.stack([p.segment_fn(a, b) for a, b in zip(pts[:-1], pts[1:])])
            hit_now = torch.any(seg_hits, dim=0) & accept
            th_c = torch.ones_like(lam)
            c_prev_new = c["c_prev"]
        else:
            hit_now = torch.zeros_like(alive)
            th_c = torch.zeros_like(lam)
            c_prev_new = c["c_prev"]

        # --- chart + user discrete events (step end), masked by no-hit -------
        # r_inner may be a θ-dependent PoloidalShape (reference
        # `PoloidalShapeChart`, charts.jl:26-48): r_min at each ray's θ,
        # clamped to the end values outside the shape's θ range
        r_new = y_new[..., 1]
        if getattr(p.r_inner, "rs", None) is not None:
            rmin = linear_interp(y_new[..., 2], p.r_inner.thetas, p.r_inner.rs)
        else:
            rmin = p.r_inner
        inner = accept & ~hit_now & (r_new <= rmin)
        outer = accept & ~hit_now & (r_new > p.r_outer)
        user_masks = [
            accept & ~hit_now & ~inner & ~outer & pred(y_new, lam_new) for pred, _code in p.terminate_fns
        ]
        finished = accept & (lam_new >= lam1 - 1e-12)

        # --- commit ----------------------------------------------------------
        sel = accept[..., None]
        y_out = torch.where(sel, y_new, y)
        lam_out = torch.where(accept, lam_new, lam)
        k1_out = torch.where(sel, k7, c["k1"])

        status = c["status"]
        status = torch.where(inner, StatusCodes.WithinInnerBoundary, status)
        status = torch.where(outer, StatusCodes.OutOfDomain, status)
        for (_pred, code), mask in zip(p.terminate_fns, user_masks):
            status = torch.where(mask, code, status)

        if p.terminate_on_hit:
            status = torch.where(hit_now, StatusCodes.IntersectedWithGeometry, status)
            dead = hit_now | inner | outer | finished | failed
        else:
            # bump the crossing counter (last state component) and continue
            bumped = torch.cat([y_out[..., :-1], y_out[..., -1:] + 1.0], dim=-1)
            y_out = torch.where(hit_now[..., None], bumped, y_out)
            dead = inner | outer | finished | failed
        for mask in user_masks:
            dead = dead | mask

        hsel = hit_now[..., None]
        steps_new = c["steps"] + accept.to(torch.int32)
        out = dict(
            y=y_out,
            lam=lam_out,
            lam1=lam1,
            dt=dt_next,
            k1=k1_out,
            qold=qold_new,
            status=status,
            alive=alive & ~dead,
            steps=steps_new,
            failed=failed,
            c_prev=c_prev_new,
            dc_prev=dc_prev_new,
            hit_y=torch.where(hsel, y, c["hit_y"]),
            hit_k=torch.where(hsel, c["k1"], c["hit_k"]),
            hit_dt=torch.where(hit_now, dt_eff, c["hit_dt"]),
            hit_lam=torch.where(hit_now, lam, c["hit_lam"]),
            hit_theta=torch.where(hit_now, th_c, c["hit_theta"]),
        )
        if p.n_save > 0:
            # the accepted state goes to slot min(steps, n_save - 1): an
            # out-of-place scatter of each ray's slot, rewritten unchanged
            # where the step was rejected
            idx = torch.clamp(steps_new, 0, p.n_save - 1).to(torch.int64)[:, None]
            cur = torch.gather(c["traj_lam"], 1, idx)[:, 0]
            out["traj_lam"] = torch.scatter(
                c["traj_lam"], 1, idx, torch.where(accept, lam_new, cur)[:, None]
            )
            idx_s = idx[..., None].expand(-1, 1, y.shape[-1])
            cur_y = torch.gather(c["traj"], 1, idx_s)[:, 0]
            out["traj"] = torch.scatter(
                c["traj"], 1, idx_s, torch.where(sel, y_new, cur_y)[:, None]
            )
        return out

    return body


def _newton_polish(p: _Problem, hit, y_s, k_s, dt_s, lam_s, theta, y_f, lam_f):
    """Newton polish on the exact trajectory: one 5th-order RK substep from
    the hit step's start (``y_s``, ``k_s``, ``lam_s``, span ``dt_s``) to λ*,
    then λ* ← λ* − c(y*)/(∇c·f)(y*), from the event's fraction ``theta``;
    ``y_f`` and ``lam_f`` take the result where ``hit``."""
    dt_safe = torch.where(hit, dt_s, torch.ones_like(dt_s))
    th = theta
    for _ in range(p.newton_iters):
        ystar, _, _, _ = tsit5_step(p.f, y_s, th * dt_safe, k_s)
        cval, cdot = torch.func.jvp(p.crossing_fn, (ystar,), (p.f(ystar),))
        cdot = torch.where(torch.abs(cdot) < 1e-30, torch.ones_like(cdot), cdot)
        th = torch.clamp(th - cval / (cdot * dt_safe), 0.0, 1.0)
    dt_star = th * dt_safe
    y_star, _, _, _ = tsit5_step(p.f, y_s, dt_star, k_s)
    y_f = torch.where(hit[..., None], y_star, y_f)
    lam_f = torch.where(hit, lam_s + dt_star, lam_f)
    return y_f, lam_f


def _polish_hits(p: _Problem, cf: dict, y_f, lam_f):
    """The Newton polish of the integrator kernel's hits (`_newton_polish`).

    ``cf`` holds the kernel's raw outputs: for a hit ray ``y``, ``k1`` and
    ``lam`` are the hit step's start and ``dt`` its span."""
    hit = cf["status"] == StatusCodes.IntersectedWithGeometry
    return _newton_polish(p, hit, cf["y"], cf["k1"], cf["dt"], cf["lam"], cf["hit_theta"], y_f, lam_f)


def _polish_carry_hits(p: _Problem, cf: dict, y_f, lam_f):
    """The Newton polish of `integrate_rays`'s hits (`_newton_polish`),
    from the hit step the loop recorded in ``hit_y``, ``hit_k``,
    ``hit_dt``, ``hit_lam`` and ``hit_theta``."""
    hit = cf["status"] == StatusCodes.IntersectedWithGeometry
    return _newton_polish(
        p, hit, cf["hit_y"], cf["hit_k"], cf["hit_dt"], cf["hit_lam"], cf["hit_theta"], y_f, lam_f
    )


_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor
_DOT = "dot_"  # key prefix of a tangent in the explicit-tangent carry


def _tangent_step(body, float_keys, batched: bool = False):
    """One iteration of the explicit-tangent loop: the lifted jvp of
    ``body`` over a carry holding each float entry ``k`` and its tangent
    ``dot_k``; the integer and boolean entries ride along. With
    ``batched``, each tangent holds K tangents on a leading axis, and the
    jvp is vmapped over them: one primal body for K tangents."""

    def step(c):
        rest = {k: v for k, v in c.items() if k not in float_keys and not k.startswith(_DOT)}

        def f(primal):
            out = body({**primal, **rest})
            return {k: out[k] for k in float_keys}, {k: out[k] for k in rest}

        # a dual may not be a broadcast view
        primals = {k: c[k].contiguous() for k in float_keys}
        tangents = {k: c[_DOT + k].contiguous() for k in float_keys}
        out, out_dot, aux = _jvp_maybe_batched(f, primals, tangents, batched)
        return {**out, **{_DOT + k: v for k, v in out_dot.items()}, **aux}

    return step


def _jvp_maybe_batched(f, primals, tangents, batched: bool):
    """The lifted ``jvp(f, (primals,), (tangents,), has_aux=True)``, vmapped
    over the tangents' leading axis when ``batched``."""
    if not batched:
        return jvp(f, (primals,), (tangents,), has_aux=True)
    return torch.func.vmap(lambda t: jvp(f, (primals,), (t,), has_aux=True), out_dims=(None, 0, None))(tangents)


_PARAM = "param_"  # key prefix of a lifted slot's value in the carry


def _param_keys(slots):
    return [f"{_PARAM}{i}" for i in range(len(slots))]


def _with_params(body, slots):
    """``body`` over a carry that also holds each slot's value (`lifting`)
    under ``param_i``: the values are bound into their slots while the body
    runs, and pass through unchanged, so that a captured body reads them
    from the carry's static buffers and a jvp or vjp of the step sees them
    as inputs."""
    keys = _param_keys(slots)

    def step(c):
        with bound(slots, [c[k] for k in keys]):
            out = body(c)
        return {**out, **{k: c[k] for k in keys}}

    return step


def _graph_of(warm_up, work, device, **info):
    """A CUDA graph of ``work()`` on ``device``, after one run of
    ``warm_up()`` on a side stream (lazy initialisation stays out of the
    capture; it must change no buffer the graph reads). Reports
    ``"capture"`` to the observers with ``info``."""
    t0 = time.perf_counter()
    reserved0 = torch.cuda.memory_reserved(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_up()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        work()
    _tell(
        "capture",
        seconds=time.perf_counter() - t0,
        reserved_bytes=torch.cuda.memory_reserved(device) - reserved0,
        **info,
    )
    return graph


def _capture(step, static: dict, **info):
    """A CUDA graph of one iteration of ``step`` from the carry ``static``,
    ending with the new carry copied into ``static`` (the body is out of
    place, so its warm-up changes no buffer). ``info`` goes with the
    ``"capture"`` event."""

    def work():
        c = step(static)
        for k, buf in static.items():
            buf.copy_(c[k])

    return _graph_of(lambda: step(static), work, static["alive"].device, **info)


def _graphed(cf: dict) -> bool:
    """Whether the loop over carry ``cf`` replays a CUDA graph."""
    return cf["alive"].device.type == "cuda" and _CUDA_GRAPHS


def _refuse_uncapturable(cf: dict):
    """Raises if the carry ``cf`` of a captured loop is under a `torch.func`
    transform or requires grad: a replay records neither."""
    if any(_is_wrapped(v) for v in cf.values()):
        raise RuntimeError(
            "the lockstep loop on a CUDA tensor replays a CUDA graph, which cannot be captured "
            "under a torch.func transform: pass the tangent explicitly (integrate_rays(..., "
            "y0_dot=...), trace_geodesics(..., v_dot=...)), trace through trace_geodesics, which "
            "lifts the transform into the loop, or run uncaptured within cuda_graphs(False)"
        )
    if torch.is_grad_enabled() and any(v.requires_grad for v in cf.values()):
        raise RuntimeError(
            "the lockstep loop on a CUDA tensor replays a CUDA graph, which autograd does not record: "
            "for reverse mode trace with checkpointed=True (integrate_rays_checkpointed), whose "
            "backward is captured too, or run uncaptured within cuda_graphs(False)"
        )


def _run_loop(step, cf: dict, max_steps: int):
    """The reference's ``while any(alive) & iters < max_steps``, with the
    any() read every _ALIVE_CHECK_EVERY iterations; on a CUDA tensor, unless
    within `cuda_graphs(False)`, each iteration is a replay of the captured
    body."""
    graphed = _graphed(cf)
    if graphed:
        _refuse_uncapturable(cf)
        # static buffers: the graph reads the carry from them and writes it back
        cf = {k: v.clone(memory_format=torch.contiguous_format) for k, v in cf.items()}
    _tell("loop", tangent=any(k.startswith(_DOT) for k in cf), graphed=graphed)
    graph = None
    iters = 0
    while iters < max_steps:
        # one read on the host: while observers listen, the count of alive rays
        alive = int(cf["alive"].sum()) if _OBSERVERS else bool(cf["alive"].any())
        if not alive:
            break
        _tell("block", iterations=iters, alive=alive)
        block = min(_ALIVE_CHECK_EVERY, max_steps - iters)
        if graphed:
            if graph is None:
                graph = _capture(step, cf)
            for _ in range(block):
                graph.replay()
        else:
            for _ in range(block):
                cf = step(cf)
        iters += block
    _tell("end", iterations=iters, alive=int(cf["alive"].sum()) if _OBSERVERS else None)
    return cf


def integrate_rays(
    f: Callable,
    y0,
    lam_span,
    *,
    abstol: float,
    reltol: float,
    r_inner,
    r_outer,
    crossing_fn: Callable | None = None,
    hit_fn: Callable | None = None,
    segment_fn: Callable | None = None,
    terminate_fns: tuple = (),
    max_steps: int = 40000,
    n_interp: int = 8,
    dt_min: float = 1e-10,
    bisect_iters: int = 10,
    newton_iters: int = 3,
    terminate_on_hit: bool = True,
    n_save: int = 0,
    event_method: str = "cubic",
    y0_dot=None,
):
    """Integrate a batch of rays dy/dλ = f(y) from λ0 to λ1 with events, on
    the device of ``y0``.

    Parameters
    ----------
    f : RHS ``f(y) -> dy`` over ``(..., S)`` states (first 4 components must be
        the position 4-vector for the chart checks).
    y0 : (N, S) initial states.
    lam_span : (λ0, λ1) scalars, or per-ray tensors broadcastable to (N,).
    r_inner, r_outer : chart bounds (scalars); ``r_inner`` may also be a
        θ-dependent `PoloidalShape`, interpolated at each ray's θ.
    crossing_fn : optional signed surface indicator ``c(y) -> (...,)``; a zero
        crossing that passes ``hit_fn`` terminates with
        IntersectedWithGeometry.
    hit_fn : validity predicate at a located crossing (annulus test).
    segment_fn : without ``crossing_fn``, ``seg(xa, xb) -> bool (...,)`` over
        the n_interp chords of each step's interpolated positions; a hit
        ends the ray at step end.
    terminate_fns : tuple of ``(pred(y, lam) -> bool mask, status_code)``
        discrete step-end callbacks (e.g. `domain_upper_hemisphere`).
    max_steps : lockstep iterations at most, for the whole batch.
    terminate_on_hit : when False, a validated crossing does NOT kill the ray;
        instead the LAST state component is incremented by 1 (a crossing
        counter) and no hit is polished.
    n_save : with n_save > 0, the result's ``traj``/``traj_lam`` hold the
        initial state and the first n_save − 1 accepted steps' states (a ray
        of more steps overwrites the last slot).
    y0_dot : optional (N, S) tangent of ``y0``. Then the result is a pair
        (`IntegrationResult`, its tangent along ``y0_dot``: an
        `IntegrationResult` whose ``y``, ``lam``, ``y0``, ``lam0``,
        ``traj`` and ``traj_lam`` are tangents and whose integer fields are
        the primal's), computed with the tangent carried through the loop
        explicitly.

    Returns an `IntegrationResult` (a pair with ``y0_dot``).
    """
    p = _Problem(
        f=f,
        abstol=abstol,
        reltol=reltol,
        r_inner=r_inner,
        r_outer=r_outer,
        crossing_fn=crossing_fn,
        hit_fn=hit_fn,
        segment_fn=segment_fn,
        terminate_fns=terminate_fns,
        max_steps=max_steps,
        n_interp=n_interp,
        dt_min=dt_min,
        bisect_iters=bisect_iters,
        newton_iters=newton_iters,
        terminate_on_hit=terminate_on_hit,
        n_save=n_save,
        event_method=event_method,
    )
    body = _make_body(p, y0.dtype, y0.device)
    polish = crossing_fn is not None and terminate_on_hit
    if y0_dot is not None:
        return _integrate_lifted(p, body, lambda y: y, (y0,), (y0_dot,), lam_span, polish)
    cf, lam0 = _init_carry(p, y0, lam_span)
    cf = _run_loop(body, cf, p.max_steps)

    y_f, lam_f = cf["y"], cf["lam"]
    if polish:
        y_f, lam_f = _polish_carry_hits(p, cf, y_f, lam_f)

    return IntegrationResult(
        y=y_f,
        lam=lam_f,
        y0=y0,
        lam0=lam0,
        status=cf["status"],
        steps=cf["steps"],
        failed=cf["failed"],
        traj=cf.get("traj"),
        traj_lam=cf.get("traj_lam"),
    )


# --- compacted execution ------------------------------------------------------

# the per-ray fields of the result, flushed into the full-size output before
# each compaction and at the end
_OUT_KEYS = ("y", "lam", "status", "steps", "failed", "hit_y", "hit_k", "hit_dt", "hit_lam", "hit_theta")


def _next_bucket(n: int, min_bucket: int) -> int:
    """Smallest power-of-4 multiple of ``min_bucket`` that is ≥ n."""
    b = min_bucket
    while b < n:
        b *= 4
    return b


def _segment_schedule(segment_iters: int, schedule):
    """The segments' lengths before every later one has ``segment_iters``:
    ``schedule``, or by default the reference's growing schedule, pairs of
    ``segment_iters // 4`` (at least 8) doubling up to ``segment_iters``.
    Short early segments let compaction trim the fast-dying bulk (disc hits
    cluster at ~60 steps on the flagship render) before it occupies
    full-width lanes; long late ones amortize the host's round trips over
    the long-lived tail."""
    if schedule is not None:
        return tuple(schedule)
    s, seq = max(segment_iters // 4, 8), []
    while s < segment_iters:
        seq.extend([s, s])
        s *= 2
    return tuple(seq) or (segment_iters,)


class CompactedIntegrator:
    """Host-driven segmented integration with alive-ray compaction
    (counterpart of the reference's `CompactedIntegrator`).

    The loop of `integrate_rays` runs in segments, of ``segment_schedule``'s
    lengths and then ``segment_iters`` each: a segment runs while a ray is
    alive and the loop has run fewer than ``min(its start + its length,
    max_steps)`` iterations in which one was. After a segment, once the
    least bucket of ``min_bucket`` · 4^k rays that holds the rays still
    alive is narrower than the working set, the working set is flushed into
    the full-size output and the alive rays, padded by dead ones in their
    order, are gathered into a working set of the bucket's width. Each
    ray's result is that of `integrate_rays` on the same batch (on the
    CPU at widths that are multiples of 16: torch's vector loops run a
    shorter tail through scalar functions, whose last bits differ).

    On a CUDA tensor each width's loop body is captured once as a CUDA
    graph with its own static carry, cached on the instance across calls
    (a second call of the same size captures nothing), and replayed an
    iteration; ``alive.any()`` is read every ``_ALIVE_CHECK_EVERY``
    iterations, and the alive count and the iterations once a segment.
    `cuda_graphs(False)` runs the loop uncaptured; a capture that fails
    raises. Not differentiable: a carry on the card under a `torch.func`
    transform, or one that requires grad, raises, as in `integrate_rays`.

    ``progress``, if given, is called after each segment with a dict of
    ``segment``, ``width``, ``executed_iters`` (loop iterations so far),
    ``alive`` and ``total``. After a call, ``last_stats`` holds a
    ``(width, executed iterations, alive after)`` triple a segment and
    ``last_steps`` the result's ``steps``. The other keywords are those of
    `integrate_rays`.
    """

    def __init__(
        self,
        f: Callable,
        *,
        abstol: float,
        reltol: float,
        r_inner,
        r_outer,
        crossing_fn: Callable | None = None,
        hit_fn: Callable | None = None,
        segment_fn: Callable | None = None,
        terminate_fns: tuple = (),
        max_steps: int = 40000,
        n_interp: int = 8,
        dt_min: float = 1e-10,
        bisect_iters: int = 10,
        newton_iters: int = 3,
        terminate_on_hit: bool = True,
        segment_iters: int = 96,
        min_bucket: int = 8192,
        event_method: str = "cubic",
        segment_schedule: tuple | None = None,
        progress=None,
    ):
        self.p = _Problem(
            f=f,
            abstol=abstol,
            reltol=reltol,
            r_inner=r_inner,
            r_outer=r_outer,
            crossing_fn=crossing_fn,
            hit_fn=hit_fn,
            segment_fn=segment_fn,
            terminate_fns=terminate_fns,
            max_steps=max_steps,
            n_interp=n_interp,
            dt_min=dt_min,
            bisect_iters=bisect_iters,
            newton_iters=newton_iters,
            terminate_on_hit=terminate_on_hit,
            n_save=0,
            event_method=event_method,
        )
        self.segment_iters = segment_iters
        self.min_bucket = min_bucket
        self.segment_schedule = _segment_schedule(segment_iters, segment_schedule)
        self.progress = progress
        self._steps = {}  # (dtype, device) → the loop step
        self._widths = {}  # (width, S, dtype, device) → [graph or None, static carry]

    def _segment_len(self, k: int) -> int:
        return self.segment_schedule[k] if k < len(self.segment_schedule) else self.segment_iters

    def _step(self, dtype, device):
        """One loop iteration: the body of `integrate_rays`, and ``iters``
        counting the iterations in which a ray was alive (the reference's
        loop counter)."""
        key = (dtype, device)
        if key not in self._steps:
            body = _make_body(self.p, dtype, device)

            def step(c):
                return {**body(c), "iters": c["iters"] + c["alive"].any().to(torch.int32)}

            self._steps[key] = step
        return self._steps[key]

    def _static(self, cf: dict):
        """The static carry of ``cf``'s width (made at its first use), with
        ``cf`` copied in, and its graph (None until captured)."""
        y = cf["y"]
        key = (y.shape[0], y.shape[1], y.dtype, y.device)
        if key not in self._widths:
            self._widths[key] = [None, {k: torch.empty_like(v, memory_format=torch.contiguous_format) for k, v in cf.items()}]
        entry = self._widths[key]
        for k, buf in entry[1].items():
            buf.copy_(cf[k])
        return entry

    def __call__(self, y0, lam_span) -> IntegrationResult:
        y0 = torch.as_tensor(y0)
        if y0.dim() != 2:
            raise ValueError("CompactedIntegrator expects a (N, S) batch")
        p, N = self.p, y0.shape[0]
        cf, lam0 = _init_carry(p, y0, lam_span)
        cf["iters"] = torch.zeros((), dtype=torch.int32, device=y0.device)
        graphed = _graphed(cf)
        if graphed:
            _refuse_uncapturable(cf)
        step = self._step(y0.dtype, y0.device)
        out = {k: cf[k].clone(memory_format=torch.contiguous_format) for k in _OUT_KEYS}
        glob_idx = torch.arange(N, device=y0.device)  # working-set row → ray
        entry = self._static(cf) if graphed else None
        if graphed:
            cf = entry[1]

        def flush():
            for k in _OUT_KEYS:
                out[k].index_copy_(0, glob_idx, cf[k])

        _tell("loop", tangent=False, graphed=graphed)
        stats, iters, replays, segment = [], 0, 0, 0  # iters: those in which a ray was alive
        while iters < p.max_steps:
            width = cf["lam"].shape[0]
            cap = min(iters + self._segment_len(segment), p.max_steps)
            segment += 1
            done = iters
            while done < cap:
                # a segment's first block reads nothing: the last segment
                # left a ray alive, and an iteration without one changes no
                # output and no count
                if done > iters and not bool(cf["alive"].any()):
                    break
                _tell("block", iterations=replays)
                block = min(_ALIVE_CHECK_EVERY, cap - done)
                if graphed:
                    if entry[0] is None:
                        entry[0] = _capture(step, cf, width=width)
                    for _ in range(block):
                        entry[0].replay()
                else:
                    for _ in range(block):
                        cf = step(cf)
                done += block
                replays += block
            # one read on the host for both numbers
            n_alive, executed = torch.stack([cf["alive"].sum(), cf["iters"].to(torch.int64)]).tolist()
            stats.append((width, executed - iters, n_alive))
            iters = executed
            if self.progress is not None:
                self.progress(dict(segment=segment, width=width, executed_iters=executed, alive=n_alive, total=N))
            if n_alive == 0:
                break
            bucket = _next_bucket(n_alive, self.min_bucket)
            if bucket < width:
                flush()
                idx = torch.argsort((~cf["alive"]).to(torch.uint8), stable=True)[:bucket]
                glob_idx = glob_idx[idx]
                gathered = {k: (v if k == "iters" else v[idx]) for k, v in cf.items()}
                if graphed:
                    entry = self._static(gathered)
                    cf = entry[1]
                else:
                    cf = gathered
        flush()
        _tell("end", iterations=replays, alive=int(cf["alive"].sum()) if _OBSERVERS else None)
        self.last_stats = stats

        y_f, lam_f = out["y"], out["lam"]
        if p.crossing_fn is not None and p.terminate_on_hit:
            y_f, lam_f = _polish_carry_hits(p, out, y_f, lam_f)
        result = IntegrationResult(
            y=y_f, lam=lam_f, y0=y0, lam0=lam0, status=out["status"], steps=out["steps"], failed=out["failed"]
        )
        self.last_steps = result.steps
        return result


def _integrate_lifted(p: _Problem, body, make_y0, inputs, dots, lam_span, polish: bool, slots=(), batched=False):
    """The explicit-tangent loop from ``y0 = make_y0(*inputs)``, the inputs'
    tangents ``dots``: the lifted jvp of the initial carry, of each loop
    body and of the polish. ``slots`` (`lifting`) take the last
    ``len(slots)`` inputs as their values: they ride in the carry as
    ``param_i`` with their tangents, bound while the body runs. With
    ``batched``, every tangent holds K tangents on a leading axis. The
    trajectory buffers of ``n_save`` are float entries of the carry, so
    their tangents ride along, scattered at the primal's slots. Returns
    the pair (`IntegrationResult`, its tangent)."""
    pkeys = _param_keys(slots)
    n_in = len(inputs) - len(slots)

    def init(*args):
        with bound(slots, args[n_in:]):
            y = make_y0(*args[:n_in])
            cf, lam0 = _init_carry(p, y, lam_span)
        floats = {k: v for k, v in cf.items() if v.is_floating_point()}
        floats.update(zip(pkeys, args[n_in:]))
        return (floats, y), ({k: v for k, v in cf.items() if k not in floats}, lam0)

    # a dual may not be a broadcast view
    inputs = tuple(t.contiguous() for t in inputs)
    dots = tuple(t.contiguous() for t in dots)
    if batched:
        out, out_dot, (rest, lam0) = torch.func.vmap(
            lambda *d: jvp(init, inputs, d, has_aux=True), out_dims=(None, 0, None)
        )(*dots)
    else:
        out, out_dot, (rest, lam0) = jvp(init, inputs, dots, has_aux=True)
    (fl, y0), (fl_dot, y0_dot) = out, out_dot
    keys = list(fl)
    cf = {**fl, **{_DOT + k: v for k, v in fl_dot.items()}, **rest}
    step = _with_params(body, slots) if slots else body
    cf = _run_loop(_tangent_step(step, keys, batched), cf, p.max_steps)
    fl = {k: cf[k].contiguous() for k in keys}
    fl_dot = {k: cf[_DOT + k].contiguous() for k in keys}
    rest = {k: v for k, v in cf.items() if k not in fl and not k.startswith(_DOT)}
    if polish:

        def polished(c):
            with bound(slots, [c[k] for k in pkeys]):
                return _polish_carry_hits(p, {**c, **rest}, c["y"], c["lam"]), {}

        (y_f, lam_f), (y_dot, lam_dot), _ = _jvp_maybe_batched(polished, fl, fl_dot, batched)
    else:
        y_f, lam_f, y_dot, lam_dot = fl["y"], fl["lam"], fl_dot["y"], fl_dot["lam"]

    ints = dict(status=rest["status"], steps=rest["steps"], failed=rest["failed"])
    return (
        IntegrationResult(
            y=y_f, lam=lam_f, y0=y0, lam0=lam0, traj=fl.get("traj"), traj_lam=fl.get("traj_lam"), **ints
        ),
        IntegrationResult(
            y=y_dot,
            lam=lam_dot,
            y0=y0_dot,
            lam0=torch.zeros_like(lam_dot),
            traj=fl_dot.get("traj"),
            traj_lam=fl_dot.get("traj_lam"),
            **ints,
        ),
    )


def integrate_rays_lifted(f, make_y0, inputs, dots, lam_span, *, slots=(), batched=False, **kw):
    """`integrate_rays` from ``y0 = make_y0(*inputs)`` with the tangent
    along ``dots`` carried explicitly, ``slots`` (`lifting`) holding the
    last ``len(slots)`` inputs: the forward-mode derivative with respect
    to the metric's and geometry's parameters whose loop, on a CUDA tensor,
    replays one captured body (`tracing.trace_geodesics` under a
    `torch.func` transform). ``kw``: the keywords of `integrate_rays`.
    Returns the pair (`IntegrationResult`, its tangent); with ``batched``
    the tangents hold K tangents on a leading axis, all carried through one
    pass."""
    p = _Problem(f=f, **kw)
    body = _make_body(p, inputs[0].dtype, inputs[0].device)
    polish = p.crossing_fn is not None and p.terminate_on_hit
    return _integrate_lifted(p, body, make_y0, inputs, dots, lam_span, polish, slots, batched)


def integrate_rays_checkpointed(
    f: Callable,
    y0,
    lam_span,
    *,
    abstol: float,
    reltol: float,
    r_inner,
    r_outer,
    crossing_fn: Callable | None = None,
    hit_fn: Callable | None = None,
    terminate_fns: tuple = (),
    n_segments: int = 64,
    seg_steps: int = 32,
    n_interp: int = 8,
    dt_min: float = 1e-10,
    bisect_iters: int = 10,
    newton_iters: int = 3,
    terminate_on_hit: bool = True,
    event_method: str = "cubic",
    slots: tuple = (),
) -> IntegrationResult:
    """Reverse-differentiable variant of `integrate_rays` (counterpart of
    the reference's `integrate_rays_checkpointed`).

    The adaptive loop becomes a bounded ladder of ``n_segments`` segments of
    ``seg_steps`` loop bodies: reverse mode stores one carry a segment and
    recomputes the bodies inside a segment during the backward sweep. A
    segment in which no ray is alive is skipped (a host read between
    segments). The body, the events and the Newton hit-polish are those of
    `integrate_rays`, so the primals match it whenever ``n_segments ·
    seg_steps`` covers the trajectory. The right-hand side is evaluated at
    r clamped to 0.995 · ``r_inner`` and θ clipped to [1e-6, π − 1e-6], the
    reference's reverse-mode NaN guard (states the integrator would end
    anyway, and rays within 1e-6 rad of the pole, whose primal then
    deviates at the clamp scale, as the reference's does).

    On a CPU tensor (or within `cuda_graphs(False)`) each segment is a
    `torch.utils.checkpoint` of its bodies. On a CUDA tensor the forward
    replays one captured body and keeps the carry at each segment start;
    the backward recomputes a segment's carries by replaying it, then
    replays one captured graph of one body's vjp backwards over them,
    adding the gradients of ``slots`` (`lifting`: the metric's and
    geometry's tensors, which the body reads; `tracing.trace_geodesics`
    passes them) and of the guard's floor (so of an ``r_inner`` that
    requires grad, the metric's inner radius) into static buffers. A
    tensor that requires grad and that ``f``, ``crossing_fn``, ``hit_fn``
    or ``terminate_fns`` close over outside the slots raises there: its
    gradient would be lost.
    """
    # the floor is read from a slot, so that the captured ladder lifts it:
    # an r_inner that requires grad (a metric parameter's) gets its gradient
    floor = SimpleNamespace(r=torch.as_tensor(r_inner, dtype=y0.dtype, device=y0.device) * 0.995)
    th_eps = 1e-6

    def f_safe(y):
        r_s = torch.maximum(y[..., 1], floor.r)
        th_s = torch.clamp(y[..., 2], th_eps, torch.pi - th_eps)
        return f(torch.cat([y[..., :1], r_s[..., None], th_s[..., None], y[..., 3:]], dim=-1))

    kw = dict(
        abstol=abstol, reltol=reltol, r_inner=r_inner, r_outer=r_outer, crossing_fn=crossing_fn,
        hit_fn=hit_fn, terminate_fns=terminate_fns, max_steps=n_segments * seg_steps, n_interp=n_interp,
        dt_min=dt_min, bisect_iters=bisect_iters, newton_iters=newton_iters,
        terminate_on_hit=terminate_on_hit, event_method=event_method,
    )  # fmt: skip
    p = _Problem(f=f_safe, **kw)
    cf, lam0 = _init_carry(p, y0, lam_span)
    body = _make_body(p, y0.dtype, y0.device)
    if _graphed(cf):
        # the body only compares r with r_inner: its gradient is the floor's
        roots = dict(f=f, crossing_fn=crossing_fn, hit_fn=hit_fn, terminate_fns=terminate_fns)
        cf = _captured_ladder(body, cf, n_segments, seg_steps, (*slots, (floor, "r")), roots)
    else:
        cf = _checkpointed_ladder(body, cf, n_segments, seg_steps)

    y_f, lam_f = cf["y"], cf["lam"]
    if crossing_fn is not None and terminate_on_hit:
        y_f, lam_f = _polish_carry_hits(p, cf, y_f, lam_f)
    return IntegrationResult(
        y=y_f, lam=lam_f, y0=y0, lam0=lam0, status=cf["status"], steps=cf["steps"], failed=cf["failed"]
    )


def _checkpointed_ladder(body, cf: dict, n_segments: int, seg_steps: int):
    """The segment ladder uncaptured: each segment a non-reentrant
    `torch.utils.checkpoint` of its ``seg_steps`` bodies while autograd
    records, the bodies themselves when it does not."""

    def segment(c):
        for _ in range(seg_steps):
            c = body(c)
        return c

    _tell("loop", tangent=False, graphed=False)
    iters = 0
    for _ in range(n_segments):
        if not bool(cf["alive"].any()):
            break
        _tell("block", iterations=iters)
        if torch.is_grad_enabled():
            cf = torch.utils.checkpoint.checkpoint(segment, cf, use_reentrant=False)
        else:
            cf = segment(cf)
        iters += seg_steps
    _tell("end", iterations=iters)
    return cf


def _captured_ladder(body, cf: dict, n_segments: int, seg_steps: int, slots, roots: dict):
    """The segment ladder on a CUDA tensor: `_CapturedLadder` over the
    carry's float entries and the float tensors of ``slots``."""
    slots = [s for s, t in zip(slots, slot_values(slots)) if t.is_floating_point()]
    params = slot_values(slots)
    leak = find_unlifted(roots, params, lambda t: t.requires_grad)
    if leak is not None:
        raise RuntimeError(
            f"{leak} requires grad but is not among the tensors the captured checkpointed backward "
            "lifts (the metric's and the geometry's buffers and tensor fields): its gradient would "
            "be lost. Hold it in a buffer or tensor field of the metric or the geometry, or run "
            "within cuda_graphs(False)"
        )
    ladder = _Ladder(body, cf, n_segments, seg_steps, slots)
    out = _CapturedLadder.apply(ladder, *(cf[k] for k in ladder.keys), *params)
    n = len(ladder.keys)
    return {**dict(zip(ladder.keys, out[:n])), **dict(zip(ladder.int_keys, out[n:]))}


class _Ladder:
    """The state of one captured segment ladder: the primal body's graph,
    its static carry, the carries at the segment starts, and (made at the
    first backward) the graph of one body's vjp."""

    def __init__(self, body, cf, n_segments, seg_steps, slots):
        self.keys = [k for k, v in cf.items() if v.is_floating_point()]
        self.int_keys = [k for k in cf if k not in self.keys]
        self.ints = {k: cf[k] for k in self.int_keys}
        self.n_segments, self.seg_steps = n_segments, seg_steps
        self.slots, self.pkeys = slots, _param_keys(slots)
        self.step = _with_params(body, slots)
        self.starts = []

    def forward(self, floats):
        n = len(self.keys)
        static = {k: v.detach().clone(memory_format=torch.contiguous_format) for k, v in zip(self.keys, floats)}
        static.update({k: v.clone(memory_format=torch.contiguous_format) for k, v in self.ints.items()})
        static.update({k: v.detach().clone() for k, v in zip(self.pkeys, floats[n:])})
        self.static, self.graph = static, None
        _tell("loop", tangent=False, graphed=True)
        iters = 0
        for _ in range(self.n_segments):
            if not bool(static["alive"].any()):
                break
            _tell("block", iterations=iters)
            if self.graph is None:
                self.graph = _capture(self.step, static)
            self.starts.append({k: v.clone() for k, v in static.items()})
            for _ in range(self.seg_steps):
                self.graph.replay()
            iters += self.seg_steps
        _tell("end", iterations=iters)
        return tuple(static[k].clone() for k in self.keys) + tuple(static[k].clone() for k in self.int_keys)

    def _capture_vjp(self):
        """A CUDA graph of one body's vjp: from the carry ``vin`` and the
        cotangent of the body's float outputs ``vct``, it writes the
        cotangent of its float inputs into ``vct`` and adds the slots'
        gradients into ``grads``."""
        dev = self.static["alive"].device
        self.vin = {k: v.clone() for k, v in self.static.items()}
        self.vct = {k: torch.zeros_like(self.static[k]) for k in self.keys}
        self.grads = [torch.zeros_like(self.static[k]) for k in self.pkeys]
        ints = {k: self.vin[k] for k in self.int_keys}

        def vjp_step():
            def fun(fl, pr):
                out = self.step({**fl, **ints, **dict(zip(self.pkeys, pr))})
                return {k: out[k] for k in self.keys}

            fl = {k: self.vin[k] for k in self.keys}
            _, vjp_fn = torch.func.vjp(fun, fl, [self.vin[k] for k in self.pkeys])
            return vjp_fn({k: self.vct[k] for k in self.keys})

        def work():
            ct_fl, ct_p = vjp_step()
            for k in self.keys:
                self.vct[k].copy_(ct_fl[k])
            for g, c in zip(self.grads, ct_p):
                g.add_(c)

        return _graph_of(vjp_step, work, dev, backward=True)

    def backward(self, cts):
        ct = [torch.zeros_like(self.static[k]) if c is None else c for k, c in zip(self.keys, cts)]
        if not self.starts:
            return (*ct, *(torch.zeros_like(self.static[k]) for k in self.pkeys))
        vgraph = self._capture_vjp()
        for k, c in zip(self.keys, ct):
            self.vct[k].copy_(c)
        _tell("loop", tangent=False, graphed=True, backward=True)
        for start in reversed(self.starts):
            # the segment's carries, recomputed by the primal graph
            for k, v in start.items():
                self.static[k].copy_(v)
            carries = [start]
            for _ in range(self.seg_steps - 1):
                self.graph.replay()
                carries.append({k: v.clone() for k, v in self.static.items()})
            for c in reversed(carries):
                for k, v in c.items():
                    self.vin[k].copy_(v)
                vgraph.replay()
        _tell("end", iterations=len(self.starts) * self.seg_steps, backward=True)
        return (*(self.vct[k].clone() for k in self.keys), *(g.clone() for g in self.grads))


class _CapturedLadder(torch.autograd.Function):
    """The captured segment ladder (`_Ladder`) as an autograd node: inputs
    the carry's float entries and the slots' tensors, outputs the final
    carry's float and then integer entries."""

    @staticmethod
    def forward(ladder, *tensors):
        return ladder.forward(tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ladder = inputs[0]
        ctx.mark_non_differentiable(*output[len(ctx.ladder.keys) :])

    @staticmethod
    def backward(ctx, *cts):
        return (None, *ctx.ladder.backward(cts[: len(ctx.ladder.keys)]))
