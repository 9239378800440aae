"""Batched adaptive geodesic integration with event detection: the lockstep
solver `integrate_rays` (counterpart of `gradus_tpu/integrate/solver.py`).

The whole ray batch advances in lockstep; each ray carries its own (dt,
error, status, alive) state, and every iteration is a fixed sequence of
masked array operations over the batch. On a CUDA tensor those operations
run on the card: this is plain torch, not the CUDA integrator kernel
(`integrate/cuda_solver.py`), which it does not call. Events:

- chart bounds at step end: r ≤ r_inner → WithinInnerBoundary,
  r > r_outer → OutOfDomain;
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
uncaptured: pass the tangent as ``y0_dot`` (`trace_geodesics(..., v_dot=...)`).

Also here: the PI controller constants, the result record, and the Newton
polish of the integrator kernel's hits in its output layout (`_polish_hits`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from gradus_tpu_torch.integrate.events import cubic_first_crossing
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tsit5 import hermite_interp, initial_dt, tsit5_step
from gradus_tpu_torch.utils.jvp import jvp

__all__ = ["integrate_rays", "IntegrationResult", "cuda_graphs", "observe_loops"]

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
    (``iterations``: those the loop has run so far), and ``"capture"`` once
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
        r_new = y_new[..., 1]
        inner = accept & ~hit_now & (r_new <= p.r_inner)
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


def _tangent_step(body, float_keys):
    """One iteration of the explicit-tangent loop: the lifted jvp of
    ``body`` over a carry holding each float entry ``k`` and its tangent
    ``dot_k``; the integer and boolean entries ride along."""

    def step(c):
        rest = {k: v for k, v in c.items() if k not in float_keys and not k.startswith(_DOT)}

        def f(primal):
            out = body({**primal, **rest})
            return {k: out[k] for k in float_keys}, {k: out[k] for k in rest}

        # a dual may not be a broadcast view
        primals = {k: c[k].contiguous() for k in float_keys}
        tangents = {k: c[_DOT + k].contiguous() for k in float_keys}
        out, out_dot, aux = jvp(f, (primals,), (tangents,), has_aux=True)
        return {**out, **{_DOT + k: v for k, v in out_dot.items()}, **aux}

    return step


def _capture(step, static: dict):
    """A CUDA graph of one iteration of ``step`` from the carry ``static``,
    ending with the new carry copied into ``static``."""
    t0 = time.perf_counter()
    reserved0 = torch.cuda.memory_reserved(static["alive"].device)
    # warm-up on a side stream (lazy initialisation stays out of the
    # capture); the body is out of place, so no buffer changes
    side = torch.cuda.Stream(static["alive"].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = step(static)
        for k, buf in static.items():
            buf.copy_(c[k])
    del c
    _tell(
        "capture",
        seconds=time.perf_counter() - t0,
        reserved_bytes=torch.cuda.memory_reserved(static["alive"].device) - reserved0,
    )
    return graph


def _graphed(cf: dict) -> bool:
    """Whether the loop over carry ``cf`` replays a CUDA graph."""
    return cf["alive"].device.type == "cuda" and _CUDA_GRAPHS


def _run_loop(step, cf: dict, max_steps: int):
    """The reference's ``while any(alive) & iters < max_steps``, with the
    any() read every _ALIVE_CHECK_EVERY iterations; on a CUDA tensor, unless
    within `cuda_graphs(False)`, each iteration is a replay of the captured
    body."""
    graphed = _graphed(cf)
    if graphed and any(_is_wrapped(v) for v in cf.values()):
        raise RuntimeError(
            "the lockstep loop on a CUDA tensor replays a CUDA graph, which cannot be captured "
            "under a torch.func transform: pass the tangent explicitly (integrate_rays(..., "
            "y0_dot=...), trace_geodesics(..., v_dot=...)), or run uncaptured within cuda_graphs(False)"
        )
    if graphed:
        # static buffers: the graph reads the carry from them and writes it back
        cf = {k: v.clone(memory_format=torch.contiguous_format) for k, v in cf.items()}
    _tell("loop", tangent=any(k.startswith(_DOT) for k in cf), graphed=graphed)
    graph = None
    iters = 0
    while iters < max_steps and bool(cf["alive"].any()):
        _tell("block", iterations=iters)
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
    _tell("end", iterations=iters)
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
    r_inner, r_outer : chart bounds (scalars). A θ-dependent ``PoloidalShape``
        inner bound is not ported yet.
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
    if getattr(r_inner, "rs", None) is not None:
        raise NotImplementedError(
            "a PoloidalShape inner chart bound is not ported yet (ROADMAP queue A, item 11)"
        )
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
        return _integrate_with_tangent(p, body, y0, y0_dot, lam_span, polish)
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


def _integrate_with_tangent(p: _Problem, body, y0, y0_dot, lam_span, polish: bool):
    """`integrate_rays` with the tangent of ``y0`` carried explicitly: the
    lifted jvp of the initial carry, of each loop body and of the polish.
    The trajectory buffers of ``n_save`` are float entries of the carry, so
    their tangents ride along, scattered at the primal's slots."""

    def init(y):
        cf, lam0 = _init_carry(p, y, lam_span)
        floats = {k: v for k, v in cf.items() if v.is_floating_point()}
        return floats, ({k: v for k, v in cf.items() if k not in floats}, lam0)

    # a dual may not be a broadcast view
    fl, fl_dot, (rest, lam0) = jvp(init, (y0.contiguous(),), (y0_dot.contiguous(),), has_aux=True)
    keys = list(fl)
    cf = {**fl, **{_DOT + k: v for k, v in fl_dot.items()}, **rest}
    cf = _run_loop(_tangent_step(body, keys), cf, p.max_steps)
    fl = {k: cf[k].contiguous() for k in keys}
    fl_dot = {k: cf[_DOT + k].contiguous() for k in keys}
    rest = {k: v for k, v in cf.items() if k not in fl and not k.startswith(_DOT)}
    if polish:
        (y_f, lam_f), (y_dot, lam_dot) = jvp(
            lambda c: _polish_carry_hits(p, {**c, **rest}, c["y"], c["lam"]), (fl,), (fl_dot,)
        )
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
            lam0=torch.zeros_like(lam0),
            traj=fl_dot.get("traj"),
            traj_lam=fl_dot.get("traj_lam"),
            **ints,
        ),
    )
