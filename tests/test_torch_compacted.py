"""The port's `CompactedIntegrator` (the lockstep loop in segments, the
rays still alive gathered into a narrower working set between them) and
the `Tracer` route over it, in f64 on the CPU.

Against the JAX package's `CompactedIntegrator` on the same initial states
(256 Kerr a = 0.998 rays, r = 100, i = 75°, ThinDisc(0, 20), λ ≤ 300,
``min_bucket=16``, ``segment_iters=32``: three widths): the progress
events, ``last_stats``, statuses, accepted steps and failures identical,
and the endpoints that do not depend on the step sequence (polished hits,
rays that reach λ1) at tests/test_torch_trace_geodesics.py's atol. The
reference's segments are compiled without FMA contraction, as that file
compiles its `integrate_rays` (`_NO_FMA`).

Against the port's own `integrate_rays` on the same rays, bit for bit:
cubic and sampled events, a `MeshAccretionGeometry`'s chord test,
``terminate_fns``, the crossing counter, a charged right-hand side and a
``max_steps`` cut; and the replay path of the card (one static carry and
one captured body a width, none captured again on a second call) with a
stand-in for the captured graph. Then the `Tracer`'s lockstep route
against the JAX `Tracer`, and the refusal of a batch that is not (N, S).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geodesics.equation import constrain_all as jax_constrain_all  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate import Tracer as JaxTracer  # noqa: E402
from gradus_tpu.integrate.solver import CompactedIntegrator as JaxCompactedIntegrator  # noqa: E402
from gradus_tpu.integrate.tracing import make_geodesic_rhs as jax_rhs  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

import gradus_tpu_torch.integrate.solver as solver  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geodesics.equation import constrain_all  # noqa: E402
from gradus_tpu_torch.geometry import MeshAccretionGeometry, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import (  # noqa: E402
    CompactedIntegrator,
    StatusCodes,
    TraceGeodesic,
    Tracer,
    domain_upper_hemisphere,
    integrate_rays,
    make_geodesic_rhs,
)
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric, KerrNewmanMetric  # noqa: E402

HIT = StatusCodes.IntersectedWithGeometry
SPAN = (0.0, 300.0)
X_OBS = [0.0, 100.0, math.radians(75.0), 0.0]
TOLS = dict(abstol=1e-9, reltol=1e-9)
# tests/test_torch_trace_geodesics.py's reference compilation: XLA's CPU
# backend otherwise contracts a·b + c into fused multiply-adds, which
# changes the step sequence of some rays
_NO_FMA = {"xla_backend_optimization_level": 0}


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _no_fma(jitted):
    """``jitted`` compiled without FMA contraction, once a signature."""
    compiled = {}

    def call(*args):
        key = tuple((np.shape(a), str(getattr(a, "dtype", type(a)))) for a in jax.tree_util.tree_leaves(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(_NO_FMA)
        return compiled[key](*args)

    return call


def _jax_rays(n, seed, a=0.998, x_obs=X_OBS, lims=15.0):
    """``n`` rays at α, β ~ U(-lims, lims), constrained in the JAX package:
    (the reference's metric, its (n, 8) initial states as numpy)."""
    jm = JaxKerr(M=1.0, a=a)
    x = jnp.asarray(x_obs)
    A, B = np.random.default_rng(seed).uniform(-lims, lims, (2, n))
    v = jax_map_impact(jm, x, jnp.asarray(A), jnp.asarray(B))
    xs = jnp.broadcast_to(x, v.shape)
    return jm, np.asarray(jnp.concatenate([xs, jax_constrain_all(jm, xs, v)], axis=-1))


def _disc_events(d):
    return dict(
        crossing_fn=lambda y: d.crossing_indicator(y[..., 0:4]), hit_fn=lambda y: d.is_hit(y[..., 0:4], gtol=1e-2)
    )


def test_compacted_integrator_matches_jax():
    """256 rays, three widths (256, 64, 16): events, stats, statuses,
    steps and failures identical to the JAX package's; polished hits and
    rays that reach λ1 within atol 1e-9 (measured 3.1e-11)."""
    jm, y0 = _jax_rays(256, 0)
    jd = JaxThinDisc(0.0, 20.0)
    tm = from_numpy("KerrMetric", _params(jm), device="cpu")
    td = from_numpy("ThinDisc", _params(jd), device="cpu")
    kw = dict(TOLS, r_outer=12000.0, min_bucket=16, segment_iters=32)
    ev_j, ev_t = [], []
    cj = JaxCompactedIntegrator(
        jax_rhs(jm), r_inner=jm.inner_radius() * 1.01, progress=ev_j.append, **_disc_events(jd), **kw
    )
    for name in ("_init", "_segment", "_finalize"):
        setattr(cj, name, _no_fma(getattr(cj, name)))
    rj = cj(jnp.asarray(y0), SPAN)
    ct = CompactedIntegrator(
        make_geodesic_rhs(tm), r_inner=tm.inner_radius() * 1.01, progress=ev_t.append, **_disc_events(td), **kw
    )
    rt = ct(torch.as_tensor(y0), SPAN)

    assert ev_t == ev_j
    assert ct.last_stats == [tuple(int(v) for v in s) for s in cj.last_stats]
    assert sorted({w for w, _, _ in ct.last_stats}) == [16, 64, 256]
    sj = np.asarray(rj.status)
    for name in ("status", "steps", "failed"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)))
    assert torch.equal(ct.last_steps, rt.steps)
    lj = np.asarray(rj.lam)
    keep = (sj == HIT) | ((sj == StatusCodes.NoStatus) & (lj >= SPAN[1] - 1e-9))
    assert (sj == HIT).sum() >= 100 and keep.sum() >= 200
    np.testing.assert_allclose(rt.y.numpy()[keep], np.asarray(rj.y)[keep], rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.lam.numpy()[keep], lj[keep], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(rt.y0.numpy(), y0)


def _port_rays(n, seed, m):
    x = torch.tensor(X_OBS, dtype=torch.float64)
    A, B = (torch.as_tensor(t) for t in np.random.default_rng(seed).uniform(-15.0, 15.0, (2, n)))
    v = map_impact_parameters(m, x, A, B)
    xs = x.expand_as(v)
    return torch.cat([xs, constrain_all(m, xs, v)], dim=-1)


def _annulus(n_phi=12, r_in=4.0, r_out=20.0):
    """A triangulated annulus in the equatorial plane, each triangle facing
    up and once more down (the chord test is one-sided), as a
    `MeshAccretionGeometry` with its bounding box widened by 10 and
    ``proximity2`` its largest triangle's size plus 10, squared."""
    phi = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    inner, outer = (np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros_like(phi)], -1) for r in (r_in, r_out))
    k = np.arange(n_phi)
    up = np.concatenate(
        [np.stack([inner[k], outer[k], outer[k + 1]], 1), np.stack([inner[k], outer[k + 1], inner[k + 1]], 1)]
    )
    normal_z = np.cross(up[:, 0] - up[:, 2], up[:, 1] - up[:, 2])[:, 2]
    up = np.where((normal_z > 0)[:, None, None], up, up[:, [1, 0, 2]])
    tri = np.concatenate([up, up[:, [1, 0, 2]]])
    size = max(np.linalg.norm(tri[:, i] - tri[:, j], axis=-1).max() for i, j in ((0, 1), (0, 2), (1, 2)))
    flat = tri.reshape(-1, 3)
    return MeshAccretionGeometry(
        tri, flat.min(0) - 10.0, flat.max(0) + 10.0, (size + 10.0) ** 2, device="cpu"
    )


def _case(name):
    """(right-hand side, initial states, the solver's keywords) of a case."""
    m = KerrMetric(1.0, 0.998, device="cpu")
    y0 = _port_rays(128, 1, m)
    kw = dict(TOLS, r_inner=m.inner_radius() * 1.01, r_outer=12000.0)
    f = make_geodesic_rhs(m)
    disc = _disc_events(ThinDisc(0.0, 20.0, device="cpu"))
    if name == "cubic":
        kw.update(disc)
    elif name == "sampled":
        kw.update(disc, event_method="sampled")
    elif name == "mesh":
        kw["segment_fn"] = _annulus().segment_hit
    elif name == "terminate_fns":
        kw.update(disc, terminate_fns=(domain_upper_hemisphere(),))
    elif name == "crossing_counter":
        f8 = f
        f = lambda y: torch.cat([f8(y[..., :8]), torch.zeros_like(y[..., 8:])], dim=-1)  # noqa: E731
        y0 = torch.cat([y0, torch.zeros_like(y0[:, :1])], dim=-1)
        kw.update(disc, terminate_on_hit=False)
    elif name == "charged":
        m = KerrNewmanMetric(1.0, 0.5, 0.3, device="cpu")
        y0 = _port_rays(64, 1, m)
        kw.update(disc, r_inner=m.inner_radius() * 1.01)
        f = make_geodesic_rhs(m, TraceGeodesic(q=0.1))
    elif name == "max_steps":
        kw.update(disc, max_steps=37)
    return f, y0, kw


CASES = ("cubic", "sampled", "mesh", "terminate_fns", "crossing_counter", "charged", "max_steps")


@pytest.mark.parametrize("name", CASES)
def test_compacted_integrator_matches_integrate_rays(name):
    """128 rays (64 charged), ``min_bucket=16``: every field of the result
    equal to `integrate_rays`'s bit for bit, the working set compacted at
    least once. (On the CPU torch runs the tail of an array that is not a
    multiple of 16 doubles through scalar functions, libm's where the
    vector loop runs SLEEF's, so a ray's bits there hang on its position:
    widths of 16 · 4^k rays keep every ray in the vector loop.)"""
    f, y0, kw = _case(name)
    want = integrate_rays(f, y0, SPAN, **kw)
    events = []
    ci = CompactedIntegrator(f, min_bucket=16, segment_iters=32, progress=events.append, **kw)
    got = ci(y0, SPAN)
    for field in ("y", "lam", "y0", "lam0", "status", "steps", "failed"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.traj is None and got.traj_lam is None
    widths = [w for w, _, _ in ci.last_stats]
    assert widths[0] == len(y0) and widths == sorted(widths, reverse=True)
    assert widths[-1] < len(y0) or name == "max_steps"
    assert [e["width"] for e in events] == widths and [e["segment"] for e in events] == list(range(1, len(widths) + 1))
    executed = np.cumsum([it for _, it, _ in ci.last_stats]).tolist()
    assert [e["executed_iters"] for e in events] == executed
    if name == "max_steps":
        assert executed[-1] == 37 and events[-1]["alive"] > 0
    else:
        assert events[-1]["alive"] == 0
    if name == "crossing_counter":
        assert (got.y[:, 8] >= 2).any() and not (got.status == HIT).any()
    elif name in ("mesh", "cubic", "sampled", "charged"):
        assert (got.status == HIT).sum() >= 20
    elif name == "terminate_fns":
        assert (got.status == StatusCodes.OutOfDomain).sum() >= 5


class _Replayed:
    """A stand-in for a captured body on the CPU: replay runs the body and
    writes the carry back into the static buffers."""

    captures = []

    def __init__(self, step, static, **info):
        _Replayed.captures.append(info["width"])
        self.step, self.static = step, static

    def replay(self):
        c = self.step(self.static)
        for k, buf in self.static.items():
            buf.copy_(c[k])


def test_replay_path_captures_one_body_a_width(monkeypatch):
    """The card's path with a stand-in graph: bit for bit the uncaptured
    integrator's result, one capture a width reported to the observers,
    none on a second call of the same size, the "end" event counting every
    replay."""
    f, y0, kw = _case("cubic")
    want = CompactedIntegrator(f, min_bucket=16, segment_iters=32, **kw)(y0, SPAN)
    monkeypatch.setattr(solver, "_graphed", lambda cf: True)
    monkeypatch.setattr(solver, "_capture", _Replayed)
    monkeypatch.setattr(_Replayed, "captures", [])
    ci = CompactedIntegrator(f, min_bucket=16, segment_iters=32, **kw)
    for call in range(2):
        events = []
        with solver.observe_loops(lambda e, **i: events.append((e, i))):
            got = ci(y0, SPAN)
        for field in ("y", "lam", "status", "steps", "failed"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        widths = sorted({w for w, _, _ in ci.last_stats}, reverse=True)
        assert _Replayed.captures == widths and len(widths) >= 2
        assert events[0] == ("loop", dict(tangent=False, graphed=True))
        (end,) = [i for e, i in events if e == "end"]
        assert end["alive"] == 0 and end["iterations"] >= sum(it for _, it, _ in ci.last_stats)


def test_tracer_lockstep_route_matches_jax_tracer():
    """`Tracer` on CPU tensors (its `CompactedIntegrator` route) against the
    JAX package's `Tracer`: tests/test_plotting_progress.py's case (8 rays,
    one width) and one that compacts (256 rays, ``min_bucket=16``), both
    packages constraining the same unconstrained velocities: identical
    progress events and statuses; hits and rays that reach λ1 within 1e-9."""
    x_obs = [0.0, 100.0, math.radians(80.0), 0.0]
    al = np.linspace(-10.0, 10.0, 8) + 1e-3
    be = np.zeros(8) + 1e-3
    A, B = np.random.default_rng(7).uniform(-15.0, 15.0, (2, 256))
    for a, alpha, beta, bucket, seg in ((0.5, al, be, 64, 64), (0.998, A, B, 16, 32)):
        jm, jd = JaxKerr(M=1.0, a=a), JaxThinDisc(0.0, 20.0)
        xj = jnp.asarray(x_obs)
        vj = np.asarray(jax_map_impact(jm, xj, jnp.asarray(alpha), jnp.asarray(beta)))
        ev_j, ev_t = [], []
        tj = JaxTracer(jm, geometry=jd, min_bucket=bucket, segment_iters=seg, progress=ev_j.append)
        tj._constrain = _no_fma(tj._constrain)
        for name in ("_init", "_segment", "_finalize"):
            setattr(tj._integ, name, _no_fma(getattr(tj._integ, name)))
        gj = tj(jnp.broadcast_to(xj, vj.shape), jnp.asarray(vj), SPAN)
        tm = from_numpy("KerrMetric", _params(jm), device="cpu")
        td = from_numpy("ThinDisc", _params(jd), device="cpu")
        tt = Tracer(tm, geometry=td, min_bucket=bucket, segment_iters=seg, progress=ev_t.append)
        x = torch.tensor(x_obs, dtype=torch.float64)
        gt = tt(x.expand(len(vj), 4), torch.as_tensor(vj), SPAN)

        assert ev_t == ev_j and ev_t[-1]["alive"] == 0
        sj = np.asarray(gj.status)
        np.testing.assert_array_equal(gt.status.numpy(), sj)
        lj = np.asarray(gj.lam_max)
        keep = (sj == HIT) | ((sj == StatusCodes.NoStatus) & (lj >= SPAN[1] - 1e-9))
        assert keep.sum() >= len(sj) // 2
        for name in ("x", "v", "lam_max"):
            np.testing.assert_allclose(
                getattr(gt, name).numpy()[keep], np.asarray(getattr(gj, name))[keep], rtol=0, atol=1e-9
            )
    assert len({e["width"] for e in ev_t}) >= 3


@pytest.mark.parametrize("shape", [(8,), (2, 4, 8)])
def test_compacted_integrator_refuses_a_batch_that_is_not_2d(shape):
    m = KerrMetric(1.0, 0.5, device="cpu")
    ci = CompactedIntegrator(make_geodesic_rhs(m), **TOLS, r_inner=2.0, r_outer=100.0)
    with pytest.raises(ValueError, match=r"\(N, S\) batch"):
        ci(torch.zeros(shape, dtype=torch.float64), SPAN)
