"""Parity of the port's lockstep solver `integrate_rays` and of
`trace_geodesics` with the JAX reference's, in f64 on the CPU.

`integrate_rays` is held to the reference's branch by branch on the same
Schwarzschild rays (observer at r = 100, i = 75°, λ ≤ 300): no geometry,
cubic and sampled disc events, a `segment_fn` chord test, user
`terminate_fns`, crossing counters (``terminate_on_hit=False``, 9-slot
state), ``n_save`` trajectories and a ``max_steps`` cut; then
`trace_geodesics` at the flagship camera (Kerr a = 0.998, r = 1000, i = 75°,
ThinDisc(0, 50), λ ≤ 2200).

Two implementations take slightly different step sequences: early in a
ray's flight the embedded error estimate is roundoff (see the docstring of
tests/test_torch_integrate.py). So the observables compared are those that
do not depend on the step sequence: statuses and ``failed`` (equal),
accepted steps (equal on ≥ 95% of rays), polished hits and the endpoints of
rays that reach λ1 (atol 1e-5 required; the tightest bound measured is
stated beside each assertion).
"""

import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geodesics.equation import constrain_all as jax_constrain_all  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.solver import integrate_rays as jax_integrate_rays  # noqa: E402
from gradus_tpu.integrate.tracing import domain_upper_hemisphere as jax_upper  # noqa: E402
from gradus_tpu.integrate.tracing import make_geodesic_rhs as jax_rhs  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics as jax_trace  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

import gradus_tpu_torch.integrate.solver as solver  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.corona import LampPostModel  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import (  # noqa: E402
    StatusCodes,
    domain_upper_hemisphere,
    integrate_rays,
    make_geodesic_rhs,
    trace_geodesics,
    tracegeodesics,
)
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

HIT = StatusCodes.IntersectedWithGeometry
SPAN = (0.0, 300.0)
N = 128
CHART = dict(r_inner=2.02, r_outer=12000.0)
TOLS = dict(abstol=1e-9, reltol=1e-9)
# XLA's CPU backend contracts a·b + c into fused multiply-adds, which rounds
# the error estimate's near-total cancellation otherwise than the arithmetic
# as written: 6-12% of these rays then take one step more or fewer than
# the port's (measured). The reference is compiled with its LLVM passes at
# level 0, which keeps the arithmetic as written.
_NO_FMA = {"xla_backend_optimization_level": 0}


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def rays():
    """N Schwarzschild rays from r = 100, i = 75°, α, β ~ U(-20, 20): disc
    hits, captures and escapes; constrained in the JAX package."""
    jm = JaxKerr(M=1.0, a=0.0)
    x_obs = jnp.asarray([0.0, 100.0, math.radians(75.0), 0.0])
    rng = np.random.default_rng(5)
    A, B = rng.uniform(-20.0, 20.0, (2, N))
    v = jax_map_impact(jm, x_obs, jnp.asarray(A), jnp.asarray(B))
    xs = jnp.broadcast_to(x_obs, v.shape)
    y0 = np.asarray(jnp.concatenate([xs, jax_constrain_all(jm, xs, v)], axis=-1))
    jd = JaxThinDisc(0.0, 50.0)
    return dict(
        jm=jm,
        jd=jd,
        tm=from_numpy("KerrMetric", _params(jm), device="cpu"),
        td=from_numpy("ThinDisc", _params(jd), device="cpu"),
        y0=y0,
    )


def _segment_hit(zf):
    """A chord test for both packages: the chord's ends straddle the
    equatorial plane downward, inside r < 30."""

    def seg(xa, xb):
        za, zb = xa[..., 1] * zf.cos(xa[..., 2]), xb[..., 1] * zf.cos(xb[..., 2])
        return (za > 0) & (zb <= 0) & (xb[..., 1] < 30.0)

    return seg


def _nine(f, cat):
    """The 8-slot geodesic RHS with a 9th slot, the crossing counter, held."""
    return lambda y: cat([f(y[..., :8]), 0.0 * y[..., 8:]])


# name: (integrate_rays kwargs beyond f, y0 and the span, state slots)
CASES = {
    "none": ({}, 8),
    "cubic": ({"disc": True}, 8),
    "sampled": ({"disc": True, "event_method": "sampled"}, 8),
    "segment_fn": ({"segment": True}, 8),
    "terminate_fns": ({"disc": True, "upper": True}, 8),
    "crossing_counter": ({"disc": True, "terminate_on_hit": False}, 9),
    "n_save": ({"disc": True, "n_save": 16}, 8),
    "max_steps": ({"disc": True, "max_steps": 40}, 8),
}


def _kwargs(case, pkg, r):
    spec, _ = CASES[case]
    kw = dict(TOLS, **CHART)
    for k in ("event_method", "terminate_on_hit", "n_save", "max_steps"):
        if k in spec:
            kw[k] = spec[k]
    if spec.get("disc"):
        d = r["jd"] if pkg == "jax" else r["td"]
        kw["crossing_fn"] = lambda y: d.crossing_indicator(y[..., 0:4])
        kw["hit_fn"] = lambda y: d.is_hit(y[..., 0:4])
    if spec.get("segment"):
        kw["segment_fn"] = _segment_hit(jnp if pkg == "jax" else torch)
    if spec.get("upper"):
        kw["terminate_fns"] = ((jax_upper if pkg == "jax" else domain_upper_hemisphere)(),)
    return kw


def _run(case, r):
    """Both packages' `integrate_rays` on the same initial states; numpy
    dicts of every result field."""
    _, S = CASES[case]
    y0 = r["y0"] if S == 8 else np.concatenate([r["y0"], np.zeros((N, 1))], axis=-1)
    fj, ft = jax_rhs(r["jm"]), make_geodesic_rhs(r["tm"])
    if S == 9:
        fj = _nine(fj, lambda ys: jnp.concatenate(ys, axis=-1))
        ft = _nine(ft, lambda ys: torch.cat(ys, dim=-1))
    kw_j = _kwargs(case, "jax", r)
    y0_j = jnp.asarray(y0)
    res_j = jax.jit(lambda y: jax_integrate_rays(fj, y, SPAN, **kw_j)).lower(y0_j).compile(_NO_FMA)(y0_j)
    res_t = integrate_rays(ft, torch.as_tensor(y0), SPAN, **_kwargs(case, "torch", r))
    out = {}
    for f in dataclasses.fields(res_t):
        a, b = getattr(res_j, f.name), getattr(res_t, f.name)
        out[f.name] = (None if a is None else np.asarray(a), None if b is None else b.numpy())
    return out


@pytest.fixture(scope="module", params=list(CASES))
def branch(request, rays):
    return request.param, _run(request.param, rays)


def test_integrate_rays_matches_jax_branch_by_branch(branch):
    case, out = branch
    (sj, st), (fj, ft) = out["status"], out["failed"]
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(ft, fj)
    assert st.dtype == np.int32 and ft.dtype == bool
    (nj, nt) = out["steps"]
    assert (nt == nj).mean() >= 0.95  # measured 1.0 in every case
    np.testing.assert_array_equal(out["y0"][1], out["y0"][0])
    np.testing.assert_array_equal(out["lam0"][1], out["lam0"][0])
    (yj, yt), (lj, lt) = out["y"], out["lam"]
    if case == "max_steps":
        # 40 lockstep iterations stop the rays still in flight
        live = sj == StatusCodes.NoStatus
        assert live.sum() >= 10 and (lj[live] < SPAN[1]).all() and (nj <= 40).all()
    # endpoints that do not depend on the step sequence: polished hits and
    # rays that reach λ1 (measured ≤ 4.8e-11 in every case); a segment hit
    # ends at its step's end (measured ≤ 4.2e-6)
    done = (sj == StatusCodes.NoStatus) & (lj >= SPAN[1] - 1e-9)
    keep = done | (sj == HIT)
    atol = 1e-5 if case == "segment_fn" else 1e-9
    # below the disc plane every escape turns OutOfDomain; the cut stops
    # every escape before λ1
    assert done.sum() >= (0 if case in ("terminate_fns", "max_steps") else 10) and keep.sum() >= 10
    np.testing.assert_allclose(yt[keep], yj[keep], rtol=0, atol=atol)
    np.testing.assert_allclose(lt[keep], lj[keep], rtol=0, atol=atol)
    if case == "crossing_counter":
        # every crossing of a ray's flight counted, by both packages alike
        np.testing.assert_array_equal(yt[:, 8], yj[:, 8])
        assert (yj[:, 8] >= 2).any() and not (sj == HIT).any()
    if case == "terminate_fns":
        below = sj == StatusCodes.OutOfDomain
        assert below.sum() >= 5
        assert (yt[below, 1] * np.cos(yt[below, 2]) < 1e-4).all()
    if case == "segment_fn":
        assert (sj == HIT).sum() >= 10
    if case == "n_save":
        (tj, tt), (tlj, tlt) = out["traj"], out["traj_lam"]
        assert tt.shape == (N, 16, 8) and tlt.shape == (N, 16)
        np.testing.assert_array_equal(tt[:, 0], out["y0"][1])
        # slot k < steps holds the k-th accepted step; a ray of 15 steps or
        # more ends in the last slot with its final committed state
        for k in range(1, 16):
            filled = nt >= k
            assert (tlt[filled, k] > tlt[filled, k - 1]).all()
            assert (tlt[~filled, k] == 0).all()
        full = done & (nt >= 15)
        assert full.sum() >= 10
        np.testing.assert_allclose(tt[full, -1], tj[full, -1], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tt[full, -1], yt[full])
    else:
        assert out["traj"] == (None, None)


@pytest.mark.parametrize(
    "case",
    [{"disc": True, "n_save": 16}, {"disc": True, "event_method": "sampled", "max_steps": 37}],
    ids=["cubic_n_save", "sampled_cut_at_37"],
)
def test_alive_check_interval_changes_no_output(rays, case, monkeypatch):
    """``alive.any()`` read every iteration or every 16: every output of
    `integrate_rays` equal bit for bit (with a ``max_steps`` cut that is no
    multiple of 16 too)."""
    CASES["k_check"] = (case, 8)
    kw = _kwargs("k_check", "torch", rays)
    del CASES["k_check"]
    outs = []
    for k in (1, 16):
        monkeypatch.setattr(solver, "_ALIVE_CHECK_EVERY", k)
        outs.append(integrate_rays(make_geodesic_rhs(rays["tm"]), torch.as_tensor(rays["y0"]), SPAN, **kw))
    for f in dataclasses.fields(outs[0]):
        a, b = getattr(outs[0], f.name), getattr(outs[1], f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    assert (outs[0].status == HIT).sum() >= 10


def _flagship_rays(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-20.0, 20.0, n), rng.uniform(-15.0, 15.0, n)


def test_trace_geodesics_matches_jax_at_the_flagship_camera():
    """`trace_geodesics` of both packages (the reference as its users call
    it, jitted), 128 rays: Kerr a = 0.998, r = 1000, i = 75°, ThinDisc(0, 50),
    λ ≤ 2200."""
    jm, jd = JaxKerr(M=1.0, a=0.998), JaxThinDisc(0.0, 50.0)
    x_obs = np.array([0.0, 1000.0, math.radians(75.0), 0.0])
    A, B = _flagship_rays(128, 4)
    v = jax_map_impact(jm, jnp.asarray(x_obs), jnp.asarray(A), jnp.asarray(B))
    gp_j = jax_trace(jm, jnp.broadcast_to(jnp.asarray(x_obs), v.shape), v, (0.0, 2200.0), geometry=jd)

    m = from_numpy("KerrMetric", _params(jm), device="cpu")
    d = from_numpy("ThinDisc", _params(jd), device="cpu")
    x = torch.as_tensor(x_obs)
    vt = map_impact_parameters(m, x, torch.as_tensor(A), torch.as_tensor(B))
    gp_t = trace_geodesics(m, x.expand_as(vt), vt, (0.0, 2200.0), geometry=d)

    sj = np.asarray(gp_j.status)
    np.testing.assert_array_equal(gp_t.status.numpy(), sj)
    assert (sj == HIT).sum() >= 60 and (sj == StatusCodes.WithinInnerBoundary).any()
    for name in ("x_init", "v_init", "lam_min"):
        np.testing.assert_allclose(getattr(gp_t, name).numpy(), np.asarray(getattr(gp_j, name)), rtol=0, atol=1e-12)
    # polished hits and rays that reach λ1 (measured ≤ 6.9e-9)
    keep = (sj == HIT) | (sj == StatusCodes.NoStatus)
    for name in ("x", "v", "lam_max"):
        np.testing.assert_allclose(
            getattr(gp_t, name).numpy()[keep], np.asarray(getattr(gp_j, name))[keep], rtol=0, atol=1e-7
        )
    xh = gp_t.x.numpy()[sj == HIT]
    np.testing.assert_allclose(xh[:, 1] * np.cos(xh[:, 2]), 0.0, atol=1e-9)
    # one ray alone is the batch's first ray
    one = trace_geodesics(m, x, vt[0], (0.0, 2200.0), geometry=d)
    assert one.x.shape == (4,) and int(one.status) == int(sj[0])


def test_device_mismatch_raises(rays):
    """The trace runs on the device of ``x``: a metric, geometry or ``v``
    elsewhere raises, with no copy."""
    x = torch.as_tensor(rays["y0"][:4, :4])
    v = torch.as_tensor(rays["y0"][:4, 4:])
    meta = dict(device="meta")
    for kw in (
        dict(m=KerrMetric(1.0, 0.0, **meta)),
        dict(geometry=ThinDisc(0.0, 50.0, **meta)),
        dict(v=v.to("meta")),
    ):
        args = {**dict(m=rays["tm"], x=x, v=v, geometry=rays["td"]), **kw}
        with pytest.raises(ValueError, match="device"):
            trace_geodesics(args.pop("m"), args.pop("x"), args.pop("v"), SPAN, **args)


def test_unported_trace_paths_raise(rays):
    x = torch.as_tensor(rays["y0"][:2, :4])
    v = torch.as_tensor(rays["y0"][:2, 4:])
    m = rays["tm"]
    with pytest.raises(NotImplementedError, match="item 11"):
        trace_geodesics(m, x, v, SPAN, checkpointed=True)
    # the corona-model dispatch is ported (tests/test_torch_corona.py)
    gp = tracegeodesics(m, LampPostModel(), 1.0, n_samples=3)
    assert gp.x.shape == (3, 4) and bool(torch.isfinite(gp.x).all())
    # a θ-dependent chart and charged traces are ported
    # (tests/test_torch_shaped_chart.py, tests/test_torch_charged_orbits.py);
    # a charge needs a metric with an electromagnetic potential
    shape = types.SimpleNamespace(
        thetas=torch.linspace(0, math.pi, 5, dtype=torch.float64), rs=torch.full((5,), 2.5, dtype=torch.float64)
    )
    gp = trace_geodesics(m, x, v, (0.0, 5.0), chart_inner=shape)
    assert bool(torch.isfinite(gp.x).all())
    with pytest.raises(AttributeError, match="electromagnetic_potential"):
        trace_geodesics(m, x, v, SPAN, q=0.1)
    # the positional front door is trace_geodesics
    gp = tracegeodesics(m, x, v, (0.0, 5.0))
    assert gp.x.shape == (2, 4) and (gp.lam_max == 5.0).all()


def test_trace_geodesics_does_not_route_to_the_kernel(rays, monkeypatch):
    """`trace_geodesics` runs the lockstep solver: neither the integrator
    kernel's entry point nor its plain version is called."""
    from gradus_tpu_torch.integrate import cuda_solver

    def refuse(*args, **kw):
        raise AssertionError("trace_geodesics reached the integrator kernel's path")

    for name in ("cuda_integrate_rays", "integrate_rays_plain", "_launch_kernel"):
        monkeypatch.setattr(cuda_solver, name, refuse)
    before = cuda_solver.KERNEL_LAUNCHES
    x = torch.as_tensor(rays["y0"][:8, :4])
    v = torch.as_tensor(rays["y0"][:8, 4:])
    gp = trace_geodesics(rays["tm"], x, v, SPAN, geometry=rays["td"], constrain=False)
    assert (gp.status == HIT).any() and cuda_solver.KERNEL_LAUNCHES == before
