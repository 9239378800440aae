"""Parity of the port's integrator with the JAX reference, in f64 on the CPU.

The Tsit5 step, the HNW initial step and the cubic event locator are the
same closed forms in both packages. The whole adaptive integrator is held
against the Pallas kernel run in interpret mode (`pallas_integrate_rays`):
on a CPU tensor `cuda_integrate_rays` runs the kernel's plain PyTorch
version.

Why the raw integrator states are not compared to 1e-5: early in a ray's
flight the embedded error estimate (Σ b̃ⱼ kⱼ, a near-total cancellation) is
roundoff, ~1e-10 of the tolerance, and the PI controller reads it unclipped.
Any change of operation order changes it: the JAX reference's own eager and
jitted step differ there by 11% on the first step of these rays. So two
implementations take slightly different step sequences. The robust
observables are compared instead: statuses, accepted-step counts, and the
endpoints that do not depend on the step sequence: polished disc hits and
rays that reach the end of the affine span.

The comparisons with `PallasTracer` hold only because none of these rays is
a hit whose polish reads a ``dt`` that the Pallas kernel shrank after the
ray ended: a fault of the reference, pinned in
tests/test_torch_pallas_dt_fault.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.events import cubic_first_crossing as jax_cubic  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer, pallas_integrate_rays  # noqa: E402
from gradus_tpu.integrate.tracing import make_geodesic_rhs as jax_rhs  # noqa: E402
from gradus_tpu.integrate.tsit5 import hermite_interp as jax_hermite_interp  # noqa: E402
from gradus_tpu.integrate.tsit5 import initial_dt as jax_initial_dt  # noqa: E402
from gradus_tpu.integrate.tsit5 import tsit5_step as jax_tsit5_step  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    CudaTracer,
    _check_kernel_config,
    _warp_iters,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.integrate.events import cubic_first_crossing  # noqa: E402
from gradus_tpu_torch.integrate.status import StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.tracing import make_geodesic_rhs  # noqa: E402
from gradus_tpu_torch.integrate.tsit5 import hermite_interp, initial_dt, tsit5_step  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402

SPAN = (0.0, 2200.0)


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def setup():
    """The 96-ray setup of tests/test_pallas_solver.py, in both packages."""
    jm = JaxKerr(M=1.0, a=0.998)
    jd = JaxThinDisc(inner_r=0.0, outer_r=50.0)
    x_obs = jnp.asarray([0.0, 1000.0, np.deg2rad(75.0), 0.0])
    rng = np.random.default_rng(2)
    n = 96
    A = jnp.asarray(rng.uniform(-12, 12, n))
    B = jnp.asarray(rng.uniform(-12, 12, n))
    v = jax_map_impact(jm, x_obs, A, B)
    xs = jnp.broadcast_to(x_obs, v.shape)
    tm = from_numpy("KerrMetric", _params(jm), device="cpu")
    td = from_numpy("ThinDisc", _params(jd), device="cpu")
    return dict(jm=jm, jd=jd, xs=xs, v=v, tm=tm, td=td)


@pytest.fixture(scope="module", params=[True, False], ids=["thin_disc", "no_geometry"])
def runs(request, setup):
    """Raw integrator outputs and traced GeodesicPoints of both packages."""
    s = setup
    with_disc = request.param
    pt = PallasTracer(s["jm"], geometry=s["jd"] if with_disc else None, interpret=True)
    y0 = pt._constrain(s["xs"], s["v"])
    raw_j = pallas_integrate_rays(
        pt._f_cm,
        y0,
        SPAN,
        crossing_cm=pt._crossing_cm,
        hit_cm=pt._hit_cm,
        abstol=pt.abstol,
        reltol=pt.reltol,
        r_inner=pt.r_inner,
        r_outer=pt.r_outer,
        interpret=True,
    )
    gp_j = pt(s["xs"], s["v"], SPAN)

    geometry = s["td"] if with_disc else None
    ct = CudaTracer(s["tm"], geometry=geometry)
    y0_t = torch.as_tensor(np.array(y0))
    raw_t = cuda_integrate_rays(
        s["tm"], y0_t, SPAN, geometry=geometry, **_tol_kwargs(ct)
    )
    gp_t = ct(torch.as_tensor(np.array(s["xs"])), torch.as_tensor(np.array(s["v"])), SPAN)
    return dict(
        with_disc=with_disc,
        raw_j={k: np.asarray(v) for k, v in raw_j.items()},
        raw_t={k: v.numpy() for k, v in raw_t.items()},
        gp_j=gp_j,
        gp_t=gp_t,
        aux=ct.last_aux,
        y0=np.array(y0),
    )


def _tol_kwargs(ct):
    return dict(abstol=1e-9, reltol=1e-9, r_inner=ct.r_inner, r_outer=ct.r_outer)


def _geodesic_state(seed, n=32):
    rng = np.random.default_rng(seed)
    jm = JaxKerr(M=1.0, a=0.9)
    r = rng.uniform(4.0, 60.0, n)
    th = rng.uniform(0.3, np.pi - 0.3, n)
    x = np.stack([np.zeros(n), r, th, np.zeros(n)], -1)
    v = np.concatenate([np.ones((n, 1)), 0.05 * rng.normal(size=(n, 3))], -1)
    from gradus_tpu.geodesics.equation import constrain_all

    v = np.asarray(constrain_all(jm, jnp.asarray(x), jnp.asarray(v)))
    return jm, from_numpy("KerrMetric", _params(jm), device="cpu"), np.concatenate([x, v], -1)


def test_tsit5_step_matches_jax():
    jm, tm, y = _geodesic_state(11)
    dt = np.random.default_rng(12).uniform(0.05, 2.0, len(y))
    yn_j, err_j, k1_j, k7_j = jax_tsit5_step(jax_rhs(jm), jnp.asarray(y), jnp.asarray(dt))
    yn_t, err_t, k1_t, k7_t = tsit5_step(make_geodesic_rhs(tm), torch.as_tensor(y), torch.as_tensor(dt))
    for a, b in ((yn_j, yn_t), (k1_j, k1_t), (k7_j, k7_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-15)
    # the error estimate is a near-cancellation: compare on its own scale
    scale = np.abs(np.asarray(err_j)).max()
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=0, atol=1e-6 * scale)


def test_initial_dt_matches_jax():
    jm, tm, y = _geodesic_state(13)
    h_j = jax_initial_dt(jax_rhs(jm), jnp.asarray(y), 1e-9, 1e-9)
    h_t = initial_dt(make_geodesic_rhs(tm), torch.as_tensor(y), 1e-9, 1e-9)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-12)


def test_hermite_interp_matches_jax():
    jm, tm, y = _geodesic_state(15)
    rng = np.random.default_rng(16)
    dt = rng.uniform(0.05, 2.0, len(y))
    theta = rng.uniform(0.0, 1.0, len(y))
    y1, _, f0, f1 = jax_tsit5_step(jax_rhs(jm), jnp.asarray(y), jnp.asarray(dt))
    args = [np.asarray(a) for a in (theta, y, y1, f0, f1, dt)]
    h_j = jax_hermite_interp(*map(jnp.asarray, args))
    h_t = hermite_interp(*map(torch.as_tensor, args))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-12, atol=1e-12)
    # the ends of the step are reproduced exactly
    ends = hermite_interp(torch.zeros(len(y), dtype=torch.float64), *map(torch.as_tensor, args[1:]))
    np.testing.assert_allclose(ends.numpy(), y, rtol=1e-15)


def _cubics():
    """Random Hermite cubics plus enter-and-exit (dips below zero between two
    positive ends), near-tangent (touches within +1e-3 of zero, no root) and
    no-root cases."""
    rng = np.random.default_rng(21)
    n = 400
    c0, m0, c1, m1 = rng.normal(size=(4, n))
    # enter-and-exit: c(θ) = 4(θ-½)² - 0.9·d with c(0), c(1) > 0
    d = rng.uniform(0.2, 1.0, 50)
    dip = [1.0 - 0.9 * d, -4.0 * np.ones(50), 1.0 - 0.9 * d, 4.0 * np.ones(50)]
    # near-tangent from above: 4(θ-½)² + 1e-3
    tan = [np.full(50, 1.001), np.full(50, -4.0), np.full(50, 1.001), np.full(50, 4.0)]
    # no root: positive and monotone
    none = [rng.uniform(0.1, 1, 50), rng.uniform(0, 1, 50), rng.uniform(1, 2, 50), rng.uniform(0, 1, 50)]
    return [np.concatenate([x, a, b, c]) for x, a, b, c in zip((c0, m0, c1, m1), dip, tan, none)]


def test_cubic_first_crossing_matches_jax():
    cs = _cubics()
    f_j, th_j = jax_cubic(*map(jnp.asarray, cs))
    f_t, th_t = cubic_first_crossing(*map(torch.as_tensor, cs))
    f_j, th_j = np.asarray(f_j), np.asarray(th_j)
    assert (f_t.numpy() == f_j).all()
    np.testing.assert_allclose(th_t.numpy(), th_j, rtol=0, atol=1e-12)
    n = len(cs[0])
    assert f_j[n - 150 : n - 100].all()  # every enter-and-exit dip is found
    assert not f_j[n - 100 :].any()  # no tangent or rootless cubic is


def test_plain_integrator_matches_pallas_kernel(runs):
    rj, rt = runs["raw_j"], runs["raw_t"]
    np.testing.assert_array_equal(rt["status"], rj["status"])
    np.testing.assert_array_equal(rt["failed"], rj["failed"])
    assert (rt["steps"] == rj["steps"]).mean() >= 0.95
    assert rt["status"].dtype == np.int32 and rt["warp_iters"].dtype == np.int32
    # rays that reach λ1 end at the same affine parameter, whatever the steps
    done = (rj["status"] == StatusCodes.NoStatus) & (rj["failed"] == 0)
    if not runs["with_disc"]:
        assert done.sum() > 50
    np.testing.assert_allclose(rt["lam"][done], rj["lam"][done], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt["y"][done], rj["y"][done], rtol=0, atol=1e-5)
    if runs["with_disc"]:
        hit = rj["status"] == StatusCodes.IntersectedWithGeometry
        assert hit.sum() > 10
        # a hit does not commit its step and records its span and crossing
        assert (rt["dt"][hit] > 0).all()
        assert ((rt["hit_theta"][hit] > 0) & (rt["hit_theta"][hit] <= 1)).all()


def test_cuda_tracer_matches_pallas_tracer(runs):
    gj, gt = runs["gp_j"], runs["gp_t"]
    sj = np.asarray(gj.status)
    np.testing.assert_array_equal(gt.status.numpy(), sj)
    for name in ("x_init", "v_init", "lam_min"):
        np.testing.assert_allclose(
            getattr(gt, name).numpy(), np.asarray(getattr(gj, name)), rtol=0, atol=1e-12
        )
    # endpoints independent of the step sequence: polished hits, and rays
    # that reach λ1 (chart exits land at the first step end past the bound)
    keep = (sj == StatusCodes.IntersectedWithGeometry) | (sj == StatusCodes.NoStatus)
    assert keep.sum() > 50
    for name in ("x", "v", "lam_max"):
        np.testing.assert_allclose(
            getattr(gt, name).numpy()[keep],
            np.asarray(getattr(gj, name))[keep],
            rtol=0,
            atol=1e-5,
        )
    if runs["with_disc"]:
        xh = gt.x.numpy()[sj == StatusCodes.IntersectedWithGeometry]
        np.testing.assert_allclose(xh[:, 2], np.pi / 2, atol=1e-5)
    aux = runs["aux"]
    assert int(aux["unfinished"]) == 0
    assert (aux["warp_iters"] >= aux["attempts"]).all()
    assert (aux["attempts"] >= aux["steps"]).all()


def test_plain_integrator_screens_non_finite_rays(setup):
    y0 = torch.as_tensor(np.array(PallasTracer(setup["jm"])._constrain(setup["xs"][:4], setup["v"][:4])))
    y0[1, 5] = float("nan")
    out = integrate_rays_plain(setup["tm"], y0, SPAN, abstol=1e-9, reltol=1e-9, r_inner=1.07, r_outer=12000.0)
    assert out["failed"].tolist() == [0, 1, 0, 0]
    assert out["attempts"][1] == 0 and out["steps"][1] == 0


def test_plain_integrator_stops_at_max_steps(setup):
    y0 = torch.as_tensor(np.array(PallasTracer(setup["jm"])._constrain(setup["xs"][:8], setup["v"][:8])))
    out = integrate_rays_plain(
        setup["tm"], y0, SPAN, geometry=setup["td"], abstol=1e-9, reltol=1e-9,
        r_inner=1.07, r_outer=12000.0, max_steps=5,
    )
    assert (out["attempts"] == 5).all()
    assert (out["status"] == StatusCodes.NoStatus).all()


def test_warp_iters_is_max_attempts_per_32_rays():
    attempts = torch.arange(70, dtype=torch.int32)
    w = _warp_iters(attempts)
    assert w.dtype == torch.int32 and w.shape == (70,)
    assert w[:32].eq(31).all() and w[32:64].eq(63).all() and w[64:].eq(69).all()


@pytest.mark.parametrize(
    "case", ["metric", "geometry", "mu", "dtype"]
)
def test_kernel_rejects_configurations_it_does_not_take(setup, case):
    """The kernel refuses a metric, a geometry or a dtype it does not take.
    A timelike ray it takes: its right-hand side does not read ``mu``,
    which enters through the constraint of the initial state."""
    from gradus_tpu_torch.geometry.discs import AbstractAccretionGeometry
    from gradus_tpu_torch.metrics.base import AbstractMetric

    args = dict(m=setup["tm"], geometry=setup["td"], dtype=torch.float32)
    if case == "mu":
        tracer = CudaTracer(setup["tm"], geometry=setup["td"], mu=1.0)
        assert tracer.mu == 1.0 and "mu" not in tracer._integrate_kwargs(torch.float32)
        _check_kernel_config(args["m"], args["geometry"], args["dtype"])
        return
    args.update(
        dict(
            metric=dict(m=AbstractMetric()),
            geometry=dict(geometry=AbstractAccretionGeometry()),
            dtype=dict(dtype=torch.float16),
        )[case]
    )
    with pytest.raises(NotImplementedError):
        _check_kernel_config(args["m"], args["geometry"], args["dtype"])


def test_tracer_rejects_unported_modes(setup):
    """Sampled events and segmented tail passes are ported: the tracer takes
    them and hands them to the integrator. An event method that neither
    package has is refused."""
    t = CudaTracer(setup["tm"], geometry=setup["td"], event_method="sampled")
    assert t._integrate_kwargs(torch.float64)["event_method"] == "sampled"
    t = CudaTracer(setup["tm"], segment_iters=48)
    assert (t.segment_iters, t.tail_bucket) == (48, 16384)
    with pytest.raises(ValueError):
        CudaTracer(setup["tm"], event_method="quintic")


@pytest.mark.parametrize(
    "option",
    ["tile_rows", "steps_per_check", "tail_tile_rows", "interpret", "n_interp", "bisect_iters", "tail_bucket"],
)
def test_tracer_refuses_options_it_does_not_read(setup, option):
    """The TPU kernel's tile options are no keyword of `CudaTracer`: passing
    one fails instead of being ignored. The options of the sampled events
    and of the tail pass it takes and reads."""
    if option in ("n_interp", "bisect_iters", "tail_bucket"):
        t = CudaTracer(setup["tm"], event_method="sampled", segment_iters=48, **{option: 8})
        read = {**t._integrate_kwargs(torch.float64), "tail_bucket": t.tail_bucket}
        assert read[option] == 8
        return
    with pytest.raises(TypeError):
        CudaTracer(setup["tm"], **{option: 8})
