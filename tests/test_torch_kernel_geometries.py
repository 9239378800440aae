"""The integrator kernel's geometries beside ThinDisc and DatumPlane
(ShakuraSunyaev, EllipticalDisc, PolishDoughnut, PrecessingDisc and
CompositeGeometry, csrc/geometry.cuh), through its plain version on CPU
tensors, against the JAX package's `PallasTracer(..., interpret=True)` in
f64 (`CudaTracer` on CPU tensors runs the plain version; the kernel itself
is held to it on the card by tests/test_torch_cuda_kernel.py and
chip_smoke.py).

Rays: 64 flagship ones (Kerr a = 0.998, r = 1000, i = 75°, λ ≤ 2200) at
image-plane offsets ρ ∈ [7.5, 15], outside the critical curve. ShakuraSunyaev
(cubic events) and the composite are traced by the JAX package here; the
other cases (sampled events, the ellipse, two precessing discs whose
crossings depend on φ, the doughnut in Schwarzschild's closed form and in
the traced Kerr metric) are pinned in
tests/data/kernel_geometries_reference.npz by
scripts/torch_kernel_geometries_reference.py, whose rays and geometries
this module reads from it (and ShakuraSunyaev's rays traced alone).

What is held (`_hits_agree`: statuses identical, polished hits within 1e-9
relative to max(1, |value|)):

- the port at the tracer's defaults against the reference's batch, except
  the rays named in `OFF_BATCH`: hits that the reference's ``dt`` fault
  (ROADMAP C; tests/test_torch_pallas_dt_fault.py) moves off the surface,
  and EllipticalDisc hits whose event sits at θ = 1 − 2⁻²⁷ (the cubic
  event's answer to a NaN slope: a step that starts beyond the ellipse's
  semi-major axis, where the indicator's jax.jvp is NaN, sqrt's tangent
  at 0), from which 3 Newton iterations do not reach the surface and the
  result is as far off as the step sequence makes it;
- every ray with 20 Newton iterations against the reference traced ray by
  ray (no ``dt`` fault) with 20, but the rays named in `OFF_ALONE`, whose
  event the step sequence decides;
- the composite, whose hit test (|c| < 1e-6 at the cubic event's root,
  discs.py:462-471) decides on a residual that the step sequence sets,
  step by step: from the same carry, one iteration of each package gives
  the same statuses and the same state.

Why a step sequence is not held across packages: far from the hole the
controller's error estimate is rounding (the state's t and φ start at 0,
where the error scale is abstol), so one step from the same state gives
step sizes ~1e-8 apart in the two packages, and the steps then fall
differently; a polished hit does not depend on them, but a hit test on a
residual (the composite), an event in the step that enters the ellipse
(its indicator's slope diverges at the rim) and a polish that does not
converge do. The JAX package with and without XLA's FMA contraction
disagrees on 6 of the composite's 64 statuses.

Also pinned: the geometries that neither kernel takes (per-ray DatumPlane
heights and PolishDoughnutFW, whose arrays the Pallas kernel refuses to
capture; a CompositeGeometry of more parts than the port's block holds;
a PolishDoughnut of another metric class than the traced one), and the
forward-mode tangents the port's indicators take at their kinks, which
are the JAX package's, not torch's. WarpedThinDisc and ThickDisc, whose
cross-section callables the kernel compiles at first use, are
tests/test_torch_kernel_callables.py's.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu.geometry as jax_geometry  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer, pallas_integrate_rays  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch import geometry as G  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    _check_kernel_config,
    _mid_flight,
    _polish_plain,
    integrate_rays_plain,
)
from gradus_tpu_torch.interop import geometry_from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import JohannsenMetric, KerrMetric  # noqa: E402

SPAN = (0.0, 2200.0)
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
HIT = StatusCodes.IntersectedWithGeometry
REFERENCE = np.load(Path(__file__).resolve().parent / "data" / "kernel_geometries_reference.npz")
SPECS = json.loads(str(REFERENCE["specs"]))
# The rays whose hit at the defaults is not the reference batch's: the dt
# fault moves the reference's off the surface (all but those below), or
# 3 Newton iterations from θ = 1 − 2⁻²⁷ end off it (the ellipse's 16, 42,
# 50, 51 and 54 and its precessed 50).
OFF_ALONE = {"precessing_elliptical": [50]}  # its hit step starts 0.0035 inside the ellipse's rim
OFF_BATCH = {
    "shakura_sunyaev": [53],
    "shakura_sunyaev_sampled": [53],
    "elliptical": [12, 16, 42, 47, 49, 50, 51, 53, 54],
    "precessing_elliptical": [49, 50, 60],
    "precessing_thin": [],
    "doughnut": [11, 25, 26, 58],
    "doughnut_kerr": [11, 25, 26, 58],
}


@pytest.fixture(scope="module")
def rays():
    alpha, beta = REFERENCE["alpha"], REFERENCE["beta"]
    m = KerrMetric(1.0, 0.998, device="cpu")
    x = torch.tensor(X_OBS, dtype=torch.float64)
    v = map_impact_parameters(m, x, torch.as_tensor(alpha), torch.as_tensor(beta))
    return dict(m=m, x=x.expand_as(v), v=v, alpha=alpha, beta=beta)


def _jax_trace(geometry, alpha, beta):
    jm = JaxKerr(M=1.0, a=0.998)
    x = jnp.asarray(X_OBS)
    v = jax_map_impact(jm, x, jnp.asarray(alpha), jnp.asarray(beta))
    gp = PallasTracer(jm, geometry=geometry, interpret=True)(jnp.broadcast_to(x, v.shape), v, SPAN)
    return np.asarray(gp.status), np.asarray(gp.x), np.asarray(gp.lam_max)


def _references(case, alpha, beta):
    """(the batch's status, x, lam_max; x and lam_max ray by ray, keyed by
    ray; the port's geometry; event method). ShakuraSunyaev's batch is
    traced here."""
    xs, lams = REFERENCE[f"{case}/x_alone"], REFERENCE[f"{case}/lam_max_alone"]
    alone = {i: (xs[i : i + 1], lams[i : i + 1]) for i in range(len(alpha))}
    kind, params = SPECS[case]["geometry"]
    geometry = geometry_from_numpy(kind, params, device="cpu")
    if case == "shakura_sunyaev":
        jd = jax_geometry.ShakuraSunyaev.from_metric(JaxKerr(M=1.0, a=0.998))
        assert [float(getattr(jd, k)) for k in ("mdot_over_edd", "inv_eta", "inner_r")] == [params[k] for k in ("mdot_over_edd", "inv_eta", "inner_r")]
        return _jax_trace(jd, alpha, beta), alone, geometry, "cubic"
    batch = tuple(REFERENCE[f"{case}/{k}"] for k in ("status", "x", "lam_max"))
    return batch, alone, geometry, SPECS[case]["event_method"]


def _close(got, want, rtol=1e-9):
    return np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_plain_version_matches_pallas_tracer(rays, case):
    (status, x, lam), alone, geometry, event_method = _references(case, rays["alpha"], rays["beta"])
    _check_kernel_config(rays["m"], geometry, torch.float64)  # the kernel takes it
    # one loop, polished as the tracer polishes (3 Newton iterations) and
    # with 20: `integrate_rays_plain(newton_iters=n)` is the loop, then this
    tracer = CudaTracer(rays["m"], geometry=geometry, event_method=event_method)
    y0 = tracer._constrain(rays["x"], rays["v"])
    raw = integrate_rays_plain(rays["m"], y0, SPAN, **{**tracer._integrate_kwargs(torch.float64), "newton_iters": 0})
    gp, gp20 = (tracer._finish(_polish_plain(rays["m"], geometry, raw, n), y0, SPAN[0]) for n in (3, 20))
    np.testing.assert_array_equal(gp.status.numpy(), status)
    hit = status == HIT
    assert hit.sum() >= 32
    agree = _close(gp.x.numpy(), x).all(-1) & _close(gp.lam_max.numpy(), lam)
    assert np.nonzero(hit & ~agree)[0].tolist() == OFF_BATCH[case]
    # every ray alone, to 20 Newton iterations
    off = [
        i
        for i, (x_i, lam_i) in alone.items()
        if not (_close(gp20.x.numpy()[i], x_i[0]).all() and _close(gp20.lam_max.numpy()[i], lam_i[0]))
    ]
    assert off == OFF_ALONE.get(case, [])


# --- the composite, step by step ----------------------------------------------------

# the JAX kernel's carry (pallas_solver.py:485-496)
_JAX_STATE = ("k1", "lam", "dt", "ln_qold", "status", "steps", "failed", "c_prev", "dc_prev", "hit_theta")


def test_composite_steps_match_pallas_kernel(rays):
    """CompositeGeometry((ThinDisc(20, 100), DatumPlane(3))), the docs'
    (docs/examples.md), one iteration at a time from the port's carry:
    statuses, step counts and failures identical, the state, the
    indicator, its slope and the event's θ within 1e-9 relative to max(1,
    |value|) after every iteration (not the next step size, whose error
    estimate is rounding far from the hole), and some rays hit."""
    jm = JaxKerr(M=1.0, a=0.998)
    jd = jax_geometry.CompositeGeometry((jax_geometry.ThinDisc(20.0, 100.0), jax_geometry.DatumPlane(3.0)))
    td = G.CompositeGeometry([G.ThinDisc(20.0, 100.0, device="cpu"), G.DatumPlane(3.0, device="cpu")])
    tracer = CudaTracer(rays["m"], geometry=td)
    kw = {**tracer._integrate_kwargs(torch.float64), "newton_iters": 0, "iter_cap": 1}
    pt = PallasTracer(jm, geometry=jd, interpret=True)
    jkw = {**pt._integrate_kwargs(), "steps_per_check": 1, "iter_cap": 1}

    @jax.jit
    def jax_step(y, state):
        return pallas_integrate_rays(pt._f_cm, y, SPAN, state=state, **jkw)

    y = tracer._constrain(rays["x"], rays["v"])
    out = integrate_rays_plain(rays["m"], y, SPAN, **kw)
    iterations = 1
    while bool(_mid_flight(out, SPAN[1]).any()):
        state = {k: out[k] for k in _JAX_STATE + ("crossings",)}
        mine = integrate_rays_plain(rays["m"], out["y"], SPAN, state=state, **kw)
        theirs = jax_step(jnp.asarray(out["y"].numpy()), {k: jnp.asarray(out[k].numpy()) for k in _JAX_STATE})
        for k in ("status", "steps", "failed"):
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]), err_msg=f"{k}, iteration {iterations}")
        # the rays that stepped
        went = _mid_flight(out, SPAN[1]).numpy()
        for k in ("y", "k1", "lam", "c_prev", "dc_prev", "hit_theta"):
            assert _close(mine[k].numpy()[went], np.asarray(theirs[k])[went]).all(), f"{k}, iteration {iterations}"
        out, iterations = mine, iterations + 1
        assert iterations < 2000
    assert (out["status"] == HIT).sum() >= 32 and (out["status"] == StatusCodes.NoStatus).sum() >= 1


# --- what neither kernel takes, and the tangents at the kinks -----------------------


def test_geometries_neither_kernel_takes(rays):
    """The reference's Pallas kernel refuses arrays in a geometry (a
    per-ray DatumPlane, PolishDoughnutFW's isobar); the port's CUDA kernel
    refuses those and a composite of no part (`_check_kernel_config`,
    which needs no card). A composite of any number of parts, and a
    doughnut of another metric class than the rays' (its isobars in that
    class, as the reference's kernel evaluates that metric's components),
    it takes, as the reference's kernel does."""
    jm = JaxKerr(M=1.0, a=0.998)
    x = jnp.asarray(X_OBS)
    # 128 rays: one row of the Pallas kernel's tile, as wide as the heights
    v = jax_map_impact(jm, x, jnp.asarray(np.tile(rays["alpha"], 2)), jnp.asarray(np.tile(rays["beta"], 2)))
    rs = np.linspace(6.0, 20.0, 16)
    for g in (jax_geometry.DatumPlane(jnp.zeros(128)), jax_geometry.PolishDoughnutFW(rs=jnp.asarray(rs), zs=jnp.asarray(rs - 6.0))):
        with pytest.raises(ValueError, match="captures constants"):
            PallasTracer(jm, geometry=g, interpret=True)(jnp.broadcast_to(x, v.shape), v, SPAN)
    cpu = dict(device="cpu")
    for g in (
        G.DatumPlane([0.0] * 8, **cpu),
        G.PolishDoughnutFW(rs, rs - 6.0, **cpu),
        G.CompositeGeometry([]),
    ):
        with pytest.raises(NotImplementedError):
            _check_kernel_config(rays["m"], g, torch.float64)
    _check_kernel_config(rays["m"], G.CompositeGeometry([G.ThinDisc(**cpu)] * 5), torch.float64)
    _check_kernel_config(rays["m"], G.PolishDoughnut(metric=JohannsenMetric(1.0, 0.998, **cpu)), torch.float64)


def test_indicator_tangents_at_kinks_are_the_reference_s():
    """|x| at 0 (slope +1 in jax.jvp, 0 in torch.abs) and a tie of
    jnp.maximum (half the tangent; torch.clamp gives all of it): the
    ellipse at r = 0, a thick disc where its cross-section h(ρ) = ρ − 10
    ends (ρ = 10 at θ = π/2), and the precessed and composite forms."""
    pos = np.array([[0.0, 0.0, 1.1, 0.3], [0.0, 10.0, math.pi / 2, 0.2], [0.0, 12.0, math.pi / 2, 0.0]])
    vel = np.array([[0.0, 1.0, 0.2, 0.1], [0.0, 1.0, 0.0, 0.3], [0.0, -0.5, 0.3, 0.2]])
    pairs = [
        (jax_geometry.EllipticalDisc(0.0, 100.0, 60.0), G.EllipticalDisc(0.0, 100.0, 60.0, device="cpu")),
        (jax_geometry.ThickDisc(lambda rho: rho - 10.0), G.ThickDisc(lambda rho: rho - 10.0, device="cpu")),
        (
            jax_geometry.PrecessingDisc(jax_geometry.EllipticalDisc(0.0, 100.0, 60.0), 0.0, 0.0),
            G.PrecessingDisc(G.EllipticalDisc(0.0, 100.0, 60.0, device="cpu"), 0.0, 0.0, device="cpu"),
        ),
    ]
    for jd, td in pairs:
        c_j, dc_j = jax.jvp(lambda *p: jd.crossing_indicator_c(*p), tuple(jnp.asarray(pos.T)), tuple(jnp.asarray(vel.T)))
        c_t, dc_t = torch.func.jvp(td.crossing_indicator_c, tuple(torch.as_tensor(pos.T)), tuple(torch.as_tensor(vel.T)))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), rtol=1e-14, atol=1e-14)
    # the kinks are where the two rules differ: torch's own would not agree
    r, th = torch.tensor(0.0, dtype=torch.float64), torch.tensor(1.1, dtype=torch.float64)
    _, slope = torch.func.jvp(lambda r: torch.abs(r * torch.cos(th)), (r,), (torch.ones_like(r),))
    assert float(slope) == 0.0 and math.cos(1.1) != 0.0
