"""The Newton polish of the disc hits as the integrator's own last step, in
f64 on the CPU: the kernel runs `_polish_hits`'s arithmetic on the hits of
its launch, as each hit ray's epilogue (its last loop iterations), and its
plain version (`integrate_rays_plain`, ``newton_iters > 0``) is the loop
followed by the unchanged `_polish_hits`.
Checked here: the plain version against `_polish_hits` applied to its own
unpolished output (bit for bit) and against the JAX package's polish of the
same carry; a resumed call that does not polish again a hit it was handed;
`CudaTracer._finish`, which unpacks a polished result unchanged and
refuses an unpolished one; and the arguments the tracer and the integrator
refuse.

Rays: the flagship camera (Kerr a = 0.998, r = 1000, i = 75°) against
ThinDisc(0, 50), and transfer-function rays (i = 60°) against DatumPlane(0).

The comparisons with `PallasTracer` hold only because none of these rays is
a hit whose polish reads a ``dt`` that the Pallas kernel shrank after the
ray ended: a fault of the reference, pinned in
tests/test_torch_pallas_dt_fault.py.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.geometry import DatumPlane as JaxDatumPlane  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer  # noqa: E402
from gradus_tpu.integrate.solver import _polish_hits as jax_polish_hits  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import DatumPlane, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    CudaTracer,
    _OUTPUT_KEYS,
    _STATE_KEYS,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.integrate.solver import _polish_hits, _Problem  # noqa: E402
from gradus_tpu_torch.integrate.tracing import make_geodesic_rhs  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

HIT = StatusCodes.IntersectedWithGeometry
N = 32
CASES = {
    # (observer inclination, λ span, chart outer bound, image-plane offsets)
    "thin_disc": (75.0, (0.0, 2200.0), 12000.0, "flagship"),
    "datum_plane": (60.0, (0.0, 2000.0), 2000.0, "transfer"),
}


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _offsets(kind, seed=41):
    rng = np.random.default_rng(seed)
    if kind == "flagship":
        # outside the critical curve (ρ > 7.5), where rounding does not pick
        # another hit
        rho, phi = rng.uniform(7.5, 12.0, N), rng.uniform(0.0, 2 * np.pi, N)
    else:
        rho, phi = rng.uniform(1.5, 60.0, N), rng.uniform(0.0, 2 * np.pi, N)
    return rho * np.cos(phi), rho * np.sin(phi)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The plain integrator's outputs, unpolished and polished, for one
    geometry, with the JAX twins of the metric and the geometry."""
    incl, span, chart_outer, kind = CASES[request.param]
    jm = JaxKerr(M=1.0, a=0.998)
    jd = JaxThinDisc(0.0, 50.0) if request.param == "thin_disc" else JaxDatumPlane(0.0)
    m = from_numpy("KerrMetric", _params(jm), device="cpu")
    d = (
        ThinDisc(0.0, 50.0, device="cpu")
        if request.param == "thin_disc"
        else DatumPlane(0.0, device="cpu")
    )
    x = torch.tensor([0.0, 1000.0, math.radians(incl), 0.0], dtype=torch.float64)
    A, B = _offsets(kind)
    v = map_impact_parameters(m, x, torch.as_tensor(A), torch.as_tensor(B))
    tracer = CudaTracer(m, geometry=d, chart_outer=chart_outer)
    y0 = tracer._constrain(x.expand_as(v), v)
    kw = tracer._integrate_kwargs(torch.float64)
    raw = integrate_rays_plain(m, y0, span, **{**kw, "newton_iters": 0})
    polished = integrate_rays_plain(m, y0, span, **kw)
    return dict(
        name=request.param, m=m, d=d, jm=jm, jd=jd, y0=y0, span=span, kw=kw,
        tracer=tracer, raw=raw, polished=polished,
    )


def _problem(case, newton_iters=3):
    d = case["d"]
    return _Problem(
        f=make_geodesic_rhs(case["m"]),
        crossing_fn=lambda y: d.crossing_indicator(y[..., 0:4]),
        newton_iters=newton_iters,
    )


def test_plain_polish_is_polish_hits_on_its_own_output(case):
    """``newton_iters=3`` is ``newton_iters=0`` followed by `_polish_hits`,
    bit for bit; only a hit's ``y`` and ``lam`` move."""
    raw, polished = case["raw"], case["polished"]
    hit = raw["status"] == HIT
    assert int(hit.sum()) >= N // 2
    y, lam = _polish_hits(_problem(case), raw, raw["y"], raw["lam"])
    assert torch.equal(polished["y"], y)
    assert torch.equal(polished["lam"], lam)
    assert torch.equal(polished["y"][~hit], raw["y"][~hit])
    assert torch.equal(polished["lam"][~hit], raw["lam"][~hit])
    assert (polished["lam"][hit] > raw["lam"][hit]).all()
    for k in _OUTPUT_KEYS:
        if k not in ("y", "lam"):
            assert torch.equal(polished[k], raw[k]), k
    assert bool(polished["polished"]) and not bool(raw["polished"])


def test_plain_polish_matches_jax_polish_of_the_same_carry(case):
    """The JAX package's `_polish_hits` (which `PallasTracer._finish` runs
    after its kernel) on the same hit-step carry: the same crossing to
    1e-10 relative to max(1, |value|), and every hit on its surface."""
    raw, polished = case["raw"], case["polished"]
    pt = PallasTracer(case["jm"], geometry=case["jd"], interpret=True)
    cf = {
        "status": jnp.asarray(raw["status"].numpy()),
        "hit_y": jnp.asarray(raw["y"].numpy()),
        "hit_k": jnp.asarray(raw["k1"].numpy()),
        "hit_dt": jnp.asarray(raw["dt"].numpy()),
        "hit_lam": jnp.asarray(raw["lam"].numpy()),
        "hit_theta": jnp.asarray(raw["hit_theta"].numpy()),
    }
    y_j, lam_j = jax_polish_hits(pt._polish_problem, cf, cf["hit_y"], cf["hit_lam"])
    hit = raw["status"].numpy() == HIT
    ref = np.concatenate([np.asarray(y_j), np.asarray(lam_j)[:, None]], axis=-1)[hit]
    got = torch.cat([polished["y"], polished["lam"][:, None]], dim=-1).numpy()[hit]
    assert (np.abs(got - ref) <= 1e-10 * np.maximum(1.0, np.abs(ref))).all()
    z = got[:, 1] * np.cos(got[:, 2])
    np.testing.assert_allclose(z, 0.0, atol=1e-9)


def test_resumed_call_does_not_polish_a_carried_hit(case):
    """A capped call polishes the hits it made; its resumption leaves them
    alone and polishes its own, so the two give the single call's outputs
    bit for bit."""
    m, y0, span, kw = case["m"], case["y0"], case["span"], case["kw"]
    # cap at the median ray's loop iterations: half the rays are done
    cap = int(case["polished"]["attempts"].double().median())
    capped = integrate_rays_plain(m, y0, span, iter_cap=cap, **kw)
    carried = capped["status"] == HIT
    assert carried.any() and (capped["status"] == StatusCodes.NoStatus).any()
    resumed = integrate_rays_plain(
        m, capped["y"], span, state={k: capped[k] for k in _STATE_KEYS}, **kw
    )
    assert torch.equal(resumed["y"][carried], capped["y"][carried])
    for k in ("y",) + _STATE_KEYS:
        assert torch.equal(resumed[k], case["polished"][k]), k


def test_finish_unpacks_a_polished_result_unchanged(case):
    tracer, polished, y0 = case["tracer"], case["polished"], case["y0"]
    gp = tracer._finish(polished, y0, case["span"][0])
    assert torch.equal(gp.x, polished["y"][:, 0:4])
    assert torch.equal(gp.v, polished["y"][:, 4:8])
    assert torch.equal(gp.lam_max, polished["lam"])
    assert torch.equal(gp.status, polished["status"])
    # through the tracer's own entry point, the same
    gp2, _ = tracer.trace(y0, case["span"])
    assert torch.equal(gp2.x, gp.x) and torch.equal(gp2.lam_max, gp.lam_max)


def test_finish_refuses_an_unpolished_result(case):
    with pytest.raises(ValueError):
        case["tracer"]._finish(case["raw"], case["y0"], case["span"][0])
    # without a geometry there is nothing to polish
    free = CudaTracer(case["m"])
    free._finish(case["raw"], case["y0"], case["span"][0])


@pytest.mark.parametrize("newton_iters", [0, -1])
def test_newton_iters_the_port_refuses(newton_iters):
    """With a geometry the tracer needs at least one Newton iteration (0
    means no polish to the integrator); the integrator refuses a negative
    count."""
    m = KerrMetric(1.0, 0.998, device="cpu")
    if newton_iters == 0:
        with pytest.raises(ValueError):
            CudaTracer(m, geometry=ThinDisc(0.0, 50.0, device="cpu"), newton_iters=0)
        assert CudaTracer(m, newton_iters=0).newton_iters == 0
        return
    y0 = torch.zeros(2, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_integrate_rays(m, y0, (0.0, 1.0), abstol=1e-9, reltol=1e-9, r_inner=1.1, r_outer=100.0, newton_iters=-1)
