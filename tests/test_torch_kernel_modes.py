"""The integrator kernel's modes through its plain version, against the JAX
package in f64 on the CPU: sampled events, segmented (capped, then
resumed) passes and their `unfinished` counter, crossing counters
(``terminate_on_hit=False``) and timelike rays.

Rays: the flagship camera (Kerr a = 0.998, r = 1000, i = 75°) against
ThinDisc(0, 50), at image-plane offsets ρ ∈ [7.5, 12] (`_offsets`), outside
the critical curve, whose rays circle the photon orbit and turn a rounding
difference between two correct implementations into a different hit.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import DatumPlane as JaxDatumPlane  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer, pallas_integrate_rays  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch.geometry import DatumPlane  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import _mid_flight, integrate_rays_plain  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402

SPAN = (0.0, 2200.0)
N = 48
HIT = StatusCodes.IntersectedWithGeometry
# A tail pass: every ray is capped at 128 loop iterations, then the
# survivors (fewer than TAIL of these 48) resume in a 32-ray bucket.
SEGMENT, TAIL = 128, 32


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _offsets(n, seed=8):
    rng = np.random.default_rng(seed)
    rho, phi = rng.uniform(7.5, 12.0, n), rng.uniform(0.0, 2 * np.pi, n)
    return rho * np.cos(phi), rho * np.sin(phi)


@pytest.fixture(scope="module")
def setup():
    jm = JaxKerr(M=1.0, a=0.998)
    jd = JaxThinDisc(0.0, 50.0)
    x_obs = jnp.asarray([0.0, 1000.0, math.radians(75.0), 0.0])
    A, B = _offsets(N)
    v = jax_map_impact(jm, x_obs, jnp.asarray(A), jnp.asarray(B))
    xs = jnp.broadcast_to(x_obs, v.shape)
    tm = from_numpy("KerrMetric", _params(jm), device="cpu")
    td = from_numpy("ThinDisc", _params(jd), device="cpu")
    return dict(jm=jm, jd=jd, xs=xs, v=v, tm=tm, td=td, xt=torch.as_tensor(np.array(xs)), vt=torch.as_tensor(np.array(v)))


def _hits_agree(gp_j, gp_t, rtol=1e-9):
    """Statuses identical; polished hits within ``rtol`` relative to
    max(1, |value|)."""
    sj = np.asarray(gp_j.status)
    np.testing.assert_array_equal(gp_t.status.numpy(), sj)
    hit = sj == HIT
    assert hit.sum() >= 10
    for field in ("x", "lam_max"):
        ref = np.asarray(getattr(gp_j, field))[hit]
        got = getattr(gp_t, field).numpy()[hit]
        assert (np.abs(got - ref) <= rtol * np.maximum(1.0, np.abs(ref))).all()


def test_sampled_events_match_pallas_tracer(setup):
    s = setup
    gp_j = PallasTracer(s["jm"], geometry=s["jd"], event_method="sampled", interpret=True)(s["xs"], s["v"], SPAN)
    tracer = CudaTracer(s["tm"], geometry=s["td"], event_method="sampled")
    _hits_agree(gp_j, tracer(s["xt"], s["vt"], SPAN))
    assert int(tracer.last_aux["unfinished"]) == 0


@pytest.fixture(scope="module")
def segmented(setup):
    """The port's single pass and its segmented trace, on CPU tensors."""
    s = setup
    single = CudaTracer(s["tm"], geometry=s["td"])
    gp_1 = single(s["xt"], s["vt"], SPAN)
    seg = CudaTracer(s["tm"], geometry=s["td"], segment_iters=SEGMENT, tail_bucket=TAIL)
    gp_2 = seg(s["xt"], s["vt"], SPAN)
    y0 = single._constrain(s["xt"], s["vt"])
    capped = integrate_rays_plain(s["tm"], y0, SPAN, iter_cap=SEGMENT, **single._integrate_kwargs(torch.float64))
    return dict(gp_1=gp_1, aux_1=single.last_aux, gp_2=gp_2, aux_2=seg.last_aux, survivors=int(_mid_flight(capped, SPAN[1]).sum()))


def test_segmented_trace_equals_single_pass(segmented):
    """The resumed pass restores the exact carry: the image is the single
    pass's bit for bit."""
    s = segmented
    assert 0 < s["survivors"] <= TAIL  # the tail pass really ran, and held every survivor
    assert int(s["aux_2"]["unfinished"]) == 0
    torch.testing.assert_close(s["gp_2"].status, s["gp_1"].status, rtol=0, atol=0)
    for field in ("x", "v", "lam_max"):
        torch.testing.assert_close(getattr(s["gp_2"], field), getattr(s["gp_1"], field), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(s["aux_2"]["steps"], s["aux_1"]["steps"], rtol=0, atol=0)
    torch.testing.assert_close(s["aux_2"]["attempts"], s["aux_1"]["attempts"], rtol=0, atol=0)


def test_segmented_trace_matches_pallas_segmented(setup, segmented):
    s = setup
    pt = PallasTracer(s["jm"], geometry=s["jd"], interpret=True, segment_iters=SEGMENT, tail_bucket=TAIL, tail_tile_rows=8)
    _hits_agree(pt(s["xs"], s["v"], SPAN), segmented["gp_2"])


def test_unfinished_counter(setup):
    """An undersized tail bucket is detected, not silent
    (tests/test_pallas_solver.py:96-112): the survivors that never resumed
    stay mid-flight and are counted, as in the JAX package."""
    import jax

    s = setup
    pt = PallasTracer(s["jm"], geometry=s["jd"], interpret=True, segment_iters=24, tail_bucket=8)
    _, aux_j = jax.jit(lambda y: pt.trace(y, SPAN))(pt._constrain(s["xs"], s["v"]))
    tracer = CudaTracer(s["tm"], geometry=s["td"], segment_iters=24, tail_bucket=8)
    _, aux_t = tracer.trace(tracer._constrain(s["xt"], s["vt"]), SPAN)
    assert int(aux_t["unfinished"]) > 0
    assert int(aux_t["unfinished"]) == int(aux_j["unfinished"])


def test_crossing_counters_match_nine_slot_pallas_run(setup):
    """``terminate_on_hit=False`` against DatumPlane(0). The JAX kernel
    counts in the last state slot; run with a 9-slot state whose slot 8 has
    a zero right-hand side, it counts there without touching the geodesic.
    Its RMS error norm divides by 9 with slot 8 contributing 0, so the port
    runs with abstol and reltol scaled by √(9/8): the same norm and the same
    initial step up to rounding. Statuses and counts are identical; rays
    that reach λ1 end there, at the same position to 1e-7 relative."""
    s = setup
    pt = PallasTracer(s["jm"], geometry=JaxDatumPlane(0.0), interpret=True)
    y0 = pt._constrain(s["xs"], s["v"])
    y9 = jnp.concatenate([y0, jnp.zeros_like(y0[:, :1])], axis=-1)

    def f9(ys):
        return pt._f_cm(ys[:8]) + (jnp.zeros_like(ys[0]),)

    raw_j = pallas_integrate_rays(
        f9, y9, SPAN, abstol=pt.abstol, reltol=pt.reltol, r_inner=pt.r_inner, r_outer=pt.r_outer,
        crossing_cm=pt._crossing_cm, hit_cm=pt._hit_cm, terminate_on_hit=False, interpret=True,
    )
    k = math.sqrt(9.0 / 8.0)
    raw_t = integrate_rays_plain(
        s["tm"], torch.as_tensor(np.array(y0)), SPAN, geometry=DatumPlane(0.0, device="cpu"),
        abstol=pt.abstol * k, reltol=pt.reltol * k, r_inner=pt.r_inner, r_outer=pt.r_outer, terminate_on_hit=False,
    )
    status = np.asarray(raw_j["status"])
    np.testing.assert_array_equal(raw_t["status"].numpy(), status)
    counts = np.asarray(raw_j["y"][:, 8]).astype(np.int32)
    np.testing.assert_array_equal(raw_t["crossings"].numpy(), counts)
    assert (counts >= 2).sum() >= 2 and (counts == 1).sum() >= 10
    done = (status == StatusCodes.NoStatus) & (np.asarray(raw_j["failed"]) == 0)
    assert done.sum() >= 10
    np.testing.assert_allclose(raw_t["lam"].numpy()[done], SPAN[1], rtol=1e-12)
    ref = np.asarray(raw_j["y"])[done, :8]
    got = raw_t["y"].numpy()[done]
    assert (np.abs(got - ref) <= 1e-7 * np.maximum(1.0, np.abs(ref))).all()


def test_timelike_rays_match_pallas_tracer(setup):
    """``mu = 1``: the constraint makes the rays timelike; neither kernel's
    right-hand side reads mu."""
    s = setup
    gp_j = PallasTracer(s["jm"], geometry=s["jd"], mu=1.0, interpret=True)(s["xs"], s["v"], SPAN)
    tracer = CudaTracer(s["tm"], geometry=s["td"], mu=1.0)
    gp_t = tracer(s["xt"], s["vt"], SPAN)
    _hits_agree(gp_j, gp_t)
    # timelike: g(v, v) = -1 at the start
    g = s["tm"].metric(gp_t.x_init)
    norm = torch.einsum("ni,nij,nj->n", gp_t.v_init, g, gp_t.v_init)
    torch.testing.assert_close(norm, torch.full_like(norm, -1.0), rtol=0, atol=1e-10)
