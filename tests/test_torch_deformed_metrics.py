"""The port's deformed metrics against the JAX package, in f64 on the CPU:
components, the AD Jacobian that the integrator's plain version reaches,
inner radii and parameter interop; Johannsen without deviations against
Kerr; the parameter modules' default device; and the kernel's path through
its plain version for a Johannsen-Psaltis render against `PallasTracer` in
interpret mode.

Parameters: those of tests/test_metrics.py:26-32.

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

from gradus_tpu import metrics as jax_metrics  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer  # noqa: E402

from gradus_tpu_torch import metrics  # noqa: E402
from gradus_tpu_torch.geometry import DatumPlane, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import _check_kernel_config  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402

DEFORMED = {
    "JohannsenMetric": dict(M=1.0, a=0.6, alpha13=0.2, alpha22=0.1, eps3=0.5),
    "JohannsenPsaltisMetric": dict(M=1.0, a=0.6, eps3=2.0),
    "NoZMetric": dict(M=1.0, a=0.5, eps=0.3),
    "BumblebeeMetric": dict(M=1.0, a=0.2, l=0.1),
    "DilatonAxion": dict(M=1.0, a=0.5, beta=0.2, b=1.0),
}


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _pair(kind, **params):
    jm = getattr(jax_metrics, kind)(**(params or DEFORMED[kind]))
    return jm, from_numpy(kind, _params(jm), device="cpu")


def _rtheta(jm, seed, n=64):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.05 * float(jm.inner_radius()), 900.0, n)
    return r, rng.uniform(0.05, np.pi - 0.05, n)


def _close_jac(got, ref, values):
    """Each derivative to rtol 1e-12, plus 1e-12 of its component's value:
    an r- or θ-derivative far smaller than the terms it is made of (∂_θ g_θθ
    of NoZ at r ~ 700 is ~1e-3 of terms ~r²) carries their rounding, which
    two correct AD implementations do not share."""
    for g, r, v in zip(got, ref, values):
        r = np.asarray(r)
        assert (np.abs(g.numpy() - r) <= 1e-12 * (np.abs(r) + np.abs(np.asarray(v)))).all()


@pytest.mark.parametrize("kind", DEFORMED)
def test_components5_match_jax(kind):
    jm, tm = _pair(kind)
    r, th = _rtheta(jm, 1)
    got = tm.components5(torch.as_tensor(r), torch.as_tensor(th))
    ref = jm.components(jnp.asarray(r), jnp.asarray(th))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[..., i]), rtol=1e-12)


@pytest.mark.parametrize("kind", DEFORMED)
def test_ad_jacobian_matches_jax(kind):
    jm, tm = _pair(kind)
    r, th = _rtheta(jm, 2)
    g_t, dr_t, dth_t = tm.components5_jac(torch.as_tensor(r), torch.as_tensor(th))
    g_j, dr_j, dth_j = jm.components5_jac(jnp.asarray(r), jnp.asarray(th))
    for g, ref in zip(g_t, g_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-12)
    _close_jac(dr_t, dr_j, g_j)
    _close_jac(dth_t, dth_j, g_j)


@pytest.mark.parametrize("kind", DEFORMED)
def test_inner_radius_matches_jax(kind):
    jm, tm = _pair(kind)
    np.testing.assert_allclose(float(tm.inner_radius()), float(jm.inner_radius()), rtol=1e-12)
    assert type(tm).__name__ == kind
    for name, value in _params(jm).items():
        assert float(getattr(tm, name)) == float(value)


def test_johannsen_without_deviations_is_kerr():
    """Zero deviations: the Johannsen closed form is Kerr's, and so is its
    AD Jacobian (Kerr's is hand-derived)."""
    j = metrics.JohannsenMetric(1.0, 0.9, device="cpu")
    k = metrics.KerrMetric(1.0, 0.9, device="cpu")
    r, th = _rtheta(jax_metrics.KerrMetric(M=1.0, a=0.9), 3)
    r, th = torch.as_tensor(r), torch.as_tensor(th)
    for got, ref in zip(j.components5_jac(r, th), k.components5_jac(r, th)):
        for g, h, v in zip(got, ref, k.components5(r, th)):
            assert ((g - h).abs() <= 1e-12 * (h.abs() + v.abs())).all()


def test_dilaton_axion_guarded_ratios():
    """β = 0 makes every β-ratio 0 whatever the divisors; a zero divisor
    is replaced by 1 (deformed.py:165-171)."""
    bb, ba, bab = metrics.DilatonAxion(1.0, 0.0, 0.0, 0.0, device="cpu").guarded_ratios()
    assert (float(bb), float(ba), float(bab)) == (0.0, 0.0, 0.0)
    bb, ba, bab = metrics.DilatonAxion(1.0, 0.0, 0.2, 0.5, device="cpu").guarded_ratios()
    assert (float(bb), float(ba), float(bab)) == (0.4, 0.2, 0.2)


def test_schwarzschild_is_kerr_without_spin():
    m = metrics.SchwarzschildMetric(2.0, device="cpu")
    assert type(m) is metrics.KerrMetric and (float(m.M), float(m.a)) == (2.0, 0.0)


@pytest.mark.parametrize(
    "make",
    [
        lambda: metrics.KerrMetric(1.0, 0.5),
        lambda: metrics.JohannsenPsaltisMetric(1.0, 0.6, 2.0),
        lambda: ThinDisc(0.0, 50.0),
        lambda: DatumPlane(0.0),
        lambda: from_numpy("NoZMetric", dict(M=1.0, a=0.5, eps=0.3)),
    ],
    ids=["KerrMetric", "JohannsenPsaltisMetric", "ThinDisc", "DatumPlane", "from_numpy"],
)
def test_parameter_modules_default_to_the_card(make):
    """Without a device a module lands on the card; where torch has no CUDA
    device that raises (there is no fallback to the CPU)."""
    if torch.cuda.is_available():
        assert next(make().buffers()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


@pytest.mark.parametrize("kind", [*DEFORMED, "KerrMetric"])
def test_kernel_takes_the_deformed_metrics(kind):
    m = getattr(metrics, kind)(**DEFORMED.get(kind, dict(M=1.0, a=0.5)), device="cpu")
    _check_kernel_config(m, ThinDisc(0.0, 50.0, device="cpu"), torch.float32)


# --- the kernel's path through its plain version -------------------------------


@pytest.fixture(scope="module")
def jp_traces():
    """32 rays from r = 1000, i = 60° against ThinDisc(0, 50), through
    `CudaTracer` (the plain version on CPU tensors, with the AD Jacobian)
    and through `PallasTracer` in interpret mode (jax.jvp inside the
    kernel), after each one's polish."""
    jm, tm = _pair("JohannsenPsaltisMetric")
    jd = JaxThinDisc(0.0, 50.0)
    x_obs = np.array([0.0, 1000.0, math.radians(60.0), 0.0])
    rng = np.random.default_rng(4)
    A, B = rng.uniform(-20.0, 20.0, 32), rng.uniform(-20.0, 20.0, 32)
    xj = jnp.asarray(x_obs)
    vj = jax_map_impact(jm, xj, jnp.asarray(A), jnp.asarray(B))
    span = (0.0, 2000.0)
    gp_j = PallasTracer(jm, geometry=jd, interpret=True)(jnp.broadcast_to(xj, vj.shape), vj, span)
    tracer = CudaTracer(tm, geometry=from_numpy("ThinDisc", _params(jd), device="cpu"))
    gp_t = tracer(torch.as_tensor(x_obs).expand(32, 4), torch.as_tensor(np.asarray(vj)), span)
    return gp_j, gp_t, tracer.last_aux


def test_jp_tracer_statuses_match_pallas_tracer(jp_traces):
    gp_j, gp_t, aux = jp_traces
    sj = np.asarray(gp_j.status)
    np.testing.assert_array_equal(gp_t.status.numpy(), sj)
    assert (sj == StatusCodes.IntersectedWithGeometry).sum() > 10
    assert int(aux["unfinished"]) == 0


@pytest.mark.parametrize("field", ["x", "lam_max"])
def test_jp_tracer_hits_match_pallas_tracer(jp_traces, field):
    """Polished hits within 1e-8 relative to max(1, |value|)."""
    gp_j, gp_t, _ = jp_traces
    hit = np.asarray(gp_j.status) == StatusCodes.IntersectedWithGeometry
    ref = np.asarray(getattr(gp_j, field))[hit]
    got = getattr(gp_t, field).numpy()[hit]
    assert (np.abs(got - ref) <= 1e-8 * np.maximum(1.0, np.abs(ref))).all()
