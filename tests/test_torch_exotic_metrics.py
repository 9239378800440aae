"""The port's remaining metrics against the JAX package, in f64 on the CPU:
Kerr-Newman, the three exotic spacetimes, the two flat ones and first-order
Kerr. Components, inner radii, the AD Jacobian that the integrator's plain
version reaches, parameter interop, Kerr-Newman's potential and Faraday
tensor, the smoothed step, the Carter constants; then each metric's plain
integrator through `CudaTracer` against `PallasTracer` in interpret mode.

Parameters: those of tests/test_metrics.py:22-36 (first-order Kerr at the
spin of the other Kerr-like ones, a = 0.5).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gradus_tpu import metrics as jax_metrics  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer  # noqa: E402
from gradus_tpu.metrics.kerr_first_order import KerrSpacetimeFirstOrder as JaxFirstOrder  # noqa: E402
from gradus_tpu.metrics.kerr_first_order import carter_constants as jax_carter  # noqa: E402
from gradus_tpu.utils.linalg import smooth_step_interpolate as jax_smooth_step  # noqa: E402

from gradus_tpu_torch import metrics  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import _KERNEL_METRICS, _check_kernel_config  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.utils import smooth_step_interpolate  # noqa: E402

METRICS = {
    "KerrNewmanMetric": dict(M=1.0, a=0.5, Q=0.3),
    "MorrisThorneWormhole": dict(b=1.0),
    "KerrRefractive": dict(M=1.0, a=0.5, n=1.2, corona_radius=20.0),
    "KerrDarkMatter": dict(M=1.0, a=0.5),
    "SphericalMetric": {},
    "CartesianMetric": {},
    "KerrSpacetimeFirstOrder": dict(M=1.0, a=0.5),
}
SAMPLE_POINTS = [(4.2, 0.9), (6.0, np.pi / 2), (12.0, 1.2), (50.0, 2.0), (400.0, 0.4)]
# the render goldens' camera (tests/test_render.py): r = 100, i = 85°, λ ≤ 200
GOLDEN_X_OBS = np.array([0.0, 100.0, math.radians(85.0), 0.0])
SPAN = (0.0, 200.0)
HIT = StatusCodes.IntersectedWithGeometry


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _pair(kind):
    cls = JaxFirstOrder if kind == "KerrSpacetimeFirstOrder" else getattr(jax_metrics, kind)
    jm = cls(**METRICS[kind])
    return jm, from_numpy(kind, _params(jm), device="cpu")


def _points():
    r, th = np.array(SAMPLE_POINTS).T
    return r, th


def _close(got, ref, values=None):
    """rtol 1e-12; a derivative also gets 1e-12 of its component's value: an
    r- or θ-derivative far smaller than the terms it is made of carries
    their rounding, which two correct AD implementations do not share."""
    ref = np.asarray(ref)
    scale = np.abs(ref) if values is None else np.abs(ref) + np.abs(np.asarray(values))
    assert (np.abs(got.numpy() - ref) <= 1e-12 * scale).all()


@pytest.mark.parametrize("kind", METRICS)
def test_components_match_jax(kind):
    jm, tm = _pair(kind)
    r, th = _points()
    got = tm.components(torch.as_tensor(r), torch.as_tensor(th))
    ref = jm.components(jnp.asarray(r), jnp.asarray(th))
    for i in range(5):
        _close(got[..., i], ref[..., i])


@pytest.mark.parametrize("kind", METRICS)
def test_ad_jacobian_matches_jax(kind):
    jm, tm = _pair(kind)
    r, th = _points()
    g_t, dr_t, dth_t = tm.components5_jac(torch.as_tensor(r), torch.as_tensor(th))
    g_j, dr_j, dth_j = jm.components5_jac(jnp.asarray(r), jnp.asarray(th))
    for g, ref in zip(g_t, g_j):
        _close(g, ref)
    for got, ref in ((dr_t, dr_j), (dth_t, dth_j)):
        for g, d, v in zip(got, ref, g_j):
            _close(g, d, v)


@pytest.mark.parametrize("kind", METRICS)
def test_inner_radius_and_interop_match_jax(kind):
    jm, tm = _pair(kind)
    assert float(tm.inner_radius()) == pytest.approx(float(jm.inner_radius()), rel=1e-12, abs=0.0)
    assert type(tm).__name__ == kind and tm.device.type == "cpu"
    for name, value in _params(jm).items():
        assert float(getattr(tm, name)) == float(value)
    # every one of them runs through the kernel
    _check_kernel_config(tm, ThinDisc(0.0, 40.0, device="cpu"), torch.float32)
    assert type(tm) in _KERNEL_METRICS


def test_kerr_newman_potential_and_faraday_tensor_match_jax():
    jm, tm = _pair("KerrNewmanMetric")
    rng = np.random.default_rng(3)
    r, th = rng.uniform(2.0, 50.0, 16), rng.uniform(0.1, np.pi - 0.1, 16)
    A_t = tm.electromagnetic_potential(torch.as_tensor(r), torch.as_tensor(th))
    A_j = jm.electromagnetic_potential(jnp.asarray(r), jnp.asarray(th))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-12, atol=1e-15)
    for k in range(4):
        x = np.array([0.0, r[k], th[k], 0.3])
        F_t = metrics.faraday_tensor(tm, torch.as_tensor(x))
        F_j = jax_metrics.faraday_tensor(jm, jnp.asarray(x))
        np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-12, atol=1e-15)
    e_t = tm.ergosphere_radius(torch.as_tensor(th))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(jm.ergosphere_radius(jnp.asarray(th))), rtol=1e-12)


def test_smooth_step_matches_jax():
    """On both sides of the step, across it and at its ends, and on the
    dual numbers of the plain AD Jacobian (the derivative of the step)."""
    x = np.concatenate([np.linspace(15.0, 25.0, 41), 20.0 + np.array([-1.25, 1.25, -1e-4, 1e-4, 0.0])])
    got = smooth_step_interpolate(torch.as_tensor(x), torch.tensor(20.0, dtype=torch.float64))
    ref = jax_smooth_step(jnp.asarray(x), 20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-14)
    assert got[0] == 1.0 and got[40] == 0.0
    d_ref = jax.vmap(jax.grad(lambda v: jax_smooth_step(v, 20.0)))(jnp.asarray(x))
    _, d_t = torch.func.jvp(
        lambda v: smooth_step_interpolate(v, torch.tensor(20.0, dtype=torch.float64)),
        (torch.as_tensor(x),),
        (torch.ones(len(x), dtype=torch.float64),),
    )
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_ref), rtol=1e-13, atol=1e-14)


def test_carter_constants_match_jax():
    jm, tm = _pair("KerrSpacetimeFirstOrder")
    rng = np.random.default_rng(5)
    x = np.stack([np.zeros(8), rng.uniform(4, 40, 8), rng.uniform(0.3, 2.8, 8), np.zeros(8)], -1)
    v = np.concatenate([np.ones((8, 1)), 0.05 * rng.normal(size=(8, 3))], -1)
    for mu in (0.0, 1.0):
        got = metrics.carter_constants(tm, torch.as_tensor(x), torch.as_tensor(v), mu)
        ref = jax_carter(jm, jnp.asarray(x), jnp.asarray(v), mu)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


def test_minkowski_matrix():
    np.testing.assert_array_equal(metrics.minkowski_matrix().numpy(), np.diag([-1.0, 1.0, 1.0, 1.0]))


# --- the kernel's path through its plain version -------------------------------

# CartesianMetric reads the state's (x, y, z) where the disc reads (r, θ, φ),
# so a ThinDisc is meaningless there, and a straight ray's error estimate is
# roundoff, whose step sizes (growing tenfold a step) two correct
# implementations do not share: it is traced without a geometry, and its
# endpoints are held against the analytic line.
NO_DISC = {"CartesianMetric"}
# The refractive index steps from 1 to n within ~1e-4 of corona_radius and
# the dark-matter mass has a kink in its second derivative at r_s and
# r_s + delta_r: across them the embedded error estimate does not see the
# error it makes, so two step sequences that differ by rounding end 1e-7 to
# 1e-5 apart (the kernel's C++ built with and without FMA contraction, on a
# CPU: up to 6.3e-6 and 4.3e-6 relative). Those two are held to 1e-5.
HIT_RTOL = {"KerrRefractive": 1e-5, "KerrDarkMatter": 1e-5}


def _offsets(n, seed=4):
    """Image-plane offsets ρ ∈ [6.5, 9.5] at uniform angles: outside every
    metric's critical curve (ρ ≈ 4.8-6.0 here), whose rays circle the photon
    orbit and turn a rounding difference into a different hit (Kerr a = 0.5
    through both packages: 1.3e-4 relative on one ray of a uniform ±9.5
    field)."""
    rng = np.random.default_rng(seed)
    rho, phi = rng.uniform(6.5, 9.5, n), rng.uniform(0.0, 2 * np.pi, n)
    return rho * np.cos(phi), rho * np.sin(phi)


@pytest.fixture(scope="module", params=list(METRICS))
def traces(request):
    """32 rays at the render goldens' camera (`_offsets`) against
    ThinDisc(0, 40) (no geometry for CartesianMetric), through `CudaTracer` (the plain version
    on CPU tensors, the AD Jacobian) and `PallasTracer` in interpret mode
    (jax.jvp inside the kernel), after each one's polish."""
    kind = request.param
    jm, tm = _pair(kind)
    A, B = _offsets(32)
    xj = jnp.asarray(GOLDEN_X_OBS)
    vj = jax_map_impact(jm, xj, jnp.asarray(A), jnp.asarray(B))
    jd = None if kind in NO_DISC else JaxThinDisc(0.0, 40.0)
    gp_j = PallasTracer(jm, geometry=jd, interpret=True)(jnp.broadcast_to(xj, vj.shape), vj, SPAN)
    td = None if jd is None else from_numpy("ThinDisc", _params(jd), device="cpu")
    tracer = CudaTracer(tm, geometry=td)
    gp_t = tracer(torch.as_tensor(GOLDEN_X_OBS).expand(32, 4), torch.as_tensor(np.asarray(vj)), SPAN)
    return kind, gp_j, gp_t, tracer.last_aux


def test_tracer_statuses_match_pallas_tracer(traces):
    kind, gp_j, gp_t, aux = traces
    sj = np.asarray(gp_j.status)
    np.testing.assert_array_equal(gp_t.status.numpy(), sj)
    assert int(aux["unfinished"]) == 0
    if kind not in NO_DISC:
        assert (sj == HIT).sum() >= 8


def test_tracer_hits_match_pallas_tracer(traces):
    """Polished hits within 1e-9 relative to max(1, |value|) (HIT_RTOL for
    the two non-smooth metrics); rays that reach λ1 end at λ1."""
    kind, gp_j, gp_t, _ = traces
    sj = np.asarray(gp_j.status)
    rtol = HIT_RTOL.get(kind, 1e-9)
    for field in ("x", "lam_max"):
        ref = np.asarray(getattr(gp_j, field))[sj == HIT]
        got = getattr(gp_t, field).numpy()[sj == HIT]
        assert (np.abs(got - ref) <= rtol * np.maximum(1.0, np.abs(ref))).all()
    done = sj == StatusCodes.NoStatus
    np.testing.assert_allclose(gp_t.lam_max.numpy()[done], SPAN[1], rtol=1e-12)


def _spherical_to_cartesian(x):
    r, th, ph = x[..., 1], x[..., 2], x[..., 3]
    return np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)


@pytest.mark.parametrize("kind", ["SphericalMetric", "CartesianMetric"])
def test_flat_rays_are_straight_lines(kind):
    """An answer independent of both packages: in flat space the plain
    integrator's endpoints lie on x(λ) = x₀ + vλ, in Cartesian terms for
    the spherical chart. The Cartesian chart's right-hand side is zero, so
    its solve is exact up to rounding (1e-12 relative to max(1, |x|)). The
    spherical chart's is not: its global error after ~100 steps at reltol
    1e-9 is held to 1e-8 relative to max(1, |x|) (6.8e-9 measured on 256
    rays)."""
    m = getattr(metrics, kind)(device="cpu")
    rng = np.random.default_rng(6)
    x0 = torch.as_tensor(GOLDEN_X_OBS).expand(32, 4)
    v = map_impact_parameters(
        m, x0[0], torch.as_tensor(rng.uniform(-9.5, 9.5, 32)), torch.as_tensor(rng.uniform(-9.5, 9.5, 32))
    )
    geometry = None if kind in NO_DISC else ThinDisc(0.0, 40.0, device="cpu")
    gp = CudaTracer(m, geometry=geometry)(x0, v, SPAN)
    v0, x, lam = gp.v_init.numpy(), gp.x.numpy(), gp.lam_max.numpy()
    if kind == "CartesianMetric":
        line = x0.numpy()[:, 1:] + v0[:, 1:] * lam[:, None]
        end = x[:, 1:]
    else:
        r, th, ph = GOLDEN_X_OBS[1:]
        J = np.array(
            [
                [np.sin(th) * np.cos(ph), r * np.cos(th) * np.cos(ph), -r * np.sin(th) * np.sin(ph)],
                [np.sin(th) * np.sin(ph), r * np.cos(th) * np.sin(ph), r * np.sin(th) * np.cos(ph)],
                [np.cos(th), -r * np.sin(th), 0.0],
            ]
        )
        line = _spherical_to_cartesian(GOLDEN_X_OBS) + (v0[:, 1:] @ J.T) * lam[:, None]
        end = _spherical_to_cartesian(x)
        assert (gp.status.numpy() == HIT).sum() >= 8
    rtol = 1e-12 if kind == "CartesianMetric" else 1e-8
    dist = np.linalg.norm(end - line, axis=-1)
    assert (dist <= rtol * np.maximum(1.0, np.linalg.norm(line, axis=-1))).all()
