"""The port's `trace_geodesics` held to the physics of tests/test_integrate.py,
in f64 on the CPU: the Tsit5 step's order, conservation of E, L_z and the
null norm, capture and escape around b = 3√3, a straight line and a disc hit
in flat space, a Kerr disc batch, and the forward-mode derivative of a hit
radius by `torch.func.jvp` (through the solver's loop, its nested jvp of the
crossing indicator and the Newton polish) against a central difference and
the JAX reference's primal.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics as jax_trace  # noqa: E402
from gradus_tpu.metrics import SchwarzschildMetric as JaxSchwarzschild  # noqa: E402

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geodesics.equation import constrain_all  # noqa: E402
from gradus_tpu_torch.geodesics.tetrads import dotproduct  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.integrate.tsit5 import tsit5_step  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric, SphericalMetric  # noqa: E402

F64 = dict(dtype=torch.float64)


def _t(*vals):
    return torch.tensor(vals, **F64)


def _cartesian(x):
    r, th, ph = (float(v) for v in x[1:4])
    return np.array([r * math.sin(th) * math.cos(ph), r * math.sin(th) * math.sin(ph), r * math.cos(th)])


def test_tsit5_convergence_order():
    """Fixed-step integration of y' = -y from 0 to 1 converges at 5th order."""
    errors = []
    for n in (8, 16, 32):
        dt = torch.full((1,), 1.0 / n, **F64)
        y = torch.ones((1, 1), **F64)
        for _ in range(n):
            y, _, _, _ = tsit5_step(lambda u: -u, y, dt)
        errors.append(abs(float(y[0, 0]) - math.exp(-1.0)))
    assert math.log2(errors[0] / errors[1]) > 4.5 and math.log2(errors[1] / errors[2]) > 4.5


def test_energy_angular_momentum_conservation():
    """E = -g_tν v^ν and L_z = g_φν v^ν conserved along a Kerr photon orbit
    at the solver tolerance, and the null norm kept."""
    m = KerrMetric(1.0, 0.998, device="cpu")
    x = _t(0.0, 100.0, math.pi / 2 - 0.4, 0.0)
    v = constrain_all(m, x, _t(0.0, -1.0, 0.01, 2e-4))
    gp = trace_geodesics(m, x, v, (0.0, 500.0), constrain=False)
    assert int(gp.status) == StatusCodes.NoStatus and float(gp.lam_max) == 500.0

    def E_L(x, v):
        g = m.metric(x)
        return -(g[0, 0] * v[0] + g[0, 3] * v[3]), g[3, 3] * v[3] + g[0, 3] * v[0]

    for end, start in zip(E_L(gp.x, gp.v), E_L(x, v)):
        np.testing.assert_allclose(float(end), float(start), rtol=1e-7)
    assert abs(float(dotproduct(m.metric(gp.x), gp.v, gp.v))) < 1e-7


@pytest.mark.parametrize("b, captured", [(5.0, True), (5.4, False)])
def test_schwarzschild_capture_escape(b, captured):
    """Critical impact parameter b_c = 3√3 M ≈ 5.196: below → capture
    (WithinInnerBoundary), above → escape past the observer radius."""
    m = KerrMetric(1.0, 0.0, device="cpu")
    r0 = 1000.0
    x = _t(0.0, r0, math.pi / 2, 0.0)
    v = constrain_all(m, x, _t(0.0, -1.0, 0.0, b / r0**2 / (1 - 2 / r0)))
    gp = trace_geodesics(m, x, v, (0.0, 4000.0))
    if captured:
        assert int(gp.status) == StatusCodes.WithinInnerBoundary
    else:
        assert int(gp.status) in (StatusCodes.NoStatus, StatusCodes.OutOfDomain)
        assert float(gp.x[1]) > 100.0


def test_flat_space_straight_line():
    """In spherical Minkowski the ray is a straight line: the cartesian
    endpoint against the analytic line."""
    m = SphericalMetric(device="cpu")
    r, th, ph = 50.0, math.pi / 3, 0.3
    x = _t(0.0, r, th, ph)
    dr, dth, dph = -1.0, 0.02, 0.01
    v = constrain_all(m, x, _t(0.0, dr, dth, dph))
    lam_end = 20.0
    gp = trace_geodesics(m, x, v, (0.0, lam_end), chart_outer=1e5)
    assert int(gp.status) == StatusCodes.NoStatus
    J = np.array(
        [
            [math.sin(th) * math.cos(ph), r * math.cos(th) * math.cos(ph), -r * math.sin(th) * math.sin(ph)],
            [math.sin(th) * math.sin(ph), r * math.cos(th) * math.sin(ph), r * math.sin(th) * math.cos(ph)],
            [math.cos(th), -r * math.sin(th), 0.0],
        ]
    )
    expected = _cartesian(x) + lam_end * (J @ np.array([dr, dth, dph]))
    np.testing.assert_allclose(_cartesian(gp.x), expected, rtol=1e-7, atol=1e-7)


def test_thin_disc_intersection_flat_space():
    """Flat space, a ray from above the plane moving down: the polished hit
    is where the straight line crosses z = 0."""
    m = SphericalMetric(device="cpu")
    x = _t(0.0, 30.0, 0.3, 0.0)
    v = constrain_all(m, x, _t(0.0, -0.8, 0.05, 0.0))
    d = ThinDisc(0.0, 100.0, device="cpu")
    gp = trace_geodesics(m, x, v, (0.0, 200.0), geometry=d, gtol=1e-6, chart_outer=1e4)
    assert int(gp.status) == StatusCodes.IntersectedWithGeometry
    assert abs(float(gp.x[1] * torch.cos(gp.x[2]))) < 1e-4
    vz = math.cos(0.3) * -0.8 - 30.0 * math.sin(0.3) * 0.05
    np.testing.assert_allclose(float(gp.lam_max), -_cartesian(x)[2] / vz, rtol=1e-4)


def test_kerr_disc_hit_batch():
    """Rays from an observer toward a Kerr disc: the wide ray (α = 30) hits
    the disc at 10 < ρ < 50."""
    m = KerrMetric(1.0, 0.9, device="cpu")
    d = ThinDisc(0.0, 50.0, device="cpu")
    x = _t(0.0, 1000.0, math.radians(75.0), 0.0)
    v = map_impact_parameters(m, x, _t(0.0, 3.0, -6.0, 10.0, 30.0), torch.full((5,), 2.0, **F64))
    gp = trace_geodesics(m, x.expand(5, 4), v, (0.0, 2000.0), geometry=d)
    statuses = gp.status.numpy()
    assert (statuses != StatusCodes.NoStatus).any()
    assert statuses[4] == StatusCodes.IntersectedWithGeometry
    assert 10.0 < float(gp.x[4, 1] * torch.sin(gp.x[4, 2])) < 50.0


def test_trace_differentiable_forward():
    """∂r_hit/∂β by `torch.func.jvp` through the whole trace (the reference
    pushes ForwardDiff duals through the ODE solve the same way; JAX's test
    of it is slow-marked, the port's is not), against a central difference
    at the reference's rtol 2e-3; the primal against the JAX reference's.
    Then ∂r_hit/∂M through the metric's mass parameter, the same way."""
    d = ThinDisc(0.0, 100.0, device="cpu")
    x = _t(0.0, 100.0, math.radians(60.0), 0.0)

    def hit_radius(beta, M=torch.tensor(1.0, **F64)):
        m = KerrMetric(M, 0.0, device="cpu")
        v = map_impact_parameters(m, x, torch.zeros_like(beta), beta)
        return trace_geodesics(m, x, v, (0.0, 300.0), geometry=d).x[..., 1]

    beta0, eps = torch.tensor(10.0, **F64), 1e-3
    r0, grad = torch.func.jvp(hit_radius, (beta0,), (torch.ones_like(beta0),))
    assert float(r0) > 6.0
    fd = (hit_radius(beta0 + eps) - hit_radius(beta0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(grad), float(fd), rtol=2e-3)

    jm, jx = JaxSchwarzschild(M=1.0), jnp.asarray(x.numpy())
    jv = jax_map_impact(jm, jx, jnp.asarray(0.0), jnp.asarray(10.0))
    r_jax = float(jax_trace(jm, jx, jv, (0.0, 300.0), geometry=JaxThinDisc(0.0, 100.0)).x[1])
    np.testing.assert_allclose(float(r0), r_jax, rtol=1e-9)  # measured 2e-15

    M0 = torch.tensor(1.0, **F64)
    r_M, grad_M = torch.func.jvp(lambda M: hit_radius(beta0, M), (M0,), (torch.ones_like(M0),))
    fd_M = (hit_radius(beta0, M0 + eps) - hit_radius(beta0, M0 - eps)) / (2 * eps)
    assert float(r_M) == float(r0) and abs(float(grad_M)) > 1e-2
    np.testing.assert_allclose(float(grad_M), float(fd_M), rtol=2e-3)
