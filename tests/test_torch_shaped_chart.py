"""The θ-dependent inner chart (`PoloidalShape`, `event_horizon_chart`)
against the JAX package's, in f64 on the CPU: tests/test_charts_doughnut.py's
three chart tests, each also held to the JAX package's results on the
same rays. The chart's radii agree to 1e-12; the traces' statuses are
equal, and captured rays end within r_min(θ) + 0.3 of the interpolated
shape."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402

from gradus_tpu_torch.integrate import PoloidalShape, StatusCodes, event_horizon_chart, trace_geodesics  # noqa: E402
from gradus_tpu_torch.interop import from_numpy, poloidal_shape_from_numpy  # noqa: E402
from gradus_tpu_torch.utils.interp import linear_interp  # noqa: E402

CAPTURED = int(StatusCodes.WithinInnerBoundary)


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _rays(jm, x, al, be):
    v = jax_map_impact(jm, jnp.asarray(x), jnp.asarray(al), jnp.asarray(be))
    xs = jnp.broadcast_to(jnp.asarray(x), v.shape)
    return xs, v, torch.as_tensor(np.asarray(xs)), torch.as_tensor(np.asarray(v))


def test_event_horizon_chart_shape():
    """Near-extremal Kerr: r_H·1.01 at every θ (rtol 1e-6, as the JAX
    test), and the JAX package's chart at rtol 1e-12 (measured 0)."""
    jm = jgt.KerrMetric(M=1.0, a=0.998)
    tm = from_numpy("KerrMetric", _params(jm), device="cpu")
    chart = event_horizon_chart(tm)
    ref = jgt.event_horizon_chart(jm)
    r_h = 1.0 + np.sqrt(1.0 - 0.998**2)
    np.testing.assert_allclose(chart.rs.numpy(), r_h * 1.01, rtol=1e-6)
    np.testing.assert_allclose(chart.rs.numpy(), np.asarray(ref.rs), rtol=1e-12)
    np.testing.assert_allclose(chart.thetas.numpy(), np.asarray(ref.thetas), rtol=0, atol=1e-15)


def test_shaped_chart_capture_radius():
    """16 rays from r = 100, i = 85° across the shadow: the shaped chart's
    statuses equal the scalar chart's and the JAX package's; captured rays
    end at r ≤ r_min(θ) + 0.3. (A ray ends at the end of the step that
    crosses a chart bound, so where it ends depends on the step sequence,
    which differs by roundoff between the packages: the endpoints are not
    compared.)"""
    jm = jgt.KerrMetric(M=1.0, a=0.998)
    tm = from_numpy("KerrMetric", _params(jm), device="cpu")
    x = [0.0, 100.0, np.deg2rad(85.0), 0.0]
    xs_j, v_j, xs, v = _rays(jm, x, np.linspace(-7.0, 7.0, 16), np.zeros(16) + 0.5)
    jchart = jgt.event_horizon_chart(jm)
    chart = poloidal_shape_from_numpy(_params_shape(jchart), device="cpu")
    kw = dict(chart_outer=200.0)
    gp_shaped = trace_geodesics(tm, xs, v, (0.0, 300.0), chart_inner=chart, **kw)
    gp_scalar = trace_geodesics(tm, xs, v, (0.0, 300.0), **kw)
    ref = jgt.trace_geodesics(jm, xs_j, v_j, (0.0, 300.0), chart_inner=jchart, **kw)
    s1 = gp_shaped.status.numpy()
    np.testing.assert_array_equal(s1, gp_scalar.status.numpy())
    np.testing.assert_array_equal(s1, np.asarray(ref.status))
    captured = s1 == CAPTURED
    assert captured.any()
    r_end, th_end = gp_shaped.x[captured, 1], gp_shaped.x[captured, 2]
    r_min = np.interp(th_end.numpy(), chart.thetas.numpy(), chart.rs.numpy())
    assert (r_end.numpy() <= r_min + 0.3).all()


def _params_shape(shape):
    return dict(rs=np.asarray(shape.rs), thetas=np.asarray(shape.thetas))


def test_shaped_chart_deformed_metric():
    """Johannsen-Psaltis (a = 0.6, ε₃ = 2) through its own shaped chart:
    the chart at rtol 1e-12 of the JAX package's (measured 2e-16), no
    NoStatus, some captured, statuses equal to the JAX package's, captured
    rays within r_min(θ) + 0.3."""
    jm = jgt.JohannsenPsaltisMetric(M=1.0, a=0.6, eps3=2.0)
    tm = from_numpy("JohannsenPsaltisMetric", _params(jm), device="cpu")
    chart = event_horizon_chart(tm)
    jchart = jgt.event_horizon_chart(jm)
    np.testing.assert_allclose(chart.rs.numpy(), np.asarray(jchart.rs), rtol=1e-12)
    assert (chart.rs > 0).all()
    x = [0.0, 100.0, np.deg2rad(80.0), 0.0]
    xs_j, v_j, xs, v = _rays(jm, x, np.linspace(-6.0, 6.0, 12), np.zeros(12) + 0.3)
    gp = trace_geodesics(tm, xs, v, (0.0, 600.0), chart_inner=chart, chart_outer=200.0)
    ref = jgt.trace_geodesics(jm, xs_j, v_j, (0.0, 600.0), chart_inner=jchart, chart_outer=200.0)
    s = gp.status.numpy()
    assert (s != int(StatusCodes.NoStatus)).all()
    assert (s == CAPTURED).any()
    np.testing.assert_array_equal(s, np.asarray(ref.status))
    cap = s == CAPTURED
    r_min = linear_interp(gp.x[cap, 2], chart.thetas, chart.rs)
    assert (gp.x[cap, 1] <= r_min + 0.3).all()


def test_chart_clamps_outside_its_theta_range():
    """θ past a pole (the right-hand side unwraps θ beyond [0, π]) takes
    the end values, as ``jnp.interp`` does; inside, linear."""
    shape = PoloidalShape(
        rs=torch.tensor([2.0, 1.5, 3.0], dtype=torch.float64), thetas=torch.tensor([0.0, 1.0, math.pi], dtype=torch.float64)
    )
    th = torch.tensor([-0.4, 0.0, 0.5, 1.0, math.pi, math.pi + 0.7], dtype=torch.float64)
    got = linear_interp(th, shape.thetas, shape.rs).numpy()
    ref = np.interp(th.numpy(), shape.thetas.numpy(), shape.rs.numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-15)
    assert got[0] == 2.0 and got[-1] == 3.0
