"""Parity of the port's charged traces, orbit solvers and special radii with
the JAX package's, in f64 on the CPU.

- the charged right-hand side (the Kerr-Newman Lorentz force through the
  batched `faraday_tensor`) against the JAX `make_geodesic_rhs(m,
  TraceGeodesic(q=...))` on random states, and a short charged trace;
- `charged_circular_orbit_omega` (each radius against the JAX package's
  one-radius call), `solve_orbit_theta` and `solve_equatorial_circular_orbit`;
- `event_horizon`, `ergosphere` and `is_naked_singularity`
  (tests/test_orbits.py::test_event_horizon_and_ergosphere_kerr).

Two implementations of the adaptive solver take slightly different step
sequences (tests/test_torch_trace_geodesics.py), so a trace's endpoints
are held at atol 1e-6, with the measured gap beside each bound.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gradus_tpu.integrate.tracing import TraceGeodesic as JaxTrace  # noqa: E402
from gradus_tpu.integrate.tracing import make_geodesic_rhs as jax_rhs  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics as jax_trace  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.metrics import KerrNewmanMetric as JaxKN  # noqa: E402
from gradus_tpu.metrics import NoZMetric as JaxNoZ  # noqa: E402
from gradus_tpu.orbits import solving as jax_solving  # noqa: E402
from gradus_tpu.orbits import special_radii as jax_radii  # noqa: E402

from gradus_tpu_torch.integrate import StatusCodes, TraceGeodesic, make_geodesic_rhs, trace_geodesics  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.orbits import (  # noqa: E402
    CircularOrbits,
    charged_circular_orbit_omega,
    ergosphere,
    event_horizon,
    is_naked_singularity,
    solve_equatorial_circular_orbit,
    solve_orbit_theta,
)

KN = dict(M=1.0, a=0.5, Q=0.3)


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _pair(cls, kind, **kw):
    jm = cls(**kw)
    return jm, from_numpy(kind, _params(jm), device="cpu")


@pytest.mark.parametrize("mu", [0.0, 1.0])
def test_charged_rhs_matches_jax(mu):
    """q = 0.3 on Kerr-Newman (a = 0.5, Q = 0.3), null (q/μ taken with μ =
    1) and timelike, on 64 random states: rtol 1e-12 (measured 2e-15)."""
    jm, tm = _pair(JaxKN, "KerrNewmanMetric", **KN)
    rng = np.random.default_rng(11)
    n = 64
    x = np.stack([np.zeros(n), rng.uniform(3.0, 40.0, n), rng.uniform(0.2, math.pi - 0.2, n), rng.uniform(0, 6, n)], -1)
    v = rng.normal(size=(n, 4))
    y = np.concatenate([x, v], -1)
    got = make_geodesic_rhs(tm, TraceGeodesic(mu=mu, q=0.3))(torch.as_tensor(y)).numpy()
    ref = np.asarray(jax_rhs(jm, JaxTrace(mu=mu, q=0.3))(jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    uncharged = make_geodesic_rhs(tm, TraceGeodesic(mu=mu))(torch.as_tensor(y)).numpy()
    assert np.abs(got - uncharged).max() > 1e-3  # the force is there


def _charged_orbit_states(jm, r, q):
    """Timelike states on the charged circular orbits the JAX package
    gives at radii ``r``, with a small radial kick so they oscillate."""
    om = np.array([float(jax_solving.charged_circular_orbit_omega(jm, float(ri), q=q)) for ri in r])
    g = np.asarray(jm.components(jnp.asarray(r), jnp.full(len(r), math.pi / 2)))
    ut = 1.0 / np.sqrt(-(g[:, 0] + 2 * om * g[:, 4] + om * om * g[:, 3]))
    x = np.stack([np.zeros_like(r), r, np.full_like(r, math.pi / 2), np.zeros_like(r)], -1)
    v = np.stack([ut, np.full_like(r, 1e-3), np.full_like(r, 1e-3), om * ut], -1)
    return x, v


def test_charged_trace_matches_jax():
    """8 particles at q/μ = 0.3 near the charged circular orbits at r ∈
    [6, 20] (a small radial and polar kick), λ ≤ 300: statuses equal, the
    endpoints within atol 1e-8 (measured 3.9e-11); the charge moves them."""
    jm, tm = _pair(JaxKN, "KerrNewmanMetric", **KN)
    x, v = _charged_orbit_states(jm, np.linspace(6.0, 20.0, 8), 0.3)
    span, kw = (0.0, 300.0), dict(mu=1.0, q=0.3)
    ref = jax_trace(jm, jnp.asarray(x), jnp.asarray(v), span, **kw)
    got = trace_geodesics(tm, torch.as_tensor(x), torch.as_tensor(v), span, **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v), rtol=0, atol=1e-8)
    plain = trace_geodesics(tm, torch.as_tensor(x), torch.as_tensor(v), span, mu=1.0)
    assert (plain.x - got.x).abs().max() > 1e-2


def test_charged_circular_orbit_omega_matches_jax():
    """Elementwise over radii, each against the JAX package's one-radius
    Newton at rtol 1e-12 (measured 1.3e-15), co- and contra-rotating,
    q = ±0.3 and the uncharged analytic Ω; the orbit it gives stays
    circular over λ ≤ 500 (radius within 1e-8 relative: measured 8.3e-11)."""
    jm, tm = _pair(JaxKN, "KerrNewmanMetric", **KN)
    r = np.array([6.0, 8.5, 12.0, 20.0])
    for q, contra in ((0.3, False), (-0.3, False), (0.3, True), (0.0, False)):
        got = charged_circular_orbit_omega(tm, torch.as_tensor(r), q=q, contra_rotating=contra).numpy()
        ref = [float(jax_solving.charged_circular_orbit_omega(jm, float(ri), q=q, contra_rotating=contra)) for ri in r]
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    om = charged_circular_orbit_omega(tm, torch.as_tensor(r), q=0.3)
    g = tm.components(torch.as_tensor(r), torch.full((4,), math.pi / 2, dtype=torch.float64))
    ut = 1.0 / torch.sqrt(-(g[:, 0] + 2 * om * g[:, 4] + om * om * g[:, 3]))
    z = torch.zeros_like(om)
    x = torch.stack([z, torch.as_tensor(r), torch.full_like(z, math.pi / 2), z], -1)
    gp = trace_geodesics(tm, x, torch.stack([ut, z, z, om * ut], -1), (0.0, 500.0), mu=1.0, q=0.3, constrain=False)
    assert (gp.status == StatusCodes.NoStatus).all()
    assert float(((gp.x[:, 1] - x[:, 1]).abs() / x[:, 1]).max()) < 1e-8


def test_solve_orbit_theta_matches_jax():
    """NoZ (a = 0.5, ε = 0.3) over r ∈ [4, 20]: equal to the JAX package's
    bisection at 1e-12 (measured 0); Kerr's is the equator."""
    jm, tm = _pair(JaxNoZ, "NoZMetric", M=1.0, a=0.5, eps=0.3)
    r = np.linspace(4.0, 20.0, 9)
    got = solve_orbit_theta(tm, torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_solving.solve_orbit_theta(jm, jnp.asarray(r))), rtol=1e-12)
    _, kerr = _pair(JaxKerr, "KerrMetric", M=1.0, a=0.5)
    np.testing.assert_allclose(solve_orbit_theta(kerr, torch.as_tensor(r)).numpy(), math.pi / 2, atol=1e-9)


def test_solve_equatorial_circular_orbit_matches_jax():
    """Kerr a = 0.5 at r ∈ {6, 10, 15}, λ ≤ 60, 12 golden-section steps:
    the port's v^φ within 1e-10 relative of the JAX package's (measured
    0), and within the last bracket (1e-3) of the analytic v^φ (measured
    2.2e-16: the bracket starts symmetric about it)."""
    jm, tm = _pair(JaxKerr, "KerrMetric", M=1.0, a=0.5)
    r = np.array([6.0, 10.0, 15.0])
    got = solve_equatorial_circular_orbit(tm, torch.as_tensor(r), lam=60.0, iters=12).numpy()
    ref = np.asarray(jax_solving.solve_equatorial_circular_orbit(jm, jnp.asarray(r), lam=60.0, iters=12))
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    analytic = CircularOrbits.fourvelocity(tm, (torch.as_tensor(r), torch.full((3,), math.pi / 2, dtype=torch.float64)))
    np.testing.assert_allclose(got, analytic[:, 3].numpy(), rtol=1e-3)


def test_event_horizon_and_ergosphere_kerr():
    """tests/test_orbits.py's Kerr a = 0.9 case (rtol 1e-8 to the analytic
    radii), and each radius against the JAX package's at rtol 1e-12
    (measured 0; the deformed Johannsen-Psaltis horizon is held in
    tests/test_torch_shaped_chart.py); a naked singularity."""
    a = 0.9
    jm, tm = _pair(JaxKerr, "KerrMetric", M=1.0, a=a)
    rs, thetas = event_horizon(tm, resolution=32)
    np.testing.assert_allclose(rs.numpy(), 1 + np.sqrt(1 - a * a), rtol=1e-8)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jax_radii.event_horizon(jm, resolution=32)[0]), rtol=1e-12)
    re, thetas = ergosphere(tm, resolution=33)
    np.testing.assert_allclose(re.numpy(), 1 + np.sqrt(1 - (a * np.cos(thetas.numpy())) ** 2), rtol=1e-8)
    np.testing.assert_allclose(re.numpy(), np.asarray(jax_radii.ergosphere(jm, resolution=33)[0]), rtol=1e-12)
    assert not is_naked_singularity(tm)
    _, tn = _pair(JaxKN, "KerrNewmanMetric", M=1.0, a=0.9, Q=0.6)  # a² + Q² > M²: no horizon
    assert is_naked_singularity(tn)
