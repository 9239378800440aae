"""Parity of the port's metric, geodesic-equation and camera modules with the
JAX reference, in f64 on the CPU.

Each function is the same closed form in both packages, so inputs drawn from
a seeded numpy generator must agree to rtol 1e-12 (op order differs, so not
bitwise). The atol terms cover components that are exactly zero in one
package and roundoff-sized in the other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geodesics.equation import (  # noqa: E402
    constrain_all as jax_constrain_all,
    geodesic_acceleration as jax_geodesic_acceleration,
)
from gradus_tpu.geodesics.tetrads import lnrbasis_matrix as jax_lnrbasis_matrix  # noqa: E402
from gradus_tpu.metrics.kerr import KerrMetric as JaxKerr, kerr_isco as jax_kerr_isco  # noqa: E402

from gradus_tpu_torch.camera.impact import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geodesics.equation import (  # noqa: E402
    constrain_all,
    geodesic_acceleration,
)
from gradus_tpu_torch.geodesics.tetrads import lnrbasis_matrix  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.metrics.base import _ad_components5_jac  # noqa: E402
from gradus_tpu_torch.metrics.kerr import kerr_isco  # noqa: E402

SPINS = (0.0, 0.5, 0.998)


def _pair(a):
    jm = JaxKerr(M=1.0, a=a)
    params = {f.name: np.asarray(getattr(jm, f.name)) for f in dataclasses.fields(jm)}
    return jm, from_numpy("KerrMetric", params, dtype=torch.float64, device="cpu")


def _rtheta(seed, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(2.5, 900.0, n), rng.uniform(0.05, np.pi - 0.05, n)


def _close(a, b, rtol=1e-12, atol=1e-300):
    np.testing.assert_allclose(
        b.numpy() if hasattr(b, "numpy") else b, np.asarray(a), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("a", SPINS)
def test_kerr_components_match_jax(a):
    jm, tm = _pair(a)
    r, th = _rtheta(1)
    for x, y in zip(jm.components5(jnp.asarray(r), jnp.asarray(th)),
                    tm.components5(torch.as_tensor(r), torch.as_tensor(th))):
        _close(x, y)
    jac_j = jm.components5_jac(jnp.asarray(r), jnp.asarray(th))
    jac_t = tm.components5_jac(torch.as_tensor(r), torch.as_tensor(th))
    for tup_j, tup_t in zip(jac_j, jac_t):
        for x, y in zip(tup_j, tup_t):
            _close(x, torch.broadcast_to(torch.as_tensor(y), (len(r),)), atol=1e-15)


@pytest.mark.parametrize("a", SPINS)
def test_kerr_analytic_jacobian_matches_torch_func_ad(a):
    _, tm = _pair(a)
    r, th = (torch.as_tensor(v) for v in _rtheta(7, 32))
    for tup_a, tup_b in zip(tm.components5_jac(r, th), _ad_components5_jac(tm, r, th)):
        for x, y in zip(tup_a, tup_b):
            np.testing.assert_allclose(
                torch.broadcast_to(torch.as_tensor(x), r.shape).numpy(),
                y.numpy(),
                rtol=5e-12,
                atol=1e-12,
            )


@pytest.mark.parametrize("a", SPINS)
def test_geodesic_acceleration_matches_jax(a):
    jm, tm = _pair(a)
    r, th = _rtheta(3)
    rng = np.random.default_rng(4)
    vel = rng.normal(size=(4, len(r)))
    acc_j = jax_geodesic_acceleration(jm, jnp.asarray(r), jnp.asarray(th), *map(jnp.asarray, vel))
    acc_t = geodesic_acceleration(
        tm, torch.as_tensor(r), torch.as_tensor(th), *map(torch.as_tensor, vel)
    )
    for x, y in zip(acc_j, acc_t):
        _close(x, y, atol=1e-18)


@pytest.mark.parametrize("a", SPINS)
def test_constrain_all_and_lnrbasis_match_jax(a):
    jm, tm = _pair(a)
    r, th = _rtheta(5)
    rng = np.random.default_rng(6)
    x = np.stack([np.zeros_like(r), r, th, rng.uniform(0, 2 * np.pi, len(r))], -1)
    v = np.concatenate([np.ones((len(r), 1)), 1e-3 * rng.normal(size=(len(r), 3))], -1)
    _close(
        jax_constrain_all(jm, jnp.asarray(x), jnp.asarray(v)),
        constrain_all(tm, torch.as_tensor(x), torch.as_tensor(v)),
    )
    _close(
        jax_lnrbasis_matrix(jm, jnp.asarray(x)),
        lnrbasis_matrix(tm, torch.as_tensor(x)),
        atol=1e-15,
    )


@pytest.mark.parametrize("a", SPINS)
def test_map_impact_parameters_matches_jax(a):
    jm, tm = _pair(a)
    rng = np.random.default_rng(8)
    alpha = rng.uniform(-28, 28, 256)
    beta = rng.uniform(-18, 18, 256)
    x_obs = np.array([0.0, 1000.0, np.deg2rad(75.0), 0.0])
    v_j = jax_map_impact(jm, jnp.asarray(x_obs), jnp.asarray(alpha), jnp.asarray(beta))
    v_t = map_impact_parameters(
        tm, torch.as_tensor(x_obs), torch.as_tensor(alpha), torch.as_tensor(beta)
    )
    _close(v_j, v_t, atol=1e-18)


@pytest.mark.parametrize("a", (0.0, 0.3, 0.7, 0.998, -0.5))
def test_kerr_isco_matches_jax(a):
    np.testing.assert_allclose(
        float(kerr_isco(torch.tensor(1.0, dtype=torch.float64), torch.tensor(a, dtype=torch.float64))),
        float(jax_kerr_isco(1.0, a)),
        rtol=1e-12,
    )
