"""The port's offset solver and continuum time against the JAX reference's,
in f64 on the CPU: `find_offset_for_radius` (the batched safeguarded Newton
whose derivative is a `torch.func.jvp` through the lockstep solver) and
`continuum_time` of a lamp post.

Each Newton iteration is a forward-mode trace: ~40 ms an iteration of the
lockstep solver on one CPU core for a single ray (8× the primal), so the
continuum ray's ~2,500 solver iterations take ~100 s; this file holds the
port's costliest tests.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu.corona as jc  # noqa: E402
from gradus_tpu.geometry.discs import DatumPlane as JaxDatumPlane  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.reverberation import continuum_time as jax_continuum_time  # noqa: E402
from gradus_tpu.transfer.solvers import find_offset_for_radius as jax_find_offset  # noqa: E402

import gradus_tpu_torch.corona as tc  # noqa: E402
from gradus_tpu_torch.geometry import DatumPlane  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.reverberation import continuum_time  # noqa: E402
from gradus_tpu_torch.transfer.solvers import find_offset_for_radius, impact_parameters_for_radius  # noqa: E402

A_SPIN = 0.998


def test_find_offset_for_radius_matches_jax():
    """Two emission radii on DatumPlane(0) from r = 100, i = 45°: offsets,
    hit points and residuals at 1e-8 (measured ≤ 1e-12 relative)."""
    x = [0.0, 100.0, math.radians(45.0), 0.0]
    jm, tm = JaxKerr(M=1.0, a=A_SPIN), KerrMetric(1.0, A_SPIN, device="cpu")
    r_t, th = np.array([6.0, 12.0]), np.array([0.4, 2.5])
    rj, gj, resj = jax_find_offset(jm, jnp.asarray(x), JaxDatumPlane(0.0), jnp.asarray(r_t), jnp.asarray(th))
    rt, gt, rest = find_offset_for_radius(
        tm, torch.tensor(x, dtype=torch.float64), DatumPlane(0.0, device="cpu"), torch.as_tensor(r_t), torch.as_tensor(th)
    )
    assert np.isfinite(np.asarray(rj)).all()
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-8)
    np.testing.assert_allclose(gt.x.numpy(), np.asarray(gj.x), rtol=1e-8)
    np.testing.assert_allclose(rest.numpy(), np.asarray(resj), atol=1e-8)


def test_impact_parameters_for_radius_ring_of_nans_beyond_max_iter():
    """`impact_parameters_for_radius` with ``max_iter=0``: no Newton step, so
    every offset fails the acceptance test and is NaN, on a ring of N
    angles (the loop and the final trace still run)."""
    al, be = impact_parameters_for_radius(
        KerrMetric(1.0, A_SPIN, device="cpu"), torch.tensor([0.0, 100.0, 1.0, 0.0], dtype=torch.float64),
        DatumPlane(0.0, device="cpu"), 8.0, N=4, max_iter=0, lam_max=1.0,
    )
    assert al.shape == be.shape == (4,) and bool(torch.isnan(al).all())


def test_continuum_time_matches_jax():
    """The lamp post (h = 5) seen from r = 1000, i = 45°: t₀ at 1e-10
    relative (measured 9.2e-14); ring and disc coronae raise (A11)."""
    x = [0.0, 1000.0, math.radians(45.0), 0.0]
    tm = KerrMetric(1.0, A_SPIN, device="cpu")
    tj = float(jax_continuum_time(JaxKerr(M=1.0, a=A_SPIN), jnp.asarray(x), jc.LampPostModel()))
    tt = float(continuum_time(tm, torch.tensor(x, dtype=torch.float64), tc.LampPostModel()))
    assert 1000.0 < tt < 1030.0
    assert math.isclose(tt, tj, rel_tol=1e-10)
    for model in (tc.RingCorona(), tc.DiscCorona()):
        with pytest.raises(NotImplementedError, match="item 11"):
            continuum_time(tm, torch.tensor(x, dtype=torch.float64), model)
