"""The port's target search against the JAX package's, in
f64 on the CPU: `closest_approach`, `optimize_for_target` and
`refine_for_target` at tests/test_extended_corona.py's
configurations (Kerr a = 0.5, observer at r = 1000, i = 45°; the target on
the ring r = 3, h = 4).

The JAX package's `refine_for_target` divides the +∞ distances of the
samples past a ray's saved prefix by the softmin temperature, whose tangent
is then ∞ and the softmax's 0·∞: its Gauss-Newton Jacobian, and the polished
(α, β), are NaN whenever the ray saves fewer than `n_save` states, as this
target's does (ROADMAP C). The port keeps those samples out of the tangent;
`test_refine_for_target_reference_fault` pins the difference. The parity
tests of the polish hold the port to the JAX package with its softmax's
tangent masked where the weight is 0 (tests/torch_corona_helpers.py's
`masked_softmax`), which is the port's arithmetic.

The step sizes at r = 1000 come from error estimates dominated by rounding
(the far field is nearly flat), so the two packages save their samples at
different λ: their closest approaches agree to the sampling, not to the
solver tolerance, and the pattern search's near-ties can go another way.
The tolerances below say so.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu.transfer.targets as jt  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

import gradus_tpu_torch.integrate.solver as solver  # noqa: E402
import gradus_tpu_torch.transfer.targets as tt  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from torch_corona_helpers import masked_softmax  # noqa: E402

A_SPIN = 0.5
X_OBS = [0.0, 1000.0, math.radians(45.0), 0.0]
TARGET = [math.hypot(3.0, 4.0), math.atan2(3.0, 4.0), 0.0]


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


class _Replayed:
    """A stand-in for a captured body: raises if the carry it is given is
    under a `torch.func` transform, as the capture on the card does."""

    def __init__(self, step, static):
        assert not any(solver._is_wrapped(v) for v in static.values())
        self.step, self.static = step, static

    def replay(self):
        c = self.step(self.static)
        for k, buf in self.static.items():
            buf.copy_(c[k])


@pytest.fixture(scope="module")
def kerr():
    return JaxKerr(M=1.0, a=A_SPIN), KerrMetric(1.0, A_SPIN, device="cpu")


@pytest.fixture(scope="module")
def seeds(kerr):
    """Each package's `optimize_for_target` of the ring target."""
    jm, tm = kerr
    aj, bj, gj, accj = jt.optimize_for_target(jnp.asarray(TARGET), jm, jnp.asarray(X_OBS))
    at, bt, gt, acct = tt.optimize_for_target(TARGET, tm, _t(X_OBS))
    return dict(jax=(float(aj), float(bj), float(gj.x[0]), float(accj)), port=(at, bt, gt, acct))


@pytest.fixture(scope="module")
def refined(kerr, seeds):
    """`refine_for_target(iters=1)` (`continuum_time` takes 2) from the
    port's seed in both packages,
    the JAX package with and without its softmax's tangent masked, and the
    port's arrival-time derivative along the target's r."""
    jm, tm = kerr
    at, bt = seeds["port"][:2]
    ab0 = np.array([float(at), float(bt)])
    fault = jt.refine_for_target(jnp.asarray(TARGET), jm, jnp.asarray(X_OBS), jnp.asarray(ab0), iters=1)
    plain = jax.nn.softmax
    jax.nn.softmax = masked_softmax()
    try:
        (ab_j, t_j, d_j), (_, dt_j, _) = jax.jvp(
            lambda p: jt.refine_for_target(p, jm, jnp.asarray(X_OBS), jnp.asarray(ab0), iters=1),
            (jnp.asarray(TARGET),),
            (jnp.asarray([1.0, 0.0, 0.0]),),
        )
    finally:
        jax.nn.softmax = plain
    # the port's polish within `torch.func.jvp` (its derivative along the
    # target's r), its loops replaying a stand-in graph that refuses a carry
    # under the transform, as the capture on the card does
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, "_graphed", lambda cf: True)
        mp.setattr(solver, "_capture", _Replayed)
        port, (_, dt, _) = torch.func.jvp(
            lambda p: tt.refine_for_target(p, tm, _t(X_OBS), torch.as_tensor(ab0), iters=1),
            (_t(TARGET),),
            (_t([1.0, 0.0, 0.0]),),
        )
    return dict(fault=fault, jax=(np.asarray(ab_j), float(t_j), float(d_j), float(dt_j)), port=port, port_dt=dt, ab0=ab0)


def test_closest_approach_matches_jax(kerr):
    """A 5×5 fan around the ring target: distances within 1e-2 and the
    closest-approach times at 2e-5 relative (measured 1.7e-3 and 3.5e-6:
    the samples differ, see the module docstring)."""
    jm, tm = kerr
    off = np.linspace(-1.0, 1.0, 5)
    al = np.repeat(off, 5) + 0.08
    be = np.tile(off, 5) + 0.7
    dj, tj, _ = jt.closest_approach(jm, jnp.asarray(X_OBS), jnp.asarray(al), jnp.asarray(be), jnp.asarray(TARGET))
    dt_, t_, gp = tt.closest_approach(tm, _t(X_OBS), torch.as_tensor(al), torch.as_tensor(be), TARGET)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=0, atol=1e-2)
    np.testing.assert_allclose(t_.numpy(), np.asarray(tj), rtol=2e-5)
    assert gp.x.shape == (25, 4) and float(dt_.min()) < 0.5


def test_optimize_for_target_hits(seeds):
    """tests/test_extended_corona.py's checks on the port (accuracy
    < 5e-2, α and β finite, 990 < t < 1050) and the JAX package's result:
    t at 1e-5 relative, α and β within 5e-2 (measured 1.6e-6, 4.6e-3 and
    2.8e-2: the rounds' near-ties, see the module docstring)."""
    at, bt, gt, acct = seeds["port"]
    aj, bj, tj, accj = seeds["jax"]
    assert float(acct) < 5e-2 and accj < 5e-2
    assert math.isfinite(float(at)) and math.isfinite(float(bt))
    assert 990.0 < float(gt.x[0]) < 1050.0
    assert math.isclose(float(gt.x[0]), tj, rel_tol=1e-5)
    assert abs(float(at) - aj) < 5e-2 and abs(float(bt) - bj) < 5e-2
    a, b, acc = tt.impact_parameters_for_target(TARGET, KerrMetric(1.0, A_SPIN, device="cpu"), _t(X_OBS), n_rounds=1)
    assert math.isfinite(float(a)) and math.isfinite(float(b)) and float(acc) < 5.0


def test_refine_for_target_matches_jax(refined):
    """From the same seed, one Gauss-Newton step: t* at 5e-6 relative,
    (α, β) within 2e-2 and the distance within 3e-3 of the JAX package's
    (its softmax's tangent masked; measured 5.6e-7, 1.6e-2 and 3.3e-4: the
    Jacobians follow derivatives through step sizes that rounding sets, see
    the module docstring); the polish lands within the softmin's bias floor
    (distance < 0.05, tests/test_extended_corona.py)."""
    ab_j, t_j, d_j, _ = refined["jax"]
    ab, t, dist = refined["port"]
    assert math.isclose(float(t), t_j, rel_tol=5e-6)
    np.testing.assert_allclose(ab.numpy(), ab_j, atol=2e-2)
    assert abs(float(dist) - d_j) < 3e-3 and float(dist) < 0.05
    assert 990.0 < float(t) < 1050.0


def test_refine_for_target_reference_fault(refined):
    """The JAX package's polish of this target is NaN (its ray saves fewer
    than 256 states), so its arrival time is 0; the port's is finite (the
    fault of ROADMAP C, not pinned as right)."""
    ab_f, t_f, _ = refined["fault"]
    assert np.isnan(np.asarray(ab_f)).all() and float(t_f) == 0.0
    ab, t, _ = refined["port"]
    assert bool(torch.isfinite(ab).all()) and float(t) > 1000.0


def test_arrival_time_derivative(refined):
    """`torch.func.jvp` of the arrival time along the target's r: the
    eikonal derivative −k_r/k_t from the saved momentum, within 2e-2 of the
    JAX package's custom JVP (measured 7.0e-3: the approach samples differ);
    the loops under the transform replayed a stand-in graph with plain
    tensors, as they must on the card (`refined`)."""
    dt = float(refined["port_dt"])
    assert math.isfinite(dt) and -2.0 < dt < -1.0
    assert math.isclose(dt, refined["jax"][3], rel_tol=2e-2)
