"""The continuum time of off-axis coronae in f64 on the CPU:
`optimize_for_target` (8 rounds of a 9×9 fan of dense traces) then two
Gauss-Newton steps of `refine_for_target`, seen from r = 1000, i = 45°,
Kerr a = 0.5: a DiscCorona(r = 6, h = 4) (its source point at the
area-median radius r/√2) against the JAX package run alongside, and a
nearly on-axis RingCorona(r = 0.05, h = 5) (tests/test_extended_corona.py's
case, from r = 100) held to the JAX package's value and to its lamp
post's, both computed alongside. A RingCorona(r = 3, h = 4)'s continuum
time is the same search for its source (tests/test_torch_continuum_time.py's
dispatch test), which tests/test_torch_targets.py holds to the JAX package
step by step.

The disc's ray saves fewer than 256 states, where the JAX package's polish
is NaN and its continuum time 0 (ROADMAP C): the port is held to the JAX
package with its softmax's tangent masked where the weight is 0, the
port's arithmetic. The pattern search's near-ties and the differently
placed samples leave the two a few 1e-3 t_g apart. The near-axis ring's
ray saves all its states, and there the JAX package is right as it is.
"""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402

import gradus_tpu_torch as tgt  # noqa: E402
from torch_corona_helpers import masked_softmax  # noqa: E402

A_SPIN = 0.5
X_OBS = [0.0, 1000.0, math.radians(45.0), 0.0]


def test_continuum_time_matches_jax():
    """A DiscCorona(r = 6, h = 4): t₀ at 1e-5 relative of the JAX package's
    (its softmax's tangent masked; measured 1.6e-6 for a RingCorona(3, 4));
    1000 < t₀ < 1030."""
    jm, tm = jgt.KerrMetric(M=1.0, a=A_SPIN), tgt.KerrMetric(1.0, A_SPIN, device="cpu")
    j_model, t_model = jgt.DiscCorona(r=6.0, h=4.0), tgt.DiscCorona(r=6.0, h=4.0)
    plain = jax.nn.softmax
    jax.nn.softmax = masked_softmax()
    try:
        t_jax = float(jgt.continuum_time(jm, jnp.asarray(X_OBS), j_model))
    finally:
        jax.nn.softmax = plain
    t0 = tgt.continuum_time(tm, torch.tensor(X_OBS, dtype=torch.float64), t_model)
    assert 1000.0 < float(t0) < 1030.0
    assert math.isclose(float(t0), t_jax, rel_tol=1e-5)


@pytest.fixture(scope="module")
def jax_near_axis_times():
    """The JAX package's continuum times from r = 100 (i = 45°, a = 0.5):
    a RingCorona(r = 0.05, h = 5)'s (its ray saves all 256 states, so its
    polish is right as it is) and the on-axis `LampPostModel(h = 5)`'s (the
    datum-plane Newton); ~35 s on one core."""
    jm = jgt.KerrMetric(M=1.0, a=A_SPIN)
    x = jnp.asarray([0.0, 100.0, math.radians(45.0), 0.0])
    ring = float(jgt.continuum_time(jm, x, jgt.RingCorona(r=0.05, h=5.0)))
    lamp_post = float(jgt.continuum_time(jm, x, jgt.LampPostModel(h=5.0)))
    return ring, lamp_post


def test_continuum_time_of_a_nearly_on_axis_ring_matches_jax(jax_near_axis_times):
    """RingCorona(r = 0.05, h = 5) seen from r = 100 (tests/test_extended_corona.py
    takes r = 1000; its traces are ten times longer): t₀ at 1e-5 relative
    of the JAX package's, and within 0.5 of the JAX package's on-axis lamp
    post's, the axisymmetric limit the JAX package's test checks."""
    jax_ring, jax_lamp_post = jax_near_axis_times
    tm = tgt.KerrMetric(1.0, A_SPIN, device="cpu")
    x = torch.tensor([0.0, 100.0, math.radians(45.0), 0.0], dtype=torch.float64)
    t0 = float(tgt.continuum_time(tm, x, tgt.RingCorona(r=0.05, h=5.0)))
    assert math.isclose(t0, jax_ring, rel_tol=1e-5)
    assert abs(t0 - jax_lamp_post) < 0.5
