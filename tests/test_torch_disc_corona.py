"""The port's disc corona (`corona/extended.py`), in f64 on the CPU;
Kerr a = 0.5, ThinDisc(0, 100), rays to λ = 500 or r = 150 (well past the
disc's edge at r = 100): the ring stack as one flat batch, through
`emissivity_profile`'s dispatch, against its rings traced one by one
(2 rings × 3 slices × 32 angles, without the golden-section refinement:
one trace against two); tests/test_extended_corona.py's disc physics; the
JAX package's `DiscCoronaProfile` methods and `integrate_lagtransfer_timedep`
on the same stack (built in both packages from the port's numbers)
against the port's. The JAX package's own stack is
tests/test_torch_disc_corona_jax.py's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402

import gradus_tpu_torch.corona.extended as te  # noqa: E402
import gradus_tpu_torch as tgt  # noqa: E402
from gradus_tpu.corona.extended import DiscCoronaProfile as JaxDisc  # noqa: E402
from gradus_tpu.corona.extended import RingCoronaProfile as JaxRing  # noqa: E402
from gradus_tpu.corona.extended import TimeDependentRadialDiscProfile as JaxBranches  # noqa: E402
from gradus_tpu_torch.interop import disc_corona_profile_from_numpy  # noqa: E402
from torch_corona_helpers import mean_lag, np_fields, timedep_both  # noqa: E402

A_SPIN = 0.5
SHORT = dict(lam_max=500.0, chart_outer=150.0)


def _t(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


@pytest.fixture(scope="module")
def kerr_disc():
    jm, jd = jgt.KerrMetric(M=1.0, a=A_SPIN), jgt.ThinDisc(0.0, 100.0)
    return jm, jd, tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")


@pytest.fixture(scope="module")
def port_disc(kerr_disc):
    """The port's DiscCorona(r = 6, h = 4): 2 rings × 3 slices × 32 angles."""
    _, _, tm, td = kerr_disc
    return tgt.emissivity_profile(tm, td, tgt.DiscCorona(r=6.0, h=4.0), n_rings=2, n_beta=3, n_angles=32, n_refine=0, **SHORT)


def _jax_disc(prof):
    """The JAX package's `DiscCoronaProfile` of the port's numbers."""
    def branches(b):
        return JaxBranches(*(jnp.asarray(getattr(b, f).numpy()) for f in ("radii", "t", "eps", "n")))

    return JaxDisc(
        radii=jnp.asarray(prof.radii.numpy()),
        rings=JaxRing(left=branches(prof.rings.left), right=branches(prof.rings.right)),
        delays=jnp.asarray(prof.delays.numpy()),
    )


def test_disc_stack_is_its_rings(kerr_disc, port_disc):
    """One flat batch of every ring's rays gives each ring's branches as a
    trace of that ring alone, to 1e-12
    (the same arithmetic a ray; rounding apart, as the CPU's vector tails
    may round otherwise)."""
    _, _, tm, td = kerr_disc
    assert isinstance(port_disc, te.DiscCoronaProfile)
    for k, rc in enumerate(port_disc.radii.tolist()):
        ring = te.ring_corona_profile(tm, td, tgt.RingCorona(r=rc, h=4.0), n_beta=3, n_angles=32, n_refine=0, **SHORT)
        for arm in ("left", "right"):
            a, b = getattr(ring, arm), getattr(port_disc.rings, arm)
            np.testing.assert_array_equal(b.n[k].numpy(), a.n.numpy())
            valid = np.arange(a.radii.shape[-1]) < a.n.numpy()[:, None]
            for f in ("radii", "t", "eps"):
                np.testing.assert_allclose(getattr(b, f)[k].numpy()[valid], getattr(a, f).numpy()[valid], rtol=1e-12)


def test_disc_methods_match_jax(port_disc):
    """The JAX package's `DiscCoronaProfile` holding the port's stack: ε(r),
    the flux-weighted arrival time and the light curve's limits (with and
    without delays r/0.5) and the light curve itself at 1e-12;
    `interop.disc_corona_profile_from_numpy` carries the stack back."""
    jp = _jax_disc(port_disc)
    rq = [8.0, 12.0, 16.0, 32.0]
    for name in ("emissivity_at", "coordtime_at"):
        np.testing.assert_allclose(
            getattr(port_disc, name)(_t(rq)).numpy(), np.asarray(getattr(jp, name)(jnp.asarray(rq))), rtol=1e-12
        )
    for j, t in ((jp, port_disc), (jp.with_propagation_velocity(lambda r: r / 0.5), port_disc.with_propagation_velocity(lambda r: r / 0.5))):
        lim = [float(v) for v in j.time_limits_at(12.0)]
        np.testing.assert_allclose([float(v) for v in t.time_limits_at(12.0)], lim, rtol=1e-12)
        tq = np.linspace(lim[0], lim[1], 18)[1:-1]
        np.testing.assert_allclose(
            t.time_emissivity_curve(12.0, _t(tq)).numpy(), np.asarray(j.time_emissivity_curve(12.0, jnp.asarray(tq))),
            rtol=1e-12, atol=1e-18,
        )
    via = disc_corona_profile_from_numpy(np_fields(jp), device="cpu")
    np.testing.assert_allclose(via.emissivity_at(_t(rq)).numpy(), port_disc.emissivity_at(_t(rq)).numpy(), rtol=1e-12)


def test_disc_corona_physics(port_disc):
    """tests/test_extended_corona.py's disc checks on the port: positive
    decaying emissivity, causal limits, delays that shift the support,
    and a non-negative light curve with mass inside it."""
    prof = port_disc
    eps = prof.emissivity_at(_t([8.0, 16.0, 32.0])).numpy()
    assert np.all(eps > 0) and np.all(np.diff(eps) < 0)
    lo, hi = prof.time_limits_at(12.0)
    assert float(hi) > float(lo) > 0.0
    _, hi2 = prof.with_propagation_velocity(lambda r: r / 0.5).time_limits_at(12.0)
    assert float(hi2) > float(hi)
    curve = prof.time_emissivity_curve(12.0, torch.linspace(float(lo), float(hi), 32, dtype=torch.float64)).numpy()
    assert np.all(curve >= 0) and curve.max() > 0


def test_integrate_lagtransfer_timedep_matches_jax(port_disc):
    """The same ring stack (`_jax_disc`) and transfer grid in both packages:
    the 2D flux at 1e-9 relative to its largest bin (measured 5e-18
    absolute on the JAX package's own stack), Σ = 1, the mean echo lag
    within (2, 120); with propagation delays 2r the echo comes later. (With
    delays the light curve's last sample sits on a ring's support edge,
    t_max − dt_k, inside or outside that support by the last bit of t_max:
    there the two packages' fluxes differ by a sample, so the delays are
    held to physics, not to bits; ROADMAP C.)"""
    prof = port_disc
    jp = _jax_disc(prof)
    got, want, tbins = timedep_both(jp, prof)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    assert math.isclose(got.sum(), 1.0, rel_tol=1e-12) and 2.0 < mean_lag(got, tbins) < 120.0
    delayed, _, _ = timedep_both(jp.with_propagation_velocity(lambda r: 2.0 * r), prof.with_propagation_velocity(lambda r: 2.0 * r))
    assert math.isclose(delayed.sum(), 1.0, rel_tol=1e-12)
    assert mean_lag(delayed, tbins) > mean_lag(got, tbins) + 1.0
