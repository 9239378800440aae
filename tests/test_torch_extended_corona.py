"""The port's ring corona (`corona/extended.py`) against the JAX package's,
in f64 on the CPU, through `emissivity_profile`'s dispatch: the β-slice
fan of a RingCorona(r = 3, h = 4) at tests/test_extended_corona.py's
`ring_profile` size (6 slices × 96 angles; 4 golden-section steps, so 6
probe traces where the reference's default takes 18; the rays end at
λ = 500 or r = 150); Kerr a = 0.5, ThinDisc(0, 100). Both packages trace
the same rays with the same steps (a source near the hole), so the
branches agree to the solver's rounding. Then tests/test_extended_corona.py's
physics on the port's profiles, the fan's building blocks on seeded
inputs, and `integrate_lagtransfer_timedep` of the JAX package's fan
(carried across by `interop`) against the JAX package's on one transfer
grid. The disc corona's stack is tests/test_torch_disc_corona.py's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
import gradus_tpu.corona.extended as je  # noqa: E402

import gradus_tpu_torch.corona.extended as te  # noqa: E402
import gradus_tpu_torch as tgt  # noqa: E402
from gradus_tpu_torch.geodesics.tetrads import propernorm  # noqa: E402
from gradus_tpu_torch.interop import ring_corona_profile_from_numpy  # noqa: E402
from torch_corona_helpers import mean_lag, np_fields, timedep_both  # noqa: E402

A_SPIN = 0.5
RQ = [2.6, 3.0, 3.4, 4.0, 5.0, 8.0, 16.0, 32.0]
# rays end at λ = 500 or r = 150, well past the disc's edge at r = 100 (the
# reference's 10⁴ and 1.2·10⁴ only lengthen the escaping rays' traces)
SHORT = dict(lam_max=500.0, chart_outer=150.0)


def _t(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


@pytest.fixture(scope="module")
def kerr_disc():
    jm, jd = jgt.KerrMetric(M=1.0, a=A_SPIN), jgt.ThinDisc(0.0, 100.0)
    return jm, jd, tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")


@pytest.fixture(scope="module")
def ring_profiles(kerr_disc):
    jm, jd, tm, td = kerr_disc
    kw = dict(n_beta=6, n_angles=96, n_refine=4, near_field="fan", **SHORT)
    return (
        jgt.emissivity_profile(jm, jd, jgt.RingCorona(r=3.0, h=4.0), **kw),
        tgt.emissivity_profile(tm, td, tgt.RingCorona(r=3.0, h=4.0), **kw),
    )


def _assert_branches(jp, tp, rtol, eps_rtol):
    """Equal valid counts; radii and t of the valid prefixes at ``rtol``, ε
    at ``eps_rtol``."""
    for arm in ("left", "right"):
        a, b = getattr(jp, arm), getattr(tp, arm)
        n = np.asarray(a.n)
        np.testing.assert_array_equal(b.n.numpy(), n)
        valid = np.arange(np.asarray(a.radii).shape[-1]) < n[..., None]
        for f, tol in (("radii", rtol), ("t", rtol), ("eps", eps_rtol)):
            np.testing.assert_allclose(getattr(b, f).numpy()[valid], np.asarray(getattr(a, f))[valid], rtol=tol)


def test_ring_fan_matches_jax(ring_profiles):
    """The fan's branches: the same valid counts in each slice and arm;
    radii, t and ε at 1e-9 (measured 2.6e-13, 2.6e-13 and 6.6e-11); ε(r)
    through the near and far field and the light curve's limits at 1e-9;
    the light curve at r = 10 at 1e-9 inside its support."""
    jp, tp = ring_profiles
    assert isinstance(tp, te.RingCoronaProfile)
    _assert_branches(jp, tp, 1e-9, 1e-9)
    np.testing.assert_allclose(
        tp.emissivity_at(_t(RQ)).numpy(), np.asarray(jp.emissivity_at(jnp.asarray(RQ))), rtol=1e-9
    )
    np.testing.assert_allclose(
        tp.coordtime_at(_t(RQ)).numpy(), np.asarray(jp.coordtime_at(jnp.asarray(RQ))), rtol=1e-9
    )
    lo_j, hi_j = (float(v) for v in jp.time_limits_at(10.0))
    lo_t, hi_t = tp.time_limits_at(10.0)
    np.testing.assert_allclose([float(lo_t), float(hi_t)], [lo_j, hi_j], rtol=1e-9)
    tq = np.linspace(lo_j, hi_j, 34)[1:-1]
    np.testing.assert_allclose(
        tp.time_emissivity_curve(10.0, _t(tq)).numpy(),
        np.asarray(jp.time_emissivity_curve(10.0, jnp.asarray(tq))),
        rtol=1e-9,
        atol=1e-18,
    )


def test_ring_profile_from_numpy_is_the_jax_profile(ring_profiles):
    """`interop.ring_corona_profile_from_numpy` carries the JAX package's fan
    across: its methods give the JAX package's values at 1e-12 (the same
    interpolation of the same numbers)."""
    jp, _ = ring_profiles
    prof = ring_corona_profile_from_numpy(np_fields(jp), device="cpu")
    np.testing.assert_allclose(
        prof.emissivity_at(_t(RQ)).numpy(), np.asarray(jp.emissivity_at(jnp.asarray(RQ))), rtol=1e-12
    )
    lim = [float(v) for v in prof.time_limits_at(12.0)]
    np.testing.assert_allclose(lim, [float(v) for v in jp.time_limits_at(12.0)], rtol=1e-12)

def test_integrate_lagtransfer_timedep_matches_jax(ring_profiles):
    """The JAX package's fan, carried across by `interop`, and the same
    transfer grid in both packages: the 2D flux at 1e-9 relative to its
    largest bin (the same interpolation and scatter of the same numbers;
    measured 7e-16), Σ = 1, and tests/test_extended_corona.py's causality:
    the mean echo lag past the continuum within (2, 120)."""
    jp, _ = ring_profiles
    got, want, tbins = timedep_both(jp, ring_corona_profile_from_numpy(np_fields(jp), device="cpu"))
    assert got.shape == want.shape == (40, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    assert math.isclose(got.sum(), 1.0, rel_tol=1e-12)
    assert 2.0 < mean_lag(got, tbins) < 120.0


def test_source_velocities_timelike(kerr_disc):
    """Both source velocity functions give unit-norm timelike vectors
    (reference SourceVelocities, extended.jl:1-46), as the JAX package's
    to 1e-12."""
    jm, _, tm, _ = kerr_disc
    x = [0.0, 5.0, 0.6435, 0.0]
    for jf, tf in ((je.stationary_velocity, te.stationary_velocity), (je.co_rotating_velocity, te.co_rotating_velocity)):
        v = tf(tm, _t(x))
        np.testing.assert_allclose(float(propernorm(tm.metric(_t(x)), v)), -1.0, atol=1e-10)
        np.testing.assert_allclose(v.numpy(), np.asarray(jf(jm, jnp.asarray(x))), rtol=1e-12, atol=1e-15)
    assert float(te.co_rotating_velocity(tm, _t(x))[3]) > 1e-4
    assert float(te.stationary_velocity(tm, _t(x))[3]) == 0.0


def test_ring_profile_structure(ring_profiles):
    """Two arms, positive decaying emissivity, causal time ordering; the
    light curve is non-negative with support inside the limits and zero
    outside (tests/test_extended_corona.py)."""
    _, prof = ring_profiles
    eps = prof.emissivity_at(_t([4.0, 8.0, 16.0, 32.0])).numpy()
    assert np.all(eps > 0) and np.all(np.diff(eps) < 0)
    lo, hi = prof.time_limits_at(10.0)
    assert float(hi) > float(lo) > 0.0
    curve = prof.time_emissivity_curve(10.0, torch.linspace(float(lo), float(hi), 32, dtype=torch.float64)).numpy()
    assert np.all(curve >= 0) and curve.max() > 0
    assert float(prof.time_emissivity_curve(10.0, _t(float(lo) - 5.0))) == 0.0


def test_ring_farfield_slope(ring_profiles):
    """Beyond the ring the illumination falls as a power law: the log-slope
    over r ∈ [15, 40] lies in (−4, −1)."""
    _, prof = ring_profiles
    rq = np.geomspace(15.0, 40.0, 12)
    slope = np.polyfit(np.log(rq), np.log(prof.emissivity_at(_t(rq)).numpy()), 1)[0]
    assert -4.0 < slope < -1.0


def test_ring_small_radius_matches_lamppost(kerr_disc):
    """r → 0: the ring's fan (4 slices × 128 angles, without the
    golden-section refinement, which the reference test runs and which
    refines the caustics only) approaches the on-axis lamp post's sweep in
    shape and scale (ratio in (0.7, 1.4), flat to 0.25)."""
    _, _, tm, td = kerr_disc
    lamp = tgt.emissivity_profile(tm, td, tgt.LampPostModel(h=5.0), n_samples=400)
    ring = tgt.emissivity_profile(
        tm, td, tgt.RingCorona(r=0.05, h=5.0), n_beta=4, n_angles=128, n_refine=0, near_field="fan", **SHORT
    )
    rq = _t([6.0, 10.0, 18.0, 30.0])
    ratio = ring.emissivity_at(rq).numpy() / lamp.emissivity_at(rq).numpy()
    assert np.all(ratio > 0.7) and np.all(ratio < 1.4)
    np.testing.assert_allclose(ratio / ratio.mean(), 1.0, atol=0.25)


def test_fan_building_blocks_match_jax(kerr_disc):
    """On numpy-seeded inputs: `default_beta_angles`, `rodrigues_rotate`,
    `rotated_sky_angles`, the arm split (ties to the first index, as
    `argmin`/`argmax` in both) and the sorted-branch Dauser emissivity
    (its +inf tails and a row with one valid sample) at 1e-12."""
    jm, _, tm, _ = kerr_disc
    rng = np.random.default_rng(9)
    np.testing.assert_allclose(te.default_beta_angles(7).numpy(), np.asarray(je.default_beta_angles(7)), rtol=1e-15)
    k = rng.normal(size=3)
    k /= np.linalg.norm(k)
    v, th = rng.normal(size=(5, 3)), rng.uniform(0, 2 * np.pi, 5)
    np.testing.assert_allclose(
        te.rodrigues_rotate(_t(k), _t(v), _t(th)).numpy(),
        np.asarray(je.rodrigues_rotate(jnp.asarray(k), jnp.asarray(v), jnp.asarray(th))),
        rtol=1e-12, atol=1e-14,
    )
    deltas, betas = np.linspace(1e-4, 2 * np.pi - 1e-4, 11), np.linspace(0, 3.0, 4)
    for a, b in zip(te.rotated_sky_angles(_t(0.6), _t(deltas), _t(betas)), je.rotated_sky_angles(0.6, jnp.asarray(deltas), jnp.asarray(betas))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)
    hit = rng.uniform(size=(4, 24)) > 0.3
    rho = rng.choice([3.0, 4.0, 5.0, 6.0], size=(4, 24))  # ties
    hit[3] = False
    hit[2, :] = False
    hit[2, 5] = True
    ta, tb = te._split_arms(torch.as_tensor(hit), _t(rho))
    for row in range(4):
        ja, jb = je._split_arms(jnp.asarray(hit[row]), jnp.asarray(rho[row]), 24)
        np.testing.assert_array_equal(ta[row].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb[row].numpy(), np.asarray(jb))
    t, delta = rng.uniform(5, 20, (4, 24)), np.sort(rng.uniform(0, 6, (4, 24)), axis=1)
    g, gam = rng.uniform(0.5, 1.5, (4, 24)), rng.uniform(1.0, 1.3, (4, 24))
    rho = rng.uniform(2.0, 40.0, (4, 24))
    spec = tgt.PowerLawSpectrum(2.0)
    got = te._arm_branch(tm, spec, _t(rho), _t(t), _t(delta), _t(g), _t(gam), ta)
    for row in range(4):
        want = je._arm_branch(jm, jgt.PowerLawSpectrum(2.0), *(jnp.asarray(a[row]) for a in (rho, t, delta, g, gam)), jnp.asarray(ta[row].numpy()))
        n = int(want[3])
        assert int(got[3][row]) == n
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a[row, :n].numpy(), np.asarray(b)[:n], rtol=1e-12)
        np.testing.assert_array_equal(got[2][row, n:].numpy(), 0.0)
