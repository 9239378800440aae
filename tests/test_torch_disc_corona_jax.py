"""The JAX package's disc corona against the port's, in f64 on the CPU,
through `emissivity_profile`'s dispatch: a DiscCorona(r = 6, h = 4) stack
at tests/test_extended_corona.py's size (3 rings × 4 slices × 64 angles
and the 16 + 2 golden-section probe traces, each of every ring at once;
the JAX package maps over the rings and does not let a caller change
their refinement); Kerr a = 0.5, ThinDisc(0, 100), rays to λ = 500 or
r = 150 (past the disc's edge at r = 100).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402

import gradus_tpu_torch.corona.extended as te  # noqa: E402
import gradus_tpu_torch as tgt  # noqa: E402
from gradus_tpu_torch.interop import disc_corona_profile_from_numpy  # noqa: E402
from torch_corona_helpers import np_fields  # noqa: E402

A_SPIN = 0.5
SHORT = dict(lam_max=500.0, chart_outer=150.0)


def _t(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


@pytest.fixture(scope="module")
def kerr_disc():
    jm, jd = jgt.KerrMetric(M=1.0, a=A_SPIN), jgt.ThinDisc(0.0, 100.0)
    return jm, jd, tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")


@pytest.fixture(scope="module")
def disc_profiles(kerr_disc):
    """Both packages' DiscCorona(r = 6, h = 4) at tests/test_extended_corona.py's size."""
    jm, jd, tm, td = kerr_disc
    kw = dict(n_rings=3, n_beta=4, n_angles=64, **SHORT)
    return (
        jgt.emissivity_profile(jm, jd, jgt.DiscCorona(r=6.0, h=4.0), **kw),
        tgt.emissivity_profile(tm, td, tgt.DiscCorona(r=6.0, h=4.0), **kw),
    )


def test_disc_corona_matches_jax(disc_profiles):
    """The ring stack, one flat batch of 768 fan rays in the port: each
    ring's branches (the same valid counts; radii and t at 1e-9, ε at 4e-6:
    measured 3.9e-7 in 7 of 288 samples, where the ε's neighbour
    differences of radii cancel), ε(r) at 4e-6, the flux-weighted arrival
    time and the light curve's limits at 1e-9, with propagation delays
    r/0.5 too; the stack carried across by
    `interop.disc_corona_profile_from_numpy` at 1e-12."""
    jp, tp = disc_profiles
    assert isinstance(tp, te.DiscCoronaProfile)
    np.testing.assert_allclose(tp.radii.numpy(), np.asarray(jp.radii), rtol=1e-15)
    for arm in ("left", "right"):
        a, b = getattr(jp.rings, arm), getattr(tp.rings, arm)
        n = np.asarray(a.n)
        np.testing.assert_array_equal(b.n.numpy(), n)
        valid = np.arange(np.asarray(a.radii).shape[-1]) < n[..., None]
        for f, tol in (("radii", 1e-9), ("t", 1e-9), ("eps", 4e-6)):
            np.testing.assert_allclose(getattr(b, f).numpy()[valid], np.asarray(getattr(a, f))[valid], rtol=tol)
    rq = [8.0, 12.0, 16.0, 32.0]
    for name, tol in (("emissivity_at", 4e-6), ("coordtime_at", 1e-9)):
        np.testing.assert_allclose(
            getattr(tp, name)(_t(rq)).numpy(), np.asarray(getattr(jp, name)(jnp.asarray(rq))), rtol=tol
        )
    for j, t in ((jp, tp), (jp.with_propagation_velocity(lambda r: r / 0.5), tp.with_propagation_velocity(lambda r: r / 0.5))):
        np.testing.assert_allclose([float(v) for v in t.time_limits_at(12.0)], [float(v) for v in j.time_limits_at(12.0)], rtol=1e-9)
    via = disc_corona_profile_from_numpy(np_fields(jp), device="cpu")
    np.testing.assert_allclose(via.emissivity_at(_t(rq)).numpy(), np.asarray(jp.emissivity_at(jnp.asarray(rq))), rtol=1e-12)
