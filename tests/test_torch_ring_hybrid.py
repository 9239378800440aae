"""The near-field hybrid profile of a ring corona
(`ring_corona_profile_hybrid`: the β-slice fan with the adaptive sky's
near field), the port's against the JAX package's, in f64 on the CPU, for
a RingCorona(r = 3, h = 4); Kerr a = 0.5, ThinDisc(0, 100).

The hybrid's own work (the near field's radial nodes, the binning of the
sky into them, the fan where the sky never reached, the blend window) on
one seeded fan and sky in both packages, which stand in for
`ring_corona_profile` and `corona_adaptive_sky` (their parity is
tests/test_torch_extended_corona.py's and tests/test_torch_corona_adaptive.py's);
then the whole default dispatch with its traces at a small size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
import gradus_tpu.camera.adaptive as jca  # noqa: E402
import gradus_tpu.corona.adaptive as jad  # noqa: E402
import gradus_tpu.corona.extended as je  # noqa: E402
from gradus_tpu.corona.extended import NearFieldBlendedProfile as JaxBlended  # noqa: E402

import gradus_tpu_torch as tgt  # noqa: E402
import gradus_tpu_torch.corona.adaptive as tad  # noqa: E402
import gradus_tpu_torch.corona.extended as te  # noqa: E402
from gradus_tpu_torch.corona.extended import NearFieldBlendedProfile  # noqa: E402
from gradus_tpu_torch.interop import ring_corona_profile_from_numpy  # noqa: E402

A_SPIN = 0.5


@pytest.fixture(scope="module")
def kerr_disc():
    jm, jd = jgt.KerrMetric(M=1.0, a=A_SPIN), jgt.ThinDisc(0.0, 100.0)
    return jm, jd, tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")


def _fan_and_sky(seed=7):
    """A seeded fan (two slices and arms of sorted radii with +inf tails,
    light-curve times, ε ~ r⁻³) and a seeded sky (the JAX package's
    `AdaptiveGrid2D` at n0 = 6, one refinement, its cells' hits in
    r ∈ [1.2, 5.5] with some misses), as numpy."""
    rng = np.random.default_rng(seed)

    def branches(n):
        r = np.sort(rng.uniform(1.5, 60.0, (2, 12)), axis=1)
        valid = np.arange(12)[None, :] < np.asarray(n)[:, None]
        return dict(
            radii=np.where(valid, r, np.inf), t=np.sort(rng.uniform(2.0, 70.0, (2, 12)), axis=1),
            eps=np.where(valid, r**-3.0, 0.0), n=np.asarray(n),
        )

    fan = dict(left=branches([12, 9]), right=branches([10, 12]))
    grid = jca.AdaptiveGrid2D((-1.0 + 1e-6, 1.0 - 1e-6), (-np.pi, np.pi), 6)
    grid.values = rng.uniform(size=grid.cx.shape)
    grid.refine(grid.values > 0.8)
    n = grid.cx.shape[0]
    hit = rng.uniform(size=n) > 0.2
    vals = {
        "r": rng.uniform(1.2, 5.5, n), "phi": rng.uniform(-np.pi, np.pi, n), "g": rng.uniform(0.5, 1.5, n),
        "gamma": rng.uniform(1.0, 1.3, n), "dr_dth": rng.uniform(0.0, 2.0, n), "dr_dph": rng.uniform(0.0, 1.0, n),
        "t": rng.uniform(2.0, 20.0, n), "J": rng.uniform(0.1, 3.0, n), "area_el": rng.uniform(1.0, 10.0, n),
    }
    vals = {k: np.where(hit, v, np.nan) for k, v in vals.items()}
    return fan, grid, vals


def test_ring_hybrid_assembly_matches_jax(kerr_disc, monkeypatch):
    """On the same seeded fan and sky in both packages (standing in for the
    traces): the radial nodes, the window and the near-field nodes (the
    sky binned, the fan where it never reached) at 1e-12, and ε(r) across
    the blend at 1e-12."""
    jm, jd, tm, td = kerr_disc
    fan, grid, vals = _fan_and_sky()
    jfan = je.RingCoronaProfile(*(je.TimeDependentRadialDiscProfile(**{k: jnp.asarray(v) for k, v in fan[a].items()}) for a in ("left", "right")))
    tfan = ring_corona_profile_from_numpy(fan, device="cpu")
    monkeypatch.setattr(je, "ring_corona_profile", lambda *a, **k: jfan)
    monkeypatch.setattr(te, "ring_corona_profile", lambda *a, **k: tfan)
    monkeypatch.setattr(jad, "corona_adaptive_sky", lambda *a, **k: (grid, vals, grid.cx.shape[0]))
    monkeypatch.setattr(tad, "corona_adaptive_sky", lambda *a, **k: (grid, vals, grid.cx.shape[0]))
    jp = jgt.emissivity_profile(jm, jd, jgt.RingCorona(r=3.0, h=4.0))
    tp = tgt.emissivity_profile(tm, td, tgt.RingCorona(r=3.0, h=4.0))
    assert isinstance(jp, JaxBlended) and isinstance(tp, NearFieldBlendedProfile)
    for f in ("r_nodes", "eps_nodes", "lo0", "lo1", "hi0", "hi1"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), rtol=1e-12)
    rq = [1.3, 1.5, 2.5, 3.0, 3.6, 4.5, 4.9, 8.0, 20.0]
    np.testing.assert_allclose(
        tp.emissivity_at(torch.tensor(rq, dtype=torch.float64)).numpy(), np.asarray(jp.emissivity_at(jnp.asarray(rq))),
        rtol=1e-12,
    )
    assert np.isfinite(tp.eps_nodes.numpy()).all() and (tp.eps_nodes.numpy() > 0).any()


def test_ring_hybrid_profile_matches_jax(kerr_disc):
    """The default dispatch of a RingCorona (``near_field="hybrid"``) at a
    small size (3 slices × 32 angles and 1 golden-section step, the rays
    to λ = 500 or r = 150; the adaptive sky's first 4 × 4 cells, unrefined,
    its refinement being tests/test_torch_corona_adaptive.py's): a
    `NearFieldBlendedProfile` in both
    packages whose radial nodes and window equal the JAX package's at
    1e-12, near-field nodes at 1e-9, and ε(r) across the blend at 1e-9."""
    jm, jd, tm, td = kerr_disc
    kw = dict(n_beta=3, n_angles=32, n_refine=1, lam_max=500.0, chart_outer=150.0, n0=4, rounds=0)
    jp = jgt.emissivity_profile(jm, jd, jgt.RingCorona(r=3.0, h=4.0), **kw)
    tp = tgt.emissivity_profile(tm, td, tgt.RingCorona(r=3.0, h=4.0), **kw)
    assert isinstance(jp, JaxBlended) and isinstance(tp, NearFieldBlendedProfile)
    for f in ("r_nodes", "lo0", "lo1", "hi0", "hi1"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), rtol=1e-12)
    np.testing.assert_allclose(tp.eps_nodes.numpy(), np.asarray(jp.eps_nodes), rtol=1e-9)
    rq = [1.5, 2.5, 3.0, 3.6, 4.5, 4.9, 8.0, 20.0]
    np.testing.assert_allclose(
        tp.emissivity_at(torch.tensor(rq, dtype=torch.float64)).numpy(),
        np.asarray(jp.emissivity_at(jnp.asarray(rq))),
        rtol=1e-9,
    )
    assert float(tp.time_limits_at(10.0)[1]) > float(tp.time_limits_at(10.0)[0]) > 0.0
