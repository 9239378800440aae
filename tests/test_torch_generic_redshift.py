"""The port's generic redshift path against the JAX package, in f64 on the
CPU: the generic ISCO (scan, bisection, Newton on dE/dr = 0 with nested
AD), the closed-form plunging velocities, and the dot-product redshift point
function, for the deformed metrics of tests/test_metrics.py:26-32; and the
dot-product path on Kerr against the analytic one (the JAX package's
tests/test_redshift_analytic.py cross-check).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu import metrics as jax_metrics  # noqa: E402
from gradus_tpu.integrate.points import GeodesicPoint as JaxGeodesicPoint  # noqa: E402
from gradus_tpu.orbits.plunging import interpolate_plunging_velocities as jax_plunging  # noqa: E402
from gradus_tpu.redshift import redshift_pointfunction as jax_redshift  # noqa: E402

from gradus_tpu_torch import metrics  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes  # noqa: E402
from gradus_tpu_torch.interop import from_numpy, geodesic_points_from_numpy  # noqa: E402
from gradus_tpu_torch.orbits import interpolate_plunging_velocities, isco  # noqa: E402
from gradus_tpu_torch.redshift import interpolate_redshift, redshift_pointfunction  # noqa: E402
from gradus_tpu_torch.utils.linalg import equatorial_project  # noqa: E402

DEFORMED = {
    "JohannsenMetric": dict(M=1.0, a=0.6, alpha13=0.2, alpha22=0.1, eps3=0.5),
    "JohannsenPsaltisMetric": dict(M=1.0, a=0.6, eps3=2.0),
    "NoZMetric": dict(M=1.0, a=0.5, eps=0.3),
    "BumblebeeMetric": dict(M=1.0, a=0.2, l=0.1),
    "DilatonAxion": dict(M=1.0, a=0.5, beta=0.2, b=1.0),
}
# the JAX package's generic isco at these parameters, f64 on a CPU
JAX_ISCO = {
    "JohannsenPsaltisMetric": 2.867876680474741,
    "JohannsenMetric": 3.8718325143361603,
    "NoZMetric": 4.2330025295308324,
    "BumblebeeMetric": 5.293645577744764,
    "DilatonAxion": 8.409555985156034,
}


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _pair(kind):
    jm = getattr(jax_metrics, kind)(**DEFORMED[kind])
    return jm, from_numpy(kind, _params(jm), device="cpu")


@pytest.mark.parametrize("kind", DEFORMED)
def test_generic_isco_matches_jax(kind):
    _, tm = _pair(kind)
    r = isco(tm)
    assert r.dtype == torch.float64 and r.dim() == 0
    np.testing.assert_allclose(float(r), JAX_ISCO[kind], rtol=1e-10)
    assert float(tm.isco()) == float(r)


def test_generic_isco_of_a_kerr_limit():
    """JP with ε₃ = 0 is Kerr: the generic root-finder lands on Bardeen's
    analytic ISCO (tests/test_orbits.py:47)."""
    generic = isco(metrics.JohannsenPsaltisMetric(1.0, 0.7, 0.0, device="cpu"))
    analytic = metrics.kerr_isco(1.0, torch.tensor(0.7, dtype=torch.float64))
    np.testing.assert_allclose(float(generic), float(analytic), rtol=1e-8)


@pytest.mark.parametrize("kind", ["JohannsenPsaltisMetric", "DilatonAxion"])
def test_plunging_velocities_match_jax(kind):
    jm, tm = _pair(kind)
    pj, pt = jax_plunging(jm), interpolate_plunging_velocities(tm)
    for name in ("r_isco", "E", "L"):
        np.testing.assert_allclose(float(getattr(pt, name)), float(getattr(pj, name)), rtol=1e-10)
    r_in = float(jm.inner_radius())
    r = np.linspace(1.1 * r_in, 0.9 * float(pj.r_isco), 17)
    got = pt(torch.as_tensor(r)).numpy()
    ref = np.asarray(pj(jnp.asarray(r)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-15)
    assert (got[:, 1] < 0).all()


def _disc_points(jm, r_isco, seed, n=96):
    """GeodesicPoint fields: disc points at θ ≈ π/2, a quarter of them
    inside the ISCO, null-ish momenta, the observer at r = 1000, i = 60°."""
    rng = np.random.default_rng(seed)
    k = n // 4
    r = np.concatenate(
        [rng.uniform(1.1 * float(jm.inner_radius()), r_isco, k), rng.uniform(r_isco, 50.0, n - k)]
    )
    x = np.stack([rng.uniform(900, 1100, n), r, np.pi / 2 + rng.uniform(-1e-9, 1e-9, n), rng.uniform(0, 6.3, n)], -1)
    v = np.concatenate([np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], -1)
    x_init = np.tile([0.0, 1000.0, math.radians(60.0), 0.0], (n, 1))
    v_init = np.concatenate([np.ones((n, 1)), 1e-3 * rng.normal(size=(n, 3))], -1)
    return dict(
        status=np.full(n, StatusCodes.IntersectedWithGeometry, np.int32),
        lam_min=np.zeros(n),
        lam_max=rng.uniform(900, 1100, n),
        x_init=x_init,
        v_init=v_init,
        x=x,
        v=v,
    )


@pytest.mark.parametrize("kind", DEFORMED)
def test_dot_product_redshift_matches_jax(kind):
    jm, tm = _pair(kind)
    fields = _disc_points(jm, JAX_ISCO[kind], 7)
    x_obs = fields["x_init"][0]
    gp_j = JaxGeodesicPoint(**{k: jnp.asarray(v) for k, v in fields.items()})
    gp_t = geodesic_points_from_numpy(fields, device="cpu")
    ref = np.asarray(jax_redshift(jm, jnp.asarray(x_obs))(jm, gp_j, 2000.0))
    pf = redshift_pointfunction(tm, torch.as_tensor(x_obs))
    assert not pf.is_analytic_kerr
    got = pf(tm, gp_t, 2000.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_never_on_kerr_agrees_with_analytic():
    """g over traced disc hits, the dot-product path forced on Kerr against
    the closed form, with the JAX package's budgets: Keplerian ≤ 5e-7 (the
    integrator's momentum drift, which only the dot-product path reads),
    plunging ≤ 1e-6."""
    m = metrics.KerrMetric(1.0, 0.998, device="cpu")
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=torch.float64)
    side = 12
    al = torch.linspace(-18.0, 18.0, side, dtype=torch.float64) + 1e-3
    A, B = al[:, None].expand(side, side).reshape(-1), al[None, :].expand(side, side).reshape(-1)
    v = map_impact_parameters(m, x, A, B)
    gp = CudaTracer(m, geometry=ThinDisc(0.0, 50.0, device="cpu"))(x.expand_as(v), v, (0.0, 2200.0))
    pf_ana = redshift_pointfunction(m, x, analytic="always")
    pf_gen = redshift_pointfunction(m, x, analytic="never")
    assert pf_ana.is_analytic_kerr and not pf_gen.is_analytic_kerr
    g_ana, g_gen = pf_ana(m, gp, 2200.0), pf_gen(m, gp, 2200.0)
    hit = gp.status == StatusCodes.IntersectedWithGeometry
    r_em, r_isco = equatorial_project(gp.x), float(m.isco())
    kep = hit & (r_em >= r_isco * (1 + 1e-6))
    plunge = hit & (r_em < r_isco * (1 - 1e-6))
    assert kep.sum() > 50 and plunge.sum() > 0
    rel = ((g_ana - g_gen) / g_gen).abs()
    assert float(rel[kep].max()) < 5e-7
    assert float(rel[plunge].max()) < 1e-6


def test_auto_dispatch():
    """`analytic='auto'` takes the closed form exactly for prograde Kerr;
    'always' refuses anything else (tests/test_redshift_analytic.py)."""
    mk = metrics.KerrMetric(1.0, 0.9, device="cpu")
    assert redshift_pointfunction(mk, analytic="auto").is_analytic_kerr
    assert not redshift_pointfunction(mk, contra_rotating=True, analytic="auto").is_analytic_kerr
    mj = metrics.JohannsenMetric(1.0, 0.6, device="cpu")
    assert not redshift_pointfunction(mj, analytic="auto").is_analytic_kerr
    assert not interpolate_redshift(mj).is_analytic_kerr
    with pytest.raises(ValueError):
        redshift_pointfunction(mj, analytic="always")
