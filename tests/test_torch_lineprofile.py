"""Parity of the port's line-profile array code with the JAX reference, in
f64 on the CPU: grids, quadrature, the metric Jacobian, circular orbits, the
conserved-quantity redshift, image planes, the golden-section scan (with a
closed-form probe in place of the integrator), line-profile integration over
a transfer table, and the binned flux. No integrator runs here.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu.camera.grids as jax_grids  # noqa: E402
from gradus_tpu.camera.planes import CartesianPlane as JaxCartesianPlane  # noqa: E402
from gradus_tpu.camera.planes import PolarPlane as JaxPolarPlane  # noqa: E402
from gradus_tpu.geodesics.equation import metric_jacobian as jax_metric_jacobian  # noqa: E402
from gradus_tpu.integrate.points import GeodesicPoint as JaxGeodesicPoint  # noqa: E402
from gradus_tpu.lineprofile import binned_flux as jax_binned_flux  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.orbits.circular import CircularOrbits as JaxCircularOrbits  # noqa: E402
from gradus_tpu.transfer.cunningham import TransferBranchGrid as JaxGrid  # noqa: E402
from gradus_tpu.transfer.cunningham import _golden_scan as jax_golden_scan  # noqa: E402
from gradus_tpu.transfer.integration import integrate_lineprofile as jax_integrate  # noqa: E402
from gradus_tpu.transfer.solvers import _conserved_g_helpers as jax_g_helpers  # noqa: E402
from gradus_tpu.transfer.solvers import rtheta_to_alphabeta as jax_rtheta  # noqa: E402
from gradus_tpu.transfer.tables import CunninghamTransferTable as JaxTable  # noqa: E402
from gradus_tpu.transfer.tables import LineProfileModel as JaxLineProfileModel  # noqa: E402
from gradus_tpu.utils.quadrature import gauss_legendre as jax_gauss_legendre  # noqa: E402

import gradus_tpu_torch.camera.grids as grids  # noqa: E402
from gradus_tpu_torch.corona import AnalyticRadialDiscProfile, DiscCorona, RingCorona, emissivity_profile  # noqa: E402
from gradus_tpu_torch.camera.planes import CartesianPlane, PolarPlane  # noqa: E402
from gradus_tpu_torch.geodesics.equation import metric_jacobian  # noqa: E402
from gradus_tpu_torch.geometry import DatumPlane, ShakuraSunyaev  # noqa: E402
from gradus_tpu_torch.integrate.points import GeodesicPoint  # noqa: E402
from gradus_tpu_torch.lineprofile import BinningMethod, binned_flux, lineprofile  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.orbits.circular import CircularOrbits  # noqa: E402
from gradus_tpu_torch.interop import transfer_grid_from_numpy  # noqa: E402
from gradus_tpu_torch.transfer.cunningham import _golden_scan, _masked_resample  # noqa: E402
from gradus_tpu_torch.transfer.integration import integrate_lineprofile  # noqa: E402
from gradus_tpu_torch.transfer.solvers import _conserved_g_helpers, rtheta_to_alphabeta  # noqa: E402
from gradus_tpu_torch.transfer.tables import CunninghamTransferTable, LineProfileModel  # noqa: E402
from gradus_tpu_torch.utils.quadrature import gauss_legendre  # noqa: E402

A_SPIN = 0.998


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(port, ref, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# --- grids, quadrature, planes ------------------------------------------------


@pytest.mark.parametrize(
    "name", ["LinearGrid", "GeometricGrid", "InverseGrid", "SinGrid", "CosGrid", "LogisticGrid"]
)
def test_grids_match_jax(name):
    for lo, hi, n in ((1.2, 50.0, 7), (0.5, 1000.0, 64)):
        _close(getattr(grids, name)()(lo, hi, n), getattr(jax_grids, name)()(lo, hi, n))
    # tensor end points set the dtype and stay differentiable
    lo = torch.tensor(2.0, dtype=torch.float32, requires_grad=True)
    out = getattr(grids, name)()(lo, 30.0, 5)
    assert out.dtype == torch.float32 and out.requires_grad


@pytest.mark.parametrize("n", [3, 7, 16])
def test_gauss_legendre_matches_jax(n):
    x, w = gauss_legendre(n)
    xj, wj = jax_gauss_legendre(n)
    _close(x, xj)
    _close(w, wj)
    np.testing.assert_allclose(float(w.sum()), 2.0, rtol=1e-14)


def test_image_planes_match_jax():
    for kw in (dict(Nr=12, Ntheta=9, r_max=50.0), dict(Nr=5, Ntheta=4, r_min=2.0, r_max=250.0)):
        p, pj = PolarPlane(grids.GeometricGrid(), **kw, device="cpu"), JaxPolarPlane(jax_grids.GeometricGrid(), **kw)
        for got, ref in zip(p.impact_parameters(), pj.impact_parameters()):
            _close(got, ref, atol=1e-12)
        _close(p.unnormalized_areas(), pj.unnormalized_areas())
        assert p.trajectory_count() == pj.trajectory_count()
    c, cj = CartesianPlane(Nx=6, Ny=4, device="cpu"), JaxCartesianPlane(Nx=6, Ny=4)
    for got, ref in zip(c.impact_parameters(), cj.impact_parameters()):
        _close(got, ref, atol=1e-15)
    _close(c.unnormalized_areas(), cj.unnormalized_areas())


# --- metric Jacobian, orbits, conserved-quantity redshift -----------------------


@pytest.fixture(scope="module")
def kerr_radii():
    tm, jm = KerrMetric(1.0, A_SPIN, device="cpu"), JaxKerr(M=1.0, a=A_SPIN)
    r = np.geomspace(float(tm.isco()), 1000.0, 24)
    return tm, jm, r


def test_metric_jacobian_matches_jax(kerr_radii):
    tm, jm, r = kerr_radii
    th = np.random.default_rng(3).uniform(0.2, np.pi - 0.2, r.shape)
    for got, ref in zip(metric_jacobian(tm, _t(r), _t(th)), jax_metric_jacobian(jm, r, th)):
        _close(got, ref, rtol=1e-12, atol=1e-12)
    # the port's hand-derived Kerr Jacobian agrees with the forward-mode one
    g, dr, dth = tm.components5_jac(_t(r), _t(th))
    _, dr_ad, dth_ad = metric_jacobian(tm, _t(r), _t(th))
    _close(torch.stack(dr, -1), dr_ad.numpy(), rtol=1e-12, atol=1e-12)
    _close(torch.stack(dth, -1), dth_ad.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["Omega", "ut_uphi", "fourvelocity", "plunging_fourvelocity"])
def test_circular_orbits_match_jax(kerr_radii, fn):
    tm, jm, r = kerr_radii
    got = getattr(CircularOrbits, fn)(tm, _t(r))
    ref = getattr(JaxCircularOrbits, fn)(jm, jnp.asarray(r))
    if isinstance(got, tuple):
        for a, b in zip(got, ref):
            _close(a, b, atol=1e-15)
        return
    if fn == "plunging_fourvelocity":
        # vʳ = −√|norm residual|: the residual cancels to roundoff (~1e-16) on
        # circular orbits, so vʳ is √roundoff ~ 1e-8 in both packages
        _close(got[..., 1], np.asarray(ref)[..., 1], rtol=0, atol=1e-7)
        got, ref = got[..., [0, 2, 3]], np.asarray(ref)[..., [0, 2, 3]]
    _close(got, ref, atol=1e-15)


def test_rtheta_to_alphabeta_matches_jax():
    rng = np.random.default_rng(4)
    r, th = rng.uniform(1, 60, 32), rng.uniform(0, 2 * np.pi, 32)
    for got, ref in zip(rtheta_to_alphabeta(_t(r), _t(th), 0.3, -0.1), jax_rtheta(r, th, 0.3, -0.1)):
        _close(got, ref, atol=1e-14)


def test_conserved_g_helpers_match_jax(kerr_radii):
    tm, jm, r = kerr_radii
    rng = np.random.default_rng(5)
    n = r.shape[0]
    x_init = np.tile([0.0, 1000.0, np.deg2rad(60.0), 0.0], (n, 1))
    v_init = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 3)) * [1.0, 1e-4, 1e-7]], -1)
    lam_t, g_t = _conserved_g_helpers(tm)
    lam_j, g_j = jax_g_helpers(jm)
    gp_t = GeodesicPoint(None, None, None, _t(x_init), _t(v_init), None, None)
    gp_j = JaxGeodesicPoint(None, None, None, jnp.asarray(x_init), jnp.asarray(v_init), None, None)
    _close(lam_t(gp_t), lam_j(gp_j))
    lam = rng.uniform(-6.0, 6.0, n)
    _close(g_t(_t(lam), _t(r)), g_j(jnp.asarray(lam), jnp.asarray(r)))


# --- the golden-section scan ----------------------------------------------------


def _jax_probe(rt, th, warm):
    r_off = rt * (1.0 + 0.1 * jnp.sin(th)) + jnp.where(jnp.isfinite(warm), 1e-3 * warm, 0.0)
    g = 1.0 + 0.3 * jnp.cos(th - 0.2 * rt)
    return r_off, g, 100.0 + th, jnp.cos(th) > -0.999


def _torch_probe(rt, th, warm):
    r_off = rt * (1.0 + 0.1 * torch.sin(th)) + torch.where(torch.isfinite(warm), 1e-3 * warm, 0.0)
    g = 1.0 + 0.3 * torch.cos(th - 0.2 * rt)
    return r_off, g, 100.0 + th, torch.cos(th) > -0.999


@pytest.mark.parametrize("warm_start", [True, False])
def test_golden_scan_matches_jax(warm_start):
    radii = np.array([3.0, 7.5, 20.0])
    warm0 = np.stack([radii * 1.1, radii * 0.9])
    ref = jax_golden_scan(
        JaxKerr(M=1.0, a=A_SPIN),
        jnp.asarray([0.0, 1000.0, 1.0, 0.0]),
        None,
        jnp.asarray(radii),
        jnp.asarray(0.3),
        jnp.asarray(2000.0),
        jnp.asarray(warm0),
        N_extrema=6,
        newton_iters=30,
        zero_atol=1e-7,
        alpha0=0.0,
        beta0=0.0,
        warm_start=warm_start,
        probe_fn=_jax_probe,
    )
    got = _golden_scan(_t(radii), 0.3, _t(warm0), N_extrema=6, probe_fn=_torch_probe, warm_start=warm_start)
    assert got[0].shape == (8, 2, 3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_masked_resample_wraps_with_fewer_than_two_samples():
    """Reproduces the JAX package's n − 2 < 0 index wrap (ROADMAP queue C)."""
    from gradus_tpu.transfer.cunningham import _masked_resample as jax_resample

    rng = np.random.default_rng(6)
    gs, vals = rng.uniform(0, 1, (3, 8)), rng.normal(size=(3, 8))
    mask = np.zeros((3, 8), bool)
    mask[0, 3] = True  # one valid sample
    mask[2, [1, 4, 6]] = True
    gq = np.linspace(0.05, 0.95, 5)
    got = _masked_resample(_t(gq), _t(gs), _t(vals), _t(mask))
    for row in range(3):
        ref = jax_resample(jnp.asarray(gq), jnp.asarray(gs[row]), jnp.asarray(vals[row]), jnp.asarray(mask[row]))
        np.testing.assert_allclose(got[row].numpy(), np.asarray(ref), rtol=1e-15)


# --- line-profile integration over a transfer table -----------------------------


def _synthetic_grid(seed, nr=12, Ng=24):
    """Smooth transfer-function branches over (rₑ, g✶) as numpy arrays."""
    rng = np.random.default_rng(seed)
    radii = np.geomspace(1.4, 60.0, nr)
    gmin = 0.25 + 0.6 * (1.0 - 1.3 / radii) + 0.01 * rng.uniform(size=nr)
    gmax = 1.0 + 0.4 / np.sqrt(radii) + 0.01 * rng.uniform(size=nr)
    gstar = np.linspace(1e-3, 1 - 1e-3, Ng)
    shape = np.sqrt(gstar * (1 - gstar))[None, :]
    amp = (1.0 / radii)[:, None]
    return dict(
        radii=radii,
        gmin=gmin,
        gmax=gmax,
        gstar=gstar,
        lower_f=amp * shape * (0.8 + 0.1 * rng.uniform(size=(nr, Ng))),
        upper_f=amp * shape * (1.2 + 0.1 * rng.uniform(size=(nr, Ng))),
        lower_t=radii[:, None] + 5 * gstar[None, :] + rng.uniform(size=(nr, Ng)),
        upper_t=radii[:, None] + 9 * gstar[None, :] + rng.uniform(size=(nr, Ng)),
    )


@pytest.mark.parametrize(
    "bins", [(0.1, 1.5, 40), (0.2, 1.45, 181)], ids=["coarse", "fine_with_edge_bins"]
)
def test_integrate_lineprofile_matches_jax(bins):
    d = _synthetic_grid(7)
    g_grid = np.linspace(*bins)
    emis = lambda r: r**-3.0  # noqa: E731
    ref = jax_integrate(emis, JaxGrid(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(g_grid), n_radii=200)
    got = integrate_lineprofile(emis, transfer_grid_from_numpy(d, device="cpu"), _t(g_grid), n_radii=200)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-300)
    assert got[-1] == 0 and math.isclose(float(got.sum()), 1.0, rel_tol=1e-12)


def test_line_profile_model_over_a_table_matches_jax():
    cells = [[_synthetic_grid(10 + 2 * i + j) for j in range(2)] for i in range(2)]

    def stack(k):
        return np.stack([np.stack([c[k] for c in row]) for row in cells])

    keys = ("radii", "gmin", "gmax", "lower_f", "upper_f", "lower_t", "upper_t")
    arrays = dict(a_grid=np.array([0.5, 0.998]), theta_grid=np.array([30.0, 60.0]), gstar=cells[0][0]["gstar"])
    arrays.update({k: stack(k) for k in keys})
    table_t = CunninghamTransferTable(**{k: _t(v) for k, v in arrays.items()})
    table_j = JaxTable(**{k: jnp.asarray(v) for k, v in arrays.items()})
    energies = np.linspace(3.0, 8.0, 60)
    params = dict(a=0.9, theta_obs=41.0, inner_r=2.0, outer_r=40.0, lineE=6.4, K=2.0)
    got = LineProfileModel(table_t, **params)(_t(energies))
    ref = JaxLineProfileModel(table_j, **params)(jnp.asarray(energies))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-300)
    # overrides at call time, as in a fit
    got2 = LineProfileModel(table_t, **params)(_t(energies), a=0.6, theta_obs=55.0)
    ref2 = JaxLineProfileModel(table_j, **params)(jnp.asarray(energies), a=0.6, theta_obs=55.0)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), rtol=1e-10, atol=1e-300)


# --- the binned flux ------------------------------------------------------------


def test_binned_flux_matches_jax():
    rng = np.random.default_rng(8)
    n = 4000
    fields = dict(
        status=rng.choice([0, 1, 3], size=n, p=[0.2, 0.1, 0.7]).astype(np.int32),
        lam_min=np.zeros(n),
        lam_max=rng.uniform(900, 1100, n),
        x_init=np.tile([0.0, 1000.0, 1.2, 0.0], (n, 1)),
        v_init=rng.normal(size=(n, 4)),
        x=np.stack(
            [rng.uniform(900, 1100, n), rng.uniform(1.0, 80.0, n), rng.uniform(1.4, 1.7, n), rng.uniform(0, 6.3, n)], -1
        ),
        v=rng.normal(size=(n, 4)),
    )
    areas = rng.uniform(0.5, 2.0, n)
    bins = np.linspace(0.1, 1.4, 120)

    def pf_j(m, gp, t):
        return 0.4 + gp.x[..., 1] / 80.0 + 0.2 * jnp.cos(gp.x[..., 3])

    def pf_t(m, gp, t):
        return 0.4 + gp.x[..., 1] / 80.0 + 0.2 * torch.cos(gp.x[..., 3])

    kw = dict(min_re=1.237, max_re=60.0, lam_max=2000.0)
    ref = jax_binned_flux(
        None, JaxGeodesicPoint(**{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(areas),
        lambda r: r**-3.0, jnp.asarray(bins), redshift_pf=pf_j, **kw,
    )
    got = binned_flux(
        None, GeodesicPoint(**{k: _t(v) for k, v in fields.items()}), _t(areas),
        lambda r: r**-3.0, _t(bins), redshift_pf=pf_t, **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-300)
    assert (got > 0).sum() > 50 and math.isclose(float(got.sum()), 1.0, rel_tol=1e-12)


# --- what is not ported raises ----------------------------------------------------


@pytest.mark.parametrize("case", ["binning_method", "profile", "axis_name", "xla_backend"])
def test_unported_line_profile_paths_raise(case, monkeypatch):
    """`binned_flux(axis_name=...)` and a thick disc's transfer functions on
    the `cuda` backend raise. The ring's and the disc's profiles without a
    sampler (``binning_method``, ``profile``) raised until corona/extended.py
    was ported: now `emissivity_profile` dispatches them there (its
    profile functions stubbed here with r⁻³; their parity is
    tests/test_torch_extended_corona.py's and tests/test_torch_disc_corona.py's)
    and the binned line profile, on a 4 × 4 plane, takes the profile's ε."""
    m = KerrMetric(1.0, A_SPIN, device="cpu")
    x = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=torch.float64)
    d = DatumPlane(0.0, device="cpu")
    if case in ("binning_method", "profile"):
        extended = importlib.import_module("gradus_tpu_torch.corona.extended")
        built = []
        for name in ("ring_corona_profile_hybrid", "disc_corona_profile"):
            monkeypatch.setattr(extended, name, lambda *a, _n=name, **k: built.append(_n) or AnalyticRadialDiscProfile(lambda r: r**-3.0))
        prof = emissivity_profile(m, d, RingCorona() if case == "binning_method" else DiscCorona())
        plane = PolarPlane(grids.GeometricGrid(), Nr=4, Ntheta=4, r_max=30.0, dtype=torch.float64, device="cpu")
        bins, flux = lineprofile(m, x, d, method=BinningMethod(), profile=prof, plane=plane)
        assert built == ["ring_corona_profile_hybrid" if case == "binning_method" else "disc_corona_profile"]
        assert bool(torch.isfinite(flux).all()) and math.isclose(float(flux.sum()), 1.0, rel_tol=1e-12)
        return
    with pytest.raises(NotImplementedError):
        if case == "axis_name":
            binned_flux(m, None, None, None, None, min_re=1, max_re=2, lam_max=1, redshift_pf=None, axis_name="i")
        else:
            # a thick disc's transfer functions, on the backend that refuses it
            lineprofile(m, x, ShakuraSunyaev.from_metric(m), backend="cuda")


def test_transfer_grid_interop_round_trip():
    d = _synthetic_grid(9)
    g = transfer_grid_from_numpy(d, device="cpu")
    for f in dataclasses.fields(g):
        np.testing.assert_array_equal(getattr(g, f.name).numpy(), d[f.name])
    at = g.at_radius(_t(np.array([1.4, 5.0, 60.0, 100.0])))
    np.testing.assert_allclose(at["gmin"][[0, 2, 3]].numpy(), d["gmin"][[0, -1, -1]], rtol=1e-15)
