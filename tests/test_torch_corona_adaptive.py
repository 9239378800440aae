"""The port's adaptive sampling against the JAX package's, in f64 on the CPU.

`camera/adaptive.py` is host numpy in both packages: the grid, its
refinement, disparities, rasterisation and the refine loops give the same
arrays bit for bit (tests/test_adaptive_fill.py's cases). `corona/adaptive.py`
traces each refinement round on the metric's device; the port carries the
two Jacobian columns as one trace of 2N rays (the cells' rays twice, each
copy with its own tangent) where the JAX package makes two forward-mode
passes: the outputs are bit for bit those of two passes. At a small n0 the
adaptive sky of a RingCorona(r = 3, h = 4) (Kerr a = 0.5, ThinDisc(0, 100))
refines the same cells as the JAX package's, with values at the solver's
rounding; its binning follows. The near-field hybrid profile is
tests/test_torch_ring_hybrid.py's.
"""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gradus_tpu as jgt  # noqa: E402
import gradus_tpu.camera.adaptive as jca  # noqa: E402
import gradus_tpu.corona.adaptive as jad  # noqa: E402

import gradus_tpu_torch as tgt  # noqa: E402
import gradus_tpu_torch.camera.adaptive as tca  # noqa: E402
import gradus_tpu_torch.corona.adaptive as tad  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.corona.samplers import sky_angles_to_velocity  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, domain_upper_hemisphere, trace_geodesics  # noqa: E402
from gradus_tpu_torch.utils import equatorial_project  # noqa: E402
from gradus_tpu_torch.utils.jvp import jvp  # noqa: E402

A_SPIN = 0.5
SKY = dict(n0=5, rounds=1, max_refine=6, lam_max=300.0, chart_outer=150.0)
FIELDS = ("t", "r", "phi", "g", "J", "gamma", "area_el", "dr_dth", "dr_dph")


def _step_values(cx, cy):
    """Synthetic field with a sharp circular edge (a fake shadow)."""
    r = np.hypot(cx, cy)
    return np.where(r < 4.0, np.nan, 1.0 / np.maximum(r, 1e-6))


def _same_grid(a, b):
    for f in ("cx", "cy", "w", "h", "depth"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.fixture(scope="module")
def kerr_disc():
    jm, jd = jgt.KerrMetric(M=1.0, a=A_SPIN), jgt.ThinDisc(0.0, 100.0)
    return jm, jd, tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")


@pytest.fixture(scope="module")
def skies(kerr_disc):
    jm, jd, tm, td = kerr_disc
    return (
        jad.corona_adaptive_sky(jm, jd, jgt.RingCorona(r=3.0, h=4.0), **SKY),
        tad.corona_adaptive_sky(tm, td, tgt.RingCorona(r=3.0, h=4.0), **SKY),
    )


@pytest.mark.parametrize("n0", [12, 110])
def test_disparity_kdtree_matches_bruteforce_and_jax(n0):
    """The k-d tree disparity equals the brute-force one (n0 = 12) and the
    JAX package's bit for bit; 12,100 cells take well under a second
    (n0 = 110)."""
    grid, jgrid = tca.AdaptiveGrid2D((-8, 8), (-8, 8), n0=n0), jca.AdaptiveGrid2D((-8, 8), (-8, 8), n0=n0)
    for g in (grid, jgrid):
        g._v_old = None
        g.set_values(_step_values(g.cx, g.cy))
    t0 = time.perf_counter()
    fast = grid.neighbour_disparity()
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(fast, jgrid.neighbour_disparity())
    if n0 == 12:
        np.testing.assert_allclose(fast, grid._neighbour_disparity_brute())
    else:
        assert seconds < 2.0


def test_refinement_concentrates_at_edge_as_jax():
    """`adaptive_render` on the fake shadow: the same cells as the JAX
    package's, and the deep ones hug the edge r = 4."""
    kw = dict(alpha_lims=(-8, 8), beta_lims=(-8, 8), n0=12, rounds=3, max_depth=3, threshold=0.05)
    grid = tgt.adaptive_render(None, None, _step_values, **kw)
    _same_grid(grid, jgt.adaptive_render(None, None, _step_values, **kw))
    deep = grid.depth >= 2
    assert deep.sum() > 50
    assert (np.abs(np.hypot(grid.cx[deep], grid.cy[deep]) - 4.0) < 1.5).mean() > 0.9


def test_fill_sky_values_reconstruction():
    """The rasterised image reproduces the field, keeps the NaN boundary,
    and equals the JAX package's bit for bit; `adaptive_sky` refines the
    same cells as the JAX package's."""
    kw = dict(alpha_lims=(-8, 8), beta_lims=(-8, 8), n0=12, rounds=2, max_depth=2, threshold=0.05)
    grid = tgt.adaptive_render(None, None, _step_values, **kw)
    xs, ys, img = tgt.fill_sky_values(grid, 96, 96)
    np.testing.assert_array_equal(img, jgt.fill_sky_values(jgt.adaptive_render(None, None, _step_values, **kw), 96, 96)[2])
    assert img.shape == (96, 96)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    R = np.hypot(X, Y)
    inside, outside = R < 3.4, (R > 4.8) & (R < 7.5)
    assert np.isnan(img[inside]).mean() > 0.9
    ok = np.isfinite(img[outside])
    assert ok.mean() > 0.98
    assert np.median(np.abs(img[outside][ok] - 1.0 / R[outside][ok]) * R[outside][ok]) < 0.05

    def sky_field(c, p):
        return np.cos(3 * p) * c

    _same_grid(tgt.adaptive_sky(None, sky_field), jgt.adaptive_sky(None, sky_field))


def test_adaptive_shadow_render_real_trace():
    """Refinement around a real Schwarzschild shadow edge (critical impact
    parameter 3√3) through the port's `trace_geodesics`."""
    m = tgt.KerrMetric(1.0, 0.0, device="cpu")
    x = torch.tensor([0.0, 200.0, math.pi / 2, 0.0], dtype=torch.float64)

    def evaluate(al, be):
        v = map_impact_parameters(m, x, torch.as_tensor(al), torch.as_tensor(be))
        gp = trace_geodesics(m, x.expand_as(v), v, (0.0, 500.0), chart_outer=250.0)
        return np.where((gp.status == StatusCodes.WithinInnerBoundary).numpy(), np.nan, 1.0)

    grid = tgt.adaptive_render(
        m, x, evaluate, alpha_lims=(-9.0, 9.0), beta_lims=(-9.0, 9.0), n0=10, rounds=2, max_depth=2, threshold=5.0
    )
    deep = grid.depth >= 1
    assert deep.sum() > 20
    assert (np.abs(np.hypot(grid.cx[deep], grid.cy[deep]) - 3.0 * math.sqrt(3.0)) < 2.0).mean() > 0.8


def test_two_tangents_in_one_trace_are_two_passes(kerr_disc):
    """`CoronaSkyTracer` traces the N cells' rays twice in one batch, the
    first copy with ∂/∂θ, the second with ∂/∂φ: r, φ_disc and their
    derivatives equal those of two separate forward-mode traces bit for bit
    (16 seeded cells). On the CPU PyTorch's vectorised loops run the last
    n mod 16 elements of an f64 tensor through scalar code (AVX-512: two
    vectors of 8 an iteration), whose `atan2` and kin round otherwise, so
    each ray's arithmetic is its own pass's only when both batches fill
    whole vectors, as 16 and 32 rays do; on the card each ray is one
    thread's arithmetic whatever N (tests/test_torch_lockstep_graph.py's
    `cuda` case takes 24)."""
    _, _, tm, td = kerr_disc
    tracer = tad.CoronaSkyTracer(tm, td, tgt.RingCorona(r=3.0, h=4.0), lam_max=150.0, chart_outer=120.0)
    rng = np.random.default_rng(2)
    th = torch.as_tensor(np.arccos(rng.uniform(-1, 1, 16)))
    ph = torch.as_tensor(rng.uniform(-np.pi, np.pi, 16))
    vals, _ = tracer._eval(th, ph)

    def one_pass(th_dot, ph_dot):
        v, v_dot = jvp(
            lambda a, b: sky_angles_to_velocity(tm, tracer.x_src, tracer.v_src, a, b), (th, ph), (th_dot, ph_dot)
        )
        gp, gp_dot = trace_geodesics(
            tm, tracer.x_src.expand_as(v), v, (0.0, 150.0), geometry=td, chart_outer=120.0,
            terminate_fns=(domain_upper_hemisphere(),), constrain=False, v_dot=v_dot,
        )
        r, dr = jvp(equatorial_project, (gp.x,), (gp_dot.x,))
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        return hit, r, dr, gp.x[:, 3], gp_dot.x[:, 3]

    one, zero = torch.ones_like(th), torch.zeros_like(th)
    hit, r, dr_dth, phi, dphi_dth = one_pass(one, zero)
    hit2, r2, dr_dph, phi2, dphi_dph = one_pass(zero, one)
    assert torch.equal(hit, hit2) and torch.equal(r, r2) and int(hit.sum()) >= 5
    assert torch.equal(vals["r"][hit], r[hit]) and torch.equal(vals["phi"][hit], phi[hit])
    assert torch.equal(vals["dr_dth"][hit], dr_dth.abs()[hit]) and torch.equal(vals["dr_dph"][hit], dr_dph.abs()[hit])
    J = torch.abs(dr_dth * dphi_dph - dr_dph * dphi_dth) / torch.sin(th)
    assert torch.equal(vals["J"][hit], J[hit]) and bool(torch.isnan(vals["J"][~hit]).all())


def test_corona_adaptive_sky_matches_jax(skies):
    """n0 = 5, one round of at most 6 splits (the rays to λ = 300 or
    r = 150, past the disc's edge): the same cells (centres,
    sizes, depths) and budget, then the same hits, and each field at 1e-9
    (measured ≤ 6e-11 at n0 = 10, two rounds of at most 24)."""
    (jgrid, jvals, jn), (grid, vals, n) = skies
    _same_grid(grid, jgrid)
    assert n == jn and (grid.depth > 0).any()
    for f in FIELDS:
        hit = np.isfinite(jvals[f])
        np.testing.assert_array_equal(np.isfinite(vals[f]), hit)
        np.testing.assert_allclose(vals[f][hit], jvals[f][hit], rtol=1e-9)
    np.testing.assert_array_equal(vals["status"], np.asarray(jvals["status"]))


def test_bin_grids_match_jax(kerr_disc, skies, monkeypatch):
    """On the JAX package's own grid and values: the emissivity, redshift and
    time grids and `adaptive_emissivity_profile` (the sky passed through)
    equal the JAX package's at 1e-12."""
    jm, jd, tm, td = kerr_disc
    (jgrid, jvals, jn), _ = skies
    r_bins, phi_bins = np.geomspace(1.5, 100.0, 13), np.linspace(0.0, 2 * np.pi, 4)
    eps, sa = tad.bin_emissivity_grid(tm, jgrid, jvals, r_bins, phi_bins)
    jeps, jsa = jad.bin_emissivity_grid(jm, jgrid, jvals, r_bins, phi_bins)
    np.testing.assert_allclose(eps, np.asarray(jeps), rtol=1e-12)
    np.testing.assert_array_equal(sa, jsa)
    assert (sa > 0).sum() > 5
    for name in ("bin_redshift_grid", "bin_time_grid"):
        got, want = getattr(tad, name)(jgrid, jvals, r_bins, phi_bins), getattr(jad, name)(jgrid, jvals, r_bins, phi_bins)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    monkeypatch.setattr(tad, "corona_adaptive_sky", lambda *a, **k: (jgrid, jvals, jn))
    monkeypatch.setattr(jad, "corona_adaptive_sky", lambda *a, **k: (jgrid, jvals, jn))
    prof, n = tad.adaptive_emissivity_profile(tm, td, tgt.RingCorona(r=3.0, h=4.0), n_bins=12)
    jprof, _ = jad.adaptive_emissivity_profile(jm, jd, jgt.RingCorona(r=3.0, h=4.0), n_bins=12)
    assert n == jn and int(prof.n) == int(jprof.n) > 3
    k = int(prof.n)
    for f in ("radii", "eps", "t"):
        np.testing.assert_allclose(getattr(prof, f)[:k].numpy(), np.asarray(getattr(jprof, f))[:k], rtol=1e-12)
