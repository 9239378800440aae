"""The port's corona modules against the JAX reference's, in f64 on the CPU:
the sky samplers, the coronal models' positions and velocities, the tetrad
boost, the spectrum, the profile classes and `utils/interp.py`; then the
emissivity profiles (the point-source δ sweep and the Monte-Carlo profile)
and the `tracegeodesics(m, model, ...)` dispatch, at small sizes.

An emissivity profile sorts its hits by radius and reads ``n = Σ hit`` as
an index bound, so one marginal ray that hits in one package and not in the
other would shift every later knot: ``n`` is compared exactly, and the
profiles through `emissivity_at`/`coordtime_at` on a radius grid inside both
hit ranges. The traces of the JAX side are compiled with XLA's LLVM passes
at level 0, which keeps its arithmetic as written (no FMA contraction), as
tests/test_torch_trace_geodesics.py does.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu.corona as jc  # noqa: E402
from gradus_tpu.corona.emissivity import point_source_emissivity_profile as jax_point_source  # noqa: E402
from gradus_tpu.corona.emissivity import tracecorona_profile as jax_tracecorona  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.tracing import tracegeodesics as jax_tracegeodesics  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.utils import interp as jinterp  # noqa: E402

import gradus_tpu_torch.corona as tc  # noqa: E402
from gradus_tpu_torch.corona.emissivity import bin_corona_hits, tracecorona_profile  # noqa: E402
from gradus_tpu_torch.geodesics.tetrads import propernorm  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, tracegeodesics  # noqa: E402
from gradus_tpu_torch.interop import corona_model_from_numpy, radial_profile_from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.utils import interp as tinterp  # noqa: E402

_NO_FMA = {"xla_backend_optimization_level": 0}
HIT = StatusCodes.IntersectedWithGeometry


def _no_fma(fn, *args):
    """``fn(*args)`` compiled by XLA with its arithmetic as written."""
    return jax.jit(fn).lower(*args).compile(_NO_FMA)(*args)


# --- samplers -----------------------------------------------------------------

SAMPLERS = {
    "even_golden_lower": lambda mod: mod.EvenSampler(),
    "even_golden_both": lambda mod: mod.EvenSampler(domain=mod.BothHemispheres()),
    "even_even_lower": lambda mod: mod.EvenSampler(generator="even"),
    "even_even_both": lambda mod: mod.EvenSampler(domain=mod.BothHemispheres(), generator="even"),
    "weierstrass_lower": lambda mod: mod.WeierstrassSampler(res=50.0),
    "weierstrass_both": lambda mod: mod.WeierstrassSampler(res=50.0, domain=mod.BothHemispheres()),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_angles_match_jax(name):
    """Deterministic generators: the same angles at 1e-12 (measured
    ≤ 4.5e-16)."""
    N = 257
    i = np.arange(1, N + 1, dtype=np.float64)
    ej, aj = SAMPLERS[name](jc).sample_angles(jnp.asarray(i), N)
    et, at = SAMPLERS[name](tc).sample_angles(torch.as_tensor(i), N)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-12)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("sampler", ["even", "weierstrass"])
def test_random_generator_range_and_distribution(sampler):
    """The `random` generator draws from a seeded `torch.Generator` (the JAX
    package draws from `jax.random`, so the draws cannot agree bit for bit):
    the same seed gives the same angles, another seed others; the angles lie
    in range; for the even sampler over both hemispheres cos θ = 1 − 2u is
    uniform in [−1, 1] and φ uniform in [0, 2π) (mean and variance within
    5σ of a uniform's for 20,000 draws)."""
    N = 20000
    i = torch.arange(1, N + 1, dtype=torch.float64)

    def make(seed):
        key = torch.Generator().manual_seed(seed)
        if sampler == "even":
            return tc.EvenSampler(domain=tc.BothHemispheres(), generator="random", key=key)
        return tc.WeierstrassSampler(domain=tc.BothHemispheres(), generator="random", key=key)

    e1, a1 = make(7).sample_angles(i, N)
    e2, a2 = make(7).sample_angles(i, N)
    e3, _ = make(8).sample_angles(i, N)
    assert torch.equal(e1, e2) and torch.equal(a1, a2) and not torch.equal(e1, e3)
    assert bool(((e1 >= 0) & (e1 <= math.pi)).all()) and bool(((a1 >= 0) & (a1 < 2 * math.pi)).all())
    if sampler == "even":
        for v, lo, hi in ((torch.cos(e1), -1.0, 1.0), (a1, 0.0, 2 * math.pi)):
            mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
            assert abs(float(v.mean()) - mean) < 5 * math.sqrt(var / N)
            assert abs(float(v.var()) - var) < 5 * var * math.sqrt(0.8 / N)


def test_default_random_key_is_seeded():
    """Without a key, the `random` generator draws from a generator seeded 0:
    two calls give the same angles."""
    i = torch.arange(1, 65, dtype=torch.float64)
    s = tc.EvenSampler(generator="random")
    assert torch.equal(s.sample_angles(i, 64)[0], s.sample_angles(i, 64)[0])


def test_cart_to_spher_jacobian_matches_jax():
    rng = np.random.default_rng(11)
    th, ph = rng.uniform(0.0, math.pi, 32), rng.uniform(0.0, 2 * math.pi, 32)
    j = np.asarray(jc.samplers.cart_to_spher_jacobian(jnp.asarray(th), jnp.asarray(ph)))
    t = tc.samplers.cart_to_spher_jacobian(torch.as_tensor(th), torch.as_tensor(ph)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-15)


# --- models, boost, spectrum --------------------------------------------------

MODELS = {
    "LampPostModel": dict(h=5.0, theta=0.01, phi=0.0),
    "BeamedPointSource": dict(r=10.0, beta=0.3),
    "RingCorona": dict(r=5.0, h=4.0),
    "DiscCorona": dict(r=10.0, h=5.0),
}


@pytest.mark.parametrize("kind", list(MODELS))
def test_model_position_velocity_matches_jax(kind):
    """`sample_position_velocity` on the metric's device and in its dtype,
    against the JAX model at 1e-12 (measured: equal bit for bit); every velocity
    timelike-normalised to 1e-10."""
    jm, tm = JaxKerr(M=1.0, a=0.5), KerrMetric(1.0, 0.5, device="cpu")
    xj, vj = getattr(jc, kind)(**MODELS[kind]).sample_position_velocity(jm)
    model = corona_model_from_numpy(kind, MODELS[kind])
    xt, vt = model.sample_position_velocity(tm)
    assert xt.dtype == torch.float64 and xt.device.type == "cpu"
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-12, atol=1e-14)
    assert math.isclose(float(propernorm(tm.metric(xt), vt)), -1.0, abs_tol=1e-10)


def test_beamed_source_outflows_and_f32_models_follow_the_metric():
    """tests/test_corona.py's beamed source: timelike (1e-10) and outflowing;
    a float32 metric gives float32 source vectors."""
    m = KerrMetric(1.0, 0.5, device="cpu")
    x, v = tc.BeamedPointSource(r=10.0, beta=0.3).sample_position_velocity(m)
    assert math.isclose(float(propernorm(m.metric(x), v)), -1.0, abs_tol=1e-10) and float(v[1]) > 0
    x32, v32 = tc.LampPostModel().sample_position_velocity(KerrMetric(1.0, 0.5, dtype=torch.float32, device="cpu"))
    assert x32.dtype == v32.dtype == torch.float32


def test_sky_angles_to_velocity_matches_jax():
    """The tetrad boost of 64 golden-spiral directions from a lamp post, at
    1e-12 (measured 1.8e-15 relative)."""
    jm, tm = JaxKerr(M=1.0, a=0.998), KerrMetric(1.0, 0.998, device="cpu")
    xj, vj = jc.LampPostModel(h=3.0).sample_position_velocity(jm)
    xt, vt = tc.LampPostModel(h=3.0).sample_position_velocity(tm)
    i = np.arange(1, 65, dtype=np.float64)
    ej, aj = jc.EvenSampler(domain=jc.BothHemispheres()).sample_angles(jnp.asarray(i), 64)
    et, at = tc.EvenSampler(domain=tc.BothHemispheres()).sample_angles(torch.as_tensor(i), 64)
    wj = np.asarray(jc.sky_angles_to_velocity(jm, xj, vj, ej, aj, E0=1.5))
    wt = tc.sky_angles_to_velocity(tm, xt, vt, et, at, E0=1.5).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-12, atol=1e-13)


def test_power_law_spectrum_matches_jax():
    g = np.linspace(0.1, 3.0, 50)
    for gamma in (2.0, 3.1):
        np.testing.assert_allclose(
            tc.PowerLawSpectrum(gamma)(torch.as_tensor(g)).numpy(),
            np.asarray(jc.PowerLawSpectrum(gamma)(jnp.asarray(g))),
            rtol=1e-14,
        )


def test_profile_classes_match_jax():
    """A `RadialDiscProfile` carried across by `interop` and an analytic one
    give the JAX package's values at 1e-14, queried inside, between and
    outside the knots."""
    radii = np.array([2.0, 3.0, 5.0, 9.0, np.inf, np.inf])
    fields = dict(radii=radii, eps=np.array([4.0, 2.0, 1.0, 0.5, 0.0, 0.0]), t=np.array([1.0, 2.0, 4.0, 8.0, 0.0, 0.0]), n=4)
    jp = jc.RadialDiscProfile(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = radial_profile_from_numpy(fields, device="cpu")
    rq = np.array([1.0, 2.0, 2.5, 4.0, 8.99, 9.0, 20.0])
    for name in ("emissivity_at", "coordtime_at"):
        np.testing.assert_allclose(
            getattr(tp, name)(torch.as_tensor(rq)).numpy(), np.asarray(getattr(jp, name)(jnp.asarray(rq))), rtol=1e-14
        )
    assert "N samples    : 4" in repr(tp)
    ja = jc.AnalyticRadialDiscProfile(lambda r: r**-3.0, lambda r: 2.0 * r)
    ta = tc.AnalyticRadialDiscProfile(lambda r: r**-3.0, lambda r: 2.0 * r)
    np.testing.assert_allclose(ta.emissivity_at(rq).numpy(), np.asarray(ja.emissivity_at(rq)), rtol=1e-14)
    np.testing.assert_allclose(ta.coordtime_at(rq).numpy(), np.asarray(ja.coordtime_at(rq)), rtol=1e-14)
    assert float(tc.AnalyticRadialDiscProfile(lambda r: r).coordtime_at(torch.ones(3)).abs().sum()) == 0.0


# --- utils/interp.py ----------------------------------------------------------


def _interp_inputs():
    rng = np.random.default_rng(3)
    xs = np.sort(rng.uniform(0.0, 10.0, 24))
    ys = rng.normal(size=24)
    ys_nan = ys.copy()
    ys_nan[[0, 5, 6, 17, 23]] = np.nan
    xq = np.concatenate([rng.uniform(-2.0, 12.0, 40), xs[[0, 3, 23]]])
    return xs, ys, ys_nan, xq


@pytest.mark.parametrize("fn", ["linear_interp", "nan_tolerant_interp", "make_interpolator", "make_nan_interpolator"])
def test_interpolators_match_jax(fn):
    """At 1e-14, with NaN knots at both ends and inside for the NaN-tolerant
    forms, and queries outside the knots."""
    xs, ys, ys_nan, xq = _interp_inputs()
    y = ys if fn in ("linear_interp", "make_interpolator") else ys_nan
    if fn.startswith("make"):
        nan = fn == "make_nan_interpolator"
        j = jinterp.make_interpolator(jnp.asarray(xs), jnp.asarray(y), nan_tolerant=nan)(jnp.asarray(xq))
        t = tinterp.make_interpolator(torch.as_tensor(xs), torch.as_tensor(y), nan_tolerant=nan)(torch.as_tensor(xq))
    else:
        j = getattr(jinterp, fn)(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(y))
        t = getattr(tinterp, fn)(torch.as_tensor(xq), torch.as_tensor(xs), torch.as_tensor(y))
    assert not np.isnan(np.asarray(j)).any()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-14, atol=1e-14)


def test_masked_sorted_interp_matches_jax():
    xs, ys, _, xq = _interp_inputs()
    xs_inf = np.concatenate([xs[:15], np.full(9, np.inf)])
    for n in (2, 7, 15):
        j = jinterp.masked_sorted_interp(jnp.asarray(xq), jnp.asarray(xs_inf), jnp.asarray(ys), n)
        t = tinterp.masked_sorted_interp(torch.as_tensor(xq), torch.as_tensor(xs_inf), torch.as_tensor(ys), torch.tensor(n))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("n", [0, 1])
def test_masked_sorted_interp_wraps_with_fewer_than_two_knots(n):
    """A fault of the reference that the port reproduces (ROADMAP queue C,
    `utils/interp.py:71`): with fewer than 2 valid knots the index's upper
    clip n − 2 is negative, the index wraps to the +inf tail, and the result
    is not the valid knot's value. Both packages give the same numbers."""
    xs = np.array([3.0, np.inf, np.inf, np.inf])
    ys = np.array([7.0, 1.0, 2.0, 5.0])
    xq = np.array([1.0, 3.0, 10.0])
    j = np.asarray(jinterp.masked_sorted_interp(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(ys), n))
    t = tinterp.masked_sorted_interp(torch.as_tensor(xq), torch.as_tensor(xs), torch.as_tensor(ys), torch.tensor(n)).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], rtol=0, atol=0)
    assert not np.allclose(t, 7.0)


def test_enforce_interpolation_bounds_matches_jax():
    r = np.array([0.5, 2.0, 3.0, 11.0])
    tinterp._bounds_warned[0] = False
    with pytest.warns(UserWarning, match="out of bounds"):
        t = tinterp.enforce_interpolation_bounds(torch.as_tensor(r), 1.0, 10.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jinterp.enforce_interpolation_bounds(jnp.asarray(r), 1.0, 10.0, warn=False)))


@pytest.mark.parametrize("kf", ["gaussian", "constant"])
def test_kernel_interpolate_matches_jax(kf):
    """Interior NaN pixels filled with the kernel-weighted mean of their
    neighbours, the border untouched, at 1e-13; the stencils at 1e-15."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0.0, 1.0, (12, 9))
    img[rng.uniform(size=img.shape) < 0.25] = np.nan
    jk, tk = getattr(jinterp, f"{kf}_kernel"), getattr(tinterp, f"{kf}_kernel")
    np.testing.assert_allclose(tk((5, 3)).numpy(), np.asarray(jk((5, 3))), rtol=0, atol=1e-15)
    j = np.asarray(jinterp.kernel_interpolate(jnp.asarray(img), kernel_size=(5, 3), kf=jk))
    t = tinterp.kernel_interpolate(torch.as_tensor(img), kernel_size=(5, 3), kf=tk).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], rtol=1e-13, atol=1e-15)


# --- emissivity profiles --------------------------------------------------------

A_SPIN = 0.998
N_SWEEP = 128
N_MC = 256


@pytest.fixture(scope="module")
def kerr():
    return dict(
        jm=JaxKerr(M=1.0, a=A_SPIN),
        jd=JaxThinDisc(0.0, jnp.inf),
        tm=KerrMetric(1.0, A_SPIN, device="cpu"),
        td=ThinDisc(0.0, math.inf, device="cpu"),
    )


@pytest.fixture(scope="module")
def sweep(kerr):
    """The point-source δ sweep (lamp post h = 5) in both packages."""
    jp = _no_fma(
        lambda: jax_point_source.__wrapped__(kerr["jm"], kerr["jd"], jc.LampPostModel(h=5.0), n_samples=N_SWEEP)
    )
    tp = tc.emissivity_profile(kerr["tm"], kerr["td"], tc.LampPostModel(h=5.0), n_samples=N_SWEEP)
    return jp, tp


@pytest.fixture(scope="module")
def monte_carlo(kerr):
    """The Monte-Carlo profile (`EvenSampler` over both hemispheres)."""
    jp = _no_fma(
        lambda: jax_tracecorona.__wrapped__(
            kerr["jm"], kerr["jd"], jc.LampPostModel(h=5.0), sampler=jc.EvenSampler(domain=jc.BothHemispheres()), n_samples=N_MC
        )
    )
    tp = tc.emissivity_profile(
        kerr["tm"], kerr["td"], tc.LampPostModel(h=5.0), sampler=tc.EvenSampler(domain=tc.BothHemispheres()), n_samples=N_MC
    )
    return jp, tp


def _grid_inside(jp, tp, k=40):
    n = int(np.asarray(jp.n))
    lo = max(float(np.asarray(jp.radii)[0]), float(tp.radii[0]))
    hi = min(float(np.asarray(jp.radii)[n - 1]), float(tp.radii[int(tp.n) - 1]))
    return np.geomspace(lo, hi, k)


@pytest.mark.parametrize("profile", ["sweep", "monte_carlo"])
def test_emissivity_profile_matches_jax(profile, request):
    """``n`` exact; ε and t on a radius grid inside both hit ranges at
    rtol 1e-8 (measured ≤ 5.2e-13 for both); the knots themselves at 1e-8
    (measured ≤ 2.3e-14)."""
    jp, tp = request.getfixturevalue(profile)
    n = int(np.asarray(jp.n))
    assert int(tp.n) == n and n > 10
    np.testing.assert_allclose(tp.radii[:n].numpy(), np.asarray(jp.radii)[:n], rtol=1e-8)
    rq = _grid_inside(jp, tp)
    for name in ("emissivity_at", "coordtime_at"):
        got = getattr(tp, name)(torch.as_tensor(rq)).numpy()
        ref = np.asarray(getattr(jp, name)(jnp.asarray(rq)))
        np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_emissivity_physics(sweep, monte_carlo):
    """tests/test_corona.py's checks, on the port's profiles: ε ~ r⁻³ between
    r = 10 and 40 (slope in (−3.6, −2.6) for the sweep, (−4, −2) for the
    Monte-Carlo profile), ε ≥ 0, t(r) increasing, and t(40) > 35."""
    _, tp = sweep
    n = int(tp.n)
    assert n > 50 and bool((tp.eps[:n] >= 0).all())
    e = tp.emissivity_at(torch.tensor([10.0, 20.0, 40.0], dtype=torch.float64)).numpy()
    assert -3.6 < math.log(e[2] / e[0]) / math.log(4.0) < -2.6
    t = tp.coordtime_at(torch.tensor([10.0, 20.0, 40.0], dtype=torch.float64)).numpy()
    assert np.all(np.diff(t) > 0) and t[2] > 40.0 - 5.0
    _, mc = monte_carlo
    e = mc.emissivity_at(torch.tensor([10.0, 40.0], dtype=torch.float64)).numpy()
    assert -4.0 < math.log(e[1] / e[0]) / math.log(4.0) < -2.0


def test_emissivity_dispatch_and_unported_branches(kerr, monkeypatch, tmp_path):
    """Ring and disc coronae without a sampler go to `corona/extended.py`
    (a ring to the near-field hybrid unless ``near_field="fan"``, a disc to
    the fan stack unless ``near_field="hybrid"``; here with the profile functions
    stubbed, their parity is tests/test_torch_extended_corona.py's); with a
    sampler they run the Monte-Carlo profile. `bin_corona_hits(axis_name=...)`
    raised until the ray mesh was ported: now, over two gloo ranks each
    holding half of that profile's sky samples, every rank returns the
    profile of the whole (n and the radii bit for bit, ε and t at rtol
    1e-12: the bin sums' order differs)."""
    tm, td = kerr["tm"], ThinDisc(0.0, 100.0, device="cpu")
    ext = importlib.import_module("gradus_tpu_torch.corona.extended")
    for name in ("ring_corona_profile", "ring_corona_profile_hybrid", "disc_corona_profile", "disc_corona_profile_hybrid"):
        monkeypatch.setattr(ext, name, lambda m, d, model, spectrum, _name=name, **kw: (_name, kw))
    ring, disc = tc.RingCorona(), tc.DiscCorona()
    assert tc.emissivity_profile(tm, td, ring, n_beta=3) == ("ring_corona_profile_hybrid", dict(n_beta=3))
    assert tc.emissivity_profile(tm, td, ring, near_field="fan") == ("ring_corona_profile", {})
    assert tc.emissivity_profile(tm, td, disc, n_rings=2) == ("disc_corona_profile", dict(n_rings=2))
    assert tc.emissivity_profile(tm, td, disc, near_field="hybrid") == ("disc_corona_profile_hybrid", {})
    ring = tc.RingCorona(r=4.0, h=3.0)
    prof = tracecorona_profile(tm, td, ring, n_samples=32, lam_max=400.0, n_bins=8)
    assert 0 < int(prof.n) <= 8
    from gradus_tpu_torch import parallel
    from gradus_tpu_torch.corona.emissivity import _trace_sky

    import torch_parallel_ranks as ranks

    x, v_src = ring.sample_position_velocity(tm)
    sampler = tc.EvenSampler(domain=tc.BothHemispheres())
    elev, az = sampler.sample_angles(torch.arange(1, 33, dtype=x.dtype), 32)
    gps = _trace_sky(tm, td, x, tc.sky_angles_to_velocity(tm, x, v_src, elev, az), 400.0)
    hit = gps.status == StatusCodes.IntersectedWithGeometry
    jobs = [("bin_corona_hits", (tm, tc.PowerLawSpectrum(2.0), gps, v_src, hit, 8))]
    for (got,) in parallel.spawn(ranks.reduce_halves, 2, (jobs,), device="cpu", threads=1, root=tmp_path):
        assert int(got.n) == int(prof.n) and torch.equal(got.radii, prof.radii)
        for name in ("eps", "t"):
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(prof, name).numpy(), rtol=1e-12, atol=0)


def test_near_field_reaches_the_sampler_branch(kerr):
    """A fault of the reference that the port reproduces (ROADMAP queue C,
    `corona/emissivity.py:297,306`): ``near_field`` is taken out of the
    keywords only on the ring and disc branches without a sampler, so with
    a sampler (or for a point source) it reaches the profile function, which
    refuses it in both packages."""
    sampler_j, sampler_t = jc.EvenSampler(), tc.EvenSampler()
    with pytest.raises(TypeError, match="near_field"):
        jc.emissivity_profile(kerr["jm"], kerr["jd"], jc.RingCorona(), sampler=sampler_j, near_field="fan")
    with pytest.raises(TypeError, match="near_field"):
        tc.emissivity_profile(kerr["tm"], kerr["td"], tc.RingCorona(), sampler=sampler_t, near_field="fan")
    with pytest.raises(TypeError, match="near_field"):
        tc.emissivity_profile(kerr["tm"], kerr["td"], tc.LampPostModel(), near_field="fan")


def test_tracegeodesics_corona_default_n_samples_is_64():
    """The `tracegeodesics(m, model, λ)` dispatch (tests/test_corona.py) in
    both packages, at its default ``n_samples``: 64, as the JAX package
    defaults (a fault against the reference's 1024, ROADMAP queue C,
    `integrate/tracing.py:266`, which the port reproduces). Statuses equal,
    hits at 1e-8 (measured 9.2e-15); more than 10 disc hits and some
    captures."""
    jm = JaxKerr(M=1.0, a=0.0)
    gj = _no_fma(lambda: jax_tracegeodesics(jm, jc.LampPostModel(), 2000.0, geometry=JaxThinDisc(0.0, 100.0)))
    gt = tracegeodesics(KerrMetric(1.0, 0.0, device="cpu"), tc.LampPostModel(), 2000.0, geometry=ThinDisc(0.0, 100.0, device="cpu"))
    st = gt.status.numpy()
    assert st.shape == (64,)
    np.testing.assert_array_equal(st, np.asarray(gj.status))
    assert (st == int(HIT)).sum() > 10 and (st == int(StatusCodes.WithinInnerBoundary)).sum() > 0
    hit = st == int(HIT)
    np.testing.assert_allclose(gt.x.numpy()[hit], np.asarray(gj.x)[hit], rtol=1e-8)
