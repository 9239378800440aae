"""The port's reverberation slice against the JAX reference's, in f64 on the
CPU: the FFT lag spectrum, `integrate_lagtransfer` on one transfer-function
grid and one emissivity profile carried across by `interop`, `lagtransfer`
with `binflux` on a small plane. The offset solves and the continuum time
are in tests/test_torch_continuum_time.py, the slice end to end in
tests/test_torch_lag_frequency.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu.corona as jc  # noqa: E402
from gradus_tpu.camera.grids import GeometricGrid as JaxGeometricGrid  # noqa: E402
from gradus_tpu.camera.planes import PolarPlane as JaxPolarPlane  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.reverberation import _lag_frequency_fft as jax_lag_fft  # noqa: E402
from gradus_tpu.reverberation import binflux as jax_binflux  # noqa: E402
from gradus_tpu.reverberation import lagtransfer as jax_lagtransfer  # noqa: E402
from gradus_tpu.transfer import TransferBranchGrid as JaxGrid  # noqa: E402
from gradus_tpu.transfer.integration import integrate_lagtransfer as jax_integrate_lagtransfer  # noqa: E402

import gradus_tpu_torch.corona as tc  # noqa: E402
from gradus_tpu_torch.camera import GeometricGrid, PolarPlane  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.interop import radial_profile_from_numpy, transfer_grid_from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.reverberation import _lag_frequency_fft, binflux, lag_frequency, lagtransfer  # noqa: E402
from gradus_tpu_torch.transfer.integration import integrate_lagtransfer  # noqa: E402



# --- the FFT lag spectrum -------------------------------------------------------


def _impulse_table(seed=2):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 100.0, 100)
    f = rng.uniform(0.0, 1.0, (40, 100)) * np.exp(-t / 20.0)[None, :]
    f[rng.uniform(size=f.shape) < 0.3] = np.nan
    return t, f / np.nansum(f)


@pytest.mark.parametrize("case", ["2d", "1d", "n_ext", "flo"])
def test_lag_frequency_fft_matches_jax(case):
    """freq and τ at 1e-12 (measured ≤ 3e-15 relative): the 2D table summed
    NaN-tolerantly over energy, a 1D impulse response, a given padded length
    and another lowest frequency. Σfreq of the reference's smoke grid
    (t ∈ [0, 100], 100 bins) is Gradus.jl's 2449.8787687490535 at 1e-6."""
    t, f = _impulse_table()
    kw = {"n_ext": 4096} if case == "n_ext" else {"flo": 1e-3} if case == "flo" else {}
    table = np.nansum(f, axis=0) if case == "1d" else f
    fj, tj = jax_lag_fft(jnp.asarray(t), jnp.asarray(table), **kw)
    ft, tt = _lag_frequency_fft(torch.as_tensor(t), torch.as_tensor(table), **kw)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=0)
    ok = np.isfinite(np.asarray(tj))
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), ok)
    np.testing.assert_allclose(tt.numpy()[ok], np.asarray(tj)[ok], rtol=1e-12, atol=1e-12)
    if case == "2d":
        assert math.isclose(float(ft.sum()), 2449.8787687490535, rel_tol=1e-6)
        freq2, _ = lag_frequency(torch.as_tensor(t), torch.as_tensor(f))
        assert torch.equal(freq2, ft)


# --- integrate_lagtransfer --------------------------------------------------------


def _synthetic_grid(seed=4):
    """A smooth transfer-function table over 6 radii and 16 g✶ nodes, with
    the branch shapes of a real one (f ~ √(g✶(1−g✶)), t rising with r)."""
    rng = np.random.default_rng(seed)
    radii = np.geomspace(2.0, 60.0, 6)
    gstar = np.linspace(0.0, 1.0, 16)
    gmin = 0.4 + 0.3 * (1 - np.exp(-radii / 10.0))
    gmax = gmin + 0.3 + 0.02 * rng.uniform(size=6)
    shape = np.sqrt(gstar * (1 - gstar))[None, :]
    lower_f = shape * (1 + 0.1 * rng.uniform(size=(6, 16)))
    upper_f = shape * (1 + 0.1 * rng.uniform(size=(6, 16)))
    lower_t = radii[:, None] * (1 + 0.2 * gstar[None, :]) + rng.uniform(size=(6, 16))
    upper_t = radii[:, None] * (1.3 - 0.2 * gstar[None, :]) + rng.uniform(size=(6, 16))
    return dict(radii=radii, gmin=gmin, gmax=gmax, gstar=gstar, lower_f=lower_f, upper_f=upper_f, lower_t=lower_t, upper_t=upper_t)


def _synthetic_profile():
    r = np.geomspace(1.5, 80.0, 30)
    fields = dict(radii=np.concatenate([r, np.full(4, np.inf)]), eps=np.concatenate([r**-3.0, np.zeros(4)]),
                  t=np.concatenate([np.sqrt(r * r + 25.0), np.zeros(4)]), n=30)
    return fields


@pytest.mark.parametrize("kw", [dict(), dict(n_radii=300, t0=3.0, g_scale=1.1), dict(rmin=4.0, rmax=50.0, quadrature_points=5)])
def test_integrate_lagtransfer_matches_jax(kw):
    """The same grid and profile in both packages (`interop`): the (g, t)
    flux at 1e-10 relative to its largest bin (measured ≤ 2e-15), Σ = 1, and
    the last row zero."""
    grid, prof = _synthetic_grid(), _synthetic_profile()
    bins = np.linspace(0.3, 1.3, 40)
    tbins = np.linspace(0.0, 120.0, 60)
    j = np.asarray(
        jax_integrate_lagtransfer(
            jc.RadialDiscProfile(**{k: jnp.asarray(v) for k, v in prof.items()}),
            JaxGrid(**{k: jnp.asarray(v) for k, v in grid.items()}),
            jnp.asarray(bins),
            jnp.asarray(tbins),
            **kw,
        )
    )
    t = integrate_lagtransfer(
        radial_profile_from_numpy(prof, device="cpu"),
        transfer_grid_from_numpy(grid, device="cpu"),
        torch.as_tensor(bins),
        torch.as_tensor(tbins),
        **kw,
    ).numpy()
    assert t.shape == (40, 60) and (t[-1] == 0).all() and math.isclose(t.sum(), 1.0, rel_tol=1e-12)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-10 * np.abs(j).max())


# --- lagtransfer and binflux --------------------------------------------------------

A_SPIN = 0.998


@pytest.fixture(scope="module")
def small_lagtransfer():
    """`lagtransfer` on an 8×8 plane (ρ ∈ [8, 50]) with 32 corona samples:
    observer r = 1000, i = 30°, ThinDisc(isco, 500), lamp post h = 10."""
    x = [0.0, 1000.0, math.radians(30.0), 0.0]
    jm = JaxKerr(M=1.0, a=A_SPIN)
    tm = KerrMetric(1.0, A_SPIN, device="cpu")
    isco = float(tm.isco())
    jtf = jax_lagtransfer(
        jm, jnp.asarray(x), JaxThinDisc(isco, 500.0), jc.LampPostModel(h=10.0, theta=1e-3),
        plane=JaxPolarPlane(JaxGeometricGrid(), Nr=8, Ntheta=8, r_min=8.0, r_max=50.0), n_samples=32,
    )
    ttf = lagtransfer(
        tm, torch.tensor(x, dtype=torch.float64), ThinDisc(isco, 500.0, device="cpu"), tc.LampPostModel(h=10.0, theta=1e-3),
        plane=PolarPlane(GeometricGrid(), Nr=8, Ntheta=8, r_min=8.0, r_max=50.0, device="cpu"), n_samples=32,
    )
    return jtf, ttf


def test_lagtransfer_matches_jax(small_lagtransfer):
    """Hits and coronal hit counts exact; the coronal (r, t) samples and the
    plane's hit points at 1e-8 (measured ≤ 1e-12); the δ-sweep profile on a
    radius grid at 1e-8."""
    jtf, ttf = small_lagtransfer
    np.testing.assert_array_equal(ttf["hit"].numpy(), np.asarray(jtf["hit"]))
    n = int(np.asarray(jtf["corona_n"]))
    assert int(ttf["corona_n"]) == n and n > 5 and int(ttf["hit"].sum()) > 30
    np.testing.assert_allclose(ttf["corona_r"][:n].numpy(), np.asarray(jtf["corona_r"])[:n], rtol=1e-8)
    np.testing.assert_allclose(ttf["corona_t"][:n].numpy(), np.asarray(jtf["corona_t"])[:n], rtol=1e-8)
    hit = ttf["hit"].numpy()
    np.testing.assert_allclose(ttf["points"].x.numpy()[hit], np.asarray(jtf["points"].x)[hit], rtol=1e-8)
    rq = np.geomspace(3.0, 40.0, 20)
    for name in ("emissivity_at", "coordtime_at"):
        np.testing.assert_allclose(
            getattr(ttf["profile"], name)(torch.as_tensor(rq)).numpy(),
            np.asarray(getattr(jtf["profile"], name)(jnp.asarray(rq))),
            rtol=1e-8,
        )


@pytest.mark.parametrize("which", ["default", "traced_profile", "given_bins"])
def test_binflux_matches_jax(small_lagtransfer, which):
    """`binflux` with the reference's default profile (ε = r⁻³, times over
    the raw coronal samples), with the traced profile, and with given bin
    edges: the bin edges at 1e-10, the histogram at 1e-8 relative (measured
    ≤ 1e-11) with the same empty bins, and Σ H·ΔE·Δt = 1 at 1e-12."""
    jtf, ttf = small_lagtransfer
    kw = dict(N_E=12, N_t=10)
    if which == "given_bins":
        kw = dict(e_bins=np.linspace(0.5, 9.0, 9), t_bins=np.linspace(-5.0, 300.0, 7))
    tj, ej, hj = jax_binflux(jtf, jtf["profile"] if which == "traced_profile" else None, **kw)
    tt, et, ht = binflux(ttf, ttf["profile"] if which == "traced_profile" else None, **kw)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-10)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-10)
    hj, ht = np.asarray(hj), ht.numpy()
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    np.testing.assert_allclose(ht[~np.isnan(ht)], hj[~np.isnan(hj)], rtol=1e-8)
    if which != "given_bins":
        de, dt = float(et[1] - et[0]), float(tt[1] - tt[0])
        assert math.isclose(float(np.nansum(ht)) * de * dt, 1.0, rel_tol=1e-12)


def _jax_binflux_sharded(jtf, profile, kw):
    """The JAX package's `binflux(axis_name="rays")` under `shard_map` over
    two of its CPU devices, each holding half of the plane's rays."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("rays",))
    n = jtf["hit"].shape[0]

    def local(points, hit, areas):
        return jax_binflux(dict(jtf, points=points, hit=hit, areas=areas), profile, axis_name="rays", **kw)

    spec = jax.tree.map(lambda a: P("rays") if a.ndim and a.shape[0] == n else P(), jtf["points"])
    shard = jax.shard_map(local, mesh=mesh, in_specs=(spec, P("rays"), P("rays")), out_specs=(P(), P(), P()))
    # jitted: shard_map run op by op takes ~40 s here, jitted < 1 s
    return jax.jit(shard)(jtf["points"], jtf["hit"], jtf["areas"])


def test_binflux_axis_name_raises(small_lagtransfer, tmp_path):
    """`binflux(axis_name=...)` raised until the ray mesh was ported (the
    name is kept: it is this test's in the package's history); now, over two
    gloo ranks each holding half of the plane's rays (the flux total, the
    bin range and the histogram reduced over them), every rank returns what
    `binflux` of the whole does, with the default profile, the traced one
    and given bin edges: the bin edges bit for bit, the same empty bins, the
    histogram at rtol 1e-12 (the sums' order differs). And it returns what
    the JAX package's `binflux(axis_name="rays")` does under `shard_map`
    over two devices on the same halves, at test_binflux_matches_jax's
    tolerances (edges 1e-10, the histogram 1e-8, the same empty bins)."""
    from gradus_tpu_torch import parallel

    import torch_parallel_ranks as ranks

    jtf, ttf = small_lagtransfer
    cases = [
        dict(N_E=12, N_t=10),
        dict(N_E=12, N_t=10, profile="traced"),
        dict(e_bins=np.linspace(0.5, 9.0, 9), t_bins=np.linspace(-5.0, 300.0, 7)),
    ]
    traced = lambda kw, tf: dict(kw, profile=tf["profile"]) if kw.get("profile") else kw  # noqa: E731
    jobs = [("binflux", (ttf, traced(kw, ttf))) for kw in cases]
    got = parallel.spawn(ranks.reduce_halves, 2, (jobs,), device="cpu", threads=1, root=tmp_path)
    for k, kw in enumerate(cases):
        t, e, h = binflux(ttf, **traced(kw, ttf))
        jkw = traced(kw, jtf)
        tj, ej, hj = (np.asarray(a) for a in _jax_binflux_sharded(jtf, jkw.pop("profile", None), jkw))
        assert int((~h.isnan()).sum()) >= (10 if k < 2 else 3)
        for tr, er, hr in (rank[k] for rank in got):
            assert torch.equal(tr, t) and torch.equal(er, e)
            np.testing.assert_array_equal(hr.isnan().numpy(), h.isnan().numpy())
            np.testing.assert_allclose(hr.numpy(), h.numpy(), rtol=1e-12, atol=0)
            np.testing.assert_allclose(tr.numpy(), tj, rtol=1e-10)
            np.testing.assert_allclose(er.numpy(), ej, rtol=1e-10)
            np.testing.assert_array_equal(hr.isnan().numpy(), np.isnan(hj))
            np.testing.assert_allclose(hr.numpy()[~np.isnan(hj)], hj[~np.isnan(hj)], rtol=1e-8)


def test_lagtransfer_default_corona_sampler_is_the_golden_spiral():
    """A property of the reference that the port reproduces (ROADMAP queue C,
    `reverberation.py:186-190`): without a sampler `lagtransfer` draws its
    raw coronal samples from the golden spiral over both hemispheres, though
    the comment there cites the reference's random sampler. The coronal
    directions the port traces are the golden spiral's (the `sample_angles`
    call is recorded)."""
    seen = []
    orig = tc.EvenSampler.sample_angles

    def recording(self, i, N):
        seen.append((self.generator, type(self.domain).__name__, N))
        return orig(self, i, N)

    m = KerrMetric(1.0, 0.0, device="cpu")
    tc.EvenSampler.sample_angles = recording
    try:
        tf = lagtransfer(
            m, torch.tensor([0.0, 50.0, 1.0, 0.0], dtype=torch.float64), ThinDisc(0.0, 40.0, device="cpu"),
            tc.LampPostModel(), plane=PolarPlane(Nr=2, Ntheta=2, r_min=5.0, r_max=6.0, device="cpu"),
            n_samples=8, max_t=1.0,
        )
    finally:
        tc.EvenSampler.sample_angles = orig
    assert seen == [("golden", "BothHemispheres", 8)] and tf["corona_r"].shape == (8,)
