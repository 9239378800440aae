"""The slice end to end: the port's `lag_frequency(m, x, d, model,
backend="cuda")` against the JAX package's `lag_frequency(...,
backend="pallas")` with the Pallas kernel in interpret mode, in f64 on the
CPU (the port's CUDA transfer functions run the integrator kernel's plain
version on CPU tensors).

Configuration: Kerr a = 0.998, observer at r = 1000 and i = 45°,
ThinDisc(0, ∞), `LampPostModel()` (h = 5), 3 radii (4, 8, 16), N = 10,
N_extrema = 4, Ng = 16, a 64-sample emissivity sweep, 30 g bins over
[0.2, 1.4], 60 t bins over [0, 100], 200 integration radii. The pieces the
model dispatch joins (profile, continuum time, transfer functions) are kept
as each package computes them and compared too; then the FFT lags of both
fluxes.

The port's continuum time is a jvp Newton through the lockstep solver
(~100 s of this file on one core; tests/test_torch_continuum_time.py).
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu.corona as jc  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

import gradus_tpu_torch.corona as tc  # noqa: E402
from gradus_tpu_torch.geometry import ShakuraSunyaev, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import cuda_solver  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

jax_rev = importlib.import_module("gradus_tpu.reverberation")
port_rev = importlib.import_module("gradus_tpu_torch.reverberation")

A_SPIN = 0.998
X_OBS = [0.0, 1000.0, math.radians(45.0), 0.0]
RADII = [4.0, 8.0, 16.0]
CTF_KW = dict(N=10, N_extrema=4, Ng=16)
BINS = np.linspace(0.2, 1.4, 30)
TBINS = np.linspace(0.0, 100.0, 60)
KW = dict(n_samples=64, n_radii=200)


def _keeping(module, names):
    """Wraps ``names`` of ``module`` so that their results are kept;
    returns (kept, restore)."""
    kept, orig = {}, {n: getattr(module, n) for n in names}
    for n, fn in orig.items():

        def keep(*a, _fn=fn, _n=n, **k):
            kept[_n] = _fn(*a, **k)
            return kept[_n]

        setattr(module, n, keep)
    return kept, lambda: [setattr(module, n, fn) for n, fn in orig.items()]


NAMES = ("emissivity_profile", "continuum_time", "transferfunctions")


@pytest.fixture(scope="module")
def runs():
    kept_j, restore_j = _keeping(jax_rev, NAMES)
    try:
        jout = jax_rev.lag_frequency(
            JaxKerr(M=1.0, a=A_SPIN), jnp.asarray(X_OBS), JaxThinDisc(0.0, jnp.inf), jc.LampPostModel(),
            radii=jnp.asarray(RADII), bins=jnp.asarray(BINS), tbins=jnp.asarray(TBINS),
            backend="pallas", pallas_opts={"interpret": True}, **CTF_KW, **KW,
        )
    finally:
        restore_j()
    kept_t, restore_t = _keeping(port_rev, NAMES)
    before = cuda_solver.KERNEL_LAUNCHES
    try:
        tout = port_rev.lag_frequency(
            KerrMetric(1.0, A_SPIN, device="cpu"), torch.tensor(X_OBS, dtype=torch.float64),
            ThinDisc(0.0, math.inf, device="cpu"), tc.LampPostModel(),
            radii=torch.tensor(RADII, dtype=torch.float64), bins=torch.as_tensor(BINS), tbins=torch.as_tensor(TBINS),
            backend="cuda", **CTF_KW, **KW,
        )
    finally:
        restore_t()
    return dict(jax=jout, port=tout, kept_j=kept_j, kept_t=kept_t, launches=cuda_solver.KERNEL_LAUNCHES - before)


def test_pieces_match_jax(runs):
    """The profile's hit count exactly and its ε on a grid at 1e-8 (measured
    2.9e-13); t₀ at 1e-10 (measured 9.2e-14); the transfer functions'
    extremal g at 1e-6 (measured 2.4e-12) and branch interiors at 1e-4
    (measured 2.1e-7), as tests/test_torch_ctf_e2e.py holds them. On CPU
    tensors the kernel's plain version ran, with no launch."""
    kj, kt = runs["kept_j"], runs["kept_t"]
    assert runs["launches"] == 0
    pj, pt = kj["emissivity_profile"], kt["emissivity_profile"]
    assert int(pt.n) == int(np.asarray(pj.n))
    rq = np.geomspace(3.0, 100.0, 30)
    np.testing.assert_allclose(
        pt.emissivity_at(torch.as_tensor(rq)).numpy(), np.asarray(pj.emissivity_at(jnp.asarray(rq))), rtol=1e-8
    )
    assert math.isclose(float(kt["continuum_time"]), float(kj["continuum_time"]), rel_tol=1e-10)
    gj, gt = kj["transferfunctions"], kt["transferfunctions"]
    np.testing.assert_allclose(gt.gmin.numpy(), np.asarray(gj.gmin), rtol=1e-6)
    np.testing.assert_allclose(gt.gmax.numpy(), np.asarray(gj.gmax), rtol=1e-6)
    inner = (np.asarray(gj.gstar) > 0.1) & (np.asarray(gj.gstar) < 0.9)
    for branch in ("lower_f", "upper_f", "lower_t", "upper_t"):
        np.testing.assert_allclose(getattr(gt, branch).numpy()[:, inner], np.asarray(getattr(gj, branch))[:, inner], rtol=1e-4)


def test_lag_frequency_matches_jax(runs):
    """The (g, t) flux: the same bins, the same zero (NaN) bins, Σ = 1 at
    1e-8, and each bin above 1e-3 of the largest at rtol 1e-5 (the transfer
    functions' difference carried through the integration; measured
    1.3e-7). The FFT lags of both: the same frequencies at 1e-12, τ over the
    50 lowest frequencies at rtol 1e-6 (measured 8.8e-10)."""
    (tbj, bj, fj), (tbt, bt, ft) = runs["jax"], runs["port"]
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(tbj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    fj, ft = np.asarray(fj), ft.numpy()
    assert ft.shape == (30, 60) and math.isclose(np.nansum(ft), 1.0, rel_tol=1e-8)
    top = np.nan_to_num(fj) > 1e-3 * np.nanmax(fj)
    assert top.sum() > 30
    np.testing.assert_array_equal(np.isnan(ft), np.isnan(fj))
    np.testing.assert_allclose(ft[top], fj[top], rtol=1e-5)
    freq_j, tau_j = jax_rev.lag_frequency(np.asarray(tbj), fj)
    freq_t, tau_t = port_rev.lag_frequency(tbt, torch.as_tensor(ft))
    np.testing.assert_allclose(freq_t.numpy(), np.asarray(freq_j), rtol=1e-12)
    low = slice(1, 51)
    np.testing.assert_allclose(tau_t.numpy()[low], np.asarray(tau_j)[low], rtol=1e-6)
    assert float(tau_t[low].mean()) > 0


def test_unported_lag_paths_raise(monkeypatch):
    """A time-dependent profile (a ring's or disc's) goes to
    `integrate_lagtransfer_timedep` with ``n_radii`` clamped to 400, with a
    warning (here with the pieces stubbed; the parity is
    tests/test_torch_ring_lags.py's); the `cuda` transfer functions of a
    thick disc (whose kernel form is in ROADMAP queue B) raise before any
    trace."""
    m = KerrMetric(1.0, A_SPIN, device="cpu")
    x = torch.tensor(X_OBS, dtype=torch.float64)

    class Timed:
        def time_emissivity_curve(self):
            pass

    calls = []

    def timedep(prof, tfs, bins, tbins, *, t0, n_radii):
        calls.append((type(prof).__name__, tfs, float(t0), n_radii))
        return torch.zeros(len(bins), len(tbins), dtype=torch.float64)

    with monkeypatch.context() as mp:
        mp.setattr(port_rev, "emissivity_profile", lambda *a, **k: Timed())
        mp.setattr(port_rev, "continuum_time", lambda *a: torch.tensor(7.0, dtype=torch.float64))
        mp.setattr(port_rev, "transferfunctions", lambda *a, **k: "tfs")
        mp.setattr(port_rev, "integrate_lagtransfer_timedep", timedep)
        with pytest.warns(UserWarning, match="clamping n_radii 6000"):
            _, _, flux = port_rev.lag_frequency(m, x, ThinDisc(0.0, math.inf, device="cpu"), tc.RingCorona())
    assert calls == [("Timed", "tfs", 7.0, 400)] and bool(torch.isnan(flux).all())
    with pytest.raises(NotImplementedError, match="thick discs"):
        port_rev.transferfunctions(
            m, x, ShakuraSunyaev.from_metric(m), radii=torch.tensor([4.0, 8.0], dtype=torch.float64), backend="cuda"
        )
