"""The ring and disc coronae's lags in the port, in f64 on the CPU: a small
ring `lag_frequency` end to end (the β-slice fan profile, the continuum
time, the transfer functions on the
integrator kernel's plain version, `backend="cuda"`, and the time-dependent
integration with ``n_radii`` clamped, loudly, to 400), Kerr a = 0.5,
ThinDisc(0, 100), observer at r = 100, i = 45°. The slow tests take
tests/test_extended_corona.py's observer at r = 1000.

`integrate_lagtransfer_timedep`'s parity with the JAX package is
tests/test_torch_extended_corona.py's and tests/test_torch_disc_corona.py's.
The `slow` tests port tests/test_extended_corona.py's slow physics checks.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gradus_tpu_torch as tgt  # noqa: E402
from gradus_tpu_torch.transfer.integration import integrate_lagtransfer_timedep  # noqa: E402

A_SPIN = 0.5
X_OBS = [0.0, 1000.0, math.radians(45.0), 0.0]
BINS = np.linspace(0.0, 1.5, 40)
TBINS = np.linspace(0.0, 150.0, 100)


def test_ring_lag_frequency_end_to_end():
    """`lag_frequency(m, x, d, RingCorona(3, 4), backend="cuda")` at a small
    size: the fan profile (3 slices × 32 angles, no golden-section step,
    the rays to λ = 500 or r = 150; the default hybrid is
    tests/test_torch_ring_hybrid.py's), 3 transfer-function radii (N = 6),
    40 g and 100 t bins; n_radii = 500
    warns and is clamped to 400. Σflux = 1 at 1e-8, flux finite where not
    NaN, τ finite past the first bin and the low-frequency mean τ > 0."""
    m = tgt.KerrMetric(1.0, A_SPIN, device="cpu")
    x = torch.tensor([0.0, 100.0, math.radians(45.0), 0.0], dtype=torch.float64)
    d = tgt.ThinDisc(0.0, 100.0, device="cpu")
    with pytest.warns(UserWarning, match="clamping n_radii 500"):
        tbins, bins, flux = tgt.lag_frequency(
            m, x, d, tgt.RingCorona(r=3.0, h=4.0),
            radii=torch.tensor([4.0, 10.0, 30.0], dtype=torch.float64), bins=torch.as_tensor(BINS),
            tbins=torch.as_tensor(TBINS), n_radii=500, backend="cuda", N=6, N_extrema=4, Ng=16,
            profile_kwargs=dict(n_beta=3, n_angles=32, n_refine=0, lam_max=500.0, chart_outer=150.0, near_field="fan"),
        )
    ok = ~torch.isnan(flux)
    assert flux.shape == (40, 100) and int(ok.sum()) > 50
    assert bool(torch.isfinite(flux[ok]).all())
    assert abs(float(torch.nansum(flux)) - 1.0) <= 1e-8
    freq, tau = tgt.lag_frequency(tbins, flux)
    assert bool(torch.isfinite(tau[1:]).all()) and float(tau[1:50].mean()) > 0


# --- tests/test_extended_corona.py's slow physics, on the port ----------------


def _small_tfs(m, x, d):
    return tgt.transferfunctions(
        m, x, d, radii=tgt.LinearGrid()(float(tgt.isco(m)) + 1e-2, 30.0, 5, dtype=torch.float64),
        N=12, N_extrema=5, Ng=24, backend="cuda",
    )


@pytest.mark.slow
def test_timedep_lagtransfer():
    """Time-dependent 2D lag transfer of a ring: normalised, and the echo lag
    inside the light-crossing budget."""
    m, d = tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")
    x = torch.tensor(X_OBS, dtype=torch.float64)
    prof = tgt.emissivity_profile(m, d, tgt.RingCorona(r=3.0, h=4.0), n_beta=4, n_angles=64)
    flux = integrate_lagtransfer_timedep(
        prof, _small_tfs(m, x, d), torch.as_tensor(BINS), torch.as_tensor(TBINS), t0=1000.0, n_radii=60, n_time=24
    ).numpy()
    assert math.isclose(np.nansum(flux), 1.0, rel_tol=1e-6)
    psi = np.nansum(flux, axis=0)
    assert 2.0 < float((TBINS * psi).sum() / psi.sum()) < 120.0


@pytest.mark.slow
def test_disc_corona_lag_frequency_grows_with_radius():
    """A radially larger disc corona has the longer mean echo lag and
    low-frequency lag (delays 2r)."""
    m, d = tgt.KerrMetric(1.0, A_SPIN, device="cpu"), tgt.ThinDisc(0.0, 100.0, device="cpu")
    x = torch.tensor(X_OBS, dtype=torch.float64)
    tfs = _small_tfs(m, x, d)
    tbins = np.linspace(0.0, 200.0, 128)
    lags, taus = {}, {}
    for rc in (2.0, 10.0):
        prof = tgt.emissivity_profile(m, d, tgt.DiscCorona(r=rc, h=4.0), n_rings=3, n_beta=4, n_angles=64)
        prof = prof.with_propagation_velocity(lambda r: 2.0 * r)
        flux = integrate_lagtransfer_timedep(
            prof, tfs, torch.as_tensor(BINS), torch.as_tensor(tbins), t0=1000.0, n_radii=60, n_time=24
        )
        assert math.isclose(float(torch.nansum(flux)), 1.0, rel_tol=1e-6)
        psi = np.nansum(flux.numpy(), axis=0)
        lags[rc] = float((tbins * psi).sum() / psi.sum())
        freq, tau = tgt.lag_frequency(torch.as_tensor(tbins), flux)
        lo = (freq > 0) & (freq < 2e-3)
        taus[rc] = float(np.nanmean(tau[lo].numpy()))
    assert lags[10.0] > lags[2.0] + 1.0
    assert taus[10.0] > taus[2.0] > 0


# the two slowest ports take ~30 minutes on one core; their `cuda` cases run
# them on the card (`pytest -m "slow and cuda"`), where they take minutes
ON_DEVICE = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


@pytest.mark.slow
@pytest.mark.parametrize("device", ON_DEVICE)
def test_ring_corona_n_beta_convergence(device):
    """The default (hybrid) ring profile converges in the slice count through
    the near field: n_beta 20 against 40 at 1e-2, 10 against 40 at 3e-2."""
    dev = _device(device)
    m, d = tgt.KerrMetric(1.0, A_SPIN, device=dev), tgt.ThinDisc(0.0, 100.0, device=dev)
    rq = torch.tensor([2.6, 3.0, 3.4, 4.0, 5.0, 8.0, 15.0, 30.0], dtype=torch.float64, device=dev)
    eps = {
        nb: tgt.emissivity_profile(m, d, tgt.RingCorona(r=3.0, h=6.0), n_beta=nb, n_angles=256)
        .emissivity_at(rq)
        .cpu()
        .numpy()
        for nb in (10, 20, 40)
    }
    np.testing.assert_allclose(eps[20], eps[40], rtol=1e-2)
    np.testing.assert_allclose(eps[10], eps[40], rtol=3e-2)
    assert np.all(eps[40][:4] > 0)


@pytest.mark.slow
@pytest.mark.parametrize("device", ON_DEVICE)
def test_ring_corona_lag_frequency_n_beta_stable(device):
    """Doubling the slice count moves the ring's low-frequency lag by < 2%."""
    dev = _device(device)
    m, d = tgt.KerrMetric(1.0, A_SPIN, device=dev), tgt.ThinDisc(0.0, 100.0, device=dev)
    x = torch.tensor(X_OBS, dtype=torch.float64, device=dev)
    like = dict(dtype=torch.float64, device=dev)
    taus = {}
    for nb in (10, 20):
        tbins, _, flux = tgt.lag_frequency(
            m, x, d, tgt.RingCorona(r=3.0, h=4.0), bins=torch.as_tensor(BINS, **like),
            tbins=torch.as_tensor(TBINS, **like),
            radii=tgt.LinearGrid()(float(tgt.isco(m)) + 1e-2, 30.0, 5, **like),
            N=12, N_extrema=5, Ng=24, n_radii=60, backend="cuda", profile_kwargs=dict(n_beta=nb, n_angles=128),
        )
        freq, tau = tgt.lag_frequency(tbins, torch.nan_to_num(flux))
        lo = (freq > 0) & (freq < 2e-3)
        taus[nb] = float(np.nanmean(tau[lo].cpu().numpy()))
    np.testing.assert_allclose(taus[10], taus[20], rtol=2e-2)


@pytest.mark.slow
def test_refine_for_target_differentiable():
    """The arrival time's forward-mode derivative with respect to the
    corona's (r, h) (the eikonal JVP) against central differences."""
    m = tgt.KerrMetric(1.0, A_SPIN, device="cpu")
    x0 = torch.tensor(X_OBS, dtype=torch.float64)

    def src_position(rh):
        r_c, h = rh[0], rh[1]
        return torch.stack([torch.sqrt(r_c**2 + h**2), torch.atan2(r_c, h), torch.zeros_like(h)])

    rh0 = torch.tensor([3.0, 6.0], dtype=torch.float64)
    al, be, _, _ = tgt.optimize_for_target(src_position(rh0), m, x0)
    ab0 = torch.stack([al, be])
    from gradus_tpu_torch.transfer.targets import refine_for_target

    def arrival_time(rh):
        return refine_for_target(src_position(rh), m, x0, ab0, iters=3)[1]

    assert 950.0 < float(arrival_time(rh0)) < 1100.0
    assert float(refine_for_target(src_position(rh0), m, x0, ab0, iters=3)[2]) < 0.05
    for k in range(2):
        u = torch.zeros(2, dtype=torch.float64)
        u[k] = 1.0
        _, g = torch.func.jvp(arrival_time, (rh0,), (u,))
        fd = (float(arrival_time(rh0 + 5e-2 * u)) - float(arrival_time(rh0 - 5e-2 * u))) / 0.1
        np.testing.assert_allclose(float(g), fd, rtol=8e-2, atol=5e-3)
