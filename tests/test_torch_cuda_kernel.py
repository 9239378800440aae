"""The CUDA integrator kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc; skips without a CUDA device. Imports no JAX, so
it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geodesics.equation import constrain_all  # noqa: E402
from gradus_tpu_torch.geometry import DatumPlane, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, cuda_solver  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch import metrics  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

SPAN = (0.0, 2200.0)
# tests/test_metrics.py:26-32
DEFORMED = {
    "JohannsenMetric": dict(M=1.0, a=0.6, alpha13=0.2, alpha22=0.1, eps3=0.5),
    "JohannsenPsaltisMetric": dict(M=1.0, a=0.6, eps3=2.0),
    "NoZMetric": dict(M=1.0, a=0.5, eps=0.3),
    "BumblebeeMetric": dict(M=1.0, a=0.2, l=0.1),
    "DilatonAxion": dict(M=1.0, a=0.5, beta=0.2, b=1.0),
}
# The bumblebee metric's inner radius is Kerr's M + √(M² − a²), as in the
# reference, which lies inside its horizon at r = 2M: an infalling ray slows
# there without end and runs to max_steps. Its chart stops at 1.01 · 2M.
CHART_INNER = {"BumblebeeMetric": 2.02}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rays(dev, dtype, n=512):
    rng = np.random.default_rng(5)
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=dtype, device=dev)
    alpha = torch.as_tensor(rng.uniform(-28, 28, n), dtype=dtype, device=dev)
    beta = torch.as_tensor(rng.uniform(-18, 18, n), dtype=dtype, device=dev)
    v = map_impact_parameters(m, x, alpha, beta)
    return m, x.expand_as(v), v


@pytest.mark.parametrize("with_disc", [True, False], ids=["thin_disc", "no_geometry"])
def test_kernel_matches_plain_version_f64(dev, with_disc):
    m, xs, v = _rays(dev, torch.float64)
    d = ThinDisc(0.0, 50.0, device=dev) if with_disc else None
    tracer = CudaTracer(m, geometry=d)
    y0 = tracer._constrain(xs, v)
    kw = tracer._integrate_kwargs(torch.float64)
    before = cuda_solver.KERNEL_LAUNCHES
    gk = tracer._finish(cuda_integrate_rays(m, y0, SPAN, **kw), y0, SPAN[0])
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    gp = tracer._finish(integrate_rays_plain(m, y0, SPAN, **kw), y0, SPAN[0])
    torch.cuda.synchronize()
    agree = gk.status == gp.status
    assert agree.double().mean() >= 0.999
    keep = agree & (
        (gk.status == StatusCodes.IntersectedWithGeometry) | (gk.status == StatusCodes.NoStatus)
    )
    assert (gk.x[keep] - gp.x[keep]).abs().max() < 1e-6
    assert (gk.lam_max[keep] - gp.lam_max[keep]).abs().max() < 1e-6


def test_datum_plane_kernel_matches_plain_version_f64(dev):
    """Transfer-function rays (image-plane offsets ρ ∈ [1.5, 60], i=60°)
    against DatumPlane(0.5), as `transfer/cuda_ctf.py` traces them."""
    rng = np.random.default_rng(6)
    n, dtype, span = 512, torch.float64, (0.0, 2000.0)
    rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
    m = KerrMetric(1.0, 0.998, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=dtype, device=dev)
    v = map_impact_parameters(
        m,
        x,
        torch.as_tensor(rho * np.cos(th), device=dev),
        torch.as_tensor(rho * np.sin(th), device=dev),
    )
    tracer = CudaTracer(m, geometry=DatumPlane(0.5, device=dev), chart_outer=2000.0)
    y0 = tracer._constrain(x.expand_as(v), v)
    kw = tracer._integrate_kwargs(dtype)
    before = cuda_solver.KERNEL_LAUNCHES
    gk = tracer._finish(cuda_integrate_rays(m, y0, span, **kw), y0, span[0])
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    gp = tracer._finish(integrate_rays_plain(m, y0, span, **kw), y0, span[0])
    torch.cuda.synchronize()
    assert (gk.status == gp.status).double().mean() >= 0.999
    hit = (gk.status == StatusCodes.IntersectedWithGeometry) & (gp.status == gk.status)
    assert hit.double().mean() > 0.9
    # relative to max(1, |value|): t, φ and λ reach ~1000 on rays that graze
    # the photon orbit, where reltol 1e-9 alone allows 1e-6 (chip_smoke.py)
    ends_k = torch.cat([gk.x[hit], gk.lam_max[hit, None]], dim=-1)
    ends_p = torch.cat([gp.x[hit], gp.lam_max[hit, None]], dim=-1)
    assert ((ends_k - ends_p).abs() / ends_p.abs().clamp(min=1.0)).max() < 1e-6
    z = gk.x[hit, 1] * torch.cos(gk.x[hit, 2])
    assert (z - 0.5).abs().max() < 1e-6


def test_kernel_rejects_what_it_does_not_take(dev):
    m, xs, v = _rays(dev, torch.float32, n=8)
    y0 = torch.cat([xs, v], dim=-1)
    kw = dict(abstol=1e-6, reltol=1e-6, r_inner=1.07, r_outer=12000.0)
    # a timelike ray it takes: mu enters through the constraint only
    before = cuda_solver.KERNEL_LAUNCHES
    cuda_integrate_rays(m, torch.cat([xs, constrain_all(m, xs, v, mu=1.0)], dim=-1), SPAN, **kw)
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0.half(), SPAN, **kw)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0, SPAN, geometry=DatumPlane([0.0] * 8, device=dev), **kw)


def _hits_agree(gk, gp, rel=1e-6, min_hit_share=0.3):
    """Statuses ≥ 0.999 identical; polished hits within ``rel`` relative to
    max(1, |value|)."""
    assert (gk.status == gp.status).double().mean() >= 0.999
    hit = (gk.status == StatusCodes.IntersectedWithGeometry) & (gp.status == gk.status)
    assert hit.double().mean() > min_hit_share
    ends_k = torch.cat([gk.x[hit], gk.lam_max[hit, None]], dim=-1)
    ends_p = torch.cat([gp.x[hit], gp.lam_max[hit, None]], dim=-1)
    assert ((ends_k - ends_p).abs() / ends_p.abs().clamp(min=1.0)).max() < rel


@pytest.mark.parametrize("kind", DEFORMED)
def test_deformed_kernel_matches_plain_version_f64(dev, kind):
    """The dual-number right-hand side against the plain version's AD
    Jacobian, at the render goldens' camera (r = 100, i = 85°, λ ≤ 200)
    against ThinDisc(0, 40)."""
    rng = np.random.default_rng(7)
    n, span = 256, (0.0, 200.0)
    m = getattr(metrics, kind)(**DEFORMED[kind], device=dev)
    x = torch.tensor([0.0, 100.0, math.radians(85.0), 0.0], dtype=torch.float64, device=dev)
    v = map_impact_parameters(
        m,
        x,
        torch.as_tensor(rng.uniform(-9.5, 9.5, n), device=dev),
        torch.as_tensor(rng.uniform(-9.5, 9.5, n), device=dev),
    )
    tracer = CudaTracer(m, geometry=ThinDisc(0.0, 40.0, device=dev), chart_inner=CHART_INNER.get(kind))
    y0 = tracer._constrain(x.expand_as(v), v)
    kw = tracer._integrate_kwargs(torch.float64)
    before = cuda_solver.KERNEL_LAUNCHES
    gk = tracer._finish(cuda_integrate_rays(m, y0, span, **kw), y0, span[0])
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    gp = tracer._finish(integrate_rays_plain(m, y0, span, **kw), y0, span[0])
    torch.cuda.synchronize()
    _hits_agree(gk, gp)


def test_dual_path_matches_hand_path(dev):
    """Johannsen without deviations is Kerr: through the kernel's dual-number
    right-hand side against Kerr's hand-derived one, on flagship rays."""
    m_kerr, xs, v = _rays(dev, torch.float64)
    m_dual = metrics.JohannsenMetric(1.0, 0.998, device=dev)
    d = ThinDisc(0.0, 50.0, device=dev)
    out = []
    for m in (m_dual, m_kerr):
        tracer = CudaTracer(m, geometry=d)
        y0 = tracer._constrain(xs, v)
        raw = cuda_integrate_rays(m, y0, SPAN, **tracer._integrate_kwargs(torch.float64))
        out.append(tracer._finish(raw, y0, SPAN[0]))
    torch.cuda.synchronize()
    _hits_agree(*out)


def test_kernel_refuses_other_metrics(dev):
    from gradus_tpu_torch.metrics.base import AbstractMetric

    class Flat(AbstractMetric):
        pass

    m, xs, v = _rays(dev, torch.float64, n=8)
    y0 = torch.cat([xs, v], dim=-1)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(Flat(), y0, SPAN, abstol=1e-9, reltol=1e-9, r_inner=1.07, r_outer=12000.0)


# --- the metrics and modes of the last slice of the port -------------------------

# tests/test_metrics.py:22-36; first-order Kerr at a = 0.5
NEW_METRICS = {
    "KerrNewmanMetric": dict(M=1.0, a=0.5, Q=0.3),
    "MorrisThorneWormhole": dict(b=1.0),
    "KerrRefractive": dict(M=1.0, a=0.5, n=1.2, corona_radius=20.0),
    "KerrDarkMatter": dict(M=1.0, a=0.5),
    "SphericalMetric": {},
    "CartesianMetric": {},
    "KerrSpacetimeFirstOrder": dict(M=1.0, a=0.5),
}
# The refractive index's near-step and the dark-matter mass's kink make two
# step sequences that differ by rounding end up to ~1e-5 apart
# (tests/test_torch_exotic_metrics.py); CartesianMetric is traced without a
# disc, which would read its (x, y) as (r, θ).
NEW_HIT_RTOL = {"KerrRefractive": 1e-5, "KerrDarkMatter": 1e-5}


def _golden_rays(dev, m, dtype, n, seed=7):
    """Offsets ρ ∈ [6.5, 9.5] at the render goldens' camera (r = 100,
    i = 85°), outside every metric's critical curve."""
    rng = np.random.default_rng(seed)
    rho, phi = rng.uniform(6.5, 9.5, n), rng.uniform(0.0, 2 * np.pi, n)
    x = torch.tensor([0.0, 100.0, math.radians(85.0), 0.0], dtype=dtype, device=dev)
    v = map_impact_parameters(
        m, x, torch.as_tensor(rho * np.cos(phi), dtype=dtype, device=dev), torch.as_tensor(rho * np.sin(phi), dtype=dtype, device=dev)
    )
    return x.expand_as(v), v


@pytest.mark.parametrize("kind", NEW_METRICS)
def test_new_metric_kernel_matches_plain_version_f64(dev, kind):
    span = (0.0, 200.0)
    m = getattr(metrics, kind)(**NEW_METRICS[kind], device=dev)
    xs, v = _golden_rays(dev, m, torch.float64, 256)
    d = None if kind == "CartesianMetric" else ThinDisc(0.0, 40.0, device=dev)
    tracer = CudaTracer(m, geometry=d)
    y0 = tracer._constrain(xs, v)
    kw = tracer._integrate_kwargs(torch.float64)
    before = cuda_solver.KERNEL_LAUNCHES
    gk = tracer._finish(cuda_integrate_rays(m, y0, span, **kw), y0, span[0])
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    gp = tracer._finish(integrate_rays_plain(m, y0, span, **kw), y0, span[0])
    torch.cuda.synchronize()
    if d is None:
        assert (gk.status == gp.status).double().mean() >= 0.999
        # a straight line in the chart's own coordinates
        line = xs[:, 1:] + gk.v_init[:, 1:] * gk.lam_max[:, None]
        assert ((gk.x[:, 1:] - line).norm(dim=-1) <= 1e-12 * line.norm(dim=-1).clamp(min=1.0)).all()
    else:
        # the flat and wormhole spacetimes bend few rays onto the disc (~24%)
        _hits_agree(gk, gp, rel=NEW_HIT_RTOL.get(kind, 1e-6), min_hit_share=0.15)


def _flagship_tracer_rays(dev, dtype, n=512, **tracer_kw):
    m, xs, v = _rays(dev, dtype, n)
    tracer = CudaTracer(m, geometry=ThinDisc(0.0, 50.0, dtype=dtype, device=dev), **tracer_kw)
    return m, tracer, tracer._constrain(xs, v)


@pytest.mark.parametrize("mode", ["sampled", "timelike"])
def test_mode_kernel_matches_plain_version_f64(dev, mode):
    """Sampled events, and rays constrained with mu = 1, on flagship rays."""
    kw = dict(event_method="sampled") if mode == "sampled" else dict(mu=1.0)
    m, tracer, y0 = _flagship_tracer_rays(dev, torch.float64, **kw)
    ikw = tracer._integrate_kwargs(torch.float64)
    gk = tracer._finish(cuda_integrate_rays(m, y0, SPAN, **ikw), y0, SPAN[0])
    gp = tracer._finish(integrate_rays_plain(m, y0, SPAN, **ikw), y0, SPAN[0])
    torch.cuda.synchronize()
    _hits_agree(gk, gp)


def test_crossing_counters_kernel_matches_plain_version(dev):
    m, tracer, y0 = _flagship_tracer_rays(dev, torch.float64)
    ikw = {**tracer._integrate_kwargs(torch.float64), "geometry": DatumPlane(0.0, device=dev)}
    ok = cuda_integrate_rays(m, y0, SPAN, terminate_on_hit=False, **ikw)
    op = integrate_rays_plain(m, y0, SPAN, terminate_on_hit=False, **ikw)
    torch.cuda.synchronize()
    assert (ok["crossings"] == op["crossings"]).double().mean() >= 0.999
    assert (ok["crossings"] >= 2).any() and (ok["status"] != StatusCodes.IntersectedWithGeometry).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_resumed_kernel_equals_single_pass(dev, dtype):
    """A capped launch and its resumption, reordered, give the single
    launch's outputs bit for bit (one instantiation, one carry); and the
    tracer's segmented trace gives the single pass's image."""
    m, tracer, y0 = _flagship_tracer_rays(dev, dtype, n=4096)
    kw = tracer._integrate_kwargs(dtype)
    one = cuda_integrate_rays(m, y0, SPAN, **kw)
    capped = cuda_integrate_rays(m, y0, SPAN, iter_cap=40, **kw)
    assert (cuda_solver._mid_flight(capped, SPAN[1])).any()
    perm = torch.randperm(y0.shape[0], device=dev)
    state = {k: capped[k][perm] for k in cuda_solver._STATE_KEYS}
    resumed = cuda_integrate_rays(m, capped["y"][perm], SPAN, state=state, **kw)
    inv = torch.argsort(perm)
    for k in ("y",) + cuda_solver._STATE_KEYS:
        assert torch.equal(resumed[k][inv], one[k]), k
    seg = CudaTracer(m, geometry=tracer.geometry, segment_iters=128, tail_bucket=3072)
    (gp_1, _), (gp_2, aux) = tracer.trace(y0, SPAN), seg.trace(y0, SPAN)
    assert int(aux["unfinished"]) == 0
    assert torch.equal(gp_1.status, gp_2.status)
    assert torch.equal(gp_1.x.nan_to_num(), gp_2.x.nan_to_num())
    assert torch.equal(gp_1.lam_max, gp_2.lam_max)


# --- the Newton polish of the hits in the kernel ----------------------------------


def _polish_rays(dev, case, dtype, n=512):
    """(metric, geometry, constrained states, λ span, integrator kwargs):
    flagship rays against ThinDisc(0, 50) (Kerr, Johannsen-Psaltis, sampled
    events), or transfer-function rays against DatumPlane(0)."""
    rng = np.random.default_rng(8)
    tkw, span = {}, SPAN
    if case == "johannsen_psaltis":
        m = metrics.JohannsenPsaltisMetric(**DEFORMED["JohannsenPsaltisMetric"], dtype=dtype, device=dev)
    else:
        m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    if case == "datum_plane":
        d = DatumPlane(0.0, dtype=dtype, device=dev)
        x = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=dtype, device=dev)
        rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
        alpha, beta = rho * np.cos(th), rho * np.sin(th)
        span, tkw = (0.0, 2000.0), dict(chart_outer=2000.0)
    else:
        d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev)
        x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=dtype, device=dev)
        alpha, beta = rng.uniform(-28, 28, n), rng.uniform(-18, 18, n)
    if case == "sampled":
        tkw = dict(event_method="sampled")
    tracer = CudaTracer(m, geometry=d, **tkw)
    v = map_impact_parameters(
        m, x, torch.as_tensor(alpha, dtype=dtype, device=dev), torch.as_tensor(beta, dtype=dtype, device=dev)
    )
    return m, d, tracer._constrain(x.expand_as(v), v), span, tracer._integrate_kwargs(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["thin_disc", "datum_plane", "johannsen_psaltis", "sampled"])
def test_kernel_polish_matches_plain_polish(dev, case, dtype):
    """The kernel's polished hits (``newton_iters=3``) against the plain
    polish, `_polish_hits`, of the kernel's own unpolished carry
    (``newton_iters=0``), relative to max(1, |value|): the position and λ
    within 1e-6 in both precisions; the velocity within 1e-6 in f64 and
    3e-5 in f32, where the two right-hand sides round differently (the
    kernel's FMA contractions) and its components, sums that cancel, differ
    by up to 1.3e-5 on the DatumPlane rays; every other output the same bit
    for bit."""
    from gradus_tpu_torch.integrate.solver import _Problem, _polish_hits
    from gradus_tpu_torch.integrate.tracing import make_geodesic_rhs

    m, d, y0, span, kw = _polish_rays(dev, case, dtype)
    raw0 = cuda_integrate_rays(m, y0, span, **{**kw, "newton_iters": 0})
    raw = cuda_integrate_rays(m, y0, span, **kw)
    problem = _Problem(
        f=make_geodesic_rhs(m), crossing_fn=lambda ys: d.crossing_indicator(ys[..., 0:4]), newton_iters=3
    )
    y_p, lam_p = _polish_hits(problem, raw0, raw0["y"], raw0["lam"])
    torch.cuda.synchronize()
    hit = raw["status"] == StatusCodes.IntersectedWithGeometry
    assert hit.double().mean() > 0.3
    for k in cuda_solver._OUTPUT_KEYS:
        if k not in ("y", "lam"):
            assert torch.equal(raw[k], raw0[k]), k
    assert torch.equal(raw["y"][~hit], raw0["y"][~hit]) and torch.equal(raw["lam"][~hit], raw0["lam"][~hit])
    ends_k = torch.cat([raw["y"][hit], raw["lam"][hit, None]], dim=-1)
    ends_p = torch.cat([y_p[hit], lam_p[hit, None]], dim=-1)
    rel = (ends_k - ends_p).abs() / ends_p.abs().clamp(min=1.0)
    assert rel[:, [0, 1, 2, 3, 8]].max() < 1e-6
    assert rel[:, 4:8].max() < (1e-6 if dtype == torch.float64 else 3e-5)


def test_cuda_trace_runs_no_torch_polish(dev, monkeypatch):
    """A trace on the card, in one pass and with a tail pass, polishes in
    the kernel: the plain-torch `_polish_hits` is never called."""
    calls = []
    polish = cuda_solver._polish_hits

    def counting(*args, **kw):
        calls.append(1)
        return polish(*args, **kw)

    monkeypatch.setattr(cuda_solver, "_polish_hits", counting)
    m, tracer, y0 = _flagship_tracer_rays(dev, torch.float32, n=4096)
    seg = CudaTracer(m, geometry=tracer.geometry, segment_iters=128, tail_bucket=3072)
    before = cuda_solver.KERNEL_LAUNCHES
    (gp_1, _), (gp_2, _) = tracer.trace(y0, SPAN), seg.trace(y0, SPAN)
    torch.cuda.synchronize()
    assert cuda_solver.KERNEL_LAUNCHES == before + 3
    assert calls == []
    assert (gp_1.status == StatusCodes.IntersectedWithGeometry).any()
    assert torch.equal(gp_1.x.nan_to_num(), gp_2.x.nan_to_num())


def test_lag_frequency_on_the_card_matches_the_cpu(dev):
    """The small `lag_frequency(m, x, d, model, backend="cuda")` pipeline
    (a = 0.998, r = 100, i = 45°, ThinDisc(0, ∞), lamp post h = 5, radii 4,
    8, 16, N = 10, N_extrema = 4, Ng = 16, 64 emissivity samples, 30 g and
    60 t bins) on the card, whose transfer functions launch the kernel,
    against the same call on the CPU (the kernel's plain version): the same
    NaN (empty) bins, Σ = 1 at 1e-8 in each, the bins above 1e-3 of the
    largest at rtol 1e-4, and the lags over the 50 lowest frequencies at
    rtol 1e-4."""
    from gradus_tpu_torch.corona import LampPostModel
    from gradus_tpu_torch.reverberation import lag_frequency

    def run(device):
        m = KerrMetric(1.0, 0.998, device=device)
        x = torch.tensor([0.0, 100.0, math.radians(45.0), 0.0], dtype=torch.float64, device=device)
        kw = dict(dtype=torch.float64, device=device)
        return lag_frequency(
            m, x, ThinDisc(0.0, math.inf, device=device), LampPostModel(),
            radii=torch.tensor([4.0, 8.0, 16.0], **kw), bins=torch.linspace(0.2, 1.4, 30, **kw),
            tbins=torch.linspace(0.0, 100.0, 60, **kw), n_samples=64, n_radii=200,
            backend="cuda", N=10, N_extrema=4, Ng=16,
        )

    before = cuda_solver.KERNEL_LAUNCHES
    tb, _, f_card = run(dev)
    assert cuda_solver.KERNEL_LAUNCHES > before
    _, _, f_cpu = run("cpu")
    f_card = f_card.cpu()
    assert torch.equal(torch.isnan(f_card), torch.isnan(f_cpu))
    for f in (f_card, f_cpu):
        assert math.isclose(float(torch.nansum(f)), 1.0, rel_tol=1e-8)
    top = torch.nan_to_num(f_cpu) > 1e-3 * float(torch.nan_to_num(f_cpu).max())
    torch.testing.assert_close(f_card[top], f_cpu[top], rtol=1e-4, atol=0)
    tau_card = lag_frequency(tb.cpu(), f_card)[1][1:51]
    tau_cpu = lag_frequency(tb.cpu(), f_cpu)[1][1:51]
    torch.testing.assert_close(tau_card, tau_cpu, rtol=1e-4, atol=0)


def test_lifted_jvp_matches_torch_func_jvp_on_the_card(dev):
    """`utils/jvp.py::jvp` against `torch.func.jvp` through `trace_geodesics`
    on the card: 16 rays from r = 50 at i = 75° (a = 0.998, ThinDisc(0, 50),
    λ ≤ 120), differentiated by β; outputs and tangents equal bit for bit.
    Both transforms wrap the whole loop, so it runs uncaptured
    (`cuda_graphs(False)`): a CUDA graph cannot be captured under a
    `torch.func` transform."""
    from gradus_tpu_torch.integrate import cuda_graphs, trace_geodesics
    from gradus_tpu_torch.utils.jvp import jvp

    m = KerrMetric(1.0, 0.998, device=dev)
    d = ThinDisc(0.0, 50.0, device=dev)
    x = torch.tensor([0.0, 50.0, math.radians(75.0), 0.0], dtype=torch.float64, device=dev)
    rng = np.random.default_rng(1)
    rho = torch.as_tensor(rng.uniform(3.0, 25.0, 16), device=dev)
    phi = torch.as_tensor(rng.uniform(0.0, 2 * math.pi, 16), device=dev)

    def trace(B):
        v = map_impact_parameters(m, x, rho * torch.cos(phi), B)
        gp = trace_geodesics(m, x.expand_as(v), v, (0.0, 120.0), geometry=d)
        return gp.x, gp.v

    B = rho * torch.sin(phi)
    with cuda_graphs(False):
        a = torch.func.jvp(trace, (B,), (torch.ones_like(B),))
        b = jvp(trace, (B,), (torch.ones_like(B),))
    for u, w in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(u.isnan(), w.isnan()) and torch.equal(u.nan_to_num(), w.nan_to_num())


# --- the generic geometries (csrc/geometry.cuh) ----------------------------------


def _chip_smoke():
    """chip_smoke.py (at the root of the checkout), for its cases and checks."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "kind",
    [
        "shakura_sunyaev", "shakura_sunyaev_sampled", "elliptical", "precessing_elliptical", "precessing_thin",
        "composite", "composite6", "doughnut", "doughnut_kerr",
    ],
)  # fmt: skip
def test_generic_geometry_kernel_matches_plain_version(dev, kind, dtype):
    """Each geometry of kinds 3-7 (and a composite of six parts) on 512
    flagship rays, kernel against plain
    version, at chip_smoke.py's thresholds (`phase_thick_geometries`): whole
    traces (f64: statuses ≥ 0.999 alike, hits within 1e-6; f32: ≥ 0.995,
    median redshift gap ≤ 1e-4), or, for the ellipse (also precessed) and
    the composites, whose events the step sequence decides, one iteration at
    a time from the plain version's carry (`_stepwise_ok`: statuses as
    above, in f32 the status codes but for the hit decisions, which the
    composite takes below f32's resolution; the state within 1e-9 in f64
    and 1e-4 in f32, the event's values within 1e-9 in f64)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(22)
    kw = dict(dtype=dtype, device=dev)
    m = KerrMetric(1.0, 0.998, **kw)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
    v = map_impact_parameters(
        m, x, torch.as_tensor(rng.uniform(-28, 28, 512), **kw), torch.as_tensor(rng.uniform(-18, 18, 512), **kw)
    )
    geometry = cs._thick_geometry(kind.replace("_sampled", ""), m, dtype, dev)
    tracer = CudaTracer(m, geometry=geometry, event_method="sampled" if kind.endswith("_sampled") else "cubic")
    y0 = tracer._constrain(x.expand_as(v), v)
    before = cuda_solver.KERNEL_LAUNCHES
    res = cs._full_trace(m, x, tracer, y0, dtype, f"kerr_{kind}")
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    f64 = dtype == torch.float64
    if kind in cs.STEPWISE_KINDS:
        step = cs._stepwise(m, tracer, y0, dtype)
        assert cs._stepwise_ok(step, dtype), step
    elif f64:
        assert res["status_agree"] >= 0.999 and res["hit_max_abs_err"] <= 1e-6, res
    else:
        assert res["status_agree"] >= 0.995 and res["g_median_rel"] <= 1e-4, res


def test_kinds012_kernel_unchanged_bit_for_bit(dev):
    """Geometry kinds 0-2 (none, ThinDisc, DatumPlane) give the outputs the
    kernel gave before the generic geometries came, bit for bit
    (tests/data/kernel_kinds012_digests.json; chip_smoke.py's
    `_kinds012_outputs`)."""
    import json

    cs = _chip_smoke()
    want = json.loads(cs.KINDS012_DIGESTS.read_text())["sha256"]
    assert cs._kinds012_outputs(dev) == want


def test_kernel_refuses_the_geometries_it_does_not_take(dev):
    """Per-ray heights and PolishDoughnutFW (arrays, which the reference's
    kernel refuses too) raise on the card, with no launch and no fall back
    to the plain version."""
    from gradus_tpu_torch import geometry as G

    m, xs, v = _rays(dev, torch.float64, n=8)
    y0 = torch.cat([xs, v], dim=-1)
    kw = dict(abstol=1e-9, reltol=1e-9, r_inner=1.07, r_outer=12000.0)
    rs = np.linspace(6.0, 20.0, 16)
    before = cuda_solver.KERNEL_LAUNCHES
    for g in (
        G.DatumPlane([0.0] * 8, device=dev),
        G.PolishDoughnutFW(rs, rs - 6.0, device=dev),
    ):
        with pytest.raises(NotImplementedError):
            cuda_integrate_rays(m, y0, SPAN, geometry=g, **kw)
        with pytest.raises(NotImplementedError):
            CudaTracer(m, geometry=g)(xs, v, SPAN)
    assert cuda_solver.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["warped", "thick_shakura_sunyaev", "precessing_warped", "composite_callable", "precessing_datum"])
def test_callable_geometry_kernel_matches_plain_version(dev, kind, dtype):
    """The cross-section callables compiled into the kernel (geometry kinds
    8-9, built at first use from the unit `geometry/codegen.py` writes), and
    a precessed DatumPlane, on 512 flagship rays, kernel against plain
    version at chip_smoke.py's thresholds (`phase_callable_geometries`):
    whole traces, or for the composite, whose hit test the step sequence
    decides, one iteration at a time from the plain version's carry."""
    from gradus_tpu_torch import _build

    cs = _chip_smoke()
    rng = np.random.default_rng(23)
    kw = dict(dtype=dtype, device=dev)
    m = KerrMetric(1.0, 0.998, **kw)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
    v = map_impact_parameters(
        m, x, torch.as_tensor(rng.uniform(-28, 28, 512), **kw), torch.as_tensor(rng.uniform(-18, 18, 512), **kw)
    )
    geometry = cs._callable_geometry(kind, dtype, dev)
    tracer = CudaTracer(m, geometry=geometry)
    y0 = tracer._constrain(x.expand_as(v), v)
    before = cuda_solver.KERNEL_LAUNCHES
    res = cs._full_trace(m, x, tracer, y0, dtype, f"kerr_{kind}")
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    if kind != "precessing_datum":
        assert any(info.get("entry") for info in _build.build_info()["callables"].values())
    if kind in cs.STEPWISE_KINDS:
        step = cs._stepwise(m, tracer, y0, dtype)
        assert cs._stepwise_ok(step, dtype), step
    elif dtype == torch.float64:
        assert res["status_agree"] >= 0.999 and res["hit_max_abs_err"] <= 1e-6, res
    else:
        assert res["status_agree"] >= 0.995 and res["g_median_rel"] <= 1e-4, res


# --- a user's metric traced into the kernel (metrics/codegen.py) -----------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["eddington_finkelstein", "user_johannsen_psaltis", "user_johannsen_psaltis_shakura_sunyaev"])
def test_traced_metric_kernel_matches_plain_version(dev, name, dtype):
    """chip_smoke.py's user metrics (the docs' Eddington-Finkelstein
    Schwarzschild, a copy of Johannsen-Psaltis's components), their
    components5 compiled into a unit built at first use (metric kind 12),
    on 512 flagship rays against ThinDisc(0, 50) (the unit's closed forms)
    or a ShakuraSunyaev disc (its generic instantiation), kernel against
    plain version at chip_smoke.py's thresholds (`phase_traced_metrics`)."""
    from gradus_tpu_torch import _build

    cs = _chip_smoke()
    rng = np.random.default_rng(27)
    kw = dict(dtype=dtype, device=dev)
    m, geometry, ops_key = cs._traced_case(name, dtype, dev)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
    v = map_impact_parameters(
        m, x, torch.as_tensor(rng.uniform(-28, 28, 512), **kw), torch.as_tensor(rng.uniform(-18, 18, 512), **kw)
    )
    tracer = CudaTracer(m, geometry=geometry)
    y0 = tracer._constrain(x.expand_as(v), v)
    before = cuda_solver.KERNEL_LAUNCHES
    res = cs._full_trace(m, x, tracer, y0, dtype, ops_key)
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    key = _build.callable_key(cuda_solver._kernel_unit(m, None, dtype).source)
    entry = "geodesic_tsit5_f64" if dtype == torch.float64 else "geodesic_tsit5_f32"
    assert _build.build_info()["callables"][key]["entry"] == entry
    if dtype == torch.float64:
        assert res["status_agree"] >= 0.999 and res["hit_max_abs_err"] <= 1e-6, res
    else:
        assert res["status_agree"] >= 0.995 and res["g_median_rel"] <= 1e-4, res


def test_traced_johannsen_psaltis_matches_builtin_kernel(dev):
    """The copy of Johannsen-Psaltis (kind 12, its components5 generated)
    against the built-in `DualRhs<JohannsenPsaltis>` (kind 2) on 2,048
    flagship rays in f64: statuses identical, 99% of the hits within 1e-9
    relative and every one within 1e-7 (chip_smoke.py's `_jp_agrees`, whose
    docstring says why not all within 1e-9)."""
    cs = _chip_smoke()
    res = cs._traced_vs_builtin(dev)
    assert cs._jp_agrees(res), res


@pytest.mark.parametrize("name", ["branch_s0", "branch_s1", "johannsen_series", "kerr_ef_doughnut", "jp_ef_doughnut", "doughnut_other_metric"])
def test_literal_and_doughnut_modes_kernel_matches_plain_version(dev, name):
    """The configurations the kernel takes since its traced metrics read
    parameters as literals and its doughnuts another metric class than the
    rays': the branching metric at s = 0 and s = 1, Johannsen's series past
    the slots, Kerr rays against a doughnut of the traced
    Eddington-Finkelstein metric, the JP copy's against the same (f64),
    and chip_smoke.py's render configuration, Kerr rays against a doughnut
    of `JohannsenMetric` (f32), each built at first use, on 512 flagship
    rays against the plain version at `phase_traced_metrics`' thresholds."""
    from gradus_tpu_torch import _build

    cs = _chip_smoke()
    dtype = torch.float32 if name == "doughnut_other_metric" else torch.float64
    kw = dict(dtype=dtype, device=dev)
    if name == "doughnut_other_metric":
        m, geometry, ops_key = KerrMetric(1.0, 0.998, **kw), cs._doughnut_other_metric(dtype, dev), "kerr_doughnut_johannsen"
    else:
        m, geometry, ops_key = cs._traced_case(name, dtype, dev)
    rng = np.random.default_rng(28)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
    v = map_impact_parameters(
        m, x, torch.as_tensor(rng.uniform(-28, 28, 512), **kw), torch.as_tensor(rng.uniform(-18, 18, 512), **kw)
    )
    tracer = CudaTracer(m, geometry=geometry)
    y0 = tracer._constrain(x.expand_as(v), v)
    before = cuda_solver.KERNEL_LAUNCHES
    res = cs._full_trace(m, x, tracer, y0, dtype, ops_key, plain_graphs=name not in cs.UNCAPTURED_PLAIN)
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    key = _build.callable_key(cuda_solver._kernel_unit(m, geometry, dtype).source)
    assert key in _build.build_info()["callables"]
    if dtype == torch.float64:
        assert res["status_agree"] >= 0.999 and res["hit_max_abs_err"] <= 1e-6, res
    else:
        assert res["status_agree"] >= 0.995 and res["g_median_rel"] <= 1e-4, res


@pytest.mark.parametrize("name", ["branch_s0", "branch_s1", "johannsen_series_kerr_order"])
def test_literal_metrics_match_builtin_kernels(dev, name):
    """The branching metric at s = 0 and s = 1 against the built-in Kerr
    and Johannsen-Psaltis kernels, and Johannsen's series of the library's
    order against the built-in Johannsen kernel, on 2,048 flagship rays in
    f64, held as the JP copy is (`_jp_agrees`)."""
    cs = _chip_smoke()
    res = cs._traced_vs_builtin(dev, name)
    assert cs._jp_agrees(res), res


def test_kernel_refuses_untraceable_metrics(dev):
    """A metric the generator cannot compile raises on the card before any
    build or launch, and nothing falls back to the plain version."""
    from gradus_tpu_torch import _build
    from gradus_tpu_torch.metrics.base import AbstractMetric

    class Branching(AbstractMetric):
        def __init__(self):
            super().__init__()
            self._register_params(torch.float64, dev, M=1.0)

        def components5(self, r, theta):
            if (r > 3.0).all():
                r = r * 1.0
            return (-(1.0 - 2.0 * self.M / r), 1.0 / (1.0 - 2.0 * self.M / r), r * r, r * r, torch.zeros_like(r))

        def inner_radius(self):
            return 2.0 * self.M

    _, xs, v = _rays(dev, torch.float64, n=8)
    y0 = torch.cat([xs, v], dim=-1)
    built = dict(_build.build_info()["callables"])
    before = cuda_solver.KERNEL_LAUNCHES
    with pytest.raises(NotImplementedError, match="branch on r"):
        cuda_integrate_rays(Branching(), y0, SPAN, abstol=1e-9, reltol=1e-9, r_inner=2.02, r_outer=12000.0)
    with pytest.raises(NotImplementedError, match="branch on r"):
        CudaTracer(Branching(), geometry=ThinDisc(0.0, 50.0, device=dev))(xs, v, SPAN)
    assert cuda_solver.KERNEL_LAUNCHES == before and _build.build_info()["callables"] == built
