"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Builds the port's CUDA kernel from `gradus_tpu_torch/csrc/`, holds it against
its plain PyTorch version on the card (f64 and f32; flagship rays against a
ThinDisc, rays without geometry, and transfer-function rays against a
DatumPlane), reproduces the two render goldens through it, then runs the
port's three products through their entry points:

- the flagship render at full size: 1024² rays, f32, Kerr a=0.998, observer
  at r=1000 and i=75°, ThinDisc(0, 50), λ ∈ (0, 2200), analytic Kerr redshift;
- the Gradus.jl line-profile edge goldens (Kerr a=0.6, i=60°), f64, through
  `lineprofile(..., backend="cuda")`;
- the transfer-function line profile at full size (`bench.py::bench_ctf`'s
  configuration: f32, a=0.998, i=60°, 100 radii × 80 angles), with its first
  moment against the JAX package's f64 CPU value;
- the binned line profile at full size (`bench.py::bench_binning`'s
  configuration: a 1000×1000 polar plane, f32, i=70°), and once more at the
  transfer-function profile's configuration to compare the two methods.

Every phase prints one line; any failure raises, so the exit code is
non-zero. The last line is a JSON object with the device.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc). Imports no JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gradus_tpu_torch import _build
from gradus_tpu_torch.camera import (
    ConstPointFunctions,
    GeometricGrid,
    PolarPlane,
    map_impact_parameters,
)
from gradus_tpu_torch.geometry import DatumPlane, ThinDisc
from gradus_tpu_torch.integrate import StatusCodes, cuda_solver
from gradus_tpu_torch.integrate.cuda_solver import (
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.lineprofile import binned_flux, lineprofile
from gradus_tpu_torch.metrics import KerrMetric
from gradus_tpu_torch.redshift import redshift_pointfunction
from gradus_tpu_torch.utils import equatorial_project

SPAN = (0.0, 2200.0)
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
HIT = StatusCodes.IntersectedWithGeometry
# the transfer-function configuration of bench.py::bench_ctf
CTF_X_OBS = [0.0, 1000.0, math.radians(60.0), 0.0]
CTF_BINS = (0.1, 1.5, 180)
# bench.py:227: the first moment Σ(flux·g)/Σflux of that profile, f64 on a CPU
M1_F64_CPU = 0.9201437735481984


def _say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _flagship(dtype, dev, outer_r=50.0):
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    d = None if outer_r is None else ThinDisc(0.0, outer_r, dtype=dtype, device=dev)
    x = torch.tensor(X_OBS, dtype=dtype, device=dev)
    return m, d, x


def _pixel_grid(width, height, alpha_lims, beta_lims, offset, dtype, dev):
    """Impact parameters laid out as gradus_tpu/camera/render.py:54-61 does:
    linspace + offset, α-major ravel."""
    alphas = torch.linspace(*alpha_lims, width, dtype=dtype, device=dev) + offset
    betas = torch.linspace(*beta_lims, height, dtype=dtype, device=dev) + offset
    A = alphas[:, None].expand(width, height).reshape(-1)
    B = betas[None, :].expand(width, height).reshape(-1)
    return A, B


def _constrained(tracer, m, x, A, B):
    v = map_impact_parameters(m, x, A, B)
    return tracer._constrain(x.expand_as(v), v)


def _rel(a, b):
    return (a - b).abs() / b.abs()


def _timed(fn):
    """(fn(), its milliseconds on the card by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the port's contractions need full f32")
    _say(
        "device",
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
    )


def phase_build():
    _build.load_library()
    info = _build.build_info()
    ptxas = [
        line.strip()
        for line in info["ptxas"].splitlines()
        if "Compiling entry" in line or "spill" in line or "Used" in line
    ]
    _say("build", seconds=info["seconds"], built=info["built"], path=info["path"], ptxas=ptxas)


def _datum_plane_group(dev, n=8192, n_raised=2048):
    """Transfer-function rays against DatumPlane(0) in f64 and f32, and
    against a raised DatumPlane(0.5) in f64 (``n_raised`` rays, which
    exercises the kernel's height argument), kernel and plain version on
    the same card tensors, compared after the polish: image-plane offsets
    ρ ∈ [1.5, 60], θ ∈ [0, 2π) at i=60°, λ ∈ (0, 2000), chart outer bound
    2000 (as `transfer/cuda_ctf.py` traces them).

    In f64 the polished hits are held to 1e-6 relative to max(1, |value|),
    component by component: rays that graze the photon orbit before they
    cross the plane reach t, φ, λ ~ 1000 and amplify the two versions'
    different step sequences to the integrator's own tolerance there
    (reltol 1e-9 × |t| ~ 1e-6), which an absolute 1e-6 does not allow.
    The kernel's f64 hits also lie on their plane: |r cos θ − height|
    ≤ 1e-9 (the plain version's polish reaches ~1e-14)."""
    rng = np.random.default_rng(21)
    rho = rng.uniform(1.5, 60.0, n)
    th = rng.uniform(0.0, 2 * math.pi, n)
    span = (0.0, 2000.0)
    out = {}
    for name, dtype, height, k in (
        ("f64", torch.float64, 0.0, n),
        ("f32", torch.float32, 0.0, n),
        ("f64_height_0.5", torch.float64, 0.5, n_raised),
    ):
        m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
        x = torch.tensor(CTF_X_OBS, dtype=dtype, device=dev)
        tracer = CudaTracer(m, geometry=DatumPlane(height, dtype=dtype, device=dev), chart_outer=2000.0)
        A = torch.as_tensor(rho[:k] * np.cos(th[:k]), dtype=dtype, device=dev)
        B = torch.as_tensor(rho[:k] * np.sin(th[:k]), dtype=dtype, device=dev)
        y0 = _constrained(tracer, m, x, A, B)
        kw = tracer._integrate_kwargs(dtype)
        cuda_integrate_rays(m, y0, span, **kw)  # warm-up
        (out_k, ms_k), (out_p, ms_p) = (
            _timed(lambda f=f: f(m, y0, span, **kw))
            for f in (cuda_integrate_rays, integrate_rays_plain)
        )
        gk = tracer._finish(out_k, y0, span[0])
        gp = tracer._finish(out_p, y0, span[0])
        torch.cuda.synchronize()
        hit = (gk.status == HIT) & (gp.status == HIT)
        rho_k, rho_p = equatorial_project(gk.x[hit]), equatorial_project(gp.x[hit])
        ends_k = torch.cat([gk.x[hit], gk.lam_max[hit, None]], dim=-1)
        ends_p = torch.cat([gp.x[hit], gp.lam_max[hit, None]], dim=-1)
        diff = (ends_k - ends_p).abs()
        xk = gk.x[gk.status == HIT]
        res = dict(
            height=height,
            rays=k,
            status_agree=float((gk.status == gp.status).double().mean()),
            hits=int(hit.sum()),
            hit_max_abs_err=float(diff.max()),
            hit_max_abs_err_t_r_th_ph_lam=diff.amax(dim=0).tolist(),
            hit_max_rel_err=float((diff / ends_p.abs().clamp(min=1.0)).max()),
            rho_median_rel=float(_rel(rho_k, rho_p).median()),
            rho_max_rel=float(_rel(rho_k, rho_p).max()),
            kernel_plane_residual_max=float((xk[:, 1] * torch.cos(xk[:, 2]) - height).abs().max()),
            kernel_ms=ms_k,
            plain_ms=ms_p,
        )
        out[name] = res
        if dtype == torch.float64:
            if (
                res["status_agree"] < 0.999
                or res["hit_max_rel_err"] > 1e-6
                or res["kernel_plane_residual_max"] > 1e-9
            ):
                raise AssertionError(f"datum_plane {name} kernel/plain disagree: {res}")
        elif res["status_agree"] < 0.995 or res["rho_median_rel"] > 1e-4:
            raise AssertionError(f"datum_plane {name} kernel/plain disagree: {res}")
    return out


def phase_kernel_vs_plain(dev, n_disc=8192, n_free=2048, n_datum=8192):
    """The kernel and its plain version on the same card tensors, compared
    after the polish: flagship rays with the disc, rays without one, and
    transfer-function rays against a DatumPlane."""
    rng = np.random.default_rng(20)
    alpha = rng.uniform(-28.0, 28.0, n_disc + n_free)
    beta = rng.uniform(-18.0, 18.0, n_disc + n_free)
    results = {}
    for dtype in (torch.float64, torch.float32):
        status_k, status_p = [], []
        err_hit, g_rel = 0.0, None
        for sl, outer_r in ((slice(0, n_disc), 50.0), (slice(n_disc, None), None)):
            m, d, x = _flagship(dtype, dev, outer_r)
            tracer = CudaTracer(m, geometry=d)
            y0 = _constrained(
                tracer,
                m,
                x,
                torch.as_tensor(alpha[sl], dtype=dtype, device=dev),
                torch.as_tensor(beta[sl], dtype=dtype, device=dev),
            )
            kw = tracer._integrate_kwargs(dtype)
            gk = tracer._finish(cuda_integrate_rays(m, y0, SPAN, **kw), y0, SPAN[0])
            gp = tracer._finish(integrate_rays_plain(m, y0, SPAN, **kw), y0, SPAN[0])
            torch.cuda.synchronize()
            status_k.append(gk.status)
            status_p.append(gp.status)
            if d is None:
                continue
            hit = (gk.status == HIT) & (gp.status == HIT)
            err_hit = max(
                float((gk.x[hit] - gp.x[hit]).abs().max()),
                float((gk.lam_max[hit] - gp.lam_max[hit]).abs().max()),
            )
            pf = ConstPointFunctions.redshift(m, x)
            g_rel = float(_rel(pf(m, gk, SPAN[1])[hit], pf(m, gp, SPAN[1])[hit]).median())
        agree = float((torch.cat(status_k) == torch.cat(status_p)).double().mean())
        name = "f64" if dtype == torch.float64 else "f32"
        results[name] = dict(status_agree=agree, hit_max_abs_err=err_hit, g_median_rel=g_rel)
        if dtype == torch.float64:
            if agree < 0.999 or err_hit > 1e-6:
                raise AssertionError(f"f64 kernel/plain disagree: {results[name]}")
        elif agree < 0.995 or g_rel > 1e-4:
            raise AssertionError(f"f32 kernel/plain disagree: {results[name]}")
    results["datum_plane"] = _datum_plane_group(dev, n_datum)
    _say("kernel_vs_plain", **results)
    return results


def phase_goldens(dev):
    """tests/test_render.py's goldens through the kernel, f64."""
    sums = {}
    A, B = _pixel_grid(20, 20, (-9.5, 9.5), (-9.5, 9.5), 1e-6, torch.float64, dev)
    x = torch.tensor([0.0, 100.0, math.radians(85.0), 0.0], dtype=torch.float64, device=dev)
    m = KerrMetric(1.0, 0.0, device=dev)
    for name, d, golden in (
        ("shadow", None, 9009.452876609641),
        ("thin_disc", ThinDisc(0.0, 40.0, device=dev), 38412.08347901267),
    ):
        before = cuda_solver.KERNEL_LAUNCHES
        v = map_impact_parameters(m, x, A, B)
        gp = CudaTracer(m, geometry=d)(x.expand_as(v), v, (0.0, 200.0))
        total = float(torch.nansum(ConstPointFunctions.shadow()(m, gp, 200.0)))
        if cuda_solver.KERNEL_LAUNCHES != before + 1:
            raise AssertionError("the golden render did not go through the kernel")
        if not math.isclose(total, golden, rel_tol=1e-1):
            raise AssertionError(f"{name} golden: {total} vs {golden}")
        sums[name] = total
    _say("goldens", **sums)


def phase_main_path(dev, side=1024):
    """The flagship render, f32, side² rays, through the port's entry points."""
    dtype = torch.float32
    n = side * side
    m, d, x = _flagship(dtype, dev)
    pf = ConstPointFunctions.redshift(m, x) @ ConstPointFunctions.filter_intersected()
    tracer = CudaTracer(m, geometry=d)

    def render():
        A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev)
        v = map_impact_parameters(m, x, A, B)
        gp = tracer(x.expand_as(v), v, SPAN)
        return pf(m, gp, SPAN[1])

    cuda_solver.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    img = render()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = cuda_solver.KERNEL_LAUNCHES
    aux = tracer.last_aux
    if launches != 4:
        raise AssertionError(f"4 renders launched the kernel {launches} times")
    if int(aux["unfinished"]) != 0:
        raise AssertionError(f"{int(aux['unfinished'])} rays unfinished")
    finite = torch.isfinite(img)
    g = img[finite]
    if finite.sum() == 0 or not bool(((g > 0) & (g < 2)).all()) or float(g.max()) <= 1.0:
        raise AssertionError("redshift image out of range")
    dt = statistics.median(times)
    executed = int(aux["warp_iters"].sum())
    useful = int(aux["steps"].sum())
    attempted = int(aux["attempts"].sum())

    # every 64th pixel, against the plain version on the card
    idx = torch.arange(0, n, 64, device=dev)
    A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev)
    y0 = _constrained(tracer, m, x, A[idx], B[idx])
    kw = tracer._integrate_kwargs(dtype)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out_p = integrate_rays_plain(m, y0, SPAN, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    g_p = pf(m, tracer._finish(out_p, y0, SPAN[0]), SPAN[1])
    g_k = img[idx]
    mask_agree = float((torch.isfinite(g_k) == torch.isfinite(g_p)).double().mean())
    both = torch.isfinite(g_k) & torch.isfinite(g_p)
    g_rel = float(_rel(g_k[both], g_p[both]).median())
    if mask_agree < 0.995 or g_rel > 1e-4:
        raise AssertionError(f"subset: hit mask agree {mask_agree}, median rel g {g_rel}")

    kernel_ms = []
    cuda_integrate_rays(m, y0, SPAN, **kw)  # warm-up
    for _ in range(3):
        start.record()
        cuda_integrate_rays(m, y0, SPAN, **kw)
        end.record()
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(end))
    result = dict(
        rays=n,
        seconds_per_render=dt,
        render_seconds=times,
        rays_per_s=n / dt,
        finite_pixels=int(finite.sum()),
        g_min=float(g.min()),
        g_max=float(g.max()),
        launches=launches,
        unfinished=int(aux["unfinished"]),
        executed_lane_steps=executed,
        attempted_lane_steps=attempted,
        useful_ray_steps=useful,
        wasted_step_fraction=1.0 - useful / max(executed, 1),
        subset_rays=int(idx.numel()),
        subset_hit_mask_agree=mask_agree,
        subset_g_median_rel=g_rel,
        subset_kernel_ms=statistics.median(kernel_ms),
        subset_plain_ms=plain_ms,
    )
    _say("main_path", **result)
    return result


def _m1(flux, bins):
    """First moment Σ(flux·g)/Σflux over the bin edges (bench.py:228-230)."""
    return float((flux * bins).sum() / flux.sum())


def _device_busy_ms(fn):
    """(kernel time on the card in ms, device events) during one call of
    ``fn`` (torch.profiler, device activity only); the time is None if the
    profiler sees no device activity. The profiler's raw events are summed
    directly: `key_averages()` over the ~10⁶ events of a CTF profile takes
    minutes of host time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    busy_ns = sum(e.duration_ns() for e in device)
    return (busy_ns / 1e6 if busy_ns > 0 else None), len(device)


def phase_ctf_golden(dev):
    """Gradus.jl's test-cunningham.jl edges through the kernel, f64
    (tests/test_transfer.py:32-67): Kerr a=0.6, i=60°, ThinDisc(0, 250)."""
    m = KerrMetric(1.0, 0.6, device=dev)
    x = torch.tensor(CTF_X_OBS, dtype=torch.float64, device=dev)
    bins = torch.linspace(0.1, 1.3, 100, dtype=torch.float64, device=dev)
    before = cuda_solver.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    bins, flux = lineprofile(
        m, x, ThinDisc(0.0, 250.0, device=dev), bins=bins, N=40, num_re=30, backend="cuda"
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_solver.KERNEL_LAUNCHES - before
    b, f = bins.cpu().numpy(), flux.cpu().numpy()
    nz = np.nonzero(f > 0)[0]
    res = dict(
        seconds=seconds,
        launches=launches,
        g_low=float(b[nz[0]]),
        g_high=float(b[nz[-1]]),
        flux_sum=float(f.sum()),
        peak_g=float(b[np.argmax(f)]),
    )
    if launches == 0:
        raise AssertionError("the CTF golden did not go through the kernel")
    if abs(res["g_low"] - 0.355) > 0.05 or abs(res["g_high"] - 1.2) > 0.05:
        raise AssertionError(f"CTF line-profile edges off the Gradus.jl goldens: {res}")
    if not math.isclose(res["flux_sum"], 1.0, rel_tol=1e-10) or (f < 0).any():
        raise AssertionError(f"CTF line profile not normalised: {res}")
    if not 0.9 < res["peak_g"] < 1.25:
        raise AssertionError(f"CTF line-profile peak off: {res}")
    _say("ctf_golden", **res)


def phase_ctf_lineprofile(dev):
    """The transfer-function line profile at full size, f32 (bench_ctf)."""
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor(CTF_X_OBS, dtype=dtype, device=dev)
    d = ThinDisc(0.0, math.inf, dtype=dtype, device=dev)
    bins = torch.linspace(*CTF_BINS, dtype=dtype, device=dev)

    def profile():
        return lineprofile(m, x, d, bins=bins, num_re=100, N=80, backend="cuda")[1]

    cuda_solver.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = profile()  # warm-up: builds the solver
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        flux = profile()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = cuda_solver.KERNEL_LAUNCHES
    if launches == 0:
        raise AssertionError("the CTF line profile did not go through the kernel")
    total = float(flux.double().sum())
    if not bool(torch.isfinite(flux).all()) or abs(total - 1.0) > 1e-4:
        raise AssertionError(f"CTF flux not finite or not normalised: sum {total}")
    flux_np, bins_np = flux.double().cpu().numpy(), bins.double().cpu().numpy()
    m1 = _m1(flux_np, bins_np)
    drift = abs(m1 / M1_F64_CPU - 1.0)
    if drift > 1e-3:
        raise AssertionError(f"CTF m1 {m1} drifts {drift} from the f64 CPU value")
    dt = statistics.median(times)
    busy_ms, device_events = _device_busy_ms(profile)
    res = dict(
        seconds_per_profile=dt,
        profile_seconds=times,
        first_profile_seconds=first,
        launches=launches,
        launches_per_profile=launches / 4,
        flux_sum=total,
        m1=m1,
        m1_drift_vs_f64_cpu=drift,
        nonzero_bins=int((flux > 0).sum()),
        device_events=device_events,
        device_busy_ms=busy_ms,
        device_busy_share=None if busy_ms is None else busy_ms / 1e3 / dt,
    )
    _say("ctf_lineprofile", **res)
    return res, flux_np


def _binned_profile(dev, side, incl_deg, r_max_plane, bins, isco_margin, max_re):
    """`bench_binning`'s path: a side×side geometric polar plane traced by
    `CudaTracer` against ThinDisc(0, ∞) over λ ∈ (0, 2000), then
    `binned_flux` with the analytic redshift, ε = r⁻³ and rₑ ∈
    [isco + isco_margin, max_re]. Returns (profile, tracer)."""
    lam_max = 2000.0
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(incl_deg), 0.0], dtype=dtype, device=dev)
    tracer = CudaTracer(m, geometry=ThinDisc(0.0, math.inf, dtype=dtype, device=dev))
    plane = PolarPlane(GeometricGrid(), Nr=side, Ntheta=side, r_max=r_max_plane, dtype=dtype, device=dev)
    pf = redshift_pointfunction(m, x)
    min_re = float(m.isco()) + isco_margin

    def profile():
        alpha, beta = plane.impact_parameters()
        v = map_impact_parameters(m, x, alpha, beta)
        gp = tracer(x.expand_as(v), v, (0.0, lam_max))
        return binned_flux(
            m,
            gp,
            plane.unnormalized_areas(),
            lambda r: r**-3.0,
            bins,
            min_re=min_re,
            max_re=max_re,
            lam_max=lam_max,
            redshift_pf=pf,
        )

    return profile, tracer


def phase_binning_lineprofile(dev, ctf_flux, side=1000):
    """The binned line profile at full size (bench_binning: i=70°, plane
    r_max 50, bins 0.1:1.4×200, rₑ ∈ [isco, 200]); then once at the CTF
    profile's configuration, to compare the two methods."""
    bins = torch.linspace(0.1, 1.4, 200, dtype=torch.float32, device=dev)
    profile, tracer = _binned_profile(dev, side, 70.0, 50.0, bins, 0.0, 200.0)
    n = side * side
    cuda_solver.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    flux = profile()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        flux = profile()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = cuda_solver.KERNEL_LAUNCHES
    aux = tracer.last_aux
    if launches != 4:
        raise AssertionError(f"4 binned profiles launched the kernel {launches} times")
    if int(aux["unfinished"]) != 0:
        raise AssertionError(f"{int(aux['unfinished'])} rays unfinished")
    total = float(flux.double().sum())
    nonzero = int((flux > 0).sum())
    if abs(total - 1.0) > 1e-4 or nonzero <= 100:
        raise AssertionError(f"binned flux: sum {total}, {nonzero} nonzero bins")
    dt = statistics.median(times)
    executed = int(aux["warp_iters"].sum())
    useful = int(aux["steps"].sum())

    # the binned method at the transfer-function profile's configuration
    ctf_bins = torch.linspace(*CTF_BINS, dtype=torch.float32, device=dev)
    profile60, _ = _binned_profile(dev, side, 60.0, 250.0, ctf_bins, 1e-2, 50.0)
    fb = profile60().double().cpu().numpy()
    g = ctf_bins.double().cpu().numpy()
    top = ctf_flux > 1e-3 * ctf_flux.max()
    res = dict(
        rays=n,
        seconds_per_profile=dt,
        profile_seconds=times,
        rays_per_s=n / dt,
        launches=launches,
        unfinished=int(aux["unfinished"]),
        flux_sum=total,
        nonzero_bins=nonzero,
        executed_lane_steps=executed,
        useful_ray_steps=useful,
        wasted_step_fraction=1.0 - useful / max(executed, 1),
        vs_ctf_bins_compared=int(top.sum()),
        vs_ctf_median_rel=float(np.median(np.abs(fb[top] - ctf_flux[top]) / ctf_flux[top])),
        m1_binned=_m1(fb, g),
        m1_ctf=_m1(ctf_flux, g),
    )
    _say("binning_lineprofile", **res)
    return res


def main():
    t_start = time.perf_counter()
    seconds = {}

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed_phase("device", phase_device)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    timed_phase("build", phase_build)
    checks = timed_phase("kernel_vs_plain", phase_kernel_vs_plain, dev)
    timed_phase("goldens", phase_goldens, dev)
    rendered = timed_phase("main_path", phase_main_path, dev)
    timed_phase("ctf_golden", phase_ctf_golden, dev)
    ctf, ctf_flux = timed_phase("ctf_lineprofile", phase_ctf_lineprofile, dev)
    binned = timed_phase("binning_lineprofile", phase_binning_lineprofile, dev, ctf_flux)
    _say("timing", seconds=seconds, total_seconds=time.perf_counter() - t_start)
    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": "geodesic_tsit5",
                        "route": "cuda",
                        "source": "gradus_tpu_torch/csrc/geodesic_tsit5.cu",
                        "replaces": "gradus_tpu/integrate/pallas_solver.py:580",
                        "launches": rendered["launches"],
                        "max_abs_err": checks["f64"]["hit_max_abs_err"],
                        "ms": rendered["subset_kernel_ms"],
                        "plain_ms": rendered["subset_plain_ms"],
                        "modes": ["none", "thin_disc", "datum_plane"],
                        "datum_plane_max_abs_err": checks["datum_plane"]["f64"][
                            "hit_max_abs_err"
                        ],
                        "launches_by_path": {
                            "flagship_render": rendered["launches"],
                            "ctf_lineprofile": ctf["launches"],
                            "binning_lineprofile": binned["launches"],
                        },
                        "ctf_launches_per_profile": ctf["launches_per_profile"],
                    }
                ]
            }
        ),
        flush=True,
    )
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    sys.exit(main())
