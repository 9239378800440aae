"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Builds the port's CUDA kernel from `gradus_tpu_torch/csrc/`, holds it against
its plain PyTorch version on the card (f64 and f32; flagship rays against a
ThinDisc, rays without geometry, transfer-function rays against a
DatumPlane, every metric of the port, and the kernel's modes: sampled
events, capped and resumed passes, crossing counters, timelike rays),
reproduces the two render goldens through it, then runs the port's products
through their entry points:

- the flagship render at full size: 1024² rays, f32, Kerr a=0.998, observer
  at r=1000 and i=75°, ThinDisc(0, 50), λ ∈ (0, 2200), analytic Kerr
  redshift; once more with a capped pass and a resumed tail pass, which
  must give the same image;
- the same camera in Johannsen-Psaltis (a=0.6, ε₃=2) and in Kerr-Newman
  (a=0.5, Q=0.3), through the kernel's dual-number path and the
  dot-product redshift with the generic ISCO;
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
from gradus_tpu_torch import metrics
from gradus_tpu_torch.lineprofile import binned_flux, lineprofile
from gradus_tpu_torch.metrics import (
    JohannsenMetric,
    JohannsenPsaltisMetric,
    KerrMetric,
    KerrNewmanMetric,
)
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
# the render goldens' camera (tests/test_render.py): r = 100, i = 85°, λ ≤ 200
GOLDEN_X_OBS = [0.0, 100.0, math.radians(85.0), 0.0]
# the deformed metrics at the parameters of tests/test_metrics.py:26-32
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
# the flagship camera with the Johannsen-Psaltis metric of Gradus.jl's
# deformed line-profile golden
JP = dict(M=1.0, a=0.6, eps3=2.0)
# the other metrics, at the parameters of tests/test_metrics.py:22-36
# (first-order Kerr at the spin of the other Kerr-like ones)
NEW_METRICS = {
    "KerrNewmanMetric": dict(M=1.0, a=0.5, Q=0.3),
    "MorrisThorneWormhole": dict(b=1.0),
    "KerrRefractive": dict(M=1.0, a=0.5, n=1.2, corona_radius=20.0),
    "KerrDarkMatter": dict(M=1.0, a=0.5),
    "SphericalMetric": {},
    "CartesianMetric": {},
    "KerrSpacetimeFirstOrder": dict(M=1.0, a=0.5),
}
# The refractive index steps from 1 to n within ~1e-4 of corona_radius and the
# dark-matter mass has a kink in its second derivative: across them the
# embedded error estimate misses the error it makes, and two step sequences
# that differ by rounding end up to ~6e-6 apart (the kernel's C++ built with
# and without FMA contraction on a CPU, 256 rays: 6.3e-6 and 4.3e-6).
NEW_HIT_RTOL = {"KerrRefractive": 1e-5, "KerrDarkMatter": 1e-5}
# CartesianMetric's state is (t, x, y, z), which a disc would read as
# (t, r, θ, φ): it is traced without one.
NO_DISC = {"CartesianMetric"}
# the Kerr-Newman render: tests/test_metrics.py:28's parameters
KN = dict(M=1.0, a=0.5, Q=0.3)
# The flagship render's tail pass. After 128 loop iterations 16,140 of its
# 1024² rays are mid-flight (the kernel's C++ in f32 on a CPU), 98.5% of
# the 16,384 bucket of the TPU tracer's default; rounding on the card may
# differ, so the bucket holds 32,768.
SEGMENT_ITERS, TAIL_BUCKET = 128, 32768


# The kernel's operations (additions, multiplications, divisions, square
# roots and transcendental calls, one each) per ray start and per attempted
# step, counted by running its C++ on a CPU with a counting scalar over 512
# rays of each configuration: `python -m gradus_tpu_torch.opcount`.
KERNEL_OPS = {
    "kerr": (427.0, 1641.5810057681372),
    "johannsen_psaltis": (675.0, 2385.5925913741485),
    "kerr_newman": (559.0, 2037.583382536246),
    "kerr_datum_plane": (428.0, 1642.1925643294255),
}
# NVIDIA H100 SXM data sheet, at its 700 W limit: FP32 and FP64 outside the
# tensor cores, and HBM3
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_PER_S = 3.35e12


def _bound(metric, rays, attempts, dtype):
    """(the least milliseconds the card could take for the kernel's work on
    these rays, what bounds it): the larger of the operations (per ray
    start and per attempted step, `KERNEL_OPS`) over the peak rate and the
    bytes it must move (8 state values in; 22 values and 5 int32 out per
    ray) over the memory rate."""
    per_start, per_step = KERNEL_OPS[metric]
    ops_ms = (rays * per_start + attempts * per_step) / PEAK_OPS[dtype] * 1e3
    itemsize = torch.finfo(dtype).bits // 8
    bytes_ms = rays * (30 * itemsize + 20) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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


def _hit_ends_rel(gk, gp):
    """Max over rays that both versions hit of |Δ| / max(1, |value|), over
    the polished position and λ."""
    hit = (gk.status == HIT) & (gp.status == HIT)
    if not bool(hit.any()):
        return 0, 0.0, 0.0
    ends_k = torch.cat([gk.x[hit], gk.lam_max[hit, None]], dim=-1)
    ends_p = torch.cat([gp.x[hit], gp.lam_max[hit, None]], dim=-1)
    diff = (ends_k - ends_p).abs()
    return int(hit.sum()), float(diff.max()), float((diff / ends_p.abs().clamp(min=1.0)).max())


def _metrics_group(dev, n=1024):
    """Each deformed metric's kernel (the dual-number right-hand side)
    against its plain version (the AD Jacobian) on the same card tensors,
    after the polish, at the render goldens' camera against ThinDisc(0, 40):
    f64 for all five, f32 for Johannsen-Psaltis. f64: statuses ≥ 0.999
    identical and hits within 1e-6 relative to max(1, |value|); f32: the
    median relative dot-product redshift of the hits ≤ 1e-4."""
    rng = np.random.default_rng(22)
    alpha, beta = rng.uniform(-9.5, 9.5, n), rng.uniform(-9.5, 9.5, n)
    span = (0.0, 200.0)
    out = {}
    cases = [(kind, kind, torch.float64) for kind in DEFORMED]
    cases.append(("JohannsenPsaltisMetric_f32", "JohannsenPsaltisMetric", torch.float32))
    for name, kind, dtype in cases:
        m = getattr(metrics, kind)(**DEFORMED[kind], dtype=dtype, device=dev)
        x = torch.tensor(GOLDEN_X_OBS, dtype=dtype, device=dev)
        tracer = CudaTracer(
            m, geometry=ThinDisc(0.0, 40.0, dtype=dtype, device=dev), chart_inner=CHART_INNER.get(kind)
        )
        A = torch.as_tensor(alpha, dtype=dtype, device=dev)
        B = torch.as_tensor(beta, dtype=dtype, device=dev)
        y0 = _constrained(tracer, m, x, A, B)
        kw = tracer._integrate_kwargs(dtype)
        cuda_integrate_rays(m, y0, span, **kw)  # warm-up
        (out_k, ms_k), (out_p, ms_p) = (
            _timed(lambda f=f: f(m, y0, span, **kw))
            for f in (cuda_integrate_rays, integrate_rays_plain)
        )
        gk, gp = tracer._finish(out_k, y0, span[0]), tracer._finish(out_p, y0, span[0])
        torch.cuda.synchronize()
        hits, err_abs, err_rel = _hit_ends_rel(gk, gp)
        res = dict(
            rays=n,
            status_agree=float((gk.status == gp.status).double().mean()),
            hits=hits,
            hit_max_abs_err=err_abs,
            hit_max_rel_err=err_rel,
            attempts=int(out_k["attempts"].sum()),
            kernel_ms=ms_k,
            plain_ms=ms_p,
        )
        if dtype == torch.float64:
            if res["status_agree"] < 0.999 or res["hit_max_rel_err"] > 1e-6:
                raise AssertionError(f"{name} kernel/plain disagree: {res}")
        else:
            pf = ConstPointFunctions.redshift(m, x)
            hit = (gk.status == HIT) & (gp.status == HIT)
            res["g_median_rel"] = float(_rel(pf(m, gk, span[1])[hit], pf(m, gp, span[1])[hit]).median())
            if res["status_agree"] < 0.995 or res["g_median_rel"] > 1e-4:
                raise AssertionError(f"{name} kernel/plain disagree: {res}")
        out[name] = res
    return out


def _dual_vs_hand(dev, n=8192, n_full=262144):
    """Johannsen without deviations is Kerr: the kernel's dual-number
    right-hand side against Kerr's hand-derived one on the same flagship
    rays, both through the kernel. f64: statuses ≥ 0.999 identical, hits
    within 1e-6 relative to max(1, |value|). The kernel times of both, in
    f64 and f32, give the cost of the AD path: on ``n`` rays, whose launch
    fills half the SMs with 4 warps and waits on its slowest ray, and per
    attempted step on ``n_full`` rays, which fill the card."""
    rng = np.random.default_rng(23)
    alpha, beta = rng.uniform(-28.0, 28.0, n_full), rng.uniform(-18.0, 18.0, n_full)
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        x = torch.tensor(X_OBS, dtype=dtype, device=dev)
        d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev)
        A = torch.as_tensor(alpha, dtype=dtype, device=dev)
        B = torch.as_tensor(beta, dtype=dtype, device=dev)
        runs = []
        for m in (
            JohannsenMetric(1.0, 0.998, dtype=dtype, device=dev),
            KerrMetric(1.0, 0.998, dtype=dtype, device=dev),
        ):
            tracer = CudaTracer(m, geometry=d)
            y0_full = _constrained(tracer, m, x, A, B)
            y0 = y0_full[:n]
            kw = tracer._integrate_kwargs(dtype)
            cuda_integrate_rays(m, y0, SPAN, **kw)  # warm-up
            raw, ms = _timed(lambda: cuda_integrate_rays(m, y0, SPAN, **kw))
            raw_full, ms_full = _timed(lambda: cuda_integrate_rays(m, y0_full, SPAN, **kw))
            attempts = raw["attempts"]
            ns_per_step = ms_full * 1e6 / int(raw_full["attempts"].sum())
            gp = tracer._finish(raw, y0, SPAN[0])
            runs.append((gp, ms, int(attempts.sum()), int(attempts.max()), ms_full, ns_per_step))
        torch.cuda.synchronize()
        (g_dual, ms_dual, att_dual, tail_dual, full_dual, ns_dual) = runs[0]
        (g_hand, ms_hand, att_hand, tail_hand, full_hand, ns_hand) = runs[1]
        hits, err_abs, err_rel = _hit_ends_rel(g_dual, g_hand)
        res = dict(
            rays=n,
            status_agree=float((g_dual.status == g_hand.status).double().mean()),
            hits=hits,
            hit_max_abs_err=err_abs,
            hit_max_rel_err=err_rel,
            dual_ms=ms_dual,
            hand_ms=ms_hand,
            dual_over_hand=ms_dual / ms_hand,
            attempts_dual=att_dual,
            attempts_hand=att_hand,
            max_attempts_dual=tail_dual,
            max_attempts_hand=tail_hand,
            full_rays=n_full,
            full_dual_ms=full_dual,
            full_hand_ms=full_hand,
            ns_per_attempted_step_dual=ns_dual,
            ns_per_attempted_step_hand=ns_hand,
            dual_over_hand_per_step=ns_dual / ns_hand,
        )
        if name == "f64" and (res["status_agree"] < 0.999 or res["hit_max_rel_err"] > 1e-6):
            raise AssertionError(f"dual vs hand {name} disagree: {res}")
        if name == "f32" and res["status_agree"] < 0.995:
            raise AssertionError(f"dual vs hand {name} disagree: {res}")
        out[name] = res
    return out


def _golden_offsets(n, seed):
    """Image-plane offsets ρ ∈ [6.5, 9.5] at uniform angles, for the render
    goldens' camera: outside every metric's critical curve (ρ ≈ 4.8-6.0
    there), whose rays circle the photon orbit and turn a rounding
    difference into a different hit."""
    rng = np.random.default_rng(seed)
    rho, phi = rng.uniform(6.5, 9.5, n), rng.uniform(0.0, 2 * math.pi, n)
    return rho * np.cos(phi), rho * np.sin(phi)


def _straight_line_err(x0, gp, spherical):
    """Max over rays of |endpoint − (x₀ + v₀λ)| / max(1, |x₀ + v₀λ|), in
    Cartesian terms: a flat-space answer independent of both versions."""

    def cart(x):
        r, th, ph = x[..., 1], x[..., 2], x[..., 3]
        return torch.stack([r * torch.sin(th) * torch.cos(ph), r * torch.sin(th) * torch.sin(ph), r * torch.cos(th)], -1)

    v0, lam = gp.v_init[:, 1:], gp.lam_max[:, None]
    if spherical:
        # the Jacobian d(x, y, z)/d(r, θ, φ) at the start maps v₀
        r, th, ph = x0[1], x0[2], x0[3]
        J = torch.stack(
            [
                torch.stack([torch.sin(th) * torch.cos(ph), r * torch.cos(th) * torch.cos(ph), -r * torch.sin(th) * torch.sin(ph)]),
                torch.stack([torch.sin(th) * torch.sin(ph), r * torch.cos(th) * torch.sin(ph), r * torch.sin(th) * torch.cos(ph)]),
                torch.stack([torch.cos(th), -r * torch.sin(th), torch.zeros_like(r)]),
            ]
        )
        line, end = cart(x0) + (v0 @ J.T) * lam, cart(gp.x)
    else:
        line, end = x0[1:] + v0 * lam, gp.x[:, 1:]
    return float(((end - line).norm(dim=-1) / line.norm(dim=-1).clamp(min=1.0)).max())


def _new_metrics_group(dev, n=512):
    """The metrics of kerr_newman.py, exotic.py, minkowski.py and
    kerr_first_order.py: the kernel (dual numbers; Kerr's hand-derived
    Jacobian for the first-order class) against its plain version (the AD
    Jacobian) on the same card tensors, after the polish, at the render
    goldens' camera (`_golden_offsets`) against ThinDisc(0, 40) (no geometry
    for CartesianMetric), f64; Kerr-Newman also in f32. f64: statuses ≥
    0.999 identical and hits within 1e-6 relative to max(1, |value|)
    (`NEW_HIT_RTOL` for the two non-smooth metrics); the two flat metrics'
    kernel endpoints on the straight line x₀ + v₀λ, to 1e-12 relative in
    the Cartesian chart (whose right-hand side is 0) and 1e-8 in the
    spherical one (~100 steps at reltol 1e-9). f32: the median relative
    dot-product redshift of the hits ≤ 1e-4."""
    alpha, beta = _golden_offsets(n, 24)
    span = (0.0, 200.0)
    out = {}
    cases = [(kind, kind, torch.float64) for kind in NEW_METRICS]
    cases.append(("KerrNewmanMetric_f32", "KerrNewmanMetric", torch.float32))
    for name, kind, dtype in cases:
        m = getattr(metrics, kind)(**NEW_METRICS[kind], dtype=dtype, device=dev)
        x = torch.tensor(GOLDEN_X_OBS, dtype=dtype, device=dev)
        d = None if kind in NO_DISC else ThinDisc(0.0, 40.0, dtype=dtype, device=dev)
        tracer = CudaTracer(m, geometry=d)
        y0 = _constrained(
            tracer, m, x, torch.as_tensor(alpha, dtype=dtype, device=dev), torch.as_tensor(beta, dtype=dtype, device=dev)
        )
        kw = tracer._integrate_kwargs(dtype)
        cuda_integrate_rays(m, y0, span, **kw)  # warm-up
        (out_k, ms_k), (out_p, ms_p) = (
            _timed(lambda f=f: f(m, y0, span, **kw)) for f in (cuda_integrate_rays, integrate_rays_plain)
        )
        gk, gp = tracer._finish(out_k, y0, span[0]), tracer._finish(out_p, y0, span[0])
        torch.cuda.synchronize()
        hits, err_abs, err_rel = _hit_ends_rel(gk, gp)
        res = dict(
            rays=n,
            status_agree=float((gk.status == gp.status).double().mean()),
            hits=hits,
            hit_max_abs_err=err_abs,
            hit_max_rel_err=err_rel,
            attempts=int(out_k["attempts"].sum()),
            kernel_ms=ms_k,
            plain_ms=ms_p,
        )
        if kind in ("SphericalMetric", "CartesianMetric") and dtype == torch.float64:
            res["line_max_rel_err"] = _straight_line_err(x, gk, kind == "SphericalMetric")
            if res["line_max_rel_err"] > (1e-8 if kind == "SphericalMetric" else 1e-12):
                raise AssertionError(f"{name}: kernel endpoints off the straight line: {res}")
        if dtype == torch.float64:
            if res["status_agree"] < 0.999 or (hits and res["hit_max_rel_err"] > NEW_HIT_RTOL.get(kind, 1e-6)):
                raise AssertionError(f"{name} kernel/plain disagree: {res}")
            if kind not in NO_DISC and hits < n // 10:
                raise AssertionError(f"{name}: {hits} hits of {n} rays")
        else:
            pf = ConstPointFunctions.redshift(m, x)
            hit = (gk.status == HIT) & (gp.status == HIT)
            res["g_median_rel"] = float(_rel(pf(m, gk, span[1])[hit], pf(m, gp, span[1])[hit]).median())
            if res["status_agree"] < 0.995 or res["g_median_rel"] > 1e-4:
                raise AssertionError(f"{name} kernel/plain disagree: {res}")
        out[name] = res
    return out


def _flagship_rays(dev, dtype, n, seed, **tracer_kw):
    """(metric, tracer, constrained states) for ``n`` flagship rays (uniform
    α ∈ ±28, β ∈ ±18) against ThinDisc(0, 50)."""
    rng = np.random.default_rng(seed)
    m, d, x = _flagship(dtype, dev)
    tracer = CudaTracer(m, geometry=d, **tracer_kw)
    A = torch.as_tensor(rng.uniform(-28.0, 28.0, n), dtype=dtype, device=dev)
    B = torch.as_tensor(rng.uniform(-18.0, 18.0, n), dtype=dtype, device=dev)
    return m, tracer, _constrained(tracer, m, x, A, B)


def _sampled_events(dev, n):
    """event_method="sampled" (8 Hermite samples a step, 10 bisections),
    kernel against plain version on flagship rays, with the flagship
    group's thresholds; and the kernel's sampled hits against its cubic
    ones, printed."""
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        m, tracer, y0 = _flagship_rays(dev, dtype, n, 25, event_method="sampled")
        kw = tracer._integrate_kwargs(dtype)
        (out_k, ms_k), (out_p, ms_p) = (
            _timed(lambda f=f: f(m, y0, SPAN, **kw)) for f in (cuda_integrate_rays, integrate_rays_plain)
        )
        cubic = CudaTracer(m, geometry=tracer.geometry)
        gk, gp = tracer._finish(out_k, y0, SPAN[0]), tracer._finish(out_p, y0, SPAN[0])
        gc = cubic._finish(cuda_integrate_rays(m, y0, SPAN, **cubic._integrate_kwargs(dtype)), y0, SPAN[0])
        torch.cuda.synchronize()
        hits, err_abs, err_rel = _hit_ends_rel(gk, gp)
        _, cubic_abs, cubic_rel = _hit_ends_rel(gk, gc)
        hit = (gk.status == HIT) & (gp.status == HIT)
        pf = ConstPointFunctions.redshift(m, torch.tensor(X_OBS, dtype=dtype, device=dev))
        res = dict(
            rays=n,
            status_agree=float((gk.status == gp.status).double().mean()),
            hits=hits,
            hit_max_abs_err=err_abs,
            hit_max_rel_err=err_rel,
            g_median_rel=float(_rel(pf(m, gk, SPAN[1])[hit], pf(m, gp, SPAN[1])[hit]).median()),
            vs_cubic_status_agree=float((gk.status == gc.status).double().mean()),
            vs_cubic_hit_max_abs_err=cubic_abs,
            vs_cubic_hit_max_rel_err=cubic_rel,
            kernel_ms=ms_k,
            plain_ms=ms_p,
        )
        if dtype == torch.float64:
            if res["status_agree"] < 0.999 or err_abs > 1e-6:
                raise AssertionError(f"sampled {name} kernel/plain disagree: {res}")
        elif res["status_agree"] < 0.995 or res["g_median_rel"] > 1e-4:
            raise AssertionError(f"sampled {name} kernel/plain disagree: {res}")
        out[name] = res
    return out


def _segmented(dev, n, segment_iters=128, tail_bucket=8192):
    """The kernel's single pass against a pass capped at ``segment_iters``
    loop iterations plus a resumed pass over its survivors in a
    ``tail_bucket``-sized bucket (`CudaTracer._integrate`), on flagship
    rays: statuses identical and outputs bit for bit the same (else the f64
    endpoints within 1e-12 relative). 128 / 8192 rather than 48 / 2048:
    after 48 iterations 12,100 (f32) and 14,154 (f64) of 16,384 flagship
    rays are mid-flight (the kernel's C++ on a CPU), more than such a
    bucket holds. Then a bucket of 8 leaves rays unfinished, and says so."""
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        m, single, y0 = _flagship_rays(dev, dtype, n, 26)
        seg = CudaTracer(m, geometry=single.geometry, segment_iters=segment_iters, tail_bucket=tail_bucket)
        capped = cuda_integrate_rays(m, y0, SPAN, iter_cap=segment_iters, **single._integrate_kwargs(dtype))
        survivors = int(cuda_solver._mid_flight(capped, SPAN[1]).sum())
        o1, o2 = single._integrate(y0, SPAN), seg._integrate(y0, SPAN)
        torch.cuda.synchronize()
        same = {k: bool(torch.equal(o1[k], o2[k])) for k in ("y", "status", "lam", "dt", "steps", "hit_theta")}
        res = dict(
            rays=n,
            survivors=survivors,
            unfinished=int(cuda_solver._mid_flight(o2, SPAN[1]).sum()),
            status_identical=same["status"],
            bit_identical=all(same.values()),
            y_max_rel_err=float(((o1["y"] - o2["y"]).abs() / o1["y"].abs().clamp(min=1.0)).max()),
            attempts=(int(o1["attempts"].sum()), int(o2["attempts"].sum())),
            warp_iters=(int(o1["warp_iters"].sum()), int(o2["warp_iters"].sum())),
        )
        if not same["status"] or res["unfinished"] != 0 or not 0 < survivors <= tail_bucket:
            raise AssertionError(f"segmented {name} differs from the single pass: {res}")
        if not res["bit_identical"] and (dtype == torch.float32 or res["y_max_rel_err"] > 1e-12):
            raise AssertionError(f"segmented {name} differs from the single pass: {res}")
        out[name] = res
    m, _, y0 = _flagship_rays(dev, torch.float64, n, 26)
    small = CudaTracer(m, geometry=ThinDisc(0.0, 50.0, device=dev), segment_iters=48, tail_bucket=8)
    out["tail_bucket_8_unfinished"] = int(small.trace(y0, SPAN)[1]["unfinished"])
    if out["tail_bucket_8_unfinished"] <= 0:
        raise AssertionError("an undersized tail bucket left no ray unfinished")
    return out


def _crossing_counters(dev, n):
    """terminate_on_hit=False against DatumPlane(0) on flagship rays, f64:
    the kernel's crossing counts against the plain version's, identical
    for ≥ 0.999 of the rays."""
    m, tracer, y0 = _flagship_rays(dev, torch.float64, n, 27)
    kw = {**tracer._integrate_kwargs(torch.float64), "geometry": DatumPlane(0.0, device=dev)}
    (ok, ms_k), (op, ms_p) = (
        _timed(lambda f=f: f(m, y0, SPAN, terminate_on_hit=False, **kw)) for f in (cuda_integrate_rays, integrate_rays_plain)
    )
    torch.cuda.synchronize()
    res = dict(
        rays=n,
        count_agree=float((ok["crossings"] == op["crossings"]).double().mean()),
        status_agree=float((ok["status"] == op["status"]).double().mean()),
        counts=torch.bincount(ok["crossings"].long()).tolist(),
        kernel_ms=ms_k,
        plain_ms=ms_p,
    )
    if res["count_agree"] < 0.999 or res["status_agree"] < 0.999 or len(res["counts"]) < 3:
        raise AssertionError(f"crossing counters kernel/plain disagree: {res}")
    return res


def _timelike(dev, n):
    """mu = 1 (timelike rays from the flagship camera) against the disc, f64:
    kernel against plain version with the flagship group's thresholds."""
    m, tracer, y0 = _flagship_rays(dev, torch.float64, n, 28, mu=1.0)
    kw = tracer._integrate_kwargs(torch.float64)
    gk = tracer._finish(cuda_integrate_rays(m, y0, SPAN, **kw), y0, SPAN[0])
    gp = tracer._finish(integrate_rays_plain(m, y0, SPAN, **kw), y0, SPAN[0])
    torch.cuda.synchronize()
    hits, err_abs, err_rel = _hit_ends_rel(gk, gp)
    res = dict(
        rays=n,
        status_agree=float((gk.status == gp.status).double().mean()),
        hits=hits,
        hit_max_abs_err=err_abs,
        hit_max_rel_err=err_rel,
    )
    if res["status_agree"] < 0.999 or err_abs > 1e-6 or hits < n // 10:
        raise AssertionError(f"timelike kernel/plain disagree: {res}")
    return res


def phase_kernel_vs_plain(
    dev,
    n_disc=8192,
    n_free=2048,
    n_datum=8192,
    n_metric=1024,
    n_dual=8192,
    n_new_metric=512,
    n_sampled=2048,
    n_seg=16384,
    n_cross=2048,
    n_timelike=512,
):
    """The kernel and its plain version on the same card tensors, compared
    after the polish: flagship rays with the disc, rays without one,
    transfer-function rays against a DatumPlane, the deformed metrics and
    the other metrics; the kernel's dual-number path against its
    hand-derived Kerr path; then the kernel's modes: sampled events, the
    tail pass, crossing counters and timelike rays."""
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
    results["metrics"] = _metrics_group(dev, n_metric)
    results["dual_vs_hand"] = _dual_vs_hand(dev, n_dual)
    results["new_metrics"] = _new_metrics_group(dev, n_new_metric)
    results["modes"] = dict(
        sampled=_sampled_events(dev, n_sampled),
        segmented=_segmented(dev, n_seg),
        crossing_counters=_crossing_counters(dev, n_cross),
        timelike=_timelike(dev, n_timelike),
    )
    _say("kernel_vs_plain", **results)
    return results


def phase_goldens(dev):
    """tests/test_render.py's goldens through the kernel, f64: the Kerr
    shadow and thin disc, and the Johannsen (a = 0) shadow through the
    dual-number path."""
    sums = {}
    A, B = _pixel_grid(20, 20, (-9.5, 9.5), (-9.5, 9.5), 1e-6, torch.float64, dev)
    x = torch.tensor(GOLDEN_X_OBS, dtype=torch.float64, device=dev)
    kerr = KerrMetric(1.0, 0.0, device=dev)
    for name, m, d, golden in (
        ("shadow", kerr, None, 9009.452876609641),
        ("thin_disc", kerr, ThinDisc(0.0, 40.0, device=dev), 38412.08347901267),
        ("johannsen_shadow", JohannsenMetric(1.0, 0.0, device=dev), None, 9009.448935932085),
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


def _full_render(dev, m, side, name, ops_key, subset=True, **tracer_kw):
    """A side² render, f32, at the flagship camera (r = 1000, i = 75°,
    ThinDisc(0, 50), λ ∈ (0, 2200)) through the port's entry points, with
    the metric's redshift point function; one warm-up and three timed
    renders, one kernel launch each (two with a tail pass, ``tracer_kw``'s
    ``segment_iters``). With ``subset``, every 64th pixel is held against
    the plain version on the card. Returns (the printed result, the last
    render's GeodesicPoint)."""
    dtype = torch.float32
    n = side * side
    d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev)
    x = torch.tensor(X_OBS, dtype=dtype, device=dev)
    pf = ConstPointFunctions.redshift(m, x) @ ConstPointFunctions.filter_intersected()
    tracer = CudaTracer(m, geometry=d, **tracer_kw)
    A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev)
    last = {}

    def render():
        A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev)
        v = map_impact_parameters(m, x, A, B)
        last["gp"] = tracer(x.expand_as(v), v, SPAN)
        return pf(m, last["gp"], SPAN[1])

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
    per_render = 1 if tracer.segment_iters is None else 2
    if launches != 4 * per_render:
        raise AssertionError(f"{name}: 4 renders launched the kernel {launches} times")
    if int(aux["unfinished"]) != 0:
        raise AssertionError(f"{name}: {int(aux['unfinished'])} rays unfinished")
    finite = torch.isfinite(img)
    g = img[finite]
    if finite.sum() == 0 or not bool(((g > 0) & (g < 2)).all()) or float(g.max()) <= 1.0:
        raise AssertionError(f"{name}: redshift image out of range")
    dt = statistics.median(times)
    executed = int(aux["warp_iters"].sum())
    useful = int(aux["steps"].sum())
    attempted = int(aux["attempts"].sum())
    kw = tracer._integrate_kwargs(dtype)
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
        dead_lane_share=(executed - attempted) / max(executed, 1),
    )

    if subset:
        # every 64th pixel, against the plain version on the card
        idx = torch.arange(0, n, 64, device=dev)
        y0 = _constrained(tracer, m, x, A[idx], B[idx])
        out_p, plain_ms = _timed(lambda: integrate_rays_plain(m, y0, SPAN, **kw))
        g_p = pf(m, tracer._finish(out_p, y0, SPAN[0]), SPAN[1])
        g_k = img[idx]
        mask_agree = float((torch.isfinite(g_k) == torch.isfinite(g_p)).double().mean())
        both = torch.isfinite(g_k) & torch.isfinite(g_p)
        g_rel = float(_rel(g_k[both], g_p[both]).median())
        if mask_agree < 0.995 or not g_rel <= 1e-4:
            raise AssertionError(f"{name} subset: hit mask agree {mask_agree}, median rel g {g_rel}")
        cuda_integrate_rays(m, y0, SPAN, **kw)  # warm-up
        kernel_ms, subset_attempts = [], 0
        for _ in range(3):
            out_k, ms = _timed(lambda: cuda_integrate_rays(m, y0, SPAN, **kw))
            kernel_ms.append(ms)
            subset_attempts = int(out_k["attempts"].sum())
        result.update(
            subset_rays=int(idx.numel()),
            subset_hit_mask_agree=mask_agree,
            subset_g_median_rel=g_rel,
            subset_kernel_ms=statistics.median(kernel_ms),
            subset_plain_ms=plain_ms,
            subset_attempted_lane_steps=subset_attempts,
        )
    # the kernel alone (both passes and the compaction, with a tail pass) on
    # every ray of the render
    y0_full = _constrained(tracer, m, x, A, B)
    out_full, full_ms = _timed(lambda: tracer._integrate(y0_full, SPAN))
    full_bound_ms, _ = _bound(ops_key, n, int(out_full["attempts"].sum()), dtype)
    result.update(full_kernel_ms=full_ms, full_bound_ms=full_bound_ms, full_bound_share=full_bound_ms / full_ms)
    _say(name, **result)
    return result, last["gp"]


def phase_main_path(dev, side=1024):
    """The flagship render: Kerr a = 0.998, analytic redshift; then the same
    render with a tail pass (`SEGMENT_ITERS`, `TAIL_BUCKET`), whose image
    (status, x, λ) must be the single pass's, bit for bit. Whether the tail
    pass pays is in its time beside the single pass's."""
    m = KerrMetric(1.0, 0.998, dtype=torch.float32, device=dev)
    single, gp_1 = _full_render(dev, m, side, "main_path", "kerr")
    seg, gp_2 = _full_render(
        dev,
        m,
        side,
        "flagship_render_segmented",
        "kerr",
        subset=False,
        segment_iters=SEGMENT_ITERS,
        tail_bucket=TAIL_BUCKET,
    )
    same = dict(
        status=bool(torch.equal(gp_1.status, gp_2.status)),
        x=bool(torch.equal(gp_1.x.nan_to_num(), gp_2.x.nan_to_num())),
        lam=bool(torch.equal(gp_1.lam_max, gp_2.lam_max)),
    )
    _say(
        "segmented_vs_single",
        image_identical=same,
        seconds_per_render=(single["seconds_per_render"], seg["seconds_per_render"]),
        full_kernel_ms=(single["full_kernel_ms"], seg["full_kernel_ms"]),
        wasted_step_fraction=(single["wasted_step_fraction"], seg["wasted_step_fraction"]),
        dead_lane_share=(single["dead_lane_share"], seg["dead_lane_share"]),
    )
    if not all(same.values()):
        raise AssertionError(f"the segmented render's image differs from the single pass's: {same}")
    return single, seg


def phase_deformed_render(dev, side=1024):
    """The flagship camera with Johannsen-Psaltis (a = 0.6, ε₃ = 2) through
    the kernel's dual-number path, and the dot-product redshift (generic
    ISCO, Keplerian and plunging disc velocities)."""
    m = JohannsenPsaltisMetric(**JP, dtype=torch.float32, device=dev)
    return _full_render(dev, m, side, "deformed_render", "johannsen_psaltis")[0]


def phase_kerr_newman_render(dev, side=1024):
    """The flagship camera with Kerr-Newman (a = 0.5, Q = 0.3) through the
    kernel's dual-number path, and the dot-product redshift with the generic
    ISCO (the metric has no closed-form one)."""
    m = KerrNewmanMetric(**KN, dtype=torch.float32, device=dev)
    return _full_render(dev, m, side, "kerr_newman_render", "kerr_newman")[0]


def _m1(flux, bins):
    """First moment Σ(flux·g)/Σflux over the bin edges (bench.py:228-230)."""
    return float((flux * bins).sum() / flux.sum())


def _device_busy_ms(fn):
    """(kernel time on the card in ms, the integrator kernel's own ms, device
    events) during one call of ``fn`` (torch.profiler, device activity
    only); a time is None if the profiler sees no such device activity. The
    profiler's raw events are summed directly: `key_averages()` over the
    ~10⁶ events of a CTF profile takes minutes of host time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    busy_ns = sum(e.duration_ns() for e in device)
    kernel_ns = sum(e.duration_ns() for e in device if "geodesic_tsit5" in e.name())
    return (busy_ns / 1e6 if busy_ns > 0 else None), (kernel_ns / 1e6 if kernel_ns > 0 else None), len(device)


def phase_ctf_golden(dev):
    """Gradus.jl's test-cunningham.jl edges through the kernel, f64
    (tests/test_transfer.py:32-84): i=60°, ThinDisc(0, 250), bins
    0.1:1.3×100, N=40, num_re=30, for Kerr a=0.6 (red edge 0.355) and
    Johannsen-Psaltis a=0.6, ε₃=2 (red edge 0.27, through the dual-number
    path, the generic ISCO and the Keplerian redshift)."""
    out = {}
    for name, m, g_low in (
        ("kerr", KerrMetric(1.0, 0.6, device=dev), 0.355),
        ("johannsen_psaltis", JohannsenPsaltisMetric(**JP, device=dev), 0.27),
    ):
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
            raise AssertionError(f"the {name} CTF golden did not go through the kernel")
        if abs(res["g_low"] - g_low) > 0.05 or abs(res["g_high"] - 1.2) > 0.05:
            raise AssertionError(f"{name} CTF line-profile edges off the Gradus.jl goldens: {res}")
        if not math.isclose(res["flux_sum"], 1.0, rel_tol=1e-10) or (f < 0).any():
            raise AssertionError(f"{name} CTF line profile not normalised: {res}")
        if name == "kerr" and not 0.9 < res["peak_g"] < 1.25:
            raise AssertionError(f"CTF line-profile peak off: {res}")
        out[name] = res
    _say("ctf_golden", **out)
    return out


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
    # one more profile under the profiler, counting the rays and attempted
    # steps of every launch for the kernel's bound (a sum on the card per
    # launch, read once at the end)
    counted = []

    def counting(*args, **kw):
        out = integrate(*args, **kw)
        counted.append(torch.stack([torch.tensor(out["attempts"].numel(), device=dev), out["attempts"].sum()]))
        return out

    integrate, cuda_solver.cuda_integrate_rays = cuda_solver.cuda_integrate_rays, counting
    try:
        busy_ms, kernel_ms, device_events = _device_busy_ms(profile)
    finally:
        cuda_solver.cuda_integrate_rays = integrate
    rays, attempts = (int(v) for v in torch.stack(counted).sum(dim=0))
    bound_ms, bound_by = _bound("kerr_datum_plane", rays, attempts, dtype)
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
        kernel_ms=kernel_ms,
        kernel_rays=rays,
        attempted_lane_steps=attempts,
        bound_ms=bound_ms,
        bound_by=bound_by,
        bound_share=None if kernel_ms is None else bound_ms / kernel_ms,
    )
    _say("ctf_lineprofile", **res)
    return res, flux_np


def _binned_profile(dev, side, incl_deg, r_max_plane, bins, isco_margin, max_re):
    """`bench_binning`'s path: a side×side geometric polar plane traced by
    `CudaTracer` against ThinDisc(0, ∞) over λ ∈ (0, 2000), then
    `binned_flux` with the analytic redshift, ε = r⁻³ and rₑ ∈
    [isco + isco_margin, max_re]. Returns (profile, tracer, kernel_only),
    the last timing the kernel alone on the plane's rays: (attempted
    lane-steps, ms)."""
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

    def kernel_only():
        alpha, beta = plane.impact_parameters()
        y0 = _constrained(tracer, m, x, alpha, beta)
        kw = tracer._integrate_kwargs(dtype)
        out, ms = _timed(lambda: cuda_integrate_rays(m, y0, (0.0, lam_max), **kw))
        return int(out["attempts"].sum()), ms

    return profile, tracer, kernel_only


def phase_binning_lineprofile(dev, ctf_flux, side=1000):
    """The binned line profile at full size (bench_binning: i=70°, plane
    r_max 50, bins 0.1:1.4×200, rₑ ∈ [isco, 200]); then once at the CTF
    profile's configuration, to compare the two methods."""
    bins = torch.linspace(0.1, 1.4, 200, dtype=torch.float32, device=dev)
    profile, tracer, kernel_only = _binned_profile(dev, side, 70.0, 50.0, bins, 0.0, 200.0)
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
    attempted, kernel_ms = kernel_only()
    bound_ms, _ = _bound("kerr", n, attempted, torch.float32)

    # the binned method at the transfer-function profile's configuration
    ctf_bins = torch.linspace(*CTF_BINS, dtype=torch.float32, device=dev)
    profile60, _, _ = _binned_profile(dev, side, 60.0, 250.0, ctf_bins, 1e-2, 50.0)
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
        attempted_lane_steps=attempted,
        useful_ray_steps=useful,
        wasted_step_fraction=1.0 - useful / max(executed, 1),
        kernel_ms=kernel_ms,
        bound_ms=bound_ms,
        bound_share=bound_ms / kernel_ms,
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
    rendered, segmented = timed_phase("main_path", phase_main_path, dev)
    deformed = timed_phase("deformed_render", phase_deformed_render, dev)
    kerr_newman = timed_phase("kerr_newman_render", phase_kerr_newman_render, dev)
    timed_phase("ctf_golden", phase_ctf_golden, dev)
    ctf, ctf_flux = timed_phase("ctf_lineprofile", phase_ctf_lineprofile, dev)
    binned = timed_phase("binning_lineprofile", phase_binning_lineprofile, dev, ctf_flux)
    _say("timing", seconds=seconds, total_seconds=time.perf_counter() - t_start)
    bound_ms, bound_by = _bound(
        "kerr", rendered["subset_rays"], rendered["subset_attempted_lane_steps"], torch.float32
    )
    deformed_bound_ms, deformed_bound_by = _bound(
        "johannsen_psaltis",
        deformed["subset_rays"],
        deformed["subset_attempted_lane_steps"],
        torch.float32,
    )
    kn_bound_ms, kn_bound_by = _bound(
        "kerr_newman",
        kerr_newman["subset_rays"],
        kerr_newman["subset_attempted_lane_steps"],
        torch.float32,
    )
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
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": None,
                        "modes": [
                            "none",
                            "thin_disc",
                            "datum_plane",
                            "sampled",
                            "resume",
                            "crossing_counter",
                            "timelike",
                        ],
                        "metrics": [
                            "kerr",
                            "johannsen",
                            "johannsen_psaltis",
                            "noz",
                            "bumblebee",
                            "dilaton_axion",
                            "kerr_newman",
                            "morris_thorne",
                            "kerr_refractive",
                            "kerr_dark_matter",
                            "spherical",
                            "cartesian",
                        ],
                        "datum_plane_max_abs_err": checks["datum_plane"]["f64"][
                            "hit_max_abs_err"
                        ],
                        "metrics_max_abs_err": max(
                            checks["metrics"][kind]["hit_max_abs_err"] for kind in DEFORMED
                        ),
                        "new_metrics_max_abs_err": max(
                            checks["new_metrics"][kind]["hit_max_abs_err"] for kind in NEW_METRICS
                        ),
                        "dual_max_abs_err": checks["dual_vs_hand"]["f64"]["hit_max_abs_err"],
                        "dual_over_hand_per_step": checks["dual_vs_hand"]["f32"][
                            "dual_over_hand_per_step"
                        ],
                        "deformed_render": {
                            "launches": deformed["launches"],
                            "ms": deformed["subset_kernel_ms"],
                            "plain_ms": deformed["subset_plain_ms"],
                            "bound_ms": deformed_bound_ms,
                            "bound_by": deformed_bound_by,
                        },
                        "kerr_newman_render": {
                            "launches": kerr_newman["launches"],
                            "ms": kerr_newman["subset_kernel_ms"],
                            "plain_ms": kerr_newman["subset_plain_ms"],
                            "bound_ms": kn_bound_ms,
                            "bound_by": kn_bound_by,
                        },
                        "flagship_render_segmented": {
                            "launches": segmented["launches"],
                            "full_kernel_ms": segmented["full_kernel_ms"],
                            "single_pass_full_kernel_ms": rendered["full_kernel_ms"],
                        },
                        "ctf_lineprofile": {
                            "launches": ctf["launches"],
                            "ms": ctf["kernel_ms"],
                            "bound_ms": ctf["bound_ms"],
                            "bound_by": ctf["bound_by"],
                        },
                        "launches_by_path": {
                            "flagship_render": rendered["launches"],
                            "flagship_render_segmented": segmented["launches"],
                            "deformed_render": deformed["launches"],
                            "kerr_newman_render": kerr_newman["launches"],
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
