"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Builds the port's CUDA kernel from `gradus_tpu_torch/csrc/`, holds it against
its plain PyTorch version on the card (f64 and f32), reproduces the two
render goldens through it, then runs the flagship render at full size: 1024²
rays, f32, Kerr a=0.998, observer at r=1000 and i=75°, ThinDisc(0, 50),
λ ∈ (0, 2200), analytic Kerr redshift. Every phase prints one line; any
failure raises, so the exit code is non-zero. The last line is a JSON
object with the device.

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
from gradus_tpu_torch.camera import ConstPointFunctions, map_impact_parameters
from gradus_tpu_torch.geometry import ThinDisc
from gradus_tpu_torch.integrate import StatusCodes, cuda_solver
from gradus_tpu_torch.integrate.cuda_solver import (
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.metrics import KerrMetric

SPAN = (0.0, 2200.0)
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
HIT = StatusCodes.IntersectedWithGeometry


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


def phase_kernel_vs_plain(dev, n_disc=8192, n_free=2048):
    """The kernel and its plain version on the same card tensors, compared
    after the polish: flagship rays with the disc, and rays without one."""
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


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    checks = phase_kernel_vs_plain(dev)
    phase_goldens(dev)
    rendered = phase_main_path(dev)
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
