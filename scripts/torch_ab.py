"""Time the PyTorch/CUDA port's products on one card for several checkouts
of it, in turns, so that two versions are compared within one run.

    python scripts/torch_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a directory that holds a `gradus_tpu_torch` package (a
checkout, or an unpacked `git archive` of one). The kernels of every ROOT are
built first, all together; then each ROOT in the order given runs in a
process of its own and prints one JSON line, f32 throughout:

- ``kernel``: the integrator alone on the 1024² flagship rays (r = 1000,
  i = 75°, ThinDisc(0, 50), λ ∈ (0, 2200)) for Kerr a = 0.998,
  Johannsen-Psaltis (a = 0.6, ε₃ = 2) and Kerr-Newman (a = 0.5, Q = 0.3):
  milliseconds by CUDA events with the tracer's arguments, and without the
  Newton polish where the package's integrator takes ``newton_iters``; for
  Kerr also the slowest ray alone and all rays with the warps of most
  attempts first;
- ``render``: seconds per render through the entry points
  (`map_impact_parameters`, `CudaTracer`, the metric's redshift point
  function), host clock ending in a synchronize;
- ``binned``: seconds per binned line profile (`bench.py::bench_binning`'s
  configuration) and ``ctf``: seconds per transfer-function profile
  (`bench.py::bench_ctf`'s), with its first moment.

Every time is the median of three after a warm-up. Needs one CUDA device
and nvcc. The card's name and power limit are printed first.

    python scripts/torch_ab.py --interleave ROOT_A ROOT_B

compares two ROOTs whose packages differ in their kernel sources only: one
process loads both kernel libraries and times the three renders and their
kernels in the order A, B, B, A, five times over, swapping the library
between calls, so that the host's own drift falls on both alike. It prints
each render's times, its kernel's and its shading's (the point function
after the kernel), for each ROOT, and how far the two libraries' outputs
differ: rays whose status or state differs, the largest difference of a
state, and each library's largest |φ| and count of non-finite states.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time

SPAN = (0.0, 2200.0)


def _timed_ms(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _median_ms(torch, fn):
    fn()
    runs = [_timed_ms(torch, fn) for _ in range(3)]
    return runs[-1][0], statistics.median(ms for _, ms in runs)


def _median_s(torch, fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _flagship(torch, dev):
    """The 1024² flagship camera in f32: (α, β, observer, ThinDisc(0, 50),
    the three metrics by name)."""
    from gradus_tpu_torch.geometry import ThinDisc
    from gradus_tpu_torch.metrics import JohannsenPsaltisMetric, KerrMetric, KerrNewmanMetric

    f32, side = torch.float32, 1024
    alphas = torch.linspace(-28.0, 28.0, side, dtype=f32, device=dev) + 1e-4
    betas = torch.linspace(-18.0, 18.0, side, dtype=f32, device=dev) + 1e-4
    A = alphas[:, None].expand(side, side).reshape(-1)
    B = betas[None, :].expand(side, side).reshape(-1)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=f32, device=dev)
    metrics = (
        ("kerr", KerrMetric(1.0, 0.998, dtype=f32, device=dev)),
        ("johannsen_psaltis", JohannsenPsaltisMetric(1.0, 0.6, 2.0, dtype=f32, device=dev)),
        ("kerr_newman", KerrNewmanMetric(1.0, 0.5, 0.3, dtype=f32, device=dev)),
    )
    return A, B, x, ThinDisc(0.0, 50.0, dtype=f32, device=dev), metrics


def run(root):
    """Time one ROOT's products; its package is first on ``sys.path``."""
    import torch

    from gradus_tpu_torch import _build
    from gradus_tpu_torch.camera import ConstPointFunctions, GeometricGrid, PolarPlane, map_impact_parameters
    from gradus_tpu_torch.geometry import ThinDisc
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer, cuda_integrate_rays
    from gradus_tpu_torch.lineprofile import binned_flux, lineprofile
    from gradus_tpu_torch.metrics import KerrMetric
    from gradus_tpu_torch.redshift import redshift_pointfunction

    _build.load_library()
    dev, f32 = torch.device("cuda", 0), torch.float32
    takes_newton = "newton_iters" in inspect.signature(cuda_integrate_rays).parameters
    A, B, x, disc, metrics = _flagship(torch, dev)
    res = {"root": root, "kernel": {}, "render": {}}
    for name, m in metrics:
        tracer = CudaTracer(m, geometry=disc)
        v = map_impact_parameters(m, x, A, B)
        y0 = tracer._constrain(x.expand_as(v), v)
        kw = tracer._integrate_kwargs(f32)
        out, ms = _median_ms(torch, lambda: cuda_integrate_rays(m, y0, SPAN, **kw))
        k = dict(ms=ms, attempts=int(out["attempts"].sum()), hits=int((out["status"] == 3).sum()))
        if takes_newton:
            _, k["ms_without_polish"] = _median_ms(
                torch, lambda: cuda_integrate_rays(m, y0, SPAN, **{**kw, "newton_iters": 0})
            )
        if name == "kerr":
            slowest = int(out["attempts"].argmax())
            y1 = y0[slowest : slowest + 1]
            _, k["slowest_ray_ms"] = _median_ms(torch, lambda: cuda_integrate_rays(m, y1, SPAN, **kw))
            order = torch.argsort(out["attempts"].view(-1, 32).amax(dim=1), descending=True)
            y_ord = y0[(order[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)]
            _, k["longest_warps_first_ms"] = _median_ms(torch, lambda: cuda_integrate_rays(m, y_ord, SPAN, **kw))
        res["kernel"][name] = k
        pf = ConstPointFunctions.redshift(m, x) @ ConstPointFunctions.filter_intersected()

        def render():
            v = map_impact_parameters(m, x, A, B)
            return pf(m, tracer(x.expand_as(v), v, SPAN), SPAN[1])

        res["render"][name] = _median_s(torch, render)

    m = KerrMetric(1.0, 0.998, dtype=f32, device=dev)
    x70 = torch.tensor([0.0, 1000.0, math.radians(70.0), 0.0], dtype=f32, device=dev)
    tracer = CudaTracer(m, geometry=ThinDisc(0.0, math.inf, dtype=f32, device=dev))
    plane = PolarPlane(GeometricGrid(), Nr=1000, Ntheta=1000, r_max=50.0, dtype=f32, device=dev)
    bins = torch.linspace(0.1, 1.4, 200, dtype=f32, device=dev)
    pf = redshift_pointfunction(m, x70)
    isco = float(m.isco())

    def binned():
        alpha, beta = plane.impact_parameters()
        v = map_impact_parameters(m, x70, alpha, beta)
        gp = tracer(x70.expand_as(v), v, (0.0, 2000.0))
        return binned_flux(
            m, gp, plane.unnormalized_areas(), lambda r: r**-3.0, bins,
            min_re=isco, max_re=200.0, lam_max=2000.0, redshift_pf=pf,
        )

    res["binned_s"] = _median_s(torch, binned)
    x60 = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=f32, device=dev)
    ctf_bins = torch.linspace(0.1, 1.5, 180, dtype=f32, device=dev)
    d_inf = ThinDisc(0.0, math.inf, dtype=f32, device=dev)

    def ctf():
        return lineprofile(m, x60, d_inf, bins=ctf_bins, num_re=100, N=80, backend="cuda")[1]

    res["ctf_s"] = _median_s(torch, ctf)
    flux = ctf().double()
    res["ctf_m1"] = float((flux * ctf_bins.double()).sum() / flux.sum())
    print(json.dumps(res), flush=True)


def _device_kernels(torch, fn):
    """Device time of one call of ``fn`` (torch.profiler, device activity
    only): total ms, kernel count and the five longest kernels by name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    for e in events:
        by_name[e.name()[:80]] = by_name.get(e.name()[:80], 0) + e.duration_ns() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"ms": sum(by_name.values()), "events": len(events), "top_ms": top}


def interleave(roots):
    """Time the renders of ROOT_A's package with each ROOT's kernel library
    in turn (see the module docstring); the libraries are built already."""
    import ctypes

    import torch

    from gradus_tpu_torch import _build
    from gradus_tpu_torch.camera import ConstPointFunctions, map_impact_parameters
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer

    libs = []
    for root in roots:
        build = os.path.join(root, "build", "gradus_tpu_torch")
        paths = [os.path.join(build, f) for f in os.listdir(build) if f.endswith(".so")]
        if len(paths) != 1:
            raise RuntimeError(f"{root}: expected one built kernel library, found {paths}")
        lib = ctypes.CDLL(paths[0])
        _build._declare(lib)
        libs.append(lib)
    A, B, x, disc, metrics = _flagship(torch, torch.device("cuda", 0))
    res = {root: {} for root in roots}
    for name, m in metrics:
        tracer = CudaTracer(m, geometry=disc)
        pf = ConstPointFunctions.redshift(m, x) @ ConstPointFunctions.filter_intersected()

        def render():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = map_impact_parameters(m, x, A, B)
            y0 = tracer._constrain(x.expand_as(v), v)
            ev[0].record()
            out = tracer._integrate(y0, SPAN)
            ev[1].record()
            pf(m, tracer._finish(out, y0, SPAN[0]), SPAN[1])
            ev[2].record()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

        v = map_impact_parameters(m, x, A, B)
        y0 = tracer._constrain(x.expand_as(v), v)
        outs = []
        for k in (0, 1):
            _build._lib = libs[k]
            render()
            outs.append(tracer._integrate(y0, SPAN))
        (a, b), ya = outs, outs[0]["y"]
        diff = (a["y"] - b["y"]).abs().nan_to_num(nan=math.inf)
        same = (a["y"] == b["y"]) | (a["y"].isnan() & b["y"].isnan())
        res["outputs_" + name] = {
            "status_differs": int((a["status"] != b["status"]).sum()),
            "state_differs": int((~same.all(dim=1)).sum()),
            "state_max_abs_diff": float(diff[~same].max()) if (~same).any() else 0.0,
            "max_abs_phi": [float(o["y"][:, 3].abs().nan_to_num().max()) for o in outs],
            "nonfinite_states": [int((~o["y"].isfinite().all(dim=1)).sum()) for o in outs],
            "rays": int(ya.shape[0]),
            "shading_device": [_device_kernels(torch, lambda o=o: pf(m, tracer._finish(o, y0, SPAN[0]), SPAN[1])) for o in outs],
        }
        for _ in range(5):
            for k in (0, 1, 1, 0):
                _build._lib = libs[k]
                s, kernel_ms, shading_ms = render()
                r = res[roots[k]].setdefault(name, {"s": [], "kernel_ms": [], "shading_ms": []})
                r["s"].append(s)
                r["kernel_ms"].append(kernel_ms)
                r["shading_ms"].append(shading_ms)
    print(json.dumps(res), flush=True)


def _child(root, mode):
    env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), f"--{mode}", root], env=env)


def main(argv):
    if argv and argv[0] in ("--build", "--run"):
        if argv[0] == "--build":
            from gradus_tpu_torch import _build

            _build.load_library()
        elif argv[1] == "--interleave":
            interleave(argv[2:])
        else:
            run(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    roots = argv[1:] if argv[0] == "--interleave" else argv
    builds = [_child(root, "build") for root in dict.fromkeys(roots)]
    if any(p.wait() != 0 for p in builds):
        return 1
    if argv[0] == "--interleave":
        env = {**os.environ, "PYTHONPATH": os.path.abspath(roots[0])}
        cmd = [sys.executable, os.path.abspath(__file__), "--run", "--interleave", *map(os.path.abspath, roots)]
        return subprocess.run(cmd, env=env).returncode
    for root in argv:
        if _child(root, "run").wait() != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
