"""Time the lockstep solver's loop on the card with and without its CUDA
graph, in one process, and check that both give the same bits.

Parts (``--parts``, comma-separated; all by default):

- ``trace``: `trace_geodesics` on 8,192 flagship rays (Kerr a = 0.998,
  r = 1000, i = 75°, ThinDisc(0, 50), λ ≤ 2200), f64 and f32;
- ``jvp1``: the one-ray forward-mode trace of `continuum_time` at r = 10⁴
  (Gradus.jl's reverberation smoke test, f64): the first trace of its
  Newton, at the cold start;
- ``jvp_ctf``: one forward-mode trace of the transfer functions' sweep at
  `bench_ctf`'s configuration (f32, a = 0.998, i = 60°, r = 1000,
  DatumPlane(0), 100 radii × 80 angles, from the flat-space ellipse);
- ``ctf_small``: `transferfunctions` with the default (``xla``) backend at
  `bench_ctf`'s configuration cut to ``--num-re`` radii, captured only:
  forward-mode traces, iterations and seconds;
- ``render``: `rendergeodesics`' trace at 1024² (f32, the flagship camera),
  with the card's peak memory.

``--jvp plain`` runs the loop's forward mode with plain `torch.func.jvp`
in place of the lifted jvp of `utils/jvp.py` (the same bits; it launches
other kernels for the tangents of constants). ``--n-extrema`` sets
``ctf_small``'s golden-section steps.

Each part prints one JSON line: seconds, lockstep iterations, ms an
iteration and the busy share (over the iterations from 256 to 320, where
the loop runs that long) with and without the graph, the captures' host
seconds and reserved bytes. Prints the card's name and power limit first.

    python scripts/torch_lockstep_graph_probe.py [--parts trace,jvp1] [--num-re 4]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gradus_tpu_torch.camera import map_impact_parameters, prerendergeodesics  # noqa: E402
from gradus_tpu_torch.corona import LampPostModel  # noqa: E402
from gradus_tpu_torch.geometry import DatumPlane, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import cuda_graphs, solver, trace_geodesics  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.transfer import transferfunctions  # noqa: E402
from gradus_tpu_torch.transfer.solvers import _make_trace_to_disc  # noqa: E402

SPAN = (0.0, 2200.0)


class LoopWatch:
    """Observes the lockstep loops run while entered (`solver.observe_loops`):
    counts loops, those carrying a tangent, iterations, captures and their
    host seconds and reserved bytes; with ``busy``, profiles the card over
    the iterations [start, start + window) of each loop."""

    def __init__(self, busy=True, start=256, window=64):
        self.busy, self.start, self.window = busy, start, window
        self.loops = self.tangent_loops = self.iterations = self.captures = self.capture_reserved_bytes = 0
        self.capture_seconds = self.busy_ms = self.wall_ms = 0.0
        self._prof = None

    def __call__(self, event, **info):
        if event == "loop":
            self.loops += 1
            self.tangent_loops += info["tangent"]
        elif event == "capture":
            self.captures += 1
            self.capture_seconds += info["seconds"]
            self.capture_reserved_bytes += info["reserved_bytes"]
        elif event == "end":
            self.iterations += info["iterations"]
        if self.busy and event in ("block", "end"):
            self._window(info["iterations"])

    def _window(self, iters):
        if iters == self.start and self._prof is None:
            torch.cuda.synchronize()
            self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        elif iters >= self.start + self.window and self._prof is not None:
            torch.cuda.synchronize()
            self.wall_ms += (time.perf_counter() - self._t0) * 1e3
            self._prof.__exit__(None, None, None)
            cuda = torch.autograd.DeviceType.CUDA
            events = [e for e in self._prof.profiler.kineto_results.events() if e.device_type() == cuda]
            self.busy_ms += sum(e.duration_ns() for e in events) / 1e6
            self._prof = None

    def __enter__(self):
        self._observing = solver.observe_loops(self)
        self._observing.__enter__()
        return self

    def __exit__(self, *exc):
        self._observing.__exit__(*exc)
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof = None

    def share(self):
        return self.busy_ms / self.wall_ms if self.wall_ms else None


def measure(fn, graphs=True, busy=True):
    """(fn()'s output, its record): seconds to a synchronize, lockstep loops
    and iterations, ms an iteration, busy share, capture seconds and bytes,
    the card's peak allocated bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with cuda_graphs(graphs), LoopWatch(busy) as st:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = dict(
        graphs=graphs,
        seconds=seconds,
        loops=st.loops,
        tangent_loops=st.tangent_loops,
        iterations=st.iterations,
        ms_per_iteration=seconds * 1e3 / max(st.iterations, 1),
        busy_share=st.share() if busy else None,
        captures=st.captures,
        capture_seconds=st.capture_seconds,
        capture_reserved_bytes=st.capture_reserved_bytes,
        peak_allocated_bytes=torch.cuda.max_memory_allocated(),
    )
    return out, rec


def _same(a, b, fields=("status", "x", "v", "lam_max")):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def part_trace(dev):
    out = {}
    rng = np.random.default_rng(30)
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
        x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=dtype, device=dev)
        d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev)
        A = torch.as_tensor(rng.uniform(-28, 28, 8192), dtype=dtype, device=dev)
        B = torch.as_tensor(rng.uniform(-18, 18, 8192), dtype=dtype, device=dev)
        v = map_impact_parameters(m, x, A, B)

        def trace():
            return trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d)

        trace_geodesics(m, x.expand_as(v[:64]), v[:64], SPAN, geometry=d)  # warm-up
        got, with_graph = measure(trace, True)
        want, without = measure(trace, False)
        out[name] = dict(rays=8192, bit_equal=_same(got, want), with_graph=with_graph, without_graph=without)
    return out


def _continuum_trace(dev):
    """The first forward-mode trace of `continuum_time`'s Newton at r = 10⁴."""
    kw = dict(dtype=torch.float64, device=dev)
    m = KerrMetric(1.0, 0.998, device=dev)
    x = torch.tensor([0.0, 1e4, math.radians(45.0), 0.0], **kw)
    x_src, _ = LampPostModel().sample_position_velocity(m)
    x_src = x_src.to(torch.float64)
    z_src = x_src[1] * torch.cos(x_src[2])
    rho_src = torch.maximum(x_src[1] * torch.sin(x_src[2]), 1e-3 * x_src[1]).reshape(1)
    plane = DatumPlane(z_src, device=dev)
    th = torch.full((1,), math.pi / 2, **kw)
    trace = _make_trace_to_disc(m, x, plane, 2.0 * x[1], th, 0.0, 0.0, 1e-2, {})
    r0 = torch.clamp(rho_src, min=20.0)
    return lambda: trace(r0, torch.ones_like(r0))


def part_jvp1(dev):
    fn = _continuum_trace(dev)
    (gp, gd), with_graph = measure(fn, True)
    (gp2, gd2), without = measure(fn, False)
    return dict(rays=1, bit_equal=_same(gp, gp2) and _same(gd, gd2), with_graph=with_graph, without_graph=without)


def _ctf_setup(dev):
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=dtype, device=dev)
    return m, x, dtype


def part_jvp_ctf(dev):
    from gradus_tpu_torch.camera.grids import InverseGrid
    from gradus_tpu_torch.transfer.cunningham import _avoid_poles, _theta_samples

    m, x, dtype = _ctf_setup(dev)
    radii = InverseGrid()(float(m.isco()) + 1e-2, 50.0, 100, dtype=dtype, device=dev)
    th = _theta_samples(80, 0.3, dtype=dtype, device=dev)
    TH, RE = th[None, :].expand(100, 80).reshape(-1), radii[:, None].expand(100, 80).reshape(-1)
    cos_i = torch.cos(x[2])
    sin2 = torch.sin(TH) ** 2
    r0 = RE * torch.abs(cos_i) / torch.sqrt(cos_i**2 * (1.0 - sin2) + sin2) + 1.0 + torch.sin(x[2]) * torch.clamp(
        torch.sin(TH), min=0.0
    )
    trace = _make_trace_to_disc(m, x, DatumPlane(0.0, dtype=dtype, device=dev), 2.0 * x[1], _avoid_poles(TH), 0.0, 0.0, 1e-2, {})
    (gp, gd), with_graph = measure(lambda: trace(r0, torch.ones_like(r0)), True)
    (gp2, gd2), without = measure(lambda: trace(r0, torch.ones_like(r0)), False)
    return dict(
        rays=int(r0.numel()), bit_equal=_same(gp, gp2) and _same(gd, gd2), with_graph=with_graph, without_graph=without
    )


def part_ctf_small(dev, num_re, n_extrema):
    m, x, dtype = _ctf_setup(dev)
    d = ThinDisc(0.0, math.inf, dtype=dtype, device=dev)
    grid, with_graph = measure(
        lambda: transferfunctions(m, x, d, num_re=num_re, N=80, N_extrema=n_extrema), True, busy=False
    )
    return dict(
        num_re=num_re, angles=80, n_extrema=n_extrema, finite=bool(torch.isfinite(grid.upper_f).all()),
        tangent_loops=with_graph.pop("tangent_loops"), with_graph=with_graph,
    )


def part_render(dev):
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=dtype, device=dev)
    d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev)
    kw = dict(image_width=1024, image_height=1024, alpha_lims=(-28.0, 28.0), beta_lims=(-18.0, 18.0))
    (_, _, got), with_graph = measure(lambda: prerendergeodesics(m, x, d, SPAN[1], **kw), True)
    (_, _, want), without = measure(lambda: prerendergeodesics(m, x, d, SPAN[1], **kw), False)
    return dict(
        pixels=1024 * 1024, bit_equal=_same(got.points, want.points), with_graph=with_graph, without_graph=without
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="trace,jvp1,jvp_ctf,ctf_small,render")
    ap.add_argument("--num-re", type=int, default=4)
    ap.add_argument("--n-extrema", type=int, default=15)
    ap.add_argument("--jvp", choices=("lifted", "plain"), default="lifted")
    args = ap.parse_args()
    if args.jvp == "plain":
        solver.jvp = torch.func.jvp
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(
        subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip(),
        flush=True,
    )
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for part in args.parts.split(","):
        t0 = time.perf_counter()
        if part == "ctf_small":
            rec = part_ctf_small(dev, args.num_re, args.n_extrema)
        else:
            rec = globals()[f"part_{part}"](dev)
        print(json.dumps(dict(part=part, jvp=args.jvp, part_seconds=time.perf_counter() - t0, **rec)), flush=True)


if __name__ == "__main__":
    main()
