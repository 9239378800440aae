"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

First, while the port's CUDA kernel builds in a process of its own (the
host's cores), the AD half runs alone on the card, launching no kernel:
`adjoint_render` (∂⟨g⟩/∂(a, i) of the 1024² flagship render in f64 through
`fwd_adjoint`, the two parameter tangents carried through one captured
lockstep loop; the gradient against the pixel Jacobian's contraction and,
on every 8th pixel each way, against central differences) and
`checkpointed_adjoint` (`torch.autograd.grad` of tests/test_checkpointed_adjoint.py's
loss with respect to 128 spline heights over 128² rays, through the
checkpointed ladder whose forward and backward replay captured graphs;
against central differences, and beside the uncheckpointed backward).

Then it loads the port's CUDA kernel, built from `gradus_tpu_torch/csrc/`, and holds it against
its plain PyTorch version on the card (f64 and f32; flagship rays against a
ThinDisc, rays without geometry, transfer-function rays against a
DatumPlane, every metric of the port, and the kernel's modes: sampled
events, capped and resumed passes, crossing counters, timelike rays, and
the Newton polish of the hits in the kernel against `_polish_hits`),
reproduces the two render goldens through it, then runs the port's products
through their entry points, none of which may call the plain-torch polish:

- the flagship render at full size: 1024² rays, f32, Kerr a=0.998, observer
  at r=1000 and i=75°, ThinDisc(0, 50), λ ∈ (0, 2200), analytic Kerr
  redshift; once more with a capped pass and a resumed tail pass, which
  must give the same image;
- the same camera in Johannsen-Psaltis (a=0.6, ε₃=2) and in Kerr-Newman
  (a=0.5, Q=0.3), through the kernel's dual-number path and the
  dot-product redshift with the generic ISCO; against
  ShakuraSunyaev.from_metric(m, 0.3) (`thick_geometries_render`, the
  kernel's generic instantiation) and against the docs'
  WarpedThinDisc(lambda r: 2 sin(r/10), 0, 100) (`callable_geometries_render`:
  its cross-section compiled into a unit that `phase_build` builds with the
  library); the other geometries, the callable ones among them
  (`callable_geometries`: the warped disc, ShakuraSunyaev's cross-section as
  a ThickDisc, both precessed or in a composite, and a precessed
  DatumPlane), against the plain version in the worker `plain`;
- the flagship render's longest chain of steps: its slowest ray launched
  alone, and the kernel's static SASS counts;
- the Gradus.jl line-profile edge goldens (Kerr a=0.6, i=60°), f64, through
  `lineprofile(..., backend="cuda")`;
- the transfer-function line profile at full size (`bench.py::bench_ctf`'s
  configuration: f32, a=0.998, i=60°, 100 radii × 80 angles), with its first
  moment against the JAX package's f64 CPU value;
- the binned line profile at full size (`bench.py::bench_binning`'s
  configuration: a 1000×1000 polar plane, f32, i=70°), and once more at the
  transfer-function profile's configuration to compare the two methods;
- the public entry points over the lockstep solver (`trace_geodesics`, plain
  torch on the card, which launches no kernel, its loop replayed as a CUDA
  graph): `trace_api` holds `trace_geodesics` against `CudaTracer` on 8,192
  flagship rays in f64 and f32 and a forward-mode derivative through it
  (`trace_geodesics(..., v_dot=...)`) against a central difference; `render_api` runs the render goldens and the 1024² flagship
  redshift render through `rendergeodesics`; `binning_api` runs
  `lineprofile(..., method=BinningMethod())` at `bench_binning`'s
  configuration and at the transfer-function profile's;
- the lamp-post corona and the reverberation lags, f64, through their entry
  points (plain torch on the card, the transfer functions through the
  kernel): `emissivity` (the δ sweep and the Monte-Carlo profile),
  `reverberation_golden` (Gradus.jl's reverberation smoke test),
  `lag_frequency_full` (the lag spectrum at its defaults, timed by part),
  `binflux_golden` (Gradus.jl's test-2d.jl, then `lagtransfer` at its
  defaults), `lagtransfer_semianalytic` and `profiled_lineprofile` (the
  lamp-post line profile by both methods);
- the lockstep loop as a CUDA graph (every lockstep phase above runs
  captured, and fails if a loop did not): `lockstep_graph` holds the
  captured loop against the uncaptured one (`cuda_graphs(False)`) bit for
  bit on 8,192 flagship rays in f64 and f32 and on the one-ray
  forward-mode trace of `continuum_time` at r = 10⁴, and on the dense trace
  and its tangent of the ring's target polish;
- the extended coronae, f64: `ring_corona` (`lag_frequency` of a
  RingCorona(r=3, h=4) at its defaults with `backend="cuda"`: the
  near-field hybrid profile, the continuum time by the target search, the
  transfer functions on the kernel, the time-dependent integration; timed
  by part, the kernel counted in that run, the integration held to the
  same one on the CPU) and `disc_corona` (a DiscCorona(r=10, h=4)'s default
  profile, 51,200 rays in one trace, and the reference's disc lag
  physics), their profiles and t₀ held to the JAX package's CPU values
  (tests/data/extended_corona_reference.json), and the JAX package's sky
  cells traced on the card against the port's values from them on the CPU
  (tests/data/extended_corona_sky_cells.npz);
- the `xla` transfer functions (the jvp Newton through the lockstep
  solver, the default backend) at full size: `ctf_xla` (`bench_ctf`'s thin
  disc: m1, and against the `cuda` backend) and `thick_disc` (a
  `ShakuraSunyaev` disc against `lineprofile(method=BinningMethod())`),
  at 5 and 4 golden-section steps, not 15 and 10, so that the script ends
  inside its time limit,
  and `thick_disc_golden` (tests/test_transfer.py's thick-disc golden in
  f64, its samples against the JAX package's and the port's CPU runs);
- the special traces on the lockstep solver, each at full size on the
  card with its loops captured and a subset of 512 rays held against the
  same call on CPU tensors (`TRACES`, alone on the card after the
  kernel-timed phases; their CPU subsets in the worker `traces_cpu`):
  `charged` (65,536 charged particles on Kerr-Newman's charged circular
  orbits, f64, and `solve_equatorial_circular_orbit` at 64 radii),
  `shaped_chart` (`event_horizon_chart` as the inner chart at 1024², Kerr
  against the scalar chart and Johannsen-Psaltis), `first_order` (the
  Mino-time tracer against the second-order one at 1024², f64), `windings`
  and `radiative_transfer` (1024²; the charged and radiative-transfer
  loops also held captured against uncaptured bit for bit) and `mesh` (a
  triangulated annulus at 128² against the thin disc, and in f32 on
  every 4th of those pixels), in f64 but
  Johannsen-Psaltis and the mesh's f32 trace (each phase's docstring says
  why not f32).
The phases from the lags on (but the special traces' card work), with
`kernel_vs_plain` and `trace_api`, run in worker processes (`WORKERS`)
beside the main one's `render_api` and `binning_api`, after the phases
that time kernels and the special traces' card work. (The workers share the card: captured loops from two
processes take turns on it.)

Every phase prints one line; any failure raises, so the exit code is
non-zero. The last line is a JSON object with the device.

    python3 chip_smoke.py

A worker's phases alone (a name of `WORKERS`, or `traces` for `TRACES`):
`python3 chip_smoke.py --worker NAME OUT.json`.

Needs one CUDA device and the CUDA toolkit (nvcc). Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from gradus_tpu_torch import _build
from gradus_tpu_torch.camera import (
    ConstPointFunctions,
    GeometricGrid,
    InverseGrid,
    LinearGrid,
    PolarPlane,
    apply,
    map_impact_parameters,
    prerendergeodesics,
    rendergeodesics,
)
from gradus_tpu_torch.camera.render import _pixel_velocities
from gradus_tpu_torch.geometry import (
    AbstractThickAccretionDisc,
    CompositeGeometry,
    DatumPlane,
    EllipticalDisc,
    MeshAccretionGeometry,
    PolishDoughnut,
    PrecessingDisc,
    ShakuraSunyaev,
    ThickDisc,
    ThinDisc,
    WarpedThinDisc,
)
from gradus_tpu_torch.integrate import StatusCodes, cuda_solver
from gradus_tpu_torch.integrate.cuda_solver import (
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.integrate import cuda_graphs
from gradus_tpu_torch.integrate import solver as lockstep_solver
from gradus_tpu_torch.integrate.solver import _Problem
from gradus_tpu_torch.integrate.tracing import (
    PoloidalShape,
    event_horizon_chart,
    make_geodesic_rhs,
    trace_geodesics,
    trace_radiative_transfer,
    trace_windings,
)
from gradus_tpu_torch.utils.jvp import jvp as lifted_jvp
from gradus_tpu_torch import metrics
from gradus_tpu_torch.lineprofile import BinningMethod, TransferFunctionMethod, binned_flux, lineprofile
from gradus_tpu_torch.metrics import (
    JohannsenMetric,
    JohannsenPsaltisMetric,
    KerrMetric,
    KerrNewmanMetric,
    trace_geodesics_first_order,
)
from gradus_tpu_torch.orbits import CircularOrbits, charged_circular_orbit_omega, solve_equatorial_circular_orbit
from gradus_tpu_torch.corona import (
    BothHemispheres,
    DiscCorona,
    EvenSampler,
    LampPostModel,
    NearFieldBlendedProfile,
    PowerLawSpectrum,
    RingCorona,
    emissivity_profile,
)
from gradus_tpu_torch.interop import near_field_profile_from_numpy, transfer_grid_from_numpy
from gradus_tpu_torch.redshift import redshift_pointfunction
from gradus_tpu_torch.reverberation import binflux, continuum_time, lag_frequency, lagtransfer
from gradus_tpu_torch.transfer import (
    cunningham_transfer_function,
    integrate_lagtransfer,
    integrate_lagtransfer_timedep,
    transferfunctions,
)
from gradus_tpu_torch.transfer.solvers import _make_trace_to_disc
from gradus_tpu_torch.utils import equatorial_project
from gradus_tpu_torch.utils.interp import linear_interp

# the modules, which the package's functions of the same names shadow
lineprofile_module = importlib.import_module("gradus_tpu_torch.lineprofile")
emissivity = importlib.import_module("gradus_tpu_torch.corona.emissivity")
reverberation = importlib.import_module("gradus_tpu_torch.reverberation")
extended_module = importlib.import_module("gradus_tpu_torch.corona.extended")
adaptive_module = importlib.import_module("gradus_tpu_torch.corona.adaptive")
targets_module = importlib.import_module("gradus_tpu_torch.transfer.targets")

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
# roots and transcendental calls, one each) per ray start, per attempted step
# and per hit it polishes (3 Newton iterations), counted by running
# its C++ on a CPU with a counting scalar over 512 rays of each
# configuration: `python -m gradus_tpu_torch.opcount` (the flagship camera
# against the generic geometries' cases and the callable ones as
# `kerr_<case>`).
KERNEL_OPS = {
    "kerr": (427.0, 1431.2514095377364, 4351.0),
    "johannsen_psaltis": (675.0, 2175.2740566503276, 6831.0),
    "kerr_newman": (559.0, 1827.2608574427607, 5671.0),
    "kerr_datum_plane": (428.0, 1431.9918712674187, 4354.0),
    "kerr_shakura_sunyaev": (447.0, 1452.4608245197498, 4411.0),
    "kerr_shakura_sunyaev_sampled": (447.0, 1813.5959421541115, 4411.0),
    "kerr_elliptical": (442.0, 1449.7060856908943, 4396.0),
    "kerr_precessing_elliptical": (506.0, 1513.6654835458567, 4588.0),
    "kerr_precessing_thin": (491.0, 1495.7654253598578, 4543.0),
    "kerr_composite": (435.0, 1441.1087017186755, 4375.0),
    "kerr_doughnut": (1257.0, 2290.3580878681973, 6841.0),
    "kerr_doughnut_kerr": (2323.0, 3386.693584623065, 10039.0),
    "kerr_warped": (443.0, 1448.1206381883685, 4399.0),
    "kerr_thick_shakura_sunyaev": (449.0, 1454.4562918195554, 4417.0),
    "kerr_precessing_warped": (507.0, 1512.227447636084, 4591.0),
    "kerr_composite_callable": (447.0, 1453.8120760557824, 4411.0),
    "kerr_precessing_datum": (492.0, 1496.86964026354, 4546.0),
}
# NVIDIA H100 SXM data sheet, at its 700 W limit: FP32 and FP64 outside the
# tensor cores, and HBM3
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_PER_S = 3.35e12


def _bound(metric, rays, attempts, hits, dtype):
    """(the least milliseconds the card could take for the kernel's work on
    these rays, what bounds it): the larger of the operations (per ray
    start, per attempted step and per polished hit, `KERNEL_OPS`) over the
    peak rate and the bytes it must move (8 state values in; 22 values and
    5 int32 out per ray) over the memory rate."""
    per_start, per_step, per_hit = KERNEL_OPS[metric]
    ops_ms = (rays * per_start + attempts * per_step + hits * per_hit) / PEAK_OPS[dtype] * 1e3
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


def _hits(out):
    return int((out["status"] == HIT).sum())


class _PolishCounter:
    """Counts the calls of the plain-torch polish, `_polish_hits`, while it
    is entered: the port's CUDA paths polish in the kernel and must make
    none."""

    def __enter__(self):
        self.calls, self._fn = 0, cuda_solver._polish_hits

        def counting(*args, **kw):
            self.calls += 1
            return self._fn(*args, **kw)

        cuda_solver._polish_hits = counting
        return self

    def __exit__(self, *exc):
        cuda_solver._polish_hits = self._fn


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


def phase_build(dev=None):
    """The library and the generated units of the callable phases
    (`_callable_units`), their nvcc runs started together."""
    units = [] if dev is None else _callable_units()
    _build.load_library(units)
    info = _build.build_info()
    ptxas = [
        line.strip()
        for line in info["ptxas"].splitlines()
        if "Compiling entry" in line or "spill" in line or "Used" in line
    ]
    _say(
        "build",
        seconds=info["seconds"],
        built=info["built"],
        path=info["path"],
        ptxas=ptxas,
        callables={k: {f: c.get(f) for f in ("entry", "built", "seconds", "registers", "spills")} for k, c in info["callables"].items()},
    )


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


def _polish_epilogue(dev, n=2048):
    """The kernel's polish of its hits (each hit ray's epilogue: its last
    loop iterations) against its plain version, `_polish_hits`, on the same
    carry, f64 and f32: the kernel with ``newton_iters=3`` against
    the torch polish of its own ``newton_iters=0`` outputs, for Kerr against
    ThinDisc(0, 50) and DatumPlane(0), Johannsen-Psaltis (dual numbers) and
    sampled events. Every output but a hit's y and λ is the same bit for
    bit; the polished hits agree relative to max(1, |value|): the position
    and λ within 1e-6 in both precisions, the velocity within 1e-6 in f64
    and 3e-5 in f32, where the two right-hand sides round differently (the
    kernel's FMA contractions) and its components, sums that cancel, differ
    by up to 1.3e-5 on the DatumPlane rays. Also prints the kernel's largest
    |indicator| at its polished hits."""
    rng = np.random.default_rng(29)
    alpha, beta = rng.uniform(-28.0, 28.0, n), rng.uniform(-18.0, 18.0, n)
    rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
    out = {}
    for case in ("kerr_thin_disc", "kerr_datum_plane", "johannsen_psaltis", "sampled"):
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            x_obs, A, B, span, tkw = X_OBS, alpha, beta, SPAN, {}
            if case == "johannsen_psaltis":
                m = JohannsenPsaltisMetric(**JP, dtype=dtype, device=dev)
            else:
                m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
            if case == "kerr_datum_plane":
                d = DatumPlane(0.0, dtype=dtype, device=dev)
                x_obs, A, B, span = CTF_X_OBS, rho * np.cos(th), rho * np.sin(th), (0.0, 2000.0)
                tkw = dict(chart_outer=2000.0)
            else:
                d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev)
            if case == "sampled":
                tkw = dict(event_method="sampled")
            tracer = CudaTracer(m, geometry=d, **tkw)
            x = torch.tensor(x_obs, dtype=dtype, device=dev)
            y0 = _constrained(
                tracer, m, x, torch.as_tensor(A, dtype=dtype, device=dev), torch.as_tensor(B, dtype=dtype, device=dev)
            )
            kw = tracer._integrate_kwargs(dtype)
            raw0 = cuda_integrate_rays(m, y0, span, **{**kw, "newton_iters": 0})
            raw = cuda_integrate_rays(m, y0, span, **kw)
            problem = _Problem(
                f=make_geodesic_rhs(m),
                crossing_fn=lambda ys, d=d: d.crossing_indicator(ys[..., 0:4]),
                newton_iters=kw["newton_iters"],
            )
            y_p, lam_p = cuda_solver._polish_hits(problem, raw0, raw0["y"], raw0["lam"])
            torch.cuda.synchronize()
            hit = raw["status"] == HIT
            same = all(torch.equal(raw0[k], raw[k]) for k in cuda_solver._OUTPUT_KEYS if k not in ("y", "lam"))
            same = same and torch.equal(raw0["y"][~hit], raw["y"][~hit]) and torch.equal(raw0["lam"][~hit], raw["lam"][~hit])
            ends_k = torch.cat([raw["y"][hit], raw["lam"][hit, None]], dim=-1)
            ends_p = torch.cat([y_p[hit], lam_p[hit, None]], dim=-1)
            rel = (ends_k - ends_p).abs() / ends_p.abs().clamp(min=1.0)
            res = dict(
                rays=n,
                hits=int(hit.sum()),
                other_outputs_identical=bool(same),
                hit_max_rel_err=float(rel.max()),
                hit_max_rel_err_t_r_th_ph_v_lam=rel.amax(dim=0).tolist(),
                kernel_indicator_max=float(d.crossing_indicator(raw["y"][hit, 0:4]).abs().max()),
            )
            v_rtol = 1e-6 if dtype == torch.float64 else 3e-5
            pos_lam = float(rel[:, [0, 1, 2, 3, 8]].max())
            if not same or res["hits"] < n // 10 or pos_lam > 1e-6 or float(rel[:, 4:8].max()) > v_rtol:
                raise AssertionError(f"polish epilogue {case} {name} disagrees with _polish_hits: {res}")
            out[f"{case}_{name}"] = res
    return out


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
    n_polish=2048,
):
    """The kernel and its plain version on the same card tensors, each
    polishing its hits: flagship rays with the disc, rays without one,
    transfer-function rays against a DatumPlane, the deformed metrics and
    the other metrics; the kernel's dual-number
    path against its hand-derived Kerr path; then the kernel's modes:
    sampled events, the tail pass, crossing counters and timelike rays; and
    the kernel's polish against the plain polish on the same carry."""
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
        polish_epilogue=_polish_epilogue(dev, n_polish),
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


def _full_render(dev, m, side, name, ops_key, subset=True, geometry=None, range_rho_min=None, **tracer_kw):
    """A side² render, f32, at the flagship camera (r = 1000, i = 75°,
    ThinDisc(0, 50) unless ``geometry`` is given, λ ∈ (0, 2200)) through
    the port's entry points, with
    the metric's redshift point function, whose finite values must lie in
    (0, 2) (with ``range_rho_min``, those of hits at ρ ≥ it; the others
    outside are counted); one warm-up and three timed
    renders, one kernel launch each (two with a tail pass, ``tracer_kw``'s
    ``segment_iters``), none of which may call the plain-torch polish; then
    one render split by CUDA events into camera + constraint, the kernel
    with its polish, and unpack + shading. With ``subset``, every 64th
    pixel is held against the plain version on the card. Returns (the
    printed result, the last render's GeodesicPoint)."""
    dtype = torch.float32
    n = side * side
    d = ThinDisc(0.0, 50.0, dtype=dtype, device=dev) if geometry is None else geometry
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
    with _PolishCounter() as polish:
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
    if polish.calls != 0:
        raise AssertionError(f"{name}: the renders called the plain-torch polish {polish.calls} times")
    if int(aux["unfinished"]) != 0:
        raise AssertionError(f"{name}: {int(aux['unfinished'])} rays unfinished")
    finite = torch.isfinite(img)
    g = img[finite]
    held = finite
    if range_rho_min is not None:
        held = finite & (equatorial_project(last["gp"].x) >= range_rho_min)
    out_of_range = finite & ~((img > 0) & (img < 2))
    if finite.sum() == 0 or bool((out_of_range & held).any()) or float(g.max()) <= 1.0:
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
        g_out_of_range_below_rho_min=int(out_of_range.sum()),
        launches=launches,
        torch_polish_calls=polish.calls,
        unfinished=int(aux["unfinished"]),
        executed_lane_steps=executed,
        attempted_lane_steps=attempted,
        useful_ray_steps=useful,
        wasted_step_fraction=1.0 - useful / max(executed, 1),
        dead_lane_share=(executed - attempted) / max(executed, 1),
    )

    # one more render, split on the card's timeline
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    v = map_impact_parameters(m, x, *_pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev))
    y0_split = tracer._constrain(x.expand_as(v), v)
    ev[1].record()
    out_split = tracer._integrate(y0_split, SPAN)
    ev[2].record()
    pf(m, tracer._finish(out_split, y0_split, SPAN[0]), SPAN[1])
    ev[3].record()
    torch.cuda.synchronize()
    result["split_ms"] = dict(
        zip(
            ("camera_constraint", "kernel_with_polish", "unpack_shading"),
            (ev[k].elapsed_time(ev[k + 1]) for k in range(3)),
        )
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
        kernel_ms = []
        for _ in range(3):
            out_k, ms = _timed(lambda: cuda_integrate_rays(m, y0, SPAN, **kw))
            kernel_ms.append(ms)
        result.update(
            subset_rays=int(idx.numel()),
            subset_hit_mask_agree=mask_agree,
            subset_g_median_rel=g_rel,
            subset_kernel_ms=statistics.median(kernel_ms),
            subset_plain_ms=plain_ms,
            subset_attempted_lane_steps=int(out_k["attempts"].sum()),
            subset_hits=_hits(out_k),
        )
    # the kernel alone (both passes and the compaction, with a tail pass) on
    # every ray of the render; and its single pass without the polish
    y0_full = _constrained(tracer, m, x, A, B)
    tracer._integrate(y0_full, SPAN)  # warm-up: the allocator's blocks for 1024² outputs
    out_full, full_ms = _timed(lambda: tracer._integrate(y0_full, SPAN))
    full_hits = _hits(out_full)
    full_bound_ms, _ = _bound(ops_key, n, int(out_full["attempts"].sum()), full_hits, dtype)
    _, no_polish_ms = _timed(lambda: cuda_integrate_rays(m, y0_full, SPAN, **{**kw, "newton_iters": 0}))
    result.update(
        full_kernel_ms=full_ms,
        full_hits=full_hits,
        full_bound_ms=full_bound_ms,
        full_bound_share=full_bound_ms / full_ms,
        full_kernel_ms_single_pass_without_polish=no_polish_ms,
    )
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


def phase_thick_geometries_render(dev, side=1024):
    """The flagship render (f32, Kerr a = 0.998, analytic redshift) against
    ``ShakuraSunyaev.from_metric(m, 0.3)`` through the kernel's generic
    instantiation (`_full_render`: the render's time, finite pixels,
    attempted lane-steps, the kernel's time and bound, every 64th pixel
    against the plain version)."""
    m = KerrMetric(1.0, 0.998, dtype=torch.float32, device=dev)
    geometry = ShakuraSunyaev.from_metric(m, 0.3)
    return _full_render(dev, m, side, "thick_geometries_render", "kerr_shakura_sunyaev", geometry=geometry)[0]


# --- the generic geometries (csrc/geometry.cuh) against the plain version --------

# The cases of `phase_thick_geometries`, as the docs build them
# (docs/examples.md, docs/getting-started.md); ShakuraSunyaev also with
# sampled events.
THICK_KINDS = (
    "shakura_sunyaev",
    "elliptical",
    "precessing_elliptical",
    "precessing_thin",
    "composite",
    "doughnut",
    "doughnut_kerr",
)
# The kinds whose traces are held one iteration at a time from the plain
# version's carry (`_stepwise`): where an event or a hit test depends on
# the step sequence, which rounding in the controller's error estimate
# separates (tests/test_torch_kernel_geometries.py), two correct
# implementations' traces differ: the composite's |c| < 1e-6 hit test, and
# the ellipse's (also precessed) events in a step that starts beyond its
# semi-major axis (a NaN slope) or by its rim (a slope that diverges), and
# their unconverged polish.
STEPWISE_KINDS = ("elliptical", "precessing_elliptical", "composite", "composite_callable")
STEPWISE_ITERS = 400
KINDS012_DIGESTS = Path(__file__).resolve().parent / "tests" / "data" / "kernel_kinds012_digests.json"


def _thick_geometry(kind, m, dtype, dev):
    kw = dict(dtype=dtype, device=dev)
    ellipse = EllipticalDisc(0.0, 100.0, 60.0, **kw)
    return {
        "shakura_sunyaev": lambda: ShakuraSunyaev.from_metric(m, 0.3),
        "elliptical": lambda: ellipse,
        "precessing_elliptical": lambda: PrecessingDisc(ellipse, math.radians(10.0), math.radians(30.0), **kw),
        "precessing_thin": lambda: PrecessingDisc(ThinDisc(0.0, 50.0, **kw), math.radians(20.0), math.radians(30.0), **kw),
        "composite": lambda: CompositeGeometry([ThinDisc(20.0, 100.0, **kw), DatumPlane(3.0, **kw)]),
        "doughnut": lambda: PolishDoughnut(**kw),
        "doughnut_kerr": lambda: PolishDoughnut(metric=m),
    }[kind]()


def _full_trace(m, x, tracer, y0, dtype, ops_key):
    """The kernel and its plain version on the same rays, each polishing its
    hits: status agreement, the largest |Δ| of a hit's x and λ, the hits
    past 1e-6, the median relative gap of the redshift of both versions'
    hits, both versions' ms, and the kernel's bound (`KERNEL_OPS[ops_key]`,
    from its attempted steps and hits)."""
    kw = tracer._integrate_kwargs(dtype)
    ok, kernel_ms = _timed(lambda: cuda_integrate_rays(m, y0, SPAN, **kw))
    op, plain_ms = _timed(lambda: integrate_rays_plain(m, y0, SPAN, **kw))
    gk, gp = tracer._finish(ok, y0, SPAN[0]), tracer._finish(op, y0, SPAN[0])
    hit = (gk.status == HIT) & (gp.status == HIT)
    gap = torch.cat([(gk.x[hit] - gp.x[hit]).abs(), (gk.lam_max[hit] - gp.lam_max[hit]).abs()[:, None]], dim=-1).amax(dim=-1)
    pf = ConstPointFunctions.redshift(m, x)
    g_k, g_p = pf(m, gk, SPAN[1])[hit], pf(m, gp, SPAN[1])[hit]
    bound_ms, bound_by = _bound(ops_key, int(y0.shape[0]), int(ok["attempts"].sum()), _hits(ok), dtype)
    return dict(
        rays=int(y0.shape[0]),
        hits=int(hit.sum()),
        status_agree=float((gk.status == gp.status).double().mean()),
        hit_max_abs_err=float(gap.nan_to_num(nan=math.inf).max()) if hit.any() else 0.0,
        hits_past_1e6=int((gap.nan_to_num(nan=math.inf) > 1e-6).sum()),
        g_median_rel=float(_rel(g_k, g_p).nanmedian()) if hit.any() else 0.0,
        kernel_ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
    )


def _stepwise(m, tracer, y0, dtype, max_iters=STEPWISE_ITERS):
    """The trace one loop iteration at a time: from the plain version's carry
    after each iteration, one more iteration of the kernel and of the plain
    version (uncaptured: a carry a call), no polish. Over every ray that
    stepped: the share of identical statuses, step and failure counts; the
    share of identical status codes, counting a step that ends in a hit in
    one version only as alike; those steps and those whose acceptance
    differs; and over the rays that agree the largest relative gap (to max(1, |value|);
    a NaN where the other is not counts as infinite) of the state y and λ,
    and of the event's indicator, slope and θ (in f32 these lose digits by
    the ellipse's rim, where 1 − (r/a)² cancels). Not the next step size:
    its error estimate is rounding far from the hole."""
    kw = {**tracer._integrate_kwargs(dtype), "newton_iters": 0, "iter_cap": 1}
    with cuda_graphs(False):
        out = integrate_rays_plain(m, y0, SPAN, **kw)
    same = codes = hit_flips = step_flips = stepped = 0
    gaps = {part: torch.zeros((), dtype=torch.float64, device=y0.device) for part in ("state", "event")}
    iters = 1
    t0 = time.perf_counter()
    while iters < max_iters and bool(cuda_solver._mid_flight(out, SPAN[1]).any()):
        went = cuda_solver._mid_flight(out, SPAN[1])
        state = {k: out[k] for k in cuda_solver._STATE_KEYS}
        k = cuda_integrate_rays(m, out["y"], SPAN, state=state, **kw)
        with cuda_graphs(False):
            p = integrate_rays_plain(m, out["y"], SPAN, state=state, **kw)
        agree = (k["status"] == p["status"]) & (k["steps"] == p["steps"]) & (k["failed"] == p["failed"])
        flip = went & ((k["status"] == HIT) != (p["status"] == HIT))
        same, stepped = same + (agree & went).sum(), stepped + went.sum()
        codes = codes + (went & ((k["status"] == p["status"]) | flip)).sum()
        hit_flips = hit_flips + flip.sum()
        step_flips = step_flips + (went & (k["steps"] != p["steps"])).sum()
        both = agree & went
        for key in ("y", "lam", "c_prev", "dc_prev", "hit_theta"):
            part = "state" if key in ("y", "lam") else "event"
            a, b = k[key][both].double(), p[key][both].double()
            rel = ((a - b).abs() / b.abs().clamp(min=1.0)).nan_to_num(nan=math.inf)
            rel = torch.where(a.isnan() & b.isnan(), 0.0, rel)
            if rel.numel():
                gaps[part] = torch.maximum(gaps[part], rel.max())
        out, iters = p, iters + 1
    return dict(
        iterations=iters,
        ray_steps=int(stepped),
        status_agree=float(same / max(int(stepped), 1)),
        codes_agree_but_hits=float(codes / max(int(stepped), 1)),
        hit_flips=int(hit_flips),
        step_flips=int(step_flips),
        state_max_rel=float(gaps["state"]),
        event_max_rel=float(gaps["event"]),
        seconds=time.perf_counter() - t0,
    )


def _stepwise_ok(step, dtype):
    """`_stepwise`'s thresholds: f64 statuses, step and failure counts ≥
    0.999 alike, state and event within 1e-9; f32 status codes ≥ 0.995
    alike but for the steps that one version ends in a hit and the other
    does not, and the state within 1e-4. In f32 the composite's |c| < 1e-6
    is below the resolution of c = r cos θ − h (~1e-6 at r ~ 10), and an
    error estimate near 1 decides a step's acceptance, on rounding in any
    trace: those flips are counted."""
    if dtype == torch.float64:
        return step["status_agree"] >= 0.999 and max(step["state_max_rel"], step["event_max_rel"]) <= 1e-9
    return step["codes_agree_but_hits"] >= 0.995 and step["state_max_rel"] <= 1e-4


def _kinds012_outputs(dev):
    """The kernel's outputs for geometry kinds 0-2: Kerr a = 0.998 and
    Johannsen-Psaltis (a = 0.6, ε₃ = 2), 8,192 flagship rays each (seed 5),
    without a geometry, against ThinDisc(0, 50) with cubic and sampled
    events, and against DatumPlane(0.5), in f32 and f64: the sha256 of each
    case's 13 outputs."""
    import hashlib

    rng = np.random.default_rng(5)
    digests = {}
    for dtype in (torch.float32, torch.float64):
        kw = dict(dtype=dtype, device=dev)
        x = torch.tensor(X_OBS, **kw)
        for name, m in (("kerr", KerrMetric(1.0, 0.998, **kw)), ("jp", JohannsenPsaltisMetric(1.0, 0.6, 2.0, **kw))):
            A = torch.as_tensor(rng.uniform(-28, 28, 8192), **kw)
            B = torch.as_tensor(rng.uniform(-18, 18, 8192), **kw)
            v = map_impact_parameters(m, x, A, B)
            for geo, d, tkw in (
                ("none", None, {}),
                ("thin", ThinDisc(0.0, 50.0, **kw), {}),
                ("thin_sampled", ThinDisc(0.0, 50.0, **kw), {"event_method": "sampled"}),
                ("datum", DatumPlane(0.5, **kw), {}),
            ):
                tracer = CudaTracer(m, geometry=d, **tkw)
                y0 = tracer._constrain(x.expand_as(v), v)
                out = cuda_integrate_rays(m, y0, SPAN, **tracer._integrate_kwargs(dtype))
                h = hashlib.sha256()
                for key in cuda_solver._OUTPUT_KEYS:
                    h.update(out[key].contiguous().cpu().numpy().tobytes())
                digests[f"{name}_{geo}_{str(dtype)[6:]}"] = h.hexdigest()[:32]
    return digests


def phase_thick_geometries(dev, n=2048, n_trace=2048):
    """The kernel's generic geometries against its plain version on the
    same card tensors, ``n`` flagship rays (uniform over α ∈ [−28, 28], β ∈
    [−18, 18]) a case, f64 and f32: every case of `THICK_KINDS` and
    ShakuraSunyaev with sampled events traced whole (`_full_trace`), held
    at `phase_kernel_vs_plain`'s thresholds (f64: statuses ≥ 0.999 alike,
    hits within 1e-6; f32: ≥ 0.995, median redshift gap ≤ 1e-4), but the
    `STEPWISE_KINDS`, whose whole traces are printed and held iteration by
    iteration (`_stepwise`, its first `STEPWISE_ITERS` iterations, at
    `_stepwise_ok`'s thresholds);
    then the kernel against the captured `trace_geodesics` with
    ShakuraSunyaev on ``n_trace`` rays (f64, statuses ≥ 0.99 alike), and
    geometry kinds 0-2 bit for bit the kernel's before the generic
    geometries came (`KINDS012_DIGESTS`)."""
    rng = np.random.default_rng(21)
    alpha, beta = rng.uniform(-28.0, 28.0, n), rng.uniform(-18.0, 18.0, n)
    results, failed = {}, []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        kw = dict(dtype=dtype, device=dev)
        m = KerrMetric(1.0, 0.998, **kw)
        x = torch.tensor(X_OBS, **kw)
        v = map_impact_parameters(m, x, torch.as_tensor(alpha, **kw), torch.as_tensor(beta, **kw))
        for kind in THICK_KINDS + ("shakura_sunyaev_sampled",):
            geometry = _thick_geometry(kind.replace("_sampled", ""), m, dtype, dev)
            tracer = CudaTracer(m, geometry=geometry, event_method="sampled" if kind.endswith("_sampled") else "cubic")
            y0 = tracer._constrain(x.expand_as(v), v)
            res = _full_trace(m, x, tracer, y0, dtype, f"kerr_{kind}")
            if kind in STEPWISE_KINDS:
                res["stepwise"] = step = _stepwise(m, tracer, y0, dtype)
                ok = _stepwise_ok(step, dtype)
            elif dtype == torch.float64:
                ok = res["status_agree"] >= 0.999 and res["hit_max_abs_err"] <= 1e-6
            else:
                ok = res["status_agree"] >= 0.995 and res["g_median_rel"] <= 1e-4
            results[f"{kind}_{name}"] = res
            if not ok:
                failed.append(f"{kind}_{name}")
    # the kernel against the lockstep solver's trace_geodesics
    m = KerrMetric(1.0, 0.998, device=dev)
    x = torch.tensor(X_OBS, dtype=torch.float64, device=dev)
    geometry = ShakuraSunyaev.from_metric(m, 0.3)
    v = map_impact_parameters(m, x, *(torch.as_tensor(a[:n_trace], device=dev) for a in (alpha, beta)))
    steps = _Lockstep()
    with steps:
        gt = trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=geometry)
    _require_captured("thick_geometries trace_geodesics", steps)
    gk = CudaTracer(m, geometry=geometry)(x.expand_as(v), v, SPAN)
    hit = (gk.status == HIT) & (gt.status == HIT)
    results["trace_geodesics"] = dict(
        rays=n_trace,
        iterations=steps.iters,
        status_agree=float((gk.status == gt.status).double().mean()),
        hits=int(hit.sum()),
        hit_max_abs_err=float((gk.x[hit] - gt.x[hit]).abs().max()) if hit.any() else 0.0,
    )
    if results["trace_geodesics"]["status_agree"] < 0.99:
        failed.append("trace_geodesics")
    want = json.loads(KINDS012_DIGESTS.read_text())["sha256"]
    got = _kinds012_outputs(dev)
    results["kinds012_bit_for_bit"] = {case: got[case] == want[case] for case in want}
    if not all(results["kinds012_bit_for_bit"].values()):
        failed.append("kinds012_bit_for_bit")
    _say("thick_geometries", **results)
    if failed:
        raise AssertionError(f"thick_geometries: kernel and plain version disagree: {failed}")
    return results


# --- the cross-section callables (geometry kinds 8-9, geometry/codegen.py) ----------

# The cases of `phase_callable_geometries`: the docs' warped disc
# (docs/examples.md), ShakuraSunyaev's cross-section written as a callable
# (held also against kind 3 on the same rays), the warped disc precessed, a
# composite with a callable part, and a precessed DatumPlane (kind 2 inside
# kind 6, which needs no generated unit)
CALLABLE_KINDS = ("warped", "thick_shakura_sunyaev", "precessing_warped", "composite_callable", "precessing_datum")


def _docs_warp(rho):
    return 2.0 * torch.sin(rho / 10.0)


@functools.lru_cache(maxsize=1)
def _shakura_sunyaev_numbers():
    """(Ṁ/Ṁ_Edd, 1/η, r_isco) of ShakuraSunyaev.from_metric(m, 0.3) for
    Kerr a = 0.998, in f64 on the CPU: the same numbers, and so the same
    generated unit, whatever the device and dtype of the rays."""
    d = ShakuraSunyaev.from_metric(KerrMetric(1.0, 0.998, device="cpu"), 0.3)
    return float(d.mdot_over_edd), float(d.inv_eta), float(d.inner_r)


def _shakura_sunyaev_disc(dev):
    """That disc as kind 3, ShakuraSunyaev."""
    mdot, inv_eta, r_in = _shakura_sunyaev_numbers()
    return ShakuraSunyaev(mdot, inv_eta, r_in, device=dev)


def _shakura_sunyaev_callable():
    """That disc's cross-section (discs.py:279-283) as a callable of its
    numbers, for a ThickDisc."""
    mdot, inv_eta, r_in = _shakura_sunyaev_numbers()
    h0 = 3.0 * inv_eta * mdot

    def cross_section(rho):
        return torch.where(rho < r_in, -0.0, h0 * (1.0 - torch.sqrt(r_in / rho.clamp(min=1e-12))))

    return cross_section


def _callable_geometry(kind, dtype, dev):
    kw = dict(dtype=dtype, device=dev)
    warp = lambda: WarpedThinDisc(_docs_warp, 0.0, 100.0, **kw)  # noqa: E731
    return {
        "warped": warp,
        "thick_shakura_sunyaev": lambda: ThickDisc(_shakura_sunyaev_callable(), **kw),
        "precessing_warped": lambda: PrecessingDisc(warp(), 0.17, 0.5, **kw),
        "composite_callable": lambda: CompositeGeometry([ThinDisc(0.0, 20.0, **kw), ThickDisc(lambda rho: 0.1 * rho - 2.0, **kw)]),
        "precessing_datum": lambda: PrecessingDisc(DatumPlane(1.0, **kw), 0.1, 0.2, **kw),
    }[kind]()


def _callable_units():
    """The generated units that the callable phases launch: the render's
    (f32) and each case's in f64 and f32, for `phase_build` (their text
    does not depend on the device)."""
    m = KerrMetric(1.0, 0.998, device="cpu")
    units = []
    for dtype in (torch.float64, torch.float32):
        for kind in CALLABLE_KINDS:
            unit = cuda_solver._kernel_unit(m, _callable_geometry(kind, dtype, "cpu"), dtype)
            if unit is not None:
                units.append(unit)
    return units


def _callable_build(geometry, m, dtype):
    """The build of a geometry's generated unit as the worker ``build``
    recorded it (`_build.build_info()`): its registers and spills, and the
    seconds of the nvcc pass that built it (None where an earlier run had
    built it)."""
    key = _build.callable_key(cuda_solver._kernel_unit(m, geometry, dtype).source)
    build = json.loads((_WORKER_DIR / "build.json").read_text())["results"]["build"]
    return {"key": key, **build["callables"][key]}


def phase_callable_geometries_render(dev, side=1024):
    """The flagship render (f32, Kerr a = 0.998, analytic redshift) against
    the docs' ``WarpedThinDisc(lambda r: 2 sin(r / 10), 0, 100)``, its
    cross-section compiled into the kernel (`_full_render`: the render's
    time, finite pixels, attempted lane-steps, the kernel's time and bound,
    every 64th pixel against the plain version), and the build of its
    generated unit."""
    m = KerrMetric(1.0, 0.998, dtype=torch.float32, device=dev)
    geometry = _callable_geometry("warped", torch.float32, dev)
    # the analytic redshift's plunging four-velocity is the equatorial one:
    # off the plane, inside the ISCO (the warped disc reaches the horizon
    # at z ~ 0.2), g leaves (0, 2) on ~40 pixels, in the plain version and
    # in f64 alike; the range is held outside the ISCO
    result = _full_render(
        dev, m, side, "callable_geometries_render", "kerr_warped", geometry=geometry, range_rho_min=float(m.isco())
    )[0]
    result["build"] = _callable_build(geometry, m, torch.float32)
    _say("callable_geometries_build", **result["build"])
    return result


def phase_callable_geometries(dev, n=2048):
    """The cross-section callables compiled into the kernel against its
    plain version on the same card tensors, ``n`` flagship rays (uniform
    over α ∈ [−28, 28], β ∈ [−18, 18]) a case of `CALLABLE_KINDS`, f64 and
    f32, at `phase_thick_geometries`' thresholds (whole traces; the
    composite, whose hit test the step sequence decides, iteration by
    iteration); and ShakuraSunyaev's cross-section as a callable against
    kind 3 (the same kernel's closed form of it) on the same rays: statuses
    alike and hits within 1e-6 in f64 (printed)."""
    rng = np.random.default_rng(24)
    alpha, beta = rng.uniform(-28.0, 28.0, n), rng.uniform(-18.0, 18.0, n)
    results, failed = {}, []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        kw = dict(dtype=dtype, device=dev)
        m = KerrMetric(1.0, 0.998, **kw)
        x = torch.tensor(X_OBS, **kw)
        v = map_impact_parameters(m, x, torch.as_tensor(alpha, **kw), torch.as_tensor(beta, **kw))
        for kind in CALLABLE_KINDS:
            geometry = _callable_geometry(kind, dtype, dev)
            tracer = CudaTracer(m, geometry=geometry)
            y0 = tracer._constrain(x.expand_as(v), v)
            res = _full_trace(m, x, tracer, y0, dtype, f"kerr_{kind}")
            if kind in STEPWISE_KINDS:
                res["stepwise"] = step = _stepwise(m, tracer, y0, dtype)
                ok = _stepwise_ok(step, dtype)
            elif dtype == torch.float64:
                ok = res["status_agree"] >= 0.999 and res["hit_max_abs_err"] <= 1e-6
            else:
                ok = res["status_agree"] >= 0.995 and res["g_median_rel"] <= 1e-4
            if kind != "precessing_datum":
                res["build"] = _callable_build(geometry, m, dtype)
            results[f"{kind}_{name}"] = res
            if not ok:
                failed.append(f"{kind}_{name}")
            if kind == "thick_shakura_sunyaev":
                tk = CudaTracer(m, geometry=_shakura_sunyaev_disc(dev))
                ga, gb = tracer(x.expand_as(v), v, SPAN), tk(x.expand_as(v), v, SPAN)
                hit = (ga.status == HIT) & (gb.status == HIT)
                results[f"callable_vs_kind3_{name}"] = dict(
                    status_agree=float((ga.status == gb.status).double().mean()),
                    hits=int(hit.sum()),
                    hit_max_abs_err=float((ga.x[hit] - gb.x[hit]).abs().max()) if hit.any() else 0.0,
                )
    _say("callable_geometries", **results)
    if failed:
        raise AssertionError(f"callable_geometries: kernel and plain version disagree: {failed}")
    return results


def _sass_counts(lib_path, want=("geodesic_tsit5_kernelIf", "4KerrE", "Lb0E")):
    """Static SASS counts (cuobjdump -sass) of the Kerr f32 instantiation
    for geometry kinds 0-2 (``Lb0E``: kGeneric = false):
    its instructions, and those of its main loop, taken as the span of its
    longest backward branch, with the loop's most frequent opcodes. The
    loop's count holds the cubic event's 26 bisections and the other inner
    loops once each, whatever a step runs of them."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = body.partition("\n")
        if not all(w in name for w in want):
            continue
        instrs = [
            (int(a, 16), op.strip())
            for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
        ]
        backward = []
        for addr, op in instrs:
            target = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if target and int(target.group(1), 16) < addr:
                backward.append((addr - int(target.group(1), 16), int(target.group(1), 16), addr))
        _, lo, hi = max(backward)
        loop = [op for addr, op in instrs if lo <= addr <= hi]
        opcodes = {}
        for op in loop:
            word = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]
            opcodes[word] = opcodes.get(word, 0) + 1
        top = sorted(opcodes.items(), key=lambda kv: -kv[1])[:12]
        return dict(function=name.strip(), instructions=len(instrs), loop_instructions=len(loop), loop_top_opcodes=top)
    raise AssertionError(f"no SASS function with {want} in {lib_path}")


def phase_chain(dev, side=1024):
    """The flagship render's longest chain of steps, f32: the ray with the
    most attempts launched alone (its milliseconds and µs per attempt), the
    1/64 subset and all 1024² rays beside their longest ray's attempts, and
    all rays again with the warps of most attempts launched first; the
    kernel's static SASS counts (ncu does not run on the machine)."""
    dtype = torch.float32
    m, d, x = _flagship(dtype, dev)
    tracer = CudaTracer(m, geometry=d)
    y0 = _constrained(tracer, m, x, *_pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev))
    kw = tracer._integrate_kwargs(dtype)

    def launch(y, **extra):
        args = {**kw, **extra}
        cuda_integrate_rays(m, y, SPAN, **args)  # warm-up
        runs = [_timed(lambda: cuda_integrate_rays(m, y, SPAN, **args)) for _ in range(5)]
        return runs[-1][0], statistics.median(ms for _, ms in runs)

    res = {}
    out_full, full_ms = launch(y0)
    k = int(out_full["attempts"].argmax())
    for name, y in (("ray", y0[k : k + 1]), ("subset", y0[::64]), ("full", y0)):
        out, ms = (out_full, full_ms) if name == "full" else launch(y)
        longest = int(out["attempts"].max())
        res[name] = dict(rays=y.shape[0], longest_attempts=longest, ms=ms, us_per_longest_attempt=ms * 1e3 / longest)
    out, res["ray"]["ms_without_polish"] = launch(y0[k : k + 1], newton_iters=0)
    res["ray"].update(index=k, status=int(out["status"][0]), steps=int(out["steps"][0]))
    res["ray_share_of_full"] = res["ray"]["ms"] / full_ms
    # the same rays with the longest warps first (warps of 32 raster rays,
    # ordered by this run's attempts: an oracle for any longest-first order)
    order = torch.argsort(out_full["attempts"].view(-1, 32).amax(dim=1), descending=True)
    perm = (order[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)
    _, res["oracle_longest_warps_first_ms"] = launch(y0[perm])
    res["ncu_on_path"] = shutil.which("ncu") is not None
    res["sass_kerr_f32"] = _sass_counts(_build.build_info()["path"])
    _say("chain", **res)
    return res


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


def _kernel_counted(fn, dtype, dev):
    """One call of ``fn`` under the profiler, with the rays, attempted
    lane-steps and hits of each of B1's launches counted (sums on the card
    per launch, read once at the end): kernel and busy ms, launches, the
    counts, and the kernel's bound (`_bound`, Kerr against a DatumPlane)."""
    counted = []

    def counting(*args, **kw):
        out = integrate(*args, **kw)
        counted.append(
            torch.stack(
                [torch.tensor(out["attempts"].numel(), device=dev), out["attempts"].sum(), (out["status"] == HIT).sum()]
            )
        )
        return out

    integrate, cuda_solver.cuda_integrate_rays = cuda_solver.cuda_integrate_rays, counting
    try:
        busy_ms, kernel_ms, device_events = _device_busy_ms(fn)
    finally:
        cuda_solver.cuda_integrate_rays = integrate
    rays, attempts, hits = (int(v) for v in torch.stack(counted).sum(dim=0))
    bound_ms, bound_by = _bound("kerr_datum_plane", rays, attempts, hits, dtype)
    return dict(
        kernel_ms=kernel_ms, busy_ms=busy_ms, device_events=device_events, counted_launches=len(counted),
        kernel_rays=rays, attempted_lane_steps=attempts, hits=hits, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=None if kernel_ms is None else bound_ms / kernel_ms,
    )


class _KernelCountedCalls:
    """While entered, each call of ``module.name`` runs under
    `_kernel_counted`: its B1 launches, counts, kernel time and bound, from
    that call itself, go to ``kernel`` (one dict a call)."""

    def __init__(self, module, name, dtype, dev):
        self.module, self.name, self.dtype, self.dev, self.kernel = module, name, dtype, dev, []

    def __enter__(self):
        self._fn = fn = getattr(self.module, self.name)

        def counted(*args, **kw):
            out = []
            self.kernel.append(_kernel_counted(lambda: out.append(fn(*args, **kw)), self.dtype, self.dev))
            return out[0]

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


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
    with _PolishCounter() as polish:
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
    if polish.calls != 0:
        raise AssertionError(f"the CTF line profile called the plain-torch polish {polish.calls} times")
    total = float(flux.double().sum())
    if not bool(torch.isfinite(flux).all()) or abs(total - 1.0) > 1e-4:
        raise AssertionError(f"CTF flux not finite or not normalised: sum {total}")
    flux_np, bins_np = flux.double().cpu().numpy(), bins.double().cpu().numpy()
    m1 = _m1(flux_np, bins_np)
    drift = abs(m1 / M1_F64_CPU - 1.0)
    if drift > 1e-3:
        raise AssertionError(f"CTF m1 {m1} drifts {drift} from the f64 CPU value")
    dt = statistics.median(times)
    # one more profile under the profiler, for the kernel's time and bound
    k = _kernel_counted(profile, dtype, dev)
    busy_ms, kernel_ms = k["busy_ms"], k["kernel_ms"]
    res = dict(
        seconds_per_profile=dt,
        profile_seconds=times,
        first_profile_seconds=first,
        launches=launches,
        launches_per_profile=launches / 4,
        torch_polish_calls=polish.calls,
        flux_sum=total,
        m1=m1,
        m1_drift_vs_f64_cpu=drift,
        nonzero_bins=int((flux > 0).sum()),
        device_events=k["device_events"],
        device_events_per_launch=k["device_events"] / k["counted_launches"],
        device_busy_ms=busy_ms,
        device_busy_share=None if busy_ms is None else busy_ms / 1e3 / dt,
        kernel_ms=kernel_ms,
        kernel_rays=k["kernel_rays"],
        attempted_lane_steps=k["attempted_lane_steps"],
        hits=k["hits"],
        bound_ms=k["bound_ms"],
        bound_by=k["bound_by"],
        bound_share=k["bound_share"],
    )
    _say("ctf_lineprofile", **res)
    return res, flux_np


def _binned_profile(dev, side, incl_deg, r_max_plane, bins, isco_margin, max_re):
    """`bench_binning`'s path: a side×side geometric polar plane traced by
    `CudaTracer` against ThinDisc(0, ∞) over λ ∈ (0, 2000), then
    `binned_flux` with the analytic redshift, ε = r⁻³ and rₑ ∈
    [isco + isco_margin, max_re]. Returns (profile, tracer, kernel_only),
    the last timing the kernel alone on the plane's rays: (attempted
    lane-steps, hits, ms)."""
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
        return int(out["attempts"].sum()), _hits(out), ms

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
    with _PolishCounter() as polish:
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
    if polish.calls != 0:
        raise AssertionError(f"the binned profiles called the plain-torch polish {polish.calls} times")
    if int(aux["unfinished"]) != 0:
        raise AssertionError(f"{int(aux['unfinished'])} rays unfinished")
    total = float(flux.double().sum())
    nonzero = int((flux > 0).sum())
    if abs(total - 1.0) > 1e-4 or nonzero <= 100:
        raise AssertionError(f"binned flux: sum {total}, {nonzero} nonzero bins")
    dt = statistics.median(times)
    executed = int(aux["warp_iters"].sum())
    useful = int(aux["steps"].sum())
    attempted, hits, kernel_ms = kernel_only()
    bound_ms, _ = _bound("kerr", n, attempted, hits, torch.float32)

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
        torch_polish_calls=polish.calls,
        unfinished=int(aux["unfinished"]),
        flux_sum=total,
        nonzero_bins=nonzero,
        executed_lane_steps=executed,
        attempted_lane_steps=attempted,
        useful_ray_steps=useful,
        wasted_step_fraction=1.0 - useful / max(executed, 1),
        hits=hits,
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


# --- the lockstep solver (plain torch on the card) through the public API ------


class _Lockstep:
    """Observes the lockstep loops that `integrate_rays` runs while it is
    entered (`solver.observe_loops`): loops (``calls``), those carrying a
    tangent (``tangent_calls``), iterations (``iters``), each loop's
    iterations and host seconds from its start to its last alive check,
    which waits for the card (``loops``), and what their CUDA
    graphs did (``graph``: captures, replays (one an iteration), the
    captures' host seconds and reserved bytes); with ``window``,
    profiles the card over that many iterations from iteration ``start`` of
    each loop (at the loop's block boundaries): the busy share of the loop
    in its steady state."""

    def __init__(self, window=0, start=256):
        self.window, self.start = window, start

    def __enter__(self):
        self.calls = self.tangent_calls = self.iters = 0
        self.loops = []
        self.graph = dict(captures=0, replays=0, capture_seconds=0.0, capture_reserved_bytes=0)
        self.busy_ms = self.wall_ms = 0.0
        self.device_events = 0
        self._prof = None
        self._observing = lockstep_solver.observe_loops(self)
        self._observing.__enter__()
        return self

    def __call__(self, event, **info):
        if event == "loop":
            self.calls += 1
            self.tangent_calls += info["tangent"]
            self._graphed = info["graphed"]
            self._loop_t0 = time.perf_counter()
        elif event == "capture":
            self.graph["captures"] += 1
            self.graph["capture_seconds"] += info["seconds"]
            self.graph["capture_reserved_bytes"] += info["reserved_bytes"]
        elif event == "end":
            self.iters += info["iterations"]
            self.loops.append(dict(iterations=info["iterations"], seconds=time.perf_counter() - self._loop_t0))
            if self._graphed:
                self.graph["replays"] += info["iterations"]
        if self.window and event in ("block", "end"):
            self._block(info["iterations"])

    def _block(self, iters):
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
            self._prof = None
            self.busy_ms += sum(e.duration_ns() for e in events) / 1e6
            self.device_events += len(events)

    def __exit__(self, *exc):
        self._observing.__exit__(*exc)
        if self._prof is not None:  # a loop shorter than the window
            self._prof.__exit__(None, None, None)

    def busy_share(self):
        return self.busy_ms / self.wall_ms if self.wall_ms else None


class _NoKernelRoute:
    """Counts calls of the integrator kernel's entry points (the kernel and
    its plain version) and kernel launches while it is entered: the lockstep
    solver's path must make none."""

    def __enter__(self):
        self.calls, self._fns = 0, {k: getattr(cuda_solver, k) for k in ("cuda_integrate_rays", "integrate_rays_plain")}
        self._launches = cuda_solver.KERNEL_LAUNCHES
        for name, fn in self._fns.items():

            def counting(*args, _fn=fn, **kw):
                self.calls += 1
                return _fn(*args, **kw)

            setattr(cuda_solver, name, counting)
        return self

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(cuda_solver, name, fn)
        self.launches = cuda_solver.KERNEL_LAUNCHES - self._launches
        if exc[0] is None and (self.calls or self.launches):
            raise AssertionError(
                f"the lockstep solver's path reached the integrator kernel: {self.calls} calls, "
                f"{self.launches} launches"
            )


def _require_captured(what, steps):
    """Raises unless every lockstep iteration that ``steps`` counted ran as
    a CUDA graph replay."""
    if steps.graph["captures"] < 1 or steps.iters != steps.graph["replays"]:
        raise AssertionError(f"{what}: the lockstep loop did not run captured: {steps.graph}, {steps.iters} iterations")


def _trace_seconds(fn):
    """(fn(), its seconds on the host clock up to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _hit_radius_jvp(dev, n, seed=31):
    """∂r_hit/∂β by `trace_geodesics(..., v_dot=...)` (the tangent carried through the
    captured loop; the bits of `torch.func.jvp` around `trace_geodesics`)
    on ``n`` f64 flagship rays at ρ ∈ [8, 20] (outside the critical curve),
    against a central difference (ε = 1e-3) at the reference's rtol 2e-3
    (tests/test_integrate.py:193)."""
    m, d, x = _flagship(torch.float64, dev)
    rng = np.random.default_rng(seed)
    rho, phi = rng.uniform(8.0, 20.0, n), rng.uniform(0.0, 2 * math.pi, n)
    A = torch.as_tensor(rho * np.cos(phi), device=dev)
    B0 = torch.as_tensor(rho * np.sin(phi), device=dev)

    def hit(B):
        v = map_impact_parameters(m, x, A, B)
        gp = trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d)
        return gp.x[:, 1] * torch.sin(gp.x[:, 2]), gp.status

    def hit_jvp(B):
        v, v_dot = lifted_jvp(lambda b: map_impact_parameters(m, x, A, b), (B,), (torch.ones_like(B),))
        gp, gp_dot = trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d, v_dot=v_dot)
        r, dr = lifted_jvp(lambda X: X[:, 1] * torch.sin(X[:, 2]), (gp.x,), (gp_dot.x,))
        return r, dr, gp.status

    eps = 1e-3
    with _Lockstep() as steps:
        (r0, dr, s0), seconds = _trace_seconds(lambda: hit_jvp(B0))
    (rp, sp), (rm, sm) = hit(B0 + eps), hit(B0 - eps)
    ok = (s0 == HIT) & (sp == HIT) & (sm == HIT)
    fd = (rp - rm) / (2 * eps)
    rel = float(((dr - fd).abs() / fd.abs())[ok].max())
    res = dict(
        rays=n, hit_in_all_three=int(ok.sum()), max_rel_err=rel, seconds=seconds, iterations=steps.iters,
        ms_per_iteration=seconds * 1e3 / max(steps.iters, 1), graph=steps.graph,
    )
    if int(ok.sum()) < n // 2 or not rel <= 2e-3 or steps.graph["captures"] != 1:
        raise AssertionError(f"∂r_hit/∂β by jvp against the central difference: {res}")
    return res


def phase_trace_api(dev, n=8192, n_jvp=64):
    """`trace_geodesics` (the lockstep solver, plain torch on the card)
    against `CudaTracer` on the same constrained flagship states (Kerr a =
    0.998, i = 75°, r = 1000, ThinDisc(0, 50), λ ≤ 2200), f64 and f32:
    statuses ≥ 0.995 alike; hit positions within atol 1e-5 in f64 (as
    tests/test_torch_integrate.py holds the kernel's plain version) and to
    a median relative difference ≤ 1e-5 in f32; lockstep iterations and ms
    per iteration. Then a forward-mode derivative through it
    (`_hit_radius_jvp`)."""
    res = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        m, tracer, y0 = _flagship_rays(dev, dtype, n, 30)
        d = tracer.geometry

        def trace(y):
            return trace_geodesics(m, y[:, :4], y[:, 4:], SPAN, geometry=d, constrain=False)

        trace(y0[:64])  # warm-up
        with _NoKernelRoute(), _Lockstep() as steps:
            gp, seconds = _trace_seconds(lambda: trace(y0))
        gk, _ = tracer.trace(y0, SPAN)
        torch.cuda.synchronize()
        agree = float((gp.status == gk.status).double().mean())
        hit = (gp.status == HIT) & (gk.status == HIT)
        pos_abs = (gp.x[hit] - gk.x[hit]).abs()
        pos_rel = pos_abs / gk.x[hit].abs().clamp(min=1e-30)
        r = dict(
            rays=n,
            status_agree=agree,
            hits=int(hit.sum()),
            hit_x_max_abs=float(pos_abs.max()),
            hit_x_max_rel=float(pos_rel.max()),
            hit_x_median_rel=float(pos_rel.median()),
            hit_lam_max_abs=float((gp.lam_max[hit] - gk.lam_max[hit]).abs().max()),
            unfinished=int(((gp.status == StatusCodes.NoStatus) & (gp.lam_max < SPAN[1] - 1e-3)).sum()),
            iterations=steps.iters,
            seconds=seconds,
            ms_per_iteration=seconds * 1e3 / max(steps.iters, 1),
            graph=steps.graph,
        )
        res[name] = r
        _require_captured(f"trace_api {name}", steps)
        if agree < 0.995 or r["unfinished"]:
            raise AssertionError(f"trace_geodesics {name} against CudaTracer: {r}")
        if name == "f64" and not r["hit_x_max_abs"] <= 1e-5:
            raise AssertionError(f"trace_geodesics f64 hits off CudaTracer's: {r}")
        if name == "f32" and not r["hit_x_median_rel"] <= 1e-5:
            raise AssertionError(f"trace_geodesics f32 hits off CudaTracer's: {r}")
    res["jvp"] = _hit_radius_jvp(dev, n_jvp)
    _say("trace_api", **res)
    return res


def phase_render_api(dev, side=1024):
    """`rendergeodesics` through the public API: first the f64 render
    goldens (20×20, r = 100, i = 85°, λ ≤ 200; the Kerr and Johannsen
    shadows and the Kerr thin disc, rtol 1e-1 as tests/test_render.py),
    then the flagship redshift render at side² pixels, f32, whose pixel
    velocities (`_pixel_velocities`) `CudaTracer` traces once more: hit masks
    ≥ 0.995 alike, median relative g ≤ 1e-4, no unfinished ray. The render
    is `prerendergeodesics` and `apply`, which is `rendergeodesics`, so that
    its points can be read; its busy share is profiled over 64 lockstep
    iterations from the 256th."""
    goldens = {}
    x = torch.tensor(GOLDEN_X_OBS, dtype=torch.float64, device=dev)
    kerr = KerrMetric(1.0, 0.0, device=dev)
    camera = dict(image_width=20, image_height=20, alpha_lims=(-9.5, 9.5), beta_lims=(-9.5, 9.5))
    for name, m, d, golden in (
        ("shadow", kerr, None, 9009.452876609641),
        ("thin_disc", kerr, ThinDisc(0.0, 40.0, device=dev), 38412.08347901267),
        ("johannsen_shadow", JohannsenMetric(1.0, 0.0, device=dev), None, 9009.448935932085),
    ):
        with _NoKernelRoute():
            _, _, img = rendergeodesics(m, x, d, 200.0, **camera)
        total = float(torch.nansum(img))
        if img.shape != (20, 20) or not math.isclose(total, golden, rel_tol=1e-1):
            raise AssertionError(f"{name} golden through rendergeodesics: {total} vs {golden}")
        goldens[name] = total

    dtype = torch.float32
    m, d, x = _flagship(dtype, dev)
    pf = ConstPointFunctions.redshift(m, x) @ ConstPointFunctions.filter_intersected()
    camera = dict(alpha_lims=(-28.0, 28.0), beta_lims=(-18.0, 18.0))
    rendergeodesics(m, x, d, SPAN[1], pf=pf, image_width=32, image_height=32, **camera)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _NoKernelRoute(), _Lockstep(window=64) as steps:
        (_, _, cache), seconds = _trace_seconds(
            lambda: prerendergeodesics(m, x, d, SPAN[1], image_width=side, image_height=side, **camera)
        )
        img, shade_s = _trace_seconds(lambda: apply(pf, cache))
    peak_bytes = torch.cuda.max_memory_allocated()
    _require_captured("render_api", steps)
    gp = cache.points
    unfinished = int(((gp.status == StatusCodes.NoStatus) & (gp.lam_max < SPAN[1] - 1e-3)).sum())
    _, _, v = _pixel_velocities(m, x, side, side, camera["alpha_lims"], camera["beta_lims"])
    gk = CudaTracer(m, geometry=d)(x.expand_as(v), v, SPAN)
    img_k = pf(m, gk, SPAN[1]).reshape(side, side).T
    fin, fin_k = torch.isfinite(img), torch.isfinite(img_k)
    both = fin & fin_k
    res = dict(
        goldens=goldens,
        pixels=side * side,
        seconds_per_render=seconds + shade_s,
        trace_seconds=seconds,
        shading_seconds=shade_s,
        iterations=steps.iters,
        ms_per_iteration=seconds * 1e3 / max(steps.iters, 1),
        busy_share=steps.busy_share(),
        busy_window=dict(iterations=64, from_iteration=256, busy_ms=steps.busy_ms, wall_ms=steps.wall_ms,
                         device_events=steps.device_events),
        graph=steps.graph,
        peak_allocated_bytes=peak_bytes,
        finite_pixels=int(fin.sum()),
        hit_mask_agree=float((fin == fin_k).double().mean()),
        g_median_rel=float(_rel(img[both], img_k[both]).median()),
        unfinished=unfinished,
    )
    if res["hit_mask_agree"] < 0.995 or not res["g_median_rel"] <= 1e-4 or unfinished:
        raise AssertionError(f"rendergeodesics against CudaTracer: {res}")
    _say("render_api", **res)
    return res


class _KeepPoints:
    """Keeps the points `lineprofile` traces while it is entered."""

    def __enter__(self):
        self.points, self._fn = [], lineprofile_module.trace_geodesics

        def keeping(*args, **kw):
            self.points.append(self._fn(*args, **kw))
            return self.points[-1]

        lineprofile_module.trace_geodesics = keeping
        return self

    def __exit__(self, *exc):
        lineprofile_module.trace_geodesics = self._fn


def phase_binning_api(dev, ctf_flux, side=1000):
    """`lineprofile(..., method=BinningMethod())` at bench_binning's
    configuration (f32, i = 70°, a side×side geometric plane to r = 50,
    ThinDisc(0, ∞), λ ≤ 2000, rₑ ∈ [isco, 200], bins 0.1:1.4×200): Σ = 1 ±
    1e-4, and bin by bin against `CudaTracer`'s binned profile over the bins
    above 1e-3 of the peak (median relative difference ≤ 1e-3; the rays
    `domain_upper_hemisphere` stops are the expected difference). Then once
    at the transfer-function profile's configuration (i = 60°, plane to
    r = 250, rₑ ∈ [isco + 1e-2, 50]) against that profile: median relative
    difference ≤ 2%."""
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    d = ThinDisc(0.0, math.inf, dtype=dtype, device=dev)

    def binned(incl_deg, r_max, bins, n, **kw):
        x = torch.tensor([0.0, 1000.0, math.radians(incl_deg), 0.0], dtype=dtype, device=dev)
        plane = PolarPlane(GeometricGrid(), Nr=n, Ntheta=n, r_max=r_max, dtype=dtype, device=dev)
        return lineprofile(m, x, d, bins=bins, method=BinningMethod(), plane=plane, lam_max=2000.0, **kw)[1]

    bins = torch.linspace(0.1, 1.4, 200, dtype=dtype, device=dev)
    binned(70.0, 50.0, bins, 32, max_re=200.0)  # warm-up
    with _NoKernelRoute(), _Lockstep() as steps, _KeepPoints() as kept:
        flux, seconds = _trace_seconds(lambda: binned(70.0, 50.0, bins, side, max_re=200.0))
    _require_captured("binning_api", steps)
    gp = kept.points[-1]
    below = int(((gp.status == StatusCodes.OutOfDomain) & (gp.x[:, 1] <= 12000.0)).sum())
    total = float(flux.double().sum())
    profile_k, _, _ = _binned_profile(dev, side, 70.0, 50.0, bins, 0.0, 200.0)
    flux_k = profile_k().double().cpu().numpy()
    f = flux.double().cpu().numpy()
    top = flux_k > 1e-3 * flux_k.max()
    res = dict(
        rays=side * side,
        seconds_per_profile=seconds,
        iterations=steps.iters,
        ms_per_iteration=seconds * 1e3 / max(steps.iters, 1),
        graph=steps.graph,
        flux_sum=total,
        nonzero_bins=int((f > 0).sum()),
        stopped_below_the_plane=below,
        hits=int((gp.status == HIT).sum()),
        vs_cuda_tracer_bins_compared=int(top.sum()),
        vs_cuda_tracer_median_rel=float(np.median(np.abs(f[top] - flux_k[top]) / flux_k[top])),
        vs_cuda_tracer_max_rel=float(np.max(np.abs(f[top] - flux_k[top]) / flux_k[top])),
    )
    if abs(total - 1.0) > 1e-4 or not res["vs_cuda_tracer_median_rel"] <= 1e-3:
        raise AssertionError(f"binned lineprofile against CudaTracer's: {res}")

    ctf_bins = torch.linspace(*CTF_BINS, dtype=dtype, device=dev)
    with _NoKernelRoute():
        f60, seconds60 = _trace_seconds(
            lambda: binned(60.0, 250.0, ctf_bins, side, min_re=float(m.isco()) + 1e-2, max_re=50.0)
        )
    f60 = f60.double().cpu().numpy()
    top = ctf_flux > 1e-3 * ctf_flux.max()
    res.update(
        ctf_config_seconds=seconds60,
        ctf_config_flux_sum=float(f60.sum()),
        vs_ctf_bins_compared=int(top.sum()),
        vs_ctf_median_rel=float(np.median(np.abs(f60[top] - ctf_flux[top]) / ctf_flux[top])),
    )
    if abs(res["ctf_config_flux_sum"] - 1.0) > 1e-4 or not res["vs_ctf_median_rel"] <= 2e-2:
        raise AssertionError(f"binned lineprofile against the transfer-function profile: {res}")
    _say("binning_api", **res)
    return res


# --- the lockstep loop's CUDA graph, and the `xla` transfer functions -------------


def _graph_ab(fn):
    """fn() with the lockstep loop captured, then uncaptured
    (`cuda_graphs(False)`): (captured output, uncaptured output, record of
    both runs' seconds, iterations, ms an iteration and graph counters)."""
    rec, outs = {}, []
    for name, on in (("with_graph", True), ("without_graph", False)):
        with cuda_graphs(on), _Lockstep() as steps:
            out, seconds = _trace_seconds(fn)
        outs.append(out)
        rec[name] = dict(
            seconds=seconds, iterations=steps.iters, ms_per_iteration=seconds * 1e3 / max(steps.iters, 1),
            graph=steps.graph,
        )
    return outs[0], outs[1], rec


def _same_points(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("status", "x", "v", "lam_max", "x_init", "v_init"))


def phase_lockstep_graph(dev, n=8192):
    """The captured lockstep loop against the uncaptured one, bit for bit:
    `trace_geodesics` on ``n`` flagship rays (Kerr a = 0.998, r = 1000,
    i = 75°, ThinDisc(0, 50), λ ≤ 2200) in f64 and f32, and the first
    forward-mode trace of `continuum_time`'s Newton at r = 10⁴ (one ray,
    f64: the lamp post's height plane, from the cold start), its tangent
    too; and the dense trace (256 saved states) and its tangent of
    `refine_for_target`'s Gauss-Newton step for the ring corona's source at
    r = 10⁴. Seconds, iterations and ms an iteration both ways; the
    captures' host seconds and reserved bytes."""
    res = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        m, d, x = _flagship(dtype, dev)
        rng = np.random.default_rng(30)
        A = torch.as_tensor(rng.uniform(-28, 28, n), dtype=dtype, device=dev)
        B = torch.as_tensor(rng.uniform(-18, 18, n), dtype=dtype, device=dev)
        v = map_impact_parameters(m, x, A, B)
        got, want, rec = _graph_ab(lambda: trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d))
        res[name] = dict(rays=n, bit_equal=_same_points(got, want), **rec)
    m, x = _lag_setup(dev, LAG_X_OBS)
    x_src, _ = LampPostModel().sample_position_velocity(m)
    x_src = x_src.to(torch.float64)
    rho_src = torch.maximum(x_src[1] * torch.sin(x_src[2]), 1e-3 * x_src[1]).reshape(1)
    plane = DatumPlane(x_src[1] * torch.cos(x_src[2]), device=dev)
    th = torch.full((1,), math.pi / 2, dtype=torch.float64, device=dev)
    trace = _make_trace_to_disc(m, x, plane, 2.0 * x[1], th, 0.0, 0.0, 1e-2, {})
    r0 = torch.clamp(rho_src, min=20.0)
    (gp, gd), (gp2, gd2), rec = _graph_ab(lambda: trace(r0, torch.ones_like(r0)))
    res["continuum_jvp_trace"] = dict(rays=1, bit_equal=_same_points(gp, gp2) and _same_points(gd, gd2), **rec)
    # the dense trace and its tangent of `refine_for_target`'s Gauss-Newton
    # step for the ring corona's source (r = 3, h = 4), from the JAX
    # package's pattern-search seed: the ray twice, each with one column
    ab = torch.tensor(_extended_reference()["ring"]["jax"]["ring_ab"], dtype=torch.float64, device=dev)
    eye = torch.eye(2, dtype=torch.float64, device=dev)
    lam = 2.0 * float(x[1])
    (p1, d1), (p2, d2), rec = _graph_ab(
        lambda: targets_module._dense(m, x, ab[0].repeat(2), ab[1].repeat(2), lam, 256, 0.0, lam, (eye[0], eye[1]))
    )
    same = all(torch.equal(a, b) for a, b in zip(p1[1:] + d1[1:3], p2[1:] + d2[1:3]))
    res["refine_dense_tangent"] = dict(
        rays=2, saved=int(p1[3].max()), bit_equal=same and _same_points(p1[0], p2[0]) and _same_points(d1[0], d2[0]), **rec
    )
    _say("lockstep_graph", **res)
    bad = {k: r["bit_equal"] for k, r in res.items() if not r["bit_equal"] or r["with_graph"]["graph"]["captures"] != 1}
    if bad:
        raise AssertionError(f"the captured lockstep loop against the uncaptured one: {bad}")
    return res


def _binwise_gap(flux, ref, floor):
    """Median and largest relative gap of ``flux`` to ``ref`` over the bins
    where ``ref`` ≥ ``floor``."""
    top = ref >= floor
    rel = np.abs(flux[top] - ref[top]) / ref[top]
    return dict(bins_compared=int(top.sum()), median_rel=float(np.median(rel)), max_rel=float(rel.max()))


def phase_ctf_xla(dev, num_re=100, N_extrema=15, N=80):
    """`lineprofile` with the default (``xla``) transfer functions at
    `bench_ctf`'s configuration (f32, a = 0.998, i = 60°, ThinDisc(0, ∞),
    ``num_re`` radii × 80 angles, ``N_extrema`` golden-section steps, bins
    0.1:1.5×180), with no launch of B1: finite, Σ = 1 ± 1e-4, bin by bin
    within 2% (median over the bins above 1e-3 of the peak) of the
    ``backend="cuda"`` profile at the same configuration, and at the full
    configuration (100 radii, 80 angles, whatever the steps) m1 within
    1e-3 of the JAX package's f64 CPU value. Forward-mode traces, lockstep iterations, ms an
    iteration and the captures' host seconds."""
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor(CTF_X_OBS, dtype=dtype, device=dev)
    d = ThinDisc(0.0, math.inf, dtype=dtype, device=dev)
    bins = torch.linspace(*CTF_BINS, dtype=dtype, device=dev)
    kw = dict(bins=bins, num_re=num_re, N=N, N_extrema=N_extrema)
    with _NoKernelRoute(), _Lockstep() as steps:
        (_, flux), seconds = _trace_seconds(lambda: lineprofile(m, x, d, **kw))
    _require_captured("ctf_xla", steps)
    cuda_flux = lineprofile(m, x, d, backend="cuda", **kw)[1].double().cpu().numpy()
    f = flux.double().cpu().numpy()
    m1 = _m1(f, bins.double().cpu().numpy())
    full = num_re == 100 and N == 80
    res = dict(
        num_re=num_re, angles=N, N_extrema=N_extrema, full_size=full, seconds_per_profile=seconds,
        seconds_per_radius=seconds / num_re, traces=steps.calls, jvp_traces=steps.tangent_calls,
        iterations=steps.iters, ms_per_iteration=seconds * 1e3 / max(steps.iters, 1), graph=steps.graph,
        finite=bool(np.isfinite(f).all()), flux_sum=float(f.sum()), m1=m1, m1_drift_vs_f64_cpu=abs(m1 / M1_F64_CPU - 1.0),
        vs_cuda_backend=_binwise_gap(f, cuda_flux, 1e-3 * cuda_flux.max()),
    )
    _say("ctf_xla", **res)
    if not (res["finite"] and abs(res["flux_sum"] - 1.0) <= 1e-4 and res["vs_cuda_backend"]["median_rel"] <= 2e-2):
        raise AssertionError(f"the xla transfer-function line profile: {res}")
    if full and not res["m1_drift_vs_f64_cpu"] <= 1e-3:
        raise AssertionError(f"the xla transfer-function line profile's m1: {res}")
    return res


THICK_GOLDEN_JAX = 14.714802  # tests/test_transfer.py:281
THICK_GOLDEN_GRADUS = 14.64279128586961  # Gradus.jl test-thick-disc.jl
# the golden's samples from the JAX package and the port, f64 on the CPU
# (scripts/torch_thick_golden_fma.py --samples)
THICK_GOLDEN_SAMPLES = Path(__file__).resolve().parent / "tests" / "data" / "thick_golden_samples.json"


def _sum_f_split(ok, f, gstar):
    """Σf over the valid samples, the interior ones (0.01 < g✶ < 0.99) and
    the rest, with the counts."""
    valid = ok & np.isfinite(f)
    interior = valid & (gstar > 0.01) & (gstar < 0.99)
    return dict(
        valid=int(ok.sum()), interior=int(interior.sum()), sum_f=float(f[valid].sum()),
        sum_f_interior=float(f[interior].sum()), sum_f_rest=float(f[valid & ~interior].sum()),
    )  # fmt: skip


# the interior samples' bounds against the CPU runs: ~10× the JAX package's
# gap to the port's on the CPU (θ 0, g✶ 1.2e-7, t 4.4e-11, f 4.2e-6; f
# carries |∂(α,β)/∂(ρ,g)| from forward-mode traces 10⁴ long)
THICK_GOLDEN_RTOL = dict(theta=1e-9, gstar=1e-6, t=1e-9, f=5e-5)


def phase_thick_disc_golden(dev):
    """tests/test_transfer.py::test_thick_disc_ctf_golden through the
    ``xla`` backend, f64 (Kerr a = 0.998, r = 10⁴, i = 75°,
    `ShakuraSunyaev.from_metric`, rₑ = 3, β₀ = 2), held where it is well
    conditioned: the same valid samples as the JAX package's and the port's
    f64 CPU runs (`THICK_GOLDEN_SAMPLES`), the interior samples' (0.01 < g✶
    < 0.99) θ, g✶, t and f within `THICK_GOLDEN_RTOL` of both, and Σf
    within 7e-3 of Gradus.jl's 14.64279 (the JAX test's bound against
    Gradus.jl). Σf's gap to the JAX package's 14.714802 is recorded, not
    held: 40% of Σf comes from the 43 samples with g✶ within 0.01 of the
    extremes, where f is a 0·∞ product that the traces' last bits move
    (the JAX package's own Σf moves by 4.5e-3 with XLA's fused
    multiply-adds off, all of it there). Σf split into the interior
    samples and the rest, on the card and in both CPU runs, shows where a
    gap lies."""
    m = KerrMetric(1.0, 0.998, device=dev)
    x = torch.tensor([0.0, 1e4, math.radians(75.0), 0.0], dtype=torch.float64, device=dev)
    disc = ShakuraSunyaev.from_metric(m)
    radii = torch.tensor([3.0], dtype=torch.float64, device=dev)
    with _NoKernelRoute(), _Lockstep() as steps:
        (_, samples), golden_s = _trace_seconds(
            lambda: cunningham_transfer_function(m, x, disc, radii, beta0=2.0, return_samples=True)
        )
    _require_captured("thick_disc_golden", steps)
    card = {k: samples[k][0].cpu().numpy() for k in ("theta", "gstar", "f", "t", "ok")}
    cpu = {
        run: {k: np.asarray(v, dtype=bool if k == "ok" else np.float64) for k, v in s.items()}
        for run, s in json.loads(THICK_GOLDEN_SAMPLES.read_text()).items()
    }
    res = dict(card=_sum_f_split(card["ok"], card["f"], card["gstar"]))
    res.update(
        {f"{run}_cpu": _sum_f_split(c["ok"], c["f"], c["gstar"]) for run, c in cpu.items()},
        seconds=golden_s, traces=steps.calls, jvp_traces=steps.tangent_calls, iterations=steps.iters,
        ms_per_iteration=golden_s * 1e3 / max(steps.iters, 1), graph=steps.graph,
    )  # fmt: skip
    total = res["card"]["sum_f"]
    res.update(vs_jax_rel=total / THICK_GOLDEN_JAX - 1.0, vs_gradus_rel=total / THICK_GOLDEN_GRADUS - 1.0)
    same_ok, interior_rel = {}, {}
    for run, c in cpu.items():
        same_ok[run] = bool(c["ok"].shape == card["ok"].shape and np.array_equal(c["ok"], card["ok"]))
        if not same_ok[run]:
            continue
        interior = c["ok"] & (c["gstar"] > 0.01) & (c["gstar"] < 0.99)
        interior_rel[run] = {
            k: float(np.max(np.abs(card[k][interior] / c[k][interior] - 1.0))) for k in THICK_GOLDEN_RTOL
        }
    res.update(same_ok_as_cpu=same_ok, interior_max_rel=interior_rel)
    _say("thick_disc_golden", **res)
    held = (
        all(same_ok.values())
        and res["card"]["interior"] >= 30
        and all(r[k] <= THICK_GOLDEN_RTOL[k] for r in interior_rel.values() for k in r)
        and abs(res["vs_gradus_rel"]) <= 7e-3
    )
    if not held:
        raise AssertionError(f"thick-disc golden: {res}")
    return res


def phase_thick_disc(dev, num_re=100, N_extrema=15, N=80, binned_plane=None):
    """The thick-disc line profile through the ``xla`` transfer functions
    at full size, f32, at `bench_ctf`'s camera (a = 0.998, i = 60°,
    r = 1000) for `ShakuraSunyaev.from_metric(m)`: `transferfunctions` at
    its defaults (100 radii × 80 angles), finite, Σ = 1 ± 1e-4; and against
    `lineprofile(method=BinningMethod())` on the same disc: at 100 radii ×
    80 angles, a median gap of at most 5% over the bins holding ≥ 1e-3 of
    the flux. ``num_re``, ``N_extrema`` and ``N`` cut the line profile's
    transfer functions (the script's run takes 4 golden-section steps, not
    15, to end inside its time limit), ``binned_plane`` (a `PolarPlane`) the
    binned profile's rays."""
    dtype = torch.float32
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor(CTF_X_OBS, dtype=dtype, device=dev)
    disc = ShakuraSunyaev.from_metric(m, dtype=dtype)
    bins = torch.linspace(*CTF_BINS, dtype=dtype, device=dev)
    with _NoKernelRoute(), _Lockstep() as steps:
        (_, flux), seconds = _trace_seconds(
            lambda: lineprofile(m, x, disc, bins=bins, num_re=num_re, N_extrema=N_extrema, N=N)
        )
    _require_captured("thick_disc", steps)
    with _NoKernelRoute(), _Lockstep() as bsteps:
        (_, binned), binned_s = _trace_seconds(
            lambda: lineprofile(m, x, disc, bins=bins, method=BinningMethod(), plane=binned_plane)
        )
    f, fb = flux.double().cpu().numpy(), binned.double().cpu().numpy()
    res = dict(
        num_re=num_re, angles=N, N_extrema=N_extrema, full_size=num_re == 100 and N_extrema == 15 and N == 80,
        seconds_per_profile=seconds, seconds_per_radius=seconds / num_re,
        traces=steps.calls, jvp_traces=steps.tangent_calls, iterations=steps.iters,
        ms_per_iteration=seconds * 1e3 / max(steps.iters, 1), graph=steps.graph,
        finite=bool(np.isfinite(f).all()), flux_sum=float(f.sum()), m1=_m1(f, bins.double().cpu().numpy()),
        binned_seconds=binned_s, binned_iterations=bsteps.iters, binned_graph=bsteps.graph,
        binned_flux_sum=float(fb.sum()), binned_m1=_m1(fb, bins.double().cpu().numpy()),
        vs_binning_method=_binwise_gap(f, fb, 1e-3),
    )
    _say("thick_disc", **res)
    if not (res["finite"] and abs(res["flux_sum"] - 1.0) <= 1e-4 and abs(res["binned_flux_sum"] - 1.0) <= 1e-4):
        raise AssertionError(f"thick-disc line profile: {res}")
    if num_re == 100 and N == 80 and not res["vs_binning_method"]["median_rel"] <= 5e-2:
        raise AssertionError(f"thick-disc line profile against the binned one: {res}")
    return res


# --- the lamp-post corona and the reverberation lags ------------------------------

LAG_X_OBS = [0.0, 1e4, math.radians(45.0), 0.0]
BINFLUX_X_OBS = [0.0, 1e6, math.radians(30.0), 0.0]
GRADUS_TAU_131 = 9.322742661315855
JAX_TAU_131 = 9.54984  # the JAX package's, through its default `xla` transfer functions
GRADUS_ROW_39 = 0.021759503160585468
JAX_ROW_39 = 0.0214131  # the JAX package's, through its default `xla` transfer functions
# the gap allowed to the JAX package's values (pinned to 6 digits): the CPU
# parity test of the pipeline (tests/test_torch_lag_frequency.py) holds the
# port's flux to the JAX package's at 1e-5 (measured 1.3e-7) and its lags
# at 1e-6
JAX_VALUE_RTOL = 1e-5


class _CallTimes:
    """Seconds (up to a synchronize) and lockstep iterations of each call of
    the functions ``names`` of ``module`` while it is entered, keyed by
    name: lists of ``{"seconds", "iterations"}``; their results in
    ``outputs`` and their arguments ``(args, kwargs)`` in ``inputs``, keyed
    likewise."""

    def __init__(self, module, *names):
        self.module, self.names, self.calls = module, names, {n: [] for n in names}
        self.outputs = {n: [] for n in names}
        self.inputs = {n: [] for n in names}

    def __enter__(self):
        self._fns = {n: getattr(self.module, n) for n in self.names}
        for name, fn in self._fns.items():

            def timed(*args, _fn=fn, _name=name, **kw):
                self.inputs[_name].append((args, kw))
                with _Lockstep() as steps:
                    out, seconds = _trace_seconds(lambda: _fn(*args, **kw))
                self.calls[_name].append(dict(seconds=seconds, iterations=steps.iters, traces=steps.calls))
                self.outputs[_name].append(out)
                return out

            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(self.module, name, fn)


def _lag_setup(dev, x_obs, dtype=torch.float64):
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    return m, torch.tensor(x_obs, dtype=dtype, device=dev)


def _slope(prof, r0, r1, dev):
    e = prof.emissivity_at(torch.tensor([r0, r1], dtype=torch.float64, device=dev)).cpu().numpy()
    return math.log(e[1] / e[0]) / math.log(r1 / r0)


def phase_emissivity(dev, n_sweep=1000, n_mc=2000):
    """`emissivity_profile(KerrMetric(1, 0.998), ThinDisc(0, ∞),
    LampPostModel(h=5))`, f64: the δ sweep at the default 1,000 samples,
    then the Monte-Carlo profile (`EvenSampler(BothHemispheres())`, 2,000
    samples); tests/test_corona.py's checks (ε(40)/ε(10) slope in (−3.6,
    −2.6) for the sweep and (−4, −2) for the Monte-Carlo profile, n > 100,
    ε ≥ 0, t(r) increasing and t(40) > 35); lockstep iterations, seconds and
    the device's busy share over 64 iterations from the 128th."""
    m, _ = _lag_setup(dev, LAG_X_OBS)
    d = ThinDisc(0.0, math.inf, device=dev)
    model = LampPostModel(h=5.0)
    res = {}
    with _NoKernelRoute(), _Lockstep(window=64, start=128) as steps:
        prof, seconds = _trace_seconds(lambda: emissivity_profile(m, d, model, n_samples=n_sweep))
    _require_captured("emissivity sweep", steps)
    n = int(prof.n)
    radii = torch.tensor([10.0, 20.0, 40.0], dtype=torch.float64, device=dev)
    t = prof.coordtime_at(radii).cpu().numpy()
    res["sweep"] = dict(
        samples=n_sweep, hits=n, seconds=seconds, iterations=steps.iters, busy_share=steps.busy_share(),
        busy_window=dict(iterations=64, from_iteration=128, busy_ms=steps.busy_ms, wall_ms=steps.wall_ms),
        slope_10_40=_slope(prof, 10.0, 40.0, dev), eps_min=float(prof.eps[:n].min()), t=t.tolist(),
    )
    r = res["sweep"]
    if not (-3.6 < r["slope_10_40"] < -2.6 and n > 100 and r["eps_min"] >= 0 and np.all(np.diff(t) > 0) and t[2] > 35.0):
        raise AssertionError(f"lamp-post emissivity profile: {r}")
    with _NoKernelRoute(), _Lockstep() as steps:
        mc, seconds = _trace_seconds(
            lambda: emissivity_profile(m, d, model, sampler=EvenSampler(domain=BothHemispheres()), n_samples=n_mc)
        )
    res["monte_carlo"] = dict(
        samples=n_mc, bins_filled=int(mc.n), seconds=seconds, iterations=steps.iters,
        slope_10_40=_slope(mc, 10.0, 40.0, dev),
    )
    if not -4.0 < res["monte_carlo"]["slope_10_40"] < -2.0:
        raise AssertionError(f"Monte-Carlo emissivity profile: {res['monte_carlo']}")
    _say("emissivity", **res)
    return res, prof


def _tfs_with_kernel(m, x, d, **kw):
    """`transferfunctions(..., backend="cuda")` once timed, with B1's
    launches, then once more under the profiler for the kernel's time and
    bound (`_kernel_counted`)."""
    before = cuda_solver.KERNEL_LAUNCHES
    tfs, seconds = _trace_seconds(lambda: transferfunctions(m, x, d, backend="cuda", **kw))
    launches = cuda_solver.KERNEL_LAUNCHES - before
    if launches == 0:
        raise AssertionError("the transfer functions did not go through the kernel")
    k = _kernel_counted(lambda: transferfunctions(m, x, d, backend="cuda", **kw), x.dtype, x.device)
    return tfs, dict(seconds=seconds, launches=launches, **k)


def phase_reverberation_golden(dev):
    """Gradus.jl's reverberation smoke test (test/smoke-tests/reverberation.jl)
    as tests/test_reverberation.py runs it, f64: a = 0.998, r = 10⁴, i = 45°,
    ThinDisc(0, ∞), `LampPostModel()`, radii `InverseGrid()(isco, 100, 10)`,
    β₀ = 2, 500 emissivity samples, 100 g and t bins; the transfer functions
    through B1 (`backend="cuda"`). Checks: 10005 < t₀ < 10030, Σflux = 1 at
    1e-8, Σfreq at 1e-6, τ[131] within 3e-2 of Gradus.jl's and within
    `JAX_VALUE_RTOL` of the JAX package's (through its `xla` transfer
    functions)."""
    m, x = _lag_setup(dev, LAG_X_OBS)
    d = ThinDisc(0.0, math.inf, device=dev)
    model = LampPostModel()
    radii = InverseGrid()(float(m.isco()), 100.0, 10, dtype=torch.float64, device=dev)
    tfs, ctf = _tfs_with_kernel(m, x, d, radii=radii, beta0=2.0)
    with _Lockstep() as steps:
        prof, prof_s = _trace_seconds(lambda: emissivity_profile(m, d, model, n_samples=500))
    prof_iters = steps.iters
    with _NoKernelRoute(), _Lockstep() as steps:
        t0, t0_s = _trace_seconds(lambda: continuum_time(m, x, model))
    _require_captured("continuum_time", steps)
    t0_graph = steps.graph
    bins = torch.linspace(0.0, 1.5, 100, dtype=torch.float64, device=dev)
    tbins = torch.linspace(0.0, 100.0, 100, dtype=torch.float64, device=dev)
    flux, integ_s = _trace_seconds(lambda: integrate_lagtransfer(prof, tfs, bins, tbins, t0=t0, n_radii=100))
    flux = torch.where(flux == 0, math.nan, flux)
    freq, tau = lag_frequency(tbins, flux)
    tau131 = float(tau[131])
    res = dict(
        t0=float(t0), t0_seconds=t0_s, t0_newton_iterations=steps.calls - 1, t0_lockstep_iterations=steps.iters,
        t0_ms_per_iteration=t0_s * 1e3 / max(steps.iters, 1), t0_graph=t0_graph,
        emissivity_seconds=prof_s, emissivity_iterations=prof_iters, integration_seconds=integ_s,
        transfer_functions=ctf, flux_sum=float(torch.nansum(flux)), freq_sum=float(freq.sum()), tau_131=tau131,
        tau_131_vs_gradus_rel=tau131 / GRADUS_TAU_131 - 1.0, tau_131_vs_jax_rel=tau131 / JAX_TAU_131 - 1.0,
        tau_131_within_jax_rtol=abs(tau131 / JAX_TAU_131 - 1.0) <= JAX_VALUE_RTOL,
    )
    if not (
        10005.0 < res["t0"] < 10030.0
        and abs(res["flux_sum"] - 1.0) <= 1e-8
        and math.isclose(res["freq_sum"], 2449.8787687490535, rel_tol=1e-6)
        and abs(res["tau_131_vs_gradus_rel"]) <= 3e-2
        and res["tau_131_within_jax_rtol"]
    ):
        raise AssertionError(f"reverberation golden: {res}")
    _say("reverberation_golden", **res)
    return res


def phase_lag_frequency_full(dev):
    """`lag_frequency(m, x, d, model, backend="cuda")` at the model
    dispatch's own defaults (100 radii, 1,000 emissivity samples, 6,000
    integration radii, 500 g bins, 2,000 t bins) for the golden's m, x, d
    and model, then the FFT dispatch on its flux. Checks: the flux finite
    where it is not NaN (zero), Σ = 1 at 1e-8; τ finite past the first bin;
    the mean τ over the 50 lowest frequencies > 0. Seconds split into
    emissivity, continuum time, transfer functions (under the profiler: B1's
    launches, counts, time and bound come from this run) and integration."""
    m, x = _lag_setup(dev, LAG_X_OBS)
    d = ThinDisc(0.0, math.inf, device=dev)
    before = cuda_solver.KERNEL_LAUNCHES
    with (
        _KernelCountedCalls(reverberation, "transferfunctions", torch.float64, dev) as tfs,
        _CallTimes(reverberation, "emissivity_profile", "continuum_time", "transferfunctions", "integrate_lagtransfer") as parts,
    ):
        (tbins, bins, flux), seconds = _trace_seconds(lambda: lag_frequency(m, x, d, LampPostModel(), backend="cuda"))
    launches = cuda_solver.KERNEL_LAUNCHES - before
    freq, tau = lag_frequency(tbins, flux)
    ok = ~torch.isnan(flux)
    low = tau[1:50]
    res = dict(
        seconds=seconds, launches=launches,
        split={k: v[0] for k, v in parts.calls.items()},
        shape=list(flux.shape), nonzero_bins=int(ok.sum()), flux_sum=float(torch.nansum(flux)),
        freq_bins=int(freq.shape[0]), tau_finite_past_first=bool(torch.isfinite(tau[1:]).all()),
        low_frequency_mean_tau=float(low.mean()),
    )
    res["continuum_newton_iterations"] = res["split"]["continuum_time"]["traces"] - 1
    (res["transfer_functions_kernel"],) = tfs.kernel
    if not (
        launches > 0
        and res["transfer_functions_kernel"]["counted_launches"] == launches
        and bool(torch.isfinite(flux[ok]).all())
        and abs(res["flux_sum"] - 1.0) <= 1e-8
        and res["tau_finite_past_first"]
        and res["low_frequency_mean_tau"] > 0
    ):
        raise AssertionError(f"lag_frequency at its defaults: {res}")
    _say("lag_frequency_full", **res)
    return res


def _binflux_sum(t, E, H):
    return float(torch.nansum(H)) * float(E[1] - E[0]) * float(t[1] - t[0])


def phase_binflux_golden(dev):
    """tests/test_binflux.py's configuration (Gradus.jl's test-2d.jl), f64:
    r = 10⁶, i = 30°, ThinDisc(isco, 500), `LampPostModel(h=10,
    theta=1e-3)`, a 20×20 geometric `PolarPlane`, 100 golden-spiral samples
    over both hemispheres, `binflux` at N_t = N_E = 100: 337 plane hits, 57
    coronal hits, Σ H·ΔE·Δt = 1 at 1e-8, fluxsum 4.34523 at atol 5e-3, E
    min/max 0.61679 / 6.70315 at rtol 1e-3. Then `lagtransfer` at its
    defaults (an 800×800 plane to r = 50, 10⁴ samples) and `binflux` at N =
    300: Σ H·ΔE·Δt = 1 at 1e-8, with seconds and lockstep iterations for each
    of its three traces."""
    m, x = _lag_setup(dev, BINFLUX_X_OBS)
    isco = float(m.isco())
    d = ThinDisc(isco, 500.0, device=dev)
    model = LampPostModel(h=10.0, theta=1e-3)
    plane = PolarPlane(GeometricGrid(), Nr=20, Ntheta=20, device=dev)
    sampler = EvenSampler(domain=BothHemispheres(), generator="golden")
    with _NoKernelRoute():
        tf, seconds = _trace_seconds(lambda: lagtransfer(m, x, d, model, plane=plane, n_samples=100, sampler=sampler))
    t, E, H = binflux(tf, N_t=100, N_E=100)
    res = dict(
        seconds=seconds, hits=int(tf["hit"].sum()), corona_n=int(tf["corona_n"]), norm=_binflux_sum(t, E, H),
        fluxsum=float(torch.nansum(H)), E_min=float(E.min()), E_max=float(E.max()),
    )
    if not (
        res["hits"] == 337
        and res["corona_n"] == 57
        and abs(res["norm"] - 1.0) <= 1e-8
        and abs(res["fluxsum"] - 4.34523) <= 5e-3
        and math.isclose(res["E_min"], 0.61679, rel_tol=1e-3)
        and math.isclose(res["E_max"], 6.70315, rel_tol=1e-3)
    ):
        raise AssertionError(f"binflux golden: {res}")
    with _NoKernelRoute(), _CallTimes(emissivity, "trace_geodesics") as a, _CallTimes(reverberation, "trace_geodesics") as b:
        tf, seconds = _trace_seconds(lambda: lagtransfer(m, x, d, model))
    traces = a.calls["trace_geodesics"] + b.calls["trace_geodesics"]
    (t, E, H), bin_s = _trace_seconds(lambda: binflux(tf, N_t=300, N_E=300))
    res["defaults"] = dict(
        seconds=seconds, binflux_seconds=bin_s, rays=int(tf["hit"].shape[0]), hits=int(tf["hit"].sum()),
        corona_n=int(tf["corona_n"]), norm=_binflux_sum(t, E, H),
        traces=dict(zip(("emissivity_sweep", "corona_samples", "plane"), traces)),
    )
    if len(traces) != 3 or abs(res["defaults"]["norm"] - 1.0) > 1e-8:
        raise AssertionError(f"lagtransfer at its defaults: {res['defaults']}")
    _say("binflux_golden", **res)
    return res


def phase_lagtransfer_semianalytic(dev):
    """tests/test_binflux.py:94-142 (Gradus.jl's test-2d.jl:35-64), f64:
    `integrate_lagtransfer` over 5 radii of `backend="cuda"` transfer
    functions with a 5,000-sample golden-spiral Monte-Carlo profile. Checks:
    Σflux within 1e-2 of 1, row 39 within 2.5e-2 of Gradus.jl's and within
    `JAX_VALUE_RTOL` of the JAX package's (through its `xla` transfer
    functions)."""
    m, x = _lag_setup(dev, BINFLUX_X_OBS)
    isco = float(m.isco())
    sampler = EvenSampler(domain=BothHemispheres(), generator="golden")
    with _Lockstep() as steps:
        prof, prof_s = _trace_seconds(
            lambda: emissivity_profile(m, ThinDisc(isco, 500.0, device=dev), LampPostModel(h=10.0, theta=1e-3),
                                       n_samples=5000, sampler=sampler)
        )
    radii = InverseGrid()(isco, 100.0, 5, dtype=torch.float64, device=dev)
    tfs, ctf = _tfs_with_kernel(m, x, ThinDisc(0.0, 500.0, device=dev), radii=radii)
    bins = torch.linspace(0.0, 1.5, 100, dtype=torch.float64, device=dev)
    tbins = torch.linspace(0.0, 150.0, 100, dtype=torch.float64, device=dev)
    flux = integrate_lagtransfer(prof, tfs, bins, tbins, t0=float(x[1]), n_radii=1000,
                                 rmin=float(radii[0]), rmax=float(radii[-1]))
    row39 = float(flux[39].sum())
    res = dict(
        emissivity_seconds=prof_s, emissivity_iterations=steps.iters, transfer_functions=ctf,
        flux_sum=float(flux.sum()), row_39=row39, row_39_vs_gradus_rel=row39 / GRADUS_ROW_39 - 1.0,
        row_39_vs_jax_rel=row39 / JAX_ROW_39 - 1.0,
        row_39_within_jax_rtol=abs(row39 / JAX_ROW_39 - 1.0) <= JAX_VALUE_RTOL,
    )
    if abs(res["flux_sum"] - 1.0) > 1e-2 or abs(res["row_39_vs_gradus_rel"]) > 2.5e-2 or not res["row_39_within_jax_rtol"]:
        raise AssertionError(f"semi-analytic lag transfer: {res}")
    _say("lagtransfer_semianalytic", **res)
    return res


def phase_profiled_lineprofile(dev, prof):
    """`lineprofile(m, x, d, profile=prof)` with phase `emissivity`'s
    lamp-post profile (its default method is `BinningMethod`), then with
    `method=TransferFunctionMethod(), backend="cuda"`, at the CTF line
    profile's configuration (i = 60°, ThinDisc(0, ∞), rₑ ∈ [isco + 1e-2,
    50], bins 0.1:1.5×180), f32 and f64. Checks: Σ = 1 ± 1e-4 for each, and
    the two methods bin by bin over the bins above 1e-3 of the peak (median
    relative difference ≤ 2%, as `binning_api` holds them for ε = r⁻³)."""
    res = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        m, x = _lag_setup(dev, CTF_X_OBS, dtype)
        d = ThinDisc(0.0, math.inf, dtype=dtype, device=dev)
        bins = torch.linspace(*CTF_BINS, dtype=dtype, device=dev)
        min_re = float(m.isco()) + 1e-2
        with _NoKernelRoute(), _Lockstep() as steps:
            fb, binned_s = _trace_seconds(lambda: lineprofile(m, x, d, bins=bins, profile=prof, min_re=min_re)[1])
        before = cuda_solver.KERNEL_LAUNCHES
        ft, ctf_s = _trace_seconds(
            lambda: lineprofile(m, x, d, bins=bins, profile=prof, method=TransferFunctionMethod(), backend="cuda")[1]
        )
        launches = cuda_solver.KERNEL_LAUNCHES - before
        kernel = _kernel_counted(
            lambda: lineprofile(m, x, d, bins=bins, profile=prof, method=TransferFunctionMethod(), backend="cuda"),
            dtype, dev,
        )  # fmt: skip
        fb, ft = fb.double().cpu().numpy(), ft.double().cpu().numpy()
        top = ft > 1e-3 * ft.max()
        r = dict(
            binned_seconds=binned_s, binned_iterations=steps.iters, ctf_seconds=ctf_s, ctf_launches=launches,
            ctf_kernel=kernel,
            binned_sum=float(fb.sum()), ctf_sum=float(ft.sum()), bins_compared=int(top.sum()),
            median_rel=float(np.median(np.abs(fb[top] - ft[top]) / ft[top])),
        )
        res[name] = r
        if launches == 0 or abs(r["binned_sum"] - 1.0) > 1e-4 or abs(r["ctf_sum"] - 1.0) > 1e-4 or not r["median_rel"] <= 2e-2:
            raise AssertionError(f"line profile with the lamp-post profile, {name}: {r}")
    _say("profiled_lineprofile", **res)
    return res


# --- the extended coronae: ring and disc -------------------------------------

EXTENDED_REFERENCE = Path(__file__).resolve().parent / "tests" / "data" / "extended_corona_reference.json"


def _extended_reference():
    """The JAX package's CPU values at the phases' configurations, and the
    tolerances (scripts/torch_extended_corona_reference.py)."""
    return json.loads(EXTENDED_REFERENCE.read_text())


def _held(got, want, rtol):
    """The largest relative gap of ``got`` to ``want``, and whether it is
    within ``rtol``."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
    return dict(gap=gap, rtol=rtol, ok=bool(gap <= rtol))


def _cell_set(depth, cx, cy):
    """The adaptive sky's cells as (depth, cosθ, φ) of their centres: the
    grid's numpy arithmetic is the same in both packages and on every
    platform, so a cell two runs both made is the same floats."""
    return set(zip(np.asarray(depth).tolist(), np.asarray(cx).tolist(), np.asarray(cy).tolist()))


def _numpy_fields(obj):
    """A (nested) dataclass of tensors as the dict of numpy arrays that
    `interop`'s `*_from_numpy` functions take."""
    return {
        f.name: _numpy_fields(v) if dataclasses.is_dataclass(v) else v.cpu().numpy()
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)
    }


# the card's time-dependent flux against the same integration on the CPU, as
# a share of the flux's largest bin (`index_add_` on the card accumulates in
# no fixed order)
FLUX_CPU_RTOL = 1e-12
def _timedep_flux_on_the_cpu(parts):
    """`integrate_lagtransfer_timedep` of the spectrum's own call rerun on
    the CPU, on its profile (a `NearFieldBlendedProfile`, through `interop`)
    and transfer functions moved there; the largest gap to the card's flux
    over the largest bin, and whether the two have the same empty bins."""
    (((prof, tfs, bins, tbins), kw),) = parts.inputs["integrate_lagtransfer_timedep"]
    (flux,) = parts.outputs["integrate_lagtransfer_timedep"]
    if not isinstance(prof, NearFieldBlendedProfile):
        raise AssertionError(f"the ring's default profile is a {type(prof).__name__}")
    cpu = dict(dtype=torch.float64, device="cpu")
    kw = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    ref, seconds = _trace_seconds(
        lambda: integrate_lagtransfer_timedep(
            near_field_profile_from_numpy(_numpy_fields(prof), **cpu),
            transfer_grid_from_numpy(_numpy_fields(tfs), **cpu),
            bins.cpu(), tbins.cpu(), **kw,
        )
    )
    flux = flux.cpu()
    gap = float((flux - ref).abs().max() / ref.abs().max())
    return dict(
        gap_over_max=gap, rtol=FLUX_CPU_RTOL, same_empty_bins=bool(torch.equal(flux == 0, ref == 0)),
        cpu_seconds=seconds, ok=bool(gap <= FLUX_CPU_RTOL and torch.equal(flux == 0, ref == 0)),
    )


def _sky_nodes_on_reference_cells(m, d, ref):
    """The JAX package's final sky cells (`tests/data/extended_corona_sky_cells.npz`)
    traced on the card by `CoronaSkyTracer` in one trace of 2N rays, against
    the port's values from the same cells on the CPU (in the same file): no
    refinement decision lies between them. A ray that grazes the horizon
    meets the disc and the hemisphere's edge at once, and ends as either by
    the last bits (the two packages' CPU rays end otherwise in
    `status_differing_from_jax` cells): the cells whose rays end otherwise
    are counted and held to ten times that; where they end alike, each
    value and the near-field nodes binned from either side's values (as
    the hybrid bins its own sky) are held at the reference's tolerances
    (`sky_values`, `sky_nodes_same_fate`: ten times the two packages' CPU
    gaps on these cells, at least 1e-9); the nodes of all the cells,
    against the JAX package's own, at `sky_nodes`."""
    cells = np.load(EXTENDED_REFERENCE.parent / ref["sky_cells"])
    grid = SimpleNamespace(**{k: cells[f"jax_{k}"] for k in ("cx", "cy", "w", "h", "depth")})
    cpu = {k.removeprefix("port_sky_"): cells[k] for k in cells.files if k.startswith("port_sky_")}
    fields = [k for k in cpu if k != "status"]
    cfg, sky = ref["config"], ref["ring"]["port_cpu_sky"]
    tracer = adaptive_module.CoronaSkyTracer(m, d, RingCorona(**cfg["ring"]))
    with _Lockstep() as steps:
        vals, seconds = _trace_seconds(lambda: tracer(grid.cx, grid.cy))
    _require_captured("the sky's reference cells", steps)

    def nodes(g, v):
        return extended_module._near_field_nodes(
            m, cfg["ring"]["r"], g, v, PowerLawSpectrum(2.0), cfg["near_outer"], cfg["n_r_nodes"]
        )[1:]

    same = vals["status"] == cpu["status"]
    sub = SimpleNamespace(**{k: v[same] for k, v in vars(grid).items()})
    hit = same & np.isfinite(cpu["r"])
    value_gaps = {
        k: float(np.nanmax(np.abs(vals[k][hit] - cpu[k][hit]) / np.maximum(np.abs(cpu[k][hit]), 1e-300)))
        for k in fields
    }
    nan_alike = all(bool(np.array_equal(np.isnan(vals[k][same]), np.isnan(cpu[k][same]))) for k in fields)
    eps, covered = nodes(grid, vals)
    on = np.asarray(sky["covered"])
    eps_same = nodes(sub, {k: v[same] for k, v in vals.items()})[0]
    eps_same_cpu = nodes(sub, {k: v[same] for k, v in cpu.items()})[0]
    flips = int((~same).sum())
    flip_limit = max(10 * sky["status_differing_from_jax"], 1)
    rtol = ref["ring"]["rtol"]
    return dict(
        cells=int(grid.cx.shape[0]), rays=2 * int(grid.cx.shape[0]), seconds=seconds, iterations=steps.iters,
        graph=steps.graph, status_differing_from_port_cpu=flips, status_limit=flip_limit,
        value_gaps_where_alike=value_gaps, nan_where_alike_as_on_cpu=nan_alike, covered_as_on_cpu=covered.tolist() == sky["covered"],
        value_rtol=rtol["sky_values"],
        nodes_where_alike_vs_port_cpu=_held(eps_same[on], eps_same_cpu[on], rtol["sky_nodes_same_fate"]),
        nodes_vs_port_cpu_gap=_held(eps[on], np.asarray(sky["eps_nodes"])[on], math.inf)["gap"],
        nodes_vs_jax=_held(eps[on], np.asarray(ref["ring"]["jax"]["near_field"]["eps_nodes"])[on], rtol["sky_nodes"]),
        ok=bool(
            flips <= flip_limit
            and nan_alike
            and max(value_gaps.values()) <= rtol["sky_values"]
            and covered.tolist() == sky["covered"]
        ),
    )


def _profile_at(prof, ref, part, dev):
    """ε at the reference's radii and `time_limits_at` at its three."""
    eps = prof.emissivity_at(torch.tensor(ref["eps_radii"][part], dtype=torch.float64, device=dev)).cpu().numpy()
    limits = [
        [float(v) for v in prof.time_limits_at(torch.tensor(r, dtype=torch.float64, device=dev))]
        for r in ref["limit_radii"]
    ]
    return eps, limits


def _against_reference(eps, limits, ref, part, near_field=None):
    """ε and the time limits against the JAX package's CPU values, at the
    reference's tolerances; with ``near_field`` the radii up to it are held
    at ``near_field``'s own tolerance."""
    r = ref[part]
    radii = np.asarray(ref["eps_radii"][part])
    out = dict(time_limits_vs_jax=_held(limits, r["jax"]["time_limits"], r["rtol"]["time_limits"]))
    far = radii > (near_field or (0.0, 0.0))[0]
    out["eps_far_vs_jax"] = _held(eps[far], np.asarray(r["jax"]["eps"])[far], r["rtol"].get("eps_far", r["rtol"]["eps"]))
    if near_field is not None:
        out["eps_near_vs_jax"] = _held(eps[~far], np.asarray(r["jax"]["eps"])[~far], near_field[1])
    return out


def phase_ring_corona(dev):
    """`lag_frequency(m, x, d, RingCorona(r=3, h=4), backend="cuda")` at its
    defaults for `_lag_setup`'s Kerr a = 0.998, `LAG_X_OBS` and ThinDisc(0,
    ∞), f64: the hybrid profile (20 slices × 256 angles and 16 + 2
    golden-section probe traces of 40 rays; the adaptive sky at n0 = 24, 5
    rounds of at most 256 splits, each round one trace of 2N rays with
    their tangents), the continuum time (8 dense traces of 81 rays, then 2
    forward-mode traces of 2 rays and one of 1), 100 transfer-function radii
    on B1 (under the profiler: B1's launches, counts, time and bound come
    from this run), and the time-dependent integration at 400 radii (the
    clamp), 500 g and 2,000 t bins. Timed by part, every lockstep loop
    captured; then `torch.func.jvp` of `refine_for_target`'s arrival time
    along the source's r, its loops captured within the transform. Checks:
    Σflux = 1 at 1e-8, the flux finite where not NaN, τ finite past the first
    bin and its mean over the 50 lowest frequencies > 0; the integration's
    flux against the same integration on the CPU (`_timedep_flux_on_the_cpu`);
    the profile the call built (ε at 12 radii, its time limits at 3) and t₀
    against the JAX package's CPU values (`EXTENDED_REFERENCE`), the near
    field (the adaptive sky's radial nodes) at its own tolerance, with the
    number of the sky's cells that differ from each package's on the CPU;
    and the near-field nodes of the JAX package's own cells
    (`_sky_nodes_on_reference_cells`)."""
    ref = _extended_reference()
    m, x = _lag_setup(dev, LAG_X_OBS)
    d = ThinDisc(0.0, math.inf, device=dev)
    before = cuda_solver.KERNEL_LAUNCHES
    names = ("emissivity_profile", "continuum_time", "transferfunctions", "integrate_lagtransfer_timedep")
    with (
        _KernelCountedCalls(reverberation, "transferfunctions", torch.float64, dev) as tfs,
        _CallTimes(reverberation, *names) as parts,
        _CallTimes(extended_module, "ring_corona_profile") as fan,
        _CallTimes(adaptive_module, "corona_adaptive_sky") as sky,
        _CallTimes(adaptive_module.CoronaSkyTracer, "__call__") as rounds,
        _Lockstep() as steps,
    ):
        (tbins, bins, flux), seconds = _trace_seconds(
            lambda: lag_frequency(m, x, d, RingCorona(r=3.0, h=4.0), backend="cuda")
        )
    _require_captured("ring_corona", steps)
    launches = cuda_solver.KERNEL_LAUNCHES - before
    prof, t0 = parts.outputs["emissivity_profile"][0], float(parts.outputs["continuum_time"][0])
    freq, tau = lag_frequency(tbins, flux)
    ok = ~torch.isnan(flux)
    grid = sky.outputs["corona_adaptive_sky"][0][0]
    cells = _cell_set(grid.depth, grid.cx, grid.cy)
    npz = np.load(EXTENDED_REFERENCE.parent / ref["sky_cells"])
    eps, limits = _profile_at(prof, ref, "ring", dev)
    near_rtol = ref["ring"]["rtol"]["eps_near"]
    branch_n = [prof.fan.left.n.tolist(), prof.fan.right.n.tolist()]
    (tfs_kernel,) = tfs.kernel
    res = dict(
        seconds=seconds, launches=launches, iterations=steps.iters, loops=steps.calls,
        forward_mode_loops=steps.tangent_calls, graph=steps.graph,
        split={k: v[0] for k, v in parts.calls.items()},
        fan=fan.calls["ring_corona_profile"][0],
        adaptive_sky=dict(
            **sky.calls["corona_adaptive_sky"][0], cells=len(cells),
            rays_per_round=[2 * int(v["r"].shape[0]) for v in rounds.outputs["__call__"]],
            round_seconds=[c["seconds"] for c in rounds.calls["__call__"]],
            **{
                f"cells_differing_from_{pkg}_cpu": len(cells ^ _cell_set(npz[f"{pkg}_depth"], npz[f"{pkg}_cx"], npz[f"{pkg}_cy"]))
                for pkg in ("jax", "port")
            },
        ),
        fan_branch_counts_equal_jax_cpu=branch_n == ref["ring"]["jax"]["branch_n"],
        fan_branch_counts_equal_port_cpu=branch_n == ref["ring"]["port_cpu"]["branch_n"],
        shape=list(flux.shape), nonzero_bins=int(ok.sum()), flux_sum=float(torch.nansum(flux)),
        tau_finite_past_first=bool(torch.isfinite(tau[1:]).all()), low_frequency_mean_tau=float(tau[1:50].mean()),
        flux_vs_cpu=_timedep_flux_on_the_cpu(parts),
        eps=eps.tolist(), time_limits=limits, t0=t0,
        eps_vs_port_cpu_gap=_held(eps, ref["ring"]["port_cpu"]["eps"], math.inf)["gap"],
        t0_vs_jax=_held([t0], [ref["ring"]["jax"]["continuum_time"]], ref["ring"]["rtol"]["continuum_time"]),
        **_against_reference(eps, limits, ref, "ring", near_field=(ref["config"]["ring_near_field"], near_rtol)),
        transfer_functions_kernel=tfs_kernel,
    )
    res["continuum_newton_traces"] = res["split"]["continuum_time"]["traces"]
    res["sky_nodes_on_jax_cells"] = _sky_nodes_on_reference_cells(m, d, ref)
    # ∂t₀/∂r of the source by `torch.func.jvp` around `refine_for_target`:
    # the traces run inside its autograd.Function's forward, on plain
    # tensors, so they replay captured graphs within the transform
    src = RingCorona(r=3.0, h=4.0).sample_position_velocity(m)[0][1:4]
    ab0 = torch.tensor(ref["ring"]["jax"]["ring_ab"], dtype=torch.float64, device=dev)
    with _Lockstep() as steps:
        (t_ref, dt_dr), jvp_s = _trace_seconds(
            lambda: torch.func.jvp(
                lambda p: targets_module.refine_for_target(p, m, x, ab0, iters=2)[1], (src,), (torch.eye(3, dtype=torch.float64, device=dev)[0],)
            )
        )
    _require_captured("torch.func.jvp of refine_for_target", steps)
    res["t0_jvp"] = dict(dt0_dr=float(dt_dr), t0=float(t_ref), seconds=jvp_s, loops=steps.calls, graph=steps.graph)
    _say("ring_corona", **res)
    checks = ("t0_vs_jax", "time_limits_vs_jax", "eps_far_vs_jax", "eps_near_vs_jax", "flux_vs_cpu")
    nodes = res["sky_nodes_on_jax_cells"]
    if not (
        launches > 0
        and tfs_kernel["counted_launches"] == launches
        and bool(torch.isfinite(flux[ok]).all())
        and abs(res["flux_sum"] - 1.0) <= 1e-8
        and res["tau_finite_past_first"]
        and res["low_frequency_mean_tau"] > 0
        and all(res[k]["ok"] for k in checks)
        and nodes["ok"] and nodes["nodes_where_alike_vs_port_cpu"]["ok"] and nodes["nodes_vs_jax"]["ok"]
        and math.isfinite(res["t0_jvp"]["dt0_dr"])
    ):
        raise AssertionError(f"ring corona lag spectrum: {res}")
    return res


def _disc_lags_grow_with_radius(dev):
    """tests/test_extended_corona.py:196-236 at that test's size (Kerr a =
    0.5, r = 1000, i = 45°, ThinDisc(0, 100); 5 transfer-function radii on
    B1; disc coronae of 3 rings × 4 slices × 64 angles, delays 2r; 40 g and
    128 t bins): Σflux = 1 at 1e-6 for each, and the mean echo lag and the
    low-frequency lag grow from r = 2 to r = 10."""
    m = KerrMetric(1.0, 0.5, dtype=torch.float64, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(45.0), 0.0], dtype=torch.float64, device=dev)
    d = ThinDisc(0.0, 100.0, device=dev)
    radii = LinearGrid()(float(m.isco()) + 1e-2, 30.0, 5, dtype=torch.float64, device=dev)
    tfs = transferfunctions(m, x, d, radii=radii, N=12, N_extrema=5, Ng=24, backend="cuda")
    bins = torch.linspace(0.0, 1.5, 40, dtype=torch.float64, device=dev)
    tbins = torch.linspace(0.0, 200.0, 128, dtype=torch.float64, device=dev)
    res = {}
    for rc in (2.0, 10.0):
        prof = emissivity_profile(m, d, DiscCorona(r=rc, h=4.0), n_rings=3, n_beta=4, n_angles=64)
        prof = prof.with_propagation_velocity(lambda r: 2.0 * r)
        flux = integrate_lagtransfer_timedep(prof, tfs, bins, tbins, t0=1000.0, n_radii=60, n_time=24)
        psi = torch.nansum(flux, dim=0)
        freq, tau = lag_frequency(tbins, flux)
        low = (freq > 0) & (freq < 2e-3)
        res[str(rc)] = dict(
            flux_sum=float(torch.nansum(flux)), mean_lag=float((tbins * psi).sum() / psi.sum()),
            low_frequency_tau=float(torch.nanmean(tau[low])),
        )
    a, b = res["2.0"], res["10.0"]
    res["ok"] = bool(
        all(abs(r["flux_sum"] - 1.0) <= 1e-6 for r in (a, b))
        and b["mean_lag"] > a["mean_lag"] + 1.0
        and b["low_frequency_tau"] > a["low_frequency_tau"] > 0
    )
    return res


def phase_disc_corona(dev):
    """`emissivity_profile(m, d, DiscCorona(r=10, h=4))` at its defaults for
    `_lag_setup`'s Kerr a = 0.998 and ThinDisc(0, ∞), f64: 10 rings × 20
    slices × 256 angles, 51,200 rays in one trace, then 16 + 2
    golden-section probe traces of the rings' 400 rays; every loop
    captured; ε at 12 radii and the time limits at 3 against the JAX
    package's CPU values; each loop's iterations and seconds. Then the
    reference's physics check at its own size (`_disc_lags_grow_with_radius`)."""
    ref = _extended_reference()
    m, _ = _lag_setup(dev, LAG_X_OBS)
    d = ThinDisc(0.0, math.inf, device=dev)
    with _Lockstep() as steps:
        prof, seconds = _trace_seconds(lambda: emissivity_profile(m, d, DiscCorona(r=10.0, h=4.0)))
    _require_captured("disc_corona", steps)
    eps, limits = _profile_at(prof, ref, "disc", dev)
    branch_n = [prof.rings.left.n.tolist(), prof.rings.right.n.tolist()]
    fan_loop, probes = steps.loops[0], steps.loops[1:]
    res = dict(
        seconds=seconds, rays=10 * 20 * 256, iterations=steps.iters, loops=steps.calls, graph=steps.graph,
        fan=dict(**fan_loop, ms_per_iteration=fan_loop["seconds"] * 1e3 / max(fan_loop["iterations"], 1)),
        probes=dict(
            traces=len(probes), rays=10 * 2 * 20, iterations=sum(p["iterations"] for p in probes),
            seconds=sum(p["seconds"] for p in probes),
        ),
        eps=eps.tolist(), time_limits=limits, **_against_reference(eps, limits, ref, "disc"),
        eps_vs_port_cpu_gap=_held(eps, ref["disc"]["port_cpu"]["eps"], math.inf)["gap"],
        # the arms split on near-equal radii: the branch counts of the two
        # packages differ on the CPU already
        branch_counts_equal=dict(
            jax_cpu=branch_n == ref["disc"]["jax"]["branch_n"], port_cpu=branch_n == ref["disc"]["port_cpu"]["branch_n"]
        ),
    )
    res["probes"]["ms_per_iteration"] = res["probes"]["seconds"] * 1e3 / max(res["probes"]["iterations"], 1)
    res["lags_grow_with_radius"], res["lags_seconds"] = _trace_seconds(lambda: _disc_lags_grow_with_radius(dev))
    _say("disc_corona", **res)
    if not (res["time_limits_vs_jax"]["ok"] and res["eps_far_vs_jax"]["ok"] and res["lags_grow_with_radius"]["ok"]):
        raise AssertionError(f"disc corona: {res}")
    return res


# --- the special traces on the lockstep solver (`TRACES`) ---------------------------
#
# Each phase runs its product at full size on the card (every loop captured)
# and returns its result with a check of 512 of its rays against the same
# call on CPU tensors. The CPU's side is the worker ``traces_cpu``
# (`phase_cpu_subsets`), which makes the same inputs on the CPU and runs
# beside the other workers, so that the CPU's time does not hold the card.

TRACES_SIDE = 1024
TRACES_SUBSET = 512
SLAB_MAX_STEPS = 1000
# the radiative transfer's captured loop against the uncaptured one runs
# this many iterations (an uncaptured iteration costs ~70 ms)
SLAB_GRAPH_AB_STEPS = 160
TRACES_CHART_OUTER = 1100.0
MESH_SIDE = 128
MESH_N_PHI = 64
# The f32 mesh trace runs on every MESH_F32_STRIDE-th pixel of the
# MESH_SIDE² grid (4,096 rays); away from the rims it may lose no disc hit:
# the full f32 image at 256² lost none (on an H100, PERF.md §5).
MESH_F32_STRIDE = 4
MESH_F32_OFF_RIM_LOSSES = 0
# The first-order tracer's hits inside r = 3.8, where its gap to the
# second-order trace grows in both packages (scripts/torch_reference_witness.py
# first_order, CPU, f64): the share beyond 5e-3 (the JAX package's 60% at
# 64², 58% at 128²) and the largest gap (the JAX package's on the card's 8
# worst rays 0.119–0.127, the card's within 2e-4 of it).
FIRST_ORDER_NEAR_HOLE_SHARE = 0.65
FIRST_ORDER_NEAR_HOLE_GAP = 0.13


class _EmittingSlab(AbstractThickAccretionDisc):
    """Top-hat emitting slab |z| < 1 between ρ ∈ [8, 12], j_ν = 1
    (tests/test_rt_windings.py:30-40), optically thick."""

    def __init__(self, inner_r=8.0, outer_r=12.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._buffers_from(dtype, device, inner_r=inner_r, outer_r=outer_r)

    def cross_section(self, rho):
        return torch.where((rho > self.inner_r) & (rho < self.outer_r), 1.0, -1.0)

    def emission_coefficient(self, x4, nu):
        return torch.ones(x4.shape[:-1], dtype=x4.dtype, device=x4.device)


def _annulus_triangles(n_phi=96, r_in=6.0, r_out=50.0):
    """A triangulated annulus r_in ≤ ρ ≤ r_out in the equatorial plane:
    ``n_phi`` quads of two triangles, each front-facing upward (the JSF
    test is one-sided) and once more reversed, facing down: (4·n_phi, 3, 3)."""
    phi = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    ring = lambda r: np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros_like(phi)], -1)
    inner, outer = ring(r_in), ring(r_out)
    k = np.arange(n_phi)
    up = np.concatenate(
        [np.stack([inner[k], outer[k], outer[k + 1]], 1), np.stack([inner[k], outer[k + 1], inner[k + 1]], 1)]
    )
    normal_z = np.cross(up[:, 0] - up[:, 2], up[:, 1] - up[:, 2])[:, 2]
    up = np.where((normal_z > 0)[:, None, None], up, up[:, [1, 0, 2]])
    return np.concatenate([up, up[:, [1, 0, 2]]])


def _shared_edge_distance(rho, phi, n_phi, r_in=6.0, r_out=50.0):
    """Distance in the plane from each (ρ, φ) (numpy arrays) to the nearest
    edge that two triangles of `_annulus_triangles` share: the radial edges
    between quads and each quad's diagonal."""
    ang = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    p = np.stack([rho * np.cos(phi), rho * np.sin(phi)], -1)[..., None, :]
    ring = lambda r: np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    k = np.arange(n_phi)
    a = np.concatenate([ring(r_in)[k], ring(r_in)[k]])
    b = np.concatenate([ring(r_out)[k], ring(r_out)[k + 1]])
    t = np.clip(np.sum((p - a) * (b - a), -1) / np.sum((b - a) ** 2, -1), 0.0, 1.0)
    return np.linalg.norm(a + t[..., None] * (b - a) - p, axis=-1).min(-1)


def _mesh_args(n_phi=None):
    """`MeshAccretionGeometry`'s arguments for the annulus of ``n_phi``
    quads: its bounding box widened by 10 and ``proximity2`` the square of
    its largest triangle's size plus 10."""
    tri = _annulus_triangles(MESH_N_PHI if n_phi is None else n_phi)
    size = max(np.linalg.norm(tri[:, i] - tri[:, j], axis=-1).max() for i, j in ((0, 1), (0, 2), (1, 2)))
    flat = tri.reshape(-1, 3)
    return dict(triangles=tri, bbox_min=flat.min(0) - 10.0, bbox_max=flat.max(0) + 10.0, proximity2=(size + 10.0) ** 2)


def _traces_rays(dtype, dev, side, metric=None, outer_r=50.0):
    """The flagship camera at side² pixels (`_pixel_grid`): (metric, disc or
    None, x, v, A, B)."""
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev) if metric is None else metric
    d = None if outer_r is None else ThinDisc(0.0, outer_r, dtype=dtype, device=dev)
    x = torch.tensor(X_OBS, dtype=dtype, device=dev)
    A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, dtype, dev)
    return m, d, x, map_impact_parameters(m, x, A, B), A, B


_SCALAR_TRACES = {}


def _flagship_scalar_trace(dev, side):
    """The second-order f64 trace of side² flagship pixels against
    ThinDisc(0, 50) with the scalar chart (chart_outer `TRACES_CHART_OUTER`):
    (points, its record), traced once for `phase_shaped_chart` and
    `phase_first_order`, which both compare against it."""
    if side not in _SCALAR_TRACES:
        m, d, x, v, _, _ = _traces_rays(torch.float64, dev, side)
        _SCALAR_TRACES[side] = _lockstep_run(
            "second-order scalar-chart trace",
            lambda: trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d, chart_outer=TRACES_CHART_OUTER),
        )
    return _SCALAR_TRACES[side]


def _subset(n, k=TRACES_SUBSET):
    """``k`` pixel indices spread evenly over ``n`` (raster order), on the CPU."""
    return torch.linspace(0, n - 1, k, dtype=torch.float64).round().long()


def _slab_subset(side):
    """The radiative transfer's CPU subset: 512 pixels spread evenly over
    those whose image-plane ellipse radius √(α² + (β/cos i)²) lies in
    [7, 13], the slab's image (on the CPU)."""
    A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, torch.float64, "cpu")
    ell = torch.sqrt(A * A + (B / math.cos(X_OBS[2])) ** 2)
    band = torch.nonzero((ell >= 7.0) & (ell <= 13.0)).flatten()
    return band[_subset(len(band))]


def _lockstep_run(what, fn):
    """fn() on the card with every lockstep loop captured (`_require_captured`),
    and no route to the integrator kernel: (output, its seconds, lockstep
    loops and iterations, ms an iteration and graph counters)."""
    with _NoKernelRoute(), _Lockstep() as steps:
        out, seconds = _trace_seconds(fn)
    _require_captured(what, steps)
    rec = dict(
        seconds=seconds, loops=steps.calls, iterations=steps.iters,
        ms_per_iteration=seconds * 1e3 / max(steps.iters, 1), graph=steps.graph,
    )
    return out, rec


def _numpy_points(gp):
    return {k: getattr(gp, k).cpu().numpy() for k in ("status", "x", "v", "lam_max") if getattr(gp, k) is not None} | (
        {} if gp.aux is None else {"aux": gp.aux.cpu().numpy()}
    )


def _cpu_inputs(kind):
    """The inputs of CPU subset ``kind``, made on the CPU as its phase makes
    them on the card: numpy arrays."""
    cpu = torch.device("cpu")
    if kind == "charged":
        m = KerrNewmanMetric(1.0, 0.5, 0.3, device=cpu)
        half = CHARGED_PARTICLES // 2
        idx = _subset(half, TRACES_SUBSET // 2)
        starts = [_charged_orbits(m, half, s) for s in (CHARGED_Q, -CHARGED_Q)]
        return dict(
            x=torch.cat([x[idx] for x, _ in starts]).numpy(), v=torch.cat([v[idx] for _, v in starts]).numpy(),
            q=np.repeat([CHARGED_Q, -CHARGED_Q], len(idx)),
        )
    dtype = torch.float32 if kind == "chart_jp" else torch.float64
    metric = JohannsenPsaltisMetric(1.0, 0.6, 2.0, dtype=dtype, device=cpu) if kind == "chart_jp" else None
    side = MESH_SIDE if kind == "mesh" else TRACES_SIDE
    m, _, x, v, _, _ = _traces_rays(dtype, cpu, side, metric=metric)
    idx = _slab_subset(side) if kind == "radiative_transfer" else _subset(side * side)
    a = dict(x=x.expand_as(v)[idx].numpy(), v=v[idx].numpy())
    if kind.startswith("chart"):
        chart = event_horizon_chart(m)
        a.update(rs=chart.rs.numpy(), thetas=chart.thetas.numpy())
    if kind == "mesh":
        a.update(_mesh_args())
    return a


def _cpu_trace(kind, a):
    """The CPU side of a phase: the same call as on the card, on CPU
    tensors, for the subset's inputs ``a`` (numpy arrays); returns its
    points as numpy arrays."""
    cpu = dict(device="cpu")
    dt = torch.float32 if kind == "chart_jp" else torch.float64
    kw = dict(dtype=dt, **cpu)
    x, v = torch.as_tensor(a["x"]), torch.as_tensor(a["v"])
    if kind == "first_order":
        m = metrics.KerrSpacetimeFirstOrder(1.0, 0.998, **kw)
        out = trace_geodesics_first_order(m, x, v, SPAN, geometry=ThinDisc(0.0, 50.0, **kw), chart_outer=TRACES_CHART_OUTER)
    elif kind in ("chart_kerr", "chart_jp"):
        m = KerrMetric(1.0, 0.998, **kw) if kind == "chart_kerr" else JohannsenPsaltisMetric(1.0, 0.6, 2.0, **kw)
        chart = PoloidalShape(torch.as_tensor(a["rs"]), torch.as_tensor(a["thetas"]))
        out = trace_geodesics(
            m, x, v, SPAN, geometry=ThinDisc(0.0, 50.0, **kw), chart_inner=chart, chart_outer=TRACES_CHART_OUTER
        )
    elif kind == "windings":
        gp, w = trace_windings(KerrMetric(1.0, 0.998, **kw), x, v, SPAN)
        return dict(_numpy_points(gp), windings=w.numpy())
    elif kind == "radiative_transfer":
        out = trace_radiative_transfer(
            KerrMetric(1.0, 0.998, **kw), x, v, SPAN, geometry=_EmittingSlab(**kw), max_steps=SLAB_MAX_STEPS
        )
    elif kind == "charged":
        m = KerrNewmanMetric(1.0, 0.5, 0.3, **kw)
        q = torch.as_tensor(a["q"])
        parts = [_charged_legs(m, x[q == s], v[q == s], s)[0] for s in (CHARGED_Q, -CHARGED_Q)]
        out = SimpleNamespace(**{k: torch.cat([getattr(p, k) for p in parts]) for k in ("status", "x", "v", "lam_max")}, aux=None)
    elif kind == "mesh":
        mesh = MeshAccretionGeometry(a["triangles"], a["bbox_min"], a["bbox_max"], float(a["proximity2"]), **kw)
        out = trace_geodesics(KerrMetric(1.0, 0.998, **kw), x, v, SPAN, geometry=mesh)
    else:
        raise ValueError(kind)
    return _numpy_points(out)


CPU_SUBSETS = ("charged", "chart_kerr", "chart_jp", "first_order", "windings", "radiative_transfer", "mesh")


def phase_cpu_subsets(dev=None):
    """Each of `CPU_SUBSETS` on the CPU, in one thread: {kind: its points
    as lists, and its ``cpu_seconds``} (the worker ``traces_cpu``)."""
    torch.set_num_threads(1)
    out = {}
    for kind in CPU_SUBSETS:
        t0 = time.perf_counter()
        pts = _cpu_trace(kind, _cpu_inputs(kind))
        out[kind] = {k: np.asarray(a).tolist() for k, a in pts.items()} | dict(cpu_seconds=time.perf_counter() - t0)
    return out


def _status_agreement(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return dict(rays=int(a.size), agree=float((a == b).mean()), differ=int((a != b).sum()))


def phase_first_order(dev):
    """`trace_geodesics_first_order(KerrSpacetimeFirstOrder(a = 0.998), ...)`
    at TRACES_SIDE² flagship pixels (ThinDisc(0, 50), λ ≤ 2200, chart_outer
    1100) against the port's second-order `trace_geodesics(KerrMetric(a =
    0.998), ...)` on the same rays (`_flagship_scalar_trace`, shared with
    `phase_shaped_chart`): statuses equal on ≥ 99.5% of pixels (the number
    that differ printed); hit r and t within 5e-3 relative
    (tests/test_first_order.py's rtol) on ≥ 99.9% of the hits at r ≥ 3.8,
    the smallest hit radius of that test's rays. Nearer the hole the
    first-order form departs further from the second-order one in the JAX
    package too (scripts/torch_reference_witness.py first_order: at 128² on
    the CPU, 170 of its 295 hits inside r = 3.8 beyond 5e-3 in both
    packages, the largest gap 0.106, the two packages' gaps on those rays
    within 1.6e-4 of each other), so there the share beyond 5e-3 and the
    largest gap are held to `FIRST_ORDER_NEAR_HOLE_SHARE` and
    `FIRST_ORDER_NEAR_HOLE_GAP`, set from the JAX package's, and the worst
    rays printed. The CPU subset
    (512 rays): statuses equal on ≥ 99%, hit r and t within 1e-5 relative
    (the two packages' CPU gap, tests/test_torch_first_order_rt.py: 1.6e-6).

    In f64, not f32: in f32 the second-order form in Mino time does not
    keep the radial constraint p_r² = R(r) — R spans ~10¹² at r = 1000 and
    ~1 near the hole, so its f32 rounding far out swamps it near the hole —
    and on the CPU at 48² half the statuses then differ from the
    second-order trace's (1,167 of 2,304; 160 lockstep iterations)."""
    dtype, side = torch.float64, TRACES_SIDE
    m, d, x, v, A, B = _traces_rays(dtype, dev, side)
    mfo = metrics.KerrSpacetimeFirstOrder(1.0, 0.998, dtype=dtype, device=dev)
    xs = x.expand_as(v)
    idx = _subset(v.shape[0])
    fo, fo_rec = _lockstep_run(
        "first_order",
        lambda: trace_geodesics_first_order(mfo, xs, v, SPAN, geometry=d, chart_outer=TRACES_CHART_OUTER),
    )
    so, so_rec = _flagship_scalar_trace(dev, side)
    hit = (fo.status == HIT) & (so.status == HIT)
    far, near = hit & (so.x[:, 1] >= 3.8), hit & (so.x[:, 1] < 3.8)
    rel = {k: _rel(fo.x[:, i], so.x[:, i]) for k, i in (("t", 0), ("r", 1))}
    gap = torch.maximum(rel["r"], rel["t"])
    over = gap > 5e-3
    far_over = torch.nonzero(over & far).flatten()
    near_i = torch.nonzero(near).flatten()
    worst_near = near_i[gap[near_i].argsort(descending=True)[:8]]
    res = dict(
        pixels=side * side, dtype="f64", first_order=fo_rec, second_order=so_rec,
        status=_status_agreement(fo.status.cpu(), so.status.cpu()), hits=int(hit.sum()), hits_r_ge_3_8=int(far.sum()),
        hit_r_max_rel=float(rel["r"][far].max()), hit_t_max_rel=float(rel["t"][far].max()),
        hit_r_median_rel=float(rel["r"][hit].median()),
        hits_r_ge_3_8_over_5e_3=dict(
            count=len(far_over), share=len(far_over) / max(int(far.sum()), 1),
            worst=[dict(r_second_order=float(so.x[i, 1]), r_first_order=float(fo.x[i, 1]), rel=float(rel["r"][i]))
                   for i in far_over[rel["r"][far_over].argsort(descending=True)[:10]].tolist()],
        ),
        hits_inside_3_8=dict(
            count=len(near_i), over_5e_3=int(over[near].sum()),
            share_over_5e_3=int(over[near].sum()) / max(len(near_i), 1),
            gap_max=float(gap[near].max()) if len(near_i) else 0.0,
            gap_median=float(gap[near].median()) if len(near_i) else 0.0,
            worst=[dict(alpha=float(A[i]), beta=float(B[i]), r_second_order=float(so.x[i, 1]), gap=float(gap[i]))
                   for i in worst_near.tolist()],
        ),
        held_inside_3_8=dict(share=FIRST_ORDER_NEAR_HOLE_SHARE, gap=FIRST_ORDER_NEAR_HOLE_GAP),
    )
    _say("first_order", **res)
    inside = res["hits_inside_3_8"]
    if not (res["status"]["agree"] >= 0.995 and res["hits_r_ge_3_8_over_5e_3"]["share"] <= 1e-3):
        raise AssertionError(f"first-order tracer against the second-order one: {res}")
    if not (inside["share_over_5e_3"] <= FIRST_ORDER_NEAR_HOLE_SHARE and inside["gap_max"] <= FIRST_ORDER_NEAR_HOLE_GAP):
        raise AssertionError(f"first-order tracer against the second-order one inside r = 3.8: {res}")
    card = dict(status=fo.status[idx].cpu().numpy(), x=fo.x[idx].cpu().numpy())

    def against_cpu(sub):
        fs, ss = card["status"], sub["status"]
        both = (fs == HIT) & (ss == HIT)
        gx = card["x"]
        cpu_rel = float((np.abs(gx[both, :2] - sub["x"][both, :2]) / np.abs(sub["x"][both, :2])).max()) if both.any() else 0.0
        res["cpu_subset"] = dict(status=_status_agreement(fs, ss), hits=int(both.sum()), hit_tr_max_rel=cpu_rel,
                                 cpu_seconds=sub["cpu_seconds"])
        if not (res["cpu_subset"]["status"]["agree"] >= 0.99 and cpu_rel <= 1e-5):
            raise AssertionError(f"first-order tracer against the CPU: {res}")
        return res["cpu_subset"]

    return res, {"first_order": against_cpu}


def phase_windings(dev):
    """`trace_windings` at TRACES_SIDE² flagship pixels without a disc
    (f64, λ ≤ 2200): the histogram of winding counts; the outer pixels (α²
    + β² ≥ 400) wind exactly once (tests/test_rt_windings.py's wide ray),
    and some pixels near the shadow's rim (α² + β² < 400) wind ≥ 2 times
    (its near-critical ray). The CPU subset (512 rays): counts equal on ≥
    99.9%, the rays that differ printed (grazing the photon ring).

    In f64, not f32: in f32 the loop runs 3,008 iterations here (on an
    H100, 37 s alone), in f64 ~4× fewer (432 against 1,872 at 24² on
    the CPU; the JAX package's loop counts 430 against 1,689,
    scripts/torch_reference_witness.py iterations), at under twice the
    cost each: half the card time, which the script's time limit needs."""
    dtype, side = torch.float64, TRACES_SIDE
    m, _, x, v, A, B = _traces_rays(dtype, dev, side, outer_r=None)
    xs = x.expand_as(v)
    idx = _subset(v.shape[0])
    (gp, w), rec = _lockstep_run("windings", lambda: trace_windings(m, xs, v, SPAN))
    outer = A * A + B * B >= 400.0
    res = dict(
        pixels=side * side, dtype="f64", **rec, histogram=torch.bincount(w.long()).tolist(),
        outer_pixels=int(outer.sum()), outer_not_one=int((w[outer] != 1).sum()),
        two_or_more=int((w >= 2).sum()), two_or_more_outside_r20=int(((w >= 2) & outer).sum()),
    )
    _say("windings", **res)
    if res["outer_not_one"] or not res["two_or_more"]:
        raise AssertionError(f"trace_windings: {res}")
    wc, Ai, Bi = w[idx].cpu().numpy(), A[idx].cpu().numpy(), B[idx].cpu().numpy()

    def against_cpu(sub):
        ws = sub["windings"]
        differ = np.nonzero(wc != ws)[0]
        res["cpu_subset"] = dict(
            rays=len(wc), agree=float((wc == ws).mean()), cpu_seconds=sub["cpu_seconds"],
            differing=[dict(alpha=float(Ai[i]), beta=float(Bi[i]), card=int(wc[i]), cpu=int(ws[i])) for i in differ],
        )
        if res["cpu_subset"]["agree"] < 0.999:
            raise AssertionError(f"trace_windings against the CPU: {res}")
        return res["cpu_subset"]

    return res, {"windings": against_cpu}


def phase_radiative_transfer(dev):
    """`trace_radiative_transfer` at TRACES_SIDE² flagship pixels (λ ≤ 2200)
    through an optically thick emitter, `_EmittingSlab` (a top-hat slab
    |z| < 1 between ρ ∈ [8, 12], j_ν = 1, as tests/test_rt_windings.py's):
    a ray that never counts a crossing keeps I = I0 exactly; a ray with an
    even count ≥ 2 (in and out again) has I > I0; some do. A ray with an
    odd count meets the reference's fault (ROADMAP C): the count misses a
    crossing of the slab's vertical walls, where the top-hat indicator
    jumps, and the second of two crossings in one step, so the in/out
    parity inverts and emission is integrated outside the slab; such a ray
    falling into the hole stalls, so the loop is capped at
    `SLAB_MAX_STEPS` iterations (on an H100: 6,500 rays, every one
    with an odd count, still alive after 3,000; at a cap of 1,000, those
    and 2 rays with no count, at r = 1.083 by the horizon; at 700, also
    rays still climbing past a pole, r up to 84): every ray the cap stops
    with an even count must be one still by the hole (r < 10 at the cap).
    Those rays are counted and printed. The captured loop against
    `cuda_graphs(False)`, bit for bit, on 256 of the rays with an even
    count ≥ 2, over their first `SLAB_GRAPH_AB_STEPS` iterations.

    The CPU subset (`_slab_subset`): the counts equal on ≥ 90%, and where
    they are equal and even, I within a median relative gap of 5e-3, the
    largest printed. The count and I follow the step sequence (a crossing
    is counted at the end of its step, so I is integrated from step end to
    step end), and the two devices' sequences part by rounding: on the
    CPU, the same rays with v scaled by 1 + 1e-15 keep 91.7% of their
    counts and a median gap of 6.6e-4 (the largest 4.9e-2).

    In f64, not f32: in f32 the step sequences part from the first steps
    (the error estimate is rounding), so the card and the CPU integrate
    over different stretches of the slab (on an H100: 11 of 512
    counts and the one comparable intensity 20% apart), and the stalled
    rays' loop needs ~1,700 iterations (against ~500 in f64)."""
    dtype, side = torch.float64, TRACES_SIDE
    m, _, x, v, A, B = _traces_rays(dtype, dev, side, outer_r=None)
    slab = _EmittingSlab(dtype=dtype, device=dev)
    xs = x.expand_as(v)
    idx = _slab_subset(side)

    def rt(xx, vv, max_steps=SLAB_MAX_STEPS):
        return trace_radiative_transfer(m, xx, vv, SPAN, geometry=slab, max_steps=max_steps)

    gp, rec = _lockstep_run("radiative_transfer", lambda: rt(xs, v))
    I, n = gp.aux[:, 0], gp.aux[:, 1]
    none, even = n == 0, (n >= 2) & (torch.remainder(n, 2) == 0)
    odd = torch.remainder(n, 2) == 1
    stopped = (gp.status == StatusCodes.NoStatus) & (gp.lam_max < SPAN[1] - 1e-3)
    sel = torch.nonzero(even).flatten()
    sel = sel[torch.linspace(0, len(sel) - 1, 256, device=sel.device).round().long()]
    got, want, ab = _graph_ab(lambda: rt(xs[sel], v[sel], SLAB_GRAPH_AB_STEPS))
    res = dict(
        pixels=side * side, dtype="f64", max_steps=SLAB_MAX_STEPS, **rec,
        crossings=torch.bincount(n.long()).tolist(), never_entered=int(none.sum()),
        never_entered_I_not_I0=int((I[none] != 1.0).sum()), in_and_out=int(even.sum()),
        in_and_out_I_not_above_I0=int((I[even] <= 1.0).sum()), odd_count=int(odd.sum()),
        unfinished=int(stopped.sum()),
        unfinished_with_odd_count=int((stopped & odd).sum()),
        unfinished_with_even_count=[dict(r=float(gp.x[i, 1]), theta=float(gp.x[i, 2]), crossings=int(n[i]))
                                    for i in torch.nonzero(stopped & ~odd).flatten()[:16].tolist()],
        I_max=float(I.max()),
        graph_vs_uncaptured=dict(rays=256, max_steps=SLAB_GRAPH_AB_STEPS,
                                 bit_equal=_same_points(got, want) and torch.equal(got.aux, want.aux), **ab),
    )
    _say("radiative_transfer", **res)
    if res["never_entered_I_not_I0"] or res["in_and_out_I_not_above_I0"] or not res["in_and_out"]:
        raise AssertionError(f"trace_radiative_transfer: {res}")
    if int((stopped & ~odd & (gp.x[:, 1] >= 10.0)).sum()):
        raise AssertionError(f"trace_radiative_transfer: the cap stopped rays with an even count away from the hole: {res}")
    if not res["graph_vs_uncaptured"]["bit_equal"] or res["graph_vs_uncaptured"]["with_graph"]["graph"]["captures"] != 1:
        raise AssertionError(f"trace_radiative_transfer captured against uncaptured: {res}")
    nc, Ic = n[idx].cpu().numpy(), I[idx].cpu().numpy()

    def against_cpu(sub):
        ns = sub["aux"][:, 1]
        same_even = (nc == ns) & (nc >= 2) & (nc % 2 == 0)
        I_rel = np.abs(Ic[same_even] - sub["aux"][same_even, 0]) / sub["aux"][same_even, 0]
        res["cpu_subset"] = r = dict(
            rays=len(idx), crossings_agree=float((nc == ns).mean()), card_crossings=np.bincount(nc.astype(int)).tolist(),
            even_compared=int(same_even.sum()), I_median_rel=float(np.median(I_rel)) if len(I_rel) else 0.0,
            I_max_rel=float(I_rel.max()) if len(I_rel) else 0.0, cpu_seconds=sub["cpu_seconds"],
        )
        if r["crossings_agree"] < 0.9 or not r["even_compared"] or not r["I_median_rel"] <= 5e-3:
            raise AssertionError(f"trace_radiative_transfer against the CPU: {res}")
        return r

    return res, {"radiative_transfer": against_cpu}


def phase_shaped_chart(dev):
    """The θ-dependent inner chart at TRACES_SIDE² flagship pixels
    (ThinDisc(0, 50), λ ≤ 2200, chart_outer 1100 so that every escaping ray
    leaves the chart before λ = 2200): Kerr a = 0.998 in f64 with
    `event_horizon_chart(m)` against the scalar chart
    (`_flagship_scalar_trace`, shared with `phase_first_order`), statuses
    identical on ≥ 99.99% of pixels, each that differs printed with its end
    radius against r_min(θ) (tests/test_charts_doughnut.py:22-46's
    property; the bisected horizon sits within ~1e-6 of the analytic one,
    so a ray that ends on the bound may go either way); Johannsen-Psaltis
    (a = 0.6, ε₃ = 2) with its own chart: no NoStatus, and every captured
    ray ends within r_min(θ) + 0.3. The CPU subsets (512 rays, each chart
    made on the CPU): statuses equal on ≥ 99%.

    Kerr in f64, not f32 as the flagship render: in f32 this camera's
    lockstep loop needs 1,616 iterations (the error estimate is rounding
    for its slowest rays; 11.3 ms each on an H100), in f64 432
    (21 ms each), so f64 takes half the card time, which the script's time
    limit needs; the JAX package's loop needs the same ~3× more in f32 (851
    against 286 at 24² on the CPU, the port's 976 against 288,
    scripts/torch_reference_witness.py iterations). Johannsen-Psaltis in
    f32 (304 iterations, 16.6 ms each; 432 in f64)."""
    res, cards = {}, {}
    for name, dtype in (("kerr", torch.float64), ("johannsen_psaltis", torch.float32)):
        metric = (KerrMetric(1.0, 0.998, dtype=dtype, device=dev) if name == "kerr"
                  else JohannsenPsaltisMetric(1.0, 0.6, 2.0, dtype=dtype, device=dev))
        m, d, x, v, _, _ = _traces_rays(dtype, dev, TRACES_SIDE, metric=metric)
        xs = x.expand_as(v)
        chart = event_horizon_chart(m)
        idx = _subset(v.shape[0])
        kw = dict(geometry=d, chart_outer=TRACES_CHART_OUTER)
        gp, rec = _lockstep_run(f"shaped_chart {name}", lambda: trace_geodesics(m, xs, v, SPAN, chart_inner=chart, **kw))
        cards[name] = gp.status[idx].cpu().numpy()
        cap = gp.status == StatusCodes.WithinInnerBoundary
        r_min = linear_interp(gp.x[:, 2], chart.thetas, chart.rs)
        r = dict(
            shaped=rec, chart_rs=[float(chart.rs.min()), float(chart.rs.max())],
            statuses=torch.bincount(gp.status.long(), minlength=4).tolist(), captured=int(cap.sum()),
            captured_beyond_rmin_0_3=int((gp.x[cap, 1] > r_min[cap] + 0.3).sum()),
            captured_end_minus_rmin_max=float((gp.x[cap, 1] - r_min[cap]).max()) if bool(cap.any()) else None,
        )
        if name == "kerr":
            sc, sc_rec = _flagship_scalar_trace(dev, TRACES_SIDE)
            diff = torch.nonzero(gp.status != sc.status).flatten()
            r.update(
                scalar=sc_rec, status=_status_agreement(gp.status.cpu(), sc.status.cpu()),
                differing=[
                    dict(shaped=int(gp.status[i]), scalar=int(sc.status[i]), r_end=float(gp.x[i, 1]),
                         r_min=float(r_min[i]), r_scalar_end=float(sc.x[i, 1]))
                    for i in diff[:20].tolist()
                ],
            )
        res[name] = r
    _say("shaped_chart", **res)
    k, jp = res["kerr"], res["johannsen_psaltis"]
    if k["status"]["agree"] < 0.9999 or jp["statuses"][StatusCodes.NoStatus] or jp["captured_beyond_rmin_0_3"] or not jp["captured"]:
        raise AssertionError(f"the shaped chart: {res}")

    def against_cpu(name):
        def check(sub):
            res[name]["cpu_subset"] = dict(status=_status_agreement(cards[name], sub["status"]), cpu_seconds=sub["cpu_seconds"])
            if res[name]["cpu_subset"]["status"]["agree"] < 0.99:
                raise AssertionError(f"the shaped chart against the CPU: {res}")
            return res[name]["cpu_subset"]

        return check

    return res, {"chart_kerr": against_cpu("kerr"), "chart_jp": against_cpu("johannsen_psaltis")}


CHARGED_Q = 0.3
CHARGED_LAMBDA = 2000.0
CHARGED_PARTICLES = 65536
CHARGED_SOLVE_RADII = 64


def _charged_orbits(m, n, q):
    """``n`` timelike states on the equatorial circular orbits that
    `charged_circular_orbit_omega` gives at q/μ = ``q`` for r ∈ [6, 20]."""
    r = torch.linspace(6.0, 20.0, n, dtype=m.a.dtype, device=m.a.device)
    om = charged_circular_orbit_omega(m, r, q=q)
    g = m.components(r, torch.full_like(r, math.pi / 2))
    ut = 1.0 / torch.sqrt(-(g[:, 0] + 2 * om * g[:, 4] + om * om * g[:, 3]))
    z = torch.zeros_like(r)
    return torch.stack([z, r, torch.full_like(r, math.pi / 2), z], -1), torch.stack([ut, z, z, om * ut], -1)


def _charged_legs(m, x, v, q, run=lambda f: (f(), None)):
    """Traces the particles (``x``, ``v``) at q/μ = ``q`` to λ = CHARGED_LAMBDA
    in four legs, each from the last one's end, through ``run(fn) → (points,
    record)``: (the last points, [(each leg's points, its record)])."""
    legs = []
    for leg in range(4):
        span = (CHARGED_LAMBDA / 4 * leg, CHARGED_LAMBDA / 4 * (leg + 1))
        gp, rec = run(lambda: trace_geodesics(m, x, v, span, mu=1.0, q=q, constrain=False))
        legs.append((gp, rec))
        x, v = gp.x, gp.v
    return gp, legs


def phase_charged(dev):
    """Charged traces, f64, Kerr-Newman (a = 0.5, Q = 0.3):
    CHARGED_PARTICLES timelike particles, half at q/μ = +0.3 and half at
    −0.3, on the equatorial circular orbits `charged_circular_orbit_omega`
    gives for r ∈ [6, 20], traced to λ = 2000 in four legs of 500 (the
    Lorentz force through the batched `faraday_tensor`): every radius stays
    within 1e-8 relative of its start at each leg's end, and θ within 1e-6
    of π/2 (on the CPU at 64 radii: 1.2e-9 and 2.1e-7). The captured loop
    against `cuda_graphs(False)`, bit for bit, on 256 particles over the
    first leg. The CPU subset (512 particles, the same four legs): statuses
    equal, positions within atol 1e-6. Then `solve_equatorial_circular_orbit`
    at CHARGED_SOLVE_RADII radii of the same metric (uncharged particles;
    its 30 golden-section steps, one batched trace of the radii each)
    against `CircularOrbits`' analytic v^φ, within 1e-6 relative (on the CPU
    3.1e-16 at 16 radii)."""
    m = KerrNewmanMetric(1.0, 0.5, 0.3, device=dev)
    drift, theta_dev, recs, ends = 0.0, 0.0, [], []
    half = CHARGED_PARTICLES // 2
    starts = {s: _charged_orbits(m, half, s) for s in (CHARGED_Q, -CHARGED_Q)}
    for s, (x, v) in starts.items():
        gp, legs = _charged_legs(m, x, v, s, run=lambda f: _lockstep_run("charged", f))
        for end, rec in legs:
            recs.append(rec)
            drift = max(drift, float(((end.x[:, 1] - x[:, 1]).abs() / x[:, 1]).max()))
            theta_dev = max(theta_dev, float((end.x[:, 2] - math.pi / 2).abs().max()))
        ends.append(gp)
    x, v = starts[CHARGED_Q]
    sel = _subset(half, 256).to(dev)
    got, want, ab = _graph_ab(lambda: trace_geodesics(m, x[sel], v[sel], (0.0, CHARGED_LAMBDA / 4), mu=1.0, q=CHARGED_Q, constrain=False))
    r = torch.linspace(6.0, 20.0, CHARGED_SOLVE_RADII, dtype=torch.float64, device=dev)
    vphi, solve_rec = _lockstep_run("solve_equatorial_circular_orbit", lambda: solve_equatorial_circular_orbit(m, r))
    analytic = CircularOrbits.fourvelocity(m, (r, torch.full_like(r, math.pi / 2)))[:, 3]
    res = dict(
        particles=CHARGED_PARTICLES, q_over_mu=[CHARGED_Q, -CHARGED_Q], lam=CHARGED_LAMBDA, loops=len(recs),
        seconds=sum(r["seconds"] for r in recs), iterations=sum(r["iterations"] for r in recs),
        ms_per_iteration=sum(r["seconds"] for r in recs) * 1e3 / max(sum(r["iterations"] for r in recs), 1),
        legs=recs, radius_drift_max_rel=drift, theta_deviation_max=theta_dev,
        finished=int(sum(int((e.status == StatusCodes.NoStatus).sum()) for e in ends)),
        graph_vs_uncaptured=dict(rays=256, bit_equal=_same_points(got, want), **ab),
        solve_equatorial_circular_orbit=dict(radii=CHARGED_SOLVE_RADII, **solve_rec, vphi_max_rel=float(_rel(vphi, analytic).max())),
    )
    _say("charged", **res)
    if not (drift <= 1e-8 and theta_dev <= 1e-6 and res["finished"] == CHARGED_PARTICLES):
        raise AssertionError(f"charged circular orbits: {res}")
    if not res["graph_vs_uncaptured"]["bit_equal"] or res["graph_vs_uncaptured"]["with_graph"]["graph"]["captures"] != 1:
        raise AssertionError(f"charged traces captured against uncaptured: {res}")
    if not res["solve_equatorial_circular_orbit"]["vphi_max_rel"] <= 1e-6:
        raise AssertionError(f"solve_equatorial_circular_orbit against the analytic v^φ: {res}")
    idx = _subset(half, TRACES_SUBSET // 2).to(dev)
    card = {k: torch.cat([getattr(e, k)[idx] for e in ends]).cpu().numpy() for k in ("status", "x")}

    def against_cpu(sub):
        res["cpu_subset"] = dict(
            status=_status_agreement(card["status"], sub["status"]), x_max_abs=float(np.abs(card["x"] - sub["x"]).max()),
            cpu_seconds=sub["cpu_seconds"],
        )
        if res["cpu_subset"]["status"]["agree"] < 1.0 or not res["cpu_subset"]["x_max_abs"] <= 1e-6:
            raise AssertionError(f"charged traces against the CPU: {res}")
        return res["cpu_subset"]

    return res, {"charged": against_cpu}


def _mesh_against_disc(m, xs, v, A, B, mesh, what):
    """The mesh trace of (``xs``, ``v``) against the ThinDisc(6, 50) trace of
    the same rays, in the metric's dtype: the records, the hit counts, and
    each ray whose hit masks differ with whether it lies within one chord
    of the annulus's rims (a polygon edge, 2ρ·sin(π/n_phi), of ρ = 6 or
    ρ = 50: traced again against each of those two bands, a thin disc
    each, it hits one), where its disc hit lies (ρ, φ) and how far that is
    from the nearest edge two triangles share."""
    dtype, dev = v.dtype, v.device
    torch.cuda.reset_peak_memory_stats()
    gm, rec = _lockstep_run(what, lambda: trace_geodesics(m, xs, v, SPAN, geometry=mesh))
    peak = torch.cuda.max_memory_allocated()
    gd, disc_rec = _lockstep_run(f"{what} disc", lambda: trace_geodesics(m, xs, v, SPAN, geometry=ThinDisc(6.0, 50.0, dtype=dtype, device=dev)))
    differ = torch.nonzero((gm.status == HIT) != (gd.status == HIT)).flatten()
    w_in, w_out = (2 * r * math.sin(math.pi / MESH_N_PHI) for r in (6.0, 50.0))
    at_rims = torch.zeros(len(differ), dtype=torch.bool, device=dev)
    for lo, hi in ((6.0 - w_in, 6.0 + w_in), (50.0 - w_out, 50.0 + w_out)):
        if len(differ):
            band = ThinDisc(lo, hi, dtype=dtype, device=dev)
            at_rims |= trace_geodesics(m, xs[differ], v[differ], SPAN, geometry=band).status == HIT
    dx = gd.x[differ].double().cpu().numpy()
    rho, phi = dx[:, 1] * np.sin(dx[:, 2]), dx[:, 3]
    edge = _shared_edge_distance(rho, phi, MESH_N_PHI) if len(differ) else np.zeros(0)
    rays = [
        dict(alpha=float(A[i]), beta=float(B[i]), mesh_status=int(gm.status[i]), disc_status=int(gd.status[i]),
             disc_rho=float(rho[k]), disc_phi=float(phi[k]), shared_edge_distance=float(edge[k]), at_rims=bool(at_rims[k]))
        for k, i in enumerate(differ.tolist())
    ]
    off_rim = [r for r in rays if not r["at_rims"]]
    out = dict(
        rays=len(v), mesh=rec, disc=disc_rec, peak_allocated_bytes=peak, mesh_hits=int((gm.status == HIT).sum()),
        disc_hits=int((gd.status == HIT).sum()), differing=len(rays), differing_within_a_chord_of_the_rims=len(rays) - len(off_rim),
        off_rim_disc_hits_lost=sum(r["disc_status"] == HIT for r in off_rim), off_rim=off_rim, at_rims=[r for r in rays if r["at_rims"]][:16],
    )
    return gm, out


def phase_mesh(dev):
    """A triangulated annulus 6 ≤ ρ ≤ 50 (`_annulus_triangles`: 4·MESH_N_PHI
    triangles, each face both ways up, as the JSF test is one-sided) as a
    `MeshAccretionGeometry` (`_mesh_args`: the default ``proximity2`` of 9
    would drop hits on large triangles; tests/test_mesh_tables.py widens it
    and the box too), traced at MESH_SIDE² flagship pixels (λ ≤ 2200)
    against the ThinDisc(6, 50) trace of the same pixels
    (`_mesh_against_disc`).

    In f64: hit masks equal but for pixels within one chord of the
    annulus's rims (their number printed). The CPU subset (512 rays):
    statuses equal on ≥ 99%.

    In f32 (the flagship render's dtype), on every `MESH_F32_STRIDE`-th
    pixel, against the f32 disc trace of the same pixels: the same check,
    the disc hits lost away from the rims held to
    `MESH_F32_OFF_RIM_LOSSES`. In f32 the JSF test lets a chord through
    where it crosses within a few 1e-6 of an edge that two triangles
    share, in both packages (ROADMAP C,
    tests/test_torch_reference_properties.py); the full f32 image at 256²
    lost no disc hit to it (on an H100, 38 differing pixels, all at the
    rims).

    At 128², not 1024²: `segment_hit` materialises (rays × triangles)
    tensors for each chord, ~60–80 bytes a pair in f32, so 1024² rays
    against 256 triangles would take ~17–22 GB a chord; a hand-written
    segment test is a later PR's. (256² until the AD phases needed its
    ~40 s: 69 ms an f64 iteration there.) The full image is traced in f64
    because f32 needs ~4× its lockstep iterations at this camera (3,056
    against 768 at 256²; the JAX package's loop the same, ROADMAP C) at
    ~45 ms each against 256 triangles."""
    side, args = MESH_SIDE, _mesh_args()
    res = dict(pixels=side * side, triangles=len(args["triangles"]), proximity2=args["proximity2"])
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        m, _, x, v, A, B = _traces_rays(dtype, dev, side, outer_r=None)
        xs = x.expand_as(v)
        if name == "f32":
            xs, v, A, B = (t[::MESH_F32_STRIDE] for t in (xs, v, A, B))
        mesh = MeshAccretionGeometry(*args.values(), dtype=dtype, device=dev)
        gm, res[name] = _mesh_against_disc(m, xs, v, A, B, mesh, f"mesh {name}")
        if name == "f64":
            card = gm.status[_subset(v.shape[0])].cpu().numpy()
    res["f32"]["held_off_rim_losses"] = MESH_F32_OFF_RIM_LOSSES
    _say("mesh", **res)
    r64, r32 = res["f64"], res["f32"]
    if r64["off_rim"] or not r64["mesh_hits"]:
        raise AssertionError(f"the mesh against the thin disc (f64): {res}")
    if r32["off_rim_disc_hits_lost"] != len(r32["off_rim"]) or r32["off_rim_disc_hits_lost"] > MESH_F32_OFF_RIM_LOSSES:
        raise AssertionError(f"the mesh against the thin disc (f32): {res}")

    def against_cpu(sub):
        res["cpu_subset"] = dict(status=_status_agreement(card, sub["status"]), cpu_seconds=sub["cpu_seconds"])
        if res["cpu_subset"]["status"]["agree"] < 0.99:
            raise AssertionError(f"the mesh against the CPU: {res}")
        return res["cpu_subset"]

    return res, {"mesh": against_cpu}


# Most host-bound phases run in worker processes beside the main one, after
# the kernel-timed phases, so that the script ends inside its time limit:
# each lockstep iteration is host dispatch (the card is busy a third of it),
# and the machine has cores to spare. Each worker runs its phases in order
# and writes their results to a JSON file.
#
# The ``xla`` transfer functions at `bench_ctf`'s full size (~200 captured
# forward-mode traces a profile, ~20 ms an iteration) take a worker each.
ADJOINT_EPS = 1e-4  # tests/test_reverse_mode.py's central difference
ADJOINT_EVERY = 8  # the FD subset: every 8th pixel each way (1/64, 16,384 rays at 1024²)


def _adjoint_pixels(dev, side, params, every=1):
    """The flagship redshift render (Kerr, r = 1000, ThinDisc(0, 50), λ ≤
    2200, f64) at ``params`` = (a, i), every ``every``-th pixel each way of
    the side² grid: (g where the ray hit the disc and 0 elsewhere, the hit
    mask as 0/1, the hits' ρ, the statuses) — tests/test_reverse_mode.py's
    `_mean_redshift` is the first over the second's sum."""
    a, incl = params
    m = KerrMetric(1.0, a, device=dev)
    d = ThinDisc(0.0, 50.0, dtype=torch.float64, device=dev)
    z = torch.zeros((), dtype=torch.float64, device=dev)
    x = torch.stack([z, z + X_OBS[1], incl, z])
    A, B = _pixel_grid(side, side, (-28.0, 28.0), (-18.0, 18.0), 1e-4, torch.float64, dev)
    if every > 1:
        A, B = (t.view(side, side)[::every, ::every].reshape(-1) for t in (A, B))
    v = map_impact_parameters(m, x, A, B)
    gp = trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d)
    g = redshift_pointfunction(m, x)(m, gp, SPAN[1])
    hit = gp.status == HIT
    return torch.where(hit, g, 0.0), hit.to(torch.float64), gp.x[:, 1] * torch.sin(gp.x[:, 2]), gp.status


def phase_adjoint_render(dev, side=1024, every=ADJOINT_EVERY):
    """∂⟨g⟩/∂(a, i) of the flagship render in f64 through `fwd_adjoint`:
    its forward is `jacfwd` of the side² pixel image, on the card
    `tracing._LiftedTrace` (one captured primal loop, then one captured
    loop carrying both parameter tangents; no uncaptured iteration). The
    loss is the masked mean redshift of tests/test_reverse_mode.py's
    `_mean_redshift`. Checks: `torch.autograd.grad` of the loss equals the
    contraction of the pixel Jacobian (rtol 1e-12); on every ``every``-th
    pixel each way, the subset's own trace gives the full run's primal bit
    for bit, and the Jacobian's columns agree with central differences (ε
    = 1e-4) on the pixels hit in all three: median relative error ≤ 2e-3
    (`_hit_radius_jvp`'s rtol), share within 2e-2 (the JAX test's rtol) ≥
    0.99; the 8 worst pixels are printed with their ρ and statuses."""
    from gradus_tpu_torch.diff import fwd_adjoint

    f64 = dict(dtype=torch.float64, device=dev)
    p0 = (torch.tensor(0.998, **f64), torch.tensor(X_OBS[2], **f64))
    params = tuple(t.clone().requires_grad_(True) for t in p0)
    image = fwd_adjoint(lambda p: _adjoint_pixels(dev, side, p)[:2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _NoKernelRoute(), _Lockstep() as steps:
        (gm, hitf), seconds = _trace_seconds(lambda: image(params))
    peak = torch.cuda.max_memory_allocated()
    _require_captured("adjoint_render", steps)
    if steps.graph["captures"] != 2 or steps.calls != 2 or steps.tangent_calls != 1:
        raise AssertionError(f"adjoint_render: expected a primal and a tangent loop, one capture each: {steps.graph}")
    loss = gm.sum() / hitf.sum()
    grads = torch.autograd.grad(loss, params)
    jac = gm.grad_fn.box.jac[0]  # the pixels' Jacobian columns, from the same forward
    w = torch.full_like(gm, 1.0) / hitf.sum()
    contraction = [float(torch.dot(w.detach(), torch.nan_to_num(j))) for j in jac]
    grad_rel = [abs(float(g) - c) / abs(c) for g, c in zip(grads, contraction)]
    if not max(grad_rel) <= 1e-12:
        raise AssertionError(f"adjoint_render: autograd.grad against the Jacobian's contraction: {grad_rel}")

    # the subset, its primal bit for bit the full run's, and central differences
    idx = torch.arange(side * side, device=dev).view(side, side)[::every, ::every].reshape(-1)
    with torch.no_grad():
        g0, h0, rho0, s0 = _adjoint_pixels(dev, side, p0, every)
        same = bool(torch.equal(g0, gm.detach()[idx])) and bool(torch.equal(h0, hitf.detach()[idx]))
        if not same:
            raise AssertionError("adjoint_render: the subset's primal is not the full run's bit for bit")
        fd, worst, stats = [], [], {}
        for k, name in enumerate(("a", "incl")):
            runs = []
            for sign in (1.0, -1.0):
                p = list(p0)
                p[k] = p[k] + sign * ADJOINT_EPS
                runs.append(_adjoint_pixels(dev, side, tuple(p), every))
            (gp_, hp, _, sp), (gm_, hm, _, sm) = runs
            ok = (h0 > 0) & (hp > 0) & (hm > 0)
            fd_k = (gp_ - gm_) / (2 * ADJOINT_EPS)
            j_k = jac[k].detach()[idx]
            rel = ((j_k - fd_k).abs() / fd_k.abs())[ok]
            share = float((rel <= 2e-2).double().mean())
            stats[name] = dict(
                pixels=int(ok.sum()), median_rel=float(rel.median()), share_within_2e_2=share,
                max_rel=float(rel.max()), grad=float(grads[k]), contraction=contraction[k],
            )  # fmt: skip
            order = torch.argsort(torch.where(ok, (j_k - fd_k).abs() / fd_k.abs(), -1.0), descending=True)[:8]
            worst.append({
                name: [
                    dict(pixel=int(idx[i]), rho=float(rho0[i]), status=[int(s0[i]), int(sp[i]), int(sm[i])],
                         jac=float(j_k[i]), fd=float(fd_k[i]), rel=float((j_k[i] - fd_k[i]).abs() / fd_k[i].abs()))
                    for i in order.tolist()
                ]
            })  # fmt: skip
    loops = [dict(lp, ms_per_iteration=lp["seconds"] * 1e3 / max(lp["iterations"], 1)) for lp in steps.loops]
    res = dict(
        pixels=side * side, dtype="f64", loss=float(loss), grad=[float(g) for g in grads], grad_rel=grad_rel,
        subset=dict(every=every, rays=int(idx.numel()), primal_bit_for_bit=same), fd=stats, worst=worst,
        seconds=seconds, iterations=steps.iters, loops=loops, graph=steps.graph, peak_allocated_bytes=peak,
    )  # fmt: skip
    _say("adjoint_render", **res)
    for name, st in stats.items():
        if not (st["median_rel"] <= 2e-3 and st["share_within_2e_2"] >= 0.99 and st["pixels"] >= idx.numel() // 4):
            raise AssertionError(f"adjoint_render: ∂g/∂{name} against central differences: {st}")
    return res


@dataclasses.dataclass(frozen=True)
class _SplineSurface:
    """tests/test_checkpointed_adjoint.py's warped disc z = h(ρ), h a
    128-knot linear spline: a many-parameter head inside the event
    function."""

    knots: torch.Tensor
    heights: torch.Tensor

    def crossing_indicator(self, x):
        r, th = x[..., 1], x[..., 2]
        return r * torch.cos(th) - linear_interp(r * torch.sin(th), self.knots, self.heights)

    def is_hit(self, x, gtol=1e-2):
        rho = x[..., 1] * torch.sin(x[..., 2])
        return (rho > 5.0) & (rho < 35.0)


LADDER = dict(n_segments=16, seg_steps=16)


def phase_checkpointed_adjoint(dev, side=128, n_proj=5):
    """`torch.autograd.grad` through the checkpointed ladder
    (`trace_geodesics(..., checkpointed=True)`: the forward and the
    backward each replay a captured graph) of tests/test_checkpointed_adjoint.py's
    loss with respect to the 128 spline heights, at its camera (Kerr a =
    0.6, r = 100, i = 70°, λ ≤ 300, 16 × 16) over side² rays in its window
    α ∈ [−16, −8], β ∈ [−3, 3], f64. Checks: the ladder's primal against
    the while-loop's (statuses equal, x within 1e-10); the gradient against
    central differences on ``n_proj`` random unit projections (ε = 3e-5,
    rtol 1e-3, atol 1e-9, the JAX test's). Beside it, the uncheckpointed
    `loss.backward()` uncaptured (`cuda_graphs(False)`): seconds and peak
    bytes."""
    f64 = dict(dtype=torch.float64, device=dev)
    m = KerrMetric(1.0, 0.6, device=dev)
    x_obs = torch.tensor([0.0, 100.0, math.radians(70.0), 0.0], **f64)
    A, B = _pixel_grid(side, side, (-16.0, -8.0), (-3.0, 3.0), 0.0, torch.float64, dev)
    v = map_impact_parameters(m, x_obs, A, B)
    xs = x_obs.expand_as(v)
    knots = torch.linspace(3.0, 40.0, 128, **f64)
    heights0 = 0.5 + 0.3 * torch.sin(knots / 5.0)

    def trace(h, **kw):
        return trace_geodesics(m, xs, v, (0.0, 300.0), geometry=_SplineSurface(knots, h), **kw)

    def loss_of(gp):
        hit = gp.status == HIT
        rho = gp.x[..., 1] * torch.sin(gp.x[..., 2])
        return torch.where(hit, rho**2 + 0.1 * gp.x[..., 0], 0.0).sum() / xs.shape[0]

    with torch.no_grad(), _Lockstep() as primal_steps:
        gw = trace(heights0)
        gc = trace(heights0, checkpointed=True, **LADDER)
    _require_captured("checkpointed_adjoint primal", primal_steps)
    x_err = float((gw.x - gc.x).abs().max())
    if not (torch.equal(gw.status, gc.status) and torch.allclose(gc.x, gw.x, rtol=1e-10, atol=1e-10)):
        raise AssertionError(f"checkpointed_adjoint: the ladder's primal against the while-loop's: {x_err}")

    h = heights0.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _Lockstep() as steps:
        val, forward_s = _trace_seconds(lambda: loss_of(trace(h, checkpointed=True, **LADDER)))
        (grad,), backward_s = _trace_seconds(lambda: torch.autograd.grad(val, h))
    peak = torch.cuda.max_memory_allocated()
    _require_captured("checkpointed_adjoint", steps)
    val = val.detach()
    if not (float(val) > 0 and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0):
        raise AssertionError(f"checkpointed_adjoint: loss {float(val)}, gradient {grad}")

    rng = np.random.default_rng(3)
    eps, proj = 3e-5, []
    with torch.no_grad():
        for _ in range(n_proj):
            u = torch.as_tensor(rng.standard_normal(128), **f64)
            u /= torch.linalg.norm(u)
            fd = (loss_of(trace(heights0 + eps * u, checkpointed=True, **LADDER))
                  - loss_of(trace(heights0 - eps * u, checkpointed=True, **LADDER))) / (2 * eps)  # fmt: skip
            an = float(grad @ u)
            proj.append(dict(analytic=an, fd=float(fd), rel=abs(an - float(fd)) / abs(float(fd))))
    fd_ok = all(abs(p["analytic"] - p["fd"]) <= 1e-9 + 1e-3 * abs(p["fd"]) for p in proj)

    # the uncheckpointed backward, uncaptured: autograd records each op
    h_u = heights0.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with cuda_graphs(False), _Lockstep() as plain_steps:
        val_u, plain_forward_s = _trace_seconds(lambda: loss_of(trace(h_u)))
        (grad_u,), plain_backward_s = _trace_seconds(lambda: torch.autograd.grad(val_u, h_u))
    plain_peak = torch.cuda.max_memory_allocated()
    res = dict(
        rays=side * side, ladder=LADDER, loss=float(val), primal_x_max_abs=x_err,
        forward_seconds=forward_s, backward_seconds=backward_s, iterations=steps.iters, loops=steps.loops,
        graph=steps.graph, peak_allocated_bytes=peak, projections=proj,
        uncheckpointed=dict(
            forward_seconds=plain_forward_s, backward_seconds=plain_backward_s, iterations=plain_steps.iters,
            peak_allocated_bytes=plain_peak,
            grad_max_rel_to_ladder=float(((grad_u - grad).abs() / grad.abs().max()).max()),
        ),
    )  # fmt: skip
    _say("checkpointed_adjoint", **res)
    if not fd_ok:
        raise AssertionError(f"checkpointed_adjoint: the gradient against central differences: {proj}")
    return res


WORKERS = {
    "lags_golden": (("reverberation_golden", {}),),
    "lags_full": (("lag_frequency_full", {}),),
    "binflux": (("binflux_golden", {}), ("lagtransfer_semianalytic", {}), ("trace_api", {})),
    "corona": (("emissivity", {}), ("profiled_lineprofile", {})),
    "graph": (("lockstep_graph", {}),),
    "xla_thin": (("ctf_xla", {"N_extrema": 5}),),
    "xla_thick": (("thick_disc", {"N_extrema": 4}),),
    "thick_golden": (("thick_disc_golden", {}),),
    "ring_corona": (("ring_corona", {}),),
    "disc_corona": (("disc_corona", {}),),
    "traces_cpu": (("cpu_subsets", {}),),
    "plain": (("kernel_vs_plain", {}), ("callable_geometries", {})),
    "geometries": (("thick_geometries", {}),),
}
# The special traces' card work runs alone on the card, in the main process
# before the workers start (`_run_traces`), or alone as ``--worker traces``:
# beside the workers their 1024² iterations (20–60 ms of card time each)
# slowed every worker's loop 2–12× and the script overran its time limit.
TRACES = ("charged", "shaped_chart", "first_order", "windings", "radiative_transfer", "mesh")
_WORKER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_workers"


def _worker(name, out_path):
    """Runs the phases of worker ``name`` on card 0; writes {"results",
    "seconds"} to ``out_path``."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if name == "build":
        t0 = time.perf_counter()
        phase_build(dev)
        info = _build.build_info()
        results = {"build": dict(seconds=info["seconds"], built=info["built"], callables=info["callables"])}
        Path(out_path).write_text(json.dumps(dict(results=results, seconds={"build": time.perf_counter() - t0})))
        return
    _build.load_library()
    if name == "traces":
        procs = _start_workers(("traces_cpu",))
        try:
            pending, seconds = _run_traces(dev)
            cpu, _ = _join_workers(procs, timeout=1150.0)
        finally:
            _stop_workers(procs)
        results = _hold_traces_to_cpu(pending, cpu["cpu_subsets"])
        Path(out_path).write_text(json.dumps(dict(results=results, seconds=seconds)))
        return
    results, seconds, prof = {}, {}, None
    for phase, kw in WORKERS[name]:
        t0 = time.perf_counter()
        if phase == "emissivity":
            results[phase], prof = phase_emissivity(dev)
        elif phase == "profiled_lineprofile":
            results[phase] = phase_profiled_lineprofile(dev, prof)
        else:
            results[phase] = globals()[f"phase_{phase}"](dev, **kw)
        seconds[phase] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(dict(results=results, seconds=seconds)))


def _run_traces(dev):
    """The card's part of each `TRACES` phase, in order: ({phase: (result,
    its checks against the CPU subsets)}, seconds keyed by phase)."""
    pending, seconds = {}, {}
    try:
        for phase in TRACES:
            t0 = time.perf_counter()
            pending[phase] = globals()[f"phase_{phase}"](dev)
            seconds[phase] = time.perf_counter() - t0
    finally:
        _SCALAR_TRACES.clear()
    return pending, seconds


def _hold_traces_to_cpu(pending, subsets):
    """Holds each `TRACES` phase's card results to its CPU subsets
    (`phase_cpu_subsets`' output), raising at the first that fails, and
    prints each comparison: the results keyed by phase."""
    held = {}
    for _, checks in pending.values():
        for kind, check in checks.items():
            held[kind] = check({k: np.asarray(a) if isinstance(a, list) else a for k, a in subsets[kind].items()})
    _say("cpu_subsets", **held)
    return {phase: res for phase, (res, _) in pending.items()}


def _start_workers(names=WORKERS):
    _WORKER_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        log = open(_WORKER_DIR / f"{name}.log", "w")
        procs[name] = (
            subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker", name, str(_WORKER_DIR / f"{name}.json")],
                stdout=log,
                stderr=subprocess.STDOUT,
            ),
            log,
        )
    return procs


def _join_workers(procs, timeout):
    """Waits for every worker, prints its output, and returns its phases'
    results and seconds; raises if one failed."""
    results, seconds, failed = {}, {}, []
    deadline = time.perf_counter() + timeout
    for name, (proc, log) in procs.items():
        rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        log.close()
        print((_WORKER_DIR / f"{name}.log").read_text(), end="", flush=True)
        if rc != 0:
            failed.append((name, rc))
            continue
        out = json.loads((_WORKER_DIR / f"{name}.json").read_text())
        results.update(out["results"])
        seconds.update(out["seconds"])
    if failed:
        raise AssertionError(f"worker phases failed: {failed}")
    return results, seconds


def _traces_summary(results, seconds):
    """The `TRACES` phases for the closing line: seconds, and the lockstep
    iterations and ms an iteration of each full-size trace."""

    def loop(r):
        return {k: r[k] for k in ("seconds", "iterations", "ms_per_iteration")}

    fo, sc, rt = results["first_order"], results["shaped_chart"], results["radiative_transfer"]
    return dict(
        seconds={p: seconds[p] for p in TRACES},
        charged={k: results["charged"][k] for k in ("particles", "seconds", "iterations", "ms_per_iteration")},
        shaped_chart={"kerr": loop(sc["kerr"]["shaped"]), "kerr_scalar": loop(sc["kerr"]["scalar"]),
                      "johannsen_psaltis": loop(sc["johannsen_psaltis"]["shaped"])},
        first_order=loop(fo["first_order"]), second_order=loop(fo["second_order"]),
        windings=loop(results["windings"]), radiative_transfer=loop(rt),
        mesh={name: loop(results["mesh"][name]["mesh"]) for name in ("f64", "f32")},
    )


def _stop_workers(procs):
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


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
    # the build's nvcc runs (the host's cores) in a process of its own while
    # the AD half, which launches no kernel of the library, has the card
    building = _start_workers(("build",))
    try:
        adjoint = timed_phase("adjoint_render", phase_adjoint_render, dev)
        checkpointed = timed_phase("checkpointed_adjoint", phase_checkpointed_adjoint, dev)
        _, build_seconds = _join_workers(building, timeout=600.0)
    finally:
        _stop_workers(building)
    seconds.update(build_seconds)
    timed_phase("load", _build.load_library, _callable_units())
    # the phases that time kernels, alone on the card
    timed_phase("goldens", phase_goldens, dev)
    rendered, segmented = timed_phase("main_path", phase_main_path, dev)
    deformed = timed_phase("deformed_render", phase_deformed_render, dev)
    kerr_newman = timed_phase("kerr_newman_render", phase_kerr_newman_render, dev)
    thick = timed_phase("thick_geometries_render", phase_thick_geometries_render, dev)
    warped = timed_phase("callable_geometries_render", phase_callable_geometries_render, dev)
    chain = timed_phase("chain", phase_chain, dev)
    timed_phase("ctf_golden", phase_ctf_golden, dev)
    ctf, ctf_flux = timed_phase("ctf_lineprofile", phase_ctf_lineprofile, dev)
    binned = timed_phase("binning_lineprofile", phase_binning_lineprofile, dev, ctf_flux)
    # the special traces' card work, alone on the card; their CPU subsets
    # run in the worker ``traces_cpu`` and are held after the workers end
    pending, traces_seconds = _run_traces(dev)
    # the host-bound phases: the workers' beside this process's
    t_workers = time.perf_counter()
    procs = _start_workers()
    try:
        render_api = timed_phase("render_api", phase_render_api, dev)
        binning_api = timed_phase("binning_api", phase_binning_api, dev, ctf_flux)
        lags, worker_seconds = _join_workers(procs, timeout=1150.0 - (time.perf_counter() - t_start))
        checks, trace_api = lags["kernel_vs_plain"], lags["trace_api"]
    finally:
        _stop_workers(procs)
    traces = _hold_traces_to_cpu(pending, lags.pop("cpu_subsets"))
    seconds.update(traces_seconds)
    seconds.update(worker_seconds)
    _say(
        "timing",
        seconds=seconds,
        total_seconds=time.perf_counter() - t_start,
        concurrent_from_second=t_workers - t_start,
        workers={name: [phase for phase, _ in phases] for name, phases in WORKERS.items()},
    )
    # the lockstep solver under trace_geodesics is plain torch, not a kernel
    print(
        json.dumps(
            {
                "lockstep_solver": {
                    "source": "gradus_tpu_torch/integrate/solver.py",
                    "reference": "gradus_tpu/integrate/solver.py:417",
                    "kernel_launches": 0,
                    "cuda_graphs": "one loop body captured a call, replayed an iteration",
                    "graph_vs_uncaptured": lags["lockstep_graph"],
                    "trace_f64": {
                        k: trace_api["f64"][k] for k in ("rays", "iterations", "seconds", "ms_per_iteration", "graph")
                    },
                    "trace_f32": {
                        k: trace_api["f32"][k] for k in ("rays", "iterations", "seconds", "ms_per_iteration", "graph")
                    },
                    "jvp": trace_api["jvp"],
                    "render": {
                        k: render_api[k]
                        for k in (
                            "pixels",
                            "seconds_per_render",
                            "iterations",
                            "ms_per_iteration",
                            "busy_share",
                            "graph",
                            "peak_allocated_bytes",
                        )
                    },
                    "binned_profile": {
                        k: binning_api[k] for k in ("rays", "seconds_per_profile", "iterations", "ms_per_iteration")
                    },
                    "corona_sweep": lags["emissivity"]["sweep"],
                    "corona_monte_carlo": lags["emissivity"]["monte_carlo"],
                    "continuum_time": {
                        k: lags["reverberation_golden"][k]
                        for k in (
                            "t0_seconds",
                            "t0_newton_iterations",
                            "t0_lockstep_iterations",
                            "t0_ms_per_iteration",
                            "t0_graph",
                        )
                    },
                    "ctf_xla": lags["ctf_xla"],
                    "thick_disc": lags["thick_disc"],
                    "thick_disc_golden": lags["thick_disc_golden"],
                    "lag_frequency_full": lags["lag_frequency_full"]["split"],
                    "ring_corona": {
                        k: lags["ring_corona"][k]
                        for k in ("seconds", "iterations", "loops", "forward_mode_loops", "split", "fan", "adaptive_sky")
                    },
                    "disc_corona": {k: lags["disc_corona"][k] for k in ("seconds", "rays", "iterations", "fan", "probes")},
                    "traces": _traces_summary(traces, traces_seconds),
                    "adjoint_render": {
                        k: adjoint[k] for k in ("pixels", "seconds", "iterations", "loops", "graph", "peak_allocated_bytes", "fd")
                    },
                    "checkpointed_adjoint": {
                        k: checkpointed[k]
                        for k in (
                            "rays", "forward_seconds", "backward_seconds", "iterations", "graph",
                            "peak_allocated_bytes", "uncheckpointed",
                        )
                    },  # fmt: skip
                    "lagtransfer_defaults": lags["binflux_golden"]["defaults"]["traces"],
                    "profiled_binned_profile": {
                        name: {k: r[k] for k in ("binned_seconds", "binned_iterations")}
                        for name, r in lags["profiled_lineprofile"].items()
                    },
                }
            }
        ),
        flush=True,
    )
    bounds = {
        key: _bound(ops, r["subset_rays"], r["subset_attempted_lane_steps"], r["subset_hits"], torch.float32)
        for key, ops, r in (
            ("flagship", "kerr", rendered),
            ("deformed", "johannsen_psaltis", deformed),
            ("kerr_newman", "kerr_newman", kerr_newman),
            ("thick", "kerr_shakura_sunyaev", thick),
            ("warped", "kerr_warped", warped),
        )
    }
    bound_ms, bound_by = bounds["flagship"]
    deformed_bound_ms, deformed_bound_by = bounds["deformed"]
    kn_bound_ms, kn_bound_by = bounds["kerr_newman"]
    thick_bound_ms, thick_bound_by = bounds["thick"]
    warped_bound_ms, warped_bound_by = bounds["warped"]
    geometries = lags["thick_geometries"]
    callables = lags["callable_geometries"]
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
                            "polish_epilogue",
                            "shakura_sunyaev",
                            "elliptical_disc",
                            "polish_doughnut",
                            "precessing_disc",
                            "composite_geometry",
                            "warped_thin_disc",
                            "thick_disc",
                            "precessing_datum_plane",
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
                        "polish_epilogue_max_rel_err": max(
                            r["hit_max_rel_err"] for r in checks["modes"]["polish_epilogue"].values()
                        ),
                        "torch_polish_calls": rendered["torch_polish_calls"],
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
                        "thick_geometries_render": {
                            "launches": thick["launches"],
                            "ms": thick["subset_kernel_ms"],
                            "plain_ms": thick["subset_plain_ms"],
                            "bound_ms": thick_bound_ms,
                            "bound_by": thick_bound_by,
                            "full_kernel_ms": thick["full_kernel_ms"],
                            "full_bound_ms": thick["full_bound_ms"],
                        },
                        "callable_geometries_render": {
                            "launches": warped["launches"],
                            "ms": warped["subset_kernel_ms"],
                            "plain_ms": warped["subset_plain_ms"],
                            "bound_ms": warped_bound_ms,
                            "bound_by": warped_bound_by,
                            "full_kernel_ms": warped["full_kernel_ms"],
                            "full_bound_ms": warped["full_bound_ms"],
                            "build_seconds": warped["build"]["seconds"],
                            "build_registers": warped["build"]["registers"],
                            "build_spills": warped["build"]["spills"],
                        },
                        "callables_max_abs_err": {
                            k: r["hit_max_abs_err"] for k, r in callables.items() if k.endswith("_float64")
                        },
                        "callables_kernel": {
                            k: {f: r[f] for f in ("rays", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
                            for k, r in callables.items()
                            if "kernel_ms" in r
                        },
                        "callables_stepwise_max_rel": {
                            k: r["stepwise"]["state_max_rel"] for k, r in callables.items() if "stepwise" in r
                        },
                        "callable_vs_kind3": {k: r for k, r in callables.items() if k.startswith("callable_vs_kind3")},
                        "geometries_max_abs_err": {
                            k: r["hit_max_abs_err"] for k, r in geometries.items() if k.endswith("_float64")
                        },
                        "geometries_kernel": {
                            k: {f: r[f] for f in ("rays", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
                            for k, r in geometries.items()
                            if "kernel_ms" in r
                        },
                        "geometries_stepwise_max_rel": {
                            k: r["stepwise"]["state_max_rel"] for k, r in geometries.items() if "stepwise" in r
                        },
                        "kinds012_bit_for_bit": all(geometries["kinds012_bit_for_bit"].values()),
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
                            "thick_geometries_render": thick["launches"],
                            "callable_geometries_render": warped["launches"],
                            "ctf_lineprofile": ctf["launches"],
                            "binning_lineprofile": binned["launches"],
                            "reverberation_golden": lags["reverberation_golden"]["transfer_functions"]["launches"],
                            "lag_frequency_full": lags["lag_frequency_full"]["launches"],
                            "ring_corona": lags["ring_corona"]["launches"],
                            "lagtransfer_semianalytic": lags["lagtransfer_semianalytic"]["transfer_functions"][
                                "launches"
                            ],
                            "profiled_lineprofile_f32": lags["profiled_lineprofile"]["f32"]["ctf_launches"],
                            "profiled_lineprofile_f64": lags["profiled_lineprofile"]["f64"]["ctf_launches"],
                        },
                        "lag_transfer_functions": {
                            "reverberation_golden": lags["reverberation_golden"]["transfer_functions"],
                            "lag_frequency_full": {
                                **lags["lag_frequency_full"]["split"]["transferfunctions"],
                                **lags["lag_frequency_full"]["transfer_functions_kernel"],
                            },
                            "lagtransfer_semianalytic": lags["lagtransfer_semianalytic"]["transfer_functions"],
                            "ring_corona": {
                                **lags["ring_corona"]["split"]["transferfunctions"],
                                **lags["ring_corona"]["transfer_functions_kernel"],
                            },
                            "profiled_lineprofile_f32": lags["profiled_lineprofile"]["f32"]["ctf_kernel"],
                            "profiled_lineprofile_f64": lags["profiled_lineprofile"]["f64"]["ctf_kernel"],
                        },
                        "ctf_launches_per_profile": ctf["launches_per_profile"],
                        "ctf_device_events_per_launch": ctf["device_events_per_launch"],
                        "chain": {
                            "longest_attempts": chain["ray"]["longest_attempts"],
                            "ray_ms": chain["ray"]["ms"],
                            "ray_us_per_attempt": chain["ray"]["us_per_longest_attempt"],
                            "ray_share_of_full": chain["ray_share_of_full"],
                        },
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
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.exit(_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
