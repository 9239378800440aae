"""Count the integrator kernel's arithmetic, per ray start, per attempted
step and per polished hit, for the bound that `chip_smoke.py` puts beside
the kernel's time.

The CUDA sources of `csrc/` are compiled for the host with g++, their
``<<<...>>>`` launch turned into a loop over blocks and threads and the
CUDA qualifiers stubbed, and instantiated with a scalar that counts every
addition or subtraction, multiplication, division, square root and
transcendental call (sin, cos, log, exp, pow) it takes part in. Rays made
by the port's camera and constraint on the CPU run through it once with
``max_steps = 0`` (the start: initial step and first crossing test), then to
their end without the Newton polish of the hits and with it (3 iterations,
`CudaTracer`'s default): the difference over the hits is the polish's cost
per hit. Prints one JSON object: for each case, the operations per ray
start, per attempted step and per polished hit, and their split by kind.

    python -m gradus_tpu_torch.opcount

Needs g++; builds into ``build/gradus_tpu_torch/opcount/``. The same host
build, instantiated with float and double, is the kernel's library with
its C entry points (`host_library`): `cuda_solver._launch_kernel` runs it
on CPU tensors, a rehearsal of an edited kernel against its plain version
before a card runs it.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "gradus_tpu_torch" / "opcount"
KINDS = ("add", "mul", "div", "sqrt", "transcendental")

_STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline uint3 threadIdx, blockIdx;
inline dim3 blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline long long op_counts[5];
struct Counted {
  double x;
  Counted() = default;
  Counted(double v) : x(v) {}
  explicit operator int() const { return int(x); }
};
inline Counted operator+(Counted a, Counted b) { ++op_counts[0]; return a.x + b.x; }
inline Counted operator-(Counted a, Counted b) { ++op_counts[0]; return a.x - b.x; }
inline Counted operator*(Counted a, Counted b) { ++op_counts[1]; return a.x * b.x; }
inline Counted operator/(Counted a, Counted b) { ++op_counts[2]; return a.x / b.x; }
inline Counted operator-(Counted a) { return -a.x; }
inline bool operator<(Counted a, Counted b) { return a.x < b.x; }
inline bool operator>(Counted a, Counted b) { return a.x > b.x; }
inline bool operator<=(Counted a, Counted b) { return a.x <= b.x; }
inline bool operator>=(Counted a, Counted b) { return a.x >= b.x; }
inline bool operator==(Counted a, Counted b) { return a.x == b.x; }
inline bool operator!=(Counted a, Counted b) { return a.x != b.x; }
inline Counted sqrt(Counted a) { ++op_counts[3]; return std::sqrt(a.x); }
inline Counted sin(Counted a) { ++op_counts[4]; return std::sin(a.x); }
inline Counted cos(Counted a) { ++op_counts[4]; return std::cos(a.x); }
inline Counted log(Counted a) { ++op_counts[4]; return std::log(a.x); }
inline Counted exp(Counted a) { ++op_counts[4]; return std::exp(a.x); }
inline Counted atan(Counted a) { ++op_counts[4]; return std::atan(a.x); }
inline Counted tan(Counted a) { ++op_counts[4]; return std::tan(a.x); }
inline Counted tanh(Counted a) { ++op_counts[4]; return std::tanh(a.x); }
inline Counted atan2(Counted a, Counted b) { ++op_counts[4]; return std::atan2(a.x, b.x); }
inline Counted pow(Counted a, Counted b) { ++op_counts[4]; return std::pow(a.x, b.x); }
inline Counted sinh(Counted a) { ++op_counts[4]; return std::sinh(a.x); }
inline Counted cosh(Counted a) { ++op_counts[4]; return std::cosh(a.x); }
inline Counted asin(Counted a) { ++op_counts[4]; return std::asin(a.x); }
inline Counted acos(Counted a) { ++op_counts[4]; return std::acos(a.x); }
inline Counted floor(Counted a) { return std::floor(a.x); }
inline Counted fabs(Counted a) { return std::fabs(a.x); }
inline bool isfinite(Counted a) { return std::isfinite(a.x); }
using std::sin; using std::cos; using std::sqrt; using std::fabs; using std::log;
using std::exp; using std::pow; using std::isfinite; using std::atan; using std::atan2;
using std::tan; using std::tanh; using std::sinh; using std::cosh; using std::asin; using std::acos;
using std::floor;
"""

_HARNESS = r"""
HARNESS_INCLUDES
#include <vector>

extern "C" int count_ops(const double* y0, int64_t n, int metric, double M, double a,
                         const double* q, int geometry, double inner_r, double outer_r,
                         double height, const double* geo, double abstol, double reltol, double r_inner,
                         double r_outer, double lam0, double lam1, int max_steps,
                         double dt_min, const int* modes, long long* counts,
                         int32_t* status, int32_t* attempts) {
  std::vector<Counted> y(y0, y0 + 8 * n), f8a(8 * n), f8b(8 * n), f[6];
  for (auto& v : f) v.resize(n);
  std::vector<int32_t> i4[3];
  for (auto& v : i4) v.resize(n);
  void* const out[gradus::kOutputs] = {
      f8a.data(), f8b.data(), f[0].data(), f[1].data(), f[2].data(), status,
      i4[0].data(), i4[1].data(), f[3].data(), f[4].data(), f[5].data(), attempts,
      i4[2].data()};
  std::vector<Counted> g(geo, geo + (geo != nullptr ? 2 + int(geo[1]) * gradus::kPartStride : 0));
  for (auto& c : op_counts) c = 0;
  const int rc = gradus::launch_entry<Counted>(
      y.data(), n, metric, M, a, q, geometry, inner_r, outer_r, height,
      geo != nullptr ? g.data() : nullptr, abstol,
      reltol, r_inner, r_outer, lam0, lam1, max_steps, dt_min, modes, nullptr, out,
      nullptr, HARNESS_LAUNCH);
  for (int k = 0; k < 5; ++k) counts[k] = op_counts[k];
  return rc;
}
"""


def _host_sources():
    """The sources of `csrc/` for the host, in ``_BUILD``: the launch a loop
    over blocks and threads, `cuda_runtime.h` a stub."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    for src in list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")):
        text = src.read_text()
        if src.name == "tsit5.cuh":
            launch = re.compile(r"geodesic_tsit5_kernel<T, Metric, P, kGeneric><<<.*?>>>\((.*?)\);", re.S)
            text, n = launch.subn(
                lambda m: (
                    "for (unsigned b_ = 0; b_ < unsigned(blocks); ++b_)"
                    " for (unsigned t_ = 0; t_ < unsigned(threads); ++t_) {"
                    " blockIdx.x = b_; threadIdx.x = t_; blockDim.x = threads;"
                    f" geodesic_tsit5_kernel<T, Metric, P, kGeneric>({m.group(1)}); }}"
                ),
                text,
            )
            if n != 1:
                raise RuntimeError("the kernel launch in tsit5.cuh was not found")
        _write(_BUILD / src.name, text)
    _write(_BUILD / "cuda_runtime.h", _STUB)
    return "\n".join(f'#include "{src.name}"' for src in sorted(_CSRC.glob("*.cu")))


def _write(path, text):
    """Writes ``path`` by an atomic rename unless it holds ``text``: a
    process that builds beside another (a test worker) never reads a
    half-written header."""
    if path.exists() and path.read_text() == text:
        return
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def _gxx(source: str, name: str, opt: str) -> Path:
    _write(_BUILD / f"{name}.cpp", source)
    lib = _BUILD / f"lib{name}.so"
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
    subprocess.run(
        ["g++", "-std=c++17", opt, "-shared", "-fPIC", "-I", str(_BUILD), "-o", str(tmp), str(_BUILD / f"{name}.cpp")],
        check=True,
    )
    os.replace(tmp, lib)
    return lib


def host_library() -> ctypes.CDLL:
    """The kernel's library built for the host (g++, no FMA contraction),
    with `_build`'s C entry points; ``_build._lib = host_library()`` and
    `torch.cuda.device`/`current_stream` stubbed let `_launch_kernel` run
    it on CPU tensors."""
    from gradus_tpu_torch import _build

    so = ctypes.CDLL(str(_gxx(_host_sources(), "host_kernel", "-O2")))
    _build._declare(so)
    return so


def host_callable_library(unit) -> ctypes.CDLL:
    """A generated unit (`geometry.codegen.kernel_unit`) built for the host
    as `host_library` builds the library, with its C entry point; placed in
    ``_build._callable_libs`` under its key, `_launch_kernel` runs it on
    CPU tensors (with `torch.cuda.device`/`current_stream` stubbed)."""
    from gradus_tpu_torch import _build

    _host_sources()
    so = ctypes.CDLL(str(_gxx(unit.source, f"host_callable_{_build.callable_key(unit.source)}", "-O2")))
    _build._declare(so, (unit.entry,))
    return so


def host_cross_sections(functions) -> ctypes.CDLL:
    """The device functions that `geometry.codegen` generates from the torch
    callables ``functions``, built for the host (g++) with, for each k, a C
    function ``cross_section_<k>(x, t, n, value, tangent, scalar)`` over n
    doubles: the value and tangent of the function at x along t (its
    ``Dual1<double>`` instantiation) and its value alone (its ``double``
    one)."""
    from gradus_tpu_torch.geometry import codegen

    _host_sources()
    parts = ["#include \"dual.cuh\"\n#include <cstdint>\nnamespace gradus {\n"]
    for k, f in enumerate(functions):
        parts.append(codegen.cross_section_source(f, f"h_{k}"))
        parts.append(
            f'extern "C" void cross_section_{k}(const double* x, const double* t, int64_t n, double* v, double* d, double* s) {{\n'
            f"  for (int64_t i = 0; i < n; ++i) {{\n"
            f"    const Dual1<double> r = h_{k}<double>(Dual1<double>{{x[i], t[i]}});\n"
            f"    v[i] = r.v;\n    d[i] = r.d;\n    s[i] = h_{k}<double>(x[i]);\n  }}\n}}\n"
        )
    parts.append("}  // namespace gradus\n")
    source = "".join(parts)
    import hashlib

    so = ctypes.CDLL(str(_gxx(source, f"cross_sections_{hashlib.sha256(source.encode()).hexdigest()[:16]}", "-O2")))
    vp = ctypes.c_void_p
    for k in range(len(functions)):
        fn = getattr(so, f"cross_section_{k}")
        fn.argtypes = [vp, vp, ctypes.c_int64, vp, vp, vp]
        fn.restype = None
    return so


def host_metric_components(metrics) -> ctypes.CDLL:
    """The classes that `metrics.codegen` generates from the traced
    metrics ``metrics`` (`TracedMetric`s), built for the host (g++) with,
    for each k, a C function ``metric_<k>(r, th, n, M, a, q, out)`` over n
    points: ``out`` holds 20 n doubles, the 5 components, their ∂_r and
    their ∂_θ (the class's ``Dual2<double>`` instantiation of a traced
    ``components5``, its ``double`` one of a traced ``components5_jac``),
    then the 5 components of its ``double`` instantiation; ``q`` holds the
    5 parameters of ``p.q``."""
    import hashlib

    _host_sources()
    parts = ['#include "callable.cuh"\n#include <cstdint>\nnamespace gradus {\n']
    for k, t in enumerate(metrics):
        jac = t.method == "components5_jac"
        parts.append(f"namespace m{k} {{\n{t.source}}}  // namespace m{k}\n")
        parts.append(
            f'extern "C" void metric_{k}(const double* r, const double* th, int64_t n, double M, double a, const double* q, double* out) {{\n'
            "  DeformedParams<double> p;\n  p.M = M;\n  p.a = a;\n"
            "  for (int j = 0; j < kMetricParams; ++j) p.q[j] = q[j];\n"
            "  for (int64_t i = 0; i < n; ++i) {\n"
            "    double v[5], dr[5], dth[5], s[5];\n"
        )
        if jac:
            parts.append(f"    m{k}::TracedMetric::components5_jac(p, r[i], th[i], v, dr, dth);\n    for (int c = 0; c < 5; ++c) s[c] = v[c];\n")
        else:
            parts.append(
                "    Dual2<double> g[5];\n"
                f"    m{k}::TracedMetric::components5(p, Dual2<double>{{r[i], 1.0, 0.0}}, Dual2<double>{{th[i], 0.0, 1.0}}, g);\n"
                "    for (int c = 0; c < 5; ++c) {\n      v[c] = g[c].v;\n      dr[c] = g[c].dr;\n      dth[c] = g[c].dth;\n    }\n"
                f"    m{k}::TracedMetric::components5(p, r[i], th[i], s);\n"
            )
        parts.append(
            "    for (int c = 0; c < 5; ++c) {\n"
            "      out[c * n + i] = v[c];\n      out[(5 + c) * n + i] = dr[c];\n"
            "      out[(10 + c) * n + i] = dth[c];\n      out[(15 + c) * n + i] = s[c];\n    }\n  }\n}\n"
        )
    parts.append("}  // namespace gradus\n")
    source = "".join(parts)
    so = ctypes.CDLL(str(_gxx(source, f"metric_components_{hashlib.sha256(source.encode()).hexdigest()[:16]}", "-O2")))
    vp, dbl = ctypes.c_void_p, ctypes.c_double
    for k in range(len(metrics)):
        fn = getattr(so, f"metric_{k}")
        fn.argtypes = [vp, vp, ctypes.c_int64, dbl, dbl, vp, vp]
        fn.restype = None
    return so


def _declare_counting(so):
    vp, dbl, i32, i64 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int64
    so.count_ops.argtypes = [
        vp, i64, i32, dbl, dbl, ctypes.POINTER(dbl), i32, dbl, dbl, dbl, ctypes.POINTER(dbl),
        dbl, dbl, dbl, dbl, dbl, dbl, i32, dbl, ctypes.POINTER(i32), vp, vp, vp,
    ]
    so.count_ops.restype = ctypes.c_int
    return so


def build(unit=None) -> ctypes.CDLL:
    """Build the counting library from the sources of `csrc/` and load it;
    with a generated ``unit``, from the unit's cross-sections (its launch
    instantiated with the counting scalar)."""
    includes = _host_sources()
    if unit is None:
        harness = _HARNESS.replace("HARNESS_INCLUDES", includes).replace("HARNESS_LAUNCH", "gradus::launch_metric<Counted>")
        return _declare_counting(ctypes.CDLL(str(_gxx(harness, "opcount", "-O1"))))
    from gradus_tpu_torch import _build

    harness = _HARNESS.replace("HARNESS_INCLUDES", unit.body).replace("HARNESS_LAUNCH", unit.launch("Counted"))
    return _declare_counting(ctypes.CDLL(str(_gxx(harness, f"opcount_{_build.callable_key(unit.source)}", "-O1"))))


def _rays(m, x_obs, alpha, beta, tracer):
    from gradus_tpu_torch.camera import map_impact_parameters

    x = torch.tensor(x_obs, dtype=torch.float64)
    v = map_impact_parameters(m, x, torch.as_tensor(alpha), torch.as_tensor(beta))
    return tracer._constrain(x.expand_as(v), v)


def count(so, m, geometry, y0, lam_span, **tracer_kw):
    """(operations per ray start, per attempted step and per polished hit,
    the split of each by kind, rays, attempts, hits) for the rays ``y0`` of
    a `CudaTracer`."""
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer, _geometry_args, _metric_args
    from gradus_tpu_torch.integrate.status import StatusCodes

    tracer = CudaTracer(m, geometry=geometry, **tracer_kw)
    kw = tracer._integrate_kwargs(torch.float64)
    kind, M, a, q = _metric_args(m)
    geo, inner_r, outer_r, height, block = _geometry_args(geometry)
    block = None if block is None else (ctypes.c_double * len(block))(*block)
    y = np.ascontiguousarray(y0.t().numpy())
    n = y0.shape[0]
    results = []
    for max_steps, newton_iters in ((0, 0), (kw["max_steps"], 0), (kw["max_steps"], kw["newton_iters"])):
        modes = (ctypes.c_int * 5)(
            int(kw["event_method"] == "sampled"), kw["n_interp"], kw["bisect_iters"], 1, newton_iters
        )
        counts = np.zeros(5, np.int64)
        status = np.zeros(n, np.int32)
        attempts = np.zeros(n, np.int32)
        rc = so.count_ops(
            y.ctypes.data, n, kind, M, a, q, geo, inner_r, outer_r, height, block,
            kw["abstol"], kw["reltol"], kw["r_inner"], kw["r_outer"], float(lam_span[0]),
            float(lam_span[1]), max_steps, 1e-10, modes, counts.ctypes.data, status.ctypes.data,
            attempts.ctypes.data,
        )
        if rc != 0:
            raise RuntimeError(f"count_ops failed: {rc}")
        results.append((counts, int(attempts.sum()), int((status == StatusCodes.IntersectedWithGeometry).sum())))
    (start, _, _), (total, attempts, hits), (polished, _, _) = results
    per_step = (total - start) / attempts
    per_hit = (polished - total) / max(hits, 1)
    return dict(
        rays=n,
        attempts=attempts,
        hits=hits,
        ops_per_start=float(start.sum() / n),
        ops_per_step=float(per_step.sum()),
        ops_per_hit=float(per_hit.sum()),
        start_by_kind=dict(zip(KINDS, (start / n).tolist())),
        step_by_kind=dict(zip(KINDS, per_step.tolist())),
        hit_by_kind=dict(zip(KINDS, per_hit.tolist())),
    )


def _generic_cases(m):
    """(name, geometry, tracer keywords) of chip_smoke.py's generic
    geometries (`THICK_KINDS`), as the docs build them."""
    from gradus_tpu_torch import geometry as G
    from gradus_tpu_torch.metrics import JohannsenMetric

    cpu = dict(device="cpu")
    ellipse = G.EllipticalDisc(0.0, 100.0, 60.0, **cpu)
    ss = G.ShakuraSunyaev.from_metric(m, 0.3)
    composite6 = G.CompositeGeometry(
        [G.ThinDisc(r, r + 10.0, **cpu) for r in (0.0, 10.0, 20.0, 30.0)]
        + [G.PrecessingDisc(G.ThinDisc(40.0, 60.0, **cpu), math.radians(10.0), math.radians(30.0), **cpu),
           G.EllipticalDisc(60.0, 100.0, 80.0, **cpu)]
    )  # fmt: skip
    return (
        ("shakura_sunyaev", ss, {}),
        ("shakura_sunyaev_sampled", ss, dict(event_method="sampled")),
        ("elliptical", ellipse, {}),
        ("precessing_elliptical", G.PrecessingDisc(ellipse, math.radians(10.0), math.radians(30.0), **cpu), {}),
        ("precessing_thin", G.PrecessingDisc(G.ThinDisc(0.0, 50.0, **cpu), math.radians(20.0), math.radians(30.0), **cpu), {}),
        ("composite", G.CompositeGeometry([G.ThinDisc(20.0, 100.0, **cpu), G.DatumPlane(3.0, **cpu)]), {}),
        ("composite6", composite6, {}),
        ("doughnut", G.PolishDoughnut(**cpu), {}),
        ("doughnut_kerr", G.PolishDoughnut(metric=m), {}),
        ("doughnut_johannsen", G.PolishDoughnut(metric=JohannsenMetric(float(m.M), float(m.a), **cpu)), {}),
    )


def _callable_cases(m):
    """(name, geometry, tracer keywords) of chip_smoke.py's cross-section
    callables (`CALLABLE_KINDS`), as it builds them."""
    from gradus_tpu_torch import geometry as G

    cpu = dict(device="cpu")
    ss = G.ShakuraSunyaev.from_metric(m, 0.3)
    h0, r_in = float(3.0 * ss.inv_eta * ss.mdot_over_edd), float(ss.inner_r)
    warp = G.WarpedThinDisc(lambda rho: 2.0 * torch.sin(rho / 10.0), 0.0, 100.0, **cpu)
    thick_ss = G.ThickDisc(lambda rho: torch.where(rho < r_in, -0.0, h0 * (1.0 - torch.sqrt(r_in / rho.clamp(min=1e-12)))), **cpu)
    return (
        ("warped", warp, {}),
        ("thick_shakura_sunyaev", thick_ss, {}),
        ("precessing_warped", G.PrecessingDisc(warp, 0.17, 0.5, **cpu), {}),
        ("composite_callable", G.CompositeGeometry([G.ThinDisc(0.0, 20.0, **cpu), G.ThickDisc(lambda rho: 0.1 * rho - 2.0, **cpu)]), {}),
        ("precessing_datum", G.PrecessingDisc(G.DatumPlane(1.0, **cpu), 0.1, 0.2, **cpu), {}),
    )


def main(n: int = 512):
    from gradus_tpu_torch.geometry import DatumPlane, ThinDisc
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer, _kernel_unit
    from gradus_tpu_torch.metrics import JohannsenPsaltisMetric, KerrMetric, KerrNewmanMetric

    so = build()
    rng = np.random.default_rng(0)
    cpu = dict(device="cpu")
    flagship = [0.0, 1000.0, math.radians(75.0), 0.0]
    alpha, beta = rng.uniform(-28.0, 28.0, n), rng.uniform(-18.0, 18.0, n)
    rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
    out = {}
    for name, m, d, x_obs, (a_, b_), span, tkw in (
        ("kerr_thin_disc", KerrMetric(1.0, 0.998, **cpu), ThinDisc(0.0, 50.0, **cpu), flagship, (alpha, beta), (0.0, 2200.0), {}),
        (
            "johannsen_psaltis_thin_disc",
            JohannsenPsaltisMetric(1.0, 0.6, 2.0, **cpu),
            ThinDisc(0.0, 50.0, **cpu),
            flagship,
            (alpha, beta),
            (0.0, 2200.0),
            {},
        ),
        (
            "kerr_newman_thin_disc",
            KerrNewmanMetric(1.0, 0.5, 0.3, **cpu),
            ThinDisc(0.0, 50.0, **cpu),
            flagship,
            (alpha, beta),
            (0.0, 2200.0),
            {},
        ),
        *(
            (f"kerr_{kind}", KerrMetric(1.0, 0.998, **cpu), geometry, flagship, (alpha, beta), (0.0, 2200.0), tkw)
            for kind, geometry, tkw in _generic_cases(KerrMetric(1.0, 0.998, **cpu)) + _callable_cases(KerrMetric(1.0, 0.998, **cpu))
        ),
        (
            "kerr_datum_plane",
            KerrMetric(1.0, 0.998, **cpu),
            DatumPlane(0.0, **cpu),
            [0.0, 1000.0, math.radians(60.0), 0.0],
            (rho * np.cos(th), rho * np.sin(th)),
            (0.0, 2000.0),
            dict(chart_outer=2000.0),
        ),
    ):
        y0 = _rays(m, x_obs, a_, b_, CudaTracer(m, geometry=d, **tkw))
        unit = _kernel_unit(m, d, torch.float64)
        out[name] = count(so if unit is None else build(unit), m, d, y0, span, **tkw)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
