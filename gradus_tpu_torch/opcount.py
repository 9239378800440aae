"""Count the integrator kernel's arithmetic, per ray start and per attempted
step, for the bound that `chip_smoke.py` puts beside the kernel's time.

The CUDA sources of `csrc/` are compiled for the host with g++, their
``<<<...>>>`` launch turned into a loop over blocks and threads and the
CUDA qualifiers stubbed, and instantiated with a scalar that counts every
addition or subtraction, multiplication, division, square root and
transcendental call (sin, cos, log, exp, pow) it takes part in. Rays made
by the port's camera and constraint on the CPU run through it once with
``max_steps = 0`` (the start: initial step and first crossing test) and once
to their end. Prints one JSON object: for each case, the operations per ray
start and per attempted step, and their split by kind.

    python -m gradus_tpu_torch.opcount

Needs g++; builds into ``build/gradus_tpu_torch/opcount/``.
"""

from __future__ import annotations

import ctypes
import json
import math
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
#define __launch_bounds__(x)
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
inline Counted pow(Counted a, Counted b) { ++op_counts[4]; return std::pow(a.x, b.x); }
inline Counted fabs(Counted a) { return std::fabs(a.x); }
inline bool isfinite(Counted a) { return std::isfinite(a.x); }
using std::sin; using std::cos; using std::sqrt; using std::fabs; using std::log;
using std::exp; using std::pow; using std::isfinite; using std::atan;
"""

_HARNESS = r"""
HARNESS_INCLUDES
#include <vector>

extern "C" int count_ops(const double* y0, int64_t n, int metric, double M, double a,
                         const double* q, int geometry, double inner_r, double outer_r,
                         double height, double abstol, double reltol, double r_inner,
                         double r_outer, double lam0, double lam1, int max_steps,
                         double dt_min, const int* modes, long long* counts,
                         int32_t* attempts) {
  std::vector<Counted> y(y0, y0 + 8 * n), f8a(8 * n), f8b(8 * n), f[6];
  for (auto& v : f) v.resize(n);
  std::vector<int32_t> i4[4];
  for (auto& v : i4) v.resize(n);
  void* const out[gradus::kOutputs] = {
      f8a.data(), f8b.data(), f[0].data(), f[1].data(), f[2].data(), i4[0].data(),
      i4[1].data(), i4[2].data(), f[3].data(), f[4].data(), f[5].data(), attempts,
      i4[3].data()};
  for (auto& c : op_counts) c = 0;
  const int rc = gradus::launch_metric<Counted>(
      y.data(), n, metric, M, a, q, geometry, inner_r, outer_r, height, abstol,
      reltol, r_inner, r_outer, lam0, lam1, max_steps, dt_min, modes, nullptr, out,
      nullptr);
  for (int k = 0; k < 5; ++k) counts[k] = op_counts[k];
  return rc;
}
"""


def build() -> ctypes.CDLL:
    """Build the counting library from the sources of `csrc/` and load it."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    for src in list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")):
        text = src.read_text()
        if src.name == "tsit5.cuh":
            launch = re.compile(r"geodesic_tsit5_kernel<T, Metric, P><<<.*?>>>\((.*?)\);", re.S)
            text, n = launch.subn(
                lambda m: (
                    "for (unsigned b_ = 0; b_ < unsigned(blocks); ++b_)"
                    " for (unsigned t_ = 0; t_ < unsigned(threads); ++t_) {"
                    " blockIdx.x = b_; threadIdx.x = t_; blockDim.x = threads;"
                    f" geodesic_tsit5_kernel<T, Metric, P>({m.group(1)}); }}"
                ),
                text,
            )
            if n != 1:
                raise RuntimeError("the kernel launch in tsit5.cuh was not found")
        (_BUILD / src.name).write_text(text)
    (_BUILD / "cuda_runtime.h").write_text(_STUB)
    includes = "\n".join(f'#include "{src.name}"' for src in sorted(_CSRC.glob("*.cu")))
    (_BUILD / "harness.cpp").write_text(_HARNESS.replace("HARNESS_INCLUDES", includes))
    lib = _BUILD / "libopcount.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(_BUILD), "-o", str(lib), str(_BUILD / "harness.cpp")],
        check=True,
    )
    so = ctypes.CDLL(str(lib))
    vp, dbl, i32, i64 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int64
    so.count_ops.argtypes = [
        vp, i64, i32, dbl, dbl, ctypes.POINTER(dbl), i32, dbl, dbl, dbl,
        dbl, dbl, dbl, dbl, dbl, dbl, i32, dbl, ctypes.POINTER(i32), vp, vp,
    ]
    so.count_ops.restype = ctypes.c_int
    return so


def _rays(m, x_obs, alpha, beta, tracer):
    from gradus_tpu_torch.camera import map_impact_parameters

    x = torch.tensor(x_obs, dtype=torch.float64)
    v = map_impact_parameters(m, x, torch.as_tensor(alpha), torch.as_tensor(beta))
    return tracer._constrain(x.expand_as(v), v)


def count(so, m, geometry, y0, lam_span, **tracer_kw):
    """(operations per ray start, per attempted step, the split of each by
    kind, rays, attempts) for the rays ``y0`` of a `CudaTracer`."""
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer, _metric_args

    tracer = CudaTracer(m, geometry=geometry, **tracer_kw)
    kw = tracer._integrate_kwargs(torch.float64)
    kind, M, a, q = _metric_args(m)
    modes = (ctypes.c_int * 4)(int(kw["event_method"] == "sampled"), kw["n_interp"], kw["bisect_iters"], 1)
    if geometry is None:
        geo, inner_r, outer_r, height = 0, 0.0, 0.0, 0.0
    elif hasattr(geometry, "height"):
        geo, inner_r, outer_r, height = 2, 0.0, 0.0, float(geometry.height)
    else:
        geo, inner_r, outer_r, height = 1, float(geometry.inner_r), float(geometry.outer_r), 0.0
    y = np.ascontiguousarray(y0.t().numpy())
    n = y0.shape[0]
    results = []
    for max_steps in (0, kw["max_steps"]):
        counts = np.zeros(5, np.int64)
        attempts = np.zeros(n, np.int32)
        rc = so.count_ops(
            y.ctypes.data, n, kind, M, a, q, geo, inner_r, outer_r, height,
            kw["abstol"], kw["reltol"], kw["r_inner"], kw["r_outer"], float(lam_span[0]),
            float(lam_span[1]), max_steps, 1e-10, modes, counts.ctypes.data, attempts.ctypes.data,
        )
        if rc != 0:
            raise RuntimeError(f"count_ops failed: {rc}")
        results.append((counts, int(attempts.sum())))
    (start, _), (total, attempts) = results
    per_step = (total - start) / attempts
    return dict(
        rays=n,
        attempts=attempts,
        ops_per_start=float(start.sum() / n),
        ops_per_step=float(per_step.sum()),
        start_by_kind=dict(zip(KINDS, (start / n).tolist())),
        step_by_kind=dict(zip(KINDS, per_step.tolist())),
    )


def main(n: int = 512):
    from gradus_tpu_torch.geometry import DatumPlane, ThinDisc
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer
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
        out[name] = count(so, m, d, y0, span, **tkw)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
