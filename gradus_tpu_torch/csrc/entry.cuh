// The library's C entry points: the arguments of `_build.py::_declare`
// unpacked into tsit5.cuh's GenericParams and Launch, then handed to a
// launch for the metric kind (geodesic_tsit5.cu's, or a generated unit's
// for a geometry with callables, callable.cuh).
//
// metric: the metric kind; q: its parameters (metrics.cuh), 5 doubles on the
// host. geometry: its kind; inner_r, outer_r and height are those of kinds
// 1-2; geo: for kinds 3-9 the device pointer of its block of
// 2 + parts * kPartStride values of T (geometry.cuh), else unread. modes: 5 ints on
// the host (sampled, n_interp, bisect_iters, terminate_on_hit,
// newton_iters). carry: null for a fresh start, or the 11 device pointers
// of tsit5.cuh's Carry.
// out: the 13 device pointers of Outputs.

#pragma once

#include "tsit5.cuh"

namespace gradus {

template <typename T, class LaunchMetric>
int launch_entry(const void* y0, int64_t n, int metric, double M, double a, const double* q,
                 int geometry, double inner_r, double outer_r, double height, const void* geo,
                 double abstol, double reltol, double r_inner, double r_outer, double lam0,
                 double lam1, int max_steps, double dt_min, const int* modes,
                 const void* const* carry, void* const* out, void* stream,
                 LaunchMetric launch_metric) {
  Launch<T> l;
  l.y0 = static_cast<const T*>(y0);
  l.n = n;
  l.modes.sampled = modes[0];
  l.modes.n_interp = modes[1];
  l.modes.bisect_iters = modes[2];
  l.modes.theta_step = 1.0 / double(modes[1] > 0 ? modes[1] : 1);
  l.modes.terminate_on_hit = modes[3];
  l.modes.newton_iters = modes[4];
  const void* const none[11] = {};
  const void* const* c = carry != nullptr ? carry : none;
  l.carry = {static_cast<const T*>(c[0]),       static_cast<const T*>(c[1]),
             static_cast<const T*>(c[2]),       static_cast<const T*>(c[3]),
             static_cast<const int32_t*>(c[4]), static_cast<const int32_t*>(c[5]),
             static_cast<const int32_t*>(c[6]), static_cast<const T*>(c[7]),
             static_cast<const T*>(c[8]),       static_cast<const T*>(c[9]),
             static_cast<const int32_t*>(c[10])};
  l.out = {static_cast<T*>(out[0]),        static_cast<T*>(out[1]),
           static_cast<T*>(out[2]),        static_cast<T*>(out[3]),
           static_cast<T*>(out[4]),        static_cast<int32_t*>(out[5]),
           static_cast<int32_t*>(out[6]),  static_cast<int32_t*>(out[7]),
           static_cast<T*>(out[8]),        static_cast<T*>(out[9]),
           static_cast<T*>(out[10]),       static_cast<int32_t*>(out[11]),
           static_cast<int32_t*>(out[12])};
  l.stream = stream;

  GenericParams<T> p;
  p.M = T(M);
  p.a = T(a);
  p.geometry = geometry;
  p.inner_r = T(inner_r);
  p.outer_r = T(outer_r);
  p.height = T(height);
  p.abstol = T(abstol);
  p.reltol = T(reltol);
  p.r_inner = T(r_inner);
  p.r_outer = T(r_outer);
  p.lam0 = T(lam0);
  p.lam1 = T(lam1);
  p.lam1_eps = T(lam1 - 1e-12);
  p.max_steps = max_steps;
  p.dt_min = T(dt_min);
  for (int k = 0; k < kMetricParams; ++k) p.q[k] = T(q[k]);
  p.geo = static_cast<const T*>(geo);
  return launch_metric(metric, p, l);
}

}  // namespace gradus

// An extern "C" entry NAME for the scalar T, which launches through
// LAUNCH_METRIC(metric, params, launch).
#define GEODESIC_TSIT5_ENTRY(NAME, T, LAUNCH_METRIC)                                   \
  extern "C" int NAME(const void* y0, int64_t n, int metric, double M, double a,       \
                      const double* q, int geometry, double inner_r, double outer_r,   \
                      double height, const void* geo, double abstol, double reltol,    \
                      double r_inner, double r_outer, double lam0, double lam1,        \
                      int max_steps, double dt_min, const int* modes,                  \
                      const void* const* carry, void* const* out, void* stream) {      \
    return gradus::launch_entry<T>(y0, n, metric, M, a, q, geometry, inner_r, outer_r, \
                                   height, geo, abstol, reltol, r_inner, r_outer,      \
                                   lam0, lam1, max_steps, dt_min, modes, carry, out,   \
                                   stream, LAUNCH_METRIC);                             \
  }
