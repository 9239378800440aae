// Adaptive Tsit5 geodesic integrator with disc-crossing events: one CUDA
// thread integrates one ray from its initial state to its end. The kernel
// itself is the template in tsit5.cuh; this file holds the library's C entry
// points and Kerr's instantiation for geometry kinds 0-2 (its right-hand side
// is in kerr.cuh; every metric's instantiation for kinds 3-7 is in a
// geodesic_tsit5_generic_*.cu file).
//
// Replaces gradus_tpu/integrate/pallas_solver.py::_make_kernel (the Pallas TPU
// kernel launched by pallas_integrate_rays) in every mode a caller of the JAX
// package reaches with these geometries: cubic-Hermite or sampled events,
// terminate on hit or count the crossings, a fresh start or the resumption
// of a saved carry with a cap on the loop iterations, against a geometry
//   0  none
//   1  ThinDisc(inner_r, outer_r): crossings of theta = pi/2 inside the annulus
//   2  DatumPlane(height): every crossing of the plane r cos(theta) = height
//      (the Cunningham transfer-function solve; one height for all rays)
//   3-7  ShakuraSunyaev, EllipticalDisc, PolishDoughnut, PrecessingDisc,
//      CompositeGeometry of up to four parts (geometry.cuh; the kernel's
//      generic instantiation)
// and for every metric of gradus_tpu/metrics/: Kerr (kind 0, also the
// first-order Kerr class), with the hand-derived components5_jac below, or
// one of eleven metrics whose value and (d_r, d_theta) Jacobian come from one
// forward-mode pass over dual numbers with two tangents (metrics.cuh,
// dual.cuh; kinds 1-11, geodesic_tsit5_{deformed,exotic,minkowski}.cu), where
// the TPU kernel inlines two jax.jvp passes through components5. The rest
// of the TPU kernel's geometries (WarpedThinDisc and ThickDisc, which carry
// a Python callable that the TPU kernel inlines) are not ported.
//
// What bounds it on an H100: compute and instruction issue, and the serial
// chain of one ray's steps. Each accepted or rejected step is 7 evaluations
// of the geodesic right-hand side (sin/cos, the 5-component metric with its
// r- and theta-derivatives, the inverse and the Christoffel contraction),
// the 6-stage Runge-Kutta sums, the error norm, one log and one exp for the
// controller, and on an accepted step the event test. A hit adds its Newton
// polish: newton_iters + 1 Tsit5 sub-steps of 5 right-hand sides each.
// There is no device-memory traffic inside the loop: a ray reads its 8
// initial values once (a resumed ray its carry too, 18 more) and writes 27
// values once. The dual-number right-hand side carries three values through
// every operation of the metric, so it costs more operations and registers
// than Kerr's closed form.
//
// What the design does about it: the whole integrator carry (state, FSAL
// derivative, step size, controller and event state) stays in registers for
// the ray's lifetime, and every thread leaves its loop as soon as its own ray
// is done, so the warp (not a 1024-ray tile) is the unit of early exit. Work
// the TPU's lockstep lanes compute and throw away is skipped per thread: the
// controller computes only the factor of the step's outcome, the event test
// runs on accepted steps only, and the cubic event bisects only a sign
// change it found. A hit is polished where the hit step's start is still in
// registers, as the ray's last loop iterations: each sub-step runs the
// step's own stage code, so a warp's polishing lanes take the same
// instructions as its stepping lanes and the kernel holds one inlined copy
// of the stages (a separate epilogue after the loop, run once all the
// warp's lanes had left it, took 4-20% more kernel time than this form on
// the f32 1024² renders of Kerr, Johannsen-Psaltis and Kerr-Newman on an
// H100, and more registers). No pass over every ray after the kernel
// remains. The kernel is a template over the metric, so each
// instantiation inlines its own right-hand side. Metric and disc
// parameters, tolerances, the affine span and the modes are runtime
// arguments, so one build serves every configuration, and a capped pass and
// its resumption run the same machine code.
//
// Layout: inputs and outputs are state-major, (8, n) and (n,), contiguous,
// so neighbouring threads touch neighbouring addresses.
//
// Built with nvcc for sm_90a without --use_fast_math: the tolerances of the
// comparison with the plain PyTorch version assume IEEE sin/cos/log/exp/sqrt
// and IEEE division.

#include "kerr.cuh"

namespace gradus {
namespace {

template <typename T>
int launch_metric(const void* y0, int64_t n, int metric, double M, double a,
                  const double* q, int geometry, double inner_r, double outer_r,
                  double height, const void* geo, double abstol, double reltol, double r_inner,
                  double r_outer, double lam0, double lam1, int max_steps,
                  double dt_min, const int* modes, const void* const* carry,
                  void* const* out, void* stream) {
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
  if (metric == kMetricKerr) return launch<T, Kerr, Params<T>>(p, l);
  if (metric <= kMetricDilatonAxion) return launch_deformed<T>(metric, p, l);
  if (metric <= kMetricKerrDarkMatter) return launch_exotic<T>(metric, p, l);
  return launch_minkowski<T>(metric, p, l);
}

}  // namespace
}  // namespace gradus

// metric: the metric kind; q: its parameters (metrics.cuh), 5 doubles on the
// host. geometry: its kind; inner_r, outer_r and height are those of kinds
// 1-2; geo: for kinds 3-7 the device pointer of its block of
// kGeometryValues values of T (geometry.cuh), else unread. modes: 5 ints on
// the host (sampled, n_interp, bisect_iters, terminate_on_hit,
// newton_iters). carry: null for a fresh start, or the 11 device pointers
// of tsit5.cuh's Carry.
// out: the 13 device pointers of Outputs.
#define GEODESIC_TSIT5_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* y0, int64_t n, int metric, double M,          \
                      double a, const double* q, int geometry, double inner_r,  \
                      double outer_r, double height, const void* geo,           \
                      double abstol, double reltol, double r_inner,             \
                      double r_outer, double lam0, double lam1, int max_steps,  \
                      double dt_min, const int* modes,                          \
                      const void* const* carry, void* const* out,               \
                      void* stream) {                                           \
    return gradus::launch_metric<T>(y0, n, metric, M, a, q, geometry, inner_r,  \
                                    outer_r, height, geo, abstol, reltol,       \
                                    r_inner, r_outer, lam0, lam1, max_steps,    \
                                    dt_min, modes, carry, out, stream);         \
  }

GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f32, float)
GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f64, double)
