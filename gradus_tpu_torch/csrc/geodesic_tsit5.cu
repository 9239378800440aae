// Adaptive Tsit5 geodesic integrator with disc-crossing events: one CUDA
// thread integrates one ray from its initial state to its end. The kernel
// itself is the template in tsit5.cuh; this file holds the Kerr right-hand
// side and the library's C entry points.
//
// Replaces gradus_tpu/integrate/pallas_solver.py::_make_kernel (the Pallas TPU
// kernel launched by pallas_integrate_rays) in every mode a caller of the JAX
// package reaches with these geometries: cubic-Hermite or sampled events,
// terminate on hit or count the crossings, a fresh start or the resumption
// of a saved carry with a cap on the loop iterations, against one of three
// geometry kinds
//   0  none
//   1  ThinDisc(inner_r, outer_r): crossings of theta = pi/2 inside the annulus
//   2  DatumPlane(height): every crossing of the plane r cos(theta) = height
//      (the Cunningham transfer-function solve; one height for all rays)
// and for every metric of gradus_tpu/metrics/: Kerr (kind 0, also the
// first-order Kerr class), with the hand-derived components5_jac below, or
// one of eleven metrics whose value and (d_r, d_theta) Jacobian come from one
// forward-mode pass over dual numbers with two tangents (metrics.cuh,
// dual.cuh; kinds 1-11, geodesic_tsit5_{deformed,exotic,minkowski}.cu), where
// the TPU kernel inlines two jax.jvp passes through components5. The rest
// of the TPU kernel's geometries (warped and thick discs, which carry a
// Python callable) are not ported.
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

#include "tsit5.cuh"

namespace gradus {
namespace {

// Kerr metric components and their r- and theta-derivatives
// (gradus_tpu/metrics/kerr.py:45-101), then the geodesic acceleration
// (gradus_tpu/geodesics/equation.py:94-134). f = (v, a).
template <typename T>
__device__ __forceinline__ void geodesic_rhs(const Params<T>& p, const T* y,
                                             T* f) {
  const T r = y[1], th = y[2];
  const T vt = y[4], vr = y[5], vth = y[6], vph = y[7];
  const T M = p.M, a = p.a;
  const T R = T(2) * M;
  const T s = sin(th);
  const T c = cos(th);
  const T sin2 = s * s;
  const T ds2 = T(2) * s * c;
  const T cos2 = T(1) - sin2;
  const T a2 = a * a;
  const T r2 = r * r;

  const T sigma = r2 + a2 * cos2;
  const T sig_r = T(2) * r;
  const T sig_th = -a2 * ds2;
  const T inv_sigma = T(1) / sigma;
  const T inv_sig2 = inv_sigma * inv_sigma;
  const T delta = r2 + a2 - R * r;
  const T del_r = T(2) * r - R;
  const T inv_delta = T(1) / delta;
  const T gamma = sin2 * R * r * a;
  const T gam_r = sin2 * R * a;
  const T gam_th = ds2 * R * r * a;

  const T tt = -(T(1) - (R * r) * inv_sigma);
  const T tt_r = R * (sigma - r * sig_r) * inv_sig2;
  const T tt_th = -(R * r) * sig_th * inv_sig2;

  const T rr = sigma * inv_delta;
  const T rr_r = (sig_r * delta - sigma * del_r) * inv_delta * inv_delta;
  const T rr_th = sig_th * inv_delta;

  const T hh = sigma;
  const T hh_r = sig_r;
  const T hh_th = sig_th;

  const T u = gamma * a * inv_sigma;
  const T u_r = a * (gam_r * sigma - gamma * sig_r) * inv_sig2;
  const T u_th = a * (gam_th * sigma - gamma * sig_th) * inv_sig2;
  const T w = r2 + a2 + u;
  const T pp = sin2 * w;
  const T pp_r = sin2 * (T(2) * r + u_r);
  const T pp_th = ds2 * w + sin2 * u_th;

  const T tp = -gamma * inv_sigma;
  const T tp_r = -(gam_r * sigma - gamma * sig_r) * inv_sig2;
  const T tp_th = -(gam_th * sigma - gamma * sig_th) * inv_sig2;

  // inverse of the 5-component symmetric form
  const T inv_det = T(1) / (tt * pp - tp * tp);
  const T gi_tt = pp * inv_det;
  const T gi_phph = tt * inv_det;
  const T gi_tph = -tp * inv_det;
  const T gi_rr = T(1) / rr;
  const T gi_thth = T(1) / hh;

  // (J v)_rho for J = d_r g and J = d_theta g
  const T J1v_t = tt_r * vt + tp_r * vph;
  const T J1v_r = rr_r * vr;
  const T J1v_th = hh_r * vth;
  const T J1v_ph = tp_r * vt + pp_r * vph;
  const T q1 = vt * J1v_t + vr * J1v_r + vth * J1v_th + vph * J1v_ph;
  const T J2v_t = tt_th * vt + tp_th * vph;
  const T J2v_r = rr_th * vr;
  const T J2v_th = hh_th * vth;
  const T J2v_ph = tp_th * vt + pp_th * vph;
  const T q2 = vt * J2v_t + vr * J2v_r + vth * J2v_th + vph * J2v_ph;

  const T A_t = vr * J1v_t + vth * J2v_t;
  const T A_r = vr * J1v_r + vth * J2v_r - T(0.5) * q1;
  const T A_th = vr * J1v_th + vth * J2v_th - T(0.5) * q2;
  const T A_ph = vr * J1v_ph + vth * J2v_ph;

  f[0] = vt;
  f[1] = vr;
  f[2] = vth;
  f[3] = vph;
  f[4] = -(gi_tt * A_t + gi_tph * A_ph);
  f[5] = -gi_rr * A_r;
  f[6] = -gi_thth * A_th;
  f[7] = -(gi_tph * A_t + gi_phph * A_ph);
}

struct Kerr {
  template <typename T>
  static __device__ __forceinline__ void rhs(const Params<T>& p, const T* y,
                                             T* f) {
    geodesic_rhs(p, y, f);
  }
};

template <typename T>
int launch_metric(const void* y0, int64_t n, int metric, double M, double a,
                  const double* q, int geometry, double inner_r, double outer_r,
                  double height, double abstol, double reltol, double r_inner,
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

  DeformedParams<T> p;
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
  if (metric == kMetricKerr) return launch<T, Kerr>(static_cast<const Params<T>&>(p), l);
  if (metric <= kMetricDilatonAxion) return launch_deformed<T>(metric, p, l);
  if (metric <= kMetricKerrDarkMatter) return launch_exotic<T>(metric, p, l);
  return launch_minkowski<T>(metric, p, l);
}

}  // namespace
}  // namespace gradus

// metric: the metric kind; q: its parameters (metrics.cuh), 5 doubles on the
// host. modes: 5 ints on the host (sampled, n_interp, bisect_iters,
// terminate_on_hit, newton_iters). carry: null for a fresh start, or the 11
// device pointers of tsit5.cuh's Carry. out: the 13 device pointers of
// Outputs.
#define GEODESIC_TSIT5_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* y0, int64_t n, int metric, double M,          \
                      double a, const double* q, int geometry, double inner_r,  \
                      double outer_r, double height, double abstol,             \
                      double reltol, double r_inner, double r_outer,            \
                      double lam0, double lam1, int max_steps, double dt_min,   \
                      const int* modes, const void* const* carry,               \
                      void* const* out, void* stream) {                         \
    return gradus::launch_metric<T>(y0, n, metric, M, a, q, geometry, inner_r,  \
                                    outer_r, height, abstol, reltol, r_inner,   \
                                    r_outer, lam0, lam1, max_steps, dt_min,     \
                                    modes, carry, out, stream);                 \
  }

GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f32, float)
GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f64, double)
