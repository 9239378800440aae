// The adaptive Tsit5 geodesic integrator with disc-crossing events, as a
// kernel template over the metric: one CUDA thread integrates one ray from
// its initial state (or from a saved carry) to its end. `geodesic_tsit5.cu`
// instantiates it for Kerr (hand-derived Jacobian), the other
// `geodesic_tsit5_*.cu` files for the metrics whose Jacobian comes from
// forward-mode dual numbers (`metrics.cuh`). The design note is at the top
// of `geodesic_tsit5.cu`.
//
// A Metric is a type with
//   static __device__ void rhs(const P& p, const T* y, T* f);
// that writes the geodesic right-hand side f = (v, a) of the state y, for
// its parameter struct P: Params<T> for Kerr, DeformedParams<T> for the
// dual-number metrics. Kerr's kernel thus takes the same physics arguments
// as before the dual-number metrics came.
//
// The modes of the TPU kernel (gradus_tpu/integrate/pallas_solver.py) are
// runtime arguments of every instantiation (Modes, Carry), so a capped pass
// and its resumption run the same machine code as a single pass:
//   - events: the cubic model of the crossing indicator (the default) or
//     n_interp Hermite samples of it with bisection (:358-399);
//   - terminate on hit (the default), or count the crossings and fly on
//     (:413-430; the port counts in an output of its own, `crossings`, where
//     the TPU kernel adds 1 to the last state slot, v^phi);
//   - a fresh start, or the resumption of a saved carry (:182-240), and a
//     cap on a ray's loop iterations (max_steps, per ray here, per tile of
//     1024 rays on the TPU).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace gradus {

constexpr int S = 8;

// PI step-size controller constants (gradus_tpu/integrate/solver.py:57-63)
constexpr double kGamma = 0.9;
constexpr double kBeta1 = 7.0 / 50.0;
constexpr double kBeta2 = 2.0 / 25.0;
constexpr double kQmaxFactor = 10.0;
constexpr double kQminFactor = 0.2;
constexpr double kLnQoldInit = -9.210340371976182;  // log(1e-4)

// Status codes (integrate/status.py)
constexpr int kOutOfDomain = 1;
constexpr int kWithinInnerBoundary = 2;
constexpr int kIntersectedWithGeometry = 3;

// Geometry kind 2 (kinds 0 and 1, none and ThinDisc, are told apart by
// geometry != 0)
constexpr int kDatumPlane = 2;

// Metric kinds (integrate/cuda_solver.py::_KERNEL_METRICS)
constexpr int kMetricKerr = 0;
constexpr int kMetricJohannsen = 1;
constexpr int kMetricJohannsenPsaltis = 2;
constexpr int kMetricNoZ = 3;
constexpr int kMetricBumblebee = 4;
constexpr int kMetricDilatonAxion = 5;
constexpr int kMetricKerrNewman = 6;
constexpr int kMetricMorrisThorne = 7;
constexpr int kMetricKerrRefractive = 8;
constexpr int kMetricKerrDarkMatter = 9;
constexpr int kMetricSpherical = 10;
constexpr int kMetricCartesian = 11;
constexpr int kMetricParams = 5;

// Tsit5 tableau (integrate/tsit5.py)
constexpr double A21 = 0.161;
constexpr double A31 = -0.008480655492356989, A32 = 0.335480655492357;
constexpr double A41 = 2.8971530571054935, A42 = -6.359448489975075,
                 A43 = 4.3622954328695815;
constexpr double A51 = 5.325864828439257, A52 = -11.748883564062828,
                 A53 = 7.4955393428898365, A54 = -0.09249506636175525;
constexpr double A61 = 5.86145544294642, A62 = -12.92096931784711,
                 A63 = 8.159367898576159, A64 = -0.071584973281401,
                 A65 = -0.028269050394068383;
constexpr double A71 = 0.09646076681806523, A72 = 0.01,
                 A73 = 0.4798896504144996, A74 = 1.379008574103742,
                 A75 = -3.290069515436081, A76 = 2.324710524099774;
constexpr double BT1 = -0.00178001105222577714, BT2 = -0.0008164344596567469,
                 BT3 = 0.007880878010261995, BT4 = -0.1447110071732629,
                 BT5 = 0.5823571654525552, BT6 = -0.45808210592918697,
                 BT7 = 0.015151515151515152;

template <typename T>
struct Params {
  T M, a;
  int geometry;  // 0 = none, 1 = ThinDisc, 2 = DatumPlane
  T inner_r, outer_r;  // ThinDisc
  T height;            // DatumPlane
  T abstol, reltol;
  T r_inner, r_outer;
  T lam0, lam1;
  T lam1_eps;  // lam1 - 1e-12, rounded once as the reference does
  int max_steps;
  T dt_min;
};

// Params and a dual-number metric's own parameters (metrics.cuh)
template <typename T>
struct DeformedParams : Params<T> {
  T q[kMetricParams];
};

// How a launch runs, beside the physics of Params.
struct Modes {
  int sampled;           // 0: cubic events; 1: sampled events
  int n_interp;          // sampled: Hermite samples of the indicator a step
  int bisect_iters;      // sampled: bisections of the first sign change
  double theta_step;     // sampled: 1 / n_interp, as numpy.linspace takes it
  int terminate_on_hit;  // 0: count the crossings and fly on
};

// The carry a resumed launch starts from (integrate/cuda_solver.py::
// _STATE_KEYS): the TPU kernel's ten fields and the port's crossing count,
// all null for a fresh start. k1 is state-major (8, n) like y0.
template <typename T>
struct Carry {
  const T* k1;
  const T* lam;
  const T* dt;
  const T* ln_qold;
  const int32_t* status;
  const int32_t* steps;
  const int32_t* failed;
  const T* c_prev;
  const T* dc_prev;
  const T* hit_theta;
  const int32_t* crossings;
};

// The 13 outputs, in the order of integrate/cuda_solver.py::_OUTPUT_KEYS.
constexpr int kOutputs = 13;
template <typename T>
struct Outputs {
  T* y;
  T* k1;
  T* lam;
  T* dt;
  T* ln_qold;
  int32_t* status;
  int32_t* steps;
  int32_t* failed;
  T* c_prev;
  T* dc_prev;
  T* hit_theta;
  int32_t* attempts;
  int32_t* crossings;
};

// Everything a launch takes besides the physics.
template <typename T>
struct Launch {
  const T* y0;
  int64_t n;
  Modes modes;
  Carry<T> carry;
  Outputs<T> out;
  void* stream;
};

// max/min that propagate NaN, as jnp.maximum / jnp.minimum do (fmax/fmin
// would drop the NaN and let a non-finite step through).
template <typename T>
__device__ __forceinline__ T mx(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T mn(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return mn(mx(x, lo), hi);
}

// Crossing indicator c = r cos(theta) (ThinDisc) or r cos(theta) - height
// (DatumPlane, gradus_tpu/geometry/discs.py:170-171) and its derivative along
// the velocity, the same for both (v^r cos(theta) - r sin(theta) v^theta):
// the jvp of pallas_solver.py:178-179 in closed form.
template <typename T>
__device__ __forceinline__ void crossing_jvp(const Params<T>& p, const T* pos,
                                             const T* vel, T& c, T& dc) {
  const T s = sin(pos[2]);
  const T co = cos(pos[2]);
  c = pos[1] * co;
  if (p.geometry == kDatumPlane) c = c - p.height;
  dc = vel[1] * co - pos[1] * s * vel[2];
}

// ThinDisc.is_hit_c (gradus_tpu/geometry/discs.py:123-125)
template <typename T>
__device__ __forceinline__ bool thin_disc_hit(const Params<T>& p, T r, T th) {
  const T rho = r * fabs(sin(th));
  return (rho >= p.inner_r) && (rho <= p.outer_r);
}

// The crossing indicator's value alone, for the sampled events.
template <typename T>
__device__ __forceinline__ T crossing_value(const Params<T>& p, T r, T th) {
  const T c = r * cos(th);
  return p.geometry == kDatumPlane ? c - p.height : c;
}

// The cubic Hermite interpolant of r and theta over a step
// (pallas_solver.py:136-147, the two components the events read).
template <typename T>
__device__ __forceinline__ void hermite_rth(T t, const T* y, const T* y_new,
                                            const T* f0, const T* f1, T dt,
                                            T& r, T& th) {
  const T h00 = (T(1) + T(2) * t) * ((T(1) - t) * (T(1) - t));
  const T h10 = t * ((T(1) - t) * (T(1) - t));
  const T h01 = t * t * (T(3) - T(2) * t);
  const T h11 = t * t * (t - T(1));
  r = h00 * y[1] + h10 * dt * f0[1] + h01 * y_new[1] + h11 * dt * f1[1];
  th = h00 * y[2] + h10 * dt * f0[2] + h01 * y_new[2] + h11 * dt * f1[2];
}

// theta_k = k / n_interp as numpy.linspace(0, 1, n_interp + 1) gives it.
template <typename T>
__device__ __forceinline__ T theta_at(const Modes& md, int k) {
  return k == md.n_interp ? T(1) : T(double(k) * md.theta_step);
}

// The sampled event of pallas_solver.py:358-399: the first sign change of
// the indicator among n_interp Hermite samples over the step, narrowed by
// bisect_iters bisections. Returns whether a sign change was found, its
// theta, and the indicator at the step end (the next step's c_prev).
template <typename T>
__device__ __forceinline__ bool sampled_crossing(const Params<T>& p, const Modes& md,
                                                 T c_prev, const T* y, const T* y_new,
                                                 const T* f0, const T* f1, T dt,
                                                 T& theta, T& c_end) {
  bool found = false;
  T th_lo = T(0), th_hi = T(1), c_lo = c_prev, c_left = c_prev;
  for (int k = 0; k < md.n_interp; ++k) {
    const T th_r = theta_at<T>(md, k + 1);
    T r, th;
    hermite_rth(th_r, y, y_new, f0, f1, dt, r, th);
    const T c_right = crossing_value(p, r, th);
    if (((c_left < T(0)) != (c_right < T(0))) && !found) {
      th_lo = theta_at<T>(md, k);
      th_hi = th_r;
      c_lo = c_left;
      found = true;
    }
    c_left = c_right;
  }
  c_end = c_left;
  if (found) {
    for (int it = 0; it < md.bisect_iters; ++it) {
      const T mid = T(0.5) * (th_lo + th_hi);
      T r, th;
      hermite_rth(mid, y, y_new, f0, f1, dt, r, th);
      const T cm = crossing_value(p, r, th);
      if ((cm < T(0)) == (c_lo < T(0))) {
        th_lo = mid;
        c_lo = cm;
      } else {
        th_hi = mid;
      }
    }
  }
  theta = T(0.5) * (th_lo + th_hi);
  return found;
}

// First sign change in (0, 1] of the Hermite cubic with c(0)=c0, c'(0)=m0,
// c(1)=c1, c'(1)=m1 (gradus_tpu/integrate/events.py:31-95, 26 bisections).
template <typename T>
__device__ __forceinline__ bool cubic_first_crossing(T c0, T m0, T c1, T m1,
                                                     T& theta) {
  const T a = T(2) * c0 - T(2) * c1 + m0 + m1;
  const T b = T(-3) * c0 + T(3) * c1 - T(2) * m0 - m1;
  const T c = m0;
  auto poly = [&](T t) { return ((a * t + b) * t + c) * t + c0; };

  const T A = T(3) * a;
  const T B = T(2) * b;
  const T disc = B * B - T(4) * A * c;
  const bool real = disc >= T(0);
  const T sq = real ? sqrt(disc) : T(0);
  const bool tiny = fabs(A) < T(1e-30) * (T(1) + fabs(B));
  const T safe_A = tiny ? T(1) : A;
  T r1 = (-B - sq) / (T(2) * safe_A);
  T r2 = (-B + sq) / (T(2) * safe_A);
  const T lin = -c / (fabs(B) < T(1e-30) ? T(1) : B);
  r1 = real ? (tiny ? lin : r1) : T(0);
  r2 = real ? (tiny ? lin : r2) : T(0);
  const T t1 = clip(mn(r1, r2), T(0), T(1));
  const T t2 = clip(mx(r1, r2), T(0), T(1));

  const T nodes[4] = {T(0), t1, t2, T(1)};
  const T vals[4] = {c0, poly(t1), poly(t2), c1};
  bool found = false;
  T lo = T(0), hi = T(1), cl = c0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool sc = ((vals[k] < T(0)) != (vals[k + 1] < T(0))) && !found;
    if (sc) {
      lo = nodes[k];
      hi = nodes[k + 1];
      cl = vals[k];
      found = true;
    }
  }
  for (int it = 0; it < 26; ++it) {
    const T mid = T(0.5) * (lo + hi);
    const T cm = poly(mid);
    if ((cm < T(0)) == (cl < T(0))) {
      lo = mid;
      cl = cm;
    } else {
      hi = mid;
    }
  }
  theta = found ? T(0.5) * (lo + hi) : T(0);
  return found;
}

// Hairer-Norsett-Wanner initial step (pallas_solver.py:105-133); writes
// f(y) into f0.
template <class Metric, typename T, class P>
__device__ __forceinline__ T initial_dt(const P& p, const T* y, T* f0) {
  Metric::rhs(p, y, f0);
  T d0sq = T(0), d1sq = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const T sc = p.abstol + fabs(y[i]) * p.reltol;
    const T a = y[i] / sc;
    const T b = f0[i] / sc;
    d0sq = d0sq + a * a;
    d1sq = d1sq + b * b;
  }
  const T d0 = sqrt(d0sq / T(S));
  const T d1 = sqrt(d1sq / T(S));
  const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6)
                                               : T(0.01) * d0 / mx(d1, T(1e-30));
  T y1[S], f1[S];
#pragma unroll
  for (int i = 0; i < S; ++i) y1[i] = y[i] + h0 * f0[i];
  Metric::rhs(p, y1, f1);
  T d2sq = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const T sc = p.abstol + fabs(y[i]) * p.reltol;
    const T c = (f1[i] - f0[i]) / sc;
    d2sq = d2sq + c * c;
  }
  const T d2 = sqrt(d2sq / T(S)) / h0;
  const T dmax = mx(d1, d2);
  const T h1 = dmax <= T(1e-15) ? mx(T(1e-6), h0 * T(1e-3))
                                : pow(T(0.01) / dmax, T(1) / T(5));
  return mn(T(100) * h0, h1);
}

template <typename T, class Metric, class P>
__global__ void __launch_bounds__(128)
    geodesic_tsit5_kernel(P p, Modes md, Carry<T> in, const T* __restrict__ y0,
                          int64_t n, T* __restrict__ y_out, T* __restrict__ k1_out,
                          T* __restrict__ lam_out, T* __restrict__ dt_out,
                          T* __restrict__ lnq_out, int32_t* __restrict__ status_out,
                          int32_t* __restrict__ steps_out,
                          int32_t* __restrict__ failed_out,
                          T* __restrict__ cprev_out, T* __restrict__ dcprev_out,
                          T* __restrict__ hth_out,
                          int32_t* __restrict__ attempts_out,
                          int32_t* __restrict__ crossings_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T y[S], k1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) y[s] = y0[s * n + i];

  T lam, dt, ln_qold, c_prev, dc_prev, hit_th;
  int status, steps, crossings;
  bool alive, failed;
  const bool disc = p.geometry != 0;
  if (in.lam != nullptr) {
    // resume the saved carry; only a ray still mid-flight goes on
    // (pallas_solver.py:222-240)
#pragma unroll
    for (int s = 0; s < S; ++s) k1[s] = in.k1[s * n + i];
    lam = in.lam[i];
    dt = in.dt[i];
    ln_qold = in.ln_qold[i];
    status = in.status[i];
    steps = in.steps[i];
    failed = in.failed[i] != 0;
    c_prev = in.c_prev[i];
    dc_prev = in.dc_prev[i];
    hit_th = in.hit_theta[i];
    crossings = in.crossings[i];
    alive = status == 0 && !failed && lam < p.lam1_eps;
  } else {
    lam = p.lam0;
    dt = initial_dt<Metric>(p, y, k1);
    dt = mn(dt, p.lam1 - lam);
    bool finite0 = isfinite(dt);
#pragma unroll
    for (int s = 0; s < S; ++s) finite0 = finite0 && isfinite(y[s]) && isfinite(k1[s]);
    alive = finite0;
    failed = !finite0;
    status = 0;
    steps = 0;
    crossings = 0;
    ln_qold = T(kLnQoldInit);
    c_prev = T(0);
    dc_prev = T(0);
    hit_th = T(0);
    if (disc) {
      crossing_jvp(p, y, k1, c_prev, dc_prev);
      if (md.sampled) dc_prev = T(0);  // the sampled events read no slope
    }
  }
  int attempts = 0;

  while (alive && attempts < p.max_steps) {
    ++attempts;
    const T dt_eff = mn(mx(p.lam1 - lam, p.dt_min), dt);

    // --- one FSAL Tsit5 step ------------------------------------------------
    T k2[S], k3[S], k4[S], k5[S], k6[S], k7[S], y_new[S], tmp[S];
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + dt_eff * (T(A21) * k1[s]);
    Metric::rhs(p, tmp, k2);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A31) * k1[s] + T(A32) * k2[s]);
    Metric::rhs(p, tmp, k3);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A41) * k1[s] + T(A42) * k2[s] + T(A43) * k3[s]);
    Metric::rhs(p, tmp, k4);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A51) * k1[s] + T(A52) * k2[s] + T(A53) * k3[s] +
                                T(A54) * k4[s]);
    Metric::rhs(p, tmp, k5);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A61) * k1[s] + T(A62) * k2[s] + T(A63) * k3[s] +
                                T(A64) * k4[s] + T(A65) * k5[s]);
    Metric::rhs(p, tmp, k6);
#pragma unroll
    for (int s = 0; s < S; ++s)
      y_new[s] = y[s] + dt_eff * (T(A71) * k1[s] + T(A72) * k2[s] + T(A73) * k3[s] +
                                  T(A74) * k4[s] + T(A75) * k5[s] + T(A76) * k6[s]);
    Metric::rhs(p, y_new, k7);

    // --- RMS error norm -------------------------------------------------------
    T acc = T(0);
    bool step_ok = true;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T e = dt_eff * (T(BT1) * k1[s] + T(BT2) * k2[s] + T(BT3) * k3[s] +
                            T(BT4) * k4[s] + T(BT5) * k5[s] + T(BT6) * k6[s] +
                            T(BT7) * k7[s]);
      const T sc = p.abstol + mx(fabs(y[s]), fabs(y_new[s])) * p.reltol;
      const T q = e / sc;
      acc = acc + q * q;
      step_ok = step_ok && isfinite(y_new[s]);
    }
    T err = mx(sqrt(acc / T(S)), T(1e-12));
    step_ok = step_ok && isfinite(err);
    if (!step_ok) err = T(2);
    const bool accept = err <= T(1);

    // --- PI controller in log space ---------------------------------------------
    const T ln_err = log(err);
    const T q = exp(T(kBeta1) * ln_err - T(kBeta2) * ln_qold) / T(kGamma);
    const T fac_acc = T(1) / clip(q, T(1.0 / kQmaxFactor), T(1.0 / kQminFactor));
    const T fac_rej = T(1) / clip(exp(T(0.2) * ln_err) / T(kGamma), T(1),
                                  T(1.0 / kQminFactor));
    const T dt_next = accept ? dt_eff * fac_acc : dt_eff * fac_rej;
    failed = !step_ok && (dt_next < p.dt_min || !isfinite(dt_next));
    if (accept) ln_qold = mx(ln_err, T(kLnQoldInit));
    const T lam_new = lam + dt_eff;

    // --- disc event -----------------------------------------------------------
    bool hit_now = false;
    if (disc && !md.sampled) {
      // on the cubic model of the indicator
      T c1v, dc1v, th_c;
      crossing_jvp(p, y_new, k7, c1v, dc1v);
      const bool found =
          cubic_first_crossing(c_prev, dt_eff * dc_prev, c1v, dt_eff * dc1v, th_c);
      if (found && accept && p.geometry == kDatumPlane) {
        // every crossing of the plane is a hit (discs.py:173-174)
        hit_now = true;
        hit_th = th_c;
      } else if (found && accept) {
        // ThinDisc: Hermite position at the crossing, only r and theta are read
        T rc, thc;
        hermite_rth(th_c, y, y_new, k1, k7, dt_eff, rc, thc);
        hit_now = thin_disc_hit(p, rc, thc);
        if (hit_now) hit_th = th_c;
      }
      if (accept) {
        c_prev = c1v;
        dc_prev = dc1v;
      }
    } else if (disc && accept) {
      // on n_interp samples of the indicator's interpolant
      T th_c, c_end;
      if (sampled_crossing(p, md, c_prev, y, y_new, k1, k7, dt_eff, th_c, c_end)) {
        hit_now = true;
        if (p.geometry != kDatumPlane) {
          T rc, thc;
          hermite_rth(th_c, y, y_new, k1, k7, dt_eff, rc, thc);
          hit_now = thin_disc_hit(p, rc, thc);
        }
        if (hit_now) hit_th = th_c;
      }
      c_prev = c_end;
    }

    // --- chart bounds and span end, at step end ---------------------------------
    const T r_new = y_new[1];
    const bool inner = accept && !hit_now && (r_new <= p.r_inner);
    const bool outer = accept && !hit_now && (r_new > p.r_outer);
    const bool finished = accept && (lam_new >= p.lam1_eps);
    if (inner) status = kWithinInnerBoundary;
    if (outer) status = kOutOfDomain;
    steps += accept ? 1 : 0;
    crossings += hit_now ? 1 : 0;

    const bool stop_at_hit = hit_now && md.terminate_on_hit;
    if (stop_at_hit) {
      // a hit does not commit its step: y, k1 and lam stay at the step start
      // and dt records the step span, for the post-kernel Newton polish
      status = kIntersectedWithGeometry;
      dt = dt_eff;
    } else {
      dt = dt_next;
      if (accept) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          y[s] = y_new[s];
          k1[s] = k7[s];
        }
        lam = lam_new;
      }
    }
    alive = !(stop_at_hit || inner || outer || finished || failed);
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    y_out[s * n + i] = y[s];
    k1_out[s * n + i] = k1[s];
  }
  lam_out[i] = lam;
  dt_out[i] = dt;
  lnq_out[i] = ln_qold;
  status_out[i] = status;
  steps_out[i] = steps;
  failed_out[i] = failed ? 1 : 0;
  cprev_out[i] = c_prev;
  dcprev_out[i] = dc_prev;
  hth_out[i] = hit_th;
  attempts_out[i] = attempts;
  crossings_out[i] = crossings;
}

template <typename T, class Metric, class P>
int launch(const P& p, const Launch<T>& l) {
  const int threads = 128;
  const int64_t blocks = (l.n + threads - 1) / threads;
  const Outputs<T>& o = l.out;
  geodesic_tsit5_kernel<T, Metric, P><<<dim3(unsigned(blocks)), dim3(threads), 0,
                                         static_cast<cudaStream_t>(l.stream)>>>(
      p, l.modes, l.carry, l.y0, l.n, o.y, o.k1, o.lam, o.dt, o.ln_qold, o.status,
      o.steps, o.failed, o.c_prev, o.dc_prev, o.hit_theta, o.attempts, o.crossings);
  return int(cudaGetLastError());
}

// The launches for the dual-number metric kinds, each defined in the file of
// its metric module: geodesic_tsit5_deformed.cu (kinds 1-5),
// geodesic_tsit5_exotic.cu (6-9: Kerr-Newman and exotic.py),
// geodesic_tsit5_minkowski.cu (10-11). Each returns cudaErrorInvalidValue
// for a kind it does not hold.
template <typename T>
int launch_deformed(int metric, const DeformedParams<T>& p, const Launch<T>& l);
template <typename T>
int launch_exotic(int metric, const DeformedParams<T>& p, const Launch<T>& l);
template <typename T>
int launch_minkowski(int metric, const DeformedParams<T>& p, const Launch<T>& l);

}  // namespace gradus
