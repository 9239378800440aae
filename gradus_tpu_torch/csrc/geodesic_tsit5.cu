// Adaptive Tsit5 geodesic integrator with cubic disc-crossing events: one
// CUDA thread integrates one ray from its initial state to its end.
//
// Replaces gradus_tpu/integrate/pallas_solver.py::_make_kernel (the Pallas TPU
// kernel launched by pallas_integrate_rays), in the modes the flagship render
// and the two line profiles use: Kerr metric (hand-derived components5_jac),
// cubic-Hermite events, terminate on hit, fresh start, and one of three
// geometry kinds:
//   0  none
//   1  ThinDisc(inner_r, outer_r): crossings of theta = pi/2 inside the annulus
//   2  DatumPlane(height): every crossing of the plane r cos(theta) = height
//      (the Cunningham transfer-function solve; one height for all rays)
//
// What bounds it on an H100: compute and instruction issue. Each accepted or
// rejected step is 7 evaluations of the geodesic right-hand side (sin/cos,
// the 5-component Kerr metric with its r- and theta-derivatives, the inverse
// and the Christoffel contraction), the 6-stage Runge-Kutta sums, the error
// norm, one log and two exp for the controller, and the cubic event test.
// There is no device-memory traffic inside the loop: a ray reads its 8
// initial values once and writes ~30 values once.
//
// What the design does about it: the whole integrator carry (state, FSAL
// derivative, step size, controller and event state) stays in registers for
// the ray's lifetime, and every thread leaves its loop as soon as its own ray
// is done, so the warp (not a 1024-ray tile) is the unit of early exit. Metric
// and disc parameters, tolerances and the affine span are runtime arguments,
// so one build serves every configuration.
//
// Layout: inputs and outputs are state-major, (8, n) and (n,), contiguous,
// so neighbouring threads touch neighbouring addresses.
//
// Built with nvcc for sm_90a without --use_fast_math: the tolerances of the
// comparison with the plain PyTorch version assume IEEE sin/cos/log/exp/sqrt
// and IEEE division.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

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
template <typename T>
__device__ __forceinline__ T initial_dt(const Params<T>& p, const T* y, T* f0) {
  geodesic_rhs(p, y, f0);
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
  geodesic_rhs(p, y1, f1);
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

template <typename T>
__global__ void __launch_bounds__(128)
    geodesic_tsit5_kernel(Params<T> p, const T* __restrict__ y0, int64_t n,
                          T* __restrict__ y_out, T* __restrict__ k1_out,
                          T* __restrict__ lam_out, T* __restrict__ dt_out,
                          T* __restrict__ lnq_out, int32_t* __restrict__ status_out,
                          int32_t* __restrict__ steps_out,
                          int32_t* __restrict__ failed_out,
                          T* __restrict__ cprev_out, T* __restrict__ dcprev_out,
                          T* __restrict__ hth_out,
                          int32_t* __restrict__ attempts_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T y[S], k1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) y[s] = y0[s * n + i];

  T lam = p.lam0;
  T dt = initial_dt(p, y, k1);
  dt = mn(dt, p.lam1 - lam);
  bool finite0 = isfinite(dt);
#pragma unroll
  for (int s = 0; s < S; ++s) finite0 = finite0 && isfinite(y[s]) && isfinite(k1[s]);
  bool alive = finite0;
  bool failed = !finite0;

  int status = 0;
  int steps = 0;
  int attempts = 0;
  T ln_qold = T(kLnQoldInit);
  T c_prev = T(0), dc_prev = T(0), hit_th = T(0);
  const bool disc = p.geometry != 0;
  if (disc) crossing_jvp(p, y, k1, c_prev, dc_prev);

  while (alive && attempts < p.max_steps) {
    ++attempts;
    const T dt_eff = mn(mx(p.lam1 - lam, p.dt_min), dt);

    // --- one FSAL Tsit5 step ------------------------------------------------
    T k2[S], k3[S], k4[S], k5[S], k6[S], k7[S], y_new[S], tmp[S];
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + dt_eff * (T(A21) * k1[s]);
    geodesic_rhs(p, tmp, k2);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A31) * k1[s] + T(A32) * k2[s]);
    geodesic_rhs(p, tmp, k3);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A41) * k1[s] + T(A42) * k2[s] + T(A43) * k3[s]);
    geodesic_rhs(p, tmp, k4);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A51) * k1[s] + T(A52) * k2[s] + T(A53) * k3[s] +
                                T(A54) * k4[s]);
    geodesic_rhs(p, tmp, k5);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tmp[s] = y[s] + dt_eff * (T(A61) * k1[s] + T(A62) * k2[s] + T(A63) * k3[s] +
                                T(A64) * k4[s] + T(A65) * k5[s]);
    geodesic_rhs(p, tmp, k6);
#pragma unroll
    for (int s = 0; s < S; ++s)
      y_new[s] = y[s] + dt_eff * (T(A71) * k1[s] + T(A72) * k2[s] + T(A73) * k3[s] +
                                  T(A74) * k4[s] + T(A75) * k5[s] + T(A76) * k6[s]);
    geodesic_rhs(p, y_new, k7);

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

    // --- disc event on the cubic model of the indicator ------------------------
    bool hit_now = false;
    if (disc) {
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
        const T t = th_c;
        const T h00 = (T(1) + T(2) * t) * ((T(1) - t) * (T(1) - t));
        const T h10 = t * ((T(1) - t) * (T(1) - t));
        const T h01 = t * t * (T(3) - T(2) * t);
        const T h11 = t * t * (t - T(1));
        const T rc = h00 * y[1] + h10 * dt_eff * k1[1] + h01 * y_new[1] +
                     h11 * dt_eff * k7[1];
        const T thc = h00 * y[2] + h10 * dt_eff * k1[2] + h01 * y_new[2] +
                      h11 * dt_eff * k7[2];
        hit_now = thin_disc_hit(p, rc, thc);
        if (hit_now) hit_th = th_c;
      }
      if (accept) {
        c_prev = c1v;
        dc_prev = dc1v;
      }
    }

    // --- chart bounds and span end, at step end ---------------------------------
    const T r_new = y_new[1];
    const bool inner = accept && !hit_now && (r_new <= p.r_inner);
    const bool outer = accept && !hit_now && (r_new > p.r_outer);
    const bool finished = accept && (lam_new >= p.lam1_eps);
    if (inner) status = kWithinInnerBoundary;
    if (outer) status = kOutOfDomain;
    steps += accept ? 1 : 0;

    if (hit_now) {
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
    alive = !(hit_now || inner || outer || finished || failed);
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
}

template <typename T>
int launch(const void* y0, int64_t n, double M, double a, int geometry,
           double inner_r, double outer_r, double height, double abstol,
           double reltol, double r_inner, double r_outer, double lam0,
           double lam1, int max_steps, double dt_min, void* y, void* k1,
           void* lam, void* dt, void* lnq, void* status, void* steps,
           void* failed, void* cprev, void* dcprev, void* hth, void* attempts,
           void* stream) {
  Params<T> p;
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
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  geodesic_tsit5_kernel<T><<<dim3(unsigned(blocks)), dim3(threads), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const T*>(y0), n, static_cast<T*>(y), static_cast<T*>(k1),
      static_cast<T*>(lam), static_cast<T*>(dt), static_cast<T*>(lnq),
      static_cast<int32_t*>(status), static_cast<int32_t*>(steps),
      static_cast<int32_t*>(failed), static_cast<T*>(cprev),
      static_cast<T*>(dcprev), static_cast<T*>(hth),
      static_cast<int32_t*>(attempts));
  return int(cudaGetLastError());
}

}  // namespace

#define GEODESIC_TSIT5_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* y0, int64_t n, double M, double a,           \
                      int geometry, double inner_r, double outer_r,            \
                      double height, double abstol, double reltol,             \
                      double r_inner, double r_outer, double lam0,             \
                      double lam1, int max_steps, double dt_min, void* y,      \
                      void* k1, void* lam, void* dt, void* lnq, void* status,  \
                      void* steps, void* failed, void* cprev, void* dcprev,    \
                      void* hth, void* attempts, void* stream) {               \
    return launch<T>(y0, n, M, a, geometry, inner_r, outer_r, height, abstol,  \
                     reltol, r_inner, r_outer, lam0, lam1, max_steps, dt_min,  \
                     y, k1, lam, dt, lnq, status, steps, failed, cprev,        \
                     dcprev, hth, attempts, stream);                           \
  }

GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f32, float)
GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f64, double)
