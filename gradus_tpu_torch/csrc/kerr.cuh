// The Kerr metric's right-hand side with its hand-derived Jacobian, the
// kernel's Metric for Kerr (tsit5.cuh), in a header of its own so that
// geodesic_tsit5.cu and a generic instantiation's file (geodesic_tsit5_
// generic_*.cu) share it.

#pragma once

#include "tsit5.cuh"

namespace gradus {

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

  // the components' values (gradus_tpu/metrics/kerr.py:45-60), for a
  // PolishDoughnut's potential (geometry.cuh)
  template <typename T>
  static __device__ __forceinline__ void components(T M, T a, const T*, T r, T th, T* g) {
    const T R = T(2) * M;
    const T s = sin(th);
    const T sin2 = s * s;
    const T sigma = r * r + a * a * (T(1) - sin2);
    const T inv_sigma = T(1) / sigma;
    const T gamma = sin2 * R * r * a;
    g[0] = -(T(1) - (R * r) * inv_sigma);
    g[1] = sigma / (r * r + a * a - R * r);
    g[2] = sigma;
    g[3] = sin2 * (r * r + a * a + (gamma * a) * inv_sigma);
    g[4] = -gamma * inv_sigma;
  }
};

}  // namespace gradus
