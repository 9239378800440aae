// The metrics without a hand-derived Jacobian -- the five of
// gradus_tpu/metrics/deformed.py, Kerr-Newman (kerr_newman.py, uncharged
// rays), the three of exotic.py and the two of minkowski.py -- each as
//   template <typename T, class S>
//   static void components5(const DeformedParams<T>& p, S r, S th, S* g);
// writing g = (g_tt, g_rr, g_thth, g_phph, g_tphi) with the JAX package's
// expressions. The scalar S is T for a value, Dual2<T> for the value and
// its (d_r, d_theta) Jacobian; S{c} is a constant. Integer powers are
// products; the poles' 1/sin^2 (DilatonAxion) and 1/(1 - cos^2) (NoZ) are
// kept as they are, so a NaN fails a ray the same way as in the plain
// version. DualRhs, at the end, turns one of them into the kernel's
// right-hand side.
//
// Parameters: p.M and p.a (0 for a metric without them), and the other
// parameters in p.q, in the order of
// integrate/cuda_solver.py::_KERNEL_METRICS:
//   Johannsen           q = (alpha13, alpha22, alpha52, eps3)
//   JohannsenPsaltis    q = (eps3)
//   NoZ                 q = (eps)
//   Bumblebee           q = (l)
//   DilatonAxion        q = (beta, b, bb, ba, bab), the last three the
//                       guarded ratios beta/b, beta/a, beta/(a b), which
//                       depend on the parameters only and come from the host
//   KerrNewman          q = (Q)
//   MorrisThorne        q = (b)
//   KerrRefractive      q = (n, corona_radius)
//   KerrDarkMatter      q = (M_dark_matter, delta_r, r_s)
//   Spherical, Cartesian  q = ()

#pragma once

#include "dual.cuh"
#include "tsit5.cuh"

namespace gradus {

// reference src/metrics/johannsen-ad.jl:49-67
struct Johannsen {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a, a2 = a * a;
    const T alpha13 = p.q[0], alpha22 = p.q[1], alpha52 = p.q[2], eps3 = p.q[3];
    const S Mr = M / r;
    const S Mr2 = Mr * Mr;
    const S A1 = T(1) + alpha13 * (Mr2 * Mr);
    const S A2 = T(1) + alpha22 * Mr2;
    const S A5 = T(1) + alpha52 * Mr2;
    const S f = eps3 * (M * M * M) / r;
    const S s = sin(th);
    const S sin2 = s * s;
    const S r2 = r * r;
    const S sigma = r2 + a2 * (T(1) - sin2) + f;
    const S delta = r2 - T(2) * M * r + a2;
    const S r2a2 = r2 + a2;

    const S base = r2a2 * A1 - a2 * A2 * sin2;
    const S denom = base * base;
    const S tt = -sigma * (delta - a2 * A2 * A2 * sin2);
    const S pp = sigma * sin2 * (r2a2 * r2a2 * (A1 * A1) - a2 * delta * sin2);
    const S tp = -a * sigma * sin2 * (r2a2 * A1 * A2 - delta);
    g[0] = tt / denom;
    g[1] = sigma / (delta * A5);
    g[2] = sigma;
    g[3] = pp / denom;
    g[4] = tp / denom;
  }
};

// reference src/metrics/johannsen-psaltis-ad.jl
struct JohannsenPsaltis {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a, a2 = a * a;
    const T eps3 = p.q[0];
    const S s = sin(th);
    const S sin2 = s * s;
    const S r2 = r * r;
    const S sigma = r2 + a2 * (T(1) - sin2);
    const S h = eps3 * (M * M * M) * r / (sigma * sigma);
    const S delta = r2 - T(2) * M * r + a2;
    const S one_h = T(1) + h;
    const S twoMr = T(2) * M * r;

    g[0] = -one_h * (T(1) - twoMr / sigma);
    g[1] = sigma * one_h / (delta + a2 * sin2 * h);
    g[2] = sigma;
    const S term1 = sin2 * (r2 + a2 + T(2) * a2 * M * r * sin2 / sigma);
    const S term2 = h * a2 * (sigma + twoMr) * (sin2 * sin2) / sigma;
    g[3] = term1 + term2;
    g[4] = T(-2) * a * M * r * sin2 * one_h / sigma;
  }
};

// reference src/metrics/noz-metric.jl:55-120 (dy^2 = sin^2 dtheta^2 folded
// into g_thth)
struct NoZ {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a, a2 = a * a;
    const T eps = p.q[0];
    const S s = sin(th);
    const S sin2 = s * s;
    const S y = cos(th);
    const S y2 = y * y;
    const S e = eps * M * a * y;
    const S r2 = r * r;

    const S sig = r2 + a2 * y2;
    const S den = sig * sig + (r2 - T(2) * M * r + a2 * y2) * e;
    const S se = sig + e;
    const S one_y2 = T(1) - y2;

    g[0] = T(-1) + (T(2) * M * r * sig) / den;
    g[1] = se / (r2 - T(2) * M * r + a2);
    g[2] = se / one_y2 * sin2;
    g[3] = (one_y2 * se *
            (r2 * r2 + (a2 * a2) * y2 + r2 * (a2 + a2 * y2 + e) + a2 * e +
             T(2) * M * r * (a2 - a2 * y2 - e))) /
           den;
    g[4] = -(T(2) * M * r * a * one_y2 * se) / den;
  }
};

// reference src/metrics/bumblebee-ad.jl:25-52
struct Bumblebee {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a;
    const T l = p.q[0];
    const S s = sin(th);
    const S sin2 = s * s;
    const S r2 = r * r;
    const S delta = (r2 - T(2) * M * r) / (l + T(1));
    g[0] = -(T(1) - T(2) * M / r);
    g[1] = r2 / delta;
    g[2] = r2;
    g[3] = r2 * sin2;
    g[4] = T(-2) * M * a * sin2 / r;
  }
};

// reference src/metrics/dilaton-axion-ad.jl:57-76
struct DilatonAxion {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a, a2 = a * a;
    const T beta = p.q[0], b = p.q[1], bb = p.q[2], ba = p.q[3], bab = p.q[4];
    const T R = M;
    const S s = sin(th);
    const S c = cos(th);
    const S sin2 = s * s;
    const S csc2 = T(1) / sin2;
    const S r2 = r * r;
    const S sigma = r2 + a2 * (c * c);
    const S delta = r2 + a2 - T(2) * R * r;
    const S beta_b = beta * beta + T(2) * b * r;
    const S delta_hat = delta - beta_b - R * (R + T(2) * b) * bb * bb;
    const S sigma_hat = sigma - beta_b + R * R * bb * (bb - T(2) * a * c);
    const S dlt = r2 - T(2) * b * r + a2;
    const S W = T(1) + (bab * (T(2) * c - bab) + ba * ba) * csc2;
    const S Was = W * a * s;
    const S A = dlt * dlt - delta_hat * (Was * Was);

    g[0] = -(delta_hat - a2 * sin2) / sigma_hat;
    g[1] = sigma_hat / delta_hat;
    g[2] = sigma_hat;
    g[3] = A * sin2 / sigma_hat;
    g[4] = -a * (dlt - delta_hat * W) * sin2 / sigma_hat;
  }
};

// reference src/metrics/kerr-newman-ad.jl:1-26
struct KerrNewman {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a;
    const T Q = p.q[0];
    const T R = T(2) * M;
    const S s = sin(th);
    const S sin2 = s * s;
    const S ac = a * cos(th);
    const S sigma = r * r + ac * ac;
    const S delta = r * r - R * r + a * a + Q * Q;
    const S r2a2 = r * r + a * a;

    g[0] = (a * a * sin2 - delta) / sigma;
    g[1] = sigma / delta;
    g[2] = sigma;
    g[3] = (sin2 / sigma) * (r2a2 * r2a2 - a * a * sin2 * delta);
    g[4] = (a * sin2 / sigma) * (delta - r2a2);
  }
};

// reference src/metrics/morris-thorne-ad.jl:1-37; g_phph = (b^2 + l^2) sin(theta)
// as the reference writes it (not sin^2)
struct MorrisThorne {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T b = p.q[0];
    g[0] = S{T(-1)};
    g[1] = S{T(1)};
    g[2] = b * b + r * r;
    g[3] = (b * b + r * r) * sin(th);
    g[4] = S{T(0)};
  }
};

// the smoothed 1 -> 0 step at x0 of gradus_tpu/utils/linalg.py:128-136
// (dx = 2.5, smoothing offset 1e4)
template <typename T, class S>
__device__ __forceinline__ S smooth_step(S x, T x0) {
  const S t = (x - x0) / T(2.5);
  const S v = atan(T(1e4) * t) / T(3.141592653589793) + T(0.5);
  const S mid = T(1) - v;
  return select(x <= x0 - T(1.25), S{T(1)}, select(x >= x0 + T(1.25), S{T(0)}, mid));
}

// reference src/metrics/kerr-refractive-ad.jl:44-64
struct KerrRefractive {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T M = p.M, a = p.a;
    const T n = p.q[0], corona_radius = p.q[1];
    const T R = T(2) * M;
    const S s = sin(th);
    const S c = cos(th);
    const S sin2 = s * s;
    const S sigma = r * r + a * a * (c * c);
    const S delta = r * r - R * r + a * a;

    const S tt = -(T(1) - (R * r) / sigma);
    const S tp = (-R * r * a * sin2) / sigma;
    const S t = smooth_step(r, corona_radius);
    const S nn = t + (T(1) - t) * n;
    g[0] = tt / (nn * nn);
    g[1] = sigma / delta;
    g[2] = sigma;
    g[3] = sin2 * (r * r + a * a + (sin2 * R * r * a * a) / sigma);
    g[4] = tp / nn;
  }
};

// reference src/metrics/kerr-dark-matter.jl:1-72: Kerr with the mass
// M + m(r) of a smoothed shell between r_s and r_s + delta_r
struct KerrDarkMatter {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>& p, S r, S th, S* g) {
    const T a = p.a;
    const T M_dm = p.q[0], delta_r = p.q[1], r_s = p.q[2];
    const S dr = (r - r_s) / delta_r;
    const S G = (T(3) - T(2) * dr) * dr * dr;
    const S mass = select(r < r_s, S{T(0)}, select(r < r_s + delta_r, M_dm * G, S{M_dm}));
    const S M = p.M + mass;
    const S R = T(2) * M;
    const S s = sin(th);
    const S sin2 = s * s;
    const S cos2 = T(1) - sin2;
    const S sigma = r * r + a * a * cos2;
    const S delta = r * r + a * a - R * r;

    g[0] = -(T(1) - (R * r) / sigma);
    g[1] = sigma / delta;
    g[2] = sigma;
    g[3] = sin2 * (r * r + a * a + (sin2 * R * r * a * a) / sigma);
    g[4] = (-R * r * a * sin2) / sigma;
  }
};

// reference src/metrics/minkowski.jl: flat space in spherical coordinates
struct Spherical {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>&, S r, S th, S* g) {
    const S rs = r * sin(th);
    g[0] = S{T(-1)};
    g[1] = S{T(1)};
    g[2] = r * r;
    g[3] = rs * rs;
    g[4] = S{T(0)};
  }
};

// flat space in cartesian coordinates: diag(-1, 1, 1, 1)
struct Cartesian {
  template <typename T, class S>
  static __device__ __forceinline__ void components5(
      const DeformedParams<T>&, S, S, S* g) {
    g[0] = S{T(-1)};
    g[1] = S{T(1)};
    g[2] = S{T(1)};
    g[3] = S{T(1)};
    g[4] = S{T(0)};
  }
};

// --- the right-hand side of a metric above -----------------------------------

// a^mu = -g^{mu rho} [ (v^r d_r g + v^theta d_theta g)_{rho sigma} v^sigma
//                      - 1/2 delta_{rho in {r, theta}} (v d_rho g v) ]
// (gradus_tpu/geodesics/equation.py:94-134)
template <typename T>
__device__ __forceinline__ void geodesic_acceleration(const Dual2<T>* g,
                                                      const T* y, T* f) {
  const T vt = y[4], vr = y[5], vth = y[6], vph = y[7];
  const T inv_det = T(1) / (g[0].v * g[3].v - g[4].v * g[4].v);
  const T gi_tt = g[3].v * inv_det;
  const T gi_phph = g[0].v * inv_det;
  const T gi_tph = -g[4].v * inv_det;
  const T gi_rr = T(1) / g[1].v;
  const T gi_thth = T(1) / g[2].v;

  // (J v)_rho for J = d_r g and J = d_theta g
  const T J1v_t = g[0].dr * vt + g[4].dr * vph;
  const T J1v_r = g[1].dr * vr;
  const T J1v_th = g[2].dr * vth;
  const T J1v_ph = g[4].dr * vt + g[3].dr * vph;
  const T q1 = vt * J1v_t + vr * J1v_r + vth * J1v_th + vph * J1v_ph;
  const T J2v_t = g[0].dth * vt + g[4].dth * vph;
  const T J2v_r = g[1].dth * vr;
  const T J2v_th = g[2].dth * vth;
  const T J2v_ph = g[4].dth * vt + g[3].dth * vph;
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

// The kernel's Metric for one of the metrics above: components5 once on dual
// numbers with two tangents gives the value and the (d_r, d_theta) Jacobian
// that the TPU kernel gets from two jax.jvp passes
// (gradus_tpu/metrics/base.py:100-114), then the geodesic acceleration.
template <class Components>
struct DualRhs {
  template <typename T>
  static __device__ __forceinline__ void rhs(const DeformedParams<T>& p,
                                             const T* y, T* f) {
    const Dual2<T> r = {y[1], T(1), T(0)};
    const Dual2<T> th = {y[2], T(0), T(1)};
    Dual2<T> g[5];
    Components::components5(p, r, th, g);
    geodesic_acceleration(g, y, f);
  }

  // the values of the components at (r, th) for the parameters (M, a, q):
  // a PolishDoughnut's potential (geometry.cuh)
  template <typename T>
  static __device__ __forceinline__ void components(T M, T a, const T* q, T r, T th, T* g) {
    DeformedParams<T> p;
    p.M = M;
    p.a = a;
#pragma unroll
    for (int k = 0; k < kMetricParams; ++k) p.q[k] = q[k];
    Components::components5(p, r, th, g);
  }
};

}  // namespace gradus
