// The five deformed metrics of gradus_tpu/metrics/deformed.py, each as
//   template <typename T, class S>
//   static void components5(const DeformedParams<T>& p, S r, S th, S* g);
// writing g = (g_tt, g_rr, g_thth, g_phph, g_tphi) with the JAX package's
// expressions. The scalar S is T for a value, Dual2<T> for the value and
// its (d_r, d_theta) Jacobian. Integer powers are products; the poles'
// 1/sin^2 (DilatonAxion) and 1/(1 - cos^2) (NoZ) are kept as they are, so a
// NaN fails a ray the same way as in the plain version.
//
// Parameters: p.M and p.a, and the deformation parameters in p.q, in the
// order of integrate/cuda_solver.py::_KERNEL_METRICS:
//   Johannsen           q = (alpha13, alpha22, alpha52, eps3)
//   JohannsenPsaltis    q = (eps3)
//   NoZ                 q = (eps)
//   Bumblebee           q = (l)
//   DilatonAxion        q = (beta, b, bb, ba, bab), the last three the
//                       guarded ratios beta/b, beta/a, beta/(a b), which
//                       depend on the parameters only and come from the host

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

}  // namespace gradus
