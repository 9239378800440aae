// Forward-mode dual numbers with two tangents, for the value and the
// (d_r, d_theta) derivatives of a metric's components in one pass: the
// device counterpart of the two jax.jvp passes of
// gradus_tpu/metrics/base.py::_ad_components5_jac. The derivatives agree
// with JAX's up to rounding.
//
// The operations are hidden friends, found by argument-dependent lookup
// only, so they never hide the scalar sin/cos/sqrt/atan of the same names.
// Integer powers are written as products by the callers; there is no pow.
// A comparison reads the value; select(c, a, b) takes the value and the
// tangents of the branch c names, as jax.jvp differentiates jnp.where.

#pragma once

#include <cuda_runtime.h>

namespace gradus {

template <typename T>
struct Dual2 {
  T v, dr, dth;

  friend __device__ __forceinline__ Dual2 operator-(Dual2 a) {
    return {-a.v, -a.dr, -a.dth};
  }

  friend __device__ __forceinline__ Dual2 operator+(Dual2 a, Dual2 b) {
    return {a.v + b.v, a.dr + b.dr, a.dth + b.dth};
  }
  friend __device__ __forceinline__ Dual2 operator+(Dual2 a, T b) {
    return {a.v + b, a.dr, a.dth};
  }
  friend __device__ __forceinline__ Dual2 operator+(T a, Dual2 b) {
    return {a + b.v, b.dr, b.dth};
  }

  friend __device__ __forceinline__ Dual2 operator-(Dual2 a, Dual2 b) {
    return {a.v - b.v, a.dr - b.dr, a.dth - b.dth};
  }
  friend __device__ __forceinline__ Dual2 operator-(Dual2 a, T b) {
    return {a.v - b, a.dr, a.dth};
  }
  friend __device__ __forceinline__ Dual2 operator-(T a, Dual2 b) {
    return {a - b.v, -b.dr, -b.dth};
  }

  friend __device__ __forceinline__ Dual2 operator*(Dual2 a, Dual2 b) {
    return {a.v * b.v, a.dr * b.v + a.v * b.dr, a.dth * b.v + a.v * b.dth};
  }
  friend __device__ __forceinline__ Dual2 operator*(Dual2 a, T b) {
    return {a.v * b, a.dr * b, a.dth * b};
  }
  friend __device__ __forceinline__ Dual2 operator*(T a, Dual2 b) {
    return {a * b.v, a * b.dr, a * b.dth};
  }

  // d(a/b) = (da - (a/b) db) / b: the quotient by IEEE division, the
  // tangents through one reciprocal
  friend __device__ __forceinline__ Dual2 operator/(Dual2 a, Dual2 b) {
    const T q = a.v / b.v;
    const T inv = T(1) / b.v;
    return {q, (a.dr - q * b.dr) * inv, (a.dth - q * b.dth) * inv};
  }
  friend __device__ __forceinline__ Dual2 operator/(Dual2 a, T b) {
    const T inv = T(1) / b;
    return {a.v / b, a.dr * inv, a.dth * inv};
  }
  friend __device__ __forceinline__ Dual2 operator/(T a, Dual2 b) {
    const T q = a / b.v;
    const T inv = T(1) / b.v;
    return {q, -q * b.dr * inv, -q * b.dth * inv};
  }

  friend __device__ __forceinline__ Dual2 sin(Dual2 a) {
    const T s = sin(a.v);
    const T c = cos(a.v);
    return {s, c * a.dr, c * a.dth};
  }
  friend __device__ __forceinline__ Dual2 cos(Dual2 a) {
    const T s = sin(a.v);
    const T c = cos(a.v);
    return {c, -s * a.dr, -s * a.dth};
  }
  friend __device__ __forceinline__ Dual2 sqrt(Dual2 a) {
    const T s = sqrt(a.v);
    const T h = T(0.5) / s;
    return {s, a.dr * h, a.dth * h};
  }
  // d atan(x) = dx / (1 + x^2)
  friend __device__ __forceinline__ Dual2 atan(Dual2 a) {
    const T d = T(1) / (T(1) + a.v * a.v);
    return {atan(a.v), a.dr * d, a.dth * d};
  }

  friend __device__ __forceinline__ bool operator<(Dual2 a, T b) { return a.v < b; }
  friend __device__ __forceinline__ bool operator<=(Dual2 a, T b) { return a.v <= b; }
  friend __device__ __forceinline__ bool operator>=(Dual2 a, T b) { return a.v >= b; }

  friend __device__ __forceinline__ Dual2 select(bool c, Dual2 a, Dual2 b) {
    return c ? a : b;
  }
};

// select for a plain scalar, so that a components5 template reads the same
// for both of its scalars
template <typename T>
__device__ __forceinline__ T select(bool c, T a, T b) {
  return c ? a : b;
}

}  // namespace gradus
