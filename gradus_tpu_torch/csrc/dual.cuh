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

  // the unary functions of the metric generator's whitelist
  // (metrics/codegen.py), with jax.jvp's rules, as Dual1's below
  friend __device__ __forceinline__ Dual2 fabs(Dual2 a) {
    return {fabs(a.v), a.v >= T(0) ? a.dr : -a.dr, a.v >= T(0) ? a.dth : -a.dth};
  }
  friend __device__ __forceinline__ Dual2 exp(Dual2 a) {
    const T e = exp(a.v);
    return {e, a.dr * e, a.dth * e};
  }
  friend __device__ __forceinline__ Dual2 log(Dual2 a) {
    return {log(a.v), a.dr / a.v, a.dth / a.v};
  }
  friend __device__ __forceinline__ Dual2 tan(Dual2 a) {
    const T t = tan(a.v);
    return {t, a.dr * (T(1) + t * t), a.dth * (T(1) + t * t)};
  }
  friend __device__ __forceinline__ Dual2 tanh(Dual2 a) {
    const T t = tanh(a.v);
    return {t, (a.dr + a.dr * t) * (T(1) - t), (a.dth + a.dth * t) * (T(1) - t)};
  }
  friend __device__ __forceinline__ Dual2 sinh(Dual2 a) {
    const T c = cosh(a.v);
    return {sinh(a.v), a.dr * c, a.dth * c};
  }
  friend __device__ __forceinline__ Dual2 cosh(Dual2 a) {
    const T s = sinh(a.v);
    return {cosh(a.v), a.dr * s, a.dth * s};
  }
  friend __device__ __forceinline__ Dual2 asin(Dual2 a) {
    const T d = T(1) / sqrt(T(1) - a.v * a.v);
    return {asin(a.v), a.dr * d, a.dth * d};
  }
  friend __device__ __forceinline__ Dual2 acos(Dual2 a) {
    const T d = -(T(1) / sqrt(T(1) - a.v * a.v));
    return {acos(a.v), a.dr * d, a.dth * d};
  }
  friend __device__ __forceinline__ Dual2 floor(Dual2 a) { return {floor(a.v), T(0), T(0)}; }
};

// select for a plain scalar, so that a components5 template reads the same
// for both of its scalars
template <typename T>
__device__ __forceinline__ T select(bool c, T a, T b) {
  return c ? a : b;
}

// Forward-mode dual numbers with one tangent: a geometry's crossing
// indicator and its derivative along a direction in one pass (geometry.cuh),
// the device counterpart of the jax.jvp of pallas_solver.py:178-179. Where a
// function has a kink, the tangent is the one jax.jvp gives there, not the
// mathematics': |x| has slope +1 at 0 (jnp.abs's select(x >= 0, t, -t)),
// and a tie of jnp.maximum splits the tangent in half (jmax below).
template <typename T>
struct Dual1 {
  T v, d;

  friend __device__ __forceinline__ Dual1 operator-(Dual1 a) { return {-a.v, -a.d}; }

  friend __device__ __forceinline__ Dual1 operator+(Dual1 a, Dual1 b) {
    return {a.v + b.v, a.d + b.d};
  }
  friend __device__ __forceinline__ Dual1 operator+(Dual1 a, T b) { return {a.v + b, a.d}; }
  friend __device__ __forceinline__ Dual1 operator+(T a, Dual1 b) { return {a + b.v, b.d}; }
  friend __device__ __forceinline__ Dual1 operator-(Dual1 a, Dual1 b) {
    return {a.v - b.v, a.d - b.d};
  }
  friend __device__ __forceinline__ Dual1 operator-(Dual1 a, T b) { return {a.v - b, a.d}; }
  friend __device__ __forceinline__ Dual1 operator-(T a, Dual1 b) { return {a - b.v, -b.d}; }

  friend __device__ __forceinline__ Dual1 operator*(Dual1 a, Dual1 b) {
    return {a.v * b.v, a.d * b.v + a.v * b.d};
  }
  friend __device__ __forceinline__ Dual1 operator*(Dual1 a, T b) { return {a.v * b, a.d * b}; }
  friend __device__ __forceinline__ Dual1 operator*(T a, Dual1 b) { return {a * b.v, a * b.d}; }

  friend __device__ __forceinline__ Dual1 operator/(Dual1 a, T b) { return {a.v / b, a.d / b}; }
  // d(a/b) = -(a/b) db / b
  friend __device__ __forceinline__ Dual1 operator/(T a, Dual1 b) {
    const T q = a / b.v;
    return {q, -q * b.d / b.v};
  }

  friend __device__ __forceinline__ Dual1 sin(Dual1 a) { return {sin(a.v), cos(a.v) * a.d}; }
  friend __device__ __forceinline__ Dual1 cos(Dual1 a) { return {cos(a.v), -sin(a.v) * a.d}; }
  // jax: t * (0.5 / sqrt(x)), NaN for t = 0 at x = 0
  friend __device__ __forceinline__ Dual1 sqrt(Dual1 a) {
    const T s = sqrt(a.v);
    return {s, a.d * (T(0.5) / s)};
  }
  // atan2(y, x): dy x / (x^2 + y^2) - dx y / (x^2 + y^2)
  friend __device__ __forceinline__ Dual1 atan2(Dual1 y, Dual1 x) {
    const T n = x.v * x.v + y.v * y.v;
    return {atan2(y.v, x.v), y.d * (x.v / n) + x.d * (-y.v / n)};
  }
  friend __device__ __forceinline__ Dual1 fabs(Dual1 a) {
    return {fabs(a.v), a.v >= T(0) ? a.d : -a.d};
  }
  // the unary functions of the cross-section generator's whitelist
  // (geometry/codegen.py), with jax.jvp's rules: exp t e^x, log t / x,
  // tan t (1 + tan^2), tanh (t + t tanh) (1 - tanh), atan t / (1 + x^2)
  friend __device__ __forceinline__ Dual1 exp(Dual1 a) {
    const T e = exp(a.v);
    return {e, a.d * e};
  }
  friend __device__ __forceinline__ Dual1 log(Dual1 a) { return {log(a.v), a.d / a.v}; }
  friend __device__ __forceinline__ Dual1 tan(Dual1 a) {
    const T t = tan(a.v);
    return {t, a.d * (T(1) + t * t)};
  }
  friend __device__ __forceinline__ Dual1 tanh(Dual1 a) {
    const T t = tanh(a.v);
    return {t, (a.d + a.d * t) * (T(1) - t)};
  }
  friend __device__ __forceinline__ Dual1 atan(Dual1 a) {
    return {atan(a.v), a.d / (T(1) + a.v * a.v)};
  }
  // sinh t cosh, cosh t sinh, asin t / sqrt(1 - x^2), acos -t / sqrt(1 -
  // x^2); floor and sign (jsign below) carry no tangent
  friend __device__ __forceinline__ Dual1 sinh(Dual1 a) { return {sinh(a.v), a.d * cosh(a.v)}; }
  friend __device__ __forceinline__ Dual1 cosh(Dual1 a) { return {cosh(a.v), a.d * sinh(a.v)}; }
  friend __device__ __forceinline__ Dual1 asin(Dual1 a) {
    return {asin(a.v), a.d * (T(1) / sqrt(T(1) - a.v * a.v))};
  }
  friend __device__ __forceinline__ Dual1 acos(Dual1 a) {
    return {acos(a.v), a.d * -(T(1) / sqrt(T(1) - a.v * a.v))};
  }
  friend __device__ __forceinline__ Dual1 floor(Dual1 a) { return {floor(a.v), T(0)}; }
};

// jnp.sign: -1, 0 (of the zero's sign) or 1, NaN for NaN; no tangent
template <typename T>
__device__ __forceinline__ T jsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jsign(Dual1<T> a) {
  return {jsign(a.v), T(0)};
}
template <typename T>
__device__ __forceinline__ Dual2<T> jsign(Dual2<T> a) {
  return {jsign(a.v), T(0), T(0)};
}

// jnp.maximum(x, c) of a constant c: the value as tsit5.cuh's mx (a NaN
// propagates), the tangent t times 1 above c, 0 below and 1/2 at a tie
// (jax's _balanced_eq)
template <typename T>
__device__ __forceinline__ T jmax(T x, T c) {
  return (x > c || x != x) ? x : c;
}
template <typename T>
__device__ __forceinline__ Dual1<T> jmax(Dual1<T> x, T c) {
  const T v = jmax(x.v, c);
  const T f = x.v == v ? (c == v ? T(0.5) : T(1)) : T(0);
  return {v, x.d * f};
}

// jnp.minimum(x, c) of a constant c, as jmax
template <typename T>
__device__ __forceinline__ T jmin(T x, T c) {
  return (x < c || x != x) ? x : c;
}
template <typename T>
__device__ __forceinline__ Dual1<T> jmin(Dual1<T> x, T c) {
  const T v = jmin(x.v, c);
  const T f = x.v == v ? (c == v ? T(0.5) : T(1)) : T(0);
  return {v, x.d * f};
}

// --- the rest of the cross-section generator's whitelist (geometry/codegen.py),
// for a scalar T and a Dual1<T>, with jax.jvp's rules where a rule is not the
// obvious one. A number beside a dual is a literal: it carries no tangent, as
// a Python number does in jax.jvp.

// jax's _balanced_eq(x, z, y): the share of a tangent that min/max give x
template <typename T>
__device__ __forceinline__ T balanced_eq(T x, T z, T y) {
  return (x == z ? T(1) : T(0)) / (y == z ? T(2) : T(1));
}
template <typename T>
__device__ __forceinline__ Dual1<T> jmax(T c, Dual1<T> x) {
  return jmax(x, c);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jmax(Dual1<T> x, Dual1<T> y) {
  const T v = jmax(x.v, y.v);
  return {v, x.d * balanced_eq(x.v, v, y.v) + y.d * balanced_eq(y.v, v, x.v)};
}
template <typename T>
__device__ __forceinline__ Dual1<T> jmin(T c, Dual1<T> x) {
  return jmin(x, c);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jmin(Dual1<T> x, Dual1<T> y) {
  const T v = jmin(x.v, y.v);
  return {v, x.d * balanced_eq(x.v, v, y.v) + y.d * balanced_eq(y.v, v, x.v)};
}

// lax.integer_pow(x, n): binary exponentiation, 1 / x^|n| for n < 0; the
// tangent t (n x^(n-1)), 0 for n = 0
template <typename T>
__device__ __forceinline__ T ipow(T x, int n) {
  if (n == 0) return T(1);
  int m = n < 0 ? -n : n;
  T acc = x;
  bool first = true;
  while (m > 0) {
    if (m & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    m >>= 1;
    if (m > 0) x = x * x;
  }
  return n < 0 ? T(1) / acc : acc;
}
template <typename T>
__device__ __forceinline__ Dual1<T> ipow(Dual1<T> x, int n) {
  return {ipow(x.v, n), n == 0 ? T(0) : x.d * (T(n) * ipow(x.v, n - 1))};
}

// lax.pow(x, y): the x tangent t (y x^(y-1)), the y tangent t (log(x) x^y)
// with log(0) read as log(1)
template <typename T>
__device__ __forceinline__ T jpow(T x, T y) {
  return pow(x, y);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jpow(Dual1<T> x, T y) {
  return {pow(x.v, y), x.d * (y * pow(x.v, y - T(1)))};
}
template <typename T>
__device__ __forceinline__ Dual1<T> jpow(T x, Dual1<T> y) {
  const T ans = pow(x, y.v);
  return {ans, y.d * (log(x == T(0) ? T(1) : x) * ans)};
}
template <typename T>
__device__ __forceinline__ Dual1<T> jpow(Dual1<T> x, Dual1<T> y) {
  const T ans = pow(x.v, y.v);
  return {ans, x.d * (y.v * pow(x.v, y.v - T(1))) + y.d * (log(x.v == T(0) ? T(1) : x.v) * ans)};
}

// lax.div(x, y): the x tangent t / y, the y tangent (-t x) y^-2
template <typename T>
__device__ __forceinline__ T jdiv(T x, T y) {
  return x / y;
}
template <typename T>
__device__ __forceinline__ Dual1<T> jdiv(Dual1<T> x, T y) {
  return {x.v / y, x.d / y};
}
template <typename T>
__device__ __forceinline__ Dual1<T> jdiv(T x, Dual1<T> y) {
  return {x / y.v, (-y.d * x) * ipow(y.v, -2)};
}
template <typename T>
__device__ __forceinline__ Dual1<T> jdiv(Dual1<T> x, Dual1<T> y) {
  return {x.v / y.v, x.d / y.v + (-y.d * x.v) * ipow(y.v, -2)};
}

// lax.square: t (2 x); lax.rsqrt: t (-0.5 (rsqrt(x) / x))
template <typename T>
__device__ __forceinline__ T jsquare(T x) {
  return x * x;
}
template <typename T>
__device__ __forceinline__ Dual1<T> jsquare(Dual1<T> x) {
  return {x.v * x.v, x.d * (T(2) * x.v)};
}
template <typename T>
__device__ __forceinline__ T jrsqrt(T x) {
  return T(1) / sqrt(x);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jrsqrt(Dual1<T> x) {
  const T ans = T(1) / sqrt(x.v);
  return {ans, x.d * (T(-0.5) * (ans / x.v))};
}

// lax.atan2(y, x) with one side a literal
template <typename T>
__device__ __forceinline__ T jatan2(T y, T x) {
  return atan2(y, x);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jatan2(Dual1<T> y, Dual1<T> x) {
  return atan2(y, x);
}
template <typename T>
__device__ __forceinline__ Dual1<T> jatan2(Dual1<T> y, T x) {
  return {atan2(y.v, x), y.d * (x / (y.v * y.v + x * x))};
}
template <typename T>
__device__ __forceinline__ Dual1<T> jatan2(T y, Dual1<T> x) {
  return {atan2(y, x.v), x.d * (-y / (y * y + x.v * x.v))};
}

// the value of a scalar or a dual
template <typename T>
__device__ __forceinline__ T value(T x) {
  return x;
}
template <typename T>
__device__ __forceinline__ T value(Dual1<T> x) {
  return x.v;
}

// --- the whitelist for Dual2, the scalar of a traced metric's components5
// (metrics/codegen.py): the rules above, with the two tangents (d_r, d_theta)
// of Dual2. The operators and the unary functions are Dual2's own friends.

template <typename T>
__device__ __forceinline__ T value(Dual2<T> x) {
  return x.v;
}

// a tangent pair scaled: (x.dr * f, x.dth * f)
template <typename T>
__device__ __forceinline__ Dual2<T> scaled(T v, Dual2<T> x, T f) {
  return {v, x.dr * f, x.dth * f};
}

template <typename T>
__device__ __forceinline__ Dual2<T> jmax(Dual2<T> x, T c) {
  const T v = jmax(x.v, c);
  return scaled(v, x, x.v == v ? (c == v ? T(0.5) : T(1)) : T(0));
}
template <typename T>
__device__ __forceinline__ Dual2<T> jmin(Dual2<T> x, T c) {
  const T v = jmin(x.v, c);
  return scaled(v, x, x.v == v ? (c == v ? T(0.5) : T(1)) : T(0));
}
template <typename T>
__device__ __forceinline__ Dual2<T> jmax(T c, Dual2<T> x) {
  return jmax(x, c);
}
template <typename T>
__device__ __forceinline__ Dual2<T> jmin(T c, Dual2<T> x) {
  return jmin(x, c);
}
template <typename T>
__device__ __forceinline__ Dual2<T> jmax(Dual2<T> x, Dual2<T> y) {
  const T v = jmax(x.v, y.v);
  const T fx = balanced_eq(x.v, v, y.v), fy = balanced_eq(y.v, v, x.v);
  return {v, x.dr * fx + y.dr * fy, x.dth * fx + y.dth * fy};
}
template <typename T>
__device__ __forceinline__ Dual2<T> jmin(Dual2<T> x, Dual2<T> y) {
  const T v = jmin(x.v, y.v);
  const T fx = balanced_eq(x.v, v, y.v), fy = balanced_eq(y.v, v, x.v);
  return {v, x.dr * fx + y.dr * fy, x.dth * fx + y.dth * fy};
}

template <typename T>
__device__ __forceinline__ Dual2<T> ipow(Dual2<T> x, int n) {
  if (n == 0) return {T(1), T(0), T(0)};
  return scaled(ipow(x.v, n), x, T(n) * ipow(x.v, n - 1));
}
template <typename T>
__device__ __forceinline__ Dual2<T> jpow(Dual2<T> x, T y) {
  return scaled(pow(x.v, y), x, y * pow(x.v, y - T(1)));
}
template <typename T>
__device__ __forceinline__ Dual2<T> jpow(T x, Dual2<T> y) {
  const T ans = pow(x, y.v);
  return scaled(ans, y, log(x == T(0) ? T(1) : x) * ans);
}
template <typename T>
__device__ __forceinline__ Dual2<T> jpow(Dual2<T> x, Dual2<T> y) {
  const T ans = pow(x.v, y.v);
  const T fx = y.v * pow(x.v, y.v - T(1)), fy = log(x.v == T(0) ? T(1) : x.v) * ans;
  return {ans, x.dr * fx + y.dr * fy, x.dth * fx + y.dth * fy};
}

template <typename T>
__device__ __forceinline__ Dual2<T> jdiv(Dual2<T> x, T y) {
  return {x.v / y, x.dr / y, x.dth / y};
}
template <typename T>
__device__ __forceinline__ Dual2<T> jdiv(T x, Dual2<T> y) {
  const T f = ipow(y.v, -2);
  return {x / y.v, (-y.dr * x) * f, (-y.dth * x) * f};
}
template <typename T>
__device__ __forceinline__ Dual2<T> jdiv(Dual2<T> x, Dual2<T> y) {
  const T f = ipow(y.v, -2);
  return {x.v / y.v, x.dr / y.v + (-y.dr * x.v) * f, x.dth / y.v + (-y.dth * x.v) * f};
}

template <typename T>
__device__ __forceinline__ Dual2<T> jsquare(Dual2<T> x) {
  return scaled(x.v * x.v, x, T(2) * x.v);
}
template <typename T>
__device__ __forceinline__ Dual2<T> jrsqrt(Dual2<T> x) {
  const T ans = T(1) / sqrt(x.v);
  return scaled(ans, x, T(-0.5) * (ans / x.v));
}

template <typename T>
__device__ __forceinline__ Dual2<T> jatan2(Dual2<T> y, Dual2<T> x) {
  const T n = x.v * x.v + y.v * y.v;
  const T fy = x.v / n, fx = -y.v / n;
  return {atan2(y.v, x.v), y.dr * fy + x.dr * fx, y.dth * fy + x.dth * fx};
}
template <typename T>
__device__ __forceinline__ Dual2<T> jatan2(Dual2<T> y, T x) {
  return scaled(atan2(y.v, x), y, x / (y.v * y.v + x * x));
}
template <typename T>
__device__ __forceinline__ Dual2<T> jatan2(T y, Dual2<T> x) {
  return scaled(atan2(y, x.v), x, -y / (y * y + x.v * x.v));
}

}  // namespace gradus
