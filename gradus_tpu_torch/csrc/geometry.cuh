// The geometries of the integrator kernel beside ThinDisc and a one-height
// DatumPlane: their crossing indicators, written once as templates over the
// scalar (T for a value, Dual1<T> for the value and its derivative along a
// direction), and their hit tests, with the JAX package's expressions
// (gradus_tpu/geometry/discs.py). tsit5.cuh's generic instantiation reads
// them; the thin-disc and datum-plane kernels keep their closed forms.
//
// A geometry is a block of values on the device (below): its kind, its part
// count n, then n parts of kPartStride values each. A part is one of
//   1  ThinDisc         v = (inner_r, outer_r)
//   2  DatumPlane       v = (height)
//   3  ShakuraSunyaev   v = (3 inv_eta mdot, inner_r)
//   4  EllipticalDisc   v = (inner_r, semi_major, semi_minor^2)
//   5  PolishDoughnut   v = (2M, 2.2M, unused, ell^2, 2 ell, z_max, W at
//                       (r_cusp, 0), 1 if the potential reads a metric's
//                       components else 0 (Schwarzschild's closed form),
//                       that metric's M, a and 5 parameters)
//   6  PrecessingDisc   of a part of kind 1-5, 8 or 9 (`inner`), with that
//                       part's values and v[17..19] = (cos(-beta),
//                       sin(-beta), gamma)
//   8  WarpedThinDisc   v = (inner_r, outer_r), and its height f(rho)
//   9  ThickDisc        v = (), and its cross-section f(rho)
// The f of kinds 8 and 9 is a user's torch callable, compiled into a device
// function by geometry/codegen.py: a Policy class (below) holds them, one
// per part, and the kernel that reads them is built for that Policy at
// first use (_build.py). The default Policy, NoCallables, holds none and
// compiles kinds 8 and 9 out.
// The constants are folded on the host in f64, where the plain version
// folds them in its f64 buffers. A geometry of kind 7, a CompositeGeometry,
// takes the indicator of the part with the least |c| (the first of a tie,
// or the first NaN, as jnp.argmin) and is hit where a part is hit with
// |c| < 1e-6 (discs.py:453-471); kinds 3-6, 8 and 9 are one part.
//
// A Metric is the kernel's (tsit5.cuh) with
//   static __device__ void components(T M, T a, const T* q, T r, T th, T* g);
// the PolishDoughnut of a metric reads the ray metric's class with its own
// parameters, or, where the Policy names one for its part (a doughnut of
// another metric class than the rays'), that class.

#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"

namespace gradus {

constexpr int kPartValues = 20;
// kinds of a part (and of the geometry, for kinds 3-7)
constexpr int kThinDisc = 1;
constexpr int kDatumPlaneKind = 2;
constexpr int kShakuraSunyaev = 3;
constexpr int kEllipticalDisc = 4;
constexpr int kPolishDoughnut = 5;
constexpr int kPrecessingDisc = 6;
constexpr int kComposite = 7;
constexpr int kWarpedThinDisc = 8;
constexpr int kThickDisc = 9;
// The geometry's block on the device, in the launch's scalar: its kind and
// part count n, then each part's kind, inner kind and kPartValues values,
// 2 + n * kPartStride values in all (the part count is read at run time).
constexpr int kPartStride = 2 + kPartValues;

// A Policy holds the cross-sections of the parts of kinds 8 and 9, and the
// cross-sections of the PolishDoughnut parts whose isobars read another
// metric class than the rays' (doughnut_h below, of that class):
//   static constexpr bool kCallables, kDoughnuts;
//   template <typename T, class S> static S cross_section(int part, S rho);
//   template <class Metric, typename T> static T doughnut_h(int part, const T* v, T rho);
// NoCallables, the default, holds none.
struct NoCallables {
  static constexpr bool kCallables = false;
  static constexpr bool kDoughnuts = false;
  template <typename T, class S>
  static __device__ __forceinline__ S cross_section(int, S rho) {
    return rho;
  }
};

// ρ = r |sin θ| and z = r |cos θ| (equatorial_project, spinaxis_project)
template <typename S>
__device__ __forceinline__ S rho_of(S r, S th) {
  return r * fabs(sin(th));
}

// ShakuraSunyaev.cross_section (discs.py:279-283)
template <typename T, class S>
__device__ __forceinline__ S shakura_sunyaev_h(const T* v, S rho) {
  const S h = v[0] * (T(1) - sqrt(v[1] / jmax(rho, T(1e-12))));
  return select(value(rho) < v[1], S{T(-0.0)}, h);
}

// PolishDoughnut._potential (discs.py:392-420)
template <class Metric, typename T>
__device__ __forceinline__ T doughnut_potential(const T* v, T rho, T z) {
  const T R = sqrt(rho * rho + z * z);
  if (v[7] != T(0)) {
    T g[5];
    Metric::components(v[8], v[9], v + 10, jmax(R, T(1e-6)), atan2(rho, z), g);
    const T denom = g[3] + v[4] * g[4] + v[3] * g[0];
    const T ut2 = (g[4] * g[4] - g[0] * g[3]) / (fabs(denom) < T(1e-12) ? T(1e-12) : denom);
    return denom > T(0) ? T(0.5) * log(jmax(ut2, T(1e-12))) : T(INFINITY);
  }
  const T q = rho / jmax(R, T(1e-12));
  const T sin2 = R > T(0) ? q * q : T(1);
  const T f = T(1) - v[0] / jmax(R, v[1]);
  const T denom = jmax(R * R * sin2 - v[3] * f, T(1e-12));
  const T ut2 = R * R * sin2 * f / denom;
  return T(0.5) * log(jmax(ut2, T(1e-12)));
}

// PolishDoughnut.cross_section (discs.py:422-436): 40 bisections of the
// equipotential. Its value carries no tangent: the bisection starts from
// zeros_like(ρ) and z_max.
template <class Metric, typename T>
__device__ __noinline__ T doughnut_h(const T* v, T rho) {
  const T w_s = v[6];
  const bool in_disc = doughnut_potential<Metric>(v, rho, T(0)) < w_s;
  T a = T(0), b = v[5];
#pragma unroll 1
  for (int it = 0; it < 40; ++it) {
    const T mid = T(0.5) * (a + b);
    const bool below = doughnut_potential<Metric>(v, rho, mid) < w_s;
    a = below ? mid : a;
    b = below ? b : mid;
  }
  return in_disc ? T(0.5) * (a + b) : T(-1);
}

// The cross-section of the PolishDoughnut part k: in the Policy's class for
// that part where it names one, else in the ray metric's.
template <class Metric, class Policy, typename T>
__device__ __forceinline__ T doughnut_height(int k, const T* v, T rho) {
  if constexpr (Policy::kDoughnuts) return Policy::template doughnut_h<Metric>(k, v, rho);
  else return doughnut_h<Metric>(v, rho);
}

// The indicator of a part of kind 1-5, 8 or 9 at (r, θ) (discs.py: ThinDisc
// and DatumPlane :113-171, WarpedThinDisc's z - f(ρ) :144-147, the thick
// discs' |z| - max(h(ρ), 0) :192-196, EllipticalDisc :302-306); ``k`` is
// the part's index, which names its cross-section in the Policy.
template <class Metric, class Policy, typename T, class S>
__device__ __forceinline__ S disc_indicator(int kind, int k, const T* v, S r, S th) {
  if constexpr (Policy::kCallables) {
    if (kind == kWarpedThinDisc) return r * cos(th) - Policy::template cross_section<T>(k, rho_of(r, th));
    if (kind == kThickDisc)
      return r * fabs(cos(th)) - jmax(Policy::template cross_section<T>(k, rho_of(r, th)), T(0));
  }
  switch (kind) {
    case kThinDisc:
      return r * cos(th);
    case kDatumPlaneKind:
      return r * cos(th) - v[0];
    case kShakuraSunyaev:
      return r * fabs(cos(th)) - jmax(shakura_sunyaev_h(v, rho_of(r, th)), T(0));
    case kEllipticalDisc: {
      const S q = r / v[1];
      return fabs(r * cos(th)) - sqrt(jmax(T(1) - q * q, T(0)) * v[2]);
    }
    default: {
      const T h = doughnut_height<Metric, Policy>(k, v, value(rho_of(r, th)));
      return r * fabs(cos(th)) - jmax(S{h}, T(0));
    }
  }
}

// A part's is_hit at (r, θ) (discs.py:116-118, 149-151, 173-174, 198-199,
// 308-310)
template <class Metric, class Policy, typename T>
__device__ __forceinline__ bool disc_hit(int kind, int k, const T* v, T r, T th) {
  const T rho = rho_of(r, th);
  if constexpr (Policy::kCallables) {
    if (kind == kWarpedThinDisc) return rho >= v[0] && rho <= v[1];
    if (kind == kThickDisc) return Policy::template cross_section<T>(k, rho) > T(0);
  }
  switch (kind) {
    case kThinDisc:
      return rho >= v[0] && rho <= v[1];
    case kDatumPlaneKind:
      return true;
    case kShakuraSunyaev:
      return shakura_sunyaev_h(v, rho) > T(0);
    case kEllipticalDisc:
      return r >= v[0] && r <= v[1];
    default:
      return doughnut_height<Metric, Policy>(k, v, rho) > T(0);
  }
}

// PrecessingDisc._rotated (discs.py:346-363): (θ', φ') in the disc's frame
template <typename T, class S>
__device__ __forceinline__ void precessed(const T* v, S th, S ph, S& th_p, S& ph_p) {
  const T cb = v[17], sb = v[18];
  const S phi = ph - v[19];
  const S st = sin(th);
  const S px = st * sin(phi);
  const S py = st * cos(phi);
  const S pz = cos(th);
  const S y_ = cb * py + sb * pz;
  const S z_ = -sb * py + cb * pz;
  th_p = atan2(sqrt(px * px + y_ * y_), z_);
  ph_p = atan2(y_, px);
}

// A part of the block: its kind, the wrapped kind of a PrecessingDisc, its
// index and its values.
template <typename T>
struct Part {
  int kind, inner, index;
  const T* v;
};

template <typename T>
__device__ __forceinline__ Part<T> part(const T* g, int k) {
  const T* p = g + 2 + k * kPartStride;
  return {int(p[0]), int(p[1]), k, p + 2};
}

template <class Metric, class Policy, typename T, class S>
__device__ __forceinline__ S part_indicator(const Part<T>& p, S r, S th, S ph) {
  if (p.kind != kPrecessingDisc) return disc_indicator<Metric, Policy>(p.kind, p.index, p.v, r, th);
  S th_p, ph_p;
  precessed(p.v, th, ph, th_p, ph_p);
  return disc_indicator<Metric, Policy>(p.inner, p.index, p.v, r, th_p);
}

template <class Metric, class Policy, typename T>
__device__ __forceinline__ bool part_hit(const Part<T>& p, T r, T th, T ph) {
  if (p.kind != kPrecessingDisc) return disc_hit<Metric, Policy>(p.kind, p.index, p.v, r, th);
  T th_p, ph_p;
  precessed(p.v, th, ph, th_p, ph_p);
  return disc_hit<Metric, Policy>(p.inner, p.index, p.v, r, th_p);
}

// The geometry's crossing_indicator_c at (r, θ, φ): a part's, or a
// composite's part of least |c|
template <class Metric, class Policy, typename T, class S>
__device__ __forceinline__ S indicator(const T* g, S r, S th, S ph) {
  S best = part_indicator<Metric, Policy>(part(g, 0), r, th, ph);
  const int n_parts = int(g[1]);
#pragma unroll 1
  for (int k = 1; k < n_parts; ++k) {
    const S c = part_indicator<Metric, Policy>(part(g, k), r, th, ph);
    const T cv = fabs(value(c)), bv = fabs(value(best));
    if (bv == bv && (cv != cv || cv < bv)) best = c;
  }
  return best;
}

// The three entry points of the kernel, each compiled once per
// instantiation rather than inlined where the kernel reads it: the
// indicator's value, its value and derivative along (dr, dθ, dφ) (the jvp
// of pallas_solver.py:178-179), and the hit test.
template <class Metric, class Policy, typename T>
__device__ __noinline__ T geometry_value(const T* g, T r, T th, T ph) {
  return indicator<Metric, Policy>(g, r, th, ph);
}

template <class Metric, class Policy, typename T>
__device__ __noinline__ Dual1<T> geometry_jvp(const T* g, T r, T th, T ph, T dr, T dth, T dph) {
  return indicator<Metric, Policy>(g, Dual1<T>{r, dr}, Dual1<T>{th, dth}, Dual1<T>{ph, dph});
}

// The geometry's is_hit_c at (r, θ, φ)
template <class Metric, class Policy, typename T>
__device__ __noinline__ bool geometry_hit(const T* g, T r, T th, T ph) {
  if (int(g[0]) != kComposite) return part_hit<Metric, Policy>(part(g, 0), r, th, ph);
  bool hit = false;
  const int n_parts = int(g[1]);
#pragma unroll 1
  for (int k = 0; k < n_parts; ++k) {
    const Part<T> p = part(g, k);
    hit = hit || (part_hit<Metric, Policy>(p, r, th, ph) && fabs(part_indicator<Metric, Policy>(p, r, th, ph)) < T(1e-6));
  }
  return hit;
}

}  // namespace gradus
