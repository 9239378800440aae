// The integrator kernel for a geometry whose parts of kinds 8-9
// (WarpedThinDisc, ThickDisc) carry a user's cross-section, or for a
// user's metric: a unit that geometry/codegen.py generates at first use
// includes this header, defines the cross-sections as device functions and
// a Policy holding them, or the metric's class (metrics/codegen.py), and
// instantiates launch_callable for a kernel metric's class, or
// launch_traced for the traced metric, for the launch's scalar only
// (_build.py builds it). The counterpart of the TPU kernel's trace, into
// which the callable and the metric are inlined (pallas_solver.py:178-179,
// :760-763, discs.py:73-77).

#pragma once

#include "entry.cuh"
#include "kerr.cuh"
#include "metrics.cuh"

namespace gradus {

// GenericParams with a generated Policy, which the kernel's geometry code
// reads (tsit5.cuh, geometry.cuh)
template <typename T, class CrossSections>
struct CallableParams : GenericParams<T> {
  using Policy = CrossSections;
};

// The generic instantiation of Metric with the Policy's cross-sections;
// cudaErrorInvalidValue for another metric kind than the unit's or a
// geometry of kinds 0-2.
template <typename T, class Metric, class Policy, int kMetricKind>
int launch_callable(int metric, const GenericParams<T>& p, const Launch<T>& l) {
  if (metric != kMetricKind || p.geometry < kGenericGeometry) return int(cudaErrorInvalidValue);
  CallableParams<T, Policy> cp;
  static_cast<GenericParams<T>&>(cp) = p;
  return launch_kernel<T, Metric, CallableParams<T, Policy>, true>(cp, l);
}

// The kernel's Metric for a traced components5_jac: its values and
// (d_r, d_theta) derivatives, as the reference's metric_jacobian5 reads a
// hand-derived one (gradus_tpu/geodesics/equation.py:57-65), then the
// geodesic acceleration (metrics.cuh).
template <class Components>
struct JacRhs {
  template <typename T>
  static __device__ __forceinline__ void rhs(const DeformedParams<T>& p, const T* y, T* f) {
    T v[5], dr[5], dth[5];
    Components::components5_jac(p, y[1], y[2], v, dr, dth);
    Dual2<T> g[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) g[k] = {v[k], dr[k], dth[k]};
    geodesic_acceleration(g, y, f);
  }

  // the values at (r, th) for the parameters (M, a, q): a PolishDoughnut's
  // potential (geometry.cuh)
  template <typename T>
  static __device__ __forceinline__ void components(T M, T a, const T* q, T r, T th, T* g) {
    DeformedParams<T> p;
    p.M = M;
    p.a = a;
#pragma unroll
    for (int k = 0; k < kMetricParams; ++k) p.q[k] = q[k];
    T dr[5], dth[5];
    Components::components5_jac(p, r, th, g, dr, dth);
  }
};

// A traced metric (DualRhs or JacRhs of the generated class) for every
// geometry: kinds 0-2 by their closed forms, the others by the generic
// instantiation with the Policy's cross-sections (NoCallables for a
// geometry without kinds 8-9); cudaErrorInvalidValue for another metric
// kind than the unit's.
template <typename T, class Metric, class Policy, int kMetricKind>
int launch_traced(int metric, const GenericParams<T>& p, const Launch<T>& l) {
  if (metric != kMetricKind) return int(cudaErrorInvalidValue);
  if (p.geometry < kGenericGeometry) return launch_kernel<T, Metric, DeformedParams<T>, false>(p, l);
  CallableParams<T, Policy> cp;
  static_cast<GenericParams<T>&>(cp) = p;
  return launch_kernel<T, Metric, CallableParams<T, Policy>, true>(cp, l);
}

}  // namespace gradus
