// The integrator kernel for a geometry whose parts of kinds 8-9
// (WarpedThinDisc, ThickDisc) carry a user's cross-section: a unit that
// geometry/codegen.py generates at first use includes this header, defines
// the cross-sections as device functions and a Policy holding them, and
// instantiates launch_callable for the traced metric's class and the
// launch's scalar only (_build.py builds it). The counterpart of the TPU
// kernel's trace, into which the callable is inlined
// (pallas_solver.py:178-179, discs.py:73-77).

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

}  // namespace gradus
