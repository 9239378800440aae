// The definition of tsit5.cuh's launch_generic, for the files that
// instantiate it (geodesic_tsit5_generic_*.cu, a group of metrics each, so
// that nvcc compiles the groups at once).

#pragma once

#include "tsit5.cuh"

namespace gradus {

template <typename T, class Metric>
int launch_generic(const GenericParams<T>& p, const Launch<T>& l) {
  return launch_kernel<T, Metric, GenericParams<T>, true>(p, l);
}

}  // namespace gradus

#define GRADUS_GENERIC(METRIC)                                                              \
  template int launch_generic<float, METRIC>(const GenericParams<float>&, const Launch<float>&); \
  template int launch_generic<double, METRIC>(const GenericParams<double>&, const Launch<double>&);
