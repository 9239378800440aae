// The integrator kernel of tsit5.cuh for the two flat metrics of
// gradus_tpu/metrics/minkowski.py, through the dual-number right-hand side
// (DualRhs, metrics.cuh). The design note is at the top of geodesic_tsit5.cu.

#include "metrics.cuh"

namespace gradus {

template <typename T>
int launch_minkowski(int metric, const GenericParams<T>& p, const Launch<T>& l) {
  switch (metric) {
    case kMetricSpherical:
      return launch<T, DualRhs<Spherical>, DeformedParams<T>>(p, l);
    case kMetricCartesian:
      return launch<T, DualRhs<Cartesian>, DeformedParams<T>>(p, l);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template int launch_minkowski<float>(int, const GenericParams<float>&, const Launch<float>&);
template int launch_minkowski<double>(int, const GenericParams<double>&, const Launch<double>&);

}  // namespace gradus
