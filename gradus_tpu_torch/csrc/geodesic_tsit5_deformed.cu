// The integrator kernel of tsit5.cuh for the five deformed metrics of
// metrics.cuh (gradus_tpu/metrics/deformed.py), through their dual-number
// right-hand side (DualRhs). The design note is at the top of
// geodesic_tsit5.cu.

#include "metrics.cuh"

namespace gradus {

template <typename T>
int launch_deformed(int metric, const GenericParams<T>& p, const Launch<T>& l) {
  switch (metric) {
    case kMetricJohannsen:
      return launch<T, DualRhs<Johannsen>, DeformedParams<T>>(p, l);
    case kMetricJohannsenPsaltis:
      return launch<T, DualRhs<JohannsenPsaltis>, DeformedParams<T>>(p, l);
    case kMetricNoZ:
      return launch<T, DualRhs<NoZ>, DeformedParams<T>>(p, l);
    case kMetricBumblebee:
      return launch<T, DualRhs<Bumblebee>, DeformedParams<T>>(p, l);
    case kMetricDilatonAxion:
      return launch<T, DualRhs<DilatonAxion>, DeformedParams<T>>(p, l);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template int launch_deformed<float>(int, const GenericParams<float>&, const Launch<float>&);
template int launch_deformed<double>(int, const GenericParams<double>&, const Launch<double>&);

}  // namespace gradus
