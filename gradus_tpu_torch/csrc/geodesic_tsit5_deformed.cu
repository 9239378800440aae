// The integrator kernel of tsit5.cuh for the five deformed metrics of
// metrics.cuh (gradus_tpu/metrics/deformed.py), through their dual-number
// right-hand side (DualRhs). The design note is at the top of
// geodesic_tsit5.cu.

#include "metrics.cuh"

namespace gradus {

template <typename T>
int launch_deformed(int metric, const DeformedParams<T>& p, const Launch<T>& l) {
  switch (metric) {
    case kMetricJohannsen:
      return launch<T, DualRhs<Johannsen>>(p, l);
    case kMetricJohannsenPsaltis:
      return launch<T, DualRhs<JohannsenPsaltis>>(p, l);
    case kMetricNoZ:
      return launch<T, DualRhs<NoZ>>(p, l);
    case kMetricBumblebee:
      return launch<T, DualRhs<Bumblebee>>(p, l);
    case kMetricDilatonAxion:
      return launch<T, DualRhs<DilatonAxion>>(p, l);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template int launch_deformed<float>(int, const DeformedParams<float>&, const Launch<float>&);
template int launch_deformed<double>(int, const DeformedParams<double>&, const Launch<double>&);

}  // namespace gradus
