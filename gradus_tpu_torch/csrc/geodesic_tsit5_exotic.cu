// The integrator kernel of tsit5.cuh for Kerr-Newman (uncharged rays,
// gradus_tpu/metrics/kerr_newman.py) and the three metrics of
// gradus_tpu/metrics/exotic.py, through their dual-number right-hand side
// (DualRhs, metrics.cuh). The design note is at the top of geodesic_tsit5.cu.

#include "metrics.cuh"

namespace gradus {

template <typename T>
int launch_exotic(int metric, const GenericParams<T>& p, const Launch<T>& l) {
  switch (metric) {
    case kMetricKerrNewman:
      return launch<T, DualRhs<KerrNewman>, DeformedParams<T>>(p, l);
    case kMetricMorrisThorne:
      return launch<T, DualRhs<MorrisThorne>, DeformedParams<T>>(p, l);
    case kMetricKerrRefractive:
      return launch<T, DualRhs<KerrRefractive>, DeformedParams<T>>(p, l);
    case kMetricKerrDarkMatter:
      return launch<T, DualRhs<KerrDarkMatter>, DeformedParams<T>>(p, l);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template int launch_exotic<float>(int, const GenericParams<float>&, const Launch<float>&);
template int launch_exotic<double>(int, const GenericParams<double>&, const Launch<double>&);

}  // namespace gradus
