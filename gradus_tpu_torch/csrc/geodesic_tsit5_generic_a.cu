// The integrator kernel's generic instantiation (geometry kinds 3-7,
// geometry.cuh) for Kerr, Johannsen, JohannsenPsaltis: one of four files,
// which nvcc compiles side by side.

#include "kerr.cuh"
#include "metrics.cuh"
#include "generic.cuh"

namespace gradus {

GRADUS_GENERIC(Kerr)
GRADUS_GENERIC(DualRhs<Johannsen>)
GRADUS_GENERIC(DualRhs<JohannsenPsaltis>)

}  // namespace gradus
