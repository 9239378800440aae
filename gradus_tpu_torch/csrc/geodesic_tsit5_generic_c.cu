// The integrator kernel's generic instantiation (geometry kinds 3-7,
// geometry.cuh) for KerrNewman, MorrisThorne, KerrRefractive: one of four files,
// which nvcc compiles side by side.

#include "metrics.cuh"
#include "generic.cuh"

namespace gradus {

GRADUS_GENERIC(DualRhs<KerrNewman>)
GRADUS_GENERIC(DualRhs<MorrisThorne>)
GRADUS_GENERIC(DualRhs<KerrRefractive>)

}  // namespace gradus
