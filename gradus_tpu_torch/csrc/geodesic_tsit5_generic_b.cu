// The integrator kernel's generic instantiation (geometry kinds 3-7,
// geometry.cuh) for NoZ, Bumblebee, DilatonAxion: one of four files,
// which nvcc compiles side by side.

#include "metrics.cuh"
#include "generic.cuh"

namespace gradus {

GRADUS_GENERIC(DualRhs<NoZ>)
GRADUS_GENERIC(DualRhs<Bumblebee>)
GRADUS_GENERIC(DualRhs<DilatonAxion>)

}  // namespace gradus
