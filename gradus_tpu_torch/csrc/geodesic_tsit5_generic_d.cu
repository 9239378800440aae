// The integrator kernel's generic instantiation (geometry kinds 3-7,
// geometry.cuh) for KerrDarkMatter, Spherical, Cartesian: one of four files,
// which nvcc compiles side by side.

#include "metrics.cuh"
#include "generic.cuh"

namespace gradus {

GRADUS_GENERIC(DualRhs<KerrDarkMatter>)
GRADUS_GENERIC(DualRhs<Spherical>)
GRADUS_GENERIC(DualRhs<Cartesian>)

}  // namespace gradus
