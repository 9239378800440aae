from gradus_tpu_torch.orbits.circular import CircularOrbits
from gradus_tpu_torch.orbits.special_radii import isco
