from gradus_tpu_torch.orbits.circular import CircularOrbits
from gradus_tpu_torch.orbits.plunging import PlungingInterpolation, interpolate_plunging_velocities
from gradus_tpu_torch.orbits.solving import (
    charged_circular_orbit_omega,
    solve_equatorial_circular_orbit,
    solve_orbit_theta,
)
from gradus_tpu_torch.orbits.special_radii import event_horizon, ergosphere, is_naked_singularity, isco
