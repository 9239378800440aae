from gradus_tpu_torch.utils.linalg import (
    cartesian_distance,
    cartesian_squared_distance,
    cartesian_to_spherical,
    equatorial_project,
    oblate_spheroid_to_spherical,
    smooth_step_interpolate,
    spherical_to_cartesian,
    spinaxis_project,
    sym4x4,
    sym4x4_inverse_components,
)
from gradus_tpu_torch.utils.interp import (
    linear_interp,
    make_interpolator,
    masked_sorted_interp,
    nan_tolerant_interp,
)
from gradus_tpu_torch.utils.quadrature import gauss_legendre
