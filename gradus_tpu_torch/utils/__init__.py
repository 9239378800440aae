from gradus_tpu_torch.utils.linalg import (
    equatorial_project,
    spinaxis_project,
    sym4x4,
    sym4x4_inverse_components,
)
from gradus_tpu_torch.utils.quadrature import gauss_legendre
