from gradus_tpu_torch.geodesics.equation import (
    constrain,
    constrain_all,
    constrain_time,
    geodesic_acceleration,
    geodesic_equation,
    metric_jacobian,
)
from gradus_tpu_torch.geodesics.tetrads import (
    dotproduct,
    gramschmidt,
    lnrbasis,
    lnrbasis_matrix,
    mproject,
    propernorm,
    tetradframe,
    tetradframe_matrix,
)
