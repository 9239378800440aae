from gradus_tpu_torch.geodesics.equation import (
    constrain,
    constrain_all,
    constrain_time,
    geodesic_acceleration,
    geodesic_equation,
    metric_jacobian,
    metric_jacobian5,
)
from gradus_tpu_torch.geodesics.tetrads import (
    dotproduct,
    gramschmidt,
    lnrbasis,
    lnrbasis_matrix,
    lnrframe,
    lnrframe_matrix,
    lowerindices,
    mproject,
    propernorm,
    raiseindices,
    tetradframe,
    tetradframe_matrix,
)
