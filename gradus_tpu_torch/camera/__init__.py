from gradus_tpu_torch.camera.grids import (
    CosGrid,
    GeometricGrid,
    InverseGrid,
    LinearGrid,
    LogisticGrid,
    SinGrid,
)
from gradus_tpu_torch.camera.impact import (
    local_momentum,
    lnr_momentum_transform,
    map_impact_parameters,
)
from gradus_tpu_torch.camera.pointfns import (
    ConstPointFunctions,
    FilterPointFunction,
    FilterStatusCode,
    PointFunction,
)
from gradus_tpu_torch.camera.planes import CartesianPlane, PolarPlane
from gradus_tpu_torch.camera.render import (
    EndpointRenderCache,
    apply,
    prerendergeodesics,
    rendergeodesics,
)
from gradus_tpu_torch.camera.adaptive import (
    AdaptiveGrid2D,
    adaptive_render,
    adaptive_sky,
    fill_sky_values,
)
