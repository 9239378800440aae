from gradus_tpu_torch.metrics.base import (
    AbstractMetric,
    inner_radius,
    inverse_metric_components,
    metric_4x4,
    metric_components,
    unpack_rtheta,
)
from gradus_tpu_torch.metrics.deformed import (
    BumblebeeMetric,
    DilatonAxion,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    NoZMetric,
)
from gradus_tpu_torch.metrics.exotic import KerrDarkMatter, KerrRefractive, MorrisThorneWormhole
from gradus_tpu_torch.metrics.kerr import KerrMetric, SchwarzschildMetric, convert_angles, kerr_isco
from gradus_tpu_torch.metrics.kerr_first_order import (
    KerrSpacetimeFirstOrder,
    carter_constants,
    trace_geodesics_first_order,
)
from gradus_tpu_torch.metrics.kerr_newman import KerrNewmanMetric, faraday_tensor
from gradus_tpu_torch.metrics.minkowski import CartesianMetric, SphericalMetric, minkowski_matrix
