from gradus_tpu_torch.metrics.base import AbstractMetric, unpack_rtheta
from gradus_tpu_torch.metrics.deformed import (
    BumblebeeMetric,
    DilatonAxion,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    NoZMetric,
)
from gradus_tpu_torch.metrics.exotic import KerrDarkMatter, KerrRefractive, MorrisThorneWormhole
from gradus_tpu_torch.metrics.kerr import KerrMetric, SchwarzschildMetric, kerr_isco
from gradus_tpu_torch.metrics.kerr_first_order import (
    KerrSpacetimeFirstOrder,
    carter_constants,
    trace_geodesics_first_order,
)
from gradus_tpu_torch.metrics.kerr_newman import KerrNewmanMetric, faraday_tensor
from gradus_tpu_torch.metrics.minkowski import CartesianMetric, SphericalMetric, minkowski_matrix
