from gradus_tpu_torch.metrics.base import AbstractMetric, unpack_rtheta
from gradus_tpu_torch.metrics.deformed import (
    BumblebeeMetric,
    DilatonAxion,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    NoZMetric,
)
from gradus_tpu_torch.metrics.kerr import KerrMetric, SchwarzschildMetric, kerr_isco
