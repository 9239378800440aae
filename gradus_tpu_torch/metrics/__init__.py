from gradus_tpu_torch.metrics.base import AbstractMetric, unpack_rtheta
from gradus_tpu_torch.metrics.kerr import KerrMetric, kerr_isco
