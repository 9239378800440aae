"""gradus_tpu_torch — the PyTorch and CUDA port of `gradus_tpu`, for NVIDIA
Hopper (H100, sm_90a).

Module paths and public names mirror `gradus_tpu`. This package imports
`torch` and never `jax`. Its first slice is the flagship render: Kerr impact
parameters → null constraint → the adaptive Tsit5 integrator with disc
events (one hand-written CUDA kernel on the card, its plain PyTorch version
on the CPU) → Newton polish of the hits → analytic Kerr redshift.
"""

from gradus_tpu_torch.camera import (
    ConstPointFunctions,
    FilterPointFunction,
    FilterStatusCode,
    PointFunction,
    map_impact_parameters,
)
from gradus_tpu_torch.geometry import AbstractAccretionGeometry, ThinDisc
from gradus_tpu_torch.integrate import (
    CudaTracer,
    GeodesicPoint,
    StatusCodes,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.metrics import AbstractMetric, KerrMetric, kerr_isco
from gradus_tpu_torch.redshift import redshift_pointfunction
