"""gradus_tpu_torch — the PyTorch and CUDA port of `gradus_tpu`, for NVIDIA
Hopper (H100, sm_90a).

Module paths and public names mirror `gradus_tpu`. This package imports
`torch` and never `jax`. Its slices so far:

- the flagship render: impact parameters → null (or timelike) constraint →
  the adaptive Tsit5 integrator with disc events (one hand-written CUDA
  kernel on the card, its plain PyTorch version on the CPU; every metric of
  `gradus_tpu_torch.metrics`, cubic or sampled events, an optional tail
  pass) → Newton polish of the hits → analytic Kerr or dot-product
  redshift;
- the line profiles on that integrator: `lineprofile(..., backend="cuda")`
  (Cunningham transfer functions from a finite-difference Newton solve over
  a `DatumPlane`, then Gauss-Legendre integration), and `binned_flux` over a
  `PolarPlane` traced by `CudaTracer`.
"""

from gradus_tpu_torch.camera import (
    CartesianPlane,
    ConstPointFunctions,
    CosGrid,
    FilterPointFunction,
    FilterStatusCode,
    GeometricGrid,
    InverseGrid,
    LinearGrid,
    LogisticGrid,
    PointFunction,
    PolarPlane,
    SinGrid,
    map_impact_parameters,
)
from gradus_tpu_torch.geodesics import metric_jacobian
from gradus_tpu_torch.geometry import AbstractAccretionGeometry, DatumPlane, ThinDisc
from gradus_tpu_torch.integrate import (
    CudaTracer,
    GeodesicPoint,
    StatusCodes,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.lineprofile import (
    BinningMethod,
    TransferFunctionMethod,
    binned_flux,
    lineprofile,
)
from gradus_tpu_torch.metrics import AbstractMetric, KerrMetric, kerr_isco
from gradus_tpu_torch.orbits import CircularOrbits, isco
from gradus_tpu_torch.redshift import redshift_pointfunction
from gradus_tpu_torch.transfer import (
    CudaCTFSolver,
    CunninghamTransferTable,
    LineProfileModel,
    TransferBranchGrid,
    cunningham_transfer_function,
    integrate_lineprofile,
    interpolated_transfer_branches,
    make_transfer_function_table,
    transferfunctions,
)
