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
  `PolarPlane` traced by `CudaTracer`;
- the reference's front door over its lockstep solver, as plain torch on
  the inputs' device (no kernel; differentiable with `torch.func.jvp`):
  `integrate_rays`, `trace_geodesics`, `tracegeodesics`,
  `domain_upper_hemisphere`, `rendergeodesics`, `prerendergeodesics`,
  `EndpointRenderCache`, `apply`, and `lineprofile(...,
  method=BinningMethod())`;
- the lamp-post corona and the reverberation lags, as plain torch on the
  metric's device, with their transfer functions on the CUDA integrator:
  the coronal models and sky samplers, `emissivity_profile`,
  `lineprofile(profile=...)`, `tracegeodesics(m, model, ...)`,
  `find_offset_for_radius`, `continuum_time`, `integrate_lagtransfer`,
  `lag_frequency`, `lagtransfer` and `binflux`.
"""

from gradus_tpu_torch.camera import (
    CartesianPlane,
    ConstPointFunctions,
    CosGrid,
    EndpointRenderCache,
    FilterPointFunction,
    FilterStatusCode,
    GeometricGrid,
    InverseGrid,
    LinearGrid,
    LogisticGrid,
    PointFunction,
    PolarPlane,
    SinGrid,
    apply,
    map_impact_parameters,
    prerendergeodesics,
    rendergeodesics,
)
from gradus_tpu_torch.corona import (
    AnalyticRadialDiscProfile,
    BeamedPointSource,
    BothHemispheres,
    DiscCorona,
    EvenSampler,
    LampPostModel,
    LowerHemisphere,
    PowerLawSpectrum,
    RadialDiscProfile,
    RingCorona,
    WeierstrassSampler,
    emissivity_profile,
    tracecorona,
)
from gradus_tpu_torch.geodesics import metric_jacobian
from gradus_tpu_torch.geometry import AbstractAccretionGeometry, DatumPlane, ThinDisc
from gradus_tpu_torch.integrate import (
    CudaTracer,
    GeodesicPoint,
    StatusCodes,
    cuda_integrate_rays,
    domain_upper_hemisphere,
    integrate_rays,
    integrate_rays_plain,
    trace_geodesics,
    tracegeodesics,
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
from gradus_tpu_torch.reverberation import binflux, continuum_time, lag_frequency, lagtransfer
from gradus_tpu_torch.transfer import (
    CudaCTFSolver,
    CunninghamTransferTable,
    LineProfileModel,
    TransferBranchGrid,
    cunningham_transfer_function,
    find_offset_for_radius,
    impact_parameters_for_radius,
    integrate_lagtransfer,
    integrate_lineprofile,
    interpolated_transfer_branches,
    make_transfer_function_table,
    transferfunctions,
)
