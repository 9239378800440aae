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
- the default `xla` transfer functions (the jvp Newton of
  `transfer/solvers.py` through the lockstep solver), for every disc of
  `geometry/discs.py`, thick ones through one datum plane per radius;
- the reference's front door over its lockstep solver, as plain torch on
  the inputs' device (no kernel; on the card the loop replays a CUDA graph;
  forward mode by `torch.func.jvp` on the CPU, by ``v_dot=`` anywhere):
  `integrate_rays`, `trace_geodesics`, `tracegeodesics`,
  `domain_upper_hemisphere`, `rendergeodesics`, `prerendergeodesics`,
  `EndpointRenderCache`, `apply`, and `lineprofile(...,
  method=BinningMethod())`;
- the coronae and the reverberation lags, as plain torch on the metric's
  device, with their transfer functions on the CUDA integrator: the
  coronal models and sky samplers, `emissivity_profile` (the lamp post's
  sweep, the ring and disc coronae's β-slice fans and the adaptive sky's
  near field), `lineprofile(profile=...)`, `tracegeodesics(m, model,
  ...)`, `find_offset_for_radius`, the target search
  (`optimize_for_target`, `refine_for_target`, `is_visible`),
  `continuum_time`, `integrate_lagtransfer` and its time-dependent form,
  `lag_frequency`, `lagtransfer` and `binflux`; the host-driven adaptive
  grids of `camera/adaptive.py`;
- the special traces on the lockstep solver: charged traces (the
  Kerr-Newman Lorentz force), the θ-dependent inner chart
  (`event_horizon_chart`, with `event_horizon`, `ergosphere` and
  `is_naked_singularity`), the first-order Mino-time Kerr tracer
  (`trace_geodesics_first_order`), `trace_radiative_transfer`,
  `trace_windings`, triangle meshes (`MeshAccretionGeometry` and the
  polygon utilities) and the orbit solvers of `orbits/solving.py`;
- the reference's public names beside these: every metric class, the
  geodesic equation and its constraints, the tetrads and the LNRF frame,
  the metric's free functions, the redshift interpolations and
  `unpack_solution`;
- the AD half: `fwd_adjoint`, `value_and_grad_fwd` and `grad_fwd` (the
  forward parameter Jacobian, on the card through the captured loop with
  the parameters' tangents in its carry), and `trace_geodesics(...,
  checkpointed=True)`, the reverse-mode segment ladder (on the card with a
  captured backward);
- the periphery: `Tracer` (segmented, on the CUDA integrator where it
  takes the configuration), `save_npz`/`load_npz` (the JAX package's file
  format), `plotting` and `camera/tiling.py`;
- multi-device tracing over `torch.distributed`, in the subpackage
  `gradus_tpu_torch.parallel` as in the JAX package: the ray mesh and its
  collectives, the sharded trace, render, line profile and emissivity, B1
  under the mesh and the multichip step.

Not here: `enable_x64`, which has no torch meaning (a tensor's dtype is its
own; pass ``dtype=torch.float64``), and `parallel`'s `P_RAYS` and `P_NONE`,
JAX `PartitionSpec`s (a rank's shard follows from its rank).
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
    AdaptiveGrid2D,
    adaptive_render,
    adaptive_sky,
    apply,
    fill_sky_values,
    local_momentum,
    map_impact_parameters,
    prerendergeodesics,
    rendergeodesics,
)
from gradus_tpu_torch.corona import (
    AnalyticRadialDiscProfile,
    BeamedPointSource,
    BothHemispheres,
    DiscCorona,
    DiscCoronaProfile,
    EvenSampler,
    LampPostModel,
    LowerHemisphere,
    PowerLawSpectrum,
    RadialDiscProfile,
    RingCorona,
    RingCoronaProfile,
    TimeDependentRadialDiscProfile,
    WeierstrassSampler,
    disc_corona_profile,
    emissivity_profile,
    ring_corona_profile,
    ring_corona_profile_hybrid,
    tracecorona,
)
from gradus_tpu_torch.geodesics import (
    constrain,
    constrain_all,
    constrain_time,
    dotproduct,
    geodesic_equation,
    lnrbasis,
    lnrframe,
    lowerindices,
    metric_jacobian,
    propernorm,
    raiseindices,
    tetradframe,
)
from gradus_tpu_torch.geometry import (
    AbstractAccretionGeometry,
    CompositeGeometry,
    DatumPlane,
    EllipticalDisc,
    MeshAccretionGeometry,
    PolishDoughnut,
    PrecessingDisc,
    ShakuraSunyaev,
    ThickDisc,
    ThinDisc,
    WarpedThinDisc,
    in_polygon,
    jsf_segment_triangle,
    orientation,
    polygon_area,
    polygon_barycenter,
)
from gradus_tpu_torch.integrate import (
    CudaTracer,
    GeodesicPoint,
    StatusCodes,
    Tracer,
    cuda_integrate_rays,
    domain_upper_hemisphere,
    integrate_rays,
    integrate_rays_plain,
    cuda_graphs,
    PoloidalShape,
    TraceGeodesic,
    TraceRadiativeTransfer,
    event_horizon_chart,
    trace_geodesics,
    trace_radiative_transfer,
    trace_windings,
    tracegeodesics,
    unpack_solution,
)
from gradus_tpu_torch.diff import fwd_adjoint, grad_fwd, value_and_grad_fwd
from gradus_tpu_torch.lineprofile import (
    BinningMethod,
    TransferFunctionMethod,
    binned_flux,
    lineprofile,
)
from gradus_tpu_torch.metrics import (
    AbstractMetric,
    BumblebeeMetric,
    CartesianMetric,
    DilatonAxion,
    JohannsenMetric,
    JohannsenPsaltisMetric,
    KerrDarkMatter,
    KerrMetric,
    KerrNewmanMetric,
    KerrRefractive,
    KerrSpacetimeFirstOrder,
    MorrisThorneWormhole,
    NoZMetric,
    SchwarzschildMetric,
    SphericalMetric,
    inner_radius,
    inverse_metric_components,
    kerr_isco,
    metric_4x4,
    metric_components,
    trace_geodesics_first_order,
)
from gradus_tpu_torch.orbits import (
    CircularOrbits,
    PlungingInterpolation,
    charged_circular_orbit_omega,
    ergosphere,
    event_horizon,
    interpolate_plunging_velocities,
    is_naked_singularity,
    isco,
    solve_equatorial_circular_orbit,
    solve_orbit_theta,
)
from gradus_tpu_torch import redshift_analytic
from gradus_tpu_torch.redshift import interpolate_redshift, keplerian_velocity_projector, redshift_pointfunction
from gradus_tpu_torch.redshift_analytic import analytic_redshift_pointfunction
from gradus_tpu_torch.reverberation import binflux, continuum_time, lag_frequency, lagtransfer
from gradus_tpu_torch.serialization import load_npz, save_npz
from gradus_tpu_torch.utils import (
    cartesian_distance,
    cartesian_squared_distance,
    cartesian_to_spherical,
    oblate_spheroid_to_spherical,
)
from gradus_tpu_torch.transfer import (
    CudaCTFSolver,
    CunninghamTransferTable,
    LineProfileModel,
    TransferBranchGrid,
    closest_approach,
    cunningham_transfer_function,
    find_offset_for_radius,
    impact_parameters_for_radius,
    impact_parameters_for_target,
    integrate_lagtransfer,
    integrate_lagtransfer_timedep,
    integrate_lineprofile,
    is_visible,
    optimize_for_target,
    interpolated_transfer_branches,
    make_transfer_function_table,
    transferfunctions,
)
