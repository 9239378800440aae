from gradus_tpu_torch.integrate.cuda_solver import (
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.integrate.points import GeodesicPoint, unpack_solution
from gradus_tpu_torch.integrate.solver import (
    CompactedIntegrator,
    IntegrationResult,
    cuda_graphs,
    integrate_rays,
    integrate_rays_checkpointed,
)
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tsit5 import TSIT5_C
from gradus_tpu_torch.integrate.tracing import (
    PoloidalShape,
    TraceGeodesic,
    Tracer,
    TraceRadiativeTransfer,
    domain_upper_hemisphere,
    event_horizon_chart,
    make_geodesic_rhs,
    trace_geodesics,
    trace_radiative_transfer,
    trace_windings,
    tracegeodesics,
)
