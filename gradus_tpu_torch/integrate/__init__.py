from gradus_tpu_torch.integrate.cuda_solver import (
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.integrate.points import GeodesicPoint, unpack_solution
from gradus_tpu_torch.integrate.solver import IntegrationResult, integrate_rays
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import (
    TraceGeodesic,
    domain_upper_hemisphere,
    make_geodesic_rhs,
    trace_geodesics,
    tracegeodesics,
)
