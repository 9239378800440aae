"""The CUDA integrator kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc; skips without a CUDA device. Imports no JAX, so
it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, cuda_solver  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    CudaTracer,
    cuda_integrate_rays,
    integrate_rays_plain,
)
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

SPAN = (0.0, 2200.0)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rays(dev, dtype, n=512):
    rng = np.random.default_rng(5)
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], dtype=dtype, device=dev)
    alpha = torch.as_tensor(rng.uniform(-28, 28, n), dtype=dtype, device=dev)
    beta = torch.as_tensor(rng.uniform(-18, 18, n), dtype=dtype, device=dev)
    v = map_impact_parameters(m, x, alpha, beta)
    return m, x.expand_as(v), v


@pytest.mark.parametrize("with_disc", [True, False], ids=["thin_disc", "no_geometry"])
def test_kernel_matches_plain_version_f64(dev, with_disc):
    m, xs, v = _rays(dev, torch.float64)
    d = ThinDisc(0.0, 50.0, device=dev) if with_disc else None
    tracer = CudaTracer(m, geometry=d)
    y0 = tracer._constrain(xs, v)
    kw = tracer._integrate_kwargs(torch.float64)
    before = cuda_solver.KERNEL_LAUNCHES
    gk = tracer._finish(cuda_integrate_rays(m, y0, SPAN, **kw), y0, SPAN[0])
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    gp = tracer._finish(integrate_rays_plain(m, y0, SPAN, **kw), y0, SPAN[0])
    torch.cuda.synchronize()
    agree = gk.status == gp.status
    assert agree.double().mean() >= 0.999
    keep = agree & (
        (gk.status == StatusCodes.IntersectedWithGeometry) | (gk.status == StatusCodes.NoStatus)
    )
    assert (gk.x[keep] - gp.x[keep]).abs().max() < 1e-6
    assert (gk.lam_max[keep] - gp.lam_max[keep]).abs().max() < 1e-6


def test_kernel_rejects_what_it_does_not_take(dev):
    m, xs, v = _rays(dev, torch.float32, n=8)
    y0 = torch.cat([xs, v], dim=-1)
    kw = dict(abstol=1e-6, reltol=1e-6, r_inner=1.07, r_outer=12000.0)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0, SPAN, mu=1.0, **kw)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0.half(), SPAN, **kw)
