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
from gradus_tpu_torch.geometry import DatumPlane, ThinDisc  # noqa: E402
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


def test_datum_plane_kernel_matches_plain_version_f64(dev):
    """Transfer-function rays (image-plane offsets ρ ∈ [1.5, 60], i=60°)
    against DatumPlane(0.5), as `transfer/cuda_ctf.py` traces them."""
    rng = np.random.default_rng(6)
    n, dtype, span = 512, torch.float64, (0.0, 2000.0)
    rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
    m = KerrMetric(1.0, 0.998, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=dtype, device=dev)
    v = map_impact_parameters(
        m,
        x,
        torch.as_tensor(rho * np.cos(th), device=dev),
        torch.as_tensor(rho * np.sin(th), device=dev),
    )
    tracer = CudaTracer(m, geometry=DatumPlane(0.5, device=dev), chart_outer=2000.0)
    y0 = tracer._constrain(x.expand_as(v), v)
    kw = tracer._integrate_kwargs(dtype)
    before = cuda_solver.KERNEL_LAUNCHES
    gk = tracer._finish(cuda_integrate_rays(m, y0, span, **kw), y0, span[0])
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    gp = tracer._finish(integrate_rays_plain(m, y0, span, **kw), y0, span[0])
    torch.cuda.synchronize()
    assert (gk.status == gp.status).double().mean() >= 0.999
    hit = (gk.status == StatusCodes.IntersectedWithGeometry) & (gp.status == gk.status)
    assert hit.double().mean() > 0.9
    # relative to max(1, |value|): t, φ and λ reach ~1000 on rays that graze
    # the photon orbit, where reltol 1e-9 alone allows 1e-6 (chip_smoke.py)
    ends_k = torch.cat([gk.x[hit], gk.lam_max[hit, None]], dim=-1)
    ends_p = torch.cat([gp.x[hit], gp.lam_max[hit, None]], dim=-1)
    assert ((ends_k - ends_p).abs() / ends_p.abs().clamp(min=1.0)).max() < 1e-6
    z = gk.x[hit, 1] * torch.cos(gk.x[hit, 2])
    assert (z - 0.5).abs().max() < 1e-6


def test_kernel_rejects_what_it_does_not_take(dev):
    m, xs, v = _rays(dev, torch.float32, n=8)
    y0 = torch.cat([xs, v], dim=-1)
    kw = dict(abstol=1e-6, reltol=1e-6, r_inner=1.07, r_outer=12000.0)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0, SPAN, mu=1.0, **kw)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0.half(), SPAN, **kw)
    with pytest.raises(NotImplementedError):
        cuda_integrate_rays(m, y0, SPAN, geometry=DatumPlane([0.0] * 8, device=dev), **kw)
