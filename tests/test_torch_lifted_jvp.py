"""`gradus_tpu_torch/utils/jvp.py`: `torch.func.jvp` with the operands
that carry no tangent lifted to zero-tangent duals, which the offset
solver's Newton uses. It must give `torch.func.jvp`'s outputs and tangents
bit for bit, through the lockstep solver and on single ops.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.utils import jvp as lifted  # noqa: E402

A_SPIN = 0.998


def test_lifted_jvp_is_torch_func_jvp_bit_for_bit():
    """`utils/jvp.py::jvp` against `torch.func.jvp` through
    `trace_geodesics`: 16 rays from r = 50 at i = 75° (a = 0.998,
    ThinDisc(0, 50), λ ≤ 120: disc hits, captures and escapes)
    differentiated by the impact parameter β. Every output and tangent is
    the same bit for bit."""
    m = KerrMetric(1.0, A_SPIN, device="cpu")
    d = ThinDisc(0.0, 50.0, device="cpu")
    x = torch.tensor([0.0, 50.0, math.radians(75.0), 0.0], dtype=torch.float64)
    rng = np.random.default_rng(1)
    rho, phi = torch.as_tensor(rng.uniform(3.0, 25.0, 16)), torch.as_tensor(rng.uniform(0.0, 2 * math.pi, 16))

    def trace(B):
        v = map_impact_parameters(m, x, rho * torch.cos(phi), B)
        gp = trace_geodesics(m, x.expand_as(v), v, (0.0, 120.0), geometry=d)
        return gp.x, gp.v, gp.lam_max, gp.status

    B = rho * torch.sin(phi)
    a = torch.func.jvp(trace, (B,), (torch.ones_like(B),))
    b = lifted.jvp(trace, (B,), (torch.ones_like(B),))
    for u, w in zip(a[0][:3] + a[1][:3], b[0][:3] + b[1][:3]):
        assert torch.equal(u.isnan(), w.isnan()) and torch.equal(u.nan_to_num(), w.nan_to_num())
    status = a[0][3]
    assert torch.equal(status, b[0][3])
    hits = int((status == StatusCodes.IntersectedWithGeometry).sum())
    assert 0 < hits < 16 and float(a[1][0].abs().max()) > 0


OPS = {
    "number_times_dual": lambda t, c: 2.5 * t,
    "dual_over_number": lambda t, c: t / 3.0,
    "number_over_dual": lambda t, c: 1.0 / t,
    "number_minus_dual": lambda t, c: 1.0 - t,
    "zero_d_constant": lambda t, c: (c * t + c) / (t - c),
    "plain_tensor": lambda t, c: torch.maximum(t, torch.full_like(t, 0.5).detach()) * torch.arange(3.0, dtype=t.dtype),
    "atan2": lambda t, c: torch.atan2(t, c) + torch.atan2(c, t),
    "f32_with_f64_constant": lambda t, c: t.float() * c + 1.0,
}


@pytest.mark.parametrize("op", list(OPS))
def test_lifted_jvp_of_single_ops(op):
    """Each lifted form against `torch.func.jvp`, values and tangents bit
    for bit, with dtypes kept."""
    t = torch.tensor([0.3, 1.7, -2.2], dtype=torch.float64)
    c = torch.tensor(1.25, dtype=torch.float64)
    f = lambda t: OPS[op](t, c)  # noqa: E731
    a = torch.func.jvp(f, (t,), (torch.ones_like(t),))
    b = lifted.jvp(f, (t,), (torch.ones_like(t),))
    for u, w in zip(a, b):
        assert u.dtype == w.dtype and torch.equal(u, w)
