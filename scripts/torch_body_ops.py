"""Counts the operations of one lockstep loop body for each trace problem of
the port: the nodes a captured CUDA graph of that body holds, one a
dispatched kernel-launching op (views and metadata-only ops not counted).

Runs on the CPU at a small batch (the count does not depend on the batch
size); each problem's `integrate_rays` call is intercepted at its loop and
one body is run under a dispatch counter. Prints one JSON object: the
problem, the ops of its body, and the state's width.

    python scripts/torch_body_ops.py
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import AbstractThickAccretionDisc, MeshAccretionGeometry, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import solver  # noqa: E402
from gradus_tpu_torch.integrate.tracing import (  # noqa: E402
    event_horizon_chart,
    trace_geodesics,
    trace_radiative_transfer,
    trace_windings,
)
from gradus_tpu_torch.metrics import (  # noqa: E402
    JohannsenPsaltisMetric,
    KerrMetric,
    KerrNewmanMetric,
    KerrSpacetimeFirstOrder,
    trace_geodesics_first_order,
)

_VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze", "squeeze", "t", "transpose",
          "permute", "alias", "detach", "as_strided", "unbind", "split", "split_with_sizes", "lift_fresh"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ not in _VIEWS:
            self.ops += 1
        return func(*args, **(kwargs or {}))


class _Slab(AbstractThickAccretionDisc):
    def __init__(self):
        super().__init__()
        self._buffers_from(torch.float64, "cpu", inner_r=8.0, outer_r=12.0)

    def cross_section(self, rho):
        return torch.where((rho > self.inner_r) & (rho < self.outer_r), 1.0, -1.0)

    def emission_coefficient(self, x4, nu):
        return torch.ones(x4.shape[:-1], dtype=x4.dtype, device=x4.device)


def body_ops(call):
    """The ops of the first loop body that ``call()`` runs."""
    seen = {}
    run = solver._run_loop

    def counting(step, cf, max_steps):
        if not seen:
            with _Count() as c:
                step(cf)
            seen.update(ops=c.ops, slots=int(cf["y"].shape[-1]))
        return run(step, cf, 16)

    solver._run_loop = counting
    try:
        call()
    finally:
        solver._run_loop = run
    return seen


def main():
    kw = dict(dtype=torch.float64, device="cpu")
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
    A, B = torch.linspace(-20, 20, 8, **kw), torch.linspace(-10, 10, 8, **kw)
    kerr, disc = KerrMetric(1.0, 0.998, **kw), ThinDisc(0.0, 50.0, **kw)
    v = map_impact_parameters(kerr, x, A, B)
    xs = x.expand_as(v)
    kn = KerrNewmanMetric(1.0, 0.5, 0.3, **kw)
    vkn = map_impact_parameters(kn, x, A, B)
    jp = JohannsenPsaltisMetric(1.0, 0.6, 2.0, **kw)
    vjp = map_impact_parameters(jp, x, A, B)
    tri = torch.tensor([[[-30.0, -30.0, 0.0], [30.0, -30.0, 0.0], [30.0, 30.0, 0.0]]], **kw).repeat(256, 1, 1)
    mesh = MeshAccretionGeometry(tri, [-31.0, -31.0, -1.0], [31.0, 31.0, 1.0], 1e4, **kw)
    problems = {
        "kerr_thin_disc": lambda: trace_geodesics(kerr, xs, v, (0, 2200), geometry=disc),
        "kerr_newman_uncharged": lambda: trace_geodesics(kn, xs, vkn, (0, 2200), geometry=disc),
        "kerr_newman_charged": lambda: trace_geodesics(kn, xs, vkn, (0, 2200), geometry=disc, q=0.3),
        "kerr_shaped_chart": lambda: trace_geodesics(kerr, xs, v, (0, 2200), geometry=disc, chart_inner=event_horizon_chart(kerr)),
        "johannsen_psaltis_shaped_chart": lambda: trace_geodesics(jp, xs, vjp, (0, 2200), geometry=disc, chart_inner=event_horizon_chart(jp)),
        "first_order": lambda: trace_geodesics_first_order(KerrSpacetimeFirstOrder(1.0, 0.998, **kw), xs, v, (0, 2200), geometry=disc),
        "windings": lambda: trace_windings(kerr, xs, v, (0, 2200)),
        "radiative_transfer": lambda: trace_radiative_transfer(kerr, xs, v, (0, 2200), geometry=_Slab()),
        "mesh_256_triangles": lambda: trace_geodesics(kerr, xs, v, (0, 2200), geometry=mesh),
    }
    print(json.dumps({name: body_ops(call) for name, call in problems.items()}))


if __name__ == "__main__":
    main()
