"""The multichip step: a render tile and its spin tangent on every rank, the
loss and its tangent all-reduced (counterpart of the JAX package's
`__graft_entry__.py::_render_tile` and of `dryrun_multichip`'s step).

Each rank traces its shard of the pixels with `trace_geodesics` and takes
the spin tangent with `torch.func.jvp` (on the card the lifted trace, whose
captured loop carries the tangent). The loss is psum'd inside the
transform, as tests/test_parallel.py writes its gradient: psum is linear,
so its tangent is the psum of the ranks' tangents, and the loss and its
tangent come out all-reduced, equal to `dryrun_multichip`'s psum after
`jax.jvp`.
"""

from __future__ import annotations

import torch

from gradus_tpu_torch.parallel.mesh import all_gather, psum, ray_mesh
from gradus_tpu_torch.parallel.sharded import local_rows, real_rows
from gradus_tpu_torch.utils.jvp import jvp

__all__ = ["render_tile", "multichip_step"]


def render_tile(a, x_obs, alphas, betas, lam_max):
    """Redshift of each pixel (α, β) of Kerr spin ``a`` against
    ThinDisc(0, 50), 0 where the ray misses the disc: the flagship forward
    step."""
    from gradus_tpu_torch.camera.impact import map_impact_parameters
    from gradus_tpu_torch.geometry.discs import ThinDisc
    from gradus_tpu_torch.integrate.status import StatusCodes
    from gradus_tpu_torch.integrate.tracing import trace_geodesics
    from gradus_tpu_torch.metrics.kerr import KerrMetric
    from gradus_tpu_torch.redshift import redshift_pointfunction

    kw = dict(dtype=alphas.dtype, device=alphas.device)
    m = KerrMetric(1.0, a, **kw)
    d = ThinDisc(0.0, 50.0, **kw)
    v = map_impact_parameters(m, x_obs, alphas, betas)
    gp = trace_geodesics(m, torch.broadcast_to(x_obs, v.shape), v, (0.0, lam_max), geometry=d)
    g = redshift_pointfunction(m, x_obs)(m, gp, lam_max)
    return torch.where(gp.status == StatusCodes.IntersectedWithGeometry, g, 0.0)


def multichip_step(a, x_obs, alphas, betas, lam_max=2200.0, *, mesh=None, tile=render_tile):
    """One step over the mesh: (the tile of every pixel, gathered on every
    rank; Σ tile; ∂Σ tile/∂a). ``tile(a, x_obs, alphas, betas, lam_max)``
    gives a value a pixel (`render_tile` by default); each rank evaluates
    it and its tangent in ``a`` on its shard of the pixels (padded pixels
    count 0), and the two sums are all-reduced."""
    mesh = mesh or ray_mesh(device=alphas.device)
    n = alphas.shape[0]
    al, be, valid = local_rows(alphas, mesh), local_rows(betas, mesh), real_rows(n, mesh, alphas.device)
    # on the CPU the constants are lifted (`utils.jvp`: the same bits, ~3x
    # faster there), as diff.py's jacfwd does
    fwd = jvp if a.device.type == "cpu" else torch.func.jvp

    def step(aa):
        img = torch.where(valid, tile(aa, x_obs, al, be, lam_max), 0.0)
        return img, psum(img.sum(), mesh)

    (img, loss), (_, dloss) = fwd(step, (a,), (torch.ones_like(a),))
    return all_gather(img, mesh)[:n], loss, dloss
