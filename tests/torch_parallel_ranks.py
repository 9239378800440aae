"""What the ranks of tests/test_torch_parallel.py run: tests/test_parallel.py's
six cases through `gradus_tpu_torch.parallel` on the CPU, and the port's
unsharded call of each. Imports torch and the port only (a rank process
imports this module by name)."""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import GeometricGrid
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.camera.planes import PolarPlane
from gradus_tpu_torch.camera.render import rendergeodesics
from gradus_tpu_torch.corona.emissivity import tracecorona_profile
from gradus_tpu_torch.corona.models import LampPostModel
from gradus_tpu_torch.geometry.discs import ThinDisc
from gradus_tpu_torch.integrate.cuda_solver import CudaTracer
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.integrate.tracing import trace_geodesics
from gradus_tpu_torch.lineprofile import BinningMethod, lineprofile
from gradus_tpu_torch.metrics.kerr import KerrMetric
from gradus_tpu_torch.utils.jvp import jvp
from gradus_tpu_torch import parallel

CPU = dict(dtype=torch.float64, device="cpu")
SPAN = (0.0, 2200.0)
RENDER = dict(image_width=12, image_height=12, alpha_lims=(-10.0, 10.0), beta_lims=(-10.0, 10.0), lam_max=2200.0)


def kerr_setup():
    """tests/test_parallel.py's fixture: Kerr a = 0.9 at r = 1000, i = 60°,
    ThinDisc(0, 50)."""
    return (
        KerrMetric(1.0, 0.9, device="cpu"),
        torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], **CPU),
        ThinDisc(0.0, 50.0, device="cpu"),
    )


def trace_rays(m, x):
    """10 rays across α ∈ [−10, 10] (ragged over 3 ranks)."""
    v = map_impact_parameters(m, x, torch.linspace(-10.0, 10.0, 10, **CPU) + 1e-4, torch.zeros(10, **CPU) + 1e-4)
    return torch.broadcast_to(x, v.shape), v


def pallas_y0(m, x, d):
    """The 20 constrained rays of the kernel's case (α ∈ [−10, 10], β = 2)
    and their tracer."""
    al = torch.linspace(-10.0, 10.0, 20, **CPU) + 1e-3
    v = map_impact_parameters(m, x, al, torch.full_like(al, 2.0))
    tracer = CudaTracer(m, geometry=d)
    return tracer, tracer._constrain(torch.broadcast_to(x, v.shape), v)


def lineprofile_plane():
    return PolarPlane(GeometricGrid(), Nr=16, Ntheta=16, r_max=30.0, **CPU)


GRADIENT = dict(x=[0.0, 100.0, math.radians(70.0), 0.0], a=0.5, lam_max=300.0)


def gradient_inputs():
    """8 pixels α ∈ [4, 9], β = 1e-3, from r = 100, i = 70°."""
    return (
        torch.tensor(GRADIENT["x"], **CPU),
        torch.linspace(4.0, 9.0, 8, **CPU),
        torch.zeros(8, **CPU) + 1e-3,
    )


def hit_radius_tile(a, x_obs, alphas, betas, lam_max):
    """tests/test_parallel.py's gradient loss, a pixel: the hit's r against
    ThinDisc(0, 30), 0 for a miss."""
    m = KerrMetric(1.0, a, **CPU)
    v = map_impact_parameters(m, x_obs, alphas, betas)
    gp = trace_geodesics(
        m, torch.broadcast_to(x_obs, v.shape), v, (0.0, lam_max), geometry=ThinDisc(0.0, 30.0, device="cpu")
    )
    return torch.where(gp.status == StatusCodes.IntersectedWithGeometry, gp.x[..., 1], 0.0)


# the collectives' derivatives: Σ sin(x)·x over rows of X, psum'd
DERIVATIVE_X = dict(start=0.1, end=2.4, steps=24)


def collective_derivatives(mesh):
    """psum's and all_gather's derivatives on this rank's rows of X (whose
    length the mesh divides): the value and tangent of the psum'd loss by
    `torch.func.jvp`, the gradients through psum (`torch.autograd.grad`)
    and through all_gather, each gathered; and what differentiating
    through pmin and pmax raises (`jvp`, `grad`)."""
    x = parallel.shard_rows(torch.linspace(**DERIVATIVE_X, **CPU), mesh)
    loss = lambda t: parallel.psum((torch.sin(t) * t).sum(), mesh)  # noqa: E731
    gathered = lambda t: parallel.all_gather(torch.sin(t) * t, mesh).sum()  # noqa: E731
    out = dict(jvp=torch.func.jvp(loss, (x,), (torch.ones_like(x),)))
    out["gather_jvp"] = torch.func.jvp(gathered, (x,), (torch.ones_like(x),))
    for name, fn in (("grad", loss), ("gather_grad", gathered)):
        xr = x.clone().requires_grad_()
        out[name] = parallel.all_gather(torch.autograd.grad(fn(xr), xr)[0], mesh)
    for name, fn in (("pmin", parallel.pmin), ("pmax", parallel.pmax)):
        for how in ("jvp", "grad"):
            xr = x.clone().requires_grad_()
            try:
                if how == "jvp":
                    torch.func.jvp(lambda t: fn(t.sum(), mesh), (x,), (torch.ones_like(x),))
                else:
                    torch.autograd.grad(fn(xr.sum(), mesh), xr)
                out[f"{name}_{how}"] = None
            except NotImplementedError as e:
                out[f"{name}_{how}"] = str(e)
    return out


def sharded(mesh):
    """Every case through the mesh: {case: result on this rank}."""
    m, x, d = kerr_setup()
    xs, v = trace_rays(m, x)
    tracer, y0 = pallas_y0(m, x, d)
    gx, ga, gb = gradient_inputs()
    _, flux = parallel.sharded_lineprofile(m, x, d, plane=lineprofile_plane(), max_re=50.0, mesh=mesh)
    return dict(
        trace=parallel.sharded_trace(m, xs, v, SPAN, geometry=d, mesh=mesh),
        pallas=parallel.sharded_pallas_trace(tracer, y0, SPAN, mesh=mesh),
        render=parallel.sharded_render(m, x, mesh=mesh, **RENDER)[2],
        lineprofile=flux,
        emissivity=parallel.sharded_emissivity(m, d, LampPostModel(), n_samples=256, n_bins=20, mesh=mesh),
        gradient=parallel.multichip_step(
            torch.tensor(GRADIENT["a"], **CPU), gx, ga, gb, GRADIENT["lam_max"], mesh=mesh, tile=hit_radius_tile
        ),
        derivatives=collective_derivatives(mesh),
    )


def unsharded(part):
    """The port's unsharded call of a case (the reference test's right-hand
    side)."""
    m, x, d = kerr_setup()
    if part == "trace":
        xs, v = trace_rays(m, x)
        return trace_geodesics(m, xs, v, SPAN, geometry=d)
    if part == "pallas":
        tracer, y0 = pallas_y0(m, x, d)
        return tracer.trace(y0, SPAN)[0]
    if part == "render":
        return rendergeodesics(m, x, **RENDER)[2]
    if part == "lineprofile":
        return lineprofile(m, x, d, method=BinningMethod(), plane=lineprofile_plane(), max_re=50.0)[1]
    if part == "emissivity":
        return tracecorona_profile(m, d, LampPostModel(), n_samples=256, n_bins=20)
    gx, ga, gb = gradient_inputs()
    a = torch.tensor(GRADIENT["a"], **CPU)
    return jvp(lambda aa: hit_radius_tile(aa, gx, ga, gb, GRADIENT["lam_max"]).sum(), (a,), (torch.ones_like(a),))


CASES = ("trace", "pallas", "render", "lineprofile", "emissivity", "gradient")


def run_all(mesh):
    """{"sharded": {case: result}, "mesh": (rank, size, backend)}."""
    return dict(sharded=sharded(mesh), mesh=(mesh.rank, mesh.size, mesh.backend))


# --- a reduction over two ranks, each holding half of the rays ----------------------


def synthetic_redshift(m, gp, lam_max):
    """A redshift of the points alone (tests/test_torch_lineprofile.py's)."""
    return 0.4 + gp.x[..., 1] / 80.0 + 0.2 * torch.cos(gp.x[..., 3])


def inverse_cube(r):
    return r**-3.0


def _half(t, mesh):
    """This rank's half (rows ⌈n/2⌉·rank onwards) of a per-ray tensor."""
    k = -(-t.shape[0] // mesh.size)
    return t[mesh.rank * k : (mesh.rank + 1) * k]


def _half_points(gp, mesh):
    from gradus_tpu_torch.integrate.points import GeodesicPoint

    return GeodesicPoint(**{f: None if getattr(gp, f) is None else _half(getattr(gp, f), mesh) for f in gp.__dataclass_fields__})


def reduce_halves(mesh, jobs):
    """[`_reduce_half(mesh, which, inputs)` for each (which, inputs) of
    ``jobs``]."""
    return [_reduce_half(mesh, which, inputs) for which, inputs in jobs]


def _reduce_half(mesh, which, inputs):
    """``which`` ("binned_flux", "binflux" or "bin_corona_hits") over the
    mesh, this rank holding its half of the rays of ``inputs``."""
    if which == "binned_flux":
        from gradus_tpu_torch.lineprofile import binned_flux

        gp, areas, bins, kw = inputs
        return binned_flux(
            None, _half_points(gp, mesh), _half(areas, mesh), inverse_cube, bins,
            redshift_pf=synthetic_redshift, axis_name=mesh, **kw,
        )  # fmt: skip
    if which == "binflux":
        from gradus_tpu_torch.reverberation import binflux

        tf, kw = inputs
        half = dict(tf, points=_half_points(tf["points"], mesh), hit=_half(tf["hit"], mesh), areas=_half(tf["areas"], mesh))
        return binflux(half, axis_name=mesh, **kw)
    from gradus_tpu_torch.corona.emissivity import bin_corona_hits

    m, spectrum, gp, v_src, hit, n_bins = inputs
    return bin_corona_hits(m, spectrum, _half_points(gp, mesh), v_src, _half(hit, mesh), n_bins=n_bins, axis_name=mesh)
