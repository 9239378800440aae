"""The port's multi-device module (`gradus_tpu_torch.parallel`) against
tests/test_parallel.py, on the CPU over 3 gloo ranks, so that 10, 20 and
256 rays all pad (144 pixels do not): its six cases at that test's sizes
and tolerances, each held to the port's unsharded call and to the JAX
package's sharded result on 8 devices, pinned in
tests/data/jax_reference_parallel.npz (`scripts/torch_parallel_reference.py`).

Against the JAX package, whose arithmetic is another's, test_parallel.py's
tolerances (made for one program against itself) hold where a ray's
result does not hang on its step sequence: statuses, the hits and the rays
that reach λ₁, the emissivity and the gradient. A ray that falls into the
hole ends where a step crosses the inner chart, which each package's
sequence decides (here up to 4.6e-5 apart): both must end inside the
chart, and the shadow image, whose pixels are those rays' affine times, is
held at tests/test_torch_render_api.py's rtol 2e-5 (measured 4.2e-7). The
reference's Pallas kernel and the port's CUDA kernel's plain version agree
on the hits at 1.2e-10 (x), held within 1e-9 of max(1, |value|) as the
kernel parity tests hold them (test_parallel.py's 1e-12 holds the
kernel to itself: the port's gathered batch is its unsharded trace's, bit
for bit). In the line profile two of the 256 rays hit the disc in the port
and stop a step end above it (θ = π/2 − 2e-5) in the JAX package's traces,
which their last bits decide (tests/test_torch_lineprofile_binning.py
avoids such rays): the profiles share all but one nonzero bin, their first
moments agree at 1e-3 (measured 1.3e-4) and Σ|Δf| ≤ 0.05 (measured 0.021).

The collectives carry JAX's derivative rules (psum inside the jvp of the
multichip step, as tests/test_parallel.py writes its gradient case;
`torch.autograd.grad`
through psum and all_gather against `jax.grad`; pmin and pmax refuse a
derivative, as JAX's do).

The ranks start once for the module (`parallel.spawn` over a FileStore in a
temporary directory, one thread each) and run every sharded case of
tests/torch_parallel_ranks.py, while this process makes the unsharded
calls. In this process too, each reduction over the one-process mesh
(world size 1, no process group) is its call without ``axis_name``, bit
for bit.
"""

import math
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_ranks as ranks  # noqa: E402

from gradus_tpu_torch import parallel  # noqa: E402
from gradus_tpu_torch.corona.emissivity import _trace_sky, bin_corona_hits  # noqa: E402
from gradus_tpu_torch.corona.models import LampPostModel  # noqa: E402
from gradus_tpu_torch.corona.profiles import AnalyticRadialDiscProfile  # noqa: E402
from gradus_tpu_torch.corona.samplers import BothHemispheres, EvenSampler, sky_angles_to_velocity  # noqa: E402
from gradus_tpu_torch.corona.spectra import PowerLawSpectrum  # noqa: E402
from gradus_tpu_torch.integrate.status import StatusCodes  # noqa: E402
from gradus_tpu_torch.integrate.tracing import domain_upper_hemisphere, trace_geodesics  # noqa: E402
from gradus_tpu_torch.lineprofile import binned_flux  # noqa: E402
from gradus_tpu_torch.redshift import redshift_pointfunction  # noqa: E402
from gradus_tpu_torch.reverberation import binflux  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_parallel_reference import load  # noqa: E402

JAX = load()
WORLD = 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's output, the unsharded calls by case): the ranks run in
    their processes while this one makes the unsharded calls (in its main
    thread, where `torch.func.jvp` runs)."""
    root, box = tmp_path_factory.mktemp("ranks"), {}

    def run():
        try:
            box["outs"] = parallel.spawn(ranks.run_all, WORLD, device="cpu", backend="gloo", threads=1, root=root)
        except Exception as e:  # raised again below, in the main thread
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    unsharded = {case: ranks.unsharded(case) for case in ranks.CASES}
    thread.join(timeout=600.0)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    return box["outs"], unsharded


def _sharded(world, case):
    return world[0][0]["sharded"][case]


def _same(a, b):
    """Equal, NaN where the other is NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(), b.nan_to_num())


def test_mesh_has_ranks(world):
    """Three gloo ranks, each holding the same gathered and reduced results
    (the global arrays of the reference's mesh)."""
    outs, _ = world
    assert [out["mesh"] for out in outs] == [(r, WORLD, "gloo") for r in range(WORLD)]
    first = outs[0]["sharded"]
    for out in outs[1:]:
        got = out["sharded"]
        for case in ("trace", "pallas"):
            assert _same(got[case].x, first[case].x) and torch.equal(got[case].status, first[case].status)
        assert _same(got["render"], first["render"]) and torch.equal(got["lineprofile"], first["lineprofile"])
        assert torch.equal(got["emissivity"].eps, first["emissivity"].eps)
        assert all(torch.equal(a, b) for a, b in zip(got["gradient"], first["gradient"]))


CAPTURED = StatusCodes.WithinInnerBoundary


def _inside_chart(x):
    """Whether each endpoint lies inside the traces' inner chart (1.01 of
    the horizon of Kerr a = 0.9)."""
    return np.asarray(x)[:, 1] < 1.01 * (1.0 + math.sqrt(1.0 - 0.9**2))


def test_sharded_trace_matches(world):
    """Per-ray results are independent of the sharding layout (10 rays over
    3 ranks, padded to 12): statuses equal, x at rtol 1e-8; against the JAX
    package the captured rays inside the inner chart in both."""
    gp, gp1 = _sharded(world, "trace"), world[1]["trace"]
    np.testing.assert_array_equal(gp.status.numpy(), gp1.status.numpy())
    np.testing.assert_allclose(gp.x.numpy(), gp1.x.numpy(), rtol=1e-8, atol=1e-8)
    status = gp.status.numpy()
    np.testing.assert_array_equal(status, JAX["trace_status"])
    cap = status == CAPTURED
    assert 0 < cap.sum() < len(status) and _inside_chart(gp.x[cap]).all() and _inside_chart(JAX["trace_x"][cap]).all()
    np.testing.assert_allclose(gp.x.numpy()[~cap], JAX["trace_x"][~cap], rtol=1e-8, atol=1e-8)


def test_sharded_lineprofile_matches(world):
    """The psum'd flux histogram (256 plane rays over 3 ranks, padded rays
    of zero area) equals the unsharded histogram, at rtol 1e-10, with Σ = 1."""
    flux = _sharded(world, "lineprofile").numpy()
    np.testing.assert_allclose(flux, world[1]["lineprofile"].numpy(), rtol=1e-10, atol=1e-12)
    assert np.isclose(flux.sum(), 1.0, rtol=1e-8)
    jax_flux = JAX["lineprofile"]
    centres = np.linspace(0.1, 1.5, 180)
    assert ((flux > 0) != (jax_flux > 0)).sum() <= 1 and (flux > 0).sum() > 50
    assert abs((centres * flux).sum() - (centres * jax_flux).sum()) < 1e-3
    assert np.abs(flux - jax_flux).sum() < 0.05


def test_sharded_emissivity_matches(world):
    """pmin/pmax bin agreement and psum'd photon counting (256 samples over
    3 ranks, padded samples masked) equal the unsharded profile: n equal, ε
    at rtol 1e-9, the radii at 1e-12."""
    prof, prof1 = _sharded(world, "emissivity"), world[1]["emissivity"]
    for n, eps, radii in (
        (prof1.n, prof1.eps, prof1.radii),
        (JAX["emissivity_n"], JAX["emissivity_eps"], JAX["emissivity_radii"]),
    ):
        assert int(prof.n) == int(n)
        np.testing.assert_allclose(prof.eps.numpy(), np.asarray(eps), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(prof.radii.numpy(), np.asarray(radii), rtol=1e-12)


def test_sharded_render_matches(world):
    """The sharded 12 × 12 shadow render equals the single-process render
    pixel for pixel (rtol 1e-8), and the JAX package's at rtol 2e-5."""
    img = _sharded(world, "render").numpy()
    np.testing.assert_allclose(img, world[1]["render"].numpy(), rtol=1e-8, atol=1e-8)
    assert np.isfinite(img).sum() > 10
    np.testing.assert_array_equal(np.isnan(img), np.isnan(JAX["render"]))
    np.testing.assert_allclose(img, JAX["render"], rtol=2e-5)


def test_sharded_gradient_psum(world):
    """The multichip step (`parallel.multichip_step`) with the reference
    test's loss, psum'd inside the transform as that test writes it (psum's
    tangent is the psum of the ranks'): the loss at rtol 1e-10 and its spin
    tangent, finite, at rtol 1e-6 against the unsharded jvp and the JAX
    package's jax.jvp of the psum'd loss; the gathered tile sums to the
    loss."""
    img, val, dval = _sharded(world, "gradient")
    assert math.isfinite(float(dval)) and img.shape == (8,)
    np.testing.assert_allclose(float(img.sum()), float(val), rtol=1e-12)
    val1, dval1 = world[1]["gradient"]
    for want, dwant in ((val1, dval1), (JAX["gradient_value"], JAX["gradient_tangent"])):
        np.testing.assert_allclose(float(val), float(want), rtol=1e-10)
        np.testing.assert_allclose(float(dval), float(dwant), rtol=1e-6)


def test_collective_derivatives(world):
    """On every rank, the collectives' derivatives follow JAX's under
    shard_map (pinned on 8 devices): psum's jvp gives the psum'd tangent,
    `torch.autograd.grad` through psum gives each rank the loss's gradient
    in its rows, with no factor of the world's size (jax.grad's), and
    through all_gather alike (rtol 1e-12: the sums' order differs); pmin
    and pmax raise under jvp and grad, as jax.lax.pmin/pmax do."""
    for out in world[0]:
        got = out["sharded"]["derivatives"]
        for val, dval in (got["jvp"], got["gather_jvp"]):
            np.testing.assert_allclose(float(val), JAX["psum_value"], rtol=1e-12)
            np.testing.assert_allclose(float(dval), JAX["psum_tangent"], rtol=1e-12)
        for name in ("grad", "gather_grad"):
            np.testing.assert_allclose(got[name].numpy(), JAX["psum_grad"], rtol=1e-12)
        for name in ("pmin", "pmax"):
            for how in ("jvp", "grad"):
                assert got[f"{name}_{how}"] == f"{name} has no derivative (jax.lax.{name} has none)"


def test_sharded_pallas_trace_matches(world):
    """B1 under the mesh (`sharded_pallas_trace` of a `CudaTracer`, whose
    plain version runs on the CPU): 20 rays over 3 ranks, padded to 21,
    equal the unsharded trace bit for bit (test_parallel.py: rtol 1e-12);
    against the reference's interpret-mode `PallasTracer` on 8 devices,
    statuses equal, the hits' x and v within 1e-9 of max(1, |value|)
    (the kernel parity tests' measure), the captured rays
    inside the inner chart in both."""
    gp, gp1 = _sharded(world, "pallas"), world[1]["pallas"]
    assert torch.equal(gp.status, gp1.status) and torch.equal(gp.x, gp1.x) and torch.equal(gp.v, gp1.v)
    status = gp.status.numpy()
    np.testing.assert_array_equal(status, JAX["pallas_status"])
    hit = status == StatusCodes.IntersectedWithGeometry
    cap = status == CAPTURED
    assert hit.sum() >= 10 and (hit | cap).all() and _inside_chart(gp.x[cap]).all() and _inside_chart(JAX["pallas_x"][cap]).all()
    np.testing.assert_allclose(gp.x.numpy()[hit], JAX["pallas_x"][hit], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(gp.v.numpy()[hit], JAX["pallas_v"][hit], rtol=1e-9, atol=1e-9)


# --- the reductions over the one-process mesh -------------------------------------


@pytest.fixture(scope="module")
def small_traces():
    """A 64-ray plane trace from the flagship camera to ThinDisc(0, 50) and
    a 64-sample lamp-post sky trace (Kerr a = 0.9)."""
    m, x, d = ranks.kerr_setup()
    al = torch.linspace(-25.0, 25.0, 8, dtype=torch.float64)
    A, B = (t.reshape(-1) for t in torch.meshgrid(al + 1e-3, al / 2.0 + 1e-3, indexing="ij"))
    from gradus_tpu_torch.camera.impact import map_impact_parameters

    v = map_impact_parameters(m, x, A, B)
    plane = trace_geodesics(m, x.expand_as(v), v, (0.0, 2000.0), geometry=d, terminate_fns=(domain_upper_hemisphere(),))
    xs, v_src = LampPostModel().sample_position_velocity(m)
    elev, az = EvenSampler(domain=BothHemispheres()).sample_angles(torch.arange(1, 65, dtype=torch.float64), 64)
    sky = _trace_sky(m, d, xs, sky_angles_to_velocity(m, xs, v_src, elev, az), 10000.0)
    return m, x, plane, sky, v_src


@pytest.mark.parametrize("which", ["binned_flux", "binflux", "bin_corona_hits"])
def test_reductions_over_one_process_mesh(small_traces, which):
    """With no process group, ``axis_name=ray_mesh(device="cpu")`` (world
    size 1, whose collectives are the identity) gives what no
    ``axis_name`` gives, bit for bit."""
    m, x, plane, sky, v_src = small_traces
    mesh = parallel.ray_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    if which == "binned_flux":
        kw = dict(min_re=1.5, max_re=50.0, lam_max=2000.0, redshift_pf=redshift_pointfunction(m, x))
        args = (m, plane, torch.ones(64, dtype=torch.float64), ranks.inverse_cube, torch.linspace(0.1, 1.5, 40, dtype=torch.float64))
        got, want = binned_flux(*args, axis_name=mesh, **kw), binned_flux(*args, **kw)
        assert (got > 0).sum() > 5 and torch.equal(got, want)
        return
    if which == "binflux":
        tf = dict(
            metric=m, points=plane, hit=plane.status == StatusCodes.IntersectedWithGeometry,
            areas=torch.ones(64, dtype=torch.float64), x=x, max_t=2000.0,
        )  # fmt: skip
        prof = AnalyticRadialDiscProfile(ranks.inverse_cube, lambda r: r)
        got, want = binflux(tf, prof, N_E=10, N_t=8, axis_name=mesh), binflux(tf, prof, N_E=10, N_t=8)
        assert int((~want[2].isnan()).sum()) > 5
        assert all(_same(a, b) for a, b in zip(got, want))
        return
    hit = sky.status == StatusCodes.IntersectedWithGeometry
    got = bin_corona_hits(m, PowerLawSpectrum(2.0), sky, v_src, hit, n_bins=10, axis_name=mesh)
    want = bin_corona_hits(m, PowerLawSpectrum(2.0), sky, v_src, hit, n_bins=10)
    assert int(want.n) > 3 and all(_same(getattr(got, k), getattr(want, k)) for k in ("radii", "eps", "t", "n"))


def test_axis_name_takes_a_mesh_or_a_group():
    """torch has no named mesh axes: a name raises, naming what it takes."""
    with pytest.raises(TypeError, match="ray_mesh"):
        parallel.psum(torch.ones(3), "rays")
