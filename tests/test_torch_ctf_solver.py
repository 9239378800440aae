"""Parity of the port's transfer-function kernel path with the JAX reference,
piece by piece, in f64 on the CPU: the integrator against a DatumPlane (the
CUDA kernel's plain version against the Pallas kernel in interpret mode),
then the finite-difference offset solver's probe and Jacobian
(`CudaCTFSolver` against `PallasCTFSolver(interpret=True)`), and what the
CUDA path refuses.

The two integrators take different step sequences (see
tests/test_torch_integrate.py), so the solver outputs agree to the Newton
tolerance and the polished hits, not bit for bit.

The comparisons with `PallasTracer` hold only because none of these rays is
a hit whose polish reads a ``dt`` that the Pallas kernel shrank after the
ray ended: a fault of the reference, pinned in
tests/test_torch_pallas_dt_fault.py.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import DatumPlane as JaxDatumPlane  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer, pallas_integrate_rays  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.transfer.pallas_ctf import PallasCTFSolver  # noqa: E402

from gradus_tpu_torch.geometry import DatumPlane, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    CudaTracer,
    _check_kernel_config,
    cuda_integrate_rays,
)
from gradus_tpu_torch.integrate.status import StatusCodes  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.transfer.cuda_ctf import CudaCTFSolver, get_cuda_ctf_solver  # noqa: E402
from gradus_tpu_torch.transfer.cunningham import cunningham_transfer_function  # noqa: E402

A_SPIN = 0.998
X_OBS = np.array([0.0, 1000.0, np.deg2rad(60.0), 0.0])
SPAN = (0.0, 2000.0)  # the CTF solver's λ span and chart: 2·r_obs


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def datum_runs():
    """48 transfer-function rays (ρ ∈ [1.5, 60], θ ∈ [0, 2π) on the image
    plane) against DatumPlane(0), through both integrators."""
    rng = np.random.default_rng(31)
    n = 48
    rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * np.pi, n)
    jm, jd = JaxKerr(M=1.0, a=A_SPIN), JaxDatumPlane(0.0)
    xj = jnp.asarray(X_OBS)
    v = jax_map_impact(jm, xj, jnp.asarray(rho * np.cos(th)), jnp.asarray(rho * np.sin(th)))
    pt = PallasTracer(jm, geometry=jd, chart_outer=SPAN[1], interpret=True)
    y0 = pt._constrain(jnp.broadcast_to(xj, v.shape), v)
    raw_j = pallas_integrate_rays(
        pt._f_cm,
        y0,
        SPAN,
        crossing_cm=pt._crossing_cm,
        hit_cm=pt._hit_cm,
        abstol=pt.abstol,
        reltol=pt.reltol,
        r_inner=pt.r_inner,
        r_outer=pt.r_outer,
        interpret=True,
    )
    gp_j = pt._finish(raw_j, y0, SPAN[0])

    tm, td = from_numpy("KerrMetric", _params(jm), device="cpu"), from_numpy(
        "DatumPlane", _params(jd), device="cpu"
    )
    ct = CudaTracer(tm, geometry=td, chart_outer=SPAN[1])
    y0_t = torch.as_tensor(np.array(y0))
    raw_t = cuda_integrate_rays(tm, y0_t, SPAN, **ct._integrate_kwargs(torch.float64))
    gp_t = ct._finish(raw_t, y0_t, SPAN[0])
    return dict(
        raw_j={k: np.asarray(v) for k, v in raw_j.items()},
        raw_t={k: v.numpy() for k, v in raw_t.items()},
        gp_j=gp_j,
        gp_t=gp_t,
    )


def test_datum_plane_integration_matches_pallas_kernel(datum_runs):
    rj, rt = datum_runs["raw_j"], datum_runs["raw_t"]
    np.testing.assert_array_equal(rt["status"], rj["status"])
    np.testing.assert_array_equal(rt["failed"], rj["failed"])
    hit = rj["status"] == StatusCodes.IntersectedWithGeometry
    assert hit.sum() >= 40
    assert ((rt["hit_theta"][hit] > 0) & (rt["hit_theta"][hit] <= 1)).all()


def test_datum_plane_polished_hits_match_pallas_tracer(datum_runs):
    gj, gt = datum_runs["gp_j"], datum_runs["gp_t"]
    sj = np.asarray(gj.status)
    np.testing.assert_array_equal(gt.status.numpy(), sj)
    keep = (sj == StatusCodes.IntersectedWithGeometry) | (sj == StatusCodes.NoStatus)
    for name in ("x", "v", "lam_max"):
        np.testing.assert_allclose(
            getattr(gt, name).numpy()[keep], np.asarray(getattr(gj, name))[keep], rtol=0, atol=1e-5
        )
    # every hit lies on the plane z = r cos θ = 0
    xh = gt.x.numpy()[sj == StatusCodes.IntersectedWithGeometry]
    np.testing.assert_allclose(xh[:, 1] * np.cos(xh[:, 2]), 0.0, atol=1e-7)


# --- the offset solver ------------------------------------------------------------


@pytest.fixture(scope="module")
def solvers():
    """4 (rₑ, θ) pairs: rₑ ∈ {4, 11} × θ ∈ {0.31, 2.3}; a=0.998, i=60°."""
    RE = np.repeat([4.0, 11.0], 2)
    TH = np.tile([0.31, 2.3], 2)
    sj = PallasCTFSolver(
        JaxKerr(M=1.0, a=A_SPIN), X_OBS, JaxDatumPlane(jnp.asarray(0.0)),
        interpret=True, dtype=jnp.float64,
    )
    st = CudaCTFSolver(
        KerrMetric(1.0, A_SPIN, device="cpu"),
        torch.as_tensor(X_OBS),
        DatumPlane(0.0, device="cpu"),
        dtype=torch.float64,
    )
    probe_j = [np.asarray(v) for v in sj.probe(jnp.asarray(RE), jnp.asarray(TH))]
    probe_t = [v.numpy() for v in st.probe(torch.as_tensor(RE), torch.as_tensor(TH))]
    r_off = probe_j[0]
    jac_j = [np.asarray(v) for v in sj.jacobian_at(jnp.asarray(RE), jnp.asarray(TH), jnp.asarray(r_off))]
    jac_t = [v.numpy() for v in st.jacobian_at(RE, TH, r_off)]
    return dict(probe_j=probe_j, probe_t=probe_t, jac_j=jac_j, jac_t=jac_t)


def test_probe_matches_pallas_solver(solvers):
    (r_j, g_j, t_j, ok_j), (r_t, g_t, t_t, ok_t) = solvers["probe_j"], solvers["probe_t"]
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.all()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-6)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6)


def test_jacobian_at_matches_pallas_solver(solvers):
    (g_j, J_j, t_j, ok_j, c_j), (g_t, J_t, t_t, ok_t, c_t) = solvers["jac_j"], solvers["jac_t"]
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.all()
    np.testing.assert_allclose(J_t, J_j, rtol=1e-4)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-6)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4)


# --- refusals and the solver cache ---------------------------------------------------


@pytest.mark.parametrize("case", ["xla_backend", "per_ray_heights_ctf", "per_ray_heights_kernel"])
def test_cuda_path_refuses_what_it_does_not_take(case):
    m = KerrMetric(1.0, A_SPIN, device="cpu")
    x = torch.as_tensor(X_OBS)
    radii = torch.tensor([5.0], dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        if case == "xla_backend":
            cunningham_transfer_function(m, x, ThinDisc(0.0, math.inf, device="cpu"), radii, N=5, backend="xla")
        elif case == "per_ray_heights_ctf":
            cunningham_transfer_function(m, x, DatumPlane([0.1, 0.2], device="cpu"), radii, N=5, backend="cuda")
        else:
            _check_kernel_config(m, DatumPlane([0.1, 0.2], device="cpu"), torch.float64)
    # a DatumPlane of one height is a kernel configuration
    _check_kernel_config(m, DatumPlane(0.3, device="cpu"), torch.float32)


def test_solver_cache_keys_dtype_and_device():
    """The cache hands an f32 solver to no f64 caller (the JAX package's
    test_solver_cache_keys_dtype), and keys the device."""
    m = KerrMetric(1.0, 0.9, device="cpu")
    x = np.asarray([0.0, 1000.0, np.deg2rad(40.0), 0.0])
    d = DatumPlane(0.0, device="cpu")
    s32 = get_cuda_ctf_solver(m, x, d, dtype=torch.float32)
    s64 = get_cuda_ctf_solver(m, x, d, dtype=torch.float64)
    assert s32 is not s64
    assert s32 is get_cuda_ctf_solver(m, x, d, dtype=torch.float32)
    assert s32.x.dtype == torch.float32 and s32.m.a.dtype == torch.float32
    assert s64.tracer.geometry.height.dtype == torch.float64
    assert s32 is get_cuda_ctf_solver(m, x, d, dtype=torch.float32, device="cpu")
    assert get_cuda_ctf_solver(m, x, DatumPlane(0.5, device="cpu"), dtype=torch.float32) is not s32


@pytest.mark.parametrize("option", ["tile_rows", "interpret", "newton_iters"])
def test_options_the_port_does_not_read_are_refused(option):
    """The TPU kernel's tile options and the 'xla' backend's Newton bound are
    no keyword of the port: passing one fails instead of being ignored."""
    m = KerrMetric(1.0, A_SPIN, device="cpu")
    x = torch.as_tensor(X_OBS)
    with pytest.raises(TypeError):
        if option == "newton_iters":
            cunningham_transfer_function(
                m, x, ThinDisc(0.0, math.inf, device="cpu"), [5.0], N=5, backend="cuda", newton_iters=30
            )
        else:
            get_cuda_ctf_solver(m, x, DatumPlane(0.0, device="cpu"), dtype=torch.float64, **{option: 8})
