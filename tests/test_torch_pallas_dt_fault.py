"""A fault of the JAX reference's Pallas kernel, pinned as the reference's.

The kernel's lockstep tile goes on stepping a ray after the ray has ended,
and rewrites its ``dt`` with the rejection factor every iteration
(`gradus_tpu/integrate/pallas_solver.py:421`). A hit ray's ``dt`` should
hold its hit step's span; once it has shrunk, `PallasTracer`'s Newton
polish (which clips the crossing's fraction of that span to [0, 1]) cannot
reach a crossing late in the step, and the polished hit lands off the disc.

The rays: the flagship camera (Kerr a = 0.998, r = 1000, i = 75°),
ThinDisc(0, 50), λ ≤ 2200, f64, ρ ~ U(7.5, 20), φ ~ U(0, 2π) from
`numpy.random.default_rng(3)`: of 1,024 such rays, 926 hit, and the three
kept here land 2.9e-3, 5.0e-3 and 2.0e-3 off the plane in the Pallas
tracer. The fault needs the tile to stay alive after those rays end, so the
subset keeps the 1,024's ray of most steps (395) beside them, and a few
healthy hits.

The reference's own XLA solver (`integrate_rays`, which keeps a separate
``hit_dt``) lands the same hits on the plane, and so do the port's
`trace_geodesics` and `CudaTracer`. The other parity tests against
`PallasTracer` (tests/test_torch_integrate.py, test_torch_kernel_modes.py
and the like) pass only because none of their rays is such a hit.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics as jax_trace  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch.integrate import CudaTracer, StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.interop import from_numpy  # noqa: E402

SPAN = (0.0, 2200.0)
FAULTY = [100, 166, 172]
LONGEST = 290
HEALTHY = [0, 1, 2, 4, 5]


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _height(x):
    return np.abs(x[:, 1] * np.cos(x[:, 2]))


@pytest.fixture(scope="module")
def traced():
    rng = np.random.default_rng(3)
    rho, phi = rng.uniform(7.5, 20.0, 1024), rng.uniform(0.0, 2 * np.pi, 1024)
    keep = FAULTY + HEALTHY + [LONGEST]
    A, B = (rho * np.cos(phi))[keep], (rho * np.sin(phi))[keep]
    jm, jd = JaxKerr(M=1.0, a=0.998), JaxThinDisc(0.0, 50.0)
    x_obs = jnp.asarray([0.0, 1000.0, math.radians(75.0), 0.0])
    v = jax_map_impact(jm, x_obs, jnp.asarray(A), jnp.asarray(B))
    xs = jnp.broadcast_to(x_obs, v.shape)
    pallas = PallasTracer(jm, geometry=jd, interpret=True)(xs, v, SPAN)
    xla = jax_trace(jm, xs, v, SPAN, geometry=jd)

    m, d = from_numpy("KerrMetric", _params(jm), device="cpu"), from_numpy("ThinDisc", _params(jd), device="cpu")
    xt, vt = torch.as_tensor(np.array(xs)), torch.as_tensor(np.array(v))
    port = trace_geodesics(m, xt, vt, SPAN, geometry=d)
    cuda_tracer = CudaTracer(m, geometry=d)(xt, vt, SPAN)
    to_np = {"status": lambda g: np.asarray(g.status), "x": lambda g: np.asarray(g.x), "lam": lambda g: np.asarray(g.lam_max)}
    return {
        name: {k: f(g) for k, f in to_np.items()}
        for name, g in (("pallas", pallas), ("xla", xla), ("port", port), ("cuda_tracer", cuda_tracer))
    }


def test_statuses_agree_and_the_long_ray_outlives_the_hits(traced):
    s = traced["xla"]["status"]
    for name in ("pallas", "port", "cuda_tracer"):
        np.testing.assert_array_equal(traced[name]["status"], s)
    assert (s[:-1] == StatusCodes.IntersectedWithGeometry).all()
    assert s[-1] != StatusCodes.IntersectedWithGeometry


def test_pallas_tracer_lands_the_three_hits_off_the_plane(traced):
    z = _height(traced["pallas"]["x"])
    n = len(FAULTY)
    assert (z[:n] > 1e-3).all()  # measured 2.9e-3, 5.0e-3, 2.0e-3
    assert (z[n:-1] < 1e-12).all()


@pytest.mark.parametrize("name", ["xla", "port", "cuda_tracer"])
def test_hits_land_on_the_plane_and_agree_with_the_xla_solver(traced, name):
    """The XLA solver, the port's `trace_geodesics` and `CudaTracer`: every
    hit on the plane (measured ≤ 8e-15), and where the Pallas tracer parts
    from them, only at its three faulty hits."""
    hit = traced["xla"]["status"] == StatusCodes.IntersectedWithGeometry
    assert (_height(traced[name]["x"])[hit] < 1e-12).all()
    ref = traced["xla"]
    np.testing.assert_allclose(traced[name]["x"][hit], ref["x"][hit], rtol=1e-9)
    np.testing.assert_allclose(traced[name]["lam"][hit], ref["lam"][hit], rtol=1e-9)
    parted = np.abs(traced["pallas"]["x"] - ref["x"]).max(axis=1) > 1e-6
    np.testing.assert_array_equal(np.nonzero(parted & hit)[0], np.arange(len(FAULTY)))
