"""The port's dense traces against the JAX package's, in f64 on the CPU:
`trace_geodesics_dense` (trajectory, λ and step count, the JAX package
compiled without fused multiply-adds) and its tangent carried through the
loop (``v_dot=``) against `torch.func.jvp` around the whole loop, bit for
bit; and `is_visible` at tests/test_extended_corona.py's configuration.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu.transfer.targets as jt  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics as jax_trace  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics_dense as jax_dense  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.metrics import SchwarzschildMetric as JaxSchwarzschild  # noqa: E402

import gradus_tpu_torch.transfer.targets as tt  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.integrate.tracing import trace_geodesics_dense  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.utils.jvp import jvp  # noqa: E402

A_SPIN = 0.5
# XLA's CPU backend contracts a·b + c into fused multiply-adds; compiled at
# level 0 the JAX package keeps the arithmetic as written
_NO_FMA = {"xla_backend_optimization_level": 0}


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


def _kerr():
    return JaxKerr(M=1.0, a=A_SPIN), KerrMetric(1.0, A_SPIN, device="cpu")


def test_dense_tangent_matches_jvp_of_the_whole_loop():
    """Two rays, one through ThinDisc(0, 50), from r = 100, f64, 32 saved
    states: the trajectory, its λ and the endpoint, and their tangents
    ∂/∂β, from `trace_geodesics_dense(..., v_dot=...)` equal those of
    `torch.func.jvp` (lifted) around the whole uncaptured dense trace, bit
    for bit; the step counts equal the primal's."""
    _, m = _kerr()
    x = _t([0.0, 100.0, math.radians(45.0), 0.0])
    A, B = _t([3.0, 0.5]), _t([1.0, -4.0])
    d = ThinDisc(0.0, 50.0, device="cpu")
    kw = dict(geometry=d, n_save=32, chart_outer=120.0)

    def dense(b):
        v = map_impact_parameters(m, x, A, b)
        gp, traj, traj_lam, _ = trace_geodesics_dense(m, x.expand_as(v), v, (0.0, 300.0), **kw)
        return gp.x, traj, traj_lam

    ones = torch.ones_like(B)
    whole, whole_dot = jvp(dense, (B,), (ones,))
    v, v_dot = jvp(lambda b: map_impact_parameters(m, x, A, b), (B,), (ones,))
    (gp, traj, lam, n), (gp_dot, traj_dot, lam_dot, n_dot) = trace_geodesics_dense(
        m, x.expand_as(v), v, (0.0, 300.0), v_dot=v_dot, **kw
    )
    for got, want in zip((gp.x, traj, lam, gp_dot.x, traj_dot, lam_dot), whole + whole_dot):
        assert torch.equal(got, want)
    assert torch.equal(n, n_dot) and torch.equal(traj, dense(B)[1])
    assert (gp.status == StatusCodes.IntersectedWithGeometry).sum() >= 1
    assert bool(torch.isfinite(traj_dot).all()) and float(traj_dot.abs().max()) > 0


def test_dense_trace_matches_jax():
    """tests/test_adaptive_dense.py's dense case (Schwarzschild, r = 100,
    α = 7, β = 1, λ ≤ 300, 256 saved states): the same step count, the
    trajectory at 5e-6 and λ at 1e-7 (the JAX package compiled without
    fused multiply-adds; measured 1.4e-6 relative, 1.9e-6 absolute, and
    6.2e-9, in the last few of 173 states, where the steps are longest);
    and that test's checks on the port: the
    trajectory ends at the endpoint, λ increases, it starts at the
    observer."""
    jm, tm = JaxSchwarzschild(M=1.0), KerrMetric(1.0, 0.0, device="cpu")
    x = [0.0, 100.0, math.pi / 2, 0.0]
    vj = jax_map_impact(jm, jnp.asarray(x), jnp.asarray(7.0), jnp.asarray(1.0))

    def run(x, v):
        return jax_dense(jm, x, v, (0.0, 300.0), n_save=256)

    gj, trj, lj, nj = jax.jit(run).lower(jnp.asarray(x), vj).compile(_NO_FMA)(jnp.asarray(x), vj)
    v = map_impact_parameters(tm, _t(x), _t(7.0), _t(1.0))
    gp, traj, lam, n = trace_geodesics_dense(tm, _t(x), v, (0.0, 300.0), n_save=256)
    n = int(n)
    assert n == int(nj) and 10 < n <= 256
    np.testing.assert_allclose(traj[:n].numpy(), np.asarray(trj)[:n], rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(lam[:n].numpy(), np.asarray(lj)[:n], rtol=1e-7)
    np.testing.assert_allclose(traj[n - 1, 0:4].numpy(), gp.x.numpy(), rtol=1e-10)
    assert np.all(np.diff(lam[:n].numpy()) > 0) and float(traj[0, 1]) == 100.0
    np.testing.assert_allclose(gp.x.numpy(), np.asarray(gj.x), rtol=1e-9)


def test_is_visible():
    """tests/test_extended_corona.py's case (r = 1000, i = 85°): the ray far
    from the hole re-traces to its endpoint, some of the near-plane rays
    meet the disc; the same flags as the JAX package."""
    jm, tm = _kerr()
    x = [0.0, 1000.0, math.radians(85.0), 0.0]
    al, be = [80.0, 0.0, 4.0, -4.0], [80.0, 5.0, 3.0, 3.0]
    vj = jax_map_impact(jm, jnp.asarray(x), jnp.asarray(al), jnp.asarray(be))
    gj = jax_trace(jm, jnp.broadcast_to(jnp.asarray(x), vj.shape), vj, (0.0, 4000.0), chart_outer=2000.0)
    want = np.asarray(jt.is_visible(jm, JaxThinDisc(0.0, 100.0), gj, lam_max=4000.0, atol=1e-4, chart_outer=2000.0))
    v = map_impact_parameters(tm, _t(x), _t(al), _t(be))
    gp = trace_geodesics(tm, _t(x).expand_as(v), v, (0.0, 4000.0), chart_outer=2000.0)
    vis = tt.is_visible(tm, ThinDisc(0.0, 100.0, device="cpu"), gp, lam_max=4000.0, atol=1e-4, chart_outer=2000.0)
    assert vis.dtype == torch.bool and vis.shape == (4,)
    assert bool(vis[0]) and not bool(vis[1:].all())
    np.testing.assert_array_equal(vis.numpy(), want)
