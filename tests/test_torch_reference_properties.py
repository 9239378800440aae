"""Two properties of the JAX package that the port keeps, each shown in both
packages on the same inputs on the CPU (ROADMAP C):

- in f32 the JSF segment-triangle test lets a chord through a mesh where
  it crosses within a few 1e-6 of an edge that two triangles share: each
  triangle's barycentric test rounds the crossing onto its neighbour's
  side. In f64 no chord of the same set gets through;
- at the flagship camera a trace in f32 runs several times the lockstep
  iterations of the same trace in f64 (the error estimate of its slowest
  rays is rounding).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import jsf_segment_triangle as jax_jsf  # noqa: E402
from gradus_tpu.integrate import solver as jax_solver  # noqa: E402

from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import jsf_segment_triangle  # noqa: E402
from gradus_tpu_torch.integrate import trace_geodesics  # noqa: E402
from gradus_tpu_torch.integrate.solver import observe_loops  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402


def _annulus(n_phi, r_in=6.0, r_out=50.0):
    """The equatorial annulus of `chip_smoke.py`'s mesh phase, upward faces:
    (2·n_phi, 3, 3) triangles and the ends of the edges two of them share
    (the radial edges and each quad's diagonal)."""
    phi = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    ring = lambda r: np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros_like(phi)], -1)
    inner, outer = ring(r_in), ring(r_out)
    k = np.arange(n_phi)
    tri = np.concatenate(
        [np.stack([inner[k], outer[k], outer[k + 1]], 1), np.stack([inner[k], outer[k + 1], inner[k + 1]], 1)]
    )
    normal_z = np.cross(tri[:, 0] - tri[:, 2], tri[:, 1] - tri[:, 2])[:, 2]
    tri = np.where((normal_z > 0)[:, None, None], tri, tri[:, [1, 0, 2]])
    return tri, np.concatenate([inner[k], inner[k]]), np.concatenate([outer[k], outer[k + 1]])


def test_jsf_f32_lets_chords_through_shared_edges():
    """4,000 downward chords (0.01–10 long, 5°–80° from the vertical) that
    cross the plane within 5e-6 of a shared edge of a 128-triangle annulus:
    in f32 both packages let more than 0.5% of them through the mesh, at
    rates within 2× of each other (the two packages' f32 roundings differ,
    so not the same chords), and in f64 neither lets one through (measured:
    in f32 the port 1.8%, the JAX package 1.7%)."""
    tri, a, b = _annulus(64)
    rng = np.random.default_rng(10)
    n = 4000
    e = rng.integers(0, len(a), n)
    p = a[e] + rng.uniform(0.02, 0.98, n)[:, None] * (b[e] - a[e])
    u = (b[e] - a[e]) / np.linalg.norm(b[e] - a[e], axis=-1, keepdims=True)
    p += rng.uniform(-5e-6, 5e-6, n)[:, None] * np.stack([-u[:, 1], u[:, 0], 0 * u[:, 0]], -1)
    th, ph = rng.uniform(0.09, 1.4, n), rng.uniform(0, 2 * math.pi, n)
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), -np.cos(th)], -1)
    length = 10 ** rng.uniform(-2, 1, n)
    t1 = rng.uniform(0, 1, n) * length
    q1, q2 = p - t1[:, None] * d, p + (length - t1)[:, None] * d
    args = (q1[:, None], q2[:, None], tri[:, 0], tri[:, 1], tri[:, 2])
    through = {}
    for name, tdt, jdt in (("f32", torch.float32, jnp.float32), ("f64", torch.float64, jnp.float64)):
        port = jsf_segment_triangle(*(torch.as_tensor(x, dtype=tdt) for x in args)).numpy()
        ref = np.asarray(jax_jsf(*(jnp.asarray(x, jdt) for x in args)))
        through[name] = (float((~port.any(-1)).mean()), float((~ref.any(-1)).mean()))
    port32, ref32 = through["f32"]
    assert port32 > 0.005 and ref32 > 0.005, through
    assert 0.5 < port32 / ref32 < 2.0, through
    assert through["f64"] == (0.0, 0.0), through


def test_f32_trace_takes_several_times_f64_iterations():
    """The flagship camera (Kerr a = 0.998, r = 1000, i = 75°, λ ≤ 2200, no
    disc) at 8² of `chip_smoke.py`'s pixel grid: in both packages the f32
    trace runs more than 2.5× the lockstep iterations of the f64 one, and
    the two packages' counts lie within 25% of each other in each dtype
    (measured: the JAX package 877 against 288, the port 960 against 288;
    scripts/torch_reference_witness.py iterations at 24²: 1,689 against
    430 and 1,872 against 432)."""
    side = 8
    al = np.repeat(np.linspace(-28.0, 28.0, side) + 1e-4, side)
    be = np.tile(np.linspace(-18.0, 18.0, side) + 1e-4, side)
    x_obs = [0.0, 1000.0, math.radians(75.0), 0.0]
    span = (0.0, 2200.0)
    iters = {}
    orig = jax_solver.lax

    class _Lax:
        def __getattr__(self, name):
            if name != "while_loop":
                return getattr(orig, name)

            def while_loop(cond, body, init):
                out = orig.while_loop(cond, body, init)
                jax.debug.callback(lambda it: iters.setdefault(key, []).append(int(it)), out["iters"])
                return out

            return while_loop

    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        key = ("jax", dt)
        jm = jgt.KerrMetric(M=jnp.asarray(1.0, jdt), a=jnp.asarray(0.998, jdt))
        jx = jnp.asarray(x_obs, jdt)
        jv = jax_map_impact(jm, jx, jnp.asarray(al, jdt), jnp.asarray(be, jdt))
        jax_solver.lax = _Lax()
        try:
            # unjitted, so that the loop is traced here whatever another test compiled
            jax.block_until_ready(jgt.trace_geodesics.__wrapped__(jm, jnp.broadcast_to(jx, jv.shape), jv, span).x)
        finally:
            jax_solver.lax = orig
        m = KerrMetric(1.0, 0.998, dtype=dt, device="cpu")
        x = torch.tensor(x_obs, dtype=dt)
        v = map_impact_parameters(m, x, torch.as_tensor(al, dtype=dt), torch.as_tensor(be, dtype=dt))
        key = ("port", dt)
        with observe_loops(lambda event, **info: event == "end" and iters.setdefault(key, []).append(info["iterations"])):
            trace_geodesics(m, x.expand_as(v), v, span)
    n = {k: sum(v) for k, v in iters.items()}
    for pkg in ("jax", "port"):
        assert n[(pkg, torch.float32)] > 2.5 * n[(pkg, torch.float64)], n
    for dt in (torch.float32, torch.float64):
        assert abs(n[("port", dt)] / n[("jax", dt)] - 1.0) < 0.25, n
