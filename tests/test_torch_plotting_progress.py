"""The port's plotting-recipe helpers, progress hooks and ray orderings
(tests/test_plotting_progress.py's cases, held against the JAX package
where it computes the same arrays).

Reference: `src/plotting-recipes.jl` (path extraction and windowing, the
horizon surface, the emissivity index) and the ProgressMeter plumbing
(`src/rendering/utility.jl:30-41`)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradus_tpu as jgt
import gradus_tpu_torch as tgt
from gradus_tpu.camera import tiling as jtiling
from gradus_tpu.plotting import event_horizon_outline as jax_outline
from gradus_tpu.plotting import extract_path as jax_extract_path
from gradus_tpu_torch import plotting
from gradus_tpu_torch.camera import tiling
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.plotting import emissivity_index, extract_path, horizon_circle, horizon_surface

torch.set_num_threads(1)


def test_horizon_shapes():
    m = tgt.KerrMetric(1.0, 0.9, device="cpu")
    x, y, z = horizon_surface(m, n_points=16)
    assert x.shape == (16, 16)
    R = float(m.inner_radius())
    np.testing.assert_allclose(np.sqrt(x**2 + y**2 + z**2), R, rtol=1e-12)
    phi, r = horizon_circle(m, n_points=32, projection="polar")
    np.testing.assert_allclose(r, R)
    cx, cy = horizon_circle(m, n_points=32)
    np.testing.assert_allclose(np.hypot(cx, cy), R, rtol=1e-12)
    # the poloidal outline of the horizon, against the JAX package's
    got = plotting.event_horizon_outline(m, resolution=32)
    want = jax_outline(jgt.KerrMetric(M=1.0, a=0.9), resolution=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-12)


def test_emissivity_index_powerlaw():
    """ε ∝ r^-3 → index ≈ 3 (reference Plot_Emissivity_Index semantics)."""

    class P:
        radii = torch.as_tensor(np.geomspace(2.0, 50.0, 200))
        emissivity = radii**-3.0

    r, idx = emissivity_index(P())
    np.testing.assert_allclose(idx, 3.0, rtol=4e-2)


def test_extract_path_window():
    """Terminated rays window at the endpoint; escaping ones mid-flight
    (reference `_extract_path`, plotting-recipes.jl:3-30); the same arrays
    as the JAX package's."""
    lam = np.linspace(0.0, 400.0, 81)
    traj = np.zeros((81, 8))
    traj[:, 1] = np.linspace(100.0, 3.0, 81)
    traj[:, 2] = np.pi / 2
    st = int(StatusCodes.WithinInnerBoundary)
    x, y, z = extract_path(torch.as_tensor(traj), torch.as_tensor(lam), 81, status=st, n_points=50, t_span=50.0)
    assert x.shape == (50,)
    assert np.hypot(x, y).min() < 10.0
    x2, y2, z2 = extract_path(traj, lam, 81, status=None, n_points=50, t_span=50.0)
    assert 30.0 < np.hypot(x2, y2).mean() < 80.0
    for got, want in zip((x, y, z), jax_extract_path(traj, lam, 81, status=st, n_points=50, t_span=50.0)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_paths_to_cartesian_matches_jax():
    rng = np.random.default_rng(4)
    traj = np.concatenate([np.zeros((3, 10, 1)), rng.uniform(1.0, 20.0, (3, 10, 7))], -1)
    n = np.array([10, 4, 7])
    got = plotting.paths_to_cartesian(torch.as_tensor(traj), None, torch.as_tensor(n))
    want = jgt.plotting.paths_to_cartesian(traj, None, n)
    assert [p.shape for p in got] == [(10, 3), (4, 3), (7, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-14)


def test_tracer_progress_hook():
    """`Tracer` reports its progress by segment (width, alive), and traces
    what `trace_geodesics` traces."""
    m = tgt.KerrMetric(1.0, 0.5, device="cpu")
    d = tgt.ThinDisc(0.0, 20.0, device="cpu")
    events = []
    tracer = tgt.Tracer(m, geometry=d, min_bucket=64, segment_iters=64, progress=events.append)
    x = torch.tensor([0.0, 100.0, math.radians(80.0), 0.0], dtype=torch.float64)
    al = torch.linspace(-10.0, 10.0, 8, dtype=torch.float64) + 1e-3
    be = torch.zeros(8, dtype=torch.float64) + 1e-3
    v = map_impact_parameters(m, x, al, be)
    xs = x.expand_as(v)
    gp = tracer(xs, v, (0.0, 300.0))
    assert len(events) >= 1
    e = events[0]
    assert e["total"] == 8 and e["width"] >= e["alive"] >= 0
    assert e["executed_iters"] > 0
    assert events[-1]["alive"] == 0
    assert [e["segment"] for e in events] == list(range(1, len(events) + 1))
    want = tgt.trace_geodesics(m, xs, v, (0.0, 300.0), geometry=d)
    assert torch.equal(gp.x, want.x) and torch.equal(gp.status, want.status)


@pytest.mark.parametrize("min_bucket", [1 << 62, 2])
def test_cuda_tracer_passes_match_one_pass(min_bucket):
    """`CudaTracer`'s capped, resumed passes (which `Tracer` runs on the
    card to report its progress), at full width or with the survivors
    gathered by the bucket rule, give its one pass bit for bit; on CPU
    tensors through the kernel's plain version."""
    from gradus_tpu_torch.integrate import CudaTracer

    m = tgt.KerrMetric(1.0, 0.5, device="cpu")
    d = tgt.ThinDisc(0.0, 20.0, device="cpu")
    x = torch.tensor([0.0, 100.0, math.radians(80.0), 0.0], dtype=torch.float64)
    al = torch.linspace(-10.0, 10.0, 16, dtype=torch.float64) + 1e-3
    be = torch.linspace(-6.0, 6.0, 16, dtype=torch.float64) + 1e-3
    v = map_impact_parameters(m, x, al, be)
    xs = x.expand_as(v)
    want = CudaTracer(m, geometry=d)(xs, v, (0.0, 300.0))
    events = []
    tracer = CudaTracer(m, geometry=d)
    got = tracer(xs, v, (0.0, 300.0), segments=(8, 8, 16), progress=events.append, min_bucket=min_bucket)
    for a, b in ((got.x, want.x), (got.v, want.v), (got.status, want.status)):
        assert torch.equal(a, b)
    assert [e["executed_iters"] for e in events][:4] == [8, 16, 32, 48]
    assert events[-1]["alive"] == 0 and all(e["total"] == 16 for e in events)
    widths = [e["width"] for e in events]
    assert widths[-1] == (16 if min_bucket > 16 else 6)
    assert int(tracer.last_aux["unfinished"]) == 0


def test_adaptive_render_progress_hook():
    from gradus_tpu_torch.camera.adaptive import adaptive_render

    m = tgt.KerrMetric(1.0, 0.0, device="cpu")
    rounds = []

    def evaluate(ax, bx):
        return np.hypot(np.asarray(ax), np.asarray(bx))  # smooth: no refine

    adaptive_render(m, None, evaluate, n0=8, rounds=2, threshold=1e9, progress=rounds.append)
    assert rounds and rounds[0]["cells"] == 64 and rounds[0]["refining"] == 0


@pytest.mark.parametrize("ny, nx, block", [(64, 96, 32), (50, 70, 16), (7, 5, 4), (1024, 1024, 32)])
def test_tiling_permutations_match_jax(ny, nx, block):
    perm, inv = tiling.block_permutation(ny, nx, block)
    jperm, jinv = jtiling.block_permutation(ny, nx, block)
    assert perm.dtype == jperm.dtype and inv.dtype == jinv.dtype
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(tiling.tile_permutation(ny, nx, block), jtiling.tile_permutation(ny, nx, block))
    np.testing.assert_array_equal(perm[inv], np.arange(ny * nx))
