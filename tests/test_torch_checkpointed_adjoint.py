"""Reverse mode through the port's checkpointed segment ladder
(`trace_geodesics(..., checkpointed=True)`), held against the JAX package:
tests/test_checkpointed_adjoint.py's two tests with their marks, and its
setup's ladder primal and `jax.grad` (pinned in
tests/data/jax_reference_adjoint.npz by scripts/torch_adjoint_reference.py)
against the port's primal and `torch.autograd.grad`."""

import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.integrate import StatusCodes, solver, trace_geodesics
from gradus_tpu_torch.metrics import KerrMetric
from gradus_tpu_torch.utils.interp import linear_interp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_adjoint_reference as ref  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


@dataclasses.dataclass(frozen=True)
class SplineSurface:
    """Warped disc surface z = h(ρ), h a 128-knot linear spline (the JAX
    test's many-parameter head inside the event function)."""

    knots: torch.Tensor
    heights: torch.Tensor

    def height(self, rho):
        return linear_interp(rho, self.knots, self.heights)

    def crossing_indicator(self, x):
        r, th = x[..., 1], x[..., 2]
        return r * torch.cos(th) - self.height(r * torch.sin(th))

    def is_hit(self, x, gtol=1e-2):
        rho = x[..., 1] * torch.sin(x[..., 2])
        return (rho > 5.0) & (rho < 35.0)


def _setup(side=4, device="cpu"):
    m = KerrMetric(1.0, 0.6, device=device)
    x_obs = torch.tensor([0.0, 100.0, math.radians(70.0), 0.0], dtype=torch.float64, device=device)
    al = torch.linspace(-16.0, -8.0, side, dtype=torch.float64, device=device)
    be = torch.linspace(-3.0, 3.0, side, dtype=torch.float64, device=device)
    A = al[:, None].expand(side, side).reshape(-1)
    B = be[None, :].expand(side, side).reshape(-1)
    v = map_impact_parameters(m, x_obs, A, B)
    knots = torch.linspace(3.0, 40.0, 128, dtype=torch.float64, device=device)
    return m, x_obs.expand_as(v), v, knots


def _heights(knots):
    return 0.5 + 0.3 * torch.sin(knots / 5.0)


def _trace(m, xs, v, d, **kw):
    return trace_geodesics(m, xs, v, (0.0, 300.0), geometry=d, **kw)


def _loss_fn(m, xs, v, knots):
    def loss(heights):
        gp = _trace(m, xs, v, SplineSurface(knots, heights), checkpointed=True, n_segments=16, seg_steps=16)
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        rho = gp.x[..., 1] * torch.sin(gp.x[..., 2])
        return torch.where(hit, rho**2 + 0.1 * gp.x[..., 0], 0.0).sum() / xs.shape[0]

    return loss


@pytest.mark.slow
def test_checkpointed_primal_matches_while_loop():
    m, xs, v, knots = _setup()
    d = SplineSurface(knots, _heights(knots))
    gp_w = _trace(m, xs, v, d)
    gp_c = _trace(m, xs, v, d, checkpointed=True, n_segments=16, seg_steps=16)
    assert torch.equal(gp_w.status, gp_c.status)
    np.testing.assert_allclose(gp_w.x.numpy(), gp_c.x.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.slow
def test_checkpointed_adjoint_128_param_head_matches_fd():
    m, xs, v, knots = _setup()
    heights0 = _heights(knots)
    loss = _loss_fn(m, xs, v, knots)
    h = heights0.clone().requires_grad_(True)
    val0 = loss(h)
    assert float(val0) > 0
    (grad,) = torch.autograd.grad(val0, h)
    assert grad.shape == (128,)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    rng = np.random.default_rng(3)
    eps = 3e-5
    with torch.no_grad():
        for _ in range(5):
            u = torch.as_tensor(rng.standard_normal(128))
            u /= torch.linalg.norm(u)
            fd = (loss(heights0 + eps * u) - loss(heights0 - eps * u)) / (2 * eps)
            np.testing.assert_allclose(float(grad @ u), float(fd), rtol=1e-3, atol=1e-9)


def test_ladder_primal_and_grad_match_jax():
    """The JAX test's setup: the ladder's endpoints against the JAX
    ladder's (rtol 1e-10), and `torch.autograd.grad` of its loss against
    `jax.grad` (rtol 1e-6)."""
    want = ref.load()
    m, xs, v, knots = _setup()
    h = _heights(knots).requires_grad_(True)
    gp = _trace(m, xs, v, SplineSurface(knots, h), checkpointed=True, n_segments=16, seg_steps=16)
    np.testing.assert_array_equal(gp.status.numpy(), want["ladder_status"])
    np.testing.assert_allclose(gp.x.detach().numpy(), want["ladder_x"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gp.v.detach().numpy(), want["ladder_v"], rtol=1e-10, atol=1e-10)
    loss = _loss_fn(m, xs, v, knots)(h)
    np.testing.assert_allclose(float(loss), want["ladder_loss"], rtol=1e-10)
    (grad,) = torch.autograd.grad(loss, h)
    np.testing.assert_allclose(grad.numpy(), want["ladder_grad"], rtol=1e-6)



def _replayed_on_the_cpu(monkeypatch):
    """The card's route on CPU tensors: every loop takes the captured path,
    each CUDA graph replaced by a call of the work it would capture."""
    monkeypatch.setattr(solver, "_graphed", lambda cf: True)
    monkeypatch.setattr(solver, "_graph_of", lambda warm_up, work, device, **info: SimpleNamespace(replay=work))


def test_captured_ladder_matches_the_checkpoint(monkeypatch):
    """`solver._CapturedLadder` (the forward replays one body and keeps each
    segment's start; the backward recomputes a segment's carries, then
    replays one body's vjp backwards over them) against the uncaptured
    ladder's `torch.utils.checkpoint` backward, on 2×2 of the JAX test's
    rays, with respect to the 128 heights and the spin a (a metric buffer that requires grad, which also sets the
    rays' start and the chart's inner radius, so the ladder's NaN-guard
    floor): the loss bit for bit, the gradients within 1e-12 of their
    largest entry (autograd and `torch.func.vjp` may add a gradient's terms
    in another order)."""
    _, xs, _, knots = _setup(side=2)
    x = xs[0]
    al = torch.tensor([-16.0, -16.0, -8.0, -8.0], **F64)
    be = torch.tensor([-3.0, 3.0, -3.0, 3.0], **F64)

    def loss_and_grad():
        m = KerrMetric(1.0, 0.6, device="cpu")
        m.a = torch.tensor(0.6, **F64, requires_grad=True)
        v = map_impact_parameters(m, x, al, be)
        h = _heights(knots).requires_grad_(True)
        gp = _trace(m, x.expand_as(v), v, SplineSurface(knots, h), checkpointed=True, n_segments=16, seg_steps=16)
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        rho = gp.x[..., 1] * torch.sin(gp.x[..., 2])
        loss = torch.where(hit, rho**2 + 0.1 * gp.x[..., 0], 0.0).sum() / 4
        return loss, torch.autograd.grad(loss, (h, m.a))

    want = loss_and_grad()
    _replayed_on_the_cpu(monkeypatch)
    calls = []
    with solver.observe_loops(lambda e, **kw: calls.append(kw) if e == "loop" else None):
        got = loss_and_grad()
    assert [kw.get("backward", False) for kw in calls] == [False, True]
    assert torch.equal(got[0], want[0])
    (gh, ga), (wh, wa) = got[1], want[1]
    assert float(wh.abs().max()) > 0 and float(wa) != 0.0
    np.testing.assert_allclose(gh.numpy(), wh.numpy(), rtol=1e-12, atol=1e-12 * float(wh.abs().max()))
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-12)
