"""Reverse-mode gradients through the port's integrator, held against the
JAX package (tests/test_reverse_mode.py, with the same marks): `fwd_adjoint`
on (spin, inclination) through a small render, and the helpers of
`gradus_tpu_torch/diff.py` on closed-form functions against
`gradus_tpu.diff` under `jax.grad`. The JAX side of the render's Jacobian
is pinned in tests/data/jax_reference_adjoint.npz
(scripts/torch_adjoint_reference.py). Also the card's route for a trace
under a `torch.func` transform (`tracing._LiftedTrace`: the parameter
tangents carried through the lockstep loop), run here on CPU tensors, bit
for bit against `torch.func.jvp` and `jacfwd` through the plain loop."""

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradus_tpu.diff as jdiff
import gradus_tpu_torch as tgt
from gradus_tpu_torch import diff as tdiff
from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.integrate import solver, tracing
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.redshift import redshift_pointfunction

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_adjoint_reference as ref  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


def _mean_redshift(params, n=8, r_obs=1000.0, lam_max=2200.0):
    """tests/test_reverse_mode.py's loss in the port: the masked mean
    redshift of an n×n Kerr disc render, as a function of the spin ``a``
    and the inclination ``incl``."""
    a, incl = params["a"], params["incl"]
    m = tgt.KerrMetric(1.0, a, device=incl.device)
    d = tgt.ThinDisc(0.0, 50.0, device=incl.device)
    z = torch.zeros((), dtype=incl.dtype, device=incl.device)
    x = torch.stack([z, z + r_obs, incl, z])
    al = torch.linspace(-12.0, 12.0, n, **F64).to(incl.device) + 1e-3
    be = torch.linspace(-8.0, 8.0, n, **F64).to(incl.device) + 1e-3
    A = al[:, None].expand(n, n).reshape(-1)
    B = be[None, :].expand(n, n).reshape(-1)
    v = map_impact_parameters(m, x, A, B)
    gp = tgt.trace_geodesics(m, x.expand_as(v), v, (0.0, lam_max), geometry=d)
    g = redshift_pointfunction(m, x)(m, gp, lam_max)
    hit = gp.status == StatusCodes.IntersectedWithGeometry
    return torch.where(hit, g, 0.0).sum() / hit.sum()


def _params(a, incl_deg):
    return {"a": torch.tensor(a, **F64), "incl": torch.tensor(math.radians(incl_deg), **F64)}


@pytest.mark.slow
def test_grad_render_vjp_jvp_fd_agree():
    params = {k: v.requires_grad_(True) for k, v in _params(0.5, 60.0).items()}
    loss = tdiff.fwd_adjoint(_mean_redshift)(params)
    g_rev = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    g_fwd = torch.func.jacfwd(_mean_redshift)({k: v.detach() for k, v in params.items()})

    def fd(key, eps=1e-4):
        up = {k: v.detach().clone() for k, v in params.items()}
        dn = {k: v.detach().clone() for k, v in params.items()}
        up[key] += eps
        dn[key] -= eps
        return (float(_mean_redshift(up)) - float(_mean_redshift(dn))) / (2 * eps)

    for key in ("a", "incl"):
        np.testing.assert_allclose(float(g_rev[key]), float(g_fwd[key]), rtol=1e-6)
        np.testing.assert_allclose(float(g_rev[key]), fd(key), rtol=2e-2, atol=1e-7)
    assert abs(float(g_rev["incl"])) > 1e-5


def test_grad_composes_with_downstream_reverse_ad():
    """The wrapper sits at the trace boundary; plain reverse mode handles
    the downstream computation on top of it. The JAX side is `jax.jacfwd`
    of the unwrapped pipeline (pinned)."""
    want = ref.load()
    params = {k: v.requires_grad_(True) for k, v in _params(0.3, 45.0).items()}
    v = tdiff.fwd_adjoint(_mean_redshift)(params)
    out = torch.tanh(v) ** 2 + 3.0 * v
    g = dict(zip(params, torch.autograd.grad(out, list(params.values()))))
    np.testing.assert_allclose(float(v), want["composes_value"], rtol=1e-10)
    for key in ("a", "incl"):
        np.testing.assert_allclose(float(g[key]), want[f"composes_grad_{key}"], rtol=1e-6)


@pytest.mark.slow
def test_lineprofile_model_gradient():
    """Reverse mode through the fittable LineProfileModel (table
    interpolation and line integration) with respect to (a, inner_r, lineE,
    K), as the JAX test's `jax.grad`."""
    d = tgt.ThinDisc(0.0, math.inf, device="cpu")
    table = tgt.make_transfer_function_table(
        tgt.KerrMetric, d, [0.5, 0.7], [40.0, 50.0], n_radii=6, r_max=30.0, N=16, N_extrema=6, Ng=24, device="cpu"
    )
    model = tgt.LineProfileModel(table=table)
    energies = torch.linspace(2.0, 9.0, 40, **F64)

    def chi2(p):
        flux = model(energies, a=p["a"], inner_r=p["inner_r"], lineE=p["lineE"], K=p["K"])
        return torch.sum((flux - 0.01) ** 2)

    p0 = {k: torch.tensor(v, **F64, requires_grad=True) for k, v in dict(a=0.6, inner_r=4.0, lineE=6.4, K=1.0).items()}
    g = dict(zip(p0, torch.autograd.grad(chi2(p0), list(p0.values()))))
    for k, v in g.items():
        assert np.isfinite(float(v)), k
    eps = 1e-4
    with torch.no_grad():
        up = {k: v.detach() + (eps if k == "K" else 0.0) for k, v in p0.items()}
        dn = {k: v.detach() - (eps if k == "K" else 0.0) for k, v in p0.items()}
        fd = (float(chi2(up)) - float(chi2(dn))) / (2 * eps)
    np.testing.assert_allclose(float(g["K"]), fd, rtol=1e-4)


# --- the helpers on closed-form functions, against gradus_tpu.diff ---------


def _f_dict(lib):
    def f(p, w):
        return lib.stack([lib.sin(p["a"]) * p["b"].sum(), p["a"] ** 2 * w, lib.log(p["a"] - 2.0)])

    return f


def _f_tuple(lib):
    def f(p, w):
        return lib.tanh(p[0]) * p[1] + w * p[0] ** 3

    return f


_P = {"a": np.array(0.7), "b": np.array([1.0, 2.0, -0.5])}
_W = np.array(3.0)


def _t(p):
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()} if isinstance(p, dict) else tuple(
        torch.tensor(v, dtype=torch.float64) for v in p
    )


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()} if isinstance(p, dict) else tuple(jnp.asarray(v) for v in p)


def _leaves(p):
    return list(p.values()) if isinstance(p, dict) else list(p)


def _close(got, want, rtol=1e-13):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=1e-15)


_CASES = {
    # a NaN row (log of a negative number): its Jacobian entries count as zero
    "dict_nan_row": (_f_dict, _P, lambda y: y[0] * 2.0 + y[1] + 0.0 * y[2], lambda y: y[0] * 2.0 + y[1] + 0.0 * y[2]),
    "tuple": (_f_tuple, (np.array(0.3), np.array(2.0)), lambda y: y, lambda y: y),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fwd_adjoint_matches_jax_grad(case):
    make, p, head_t, head_j = _CASES[case]
    pt = {k: v.requires_grad_(True) for k, v in _t(p).items()} if isinstance(p, dict) else tuple(
        v.requires_grad_(True) for v in _t(p)
    )
    w = torch.tensor(_W, dtype=torch.float64, requires_grad=True)
    out = head_t(tdiff.fwd_adjoint(make(torch))(pt, w))
    got = torch.autograd.grad(out, _leaves(pt) + [w])
    want = jax.grad(lambda q, ww: head_j(jdiff.fwd_adjoint(make(jnp))(q, ww)), argnums=(0, 1))(_j(p), jnp.asarray(_W))
    _close(got[:-1], want[0])
    # the extra argument gets a zero gradient, as in the reference
    assert float(got[-1]) == 0.0 == float(want[1])


@pytest.mark.parametrize("helper", ["value_and_grad_fwd", "grad_fwd", "torch_func_grad"])
def test_forward_helpers_match_jax(helper):
    f_t = lambda p, w: _f_dict(torch)(p, w)[:2].sum()  # noqa: E731
    f_j = lambda p, w: _f_dict(jnp)(p, w)[:2].sum()  # noqa: E731
    pt, w = _t(_P), torch.tensor(_W, dtype=torch.float64)
    want_val, want = jax.value_and_grad(f_j)(_j(_P), jnp.asarray(_W))
    if helper == "value_and_grad_fwd":
        val, got = tdiff.value_and_grad_fwd(f_t)(pt, w)
        np.testing.assert_allclose(float(val), float(want_val), rtol=1e-14)
    elif helper == "grad_fwd":
        got = tdiff.grad_fwd(f_t)(pt, w)
    else:
        # torch.func.grad composes with the wrapper
        got = torch.func.grad(lambda p: tdiff.fwd_adjoint(f_t)(p, w))(pt)
    assert sorted(got) == sorted(want)
    _close([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])


# --- the card's route, on CPU tensors --------------------------------------


def _small_loss(params):
    return _mean_redshift(params, n=2, r_obs=100.0, lam_max=300.0)


def _lift(monkeypatch, on: bool):
    """Traces under a transform take the card's route on the CPU too: the
    lifted trace, whose loops take the captured path, each CUDA graph
    replaced by a call of the work it would capture (or, ``on`` False, the
    plain route as the CPU takes it)."""
    if not on:
        monkeypatch.undo()
        return
    monkeypatch.setattr(tracing, "_lift_route", lambda device: True)
    monkeypatch.setattr(solver, "_graphed", lambda cf: True)
    monkeypatch.setattr(solver, "_graph_of", lambda warm_up, work, device, **info: SimpleNamespace(replay=work))


def test_lifted_trace_jvp_bits(monkeypatch):
    p = _params(0.6, 70.0)
    t = {"a": torch.tensor(1.0, **F64), "incl": torch.tensor(0.5, **F64)}
    _lift(monkeypatch, True)
    got = torch.func.jvp(_small_loss, (p,), (t,))
    _lift(monkeypatch, False)
    want = torch.func.jvp(_small_loss, (p,), (t,))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1]) != 0.0


def test_lifted_trace_jacfwd_bits(monkeypatch):
    """`jacfwd`: the two tangents ride in one pass of the loop."""
    p = _params(0.6, 70.0)
    _lift(monkeypatch, True)
    passes = []
    with solver.observe_loops(lambda e, **kw: passes.append(kw) if e == "loop" else None):
        got = torch.func.jacfwd(_small_loss)(p)
    assert [kw["tangent"] for kw in passes] == [False, True]
    _lift(monkeypatch, False)
    # the plain loop's jacfwd as `fwd_adjoint` runs it on the CPU: the bits
    # of `torch.func.jacfwd`, its constants lifted (utils/jvp.py)
    want = tdiff._jacfwd(lambda a, i: _small_loss({"a": a, "incl": i}), [p["a"], p["incl"]])
    want = dict(zip(p, want))
    for k in p:
        assert torch.equal(got[k], want[k])


def test_lifted_trace_refuses_an_unlifted_tensor(monkeypatch):
    """A tensor under the transform that the trace reads from a callable's
    closure raises, naming it."""
    _lift(monkeypatch, True)

    def loss(h):
        d = tgt.WarpedThinDisc(lambda r: h * torch.sin(r / 10.0), 0.0, 50.0, device="cpu")
        m = tgt.KerrMetric(1.0, 0.5, device="cpu")
        x = torch.tensor([0.0, 100.0, 1.2, 0.0], **F64)
        v = map_impact_parameters(m, x, torch.tensor([5.0], **F64), torch.tensor([1.0], **F64))
        return tgt.trace_geodesics(m, x.expand_as(v), v, (0.0, 300.0), geometry=d).x

    with pytest.raises(RuntimeError, match="geometry.*__closure__"):
        torch.func.jvp(loss, (torch.tensor(0.5, **F64),), (torch.tensor(1.0, **F64),))
