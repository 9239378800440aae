"""The public API's tail (ROADMAP A14) against the JAX package, in f64 on the
CPU: the tetrads' LNRF frame and index gymnastics, the metric's free
functions, `convert_angles` and `metric_jacobian5`; and the top-level names
that the port exports beside the reference's."""

import math
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
import gradus_tpu.geodesics.equation as jeq  # noqa: E402
import gradus_tpu.geodesics.tetrads as jtet  # noqa: E402
import gradus_tpu.metrics.base as jbase  # noqa: E402
import gradus_tpu.metrics.kerr as jkerr  # noqa: E402

import gradus_tpu_torch as tgt  # noqa: E402
from gradus_tpu_torch import diff as tdiff  # noqa: E402
import gradus_tpu_torch.geodesics.equation as teq  # noqa: E402
import gradus_tpu_torch.geodesics.tetrads as ttet  # noqa: E402
import gradus_tpu_torch.metrics.base as tbase  # noqa: E402
import gradus_tpu_torch.metrics.kerr as tkerr  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-13
# (t, r, θ, φ) positions outside the horizon, and velocities there
X = np.array([[0.0, 4.0, 1.1, 0.3], [1.0, 12.5, 0.4, -2.0], [5.0, 60.0, 2.9, 1.0], [0.0, 2.2, math.pi / 2, 0.0]])
V = np.array([[1.0, 0.3, -0.01, 0.02], [2.0, -0.5, 0.004, 0.01], [1.5, 0.1, 0.001, -0.002], [3.0, -1.0, 0.05, 0.2]])
METRICS = {
    "kerr": (lambda: jgt.KerrMetric(M=1.0, a=0.998), lambda: tgt.KerrMetric(1.0, 0.998, device="cpu")),
    "johannsen_psaltis": (
        lambda: jgt.JohannsenPsaltisMetric(M=1.0, a=0.6, eps3=2.0),
        lambda: tgt.JohannsenPsaltisMetric(1.0, 0.6, 2.0, device="cpu"),
    ),
}


def _close(got, want, rtol=RTOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-300)


@pytest.fixture(params=sorted(METRICS))
def metrics(request):
    jm, tm = METRICS[request.param]
    return jm(), tm()


@pytest.mark.parametrize("name", ["lnrframe", "lnrframe_matrix"])
def test_lnrf_frame_matches_jax(metrics, name):
    jm, tm = metrics
    _close(getattr(ttet, name)(tm, torch.as_tensor(X)), getattr(jtet, name)(jm, jnp.asarray(X)))


def test_lnrf_frame_is_orthonormal(metrics):
    """g(e_a, e_b) = η_ab, the frame's defining property."""
    _, tm = metrics
    x = torch.as_tensor(X)
    g, e = tm.metric(x), ttet.lnrframe_matrix(tm, x)
    eta = torch.einsum("...ia,...ij,...jb->...ab", e, g, e)
    np.testing.assert_allclose(eta.numpy(), np.broadcast_to(np.diag([-1.0, 1.0, 1.0, 1.0]), eta.shape), atol=1e-12)


@pytest.mark.parametrize("name", ["lowerindices", "raiseindices"])
def test_index_maps_match_jax(metrics, name):
    jm, tm = metrics
    _close(getattr(ttet, name)(tm, torch.as_tensor(X), torch.as_tensor(V)), getattr(jtet, name)(jm, jnp.asarray(X), jnp.asarray(V)))
    # lowering then raising is the identity
    lowered = ttet.lowerindices(tm, torch.as_tensor(X), torch.as_tensor(V))
    np.testing.assert_allclose(ttet.raiseindices(tm, torch.as_tensor(X), lowered).numpy(), V, rtol=1e-12, atol=1e-15)


def test_metric_free_functions_match_jax(metrics):
    jm, tm = metrics
    x, rt = torch.as_tensor(X), torch.as_tensor(X[:, 1:3])
    _close(tbase.metric_components(tm, x), jbase.metric_components(jm, jnp.asarray(X)))
    _close(tbase.metric_components(tm, rt), jbase.metric_components(jm, jnp.asarray(X[:, 1:3])))
    _close(tbase.metric_4x4(tm, x), jbase.metric_4x4(jm, jnp.asarray(X)))
    _close(tbase.inverse_metric_components(tm, x), jbase.inverse_metric_components(jm, jnp.asarray(X)))
    comps = tbase.metric_components(tm, x)
    _close(tbase.inverse_metric_components(comps), jbase.inverse_metric_components(jbase.metric_components(jm, jnp.asarray(X))))
    _close(tbase.inner_radius(tm), jbase.inner_radius(jm))


def test_metric_jacobian5_matches_jax(metrics):
    """Kerr's hand-derived Jacobian and Johannsen-Psaltis's by forward mode."""
    jm, tm = metrics
    got = teq.metric_jacobian5(tm, torch.as_tensor(X[:, 1]), torch.as_tensor(X[:, 2]))
    want = jeq.metric_jacobian5(jm, jnp.asarray(X[:, 1]), jnp.asarray(X[:, 2]))
    _close(got, want, rtol=1e-12)
    # numbers broadcast as the reference's do
    _close(teq.metric_jacobian5(tm, 6.0, torch.as_tensor(X[:, 2])), jeq.metric_jacobian5(jm, 6.0, jnp.asarray(X[:, 2])), rtol=1e-12)


def test_convert_angles_matches_jax():
    rng = np.random.default_rng(3)
    a = 0.9
    r, th, ph = rng.uniform(2.0, 50.0, 16), rng.uniform(0.1, 3.0, 16), rng.uniform(-3.0, 3.0, 16)
    th_o, ph_o = math.radians(60.0), 0.2
    got = tkerr.convert_angles(a, torch.as_tensor(r), torch.as_tensor(th), torch.as_tensor(ph), th_o, ph_o)
    want = jkerr.convert_angles(a, jnp.asarray(r), jnp.asarray(th), jnp.asarray(ph), th_o, ph_o)
    _close(got, want)


def test_top_level_names():
    """The reference's top-level names all exist in the port, but
    `enable_x64`, which has no torch meaning; each new one is its
    submodule's object. (Submodules are left out: which of them are
    attributes of a package depends on what the process imported.)"""
    names = (n for n in dir(jgt) if not n.startswith("_") and not isinstance(getattr(jgt, n), types.ModuleType))
    missing = sorted(n for n in names if not hasattr(tgt, n))
    assert missing == ["enable_x64"]
    assert tgt.fwd_adjoint is tdiff.fwd_adjoint and tgt.grad_fwd is tdiff.grad_fwd
    assert tgt.Tracer is tgt.integrate.tracing.Tracer and tgt.save_npz is tgt.serialization.save_npz
    assert tgt.lnrframe is ttet.lnrframe and tgt.raiseindices is ttet.raiseindices
    assert tgt.metric_components is tbase.metric_components and tgt.inner_radius is tbase.inner_radius
    assert tgt.JohannsenPsaltisMetric is tgt.metrics.JohannsenPsaltisMetric


def test_documented_names_in_the_port():
    """tests/test_docs.py's `gt.<name>` set: the port lacks only
    `enable_x64` (no torch meaning)."""
    names = set()
    for doc in (ROOT / "docs").glob("*.md"):
        names |= set(re.findall(r"gt\.([A-Za-z_][A-Za-z0-9_]*)", doc.read_text()))
    assert sorted(n for n in names if not hasattr(tgt, n)) == ["enable_x64"]
