"""Parity of the port's jvp offset solvers with the JAX reference's, in f64
on the CPU: `offset_workhorse` (Newton, redshift, visibility re-trace and the
|∂(α,β)/∂(ρ,g)| Jacobian from two forward-mode traces), `offset_probe` and
`offset_jacobian_at`, for a thin disc (the equatorial `DatumPlane`) and a
`ShakuraSunyaev` disc (one datum plane per radius, re-traced against the disc
itself; tests/test_torch_offset_workhorse_thick.py, a file of its own so that
the two cases run on two workers); and
tests/test_transfer.py::test_offset_solver_flat_and_kerr on the port.

Setup: Kerr a = 0.998, observer at r = 1000, i = 60°, 3 emission radii × 8
image-plane angles. The Newton starts from the flat-space ellipse of each
ring (the ``r_init`` of the f32 transfer functions) to keep the forward-mode
traces few; the probe starts from the workhorse's offsets.

The offsets and the redshifts are held at 5e-9 relative, not 1e-9: the two
packages' traces differ in their last bits (tests/test_torch_trace_geodesics.py),
and near the Newton's ``zero_atol`` (1e-7 in ρ) that decides whether a ray
takes one step more, which moves its offset within that tolerance (2.2e-9
relative measured on one ray of 24). A tighter ``zero_atol`` does not help:
at 1e-10 some rays never reach it and the Newton runs to its 30 iterations.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu.geometry.discs as jd  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.transfer import solvers as js  # noqa: E402

import gradus_tpu_torch.geometry.discs as td  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.transfer import solvers as ts  # noqa: E402
from gradus_tpu_torch.transfer.cunningham import disc_solver_tile  # noqa: E402

X_OBS = [0.0, 1000.0, math.radians(60.0), 0.0]
RADII = np.array([4.0, 8.0, 15.0])
N_ANGLES = 8
# XLA's CPU backend contracts a·b + c into fused multiply-adds, which moves
# the Newton's iterates by ~1e-9; the reference is compiled with its LLVM
# passes at level 0, which keeps the arithmetic as written.
_NO_FMA = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_NO_FMA)(*args)


def _rays():
    th = np.linspace(-math.pi / 2, 3 * math.pi / 2, N_ANGLES, endpoint=False) + 0.05
    RE, TH = np.meshgrid(RADII, th, indexing="ij")
    cos_i, sin2 = math.cos(X_OBS[2]), np.sin(TH) ** 2
    warm = RE * abs(cos_i) / np.sqrt(cos_i**2 * (1.0 - sin2) + sin2) + 1.0 + math.sin(X_OBS[2]) * np.maximum(np.sin(TH), 0.0)
    return RE.ravel(), TH.ravel(), warm.ravel()


def _discs(kind):
    """(JAX kwargs, port kwargs): the solver's disc, the Jacobian's and the
    visibility re-trace's."""
    if kind == "thin":
        return dict(d=jd.DatumPlane(0.0)), dict(d=td.DatumPlane(0.0, device="cpu"))
    jm, tm = JaxKerr(M=1.0, a=0.998), KerrMetric(1.0, 0.998, device="cpu")
    sj, st = jd.ShakuraSunyaev.from_metric(jm), td.ShakuraSunyaev.from_metric(tm)
    pj = jd.DatumPlane(jnp.repeat(sj.cross_section(jnp.asarray(RADII)), N_ANGLES))
    pt = disc_solver_tile(td.datumplane(st, torch.as_tensor(RADII)), N_ANGLES)
    return (
        dict(d=pj, jacobian_disc=sj, verify_disc=sj),
        dict(d=pt, jacobian_disc=st, verify_disc=st),
    )


def solve(kind):
    """Both packages' workhorse, probe and Jacobian on the same rays."""
    RE, TH, warm = _rays()
    kj, kt = _discs(kind)
    jm, tm = JaxKerr(M=1.0, a=0.998), KerrMetric(1.0, 0.998, device="cpu")
    xj, xt = jnp.asarray(X_OBS), torch.tensor(X_OBS, dtype=torch.float64)
    aj = dict(r_targets=jnp.asarray(RE), thetas=jnp.asarray(TH))
    at = dict(r_targets=torch.as_tensor(RE), thetas=torch.as_tensor(TH))
    dj, dt = kj.pop("d"), kt.pop("d")
    wj = _jit(lambda w: js.offset_workhorse(jm, xj, dj, **aj, r_init=w, return_r_off=True, **kj), jnp.asarray(warm))
    wt = ts.offset_workhorse(tm, xt, dt, **at, r_init=torch.as_tensor(warm), return_r_off=True, **kt)
    pj = _jit(lambda w: js.offset_probe(jm, xj, dj, **aj, r_init=w), wj[4])
    pt = ts.offset_probe(tm, xt, dt, **at, r_init=wt[4])
    cj = _jit(lambda r: js.offset_jacobian_at(jm, xj, dj, **aj, r_off=r, **kj), wj[4])
    ct = ts.offset_jacobian_at(tm, xt, dt, **at, r_off=wt[4], **kt)
    to_np = lambda out: [np.asarray(v) for v in out]  # noqa: E731
    return kind, to_np(wj), [v.numpy() for v in wt], to_np(pj), [v.numpy() for v in pt], to_np(cj), [v.numpy() for v in ct]


@pytest.fixture(scope="module", params=["thin"])
def solved(request):
    return solve(request.param)


def _check(got, want, ok, rtol):
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol)


def test_offset_workhorse_matches_jax(solved):
    """(g, J, t, ok, r_off, cond): ``ok`` identical; r_off and g at 5e-9,
    t at 1e-9, J at 1e-7 relative where ok."""
    kind, wj, wt, *_ = solved
    g, J, t, ok, r_off, cond = wt
    np.testing.assert_array_equal(ok, wj[3])
    assert ok.sum() >= (16 if kind == "thin" else 8)
    _check(r_off, wj[4], ok, 5e-9)
    _check(g, wj[0], ok, 5e-9)
    _check(t, wj[2], ok, 1e-9)
    _check(J, wj[1], ok, 1e-7)
    _check(cond, wj[5], ok, 1e-6)


def test_offset_probe_matches_jax(solved):
    """(r_off, g, t, ok) warm-started at the workhorse's offsets."""
    _, _, _, pj, pt, *_ = solved
    r_off, g, t, ok = pt
    np.testing.assert_array_equal(ok, pj[3])
    _check(r_off, pj[0], ok, 5e-9)
    _check(g, pj[1], ok, 5e-9)
    _check(t, pj[2], ok, 1e-9)


def test_offset_jacobian_at_matches_jax(solved):
    """(g, J, t, ok, cond) at the workhorse's offsets, no Newton."""
    *_, cj, ct = solved
    g, J, t, ok, cond = ct
    np.testing.assert_array_equal(ok, cj[3])
    _check(g, cj[0], ok, 1e-9)
    _check(J, cj[1], ok, 1e-7)
    _check(t, cj[2], ok, 1e-9)


def test_offset_solver_flat_and_kerr():
    """tests/test_transfer.py::test_offset_solver_flat_and_kerr on the port:
    Schwarzschild, r = 1000, i = 60°, DatumPlane(0); the offsets hit the
    requested emission radii to ~1e-7."""
    m = KerrMetric(1.0, 0.0, device="cpu")
    x = torch.tensor([0.0, 1000.0, math.radians(60.0), 0.0], dtype=torch.float64)
    r_targets = torch.tensor([6.0, 10.0, 20.0], dtype=torch.float64)
    thetas = torch.tensor([math.pi / 2, math.pi / 2, 0.3], dtype=torch.float64)
    r_off, gp, resid = ts.find_offset_for_radius(m, x, td.DatumPlane(0.0, device="cpu"), r_targets, thetas)
    assert torch.isfinite(r_off).all()
    assert (resid.abs() < 1e-6).all()
    rho = gp.x[:, 1] * torch.abs(torch.sin(gp.x[:, 2]))
    np.testing.assert_allclose(rho.numpy(), r_targets.numpy(), rtol=1e-6)
