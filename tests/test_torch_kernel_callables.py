"""The integrator kernel's callable cross-sections (`WarpedThinDisc`,
`ThickDisc`: geometry kinds 8-9, `geometry/codegen.py`), on the CPU through
the host build of the generated code (`opcount.host_cross_sections`,
`opcount.host_callable_library`: g++, the C++ the card's nvcc compiles),
against the JAX package in f64:

- the generated device functions, value and forward-mode tangent, against
  jax.jvp of the same function written with jax.numpy, at ordinary points
  and at the kinks, where jax.jvp's rules are not torch's (|x| at 0, a tie
  of maximum/minimum/clip, the branch `where` takes);
- the generated kernel on 64 flagship rays against the JAX package's
  `PallasTracer(..., interpret=True)`, pinned with the other kernel
  geometries in tests/data/kernel_geometries_reference.npz
  (`scripts/torch_kernel_geometries_reference.py --callables`), held as
  tests/test_torch_kernel_geometries.py holds them;
- the refusals, which happen before any build or launch, and the build key.

The kernel itself is held to its plain version on the card by
tests/test_torch_cuda_kernel.py and chip_smoke.py.
"""

import contextlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gradus_tpu_torch import _build, opcount  # noqa: E402
from gradus_tpu_torch import geometry as G  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import codegen  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes, cuda_solver  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import _check_kernel_config, _geometry_args, _launch_kernel  # noqa: E402
from gradus_tpu_torch.interop import geometry_from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_kernel_geometries_reference import CALLABLES  # noqa: E402

REFERENCE = np.load(ROOT / "tests" / "data" / "kernel_geometries_reference.npz")
SPECS = json.loads(str(REFERENCE["callable_specs"]))
SPAN = (0.0, 2200.0)
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
HIT = StatusCodes.IntersectedWithGeometry
CPU = dict(device="cpu")


def _both(fn):
    """(the torch callable, the jax.numpy one) of ``fn(xp)``."""
    return fn(torch), fn(jnp)


# name: (torch callable, jax.numpy callable)
CROSS_SECTIONS = {
    # docs/examples.md and docs/getting-started.md
    "docs_warped": _both(lambda xp: lambda rho: 2.0 * xp.sin(rho / 10.0)),
    "docs_linear": _both(lambda xp: lambda rho: 0.05 * rho),
    # tests/test_torch_geometry.py's warped disc
    "lockstep": _both(lambda xp: lambda rho: 0.05 * rho * xp.sin(rho / 5.0)),
    "thick_line": _both(lambda xp: lambda rho: rho - 10.0),
    # where (switching at 6), pow of a number and of an int, exp, log, abs
    # (its kink at 8), clip
    "choices": (
        lambda rho: torch.clamp(
            torch.where(rho > 6.0, (rho - 6.0) ** 1.5, -((rho - 6.0) ** 2)) * torch.exp(-rho / 40.0)
            + torch.log(torch.abs(rho - 8.0) + 1.0),
            -3.0,
            4.0,
        ),
        lambda rho: jnp.clip(
            jnp.where(rho > 6.0, (rho - 6.0) ** 1.5, -((rho - 6.0) ** 2)) * jnp.exp(-rho / 40.0)
            + jnp.log(jnp.abs(rho - 8.0) + 1.0),
            -3.0,
            4.0,
        ),
    ),
    # ties of clip (10, 15), maximum (10) and minimum (12)
    "ties": (
        lambda rho: torch.clamp(rho - 10.0, min=0.0, max=5.0) + torch.maximum(rho, 20.0 - rho) + torch.minimum(rho, 24.0 - rho) ** 2,
        lambda rho: jnp.clip(rho - 10.0, 0.0, 5.0) + jnp.maximum(rho, 20.0 - rho) + jnp.minimum(rho, 24.0 - rho) ** 2,
    ),
    # the rest of the whitelist
    "functions": (
        lambda rho: torch.atan2(torch.tanh(rho / 30.0) + torch.atan(rho / 7.0), torch.reciprocal(torch.square(torch.rsqrt(rho))))
        + torch.tan(rho / 50.0)
        - torch.cos(rho) / torch.sqrt(rho)
        + 2.0 ** (-rho / 10.0)
        + rho ** (rho / 100.0),
        lambda rho: jnp.arctan2(jnp.tanh(rho / 30.0) + jnp.arctan(rho / 7.0), jnp.reciprocal(jnp.square(jax.lax.rsqrt(rho))))
        + jnp.tan(rho / 50.0)
        - jnp.cos(rho) / jnp.sqrt(rho)
        + 2.0 ** (-rho / 10.0)
        + rho ** (rho / 100.0),
    ),
    # the ops the reference's kernel was found to take beside those (floor
    # and sign carry no tangent; sign's kink at 8)
    "more_functions": (
        lambda rho: torch.sinh(rho / 50.0) * torch.cosh(rho / 40.0) + torch.asin(rho / 100.0) - torch.acos(rho / 120.0)
        + torch.floor(rho / 7.0) * torch.sign(rho - 8.0),
        lambda rho: jnp.sinh(rho / 50.0) * jnp.cosh(rho / 40.0) + jnp.arcsin(rho / 100.0) - jnp.arccos(rho / 120.0)
        + jnp.floor(rho / 7.0) * jnp.sign(rho - 8.0),
    ),
}
# ordinary points and the kinks (6, 8, 10, 12, 15), each with tangents of
# both signs
POINTS = np.repeat([3.0, 6.0, 7.3, 8.0, 10.0, 11.1, 12.0, 15.0, 25.0, 60.5, 99.0], 2)
TANGENTS = np.tile([0.7, -1.3], len(POINTS) // 2)


@pytest.fixture(scope="module")
def host_cross_sections():
    return opcount.host_cross_sections([f for f, _ in CROSS_SECTIONS.values()])


@pytest.mark.parametrize("k, name", list(enumerate(CROSS_SECTIONS)))
def test_generated_cross_sections_match_jax_jvp(host_cross_sections, k, name):
    """Value and tangent of the generated code (its ``Dual1<double>``
    instantiation) against jax.jvp at rtol 1e-14, and its ``double``
    instantiation's value the same bits."""
    x, t = POINTS.copy(), TANGENTS.copy()
    v, d, s = (np.zeros_like(x) for _ in range(3))
    getattr(host_cross_sections, f"cross_section_{k}")(x.ctypes.data, t.ctypes.data, len(x), v.ctypes.data, d.ctypes.data, s.ctypes.data)
    vj, dj = jax.jvp(CROSS_SECTIONS[name][1], (jnp.asarray(x),), (jnp.asarray(t),))
    np.testing.assert_allclose(v, np.asarray(vj), rtol=1e-14, atol=0)
    np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-14, atol=0)
    np.testing.assert_array_equal(s, v)


def test_kinks_take_jax_rules(host_cross_sections):
    """At the kinks the tangents are jax.jvp's, which torch's own differ
    from: a tie of maximum splits the tangent (torch.clamp gives it whole)."""
    k = list(CROSS_SECTIONS).index("ties")
    x, t = np.array([10.0]), np.array([1.0])
    v, d, s = (np.zeros(1) for _ in range(3))
    getattr(host_cross_sections, f"cross_section_{k}")(x.ctypes.data, t.ctypes.data, 1, v.ctypes.data, d.ctypes.data, s.ctypes.data)
    # clip's tie at 0: 1/2; maximum's tie: 1/2 - 1/2; minimum(10, 14)^2: 2 * 10
    assert d[0] == 0.5 + 0.0 + 20.0
    _, torch_d = torch.func.jvp(CROSS_SECTIONS["ties"][0], (torch.tensor(10.0, dtype=torch.float64),), (torch.tensor(1.0, dtype=torch.float64),))
    assert float(torch_d) != d[0]


# --- the generated kernel against the reference's ------------------------------------


@pytest.fixture
def host_kernel(monkeypatch):
    """`_launch_kernel` on CPU tensors: `torch.cuda.device` and the current
    stream stubbed; each generated unit built for the host on its first
    launch."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(_build, "_callable_libs", dict(_build._callable_libs))
    real = _build.load_callable_library

    def load(unit):
        key = _build.callable_key(unit.source)
        if key not in _build._callable_libs:
            _build._callable_libs[key] = opcount.host_callable_library(unit)
        return real(unit)

    monkeypatch.setattr(_build, "load_callable_library", load)


def _rays(m):
    x = torch.tensor(X_OBS, dtype=torch.float64)
    v = map_impact_parameters(m, x, torch.as_tensor(REFERENCE["alpha"]), torch.as_tensor(REFERENCE["beta"]))
    return x.expand_as(v), v


def _kernel_points(m, geometry, newton_iters):
    tracer = CudaTracer(m, geometry=geometry, newton_iters=newton_iters)
    x, v = _rays(m)
    y0 = tracer._constrain(x, v)
    kw = dict(tracer._integrate_kwargs(torch.float64), dt_min=1e-10, terminate_on_hit=True, iter_cap=None, state=None)
    before = cuda_solver.KERNEL_LAUNCHES
    out = _launch_kernel(m, y0, SPAN, geometry, kw)
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    return tracer._finish(out, y0, SPAN[0])


def _close(got, want, rtol=1e-9):
    return np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want))


# The rays whose hit at the defaults is not the reference batch's: the
# reference's dt fault moves its hit off the surface (ROADMAP C;
# tests/test_torch_kernel_geometries.py)
OFF_BATCH = {"warped": [], "thick": []}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_host_kernel_matches_pallas_tracer(host_kernel, case):
    """The generated kernel for the case's callable, at the tracer's
    defaults and with 20 Newton iterations, against the reference's batch
    and its rays traced alone with 20: statuses identical, polished hits
    within 1e-9 relative to max(1, |value|)."""
    kind, params = SPECS[case]["geometry"]
    geometry = geometry_from_numpy(kind, {**params, "f": CALLABLES[params["f"]](torch)}, **CPU)
    m = KerrMetric(1.0, 0.998, **CPU)
    status, x, lam = (REFERENCE[f"{case}/{k}"] for k in ("status", "x", "lam_max"))
    gp = _kernel_points(m, geometry, 3)
    np.testing.assert_array_equal(gp.status.numpy(), status)
    hit = status == HIT
    assert hit.sum() >= 32
    agree = _close(gp.x.numpy(), x).all(-1) & _close(gp.lam_max.numpy(), lam)
    assert np.nonzero(hit & ~agree)[0].tolist() == OFF_BATCH[case]
    gp20 = _kernel_points(m, geometry, 20)
    np.testing.assert_array_equal(gp20.status.numpy(), status)
    x_alone, lam_alone = REFERENCE[f"{case}/x_alone"], REFERENCE[f"{case}/lam_max_alone"]
    ok = _close(gp20.x.numpy(), x_alone).all(-1) & _close(gp20.lam_max.numpy(), lam_alone)
    assert ok[hit].all(), np.nonzero(hit & ~ok)[0].tolist()


# --- what the kernel takes, what it refuses, and the build key ----------------------


def test_kernel_takes_the_callable_geometries():
    """Kinds 8-9 alone, precessed and in a composite, and a precessed
    DatumPlane (kind 2 inside kind 6): `_check_kernel_config` takes them,
    and the block names each part's kind, its precessed kind and its
    cross-section's index in the generated Policy."""
    m = KerrMetric(1.0, 0.998, **CPU)
    warp = G.WarpedThinDisc(lambda rho: 2.0 * torch.sin(rho / 10.0), 0.0, 100.0, **CPU)
    thick = G.ThickDisc(lambda rho: 0.1 * rho - 2.0, **CPU)
    cases = {
        "warped": (warp, (8,), [0]),
        "thick": (thick, (9,), [0]),
        "precessed_warped": (G.PrecessingDisc(warp, 0.17, 0.5, **CPU), (6, 8), [0]),
        "composite": (G.CompositeGeometry([G.ThinDisc(0.0, 20.0, **CPU), thick]), (7, 1, 9), [1]),
        "precessed_datum": (G.PrecessingDisc(G.DatumPlane(1.0, **CPU), 0.1, 0.2, **CPU), (6, 2), []),
    }
    for name, (g, kinds, parts) in cases.items():
        for dtype in (torch.float64, torch.float32):
            _check_kernel_config(m, g, dtype)
        kind, _, _, _, block = _geometry_args(g)
        if kind == 7:
            assert (kind, int(block[2]), int(block[2 + 22])) == kinds, name
        elif kind == 6:
            assert (kind, int(block[3])) == kinds, name
        else:
            assert (kind,) == kinds, name
        assert [k for k, _ in codegen.callable_parts(g)] == parts, name
        unit = cuda_solver._kernel_unit(m, g, torch.float32)
        assert (unit is None) == (not parts), name
        if unit is not None:
            assert unit.entry == "geodesic_tsit5_f32" and "T(0.10000000000000001)" in unit.source or name != "composite"


def test_composite_block_of_any_part_count():
    """A composite's block is its kind and part count, then 22 values a part
    (kind, inner kind, 20 values): 2 + 6 · 22 for six parts, a precessed one
    and a callable one among them, whose cross-section the generated unit
    selects by its part index. A composite of up to four parts gives the
    kernel the values it read before the block was sized by the count
    (the two-part `composite` case of chip_smoke.py, written out)."""
    m = KerrMetric(1.0, 0.998, **CPU)
    warp = G.WarpedThinDisc(lambda rho: 2.0 * torch.sin(rho / 10.0), 60.0, 100.0, **CPU)
    tilted = G.PrecessingDisc(G.ThinDisc(40.0, 60.0, **CPU), 0.17, 0.5, **CPU)
    parts = [G.ThinDisc(r, r + 10.0, **CPU) for r in (0.0, 10.0, 20.0, 30.0)] + [tilted, warp]
    g = G.CompositeGeometry(parts)
    for dtype in (torch.float64, torch.float32):
        _check_kernel_config(m, g, dtype)
    kind, _, _, _, block = _geometry_args(g)
    assert kind == 7 and len(block) == 2 + 6 * 22 and block[:2] == [7.0, 6.0]
    part = [block[2 + 22 * k : 2 + 22 * (k + 1)] for k in range(6)]
    assert [(p[0], p[1]) for p in part] == [(1.0, 0.0)] * 4 + [(6.0, 1.0), (8.0, 0.0)]
    for k, r in enumerate((0.0, 10.0, 20.0, 30.0)):
        assert part[k][2:] == [r, r + 10.0] + [0.0] * 18
    assert part[4][2:4] == [40.0, 60.0] and part[4][4:19] == [0.0] * 15
    assert part[4][19:] == [math.cos(-0.17), math.sin(-0.17), 0.5]
    assert part[5][2:] == [60.0, 100.0] + [0.0] * 18
    assert [k for k, _ in codegen.callable_parts(g)] == [5]
    unit = cuda_solver._kernel_unit(m, g, torch.float64)
    assert "case 5: return h_5<T>(rho);" in unit.source and "case 4:" not in unit.source
    two = G.CompositeGeometry([G.ThinDisc(20.0, 100.0, **CPU), G.DatumPlane(3.0, **CPU)])
    assert _geometry_args(two)[4] == [7.0, 2.0, 1.0, 0.0, 20.0, 100.0] + [0.0] * 18 + [2.0, 0.0, 3.0] + [0.0] * 19
    with pytest.raises(NotImplementedError, match="one part or more"):
        _check_kernel_config(m, G.CompositeGeometry([]), torch.float64)


_TABLE = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
_C0 = torch.tensor(10.0, dtype=torch.float64)
REFUSED = {
    "unsupported_op": (lambda rho: torch.erf(rho) - 10.0, NotImplementedError, "erf"),
    "math_sin": (lambda rho: 2.0 * math.sin(rho / 10.0), NotImplementedError, "math.sin"),
    "python_branch": (lambda rho: rho - 10.0 if rho > 3.0 else -rho, NotImplementedError, "branch"),
    "captured_scalar": (lambda rho: rho - _C0, ValueError, r"captures constants \['f64\[\]'\]"),
    "captured_table": (lambda rho: _TABLE[torch.searchsorted(_TABLE, rho)], ValueError, r"captures constants \['f64\[11\]'"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_before_any_build_or_launch(monkeypatch, name):
    """An op off the whitelist, math.* of ρ and a Python branch on it raise
    NotImplementedError; a captured tensor, 0-d or a table, ValueError (the
    reference's own refusal) — from `_check_kernel_config` and from the
    launch, before any nvcc run or launch."""
    f, error, match = REFUSED[name]
    monkeypatch.setattr(_build, "_run_nvcc", lambda *a, **k: pytest.fail("nvcc ran"))
    m = KerrMetric(1.0, 0.998, **CPU)
    for g in (G.ThickDisc(f, **CPU), G.CompositeGeometry([G.ThinDisc(**CPU), G.WarpedThinDisc(f, 0.0, 100.0, **CPU)])):
        with pytest.raises(error, match=match):
            _check_kernel_config(m, g, torch.float64)
        before = cuda_solver.KERNEL_LAUNCHES
        with pytest.raises(error, match=match):
            _launch_kernel(m, torch.zeros(4, 8, dtype=torch.float64), SPAN, g, {})
        assert cuda_solver.KERNEL_LAUNCHES == before


def test_build_key():
    """The same text gives the same key (two callables written alike share
    one build), a different constant or dtype a new one; the headers are in
    the key."""
    m = KerrMetric(1.0, 0.998, **CPU)

    def unit(h, dtype=torch.float64):
        return cuda_solver._kernel_unit(m, G.ThickDisc(lambda rho: rho - h, **CPU), dtype)

    a, b = unit(10.0), unit(10.0)
    assert a.source == b.source and _build.callable_key(a.source) == _build.callable_key(b.source)
    assert _build.callable_key(unit(10.5).source) != _build.callable_key(a.source)
    assert _build.callable_key(unit(10.0, torch.float32).source) != _build.callable_key(a.source)
    assert "T(10.0)" in a.source and "T(10.5)" in unit(10.5).source
