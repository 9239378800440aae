"""The integrator kernel's traced-metric mode (a user's metric, whose
``components5`` or ``components5_jac`` `gradus_tpu_torch/metrics/codegen.py`
compiles into a generated unit), on the CPU through the host build of the
generated code (`opcount.host_metric_components`,
`opcount.host_callable_library`: g++, the C++ the card's nvcc compiles),
against the JAX package in f64:

- the generated class, value and (∂_r, ∂_θ) tangents on ``Dual2<double>``,
  of the docs' `EddingtonFinkelsteinAD` and a user's copy of
  `JohannsenPsaltisMetric`, against jax.jvp of the same metric written with
  jax.numpy; and a `KerrMetric` subclass, whose hand-derived
  ``components5_jac`` is traced, against the JAX package's;
- the generated kernel on 64 flagship rays against the JAX package's
  `PallasTracer(m, geometry=g, interpret=True)`, pinned in
  tests/data/traced_metric_reference.npz
  (scripts/torch_traced_metric_reference.py, which holds both packages'
  metrics), held as tests/test_torch_kernel_callables.py holds its cases;
  and the plain version against the same arrays;
- the refusals, which happen before any build or launch, the parameter
  slots, the parameters baked into the unit as literals (a branch on a
  parameter, the parameters past the slots), a PolishDoughnut of another
  metric class than the rays', and the build key.

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

from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch import _build, opcount  # noqa: E402
from gradus_tpu_torch import geometry as G  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes, cuda_solver  # noqa: E402
from gradus_tpu_torch.integrate.cuda_solver import (  # noqa: E402
    _check_kernel_config,
    _launch_kernel,
    _metric_args,
    _polish_plain,
    integrate_rays_plain,
)
from gradus_tpu_torch.metrics import JohannsenMetric, KerrMetric  # noqa: E402
from gradus_tpu_torch.metrics import codegen as metric_codegen  # noqa: E402
from gradus_tpu_torch.metrics.base import AbstractMetric  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_traced_metric_reference import BRANCH, JP, SERIES, jax_metric, torch_geometry, torch_metric  # noqa: E402

REFERENCE = np.load(ROOT / "tests" / "data" / "traced_metric_reference.npz")
SPECS = json.loads(str(REFERENCE["specs"]))
SPAN = (0.0, 2200.0)
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
HIT = StatusCodes.IntersectedWithGeometry
CPU = dict(device="cpu")
EF = ("EddingtonFinkelsteinAD", {"M": 1.0})
USER_JP = ("UserJohannsenPsaltis", JP)


class KerrSubclass(KerrMetric):
    """A user's subclass of a kernel metric: not the class itself, so it is
    traced, through Kerr's hand-derived ``components5_jac``."""


# --- the generated class against jax.jvp ----------------------------------------------

def _more_functions5(xp, M, r, theta):
    """Schwarzschild's components perturbed by the ops the reference's kernel
    was found to take beside the cross-sections' first ones (floor and sign
    carry no tangent; sign's kink at θ = 1), over ``xp``."""
    tt = -(1.0 - 2.0 * M / r) + 1e-3 * (xp.sinh(1.0 / r) + xp.cosh(theta) + xp.floor(r / 7.0) + xp.sign(theta - 1.0))
    rr = 1.0 / (1.0 - 2.0 * M / r) + 1e-3 * xp.arcsin(1.0 / r)
    pp = r * r * xp.sin(theta) ** 2 * (1.0 + 1e-3 * xp.arccos(0.5 * xp.cos(theta)))
    return (tt, rr, r * r, pp, xp.zeros_like(r))


class MoreFunctions(AbstractMetric):
    def __init__(self):
        super().__init__()
        self._register_params(torch.float64, "cpu", M=1.0)

    def components5(self, r, theta):
        return _more_functions5(torch, self.M, r, theta)


def _jax_more_functions():
    from gradus_tpu.metrics.base import AbstractMetric as JaxMetric
    from gradus_tpu.metrics.base import metric_dataclass

    @metric_dataclass
    class MoreFunctions(JaxMetric):
        M: float = 1.0

        def components5(self, r, theta):
            return _more_functions5(jnp, self.M, r, theta)

    return MoreFunctions()


# name: (the torch metric, the JAX package's)
METRICS = {
    "eddington_finkelstein": (lambda: torch_metric(EF, **CPU), lambda: jax_metric(EF)),
    "user_johannsen_psaltis": (lambda: torch_metric(USER_JP, **CPU), lambda: jax_metric(USER_JP)),
    "kerr_subclass": (lambda: KerrSubclass(1.0, 0.9, **CPU), lambda: JaxKerr(M=1.0, a=0.9)),
    "more_functions": (MoreFunctions, _jax_more_functions),
}
# from the horizon's neighbourhood to the far field, at both poles' sides
R = np.array([2.5, 3.0, 4.2, 6.0, 10.0, 30.0, 100.0, 1000.0])
TH = np.array([0.1, 0.3, 0.7, 1.0, math.pi / 2, 2.0, 2.6, 3.0])


@pytest.fixture(scope="module")
def host_components():
    """The three metrics' generated classes, one host build."""
    metrics = [make() for make, _ in METRICS.values()]
    return opcount.host_metric_components([metric_codegen.traced_metric(m) for m in metrics]), metrics


def _generated(host, k, m):
    """(values, ∂_r, ∂_θ, the double instantiation's values), each (5, n)."""
    _, M, a, q = _metric_args(m)
    out = np.zeros(20 * len(R))
    getattr(host, f"metric_{k}")(R.ctypes.data, TH.ctypes.data, len(R), M, a, np.array(list(q)).ctypes.data, out.ctypes.data)
    return out.reshape(4, 5, len(R))


def _stack(parts):
    return np.stack([np.broadcast_to(np.asarray(c), R.shape) for c in parts])


def _jvp(jm):
    """(values, ∂_r, ∂_θ) of the JAX metric's components5 by jax.jvp."""
    r, th = jnp.asarray(R), jnp.asarray(TH)
    one, zero = jnp.ones_like(r), jnp.zeros_like(r)
    g, dr = jax.jvp(jm.components5, (r, th), (one, zero))
    _, dth = jax.jvp(jm.components5, (r, th), (zero, one))
    return _stack(g), _stack(dr), _stack(dth)


def _within(got, want, rtol):
    """|got − want| ≤ rtol · max(1, |want|): at r = 1000 an r-derivative
    is a difference of ~1e-3 terms that cancel to ~1e-6."""
    return np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want))


@pytest.mark.parametrize("k, name", list(enumerate(METRICS)))
def test_generated_components_match_jax_jvp(host_components, k, name):
    """Value and (∂_r, ∂_θ) of the generated class against jax.jvp of the
    same metric in jax.numpy, within 1e-14 of max(1, |value|); its double
    instantiation's values the same bits. The Kerr subclass's traced
    ``components5_jac`` against the JAX package's (the same closed forms)
    at 1e-14 too, and against jax.jvp of Kerr's components5 at 1e-12 (a
    hand-derived Jacobian is not AD's rounding)."""
    host, metrics = host_components
    m, jm = metrics[k], METRICS[name][1]()
    got = _generated(host, k, m)
    np.testing.assert_array_equal(got[3], got[0])
    if name == "kerr_subclass":
        assert metric_codegen.traced_metric(m).method == "components5_jac"
        hand = [_stack(part) for part in jm.components5_jac(jnp.asarray(R), jnp.asarray(TH))]
        for mine, want in zip(got[:3], hand):
            assert _within(mine, want, 1e-14).all()
        rtol = 1e-12
    else:
        assert metric_codegen.traced_metric(m).method == "components5"
        rtol = 1e-14
    for what, mine, want in zip(("value", "d_r", "d_theta"), got[:3], _jvp(jm)):
        assert _within(mine, want, rtol).all(), (what, np.max(np.abs(mine - want) / np.maximum(1.0, np.abs(want))))


# --- the generated kernel and the plain version against the reference's --------------


@pytest.fixture(scope="module")
def host_kernel():
    """`_launch_kernel` on CPU tensors: `torch.cuda.device` and the current
    stream stubbed; each generated unit built for the host on its first
    launch, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        mp.setattr(torch.cuda, "current_stream", lambda d=None: type("Stream", (), {"cuda_stream": 0})())
        mp.setattr(_build, "_callable_libs", dict(_build._callable_libs))
        real = _build.load_callable_library

        def load(unit):
            key = _build.callable_key(unit.source)
            if key not in _build._callable_libs:
                _build._callable_libs[key] = opcount.host_callable_library(unit)
            return real(unit)

        mp.setattr(_build, "load_callable_library", load)
        yield


def _case(case):
    """(the torch metric, its geometry, the rays' x and v)."""
    spec = SPECS[case]
    m = torch_metric(spec["metric"], **CPU)
    geometry = torch_geometry(spec["geometry"], **CPU)
    x = torch.tensor(X_OBS, dtype=torch.float64)
    v = map_impact_parameters(m, x, torch.as_tensor(REFERENCE["alpha"]), torch.as_tensor(REFERENCE["beta"]))
    return m, geometry, x.expand_as(v), v


def _kernel_points(m, geometry, x, v, newton_iters):
    tracer = CudaTracer(m, geometry=geometry, newton_iters=newton_iters)
    y0 = tracer._constrain(x, v)
    kw = dict(tracer._integrate_kwargs(torch.float64), dt_min=1e-10, terminate_on_hit=True, iter_cap=None, state=None)
    before = cuda_solver.KERNEL_LAUNCHES
    out = _launch_kernel(m, y0, SPAN, geometry, kw)
    assert cuda_solver.KERNEL_LAUNCHES == before + 1
    return tracer._finish(out, y0, SPAN[0])


def _close(got, want, rtol=1e-9):
    return np.abs(got - want) <= rtol * np.maximum(1.0, np.abs(want))


def _held(case, gp, gp20):
    """Statuses identical to the reference's; polished hits within 1e-9
    relative to max(1, |value|): at the defaults against its batch, with 20
    Newton iterations against its rays alone."""
    status, x, lam = (REFERENCE[f"{case}/{k}"] for k in ("status", "x", "lam_max"))
    np.testing.assert_array_equal(gp.status.numpy(), status)
    hit = status == HIT
    assert hit.sum() >= 32
    agree = _close(gp.x.numpy(), x).all(-1) & _close(gp.lam_max.numpy(), lam)
    assert np.nonzero(hit & ~agree)[0].tolist() == OFF_BATCH[case]
    np.testing.assert_array_equal(gp20.status.numpy(), status)
    x_alone, lam_alone = REFERENCE[f"{case}/x_alone"], REFERENCE[f"{case}/lam_max_alone"]
    ok = _close(gp20.x.numpy(), x_alone).all(-1) & _close(gp20.lam_max.numpy(), lam_alone)
    assert ok[hit].all(), np.nonzero(hit & ~ok)[0].tolist()


# The rays whose hit at the defaults is not the reference batch's: the
# reference's dt fault moves its hit off the surface (ROADMAP C;
# tests/test_torch_kernel_geometries.py)
OFF_BATCH = {
    **{case: [] for case in SPECS},
    "kerr_johannsen_doughnut": [11, 25, 26, 58],
    "kerr_ef_doughnut": [11, 25, 26, 58],
    "ef_johannsen_doughnut": [26, 41, 57, 60],
    "jp_ef_doughnut": [25],
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_host_kernel_matches_pallas_tracer(host_kernel, case):
    """The generated kernel for the case's metric, at the tracer's defaults
    and with 20 Newton iterations, against the reference (`_held`)."""
    m, geometry, x, v = _case(case)
    _held(case, _kernel_points(m, geometry, x, v, 3), _kernel_points(m, geometry, x, v, 20))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_plain_version_matches_pallas_tracer(case):
    """The plain version (`integrate_rays_plain`, the metric's
    ``components5_jac`` by `_ad_components5_jac`'s dual numbers), one loop
    polished with 3 and with 20 Newton iterations, against the same
    arrays (`_held`)."""
    m, geometry, x, v = _case(case)
    tracer = CudaTracer(m, geometry=geometry)
    y0 = tracer._constrain(x, v)
    raw = integrate_rays_plain(m, y0, SPAN, **{**tracer._integrate_kwargs(torch.float64), "newton_iters": 0})
    gp, gp20 = (tracer._finish(_polish_plain(m, geometry, raw, n), y0, SPAN[0]) for n in (3, 20))
    _held(case, gp, gp20)


# --- what the kernel takes, what it refuses, the slots and the build key ---------------


class _Slots(AbstractMetric):
    """Parameters registered b, M, c, a: M and a by name, b and c in p.q in
    that order; ``unused`` is read by no component."""

    def __init__(self):
        super().__init__()
        self._register_params(torch.float64, "cpu", b=0.1, M=1.0, unused=7.0, c=0.2, a=0.3)

    def components5(self, r, theta):
        s = torch.sin(theta)
        return (-(1.0 - 2.0 * self.M / r) + self.b, 1.0 + self.c / r, r * r, (r * s) ** 2 + self.a, 0.0)


def test_parameters_are_runtime_slots():
    """M and a by name, the others in p.q in their registration order, from
    the metric's buffers at each launch: a kernel metric's exact class
    keeps its kind and its table; a subclass is traced."""
    m = _Slots()
    traced = metric_codegen.traced_metric(m)
    assert traced.slots == (("M", "p.M"), ("a", "p.a"), ("b", "p.q[0]"), ("c", "p.q[1]"))
    kind, M, a, q = _metric_args(m)
    assert (kind, M, a, list(q)) == (12, 1.0, 0.3, [0.1, 0.2, 0.0, 0.0, 0.0])
    m.M.fill_(2.0)
    assert _metric_args(m)[1] == 2.0
    assert "g[4] = S{T(0.0)};" in traced.source
    assert _metric_args(KerrMetric(1.0, 0.5, **CPU))[0] == 0
    assert cuda_solver._kernel_unit(KerrMetric(1.0, 0.5, **CPU), G.ThinDisc(**CPU), torch.float32) is None
    sub = cuda_solver._kernel_unit(KerrSubclass(1.0, 0.5, **CPU), G.ThinDisc(**CPU), torch.float32)
    assert sub.metric_kind == 12 and "JacRhs<gradus::generated::TracedMetric>" in sub.source


def test_traced_metric_takes_every_geometry():
    """One unit per (metric, cross-sections, dtype) runs every geometry
    kind: ThinDisc and a DatumPlane by the closed forms, the others by the
    generic instantiation (with the cross-sections' Policy for kinds 8-9),
    a PolishDoughnut of the traced metric reading its components."""
    m = torch_metric(USER_JP, **CPU)
    thin = cuda_solver._kernel_unit(m, G.ThinDisc(**CPU), torch.float64)
    for g in (None, G.DatumPlane(1.0, **CPU), G.ShakuraSunyaev(0.3, 0.05, 6.0, **CPU), G.PolishDoughnut(metric=m)):
        _check_kernel_config(m, g, torch.float64)
        assert cuda_solver._kernel_unit(m, g, torch.float64).source == thin.source
    assert "gradus::NoCallables" in thin.source and "launch_traced" in thin.source
    warped = cuda_solver._kernel_unit(m, G.WarpedThinDisc(lambda rho: 0.1 * rho, 0.0, 50.0, **CPU), torch.float64)
    assert "generated::CrossSections" in warped.source and metric_codegen.traced_metric(m).source in warped.source
    block = cuda_solver._geometry_args(G.PolishDoughnut(metric=m))[4]
    assert block[2 + 2 + 7 : 2 + 2 + 15] == [1.0, 1.0, 0.6, 2.0, 0.0, 0.0, 0.0, 0.0]


def test_doughnut_of_another_metric_class():
    """A PolishDoughnut whose metric is of another class than the rays'
    (or traces to another text) is taken, as the reference's kernel takes
    it (it evaluates that metric's own components): its isobars read that
    class, a library metric's or the traced metric's under a name of its
    own, selected by the part index; with the rays' own class the
    library's kernels (or the traced unit) run as before."""
    kerr, ef, jp = KerrMetric(1.0, 0.998, **CPU), torch_metric(EF, **CPU), torch_metric(USER_JP, **CPU)
    for m, other, cls in (
        (kerr, JohannsenMetric(1.0, 0.998, **CPU), "gradus::doughnut_h<DualRhs<Johannsen>>"),
        (kerr, ef, "gradus::doughnut_h<DualRhs<gradus::generated::Doughnut0>>"),
        (ef, JohannsenMetric(1.0, 0.998, **CPU), "gradus::doughnut_h<DualRhs<Johannsen>>"),
        (jp, ef, "gradus::doughnut_h<DualRhs<gradus::generated::Doughnut0>>"),
    ):
        _check_kernel_config(m, G.PolishDoughnut(metric=other), torch.float64)
        unit = cuda_solver._kernel_unit(m, G.PolishDoughnut(metric=other), torch.float64)
        assert f"case 0: return {cls}(v, rho);" in unit.source and "kDoughnuts = true" in unit.source
    # the same class: the library's kernel, or the traced metric's one unit
    assert cuda_solver._kernel_unit(kerr, G.PolishDoughnut(metric=KerrMetric(1.0, 0.5, **CPU)), torch.float64) is None
    assert "kDoughnuts" not in cuda_solver._kernel_unit(jp, G.PolishDoughnut(metric=torch_metric(USER_JP, **CPU)), torch.float64).source
    # one class a part: the composite's second part and a precessed third
    composite = G.CompositeGeometry(
        [G.ThinDisc(0.0, 5.0, **CPU), G.PolishDoughnut(metric=ef), G.PrecessingDisc(G.PolishDoughnut(metric=JohannsenMetric(**CPU)), 0.1, 0.2, **CPU)]
    )
    source = cuda_solver._kernel_unit(kerr, composite, torch.float32).source
    assert "case 1: return gradus::doughnut_h<DualRhs<gradus::generated::Doughnut1>>(v, rho);" in source
    assert "case 2: return gradus::doughnut_h<DualRhs<Johannsen>>(v, rho);" in source
    assert "launch_callable<float, gradus::Kerr, gradus::generated::CrossSections, 0>" in source


class _Branch(KerrMetric):
    def components5(self, r, theta):
        if self.a == 0:
            return super().components5(r, theta)
        return super().components5(r, theta)

    components5_jac = AbstractMetric.components5_jac


class _BranchOnR(AbstractMetric):
    def __init__(self):
        super().__init__()
        self._register_params(torch.float64, "cpu", M=1.0)

    def components5(self, r, theta):
        if (r > 3.0).all():
            return (-(1.0 - 2.0 * self.M / r), 1.0, r * r, r * r, 0.0)
        return (-1.0, 1.0, r * r, r * r, 0.0)


class _BranchOnTheta(_BranchOnR):
    def components5(self, r, theta):
        s = torch.sin(theta) if (theta < 1.0).all() else torch.cos(theta)
        return (-(1.0 - 2.0 * self.M / r), 1.0, r * r, (r * s) ** 2, 0.0)


class _OffList(AbstractMetric):
    def __init__(self):
        super().__init__()
        self._register_params(torch.float64, "cpu", M=1.0)

    def components5(self, r, theta):
        return (-(1.0 - 2.0 * self.M / r), torch.erf(r), r * r, r * r, 0.0)


class _Table(AbstractMetric):
    def __init__(self):
        super().__init__()
        self._register_params(torch.float64, "cpu", M=1.0)
        self.register_buffer("table", torch.linspace(0.0, 1.0, 11, dtype=torch.float64))

    def components5(self, r, theta):
        return (-(1.0 - 2.0 * self.M / r), 1.0 + self.table[3] / r, r * r, r * r, 0.0)


class _TooMany(AbstractMetric):
    def __init__(self):
        super().__init__()
        self._register_params(torch.float64, "cpu", M=1.0, **{f"p{k}": 0.1 * k for k in range(6)})

    def components5(self, r, theta):
        extra = self.p0 + self.p1 + self.p2 + self.p3 + self.p4 + self.p5
        return (-(1.0 - 2.0 * self.M / r), 1.0 + extra / r, r * r, r * r, 0.0)


_C0 = torch.tensor(0.5, dtype=torch.float64)


class _Captured(AbstractMetric):
    def components5(self, r, theta):
        return (-(1.0 - 2.0 / r), 1.0 + _C0 / r, r * r, r * r, 0.0)


class _NoComponents(AbstractMetric):
    pass


REFUSED = {
    "branch_on_r": (_BranchOnR, NotImplementedError, "a Python branch on r "),
    "op_off_the_whitelist": (_OffList, NotImplementedError, "erf"),
    "non_0d_parameter": (_Table, ValueError, r"parameter table is f64\[11\]"),
    "branch_on_theta": (_BranchOnTheta, NotImplementedError, "a Python branch on th "),
    "captured_tensor": (_Captured, ValueError, "captures tensors"),
    "no_components5": (_NoComponents, NotImplementedError, "defines no components5"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_before_any_build_or_launch(monkeypatch, name):
    """A Python branch on r or θ (named) and an op off the whitelist raise
    NotImplementedError; a parameter that is not 0-d and a captured tensor
    ValueError — from `_check_kernel_config` and from the launch, before
    any nvcc or g++ run or launch. (A branch on a parameter, and more
    parameters than the slots, the reference takes: they are literals,
    `test_parameters_read_as_numbers_are_literals`.)"""
    cls, error, match = REFUSED[name]
    monkeypatch.setattr(_build, "_run_nvcc", lambda *a, **k: pytest.fail("nvcc ran"))
    monkeypatch.setattr(opcount, "_gxx", lambda *a, **k: pytest.fail("g++ ran"))
    m = cls()
    with pytest.raises(error, match=match):
        _check_kernel_config(m, G.ThinDisc(**CPU), torch.float64)
    before = cuda_solver.KERNEL_LAUNCHES
    with pytest.raises(error, match=match):
        _launch_kernel(m, torch.zeros(4, 8, dtype=torch.float64), SPAN, None, {})
    assert cuda_solver.KERNEL_LAUNCHES == before


def test_parameters_read_as_numbers_are_literals():
    """A parameter a Python branch reads, and the parameters past the
    `Q_SLOTS` slots (in registration order), are literals of the unit, as
    the reference bakes every parameter (`PallasTracer._concretize`): the
    slots mark them with their text, `metric_slots` passes nothing for
    them, and a new value of one traces the metric again (the cache holds
    a metric while its literals keep their values)."""
    branch = _Branch(1.0, 0.5, **CPU)
    traced = metric_codegen.traced_metric(branch)
    assert traced.slots == (("M", "p.M"), ("a", "T(0.5)")) and traced.literals == (("a", "T(0.5)"),)
    assert _metric_args(branch)[1:3] == (1.0, 0.0)
    assert metric_codegen.traced_metric(branch) is traced
    branch.a.fill_(0.0)
    again = metric_codegen.traced_metric(branch)
    assert again is not traced and again.slots == (("M", "p.M"), ("a", "T(0.0)"))
    many = _TooMany()
    traced = metric_codegen.traced_metric(many)
    assert traced.slots == (("M", "p.M"),) + tuple((f"p{k}", f"p.q[{k}]") for k in range(5)) + (("p5", "T(0.5)"),)
    assert list(_metric_args(many)[3]) == [0.0, 0.1, 0.2, 0.30000000000000004, 0.4]
    assert "const T v" in traced.source and "T(0.5)" in traced.source
    _check_kernel_config(many, G.ThinDisc(**CPU), torch.float64)


def test_build_key():
    """M = 1 and M = 2 share a unit (the parameters are slots); another
    number in the text, another dtype or another cross-section make a new
    one."""

    def key(m, dtype=torch.float64, geometry=None):
        return _build.callable_key(cuda_solver._kernel_unit(m, geometry, dtype).source)

    ef1, ef2 = torch_metric(("EddingtonFinkelsteinAD", {"M": 1.0}), **CPU), torch_metric(("EddingtonFinkelsteinAD", {"M": 2.0}), **CPU)
    assert key(ef1) == key(ef2) and _metric_args(ef2)[1] == 2.0
    assert key(ef1, torch.float32) != key(ef1)
    assert key(ef1, geometry=G.ThickDisc(lambda rho: rho - 10.0, **CPU)) != key(ef1)

    class Scaled(type(ef1)):
        def components5(self, r, theta):
            tt = -(1.0 - 2.5 * self.M / r)
            return (tt, -1.0 / tt, r * r, r * r * torch.sin(theta) ** 2, torch.zeros_like(r))

    assert key(Scaled(**CPU)) != key(ef1) and "T(2.5)" in cuda_solver._kernel_unit(Scaled(**CPU), None, torch.float64).source
    # a slot parameter shares the unit; a literal one (read by a branch, or
    # past the slots) makes a new unit a value
    series = [torch_metric(("JohannsenSeries", {**SERIES, **change}), **CPU) for change in ({}, {"alpha13": 0.3}, {"alpha53": 0.07})]
    assert key(series[0]) == key(series[1]) and key(series[0]) != key(series[2])
    branch = [torch_metric(("BranchingMetric", {**BRANCH, **change}), **CPU) for change in ({}, {"a": 0.7}, {"s": 1.0}, {"s": 2.0})]
    assert key(branch[0]) == key(branch[1]) and len({key(b) for b in branch[1:]}) == 3


def test_chip_smoke_metrics_are_the_references():
    """chip_smoke.py writes its user metrics itself: their generated
    classes are this module's, so the reference's arrays and the counts of
    `scripts/torch_traced_metric_reference.py --opcount` hold for them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for mine, spec in (
        (chip_smoke.EddingtonFinkelsteinAD(**CPU), EF),
        (chip_smoke.UserJohannsenPsaltis(**JP, **CPU), USER_JP),
        (chip_smoke.BranchingMetric(**BRANCH, s=0.0, **CPU), SPECS["branch_s0"]["metric"]),
        (chip_smoke.BranchingMetric(**BRANCH, s=1.0, **CPU), SPECS["branch_s1"]["metric"]),
        (chip_smoke.JohannsenSeries(**SERIES, **CPU), SPECS["johannsen_series"]["metric"]),
    ):
        assert metric_codegen.traced_metric(mine).source == metric_codegen.traced_metric(torch_metric(spec, **CPU)).source
