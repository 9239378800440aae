"""The JAX package's integrator kernel with a user's metric, pinned for
tests/test_torch_kernel_metrics.py: `PallasTracer(m, geometry=g,
interpret=True)` (which inlines the metric's ``components5`` and its
jax.jvp into the kernel) on 64 flagship rays (r = 1000, i = 75°, λ ≤ 2200,
f64 on the CPU; the image-plane offsets of
scripts/torch_kernel_geometries_reference.py, seed 8) for each case of
`CASES`:

- ``ef_thin``: the docs' `EddingtonFinkelsteinAD` (docs/custom-metrics.md,
  M = 1) against ThinDisc(0, 50);
- ``jp_thin`` and ``jp_shakura_sunyaev``: a user's copy of
  `JohannsenPsaltisMetric`'s components (a = 0.6, ε₃ = 2) against
  ThinDisc(0, 50) and against the ShakuraSunyaev disc of
  scripts/torch_kernel_geometries_reference.py (Kerr a = 0.998's numbers);
- ``branch_s0`` and ``branch_s1``: `BranchingMetric`, whose components5
  branches on its parameter s (``if self.s == 0:``, Kerr's components,
  else Johannsen-Psaltis's), at a = 0.6 with s = 0, and with s = 1 and
  ε₃ = 2, against ThinDisc(0, 50);
- ``johannsen_series``: `JohannsenSeries`, Johannsen's metric with its
  series one order further (7 parameters besides M and a: more than the
  kernel's 5 slots), against ThinDisc(0, 50);
- a PolishDoughnut (the docs' ℓ = 8, r_cusp = 10) whose isobars read
  another metric class than the rays': ``kerr_johannsen_doughnut`` (Kerr
  a = 0.998 rays, `JohannsenMetric(1, 0.998)`'s isobars: two metrics of
  the library), ``kerr_ef_doughnut`` (`EddingtonFinkelsteinAD`'s),
  ``ef_johannsen_doughnut`` (the rays in `EddingtonFinkelsteinAD`) and
  ``jp_ef_doughnut`` (the rays in the JP copy, the isobars in
  `EddingtonFinkelsteinAD`).

Each case is traced twice, as that script traces its cases: one batch at
the tracer's defaults, and ray by ray with ``steps_per_check=1`` and
``newton_iters=20`` (no ``dt`` fault, ROADMAP C).

Writes tests/data/traced_metric_reference.npz: ``alpha``, ``beta``,
``specs`` (JSON: each case's metric and geometry) and each case's
``status``, ``x``, ``lam_max``, ``x_alone`` and ``lam_max_alone``.

    python scripts/torch_traced_metric_reference.py [--cases a,b] [--out PATH]

~1 minute a case on one core, the doughnuts longer (their isobars bisect
40 times an indicator call). Cases written to files of their own, to run
side by side, go into the pinned file with ``--merge A.npz,B.npz``.

``--opcount`` prints instead the kernel's operations per ray start, per
attempted step and per polished hit for the torch metrics of this module
against ThinDisc(0, 50) at the flagship camera, for `UserJohannsenPsaltis`
against chip_smoke.py's ShakuraSunyaev disc (`from_metric` of Kerr a =
0.998, Ṁ = 0.3) there too, for `EddingtonFinkelsteinAD` against
DatumPlane(0) at the transfer functions' camera, and for the cases
``branch_s0``, ``branch_s1``, ``johannsen_series``, ``kerr_ef_doughnut``
and ``jp_ef_doughnut`` (`gradus_tpu_torch.opcount` through each generated
unit's host build, 512 rays as its ``main`` draws them): `chip_smoke.py`'s
``KERNEL_OPS`` for its traced metrics, whose generated code
tests/test_torch_kernel_metrics.py holds to these metrics' (~1 minute,
needs g++).

The metrics are written twice, in torch (`torch_metric`, which the tests
and the counts read) and in jax.numpy (`jax_metric`), with the same
expressions.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_kernel_geometries_reference import N_RAYS, SPAN, X_OBS, offsets  # noqa: E402

from gradus_tpu_torch.metrics.base import AbstractMetric  # noqa: E402

# the parameters of (b): chip_smoke.py's JP
JP = dict(M=1.0, a=0.6, eps3=2.0)
THIN = ("ThinDisc", {"inner_r": 0.0, "outer_r": 50.0})
# ShakuraSunyaev.from_metric(KerrMetric(1, 0.998)) of the JAX package
# (scripts/torch_kernel_geometries_reference.py's `spec_numbers`)
SHAKURA_SUNYAEV = ("ShakuraSunyaev", "from_metric")
EF = ("EddingtonFinkelsteinAD", {"M": 1.0})
USER_JP = ("UserJohannsenPsaltis", JP)
KERR = ("KerrMetric", {"M": 1.0, "a": 0.998})
JOHANNSEN = ("JohannsenMetric", {"M": 1.0, "a": 0.998, "alpha13": 0.0, "alpha22": 0.0, "alpha52": 0.0, "eps3": 0.0})
# the branching metric at s = 0 (Kerr's components) and s = 1 (JP's)
BRANCH = dict(M=1.0, a=0.6, eps3=2.0)
# Johannsen's series one order further: α14, α23 and α53 past the library's
SERIES = dict(M=1.0, a=0.6, alpha13=0.2, alpha14=0.1, alpha22=0.1, alpha23=0.05, alpha52=0.1, alpha53=0.05, eps3=0.5)
# the docs' doughnut (ℓ = 8, r_cusp = 10), its isobars in ``metric``'s components
DOUGHNUT = {"M": 1.0, "ell": 8.0, "r_cusp": 10.0, "inner_r": 0.0, "outer_r": math.inf, "z_max": 50.0}


def doughnut(metric):
    return ("PolishDoughnut", {**DOUGHNUT, "metric": metric})


CASES = {
    "ef_thin": (EF, THIN),
    "jp_thin": (USER_JP, THIN),
    "jp_shakura_sunyaev": (USER_JP, SHAKURA_SUNYAEV),
    "branch_s0": (("BranchingMetric", {**BRANCH, "s": 0.0}), THIN),
    "branch_s1": (("BranchingMetric", {**BRANCH, "s": 1.0}), THIN),
    "johannsen_series": (("JohannsenSeries", SERIES), THIN),
    "kerr_johannsen_doughnut": (KERR, doughnut(JOHANNSEN)),
    "kerr_ef_doughnut": (KERR, doughnut(EF)),
    "ef_johannsen_doughnut": (EF, doughnut(JOHANNSEN)),
    "jp_ef_doughnut": (USER_JP, doughnut(EF)),
}
OUT = Path(__file__).resolve().parent.parent / "tests" / "data" / "traced_metric_reference.npz"


class EddingtonFinkelsteinAD(AbstractMetric):
    """docs/custom-metrics.md's example, written in torch."""

    def __init__(self, M=1.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M)

    def components5(self, r, theta):
        tt = -(1.0 - 2.0 * self.M / r)
        rr = -1.0 / tt
        hh = r * r
        pp = r * r * torch.sin(theta) ** 2
        tp = torch.zeros_like(r)
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        return 2.0 * self.M


class UserJohannsenPsaltis(AbstractMetric):
    """A user's copy of `JohannsenPsaltisMetric`'s components."""

    def __init__(self, M=1.0, a=0.0, eps3=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, eps3=eps3)

    def components5(self, r, theta):
        M, a = self.M, self.a
        sin2 = torch.sin(theta) ** 2
        sigma = r * r + a * a * (1.0 - sin2)
        h = self.eps3 * M**3 * r / sigma**2
        delta = r * r - 2.0 * M * r + a * a
        tt = -(1.0 + h) * (1.0 - 2.0 * M * r / sigma)
        rr = sigma * (1.0 + h) / (delta + a * a * sin2 * h)
        hh = sigma
        term1 = sin2 * (r * r + a * a + 2.0 * a * a * M * r * sin2 / sigma)
        term2 = h * a * a * (sigma + 2.0 * M * r) * sin2**2 / sigma
        pp = term1 + term2
        tp = -2.0 * a * M * r * sin2 * (1.0 + h) / sigma
        return (tt, rr, hh, pp, tp)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)


def kerr5(xp, M, a, r, theta):
    """Kerr's components (the port's `KerrMetric.components5`), over the
    array module ``xp`` (torch or jax.numpy)."""
    R = 2.0 * M
    sin2 = xp.sin(theta) ** 2
    sigma = r * r + a * a * (1.0 - sin2)
    gamma = sin2 * R * r * a
    return (-(1.0 - R * r / sigma), sigma / (r * r + a * a - R * r), sigma, sin2 * (r * r + a * a + gamma * a / sigma), -gamma / sigma)


def jp5(xp, M, a, eps3, r, theta):
    """Johannsen-Psaltis's components (`UserJohannsenPsaltis`'s), over ``xp``."""
    sin2 = xp.sin(theta) ** 2
    sigma = r * r + a * a * (1.0 - sin2)
    h = eps3 * M**3 * r / sigma**2
    delta = r * r - 2.0 * M * r + a * a
    tt = -(1.0 + h) * (1.0 - 2.0 * M * r / sigma)
    rr = sigma * (1.0 + h) / (delta + a * a * sin2 * h)
    pp = sin2 * (r * r + a * a + 2.0 * a * a * M * r * sin2 / sigma) + h * a * a * (sigma + 2.0 * M * r) * sin2**2 / sigma
    return (tt, rr, sigma, pp, -2.0 * a * M * r * sin2 * (1.0 + h) / sigma)


def johannsen_series5(xp, m, r, theta):
    """Johannsen's components (the port's `JohannsenMetric.components5`)
    with A1, A2 and A5 one order further, over ``xp``."""
    M, a = m.M, m.a
    A1 = 1.0 + m.alpha13 * (M / r) ** 3 + m.alpha14 * (M / r) ** 4
    A2 = 1.0 + m.alpha22 * (M / r) ** 2 + m.alpha23 * (M / r) ** 3
    A5 = 1.0 + m.alpha52 * (M / r) ** 2 + m.alpha53 * (M / r) ** 3
    f = m.eps3 * M**3 / r
    sin2 = xp.sin(theta) ** 2
    sigma = r * r + a * a * (1.0 - sin2) + f
    delta = r * r - 2.0 * M * r + a * a
    r2a2 = r * r + a * a
    denom = (r2a2 * A1 - a * a * A2 * sin2) ** 2
    tt = -sigma * (delta - a * a * A2 * A2 * sin2)
    pp = sigma * sin2 * (r2a2**2 * A1**2 - a * a * delta * sin2)
    tp = -a * sigma * sin2 * (r2a2 * A1 * A2 - delta)
    return (tt / denom, sigma / (delta * A5), sigma, pp / denom, tp / denom)


class BranchingMetric(AbstractMetric):
    """A user's metric that branches on its parameter s: Kerr's components
    where s = 0, Johannsen-Psaltis's (ε₃) otherwise."""

    def __init__(self, M=1.0, a=0.0, eps3=0.0, s=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._register_params(dtype, device, M=M, a=a, eps3=eps3, s=s)

    def components5(self, r, theta):
        if self.s == 0:
            return kerr5(torch, self.M, self.a, r, theta)
        return jp5(torch, self.M, self.a, self.eps3, r, theta)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)


class JohannsenSeries(AbstractMetric):
    """Johannsen's metric with A1, A2 and A5 one order further: seven
    parameters besides M and a, in this order."""

    def __init__(self, M=1.0, a=0.0, alpha13=0.0, alpha14=0.0, alpha22=0.0, alpha23=0.0, alpha52=0.0, alpha53=0.0, eps3=0.0,
                 *, dtype=torch.float64, device=None):  # fmt: skip
        super().__init__()
        self._register_params(
            dtype, device, M=M, a=a, alpha13=alpha13, alpha14=alpha14, alpha22=alpha22, alpha23=alpha23,
            alpha52=alpha52, alpha53=alpha53, eps3=eps3,
        )  # fmt: skip

    def components5(self, r, theta):
        return johannsen_series5(torch, self, r, theta)

    def inner_radius(self):
        return self.M + torch.sqrt(self.M**2 - self.a**2)


TORCH_METRICS = {
    "EddingtonFinkelsteinAD": EddingtonFinkelsteinAD,
    "UserJohannsenPsaltis": UserJohannsenPsaltis,
    "BranchingMetric": BranchingMetric,
    "JohannsenSeries": JohannsenSeries,
}


def torch_metric(spec, **kw):
    """The torch metric of a ``(class name, params)`` spec: a metric of
    this module, or of the port's library."""
    name, params = spec
    if name not in TORCH_METRICS:
        from gradus_tpu_torch.interop import from_numpy

        return from_numpy(name, params, **kw)
    return TORCH_METRICS[name](**params, **kw)


def torch_geometry(spec, **kw):
    """The port's geometry of a ``(kind, params)`` spec, a PolishDoughnut's
    ``metric`` a metric spec of `torch_metric`."""
    from gradus_tpu_torch.interop import geometry_from_numpy

    kind, params = spec
    if kind == "PolishDoughnut" and params.get("metric") is not None:
        from gradus_tpu_torch.geometry import PolishDoughnut

        numbers = {k: v for k, v in params.items() if k != "metric"}
        return PolishDoughnut(**numbers, metric=torch_metric(params["metric"], **kw), **kw)
    return geometry_from_numpy(kind, params, **kw)


def jax_metric(spec):
    """The same metric written for the JAX package (jax.numpy)."""
    import jax.numpy as jnp

    from gradus_tpu.metrics.base import AbstractMetric as JaxMetric
    from gradus_tpu.metrics.base import metric_dataclass

    @metric_dataclass
    class EddingtonFinkelsteinAD(JaxMetric):
        M: float = 1.0

        def components5(self, r, theta):
            tt = -(1.0 - 2.0 * self.M / r)
            rr = -1.0 / tt
            hh = r * r
            pp = r * r * jnp.sin(theta) ** 2
            tp = jnp.zeros_like(r)
            return (tt, rr, hh, pp, tp)

        def components(self, r, theta):
            r, theta = jnp.broadcast_arrays(jnp.asarray(r, jnp.result_type(r, theta, float)), theta)
            return jnp.stack(self.components5(r, theta), axis=-1)

        def inner_radius(self):
            return 2.0 * self.M

    @metric_dataclass
    class UserJohannsenPsaltis(JaxMetric):
        M: float = 1.0
        a: float = 0.0
        eps3: float = 0.0

        def components5(self, r, theta):
            M, a = self.M, self.a
            sin2 = jnp.sin(theta) ** 2
            sigma = r * r + a * a * (1.0 - sin2)
            h = self.eps3 * M**3 * r / sigma**2
            delta = r * r - 2.0 * M * r + a * a
            tt = -(1.0 + h) * (1.0 - 2.0 * M * r / sigma)
            rr = sigma * (1.0 + h) / (delta + a * a * sin2 * h)
            hh = sigma
            term1 = sin2 * (r * r + a * a + 2.0 * a * a * M * r * sin2 / sigma)
            term2 = h * a * a * (sigma + 2.0 * M * r) * sin2**2 / sigma
            pp = term1 + term2
            tp = -2.0 * a * M * r * sin2 * (1.0 + h) / sigma
            return (tt, rr, hh, pp, tp)

        def components(self, r, theta):
            r, theta = jnp.broadcast_arrays(jnp.asarray(r, jnp.result_type(r, theta, float)), theta)
            return jnp.stack(self.components5(r, theta), axis=-1)

        def inner_radius(self):
            return self.M + jnp.sqrt(self.M**2 - self.a**2)

    @metric_dataclass
    class BranchingMetric(JaxMetric):
        M: float = 1.0
        a: float = 0.0
        eps3: float = 0.0
        s: float = 0.0

        def components5(self, r, theta):
            if self.s == 0:
                return kerr5(jnp, self.M, self.a, r, theta)
            return jp5(jnp, self.M, self.a, self.eps3, r, theta)

        def components(self, r, theta):
            r, theta = jnp.broadcast_arrays(jnp.asarray(r, jnp.result_type(r, theta, float)), theta)
            return jnp.stack(self.components5(r, theta), axis=-1)

        def inner_radius(self):
            return self.M + jnp.sqrt(self.M**2 - self.a**2)

    @metric_dataclass
    class JohannsenSeries(JaxMetric):
        M: float = 1.0
        a: float = 0.0
        alpha13: float = 0.0
        alpha14: float = 0.0
        alpha22: float = 0.0
        alpha23: float = 0.0
        alpha52: float = 0.0
        alpha53: float = 0.0
        eps3: float = 0.0

        def components5(self, r, theta):
            return johannsen_series5(jnp, self, r, theta)

        def components(self, r, theta):
            r, theta = jnp.broadcast_arrays(jnp.asarray(r, jnp.result_type(r, theta, float)), theta)
            return jnp.stack(self.components5(r, theta), axis=-1)

        def inner_radius(self):
            return self.M + jnp.sqrt(self.M**2 - self.a**2)

    name, params = spec
    mine = {
        "EddingtonFinkelsteinAD": EddingtonFinkelsteinAD,
        "UserJohannsenPsaltis": UserJohannsenPsaltis,
        "BranchingMetric": BranchingMetric,
        "JohannsenSeries": JohannsenSeries,
    }
    if name not in mine:
        import gradus_tpu.metrics

        return getattr(gradus_tpu.metrics, name)(**params)
    return mine[name](**params)


def geometry_spec(spec):
    """``spec`` with ShakuraSunyaev.from_metric's numbers from the JAX package."""
    from torch_kernel_geometries_reference import spec_numbers

    return spec_numbers(spec)


def jax_trace(metric_spec, geometry, alpha, beta, alone=False):
    """(status, x, lam_max) of `PallasTracer(..., interpret=True)`: one
    batch at the defaults, or ``alone``, ray by ray with
    ``steps_per_check=1`` and ``newton_iters=20``."""
    import jax.numpy as jnp
    from torch_kernel_geometries_reference import jax_geometry

    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.integrate.pallas_solver import PallasTracer

    jm = jax_metric(metric_spec)
    x = jnp.asarray(X_OBS)
    kw = dict(steps_per_check=1, newton_iters=20) if alone else {}
    kind, params = geometry
    if kind == "PolishDoughnut" and params.get("metric") is not None:
        import gradus_tpu.geometry as G

        jg = G.PolishDoughnut(**{**params, "metric": jax_metric(params["metric"])})
    else:
        jg = jax_geometry(geometry, jm)
    tracer = PallasTracer(jm, geometry=jg, interpret=True, **kw)
    out = []
    for sl in [slice(i, i + 1) for i in range(len(alpha))] if alone else [slice(None)]:
        v = map_impact_parameters(jm, x, jnp.asarray(alpha[sl]), jnp.asarray(beta[sl]))
        gp = tracer(jnp.broadcast_to(x, v.shape), v, SPAN)
        out.append((np.asarray(gp.status), np.asarray(gp.x), np.asarray(gp.lam_max)))
    return tuple(np.concatenate(a) for a in zip(*out))


def opcount_cases(n=512):
    """{name: `opcount.count`} of the torch metrics against ThinDisc(0, 50)
    at the flagship camera, and of `EddingtonFinkelsteinAD` against
    DatumPlane(0) at the transfer functions' camera (i = 60°), as
    `opcount.main` draws its rays and counts `kerr_datum_plane`."""
    from gradus_tpu_torch import opcount
    from gradus_tpu_torch.geometry import DatumPlane, ThinDisc
    from gradus_tpu_torch.integrate.cuda_solver import CudaTracer, _kernel_unit

    rng = np.random.default_rng(0)
    alpha, beta = rng.uniform(-28.0, 28.0, n), rng.uniform(-18.0, 18.0, n)
    rho, th = rng.uniform(1.5, 60.0, n), rng.uniform(0.0, 2 * math.pi, n)
    ef, jp = ("EddingtonFinkelsteinAD", {"M": 1.0}), ("UserJohannsenPsaltis", JP)
    thin = dict(geometry=ThinDisc(0.0, 50.0, device="cpu"), x_obs=X_OBS, ab=(alpha, beta), span=SPAN, tkw={})
    plane = dict(
        geometry=DatumPlane(0.0, device="cpu"),
        x_obs=[0.0, 1000.0, math.radians(60.0), 0.0],
        ab=(rho * np.cos(th), rho * np.sin(th)),
        span=(0.0, 2000.0),
        tkw=dict(chart_outer=2000.0),
    )
    from torch_kernel_geometries_reference import KERR

    from gradus_tpu_torch.geometry import ShakuraSunyaev
    from gradus_tpu_torch.metrics import KerrMetric

    disc = ShakuraSunyaev.from_metric(KerrMetric(**KERR[1], device="cpu"), 0.3)
    shakura_sunyaev = dict(thin, geometry=ShakuraSunyaev(*(float(getattr(disc, k)) for k in ("mdot_over_edd", "inv_eta", "inner_r")), device="cpu"))
    ef_doughnut = dict(thin, geometry=torch_geometry(doughnut(EF), device="cpu"))
    out = {}
    for name, spec, case in (
        ("traced_eddington_finkelstein", ef, thin),
        ("traced_user_johannsen_psaltis", jp, thin),
        ("traced_eddington_finkelstein_datum_plane", ef, plane),
        ("traced_user_johannsen_psaltis_shakura_sunyaev", jp, shakura_sunyaev),
        ("traced_branch_s0", CASES["branch_s0"][0], thin),
        ("traced_branch_s1", CASES["branch_s1"][0], thin),
        ("traced_johannsen_series", CASES["johannsen_series"][0], thin),
        ("kerr_doughnut_ef", KERR, ef_doughnut),
        ("traced_jp_doughnut_ef", jp, ef_doughnut),
    ):
        m, d = torch_metric(spec, device="cpu"), case["geometry"]
        y0 = opcount._rays(m, case["x_obs"], *case["ab"], CudaTracer(m, geometry=d, **case["tkw"]))
        out[name] = opcount.count(opcount.build(_kernel_unit(m, d, torch.float64)), m, d, y0, case["span"], **case["tkw"])
    return out


def merge(paths, out):
    """Adds the cases of the files ``paths`` (written by this script for
    the same rays) to ``out``."""
    with np.load(out) as old:
        arrays = {k: old[k] for k in old.files}
    specs = json.loads(str(arrays.pop("specs")))
    for path in paths:
        with np.load(path) as new:
            if not (np.array_equal(new["alpha"], arrays["alpha"]) and np.array_equal(new["beta"], arrays["beta"])):
                raise AssertionError(f"{path}: its rays are not the pinned file's")
            specs.update(json.loads(str(new["specs"])))
            arrays.update({k: new[k] for k in new.files if "/" in k})
    arrays["specs"] = json.dumps(specs)
    np.savez(out, **arrays)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=None)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--opcount", action="store_true")
    ap.add_argument("--merge", default=None)
    args = ap.parse_args()
    if args.opcount:
        print(json.dumps(opcount_cases(), indent=1))
        return
    if args.merge:
        merge(args.merge.split(","), args.out)
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    alpha, beta = offsets(N_RAYS)
    arrays, specs = dict(alpha=alpha, beta=beta), {}
    if Path(args.out).exists():
        with np.load(args.out) as old:
            arrays.update({k: old[k] for k in old.files if k != "specs"})
            specs = json.loads(str(old["specs"]))
        if not (np.array_equal(arrays["alpha"], alpha) and np.array_equal(arrays["beta"], beta)):
            raise AssertionError("the pinned file's rays are not these")
    for case in (args.cases or ",".join(CASES)).split(","):
        metric, geometry = CASES[case]
        geometry = geometry_spec(geometry)
        t0 = time.perf_counter()
        status, x, lam = jax_trace(metric, geometry, alpha, beta)
        status_alone, x_alone, lam_alone = jax_trace(metric, geometry, alpha, beta, alone=True)
        if not (status_alone == status).all():
            raise AssertionError(f"{case}: the rays alone end otherwise than in the batch")
        print(case, f"{time.perf_counter() - t0:.1f} s", np.bincount(status, minlength=4).tolist(), flush=True)
        specs[case] = dict(metric=metric, geometry=geometry)
        arrays.update({f"{case}/status": status, f"{case}/x": x, f"{case}/lam_max": lam})
        arrays.update({f"{case}/x_alone": x_alone, f"{case}/lam_max_alone": lam_alone})
    arrays["specs"] = json.dumps(specs)
    np.savez(args.out, **arrays)


if __name__ == "__main__":
    main()
