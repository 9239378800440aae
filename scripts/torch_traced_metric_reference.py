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
  scripts/torch_kernel_geometries_reference.py (Kerr a = 0.998's numbers).

Each case is traced twice, as that script traces its cases: one batch at
the tracer's defaults, and ray by ray with ``steps_per_check=1`` and
``newton_iters=20`` (no ``dt`` fault, ROADMAP C).

Writes tests/data/traced_metric_reference.npz: ``alpha``, ``beta``,
``specs`` (JSON: each case's metric and geometry) and each case's
``status``, ``x``, ``lam_max``, ``x_alone`` and ``lam_max_alone``.

    python scripts/torch_traced_metric_reference.py [--cases a,b] [--out PATH]

~1 minute a case on one core.

``--opcount`` prints instead the kernel's operations per ray start, per
attempted step and per polished hit for the torch metrics of this module
against ThinDisc(0, 50) at the flagship camera, for `UserJohannsenPsaltis`
against chip_smoke.py's ShakuraSunyaev disc (`from_metric` of Kerr a =
0.998, Ṁ = 0.3) there too, and for `EddingtonFinkelsteinAD` against
DatumPlane(0) at the transfer functions' camera (`gradus_tpu_torch.opcount` through each generated unit's host
build, 512 rays as its ``main`` draws them): `chip_smoke.py`'s
``KERNEL_OPS`` for its traced metrics, whose generated code
tests/test_torch_kernel_metrics.py holds to these metrics' (~30 s, needs
g++).

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
CASES = {
    "ef_thin": (("EddingtonFinkelsteinAD", {"M": 1.0}), THIN),
    "jp_thin": (("UserJohannsenPsaltis", JP), THIN),
    "jp_shakura_sunyaev": (("UserJohannsenPsaltis", JP), SHAKURA_SUNYAEV),
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


TORCH_METRICS = {"EddingtonFinkelsteinAD": EddingtonFinkelsteinAD, "UserJohannsenPsaltis": UserJohannsenPsaltis}


def torch_metric(spec, **kw):
    """The torch metric of a ``(class name, params)`` spec."""
    name, params = spec
    return TORCH_METRICS[name](**params, **kw)


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

    name, params = spec
    return {"EddingtonFinkelsteinAD": EddingtonFinkelsteinAD, "UserJohannsenPsaltis": UserJohannsenPsaltis}[name](**params)


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
    tracer = PallasTracer(jm, geometry=jax_geometry(geometry, jm), interpret=True, **kw)
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
    out = {}
    for name, spec, case in (
        ("traced_eddington_finkelstein", ef, thin),
        ("traced_user_johannsen_psaltis", jp, thin),
        ("traced_eddington_finkelstein_datum_plane", ef, plane),
        ("traced_user_johannsen_psaltis_shakura_sunyaev", jp, shakura_sunyaev),
    ):
        m, d = torch_metric(spec, device="cpu"), case["geometry"]
        y0 = opcount._rays(m, case["x_obs"], *case["ab"], CudaTracer(m, geometry=d, **case["tkw"]))
        out[name] = opcount.count(opcount.build(_kernel_unit(m, d, torch.float64)), m, d, y0, case["span"], **case["tkw"])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=None)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--opcount", action="store_true")
    args = ap.parse_args()
    if args.opcount:
        print(json.dumps(opcount_cases(), indent=1))
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
