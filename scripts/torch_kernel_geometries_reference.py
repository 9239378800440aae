"""The JAX package's integrator kernel against the geometries that the port's
CUDA kernel takes beside ThinDisc and DatumPlane, pinned for
tests/test_torch_kernel_geometries.py: `PallasTracer(KerrMetric(1, 0.998),
geometry=g, interpret=True)` on 64 flagship rays (r = 1000, i = 75°, λ ≤
2200, f64 on the CPU; image-plane offsets ρ ∈ [7.5, 15] at uniform angles
from seed 8, `_offsets`), for each geometry of `PINNED`, as the docs build
them (docs/examples.md, docs/getting-started.md).

Each case is traced twice: once as a user traces it (one batch, the
tracer's defaults), and once ray by ray with ``steps_per_check=1`` and
``newton_iters=20``. Alone in its tile, with no iteration after its end, a
ray keeps its hit step's ``dt``, which the batch's lockstep tile rewrites
after the ray has ended (the reference's ``dt`` fault, ROADMAP C; its
polish then misses the surface); and 20 Newton iterations converge where
the default 3 do not: from an event at θ = 1 − 2⁻²⁷, which the cubic
event gives when a step starts beyond an EllipticalDisc's semi-major axis,
where jax.jvp of its indicator is NaN (sqrt's tangent at 0).

Writes tests/data/kernel_geometries_reference.npz: the offsets ``alpha``
and ``beta``, ``specs`` (JSON: each case's geometry as the ``(kind,
params)`` pair `gradus_tpu_torch.interop.geometry_from_numpy` takes, and
its event method), and each case's ``status``, ``x`` and ``lam_max`` (the
batch) and ``x_alone`` and ``lam_max_alone`` (ray by ray).

    python scripts/torch_kernel_geometries_reference.py [--cases a,b] [--out PATH]

Each case takes 20–25 s on one core (a batch and 64 single rays, each
compiled once); the cases run one after another (~2.5 minutes).

``--callables`` traces the cases of `CALLABLE_CASES` instead, the discs
whose cross-section is a callable (tests/test_torch_kernel_callables.py),
and adds them to the file beside the others under ``callable_specs``: their
``f`` is a name of `CALLABLES`, which builds the same function from
jax.numpy or torch.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

N_RAYS = 64
SEED = 8
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
SPAN = (0.0, 2200.0)
KERR = ("KerrMetric", {"M": 1.0, "a": 0.998})
ELLIPSE = ("EllipticalDisc", {"inner_r": 0.0, "semi_major": 100.0, "semi_minor": 60.0})
DOUGHNUT = {"M": 1.0, "ell": 8.0, "r_cusp": 10.0, "inner_r": 0.0, "outer_r": math.inf, "z_max": 50.0}

# case: (geometry spec, event method); tests/test_torch_kernel_geometries.py
# traces ShakuraSunyaev's batch (and the composite) through the JAX package
# live, and reads its rays alone from here
PINNED = {
    "shakura_sunyaev": (("ShakuraSunyaev", "from_metric"), "cubic"),  # params filled in by `spec_numbers`
    "shakura_sunyaev_sampled": (("ShakuraSunyaev", "from_metric"), "sampled"),
    "elliptical": (ELLIPSE, "cubic"),
    "precessing_elliptical": (("PrecessingDisc", {"disc": ELLIPSE, "beta": math.radians(10.0), "gamma": math.radians(30.0)}), "cubic"),
    "precessing_thin": (
        ("PrecessingDisc", {"disc": ("ThinDisc", {"inner_r": 0.0, "outer_r": 50.0}), "beta": math.radians(20.0), "gamma": math.radians(30.0)}),
        "cubic",
    ),
    "doughnut": (("PolishDoughnut", {**DOUGHNUT, "metric": None}), "cubic"),
    "doughnut_kerr": (("PolishDoughnut", {**DOUGHNUT, "metric": KERR}), "cubic"),
}
# The cross-sections of the callable cases, by name: each built from an
# array module (jax.numpy or torch), so both packages trace the same function.
CALLABLES = {
    "warp_docs": lambda xp: lambda rho: 2.0 * xp.sin(rho / 10.0),  # docs/examples.md
    "thick_line": lambda xp: lambda rho: rho - 10.0,
}
CALLABLE_CASES = {
    "warped": (("WarpedThinDisc", {"f": "warp_docs", "inner_r": 0.0, "outer_r": 100.0}), "cubic"),
    "thick": (("ThickDisc", {"f": "thick_line", "inner_r": 0.0, "outer_r": math.inf}), "cubic"),
}
OUT = Path(__file__).resolve().parent.parent / "tests" / "data" / "kernel_geometries_reference.npz"


def offsets(n=N_RAYS, seed=SEED):
    """Image-plane offsets ρ ∈ [7.5, 15] at uniform angles: outside the
    critical curve, whose rays circle the photon orbit."""
    rng = np.random.default_rng(seed)
    rho, phi = rng.uniform(7.5, 15.0, n), rng.uniform(0.0, 2 * np.pi, n)
    return rho * np.cos(phi), rho * np.sin(phi)


def spec_numbers(spec):
    """``spec`` with ``ShakuraSunyaev.from_metric``'s numbers, from the JAX
    package (the parameters both packages then build from)."""
    import gradus_tpu.geometry as G
    from gradus_tpu.metrics import KerrMetric

    kind, params = spec
    if params != "from_metric":
        return spec
    d = G.ShakuraSunyaev.from_metric(KerrMetric(**KERR[1]))
    return kind, {k: float(getattr(d, k)) for k in ("mdot_over_edd", "inv_eta", "inner_r")}


def jax_geometry(spec, jm):
    """The JAX package's geometry of a ``(kind, params)`` spec."""
    import gradus_tpu.geometry as G
    from gradus_tpu.metrics import KerrMetric

    import jax.numpy as jnp

    kind, params = spec
    params = dict(params)
    if isinstance(params.get("f"), str):
        params["f"] = CALLABLES[params["f"]](jnp)
    if "disc" in params:
        params["disc"] = jax_geometry(params["disc"], jm)
    if "geometries" in params:
        params["geometries"] = tuple(jax_geometry(g, jm) for g in params["geometries"])
    if params.get("metric") is not None:
        params["metric"] = KerrMetric(**params["metric"][1])
    return getattr(G, kind)(**params)


def jax_trace(spec, event_method, alpha, beta, alone=False):
    """(status, x, lam_max) of `PallasTracer(..., interpret=True)`: one
    batch at the defaults, or ``alone``, ray by ray with
    ``steps_per_check=1`` and ``newton_iters=20``."""
    import jax.numpy as jnp

    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.integrate.pallas_solver import PallasTracer
    from gradus_tpu.metrics import KerrMetric

    jm = KerrMetric(**KERR[1])
    x = jnp.asarray(X_OBS)
    kw = dict(steps_per_check=1, newton_iters=20) if alone else {}
    tracer = PallasTracer(jm, geometry=jax_geometry(spec, jm), event_method=event_method, interpret=True, **kw)
    out = []
    for sl in [slice(i, i + 1) for i in range(len(alpha))] if alone else [slice(None)]:
        v = map_impact_parameters(jm, x, jnp.asarray(alpha[sl]), jnp.asarray(beta[sl]))
        gp = tracer(jnp.broadcast_to(x, v.shape), v, SPAN)
        out.append((np.asarray(gp.status), np.asarray(gp.x), np.asarray(gp.lam_max)))
    return tuple(np.concatenate(a) for a in zip(*out))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=None)
    ap.add_argument("--callables", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    cases = CALLABLE_CASES if args.callables else PINNED
    alpha, beta = offsets()
    arrays = dict(alpha=alpha, beta=beta)
    specs = {}
    if Path(args.out).exists():
        # the other group of cases stays as it is
        other = PINNED if args.callables else CALLABLE_CASES
        with np.load(args.out) as old:
            arrays = {k: old[k] for k in old.files if k.startswith(tuple(f"{c}/" for c in other))}
            arrays.update({k: old[k] for k in ("alpha", "beta", "specs" if args.callables else "callable_specs") if k in old.files})
        if arrays and not (np.array_equal(arrays["alpha"], alpha) and np.array_equal(arrays["beta"], beta)):
            raise AssertionError("the pinned file's rays are not these")
        arrays.update(alpha=alpha, beta=beta)
    for case in (args.cases or ",".join(cases)).split(","):
        spec, method = cases[case]
        spec = spec_numbers(spec)
        t0 = time.perf_counter()
        status, x, lam = jax_trace(spec, method, alpha, beta)
        status_alone, x_alone, lam_alone = jax_trace(spec, method, alpha, beta, alone=True)
        if not (status_alone == status).all():
            raise AssertionError(f"{case}: the rays alone end otherwise than in the batch")
        print(case, f"{time.perf_counter() - t0:.1f} s", np.bincount(status, minlength=4).tolist(), flush=True)
        specs[case] = dict(geometry=spec, event_method=method)
        arrays.update({f"{case}/status": status, f"{case}/x": x, f"{case}/lam_max": lam})
        arrays.update({f"{case}/x_alone": x_alone, f"{case}/lam_max_alone": lam_alone})
    if args.callables:
        arrays["callable_specs"] = json.dumps(specs)
    else:
        arrays["specs"] = json.dumps(specs)
    np.savez(args.out, **arrays)


if __name__ == "__main__":
    main()
