"""The arrival time of `refine_for_target` against the target's r, in the JAX
package or the port on the CPU (f64), at the setup of
tests/test_extended_corona.py::test_refine_for_target_differentiable: Kerr
a = 0.5, observer at r = 1000 and i = 45°, the target (r_c, h) = (3, 6)
± ε along r_c, three Gauss-Newton steps from one pattern-search seed.

It prints, as one JSON object: for each ε, the polished (α, β), the arrival
time t and the distance; the central difference (t(+ε) − t(−ε))/2ε; and
(α, β) after 1 to 6 Gauss-Newton steps at ε = 0. With ``--seed FILE``
(another run's output) the polish starts from that run's seed, and the
arrival time is also evaluated at that run's polished (α, β) for each ε
(`closest_approach`): so one package's arrival time can be read at the
other's impact parameters. With ``--steps`` it prints only the affine
parameters of the first eight saved states of the seed's ray (the dense
trace `refine_for_target` samples), which show where the two packages'
step sequences part.

    python scripts/torch_refine_fd_noise.py --package port --out build/fd/port.json
    python scripts/torch_refine_fd_noise.py --package jax --seed build/fd/port.json --out build/fd/jax.json
    python scripts/torch_refine_fd_noise.py --package jax --seed build/fd/port.json --steps --out build/fd/jax_steps.json

The port takes ~25 minutes on one core, the JAX package ~1 minute.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np

EPS = [0.005, 0.01, 0.02, 0.05, 0.1]
X_OBS = [0.0, 1000.0, math.radians(45.0), 0.0]
RH0 = (3.0, 6.0)


def _package(name):
    """(array constructor, Kerr a = 0.5, targets module) of one package."""
    if name == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        import gradus_tpu as gt
        from gradus_tpu.transfer import targets

        return jnp.asarray, gt.KerrMetric(M=1.0, a=0.5), targets
    import torch

    torch.set_num_threads(1)
    import gradus_tpu_torch as gt
    from gradus_tpu_torch.transfer import targets

    def array(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64))

    return array, gt.KerrMetric(1.0, 0.5, device="cpu"), targets


def saved_lambdas(package, seed):
    """The affine parameters of the first eight saved states of the ray
    from ``seed`` (α, β), as `refine_for_target` traces it."""
    array, m, targets = _package(package)
    x0 = array(X_OBS)
    if package == "jax":
        from gradus_tpu.camera.impact import map_impact_parameters
        from gradus_tpu.integrate.tracing import trace_geodesics_dense
    else:
        from gradus_tpu_torch.camera.impact import map_impact_parameters
        from gradus_tpu_torch.integrate.tracing import trace_geodesics_dense
    ab = array(seed)
    v = map_impact_parameters(m, x0, ab[0:1], ab[1:2])
    lam_max = 2.0 * X_OBS[1]
    _, _, lam, _ = trace_geodesics_dense(m, x0 + 0.0 * v, v, (0.0, lam_max), n_save=256, chart_outer=lam_max)
    return dict(package=package, seed=seed, saved_lambda=[float(v) for v in lam[0][:8]])


def run(package, seed_run=None):
    array, m, targets = _package(package)
    x0 = array(X_OBS)

    def target(e):
        r_c, h = RH0[0] + e, RH0[1]
        return array([math.hypot(r_c, h), math.atan2(r_c, h), 0.0])

    if seed_run is None:
        al, be, _, _ = targets.optimize_for_target(target(0.0), m, x0)
        seed = [float(al), float(be)]
    else:
        seed = seed_run["seed"]
    out = dict(package=package, seed=seed, polish={}, central_difference={}, gauss_newton_steps={})
    for e in [0.0] + [s * e for e in EPS for s in (1.0, -1.0)]:
        ab, t, d = targets.refine_for_target(target(e), m, x0, array(seed), iters=3)
        out["polish"][repr(e)] = dict(ab=[float(v) for v in ab], t=float(t), dist=float(d))
    for e in EPS:
        p, q = out["polish"][repr(e)]["t"], out["polish"][repr(-e)]["t"]
        out["central_difference"][repr(e)] = (p - q) / (2 * e)
    for it in range(1, 7):
        ab, t, _ = targets.refine_for_target(target(0.0), m, x0, array(seed), iters=it)
        out["gauss_newton_steps"][it] = dict(ab=[float(v) for v in ab], t=float(t))
    if seed_run is not None:
        # this package's arrival time at the other run's polished (α, β)
        at = {}
        for key, pol in seed_run["polish"].items():
            d, t, _ = targets.closest_approach(m, x0, array([pol["ab"][0]]), array([pol["ab"][1]]), target(float(key)))
            at[key] = dict(t=float(t[0]), dist=float(d[0]), other_t=pol["t"])
        out["at_other_polish"] = at
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--seed", metavar="FILE", help="another run's output: its seed and polished (α, β)")
    ap.add_argument("--steps", action="store_true", help="only the seed ray's first saved affine parameters")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    seed_run = None if args.seed is None else json.loads(Path(args.seed).read_text())
    if args.steps:
        res = saved_lambdas(args.package, seed_run["seed"])
    else:
        res = run(args.package, seed_run)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
