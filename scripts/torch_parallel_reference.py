"""The JAX package's side of tests/test_torch_parallel.py, computed once and
kept in `tests/data/jax_reference_parallel.npz`, so that the test runs the
port's side alone. It runs tests/test_parallel.py's six cases through
`gradus_tpu.parallel` on 8 virtual CPU devices in f64, with that test's
inputs, each compiled as the port's parity tests compile the reference
(`xla_backend_optimization_level=0`: XLA's CPU backend would contract
a·b + c into fused multiply-adds, which changes the step sequence of a
ray against the arithmetic as written, and so where a captured ray ends):

- `trace`: `sharded_trace` of 10 rays (status, x);
- `pallas`: `sharded_pallas_trace` of the interpret-mode `PallasTracer`
  on 20 rays (status, x, v);
- `render`: `sharded_render`'s 12 × 12 shadow image;
- `lineprofile`: `sharded_lineprofile` on a 16 × 16 polar plane (flux);
- `emissivity`: `sharded_emissivity` of the lamp post, 256 samples, 20
  bins (n, radii, eps, t);
- `gradient`: the psum'd hit-radius loss and its spin tangent by `jax.jvp`
  at a = 0.5;
- `psum`: Σ sin(x)·x over 24 points in [0.1, 2.4], psum'd: its value and
  tangent by `jax.jvp` and its gradient by `jax.grad` (the convention of
  the collectives' derivatives).

    python scripts/torch_parallel_reference.py

It prints the seconds each part took.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PATH = ROOT / "tests" / "data" / "jax_reference_parallel.npz"


def load():
    """The pinned arrays, as a dict of numpy arrays."""
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


def main():
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, str(ROOT))
    import gradus_tpu as gt
    from gradus_tpu.camera.grids import GeometricGrid
    from gradus_tpu.camera.impact import map_impact_parameters
    from gradus_tpu.camera.planes import PolarPlane
    from gradus_tpu.integrate.pallas_solver import PallasTracer
    from gradus_tpu.parallel import (
        ray_mesh,
        sharded_emissivity,
        sharded_lineprofile,
        sharded_pallas_trace,
        sharded_render,
        sharded_trace,
    )

    def no_fma(fn):
        """``fn()``, jitted without FMA contraction."""
        return jax.jit(fn).lower().compile({"xla_backend_optimization_level": 0})()

    assert ray_mesh().devices.size == 8
    m = gt.KerrMetric(M=1.0, a=0.9)
    x = jnp.array([0.0, 1000.0, np.deg2rad(60.0), 0.0])
    d = gt.ThinDisc(0.0, 50.0)
    out = {}

    t0 = time.perf_counter()
    v = map_impact_parameters(m, x, jnp.linspace(-10.0, 10.0, 10) + 1e-4, jnp.zeros(10) + 1e-4)
    gp = no_fma(lambda: sharded_trace(m, jnp.broadcast_to(x, v.shape), v, (0.0, 2200.0), geometry=d))
    out["trace_status"], out["trace_x"] = np.asarray(gp.status), np.asarray(gp.x)
    print(f"trace: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    al = jnp.linspace(-10.0, 10.0, 20) + 1e-3
    v = map_impact_parameters(m, x, al, jnp.full_like(al, 2.0))
    pt = PallasTracer(m, geometry=d, interpret=True)
    y0 = pt._constrain(jnp.broadcast_to(x, v.shape), v)
    gp = no_fma(lambda: sharded_pallas_trace(pt, y0, (0.0, 2200.0), mesh=ray_mesh()))
    out["pallas_status"], out["pallas_x"], out["pallas_v"] = (np.asarray(a) for a in (gp.status, gp.x, gp.v))
    print(f"pallas: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    kw = dict(image_width=12, image_height=12, alpha_lims=(-10.0, 10.0), beta_lims=(-10.0, 10.0), lam_max=2200.0)
    out["render"] = np.asarray(no_fma(lambda: sharded_render(m, x, **kw)[2]))
    print(f"render: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    plane = PolarPlane(GeometricGrid(), Nr=16, Ntheta=16, r_max=30.0)
    # lam_max is the default's 2·r_obs, given: the default converts a traced x[1]
    prof = no_fma(lambda: sharded_lineprofile(m, x, d, plane=plane, max_re=50.0, lam_max=2000.0)[1])
    out["lineprofile"] = np.asarray(prof)
    print(f"lineprofile: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    prof = no_fma(lambda: sharded_emissivity(m, d, gt.LampPostModel(), n_samples=256, n_bins=20))
    for k in ("n", "radii", "eps", "t"):
        out[f"emissivity_{k}"] = np.asarray(getattr(prof, k))
    print(f"emissivity: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    mesh = ray_mesh()
    dg = gt.ThinDisc(0.0, 30.0)
    xg = jnp.array([0.0, 100.0, np.deg2rad(70.0), 0.0])
    alphas, betas = jnp.linspace(4.0, 9.0, 8), jnp.zeros(8) + 1e-3

    def loss(a):
        mg = gt.KerrMetric(M=1.0, a=a)
        vg = map_impact_parameters(mg, xg, alphas, betas)

        def local(x_loc, v_loc):
            g = gt.trace_geodesics(mg, x_loc, v_loc, (0.0, 300.0), geometry=dg)
            hit = g.status == gt.StatusCodes.IntersectedWithGeometry
            return jax.lax.psum(jnp.sum(jnp.where(hit, g.x[..., 1], 0.0)), "rays")

        return jax.shard_map(local, mesh=mesh, in_specs=(P("rays"), P("rays")), out_specs=P())(
            jnp.broadcast_to(xg, vg.shape), vg
        )

    val, dval = no_fma(lambda: jax.jvp(loss, (jnp.asarray(0.5),), (jnp.ones(()),)))
    out["gradient_value"], out["gradient_tangent"] = np.asarray(val), np.asarray(dval)
    print(f"gradient: {time.perf_counter() - t0:.1f} s", flush=True)

    xs = jnp.linspace(0.1, 2.4, 24)
    psummed = jax.shard_map(
        lambda t: jax.lax.psum(jnp.sum(jnp.sin(t) * t), "rays"), mesh=mesh, in_specs=P("rays"), out_specs=P()
    )
    val, dval = no_fma(lambda: jax.jvp(psummed, (xs,), (jnp.ones_like(xs),)))
    out["psum_value"], out["psum_tangent"] = np.asarray(val), np.asarray(dval)
    out["psum_grad"] = np.asarray(no_fma(lambda: jax.grad(psummed)(xs)))
    np.savez(PATH, **out)
    print(f"wrote {PATH.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
