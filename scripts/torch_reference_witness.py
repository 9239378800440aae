"""Witnesses, on the CPU, of three properties that the port's traces show at
the flagship camera (Kerr a = 0.998, r = 1000, i = 75°, λ ≤ 2200), each
measured the same way in the JAX package and in the port, so that a
property of the reference is not taken for a fault of the port:

- ``iterations``: the lockstep iterations of one trace in f32 against f64
  (side² pixels of `chip_smoke.py`'s grid, with ThinDisc(0, 50) and
  without geometry). The JAX package's loop count is read from its
  ``lax.while_loop`` carry, the port's from `observe_loops`.
- ``first_order``: the first-order (Mino-time) tracer against the
  second-order one (ThinDisc(0, 50), f64, side² pixels, or the rays
  ``--rays`` gives): the relative gap of the hit radius and time, split at
  r = 3.8 (the smallest hit radius of tests/test_first_order.py's rays),
  in both packages on the same rays.
- ``mesh``: rays given by their impact parameters (``--rays``, a JSON list
  of [α, β]) traced in f32 through `chip_smoke.py`'s triangulated annulus
  (6 ≤ ρ ≤ 50, the phase's bounding box and proximity) and through
  ThinDisc(6, 50), in both packages: does the mesh miss where the disc
  hits? Also, for each ray, where its disc hit lies (ρ, φ) and how far it
  is from the nearest edge that two triangles share.

Prints one JSON line per part.

    python scripts/torch_reference_witness.py iterations [--side 24]
    python scripts/torch_reference_witness.py first_order [--side 64 | --rays '[[a, b], ...]']
    python scripts/torch_reference_witness.py mesh --rays '[[a, b], ...]' [--n-phi 64]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import MeshAccretionGeometry as JaxMesh  # noqa: E402
from gradus_tpu.integrate import solver as jax_solver  # noqa: E402
from gradus_tpu.metrics.kerr_first_order import KerrSpacetimeFirstOrder as JaxFO  # noqa: E402
from gradus_tpu.metrics.kerr_first_order import trace_geodesics_first_order as jax_fo_trace  # noqa: E402

from gradus_tpu_torch import metrics as tmetrics  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import MeshAccretionGeometry, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.integrate.solver import observe_loops  # noqa: E402

HIT = int(StatusCodes.IntersectedWithGeometry)
X_OBS = [0.0, 1000.0, math.radians(75.0), 0.0]
SPAN = (0.0, 2200.0)
torch.set_num_threads(2)


def _grid(side):
    """`chip_smoke.py`'s `_pixel_grid` at side² (α-major ravel), in f64."""
    a = np.linspace(-28.0, 28.0, side) + 1e-4
    b = np.linspace(-18.0, 18.0, side) + 1e-4
    return np.repeat(a, side), np.tile(b, side)


class _JaxLoops:
    """Counts the JAX package's lockstep iterations: wraps the solver's
    ``lax.while_loop`` and reads ``iters`` from its final carry."""

    def __enter__(self):
        self.iters, self._orig = [], jax_solver.lax

        def while_loop(cond, body, init):
            out = self._orig.while_loop(cond, body, init)
            if isinstance(out, dict) and "iters" in out:
                jax.debug.callback(lambda it: self.iters.append(int(it)), out["iters"])
            return out

        class _Lax:
            def __getattr__(_, name):
                return while_loop if name == "while_loop" else getattr(self._orig, name)

        jax_solver.lax = _Lax()
        return self

    def __exit__(self, *exc):
        jax_solver.lax = self._orig


class _PortLoops:
    def __enter__(self):
        self.iters = []

        def observer(event, **info):
            if event == "end":
                self.iters.append(int(info["iterations"]))

        self._cm = observe_loops(observer)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)


def _jax_rays(m, al, be, dtype):
    x = jnp.asarray(X_OBS, dtype)
    v = jax_map_impact(m, x, jnp.asarray(al, dtype), jnp.asarray(be, dtype))
    return jnp.broadcast_to(x, v.shape), v


def _port_rays(m, al, be, dtype):
    x = torch.tensor(X_OBS, dtype=dtype, device="cpu")
    v = map_impact_parameters(m, x, torch.as_tensor(al, dtype=dtype), torch.as_tensor(be, dtype=dtype))
    return x.expand_as(v), v


def part_iterations(side):
    al, be = _grid(side)
    out = {}
    for geo in ("disc", "none"):
        for name, jdt, tdt in (("f32", jnp.float32, torch.float32), ("f64", jnp.float64, torch.float64)):
            jm = jgt.KerrMetric(M=jnp.asarray(1.0, jdt), a=jnp.asarray(0.998, jdt))
            jd = jgt.ThinDisc(jnp.asarray(0.0, jdt), jnp.asarray(50.0, jdt)) if geo == "disc" else None
            with _JaxLoops() as jl:
                jgp = jgt.trace_geodesics(jm, *_jax_rays(jm, al, be, jdt), SPAN, geometry=jd)
                jax.block_until_ready(jgp.x)
            tm = tmetrics.KerrMetric(1.0, 0.998, dtype=tdt, device="cpu")
            td = ThinDisc(0.0, 50.0, dtype=tdt, device="cpu") if geo == "disc" else None
            with _PortLoops() as pl:
                tgp = trace_geodesics(tm, *_port_rays(tm, al, be, tdt), SPAN, geometry=td)
            js, ts = np.asarray(jgp.status), tgp.status.numpy()
            out[f"{geo}_{name}"] = dict(
                jax_iterations=jl.iters, port_iterations=pl.iters, status_agree=float((js == ts).mean())
            )
    print(json.dumps(dict(part="iterations", pixels=side * side, **out)), flush=True)


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def part_first_order(side, rays=None):
    al, be = _grid(side) if not rays else np.asarray(rays, float).T
    jfo, jad = JaxFO(M=1.0, a=0.998), jgt.KerrMetric(M=1.0, a=0.998)
    xs, v = _jax_rays(jad, al, be, jnp.float64)
    jd = jgt.ThinDisc(0.0, 50.0)
    j_so = jgt.trace_geodesics(jad, xs, v, SPAN, geometry=jd)
    j_fo = jax_fo_trace(jfo, xs, v, SPAN, geometry=jd)
    tfo = tmetrics.KerrSpacetimeFirstOrder(1.0, 0.998, device="cpu")
    tad = tmetrics.KerrMetric(1.0, 0.998, device="cpu")
    txs, tv = torch.as_tensor(np.array(xs)), torch.as_tensor(np.array(v))
    td = ThinDisc(0.0, 50.0, device="cpu")
    t_so = trace_geodesics(tad, txs, tv, SPAN, geometry=td)
    t_fo = tmetrics.trace_geodesics_first_order(tfo, txs, tv, SPAN, geometry=td)

    def gaps(so_s, so_x, fo_s, fo_x):
        so_s, so_x, fo_s, fo_x = map(np.asarray, (so_s, so_x, fo_s, fo_x))
        hit = (so_s == HIT) & (fo_s == HIT)
        g = np.maximum(_rel(fo_x[:, 1], so_x[:, 1]), _rel(fo_x[:, 0], so_x[:, 0]))
        near, far = hit & (so_x[:, 1] < 3.8), hit & (so_x[:, 1] >= 3.8)
        return dict(
            status_agree=float((so_s == fo_s).mean()), hits=int(hit.sum()),
            near=dict(hits=int(near.sum()), over_5e_3=int((g[near] > 5e-3).sum()),
                      gap_max=float(g[near].max()) if near.any() else None,
                      gap_median=float(np.median(g[near])) if near.any() else None),
            far=dict(hits=int(far.sum()), over_5e_3=int((g[far] > 5e-3).sum()),
                     gap_max=float(g[far].max()) if far.any() else None),
        ), g, near

    jres, jg, jnear = gaps(j_so.status, j_so.x, j_fo.status, j_fo.x)
    tres, tg, tnear = gaps(t_so.status, t_so.x, t_fo.status, t_fo.x)
    both = jnear & tnear
    r_so = np.asarray(j_so.x)[:, 1]
    order = np.argsort(r_so[both])
    rows = [dict(r_second_order=float(r_so[both][i]), jax_gap=float(jg[both][i]), port_gap=float(tg[both][i]))
            for i in order[:: max(len(order) // 12, 1)]]
    if rays:
        per_ray = [dict(alpha=float(al[i]), beta=float(be[i]), r_second_order=float(r_so[i]), jax_gap=float(jg[i]),
                        port_gap=float(tg[i])) for i in range(len(al))]
        print(json.dumps(dict(part="first_order", rays=len(al), jax=jres, port=tres, per_ray=per_ray)), flush=True)
        return
    print(json.dumps(dict(part="first_order", pixels=side * side, jax=jres, port=tres,
                          near_hole_same_rays=dict(rays=int(both.sum()),
                                                   gap_max_abs_diff=float(np.abs(jg[both] - tg[both]).max()) if both.any() else None,
                                                   by_radius=rows))), flush=True)


def part_mesh(rays, n_phi):
    al, be = np.asarray(rays, float).T
    import chip_smoke

    tri, lo, hi, prox = chip_smoke._mesh_args(n_phi).values()
    out = dict(part="mesh", rays=len(al), n_phi=n_phi, triangles=len(tri))
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32), ("f64", jnp.float64, torch.float64)):
        jm = jgt.KerrMetric(M=jnp.asarray(1.0, jdt), a=jnp.asarray(0.998, jdt))
        xs, v = _jax_rays(jm, al, be, jdt)
        jmesh = JaxMesh(triangles=jnp.asarray(tri, jdt), bbox_min=jnp.asarray(lo, jdt), bbox_max=jnp.asarray(hi, jdt),
                        proximity2=prox)
        j_mesh = jgt.trace_geodesics(jm, xs, v, SPAN, geometry=jmesh)
        j_disc = jgt.trace_geodesics(jm, xs, v, SPAN, geometry=jgt.ThinDisc(jnp.asarray(6.0, jdt), jnp.asarray(50.0, jdt)))
        tm = tmetrics.KerrMetric(1.0, 0.998, dtype=tdt, device="cpu")
        txs, tv = _port_rays(tm, al, be, tdt)
        tmesh = MeshAccretionGeometry(tri, lo, hi, prox, dtype=tdt, device="cpu")
        t_mesh = trace_geodesics(tm, txs, tv, SPAN, geometry=tmesh)
        t_disc = trace_geodesics(tm, txs, tv, SPAN, geometry=ThinDisc(6.0, 50.0, dtype=tdt, device="cpu"))
        jdx = np.asarray(j_disc.x, float)
        per_ray = []
        for i in range(len(al)):
            rho = float(jdx[i, 1] * math.sin(jdx[i, 2]))
            per_ray.append(dict(
                alpha=float(al[i]), beta=float(be[i]),
                jax=dict(mesh_hit=bool(j_mesh.status[i] == HIT), disc_hit=bool(j_disc.status[i] == HIT)),
                port=dict(mesh_hit=bool(t_mesh.status[i] == HIT), disc_hit=bool(t_disc.status[i] == HIT)),
                disc_rho=rho, disc_phi=float(jdx[i, 3]),
                shared_edge_distance=float(chip_smoke._shared_edge_distance(np.array(rho), np.array(jdx[i, 3]), n_phi)),
            ))
        out[name] = dict(
            jax_mesh_misses_disc_hits=sum(r["jax"]["disc_hit"] and not r["jax"]["mesh_hit"] for r in per_ray),
            port_mesh_misses_disc_hits=sum(r["port"]["disc_hit"] and not r["port"]["mesh_hit"] for r in per_ray),
            per_ray=per_ray,
        )
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("part", choices=("iterations", "first_order", "mesh"))
    ap.add_argument("--side", type=int, default=None)
    ap.add_argument("--rays", default="[]")
    ap.add_argument("--n-phi", type=int, default=64)
    a = ap.parse_args()
    if a.part == "iterations":
        part_iterations(a.side or 24)
    elif a.part == "first_order":
        part_first_order(a.side or 64, json.loads(a.rays))
    else:
        part_mesh(json.loads(a.rays), a.n_phi)


if __name__ == "__main__":
    main()
