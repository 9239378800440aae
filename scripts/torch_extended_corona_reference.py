"""Reference values for `chip_smoke.py`'s extended-corona phases, from the JAX
package on the CPU in f64, at the phases' own configurations: Kerr
a = 0.998, ThinDisc(0, ∞), observer at r = 10⁴ and i = 45°;

- `ring`: the profile `lag_frequency(m, x, d, RingCorona(r=3, h=4))` builds
  at its defaults (`emissivity_profile`'s near-field hybrid: 20 slices ×
  256 angles, 16 golden-section steps; the adaptive sky at n0 = 24, 5
  rounds, at most 256 splits a round): ε at 12 radii through the near and
  far field, `time_limits_at` at 3 radii, the fan's branch counts, the
  adaptive sky's cells and its near-field nodes; and the continuum time t₀;
- `disc`: `emissivity_profile(m, d, DiscCorona(r=10, h=4))` at its
  defaults (10 rings × 20 × 256 fan rays in one trace): ε at 12 radii and
  `time_limits_at` at 3 radii.

The JAX package's `refine_for_target` is NaN for the ring's source (its ray
saves fewer than 256 states: ROADMAP C), which makes its t₀ 0. t₀ here comes
from the JAX package with `jax.nn.softmax`'s tangent masked where the weight
is 0 (the port's arithmetic); the unmasked value is recorded beside it.

With ``--package port`` the same values come from the port on the CPU.
``--part sky --package port`` traces the JAX package's final sky cells
through the port's `CoronaSkyTracer` in one trace and bins them into the
near-field nodes: the same cells on both sides, so no refinement decision
(the `argpartition` ties of `corona_adaptive_sky`) separates the values;
it counts the cells whose ray ends otherwise than the JAX package's (a
disc hit against the hemisphere's edge, by the last bits) and bins the
cells where both end alike with each package's values. Its values go to
the cells file too, for `chip_smoke.py` to hold the card's to.
``--merge`` writes, for each value, the JAX package's number, the port's,
their largest relative gap (for the ring's ε also split at r = 5.3 into
the near field, the adaptive sky's nodes, and the far field, the fan's)
and the tolerance the card is held to: ten times the gap, and at least
1e-9 where the two packages agree to rounding on the CPU (the card's
transcendental functions round otherwise). The two packages' sky cells
(centres, sizes, depths: the same numpy arithmetic in both, so a cell both
made is the same floats) go to `tests/data/extended_corona_sky_cells.npz`.

    python scripts/torch_extended_corona_reference.py --part ring --package jax --out build/ref/ring_jax.json
    python scripts/torch_extended_corona_reference.py --part ring --package port --out build/ref/ring_port.json
    (the same for --part disc; then, after the JAX package's ring)
    python scripts/torch_extended_corona_reference.py --part sky --package port --out build/ref/sky_port.json
    python scripts/torch_extended_corona_reference.py --merge build/ref --out tests/data/extended_corona_reference.json

Each part and package is one process, run the four together: on one core
a few minutes each (the ring: 163 s in the JAX package, 385 s in the port;
the disc: 84 s and 218 s). The sky part needs the JAX package's ring.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

A_SPIN = 0.998
X_OBS = [0.0, 1e4, math.radians(45.0), 0.0]
RING = dict(r=3.0, h=4.0)
DISC = dict(r=10.0, h=4.0)
EPS_RADII = {
    "ring": [1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0, 6.0, 10.0, 30.0, 100.0],
    "disc": [1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0, 16.0, 30.0, 100.0],
}
LIMIT_RADII = [4.0, 10.0, 30.0]
N0 = 24
# the ring's near field: the hybrid's adaptive-sky nodes reach r_ring + 1.8 + 0.5;
# ε beyond is the β-slice fan's alone
RING_NEAR_FIELD = 5.3
# the hybrid's near-field binning (`ring_corona_profile_hybrid`'s defaults)
NEAR_OUTER, N_R_NODES = 1.8, 24


CELL_FIELDS = ("cx", "cy", "w", "h", "depth")
# the per-cell values the near-field binning reads, and each ray's status
VALUE_FIELDS = ("r", "phi", "g", "gamma", "dr_dth", "dr_dph", "status")
SKY_CELLS = "extended_corona_sky_cells.npz"


def _save_cells(grid, out, vals=None):
    """The adaptive sky's final cells (and their values) beside the part's
    JSON."""
    arrays = {k: getattr(grid, k) for k in CELL_FIELDS}
    arrays.update({f"value_{k}": np.asarray(vals[k]) for k in VALUE_FIELDS} if vals is not None else {})
    np.savez(Path(out).with_suffix(".npz"), **arrays)


def _values(prof, part, as_array, to_list):
    eps = to_list(prof.emissivity_at(as_array(EPS_RADII[part])))
    limits = [[float(v) for v in prof.time_limits_at(as_array(r))] for r in LIMIT_RADII]
    return dict(eps=eps, time_limits=limits)


def _jax(part, out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import gradus_tpu as gt
    import gradus_tpu.corona.adaptive as adaptive

    m, d = gt.KerrMetric(M=1.0, a=A_SPIN), gt.ThinDisc(0.0, math.inf)
    x = jnp.asarray(X_OBS)
    out = {}
    if part == "ring":
        model = gt.RingCorona(**RING)
        skies = []
        sky = adaptive.corona_adaptive_sky
        adaptive.corona_adaptive_sky = lambda *a, **k: skies.append(sky(*a, **k)) or skies[-1]
        t0 = time.perf_counter()
        prof = gt.emissivity_profile(m, d, model)
        out["profile_seconds"] = time.perf_counter() - t0
        adaptive.corona_adaptive_sky = sky
        (grid, vals, n_traced), = skies
        _save_cells(grid, out_path, vals)
        out.update(cells=int(grid.cx.shape[0]), cells_traced=int(n_traced))
        out["near_field"] = dict(r_nodes=np.asarray(prof.r_nodes).tolist(), eps_nodes=np.asarray(prof.eps_nodes).tolist())
        out["branch_n"] = [np.asarray(prof.fan.left.n).tolist(), np.asarray(prof.fan.right.n).tolist()]
        out["continuum_time_unmasked"] = float(gt.continuum_time(m, x, model))
        plain = jax.nn.softmax

        @jax.custom_jvp
        def softmax(z):
            return plain(z)

        @softmax.defjvp
        def _jvp(primals, tangents):
            (z,), (z_dot,) = primals, tangents
            w = plain(z)
            z_dot = jnp.where(w > 0, z_dot, 0.0)
            return w, w * (z_dot - jnp.sum(w * z_dot))

        jax.nn.softmax = softmax
        try:
            out["continuum_time"] = float(gt.continuum_time(m, x, model))
        finally:
            jax.nn.softmax = plain
        al, be, _, _ = gt.optimize_for_target(jnp.asarray(model.sample_position_velocity(m)[0][1:4]), m, x)
        out["ring_ab"] = [float(al), float(be)]
    else:
        t0 = time.perf_counter()
        prof = gt.emissivity_profile(m, d, gt.DiscCorona(**DISC))
        out["profile_seconds"] = time.perf_counter() - t0
        out["branch_n"] = [np.asarray(prof.rings.left.n).tolist(), np.asarray(prof.rings.right.n).tolist()]
    out.update(_values(prof, part, jnp.asarray, lambda a: np.asarray(a).tolist()))
    return out


def _port(part, out_path):
    import torch

    torch.set_num_threads(1)
    import gradus_tpu_torch as gt
    import gradus_tpu_torch.corona.adaptive as adaptive

    m, d = gt.KerrMetric(1.0, A_SPIN, device="cpu"), gt.ThinDisc(0.0, math.inf, device="cpu")
    x = torch.tensor(X_OBS, dtype=torch.float64)
    out = {}
    if part == "ring":
        model = gt.RingCorona(**RING)
        skies = []
        sky = adaptive.corona_adaptive_sky
        adaptive.corona_adaptive_sky = lambda *a, **k: skies.append(sky(*a, **k)) or skies[-1]
        t0 = time.perf_counter()
        prof = gt.emissivity_profile(m, d, model)
        out["profile_seconds"] = time.perf_counter() - t0
        adaptive.corona_adaptive_sky = sky
        (grid, _, n_traced), = skies
        _save_cells(grid, out_path)
        out.update(cells=int(grid.cx.shape[0]), cells_traced=int(n_traced))
        out["near_field"] = dict(r_nodes=prof.r_nodes.tolist(), eps_nodes=prof.eps_nodes.tolist())
        out["branch_n"] = [prof.fan.left.n.tolist(), prof.fan.right.n.tolist()]
        out["continuum_time"] = float(gt.continuum_time(m, x, model))
    else:
        t0 = time.perf_counter()
        prof = gt.emissivity_profile(m, d, gt.DiscCorona(**DISC))
        out["profile_seconds"] = time.perf_counter() - t0
        out["branch_n"] = [prof.rings.left.n.tolist(), prof.rings.right.n.tolist()]

    def as_tensor(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64))

    out.update(_values(prof, part, as_tensor, lambda a: a.tolist()))
    return out


def _port_sky(folder):
    """The port's near-field nodes on the JAX package's final sky cells,
    traced in one trace on the CPU."""
    import torch

    torch.set_num_threads(1)
    import gradus_tpu_torch as gt
    from gradus_tpu_torch.corona.adaptive import CoronaSkyTracer
    from gradus_tpu_torch.corona.extended import _near_field_nodes

    m, d = gt.KerrMetric(1.0, A_SPIN, device="cpu"), gt.ThinDisc(0.0, math.inf, device="cpu")
    cells = np.load(Path(folder) / "ring_jax.npz")
    grid = SimpleNamespace(**{k: cells[k] for k in CELL_FIELDS})
    vals = CoronaSkyTracer(m, d, gt.RingCorona(**RING))(grid.cx, grid.cy)
    np.savez(Path(folder) / "sky_port.npz", **{k: vals[k] for k in VALUE_FIELDS})
    r, eps, covered = _near_field_nodes(m, RING["r"], grid, vals, gt.PowerLawSpectrum(2.0), NEAR_OUTER, N_R_NODES)
    # the JAX package's cells where its ray and the port's end alike, with
    # each package's values
    jax_vals = {k: cells[f"value_{k}"] for k in VALUE_FIELDS}
    same = jax_vals["status"] == vals["status"]
    sub = SimpleNamespace(**{k: v[same] for k, v in vars(grid).items()})
    spectrum = gt.PowerLawSpectrum(2.0)
    same_fate = {
        pkg: _near_field_nodes(m, RING["r"], sub, {k: v[same] for k, v in vs.items()}, spectrum, NEAR_OUTER, N_R_NODES)[1]
        for pkg, vs in (("jax", jax_vals), ("port", vals))
    }
    hit = same & np.isfinite(vals["r"])
    return dict(
        r_nodes=r.tolist(), eps_nodes=eps.tolist(), covered=covered.tolist(), cells=int(grid.cx.shape[0]),
        status_differing_from_jax=int((~same).sum()),
        value_gaps_from_jax={k: _rel_gap(jax_vals[k][hit], vals[k][hit]) for k in VALUE_FIELDS if k != "status"},
        same_fate_eps_nodes={pkg: v.tolist() for pkg, v in same_fate.items()},
    )


def _rel_gap(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-300)))


def _cell_set(cells):
    return set(zip(cells["depth"].tolist(), cells["cx"].tolist(), cells["cy"].tolist()))


def merge(folder, out):
    """tests/data/extended_corona_reference.json and the sky cells beside it
    from the five partial runs."""
    folder, out = Path(folder), Path(out)
    res = dict(
        source="scripts/torch_extended_corona_reference.py",
        config=dict(
            a=A_SPIN, x_obs=X_OBS, disc="ThinDisc(0, inf)", ring=RING, disc_corona=DISC, n0=N0,
            ring_near_field=RING_NEAR_FIELD, near_outer=NEAR_OUTER, n_r_nodes=N_R_NODES,
        ),
        eps_radii=EPS_RADII,
        limit_radii=LIMIT_RADII,
        sky_cells=SKY_CELLS,
    )
    for part in ("ring", "disc"):
        jx = json.loads((folder / f"{part}_jax.json").read_text())
        pt = json.loads((folder / f"{part}_port.json").read_text())
        gap = {k: _rel_gap(jx[k], pt[k]) for k in ["eps", "time_limits"] + (["continuum_time"] if part == "ring" else [])}
        if part == "ring":
            near = np.asarray(EPS_RADII["ring"]) <= RING_NEAR_FIELD
            gap["eps_near"] = _rel_gap(np.asarray(jx["eps"])[near], np.asarray(pt["eps"])[near])
            gap["eps_far"] = _rel_gap(np.asarray(jx["eps"])[~near], np.asarray(pt["eps"])[~near])
            # the near-field nodes on the JAX package's own cells, both
            # packages: the nodes the sky reached
            sky = json.loads((folder / "sky_port.json").read_text())
            covered = np.asarray(sky["covered"])
            gap["sky_nodes"] = _rel_gap(
                np.asarray(jx["near_field"]["eps_nodes"])[covered], np.asarray(sky["eps_nodes"])[covered]
            )
            same_fate = sky["same_fate_eps_nodes"]
            gap["sky_values"] = max(sky["value_gaps_from_jax"].values())
            gap["sky_nodes_same_fate"] = _rel_gap(
                np.asarray(same_fate["jax"])[covered], np.asarray(same_fate["port"])[covered]
            )
        entry = dict(jax=jx, port_cpu=pt, cpu_gap=gap)
        entry["rtol"] = {k: max(10.0 * g, 1e-9) for k, g in gap.items()}
        entry["cpu_branch_n_equal"] = jx["branch_n"] == pt["branch_n"]
        if part == "ring":
            entry["port_cpu_sky"] = sky
            cells = {pkg: np.load(folder / f"ring_{pkg}.npz") for pkg in ("jax", "port")}
            entry["cpu_cells_differing"] = len(_cell_set(cells["jax"]) ^ _cell_set(cells["port"]))
            sky_vals = np.load(folder / "sky_port.npz")
            np.savez_compressed(
                out.parent / SKY_CELLS,
                **{f"{pkg}_{k}": c[k] for pkg, c in cells.items() for k in CELL_FIELDS},
                **{f"port_sky_{k}": sky_vals[k] for k in VALUE_FIELDS},
            )
        res[part] = entry
    out.write_text(json.dumps(res, separators=(",", ":")) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("ring", "disc", "sky"))
    ap.add_argument("--package", choices=("jax", "port"))
    ap.add_argument("--merge", metavar="FOLDER")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if args.merge:
        merge(args.merge, args.out)
        return
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if args.part == "sky":
        res = _port_sky(Path(args.out).parent)
    else:
        res = (_jax if args.package == "jax" else _port)(args.part, args.out)
    res["seconds"] = time.perf_counter() - t0
    Path(args.out).write_text(json.dumps(res))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
