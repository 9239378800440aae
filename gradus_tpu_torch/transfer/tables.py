"""Precomputed transfer-function tables over (spin, inclination) and the
fittable line-profile model (counterpart of `gradus_tpu/transfer/tables.py`).

Reference: `CunninghamTransferGrid`/`CunninghamTransferTable`
(`src/transfer-functions/types.jl:14-118`), `make_transfer_function_table`
(cunningham-transfer-functions.jl:500-530) and the SpectralFitting adapter
`GradusSpectralModels.LineProfile`
(`lib/GradusSpectralModels/src/GradusSpectralModels.jl:5-67`).

The table stacks `TransferBranchGrid`s on an (a, θ_obs) lattice; queries
interpolate every grid quantity bilinearly, giving a differentiable line
model: flux(E; K, a, θ_obs, r_in, r_out, lineE).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from gradus_tpu_torch.config import default_device
from gradus_tpu_torch.transfer.cunningham import TransferBranchGrid, transferfunctions
from gradus_tpu_torch.transfer.integration import integrate_lineprofile

__all__ = [
    "CunninghamTransferTable",
    "make_transfer_function_table",
    "LineProfileModel",
]


def _lattice_index(grid, v):
    """(i, w): the cell [grid[i], grid[i+1]] holding v, clipped to the
    lattice, and v's clipped fractional position in it."""
    v = torch.as_tensor(v, dtype=grid.dtype, device=grid.device)
    i = torch.searchsorted(grid, v.reshape(1), right=True)[0] - 1
    i = torch.clamp(i, 0, grid.shape[0] - 2)
    w = torch.clamp((v - grid[i]) / torch.clamp(grid[i + 1] - grid[i], min=1e-12), 0.0, 1.0)
    return i, w


@dataclasses.dataclass(frozen=True)
class CunninghamTransferTable:
    """(a, θ) lattice of transfer grids; callable at (a, θ) → interpolated
    TransferBranchGrid."""

    a_grid: Any  # (Na,)
    theta_grid: Any  # (Nt,) degrees
    # stacked grid quantities: leading axes (Na, Nt)
    radii: Any  # (Na, Nt, nr)
    gmin: Any
    gmax: Any
    gstar: Any  # (Ng,)
    lower_f: Any  # (Na, Nt, nr, Ng)
    upper_f: Any
    lower_t: Any
    upper_t: Any

    def __repr__(self):
        # reference show method parity (transfer-functions/types.jl:164-174)
        ag, tg = self.a_grid, self.theta_grid
        return (
            "CunninghamTransferTable\n"
            f"  . a grid      : {ag.shape[0]} in ({float(ag.min()):.4g}, {float(ag.max()):.4g})\n"
            f"  . θ grid (°)  : {tg.shape[0]} in ({float(tg.min()):.4g}, {float(tg.max()):.4g})\n"
            f"  . radii × g✶  : {self.radii.shape[-1]} × {self.gstar.shape[0]}"
        )

    def __call__(self, a, theta) -> TransferBranchGrid:
        ia, wa = _lattice_index(self.a_grid, a)
        it, wt = _lattice_index(self.theta_grid, theta)

        def bilerp(q):
            return (
                q[ia, it] * (1 - wa) * (1 - wt)
                + q[ia + 1, it] * wa * (1 - wt)
                + q[ia, it + 1] * (1 - wa) * wt
                + q[ia + 1, it + 1] * wa * wt
            )

        return TransferBranchGrid(
            radii=bilerp(self.radii),
            gmin=bilerp(self.gmin),
            gmax=bilerp(self.gmax),
            gstar=self.gstar,
            lower_f=bilerp(self.lower_f),
            upper_f=bilerp(self.upper_f),
            lower_t=bilerp(self.lower_t),
            upper_t=bilerp(self.upper_t),
        )


def make_transfer_function_table(
    metric_cls,
    d,
    a_range,
    theta_range,
    *,
    r_max: float = 500.0,
    n_radii: int = 150,
    r_obs: float = 10000.0,
    verbose: bool = False,
    progress=None,
    dtype=torch.float64,
    device=None,
    **kwargs,
) -> CunninghamTransferTable:
    """Precompute grids over the (a, θ_obs[deg]) lattice (reference
    `make_transfer_function_table`). The metrics and observers are made in
    ``dtype`` on ``device`` (the card when None); ``kwargs`` go to `cunningham_transfer_function`
    (``backend="cuda"``, the finite-difference Newton on the CUDA
    integrator, is the faster of the two backends on the card)."""
    from gradus_tpu_torch.camera.grids import InverseGrid
    from gradus_tpu_torch.orbits.special_radii import isco as _isco

    kw = dict(dtype=dtype, device=default_device(device))
    a_range, theta_range = np.asarray(a_range), np.asarray(theta_range)
    grids = []
    for a in a_range:
        row = []
        for th in theta_range:
            m = metric_cls(M=1.0, a=float(a), **kw)
            x = torch.tensor([0.0, r_obs, math.radians(float(th)), 0.0], **kw)
            radii = InverseGrid()(float(_isco(m)) + 1e-2, r_max, n_radii, **kw)
            g = transferfunctions(m, x, d, radii=radii, **kwargs)
            if verbose:
                print(f"table: a={a}, theta={th} done")
            if progress is not None:
                progress(
                    dict(
                        done=len(grids) * len(theta_range) + len(row) + 1,
                        total=len(a_range) * len(theta_range),
                        a=float(a),
                        theta=float(th),
                    )
                )
            row.append(g)
        grids.append(row)

    def stack(attr):
        return torch.stack([torch.stack([getattr(g, attr) for g in row]) for row in grids])

    return CunninghamTransferTable(
        a_grid=torch.as_tensor(a_range, **kw),
        theta_grid=torch.as_tensor(theta_range, **kw),
        radii=stack("radii"),
        gmin=stack("gmin"),
        gmax=stack("gmax"),
        gstar=grids[0][0].gstar,
        lower_f=stack("lower_f"),
        upper_f=stack("upper_f"),
        lower_t=stack("lower_t"),
        upper_t=stack("upper_t"),
    )


def _powerlaw3(r):
    return r**-3.0


@dataclasses.dataclass
class LineProfileModel:
    """Fittable additive table model: relativistic Fe-Kα line (reference
    `GradusSpectralModels.LineProfile`). Parameters follow the reference:
    K (norm), a, θ_obs (deg), inner_r, outer_r, lineE (keV).

    Calling with an energy-bin domain returns the model flux, differentiable
    in the parameters."""

    table: CunninghamTransferTable
    emissivity: Any = dataclasses.field(default=None)
    K: float = 1.0
    a: float = 0.998
    theta_obs: float = 45.0
    inner_r: float = 1.0
    outer_r: float = 100.0
    lineE: float = 6.4

    def __call__(self, energies, **overrides):
        params = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        params.update(overrides)
        eps = self.emissivity or _powerlaw3
        grid = self.table(params["a"], params["theta_obs"])
        like = grid.radii[0]
        rmin = torch.maximum(torch.as_tensor(params["inner_r"]).to(like), like)
        rmax = torch.maximum(torch.as_tensor(params["outer_r"]).to(like), rmin)
        flux = integrate_lineprofile(
            eps,
            grid,
            energies,
            rmin=rmin,
            rmax=rmax,
            g_scale=params["lineE"],
        )
        return params["K"] * flux
