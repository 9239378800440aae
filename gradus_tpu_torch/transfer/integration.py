"""Line-profile and lag-transfer integration over transfer-function
branches (counterpart of `gradus_tpu/transfer/integration.py`;
`integrate_lagtransfer_timedep`, which needs the extended coronae's
light curves, waits for ROADMAP queue A, item 9, second half).

Reference: `src/transfer-functions/integration.jl`. The flux in energy bin
[g_lo, g_hi] from an annulus at rₑ is

    ∫ S(g) dg,   S(g) = I(rₑ, g) · f(g✶) · g / √(g✶(1−g✶)),

with I(r, g) = g² for line profiles, integrated with fixed-order
Gauss-Legendre plus analytic √-edge handling within h of the branch extrema
(`integrate_bin`, :161-200), and an annulus weight Δrₑ·rₑ·ε(rₑ)·π/(gmax−gmin)
(:356). All (fine radius, energy bin, quadrature node) combinations evaluate
at once; the radial accumulation is an elementwise product and a sum.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.grids import GeometricGrid, InverseGrid
from gradus_tpu_torch.transfer.cunningham import TransferBranchGrid, _interval_index
from gradus_tpu_torch.utils.quadrature import gauss_legendre

__all__ = ["integrate_lineprofile", "integrate_lagtransfer"]


def _branch_value(grid_rows, gstar_axis, gstar_q):
    """Interpolate branch rows (nf, Ng) at query g✶ (nf, K)."""
    idx = _interval_index(gstar_axis, gstar_q)
    x0 = gstar_axis[idx]
    x1 = gstar_axis[idx + 1]
    w = torch.clamp((gstar_q - x0) / (x1 - x0), 0.0, 1.0)
    v0 = torch.gather(grid_rows, -1, idx)
    v1 = torch.gather(grid_rows, -1, idx + 1)
    return v0 * (1 - w) + v1 * w


def _make_S_both(branches, gstar_axis, gmin, gmax):
    """S(g) per fine radius: (nf, K) g-values → (nf, K) integrand values,
    summing both branches (reference `_both_branches`, integration.jl:124-146)."""

    def S(gvals):
        gstar = (gvals - gmin[:, None]) / (gmax - gmin)[:, None]
        # dtype-aware interior clip: a fixed 1 − 1e-12 rounds to exactly 1.0 in
        # float32, sending 1/√(g✶(1−g✶)) to ∞ at the edge nodes
        lo = max(1e-12, 4 * torch.finfo(gvals.dtype).eps)
        gstar_c = torch.clamp(gstar, lo, 1.0 - lo)
        fl = _branch_value(branches["lower_f"], gstar_axis, gstar_c)
        fu = _branch_value(branches["upper_f"], gstar_axis, gstar_c)
        f = torch.nan_to_num(fl) + torch.nan_to_num(fu)
        return gvals**3 * f / torch.sqrt(gstar_c * (1.0 - gstar_c))

    return S


def _integrate_bins(S, g_grid, gmin, gmax, h, quad):
    """Vectorised `integrate_bin` over (nf radii, nb bins).

    Returns (nf, nb) bin integrals (without the annulus weight)."""
    Xq, Wq = quad
    glo_raw = g_grid[None, :-1]
    ghi_raw = g_grid[None, 1:]
    gmin_ = gmin[:, None]
    gmax_ = gmax[:, None]
    glo = torch.minimum(torch.maximum(glo_raw, gmin_), gmax_)
    ghi = torch.minimum(torch.maximum(ghi_raw, gmin_), gmax_)
    empty = glo >= ghi

    span = gmax_ - gmin_
    gstar_lo = (glo_raw - gmin_) / span
    gstar_hi = (ghi_raw - gmin_) / span

    # --- √-edge corrections ---------------------------------------------
    def edge(lim_g, lim_gstar):
        gh = lim_gstar * span + gmin_
        Sgh = S(gh)
        return Sgh * torch.abs(torch.sqrt(gh) - torch.sqrt(lim_g)) * math.sqrt(h)

    lo_edge = gstar_lo < h
    hi_edge = gstar_hi > 1.0 - h
    edge_lo_lim = torch.clamp(gstar_hi, max=h)
    edge_hi_lim = torch.clamp(gstar_lo, min=1.0 - h)
    E_lo = torch.where(lo_edge, edge(glo, edge_lo_lim), 0.0)
    E_hi = torch.where(hi_edge, edge(ghi, edge_hi_lim), 0.0)

    glo_eff = torch.where(lo_edge, h * span + gmin_, glo)
    ghi_eff = torch.where(hi_edge, (1.0 - h) * span + gmin_, ghi)
    has_interior = ghi_eff > glo_eff

    # --- Gauss-Legendre interior ------------------------------------------
    q = (ghi_eff - glo_eff) / 2.0
    mid = (ghi_eff + glo_eff) / 2.0
    total = torch.zeros_like(glo)
    for xi, wi in zip(Xq.tolist(), Wq.tolist()):
        total = total + wi * S(mid + q * xi)
    interior = torch.where(has_interior, total * q, 0.0)

    return torch.where(empty, 0.0, E_lo + E_hi + interior)


def _normalize_flux(flux, g_grid):
    """flux[i] /= (g[i]+g[i+1]); flux /= Σ (reference `_normalize!`,
    utils.jl:121-132)."""
    gbar = g_grid[:-1] + g_grid[1:]
    flux = flux / gbar
    total = flux.sum()
    return torch.where(total > 0, flux / total, flux)


def integrate_lineprofile(
    emissivity,
    tfs: TransferBranchGrid,
    g_grid,
    *,
    h: float = 2e-8,
    n_radii: int = 1000,
    quadrature_points: int = 7,
    rmin=None,
    rmax=None,
    g_scale: float = 1.0,
    normalize: bool = True,
):
    """Integrate a line profile over the transfer-function table.

    emissivity: callable ε(r) (reference default r⁻³) or a tensor
    broadcastable over radii. Returns flux with len(g_grid) entries (last = 0,
    as in the reference's output layout)."""
    if not isinstance(g_grid, torch.Tensor):
        g_grid = torch.as_tensor(g_grid, dtype=torch.float64, device=tfs.radii.device)
    rmin = tfs.inner_radius() if rmin is None else rmin
    rmax = tfs.outer_radius() if rmax is None else rmax

    # dtype-aware edge width: the f64 default h = 2e-8 is below float32's
    # g✶ resolution, degenerating the analytic √-edge handling
    h = max(h, 8.0 * torch.finfo(g_grid.dtype).eps)

    r_fine = InverseGrid()(rmin, rmax, n_radii, dtype=tfs.radii.dtype, device=tfs.radii.device)
    rmin = r_fine.new_tensor(rmin) if not isinstance(rmin, torch.Tensor) else rmin.to(r_fine)
    dr = torch.diff(r_fine, prepend=(rmin - (r_fine[1] - rmin)).reshape(1))
    br = tfs.at_radius(r_fine)
    gmin, gmax = br["gmin"], br["gmax"]

    eps = emissivity(r_fine) if callable(emissivity) else torch.as_tensor(emissivity).to(r_fine)
    weight = dr * r_fine * eps * math.pi / (gmax - gmin)

    S = _make_S_both(br, tfs.gstar, gmin, gmax)
    quad = gauss_legendre(quadrature_points)
    bins = _integrate_bins(S, g_grid / g_scale, gmin, gmax, h, quad)  # (nf, nb)
    # the radial sum as elementwise products, at full precision
    flux_bins = (weight[:, None] * bins).sum(dim=0)
    if normalize:
        flux_bins = _normalize_flux(flux_bins, g_grid)
    return torch.cat([flux_bins, flux_bins.new_zeros(1)])


def integrate_lagtransfer(
    profile,
    tfs: TransferBranchGrid,
    g_grid,
    t_grid,
    *,
    h: float = 2e-8,
    n_radii: int = 1000,
    quadrature_points: int = 7,
    rmin=None,
    rmax=None,
    g_scale: float = 1.0,
    t0=0.0,
):
    """2D (g, t) flux: branch fluxes scatter-added into arrival-time bins
    (reference `_integrate_transfer_problem!` matrix variant,
    integration.jl:374-453). ``profile`` must provide emissivity_at(r) and
    coordtime_at(r) (a `RadialDiscProfile`); ``t0`` is the continuum time
    offset. Returns (len(g_grid), len(t_grid)), the last row zero, as in
    the reference's output layout."""
    device, dtype = tfs.radii.device, tfs.radii.dtype
    g_grid = torch.as_tensor(g_grid, dtype=dtype, device=device)
    t_grid = torch.as_tensor(t_grid, dtype=dtype, device=device)
    rmin = tfs.inner_radius() if rmin is None else rmin
    rmax = tfs.outer_radius() if rmax is None else rmax

    r_fine = GeometricGrid()(rmin, rmax, n_radii, dtype=dtype, device=device)
    rmin = torch.as_tensor(rmin, dtype=dtype, device=device)
    dr = torch.diff(r_fine, prepend=(rmin - (r_fine[1] - rmin)).reshape(1))
    br = tfs.at_radius(r_fine)
    gmin, gmax = br["gmin"], br["gmax"]

    eps = profile.emissivity_at(r_fine)
    t_source_disc = profile.coordtime_at(r_fine) - t0
    weight = dr * r_fine * eps * math.pi / (gmax - gmin)

    quad = gauss_legendre(quadrature_points)

    def branch_S(which):
        def S(gvals):
            gstar = (gvals - gmin[:, None]) / (gmax - gmin)[:, None]
            gstar_c = torch.clamp(gstar, 1e-12, 1.0 - 1e-12)
            f = _branch_value(br[which], tfs.gstar, gstar_c)
            return gvals**3 * torch.nan_to_num(f) / torch.sqrt(gstar_c * (1.0 - gstar_c))

        return S

    k_lower = _integrate_bins(branch_S("lower_f"), g_grid / g_scale, gmin, gmax, h, quad)
    k_upper = _integrate_bins(branch_S("upper_f"), g_grid / g_scale, gmin, gmax, h, quad)

    # arrival time per (radius, bin): branch time averaged over the bin edges
    # (reference `_time_bins`, integration.jl:103-112)
    span_ = (gmax - gmin)[:, None]
    gstar_e0 = torch.clamp((g_grid[None, :-1] / g_scale - gmin[:, None]) / span_, 1e-6, 1 - 1e-6)
    gstar_e1 = torch.clamp((g_grid[None, 1:] / g_scale - gmin[:, None]) / span_, 1e-6, 1 - 1e-6)

    def branch_t(which):
        t_e0 = _branch_value(br[which], tfs.gstar, gstar_e0)
        t_e1 = _branch_value(br[which], tfs.gstar, gstar_e1)
        return 0.5 * (t_e0 + t_e1) + t_source_disc[:, None]

    nb = g_grid.shape[0] - 1
    nt = t_grid.shape[0]

    def scatter(k, t_arr):
        # searchsorted-first, and a time past the last bin is dropped
        ti = torch.searchsorted(t_grid, t_arr.contiguous())  # (nf, nb)
        valid = ti < nt
        ti = torch.clamp(ti, 0, nt - 1)
        contrib = torch.where(valid, k * weight[:, None], 0.0)
        flat_idx = (torch.arange(nb, device=device)[None, :] * nt + ti).reshape(-1)
        return k.new_zeros(nb * nt).index_add_(0, flat_idx, contrib.reshape(-1)).reshape(nb, nt)

    out = scatter(k_lower, branch_t("lower_t")) + scatter(k_upper, branch_t("upper_t"))

    # normalise (reference matrix `_normalize!`, utils.jl:134-147). The
    # reference's final `flux = flux ./ maximum(sum(flux, dims=2))` rebinds
    # a local instead of mutating, so it never reaches the returned array:
    # the effective normalisation is total = 1 only, kept as the JAX
    # package keeps it (the reverberation goldens depend on it).
    gbar = (g_grid[:-1] + g_grid[1:])[:, None]
    out = out / gbar
    total = out.sum()
    out = torch.where(total > 0, out / total, out)
    return torch.cat([out, out.new_zeros(1, nt)], dim=0)
