"""Adaptive sampling: host-driven refinement around device batches
(counterpart of `gradus_tpu/camera/adaptive.py`, host numpy as there).

Reference: `src/image-planes/{adaptive-grid,adaptive-sky,adaptive-plane}.jl`:
a 3×3-subdividing quadtree over the (x, y) image plane or the (cos θ, φ) local
sky, refining where a user predicate sees disparity between neighbouring
values. The refinement decision loop runs on the host; each round evaluates
one batched trace on the device, through the caller's ``evaluate``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["AdaptiveGrid2D", "adaptive_sky", "adaptive_render", "fill_sky_values"]


class AdaptiveGrid2D:
    """3×3-refinement grid over [x0,x1]×[y0,y1] with per-cell values."""

    def __init__(self, x_lims, y_lims, n0: int = 16):
        xs = np.linspace(x_lims[0], x_lims[1], n0 + 1)
        ys = np.linspace(y_lims[0], y_lims[1], n0 + 1)
        cx = 0.5 * (xs[:-1] + xs[1:])
        cy = 0.5 * (ys[:-1] + ys[1:])
        X, Y = np.meshgrid(cx, cy, indexing="ij")
        self.cx = X.ravel()
        self.cy = Y.ravel()
        self.w = np.full(self.cx.shape, xs[1] - xs[0])
        self.h = np.full(self.cy.shape, ys[1] - ys[0])
        self.values = None
        self.depth = np.zeros(self.cx.shape, dtype=int)

    def refine(self, mask):
        """Subdivide masked cells 3×3 (reference `refine!`,
        adaptive-grid.jl:33-120)."""
        keep = ~mask
        cx_k, cy_k = self.cx[keep], self.cy[keep]
        w_k, h_k = self.w[keep], self.h[keep]
        v_k = self.values[keep] if self.values is not None else None
        d_k = self.depth[keep]

        cx_r, cy_r = self.cx[mask], self.cy[mask]
        w_r, h_r = self.w[mask], self.h[mask]
        d_r = self.depth[mask]
        offs = np.array([-1.0 / 3.0, 0.0, 1.0 / 3.0])
        new_cx, new_cy, new_w, new_h, new_d = [], [], [], [], []
        for ox in offs:
            for oy in offs:
                new_cx.append(cx_r + ox * w_r)
                new_cy.append(cy_r + oy * h_r)
                new_w.append(w_r / 3.0)
                new_h.append(h_r / 3.0)
                new_d.append(d_r + 1)
        n_new = mask.sum() * 9
        self.cx = np.concatenate([cx_k] + new_cx)
        self.cy = np.concatenate([cy_k] + new_cy)
        self.w = np.concatenate([w_k] + new_w)
        self.h = np.concatenate([h_k] + new_h)
        self.depth = np.concatenate([d_k] + new_d)
        self._n_old = keep.sum()
        self._v_old = v_k
        return n_new

    def set_values(self, new_values):
        if self._v_old is None:
            self.values = np.asarray(new_values)
        else:
            self.values = np.concatenate([self._v_old, np.asarray(new_values)])

    def neighbour_disparity(self):
        """Max |Δvalue| to the nearest cells. O(n log n): a k-d tree over the
        cell centres queried per depth level (all cells of one level share a
        radius), replacing the previous O(n²) python loop — usable at the
        reference's 1e5-cell scale (adaptive-grid.jl neighbour tracking)."""
        try:
            from scipy.spatial import cKDTree
        except Exception:  # pragma: no cover - scipy always baked in
            return self._neighbour_disparity_brute()

        v = self.values
        n = v.shape[0]
        disp = np.zeros(n)
        pts = np.stack([self.cx, self.cy], axis=1)
        tree = cKDTree(pts)
        nan_i = ~np.isfinite(v)
        for depth in np.unique(self.depth):
            sel = np.nonzero(self.depth == depth)[0]
            # shrink slightly: query_ball_point uses a CLOSED ball while the
            # brute-force reference uses strict d² < r², and on uniform grids
            # the 3-cells-away centre sits exactly at r — float rounding must
            # not decide neighbourhood
            r = 1.5 * (self.w[sel[0]] + self.h[sel[0]]) * (1.0 - 1e-9)
            pairs = tree.query_ball_point(pts[sel], r, workers=-1)
            # flatten the ragged neighbour lists once
            counts = np.fromiter((len(p) for p in pairs), int, len(pairs))
            if counts.sum() == 0:
                continue
            flat = np.concatenate([np.asarray(p, int) for p in pairs])
            owner = np.repeat(sel, counts)
            keep = flat != owner
            flat, owner = flat[keep], owner[keep]
            dv = np.abs(v[flat] - v[owner])
            both_nan = nan_i[flat] & nan_i[owner]
            dv = np.where(np.isfinite(dv), dv, np.where(both_nan, 0.0, np.inf))
            np.maximum.at(disp, owner, dv)
        return disp

    def _neighbour_disparity_brute(self):
        v = self.values
        n = v.shape[0]
        disp = np.zeros(n)
        pts = np.stack([self.cx, self.cy], axis=1)
        for i in range(n):
            d2 = np.sum((pts - pts[i]) ** 2, axis=1)
            r2 = (1.5 * (self.w[i] + self.h[i])) ** 2
            nbr = (d2 < r2) & (d2 > 0)
            if nbr.any():
                dv = np.abs(v[nbr] - v[i])
                finite = np.isfinite(dv)
                both_nan = ~np.isfinite(v[nbr]) & ~np.isfinite(v[i])
                dv = np.where(finite, dv, np.where(both_nan, 0.0, np.inf))
                disp[i] = dv.max()
        return disp

    def fill_values(self, nx: int, ny: int, blend: bool = True):
        """Rasterize the hierarchical cells onto a regular nx×ny grid
        (reference `fill_sky_values` / adaptive-plane blending,
        adaptive-plane.jl:100-181).

        Cells paint coarse-to-fine, so the deepest covering cell wins each
        pixel — exact piecewise-constant reconstruction. With `blend=True` a
        3×3 intersect-aware pass then averages each pixel with neighbours of
        the SAME class (finite vs NaN), smoothing values without bleeding
        across the hit/miss (shadow or disc-edge) boundary, which is the
        reference's intersect-aware interpolation semantics."""
        # raster bounds from the ACTUAL cell extents (w.max() on border cells
        # would inflate the margin when borders are refined)
        x0, x1 = (self.cx - self.w / 2).min(), (self.cx + self.w / 2).max()
        xs = np.linspace(x0, x1, nx + 1)
        y0, y1 = (self.cy - self.h / 2).min(), (self.cy + self.h / 2).max()
        ys = np.linspace(y0, y1, ny + 1)
        out = np.full((nx, ny), np.nan)
        order = np.argsort(self.depth, kind="stable")
        # first pixel whose cell-interval contains it: side='right' − 1 keeps
        # a cell edge coinciding exactly with a raster edge from bleeding one
        # pixel across the boundary
        ix0 = np.searchsorted(xs, self.cx - self.w / 2, side="right") - 1
        ix1 = np.searchsorted(xs, self.cx + self.w / 2, side="left")
        iy0 = np.searchsorted(ys, self.cy - self.h / 2, side="right") - 1
        iy1 = np.searchsorted(ys, self.cy + self.h / 2, side="left")
        for i in order:
            out[
                max(ix0[i], 0) : min(ix1[i], nx),
                max(iy0[i], 0) : min(iy1[i], ny),
            ] = self.values[i]
        if blend:
            finite = np.isfinite(out)
            vals = np.where(finite, out, 0.0)
            num = np.zeros_like(vals)
            den = np.zeros_like(vals)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    sh = np.roll(np.roll(vals, dx, 0), dy, 1)
                    fin = np.roll(np.roll(finite, dx, 0), dy, 1)
                    num += np.where(fin, sh, 0.0)
                    den += fin.astype(vals.dtype)
            blended = np.where(den > 0, num / np.maximum(den, 1), np.nan)
            out = np.where(finite, blended, np.nan)
        centres_x = 0.5 * (xs[:-1] + xs[1:])
        centres_y = 0.5 * (ys[:-1] + ys[1:])
        return centres_x, centres_y, out


def _refine_loop(
    grid: AdaptiveGrid2D, evaluate: Callable, check, rounds, max_depth, progress=None
):
    grid._v_old = None
    vals = evaluate(grid.cx, grid.cy)
    grid.set_values(vals)
    for rnd in range(rounds):
        disp = grid.neighbour_disparity()
        mask = check(grid.values, disp) & (grid.depth < max_depth)
        if progress is not None:
            progress(dict(round=rnd, cells=int(grid.cx.shape[0]), refining=int(mask.sum())))
        if not mask.any():
            break
        grid.refine(mask)
        new_cx = grid.cx[grid._n_old :]
        new_cy = grid.cy[grid._n_old :]
        vals = evaluate(new_cx, new_cy)
        grid.set_values(vals)
    return grid


def adaptive_render(
    m,
    position,
    evaluate: Callable,
    *,
    alpha_lims=(-10.0, 10.0),
    beta_lims=(-10.0, 10.0),
    n0: int = 16,
    rounds: int = 3,
    max_depth: int = 4,
    threshold: float = 0.1,
    progress=None,
):
    """Adaptively-refined image: `evaluate(αs, βs) -> values` traces a batch;
    refinement targets cells whose neighbour disparity exceeds `threshold`
    (or NaN boundaries — the shadow edge)."""
    grid = AdaptiveGrid2D(alpha_lims, beta_lims, n0=n0)

    def check(values, disp):
        return (disp > threshold) | ~np.isfinite(disp)

    return _refine_loop(grid, evaluate, check, rounds, max_depth, progress)


def adaptive_sky(
    m,
    evaluate: Callable,
    *,
    n0: int = 12,
    rounds: int = 3,
    max_depth: int = 5,
    threshold: float = 0.1,
):
    """Adaptive sampling of the (cos θ, φ) local sky (reference
    `AdaptiveSky`, adaptive-sky.jl:26-99); `evaluate(cosθs, φs) -> values`."""
    grid = AdaptiveGrid2D((-1.0, 1.0), (0.0, 2 * np.pi), n0=n0)

    def check(values, disp):
        return disp > threshold

    return _refine_loop(grid, evaluate, check, rounds, max_depth)


def fill_sky_values(grid: AdaptiveGrid2D, nx: int, ny: int, blend: bool = True):
    """Reference-parity name for rasterizing an adaptive grid onto a regular
    image (reference `fill_sky_values`, adaptive-plane.jl:100-181)."""
    return grid.fill_values(nx, ny, blend=blend)
