"""Cunningham transfer functions, batched over (emission radius, angle)
(counterpart of `gradus_tpu/transfer/cunningham.py`).

Reference: `src/transfer-functions/cunningham-transfer-functions.jl`. For each
emission radius rₑ the reference loops an edge-clustered θ iterator, root-finds
the image-plane offset per θ, golden-sections for the extremal redshifts
gmin/gmax, rescales the Jacobian to ∂g✶ and forms

    f = (1/π rₑ) · g · √(g✶(1−g✶)) · J            (:62)

then splits the samples into upper/lower branches and interpolates over g✶.

All radii process all angles at once through an offset solver; the
golden-section extremal search advances every radius in lockstep, and the
branches are resampled onto a fixed g✶ grid as a dense `TransferBranchGrid` —
the reference's `CunninghamTransferGrid` (types.jl:14-40). Two backends, as
in the JAX package:

- ``"xla"``, the default: the jvp Newton of `transfer/solvers.py` through the
  lockstep solver (plain torch on the observer's device; on the card its
  loop replays CUDA graphs). It takes thin discs, any other geometry, and
  thick discs through one datum plane per radius, with the visibility
  re-trace against the real disc.
- ``"cuda"`` (the JAX package's ``"pallas"``): the finite-difference Newton
  of `transfer/cuda_ctf.py` on the hand-written CUDA integrator (its plain
  version on CPU tensors). Thin discs only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from gradus_tpu_torch.geometry.discs import AbstractThickAccretionDisc, DatumPlane, ThinDisc, datumplane
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.transfer.solvers import offset_jacobian_at, offset_probe, offset_workhorse

__all__ = [
    "TransferBranchGrid",
    "cunningham_transfer_function",
    "transferfunctions",
    "interpolated_transfer_branches",
    "g_to_gstar",
    "gstar_to_g",
    "disc_solver_tile",
]

_GR = 0.6180339887498949


def g_to_gstar(g, gmin, gmax):
    return (g - gmin) / (gmax - gmin)


def gstar_to_g(gstar, gmin, gmax):
    return (gmax - gmin) * gstar + gmin


def _interval_index(xs, q):
    """Index i of the interval [xs[i], xs[i+1]] holding q, clipped to the
    first and last (``searchsorted(side="right") − 1``)."""
    idx = torch.searchsorted(xs, q.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, xs.shape[-1] - 2)


@dataclasses.dataclass(frozen=True)
class TransferBranchGrid:
    """Dense transfer-function table over (rₑ, g✶)."""

    radii: Any  # (nr,)
    gmin: Any  # (nr,)
    gmax: Any  # (nr,)
    gstar: Any  # (Ng,)
    lower_f: Any  # (nr, Ng)
    upper_f: Any  # (nr, Ng)
    lower_t: Any  # (nr, Ng)
    upper_t: Any  # (nr, Ng)

    def inner_radius(self):
        return self.radii[0]

    def outer_radius(self):
        return self.radii[-1]

    def at_radius(self, r):
        """Linear interpolation of every row quantity at radii ``r`` (any
        shape). Returns a dict of tensors with the leading shape of ``r``."""
        xs = self.radii
        r = torch.as_tensor(r, dtype=xs.dtype, device=xs.device)
        idx = _interval_index(xs, r)
        x0, x1 = xs[idx], xs[idx + 1]
        w = torch.clamp((r - x0) / torch.where(x1 == x0, 1.0, x1 - x0), 0.0, 1.0)

        def lerp(row):
            if row.dim() > 1:
                return row[idx] * (1 - w[..., None]) + row[idx + 1] * w[..., None]
            return row[idx] * (1 - w) + row[idx + 1] * w

        return dict(
            gmin=lerp(self.gmin),
            gmax=lerp(self.gmax),
            lower_f=lerp(self.lower_f),
            upper_f=lerp(self.upper_f),
            lower_t=lerp(self.lower_t),
            upper_t=lerp(self.upper_t),
        )

    def __repr__(self):
        return (
            f"TransferBranchGrid\n"
            f"  . radii (N, min, max) : {self.radii.shape[0]}, "
            f"{float(self.radii.min()):.4g}, {float(self.radii.max()):.4g}\n"
            f"  . g✶ grid            : {self.gstar.shape[0]} nodes\n"
            f"  . g (min, max)        : "
            f"{float(self.gmin.min()):.4g}, {float(self.gmax.max()):.4g}"
        )


def _theta_samples(N: int, theta_offset: float, dtype, device=None):
    """Edge-clustered θ iterator (reference
    cunningham-transfer-functions.jl:359-367)."""
    K = N // 5
    a = np.linspace(-2 * theta_offset, 2 * theta_offset, K)
    b = np.linspace(-np.pi / 2, 3 * np.pi / 2, N - 2 * K)
    c = np.linspace(np.pi - 2 * theta_offset, np.pi + 2 * theta_offset, K)
    return torch.as_tensor(np.concatenate([a, b, c]), dtype=dtype, device=device)


def _avoid_poles(theta):
    """Nudge θ off the exact image-plane axes (reference `_gmin_finder`,
    cunningham-transfer-functions.jl:437-447)."""
    near0 = torch.abs(theta) < 1e-4
    nearpi = torch.abs(torch.abs(theta) - math.pi) < 1e-4
    return torch.where(near0 | nearpi, theta + 1e-4, theta)


def _masked_resample(gq, gs, vals, mask):
    """Row-wise linear interpolation of (gs, vals) restricted to mask,
    sampled at gq.

    Invalid entries sort to +inf; queries clamp to the valid range.
    gs, vals, mask: (R, M); gq: (Ng,) → (R, Ng). A row with fewer than 2
    valid samples clips its interval index to n − 2 < 0, which wraps from the
    end of the row: the JAX package does the same (a reference fault of the
    class of `gradus_tpu/utils/interp.py:71`, ROADMAP queue C), and it is
    reproduced here."""
    M = gs.shape[-1]
    big = torch.where(mask, gs, torch.inf)
    order = torch.argsort(big, dim=-1, stable=True)
    xs = torch.gather(big, -1, order)
    ys = torch.gather(vals, -1, order)
    n = mask.sum(dim=-1, keepdim=True)
    q = gq.expand(gs.shape[0], -1).contiguous()
    idx = torch.searchsorted(xs, q, right=True) - 1
    idx = torch.minimum(torch.clamp(idx, min=0), n - 2)
    # negative indices count from the end, as jnp indexing does
    i0, i1 = (torch.where(i < 0, i + M, i) for i in (idx, idx + 1))
    x0, x1 = torch.gather(xs, -1, i0), torch.gather(xs, -1, i1)
    w = torch.clamp((q - x0) / torch.where(x1 <= x0, 1.0, x1 - x0), 0.0, 1.0)
    return torch.gather(ys, -1, i0) * (1 - w) + torch.gather(ys, -1, i1) * w


def _golden_scan(radii, theta_offset, warm0, *, N_extrema, probe_fn, warm_start=True):
    """Both extremal golden-section searches (gmin around θ=0, gmax around
    θ=π) advanced in lockstep: ``N_extrema`` steps of g-only probes, each
    warm-started from the previous probe's offset.

    ``probe_fn(r_targets, θ, warm) → (r_off, g, t, ok)`` is the solver's
    probe (`offset_probe` for the ``xla`` backend, `CudaCTFSolver.probe_fn`
    for ``cuda``); a NaN warm start is a cold one. Returns (θ, r_off, g, t,
    ok) stacked (N_extrema+2, 2, nr) — the probe trajectory of the
    reference's sequential Optim.jl GoldenSection
    (`_search_extremal!`, cunningham-transfer-functions.jl:391-430)."""
    nr = radii.shape[0]
    kw = dict(dtype=radii.dtype, device=radii.device)
    sign = torch.tensor([1.0, -1.0], **kw)[:, None]  # min side, max side
    center = torch.tensor([0.0, math.pi], **kw)[:, None]
    a = (center - theta_offset).expand(2, nr)
    b = (center + theta_offset).expand(2, nr)
    c = b - _GR * (b - a)
    e = a + _GR * (b - a)
    RE2 = radii[None, :].expand(2, nr).reshape(-1)

    def probe_eval(theta_2nr, warm_2nr):
        warm = warm_2nr.reshape(-1) if warm_start else torch.full_like(RE2, torch.nan)
        r_off, g, t, ok = probe_fn(RE2, _avoid_poles(theta_2nr.reshape(-1)), warm)
        return tuple(v.reshape(2, nr) for v in (r_off, g, t, ok))

    # prologue: evaluate both interior points of both brackets
    rc, gc, tc, okc = probe_eval(c, warm0)
    warm = torch.where(torch.isfinite(rc), rc, warm0)
    re_, ge, te, oke = probe_eval(e, warm)
    warm = torch.where(torch.isfinite(re_), re_, warm)
    fc = sign * gc
    fe = sign * ge

    probes = [(c, rc, gc, tc, okc), (e, re_, ge, te, oke)]
    for _ in range(N_extrema):
        left = fc < fe
        a, b = torch.where(left, a, c), torch.where(left, e, b)
        c, e = (
            torch.where(left, b - _GR * (b - a), e),
            torch.where(left, c, a + _GR * (b - a)),
        )
        probe = torch.where(left, c, e)
        rp, gp_, tp_, okp_ = probe_eval(probe, warm)
        warm = torch.where(torch.isfinite(rp), rp, warm)
        fp = sign * gp_
        fc, fe = torch.where(left, fp, fe), torch.where(left, fc, fp)
        probes.append((probe, rp, gp_, tp_, okp_))
    return tuple(torch.stack(col) for col in zip(*probes))


class _XlaSolver:
    """The ``xla`` backend's offset solver, in the three operations the
    assembly takes (`CudaCTFSolver`'s interface): the jvp Newton of
    `transfer/solvers.py` over ``disc`` (one height, or one per radius of a
    thick disc, which `disc_solver_tile` and `_tile` lay out for a batch)."""

    def __init__(self, m, x, disc, jacobian_disc, verify_disc, *, lam_max, zero_atol, newton_iters, alpha0, beta0):
        self.m, self.x, self.disc = m, x, disc
        self.common = dict(lam_max=lam_max, alpha0=alpha0, beta0=beta0)
        self.jac = dict(jacobian_disc=jacobian_disc, verify_disc=verify_disc)
        self.newton = dict(zero_atol=zero_atol, max_iter=newton_iters)

    def workhorse(self, r_targets, thetas, r_init=None):
        per_radius = r_targets.shape[0] // _n_heights(self.disc)
        return offset_workhorse(
            self.m, self.x, disc_solver_tile(self.disc, per_radius), r_targets, thetas,
            r_init=r_init, return_r_off=True, **self.common, **self.jac, **self.newton,
        )  # fmt: skip

    def probe_fn(self, r_targets, thetas, warm):
        return offset_probe(
            self.m, self.x, _tile(self.disc, 2), r_targets, thetas, r_init=warm, **self.common, **self.newton
        )

    def jacobian_at(self, r_targets, thetas, r_off):
        per_radius = r_targets.shape[0] // _n_heights(self.disc)
        return offset_jacobian_at(
            self.m, self.x, disc_solver_tile(self.disc, per_radius), r_targets, thetas, r_off,
            **self.common, **self.jac,
        )  # fmt: skip


def _n_heights(disc):
    return disc.height.shape[0] if isinstance(disc, DatumPlane) and disc.height.dim() == 1 else 1


def _tile(disc, k):
    """A disc whose per-ray heights match a (k·nr,) flat [k, nr] batch
    (the reference's ``_tiled_disc``)."""
    if isinstance(disc, DatumPlane) and disc.height.dim() == 1:
        return DatumPlane(disc.height.repeat(k), dtype=disc.height.dtype, device=disc.height.device)
    return disc


def disc_solver_tile(disc, N):
    """Per-radius datum planes repeated across the angle axis: the heights of
    an (nr·N,) flat [nr, N] batch."""
    if isinstance(disc, DatumPlane) and disc.height.dim() == 1:
        h = disc.height.repeat_interleave(N)
        return DatumPlane(h, dtype=h.dtype, device=h.device)
    return disc


def cunningham_transfer_function(
    m: AbstractMetric,
    x,
    d,
    radii,
    *,
    N: int = 80,
    N_extrema: int = 15,  # + 2 init evals = 17 probes/side (reference M = N + 2·17)
    Ng: int = 64,
    theta_offset: float = 0.3,
    h: float = 1e-6,
    h_reg: float = 1e-4,
    h_resample: float = 1e-3,
    zero_atol: float = 1e-7,
    newton_iters: int | None = None,
    lam_max=None,
    alpha0: float = 0.0,
    beta0: float = 0.0,
    return_samples: bool = False,
    probe_warm_start: bool = True,
    backend: str = "xla",
    cuda_opts: dict | None = None,
) -> TransferBranchGrid:
    """Compute transfer functions for an array of emission radii at once.

    ``backend="xla"`` (the default) solves the offsets by the jvp Newton of
    `transfer/solvers.py` (``newton_iters`` iterations at most, 30 when
    None); ``backend="cuda"`` (the JAX package's ``"pallas"``) through
    `CudaCTFSolver`, whose keyword arguments are ``cuda_opts`` (its Newton
    bound is ``cuda_opts["max_iter"]``: ``newton_iters`` raises there rather
    than be ignored). Thin discs are
    promoted to an equatorial `DatumPlane` for the offset solve (reference
    `_promote_disc_for_transfer_functions`, :1-5); a thick disc is solved
    against one datum plane per radius at its cross-section height, then
    re-traced against the disc itself for visibility (``"xla"`` only)."""
    if backend not in ("xla", "cuda"):
        raise ValueError(f"backend must be 'xla' or 'cuda', not {backend!r}")
    x = _as_observer(x, m)
    kw = dict(dtype=x.dtype, device=x.device)
    radii = torch.atleast_1d(torch.as_tensor(radii, **kw))
    nr = radii.shape[0]
    if lam_max is None:
        lam_max = 2.0 * x[1]

    thick = isinstance(d, AbstractThickAccretionDisc)
    if isinstance(d, ThinDisc):
        disc_solver = DatumPlane(0.0, **kw)
        jacobian_disc, verify_disc = disc_solver, None
    elif thick:
        # one datum plane per radius, at the disc's height there
        disc_solver = datumplane(d, radii)
        jacobian_disc, verify_disc = d, d
    else:
        disc_solver, jacobian_disc, verify_disc = d, d, None

    thetas0 = _theta_samples(N, theta_offset, **kw)

    # --- main angular sweep ---------------------------------------------
    TH = thetas0[None, :].expand(nr, N)
    RE = radii[:, None].expand(nr, N)
    # Warm start of the lockstep Newton: the flat-space image of the emission
    # ring, the ellipse r(θ) = rₑ·cos i / √(cos²i·cos²θ + sin²θ), plus an O(M)
    # light-bending lift that peaks on the far side (θ ≈ π/2). The ``cuda``
    # backend takes it in f32 and f64 alike, as the JAX package's "pallas"
    # branch does (:385-389); the ``xla`` backend in f32 only: in f64 the
    # cold reference start is kept, as in the JAX package (:338-356).
    inc = x[2]
    cos_i = torch.cos(inc)
    sin2 = torch.sin(TH) ** 2
    ellipse = RE * torch.abs(cos_i) / torch.sqrt(cos_i**2 * (1.0 - sin2) + sin2)
    bend = 1.0 + torch.sin(inc) * torch.clamp(torch.sin(TH), min=0.0)
    r_init = (ellipse + bend).reshape(-1)

    if backend == "cuda":
        if newton_iters is not None:
            raise TypeError("newton_iters bounds the 'xla' backend's Newton; backend='cuda' takes cuda_opts['max_iter']")
        if not (isinstance(disc_solver, DatumPlane) and disc_solver.height.dim() == 0):
            raise NotImplementedError(
                "backend='cuda' supports thin discs (a DatumPlane of one height) "
                f"only, not {type(d).__name__}"
                + (" with per-ray heights" if isinstance(d, DatumPlane) else "")
                + "; thick discs use the default 'xla' backend"
            )
        from gradus_tpu_torch.transfer.cuda_ctf import get_cuda_ctf_solver

        solver = get_cuda_ctf_solver(
            m,
            x,
            disc_solver,
            lam_max=float(lam_max),
            alpha0=float(alpha0),
            beta0=float(beta0),
            zero_atol=float(zero_atol),
            dtype=x.dtype,
            device=x.device,
            **(cuda_opts or {}),
        )
    else:
        solver = _XlaSolver(
            m,
            x,
            disc_solver,
            jacobian_disc,
            verify_disc,
            lam_max=lam_max,
            zero_atol=zero_atol,
            newton_iters=30 if newton_iters is None else newton_iters,
            alpha0=alpha0,
            beta0=beta0,
        )
        if x.dtype != torch.float32:
            r_init = None
    g_s, J_s, t_s, ok_s, roff_s, cond_s = (
        v.reshape(nr, N)
        for v in solver.workhorse(RE.reshape(-1), _avoid_poles(TH.reshape(-1)), r_init=r_init)
    )

    # --- golden-section extremal search (batched over radii) -------------
    # warm starts from the sweep samples nearest each bracket centre (the θ
    # iterator clusters samples around 0 and π for this)
    th_np = thetas0.cpu().numpy()
    i0 = int(np.argmin(np.abs(th_np)))
    ipi = int(np.argmin(np.abs(th_np - np.pi)))
    warm0 = torch.stack([roff_s[:, i0], roff_s[:, ipi]], dim=0)  # (2, nr)

    th_p, r_p, g_p, t_p, ok_p = _golden_scan(
        radii,
        theta_offset,
        warm0,
        N_extrema=N_extrema,
        probe_fn=solver.probe_fn,
        warm_start=probe_warm_start,
    )
    P = N_extrema + 2

    # Jacobians for all probes in one batched launch, at the solved offsets
    # (no Newton re-solve): probes flatten (P, 2, nr) → (nr, 2P) per radius
    def to_rows(arr):
        return torch.movedim(arr, -1, 0).reshape(nr, 2 * P)

    th_rows = to_rows(th_p)
    r_rows = to_rows(r_p)
    gJ, J_pr, tJ, okJ, condJ = solver.jacobian_at(
        radii[:, None].expand(nr, 2 * P).reshape(-1),
        _avoid_poles(th_rows.reshape(-1)),
        r_rows.reshape(-1),
    )
    J_rows = J_pr.reshape(nr, 2 * P)
    ok_rows = to_rows(ok_p) & okJ.reshape(nr, 2 * P)

    # assemble all samples: static sweep + probe evaluations
    th_all = torch.cat([TH, th_rows], dim=1)
    g_all = torch.cat([g_s, to_rows(g_p)], dim=1)
    J_all = torch.cat([J_s, J_rows], dim=1)
    t_all = torch.cat([t_s, to_rows(t_p)], dim=1)
    ok_all = torch.cat([ok_s, ok_rows], dim=1)
    cond_all = torch.cat([cond_s, condJ.reshape(nr, 2 * P)], dim=1)

    # extrema from the collected samples only: the argmin/argmax samples then
    # get g✶ = 0 / 1 exactly (IEEE x/x = 1), so √(g✶(1−g✶)) = 0 kills the
    # divergent-J endpoint instead of producing a 0·∞ product — matching the
    # reference accumulator (`_cunningham_transfer_function!`, :314-332)
    gmin = torch.where(ok_all, g_all, torch.inf).amin(dim=1)
    gmax = torch.where(ok_all, g_all, -torch.inf).amax(dim=1)

    # --- transfer function values ----------------------------------------
    span = (gmax - gmin)[:, None]
    gstar_all = (g_all - gmin[:, None]) / span
    Jstar = span * J_all
    root = torch.sqrt(torch.clamp(gstar_all * (1.0 - gstar_all), min=0.0))
    # at the exact extrema root = 0 while J may overflow: f ≡ 0 there
    f_all = torch.where(
        root == 0.0,
        0.0,
        (1.0 / (math.pi * radii[:, None])) * g_all * root * Jstar,
    )

    # --- near-extremal regularisation (gated outlier filter) ---------------
    # Within h_reg of either extremum J = 1/|det| and (1−g✶) can both be
    # noise-dominated, and their product spikes. A sample there is replaced by
    # its nearest well-conditioned neighbour's f only when it spikes upward by
    # more than κ = 1.5× (or is non-finite); downward dips are kept (the JAX
    # package's reasoning and measurements: gradus_tpu/transfer/cunningham.py
    # :513-536).
    if h_reg > 0.0:
        kappa = 1.5

        def _regularise(f_cur, ill, safe, toward):
            have = safe.any(dim=1)[:, None]
            cand = torch.where(safe, gstar_all, -toward * torch.inf)
            pick = cand.argmax(dim=1) if toward > 0 else cand.argmin(dim=1)
            f_ref = torch.gather(f_cur, 1, pick[:, None])
            noise = ~torch.isfinite(f_cur) | (f_cur > kappa * f_ref)
            return torch.where(ill & have & noise, f_ref, f_cur)

        safe_hi = ok_all & (gstar_all <= 1.0 - h_reg)
        ill_hi = ok_all & (gstar_all > 1.0 - h_reg) & (gstar_all < 1.0)
        f_all = _regularise(f_all, ill_hi, safe_hi, +1.0)
        safe_lo = ok_all & (gstar_all >= h_reg)
        ill_lo = ok_all & (gstar_all < h_reg) & (gstar_all > 0.0)
        f_all = _regularise(f_all, ill_lo, safe_lo, -1.0)

    # --- sort by θ, split branches at the g✶ extrema ----------------------
    # stable, as jnp.argsort: the sweep and the probes can hold equal angles
    order = torch.argsort(th_all, dim=1, stable=True)
    gstar_o = torch.gather(gstar_all, 1, order)
    f_o = torch.gather(f_all, 1, order)
    t_o = torch.gather(t_all, 1, order)
    ok_o = torch.gather(ok_all, 1, order)

    M = gstar_o.shape[1]
    k = torch.arange(M, device=x.device)[None, :]
    imin = torch.where(ok_o, gstar_o, torch.inf).argmin(dim=1)
    imax = torch.where(ok_o, gstar_o, -torch.inf).argmax(dim=1)
    i1 = torch.minimum(imin, imax)[:, None]
    i2 = torch.maximum(imin, imax)[:, None]
    # exclude samples hard against the extrema, where f is a numerically
    # broken 0·∞ product; the reference drops g✶ ∉ (h, 1−h) the same way
    # (`_make_sorted_with_adjustments!`, :81-89)
    interior = ok_o & (gstar_o > h) & (gstar_o < 1.0 - h)
    b1 = (k >= i1) & (k <= i2) & interior
    b2 = ((k <= i1) | (k >= i2)) & interior

    from gradus_tpu_torch.camera.grids import LinearGrid

    gq = LinearGrid()(h_resample, 1.0 - h_resample, Ng, **kw)
    f1 = _masked_resample(gq, gstar_o, f_o, b1)
    t1 = _masked_resample(gq, gstar_o, t_o, b1)
    f2 = _masked_resample(gq, gstar_o, f_o, b2)
    t2 = _masked_resample(gq, gstar_o, t_o, b2)

    # upper branch = larger mean f (the reference orders adjacent samples)
    sel = (f1.mean(dim=1) > f2.mean(dim=1))[:, None]
    grid = TransferBranchGrid(
        radii=radii,
        gmin=gmin,
        gmax=gmax,
        gstar=gq,
        lower_f=torch.where(sel, f2, f1),
        upper_f=torch.where(sel, f1, f2),
        lower_t=torch.where(sel, t2, t1),
        upper_t=torch.where(sel, t1, t2),
    )
    if return_samples:
        samples = dict(
            theta=torch.gather(th_all, 1, order),
            gstar=gstar_o,
            f=f_o,
            t=t_o,
            ok=ok_o,
            cond=torch.gather(cond_all, 1, order),
            J=torch.gather(J_all, 1, order),
        )
        return grid, samples
    return grid


def transferfunctions(
    m: AbstractMetric,
    x,
    d,
    *,
    min_re=None,
    max_re: float = 50.0,
    num_re: int = 100,
    radii=None,
    **kwargs,
) -> TransferBranchGrid:
    """Pre-compute transfer functions over an inverse-spaced radial grid
    (reference `transferfunctions`, cunningham-transfer-functions.jl:547-569;
    defaults minrₑ = isco + 1e-2, maxrₑ = 50, numrₑ = 100)."""
    from gradus_tpu_torch.camera.grids import InverseGrid
    from gradus_tpu_torch.orbits.special_radii import isco as _isco

    if radii is None:
        x = _as_observer(x, m)
        if min_re is None:
            min_re = _isco(m) + 1e-2
        radii = InverseGrid()(min_re, max_re, num_re, dtype=x.dtype, device=x.device)
    return cunningham_transfer_function(m, x, d, radii, **kwargs)


# reference-parity alias
interpolated_transfer_branches = transferfunctions
