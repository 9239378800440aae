"""Cunningham-transfer-function offset solver over the CUDA integrator
(counterpart of `gradus_tpu/transfer/pallas_ctf.py`).

The image-plane offset r₀ along a direction θ whose ray hits the disc at
emission radius rₑ is found by a safeguarded Newton iteration whose slope is
a finite difference: one (2N,) integrator launch per iteration traces ρ(r₀)
and ρ(r₀ + h) together. The redshift needs no tracing: with the conserved
λ = p_φ/(−p_t), a closed form of the initial conditions, and the Keplerian
disc velocity, g(α, β) = 1/(uᵗ(ρ) − λ(α, β)·uᶲ(ρ)), so ∂g/∂(α, β) splits into
exact `torch.func.jvp` derivatives of λ and u plus the finite-difference ρ
derivatives. The Jacobian |∂(α, β)/∂(ρ, g)| is one central-difference
(5N,) launch.

On CUDA tensors every launch is the hand-written kernel
(`csrc/geodesic_tsit5.cu`, geometry kind `DatumPlane`); on CPU tensors it is
the kernel's plain PyTorch version. The Newton loop is a Python loop with
one device→host sync per iteration.
"""

from __future__ import annotations

import copy

import torch

from gradus_tpu_torch.camera.impact import map_impact_parameters
from gradus_tpu_torch.geodesics.equation import constrain_all
from gradus_tpu_torch.integrate.cuda_solver import CudaTracer
from gradus_tpu_torch.integrate.status import StatusCodes
from gradus_tpu_torch.metrics.base import AbstractMetric, _as_observer
from gradus_tpu_torch.transfer.solvers import (
    _conserved_g_helpers,
    _p_t_p_phi,
    rtheta_to_alphabeta,
)
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = ["CudaCTFSolver", "get_cuda_ctf_solver"]


class CudaCTFSolver:
    """Reusable offset solver over a fixed (metric, observer, disc) triple.

    Provides the three operations the CTF assembly consumes
    (`transfer/cunningham.py`): ``workhorse`` (solve + g + J + t), ``probe``
    (solve + g + t, no J) and ``jacobian_at`` (J at given offsets). The
    metric and the disc are copied into ``dtype`` on ``device`` (when None:
    the observer's device if ``x`` is a tensor, else the metric's)."""

    def __init__(
        self,
        m: AbstractMetric,
        x,
        d,
        *,
        lam_max=None,
        alpha0: float = 0.0,
        beta0: float = 0.0,
        gtol: float = 1e-2,
        fd_h: float = 4e-4,
        # the JAX package's default, from a sweep on its TPU: h = 2.5e-3·(1+|r|)
        # balanced truncation against noise there (pallas_ctf.py:69-73)
        fd_h_ab: float = 2.5e-3,
        max_iter: int = 20,
        stall_iters: int = 5,
        zero_atol: float = 1e-7,
        worst_accuracy_factor: float = 1e-4,
        dtype=torch.float32,
        device=None,
    ):
        if device is None:
            device = _as_observer(x, m).device
        self.x = torch.as_tensor(x, dtype=dtype, device=device)
        self.m = copy.deepcopy(m).to(device=device, dtype=dtype)
        d = copy.deepcopy(d).to(device=device, dtype=dtype)
        self.alpha0 = float(alpha0)
        self.beta0 = float(beta0)
        self.lam_max = float(2.0 * self.x[1]) if lam_max is None else float(lam_max)
        self.fd_h = float(fd_h)
        self.fd_h_ab = float(fd_h_ab)
        self.max_iter = int(max_iter)
        self.stall_iters = int(stall_iters)
        self.zero_atol = float(zero_atol)
        self.worst_accuracy_factor = float(worst_accuracy_factor)
        self.tracer = CudaTracer(
            self.m,
            geometry=d,
            gtol=gtol,
            chart_outer=2.0 * float(self.x[1]),
            dtype=dtype,
        )
        self._lam_of_helpers = _conserved_g_helpers(self.m)
        # the (r_targets, θ, warm) → (r_off, g, t, ok) contract of
        # `cunningham._golden_scan(probe_fn=...)`
        self.probe_fn = lambda rt, th, warm: self._probe_impl(rt, th, warm)

    # -- primitives -------------------------------------------------------

    def _trace_ab(self, al, be):
        """(ρ, t_hit, hit) for image-plane coordinates via the integrator."""
        v = map_impact_parameters(self.m, self.x, al, be)
        y0 = self.tracer._constrain(self.x.expand_as(v), v)
        gp, _aux = self.tracer.trace(y0, (0.0, self.lam_max))
        rho = equatorial_project(gp.x)
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        return rho, gp.x[..., 0], hit

    def _trace_rho_t(self, r_off, thetas):
        al, be = rtheta_to_alphabeta(r_off, thetas, self.alpha0, self.beta0)
        return self._trace_ab(al, be)

    def _lam_of_ab(self, al, be):
        """Conserved λ = p_φ/(−p_t) from the image-plane coordinates —
        closed form, no integration. The null constraint must be applied
        first: it solves for v^t, and λ is a ratio involving p_t."""
        v = map_impact_parameters(self.m, self.x, al, be)
        xs = self.x.expand_as(v)
        v = constrain_all(self.m, xs, v, mu=0.0)
        p_t, p_phi = _p_t_p_phi(self.m, xs, v)
        return p_phi / (-p_t)

    def _g_of(self, lam, rho):
        _lam_of, _g_conserved = self._lam_of_helpers
        return _g_conserved(lam, rho)

    # -- the FD Newton ----------------------------------------------------

    def _solve_impl(self, r_targets, thetas, r_init):
        eps = torch.finfo(self.x.dtype).eps
        zero_atol_eff = torch.clamp(
            32.0 * eps * torch.clamp(r_targets, min=1.0), min=self.zero_atol
        )
        accept_tol = torch.maximum(
            self.worst_accuracy_factor * r_targets, 10 * zero_atol_eff
        )

        r0 = torch.clamp(r_targets, min=20.0)
        r0 = torch.where(torch.isfinite(r_init) & (r_init > 0.0), r_init, r0)
        lo = torch.zeros_like(r0)
        hi = torch.full_like(r0, torch.inf)
        have_hi = torch.zeros_like(r0, dtype=torch.bool)
        upper_limit = 4.0 * (r_targets + 20.0)
        best_r = r0
        best_y = torch.full_like(r0, torch.inf)
        since = torch.zeros_like(r0, dtype=torch.int32)
        done = torch.zeros_like(r0, dtype=torch.bool)
        n = r0.shape[0]
        th2 = torch.cat([thetas, thetas])

        r, it = r0, 0
        # `done.all()` is this loop's one device→host sync per iteration
        while it < self.max_iter and not bool(done.all()):
            h = self.fd_h * (1.0 + r)
            rho2, _, _ = self._trace_rho_t(torch.cat([r, r + h]), th2)
            rho = rho2[:n]
            drho = (rho2[n:] - rho) / h
            y = rho - r_targets
            improved = torch.abs(y) < best_y
            progressed = torch.abs(y) < 0.5 * best_y
            best_r = torch.where(improved, r, best_r)
            best_y = torch.where(improved, torch.abs(y), best_y)
            since = torch.where(progressed, 0, since + 1)
            lo = torch.where(y < 0, torch.maximum(lo, r), lo)
            hi = torch.where(y > 0, torch.minimum(hi, r), hi)
            have_hi = have_hi | (y > 0)
            drho_safe = torch.where(torch.abs(drho) < 1e-20, 1.0, drho)
            newton = r - y / drho_safe
            # a branch-straddling FD pair (the + h ray crossed the photon-ring
            # critical curve into another image order) shows up as an enormous
            # or negative slope: a bad step, so the bracketed bisection keeps
            # the solve on the primary image
            branch_jump = (torch.abs(drho) > 1e3) | (drho < 0.0)
            bad = (
                branch_jump
                | ~torch.isfinite(newton)
                | (newton <= lo)
                | (have_hi & (newton >= hi))
                | (newton > upper_limit)
            )
            grow = torch.minimum(2.0 * r, upper_limit)
            fallback = torch.where(have_hi, 0.5 * (lo + hi), grow)
            converged = torch.abs(y) < zero_atol_eff
            done = converged | (since >= self.stall_iters)
            r = torch.where(converged, r, torch.where(bad, fallback, newton))
            it += 1

        r_off = best_r
        rho, t_hit, hit = self._trace_rho_t(r_off, thetas)
        ok = (torch.abs(rho - r_targets) < accept_tol) & hit
        return torch.where(ok, r_off, torch.nan), rho, t_hit, ok

    def _probe_impl(self, r_targets, thetas, r_init):
        r_off, rho, t_hit, ok = self._solve_impl(r_targets, thetas, r_init)
        r_safe = torch.where(ok, r_off, torch.clamp(r_targets, min=20.0))
        al, be = rtheta_to_alphabeta(r_safe, thetas, self.alpha0, self.beta0)
        g = self._g_of(self._lam_of_ab(al, be), r_targets)
        return r_off, g, t_hit, ok

    def _jacobian_impl(self, r_targets, thetas, r_off):
        """(g, J, t, ok, cond) at solved offsets: one (5N,) launch gives the
        centre and the central α/β differences of ρ; the λ part of g is
        closed-form."""
        ok0 = torch.isfinite(r_off)
        r_safe = torch.where(ok0, r_off, torch.clamp(r_targets, min=20.0))
        al, be = rtheta_to_alphabeta(r_safe, thetas, self.alpha0, self.beta0)
        h = self.fd_h_ab * (1.0 + torch.abs(r_safe))
        n = r_targets.shape[0]

        als = torch.cat([al, al + h, al - h, al, al])
        bes = torch.cat([be, be, be, be + h, be - h])
        rho5, t5, hit5 = self._trace_ab(als, bes)
        rho_c = rho5[:n]
        t_hit = t5[:n]
        drho_da = (rho5[n : 2 * n] - rho5[2 * n : 3 * n]) / (2.0 * h)
        drho_db = (rho5[3 * n : 4 * n] - rho5[4 * n : 5 * n]) / (2.0 * h)

        # g(α, β) = g_c(λ(α, β), ρ(α, β)): λ and the Keplerian u are closed
        # forms, so their derivatives are exact jvps (elementwise in the
        # sample index, so an all-ones tangent reads off the diagonal); only
        # the ρ derivatives involve the integrator
        ones = torch.ones_like(al)
        jvp = torch.func.jvp
        lam_c, dlam_da = jvp(lambda a_: self._lam_of_ab(a_, be), (al,), (ones,))
        _, dlam_db = jvp(lambda b_: self._lam_of_ab(al, b_), (be,), (ones,))
        _, dg_dlam = jvp(lambda l_: self._g_of(l_, rho_c), (lam_c,), (ones,))
        _, dg_drho = jvp(lambda r_: self._g_of(lam_c, r_), (rho_c,), (ones,))
        dg_da = dg_dlam * dlam_da + dg_drho * drho_da
        dg_db = dg_dlam * dlam_db + dg_drho * drho_db
        det = drho_da * dg_db - drho_db * dg_da
        J = torch.abs(1.0 / det)
        cond = torch.abs(det) / (
            torch.abs(drho_da * dg_db) + torch.abs(drho_db * dg_da) + 1e-300
        )
        # g at exactly rₑ for the dataset
        g = self._g_of(self._lam_of_ab(al, be), r_targets)
        ok = ok0 & hit5[:n] & torch.isfinite(J)
        return g, J, t_hit, ok, cond

    # -- public entry points ------------------------------------------------

    def _as_x(self, v):
        return torch.as_tensor(v, dtype=self.x.dtype, device=self.x.device)

    def workhorse(self, r_targets, thetas, r_init=None):
        """(g, J, t, ok, r_off, cond) — the sweep operation."""
        r_targets, thetas = self._as_x(r_targets), self._as_x(thetas)
        r_init = torch.full_like(r_targets, torch.nan) if r_init is None else self._as_x(r_init)
        r_off, rho, t_hit, ok = self._solve_impl(r_targets, thetas, r_init)
        g, J, _t2, okJ, cond = self._jacobian_impl(r_targets, thetas, r_off)
        return g, J, t_hit, ok & okJ, r_off, cond

    def probe(self, r_targets, thetas, r_init=None):
        """(r_off, g, t, ok) — golden-section probe (no J)."""
        r_targets, thetas = self._as_x(r_targets), self._as_x(thetas)
        r_init = torch.full_like(r_targets, torch.nan) if r_init is None else self._as_x(r_init)
        return self._probe_impl(r_targets, thetas, r_init)

    def jacobian_at(self, r_targets, thetas, r_off):
        """(g, J, t, ok, cond) at precomputed offsets."""
        return self._jacobian_impl(
            self._as_x(r_targets), self._as_x(thetas), self._as_x(r_off)
        )


_SOLVER_CACHE: dict = {}


def get_cuda_ctf_solver(m, x, d, **kwargs) -> CudaCTFSolver:
    """Config-keyed solver cache, reused across `cunningham_transfer_function`
    calls (a line profile calls it afresh each time). The key holds the
    metric's and the disc's parameters, the observer, the dtype, the device
    and the numeric keyword arguments."""

    def leafkey(module):
        return tuple(float(b) for b in module.buffers() if b.dim() == 0)

    dtype = kwargs.get("dtype", torch.float32)
    device = kwargs.get("device")
    if device is None:
        device = _as_observer(x, m).device
    x_key = torch.as_tensor(x, dtype=torch.float64, device="cpu").tolist()
    key = (
        type(m).__name__,
        leafkey(m),
        tuple(x_key),
        type(d).__name__,
        leafkey(d),
        str(dtype),
        str(torch.device(device)),
        tuple(sorted((k, float(v)) for k, v in kwargs.items() if isinstance(v, (int, float)))),
    )
    if key not in _SOLVER_CACHE:
        _SOLVER_CACHE[key] = CudaCTFSolver(m, x, d, **kwargs)
    return _SOLVER_CACHE[key]
