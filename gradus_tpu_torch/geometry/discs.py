"""Accretion-disc geometry consumed by the integrator's event layer
(counterpart of `gradus_tpu/geometry/discs.py`).

`distance_to_disc(x4, gtol)` is positive away from the disc, ≤ 0 on it; the
surface thickening is ``gtol·|r|``. Out-of-annulus queries return 1. A
geometry's parameters are registered buffers, on the card unless ``device``
says otherwise; a cross-section given as a Python callable (`ThickDisc`,
`WarpedThinDisc`) is kept as it is. Every method is elementwise torch with
no host read, so the lockstep solver's loop replays them in a CUDA graph.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from torch import nn

from gradus_tpu_torch.config import default_device
from gradus_tpu_torch.utils.linalg import equatorial_project, spinaxis_project

__all__ = [
    "AbstractAccretionGeometry",
    "AbstractThickAccretionDisc",
    "ThinDisc",
    "WarpedThinDisc",
    "DatumPlane",
    "ThickDisc",
    "ShakuraSunyaev",
    "EllipticalDisc",
    "PrecessingDisc",
    "PolishDoughnut",
    "PolishDoughnutFW",
    "polish_doughnut_fw",
    "CompositeGeometry",
    "datumplane",
]


class AbstractAccretionGeometry(nn.Module):
    optically_thin = True

    def _buffers_from(self, dtype, device, **values):
        device = default_device(device)
        for name, value in values.items():
            self.register_buffer(name, torch.as_tensor(value, dtype=dtype, device=device))

    def distance_to_disc(self, x4, gtol=1e-2):  # pragma: no cover - interface
        raise NotImplementedError

    def crossing_indicator(self, x4):
        """Smooth signed function whose zero crossings include every possible
        surface hit; defaults to the distance function."""
        return self.distance_to_disc(x4, gtol=0.0)

    def is_hit(self, x4, gtol=1e-2):
        """Whether a located zero crossing is a real surface hit."""
        return torch.ones(x4.shape[:-1], dtype=torch.bool, device=x4.device)

    # component form: the event interface of the integrator's plain version
    def crossing_indicator_c(self, t, r, th, ph):
        return self.crossing_indicator(torch.stack([t, r, th, ph], dim=-1))

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        return self.is_hit(torch.stack([t, r, th, ph], dim=-1), gtol=gtol)

    # radiative transfer coefficients (reference
    # radiative-transfer-problem.jl:25-27; zero by default)
    def absorption_coefficient(self, x4, nu):
        return torch.zeros(x4.shape[:-1], dtype=x4.dtype, device=x4.device)

    def emission_coefficient(self, x4, nu):
        return torch.zeros(x4.shape[:-1], dtype=x4.dtype, device=x4.device)

    def inner_radius(self):
        return self.inner_r

    def outer_radius(self):
        return self.outer_r


def _gtol_error(gtol, x4):
    return gtol * torch.abs(x4[..., 1])


class ThinDisc(AbstractAccretionGeometry):
    """Geometrically-thin equatorial annulus; ``inner_r`` and ``outer_r`` are
    registered 0-d buffers (on the card unless ``device`` says otherwise)."""

    def __init__(self, inner_r=0.0, outer_r=500.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._buffers_from(dtype, device, inner_r=inner_r, outer_r=outer_r)

    def distance_to_disc(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        inside = (rho >= self.inner_r) & (rho <= self.outer_r)
        d = spinaxis_project(x4) - _gtol_error(gtol, x4)
        return torch.where(inside, d, torch.ones_like(d))

    def crossing_indicator(self, x4):
        return spinaxis_project(x4, signed=True)

    def is_hit(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        return (rho >= self.inner_r) & (rho <= self.outer_r)

    def crossing_indicator_c(self, t, r, th, ph):
        return r * torch.cos(th)

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        rho = r * torch.abs(torch.sin(th))
        return (rho >= self.inner_r) & (rho <= self.outer_r)


class WarpedThinDisc(AbstractAccretionGeometry):
    """Thin disc with scale height z = f(ρ) (signed), ``f`` a callable of
    tensors (reference thin-disc.jl:31-65)."""

    def __init__(self, f, inner_r=0.0, outer_r=500.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self.f = f
        self._buffers_from(dtype, device, inner_r=inner_r, outer_r=outer_r)

    def distance_to_disc(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        inside = (rho >= self.inner_r) & (rho <= self.outer_r)
        h = self.f(rho)
        z = spinaxis_project(x4, signed=True)
        d = torch.abs(h - z) - _gtol_error(gtol, x4)
        return torch.where(inside, d, torch.ones_like(d))

    def crossing_indicator(self, x4):
        rho = equatorial_project(x4)
        return spinaxis_project(x4, signed=True) - self.f(rho)

    def is_hit(self, x4, gtol=1e-2):
        rho = equatorial_project(x4)
        return (rho >= self.inner_r) & (rho <= self.outer_r)


class DatumPlane(AbstractAccretionGeometry):
    """Plane at constant height; no underside, no gtol widening. ``height``
    is a registered buffer: 0-d for one plane, or (N,) for one plane per ray
    (the thick-disc transfer functions, which the CUDA integrator does not
    take)."""

    def __init__(self, height=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._buffers_from(dtype, device, height=height)

    def inner_radius(self):
        return 0.0

    def distance_to_disc(self, x4, gtol=1e-2):
        return spinaxis_project(x4, signed=True) - self.height

    def crossing_indicator(self, x4):
        return spinaxis_project(x4, signed=True) - self.height

    def crossing_indicator_c(self, t, r, th, ph):
        return r * torch.cos(th) - self.height

    def is_hit_c(self, t, r, th, ph, gtol=1e-2):
        return torch.ones_like(r, dtype=torch.bool)


class AbstractThickAccretionDisc(AbstractAccretionGeometry):
    """Discs defined by a height cross-section h(ρ), ≤ 0 where undefined
    (reference `src/geometry/discs/thick-disc.jl:55-62`); optically thick."""

    optically_thin = False

    def cross_section(self, rho):  # pragma: no cover - interface
        raise NotImplementedError

    def distance_to_disc(self, x4, gtol=1e-2):
        h = self.cross_section(equatorial_project(x4))
        d = spinaxis_project(x4) - h
        return torch.where(h <= 0.0, torch.ones_like(d), d)

    def crossing_indicator(self, x4):
        # |z| − h has a sign change entering the disc volume; outside the
        # defined region, |z| − 0
        h = self.cross_section(equatorial_project(x4))
        return spinaxis_project(x4) - torch.clamp(h, min=0.0)

    def is_hit(self, x4, gtol=1e-2):
        return self.cross_section(equatorial_project(x4)) > 0.0

    def xz_parameterize(self, rho):
        """(ρ, h(ρ)) surface curve in the poloidal plane (reference
        `xz_parameterize`, thick-disc.jl:54)."""
        return torch.stack(torch.broadcast_tensors(rho, self.cross_section(rho)), dim=-1)

    def cartesian_tangent_vector(self, rho):
        """Unit tangent of the surface in cartesian (x, y, z) at azimuth 0,
        by forward mode through the cross-section (reference
        `_cartesian_tangent_vector`, thick-disc.jl:64-71)."""
        rho = _as_float(rho, self)
        _, grad = torch.func.jvp(self.xz_parameterize, (rho,), (torch.ones_like(rho),))
        v = torch.stack([grad[..., 0], torch.zeros_like(rho), grad[..., 1]], dim=-1)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def cartesian_surface_normal(self, rho, phi=None):
        """Outward unit surface normal: the tangent rotated 90° about φ̂,
        optionally rotated to azimuth φ about the spin axis (reference
        `_cartesian_surface_normal`, thick-disc.jl:73-82)."""
        t = self.cartesian_tangent_vector(rho)
        n = torch.stack([-t[..., 2], t[..., 1], t[..., 0]], dim=-1)
        if phi is None:
            return n
        phi = torch.as_tensor(phi, dtype=n.dtype, device=n.device)
        c, s = torch.cos(phi), torch.sin(phi)
        return torch.stack([c * n[..., 0] - s * n[..., 1], s * n[..., 0] + c * n[..., 1], n[..., 2]], dim=-1)


def _as_float(rho, geometry):
    """``rho`` as a float tensor on the geometry's device."""
    buf = next(geometry.buffers(), None)
    if isinstance(rho, torch.Tensor) and rho.is_floating_point():
        return rho
    if buf is None:
        return torch.as_tensor(rho, dtype=torch.float64)
    return torch.as_tensor(rho, dtype=buf.dtype, device=buf.device)


class ThickDisc(AbstractThickAccretionDisc):
    """Custom cross-section disc, ``f`` a callable of tensors (reference
    thick-disc.jl:1-53)."""

    def __init__(self, f, inner_r=0.0, outer_r=math.inf, *, dtype=torch.float64, device=None):
        super().__init__()
        self.f = f
        self._buffers_from(dtype, device, inner_r=inner_r, outer_r=outer_r)

    def cross_section(self, rho):
        return self.f(rho)


class ShakuraSunyaev(AbstractThickAccretionDisc):
    """Shakura & Sunyaev (1973) α-disc: H = 3/(2η)·(Ṁ/Ṁ_Edd)(1 − √(r_isco/ρ)),
    total thickness 2H (reference `src/geometry/discs/shakura-sunyaev.jl`).

    Construct via `ShakuraSunyaev.from_metric(m, eddington_ratio=0.3)`: the
    radiative efficiency defaults to 1 − E_isco."""

    def __init__(self, mdot_over_edd=0.3, inv_eta=1.0 / 0.057, inner_r=6.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self._buffers_from(dtype, device, mdot_over_edd=mdot_over_edd, inv_eta=inv_eta, inner_r=inner_r)

    @staticmethod
    def from_metric(m, eddington_ratio=0.3, eta=None, contra_rotating=False, *, dtype=torch.float64):
        """On the metric's device."""
        from gradus_tpu_torch.orbits import CircularOrbits
        from gradus_tpu_torch.orbits.special_radii import isco as _isco

        r_isco = _isco(m)
        if eta is None:
            eta = 1.0 - CircularOrbits.energy(m, r_isco, contra_rotating=contra_rotating)
        return ShakuraSunyaev(eddington_ratio, 1.0 / eta, r_isco, dtype=dtype, device=r_isco.device)

    def cross_section(self, rho):
        h = 3.0 * self.inv_eta * self.mdot_over_edd * (1.0 - torch.sqrt(self.inner_r / torch.clamp(rho, min=1e-12)))
        return torch.where(rho < self.inner_r, -0.0, h)


class EllipticalDisc(AbstractAccretionGeometry):
    """Ellipse cross-section disc (reference discs.jl:57-72)."""

    def __init__(self, inner_r, semi_major, semi_minor, *, dtype=torch.float64, device=None):
        super().__init__()
        self._buffers_from(dtype, device, inner_r=inner_r, semi_major=semi_major, semi_minor=semi_minor)

    def _half_height(self, r):
        arg = torch.clamp(1.0 - (r / self.semi_major) ** 2, min=0.0)
        return torch.sqrt(arg * self.semi_minor**2)

    def distance_to_disc(self, x4, gtol=1e-2):
        r = x4[..., 1]
        inside = (r >= self.inner_r) & (r <= self.semi_major)
        h = torch.abs(r * torch.cos(x4[..., 2]))
        d = h - self._half_height(r) - _gtol_error(gtol, x4)
        return torch.where(inside, d, torch.ones_like(d))

    def crossing_indicator(self, x4):
        r = x4[..., 1]
        return torch.abs(r * torch.cos(x4[..., 2])) - self._half_height(r)

    def is_hit(self, x4, gtol=1e-2):
        r = x4[..., 1]
        return (r >= self.inner_r) & (r <= self.semi_major)


class PrecessingDisc(AbstractAccretionGeometry):
    """Wrapper rotating a disc by Euler angles (β about x after γ about z)
    (reference discs.jl:74-96)."""

    def __init__(self, disc, beta=0.0, gamma=0.0, *, dtype=torch.float64, device=None):
        super().__init__()
        self.disc = disc
        self._buffers_from(dtype, device, beta=beta, gamma=gamma)

    def inner_radius(self):
        return self.disc.inner_radius()

    def _rotated(self, x4):
        b = -self.beta
        theta = x4[..., 2]
        phi = x4[..., 3] - self.gamma
        # cartesian direction in the rotated frame (Rx(-β))
        px = torch.sin(theta) * torch.sin(phi)
        py = torch.sin(theta) * torch.cos(phi)
        pz = torch.cos(theta)
        y_ = torch.cos(b) * py + torch.sin(b) * pz
        z_ = -torch.sin(b) * py + torch.cos(b) * pz
        theta_p = torch.atan2(torch.sqrt(px**2 + y_**2), z_)
        phi_p = torch.atan2(y_, px)
        return torch.stack([x4[..., 0], x4[..., 1], theta_p, phi_p], dim=-1)

    def distance_to_disc(self, x4, gtol=1e-2):
        return self.disc.distance_to_disc(self._rotated(x4), gtol=gtol)

    def crossing_indicator(self, x4):
        return self.disc.crossing_indicator(self._rotated(x4))

    def is_hit(self, x4, gtol=1e-2):
        return self.disc.is_hit(self._rotated(x4), gtol=gtol)


class PolishDoughnut(AbstractThickAccretionDisc):
    """Rotationally-supported torus of constant specific angular momentum ℓ
    (Abramowicz-style polish doughnut): the cross-section h(ρ) is a
    40-step bisection on the equipotential W(ρ, z) = W(r_cusp, 0), with the
    Schwarzschild closed form of W, or the given ``metric``'s components."""

    def __init__(
        self,
        M=1.0,
        ell=8.0,
        r_cusp=10.0,
        inner_r=0.0,
        outer_r=math.inf,
        z_max=50.0,
        metric=None,
        *,
        dtype=torch.float64,
        device=None,
    ):
        super().__init__()
        if metric is not None and device is None:
            device = metric.device
        self.metric = metric
        self._buffers_from(
            dtype, device, M=M, ell=ell, r_cusp=r_cusp, inner_r=inner_r, outer_r=outer_r, z_max=z_max
        )

    def _potential(self, rho, z):
        """W = ½ ln(u_t²), u_t² = (g_tφ² − g_tt g_φφ)/(g_φφ + 2ℓ g_tφ + ℓ² g_tt)
        (Abramowicz-Jaroszyński-Sikora), from ``metric`` when set, else the
        Schwarzschild closed form."""
        R = torch.sqrt(rho * rho + z * z)
        if self.metric is not None:
            R_c = torch.clamp(R, min=1e-6)
            theta = torch.atan2(rho, z)
            g = self.metric.components(R_c, theta)
            gtt, gpp, gtp = g[..., 0], g[..., 3], g[..., 4]
            denom = gpp + 2.0 * self.ell * gtp + self.ell**2 * gtt
            ut2 = (gtp * gtp - gtt * gpp) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
            return torch.where(denom > 0, 0.5 * torch.log(torch.clamp(ut2, min=1e-12)), math.inf)
        sin2 = torch.where(R > 0, (rho / torch.clamp(R, min=1e-12)) ** 2, 1.0)
        f = 1.0 - 2.0 * self.M / torch.maximum(R, 2.2 * self.M)
        denom = torch.clamp(R * R * sin2 - self.ell**2 * f, min=1e-12)
        ut2 = R * R * sin2 * f / denom
        return 0.5 * torch.log(torch.clamp(ut2, min=1e-12))

    def cross_section(self, rho):
        W_s = self._potential(self.r_cusp, torch.zeros_like(self.r_cusp))
        in_disc = self._potential(rho, torch.zeros_like(rho)) < W_s
        a = torch.zeros_like(rho)
        b = torch.broadcast_to(self.z_max, rho.shape)
        for _ in range(40):
            mid = 0.5 * (a + b)
            below = self._potential(rho, mid) < W_s
            a, b = torch.where(below, mid, a), torch.where(below, b, mid)
        return torch.where(in_disc, 0.5 * (a + b), -1.0)


class CompositeGeometry(AbstractAccretionGeometry):
    """Tuple of geometries; distance = elementwise minimum (reference
    `src/geometry/composite.jl`)."""

    def __init__(self, geometries):
        super().__init__()
        self.geometries = nn.ModuleList(geometries)

    def inner_radius(self):
        return min(float(g.inner_radius()) for g in self.geometries)

    def distance_to_disc(self, x4, gtol=1e-2):
        return torch.stack([g.distance_to_disc(x4, gtol=gtol) for g in self.geometries]).amin(dim=0)

    def crossing_indicator(self, x4):
        # the signed indicator of the component closest to crossing
        inds = torch.stack([g.crossing_indicator(x4) for g in self.geometries])
        idx = torch.argmin(torch.abs(inds), dim=0)
        return torch.gather(inds, 0, idx[None])[0]

    def is_hit(self, x4, gtol=1e-2):
        hits = [g.is_hit(x4, gtol=gtol) & (torch.abs(g.crossing_indicator(x4)) < 1e-6) for g in self.geometries]
        return torch.stack(hits).any(dim=0)


def datumplane(disc: AbstractThickAccretionDisc, rho):
    """Datum plane at the disc's cross-section height at ρ (reference
    datum-plane.jl:14-18); one plane per element of ``rho``."""
    h = disc.cross_section(_as_float(rho, disc))
    return DatumPlane(h, dtype=h.dtype, device=h.device)


def _interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)`: linear between sorted knots, the end values
    outside."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class PolishDoughnutFW(AbstractThickAccretionDisc):
    """Fuerst & Wu (2004, 2007) / Younsi et al. (2012) torus, the reference's
    (rₖ, n) parameterisation (`src/geometry/discs/polish-doughnut.jl:1-124`):
    the isobar curve ``rs``, ``zs`` (sorted by radius), whose linear
    interpolant is the cross-section. Construct with
    `polish_doughnut_fw(m, r_k, n)`."""

    def __init__(self, rs, zs, r_k=12.0, n=0.21, *, dtype=torch.float64, device=None):
        super().__init__()
        self._buffers_from(dtype, device, rs=rs, zs=zs, r_k=r_k, n=n)

    def cross_section(self, rho):
        h = _interp(rho, self.rs, self.zs)
        inside = (rho >= self.rs[0]) & (rho <= self.rs[-1])
        return torch.where(inside, h, 0.0)

    def inner_radius(self):
        return self.rs[0]

    def outer_radius(self):
        return self.rs[-1]


def polish_doughnut_fw(
    m,
    r_k: float = 12.0,
    n: float = 0.21,
    *,
    init_r: float = 5.0,
    lam_max: float = 40.0,
    dt: float = 5e-2,
    newton_iters: int = 40,
) -> PolishDoughnutFW:
    """The Fuerst-Wu (rₖ, n) doughnut of a Kerr metric (reference
    `PolishDoughnut` constructor and `__PolishDoughnut` module,
    polish-doughnut.jl:1-124): the innermost radius by Newton on dE/dr = 0,
    then the isobar curve by fixed-step RK4 of the Younsi (2012) eq. 30-31
    differential, cut where z < 0. In f64 on the metric's device."""
    from gradus_tpu_torch.orbits import CircularOrbits

    if not hasattr(m, "a"):
        raise ValueError(
            "the Fuerst-Wu isobar differential is Kerr-specific "
            "(reference isobar_differential, polish-doughnut.jl:39-51)"
        )
    kw = dict(dtype=torch.float64, device=m.device)
    half_pi = torch.tensor(math.pi / 2, **kw)

    def Omega(rho):
        return CircularOrbits.Omega(m, (rho, torch.full_like(rho, math.pi / 2))) * (r_k / rho) ** n

    def orbital_energy(r):
        # reference `orbital_energy` (polish-doughnut.jl:21-28)
        Om = Omega(r)
        g = m.components(r, half_pi)
        return -(g[..., 0] + g[..., 4] * Om) / torch.sqrt(-g[..., 0] - 2 * g[..., 4] * Om - g[..., 3] * Om**2)

    dE = torch.func.grad(orbital_energy)
    d2E = torch.func.grad(dE)

    r_in = torch.tensor(float(init_r), **kw)
    for _ in range(newton_iters):
        r_in = r_in - dE(r_in) / d2E(r_in)
    r_in = float(r_in)

    M, a = m.M, m.a

    def isobar_rhs(u):
        # Younsi et al. (2012) eqs. 30-31 (reference Ψ₁/Ψ₂ + differential)
        r, th = u[0], u[1]
        sigma = r * r + a * a * torch.cos(th) ** 2
        delta = r * r + a * a - 2.0 * M * r
        rho = r * torch.sin(th)
        inv_om = 1.0 / Omega(rho)
        psi1 = M * ((sigma - 2 * r * r) / sigma**2) * (inv_om - a * torch.sin(th)) ** 2 + r * torch.sin(th) ** 2
        psi2 = torch.sin(2 * th) * ((M * r / sigma**2) * (a * inv_om - (r * r + a * a)) ** 2 + delta / 2)
        d = 1.0 / (torch.sqrt(delta * psi1**2 + psi2**2) * torch.sqrt(sigma / delta))
        return torch.stack([psi2 * d, -psi1 * d])

    u = torch.tensor([r_in, math.pi / 2], **kw)
    us = [u]
    for _ in range(int(lam_max / dt)):
        k1 = isobar_rhs(u)
        k2 = isobar_rhs(u + 0.5 * dt * k1)
        k3 = isobar_rhs(u + 0.5 * dt * k2)
        k4 = isobar_rhs(u + dt * (k3))
        u = u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        us.append(u)
    us = torch.stack(us).cpu().numpy()
    r = us[:, 0]
    z = np.cos(us[:, 1]) * r
    # keep the upper branch up to the first z < 0 crossing (reference
    # DiscreteCallback termination)
    neg = np.nonzero(z < 0)[0]
    stop = neg[0] if neg.size else z.shape[0]
    r, z = r[:stop], z[:stop]
    # z(r) must be single-valued for the interpolant: truncate at the first
    # radial turning point past the apex
    if r.size > 2:
        apex = int(np.argmax(z))
        turn = np.nonzero(np.diff(r[apex:]) < 0)[0]
        if turn.size:
            warnings.warn(
                "polish_doughnut_fw: overhanging (double-valued) isobar "
                "cross-section; truncating at the radial turning point",
                stacklevel=2,
            )
            r = r[: apex + turn[0] + 1]
            z = z[: apex + turn[0] + 1]
    order = np.argsort(r)
    r, z = r[order], z[order]
    # deduplicate for a strictly increasing interpolation grid
    keep = np.concatenate([[True], np.diff(r) > 1e-12])
    return PolishDoughnutFW(r[keep], z[keep], r_k, n, device=m.device)
