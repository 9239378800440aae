"""Analytic Kerr redshift: the Cunningham (1975) machinery (counterpart of
`gradus_tpu/redshift_analytic.py`).

All formulas are Cunningham et al. (1975) appendix A, in Boyer-Lindquist
coordinates with G = c = 1:

- eⱽ = √(ΔΣ/A)                       (A2a)
- eᶲ = sin θ √(A/Σ)                  (A2b)
- ω  = 2aMr/A                        (A2c)
- Ωₑ = √M/(rₑ^{3/2} + a√M)           (A7b)
- Vₑ = (Ωₑ − ω) eᶲ/eⱽ                (A7b)
- Lₑ, γₑ, H, uᵗ, uʳ, uᶲ              (A11-A12, plunging gas)

Outside the ISCO the photon redshift is the closed form
g = eⱽ √(1 − Vₑ²) / (1 − λΩₑ) with λ = p_φ / (−p_t); inside it is the dot
product against the analytic plunging four-velocity (A12).
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.pointfns import PointFunction
from gradus_tpu_torch.geodesics.tetrads import dotproduct
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = [
    "e_nu",
    "e_phi",
    "omega",
    "Omega_e",
    "V_e",
    "L_e",
    "gamma_e",
    "H",
    "u_t",
    "u_r",
    "u_phi",
    "plunging_fourvelocity_analytic",
    "regular_pdotu_inv",
    "analytic_redshift_pointfunction",
]


def _Sigma(r, a, theta):
    return r * r + (a * torch.cos(theta)) ** 2


def _Delta(M, r, a):
    return r * r - 2 * M * r + a * a


def _A(M, r, a, theta):
    return (r * r + a * a) ** 2 - a * a * _Delta(M, r, a) * torch.sin(theta) ** 2


def e_nu(M, r, a, theta):
    """eⱽ = √(ΣΔ/A) (Cunningham A2a)."""
    return torch.sqrt(_Sigma(r, a, theta) * _Delta(M, r, a) / _A(M, r, a, theta))


def e_phi(M, r, a, theta):
    """eᶲ = sin θ √(A/Σ) (A2b)."""
    return torch.sin(theta) * torch.sqrt(_A(M, r, a, theta) / _Sigma(r, a, theta))


def omega(M, r, a, theta):
    """Frame-dragging ω = 2aMr/A (A2c)."""
    return 2 * a * M * r / _A(M, r, a, theta)


def Omega_e(M, r, a):
    """Keplerian Ωₑ = √M/(r^{3/2} + a√M) (A7b)."""
    return torch.sqrt(M) / (r**1.5 + a * torch.sqrt(M))


def V_e(M, r, a, theta):
    """LNRF velocity Vₑ = (Ωₑ − ω) eᶲ/eⱽ (A7b)."""
    return (Omega_e(M, r, a) - omega(M, r, a, theta)) * e_phi(M, r, a, theta) / e_nu(
        M, r, a, theta
    )


def L_e(M, rms, a):
    """ISCO specific angular momentum (A11b)."""
    return (
        torch.sqrt(M)
        * (rms**2 - 2 * a * torch.sqrt(M * rms) + a**2)
        / (rms**1.5 - 2 * M * torch.sqrt(rms) + a * torch.sqrt(M))
    )


def H(M, rms, r, a):
    """(2Mr − aLₑ)/Δ (A12e)."""
    return (2 * M * r - a * L_e(M, rms, a)) / _Delta(M, r, a)


def gamma_e(M, rms):
    """γₑ = √(1 − 2M/(3 rms)) (A11c)."""
    return torch.sqrt(1 - (2 * M) / (3 * rms))


def u_r(M, rms, r):
    """Plunging uʳ (A12b) — negative (infalling)."""
    return -torch.sqrt((2 * M) / (3 * rms)) * (rms / r - 1) ** 1.5


def u_phi(M, rms, r, a):
    """Plunging uᶲ (A12c)."""
    return gamma_e(M, rms) / r**2 * (L_e(M, rms, a) + a * H(M, rms, r, a))


def u_t(M, rms, r, a):
    """Plunging uᵗ (A12b)."""
    return gamma_e(M, rms) * (1 + 2 * M * (1 + H(M, rms, r, a)) / r)


def plunging_fourvelocity_analytic(M, rms, r, a):
    """Cunningham A12 plunging gas four-velocity. The radial component is
    returned POSITIVE (+|uʳ|): photons are traced backwards from the
    observer, so the disc velocity enters as (uᵗ, −uʳ, 0, uᶲ) with uʳ < 0."""
    return torch.stack(
        torch.broadcast_tensors(
            u_t(M, rms, r, a),
            -u_r(M, rms, r),
            torch.zeros_like(r),
            u_phi(M, rms, r, a),
        ),
        dim=-1,
    )


def regular_pdotu_inv(lam, M, r, a, theta):
    """g = eⱽ√(1−Vₑ²)/(1 − λΩₑ) for Keplerian gas."""
    return (e_nu(M, r, a, theta) * torch.sqrt(1 - V_e(M, r, a, theta) ** 2)) / (
        1 - lam * Omega_e(M, r, a)
    )


def analytic_redshift_pointfunction(m, x_obs=None):
    """Analytic-Kerr redshift PointFunction.

    Keplerian branch: closed-form `regular_pdotu_inv` with the photon's
    conserved λ = p_φ/(−p_t) evaluated at the observer (v_obs = (1,0,0,0),
    unnormalized), so E_obs cancels exactly. Plunging branch: dot product
    against the Cunningham A12 four-velocity."""
    from gradus_tpu_torch.orbits.special_radii import isco as _isco

    M = m.M
    a = m.a
    rms = _isco(m)

    def f(m_, gp, max_time, **kw):
        r = equatorial_project(gp.x)
        g_disc = m.metric(gp.x)
        g_obs = m.metric(gp.x_init)
        # conserved photon quantities from the observer-side state
        p_init = (g_obs * gp.v_init[..., None, :]).sum(dim=-1)
        E_ph = -p_init[..., 0]
        lam = p_init[..., 3] / E_ph

        # --- Keplerian branch (closed form) --------------------------------
        g_kep = regular_pdotu_inv(
            lam, M, torch.maximum(r, rms), a, torch.full_like(r, math.pi / 2)
        )

        # --- plunging branch ----------------------------------------------
        v_plunge = plunging_fourvelocity_analytic(M, rms, torch.minimum(r, rms), a)
        E_disc = dotproduct(g_disc, gp.v, v_plunge)
        v_obs = torch.zeros_like(gp.v_init)
        v_obs[..., 0] = 1.0
        E_obs = dotproduct(g_obs, gp.v_init, v_obs)
        g_plunge = E_obs / E_disc

        return torch.where(r < rms, g_plunge, g_kep)

    return PointFunction(f)
