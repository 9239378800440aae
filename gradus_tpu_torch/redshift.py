"""Redshift point function: g = E_obs / E_disc via metric dot products, with
Keplerian disc velocity outside the ISCO and the exact plunging velocity
inside (counterpart of `gradus_tpu/redshift.py`).

Prograde Kerr dispatches to the closed-form Cunningham machinery
(`redshift_analytic.py`); every other metric, and contra-rotating discs,
take the dot-product path (reference `_redshift_dotproduct`,
redshift.jl:204-220). Conventions mirrored from the reference: observer
velocity v_obs = (1, 0, 0, 0), unnormalized; the plunging radial velocity's
sign is flipped because photons are traced backwards from the observer.
The contractions are elementwise sums (`geodesics/tetrads.py::dotproduct`),
so no TF32 matmul can reach them.
"""

from __future__ import annotations

import math

import torch

from gradus_tpu_torch.camera.pointfns import PointFunction
from gradus_tpu_torch.geodesics.tetrads import dotproduct
from gradus_tpu_torch.metrics.base import AbstractMetric
from gradus_tpu_torch.orbits.circular import CircularOrbits
from gradus_tpu_torch.orbits.plunging import interpolate_plunging_velocities
from gradus_tpu_torch.utils.linalg import equatorial_project

__all__ = [
    "disc_velocity",
    "keplerian_velocity_projector",
    "redshift_pointfunction",
    "interpolate_redshift",
]


def keplerian_velocity_projector(m: AbstractMetric, contra_rotating=False):
    """x4 ↦ disc fluid 4-velocity: Keplerian circular orbit outside the ISCO,
    plunging (E, L frozen at ISCO) inside
    (reference `_keplerian_velocity_projector`, circular-orbits.jl:155-170)."""
    plunge = interpolate_plunging_velocities(m, contra_rotating=contra_rotating)
    r_isco = plunge.r_isco

    def project(x4):
        r = equatorial_project(x4)
        # evaluate both branches at guarded radii to keep them finite
        v_kep = CircularOrbits.fourvelocity(
            m,
            (torch.maximum(r, r_isco), torch.full_like(r, math.pi / 2)),
            contra_rotating=contra_rotating,
        )
        vp = plunge(torch.minimum(r, r_isco))
        # backwards-tracing convention: reverse the radial component
        v_plunge = torch.cat([vp[..., :1], -vp[..., 1:2], vp[..., 2:]], dim=-1)
        return torch.where((r < r_isco)[..., None], v_plunge, v_kep)

    return project


disc_velocity = keplerian_velocity_projector


def redshift_pointfunction(
    m: AbstractMetric, x_obs=None, contra_rotating=False, analytic: str = "auto"
):
    """PointFunction computing g = (g_obs·v_init·u_obs)/(g_disc·v·u_disc).

    ``analytic``: "auto" dispatches prograde Kerr to the closed-form
    Cunningham machinery; "never" forces the generic dot-product path (the
    cross-check); "always" requires a prograde KerrMetric and raises
    `ValueError` otherwise, as the JAX package does."""
    from gradus_tpu_torch.metrics.kerr import KerrMetric

    is_kerr = type(m) is KerrMetric and not contra_rotating
    if analytic == "always" and not is_kerr:
        raise ValueError("analytic='always' requires a prograde KerrMetric")
    if analytic in ("auto", "always") and is_kerr:
        from gradus_tpu_torch.redshift_analytic import analytic_redshift_pointfunction

        pf = analytic_redshift_pointfunction(m, x_obs)
        pf.is_analytic_kerr = True
        return pf

    project = keplerian_velocity_projector(m, contra_rotating=contra_rotating)

    def f(m_, gp, max_time, **kw):
        v_disc = project(gp.x)
        g_disc = m.metric(gp.x)
        g_obs = m.metric(gp.x_init)
        v_obs = torch.zeros_like(gp.v_init)
        v_obs[..., 0] = 1.0
        E_disc = dotproduct(g_disc, gp.v, v_disc)
        E_obs = dotproduct(g_obs, gp.v_init, v_obs)
        return E_obs / E_disc

    pf = PointFunction(f)
    pf.is_analytic_kerr = False
    return pf


def interpolate_redshift(m: AbstractMetric, x_obs=None, **kwargs):
    """Reference-parity name (redshift.jl:246-276); the closed-form projector
    makes 'interpolation' exact."""
    return redshift_pointfunction(m, x_obs, **kwargs)
