"""Redshift point function (counterpart of `gradus_tpu/redshift.py`, the
analytic prograde-Kerr dispatch only).

The generic dot-product path needs the Keplerian and plunging disc
velocities of `orbits/circular.py` and `orbits/plunging.py`, which are not
ported yet; it raises `NotImplementedError`.
"""

from __future__ import annotations

from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["redshift_pointfunction"]


def redshift_pointfunction(
    m: AbstractMetric, x_obs=None, contra_rotating=False, analytic: str = "auto"
):
    """PointFunction computing g = E_obs / E_disc.

    ``analytic``: "auto" and "always" dispatch a prograde `KerrMetric` to the
    closed-form Cunningham machinery (`redshift_analytic.py`); "always"
    raises `ValueError` for anything else, as the JAX package does."""
    from gradus_tpu_torch.metrics.kerr import KerrMetric

    is_kerr = type(m) is KerrMetric and not contra_rotating
    if analytic == "always" and not is_kerr:
        raise ValueError("analytic='always' requires a prograde KerrMetric")
    if analytic in ("auto", "always") and is_kerr:
        from gradus_tpu_torch.redshift_analytic import analytic_redshift_pointfunction

        pf = analytic_redshift_pointfunction(m, x_obs)
        pf.is_analytic_kerr = True
        return pf
    raise NotImplementedError(
        "the generic dot-product redshift (non-Kerr or contra-rotating discs, "
        "or analytic='never') needs orbits/circular.py and orbits/plunging.py, "
        "which are not ported yet (ROADMAP queue A)"
    )
