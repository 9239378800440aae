"""The first-order (Carter/Mino) Kerr tracer, the radiative-transfer trace
and the winding count against the JAX package's, in f64 on the CPU:
tests/test_first_order.py's two tests and tests/test_rt_windings.py's two,
each also held to the JAX package's results on the same rays.

Disc hits are polished, so their radii and times are compared (the
measured gap beside each bound); where a ray ends at a step's end
(the Mino tracer's λ limit, a chart bound) the endpoint depends on the
step sequence, which differs by roundoff between the packages, and only
the status is compared.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.integrate.tracing import trace_radiative_transfer as jax_rt  # noqa: E402
from gradus_tpu.integrate.tracing import trace_windings as jax_windings  # noqa: E402
from gradus_tpu.metrics.kerr_first_order import KerrSpacetimeFirstOrder as JaxFO  # noqa: E402
from gradus_tpu.metrics.kerr_first_order import trace_geodesics_first_order as jax_fo_trace  # noqa: E402

from gradus_tpu_torch.geometry import AbstractThickAccretionDisc, ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import (  # noqa: E402
    StatusCodes,
    trace_geodesics,
    trace_radiative_transfer,
    trace_windings,
)
from gradus_tpu_torch.interop import from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import carter_constants, trace_geodesics_first_order  # noqa: E402

HIT = int(StatusCodes.IntersectedWithGeometry)


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _rays(jm, x, al, be):
    v = jax_map_impact(jm, jnp.asarray(x), jnp.asarray(al, float), jnp.asarray(be, float))
    xs = jnp.broadcast_to(jnp.asarray(x), v.shape)
    return xs, v, torch.as_tensor(np.array(xs)), torch.as_tensor(np.array(v))


def test_carter_constants_conserved():
    """E, L, Q at the endpoint of the port's second-order trace match the
    initial values (tests/test_first_order.py's bounds)."""
    jm = JaxFO(M=1.0, a=0.9)
    tm = from_numpy("KerrSpacetimeFirstOrder", _params(jm), device="cpu")
    x = [0.0, 100.0, 1.2, 0.0]
    _, _, xs, v = _rays(jm, x, [5.0], [3.0])
    gp = trace_geodesics(tm, xs[0], v[0], (0.0, 150.0))
    E0, L0, Q0 = carter_constants(tm, gp.x_init, gp.v_init)
    E1, L1, Q1 = carter_constants(tm, gp.x, gp.v)
    np.testing.assert_allclose(float(E1), float(E0), rtol=1e-7)
    np.testing.assert_allclose(float(L1), float(L0), rtol=1e-7)
    np.testing.assert_allclose(float(Q1), float(Q0), rtol=1e-5, atol=1e-8)


def test_first_order_matches_ad_disc_hits():
    """The flagship camera's four rays (a = 0.998, ThinDisc(0, 50)): the
    port's first-order tracer against its second-order one (statuses equal,
    hit r and t at rtol 5e-3, as the JAX test), and against the JAX
    package's first-order tracer (statuses equal, hit r and t at rtol 1e-5:
    measured 1.6e-6, the two packages' step sequences over ~10³ of Mino
    time at the f64 tolerances; the velocities at atol 2e-5: measured
    5.0e-6), with a ray that reaches the λ limit (NoStatus)."""
    jm = JaxFO(M=1.0, a=0.998)
    tm = from_numpy("KerrSpacetimeFirstOrder", _params(jm), device="cpu")
    tk = from_numpy("KerrMetric", _params(jm), device="cpu")
    d = ThinDisc(0.0, 50.0, device="cpu")
    x = [0.0, 1000.0, np.deg2rad(75.0), 0.0]
    xs_j, v_j, xs, v = _rays(jm, x, [6.0, -8.0, 15.0, 30.0, 80.0], [2.0, 2.0, 2.0, 2.0, 2.0])
    gp_ad = trace_geodesics(tk, xs, v, (0.0, 2000.0), geometry=d)
    gp_fo = trace_geodesics_first_order(tm, xs, v, (0.0, 2000.0), geometry=d)
    ref = jax_fo_trace(jm, xs_j, v_j, (0.0, 2000.0), geometry=jgt.ThinDisc(0.0, 50.0))
    st = gp_fo.status.numpy()
    np.testing.assert_array_equal(gp_ad.status.numpy(), st)
    np.testing.assert_array_equal(np.asarray(ref.status), st)
    hit = st == HIT
    assert hit.sum() >= 3 and st[-1] == int(StatusCodes.NoStatus)
    for k in (0, 1):  # t and r
        np.testing.assert_allclose(gp_fo.x[hit, k].numpy(), gp_ad.x[hit, k].numpy(), rtol=5e-3)
        np.testing.assert_allclose(gp_fo.x[hit, k].numpy(), np.asarray(ref.x)[hit, k], rtol=1e-5)
    np.testing.assert_allclose(gp_fo.v[hit].numpy(), np.asarray(ref.v)[hit], rtol=0, atol=2e-5)
    # the λ limit: the carried affine parameter reached λ1 = 2000
    assert 2000.0 <= float(gp_fo.lam_max[-1]) < 2100.0


def test_windings_flat_vs_orbiting():
    """Schwarzschild from r = 1000, θ = π/2 − 0.3: the wide ray (α = 30)
    crosses the equatorial plane once, the near-critical one (α = 5.2)
    at least twice; both counts equal the JAX package's."""
    jm = jgt.SchwarzschildMetric(M=1.0)
    tm = from_numpy("KerrMetric", dict(M=np.asarray(1.0), a=np.asarray(0.0)), device="cpu")
    x = [0.0, 1000.0, np.pi / 2 - 0.3, 0.0]
    xs_j, v_j, xs, v = _rays(jm, x, [30.0, 5.2], [0.0, 0.0])
    _, w = trace_windings(tm, xs, v, (0.0, 3000.0))
    assert w.dtype == torch.int32
    assert int(w[0]) == 1 and int(w[1]) >= 2
    _, w_j = jax_windings(jm, xs_j, v_j, (0.0, 3000.0))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    gp1, w1 = trace_windings(tm, xs[1], v[1], (0.0, 3000.0))  # one ray
    assert w1.dim() == 0 and int(w1) == int(w[1]) and gp1.x.shape == (4,)


class _EmittingSlab(AbstractThickAccretionDisc):
    """Top-hat emitting slab |z| < 1 between ρ ∈ [8, 12], j_ν = 1
    (tests/test_rt_windings.py::_EmittingTorus)."""

    def __init__(self, inner_r=8.0, outer_r=12.0, *, dtype=torch.float64, device="cpu"):
        super().__init__()
        self._buffers_from(dtype, device, inner_r=inner_r, outer_r=outer_r)

    def cross_section(self, rho):
        return torch.where((rho > self.inner_r) & (rho < self.outer_r), 1.0, -1.0)

    def emission_coefficient(self, x4, nu):
        return torch.ones(x4.shape[:-1], dtype=x4.dtype, device=x4.device)


def test_radiative_transfer_through_slab():
    """A ray through the slab (α = 10) gains intensity and counts ≥ 2
    crossings; a ray far outside (α = 100) keeps I0 = 1; both against the
    JAX package's: the crossings equal, I at rtol 5e-3 (measured 5.6e-4).
    The solver counts a crossing at the end of the step that holds it, so
    the intensity is integrated from step end to step end, and where the
    two packages' step sequences part (by roundoff) it differs by a share
    of a step's path through the slab."""
    from test_rt_windings import _EmittingTorus

    jm = jgt.SchwarzschildMetric(M=1.0)
    tm = from_numpy("KerrMetric", dict(M=np.asarray(1.0), a=np.asarray(0.0)), device="cpu")
    x = [0.0, 500.0, np.deg2rad(75.0), 0.0]
    xs_j, v_j, xs, v = _rays(jm, x, [10.0, 100.0], [0.0, 0.0])
    gp = trace_radiative_transfer(tm, xs, v, (0.0, 1200.0), geometry=_EmittingSlab())
    I, crossings = gp.aux[:, 0], gp.aux[:, 1]
    assert int(crossings[0]) >= 2 and float(I[0]) > 1.0
    np.testing.assert_allclose(float(I[1]), 1.0, atol=1e-8)
    ref = jax_rt(jm, xs_j, v_j, (0.0, 1200.0), geometry=_EmittingTorus())
    np.testing.assert_array_equal(crossings.numpy(), np.asarray(ref.aux)[:, 1])
    np.testing.assert_allclose(I.numpy(), np.asarray(ref.aux)[:, 0], rtol=5e-3)
