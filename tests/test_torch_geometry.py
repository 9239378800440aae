"""Parity of the port's disc geometries (`gradus_tpu_torch/geometry/discs.py`)
with the JAX reference's, in f64 on the CPU: every class's
`distance_to_disc`, `crossing_indicator`, `is_hit` and `cross_section` on
4,096 seeded points, the geometries carried across by
`interop.geometry_from_numpy`; the thick disc's tangent and normal and the
Fuerst-Wu doughnut (mirrors of tests/test_geometry_parity.py); and
`trace_geodesics` against a `ShakuraSunyaev` and a `PolishDoughnut` disc.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gradus_tpu.geometry.discs as jd  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.integrate.tracing import trace_geodesics as jax_trace  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

import gradus_tpu_torch.geometry.discs as td  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.interop import geometry_from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

N_POINTS = 4096
CPU = dict(dtype=torch.float64, device="cpu")
# XLA's CPU backend contracts a·b + c into fused multiply-adds; the
# reference is compiled with its LLVM passes at level 0, which keeps the
# arithmetic as written (tests/test_torch_trace_geodesics.py).
_NO_FMA = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_NO_FMA)(*args)


# the callable cross-sections, written once per package
WARP = (lambda rho: 0.05 * rho * jnp.sin(rho / 5.0), lambda rho: 0.05 * rho * torch.sin(rho / 5.0))
THICK = (lambda rho: 0.2 * rho - 1.0, lambda rho: 0.2 * rho - 1.0)


def _to_port(g):
    """The port's counterpart of JAX geometry ``g``, through interop."""
    return geometry_from_numpy(*_pair(g), device="cpu")


def _pair(g):
    kind = type(g).__name__
    if kind == "CompositeGeometry":
        return kind, {"geometries": [_pair(c) for c in g.geometries]}
    params = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if f.name == "f":
            params["f"] = {id(WARP[0]): WARP[1], id(THICK[0]): THICK[1]}[id(v)]
        elif f.name == "disc":
            params["disc"] = _pair(v)
        elif f.name == "metric":
            params["metric"] = None if v is None else ("KerrMetric", {"M": np.asarray(v.M), "a": np.asarray(v.a)})
        else:
            params[f.name] = np.asarray(v)
    return kind, params


def _geometries():
    jm = JaxKerr(M=1.0, a=0.998)
    return {
        "ThinDisc": jd.ThinDisc(2.0, 40.0),
        "WarpedThinDisc": jd.WarpedThinDisc(f=WARP[0], inner_r=3.0, outer_r=45.0),
        "DatumPlane": jd.DatumPlane(1.5),
        "ThickDisc": jd.ThickDisc(f=THICK[0], inner_r=0.0, outer_r=jnp.inf),
        "ShakuraSunyaev": jd.ShakuraSunyaev.from_metric(jm),
        "EllipticalDisc": jd.EllipticalDisc(inner_r=3.0, semi_major=30.0, semi_minor=5.0),
        "PrecessingDisc": jd.PrecessingDisc(jd.ThinDisc(0.0, 50.0), beta=0.3, gamma=0.5),
        "PolishDoughnut": jd.PolishDoughnut(),
        "PolishDoughnut_metric": jd.PolishDoughnut(ell=4.0, r_cusp=6.0, metric=JaxKerr(M=1.0, a=0.5)),
        "CompositeGeometry": jd.CompositeGeometry(
            (jd.ThinDisc(0.0, 20.0), jd.EllipticalDisc(inner_r=3.0, semi_major=30.0, semi_minor=5.0))
        ),
    }


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    return np.stack(
        [
            rng.uniform(0.0, 100.0, N_POINTS),
            rng.uniform(1.0, 60.0, N_POINTS),
            rng.uniform(0.0, math.pi, N_POINTS),
            rng.uniform(-math.pi, math.pi, N_POINTS),
        ],
        axis=-1,
    )


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.max(np.abs(want[np.isfinite(want)]), initial=1.0)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("name", list(_geometries()))
def test_geometry_methods_match_jax(name, points):
    """distance_to_disc (gtol 0 and 1e-2), crossing_indicator, is_hit and,
    for a thick disc, cross_section: to 1e-12 relative (of the largest
    value), booleans equal; the JAX side compiled without FMA contraction."""
    gj = _geometries()[name]
    gt = _to_port(gj)
    xj, xt = jnp.asarray(points), torch.as_tensor(points)
    for method, kw in (("distance_to_disc", {"gtol": 0.0}), ("distance_to_disc", {}), ("crossing_indicator", {}), ("is_hit", {})):
        want = _jit(lambda x, m=method, k=kw: getattr(gj, m)(x, **k), xj)
        _close(getattr(gt, method)(xt, **kw), want)
    if isinstance(gj, jd.AbstractThickAccretionDisc):
        rho = xj[:, 1] * jnp.abs(jnp.sin(xj[:, 2]))
        want = _jit(gj.cross_section, rho)
        _close(gt.cross_section(torch.tensor(np.asarray(rho))), want)
        assert isinstance(gt, td.AbstractThickAccretionDisc) and not gt.optically_thin


def test_datumplane_per_ray_heights_match_jax(points):
    """`datumplane(disc, ρ)` of a ShakuraSunyaev: one height per ray, and the
    plane's indicator at 1e-12."""
    gj = jd.ShakuraSunyaev.from_metric(JaxKerr(M=1.0, a=0.998))
    gt = _to_port(gj)
    rho = np.linspace(2.0, 40.0, N_POINTS)
    pj, pt = jd.datumplane(gj, jnp.asarray(rho)), td.datumplane(gt, torch.as_tensor(rho))
    _close(pt.height, pj.height)
    _close(pt.crossing_indicator(torch.as_tensor(points)), _jit(pj.crossing_indicator, jnp.asarray(points)))


def test_thick_disc_tangent_and_normal():
    """tests/test_geometry_parity.py::test_thick_disc_tangent_and_normal on
    the port, and the port's tangent and normal against the JAX ones."""
    d = td.ThickDisc(lambda rho: 0.1 * rho**2, 0.0, 50.0, device="cpu")
    rho = torch.tensor([1.0, 3.0, 7.5], dtype=torch.float64)
    t = d.cartesian_tangent_vector(rho)
    expect = torch.stack([torch.ones_like(rho), torch.zeros_like(rho), 0.2 * rho], dim=-1)
    expect = expect / torch.linalg.vector_norm(expect, dim=-1, keepdim=True)
    np.testing.assert_allclose(t.numpy(), expect.numpy(), atol=1e-12)
    n = d.cartesian_surface_normal(rho)
    np.testing.assert_allclose(torch.linalg.vector_norm(n, dim=-1).numpy(), 1.0, atol=1e-12)
    np.testing.assert_allclose((n * t).sum(-1).numpy(), 0.0, atol=1e-12)
    assert (n[:, 2] > 0).all()
    n_rot = d.cartesian_surface_normal(rho, phi=1.2)
    np.testing.assert_allclose(n_rot[:, 2].numpy(), n[:, 2].numpy(), atol=1e-12)
    np.testing.assert_allclose(torch.linalg.vector_norm(n_rot, dim=-1).numpy(), 1.0, atol=1e-12)

    jdisc = jd.ThickDisc(f=lambda r: 0.1 * r**2, inner_r=0.0, outer_r=50.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jdisc.cartesian_tangent_vector(jnp.asarray(rho.numpy()))), rtol=1e-12)
    np.testing.assert_allclose(
        n_rot.numpy(), np.asarray(jdisc.cartesian_surface_normal(jnp.asarray(rho.numpy()), phi=jnp.asarray(1.2))), rtol=1e-12, atol=1e-15
    )
    ss = td.ShakuraSunyaev.from_metric(KerrMetric(1.0, 0.9, device="cpu"))
    assert torch.isfinite(ss.cartesian_surface_normal(torch.tensor(8.0, dtype=torch.float64))).all()


def test_fuerst_wu_doughnut_matches_jax():
    """`polish_doughnut_fw` (a = 0.998, rₖ = 12, n = 0.21; RK4 steps of 0.1
    and 10 Newton iterations, where the defaults are 0.05 and 40, to keep
    the two constructors' ~25 s of eager autodiff in bounds): the isobar
    tables at 1e-9 against the JAX constructor's, the cross-section positive
    inside with one interior maximum and zero outside (the checks of
    tests/test_geometry_parity.py::test_fuerst_wu_doughnut)."""
    jm, tm = JaxKerr(M=1.0, a=0.998), KerrMetric(1.0, 0.998, device="cpu")
    kw = dict(r_k=12.0, n=0.21, dt=0.1, newton_iters=10)
    dj = jd.polish_doughnut_fw(jm, **kw)
    dt = td.polish_doughnut_fw(tm, **kw)
    assert dt.rs.shape == tuple(np.shape(dj.rs))
    np.testing.assert_allclose(dt.rs.numpy(), np.asarray(dj.rs), rtol=1e-9)
    np.testing.assert_allclose(dt.zs.numpy(), np.asarray(dj.zs), rtol=1e-9, atol=1e-9)
    r_in, r_out = float(dt.inner_radius()), float(dt.outer_radius())
    assert 1.0 < r_in < 12.0 and r_out > r_in + 5.0
    rho = torch.linspace(r_in + 1e-3, r_out - 1e-3, 200, dtype=torch.float64)
    h = dt.cross_section(rho)
    assert (h >= 0).all() and h.max() > 0.1
    assert 5 < int(h.argmax()) < 195
    assert float(dt.cross_section(torch.tensor(r_out + 1.0, dtype=torch.float64))) == 0.0
    _close(h, _jit(dj.cross_section, jnp.asarray(rho.numpy())), rtol=1e-9)


@pytest.mark.parametrize("name", ["ShakuraSunyaev", "PolishDoughnut"])
def test_trace_geodesics_thick_disc_matches_jax(name):
    """`trace_geodesics` against a thick disc on 64 rays (Kerr a = 0.998,
    r = 1000, i = 85°, λ ≤ 2200, impact parameters through the disc's
    radii): statuses identical, hits at 1e-9 relative (an azimuth near 0
    at 1e-9 absolute; measured ≤ 5e-12)."""
    jm, tm = JaxKerr(M=1.0, a=0.998), KerrMetric(1.0, 0.998, device="cpu")
    gj = _geometries()[name]
    gt = _to_port(gj)
    rng = np.random.default_rng(5)
    A = rng.uniform(-16.0, 16.0, 64)
    B = rng.uniform(-4.0, 4.0, 64)
    x = np.array([0.0, 1000.0, math.radians(85.0), 0.0])
    vj = jax_map_impact(jm, jnp.asarray(x), jnp.asarray(A), jnp.asarray(B))
    gpj = _jit(lambda v: jax_trace(jm, jnp.broadcast_to(jnp.asarray(x), v.shape), v, (0.0, 2200.0), geometry=gj), vj)
    xt = torch.as_tensor(x)
    vt = map_impact_parameters(tm, xt, torch.as_tensor(A), torch.as_tensor(B))
    gpt = trace_geodesics(tm, xt.expand_as(vt), vt, (0.0, 2200.0), geometry=gt)
    np.testing.assert_array_equal(gpt.status.numpy(), np.asarray(gpj.status))
    hit = gpt.status.numpy() == StatusCodes.IntersectedWithGeometry
    assert hit.sum() >= 8
    np.testing.assert_allclose(gpt.x.numpy()[hit], np.asarray(gpj.x)[hit], rtol=1e-9, atol=1e-9)
