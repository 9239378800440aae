"""Triangle meshes, the polygon utilities and the coordinate helpers of
`utils/linalg.py` against the JAX package's, in f64 on the CPU:
tests/test_mesh_tables.py's `test_jsf_algorithm_basic`,
`test_mesh_render_hit` and `test_mesh_file_loaders`,
tests/test_geometry_parity.py::test_polygon_utils and
tests/test_flux_coordinates.py's oblate-spheroid case, each also held to
the JAX package's results on the same inputs."""

import dataclasses
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu as jgt  # noqa: E402
from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import MeshAccretionGeometry as JaxMesh  # noqa: E402
from gradus_tpu.geometry import jsf_segment_triangle as jax_jsf  # noqa: E402
from gradus_tpu.geometry import polygons as jax_polygons  # noqa: E402
from gradus_tpu.utils import linalg as jax_linalg  # noqa: E402

from gradus_tpu_torch.geometry import (  # noqa: E402
    MeshAccretionGeometry,
    in_polygon,
    jsf_segment_triangle,
    orientation,
    polygon_area,
    polygon_barycenter,
)
from gradus_tpu_torch.integrate import StatusCodes, trace_geodesics  # noqa: E402
from gradus_tpu_torch.interop import from_numpy, mesh_from_numpy  # noqa: E402
from gradus_tpu_torch.utils import linalg  # noqa: E402

HIT = int(StatusCodes.IntersectedWithGeometry)


def _t(*a):
    return torch.tensor(a, dtype=torch.float64)


def test_jsf_algorithm_basic():
    """tests/test_mesh_tables.py's three segments, and 4,096 random
    segments against 64 random triangles equal to the JAX package's
    verdicts bit for bit."""
    v1, v2, v3 = _t(0.0, 0.0, 0.0), _t(1.0, 0.0, 0.0), _t(0.0, 1.0, 0.0)
    assert bool(jsf_segment_triangle(_t(0.2, 0.2, 1.0), _t(0.2, 0.2, -1.0), v1, v2, v3))
    assert not bool(jsf_segment_triangle(_t(2.0, 2.0, 1.0), _t(2.0, 2.0, -1.0), v1, v2, v3))
    assert not bool(jsf_segment_triangle(_t(0.2, 0.2, 1.0), _t(0.2, 0.2, 0.5), v1, v2, v3))
    # the back face: one-sided, as the reference
    assert not bool(jsf_segment_triangle(_t(0.2, 0.2, -1.0), _t(0.2, 0.2, 1.0), v1, v2, v3))
    rng = np.random.default_rng(4)
    q1, q2 = rng.uniform(-2, 2, (2, 4096, 1, 3))
    tri = rng.uniform(-1.5, 1.5, (64, 3, 3))
    got = jsf_segment_triangle(*(torch.as_tensor(a) for a in (q1, q2, tri[:, 0], tri[:, 1], tri[:, 2])))
    ref = jax_jsf(*(jnp.asarray(a) for a in (q1, q2, tri[:, 0], tri[:, 1], tri[:, 2])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < got.numel()


def test_mesh_render_hit():
    """A 60 × 60 square at z = 0 (two triangles), Schwarzschild from
    r = 100, i = 60°: the ray at α = 9 hits it, the ray at α = 80 misses,
    as in the JAX test, with the statuses equal to the JAX package's (a
    ray ends at the end of the step whose chord crossed the mesh, which
    depends on the step sequence: the endpoints are not compared); and
    the chord test's verdicts on 512 random chords equal the JAX
    package's."""
    tri = np.array(
        [
            [[-30.0, -30.0, 0.0], [30.0, -30.0, 0.0], [30.0, 30.0, 0.0]],
            [[-30.0, -30.0, 0.0], [30.0, 30.0, 0.0], [-30.0, 30.0, 0.0]],
        ]
    )
    j0 = JaxMesh.from_triangles(tri)
    jmesh = JaxMesh(triangles=j0.triangles, bbox_min=j0.bbox_min - 1, bbox_max=j0.bbox_max + 1, proximity2=1e8)
    mesh = mesh_from_numpy({f.name: np.asarray(getattr(jmesh, f.name)) for f in dataclasses.fields(jmesh)}, device="cpu")
    t0 = MeshAccretionGeometry.from_triangles(tri, device="cpu")
    np.testing.assert_array_equal(t0.bbox_min.numpy(), np.asarray(j0.bbox_min))
    assert mesh.proximity2 == 1e8 and t0.proximity2 == 9.0
    jm = jgt.SchwarzschildMetric(M=1.0)
    tm = from_numpy("KerrMetric", dict(M=np.asarray(1.0), a=np.asarray(0.0)), device="cpu")
    x = jnp.array([0.0, 100.0, np.deg2rad(60.0), 0.0])
    v = jax_map_impact(jm, x, jnp.array([9.0, 80.0]), jnp.array([0.1, 0.1]))
    xs = jnp.broadcast_to(x, v.shape)
    ref = jgt.trace_geodesics(jm, xs, v, (0.0, 300.0), geometry=jmesh)
    gp = trace_geodesics(tm, torch.as_tensor(np.array(xs)), torch.as_tensor(np.array(v)), (0.0, 300.0), geometry=mesh)
    st = gp.status.numpy()
    assert st[0] == HIT and st[1] != HIT
    np.testing.assert_array_equal(st, np.asarray(ref.status))
    rng = np.random.default_rng(6)
    xa = np.stack([np.zeros(512), rng.uniform(20, 60, 512), rng.uniform(1.2, 1.9, 512), rng.uniform(0, 6.3, 512)], -1)
    xb = xa + rng.normal(0, 0.3, (512, 4)) * [0, 10, 1, 1]
    got = mesh.segment_hit(torch.as_tensor(xa), torch.as_tensor(xb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmesh.segment_hit(jnp.asarray(xa), jnp.asarray(xb))))
    assert got.any() and not got.all()


def test_mesh_file_loaders(tmp_path):
    """OBJ and STL (binary and ASCII) give the JAX package's triangle soup
    and bounding box (tests/test_mesh_tables.py's files)."""
    obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2/1 4/2/3 3//1\n"
    p_obj = tmp_path / "m.obj"
    p_obj.write_text(obj)
    g = MeshAccretionGeometry.from_file(p_obj, device="cpu")
    tris = g.triangles.numpy()
    assert tris.shape == (2, 3, 3)
    ref = JaxMesh.from_file(p_obj)
    np.testing.assert_array_equal(tris, np.asarray(ref.triangles))
    np.testing.assert_array_equal(g.bbox_max.numpy(), np.asarray(ref.bbox_max))

    buf = b"\0" * 80 + struct.pack("<I", len(tris))
    for t in tris.astype(np.float32):
        buf += struct.pack("<3f", 0, 0, 1)
        for v in t:
            buf += struct.pack("<3f", *v)
        buf += struct.pack("<H", 0)
    p_stl = tmp_path / "m.stl"
    p_stl.write_bytes(buf)
    np.testing.assert_allclose(MeshAccretionGeometry.from_file(p_stl, device="cpu").triangles.numpy(), tris)

    lines = ["solid x"]
    for t in tris:
        lines += ["facet normal 0 0 1", "outer loop"]
        lines += [f"vertex {v[0]} {v[1]} {v[2]}" for v in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid x")
    p_ascii = tmp_path / "ma.stl"
    p_ascii.write_text("\n".join(lines))
    np.testing.assert_allclose(MeshAccretionGeometry.from_stl(p_ascii, device="cpu").triangles.numpy(), tris)
    with pytest.raises(ValueError, match="unsupported"):
        MeshAccretionGeometry.from_file(tmp_path / "m.ply")


def test_polygon_utils():
    """tests/test_geometry_parity.py's square and triangle, and random
    convex polygons and points against the JAX package's."""
    sq = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], dtype=torch.float64)
    assert float(polygon_area(sq)) == pytest.approx(1.0)
    np.testing.assert_allclose(polygon_barycenter(sq).numpy(), [0.5, 0.5])
    tri = torch.tensor([[0.0, 0.0], [0.0, 2.0], [3.0, 0.0]], dtype=torch.float64)
    assert float(polygon_area(tri)) == pytest.approx(3.0)
    pts = torch.tensor([[0.5, 0.5], [1.5, 0.5], [0.99, 0.01], [-0.01, 0.5]], dtype=torch.float64)
    assert in_polygon(sq, pts).tolist() == [True, False, True, False]
    assert bool(in_polygon(tri, torch.tensor([0.5, 0.5], dtype=torch.float64)))

    rng = np.random.default_rng(8)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
    poly = np.stack([2 * np.cos(ang), 1.5 * np.sin(ang)], -1)
    p = rng.uniform(-2.5, 2.5, (16, 32, 2))
    np.testing.assert_allclose(float(polygon_area(poly)), float(jax_polygons.polygon_area(jnp.asarray(poly))), rtol=1e-14)
    np.testing.assert_allclose(
        polygon_barycenter(poly).numpy(), np.asarray(jax_polygons.polygon_barycenter(jnp.asarray(poly))), rtol=1e-14
    )
    got = in_polygon(poly, p).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_polygons.in_polygon(jnp.asarray(poly), jnp.asarray(p))))
    assert got.shape == (16, 32) and got.any() and not got.all()
    o = orientation(poly[0], poly[1], p).numpy()
    np.testing.assert_array_equal(o, np.asarray(jax_polygons.orientation(jnp.asarray(poly[0]), jnp.asarray(poly[1]), jnp.asarray(p))))


def test_linalg_coordinate_helpers():
    """`cartesian_to_spherical`, `cartesian_squared_distance` and
    `cartesian_distance` on random points, against the JAX package's at
    rtol 1e-13 (measured 2e-16)."""
    rng = np.random.default_rng(12)
    c = rng.normal(0, 10, (256, 3))
    np.testing.assert_allclose(
        linalg.cartesian_to_spherical(torch.as_tensor(c)).numpy(),
        np.asarray(jax_linalg.cartesian_to_spherical(jnp.asarray(c))),
        rtol=1e-13,
        atol=1e-15,
    )
    x1 = np.stack([np.zeros(256), rng.uniform(2, 50, 256), rng.uniform(0, np.pi, 256), rng.uniform(0, 6.3, 256)], -1)
    x2 = x1 + rng.normal(0, 1, (256, 4))
    for name in ("cartesian_squared_distance", "cartesian_distance"):
        got = getattr(linalg, name)(torch.as_tensor(x1), torch.as_tensor(x2)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jax_linalg, name)(jnp.asarray(x1), jnp.asarray(x2))), rtol=1e-13)
    # round trip through the spherical form
    back = linalg.spherical_to_cartesian(linalg.cartesian_to_spherical(torch.as_tensor(c))).numpy()
    np.testing.assert_allclose(back, c, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("a", [0.998, 0.5, 0.0])
def test_oblate_spheroid_to_spherical(a):
    """tests/test_flux_coordinates.py's pin ((1.02, 1.113) at a = 0.998 →
    r ≈ 1.3872, θ ≈ acos(0.8023)), and each spin on a grid of points
    against the JAX package's at rtol 1e-11 (measured 5.1e-13, where the
    formula for cos²θ cancels; a = 0 is the flat branch)."""
    if a == 0.998:
        r, theta = linalg.oblate_spheroid_to_spherical(1.02, 1.113, 0.998)
        np.testing.assert_allclose(float(r), 1.3872, atol=1e-3)
        np.testing.assert_allclose(float(theta), np.arccos(0.8023), atol=1e-3)
    xs, hs = np.meshgrid(np.linspace(0.1, 20.0, 17), np.linspace(0.05, 10.0, 13))
    got = linalg.oblate_spheroid_to_spherical(torch.as_tensor(xs), torch.as_tensor(hs), a)
    ref = jax_linalg.oblate_spheroid_to_spherical(jnp.asarray(xs), jnp.asarray(hs), a)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11)
