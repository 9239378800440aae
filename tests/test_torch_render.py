"""The port's flagship slice end to end on the CPU: impact parameters →
`CudaTracer` (plain integrator on CPU tensors) → composed redshift point
function, against the same pipeline through the JAX reference's
`PallasTracer` (interpret mode); the render goldens of tests/test_render.py
through the port; parameter interop; and the port's independence of JAX.
"""

import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.impact import map_impact_parameters as jax_map_impact  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.integrate.pallas_solver import PallasTracer  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.redshift import redshift_pointfunction as jax_redshift  # noqa: E402

import gradus_tpu_torch  # noqa: E402
from gradus_tpu_torch.camera import ConstPointFunctions, map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer, StatusCodes  # noqa: E402
from gradus_tpu_torch.interop import from_numpy, geodesic_points_from_numpy  # noqa: E402
from gradus_tpu_torch.metrics import JohannsenMetric, KerrMetric  # noqa: E402


def _grid(width, height, alpha_lims, beta_lims, offset=1e-6):
    """Pixel impact parameters as `gradus_tpu/camera/render.py` lays them
    out: linspace + offset, α-major ravel."""
    alphas = np.linspace(alpha_lims[0], alpha_lims[1], width) + offset
    betas = np.linspace(beta_lims[0], beta_lims[1], height) + offset
    A = np.broadcast_to(alphas[:, None], (width, height)).ravel()
    B = np.broadcast_to(betas[None, :], (width, height)).ravel()
    return A, B


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _port_render(m, x_obs, geometry, lam_max, A, B, pf):
    x = torch.as_tensor(x_obs)
    v = map_impact_parameters(m, x, torch.as_tensor(A), torch.as_tensor(B))
    xs = torch.broadcast_to(x, v.shape)
    gp = CudaTracer(m, geometry=geometry)(xs, v, (0.0, lam_max))
    return pf(m, gp, lam_max)


def test_redshift_render_matches_jax_pallas_tracer():
    a, lam_max = 0.998, 2200.0
    x_obs = np.array([0.0, 1000.0, np.deg2rad(75.0), 0.0])
    A, B = _grid(30, 20, (-25.0, 25.0), (-15.0, 15.0))

    jm, jd = JaxKerr(M=1.0, a=a), JaxThinDisc(0.0, 40.0)
    xj = jnp.asarray(x_obs)
    vj = jax_map_impact(jm, xj, jnp.asarray(A), jnp.asarray(B))
    gp_j = PallasTracer(jm, geometry=jd, interpret=True)(jnp.broadcast_to(xj, vj.shape), vj, (0.0, lam_max))
    g_j = np.asarray(jax_redshift(jm, xj)(jm, gp_j, lam_max))
    g_j = np.where(np.asarray(gp_j.status) == StatusCodes.IntersectedWithGeometry, g_j, np.nan)

    m = from_numpy("KerrMetric", _params(jm), device="cpu")
    d = from_numpy("ThinDisc", _params(jd), device="cpu")
    pf = ConstPointFunctions.redshift(m, torch.as_tensor(x_obs)) @ ConstPointFunctions.filter_intersected()
    g_t = _port_render(m, x_obs, d, lam_max, A, B, pf).numpy()

    finite = np.isfinite(g_j)
    assert finite.sum() > 100
    np.testing.assert_array_equal(np.isfinite(g_t), finite)
    np.testing.assert_allclose(g_t[finite], g_j[finite], rtol=1e-6)
    # approaching side blueshifted, receding side redshifted
    assert np.nanmax(g_t) > 1.0 and np.nanmin(g_t) < 0.7


# tests/test_render.py: r = 100, i = 85°, 20×20, α,β ∈ (-9.5, 9.5), λ 200
_GOLDEN_X = np.array([0.0, 100.0, np.deg2rad(85.0), 0.0])


@pytest.mark.parametrize(
    "metric, outer_r, golden",
    [
        (KerrMetric, None, 9009.452876609641),
        (KerrMetric, 40.0, 38412.08347901267),
        (JohannsenMetric, None, 9009.448935932085),
    ],
    ids=["shadow", "thin_disc", "johannsen_shadow"],
)
def test_render_goldens_through_the_port(metric, outer_r, golden):
    m = metric(1.0, 0.0, device="cpu")
    d = None if outer_r is None else ThinDisc(0.0, outer_r, device="cpu")
    A, B = _grid(20, 20, (-9.5, 9.5), (-9.5, 9.5))
    img = _port_render(m, _GOLDEN_X, d, 200.0, A, B, ConstPointFunctions.shadow())
    assert math.isclose(float(torch.nansum(img)), golden, rel_tol=1e-1)


def test_interop_round_trip():
    jm, jd = JaxKerr(M=1.5, a=0.7), JaxThinDisc(inner_r=2.0, outer_r=60.0)
    m = from_numpy("KerrMetric", _params(jm), dtype=torch.float32, device="cpu")
    d = from_numpy("ThinDisc", _params(jd), device="cpu")
    assert m.M.dtype == torch.float32
    assert (float(m.M), float(m.a)) == (1.5, pytest.approx(0.7))
    assert (float(d.inner_r), float(d.outer_r)) == (2.0, 60.0)
    assert float(from_numpy("DatumPlane", {"height": np.asarray(1.0)}, device="cpu").height) == 1.0
    with pytest.raises(ValueError):
        from_numpy("ShakuraSunyaev", {"eddington_ratio": np.asarray(0.3)})

    rng = np.random.default_rng(3)
    fields = dict(
        status=np.array([0, 3], np.int32),
        lam_min=np.zeros(2),
        lam_max=rng.uniform(size=2),
        x_init=rng.normal(size=(2, 4)),
        v_init=rng.normal(size=(2, 4)),
        x=rng.normal(size=(2, 4)),
        v=rng.normal(size=(2, 4)),
    )
    gp = geodesic_points_from_numpy(fields, device="cpu")
    assert gp.aux is None
    for k, val in fields.items():
        np.testing.assert_array_equal(getattr(gp, k).numpy(), val)
    np.testing.assert_array_equal(gp[1:].x.numpy(), fields["x"][1:])


def test_port_imports_no_jax():
    """Static check: no module of the port imports jax or the JAX package."""
    root = Path(gradus_tpu_torch.__file__).parent
    offenders = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "gradus_tpu"):
                    offenders.append(f"{path.relative_to(root)}: {name}")
    assert offenders == []
