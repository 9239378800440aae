"""The port's `rendergeodesics`, `prerendergeodesics` and `apply` (over its
`trace_geodesics`) against the JAX reference's, pixel by pixel, in f64 on
the CPU: the render goldens of tests/test_render.py (r = 100, i = 85°, 20×20,
α, β ∈ (-9.5, 9.5), λ ≤ 200: the Kerr and Johannsen shadows and the Kerr
thin disc), the redshift render of its physics test, the status
distribution, and `apply` over a render cache carried across from JAX.

The images' NaN masks are equal. Redshifts are held at rtol 1e-6
(tests/test_torch_render.py). A shadow pixel is the affine time at which
its ray ended: at a polished disc hit it does not depend on the step
sequence, but a capture ends at the first step end inside the chart, and
the two packages take slightly different steps (tests/test_torch_integrate.py
says why). Those are held at the tightest tolerance that holds, stated
beside each assertion.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera import ConstPointFunctions as JaxPF  # noqa: E402
from gradus_tpu.camera.render import apply as jax_apply  # noqa: E402
from gradus_tpu.camera.render import prerendergeodesics as jax_prerender  # noqa: E402
from gradus_tpu.camera.render import rendergeodesics as jax_render  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.metrics import JohannsenMetric as JaxJohannsen  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch.camera import (  # noqa: E402
    ConstPointFunctions,
    EndpointRenderCache,
    apply,
    prerendergeodesics,
    rendergeodesics,
)
from gradus_tpu_torch.integrate import StatusCodes  # noqa: E402
from gradus_tpu_torch.interop import from_numpy, render_cache_from_numpy  # noqa: E402

CAMERA = dict(image_width=20, image_height=20, alpha_lims=(-9.5, 9.5), beta_lims=(-9.5, 9.5))
X_OBS = [0.0, 100.0, math.radians(85.0), 0.0]
# the redshift render of tests/test_render.py::test_redshift_render_physics
RED_CAMERA = dict(image_width=30, image_height=20, alpha_lims=(-25.0, 25.0), beta_lims=(-15.0, 15.0))


def _params(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _port(obj):
    return from_numpy(type(obj).__name__, _params(obj), device="cpu")


def _both(jm, jd, lam_max, camera, pf_j=None, pf_t=None):
    """(JAX image, port image, port metric) of one render."""
    xj = jnp.asarray(X_OBS)
    _, _, img_j = jax_render(jm, xj, jd, lam_max, pf=pf_j, **camera)
    m = _port(jm)
    d = None if jd is None else _port(jd)
    pf = None if pf_t is None else pf_t(m)
    _, _, img_t = rendergeodesics(m, torch.tensor(X_OBS, dtype=torch.float64), d, lam_max, pf=pf, **camera)
    return np.asarray(img_j), img_t.numpy(), m


@pytest.mark.parametrize(
    "metric, outer_r, golden",
    [
        ("kerr", None, 9009.452876609641),
        ("johannsen", None, 9009.448935932085),
        ("kerr", 40.0, 38412.08347901267),
    ],
    ids=["kerr_shadow", "johannsen_shadow", "kerr_thin_disc"],
)
def test_render_goldens_match_jax(metric, outer_r, golden):
    jm = JaxKerr(M=1.0, a=0.0) if metric == "kerr" else JaxJohannsen(M=1.0, a=0.0)
    jd = None if outer_r is None else JaxThinDisc(0.0, outer_r)
    img_j, img_t, _ = _both(jm, jd, 200.0, CAMERA)
    assert img_t.shape == (20, 20)
    np.testing.assert_array_equal(np.isnan(img_t), np.isnan(img_j))
    # a capture's affine time, at its last step's end: measured ≤ 1.0e-5
    # relative (≤ 1.0e-3 absolute) in all three renders
    np.testing.assert_allclose(img_t, img_j, rtol=2e-5)
    assert math.isclose(np.nansum(img_t), golden, rel_tol=1e-1)


def test_redshift_render_matches_jax():
    """tests/test_render.py's redshift render (Kerr a = 0.5, ThinDisc(0, 40),
    λ ≤ 300, 30×20): g at rtol 1e-6 (measured 9.1e-12), the physics checks."""
    jm, jd = JaxKerr(M=1.0, a=0.5), JaxThinDisc(0.0, 40.0)
    pf_j = JaxPF.redshift(jm, jnp.asarray(X_OBS)) @ JaxPF.filter_intersected()

    def pf_t(m):
        x = torch.tensor(X_OBS, dtype=torch.float64)
        return ConstPointFunctions.redshift(m, x) @ ConstPointFunctions.filter_intersected()

    img_j, img_t, _ = _both(jm, jd, 300.0, RED_CAMERA, pf_j, pf_t)
    assert img_t.shape == (20, 30)
    finite = np.isfinite(img_j)
    np.testing.assert_array_equal(np.isfinite(img_t), finite)
    np.testing.assert_allclose(img_t[finite], img_j[finite], rtol=1e-6)
    g = img_t[finite]
    assert finite.sum() > 50 and (g > 0).all() and (g < 2.0).all()
    assert g.max() > 1.0 and g.min() < 0.9


@pytest.fixture(scope="module")
def caches():
    """Both packages' render caches of the thin-disc golden."""
    jm, jd = JaxKerr(M=1.0, a=0.0), JaxThinDisc(0.0, 40.0)
    _, _, cj = jax_prerender(jm, jnp.asarray(X_OBS), jd, 200.0, **CAMERA)
    m, d = _port(jm), _port(jd)
    alphas, betas, ct = prerendergeodesics(m, torch.tensor(X_OBS, dtype=torch.float64), d, 200.0, **CAMERA)
    return dict(jm=jm, jd=jd, cj=cj, m=m, d=d, ct=ct, alphas=alphas, betas=betas)


def test_status_distribution(caches):
    """All three classes: disc hits, captures and escapes; the same status
    for every pixel in both packages, and the same polished hits."""
    statuses = caches["ct"].points.status.numpy()
    np.testing.assert_array_equal(statuses, np.asarray(caches["cj"].points.status))
    hit = statuses == StatusCodes.IntersectedWithGeometry
    for name in ("x", "lam_max"):
        got, ref = getattr(caches["ct"].points, name).numpy(), np.asarray(getattr(caches["cj"].points, name))
        np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-9)  # measured 1.2e-10
    assert (statuses == StatusCodes.IntersectedWithGeometry).sum() > 100
    assert (statuses == StatusCodes.NoStatus).sum() > 10
    assert (statuses == StatusCodes.WithinInnerBoundary).sum() > 10
    np.testing.assert_allclose(caches["alphas"].numpy(), np.linspace(-9.5, 9.5, 20) + 1e-6, rtol=0, atol=1e-14)


def test_apply_over_a_cache_carried_from_jax(caches):
    """`apply` over the JAX package's cache, carried across by
    `render_cache_from_numpy`, is the JAX package's image bit for bit; over
    the port's own cache it is the port's `rendergeodesics` image."""
    cj = caches["cj"]
    handed = dict(
        metric="KerrMetric",
        metric_params=_params(cj.m),
        max_time=np.asarray(cj.max_time),
        height=cj.height,
        width=cj.width,
        points={f.name: getattr(cj.points, f.name) for f in dataclasses.fields(cj.points)},
    )
    handed["points"] = {k: None if v is None else np.asarray(v) for k, v in handed["points"].items()}
    cache = render_cache_from_numpy(handed, device="cpu")
    assert isinstance(cache, EndpointRenderCache) and (cache.width, cache.height) == (20, 20)
    assert repr(cache) == repr(cj)
    img = apply(ConstPointFunctions.shadow(), cache).numpy()
    np.testing.assert_array_equal(img, np.asarray(jax_apply(JaxPF.shadow(), cj)))

    _, _, own = rendergeodesics(caches["m"], torch.tensor(X_OBS, dtype=torch.float64), caches["d"], 200.0, **CAMERA)
    np.testing.assert_array_equal(apply(ConstPointFunctions.shadow(), caches["ct"]).numpy(), own.numpy())
