"""The `xla` transfer-function backend (the jvp Newton through the lockstep
solver, the default of `cunningham_transfer_function`) against the JAX
reference's, in f64 on the CPU, for a thin disc; the port's `xla` and `cuda`
backends against each other on CPU tensors; and the thick-disc golden of
tests/test_transfer.py (marked slow, as the JAX test is). The thick disc's
parity is tests/test_torch_ctf_xla_thick.py.

Setup: Kerr a = 0.998, observer at r = 100 and i = 60°, ThinDisc(0, ∞),
emission radii 4 and 10, N = 16 angles, N_extrema = 4 (6 golden-section
probes a side), Ng = 16. Every forward-mode trace costs ~45 ms an iteration
on one CPU core, so the port's side is ~170 s. The JAX package's side
(~110 s a disc on one core) is pinned in
tests/data/jax_reference_ctf_xla_{thin,thick}.npz by
scripts/torch_slow_tests_reference.py (``--part ctf_xla_thin``,
``--part ctf_xla_thick``), at this module's inputs.
"""

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu.geometry.discs as jd  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.transfer.cunningham import cunningham_transfer_function as jax_ctf  # noqa: E402

import gradus_tpu_torch.geometry.discs as td  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.transfer.cunningham import cunningham_transfer_function  # noqa: E402

X_OBS = [0.0, 100.0, math.radians(60.0), 0.0]
RADII = [4.0, 10.0]
KW = dict(N=16, N_extrema=4, Ng=16)
BRANCHES = ("lower_f", "upper_f", "lower_t", "upper_t")


def jax_reference(part):
    """The JAX package's (grid, samples) for ``part`` ("ctf_xla_thin" or
    "ctf_xla_thick") at ``KW``, pinned."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from torch_slow_tests_reference import load

    ref = load(part)
    grid = SimpleNamespace(**{k[len("grid_") :]: v for k, v in ref.items() if k.startswith("grid_")})
    return grid, {k[len("samples_") :]: v for k, v in ref.items() if k.startswith("samples_")}


def compare_with_jax(part, port_disc, x_obs=X_OBS):
    """(port grid, port samples, JAX grid, JAX samples) at ``KW``, the
    JAX package's pinned (`jax_reference`)."""
    tm = KerrMetric(1.0, 0.998, device="cpu")
    gj, sj = jax_reference(part)
    gt, st = cunningham_transfer_function(
        tm, torch.tensor(x_obs, dtype=torch.float64), port_disc, torch.tensor(RADII, dtype=torch.float64),
        return_samples=True, **KW,
    )  # fmt: skip
    return gt, st, gj, sj


def assert_matches_jax(gt, st, gj, sj, rtol=1e-7):
    """The same ``ok``; gmin, gmax and every branch at ``rtol``; the samples'
    g✶, f, t and J at ``rtol`` where ok and g✶ is interior (0.01 < g✶ <
    0.99, away from the 0·∞ extremes)."""
    ok = np.asarray(sj["ok"])
    np.testing.assert_array_equal(st["ok"].numpy(), ok)
    assert ok.sum() >= 40
    for k in ("gmin", "gmax", *BRANCHES):
        np.testing.assert_allclose(getattr(gt, k).numpy(), np.asarray(getattr(gj, k)), rtol=rtol, err_msg=k)
    gstar = np.asarray(sj["gstar"])
    interior = ok & (gstar > 0.01) & (gstar < 0.99)
    assert interior.sum() >= 30
    for k in ("gstar", "f", "t", "J"):
        np.testing.assert_allclose(st[k].numpy()[interior], np.asarray(sj[k])[interior], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def thin():
    return compare_with_jax("ctf_xla_thin", td.ThinDisc(0.0, math.inf, device="cpu"))


def test_thin_disc_xla_backend_matches_jax(thin):
    """Measured ≤ 7.2e-9 relative over the interior samples and branches."""
    assert_matches_jax(*thin)


def test_xla_and_cuda_backends_agree(thin):
    """The port's two backends on CPU tensors (the `cuda` backend's offsets
    from the CUDA integrator's plain version), at
    tests/test_pallas_ctf.py::test_end_to_end_backend_pallas's bounds: gmin
    and gmax at 2e-4; the branches' f over 0.1 < g✶ < 0.9, median 5e-3 and
    90th percentile 3e-2 relative."""
    tf_x = thin[0]
    tf_c = cunningham_transfer_function(
        KerrMetric(1.0, 0.998, device="cpu"), torch.tensor(X_OBS, dtype=torch.float64),
        td.ThinDisc(0.0, math.inf, device="cpu"), torch.tensor(RADII, dtype=torch.float64), backend="cuda", **KW,
    )  # fmt: skip
    np.testing.assert_allclose(tf_c.gmin.numpy(), tf_x.gmin.numpy(), rtol=2e-4)
    np.testing.assert_allclose(tf_c.gmax.numpy(), tf_x.gmax.numpy(), rtol=2e-4)
    interior = (tf_x.gstar.numpy() > 0.1) & (tf_x.gstar.numpy() < 0.9)
    for branch in ("lower_f", "upper_f"):
        fx = getattr(tf_x, branch).numpy()[:, interior]
        fc = getattr(tf_c, branch).numpy()[:, interior]
        rel = np.abs(fc - fx) / np.maximum(np.abs(fx), 1e-12)
        assert np.median(rel) < 5e-3, (branch, np.median(rel))
        assert np.percentile(rel, 90) < 3e-2, (branch, np.percentile(rel, 90))


def test_default_backend_is_xla():
    import inspect

    assert inspect.signature(cunningham_transfer_function).parameters["backend"].default == "xla"


@pytest.mark.slow
def test_thick_disc_ctf_golden():
    """tests/test_transfer.py::test_thick_disc_ctf_golden on the port:
    ShakuraSunyaev, Kerr a = 0.998, i = 75°, r = 10⁴, rₑ = 3, β₀ = 2 at the
    defaults (N = 80, N_extrema = 15): the same 114 valid samples as the
    JAX package's, and the 71 interior ones (0.01 < g✶ < 0.99) within 1e-9
    (θ, t), 1e-6 (g✶) and 5e-5 (f) of them (measured 0, 4.4e-11, 1.2e-7 and
    4.2e-6: f carries the Jacobian of forward-mode traces 10⁴ long); Σf within 7e-3 of Gradus.jl's 14.64279, within 1e-3 of the JAX
    package's 14.714802, and at 1e-5 of the port's own value on the CPU,
    14.71635013791655 (a determinism pin, as the JAX test keeps its own).
    Not at 1e-5 of the JAX package's: Σf is dominated by samples within
    1e-4 of the extremal redshifts, where f is a 0·∞ product that the
    traces' last bits move, and the JAX package's own value moves to
    14.647849 with XLA's fused multiply-adds off
    (`scripts/torch_thick_golden_fma.py`); the port's is 1.05e-4 from it."""
    m = KerrMetric(1.0, 0.998, device="cpu")
    x = torch.tensor([0.0, 10000.0, math.radians(75.0), 0.0], dtype=torch.float64)
    d = td.ShakuraSunyaev.from_metric(m)
    _, s = cunningham_transfer_function(m, x, d, torch.tensor([3.0], dtype=torch.float64), beta0=2.0, return_samples=True)
    jm = JaxKerr(M=1.0, a=0.998)
    _, sj = jax_ctf(
        jm, jnp.array([0.0, 10000.0, math.radians(75.0), 0.0]), jd.ShakuraSunyaev.from_metric(jm), jnp.array([3.0]),
        beta0=2.0, return_samples=True,
    )  # fmt: skip
    ok = s["ok"][0].numpy()
    f = s["f"][0].numpy()
    total = f[ok & np.isfinite(f)].sum()
    assert ok.sum() == 114
    np.testing.assert_array_equal(ok, np.asarray(sj["ok"][0]))
    gstar = np.asarray(sj["gstar"][0])
    interior = ok & (gstar > 0.01) & (gstar < 0.99)
    assert interior.sum() >= 30
    for k, rtol in dict(theta=1e-9, gstar=1e-6, t=1e-9, f=5e-5).items():
        np.testing.assert_allclose(s[k][0].numpy()[interior], np.asarray(sj[k][0])[interior], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(total, 14.64279128586961, rtol=7e-3)
    np.testing.assert_allclose(total, 14.714802, rtol=1e-3)
    np.testing.assert_allclose(total, 14.71635013791655, rtol=1e-5)
