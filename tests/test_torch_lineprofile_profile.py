"""`lineprofile(..., profile=...)` in the port against the JAX reference's,
in f64 on the CPU: with an emissivity profile, ε is its `emissivity_at`,
and the default method becomes `BinningMethod`. The profile (a
`RadialDiscProfile` of 40 knots, ε ~ r⁻³ with a bump) is carried into both
packages by `interop`.

- `BinningMethod`, by default: a 40×40 geometric polar plane over
  8 ≤ ρ ≤ 50 at a = 0.998, i = 60°, r = 1000, ThinDisc(0, ∞), as
  tests/test_torch_lineprofile_binning.py traces it.
- `TransferFunctionMethod`: both packages integrate over one
  transfer-function grid, handed to each package's `lineprofile` in place
  of its `transferfunctions` (the grids' own parity is
  tests/test_torch_ctf_e2e.py's).
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gradus_tpu.corona as jc  # noqa: E402
from gradus_tpu.camera.grids import GeometricGrid as JaxGeometricGrid  # noqa: E402
from gradus_tpu.camera.planes import PolarPlane as JaxPolarPlane  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.lineprofile import TransferFunctionMethod as JaxTFM  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.transfer import TransferBranchGrid as JaxGrid  # noqa: E402

from gradus_tpu_torch.camera import GeometricGrid, PolarPlane  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.interop import radial_profile_from_numpy, transfer_grid_from_numpy  # noqa: E402
from gradus_tpu_torch.lineprofile import TransferFunctionMethod  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

# the modules, which the packages' `lineprofile` functions shadow as attributes
jax_lp = importlib.import_module("gradus_tpu.lineprofile")
port_lp = importlib.import_module("gradus_tpu_torch.lineprofile")

X_OBS = [0.0, 1000.0, math.radians(60.0), 0.0]
SIDE = 40


def _profile():
    r = np.geomspace(1.3, 400.0, 40)
    eps = r**-3.0 * (1.0 + 0.5 * np.exp(-(((r - 9.0) / 3.0) ** 2)))
    return dict(
        radii=np.concatenate([r, np.full(3, np.inf)]),
        eps=np.concatenate([eps, np.zeros(3)]),
        t=np.concatenate([np.sqrt(r * r + 25.0), np.zeros(3)]),
        n=40,
    )


def _grid():
    """A smooth table over 8 radii from 2 to 50 and 32 g✶ nodes, with the
    shapes of a real one."""
    rng = np.random.default_rng(8)
    radii = np.geomspace(2.0, 50.0, 8)
    gstar = np.linspace(0.0, 1.0, 32)
    gmin = 0.3 + 0.5 * (1 - np.exp(-radii / 8.0))
    gmax = gmin + 0.5 * np.exp(-radii / 60.0)
    shape = np.sqrt(gstar * (1 - gstar))[None, :]
    f = shape * (1 + 0.1 * rng.uniform(size=(8, 32)))
    t = radii[:, None] * (1 + 0.2 * gstar[None, :])
    return dict(radii=radii, gmin=gmin, gmax=gmax, gstar=gstar, lower_f=f, upper_f=f[:, ::-1].copy(), lower_t=t, upper_t=t)


def test_profile_default_is_the_binning_method():
    """With a profile and no method both packages bin: every ray lands in
    the same bin, the nonzero bins are the same, each bin agrees at rtol
    1e-8 (measured ≤ 1e-10), and the port never asks for transfer
    functions."""
    fields = _profile()
    jprof = jc.RadialDiscProfile(**{k: jnp.asarray(v) for k, v in fields.items()})
    _, flux_j = jax_lp.lineprofile(
        JaxKerr(M=1.0, a=0.998),
        jnp.asarray(X_OBS),
        JaxThinDisc(0.0, jnp.inf),
        profile=jprof,
        plane=JaxPolarPlane(JaxGeometricGrid(), Nr=SIDE, Ntheta=SIDE, r_min=8.0, r_max=50.0),
    )
    asked = []
    orig = port_lp.transferfunctions
    port_lp.transferfunctions = lambda *a, **k: asked.append(1)
    try:
        _, flux_t = port_lp.lineprofile(
            KerrMetric(1.0, 0.998, device="cpu"),
            torch.tensor(X_OBS, dtype=torch.float64),
            ThinDisc(0.0, math.inf, device="cpu"),
            profile=radial_profile_from_numpy(fields, device="cpu"),
            plane=PolarPlane(GeometricGrid(), Nr=SIDE, Ntheta=SIDE, r_min=8.0, r_max=50.0, device="cpu"),
        )
    finally:
        port_lp.transferfunctions = orig
    ref, got = np.asarray(flux_j), flux_t.numpy()
    assert not asked and math.isclose(got.sum(), 1.0, rel_tol=1e-12) and (ref > 0).sum() > 50
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=0)


@pytest.mark.parametrize("emissivity", ["profile", "explicit"])
def test_profile_with_the_transfer_function_method(emissivity):
    """Over one grid, the port's profile-weighted line profile is the JAX
    package's at rtol 1e-10 (measured ≤ 1e-14); an explicit ``emissivity``
    takes precedence over the profile in both."""
    fields, grid = _profile(), _grid()
    bins = np.linspace(0.2, 1.3, 60)
    explicit = emissivity == "explicit"
    kw = dict(bins=bins, n_radii=400)
    j_grid = JaxGrid(**{k: jnp.asarray(v) for k, v in grid.items()})
    t_grid = transfer_grid_from_numpy(grid, device="cpu")
    orig_j, orig_t = jax_lp.transferfunctions, port_lp.transferfunctions
    jax_lp.transferfunctions = lambda *a, **k: j_grid
    port_lp.transferfunctions = lambda *a, **k: t_grid
    try:
        _, fj = jax_lp.lineprofile(
            JaxKerr(M=1.0, a=0.998), jnp.asarray(X_OBS), JaxThinDisc(0.0, jnp.inf), method=JaxTFM(),
            profile=jc.RadialDiscProfile(**{k: jnp.asarray(v) for k, v in fields.items()}),
            emissivity=(lambda r: r**-2.0) if explicit else None, **kw,
        )
        _, ft = port_lp.lineprofile(
            KerrMetric(1.0, 0.998, device="cpu"), torch.tensor(X_OBS, dtype=torch.float64),
            ThinDisc(0.0, math.inf, device="cpu"), method=TransferFunctionMethod(),
            profile=radial_profile_from_numpy(fields, device="cpu"),
            emissivity=(lambda r: r**-2.0) if explicit else None, **kw,
        )
    finally:
        jax_lp.transferfunctions, port_lp.transferfunctions = orig_j, orig_t
    ref, got = np.asarray(fj), ft.numpy()
    assert math.isclose(got.sum(), 1.0, rel_tol=1e-12) and (ref > 0).sum() > 20
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14)
