"""The port's transfer-function line profile end to end for a deformed
metric, against the JAX reference, in f64 on the CPU: the Johannsen-Psaltis
metric of Gradus.jl's deformed line-profile golden
(test/line-profiles/test-cunningham.jl:25-40; tests/test_transfer.py:70-84),
through the generic ISCO, the AD Jacobian of the integrator's plain version
and the Keplerian redshift of the transfer-function solver. The comparisons
and their tolerances are those of tests/test_torch_ctf_e2e.py.

Configuration: JohannsenPsaltisMetric(1, 0.6, ε₃=2), i=60°, ThinDisc(0, ∞),
radii (4, 8), N=10, N_extrema=4, Ng=16.

The JAX package's side (its interpret-mode Pallas transfer functions, ~235 s
on one core, and the line profile over them) is pinned in
tests/data/jax_reference_ctf_e2e_deformed.npz by
scripts/torch_slow_tests_reference.py (``--part ctf_e2e_deformed``), at
this module's inputs.
"""

import importlib
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import cuda_solver  # noqa: E402
from gradus_tpu_torch.lineprofile import lineprofile  # noqa: E402
from gradus_tpu_torch.metrics import JohannsenPsaltisMetric  # noqa: E402
from gradus_tpu_torch.transfer.integration import integrate_lineprofile  # noqa: E402

# the module, which the package's `lineprofile` function shadows as an attribute
port_lineprofile_module = importlib.import_module("gradus_tpu_torch.lineprofile")

A_SPIN, EPS3 = 0.6, 2.0
X_OBS = [0.0, 1000.0, math.radians(60.0), 0.0]
RADII = [4.0, 8.0]
CTF_KW = dict(N=10, N_extrema=4, Ng=16)
BINS = np.linspace(0.1, 1.5, 40)
N_RADII = 100


def _emissivity(r):
    return r**-3.0


def _jax_reference():
    """The JAX package's grid and flux at this module's inputs, pinned."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from torch_slow_tests_reference import load

    return load("ctf_e2e_deformed")


@pytest.fixture(scope="module")
def jax_grid():
    ref = _jax_reference()
    return SimpleNamespace(**{k[len("grid_") :]: v for k, v in ref.items() if k.startswith("grid_")})


@pytest.fixture(scope="module")
def port_run():
    """`lineprofile` over radii (4, 8): an inverse grid of 2 radii from 4 to
    8 is exactly (4, 8). The grid that `transferfunctions` hands to the
    integration is kept for the comparisons below."""
    grids = []
    transferfunctions = port_lineprofile_module.transferfunctions

    def keep(*args, **kwargs):
        grids.append(transferfunctions(*args, **kwargs))
        return grids[-1]

    port_lineprofile_module.transferfunctions = keep
    before = cuda_solver.KERNEL_LAUNCHES
    try:
        bins, flux = lineprofile(
            JohannsenPsaltisMetric(1.0, A_SPIN, EPS3, device="cpu"),
            torch.tensor(X_OBS, dtype=torch.float64),
            ThinDisc(0.0, math.inf, device="cpu"),
            bins=torch.as_tensor(BINS),
            min_re=RADII[0],
            max_re=RADII[1],
            num_re=2,
            n_radii=N_RADII,
            backend="cuda",
            **CTF_KW,
        )
    finally:
        port_lineprofile_module.transferfunctions = transferfunctions
    return dict(grid=grids[0], bins=bins, flux=flux, launches=cuda_solver.KERNEL_LAUNCHES - before)


@pytest.fixture(scope="module")
def port_grid(port_run):
    return port_run["grid"]


def test_extremal_redshifts_match_jax(jax_grid, port_grid):
    np.testing.assert_array_equal(port_grid.radii.numpy(), np.asarray(jax_grid.radii))
    np.testing.assert_allclose(port_grid.gmin.numpy(), np.asarray(jax_grid.gmin), rtol=1e-6)
    np.testing.assert_allclose(port_grid.gmax.numpy(), np.asarray(jax_grid.gmax), rtol=1e-6)
    np.testing.assert_allclose(port_grid.gstar.numpy(), np.asarray(jax_grid.gstar), rtol=1e-15)


@pytest.mark.parametrize("branch", ["lower_f", "upper_f", "lower_t", "upper_t"])
def test_branches_match_jax(jax_grid, port_grid, branch):
    gq = np.asarray(jax_grid.gstar)
    inner = (gq > 0.1) & (gq < 0.9)
    ref = np.asarray(getattr(jax_grid, branch))[:, inner]
    got = getattr(port_grid, branch).numpy()[:, inner]
    assert np.isfinite(ref).all() and (np.abs(ref) > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.fixture(scope="module")
def fluxes(jax_grid, port_grid):
    ref = _jax_reference()["flux"]
    got = integrate_lineprofile(_emissivity, port_grid, torch.as_tensor(BINS), n_radii=N_RADII).numpy()
    return ref, got


def test_line_profile_over_the_grid_matches_jax(fluxes):
    ref, got = fluxes
    np.testing.assert_allclose(ref.sum(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-12)
    top = ref > 1e-3 * ref.max()
    assert top.sum() >= 20
    np.testing.assert_allclose(got[top], ref[top], rtol=1e-3)
    assert (got[~top] < 2e-3 * ref.max()).all()


def test_lineprofile_entry_point_matches_jax(fluxes, port_run):
    """On CPU tensors the entry point ran the integrator's plain version,
    not the kernel, and its flux is the integration over its grid."""
    ref, got = fluxes
    assert port_run["launches"] == 0
    np.testing.assert_array_equal(port_run["bins"].numpy(), BINS)
    flux = port_run["flux"].numpy()
    np.testing.assert_allclose(flux, got, rtol=1e-12, atol=1e-300)
    top = ref > 1e-3 * ref.max()
    np.testing.assert_allclose(flux[top], ref[top], rtol=1e-3)
