"""The port's transfer-function line profile end to end, against the JAX
reference, in f64 on the CPU. The port's `lineprofile(..., backend="cuda")`
runs once; the transfer-function grid it builds (through
`cunningham_transfer_function`, with the CUDA integrator's plain version on
CPU tensors) is held against the JAX package's `backend="pallas"` grid with
the Pallas kernel in interpret mode, then the line profile integrated over
each package's grid, and the entry point's own flux.

Configuration: Kerr a=0.998, i=60°, ThinDisc(0, ∞), radii (4, 8), N=10,
N_extrema=4, Ng=16.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402
from gradus_tpu.transfer.cunningham import (  # noqa: E402
    cunningham_transfer_function as jax_ctf,
)
from gradus_tpu.transfer.integration import integrate_lineprofile as jax_integrate  # noqa: E402

from gradus_tpu_torch.camera import GeometricGrid, PolarPlane  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import cuda_solver  # noqa: E402
from gradus_tpu_torch.lineprofile import BinningMethod, lineprofile  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.transfer.integration import integrate_lineprofile  # noqa: E402

# the module, which the package's `lineprofile` function shadows as an attribute
port_lineprofile_module = importlib.import_module("gradus_tpu_torch.lineprofile")

A_SPIN = 0.998
X_OBS = [0.0, 1000.0, math.radians(60.0), 0.0]
RADII = [4.0, 8.0]
CTF_KW = dict(N=10, N_extrema=4, Ng=16)
BINS = np.linspace(0.1, 1.5, 40)
N_RADII = 100


def _emissivity(r):
    return r**-3.0


@pytest.fixture(scope="module")
def jax_grid():
    return jax_ctf(
        JaxKerr(M=1.0, a=A_SPIN),
        jnp.asarray(X_OBS),
        JaxThinDisc(0.0, jnp.inf),
        jnp.asarray(RADII),
        backend="pallas",
        pallas_opts={"interpret": True},
        **CTF_KW,
    )


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
            KerrMetric(1.0, A_SPIN, device="cpu"),
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
    ref = np.asarray(jax_integrate(_emissivity, jax_grid, jnp.asarray(BINS), n_radii=N_RADII))
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


def test_binning_method_agrees_with_the_transfer_functions(port_run):
    """The port's two line-profile methods share almost no code: the
    BinningMethod branch (`trace_geodesics` over a 60×60 geometric polar
    plane over 2 ≤ ρ ≤ 11.2, binned over the same radii and bins) against
    the transfer-function profile above. Over the bins above 1e-2 of the
    peak the median relative difference is ≤ 0.1 (measured 0.060; at
    120×120 0.069, so the two radii of the transfer-function grid, not the
    plane, set it; the full-size comparison on the card is in
    chip_smoke.py's binning_api)."""
    _, binned = lineprofile(
        KerrMetric(1.0, A_SPIN, device="cpu"),
        torch.tensor(X_OBS, dtype=torch.float64),
        ThinDisc(0.0, math.inf, device="cpu"),
        bins=torch.as_tensor(BINS),
        method=BinningMethod(),
        plane=PolarPlane(GeometricGrid(), Nr=60, Ntheta=60, r_min=2.0, r_max=1.4 * RADII[1], device="cpu"),
        min_re=RADII[0],
        max_re=RADII[1],
    )
    tf, b = port_run["flux"].numpy(), binned.numpy()
    assert math.isclose(b.sum(), 1.0, rel_tol=1e-12)
    top = tf > 1e-2 * tf.max()
    assert top.sum() >= 20
    assert np.median(np.abs(b[top] - tf[top]) / tf[top]) <= 0.1
