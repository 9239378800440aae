"""The BinningMethod branch of the port's `lineprofile` against the JAX
reference's, bin by bin, in f64 on the CPU: a 40×40 geometric polar plane
over 8 ≤ ρ ≤ 50 at the flagship spin (Kerr a = 0.998, i = 60°, r = 1000),
ThinDisc(0, ∞), traced by each package's `trace_geodesics` with the
`domain_upper_hemisphere` terminator, then binned with the analytic
redshift and ε = r⁻³ over rₑ ∈ [isco, 50] (the defaults of both packages
but the plane). The plane starts outside the critical curve: rays near it
circle the photon orbit, where a rounding difference between the two
packages' step sequences turns into a different outcome (a hit, or a stop
by `domain_upper_hemisphere` at a step end just above the plane).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gradus_tpu.camera.grids import GeometricGrid as JaxGeometricGrid  # noqa: E402
from gradus_tpu.camera.planes import PolarPlane as JaxPolarPlane  # noqa: E402
from gradus_tpu.geometry import ThinDisc as JaxThinDisc  # noqa: E402
from gradus_tpu.lineprofile import BinningMethod as JaxBinningMethod  # noqa: E402
from gradus_tpu.lineprofile import lineprofile as jax_lineprofile  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

from gradus_tpu_torch.camera import GeometricGrid, PolarPlane  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.lineprofile import BinningMethod, lineprofile  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

X_OBS = [0.0, 1000.0, math.radians(60.0), 0.0]
SIDE = 40


def test_binning_method_matches_jax():
    bins_j, flux_j = jax_lineprofile(
        JaxKerr(M=1.0, a=0.998),
        jnp.asarray(X_OBS),
        JaxThinDisc(0.0, jnp.inf),
        method=JaxBinningMethod(),
        plane=JaxPolarPlane(JaxGeometricGrid(), Nr=SIDE, Ntheta=SIDE, r_min=8.0, r_max=50.0),
    )
    bins_t, flux_t = lineprofile(
        KerrMetric(1.0, 0.998, device="cpu"),
        torch.tensor(X_OBS, dtype=torch.float64),
        ThinDisc(0.0, math.inf, device="cpu"),
        method=BinningMethod(),
        plane=PolarPlane(GeometricGrid(), Nr=SIDE, Ntheta=SIDE, r_min=8.0, r_max=50.0, device="cpu"),
    )
    np.testing.assert_allclose(bins_t.numpy(), np.asarray(bins_j), rtol=0, atol=1e-15)
    ref, got = np.asarray(flux_j), flux_t.numpy()
    assert math.isclose(got.sum(), 1.0, rel_tol=1e-12) and (ref > 0).sum() > 50
    # every ray lands in the same bin: the nonzero bins are the same ones,
    # and each bin's flux agrees at rtol 1e-8 (measured 7.9e-11)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=0)
