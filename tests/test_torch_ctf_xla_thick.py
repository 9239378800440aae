"""The `xla` transfer-function backend for a thick disc (`ShakuraSunyaev`:
one datum plane per emission radius, the visibility re-trace against the
disc, the Jacobian traced against the disc with the upper-hemisphere
terminator) against the JAX reference's, in f64 on the CPU, at the setup of
tests/test_torch_ctf_xla.py (a file of its own, so that the two ~250 s
comparisons run on two workers)."""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gradus_tpu.geometry.discs as jd  # noqa: E402
from gradus_tpu.metrics import KerrMetric as JaxKerr  # noqa: E402

import gradus_tpu_torch.geometry.discs as td  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

from test_torch_ctf_xla import assert_matches_jax, compare_with_jax  # noqa: E402


def test_thick_disc_xla_backend_matches_jax():
    """Measured ≤ 6.4e-9 relative over the interior samples and branches;
    the same visible samples."""
    jax_disc = jd.ShakuraSunyaev.from_metric(JaxKerr(M=1.0, a=0.998))
    port_disc = td.ShakuraSunyaev.from_metric(KerrMetric(1.0, 0.998, device="cpu"))
    assert_matches_jax(*compare_with_jax(jax_disc, port_disc))
