"""tests/test_torch_offset_workhorse.py's parity of the jvp offset solvers
with the JAX reference's, for a `ShakuraSunyaev` disc: one datum plane per
emission radius, the visibility re-trace and the Jacobian against the disc
itself (a file of its own, so that the thin and the thick case run on two
workers)."""

import pytest

pytest.importorskip("torch")

from test_torch_offset_workhorse import (  # noqa: E402, F401
    solve,
    test_offset_jacobian_at_matches_jax,
    test_offset_probe_matches_jax,
    test_offset_workhorse_matches_jax,
)


@pytest.fixture(scope="module", params=["ShakuraSunyaev"])
def solved(request):
    return solve(request.param)
