"""The JAX package's side of the port's AD parity tests, computed once and
kept in `tests/data/jax_reference_adjoint.npz`, so that the tests run the
port's side alone. It runs the JAX package on the CPU in f64 with the JAX
tests' own functions and inputs:

- `composes` (tests/test_torch_reverse_mode.py): `jax.jacfwd` of
  tests/test_reverse_mode.py's downstream loss ``tanh(v)² + 3v`` of
  `_mean_redshift` at a = 0.3, i = 45°, and the value of `_mean_redshift`;
- `ladder` (tests/test_torch_checkpointed_adjoint.py): the checkpointed
  ladder's endpoints and statuses from tests/test_checkpointed_adjoint.py's
  `_setup` with its heights, the loss and its `jax.grad`.

    python scripts/torch_adjoint_reference.py

It prints the seconds each part took.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PATH = ROOT / "tests" / "data" / "jax_reference_adjoint.npz"


def load():
    """The pinned arrays, as a dict of numpy arrays."""
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


def main():
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import test_checkpointed_adjoint as tca
    import test_reverse_mode as trm

    from gradus_tpu.integrate import trace_geodesics

    out = {}
    t0 = time.perf_counter()
    params = {"a": jnp.asarray(0.3), "incl": jnp.asarray(np.deg2rad(45.0))}

    def downstream_plain(p):
        v = trm._mean_redshift(p)
        return jnp.tanh(v) ** 2 + 3.0 * v

    gf = jax.jacfwd(downstream_plain)(params)
    out["composes_value"] = np.asarray(trm._mean_redshift(params))
    out["composes_grad_a"] = np.asarray(gf["a"])
    out["composes_grad_incl"] = np.asarray(gf["incl"])
    print(f"composes: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    m, xs, v, knots = tca._setup()
    heights = 0.5 + 0.3 * jnp.sin(knots / 5.0)
    gp = trace_geodesics(
        m, xs, v, (0.0, 300.0), geometry=tca.SplineSurface(knots=knots, heights=heights),
        checkpointed=True, n_segments=16, seg_steps=16,
    )  # fmt: skip
    loss = tca._loss_fn(m, xs, v, knots)
    out["ladder_x"] = np.asarray(gp.x)
    out["ladder_v"] = np.asarray(gp.v)
    out["ladder_status"] = np.asarray(gp.status)
    out["ladder_loss"] = np.asarray(loss(heights))
    out["ladder_grad"] = np.asarray(jax.jit(jax.grad(loss))(heights))
    print(f"ladder: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez(PATH, **out)


if __name__ == "__main__":
    main()
