"""The JAX package's side of four CPU parity tests of the port, computed once
and kept in `tests/data/` so that the tests run the port's side alone. Each
part runs the JAX package on the CPU in f64 at its test's configuration, with
the test's own inputs, and writes the values that test compares:

- `ctf_e2e_deformed` (tests/test_torch_ctf_e2e_deformed.py): the
  Johannsen-Psaltis transfer functions of the interpret-mode Pallas backend
  and the line profile integrated over them;
- `ctf_xla_thin` and `ctf_xla_thick` (tests/test_torch_ctf_xla.py,
  tests/test_torch_ctf_xla_thick.py): the `xla` backend's transfer
  functions and samples for a ThinDisc and a ShakuraSunyaev disc;
- `lag_frequency` (tests/test_torch_lag_frequency.py): the lamp post's
  profile on a grid of radii, the continuum time, the transfer functions and
  the (g, t) flux of `lag_frequency(..., backend="pallas")` in interpret mode.

    python scripts/torch_slow_tests_reference.py --part ctf_e2e_deformed
    (likewise the other three parts; one process each, run them together)

Each part writes `tests/data/jax_reference_<part>.npz` and prints the seconds
its JAX run took.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
BRANCHES = ("lower_f", "upper_f", "lower_t", "upper_t")
GRID_KEYS = ("radii", "gmin", "gmax", "gstar") + BRANCHES
SAMPLE_KEYS = ("ok", "gstar", "f", "t", "J")
PARTS = ("ctf_e2e_deformed", "ctf_xla_thin", "ctf_xla_thick", "lag_frequency")


def path(part):
    return DATA / f"jax_reference_{part}.npz"


def load(part):
    """The part's arrays, as a dict of numpy arrays."""
    with np.load(path(part)) as z:
        return {k: z[k] for k in z.files}


def _grid(prefix, grid):
    return {f"{prefix}{k}": np.asarray(getattr(grid, k)) for k in GRID_KEYS}


def _run(part):
    # the tests' JAX: the CPU, 8 virtual devices (tests/conftest.py), f64
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    if part == "ctf_e2e_deformed":
        import test_torch_ctf_e2e_deformed as t
        from gradus_tpu.geometry import ThinDisc
        from gradus_tpu.metrics import JohannsenPsaltisMetric
        from gradus_tpu.transfer.cunningham import cunningham_transfer_function
        from gradus_tpu.transfer.integration import integrate_lineprofile

        grid = cunningham_transfer_function(
            JohannsenPsaltisMetric(M=1.0, a=t.A_SPIN, eps3=t.EPS3), jnp.asarray(t.X_OBS), ThinDisc(0.0, jnp.inf),
            jnp.asarray(t.RADII), backend="pallas", pallas_opts={"interpret": True}, **t.CTF_KW,
        )  # fmt: skip
        flux = integrate_lineprofile(t._emissivity, grid, jnp.asarray(t.BINS), n_radii=t.N_RADII)
        return {**_grid("grid_", grid), "flux": np.asarray(flux)}
    if part in ("ctf_xla_thin", "ctf_xla_thick"):
        import test_torch_ctf_xla as t
        import gradus_tpu.geometry.discs as jd
        from gradus_tpu.metrics import KerrMetric
        from gradus_tpu.transfer.cunningham import cunningham_transfer_function

        m = KerrMetric(M=1.0, a=0.998)
        disc = jd.ThinDisc(0.0, jnp.inf) if part == "ctf_xla_thin" else jd.ShakuraSunyaev.from_metric(m)
        grid, samples = cunningham_transfer_function(
            m, jnp.asarray(t.X_OBS), disc, jnp.asarray(t.RADII), return_samples=True, **t.KW
        )
        return {**_grid("grid_", grid), **{f"samples_{k}": np.asarray(samples[k]) for k in SAMPLE_KEYS}}
    if part == "lag_frequency":
        import test_torch_lag_frequency as t
        import gradus_tpu.corona as jc
        from gradus_tpu.geometry import ThinDisc
        from gradus_tpu.metrics import KerrMetric

        rev = importlib.import_module("gradus_tpu.reverberation")
        kept, restore = t._keeping(rev, t.NAMES)
        try:
            tbins, bins, flux = rev.lag_frequency(
                KerrMetric(M=1.0, a=t.A_SPIN), jnp.asarray(t.X_OBS), ThinDisc(0.0, jnp.inf), jc.LampPostModel(),
                radii=jnp.asarray(t.RADII), bins=jnp.asarray(t.BINS), tbins=jnp.asarray(t.TBINS),
                backend="pallas", pallas_opts={"interpret": True}, **t.CTF_KW, **t.KW,
            )  # fmt: skip
        finally:
            restore()
        prof = kept["emissivity_profile"]
        return {
            "profile_n": np.asarray(prof.n),
            "profile_eps": np.asarray(prof.emissivity_at(jnp.asarray(t.PROFILE_RADII))),
            "continuum_time": np.asarray(kept["continuum_time"]),
            **_grid("grid_", kept["transferfunctions"]),
            "tbins": np.asarray(tbins),
            "bins": np.asarray(bins),
            "flux": np.asarray(flux),
        }
    raise ValueError(part)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=PARTS, required=True)
    args = ap.parse_args()
    t0 = time.perf_counter()
    arrays = _run(args.part)
    seconds = time.perf_counter() - t0
    np.savez(path(args.part), **arrays)
    print(f"{args.part}: {seconds:.1f} s -> {path(args.part).relative_to(ROOT)}")


if __name__ == "__main__":
    main()
