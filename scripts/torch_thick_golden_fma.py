"""The thick-disc golden of tests/test_transfer.py::test_thick_disc_ctf_golden
(Kerr a = 0.998, r = 10⁴, i = 75°, `ShakuraSunyaev.from_metric`, rₑ = 3,
β₀ = 2; Σf over the valid samples), in f64 on the CPU, three ways in three
processes at once: the JAX package as its tests compile it, the JAX package
with XLA's LLVM passes at level 0 (no fused multiply-add contraction), and
the port. Prints one JSON line per run with Σf (repr), the valid samples,
and Σf split into the interior samples (0.01 < g✶ < 0.99) and the rest.
Σf is dominated by samples within 1e-4 of the extremal redshifts, where f
is a 0·∞ product, so the last bits of the traces move it; the interior
samples are well conditioned.

With ``--samples PATH``, also writes the JAX package's (as its tests compile
it) and the port's samples (θ, g✶, f, t, ok) to PATH as JSON: the CPU
reference that `chip_smoke.py`'s thick-disc golden holds the card's samples
to (tests/data/thick_golden_samples.json).

    python scripts/torch_thick_golden_fma.py [--samples tests/data/thick_golden_samples.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

JAX = """
import jax, numpy as np, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
import gradus_tpu as gt
m = gt.KerrMetric(M=1.0, a=0.998)
x = jnp.array([0.0, 10000.0, np.deg2rad(75.0), 0.0])
_, s = gt.cunningham_transfer_function(m, x, gt.ShakuraSunyaev.from_metric(m), jnp.array([3.0]), beta0=2.0,
                                       return_samples=True)
s = {k: np.asarray(s[k][0]) for k in ("theta", "gstar", "f", "t", "ok")}
"""

PORT = """
import math, numpy as np, torch
torch.set_num_threads(1)
from gradus_tpu_torch.geometry import ShakuraSunyaev
from gradus_tpu_torch.metrics import KerrMetric
from gradus_tpu_torch.transfer import cunningham_transfer_function
m = KerrMetric(1.0, 0.998, device="cpu")
x = torch.tensor([0.0, 10000.0, math.radians(75.0), 0.0], dtype=torch.float64)
_, s = cunningham_transfer_function(m, x, ShakuraSunyaev.from_metric(m), torch.tensor([3.0], dtype=torch.float64),
                                    beta0=2.0, return_samples=True)
s = {k: s[k][0].numpy() for k in ("theta", "gstar", "f", "t", "ok")}
"""

# Σf over the valid samples, over the interior ones and over the rest; the samples
REPORT = """
import json
ok, f, g = s["ok"], s["f"], s["gstar"]
valid = ok & np.isfinite(f)
interior = valid & (g > 0.01) & (g < 0.99)
print(json.dumps(dict(
    sum_f=repr(float(f[valid].sum())), valid=int(ok.sum()), interior=int(interior.sum()),
    sum_f_interior=repr(float(f[interior].sum())), sum_f_rest=repr(float(f[valid & ~interior].sum())),
    samples={k: v.tolist() for k, v in s.items()},
)))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=Path, help="write the JAX package's and the port's samples here")
    args = ap.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    runs = {
        "jax": (JAX, env),
        "jax_no_fma": (JAX, dict(env, XLA_FLAGS="--xla_backend_optimization_level=0")),
        "port": (PORT, env),
    }
    procs = {
        name: subprocess.Popen([sys.executable, "-c", code + REPORT], env=e, stdout=subprocess.PIPE, text=True)
        for name, (code, e) in runs.items()
    }
    samples = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed ({proc.returncode})")
        rec = json.loads(out.strip().splitlines()[-1])
        samples[name] = rec.pop("samples")
        print(json.dumps(dict(run=name, **rec)), flush=True)
    if args.samples:
        args.samples.parent.mkdir(parents=True, exist_ok=True)
        args.samples.write_text(json.dumps({k: samples[k] for k in ("jax", "port")}) + "\n")


if __name__ == "__main__":
    main()
