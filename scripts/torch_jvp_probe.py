"""Time `continuum_time` on the card with the offset solver's derivative
taken by plain `torch.func.jvp` and by the lifted jvp of
`gradus_tpu_torch/utils/jvp.py`, in one process, one after the other, with
the lockstep loop uncaptured (`cuda_graphs(False)`: the two differ in host
time, which a CUDA graph does not spend).

Configuration: Gradus.jl's reverberation smoke test (Kerr a = 0.998,
observer at r = 10⁴ and i = 45°, `LampPostModel()`), f64. Prints the card's
name and power limit, then one JSON line per variant: t₀ (repr), seconds,
Newton iterations (traces − 1) and lockstep iterations.

    python scripts/torch_jvp_probe.py [--r 1e4] [--order plain,lifted]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gradus_tpu_torch.corona import LampPostModel  # noqa: E402
from gradus_tpu_torch.integrate import solver  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.reverberation import continuum_time  # noqa: E402
from gradus_tpu_torch.transfer import solvers  # noqa: E402
from gradus_tpu_torch.utils import jvp as lifted  # noqa: E402

VARIANTS = {"plain": torch.func.jvp, "lifted": lifted.jvp}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=float, default=1e4)
    ap.add_argument("--order", default="plain,lifted")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(
        subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip(),
        flush=True,
    )
    dev = torch.device("cuda", 0)
    m = KerrMetric(1.0, 0.998, device=dev)
    x = torch.tensor([0.0, args.r, math.radians(45.0), 0.0], dtype=torch.float64, device=dev)
    for name in args.order.split(","):
        solvers.jvp = solver.jvp = VARIANTS[name]
        ends = []  # the iterations of each lockstep loop

        def observe(event, **info):
            if event == "end":
                ends.append(info["iterations"])

        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with solver.cuda_graphs(False), solver.observe_loops(observe):
                t = float(continuum_time(m, x, LampPostModel()))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            solvers.jvp = solver.jvp = lifted.jvp
        print(
            json.dumps(
                dict(
                    variant=name,
                    r_obs=args.r,
                    t0=repr(t),
                    seconds=seconds,
                    newton_iterations=len(ends) - 1,
                    lockstep_iterations=sum(ends),
                    ms_per_iteration=seconds * 1e3 / max(sum(ends), 1),
                )
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
