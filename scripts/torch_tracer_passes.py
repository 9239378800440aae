"""Time `CudaTracer` on the card in one pass and in the capped, resumed
passes that `Tracer` runs to report its progress: at full width each pass
(``min_bucket`` 2⁶², a bucket no batch fits below), and with the
survivors gathered by the reference's bucket rule (``min_bucket`` 8192,
`Tracer`'s default; 1024, and 1, which gathers at nearly every pass).
Each variant's result is held bit for bit against the one pass.

Configuration: the flagship camera (1024², Kerr a = 0.998, i = 75°,
r = 1000, ThinDisc(0, 50), λ ≤ 2200), `Tracer`'s default schedule of
pass lengths (24, 24, 48, 48, then 96). Prints the card's name and power
limit, then one JSON line per dtype: each variant's seconds (a
synchronize at each end; the variants in the order given, then reversed,
``--reps`` times), its passes and the width of its last pass.

    python scripts/torch_tracer_passes.py [--side 1024] [--reps 3] [--dtypes float64,float32]
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

from gradus_tpu_torch.camera.impact import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geometry import ThinDisc  # noqa: E402
from gradus_tpu_torch.integrate import CudaTracer  # noqa: E402
from gradus_tpu_torch.integrate.solver import _segment_schedule  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402

VARIANTS = {"one_pass": "one", "full_width": 1 << 62, "bucket_8192": 8192, "bucket_1024": 1024, "bucket_1": 1}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtypes", default="float64,float32")
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
    schedule = (*_segment_schedule(96, None), 96)
    for dtype in (getattr(torch, d) for d in args.dtypes.split(",")):
        kw = dict(dtype=dtype, device=dev)
        m = KerrMetric(1.0, 0.998, **kw)
        tracer = CudaTracer(m, geometry=ThinDisc(0.0, 50.0, **kw))
        x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
        s = torch.linspace(-25.0, 25.0, args.side, **kw)
        v = map_impact_parameters(m, x, s[None, :].expand(args.side, -1).reshape(-1), s[:, None].expand(-1, args.side).reshape(-1))
        xs = x.expand_as(v)
        want = tracer(xs, v, (0.0, 2200.0))
        seconds = {k: [] for k in VARIANTS}
        shape = {}
        for rep in range(args.reps):
            for name in VARIANTS if rep % 2 == 0 else reversed(VARIANTS):
                bucket = VARIANTS[name]
                events = []
                kw_passes = {} if bucket == "one" else dict(segments=schedule, progress=events.append, min_bucket=bucket)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = tracer(xs, v, (0.0, 2200.0), **kw_passes)
                torch.cuda.synchronize()
                seconds[name].append(time.perf_counter() - t0)
                for a, b in ((got.x, want.x), (got.v, want.v), (got.status, want.status)):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} differs from the one pass")
                shape[name] = dict(passes=len(events), last_width=events[-1]["width"] if events else v.shape[0])
        print(json.dumps(dict(dtype=str(dtype)[6:], rays=v.shape[0], seconds=seconds, passes=shape)), flush=True)


if __name__ == "__main__":
    main()
