"""A quick probe of the integrator kernel's generic geometries on the card
(no JAX): each case of chip_smoke.py's `thick_geometries` (ShakuraSunyaev
with cubic and sampled events, the ellipse, two precessing discs, the
composite, the doughnut in Schwarzschild's closed form and in Kerr) on N
flagship rays (r = 1000, i = 75°, λ ≤ 2200; α ∈ [−28, 28], β ∈ [−18, 18],
seed 20), f64 and f32: the kernel against its plain version, one JSON line
a case (status agreement, hits, the largest |Δ| of a hit's x and λ and the
hits past 1e-6, the median redshift gap, both versions' ms); then the plain
version's loop captured against uncaptured on 512 f64 rays (bit for bit,
and both times); then three launches of the 1024² f32 ShakuraSunyaev
kernel (ms, attempted lane-steps, hits).

    python scripts/torch_kernel_geometries_probe.py [N]

Needs one CUDA device and nvcc (the kernels build at first use).
"""
import json
import math
import sys

import numpy as np
import torch

from gradus_tpu_torch import geometry as G, cuda_graphs
from gradus_tpu_torch.camera import map_impact_parameters, ConstPointFunctions
from gradus_tpu_torch.integrate.cuda_solver import CudaTracer, cuda_integrate_rays, integrate_rays_plain
from gradus_tpu_torch.metrics import KerrMetric
dev = torch.device("cuda", 0)
n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
rng = np.random.default_rng(20)
alpha, beta = rng.uniform(-28, 28, n), rng.uniform(-18, 18, n)
def timed(fn):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(); s.record(); o = fn(); e.record(); torch.cuda.synchronize(); return o, s.elapsed_time(e)
for dtype in (torch.float64, torch.float32):
    kw = dict(dtype=dtype, device=dev)
    m = KerrMetric(1.0, 0.998, **kw)
    x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
    v = map_impact_parameters(m, x, torch.as_tensor(alpha, **kw), torch.as_tensor(beta, **kw))
    cases = {
        "shakura_sunyaev": G.ShakuraSunyaev.from_metric(m),
        "elliptical": G.EllipticalDisc(0.0, 100.0, 60.0, **kw),
        "precessing_elliptical": G.PrecessingDisc(G.EllipticalDisc(0.0, 100.0, 60.0, **kw), math.radians(10), math.radians(30), **kw),
        "precessing_thin": G.PrecessingDisc(G.ThinDisc(0.0, 50.0, **kw), math.radians(20), math.radians(30), **kw),
        "composite": G.CompositeGeometry([G.ThinDisc(20.0, 100.0, **kw), G.DatumPlane(3.0, **kw)]),
        "doughnut": G.PolishDoughnut(**kw),
        "doughnut_kerr": G.PolishDoughnut(metric=m),
    }
    for name, d in cases.items():
        for method in (("cubic", "sampled") if name == "shakura_sunyaev" else ("cubic",)):
            tr = CudaTracer(m, geometry=d, event_method=method)
            y0 = tr._constrain(x.expand_as(v), v)
            ikw = tr._integrate_kwargs(dtype)
            ok, kms = timed(lambda: cuda_integrate_rays(m, y0, (0.0, 2200.0), **ikw))
            op, pms = timed(lambda: integrate_rays_plain(m, y0, (0.0, 2200.0), **ikw))
            gk, gp = tr._finish(ok, y0, 0.0), tr._finish(op, y0, 0.0)
            agree = float((gk.status == gp.status).double().mean())
            hit = (gk.status == 3) & (gp.status == 3)
            err = float(torch.maximum((gk.x[hit] - gp.x[hit]).abs().max(), (gk.lam_max[hit] - gp.lam_max[hit]).abs().max())) if hit.any() else None
            pf = ConstPointFunctions.redshift(m, x)
            grel = float(((pf(m, gk, 2200.0)[hit] - pf(m, gp, 2200.0)[hit]).abs() / pf(m, gp, 2200.0)[hit].abs()).median()) if hit.any() else None
            nbad = int(((gk.x[hit] - gp.x[hit]).abs().max(-1).values > 1e-6).sum()) if hit.any() else 0
            print(json.dumps(dict(case=name, method=method, dtype=str(dtype)[6:], agree=agree, hits=int(hit.sum()), hit_max_abs_err=err, rays_over_1e6=nbad, g_median_rel=grel, kernel_ms=kms, plain_ms=pms, status=torch.bincount(gk.status.long(), minlength=4).tolist())), flush=True)
# the plain loop captured against uncaptured, bit for bit
m = KerrMetric(1.0, 0.998, device=dev); x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], device=dev, dtype=torch.float64)
v = map_impact_parameters(m, x, torch.as_tensor(alpha[:512], device=dev), torch.as_tensor(beta[:512], device=dev))
d = G.ShakuraSunyaev.from_metric(m); tr = CudaTracer(m, geometry=d); y0 = tr._constrain(x.expand_as(v), v); ikw = tr._integrate_kwargs(torch.float64)
a, ams = timed(lambda: integrate_rays_plain(m, y0, (0.0, 2200.0), **ikw))
with cuda_graphs(False):
    b, bms = timed(lambda: integrate_rays_plain(m, y0, (0.0, 2200.0), **ikw))
same = {k: bool(torch.equal(torch.nan_to_num(a[k].double(), nan=7.7), torch.nan_to_num(b[k].double(), nan=7.7))) for k in a if isinstance(a[k], torch.Tensor)}
print(json.dumps(dict(plain_graph_vs_uncaptured=same, graph_ms=ams, uncaptured_ms=bms)), flush=True)
# full-size SS render f32 kernel timing
dtype = torch.float32; kw = dict(dtype=dtype, device=dev)
m = KerrMetric(1.0, 0.998, **kw); x = torch.tensor([0.0, 1000.0, math.radians(75.0), 0.0], **kw)
side = 1024
al = torch.linspace(-28, 28, side, **kw) + 1e-4; be = torch.linspace(-18, 18, side, **kw) + 1e-4
A = al[:, None].expand(side, side).reshape(-1); B = be[None, :].expand(side, side).reshape(-1)
d = G.ShakuraSunyaev.from_metric(m); tr = CudaTracer(m, geometry=d)
v = map_impact_parameters(m, x, A, B); y0 = tr._constrain(x.expand_as(v), v)
ikw = tr._integrate_kwargs(dtype)
cuda_integrate_rays(m, y0, (0.0, 2200.0), **ikw)
times = [timed(lambda: cuda_integrate_rays(m, y0, (0.0, 2200.0), **ikw)) for _ in range(3)]
o = times[-1][0]
print(json.dumps(dict(ss_render_kernel_ms=[t for _, t in times], attempts=int(o["attempts"].sum()), hits=int((o["status"] == 3).sum()), status=torch.bincount(o["status"].long(), minlength=4).tolist())), flush=True)
