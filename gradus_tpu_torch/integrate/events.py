"""Event localisation on one integrator step (counterpart of
`gradus_tpu/integrate/events.py`).

The signed crossing indicator c(θ) along a step is modelled as the cubic
Hermite through the values and θ-derivatives of c at the step's ends. Its
interior extrema are the roots of a quadratic, so the first sign change on
[0, 1] is found from 4 polynomial evaluations, then polished by bisection on
the cubic. The CUDA kernel carries the same function as a device function.
"""

from __future__ import annotations

import torch

__all__ = ["cubic_first_crossing"]


def cubic_first_crossing(c0, m0, c1, m1, bisect_iters: int = 26):
    """First sign change in (0, 1] of the Hermite cubic with c(0)=c0,
    c'(0)=m0, c(1)=c1, c'(1)=m1 (θ-derivatives, i.e. dλ-derivatives × dt).

    Returns ``(found, theta)``: elementwise bool mask and crossing location
    (0 where not found)."""
    a = 2.0 * c0 - 2.0 * c1 + m0 + m1
    b = -3.0 * c0 + 3.0 * c1 - 2.0 * m0 - m1
    c = m0

    def poly(th):
        return ((a * th + b) * th + c) * th + c0

    zero = torch.zeros_like(c0)
    one = torch.ones_like(c0)

    # interior extrema: roots of 3aθ² + 2bθ + c
    A = 3.0 * a
    B = 2.0 * b
    disc = B * B - 4.0 * A * c
    real = disc >= 0.0
    sq = torch.where(real, torch.sqrt(torch.where(real, disc, one)), zero)
    tiny = torch.abs(A) < 1e-30 * (1.0 + torch.abs(B))
    safe_A = torch.where(tiny, one, A)
    r1 = (-B - sq) / (2.0 * safe_A)
    r2 = (-B + sq) / (2.0 * safe_A)
    # quadratic (a≈0) case: single extremum at -c/B
    lin = -c / torch.where(torch.abs(B) < 1e-30, one, B)
    r1 = torch.where(real, torch.where(tiny, lin, r1), zero)
    r2 = torch.where(real, torch.where(tiny, lin, r2), zero)
    t1 = torch.clamp(torch.minimum(r1, r2), 0.0, 1.0)
    t2 = torch.clamp(torch.maximum(r1, r2), 0.0, 1.0)

    # scan the ≤3 monotone segments for the first sign change
    nodes = (zero, t1, t2, one)
    vals = (c0, poly(t1), poly(t2), c1)
    found = torch.zeros_like(c0, dtype=torch.bool)
    lo, hi, cl = zero, one, c0
    for k in range(3):
        sc = ((vals[k] < 0) != (vals[k + 1] < 0)) & ~found
        lo = torch.where(sc, nodes[k], lo)
        hi = torch.where(sc, nodes[k + 1], hi)
        cl = torch.where(sc, vals[k], cl)
        found = found | sc

    # bisection on the cubic (pure polynomial evaluations)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        cm = poly(mid)
        same = (cm < 0) == (cl < 0)
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
        cl = torch.where(same, cm, cl)
    theta = torch.where(found, 0.5 * (lo + hi), zero)
    return found, theta
