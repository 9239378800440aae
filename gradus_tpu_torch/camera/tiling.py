"""Spatially-coherent ray ordering for tile-resident integration
(counterpart of `gradus_tpu/camera/tiling.py`; numpy only).

The TPU kernel (`gradus_tpu/integrate/pallas_solver.py`) advances one tile of
``tile_rows * 128`` rays per grid step and exits the tile when all its rays are
done, so executed work is Σ_tiles max(steps in tile). Raster order is the worst
case: each tile is a thin strip that crosses the whole image (shadow edge, disc
and far field in one tile → every tile pays the global max). Re-ordering rays
so each tile is a compact pixel block makes per-tile step counts coherent.

On the TPU, for the 1024² Kerr a=0.998 flagship render, the JAX package's
notes give 32×32 pixel blocks about 90% of a cost-sorted oracle's saving
over raster tiles. The CUDA integrator runs one ray a thread, so its
counterpart is a warp of 32 rays: whether the same ordering pays there is
ROADMAP queue B's launch-order question.

Reference analogue: dynamic per-thread scheduling in
`src/tracing/tracing.jl:151-196` (EnsembleEndpointThreads) — threads grabbing
rays one at a time never wait on a slow tile; here coherence substitutes for
dynamic scheduling.
"""

from __future__ import annotations

import numpy as np

__all__ = ["block_permutation", "tile_permutation"]


def block_permutation(ny: int, nx: int, block: int = 32):
    """Permutation mapping block-major order to raster order.

    For an ``(ny, nx)`` raster-ravelled pixel grid, returns int32 arrays
    ``(perm, inv)`` such that ``rays[perm]`` groups each ``block × block``
    pixel tile contiguously (block-row-major over tiles), and
    ``out[inv]`` restores raster order. Grid dims that don't divide evenly
    fall back to padding-free greedy blocking via `tile_permutation`.
    """
    if ny % block == 0 and nx % block == 0:
        perm = (
            np.arange(ny * nx, dtype=np.int64)
            .reshape(ny // block, block, nx // block, block)
            .transpose(0, 2, 1, 3)
            .ravel()
        )
    else:
        perm = tile_permutation(ny, nx, block)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm.astype(np.int32), inv.astype(np.int32)


def tile_permutation(ny: int, nx: int, block: int = 32):
    """Blocking permutation for grids not divisible by ``block``: tiles are
    clipped at the right/bottom edges (ragged tiles stay contiguous)."""
    idx = np.arange(ny * nx, dtype=np.int64).reshape(ny, nx)
    out = []
    for by in range(0, ny, block):
        for bx in range(0, nx, block):
            out.append(idx[by : by + block, bx : bx + block].ravel())
    return np.concatenate(out)
