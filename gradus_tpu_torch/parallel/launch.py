"""Start the ranks of a mesh on this host: `spawn` runs ``fn(mesh, *args)``
in ``world_size`` new processes, one rank each, over a `FileStore` (no
network port), and returns each rank's return value.

Under `torchrun` the ranks exist already: each calls
`torch.distributed.init_process_group()` and then `ray_mesh()` instead.
"""

from __future__ import annotations

import datetime
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gradus_tpu_torch.parallel.mesh import backend_for, rank_device, ray_mesh

__all__ = ["spawn"]


def _rank_main(rank, fn, world_size, root, device, backend, timeout, threads, args):
    if threads is not None:
        torch.set_num_threads(threads)
    backend = backend or backend_for(rank_device(device, rank))
    kw = {} if timeout is None else dict(timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, store=dist.FileStore(str(Path(root) / "store"), world_size), rank=rank, world_size=world_size, **kw)
    try:
        out = fn(ray_mesh(device=device, backend=backend), *args)
        torch.save(out, Path(root) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), *, device=None, backend=None, root=None, timeout=None, threads=None):
    """Runs ``fn(mesh, *args)`` (``fn`` importable by name: a module-level
    function) on ``world_size`` fresh processes. Rank r's process group is
    initialised over a `FileStore` in ``root`` (a new temporary directory
    when None) with ``backend`` (the device's by default, `backend_for`),
    and its mesh is ``ray_mesh(device=device, backend=backend)``. Returns
    the ranks' return values in rank order, loaded on the CPU.
    ``threads``: each rank's `torch.set_num_threads`; ``timeout``: the
    collectives' (s). Raises if a rank raises or dies (the others are
    ended)."""
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        mp.start_processes(
            _rank_main,
            args=(fn, world_size, tmp, device, backend, timeout, threads, tuple(args)),
            nprocs=world_size,
            join=True,
            start_method="spawn",
        )
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu", weights_only=False) for r in range(world_size)]
