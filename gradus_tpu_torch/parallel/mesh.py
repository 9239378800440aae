"""The ray mesh over `torch.distributed` (counterpart of
`gradus_tpu/parallel/mesh.py`).

The JAX package shards one mesh axis, "rays", with `shard_map`. Here the
program is SPMD: one process a GPU, every rank calling the same function
with the same arguments. A rank holds a contiguous shard of the ray axis
(`shard_rows`); the reference's `psum`/`pmin`/`pmax` are `all_reduce` with
SUM/MIN/MAX (`psum`, `pmin`, `pmax`), and a sharded output is gathered into
the full batch on every rank (`all_gather`), the counterpart of the global
array that JAX returns.

Without an initialised process group, `ray_mesh()` is the one-process mesh
of world size 1 (JAX's one-device mesh), whose collectives are the
identity.

The collectives carry derivatives as JAX's do under `shard_map`. `psum` is
linear: its tangent is the psum of the ranks' tangents (`torch.func.jvp`,
`torch.autograd.forward_ad`), and in reverse mode a rank's input gets the
cotangent of the reduced value as it is, since that value is replicated
(the same on every rank, as an ``out_specs=P()`` output is in JAX), so
`torch.autograd.grad` of a loss through it gives what `jax.grad` does.
`all_gather` gathers the tangents, and its backward hands each rank the
rows of the cotangent that it contributed. `pmin` and `pmax` have no
derivative, as `jax.lax.pmin`/`pmax` have none: differentiating through
them raises `NotImplementedError`.

Not here: `P_RAYS` and `P_NONE`, JAX `PartitionSpec`s. A rank's shard
follows from its rank, and a replicated value is any tensor that every rank
computes alike, so they have no torch meaning (as `enable_x64` has none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["RayMesh", "ray_mesh", "psum", "pmin", "pmax", "all_gather", "shard_rows"]

AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A one-axis mesh of ``size`` ranks: the process ``group`` (None for
    the one-process mesh), this process's ``rank`` in it, the ``device``
    its shard lives on and the group's ``backend``."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str | None
    axis_name: str = AXIS


def backend_for(device: torch.device) -> str:
    """The backend a device's collectives take by default."""
    return "nccl" if device.type == "cuda" else "gloo"


def ray_mesh(n_devices: int | None = None, *, device=None, backend: str | None = None) -> RayMesh | None:
    """The mesh over every rank of the initialised process group (or its
    first ``n_devices``, a `dist.new_group` that every rank must ask for
    alike; a rank past them gets None). Without a process group, the
    one-process mesh of world size 1.

    ``device``: the rank's device, ``cuda:<local rank>`` (``LOCAL_RANK``,
    else the rank) unless given, ``"cpu"`` for the CPU. ``backend``: the
    caller's, else ``nccl`` for a CUDA device and ``gloo`` for the CPU; it
    must be the group's (`torch.distributed.init_process_group`'s, which
    `torchrun`'s ranks call, or `parallel.spawn`'s), never swapped for
    another."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"no process group is initialised: the mesh has 1 rank, not {n_devices}")
        return RayMesh(group=None, rank=0, size=1, device=rank_device(device, 0), backend=None)
    world, me = dist.get_world_size(), dist.get_rank()
    dev = rank_device(device, me)
    want, have = backend or backend_for(dev), dist.get_backend()
    if want != have:
        raise ValueError(
            f"the process group's backend is {have!r}, not {want!r} (the {'given' if backend else dev.type} "
            f"backend): pass backend={have!r} to use it"
        )
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"the process group has {world} ranks: a mesh of {n_devices} is not in it")
    group = dist.group.WORLD if n == world else dist.new_group(ranks=list(range(n)), backend=have)
    if me >= n:
        return None
    return RayMesh(group=group, rank=me, size=n, device=dev, backend=have)


def rank_device(device, rank: int) -> torch.device:
    """``device``, or ``cuda:<local rank>`` (``LOCAL_RANK``, else ``rank``)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))


def _group(axis_name):
    """(process group, size) of a mesh or a group; torch has no named axes."""
    if isinstance(axis_name, RayMesh):
        return axis_name.group, axis_name.size
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name, dist.get_world_size(axis_name)
    raise TypeError(
        "axis_name takes the port's mesh (gradus_tpu_torch.parallel.ray_mesh()) or its process "
        f"group, not {type(axis_name).__name__}: torch has no named mesh axes"
    )


_OP_NAMES = {dist.ReduceOp.SUM: "psum", dist.ReduceOp.MIN: "pmin", dist.ReduceOp.MAX: "pmax"}


def _reduced(x, group, op):
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """`dist.all_reduce` out of place, with JAX's derivative rules: SUM's
    tangent is the psum of the tangents and its cotangent passes through;
    MIN and MAX have none."""

    @staticmethod
    def forward(x, group, op):
        return _reduced(x, group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.op = inputs

    @staticmethod
    def _linear(ctx):
        if ctx.op != dist.ReduceOp.SUM:
            name = _OP_NAMES[ctx.op]
            raise NotImplementedError(f"{name} has no derivative (jax.lax.{name} has none)")

    @staticmethod
    def jvp(ctx, dx, _group, _op):
        _AllReduce._linear(ctx)
        return _reduced(dx, ctx.group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        _AllReduce._linear(ctx)
        return ct, None, None


def _all_reduce(x, axis_name, op):
    group, _ = _group(axis_name)
    if group is None:
        return x
    return _AllReduce.apply(x, group, op)


def psum(x, axis_name):
    """Σ of ``x`` over the mesh's ranks, on every rank (`jax.lax.psum`)."""
    return _all_reduce(x, axis_name, dist.ReduceOp.SUM)


def pmin(x, axis_name):
    """Elementwise min of ``x`` over the mesh's ranks (`jax.lax.pmin`)."""
    return _all_reduce(x, axis_name, dist.ReduceOp.MIN)


def pmax(x, axis_name):
    """Elementwise max of ``x`` over the mesh's ranks (`jax.lax.pmax`)."""
    return _all_reduce(x, axis_name, dist.ReduceOp.MAX)


def _gathered(x, group, size):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class _AllGather(torch.autograd.Function):
    """`dist.all_gather` along axis 0: the tangents are gathered alike, and
    a rank's input gets its own rows of the (replicated) cotangent."""

    @staticmethod
    def forward(x, group, size):
        return _gathered(x, group, size)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.group, ctx.size = inputs
        ctx.rows = x.shape[0]

    @staticmethod
    def jvp(ctx, dx, _group, _size):
        return _gathered(dx, ctx.group, ctx.size)

    @staticmethod
    def backward(ctx, ct):
        k = ctx.rows
        rank = dist.get_rank(ctx.group)
        return ct[rank * k : (rank + 1) * k], None, None


def all_gather(x, axis_name):
    """The ranks' ``x`` (one shape on every rank) concatenated along axis
    0 in rank order, on every rank: a sharded output made global."""
    group, size = _group(axis_name)
    if group is None:
        return x
    return _AllGather.apply(x, group, size)


def shard_rows(x, mesh: RayMesh):
    """This rank's contiguous rows of ``x``, whose axis 0 the mesh's size
    divides (`sharded.pad_to_multiple`)."""
    k = x.shape[0] // mesh.size
    return x[mesh.rank * k : (mesh.rank + 1) * k]
