"""The tensors a trace reads from its metric, geometry and trace record,
found and swapped in place, so that a captured lockstep loop can take them
as inputs (the parameter tangents of `tracing.trace_geodesics` under a
`torch.func` transform on a CUDA tensor, and the parameter gradients of
`solver.integrate_rays_checkpointed`'s captured backward).

A slot is ``(owner, name)``: a buffer or parameter of an `nn.Module` (of the
module and of every submodule), or a tensor field of a dataclass (of the
object and of the dataclasses, modules, tuples and lists it holds). `bound`
swaps values into the slots, as `torch.func.functional_call` swaps a
module's buffers; a loop body that closes over the owners then reads the
values it is given. `find_unlifted` walks what a trace closes over (object
attributes, dataclass fields, containers, function closures and defaults)
for a tensor that a transform would differentiate but that no slot holds:
such a tensor cannot enter a captured loop, and the caller raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import types

import torch
from torch import nn

__all__ = ["tensor_slots", "slot_values", "bound", "find_unlifted"]


def _children(obj):
    """The objects a slot search descends into: a module's submodules, a
    dataclass's fields, a container's items."""
    if isinstance(obj, (tuple, list)):
        return list(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return []


def tensor_slots(*objs):
    """The ``(owner, name)`` slots of the tensors that ``objs`` hold, each
    tensor once, in a fixed order."""
    slots, seen, tensors = [], set(), set()

    def visit(obj):
        if obj is None or id(obj) in seen or isinstance(obj, torch.Tensor):
            return
        seen.add(id(obj))
        if isinstance(obj, nn.Module):
            for mod in obj.modules():
                for store in (mod._parameters, mod._buffers):
                    for name, t in store.items():
                        if t is not None and id(t) not in tensors:
                            tensors.add(id(t))
                            slots.append((mod, name))
            for value in vars(obj).values():
                if not isinstance(value, (nn.Module, torch.Tensor, dict)):
                    visit(value)
            return
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                t = getattr(obj, f.name)
                if isinstance(t, torch.Tensor) and id(t) not in tensors:
                    tensors.add(id(t))
                    slots.append((obj, f.name))
        for child in _children(obj):
            visit(child)

    for obj in objs:
        visit(obj)
    return slots


def _get(slot):
    owner, name = slot
    if isinstance(owner, nn.Module):
        return owner._parameters[name] if name in owner._parameters else owner._buffers[name]
    return getattr(owner, name)


def _set(slot, value):
    owner, name = slot
    if isinstance(owner, nn.Module):
        (owner._parameters if name in owner._parameters else owner._buffers)[name] = value
    else:
        object.__setattr__(owner, name, value)


def slot_values(slots):
    """The tensors the slots hold now."""
    return [_get(s) for s in slots]


@contextlib.contextmanager
def bound(slots, values):
    """Within the block, each slot holds its value of ``values``."""
    before = slot_values(slots)
    try:
        for s, v in zip(slots, values):
            _set(s, v)
        yield
    finally:
        for s, v in zip(slots, before):
            _set(s, v)


def find_unlifted(roots: dict, lifted, wanted, depth: int = 6):
    """The path of the first tensor reachable from ``roots`` (name → object)
    for which ``wanted(tensor)`` holds and that is none of ``lifted``, or
    None. The walk follows object attributes, dataclass fields, containers
    and dicts, and a function's closure cells and defaults."""
    lifted = {id(t) for t in lifted}
    seen = set()

    def walk(obj, path, d):
        if isinstance(obj, torch.Tensor):
            return path if id(obj) not in lifted and wanted(obj) else None
        if d == 0 or obj is None or id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool, type)):
            return None
        seen.add(id(obj))
        items = []
        if isinstance(obj, nn.Module):
            items = [(f".{k}", v) for k, v in {**obj._parameters, **obj._buffers, **obj._modules}.items()]
            items += [(f".{k}", v) for k, v in vars(obj).items() if not k.startswith("_")]
        elif isinstance(obj, (tuple, list)):
            items = [(f"[{i}]", v) for i, v in enumerate(obj)]
        elif isinstance(obj, dict):
            items = [(f"[{k!r}]", v) for k, v in obj.items()]
        elif isinstance(obj, (types.FunctionType, types.MethodType)):
            fn = getattr(obj, "__func__", obj)
            cells = [c.cell_contents for c in (fn.__closure__ or ()) if _filled(c)]
            items = [(f".__closure__[{i}]", v) for i, v in enumerate(cells)]
            items += [(f".__defaults__[{i}]", v) for i, v in enumerate(fn.__defaults__ or ())]
            if isinstance(obj, types.MethodType):
                items.append((".__self__", obj.__self__))
        elif isinstance(obj, functools.partial):
            items = [(".func", obj.func)] + [(f".args[{i}]", v) for i, v in enumerate(obj.args)]
            items += [(f".keywords[{k!r}]", v) for k, v in obj.keywords.items()]
        elif hasattr(obj, "__dict__"):
            items = list((f".{k}", v) for k, v in vars(obj).items())
        for key, value in items:
            found = walk(value, path + key, d - 1)
            if found is not None:
                return found
        return None

    for name, obj in roots.items():
        found = walk(obj, name, depth)
        if found is not None:
            return found
    return None


def _filled(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True

