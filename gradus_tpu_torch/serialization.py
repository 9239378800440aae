"""Artifact serialization: save and load precomputed tables and caches as
npz (counterpart of `gradus_tpu/serialization.py`, in its on-disk format).

A file holds the object's structure as JSON (``__tree__``) and its arrays
as numbered payloads (``arr_i``), with no pickle. A dataclass is
``{"__dc__": class name, "fields": {...}}``; a metric or a geometry, which
the port holds as an `nn.Module`, is written as the JAX package's
dataclass of the same name (its fields, from `interop._KINDS`), so that a
table, a `GeodesicPoint`, a render cache or a metric saved by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

__all__ = ["save_npz", "load_npz"]


def _registry():
    """Name → class of every dataclass of the port that a file may hold."""
    import gradus_tpu_torch as gt
    from gradus_tpu_torch.camera.render import EndpointRenderCache
    from gradus_tpu_torch.corona import extended, profiles
    from gradus_tpu_torch.integrate.points import GeodesicPoint
    from gradus_tpu_torch.transfer.cunningham import TransferBranchGrid
    from gradus_tpu_torch.transfer.tables import CunninghamTransferTable

    classes = [TransferBranchGrid, CunninghamTransferTable, EndpointRenderCache, GeodesicPoint]
    for module in (gt, profiles, extended):
        for name in dir(module):
            obj = getattr(module, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                classes.append(obj)
    return {cls.__name__: cls for cls in classes}


def _module_kinds():
    from gradus_tpu_torch.interop import _KINDS

    return _KINDS


def save_npz(path, obj) -> None:
    """Serialize a (possibly nested) dataclass, metric, geometry or tensor
    tree to ``path`` as a portable npz (structure as JSON and numbered
    array payloads)."""
    arrays: list[np.ndarray] = []
    kinds = _module_kinds()

    def arr(a):
        arrays.append(np.asarray(a.detach().cpu()) if isinstance(a, torch.Tensor) else np.asarray(a))
        return {"__arr__": len(arrays) - 1}

    def enc(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {"__dc__": type(o).__name__, "fields": {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}}
        if isinstance(o, torch.nn.Module):
            name = type(o).__name__
            if name not in kinds:
                raise TypeError(f"cannot serialize {name}: it holds more than numbers")
            return {"__dc__": name, "fields": {k: arr(getattr(o, k)) for k in kinds[name][1]}}
        if isinstance(o, (torch.Tensor, np.ndarray, np.generic)):
            return arr(o)
        if o is None:
            return {"__none__": True}
        if isinstance(o, (bool, int, float, str)):
            return o
        if isinstance(o, (list, tuple)):
            return {"__seq__": [enc(v) for v in o], "tuple": isinstance(o, tuple)}
        raise TypeError(
            f"cannot serialize {type(o).__name__} (analytic callables and custom objects are not npz-serializable)"
        )

    tree = enc(obj)
    np.savez(path, __tree__=np.asarray(json.dumps(tree)), **{f"arr_{i}": a for i, a in enumerate(arrays)})


def load_npz(path, *, device=None):
    """Inverse of `save_npz`: arrays come back as tensors on ``device``
    (the card when None), each in its stored dtype; a metric or a geometry
    as the port's module, in the dtype of its stored fields."""
    from gradus_tpu_torch.config import default_device
    from gradus_tpu_torch.interop import from_numpy

    device = default_device(device)
    registry, kinds = _registry(), _module_kinds()
    with np.load(path, allow_pickle=False) as data:
        tree = json.loads(str(data["__tree__"]))
        arrays = {int(k[4:]): data[k] for k in data.files if k.startswith("arr_")}

    def dec(o):
        if isinstance(o, dict):
            if "__dc__" in o:
                name = o["__dc__"]
                if name in kinds:
                    # the JAX package writes a number field as a JSON number
                    fields = {k: arrays[v["__arr__"]] if isinstance(v, dict) else np.asarray(v) for k, v in o["fields"].items()}
                    dtypes = {a.dtype for a in fields.values()} or {np.dtype(np.float64)}
                    dtype = torch.float32 if dtypes == {np.dtype(np.float32)} else torch.float64
                    return from_numpy(name, fields, dtype=dtype, device=device)
                cls = registry.get(name)
                if cls is None:
                    raise KeyError(f"unknown serialized class {name!r}")
                return cls(**{k: dec(v) for k, v in o["fields"].items()})
            if "__arr__" in o:
                return torch.as_tensor(arrays[o["__arr__"]], device=device)
            if "__none__" in o:
                return None
            if "__seq__" in o:
                seq = [dec(v) for v in o["__seq__"]]
                return tuple(seq) if o.get("tuple") else seq
        return o

    return dec(tree)
