"""Build the CUDA sources of `csrc/` into a shared library with a plain C
interface, at first use, and load it with ctypes.

The library goes to ``build/gradus_tpu_torch/`` at the root of the checkout,
under a name that hashes the sources, the headers and the flags, so an
edited ``.cu`` or ``.cuh`` file rebuilds. Each ``.cu`` file is compiled by
its own nvcc, all started together, and the objects are linked into one
library. Only the sources in this package are compiled.

A geometry with a cross-section callable (`WarpedThinDisc`, `ThickDisc`)
runs a unit that `geometry/codegen.py` generates from the callable
(`load_callable_library`): one ``.cu`` file, compiled and linked by one
nvcc into ``build/gradus_tpu_torch/callables/`` under a name that hashes
its text, the headers and the flags, so identical callables share a build
across processes and a different constant builds anew.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "load_callable_library", "callable_key", "build_info", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gradus_tpu_torch"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lib = None
_info: dict = {"callables": {}}
# the generated units' libraries of this process, by `callable_key`
_callable_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    raise RuntimeError(
        "nvcc was not found (no CUDA toolkit; set CUDA_HOME): the CUDA kernels "
        "of gradus_tpu_torch are built from csrc/ at first use on a GPU machine"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _headers():
    return sorted(_CSRC.glob("*.cuh"))


def _run_nvcc(cmds, split=False):
    """Run the nvcc commands concurrently; their stdout+stderr, joined (a
    list, one a command, with ``split``). Raises on the first that fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed is not None:
        raise RuntimeError(failed)
    return logs if split else "".join(logs)


def _library_target():
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return sources, _BUILD_DIR / f"libgradus_tpu_torch_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def _headers_digest() -> bytes:
    """The headers and the flags, hashed once a process (a launch keys its
    unit each time)."""
    digest = hashlib.sha256()
    for src in _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.digest()


def callable_key(source: str) -> str:
    """The build key of a generated unit: a hash of its text, the headers
    and the flags."""
    return hashlib.sha256(source.encode() + _headers_digest()).hexdigest()[:16]


def _callable_target(key):
    return _BUILD_DIR / "callables" / f"libgradus_callable_{key}.so"


def _ptxas_summary(log):
    """The largest register count and the spill lines of ``-Xptxas -v``."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [line.strip() for line in log.splitlines() if "spill" in line and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)]
    return dict(registers=max(regs, default=None), spills=spills)


def load_library(units=()) -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process. Raises if the toolkit is missing or the build fails.

    ``units``: generated units (`geometry.codegen.KernelUnit`) to build in
    the same pass, their nvcc runs started with the library's, and load
    (`load_callable_library`)."""
    global _lib
    missing = [u for u in units if callable_key(u.source) not in _callable_libs]
    if _lib is not None and not missing:
        return _lib
    sources, target = _library_target()
    log_path = target.with_suffix(".log")

    t0 = time.perf_counter()
    built = _lib is None and not target.exists()
    stem = f"{target.stem}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    cmds = []
    if built:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)]
    unit_cmds, unit_t0 = _callable_commands(missing), time.perf_counter()
    logs = _run_nvcc(cmds + [cmd for _, cmd, _ in unit_cmds], split=True)
    unit_seconds = time.perf_counter() - unit_t0
    for (key, _, tmp), log in zip(unit_cmds, logs[len(cmds) :]):
        _finish_callable(key, tmp, log, unit_seconds)
    for u in missing:
        _load_callable(u)
    if _lib is not None:
        return _lib
    if built:
        log = "".join(logs[: len(cmds)])
        tmp = target.with_name(f"{stem}.tmp.so")
        log += _run_nvcc([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        log_path.write_text(log)
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _info.update(
        path=str(target),
        built=built,
        seconds=time.perf_counter() - t0,
        ptxas=log_path.read_text() if log_path.exists() else "",
    )
    _declare(lib)
    _lib = lib
    return lib


def _callable_commands(units):
    """[(key, nvcc command, its temporary output)] of the units not built
    yet (one each, the same text once)."""
    out, seen = [], set()
    for u in units:
        key = callable_key(u.source)
        target = _callable_target(key)
        if key in seen or target.exists():
            continue
        seen.add(key)
        target.parent.mkdir(parents=True, exist_ok=True)
        src = target.with_suffix(".cu")
        src.write_text(u.source)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        out.append((key, [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-shared", "-o", str(tmp), str(src)], tmp))
    return out


def _finish_callable(key, tmp, log, seconds):
    target = _callable_target(key)
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)
    _info["callables"][key] = dict(built=True, seconds=seconds)


def _load_callable(unit):
    key = callable_key(unit.source)
    target = _callable_target(key)
    lib = ctypes.CDLL(str(target))
    _declare(lib, (unit.entry,))
    log_path = target.with_suffix(".log")
    info = _info["callables"].setdefault(key, dict(built=False, seconds=0.0))
    info.update(path=str(target), entry=unit.entry, **_ptxas_summary(log_path.read_text() if log_path.exists() else ""))
    _callable_libs[key] = lib
    return lib


def load_callable_library(unit) -> ctypes.CDLL:
    """The library of a generated unit (`geometry.codegen.kernel_unit`):
    built by nvcc at its first use in any process (keyed by
    `callable_key`), loaded once per process. Raises with nvcc's log if the
    build fails, and if a build would start inside a CUDA-graph capture."""
    key = callable_key(unit.source)
    if key in _callable_libs:
        return _callable_libs[key]
    if not _callable_target(key).exists():
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a cross-section's kernel would be built inside a CUDA-graph capture: trace once "
                "before capturing (the build runs at the tracer's first call)"
            )
        cmds = _callable_commands([unit])
        t0 = time.perf_counter()
        logs = _run_nvcc([cmd for _, cmd, _ in cmds], split=True)
        for (k, _, tmp), log in zip(cmds, logs):
            _finish_callable(k, tmp, log, time.perf_counter() - t0)
    return _load_callable(unit)


def build_info() -> dict:
    """Library path, whether this process built it, the seconds that build
    (or load) took, and nvcc's ``-Xptxas -v`` report; under ``callables``,
    each generated unit's library by key: its path, entry, whether this
    process built it, the seconds of that build (of the pass that built it,
    with the library, for `load_library`'s ``units``), and ptxas's largest
    register count and its spill lines."""
    return {**_info, "callables": {k: dict(v) for k, v in _info["callables"].items()}}


def _declare(lib, names=("geodesic_tsit5_f32", "geodesic_tsit5_f64")):
    vp, dbl, i32, i64 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int64
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [
            vp, i64,  # y0, n
            i32, dbl, dbl,  # metric kind, M, a
            ctypes.POINTER(dbl),  # the metric's other parameters, double[5]
            i32, dbl, dbl, dbl,  # geometry kind, inner_r, outer_r, height
            vp,  # kinds 3-7: the geometry's block on the device (csrc/geometry.cuh), or null
            dbl, dbl, dbl, dbl,  # abstol, reltol, r_inner, r_outer
            dbl, dbl, i32, dbl,  # lam0, lam1, max_steps (or the iteration cap), dt_min
            ctypes.POINTER(i32),  # modes: sampled, n_interp, bisect_iters, terminate_on_hit, newton_iters
            ctypes.POINTER(vp),  # the carry of a resumed launch (11 pointers), or null
            ctypes.POINTER(vp),  # the 13 outputs
            vp,  # stream
        ]
        fn.restype = ctypes.c_int
