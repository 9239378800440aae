"""Build the CUDA sources of `csrc/` into a shared library with a plain C
interface, at first use, and load it with ctypes.

The library goes to ``build/gradus_tpu_torch/`` at the root of the checkout,
under a name that hashes the sources, the headers and the flags, so an
edited ``.cu`` or ``.cuh`` file rebuilds. Each ``.cu`` file is compiled by
its own nvcc, all started together, and the objects are linked into one
library. Only the sources in this package are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_info", "NVCC_FLAGS"]

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
_info: dict = {}


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


def _run_nvcc(cmds):
    """Run the nvcc commands concurrently; (their stdout+stderr, joined).
    Raises on the first that fails."""
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
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process. Raises if the toolkit is missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = _BUILD_DIR / f"libgradus_tpu_torch_{digest.hexdigest()[:16]}.so"
    log_path = target.with_suffix(".log")

    t0 = time.perf_counter()
    built = False
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        stem = f"{target.stem}.{os.getpid()}"
        objs = [_BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
        log = _run_nvcc(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)]
        )
        tmp = target.with_name(f"{stem}.tmp.so")
        log += _run_nvcc([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
        for o in objs:
            o.unlink()
        log_path.write_text(log)
        os.replace(tmp, target)
        built = True
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


def build_info() -> dict:
    """Library path, whether this process built it, the seconds that build
    (or load) took, and nvcc's ``-Xptxas -v`` report."""
    return dict(_info)


def _declare(lib):
    vp, dbl, i32, i64 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int64
    for name in ("geodesic_tsit5_f32", "geodesic_tsit5_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [
            vp, i64,  # y0, n
            i32, dbl, dbl,  # metric kind, M, a
            ctypes.POINTER(dbl),  # the metric's other parameters, double[5]
            i32, dbl, dbl, dbl,  # geometry kind, inner_r, outer_r, height
            dbl, dbl, dbl, dbl,  # abstol, reltol, r_inner, r_outer
            dbl, dbl, i32, dbl,  # lam0, lam1, max_steps (or the iteration cap), dt_min
            ctypes.POINTER(i32),  # modes: sampled, n_interp, bisect_iters, terminate_on_hit
            ctypes.POINTER(vp),  # the carry of a resumed launch (11 pointers), or null
            ctypes.POINTER(vp),  # the 13 outputs
            vp,  # stream
        ]
        fn.restype = ctypes.c_int
