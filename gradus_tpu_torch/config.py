"""Solver tolerance policy, keyed on an explicit torch dtype, and the
port's default device.

Counterpart of `gradus_tpu/config.py`. The port has no global x64 switch and
sets no process-global flag at import: every contraction on the main path is
written as elementwise products and sums, so no matmul precision setting
(TF32) can reach it.

The port runs on the card unless the caller asks for the CPU: a parameter
module built with ``device=None`` lands on ``cuda`` (and raises where torch
has no CUDA device); the CPU, where the kernels' plain versions run, is
``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = [
    "default_device",
    "default_tols",
    "DEFAULT_ABSTOL_F64",
    "DEFAULT_RELTOL_F64",
    "DEFAULT_ABSTOL_F32",
    "DEFAULT_RELTOL_F32",
]

# Reference defaults (Gradus.jl src/tracing/configuration.jl:1): 1e-9 in f64.
DEFAULT_ABSTOL_F64 = 1e-9
DEFAULT_RELTOL_F64 = 1e-9
# float32 has ~1.2e-7 eps; 1e-6 is the tightest tolerance that converges robustly.
DEFAULT_ABSTOL_F32 = 1e-6
DEFAULT_RELTOL_F32 = 1e-6


def default_tols(dtype: torch.dtype):
    """(abstol, reltol) defaults for the given torch dtype."""
    if dtype == torch.float64:
        return DEFAULT_ABSTOL_F64, DEFAULT_RELTOL_F64
    return DEFAULT_ABSTOL_F32, DEFAULT_RELTOL_F32


def default_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; None means the card."""
    return torch.device("cuda" if device is None else device)
