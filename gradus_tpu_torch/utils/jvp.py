"""Forward-mode derivatives through the lockstep solver without PyTorch's
zero-tangent slow path.

Under `torch.func.jvp`, an arithmetic op between a dual tensor and an
operand without a tangent (a Python number, a metric parameter, a solver
constant) gives that operand an "efficient zero" tangent. Ops on such
tangents infer their result's shape through the Python meta kernels of
`torch._meta_registrations`: ~0.3 ms of host time an op on the CPU, against
~0.02 ms for an op between two duals. The lockstep solver's loop body has
~500 such ops an iteration, so they are most of a jvp's time.

`jvp` is `torch.func.jvp` with those operands lifted to duals of zero
tangent first, by one `torch.where` that selects the constant (the primal
values, and so every primal bit, stay the same). A zero tangent and an
"efficient zero" one give the same tangent arithmetic wherever the primal
values are finite. A divisor that is a Python number or a CPU scalar is
not lifted: PyTorch's CUDA kernel multiplies by its reciprocal, where a
tensor divisor is divided by, and the lift would change the last bit.
"""

from __future__ import annotations

import numbers

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["jvp"]

_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor

_T = torch.Tensor
# elementwise binary arithmetic whose forward-mode formula reads the other
# operand's tangent
_LIFTED = {
    _T.__add__, _T.__radd__, _T.__sub__, _T.__rsub__, _T.__mul__, _T.__rmul__,
    _T.__truediv__, _T.__rtruediv__,
    _T.add, _T.sub, _T.mul, _T.div, _T.maximum, _T.minimum, _T.atan2,
    torch.add, torch.sub, torch.mul, torch.div, torch.true_divide,
    torch.maximum, torch.minimum, torch.atan2, torch.arctan2, torch.hypot,
}  # fmt: skip
_DIVISIONS = {_T.__truediv__, _T.div, torch.div, torch.true_divide}


def _host_scalar(c):
    return not isinstance(c, torch.Tensor) or (c.dim() == 0 and c.device.type == "cpu")


class _LiftConstants(TorchFunctionMode):
    """Lifts, in a binary op of `_LIFTED`, the operand that likely carries no
    tangent: a Python number, a tensor outside the transform, or a 0-d
    tensor beside one with more dimensions. The lift is
    ``torch.where(False, other, operand)``, whose primal is the operand and
    whose tangent is the operand's (or a zero tensor), so lifting an operand
    that does carry a tangent changes nothing but the op count."""

    def __init__(self):
        super().__init__()
        self._false = {}

    def _lift(self, c, like):
        f = self._false.get(like.device)
        if f is None:
            f = self._false[like.device] = torch.zeros((), dtype=torch.bool, device=like.device)
        return torch.where(f, like, c)

    @staticmethod
    def _constant_side(a, b):
        """0 or 1, the index of the operand to lift, or None."""
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if ta and tb:
            if not (a.is_floating_point() and b.is_floating_point()):
                return None
            if (a.dim() == 0) != (b.dim() == 0):
                return 0 if a.dim() == 0 else 1
            wa, wb = _is_wrapped(a), _is_wrapped(b)
            return None if wa == wb else (1 if wa else 0)
        if ta and a.is_floating_point() and isinstance(b, numbers.Number) and not isinstance(b, bool):
            return 1
        if tb and b.is_floating_point() and isinstance(a, numbers.Number) and not isinstance(a, bool):
            return 0
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _LIFTED and len(args) == 2 and not kwargs:
            a, b = args
            side = self._constant_side(a, b)
            if side == 1 and func in _DIVISIONS and _host_scalar(b):
                side = None
            if side == 0:
                args = (self._lift(a, b), b)
            elif side == 1:
                args = (a, self._lift(b, a))
        return func(*args, **(kwargs or {}))


def jvp(func, primals, tangents, **kwargs):
    """`torch.func.jvp(func, primals, tangents, **kwargs)`, with the
    operands that carry no tangent lifted to zero-tangent duals."""
    with _LiftConstants():
        return torch.func.jvp(func, primals, tangents, **kwargs)
