"""Metric interface: an `nn.Module` holding its parameters as buffers, plus
pure component functions (counterpart of `gradus_tpu/metrics/base.py`).

Every static, axis-symmetric spacetime is described by its 5 non-zero metric
components ``(g_tt, g_rr, g_θθ, g_φφ, g_tφ)`` as functions of ``(r, θ)``.
"""

from __future__ import annotations

import torch
from torch import nn

from gradus_tpu_torch.config import default_device
from gradus_tpu_torch.utils.linalg import sym4x4, sym4x4_inverse_components

__all__ = [
    "AbstractMetric",
    "unpack_rtheta",
    "metric_components",
    "metric_4x4",
    "inverse_metric_components",
    "inner_radius",
]


class AbstractMetric(nn.Module):
    """Shared behaviour for static axis-symmetric metrics.

    Subclasses implement ``components5(r, θ)`` (a 5-tuple of tensors) and
    ``inner_radius()``, and hold their parameters as 0-d buffers named as
    the JAX dataclass's fields (`_register_params`), so ``.to(device,
    dtype)`` carries them with the module."""

    def _register_params(self, dtype, device, **params):
        """One 0-d buffer per parameter, in ``dtype`` on ``device`` (the card
        when None)."""
        device = default_device(device)
        self._device = device
        for name, value in params.items():
            self.register_buffer(name, torch.as_tensor(value, dtype=dtype, device=device))

    def components5(self, r, theta):  # pragma: no cover - interface
        raise NotImplementedError

    def components(self, r, theta):
        """The 5 components stacked on a trailing axis."""
        r, theta = torch.broadcast_tensors(r, theta)
        return torch.stack(self.components5(r, theta), dim=-1)

    def components5_jac(self, r, theta):
        """Value + (∂_r, ∂_θ) of the 5 components: three 5-tuples of tensors.
        The default is two forward-mode passes through ``components5``; hot
        metrics (Kerr) override with hand-derived closed forms."""
        return _ad_components5_jac(self, r, theta)

    def inner_radius(self):  # pragma: no cover - interface
        raise NotImplementedError

    def metric(self, x):
        """Full 4x4 covariant metric at position ``x`` ((r,θ) pair or 4-vector)."""
        r, theta = unpack_rtheta(x)
        return sym4x4(self.components(r, theta))

    def inverse_components(self, r, theta):
        return sym4x4_inverse_components(self.components(r, theta))

    def inverse_metric(self, x):
        r, theta = unpack_rtheta(x)
        return sym4x4(self.inverse_components(r, theta))

    def isco(self):
        from gradus_tpu_torch.orbits.special_radii import isco as _isco

        return _isco(self)

    @property
    def device(self):
        """The device of the parameters (of the constructor's ``device`` for
        a metric without parameters)."""
        b = next(self.buffers(), None)
        return getattr(self, "_device", None) if b is None else b.device


class _Dual:
    """A value and its derivatives along (r, θ), stacked on a leading axis
    of 2: the plain PyTorch version of the kernel's dual numbers
    (`csrc/dual.cuh`), with the derivative rules of JAX's jvp. A tensor or
    a number met in an operation is a constant. ``components5`` written with
    Python operators, integer powers, comparisons (on the value),
    `torch.sin`/`cos`/`sqrt`/`arctan`, `torch.where` (value and tangent of
    the branch the value's condition selects, as jax.jvp differentiates
    jnp.where) and `torch.ones_like`/`zeros_like` (constants) runs on it
    unchanged (`__torch_function__`)."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    @staticmethod
    def _parts(x):
        return (x.v, x.t) if isinstance(x, _Dual) else (x, None)

    @staticmethod
    def add(a, b):
        (av, at), (bv, bt) = _Dual._parts(a), _Dual._parts(b)
        return _Dual(av + bv, at if bt is None else bt if at is None else at + bt)

    @staticmethod
    def sub(a, b):
        (av, at), (bv, bt) = _Dual._parts(a), _Dual._parts(b)
        return _Dual(av - bv, at if bt is None else -bt if at is None else at - bt)

    @staticmethod
    def mul(a, b):
        (av, at), (bv, bt) = _Dual._parts(a), _Dual._parts(b)
        if bt is None:
            return _Dual(av * bv, at * bv)
        if at is None:
            return _Dual(av * bv, av * bt)
        return _Dual(av * bv, at * bv + av * bt)

    @staticmethod
    def div(a, b):
        (av, at), (bv, bt) = _Dual._parts(a), _Dual._parts(b)
        q = av / bv
        if bt is None:
            return _Dual(q, at / bv)
        if at is None:
            return _Dual(q, -q * bt / bv)
        return _Dual(q, (at - q * bt) / bv)

    def __add__(self, o):
        return _Dual.add(self, o)

    def __radd__(self, o):
        return _Dual.add(o, self)

    def __sub__(self, o):
        return _Dual.sub(self, o)

    def __rsub__(self, o):
        return _Dual.sub(o, self)

    def __mul__(self, o):
        return _Dual.mul(self, o)

    def __rmul__(self, o):
        return _Dual.mul(o, self)

    def __truediv__(self, o):
        return _Dual.div(self, o)

    def __rtruediv__(self, o):
        return _Dual.div(o, self)

    def __neg__(self):
        return _Dual(-self.v, -self.t)

    def __lt__(self, o):
        return self.v < _Dual._parts(o)[0]

    def __le__(self, o):
        return self.v <= _Dual._parts(o)[0]

    def __ge__(self, o):
        return self.v >= _Dual._parts(o)[0]

    @staticmethod
    def where(cond, a, b):
        (av, at), (bv, bt) = _Dual._parts(a), _Dual._parts(b)
        v = torch.where(cond, av, bv)
        if at is None and bt is None:
            return v
        zero = torch.zeros_like(at if bt is None else bt)
        return _Dual(v, torch.where(cond, zero if at is None else at, zero if bt is None else bt))

    def __pow__(self, n):
        if not isinstance(n, int):
            raise TypeError("a dual number takes integer powers only")
        return _Dual(self.v**n, (n * self.v ** (n - 1)) * self.t)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """A tensor operator with a dual operand (``tensor * dual`` reaches
        here as ``mul``), a function of a dual (`_DUAL_UNARY`), `torch.where`
        with a dual branch, or a constant shaped like a dual."""
        name = getattr(func, "__name__", "")
        if name in _DUAL_UNARY and len(args) == 1 and not kwargs:
            x = args[0]
            v, dv = _DUAL_UNARY[name](x.v)
            return _Dual(v, dv * x.t)
        if name in _DUAL_BINARY and len(args) == 2 and not kwargs:
            return _DUAL_BINARY[name](*args)
        if name == "where" and len(args) == 3 and not kwargs:
            return _Dual.where(*args)
        if name in ("ones_like", "zeros_like") and len(args) == 1:
            return func(args[0].v, **(kwargs or {}))
        raise TypeError(f"{name} is not defined on the port's dual numbers")


def _sqrt_rule(v):
    s = torch.sqrt(v)
    return s, 0.5 / s


def _atan_rule(v):
    return torch.arctan(v), 1.0 / (1.0 + v * v)


# (value, derivative) of the functions a metric's components5 may call
_DUAL_UNARY = {
    "sin": lambda v: (torch.sin(v), torch.cos(v)),
    "cos": lambda v: (torch.cos(v), -torch.sin(v)),
    "sqrt": _sqrt_rule,
    "arctan": _atan_rule,
}
_DUAL_BINARY = {"add": _Dual.add, "sub": _Dual.sub, "mul": _Dual.mul, "div": _Dual.div}


def _ad_components5_jac(m, r, theta):
    """Generic value + (∂_r, ∂_θ) of ``components5`` by forward-mode AD: one
    pass over dual numbers with two tangents, where JAX makes two jvp
    passes (the same derivatives up to rounding)."""
    r, theta = torch.broadcast_tensors(r, theta)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    g = m.components5(
        _Dual(r, torch.stack([one, zero])), _Dual(theta, torch.stack([zero, one]))
    )
    g = [c if isinstance(c, _Dual) else _Dual(c, torch.zeros_like(r)) for c in g]
    values = tuple(torch.broadcast_to(c.v, r.shape) for c in g)
    tangents = tuple(torch.broadcast_to(c.t, (2,) + r.shape) for c in g)
    return values, tuple(t[0] for t in tangents), tuple(t[1] for t in tangents)


def _as_observer(x, m):
    """A position or velocity as a tensor: float64 on the metric's device
    unless it is one."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float64, device=m.device)


def unpack_rtheta(x):
    """Accept a 4-position ``(t, r, θ, φ)``, an ``(r, θ)`` pair or tuple."""
    if isinstance(x, (tuple, list)):
        if len(x) == 2:
            return x[0], x[1]
        return x[1], x[2]
    if x.shape[-1] == 2:
        return x[..., 0], x[..., 1]
    return x[..., 1], x[..., 2]


# --- functional API (the reference's names) -----------------------------------


def metric_components(m: AbstractMetric, rtheta):
    """The 5 covariant components at an (r, θ) pair or a 4-position."""
    r, theta = unpack_rtheta(rtheta)
    return m.components(r, theta)


def metric_4x4(m: AbstractMetric, x):
    return m.metric(x)


def inverse_metric_components(m_or_comps, rtheta=None):
    """The 5 inverse components: of a metric at ``rtheta``, or of the
    covariant components ``m_or_comps`` when ``rtheta`` is None."""
    if rtheta is None:
        return sym4x4_inverse_components(m_or_comps)
    r, theta = unpack_rtheta(rtheta)
    return m_or_comps.inverse_components(r, theta)


def inner_radius(m: AbstractMetric):
    return m.inner_radius()
