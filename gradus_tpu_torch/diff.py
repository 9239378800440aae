"""Reverse-mode differentiation through the geodesic integrator
(counterpart of `gradus_tpu/diff.py`).

Physical fits have few parameters (mass, spin, deformation, disc radii,
corona height: ≲ 10 scalars) and many outputs (pixels, flux bins), so the
transposed-Jacobian adjoint is cheapest computed forward: `fwd_adjoint`
makes a `torch.autograd.Function` whose forward evaluates the full
parameter Jacobian with `torch.func.jacfwd` and whose backward contracts it
with the cotangent. Exact, O(n_params) forward cost, and it composes with
`torch.autograd.grad`, `loss.backward()` and `torch.func.grad` around it.
For many-parameter heads use the checkpointed ladder
(`trace_geodesics(..., checkpointed=True)`) and plain reverse mode.

Where the Jacobian runs: on CPU tensors `jacfwd` goes through the plain
lockstep loop, with the operands that carry no tangent lifted to
zero-tangent duals (`utils/jvp.py`: the same bits, ~2.5× faster). On a
CUDA tensor every `trace_geodesics` inside ``f`` meets the transform as
`tracing._LiftedTrace`: one captured pass carries the K parameter
tangents of `jacfwd` through the loop (a tensor under the transform that
the trace cannot lift raises there).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

from gradus_tpu_torch.utils.jvp import _LiftConstants

__all__ = ["fwd_adjoint", "value_and_grad_fwd", "grad_fwd"]


def _jacfwd(fun, leaves, **kwargs):
    """`torch.func.jacfwd` of ``fun`` over all its arguments ``leaves``, the
    constants lifted where the leaves lie on the CPU."""
    jac = torch.func.jacfwd(fun, argnums=tuple(range(len(leaves))), **kwargs)
    on_cpu = all(t.device.type == "cpu" for t in leaves)
    with _LiftConstants() if on_cpu else contextlib.nullcontext():
        return jac(*leaves)


def fwd_adjoint(f):
    """Make ``f(params, *args)`` reverse-differentiable with respect to
    ``params`` (a tensor, or a dict, tuple or list of tensors) by a
    backward built from the forward-mode Jacobian.

    `torch.autograd.grad`, ``backward()`` and `torch.func.grad` work
    through the wrapped function. The extra ``*args`` get no gradient (a
    zero one where a tensor argument requires it). NaN Jacobian entries
    (miss pixels) and NaN cotangents count as zero in the contraction:
    pair with NaN-aware losses."""

    def g(params, *args):
        leaves, spec = pytree.tree_flatten(params)
        box = _Box()
        flat = _FwdAdjoint.apply(f, spec, len(leaves), len(args), box, *leaves, *args)
        return pytree.tree_unflatten(list(flat), box.out_spec)

    return g


class _Box:
    """What `_FwdAdjoint`'s forward leaves for its caller and its backward:
    the output's tree structure and the Jacobian. (Not a dict: a transform
    would rebuild a dict argument, as it flattens its arguments.)"""

    out_spec = jac = None


class _FwdAdjoint(torch.autograd.Function):
    """Inputs: ``f``, the params' tree structure, the counts of param leaves
    and of ``args``, a `_Box`, the param leaves, the ``args``. Outputs: the
    leaves of ``f``'s output."""

    @staticmethod
    def forward(f, spec, n_params, n_args, box, *tensors):
        leaves, args = tensors[:n_params], tensors[n_params:]

        def fun(*p):
            y, box.out_spec = pytree.tree_flatten(f(pytree.tree_unflatten(list(p), spec), *args))
            return tuple(y), tuple(y)

        jac, out = _jacfwd(fun, leaves, has_aux=True)
        box.jac = jac
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        _f, _spec, n_params, n_args, box = inputs[:5]
        ctx.n_params, ctx.box = n_params, box
        ctx.save_for_backward(*inputs[5 : 5 + n_params])
        ctx.args = inputs[5 + n_params :]

    @staticmethod
    def backward(ctx, *ybars):
        params = ctx.saved_tensors
        jac = ctx.box.jac  # jac[i][j]: output leaf i by param leaf j
        grads = []
        for j, p in enumerate(params):
            total = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
            for i, yb in enumerate(ybars):
                if yb is None:
                    continue
                jl = torch.nan_to_num(jac[i][j])
                total = total + torch.tensordot(torch.nan_to_num(yb), jl, dims=yb.dim()).reshape(p.shape).to(p.dtype)
            grads.append(total)
        arg_grads = [torch.zeros_like(a) if isinstance(a, torch.Tensor) else None for a in ctx.args]
        return (None, None, None, None, None, *grads, *arg_grads)


def value_and_grad_fwd(f):
    """The value and gradient of a scalar ``f(params, *args)`` from one
    forward Jacobian, without the autograd machinery of `fwd_adjoint`."""

    def vg(params, *args):
        leaves, spec = pytree.tree_flatten(params)

        def fun(*p):
            y = f(pytree.tree_unflatten(list(p), spec), *args)
            return y, y

        jac, val = _jacfwd(fun, leaves, has_aux=True)
        return val, pytree.tree_unflatten(list(jac), spec)

    return vg


def grad_fwd(f):
    """The gradient of a scalar ``f(params, *args)`` (`value_and_grad_fwd`
    without the value)."""
    vg = value_and_grad_fwd(f)

    def g(params, *args):
        return vg(params, *args)[1]

    return g
