"""A user's metric as a C++ class for the integrator kernel (counterpart of
the TPU kernel's trace, into which JAX inlines the metric's
``components5_jac``: `gradus_tpu/integrate/pallas_solver.py:760-763`,
`gradus_tpu/geodesics/equation.py:57-65`).

`traced_metric` traces the metric's ``components5(r, θ)`` with `torch.fx`
into ``template <typename T, class S> static void components5(const
DeformedParams<T>& p, S r, S th, S* g)``, which the kernel evaluates on
``Dual2<T>`` (csrc/dual.cuh) through ``DualRhs`` for the value and its
(∂_r, ∂_θ) Jacobian, as the reference's ``_ad_components5_jac`` does with
two jax.jvp passes. Where the metric's class, or a base class, overrides
``AbstractMetric.components5_jac``, it traces that instead, into
``components5_jac(p, r, th, g, dr, dth)``, whose values and derivatives the
kernel reads directly (``JacRhs``, csrc/callable.cuh): a subclass of
`KerrMetric` keeps Kerr's hand-derived Jacobian. The ops are those of the
cross-sections (`geometry.codegen.WHITELIST`), emitted by the same
`geometry.codegen.Emitter`, with jax.jvp's rules at the kinks.

The metric's 0-d floating parameters (buffers or `nn.Parameter`s) are
runtime slots of the kernel, read at every launch: ``M`` and ``a`` by
those names (``p.M``, ``p.a``), the others in ``p.q`` in their
registration order, at most ``Q_SLOTS`` of them. So a new M or a never
rebuilds the unit. A parameter that the trace's Python code needs as a
number (a branch, ``if self.s == 0:``, or ``float()`` or ``math.*`` of
it), and the parameters past the first ``Q_SLOTS``, are literals of the
unit instead: the metric is traced again with them read as Python floats
of their values, as the reference bakes every parameter into its trace
(`PallasTracer._concretize`, one compile per configuration), so another
value of such a parameter is another unit. Python numbers are literals
of the launch's dtype.

Refused on the host, before any build or launch: an op off the whitelist,
and a Python branch on r or θ, or ``float()`` or ``math.*`` of them (named
in the error), raise `NotImplementedError`; a tensor that is not 0-d, and
a tensor the metric does not hold as a parameter (an anonymous constant),
raise `ValueError` (the reference's refusal of captured arrays).
"""

from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass

import torch
import torch.fx
from torch import nn

from gradus_tpu_torch.geometry.codegen import WHITELIST, Emitter, _dtype_name, _literal
from gradus_tpu_torch.metrics.base import AbstractMetric

__all__ = ["TracedMetric", "traced_metric", "metric_slots", "Q_SLOTS"]

# the slots of p.q (csrc/tsit5.cuh, kMetricParams)
Q_SLOTS = 5


def _refuse(what):
    raise NotImplementedError(
        f"the CUDA integrator does not take {what} in a metric's components5: it compiles the ops "
        f"{', '.join(WHITELIST)} of r, θ, the metric's 0-d parameters and numbers "
        "(trace_geodesics and cuda_integrate_rays on CPU tensors take any metric)"
    )


@dataclass(frozen=True)
class TracedMetric:
    """A metric's generated class: its text (``text``, the class named
    ``TracedMetric``), the kernel's right-hand side template over it
    (``DualRhs`` for a traced ``components5``, ``JacRhs`` for a traced
    ``components5_jac``), the traced method, the metric class's name, and
    the parameters it reads with their slots, ``((name, "p.M"), ...)``,
    those of ``p.q`` in order, then the literals with their text,
    ``((name, "T(0.0)"), ...)``. ``source`` and ``rhs`` name the class
    ``TracedMetric``; `struct` and `rhs_of` give it another name (a
    PolishDoughnut's metric beside the rays' in one unit)."""

    text: str
    template: str
    method: str
    name: str
    slots: tuple

    def struct(self, cls):
        """The class's text under the name ``cls``."""
        return self.text.replace("struct TracedMetric {", f"struct {cls} {{", 1)

    def rhs_of(self, cls):
        """The kernel's Metric over the class named ``cls``."""
        return f"{self.template}<gradus::generated::{cls}>"

    @property
    def source(self):
        return self.struct("TracedMetric")

    @property
    def rhs(self):
        return self.rhs_of("TracedMetric")

    @property
    def literals(self):
        """((name, its literal's text), ...): the parameters baked into the text."""
        return tuple((k, v) for k, v in self.slots if not v.startswith("p."))


class _Components(nn.Module):
    """The metric's traced method as a module holding the metric, so that
    its parameters reach the graph by their names."""

    def __init__(self, metric, method):
        super().__init__()
        self.metric = metric
        self.method = method

    def forward(self, r, th):
        return getattr(self.metric, self.method)(r, th)


def _sources(node):
    """The inputs and parameters a node depends on, by name."""
    seen, todo, out = set(), [node], set()
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.add(n)
        if n.op == "placeholder":
            out.add(n.target)
        elif n.op == "get_attr":
            out.add(n.target.removeprefix("metric."))
        todo.extend(n.all_input_nodes)
    return sorted(out)


class _NeedsNumbers(Exception):
    """The trace's Python code needs the values of the parameters ``names``."""

    def __init__(self, names):
        super().__init__(names)
        self.names = names


class _Proxy(torch.fx.Proxy):
    """A traced value that names what ``float()`` or ``math.*`` of it reads."""

    def __float__(self):
        self.tracer.needs(self.node, "float() or math.* of")


class _Tracer(torch.fx.Tracer):
    """Proxies the metric's parameters but those of ``literals`` (name:
    value), which it reads as Python floats of their values, and names
    what a Python branch depends on."""

    def __init__(self, literals):
        super().__init__(autowrap_modules=())  # math.* of a value reads it as a number (__float__)
        self.proxy_buffer_attributes = True
        self.literals = literals

    def proxy(self, node):
        return _Proxy(node, self)

    def getattr(self, attr, attr_val, parameter_proxy_cache):
        if isinstance(attr_val, torch.Tensor):
            for name, t in _parameters(self.root.metric).items():
                if t is attr_val and name in self.literals:
                    return self.literals[name]
        return super().getattr(attr, attr_val, parameter_proxy_cache)

    def to_bool(self, obj):
        self.needs(obj.node, "a Python branch on")

    def needs(self, node, what):
        """Raises `_NeedsNumbers` where the value ``node`` depends on the
        metric's parameters only; refuses, naming them, what depends on r,
        θ or a tensor the metric does not hold."""
        names = _sources(node)
        if not names or not set(names) <= set(_parameters(self.root.metric)):
            _refuse(f"{what} {', '.join(names)}")
        raise _NeedsNumbers(names)


def _parameters(m):
    """The metric's parameters and buffers by name, in registration order."""
    return dict(itertools.chain(m.named_parameters(), m.named_buffers()))


def _trace(m, method, literals):
    wrapper = _Components(m, method)
    try:
        return _Tracer(literals).trace(wrapper)
    except (NotImplementedError, ValueError, _NeedsNumbers):
        raise
    except Exception as e:  # noqa: BLE001 - any failure to trace is a refusal
        _refuse(f"a metric that torch.fx cannot trace ({type(e).__name__}: {e})")


def _not_0d(name, t):
    return ValueError(
        f"the metric's parameter {name} is {_dtype_name(t)}{list(t.shape)}: the integrator kernel takes "
        "0-d parameters, as the reference's kernel takes numbers (pallas_solver.py:725-740); "
        "trace_geodesics takes it"
    )


def _number(m, name):
    """The parameter ``name``'s value as a Python float (the reference's
    `_concretize`)."""
    t = _parameters(m)[name]
    if t.dim() != 0:
        raise _not_0d(name, t)
    return float(t)


def _slots(m, graph):
    """({parameter name: its C++ slot} of the parameters the graph reads:
    p.M, p.a, and p.q[k] for the first `Q_SLOTS` others in registration
    order; the others it reads, past those slots)."""
    params = _parameters(m)
    used, anonymous = [], []
    for node in graph.nodes:
        if node.op != "get_attr":
            continue
        name = node.target.removeprefix("metric.")
        if not node.target.startswith("metric.") or name not in params:
            anonymous.append(node.target)
            continue
        t = params[name]
        if t.dim() != 0:
            raise _not_0d(name, t)
        used.append(name)
    if anonymous:
        raise ValueError(
            f"the metric's {type(m).__name__}.components5 captures tensors that are not its parameters "
            f"({anonymous}): the integrator kernel takes numbers and 0-d parameters only, as the "
            "reference's kernel does; register them as 0-d buffers, or write them as Python numbers"
        )
    slots = {k: f"p.{k}" for k in ("M", "a") if k in used}
    extra = [k for k in params if k in used and k not in slots]
    slots.update({k: f"p.q[{i}]" for i, k in enumerate(extra[:Q_SLOTS])})
    return slots, extra[Q_SLOTS:]


_CACHE = weakref.WeakKeyDictionary()


def _traced_graph(m, method):
    """(the traced graph, its runtime slots, its literals {name: value}):
    traced again with a parameter read as a number wherever the Python
    code needs its value, and with the parameters past the slots."""
    literals = {}
    while True:
        try:
            graph = _trace(m, method, literals)
        except _NeedsNumbers as e:
            if set(e.names) <= set(literals):  # pragma: no cover - a literal is a float
                _refuse(f"a Python use of {', '.join(e.names)} as a number")
            literals.update({k: _number(m, k) for k in e.names})
            continue
        slots, past = _slots(m, graph)
        if not past:
            return graph, slots, literals
        literals.update({k: _number(m, k) for k in past})


def _current(m, traced):
    """Whether the literals baked into ``traced`` are ``m``'s values now."""
    params = _parameters(m)
    return all(_literal(float(params[k])) == text for k, text in traced.literals)


def traced_metric(m):
    """The `TracedMetric` of ``m`` (cached by the metric while its literal
    parameters keep their values). Raises as the module says."""
    cached = _CACHE.get(m)
    if cached is not None and _current(m, cached):
        return cached
    jac = type(m).components5_jac is not AbstractMetric.components5_jac
    if not jac and type(m).components5 is AbstractMetric.components5:
        raise NotImplementedError(
            f"{type(m).__name__} defines no components5: the CUDA integrator compiles a metric's components5"
        )
    method = "components5_jac" if jac else "components5"
    graph, slots, literals = _traced_graph(m, method)
    emitter = Emitter(_refuse, attr=lambda node: (slots[node.target.removeprefix("metric.")], "P"))
    result = emitter.emit(graph, ["r", "th"])
    names = ("g", "dr", "dth") if jac else ("g",)
    groups = list(result) if jac and isinstance(result, (tuple, list)) else [result]
    if len(groups) != len(names) or not all(isinstance(o, (tuple, list)) and len(o) == 5 for o in groups):
        _refuse(f"a {method} that returns other than {'three 5-tuples' if jac else 'a 5-tuple'}")
    lines = list(emitter.lines)
    for name, group in zip(names, groups):
        lines += [f"  {name}[{k}] = {emitter.as_s(o)};" for k, o in enumerate(group)]
    slots = tuple(slots.items()) + tuple((k, _literal(v)) for k, v in literals.items())
    slot_note = ", ".join(f"{k} -> {v}" for k, v in slots) or "none"
    text = (
        f"// {type(m).__qualname__}.{method}; parameters: {slot_note}\n"
        "struct TracedMetric {\n"
        "  template <typename T, class S>\n"
        f"  static __device__ __forceinline__ void {method}(const DeformedParams<T>& p, S r, S th, "
        + ", ".join(f"S* {name}" for name in names)
        + ") {\n"
        + "\n".join("  " + line for line in lines)
        + "\n  }\n};\n"
    )
    traced = TracedMetric(text, "JacRhs" if jac else "DualRhs", method, type(m).__name__, slots)
    _CACHE[m] = traced
    return traced


def metric_slots(m, traced):
    """(M, a, the p.q values) of ``m`` for its `TracedMetric`: 0 for a slot
    the trace does not read, or a parameter baked in as a literal."""
    params, slots = _parameters(m), dict(traced.slots)
    M, a = (float(params[k]) if slots.get(k) == f"p.{k}" else 0.0 for k in ("M", "a"))
    return M, a, [float(params[k]) for k, slot in traced.slots if slot.startswith("p.q")]
