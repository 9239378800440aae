"""The cross-section of a `WarpedThinDisc` or a `ThickDisc`, a torch
callable ``f(ρ)``, as a C++ device function for the integrator kernel
(counterpart of the TPU kernel's trace, into which JAX inlines the
callable: `gradus_tpu/integrate/pallas_solver.py:178-179`,
`gradus_tpu/geometry/discs.py:73-77`).

`cross_section_source` traces ``f`` with `torch.fx.symbolic_trace` and
emits ``template <typename T, class S> S name(S rho)``, templated over the
scalar: ``S`` is ``T`` for a value, ``Dual1<T>`` (csrc/dual.cuh) for the
value and its tangent, which the kernel's events and polish read with
jax.jvp's rules at the kinks. The ops it takes (`WHITELIST`):

- arithmetic: ``+ - * /``, negation, ``pow`` with a number or a
  ρ-expression as exponent (a Python int exponent as `lax.integer_pow`
  does, by products), ``reciprocal``, ``square``;
- functions: ``abs``, ``sqrt``, ``rsqrt``, ``exp``, ``log``, ``sin``,
  ``cos``, ``tan``, ``tanh``, ``atan``, ``atan2``, ``sinh``, ``cosh``,
  ``asin``, ``acos``, ``floor``, ``sign``;
- choices: ``minimum``, ``maximum``, ``clamp``/``clip`` with number bounds,
  ``where`` on a comparison of ρ-expressions;
- constants: ``zeros_like``, ``ones_like``, ``full_like`` of a number.

Python and numpy numbers are literals, ``T(...)`` with 17 digits, so an f32
kernel computes in f32. Any other op, a Python branch on ρ or ``math.*`` of
ρ raises `NotImplementedError`; a captured tensor, of any shape, raises
`ValueError` (the reference's refusal of captured constants). Both happen
on the host, before any build or launch.

`Emitter` writes the statements; `metrics/codegen.py` emits a metric's
``components5`` with it.

`kernel_unit` writes the CUDA unit of a launch: the cross-sections of the
geometry's parts, the metric class of each PolishDoughnut part whose
isobars read another class than the rays' metric, the Policy holding them
(csrc/geometry.cuh), a traced metric's class (`metrics.codegen`), and the
C entry point for the metric and the launch's dtype (csrc/callable.cuh);
`_build.load_callable_library` builds it.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
import operator
import weakref
from dataclasses import dataclass

import torch
import torch.fx

__all__ = ["WHITELIST", "cross_section_source", "callable_parts", "doughnut_parts", "kernel_unit", "KernelUnit"]

# The C++ class of each kernel metric kind (csrc/tsit5.cuh, kMetric*)
METRIC_CLASSES = (
    "Kerr",
    "DualRhs<Johannsen>",
    "DualRhs<JohannsenPsaltis>",
    "DualRhs<NoZ>",
    "DualRhs<Bumblebee>",
    "DualRhs<DilatonAxion>",
    "DualRhs<KerrNewman>",
    "DualRhs<MorrisThorne>",
    "DualRhs<KerrRefractive>",
    "DualRhs<KerrDarkMatter>",
    "DualRhs<Spherical>",
    "DualRhs<Cartesian>",
)
# the kind of a metric traced into a generated unit (csrc/tsit5.cuh, kMetricTraced)
TRACED_METRIC = len(METRIC_CLASSES)


def _targets(name, *functions):
    """The fx targets of an op: its torch functions and its method name."""
    return [(f, name) for f in functions] + [(name, name)]


# fx target (a function, or a method's name) -> the op's name
_OPS = dict(
    [
        (operator.add, "add"),
        (operator.sub, "sub"),
        (operator.mul, "mul"),
        (operator.truediv, "div"),
        (operator.neg, "neg"),
        (operator.pow, "pow"),
        (operator.abs, "abs"),
        (operator.gt, "gt"),
        (operator.lt, "lt"),
        (operator.ge, "ge"),
        (operator.le, "le"),
        (operator.eq, "eq"),
        (operator.ne, "ne"),
        ("true_divide", "div"),
        ("negative", "neg"),
        ("absolute", "abs"),
        ("arctan", "atan"),
        ("arctan2", "atan2"),
        ("arcsin", "asin"),
        ("arccos", "acos"),
        ("clip", "clamp"),
        ("greater", "gt"),
        ("less", "lt"),
        ("greater_equal", "ge"),
        ("less_equal", "le"),
        ("not_equal", "ne"),
    ]
    + _targets("add", torch.add)
    + _targets("sub", torch.sub, torch.subtract)
    + _targets("mul", torch.mul, torch.multiply)
    + _targets("div", torch.div, torch.true_divide, torch.divide)
    + _targets("neg", torch.neg, torch.negative)
    + _targets("pow", torch.pow)
    + _targets("reciprocal", torch.reciprocal)
    + _targets("square", torch.square)
    + _targets("abs", torch.abs, torch.absolute)
    + _targets("sqrt", torch.sqrt)
    + _targets("rsqrt", torch.rsqrt)
    + _targets("exp", torch.exp)
    + _targets("log", torch.log)
    + _targets("sin", torch.sin)
    + _targets("cos", torch.cos)
    + _targets("tan", torch.tan)
    + _targets("tanh", torch.tanh)
    + _targets("atan", torch.atan, torch.arctan)
    + _targets("atan2", torch.atan2, torch.arctan2)
    + _targets("sinh", torch.sinh)
    + _targets("cosh", torch.cosh)
    + _targets("asin", torch.asin, torch.arcsin)
    + _targets("acos", torch.acos, torch.arccos)
    + _targets("floor", torch.floor)
    + _targets("sign", torch.sign)
    + _targets("minimum", torch.minimum)
    + _targets("maximum", torch.maximum)
    + _targets("clamp", torch.clamp, torch.clip)
    + _targets("clamp_min", torch.clamp_min)
    + _targets("clamp_max", torch.clamp_max)
    + _targets("where", torch.where)
    + _targets("gt", torch.gt, torch.greater)
    + _targets("lt", torch.lt, torch.less)
    + _targets("ge", torch.ge, torch.greater_equal)
    + _targets("le", torch.le, torch.less_equal)
    + _targets("eq", torch.eq)
    + _targets("ne", torch.ne, torch.not_equal)
    + [(torch.zeros_like, "zeros_like"), (torch.ones_like, "ones_like"), (torch.full_like, "full_like")]
)
WHITELIST = tuple(sorted(set(_OPS.values())))

# the device function of each op on one argument (dual.cuh, or the scalar's)
_UNARY = dict(
    abs="fabs",
    sqrt="sqrt",
    rsqrt="jrsqrt",
    exp="exp",
    log="log",
    sin="sin",
    cos="cos",
    tan="tan",
    tanh="tanh",
    atan="atan",
    sinh="sinh",
    cosh="cosh",
    asin="asin",
    acos="acos",
    floor="floor",
    sign="jsign",
    square="jsquare",
)
_FILLS = dict(zeros_like=0.0, ones_like=1.0, full_like=None)
_COMPARISONS = dict(gt=">", lt="<", ge=">=", le="<=", eq="==", ne="!=")
_ARITY = dict(
    add=2, sub=2, mul=2, div=2, pow=2, atan2=2, minimum=2, maximum=2, neg=1, reciprocal=1,
    **{k: 1 for k in _UNARY}, **{k: 2 for k in _COMPARISONS},
)  # fmt: skip


def _literal(x):
    """A Python or numpy number as the launch's scalar, 17 digits (a double
    literal: -0.0 keeps its sign)."""
    x = float(x)
    if math.isnan(x):
        return "T(NAN)"
    if math.isinf(x):
        return "T(INFINITY)" if x > 0 else "T(-INFINITY)"
    text = f"{x:.17g}"
    if text.lstrip("-").isdigit():
        text += ".0"
    return f"T({text})"


def _is_number(x):
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def _dtype_name(t):
    """torch.float64 as f64, torch.int32 as i32."""
    return str(t.dtype).replace("torch.float", "f").replace("torch.int", "i")


def _refuse(what):
    raise NotImplementedError(
        f"the CUDA integrator does not take {what} in a cross-section: it compiles the ops "
        f"{', '.join(WHITELIST)} of ρ and numbers (trace_geodesics takes any torch callable)"
    )


def _trace(f):
    try:
        return torch.fx.symbolic_trace(f)
    except torch.fx.proxy.TraceError as e:
        _refuse(f"a Python branch on ρ ({e})")
    except NotImplementedError:
        raise
    except Exception as e:  # noqa: BLE001 - any failure to trace is a refusal
        _refuse(f"a callable that torch.fx cannot trace ({type(e).__name__}: {e})")


def _captured(gm, graph):
    """The captured tensors, as the reference names them (f64[11])."""
    shapes = []
    for node in graph.nodes:
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            dims = ",".join(str(d) for d in getattr(t, "shape", ()))
            shapes.append(f"{_dtype_name(t)}[{dims}]" if isinstance(t, torch.Tensor) else repr(t))
    return shapes


def _op_name(node):
    """The op's name, or None where it is not on the whitelist (a method is
    looked up by its name, a function by itself: never by its name, so
    math.sin is not torch.sin)."""
    target = node.target
    if (node.op == "call_method") != isinstance(target, str):
        return None
    try:
        return _OPS.get(target)
    except TypeError:
        return None


def _describe(node):
    t = node.target
    if node.op == "call_method":
        return f"the method .{t}()"
    module = getattr(t, "__module__", None) or ""
    name = getattr(t, "__name__", repr(t))
    if module == "math":
        return f"math.{name} of ρ (write torch.{name})"
    return f"{module + '.' if module else ''}{name}"


class Emitter:
    """The C++ statements of a traced graph's nodes, one ``const`` a node,
    shared by the cross-sections and `metrics.codegen`. Each value has a
    kind: 'S' (the scalar ``S``: it depends on the inputs, so it carries
    their tangents), 'P' (a ``T`` that depends on runtime parameters only,
    `metrics.codegen`'s slots), 'N' (a literal) or 'B' (a comparison).
    ``refuse(what)`` raises for what the generator does not take;
    ``attr(node)`` gives the (expression, kind) of a ``get_attr`` node."""

    def __init__(self, refuse, attr=None):
        self.refuse, self.attr = refuse, attr
        self.names, self.kinds, self.lines = {}, {}, []

    def arg(self, a):
        """(C++ expression, kind) of a node or a number."""
        if isinstance(a, torch.fx.Node):
            return self.names[a], self.kinds[a]
        if _is_number(a):
            return _literal(a), "N"
        self.refuse(f"an argument {a!r}")

    def value_of(self, a):
        expr, kind = self.arg(a)
        if kind == "B":
            self.refuse("a comparison used as a number")
        return expr, kind

    def as_s(self, a):
        expr, kind = self.value_of(a)
        return expr if kind == "S" else f"S{{{expr}}}"

    def _constant(self, a):
        """A bound of clamp: a number or a parameter expression."""
        if a is None:
            return None
        if not _is_number(a) and not (isinstance(a, torch.fx.Node) and self.kinds.get(a) in ("N", "P")):
            self.refuse("clamp with bounds other than numbers")
        return self.value_of(a)[0]

    def emit(self, graph, inputs):
        """The statements of every node of ``graph`` but its placeholders
        (their C++ names ``inputs``, each of kind 'S') and its output;
        returns the output's arguments."""
        placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(inputs):
            self.refuse(f"a callable of {len(placeholders)} arguments, not {len(inputs)}")
        for node, name in zip(placeholders, inputs):
            self.names[node], self.kinds[node] = name, "S"
        for i, node in enumerate(graph.nodes):
            if node.op in ("placeholder", "output"):
                continue
            if node.op == "get_attr" and self.attr is not None:
                expr, kind = self.attr(node)
            else:
                expr, kind = self._expression(node)
            name = f"v{i}"
            self.names[node], self.kinds[node] = name, kind
            ctype = {"B": "bool", "S": "S"}.get(kind, "T")
            self.lines.append(f"  const {ctype} {name} = {expr};")
        (out,) = (n for n in graph.nodes if n.op == "output")
        return out.args[0]

    def _expression(self, node):
        if node.op not in ("call_function", "call_method"):
            self.refuse(f"a {node.op} node ({node.target})")
        op = _op_name(node)
        if op is None:
            self.refuse(_describe(node))
        args, kw = list(node.args), dict(node.kwargs)
        value_of, arg = self.value_of, self.arg
        if op in _FILLS:  # zeros_like(x), ones_like(x), full_like(x, c): a literal
            fill = args[1:] if op == "full_like" else [_FILLS[op]]
            if kw or len(args) != 1 + (op == "full_like") or not _is_number(fill[0]):
                self.refuse(f"{op} other than of a number")
            value_of(args[0])
            return _literal(fill[0]), "N"
        if op in ("clamp", "clamp_min", "clamp_max"):
            if op == "clamp_max":
                lo, hi = None, args[1] if len(args) > 1 else kw.pop("max", None)
            else:
                lo = args[1] if len(args) > 1 else kw.pop("min", None)
                hi = args[2] if len(args) > 2 else kw.pop("max", None)
            if kw:
                self.refuse(f"{op} with bounds other than numbers")
            lo, hi = self._constant(lo), self._constant(hi)
            expr, kind = value_of(args[0])
            if lo is not None:
                expr = f"jmax({expr}, {lo})"
            if hi is not None:
                expr = f"jmin({expr}, {hi})"
            return expr, "S" if kind == "S" else "P"
        if op == "where":
            if node.op == "call_method":  # x.where(cond, other)
                args = [args[1], args[0], args[2]] if len(args) == 3 else args
            if kw or len(args) != 3 or arg(args[0])[1] != "B":
                self.refuse("where other than on a comparison, with both branches")
            return f"select({arg(args[0])[0]}, {self.as_s(args[1])}, {self.as_s(args[2])})", "S"
        if kw or len(args) != _ARITY[op]:
            self.refuse(f"{op} with arguments {node.args} {node.kwargs}")
        values = [value_of(a) for a in args]
        kind = "S" if any(k == "S" for _, k in values) else "P"
        if op in _COMPARISONS:
            a, b = (e if k != "S" else f"value({e})" for e, k in values)
            return f"{a} {_COMPARISONS[op]} {b}", "B"
        (a, ka) = values[0]
        if op == "neg":
            return f"-{a}", kind
        if op == "reciprocal":
            return f"ipow({a}, -1)", kind
        if op in _UNARY:
            return f"{_UNARY[op]}({a})", kind
        if op == "pow":
            y = args[1]
            if isinstance(y, numbers.Integral) and not isinstance(y, bool):
                return f"ipow({a}, {int(y)})", kind
            return f"jpow({a}, {values[1][0]})", kind
        b = values[1][0]
        return {
            "add": f"{a} + {b}",
            "sub": f"{a} - {b}",
            "mul": f"{a} * {b}",
            "div": f"jdiv({a}, {b})",
            "atan2": f"jatan2({a}, {b})",
            "minimum": f"jmin({a}, {b})",
            "maximum": f"jmax({a}, {b})",
        }[op], kind


_SOURCES = weakref.WeakKeyDictionary()


def _body(f):
    """The statements of ``f``'s device function (a list of lines), cached
    by the callable, as the reference's trace is."""
    try:
        cached = _SOURCES.get(f)
    except TypeError:
        cached = None
    if cached is not None:
        return cached
    gm = _trace(f)
    graph = gm.graph
    captured = _captured(gm, graph)
    if captured:
        raise ValueError(
            f"the cross-section {f!r} captures constants {captured}: the integrator kernel takes "
            "numbers only, as the reference's kernel does (pallas_solver.py:181); write them as "
            "Python numbers, or trace it with trace_geodesics"
        )
    emitter = Emitter(_refuse)
    result = emitter.emit(graph, ["rho"])
    if isinstance(result, (tuple, list)):
        _refuse("a callable of several outputs")
    lines = emitter.lines + [f"  return {emitter.as_s(result)};"]
    try:
        _SOURCES[f] = lines
    except TypeError:
        pass
    return lines


def cross_section_source(f, name="h_0"):
    """The device function ``name`` that computes ``f(ρ)``: its text."""
    body = _body(f)
    return (
        f"// {getattr(f, '__qualname__', type(f).__name__)}\n"
        "template <typename T, class S>\n"
        f"__device__ __forceinline__ S {name}(S rho) {{\n" + "\n".join(body) + "\n}\n"
    )


def _parts(geometry):
    """[(part index, part)] of a geometry in the part order of the kernel's
    block, a `PrecessingDisc` part as its disc."""
    from gradus_tpu_torch.geometry.discs import CompositeGeometry, PrecessingDisc

    if geometry is None:
        return []
    parts = list(geometry.geometries) if isinstance(geometry, CompositeGeometry) else [geometry]
    return [(k, g.disc if type(g) is PrecessingDisc else g) for k, g in enumerate(parts)]


def callable_parts(geometry):
    """[(part index, cross-section)] of a geometry's parts of kinds 8-9 (a
    `WarpedThinDisc` or `ThickDisc`, alone, precessed or in a
    `CompositeGeometry`), in the part order of the kernel's block."""
    from gradus_tpu_torch.geometry.discs import ThickDisc, WarpedThinDisc

    return [(k, g.f) for k, g in _parts(geometry) if type(g) in (WarpedThinDisc, ThickDisc)]


def doughnut_parts(geometry):
    """[(part index, metric)] of a geometry's `PolishDoughnut` parts whose
    isobars read a metric's components, alone, precessed or in a
    `CompositeGeometry`."""
    from gradus_tpu_torch.geometry.discs import PolishDoughnut

    return [(k, g.metric) for k, g in _parts(geometry) if type(g) is PolishDoughnut and g.metric is not None]


@dataclass(frozen=True)
class KernelUnit:
    """The generated CUDA unit of a launch: ``body`` (the traced metric's
    class, the cross-sections and their Policy), and ``source``, the body
    and the C entry point ``entry`` for the launch's scalar, which runs
    ``launcher`` (csrc/callable.cuh) with the metric class ``metric`` of
    kind ``metric_kind`` and the Policy ``policy``."""

    body: str
    source: str
    entry: str
    metric: str
    metric_kind: int
    policy: str = "generated::CrossSections"
    launcher: str = "launch_callable"

    def launch(self, scalar):
        """The unit's launch function for the scalar type ``scalar``."""
        return _launch(scalar, self)


def _launch(scalar, u):
    return f"(gradus::{u.launcher}<{scalar}, gradus::{u.metric}, gradus::{u.policy}, {u.metric_kind}>)"


def _policy(parts, doughnuts):
    """The cross-sections of ``parts``, the classes of the traced metrics of
    ``doughnuts`` ((part index, a kernel metric kind or a
    `metrics.codegen.TracedMetric`)), and the Policy that selects them by
    their part index."""
    functions = "".join(cross_section_source(f, f"h_{k}") for k, f in parts)
    cases = "".join(f"      case {k}: return h_{k}<T>(rho);\n" for k, _ in parts)
    classes, doughnut_cases = "", ""
    for k, metric in doughnuts:
        if isinstance(metric, int):
            cls = METRIC_CLASSES[metric]
        else:
            classes += metric.struct(f"Doughnut{k}") + "\n"
            cls = metric.rhs_of(f"Doughnut{k}")
        doughnut_cases += f"      case {k}: return gradus::doughnut_h<{cls}>(v, rho);\n"
    return (
        f"{functions}{classes}\n"
        "struct CrossSections {\n"
        f"  static constexpr bool kCallables = {'true' if parts else 'false'};\n"
        f"  static constexpr bool kDoughnuts = {'true' if doughnuts else 'false'};\n"
        "  template <typename T, class S>\n"
        "  static __device__ __forceinline__ S cross_section(int k, S rho) {\n"
        "    switch (k) {\n"
        f"{cases}"
        "      default: return S{T(NAN)};\n"
        "    }\n  }\n"
        + (
            ""
            if not doughnuts
            else "  template <class Metric, typename T>\n"
            "  static __device__ __forceinline__ T doughnut_h(int k, const T* v, T rho) {\n"
            "    switch (k) {\n"
            f"{doughnut_cases}"
            "      default: return gradus::doughnut_h<Metric>(v, rho);\n"
            "    }\n  }\n"
        )
        + "};\n\n"
    )


def kernel_unit(metric_kind, geometry, dtype, traced=None, doughnuts=()):
    """The unit for a launch of the kernel against ``geometry`` in
    ``dtype``: with ``traced`` (a `metrics.codegen.TracedMetric`), for
    that metric and every geometry; else for the metric kind
    ``metric_kind``, or None when the geometry has no cross-section
    callable and ``doughnuts`` is empty. ``doughnuts`` names the class of
    each PolishDoughnut part whose isobars read another class than the
    rays' metric: (part index, its metric's kind, or its `TracedMetric`).
    Raises as `cross_section_source` does."""
    parts = callable_parts(geometry)
    doughnuts = list(doughnuts)
    if not parts and not doughnuts and traced is None:
        return None
    what = []
    if traced is not None:
        what.append(f"the {traced.name} metric's {traced.method}")
    if parts:
        what.append(f"the cross-sections of a {type(geometry).__name__}'s parts {[k for k, _ in parts]}")
    if doughnuts:
        what.append(f"the isobars of the PolishDoughnut parts {[k for k, _ in doughnuts]} in their metrics' classes")
    body = (
        "// Generated by gradus_tpu_torch/geometry/codegen.py: "
        + " and ".join(what)
        + ",\n// compiled into the integrator kernel (csrc/callable.cuh).\n"
        '#include "callable.cuh"\n\n'
        "namespace gradus {\nnamespace generated {\n\n"
        + ("" if traced is None else traced.source + "\n")
        + (_policy(parts, doughnuts) if parts or doughnuts else "")
        + "}  // namespace generated\n}  // namespace gradus\n"
    )
    f64 = dtype == torch.float64
    entry, scalar = ("geodesic_tsit5_f64", "double") if f64 else ("geodesic_tsit5_f32", "float")
    if traced is None:
        unit = KernelUnit(body, "", entry, METRIC_CLASSES[metric_kind], metric_kind)
    else:
        policy = "generated::CrossSections" if parts or doughnuts else "NoCallables"
        unit = KernelUnit(body, "", entry, traced.rhs, TRACED_METRIC, policy, "launch_traced")
    source = body + f"\nGEODESIC_TSIT5_ENTRY({entry}, {scalar}, {unit.launch(scalar)})\n"
    return dataclasses.replace(unit, source=source)
