"""Lowerings of the integrand IR (``tracing.Node``).

The JAX package needs none: Mosaic and XLA compile the traced jax
functions.  The port lowers each traced integrand two ways from the one
IR, so the plain version and the kernel evaluate the same operations in
the same order:

* :func:`to_torch` — a torch callable on float32 tensors (the plain
  version, and the CPU path);
* :func:`cuda_source` — CUDA C ``__device__ float f_j(float x)``
  functions plus the per-point entries ``tmc_accumulate``,
  ``tmc_accumulate_sq``, ``tmc_accumulate_pair_sq`` and ``tmc_values``,
  which the kernels in ``csrc/`` include; for d-ary
  integrands (d >= 2), ``f_j(const float* x)`` plus ``TMC_D`` and the
  nd entries ``tmc_accumulate_nd``, ``tmc_accumulate_nd_sq`` and
  ``tmc_values_nd``, which the nd MCMC kernel also takes for d = 1
  (``pointer=True``); and :func:`cuda_target_source`, a joint
  log-density as ``tmc_target_logpdf(const float* x)``.
  The source also compiles as host C++ with ``-D__device__=`` (the tests
  do that with g++), since it only uses C math names and the helpers of
  ``csrc/integrand_math.cuh``.

Each IR operation is one float32 operation in both; constants are rounded
to float32 once, here, for both.

An importance-sampling set (``weight=(p, q)``, or for d-ary integrands
one such pair per dimension) is weighted as the JAX
kernel's ``is_weight`` weighs it (``integrate_pallas.py:1009-1029``): the
kernel computes ``w = where(q > 0, p / safe_q, 0)`` once per sample, p
and q each a traced density, a pdf table or (q only) the CUSTOM
sampler's own density, and the CUDA source takes it in the ``_w``
entries, ``f(x) * w`` (:func:`cuda_source`); a d-ary set takes the
product of the dimensions' weights in dimension order, the JAX nd
kernel's ``weight`` (``integrate_nd_pallas.py:498-520``).  The JAX package's traced
route folds the weight into each integrand instead
(``_weighted_fns``, ``(f(x) * p(x)) / safe_q``); the two agree to a few
ulp per value.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..tracing import (
    BINARY_OPS,
    COMPARE_OPS,
    LOGIC_OPS,
    UNARY_OPS,
    Node,
    TracedFunction,
)

__all__ = [
    "cuda_source",
    "cuda_target_grad_source",
    "cuda_target_source",
    "to_torch",
    "to_torch_grad",
    "to_torch_set",
    "topo_order",
]


def topo_order(roots: Sequence[Node]) -> List[Node]:
    """Every node reachable from ``roots``, each once, arguments first."""
    order: List[Node] = []
    seen = set()
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            order.append(node)
            continue
        stack.append((node, True))
        for a in reversed(node.args):
            if id(a) not in seen:
                stack.append((a, False))
    return order


def _torch_cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_TORCH_UNARY: Dict[str, Callable] = {
    "neg": torch.neg,
    "abs": torch.abs,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "sqrt": torch.sqrt,
    "cbrt": _torch_cbrt,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "rint": torch.round,  # half to even, like jnp.round and rintf
    "trunc": torch.trunc,
}
_TORCH_BINARY: Dict[str, Callable] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "pow": torch.pow,
    "atan2": torch.atan2,
    "hypot": torch.hypot,
    "copysign": torch.copysign,
    "fmod": torch.fmod,
    "minimum": torch.minimum,
    "maximum": torch.maximum,
    "gt": torch.gt,
    "lt": torch.lt,
    "ge": torch.ge,
    "le": torch.le,
    "eq": torch.eq,
    "ne": torch.ne,
    "and": torch.logical_and,
    "or": torch.logical_or,
    "xor": torch.logical_xor,
}


def _torch_program(roots: Sequence[Node]) -> Callable[..., List[torch.Tensor]]:
    """Torch callable of float32 tensors (of one shape) returning the
    float32 values of ``roots``, each node evaluated once."""
    order = topo_order(roots)

    def run(*xs: torch.Tensor) -> List[torch.Tensor]:
        like = xs[0]
        vals: Dict[int, torch.Tensor] = {}
        for node in order:
            op = node.op
            args = [vals[id(a)] for a in node.args]
            if op == "arg":
                out = xs[node.value]
            elif op == "const":
                out = torch.tensor(
                    node.value, dtype=torch.float32, device=like.device
                )
            elif op in _TORCH_UNARY:
                out = _TORCH_UNARY[op](args[0])
            elif op in _TORCH_BINARY:
                out = _TORCH_BINARY[op](args[0], args[1])
            elif op == "not":
                out = torch.logical_not(args[0])
            elif op == "select":
                out = torch.where(args[0], args[1], args[2])
            elif op == "to_f32":
                out = args[0].to(torch.float32)
            else:
                raise ValueError(f"unknown IR operation {op!r}")
            vals[id(node)] = out
        return [torch.broadcast_to(vals[id(r)], like.shape) for r in roots]

    return run


def to_torch(fn: TracedFunction) -> Callable[..., torch.Tensor]:
    """Torch callable of ``fn.n_args`` float32 tensors (of one shape),
    returning float32 values of that shape."""
    run = _torch_program([fn.ir])
    return lambda *xs: run(*xs)[0]


def to_torch_grad(
    fn: TracedFunction,
) -> Callable[..., Tuple[torch.Tensor, List[torch.Tensor]]]:
    """Torch callable of ``fn.n_args`` float32 tensors (of one shape),
    returning ``fn``'s values and its ``fn.n_args`` partial derivatives
    (``ops/grad.py`` ``grad_ir``) from one forward pass."""
    from .grad import grad_ir

    value, grads = grad_ir(fn)
    run = _torch_program([value, *grads])

    def value_grad(*xs):
        out = run(*xs)
        return out[0], out[1:]

    return value_grad


def to_torch_set(
    fns: Sequence[TracedFunction],
) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """The set's values at one block of samples, as a list of K float32
    tensors."""
    lowered = [to_torch(f) for f in fns]
    return lambda x: [f(x) for f in lowered]


def _c_float(v: float) -> str:
    if math.isnan(v):
        return "TMC_NAN"
    if math.isinf(v):
        return "TMC_INF" if v > 0 else "(-TMC_INF)"
    return f"({v!r}f)"


_C_UNARY = {
    "neg": "(-{0})",
    "abs": "fabsf({0})",
    "rint": "rintf({0})",
    "not": "(!{0})",
    "to_f32": "({0} ? 1.0f : 0.0f)",
}
_C_UNARY.update(
    {op: op + "f({0})" for op in UNARY_OPS if op not in _C_UNARY}
)
_C_BINARY = {
    "add": "({0} + {1})",
    "sub": "({0} - {1})",
    "mul": "({0} * {1})",
    "div": "({0} / {1})",
    "pow": "powf({0}, {1})",
    "atan2": "atan2f({0}, {1})",
    "hypot": "hypotf({0}, {1})",
    "copysign": "copysignf({0}, {1})",
    "fmod": "fmodf({0}, {1})",
    "minimum": "tmc_minimum({0}, {1})",
    "maximum": "tmc_maximum({0}, {1})",
    "gt": "({0} > {1})",
    "lt": "({0} < {1})",
    "ge": "({0} >= {1})",
    "le": "({0} <= {1})",
    "eq": "({0} == {1})",
    "ne": "({0} != {1})",
    "and": "({0} && {1})",
    "or": "({0} || {1})",
    "xor": "({0} != {1})",
}
assert set(_C_BINARY) == BINARY_OPS | COMPARE_OPS | LOGIC_OPS


def _fma_root(fn: TracedFunction) -> bool:
    """Whether ``fn`` ends in a float32 multiply, which a sum can take as
    one fused multiply-add (``tmc_fma``)."""
    root = fn.ir
    return root.op == "mul" and all(a.dtype != "bool" for a in root.args)


def _c_lines(roots: Sequence[Node], nd: bool, stop=None):
    """The device function body's statements for ``roots`` (``t<i>``
    temporaries, arguments first), and each node's C expression by id;
    ``stop``, a node whose statement is not emitted."""
    lines: List[str] = []
    names: Dict[int, str] = {}
    for i, node in enumerate(topo_order(roots)):
        if node is stop:
            break
        op = node.op
        if op == "arg":
            names[id(node)] = f"x[{node.value}]" if nd else "x"
            continue
        if op == "const":
            names[id(node)] = _c_float(node.value)
            continue
        args = [names[id(a)] for a in node.args]
        if op in _C_UNARY:
            expr = _C_UNARY[op].format(*args)
        elif op in _C_BINARY:
            expr = _C_BINARY[op].format(*args)
        elif op == "select":
            expr = f"({args[0]} ? {args[1]} : {args[2]})"
        else:
            raise ValueError(f"unknown IR operation {op!r}")
        ctype = "bool" if node.dtype == "bool" else "float"
        names[id(node)] = f"t{i}"
        lines.append(f"  const {ctype} t{i} = {expr};")
    return lines, names


def _c_function(name: str, fn: TracedFunction, pointer: bool = False,
                fma_acc: bool = False) -> str:
    """``fn`` as a device function; with ``fma_acc`` (``fn`` ending in a
    multiply a * b), one that returns ``tmc_fma(a, b, acc)`` for a sum
    ``acc`` passed after the point."""
    nd = pointer or fn.n_args > 1
    param = "const float* x" if nd else "float x"
    if fma_acc:
        param += ", float acc"
    lines, names = _c_lines([fn.ir], nd, fn.ir if fma_acc else None)
    if fma_acc:
        a, b = (names[id(arg)] for arg in fn.ir.args)
        ret = f"tmc_fma({a}, {b}, acc)"
    else:
        ret = names[id(fn.ir)]
    return "\n".join([f"static __device__ inline float {name}({param}) {{",
                      *lines, f"  return {ret};", "}"])


def _c_value_grad(name: str, fn: TracedFunction, nd: bool,
                  fused: bool) -> str:
    """``fn``'s value and its partial derivatives (``ops/grad.py``
    ``grad_ir``) from one forward pass, as a device function of the point
    and a sum ``acc``: it returns ``acc`` plus the value, with the
    value build's rounding (``tmc_fma(a, b, acc)`` where ``fused``, the
    function ending in a multiply a * b), and writes d f / d x_j to
    ``d[j]``.  The forward statements are the value function's, so the
    sums are the value build's bit for bit."""
    from .grad import grad_ir

    value, grads = grad_ir(fn)
    lines, names = _c_lines([value, *grads], nd)
    lines += [f"  d[{j}] = {names[id(g)]};" for j, g in enumerate(grads)]
    if fused:
        a, b = (names[id(arg)] for arg in fn.ir.args)
        ret = f"tmc_fma({a}, {b}, acc)"
    else:
        ret = f"acc + {names[id(value)]}"
    param = "const float* x" if nd else "float x"
    return "\n".join([
        f"static __device__ inline float {name}({param}, float acc, "
        "float* d) {", *lines, f"  return {ret};", "}"])


def _grad_entries(fns: Sequence[TracedFunction], fused, nd: bool) -> List[str]:
    """The gradient builds' entry (``TMC_GRAD``): ``tmc_accumulate_grad(x,
    d1, d2, acc, g)`` for 1-argument integrands, ``tmc_accumulate_nd_grad(x,
    d1, d2, acc, g)`` for d-ary ones.  Each adds ``f_k(x)`` to ``acc[k]``
    as the value entries do and the pathwise terms ``df_k/dx_j * dx_j/dp``
    to ``g[(k * d + j) * 2 + c]``, c = 0 for p1 (``d1[j]``, the sample's
    derivative in its family's first parameter) and 1 for p2, each one
    fused multiply-add."""
    d = fns[0].n_args
    parts = [_c_value_grad(f"f_{k}_vg", fn, nd, fused[k])
             for k, fn in enumerate(fns)]
    body = []
    for k in range(len(fns)):
        body.append(f"  {{\n    float d[{d}];\n"
                    f"    acc[{k}] = f_{k}_vg(x, acc[{k}], d);")
        for j in range(d):
            dj1, dj2 = (f"d1[{j}]", f"d2[{j}]") if nd else ("d1", "d2")
            i = (k * d + j) * 2
            body.append(f"    g[{i}] = tmc_fma(d[{j}], {dj1}, g[{i}]);")
            body.append(f"    g[{i + 1}] = tmc_fma(d[{j}], {dj2}, g[{i + 1}]);")
        body.append("  }")
    if nd:
        sig = ("tmc_accumulate_nd_grad(const float* x, const float* d1, "
               "const float* d2, float* acc, float* g)")
    else:
        sig = ("tmc_accumulate_grad(float x, float d1, float d2, float* acc, "
               "float* g)")
    joined = "\n".join(body)
    return parts + [f"static __device__ inline void {sig} {{\n{joined}\n}}"]


def cuda_source(fns: Sequence[TracedFunction], pointer: bool = False,
                weight=None, grad: bool = False) -> str:
    """Device source for ``fns``: ``f_0 .. f_{K-1}``, ``TMC_K`` and the
    per-point entries.

    1-argument integrands get ``tmc_accumulate(x, acc)``, which adds each
    ``f_j(x)`` to ``acc[j]`` (the integrate kernel);
    ``tmc_accumulate_sq(x, pilot, acc, sq)``, which also adds ``(f_j(x) -
    pilot[j])^2`` to ``sq[j]`` (error bars); ``tmc_accumulate_pair_sq(x,
    y, pilot, acc, sq)``, which adds ``f_j(x)`` and ``f_j(y)`` and the
    square of their mean less the pilot (antithetic error bars); and
    ``tmc_values(x, vals)``, which stores each ``f_j(x)`` in ``vals[j]``
    (the MCMC kernel, which shifts them).  ``weight=(p, q)`` gives the
    weighted entries of :func:`_weighted_entries` in their place, the
    weight made by the kernel as the module docstring says.  Integrands of d >= 2
    arguments, all of one arity, take the point as ``const float* x`` and
    get ``TMC_D`` and :func:`_nd_entries` (with a per-dimension
    ``weight``, also :func:`_nd_weighted_entries`); ``pointer=True`` gives
    1-argument integrands that form too.  The sums take an unweighted
    integrand that ends in a multiply a * b as ``f_j_fma(x, acc)``,
    ``tmc_fma(a, b, acc)``: one rounding where ``TMC_CONTRACT`` is 1 (the
    integrate kernels' sums; the other entries and the plain version
    round the product first).

    ``grad=True`` appends the gradient builds' entry
    (:func:`_grad_entries`); the other entries are unchanged, so a value
    library's source is the same with or without it."""
    k = len(fns)
    arity = {fn.n_args for fn in fns}
    if len(arity) != 1:
        raise ValueError(f"integrands of mixed arity {sorted(arity)}")
    d = arity.pop()
    nd = pointer or d > 1
    if weight is not None:
        densities = [w for pair in weight for w in pair] if nd else weight
        if (nd and (pointer or len(weight) != d)) or any(
                isinstance(w, TracedFunction) and w.n_args != 1
                for w in densities):
            raise ValueError(
                "importance weights take 1-argument densities: one (p, q) "
                "pair for 1-argument integrands, or one per dimension for "
                "d-ary ones")
    parts = [f"#define TMC_K {k}"]
    if nd:
        parts.append(f"#define TMC_D {d}")
    parts += [_c_function(f"f_{j}", fn, nd) for j, fn in enumerate(fns)]
    fused = [weight is None and _fma_root(fn) for fn in fns]
    parts += [_c_function(f"f_{j}_fma", fn, nd, fma_acc=True)
              for j, fn in enumerate(fns) if fused[j]]
    if grad and weight is not None:
        raise ValueError("the gradient builds take unweighted integrands")
    grad_entries = _grad_entries(fns, fused, nd) if grad else []
    if nd:
        acc = "\n".join(
            f"  acc[{j}] = f_{j}_fma(x, acc[{j}]);" if fused[j]
            else f"  acc[{j}] += f_{j}(x);" for j in range(k)
        )
        entries = _nd_entries(k, acc)
        if weight is not None:
            entries += _nd_weighted_entries(k, weight)
        return "\n\n".join(parts + entries + grad_entries) + "\n"
    if weight is not None:
        return "\n\n".join(parts + _weighted_entries(k, weight)) + "\n"
    return "\n\n".join(parts + _one_d_entries(k, fused) + grad_entries) + "\n"


# Weight mode codes (TMC_P_MODE, TMC_Q_MODE): a traced density
# (tmc_pdf_p, tmc_pdf_q), a uniform-grid table, the sampler's own density
# (q only), an irregular-grid table.
_WEIGHT_MODES = {"traced": 0, "table": 1, "sampler": 2, "knots": 3}


def _weighted_entries(k: int, weight) -> List[str]:
    """A weighted 1-D set's lines: ``TMC_WEIGHTED``, the two mode
    codes, the traced densities, and the entries ``tmc_accumulate_w(x, w,
    acc)``, ``tmc_accumulate_sq_w(x, w, pilot, acc, sq)`` and
    ``tmc_accumulate_pair_sq_w(x, y, wx, wy, pilot, acc, sq)``, which add
    ``f_j(x) * w`` as :func:`_one_d_entries`' entries add ``f_j(x)``."""
    modes = ["traced" if isinstance(w, TracedFunction) else w for w in weight]
    if modes[0] not in ("traced", "table", "knots") or modes[1] not in (
            _WEIGHT_MODES):
        raise ValueError(f"unknown importance weight modes {modes}")
    parts = ["#define TMC_WEIGHTED 1",
             f"#define TMC_P_MODE {_WEIGHT_MODES[modes[0]]}",
             f"#define TMC_Q_MODE {_WEIGHT_MODES[modes[1]]}"]
    for name, w in zip(("tmc_pdf_p", "tmc_pdf_q"), weight):
        if isinstance(w, TracedFunction):
            parts.append(_c_function(name, w))
    acc = "\n".join(f"  acc[{j}] += f_{j}(x) * w;" for j in range(k))
    sq = "\n".join(
        f"  {{\n    const float v = f_{j}(x) * w;\n    acc[{j}] += v;\n"
        f"    const float dd = v - pilot[{j}];\n"
        f"    sq[{j}] = tmc_fma(dd, dd, sq[{j}]);\n  }}"
        for j in range(k)
    )
    pair = "\n".join(
        f"  {{\n    const float a = f_{j}(x) * wx;\n"
        f"    const float b = f_{j}(y) * wy;\n"
        f"    acc[{j}] += a;\n    acc[{j}] += b;\n"
        f"    const float dd = tmc_fma(0.5f, a + b, -pilot[{j}]);\n"
        f"    sq[{j}] = tmc_fma(dd, dd, sq[{j}]);\n  }}"
        for j in range(k)
    )
    return parts + [
        "static __device__ inline void tmc_accumulate_w(float x, float w, "
        f"float* acc) {{\n{acc}\n}}",
        "static __device__ inline void tmc_accumulate_sq_w(float x, float w, "
        f"const float* pilot, float* acc, float* sq) {{\n{sq}\n}}",
        "static __device__ inline void tmc_accumulate_pair_sq_w(float x, "
        "float y, float wx, float wy, const float* pilot, float* acc, "
        f"float* sq) {{\n{pair}\n}}",
    ]


def _nd_weighted_entries(k: int, weight) -> List[str]:
    """A weighted d-ary set's lines (the nd kernel's product weight):
    ``TMC_WEIGHTED``, the per-dimension mode codes ``TMC_P_MODES`` and
    ``TMC_Q_MODES``, each traced density as ``tmc_pdf_p_<j>`` or
    ``tmc_pdf_q_<j>`` and the dispatchers ``tmc_pdf_p_nd(j, x)`` and
    ``tmc_pdf_q_nd(j, x)`` (0 for a dimension whose density is not
    traced), and the entries ``tmc_accumulate_nd_w(x, w, acc)``,
    ``tmc_accumulate_nd_sq_w(x, w, pilot, acc, sq)`` and
    ``tmc_values_nd_w(x, w, vals)``, which take ``f_j(x) * w`` where the
    unweighted entries take ``f_j(x)``."""
    modes = [["traced" if isinstance(w, TracedFunction) else w for w in pair]
             for pair in weight]
    for p_mode, q_mode in modes:
        if p_mode not in ("traced", "table", "knots") or (
                q_mode not in _WEIGHT_MODES):
            raise ValueError(f"unknown importance weight modes {modes}")
    parts = [
        "#define TMC_WEIGHTED 1",
        "#define TMC_P_MODES "
        + ", ".join(str(_WEIGHT_MODES[p]) for p, _ in modes),
        "#define TMC_Q_MODES "
        + ", ".join(str(_WEIGHT_MODES[q]) for _, q in modes),
    ]
    for role, side in (("p", 0), ("q", 1)):
        cases = []
        for j, pair in enumerate(weight):
            if isinstance(pair[side], TracedFunction):
                parts.append(_c_function(f"tmc_pdf_{role}_{j}", pair[side]))
                cases.append(
                    f"  if (j == {j}) return tmc_pdf_{role}_{j}(x);")
        body = "\n".join(cases + ["  return 0.0f;"])
        parts.append(f"static __device__ inline float tmc_pdf_{role}_nd(int j, "
                     f"float x) {{\n{body}\n}}")
    acc = "\n".join(f"  acc[{j}] += f_{j}(x) * w;" for j in range(k))
    sq = "\n".join(
        f"  {{\n    const float v = f_{j}(x) * w;\n    acc[{j}] += v;\n"
        f"    const float dd = v - pilot[{j}];\n"
        f"    sq[{j}] = tmc_fma(dd, dd, sq[{j}]);\n  }}"
        for j in range(k)
    )
    vals = "\n".join(f"  vals[{j}] = f_{j}(x) * w;" for j in range(k))
    return parts + [
        "static __device__ inline void tmc_accumulate_nd_w(const float* x, "
        f"float w, float* acc) {{\n{acc}\n}}",
        "static __device__ inline void tmc_accumulate_nd_sq_w(const float* x, "
        "float w, const float* pilot, float* acc, float* sq) {\n"
        f"{sq}\n}}",
        "static __device__ inline void tmc_values_nd_w(const float* x, "
        f"float w, float* vals) {{\n{vals}\n}}",
    ]


def _one_d_entries(k: int, fused) -> List[str]:
    """The 1-D integrate and MCMC kernels' per-point entries (see
    :func:`cuda_source`)."""
    acc = "\n".join(
        f"  acc[{j}] = f_{j}_fma(x, acc[{j}]);" if fused[j]
        else f"  acc[{j}] += f_{j}(x);" for j in range(k)
    )
    sq = "\n".join(
        f"  {{\n    const float v = f_{j}(x);\n    acc[{j}] += v;\n"
        f"    const float dd = v - pilot[{j}];\n"
        f"    sq[{j}] = tmc_fma(dd, dd, sq[{j}]);\n  }}"
        for j in range(k)
    )
    pair = "\n".join(
        f"  {{\n    const float a = f_{j}(x);\n"
        f"    const float b = f_{j}(y);\n"
        f"    acc[{j}] += a;\n    acc[{j}] += b;\n"
        f"    const float dd = tmc_fma(0.5f, a + b, -pilot[{j}]);\n"
        f"    sq[{j}] = tmc_fma(dd, dd, sq[{j}]);\n  }}"
        for j in range(k)
    )
    vals = "\n".join(f"  vals[{j}] = f_{j}(x);" for j in range(k))
    return [
        "static __device__ inline void tmc_accumulate(float x, float* acc) {\n"
        f"{acc}\n}}",
        "static __device__ inline void tmc_accumulate_sq(float x, "
        "const float* pilot, float* acc, float* sq) {\n"
        f"{sq}\n}}",
        "static __device__ inline void tmc_accumulate_pair_sq(float x, "
        "float y, const float* pilot, float* acc, float* sq) {\n"
        f"{pair}\n}}",
        "static __device__ inline void tmc_values(float x, float* vals) {\n"
        f"{vals}\n}}",
    ]


def cuda_target_source(fn: TracedFunction) -> str:
    """A joint log-density of d arguments as ``static __device__ inline
    float tmc_target_logpdf(const float* x)`` (the nd MCMC kernel), in
    the pointer form for every d, d = 1 included."""
    return _c_function("tmc_target_logpdf", fn, pointer=True) + "\n"


def cuda_target_grad_source(fn: TracedFunction) -> str:
    """A joint log density of d arguments and its gradient (``ops/grad.py``
    ``grad_ir``) as ``static __device__ inline float
    tmc_target_logpdf_grad(const float* x, float* g)``: one forward pass
    shared by the value, which it returns, and the d partial derivatives,
    which it writes to ``g``."""
    from .grad import grad_ir

    value, grads = grad_ir(fn)
    lines, names = _c_lines([value, *grads], nd=True)
    lines += [f"  g[{j}] = {names[id(g)]};" for j, g in enumerate(grads)]
    return "\n".join([
        "static __device__ inline float tmc_target_logpdf_grad("
        "const float* x, float* g) {",
        *lines, f"  return {names[id(value)]};", "}"]) + "\n"


def _nd_entries(k: int, acc: str) -> List[str]:
    """The nd integrate kernel's per-point entries: ``tmc_accumulate_nd(x,
    acc)`` adds each ``f_j(x)`` (the body ``acc``); ``tmc_accumulate_nd_sq(x,
    pilot, acc, sq)`` also adds ``(f_j(x) - pilot[j])^2`` to ``sq[j]``
    (error bars); ``tmc_values_nd(x, vals)`` stores each ``f_j(x)``
    (antithetic error bars, which square the pair's mean)."""
    sq = "\n".join(
        f"  {{\n    const float v = f_{j}(x);\n    acc[{j}] += v;\n"
        f"    const float dd = v - pilot[{j}];\n"
        f"    sq[{j}] = tmc_fma(dd, dd, sq[{j}]);\n  }}"
        for j in range(k)
    )
    vals = "\n".join(f"  vals[{j}] = f_{j}(x);" for j in range(k))
    return [
        "static __device__ inline void tmc_accumulate_nd(const float* x, "
        f"float* acc) {{\n{acc}\n}}",
        "static __device__ inline void tmc_accumulate_nd_sq(const float* x, "
        "const float* pilot, float* acc, float* sq) {\n"
        f"{sq}\n}}",
        "static __device__ inline void tmc_values_nd(const float* x, "
        f"float* vals) {{\n{vals}\n}}",
    ]
