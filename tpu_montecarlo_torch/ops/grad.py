"""Reverse-mode gradient of a traced function, as IR nodes.

The JAX kernels take ``jax.grad`` of a traced joint log density
(``tpu_montecarlo/ops/mcmc_nd_pallas.py:578``,
``ops/mcmc_pt_pallas.py:387``); a hand-written kernel has no autodiff.
:func:`grad_ir` builds the gradient of a :class:`~..tracing.TracedFunction`
out of the same IR nodes, so ``ops/lower.py`` lowers it to torch (the
plain version) and to CUDA C (the kernel) unchanged, both from one
shared forward pass.

Each operation takes the JVP rule that JAX 0.9 linearizes it with, in
JAX's float32 spelling, and is transposed as JAX transposes it:

* coefficients are forward values (``div``'s ``integer_pow(b, -2)`` is
  ``1 / (b * b)``, as JAX lowers it; ``sqrt``'s ``0.5 / ans``; a
  ``max``/``min`` share ``(a == m ? 1 : 0) / (b == m ? 2 : 1)``, half at
  a tie; ``abs`` the slope of ``x >= 0`` at 0), multiplied into the
  incoming cotangent ``g`` in JAX's grouping (``a / b``'s denominator
  gets ``-((g * b**-2) * a)``, ``cos``'s ``(-g) * sin(x)``);
* a node's cotangent is the sum of its consumers' contributions, added
  one at a time in the order JAX's transpose emits them: consumers from
  the last recorded to the first (``tracing.Node.serial``), and within
  one operation the order its linearization gives (``b`` before ``a``
  for ``a * b``, ``a / b``, ``pow``, ``atan2``, ``max``, ``min``;
  ``a`` first for ``add``, ``sub`` and ``fmod``; ``abs`` and ``tanh``
  each give two terms);
* ``select`` sends ``g`` to the taken branch and a zero to the other,
  which still multiplies that branch's partials (JAX's ``0 * inf =
  NaN``); ``floor``, ``ceil``, ``rint``, ``trunc``, ``sign`` (its
  select carries ``tracing.Node.no_grad``), bool operations and their
  conversions to float pass nothing; constants get no gradient;
* ``hypot`` and ``copysign``, which ``jax.numpy`` composes from
  primitives, are differentiated through that composition (its forward
  values serve as the coefficients); ``log2``/``log10`` as ``log(x) /
  log(c)``.

Every operation of ``tracing._FUNC_MAP`` has its rule.  The tests hold
the torch lowering within a few ulp of the largest term against
``jax.grad`` of the JAX package's trace (``tests/test_torch_hmc_grad.py``);
torch's and XLA's ``exp``, ``log`` and trig functions may differ in the
last bit.  Inside a Pallas kernel the JAX package sends the trig,
hyperbolic, ``expm1``, ``cbrt`` and ``copysign`` calls to its fast_math
polynomials and differentiates those; the port has no fast_math, so
there the two gradients agree to the polynomials' accuracy only.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tracing import Node, TracedFunction

__all__ = ["grad_ir"]

_ZERO_GRAD = frozenset({"floor", "ceil", "rint", "trunc", "to_f32"})


def _const(v: float) -> Node:
    with np.errstate(all="ignore"):
        return Node("const", value=float(np.float32(v)))


def _is_const(n: Node, v: Optional[float] = None) -> bool:
    return n.op == "const" and (v is None or n.value == v)


def _fold(op: str, args: Tuple[Node, ...]) -> Optional[Node]:
    """The float32 value of ``op`` on constant arguments, as a constant
    (torch's, the plain version's), or None."""
    if not all(_is_const(a) for a in args):
        return None
    from .lower import _TORCH_BINARY, _TORCH_UNARY

    ts = [torch.tensor(a.value, dtype=torch.float32) for a in args]
    fn = _TORCH_UNARY.get(op) or _TORCH_BINARY.get(op)
    if fn is None:
        return None
    return _const(float(fn(*ts)))


def _mk(op: str, *args: Node, dtype: str = "f32") -> Node:
    if dtype == "f32":
        folded = _fold(op, args)
        if folded is not None:
            return folded
    return Node(op, args, dtype)


def _mul(a: Node, b: Node) -> Node:
    # 1.0 * v is v bit for bit.
    if _is_const(a, 1.0):
        return b
    if _is_const(b, 1.0):
        return a
    return _mk("mul", a, b)


def _add(a, b):
    return _mk("add", a, b)


def _sub(a, b):
    return _mk("sub", a, b)


def _div(a, b):
    return _mk("div", a, b)


def _neg(a):
    return _mk("neg", a)


def _sq(a):
    return _mk("mul", a, a)


def _select(c, t, f):
    return Node("select", (c, t, f))


def _rsqrt(v):
    return _div(_const(1.0), _mk("sqrt", v))


def _cmp(op, a, b):
    return Node(op, (a, b), "bool")


def _sign(x):
    """lax.sign's value (tracing._sign's nodes)."""
    return _select(_cmp("gt", x, _const(0.0)), _const(1.0),
                   _select(_cmp("lt", x, _const(0.0)), _const(-1.0), x))


def _share(a, m, b):
    """The share of max/min(a, b) = m's derivative that goes to a
    (lax._balanced_eq)."""
    return _div(_select(_cmp("eq", a, m), _const(1.0), _const(0.0)),
                _select(_cmp("eq", b, m), _const(2.0), _const(1.0)))


def _expand_hypot(x, y) -> Node:
    """``jnp.hypot``'s composition (jax/_src/numpy/ufuncs.py)."""
    inf = _const(math.inf)
    a, b = _mk("abs", x), _mk("abs", y)
    is_inf = Node("or", (_cmp("eq", a, inf), _cmp("eq", b, inf)), "bool")
    z, u = _mk("maximum", a, b), _mk("minimum", a, b)
    t = _select(_cmp("eq", z, _const(0.0)), _const(1.0), z)
    r = _mk("sqrt", _add(_const(1.0), _sq(_div(u, t))))
    h = _select(_cmp("eq", z, _const(0.0)), z, _mul(z, r))
    return _select(is_inf, inf, h)


def _expand_copysign(x, y) -> Node:
    """``jnp.copysign``'s composition: where(signbit(y), -|x|, |x|)."""
    signbit = _cmp("lt", _mk("copysign", _const(1.0), y), _const(0.0))
    neg_abs = _neg(_mk("abs", x))
    return _select(signbit, neg_abs, _mk("abs", x))


_EXPANSIONS: Dict[str, Callable[..., Node]] = {
    "hypot": _expand_hypot,
    "copysign": _expand_copysign,
}
_LOG_BASE = {"log2": 2.0, "log10": 10.0}


def _rule(node: Node, g: Node, val: Callable[[Node], Node]
          ) -> List[Tuple[int, Node]]:
    """``node``'s contributions to its arguments' cotangents from its own
    cotangent ``g``: (argument index, contribution), in the order JAX's
    transpose adds them.  ``val`` maps a node to the node of its value."""
    op = node.op
    ans = val(node)
    x = val(node.args[0]) if node.args else None
    y = val(node.args[1]) if len(node.args) > 1 else None
    one = _const(1.0)
    if op == "neg":
        return [(0, _neg(g))]
    if op == "add":
        return [(0, g), (1, g)]
    if op == "sub":
        return [(0, g), (1, _neg(g))]
    if op == "mul":
        return [(1, _mul(x, g)), (0, _mul(g, y))]
    if op == "div":
        inv_sq = _div(one, _sq(y))  # integer_pow(y, -2)
        return [(1, _neg(_mul(_mul(g, inv_sq), x))), (0, _div(g, y))]
    if op == "exp":
        return [(0, _mul(g, ans))]
    if op == "log":
        return [(0, _div(g, x))]
    if op in _LOG_BASE:
        return [(0, _div(_div(g, _mk("log", _const(_LOG_BASE[op]))), x))]
    if op == "sqrt":
        return [(0, _mul(g, _div(_const(0.5), ans)))]
    if op == "sin":
        return [(0, _mul(g, _mk("cos", x)))]
    if op == "cos":
        return [(0, _mul(_neg(g), _mk("sin", x)))]
    if op == "tan":
        return [(0, _mul(g, _add(one, _sq(ans))))]
    if op == "asin":
        return [(0, _mul(g, _rsqrt(_sub(one, _sq(x)))))]
    if op == "acos":
        return [(0, _mul(g, _neg(_rsqrt(_sub(one, _sq(x))))))]
    if op == "atan":
        return [(0, _div(g, _add(one, _sq(x))))]
    if op == "sinh":
        return [(0, _mul(g, _mk("cosh", x)))]
    if op == "cosh":
        return [(0, _mul(g, _mk("sinh", x)))]
    if op == "tanh":
        e = _mul(g, _sub(one, ans))
        return [(0, e), (0, _mul(e, ans))]
    if op == "asinh":
        return [(0, _mul(g, _rsqrt(_add(_sq(x), one))))]
    if op == "acosh":
        return [(0, _mul(g, _rsqrt(_sub(_sq(x), one))))]
    if op == "atanh":
        r = _div(one, _add(one, x))
        return [(0, _div(_mul(r, g), _sub(one, x)))]
    if op == "cbrt":
        coef = _mul(_const(1.0 / 3.0), _div(one, _sq(ans)))
        return [(0, _mul(g, coef))]
    if op == "exp2":
        return [(0, _mul(_mul(_mk("log", _const(2.0)), g), ans))]
    if op == "expm1":
        return [(0, _mul(g, _add(ans, one)))]
    if op == "log1p":
        return [(0, _div(g, _add(x, one)))]
    if op == "abs":
        c = _cmp("ge", x, _const(0.0))
        return [(0, _select(c, g, _const(0.0))),
                (0, _neg(_select(c, _const(0.0), g)))]
    if op in ("maximum", "minimum"):
        return [(1, _mul(g, _share(y, ans, x))),
                (0, _mul(g, _share(x, ans, y)))]
    if op == "pow":
        safe = _select(_cmp("eq", x, _const(0.0)), one, x)
        return [(1, _mul(g, _mul(_mk("log", safe), ans))),
                (0, _mul(g, _mul(y, _mk("pow", x, _sub(y, one)))))]
    if op == "atan2":
        den = _add(_sq(x), _sq(y))
        return [(1, _mul(g, _div(_neg(x), den))),
                (0, _mul(g, _div(y, den)))]
    if op == "fmod":
        q = _mul(_sign(_div(x, y)), _mk("floor", _mk("abs", _div(x, y))))
        return [(0, g), (1, _neg(_mul(g, q)))]
    if op == "select":
        zero = _const(0.0)
        return [(1, _select(val(node.args[0]), g, zero)),
                (2, _select(val(node.args[0]), zero, g))]
    if op in _ZERO_GRAD:
        return []
    raise ValueError(f"no gradient rule for IR operation {op!r}")


def _active(order: List[Node]) -> set:
    """The ids of the float32 nodes that depend on an argument through a
    differentiable path."""
    active = set()
    for n in order:
        if n.op == "arg":
            active.add(id(n))
        elif (n.dtype == "f32" and n.op not in _ZERO_GRAD
              and not n.no_grad
              and any(id(a) in active for a in n.args)):
            active.add(id(n))
    return active


def grad_ir(fn: TracedFunction) -> Tuple[Node, List[Node]]:
    """``(value, [d/dx_j of fn for j < fn.n_args])`` as IR nodes: the
    function's own root and the gradient of ``jax.grad(lambda v:
    jnp.sum(fn(*v)))``, which share the forward nodes.  An argument the
    function does not reach gets the constant 0."""
    from .lower import topo_order

    fwd = sorted(topo_order([fn.ir]), key=lambda n: n.serial)
    # The tape: the forward nodes in recording order, a composite's
    # composition in its place; rep maps a composite to its composition.
    tape: List[Node] = []
    rep: Dict[int, Node] = {}
    for n in fwd:
        if n.op in _EXPANSIONS:
            mark = n.serial
            out = _EXPANSIONS[n.op](*n.args)
            rep[id(n)] = out
            tape += sorted((m for m in topo_order([out]) if m.serial > mark),
                           key=lambda m: m.serial)
        else:
            tape.append(n)

    def val(n: Node) -> Node:
        return rep.get(id(n), n)

    active = _active(tape)
    root = val(fn.ir)
    cts: Dict[int, Node] = {}
    if id(root) in active:
        cts[id(root)] = _const(1.0)
    for n in reversed(tape):
        g = cts.get(id(n))
        if g is None or n.op == "arg":
            continue
        for i, c in _rule(n, g, val):
            a = val(n.args[i])
            if id(a) not in active:
                continue
            prev = cts.get(id(a))
            cts[id(a)] = c if prev is None else _add(prev, c)
    grads = [_const(0.0)] * fn.n_args
    for n in tape:
        if n.op == "arg" and id(n) in cts:
            grads[n.value] = cts[id(n)]
    return fn.ir, grads
