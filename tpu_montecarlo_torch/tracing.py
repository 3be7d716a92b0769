"""Tracing front end: restricted Python -> a small integrand IR.

Port of ``tpu_montecarlo/tracing.py``.  The JAX package evaluates a user
callable's AST on JAX tracers; a hand-written CUDA kernel cannot run a JAX
trace, so this port evaluates the same AST, with the same accepted subset
and the same ``TraceError`` messages, on :class:`Node` values that record
the operations.  ``ops/lower.py`` turns the recorded IR into a torch
callable (the plain version) and into CUDA C device functions (the
kernel), so both see one parser and one set of semantics.

Accepted: lambdas or ``def`` functions of one float argument using
arithmetic, ``**`` (integer exponents become exact multiply chains),
comparisons, ``and``/``or``/``not``, ternaries, ``if``/``else`` statements
(including returns from inside branches), ``math``/``numpy`` functions and
constants, captured int/float/bool constants and helper functions.
Boolean results become 0.0/1.0.

Semantics follow the JAX interpreter value for value: arithmetic between
two Python numbers folds in Python (double precision); everything else is
an IR operation evaluated in float32, as ``jax.numpy`` evaluates it.
Both branches of a condition are evaluated and merged with a select.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``while`` loops, integer bitwise arithmetic, WGSL source strings,
vector/matrix/struct values and the direct-trace tier (callables without
recoverable source, or that call ``jax`` functions).
"""

from __future__ import annotations

import ast
import functools
import hashlib
import inspect
import itertools
import linecache
import math
import textwrap
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .utils.roadmap import FRONT_END, not_ported

__all__ = [
    "Node",
    "TraceError",
    "TracedFunction",
    "function_fingerprint",
    "is_traceable",
    "product",
    "shifted",
    "trace_function",
]

_MAX_TRACE_DEPTH = 16


class TraceError(Exception):
    """Raised when a user function cannot be traced."""


class _PartialReturnError(TraceError):
    """Internal: a block returned on one control path but its local
    continuation has no return; the function is re-lowered through the
    return-mask transform (see run())."""


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------

#: float32 -> float32 operations.
UNARY_OPS = frozenset({
    "neg", "abs", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "sqrt", "cbrt", "exp",
    "exp2", "expm1", "log", "log2", "log10", "log1p", "floor", "ceil",
    "rint", "trunc",
})
#: (float32, float32) -> float32 operations.
BINARY_OPS = frozenset({
    "add", "sub", "mul", "div", "pow", "atan2", "hypot", "copysign",
    "fmod", "minimum", "maximum",
})
#: (float32, float32) -> bool operations.
COMPARE_OPS = frozenset({"gt", "lt", "ge", "le", "eq", "ne"})
#: (bool, bool) -> bool operations; ``not`` is the unary one.
LOGIC_OPS = frozenset({"and", "or", "xor"})


_SERIALS = itertools.count()


class Node:
    """One recorded operation: ``op`` on ``args`` (other nodes), with
    result type ``dtype`` ("f32" or "bool").  ``arg`` nodes carry the
    argument index and ``const`` nodes a float32 value in ``value``.
    ``no_grad`` marks a node whose gradient is 0 whatever its op's rule:
    only the ``select`` made by ``sign`` carries it (``lax.sign`` has no
    gradient).  ``serial`` counts the nodes in the order they were
    recorded, the order in which the JAX tracer binds the same operations
    (``ops/grad.py`` reverses it).

    Arithmetic operators record operations, so composite functions
    (``mix``, ``smoothstep``, ``_int_pow``) read as they do in the JAX
    package; between two Python floats they fold in Python, as there."""

    __slots__ = ("op", "args", "dtype", "value", "no_grad", "serial")

    def __init__(self, op: str, args=(), dtype: str = "f32", value=None):
        self.op = op
        self.args = tuple(args)
        self.dtype = dtype
        self.value = value
        self.no_grad = False
        self.serial = next(_SERIALS)

    def __repr__(self):
        return f"Node({self.op}, {self.dtype})"

    def __bool__(self):
        raise TraceError(
            "a traced value cannot be used as a Python truth value"
        )

    def __add__(self, o):
        return _arith("add", self, o)

    def __radd__(self, o):
        return _arith("add", o, self)

    def __sub__(self, o):
        return _arith("sub", self, o)

    def __rsub__(self, o):
        return _arith("sub", o, self)

    def __mul__(self, o):
        return _arith("mul", self, o)

    def __rmul__(self, o):
        return _arith("mul", o, self)

    def __truediv__(self, o):
        return _arith("div", self, o)

    def __rtruediv__(self, o):
        return _arith("div", o, self)

    def __neg__(self):
        return Node("neg", (_f32(self),))

    def __pos__(self):
        return self


def _const(v: float) -> Node:
    with np.errstate(over="ignore"):
        return Node("const", value=float(np.float32(v)))


def _node(v) -> Node:
    if isinstance(v, Node):
        return v
    if isinstance(v, (int, float, np.floating, np.integer)):
        return _const(float(v))
    raise TraceError(f"Unsupported value of type {type(v).__name__}")


def _f32(v) -> Node:
    n = _node(v)
    return Node("to_f32", (n,)) if n.dtype == "bool" else n


def _is_bool(v) -> bool:
    return isinstance(v, Node) and v.dtype == "bool"


_PY_ARITH = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}


def _arith(op: str, a, b):
    if not isinstance(a, Node) and not isinstance(b, Node):
        return _PY_ARITH[op](a, b)
    if _is_bool(a) and _is_bool(b) and op in ("add", "mul"):
        # jax.numpy adds bools as a logical or, multiplies them as an and.
        return Node("or" if op == "add" else "and", (a, b), "bool")
    return Node(op, (_f32(a), _f32(b)))


def _unary(op: str):
    def impl(a):
        return Node(op, (_f32(a),))

    impl.__name__ = op
    return impl


def _binary(op: str):
    def impl(a, b):
        return Node(op, (_f32(a), _f32(b)))

    impl.__name__ = op
    return impl


def _compare(op: str, a, b) -> Node:
    return Node(op, (_f32(a), _f32(b)), "bool")


def _truthy(v) -> Node:
    if _is_bool(v):
        return v
    return _compare("ne", v, 0.0)


def _logical(op: str, a, b) -> Node:
    return Node(op, (_truthy(a), _truthy(b)), "bool")


def _logical_not(v) -> Node:
    return Node("not", (_truthy(v),), "bool")


def _merge(cond: Node, t_val, f_val) -> Node:
    """``where(cond, t, f)``; a bool operand meeting a float one is promoted
    to 0.0/1.0, as ``jnp.where`` promotes it.  ``cond`` must be bool."""
    t, f = _node(t_val), _node(f_val)
    if t.dtype != f.dtype:
        t, f = _f32(t), _f32(f)
    return Node("select", (cond, t, f), t.dtype)


def _int_pow(base, exp: int):
    """Binary exponentiation with exact multiplies."""
    if exp == 0:
        return _const(1.0)
    inv = exp < 0
    exp = abs(exp)
    result = None
    acc = _f32(base)
    while exp:
        if exp & 1:
            result = acc if result is None else result * acc
        exp >>= 1
        if exp:
            acc = acc * acc
    return 1.0 / result if inv else result


# ---------------------------------------------------------------------------
# Function / constant tables
# ---------------------------------------------------------------------------

_minimum = _binary("minimum")
_maximum = _binary("maximum")
_floor = _unary("floor")


def _fract(x):
    return x - _floor(x)


def _mix(a, b, t):
    return a + (b - a) * t


def _step(edge, x):
    return _merge(_compare("lt", x, edge), 0.0, 1.0)


def _clip(x, lo, hi):
    return _minimum(hi, _maximum(lo, x))


def _smoothstep(e0, e1, x):
    t = _clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _sign(x):
    # lax.sign: +-1, and x itself at zero and NaN; no gradient.
    x = _f32(x)
    out = _merge(
        _compare("gt", x, 0.0), 1.0,
        _merge(_compare("lt", x, 0.0), -1.0, x),
    )
    out.no_grad = True
    return out


def _heaviside(x1, x2):
    return _merge(
        _compare("lt", x1, 0.0), 0.0,
        _merge(_compare("gt", x1, 0.0), 1.0, x2),
    )


def _power(a, b):
    return Node("pow", (_f32(a), _f32(b)))


def _fmod(a, b):
    return Node("fmod", (_f32(a), _f32(b)))


def _remainder(a, b):
    """Python's floor-mod, as ``jnp.remainder`` computes it from fmod."""
    trunc_mod = _fmod(a, b)
    do_plus = _logical(
        "and",
        _logical("xor", _compare("lt", trunc_mod, 0.0), _compare("lt", b, 0.0)),
        _compare("ne", trunc_mod, 0.0),
    )
    return _merge(do_plus, trunc_mod + b, trunc_mod)


def _floor_divide(a, b):
    """``jnp.floor_divide`` on floats (CPython's float_divmod)."""
    mod = _fmod(a, b)
    div = (a - mod) / b
    ind = _logical(
        "and",
        _compare("ne", mod, 0.0),
        _compare("ne", _sign(b), _sign(mod)),
    )
    return Node("rint", (_merge(ind, div - 1.0, div),))


def _where(cond, t, f):
    return _merge(_truthy(cond), t, f)


def _select(f_val, t_val, cond):
    return _merge(_truthy(cond), t_val, f_val)


def _cast_f32(v):
    return _f32(v)


def _square(x):
    x = _f32(x)
    return x * x


def _scale(factor: float):
    def impl(x):
        return _f32(x) * _const(factor)

    return impl


def _minmax(op):
    def impl(*args):
        if len(args) < 2:
            raise TraceError("min/max need at least two arguments")
        return functools.reduce(op, args)

    return impl


# Python math-subset name -> IR builder (the JAX package's _FUNC_MAP).
_FUNC_MAP: Dict[str, Callable] = {
    "abs": _unary("abs"),
    "fabs": _unary("abs"),
    "sin": _unary("sin"),
    "cos": _unary("cos"),
    "tan": _unary("tan"),
    "asin": _unary("asin"),
    "acos": _unary("acos"),
    "atan": _unary("atan"),
    "atan2": _binary("atan2"),
    "arcsin": _unary("asin"),
    "arccos": _unary("acos"),
    "arctan": _unary("atan"),
    "arctan2": _binary("atan2"),
    "sinh": _unary("sinh"),
    "cosh": _unary("cosh"),
    "tanh": _unary("tanh"),
    "asinh": _unary("asinh"),
    "acosh": _unary("acosh"),
    "atanh": _unary("atanh"),
    "arcsinh": _unary("asinh"),
    "arccosh": _unary("acosh"),
    "arctanh": _unary("atanh"),
    "sqrt": _unary("sqrt"),
    "cbrt": _unary("cbrt"),
    "exp": _unary("exp"),
    "exp2": _unary("exp2"),
    "expm1": _unary("expm1"),
    "log": _unary("log"),
    "log2": _unary("log2"),
    "log10": _unary("log10"),
    "log1p": _unary("log1p"),
    "floor": _floor,
    "ceil": _unary("ceil"),
    "round": _unary("rint"),
    "trunc": _unary("trunc"),
    "fract": _fract,
    "sign": _sign,
    "copysign": _binary("copysign"),
    "fmod": _fmod,
    "hypot": _binary("hypot"),
    "degrees": _scale(180.0 / math.pi),
    "radians": _scale(math.pi / 180.0),
    "min": _minmax(_minimum),
    "max": _minmax(_maximum),
    "minimum": _minimum,
    "maximum": _maximum,
    "fmin": _minimum,
    "fmax": _maximum,
    "clamp": _clip,
    "clip": _clip,
    "mix": _mix,
    "lerp": _mix,
    "step": _step,
    "smoothstep": _smoothstep,
    "pow": _power,
    "power": _power,
    "where": _where,
    "select": _select,
    "heaviside": _heaviside,
    "square": _square,
    "f32": _cast_f32,
}
_IR_BUILDERS = frozenset(id(f) for f in _FUNC_MAP.values())

# Explicitly rejected calls, with the JAX package's messages.
_REJECTED_CALLS = {
    "int": "int() casts are not traceable",
    "float": "float() casts are not traceable",
    "bool": "bool() casts are not traceable",
    "complex": "complex numbers are not supported",
    "str": "str() is not supported",
    "list": "list() is not supported",
    "dict": "dict() is not supported",
    "tuple": "tuple() is not supported",
    "set": "set() is not supported",
    "len": "len() is not supported",
    "range": "range() is not supported",
    "print": "print() is not supported",
    "input": "input() is not supported",
}

# Module constants.
_CONSTANTS: Dict[str, float] = {
    "pi": math.pi,
    "e": math.e,
    "tau": math.tau,
    "inf": math.inf,
    "nan": math.nan,
    "euler_gamma": float(np.euler_gamma),
}

_BUILTIN_FUNCS = {
    "abs": _FUNC_MAP["abs"],
    "min": _FUNC_MAP["min"],
    "max": _FUNC_MAP["max"],
    "pow": _power,
    "round": _FUNC_MAP["round"],
}


class _ModuleRef:
    """Marker for a resolved math-like module (math / numpy / jax.numpy)."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind  # "math" | "numpy" | "jnp"


def _classify_module(val) -> Optional[_ModuleRef]:
    if not isinstance(val, types.ModuleType):
        return None
    name = getattr(val, "__name__", "")
    if name == "math":
        return _ModuleRef("math")
    if name == "numpy":
        return _ModuleRef("numpy")
    if name in ("jax.numpy", "jax"):
        return _ModuleRef("jnp")
    return None


def _bit_binop(op: str, a, b):
    """``& | ^ << >>``: logical connectives on bool operands (traced
    lambdas write ``(x > a) & (x < b)``), exact integer folding between
    two constants.  The f32-modelled integer arithmetic of the JAX
    package on traced values is not ported yet."""
    if op in ("BitAnd", "BitOr", "BitXor") and (_is_bool(a) or _is_bool(b)):
        return _logical(
            {"BitAnd": "and", "BitOr": "or", "BitXor": "xor"}[op], a, b
        )
    if isinstance(a, float) and isinstance(b, float):
        if not (a.is_integer() and b.is_integer()):
            raise TraceError("bitwise/shift operators need integer operands")
        ai, bi = int(a), int(b)
        impl = {
            "BitAnd": lambda x, y: x & y,
            "BitOr": lambda x, y: x | y,
            "BitXor": lambda x, y: x ^ y,
            "LShift": lambda x, y: _wrap_i32(x << (y & 31)),
            "RShift": lambda x, y: x >> (y & 31),
        }[op]
        return float(impl(ai, bi))
    raise not_ported("integer bitwise arithmetic on traced values", FRONT_END)


def _wrap_i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


# ---------------------------------------------------------------------------
# Source recovery
# ---------------------------------------------------------------------------


def _first_instruction_col(code) -> Optional[int]:
    """Smallest column of any instruction on the code object's first line
    (picks the right lambda when several share a source line)."""
    try:
        positions = list(code.co_positions())
    except AttributeError:
        return None
    cols = [
        p[2]
        for p in positions
        if p[0] == code.co_firstlineno
        and p[2] is not None
        # skip zero-width prologue positions (RESUME reports col 0:0)
        and not (p[2] == 0 and p[3] == 0)
    ]
    return min(cols) if cols else None


def _find_def_node(func) -> ast.AST:
    """Recover the AST node (Lambda or FunctionDef) for a live callable."""
    code = func.__code__
    filename = code.co_filename
    lineno = code.co_firstlineno
    is_lambda = func.__name__ == "<lambda>"

    trees: List[Tuple[ast.AST, int]] = []  # (tree, line offset)

    file_src = "".join(linecache.getlines(filename))
    if file_src:
        try:
            trees.append((ast.parse(file_src), 0))
        except SyntaxError:
            pass

    if not trees:
        try:
            snippet = textwrap.dedent(inspect.getsource(func))
            trees.append((ast.parse(snippet), lineno - 1))
        except (OSError, TypeError, SyntaxError, IndentationError):
            pass

    for tree, offset in trees:
        if is_lambda:
            cands = [
                n
                for n in ast.walk(tree)
                if isinstance(n, ast.Lambda) and n.lineno + offset == lineno
            ]
            if len(cands) == 1:
                return cands[0]
            if len(cands) > 1:
                col = _first_instruction_col(code)
                if col is not None:
                    inside = [
                        n
                        for n in cands
                        if n.col_offset <= col <= (n.end_col_offset or 10**9)
                    ]
                    if inside:
                        return min(
                            inside,
                            key=lambda n: (n.end_col_offset or 10**9)
                            - n.col_offset,
                        )
                raise TraceError(
                    "Cannot disambiguate multiple lambdas defined on one "
                    "source line (Python >= 3.11 required)"
                )
        else:
            cands = [
                n
                for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == func.__name__
            ]
            if cands:
                return min(cands, key=lambda n: abs(n.lineno + offset - lineno))

    # The JAX package hands such callables to its direct-trace tier.
    raise not_ported(
        f"tracing {getattr(func, '__name__', func)!r}, whose source cannot "
        "be recovered (the direct-trace tier)",
        FRONT_END,
    )


# ---------------------------------------------------------------------------
# AST interpreter
# ---------------------------------------------------------------------------


def _contains_return(stmts: Sequence[ast.stmt]) -> bool:
    return any(
        isinstance(sub, ast.Return) for node in stmts for sub in ast.walk(node)
    )


# -- return-mask lowering -------------------------------------------------
#
# A branch that returns while its local continuation does not (``if c:
# return a`` as the last statement of an outer branch, the function
# returning later) has no direct (env, ret) form.  Such a function is
# re-lowered as masked dataflow: ``return e`` becomes ``__ret_val = e;
# __ret_mask = 1`` with the rest of the block guarded on the mask, and a
# trailing ``return __ret_val`` delivers the result — first return wins,
# which is early-return semantics.

_RET_MASK = "__tmc_ret_mask__"
_RET_VAL = "__tmc_ret_val__"


def _synth(node: ast.AST, like: ast.AST) -> ast.AST:
    ast.copy_location(node, like)
    ast.fix_missing_locations(node)
    return node


def _assign_name(name: str, value: ast.expr, like: ast.AST) -> ast.stmt:
    return _synth(
        ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())], value=value),
        like,
    )


def _mask_clear_test(like: ast.AST) -> ast.expr:
    return _synth(
        ast.Compare(
            left=ast.Name(id=_RET_MASK, ctx=ast.Load()),
            ops=[ast.Eq()],
            comparators=[ast.Constant(value=0.0)],
        ),
        like,
    )


def _mask_returns(stmts: Sequence[ast.stmt]) -> List[ast.stmt]:
    """Rewrite every ``return`` in a statement list into mask/value
    assignments, guarding statements a conditional return would skip."""
    out: List[ast.stmt] = []
    for idx, stmt in enumerate(stmts):
        if isinstance(stmt, ast.Return):
            if stmt.value is None:
                raise TraceError("Functions must return a value")
            out.append(_assign_name(_RET_VAL, stmt.value, stmt))
            out.append(_assign_name(_RET_MASK, ast.Constant(value=1.0), stmt))
            return out  # statements after an unconditional return are dead
        if isinstance(stmt, ast.If) and _contains_return([stmt]):
            body = _mask_returns(stmt.body) or [_synth(ast.Pass(), stmt)]
            out.append(
                _synth(
                    ast.If(
                        test=stmt.test,
                        body=body,
                        orelse=_mask_returns(stmt.orelse),
                    ),
                    stmt,
                )
            )
            rest = stmts[idx + 1 :]
            if rest:
                out.append(
                    _synth(
                        ast.If(
                            test=_mask_clear_test(stmt),
                            body=_mask_returns(rest)
                            or [_synth(ast.Pass(), stmt)],
                            orelse=[],
                        ),
                        stmt,
                    )
                )
            return out
        out.append(stmt)
    return out


def _definitely_returns(stmts: Sequence[ast.stmt]) -> bool:
    """Static guarantee that every control path through the list returns."""
    for stmt in stmts:
        if isinstance(stmt, ast.Return):
            return True
        if isinstance(stmt, ast.If) and stmt.orelse:
            if _definitely_returns(stmt.body) and _definitely_returns(
                stmt.orelse
            ):
                return True
    return False


def _mask_lowered_body(body: Sequence[ast.stmt]) -> List[ast.stmt]:
    """Whole-function masked-return lowering; the trailing return's fold
    is an identity because _definitely_returns guaranteed the mask is set
    on every path."""
    like = body[0]
    out = _mask_returns(list(body))
    out.append(
        _synth(ast.Return(value=ast.Name(id=_RET_VAL, ctx=ast.Load())), like)
    )
    return out


class _Interpreter:
    """Symbolically evaluates a restricted-Python function body on IR
    values.  One instance per traced function."""

    def __init__(self, func, depth: int = 0):
        self.func = func
        self.depth = depth
        if depth > _MAX_TRACE_DEPTH:
            raise TraceError("Maximum trace recursion depth exceeded")
        # Captured environment: closure cells first, then globals.
        self.captured = dict(getattr(func, "__globals__", {}) or {})
        code = func.__code__
        for name, cell in zip(code.co_freevars, func.__closure__ or ()):
            try:
                self.captured[name] = cell.cell_contents
            except ValueError:
                pass

    # -- name resolution ---------------------------------------------------

    def resolve_external(self, name: str):
        if name in self.captured:
            return self.admit(name, self.captured[name])
        if name in _BUILTIN_FUNCS:
            return _BUILTIN_FUNCS[name]
        if name in _REJECTED_CALLS:
            raise TraceError(_REJECTED_CALLS[name])
        raise TraceError(f"Unknown variable or function: '{name}'")

    def admit(self, name: str, val):
        """Validate a captured external value (int/float/bool constants,
        math modules and callables)."""
        if isinstance(val, bool):
            return 1.0 if val else 0.0
        if isinstance(val, (int, float, np.floating, np.integer)):
            return float(val)
        mod = _classify_module(val)
        if mod is not None:
            return mod
        if callable(val):
            return val  # resolved further at call sites
        raise TraceError(
            f"Unsupported external variable '{name}' of type "
            f"{type(val).__name__} (only int/float/bool constants, math "
            f"modules and callables are allowed)"
        )

    # -- expression evaluation ----------------------------------------------

    def eval(self, node: ast.expr, env: Dict[str, Any]):
        meth = getattr(self, f"_eval_{type(node).__name__}", None)
        if meth is None:
            raise TraceError(f"Unsupported expression: {type(node).__name__}")
        return meth(node, env)

    def _eval_Constant(self, node, env):
        v = node.value
        if isinstance(v, bool):
            return 1.0 if v else 0.0
        if isinstance(v, (int, float)):
            return float(v)
        if v is None:
            raise TraceError("None is not a valid value in traced functions")
        raise TraceError(f"Unsupported constant: {v!r}")

    def _eval_Name(self, node, env):
        if node.id in env:
            return env[node.id]
        return self.resolve_external(node.id)

    def _eval_BinOp(self, node, env):
        left = self.eval(node.left, env)
        right = self.eval(node.right, env)
        op = type(node.op).__name__
        if op in ("BitAnd", "BitOr", "BitXor", "LShift", "RShift"):
            return _bit_binop(op, left, right)
        if op == "Add":
            return _arith("add", left, right)
        if op == "Sub":
            return _arith("sub", left, right)
        if op == "Mult":
            return _arith("mul", left, right)
        if op == "Div":
            return _arith("div", left, right)
        if op == "Mod":
            # Python floor-mod semantics.
            if isinstance(left, float) and isinstance(right, float):
                return math.fmod(left, right) if right == 0 else left % right
            return _remainder(left, right)
        if op == "Pow":
            if isinstance(left, float) and isinstance(right, float):
                return left**right
            if isinstance(right, float) and right.is_integer() and abs(right) <= 64:
                # Exact repeated multiplication for integer exponents:
                # defined for negative bases, no exp/log round trip.
                return _int_pow(left, int(right))
            return _power(left, right)
        if op == "FloorDiv":
            return _floor_divide(left, right)
        raise TraceError(f"Unsupported binary operator: {op}")

    def _eval_UnaryOp(self, node, env):
        val = self.eval(node.operand, env)
        op = type(node.op).__name__
        if op == "USub":
            return -val
        if op == "UAdd":
            return +val
        if op == "Not":
            return _logical_not(val)
        if op == "Invert":
            return _bit_binop("BitXor", val, -1.0)
        raise TraceError(f"Unsupported unary operator: {op}")

    _CMP = {
        "Gt": "gt",
        "Lt": "lt",
        "GtE": "ge",
        "LtE": "le",
        "Eq": "eq",
        "NotEq": "ne",
    }

    def _eval_Compare(self, node, env):
        left = self.eval(node.left, env)
        result = None
        for op, comparator in zip(node.ops, node.comparators):
            opname = type(op).__name__
            if opname not in self._CMP:
                raise TraceError(f"Unsupported comparison: {opname}")
            right = self.eval(comparator, env)
            term = _compare(self._CMP[opname], left, right)
            result = term if result is None else _logical("and", result, term)
            left = right
        return result

    def _eval_BoolOp(self, node, env):
        # Python value semantics without short-circuit: a and b ==
        # where(truthy(a), b, a); a or b == where(truthy(a), a, b).
        vals = [self.eval(v, env) for v in node.values]
        is_and = isinstance(node.op, ast.And)
        acc = vals[0]
        for v in vals[1:]:
            if is_and:
                acc = _merge(_truthy(acc), v, acc)
            else:
                acc = _merge(_truthy(acc), acc, v)
        return acc

    def _eval_IfExp(self, node, env):
        test = _truthy(self.eval(node.test, env))
        body = self.eval(node.body, env)
        orelse = self.eval(node.orelse, env)
        return _merge(test, body, orelse)

    def _eval_Attribute(self, node, env):
        base = self.eval(node.value, env)
        if isinstance(base, _ModuleRef):
            if node.attr in _CONSTANTS:
                if node.attr == "euler_gamma" and base.kind == "math":
                    raise TraceError("math module has no attribute euler_gamma")
                return _CONSTANTS[node.attr]
            if node.attr in _FUNC_MAP:
                return _FUNC_MAP[node.attr]
            if base.kind == "jnp":
                raise not_ported(
                    f"jax.numpy.{node.attr} (the direct-trace tier)", FRONT_END
                )
            raise TraceError(
                f"Unknown function or constant: {base.kind}.{node.attr}"
            )
        raise TraceError(
            f"Attribute access is only supported on math modules, got "
            f"attribute '{node.attr}'"
        )

    def _eval_Call(self, node, env):
        if node.keywords:
            raise TraceError("Keyword arguments are not supported")

        # __import__('math') idiom
        if (
            isinstance(node.func, ast.Name)
            and node.func.id == "__import__"
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
        ):
            modname = node.args[0].value
            if modname == "math":
                return _ModuleRef("math")
            if modname == "numpy":
                return _ModuleRef("numpy")
            raise TraceError(f"Unknown module: {modname}")

        fn = self._resolve_callable(node.func, env)
        args = [self.eval(a, env) for a in node.args]
        return fn(*args)

    def _eval_Subscript(self, node, env):
        # Python integrands have no vector values to index (those come
        # from WGSL source, not ported yet).
        self.eval(node.value, env)
        raise TraceError("Indexing is only supported on vector/array/matrix values")

    def _resolve_callable(self, func_node: ast.expr, env: Dict[str, Any]):
        if isinstance(func_node, ast.Name):
            name = func_node.id
            if name in env:
                val = env[name]
            else:
                if name in _REJECTED_CALLS:
                    raise TraceError(_REJECTED_CALLS[name])
                if name in self.captured:
                    val = self.admit(name, self.captured[name])
                elif name in _BUILTIN_FUNCS:
                    return _BUILTIN_FUNCS[name]
                else:
                    raise TraceError(f"Unknown function: {name}")
            return self._as_callable(name, val)
        if isinstance(func_node, ast.Attribute):
            val = self.eval(func_node, env)
            return self._as_callable(func_node.attr, val)
        raise TraceError("Only direct function calls are supported")

    def _as_callable(self, name: str, val):
        if isinstance(val, _ModuleRef):
            raise TraceError(f"'{name}' is a module, not callable")
        if callable(val):
            if id(val) in _IR_BUILDERS:
                return val
            modname = getattr(val, "__module__", "") or ""
            qualname = getattr(val, "__name__", name)
            if modname == "math" or isinstance(val, np.ufunc):
                impl = _FUNC_MAP.get(qualname)
                if impl is None:
                    raise TraceError(f"Unknown function: {qualname}")
                return impl
            if modname.startswith("jax"):
                raise not_ported(
                    f"calling {modname}.{qualname} (the direct-trace tier)",
                    FRONT_END,
                )
            if isinstance(val, types.FunctionType):
                # User helper function: traced recursively.
                return _interpret_callable(val, self.depth + 1)
            impl = _FUNC_MAP.get(qualname)
            if impl is not None:
                return impl
            raise TraceError(f"Unknown function: {qualname}")
        if isinstance(val, float):
            raise TraceError(f"'{name}' is a constant, not callable")
        raise TraceError(f"Unknown function: {name}")

    # -- statement execution -------------------------------------------------

    def exec_block(
        self, stmts: Sequence[ast.stmt], env: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], Optional[Any]]:
        """Execute statements; returns (env, return_value_or_None)."""
        for idx, stmt in enumerate(stmts):
            rest = stmts[idx + 1 :]
            kind = type(stmt).__name__

            if kind == "Return":
                if stmt.value is None:
                    raise TraceError("Functions must return a value")
                return env, self.eval(stmt.value, env)

            if kind == "Assign":
                if len(stmt.targets) != 1 or not isinstance(
                    stmt.targets[0], ast.Name
                ):
                    raise TraceError(
                        "Only single-variable assignments are supported"
                    )
                env = dict(env)
                env[stmt.targets[0].id] = self.eval(stmt.value, env)
                continue

            if kind == "AugAssign":
                if not isinstance(stmt.target, ast.Name):
                    raise TraceError(
                        "Only single-variable assignments are supported"
                    )
                binop = ast.BinOp(
                    left=ast.Name(id=stmt.target.id, ctx=ast.Load()),
                    op=stmt.op,
                    right=stmt.value,
                )
                ast.copy_location(binop, stmt)
                ast.fix_missing_locations(binop)
                env = dict(env)
                env[stmt.target.id] = self._eval_BinOp(binop, env)
                continue

            if kind == "AnnAssign":
                if stmt.value is None or not isinstance(stmt.target, ast.Name):
                    raise TraceError("Unsupported annotated assignment")
                env = dict(env)
                env[stmt.target.id] = self.eval(stmt.value, env)
                continue

            if kind == "If":
                return self._exec_if(stmt, rest, env)

            if kind == "While":
                raise not_ported("while loops in integrands", FRONT_END)

            if kind in ("Expr", "Pass"):
                # Docstrings and bare expressions: no effect.
                continue

            if kind == "For":
                raise TraceError("For loops are not supported")

            raise TraceError(f"Unsupported statement: {kind}")

        return env, None

    def _exec_if(self, stmt: ast.If, rest, env):
        test = _truthy(self.eval(stmt.test, env))
        env_t, ret_t = self.exec_block(stmt.body, dict(env))
        env_f, ret_f = self.exec_block(stmt.orelse, dict(env))

        if ret_t is not None and ret_f is not None:
            return env, _merge(test, ret_t, ret_f)

        if ret_t is None and ret_f is None:
            merged = dict(env)
            for key in set(env_t) | set(env_f):
                in_t, in_f = key in env_t, key in env_f
                if in_t and in_f:
                    if env_t[key] is env_f[key]:
                        merged[key] = env_t[key]
                    else:
                        merged[key] = _merge(test, env_t[key], env_f[key])
                elif key in env:
                    merged[key] = _merge(
                        test, env_t.get(key, env[key]), env_f.get(key, env[key])
                    )
                # else: one-sided new variable, dropped; later use errors.
            return self.exec_block(rest, merged)

        # Exactly one branch returned: the continuation only runs on the
        # non-returning side.  A continuation without a return may still
        # be valid (an enclosing block may return after us), so signal the
        # caller to re-lower through the return mask.
        if ret_t is not None:
            env_c, ret_c = self.exec_block(rest, env_f)
            if ret_c is None:
                raise _PartialReturnError()
            return env, _merge(test, ret_t, ret_c)
        env_c, ret_c = self.exec_block(rest, env_t)
        if ret_c is None:
            raise _PartialReturnError()
        return env, _merge(test, ret_c, ret_f)

    # -- entry ----------------------------------------------------------------

    def run(self, node: ast.AST, args: Sequence[Any]):
        if not isinstance(node, (ast.Lambda, ast.FunctionDef)):
            raise TraceError(f"Cannot trace node of type {type(node).__name__}")
        params = [a.arg for a in node.args.args]
        if len(params) != len(args):
            raise TraceError(
                f"Function takes {len(params)} arguments, got {len(args)}"
            )
        env = dict(zip(params, args))
        if isinstance(node, ast.Lambda):
            return self.eval(node.body, env)
        try:
            _, ret = self.exec_block(node.body, env)
        except _PartialReturnError:
            if not _definitely_returns(node.body):
                raise TraceError("Function must return a value")
            env = dict(zip(params, args))
            env[_RET_MASK] = 0.0
            env[_RET_VAL] = 0.0
            _, ret = self.exec_block(_mask_lowered_body(node.body), env)
        if ret is None:
            raise TraceError("Function must return a value")
        return ret


def _interpret_callable(func, depth: int = 0) -> Callable:
    node = _find_def_node(func)
    interp = _Interpreter(func, depth)

    def traced(*args):
        # Boolean results become 0.0/1.0.
        return _f32(interp.run(node, args))

    traced.__name__ = getattr(func, "__name__", "traced")
    return traced


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class TracedFunction:
    """A traced integrand: its IR (``ir``, a float32 :class:`Node` of the
    argument nodes) plus the content key the program cache uses."""

    __slots__ = ("name", "n_args", "ir", "key")

    def __init__(self, name: str, n_args: int, ir: Node, key):
        self.name = name
        self.n_args = n_args
        self.ir = ir
        self.key = key

    def __repr__(self):
        return f"TracedFunction({self.name})"


def shifted(fn: TracedFunction, s: float) -> TracedFunction:
    """``fn(*xs) - s`` with ``s`` rounded to a float32 constant, as IR over
    ``fn``'s (a control variate's pilot shift); keyed by ``fn``'s key and
    the constant, so two shifts share a program only where they agree."""
    c = _const(s)
    return TracedFunction(f"{fn.name}_shifted", fn.n_args,
                          Node("sub", (fn.ir, c)),
                          ("shifted", fn.key, c.value))


def product(a: TracedFunction, b: TracedFunction) -> TracedFunction:
    """``a(*xs) * b(*xs)``, as IR over both functions' (a control
    variate's product moment); keyed by the two keys."""
    if a.n_args != b.n_args:
        raise ValueError(f"a product of {a.n_args}- and {b.n_args}-argument "
                         "functions")
    return TracedFunction(f"{a.name}_times_{b.name}", a.n_args,
                          Node("mul", (a.ir, b.ir)),
                          ("product", a.key, b.key))


def _code_fingerprint(code, depth: int = 0):
    """Structural fingerprint of a code object (recursing into nested code
    constants, e.g. inner lambdas)."""
    consts = []
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            if depth < 4:
                consts.append(_code_fingerprint(c, depth + 1))
        elif isinstance(c, (int, float, bool, str, bytes, type(None))):
            consts.append(c)
    return (code.co_filename, code.co_firstlineno, code.co_code, tuple(consts))


def function_fingerprint(func) -> Optional[tuple]:
    """Content-based cache key for a user function: code identity plus the
    values of captured numeric constants (and the code identity of captured
    helper callables).  A fresh lambda object with the same code and
    captures maps to the same key, so the program cache hits."""
    try:
        code = func.__code__
    except AttributeError:
        return None
    captured = []
    glb = getattr(func, "__globals__", {}) or {}
    cells = dict(zip(code.co_freevars, func.__closure__ or ()))
    for name in sorted(set(code.co_names) | set(code.co_freevars)):
        if name in cells:
            try:
                v = cells[name].cell_contents
            except ValueError:
                continue
        elif name in glb:
            v = glb[name]
        else:
            continue
        if isinstance(v, (bool, int, float, np.floating, np.integer)):
            captured.append((name, float(v)))
        elif isinstance(v, types.FunctionType):
            captured.append((name, function_fingerprint(v)))
        elif isinstance(v, types.ModuleType):
            captured.append((name, ("mod", getattr(v, "__name__", ""))))
        elif isinstance(v, (np.ufunc, types.BuiltinFunctionType)):
            captured.append((name, ("ufunc", getattr(v, "__name__", str(v)))))
        elif isinstance(v, np.ndarray):
            digest = hashlib.sha1(np.ascontiguousarray(v)).hexdigest()
            captured.append((name, ("arr", v.shape, str(v.dtype), digest)))
        else:
            # A capture the fingerprint cannot represent: key by identity
            # rather than risk two different functions sharing a key.
            return None
    return ("pyfn", _code_fingerprint(code), tuple(captured))


def trace_function(func: Callable, n_args: int = 1) -> TracedFunction:
    """Trace a user callable of ``n_args`` float arguments into the IR.

    Raises:
        TraceError: for constructs outside the accepted subset, with the
            JAX package's messages.
        NotImplementedError: for constructs the JAX package accepts that
            the port does not have yet (see the module docstring).
    """
    if isinstance(func, TracedFunction):
        return func
    if not callable(func):
        raise TypeError(f"Function must be callable, got {type(func)}")
    if not isinstance(getattr(func, "__code__", None), types.CodeType):
        raise not_ported(
            f"tracing {func!r}, which is not a Python function (the "
            "direct-trace tier)",
            FRONT_END,
        )
    args = [Node("arg", value=i) for i in range(n_args)]
    ir = _interpret_callable(func)(*args)
    fp = function_fingerprint(func)
    # Without a content key, key by the function object itself: the key
    # then keeps it alive, so its identity cannot be reused.
    key = fp if fp is not None else ("fn", func)
    return TracedFunction(getattr(func, "__name__", "traced"), n_args, ir, key)


def is_traceable(func: Callable, n_args: int = 1) -> bool:
    """True if ``trace_function`` would succeed."""
    try:
        trace_function(func, n_args)
        return True
    except (TraceError, TypeError, NotImplementedError):
        return False
