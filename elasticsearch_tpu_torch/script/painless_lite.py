"""painless-lite: the vectorizable score-script subset, in PyTorch.

Port of elasticsearch_tpu/script/painless_lite.py. Kept as the reference
has them: the parser (`_normalize`: `return`, ternaries, Java booleans),
the node whitelist, `_validate_access`, `compile_script` with its error
messages, the ternary-to-`where` rewrite, and the grammar: literals,
`+ - * / %` and `**`, unary minus, comparisons, ternaries, `_score`,
`params.NAME` / `params['NAME']`, `doc['field'].value` / `.empty`,
`Math.log/log10/sqrt/abs/exp/pow/min/max/floor/ceil` and `Math.E/PI`,
`sigmoid(x)` and `saturation(x, k)`, and the x-pack vector functions
`cosineSimilarity(params.qv, 'field')`, `dotProduct(...)` and
`l2norm(...)` over a dense_vector field. Those lower to the per-doc
planes of K7's script mode (ops/kernels.vector_script_batch: the dot,
|v| and |v - q| of each doc, and |q|) with the reference's formulas:
cosine = where(denom > 0, dot / denom, 0) with denom = |v| * |q|, the raw
dot, and the distance |v - q| (not a similarity). The query vector must
be a params reference and the field a string literal.

Evaluation walks the tree once (`lower`) instead of handing it to
Python's `eval`: every operation is an explicit call on a `Backend`,
so the same walk drives `CompiledScript.evaluate` (torch ops, the plain
version) and the Triton generator of ops/script_kernel.py (K6), and the
two agree op for op. The walk's rules:

- pure-constant subtrees fold in float64 (as the reference's `eval`
  folds Python literals) and round once to fp32 where they meet a
  per-doc value; constants reach the backend as fp32 scalars on the
  values' device, never as Python numbers, because a CUDA tensor divided
  by a CPU scalar multiplies by its reciprocal instead;
- values are fp32 or bool; a bool meets arithmetic as 0.0 / 1.0, an
  fp32 condition selects where it is non-zero (NaN included), and the
  result is fp32 (`doc[...].empty` or a comparison as 0.0 / 1.0);
- `%` is the remainder with the divisor's sign (torch.remainder,
  jnp.remainder);
- a NaN result takes the reference's bits (jnp under jit on XLA:CPU),
  composed from selects: arithmetic, `Math.sqrt` and `Math.pow` / `**`
  return their first NaN operand, else x86's default -NaN (and +NaN for
  the literal exponent 0.5); `Math.min`/`max` are IEEE minimum / maximum
  returning a NaN operand; every NaN of `Math.log`/`log10` is
  0xffffffff;
- `Math.pow` and `**` compute in float64 and round once to fp32: torch's
  fp32 CUDA pow agrees with neither libdevice's powf nor a float64 pow
  (bit for bit) on the H100, while the float64 route is the same
  function in torch and in Triton (within the 4 ulps the tests hold
  script values to).

A construct the walk cannot type (arithmetic or negation on booleans
alone, `and`/`or` or a chained comparison over per-doc values, a string
or a bare `doc[...]` as a value, a non-scalar param) raises ValueError,
a 400, on both paths alike.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.kernels import flip_sign

_ALLOWED_NODES = (
    ast.Expression,
    ast.BinOp,
    ast.UnaryOp,
    ast.Add,
    ast.Sub,
    ast.Mult,
    ast.Div,
    ast.Mod,
    ast.Pow,
    ast.USub,
    ast.UAdd,
    ast.Call,
    ast.Attribute,
    ast.Subscript,
    ast.Name,
    ast.Constant,
    ast.IfExp,
    ast.Compare,
    ast.Gt,
    ast.GtE,
    ast.Lt,
    ast.LtE,
    ast.Eq,
    ast.NotEq,
    ast.BoolOp,
    ast.And,
    ast.Or,
    ast.Load,
)

_ALLOWED_NAMES = frozenset(
    {
        "_score",
        "params",
        "doc",
        "Math",
        "sigmoid",
        "saturation",
        "where",
        "True",
        "False",
        "cosineSimilarity",
        "dotProduct",
        "l2norm",
    }
)

# The reference's vector functions (x-pack ScoreScriptUtils).
_VECTOR_FUNCTIONS = frozenset({"cosineSimilarity", "dotProduct", "l2norm"})

# `a ? b : c` → `(b) if (a) else (c)`; applied repeatedly for nesting.
_TERNARY_RE = re.compile(r"([^?]+)\?([^:]+):(.+)")


def _normalize(source: str) -> str:
    src = source.strip().rstrip(";")
    # Painless allows `return expr;` for score scripts.
    if src.startswith("return "):
        src = src[len("return ") :].rstrip(";")
    while "?" in src:
        m = _TERNARY_RE.fullmatch(src)
        if not m:
            break
        cond, then, other = m.groups()
        src = f"(({then.strip()}) if ({cond.strip()}) else ({other.strip()}))"
    # Java booleans / null.
    src = re.sub(r"\btrue\b", "True", src)
    src = re.sub(r"\bfalse\b", "False", src)
    return src


_MATH_MEMBERS = frozenset(
    {
        "log", "log10", "sqrt", "abs", "exp", "floor", "ceil",
        "pow", "min", "max", "E", "PI",
    }
)
_MATH_CONSTANTS = {"E": 2.718281828459045, "PI": 3.141592653589793}
_DOC_VALUE_MEMBERS = frozenset({"value", "empty"})


def _validate_access(tree: ast.Expression, source: str) -> None:
    """Whitelist attribute/subscript access shapes: the only legal
    attribute accesses are Math.<member>, params.<name> and
    doc['field'].value/.empty, and the only legal subscripts are
    doc['field'] / params['name'] with string-constant keys."""

    def fail(why: str) -> None:
        raise ValueError(f"cannot compile script [{source}]: {why}")

    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            attr, base = node.attr, node.value
            if attr.startswith("_"):
                fail(f"illegal attribute access [{attr}]")
            if isinstance(base, ast.Name):
                if base.id == "Math":
                    if attr not in _MATH_MEMBERS:
                        fail(f"unknown Math member [{attr}]")
                elif base.id == "params":
                    pass  # params.NAME: any non-underscore name
                else:
                    fail(f"illegal attribute access [{base.id}.{attr}]")
            elif isinstance(base, ast.Subscript):
                sub_base = base.value
                if not (
                    isinstance(sub_base, ast.Name) and sub_base.id == "doc"
                ):
                    fail(f"illegal attribute access [.{attr}]")
                if attr not in _DOC_VALUE_MEMBERS:
                    fail(f"unknown doc-values member [{attr}]")
            else:
                fail(f"illegal attribute access [.{attr}]")
        elif isinstance(node, ast.Subscript):
            base = node.value
            if not (
                isinstance(base, ast.Name) and base.id in ("doc", "params")
            ):
                fail("subscript access is only legal on doc[...] / params[...]")
            key = node.slice
            if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
                fail("doc/params subscript keys must be string literals")
            if key.value.startswith("_"):
                fail(f"illegal subscript key [{key.value}]")


def compile_script(source: str) -> "CompiledScript":
    """Parse + validate a painless-lite expression (raises ValueError)."""
    normalized = _normalize(source)
    try:
        tree = ast.parse(normalized, mode="eval")
    except SyntaxError as e:
        raise ValueError(
            f"cannot compile script [{source}]: painless-lite supports "
            f"expressions only ({e.msg})"
        ) from None
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"cannot compile script [{source}]: disallowed construct "
                f"[{type(node).__name__}]"
            )
        if isinstance(node, ast.Name) and node.id not in _ALLOWED_NAMES:
            raise ValueError(
                f"cannot compile script [{source}]: unknown identifier "
                f"[{node.id}]"
            )
    _validate_access(tree, source)
    # Ternaries become vectorized selects (`where`).
    tree = ast.fix_missing_locations(_TernaryToWhere().visit(tree))
    return CompiledScript(source=source, normalized=normalized, _tree=tree)


class _TernaryToWhere(ast.NodeTransformer):
    def visit_IfExp(self, node: ast.IfExp) -> ast.AST:
        self.generic_visit(node)
        return ast.Call(
            func=ast.Name(id="where", ctx=ast.Load()),
            args=[node.test, node.body, node.orelse],
            keywords=[],
        )


# ---------------------------------------------------------------------------
# The typed walk
# ---------------------------------------------------------------------------

CONST, F32, BOOL = "const", "f32", "bool"

# NaNs of XLA:CPU: x86's default NaN, which an operation on non-NaN
# operands makes, and the one its log and log10 return for a NaN or
# negative operand.
_DEFAULT_NAN = float(np.uint32(0xFFC00000).view(np.float32))
_LOG_NAN = float(np.uint32(0xFFFFFFFF).view(np.float32))


@dataclass(frozen=True)
class Value:
    """A node's value: a folded Python constant (`CONST`, a float or a
    bool), or a backend value of kind `F32` or `BOOL` (a tensor for the
    torch backend, an expression name for the Triton generator)."""

    kind: str
    v: Any


class Backend:
    """The operations the walk asks for; every tensor operand is a
    backend value, every constant an fp32 scalar made by `scalar`."""

    def score(self): ...
    def column(self, field: str): ...
    def param(self, name: str): ...
    def scalar(self, c: float): ...
    def binary(self, op: str, a, b): ...  # add sub mul div mod
    def neg(self, a): ...
    def math(self, fn: str, args: list): ...  # log ... ceil, pow
    def compare(self, op: str, a, b): ...  # gt ge lt le eq ne
    def where(self, c, a, b): ...
    def isnan(self, a): ...
    def signbit(self, a): ...
    def logical_and(self, a, b): ...
    def logical_or(self, a, b): ...
    def logical_not(self, a): ...
    def to_f32(self, a): ...
    def vector(self, part: str, name: str, field: str): ...  # dot norm dist qnorm


_BINOPS = {
    ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul", ast.Div: "div",
    ast.Mod: "mod", ast.Pow: "pow",
}
_CMPOPS = {
    ast.Gt: "gt", ast.GtE: "ge", ast.Lt: "lt", ast.LtE: "le",
    ast.Eq: "eq", ast.NotEq: "ne",
}
_UNARY_MATH = ("log", "log10", "sqrt", "abs", "exp", "floor", "ceil")


def _fold_binary(op: str, a: float, b: float) -> float:
    x, y = np.float64(a), np.float64(b)
    with np.errstate(all="ignore"):
        return float({
            "add": np.add, "sub": np.subtract, "mul": np.multiply,
            "div": np.true_divide, "mod": np.remainder, "pow": np.power,
        }[op](x, y))


def _fold_math(fn: str, args: list[float]) -> float:
    xs = [np.float64(a) for a in args]
    with np.errstate(all="ignore"):
        if fn == "pow":
            return float(np.power(*xs))
        if fn in ("min", "max"):
            return float((np.minimum if fn == "min" else np.maximum)(*xs))
        return float(getattr(np, fn)(xs[0]))


def _fold_compare(op: str, a, b) -> bool:
    return bool({
        "gt": a > b, "ge": a >= b, "lt": a < b, "le": a <= b,
        "eq": a == b, "ne": a != b,
    }[op])


class _Lowering:
    def __init__(self, backend: Backend, source: str):
        self.be = backend
        self.source = source

    def fail(self, why: str):
        raise ValueError(f"cannot evaluate script [{self.source}]: {why}")

    # -- conversions -----------------------------------------------------

    def f32(self, x: Value):
        """x as an fp32 backend value (bools as 0.0 / 1.0)."""
        if x.kind == CONST:
            return self.be.scalar(float(x.v))
        if x.kind == BOOL:
            return self.be.to_f32(x.v)
        return x.v

    def cond(self, x: Value):
        """x as a bool backend value (fp32: non-zero selects)."""
        if x.kind == BOOL:
            return x.v
        return self.be.compare("ne", self.f32(x), self.be.scalar(0.0))

    # -- nodes -----------------------------------------------------------

    def visit(self, node) -> Value:
        if isinstance(node, ast.Expression):
            return self.visit(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return Value(CONST, node.value)
            if isinstance(node.value, (int, float)):
                return Value(CONST, float(node.value))
            self.fail(f"a [{type(node.value).__name__}] literal is not a value")
        if isinstance(node, ast.Name):
            if node.id == "_score":
                return Value(F32, self.be.score())
            if node.id in ("True", "False"):
                return Value(CONST, node.id == "True")
            self.fail(f"[{node.id}] is not a value")
        if isinstance(node, ast.Attribute):
            return self.visit_attribute(node)
        if isinstance(node, ast.Subscript):
            if node.value.id == "params":
                return Value(F32, self.be.param(node.slice.value))
            self.fail("doc[...] needs .value or .empty")
        if isinstance(node, ast.Call):
            return self.visit_call(node)
        if isinstance(node, ast.BinOp):
            return self.binary(
                _BINOPS[type(node.op)], self.visit(node.left),
                self.visit(node.right),
            )
        if isinstance(node, ast.UnaryOp):
            x = self.visit(node.operand)
            return x if isinstance(node.op, ast.UAdd) else self.negate(x)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                # Python chains `a < b < c` with `and`, which has no
                # per-doc form.
                vals = [self.visit(node.left)] + [
                    self.visit(c) for c in node.comparators
                ]
                if any(v.kind != CONST for v in vals):
                    self.fail("a chained comparison over per-doc values")
                return Value(CONST, all(
                    _fold_compare(_CMPOPS[type(op)], a.v, b.v)
                    for op, a, b in zip(node.ops, vals, vals[1:])
                ))
            return self.compare(
                _CMPOPS[type(node.ops[0])], self.visit(node.left),
                self.visit(node.comparators[0]),
            )
        if isinstance(node, ast.BoolOp):
            vals = [self.visit(v) for v in node.values]
            if any(v.kind != CONST for v in vals):
                self.fail("[and]/[or] over per-doc values")
            out = vals[0].v
            for v in vals[1:]:
                out = (out and v.v) if isinstance(node.op, ast.And) else (
                    out or v.v)
            return Value(CONST, out)
        self.fail(f"[{type(node).__name__}] is not a value")

    def visit_attribute(self, node: ast.Attribute) -> Value:
        base = node.value
        if isinstance(base, ast.Name) and base.id == "Math":
            if node.attr in _MATH_CONSTANTS:
                return Value(CONST, _MATH_CONSTANTS[node.attr])
            self.fail(f"Math.{node.attr} is a function")
        if isinstance(base, ast.Name) and base.id == "params":
            return Value(F32, self.be.param(node.attr))
        field = base.slice.value  # doc['field'] (validated at compile)
        col = self.be.column(field)
        if node.attr == "value":
            return Value(F32, col)
        return Value(BOOL, self.be.isnan(col))  # .empty: NaN = missing

    def visit_call(self, node: ast.Call) -> Value:
        if node.keywords:
            self.fail("keyword arguments")
        func = node.func
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "Math"):
            name = func.attr
            if name in _MATH_CONSTANTS:
                self.fail(f"Math.{name} is not a function")
        elif isinstance(func, ast.Name) and func.id in (
            "sigmoid", "saturation", "where",
        ):
            name = func.id
        elif isinstance(func, ast.Name) and func.id in _VECTOR_FUNCTIONS:
            return self.vector_call(func.id, node.args)
        else:
            self.fail("only Math functions, sigmoid, saturation and where "
                      "are callable")
        arity = {"pow": 2, "min": 2, "max": 2, "saturation": 2, "where": 3}
        n = arity.get(name, 1)
        if len(node.args) != n:
            self.fail(f"[{name}] takes {n} argument(s), got {len(node.args)}")
        args = [self.visit(a) for a in node.args]
        if name == "sigmoid":  # 1.0 / (1.0 + exp(-x)), as the reference
            e = self.math("exp", [self.negate(args[0])])
            return self.binary(
                "div", Value(CONST, 1.0),
                self.binary("add", Value(CONST, 1.0), e),
            )
        if name == "saturation":  # x / (x + k)
            x, k = args
            return self.binary("div", x, self.binary("add", x, k))
        if name == "where":
            return self.where(*args)
        return self.math(name, args)

    def vector_call(self, name: str, args: list) -> Value:
        """cosineSimilarity / dotProduct / l2norm over K7's planes."""
        param, field = _vector_args(name, args, self.fail)
        if name == "dotProduct":
            return Value(F32, self.be.vector("dot", param, field))
        if name == "l2norm":
            return Value(F32, self.be.vector("dist", param, field))
        dot = self.be.vector("dot", param, field)
        denom = self.be.binary(
            "mul", self.be.vector("norm", param, field),
            self.be.vector("qnorm", param, field),
        )
        return Value(F32, self.be.where(
            self.be.compare("gt", denom, self.be.scalar(0.0)),
            self.be.binary("div", dot, denom), self.be.scalar(0.0),
        ))

    # -- typed operations --------------------------------------------------

    def negate(self, x: Value) -> Value:
        if x.kind == CONST:
            return Value(CONST, -float(x.v))
        if x.kind == BOOL:
            self.fail("unary minus on a boolean")
        return Value(F32, self.be.neg(x.v))

    def binary(self, op: str, a: Value, b: Value) -> Value:
        if a.kind == CONST and b.kind == CONST:
            return Value(CONST, _fold_binary(op, float(a.v), float(b.v)))
        if a.kind == BOOL and b.kind == BOOL:
            self.fail("arithmetic on two booleans")
        xs = [self.f32(a), self.f32(b)]
        if op == "pow":
            return Value(F32, self.pow([a, b], xs))
        return Value(F32, propagate(self.be, self.be.binary(op, *xs), *xs))

    def math(self, fn: str, args: list[Value]) -> Value:
        if all(a.kind == CONST for a in args):
            return Value(CONST, _fold_math(fn, [float(a.v) for a in args]))
        xs = [self.f32(a) for a in args]
        if fn in ("min", "max"):
            return Value(F32, self.extremum(fn, *xs))
        if fn == "pow":
            return Value(F32, self.pow(args, xs))
        r = self.be.math(fn, xs)
        if fn in ("sqrt", "exp", "floor", "ceil"):
            # a NaN operand passes as it is; sqrt of a negative gives -NaN
            return Value(F32, propagate(self.be, r, xs[0]))
        if fn in ("log", "log10"):  # every NaN result is XLA's 0xffffffff
            return Value(F32, self.be.where(
                self.be.isnan(r), self.be.scalar(_LOG_NAN), r))
        return Value(F32, r)

    # The NaN rules below are the reference's: jnp under jit on XLA:CPU,
    # measured op by op (tests/test_torch_script.py). torch's CPU kernels
    # (which differ between their vectorized and scalar paths), libdevice
    # and the card's canonical NaN each give other signs and payloads, so
    # the walk composes every rule from selects, on both paths.

    def extremum(self, fn: str, a, b):
        """Math.min / Math.max: IEEE 754-2019 minimum / maximum (-0.0 <
        +0.0) returning a NaN operand; of two NaNs, max returns the first
        if it is negative and min the first if it is positive, else the
        second."""
        be = self.be
        nan_a, nan_b = be.isnan(a), be.isnan(b)
        if fn == "max":
            b_wins_nan = be.logical_not(be.signbit(a))
            a_first = be.logical_or(
                be.compare("gt", a, b),
                be.logical_and(be.compare("eq", a, b), be.signbit(b)),
            )
        else:
            b_wins_nan = be.signbit(a)
            a_first = be.logical_or(
                be.compare("lt", a, b),
                be.logical_and(be.compare("eq", a, b), be.signbit(a)),
            )
        return be.where(
            nan_a, be.where(be.logical_and(nan_b, b_wins_nan), b, a),
            be.where(nan_b, b, be.where(a_first, a, b)),
        )

    def pow(self, args: list[Value], xs):
        """Math.pow and `**`, in float64 rounded once; a NaN result is
        +NaN for the literal exponent 0.5 (XLA rewrites that power), else
        as `propagate` gives it, except that a NaN base under a per-doc
        odd integer exponent loses its sign (XLA takes the odd power of
        |x|, then the sign of x)."""
        be = self.be
        a, b = xs
        r = be.math("pow", xs)
        if args[1].kind == CONST:
            if float(args[1].v) == 0.5:
                return be.where(be.isnan(r), be.scalar(np.nan), r)
            return propagate(be, r, a, b)
        odd = be.compare("eq", be.binary("mod", b, be.scalar(2.0)),
                         be.scalar(1.0))
        base = be.where(odd, be.math("abs", [a]), a)
        return propagate(be, r, base, b)

    def compare(self, op: str, a: Value, b: Value) -> Value:
        if a.kind == CONST and b.kind == CONST:
            return Value(CONST, _fold_compare(op, a.v, b.v))
        return Value(BOOL, self.be.compare(op, self.f32(a), self.f32(b)))

    def where(self, c: Value, a: Value, b: Value) -> Value:
        if c.kind == CONST:
            return a if c.v else b
        if a.kind == BOOL and b.kind == BOOL:
            return Value(BOOL, self.be.where(self.cond(c), a.v, b.v))
        return Value(F32, self.be.where(self.cond(c), self.f32(a), self.f32(b)))


def propagate(be: Backend, r, *xs):
    """r, with a NaN result replaced by the first NaN operand, or by x86's
    default NaN (-NaN) where the operation made it: XLA:CPU's rule for
    arithmetic, sqrt, exp, floor, ceil and pow."""
    nan = be.scalar(_DEFAULT_NAN)
    for x in reversed(xs):
        nan = be.where(be.isnan(x), x, nan)
    return be.where(be.isnan(r), nan, r)


def boosted(be: Backend, r, boost):
    """The script's result times the query's boost, under the same rule
    (`_eval_script`'s `result * boost`)."""
    return propagate(be, be.binary("mul", r, boost), r, boost)


def lower(script: "CompiledScript", backend: Backend):
    """Walk the script once over `backend`; returns its result as an fp32
    backend value (a folded constant becomes `backend.scalar(c)`)."""
    low = _Lowering(backend, script.source)
    return low.f32(low.visit(script._tree))


def _param_ref(node) -> str | None:
    """NAME of `params.NAME` / `params['NAME']`, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return node.attr if node.value.id == "params" else None
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        return node.slice.value if node.value.id == "params" else None
    return None


def _vector_args(name: str, args: list, fail) -> tuple[str, str]:
    """(param, field) of a vector call `name(params.qv, 'field')`."""
    if len(args) != 2:
        fail(f"[{name}] takes 2 argument(s), got {len(args)}")
    param = _param_ref(args[0])
    if param is None:
        fail(f"[{name}] takes its query vector as a params reference")
    field = args[1]
    if not (isinstance(field, ast.Constant) and isinstance(field.value, str)):
        fail(f"[{name}] takes its field as a string literal")
    return param, field.value


def _is_vector_call(node) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _VECTOR_FUNCTIONS)


def referenced_vectors(script: "CompiledScript") -> list[tuple[str, str]]:
    """The (param, field) pairs of the script's vector calls, in the order
    the walk first meets them; a malformed call raises ValueError."""
    pairs: list[tuple[str, str]] = []

    def fail(why: str):
        raise ValueError(f"cannot evaluate script [{script.source}]: {why}")

    def visit(node) -> None:
        if _is_vector_call(node):
            pairs.append(_vector_args(node.func.id, node.args, fail))
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(script._tree)
    return list(dict.fromkeys(pairs))


def referenced(script: "CompiledScript") -> tuple[list[str], list[str]]:
    """(doc-values fields, params) the script reads as values, each in the
    order the walk first meets it (left to right, depth first); the query
    vectors of vector calls are not among them (referenced_vectors)."""
    fields: list[str] = []
    params: list[str] = []

    def visit(node) -> None:
        if _is_vector_call(node):
            return
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ) and node.value.id == "params":
            params.append(node.attr)
        elif isinstance(node, ast.Subscript):
            (params if node.value.id == "params" else fields).append(
                node.slice.value
            )
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(script._tree)
    return list(dict.fromkeys(fields)), list(dict.fromkeys(params))


# ---------------------------------------------------------------------------
# The torch backend: the plain evaluation
# ---------------------------------------------------------------------------


def _pow64(a, b):
    return torch.pow(a.double(), b.double()).float()


def _clear_sign(a):
    """|a| as a sign-bit clear, which keeps a NaN's payload on every
    device (the card's arithmetic may return its canonical NaN)."""
    return a.view(torch.int32).bitwise_and(0x7FFFFFFF).view(torch.float32)


_TORCH_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "mod": torch.remainder,
}
_TORCH_COMPARE = {
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne,
}
_TORCH_MATH = {
    "log": torch.log, "log10": torch.log10, "sqrt": torch.sqrt,
    "abs": _clear_sign, "exp": torch.exp, "floor": torch.floor,
    "ceil": torch.ceil, "pow": _pow64,
}


def _param_value(params: dict, name: str):
    try:
        return params[name]
    except KeyError:
        raise ValueError(f"script params has no entry [{name}]") from None


def _doc_column(columns: dict, field: str):
    if field not in columns:
        raise ValueError(
            f"No field found for [{field}] in mapping (script doc access)"
        )
    return columns[field]


class TorchBackend(Backend):
    """Evaluates with torch ops on the values' device. `params` values
    are fp32 tensors that broadcast against the columns (0-d for one
    query, [Q, 1] for Q rows); `vectors` maps each (param, field) vector
    call to K7's script-mode planes (dot, |v|, |v - q|) f32[Q, N] and |q|
    f32[Q]."""

    def __init__(self, score, columns: dict, params: dict, device,
                 vectors: dict | None = None):
        self._score = score
        self.columns = columns
        self.params = params
        self.device = torch.device(device)
        self.vectors = vectors or {}

    def vector(self, part, name, field):
        planes = self.vectors.get((name, field))
        if planes is None:
            raise ValueError(f"no dense_vector field [{field}]")
        dot, norm, dist, qnorm = planes
        if part == "qnorm":
            return qnorm.reshape(-1, 1)
        return {"dot": dot, "norm": norm, "dist": dist}[part]

    def score(self):
        return self._score

    def column(self, field):
        return _doc_column(self.columns, field)

    def param(self, name):
        return _param_value(self.params, name)

    def scalar(self, c):
        return torch.full((), float(np.float32(c)), dtype=torch.float32,
                          device=self.device)

    def binary(self, op, a, b):
        return _TORCH_BINARY[op](a, b)

    def neg(self, a):
        return flip_sign(a)  # a sign-bit flip: keeps a NaN's payload

    def math(self, fn, args):
        return _TORCH_MATH[fn](*args)

    def compare(self, op, a, b):
        return _TORCH_COMPARE[op](a, b)

    def where(self, c, a, b):
        return torch.where(c, a, b)

    def isnan(self, a):
        return torch.isnan(a)

    def signbit(self, a):
        return torch.signbit(a)

    def logical_and(self, a, b):
        return torch.logical_and(a, b)

    def logical_or(self, a, b):
        return torch.logical_or(a, b)

    def logical_not(self, a):
        return torch.logical_not(a)

    def to_f32(self, a):
        return a.to(torch.float32)


@dataclass(frozen=True)
class CompiledScript:
    """A validated, reusable score expression."""

    source: str
    normalized: str
    _tree: ast.Expression

    def evaluate(self, score, doc_columns: dict, params: dict,
                 vectors: dict | None = None) -> torch.Tensor:
        """Evaluate over all docs at once with torch ops on `score`'s
        device: `score` is the tensor bound to `_score`, `doc_columns` maps
        fields to fp32 columns (NaN = missing), `params` names to fp32
        tensors that broadcast against them, `vectors` the vector calls'
        planes (TorchBackend). Returns an fp32 tensor that broadcasts to
        the docs (a folded constant is 0-d)."""
        return lower(self, TorchBackend(score, doc_columns, params,
                                        score.device, vectors))
