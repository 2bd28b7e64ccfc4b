"""K14 tail_eval: a Triton kernel generated per structured plan node, and
its plain PyTorch version.

Replaces the elementwise tails of elasticsearch_tpu/ops/bm25_device.py
`_eval_node`: `_eval_function_score` (:367, the math of
query/functions.py), the geo branches (:120-140, with `_haversine_m`
:322), rank_feature (:141), boosting (:178), the gate of `_eval_terms_set`
(:232) and dismax (:208). Their children (K1 terms, K11 / K12 phrases,
K13 joins, ...) run first; K14 reads their [Q, N] score and matched
planes, the doc-values columns and per-row parameters, and writes the
node's score and matched planes in one pass.

Bound on an H100: bytes. Per doc and row the pass reads the planes
(4 B each), the matched masks (1 B each) and the columns (4 B each) it
uses, and writes the score (4 B) and matched (1 B) planes. Its
transcendentals (sin, cos, atan2, exp, log, pow) cost a few hundred
operations per doc at most; the bound by operations is taken where it is
the larger (chip_smoke.py computes both).

Design: every node kind's math is written once, in `_BODIES`, against
`TailXP`, a numpy-like facade whose values (`Sym`) are those of one of two
backends: `TorchTail` runs torch ops (the plain version: the CPU tests and
the card's checks), `TritonTail` emits one Triton statement per operation
(the kernel). function_score's math is query/functions.py itself, whole,
with xp = the facade; a script function, and terms_set's script, lower
through K6's painless-lite walk on the same backend, their vector calls
reading K7's script-mode planes as node inputs (`vector_tag`). The
generated kernel is one elementwise pass: a block of 1,024 docs per
program, a row per grid column. As for K6, every operation is the one torch's CUDA kernel
computes, so the two versions are bit-equal on the card: no mul+add
contraction (enable_fp_fusion=False), IEEE division and square root
(div_rn, sqrt_rn), libdevice's sinf / cosf / atan2f / expf / logf /
log10f / log1pf, pow in float64 rounded once; and every NaN a result can
carry is composed from selects with the reference's rules (the first NaN
operand of an arithmetic operation, else x86's default -NaN; log's
0xffffffff; IEEE maximum / minimum), so the card's canonical NaN never
reaches a score; exp flushes a subnormal result to +0.0, as XLA's CPU exp
does. The source is written under `_build/triton/`, keyed by
a hash of the node's static key, and imported from there.

Stacked mode (K14s; under the vmap of `execute_shards` /
`execute_shards_batch`, elasticsearch_tpu/ops/bm25_device.py
:1155-1168): the columns are S shards' [S, N] planes and row r, the pair
(query r // S, shard r % S), reads shard r % S's through a row stride in
the kernel (a generated kernel of its own, keyed with the node); the
planes, masks and params are the rows' own.

`LAUNCHES["tail_eval_<kind>"]` (ops/kernels) counts every launch,
whatever its row count, and `tail_eval_<kind>_stacked` every stacked one.
For CPU tensors `tail_eval` runs the plain version; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import threading

import numpy as np
import torch

from ..query.functions import combine_function_score, eval_function
from ..script import compile_script
from ..script.painless_lite import (
    _LOG_NAN,
    TorchBackend,
    _Lowering,
    lower,
    propagate,
    referenced,
)
from . import kernels, script_kernel

BLOCK = 1024
GENERATOR_VERSION = "k14-2"
TRITON_DIR = kernels.BUILD_ROOT / "triton"
F32, BOOL, U32 = "f32", "bool", "u32"
_U32_MASK = 0xFFFFFFFF
_FLT_MIN_NORMAL = float(np.finfo(np.float32).tiny)

_lock = threading.Lock()
_generated: dict[tuple, tuple] = {}


# ---------------------------------------------------------------------------
# The two backends
# ---------------------------------------------------------------------------


class TorchTail(TorchBackend):
    """Torch ops over the node's inputs: planes and masks [Q, N], columns
    [N] (or [S, N] over S stacked shards, repeated to the rows), params
    [Q] (seen as [Q, 1]); uint32 values ride int64 tensors."""

    def __init__(self, planes, masks, columns, params, n, device, q=1,
                 n_shards=0):
        super().__init__(None, columns, {}, device)
        self.planes, self.masks, self.tparams, self.n = planes, masks, params, n
        self.q, self.n_shards = q, n_shards

    def plane(self, name):
        return self.planes[name]

    def mask(self, name):
        return self.masks[name]

    def column(self, name):
        col = self.columns[name]
        return col.repeat(self.q // self.n_shards, 1) if self.n_shards else col

    def param(self, name):
        return self.tparams[name].reshape(-1, 1)

    def param_u32(self, name):
        bits = self.param(name).view(torch.int32).to(torch.int64)
        return bits & _U32_MASK

    def math(self, fn, args):
        if fn == "sqrt":
            # Correctly rounded on every device (torch's vectorized CPU
            # sqrt is not): the square root in float64, rounded once.
            return torch.sqrt(args[0].double()).float()
        if fn in ("sin", "cos", "log1p"):
            return getattr(torch, fn)(args[0])
        if fn == "atan2":
            return torch.atan2(*args)
        return super().math(fn, args)

    def bool_const(self, v):
        return torch.full((), bool(v), dtype=torch.bool, device=self.device)

    def doc_index(self):
        return torch.arange(self.n, dtype=torch.int64, device=self.device)

    def u32_const(self, c):
        return torch.full((), int(c) & _U32_MASK, dtype=torch.int64,
                          device=self.device)

    def u32_op(self, op, a, b):
        if op == "add":
            return (a + b) & _U32_MASK
        if op == "mul":  # (a * b) mod 2**32 without an int64 overflow
            lo = a * (b & 0xFFFF)
            hi = ((a * (b >> 16)) & 0xFFFF) << 16
            return (lo + hi) & _U32_MASK
        if op == "xor":
            return a ^ b
        return a >> b  # shr

    def u32_to_f32(self, a):
        return a.to(torch.float32)


class TritonTail(script_kernel.TritonBackend):
    """Emits one Triton statement per operation; records the inputs in
    first-use order (the kernel's arguments)."""

    def __init__(self):
        super().__init__([], [])
        self.plane_names: list[str] = []
        self.mask_names: list[str] = []
        self.column_names: list[str] = []

    @staticmethod
    def _slot(names: list[str], name: str) -> int:
        if name not in names:
            names.append(name)
        return names.index(name)

    def plane(self, name):
        j = self._slot(self.plane_names, name)
        return self._load(f"plane:{name}",
                          f"tl.load(p{j}_ptr + base + offs, mask=mask, other=0.0)")

    def mask(self, name):
        j = self._slot(self.mask_names, name)
        return self._load(
            f"mask:{name}",
            f"tl.load(m{j}_ptr + base + offs, mask=mask, other=0) != 0",
        )

    def column(self, name):
        j = self._slot(self.column_names, name)
        return self._load(f"col:{name}",
                          f"tl.load(c{j}_ptr + cbase + offs, mask=mask, other=0.0)")

    def param(self, name):
        j = self._slot(self.names, name)
        return self._load(f"param:{name}", f"tl.load(params_ptr + prow + {j})")

    def param_u32(self, name):
        return self.emit(f"{self.param(name)}.to(tl.uint32, bitcast=True)")

    def math(self, fn, args):
        if fn == "atan2":
            return self.emit(f"libdevice.atan2({args[0]}, {args[1]})")
        return super().math(fn, args)  # sin, cos, log1p: libdevice's

    def bool_const(self, v):
        return self.emit("offs >= 0" if v else "offs < 0")

    def doc_index(self):
        return self.emit("offs.to(tl.uint32)")

    def u32_const(self, c):
        return self.emit(f"tl.full([BLOCK], {int(c) & _U32_MASK}, tl.uint32)")

    def u32_op(self, op, a, b):
        sym = {"add": "+", "mul": "*", "xor": "^", "shr": ">>"}[op]
        return self.emit(f"{a} {sym} {b}")

    def u32_to_f32(self, a):
        return self.emit(f"{a}.to(tl.float32)")


def vector_tag(prefix: str, name: str, field: str) -> str:
    """The prefix of the node inputs that carry a script's vector call
    (params.<name>, '<field>'): the planes `<tag>dot`, `<tag>norm` and
    `<tag>dist` (K7's script mode, f32[Q, N]) and the param `<tag>qnorm`."""
    return f"{prefix}v.{name}.{field}."


def script_value_params(source: str, given) -> list[str]:
    """The params of `given` that the script reads as numbers (the query
    vectors of its vector calls are read through their planes)."""
    _fields, names = referenced(compile_script(source))
    return [name for name in given if name in names]


class _ScriptScope:
    """A backend seen by a script: `_score`, `params.<name>` and the
    vector calls' planes, bound to the node's values (the inputs named
    with `prefix`, see `vector_tag`); everything else is the node's
    backend."""

    def __init__(self, be, score, params, prefix=""):
        self._be, self._score, self._params = be, score, params
        self._prefix = prefix

    def __getattr__(self, name):
        return getattr(self._be, name)

    def score(self):
        return self._score

    def param(self, name):
        if name not in self._params:
            raise ValueError(f"script params has no entry [{name}]")
        return self._params[name]

    def vector(self, part, name, field):
        tag = vector_tag(self._prefix, name, field)
        if part == "qnorm":
            return self._be.param(tag + "qnorm")
        return self._be.plane(tag + part)


# ---------------------------------------------------------------------------
# The numpy-like facade
# ---------------------------------------------------------------------------


class Sym:
    """A backend value with its kind (f32, bool or u32) and numpy's
    operators."""

    __array_ufunc__ = None  # numpy scalars defer to the reflected operators
    __hash__ = None

    def __init__(self, xp: "TailXP", v, kind: str):
        self.xp, self.v, self.kind = xp, v, kind

    @property
    def shape(self):
        return (self.xp.n,)

    def astype(self, dtype):
        return self.xp.asarray(self, dtype)

    def _bin(self, op, other, swap=False):
        other = self.xp.lift(other, self.kind)
        a, b = (other, self) if swap else (self, other)
        if self.kind == U32:
            return Sym(self.xp, self.xp.be.u32_op(op, a.v, b.v), U32)
        return self.xp.arith(op, a, b)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, True)

    def __pow__(self, p):
        if p != 2:
            raise ValueError("only the square (x ** 2) is an integer power")
        return self * self

    def __xor__(self, o):
        return self._bin("xor", o)

    def __rshift__(self, o):
        return self._bin("shr", o)

    def _cmp(self, op, o):
        o = self.xp.lift(o, F32)
        return Sym(self.xp, self.xp.be.compare(op, self.v, o.v), BOOL)

    def __gt__(self, o):
        return self._cmp("gt", o)

    def __ge__(self, o):
        return self._cmp("ge", o)

    def __lt__(self, o):
        return self._cmp("lt", o)

    def __le__(self, o):
        return self._cmp("le", o)

    def __eq__(self, o):
        return self._cmp("eq", o)

    def __ne__(self, o):
        return self._cmp("ne", o)

    def __and__(self, o):
        o = self.xp.lift(o, BOOL)
        return Sym(self.xp, self.xp.be.logical_and(self.v, o.v), BOOL)

    def __or__(self, o):
        o = self.xp.lift(o, BOOL)
        return Sym(self.xp, self.xp.be.logical_or(self.v, o.v), BOOL)

    def __invert__(self):
        return Sym(self.xp, self.xp.be.logical_not(self.v), BOOL)


class _DType:
    """xp.float32 / xp.uint32: a dtype token that also makes a constant."""

    def __init__(self, xp: "TailXP", kind: str):
        self.xp, self.kind = xp, kind

    def __call__(self, c):
        return self.xp.lift(c, self.kind)


class TailXP:
    """The subset of numpy that query/functions.py and `_BODIES` use, over
    a backend. Arithmetic, sqrt, exp, sin, cos and atan2 return their
    first NaN operand, else x86's default NaN; log, log10 and log1p return
    0xffffffff for any NaN; exp flushes a subnormal result to +0.0;
    maximum / minimum are IEEE maximum / minimum (XLA's max and min on
    the CPU)."""

    def __init__(self, be, n: int):
        self.be, self.n = be, n
        self.float32 = _DType(self, F32)
        self.uint32 = _DType(self, U32)

    # inputs
    def plane(self, name):
        return Sym(self, self.be.plane(name), F32)

    def mask(self, name):
        return Sym(self, self.be.mask(name), BOOL)

    def column(self, name):
        return Sym(self, self.be.column(name), F32)

    def param(self, name):
        return Sym(self, self.be.param(name), F32)

    def param_u32(self, name):
        return Sym(self, self.be.param_u32(name), U32)

    # constants and conversions
    def lift(self, x, kind: str) -> Sym:
        if isinstance(x, Sym):
            return x
        if isinstance(x, (bool, np.bool_)) or kind == BOOL:
            return Sym(self, self.be.bool_const(bool(x)), BOOL)
        if kind == U32:
            return Sym(self, self.be.u32_const(int(x)), U32)
        return Sym(self, self.be.scalar(float(np.float32(x))), F32)

    def _kind(self, dtype) -> str:
        if dtype is bool or dtype is np.bool_:
            return BOOL
        return dtype.kind

    def asarray(self, x, dtype=None):
        if dtype is None:
            return self.lift(x, F32)
        kind = self._kind(dtype)
        x = self.lift(x, kind)
        if x.kind == kind:
            return x
        if kind != F32:
            raise ValueError(f"cannot cast {x.kind} to {kind}")
        if x.kind == U32:
            return Sym(self, self.be.u32_to_f32(x.v), F32)
        return Sym(self, self.be.to_f32(x.v), F32)

    def full(self, _n, value, dtype=None):
        return self.lift(value, self._kind(dtype) if dtype is not None else F32)

    def zeros(self, _n, dtype=None):
        kind = self._kind(dtype) if dtype is not None else F32
        return self.lift(False if kind == BOOL else 0.0, kind)

    def arange(self, _n, dtype=None):
        return Sym(self, self.be.doc_index(), U32)

    def broadcast_to(self, x, _shape):
        return self.lift(x, F32)

    # elementwise
    def arith(self, op, a: Sym, b: Sym) -> Sym:
        r = self.be.binary(op, a.v, b.v)
        return Sym(self, propagate(self.be, r, a.v, b.v), F32)

    def where(self, c, a, b):
        c = self.lift(c, BOOL)
        kind = a.kind if isinstance(a, Sym) else (
            b.kind if isinstance(b, Sym) else F32)
        a, b = self.lift(a, kind), self.lift(b, kind)
        return Sym(self, self.be.where(c.v, a.v, b.v), kind)

    def isnan(self, x):
        return Sym(self, self.be.isnan(self.lift(x, F32).v), BOOL)

    def _math(self, fn, *xs):
        vs = [self.lift(x, F32).v for x in xs]
        r = self.be.math(fn, vs)
        if fn in ("log", "log10", "log1p"):
            r = self.be.where(self.be.isnan(r), self.be.scalar(_LOG_NAN), r)
        else:
            r = propagate(self.be, r, *vs)
        if fn == "exp":
            # XLA's CPU exp flushes a subnormal result to +0.0.
            r = self.be.where(
                self.be.compare("lt", r, self.be.scalar(_FLT_MIN_NORMAL)),
                self.be.scalar(0.0), r)
        return Sym(self, r, F32)

    def log(self, x):
        return self._math("log", x)

    def log10(self, x):
        return self._math("log10", x)

    def log1p(self, x):
        return self._math("log1p", x)

    def sqrt(self, x):
        return self._math("sqrt", x)

    def exp(self, x):
        return self._math("exp", x)

    def sin(self, x):
        return self._math("sin", x)

    def cos(self, x):
        return self._math("cos", x)

    def arctan2(self, a, b):
        return self._math("atan2", a, b)

    def power(self, a, b):
        """float64 pow rounded once (K6's rule)."""
        return self._math("pow", a, b)

    def abs(self, x):
        return Sym(self, self.be.math("abs", [self.lift(x, F32).v]), F32)

    def _extremum(self, fn, a, b):
        a, b = self.lift(a, F32), self.lift(b, F32)
        return Sym(self, _Lowering(self.be, "").extremum(fn, a.v, b.v), F32)

    def maximum(self, a, b):
        return self._extremum("max", a, b)

    def minimum(self, a, b):
        return self._extremum("min", a, b)

    def script(self, source: str, score, params: dict, prefix: str = ""):
        """A painless-lite script over this backend (K6's walk): `_score`
        is `score`, `params.<name>` the node's per-row params, a vector
        call the node's K7 planes under `prefix` (`vector_tag`)."""
        scope = _ScriptScope(self.be, self.lift(score, F32).v,
                             {k: self.lift(v, F32).v for k, v in params.items()},
                             prefix)
        return Sym(self, lower(compile_script(source), scope), F32)


class _LazyParams(dict):
    """A function's farrays: each value a param of the node, loaded on
    first access (so the kernel reads only what the math uses)."""

    def __init__(self, xp: TailXP, prefix: str):
        super().__init__()
        self.xp, self.prefix = xp, prefix

    def __missing__(self, key):
        if key == "seed":
            val = self.xp.param_u32(self.prefix + key)
        else:
            val = self.xp.param(self.prefix + key)
        self[key] = val
        return val


# ---------------------------------------------------------------------------
# The node kinds: each body returns (scores, matched) Syms
# ---------------------------------------------------------------------------


def haversine_m(xp, lat, lon, qlat, qlon):
    """Great-circle distance in meters, the reference's `_haversine_m`
    term for term."""
    rad = 0.017453292519943295
    phi1 = lat * rad
    phi2 = qlat * rad
    dphi = (qlat - lat) * rad
    dlmb = (qlon - lon) * rad
    a = (
        xp.sin(dphi / 2) ** 2
        + xp.cos(phi1) * xp.cos(phi2) * xp.sin(dlmb / 2) ** 2
    )
    return 6371008.7714 * 2 * xp.arctan2(xp.sqrt(a), xp.sqrt(1 - a))


def _geo_distance(xp, key):
    lat, lon = xp.column("lat"), xp.column("lon")
    d = haversine_m(xp, lat, lon, xp.param("lat"), xp.param("lon"))
    matched = ~xp.isnan(lat) & (d <= xp.param("radius_m"))
    return xp.where(matched, xp.param("boost"), 0.0), matched


def _geo_box(xp, key):
    lat, lon = xp.column("lat"), xp.column("lon")
    top, left = xp.param("top"), xp.param("left")
    bottom, right = xp.param("bottom"), xp.param("right")
    in_lat = (lat <= top) & (lat >= bottom)
    # Antimeridian-crossing boxes: left > right wraps.
    wraps = left > right
    in_lon_plain = (lon >= left) & (lon <= right)
    in_lon_wrap = (lon >= left) | (lon <= right)
    in_lon = xp.where(wraps, in_lon_wrap, in_lon_plain)
    matched = ~xp.isnan(lat) & in_lat & in_lon
    return xp.where(matched, xp.param("boost"), 0.0), matched


def _rank_feature(xp, key):
    fn = key[1]
    col = xp.column("col")
    matched = ~xp.isnan(col)
    v = xp.where(matched, col, 0.0)
    if fn == "saturation":
        s = v / (v + xp.param("pivot"))
    elif fn == "log":
        s = xp.log(xp.param("scaling") + v)
    else:  # sigmoid
        exponent = xp.param("exponent")
        ve = xp.power(v, exponent)
        s = ve / (ve + xp.power(xp.param("pivot"), exponent))
    return xp.where(matched, xp.param("boost") * s, 0.0), matched


def _dismax(xp, key):
    best = xp.float32(0.0)
    total = xp.float32(0.0)
    matched = xp.zeros(xp.n, dtype=bool)
    for i in range(key[1]):
        m = xp.mask(f"m{i}")
        s = xp.where(m, xp.plane(f"s{i}"), 0.0)
        best = xp.maximum(best, s)
        total = total + s
        matched = matched | m
    scores = best + xp.param("tie") * (total - best)
    return xp.where(matched, scores * xp.param("boost"), 0.0), matched


def _boosting(xp, key):
    ps, pm, nm = xp.plane("positive"), xp.mask("positive"), xp.mask("negative")
    factor = xp.where(nm, xp.param("negative_boost"), 1.0)
    return xp.where(pm, ps * factor * xp.param("boost"), 0.0), pm


def _terms_set(xp, key):
    _, n_counts, msm_kind, msm_ref = key
    s = xp.plane("scored")
    count = xp.float32(0.0)
    for i in range(n_counts):
        count = count + xp.mask(f"m{i}").astype(xp.float32)
    if msm_kind == "field":
        required = xp.column("required")
    else:
        source, names = msm_ref
        required = xp.script(
            source, xp.float32(0.0),
            {name: xp.param("p." + name)
             for name in script_value_params(source, names)})
    required = xp.maximum(required, xp.float32(1.0))  # NaN propagates
    matched = count >= required  # a NaN requirement compares False
    return xp.where(matched, s * xp.param("boost"), 0.0), matched


def _function_score(xp, key):
    _, fspecs, has_filter, score_mode, boost_mode, has_min = key
    child = xp.plane("child")
    matched = xp.mask("child")
    values, applies, weights = [], [], []
    for i, fspec in enumerate(fspecs):
        farrays = _LazyParams(xp, f"f{i}.")
        if fspec[0] == "script":
            farrays["params"] = {
                name: xp.param(f"f{i}.p.{name}")
                for name in script_value_params(fspec[1], fspec[2])
            }
        values.append(eval_function(
            xp, fspec, farrays, num_docs=xp.n,
            column=lambda name: xp.column(name),
            child_scores=child, doc_values=None, vectors=f"f{i}.",
        ))
        applies.append(matched & xp.mask(f"f{i}") if has_filter[i] else matched)
        weights.append(farrays["weight"])
    return combine_function_score(
        xp, child_scores=child, matched=matched, values=values,
        applies=applies, weights=weights, score_mode=score_mode,
        boost_mode=boost_mode, max_boost=xp.param("max_boost"),
        boost=xp.param("boost"),
        min_score=xp.param("min_score") if has_min else None,
    )


_BODIES = {
    "function_score": _function_score,
    "geo_distance": _geo_distance,
    "geo_box": _geo_box,
    "rank_feature": _rank_feature,
    "dismax": _dismax,
    "boosting": _boosting,
    "terms_set": _terms_set,
}


# ---------------------------------------------------------------------------
# The plain version and the kernel
# ---------------------------------------------------------------------------


def _check_inputs(key, q: int, n: int, planes, masks, columns, params,
                  n_shards: int = 0):
    if not isinstance(key, tuple) or not key or key[0] not in _BODIES:
        raise ValueError(f"unknown tail node key {key!r}")
    if not 1 <= q <= kernels.MAX_GRID_ROWS:
        raise ValueError(f"row count {q} out of range [1, {kernels.MAX_GRID_ROWS}]")
    if n_shards and q % n_shards:
        raise ValueError(f"{q} rows are not whole (query, shard) pairs")
    dev = None
    col_shape = (n_shards, n) if n_shards else (n,)
    for group, dtype, shape in ((planes, torch.float32, (q, n)),
                                (masks, torch.bool, (q, n)),
                                (columns, torch.float32, col_shape),
                                (params, torch.float32, (q,))):
        for name, t in group.items():
            dev = dev or t.device
            kernels._check(t, name, dtype, len(shape), dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"tail input [{name}] must be {shape}")
    return dev


def tail_eval_plain(key, q: int, n: int, planes, masks, columns, params,
                    n_shards: int = 0):
    """K14's plain version: the node's body over torch ops. Returns
    (scores f32[Q, N], matched bool[Q, N])."""
    dev = _check_inputs(key, q, n, planes, masks, columns, params, n_shards)
    dev = dev or torch.device("cpu")
    xp = TailXP(TorchTail(planes, masks, columns, params, n, dev, q,
                          n_shards), n)
    scores, matched = _BODIES[key[0]](xp, key)
    return (
        torch.broadcast_to(scores.v, (q, n)).contiguous(),
        torch.broadcast_to(matched.v, (q, n)).contiguous(),
    )


_TEMPLATE = '''\
# Generated by elasticsearch_tpu_torch/ops/tail_kernel.py for the node
#   {key}
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def tail_eval_kernel(
    out_ptr, out_matched_ptr,{args}
    params_ptr, consts_ptr, n, n_params, n_shards,
    BLOCK: tl.constexpr,
):
    row = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    base = row.to(tl.int64) * n
    cbase = {cbase}
    prow = row * n_params
{body}
    sc = tl.where(mask, {scores}, {scores})
    mt = tl.where(mask, {matched}, {matched})
    tl.store(out_ptr + base + offs, sc, mask=mask)
    tl.store(out_matched_ptr + base + offs, mt.to(tl.uint8), mask=mask)
'''


def generate_source(key, stacked: bool = False
                    ) -> tuple[str, list[float], TritonTail]:
    """(kernel module source, fp32 constants in kernel order, the backend
    with the inputs' order) for a node key; `stacked`: row r reads the
    columns' row r % n_shards ([S, N] columns)."""
    be = TritonTail()
    xp = TailXP(be, 0)
    scores, matched = _BODIES[key[0]](xp, key)
    args = "".join(
        [f"\n    p{j}_ptr," for j in range(len(be.plane_names))]
        + [f"\n    m{j}_ptr," for j in range(len(be.mask_names))]
        + [f"\n    c{j}_ptr," for j in range(len(be.column_names))]
    )
    body = "\n".join(f"    {line}" for line in be.lines)
    cbase = "(row % n_shards).to(tl.int64) * n" if stacked else "0"
    src = _TEMPLATE.format(key=repr(key).replace("\n", " "), args=args,
                           cbase=cbase, body=body, scores=scores.v,
                           matched=matched.v)
    return src, be.consts, be


def _kernel_for(key, device: torch.device, stacked: bool = False):
    digest = hashlib.sha256(
        (GENERATOR_VERSION + "\0" + repr((key, stacked))).encode()
    ).hexdigest()[:16]
    with _lock:
        hit = _generated.get((digest, device))
        if hit is not None:
            return hit
        os.environ.setdefault(
            "TRITON_CACHE_DIR", str(kernels.BUILD_ROOT / "triton_cache")
        )
        src, consts, be = generate_source(key, stacked)
        TRITON_DIR.mkdir(parents=True, exist_ok=True)
        path = TRITON_DIR / f"tail_{digest}.py"
        if not path.exists() or path.read_text() != src:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(src)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(f"_esk_tail_{digest}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        hit = (
            mod.tail_eval_kernel,
            torch.tensor(consts or [0.0], dtype=torch.float32, device=device),
            (list(be.plane_names), list(be.mask_names),
             list(be.column_names), list(be.names)),
        )
        _generated[(digest, device)] = hit
        return hit


def _take(group: dict, names: list[str], what: str):
    missing = [name for name in names if name not in group]
    if missing:
        raise ValueError(f"tail node needs {what} {missing}")
    return [group[name] for name in names]


def tail_eval(key, q: int, n: int, planes: dict, masks: dict, columns: dict,
              params: dict, n_shards: int = 0):
    """K14: one structured node's tail over Q rows.

    key: the node's static key (its kind first); planes name -> f32[Q, N],
    masks name -> bool[Q, N], columns name -> f32[N] (NaN = missing), or
    f32[S, N] over S = n_shards > 0 stacked shards (row r, the pair
    (query r // S, shard r % S), reads row r % S), params name -> f32[Q]
    (a random_score seed as its uint32 bits seen as f32). The body reads
    the names it needs. Returns (scores f32[Q, N], matched bool[Q, N])."""
    dev = _check_inputs(key, q, n, planes, masks, columns, params, n_shards)
    if dev is None or not kernels._launchable(dev):
        return tail_eval_plain(key, q, n, planes, masks, columns, params,
                               n_shards)
    kernel, const_t, (pn, mn, cn, prn) = _kernel_for(key, dev, bool(n_shards))
    p_t = _take(planes, pn, "planes")
    m_t = [m.view(torch.uint8) for m in _take(masks, mn, "masks")]
    c_t = _take(columns, cn, "columns")
    prm = _take(params, prn, "params")
    params_t = (torch.stack(prm, dim=1).contiguous() if prm
                else torch.zeros((q, 1), dtype=torch.float32, device=dev))
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    out_matched = torch.empty((q, n), dtype=torch.bool, device=dev)
    grid = (max(1, -(-n // BLOCK)), q)
    with torch.cuda.device(dev):
        kernel[grid](
            out, out_matched.view(torch.uint8), *p_t, *m_t, *c_t,
            params_t, const_t, n, params_t.shape[1], max(1, n_shards),
            BLOCK=BLOCK, num_warps=4, enable_fp_fusion=False,
        )
    kernels.count_launch("tail_eval_" + key[0], n_shards)
    return out, out_matched


def seed_bits(seed: torch.Tensor) -> torch.Tensor:
    """A uint32 random_score seed [Q] as its bits seen as f32 (a param)."""
    s = seed.to(torch.int64) & _U32_MASK
    s = torch.where(s >= 2**31, s - 2**32, s)
    return s.to(torch.int32).view(torch.float32)
