"""function_score math, shared by K14's plain version and its generator.

Port copy of elasticsearch_tpu/query/functions.py, whole: `lower_function`,
`_fvf_modify`, `eval_function` and `combine_function_score`, with two
changes. `xp` is not numpy or jax.numpy here but the array facade of
ops/tail_kernel.py (`TailXP`) over one of its two backends: torch ops
(K14's plain version) or the Triton generator (K14), so one body of math
serves both and the two are bit-equal by construction. And a script
function lowers through that facade (`xp.script`, K6's painless-lite walk)
instead of `CompiledScript.evaluate(xp, ...)`; its `vectors` is the prefix
under which the node's inputs carry the script's K7 vector planes
(`tail_kernel.vector_tag`), not the segment's vectors.

The reference computes score functions in
`common/lucene/search/function/` (FieldValueFactorFunction, ScriptScore
Function, RandomScoreFunction, the decay family in
`index/query/functionscore/DecayFunctionBuilder`) and combines them in
`FunctionScoreQuery` via ScoreMode + CombineFunction. Keeping the math
here in array-library-agnostic form (`xp` = numpy or jax.numpy, all f32)
guaranteed the compiled XLA program and the reference's parity oracle
round identically.

Per-function lowering produces a hashable static `fspec`:
    (kind, target, modifier, has_column, has_weight, has_filter)
      kind: weight | fvf | script | random | gauss | exp | linear
      target: doc-values field (fvf/decay), script source (script), None
      modifier: fvf modifier string, or sorted param-name tuple (script)
and an `farrays` dict of f32 scalars (weight, factor, missing, seed,
derived decay constants — precomputed HOST-side in f64 then rounded once
to f32 so both paths use bit-identical constants).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np

from .dsl import ScoreFunction

FLT_MAX = np.float32(3.4028235e38)


def lower_function(
    fs: ScoreFunction, has_column: Callable[[str], bool]
) -> tuple[tuple, dict[str, Any]]:
    """(fspec, farrays) for one function; the filter is lowered by the
    caller (it is a full query node)."""
    has_weight = fs.weight is not None
    weight = np.float32(fs.weight if has_weight else 1.0)
    has_filter = fs.filter is not None
    if fs.kind == "weight":
        return (
            ("weight", None, None, False, has_weight, has_filter),
            {"weight": weight},
        )
    if fs.kind == "field_value_factor":
        return (
            (
                "fvf",
                fs.field,
                fs.modifier,
                bool(has_column(fs.field)),
                has_weight,
                has_filter,
            ),
            {
                "weight": weight,
                "factor": np.float32(fs.factor),
                "missing": np.float32(
                    fs.missing if fs.missing is not None else 1.0
                ),
            },
        )
    if fs.kind == "script_score":
        from ..script import compile_script

        compile_script(fs.source)  # plan-time validation (parse errors 400)
        return (
            (
                "script",
                fs.source,
                tuple(sorted(fs.params)),
                False,
                has_weight,
                has_filter,
            ),
            {
                "weight": weight,
                "params": {
                    name: np.asarray(fs.params[name], dtype=np.float32)
                    for name in sorted(fs.params)
                },
            },
        )
    if fs.kind == "random_score":
        return (
            ("random", None, None, False, has_weight, has_filter),
            {"weight": weight, "seed": np.uint32(fs.seed & 0xFFFFFFFF)},
        )
    # Decay family. Derived constants in f64 once, rounded to f32 once.
    if fs.scale <= 0:
        raise ValueError(f"[{fs.kind}] requires a positive [scale]")
    if not (0.0 < fs.decay < 1.0):
        raise ValueError(f"[{fs.kind}] requires 0 < decay < 1")
    if fs.kind == "gauss":
        const = math.log(fs.decay) / (fs.scale * fs.scale)
    elif fs.kind == "exp":
        const = math.log(fs.decay) / fs.scale
    else:  # linear
        const = fs.scale / (1.0 - fs.decay)
    return (
        (
            fs.kind,
            fs.field,
            None,
            bool(has_column(fs.field)),
            has_weight,
            has_filter,
        ),
        {
            "weight": weight,
            "origin": np.float32(fs.origin),
            "offset": np.float32(fs.offset),
            "const": np.float32(const),
        },
    )


def _fvf_modify(xp, value, modifier: str):
    one = xp.float32(1.0)
    if modifier == "none":
        return value
    if modifier == "log":
        return xp.log10(value)
    if modifier == "log1p":
        return xp.log10(value + one)
    if modifier == "log2p":
        return xp.log10(value + xp.float32(2.0))
    if modifier == "ln":
        return xp.log(value)
    if modifier == "ln1p":
        return xp.log1p(value)
    if modifier == "ln2p":
        return xp.log(value + xp.float32(2.0))
    if modifier == "square":
        return value * value
    if modifier == "sqrt":
        return xp.sqrt(value)
    if modifier == "reciprocal":
        return one / value
    raise ValueError(f"unknown field_value_factor modifier [{modifier}]")


def eval_function(
    xp,
    fspec: tuple,
    farrays: dict[str, Any],
    *,
    num_docs: int,
    column: Callable[[str], Any],  # field -> f32[N] (NaN missing) | None
    child_scores,
    doc_values,
    vectors,
):
    """Raw (un-weighted) f32[N] value of one function."""
    kind, target, modifier, has_column, _hw, _hf = fspec
    one = xp.float32(1.0)
    if kind == "weight":
        return xp.full(num_docs, one, dtype=xp.float32)
    if kind == "fvf":
        col = column(target) if has_column else None
        if col is None:
            v = xp.full(num_docs, farrays["missing"], dtype=xp.float32)
        else:
            v = xp.where(xp.isnan(col), farrays["missing"], col)
        return xp.asarray(
            _fvf_modify(xp, farrays["factor"] * v, modifier),
            dtype=xp.float32,
        )
    if kind == "script":
        result = xp.script(target, child_scores, farrays["params"], vectors)
        return xp.broadcast_to(
            xp.asarray(result, dtype=xp.float32), (num_docs,)
        )
    if kind == "random":
        # xxhash-ish integer mix over the doc index — deterministic per
        # (seed, doc). The reference hashes (_seq_no, _id, seed); values
        # differ but the distribution contract (uniform [0, 1)) matches.
        x = (
            xp.arange(num_docs, dtype=xp.uint32) + farrays["seed"]
        ) * xp.uint32(2654435761)
        x = x ^ (x >> 16)
        x = x * xp.uint32(2246822519)
        x = x ^ (x >> 13)
        return (x >> xp.uint32(8)).astype(xp.float32) * xp.float32(
            1.0 / (1 << 24)
        )
    # Decay family over a numeric doc-values column; missing value -> 1.
    col = column(target) if has_column else None
    if col is None:
        return xp.full(num_docs, one, dtype=xp.float32)
    d = xp.maximum(
        xp.float32(0.0),
        xp.abs(col - farrays["origin"]) - farrays["offset"],
    )
    if kind == "gauss":
        value = xp.exp(farrays["const"] * d * d)
    elif kind == "exp":
        value = xp.exp(farrays["const"] * d)
    else:  # linear: max(0, (s - d) / s)
        s = farrays["const"]
        value = xp.maximum(xp.float32(0.0), (s - d) / s)
    return xp.where(xp.isnan(col), one, value).astype(xp.float32)


def combine_function_score(
    xp,
    *,
    child_scores,
    matched,
    values: list,  # per-function raw f32[N]
    applies: list,  # per-function bool[N] (filter ∧ matched)
    weights: list,  # per-function f32 scalar
    score_mode: str,
    boost_mode: str,
    max_boost,
    boost,
    min_score=None,
):
    """(scores f32[N], matched bool[N]) — the FunctionScoreQuery combine.

    Docs where NO function applies keep the neutral factor 1 (the
    reference's behavior for fully-filtered-out docs)."""
    num_docs = child_scores.shape[0]
    one = xp.float32(1.0)
    zero = xp.float32(0.0)
    if values:
        any_applies = applies[0]
        for a in applies[1:]:
            any_applies = any_applies | a
        wvalues = [w * v for w, v in zip(weights, values)]
        if score_mode == "multiply":
            factor = xp.full(num_docs, one, dtype=xp.float32)
            for a, wv in zip(applies, wvalues):
                factor = factor * xp.where(a, wv, one)
        elif score_mode == "sum":
            total = xp.zeros(num_docs, dtype=xp.float32)
            for a, wv in zip(applies, wvalues):
                total = total + xp.where(a, wv, zero)
            factor = xp.where(any_applies, total, one)
        elif score_mode == "avg":
            total = xp.zeros(num_docs, dtype=xp.float32)
            wsum = xp.zeros(num_docs, dtype=xp.float32)
            for a, wv, w in zip(applies, wvalues, weights):
                total = total + xp.where(a, wv, zero)
                wsum = wsum + xp.where(a, w, zero)
            # Safe denominator: numpy evaluates both where() branches.
            denom = xp.where(wsum != zero, wsum, one)
            factor = xp.where(wsum != zero, total / denom, one)
        elif score_mode == "first":
            factor = xp.full(num_docs, one, dtype=xp.float32)
            assigned = xp.zeros(num_docs, dtype=bool)
            for a, wv in zip(applies, wvalues):
                take = a & ~assigned
                factor = xp.where(take, wv, factor)
                assigned = assigned | a
        elif score_mode in ("max", "min"):
            sentinel = xp.float32(-np.inf if score_mode == "max" else np.inf)
            best = xp.full(num_docs, sentinel, dtype=xp.float32)
            op = xp.maximum if score_mode == "max" else xp.minimum
            for a, wv in zip(applies, wvalues):
                best = op(best, xp.where(a, wv, sentinel))
            factor = xp.where(any_applies, best, one)
        else:
            raise ValueError(f"illegal score_mode [{score_mode}]")
    else:
        factor = xp.full(num_docs, one, dtype=xp.float32)
    factor = xp.minimum(factor, max_boost)
    q = child_scores
    if boost_mode == "multiply":
        scores = q * factor
    elif boost_mode == "replace":
        scores = factor
    elif boost_mode == "sum":
        scores = q + factor
    elif boost_mode == "avg":
        scores = (q + factor) / xp.float32(2.0)
    elif boost_mode == "max":
        scores = xp.maximum(q, factor)
    elif boost_mode == "min":
        scores = xp.minimum(q, factor)
    else:
        raise ValueError(f"illegal boost_mode [{boost_mode}]")
    scores = xp.where(matched, scores * boost, zero).astype(xp.float32)
    if min_score is not None:
        matched = matched & (scores >= min_score)
        scores = xp.where(matched, scores, zero)
    return scores, matched
