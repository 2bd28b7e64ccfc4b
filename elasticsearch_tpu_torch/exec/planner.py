"""Plan-shape helpers of the execution planner.

Port copy of elasticsearch_tpu/exec/planner.py, trimmed to `ast_signature`
(the micro-batcher's group key) and `spec_work_tiles` (the coalescing
work proxy). Left out: `ExecPlanner`, its backends and decision counters,
and `oracle_eligible` — the port routes every group to the device.
"""

from __future__ import annotations

from ..query.dsl import (
    BoolQuery,
    ConstantScoreQuery,
    MatchQuery,
    Query,
    TermsQuery,
)

_TERMS_KINDS = ("terms", "terms_gather", "terms_const")


def ast_signature(query: Query) -> tuple:
    """Shape signature of a query AST — queries with equal signatures
    compile to stackable (same-family) specs, so the micro-batcher groups
    on it. Texts/values are deliberately excluded; only structure, fields
    and clause-count buckets remain."""
    if isinstance(query, BoolQuery):
        return (
            "bool",
            tuple(ast_signature(c) for c in query.must),
            tuple(ast_signature(c) for c in query.should),
            tuple(ast_signature(c) for c in query.filter),
            tuple(ast_signature(c) for c in query.must_not),
            query.minimum_should_match,
        )
    if isinstance(query, ConstantScoreQuery):
        return ("constant_score", ast_signature(query.filter))
    if isinstance(query, MatchQuery):
        n_terms = max(1, len(query.query.split()))
        bucket = 1 << (n_terms - 1).bit_length()
        return ("match", query.field_name, bucket, query.operator)
    if isinstance(query, TermsQuery):
        bucket = 1 << (max(1, len(query.values)) - 1).bit_length()
        return ("terms", query.field_name, bucket)
    for attr in ("field_name",):
        if hasattr(query, attr):
            return (type(query).__name__, getattr(query, attr))
    return (type(query).__name__,)


def spec_work_tiles(spec: tuple, floor: int = 0) -> int:
    """Total worklist tiles a compiled spec gathers (the sparse-path work
    proxy; 0 for dense-only shapes, whose cost scales with the corpus).
    `floor` raises every node's bucket to at least that value."""
    if not isinstance(spec, tuple) or not spec:
        return 0
    if spec[0] in _TERMS_KINDS:
        return max(int(spec[2]), floor)
    if spec[0] == "bool":
        total = 0
        for group in spec[1:5]:
            for child in group:
                total += spec_work_tiles(child, floor)
        return total
    return 0
