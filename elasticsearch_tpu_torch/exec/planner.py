"""Cost-based backend planner for the query phase.

Port copy of elasticsearch_tpu/exec/planner.py, trimmed to
`ast_signature` (the micro-batcher's group key), `spec_work_tiles` (the
coalescing work proxy) and `ExecPlanner` (`classify`, `decide`,
`record`, `note`, `decisions`, `stats`) over the backends the port has:
`device`, `blockmax`, `blockmax_conj`, `device_batched`, `cached_mask`
(the device kernels over a plan whose filter clauses read filter-cache
planes, index/filter_cache.py: the solo path prices and counts such a
plan under it) and `ann_ivf` (the knn section's IVF probe, decided
against the exact `device` kernels only inside the knn section;
script_score kNN never routes to it). The decision counters are a plain
dict (the reference keeps them on its metrics registry, which is not
ported). Left out: `oracle_eligible` and the `oracle`, `mesh_spmd` and
`packed` backends, which wait for their modules.

The structured kinds (nested, function_score, terms_set, geo, rank_feature,
dismax, boosting, doc_set) are dense-only specs: each spec is its own plan
class, and `device` is their one candidate.

Per (shard, query) the planner picks which backend runs the scoring
pass: `device` (the sparse/dense kernels, always eligible) or a
two-launch tile-pruned path (`blockmax` for a terms spec,
`blockmax_conj` for a must-driven conjunction), which is eligible only
when the request does not track exact totals, since its totals are lower
bounds. Routing never changes the top-k: every eligible backend returns
the same ids in the same order with the same fp32 scores. Decisions are
exploration then exploitation per plan class: each eligible backend is
tried MIN_OBS times, cheapest seed first, then the least EWMA wins.
"""

from __future__ import annotations

import threading

from ..query.dsl import (
    BoolQuery,
    ConstantScoreQuery,
    MatchQuery,
    Query,
    TermsQuery,
)
from .cost import CostModel, PlanFeatures

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


class ExecPlanner:
    """Backend decisions + counters for one node's query executions."""

    MIN_OBS = 2  # explorations per (class, backend) before exploiting
    BACKENDS = (
        "device", "blockmax", "blockmax_conj", "device_batched",
        # The device kernels over a filter-cache-substituted plan: cached
        # clauses cost one plane read instead of their worklists, so its
        # features carry the reduced work_tiles.
        "cached_mask",
        "ann_ivf",
    )

    def __init__(self, cost_model: CostModel | None = None):
        self.cost = cost_model or CostModel()
        self._lock = threading.Lock()
        self._decisions: dict[str, int] = {b: 0 for b in self.BACKENDS}

    @staticmethod
    def classify(spec: tuple, k: int) -> tuple:
        """Plan class: the compiled spec (same spec = same program = same
        cost curve) plus the requested k."""
        return (spec, k)

    def decide(
        self,
        plan_class: tuple,
        candidates: list[str],
        feats: PlanFeatures | None = None,
    ) -> str:
        """Pick a backend among `candidates` (each must uphold the result
        invariant for this request; eligibility is the caller's job).

        Unexplored backends (fewer than MIN_OBS observations) are tried
        first, cheapest seed first; once every candidate is calibrated the
        least estimate wins."""
        if len(candidates) == 1:
            return candidates[0]
        unexplored = [
            b
            for b in candidates
            if self.cost.observations(plan_class, b) < self.MIN_OBS
        ]
        pool = unexplored or candidates
        return min(
            pool, key=lambda b: self.cost.predicted_ms(plan_class, b, feats)
        )

    def record(self, plan_class: tuple, backend: str, seconds: float) -> None:
        """Count one executed decision and feed its latency to the EWMA."""
        self.cost.observe(plan_class, backend, seconds)
        self.note(backend)

    def note(self, backend: str) -> None:
        """Count a decision with no latency sample."""
        with self._lock:
            self._decisions[backend] = self._decisions.get(backend, 0) + 1

    @property
    def decisions(self) -> dict[str, int]:
        """Decision counts by backend."""
        with self._lock:
            return dict(self._decisions)

    def stats(self) -> dict:
        """Decision counters + the EWMA table (the reference's
        `_nodes/stats` payload)."""
        return {"decisions": self.decisions, "ewma": self.cost.snapshot()}
