"""Shard-level search: query phase over device segments + fetch.

Port of elasticsearch_tpu/search/service.py, trimmed to this slice:
`SearchRequest.from_json` for `query`, `from`, `size`, `track_total_hits`,
`_source`, `sort` (with `missing`), `rescore` and `search_after`, with
the reference's validations and messages; `Rescore` with `combine`;
`normalized_sort`, `sort_merge_key` and `_validate_sort`;
`SearchService.search` as the loop over segments with the candidate
merge and the `_source` fetch, hits carrying their `sort` values;
`_query_segment` with its score-sorted branch (compile, `execute_auto`,
collect), its `{"_score": "asc"}`, cursor, field-sort and missing-column
branches and the rescore stages (`_apply_rescore`), and
`_query_segment_multisort`; and the batched
query phase the micro-batcher drives — `search_many`, `assemble_plain`,
`_batched_query_phase` (with the reference's `_execute_group` inlined),
`_merge_term_groups` (with `sparse_family_key`), `_device_batch` and
`_append_plain`: N plain requests cost one padded launch per (segment,
spec group) instead of N. Left out with the reference's padding
instrument: `family_padding_tiles`. The solo loop asks the node's exec
planner (`_decide_backend`) which backend scores each segment: the
device kernels, or, when the request does not track exact totals, the
two-launch block-max paths (`blockmax` for a terms spec,
`blockmax_conj` for a must-driven conjunction), recording each
execution's time; it is not consulted for a request with rescore, as in
the reference. The top-level `knn` section (`KnnSpec`, with
`KNN_EXCLUSIVE`) is served by `_validate_knn`, `_knn_filter_mask`
(the filter's plane, from the filter cache once admitted), `_knn_plan`
(the node's AnnCache and the planner's `ann_ivf` / `device` decision),
`_query_segment_knn` (IVF probe
+ exact re-rank where the segment has partition planes, brute force
otherwise; ops/ann_device) and, for the micro-batcher's knn groups,
`_knn_search_many`, with the reference's messages and its global top-k
reduce. `aggs` / `aggregations` (search/aggs.py) run one Aggregator pass
over the same pinned segment snapshot as the hits pass, which a
`size: 0` request skips (its totals then come from the agg pass, as
the reference's do). Positional queries (match_phrase,
match_phrase_prefix, the span family and intervals) need no branch of
their own: their plans are dense-only `_eval_node` specs, so they run
through `_query_segment` and the batched query phase (K11 / K12 into
the score plane, then K3), aggregations, rescore, sorts and cursors as
any other dense plan does; so do the structured queries (multi_match,
dis_max, ids, boosting, rank_feature, geo_distance, geo_bounding_box,
terms_set, function_score and nested: K13 / K14 after their children),
a nested query's child compiling against the segment's nested block.
The node's filter cache (index/filter_cache.py, `filter_cache=`):
`_collect_filter_entries` records one admission sighting per user
request (a coordinator passes `record_filter_usage=False` and its own
entries), and `_apply_filter_cache` substitutes each segment's cached
planes, keyed (engine uid, 0, handle uid, filter key), into the plan
before it runs, on the solo path (every branch: score-sorted, sorted,
cursors, rescore; a masked plan is priced and counted as the planner's
`cached_mask` backend) and on the batched path (batchmates whose planes
are the same objects share one launch and one seg["masks"]: the group
key's mask token). Left out: CPU-oracle routing (and with it any
planner decision on the batched path), tasks and timeouts, scroll,
highlight, fields, profile and the other body keys of the reference; a
request asking for one of those is refused with a 400.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..exec.cost import PlanFeatures
from ..exec.planner import spec_work_tiles
from ..index.ann import default_nprobe
from ..index.engine import Engine, SegmentHandle
from ..ops import ann_device, bm25_device
from ..query.compile import CompiledQuery, FieldStats
from ..query.dsl import MatchAllQuery, Query, parse_query


def sparse_family_key(spec) -> tuple | None:
    """Coalescing family of a compiled terms spec: same kind/field/
    trailing shape, differing only in the nt bucket (spec[2]). Groups in
    one family re-bucket to a common nt and share ONE padded launch
    (_merge_term_groups); None for non-coalescible specs."""
    if (
        isinstance(spec, tuple)
        and spec
        and spec[0] in ("terms", "terms_gather")
        and len(spec) == 4
    ):
        return (spec[0], spec[1], spec[3])
    return None


@dataclass
class SearchHit:
    doc_id: str
    score: float | None
    source: dict[str, Any] | None
    sort: list[Any] | None = None
    global_doc: int = -1

    def to_json(self, index_name: str = "index") -> dict[str, Any]:
        out: dict[str, Any] = {
            "_index": index_name,
            "_id": self.doc_id,
            "_score": self.score,
        }
        if self.source is not None:
            out["_source"] = self.source
        if self.sort is not None:
            out["sort"] = self.sort
        return out


@dataclass
class SearchResponse:
    took_ms: int
    total: int | None  # None = untracked (track_total_hits: false)
    total_relation: str
    max_score: float | None
    hits: list[SearchHit]
    aggregations: dict[str, Any] | None = None
    shards: int = 1
    timed_out: bool = False
    skipped: int = 0  # can_match pre-filtered shards
    failed: int = 0  # shards whose scoring pass raised

    def to_json(self, index_name: str = "index") -> dict[str, Any]:
        hits_obj: dict[str, Any] = {
            "max_score": self.max_score,
            "hits": [h.to_json(index_name) for h in self.hits],
        }
        if self.total is not None:
            hits_obj = {
                "total": {"value": self.total, "relation": self.total_relation},
                **hits_obj,
            }
        out = {
            "took": self.took_ms,
            "timed_out": self.timed_out,
            "_shards": {
                "total": self.shards,
                # successful + skipped + failed == total
                "successful": max(0, self.shards - self.skipped - self.failed),
                "skipped": self.skipped,
                "failed": self.failed,
            },
            "hits": hits_obj,
        }
        if self.aggregations is not None:
            out["aggregations"] = self.aggregations
        return out


def clamp_total(total: int, track_total_hits) -> tuple[int | None, str]:
    """(reported total, relation) under the track_total_hits contract."""
    if track_total_hits is False:
        return None, "eq"
    if track_total_hits is True:
        return total, "eq"
    threshold = int(track_total_hits)
    if total > threshold:
        return threshold, "gte"
    return total, "eq"


@dataclass
class Rescore:
    """One rescore stage: re-rank the top-`window_size` docs per shard
    (the reference's QueryRescorer): combined score per `score_mode`,
    with query_weight/rescore_query_weight factors; docs in the window
    that don't match the rescore query keep query_weight * original."""

    query: Query
    window_size: int = 10
    query_weight: float = 1.0
    rescore_query_weight: float = 1.0
    score_mode: str = "total"  # total | multiply | avg | max | min

    def combine(self, orig: np.ndarray, resc: np.ndarray, matched: np.ndarray):
        qw = np.float32(self.query_weight)
        rw = np.float32(self.rescore_query_weight)
        a, b = qw * orig, rw * resc
        if self.score_mode == "total":
            combined = a + b
        elif self.score_mode == "multiply":
            combined = a * b
        elif self.score_mode == "avg":
            combined = (a + b) / np.float32(2.0)
        elif self.score_mode == "max":
            combined = np.maximum(a, b)
        elif self.score_mode == "min":
            combined = np.minimum(a, b)
        else:
            raise ValueError(f"unknown rescore score_mode [{self.score_mode}]")
        return np.where(matched, combined, a).astype(np.float32)


@dataclass
class KnnSpec:
    """The top-level `knn` search section (the reference's ES 8.0 `knn`
    option and `_knn_search` endpoint). Approximate by contract: it may be
    served from the IVF planes (index/ann.py), so the hit set may miss
    neighbours the probe never reached; every returned score is the exact
    one (ops/ann_device's parity law). Exact kNN stays available through
    `script_score`, which never routes to the IVF planes."""

    field: str
    query_vector: np.ndarray  # f32[d]
    k: int = 10
    num_candidates: int = 100
    # IVF probe width; None = the index-side default (index/ann.
    # default_nprobe), raised if needed so probed slots cover
    # num_candidates.
    nprobe: int | None = None
    filter: Query | None = None

    KNOWN_KEYS = frozenset(
        {"field", "query_vector", "k", "num_candidates", "nprobe", "filter"}
    )

    @classmethod
    def from_json(cls, body) -> "KnnSpec":
        if not isinstance(body, dict):
            raise ValueError("[knn] must be an object")
        unknown = set(body) - cls.KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown key [{sorted(unknown)[0]}] in the [knn] section"
            )
        if "field" not in body:
            raise ValueError("[knn] requires a [field]")
        if "query_vector" not in body:
            raise ValueError("[knn] requires a [query_vector]")
        raw = body["query_vector"]
        if not isinstance(raw, list) or not raw or not all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in raw
        ):
            raise ValueError(
                "[knn] [query_vector] must be a non-empty array of numbers"
            )
        k = int(body.get("k", 10))
        if k < 1:
            raise ValueError(f"[knn] [k] must be greater than 0, got [{k}]")
        num_candidates = int(body.get("num_candidates", max(100, k)))
        if num_candidates < k:
            raise ValueError(
                f"[knn] [num_candidates] cannot be less than [k] "
                f"([{num_candidates}] < [{k}])"
            )
        if num_candidates > 10_000:
            raise ValueError("[knn] [num_candidates] cannot exceed [10000]")
        nprobe = body.get("nprobe")
        if nprobe is not None:
            nprobe = int(nprobe)
            if nprobe < 1:
                raise ValueError(
                    f"[knn] [nprobe] must be greater than 0, got [{nprobe}]"
                )
        filter_q = None
        if body.get("filter") is not None:
            filter_q = parse_query(body["filter"])
        return cls(
            field=str(body["field"]),
            query_vector=np.asarray(raw, dtype=np.float32),
            k=k,
            num_candidates=num_candidates,
            nprobe=nprobe,
            filter=filter_q,
        )


@dataclass
class SearchRequest:
    query: Query = field(default_factory=MatchAllQuery)
    size: int = 10
    from_: int = 0
    source_includes: bool | list[str] = True
    sort: list[dict[str, str]] | None = None  # [{"field": "asc"|"desc"}]
    # Per-sort-key missing-value placement ("_first" | "_last"), aligned
    # with `sort` (default _last).
    sort_missing: list[str] | None = None
    rescore: list[Rescore] = field(default_factory=list)
    # Pagination cursor: the sort-key value of the last consumed hit, plus
    # an optional doc-id tiebreak (engine-global doc id; -1 = key-only
    # cursor, the public search_after form).
    search_after: list[Any] | None = None
    after_doc: int = -1
    # True = exact, False = untracked, int = exact up to the threshold.
    track_total_hits: bool | int = 10_000
    # Top-level `knn` section (approximate vector search; see KnnSpec).
    knn: KnnSpec | None = None
    aggs: list[Any] | None = None  # list[aggs.AggNode]

    # The body keys this port serves; anything else (including the
    # reference's keys still to port) is a parsing error.
    KNOWN_KEYS = frozenset(
        {
            "query", "from", "size", "track_total_hits", "_source", "sort",
            "rescore", "search_after", "knn", "aggs", "aggregations",
        }
    )

    # Body keys the `knn` section cannot ride with (the reference's list;
    # those this port does not parse are refused as unknown keys first).
    KNN_EXCLUSIVE = (
        "query", "aggs", "aggregations", "sort", "rescore",
        "search_after", "suggest", "min_score",
    )

    @classmethod
    def from_json(cls, body: dict[str, Any] | None) -> "SearchRequest":
        body = body or {}
        unknown = set(body) - cls.KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown key [{sorted(unknown)[0]}] in the search request"
            )
        knn = None
        if body.get("knn") is not None:
            for key in cls.KNN_EXCLUSIVE:
                if body.get(key) is not None:
                    raise ValueError(
                        f"[knn] cannot be combined with [{key}] yet; the "
                        f"knn section serves pure vector queries "
                        f"(script_score remains the exact hybrid path)"
                    )
            knn = KnnSpec.from_json(body["knn"])
        query = (
            parse_query(body["query"]) if "query" in body else MatchAllQuery()
        )
        aggs = None
        raw_aggs = body.get("aggs") or body.get("aggregations")
        if raw_aggs:
            from .aggs import parse_aggs

            aggs = parse_aggs(raw_aggs)
        rescore = []
        raw_rescore = body.get("rescore", [])
        if isinstance(raw_rescore, dict):
            raw_rescore = [raw_rescore]
        for entry in raw_rescore:
            rq = entry.get("query", {})
            rescore.append(
                Rescore(
                    query=parse_query(rq["rescore_query"]),
                    window_size=int(entry.get("window_size", 10)),
                    query_weight=float(rq.get("query_weight", 1.0)),
                    rescore_query_weight=float(
                        rq.get("rescore_query_weight", 1.0)
                    ),
                    score_mode=str(rq.get("score_mode", "total")),
                )
            )
        sort = None
        sort_missing = None
        if "sort" in body:
            sort = []
            sort_missing = []
            raw = body["sort"]
            if not isinstance(raw, list):
                raw = [raw]
            for entry in raw:
                missing = "_last"
                if isinstance(entry, str):
                    fname = entry
                    order = "asc" if entry != "_score" else "desc"
                else:
                    ((fname, spec),) = entry.items()
                    if isinstance(spec, dict):
                        order = spec.get("order", "asc")
                        missing = str(spec.get("missing", "_last"))
                    else:
                        order = str(spec)
                if missing not in ("_first", "_last"):
                    raise ValueError(
                        f"sort [missing] must be [_first] or [_last], got "
                        f"[{missing}] (custom missing values are not "
                        f"supported yet)"
                    )
                sort.append({fname: order})
                sort_missing.append(missing)
        if rescore and sort is not None:
            raise ValueError(
                "Cannot use [sort] option in conjunction with [rescore]"
            )
        source = body.get("_source", True)
        if isinstance(source, str):  # a single field name
            source = [source]
        search_after = body.get("search_after")
        if search_after is not None:
            if not isinstance(search_after, list) or len(search_after) != 1:
                raise ValueError(
                    "search_after must be a one-element array matching the "
                    "primary sort key (multi-key cursors are not supported "
                    "yet)"
                )
            if sort is None:
                raise ValueError(
                    "search_after requires a sort to be specified"
                )
            if rescore:
                raise ValueError("cannot use [rescore] with [search_after]")
            if int(body.get("from", 0)) > 0:
                raise ValueError(
                    "[from] parameter must be set to 0 when [search_after] "
                    "is used"
                )
            ((sa_field, _),) = sort[0].items()
            if sa_field == "_score" and not isinstance(
                search_after[0], (int, float)
            ):
                raise ValueError(
                    "search_after value for a [_score] sort must be a number"
                )
        tth = body.get("track_total_hits", 10_000)
        if not isinstance(tth, bool):
            tth = int(tth)
        return cls(
            query=query,
            size=int(body.get("size", 10)),
            from_=int(body.get("from", 0)),
            source_includes=source,
            sort=sort,
            sort_missing=sort_missing,
            rescore=rescore,
            search_after=search_after,
            track_total_hits=tth,
            knn=knn,
            aggs=aggs,
        )


_NO_SORT = object()  # sentinel: hit carries no sort values (default score sort)

F32_MAX = float(np.finfo(np.float32).max)


def normalized_sort(request: "SearchRequest") -> list[tuple[str, bool, bool]]:
    """The request's sort as [(field, descending, missing_first)], with a
    trailing "_doc" key dropped: the merge contract is ALWAYS doc-id
    tiebroken, so an explicit trailing _doc only makes the implicit
    tiebreak visible. "_score" keys pass through as the pseudo-field
    "_score"."""
    if request.sort is None:
        return []
    missing = request.sort_missing or ["_last"] * len(request.sort)
    out: list[tuple[str, bool, bool]] = []
    for i, entry in enumerate(request.sort):
        ((fname, order),) = entry.items()
        if fname == "_doc" and i == len(request.sort) - 1 and i > 0:
            continue
        out.append((fname, str(order) == "desc", missing[i] == "_first"))
    return out


def sort_merge_key(request: "SearchRequest", score, sort_values):
    """Cross-shard merge key for one hit under the request's sort: a
    scalar for single-key sorts, a tuple for multi-key. Ascending key
    space; missing values map to -/+inf per the key's missing
    directive."""
    if request.sort is None:
        return -score if score is not None else np.inf
    keys = normalized_sort(request)
    if keys and keys[0][0] == "_score":
        s = score if score is not None else 0.0
        return s if not keys[0][1] else -s
    vals = sort_values or []
    out = []
    for i, (_f, desc, mfirst) in enumerate(keys):
        v = vals[i] if i < len(vals) else None
        if v is None:
            out.append(-np.inf if mfirst else np.inf)
        else:
            out.append(-v if desc else v)
    if not out:
        return np.inf
    return tuple(out) if len(out) > 1 else out[0]


class SearchService:
    """Executes SearchRequests against one Engine (one shard). `planner`
    is the node's ExecPlanner (None: every segment runs on the device
    kernels); `ann_cache` the node's AnnCache of IVF planes (None: every
    knn runs the exact brute-force kernels); `filter_cache` the node's
    FilterCache (None: every filter is evaluated on every launch)."""

    def __init__(self, engine: Engine, planner=None, ann_cache=None,
                 index_name: str = "index", filter_cache=None):
        self.engine = engine
        self.index_name = index_name  # top_hits' `_index`
        self.planner = planner
        self.ann_cache = ann_cache
        self.filter_cache = filter_cache

    # --------------------------------------------------------- filter cache

    def _collect_filter_entries(self, query, record: bool) -> list:
        """The request's cacheable-filter entries, with one admission
        sighting recorded when `record` (once per user request, never per
        segment, and never per shard when a coordinator drives this
        service). Collected once and threaded through every per-segment
        apply."""
        from ..index.filter_cache import record_filter_usage

        return record_filter_usage(self.filter_cache, query, record=record)

    def _live_uids(self) -> frozenset:
        return frozenset(h.uid for h in self.engine.segments)

    def _apply_filter_cache(self, handle, query, compiled, seg_tree,
                            entries=None):
        """Substitute cached mask planes into one segment's compiled plan.
        Returns (compiled', masks), masks empty when nothing applied.
        Keyed per segment handle, not per engine generation: postings are
        immutable and planes exclude the live mask, so a plane stays
        servable across refreshes that only add other segments."""
        if self.filter_cache is None:
            return compiled, {}
        from ..index.filter_cache import apply_cached_masks

        def build(child_spec, child_arrays, _norm):
            plane = _owned_plane(bm25_device.compute_filter_mask(
                seg_tree, child_spec,
                bm25_device.plan_to_torch(
                    child_spec, child_arrays, handle.device.device),
            ))
            return plane, plane.numel() * plane.element_size()

        compiled, masks, _reused = apply_cached_masks(
            self.filter_cache, (self.engine.uid, 0, handle.uid), query,
            compiled, build, entries=entries, live_uids=self._live_uids(),
        )
        return compiled, masks

    def search(
        self,
        request: SearchRequest,
        stats: dict[str, FieldStats] | None = None,
        segments: list | None = None,
        record_filter_usage: bool = True,
        fc_entries: list | None = None,
    ) -> SearchResponse:
        """One request, one device launch per segment (and one agg pass per
        segment). `stats` and `segments` are the coordinator's pushed-down
        statistics and pinned segment snapshot (default: this shard's
        own). `record_filter_usage=False` records no filter-cache
        sighting: the coordinator records once per user request (an
        n-shard scatter must not count n), and the batcher's solo retry
        was counted by its coalesced attempt; `fc_entries` are the
        caller's already-collected cacheable-filter entries."""
        start = time.monotonic()
        k = max(0, request.from_) + max(0, request.size)
        if stats is None:
            stats = self.engine.field_stats()
        self._validate_sort(request)
        self._validate_knn(request)
        if fc_entries is None:
            fc_entries = self._collect_filter_entries(
                request.query, record_filter_usage
            )
        if request.knn is not None:
            from ..index.filter_cache import record_knn_filter_usage

            record_knn_filter_usage(
                self.filter_cache, request.knn, record=record_filter_usage
            )
        # One segment snapshot shared by the agg pass and the hits pass.
        if segments is None:
            segments = list(self.engine.segments)
        aggregations = None
        agg_total = None
        if request.aggs is not None:
            from .aggs import Aggregator

            agg_total, aggregations = Aggregator(
                self.engine, request.aggs, handles=segments,
                index_name=self.index_name,
            ).run(request.query, stats=stats)
        # Candidate tuples (merge_key, global_doc, handle, local, score,
        # sort_value): merge_key ascending, then global doc id ascending,
        # is Lucene's order for the score sort (key = -score) and for
        # field sorts.
        candidates: list[tuple] = []
        total = 0
        if k > 0 or agg_total is None:
            for handle in segments:
                if handle.segment.num_docs == 0:
                    continue
                total += self._query_segment(
                    handle, request, k, stats, candidates, fc_entries
                )
        if agg_total is not None:
            # The agg pass counted matched & live docs: one source for
            # totals (the same mask by construction).
            total = agg_total
        candidates.sort(key=lambda c: (c[0], c[1]))
        if request.knn is not None:
            # The knn contract returns the GLOBAL top k: segments each
            # contribute up to k candidates, the merge keeps k, and
            # from/size page within those.
            candidates = candidates[: request.knn.k]
        page = candidates[request.from_ : request.from_ + request.size]
        max_score = None
        if request.sort is None and candidates:
            max_score = -candidates[0][0]
        hits = [
            SearchHit(
                doc_id=handle.segment.ids[local],
                score=score,
                source=self._fetch_source(handle, local, request),
                sort=(
                    None
                    if sort_value is _NO_SORT
                    else sort_value
                    if isinstance(sort_value, list)
                    else [sort_value]
                ),
                global_doc=global_doc,
            )
            for _key, global_doc, handle, local, score, sort_value in page
        ]
        total_out, relation = clamp_total(total, request.track_total_hits)
        return SearchResponse(
            took_ms=int((time.monotonic() - start) * 1000),
            total=total_out,
            total_relation=relation,
            max_score=max_score,
            hits=hits,
            aggregations=aggregations,
        )

    def _validate_sort(self, request: SearchRequest) -> None:
        """Validate the sort spec against the mappings up front. Accepted
        shapes: one or more numeric doc-values fields (multi-key sorts
        lexsort on the host), an optional trailing "_doc" tiebreak, or a
        lone "_score" key."""
        if request.sort is None:
            return
        fields = [next(iter(e)) for e in request.sort]
        for i, f in enumerate(fields):
            if f == "_doc":
                if i != len(fields) - 1 or i == 0:
                    raise ValueError(
                        "[_doc] is only supported as a trailing tiebreak "
                        "after a field sort key"
                    )
                continue
            if f == "_score":
                if len(fields) > 1:
                    raise ValueError(
                        "[_score] cannot be combined with other sort keys"
                    )
                continue
            fm = self.engine.mappings.get(f)
            if fm is None or not fm.is_numeric:
                raise ValueError(
                    f"No mapping found for [{f}] in order to sort on"
                )
        real = [f for f in fields if f not in ("_doc", "_score")]
        if request.search_after is not None and len(real) > 1:
            raise ValueError(
                "search_after with a multi-key sort is not supported yet"
            )

    def _query_segment(
        self,
        handle: SegmentHandle,
        request: SearchRequest,
        k: int,
        stats: dict[str, FieldStats],
        candidates: list,
        fc_entries: list | None = None,
    ) -> int:
        """Score one segment, appending candidate tuples; returns the
        segment's total hits (a lower bound on the block-max paths, whose
        requests do not track totals)."""
        if request.knn is not None:
            return self._query_segment_knn(handle, request, stats, candidates)
        compiled = self.engine.compiler_for(handle, stats).compile(request.query)
        seg_tree = bm25_device.segment_tree(handle.device)
        # Filter cache: cacheable filter-context clauses read their cached
        # (or freshly admitted) planes, bit-identical by construction.
        compiled, fc_masks = self._apply_filter_cache(
            handle, request.query, compiled, seg_tree, entries=fc_entries
        )
        if fc_masks:
            seg_tree = {**seg_tree, "masks": fc_masks}

        # Sort spec validity is enforced up front by _validate_sort.
        sort_field = None
        descending = False
        missing_first = False
        if request.sort is not None:
            keys = normalized_sort(request)
            if keys[0][0] == "_score":
                sort_field = "_score"
                descending = keys[0][1]
            elif len(keys) == 1:
                sort_field, descending, missing_first = keys[0]
            else:
                # Multi-key field sort: dense matched mask + host lexsort.
                return self._query_segment_multisort(
                    handle, k, keys, compiled, seg_tree, candidates
                )

        cursor = request.search_after
        if sort_field is None or sort_field == "_score":
            ascending_score = sort_field == "_score" and not descending
            if cursor is not None:
                # Cursor pagination: mask docs at or before the (score,
                # doc) cursor BEFORE the device top-k.
                a_doc = (
                    request.after_doc - handle.base
                    if request.after_doc >= 0
                    else handle.device.num_docs  # key-only: no tie clause
                )
                scores, ids, tot, n_after = bm25_device.execute_score_after(
                    seg_tree, compiled.spec, _plan(handle, compiled), k,
                    np.float32(cursor[0]),
                    a_doc, ascending=ascending_score,
                )
                scores, ids = _host(scores), _host(ids)
                tot = int(tot)
                n = min(k, int(n_after), len(ids))
            elif ascending_score:
                # Bottom-k needs its own device reduction.
                scores, ids, tot = bm25_device.execute_score_asc(
                    seg_tree, compiled.spec, _plan(handle, compiled), k
                )
                scores, ids, tot = _host(scores), _host(ids), int(tot)
                n = min(k, tot, len(ids))
            else:
                scores, ids, tot = self._score_sorted(
                    handle, request, compiled, seg_tree, k, stats,
                    masked=bool(fc_masks),
                )
                n = min(k, tot, len(ids))
            for rank in range(n):
                score = float(scores[rank])
                local = int(ids[rank])
                if sort_field is None:
                    key, sort_value = -score, _NO_SORT
                else:
                    key, sort_value = (
                        (score if ascending_score else -score), score
                    )
                candidates.append(
                    (key, handle.base + local, handle, local, score, sort_value)
                )
            return tot

        missing_key = -np.inf if missing_first else np.inf
        if sort_field not in handle.device.doc_values:
            # Mapped numeric field with no values in this segment: every
            # matched doc is "missing", placed per the missing directive
            # and ordered by doc id.
            _, eligible = bm25_device.execute_dense(
                seg_tree, compiled.spec, _plan(handle, compiled)
            )
            mask = _host(eligible)
            locs = np.flatnonzero(mask)
            if cursor is not None:
                if cursor[0] is None:
                    # Cursor inside the missing region: resume by doc id
                    # (a key-only null cursor skips the whole region).
                    if request.after_doc >= 0:
                        locs = locs[locs > request.after_doc - handle.base]
                    else:
                        locs = locs[:0]
                elif missing_first:
                    # Missing-first: a real-valued cursor is PAST the
                    # whole missing region.
                    locs = locs[:0]
                # Missing-last: a real cursor precedes every missing doc.
            for local in locs[:k]:
                candidates.append(
                    (missing_key, handle.base + int(local), handle,
                     int(local), None, None)
                )
            return int(mask.sum())
        if cursor is not None:
            raw_after = cursor[0]
            fmax = np.float32(F32_MAX)
            if raw_after is None:
                # Missing-region cursor, in the transformed ascending key
                # space (missing = +fmax last / -fmax first).
                a_key = -fmax if missing_first else fmax
            else:
                a_key = np.float32(raw_after)
                if descending:
                    a_key = np.float32(-a_key)
            a_doc = (
                request.after_doc - handle.base
                if request.after_doc >= 0
                else handle.device.num_docs
            )
            values, ids, tot, n_after = bm25_device.execute_sorted_after(
                seg_tree, compiled.spec, _plan(handle, compiled), sort_field,
                descending, k,
                a_key, a_doc, missing_first=missing_first,
            )
            n = min(k, int(n_after))
        else:
            values, ids, tot = bm25_device.execute_sorted(
                seg_tree, compiled.spec, _plan(handle, compiled), sort_field,
                descending, k,
                missing_first=missing_first,
            )
            n = min(k, int(tot))
        values, ids = _host(values), _host(ids)
        for rank in range(n):
            local = int(ids[rank])
            raw = float(values[rank])
            missing = np.isnan(values[rank])
            key = missing_key if missing else (-raw if descending else raw)
            candidates.append(
                (
                    key,
                    handle.base + local,
                    handle,
                    local,
                    None,  # ES omits _score for field sorts by default
                    None if missing else raw,
                )
            )
        return int(tot)

    def _score_sorted(self, handle, request, compiled, seg_tree, k, stats,
                      masked: bool = False):
        """The score-sorted pass of one segment on the backend the planner
        picks (not consulted for a request with rescore, whose window
        runs on the device kernels), then the rescore stages. Returns
        host (scores, ids, total)."""
        backend, plan_class = "device", None
        if self.planner is not None and not request.rescore:
            backend, plan_class = self._decide_backend(
                handle, request, compiled, k, masked=masked
            )
        kern_t0 = time.monotonic()
        if backend == "blockmax":
            s, i, t, _rel = bm25_device.execute_batch_blockmax(
                seg_tree, compiled.spec, [compiled.arrays], k
            )
            scores, ids, tot = s[0], i[0], int(t[0])
        elif backend == "blockmax_conj":
            s, i, t, _rel = bm25_device.execute_batch_blockmax_conj(
                seg_tree, compiled.spec, [compiled.arrays], k
            )
            scores, ids, tot = s[0], i[0], int(t[0])
        else:
            fetch_k = k
            if request.rescore:
                fetch_k = max(k, max(r.window_size for r in request.rescore))
            scores, ids, tot = bm25_device.execute_auto(
                seg_tree, compiled.spec, _plan(handle, compiled), fetch_k
            )
            # One device -> host transfer of the hits and the total.
            scores, ids, tot = _host(scores), _host(ids), int(tot)
            if request.rescore:
                scores, ids = self._apply_rescore(
                    handle, seg_tree, request, scores, ids, tot, stats
                )
        if plan_class is not None:
            self.planner.record(
                plan_class, backend, time.monotonic() - kern_t0
            )
        return scores, ids, tot

    def _query_segment_multisort(
        self, handle, k: int, keys, compiled, seg_tree, candidates: list,
    ) -> int:
        """Multi-key field sort over one segment: ONE dense device launch
        for the matched mask, then a host lexsort over the f32-quantized
        doc-values columns (per key: asc/desc, missing first/last; final
        doc-id tiebreak). A per-key device top-k cannot serve this shape:
        docs tying on the primary key may win on a secondary key from
        beyond the primary top-k."""
        _, eligible = bm25_device.execute_dense(
            seg_tree, compiled.spec, _plan(handle, compiled)
        )
        n_docs = handle.segment.num_docs
        mask = _host(eligible)[:n_docs]
        locs = np.flatnonzero(mask)
        total = int(len(locs))
        if total == 0 or k <= 0:
            return total
        vals32 = []  # f32 stored-value semantics, like the device column
        sortkeys = []  # transformed ascending f64 key per sort position
        for f, desc, mfirst in keys:
            col = handle.segment.doc_values.get(f)
            if col is None:
                v = np.full(len(locs), np.nan, dtype=np.float32)
            else:
                v = col[locs].astype(np.float32)
            miss = np.float32(-F32_MAX if mfirst else F32_MAX)
            key = np.where(
                np.isnan(v), miss, (-v if desc else v)
            ).astype(np.float64)
            vals32.append(v)
            sortkeys.append(key)
        order = np.lexsort((locs,) + tuple(reversed(sortkeys)))[:k]
        for pos in order:
            local = int(locs[pos])
            sort_vals = []
            merge_key = []
            for ki, (_f, desc, mfirst) in enumerate(keys):
                v = vals32[ki][pos]
                if np.isnan(v):
                    sort_vals.append(None)
                    merge_key.append(-np.inf if mfirst else np.inf)
                else:
                    sort_vals.append(float(v))
                    merge_key.append(-float(v) if desc else float(v))
            candidates.append(
                (
                    tuple(merge_key),
                    handle.base + local,
                    handle,
                    local,
                    None,  # no _score for field sorts
                    sort_vals,
                )
            )
        return total

    def _apply_rescore(
        self,
        handle: SegmentHandle,
        seg_tree,
        request: SearchRequest,
        scores: np.ndarray,
        ids: np.ndarray,
        total: int,
        stats: dict[str, FieldStats],
    ) -> tuple[np.ndarray, np.ndarray]:
        """Run rescore stages over the shard-local top window: window docs
        are re-sorted by combined score; hits past the window keep their
        original order below it (QueryRescorer's contract). Each stage's
        rescore query is evaluated densely on the device and read out at
        the window's ids (scores_at: K5's gather)."""
        n = min(len(ids), total)
        scores, ids = scores[:n].copy(), ids[:n].copy()
        compiler = self.engine.compiler_for(handle, stats)
        for stage in request.rescore:
            w = min(stage.window_size, len(ids))
            if w == 0:
                continue
            compiled = compiler.compile(stage.query)
            # The window padded to a pow-2 bucket, as the reference pads.
            w_pad = 1 << (w - 1).bit_length()
            padded = np.zeros(w_pad, dtype=np.int32)
            padded[:w] = ids[:w]
            r_scores, r_matched = bm25_device.scores_at(
                seg_tree, compiled.spec, _plan(handle, compiled),
                torch.from_numpy(padded).to(handle.device.device),
            )
            r_scores = _host(r_scores)[:w]
            r_matched = _host(r_matched)[:w]
            combined = stage.combine(scores[:w], r_scores, r_matched)
            order = np.lexsort((ids[:w], -combined.astype(np.float64)))
            scores[:w] = combined[order]
            ids[:w] = ids[:w][order]
        return scores, ids

    def _decide_backend(
        self, handle: SegmentHandle, request: SearchRequest, compiled, k: int,
        masked: bool = False,
    ) -> tuple[str, tuple | None]:
        """(backend, plan_class) for one plain score-sorted segment pass.

        The candidates are the backends that cannot change the top-k:
        block-max only when exact totals are not tracked (its totals are
        "gte"), and only for k >= 1 (its threshold is the k-th score). A
        plan with filter-cache planes runs the same device kernels but is
        priced and counted as the `cached_mask` backend: its work_tiles
        leave out the cached clauses' worklists."""
        base = "cached_mask" if masked else "device"
        if self.planner is None:
            return base, None
        spec = compiled.spec
        candidates = [base]
        if request.track_total_hits is False and k > 0:
            if spec[0] == "terms":
                candidates.append("blockmax")
            elif bm25_device.supports_blockmax_conj(spec):
                candidates.append("blockmax_conj")
        plan_class = self.planner.classify(spec, k)
        if len(candidates) == 1:
            return base, plan_class
        feats = PlanFeatures(
            n_docs=handle.segment.num_docs,
            work_tiles=(
                spec_work_tiles(spec)
                if bm25_device.supports_sparse(spec)
                else 0
            ),
            n_clauses=spec[3] if spec[0] == "terms" else 1,
        )
        return self.planner.decide(plan_class, candidates, feats), plan_class

    # ------------------------------------------------------------------ knn

    def _validate_knn(self, request: SearchRequest) -> None:
        """Validate the knn section against the mappings up front (field
        mapped as dense_vector, query_vector dims agree), so a malformed
        request 400s before any segment pass runs."""
        if request.knn is None:
            return
        knn = request.knn
        fm = self.engine.mappings.get(knn.field)
        if fm is None:
            raise ValueError(
                f"failed to find knn vector field [{knn.field}] in mapping"
            )
        if fm.type != "dense_vector":
            raise ValueError(
                f"[knn] field [{knn.field}] must be of type [dense_vector] "
                f"but is [{fm.type}]"
            )
        if len(knn.query_vector) != fm.dims:
            raise ValueError(
                f"the query vector has a different number of dimensions "
                f"[{len(knn.query_vector)}] than the document vectors "
                f"[{fm.dims}]"
            )

    def _knn_filter_mask(self, handle, seg_tree, filter_query, stats):
        """The knn filter as a device mask plane bool[N], applied before
        the rank inside the kernels, so filtered-out docs never take a
        candidate slot: the filter cache's plane when the filter is a
        cacheable shape that has earned admission, else one dense filter
        pass (compute_filter_mask)."""
        compiled = self.engine.compiler_for(handle, stats).compile(
            filter_query
        )

        def build():
            return bm25_device.compute_filter_mask(
                seg_tree, compiled.spec, _plan(handle, compiled)
            )

        if self.filter_cache is None:
            return build()
        from ..query.compile import cacheable_filter_key

        norm = cacheable_filter_key(filter_query)
        if norm is None:
            return build()
        key = (self.engine.uid, 0, handle.uid, norm)
        plane = self.filter_cache.get(key)
        if plane is not None:
            self.filter_cache.note_reuse(1)
            return plane
        plane = build()
        if self.filter_cache.should_admit(norm):
            plane = _owned_plane(plane)
            self.filter_cache.put(
                key, plane, plane.numel() * plane.element_size(),
                live_uids=self._live_uids(),
            )
        return plane

    def _knn_plan(self, handle, knn: KnnSpec):
        """(partitions or None, nprobe, metric, plan_class, backend) for one
        segment's knn pass. A segment without partitions (too small, or
        the node's ANN cache off) serves the exact brute-force kernels; the
        planner decides between `ann_ivf` and the exact `device` kernels
        only here, because the knn section is approximate by contract."""
        metric = self.engine.mappings.get(knn.field).similarity
        parts = None
        if self.ann_cache is not None:
            parts = self.ann_cache.get_or_build(
                self.engine, handle, knn.field, metric
            )
        if parts is None:
            return None, 0, metric, None, "device"
        nprobe = knn.nprobe or default_nprobe(parts.n_partitions)
        # num_candidates is a floor on the real vectors the probe covers
        # (average fill n_vectors / n_partitions); num_candidates at or
        # above the corpus degenerates to a full probe.
        nprobe = max(
            nprobe,
            -(-knn.num_candidates * parts.n_partitions
              // max(1, parts.n_vectors)),
        )
        nprobe = min(nprobe, parts.n_partitions)
        backend, plan_class = "ann_ivf", None
        if self.planner is not None:
            spec = ("knn", knn.field, metric, parts.n_partitions, nprobe)
            plan_class = self.planner.classify(spec, knn.k)
            feats = PlanFeatures(
                n_docs=handle.segment.num_docs,
                n_candidates=parts.n_partitions + nprobe * parts.pmax,
            )
            backend = self.planner.decide(
                plan_class, ["ann_ivf", "device"], feats
            )
        return parts, nprobe, metric, plan_class, backend

    def _record_knn(self, plan_class, backend: str, seconds: float) -> None:
        if self.planner is None:
            return
        if plan_class is not None:
            self.planner.record(plan_class, backend, seconds)
        else:
            self.planner.note(backend)

    def _query_segment_knn(
        self, handle: SegmentHandle, request: SearchRequest, stats,
        candidates: list,
    ) -> int:
        """One segment's knn pass: IVF probe + exact re-rank where the
        segment has partition planes, exact brute force otherwise. Appends
        up to knn.k candidates (the per-segment count of the reference's
        kNN contract); returns the live ∧ filter total."""
        knn = request.knn
        dev = handle.device
        vectors = dev.vectors.get(knn.field)
        if vectors is None:
            return 0  # mapped field, no vectors in this segment
        seg_tree = bm25_device.segment_tree(dev)
        fmask = None
        if knn.filter is not None:
            fmask = self._knn_filter_mask(handle, seg_tree, knn.filter, stats)
        parts, nprobe, metric, plan_class, backend = self._knn_plan(handle, knn)
        t0 = time.monotonic()
        if backend == "ann_ivf":
            scores, ids, tot, n_cand = ann_device.ann_ivf_search(
                parts.tree(), dev.live, knn.query_vector, knn.k, nprobe,
                metric, filter_mask=fmask,
            )
        else:
            scores, ids, tot = ann_device.knn_exact(
                vectors, dev.live, knn.query_vector, knn.k, metric,
                filter_mask=fmask, has_vec=dev.has_vector[knn.field],
            )
            n_cand = tot
        scores, ids = _host(scores), _host(ids)
        tot, n_cand = int(tot), int(n_cand)
        self._record_knn(plan_class, backend, time.monotonic() - t0)
        # Real hits are the finite-score prefix: totals count the eligible
        # doc space, but vector-less docs cannot be scored.
        n_cand = min(n_cand, int(np.sum(scores > np.float32(bm25_device.NEG_INF))))
        self._append_plain(candidates, handle, scores, ids,
                           min(knn.k, n_cand, len(ids)))
        return tot

    def _knn_search_many(self, requests: list) -> list:
        """Coalesced knn serving: the micro-batcher groups unfiltered knn
        requests by (field, k, num_candidates, nprobe), so every rider
        shares one kernel shape and their query vectors stack into one
        batched pass per segment, each lane equal to its solo answer."""
        start = time.monotonic()
        n = len(requests)
        segments = list(self.engine.segments)
        cands: list[list] = [[] for _ in range(n)]
        totals = [0] * n
        errors: list[Exception | None] = [None] * n
        for i, r in enumerate(requests):
            try:
                self._validate_knn(r)
            except ValueError as e:
                errors[i] = e
        knn0 = next(
            (requests[i].knn for i in range(n) if errors[i] is None), None
        )
        uniform = all(
            errors[i] is not None
            or (
                (kn := requests[i].knn) is not None
                and kn.filter is None
                and (kn.field, kn.k, kn.num_candidates, kn.nprobe)
                == (knn0.field, knn0.k, knn0.num_candidates, knn0.nprobe)
            )
            for i in range(n)
        )
        if knn0 is None or not uniform:
            # A mixed group (the batcher's group key prevents it) serves
            # each rider solo, result-identical.
            out = []
            for i in range(n):
                if errors[i] is not None:
                    out.append(errors[i])
                    continue
                try:
                    out.append(self.search(requests[i]))
                except Exception as e:  # noqa: BLE001 - per-rider result
                    out.append(e)
            return out
        alive = [i for i in range(n) if errors[i] is None]
        for handle in segments:
            dev = handle.device
            vectors = dev.vectors.get(knn0.field)
            if vectors is None or handle.segment.num_docs == 0:
                continue
            parts, nprobe, metric, plan_class, backend = self._knn_plan(
                handle, knn0
            )
            qs = np.stack([requests[i].knn.query_vector for i in alive])
            t0 = time.monotonic()
            if backend == "ann_ivf":
                s_b, i_b, t_b, nc_b = ann_device.ann_ivf_search_batch(
                    parts.tree(), dev.live, qs, knn0.k, nprobe, metric
                )
            else:
                s_b, i_b, t_b = ann_device.knn_exact_batch(
                    vectors, dev.live, qs, knn0.k, metric,
                    has_vec=dev.has_vector[knn0.field],
                )
                nc_b = t_b
            s_b, i_b, t_b, nc_b = _host(s_b), _host(i_b), _host(t_b), _host(nc_b)
            elapsed = time.monotonic() - t0
            finite_b = np.sum(s_b > np.float32(bm25_device.NEG_INF), axis=1)
            for row, i in enumerate(alive):
                nn = min(knn0.k, int(nc_b[row]), int(finite_b[row]),
                         i_b.shape[1])
                self._append_plain(cands[i], handle, s_b[row], i_b[row], nn)
                totals[i] += int(t_b[row])
                self._record_knn(plan_class, backend, elapsed / len(alive))
        out: list = []
        for i, request in enumerate(requests):
            if errors[i] is not None:
                out.append(errors[i])
                continue
            rows = sorted(cands[i], key=lambda c: (c[0], c[1]))
            out.append(self.assemble_plain(
                request, rows[: request.knn.k], totals[i], start
            ))
        return out

    # ------------------------------------------------- batched query phase

    def search_many(self, requests: list) -> list:
        """Serve several PLAIN searches with coalesced device launches.

        The micro-batcher's group executor: one padded launch per
        (segment, spec group) scores every request's lane at once instead
        of one launch per request. Returns one SearchResponse (or
        Exception) per request, result-identical to running each request
        through search() alone. Each rider records its one filter-cache
        sighting here."""
        if any(r.knn is not None for r in requests):
            # A coalesced knn group (the batcher's ("_knn", ...) key).
            return self._knn_search_many(requests)
        start = time.monotonic()
        stats = self.engine.field_stats()
        segments = list(self.engine.segments)
        ks = [max(0, r.from_) + max(0, r.size) for r in requests]
        cands, totals, errors = self._batched_query_phase(
            requests, ks, stats, segments
        )
        return [
            errors[i]
            if errors[i] is not None
            else self.assemble_plain(request, cands[i], totals[i], start)
            for i, request in enumerate(requests)
        ]

    def assemble_plain(
        self, request: SearchRequest, rows: list, total: int, start: float
    ) -> SearchResponse:
        """Assemble one plain score-sorted SearchResponse from candidate
        tuples: sort, page, fetch, as search() does."""
        rows = sorted(rows, key=lambda c: (c[0], c[1]))
        page = rows[request.from_ : request.from_ + request.size]
        max_score = -rows[0][0] if rows else None
        hits = [
            SearchHit(
                doc_id=handle.segment.ids[local],
                score=score,
                source=self._fetch_source(handle, local, request),
                global_doc=global_doc,
            )
            for _key, global_doc, handle, local, score, _sv in page
        ]
        total_out, relation = clamp_total(total, request.track_total_hits)
        return SearchResponse(
            took_ms=int((time.monotonic() - start) * 1000),
            total=total_out,
            total_relation=relation,
            max_score=max_score,
            hits=hits,
        )

    def _batched_query_phase(
        self,
        requests: list,
        ks: list[int],
        stats: dict[str, FieldStats],
        segments: list,
        record_filter_usage: bool = True,
        fc_entries: list | None = None,
    ):
        """One coalesced scoring pass over this shard for N plain requests.

        Per segment, requests compile, take their filter-cache planes and
        group by (spec, mask token) (same-family term groups are
        re-bucketed to a common nt so they share ONE padded launch); each
        group executes as a single batched kernel call. One admission
        sighting per rider is recorded once for the whole batch, unless
        the coordinator already did (`record_filter_usage=False`, with its
        collected per-rider `fc_entries`). Returns (candidates per
        request, totals, errors)."""
        from ..index.filter_cache import mask_group_token

        n = len(requests)
        cands: list[list] = [[] for _ in range(n)]
        totals = [0] * n
        errors: list[Exception | None] = [None] * n
        alive = set(range(n))
        if fc_entries is None:
            fc_entries = [
                self._collect_filter_entries(r.query, record_filter_usage)
                for r in requests
            ]
        for handle in segments:
            if handle.segment.num_docs == 0 or not alive:
                continue
            seg_tree = bm25_device.segment_tree(handle.device)
            compiled: dict[int, CompiledQuery] = {}
            req_masks: dict[int, dict] = {}
            for i in sorted(alive):
                try:
                    compiled[i] = self.engine.compiler_for(
                        handle, stats
                    ).compile(requests[i].query)
                except ValueError as e:
                    errors[i] = e
                    alive.discard(i)
                    continue
                # Batchmates sharing a filter share one plane: substitution
                # happens before grouping, so lanes with the same (spec,
                # planes) land in one launch with the planes passed once
                # through seg["masks"], never stacked per lane.
                compiled[i], req_masks[i] = self._apply_filter_cache(
                    handle, requests[i].query, compiled[i], seg_tree,
                    entries=fc_entries[i],
                )
            groups: dict[tuple, list[int]] = {}
            for i, c in compiled.items():
                if i in alive:
                    token = mask_group_token(req_masks.get(i, {}))
                    groups.setdefault((c.spec, token), []).append(i)
            groups = self._merge_term_groups(groups, compiled)
            for (spec, _token), rows in groups.items():
                # One padded launch per group at its largest k (the
                # reference may route a group to its CPU oracle; the port
                # has one backend).
                masks = req_masks.get(rows[0], {})
                try:
                    self._device_batch(
                        handle, spec, rows, compiled, ks,
                        max(ks[i] for i in rows), cands, totals,
                        seg_tree=seg_tree, masks=masks,
                    )
                except (ValueError, TypeError) as e:
                    # Request-shaped (a k beyond the top-k window, say):
                    # only the riders that cause it may fail, so a
                    # coalesced group re-runs its riders one at a time.
                    if len(rows) == 1:
                        errors[rows[0]] = e
                        alive.discard(rows[0])
                        continue
                    for i in rows:
                        try:
                            self._device_batch(
                                handle, spec, [i], compiled, ks, ks[i],
                                cands, totals, seg_tree=seg_tree,
                                masks=masks,
                            )
                        except Exception as e_row:  # noqa: BLE001
                            errors[i] = e_row
                            alive.discard(i)
                # Launch failure isolation: only the riders of THIS group
                # fail (and get retried individually by the micro-batcher);
                # batchmates in other groups and segments are untouched.
                except Exception as e:  # noqa: BLE001
                    for i in rows:
                        errors[i] = e
                        alive.discard(i)
        return cands, totals, errors

    def _merge_term_groups(self, groups, compiled):
        """Coalesce same-family term groups that differ only in their nt
        bucket, adaptively: exec/batcher.plan_spec_buckets splits the
        family into sub-buckets, and a smaller group joins a larger bucket
        only when the padding it would pay costs less than the launch it
        saves. Joined groups PAD their compiled arrays to the bucket spec
        (bit-identical results, no recompile). Term families never carry
        masks (substitution only rewrites bool filter clauses), so the
        merge works on the empty-token keys."""
        from ..exec.batcher import plan_spec_buckets
        from ..query.compile import pad_arrays_to_spec, unify_specs

        families: dict[tuple, list[tuple]] = {}
        for spec, token in list(groups):
            fam = sparse_family_key(spec)
            if fam is not None and token == ():
                families.setdefault(fam, []).append(spec)
        for specs in families.values():
            if len(specs) < 2:
                continue
            for bucket in plan_spec_buckets(
                [(s, len(groups[(s, ())])) for s in specs]
            ):
                if len(bucket) < 2:
                    continue
                target = unify_specs(list(bucket))
                merged_rows: list[int] = []
                for s in bucket:
                    rows = groups.pop((s, ()))
                    for i in rows:
                        compiled[i] = CompiledQuery(
                            spec=target,
                            arrays=pad_arrays_to_spec(
                                compiled[i].spec, target, compiled[i].arrays
                            ),
                        )
                    merged_rows.extend(rows)
                groups.setdefault((target, ()), []).extend(merged_rows)
        return groups

    def _device_batch(
        self, handle, spec, rows, compiled, ks, k_max, cands, totals,
        seg_tree=None, masks=None,
    ) -> None:
        """One padded device launch for a same-spec row group: the plans
        stack on the host and upload once (`stack_plans`), the batched
        executor runs every row, and the results come back in one device
        -> host copy per output. The group's filter-cache planes
        (`masks`, the same objects for every rider by the group key) ride
        the seg tree once."""
        if seg_tree is None:
            seg_tree = bm25_device.segment_tree(handle.device)
        if masks:
            seg_tree = {**seg_tree, "masks": masks}
        arrays_b = bm25_device.plan_to_torch(
            spec,
            bm25_device.stack_plans([compiled[i].arrays for i in rows]),
            handle.device.device,
        )
        s_b, i_b, t_b = bm25_device.execute_batch_auto(
            seg_tree, spec, arrays_b, k_max, q=len(rows)
        )
        s_b, i_b, t_b = s_b.cpu().numpy(), i_b.cpu().numpy(), t_b.cpu().numpy()
        for row, i in enumerate(rows):
            tot = int(t_b[row])
            nn = min(ks[i], tot, s_b.shape[1])
            self._append_plain(cands[i], handle, s_b[row], i_b[row], nn)
            totals[i] += tot

    @staticmethod
    def _append_plain(bucket, handle, scores, ids, n) -> None:
        for rank in range(n):
            score = float(scores[rank])
            local = int(ids[rank])
            bucket.append(
                (-score, handle.base + local, handle, local, score, _NO_SORT)
            )

    def _fetch_source(
        self, handle: SegmentHandle, local: int, request: SearchRequest
    ) -> dict[str, Any] | None:
        if request.source_includes is False:
            return None
        src = handle.segment.sources[local]
        if request.source_includes is True:
            return src
        keep = set(request.source_includes)
        return {k: v for k, v in src.items() if k in keep}



def _plan(handle: SegmentHandle, compiled: CompiledQuery):
    """A compiled plan's arrays on the segment's device."""
    return bm25_device.plan_to_torch(
        compiled.spec, compiled.arrays, handle.device.device
    )


def _host(t) -> np.ndarray:
    """A device result as numpy (one device -> host copy)."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _owned_plane(plane: torch.Tensor) -> torch.Tensor:
    """A plane the filter cache may keep: a contiguous tensor that owns
    its memory (a view of a kernel output or of a segment plane would pin
    that buffer, and evicting it would free nothing)."""
    return plane.clone(memory_format=torch.contiguous_format)
