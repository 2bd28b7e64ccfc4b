"""Shard-level search: query phase over device segments + fetch.

Port of elasticsearch_tpu/search/service.py, trimmed to this slice:
`SearchRequest.from_json` for `query`, `from`, `size`, `track_total_hits`
and `_source`; `SearchService.search` as the plain score-sorted loop over
segments with the candidate merge and the `_source` fetch; and the hot
branch of `_query_segment` (compile, `execute_auto`, collect). Every
segment runs on the port's device path: there is no planner, CPU-oracle
routing, batcher, filter cache, rescore, sort, cursor, aggregation or
knn; a request asking for one of those is refused with a 400.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from ..index.engine import Engine, SegmentHandle
from ..ops import bm25_device
from ..query.compile import FieldStats
from ..query.dsl import MatchAllQuery, Query, parse_query


@dataclass
class SearchHit:
    doc_id: str
    score: float | None
    source: dict[str, Any] | None

    def to_json(self, index_name: str = "index") -> dict[str, Any]:
        out: dict[str, Any] = {
            "_index": index_name,
            "_id": self.doc_id,
            "_score": self.score,
        }
        if self.source is not None:
            out["_source"] = self.source
        return out


@dataclass
class SearchResponse:
    took_ms: int
    total: int | None  # None = untracked (track_total_hits: false)
    total_relation: str
    max_score: float | None
    hits: list[SearchHit]
    shards: int = 1
    timed_out: bool = False

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
        return {
            "took": self.took_ms,
            "timed_out": self.timed_out,
            "_shards": {
                "total": self.shards,
                "successful": self.shards,
                "skipped": 0,
                "failed": 0,
            },
            "hits": hits_obj,
        }


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
class SearchRequest:
    query: Query = field(default_factory=MatchAllQuery)
    size: int = 10
    from_: int = 0
    source_includes: bool | list[str] = True
    # True = exact, False = untracked, int = exact up to the threshold.
    track_total_hits: bool | int = 10_000

    KNOWN_KEYS = frozenset(
        {"query", "from", "size", "track_total_hits", "_source"}
    )

    @classmethod
    def from_json(cls, body: dict[str, Any] | None) -> "SearchRequest":
        body = body or {}
        unknown = set(body) - cls.KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown key [{sorted(unknown)[0]}] in the search request"
            )
        query = (
            parse_query(body["query"]) if "query" in body else MatchAllQuery()
        )
        source = body.get("_source", True)
        if isinstance(source, str):  # a single field name
            source = [source]
        tth = body.get("track_total_hits", 10_000)
        if not isinstance(tth, bool):
            tth = int(tth)
        return cls(
            query=query,
            size=int(body.get("size", 10)),
            from_=int(body.get("from", 0)),
            source_includes=source,
            track_total_hits=tth,
        )


class SearchService:
    """Executes SearchRequests against one Engine (one shard)."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def search(
        self,
        request: SearchRequest,
        stats: dict[str, FieldStats] | None = None,
    ) -> SearchResponse:
        start = time.monotonic()
        k = max(0, request.from_) + max(0, request.size)
        if stats is None:
            stats = self.engine.field_stats()
        segments = list(self.engine.segments)
        # Candidate tuples (merge_key, global_doc, handle, local, score):
        # merge_key ascending, then global doc id ascending, is Lucene's
        # order for the score sort (key = -score).
        candidates: list[tuple] = []
        total = 0
        for handle in segments:
            if handle.segment.num_docs == 0:
                continue
            total += self._query_segment(handle, request, k, stats, candidates)
        candidates.sort(key=lambda c: (c[0], c[1]))
        page = candidates[request.from_ : request.from_ + request.size]
        max_score = -candidates[0][0] if candidates else None
        hits = [
            SearchHit(
                doc_id=handle.segment.ids[local],
                score=score,
                source=self._fetch_source(handle, local, request),
            )
            for _key, _global_doc, handle, local, score in page
        ]
        total_out, relation = clamp_total(total, request.track_total_hits)
        return SearchResponse(
            took_ms=int((time.monotonic() - start) * 1000),
            total=total_out,
            total_relation=relation,
            max_score=max_score,
            hits=hits,
        )

    def _query_segment(
        self,
        handle: SegmentHandle,
        request: SearchRequest,
        k: int,
        stats: dict[str, FieldStats],
        candidates: list,
    ) -> int:
        """Score one segment on the device, appending candidate tuples;
        returns the segment's total hits."""
        compiled = self.engine.compiler_for(handle, stats).compile(request.query)
        seg_tree = bm25_device.segment_tree(handle.device)
        plan = bm25_device.plan_to_torch(
            compiled.spec, compiled.arrays, handle.device.device
        )
        scores, ids, tot = bm25_device.execute_auto(
            seg_tree, compiled.spec, plan, k
        )
        # One device -> host transfer of the k hits and the total.
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy()
        tot = int(tot.cpu())
        n = min(k, tot, len(ids))
        for rank in range(n):
            score = float(scores[rank])
            local = int(ids[rank])
            candidates.append((-score, handle.base + local, handle, local, score))
        return tot

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

