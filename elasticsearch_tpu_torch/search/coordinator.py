"""Cross-shard search coordination: scatter, merge, reduce.

Port of elasticsearch_tpu/search/coordinator.py, trimmed to
`ShardedSearchCoordinator` with `_shard_can_match`, `global_stats`,
`search` (which validates the sort up front, as the shards would),
`search_many`, `_scatter_merge` and `_merge_key` (the merge by
`sort_merge_key`, so field sorts, multi-key sorts, `{"_score": "asc"}`
and rescored hits merge as the reference merges them, each hit with its
`sort` values). A request's `search_after` / `after_doc` reach every
shard as they are; each shard's service makes `after_doc` local through
its segments' `handle.base`. A `knn` request is validated on the
first shard, each shard returns up to k candidates and the merge keeps
the global k (the reference's kNN reduce); a batched knn group serves
each rider through `search`. Aggregations run as one Aggregator over
every shard's pinned handles with the global statistics, and the
per-shard requests carry none (the reference's coordinator:228-247).
`search` first consults the index's mesh view (`mesh_view`,
parallel/mesh_serving.MeshView, installed by the node when the shards
fit its mesh devices) and keeps its answer when it is not None; a
declined request takes the host loop below (the reference's
coordinator:198-215). The node's filter cache (index/filter_cache.py)
counts one admission sighting per user request, recorded here before the
mesh attempt; the mesh consult and every per-shard pass (`search`'s
scatter and `search_many`'s batched passes) get
`record_filter_usage=False` and the collected entries, so an n-shard
request is one sighting, not n. Left out: scroll contexts, fetch
sub-phases (highlight, fields), tasks and timeouts, tracing and injected
faults.

The single-process analog of the reference's coordinator node path —
AbstractSearchAsyncAction fans per-shard query-phase requests out and
SearchPhaseController.merge reduces per-shard top docs
(action/search/AbstractSearchAsyncAction.java:280,
action/search/SearchPhaseController.java:398). Here the "transport" is a
direct call into each shard's SearchService; the merge keeps the same
contract: per-shard top-(from+size), merged by (sort key, shard index,
per-shard rank), then paged.

Statistics: the coordinator aggregates term statistics across every
shard's segments, nested inner fields included, and pushes them down
(the DFS phase, always on), so scores are independent of routing. An
`ids` query compiles on every shard against that shard's own `_id`
index, so each shard marks the ids it holds.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import TYPE_CHECKING

from ..query.compile import aggregate_field_stats
from .service import (
    SearchHit,
    SearchRequest,
    SearchResponse,
    SearchService,
    clamp_total,
    sort_merge_key,
)

if TYPE_CHECKING:
    from ..index.engine import Engine


class SearchPhaseFailedError(Exception):
    """Every shard a request ran on failed (the node answers HTTP 503)."""

    def __init__(self, message: str, failures: list[dict]):
        super().__init__(message)
        self.failures = failures


class ShardedSearchCoordinator:
    """Serves search requests over N shard engines of one index."""

    def __init__(
        self, engines: list["Engine"], index_name: str = "index", planner=None,
        ann_cache=None, filter_cache=None,
    ):
        self.engines = engines
        self.index_name = index_name
        # The node-wide filter cache: every shard's service keys its
        # planes into the one store.
        self.filter_cache = filter_cache
        self.services = [
            SearchService(e, planner=planner, ann_cache=ann_cache,
                          index_name=index_name, filter_cache=filter_cache)
            for e in engines
        ]
        self._stats_cache = None
        self._stats_gen: tuple = ()
        # The mesh serving path (parallel/mesh_serving.MeshView), set by
        # the node when the index's shards fit its mesh devices.
        self.mesh_view = None

    def _shard_can_match(self, request, shard_idx: int, snapshots) -> bool:
        from .can_match import can_match, shard_bounds

        if request.query is None:
            return True
        return can_match(
            request.query,
            shard_bounds(snapshots[shard_idx]),
            self.engines[shard_idx].mappings,
        )

    def global_stats(self, snapshots: list[list] | None = None):
        """Index-wide statistics across all shards' segments, cached per
        engine refresh generation."""
        gen = tuple(e.generation for e in self.engines)
        if self._stats_cache is None or gen != self._stats_gen:
            if snapshots is None:
                snapshots = [list(e.segments) for e in self.engines]
            self._stats_cache = aggregate_field_stats(
                [h.segment for snap in snapshots for h in snap]
            )
            self._stats_gen = gen
        return self._stats_cache

    def _check_failed(self, failures: list, skipped: int) -> None:
        """Every executed shard failing fails the whole request."""
        if failures and len(failures) >= len(self.engines) - skipped:
            raise SearchPhaseFailedError(
                f"all shards failed for [{self.index_name}]", failures
            )

    def _shard_failure_entry(self, shard_idx: int, e: Exception) -> dict:
        return {
            "shard": shard_idx,
            "index": self.index_name,
            "node": "local",
            "reason": {"type": type(e).__name__, "reason": str(e)},
        }

    def search(
        self, request: SearchRequest, record_filter_usage: bool = True,
    ) -> SearchResponse:
        """One user request: the mesh view's answer when it serves it,
        else the host loop's scatter and merge. `record_filter_usage=
        False` (the batcher's solo retry) records no filter-cache
        sighting."""
        from ..index.filter_cache import (
            record_filter_usage as _record_filter_usage,
            record_knn_filter_usage,
        )

        # One admission sighting per user request, recorded before the
        # mesh attempt so that neither outcome counts twice.
        fc_entries = _record_filter_usage(
            self.filter_cache, request.query, record=record_filter_usage
        )
        record_knn_filter_usage(
            self.filter_cache, request.knn, record=record_filter_usage
        )
        if self.mesh_view is not None:
            resp = self.mesh_view.serve(self, request, fc_entries=fc_entries)
            if resp is not None:
                return resp
        start = time.monotonic()
        # One segment snapshot per shard, pinned for the whole request.
        snapshots = [list(e.segments) for e in self.engines]
        stats = self.global_stats(snapshots)
        self.services[0]._validate_sort(request)
        self.services[0]._validate_knn(request)
        k = max(0, request.from_) + max(0, request.size)
        aggregations = None
        agg_total = None
        if request.aggs is not None:
            # One Aggregator over every shard's pinned handles, with the
            # global statistics: the shards' agg states merge by key in
            # one reduce, and the per-shard requests carry no aggs.
            from .aggs import Aggregator

            agg_total, aggregations = Aggregator(
                self.engines[0], request.aggs,
                handles=[h for snap in snapshots for h in snap],
                index_name=self.index_name,
            ).run(request.query, stats=stats)
        shard_request = replace(
            request, from_=0, size=k, aggs=None, track_total_hits=True
        )
        if k > 0 or agg_total is None:
            merged, total, max_score, skipped, failures = self._scatter_merge(
                shard_request, stats, snapshots, fc_entries
            )
        else:
            merged, total, max_score, skipped, failures = [], 0, None, 0, []
        self._check_failed(failures, skipped)
        if agg_total is not None:
            total = agg_total
        if request.knn is not None:
            # Global top-k reduce: shards contribute up to k candidates
            # each; the merge keeps k.
            merged = merged[: request.knn.k]
        page = merged[request.from_ : request.from_ + request.size]
        total_out, relation = clamp_total(total, request.track_total_hits)
        return SearchResponse(
            took_ms=int((time.monotonic() - start) * 1000),
            total=total_out,
            total_relation=relation,
            max_score=max_score,
            hits=[hit for _, _, _, hit in page],
            aggregations=aggregations,
            shards=len(self.engines),
            skipped=skipped,
            failed=len(failures),
        )

    def search_many(self, requests: list) -> list:
        """Serve several PLAIN searches with per-shard coalesced launches.

        The micro-batcher's group executor for sharded indices: the
        scatter loop runs once per shard with ALL requests riding one
        padded launch per (segment, spec group) — N concurrent searches
        cost one shard sweep instead of N. Merge semantics are identical
        to search(): per-shard top-(from+size) by (score desc, doc asc),
        merged by (score, shard, rank), then paged; can_match still
        pre-filters shards per request. Returns one SearchResponse (or
        Exception) per request."""
        if any(r.knn is not None for r in requests):
            # kNN groups coalesce only on one-shard services; a sharded
            # rider serves through the scatter/merge path, result-identical,
            # its error returned as its result.
            out: list = []
            for r in requests:
                try:
                    out.append(self.search(r))
                except Exception as e:  # noqa: BLE001 - per-rider result
                    out.append(e)
            return out
        from ..index.filter_cache import record_filter_usage

        start = time.monotonic()
        n = len(requests)
        # One filter-cache sighting per rider, not per shard; the entries
        # thread through every shard's batched pass.
        fc_entries = [
            record_filter_usage(self.filter_cache, r.query) for r in requests
        ]
        snapshots = [list(e.segments) for e in self.engines]
        stats = self.global_stats(snapshots)
        ks = [max(0, r.from_) + max(0, r.size) for r in requests]
        per_shard: list[list[list]] = []  # [shard][request] -> candidates
        totals = [0] * n
        errors: list[Exception | None] = [None] * n
        skipped = [0] * n
        shard_failures: list[list[dict]] = [[] for _ in range(n)]
        for shard_idx, svc in enumerate(self.services):
            rows = [
                i
                for i in range(n)
                if errors[i] is None
                and self._shard_can_match(requests[i], shard_idx, snapshots)
            ]
            for i in range(n):
                if errors[i] is None and i not in rows:
                    skipped[i] += 1
            shard_cands: list[list] = [[] for _ in range(n)]
            per_shard.append(shard_cands)
            if not rows:
                continue
            try:
                cands, tot, errs = svc._batched_query_phase(
                    [requests[i] for i in rows],
                    [ks[i] for i in rows],
                    stats,
                    snapshots[shard_idx],
                    record_filter_usage=False,
                    fc_entries=[fc_entries[i] for i in rows],
                )
            except (ValueError, TypeError):
                raise
            # Shard-level failure on the coalesced path: every rider
            # records a per-shard failure, never a whole-batch poison.
            except Exception as e:  # noqa: BLE001
                entry = self._shard_failure_entry(shard_idx, e)
                for i in rows:
                    shard_failures[i].append(entry)
                continue
            for pos, i in enumerate(rows):
                shard_cands[i] = cands[pos]
                totals[i] += tot[pos]
                if errs[pos] is not None:
                    errors[i] = errs[pos]
        out: list = []
        svc0 = self.services[0]
        for i, request in enumerate(requests):
            if errors[i] is not None:
                out.append(errors[i])
                continue
            try:
                self._check_failed(shard_failures[i], skipped[i])
            except SearchPhaseFailedError as e:
                out.append(e)
                continue
            merged: list[tuple] = []
            max_score = None
            for shard_idx in range(len(self.services)):
                rows = sorted(
                    per_shard[shard_idx][i], key=lambda c: (c[0], c[1])
                )[: ks[i]]
                if rows:
                    top = -rows[0][0]
                    max_score = (
                        top if max_score is None else max(max_score, top)
                    )
                for rank, c in enumerate(rows):
                    merged.append((c[0], shard_idx, rank, c))
            merged.sort(key=lambda t: (t[0], t[1], t[2]))
            page = merged[request.from_ : request.from_ + request.size]
            hits = []
            for _key, _shard, _rank, c in page:
                _, global_doc, handle, local, score, _sv = c
                hits.append(
                    SearchHit(
                        doc_id=handle.segment.ids[local],
                        score=score,
                        source=svc0._fetch_source(handle, local, request),
                        global_doc=global_doc,
                    )
                )
            total_out, relation = clamp_total(
                totals[i], request.track_total_hits
            )
            out.append(
                SearchResponse(
                    took_ms=int((time.monotonic() - start) * 1000),
                    total=total_out,
                    total_relation=relation,
                    max_score=max_score,
                    hits=hits,
                    shards=len(self.engines),
                    skipped=skipped[i],
                    failed=len(shard_failures[i]),
                )
            )
        return out

    def _scatter_merge(
        self, request: SearchRequest, stats, snapshots: list[list],
        fc_entries: list | None = None,
    ) -> tuple[list[tuple], int, float | None, int, list[dict]]:
        """Fan one request out to every shard and merge by
        (merge key, shard, per-shard rank). Returns (sorted merged tuples,
        total, max_score, skipped, failures). A shard whose scoring pass
        raises a non-request-shaped error is recorded in `failures` and
        the scatter continues: merged hits stay a correct subset because
        scores ride the pushed-down global statistics."""
        merged: list[tuple] = []
        total = 0
        max_score = None
        skipped = 0
        failures: list[dict] = []
        for shard_idx, svc in enumerate(self.services):
            # can_match pre-filter: skip shards whose numeric bounds
            # provably exclude the query (they contribute zero hits).
            if not self._shard_can_match(request, shard_idx, snapshots):
                skipped += 1
                continue
            try:
                resp = svc.search(
                    request, stats=stats, segments=snapshots[shard_idx],
                    record_filter_usage=False, fc_entries=fc_entries,
                )
            except (ValueError, TypeError):
                raise  # request-shaped: never "a shard died"
            except Exception as e:  # noqa: BLE001
                failures.append(self._shard_failure_entry(shard_idx, e))
                continue
            total += resp.total or 0
            if resp.max_score is not None:
                max_score = (
                    resp.max_score
                    if max_score is None
                    else max(max_score, resp.max_score)
                )
            for rank, hit in enumerate(resp.hits):
                merged.append(
                    (self._merge_key(request, hit), shard_idx, rank, hit)
                )
        merged.sort(key=lambda t: (t[0], t[1], t[2]))
        return merged, total, max_score, skipped, failures

    @staticmethod
    def _merge_key(request: SearchRequest, hit):
        """Merge key matching the shard-local ordering contract: a scalar
        for score/single-key sorts, a tuple for multi-key sorts, with
        missing values placed per each key's missing directive."""
        return sort_merge_key(request, hit.score, hit.sort)
