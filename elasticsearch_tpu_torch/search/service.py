"""Shard-level search: query phase over device segments + fetch.

Port of elasticsearch_tpu/search/service.py, trimmed to this slice:
`SearchRequest.from_json` for `query`, `from`, `size`, `track_total_hits`
and `_source`; `SearchService.search` as the plain score-sorted loop over
segments with the candidate merge and the `_source` fetch; the hot branch
of `_query_segment` (compile, `execute_auto`, collect); and the batched
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
execution's time. Left out: CPU-oracle routing (and with it any planner
decision on the batched path), the filter cache (a batch's mask token is
always `()`), tasks and timeouts, rescore, sort, cursor, aggregation and
knn; a request asking for one of those is refused with a 400.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from ..exec.cost import PlanFeatures
from ..exec.planner import spec_work_tiles
from ..index.engine import Engine, SegmentHandle
from ..ops import bm25_device
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
        return {
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
    """Executes SearchRequests against one Engine (one shard). `planner`
    is the node's ExecPlanner (None: every segment runs on the device
    kernels)."""

    def __init__(self, engine: Engine, planner=None):
        self.engine = engine
        self.planner = planner

    def search(
        self,
        request: SearchRequest,
        stats: dict[str, FieldStats] | None = None,
        segments: list | None = None,
    ) -> SearchResponse:
        """One request, one device launch per segment. `stats` and
        `segments` are the coordinator's pushed-down statistics and pinned
        segment snapshot (default: this shard's own)."""
        start = time.monotonic()
        k = max(0, request.from_) + max(0, request.size)
        if stats is None:
            stats = self.engine.field_stats()
        if segments is None:
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
        """Score one segment on the backend the planner picks, appending
        candidate tuples; returns the segment's total hits (a lower bound
        on the block-max paths, whose requests do not track totals)."""
        compiled = self.engine.compiler_for(handle, stats).compile(request.query)
        seg_tree = bm25_device.segment_tree(handle.device)
        backend, plan_class = self._decide_backend(handle, request, compiled, k)
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
        if plan_class is not None:
            self.planner.record(
                plan_class, backend, time.monotonic() - kern_t0
            )
        n = min(k, tot, len(ids))
        for rank in range(n):
            score = float(scores[rank])
            local = int(ids[rank])
            candidates.append((-score, handle.base + local, handle, local, score))
        return tot

    def _decide_backend(
        self, handle: SegmentHandle, request: SearchRequest, compiled, k: int
    ) -> tuple[str, tuple | None]:
        """(backend, plan_class) for one plain score-sorted segment pass.

        The candidates are the backends that cannot change the top-k:
        block-max only when exact totals are not tracked (its totals are
        "gte"), and only for k >= 1 (its threshold is the k-th score)."""
        if self.planner is None:
            return "device", None
        spec = compiled.spec
        candidates = ["device"]
        if request.track_total_hits is False and k > 0:
            if spec[0] == "terms":
                candidates.append("blockmax")
            elif bm25_device.supports_blockmax_conj(spec):
                candidates.append("blockmax_conj")
        plan_class = self.planner.classify(spec, k)
        if len(candidates) == 1:
            return "device", plan_class
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

    # ------------------------------------------------- batched query phase

    def search_many(self, requests: list) -> list:
        """Serve several PLAIN searches with coalesced device launches.

        The micro-batcher's group executor: one padded launch per
        (segment, spec group) scores every request's lane at once instead
        of one launch per request. Returns one SearchResponse (or
        Exception) per request, result-identical to running each request
        through search() alone."""
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

    def _batched_query_phase(
        self,
        requests: list,
        ks: list[int],
        stats: dict[str, FieldStats],
        segments: list,
    ):
        """One coalesced scoring pass over this shard for N plain requests.

        Per segment, requests compile and group by spec (same-family term
        groups are re-bucketed to a common nt so they share ONE padded
        launch); each group executes as a single batched kernel call.
        Returns (candidates per request, totals, errors)."""
        n = len(requests)
        cands: list[list] = [[] for _ in range(n)]
        totals = [0] * n
        errors: list[Exception | None] = [None] * n
        alive = set(range(n))
        for handle in segments:
            if handle.segment.num_docs == 0 or not alive:
                continue
            seg_tree = bm25_device.segment_tree(handle.device)
            compiled: dict[int, CompiledQuery] = {}
            for i in sorted(alive):
                try:
                    compiled[i] = self.engine.compiler_for(
                        handle, stats
                    ).compile(requests[i].query)
                except ValueError as e:
                    errors[i] = e
                    alive.discard(i)
            # Group keys are (spec, mask token); the port has no filter
            # cache, so every token is ().
            groups: dict[tuple, list[int]] = {}
            for i, c in compiled.items():
                if i in alive:
                    groups.setdefault((c.spec, ()), []).append(i)
            groups = self._merge_term_groups(groups, compiled)
            for (spec, _token), rows in groups.items():
                # One padded launch per group at its largest k (the
                # reference may route a group to its CPU oracle; the port
                # has one backend).
                try:
                    self._device_batch(
                        handle, spec, rows, compiled, ks,
                        max(ks[i] for i in rows), cands, totals,
                        seg_tree=seg_tree,
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
        (bit-identical results, no recompile)."""
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
        seg_tree=None,
    ) -> None:
        """One padded device launch for a same-spec row group: the plans
        stack on the host and upload once (`stack_plans`), the batched
        executor runs every row, and the results come back in one device
        -> host copy per output."""
        if seg_tree is None:
            seg_tree = bm25_device.segment_tree(handle.device)
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
            bucket.append((-score, handle.base + local, handle, local, score))

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

