"""Packed multi-tenant execution: one launch scores many small indices.

Port of elasticsearch_tpu/exec/packed.py, trimmed to this slice:
`packed_query_eligible`, `TenantSearch`, `_Unpackable` and
`PackedExecutor` (`eligible`, `wrap`, `search`, `_solo`, `search_many`,
`_compile_lane`, `_execute_lanes`, `_packed_launch`, `_ensure_plane` and
`stats`), with the reference's limits (MAX_TENANT_DOCS, MAX_PLANE_DOCS),
plane admission and rebuild rule. Left out, each with the ROADMAP queue
item that brings it: the planner's oracle backend (`_decide`,
`_oracle_rows`: every bucket runs packed until A3 brings
search/oracle.py), `retune` (remediation, A13), the HBM ledger (A6), the
metrics registry (A12: `stats()` keeps plain counters), tasks and
cancellation (A8), the QoS `lane_key` (A8), demoted engines, injected
faults and the device instruments. `search_many` records each rider's one
filter-cache sighting at entry (the packed kernel recomputes filters; a
rider that falls back to its own service records nothing more), and
`search` takes the batcher's `record_filter_usage`.

Small one-shard indices share ONE searcher facade, so the micro-batcher's
group key (`("_packed", query shape)`) coalesces concurrent searches on
DIFFERENT indices, and a coalesced batch runs as one
`ops/bm25_device.execute_batch_packed` launch per spec bucket over one
packed plane (index/tiles.py PackedPlane):

1. the plane: every known packable tenant's refreshed segments
   concatenated on the device (cached; rebuilt when a member's engine
   generation moves or a new tenant appears; this batch's tenants are
   admitted first, then the idle ones, each set in uuid order, under
   MAX_PLANE_DOCS);
2. each rider compiles against its tenant's member views: plans land in
   packed coordinates with the tenant's OWN statistics, so its scores are
   bit-identical to its solo execution;
3. lanes group by spec, and `exec.batcher.plan_spec_buckets` merges
   same-family groups across tenants when the padding they pay costs less
   than the launch they save (`exec.cost.coalesce_wins`);
4. one launch per bucket, each lane masked to its tenant's [lo, hi) doc
   range (K2b's bounds mode, K3b's window mode);
5. responses assemble through each tenant's own SearchService.

Packing never changes results: per tenant, ids, order, fp32 scores and
totals equal the solo path's. A lone rider takes the solo path (nothing
to amortize); a rider the plane refuses (an unpackable compiled spec, a
tenant without segments, a plane over budget) runs solo and is counted
in `fallback_solo`. A failed launch fails its bucket's riders with the
launch's error; the executor never reruns them solo itself.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np

from ..index.tiles import pack_segments_packed, packed_device_nbytes
from ..ops import bm25_device
from ..query.compile import (
    CompiledQuery,
    Compiler,
    pad_arrays_to_spec,
    unify_specs,
)
from ..query.dsl import (
    BoolQuery,
    ConstantScoreQuery,
    MatchNoneQuery,
    MatchQuery,
    Query,
    TermQuery,
    TermsQuery,
)
from ..search.service import SearchService
from .batcher import plan_spec_buckets

# Query leaves that lower to pure inverted-postings plans (the plane holds
# only postings planes). A term query on a NUMERIC field compiles to a
# doc-values range, which the plane cannot serve: field types are checked.
_PACKED_LEAVES = (MatchQuery, TermQuery, TermsQuery)
_PACKED_FIELD_TYPES = ("text", "keyword")


def packed_query_eligible(query: Query, mappings) -> bool:
    """May this query compile against a packed plane's views? True only
    for trees of inverted-field term shapes (match / term / terms and
    bool / constant_score combinations of them)."""
    if isinstance(query, BoolQuery):
        return all(
            packed_query_eligible(c, mappings)
            for c in (list(query.must) + list(query.should)
                      + list(query.filter) + list(query.must_not))
        )
    if isinstance(query, ConstantScoreQuery):
        return packed_query_eligible(query.filter, mappings)
    if isinstance(query, MatchNoneQuery):
        return True
    if isinstance(query, _PACKED_LEAVES):
        fm = mappings.get(query.field_name)
        return fm is not None and fm.type in _PACKED_FIELD_TYPES
    return False


class TenantSearch:
    """One rider of the shared packed group: (index service, request)."""

    __slots__ = ("svc", "request")

    def __init__(self, svc, request):
        self.svc = svc
        self.request = request


class _Unpackable(Exception):
    """A lane's compiled spec cannot ride the plane (solo fallback)."""


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class PackedExecutor:
    """Node-level packed multi-tenant searcher facade.

    Passed to MicroBatcher.execute as the `searcher` of every packable
    search, so the batcher's `(id(searcher), group_key)` group coalesces
    across indices; implements the searcher contract the batcher relies
    on (`search`, `search_many`)."""

    # Per-tenant doc ceiling: beyond it the launch cost no longer
    # dominates and the tenant's own path wins anyway.
    MAX_TENANT_DOCS = 65_536
    # Plane doc budget: past it the plane stops admitting tenants (the
    # plane duplicates its members' postings on the device).
    MAX_PLANE_DOCS = 4_000_000

    def __init__(self):
        self.max_plane_docs = int(self.MAX_PLANE_DOCS)
        self._lock = threading.Lock()
        # Known packable tenants (weak: a deleted index is neither kept
        # alive nor packed into the next plane).
        self._tenants: "weakref.WeakValueDictionary[str, object]" = (
            weakref.WeakValueDictionary()
        )
        self._plane = None
        self._plane_tree = None
        self._plane_key = None
        self._plane_nbytes = 0
        # uuid -> [(member index, SegmentHandle)] of the current plane.
        self._member_rows: dict[str, list] = {}
        # Plain counters (under _lock).
        self._launches = 0
        self._lanes = 0
        self._rebuilds = 0
        self._rebuild_s = 0.0
        self._fallbacks = 0
        self._tenants_max = 0
        self._lanes_max = 0
        self._tenants_hist: dict[int, int] = {}
        self._lanes_hist: dict[int, int] = {}

    # -------------------------------------------------------- eligibility

    def eligible(self, svc, request) -> bool:
        """May this (index, request) ride the packed group? One-shard small
        indices served by a SearchService (`assemble_plain`) with
        inverted-only query shapes; the node's `_batchable` has already
        excluded aggregations, sorts, rescores and cursors."""
        if len(svc.engines) != 1:
            return False
        if getattr(request, "knn", None) is not None:
            return False
        if not hasattr(svc.search, "assemble_plain"):
            return False
        if svc.num_docs > self.MAX_TENANT_DOCS:
            return False
        if getattr(request, "search_after", None) is not None:
            return False
        return packed_query_eligible(request.query, svc.mappings)

    def wrap(self, svc, request) -> TenantSearch:
        return TenantSearch(svc, request)

    # ---------------------------------------------- searcher facade (batcher)

    def search(self, wrapped: TenantSearch, record_filter_usage: bool = True):
        """Solo / quarantine / retry path: the tenant's own service."""
        return wrapped.svc.search.search(
            wrapped.request, record_filter_usage=record_filter_usage
        )

    def _solo(self, wrapped: TenantSearch, fallback: bool = True):
        """Per-tenant execution inside a coalesced batch: the response or
        the error the solo path gives. `fallback` counts riders the plane
        REFUSED, not a batch of one (the idle path). search_many has
        counted the rider's filter-cache sighting already."""
        if fallback:
            with self._lock:
                self._fallbacks += 1
        try:
            return self.search(wrapped, record_filter_usage=False)
        # The batcher contract: one result or exception per rider; a
        # rider's own error must not fail its batchmates.
        except Exception as e:  # noqa: BLE001
            return e

    def search_many(self, wrapped: list) -> list:
        """Serve a coalesced cross-tenant batch: one SearchResponse (or
        Exception) per rider, each equal to the rider's solo response."""
        from ..index.filter_cache import record_filter_usage

        start = time.monotonic()
        n = len(wrapped)
        # One filter-cache sighting per rider, counted here so the tally
        # is the same whether a rider runs on the packed kernel or falls
        # back to its own service.
        for w in wrapped:
            record_filter_usage(
                getattr(w.svc.search, "filter_cache", None), w.request.query
            )
        if n == 1:
            return [self._solo(wrapped[0], fallback=False)]
        plane_info = self._ensure_plane([w.svc for w in wrapped])
        if plane_info is None:
            return [self._solo(w) for w in wrapped]
        plane, tree, member_rows = plane_info
        cands: list[list] = [[] for _ in range(n)]
        totals = [0] * n
        errors: list[Exception | None] = [None] * n
        solo: set[int] = set()
        ks = [0] * n
        lanes: list[tuple] = []  # (rider, member, handle, CompiledQuery)
        for i, w in enumerate(wrapped):
            rows = member_rows.get(w.svc.uuid)
            if rows is None:
                solo.add(i)
                continue
            ks[i] = max(0, w.request.from_) + max(0, w.request.size)
            engine = w.svc.engines[0]
            stats = engine.field_stats()
            mine: list[tuple] = []
            try:
                for member, handle in rows:
                    compiled = self._compile_lane(plane, member, w, engine,
                                                  stats)
                    mine.append((i, member, handle, compiled))
            except ValueError as e:
                errors[i] = e  # request-shaped: the solo path 400s too
                continue
            except _Unpackable:
                solo.add(i)
                continue
            lanes.extend(mine)
        self._execute_lanes(plane, tree, wrapped, lanes, ks, cands, totals,
                            errors)
        out: list = [None] * n
        for i, w in enumerate(wrapped):
            if errors[i] is not None:
                out[i] = errors[i]
            elif i in solo:
                out[i] = self._solo(w)
            else:
                out[i] = w.svc.search.assemble_plain(
                    w.request, cands[i], totals[i], start
                )
        return out

    # ----------------------------------------------------------- internals

    def _compile_lane(self, plane, member, wrapped, engine, stats):
        """Compile one rider's query against one member's packed views:
        the tenant's own term dictionary, statistics and impacts with the
        posting offsets shifted into plane coordinates, so the standard
        Compiler emits the solo plan, relocated."""
        compiled = Compiler(
            fields=plane.member_fields(member),
            doc_values={},
            mappings=wrapped.svc.mappings,
            params=engine.params,
            stats=stats,
        ).compile(wrapped.request.query)
        if not bm25_device.supports_packed(compiled.spec):
            raise _Unpackable()
        return compiled

    def _execute_lanes(self, plane, tree, wrapped, lanes, ks, cands, totals,
                       errors) -> None:
        """Bucket lanes by spec (cross-tenant coalescing under the cost
        rule) and run one packed launch per bucket."""
        groups: dict[tuple, list[int]] = {}
        for idx, (_i, _m, _h, compiled) in enumerate(lanes):
            groups.setdefault(compiled.spec, []).append(idx)
        buckets: list[tuple[tuple, list[int]]] = []
        for bucket_specs in plan_spec_buckets(
            [(spec, len(idxs)) for spec, idxs in groups.items()]
        ):
            target = unify_specs(list(bucket_specs))
            members: list[int] = []
            for spec in bucket_specs:
                for idx in groups[spec]:
                    if spec != target:
                        i, m, h, c = lanes[idx]
                        lanes[idx] = (i, m, h, CompiledQuery(
                            spec=target,
                            arrays=pad_arrays_to_spec(c.spec, target,
                                                      c.arrays),
                        ))
                    members.append(idx)
            buckets.append((target, members))
        for spec, idxs in buckets:
            rows = [lanes[idx] for idx in idxs if errors[lanes[idx][0]] is None]
            if not rows:
                continue
            try:
                self._packed_launch(plane, tree, spec, rows, wrapped, ks,
                                    cands, totals)
            except (ValueError, TypeError) as e:
                # Request-shaped (a k past K3's window, say): only the
                # riders that cause it may fail, so a coalesced bucket
                # runs its lanes one at a time.
                if len(rows) == 1:
                    errors[rows[0][0]] = e
                    continue
                for r in rows:
                    if errors[r[0]] is not None:
                        continue
                    try:
                        self._packed_launch(plane, tree, spec, [r], wrapped,
                                            ks, cands, totals)
                    except Exception as e_row:  # noqa: BLE001
                        errors[r[0]] = e_row
            # A failed build or launch fails this bucket's riders only,
            # with the launch's own error.
            except Exception as e:  # noqa: BLE001
                for r in rows:
                    errors[r[0]] = e

    def _packed_launch(self, plane, tree, spec, rows, wrapped, ks, cands,
                       totals) -> None:
        """One launch scoring every lane of one spec bucket."""
        k_max = max(ks[r[0]] for r in rows)
        arrays = bm25_device.plan_to_torch(
            spec, bm25_device.stack_plans([r[3].arrays for r in rows]),
            plane.live.device,
        )
        bounds = np.array([plane.member_bounds(r[1]) for r in rows],
                          dtype=np.int32).reshape(-1, 2)
        s_b, i_b, t_b = bm25_device.execute_batch_packed(
            tree, spec, arrays, bounds[:, 0], bounds[:, 1], k_max
        )
        s_b, i_b, t_b = s_b.cpu().numpy(), i_b.cpu().numpy(), t_b.cpu().numpy()
        n_tenants = len({wrapped[r[0]].svc.uuid for r in rows})
        with self._lock:
            self._launches += 1
            self._lanes += len(rows)
            self._tenants_max = max(self._tenants_max, n_tenants)
            self._lanes_max = max(self._lanes_max, len(rows))
            tb, lb = _pow2(n_tenants), _pow2(len(rows))
            self._tenants_hist[tb] = self._tenants_hist.get(tb, 0) + 1
            self._lanes_hist[lb] = self._lanes_hist.get(lb, 0) + 1
        for row, (i, _member, handle, _compiled) in enumerate(rows):
            tot = int(t_b[row])
            nn = min(ks[i], tot, s_b.shape[1])
            SearchService._append_plain(cands[i], handle, s_b[row], i_b[row],
                                        nn)
            totals[i] += tot

    # ------------------------------------------------------------- plane

    def _ensure_plane(self, svcs):
        """(plane, executor tree, member rows) covering every known
        packable tenant, rebuilt only when a member's engine generation
        moved (refresh, delete) or a new tenant appeared. None: this
        batch's tenants do not fit the budget."""
        current = {svc.uuid for svc in svcs}
        with self._lock:
            for svc in svcs:
                self._tenants[svc.uuid] = svc
            # Budget admission, ACTIVE riders first: this batch's tenants
            # claim the plane before idle ones, so a long tail of idle
            # tenants never crowds an active rider out. Member order stays
            # uuid-sorted over the admitted set, so the cache key is stable
            # across batches with the same admitted set.
            admitted: dict[str, tuple] = {}
            total_docs = 0
            ordered = sorted(
                self._tenants.keys(), key=lambda u: (u not in current, u)
            )
            for uuid in ordered:
                svc = self._tenants.get(uuid)
                if svc is None or len(svc.engines) != 1:
                    continue
                engine = svc.engines[0]
                handles = [
                    h for h in engine.segments if h.segment.num_docs > 0
                ]
                docs = sum(h.device.num_docs for h in handles)
                if total_docs + docs > self.max_plane_docs:
                    if uuid in current:
                        return None  # an active rider does not fit
                    continue  # an idle tenant sits this plane out
                total_docs += docs
                admitted[uuid] = (svc, engine.generation, handles)
            snapshot = [(uuid,) + admitted[uuid] for uuid in sorted(admitted)]
            key = tuple((u, g) for u, _s, g, _h in snapshot)
            if key == self._plane_key and self._plane is not None:
                return self._plane, self._plane_tree, self._member_rows
        # Build outside the lock: stats() and other batches need not wait
        # for it. The snapshot's handles pin the segments, so the plane is
        # one consistent view (the last install wins; this batch serves
        # from the plane it built).
        t0 = time.monotonic()
        segs = []
        member_rows: dict[str, list] = {}
        for uuid, _svc, _gen, handles in snapshot:
            member_rows[uuid] = []
            for h in handles:
                member_rows[uuid].append((len(segs), h))
                segs.append(h.device)
        if not segs:
            return None
        plane = pack_segments_packed(segs)
        tree = bm25_device.packed_segment_tree(plane)
        nbytes = packed_device_nbytes(plane)
        with self._lock:
            self._plane = plane
            self._plane_tree = tree
            self._plane_key = key
            self._member_rows = member_rows
            self._plane_nbytes = nbytes
            self._rebuilds += 1
            self._rebuild_s += time.monotonic() - t0
        return plane, tree, member_rows

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Plain counters: launches, lanes, plane rebuilds (and their host
        seconds), solo fallbacks, the plane's docs, bytes and members, and
        tenants / lanes per launch (max, mean and pow-2 histograms)."""
        with self._lock:
            plane = self._plane
            launches = self._launches
            return {
                "launches": launches,
                "lanes": self._lanes,
                "lanes_per_launch_mean": (
                    self._lanes / launches if launches else 0.0
                ),
                "lanes_per_launch_max": self._lanes_max,
                "tenants_per_launch_max": self._tenants_max,
                "lanes_per_launch": {
                    str(b): c for b, c in sorted(self._lanes_hist.items())
                },
                "tenants_per_launch": {
                    str(b): c for b, c in sorted(self._tenants_hist.items())
                },
                "plane_rebuilds": self._rebuilds,
                "plane_rebuild_s": self._rebuild_s,
                "fallback_solo": self._fallbacks,
                "plane_docs": plane.num_docs if plane is not None else 0,
                "max_plane_docs": int(self.max_plane_docs),
                "plane_bytes": int(self._plane_nbytes),
                "plane_tenants": len(self._member_rows),
                "plane_members": sum(
                    len(v) for v in self._member_rows.values()
                ),
            }
