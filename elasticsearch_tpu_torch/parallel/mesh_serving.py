"""Mesh serving: REST `_search` on a multi-shard index as one mesh request.

Port of elasticsearch_tpu/parallel/mesh_serving.py. Kept:
`classify_mesh_error` and `MeshServingBreaker` (the serving path's
circuit breaker), `MeshIndex` (`serving_stats`, `pack_avgdls`,
`field_stats`, `_tn_avgdl`), `MeshView` (`_merged_segment`, `_schema`,
`_shapes_fit`, `_pack_shard`, `_assemble`, `_pin_engines`, `_ensure`,
`_fallback`, `ineligible_reason`, `eligible`, `_sort_plan`,
`_compile_aggs` and `serve`, with the reference's plain counters
`served`, `packs`, `seg_reuses`, `rebuilds`, `fallbacks` and
`exec_failures`) and `maybe_mesh_view`; and the filter cache's mesh rows:
`MeshIndex._apply_filter_cache` (row-granular), `MeshView(filter_cache=)`
with its `purge_scope` on a snapshot change, and `serve`'s consult of the
cache on the plain-score path. Left out, each with its ROADMAP item:
`pack_segment_delta` (A6), so a shard whose content moved repacks whole
with `pack_segment`, to the same pow-2 shapes, and answers are unchanged;
the metrics registry, tracing, the planner's `mesh_spmd` decisions and
the HBM ledger (A12); and the reference's environment switches
(ESTPU_MESH_SERVING, ESTPU_MESH_BREAKER_FAILURES,
ESTPU_MESH_BREAKER_COOLDOWN_S): `Node(mesh_devices=[])` turns the view
off, and the breaker takes its threshold and cooldown as arguments.

A multi-shard index whose shards fit the mesh serves its query phase
through parallel/sharded.py's bodies (each shard scored on its own mesh
device, the gathered top-k merged on K3, totals and count planes
psum'd) instead of the coordinator's host loop over shards:

- `MeshView` keeps a searchable snapshot of the index: one merged
  segment per shard (its engine's device-visible live docs, in the host
  loop's global-doc order, concatenated without re-analysis by
  index/merge.py), packed onto that shard's mesh device to pow-2 union
  shapes. A search re-merges only the shards whose content signature
  ((handle uid, live epoch) per handle) moved; a shape or schema growth
  repacks every shard.
- Statistics: plans compile with statistics aggregated from the ENGINE
  segments (tombstones included), the host loop's `global_stats`, so
  mesh scores equal host-loop scores bit for bit. Those statistics move
  between packs, so `MeshIndex._tn_avgdl` reports each field's pack-time
  avgdl, and the compiler falls back to the norm-cache gather
  (`terms_gather`) whenever they differ: a refresh changes the kernel
  route, not the scores.
- The fetch phase (`_source`) stays on the host against the snapshot's
  merged segments.
- Filter-cache rows survive refresh: a mesh plane is cached per shard
  row, keyed by the shard's (handle uid, live epoch) signature, so a
  refresh of one shard invalidates only that shard's row (one
  single-shard `compute_filter_mask` rebuilds it) and the other rows
  keep hitting. The per-request plane is the tuple of the cached rows
  (each on its shard's device) and is never cached itself.

One request serves sorted searches (one numeric key, asc / desc,
missing first / last, an optional trailing `_doc`), `search_after`
cursors, the mesh-eligible aggregations (search/aggs.py
`mesh_agg_ineligible_reason`) and `size: 0` requests. Anything else
returns None, and the coordinator serves it through its host loop; each
decline is counted by reason in `fallbacks`, never silently: rescore,
knn and `after_doc` cursors (`ineligible_shape` / `knn`), multi-key
sorts and `_score` asc (`sort_shape`), ineligible aggregations
(`agg_shape`), nested indices (`nested`), plans that do not compile to
one spec on every shard (`non_uniform_plan`), an open breaker
(`breaker`) and execute failures (`execute_error`, also counted in
`exec_failures` and fed to the breaker).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..index.filter_cache import mesh_cache_scope
from ..index.merge import compact_segment, concat_segments
from ..index.segment import Segment
from ..index.tiles import TILE, device_nbytes, pack_segment
from ..ops.aggs_device import agg_segment_tree
from ..query.compile import FieldStats, aggregate_field_stats
from .mesh import Mesh
from .sharded import (
    ShardedIndex,
    ShardPlanes,
    fill_union_schema,
    sharded_execute,
    sharded_execute_request,
    trees_with_masks,
    union_schema,
)


def _pow2(n: int, floor: int = 1) -> int:
    return 1 << max(0, max(n, floor) - 1).bit_length()


# Error classification for the serving breaker. Sticky failures are
# wrong-answer or will-never-work conditions (plan bugs, parity breaks);
# transient ones are capacity / runtime conditions (device out of memory
# under the mesh copy) that clear when pressure does.
_STICKY_ERROR_TYPES = (TypeError, ValueError, NotImplementedError, AssertionError)
_STICKY_ERROR_TOKENS = ("INVALID_ARGUMENT", "parity", "mismatch")
_TRANSIENT_ERROR_TOKENS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "OOM",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
)


def classify_mesh_error(e: BaseException) -> str:
    """'sticky' | 'transient' for an execute-stage mesh failure."""
    text = str(e)
    if isinstance(e, MemoryError) or any(
        tok in text for tok in _TRANSIENT_ERROR_TOKENS
    ):
        return "transient"
    if isinstance(e, _STICKY_ERROR_TYPES) or any(
        tok.lower() in text.lower() for tok in _STICKY_ERROR_TOKENS
    ):
        return "sticky"
    # Unknown runtime failures are transient: a cooled-down retry is
    # recoverable, a permanent disable is not.
    return "transient"


class MeshServingBreaker:
    """Circuit breaker for the mesh serving path.

    closed -> (threshold transient failures) -> open -> [cooldown] ->
    half-open -> closed on the first success / open again on a failure.
    A sticky failure latches the breaker open for the life of the
    process."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0):
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self.state = "closed"  # closed | open | half_open
        self.sticky = False
        self.failures = 0  # consecutive transient failures while closed
        self.opened_at = 0.0
        self.disable_events = 0
        self.reenable_events = 0
        self.last_error = ""
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May the next request try the mesh? Flips open -> half-open
        once the cooldown has elapsed (that request is the trial)."""
        with self._lock:
            if self.sticky:
                return False
            if self.state == "open":
                if time.monotonic() - self.opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    return True
                return False
            return True

    def is_open(self) -> bool:
        """Is the mesh path currently not served? (No open -> half-open
        transition, unlike allow().)"""
        with self._lock:
            if self.sticky:
                return True
            return (
                self.state == "open"
                and time.monotonic() - self.opened_at < self.cooldown_s
            )

    def record_failure(self, e: BaseException) -> None:
        with self._lock:
            self.last_error = f"{type(e).__name__}: {e}"
            if classify_mesh_error(e) == "sticky":
                self.sticky = True
                if self.state != "open":
                    self.disable_events += 1
                self.state = "open"
                self.opened_at = time.monotonic()
                return
            self.failures += 1
            if self.state == "half_open" or self.failures >= self.failure_threshold:
                if self.state != "open":
                    self.disable_events += 1
                self.state = "open"
                self.opened_at = time.monotonic()
                self.failures = 0

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state == "half_open":
                self.state = "closed"
                self.reenable_events += 1

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": "disabled" if self.sticky else self.state,
                "sticky": self.sticky,
                "failure_threshold": self.failure_threshold,
                "cooldown_seconds": self.cooldown_s,
                "disable_events": self.disable_events,
                "reenable_events": self.reenable_events,
                "last_error": self.last_error,
            }


@dataclass
class _MeshHandle:
    """Host-side handle of a snapshot's merged shard segment, duck-typed
    for SearchService._fetch_source and the Aggregator (`segment`,
    `device`) and for the mesh agg merge (`spans`: the [lo, hi) each
    engine segment occupies in the merged doc space, in handle order)."""

    segment: Segment
    device: Any = None
    spans: list = dc_field(default_factory=list)


@dataclass
class MeshIndex(ShardedIndex):
    """A ShardedIndex whose statistics scope is the engines' and whose tn
    validity tracks each shard's pack time."""

    serving_stats: dict[str, FieldStats] | None = None
    pack_avgdls: list[dict[str, float]] | None = None
    # Per-shard content signatures, (handle uid, live epoch) per handle:
    # the filter-cache rows key on them.
    shard_sigs: tuple = ()

    def field_stats(self) -> dict[str, FieldStats]:
        if self.serving_stats is not None:
            return self.serving_stats
        return super().field_stats()

    def _apply_filter_cache(
        self, query, compiled, record: bool = True, entries: list | None = None
    ):
        """Row-granular mesh filter cache: planes are cached per shard
        row, keyed (scope, ("row", shard, signature, docs pad), 0, key),
        so a refresh of one shard invalidates only its row. A missing row
        is one `compute_filter_mask` over that shard's tree, on its
        device, bit-equal to the stacked program's row. The per-request
        ShardPlanes over the rows is never cached: it would keep the rows
        alive past their own eviction."""
        cache = self.filter_cache
        if cache is None or not self.shard_sigs:
            return super()._apply_filter_cache(query, compiled, record, entries)
        from ..index.filter_cache import apply_cached_masks, record_filter_usage
        from ..ops.bm25_device import compute_filter_mask

        if entries is None:
            entries = record_filter_usage(cache, query, record=record)
        if not entries:
            return compiled, {}
        scope = self.cache_scope
        npad = self.docs_per_shard

        def build(child_spec, child_arrays, norm):
            rows = []
            hit_rows = 0
            for s in range(self.n_shards):
                rkey = (scope, ("row", s, self.shard_sigs[s], npad), 0, norm)
                row = cache.get(rkey)
                if row is None:
                    row = compute_filter_mask(
                        self.trees[s], child_spec,
                        self._shard_plan(child_arrays, s),
                    ).clone()
                    cache.put(rkey, row, row.numel() * row.element_size())
                else:
                    hit_rows += 1
                rows.append(row)
            cache.note_reuse(hit_rows)
            return ShardPlanes(rows), 0

        compiled, masks, _reused = apply_cached_masks(
            cache, (scope, 0, 0), query, compiled, build,
            const_fill=lambda: {
                "boost": np.zeros(self.n_shards, dtype=np.float32)
            },
            entries=entries,
            store_planes=False,
        )
        return compiled, masks

    def _tn_avgdl(self, shard: int, field: str, fstats) -> float:
        # The compiled spec kind must stay shard-uniform: a tn scope is
        # valid only when every shard packed the field with one avgdl;
        # any divergence routes every shard to the gather kernel.
        if not self.pack_avgdls:
            return -1.0
        vals = {d.get(field) for d in self.pack_avgdls}
        if len(vals) == 1:
            v = vals.pop()
            if v is not None:
                return float(v)
        return -1.0


@dataclass
class _Snapshot:
    """One immutable generation-consistent serving view."""

    gens: tuple
    index: MeshIndex
    handles: list[_MeshHandle]
    # The pinned engine handles the serving statistics came from (shard
    # order): the agg planner's histogram-range scope, as the host loop's.
    engine_handles: list = dc_field(default_factory=list)


class MeshView:
    """Generation-consistent mesh view of one index's shards."""

    def __init__(self, engines, mappings, params, mesh: Mesh,
                 axis: str = "shard", filter_cache=None):
        self.engines = engines
        self.mappings = mappings
        self.params = params
        self.mesh = mesh
        self.axis = axis
        # The node's FilterCache: the plain-score serve path reads cached
        # per-shard rows for repeated filter clauses; rows of shards whose
        # signature moved are purged on the snapshot change.
        self.filter_cache = filter_cache
        self._lock = threading.Lock()
        self._snap: _Snapshot | None = None
        n = len(engines)
        self._host_segs: list[Segment | None] = [None] * n
        # Per-handle live-compacted pieces keyed (handle uid, live epoch):
        # a refresh compacts only new or changed handles.
        self._pieces: dict[tuple[int, int], Segment] = {}
        # Per-shard content signature: (uid, live_epoch) per handle.
        self._shard_sig: list[tuple | None] = [None] * n
        self._filled_segs: list[Segment | None] = [None] * n
        self._trees: list[Any] = [None] * n
        self._devs: list[Any] = [None] * n  # packed DeviceSegments
        self._spans: list[list] = [[] for _ in range(n)]
        self._pack_avgdl: list[dict[str, float]] = [{} for _ in range(n)]
        self._shapes: dict[str, Any] | None = None
        self.served = 0  # searches answered on the mesh
        self.packs = 0  # shard packs + uploads
        self.seg_reuses = 0  # shard buffers reused across refreshes
        self.rebuilds = 0  # all-shard rebuilds (shape or schema growth)
        self.fallbacks: dict[str, int] = {}  # declines by reason
        self.last_fallback_reason: str | None = None
        self.exec_failures = 0
        self.breaker = MeshServingBreaker()
        self.plane_bytes = 0  # device bytes of the current snapshot

    @property
    def disabled(self) -> bool:
        """True while the mesh path is not tried (latched or cooling)."""
        return self.breaker.is_open()

    def stats(self) -> dict[str, Any]:
        """The view's counters."""
        with self._lock:
            fallbacks = dict(self.fallbacks)
        return {
            "served": self.served,
            "packs": self.packs,
            "seg_reuses": self.seg_reuses,
            "rebuilds": self.rebuilds,
            "fallbacks": fallbacks,
            "exec_failures": self.exec_failures,
            "plane_bytes": self.plane_bytes,
            "breaker": self.breaker.stats()["state"],
        }

    # ------------------------------------------------------------- refresh

    def _merged_segment(self, handles: list) -> tuple[Segment, list]:
        """One segment of the shard's device-visible live docs, in host
        order (handles in order, locals ascending), so equal-score ties
        break as the coordinator merges them; and the [lo, hi) span each
        engine handle occupies in it. No document is re-analyzed: each
        handle's live-compacted piece is cached by (uid, live epoch) and
        the pieces concatenate as array ops."""
        pieces: list[Segment] = []
        spans: list[tuple[int, int]] = []
        base = 0
        for handle in handles:
            key = (handle.uid, handle.live_epoch)
            piece = self._pieces.get(key)
            if piece is None:
                # The mask the device kernels serve, not live_host, which
                # may carry deletes visible only after the next refresh.
                live = handle.device.live.cpu().numpy()[
                    : handle.segment.num_docs
                ]
                piece = compact_segment(handle.segment, live)
                self._pieces[key] = piece
            pieces.append(piece)
            spans.append((base, base + piece.num_docs))
            base += piece.num_docs
        return concat_segments(pieces), spans

    def _schema(self, segs: list[Segment]) -> dict[str, Any]:
        """Union schema + pow-2 padded shapes covering every shard."""
        fields, dv, vec = union_schema(segs)
        docs = max([1] + [seg.num_docs for seg in segs])
        tiles: dict[str, int] = {}
        pos_tiles: dict[str, int] = {}
        for seg in segs:
            for name, has_norms in fields.items():
                f = seg.fields.get(name)
                postings = len(f.doc_ids) if f is not None else 0
                tiles[name] = max(
                    tiles.get(name, 0), _pow2(postings // TILE + 2)
                )
                if has_norms:
                    npos = (
                        len(f.positions)
                        if f is not None and f.positions is not None
                        else 0
                    )
                    pos_tiles[name] = max(
                        pos_tiles.get(name, 0), _pow2(npos // TILE + 2)
                    )
        return {
            "fields": fields,
            "dv": dv,
            "vec": vec,
            "docs": _pow2(docs),
            "tiles": tiles,
            "pos_tiles": pos_tiles,
        }

    @staticmethod
    def _shapes_fit(old: dict[str, Any] | None, new: dict[str, Any]) -> bool:
        """True when shards packed under `old` still share shapes with
        shards packed under shapes covering `new` (schema identical, no
        padded dimension grew)."""
        if old is None:
            return False
        if (
            old["fields"] != new["fields"]
            or old["dv"] != new["dv"]
            or old["vec"] != new["vec"]
        ):
            return False
        if new["docs"] > old["docs"]:
            return False
        for name, t in new["tiles"].items():
            if t > old["tiles"].get(name, 0):
                return False
        for name, t in new["pos_tiles"].items():
            if t > old["pos_tiles"].get(name, 0):
                return False
        return True

    def _pack_shard(self, shard: int, seg: Segment, shapes: dict[str, Any],
                    stats: dict[str, FieldStats]):
        """Pack one shard's merged segment onto its mesh device. Returns
        (tree, filled segment, pack avgdls, DeviceSegment); the caller
        commits them only once every shard packed. The union-schema fill
        copies the segment, so a still-serving snapshot's segments are
        never changed."""
        device = self.mesh.axis_devices(self.axis)[shard]
        seg = fill_union_schema(
            seg, shapes["fields"], shapes["dv"], shapes["vec"]
        )
        avgdl = {
            name: (stats[name].avgdl if name in stats else 1.0)
            for name in shapes["fields"]
        }
        dev = pack_segment(
            seg,
            device=device,
            pad_docs_to=shapes["docs"],
            field_min_tiles=shapes["tiles"],
            field_avgdl=avgdl,
            k1=self.params.k1,
            b=self.params.b,
            field_pos_min_tiles=shapes["pos_tiles"],
        )
        return agg_segment_tree(dev), seg, avgdl, dev

    def _assemble(self) -> list:
        """The shards' trees, in shard order (each on its own device: the
        port keeps per-shard trees where the reference assembled one
        stacked global array)."""
        return list(self._trees)

    def _pin_engines(self) -> tuple[tuple, list[list]]:
        """(generations, per-engine handle lists), each engine read under
        its lock, so that generation and handles never disagree."""
        gens = []
        pinned = []
        for e in self.engines:
            with e.lock:
                gens.append(e.generation)
                pinned.append(list(e.segments))
        return tuple(gens), pinned

    def _ensure(self) -> _Snapshot:
        """Refresh the view to the engines' current generations."""
        snap = self._snap
        if snap is not None and snap.gens == tuple(
            e.generation for e in self.engines
        ):
            return snap
        with self._lock:
            gens, pinned = self._pin_engines()
            snap = self._snap
            if snap is not None and snap.gens == gens:
                return snap
            n = len(self.engines)
            # A generation bump that leaves a shard's signature unchanged
            # (another shard's write) needs no re-merge.
            sigs = [
                tuple((h.uid, h.live_epoch) for h in pinned[i])
                for i in range(n)
            ]
            changed = [
                i for i in range(n)
                if self._shard_sig[i] != sigs[i] or self._host_segs[i] is None
            ]
            merged = {
                i: s for i, s in enumerate(self._host_segs) if s is not None
            }
            spans = {i: self._spans[i] for i in merged}
            for i in changed:
                merged[i], spans[i] = self._merged_segment(pinned[i])
            live_keys = {
                (h.uid, h.live_epoch) for handles in pinned for h in handles
            }
            self._pieces = {
                k: v for k, v in self._pieces.items() if k in live_keys
            }
            new_shapes = self._schema([merged[i] for i in sorted(merged)])
            # Serving statistics: the engine view (tombstones included),
            # from the same pinned handles the merges came from — the host
            # loop's global_stats at these generations.
            stats = aggregate_field_stats(
                [h.segment for handles in pinned for h in handles]
            )
            if self._shapes_fit(self._shapes, new_shapes):
                shapes = self._shapes
                to_pack = changed
            else:
                shapes = new_shapes
                to_pack = list(range(n))
            # Stage every pack, then commit: a failure leaves the caches
            # as they were (the old snapshot keeps serving).
            packed = {
                i: self._pack_shard(i, merged[i], shapes, stats)
                for i in to_pack
            }
            if shapes is not self._shapes:
                self._shapes = shapes
                self.rebuilds += 1
            for i in changed:
                self._host_segs[i] = merged[i]
                self._spans[i] = spans[i]
            for i, (tree, filled, avgdl, dev) in packed.items():
                self._trees[i] = tree
                self._filled_segs[i] = filled
                self._pack_avgdl[i] = avgdl
                self._devs[i] = dev
                self.packs += 1
            self.seg_reuses += n - len(to_pack)
            self._shard_sig = list(sigs)
            scope = mesh_cache_scope(self.engines)
            docs_pad = self._shapes["docs"]
            if self.filter_cache is not None:
                # Rows no snapshot can serve again free their memory now;
                # rows of unchanged shards survive and keep hitting.
                keep = {("row", s, sigs[s], docs_pad) for s in range(n)}
                self.filter_cache.purge_scope(scope, keep)
            self.plane_bytes = sum(
                device_nbytes(d) for d in self._devs if d is not None
            )
            segments = list(self._filled_segs)
            index = MeshIndex(
                mesh=self.mesh,
                axis=self.axis,
                mappings=self.mappings,
                segments=segments,
                trees=self._assemble(),
                docs_per_shard=self._shapes["docs"],
                params=self.params,
                serving_stats=stats,
                pack_avgdls=list(self._pack_avgdl),
                filter_cache=self.filter_cache,
                cache_scope=scope,
                cache_generation=sum(gens),
                shard_sigs=tuple(sigs),
            )
            self._snap = _Snapshot(
                gens=gens,
                index=index,
                handles=[
                    _MeshHandle(s, device=self._devs[i], spans=self._spans[i])
                    for i, s in enumerate(segments)
                ],
                engine_handles=[h for handles in pinned for h in handles],
            )
            return self._snap

    # -------------------------------------------------------------- serve

    def _fallback(self, reason: str):
        """Count one decline and return the None that sends the request
        to the host loop."""
        self.last_fallback_reason = reason
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        return None

    @staticmethod
    def ineligible_reason(request) -> str | None:
        """Shape-level reason this request cannot serve on the mesh
        (None = eligible); mapping- and plan-level declines surface
        inside serve()."""
        from ..search.aggs import mesh_agg_ineligible_reason
        from ..search.service import normalized_sort

        if request.rescore or getattr(request, "profile", False):
            return "ineligible_shape"
        if getattr(request, "knn", None) is not None:
            # kNN serves through the host loop's ANN / exact kernels.
            return "knn"
        if request.after_doc >= 0:
            # Engine-global doc cursors address the host path's doc
            # space, not the mesh's.
            return "ineligible_shape"
        if request.sort is not None:
            keys = normalized_sort(request)
            if len(keys) != 1:
                return "sort_shape"  # multi-key sorts lexsort on the host
            fname, desc, _mf = keys[0]
            if fname == "_score" and not desc:
                return "sort_shape"  # bottom-k: the host's score-asc path
        if request.aggs is not None:
            reason = mesh_agg_ineligible_reason(request.aggs)
            if reason is not None:
                return reason
        return None

    @classmethod
    def eligible(cls, request) -> bool:
        """Request shapes the mesh's query phase covers."""
        return cls.ineligible_reason(request) is None

    def _sort_plan(self, request):
        """(sort_field, desc, missing_first, want_sort_values), or an
        ineligibility reason; sort_field None = score-ordered."""
        from ..search.service import normalized_sort

        if request.sort is None:
            return (None, False, False, False)
        ((fname, desc, mfirst),) = normalized_sort(request)
        if fname == "_score":
            return (None, False, False, True)
        fm = self.mappings.get(fname)
        if fm is None or not fm.is_numeric:
            return "sort_shape"  # the host path raises the 400 verbatim
        return (fname, desc, mfirst, True)

    def _compile_aggs(self, coordinator, snap, request):
        """(Aggregator, specs tuple, stacked arrays) for the request's agg
        tree, compiled shard-uniform; raises ValueError when the shards'
        plans differ."""
        from ..search.aggs import Aggregator, _pow2 as agg_pow2
        from .sharded import _stack

        idx = snap.index
        term_fields: set[str] = set()

        def collect(nodes):
            for n in nodes:
                if n.kind in ("terms", "rare_terms", "cardinality"):
                    f = n.params.get("field")
                    if f:
                        term_fields.add(f)
                collect(n.subs)

        collect(request.aggs)
        term_pads: dict[str, int] = {}
        for f in term_fields:
            widths = [
                h.device.fields[f].num_terms
                for h in snap.handles
                if h.device is not None and f in h.device.fields
            ]
            if widths:
                term_pads[f] = agg_pow2(max(widths))
        agg = Aggregator(
            self.engines[0],
            request.aggs,
            handles=snap.handles,
            index_name=coordinator.index_name,
            term_pads=term_pads,
            range_handles=snap.engine_handles,
        )
        # Keep every shard row: the mesh plan is mesh-wide (the
        # constructor drops empty segments).
        agg.handles = list(snap.handles)
        per_shard = [
            agg.compile_for(snap.handles[s], idx.shard_compiler(s))
            for s in range(len(snap.handles))
        ]
        if len({s for s, _ in per_shard}) != 1:
            raise ValueError("aggregation plans did not lower shard-uniform")
        return agg, per_shard[0][0], _stack([a for _, a in per_shard])

    def serve(self, coordinator, request, fc_entries: list | None = None):
        """Answer a SearchRequest on the mesh (scoring, sorted or
        score-ordered top-k with the search_after mask, psum'd totals and
        the aggregation planes), or return None, with the decline counted
        by reason, so that the coordinator serves it through its host
        loop. `fc_entries` are the coordinator's collected filter-cache
        entries (it recorded the request's sighting)."""
        from ..search.aggs import _to_host, merge_mesh_result, new_merge_state
        from ..search.service import SearchHit, SearchResponse, clamp_total

        reason = self.ineligible_reason(request)
        if reason is not None:
            return self._fallback(reason)
        if not self.breaker.allow():
            return self._fallback("breaker")
        if any(h.segment.nested for e in self.engines for h in e.segments):
            # Nested blocks are not mesh-stackable: the mesh compiler has
            # no nested context and would lower nested queries to nothing.
            return self._fallback("nested")
        sort_plan = self._sort_plan(request)
        if isinstance(sort_plan, str):
            return self._fallback(sort_plan)
        sort_field, sort_desc, missing_first, want_sort_values = sort_plan
        start = time.monotonic()
        snap = self._ensure()
        idx = snap.index
        try:
            compiled = idx.compile(request.query)
        except Exception:  # noqa: BLE001 - the host loop re-raises
            # Plans that cannot be made shard-uniform fall back; a
            # user-facing validation error re-raises from the host path.
            return self._fallback("non_uniform_plan")
        agg = None
        aggs_spec = None
        aggs_arrays = ()
        if request.aggs is not None:
            try:
                agg, aggs_spec, aggs_arrays = self._compile_aggs(
                    coordinator, snap, request
                )
            except Exception:  # noqa: BLE001 - the host loop re-raises
                return self._fallback("non_uniform_plan")
        k = max(0, request.from_) + max(0, request.size)
        if sort_field is not None and k > 0 and sort_field not in (
            idx.segments[0].doc_values if idx.segments else {}
        ):
            # A mapped numeric field no document carries: the host path's
            # missing-column branch owns that shape.
            return self._fallback("sort_shape")
        # The search_after cursor in the transformed ascending key space;
        # public cursors are key-only, so the global doc tiebreak is
        # pushed past every shard (ties never qualify).
        has_after = request.search_after is not None
        after_key = np.float32(0.0)
        after_doc = len(self.engines) * idx.docs_per_shard
        if has_after:
            raw = request.search_after[0]
            fmax = np.float32(np.finfo(np.float32).max)
            if sort_field is None:
                if raw is None or not isinstance(raw, (int, float)):
                    return self._fallback("ineligible_shape")
                after_key = np.float32(raw)
            elif raw is None:
                after_key = -fmax if missing_first else fmax
            else:
                after_key = np.float32(raw)
                if sort_desc:
                    after_key = np.float32(-after_key)
        plain = (
            sort_field is None
            and not has_after
            and aggs_spec is None
            and not want_sort_values
            and k > 0
        )
        try:
            if plain:
                # The plain score path keeps the candidate-centric sparse
                # kernels (no dense planes, no agg planes), and repeated
                # filter clauses read their cached rows (record=False: the
                # coordinator counted the request; a fallback to the host
                # loop must not count it twice). The sorted and
                # aggregating program recomputes its filters, as the
                # reference's does.
                masks = {}
                if idx.filter_cache is not None:
                    compiled, masks = idx._apply_filter_cache(
                        request.query, compiled, record=False,
                        entries=fc_entries,
                    )
                scores, gids, total = sharded_execute(
                    idx.mesh, idx.axis, trees_with_masks(idx.trees, masks),
                    compiled.arrays, compiled.spec, k, idx.docs_per_shard,
                )
                n_after = total
                agg_out = ()
            else:
                _keys, scores, gids, total, n_after, agg_out = (
                    sharded_execute_request(
                        idx.mesh, idx.axis, idx.trees, compiled.arrays,
                        compiled.spec, k, idx.docs_per_shard,
                        sort_field=sort_field,
                        sort_desc=sort_desc,
                        missing_first=missing_first,
                        has_after=has_after,
                        after_key=after_key,
                        after_doc=after_doc,
                        aggs_spec=aggs_spec,
                        aggs_arrays_stacked=aggs_arrays,
                    )
                )
            # The host reads the replicated outputs once, after the merge.
            scores = scores.cpu().numpy()
            gids = gids.cpu().numpy()
            agg_np = _to_host(agg_out)
            total = int(total)
            n_after = int(n_after)
        except Exception as e:  # noqa: BLE001 - counted, fed to the breaker
            # Execute-stage failure (a kernel's argument check, device out
            # of memory under the mesh copy): the host loop serves the
            # request, and the breaker decides whether the mesh is tried
            # again.
            self.exec_failures += 1
            self.breaker.record_failure(e)
            return self._fallback("execute_error")
        self.breaker.record_success()
        self.served += 1
        aggregations = None
        if agg is not None:
            states = [new_merge_state(n) for n in request.aggs]
            for node, state, res in zip(request.aggs, states, agg_np):
                merge_mesh_result(node, state, res, snap.handles)
            aggregations = agg.render_states(states)
        limit = n_after if has_after else total
        n = min(k, limit, len(gids))
        max_score = None
        if request.sort is None and n > 0:
            max_score = float(scores[0])
        hits = []
        svc = coordinator.services[0]
        for rank in range(max(0, request.from_), n):
            shard, local = idx.locate(int(gids[rank]))
            handle = snap.handles[shard]
            score = None
            sort_out = None
            if sort_field is not None:
                raw = float(scores[rank])
                sort_out = [None if np.isnan(scores[rank]) else raw]
            else:
                score = float(scores[rank])
                if want_sort_values:
                    sort_out = [score]
            hits.append(
                SearchHit(
                    doc_id=handle.segment.ids[local],
                    score=score,
                    source=svc._fetch_source(handle, local, request),
                    sort=sort_out,
                )
            )
        total_out, relation = clamp_total(total, request.track_total_hits)
        return SearchResponse(
            took_ms=int((time.monotonic() - start) * 1000),
            total=total_out,
            total_relation=relation,
            max_score=max_score,
            hits=hits,
            aggregations=aggregations,
            shards=len(self.engines),
        )


def maybe_mesh_view(engines, mappings, params, devices,
                    filter_cache=None) -> MeshView | None:
    """A MeshView when mesh serving can work here: more than one shard,
    and at least one device entry per shard (`devices`, the node's mesh
    devices; entries may repeat, and none turns the view off)."""
    if len(engines) < 2:
        return None
    if len(devices) < len(engines):
        return None
    mesh = Mesh(np.array(list(devices[: len(engines)]), dtype=object),
                ("shard",))
    return MeshView(engines, mappings, params, mesh,
                    filter_cache=filter_cache)
