"""A node on one device: index management, writes and `_search`.

Port of elasticsearch_tpu/node.py, trimmed to this slice: `create_index`
(with `number_of_shards`), `delete_index`, `get_mapping`, `put_mapping`
(new fields; a type, and a dense_vector's dims and similarity, never
change),
`index_doc`, `delete_doc`, `bulk`, `refresh` and `search` over indices
of N shards on one device. Documents route to
shards by murmur3 over their _id (parallel/routing.py); ids the node
generates (`_auto_N`) come from one per-index counter. A multi-shard
index searches through the ShardedSearchCoordinator. Plain searches ride
the exec micro-batcher (exec/batcher.py), which coalesces concurrent
same-shape searches of an index into one batched launch per (shard, spec
group); a `from + size` past the index's `max_result_window` is refused
before it. Every shard's SearchService shares the node's exec planner
(exec/planner.py), which routes a solo search that does not track total
hits to the block-max paths when its cost model says they win. Requests
with aggregations, a sort, a rescore or a search_after cursor take the
solo path. Documents may carry objects (flattened to dotted fields),
nested arrays (kept whole in the parent's `_source`, indexed as the
path's hidden nested docs), geo_points and rank_features; the mapper
errors of the reference (a concrete value for an object, an object for
a leaf, a geo_point out of bounds, ...) are 400s.
`Node(exec_batcher=False)` / `Node(exec_planner=False)` turn either off:
the port's form of the reference's ESTPU_EXEC_BATCHER=0 /
ESTPU_EXEC_PLANNER=0; without the batcher every search takes the solo
path. Plain searches of small one-shard indices with inverted-only query
shapes ride one shared batcher group instead of their index's
(exec/packed.py): concurrent searches on DIFFERENT small indices coalesce
into one packed launch; `Node(exec_packed=False)` (the reference's
ESTPU_EXEC_PACKED=0) keeps every index in its own group. A multi-shard
index gets the reference's mesh view (parallel/mesh_serving.py) when the
node's mesh devices hold one entry per shard: `Node(mesh_devices=...)`
is the port's counterpart of the device count the reference reads from
XLA's flags (None: every visible CUDA device on a CUDA node, the one CPU
device on a CPU node; entries may repeat, `[torch.device("cpu")] * 8`
serves eight shards on the CPU, `[]` turns the view off). The
coordinator then serves each eligible search through the mesh before its
host loop, and such a search skips the micro-batcher, as in the
reference.
`IndexService.mesh_snapshot` stacks an index's live docs onto a mesh
(parallel/sharded.ShardedIndex). The node's filter cache
(index/filter_cache.py) is on by default, as in the reference:
`Node(filter_cache=False)` is the reference's ESTPU_FILTER_CACHE=0, and
`Node(filter_cache=FilterCache(max_bytes=..., min_freq=...))` sets what
the reference reads from ESTPU_FILTER_CACHE_BYTES / _MIN_FREQ. Every
index's services, coordinator and mesh view share it; `clear_cache`
(`POST [/{index}]/_cache/clear`) drops an index's planes, `delete_index`
drops them with the index, and a refresh prunes the planes of dead
segment handles. Left out: replication and clusters, aliases and
templates, ingest pipelines, scroll and async search, QoS lanes, the
request cache, tasks, metrics and tracing, snapshots, and every other
API of the reference node (ROADMAP queue A).
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Any

import torch

from .analysis.analyzers import AnalysisRegistry
from .device import DEFAULT_DEVICE, resolve_device
from .exec.batcher import BatcherRejected, MicroBatcher
from .exec.packed import PackedExecutor
from .exec.planner import ExecPlanner, ast_signature
from .index.ann import AnnCache, clear_index_ann
from .index.engine import Engine, VersionConflictError
from .index.filter_cache import FilterCache, clear_index_planes
from .index.mapping import Mappings
from .ops.bm25 import BM25Params
from .parallel.mesh_serving import maybe_mesh_view
from .parallel.routing import shard_for_id
from .search.coordinator import SearchPhaseFailedError, ShardedSearchCoordinator
from .search.service import SearchRequest, SearchService

_INDEX_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_\-.]*$")


class ApiError(Exception):
    """An error with an HTTP status, rendered ES-style by the REST layer."""

    def __init__(
        self,
        status: int,
        err_type: str,
        reason: str,
        retry_after_s: int | None = None,
    ):
        super().__init__(reason)
        self.status = status
        self.err_type = err_type
        self.reason = reason
        self.retry_after_s = retry_after_s  # Retry-After header on a 429


def index_not_found(name: str) -> ApiError:
    return ApiError(404, "index_not_found_exception", f"no such index [{name}]")


@dataclass
class IndexService:
    """One index: mappings + N shard engines + its search entry.

    Documents route to shards by ES-compatible murmur3 over _id
    (OperationRouting.java:245 via parallel/routing.py); a multi-shard
    index searches through the ShardedSearchCoordinator."""

    name: str
    mappings: Mappings
    engines: list[Engine]
    search: SearchService | ShardedSearchCoordinator
    max_result_window: int = 10_000  # index.max_result_window
    _auto_counter: int = -1  # seeded lazily from the shard engines
    _auto_lock: threading.Lock = field(default_factory=threading.Lock)
    # The index's incarnation id (the packed plane's member key).
    uuid: str = field(default_factory=lambda: uuid_mod.uuid4().hex)

    @property
    def num_docs(self) -> int:
        """Live searchable docs over every shard."""
        return sum(e.num_docs for e in self.engines)

    @property
    def engine(self) -> Engine:
        """The sole engine of a 1-shard index."""
        if len(self.engines) != 1:
            raise ValueError(
                f"index [{self.name}] has {len(self.engines)} shards; "
                f"use route()/engines"
            )
        return self.engines[0]

    @property
    def n_shards(self) -> int:
        return len(self.engines)

    def route(self, doc_id: str) -> Engine:
        """Shard engine owning doc_id (murmur3 routing, ES-compatible)."""
        if len(self.engines) == 1:
            return self.engines[0]
        return self.engines[shard_for_id(doc_id, len(self.engines))]

    def next_auto_id(self) -> str:
        """Node-generated _id for id-less writes to a multi-shard index
        (the id must exist before routing), safe across concurrent REST
        threads."""
        with self._auto_lock:
            if self._auto_counter < 0:
                self._auto_counter = max(e._auto_id for e in self.engines)
            doc_id = f"_auto_{self._auto_counter}"
            self._auto_counter += 1
            return doc_id

    def mesh_snapshot(self, mesh, axis: str = "shard"):
        """Stack this index's live docs onto a device mesh
        (parallel/sharded.ShardedIndex): one segment per shard on the mesh
        axis, a point-in-time snapshot (later writes do not appear). Each
        shard's segment is its engine's live docs merged without
        re-analysis (index/merge.merged_live_segment), which equals the
        reference's re-add of the same docs through SegmentBuilder."""
        from .index.merge import merged_live_segment
        from .parallel.sharded import ShardedIndex

        if mesh.shape[axis] != len(self.engines):
            raise ValueError(
                f"mesh axis [{axis}] has {mesh.shape[axis]} devices; index "
                f"[{self.name}] has {len(self.engines)} shards"
            )
        segments = []
        for engine in self.engines:
            # Pending buffers and soft deletes become visible first, so
            # the snapshot equals what the coordinator serves.
            engine.refresh()
            handles = list(engine.segments)
            segments.append(merged_live_segment(
                [h.segment for h in handles], [h.live_host for h in handles]
            ))
        return ShardedIndex.from_segments(
            segments, self.mappings, mesh, axis, self.engines[0].params
        )


class Node:
    """One node serving N-shard indices from one device.

    `exec_batcher` / `exec_planner` (default on) build the micro-batcher
    and the cost-based backend planner; either is None when turned off.
    `exec_packed` (default on) builds the packed multi-tenant executor,
    which rides the batcher (None without one). `ann_cache`: True builds
    the default AnnCache, False none, or pass one; `filter_cache` likewise
    for the FilterCache of filter-clause planes. `mesh_devices`: the
    devices a multi-shard index may serve on as a mesh, one entry per
    shard at least (None: every visible CUDA device for a CUDA node, the
    CPU for a CPU node)."""

    def __init__(
        self,
        device=DEFAULT_DEVICE,
        node_name: str = "node-0",
        cluster_name: str = "elasticsearch",
        exec_batcher: bool = True,
        exec_planner: bool = True,
        ann_cache: "bool | AnnCache" = True,
        exec_packed: bool = True,
        mesh_devices=None,
        filter_cache: "bool | FilterCache" = True,
    ):
        self.device = resolve_device(device)
        if mesh_devices is None:
            mesh_devices = (
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if self.device.type == "cuda" else [self.device]
            )
        self.mesh_devices = [torch.device(d) for d in mesh_devices]
        self.node_name = node_name
        self.cluster_name = cluster_name
        self.indices: dict[str, IndexService] = {}
        self._lock = threading.Lock()
        # Per (shard, query) backend routing, shared by every shard.
        self.exec_planner = ExecPlanner() if exec_planner else None
        # Continuous micro-batching of concurrent plain searches
        # (ESTPU_EXEC_BATCH_WAIT_MS sets its window, default 4 ms).
        self.exec_batcher = MicroBatcher() if exec_batcher else None
        # Packed multi-tenant execution (exec/packed.py): small one-shard
        # indices share ONE batcher group and one launch per spec bucket.
        self.packed_exec = (
            PackedExecutor()
            if self.exec_batcher is not None and exec_packed
            else None
        )
        # IVF planes of the knn section (None: exact brute force only).
        if isinstance(ann_cache, AnnCache):
            self.ann_cache = ann_cache
        else:
            self.ann_cache = AnnCache() if ann_cache else None
        # Mask planes of repeated filter clauses (None: every filter is
        # evaluated on every launch).
        if isinstance(filter_cache, FilterCache):
            self.filter_cache = filter_cache
        else:
            self.filter_cache = FilterCache() if filter_cache else None

    def close(self) -> None:
        """Stop the micro-batcher's scheduler thread."""
        if self.exec_batcher is not None:
            self.exec_batcher.close()

    # ------------------------------------------------------------- indices

    def create_index(self, name: str, body: dict[str, Any] | None = None) -> dict:
        body = body or {}
        with self._lock:
            if name in self.indices:
                raise ApiError(
                    400,
                    "resource_already_exists_exception",
                    f"index [{name}] already exists",
                )
            if not _INDEX_NAME_RE.match(name):
                raise ApiError(
                    400, "invalid_index_name_exception",
                    f"invalid index name [{name}]",
                )
            settings = body.get("settings") or {}
            index_settings = settings.get("index", {})
            try:
                n_shards = int(
                    index_settings.get(
                        "number_of_shards",
                        settings.get(
                            "index.number_of_shards",
                            settings.get("number_of_shards", 1),
                        ),
                    )
                )
            except (TypeError, ValueError):
                raise ApiError(
                    400, "illegal_argument_exception",
                    "index.number_of_shards must be an integer",
                ) from None
            if n_shards < 1 or n_shards > 1024:
                raise ApiError(
                    400, "illegal_argument_exception",
                    f"index.number_of_shards must be in [1, 1024], got "
                    f"{n_shards}",
                )
            try:
                window = int(index_settings.get("max_result_window", 10_000))
            except (TypeError, ValueError):
                raise ApiError(
                    400, "illegal_argument_exception",
                    "index.max_result_window must be an integer",
                ) from None
            params = BM25Params()
            sim = index_settings.get("similarity", {}).get("default", {})
            if sim.get("type") in (None, "BM25"):
                params = BM25Params(
                    k1=float(sim.get("k1", 1.2)), b=float(sim.get("b", 0.75))
                )
            analysis_cfg = (
                settings.get("analysis") or index_settings.get("analysis") or {}
            )
            try:
                registry = AnalysisRegistry(analysis_cfg.get("analyzer"))
                mappings = Mappings.from_json(
                    body.get("mappings"), analysis=registry
                )
            except ValueError as e:
                raise ApiError(400, "mapper_parsing_exception", str(e)) from None
            engines = [
                Engine(mappings, params=params, device=self.device)
                for _ in range(n_shards)
            ]
            if n_shards == 1:
                search = SearchService(
                    engines[0], planner=self.exec_planner,
                    ann_cache=self.ann_cache, index_name=name,
                    filter_cache=self.filter_cache,
                )
            else:
                search = ShardedSearchCoordinator(
                    engines, name, planner=self.exec_planner,
                    ann_cache=self.ann_cache, filter_cache=self.filter_cache,
                )
                search.mesh_view = maybe_mesh_view(
                    engines, mappings, params, self.mesh_devices,
                    filter_cache=self.filter_cache,
                )
            self.indices[name] = IndexService(
                name=name,
                mappings=mappings,
                engines=engines,
                search=search,
                max_result_window=window,
            )
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def delete_index(self, name: str) -> dict:
        """Drop an index with its filter-cache and IVF planes (their
        engine uids can never be looked up again)."""
        with self._lock:
            svc = self.indices.pop(name, None)
        if svc is None:
            raise index_not_found(name)
        clear_index_planes(self.filter_cache, svc.engines)
        clear_index_ann(self.ann_cache, svc.engines)
        return {"acknowledged": True}

    def expand_index_patterns(self, name: str) -> list[str]:
        """`_all`, comma lists and wildcards -> concrete index names; a
        concrete name that does not exist is a 404."""
        import fnmatch

        if name in ("_all", "*"):
            return sorted(self.indices)
        out: list[str] = []
        for part in name.split(","):
            part = part.strip()
            if "*" in part or "?" in part:
                out.extend(
                    i for i in sorted(self.indices)
                    if fnmatch.fnmatchcase(i, part)
                )
            elif part:
                out.append(self.get_index(part).name)
        return out

    def clear_cache(self, index: str | None = None) -> dict:
        """POST [/{index}]/_cache/clear: drop filter-cache planes and IVF
        planes (of one index, a pattern, or node-wide), with per-cache
        cleared counts as the reference reports them. `request_cache` is
        0: the request cache is not ported."""
        targets = (
            sorted(self.indices) if index is None
            else self.expand_index_patterns(index)
        )
        cleared_filter = 0
        cleared_ann = 0
        shards = 0
        for name in targets:
            svc = self.indices.get(name)
            if svc is None:
                continue
            shards += svc.n_shards
            cleared_filter += clear_index_planes(
                self.filter_cache, svc.engines
            )
            cleared_ann += clear_index_ann(self.ann_cache, svc.engines)
        return {
            "_shards": {"total": shards, "successful": shards, "failed": 0},
            "cleared": {
                "filter_cache": cleared_filter,
                "request_cache": 0,
                "ann": cleared_ann,
            },
        }

    def put_mapping(self, index: str, body: dict[str, Any] | None) -> dict:
        """Add fields to an index's mappings (PUT /{index}/_mapping); an
        existing field keeps its type, a dense_vector its dims and
        similarity (400 otherwise)."""
        svc = self.get_index(index)
        properties = (body or {}).get("properties") or {}
        try:
            for name, spec in properties.items():
                svc.mappings.merge_field(name, spec)
        except ValueError as e:
            raise ApiError(400, "illegal_argument_exception", str(e)) from None
        return {"acknowledged": True}

    def get_mapping(self, index: str) -> dict:
        """An index's mappings (GET /{index}/_mapping)."""
        svc = self.get_index(index)
        return {index: {"mappings": svc.mappings.to_json()}}

    def get_index(self, name: str, auto_create: bool = False) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            if not auto_create:
                raise index_not_found(name)
            try:
                self.create_index(name)
            except ApiError as e:
                if e.err_type != "resource_already_exists_exception":
                    raise
            svc = self.indices[name]
        return svc

    # -------------------------------------------------------------- writes

    def index_doc(
        self,
        index: str,
        source: dict[str, Any],
        doc_id: str | None = None,
        refresh: bool = False,
        op_type: str = "index",
    ) -> dict:
        if not isinstance(source, dict):
            raise ApiError(
                400, "mapper_parsing_exception",
                "failed to parse: the document must be a JSON object",
            )
        svc = self.get_index(index, auto_create=True)
        if doc_id is None and svc.n_shards > 1:
            # Multi-shard: the id must exist before routing.
            doc_id = svc.next_auto_id()
        engine = svc.engines[0] if doc_id is None else svc.route(doc_id)
        try:
            result = engine.index(source, doc_id, op_type=op_type)
        except VersionConflictError as e:
            raise ApiError(409, "version_conflict_engine_exception", str(e)) from None
        except ValueError as e:
            raise ApiError(400, "mapper_parsing_exception", str(e)) from None
        out = {
            "_index": index,
            "_id": result["_id"],
            "_version": result["_version"],
            "result": result["result"],
            "_seq_no": result["_seq_no"],
            "_primary_term": result["_primary_term"],
            "_shards": {"total": 1, "successful": 1, "failed": 0},
        }
        if refresh:
            self._refresh_engine(engine)
            out["forced_refresh"] = True
        return out

    def _refresh_engine(self, engine: Engine) -> None:
        """Refresh one shard and prune the filter-cache and IVF planes of
        its dead segments."""
        engine.refresh()
        live = frozenset(h.uid for h in engine.segments)
        if self.filter_cache is not None:
            self.filter_cache.prune_dead(engine.uid, live)
        if self.ann_cache is not None:
            self.ann_cache.prune_dead(engine.uid, live)

    def delete_doc(self, index: str, doc_id: str, refresh: bool = False) -> dict:
        svc = self.get_index(index)
        engine = svc.route(doc_id)
        result = engine.delete(doc_id)
        out = {
            "_index": index,
            "_id": doc_id,
            "result": "deleted" if result["result"] == "deleted" else "not_found",
            "_version": result["_version"],
            "_seq_no": result["_seq_no"],
            "_primary_term": result["_primary_term"],
            "_shards": {"total": 1, "successful": 1, "failed": 0},
        }
        if refresh:
            self._refresh_engine(engine)
            out["forced_refresh"] = True
        return out

    def bulk(self, body: str, default_index: str | None = None, refresh=False) -> dict:
        """NDJSON bulk: index/create/delete action lines with independent
        per-item outcomes."""
        t0 = time.monotonic()
        lines = [ln for ln in body.split("\n") if ln.strip()]
        items = []
        errors = False
        touched: set[str] = set()
        i = 0
        while i < len(lines):
            try:
                action_line = json.loads(lines[i])
            except json.JSONDecodeError as e:
                raise ApiError(
                    400, "illegal_argument_exception", f"malformed action line: {e}"
                ) from None
            if not isinstance(action_line, dict) or len(action_line) != 1:
                raise ApiError(
                    400,
                    "illegal_argument_exception",
                    f"Malformed action/metadata line [{i}], expected a "
                    f"single action object",
                )
            ((op, meta),) = action_line.items()
            index = meta.get("_index", default_index)
            doc_id = meta.get("_id")
            if doc_id is not None:
                doc_id = str(doc_id)  # numeric _ids coerce to strings
            i += 1
            try:
                if index is None:
                    raise ApiError(
                        400, "action_request_validation_exception",
                        "Validation Failed: 1: index is missing;",
                    )
                if op in ("index", "create"):
                    source = json.loads(lines[i])
                    i += 1
                    resp = self.index_doc(index, source, doc_id, op_type=op)
                    touched.add(index)
                    status = 201 if resp["result"] == "created" else 200
                    items.append({op: {**resp, "status": status}})
                elif op == "delete":
                    resp = self.delete_doc(index, doc_id)
                    touched.add(index)
                    status = 200 if resp["result"] == "deleted" else 404
                    items.append({op: {**resp, "status": status}})
                else:
                    raise ApiError(
                        400,
                        "illegal_argument_exception",
                        f"Malformed action/metadata line, expected one of "
                        f"[create, delete, index] but found [{op}]",
                    )
            except ApiError as e:
                errors = True
                items.append({
                    op: {
                        "_index": index,
                        "_id": doc_id,
                        "status": e.status,
                        "error": {"type": e.err_type, "reason": e.reason},
                    }
                })
        if refresh:
            for index in touched:
                if index in self.indices:
                    for engine in self.indices[index].engines:
                        self._refresh_engine(engine)
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "errors": errors,
            "items": items,
        }

    def refresh(self, index: str) -> dict:
        svc = self.get_index(index)
        for engine in svc.engines:
            self._refresh_engine(engine)
        n = svc.n_shards
        return {"_shards": {"total": n, "successful": n, "failed": 0}}

    # -------------------------------------------------------------- search

    def search(self, index: str, body: dict[str, Any] | None) -> dict:
        svc = self.get_index(index)
        try:
            request = SearchRequest.from_json(body)
        except (ValueError, KeyError, TypeError) as e:
            raise ApiError(400, "parsing_exception", str(e)) from None
        window = svc.max_result_window
        if request.from_ + request.size > window:
            raise ApiError(
                400,
                "illegal_argument_exception",
                f"Result window is too large, from + size must be less "
                f"than or equal to: [{window}] but was "
                f"[{request.from_ + request.size}]. See the scroll api "
                f"for a more efficient way to request large data sets.",
            )
        try:
            if request.knn is not None and self._batchable(request, svc):
                # Coalesced kNN: same-shape unfiltered knn searches group
                # into one batched pass per segment.
                knn = request.knn
                response = self.exec_batcher.execute(
                    svc.search,
                    request,
                    group_key=(
                        "_knn", svc.name, knn.field, knn.k,
                        knn.num_candidates, knn.nprobe,
                    ),
                )
            elif self._batchable(request, svc):
                if self.packed_exec is not None and self.packed_exec.eligible(
                    svc, request
                ):
                    # Small-tenant searches share ONE batcher group across
                    # indices: the packed executor is the group's searcher,
                    # so concurrent searches on DIFFERENT small indices
                    # coalesce into one packed launch.
                    response = self.exec_batcher.execute(
                        self.packed_exec,
                        self.packed_exec.wrap(svc, request),
                        group_key=("_packed", ast_signature(request.query)),
                    )
                else:
                    response = self.exec_batcher.execute(
                        svc.search,
                        request,
                        group_key=(svc.name, ast_signature(request.query)),
                    )
            else:
                response = svc.search.search(request)
        except ValueError as e:
            raise ApiError(
                400, "search_phase_execution_exception", str(e)
            ) from None
        except BatcherRejected as e:
            raise ApiError(
                429, "es_rejected_execution_exception", str(e),
                retry_after_s=e.retry_after_s,
            ) from None
        except SearchPhaseFailedError as e:
            # Every shard failed: the honest status is 503, never a
            # silently-partial 200.
            raise ApiError(
                503, "search_phase_execution_exception", str(e)
            ) from None
        return response.to_json(index)

    def _batchable(
        self, request: SearchRequest, svc: IndexService | None = None
    ) -> bool:
        """May this search ride the exec micro-batcher? Plain score-sorted
        query phases that ask for at least one hit, while the node has a
        batcher: aggregations, a sort, a rescore or a search_after cursor
        take the solo path. A knn search rides it unfiltered on a one-shard index
        (a per-lane filter mask or a shard scatter keeps its solo path). A
        search the index's mesh view serves takes the solo path too, so
        that the coordinator hands it to the mesh."""
        if self.exec_batcher is None:
            return False
        if (
            request.aggs is not None
            or request.sort is not None
            or request.rescore
            or request.search_after is not None
        ):
            return False
        if request.knn is not None:
            return (
                request.knn.filter is None
                and svc is not None
                and isinstance(svc.search, SearchService)
                and max(0, request.size) > 0
            )
        if max(0, request.from_) + max(0, request.size) <= 0:
            return False
        mv = getattr(svc.search, "mesh_view", None) if svc is not None else None
        if mv is not None and not mv.disabled and mv.eligible(request):
            return False
        return True
