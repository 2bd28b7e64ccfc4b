"""A single-shard node: index management, writes and `_search`.

Port of elasticsearch_tpu/node.py, trimmed to this slice: `create_index`,
`index_doc`, `delete_doc`, `bulk`, `refresh` and `search` over one shard
per index on one device. Left out: replication and clusters, aliases and
templates, ingest pipelines, scroll and async search, the QoS and
micro-batching front, tasks, metrics and tracing, snapshots, and every
other API of the reference node (ROADMAP queue A).
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass
from typing import Any

from .analysis.analyzers import AnalysisRegistry
from .device import DEFAULT_DEVICE, resolve_device
from .index.engine import Engine, VersionConflictError
from .index.mapping import Mappings
from .ops.bm25 import BM25Params
from .search.service import SearchRequest, SearchService

_INDEX_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_\-.]*$")


class ApiError(Exception):
    """An error with an HTTP status, rendered ES-style by the REST layer."""

    def __init__(self, status: int, err_type: str, reason: str):
        super().__init__(reason)
        self.status = status
        self.err_type = err_type
        self.reason = reason


def index_not_found(name: str) -> ApiError:
    return ApiError(404, "index_not_found_exception", f"no such index [{name}]")


@dataclass
class IndexService:
    name: str
    mappings: Mappings
    engine: Engine
    search: SearchService


class Node:
    """One node serving single-shard indices from one device."""

    def __init__(
        self,
        device=DEFAULT_DEVICE,
        node_name: str = "node-0",
        cluster_name: str = "elasticsearch",
    ):
        self.device = resolve_device(device)
        self.node_name = node_name
        self.cluster_name = cluster_name
        self.indices: dict[str, IndexService] = {}
        self._lock = threading.Lock()

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
            n_shards = int(
                index_settings.get(
                    "number_of_shards", settings.get("number_of_shards", 1)
                )
            )
            if n_shards != 1:
                raise ApiError(
                    400, "illegal_argument_exception",
                    "this node serves single-shard indices only "
                    f"(number_of_shards={n_shards})",
                )
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
            engine = Engine(mappings, params=params, device=self.device)
            self.indices[name] = IndexService(
                name=name,
                mappings=mappings,
                engine=engine,
                search=SearchService(engine),
            )
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

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
        try:
            result = svc.engine.index(source, doc_id, op_type=op_type)
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
            svc.engine.refresh()
            out["forced_refresh"] = True
        return out

    def delete_doc(self, index: str, doc_id: str, refresh: bool = False) -> dict:
        svc = self.get_index(index)
        result = svc.engine.delete(doc_id)
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
            svc.engine.refresh()
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
                    self.indices[index].engine.refresh()
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "errors": errors,
            "items": items,
        }

    def refresh(self, index: str) -> dict:
        svc = self.get_index(index)
        svc.engine.refresh()
        return {"_shards": {"total": 1, "successful": 1, "failed": 0}}

    # -------------------------------------------------------------- search

    def search(self, index: str, body: dict[str, Any] | None) -> dict:
        svc = self.get_index(index)
        try:
            request = SearchRequest.from_json(body)
        except (ValueError, KeyError, TypeError) as e:
            raise ApiError(400, "parsing_exception", str(e)) from None
        try:
            response = svc.search.search(request)
        except ValueError as e:
            raise ApiError(
                400, "search_phase_execution_exception", str(e)
            ) from None
        return response.to_json(index)
