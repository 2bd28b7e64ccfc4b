"""Per-shard engine: indexing buffer + refreshed device segments.

Port of elasticsearch_tpu/index/engine.py, trimmed to this slice: `index`,
`delete`, `refresh`, the device live mask, `_install_segment` (attach a
prebuilt segment), `field_stats`, `compiler_for`, the refresh
`generation` and the live-doc count `num_docs`. Engines and segment
handles carry process-unique `uid`s (the kNN plane cache keys on them),
and a handle its `live_epoch` (the mesh view keys on (uid, live_epoch)).
Dense_vector matrices and nested blocks ride the segments and their
device planes (a nested block's inner planes are packed with the parent
segment at refresh; a delete masks the parent, and the join drops its
children with it); `compiler_for` hands the compiler the segment's
nested blocks and its lazy `_id` index (ids queries). Left out: the
translog and store (no durability), merges, the HBM breaker, CAS writes,
replication and cold-tier demotion; see ROADMAP queue A.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.bm25 import BM25Params
from ..query.compile import Compiler, FieldStats, aggregate_field_stats
from .mapping import Mappings
from .segment import Segment, SegmentBuilder
from .tiles import DeviceSegment, pack_segment


_UIDS = itertools.count(1)


class VersionConflictError(Exception):
    """op_type=create on an existing document."""

    def __init__(self, doc_id: str, reason: str):
        super().__init__(f"[{doc_id}]: version conflict, {reason}")
        self.doc_id = doc_id


@dataclass
class SegmentHandle:
    """One searchable segment plus its mutable deletion state."""

    segment: Segment
    device: DeviceSegment
    base: int  # global doc id base for this segment
    live_host: np.ndarray  # bool[N] host copy of the live mask
    live_dirty: bool = False
    uid: int = field(default_factory=lambda: next(_UIDS))
    # Epoch of the device-visible live mask, bumped by every sync_live:
    # (uid, live_epoch) names a handle's searchable content, which the
    # mesh view keys its compacted pieces on (parallel/mesh_serving.py).
    live_epoch: int = 0
    _id_index: dict[str, int] | None = None  # lazy _id -> local (ids query)

    @property
    def id_index(self) -> dict[str, int]:
        if self._id_index is None:
            self._id_index = {d: i for i, d in enumerate(self.segment.ids)}
        return self._id_index

    def soft_delete(self, local_doc: int) -> None:
        if self.live_host[local_doc]:
            self.live_host[local_doc] = False
            self.live_dirty = True

    def sync_live(self) -> None:
        """Re-upload the live mask if deletions happened since last sync."""
        if self.live_dirty:
            self.device.live = torch.from_numpy(self.live_host.copy()).to(
                self.device.device
            )
            self.live_dirty = False
            self.live_epoch += 1


class Engine:
    """Indexing buffer + refreshed device segments for one shard."""

    def __init__(
        self,
        mappings: Mappings | None = None,
        params: BM25Params = BM25Params(),
        device=DEFAULT_DEVICE,
    ):
        self.mappings = mappings or Mappings()
        self.uid = next(_UIDS)
        self.params = params
        self.device = resolve_device(device)
        self.segments: list[SegmentHandle] = []
        # Serializes the write path (the REST layer dispatches concurrent
        # requests from a threading HTTP server).
        self.lock = threading.RLock()
        self._buffer = SegmentBuilder(self.mappings)
        self._buffer_ids: dict[str, int] = {}  # _id -> local doc in buffer
        self._buffer_deleted: set[int] = set()  # buffer locals dropped
        self._live_ids: dict[str, tuple[int, int]] = {}  # _id -> (seg, local)
        self._seqno = -1
        self._auto_id = 0
        self.primary_term = 1
        self._versions: dict[str, int] = {}
        self._stats_cache: dict[str, FieldStats] | None = None
        # Monotonic refresh generation: bumps whenever the searchable view
        # changes (the coordinator's statistics cache keys on it).
        self.generation = 0

    # ------------------------------------------------------------- write path

    def _exists(self, doc_id: str) -> bool:
        return doc_id in self._buffer_ids or doc_id in self._live_ids

    def index(
        self,
        source: dict[str, Any],
        doc_id: str | None = None,
        op_type: str = "index",
    ) -> dict:
        """Index (create or overwrite) one document; returns op metadata."""
        with self.lock:
            if doc_id is None:
                doc_id = f"_auto_{self._auto_id}"
                self._auto_id += 1
            exists = self._exists(doc_id)
            if op_type == "create" and exists:
                raise VersionConflictError(doc_id, "document already exists")
            version = self._versions.get(doc_id, 0) + 1
            seqno = self._seqno + 1
            # SegmentBuilder.add is atomic: a mapper failure leaves no doc.
            local = self._buffer.add(source, doc_id, version=version, seqno=seqno)
            self._seqno = seqno
            self._delete_existing(doc_id)
            self._buffer_ids[doc_id] = local
            self._versions[doc_id] = version
            return {
                "_id": doc_id,
                "result": "updated" if exists else "created",
                "_seq_no": seqno,
                "_version": version,
                "_primary_term": self.primary_term,
            }

    def delete(self, doc_id: str) -> dict:
        with self.lock:
            found = self._delete_existing(doc_id) > 0
            version = self._versions.get(doc_id, 0) + (1 if found else 0)
            if found:
                self._seqno += 1
                self._versions[doc_id] = version
            return {
                "_id": doc_id,
                "result": "deleted" if found else "not_found",
                "_seq_no": self._seqno,
                "_version": version if found else 1,
                "_primary_term": self.primary_term,
            }

    def _delete_existing(self, doc_id: str) -> int:
        """Tombstone any live copy of doc_id; returns number removed (0/1)."""
        removed = 0
        buf_local = self._buffer_ids.pop(doc_id, None)
        if buf_local is not None:
            self._buffer_deleted.add(buf_local)
            removed = 1
        loc = self._live_ids.pop(doc_id, None)
        if loc is not None:
            seg_idx, local = loc
            self.segments[seg_idx].soft_delete(local)
            removed = 1
        return removed

    # ----------------------------------------------------------- refresh/read

    def refresh(self) -> bool:
        """Make buffered docs searchable and deletions visible; returns True
        if anything changed. Buffered docs deleted before the refresh are
        dropped rather than indexed-then-masked."""
        with self.lock:
            changed = False
            for handle in self.segments:
                if handle.live_dirty:
                    handle.sync_live()
                    changed = True
            if changed:
                self.generation += 1
            if self._buffer.num_docs == 0:
                return changed
            if self._buffer_deleted:
                keep = [
                    i for i in range(self._buffer.num_docs)
                    if i not in self._buffer_deleted
                ]
                rebuilt = SegmentBuilder(self.mappings)
                id_map = {}
                for i in keep:
                    id_map[i] = rebuilt.add(
                        self._buffer._sources[i],
                        self._buffer._ids[i],
                        version=self._buffer._versions[i],
                        seqno=self._buffer._seqnos[i],
                    )
                self._buffer = rebuilt
                self._buffer_ids = {
                    d: id_map[loc] for d, loc in self._buffer_ids.items()
                    if loc in id_map
                }
                self._buffer_deleted.clear()
                if self._buffer.num_docs == 0:
                    return changed
            segment = self._buffer.build()
            device = pack_segment(
                segment, self.device, k1=self.params.k1, b=self.params.b
            )
            handle = SegmentHandle(
                segment=segment,
                device=device,
                base=sum(h.segment.num_docs for h in self.segments),
                live_host=np.ones(segment.num_docs, dtype=bool),
            )
            seg_idx = len(self.segments)
            self.segments.append(handle)
            for doc_id, local in self._buffer_ids.items():
                self._live_ids[doc_id] = (seg_idx, local)
            self._buffer = SegmentBuilder(self.mappings)
            self._buffer_ids = {}
            self._stats_cache = None
            self.generation += 1
            return True

    def _install_segment(
        self, segment: Segment, live: np.ndarray | None = None
    ) -> SegmentHandle:
        """Install one already-built segment: pack it, add its handle, and
        map its live docs' ids and versions, and advance the seqno mark."""
        with self.lock:
            if live is None:
                live = np.ones(segment.num_docs, dtype=bool)
            device = pack_segment(
                segment,
                self.device,
                deleted=np.flatnonzero(~live),
                k1=self.params.k1,
                b=self.params.b,
            )
            handle = SegmentHandle(
                segment=segment,
                device=device,
                base=sum(h.segment.num_docs for h in self.segments),
                live_host=live.copy(),
            )
            seg_idx = len(self.segments)
            self.segments.append(handle)
            for local, doc_id in enumerate(segment.ids):
                if live[local]:
                    self._live_ids[doc_id] = (seg_idx, local)
                    self._versions[doc_id] = segment.doc_version(local)
            if segment.seqnos is not None and len(segment.seqnos):
                self._seqno = max(self._seqno, int(segment.seqnos.max()))
            self._stats_cache = None
            self.generation += 1
            return handle

    @property
    def num_docs(self) -> int:
        """Live (searchable) docs, excluding the unrefreshed buffer."""
        return sum(int(h.live_host.sum()) for h in self.segments)

    def field_stats(self) -> dict[str, FieldStats]:
        """Shard-level BM25 statistics aggregated across segments (cached
        per refresh)."""
        if self._stats_cache is None:
            self._stats_cache = aggregate_field_stats(
                [h.segment for h in self.segments]
            )
        return self._stats_cache

    def compiler_for(
        self,
        handle: SegmentHandle,
        stats: dict[str, FieldStats] | None = None,
        nt_floor: int = 1,
    ) -> Compiler:
        return Compiler(
            fields=handle.device.fields,
            doc_values=handle.device.doc_values,
            mappings=self.mappings,
            params=self.params,
            stats=stats if stats is not None else self.field_stats(),
            nt_floor=nt_floor,
            id_index=lambda: handle.id_index,  # built only if ids compiles
            nested=handle.device.nested,
        )
