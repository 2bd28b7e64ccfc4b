"""IVF partition planes for dense_vector fields (the approximate kNN index).

Port of elasticsearch_tpu/index/ann.py: `default_nprobe`,
`AnnPartitions`, `_train_kmeans`, `build_partitions`, a trimmed
`AnnCache` and `clear_index_ann`, plus `ann_partitions_from_numpy` to
carry planes built elsewhere (the JAX package's) onto the port's device.

The build is the reference's, seeded and deterministic: Lloyd iterations
on a bounded sample (DEFAULT_SEED 17, `default_rng(seed)`), cosine fields
trained on L2-normalised copies, the mean update on the host in float64
with `np.add.at`; one assignment pass labels every vector; clusters
larger than pmax = max(32, round_up_8(ceil(1.5 n_real / C))) split into
several partitions sharing a centroid row; a stable argsort keeps each
partition's slots doc-ascending (the kNN kernels' tie-break relies on
it). Only the assignment runs on the card (K9, ops/ann_device.
assign_all); the regroup is one gather of the resident vector plane,
padding slots zero with the sentinel doc id num_docs.

`AnnCache` keeps one (segment, field)'s planes per (engine uid, segment
handle uid, field), LRU by bytes, with single-flight builds (concurrent
first queries wait on one builder), `prune_dead` (the refresh hook),
`clear` (index delete) and `stats` as plain ints. A segment below
`min_docs` (4,096 by default) is not partitioned: `get_or_build` returns
None and the serving path stays on the exact brute-force kernels. Left
out: the HBM breaker, the metrics registry, `retune`, the recall-gate
and per-search counters (`note_search`, `note_recall_gate`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.ann_device import METRICS, assign_all

DEFAULT_MIN_DOCS = 4096  # below this, brute force wins: don't partition
DEFAULT_MAX_PARTITIONS = 1024
DEFAULT_KMEANS_ITERS = 4
DEFAULT_SAMPLE_PER_PARTITION = 64
DEFAULT_MAX_BYTES = 2 << 30
DEFAULT_SEED = 17


def default_nprobe(n_partitions: int) -> int:
    """Default probe width: an eighth of the partitions (min 4)."""
    return max(4, n_partitions // 8)


@dataclass
class AnnPartitions:
    """One (segment, field)'s IVF planes, on the device."""

    field: str
    metric: str
    centroids: torch.Tensor  # f32[C, d] (split partitions repeat a centroid)
    part_vectors: torch.Tensor  # f32[C, pmax, d]
    part_docs: torch.Tensor  # i32[C, pmax], sentinel = num_docs
    pmax: int
    n_vectors: int
    num_docs: int
    n_clusters: int  # distinct k-means clusters (before splitting)
    nbytes: int

    @property
    def n_partitions(self) -> int:
        return int(self.part_docs.shape[0])

    def tree(self) -> dict[str, Any]:
        """The kernel inputs (ops/ann_device.ann_ivf_search)."""
        return {
            "centroids": self.centroids,
            "part_vectors": self.part_vectors,
            "part_docs": self.part_docs,
        }


def _train_kmeans(
    sample: np.ndarray, n_clusters: int, iters: int, rng, device
) -> np.ndarray:
    """Seeded Lloyd: assignment on the device (K9), host mean update
    (np.add.at in float64). Empty clusters keep their previous centroid.
    Returns f32[n_clusters, d]."""
    n, d = sample.shape
    init = rng.choice(n, size=min(n_clusters, n), replace=False)
    centroids = sample[np.sort(init)].astype(np.float32)
    if len(centroids) < n_clusters:
        centroids = np.pad(centroids, ((0, n_clusters - len(centroids)), (0, 0)))
    for _ in range(max(1, iters)):
        assign = assign_all(torch.from_numpy(centroids).to(device), sample)
        sums = np.zeros((n_clusters, d), dtype=np.float64)
        np.add.at(sums, assign, sample.astype(np.float64))
        counts = np.bincount(assign, minlength=n_clusters)
        nonempty = counts > 0
        centroids = centroids.copy()
        centroids[nonempty] = (
            sums[nonempty] / counts[nonempty, None]
        ).astype(np.float32)
    return centroids


def build_partitions(
    field: str,
    vectors: np.ndarray,
    device_vectors: torch.Tensor,
    num_docs: int,
    metric: str = "cosine",
    n_partitions: int | None = None,
    seed: int = DEFAULT_SEED,
    iters: int = DEFAULT_KMEANS_ITERS,
) -> "AnnPartitions | None":
    """Build one segment's IVF planes. `vectors` is the host f32[N, d]
    matrix (the k-means side), `device_vectors` the resident device copy
    (the regroup gathers from it: no second upload). None when the
    segment holds no real (non-zero) vectors."""
    if metric not in METRICS:
        raise ValueError(f"unknown dense_vector similarity [{metric}]")
    device = device_vectors.device
    n, d = vectors.shape
    # Vector-less docs (zero rows) are left out of the layout here, so the
    # query kernels never check vector presence per candidate.
    real = np.flatnonzero(np.any(vectors != 0, axis=1))
    if len(real) == 0:
        return None
    n_real = len(real)
    if n_partitions is None:
        n_partitions = int(
            np.clip(int(np.sqrt(n_real)), 8, DEFAULT_MAX_PARTITIONS)
        )
    n_partitions = min(n_partitions, n_real)
    rng = np.random.default_rng(seed)
    train = vectors
    if metric == "cosine":
        # Spherical k-means: cluster directions, the space the cosine
        # coarse scan ranks in.
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        train = (vectors / np.where(norms > 0, norms, 1.0)).astype(np.float32)
    sample_idx = real[
        np.sort(
            rng.choice(
                n_real,
                size=min(n_real, DEFAULT_SAMPLE_PER_PARTITION * n_partitions),
                replace=False,
            )
        )
    ]
    centroids = _train_kmeans(
        train[sample_idx], n_partitions, iters, rng, device
    )
    assign = assign_all(torch.from_numpy(centroids).to(device), train[real])
    sizes = np.bincount(assign, minlength=n_partitions)
    # Uniform partition size bounded by the MEAN cluster size: skewed
    # clusters split into several partitions sharing a centroid row.
    pmax = int(np.ceil(1.5 * n_real / n_partitions))
    pmax = max(32, ((pmax + 7) // 8) * 8)
    # Stable argsort over the (doc-ascending) real ids: slots within a
    # partition stay doc-ascending.
    order = real[np.argsort(assign, kind="stable")]
    starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    part_cluster: list[int] = []
    slot_doc_rows: list[np.ndarray] = []
    for c in range(n_partitions):
        if sizes[c] == 0:
            continue
        docs = order[starts[c] : starts[c] + sizes[c]]
        for off in range(0, len(docs), pmax):
            part_cluster.append(c)
            slot_doc_rows.append(docs[off : off + pmax])
    n_parts = len(slot_doc_rows)
    doc_map = np.full((n_parts, pmax), num_docs, dtype=np.int32)
    for i, row in enumerate(slot_doc_rows):
        doc_map[i, : len(row)] = row
    cent_rows = centroids[np.asarray(part_cluster, dtype=np.int64)]
    # Regroup on the device: one gather of the resident plane; padding
    # slots read row 0, then zero.
    dm = torch.from_numpy(doc_map).to(device)
    valid = dm != num_docs
    safe = torch.where(valid, dm, 0).to(torch.int64)
    part_vectors = torch.where(
        valid[:, :, None],
        device_vectors[safe.reshape(-1)].reshape(n_parts, pmax, d),
        0.0,
    ).contiguous()
    return _partitions(field, metric, torch.from_numpy(cent_rows).to(device),
                       part_vectors, dm, pmax, n_real, num_docs,
                       int(np.count_nonzero(sizes)))


def _partitions(field, metric, centroids, part_vectors, part_docs, pmax,
                n_vectors, num_docs, n_clusters) -> AnnPartitions:
    nbytes = sum(int(t.numel() * t.element_size())
                 for t in (part_vectors, part_docs, centroids))
    return AnnPartitions(
        field=field, metric=metric, centroids=centroids.contiguous(),
        part_vectors=part_vectors.contiguous(),
        part_docs=part_docs.contiguous(), pmax=int(pmax),
        n_vectors=int(n_vectors), num_docs=int(num_docs),
        n_clusters=int(n_clusters), nbytes=nbytes,
    )


def ann_partitions_from_numpy(
    field: str,
    metric: str,
    centroids: np.ndarray,
    part_vectors: np.ndarray,
    part_docs: np.ndarray,
    n_vectors: int,
    num_docs: int,
    n_clusters: int,
    device,
) -> AnnPartitions:
    """AnnPartitions from numpy planes built elsewhere (the JAX package's
    AnnPartitions after np.asarray), on `device`."""
    device = torch.device(device)
    put = lambda x, dt: torch.from_numpy(np.array(x, dtype=dt)).to(device)
    pv = put(part_vectors, np.float32)
    return _partitions(field, metric, put(centroids, np.float32), pv,
                       put(part_docs, np.int32), pv.shape[1], n_vectors,
                       num_docs, n_clusters)


class AnnCache:
    """Node-wide store of per-(segment, field) IVF planes, keyed (engine
    uid, segment-handle uid, field): a refresh mints new handles (their
    planes build on the first kNN query), dead handles prune eagerly, and
    LRU eviction keeps the bytes under `max_bytes`. The first kNN query
    against a big-enough segment pays the build; later ones reuse it."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 min_docs: int = DEFAULT_MIN_DOCS):
        self.max_bytes = int(max_bytes)
        self.min_docs = int(min_docs)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, AnnPartitions]" = OrderedDict()
        self._building: dict[tuple, threading.Lock] = {}
        self._bytes = 0
        self._builds = 0
        self._evictions = 0
        self._hits = 0
        self._misses = 0

    def get_or_build(self, engine, handle, field: str, metric: str):
        """The (engine, segment, field) IVF planes, cached or built on first
        use; None when the segment is too small to partition (or holds no
        real vector). A build the budget cannot hold still serves its
        request; only caching is skipped."""
        vectors = handle.segment.vectors.get(field)
        if vectors is None or len(vectors) < self.min_docs:
            return None
        key = (engine.uid, handle.uid, field)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.metric == metric:
                self._entries.move_to_end(key)
                self._hits += 1
                return entry
            gate = self._building.setdefault(key, threading.Lock())
        with gate:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None and entry.metric == metric:
                    self._entries.move_to_end(key)
                    self._hits += 1  # a build raced us and won
                    return entry
                self._misses += 1
            # Built outside self._lock: a k-means pass must not stall
            # lookups of other keys.
            parts = build_partitions(
                field, vectors, handle.device.vectors[field],
                num_docs=handle.device.num_docs, metric=metric,
            )
            if parts is not None:
                with self._lock:
                    self._builds += 1
                self._store(key, parts,
                            frozenset(h.uid for h in engine.segments))
        with self._lock:
            self._building.pop(key, None)
        return parts

    def _store(self, key, parts: AnnPartitions, live_uids) -> bool:
        if parts.nbytes > self.max_bytes:
            return False
        with self._lock:
            if key in self._entries:
                self._drop_locked(key)  # a metric change: never keep both
            for k in [k for k in self._entries
                      if k[0] == key[0] and k[1] not in live_uids]:
                self._drop_locked(k)
            while self._bytes + parts.nbytes > self.max_bytes and self._entries:
                self._drop_locked(next(iter(self._entries)))
            self._entries[key] = parts
            self._bytes += parts.nbytes
            return True

    def _drop_locked(self, key) -> int:
        parts = self._entries.pop(key)
        self._bytes -= parts.nbytes
        self._evictions += 1
        return parts.nbytes

    def prune_dead(self, engine_uid, live_uids) -> int:
        """Drop the planes of `engine_uid` whose segment handle is no longer
        live (the refresh hook). Returns the number dropped."""
        with self._lock:
            dead = [k for k in self._entries
                    if k[0] == engine_uid and k[1] not in live_uids]
            for k in dead:
                self._drop_locked(k)
            return len(dead)

    def clear(self, engine_uid=None) -> int:
        """Drop planes (all, or one engine's: index delete). Returns the
        number dropped."""
        with self._lock:
            keys = [k for k in self._entries
                    if engine_uid is None or k[0] == engine_uid]
            for k in keys:
                self._drop_locked(k)
            return len(keys)

    def stats(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
            return {
                "enabled": True,
                "planes": len(entries),
                "partitions": sum(p.n_partitions for p in entries),
                "centroids": sum(p.n_clusters for p in entries),
                "vectors": sum(p.n_vectors for p in entries),
                "bytes_resident": self._bytes,
                "budget_bytes": self.max_bytes,
                "builds": self._builds,
                "evictions": self._evictions,
                "hit_count": self._hits,
                "miss_count": self._misses,
            }


def clear_index_ann(cache: "AnnCache | None", engines) -> int:
    """Drop every IVF plane of one index's engines (index delete)."""
    if cache is None:
        return 0
    return sum(cache.clear(engine.uid) for engine in engines)
