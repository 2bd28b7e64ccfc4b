"""Device-resident filter cache: reusable mask planes on the card.

Port of elasticsearch_tpu/index/filter_cache.py, the counterpart of
Lucene's `IndicesQueryCache` wrapping an LRUQueryCache under a
`UsageTrackingQueryCachingPolicy`. Where Lucene caches a filter's
DocIdSet per (query, leaf reader), the cached object here is the filter
subtree's evaluated matched plane, a bool[num_docs] tensor on the
segment's device, so a repeated filter costs one plane read (or a gather
at the candidates) instead of re-deriving its posting unions on every
launch.

Kept: `FilterCache` (usage-tracking admission over a bounded history
ring, LRU eviction under a byte budget, the stale-generation purge
`_purge_stale_locked`, `prune_dead`, `purge_scope`, `clear`, `keys`,
`stats` and `disabled_stats`, with the reference's defaults: 256 MiB,
min_freq 2, a history of 256 sightings), `mesh_cache_scope`,
`clear_index_planes`, `record_filter_usage`, `record_knn_filter_usage`,
`apply_cached_masks` and `mask_group_token`. The counters are plain ints
under the reference's `stats()` names. Left out, each with its ROADMAP
item: the HBM circuit breaker (`breaker=` and the BreakerError loop wait
for A6's common/breaker.py), `retune` and its `retunes` list (A13's
remediation), the metrics registry with the windowed eviction counter
(A12) and the `_nodes/stats` section (A9). No environment variable is
read: the budget, threshold and history are constructor arguments
(`Node(filter_cache=FilterCache(...))`).

Keys. The solo key is (engine uid, 0, segment-handle uid, canonical
filter key): segment postings are immutable and planes exclude the live
mask, so the handle uid alone scopes validity; new and merged segments
mint fresh uids, so a stale plane is never served, while planes of
unchanged segments keep hitting across refreshes. Planes of dead handles
are pruned on the next store (`live_uids`) and on refresh
(`prune_dead`). The mesh path keys per shard row: (("sharded",
engine-uid tuple), ("row", shard, shard signature, docs pad), 0, key),
the signature being the shard's (handle uid, live epoch) tuple, so a
refresh of one shard invalidates only that shard's row
(parallel/mesh_serving.MeshIndex._apply_filter_cache). Soft deletes need
no invalidation: the live mask ANDs in at query time as it does for a
recomputed filter.

Shared state. A plane is read by many launches and never written: the
executors only read `seg["masks"][slot]` (a broadcast view or a gather),
and every plane the build functions store is a tensor that owns its memory, so
evicting or clearing an entry drops the last reference to it. Bit
exactness is the contract: a plane is the filter subtree's own
evaluation, and filter context discards scores, so substituting
`("cached_mask", slot)` for the subtree cannot move ids, order, fp32
scores or totals on any path.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict, deque
from typing import Any, Callable

import numpy as np

DEFAULT_MAX_BYTES = 256 << 20
DEFAULT_MIN_FREQ = 2
DEFAULT_HISTORY = 256


class FilterCache:
    """Mask-plane store with usage-tracking admission and LRU eviction."""

    def __init__(
        self,
        max_bytes: int = DEFAULT_MAX_BYTES,
        min_freq: int = DEFAULT_MIN_FREQ,
        history: int = DEFAULT_HISTORY,
    ):
        self.max_bytes = int(max_bytes)
        self.min_freq = max(1, int(min_freq))
        self._lock = threading.Lock()
        # key -> (plane, nbytes), least recently used first.
        self._entries: OrderedDict[tuple, tuple[Any, int]] = OrderedDict()
        self._bytes = 0
        # The usage-tracking history ring: one sighting per user request
        # (record_filter_usage), the policy's bounded frequency count.
        self._history: deque = deque(maxlen=max(1, int(history)))
        self._freq: Counter = Counter()
        self._hits = 0
        self._misses = 0
        self._admissions = 0
        self._evictions = 0
        self._mask_reuse = 0

    # ------------------------------------------------------------ admission

    def record(self, norm_keys) -> None:
        """Count one sighting of each filter key. Old sightings roll off
        the ring, so a filter must recur within the window to reach the
        threshold."""
        with self._lock:
            for key in norm_keys:
                if len(self._history) == self._history.maxlen:
                    oldest = self._history[0]
                    self._freq[oldest] -= 1
                    if self._freq[oldest] <= 0:
                        del self._freq[oldest]
                self._history.append(key)
                self._freq[key] += 1

    def should_admit(self, norm_key) -> bool:
        """Has this filter recurred enough to deserve residency?"""
        with self._lock:
            return self._freq.get(norm_key, 0) >= self.min_freq

    # -------------------------------------------------------------- storage

    def get(self, key: tuple):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return entry[0]

    def put(self, key: tuple, plane, nbytes: int, live_uids=None) -> bool:
        """Store one plane under the byte budget. Returns False when the
        budget cannot hold it even after evicting everything else (the
        caller goes on with its freshly computed plane; only residency is
        declined). `live_uids` (solo keys) names the engine's current
        segment-handle uids, so planes of merged-away segments are
        pruned at once."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            while self._bytes + nbytes > self.max_bytes and self._entries:
                self._evict_lru_locked()
            self._entries[key] = (plane, nbytes)
            self._bytes += nbytes
            self._admissions += 1
            # Entries that can never be served again free their memory
            # now instead of waiting for the LRU to reach them.
            self._purge_stale_locked(key)
            if live_uids is not None:
                self._prune_dead_handles_locked(key[0], live_uids, key)
            return True

    def _drop_locked(self, key: tuple) -> int:
        """Unlink one entry (bytes, eviction count): the one accounting
        site of every eviction path. Returns the entry's byte size."""
        _plane, nbytes = self._entries.pop(key)
        self._bytes -= nbytes
        self._evictions += 1
        return nbytes

    def _evict_lru_locked(self) -> int:
        return self._drop_locked(next(iter(self._entries)))

    def _purge_stale_locked(self, fresh_key: tuple) -> None:
        """Drop same-scope entries whose generation (an int key[1])
        predates `fresh_key`'s."""
        if len(fresh_key) < 2 or not isinstance(fresh_key[1], int):
            return
        scope, generation = fresh_key[0], fresh_key[1]
        stale = [
            k for k in self._entries
            if k[0] == scope and isinstance(k[1], int) and k[1] < generation
        ]
        for k in stale:
            self._drop_locked(k)

    def _prune_dead_handles_locked(self, scope, live_uids, fresh_key) -> None:
        """Drop same-scope entries whose segment-handle uid (key[2]) is no
        longer among the engine's live handles."""
        dead = [
            k for k in self._entries
            if k[0] == scope and k != fresh_key and k[2] not in live_uids
        ]
        for k in dead:
            self._drop_locked(k)

    def prune_dead(self, scope, live_uids) -> int:
        """Drop every plane of `scope` whose segment-handle uid is no
        longer live (the refresh hook). Returns the number dropped."""
        with self._lock:
            dead = [
                k for k in self._entries
                if k[0] == scope and k[2] != 0 and k[2] not in live_uids
            ]
            for k in dead:
                self._drop_locked(k)
            return len(dead)

    def purge_scope(self, scope, keep) -> int:
        """Drop every `scope` entry whose signature component (key[1]) is
        not in `keep`: the mesh view's invalidation on a snapshot change
        (rows of changed shards go, rows of unchanged shards stay).
        Returns the number dropped."""
        with self._lock:
            stale = [
                k for k in self._entries if k[0] == scope and k[1] not in keep
            ]
            for k in stale:
                self._drop_locked(k)
            return len(stale)

    def note_reuse(self, n: int) -> None:
        """Count `n` cached planes substituted into one launch."""
        if n > 0:
            with self._lock:
                self._mask_reuse += n

    def clear(self, scope=None) -> int:
        """Drop entries (all, or one engine / mesh scope: `_cache/clear`).
        Returns the number of planes dropped."""
        with self._lock:
            if scope is None:
                keys = list(self._entries)
            else:
                keys = [k for k in self._entries if k[0] == scope]
            for k in keys:
                self._drop_locked(k)
            return len(keys)

    def keys(self) -> list[tuple]:
        """Snapshot of the live entry keys, least recently used first."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "entries": len(self._entries),
                "bytes_resident": self._bytes,
                "budget_bytes": self.max_bytes,
                "hit_count": self._hits,
                "miss_count": self._misses,
                "admissions": self._admissions,
                "evictions": self._evictions,
                "mask_reuse": self._mask_reuse,
            }

    @staticmethod
    def disabled_stats() -> dict:
        """The stats shape of a node without a filter cache."""
        return {
            "enabled": False,
            "entries": 0,
            "bytes_resident": 0,
            "budget_bytes": 0,
            "hit_count": 0,
            "miss_count": 0,
            "admissions": 0,
            "evictions": 0,
            "mask_reuse": 0,
        }


def mesh_cache_scope(engines) -> tuple:
    """The scope of mesh-path plane keys, one index's engine-uid tuple:
    the one definition the store side (parallel/mesh_serving.MeshView)
    and the clear side (Node.clear_cache, delete_index) share."""
    return ("sharded", tuple(e.uid for e in engines))


def clear_index_planes(cache: "FilterCache | None", engines) -> int:
    """Drop every plane of one index: the per-engine solo scopes and the
    mesh scope. Returns the number of planes dropped."""
    if cache is None:
        return 0
    cleared = 0
    for engine in engines:
        cleared += cache.clear(engine.uid)
    cleared += cache.clear(mesh_cache_scope(engines))
    return cleared


def record_filter_usage(
    cache: "FilterCache | None", query, record: bool = True
) -> list:
    """Count one admission sighting for each distinct cacheable filter
    subtree of `query`: the one recording helper (a SearchService's own
    request, the coordinator once per user request, a ShardedIndex's
    direct search). `record=False` collects without counting, for a
    request already counted upstream (the per-shard scatter, the mesh
    consult, the batcher's solo retry). Returns the collected
    [(group, idx, key)] entries for apply_cached_masks."""
    from ..query.compile import collect_cacheable_filters

    if cache is None:
        return []
    entries = collect_cacheable_filters(query)
    if record and entries:
        # bool.filter = [F, F] (or F in both filter and must_not) is still
        # one sighting of F.
        cache.record(list(dict.fromkeys(k for _g, _i, k in entries)))
    return entries


def record_knn_filter_usage(cache, knn, record: bool = True) -> None:
    """One admission sighting for a knn section's filter, under the same
    once-per-user-request contract as record_filter_usage; the filter's
    plane is keyed and admitted as a bool filter clause's is."""
    if cache is None or knn is None or knn.filter is None or not record:
        return
    from ..query.compile import cacheable_filter_key

    norm = cacheable_filter_key(knn.filter)
    if norm is not None:
        cache.record([norm])


# ---------------------------------------------------------------------------
# Plan substitution: compiled bool spec -> masked bool spec.
# ---------------------------------------------------------------------------


def apply_cached_masks(
    cache: FilterCache | None,
    key_prefix: tuple,
    query,
    compiled,
    build_mask: Callable[[tuple, Any, tuple], tuple[Any, int]],
    const_fill: Callable[[], dict] | None = None,
    entries: list | None = None,
    live_uids=None,
    store_planes: bool = True,
):
    """Substitute cached mask planes for a plan's cacheable top-level
    filter-context clauses.

    `key_prefix` scopes the cache key (one segment: (engine uid, 0,
    handle uid); unused under `store_planes=False`, where `build_mask` keys
    its own rows); `build_mask(child_spec, child_arrays, norm_key) ->
    (plane, nbytes)` evaluates a missing plane, outside the cache lock (it
    launches kernels); `const_fill()` builds the substituted clause's
    arrays (default a scalar zero boost; the sharded paths give one per
    shard, so every plan leaf keeps its leading axis).

    Returns (compiled', masks, reused): `masks` maps a mask slot to its
    plane for the executors' seg["masks"] (empty: nothing substituted),
    `reused` counts planes served from the cache. Clause order and count
    and the lead choice are kept, so sparse eligibility, lead folds and
    unify/pad see a structurally intact bool spec."""
    from ..query.compile import (
        CompiledQuery,
        collect_cacheable_filters,
        make_bool_spec,
    )

    if cache is None:
        return compiled, {}, 0
    spec = compiled.spec
    if not (isinstance(spec, tuple) and spec and spec[0] == "bool"):
        return compiled, {}, 0
    if entries is None:
        entries = collect_cacheable_filters(query)
    if not entries:
        return compiled, {}, 0
    must_s, should_s, filter_s, must_not_s = spec[1:5]
    lead = spec[6]
    n_must, n_should, n_filter = len(must_s), len(should_s), len(filter_s)
    children = list(compiled.arrays["children"])
    new_filter = list(filter_s)
    new_must_not = list(must_not_s)
    masks: dict[int, Any] = {}
    reused = 0
    slot = 0
    for group, idx, norm in entries:
        if group == "filter":
            if idx >= n_filter:
                continue  # the compiler rewrote the clause list
            if lead >= 0 and idx == lead:
                # The lead-driven fold reads its candidates straight off
                # this filter's posting span: masking it would only
                # discard the candidate source.
                continue
            child_spec = new_filter[idx]
            flat = n_must + n_should + idx
        else:
            if idx >= len(must_not_s):
                continue
            child_spec = new_must_not[idx]
            flat = n_must + n_should + n_filter + idx
        if child_spec == ("match_none",):
            # An unmapped field's filter is free to evaluate, and skipping
            # it keeps a later mapping from pinning a stale plane.
            continue
        # store_planes=False (the mesh rows): `build_mask` manages its own
        # per-row entries, and the per-request assembly is never cached.
        plane = cache.get((*key_prefix, norm)) if store_planes else None
        if plane is None:
            if not cache.should_admit(norm):
                continue
            plane, nbytes = build_mask(child_spec, children[flat], norm)
            if store_planes:
                cache.put(
                    (*key_prefix, norm), plane, nbytes, live_uids=live_uids
                )
        else:
            reused += 1
        masks[slot] = plane
        sub = ("cached_mask", slot)
        if group == "filter":
            new_filter[idx] = sub
        else:
            new_must_not[idx] = sub
        children[flat] = (
            const_fill() if const_fill is not None
            else {"boost": np.float32(0.0)}
        )
        slot += 1
    if not masks:
        return compiled, {}, 0
    cache.note_reuse(reused)
    new_spec = make_bool_spec(
        must_s, should_s, new_filter, new_must_not, msm=spec[5], lead=lead
    )
    new_arrays = dict(compiled.arrays)
    new_arrays["children"] = tuple(children)
    return CompiledQuery(spec=new_spec, arrays=new_arrays), masks, reused


def mask_group_token(masks: dict[int, Any]) -> tuple:
    """Launch-grouping identity of a plan's mask planes: coalesced
    batchmates share one launch (and one seg["masks"]) only when every
    slot points at the same plane object. The cache entries (or the local
    plan) hold the planes alive for the token's lifetime, so id() cannot
    alias here."""
    return tuple((slot, id(plane)) for slot, plane in sorted(masks.items()))
