"""Per-plan-class cost model of the execution planner.

Port copy of elasticsearch_tpu/exec/cost.py, trimmed to `PlanFeatures`,
`coalesce_wins`, `seed_ms` for the `device`, `device_batched`,
`cached_mask`, `blockmax`, `blockmax_conj` and `ann_ivf` backends (and
the generic device formula an unknown backend falls to), and `CostModel`.
Left out with the backends that are not ported yet: the `oracle`,
`mesh_spmd` and `packed` seeds and their constants.

A plan class is the hashable identity of "queries that cost the same":
the compiled spec plus the requested k. Costs are tracked per (plan
class, backend) from two sources:

- **Seeds**: closed-form per-backend priors over index statistics. The
  constants are the reference's, in milliseconds, taken there from TPU
  measurements; they are no measurement of the port. They only set the
  ORDER in which the planner explores backends: after MIN_OBS
  observations the measured EWMA replaces them.
- **EWMA calibration**: every executed (class, backend) observation
  updates an exponentially weighted moving average of its real latency,
  as the reference's adaptive replica selection does
  (node/ResponseCollectorService.java:33).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanFeatures:
    """Index-statistics features of one (shard, query) execution."""

    n_docs: int = 0  # corpus size of the segment/shard being searched
    work_tiles: int = 0  # pow-2 worklist tiles the compiled plan touches
    n_clauses: int = 1  # scoring clauses (run-fold width proxy)
    n_shards: int = 1  # stacked shards served by one launch
    # IVF probe work: centroids scanned + nprobe * partition size
    # candidates re-ranked (the ann_ivf seed's scale).
    n_candidates: int = 0


# Seed coefficients, milliseconds: the reference's TPU-derived priors,
# kept as they are so that both packages explore in the same order.
_DEVICE_LAUNCH_MS = 0.9  # dispatch + result fetch floor per launch
_DEVICE_TILE_MS = 0.0004  # per worklist tile (gather + fold share)
_DEVICE_DENSE_MS = 2.0  # per 1M docs for dense-plane eval/top-k
_BLOCKMAX_LAUNCH_MS = 2.1  # two launches + host prune/re-bucket


def coalesce_wins(extra_pad_tiles: int) -> bool:
    """Should a smaller worklist group share a larger bucket's coalesced
    launch? True when the padding work it would add (seed per-tile cost)
    costs less than the ONE launch dispatch the merge saves — the decision
    rule behind adaptive sub-bucket splitting (exec/batcher.
    plan_spec_buckets)."""
    return _DEVICE_TILE_MS * max(0, extra_pad_tiles) <= _DEVICE_LAUNCH_MS


# Backends priced by the device launch + tiles formula below, with the
# dense term when the plan has no worklist. `cached_mask` is the device
# kernels over a filter-cache-substituted plan (index/filter_cache.py):
# the same launch floor, but its work_tiles already exclude the cached
# clauses' worklists (a cached_mask node reads one resident plane), so
# its seed undercuts the full recompute by the filter work the plane
# removed.
_DEVICE_LIKE = ("device", "device_batched", "cached_mask")


def seed_ms(backend: str, feats: PlanFeatures) -> float:
    """Closed-form prior cost (ms) for one query on one backend."""
    shards = max(1, feats.n_shards)
    if backend == "ann_ivf":
        # IVF kNN: priced in candidates examined instead of corpus size,
        # plus the dense share both knn kernels pay; the exact brute force
        # prices through the device formula below, so the seed order
        # flips to ann_ivf when the probe examines a small fraction.
        return (
            _DEVICE_LAUNCH_MS
            + _DEVICE_DENSE_MS * (feats.n_candidates / 1e6)
            + 0.25 * _DEVICE_DENSE_MS * (feats.n_docs / 1e6)
        )
    if backend in ("blockmax", "blockmax_conj"):
        # Both two-phase tile-pruned paths: two launches + a host prune,
        # with roughly half the worklist surviving to the exact launch.
        return (
            _BLOCKMAX_LAUNCH_MS
            + _DEVICE_TILE_MS * feats.work_tiles * 0.5 * shards
        )
    # Device kernels: sparse work scales with the worklist, dense work
    # with the corpus (the caller sets work_tiles = 0 for dense plans).
    cost = _DEVICE_LAUNCH_MS + _DEVICE_TILE_MS * feats.work_tiles * shards
    if backend in _DEVICE_LIKE and feats.work_tiles == 0:
        # An unknown backend gets only the launch floor: MIN_OBS
        # exploration tries it regardless, and its EWMA takes over.
        cost += _DEVICE_DENSE_MS * (feats.n_docs / 1e6) * max(
            1, feats.n_clauses
        ) * shards
    return cost


class CostModel:
    """EWMA-calibrated latency estimates per (plan class, backend)."""

    ALPHA = 0.25  # EWMA smoothing factor for new observations
    MAX_CLASSES = 512  # LRU bound on tracked (class, backend) entries

    def __init__(self):
        self._lock = threading.Lock()
        # (plan_class, backend) -> [ewma_seconds, observation_count]
        self._table: OrderedDict[tuple, list] = OrderedDict()

    def observe(self, plan_class, backend: str, seconds: float) -> None:
        """Fold one measured execution latency into the class EWMA."""
        key = (plan_class, backend)
        with self._lock:
            entry = self._table.get(key)
            if entry is None:
                self._table[key] = [float(seconds), 1]
            else:
                entry[0] += self.ALPHA * (float(seconds) - entry[0])
                entry[1] += 1
                self._table.move_to_end(key)
            while len(self._table) > self.MAX_CLASSES:
                self._table.popitem(last=False)

    def observations(self, plan_class, backend: str) -> int:
        with self._lock:
            entry = self._table.get((plan_class, backend))
            return 0 if entry is None else entry[1]

    def ewma_s(self, plan_class, backend: str) -> float | None:
        with self._lock:
            entry = self._table.get((plan_class, backend))
            return None if entry is None else entry[0]

    def predicted_ms(
        self, plan_class, backend: str, feats: PlanFeatures | None
    ) -> float:
        """Calibrated estimate when observed, seed otherwise (inf when
        neither is available)."""
        ewma = self.ewma_s(plan_class, backend)
        if ewma is not None:
            return ewma * 1e3
        if feats is None:
            return float("inf")
        return seed_ms(backend, feats)

    def snapshot(self, limit: int = 64) -> dict:
        """The EWMA table of the most recently used classes."""
        with self._lock:
            items = list(self._table.items())[-limit:]
        out: dict = {}
        for (plan_class, backend), (ewma, count) in items:
            out.setdefault(repr(plan_class), {})[backend] = {
                "ewma_ms": round(ewma * 1e3, 4),
                "observations": count,
            }
        return out
