"""The coalescing price rule of the execution cost model.

Port copy of elasticsearch_tpu/exec/cost.py, trimmed to `coalesce_wins`
and the two seed constants it reads. Left out: `CostModel` (the per plan
class EWMA table), `PlanFeatures`, `seed_ms` and the planner backends —
the port has no planner; every group runs on the device.

The seeds are the reference's, in milliseconds (taken there from TPU
measurements). They only set the ORDER of the coalescing decision, so the
port keeps them as they are: the same rule makes the same buckets in both
packages, and the same buckets give the same launches.
"""

from __future__ import annotations

_DEVICE_LAUNCH_MS = 0.9  # dispatch + result fetch floor per launch
_DEVICE_TILE_MS = 0.0004  # per worklist tile (gather + fold share)


def coalesce_wins(extra_pad_tiles: int) -> bool:
    """Should a smaller worklist group share a larger bucket's coalesced
    launch? True when the padding work it would add (seed per-tile cost)
    costs less than the ONE launch dispatch the merge saves — the decision
    rule behind adaptive sub-bucket splitting (exec/batcher.
    plan_spec_buckets)."""
    return _DEVICE_TILE_MS * max(0, extra_pad_tiles) <= _DEVICE_LAUNCH_MS
