"""Continuous micro-batching scheduler for the search serving path.

Port copy of elasticsearch_tpu/exec/batcher.py, trimmed to
`plan_spec_buckets` and `MicroBatcher` with the reference's behaviour:

- concurrent searches that share a group key (same index searcher, same
  query-AST shape, exec/planner.ast_signature) coalesce into ONE call of
  the searcher's `search_many`, which runs one padded launch per (shard,
  spec group) instead of one per request;
- an arrival into an idle group launches immediately (sequential traffic
  pays no wait); arrivals while the group has a batch in flight or queued
  wait up to `max_wait_s` for companions (ESTPU_EXEC_BATCH_WAIT_MS,
  default 4 ms); a batch carries at most `max_batch` riders (64);
- past `queue_limit` queued searches (256) an arrival is shed with
  `BatcherRejected`, which the node answers as HTTP 429
  es_rejected_execution_exception with a Retry-After hint;
- failure isolation: a rider that fails inside a coalesced launch (other
  than with a request-shaped ValueError/TypeError) is retried ONCE on its
  own through the searcher's plain `search`, on its caller's thread, with
  `record_filter_usage=False` (the searcher contract: `search(request,
  record_filter_usage=True)` and `search_many(requests)`); a
  group whose coalesced launches fail QUARANTINE_FAILURES (3) times in a
  row is served per request for QUARANTINE_TTL_S;
- a waiting caller whose scheduler thread died or wedged runs its own
  request, so a search never hangs on the scheduler.

`stats()` reports plain counters: batches, requests, coalesced requests,
occupancy (riders per launch: histogram, mean, max), sheds, individual
retries, quarantine activity and queue-wait p50/p99.

Left out: QoS tenant lanes (deficit-round-robin drain, weighted shedding),
task cancellation and deadlines, injected faults, the metrics registry and
tracing spans.
"""

from __future__ import annotations

import math
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np

# Errors that must surface verbatim, never trigger an individual retry:
# ValueError/TypeError are request-shaped (the same request would fail
# solo too).
_NO_RETRY_ERRORS = (ValueError, TypeError)


class BatcherRejected(Exception):
    """The batch queue is full: the search was shed (HTTP 429)."""

    def __init__(self, message: str, retry_after_s: int):
        super().__init__(message)
        self.retry_after_s = retry_after_s


def plan_spec_buckets(spec_rows, n_shards: int = 1) -> list[tuple]:
    """Adaptive worklist sub-bucketing for coalesced launches.

    `spec_rows`: [(compiled spec, row count or row list)] — the same-spec
    groups of a batch. Returns a list of buckets (tuples of specs); each
    bucket shares ONE padded launch at its per-position-max bucket, the
    rest launch separately. Greedy largest-first: a smaller group joins a
    bucket only when (a) its spec unifies with the bucket's (structural
    compatibility) and (b) the padding tiles it would pay cost less than
    the launch it saves (exec/cost.coalesce_wins).
    """
    from ..query.compile import SpecUnifyError, unify_specs
    from .cost import coalesce_wins
    from .planner import spec_work_tiles

    items = []
    for spec, rows in spec_rows:
        n = rows if isinstance(rows, int) else len(rows)
        items.append((spec_work_tiles(spec), spec, max(1, n)))
    items.sort(key=lambda it: -it[0])
    # Each bucket: [target_spec, target_tiles, total_rows, [member specs]]
    buckets: list[list] = []
    for tiles, spec, n in items:
        placed = False
        for b in buckets:
            try:
                target = unify_specs([b[0], spec])
            except SpecUnifyError:
                continue
            # Price the merge against the UNIFIED target: existing bucket
            # members pay any growth too, and all of that padding must beat
            # the one launch the merge saves.
            t_tiles = spec_work_tiles(target)
            extra = ((t_tiles - b[1]) * b[2] + (t_tiles - tiles) * n) * max(
                1, n_shards
            )
            if not coalesce_wins(extra):
                continue
            b[0] = target
            b[1] = t_tiles
            b[2] += n
            b[3].append(spec)
            placed = True
            break
        if not placed:
            buckets.append([spec, tiles, n, [spec]])
    return [tuple(b[3]) for b in buckets]


@dataclass
class _Pending:
    searcher: object
    request: object
    group: tuple
    enqueued_at: float
    launch_at: float
    event: threading.Event = field(default_factory=threading.Event)
    claimed: bool = False  # popped for execution (or shed)
    result: object = None
    error: Exception | None = None
    queue_wait_s: float = 0.0
    # Failed while riding a coalesced launch: the CALLER thread runs one
    # individual retry on the per-request path.
    retry_solo: bool = False


class MicroBatcher:
    """One node's continuous micro-batching scheduler."""

    # A group key whose coalesced launches failed this many times in a
    # row is quarantined to the per-request path for QUARANTINE_TTL_S
    # (then paroled and allowed to coalesce again).
    QUARANTINE_FAILURES = 3
    QUARANTINE_TTL_S = 30.0

    def __init__(
        self,
        max_wait_s: float | None = None,
        max_batch: int = 64,
        queue_limit: int = 256,
    ):
        if max_wait_s is None:
            max_wait_s = (
                float(os.environ.get("ESTPU_EXEC_BATCH_WAIT_MS", 4.0)) / 1e3
            )
        self.max_wait_s = max_wait_s
        self.max_batch = max(1, max_batch)
        self.queue_limit = max(1, queue_limit)
        self._cv = threading.Condition()
        self._queues: dict[tuple, deque[_Pending]] = {}
        self._in_flight: set[tuple] = set()
        self._thread: threading.Thread | None = None
        self._closed = False
        # Plain counters (under _cv).
        self._batches = 0
        self._requests = 0
        self._coalesced = 0
        self._shed = 0
        self._retried = 0
        self._quarantined_total = 0
        self._quarantine_hits = 0
        self._launches = 0  # batches with at least one live rider
        self._riders = 0  # riders over those launches
        self._occupancy_max = 0
        self._occupancy: dict[int, int] = {}  # pow-2 bucket -> batches
        self._wait_samples: deque[float] = deque(maxlen=512)
        # Failure isolation / quarantine state (under _cv).
        self._group_failures: dict[tuple, int] = {}
        # group -> (parole time, weakref to the offending searcher). The
        # weakref pins identity: id() reuse by a NEW searcher at the same
        # address must not inherit a dead group's quarantine.
        self._quarantine: dict[tuple, tuple[float, object]] = {}

    # ------------------------------------------------------------- public

    def execute(self, searcher, request, group_key=()) -> object:
        """Run one search through the batching queue (blocking).

        Returns the searcher's response; raises the search's own error,
        or BatcherRejected when the queue is full."""
        self._ensure_thread()
        group = (id(searcher), group_key)
        now = time.monotonic()
        with self._cv:
            # Expired quarantines (and ones whose searcher died) must not
            # accumulate or leak onto unrelated work.
            for g, (t, ref) in list(self._quarantine.items()):
                if now >= t or ref() is None:
                    self._quarantine.pop(g, None)
                    self._group_failures.pop(g, None)
            entry = self._quarantine.get(group)
            quarantined = entry is not None and entry[1]() is searcher
            if quarantined:
                self._quarantine_hits += 1
        if quarantined:
            # Repeat offender: serve it on the plain per-request path so
            # it cannot take batchmates down with it.
            return searcher.search(request)
        with self._cv:
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.queue_limit:
                self._shed += 1
                raise BatcherRejected(
                    f"rejected execution of search: exec batch queue is "
                    f"full [queued={depth}, limit={self.queue_limit}]",
                    self._retry_after_locked(depth),
                )
            queue = self._queues.setdefault(group, deque())
            # Idle groups launch immediately; a group with work in flight
            # (or already queued) opens the continuous-batching window so
            # companions coalesce while the current batch executes.
            busy = bool(queue) or group in self._in_flight
            item = _Pending(
                searcher=searcher,
                request=request,
                group=group,
                enqueued_at=now,
                launch_at=now + (self.max_wait_s if busy else 0.0),
            )
            queue.append(item)
            self._cv.notify_all()
        self._await(item)
        if item.retry_solo:
            # Failure isolation: one individual retry on the plain
            # per-request path, run HERE so a batch of failures never
            # serializes on the scheduler thread. record_filter_usage=
            # False: the coalesced attempt's search_many already counted
            # this request's filter-cache sighting.
            return searcher.search(request, record_filter_usage=False)
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def _retry_after_locked(self, depth: int) -> int:
        """Retry-After seconds for a shed request: the observed queue-wait
        p50 scaled by how many batches deep the queue is, clamped to
        [1, 30] s. Caller holds _cv."""
        if self._wait_samples:
            p50_s = float(np.percentile(
                np.asarray(self._wait_samples, dtype=np.float64), 50
            ))
        else:
            p50_s = self.max_wait_s
        estimate = p50_s * (1.0 + depth / self.max_batch)
        return int(min(30, max(1, math.ceil(estimate))))

    def stats(self) -> dict:
        """One consistent snapshot of the counters. `occupancy_*` count
        riders per launch (a launch is one search_many call with at least
        one rider); `coalesced_requests` counts riders that shared a
        launch with at least one other."""
        with self._cv:
            samples = np.asarray(self._wait_samples, dtype=np.float64)
            out = {
                "max_wait_ms": self.max_wait_s * 1e3,
                "batches": self._batches,
                "requests": self._requests,
                "coalesced_requests": self._coalesced,
                "occupancy_histogram": {
                    str(b): n for b, n in sorted(self._occupancy.items())
                },
                "occupancy_mean": (
                    self._riders / self._launches if self._launches else 0.0
                ),
                "occupancy_max": self._occupancy_max,
                "rejected": self._shed,
                "queued": sum(len(q) for q in self._queues.values()),
                "retried_individually": self._retried,
                "groups_quarantined": self._quarantined_total,
                "quarantine_hits": self._quarantine_hits,
                "quarantined_now": len(self._quarantine),
            }
        for name, q in (("queue_wait_p50_ms", 50), ("queue_wait_p99_ms", 99)):
            out[name] = (
                float(np.percentile(samples, q)) * 1e3 if samples.size else 0.0
            )
        return out

    # ----------------------------------------------------------- internal

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return
            self._closed = False
            self._thread = threading.Thread(
                target=self._loop, name="exec-batcher", daemon=True
            )
            self._thread.start()

    def _await(self, item: _Pending) -> None:
        """Wait for the scheduler to serve `item`, with a self-healing
        fallback: if the scheduler thread ever dies (or wedges past the
        item's launch window), the caller claims its own item and runs it
        alone — a request can never hang on scheduler health."""
        while not item.event.wait(timeout=0.25):
            with self._cv:
                if item.claimed or item.event.is_set():
                    continue  # executing now; keep waiting
                overdue = time.monotonic() > item.launch_at + 2.0
                dead = self._thread is None or not self._thread.is_alive()
                if not (overdue or dead):
                    continue
                item.claimed = True
                queue = self._queues.get(item.group)
                if queue is not None:
                    try:
                        queue.remove(item)
                    except ValueError:
                        pass
                    if not queue:
                        self._queues.pop(item.group, None)
            self._run_batch([item])
            return

    def _loop(self) -> None:
        while True:
            batch: list[_Pending] = []
            group = None
            with self._cv:
                while not self._closed and not any(self._queues.values()):
                    self._cv.wait()
                if self._closed:
                    return
                now = time.monotonic()
                best_due = None
                for g, q in self._queues.items():
                    if not q:
                        continue
                    due = min(it.launch_at for it in q)
                    if len(q) >= self.max_batch or due <= now:
                        if best_due is None or due < best_due:
                            best_due, group = due, g
                if group is None:
                    soonest = min(
                        min(it.launch_at for it in q)
                        for q in self._queues.values()
                        if q
                    )
                    self._cv.wait(timeout=max(1e-4, soonest - now))
                    continue
                queue = self._queues[group]
                while queue and len(batch) < self.max_batch:
                    it = queue.popleft()
                    if it.claimed:
                        continue
                    it.claimed = True
                    batch.append(it)
                if not queue:
                    self._queues.pop(group, None)
                if not batch:
                    continue
                self._in_flight.add(group)
            try:
                self._run_batch(batch)
            finally:
                with self._cv:
                    self._in_flight.discard(group)
                    self._cv.notify_all()

    def _run_batch(self, batch: list[_Pending]) -> None:
        now = time.monotonic()
        for item in batch:
            item.queue_wait_s = now - item.enqueued_at
        try:
            results = batch[0].searcher.search_many(
                [it.request for it in batch]
            )
        # Whole-launch failure fans out to per-rider individual retries.
        except Exception as e:  # noqa: BLE001
            results = [e] * len(batch)
        retry = 0
        for item, result in zip(batch, results):
            if isinstance(result, Exception):
                if isinstance(result, _NO_RETRY_ERRORS):
                    item.error = result  # would fail solo too
                else:
                    item.retry_solo = True
                    retry += 1
            else:
                item.result = result
        for item in batch:
            item.event.set()
        group = batch[0].group
        n = len(batch)
        with self._cv:
            self._batches += 1
            self._requests += n
            self._retried += retry
            if retry:
                # Repeat-offender tracking: consecutive coalesced failures
                # quarantine the group to the per-request path.
                while len(self._group_failures) > 4096:
                    self._group_failures.pop(next(iter(self._group_failures)))
                fails = self._group_failures.get(group, 0) + 1
                self._group_failures[group] = fails
                if (
                    fails >= self.QUARANTINE_FAILURES
                    and group not in self._quarantine
                ):
                    self._quarantine[group] = (
                        time.monotonic() + self.QUARANTINE_TTL_S,
                        weakref.ref(batch[0].searcher),
                    )
                    self._quarantined_total += 1
            else:
                self._group_failures.pop(group, None)
            if n >= 2:
                self._coalesced += n
            self._launches += 1
            self._riders += n
            self._occupancy_max = max(self._occupancy_max, n)
            bucket = 1 << max(0, n - 1).bit_length()
            self._occupancy[bucket] = self._occupancy.get(bucket, 0) + 1
            for item in batch:
                self._wait_samples.append(item.queue_wait_s)
