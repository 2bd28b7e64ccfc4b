"""The port's micro-batcher: scheduling contracts, failure isolation, load
shedding, and a node whose concurrent `_search` requests coalesce into
batched launches yet answer exactly as they do one at a time.

The scheduling tests drive `MicroBatcher` with a stub searcher, as the JAX
package's tests/test_exec_batcher.py does; the node tests run the port on
the CPU (plain kernel versions) over a multi-shard index.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.exec.batcher import (
    BatcherRejected,
    MicroBatcher,
    plan_spec_buckets,
)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestServer

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)


class StubSearcher:
    """search_many records batch sizes (optionally slow, optionally
    failing some riders); search serves one request alone."""

    def __init__(self, delay_s: float = 0.0, fail=lambda r: False):
        self.delay_s = delay_s
        self.fail = fail
        self.calls: list[list] = []
        self.solo: list = []
        self.lock = threading.Lock()

    def search_many(self, requests):
        with self.lock:
            self.calls.append(list(requests))
        if self.delay_s:
            time.sleep(self.delay_s)
        return [
            RuntimeError(f"launch failed for {r}") if self.fail(r) else f"r:{r}"
            for r in requests
        ]

    def search(self, request, record_filter_usage=True):
        with self.lock:
            self.solo.append(request)
        return f"solo:{request}"


def _concurrent(batcher, searcher, names, stagger_s=0.0):
    results: dict = {}
    errors: dict = {}

    def go(i, name):
        time.sleep(stagger_s * i)
        try:
            results[name] = batcher.execute(searcher, name)
        except Exception as e:  # noqa: BLE001
            errors[name] = e

    threads = [threading.Thread(target=go, args=(i, n)) for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results, errors


def test_idle_group_launches_immediately():
    batcher = MicroBatcher(max_wait_s=5.0)
    stub = StubSearcher()
    t0 = time.monotonic()
    assert batcher.execute(stub, "q1") == "r:q1"
    assert time.monotonic() - t0 < 1.0
    assert [len(c) for c in stub.calls] == [1]
    stats = batcher.stats()
    assert stats["batches"] == 1 and stats["requests"] == 1
    assert stats["coalesced_requests"] == 0 and stats["occupancy_max"] == 1
    batcher.close()


def test_wait_window_defaults_to_four_ms(monkeypatch):
    monkeypatch.delenv("ESTPU_EXEC_BATCH_WAIT_MS", raising=False)
    assert MicroBatcher().max_wait_s == pytest.approx(0.004)
    monkeypatch.setenv("ESTPU_EXEC_BATCH_WAIT_MS", "25")
    batcher = MicroBatcher()
    assert batcher.max_wait_s == pytest.approx(0.025)
    assert batcher.max_batch == 64 and batcher.queue_limit == 256


def test_concurrent_riders_coalesce():
    """Arrivals while a batch is in flight ride ONE next launch."""
    batcher = MicroBatcher(max_wait_s=0.4)
    stub = StubSearcher(delay_s=0.6)
    names = [f"q{i}" for i in range(5)]
    results, errors = _concurrent(batcher, stub, names, stagger_s=0.02)
    assert not errors
    assert results == {n: f"r:{n}" for n in names}
    sizes = [len(c) for c in stub.calls]
    assert max(sizes) >= 2 and sum(sizes) == 5
    stats = batcher.stats()
    assert stats["occupancy_max"] >= 2
    assert stats["coalesced_requests"] >= 2
    assert stats["occupancy_mean"] == pytest.approx(5 / len(sizes))
    batcher.close()


def test_max_batch_caps_a_launch():
    batcher = MicroBatcher(max_wait_s=0.3, max_batch=2)
    stub = StubSearcher(delay_s=0.2)
    results, errors = _concurrent(batcher, stub, [f"q{i}" for i in range(6)],
                                  stagger_s=0.01)
    assert not errors and len(results) == 6
    assert max(len(c) for c in stub.calls) <= 2


def test_failed_rider_is_retried_individually():
    batcher = MicroBatcher(max_wait_s=0.25)
    stub = StubSearcher(delay_s=0.2, fail=lambda r: r == "bad")
    results, errors = _concurrent(batcher, stub, ["a", "bad", "b"], stagger_s=0.02)
    assert not errors
    assert results == {"a": "r:a", "bad": "solo:bad", "b": "r:b"}
    assert stub.solo == ["bad"]
    assert batcher.stats()["retried_individually"] == 1
    batcher.close()


def test_request_shaped_errors_are_not_retried():
    class Shaped(StubSearcher):
        def search_many(self, requests):
            return [ValueError("bad query") for _ in requests]

    batcher = MicroBatcher(max_wait_s=0.0)
    stub = Shaped()
    with pytest.raises(ValueError, match="bad query"):
        batcher.execute(stub, "q")
    assert stub.solo == [] and batcher.stats()["retried_individually"] == 0
    batcher.close()


def test_group_is_quarantined_after_three_failures():
    batcher = MicroBatcher(max_wait_s=0.0)
    stub = StubSearcher(fail=lambda r: True)
    for i in range(MicroBatcher.QUARANTINE_FAILURES):
        assert batcher.execute(stub, f"q{i}") == f"solo:q{i}"
    assert len(stub.calls) == 3
    stats = batcher.stats()
    assert stats["groups_quarantined"] == 1 and stats["quarantined_now"] == 1
    # Quarantined: served per request, never through search_many.
    assert batcher.execute(stub, "q9") == "solo:q9"
    assert len(stub.calls) == 3
    assert batcher.stats()["quarantine_hits"] == 1
    # Another group key is not affected.
    assert batcher.execute(stub, "x", group_key=("other",)) == "solo:x"
    assert len(stub.calls) == 4
    batcher.close()


def test_full_queue_sheds_with_retry_after():
    batcher = MicroBatcher(max_wait_s=1.5, queue_limit=1)
    stub = StubSearcher(delay_s=1.0)
    results, errors = _concurrent(batcher, stub, ["a", "b", "c"], stagger_s=0.1)
    assert results.get("a") == "r:a" and results.get("b") == "r:b"
    assert isinstance(errors.get("c"), BatcherRejected)
    assert 1 <= errors["c"].retry_after_s <= 30
    assert batcher.stats()["rejected"] == 1
    batcher.close()


def test_stress_many_threads_lose_no_rider():
    """More threads than cores, a short switch interval: every rider gets
    its own answer and the counters add up (a lost update breaks both)."""
    import sys

    batcher = MicroBatcher(max_wait_s=0.001, max_batch=8)
    stub = StubSearcher()
    names = [f"t{t}r{r}" for t in range(32) for r in range(20)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results: dict = {}

        def go(t):
            for r in range(20):
                name = f"t{t}r{r}"
                results[name] = batcher.execute(stub, name, group_key=(t % 3,))

        threads = [threading.Thread(target=go, args=(t,)) for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert results == {n: f"r:{n}" for n in names}
    stats = batcher.stats()
    assert stats["requests"] == len(names)
    assert sum(len(c) for c in stub.calls) == len(names)
    assert stats["batches"] == len(stub.calls)
    assert stats["occupancy_mean"] * stats["batches"] == pytest.approx(len(names))
    batcher.close()


def test_plan_spec_buckets_joins_cheap_padding_only():
    small = ("terms", "body", 4, 4)
    mid = ("terms", "body", 8, 4)
    huge = ("terms", "body", 4096, 4)
    other = ("terms", "title", 4, 4)
    buckets = plan_spec_buckets([(small, 3), (mid, 2), (huge, 1), (other, 2)])
    assert (huge,) in buckets  # padding 3 rows to 4096 tiles costs more
    assert any(set(b) == {small, mid} for b in buckets)
    assert (other,) in buckets  # another field never unifies


# ---------------------------------------------------------------------------
# A node's concurrent searches
# ---------------------------------------------------------------------------

VOCAB = [f"v{i}" for i in range(30)]


@pytest.fixture(scope="module")
def node():
    n = Node(device="cpu")
    n.create_index("idx", {
        "settings": {"index": {"number_of_shards": 4}},
        "mappings": {"properties": {"body": {"type": "text"},
                                    "tag": {"type": "keyword"}}},
    })
    rng = np.random.default_rng(11)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    bulk = "".join(
        json.dumps({"index": {"_id": f"d{i}"}}) + "\n" + json.dumps({
            "body": " ".join(rng.choice(VOCAB, int(rng.integers(3, 15)), p=probs)),
            "tag": str(rng.choice(["a", "b"])),
        }) + "\n"
        for i in range(200)
    )
    assert not n.bulk(bulk, default_index="idx", refresh=True)["errors"]
    yield n
    n.close()


def _bodies():
    rng = np.random.default_rng(4)
    out = []
    for i in range(24):
        words = " ".join(rng.choice(VOCAB, 2 + i % 3))
        if i % 3 == 0:
            out.append({"query": {"match": {"body": words}}, "size": 5 + i % 4})
        elif i % 3 == 1:
            out.append({"query": {"bool": {
                "must": [{"match": {"body": words}}],
                "filter": [{"term": {"tag": "a"}}]}}})
        else:
            out.append({"query": {"bool": {"should": [
                {"match": {"body": words}}, {"term": {"body": "v1"}}]}}})
    return out


def test_concurrent_node_searches_coalesce_and_match_solo(node):
    bodies = _bodies()
    solo = [node.search("idx", b) for b in bodies]
    node.exec_batcher.close()
    node.exec_batcher = MicroBatcher(max_wait_s=0.05)
    barrier = threading.Barrier(8)
    got: dict = {}

    def client(c):
        barrier.wait()
        for i in range(c, len(bodies), 8):
            got[i] = node.search("idx", bodies[i])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, want in enumerate(solo):
        g = dict(got[i])
        g.pop("took")
        want = dict(want)
        want.pop("took")
        assert g == want, bodies[i]
    stats = node.exec_batcher.stats()
    assert stats["requests"] == len(bodies)
    assert stats["occupancy_max"] >= 2 and stats["coalesced_requests"] >= 2
    assert stats["batches"] < len(bodies)
    node.exec_batcher.close()


def test_node_sheds_with_429_and_retry_after(node):
    svc = node.get_index("idx")
    slow = MicroBatcher(max_wait_s=1.5, queue_limit=1)
    node.exec_batcher = slow
    real = svc.search.search_many

    def slow_many(requests):
        time.sleep(1.0)
        return real(requests)

    svc.search.search_many = slow_many
    rest = RestServer(node)
    body = json.dumps({"query": {"match": {"body": "v2"}}})
    out: dict = {}

    def go(i):
        time.sleep(0.1 * i)
        out[i] = rest.dispatch_with_headers("POST", "/idx/_search", {}, body)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        del svc.search.search_many
        slow.close()
    assert out[0][0] == 200 and out[1][0] == 200
    status, payload, headers = out[2]
    assert status == 429
    assert payload["error"]["type"] == "es_rejected_execution_exception"
    assert int(headers["Retry-After"]) >= 1


def _without_took(out: dict) -> dict:
    out = dict(out)
    out.pop("took")
    return out


def test_oversized_rider_fails_alone_in_a_coalesced_launch(node, monkeypatch):
    """A rider whose k the top-k kernel refuses fails on its own, with a
    400; the batchmates that shared its launch answer as they do alone."""
    from elasticsearch_tpu_torch.node import ApiError
    from elasticsearch_tpu_torch.ops import kernels

    svc = node.get_index("idx")
    sizes = [5, 3, 40, 7]
    bodies = [{"query": {"match": {"body": "v1 v2"}}, "size": s} for s in sizes]
    solo = {s: _without_took(node.search("idx", b))
            for s, b in zip(sizes, bodies) if s != 40}
    real_topk = kernels.masked_topk_batch

    def windowed(key, eligible, k):
        # The CUDA launch refuses a k past its chunk window; the plain
        # version on the CPU has none, so this stands in for the card.
        if k > 20:
            raise ValueError(f"k={k} exceeds the top-k kernel's window")
        return real_topk(key, eligible, k)

    monkeypatch.setattr(kernels, "masked_topk_batch", windowed)
    gate = threading.Event()
    batches: list = []
    real_many = svc.search.search_many

    def gated(requests):
        batches.append(sorted(r.size for r in requests))
        gate.wait(30)
        return real_many(requests)

    svc.search.search_many = gated
    node.exec_batcher.close()
    node.exec_batcher = MicroBatcher(max_wait_s=0.05)
    got: dict = {}

    def go(key, body):
        try:
            got[key] = node.search("idx", body)
        except ApiError as e:
            got[key] = e

    try:
        # A first search holds the scheduler in flight while the four
        # riders queue behind it, so they share the next launch.
        first = threading.Thread(target=go, args=("first", bodies[0]))
        first.start()
        deadline = time.monotonic() + 30
        while not batches and time.monotonic() < deadline:
            time.sleep(0.01)
        riders = [threading.Thread(target=go, args=(s, b))
                  for s, b in zip(sizes, bodies)]
        for t in riders:
            t.start()
        while (node.exec_batcher.stats()["queued"] < len(sizes)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        gate.set()
        for t in [first, *riders]:
            t.join(timeout=60)
    finally:
        gate.set()
        del svc.search.search_many
        node.exec_batcher.close()
    assert batches == [[5], sorted(sizes)]
    err = got[40]
    assert isinstance(err, ApiError) and err.status == 400
    assert "window" in err.reason
    for s, want in solo.items():
        assert _without_took(got[s]) == want, s
    assert _without_took(got["first"]) == solo[5]


def test_result_window_is_checked_before_batching():
    n = Node(device="cpu")
    try:
        n.create_index("w", {
            "settings": {"index": {"number_of_shards": 2,
                                   "max_result_window": 5}},
            "mappings": {"properties": {"body": {"type": "text"}}},
        })
        n.bulk("".join(
            json.dumps({"index": {"_id": f"d{i}"}}) + "\n"
            + json.dumps({"body": f"v1 v{i}"}) + "\n" for i in range(9)
        ), default_index="w", refresh=True)
        ok = n.search("w", {"query": {"match": {"body": "v1"}},
                            "from": 2, "size": 3})
        assert len(ok["hits"]["hits"]) == 3
        from elasticsearch_tpu_torch.node import ApiError

        with pytest.raises(ApiError) as e:
            n.search("w", {"query": {"match": {"body": "v1"}},
                           "from": 2, "size": 4})
        assert e.value.status == 400
        assert e.value.err_type == "illegal_argument_exception"
        assert "[5]" in e.value.reason and "[6]" in e.value.reason
        assert n.exec_batcher.stats()["requests"] == 1  # refused before it
    finally:
        n.close()
