"""Port packed multi-tenant serving through the node against the JAX node.

Twelve small one-shard indices (30-200 docs, two refreshes and deletes in
some, so a tenant may be two plane members) get the same documents on the
port's `Node(device="cpu")` and on the JAX `Node` (built with
ESTPU_MESH_SERVING=0, ESTPU_EXEC_PLANNER=0, ESTPU_FILTER_CACHE=0 and
ESTPU_EXEC_PACKED=0, as the other node parity suites build it: its answers
are its solo answers). Sixteen threads send mixed bodies to the port's
node, whose micro-batcher coalesces searches on DIFFERENT indices into
packed launches; every response equals the JAX node's (ids, order, score
bits, totals), and equals a `Node(exec_packed=False)`'s. Tolerance: exact.

Also ported from the reference's tests/test_packed_multitenant.py:
test_plane_tracks_refresh, test_ineligible_shapes_fall_back and
test_active_riders_outrank_idle_tenants_for_plane_budget (the budget set
on `max_plane_docs` itself: the port leaves `retune` out).
"""

import json
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.exec.batcher import MicroBatcher
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25_device
from elasticsearch_tpu_torch.search.service import SearchRequest

torch.set_num_threads(1)

JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}
VOCAB = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "shared", "common", "leak"]
MAPPINGS = {"properties": {"body": {"type": "text"},
                           "tag": {"type": "keyword"},
                           "rank": {"type": "long"}}}
N_INDICES = 12


def _bulk(rng, start, n, heavy):
    lines = []
    for i in range(start, start + n):
        toks = list(rng.choice(VOCAB[:8], rng.integers(2, 7)))
        if heavy:
            toks += ["leak"] * int(rng.integers(2, 5))
        elif rng.random() < 0.05:
            toks.append("leak")
        doc = {"body": " ".join(toks), "tag": str(rng.choice(["x", "y", "z"])),
               "rank": int(rng.integers(0, 100))}
        lines += [json.dumps({"index": {"_id": f"d{i}"}}), json.dumps(doc)]
    return "\n".join(lines) + "\n"


def _fill(node, n_indices=N_INDICES, seed=11):
    rng = np.random.default_rng(seed)
    for t in range(n_indices):
        name = f"tenant{t}"
        node.create_index(name, {"mappings": MAPPINGS})
        n = int(rng.integers(30, 200))
        node.bulk(_bulk(rng, 0, n, heavy=t == 4), default_index=name,
                  refresh=True)
        if t % 3 == 0:  # a second segment, and deletes in the first
            node.bulk(_bulk(rng, n, 40, heavy=False), default_index=name,
                      refresh=True)
            for i in range(0, n, 9):
                node.delete_doc(name, f"d{i}")
            node.refresh(name)


def _bodies(seed=29):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(96):
        t = int(rng.integers(0, N_INDICES))
        roll = j % 8
        words = lambda n: " ".join(rng.choice(VOCAB, n))  # noqa: E731
        if roll in (0, 1, 2):
            q = {"match": {"body": words(int(rng.integers(1, 4)))}}
        elif roll == 3:
            q = {"bool": {"must": [{"match": {"body": words(2)}}],
                          "filter": [{"term": {"body": str(rng.choice(VOCAB))}}]}}
        elif roll == 4:
            q = {"bool": {"should": [{"term": {"body": str(rng.choice(VOCAB))}},
                                     {"term": {"body": str(rng.choice(VOCAB))}}],
                          "minimum_should_match": 1}}
        elif roll == 5:
            q = {"bool": {"must": [{"match": {"body": words(2)}}],
                          "must_not": [{"term": {"tag": "x"}}]}}
        elif roll == 6:
            q = {"constant_score": {"filter": {"terms": {"body": ["leak", "golf"]}},
                                    "boost": 1.5}}
        else:  # ineligible: a numeric range keeps the index's own group
            q = {"bool": {"must": [{"match": {"body": words(1)}}],
                          "filter": [{"range": {"rank": {"gte": 30}}}]}}
        size = int(rng.choice([3, 10, 25]))
        out.append((f"tenant{t}", {"query": q, "size": size,
                                   "from": int(rng.integers(0, 3))}))
    return out


def _page(resp):
    hits = resp["hits"]["hits"]
    return (
        [h["_id"] for h in hits],
        np.asarray([h["_score"] for h in hits], np.float32).view(np.int32).tolist(),
        resp["hits"]["total"],
    )


@pytest.fixture(scope="module")
def nodes():
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        _fill(ref)
    port = Node(device="cpu")
    port.exec_batcher.close()
    port.exec_batcher = MicroBatcher(max_wait_s=0.05)
    _fill(port)
    flat = Node(device="cpu", exec_packed=False)
    _fill(flat)
    yield port, ref, flat
    for n in (port, flat):
        n.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def test_concurrent_packed_answers_equal_the_jax_node(nodes):
    port, ref, flat = nodes
    bodies = _bodies()
    want = [_page(ref.search(index, dict(body))) for index, body in bodies]
    got: list = [None] * len(bodies)
    errors: list = []
    barrier = threading.Barrier(16)

    def client(c):
        barrier.wait()
        for i in range(c, len(bodies), 16):
            try:
                index, body = bodies[i]
                got[i] = port.search(index, dict(body))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors[:3]
    for (index, body), g, w in zip(bodies, got, want):
        assert _page(g) == w, (index, body)
    stats = port.packed_exec.stats()
    assert stats["launches"] >= 1, stats
    assert stats["lanes"] > stats["launches"], stats
    assert stats["lanes_per_launch_max"] >= 2, stats
    assert stats["tenants_per_launch_max"] >= 2, stats
    assert stats["fallback_solo"] == 0, stats
    # Without the packed executor: the same answers, every index in its
    # own batcher group.
    assert flat.packed_exec is None
    for (index, body), g in zip(bodies, got):
        f = flat.search(index, dict(body))
        assert {k: v for k, v in f.items() if k != "took"} == {
            k: v for k, v in g.items() if k != "took"}


def test_packed_launch_failure_fails_its_riders(nodes, monkeypatch):
    """A failed packed launch gives its bucket's riders the launch's own
    error: the executor never reruns them solo."""
    port, _ref, _flat = nodes
    ex = port.packed_exec

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA kernel sparse_fold failed to launch: error 9")

    monkeypatch.setattr(bm25_device, "execute_batch_packed", broken)
    body = {"query": {"match": {"body": "alpha"}}}
    wrapped = [ex.wrap(port.get_index(f"tenant{t}"),
                       SearchRequest.from_json(dict(body))) for t in range(3)]
    before = ex.stats()
    out = ex.search_many(wrapped)
    assert all(isinstance(r, RuntimeError) for r in out), out
    assert ex.stats()["fallback_solo"] == before["fallback_solo"]
    assert ex.stats()["launches"] == before["launches"]


def _small_node(n_idx=5, docs=40):
    node = Node(device="cpu")
    rng = np.random.default_rng(11)
    for t in range(n_idx):
        name = f"tenant{t}"
        node.create_index(name, {"mappings": {"properties": {"body": {"type": "text"}}}})
        for i in range(docs + 13 * t):
            node.index_doc(name, {"body": " ".join(rng.choice(VOCAB, rng.integers(2, 6)))},
                           f"d{i}")
        node.refresh(name)
    return node


def test_plane_tracks_refresh():
    """New docs become searchable through the packed path after a
    refresh: the plane rebuilds when a member's generation moves."""
    node = _small_node(n_idx=2)
    try:
        svc0, svc1 = node.get_index("tenant0"), node.get_index("tenant1")
        req = SearchRequest.from_json({"query": {"match": {"body": "zzzunique"}}})
        wrapped = [node.packed_exec.wrap(svc0, req), node.packed_exec.wrap(svc1, req)]
        out = node.packed_exec.search_many(wrapped)
        assert out[0].total == 0 and out[1].total == 0
        rebuilds0 = node.packed_exec.stats()["plane_rebuilds"]
        node.index_doc("tenant0", {"body": "zzzunique token"}, "fresh")
        node.refresh("tenant0")
        out = node.packed_exec.search_many(wrapped)
        assert out[0].total == 1
        assert out[0].hits[0].doc_id == "fresh"
        assert out[1].total == 0
        assert node.packed_exec.stats()["plane_rebuilds"] > rebuilds0
    finally:
        node.close()


def test_ineligible_shapes_fall_back():
    """Numeric-field and unsupported query shapes never enter the packed
    group; oversized tenants and multi-shard indices are refused too."""
    node = Node(device="cpu")
    try:
        node.create_index("t", {"mappings": {"properties": {
            "body": {"type": "text"}, "rank": {"type": "long"}}}})
        node.index_doc("t", {"body": "alpha", "rank": 3}, "d0")
        node.refresh("t")
        svc = node.get_index("t")
        ok = SearchRequest.from_json({"query": {"match": {"body": "alpha"}}})
        assert node.packed_exec.eligible(svc, ok)
        for body in ({"query": {"range": {"rank": {"gte": 1}}}},
                     {"query": {"term": {"rank": 3}}},
                     {"query": {"match_phrase": {"body": "alpha"}}},
                     {"query": {"match_all": {}}}):
            assert not node.packed_exec.eligible(svc, SearchRequest.from_json(body))
        node.create_index("s", {"settings": {"index": {"number_of_shards": 2}},
                                "mappings": {"properties": {"body": {"type": "text"}}}})
        assert not node.packed_exec.eligible(node.get_index("s"), ok)
        node.packed_exec.MAX_TENANT_DOCS = 0
        assert not node.packed_exec.eligible(svc, ok)
    finally:
        node.close()
    assert Node(device="cpu", exec_batcher=False).packed_exec is None


def test_active_riders_outrank_idle_tenants_for_plane_budget():
    """Plane admission under a doc budget prefers THIS batch's tenants:
    idle registered tenants sit the plane out rather than crowding an
    active rider into the solo path."""
    node = _small_node(n_idx=4)
    try:
        ex = node.packed_exec
        body = {"query": {"match": {"body": "alpha"}}}
        all_wrapped = [ex.wrap(node.get_index(f"tenant{t}"),
                               SearchRequest.from_json(dict(body)))
                       for t in range(4)]
        out = ex.search_many(all_wrapped)  # registers all 4 tenants
        assert all(not isinstance(r, Exception) for r in out)
        assert len(ex._member_rows) == 4
        # Shrink the budget so only the two ACTIVE riders fit.
        active = [all_wrapped[2], all_wrapped[3]]
        ex.max_plane_docs = sum(w.svc.num_docs for w in active)
        out = ex.search_many(active)
        assert all(not isinstance(r, Exception) for r in out)
        assert set(ex._member_rows) == {w.svc.uuid for w in active}
        for got, w in zip(out, active):
            exp = w.svc.search.search(SearchRequest.from_json(dict(body)))
            assert got.total == exp.total
            assert [h.doc_id for h in got.hits] == [h.doc_id for h in exp.hits]
            assert [h.score for h in got.hits] == [h.score for h in exp.hits]
        assert ex.stats()["fallback_solo"] == 0
    finally:
        node.close()
