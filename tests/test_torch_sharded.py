"""Port multi-shard serving against the JAX package: murmur3 routing, an
8-shard index fed the same `_bulk` body on both sides, and `_search`
through each node (the micro-batcher and the coordinator's coalesced
`search_many`, and its one-request `search`).

The JAX node runs its host-loop coordinator on the CPU, as its own
sharded tests do with the SPMD mesh view switched off, and without its
planner, filter cache and packed executor (paths the port does not have).
Tolerance is none: the same ids in the same order, fp32 `_score` bits,
`hits.total`, `max_score` and `_shards`.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.parallel import routing as jrouting
from elasticsearch_tpu.search.service import SearchRequest as JaxRequest
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.parallel import routing
from elasticsearch_tpu_torch.search.service import SearchRequest

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

VOCAB = [f"v{i}" for i in range(40)]
INDEX = "eight"
SETTINGS = {
    "settings": {"index": {"number_of_shards": 8}},
    "mappings": {
        "properties": {
            "body": {"type": "text"},
            "tag": {"type": "keyword"},
            "rank": {"type": "long"},
        }
    },
}
JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}


def _docs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    return [
        {
            "body": " ".join(rng.choice(VOCAB, int(rng.integers(3, 20)), p=probs)),
            "tag": str(rng.choice(["alpha", "beta", "gamma"])),
            "rank": int(rng.integers(0, 1000)),
        }
        for _ in range(n)
    ]


def _bulk_body(docs: list[dict], prefix: str) -> str:
    """Half the documents carry an explicit _id, half take an auto id."""
    lines = []
    for i, d in enumerate(docs):
        meta = {"_index": INDEX}
        if i % 2 == 0:
            meta["_id"] = f"{prefix}{i}"
        lines.append(json.dumps({"index": meta}))
        lines.append(json.dumps(d))
    return "\n".join(lines) + "\n"


BODIES = [
    {"query": {"match": {"body": "v0 v3 v7 v11"}}},
    {"query": {"match": {"body": "v2 v9"}}, "size": 15},
    {"query": {"match": {"body": "v1 v5 v6 v30"}}, "from": 4, "size": 6},
    {"query": {"bool": {"must": [{"match": {"body": "v4 v8"}}],
                        "filter": [{"term": {"body": "v0"}}]}}},
    {"query": {"bool": {"must": [{"match": {"body": "v3 v12"}}],
                        "filter": [{"term": {"tag": "beta"}}]}}, "size": 7},
    {"query": {"bool": {"should": [{"match": {"body": "v5 v13"}},
                                   {"term": {"body": "v20"}}]}}},
    {"query": {"bool": {"must": [{"match": {"body": "v1"}}],
                        "must_not": [{"term": {"tag": "gamma"}}]}}},
    {"query": {"range": {"rank": {"gte": 2000}}}},
    {"query": {"term": {"tag": "alpha"}}, "size": 5},
    {"query": {"match": {"body": "v0"}}, "track_total_hits": 30},
]


def _view(out: dict) -> dict:
    hits = out["hits"]
    return {
        "_shards": out["_shards"],
        "total": hits.get("total"),
        "max_score": hits["max_score"],
        "hits": [
            (h["_id"], np.float32(h["_score"]).view(np.int32).item(),
             h.get("_source"))
            for h in hits["hits"]
        ],
    }


@pytest.fixture(scope="module")
def nodes():
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        ref.create_index(INDEX, SETTINGS)
    port = Node(device="cpu")
    port.create_index(INDEX, SETTINGS)
    body = _bulk_body(_docs(5, 260), "b")
    outs = [n.bulk(body) for n in (port, ref)]
    for n in (port, ref):
        n.index_doc(INDEX, {"body": "v1 v2 v3", "tag": "beta", "rank": 7})
        n.index_doc(INDEX, {"body": "v4", "tag": "alpha", "rank": 9}, "x1")
    refreshed = [n.refresh(INDEX) for n in (port, ref)]
    yield port, ref, outs, refreshed
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def test_shard_for_id_matches_reference():
    rng = np.random.default_rng(3)
    alphabet = list("abcXYZ019_-.") + ["é", "ß", "中", "文", "🙂", "𝄞", "\u0000"]
    ids = [f"_auto_{i}" for i in range(2500)]
    ids += [str(i) for i in range(2500)]
    ids += [
        "".join(rng.choice(alphabet, int(rng.integers(1, 24))))
        for _ in range(5000)
    ]
    assert len(ids) == 10_000
    for doc_id in ids:
        assert routing.murmur3_hash(doc_id) == jrouting.murmur3_hash(doc_id)
        for n in (1, 2, 3, 5, 8, 1024):
            assert routing.shard_for_id(doc_id, n) == jrouting.shard_for_id(
                doc_id, n
            ), (doc_id, n)


def test_bulk_and_refresh_responses_match_reference(nodes):
    _port, _ref, (pout, rout), (pref, rref) = nodes
    assert pout["errors"] is rout["errors"] is False
    assert [
        {op: {k: v[k] for k in ("_id", "result", "status", "_shards")}}
        for item in pout["items"] for op, v in item.items()
    ] == [
        {op: {k: v[k] for k in ("_id", "result", "status", "_shards")}}
        for item in rout["items"] for op, v in item.items()
    ]
    assert pref == rref == {"_shards": {"total": 8, "successful": 8, "failed": 0}}


def test_every_document_lands_on_the_reference_shard(nodes):
    port, ref, _outs, _refreshed = nodes
    psvc, rsvc = port.get_index(INDEX), ref.get_index(INDEX)
    assert psvc.n_shards == rsvc.n_shards == 8
    for pe, re_ in zip(psvc.engines, rsvc.engines):
        assert set(pe._live_ids) == {
            d for h in re_.segments for d, live in zip(h.segment.ids, h.live_host)
            if live
        }
    assert sum(1 for e in psvc.engines if e.num_docs) > 4  # murmur3 spreads


def test_search_through_the_batcher_matches_reference(nodes):
    port, ref, _outs, _refreshed = nodes
    for body in BODIES:
        assert _view(port.search(INDEX, body)) == _view(
            ref.search(INDEX, body)
        ), body
    # Both nodes served every request through their micro-batchers.
    assert port.exec_batcher.stats()["requests"] >= len(BODIES)
    assert ref.exec_batcher.stats()["requests"] >= len(BODIES)


@pytest.mark.parametrize("entry", ["search_many", "search"])
def test_coordinator_matches_reference(nodes, entry):
    port, ref, _outs, _refreshed = nodes
    pco, rco = port.get_index(INDEX).search, ref.get_index(INDEX).search
    preqs = [SearchRequest.from_json(b) for b in BODIES]
    rreqs = [JaxRequest.from_json(b) for b in BODIES]
    if entry == "search_many":
        pres, rres = pco.search_many(preqs), rco.search_many(rreqs)
    else:
        pres = [pco.search(r) for r in preqs]
        rres = [rco.search(r) for r in rreqs]
    for body, p, r in zip(BODIES, pres, rres):
        assert not isinstance(p, Exception) and not isinstance(r, Exception)
        assert _view(p.to_json(INDEX)) == _view(r.to_json(INDEX)), body


def test_skipped_shards_are_counted(nodes):
    port, _ref, _outs, _refreshed = nodes
    out = port.search(INDEX, {"query": {"range": {"rank": {"gte": 5000}}}})
    assert out["_shards"] == {
        "total": 8, "successful": 0, "skipped": 8, "failed": 0
    }
    assert out["hits"]["total"] == {"value": 0, "relation": "eq"}


def test_search_matches_reference_after_deletes(nodes):
    port, ref, _outs, _refreshed = nodes
    for n in (port, ref):
        for i in range(0, 260, 6):
            n.delete_doc(INDEX, f"b{i}")
        n.delete_doc(INDEX, "_auto_3")
        n.refresh(INDEX)
    for body in BODIES:
        assert _view(port.search(INDEX, body)) == _view(
            ref.search(INDEX, body)
        ), body
