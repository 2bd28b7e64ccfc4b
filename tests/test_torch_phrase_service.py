"""Positional queries through the port's node against the JAX node.

The same documents go to the port's `Node(device="cpu")` and to the JAX
`Node` (started, and its indices created, with ESTPU_MESH_SERVING=0,
ESTPU_EXEC_PLANNER=0, ESTPU_FILTER_CACHE=0 and ESTPU_EXEC_PACKED=0, as
the other node parity suites do), on 1 and 3 shards, over two refreshes
(two segments a shard) with deletes, the first segment holding docs whose
text analyzed to zero tokens. match_phrase, match_phrase_prefix, the
span family and intervals alone, inside bool must / filter / must_not,
with `sort`, `rescore`, `search_after` and a `terms` aggregation; the
reference's 400s; and concurrent answers against sequential ones.

Tolerance: exact everywhere — the whole response but `took` (hits, ids,
order, `_score` fp32 bits, `sort` values, totals, `_shards`, buckets).
"""

import json
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import ApiError as JaxApiError
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import ApiError, Node
from elasticsearch_tpu_torch.rest.server import RestServer

torch.set_num_threads(1)

JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}
MAPPINGS = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
}}
WORDS = ["quick", "brown", "fox", "jumps", "over", "lazy", "dog", "the",
         "quiet", "quality", "a"]


def _docs(seed, n, first):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 14)))),
             "tag": str(rng.choice(["x", "y", "z"])),
             "price": int(rng.integers(0, 60))}
        if first and i % 10 == 0:
            d["body"] = ""  # zero tokens
        if i % 8 == 3:
            d["body"] = [d["body"], "quick brown", "fox"]
        out.append(d)
    return out


def _bulk(docs, start):
    lines = []
    for i, d in enumerate(docs):
        lines += [json.dumps({"index": {"_id": f"d{start + i}"}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request):
    body = {"settings": {"index": {"number_of_shards": request.param}},
            "mappings": MAPPINGS}
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        ref.create_index("a", body)
    port = Node(device="cpu")
    port.create_index("a", body)
    for n in (port, ref):
        n.bulk(_bulk(_docs(7, 160, True), 0), default_index="a", refresh=True)
        n.bulk(_bulk(_docs(8, 120, False), 160), default_index="a", refresh=True)
        for i in range(0, 280, 19):
            n.delete_doc("a", f"d{i}")
        n.refresh("a")
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def _st(w):
    return {"span_term": {"body": w}}


PHRASE = {"match_phrase": {"body": "quick brown"}}
NEAR = {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 2,
                      "in_order": False}}

BODIES = {
    "phrase": {"query": PHRASE},
    "phrase_three": {"query": {"match_phrase": {"body": "the lazy dog"}},
                     "size": 25},
    "phrase_repeated": {"query": {"match_phrase": {"body": "fox fox"}}},
    "phrase_absent": {"query": {"match_phrase": {"body": "quick absent"}}},
    "phrase_boost": {"query": {"match_phrase": {"body": {
        "query": "brown fox", "boost": 1.7}}}},
    "phrase_prefix": {"query": {"match_phrase_prefix": {"body": "lazy qu"}}},
    "phrase_prefix_bare": {"query": {"match_phrase_prefix": {"body": "qu"}}},
    "span_term": {"query": {"span_term": {"body": "dog"}}},
    "span_or": {"query": {"span_or": {"clauses": [_st("lazy"), _st("lazy"),
                                                  _st("quiet")]}}},
    "span_near": {"query": NEAR},
    "span_near_three": {"query": {"span_near": {"clauses": [
        _st("the"), _st("brown"), _st("dog")], "slop": 4}}},
    "span_first": {"query": {"span_first": {"match": _st("fox"), "end": 2}}},
    "span_not": {"query": {"span_not": {"include": _st("fox"),
                                        "exclude": _st("brown"), "dist": 1}}},
    "intervals": {"query": {"intervals": {"body": {"match": {
        "query": "quick dog", "max_gaps": 2, "ordered": True}}}}},
    "intervals_all_of": {"query": {"intervals": {"body": {"all_of": {
        "intervals": [{"match": {"query": "lazy"}},
                      {"prefix": {"prefix": "qu"}}], "max_gaps": 1}}}}},
    "bool_must_filter": {"query": {"bool": {"must": [PHRASE],
                                            "filter": [{"term": {"tag": "x"}}]}}},
    "bool_filter_span": {"query": {"bool": {"must": [{"match": {"body": "dog"}}],
                                            "filter": [NEAR]}}},
    "bool_must_not": {"query": {"bool": {"must": [{"match": {"body": "fox"}}],
                                         "must_not": [PHRASE]}}, "size": 30},
    "sort": {"query": NEAR, "sort": [{"price": "desc"}], "size": 15},
    "sort_score_asc": {"query": PHRASE, "sort": [{"_score": "asc"}]},
    "rescore": {"query": {"match": {"body": "quick fox"}}, "size": 12,
                "rescore": {"window_size": 40, "query": {
                    "rescore_query": NEAR, "query_weight": 0.5,
                    "rescore_query_weight": 2.0}}},
    "search_after": {"query": PHRASE, "sort": [{"price": "asc"}], "size": 5,
                     "search_after": [20]},
    "aggs": {"query": {"span_or": {"clauses": [_st("fox"), _st("dog")]}},
             "size": 3, "aggs": {"t": {"terms": {"field": "tag"}}}},
    "from_size": {"query": {"span_first": {"match": _st("the"), "end": 3}},
                  "from": 4, "size": 6},
    "untracked": {"query": PHRASE, "track_total_hits": False},
}


def _view(out):
    return {k: v for k, v in out.items() if k != "took"}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_positional_bodies_match_the_jax_node(nodes, name):
    port, ref = nodes
    body = BODIES[name]
    got, want = port.search("a", json.loads(json.dumps(body))), ref.search("a", body)
    assert _view(got) == _view(want)


def test_answers_are_not_empty(nodes):
    port, _ref = nodes
    for name in ("phrase", "span_near", "span_not", "intervals", "phrase_prefix"):
        assert port.search("a", BODIES[name])["hits"]["total"]["value"] > 0, name


ERRORS = [
    {"query": {"match_phrase": {"body": {"query": "quick brown", "slop": 1}}}},
    {"query": {"span_near": {"clauses": [{"span_term": {"tag": "x"}},
                                         {"span_term": {"tag": "y"}}]}}},
    {"query": {"span_near": {"clauses": [{"match": {"body": "x"}}]}}},
    {"query": {"span_near": {"clauses": [_st("a"), _st("b"), _st("c")],
                             "in_order": False}}},
    {"query": {"span_near": {"clauses": [_st("a"), {"span_term": {"tag": "x"}}]}}},
    {"query": {"span_first": {"match": _st("a"), "end": -2}}},
    {"query": {"span_not": {"include": _st("a")}}},
    {"query": {"span_or": {"clauses": []}}},
    {"query": {"intervals": {"body": {"match": {"query": "a b c"},
                                      "any_of": {}}}}},
    {"query": {"intervals": {"body": {"fuzzy": {"term": "a"}}}}},
    {"query": {"intervals": {"body": {"all_of": {"intervals": [
        {"match": {"query": "quick brown"}}]}}}}},
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_errors_match_the_jax_node(nodes, i):
    port, ref = nodes
    with pytest.raises(ApiError) as p:
        port.search("a", ERRORS[i])
    with pytest.raises(JaxApiError) as r:
        ref.search("a", ERRORS[i])
    assert p.value.status == r.value.status == 400
    assert p.value.reason == r.value.reason


def test_positional_bodies_over_rest(nodes):
    port, ref = nodes
    status, out = RestServer(port).dispatch(
        "POST", "/a/_search", {}, json.dumps(BODIES["span_near"]))
    assert status == 200
    assert _view(out) == _view(ref.search("a", BODIES["span_near"]))
    status, out = RestServer(port).dispatch(
        "POST", "/a/_search", {}, json.dumps(ERRORS[0]))
    assert status == 400


def test_concurrent_answers_equal_sequential(nodes):
    """Each body four times from 8 threads: the micro-batcher coalesces
    same-spec plans into one launch of Q rows; every answer equals its
    sequential one."""
    port, _ref = nodes
    names = sorted(BODIES)
    want = {n: _view(port.search("a", BODIES[n])) for n in names}
    order = np.random.default_rng(5).permutation(np.tile(np.arange(len(names)), 4))
    got: list = [None] * len(order)
    errors: list = []

    def client(c):
        for j in range(c, len(order), 8):
            try:
                got[j] = _view(port.search("a", BODIES[names[order[j]]]))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for j, i in enumerate(order):
        assert got[j] == want[names[i]], names[i]
