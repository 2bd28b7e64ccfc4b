"""Structured queries through the port's node against the JAX node.

The same documents (text, keyword, numeric, geo_point, rank_feature,
rank_features, object and nested fields) go to the port's
`Node(device="cpu")` and to the JAX `Node` (its indices created with
ESTPU_MESH_SERVING=0, ESTPU_EXEC_PLANNER=0, ESTPU_FILTER_CACHE=0 and
ESTPU_EXEC_PACKED=0, as the other node parity suites do), over two
refreshes (two segments a shard) with deletes, on 1 shard (every body)
and on 3 shards (one body of each kind, `ids` across shards included):
multi_match of types best_fields, most_fields, phrase and phrase_prefix,
dis_max, ids, boosting, rank_feature (each function, a rank_features
leaf, inside bool should), geo_distance, geo_bounding_box (across the
antimeridian too), terms_set by field and by script, function_score
(every function kind, score_mode and boost_mode, min_score, a script
function) and nested (all five score modes, inside a bool with a parent
filter); the reference's 400s at search and at index time, and the
port's own 400 for multi_match `bool_prefix`; a body over REST; and
concurrent answers against sequential ones.

Tolerance: the whole response but `took`, exactly (hits, ids, order,
`_score` fp32 bits, totals, `_shards`), except the bodies marked with 4
ulps, whose scores go through a logarithm or pow (XLA's CPU
transcendentals are not glibc's): there ids, order and totals are exact
and each `_score` is within 4 ulps of the reference's.
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
    "title": {"type": "text"},
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
    "pop": {"type": "float"},
    "req": {"type": "integer"},
    "loc": {"type": "geo_point"},
    "pagerank": {"type": "rank_feature"},
    "feats": {"type": "rank_features"},
    "user": {"properties": {"name": {"type": "keyword"}, "age": {"type": "long"}}},
    "answers": {"type": "nested", "properties": {
        "body": {"type": "text"}, "votes": {"type": "long"}}},
}}
WORDS = ["quick", "brown", "fox", "jumps", "over", "lazy", "dog", "the",
         "quiet", "quality", "a", "red", "blue"]


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"title": " ".join(rng.choice(WORDS, int(rng.integers(1, 5)))),
             "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12)))),
             "tag": str(rng.choice(["x", "y", "z"])),
             "price": int(rng.integers(0, 60)),
             "pop": float(np.float32(rng.lognormal(1.0, 1.0))),
             "req": int(rng.integers(1, 4)),
             "pagerank": float(np.float32(rng.lognormal(0.0, 1.0))),
             "feats": {"x": float(np.float32(rng.random() * 5 + 0.01)),
                       "y": int(rng.integers(1, 9))},
             "user": {"name": str(rng.choice(["ann", "bob"])), "age": int(rng.integers(1, 90))}}
        if i % 5 != 4:
            d["loc"] = {"lat": float(np.float32(rng.uniform(-60, 70))),
                        "lon": float(np.float32(rng.uniform(-180, 180)))}
        if i % 7 == 3:
            d["loc"] = [float(np.float32(rng.uniform(170, 180))), float(np.float32(rng.uniform(-10, 10)))]
        if i % 6 == 2:
            del d["pop"]
        if i % 9 == 1:
            del d["pagerank"]
        k = int(rng.integers(0, 5))
        if k:
            d["answers"] = [{"body": " ".join(rng.choice(WORDS, int(rng.integers(1, 8)))),
                             "votes": int(rng.integers(-3, 40))} for _ in range(k)]
        out.append(d)
    return out


def _bulk(ds, start):
    lines = []
    for i, d in enumerate(ds):
        lines += [json.dumps({"index": {"_id": f"d{start + i}"}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


def _mm(t, **kw):
    return {"multi_match": {"query": t, "fields": ["title^2", "body"], **kw}}

def _fs(fns, **kw):
    return {"function_score": {"query": {"match": {"body": "quick fox"}}, "functions": fns, **kw}}

BODIES = {
    "mm_best": {"query": _mm("quick fox", tie_breaker=0.3)},
    "mm_most": {"query": _mm("quick dog", type="most_fields")},
    "mm_phrase": {"query": _mm("quick brown", type="phrase")},
    "mm_phrase_prefix": {"query": _mm("lazy qu", type="phrase_prefix")},
    "dis_max": {"query": {"dis_max": {"queries": [{"match": {"title": "fox blue"}}, {"term": {"tag": "x"}}], "tie_breaker": 0.7}}},
    "ids": {"query": {"ids": {"values": ["d3", "d17", "d44", "d101", "d250", "nope", "d3"]}}},
    "ids_bool": {"query": {"bool": {"must": [{"match": {"body": "fox"}}], "filter": [{"ids": {"values": [f"d{i}" for i in range(0, 300, 3)]}}]}}},
    "boosting": {"query": {"boosting": {"positive": {"match": {"body": "fox dog"}}, "negative": {"term": {"tag": "y"}}, "negative_boost": 0.2}}},
    "rf_saturation": {"query": {"rank_feature": {"field": "pagerank", "saturation": {"pivot": 2.0}}}},
    "rf_log": {"query": {"rank_feature": {"field": "pagerank", "log": {"scaling_factor": 1.5}}}},
    "rf_sigmoid": {"query": {"rank_feature": {"field": "pagerank", "sigmoid": {"pivot": 1.5, "exponent": 0.7}}}},
    "rf_features": {"query": {"rank_feature": {"field": "feats.x", "saturation": {"pivot": 1.0}, "boost": 2}}},
    "rf_should": {"query": {"bool": {"must": [{"match": {"body": "fox"}}], "should": [{"rank_feature": {"field": "pagerank", "log": {"scaling_factor": 2.0}}}]}}},
    "geo_dist": {"query": {"bool": {"must": [{"match": {"body": "dog"}}], "filter": [{"geo_distance": {"distance": "3000km", "loc": {"lat": 10, "lon": 20}}}]}}},
    "geo_box": {"query": {"geo_bounding_box": {"loc": {"top_left": {"lat": 50, "lon": -20}, "bottom_right": {"lat": -10, "lon": 60}}}}, "size": 20},
    "geo_box_wrap": {"query": {"geo_bounding_box": {"loc": {"top": 20, "left": 170, "bottom": -20, "right": -170}}}, "size": 20},
    "terms_set_field": {"query": {"terms_set": {"body": {"terms": ["quick", "fox", "dog", "red"], "minimum_should_match_field": "req"}}}},
    "terms_set_script": {"query": {"terms_set": {"body": {"terms": ["quick", "fox", "dog", "lazy"], "minimum_should_match_script": {"source": "Math.min(params.num_terms, doc['req'].value)"}}}}},
    "fs_weight": {"query": _fs([{"weight": 2.5}, {"filter": {"term": {"tag": "x"}}, "weight": 4}], score_mode="sum")},
    "fs_fvf": {"query": _fs([{"field_value_factor": {"field": "pop", "factor": 1.2, "modifier": "log1p", "missing": 1}}])},
    "fs_random": {"query": _fs([{"random_score": {"seed": 42}}], boost_mode="replace")},
    "fs_decay": {"query": _fs([{"gauss": {"price": {"origin": 30, "scale": 10, "offset": 2, "decay": 0.4}}}, {"exp": {"pop": {"origin": 1, "scale": 3}}}, {"linear": {"price": {"origin": 10, "scale": 20}}, "weight": 2}], score_mode="max", boost_mode="avg")},
    "fs_multiply_minscore": {"query": _fs([{"field_value_factor": {"field": "price", "modifier": "ln1p"}}], min_score=2.0)},
    "fs_script": {"query": _fs([{"script_score": {"script": {"source": "_score * params.a + doc['price'].value", "params": {"a": 0.5}}}}], boost_mode="replace")},
    "fs_match_all": {"query": {"function_score": {"field_value_factor": {"field": "pop"}, "boost": 2}}},
    "nested_avg": {"query": {"nested": {"path": "answers", "query": {"match": {"answers.body": "fox dog"}}}}},
    "nested_sum": {"query": {"nested": {"path": "answers", "query": {"match": {"answers.body": "quick"}}, "score_mode": "sum"}}},
    "nested_max": {"query": {"nested": {"path": "answers", "query": {"match": {"answers.body": "lazy red"}}, "score_mode": "max", "boost": 2}}},
    "nested_none": {"query": {"nested": {"path": "answers", "query": {"range": {"answers.votes": {"gte": 20}}}, "score_mode": "none"}}},
    "nested_bool": {"query": {"bool": {"must": [{"nested": {"path": "answers", "query": {"bool": {"must": [{"match": {"answers.body": "fox"}}], "filter": [{"range": {"answers.votes": {"gte": 5}}}]}}, "score_mode": "max"}}], "filter": [{"term": {"tag": "x"}}]}}},
    "object_leaf": {"query": {"bool": {"must": [{"term": {"user.name": "ann"}}], "filter": [{"range": {"user.age": {"lt": 40}}}]}}},
}

# Bodies whose scores go through a logarithm or pow: 4 ulps.
ULPS4 = {"fs_fvf", "fs_decay", "fs_multiply_minscore", "rf_log",
         "rf_sigmoid", "rf_should"}
# One body of each kind, run on 3 shards as well.
SHARDED = ["mm_best", "ids", "geo_dist", "terms_set_script", "fs_script",
           "nested_bool"]
CASES = [(1, name) for name in sorted(BODIES)] + [(3, name) for name in SHARDED]


def _make_nodes(shards):
    body = {"settings": {"index": {"number_of_shards": shards}},
            "mappings": MAPPINGS}
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        ref.create_index("a", body)
    port = Node(device="cpu")
    port.create_index("a", body)
    for n in (port, ref):
        for seed, start, count in ((7, 0, 120), (8, 120, 100)):
            out = n.bulk(_bulk(_docs(seed, count), start), default_index="a",
                         refresh=True)
            assert not out["errors"]
        for i in range(0, 220, 23):
            n.delete_doc("a", f"d{i}")
        n.refresh("a")
    return port, ref


@pytest.fixture(scope="module")
def all_nodes():
    made = {}
    yield lambda shards: made.setdefault(shards, _make_nodes(shards))
    for port, ref in made.values():
        port.close()
        if ref.exec_batcher is not None:
            ref.exec_batcher.close()


def _view(out):
    return {k: v for k, v in out.items() if k != "took"}


def _ulp_close(a, b, ulps):
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return bool(np.all((np.abs(a.astype(np.float64) - b) <= tol) | (a == b)))


@pytest.mark.parametrize("shards,name", CASES,
                         ids=[f"{s}-{n}" for s, n in CASES])
def test_structured_bodies_match_the_jax_node(all_nodes, shards, name):
    port, ref = all_nodes(shards)
    body = BODIES[name]
    got = port.search("a", json.loads(json.dumps(body)))
    want = ref.search("a", body)
    assert got["hits"]["total"]["value"] > 0, name
    if name not in ULPS4:
        assert _view(got) == _view(want)
        return
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
    assert _ulp_close([h["_score"] for h in gh], [h["_score"] for h in wh], 4)


ERRORS = [
    {"query": {"multi_match": {"query": "fox", "fields": ["title", "body"],
                               "type": "cross_fields"}}},
    {"query": {"multi_match": {"query": "fox"}}},
    {"query": {"nested": {"path": "nope", "query": {"match_all": {}}}}},
    {"query": {"nested": {"path": "answers", "query": {"match_all": {}},
                          "score_mode": "median"}}},
    {"query": {"nested": {"path": "answers"}}},
    {"query": {"rank_feature": {"field": "pagerank"}}},
    {"query": {"rank_feature": {"field": "pagerank", "log": {}}}},
    {"query": {"rank_feature": {"field": "pagerank", "log": {
        "scaling_factor": 1}, "sigmoid": {"pivot": 1, "exponent": 1}}}},
    {"query": {"terms_set": {"body": {"terms": ["fox"]}}}},
    {"query": {"function_score": {"score_mode": "bogus"}}},
    {"query": {"function_score": {"functions": [{"gauss": {"price": {
        "origin": 1}}}]}}},
    {"query": {"function_score": {"functions": [{"gauss": {"price": {
        "origin": 1, "scale": 0}}}]}}},
    {"query": {"function_score": {"functions": [{"weight": 1, "random_score": {},
                                                 "gauss": {}}]}}},
    {"query": {"function_score": {"functions": [{"field_value_factor": {
        "field": "pop", "modifier": "cube"}}]}}},
    {"query": {"geo_distance": {"loc": [1, 2]}}},
    {"query": {"geo_bounding_box": {"loc": {"top": 1}, "other": {}}}},
    {"query": {"boosting": {"positive": {"match_all": {}}}}},
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_errors_match_the_jax_node(all_nodes, i):
    port, ref = all_nodes(1)
    with pytest.raises(ApiError) as p:
        port.search("a", ERRORS[i])
    with pytest.raises(JaxApiError) as r:
        ref.search("a", ERRORS[i])
    assert p.value.status == r.value.status == 400
    assert p.value.reason == r.value.reason


def test_bool_prefix_is_a_400_until_multi_term_expansion(all_nodes):
    port, _ref = all_nodes(1)
    with pytest.raises(ApiError) as p:
        port.search("a", {"query": {"multi_match": {
            "query": "quick fo", "fields": ["title", "body"],
            "type": "bool_prefix"}}})
    assert p.value.status == 400 and "bool_prefix" in p.value.reason


INGEST_ERRORS = [
    {"loc": {"lat": 95.0, "lon": 0.0}},
    {"feats": 3},
    {"answers": ["plain"]},
    {"user": "bob"},
    {"title": {"oops": 1}},
]


@pytest.mark.parametrize("i", range(len(INGEST_ERRORS)))
def test_ingest_errors_match_the_jax_node(all_nodes, i):
    port, ref = all_nodes(1)
    with pytest.raises(ApiError) as p:
        port.index_doc("a", INGEST_ERRORS[i], "bad")
    with pytest.raises(JaxApiError) as r:
        ref.index_doc("a", INGEST_ERRORS[i], "bad")
    assert p.value.status == r.value.status == 400
    assert p.value.reason == r.value.reason


def test_nested_source_and_deleted_parents(all_nodes):
    """The parent's `_source` comes back with its nested arrays; a deleted
    parent drops out of nested answers with its children."""
    port, ref = all_nodes(1)
    body = {"query": BODIES["nested_none"]["query"], "size": 300}
    got = port.search("a", body)
    ids = {h["_id"] for h in got["hits"]["hits"]}
    assert "d0" not in ids and "d23" not in ids  # deleted parents
    hit = got["hits"]["hits"][0]
    assert hit["_source"]["answers"] == ref.search("a", {
        "query": {"ids": {"values": [hit["_id"]]}}})["hits"]["hits"][0][
            "_source"]["answers"]


def test_structured_body_over_rest(all_nodes):
    port, ref = all_nodes(1)
    status, out = RestServer(port).dispatch(
        "POST", "/a/_search", {}, json.dumps(BODIES["nested_bool"]))
    assert status == 200
    assert _view(out) == _view(ref.search("a", BODIES["nested_bool"]))


def test_concurrent_answers_equal_sequential(all_nodes):
    """Each body four times from 8 threads: the micro-batcher coalesces
    same-spec plans into one launch of Q rows (K13 and K14 with Q > 1);
    every answer equals its sequential one."""
    port, _ref = all_nodes(1)
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
