"""Port `aggs` / `aggregations` through the node against the JAX node.

The same documents go to the port's `Node(device="cpu")` and to the JAX
`Node` (started, and its indices created, with ESTPU_MESH_SERVING=0,
ESTPU_EXEC_PLANNER=0, ESTPU_FILTER_CACHE=0 and ESTPU_EXEC_PACKED=0, as
the other node parity suites do), on 1 and 3 shards, over two refreshes
(two segments a shard) with deletes, with fields absent from the first
segment, and on an empty index. Every kind this slice serves (the six
metrics, terms, histogram, range, filter, filters, global, missing),
nested under the filter family, with `size: 0` and with hits.

Tolerances (fixed before the port was written):
- bucket keys, their order, doc_counts, `sum_other_doc_count`,
  `doc_count_error_upper_bound`, `hits.total`, the hits and `_shards`:
  EXACT;
- top-level and filter-family `min` / `max` / `sum` / `avg` /
  `value_count` / `stats`: EXACT (both fold the matched f64 values on the
  host, segment by segment);
- bucket sub-metric `min`, `max`, `value_count` and `stats.count /
  min / max`: EXACT;
- bucket sub-metric `sum`, `avg` and `stats.sum / avg`: rtol 1e-5, the
  bound the reference holds its own device sums to
  (tests/test_aggs.py:254): both sum in f32 on the device, each in its own
  order (XLA's scatter and reduce; K10's chunks). The largest relative
  difference measured here is 1.05e-7 (the `range` body on 3 shards).
The 400s: status and reason equal to the reference's for every parse
error both refuse, among them a body of each kind a later slice added
(tests/test_torch_aggs_ext_service.py serves those kinds).
"""

import json
import math

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import ApiError as JaxApiError
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import ApiError, Node
from elasticsearch_tpu_torch.rest.server import RestServer
from elasticsearch_tpu_torch.search.service import SearchRequest

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
    "w": {"type": "float"},
    "late": {"type": "double"},  # only in the second batch of documents
    "color": {"type": "keyword"},  # only in the second batch
}}


def _docs(seed, n, second):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(["x", "y", "z", "w", "v"], 3)),
             "tag": f"t{int(rng.zipf(1.5)) % 30}",
             "w": float(np.float32(rng.random() * 10.0 ** int(rng.integers(0, 4))))}
        if i % 9:
            d["price"] = int(rng.integers(0, 2000))
        if i % 13 == 0:
            d["w"] = -0.0
        if second:
            d["late"] = float(rng.integers(-50, 50))
            if i % 4:
                d["color"] = str(rng.choice(["red", "green", "blue"]))
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
        ref.create_index("empty", body)
    port = Node(device="cpu")
    port.create_index("a", body)
    port.create_index("empty", body)
    for n in (port, ref):
        n.bulk(_bulk(_docs(1, 260, False), 0), default_index="a", refresh=True)
        n.bulk(_bulk(_docs(2, 180, True), 260), default_index="a", refresh=True)
        for i in range(0, 440, 17):
            n.delete_doc("a", f"d{i}")
        n.refresh("a")
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


SUB_METRICS = {"s": {"sum": {"field": "w"}}, "a": {"avg": {"field": "price"}},
               "mn": {"min": {"field": "w"}}, "mx": {"max": {"field": "w"}},
               "vc": {"value_count": {"field": "late"}},
               "st": {"stats": {"field": "w"}}}

BODIES = {
    "metrics": {"size": 0, "aggs": {
        "mn": {"min": {"field": "w"}}, "mx": {"max": {"field": "price"}},
        "s": {"sum": {"field": "w"}}, "a": {"avg": {"field": "late"}},
        "vc": {"value_count": {"field": "price"}},
        "st": {"stats": {"field": "late"}}}},
    "terms_keyword": {"size": 0, "aggs": {"t": {"terms": {"field": "tag"},
                                                "aggs": SUB_METRICS}}},
    "terms_orders": {"size": 0, "aggs": {
        "k": {"terms": {"field": "tag", "size": 4, "order": {"_key": "desc"}}},
        "c": {"terms": {"field": "tag", "size": 3, "order": {"_count": "asc"}}},
        "m": {"terms": {"field": "tag", "min_doc_count": 5, "size": 50}}}},
    "terms_absent_in_one_segment": {"size": 0, "aggs": {
        "c": {"terms": {"field": "color"},
              "aggs": {"s": {"sum": {"field": "late"}}}}}},
    "histogram": {"size": 0, "aggs": {
        "h": {"histogram": {"field": "price", "interval": 250},
              "aggs": SUB_METRICS},
        "ho": {"histogram": {"field": "late", "interval": 7.5, "offset": 2.5,
                             "min_doc_count": 2}},
        "hl": {"histogram": {"field": "late", "interval": 10}}}},
    "range": {"size": 0, "aggs": {
        "r": {"range": {"field": "price", "ranges": [
            {"to": 500}, {"from": 250, "to": 1250, "key": "mid"},
            {"from": 1000}]}, "aggs": SUB_METRICS},
        "rl": {"range": {"field": "late", "ranges": [{"from": 0}]}}}},
    "filter_nesting": {"size": 0, "aggs": {
        "f": {"filter": {"range": {"price": {"gte": 200, "lt": 1500}}},
              "aggs": {"t": {"terms": {"field": "tag", "size": 5},
                             "aggs": {"s": {"sum": {"field": "w"}}}},
                       "h": {"histogram": {"field": "price", "interval": 500}},
                       "in": {"filter": {"term": {"tag": "t1"}},
                              "aggs": {"a": {"avg": {"field": "w"}}}}}}}},
    "filters_nesting": {"size": 0, "aggs": {
        "k": {"filters": {"filters": {
            "x": {"match": {"body": "x"}},
            "cheap": {"range": {"price": {"lt": 300}}},
            "red": {"term": {"color": "red"}}}},
            "aggs": {"r": {"range": {"field": "w", "ranges": [{"to": 1},
                                                              {"from": 1}]},
                           "aggs": {"s": {"sum": {"field": "price"}}}}}},
        "l": {"filters": {"filters": [{"match": {"body": "y z"}},
                                      {"exists": {"field": "color"}}]},
              "aggs": {"st": {"stats": {"field": "late"}}}}}},
    "global_missing": {"query": {"match": {"body": "v"}}, "size": 0, "aggs": {
        "g": {"global": {}, "aggs": {"t": {"terms": {"field": "tag", "size": 3}},
                                     "m": {"missing": {"field": "price"}},
                                     "st": {"stats": {"field": "w"}}}},
        "mp": {"missing": {"field": "price"}, "aggs": {
            "h": {"histogram": {"field": "w", "interval": 100}}}},
        "mc": {"missing": {"field": "color"}},
        "mu": {"missing": {"field": "unmapped_field"}}}},
    "with_hits": {"query": {"bool": {"should": [{"match": {"body": "x w"}}],
                                     "filter": [{"range": {"price": {"gte": 100}}}]}},
                  "size": 7, "aggs": {
                      "t": {"terms": {"field": "tag", "size": 3},
                            "aggs": {"mx": {"max": {"field": "price"}}}},
                      "st": {"stats": {"field": "w"}}}},
    "sorted_with_aggs": {"sort": [{"price": "desc"}], "size": 5,
                         "aggregations": {"h": {"histogram": {
                             "field": "price", "interval": 400}}}},
    "track_total_hits_small": {"size": 0, "track_total_hits": 10,
                               "aggs": {"s": {"sum": {"field": "price"}}}},
}


def _compare(port, ref, spec, worst, tolerant=False, path="aggs"):
    """port == ref under the agg spec, the sums and averages of bucket
    sub-metrics (`tolerant`) within rtol 1e-5; worst[0] keeps the largest
    relative difference among those."""
    for name, node in spec.items():
        kind = next(k for k in node if k not in ("aggs", "aggregations"))
        subs = node.get("aggs") or node.get("aggregations") or {}
        p, r = port[name], ref[name]
        where = f"{path}/{name}"
        if kind in ("sum", "avg", "stats") and tolerant:
            keys = ("value",) if kind != "stats" else ("sum", "avg")
            assert set(p) == set(r), where
            for key in p:
                if key in keys and r[key] is not None:
                    assert p[key] is not None, where
                    assert math.isclose(p[key], r[key], rel_tol=1e-5), (
                        where, p[key], r[key])
                    if r[key] != 0:
                        worst[0] = max(worst[0],
                                       abs(p[key] - r[key]) / abs(r[key]))
                else:
                    assert p[key] == r[key], (where, key, p[key], r[key])
            continue
        if not subs:
            assert p == r, (where, p, r)
            continue
        if kind in ("filter", "global", "missing"):
            assert p["doc_count"] == r["doc_count"], where
            _compare(p, r, subs, worst, tolerant, where)
            continue
        pb, rb = p["buckets"], r["buckets"]
        assert {k: v for k, v in p.items() if k != "buckets"} == {
            k: v for k, v in r.items() if k != "buckets"}, where
        if isinstance(rb, dict):
            assert list(pb) == list(rb), where
            pairs = [(pb[k], rb[k]) for k in rb]
        else:
            assert len(pb) == len(rb), (where, pb, rb)
            pairs = list(zip(pb, rb))
        bucket_host = kind in ("terms", "histogram", "range")
        for i, (x, y) in enumerate(pairs):
            plain = {k: v for k, v in x.items() if k not in subs}
            assert plain == {k: v for k, v in y.items() if k not in subs}, (
                where, i, x, y)
            _compare(x, y, subs, worst, tolerant or bucket_host, f"{where}/{i}")
    return worst


def _hits_view(out):
    hits = out["hits"]
    return (out["_shards"], hits.get("total"), hits["max_score"],
            [(h["_id"], h["_score"], h.get("sort")) for h in hits["hits"]])


@pytest.mark.parametrize("name", sorted(BODIES))
def test_aggregations_match_the_jax_node(nodes, name):
    port, ref = nodes
    body = BODIES[name]
    p, r = port.search("a", body), ref.search("a", body)
    assert _hits_view(p) == _hits_view(r)
    assert "aggregations" in r
    spec = body.get("aggs") or body["aggregations"]
    worst = _compare(p["aggregations"], r["aggregations"], spec, [0.0])
    assert worst[0] < 1e-5, worst


@pytest.mark.parametrize("name", ["metrics", "terms_keyword", "histogram",
                                  "range", "filters_nesting", "global_missing"])
def test_aggregations_on_an_empty_index_match_the_jax_node(nodes, name):
    port, ref = nodes
    body = BODIES[name]
    p, r = port.search("empty", body), ref.search("empty", body)
    assert p["aggregations"] == r["aggregations"]
    assert _hits_view(p) == _hits_view(r)


def test_empty_aggs_object_renders_no_aggregations(nodes):
    port, ref = nodes
    body = {"size": 0, "aggs": {}}
    p, r = port.search("a", body), ref.search("a", body)
    assert "aggregations" not in p and "aggregations" not in r
    assert _hits_view(p) == _hits_view(r)


PARSE_ERRORS = [
    {"aggs": {"x": {"foo": {"field": "w"}}}},
    {"aggs": {"x": 5}},
    {"aggs": {"x": {"terms": {"field": "tag"}, "avg": {"field": "w"}}}},
    {"aggs": {"x": {"aggs": {"y": {"max": {"field": "w"}}}}}},
    {"aggs": {"x": {"avg": {"field": "w"}, "aggs": {"y": {"max": {"field": "w"}}}}}},
    {"aggs": {"x": {"cardinality": {"field": "tag"},
                    "aggs": {"y": {"max": {"field": "w"}}}}}},
    {"aggs": {"x": {"histogram": {"field": "price", "interval": 10},
                    "aggs": {"y": {"terms": {"field": "tag"}}}}}},
    {"aggs": {"x": {"terms": {"size": 3}}}},
    {"aggs": {"x": {"missing": {}}}},
    {"aggs": {"x": {"percentile_ranks": {"field": "w"}}}},
    {"aggs": {"x": {"matrix_stats": {}}}},
    {"aggs": {"x": {"global": {}, "aggs": {"c": {"composite": {"sources": [
        {"t": {"terms": {"field": "tag"}}}]}}}}}},
    {"aggs": {"x": {"histogram": {"field": "price"}}}},
    {"aggs": {"x": {"histogram": {"field": "price", "interval": -1}}}},
    {"aggs": {"x": {"histogram": {"field": "w", "interval": 1e-9}}}},
    {"aggs": {"x": {"range": {"field": "price"}}}},
    {"aggs": {"x": {"avg": {"field": "tag"}}}},
    {"aggs": {"x": {"range": {"field": "tag", "ranges": [{"to": 1}]}}}},
    {"aggs": {"x": {"terms": {"field": "body"}}}},
    {"aggs": {"x": {"terms": {"field": "price"},
                    "aggs": {"s": {"sum": {"field": "w"}}}}}},
    {"aggs": {"x": {"terms": {"field": "tag"},
                    "aggs": {"s": {"sum": {"field": "tag"}}}}}},
    {"aggs": {"x": {"filter": {"nosuch": {}}}}},
    {"aggs": {"x": {"filters": {"other": 1}}}},
    {"knn": {"field": "w", "query_vector": [1.0]},
     "aggs": {"x": {"max": {"field": "w"}}}},
]


@pytest.mark.parametrize("i", range(len(PARSE_ERRORS)))
def test_parse_errors_match_the_jax_node(nodes, i):
    port, ref = nodes
    body = PARSE_ERRORS[i]
    with pytest.raises(ApiError) as p:
        port.search("a", body)
    with pytest.raises(JaxApiError) as r:
        ref.search("a", body)
    assert (p.value.status, p.value.reason) == (r.value.status, r.value.reason)


# The kinds an earlier slice of the port left out, each in a body the
# reference refuses too.
LEFT_OUT = [
    ("top_hits", {"t": {"top_hits": {"size": 1},
                        "aggs": {"x": {"max": {"field": "w"}}}}}),
    ("top_hits", {"t": {"terms": {"field": "tag"}, "aggs": {
        "h": {"top_hits": {"size": 1},
              "aggs": {"m": {"max": {"field": "w"}}}}}}}),
    ("composite", {"c": {"composite": {"sources": [
        {"t": {"geotile_grid": {"field": "tag"}}}]}}}),
    ("significant_terms", {"s": {"significant_terms": {"field": "price"}}}),
    ("rare_terms", {"r": {"rare_terms": {"field": "tag"},
                          "aggs": {"m": {"max": {"field": "w"}}}}}),
    ("matrix_stats", {"f": {"global": {}, "aggs": {
        "m": {"matrix_stats": {"fields": ["w", "tag"]}}}}}),
    ("cardinality", {"c": {"cardinality": {"field": "body"}}}),
    ("percentiles", {"p": {"percentiles": {"field": "tag"}}}),
    ("percentile_ranks", {"p": {"percentile_ranks": {"field": "tag",
                                                     "values": [5]}}}),
    ("extended_stats", {"e": {"extended_stats": {"field": "color"}}}),
    ("median_absolute_deviation", {"m": {"median_absolute_deviation": {}}}),
    ("date_histogram", {"d": {"date_histogram": {
        "field": "price", "calendar_interval": "fortnight"}}}),
]


@pytest.mark.parametrize("i", range(len(LEFT_OUT)))
def test_left_out_kinds_answer_400(nodes, i):
    """The kinds an earlier slice left out are served now: a body of each
    that the reference refuses gets the reference's 400 and reason."""
    port, ref = nodes
    kind, aggs = LEFT_OUT[i]
    assert kind in json.dumps(aggs)
    with pytest.raises(ApiError) as p:
        port.search("a", {"size": 0, "aggs": aggs})
    with pytest.raises(JaxApiError) as r:
        ref.search("a", {"size": 0, "aggs": aggs})
    assert p.value.status == r.value.status == 400
    assert p.value.reason == r.value.reason


def test_numeric_terms_answers_400(nodes):
    """terms over a numeric field is served over the host column (the
    reference's host fallback); with a sub-aggregation it is the
    reference's 400."""
    port, ref = nodes
    body = {"size": 0, "aggs": {"p": {"terms": {"field": "price"}, "aggs": {
        "h": {"top_hits": {"size": 1}}}}}}
    with pytest.raises(ApiError) as p:
        port.search("a", body)
    with pytest.raises(JaxApiError) as r:
        ref.search("a", body)
    assert p.value.status == r.value.status == 400
    assert p.value.reason == r.value.reason
    plain = {"size": 0, "aggs": {"p": {"terms": {"field": "price"}}}}
    assert port.search("a", plain)["aggregations"] == ref.search(
        "a", plain)["aggregations"]


def test_aggregation_requests_take_the_solo_path(nodes):
    """Bodies with aggs are not batchable (the reference's node.py:2113):
    the micro-batcher sees no request for them."""
    port, _ = nodes
    svc = port.get_index("a")
    request = SearchRequest.from_json(BODIES["with_hits"])
    assert not port._batchable(request, svc)
    before = port.exec_batcher.stats()["requests"]
    port.search("a", BODIES["with_hits"])
    assert port.exec_batcher.stats()["requests"] == before
    plain = SearchRequest.from_json({"query": {"match": {"body": "x"}}})
    assert port._batchable(plain, svc)


def test_aggregations_over_rest(nodes):
    """The REST `_search` route carries `aggregations` in its body."""
    port, ref = nodes
    rest = RestServer(port)
    body = BODIES["terms_orders"]
    status, out = rest.dispatch("POST", "/a/_search", {}, json.dumps(body))
    assert status == 200
    assert out["aggregations"] == ref.search("a", body)["aggregations"]
