"""Port aggregations of the later slice through the node against the JAX
node: significant_terms, rare_terms, cardinality, top_hits, composite,
matrix_stats, the host metrics (percentiles, percentile_ranks,
extended_stats, median_absolute_deviation), date_histogram and numeric /
boolean terms.

The same documents go to the port's `Node(device="cpu")` and to the JAX
`Node` (started, and its indices created, with ESTPU_MESH_SERVING=0,
ESTPU_EXEC_PLANNER=0, ESTPU_FILTER_CACHE=0 and ESTPU_EXEC_PACKED=0, as
the other node parity suites do), on 1 and 3 shards, over two refreshes
with deletes. The bodies are those of tests/test_aggs_extended.py and the
cardinality / date_histogram tests of tests/test_aggs.py, and one or more
of every other kind this slice serves, with `size: 0` and with a query.
Composite pages are walked to the end with `after` on both nodes.

Tolerances (those of tests/test_torch_aggs_service.py): keys, their
order, doc counts, `bg_count`, significance scores, top_hits ids, scores,
order and `_source`, composite keys and `after_key`, and every host
metric (f64 on both sides): EXACT; bucket sub-metric `sum` / `avg` /
`stats.sum` / `stats.avg` under terms, significant_terms, histogram,
date_histogram and range within rtol 1e-5 (K10's f32 sums in its own
order against XLA's).
"""

import json
import math
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import ApiError as JaxApiError
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.node import ApiError, Node

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
    "cat": {"type": "keyword"},
    "rank": {"type": "long"},
    "price": {"type": "double"},
    "ts": {"type": "date"},
    "flag": {"type": "boolean"},
    "late": {"type": "keyword"},  # only in the second batch
}}

DAY = 86_400_000
T0 = datetime(2023, 1, 1, tzinfo=timezone.utc).timestamp() * 1000.0
EDGES = [datetime(y, m, 1, tzinfo=timezone.utc).timestamp() * 1000.0
         for y in (2023, 2024) for m in range(1, 13)]


def _docs(seed, n, second):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        word = str(rng.choice(["alpha", "beta", "gamma"]))
        # `cat` leans on the body word, so significant_terms finds signal
        cats = {"alpha": ["a1", "a2", "c"], "beta": ["b1", "c", "c"],
                "gamma": ["c", "g1", "a1"]}[word]
        d = {"body": f"{word} {rng.choice(['x', 'y'])}",
             "tag": ["x", "y", "z"][i % 3],
             "cat": str(rng.choice(cats)),
             "rank": int(rng.integers(0, 1000)),
             "price": round(float(rng.uniform(0, 100)), 2),
             "flag": bool(rng.random() < 0.4)}
        if i % 4 == 0:  # within 60 s of a month edge
            d["ts"] = int(EDGES[int(rng.integers(0, len(EDGES)))]
                          + rng.integers(-60_000, 60_001))
        elif i % 9:
            d["ts"] = int(T0 + rng.integers(0, 700) * DAY
                          + rng.integers(0, DAY))
        if i % 17 == 0 and "ts" in d:
            d["ts"] = datetime.fromtimestamp(
                d["ts"] / 1000.0, tz=timezone.utc).strftime(
                    "%Y-%m-%dT%H:%M:%S.%fZ")
        if i % 10 == 0:
            del d["price"]
        if second and i % 3:
            d["late"] = str(rng.choice(["p", "q", "r", "s"]))
        out.append(d)
    return out


def _bulk(docs, start):
    lines = []
    for i, d in enumerate(docs):
        lines += [json.dumps({"index": {"_id": f"d{start + i}"}}),
                  json.dumps(d)]
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
        for start, (seed, count, second) in ((0, (1, 300, False)),
                                             (300, (2, 200, True))):
            out = n.bulk(_bulk(_docs(seed, count, second), start),
                         default_index="a", refresh=True)
            assert not out["errors"]
        for i in range(0, 500, 23):
            n.delete_doc("a", f"d{i}")
        n.refresh("a")
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


MATCH = {"match": {"body": "alpha"}}
TOP = {"th": {"top_hits": {"size": 2, "_source": ["rank", "ts"]}}}
SUBS = {"s": {"sum": {"field": "price"}}, "mn": {"min": {"field": "rank"}},
        "st": {"stats": {"field": "price"}}}

BODIES = {
    # tests/test_aggs_extended.py
    "sum_extended_stats": {"size": 0, "aggs": {
        "s": {"sum": {"field": "price"}},
        "es": {"extended_stats": {"field": "price"}}}},
    "percentiles": {"size": 0, "aggs": {
        "p": {"percentiles": {"field": "rank"}},
        "pu": {"percentiles": {"field": "rank", "percents": [50, 99.9],
                               "keyed": False}},
        "only_x": {"filter": {"term": {"tag": "x"}},
                   "aggs": {"p": {"percentiles": {"field": "rank"}}}},
        "pr": {"percentile_ranks": {"field": "rank", "values": [250, 750]}},
        "pru": {"percentile_ranks": {"field": "price", "values": [10.5],
                                     "keyed": False}}}},
    "top_hits_top_level": {"size": 0, "query": MATCH, "aggs": {
        "th": {"top_hits": {"size": 3}},
        "paged": {"top_hits": {"size": 2, "from": 3, "_source": False}},
        "none": {"top_hits": {"size": 0}}}},
    "top_hits_under_terms": {"size": 0, "aggs": {"tags": {
        "terms": {"field": "tag"},
        "aggs": {"best": {"top_hits": {"size": 2, "_source": ["rank"]}}}}}},
    "top_hits_under_range": {"size": 0, "query": MATCH, "aggs": {"bands": {
        "range": {"field": "rank", "ranges": [{"to": 500}, {"from": 500}]},
        "aggs": {"top": {"top_hits": {"size": 1}}}}}},
    "top_hits_under_histogram": {"size": 0, "aggs": {"h": {
        "histogram": {"field": "rank", "interval": 250},
        "aggs": {"top": {"top_hits": {"size": 1}}}}}},
    "top_hits_context_masks": {"size": 0, "query": MATCH, "aggs": {
        "only_x": {"filter": {"term": {"tag": "x"}}, "aggs": {
            "bands": {"range": {"field": "rank",
                                "ranges": [{"to": 500}, {"from": 500}]},
                      "aggs": {"th": {"top_hits": {"size": 3}}}},
            "t": {"terms": {"field": "cat"}, "aggs": TOP}}},
        "m": {"missing": {"field": "price"}, "aggs": {
            "d": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "quarter"},
                  "aggs": TOP}}},
        "g": {"global": {}, "aggs": TOP}}},
    "top_hits_under_calendar_date_histogram": {"size": 0, "aggs": {"m": {
        "date_histogram": {"field": "ts", "calendar_interval": "month"},
        "aggs": {"th": {"top_hits": {"size": 1}}}}}},
    "composite_desc": {"size": 0, "aggs": {"c": {"composite": {
        "size": 100, "sources": [{"t": {"terms": {"field": "tag",
                                                  "order": "desc"}}}]}}}},
    "composite_date_source": {"size": 0, "aggs": {"c": {"composite": {
        "sources": [{"d": {"date_histogram": {"field": "ts",
                                              "fixed_interval": "30d"}}}]}}}},
    "multi_kind": {"size": 0, "aggs": {
        "p": {"percentiles": {"field": "rank", "percents": [50]}},
        "s": {"sum": {"field": "price"}},
        "th": {"top_hits": {"size": 2}},
        "c": {"composite": {"size": 100,
                            "sources": [{"t": {"terms": {"field": "tag"}}}]}}}},
    # tests/test_aggs.py: cardinality and date_histogram
    "cardinality": {"size": 0, "aggs": {
        "t_card": {"cardinality": {"field": "tag"}},
        "q_card": {"cardinality": {"field": "rank"}},
        "d_card": {"cardinality": {"field": "ts"}},
        "f_card": {"cardinality": {"field": "flag"}},
        "l_card": {"cardinality": {"field": "late"}},
        "u_card": {"cardinality": {"field": "unmapped"}}}},
    "date_histogram_30d": {"size": 0, "aggs": {"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "30d", "min_doc_count": 1}}}},
    # the other kinds and intervals of this slice
    "significant_terms": {"size": 0, "query": MATCH, "aggs": {
        "jlh": {"significant_terms": {"field": "cat", "min_doc_count": 1},
                "aggs": {**SUBS, **TOP}},
        "chi": {"significant_terms": {"field": "cat", "chi_square": {}}},
        "chin": {"significant_terms": {
            "field": "cat", "min_doc_count": 2,
            "chi_square": {"include_negatives": True}}},
        "pct": {"significant_terms": {"field": "cat", "percentage": {},
                                      "size": 2}},
        "late": {"significant_terms": {"field": "late",
                                       "min_doc_count": 1}}}},
    "significant_terms_under_filter": {"size": 0, "aggs": {
        "f": {"filter": {"term": {"body": "beta"}}, "aggs": {
            "s": {"significant_terms": {"field": "cat"}}}},
        "k": {"filters": {"filters": {"g": {"match": {"body": "gamma"}},
                                      "y": {"term": {"tag": "y"}}}},
              "aggs": {"s": {"significant_terms": {"field": "cat"}}}}}},
    "rare_terms": {"size": 0, "aggs": {
        "r": {"rare_terms": {"field": "cat", "max_doc_count": 60}},
        "r1": {"rare_terms": {"field": "late"}},
        "rn": {"rare_terms": {"field": "rank", "max_doc_count": 2}}}},
    "matrix_stats": {"size": 0, "query": MATCH, "aggs": {
        "m": {"matrix_stats": {"fields": ["rank", "price", "ts"]}},
        "f": {"filter": {"term": {"tag": "y"}}, "aggs": {
            "m": {"matrix_stats": {"fields": ["price", "flag"]}}}},
        "mad": {"median_absolute_deviation": {"field": "price"}}}},
    "date_histogram_intervals": {"size": 0, "aggs": {
        "d1": {"date_histogram": {"field": "ts", "fixed_interval": "1d",
                                  "min_doc_count": 1}},
        "h12": {"date_histogram": {"field": "ts", "fixed_interval": "12h",
                                   "min_doc_count": 2},
                "aggs": SUBS},
        "w": {"date_histogram": {"field": "ts", "interval": "week"}},
        "mo": {"date_histogram": {"field": "ts", "calendar_interval": "month"},
               "aggs": SUBS},
        "q": {"date_histogram": {"field": "ts", "calendar_interval": "1q"}},
        "y": {"date_histogram": {"field": "ts", "calendar_interval": "year",
                                 "min_doc_count": 1}}}},
    "numeric_and_boolean_terms": {"size": 0, "aggs": {
        "r": {"terms": {"field": "rank", "size": 5}},
        "rk": {"terms": {"field": "rank", "size": 4,
                         "order": {"_key": "asc"}}},
        "p": {"terms": {"field": "price", "min_doc_count": 2}},
        "f": {"terms": {"field": "flag"}},
        "d": {"terms": {"field": "ts", "size": 3}}}},
    "date_range_query_and_sort": {
        "query": {"range": {"ts": {"gte": "2023-03-01", "lt": 1690000000000}}},
        "size": 7, "sort": [{"ts": "desc"}],
        "aggs": {"d": {"date_histogram": {"field": "ts",
                                          "calendar_interval": "month"}},
                 "st": {"stats": {"field": "ts"}}}},
    "boolean_query": {"query": {"term": {"flag": "true"}}, "size": 5,
                      "aggs": {"f": {"terms": {"field": "flag"}},
                               "c": {"cardinality": {"field": "cat"}}}},
}


def _kind(node):
    return next(k for k in node if k not in ("aggs", "aggregations"))


def _compare(port, ref, spec, worst, tolerant=False, path="aggs"):
    """port == ref under the agg spec, the sums and averages of bucket
    sub-metrics (`tolerant`) within rtol 1e-5; worst[0] keeps the largest
    relative difference among those."""
    for name, node in spec.items():
        kind = _kind(node)
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
        bucket_host = kind in ("terms", "significant_terms", "histogram",
                               "date_histogram", "range")
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
    worst = _compare(p["aggregations"], r["aggregations"], body["aggs"],
                     [0.0])
    assert worst[0] < 1e-5, worst


@pytest.mark.parametrize("name", ["cardinality", "significant_terms",
                                  "top_hits_top_level", "composite_desc",
                                  "matrix_stats", "date_histogram_intervals",
                                  "numeric_and_boolean_terms", "percentiles",
                                  "sum_extended_stats"])
def test_aggregations_on_an_empty_index_match_the_jax_node(nodes, name):
    port, ref = nodes
    body = BODIES[name]
    p, r = port.search("empty", body), ref.search("empty", body)
    assert p["aggregations"] == r["aggregations"]
    assert _hits_view(p) == _hits_view(r)


COMPOSITE_PAGES = {
    "terms_histogram": [{"t": {"terms": {"field": "tag"}}},
                        {"h": {"histogram": {"field": "rank",
                                             "interval": 250}}}],
    "calendar_month_terms_histogram": [
        {"m": {"date_histogram": {"field": "ts", "fixed_interval": "30d"}}},
        {"t": {"terms": {"field": "cat", "order": "desc"}}},
        {"h": {"histogram": {"field": "price", "interval": 25,
                             "offset": 5}}}],
    "numeric_and_boolean_terms": [{"f": {"terms": {"field": "flag"}}},
                                  {"r": {"histogram": {"field": "rank",
                                                       "interval": 100}}},
                                  {"l": {"terms": {"field": "late"}}}],
}


@pytest.mark.parametrize("case", sorted(COMPOSITE_PAGES))
def test_composite_pages_walk_to_the_end_as_the_jax_node(nodes, case):
    """Composite with sub metrics paged with `after` until no after_key:
    every page equal on both nodes, every bucket once."""
    port, ref = nodes
    after, pages, seen = None, 0, set()
    while True:
        comp = {"size": 7, "sources": COMPOSITE_PAGES[case]}
        if after is not None:
            comp["after"] = after
        body = {"size": 0, "aggs": {"c": {
            "composite": comp,
            "aggs": {"ap": {"avg": {"field": "price"}},
                     "mx": {"max": {"field": "rank"}}}}}}
        p, r = port.search("a", body), ref.search("a", body)
        assert p["aggregations"] == r["aggregations"]
        agg = p["aggregations"]["c"]
        for b in agg["buckets"]:
            key = json.dumps(b["key"], sort_keys=True)
            assert key not in seen
            seen.add(key)
        pages += 1
        after = agg.get("after_key")
        if after is None:
            break
    assert pages >= 2 and seen


PARSE_ERRORS = [
    {"c": {"composite": {"sources": {"t": {"terms": {"field": "tag"}}}}}},
    {"c": {"composite": {"sources": []}}},
    {"c": {"composite": {"sources": [{"t": {"terms": {"field": "tag"}},
                                      "u": {"terms": {"field": "cat"}}}]}}},
    {"c": {"composite": {"sources": [{"t": {"terms": {"field": "tag"},
                                            "histogram": {}}}]}}},
    {"c": {"composite": {"sources": [{"t": {"terms": {}}}]}}},
    {"c": {"composite": {"sources": [{"t": {"terms": {"field": "tag",
                                                      "order": "up"}}}]}}},
    {"c": {"composite": {"sources": [{"h": {"histogram": {
        "field": "rank"}}}]}}},
    {"c": {"composite": {"sources": [{"d": {"date_histogram": {
        "field": "ts"}}}]}}},
    {"c": {"composite": {"sources": [{"d": {"date_histogram": {
        "field": "ts", "calendar_interval": "month"}}}]}}},
    {"c": {"composite": {"sources": [{"t": {"terms": {"field": "tag"}}}],
                         "after": {"x": "y"}}}},
    {"c": {"composite": {"sources": [{"t": {"terms": {"field": "tag"}}}]},
           "aggs": {"th": {"top_hits": {}}}}},
    {"c": {"composite": {"sources": [{"h": {"histogram": {
        "field": "cat", "interval": 5}}}]}}},
    {"d": {"date_histogram": {"field": "ts"}}},
    {"d": {"date_histogram": {"field": "ts", "fixed_interval": "3 days"}}},
    {"d": {"date_histogram": {"field": "ts", "fixed_interval": "1ms"}}},
    {"d": {"date_histogram": {"field": "tag", "fixed_interval": "1d"}}},
    {"s": {"significant_terms": {"field": "body"}}},
    {"s": {"significant_terms": {"field": "rank"}}},
    {"r": {"rare_terms": {"field": "body"}}},
    {"m": {"matrix_stats": {"fields": ["rank"]},
           "aggs": {"x": {"max": {"field": "rank"}}}}},
    {"t": {"terms": {"field": "rank"}, "aggs": {"x": {"max": {
        "field": "rank"}}}}},
    {"p": {"percentiles": {"field": "cat"}}},
]


@pytest.mark.parametrize("i", range(len(PARSE_ERRORS)))
def test_parse_errors_match_the_jax_node(nodes, i):
    port, ref = nodes
    body = {"size": 0, "aggs": PARSE_ERRORS[i]}
    with pytest.raises(ApiError) as p:
        port.search("a", body)
    with pytest.raises(JaxApiError) as r:
        ref.search("a", body)
    assert (p.value.status, p.value.reason) == (r.value.status, r.value.reason)


def test_top_hits_order_and_membership(nodes):
    """top_hits' own checks of tests/test_aggs_extended.py on the port:
    totals equal the bucket's doc_count, hits sort by (score desc, doc),
    every member carries the bucket's key, and max_score is taken before
    `from`."""
    port, _ = nodes
    out = port.search("a", {"size": 0, "query": MATCH, "aggs": {
        "tags": {"terms": {"field": "tag"}, "aggs": TOP},
        "all": {"top_hits": {"size": 2, "from": 1}}}})["aggregations"]
    for b in out["tags"]["buckets"]:
        th = b["th"]["hits"]
        assert th["total"]["value"] == b["doc_count"]
        scores = [h["_score"] for h in th["hits"]]
        assert scores == sorted(scores, reverse=True)
        for h in th["hits"]:
            assert set(h["_source"]) <= {"rank", "ts"}
            src = port.search("a", {"query": {"ids": {"values": [h["_id"]]}}})
            assert src["hits"]["hits"][0]["_source"]["tag"] == b["key"]
    every = out["all"]["hits"]
    assert every["max_score"] >= every["hits"][0]["_score"]
