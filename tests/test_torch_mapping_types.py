"""Port mapping types `boolean`, `date`, `date_nanos`, `short` and `byte`
against the JAX node: ingest, `_mapping`, term / terms / range queries,
can_match bounds and field sorts.

C3 (ROADMAP queue C): the port refused any JSON `true` / `false` with
"boolean field [...] is not supported by this port", where the reference
maps the value as `boolean`; so a `_bulk` of an ordinary document with a
flag in it failed in the port and succeeded in the JAX node. The C3 test
`_bulk`s such documents into both nodes, dynamically and explicitly
mapped, and compares the `_bulk` items, the `_mapping` responses, `term`
on the flag with `true` and `"true"` (and false), and a `terms`
aggregation on the flag (its keys 1.0 / 0.0, no `key_as_string`, as the
reference renders them).

The same documents go to the port's `Node(device="cpu")` and to the JAX
`Node` (ESTPU_MESH_SERVING=0, ESTPU_EXEC_PLANNER=0, ESTPU_FILTER_CACHE=0
and ESTPU_EXEC_PACKED=0, as the other node parity suites), on 1 and 3
shards. Everything is EXACT: doc-values columns (epoch milliseconds from
every date form the reference accepts), error reasons, hits, totals,
`_shards` (can_match's skipped count) and sort values.
"""

import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import ApiError as JaxApiError
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.index.mapping import Mappings, coerce_numeric
from elasticsearch_tpu_torch.node import ApiError, Node
from elasticsearch_tpu_torch.rest.server import RestServer

torch.set_num_threads(1)

JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}


def _jax_node():
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        return JaxNode()


def _create(nodes, name, body):
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        for n in nodes:
            n.create_index(name, body)


def _bulk_lines(docs, start=0):
    lines = []
    for i, d in enumerate(docs):
        lines += [json.dumps({"index": {"_id": f"d{start + i}"}}),
                  json.dumps(d)]
    return "\n".join(lines) + "\n"


def _items(out):
    return [(it["index"]["status"], it["index"].get("error"))
            for it in out["items"]]


def _hits_view(out):
    hits = out["hits"]
    return (out["_shards"], hits.get("total"), hits["max_score"],
            [(h["_id"], h["_score"], h.get("sort"), h.get("_source"))
             for h in hits["hits"]])


# ---------------------------------------------------------------------------
# C3: booleans
# ---------------------------------------------------------------------------

FLAG_DOCS = [
    {"title": "a", "flag": True, "n": 1},
    {"title": "b", "flag": False, "n": 2},
    {"title": "c", "flag": True, "n": 3, "extra": [True, False]},
    {"title": "d", "n": 4},
    {"title": "e", "flag": "false", "n": 5},
]


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("shards", [1, 3])
def test_c3_boolean_bulk_matches_the_jax_node(explicit, shards):
    port, ref = Node(device="cpu"), _jax_node()
    body = {"settings": {"index": {"number_of_shards": shards}}}
    if explicit:
        body["mappings"] = {"properties": {"flag": {"type": "boolean"},
                                           "n": {"type": "short"}}}
    _create((port, ref), "f", body)
    # dynamic: the first doc maps the flag from a JSON boolean
    docs = FLAG_DOCS if explicit else FLAG_DOCS[:4]
    outs = [n.bulk(_bulk_lines(docs), default_index="f", refresh=True)
            for n in (port, ref)]
    assert not outs[1]["errors"]
    assert outs[0]["errors"] == outs[1]["errors"]
    assert _items(outs[0]) == _items(outs[1])
    assert port.get_mapping("f") == ref.get_mapping("f")
    assert port.get_mapping("f")["f"]["mappings"]["properties"]["flag"] == {
        "type": "boolean"}
    for value in (True, "true", False, "false"):
        q = {"query": {"term": {"flag": value}}, "size": 10,
             "sort": [{"n": "asc"}]}
        assert _hits_view(port.search("f", q)) == _hits_view(ref.search("f", q))
    q = {"query": {"terms": {"flag": [True, "false"]}}, "size": 10}
    assert _hits_view(port.search("f", q)) == _hits_view(ref.search("f", q))
    aggs = {"size": 0, "aggs": {"f": {"terms": {"field": "flag"}},
                                "e": {"terms": {"field": "extra"}}}}
    p, r = port.search("f", aggs), ref.search("f", aggs)
    assert p["aggregations"] == r["aggregations"]
    buckets = p["aggregations"]["f"]["buckets"]
    assert {b["key"] for b in buckets} == {0.0, 1.0}
    assert all("key_as_string" not in b for b in buckets)
    port.close()


def test_c3_rest_bulk_and_mapping():
    """Over REST: a `_bulk` with booleans succeeds, GET _mapping shows the
    dynamically mapped types."""
    node = Node(device="cpu")
    rest = RestServer(node)
    status, out = rest.dispatch("POST", "/r/_bulk", {"refresh": "true"},
                                _bulk_lines(FLAG_DOCS[:3]))
    assert status == 200 and not out["errors"]
    status, out = rest.dispatch("GET", "/r/_mapping", {}, "")
    assert status == 200
    props = out["r"]["mappings"]["properties"]
    assert props["flag"] == {"type": "boolean"}
    assert props["extra"] == {"type": "long"}  # a list of booleans, as the reference
    node.close()


@pytest.mark.parametrize("ftype,value,want", [
    ("boolean", True, 1.0), ("boolean", "false", 0.0), ("boolean", 1, 1.0),
    ("date", 1700000000000, 1.7e12), ("date", "1700000000000", 1.7e12),
    ("date", "2024-02-29", 1709164800000.0),
    ("date", "2024-02-29T12:30:00Z", 1709209800000.0),
    ("date", "2024-02-29T12:30:00+02:00", 1709202600000.0),
    ("date_nanos", "2024-02-29T12:30:00.123456789Z", 1709209800123.456),
    ("long", True, 1.0), ("double", "2.5", 2.5),
])
def test_coerce_numeric_as_the_reference(ftype, value, want):
    from elasticsearch_tpu.index.mapping import coerce_numeric as jcoerce

    assert coerce_numeric(ftype, value) == jcoerce(ftype, value) == want


@pytest.mark.parametrize("ftype,value", [
    ("boolean", "maybe"), ("boolean", None), ("date", True),
    ("date", "yesterday"), ("date", [1]), ("date_nanos", "2024-13-01"),
])
def test_coerce_numeric_refuses_as_the_reference(ftype, value):
    from elasticsearch_tpu.index.mapping import coerce_numeric as jcoerce

    with pytest.raises(ValueError) as p:
        coerce_numeric(ftype, value)
    with pytest.raises(ValueError) as r:
        jcoerce(ftype, value)
    assert str(p.value) == str(r.value)


def test_parse_date_millis_is_utc_for_a_zoneless_datetime():
    from elasticsearch_tpu_torch.index.mapping import parse_date_millis

    assert parse_date_millis("2024-01-01T00:00:00") == parse_date_millis(
        "2024-01-01T00:00:00Z") == 1704067200000.0


@pytest.mark.parametrize("value", [True, 3, 2.5, "s", [True], [1, 2.5],
                                   [2, 3], ["a"], {"x": 1}, [], None])
def test_dynamic_types_as_the_reference(value):
    from elasticsearch_tpu.index.mapping import Mappings as JaxMappings

    got = Mappings().resolve_dynamic("f", value)
    want = JaxMappings().resolve_dynamic("f", value)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.type == want.type


# ---------------------------------------------------------------------------
# dates: ingest, ranges, sorts
# ---------------------------------------------------------------------------

BASE = datetime(2024, 1, 1, tzinfo=timezone.utc)


def _date_docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = BASE + timedelta(milliseconds=int(rng.integers(0, 400 * 86400000)))
        ms = int(t.timestamp() * 1000)
        form = i % 7
        if form == 0:
            ts = ms
        elif form == 1:
            ts = str(ms)
        elif form == 2:
            ts = t.strftime("%Y-%m-%dT%H:%M:%S.%fZ")
        elif form == 3:
            ts = t.astimezone(timezone(timedelta(hours=-5))).isoformat()
        elif form == 4:
            ts = t.strftime("%Y-%m-%d")
        elif form == 5:
            ts = [t.isoformat(), "2020-01-01"]  # multi-valued: the first
        else:
            ts = None
        d = {"title": f"w{i % 5}", "small": int(rng.integers(-100, 100)),
             "tiny": int(rng.integers(-10, 10)), "ok": bool(i % 2)}
        if ts is not None:
            d["ts"] = ts
        if i % 3:
            d["nano"] = t.strftime("%Y-%m-%dT%H:%M:%S.%f") + "123Z"
        out.append(d)
    return out


DATE_MAPPINGS = {"properties": {
    "title": {"type": "keyword"}, "ts": {"type": "date"},
    "nano": {"type": "date_nanos"}, "small": {"type": "short"},
    "tiny": {"type": "byte"}, "ok": {"type": "boolean"}}}


@pytest.fixture(scope="module", params=[1, 3])
def date_nodes(request):
    port, ref = Node(device="cpu"), _jax_node()
    _create((port, ref), "t", {
        "settings": {"index": {"number_of_shards": request.param}},
        "mappings": DATE_MAPPINGS})
    for n in (port, ref):
        for start, seed in ((0, 3), (150, 4)):
            out = n.bulk(_bulk_lines(_date_docs(seed, 150), start),
                         default_index="t", refresh=True)
            assert not out["errors"], out["items"][:3]
        for i in range(0, 300, 19):
            n.delete_doc("t", f"d{i}")
        n.refresh("t")
    yield port, ref
    port.close()


def test_date_columns_equal_the_reference(date_nodes):
    port, ref = date_nodes
    pe, re_ = port.get_index("t").engines, ref.get_index("t").engines
    for pengine, rengine in zip(pe, re_):
        for ph, rh in zip(pengine.segments, rengine.segments):
            assert set(ph.segment.doc_values) == set(rh.segment.doc_values)
            for f, col in rh.segment.doc_values.items():
                np.testing.assert_array_equal(ph.segment.doc_values[f], col)
    assert port.get_mapping("t") == ref.get_mapping("t")


DATE_QUERIES = {
    "range_iso": {"range": {"ts": {"gte": "2024-03-01", "lt": "2024-06-01"}}},
    "range_epoch": {"range": {"ts": {"gt": 1704067200000,
                                     "lte": "1712000000000"}}},
    "range_datetime": {"range": {"ts": {"gte": "2024-02-10T08:00:00Z",
                                        "lt": "2024-02-20T08:00:00+03:00"}}},
    "range_nanos": {"range": {"nano": {"gte": "2024-05-01T00:00:00.5Z"}}},
    "range_outside": {"range": {"ts": {"lt": "2000-01-01"}}},
    "term_date": {"term": {"ts": "2024-01-01"}},
    "terms_short": {"terms": {"small": [3, "-7", 12]}},
    "range_byte": {"range": {"tiny": {"gte": -2, "lt": 4}}},
    "bool_filter": {"bool": {"must": [{"term": {"title": "w1"}}],
                             "filter": [{"range": {"ts": {
                                 "gte": "2024-04-01"}}},
                                 {"term": {"ok": "true"}}]}},
}

DATE_SORTS = {
    "ts_desc": [{"ts": "desc"}],
    "ts_asc_missing_first": [{"ts": {"order": "asc", "missing": "_first"}}],
    "nano_asc": [{"nano": "asc"}],
    "small_then_ts": [{"small": "desc"}, {"ts": "asc"}],
}


@pytest.mark.parametrize("query", sorted(DATE_QUERIES))
@pytest.mark.parametrize("sort", sorted(DATE_SORTS))
def test_date_queries_and_sorts_match_the_jax_node(date_nodes, query, sort):
    port, ref = date_nodes
    body = {"query": DATE_QUERIES[query], "sort": DATE_SORTS[sort],
            "size": 12}
    assert _hits_view(port.search("t", body)) == _hits_view(
        ref.search("t", body))


def test_date_search_after_walk_matches_the_jax_node(date_nodes):
    port, ref = date_nodes
    after = None
    for _ in range(5):
        body = {"query": {"match_all": {}}, "sort": [{"ts": "asc"}],
                "size": 9}
        if after is not None:
            body["search_after"] = after
        p, r = port.search("t", body), ref.search("t", body)
        assert _hits_view(p) == _hits_view(r)
        after = p["hits"]["hits"][-1]["sort"]


@pytest.mark.parametrize("doc", [{"ts": "not a date"}, {"ts": True},
                                 {"ok": "yes"}, {"ok": 2.5, "ts": "2024-01"},
                                 {"nano": "2024-02-30"}, {"small": "x"}])
def test_bad_values_are_refused_as_the_reference(date_nodes, doc):
    port, ref = date_nodes
    outs = [n.bulk(_bulk_lines([doc], 9000), default_index="t")
            for n in (port, ref)]
    assert outs[1]["errors"]
    assert outs[0]["errors"]
    (ps, pe), (rs, re_) = _items(outs[0])[0], _items(outs[1])[0]
    assert ps == rs == 400
    if "small" not in doc:
        assert pe == re_


def test_date_range_query_answers_400_like_the_reference(date_nodes):
    port, ref = date_nodes
    body = {"query": {"range": {"ts": {"gte": "next tuesday"}}}}
    with pytest.raises(ApiError) as p:
        port.search("t", body)
    with pytest.raises(JaxApiError) as r:
        ref.search("t", body)
    assert p.value.status == r.value.status
