"""Mesh-served REST `_search` on the port (parallel/mesh_serving.py)
against the JAX package's mesh view and the port's own host loop.

Mirrors tests/test_mesh_serving.py, tests/test_mesh_sorted_aggs.py (its
seeded fuzz of sorted, cursored, aggregating and size-0 bodies) and
tests/test_mesh_refresh.py. Every body gets three answers on the same
documents: the port's `Node(device="cpu", mesh_devices=[cpu] * S)` over
REST (served on its mesh, checked by the view's `served` count), the JAX
`Node` (its mesh view on the eight forced host devices), and the port's
host-loop coordinator (the mesh view set aside). All three must be equal,
whole response but `took`: ids, order, fp32 scores, sort values, totals,
buckets and `_shards`. Also: the fallback reasons, re-snapshots after
`_bulk`, delete and refresh (`packs`, `seg_reuses`, `rebuilds`, equal to
the JAX view's), the statistics drift that moves the kernel route and
not the scores, an execute failure through the breaker, and
`classify_mesh_error`.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.parallel import mesh_serving as jms
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.parallel import mesh_serving as ms
from elasticsearch_tpu_torch.rest.server import RestServer
from elasticsearch_tpu_torch.search.service import SearchRequest

torch.set_num_threads(1)

CPU = torch.device("cpu")
JAX_ENV = {"ESTPU_EXEC_PLANNER": "0", "ESTPU_FILTER_CACHE": "0",
           "ESTPU_EXEC_PACKED": "0"}
WORDS = ["ant", "bee", "cat", "dog", "elk", "fox", "gnu", "hen"]
TAGS = ["x", "y", "z"]
DAY = 86_400_000


class Trio:
    """The port node (over REST) and the JAX node on one index."""

    def __init__(self, index: str, body: dict, n_shards: int):
        with pytest.MonkeyPatch.context() as mp:
            for key, val in JAX_ENV.items():
                mp.setenv(key, val)
            self.ref = JaxNode()
            self.ref.create_index(index, body)
        self.port = Node(device="cpu", mesh_devices=[CPU] * n_shards)
        self.port.create_index(index, body)
        self.rest = RestServer(self.port)
        self.index = index

    @property
    def coord(self):
        return self.port.get_index(self.index).search

    @property
    def mv(self):
        return self.coord.mesh_view

    @property
    def jmv(self):
        return self.ref.get_index(self.index).search.mesh_view

    def bulk(self, lines: list[str]) -> None:
        body = "\n".join(lines) + "\n"
        status, out = self.rest.dispatch(
            "POST", f"/{self.index}/_bulk", {"refresh": "true"}, body)
        assert status == 200 and not out["errors"], out
        out = self.ref.bulk(body, default_index=self.index, refresh=True)
        assert not out["errors"]

    def answers(self, body: dict):
        """(port mesh answer, JAX answer, port host-loop answer, served on
        the port's mesh), `took` dropped."""
        mv = self.mv
        before = mv.served
        status, mesh = self.rest.dispatch(
            "POST", f"/{self.index}/_search", {}, json.dumps(body))
        assert status == 200, mesh
        used = mv.served > before
        ref = self.ref.search(self.index, body, request_cache=False)
        self.coord.mesh_view = None
        try:
            status, host = self.rest.dispatch(
                "POST", f"/{self.index}/_search", {}, json.dumps(body))
        finally:
            self.coord.mesh_view = mv
        assert status == 200, host
        return strip(mesh), strip(ref), strip(host), used

    def close(self):
        self.port.close()
        if self.ref.exec_batcher is not None:
            self.ref.exec_batcher.close()


def strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "took"}


def _bulk_lines(seed: int, n: int, prefix: str) -> list[str]:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines.append(json.dumps({"index": {"_id": f"{prefix}{i}"}}))
        lines.append(json.dumps({
            "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 9)))),
            "tag": str(rng.choice(TAGS)),
            "rank": int(rng.integers(0, 500)),
        }))
    return lines


MESH_BODY = {
    "settings": {"index": {"number_of_shards": 8}},
    "mappings": {"properties": {
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "rank": {"type": "long"},
    }},
}


@pytest.fixture(scope="module")
def trio():
    t = Trio("mesh", MESH_BODY, 8)
    t.bulk(_bulk_lines(17, 160, "d"))
    yield t
    t.close()


DSL_MATRIX = [
    {"query": {"match": {"body": "bee cat"}}, "size": 12},
    {"query": {"match": {"body": "ant bee cat dog"}}, "size": 30},
    {"query": {"term": {"tag": "x"}}, "size": 10},
    {"query": {"bool": {"must": [{"match": {"body": "ant"}}],
                        "filter": [{"term": {"tag": "x"}}]}}},
    {"query": {"bool": {"should": [{"match": {"body": "fox"}},
                                   {"match": {"body": "hen"}}],
                        "must_not": [{"term": {"tag": "z"}}]}}},
    {"query": {"range": {"rank": {"gte": 100, "lte": 400}}}, "size": 10},
    {"query": {"exists": {"field": "rank"}}, "size": 5},
    {"query": {"match_phrase": {"body": "bee cat"}}, "size": 5},
    {"query": {"match_phrase": {"body": "ant bee cat"}}, "size": 5},
    {"query": {"dis_max": {"queries": [{"match": {"body": "fox"}},
                                       {"match": {"body": "hen"}}],
                           "tie_breaker": 0.3}}},
    {"query": {"constant_score": {"filter": {"term": {"tag": "y"}},
                                  "boost": 2.5}}},
    {"query": {"ids": {"values": ["d3", "d7", "d11"]}}},
    {"query": {"match_all": {}}, "from": 5, "size": 7},
    {"query": {"match": {"body": "bee"}}, "track_total_hits": 3},
    {"query": {"match": {"body": "bee"}}, "track_total_hits": False},
    {"query": {"match": {"body": "bee"}}, "size": 400},
    {"query": {"match": {"body": "nosuchterm"}}},
    {"query": {"function_score": {"query": {"match": {"body": "gnu"}},
                                  "field_value_factor": {"field": "rank"}}}},
    {"query": {"script_score": {"query": {"match": {"body": "elk"}},
                                "script": {"source":
                                           "_score + doc['rank'].value"}}}},
]


@pytest.mark.parametrize("body", DSL_MATRIX, ids=lambda b: json.dumps(b)[:60])
def test_dsl_matrix_equal_on_three_paths(trio, body):
    mesh, ref, host, used = trio.answers(body)
    assert used, f"mesh path not used for {body}: {trio.mv.last_fallback_reason}"
    assert mesh == ref
    assert mesh == host
    assert mesh["_shards"]["total"] == 8


def test_ineligible_shapes_fall_back_counted(trio):
    mv, jmv = trio.mv, trio.jmv
    for body, reason in [
        ({"query": {"match": {"body": "bee"}},
          "rescore": {"window_size": 5, "query": {"rescore_query": {
              "match": {"body": "cat"}}}}}, "ineligible_shape"),
        ({"query": {"match_all": {}},
          "sort": [{"rank": "asc"}, {"rank": "desc"}]}, "sort_shape"),
        ({"query": {"match": {"body": "bee"}}, "sort": [{"_score": "asc"}]},
         "sort_shape"),
        ({"query": {"match_all": {}}, "size": 0,
          "aggs": {"t": {"terms": {"field": "tag"},
                         "aggs": {"s": {"sum": {"field": "rank"}}}}}},
         "agg_shape"),
        ({"size": 0, "aggs": {"c": {"composite": {"sources": [
            {"t": {"terms": {"field": "tag"}}}]}}}}, "agg_shape"),
        ({"size": 0, "aggs": {"h": {"top_hits": {"size": 2}}}}, "agg_shape"),
    ]:
        before = mv.served
        falls = mv.fallbacks.get(reason, 0)
        jfalls = jmv.fallbacks.get(reason, 0)
        mesh, ref, host, used = trio.answers(body)
        assert not used and mv.served == before
        assert mv.fallbacks.get(reason, 0) == falls + 1, (body, mv.fallbacks)
        assert jmv.fallbacks.get(reason, 0) == jfalls + 1, jmv.fallbacks
        assert mesh == host
        assert mesh["hits"] == ref["hits"]
    req = SearchRequest.from_json({"query": {"match_all": {}}})
    req.after_doc = 3
    assert ms.MeshView.ineligible_reason(req) == "ineligible_shape"


def test_unmapped_sort_falls_back_with_the_host_loops_400(trio):
    body = {"query": {"match_all": {}}, "sort": [{"nosuch": "asc"}]}
    status, out = trio.rest.dispatch(
        "POST", "/mesh/_search", {}, json.dumps(body))
    assert status == 400, out
    assert trio.mv.last_fallback_reason == "sort_shape"


def test_execute_failure_feeds_the_breaker_and_the_host_loop_answers(
        trio, monkeypatch):
    def boom(*_a, **_k):
        raise RuntimeError("out of memory (injected)")

    body = {"query": {"match": {"body": "cat dog"}}, "size": 9}
    mv = trio.mv
    failures = mv.exec_failures
    monkeypatch.setattr(ms, "sharded_execute", boom)
    mesh, ref, host, used = trio.answers(body)
    assert not used and mv.exec_failures == failures + 1
    assert mv.last_fallback_reason == "execute_error"
    assert mesh == ref == host
    assert mv.breaker.state == "closed" and mv.breaker.failures == 1
    monkeypatch.undo()
    mesh, ref, host, used = trio.answers(body)
    assert used and mesh == ref == host
    assert mv.breaker.failures == 0


@pytest.mark.parametrize("error", [
    MemoryError(), RuntimeError("CUDA out of memory"), ValueError("bad"),
    TypeError("x"), AssertionError("parity"), RuntimeError("mismatch here"),
    RuntimeError("something else"), NotImplementedError(),
    RuntimeError("RESOURCE_EXHAUSTED: x"),
])
def test_classify_mesh_error_matches_reference(error):
    assert ms.classify_mesh_error(error) == jms.classify_mesh_error(error)


def test_breaker_latches_on_a_sticky_failure():
    for mod in (ms, jms):
        b = mod.MeshServingBreaker(failure_threshold=2, cooldown_s=0.0)
        b.record_failure(RuntimeError("transient"))
        assert b.allow()
        b.record_failure(RuntimeError("transient"))
        assert b.state == "open" and b.allow() and b.state == "half_open"
        b.record_success()
        assert b.state == "closed" and b.reenable_events == 1
        b.record_failure(ValueError("sticky"))
        assert not b.allow() and b.stats()["state"] == "disabled"


def test_refresh_repacks_one_shard_and_moves_the_route_not_the_scores(trio):
    body = {"query": {"match": {"body": "zebra ant"}}, "size": 20}
    q = SearchRequest.from_json(body).query
    mv, jmv = trio.mv, trio.jmv
    trio.answers(body)
    snap = mv._ensure()
    spec0 = snap.index.compile(q).spec
    counters = lambda v: (v.packs, v.seg_reuses, v.rebuilds)  # noqa: E731
    p0, j0 = counters(mv), counters(jmv)
    # One doc update touches exactly one shard.
    trio.bulk([json.dumps({"index": {"_id": "d9"}}),
               json.dumps({"body": "zebra ant", "tag": "x", "rank": 1})])
    mesh, ref, host, used = trio.answers(body)
    assert used and mesh == ref == host
    assert mesh["hits"]["hits"][0]["_id"] == "d9"
    p1, j1 = counters(mv), counters(jmv)
    assert (p1[0] - p0[0], p1[1] - p0[1], p1[2]) == (1, 7, p0[2])
    assert [a - b for a, b in zip(p1, p0)] == [a - b for a, b in zip(j1, j0)]
    # The engines' statistics moved: the stale impact planes are unused,
    # every shard compiles to the norm-cache gather.
    spec1 = mv._ensure().index.compile(q).spec
    assert spec0[0] == "terms" and spec1[0] == "terms_gather"
    # A delete flows through one shard's repack.
    status, _ = trio.rest.dispatch("DELETE", "/mesh/_doc/d9",
                                   {"refresh": "true"}, None)
    assert status == 200
    trio.ref.delete_doc("mesh", "d9", refresh=True)
    mesh, ref, host, used = trio.answers(body)
    assert used and mesh == ref == host
    assert "d9" not in [h["_id"] for h in mesh["hits"]["hits"]]
    assert mv.packs - p1[0] == 1 and jmv.packs - j1[0] == 1
    # Tombstones keep counting in the statistics: the route stays the
    # gather until every shard packs with one avgdl again.
    assert mv._ensure().index.compile(q).spec[0] == "terms_gather"


def test_growth_rebuilds_every_shard(trio):
    mv = trio.mv
    trio.answers({"query": {"match_all": {}}})
    docs_pad0 = mv._shapes["docs"]
    rebuilds0 = mv.rebuilds
    lines = []
    for i in range(docs_pad0 * 8 + 50):
        lines.append(json.dumps({"index": {"_id": f"g{i}"}}))
        lines.append(json.dumps({"body": "grow bee", "tag": "x", "rank": i}))
    trio.bulk(lines)
    mesh, ref, host, used = trio.answers(
        {"query": {"match": {"body": "grow"}}, "size": 25})
    assert used and mesh == ref == host
    assert mv.rebuilds == rebuilds0 + 1 and mv._shapes["docs"] > docs_pad0


def test_nested_index_falls_back():
    body = {"settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {
                "t": {"type": "text"},
                "qa": {"type": "nested", "properties": {
                    "a": {"type": "text"}}}}}}
    t = Trio("nest", body, 2)
    try:
        t.bulk([json.dumps({"index": {"_id": f"n{i}"}})
                + "\n" + json.dumps({"t": "ant bee", "qa": [{"a": "cat"}]})
                for i in range(6)])
        q = {"query": {"nested": {"path": "qa", "query": {
            "match": {"qa.a": "cat"}}}}}
        mesh, ref, host, used = t.answers(q)
        assert not used and t.mv.last_fallback_reason == "nested"
        assert mesh == ref == host
    finally:
        t.close()


# ---------------------------------------------------------------------------
# The sorted / aggs fuzz (tests/test_mesh_sorted_aggs.py's), 4 shards
# ---------------------------------------------------------------------------

N_DOCS = 260
FZ_BODY = {
    "settings": {"index": {"number_of_shards": 4}},
    "mappings": {"properties": {
        "body": {"type": "text"}, "tag": {"type": "keyword"},
        "price": {"type": "long"}, "qty": {"type": "integer"},
        "ts": {"type": "date"},
    }},
}


def _fz_lines() -> list[str]:
    rng = np.random.default_rng(1234)
    lines = []
    for i in range(N_DOCS):
        doc = {
            "body": " ".join(rng.choice(WORDS[:6], rng.integers(2, 7))),
            "tag": str(rng.choice(TAGS)),
            "qty": int(rng.integers(0, 4)),
            "ts": int(1_700_000_000_000 + int(rng.integers(0, 20)) * DAY),
        }
        if rng.random() > 0.15:
            doc["price"] = int(rng.integers(0, 40))
        lines += [json.dumps({"index": {"_id": f"d{i}"}}), json.dumps(doc)]
    return lines


@pytest.fixture(scope="module")
def fz():
    t = Trio("fz", FZ_BODY, 4)
    t.bulk(_fz_lines())
    yield t
    t.close()


QUERY_POOL = [
    {"match_all": {}},
    {"match": {"body": "bee cat"}},
    {"term": {"tag": "x"}},
    {"bool": {"must": [{"match": {"body": "ant"}}],
              "filter": [{"term": {"tag": "y"}}]}},
]
SORT_POOL = [
    None,
    [{"price": "asc"}],
    [{"price": "desc"}],
    [{"price": {"order": "asc", "missing": "_first"}}],
    [{"price": {"order": "desc", "missing": "_first"}}],
    [{"price": "asc"}, "_doc"],
    [{"qty": "asc"}],
    [{"_score": "desc"}],
]
AGG_POOL = [
    None,
    {"p_stats": {"stats": {"field": "price"}},
     "q_avg": {"avg": {"field": "qty"}},
     "p_count": {"value_count": {"field": "price"}}},
    {"tags": {"terms": {"field": "tag"}},
     "tag_card": {"cardinality": {"field": "tag"}},
     "p_card": {"cardinality": {"field": "price"}}},
    {"hist": {"histogram": {"field": "price", "interval": 7}},
     "days": {"date_histogram": {"field": "ts", "fixed_interval": "1d"}}},
    {"r": {"range": {"field": "price", "ranges": [
        {"to": 10}, {"from": 10, "to": 25}, {"from": 25}]}},
     "pct": {"percentiles": {"field": "price"}}},
    {"only_x": {"filter": {"term": {"tag": "x"}},
                "aggs": {"s": {"sum": {"field": "price"}}}},
     "no_price": {"missing": {"field": "price"}},
     "g": {"global": {}, "aggs": {"mx": {"max": {"field": "qty"}}}}},
    {"fs": {"filters": {"filters": {"a": {"term": {"tag": "x"}},
                                    "b": {"match": {"body": "cat"}}}},
            "aggs": {"e": {"extended_stats": {"field": "qty"}}}},
     "rare": {"rare_terms": {"field": "tag", "max_doc_count": 100}}},
]
TTH_POOL = [True, 10_000, False, 4]


def fuzz_cases():
    rng = np.random.default_rng(77)
    cases = []
    for _ in range(60):
        body = {"query": dict(QUERY_POOL[rng.integers(len(QUERY_POOL))])}
        sort = SORT_POOL[rng.integers(len(SORT_POOL))]
        if sort is not None:
            body["sort"] = sort
        aggs = AGG_POOL[rng.integers(len(AGG_POOL))]
        if aggs is not None:
            body["aggs"] = aggs
        if aggs is not None and rng.random() < 0.25:
            body["size"] = 0
        else:
            body["size"] = int(rng.choice([8, 13]))
        if sort is not None and rng.random() < 0.3:
            body["search_after"] = [int(rng.integers(0, 40))]
        body["track_total_hits"] = TTH_POOL[rng.integers(len(TTH_POOL))]
        cases.append(body)
    return cases


@pytest.mark.parametrize("case", range(60))
def test_fuzz_mesh_equals_reference_and_host_loop(fz, case):
    body = fuzz_cases()[case]
    mesh, ref, host, used = fz.answers(body)
    assert used, f"mesh did not serve {body}: {fz.mv.last_fallback_reason}"
    assert mesh == ref, (json.dumps(mesh)[:1500], json.dumps(ref)[:1500])
    assert mesh == host, (json.dumps(mesh)[:1500], json.dumps(host)[:1500])


@pytest.mark.parametrize("body", [
    {"query": {"match_all": {}}, "sort": [{"price": "asc"}]},
    {"query": {"match_all": {}},
     "sort": [{"price": {"order": "desc", "missing": "_first"}}]},
    {"query": {"match": {"body": "bee cat dog"}}, "sort": [{"_score": "desc"}]},
])
def test_search_after_walk(fz, body):
    """Walk a sorted result set by search_after on all three paths:
    identical pages to the end."""
    body = {**body, "size": 50}
    cursor, seen = None, 0
    for _page in range(8):
        b = dict(body)
        if cursor is not None:
            b["search_after"] = cursor
        mesh, ref, host, used = fz.answers(b)
        assert used and mesh == ref == host
        hits = mesh["hits"]["hits"]
        if not hits:
            break
        seen += len(hits)
        cursor = hits[-1]["sort"]
    assert seen > 50


def test_size0_count_only_serves_on_mesh(fz):
    mesh, ref, host, used = fz.answers(
        {"query": {"term": {"tag": "x"}}, "size": 0})
    assert used and mesh == ref == host
    assert mesh["hits"]["hits"] == []
    assert mesh["hits"]["total"]["value"] > 0
