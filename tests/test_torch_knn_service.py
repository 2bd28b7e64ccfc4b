"""The port's kNN serving path against the JAX package's: the dense_vector
mapping and ingest 400s, the top-level `knn` section and `_knn_search`
over REST on one and on N shards, filtered knn, vector-less and deleted
docs, coalesced knn, and the script_score vector functions (BASELINE
config 5's `cosineSimilarity(params.qv, 'vec') + 1.0`, `dotProduct`,
`l2norm`), on the same documents through both nodes.

Both nodes run without the exec planner (ESTPU_EXEC_PLANNER=0 /
exec_planner=False), so every segment with IVF planes serves `ann_ivf`
in both, and with a lowered ANN `min_docs` (ESTPU_ANN_MIN_DOCS /
AnnCache(min_docs=...)) so a few thousand docs are partitioned. Each
node builds its own planes (the same seeded k-means; tests/
test_torch_knn.py holds the builds equal).

Tolerances: status codes, error reasons, totals, `_shards` and hit ids
exact; scores within the reference's bound for vector scores, rtol =
atol = 1e-5 (tests/test_script_knn.py:107), because XLA's reductions
and matmuls sum in another order than K7. Two neighbours whose scores
lie within that bound of each other may swap (`ranked_close` allows
exactly that, measured on a float64 numpy oracle). Within the port
(batched against solo, concurrent against sequential, with the ANN cache
on and off for script_score): exact.
"""

import json
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.rest.server import RestServer as JaxRest
from elasticsearch_tpu_torch.index.ann import AnnCache
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestServer
from elasticsearch_tpu_torch.search.service import SearchRequest

torch.set_num_threads(1)

TOL = 1e-5
D = 12
MIN_DOCS = 256
JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
    "ESTPU_ANN_MIN_DOCS": str(MIN_DOCS),
}
VOCAB = [f"w{i}" for i in range(30)]


def _jax_node():
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        return JaxNode()


def _port_node(**kw):
    kw.setdefault("ann_cache", AnnCache(min_docs=MIN_DOCS))
    return Node(device="cpu", exec_planner=False, **kw)


def _close(port, ref):
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def _mapping(metric="cosine", shards=1):
    return {
        "settings": {"index": {"number_of_shards": shards}},
        "mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": D, "similarity": metric},
            "body": {"type": "text"},
            "tag": {"type": "keyword"},
            "pop": {"type": "float"},
        }},
    }


def _docs(seed, n, metric, vectorless_every=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((10, D)).astype(np.float32) * 3
    vecs = centers[rng.integers(0, 10, n)] + rng.standard_normal((n, D)).astype(np.float32)
    if metric == "dot_product":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    docs = {}
    for i in range(n):
        doc = {"body": " ".join(rng.choice(VOCAB, 3)),
               "tag": "odd" if i % 2 else "even",
               "pop": float(rng.random())}
        if not (vectorless_every and i % vectorless_every == 0):
            doc["vec"] = vecs[i].astype(np.float32).tolist()
        docs[f"d{i}"] = doc
    return docs, centers, rng


def _load(nodes, index, docs, body):
    lines = []
    for doc_id, doc in docs.items():
        lines += [json.dumps({"index": {"_id": doc_id}}), json.dumps(doc)]
    for n in nodes:
        n.create_index(index, body)
        out = n.bulk("\n".join(lines) + "\n", default_index=index)
        assert not out["errors"]
        n.refresh(index)


def _oracle(docs, q, metric):
    """float64 similarity of q against every doc with a vector."""
    q = np.asarray(q, np.float64)
    out = {}
    for doc_id, doc in docs.items():
        if "vec" not in doc:
            continue
        v = np.asarray(doc["vec"], np.float32).astype(np.float64)
        if metric == "l2_norm":
            out[doc_id] = 1 / (1 + ((v - q) ** 2).sum())
        elif metric == "dot_product":
            out[doc_id] = (1 + v @ q) / 2
        else:
            out[doc_id] = (1 + v @ q / np.linalg.norm(v) / np.linalg.norm(q)) / 2
    return out


def ranked_close(p, r, oracle):
    """Port answer p against the reference's r: totals and `_shards`
    exact, scores within TOL by position, ids equal except a swap of two
    docs whose oracle scores lie within TOL. Returns the swap count."""
    assert p["hits"].get("total") == r["hits"].get("total")
    assert p["_shards"] == r["_shards"]
    ph, rh = p["hits"]["hits"], r["hits"]["hits"]
    assert len(ph) == len(rh)
    np.testing.assert_allclose([h["_score"] for h in ph],
                               [h["_score"] for h in rh], rtol=TOL, atol=TOL)
    swaps = 0
    for a, b in zip(ph, rh):
        if a["_id"] != b["_id"]:
            gap = abs(oracle[a["_id"]] - oracle[b["_id"]])
            assert gap <= TOL, (a["_id"], b["_id"], gap)
            swaps += 1
    return swaps


def _knn(q, k=10, num_candidates=100, **extra):
    knn = {"field": "vec", "query_vector": [float(x) for x in q], "k": k,
           "num_candidates": num_candidates}
    knn.update(extra)
    return {"knn": knn, "_source": False}


# ---------------------------------------------------------------------------
# The knn section over REST against the JAX node
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("shards", [1, 3])
def test_knn_section_matches_reference(metric, shards):
    docs, centers, rng = _docs(7, 2400, metric, vectorless_every=50)
    port, ref = _port_node(), _jax_node()
    try:
        _load((port, ref), "v", docs, _mapping(metric, shards))
        bodies = []
        for j in range(4):
            q = centers[j] + 0.5 * rng.standard_normal(D)
            bodies += [_knn(q), _knn(q, k=7, num_candidates=20),
                       {**_knn(q, k=12), "size": 5, "from": 3},
                       _knn(q, k=5, nprobe=4096)]
        for body in bodies:
            p, r = port.search("v", body), ref.search("v", body)
            ranked_close(p, r, _oracle(docs, body["knn"]["query_vector"], metric))
            assert len(p["hits"]["hits"]) == min(
                body.get("size", 10), body["knn"]["k"] - body.get("from", 0))
        assert port.ann_cache.stats()["planes"] == shards
    finally:
        _close(port, ref)


def test_filtered_knn_and_knn_search_endpoint_match_reference():
    docs, centers, rng = _docs(8, 2000, "cosine")
    port, ref = _port_node(), _jax_node()
    prest, rrest = RestServer(port), JaxRest(node=ref)
    try:
        _load((port, ref), "v", docs, _mapping())
        filters = [{"term": {"tag": "odd"}}, {"range": {"pop": {"lt": 0.3}}},
                   {"bool": {"must": [{"match": {"body": "w1 w2"}}],
                             "must_not": [{"term": {"tag": "even"}}]}}]
        for j, filt in enumerate(filters):
            q = centers[j] + 0.4 * rng.standard_normal(D)
            body = _knn(q, k=8, num_candidates=60, filter=filt)
            p, r = port.search("v", body), ref.search("v", body)
            ranked_close(p, r, _oracle(docs, q, "cosine"))
            # _knn_search with the filter at the top level
            kbody = {"knn": {k: v for k, v in body["knn"].items() if k != "filter"},
                     "filter": filt, "_source": False}
            (ps, pb), (rs, rb) = (x.dispatch("POST", "/v/_knn_search", {},
                                             json.dumps(kbody))
                                  for x in (prest, rrest))
            assert ps == rs == 200
            ranked_close(pb, rb, _oracle(docs, q, "cosine"))
            assert [h["_id"] for h in pb["hits"]["hits"]] == [
                h["_id"] for h in p["hits"]["hits"]]
        odd = port.search("v", _knn(centers[0], k=20, filter=filters[0]))
        assert all(int(h["_id"][1:]) % 2 for h in odd["hits"]["hits"])
        (ps, pb), (rs, rb) = (x.dispatch("POST", "/v/_knn_search", {}, "{}")
                              for x in (prest, rrest))
        assert ps == rs == 400
        assert pb["error"]["reason"] == rb["error"]["reason"]
    finally:
        _close(port, ref)


def test_k_at_the_candidate_limit_matches_reference():
    """k = num_candidates = 10,000 over fewer docs: every doc with a
    vector comes back, in the reference's order."""
    docs, centers, rng = _docs(9, 1200, "l2_norm", vectorless_every=7)
    port, ref = _port_node(), _jax_node()
    try:
        _load((port, ref), "v", docs, _mapping("l2_norm"))
        q = centers[1] + rng.standard_normal(D)
        body = {**_knn(q, k=10_000, num_candidates=10_000), "size": 10_000}
        p, r = port.search("v", body), ref.search("v", body)
        ranked_close(p, r, _oracle(docs, q, "l2_norm"))
        assert len(p["hits"]["hits"]) == sum("vec" in d for d in docs.values())
    finally:
        _close(port, ref)


def test_vectorless_and_deleted_docs_never_surface():
    docs, centers, rng = _docs(10, 1500, "cosine", vectorless_every=3)
    for cache in (AnnCache(min_docs=MIN_DOCS), False):
        port = _port_node(ann_cache=cache)
        try:
            _load((port,), "v", docs, _mapping())
            q = centers[2] + 0.1 * rng.standard_normal(D)
            first = port.search("v", {**_knn(q, k=40, num_candidates=200),
                                      "size": 40})
            hits = [h["_id"] for h in first["hits"]["hits"]]
            assert len(hits) == 40
            assert all("vec" in docs[h] for h in hits)
            victim = hits[0]
            port.delete_doc("v", victim)
            port.refresh("v")
            again = port.search("v", {**_knn(q, k=40, num_candidates=200),
                                      "size": 40})
            assert victim not in [h["_id"] for h in again["hits"]["hits"]]
            assert again["hits"]["total"]["value"] == len(docs) - 1
        finally:
            port.close()


def test_search_many_and_concurrent_answers_equal_solo():
    docs, centers, rng = _docs(11, 2000, "dot_product")
    port = _port_node()
    try:
        _load((port,), "v", docs, _mapping("dot_product"))
        svc = port.indices["v"].search
        bodies = [_knn(centers[j % 10] + rng.standard_normal(D), k=6)
                  for j in range(12)]
        reqs = [SearchRequest.from_json(b) for b in bodies]
        solo = [svc.search(r) for r in reqs]
        for got, want in zip(svc.search_many(reqs), solo):
            assert [h.doc_id for h in got.hits] == [h.doc_id for h in want.hits]
            assert np.array_equal(
                np.float32([h.score for h in got.hits]).view(np.int32),
                np.float32([h.score for h in want.hits]).view(np.int32))
            assert got.total == want.total
        seq = [port.search("v", b) for b in bodies]
        outs = [None] * len(bodies)

        def client(c):
            for i in range(c, len(bodies), 4):
                outs[i] = port.search("v", bodies[i])

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for a, b in zip(outs, seq):
            assert {k: v for k, v in a.items() if k != "took"} == {
                k: v for k, v in b.items() if k != "took"}
        assert port.exec_batcher.stats()["requests"] >= len(bodies)
    finally:
        port.close()


def test_refresh_prunes_and_index_delete_clears_planes():
    docs, _centers, _rng = _docs(12, 700, "cosine")
    port = _port_node()
    try:
        _load((port,), "v", docs, _mapping())
        port.search("v", _knn(np.ones(D)))
        assert port.ann_cache.stats()["planes"] == 1
        port.index_doc("v", {"vec": [1.0] * D}, "extra", refresh=True)
        port.search("v", _knn(np.ones(D)))
        assert port.ann_cache.stats()["planes"] == 1  # the new segment is small
        assert port.delete_index("v") == {"acknowledged": True}
        assert port.ann_cache.stats()["planes"] == 0
    finally:
        port.close()


def test_ann_cache_off_serves_exact_brute_force():
    docs, centers, rng = _docs(13, 900, "cosine")
    port = _port_node(ann_cache=False)
    try:
        assert port.ann_cache is None
        _load((port,), "v", docs, _mapping())
        q = centers[0] + rng.standard_normal(D)
        out = port.search("v", _knn(q, k=5))
        oracle = _oracle(docs, q, "cosine")
        want = sorted(oracle, key=lambda d: (-oracle[d], int(d[1:])))[:5]
        assert [h["_id"] for h in out["hits"]["hits"]] == want
    finally:
        port.close()


def test_vector_only_segment_builds_packs_and_serves():
    """Documents with no text field (BASELINE config 5's shape)."""
    port, ref = _port_node(), _jax_node()
    try:
        body = {"mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 3}}}}
        docs = {f"d{i}": {"vec": [float(i % 7) + 1, 1.0, float(i % 3)]}
                for i in range(40)}
        _load((port, ref), "v", docs, body)
        seg = port.indices["v"].engine.segments[0]
        assert seg.segment.fields == {} and seg.device.vectors["vec"].shape == (40, 3)
        q = [2.0, 1.0, 0.5]
        ranked_close(port.search("v", _knn(q, k=4)), ref.search("v", _knn(q, k=4)),
                     _oracle(docs, q, "cosine"))
    finally:
        _close(port, ref)


# ---------------------------------------------------------------------------
# script_score vector functions (BASELINE config 5) against the JAX node
# ---------------------------------------------------------------------------


SCRIPTS = [
    "cosineSimilarity(params.qv, 'vec') + 1.0",
    "dotProduct(params.qv, 'vec')",
    "1 / (1 + l2norm(params.qv, 'vec'))",
    "cosineSimilarity(params['qv'], 'vec') * doc['pop'].value + _score",
]


@pytest.mark.parametrize("shards", [1, 2])
def test_script_vector_functions_match_reference(shards):
    docs, centers, rng = _docs(14, 1500, "cosine", vectorless_every=11)
    port, ref = _port_node(), _jax_node()
    try:
        _load((port, ref), "v", docs, _mapping("cosine", shards))
        for j, source in enumerate(SCRIPTS):
            q = (centers[j] + rng.standard_normal(D)).tolist()
            inner = {"match_all": {}} if j < 3 else {"match": {"body": "w3 w4"}}
            body = {"query": {"script_score": {
                "query": inner,
                "script": {"source": source, "params": {"qv": q}}}},
                "size": 10, "_source": False}
            p, r = port.search("v", body), ref.search("v", body)
            qv = np.asarray(q, np.float32).astype(np.float64)
            oracle = {}
            for doc_id, doc in docs.items():
                v = np.asarray(doc.get("vec", [0.0] * D), np.float32).astype(np.float64)
                nv, nq = np.linalg.norm(v), np.linalg.norm(qv)
                cos = v @ qv / (nv * nq) if nv * nq > 0 else 0.0
                oracle[doc_id] = [cos + 1, v @ qv, 1 / (1 + np.linalg.norm(v - qv)),
                                  None][j]
            if j == 3:  # score mixes BM25 and pop: compare by position only
                assert p["hits"]["total"] == r["hits"]["total"]
                assert [h["_id"] for h in p["hits"]["hits"]] == [
                    h["_id"] for h in r["hits"]["hits"]]
                np.testing.assert_allclose(
                    [h["_score"] for h in p["hits"]["hits"]],
                    [h["_score"] for h in r["hits"]["hits"]], rtol=TOL, atol=TOL)
            else:
                ranked_close(p, r, oracle)
    finally:
        _close(port, ref)


def test_script_score_never_routes_to_ann():
    """Exact kNN through script_score is identical with the ANN cache on,
    off, and after IVF planes exist for the field; the planner decides no
    ann_ivf for it."""
    docs, centers, rng = _docs(15, 1200, "cosine")
    q = (centers[0] + rng.standard_normal(D)).tolist()
    body = {"query": {"script_score": {"query": {"match_all": {}}, "script": {
        "source": "cosineSimilarity(params.qv, 'vec') + 1.0",
        "params": {"qv": q}}}}, "size": 10}
    outs = []
    for cache in (AnnCache(min_docs=MIN_DOCS), False):
        port = Node(device="cpu", ann_cache=cache)
        try:
            _load((port,), "v", docs, _mapping())
            outs.append(port.search("v", body))
            if port.ann_cache is not None:
                port.search("v", _knn(q))
                assert port.ann_cache.stats()["planes"] == 1
                outs.append(port.search("v", body))
            assert port.exec_planner.decisions.get("ann_ivf", 0) <= 1
        finally:
            port.close()
    strip = lambda o: {k: v for k, v in o.items() if k != "took"}
    assert strip(outs[0]) == strip(outs[1]) == strip(outs[2])


def test_script_vector_errors():
    """An unknown vector field is the reference's 400 reason; a query
    vector of the wrong length is a 400 in the port (the reference's
    matmul raises a TypeError there, which its REST layer does not turn
    into a 400)."""
    docs, _c, _r = _docs(16, 50, "cosine")
    port, ref = _port_node(), _jax_node()
    prest, rrest = RestServer(port), JaxRest(node=ref)

    def body(source, qv):
        return json.dumps({"query": {"script_score": {
            "query": {"match_all": {}},
            "script": {"source": source, "params": {"qv": qv}}}}})

    try:
        _load((port, ref), "v", docs, _mapping())
        unknown = body("cosineSimilarity(params.qv, 'nope') + 1", [1.0] * D)
        (ps, pb), (rs, rb) = (x.dispatch("POST", "/v/_search", {}, unknown)
                              for x in (prest, rrest))
        assert ps == rs == 400
        assert pb["error"]["reason"] == rb["error"]["reason"]
        assert "no dense_vector field [nope]" in pb["error"]["reason"]
        short = body("dotProduct(params.qv, 'vec')", [1.0] * (D - 1))
        ps, pb = prest.dispatch("POST", "/v/_search", {}, short)
        assert ps == 400
        assert "different number of dimensions [11]" in pb["error"]["reason"]
        with pytest.raises(TypeError):
            rrest.dispatch("POST", "/v/_search", {}, short)
    finally:
        _close(port, ref)


# ---------------------------------------------------------------------------
# Mapping, ingest and request validation: the reference's 400s
# ---------------------------------------------------------------------------


def _both(fn):
    """fn(node, ApiError) on a port and a JAX node: (status, reason) each."""
    from elasticsearch_tpu.node import ApiError as JaxApiError
    from elasticsearch_tpu_torch.node import ApiError

    port, ref = _port_node(), _jax_node()
    out = []
    try:
        for node, err in ((port, ApiError), (ref, JaxApiError)):
            try:
                fn(node)
                out.append((200, None))
            except err as e:
                out.append((e.status, e.reason))
    finally:
        _close(port, ref)
    return out


MAPPING_CASES = [
    {"vec": {"type": "dense_vector"}},
    {"vec": {"type": "dense_vector", "dims": 5000}},
    {"vec": {"type": "dense_vector", "dims": 4, "similarity": "euclid"}},
]


@pytest.mark.parametrize("case", range(len(MAPPING_CASES)))
def test_mapping_checks_match_reference(case):
    props = MAPPING_CASES[case]
    p, r = _both(lambda n: n.create_index("v", {"mappings": {"properties": props}}))
    assert p[0] == r[0] == 400 and p[1] == r[1]


@pytest.mark.parametrize("bad", [
    {"type": "dense_vector", "dims": 8},
    {"type": "dense_vector", "dims": 4, "similarity": "l2_norm"},
    {"type": "keyword"},
])
def test_dense_vector_params_are_immutable(bad):
    def fn(n):
        n.create_index("v", {"mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 4}}}})
        n.put_mapping("v", {"properties": {"vec": bad}})

    p, r = _both(fn)
    assert p == r and p[0] == 400


INGEST_CASES = [
    [1.0, 2.0],  # dims
    [[1.0, 2.0, 3.0]],  # rank 2
    ["a", "b", "c"],  # strings
    {"x": 1},  # object
    [1.0, float("nan"), 2.0],  # NaN
    [0.0, 0.0, 0.0],  # zero magnitude under cosine
]


@pytest.mark.parametrize("case", range(len(INGEST_CASES)))
def test_ingest_400s_match_reference(case):
    def fn(n):
        n.create_index("v", {"mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 3}, "body": {"type": "text"}}}})
        n.index_doc("v", {"vec": INGEST_CASES[case], "body": "x"}, "a")

    p, r = _both(fn)
    assert p[0] == r[0] == 400
    assert p[1] == r[1]


def test_zero_vector_accepted_for_l2_and_bulk_keeps_good_docs():
    def run(n):
        n.create_index("v", {"mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 3, "similarity": "l2_norm"}}}})
        n.index_doc("v", {"vec": [0.0, 0.0, 0.0]}, "z")
        lines = [json.dumps({"index": {"_id": "g1"}}), json.dumps({"vec": [1, 2, 3]}),
                 json.dumps({"index": {"_id": "bad"}}), json.dumps({"vec": [1, 2]}),
                 json.dumps({"index": {"_id": "g2"}}), json.dumps({"vec": [4, 5, 6]})]
        out = n.bulk("\n".join(lines) + "\n", default_index="v")
        n.refresh("v")
        return ([item["index"]["status"] for item in out["items"]],
                out["items"][1]["index"]["error"]["reason"],
                n.search("v", {"size": 0})["hits"]["total"]["value"])

    port, ref = _port_node(), _jax_node()
    try:
        got = run(port)
        assert got == run(ref)
        assert got[0] == [201, 400, 201] and got[2] == 3
    finally:
        _close(port, ref)


KNN_REQUEST_CASES = [
    {"knn": {"field": "nope", "query_vector": [1.0, 2.0, 3.0]}},
    {"knn": {"field": "body", "query_vector": [1.0, 2.0, 3.0]}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0]}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0], "k": 0}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0], "k": 20,
             "num_candidates": 10}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0],
             "num_candidates": 20_000}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0], "nprobe": 0}},
    {"knn": {"field": "vec", "query_vector": []}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0], "boost": 2}},
    {"knn": {"query_vector": [1.0, 2.0, 3.0]}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0]},
     "query": {"match_all": {}}},
    {"knn": {"field": "vec", "query_vector": [1.0, 2.0, 3.0]},
     "sort": [{"pop": "asc"}]},
]


@pytest.mark.parametrize("case", range(len(KNN_REQUEST_CASES)))
def test_knn_request_400s_match_reference(case):
    def fn(n):
        n.create_index("v", {"mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 3}, "body": {"type": "text"},
            "pop": {"type": "float"}}}})
        n.index_doc("v", {"vec": [1.0, 2.0, 3.0], "body": "a", "pop": 1.0}, "a")
        n.refresh("v")
        n.search("v", KNN_REQUEST_CASES[case])

    p, r = _both(fn)
    assert p[0] == r[0] == 400
    assert p[1] == r[1]
