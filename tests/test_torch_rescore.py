"""Port rescore against the JAX package.

- the fused `execute_rescore` (row 10: the window from K1-K4, the rescore
  plane, K5's fused gather, combine and top-k) against the JAX package's
  on identical planes and plans, for windows smaller than k, larger than
  the match count and in between, and against a numpy two-phase oracle
  (bench.py's BASELINE config 4 oracle);
- the node's `rescore` (K5's gather through `scores_at`, the host
  combine) against the JAX node's, for every `score_mode`, weights,
  stacked stages, and 1 and 3 shards; a rescore request does not ride
  the micro-batcher;
- the plain versions of K5 against a per-row Python loop.

Tolerances, stated per test: EXACT is ids, order, totals and fp32 bits
equal (compared as int32). ULPS (a rescore query that is a script, held
to the JAX package, whose XLA contracts the script's multiply-adds into
FMAs) is bench.py's `ranked_match` rule with ulps = 4, this file's own
copy: the same doc set, scores within 4 ulps, reordering only among
near-ties. A script held to numpy is EXACT.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine
from elasticsearch_tpu.index.mapping import Mappings
from elasticsearch_tpu.node import ApiError as JaxApiError
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.ops.bm25 import search_field
from elasticsearch_tpu.query.dsl import parse_query
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.node import ApiError, Node
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.ops import kernels as K
from elasticsearch_tpu_torch.search.service import SearchRequest

torch.set_num_threads(1)

JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}
CFG4 = ("params.w0 * _score + params.w1 * doc['f1'].value"
        " + params.w2 * doc['f2'].value")
CFG4_PARAMS = {"w0": 0.3, "w1": 4.0, "w2": 2.0}
VOCAB = [f"w{i}" for i in range(22)]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def ulp_close(a, b, ulps: int = 4) -> bool:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return False
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return bool(np.all(np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol))


def ranked_match(ids, scores, o_ids, o_scores, ulps: int = 4) -> bool:
    n = len(o_ids)
    ids = [int(x) for x in ids[:n]]
    if sorted(ids) != sorted(int(x) for x in o_ids):
        return False
    if not ulp_close(np.asarray(scores)[:n], o_scores, ulps):
        return False
    by_id = {int(i): np.float32(s) for i, s in zip(o_ids, o_scores)}
    return all(
        did == int(o_ids[rank])
        or ulp_close(by_id[did], np.float32(o_scores[rank]), ulps)
        for rank, did in enumerate(ids)
    )


def _same(port_out, jax_out):
    for p, j in zip(port_out, jax_out):
        p = np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
        j = np.asarray(j)
        assert p.shape == j.shape, (p.shape, j.shape)
        if j.dtype == np.float32:
            assert np.array_equal(_bits(p), _bits(j)), (p[:8], j[:8])
        else:
            assert np.array_equal(p, j), (p[:8], j[:8])


# ---------------------------------------------------------------------------
# execute_rescore on identical planes and plans
# ---------------------------------------------------------------------------


def _port_tree(handle):
    tree = jbd.segment_tree(handle.device)
    planes = {
        "fields": {n: tuple(np.asarray(x) for x in leaves)
                   for n, leaves in tree["fields"].items()},
        "doc_values": {n: np.asarray(c) for n, c in tree["doc_values"].items()},
        "live": np.asarray(tree["live"]),
    }
    meta = {n: field_meta(f) for n, f in handle.device.fields.items()}
    return tbd.segment_tree(device_segment_from_numpy(planes, meta, device="cpu"))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(99)
    eng = Engine(Mappings(properties={
        "body": {"type": "text"}, "f1": {"type": "float"},
        "f2": {"type": "float"},
    }))
    f1 = rng.random(400, dtype=np.float32)
    f2 = rng.random(400, dtype=np.float32)
    for i in range(400):
        eng.index({"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 10)))),
                   "f1": float(f1[i]), "f2": float(f2[i])}, f"d{i}")
    eng.refresh()
    handle = eng.segments[0]
    return eng, handle, jbd.segment_tree(handle.device), _port_tree(handle)


def _compiled(corpus, body):
    eng, handle, _j, _p = corpus
    c = eng.compiler_for(handle).compile(parse_query(body))
    return c.spec, c.arrays, tbd.plan_to_torch(c.spec, c.arrays, "cpu")


RESCORE_QUERIES = {
    "cfg4": {"script_score": {"query": {"match_all": {}},
                              "script": {"source": CFG4, "params": CFG4_PARAMS}}},
    "match": {"match": {"body": "w3 w4"}},
    "script_min": {"script_score": {"query": {"match": {"body": "w5 w6 w7"}},
                                    "script": {"source": "_score * 2 + doc['f1'].value"},
                                    "min_score": 1.5}},
}
FIRST = {
    "sparse": {"match": {"body": "w1 w2 w3 w8"}},
    "dense": {"bool": {"should": [{"match": {"body": "w1"}},
                                  {"match": {"body": "w9 w10"}}]}},
}


@pytest.mark.parametrize("first", sorted(FIRST))
@pytest.mark.parametrize("rname", sorted(RESCORE_QUERIES))
@pytest.mark.parametrize("window", [5, 64, 1000])
def test_execute_rescore_matches_reference(corpus, first, rname, window):
    """EXACT totals; ULPS scores and ids when the rescore query is a script
    (EXACT otherwise)."""
    _e, _h, jtree, ptree = corpus
    spec, arrays, plan = _compiled(corpus, FIRST[first])
    rspec, rarrays, rplan = _compiled(corpus, RESCORE_QUERIES[rname])
    for qw, rw in ((1.0, 1.0), (0.5, 2.0)):
        got = tbd.execute_rescore(ptree, spec, plan, rspec, rplan, 10, window, qw, rw)
        want = jbd.execute_rescore(jtree, spec, arrays, rspec, rarrays, 10, window,
                                   np.float32(qw), np.float32(rw))
        assert int(got[2]) == int(want[2])
        if rname == "match":
            _same(got, want)
        else:
            n = min(10, int(want[2]))
            assert ranked_match(got[1].numpy()[:n], got[0].numpy()[:n],
                                np.asarray(want[1])[:n], np.asarray(want[0])[:n])
            assert got[0].shape == np.asarray(want[0]).shape


@pytest.mark.parametrize("window", [5, 40, 1000])
def test_execute_rescore_matches_the_numpy_oracle(corpus, window):
    """EXACT against bench.py's cfg4 two-phase oracle: the BM25 top window
    by the numpy scorer, the script's products and sums in numpy fp32,
    then a stable order by the combined score."""
    eng, handle, _jtree, ptree = corpus
    terms = ["w1", "w2", "w3", "w8"]
    spec, _arrays, plan = _compiled(corpus, {"match": {"body": " ".join(terms)}})
    rspec, _ra, rplan = _compiled(corpus, RESCORE_QUERIES["cfg4"])
    s, i, t = tbd.execute_rescore(ptree, spec, plan, rspec, rplan, 10, window, 1.0, 1.0)
    seg = handle.segment
    f1 = seg.doc_values["f1"].astype(np.float32)
    f2 = seg.doc_values["f2"].astype(np.float32)
    o_scores, o_ids = search_field(seg.fields["body"], terms, seg.num_docs, window)
    w0, w1, w2 = (np.float32(CFG4_PARAMS[k]) for k in ("w0", "w1", "w2"))
    rs = (w0 * np.float32(1.0) + w1 * f1[o_ids] + w2 * f2[o_ids]).astype(np.float32)
    comb = (np.float32(1.0) * o_scores + np.float32(1.0) * rs).astype(np.float32)
    order = np.argsort(-comb, kind="stable")[:10]
    n = len(order)
    assert np.array_equal(i.numpy()[:n], np.asarray(o_ids)[order])
    assert np.array_equal(_bits(s.numpy()[:n]), _bits(comb[order]))


# ---------------------------------------------------------------------------
# K5's plain versions against a per-row Python loop
# ---------------------------------------------------------------------------


def _total_order(v):
    b = int(np.float32(v).view(np.uint32))
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else (b | 0x80000000)


def test_k5_plain_rows_match_a_python_loop():
    rng = np.random.default_rng(4)
    q, n, w, k = 3, 500, 48, 12
    planes = rng.random((q, n), dtype=np.float32)
    elig = rng.random((q, n)) < 0.6
    ids = rng.integers(0, n, (q, w)).astype(np.int32)
    s = np.sort(rng.random((q, w), dtype=np.float32), axis=1)[:, ::-1].copy()
    s[:, 40:] = -np.inf
    s[1, 3] = s[1, 4]  # a tie in the window
    gs, gm = K.window_gather_batch(torch.from_numpy(planes), torch.from_numpy(elig),
                                   torch.from_numpy(ids))
    ts, ti = K.window_rescore_batch(torch.from_numpy(s), torch.from_numpy(ids),
                                    torch.from_numpy(planes), torch.from_numpy(elig),
                                    0.5, 2.0, k)
    qw, rw = np.float32(0.5), np.float32(2.0)
    for r in range(q):
        rows = []
        for j in range(w):
            d = int(ids[r, j])
            e = bool(elig[r, d])
            rs = planes[r, d] if e else np.float32(0.0)
            assert gs[r, j].item() == rs and gm[r, j].item() == e
            a = np.float32(qw * s[r, j])
            comb = np.float32(a + np.float32(rw * rs)) if e else a
            if not s[r, j] > -np.inf:
                comb = np.float32(-np.inf)
            rows.append((_total_order(comb), -j, comb, d))
        top = sorted(rows, reverse=True)[:k]
        assert np.array_equal(_bits(ts[r].numpy()), _bits([t[2] for t in top]))
        assert ti[r].tolist() == [t[3] for t in top]


def test_k5_refuses_a_window_above_its_shared_memory():
    s = torch.zeros((1, K.WINDOW_MAX + 1), dtype=torch.float32)
    ids = torch.zeros((1, K.WINDOW_MAX + 1), dtype=torch.int32)
    plane = torch.zeros((1, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="exceeds the kernel's window"):
        K.window_rescore_batch(s, ids, plane, plane > 0, 1.0, 1.0, 10)


# ---------------------------------------------------------------------------
# The nodes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request):
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
    port = Node(device="cpu")
    rng = np.random.default_rng(7)
    lines = []
    for i in range(260):
        doc = {"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 10)))),
               "f1": float(rng.random()), "f2": float(rng.random())}
        lines += [json.dumps({"index": {"_id": f"d{i}"}}), json.dumps(doc)]
    body = {"settings": {"index": {"number_of_shards": request.param}},
            "mappings": {"properties": {"body": {"type": "text"},
                                        "f1": {"type": "float"},
                                        "f2": {"type": "float"}}}}
    for n in (port, ref):
        n.create_index("rescored", body)
        n.bulk("\n".join(lines) + "\n", default_index="rescored", refresh=True)
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def _view(out):
    hits = out["hits"]
    return {
        "total": hits.get("total"),
        "max_score": None if hits["max_score"] is None else
        np.float32(hits["max_score"]).view(np.int32).item(),
        "hits": [(h["_id"], np.float32(h["_score"]).view(np.int32).item(),
                  h.get("sort")) for h in hits["hits"]],
    }


def _rescore(rq, window=20, mode="total", qw=1.0, rw=1.0):
    return {"window_size": window, "query": {
        "rescore_query": rq, "query_weight": qw, "rescore_query_weight": rw,
        "score_mode": mode}}


MATCH_RQ = {"match": {"body": "w2 w5"}}


@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_rescore_score_modes_match_reference(nodes, mode):
    """EXACT (a BM25 rescore query)."""
    port, ref = nodes
    body = {"query": {"match": {"body": "w1 w2 w3"}}, "size": 15,
            "rescore": _rescore(MATCH_RQ, 30, mode, 0.7, 1.3)}
    assert _view(port.search("rescored", body)) == _view(ref.search("rescored", body))


@pytest.mark.parametrize("body", [
    # window smaller than k, larger than the match count, from + size
    {"query": {"match": {"body": "w4"}}, "size": 10, "rescore": _rescore(MATCH_RQ, 3)},
    {"query": {"match": {"body": "w4 w11"}}, "size": 10,
     "rescore": _rescore(MATCH_RQ, 5000)},
    {"query": {"match": {"body": "w1 w6"}}, "from": 4, "size": 6,
     "rescore": _rescore({"match_all": {"boost": 2.0}}, 8)},
    # two stages
    {"query": {"match": {"body": "w1 w2"}}, "size": 10,
     "rescore": [_rescore(MATCH_RQ, 25), _rescore({"match": {"body": "w7"}}, 6,
                                                  "max")]},
    {"query": {"match_all": {}}, "size": 5, "track_total_hits": False,
     "rescore": _rescore({"range": {"f1": {"gte": 0.5}}}, 50, "multiply")},
])
def test_rescore_windows_and_stages_match_reference(nodes, body):
    """EXACT."""
    port, ref = nodes
    assert _view(port.search("rescored", body)) == _view(ref.search("rescored", body))


def test_script_rescore_matches_reference(nodes):
    """ULPS: BASELINE config 4's script rescore over REST."""
    port, ref = nodes
    rq = {"script_score": {"query": {"match_all": {}},
                           "script": {"source": CFG4, "params": CFG4_PARAMS}}}
    body = {"query": {"match": {"body": "w1 w2 w3 w8"}}, "size": 10,
            "rescore": _rescore(rq, 100)}
    p, r = port.search("rescored", body), ref.search("rescored", body)
    assert p["hits"]["total"] == r["hits"]["total"]
    assert ranked_match([h["_id"][1:] for h in p["hits"]["hits"]],
                        [h["_score"] for h in p["hits"]["hits"]],
                        [h["_id"][1:] for h in r["hits"]["hits"]],
                        [h["_score"] for h in r["hits"]["hits"]])


def test_rescore_errors_match_reference(nodes):
    """EXACT status and reason."""
    port, ref = nodes
    for body in (
        {"rescore": _rescore(MATCH_RQ, 10, "median")},
        {"rescore": _rescore(MATCH_RQ), "search_after": [1], "sort": ["_score"]},
        {"rescore": _rescore(MATCH_RQ), "search_after": [1]},
    ):
        with pytest.raises(ApiError) as p:
            port.search("rescored", body)
        with pytest.raises(JaxApiError) as r:
            ref.search("rescored", body)
        assert (p.value.status, p.value.reason) == (r.value.status, r.value.reason)


def test_rescore_without_a_rescore_query_is_a_400(nodes):
    """A stage with no rescore_query is a parsing 400 on the port (the
    reference lets the KeyError through)."""
    port, _ref = nodes
    with pytest.raises(ApiError) as p:
        port.search("rescored", {"rescore": {"window_size": 10, "query": {}}})
    assert (p.value.status, p.value.err_type) == (400, "parsing_exception")


def test_rescore_requests_take_the_solo_path(nodes):
    port, _ref = nodes
    request = SearchRequest.from_json({"rescore": _rescore(MATCH_RQ)})
    assert not port._batchable(request)
    before = port.exec_batcher.stats()["requests"]
    port.search("rescored", {"query": {"match": {"body": "w1"}},
                             "rescore": _rescore(MATCH_RQ)})
    assert port.exec_batcher.stats()["requests"] == before
