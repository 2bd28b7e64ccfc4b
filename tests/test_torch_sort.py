"""Port field sorts, `{"_score": "asc"}` and search_after cursors against
the JAX package.

- K3k (keyed_topk, the keyed mode of K3) against `jax.lax.top_k` over the
  masked key the reference composes, with NaN, +/-0.0, +/-inf and ties;
  its plain version against an independent per-row Python sort;
- the device programs `execute_sorted`, `execute_sorted_after`,
  `execute_score_asc`, `execute_score_after` (asc and desc),
  `execute_dense` and `scores_at` against the JAX package's on identical
  planes and plans (device_segment_from_numpy, plan_to_torch): ties,
  missing first and last, key-only and missing-region cursors, signed
  zeros, NaN scores and k above the eligible count;
- the port's node against the JAX node over REST bodies: field,
  multi-key and `_score` sorts and search_after walks on 1 and 3 shards,
  and the validation 400s.

Tolerance: EXACT throughout — ids, order, totals, n_after, `sort` values
and fp32 bits (compared as int32; the scores here come out of no
script), and error statuses and reasons.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine
from elasticsearch_tpu.index.mapping import Mappings
from elasticsearch_tpu.node import ApiError as JaxApiError
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.dsl import parse_query
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.node import ApiError, Node
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.ops import kernels as K
from elasticsearch_tpu_torch.search.service import SearchRequest

torch.set_num_threads(1)

F32_MAX = np.float32(np.finfo(np.float32).max)
JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _same(port_out, jax_out):
    """EXACT: every output equal; fp32 outputs bit for bit."""
    assert len(port_out) == len(jax_out)
    for p, j in zip(port_out, jax_out):
        p = np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
        j = np.asarray(j)
        assert p.shape == j.shape, (p.shape, j.shape)
        if j.dtype == np.float32:
            assert np.array_equal(_bits(p), _bits(j)), (p[:8], j[:8])
        else:
            assert np.array_equal(p, j), (p[:8], j[:8])


# ---------------------------------------------------------------------------
# K3k against lax.top_k, and its plain version against a Python sort
# ---------------------------------------------------------------------------

SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0],
                    dtype=np.float32)


def _keys(seed, m, kind):
    rng = np.random.default_rng(seed)
    if kind == "special":
        key = rng.choice(SPECIALS, m)
    elif kind == "ties":
        key = rng.integers(0, 4, m).astype(np.float32)
    else:
        key = rng.standard_normal(m).astype(np.float32)
    return key, rng.random(m) < 0.6


def _jax_keyed(key, elig, k, mode, desc, mf, cursor):
    """The reference's composition of each sorted/cursor program's masked
    top-k over a raw key plane, on jax. The bottom-k's `-masked` keeps a
    NaN's sign, as the reference's jitted programs serve it (XLA folds the
    negation into the script's `* boost`; test_torch_script.py holds that
    against the served answers)."""
    key = jnp.asarray(key)
    elig = jnp.asarray(elig)
    m = key.shape[0]
    if mode == K.KEYED_FIELD:
        col = key
        k0 = -col if desc else col
        key = jnp.where(jnp.isnan(k0), -F32_MAX if mf else F32_MAX, k0)
    keep = elig
    if cursor is not None:
        ak, ad = jnp.float32(cursor[0]), jnp.int32(cursor[1])
        iota = jnp.arange(m, dtype=jnp.int32)
        past = key < ak if mode == K.KEYED_SCORE_DESC else key > ak
        keep = elig & (past | ((key == ak) & (iota > ad)))
    if mode == K.KEYED_SCORE_DESC:
        masked = jnp.where(keep, key, jnp.float32(-jnp.inf))
        vals, ids = jax.lax.top_k(masked, min(k, m))
    else:
        masked = jnp.where(keep, key, jnp.float32(jnp.inf))
        seen = jnp.where(jnp.isnan(masked), masked, -masked)
        neg, ids = jax.lax.top_k(seen, min(k, m))
        vals = col[ids] if mode == K.KEYED_FIELD else -neg
    return (vals, ids.astype(jnp.int32), jnp.sum(elig, dtype=jnp.int32),
            jnp.sum(keep, dtype=jnp.int32))


KEYED_CASES = [
    # (seed, m, k, kind, mode, desc, missing_first, cursor)
    (0, 400, 10, "special", K.KEYED_FIELD, False, False, None),
    (1, 400, 400, "special", K.KEYED_FIELD, True, True, None),
    (2, 400, 50, "special", K.KEYED_FIELD, False, True, (F32_MAX * -1, 120)),
    (3, 400, 50, "special", K.KEYED_FIELD, True, False, (0.0, 200)),
    (4, 300, 1000, "ties", K.KEYED_FIELD, False, False, (1.0, 300)),
    (5, 400, 400, "special", K.KEYED_SCORE_ASC, False, False, None),
    (6, 400, 30, "special", K.KEYED_SCORE_ASC, False, False, (-0.0, 17)),
    (7, 400, 400, "special", K.KEYED_SCORE_DESC, False, False, (1.0, 400)),
    (8, 3000, 2500, "ties", K.KEYED_SCORE_DESC, False, False, (2.0, 1500)),
    (9, 5000, 20, "normal", K.KEYED_SCORE_ASC, False, False, (0.5, 5000)),
]


@pytest.mark.parametrize("case", KEYED_CASES)
def test_k3k_matches_lax_top_k(case):
    seed, m, k, kind, mode, desc, mf, cursor = case
    key, elig = _keys(seed, m, kind)
    want = _jax_keyed(key, elig, k, mode, desc, mf, cursor)
    got = K.keyed_topk(
        torch.from_numpy(key), torch.from_numpy(elig), k, mode, desc, mf,
        *(cursor if cursor is not None else (None, None)),
    )
    _same(got, want)


def _py_keyed(key, elig, k, mode, desc, mf, cursor):
    """K3k's contract one doc at a time in Python: (seen value, index)
    sorted by IEEE total order descending, then index ascending; the
    bottom-k's negation keeps a NaN's sign and its output flips it."""

    def order_bits(v):
        b = int(np.float32(v).view(np.uint32))
        return (~b & 0xFFFFFFFF) if b & 0x80000000 else (b | 0x80000000)

    rows = []
    for i in range(len(key)):
        raw = np.float32(key[i])
        kv = raw
        if mode == K.KEYED_FIELD:
            kv = -raw if desc else raw
            if np.isnan(kv):
                kv = -F32_MAX if mf else F32_MAX
        keep = bool(elig[i])
        if cursor is not None:
            ak = np.float32(cursor[0])
            past = kv < ak if mode == K.KEYED_SCORE_DESC else kv > ak
            keep = keep and (past or (kv == ak and i > cursor[1]))
        neg = mode != K.KEYED_SCORE_DESC
        masked = kv if keep else np.float32(np.inf if neg else -np.inf)
        seen = -masked if neg and not np.isnan(masked) else masked
        out = masked
        if mode == K.KEYED_FIELD:
            out = raw
        elif neg and np.isnan(masked):
            out = -masked
        rows.append((order_bits(seen), -i, out, keep))
    top = sorted(rows, reverse=True)[: min(k, len(key))]
    vals = np.array([r[2] for r in top], dtype=np.float32)
    ids = np.array([-r[1] for r in top], dtype=np.int32)
    return vals, ids, int(elig.sum()), sum(r[3] for r in rows)


@pytest.mark.parametrize("case", [c for c in KEYED_CASES if c[1] <= 400])
def test_k3k_plain_rows_match_a_python_loop(case):
    """The batched plain K3k over 3 rows (their own key planes and
    cursors) against the per-row Python sort."""
    seed, m, k, _kind, mode, desc, mf, cursor = case
    rows = [_keys(seed + 100 * r, m, "special") for r in range(3)]
    key = torch.from_numpy(np.stack([r[0] for r in rows]))
    elig = torch.from_numpy(np.stack([r[1] for r in rows]))
    cur = (None, None)
    if cursor is not None:
        cur = (torch.tensor([cursor[0], 0.5, -np.inf], dtype=torch.float32),
               torch.tensor([cursor[1], 7, m], dtype=torch.int32))
    got = K.keyed_topk_batch(key, elig, k, mode, desc, mf, *cur)
    for r in range(3):
        c = None if cursor is None else (float(cur[0][r]), int(cur[1][r]))
        want = _py_keyed(rows[r][0], rows[r][1], k, mode, desc, mf, c)
        _same([g[r] for g in got], [want[0], want[1], np.int32(want[2]),
                                     np.int32(want[3])])


def test_k3_orders_signed_zeros_as_lax_top_k():
    """K3 ranks +0.0 above -0.0, as lax.top_k's total order does, when the
    zeros reach the top-k."""
    rng = np.random.default_rng(3)
    key = rng.choice(np.array([-0.0, 0.0, -1.0], np.float32), 2000)
    elig = rng.random(2000) < 0.7
    key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(key), 1500)
    s, i, _t = K.masked_topk(torch.from_numpy(key), torch.from_numpy(elig), 1500)
    _same([s, i], [ref_s, ref_i])


# ---------------------------------------------------------------------------
# The device programs on identical planes and plans
# ---------------------------------------------------------------------------

VOCAB = [f"w{i}" for i in range(20)]


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
    rng = np.random.default_rng(23)
    eng = Engine(Mappings(properties={
        "body": {"type": "text"}, "rank": {"type": "long"},
        "price": {"type": "double"}, "f": {"type": "float"},
    }))
    for i in range(320):
        doc = {"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 8)))),
               "rank": int(rng.integers(0, 6))}
        if i % 4:
            doc["price"] = float(np.round(rng.random() * 20, 1))
        if i % 9 == 0:
            doc["price"] = -0.0 if i % 2 else 0.0
        doc["f"] = float(rng.random() * 2 - 1)
        eng.index(doc, f"d{i}")
    eng.refresh()
    for i in range(0, 320, 13):
        eng.delete(f"d{i}")
    eng.refresh()
    handle = eng.segments[0]
    return eng, handle, jbd.segment_tree(handle.device), _port_tree(handle)


def _plans(corpus, body):
    eng, handle, _j, _p = corpus
    c = eng.compiler_for(handle).compile(parse_query(body))
    return c.spec, c.arrays, tbd.plan_to_torch(c.spec, c.arrays, "cpu")


QUERIES = [
    {"match": {"body": "w1 w2 w3"}},
    {"match_all": {}},
    # every matched doc scores 0.0 (-masked makes -0.0 of each)
    {"constant_score": {"filter": {"match": {"body": "w4 w5"}}, "boost": 0.0}},
    {"bool": {"should": [{"match": {"body": "w6"}}, {"match": {"body": "w7"}}],
              "filter": [{"range": {"rank": {"gte": 2}}}]}},
]


@pytest.mark.parametrize("desc,mf", [(False, False), (True, False), (False, True),
                                     (True, True)])
def test_sort_key_plane_matches_reference(corpus, desc, mf):
    _e, _h, jtree, ptree = corpus
    _same(tbd.sort_key_plane(ptree, "price", desc, mf),
          jbd.sort_key_plane(jtree, "price", desc, mf))


@pytest.mark.parametrize("qi", range(len(QUERIES)))
@pytest.mark.parametrize("field,desc,mf", [
    ("price", False, False), ("price", True, True), ("rank", True, False),
    ("price", False, True),
])
def test_execute_sorted_matches_reference(corpus, qi, field, desc, mf):
    _e, _h, jtree, ptree = corpus
    spec, arrays, plan = _plans(corpus, QUERIES[qi])
    for k in (10, 500):  # 500: above the eligible count and the doc count
        _same(tbd.execute_sorted(ptree, spec, plan, field, desc, k, missing_first=mf),
              jbd.execute_sorted(jtree, spec, arrays, field, desc, k, missing_first=mf))


@pytest.mark.parametrize("field,desc,mf,after_key,after_doc", [
    ("price", False, False, 7.5, 320),  # key-only cursor (after_doc = N)
    ("price", True, False, -7.5, 100),  # key in the negated space
    ("price", False, True, -F32_MAX, 150),  # cursor in the missing region (first)
    ("price", False, False, F32_MAX, 40),  # ... and last
    ("price", False, False, 0.0, 60),  # on the signed zeros
    ("rank", False, False, 3.0, 200),  # ties
])
def test_execute_sorted_after_matches_reference(corpus, field, desc, mf, after_key,
                                                after_doc):
    _e, _h, jtree, ptree = corpus
    for qi in (0, 1):
        spec, arrays, plan = _plans(corpus, QUERIES[qi])
        _same(
            tbd.execute_sorted_after(ptree, spec, plan, field, desc, 25,
                                     after_key, after_doc, missing_first=mf),
            jbd.execute_sorted_after(jtree, spec, arrays, field, desc, 25,
                                     np.float32(after_key), np.int32(after_doc),
                                     missing_first=mf),
        )


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_execute_score_asc_and_dense_match_reference(corpus, qi):
    _e, _h, jtree, ptree = corpus
    spec, arrays, plan = _plans(corpus, QUERIES[qi])
    for k in (10, 400):
        _same(tbd.execute_score_asc(ptree, spec, plan, k),
              jbd.execute_score_asc(jtree, spec, arrays, k))
    _same(tbd.execute_dense(ptree, spec, plan), jbd.execute_dense(jtree, spec, arrays))
    ids = np.concatenate([np.arange(0, 320, 5), [0, 319, 1]]).astype(np.int32)
    _same(tbd.scores_at(ptree, spec, plan, torch.from_numpy(ids)),
          jbd.scores_at(jtree, spec, arrays, ids))


@pytest.mark.parametrize("qi", range(len(QUERIES)))
@pytest.mark.parametrize("ascending", [False, True])
def test_execute_score_after_matches_reference(corpus, qi, ascending):
    _e, _h, jtree, ptree = corpus
    spec, arrays, plan = _plans(corpus, QUERIES[qi])
    top = np.asarray(jbd.execute(jtree, spec, arrays, 40)[0])
    finite = top[np.isfinite(top)]
    cursors = [(float(finite[len(finite) // 2]) if len(finite) else 0.0, 320),
               (0.0, 150)]
    for after, after_doc in cursors:
        _same(
            tbd.execute_score_after(ptree, spec, plan, 30, after, after_doc,
                                    ascending=ascending),
            jbd.execute_score_after(jtree, spec, arrays, 30, np.float32(after),
                                    np.int32(after_doc), ascending=ascending),
        )


def test_nan_scores_sort_as_the_reference_composes_them(corpus):
    """NaN scores (a missing column or a negative operand through a
    script) in bottom-k and both cursors, against the reference's served
    programs themselves (`jbd.execute_score_asc` and
    `jbd.execute_score_after`): +NaN leads a bottom-k and -NaN trails the
    ineligible docs (XLA folds `-masked` into the script's `* boost`, so
    the negation keeps a NaN's sign), the bottom-k's values carry the NaN
    with its sign flipped, and a cursor on a NaN keeps nothing."""
    _e, _h, jtree, ptree = corpus
    for src in (
        "doc['price'].value * 2",  # +NaN for a missing price
        "Math.sqrt(doc['f'].value) + doc['price'].value",  # and -NaN for f < 0
        # -NaN only (log's NaN, and -inf * 0.0); exact values elsewhere
        "Math.log(doc['price'].value) * 0.0 + doc['price'].value",
    ):
        body = {"script_score": {"query": {"match": {"body": "w1 w2"}},
                                 "script": {"source": src}}}
        spec, arrays, plan = _plans(corpus, body)
        scores, elig = (np.asarray(x)
                        for x in jbd.execute_dense(jtree, spec, arrays))
        assert np.isnan(scores[elig]).any()
        _same(tbd.execute_score_asc(ptree, spec, plan, 320),
              jbd.execute_score_asc(jtree, spec, arrays, 320))
        for after, after_doc, asc in ((10.0, 320, False), (-1.0, 320, True),
                                      (np.nan, 40, True), (np.nan, 40, False)):
            _same(tbd.execute_score_after(ptree, spec, plan, 200, after,
                                          after_doc, ascending=asc),
                  jbd.execute_score_after(jtree, spec, arrays, 200,
                                          np.float32(after),
                                          np.int32(after_doc), ascending=asc))


# ---------------------------------------------------------------------------
# The nodes over REST bodies
# ---------------------------------------------------------------------------


def _docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 9)))),
             "rank": int(rng.integers(0, 8))}
        if i % 4:
            d["price"] = float(np.round(rng.random() * 50, 1))
        out.append(d)
    return out


MAPPINGS = {"properties": {
    "body": {"type": "text"}, "rank": {"type": "long"},
    "price": {"type": "double"}, "unused": {"type": "double"},
}}


@pytest.fixture(scope="module", params=[1, 3])
def nodes(request):
    shards = request.param
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
    port = Node(device="cpu")
    body = {"settings": {"index": {"number_of_shards": shards}},
            "mappings": MAPPINGS}
    lines = []
    for i, d in enumerate(_docs(31, 230)):
        lines += [json.dumps({"index": {"_id": f"d{i}"}}), json.dumps(d)]
    for n in (port, ref):
        n.create_index("sorted", body)
        n.bulk("\n".join(lines) + "\n", default_index="sorted", refresh=True)
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def _view(out):
    hits = out["hits"]
    return {
        "total": hits.get("total"),
        "max_score": hits["max_score"],
        "hits": [(h["_id"], None if h["_score"] is None else
                  np.float32(h["_score"]).view(np.int32).item(), h.get("sort"))
                 for h in hits["hits"]],
    }


SORT_BODIES = [
    {"query": {"match": {"body": "w1 w2 w3"}}, "sort": [{"price": "desc"}]},
    {"query": {"match": {"body": "w1 w2 w3"}},
     "sort": [{"price": {"order": "asc", "missing": "_first"}}], "size": 30},
    {"query": {"match_all": {}}, "sort": [{"rank": "asc"}], "from": 5, "size": 12},
    {"query": {"match_all": {}}, "sort": [{"rank": "desc"}, {"price": "asc"}],
     "size": 25},
    {"query": {"match_all": {}}, "sort": [{"rank": "asc"}, {"_doc": "asc"}]},
    {"query": {"match_all": {}},
     "sort": ["rank", {"price": {"order": "desc", "missing": "_first"}}]},
    {"query": {"match": {"body": "w4"}}, "sort": [{"_score": "asc"}]},
    {"query": {"match": {"body": "w4 w5"}}, "sort": ["_score"], "size": 7},
    {"query": {"match": {"body": "w4 w5"}}, "sort": [{"unused": "asc"}]},
    {"query": {"match": {"body": "w6"}}, "sort": [{"price": "asc"}], "size": 0},
]


@pytest.mark.parametrize("bi", range(len(SORT_BODIES)))
def test_sorted_search_matches_reference(nodes, bi):
    port, ref = nodes
    body = SORT_BODIES[bi]
    assert _view(port.search("sorted", body)) == _view(ref.search("sorted", body))


WALKS = [
    ([{"price": "desc"}], {"match": {"body": "w1 w2 w3"}}),
    ([{"price": {"order": "asc", "missing": "_first"}}], {"match_all": {}}),
    ([{"price": {"order": "desc", "missing": "_last"}}], {"match": {"body": "w2 w8"}}),
    ([{"_score": "desc"}], {"match": {"body": "w1 w2 w3"}}),
    ([{"_score": "asc"}], {"match": {"body": "w1 w2 w3"}}),
    ([{"rank": "asc"}], {"match_all": {}}),
]


@pytest.mark.parametrize("wi", range(len(WALKS)))
def test_search_after_walk_matches_reference(nodes, wi):
    """Pages of 7 by each node's own last `sort` value, page for page."""
    port, ref = nodes
    sort, query = WALKS[wi]
    after = None
    for _page in range(6):
        body = {"query": query, "sort": sort, "size": 7}
        if after is not None:
            body["search_after"] = after
        p, r = port.search("sorted", body), ref.search("sorted", body)
        assert _view(p) == _view(r), body
        if not r["hits"]["hits"]:
            break
        after = r["hits"]["hits"][-1]["sort"]


BAD_BODIES = [
    {"sort": [{"price": {"order": "asc", "missing": 0}}]},
    {"sort": [{"price": "asc"}], "rescore": {"query": {"rescore_query": {"match_all": {}}}}},
    {"search_after": [1]},
    {"sort": [{"price": "asc"}], "search_after": [1, 2]},
    {"sort": [{"price": "asc"}], "search_after": 1},
    {"sort": [{"price": "asc"}], "search_after": [1], "from": 3},
    {"sort": [{"_score": "desc"}], "search_after": ["x"]},
    {"sort": [{"body": "asc"}]},
    {"sort": [{"nosuch": "asc"}]},
    {"sort": [{"_doc": "asc"}]},
    {"sort": [{"_doc": "asc"}, {"price": "asc"}]},
    {"sort": [{"_score": "desc"}, {"price": "asc"}]},
    {"sort": [{"price": "asc"}, {"rank": "asc"}], "search_after": [1]},
    {"sort": [{"price": "asc", "rank": "desc"}]},
    # bucket-in-bucket nesting under a terms agg: a parse error in both
    {"aggs": {"x": {"terms": {"field": "rank"},
                    "aggs": {"y": {"terms": {"field": "rank"}}}}}},
]


@pytest.mark.parametrize("bi", range(len(BAD_BODIES)))
def test_validation_400s_match_reference(nodes, bi):
    """Status and reason equal."""
    port, ref = nodes
    body = BAD_BODIES[bi]
    with pytest.raises(ApiError) as p:
        port.search("sorted", body)
    with pytest.raises(JaxApiError) as r:
        ref.search("sorted", body)
    assert (p.value.status, p.value.reason) == (r.value.status, r.value.reason)


def test_sorted_and_cursor_requests_take_the_solo_path(nodes):
    """`_batchable` admits only plain score-sorted requests: a sort or a
    cursor never rides the micro-batcher."""
    port, _ref = nodes
    plain = SearchRequest.from_json({"query": {"match": {"body": "w1"}}})
    assert port._batchable(plain)
    for body in ({"sort": [{"price": "asc"}]}, {"sort": ["_score"]},
                 {"sort": [{"price": "asc"}], "search_after": [3]}):
        assert not port._batchable(SearchRequest.from_json(body))
    before = port.exec_batcher.stats()["requests"]
    port.search("sorted", {"sort": [{"rank": "desc"}], "size": 3})
    assert port.exec_batcher.stats()["requests"] == before
