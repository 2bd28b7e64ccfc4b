"""The port's shard mesh (parallel/sharded.py over parallel/mesh.py)
against the JAX package's shard_map programs on the same documents.

Mirrors tests/test_sharded.py and widens it: `ShardedIndex.search` on 2,
3 and 8 shards over match, bool, phrase, script_score, function_score,
equal-score and NaN-scored plans; `search_batch` on (1 x 8) and (2 x 4)
meshes; `compile_batch_buckets`; `sharded_execute_request` with a field
sort, a search_after cursor, `size: 0` and aggregations; `mesh_combine`
alone; the nested refusal; and `k` above `docs_per_shard`. The JAX side
runs on the eight host devices tests/conftest.py forces; the port's mesh
repeats the CPU device. Tolerance is none: the same global ids in the
same order, fp32 score and sort-key bits (NaN signs included), totals
and aggregation planes.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops.aggs_device import mesh_combine as jax_mesh_combine
from elasticsearch_tpu.parallel import sharded as jsh
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu.search.service import SearchRequest as JaxRequest
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.aggs_device import mesh_combine
from elasticsearch_tpu_torch.parallel import mesh as mesh_ops
from elasticsearch_tpu_torch.parallel import sharded as psh
from elasticsearch_tpu_torch.parallel.mesh import Mesh
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.search.service import SearchRequest

torch.set_num_threads(1)

CPU = torch.device("cpu")
VOCAB = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima",
]
PROPS = {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "rank": {"type": "long"},
    "f": {"type": "float"},
}


def make_docs(n=200, seed=11):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        doc = {
            "body": " ".join(rng.choice(VOCAB, int(rng.integers(3, 30)))),
            "tag": str(rng.choice(["red", "green", "blue"])),
            "rank": int(rng.integers(0, 100)),
        }
        if i % 5:
            doc["f"] = float((i % 7) - 3)
        docs.append((f"doc{i}", doc))
    return docs


DOCS = make_docs()


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def port_mesh(shape, names):
    return Mesh(np.full(shape, CPU, dtype=object), names)


def build(n_shards, docs=DOCS, batch=None):
    """(port index, JAX index) over the same docs, on a 1D shard mesh or a
    2D (batch x shard) mesh."""
    if batch is None:
        shape, names = (n_shards,), ("shard",)
    else:
        shape, names = (batch, n_shards), ("batch", "shard")
    port = psh.ShardedIndex.from_docs(
        docs, Mappings(properties=PROPS), port_mesh(shape, names))
    ref = jsh.ShardedIndex.from_docs(
        docs, JaxMappings(properties=PROPS), jax_mesh(shape, names))
    return port, ref


@pytest.fixture(scope="module", params=[2, 3, 8])
def pair(request):
    return build(request.param)


def bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def same_page(port_out, ref_out):
    (ps, pi, pt), (rs, ri, rt) = port_out, ref_out
    assert pt == rt
    assert np.array_equal(np.asarray(pi), np.asarray(ri))
    assert np.array_equal(bits(ps), bits(rs))


SEARCHES = [
    {"match": {"body": "alpha"}},
    {"match": {"body": "alpha bravo charlie"}},
    {"bool": {"must": [{"match": {"body": "delta"}}],
              "filter": [{"term": {"tag": "red"}}]}},
    {"bool": {"must": [{"match": {"body": "echo foxtrot"}}],
              "must_not": [{"range": {"rank": {"lt": 50}}}]}},
    {"bool": {"should": [{"match": {"body": "golf"}},
                         {"term": {"tag": "blue"}}]}},
    {"match_all": {}},
    {"match_phrase": {"body": "alpha bravo"}},
    {"script_score": {"query": {"match": {"body": "kilo lima"}},
                      "script": {"source": "_score * 2 + doc['rank'].value"}}},
    {"function_score": {"query": {"match": {"body": "hotel"}},
                        "functions": [{"field_value_factor": {
                            "field": "rank", "factor": 1.5,
                            "missing": 1}},
                                      {"filter": {"term": {"tag": "green"}},
                                       "weight": 3}],
                        "score_mode": "sum", "boost_mode": "multiply"}},
    # equal scores across every shard: the (shard, rank) tiebreak
    {"constant_score": {"filter": {"term": {"tag": "red"}}, "boost": 1.5}},
    {"match": {"body": "zzz"}},
]


@pytest.mark.parametrize("query", SEARCHES, ids=lambda q: next(iter(q)))
def test_search_matches_reference(pair, query):
    port, ref = pair
    assert port.docs_per_shard == ref.docs_per_shard
    for k in (10, 37):
        same_page(port.search(parse_query(query), k),
                  ref.search(jax_parse(query), k))


NAN_SCRIPTS = [
    "doc['f'].value",  # +NaN for a missing f
    "Math.sqrt(doc['f'].value)",  # -NaN for f < 0
    "Math.log(doc['f'].value) * 2",
]


@pytest.mark.parametrize("src", NAN_SCRIPTS)
def test_nan_scored_pages_match_reference(pair, src):
    port, ref = pair
    query = {"script_score": {"query": {"range": {"rank": {"gte": 8}}},
                              "script": {"source": src}}}
    p = port.search(parse_query(query), 200)
    r = ref.search(jax_parse(query), 200)
    assert np.isnan(r[0]).any()
    same_page(p, r)


def test_k_above_docs_per_shard():
    """A tiny index: the merge keeps min(k, S * kk) hits, not kk."""
    port, ref = build(8, docs=make_docs(n=20, seed=5))
    assert port.docs_per_shard < 15
    for query in ({"match_all": {}}, {"match": {"body": "alpha bravo"}}):
        same_page(port.search(parse_query(query), 15),
                  ref.search(jax_parse(query), 15))


def test_locate_and_routing(pair):
    port, ref = pair
    for doc_id, _src in DOCS[:20]:
        s = psh.shard_for_id(doc_id, port.n_shards)
        assert doc_id in port.segments[s].ids
    g = port.docs_per_shard * (port.n_shards - 1) + 1
    assert port.locate(g) == ref.locate(g)


BATCH = [
    {"match": {"body": "alpha bravo"}},
    {"match": {"body": "charlie delta"}},
    {"match": {"body": "echo golf"}},
    {"match": {"body": "kilo india"}},
]


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_search_batch_matches_reference(shape):
    batch, n_shards = shape
    port, ref = build(n_shards, batch=batch)
    ps, pi, pt = port.search_batch([parse_query(q) for q in BATCH], 10,
                                   "batch")
    rs, ri, rt = ref.search_batch([jax_parse(q) for q in BATCH], 10, "batch")
    assert np.array_equal(pt.numpy(), np.asarray(rt))
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    assert np.array_equal(bits(ps.numpy()), bits(np.asarray(rs)))
    # The replica rows on one device share each shard's tree.
    assert all(port.tree_on(s, CPU) is port.trees[s] for s in range(n_shards))
    assert not port._replicas


def _plan_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _plan_equal(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _plan_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)


def test_compile_batch_buckets_match_reference(pair):
    port, ref = pair
    queries = BATCH + [
        {"match": {"body": "alpha bravo charlie delta echo"}},
        {"match": {"body": "lima"}},
        {"bool": {"must": [{"match": {"body": "delta"}}],
                  "filter": [{"term": {"tag": "red"}}]}},
    ]
    got = port.compile_batch_buckets([parse_query(q) for q in queries])
    want = ref.compile_batch_buckets([jax_parse(q) for q in queries])
    assert [(c.spec, pos) for c, pos in got] == [
        (c.spec, pos) for c, pos in want
    ]
    for (c, _p), (w, _q) in zip(got, want):
        _plan_equal(c.arrays, w.arrays)


def test_nested_refusal():
    props = {"body": {"type": "text"},
             "qa": {"type": "nested",
                    "properties": {"a": {"type": "text"}}}}
    doc = {"body": "alpha", "qa": [{"a": "bravo"}]}
    for builder, mappings, cls, mesh in (
        (SegmentBuilder, Mappings(properties=props), psh.ShardedIndex,
         port_mesh((2,), ("shard",))),
        (JaxBuilder, JaxMappings(properties=props), jsh.ShardedIndex,
         jax_mesh((2,), ("shard",))),
    ):
        segs = []
        for s in range(2):
            b = builder(mappings)
            b.add(doc, f"d{s}")
            segs.append(b.build())
        with pytest.raises(ValueError, match="nested blocks"):
            cls.from_segments(segs, mappings, mesh)


# ---------------------------------------------------------------------------
# sharded_execute_request, through both nodes' mesh snapshots
# ---------------------------------------------------------------------------

REQ_PROPS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "price": {"type": "long"}, "qty": {"type": "integer"},
}}
REQ_ENV = {"ESTPU_EXEC_PLANNER": "0", "ESTPU_FILTER_CACHE": "0",
           "ESTPU_EXEC_PACKED": "0"}


@pytest.fixture(scope="module")
def snaps():
    """Both nodes' mesh snapshots of one 4-shard index (the JAX node's on
    its forced host devices)."""
    body = {"settings": {"index": {"number_of_shards": 4}},
            "mappings": REQ_PROPS}
    with pytest.MonkeyPatch.context() as mp:
        for key, val in REQ_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        ref.create_index("rq", body)
    port = Node(device="cpu", mesh_devices=[CPU] * 4)
    port.create_index("rq", body)
    rng = np.random.default_rng(1234)
    lines = []
    for i in range(180):
        doc = {"body": " ".join(rng.choice(VOCAB[:6], int(rng.integers(2, 7)))),
               "tag": str(rng.choice(["x", "y", "z"])),
               "qty": int(rng.integers(0, 4))}
        if rng.random() > 0.15:
            doc["price"] = int(rng.integers(0, 40))
        lines += [json.dumps({"index": {"_id": f"d{i}"}}), json.dumps(doc)]
    for n in (port, ref):
        n.bulk("\n".join(lines) + "\n", default_index="rq", refresh=True)
    out = []
    for n in (port, ref):
        svc = n.get_index("rq")
        mv = svc.search.mesh_view
        out.append((svc.search, mv, mv._ensure()))
    yield out
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


def _run_request(side, body, **kw):
    coord, mv, snap = side
    is_port = isinstance(mv.mesh, Mesh)
    req = (SearchRequest if is_port else JaxRequest).from_json(body)
    idx = snap.index
    compiled = idx.compile(req.query)
    aggs_spec, aggs_arrays = None, ()
    if req.aggs is not None:
        _agg, aggs_spec, aggs_arrays = mv._compile_aggs(coord, snap, req)
    k = req.from_ + req.size
    if is_port:
        out = psh.sharded_execute_request(
            idx.mesh, idx.axis, idx.trees, compiled.arrays, compiled.spec,
            k, idx.docs_per_shard, aggs_spec=aggs_spec,
            aggs_arrays_stacked=aggs_arrays, **kw)
    else:
        out = jsh.sharded_execute_request(
            idx.mesh, idx.axis, idx.seg_stacked, compiled.arrays,
            compiled.spec, k, idx.docs_per_shard, aggs_spec=aggs_spec,
            aggs_arrays_stacked=aggs_arrays, **kw)
    return _to_np(out)


REQUESTS = [
    ({"query": {"match": {"body": "bravo charlie"}}, "size": 13}, {}),
    ({"query": {"match_all": {}}, "size": 9},
     {"sort_field": "price", "sort_desc": False}),
    ({"query": {"match_all": {}}, "size": 9},
     {"sort_field": "price", "sort_desc": True, "missing_first": True}),
    ({"query": {"term": {"tag": "x"}}, "size": 8},
     {"sort_field": "qty", "has_after": True, "after_key": 1.0,
      "after_doc": 4 * 10_000}),
    ({"query": {"match": {"body": "alpha"}}, "size": 8},
     {"has_after": True, "after_key": 1.1, "after_doc": 4 * 10_000}),
    ({"query": {"match": {"body": "bravo"}}, "size": 0}, {}),
    ({"query": {"match": {"body": "delta echo"}}, "size": 5,
      "aggs": {"tags": {"terms": {"field": "tag"}},
               "h": {"histogram": {"field": "price", "interval": 7}},
               "r": {"range": {"field": "price", "ranges": [
                   {"to": 10}, {"from": 10, "to": 25}, {"from": 25}]}},
               "s": {"stats": {"field": "price"}},
               "f": {"filter": {"term": {"tag": "y"}},
                     "aggs": {"m": {"max": {"field": "qty"}}}},
               "fs": {"filters": {"filters": {
                   "a": {"term": {"tag": "x"}},
                   "b": {"match": {"body": "alpha"}}}}},
               "g": {"global": {}, "aggs": {"c": {"cardinality": {
                   "field": "tag"}}}}}},
     {"sort_field": "price"}),
    ({"query": {"match_all": {}}, "size": 0,
      "aggs": {"no_price": {"missing": {"field": "price"}},
               "pct": {"percentiles": {"field": "price"}}}}, {}),
]


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _same_tree(a[key], b[key])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.dtype.kind == "f":
            assert np.array_equal(bits(a), bits(b))
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", range(len(REQUESTS)))
def test_sharded_execute_request_matches_reference(snaps, case):
    body, kw = REQUESTS[case]
    port_side, ref_side = snaps
    # a mesh-global cursor past every shard: key ties never qualify
    if "after_doc" in kw:
        kw = {**kw, "after_doc": 4 * port_side[2].index.docs_per_shard}
    got = _run_request(port_side, body, **kw)
    want = _run_request(ref_side, body, **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got[:5], want[:5]):
        _same_tree(g, w)
    _same_tree(got[5], want[5])


def test_mesh_combine_matches_reference():
    """Integer count planes psum and come back replicated; masks and
    terms counts come back stacked per shard; a float plane never sums."""
    rng = np.random.default_rng(3)
    n_shards, n = 4, 16
    spec = (
        ("histogram", "p", 6, (), ()),
        ("filter", ("match_all",), (("matched",), ("range", "p", 3, ()))),
        ("filters", (("match_all",), ("match_all",)), (("matched",),)),
        ("terms", "t", 4, ()),
    )
    shards = []
    for _ in range(n_shards):
        mask = rng.random(n) < 0.5
        shards.append((
            {"counts": rng.integers(0, 9, 6).astype(np.int32)},
            {"doc_count": np.int32(rng.integers(0, 9)),
             "subs": ({"mask": mask},
                      {"counts": rng.integers(0, 9, 3).astype(np.int32)})},
            tuple({"doc_count": np.int32(rng.integers(0, 9)),
                   "subs": ({"mask": rng.random(n) < 0.5},)}
                  for _ in range(2)),
            {"counts": rng.integers(0, 9, 4).astype(np.int32)},
        ))
    got = _to_np(mesh_combine(spec, [_to_torch(s) for s in shards], CPU))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *shards)
    body = jsh._shard_map(
        lambda r: jax.tree.map(
            lambda x: x[None],
            jax_mesh_combine(spec, jax.tree.map(lambda x: x[0], r), "shard")),
        mesh=jax_mesh((n_shards,), ("shard",)),
        in_specs=(jax.sharding.PartitionSpec("shard"),),
        out_specs=jax.sharding.PartitionSpec("shard"),
    )
    want = _to_np(jax.device_get(body(stacked)))
    _same_tree(got, want)
    with pytest.raises(TypeError, match="integer planes only"):
        mesh_ops.psum([torch.zeros(2), torch.zeros(2)], CPU)
