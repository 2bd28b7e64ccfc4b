"""Vector functions inside function_score and terms_set scripts (fault
C4) through the port against the JAX node.

A `function_score` script function, or a `terms_set`
`minimum_should_match_script`, may call `cosineSimilarity`, `dotProduct`
or `l2norm` over a dense_vector field. The reference evaluates the script
with the segment's vectors (elasticsearch_tpu/query/functions.py, the
script branch; ops/bm25_device.py `_eval_terms_set`). The port stages each
vector call's planes through K7's script mode, as script_score does, and
K14 reads them as inputs of the tail node (ops/bm25_device.py
`_tail_script_inputs`).

Cases, on 1 and 3 shards, over the port's REST server (`Node(device=
"cpu")`) against the JAX node (ESTPU_MESH_SERVING, ESTPU_EXEC_PLANNER,
ESTPU_FILTER_CACHE and ESTPU_EXEC_PACKED off, as the other node parity
suites run it): the fault's repro (five docs `{"b": "fox dog", "v": [1, i,
2]}`), the same with dotProduct and l2norm, a seeded corpus with docs
that lack the vector, two functions, a filter and a number param, and
terms_set with a vector script. The stacked-shard mode (K14s) is held to
the JAX package's `execute_shards_batch`. The refusals: a list-valued
param read as a number stays refused (the reference raises a TypeError,
the port answers 400), a query vector of the wrong length answers the
400 script_score answers, an unknown field the reference's 400.

Tolerance: ids, order and totals exact; each `_score` within 4 ulps of
the reference's (XLA sums the dot in another order than K7's lane order),
as for every script.
"""

import json

import jax
import numpy as np
import pytest
import torch
from test_torch_stacked_tail import _pads
from test_torch_structured import all_field_meta, same_topk, tree_planes

from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query import compile as jcomp
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25_device as pbd
from elasticsearch_tpu_torch.ops import kernels, tail_kernel
from elasticsearch_tpu_torch.query import compile as pcomp
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.rest.server import RestServer

torch.set_num_threads(1)

JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}
PROPS = {"b": {"type": "text"}, "v": {"type": "dense_vector", "dims": 3},
         "p": {"type": "float"}}
WORDS = ["fox", "dog", "cat", "owl"]


def _repro_docs():
    return [{"b": "fox dog", "v": [1, i, 2]} for i in range(5)]


def _seeded_docs(seed=5, n=60):
    """Docs from numpy's seed: one in seven lacks the vector."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"b": " ".join(rng.choice(WORDS, 3)),
             "p": float(np.float32(rng.random()))}
        if i % 7 != 3:
            d["v"] = [float(np.float32(x)) for x in rng.normal(size=3)]
        out.append(d)
    return out


def _bulk(docs, prefix):
    lines = []
    for i, d in enumerate(docs):
        lines += [json.dumps({"index": {"_id": f"{prefix}{i}"}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


def _make_nodes(shards):
    body = {"settings": {"index": {"number_of_shards": shards}},
            "mappings": {"properties": PROPS}}
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        for name in ("repro", "seeded"):
            ref.create_index(name, body)
    port = Node(device="cpu")
    for name in ("repro", "seeded"):
        port.create_index(name, body)
    for n in (port, ref):
        assert not n.bulk(_bulk(_repro_docs(), ""), default_index="repro",
                          refresh=True)["errors"]
        assert not n.bulk(_bulk(_seeded_docs(), "d"), default_index="seeded",
                          refresh=True)["errors"]
    return port, ref


@pytest.fixture(scope="module")
def nodes():
    made = {}
    yield lambda shards: made.setdefault(shards, _make_nodes(shards))
    for port, ref in made.values():
        port.close()
        if ref.exec_batcher is not None:
            ref.exec_batcher.close()


def _ulp_close(a, b, ulps):
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return bool(np.all((np.abs(a.astype(np.float64) - b) <= tol) | (a == b)))


def _served(port, ref, index, body):
    """The port's REST answer (200) held to the JAX node's: ids, order and
    totals exact, scores within 4 ulps. Returns the port's hits."""
    status, got = RestServer(port).dispatch(
        "POST", f"/{index}/_search", {}, json.dumps(body))
    assert status == 200, got
    want = ref.search(index, json.loads(json.dumps(body)))
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert gh and [h["_id"] for h in gh] == [h["_id"] for h in wh]
    assert _ulp_close([h["_score"] for h in gh], [h["_score"] for h in wh], 4)
    return gh


def _fs_script(source, params, **kw):
    return {"query": {"function_score": {
        "query": {"match": {"b": "fox"}},
        "functions": [{"script_score": {"script": {
            "source": source, "params": params}}}], **kw}}}


SHARDS = [1, 3]
VECTOR_SOURCES = {
    "cosine": "cosineSimilarity(params.q, 'v') + 1.0",
    "dot": "dotProduct(params.q, 'v')",
    "l2norm": "l2norm(params.q, 'v')",
}


@pytest.mark.parametrize("shards", SHARDS)
def test_c4_repro_answers_the_jax_nodes_scores(nodes, shards):
    port, ref = nodes(shards)
    hits = _served(port, ref, "repro", _fs_script(
        VECTOR_SOURCES["cosine"], {"q": [1, 0, 0]}))
    assert [h["_id"] for h in hits[:3]] == ["0", "1", "2"]
    assert _ulp_close([h["_score"] for h in hits[:3]],
                      [0.12592404, 0.12253361, 0.11601516], 4)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("fn", sorted(VECTOR_SOURCES))
def test_vector_functions_in_function_score_match_the_jax_node(
        nodes, shards, fn):
    port, ref = nodes(shards)
    _served(port, ref, "repro", _fs_script(VECTOR_SOURCES[fn], {"q": [1, 0, 0]}))
    _served(port, ref, "seeded", _fs_script(
        VECTOR_SOURCES[fn], {"q": [0.25, -1.0, 2.0]}, boost_mode="sum"))


@pytest.mark.parametrize("shards", SHARDS)
def test_two_functions_a_filter_and_a_number_param(nodes, shards):
    port, ref = nodes(shards)
    body = {"query": {"function_score": {
        "query": {"match": {"b": "fox dog"}},
        "functions": [
            {"script_score": {"script": {
                "source": "cosineSimilarity(params.q, 'v') * doc['p'].value"
                          " + params.w - l2norm(params.r, 'v')",
                "params": {"q": [0.3, -1, 2], "w": 2, "r": [1, 1, 1]}}}},
            {"filter": {"match": {"b": "cat"}}, "script_score": {"script": {
                "source": "dotProduct(params.q, 'v') * params.w",
                "params": {"q": [1, 0.5, -0.5], "w": 0.5}}}},
            {"filter": {"match": {"b": "owl"}}, "weight": 3},
        ], "score_mode": "sum", "boost_mode": "sum"}}, "size": 30}
    _served(port, ref, "seeded", body)


@pytest.mark.parametrize("shards", SHARDS)
def test_terms_set_vector_script_matches_the_jax_node(nodes, shards):
    port, ref = nodes(shards)
    repro = {"query": {"terms_set": {"b": {
        "terms": ["fox", "dog", "cat"],
        "minimum_should_match_script": {
            "source": "dotProduct(params.q, 'v')", "params": {"q": [0, 1, 0]}}}}}}
    hits = _served(port, ref, "repro", repro)
    # Required = max(i, 1): docs 0-2 carry two of the terms, 3 and 4 do not.
    assert sorted(h["_id"] for h in hits) == ["0", "1", "2"]
    seeded = {"query": {"terms_set": {"b": {
        "terms": ["fox", "dog", "cat", "owl"],
        "minimum_should_match_script": {
            "source": "Math.min(params.num_terms, l2norm(params.q, 'v') * "
                      "params.s)",
            "params": {"q": [0, 0, 0], "s": 1.5}}}}}, "size": 40}
    _served(port, ref, "seeded", seeded)


def test_list_param_read_as_a_number_stays_refused(nodes):
    """The reference fails on it (a TypeError from its broadcast); the
    port refuses it with a 400, as K6 refuses it in script_score."""
    port, ref = nodes(1)
    body = _fs_script("_score + params.a", {"a": [1, 2]})
    status, out = RestServer(port).dispatch(
        "POST", "/seeded/_search", {}, json.dumps(body))
    assert status == 400
    assert out["error"]["reason"] == "script param [a] must be a number"
    with pytest.raises(TypeError):
        ref.search("seeded", body)
    mixed = _fs_script("dotProduct(params.q, 'v') + params.q", {"q": [1, 0, 0]})
    status, out = RestServer(port).dispatch(
        "POST", "/seeded/_search", {}, json.dumps(mixed))
    assert status == 400
    assert out["error"]["reason"] == "script param [q] must be a number"


@pytest.mark.parametrize("shards", SHARDS)
def test_wrong_length_query_vector_is_script_scores_400(nodes, shards):
    port, ref = nodes(shards)
    rest = RestServer(port)
    short = [1.0, 2.0]
    fs = _fs_script("dotProduct(params.q, 'v')", {"q": short})
    ts = {"query": {"terms_set": {"b": {"terms": ["fox"],
          "minimum_should_match_script": {
              "source": "l2norm(params.q, 'v')", "params": {"q": short}}}}}}
    ss = {"query": {"script_score": {"query": {"match": {"b": "fox"}},
          "script": {"source": "dotProduct(params.q, 'v')",
                     "params": {"q": short}}}}}
    answers = [rest.dispatch("POST", "/seeded/_search", {}, json.dumps(b))
               for b in (fs, ts, ss)]
    reasons = {out["error"]["reason"] for _status, out in answers}
    assert [status for status, _out in answers] == [400, 400, 400]
    assert reasons == {"the query vector [params.q] has a different number "
                       "of dimensions [2] than the document vectors [3]"}
    unknown = _fs_script("l2norm(params.q, 'nope')", {"q": [1, 2, 3]})
    status, out = rest.dispatch("POST", "/seeded/_search", {},
                                json.dumps(unknown))
    assert status == 400
    assert out["error"]["reason"] == "no dense_vector field [nope]"
    with pytest.raises(Exception) as r:
        ref.search("seeded", unknown)
    assert "no dense_vector field [nope]" in str(r.value)


def test_kernel_reads_the_vector_planes_as_node_inputs():
    """K14's generator names each vector call's planes and |q| among the
    node's inputs, and reads no query-vector param as a number."""
    fspec = ("script", "cosineSimilarity(params.q, 'v') * params.w + "
             "l2norm(params.q, 'v')", ("q", "w"), False, False, False)
    key = ("function_score", (fspec,), (False,), "multiply", "multiply",
           False)
    _src, _consts, be = tail_kernel.generate_source(key)
    tag = tail_kernel.vector_tag("f0.", "q", "v")
    assert set(be.plane_names) == {"child", tag + "dot", tag + "norm",
                                   tag + "dist"}
    assert tag + "qnorm" in be.names and "f0.p.w" in be.names
    assert "f0.p.q" not in be.names
    ts_key = ("terms_set", 1, "script", ("dotProduct(params.q, 'v')",
                                         ("num_terms", "q")))
    _src, _consts, be = tail_kernel.generate_source(ts_key)
    assert tail_kernel.vector_tag("", "q", "v") + "dot" in be.plane_names
    assert "p.q" not in be.names


# ---------------------------------------------------------------------------
# K14s: the stacked-shard mode against the JAX package's vmap
# ---------------------------------------------------------------------------

STACKED_DOCS = (40, 31, 22)
K = 12
STACKED_BODIES = [
    _fs_script(VECTOR_SOURCES["cosine"], {"q": [0.5, -1.0, 0.25]})["query"],
    _fs_script("dotProduct(params.q, 'v') * params.w",
               {"q": [1.0, 2.0, -1.0], "w": 0.5}, boost_mode="sum")["query"],
    {"terms_set": {"b": {"terms": ["fox", "dog", "cat"],
     "minimum_should_match_script": {"source": "l2norm(params.q, 'v')",
                                     "params": {"q": [0.0, 0.0, 0.0]}}}}},
]


def _stacked():
    jm, pm = JaxMappings(properties=PROPS), Mappings(properties=PROPS)
    segs = []
    for s, n in enumerate(STACKED_DOCS):
        b = JaxBuilder(jm)
        for i, d in enumerate(_seeded_docs(20 + s, n)):
            b.add(d, f"s{s}d{i}")
        segs.append(b.build())
    n_pad, min_tiles, pos_tiles = _pads(segs)
    jdevs = [jax_pack(seg, pad_docs_to=n_pad, field_min_tiles=min_tiles,
                      field_pos_min_tiles=pos_tiles) for seg in segs]
    jtrees = [jbd.segment_tree(d) for d in jdevs]
    pdevs = []
    for t, d in zip(jtrees, jdevs):
        planes = tree_planes(t)
        planes["vectors"] = {k: np.asarray(v) for k, v in t["vectors"].items()}
        pdevs.append(device_segment_from_numpy(planes, all_field_meta(d),
                                               device="cpu"))
    jtree = jax.tree.map(lambda *xs: np.stack(xs), *jtrees)
    ptree = pbd.stack_segment_trees([pbd.segment_tree(d) for d in pdevs])
    jc = [jcomp.Compiler(d.fields, d.doc_values, jm) for d in jdevs]
    pc = [pcomp.Compiler(d.fields, d.doc_values, pm) for d in pdevs]
    return n_pad, jtree, ptree, jc, pc


@pytest.mark.parametrize("i", range(len(STACKED_BODIES)))
def test_stacked_shards_match_the_jax_package(i):
    n_pad, jtree, ptree, jc, pc = _stacked()
    bodies = [STACKED_BODIES[i], STACKED_BODIES[i]]
    jflat = jcomp.equalize_compiled(
        [c.compile(jax_parse(b)) for b in bodies for c in jc])
    pflat = pcomp.equalize_compiled(
        [c.compile(parse_query(b)) for b in bodies for c in pc])
    assert jflat[0].spec == pflat[0].spec
    s = len(jc)

    def per_query(flat):
        return [jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                             *[c.arrays for c in flat[q * s:(q + 1) * s]])
                for q in range(len(bodies))]

    spec = pflat[0].spec
    jb = jax.tree.map(lambda *xs: np.stack(xs), *per_query(jflat))
    pb = pbd.plan_to_torch(spec, pbd.stack_plans(per_query(pflat)), "cpu")
    before = dict(kernels.LAUNCHES)
    jout = jbd.execute_shards_batch(jtree, spec, jb, K, n_pad)
    pout = pbd.execute_shards_batch(ptree, spec, pb, K, n_pad)
    assert dict(kernels.LAUNCHES) == before  # the CPU runs the plain versions
    for r in range(len(bodies)):
        assert int(np.asarray(jout[2])[r]) > 0
        same_topk(tuple(np.asarray(x)[r] for x in jout),
                  tuple(x[r] for x in pout), 4, (i, r))
