"""The filter cache's stacked and mesh halves against the JAX package.

`compute_filter_mask_stacked` over a stacked tree of S = 3 shards, for
term, terms, range, exists and a bool of filters, bit-equal to the JAX
program; stacked `execute_shards` with [S, N] planes equal to the JAX
vmap; `ShardedIndex.search` with its cache (the per-shard rows, each
equal to the stacked program's row) against the uncached index and the
JAX `ShardedIndex` with its cache; and the mesh view on `[cpu] * 3` with
the node's cache against the host loop and the JAX node's own mesh view:
answers, one shard's refresh keeping the other rows hitting, and
`_cache/clear` dropping the mesh scope. Mirrors the mesh parts of
tests/test_filter_cache.py and tests/test_mesh_refresh.py. Tolerance:
none.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from elasticsearch_tpu.index.filter_cache import FilterCache as JaxFilterCache
from elasticsearch_tpu.index.filter_cache import (
    apply_cached_masks as japply_cached_masks,
)
from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jpack_segment
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.parallel import sharded as jsh
from elasticsearch_tpu.query.compile import Compiler as JCompiler
from elasticsearch_tpu.query.compile import equalize_compiled as jequalize
from elasticsearch_tpu.query.dsl import parse_query as jparse
from elasticsearch_tpu_torch.index.filter_cache import (
    FilterCache,
    apply_cached_masks,
    mesh_cache_scope,
)
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import TILE, pack_segment
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.parallel import sharded as psh
from elasticsearch_tpu_torch.parallel.mesh import Mesh
from elasticsearch_tpu_torch.query.compile import Compiler, equalize_compiled
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.rest.server import RestServer

torch.set_num_threads(1)

CPU = torch.device("cpu")
S = 3
WORDS = [f"w{i}" for i in range(30)]
TAGS = ["red", "green", "blue", "teal"]
MAPPINGS = {"properties": {
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
}}
FILTERS = [
    {"term": {"tag": "red"}},
    {"terms": {"tag": ["blue", "teal"]}},
    {"range": {"price": {"gte": 20, "lt": 60}}},
    {"exists": {"field": "price"}},
    {"bool": {"filter": [{"term": {"tag": "green"}}],
              "must_not": [{"range": {"price": {"lt": 30}}}]}},
]


def _docs(n: int, seed: int) -> list[tuple[str, dict]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {"title": " ".join(rng.choice(WORDS, int(rng.integers(2, 8)))),
               "tag": str(rng.choice(TAGS))}
        if i % 7:
            doc["price"] = int(rng.integers(0, 100))
        out.append((f"d{i}", doc))
    return out


def _strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "took"}


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


# ---------------------------------------------------------------------------
# Stacked shards on one device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacked():
    sizes = (260, 180, 97)
    pm, jm = Mappings.from_json(MAPPINGS), JaxMappings.from_json(MAPPINGS)
    psegs, jsegs = [], []
    for s, n in enumerate(sizes):
        pb, jb = SegmentBuilder(pm), JaxBuilder(jm)
        for doc_id, doc in _docs(n, 50 + s):
            pb.add(doc, doc_id)
            jb.add(doc, doc_id)
        psegs.append(pb.build())
        jsegs.append(jb.build())
    n_pad = max(sizes)
    min_tiles = {
        name: max(len(seg.fields[name].doc_ids) // TILE + 2 for seg in psegs)
        for name in ("title", "tag")
    }
    # The port's stack_segment_trees stacks the positional planes too, so
    # they take a common shape (ShardedIndex.from_segments' pad).
    pos_tiles = {
        name: max(len(seg.fields[name].positions) // TILE + 2 for seg in psegs)
        for name in ("title", "tag")
        if psegs[0].fields[name].positions is not None
    }
    pdevs = [pack_segment(s, device="cpu", pad_docs_to=n_pad,
                          field_min_tiles=min_tiles,
                          field_pos_min_tiles=pos_tiles) for s in psegs]
    jdevs = [jpack_segment(s, pad_docs_to=n_pad, field_min_tiles=min_tiles)
             for s in jsegs]
    return {
        "pm": pm, "jm": jm, "pdevs": pdevs, "jdevs": jdevs, "n_pad": n_pad,
        "ptree": tbd.stack_segment_trees([tbd.segment_tree(d) for d in pdevs]),
        # The JAX package's positional planes are not padded to a common
        # shape, and these plans do not read them.
        "jtree": jax.tree.map(
            lambda *xs: np.stack(xs),
            *[{k: v for k, v in jbd.segment_tree(d).items()
               if k not in ("positions", "nested")} for d in jdevs]),
    }


def _compile_stacked(sh, body):
    """(port spec, port [S, ...] numpy plan, JAX spec, JAX plan): each
    package compiles per shard with that shard's statistics, equalizes
    and stacks."""
    pc = equalize_compiled([
        Compiler(d.fields, d.doc_values, sh["pm"]).compile(parse_query(body))
        for d in sh["pdevs"]])
    jc = jequalize([
        JCompiler(d.fields, d.doc_values, sh["jm"]).compile(jparse(body))
        for d in sh["jdevs"]])
    assert pc[0].spec == jc[0].spec
    stack = lambda cs: jax.tree.map(lambda *xs: np.stack(xs),  # noqa: E731
                                    *[c.arrays for c in cs])
    return pc[0].spec, stack(pc), jc[0].spec, stack(jc)


@pytest.mark.parametrize("body", FILTERS)
def test_compute_filter_mask_stacked_bit_equal(stacked, body):
    pspec, parr, jspec, jarr = _compile_stacked(stacked, body)
    got = tbd.compute_filter_mask_stacked(
        stacked["ptree"], pspec, tbd.plan_to_torch(pspec, parr, CPU))
    want = np.asarray(jbd.compute_filter_mask_stacked(
        stacked["jtree"], jspec, jarr))
    assert got.shape == want.shape == (S, stacked["n_pad"])
    np.testing.assert_array_equal(got.numpy(), want)
    # Row s is compute_filter_mask over shard s's own tree: the form the
    # sharded plane builds take.
    for s, dev in enumerate(stacked["pdevs"]):
        row = tbd.compute_filter_mask(
            tbd.segment_tree(dev), pspec,
            tbd.plan_to_torch(pspec, jax.tree.map(lambda x: x[s], parr), CPU))
        np.testing.assert_array_equal(row.numpy(), want[s])


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("must", ["w1 w2", "w3"])
def test_execute_shards_with_stacked_masks_equals_vmap(stacked, filt, must):
    """A bool(must match, filter F, must_not term) whose cacheable clauses
    read [S, N] planes: the port's execute_shards equals the JAX
    package's, and both equal the unmasked plan."""
    body = {"bool": {"must": [{"match": {"title": must}}],
                     "filter": [filt],
                     "must_not": [{"term": {"tag": "teal"}}]}}
    pspec, parr, jspec, jarr = _compile_stacked(stacked, body)
    n_pad = stacked["n_pad"]

    def pbuild(cs, ca, _norm):
        plane = tbd.compute_filter_mask_stacked(
            stacked["ptree"], cs, tbd.plan_to_torch(cs, ca, CPU)).clone()
        return plane, plane.numel()

    def jbuild(cs, ca, _norm):
        plane = jbd.compute_filter_mask_stacked(stacked["jtree"], cs, ca)
        return plane, int(plane.nbytes)

    from elasticsearch_tpu_torch.query.compile import CompiledQuery
    from elasticsearch_tpu.query.compile import CompiledQuery as JCompiled

    fill = lambda: {"boost": np.zeros(S, dtype=np.float32)}  # noqa: E731
    entries = _entries(body)
    pcache, jcache = FilterCache(min_freq=1), JaxFilterCache(min_freq=1)
    for cache in (pcache, jcache):
        cache.record([k for _g, _i, k in entries])
    pm_c, pmasks, _ = apply_cached_masks(
        pcache, ("t", 0, 0), parse_query(body), CompiledQuery(pspec, parr),
        pbuild, const_fill=fill, entries=entries)
    jm_c, jmasks, _ = japply_cached_masks(
        jcache, ("t", 0, 0), jparse(body), JCompiled(jspec, jarr), jbuild,
        const_fill=fill, entries=entries)
    assert pm_c.spec == jm_c.spec and pmasks
    got = tbd.execute_shards(
        {**stacked["ptree"], "masks": pmasks}, pm_c.spec,
        tbd.plan_to_torch(pm_c.spec, pm_c.arrays, CPU), 15, n_pad)
    want = jbd.execute_shards(
        {**stacked["jtree"], "masks": jmasks}, jm_c.spec, jm_c.arrays, 15,
        n_pad)
    unmasked = tbd.execute_shards(
        stacked["ptree"], pspec, tbd.plan_to_torch(pspec, parr, CPU), 15,
        n_pad)
    for g, w, u in zip(got, want, unmasked):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(u.numpy()))


def _entries(body):
    from elasticsearch_tpu_torch.query.compile import collect_cacheable_filters

    return collect_cacheable_filters(parse_query(body))


# ---------------------------------------------------------------------------
# ShardedIndex with the cache
# ---------------------------------------------------------------------------

BODIES = [
    {"bool": {"must": [{"match": {"title": m}}], "filter": [f, FILTERS[3]]}}
    for m in ("w1 w2", "w4", "w5 w6 w7") for f in FILTERS[:3]
]


def test_sharded_index_masks_bit_identical():
    docs = _docs(400, 21)
    pm, jm = Mappings.from_json(MAPPINGS), JaxMappings.from_json(MAPPINGS)
    mesh = Mesh(np.full((S,), CPU, dtype=object), ("shard",))
    jmesh = JaxMesh(np.array(jax.devices()[:S]), ("shard",))
    plain = psh.ShardedIndex.from_docs(docs, pm, mesh)
    cached = psh.ShardedIndex.from_docs(docs, pm, mesh)
    cached.filter_cache = FilterCache(min_freq=1)
    jcached = jsh.ShardedIndex.from_docs(docs, jm, jmesh)
    jcached.filter_cache = JaxFilterCache(min_freq=1)
    for body in BODIES:
        ref = plain.search(parse_query(body), k=10)
        for _rep in range(2):  # cold (admission), then warm (hit)
            got = cached.search(parse_query(body), k=10)
            want = jcached.search(jparse(body), k=10)
            for g, r, w in zip(got[:2], ref[:2], want[:2]):
                np.testing.assert_array_equal(_bits(g), _bits(r))
                np.testing.assert_array_equal(_bits(g), _bits(w))
            assert got[2] == ref[2] == want[2]
    stats = cached.filter_cache.stats()
    assert stats["admissions"] > 0 and stats["hit_count"] > 0
    for key in ("entries", "hit_count", "miss_count", "admissions"):
        assert stats[key] == jcached.filter_cache.stats()[key], key
    # Each cached entry is S rows, each on its shard's device, equal to
    # the stacked program over the stacked trees.
    stree = tbd.stack_segment_trees(cached.trees)
    for key in cached.filter_cache.keys():
        rows = cached.filter_cache.get(key)
        assert isinstance(rows, psh.ShardPlanes) and len(rows) == S
        q = parse_query(json.loads(json.dumps(_filter_of(key[-1]))))
        c = cached.compile(q)
        stacked_plane = tbd.compute_filter_mask_stacked(
            stree, c.spec, tbd.plan_to_torch(c.spec, c.arrays, CPU))
        for s, row in enumerate(rows):
            assert row.device == cached.trees[s]["live"].device
            np.testing.assert_array_equal(row.numpy(), stacked_plane[s].numpy())


def _filter_of(norm):
    """The query body of a canonical filter key (the shapes FILTERS
    uses)."""
    for f in FILTERS:
        from elasticsearch_tpu_torch.query.compile import cacheable_filter_key

        if cacheable_filter_key(parse_query(f)) == norm:
            return f
    raise KeyError(norm)


# ---------------------------------------------------------------------------
# The mesh view with the node's cache
# ---------------------------------------------------------------------------

INDEX_BODY = {"settings": {"index": {"number_of_shards": S}},
              "mappings": MAPPINGS}


def _bulk_body(docs) -> str:
    lines = []
    for doc_id, doc in docs:
        lines.append(json.dumps({"index": {"_id": doc_id}}))
        lines.append(json.dumps(doc))
    return "\n".join(lines) + "\n"


@pytest.fixture()
def trio():
    """The port node on a [cpu] * 3 mesh with its cache (min_freq 1), the
    JAX node on its own mesh view with its cache, the same documents."""
    with pytest.MonkeyPatch.context() as mp:
        for key, val in {"ESTPU_EXEC_PLANNER": "0", "ESTPU_EXEC_PACKED": "0",
                         "ESTPU_FILTER_CACHE_MIN_FREQ": "1"}.items():
            mp.setenv(key, val)
        ref = JaxNode()
        ref.create_index("m", INDEX_BODY)
    port = Node(device="cpu", mesh_devices=[CPU] * S,
                filter_cache=FilterCache(min_freq=1))
    port.create_index("m", INDEX_BODY)
    bulk = _bulk_body(_docs(240, 3))
    for n in (port, ref):
        assert not n.bulk(bulk, default_index="m", refresh=True)["errors"]
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


MESH_BODY = {"query": {"bool": {
    "must": [{"match": {"title": "w1 w2 w3"}}],
    "filter": [{"term": {"tag": "red"}}, {"range": {"price": {"gte": 10}}}],
    "must_not": [{"exists": {"field": "nope"}}],
}}, "size": 10}


def _host_loop(port, body):
    coord = port.get_index("m").search
    mv = coord.mesh_view
    coord.mesh_view = None
    try:
        return _strip(port.search("m", json.loads(json.dumps(body))))
    finally:
        coord.mesh_view = mv


def test_mesh_serve_consults_cache_and_stays_exact(trio):
    port, ref = trio
    mv = port.get_index("m").search.mesh_view
    assert mv is not None and mv.filter_cache is port.filter_cache
    scope = mesh_cache_scope(port.get_index("m").engines)
    rng = np.random.default_rng(8)
    bodies = [MESH_BODY] + [
        {"query": {"bool": {
            "must": [{"match": {"title": " ".join(rng.choice(WORDS, 2))}}],
            "filter": [FILTERS[int(rng.integers(0, len(FILTERS)))]],
        }}, "size": 10}
        for _ in range(6)
    ]
    for body in bodies:
        want = _host_loop(port, body)
        for _rep in range(2):
            before = mv.served
            got = _strip(port.search("m", json.loads(json.dumps(body))))
            assert mv.served == before + 1
            assert got == want
            assert got == _strip(ref.search("m", json.loads(json.dumps(body)),
                                            request_cache=False))
    keys = [k for k in port.filter_cache.keys() if k[0] == scope]
    assert keys and all(k[1][0] == "row" for k in keys)
    assert port.filter_cache.stats()["hit_count"] > 0


def test_one_shard_refresh_keeps_other_rows_hitting(trio):
    port, ref = trio
    scope = mesh_cache_scope(port.get_index("m").engines)
    port.search("m", json.loads(json.dumps(MESH_BODY)))  # admit the rows
    rows = {k for k in port.filter_cache.keys() if k[0] == scope}
    n_filters = len({k[3] for k in rows})
    assert len(rows) == S * n_filters
    doc = {"title": "w1 w2 w3", "tag": "red", "price": 50}
    for n in (port, ref):
        n.index_doc("m", doc, "new")
        n.refresh("m")
    shard = port.get_index("m").engines.index(port.get_index("m").route("new"))
    hits = port.filter_cache.stats()["hit_count"]
    got = _strip(port.search("m", json.loads(json.dumps(MESH_BODY))))
    after = {k for k in port.filter_cache.keys() if k[0] == scope}
    # The changed shard's rows were purged and rebuilt; the others hit.
    assert {k for k in rows if k[1][1] != shard} <= after
    assert not {k for k in rows if k[1][1] == shard} & after
    assert port.filter_cache.stats()["hit_count"] - hits == (S - 1) * n_filters
    assert any(h["_id"] == "new" for h in got["hits"]["hits"])
    assert got == _host_loop(port, MESH_BODY)
    assert got == _strip(ref.search("m", json.loads(json.dumps(MESH_BODY)),
                                    request_cache=False))


def test_cache_clear_drops_the_mesh_scope(trio):
    port, _ref = trio
    rest = RestServer(port)
    scope = mesh_cache_scope(port.get_index("m").engines)
    status, _ = rest.dispatch("POST", "/m/_search", {}, json.dumps(MESH_BODY))
    assert status == 200
    assert any(k[0] == scope for k in port.filter_cache.keys())
    status, out = rest.dispatch("POST", "/m/_cache/clear", {}, "")
    assert status == 200 and out["cleared"]["filter_cache"] > 0
    assert out["_shards"]["total"] == S
    assert not any(k[0] == scope for k in port.filter_cache.keys())
    status, again = rest.dispatch("POST", "/m/_search", {},
                                  json.dumps(MESH_BODY))
    assert status == 200
    assert _strip(again) == _host_loop(port, MESH_BODY)
