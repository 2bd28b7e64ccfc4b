"""Port structured plans (kernel-table row 16b) against the JAX package.

The JAX package builds and packs each corpus; the port gets the very same
planes (device_segment_from_numpy, nested blocks and the geo, rank_feature
and `req` columns included). Both compilers compile every body against
their own view of it (nested blocks and the `_id` index included): specs
and arrays must be equal element for element. Then the port's `execute`
(Q = 1) and `execute_batch` (Q = 3, the reference's unify_specs /
pad_arrays_to_spec, then stack_plans) — K13's and K14's plain versions on
the CPU — must equal the jitted JAX `bm25_device.execute` /
`execute_batch`: top-k ids, order, fp32 score bits and totals.

Tolerance: exact (ids, order, totals and score bits), except
- dis_max (and multi_match best_fields, which lowers to it): scores
  within 1 ulp, the reference's own allowance (XLA may contract
  `best + tie * (total - best)` into an FMA, bm25_device.py:219-225);
- a body whose scores go through exp, log, pow, sin, cos or atan2 (the
  decay functions, field_value_factor's log modifiers, rank_feature log
  and sigmoid, geo distance): scores within 4 ulps (XLA's CPU
  transcendentals are not glibc's), ids and order exact but where the
  reference's two scores at the swapped ranks are within 4 ulps;
- geo_distance's matched set, measured in
  `test_haversine_ulps_and_the_geo_boundary`: the JAX CPU distance's
  error against float64 numpy is measured on 20,000 points and stated as
  a bound; the two matched sets are equal except docs whose JAX distance
  lies within that bound of the radius, and those are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query import compile as jcomp
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu_torch.exec.planner import ExecPlanner
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.ops import bm25_device as pbd
from elasticsearch_tpu_torch.ops import kernels, tail_kernel
from elasticsearch_tpu_torch.query import compile as pcomp
from elasticsearch_tpu_torch.query.dsl import parse_query

torch.set_num_threads(1)

K = 12
PROPS = {
    "title": {"type": "text"},
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
    "pop": {"type": "float"},
    "req": {"type": "integer"},
    "loc": {"type": "geo_point"},
    "pagerank": {"type": "rank_feature"},
    "feats": {"type": "rank_features"},
    "answers": {"type": "nested", "properties": {
        "body": {"type": "text"}, "votes": {"type": "long"}}},
}
WORDS = ["quick", "brown", "fox", "jumps", "over", "lazy", "dog", "the",
         "quiet", "red", "blue"]


def make_docs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"title": " ".join(rng.choice(WORDS, int(rng.integers(1, 5)))),
             "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12)))),
             "tag": str(rng.choice(["x", "y", "z"])),
             "price": int(rng.integers(0, 60)),
             "pop": float(rng.lognormal(1.0, 1.0)),
             "req": int(rng.integers(1, 4)),
             "pagerank": float(rng.lognormal(0.0, 1.0)),
             "feats": {"x": float(rng.random() * 5 + 0.01)}}
        if i % 5 != 4:
            d["loc"] = {"lat": float(rng.uniform(-60, 70)),
                        "lon": float(rng.uniform(-180, 180))}
        if i % 6 == 2:
            del d["pop"]
        k = int(rng.integers(0, 5))
        if k:
            d["answers"] = [
                {"body": " ".join(rng.choice(WORDS, int(rng.integers(1, 8)))),
                 "votes": int(rng.integers(-3, 40))} for _ in range(k)]
        out.append(d)
    return out


def tree_planes(tree) -> dict:
    """A JAX segment tree's leaves as numpy, nested blocks included."""
    return {
        "fields": {k: [np.asarray(x) for x in v]
                   for k, v in tree["fields"].items()},
        "positions": {k: [np.asarray(x) for x in v]
                      for k, v in tree["positions"].items()},
        "doc_values": {k: np.asarray(v) for k, v in tree["doc_values"].items()},
        "live": np.asarray(tree["live"]),
        "nested": {p: {"tree": tree_planes(b["tree"]),
                       "parent_of": np.asarray(b["parent_of"])}
                   for p, b in tree.get("nested", {}).items()},
    }


def all_field_meta(jdev) -> dict:
    meta = {name: field_meta(f) for name, f in jdev.fields.items()}
    for inner, _parent_of in jdev.nested.values():
        meta.update(all_field_meta(inner))
    return meta


class Corpus:
    """One segment built and packed by the JAX package, its planes moved
    into the port, and a compiler on each side."""

    def __init__(self, docs):
        self.jm = JaxMappings(properties=PROPS)
        self.pm = Mappings(properties=PROPS)
        jb, pb = JaxBuilder(self.jm), SegmentBuilder(self.pm)
        for i, d in enumerate(docs):
            jb.add(d, f"d{i}")
            pb.add(d, f"d{i}")  # the port's dynamic leaf mappings
        self.seg = jb.build()
        self.jdev = jax_pack(self.seg)
        self.jtree = jbd.segment_tree(self.jdev)
        self.pdev = device_segment_from_numpy(
            tree_planes(self.jtree), all_field_meta(self.jdev), device="cpu")
        self.ptree = pbd.segment_tree(self.pdev)
        ids = {d: i for i, d in enumerate(self.seg.ids)}
        self.jc = jcomp.Compiler(self.jdev.fields, self.jdev.doc_values,
                                 self.jm, id_index=ids, nested=self.jdev.nested)
        self.pc = pcomp.Compiler(self.pdev.fields, self.pdev.doc_values,
                                 self.pm, id_index=ids, nested=self.pdev.nested)

    def compile_both(self, query):
        a = self.jc.compile(jax_parse(query))
        b = self.pc.compile(parse_query(query))
        assert a.spec == b.spec, (query, a.spec, b.spec)
        same_arrays(a.arrays, b.arrays, query)
        return a, b


def same_arrays(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for key in a:
            same_arrays(a[key], b[key], where)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            same_arrays(x, y, where)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert np.array_equal(x, y), where


def ulp_close(a, b, ulps: int) -> bool:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return False
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return bool(np.all((np.abs(a.astype(np.float64) - b) <= tol) | (a == b)))


def same_topk(jax_out, port_out, ulps: int, where):
    """Totals exact; ids, order and fp32 bits exact for ulps = 0, else
    scores within `ulps` and a doc at another rank only where the
    reference's scores at the two ranks are within `ulps`."""
    js, ji, jt = (np.asarray(x) for x in jax_out)
    ps, pi, pt = (x.numpy() for x in port_out)
    assert int(jt) == int(pt), (where, int(jt), int(pt))
    n = min(int(jt), len(ji))
    if ulps == 0:
        assert list(ji[:n]) == list(pi[:n]), (where, ji[:n], pi[:n])
        assert np.array_equal(js[:n].view(np.int32), ps[:n].view(np.int32)), (
            where, js[:n], ps[:n])
        return
    assert ulp_close(js[:n], ps[:n], ulps), (where, js[:n], ps[:n])
    by_id = dict(zip(ji[:n].tolist(), js[:n]))
    assert sorted(ji[:n].tolist()) == sorted(pi[:n].tolist()) or n == len(ji), where
    for rank, did in enumerate(pi[:n].tolist()):
        if did != int(ji[rank]):
            assert did in by_id and ulp_close(by_id[did], js[rank], ulps), where


@pytest.fixture(scope="module")
def corpus():
    return Corpus(make_docs(11, 160))


def _fs(functions, **kw):
    return {"function_score": {"query": {"match": {"body": "quick fox"}},
                               "functions": functions, **kw}}


def _mm(text, **kw):
    return {"multi_match": {"query": text, "fields": ["title^2", "body"], **kw}}


def _nested(query, mode, **kw):
    return {"nested": {"path": "answers", "query": query, "score_mode": mode,
                       **kw}}


GAUSS = {"gauss": {"price": {"origin": 30, "scale": 10, "offset": 2,
                             "decay": 0.4}}}
EXP = {"exp": {"pop": {"origin": 1, "scale": 3}}}
LINEAR = {"linear": {"price": {"origin": 10, "scale": 20}}, "weight": 2}
TAG_X = {"term": {"tag": "x"}}

# (name, body, ulps)
CASES = [
    ("geo_distance", {"geo_distance": {"distance": "3000km",
                                       "loc": {"lat": 10, "lon": 20}}}, 0),
    ("geo_distance_bool", {"bool": {"must": [{"match": {"body": "dog"}}],
                                    "filter": [{"geo_distance": {
                                        "distance": 5e6, "loc": [20, 5]}}]}}, 0),
    ("geo_box", {"geo_bounding_box": {"loc": {
        "top_left": {"lat": 50, "lon": -20},
        "bottom_right": {"lat": -10, "lon": 60}}}}, 0),
    ("geo_box_wrap", {"geo_bounding_box": {"loc": {
        "top": 40, "left": 150, "bottom": -40, "right": -150}}}, 0),
    ("rank_saturation", {"rank_feature": {"field": "pagerank",
                                          "saturation": {"pivot": 2.0}}}, 0),
    ("rank_log", {"rank_feature": {"field": "pagerank",
                                   "log": {"scaling_factor": 1.5}}}, 4),
    ("rank_sigmoid", {"rank_feature": {"field": "pagerank", "sigmoid": {
        "pivot": 1.5, "exponent": 0.7}}}, 4),
    ("rank_features_leaf", {"rank_feature": {"field": "feats.x",
                                             "saturation": {"pivot": 1.0},
                                             "boost": 2}}, 0),
    ("boosting", {"boosting": {"positive": {"match": {"body": "fox dog"}},
                               "negative": {"term": {"tag": "y"}},
                               "negative_boost": 0.2}}, 0),
    ("terms_set_field", {"terms_set": {"body": {
        "terms": ["quick", "fox", "dog", "red"],
        "minimum_should_match_field": "req"}}}, 0),
    ("terms_set_script", {"terms_set": {"body": {
        "terms": ["quick", "fox", "dog", "lazy"],
        "minimum_should_match_script": {
            "source": "Math.min(params.num_terms, doc['req'].value)"}}}}, 0),
    ("ids", {"ids": {"values": ["d3", "d17", "d44", "d101", "nope", "d3"]}}, 0),
    ("ids_filter", {"bool": {"must": [{"match": {"body": "fox"}}],
                             "filter": [{"ids": {"values": [
                                 f"d{i}" for i in range(0, 160, 3)]}}]}}, 0),
    ("dis_max", {"dis_max": {"queries": [{"match": {"title": "fox blue"}},
                                         TAG_X], "tie_breaker": 0.7}}, 1),
    ("multi_match_best", _mm("quick fox", tie_breaker=0.3), 1),
    ("multi_match_most", _mm("quick dog", type="most_fields"), 0),
    ("multi_match_phrase", _mm("quick brown", type="phrase"), 1),
    ("fs_weight_sum", _fs([{"weight": 2.5}, {"filter": TAG_X, "weight": 4}],
                          score_mode="sum"), 0),
    ("fs_fvf_log1p", _fs([{"field_value_factor": {
        "field": "pop", "factor": 1.2, "modifier": "log1p", "missing": 1}}]), 4),
    ("fs_fvf_plain_mods", _fs([{"field_value_factor": {
        "field": "pop", "modifier": m}} for m in ("none", "square",
                                                  "reciprocal")],
        score_mode="avg", boost_mode="sum"), 0),
    ("fs_fvf_root_mods", _fs([{"field_value_factor": {
        "field": "price", "modifier": m, "missing": 3}} for m in (
            "sqrt", "log", "log2p", "ln", "ln2p")], score_mode="sum"), 4),
    ("fs_random", _fs([{"random_score": {"seed": 42}}], boost_mode="replace"), 0),
    ("fs_decay_max_avg", _fs([GAUSS, EXP, LINEAR], score_mode="max",
                             boost_mode="avg"), 4),
    ("fs_decay_min_max", _fs([GAUSS, LINEAR], score_mode="min",
                             boost_mode="max"), 4),
    ("fs_first_min", _fs([{"filter": {"term": {"tag": "y"}}, "weight": 3},
                          {"weight": 0.5}], score_mode="first",
                         boost_mode="min"), 0),
    ("fs_multiply_max_boost", _fs([{"filter": TAG_X, "weight": 3},
                                   {"weight": 0.5}], max_boost=2.0), 0),
    ("fs_min_score", _fs([{"field_value_factor": {"field": "price"}}],
                         min_score=30.0), 0),
    ("fs_script", _fs([{"script_score": {"script": {
        "source": "_score * params.a + doc['price'].value",
        "params": {"a": 0.5}}}}], boost_mode="replace"), 0),
    ("fs_shorthand", {"function_score": {"field_value_factor": {
        "field": "pop"}, "boost": 2}}, 0),
    ("nested_avg", _nested({"match": {"answers.body": "fox dog"}}, "avg"), 0),
    ("nested_sum", _nested({"match": {"answers.body": "quick"}}, "sum"), 0),
    ("nested_max", _nested({"match": {"answers.body": "lazy red"}}, "max",
                           boost=2), 0),
    ("nested_min", _nested({"match": {"answers.body": "the"}}, "min"), 0),
    ("nested_none", _nested({"range": {"answers.votes": {"gte": 20}}},
                            "none"), 0),
    ("nested_bool", {"bool": {"must": [_nested({"bool": {
        "must": [{"match": {"answers.body": "fox"}}],
        "filter": [{"range": {"answers.votes": {"gte": 5}}}]}}, "max")],
        "filter": [TAG_X]}}, 0),
]


@pytest.mark.parametrize("name,body,ulps", CASES, ids=[c[0] for c in CASES])
def test_structured_plans_match_the_jax_package(corpus, name, body, ulps):
    a, b = corpus.compile_both(body)
    jout = jbd.execute(corpus.jtree, a.spec, a.arrays, K)
    pout = pbd.execute(corpus.ptree, b.spec,
                       pbd.plan_to_torch(b.spec, b.arrays, "cpu"), K)
    same_topk(jout, pout, ulps, name)
    assert int(pout[2]) > 0 or name.startswith("ids"), name


# Q = 3 batches: three bodies of one shape each
BATCHES = [
    ("ids", [{"ids": {"values": v}} for v in (
        ["d1"], ["d2", "d9", "d77"], [f"d{i}" for i in range(40, 60)])], 0),
    ("nested_avg", [_nested({"match": {"answers.body": t}}, "avg")
                    for t in ("fox dog", "lazy red", "blue quick")], 0),
    ("nested_min", [_nested({"match": {"answers.body": t}}, "min")
                    for t in ("the", "over", "jumps")], 0),
    ("geo_distance", [{"geo_distance": {"distance": f"{d}km", "loc": p}}
                      for d, p in ((2000, "10,20"), (4000, "-30,100"),
                                   (800, "45,-70"))], 0),
    ("rank_sigmoid", [{"rank_feature": {"field": "pagerank", "sigmoid": {
        "pivot": p, "exponent": e}}} for p, e in ((1, 0.5), (2, 1.5),
                                                   (0.5, 2.0))], 4),
    ("boosting", [{"boosting": {"positive": {"match": {"body": t}},
                                "negative": TAG_X, "negative_boost": nb}}
                  for t, nb in (("fox", 0.1), ("dog", 0.5),
                                ("quick", 0.9))], 0),
    ("dis_max", [{"dis_max": {"queries": [{"match": {"title": t}},
                                          {"match": {"body": t}}],
                              "tie_breaker": tb}}
                 for t, tb in (("fox", 0.1), ("blue", 0.5),
                               ("dog", 0.0))], 1),
    ("terms_set", [{"terms_set": {"body": {
        "terms": ts, "minimum_should_match_field": "req"}}}
        for ts in (["fox", "dog"], ["quick", "lazy"], ["red", "the"])], 0),
    ("function_score", [_fs([{"field_value_factor": {
        "field": "price", "factor": f}}, {"filter": TAG_X, "weight": w}],
        score_mode="sum", boost_mode="multiply") for f, w in (
            (0.5, 2), (1.0, 3), (2.0, 0.5))], 0),
    ("function_score_random", [_fs([{"random_score": {"seed": s}}],
                                   boost_mode="sum")
                               for s in (1, 2**31 + 5, 77)], 0),
]


@pytest.mark.parametrize("name,bodies,ulps", BATCHES, ids=[b[0] for b in BATCHES])
def test_batches_of_three_match_the_jax_package(corpus, name, bodies, ulps):
    pairs = [corpus.compile_both(b) for b in bodies]
    jspec = jcomp.unify_specs([a.spec for a, _ in pairs])
    pspec = pcomp.unify_specs([b.spec for _, b in pairs])
    assert jspec == pspec, name
    jarr = [jcomp.pad_arrays_to_spec(a.spec, jspec, a.arrays) for a, _ in pairs]
    parr = [pcomp.pad_arrays_to_spec(b.spec, pspec, b.arrays) for _, b in pairs]
    for x, y in zip(jarr, parr):
        same_arrays(x, y, name)
    jb = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *jarr)
    jout = jbd.execute_batch(corpus.jtree, jspec, jb, K)
    pout = pbd.execute_batch(
        corpus.ptree, pspec,
        pbd.plan_to_torch(pspec, pbd.stack_plans(parr), "cpu"), K)
    for r in range(3):
        same_topk(tuple(np.asarray(x)[r] for x in jout),
                  tuple(x[r] for x in pout), ulps, (name, r))
        solo = pbd.execute(corpus.ptree, pspec,
                           pbd.plan_to_torch(pspec, parr[r], "cpu"), K)
        for got, want in zip(solo, (x[r] for x in pout)):
            assert np.array_equal(got.numpy().reshape(-1).view(np.uint8),
                                  want.numpy().reshape(-1).view(np.uint8)), (
                name, r)


def test_launch_counts_stay_zero_on_the_cpu(corpus):
    kernels.reset_launches()
    for name, body, _ulps in CASES[:12]:
        _a, b = corpus.compile_both(body)
        pbd.execute(corpus.ptree, b.spec,
                    pbd.plan_to_torch(b.spec, b.arrays, "cpu"), K)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_structured_nodes_refuse_stacked_shards(corpus):
    """Shards whose nested blocks differ in shape refuse to stack, with a
    ValueError naming the nested path (the reference's np.stack refuses
    them too); with alike blocks they stack and run
    (test_torch_stacked_tail.py)."""
    from elasticsearch_tpu_torch.index.tiles import pack_segment

    segs = []
    for seed in (11, 12):
        builder = SegmentBuilder(corpus.pm)
        for i, d in enumerate(make_docs(seed, 40)):
            builder.add(d, f"d{i}")
        segs.append(builder.build())
    assert segs[0].nested["answers"].seg.num_docs != (
        segs[1].nested["answers"].seg.num_docs)
    min_tiles = {name: max(len(s.fields[name].doc_ids) for s in segs) // 256 + 2
                 for name in segs[0].fields}
    pos_tiles = {name: max(len(s.fields[name].positions) for s in segs)
                 // 256 + 2 for name in segs[0].fields
                 if segs[0].fields[name].positions is not None}
    trees = [pbd.segment_tree(pack_segment(
        s, device="cpu", pad_docs_to=40, field_min_tiles=min_tiles,
        field_pos_min_tiles=pos_tiles)) for s in segs]
    with pytest.raises(ValueError, match=r"nested\.answers"):
        pbd.stack_segment_trees(trees)
    # the same blocks on both shards stack
    stree = pbd.stack_segment_trees([trees[0], trees[0]])
    assert stree["nested"]["answers"]["child_start"].shape == (2, 41)


def test_structured_plans_classify_on_the_device_backend(corpus):
    """The exec planner's plan classes for the new kinds: each is its own
    class (the spec) and decides the dense `device` backend, the only
    candidate for a dense-only spec."""
    planner = ExecPlanner()
    for name, body, _ulps in CASES:
        _a, b = corpus.compile_both(body)
        assert not pbd.supports_sparse(b.spec), name
        cls = planner.classify(b.spec, K)
        assert planner.decide(cls, ["device"]) == "device"


def _haversine64(lat, lon, qlat, qlon):
    rad = np.pi / 180.0
    lat, lon = lat.astype(np.float64), lon.astype(np.float64)
    dphi = (qlat - lat) * rad
    dlmb = (qlon - lon) * rad
    a = (np.sin(dphi / 2) ** 2
         + np.cos(lat * rad) * np.cos(qlat * rad) * np.sin(dlmb / 2) ** 2)
    return 6371008.7714 * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def test_haversine_ulps_and_the_geo_boundary():
    """The JAX CPU haversine against float64 numpy on its own 20,000
    points: the bound it meets; then K14's geo_distance plain version
    against the JAX node kind at radii through the points' distances —
    the matched sets are equal but where the JAX distance lies within
    that bound of the radius."""
    rng = np.random.default_rng(5)
    n = 20_000
    lat = rng.uniform(-60, 70, n).astype(np.float32)
    lon = rng.uniform(-180, 180, n).astype(np.float32)
    q = (np.float32(10.5), np.float32(20.25))
    jd = np.asarray(jax.jit(lambda a, b, c, d: jbd._haversine_m(jnp, a, b, c, d))(
        lat, lon, *q))
    d64 = _haversine64(lat, lon, float(q[0]), float(q[1]))
    err = np.abs(jd.astype(np.float64) - d64)
    ulps = err / np.spacing(np.abs(d64).astype(np.float32)).astype(np.float64)
    bound_m = float(err.max())
    # The bound this test states: XLA's float32 haversine stays within
    # 16 ulps of the float64 distance on these points (13.2 ulps and
    # 26.4 m measured, the ulp being 2 m at 2e7 m); the geo check below
    # uses the measured metres.
    assert float(ulps.max()) <= 16.0, float(ulps.max())
    seg = {"doc_values": {"loc.lat": jnp.asarray(lat), "loc.lon": jnp.asarray(lon)}}
    radii = np.quantile(jd, [0.01, 0.3, 0.5, 0.9]).astype(np.float32)
    near = 0
    for radius in radii:
        arrays = {"lat": q[0], "lon": q[1], "radius_m": radius,
                  "boost": np.float32(1.0)}
        _s, jm = jax.jit(lambda a, sg: jbd._eval_node(
            ("geo_distance", "loc"), a, sg, n))(arrays, seg)
        _ps, pm = tail_kernel.tail_eval_plain(
            ("geo_distance",), 1, n, {}, {},
            {"lat": torch.from_numpy(lat), "lon": torch.from_numpy(lon)},
            {k: torch.tensor([v], dtype=torch.float32) for k, v in arrays.items()})
        differ = np.asarray(jm) != pm[0].numpy()
        assert np.all(np.abs(jd[differ] - radius) <= bound_m), radius
        near += int(differ.sum())
    # The radii run through the points themselves (each one has a point
    # at distance exactly radius), so a few docs may flip; never more
    # than 0.1 % of them.
    assert near <= n * len(radii) // 1000, near
