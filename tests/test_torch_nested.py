"""Nested documents in the port against the JAX package.

- The mapping and the builder: object leaves flatten to dotted paths, a
  nested path gets its own scope, rank_features flatten to one column per
  key, a geo_point to its `.lat` / `.lon` columns; each nested object
  becomes one inner doc of its path's block, with `parent_of` — all equal
  to the reference's segments, array for array. A rejected write leaves
  no nested block behind (the reference's
  tests/test_nested.py::test_rejected_write_leaves_no_ghost_nested_block),
  and the reference's mapper errors are raised with its messages.
- K13's join: the plain fold by child rank against the jitted JAX
  `_eval_nested` scatters, fp32 bits exact, for all five score modes;
  with finite child scores whose sum order matters (up to 40 children a
  parent, magnitudes over 12 decades), and with NaN child scores from a
  script_score child (both signs and two payloads, beside infinities and
  signed zeros), NaN bits included.
- K13's mark mode (ids) against the JAX `doc_set` node.

Tolerance: exact everywhere (fp32 bits, NaN payloads and signs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import child_starts
from elasticsearch_tpu_torch.ops import bm25_device as pbd
from elasticsearch_tpu_torch.ops import kernels

torch.set_num_threads(1)

MAPPINGS = {"properties": {
    "title": {"type": "text"},
    "user": {"properties": {"name": {"type": "keyword"},
                            "age": {"type": "long"}}},
    "loc": {"type": "geo_point"},
    "feats": {"type": "rank_features"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"}, "body": {"type": "text"},
        "stars": {"type": "long"}}},
}}

DOCS = [
    {"title": "red fox", "user": {"name": "ann", "age": 31},
     "loc": {"lat": 41.1, "lon": -73.5}, "feats": {"x": 1.5, "y": 3},
     "comments": [{"author": "bob", "body": "quick brown fox", "stars": 4},
                  {"author": "cy", "body": "lazy dog", "stars": 2}]},
    {"title": "blue", "loc": [12.5, -8.25],
     "comments": {"author": "dee", "body": "a fox", "stars": 5}},
    {"title": "green", "user": {"name": "bob"}, "loc": "10.5,20.25",
     "extra": {"deep": {"v": 2.5}}},
    {"title": "dotted", "comments.author": "eve", "comments.stars": 1},
    {"title": "objects", "parts": [{"a": 1}, {"a": 2, "b": "x y"}],
     "comments": [{"body": "fox fox", "stars": 3}, {"author": "fin"},
                  {"body": "the end", "stars": 1}]},
]


def _build(mappings_cls, builder_cls, docs):
    m = mappings_cls.from_json(MAPPINGS)
    b = builder_cls(m)
    for i, d in enumerate(docs):
        b.add(d, f"d{i}")
    return m, b.build()


def _same_segment(p, j):
    assert p.num_docs == j.num_docs
    assert sorted(p.fields) == sorted(j.fields)
    for name, pf in p.fields.items():
        jf = j.fields[name]
        assert pf.terms == jf.terms, name
        for attr in ("df", "offsets", "doc_ids", "tfs", "norm_bytes",
                     "present", "pos_offsets", "positions"):
            a, b = getattr(pf, attr), getattr(jf, attr)
            assert (a is None) == (b is None), (name, attr)
            if a is not None:
                assert np.array_equal(a, b), (name, attr)
        assert (pf.doc_count, pf.sum_total_tf) == (jf.doc_count, jf.sum_total_tf)
    assert sorted(p.doc_values) == sorted(j.doc_values)
    for name, col in p.doc_values.items():
        assert np.array_equal(col, j.doc_values[name], equal_nan=True), name
    assert p.ids == j.ids and p.sources == j.sources
    assert sorted(p.nested) == sorted(j.nested)
    for path, blk in p.nested.items():
        assert np.array_equal(blk.parent_of, j.nested[path].parent_of), path
        assert blk.parent_of.dtype == np.int32
        _same_segment(blk.seg, j.nested[path].seg)


def test_mapping_and_builder_match_the_reference():
    pm, pseg = _build(Mappings, SegmentBuilder, DOCS)
    jm, jseg = _build(JaxMappings, JaxBuilder, DOCS)
    _same_segment(pseg, jseg)
    # each dotted key of doc 3 expands to a nested object of its own
    assert pseg.nested["comments"].parent_of.tolist() == [0, 0, 1, 3, 3, 4, 4, 4]
    assert sorted(pm.nested) == sorted(jm.nested) == ["comments"]
    for name in ("user", "user.name", "loc", "feats.x", "extra", "extra.deep.v",
                 "parts", "parts.a", "parts.b", "comments"):
        pf, jf = pm.get(name), jm.get(name)
        assert pf is not None and jf is not None, name
        assert pf.type == jf.type, name
    assert sorted(pm.nested["comments"].fields) == sorted(jm.nested["comments"].fields)
    # the parent's _source keeps its nested arrays
    assert pseg.sources[0]["comments"][1]["body"] == "lazy dog"


def test_rejected_write_leaves_no_ghost_nested_block():
    for mcls, bcls in ((Mappings, SegmentBuilder), (JaxMappings, JaxBuilder)):
        m = mcls.from_json(MAPPINGS)
        b = bcls(m)
        with pytest.raises(ValueError):
            b.add({"comments": [{"stars": "not-a-number"}]}, "bad")
        assert b.build().nested == {}
        b2 = bcls(m)
        with pytest.raises(ValueError):
            b2.add({"comments": [{"stars": 4}, {"stars": "nope"}]}, "bad2")
        b2.add({"title": "kept"}, "ok")
        seg = b2.build()
        assert seg.nested == {} and seg.num_docs == 1


MAPPER_ERRORS = [
    ({"user": "bob"}, "object"),
    ({"title": {"oops": 1}}, "found an object"),
    ({"comments": ["plain"]}, "concrete value"),
    ({"loc": {"lat": 95.0, "lon": 0.0}}, "out of bounds"),
    ({"loc": "nowhere"}, "geo_point"),
    ({"feats": 3}, "rank_features"),
    ({"parts": [{"a": 1}, 5]}, "mix objects"),
]


@pytest.mark.parametrize("doc,match", MAPPER_ERRORS)
def test_mapper_errors_match_the_reference(doc, match):
    for mcls, bcls in ((Mappings, SegmentBuilder), (JaxMappings, JaxBuilder)):
        b = bcls(mcls.from_json(MAPPINGS))
        with pytest.raises(ValueError, match=match):
            b.add(doc, "x")
        assert b.num_docs == 0


def test_child_starts_is_the_csr_of_parent_of():
    parent_of = np.array([0, 0, 2, 2, 2, 5], dtype=np.int32)
    assert child_starts(parent_of, 7).tolist() == [0, 2, 2, 5, 5, 5, 6, 6]
    assert child_starts(np.zeros(0, np.int32), 3).tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="nondecreasing"):
        child_starts(np.array([1, 0], dtype=np.int32), 3)
    with pytest.raises(ValueError, match="nondecreasing"):
        child_starts(np.array([0, 4], dtype=np.int32), 3)


# ---------------------------------------------------------------------------
# K13: the join against the JAX scatters
# ---------------------------------------------------------------------------

MODES = ("none", "sum", "avg", "max", "min")


def _f32(u):
    return np.array([u], np.uint32).view(np.float32)[0]


def _join_pair(col, parent_of, n, mode, boost=2.0):
    """(JAX scores, matched) of `_eval_nested` over a script child that
    reads the inner column `c.f`, and the port's, as uint32 bits / bool."""
    spec = ("nested", "c", ("script", ("match_all",), "doc['c.f'].value",
                            (), False), mode)
    arrays = {"child": {"child": {"boost": np.float32(1)}, "params": {},
                        "boost": np.float32(1.0)},
              "boost": np.float32(boost)}
    nn = len(col)
    jtree = {"fields": {}, "doc_values": {"c.f": jnp.asarray(col)},
             "vectors": {}, "live": jnp.ones(nn, bool)}
    jseg = {"nested": {"c": {"tree": jtree, "parent_of": jnp.asarray(parent_of)}}}
    # The tree is an argument of the jitted program, as it is when the
    # reference serves: closed over, XLA would fold it as constants.
    js, jm = jax.jit(lambda a, sg: jbd._eval_nested(spec, a, sg, n))(arrays, jseg)
    ptree = {"fields": {}, "doc_values": {"c.f": torch.from_numpy(col)},
             "vectors": {}, "live": torch.ones(nn, dtype=torch.bool)}
    pseg = {"live": torch.ones(n, dtype=torch.bool),
            "nested": {"c": {"tree": ptree,
                             "parent_of": torch.from_numpy(parent_of),
                             "child_start": torch.from_numpy(
                                 child_starts(parent_of, n))}}}
    ps, pm = pbd._eval_node(spec, pbd._rows1(pbd.plan_to_torch(
        spec, arrays, "cpu")), pseg, n, 1)
    return (np.asarray(js).view(np.uint32), np.asarray(jm),
            ps[0].numpy().view(np.uint32), pm[0].numpy())


@pytest.mark.parametrize("mode", MODES)
def test_join_folds_in_the_reference_order(mode):
    """Finite child scores, up to 40 children a parent, magnitudes over 12
    decades: the fp32 sum depends on its order, and the fold by child
    rank must give the scatter's bits."""
    rng = np.random.default_rng(9)
    n = 300
    counts = rng.integers(0, 41, n)
    parent_of = np.repeat(np.arange(n, dtype=np.int32), counts)
    col = (rng.standard_normal(len(parent_of))
           * 10.0 ** rng.integers(-6, 6, len(parent_of))).astype(np.float32)
    js, jm, ps, pm = _join_pair(col, parent_of, n, mode, boost=1.7)
    assert np.array_equal(jm, pm)
    assert np.array_equal(js, ps), mode


@pytest.mark.parametrize("mode", MODES)
def test_join_keeps_the_references_nan_bits(mode):
    """NaN child scores of both signs and two payloads (a script_score
    child reading them from a column), beside infinities and signed zeros,
    three children a parent in every order: the parents' scores carry the
    JAX package's bits."""
    vals = [_f32(0x7FC00000), _f32(0xFFC00000), _f32(0x7FC00003),
            _f32(0xFFC00005), np.float32(1), np.float32(-2),
            np.float32(np.inf), np.float32(-np.inf), np.float32(0.0),
            np.float32(-0.0)]
    rng = np.random.default_rng(0)
    n = 400
    col = rng.choice(np.array(vals, np.float32), size=n * 3).astype(np.float32)
    parent_of = np.repeat(np.arange(n, dtype=np.int32), 3)
    js, jm, ps, pm = _join_pair(col, parent_of, n, mode)
    assert np.array_equal(jm, pm)
    assert np.array_equal(js, ps), [
        (hex(a), hex(b)) for a, b in zip(js, ps) if a != b][:5]


def test_join_plain_batches_rows_and_drops_unmatched_children():
    """Q = 3 rows at once equal the three solo folds; unmatched children
    take no part; a parent without matched children scores 0."""
    rng = np.random.default_rng(4)
    n = 50
    counts = rng.integers(0, 6, n)
    child_start = torch.from_numpy(child_starts(
        np.repeat(np.arange(n, dtype=np.int32), counts), n))
    nn = int(counts.sum())
    cm = torch.from_numpy(rng.random((3, nn)) < 0.6)
    cs = torch.from_numpy(rng.random((3, nn), dtype=np.float32))
    boost = torch.tensor([1.0, 2.0, 0.5])
    for mode in MODES:
        m3, s3 = kernels.doc_join(cm, cs, child_start, boost, mode)
        for r in range(3):
            m1, s1 = kernels.doc_join(cm[r:r + 1].contiguous(),
                                      cs[r:r + 1].contiguous(), child_start,
                                      boost[r:r + 1], mode)
            assert torch.equal(m1[0], m3[r]) and torch.equal(
                s1[0].view(torch.int32), s3[r].view(torch.int32))
        no_child = (counts == 0)
        assert not m3[:, torch.from_numpy(no_child)].any()
        assert (s3[~m3] == 0).all()


def test_mark_matches_the_doc_set_node():
    n = 40
    docs = np.array([3, 7, 7, 39, 0, -1, -1, -1], dtype=np.int32)
    arrays = {"docs": docs, "boost": np.float32(1.5)}
    seg = {"live": jnp.ones(n, bool)}
    js, jm = jax.jit(lambda a: jbd._eval_node(("doc_set", 8), a, seg, n))(arrays)
    ps, pm = pbd._eval_node(("doc_set", 8), pbd._rows1(pbd.plan_to_torch(
        ("doc_set", 8), arrays, "cpu")), {"live": torch.ones(n, dtype=torch.bool)},
        n, 1)
    assert np.array_equal(np.asarray(jm), pm[0].numpy())
    assert np.array_equal(np.asarray(js).view(np.uint32),
                          ps[0].numpy().view(np.uint32))
