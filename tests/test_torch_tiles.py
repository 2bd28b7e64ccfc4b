"""Port host index modules against the JAX package's: SegmentBuilder
arrays, the Zipf corpus generator, pack_segment planes, and the
device_segment_from_numpy round trip. Exact equality throughout."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import Mappings as JMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JSegmentBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jpack_segment
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.utils.corpus import build_zipf_segment as jzipf
from elasticsearch_tpu.utils.corpus import pick_query_terms as jpick
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import (
    TILE,
    device_nbytes,
    device_segment_from_numpy,
    field_meta,
    pack_segment,
)
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment, pick_query_terms

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

PROPS = {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "rank": {"type": "long"},
    "score": {"type": "float"},
}
FIELD_ATTRS = ("df", "offsets", "doc_ids", "tfs", "norm_bytes", "present")


def _docs(seed, n=400):
    rng = np.random.default_rng(seed)
    words = ["Alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "the",
             "Über", "naïve", "x1", "2024"]
    out = []
    for i in range(n):
        doc = {"body": " ".join(rng.choice(words, int(rng.integers(0, 12)))),
               "tag": str(rng.choice(["a", "b", "c d"]))}
        if i % 4:
            doc["rank"] = int(rng.integers(-5, 100))
        if i % 3 == 0:
            doc["score"] = float(rng.random())
        if i % 7 == 0:
            doc["note"] = "dynamic " + str(rng.choice(words))  # text + .keyword
        if i % 11 == 0:
            doc["count"] = int(i)  # dynamic long
        out.append(doc)
    return out


def _assert_fields_equal(port_seg, ref_seg):
    assert sorted(port_seg.fields) == sorted(ref_seg.fields)
    for name, rf in ref_seg.fields.items():
        pf = port_seg.fields[name]
        assert pf.terms == rf.terms, name
        for attr in FIELD_ATTRS:
            a, b = getattr(pf, attr), getattr(rf, attr)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, attr)
        assert (pf.doc_count, pf.sum_total_tf, pf.has_norms) == (
            rf.doc_count, rf.sum_total_tf, rf.has_norms), name


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_builder_matches_reference(seed):
    pb, rb = SegmentBuilder(Mappings(PROPS)), JSegmentBuilder(JMappings(PROPS))
    for i, doc in enumerate(_docs(seed)):
        assert pb.add(doc, f"id{i}", seqno=i) == rb.add(doc, f"id{i}", seqno=i)
    ps, rs = pb.build(), rb.build()
    assert ps.num_docs == rs.num_docs and ps.ids == rs.ids
    assert np.array_equal(ps.versions, rs.versions)
    assert np.array_equal(ps.seqnos, rs.seqnos)
    _assert_fields_equal(ps, rs)
    assert sorted(ps.doc_values) == sorted(rs.doc_values)
    for name, col in rs.doc_values.items():
        assert np.array_equal(ps.doc_values[name], col, equal_nan=True), name


def test_segment_builder_rejects_atomically():
    b = SegmentBuilder(Mappings(PROPS))
    b.add({"body": "ok", "rank": 3})
    with pytest.raises(ValueError):
        b.add({"body": "bad", "rank": "not a number"})
    assert b.num_docs == 1
    seg = b.build()
    assert seg.fields["body"].terms == {"ok": 0}


@pytest.mark.parametrize("seed", [3, 13])
def test_zipf_segment_identical_for_same_seed(seed):
    _, ps = build_zipf_segment(3000, vocab_size=800, seed=seed)
    _, rs = jzipf(3000, vocab_size=800, seed=seed)
    assert ps.ids == rs.ids
    _assert_fields_equal(ps, rs)
    pq = pick_query_terms(ps, np.random.default_rng(seed), 6)
    rq = jpick(rs, np.random.default_rng(seed), 6)
    assert pq == rq


def _ref_planes(ref_dev):
    tree = jbd.segment_tree(ref_dev)
    return {
        "fields": {n: tuple(np.asarray(x) for x in leaves)
                   for n, leaves in tree["fields"].items()},
        "doc_values": {n: np.asarray(c) for n, c in tree["doc_values"].items()},
        "live": np.asarray(tree["live"]),
    }


def test_pack_segment_planes_equal_reference():
    props = dict(PROPS)
    pb, rb = SegmentBuilder(Mappings(props)), JSegmentBuilder(JMappings(props))
    for i, doc in enumerate(_docs(5, 700)):
        pb.add(doc, str(i))
        rb.add(doc, str(i))
    ps, rs = pb.build(), rb.build()
    deleted = np.array([3, 10, 99])
    pdev = pack_segment(ps, device="cpu", deleted=deleted)
    rdev = jpack_segment(rs, deleted=deleted)
    ref = _ref_planes(rdev)
    port = tbd.segment_tree(pdev)
    assert sorted(port["fields"]) == sorted(ref["fields"])
    for name, leaves in ref["fields"].items():
        for i, (p, r) in enumerate(zip(port["fields"][name], leaves)):
            assert p.numpy().dtype == r.dtype, (name, i)
            assert np.array_equal(p.numpy(), r), (name, i)
        pf, rf = pdev.fields[name], rdev.fields[name]
        assert pf.doc_ids.shape[1] == TILE
        for attr in ("tile_max", "tile_doc_lo", "tile_doc_hi"):
            assert np.array_equal(getattr(pf, attr), getattr(rf, attr)), attr
        assert (pf.tn_avgdl, pf.tn_k1, pf.tn_b) == (rf.tn_avgdl, rf.tn_k1, rf.tn_b)
        assert pf.pad_tile == rf.pad_tile
    for name, col in ref["doc_values"].items():
        assert np.array_equal(port["doc_values"][name].numpy(), col, equal_nan=True)
    assert np.array_equal(port["live"].numpy(), ref["live"])


def test_device_segment_from_numpy_round_trips():
    _, seg = build_zipf_segment(1500, vocab_size=300, seed=2)
    dev = pack_segment(seg, device="cpu")
    tree = tbd.segment_tree(dev)
    planes = {
        "fields": {n: tuple(x.numpy() for x in leaves)
                   for n, leaves in tree["fields"].items()},
        "doc_values": {},
        "live": tree["live"].numpy(),
    }
    meta = {n: field_meta(f) for n, f in dev.fields.items()}
    back = device_segment_from_numpy(planes, meta, seg.sources, seg.ids, device="cpu")
    assert back.num_docs == dev.num_docs and back.ids == dev.ids
    for name, f in dev.fields.items():
        g = back.fields[name]
        for attr in ("doc_ids", "tn", "tfs", "norm_bytes", "present"):
            a, b = getattr(f, attr), getattr(g, attr)
            assert a.dtype == b.dtype and torch.equal(a, b), attr
        assert field_meta(g).keys() == field_meta(f).keys()
        for key, val in field_meta(f).items():
            other = field_meta(g)[key]
            if isinstance(val, np.ndarray):
                assert np.array_equal(val, other), key
            else:
                assert val == other, key
    assert torch.equal(back.live, dev.live)


def test_device_segment_from_numpy_carries_nested_and_structured_columns():
    """The JAX package's planes of a segment with nested blocks and the geo,
    rank_feature and `req` columns, moved with device_segment_from_numpy:
    every column, the inner segment's planes, parent_of and the derived
    child_start equal the port's own pack of the port's own build."""
    from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
    from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
    from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
    from elasticsearch_tpu.ops import bm25_device as jbd
    from elasticsearch_tpu_torch.index.mapping import Mappings
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder

    props = {"title": {"type": "text"}, "loc": {"type": "geo_point"},
             "pr": {"type": "rank_feature"}, "req": {"type": "integer"},
             "answers": {"type": "nested", "properties": {
                 "body": {"type": "text"}, "votes": {"type": "long"}}}}
    rng = np.random.default_rng(3)
    docs = []
    for i in range(40):
        d = {"title": " ".join(rng.choice(["a", "b", "c", "d"], 3)),
             "req": int(rng.integers(1, 4)), "pr": float(rng.random() + 0.1)}
        if i % 3:
            d["loc"] = [float(rng.uniform(-180, 180)), float(rng.uniform(-60, 70))]
        d["answers"] = [{"body": str(rng.choice(["x y", "y z"])),
                         "votes": int(rng.integers(0, 9))}
                        for _ in range(int(rng.integers(0, 4)))]
        docs.append(d)
    jb, pb = JaxBuilder(JaxMappings(properties=props)), SegmentBuilder(
        Mappings(properties=props))
    for i, d in enumerate(docs):
        jb.add(d, f"d{i}")
        pb.add(d, f"d{i}")
    jdev = jax_pack(jb.build())
    pdev = pack_segment(pb.build(), device="cpu")

    def planes(tree):
        return {"fields": {n: [np.asarray(x) for x in v]
                           for n, v in tree["fields"].items()},
                "positions": {n: [np.asarray(x) for x in v]
                              for n, v in tree["positions"].items()},
                "doc_values": {n: np.asarray(v)
                               for n, v in tree["doc_values"].items()},
                "live": np.asarray(tree["live"]),
                "nested": {p: {"tree": planes(b["tree"]),
                               "parent_of": np.asarray(b["parent_of"])}
                           for p, b in tree["nested"].items()}}

    meta = {n: field_meta(f) for n, f in jdev.fields.items()}
    for inner, _parent_of in jdev.nested.values():
        meta.update({n: field_meta(f) for n, f in inner.fields.items()})
    back = device_segment_from_numpy(planes(jbd.segment_tree(jdev)), meta,
                                     device="cpu")

    def same(a, b):
        assert sorted(a.doc_values) == sorted(b.doc_values) == sorted(
            set(a.doc_values))
        for name, col in a.doc_values.items():
            assert torch.equal(col.isnan(), b.doc_values[name].isnan()), name
            assert torch.equal(col.nan_to_num(), b.doc_values[name].nan_to_num())
        for name, f in a.fields.items():
            for attr in ("doc_ids", "tn", "tfs", "norm_bytes", "present"):
                assert torch.equal(getattr(f, attr), getattr(b.fields[name], attr))
        assert torch.equal(a.live, b.live)

    same(back, pdev)
    assert {"loc.lat", "loc.lon", "pr", "req"} <= set(back.doc_values)
    assert sorted(back.nested) == sorted(pdev.nested) == ["answers"]
    (bi, bp, bc), (pi, pp, pc) = back.nested["answers"], pdev.nested["answers"]
    same(bi, pi)
    assert torch.equal(bp, pp) and torch.equal(bc, pc)
    assert bc.dtype == torch.int32 and bc.shape[0] == back.num_docs + 1
    assert device_nbytes(back) == device_nbytes(pdev)
