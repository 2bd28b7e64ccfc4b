"""The port's tokenization-free merge (index/merge.py) against the JAX
package's, field by field: `compact_segment` over several live masks,
`concat_segments` over several members (with fields some members lack,
positions, doc values, vectors and nested blocks), `merged_live_segment`,
and, as the reference's own merge tests hold it, equality with a fresh
SegmentBuilder re-add of the same live docs in the same order. Exact:
every array, dtype included.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index import merge as jmerge
from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu_torch.index import merge
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder

WORDS = ["ant", "bee", "cat", "dog", "elk", "fox", "gnu", "hen", "ibis"]
PROPS = {
    "body": {"type": "text"},
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
    "vec": {"type": "dense_vector", "dims": 3, "similarity": "l2_norm"},
    "qa": {"type": "nested", "properties": {"a": {"type": "text"}}},
}


def _docs(seed: int, n: int) -> list[tuple[str, dict]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {"body": " ".join(rng.choice(WORDS, int(rng.integers(1, 9))))}
        if rng.random() < 0.6:
            doc["tag"] = [str(t) for t in rng.choice(["x", "y", "z"], 2)]
        if rng.random() < 0.5:
            doc["title"] = " ".join(rng.choice(WORDS[:4], 2))
        if rng.random() < 0.7:
            doc["price"] = int(rng.integers(0, 50))
        if rng.random() < 0.5:
            doc["vec"] = [float(v) for v in rng.normal(size=3)]
        if rng.random() < 0.4:
            doc["qa"] = [{"a": str(rng.choice(WORDS))}
                         for _ in range(int(rng.integers(1, 3)))]
        out.append((f"{seed}-{i}", doc))
    return out


def _build(builder, mappings, docs):
    b = builder(mappings)
    for doc_id, src in docs:
        b.add(src, doc_id)
    return b.build()


def _pair(docs):
    return (_build(SegmentBuilder, Mappings(properties=PROPS), docs),
            _build(JaxBuilder, JaxMappings(properties=PROPS), docs))


def _same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


def same_segment(p, r, where="segment"):
    """Every field of two segments (port, reference) is equal."""
    assert p.num_docs == r.num_docs, where
    assert p.ids == r.ids and p.sources == r.sources, where
    _same_array(p.versions, r.versions, f"{where}.versions")
    _same_array(p.seqnos, r.seqnos, f"{where}.seqnos")
    assert sorted(p.fields) == sorted(r.fields), where
    for name, pf in p.fields.items():
        rf = r.fields[name]
        w = f"{where}.{name}"
        assert pf.terms == rf.terms and list(pf.terms) == list(rf.terms), w
        for attr in ("df", "offsets", "doc_ids", "tfs", "norm_bytes",
                     "present", "pos_offsets", "positions"):
            _same_array(getattr(pf, attr), getattr(rf, attr), f"{w}.{attr}")
        assert (pf.doc_count, pf.sum_total_tf, pf.has_norms) == (
            rf.doc_count, rf.sum_total_tf, rf.has_norms), w
    assert sorted(p.doc_values) == sorted(r.doc_values), where
    for name in p.doc_values:
        _same_array(p.doc_values[name], r.doc_values[name], f"{where}.dv")
    assert sorted(p.vectors) == sorted(r.vectors), where
    for name in p.vectors:
        _same_array(p.vectors[name], r.vectors[name], f"{where}.vec")
    assert sorted(p.nested) == sorted(r.nested), where
    for path, pb in p.nested.items():
        rb = r.nested[path]
        _same_array(pb.parent_of, rb.parent_of, f"{where}.{path}.parent_of")
        same_segment(pb.seg, rb.seg, f"{where}.{path}")


MASKS = ["all", "none", "even", "random", "first"]


def _mask(kind: str, n: int) -> np.ndarray:
    if kind == "all":
        return np.ones(n, dtype=bool)
    if kind == "none":
        return np.zeros(n, dtype=bool)
    if kind == "even":
        return np.arange(n) % 2 == 0
    if kind == "first":
        return np.arange(n) == 0
    return np.random.default_rng(n).random(n) < 0.6


@pytest.mark.parametrize("kind", MASKS)
def test_compact_segment_matches_reference(kind):
    p, r = _pair(_docs(1, 40))
    live = _mask(kind, p.num_docs)
    same_segment(merge.compact_segment(p, live),
                 jmerge.compact_segment(r, live))


@pytest.mark.parametrize("n_members", [0, 1, 2, 4])
def test_concat_segments_matches_reference(n_members):
    pairs = [_pair(_docs(10 + m, 5 + 7 * m)) for m in range(n_members)]
    # A member without the title field and one without vectors.
    if n_members > 2:
        pairs[1] = _pair([(i, {k: v for k, v in d.items() if k != "title"})
                          for i, d in _docs(30, 9)])
    same_segment(merge.concat_segments([p for p, _r in pairs]),
                 jmerge.concat_segments([r for _p, r in pairs]))


@pytest.mark.parametrize("kind", ["all", "even", "random"])
def test_merged_live_segment_equals_a_fresh_build(kind):
    members = [_docs(20 + m, 12 + 5 * m) for m in range(3)]
    pairs = [_pair(d) for d in members]
    masks = [_mask(kind, p.num_docs) for p, _r in pairs]
    got = merge.merged_live_segment([p for p, _r in pairs], masks)
    want = jmerge.merged_live_segment([r for _p, r in pairs], masks)
    same_segment(got, want)
    live_docs = [doc for d, m in zip(members, masks)
                 for doc, keep in zip(d, m) if keep]
    fresh = _build(SegmentBuilder, Mappings(properties=PROPS), live_docs)
    # A re-add stamps version 1; the merge keeps each doc's version.
    assert got.num_docs == fresh.num_docs
    for name, f in fresh.fields.items():
        for attr in ("terms", "df", "offsets", "doc_ids", "tfs",
                     "norm_bytes", "positions", "pos_offsets"):
            a, b = getattr(got.fields[name], attr), getattr(f, attr)
            if isinstance(a, dict):
                assert a == b
            else:
                _same_array(a, b, f"{name}.{attr}")
