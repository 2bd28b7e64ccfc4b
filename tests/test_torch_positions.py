"""Port positions against the JAX package: the analyzer's (token,
position) pairs, the segment's CSR position arrays and the packed
positional planes, built by each package from the same documents.

Tolerance: exact everywhere (integer arrays; no arithmetic on this path).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry as JaxRegistry
from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import (
    POSITION_INCREMENT_GAP,
    SegmentBuilder,
)
from elasticsearch_tpu_torch.index.tiles import (
    device_segment_from_numpy,
    field_meta,
    pack_segment,
    position_bits,
)

torch.set_num_threads(1)

CUSTOM = {"stops": {"tokenizer": "standard", "filter": ["lowercase", "stop"]},
          "ws_stop": {"tokenizer": "whitespace", "filter": ["stop"]},
          "folded": {"tokenizer": "standard",
                     "filter": ["lowercase", "asciifolding", "stop"]}}

TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "jump the fence",
    "a an and are as at be",
    "",
    "   ",
    "Héllo Wörld, it is the café",
    "x1 y2 x1 x1 the end",
    "ONE two THREE two one",
]


@pytest.mark.parametrize("analyzer", ["standard", "whitespace", "keyword",
                                      "stops", "ws_stop", "folded"])
@pytest.mark.parametrize("text", TEXTS)
def test_analyze_positions_match_the_reference(analyzer, text):
    port = AnalysisRegistry(CUSTOM).get(analyzer)
    ref = JaxRegistry(CUSTOM).get(analyzer)
    assert port.analyze_positions(text) == ref.analyze_positions(text)


def test_stop_words_leave_gaps():
    pairs, span = AnalysisRegistry(CUSTOM).get("stops").analyze_positions(
        "jump the fence")
    assert pairs == [("jump", 0), ("fence", 2)] and span == 3


PROPS = {
    "body": {"type": "text"},
    "title": {"type": "text", "analyzer": "stops"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
}


def _docs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    words = ["quick", "brown", "fox", "the", "lazy", "dog", "a", "jumps"]
    out = []
    for i in range(n):
        d = {"tag": str(rng.choice(["x", "y z"])), "n": int(i)}
        k = int(rng.integers(0, 9))
        text = " ".join(rng.choice(words, k))
        if i % 7 == 0:
            d["body"] = [text, " ".join(rng.choice(words, 3)), "the"]
        elif i % 11 == 0:
            d["body"] = ""  # zero tokens
        else:
            d["body"] = text
        if i % 3:
            d["title"] = " ".join(rng.choice(words, int(rng.integers(1, 6))))
        out.append(d)
    return out


def _build(docs):
    jb = JaxBuilder(JaxMappings(properties=PROPS, analysis=JaxRegistry(CUSTOM)))
    pb = SegmentBuilder(Mappings(properties=PROPS, analysis=AnalysisRegistry(CUSTOM)))
    for i, d in enumerate(docs):
        jb.add(d, f"d{i}")
        pb.add(d, f"d{i}")
    return jb.build(), pb.build()


@pytest.fixture(scope="module")
def segments():
    return _build(_docs(5, 90))


@pytest.mark.parametrize("field", ["body", "title", "tag"])
def test_segment_positions_match_the_reference(segments, field):
    jseg, pseg = segments
    jf, pf = jseg.fields[field], pseg.fields[field]
    if jf.positions is None:
        assert pf.positions is None and pf.pos_offsets is None
        return
    assert pf.positions.dtype == jf.positions.dtype
    assert pf.pos_offsets.dtype == jf.pos_offsets.dtype
    np.testing.assert_array_equal(pf.pos_offsets, jf.pos_offsets)
    np.testing.assert_array_equal(pf.positions, jf.positions)
    for term in list(jf.terms)[:6]:
        for doc in range(0, jseg.num_docs, 9):
            np.testing.assert_array_equal(pf.term_positions(term, doc),
                                          jf.term_positions(term, doc))


def test_multi_valued_field_positions_are_gap_apart():
    _jseg, pseg = _build([{"body": ["hello world", "goodbye moon"]},
                          {"body": ["hello", "world"]}])
    fld = pseg.fields["body"]
    assert list(fld.term_positions("world", 1)) == [1 + POSITION_INCREMENT_GAP]
    assert list(fld.term_positions("goodbye", 0)) == [2 + POSITION_INCREMENT_GAP]


def test_zero_token_field_keeps_empty_position_arrays():
    jseg, pseg = _build([{"body": ""}, {"body": "the", "title": "the a"}])
    for name in ("body", "title"):
        jf, pf = jseg.fields[name], pseg.fields[name]
        assert pf.positions is not None and len(pf.positions) == len(jf.positions)
        np.testing.assert_array_equal(pf.pos_offsets, jf.pos_offsets)
    assert len(pseg.fields["title"].positions) == 0


def test_keyword_field_is_positionless(segments):
    _jseg, pseg = segments
    assert not pseg.fields["tag"].has_positions
    assert pseg.fields["body"].has_positions


@pytest.mark.parametrize("min_tiles", [0, 9])
def test_packed_planes_match_the_reference(segments, min_tiles):
    """The positional planes and spans, also with the postings tile axis
    padded for stacking (which leaves the positional planes as they are)."""
    jseg, pseg = segments
    jd = jax_pack(jseg, field_min_tiles={"body": min_tiles})
    pd = pack_segment(pseg, device="cpu", field_min_tiles={"body": min_tiles})
    for name in ("body", "title"):
        jf, pf = jd.fields[name], pd.fields[name]
        np.testing.assert_array_equal(pf.pos_doc.numpy(), np.asarray(jf.pos_doc))
        np.testing.assert_array_equal(pf.pos_val.numpy(), np.asarray(jf.pos_val))
        assert pf.pos_doc.dtype == pf.pos_val.dtype == torch.int32
        assert pf.pos_pad_tile == jf.pos_pad_tile
        for term in jf.terms:
            assert pf.term_pos_span(term) == jf.term_pos_span(term)
        assert pf.term_pos_span("absent") == jf.term_pos_span("absent") == (0, 0)
        assert pf.pos_bits == position_bits(jseg.fields[name].positions)
    assert pd.fields["tag"].pos_doc is None and jd.fields["tag"].pos_doc is None
    if min_tiles:
        assert pd.fields["body"].doc_ids.shape[0] == min_tiles
    assert pd.fields["body"].pos_doc.shape == jd.fields["body"].pos_doc.shape


def test_position_planes_through_device_segment_from_numpy(segments):
    """The parity harness's route: the JAX package's planes moved into a
    port DeviceSegment carry the same positional planes and spans."""
    from elasticsearch_tpu.ops import bm25_device as jbd

    jseg, pseg = segments
    jd = jax_pack(jseg)
    tree = jbd.segment_tree(jd)
    moved = device_segment_from_numpy(
        {"fields": {k: [np.asarray(x) for x in v]
                    for k, v in tree["fields"].items()},
         "positions": {k: [np.asarray(x) for x in v]
                       for k, v in tree["positions"].items()},
         "live": np.asarray(tree["live"])},
        {name: field_meta(f) for name, f in jd.fields.items()},
        device="cpu",
    )
    pd = pack_segment(pseg, device="cpu")
    for name in ("body", "title"):
        assert torch.equal(moved.fields[name].pos_doc, pd.fields[name].pos_doc)
        assert torch.equal(moved.fields[name].pos_val, pd.fields[name].pos_val)
        assert moved.fields[name].pos_bits == pd.fields[name].pos_bits
        assert moved.fields[name].term_pos_span("fox") == \
            pd.fields[name].term_pos_span("fox")


def test_device_nbytes_counts_the_positional_planes(segments):
    from elasticsearch_tpu.index.tiles import device_nbytes as jax_nbytes
    from elasticsearch_tpu_torch.index.tiles import device_nbytes

    jseg, pseg = segments
    pd = pack_segment(pseg, device="cpu")
    planes = sum(f.pos_doc.nbytes + f.pos_val.nbytes
                 for f in pd.fields.values() if f.pos_doc is not None)
    assert planes > 0
    jd = jax_pack(jseg)
    jax_planes = sum(np.asarray(f.pos_doc).nbytes + np.asarray(f.pos_val).nbytes
                     for f in jd.fields.values() if f.pos_doc is not None)
    assert planes == jax_planes
    assert device_nbytes(pd) >= planes
    assert jax_nbytes(jd) >= jax_planes
