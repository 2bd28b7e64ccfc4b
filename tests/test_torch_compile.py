"""The port's query compiler against the JAX package's: on segments built
from the same documents, every query yields the same spec tuple and
array-equal plan arrays (dtype, shape and values)."""

import numpy as np
import pytest

from elasticsearch_tpu.index.mapping import Mappings as JMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JSegmentBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jpack_segment
from elasticsearch_tpu.query.compile import Compiler as JCompiler
from elasticsearch_tpu.query.compile import aggregate_field_stats as jstats
from elasticsearch_tpu.query.dsl import parse_query as jparse
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import pack_segment
from elasticsearch_tpu_torch.query.compile import Compiler, aggregate_field_stats
from elasticsearch_tpu_torch.query.dsl import parse_query

PROPS = {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "rank": {"type": "long"},
    "price": {"type": "double"},
}
VOCAB = [f"w{i}" for i in range(40)]


@pytest.fixture(scope="module")
def compilers():
    rng = np.random.default_rng(3)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    pm, rm = Mappings(PROPS), JMappings(PROPS)
    pb, rb = SegmentBuilder(pm), JSegmentBuilder(rm)
    for i in range(1500):
        doc = {
            "body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 30)), p=probs)),
            "tag": "rare" if i % 97 == 0 else str(rng.choice(["x", "y", "z"])),
            "rank": int(rng.integers(0, 1000)),
        }
        if i % 2:
            doc["price"] = float(rng.random() * 50)
        pb.add(doc, str(i))
        rb.add(doc, str(i))
    ps, rs = pb.build(), rb.build()
    pdev, rdev = pack_segment(ps, device="cpu"), jpack_segment(rs)
    port = Compiler(pdev.fields, pdev.doc_values, pm,
                    stats=aggregate_field_stats([ps]))
    ref = JCompiler(rdev.fields, rdev.doc_values, rm, stats=jstats([rs]))
    return port, ref


def _assert_arrays_equal(a, b, path="arrays"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for key in b:
            _assert_arrays_equal(a[key], b[key], f"{path}.{key}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_arrays_equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        assert np.array_equal(x, y, equal_nan=True), path


QUERIES = [
    {"match": {"body": "w1"}},
    {"match": {"body": "w1 w2 w3"}},
    {"match": {"body": "w0 w0 w5 w9 w13 w21 w34 w0"}},  # 8 terms, duplicates
    {"match": {"body": "W2 absent w7"}},
    {"match": {"body": {"query": "w1 w4 w6", "operator": "and"}}},
    {"match": {"body": {"query": "w3 w8 w9 w10", "minimum_should_match": 3}}},
    {"match": {"body": {"query": "w5", "boost": 2.5}}},
    {"term": {"tag": "x"}},
    {"term": {"body": {"value": "w11", "boost": 0.5}}},
    {"term": {"rank": 17}},
    {"terms": {"tag": ["x", "rare", "nothing"]}},
    {"terms": {"rank": [1, 2, 3]}},
    {"range": {"price": {"gte": 10, "lt": 20.5}}},
    {"range": {"rank": {"gt": 900}}},
    {"exists": {"field": "price"}},
    {"exists": {"field": "tag"}},
    {"exists": {"field": "nosuch"}},
    {"match_all": {"boost": 3}},
    {"match_none": {}},
    {"constant_score": {"filter": {"match": {"body": "w2 w3"}}, "boost": 1.2}},
    {"bool": {"must": [{"match": {"body": "w0 w1"}}],
              "should": [{"match": {"body": "w4"}}],
              "filter": [{"term": {"tag": "y"}},
                         {"range": {"rank": {"lte": 500}}}],
              "must_not": [{"term": {"body": "w30"}}],
              "minimum_should_match": 1, "boost": 1.1}},
    # single-span filter rarer than the must: the filter leads
    {"bool": {"must": [{"match": {"body": "w0 w1 w2"}}],
              "filter": [{"term": {"tag": "rare"}}]}},
    {"bool": {"must": [{"match": {"body": "w39"}}],
              "filter": [{"term": {"tag": "x"}}]}},
    {"bool": {"should": [{"match": {"body": "w1"}}, {"match": {"body": "w2"}},
                         {"term": {"tag": "z"}}]}},
    {"bool": {"filter": [{"terms": {"tag": ["x", "y"]}}],
              "must_not": [{"exists": {"field": "price"}}]}},
]


@pytest.mark.parametrize("body", QUERIES, ids=[str(i) for i in range(len(QUERIES))])
def test_compile_matches_reference(compilers, body):
    port, ref = compilers
    pc = port.compile(parse_query(body))
    rc = ref.compile(jparse(body))
    assert pc.spec == rc.spec
    _assert_arrays_equal(pc.arrays, rc.arrays)


def test_lead_clause_is_chosen_like_reference(compilers):
    port, _ref = compilers
    c = port.compile(parse_query(QUERIES[21]))
    assert c.spec[0] == "bool" and c.spec[6] == 0


def test_query_types_outside_the_slice_raise_parsing_errors():
    for body in ({"fuzzy": {"body": "w1"}}, {"prefix": {"body": "w1"}},
                 {"nosuch": {}}):
        with pytest.raises(ValueError) as pe:
            parse_query(body)
        assert "unknown query type" in str(pe.value)
