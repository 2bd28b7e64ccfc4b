"""Port parity: elasticsearch_tpu_torch.ops.bm25_device against the JAX
package's ops/bm25_device on identical planes and identical plans.

The JAX side packs the segment and compiles each query with its own
compiler; the port gets the very same planes (device_segment_from_numpy)
and the very same plan arrays (plan_to_torch), so this holds the port's
executors — the plain versions of K1-K4 plus the torch composition — to
the reference alone. Tolerance is exact: ids, order and totals equal, fp32
scores bit-equal (compared as int32).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine
from elasticsearch_tpu.index.mapping import Mappings
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.dsl import parse_query
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.ops import bm25_device as tbd

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

VOCAB = [f"w{i:02d}" for i in range(28)]
TAGS = ["red", "green", "blue", "rare"]
K = 10


def _port_segment(handle, live=None):
    tree = jbd.segment_tree(handle.device)
    planes = {
        "fields": {
            name: tuple(np.asarray(x) for x in leaves)
            for name, leaves in tree["fields"].items()
        },
        "doc_values": {
            name: np.asarray(col) for name, col in tree["doc_values"].items()
        },
        "live": np.asarray(tree["live"] if live is None else live),
    }
    meta = {name: field_meta(f) for name, f in handle.device.fields.items()}
    return device_segment_from_numpy(planes, meta, device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    weights = 1.0 / (np.arange(1, len(VOCAB) + 1) ** 1.1)
    probs = weights / weights.sum()
    eng = Engine(
        Mappings(
            properties={
                "body": {"type": "text"},
                "tag": {"type": "keyword"},
                "rank": {"type": "long"},
            }
        )
    )
    for i in range(600):
        n_tokens = int(rng.integers(3, 16))
        eng.index(
            {
                "body": " ".join(rng.choice(VOCAB, n_tokens, p=probs)),
                "tag": "rare" if i % 41 == 0 else str(rng.choice(TAGS[:3])),
                "rank": int(rng.integers(0, 1000)),
            },
            f"d{i}",
        )
    eng.refresh()
    # Deleted docs: the live mask must keep them out of hits and totals.
    for i in range(0, 600, 7):
        eng.delete(f"d{i}")
    eng.refresh()
    assert len(eng.segments) == 1
    handle = eng.segments[0]
    return eng, handle, _port_segment(handle)


def _random_body(rng) -> dict:
    roll = rng.random()
    if roll < 0.3:
        n = int(rng.integers(1, 9))
        return {"match": {"body": " ".join(rng.choice(VOCAB, n))}}
    if roll < 0.4:
        # t_pad > 32: the sparse fold does not cover it; routes dense.
        return {"match": {"body": " ".join(rng.choice(VOCAB, 40))}}
    if roll < 0.5:
        return {
            "bool": {
                "should": [
                    {"match": {"body": " ".join(rng.choice(VOCAB, 2))}}
                    for _ in range(int(rng.integers(2, 4)))
                ]
            }
        }
    clauses: dict = {
        "must": [
            {"match": {"body": " ".join(rng.choice(VOCAB, int(rng.integers(1, 5))))}}
        ]
    }
    r = rng.random()
    if r < 0.45:
        clauses["filter"] = [{"term": {"tag": str(rng.choice(TAGS))}}]
    elif r < 0.75:
        clauses["filter"] = [{"term": {"body": str(rng.choice(VOCAB))}}]
    if rng.random() < 0.3:
        clauses.setdefault("filter", []).append(
            {"range": {"rank": {"gte": int(rng.integers(0, 800))}}}
        )
    if rng.random() < 0.3:
        clauses["must_not"] = [{"term": {"tag": str(rng.choice(TAGS))}}]
    if rng.random() < 0.2:
        clauses.setdefault("filter", []).append(
            {"terms": {"tag": [str(t) for t in rng.choice(TAGS, 2)]}}
        )
    return {"bool": clauses}


def _trim(out):
    s, i, t = (np.asarray(x) for x in out)
    n = min(K, int(t), len(i))
    return s[:n].view(np.int32), i[:n].astype(np.int64), int(t)


def _assert_same(port_out, ref_out, label):
    ps, pi, pt = _trim(tuple(x.numpy() for x in port_out))
    rs, ri, rt = _trim(ref_out)
    assert pt == rt, (label, pt, rt)
    assert pi.tolist() == ri.tolist(), (label, pi, ri)
    assert np.array_equal(ps, rs), (label, ps, rs)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_execute_auto_matches_reference(corpus, seed):
    eng, handle, pseg = corpus
    rng = np.random.default_rng(1000 + seed)
    tree = jbd.segment_tree(handle.device)
    ptree = tbd.segment_tree(pseg)
    compiler = eng.compiler_for(handle)
    for _ in range(8):
        body = _random_body(rng)
        c = compiler.compile(parse_query(body))
        ref = jbd.execute_auto(tree, c.spec, c.arrays, K)
        plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
        _assert_same(tbd.execute_auto(ptree, c.spec, plan, K), ref, body)
        # Every path the port has for the spec agrees with the reference.
        _assert_same(tbd.execute(ptree, c.spec, plan, K), ref, ("dense", body))
        if tbd.supports_sparse(c.spec):
            _assert_same(
                tbd.execute_sparse(ptree, c.spec, plan, K), ref, ("sparse", body)
            )
        assert tbd.supports_sparse(c.spec) == jbd.supports_sparse(c.spec)


def test_full_outputs_equal_including_padding(corpus):
    """Beyond the trimmed hits, the whole (scores, ids, total) triple —
    -inf tail slots included — equals the reference's."""
    eng, handle, pseg = corpus
    tree = jbd.segment_tree(handle.device)
    ptree = tbd.segment_tree(pseg)
    compiler = eng.compiler_for(handle)
    for body in (
        {"match": {"body": "w27 w26"}},
        {"bool": {"must": [{"match": {"body": "w03 w27"}}],
                  "filter": [{"term": {"tag": "rare"}}]}},
        {"bool": {"should": [{"match": {"body": "w26"}},
                             {"match": {"body": "w27"}}]}},
    ):
        c = compiler.compile(parse_query(body))
        plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
        for k in (10, 2000):
            rs, ri, rt = (np.asarray(x) for x in jbd.execute_auto(tree, c.spec, c.arrays, k))
            ps, pi, pt = (x.numpy() for x in tbd.execute_auto(ptree, c.spec, plan, k))
            assert ps.view(np.int32).tolist() == rs.view(np.int32).tolist(), body
            assert pi.tolist() == ri.tolist(), body
            assert int(pt) == int(rt)


def test_lead_and_gather_paths(corpus):
    """The filter-led conjunction (K4) and the custom-statistics gather
    variant of K1 (non-default avgdl) against the reference."""
    eng, handle, pseg = corpus
    tree = jbd.segment_tree(handle.device)
    ptree = tbd.segment_tree(pseg)
    from elasticsearch_tpu.query.compile import Compiler, FieldStats

    lead_body = {"bool": {"must": [{"match": {"body": "w00 w01 w05"}}],
                          "filter": [{"term": {"tag": "rare"}}]}}
    c = eng.compiler_for(handle).compile(parse_query(lead_body))
    assert c.spec[6] >= 0  # the selective filter leads
    plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
    _assert_same(tbd.execute_auto(ptree, c.spec, plan, K),
                 jbd.execute_auto(tree, c.spec, c.arrays, K), "lead")
    stats = {"body": FieldStats(doc_count=900, avgdl=7.25)}
    gc = Compiler(handle.device.fields, handle.device.doc_values, eng.mappings,
                  stats=stats)
    for body in ({"match": {"body": "w00 w02 w09"}},
                 {"bool": {"should": [{"match": {"body": "w04"}},
                                      {"term": {"body": "w11"}}]}}):
        c = gc.compile(parse_query(body))
        assert "terms_gather" in repr(c.spec)
        plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
        _assert_same(tbd.execute_auto(ptree, c.spec, plan, K),
                     jbd.execute_auto(tree, c.spec, c.arrays, K), body)


def test_all_constant_and_empty_kinds(corpus):
    eng, handle, pseg = corpus
    tree = jbd.segment_tree(handle.device)
    ptree = tbd.segment_tree(pseg)
    compiler = eng.compiler_for(handle)
    for body in (
        {"match_all": {"boost": 1.5}},
        {"match_none": {}},
        {"exists": {"field": "tag"}},
        {"exists": {"field": "rank"}},
        {"range": {"rank": {"gte": 100, "lt": 400}}},
        {"constant_score": {"filter": {"term": {"tag": "blue"}}, "boost": 2.0}},
        {"terms": {"tag": ["red", "rare"]}},
        {"match": {"body": "absentterm"}},
        {"bool": {"must": [{"match": {"body": "w01"}}],
                  "should": [{"match": {"body": "w02 w03"}}],
                  "minimum_should_match": 1}},
    ):
        c = compiler.compile(parse_query(body))
        plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
        _assert_same(tbd.execute_auto(ptree, c.spec, plan, K),
                     jbd.execute_auto(tree, c.spec, c.arrays, K), body)


def test_plan_to_torch_keeps_dtypes_and_groups(corpus):
    eng, handle, _pseg = corpus
    c = eng.compiler_for(handle).compile(parse_query({"match": {"body": "w01 w01 w02"}}))
    plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
    for key in ("tile_ids", "starts", "ends", "weights"):
        assert plan[key].dtype == torch.from_numpy(np.asarray(c.arrays[key])).dtype
        assert np.array_equal(plan[key].numpy(), np.asarray(c.arrays[key]))
    groups = plan["_groups"]
    assert len(groups) == 3  # one launch group per term occurrence
