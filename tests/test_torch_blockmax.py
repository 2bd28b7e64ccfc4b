"""Port block-max execution against the JAX package:
`execute_batch_blockmax`, `execute_batch_blockmax_conj` and
`execute_shards_blockmax_conj` on the same host plans.

A skewed Zipf corpus whose head-term worklists span many tiles makes the
host prune fire (relation "gte"); tiny worklists take the one-launch
path (`a_bucket >= nt`, relation "eq"). Tolerance: none — ids, order,
fp32 score bits, totals, the relation string and the pruned fractions
handed to `instruments` are equal.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.tiles import pack_segment as jpack_segment
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.compile import Compiler as JCompiler
from elasticsearch_tpu.query.compile import equalize_compiled as jequalize
from elasticsearch_tpu.query.dsl import parse_query as jparse
from elasticsearch_tpu.utils.corpus import build_zipf_segment as jzipf
from elasticsearch_tpu_torch.index.tiles import TILE, pack_segment
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.query.compile import Compiler, equalize_compiled
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)


class Recorder:
    """An `instruments` object: keeps every pruned fraction it is given."""

    def __init__(self):
        self.fractions = []

    def blockmax_pruned(self, fraction):
        self.fractions.append(float(fraction))


@pytest.fixture(scope="module")
def corpus():
    """One segment whose head-term worklists span >= 16 tiles, packed by
    both packages."""
    pmap, pseg = build_zipf_segment(30_000, vocab_size=2_000, seed=11)
    jmap, jseg = jzipf(30_000, vocab_size=2_000, seed=11)
    pdev = pack_segment(pseg, device="cpu")
    jdev = jpack_segment(jseg)
    return {
        "seg": pseg,
        "ptree": tbd.segment_tree(pdev), "jtree": jbd.segment_tree(jdev),
        "pcomp": Compiler(pdev.fields, pdev.doc_values, pmap),
        "jcomp": JCompiler(jdev.fields, jdev.doc_values, jmap),
    }


@pytest.fixture(scope="module")
def shards():
    """Four uneven shards of that corpus's shape, stacked as bench.py
    stacks cfg3's."""
    import jax

    sizes = (9_000, 7_600, 6_100, 400)
    psegs = [build_zipf_segment(n, vocab_size=2_000, seed=60 + s)
             for s, n in enumerate(sizes)]
    jsegs = [jzipf(n, vocab_size=2_000, seed=60 + s) for s, n in enumerate(sizes)]
    n_pad = max(sizes)
    min_tiles = {"body": max(len(s.fields["body"].doc_ids) // TILE + 2
                             for _m, s in psegs)}
    pdevs = [pack_segment(s, device="cpu", pad_docs_to=n_pad,
                          field_min_tiles=min_tiles) for _m, s in psegs]
    jdevs = [jpack_segment(s, pad_docs_to=n_pad, field_min_tiles=min_tiles)
             for _m, s in jsegs]
    return {
        "seg": psegs[0][1], "n_pad": n_pad,
        "pmap": psegs[0][0], "jmap": jsegs[0][0],
        "pdevs": pdevs, "jdevs": jdevs,
        "ptree": tbd.stack_segment_trees([tbd.segment_tree(d) for d in pdevs]),
        "jtree": jax.tree.map(lambda *xs: np.stack(xs),
                              *[jbd.segment_tree(d) for d in jdevs]),
    }


def _by_df(seg):
    fld = seg.fields["body"]
    return sorted(fld.terms, key=lambda t: (-fld.df[fld.terms[t]], t))


def _match(seg, ranks):
    return {"match": {"body": " ".join(_by_df(seg)[r] for r in ranks)}}


def _conj(seg, must_ranks, filter_rank, boost=None):
    by_df = _by_df(seg)
    clauses = {
        "must": [{"match": {"body": " ".join(by_df[r] for r in must_ranks)}}],
        "filter": [{"term": {"body": by_df[filter_rank]}}],
    }
    if boost is not None:
        clauses["boost"] = boost
    return {"bool": clauses}


def _assert_same(got, ref):
    *g_arrays, g_rel = got
    *r_arrays, r_rel = ref
    assert g_rel == r_rel
    for g, r in zip(g_arrays, r_arrays):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape)
        if g.dtype == np.float32:
            g, r = g.view(np.int32), r.view(np.int32)
        np.testing.assert_array_equal(g, r)


def _group(compiler, bodies, parse, equalize):
    return equalize([compiler.compile(parse(b)) for b in bodies])


# Disjunctions of head and mid terms (wide worklists, pruning) and of tail
# terms (a worklist of <= 8 tiles: one launch, "eq").
MATCH_SETS = {
    "head": [(0, 1, 30, 200), (2, 5, 90, 400), (0, 3, 7, 60), (1, 4, 33, 150)],
    "tail": [(1500, 1700), (1800, 1900), (1600, 1950), (1990, 1520)],
}


@pytest.mark.parametrize("which", sorted(MATCH_SETS))
@pytest.mark.parametrize("k", [1, 3, 10])
def test_execute_batch_blockmax_equals_reference(corpus, which, k):
    bodies = [_match(corpus["seg"], r) for r in MATCH_SETS[which]]
    pc = _group(corpus["pcomp"], bodies, parse_query, equalize_compiled)
    jc = _group(corpus["jcomp"], bodies, jparse, jequalize)
    spec = pc[0].spec
    assert spec == jc[0].spec and spec[0] == "terms"
    p_rec, j_rec = Recorder(), Recorder()
    got = tbd.execute_batch_blockmax(corpus["ptree"], spec,
                                     [c.arrays for c in pc], k, instruments=p_rec)
    ref = jbd.execute_batch_blockmax(corpus["jtree"], spec,
                                     [c.arrays for c in jc], k, instruments=j_rec)
    _assert_same(got, ref)
    assert p_rec.fractions == j_rec.fractions
    if which == "tail":
        assert max(8, spec[2] // 4) >= spec[2] and got[3] == "eq"
    elif k == 1:
        assert got[3] == "gte" and max(p_rec.fractions) > 0
    # Exact top-k against the one-launch sparse path; totals are lower
    # bounds.
    exact = tbd.execute_batch_sparse(
        corpus["ptree"], spec,
        tbd.plan_to_torch(spec, tbd.stack_plans([c.arrays for c in pc]), "cpu"), k)
    s_e, i_e, t_e = (x.numpy() for x in exact)
    for row in range(len(bodies)):
        n = min(k, int(t_e[row]))
        assert np.array_equal(got[0][row][:n].view(np.int32), s_e[row][:n].view(np.int32))
        assert np.array_equal(got[1][row][:n], i_e[row][:n])
        assert got[2][row] <= t_e[row]
        if got[3] == "eq":
            assert got[2][row] == t_e[row]


CONJ_CASES = [
    ((40, 70), 3, None),
    ((25, 90, 140), 5, None),
    ((60, 61), 1, None),
    ((40, 70), 3, 2.5),  # θ in the boosted space: bounds scale by the boost
    ((25, 90, 140), 5, 0.25),
    ((40, 70), 3, 0.0),  # boost <= 0: no pruning
    ((1500, 1700), 3, None),  # a tiny must worklist: one launch, "eq"
]


@pytest.mark.parametrize("case", range(len(CONJ_CASES)))
@pytest.mark.parametrize("k", [1, 3])
def test_execute_batch_blockmax_conj_equals_reference(corpus, case, k):
    must, filt, boost = CONJ_CASES[case]
    body = _conj(corpus["seg"], must, filt, boost)
    pc = corpus["pcomp"].compile(parse_query(body))
    jc = corpus["jcomp"].compile(jparse(body))
    assert pc.spec == jc.spec
    assert tbd.supports_blockmax_conj(pc.spec) == jbd.supports_blockmax_conj(jc.spec)
    assert tbd.supports_blockmax_conj(pc.spec), pc.spec
    p_rec, j_rec = Recorder(), Recorder()
    got = tbd.execute_batch_blockmax_conj(corpus["ptree"], pc.spec, [pc.arrays],
                                          k, instruments=p_rec)
    ref = jbd.execute_batch_blockmax_conj(corpus["jtree"], jc.spec, [jc.arrays],
                                          k, instruments=j_rec)
    _assert_same(got, ref)
    assert p_rec.fractions == j_rec.fractions
    must_nt = pc.spec[1][0][2]
    if max(8, must_nt // 4) >= must_nt:
        assert got[3] == "eq" and not p_rec.fractions
    if boost == 0.0:
        assert got[3] == "eq" and p_rec.fractions == [0.0]
    s_e, i_e, t_e = (x.numpy() for x in tbd.execute_sparse(
        corpus["ptree"], pc.spec, tbd.plan_to_torch(pc.spec, pc.arrays, "cpu"), k))
    n = min(k, int(t_e))
    assert np.array_equal(got[0][0][:n].view(np.int32), s_e[:n].view(np.int32))
    assert np.array_equal(got[1][0][:n], i_e[:n])
    assert got[2][0] <= t_e


def test_blockmax_conj_prunes_on_the_skewed_corpus(corpus):
    """At k = 1 at least one conjunction prunes (relation "gte"), so the
    parity above covers the two-launch path, not only the one-launch one."""
    rels = []
    for must, filt, boost in CONJ_CASES[:5]:
        c = corpus["pcomp"].compile(parse_query(_conj(corpus["seg"], must, filt, boost)))
        rels.append(tbd.execute_batch_blockmax_conj(
            corpus["ptree"], c.spec, [c.arrays], 1)[3])
    assert "gte" in rels


def _shard_plans(sh, bodies, compiler_cls, parse, equalize, devs, mappings):
    """Each query compiled per shard (own statistics), every (query, shard)
    plan equalized to one spec; per-query [S, ...] host plans."""
    import jax

    flat = equalize([
        compiler_cls(d.fields, d.doc_values, mappings).compile(parse(b))
        for b in bodies for d in devs
    ])
    s = len(devs)
    plans = [
        jax.tree.map(lambda *xs: np.stack(xs),
                     *[c.arrays for c in flat[q * s:(q + 1) * s]])
        for q in range(len(bodies))
    ]
    return flat[0].spec, plans


SHARD_SETS = {
    "wide": [((40, 70), 3), ((25, 90), 5), ((60, 61), 1), ((30, 45), 2)],
    "tiny": [((1500, 1700), 3), ((1800, 1900), 1)],
}


@pytest.mark.parametrize("which", sorted(SHARD_SETS))
@pytest.mark.parametrize("k", [1, 10])
def test_execute_shards_blockmax_conj_equals_reference(shards, which, k):
    bodies = [_conj(shards["seg"], m, f) for m, f in SHARD_SETS[which]]
    pspec, pplans = _shard_plans(shards, bodies, Compiler, parse_query,
                                 equalize_compiled, shards["pdevs"], shards["pmap"])
    jspec, jplans = _shard_plans(shards, bodies, JCompiler, jparse, jequalize,
                                 shards["jdevs"], shards["jmap"])
    assert pspec == jspec and tbd.supports_blockmax_conj(pspec)
    p_rec, j_rec = Recorder(), Recorder()
    got = tbd.execute_shards_blockmax_conj(shards["ptree"], pspec, pplans, k,
                                           shards["n_pad"], instruments=p_rec)
    ref = jbd.execute_shards_blockmax_conj(shards["jtree"], jspec, jplans, k,
                                           shards["n_pad"], instruments=j_rec)
    _assert_same(got, ref)
    assert p_rec.fractions == j_rec.fractions
    if which == "tiny":
        assert got[3] == "eq"
    elif k == 1:
        assert got[3] == "gte"
    exact = tbd.execute_shards_batch(
        shards["ptree"], pspec,
        tbd.plan_to_torch(pspec, tbd.stack_plans(pplans), "cpu"), k, shards["n_pad"])
    s_e, i_e, t_e = (x.numpy() for x in exact)
    for row in range(len(bodies)):
        n = min(k, int(t_e[row]))
        assert np.array_equal(got[0][row][:n].view(np.int32), s_e[row][:n].view(np.int32))
        assert np.array_equal(got[1][row][:n], i_e[row][:n])
        assert got[2][row] <= t_e[row]


def test_supports_blockmax_conj_equals_reference(corpus):
    seg = corpus["seg"]
    by_df = _by_df(seg)
    bodies = [
        _conj(seg, (40, 70), 3),
        _conj(seg, (0, 1), 1990),  # a tail filter leads: no sort to prune
        _match(seg, (0, 1)),
        {"bool": {"should": [{"match": {"body": by_df[3]}}]}},
        {"bool": {"must": [{"match": {"body": by_df[9]}}],
                  "must_not": [{"term": {"body": by_df[2]}}]}},
        {"bool": {"must": [{"match": {"body": by_df[9]}}],
                  "filter": [{"range": {"body": {"gte": 1}}}]}},
    ]
    seen = set()
    for body in bodies:
        pc = corpus["pcomp"].compile(parse_query(body))
        jc = corpus["jcomp"].compile(jparse(body))
        assert pc.spec == jc.spec
        got = tbd.supports_blockmax_conj(pc.spec)
        assert got == jbd.supports_blockmax_conj(jc.spec)
        seen.add(got)
    assert seen == {True, False}
