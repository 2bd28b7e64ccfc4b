"""Port the stacked-shard modes of rows 14-15 (phrase and span) and 16b
(the structured tail) against the JAX package.

Three shards of unequal doc counts are built and packed by the JAX
package to common shapes (`pad_docs_to`, `field_min_tiles` and
`field_pos_min_tiles`, as ShardedIndex.from_segments computes them); each
shard's planes move into the port (device_segment_from_numpy) and both
packages stack them: the port with `stack_segment_trees`, the JAX package
with `jax.tree.map(np.stack, ...)`. Every body is compiled per shard with
that shard's statistics by each package's own compiler and equalized to
one spec (plans equal element for element), then run through
`execute_shards` (one query) and `execute_shards_batch` (two, [Q, S, ...])
on each side: K11s-K14s's plain versions on the CPU against the vmaps of
the reference's programs.

Cases: every phrase and span body of test_torch_phrase.py (SPAN_CASES,
PHRASE_TRAPS) and every structured body of test_torch_structured.py
(CASES, and BATCHES through execute_shards_batch), each one parametrised
case. Tolerances are those files': exact (ids, order, fp32 bits,
totals) for the positional kinds; the structured cases' stated ulps (0,
1 for dis_max, 4 where exp, log or pow is in the score).

The nested blocks: the reference stacks them only where every shard's
block has the same shapes (np.stack). Each shard's parents here carry a
permutation of one list of answer objects, in per-parent counts drawn
per shard, so the blocks have equal shapes and different contents.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_phrase import CUSTOM, PHRASE_TRAPS, SPAN_CASES, _random_docs
from test_torch_phrase import PROPS as PHRASE_PROPS
from test_torch_structured import (
    BATCHES,
    CASES,
    PROPS,
    WORDS,
    all_field_meta,
    make_docs,
    same_topk,
    tree_planes,
)

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry as JaxRegistry
from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query import compile as jcomp
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import TILE, device_segment_from_numpy
from elasticsearch_tpu_torch.ops import bm25_device as pbd
from elasticsearch_tpu_torch.ops import kernels, tail_kernel
from elasticsearch_tpu_torch.query import compile as pcomp
from elasticsearch_tpu_torch.query.dsl import parse_query

torch.set_num_threads(1)

K = 12
PHRASE_SHARD_DOCS = (70, 52, 31)
STRUCT_SHARD_DOCS = (64, 50, 37)
N_ANSWERS = 90  # answer objects each structured shard carries


def _pads(segments):
    """ShardedIndex.from_segments' common shapes: docs, postings tiles
    and (text fields) position tiles."""
    n_pad = max(s.num_docs for s in segments)
    min_tiles, pos_tiles = {}, {}
    for seg in segments:
        for name, fld in seg.fields.items():
            min_tiles[name] = max(min_tiles.get(name, 0),
                                  len(fld.doc_ids) // TILE + 2)
            if fld.positions is not None:
                pos_tiles[name] = max(pos_tiles.get(name, 0),
                                      len(fld.positions) // TILE + 2)
    return n_pad, min_tiles, pos_tiles


class Shards:
    """S shards built and packed by the JAX package to common shapes, the
    same planes in the port, both stacked; a compiler per shard on each
    side."""

    def __init__(self, doc_lists, jm, pm, ids=False, nested=False):
        self.jm, self.pm = jm, pm
        segs = []
        for s, docs in enumerate(doc_lists):
            jb, pb = JaxBuilder(jm), SegmentBuilder(pm)
            for i, d in enumerate(docs):
                name = f"s{s}d{i}" if ids is False else ids[s][i]
                jb.add(d, name)
                pb.add(d, name)  # the port's dynamic leaf mappings
            segs.append(jb.build())
        self.n_pad, min_tiles, pos_tiles = _pads(segs)
        self.jdevs = [jax_pack(seg, pad_docs_to=self.n_pad,
                               field_min_tiles=min_tiles,
                               field_pos_min_tiles=pos_tiles) for seg in segs]
        jtrees = [jbd.segment_tree(d) for d in self.jdevs]
        self.pdevs = [device_segment_from_numpy(
            tree_planes(t), all_field_meta(d), device="cpu")
            for t, d in zip(jtrees, self.jdevs)]
        self.jtree = jax.tree.map(lambda *xs: np.stack(xs), *jtrees)
        self.ptree = pbd.stack_segment_trees(
            [pbd.segment_tree(d) for d in self.pdevs])
        self.jc, self.pc = [], []
        for seg, jd, pd in zip(segs, self.jdevs, self.pdevs):
            kw_j, kw_p = {}, {}
            if ids is not False:
                index = {d: i for i, d in enumerate(seg.ids)}
                kw_j["id_index"] = kw_p["id_index"] = index
            if nested:
                kw_j["nested"], kw_p["nested"] = jd.nested, pd.nested
            self.jc.append(jcomp.Compiler(jd.fields, jd.doc_values, jm, **kw_j))
            self.pc.append(pcomp.Compiler(pd.fields, pd.doc_values, pm, **kw_p))

    def plans(self, bodies):
        """Each body per shard on each side, all equalized to one spec and
        stacked [Q, S, ...]: (spec, JAX arrays, port tensors)."""
        jflat = jcomp.equalize_compiled(
            [c.compile(jax_parse(b)) for b in bodies for c in self.jc])
        pflat = pcomp.equalize_compiled(
            [c.compile(parse_query(b)) for b in bodies for c in self.pc])
        assert jflat[0].spec == pflat[0].spec, bodies
        for a, b in zip(jflat, pflat):
            same_arrays(a.arrays, b.arrays, bodies)
        s = len(self.jc)

        def per_query(flat):
            return [jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                 *[c.arrays for c in flat[q * s:(q + 1) * s]])
                    for q in range(len(bodies))]

        jplans, pplans = per_query(jflat), per_query(pflat)
        jb = jax.tree.map(lambda *xs: np.stack(xs), *jplans)
        pb = pbd.plan_to_torch(pflat[0].spec, pbd.stack_plans(pplans), "cpu")
        return pflat[0].spec, jplans, pplans, jb, pb

    def run_both(self, bodies, ulps, where):
        """execute_shards on the first body, execute_shards_batch on all,
        each held to the JAX package's."""
        spec, jplans, pplans, jb, pb = self.plans(bodies)
        jout = jbd.execute_shards(self.jtree, spec, jplans[0], K, self.n_pad)
        pout = pbd.execute_shards(
            self.ptree, spec, pbd.plan_to_torch(spec, pplans[0], "cpu"), K,
            self.n_pad)
        same_topk(jout, pout, ulps, where)
        jout = jbd.execute_shards_batch(self.jtree, spec, jb, K, self.n_pad)
        pout = pbd.execute_shards_batch(self.ptree, spec, pb, K, self.n_pad)
        for r in range(len(bodies)):
            same_topk(tuple(np.asarray(x)[r] for x in jout),
                      tuple(x[r] for x in pout), ulps, (where, r))
        return pout


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


@pytest.fixture(scope="module")
def phrase_shards():
    docs = [_random_docs(30 + s, n) for s, n in enumerate(PHRASE_SHARD_DOCS)]
    return Shards(docs, JaxMappings(properties=PHRASE_PROPS,
                                    analysis=JaxRegistry(CUSTOM)),
                  Mappings(properties=PHRASE_PROPS,
                           analysis=AnalysisRegistry(CUSTOM)))


def structured_docs():
    """Three shards of make_docs' documents whose answers are, per shard,
    a permutation of one list of N_ANSWERS answer objects spread over the
    shard's parents in counts of 0-4 drawn per shard."""
    rng = np.random.default_rng(5)
    answers = [{"body": " ".join(rng.choice(WORDS, int(rng.integers(1, 8)))),
                "votes": int(rng.integers(-3, 40))} for _ in range(N_ANSWERS)]
    out, ids, base = [], [], 0
    for s, n in enumerate(STRUCT_SHARD_DOCS):
        docs = make_docs(40 + s, n)
        srng = np.random.default_rng(50 + s)
        counts = np.zeros(n, dtype=int)
        for _ in range(N_ANSWERS):  # every answer to a parent, 4 at most
            free = np.flatnonzero(counts < 4)
            counts[srng.choice(free)] += 1
        order = srng.permutation(N_ANSWERS)
        at = 0
        for d, c in zip(docs, counts):
            d.pop("answers", None)
            if c:
                d["answers"] = [answers[j] for j in order[at:at + c]]
                at += c
        out.append(docs)
        ids.append([f"d{base + i}" for i in range(n)])
        base += n
    return out, ids


@pytest.fixture(scope="module")
def struct_shards():
    docs, ids = structured_docs()
    return Shards(docs, JaxMappings(properties=PROPS), Mappings(properties=PROPS),
                  ids=ids, nested=True)


POSITIONAL = SPAN_CASES + PHRASE_TRAPS


@pytest.mark.parametrize("case", range(len(POSITIONAL)))
def test_positional_plans_over_stacked_shards_match_the_jax_package(
        phrase_shards, case):
    body = POSITIONAL[case]
    phrase_shards.run_both([body, body], 0, body)


@pytest.mark.parametrize("name,body,ulps", CASES, ids=[c[0] for c in CASES])
def test_structured_plans_over_stacked_shards_match_the_jax_package(
        struct_shards, name, body, ulps):
    pout = struct_shards.run_both([body, body], ulps, name)
    assert int(pout[2][0]) > 0 or name.startswith("ids"), name


@pytest.mark.parametrize("name,bodies,ulps", BATCHES,
                         ids=[b[0] for b in BATCHES])
def test_structured_batches_over_stacked_shards_match_the_jax_package(
        struct_shards, name, bodies, ulps):
    struct_shards.run_both(bodies, ulps, name)


def test_stacked_trees_keep_positions_and_nested_blocks(phrase_shards,
                                                        struct_shards):
    pos_doc, pos_val, pos_bits = phrase_shards.ptree["positions"]["body"]
    assert pos_doc.dim() == 3 and pos_doc.shape == pos_val.shape
    assert pos_bits == max(d.fields["body"].pos_bits
                           for d in phrase_shards.pdevs)
    blk = struct_shards.ptree["nested"]["answers"]
    s = len(STRUCT_SHARD_DOCS)
    assert blk["child_start"].shape == (s, struct_shards.n_pad + 1)
    assert blk["tree"]["live"].shape == (s, N_ANSWERS)
    # the shards' blocks differ in contents
    assert not torch.equal(blk["child_start"][0], blk["child_start"][1])


def test_stacked_wrappers_equal_their_rows_on_each_shard(phrase_shards,
                                                         struct_shards):
    """K11s, K12s, K13s and K14s (plain, on the CPU) row by row against
    the single-segment wrappers on row r's shard."""
    tree, n = phrase_shards.ptree, phrase_shards.n_pad
    s = len(PHRASE_SHARD_DOCS)
    spec, _jp, _pp, _jb, pb = phrase_shards.plans([
        {"span_near": {"clauses": [{"span_term": {"body": "quick"}},
                                   {"span_term": {"body": "fox"}}],
                       "slop": 2}}] * 2)
    rows = pbd._pair_rows(pb)
    pos_doc, pos_val, pos_bits = tree["positions"]["body"]
    norm = tree["fields"]["body"][3]
    cb = kernels.clause_bits_for(2)
    keys, count = kernels.position_events_stacked(
        pos_doc, pos_val, rows["tile_ids"], rows["starts"], rows["ends"],
        rows["clause_of"], n, pos_bits, cb, kernels.EVENTS_SPAN)
    sc, m = kernels.position_walk_stacked(
        keys, count, norm, rows["weight"], rows["cache"], n, pos_bits, cb,
        kernels.WALK_NEAR, 2, slop=2)
    for r in range(2 * s):
        one = slice(r, r + 1)
        k1, c1 = kernels.position_events(
            pos_doc[r % s], pos_val[r % s], rows["tile_ids"][one],
            rows["starts"][one], rows["ends"][one], rows["clause_of"][one],
            n, pos_bits, cb, kernels.EVENTS_SPAN)
        assert torch.equal(k1[0], keys[r]) and torch.equal(c1[0], count[r])
        s1, m1 = kernels.position_walk(
            k1, c1, norm[r % s], rows["weight"][one], rows["cache"][one], n,
            pos_bits, cb, kernels.WALK_NEAR, 2, slop=2)
        assert torch.equal(s1[0].view(torch.int32), sc[r].view(torch.int32))
        assert torch.equal(m1[0], m[r])
    blk = struct_shards.ptree["nested"]["answers"]
    s = len(STRUCT_SHARD_DOCS)
    nn, n = blk["tree"]["live"].shape[-1], struct_shards.n_pad
    rng = np.random.default_rng(3)
    cm = torch.from_numpy(rng.random((2 * s, nn)) < 0.5)
    cs = torch.from_numpy(rng.normal(size=(2 * s, nn)).astype(np.float32))
    boost = torch.tensor([1.5, -2.0] * s, dtype=torch.float32)
    for mode in kernels.JOIN_MODES:
        jm, js = kernels.doc_join(cm, cs, blk["child_start"], boost, mode,
                                  n_shards=s)
        for r in range(2 * s):
            one = slice(r, r + 1)
            m1, s1 = kernels.doc_join(cm[one], cs[one], blk["child_start"][r % s],
                                      boost[one], mode)
            assert torch.equal(m1[0], jm[r]), (mode, r)
            assert torch.equal(s1[0].view(torch.int32), js[r].view(torch.int32))
    col = struct_shards.ptree["doc_values"]["pagerank"]
    key = ("rank_feature", "saturation")
    params = {"pivot": boost.abs(), "boost": boost}
    t_scores, t_matched = tail_kernel.tail_eval(key, 2 * s, n, {}, {},
                                                {"col": col}, params,
                                                n_shards=s)
    for r in range(2 * s):
        one = slice(r, r + 1)
        s1, m1 = tail_kernel.tail_eval(
            key, 1, n, {}, {}, {"col": col[r % s]},
            {name: p[one] for name, p in params.items()})
        assert torch.equal(s1[0].view(torch.int32), t_scores[r].view(torch.int32))
        assert torch.equal(m1[0], t_matched[r])


def test_stacked_modes_launch_nothing_on_the_cpu(phrase_shards, struct_shards):
    kernels.reset_launches()
    phrase_shards.run_both([{"match_phrase": {"body": "quick brown"}}] * 2, 0,
                           "phrase")
    struct_shards.run_both([CASES[-1][1]] * 2, 0, "nested")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
