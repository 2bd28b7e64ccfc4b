"""Port phrase and span plans against the JAX package.

The JAX package packs each corpus; the port gets the very same planes
(device_segment_from_numpy, positional planes included). Both compilers
compile every body against their own view of it: specs and arrays must
be equal element for element. Then the port's `execute` / `execute_batch`
(K11 and K12's plain versions on the CPU) must equal the jitted JAX
`bm25_device.execute` / `execute_batch`: top-k ids, order, fp32 score
bits and totals.

Tolerance: exact everywhere. Every value on this path is an integer
(positions, counts held in fp32) until the BM25 tail, which both sides
compute as the same fp32 expression in the same order; there is no sum
whose order could differ.

Bodies: every case of the reference's tests/test_phrase_and_expansion.py
(:176-356) and tests/test_span_queries.py (:58-257) in this slice's
kinds, the traps of the port's design (a repeated phrase slot, the
prefix's union slot, an exclude at an include's own position, the
unordered relabel, duplicate span_or terms, an impossible phrase, a
chain of more than two clauses), and a seeded fuzz of 240 random bodies
run in batches of one spec.
"""

import jax
import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.analyzers import AnalysisRegistry as JaxRegistry
from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query import compile as jcomp
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.exec.planner import spec_work_tiles
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.ops import bm25_device as pbd
from elasticsearch_tpu_torch.ops import kernels
from elasticsearch_tpu_torch.query import compile as pcomp
from elasticsearch_tpu_torch.query.dsl import parse_query

torch.set_num_threads(1)

CUSTOM = {"stops": {"tokenizer": "standard", "filter": ["lowercase", "stop"]}}
PROPS = {"body": {"type": "text"}, "tag": {"type": "keyword"},
         "t": {"type": "text", "analyzer": "stops"}}
K = 12

SPAN_DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "quick fox",
    "the fox was quick and brown",
    "lazy quick brown dog fox",
    "a dog and a fox walked home",
    "quick brown quick fox",
    "brown dog",
]
VOCAB = ["quick", "brown", "fox", "jumps", "over", "lazy", "dog", "the",
         "quiet", "quality", "quarter", "brief", "broken"]


class Corpus:
    """One segment packed by the JAX package, its planes moved into the
    port, and a compiler on each side."""

    def __init__(self, docs, nt_floor: int = 1):
        jm = JaxMappings(properties=PROPS, analysis=JaxRegistry(CUSTOM))
        self.pm = Mappings(properties=PROPS, analysis=AnalysisRegistry(CUSTOM))
        self.jm = jm
        builder = JaxBuilder(jm)
        for i, d in enumerate(docs):
            builder.add(d, f"d{i}")
        self.seg = builder.build()
        self.jdev = jax_pack(self.seg)
        self.jtree = jbd.segment_tree(self.jdev)
        tree = self.jtree
        planes = {
            "fields": {k: [np.asarray(x) for x in v]
                       for k, v in tree["fields"].items()},
            "positions": {k: [np.asarray(x) for x in v]
                          for k, v in tree["positions"].items()},
            "doc_values": {k: np.asarray(v)
                           for k, v in tree["doc_values"].items()},
            "live": np.asarray(tree["live"]),
        }
        meta = {name: field_meta(f) for name, f in self.jdev.fields.items()}
        self.pdev = device_segment_from_numpy(planes, meta, device="cpu")
        self.ptree = pbd.segment_tree(self.pdev)
        self.jc = jcomp.Compiler(self.jdev.fields, self.jdev.doc_values, jm,
                                 nt_floor=nt_floor)
        self.pc = pcomp.Compiler(self.pdev.fields, self.pdev.doc_values,
                                 self.pm, nt_floor=nt_floor)

    def compile_both(self, query):
        a = self.jc.compile(jax_parse(query))
        b = self.pc.compile(parse_query(query))
        assert a.spec == b.spec, (query, a.spec, b.spec)
        _same_arrays(a.arrays, b.arrays, query)
        return a, b


def _same_arrays(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for key in a:
            _same_arrays(a[key], b[key], where)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _same_arrays(x, y, where)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert np.array_equal(x, y), where


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _same_topk(jax_out, port_out, where):
    js, ji, jt = (np.asarray(x) for x in jax_out)
    ps, pi, pt = (x.numpy() for x in port_out)
    assert int(jt) == int(pt), (where, int(jt), int(pt))
    n = min(int(jt), len(ji))
    assert list(ji[:n]) == list(pi[:n]), (where, ji[:n], pi[:n])
    assert np.array_equal(_bits(js[:n]), _bits(ps[:n])), (where, js[:n], ps[:n])


def run_pair(corpus: Corpus, query: dict, k: int = K):
    a, b = corpus.compile_both(query)
    jout = jbd.execute(corpus.jtree, a.spec, a.arrays, k)
    pout = pbd.execute(corpus.ptree, b.spec,
                       pbd.plan_to_torch(b.spec, b.arrays, "cpu"), k)
    _same_topk(jout, pout, query)
    return b.spec, pout


@pytest.fixture(scope="module")
def spans():
    return Corpus([{"body": t} for t in SPAN_DOCS])


def _random_docs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(VOCAB, size=int(rng.integers(2, 12)))),
             "tag": str(rng.choice(["a", "b"]))}
        if i % 9 == 0:
            d["body"] = [d["body"], " ".join(rng.choice(VOCAB, 3))]
        if i % 4 == 0:
            d["t"] = " ".join(rng.choice(VOCAB + ["the", "a", "of"], 5))
        out.append(d)
    return out


@pytest.fixture(scope="module")
def rand():
    return Corpus(_random_docs(3, 150), nt_floor=16)


def _st(w):
    return {"span_term": {"body": w}}


SPAN_CASES = [
    {"span_term": {"body": "fox"}},
    {"term": {"body": "fox"}},
    {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 0}},
    {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 1}},
    {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 3}},
    {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 0,
                   "in_order": False}},
    {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 2,
                   "in_order": False}},
    {"span_near": {"clauses": [_st("quick"), _st("brown"), _st("fox")],
                   "slop": 0}},
    {"span_near": {"clauses": [_st("quick"), _st("brown"), _st("fox")],
                   "slop": 1}},
    {"span_or": {"clauses": [_st("lazy"), _st("walked")]}},
    {"span_near": {"clauses": [{"span_or": {"clauses": [_st("quick"),
                                                        _st("lazy")]}},
                               _st("dog")], "slop": 0}},
    {"span_near": {"clauses": [{"span_or": {"clauses": [_st("quick"),
                                                        _st("lazy")]}},
                               _st("dog")], "slop": 2}},
    {"span_first": {"match": _st("quick"), "end": 1}},
    {"span_first": {"match": _st("quick"), "end": 2}},
    {"span_not": {"include": _st("fox"), "exclude": _st("quick"), "dist": 1}},
    {"span_not": {"include": _st("fox"), "exclude": _st("quick"), "pre": 1,
                  "post": 0}},
    {"span_not": {"include": _st("fox"), "exclude": _st("absent"), "dist": 1}},
    {"bool": {"must": [{"match": {"body": "dog"}}],
              "filter": [{"span_near": {"clauses": [_st("quick"), _st("fox")],
                                        "slop": 1}}]}},
    {"intervals": {"body": {"match": {"query": "quick fox", "max_gaps": 1,
                                      "ordered": True}}}},
    {"intervals": {"body": {"match": {"query": "fox quick"}}}},
    {"intervals": {"body": {"all_of": {"intervals": [
        {"match": {"query": "quick"}}, {"prefix": {"prefix": "fo"}}],
        "max_gaps": 2, "ordered": True}}}},
    {"intervals": {"body": {"any_of": {"intervals": [
        {"match": {"query": "walked"}}, {"match": {"query": "lazy"}}]}}}},
    {"intervals": {"body": {"prefix": {"prefix": "qu"}}}},
    {"match_phrase": {"body": "quick brown"}},
    {"match_phrase": {"body": "quick fox"}},
    {"match_phrase": {"body": "brown quick fox"}},
]


@pytest.mark.parametrize("case", range(len(SPAN_CASES)))
def test_span_queries_match_the_reference(spans, case):
    run_pair(spans, SPAN_CASES[case])


def test_span_term_scores_like_term(spans):
    _s1, a = run_pair(spans, {"span_term": {"body": "fox"}})
    _s2, b = run_pair(spans, {"term": {"body": "fox"}})
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_span_near_matching_sets(spans):
    """The reference's expected matching sets (test_span_queries.py)."""
    def ids(q):
        _spec, (s, i, t) = run_pair(spans, q)
        return sorted(int(x) for x in i[: int(t)])

    near = {"span_near": {"clauses": [_st("quick"), _st("fox")], "slop": 0}}
    assert ids(near) == [1, 5]
    near["span_near"]["slop"] = 2
    assert ids(near) == [0, 1, 3, 5]
    assert ids({"span_first": {"match": _st("quick"), "end": 1}}) == [1, 5]
    assert ids({"span_first": {"match": _st("quick"), "end": 2}}) == [0, 1, 3, 5]
    assert ids({"span_not": {"include": _st("fox"), "exclude": _st("quick"),
                             "pre": 1}}) == [0, 2, 3, 4]


PHRASE_TRAPS = [
    # a repeated slot: "quick quick" needs two adjacent quicks
    {"match_phrase": {"body": "quick quick"}},
    {"match_phrase": {"body": "fox fox fox"}},
    # the union slot of match_phrase_prefix (qu* -> quick, quiet, ...)
    {"match_phrase_prefix": {"body": "brown qu"}},
    {"match_phrase_prefix": {"body": {"query": "the qua", "max_expansions": 1}}},
    {"match_phrase_prefix": {"body": "lazy zz"}},  # no expansion survives
    {"match_phrase_prefix": {"body": "br"}},  # a bare prefix: terms_const
    # an impossible phrase: an EMPTY worklist, not match_none
    {"match_phrase": {"body": "quick absentterm fox"}},
    # an exclude at the include's own (doc, pos)
    {"span_not": {"include": _st("fox"), "exclude": {"span_or": {"clauses": [
        _st("fox"), _st("dog")]}}, "dist": 0}},
    {"span_not": {"include": {"span_or": {"clauses": [_st("fox"), _st("dog")]}},
                  "exclude": _st("fox"), "pre": 2, "post": 0}},
    # the unordered relabel, both orders present in a doc
    {"span_near": {"clauses": [_st("quick"), _st("brown")], "slop": 1,
                   "in_order": False}},
    # duplicate span_or terms: every chain-end event counts
    {"span_or": {"clauses": [_st("fox"), _st("fox"), _st("dog")]}},
    {"span_near": {"clauses": [{"span_or": {"clauses": [_st("fox"), _st("fox")]}},
                               _st("dog")], "slop": 3, "in_order": False}},
    # more than two clauses (the DP's stored levels)
    {"span_near": {"clauses": [_st("the"), _st("quick"), _st("brown"),
                               _st("fox")], "slop": 4}},
    {"span_near": {"clauses": [_st("quick"), _st("quick"), _st("fox")],
                   "slop": 2}},
    # stop-word gaps: "jump the fence" analyzes to jump@0 fence@2
    {"match_phrase": {"t": "quick the fox"}},
    {"match_phrase": {"t": "the quick"}},
    # a keyword field: one token, the term query
    {"match_phrase": {"tag": "a"}},
    {"match_phrase": {"body": {"query": "quick brown", "boost": 2.5}}},
    {"bool": {"must": [{"match_phrase": {"body": "brown fox"}}],
              "filter": [{"term": {"tag": "a"}}]}},
    {"bool": {"should": [{"match_phrase": {"body": "lazy dog"}},
                         {"span_near": {"clauses": [_st("quick"), _st("dog")],
                                        "slop": 5}}],
              "must_not": [{"match_phrase": {"body": "the the"}}]}},
    {"constant_score": {"filter": {"match_phrase": {"body": "over the"}},
                        "boost": 3.0}},
]


@pytest.mark.parametrize("case", range(len(PHRASE_TRAPS)))
def test_phrase_traps_match_the_reference(rand, case):
    run_pair(rand, PHRASE_TRAPS[case], k=40)


def _mk(docs):
    return Corpus([d if isinstance(d, dict) else {"body": d} for d in docs])


def test_phrase_semantics_order_matters():
    c = _mk(["quick brown fox", "brown quick fox", "quick fox brown"])
    _spec, (s, i, t) = run_pair(c, {"match_phrase": {"body": "quick brown"}})
    assert int(t) == 1 and int(i[0]) == 0


def test_phrase_counts_multiple_occurrences():
    c = _mk(["ab cd ab cd ab cd", "ab cd xx xx xx xx"])
    _spec, (s, i, t) = run_pair(c, {"match_phrase": {"body": "ab cd"}})
    assert [int(x) for x in i[:2]] == [0, 1] and s[0] > s[1]


def test_phrase_does_not_cross_multi_value_boundary():
    c = _mk([{"body": ["hello world", "goodbye moon"]},
             {"body": ["hello", "world"]}])
    _spec, (s, i, t) = run_pair(c, {"match_phrase": {"body": "hello world"}})
    assert int(t) == 1 and int(i[0]) == 0


def test_phrase_respects_stopword_gaps():
    c = _mk([{"t": "jump the fence"}, {"t": "jump fence"}])
    _spec, (s, i, t) = run_pair(c, {"match_phrase": {"t": "jump the fence"}})
    assert int(t) == 1 and int(i[0]) == 0


def test_phrase_on_keyword_field_acts_as_term():
    c = _mk([{"tag": "a", "body": "x"}, {"tag": "a b", "body": "y"}])
    spec, (s, i, t) = run_pair(c, {"match_phrase": {"tag": "a"}})
    assert spec[0] != "phrase" and int(t) == 1 and int(i[0]) == 0
    _spec, (s, i, t) = run_pair(c, {"match_phrase": {"tag": "a b"}})
    assert int(t) == 1 and int(i[0]) == 1


@pytest.mark.parametrize("query, match", [
    ({"match_phrase": {"body": {"query": "a b", "slop": 2}}}, "slop"),
    ({"span_near": {"clauses": [_st("a"), {"span_term": {"tag": "a"}}]}},
     "same field"),
    ({"span_term": {"tag": "a"}}, None),
    ({"span_near": {"clauses": [{"span_term": {"tag": "a"}},
                                {"span_term": {"tag": "b"}}]}},
     "without positions"),
    ({"match_phrase_prefix": {"tag": "a b"}}, None),  # one keyword token
])
def test_compile_errors_match_the_reference(spans, query, match):
    c = _mk([{"tag": "a", "body": "a b"}])
    if match is None:
        run_pair(c, query)
        return
    with pytest.raises(ValueError, match=match) as port_err:
        c.pc.compile(parse_query(query))
    with pytest.raises(ValueError) as jax_err:
        c.jc.compile(jax_parse(query))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("query", [
    {"span_near": {"clauses": [{"term": {"body": "x"}}]}},
    {"span_near": {"clauses": [_st("a"), _st("b"), _st("c")],
                   "in_order": False}},
    {"span_first": {"match": _st("a")}},
    {"span_first": {"match": _st("a"), "end": -1}},
    {"span_or": {"clauses": []}},
    {"span_not": {"include": _st("a")}},
    {"intervals": {"body": "x"}},
    {"span_near": {"clauses": [{"span_near": {"clauses": [_st("a")]}}]}},
])
def test_parse_errors_match_the_reference(query):
    with pytest.raises(ValueError) as port_err:
        pcomp.Compiler({}, {}, Mappings(properties=PROPS)).compile(
            parse_query(query))
    with pytest.raises(ValueError) as jax_err:
        jcomp.Compiler({}, {}, JaxMappings(properties=PROPS)).compile(
            jax_parse(query))
    assert str(port_err.value) == str(jax_err.value)


def test_planner_counts_positional_work_as_the_reference():
    from elasticsearch_tpu.exec.planner import spec_work_tiles as jax_tiles

    specs = [("phrase", "body", 64, 2), ("span_near", "body", 32, 2, 1, True, -1),
             ("span_not", "body", 16, 1, 1),
             ("bool", (("phrase", "body", 8, 3),), (), (("terms_const", "tag", 4, 1),),
              (), -1, -1)]
    for spec in specs:
        assert spec_work_tiles(spec) == jax_tiles(spec)
        assert spec_work_tiles(spec, floor=128) == jax_tiles(spec, floor=128)


def test_positional_plans_are_dense_only():
    for spec in (("phrase", "body", 4, 2), ("span_near", "body", 4, 2, 0, True, -1),
                 ("span_not", "body", 4, 0, 0)):
        assert not pbd.supports_sparse(spec)
        assert pbd.supports_sparse(spec) == jbd.supports_sparse(spec)


def _fuzz_body(rng, fields_terms):
    words = fields_terms
    kind = int(rng.integers(0, 9))

    def w():
        return str(rng.choice(words))

    if kind == 0:
        return {"match_phrase": {"body": " ".join(w() for _ in range(
            int(rng.integers(2, 5))))}}
    if kind == 1:
        last = w()
        return {"match_phrase_prefix": {"body": f"{w()} {last[:int(rng.integers(1, 4))]}"}}
    if kind == 2:
        n = int(rng.integers(1, 4))
        clauses = [_st(w()) if rng.random() < 0.7 else
                   {"span_or": {"clauses": [_st(w()), _st(w())]}}
                   for _ in range(n)]
        return {"span_near": {"clauses": clauses,
                              "slop": int(rng.integers(0, 3)),
                              "in_order": bool(n != 2 or rng.random() < 0.5)}}
    if kind == 3:
        return {"span_first": {"match": _st(w()), "end": int(rng.integers(1, 4))}}
    if kind == 4:
        d = int(rng.integers(0, 2))
        return {"span_not": {"include": _st(w()),
                             "exclude": {"span_or": {"clauses": [_st(w()), _st(w())]}},
                             "pre": d, "post": int(rng.integers(0, 2))}}
    if kind == 5:
        return {"span_or": {"clauses": [_st(w()) for _ in range(
            int(rng.integers(1, 4)))]}}
    if kind == 6:
        n = int(rng.integers(2, 4))
        return {"intervals": {"body": {"match": {
            "query": " ".join(w() for _ in range(n)), "max_gaps": 2,
            "ordered": bool(n == 3 or rng.random() < 0.5)}}}}
    if kind == 7:
        return {"bool": {"must": [{"match_phrase": {"body": f"{w()} {w()}"}}],
                         "filter": [{"term": {"tag": str(rng.choice(["a", "b"]))}}]}}
    return {"bool": {"should": [{"match_phrase": {"body": f"{w()} {w()}"}},
                                {"match": {"body": w()}}]}}


def test_fuzz_batches_match_the_reference(rand):
    """240 random bodies, grouped by compiled spec: each group runs as one
    batch (execute_batch) on both sides, and each body alone through the
    port's execute against its batch row."""
    rng = np.random.default_rng(2024)
    words = VOCAB + ["absent"]
    bodies = [_fuzz_body(rng, words) for _ in range(240)]
    groups: dict = {}
    for body in bodies:
        a, b = rand.compile_both(body)
        groups.setdefault(a.spec, []).append((a, b))
    assert len(groups) >= 10
    matched_rows = 0
    for spec, pairs in groups.items():
        ja = jax.tree.map(lambda *x: np.stack(x), *[a.arrays for a, _ in pairs])
        pa = pbd.stack_plans([b.arrays for _, b in pairs])
        js, ji, jt = (np.asarray(x) for x in jbd.execute_batch(
            rand.jtree, spec, ja, K))
        ps, pi, pt = (x.numpy() for x in pbd.execute_batch(
            rand.ptree, spec, pbd.plan_to_torch(spec, pa, "cpu"), K))
        for r, (_a, b) in enumerate(pairs):
            _same_topk((js[r], ji[r], jt[r]),
                       (torch.from_numpy(ps[r]), torch.from_numpy(pi[r]),
                        torch.tensor(pt[r])), spec)
            matched_rows += int(pt[r]) > 0
        solo = pbd.execute(rand.ptree, spec,
                           pbd.plan_to_torch(spec, pairs[0][1].arrays, "cpu"), K)
        assert torch.equal(solo[1], torch.from_numpy(pi[0]))
        assert torch.equal(solo[0].view(torch.int32),
                           torch.from_numpy(ps[0]).view(torch.int32))
    assert matched_rows >= 100


def test_unified_batch_of_phrase_buckets_matches_the_reference(rand):
    """Phrases of different worklist buckets share one padded launch
    (unify_specs / pad_arrays_to_spec with `shifts` and `clause_of`)."""
    for bodies in (
        [{"match_phrase": {"body": "quick brown"}},
         {"match_phrase": {"body": "the fox"}},
         {"match_phrase": {"body": "absent fox"}}],
        [{"span_near": {"clauses": [_st("quick"), _st("dog")], "slop": 2}},
         {"span_near": {"clauses": [_st("the"), _st("the")], "slop": 2}}],
        [{"span_not": {"include": _st("fox"), "exclude": _st("the"), "dist": 1}},
         {"span_not": {"include": _st("the"), "exclude": _st("absent"), "dist": 1}}],
    ):
        c = Corpus(_random_docs(3, 150))  # natural buckets (nt_floor 1)
        compiled = [c.compile_both(b) for b in bodies]
        jspec = jcomp.unify_specs([a.spec for a, _ in compiled])
        pspec = pcomp.unify_specs([b.spec for _, b in compiled])
        assert jspec == pspec
        ja = [jcomp.pad_arrays_to_spec(a.spec, jspec, a.arrays) for a, _ in compiled]
        pa = [pcomp.pad_arrays_to_spec(b.spec, pspec, b.arrays) for _, b in compiled]
        for x, y in zip(ja, pa):
            _same_arrays(x, y, bodies)
        jout = jbd.execute_batch(
            c.jtree, jspec, jax.tree.map(lambda *x: np.stack(x), *ja), K)
        pout = pbd.execute_batch(
            c.ptree, pspec, pbd.plan_to_torch(pspec, pbd.stack_plans(pa), "cpu"), K)
        for r in range(len(bodies)):
            _same_topk(tuple(np.asarray(x)[r] for x in jout),
                       tuple(x[r] for x in pout), bodies[r])


def test_stacked_shards_refuse_positional_plans(rand):
    """Shards whose positional planes were packed without a common
    `field_pos_min_tiles` refuse to stack, naming the plane (the
    reference's np.stack refuses them too); packed with one, they stack
    and run (test_torch_stacked_tail.py)."""
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.index.tiles import pack_segment

    builder = SegmentBuilder(rand.pm)
    for i, d in enumerate(_random_docs(3, 40)):
        builder.add(d, f"d{i}")
    seg = builder.build()
    natural = pack_segment(seg, device="cpu")
    pt = natural.fields["body"].pos_doc.shape[0]
    longer = pack_segment(seg, device="cpu",
                          field_pos_min_tiles={"body": pt + 2})
    with pytest.raises(ValueError, match=r"positions\.body"):
        pbd.stack_segment_trees([pbd.segment_tree(natural),
                                 pbd.segment_tree(longer)])
    common = pack_segment(seg, device="cpu", field_pos_min_tiles={"body": pt})
    tree = pbd.stack_segment_trees([pbd.segment_tree(natural),
                                    pbd.segment_tree(common)])
    assert tree["positions"]["body"][0].shape == (2, pt, 256)


def test_kernel_wrappers_take_cpu_tensors_to_their_plain_versions(rand):
    """On CPU tensors K11 and K12 run their plain versions and count no
    launch; the wrappers refuse malformed inputs."""
    _a, b = rand.compile_both({"span_near": {"clauses": [_st("quick"), _st("fox")],
                                             "slop": 1}})
    plan = pbd._rows1(pbd.plan_to_torch(b.spec, b.arrays, "cpu"))
    pos_doc, pos_val, pos_bits = rand.ptree["positions"]["body"]
    n = rand.ptree["live"].shape[0]
    kernels.reset_launches()
    args = (pos_doc, pos_val, plan["tile_ids"], plan["starts"], plan["ends"],
            plan["clause_of"], n, pos_bits, 1, kernels.EVENTS_SPAN)
    keys, count = kernels.position_events(*args)
    want = kernels.position_events_plain(*args)
    assert torch.equal(keys, want[0]) and torch.equal(count, want[1])
    assert torch.all(keys[0, : int(count[0])] < (n << (pos_bits + 1)))
    assert torch.all(keys[0, int(count[0]):] == (n << (pos_bits + 1)))
    assert torch.equal(keys, torch.sort(keys, dim=1).values)
    assert kernels.LAUNCHES["position_events"] == 0
    with pytest.raises(TypeError):
        kernels.position_events(pos_doc.to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        kernels.position_events(*args[:6], n, 60, 8, kernels.EVENTS_SPAN)
    with pytest.raises(ValueError):
        kernels.position_walk(keys, count, rand.ptree["fields"]["body"][3],
                              plan["weight"].reshape(1), plan["cache"], n,
                              pos_bits, 1, 7, 2)
    assert kernels.LAUNCHES["position_walk"] == 0
