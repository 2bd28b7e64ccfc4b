"""Port the strictly sequential chains (kernel-table row 17) against the
JAX package.

Each of the port's four chains (`execute_sequential_sparse`,
`execute_sequential`, `execute_shards_sequential`,
`execute_rescore_sequential`) runs the same Q plans as the JAX package's
chain (a `lax.scan` whose step perturbs the plan by the previous total
times 0.0): ids, order, fp32 score bits and totals, the padding slots
past each row's hits included, compared as integers with no tolerance.
The single corpus is packed by the JAX package and its planes moved into
the port (device_segment_from_numpy); the stacked shards are packed by
each package to the same padded shapes. Plans are compiled by each
package's own compiler and must agree element for element.

Shapes: sparse `match`; dense `bool(should)`; `bool(must + filter)` over
3 stacked shards of unequal doc counts; a BASELINE config 4 rescore (the
cfg4 script over columns f1 / f2); a `script_score`; `match_none` with
`length`; and the -0.0 boost trap: a chain adds +0.0 to the boost, so
where `execute` scores a hit -0.0 the chain scores it +0.0, in both
packages. K15's plain version is held to numpy's float32 addition.

One stated exception: a script_score whose script feeds a product into a
sum. XLA contracts that into an FMA inside each of the JAX package's
programs (its per-query kernel as much as its chain), while the port
rounds the product, as K6 does everywhere (test_torch_script.py's 4-ulp
allowance). Such a chain is held exactly to its own package's per-query
program and to the other package's chain within 4 ulps; the exact
script_score case divides instead (`_score / params.a + ...`), which XLA
does not contract.
"""

import jax
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.tiles import pack_segment as jax_pack
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query import compile as jcomp
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu.utils.corpus import build_zipf_segment as jax_zipf
from elasticsearch_tpu_torch.index.tiles import (
    TILE,
    device_segment_from_numpy,
    field_meta,
    pack_segment,
)
from elasticsearch_tpu_torch.ops import bm25_device as pbd
from elasticsearch_tpu_torch.ops import kernels
from elasticsearch_tpu_torch.query import compile as pcomp
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

torch.set_num_threads(1)

K = 10
N_DOCS = 900
Q = 4
SHARD_DOCS = (700, 520, 9)  # the last shard holds fewer docs than k
CFG4_SCRIPT = ("params.w0 * _score + params.w1 * doc['f1'].value"
               " + params.w2 * doc['f2'].value")
CFG4_PARAMS = {"w0": 0.3, "w1": 4.0, "w2": 2.0}


class Corpus:
    """A Zipf segment with columns f1 / f2 (default_rng(99)'s first two
    draws, as BASELINE config 4 draws them), packed by the JAX package,
    its planes moved into the port, and a compiler on each side."""

    def __init__(self):
        self.jm, seg = jax_zipf(N_DOCS, vocab_size=120, seed=21)
        rng = np.random.default_rng(99)
        seg.doc_values["f1"] = rng.random(N_DOCS, dtype=np.float32)
        seg.doc_values["f2"] = rng.random(N_DOCS, dtype=np.float32)
        self.seg = seg
        self.jdev = jax_pack(seg)
        self.jtree = jbd.segment_tree(self.jdev)
        planes = {
            "fields": {k: [np.asarray(x) for x in v]
                       for k, v in self.jtree["fields"].items()},
            "doc_values": {k: np.asarray(v)
                           for k, v in self.jtree["doc_values"].items()},
            "live": np.asarray(self.jtree["live"]),
        }
        meta = {name: field_meta(f) for name, f in self.jdev.fields.items()}
        self.pdev = device_segment_from_numpy(planes, meta, device="cpu")
        self.ptree = pbd.segment_tree(self.pdev)
        self.jc = jcomp.Compiler(self.jdev.fields, self.jdev.doc_values,
                                 self.jm)
        self.pc = pcomp.Compiler(self.pdev.fields, self.pdev.doc_values,
                                 self.jm_port())
        fld = seg.fields["body"]
        self.by_df = sorted(fld.terms, key=lambda t: (-fld.df[fld.terms[t]], t))

    def jm_port(self):
        from elasticsearch_tpu_torch.index.mapping import Mappings

        return Mappings(properties={"body": {"type": "text"}})

    def batch(self, bodies):
        """Both packages' unified [Q, ...] plans of `bodies`: (JAX spec,
        JAX arrays, port spec, port tensors)."""
        pairs = []
        for body in bodies:
            a = self.jc.compile(jax_parse(body))
            b = self.pc.compile(parse_query(body))
            assert a.spec == b.spec, body
            same_arrays(a.arrays, b.arrays, body)
            pairs.append((a, b))
        jspec = jcomp.unify_specs([a.spec for a, _ in pairs])
        pspec = pcomp.unify_specs([b.spec for _, b in pairs])
        assert jspec == pspec
        jarr = [jcomp.pad_arrays_to_spec(a.spec, jspec, a.arrays)
                for a, _ in pairs]
        parr = [pcomp.pad_arrays_to_spec(b.spec, pspec, b.arrays)
                for _, b in pairs]
        jb = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *jarr)
        pb = pbd.plan_to_torch(pspec, pbd.stack_plans(parr), "cpu")
        return jspec, jb, pspec, pb


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


def same_bits(jax_out, port_out, where):
    """Every slot of (scores, ids, totals) equal, scores as fp32 bits."""
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        p = p.numpy()
        assert j.shape == p.shape and j.dtype == p.dtype, (where, j.shape,
                                                           p.shape)
        if j.dtype == np.float32:
            j, p = j.view(np.int32), p.view(np.int32)
        np.testing.assert_array_equal(p, j, err_msg=str(where))


def solo(plan, r: int):
    """Row r of a [Q, ...] port plan as a solo plan (no leading axis)."""
    if isinstance(plan, dict):
        return {key: solo(val, r) for key, val in plan.items()}
    if isinstance(plan, (tuple, list)):
        return tuple(solo(v, r) for v in plan)
    return plan[r]


@pytest.fixture(scope="module")
def corpus():
    return Corpus()


def _match_bodies(c, n, seed, terms=3):
    rng = np.random.default_rng(seed)
    mid = c.by_df[4:60]
    return [{"match": {"body": " ".join(rng.choice(mid, terms, replace=False))}}
            for _ in range(n)]


def _should_bodies(c, n, seed):
    rng = np.random.default_rng(seed)
    mid = c.by_df[4:60]
    return [{"bool": {"should": [
        {"match": {"body": " ".join(rng.choice(mid, 2, replace=False))}},
        {"term": {"body": str(rng.choice(c.by_df[:4]))}},
    ]}} for _ in range(n)]


def _script_bodies(c, n, seed, source="_score / params.a + doc['f1'].value"):
    rng = np.random.default_rng(seed)
    return [{"script_score": {
        "query": {"match": {"body": " ".join(rng.choice(c.by_df[4:60], 2))}},
        "script": {"source": source,
                   "params": {"a": float(rng.random() + 0.5)}}}}
        for _ in range(n)]


# (name, bodies of one spec) run through the single-segment chains
CHAINS = [
    ("match", lambda c: _match_bodies(c, Q, 1)),
    ("match_one_term", lambda c: _match_bodies(c, Q, 2, terms=1)),
    ("bool_should", lambda c: _should_bodies(c, Q, 3)),
    ("script_score", lambda c: _script_bodies(c, Q, 4)),
]


@pytest.mark.parametrize("name,make", CHAINS, ids=[c[0] for c in CHAINS])
def test_execute_sequential_matches_the_jax_chain(corpus, name, make):
    jspec, jb, pspec, pb = corpus.batch(make(corpus))
    want = jbd.execute_sequential(corpus.jtree, jspec, jb, K)
    got = pbd.execute_sequential(corpus.ptree, pspec, pb, K)
    same_bits(want, got, name)
    # The chain's rows equal the batched program's: the perturbation is
    # +0.0 and no boost here is -0.0.
    same_bits([np.asarray(x) for x in pbd.execute_batch_auto(
        corpus.ptree, pspec, pb, K)], got, (name, "batch"))


def ulp_close(a, b, ulps: int) -> bool:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return bool(np.all((np.abs(a.astype(np.float64) - b) <= tol) | (a == b)))


def test_multiply_add_script_chain_within_the_script_tolerance(corpus):
    """A script with a multiply feeding an add: XLA contracts it into an
    FMA inside either of the JAX package's programs, the port rounds the
    product (test_torch_script.py's 4-ulp allowance). The chains add
    nothing to that: each package's chain equals its own per-query
    program bit for bit, and the two chains agree within 4 ulps, ids
    swapping only between scores within 4 ulps, totals exact."""
    bodies = _script_bodies(corpus, Q, 4, "_score * params.a + doc['f1'].value")
    jspec, jb, pspec, pb = corpus.batch(bodies)
    want = jbd.execute_sequential(corpus.jtree, jspec, jb, K)
    got = pbd.execute_sequential(corpus.ptree, pspec, pb, K)
    same_bits([np.asarray(x) for x in pbd.execute_batch(
        corpus.ptree, pspec, pb, K)], got, "port chain vs batch")
    same_bits([np.asarray(x) for x in want],
              [torch.from_numpy(np.array(x)) for x in jbd.execute_batch(
                  corpus.jtree, jspec, jb, K)], "jax chain vs batch")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    js, ji = np.asarray(want[0]), np.asarray(want[1])
    for r in range(Q):
        n = min(int(want[2][r]), K)
        ps, pi = got[0][r, :n].numpy(), got[1][r, :n].numpy()
        assert ulp_close(ps, js[r, :n], 4), r
        by_id = dict(zip(ji[r, :n].tolist(), js[r, :n]))
        for rank, did in enumerate(pi.tolist()):
            if did != int(ji[r, rank]):
                assert did in by_id and ulp_close(by_id[did], js[r, rank], 4)


def test_execute_sequential_sparse_matches_the_jax_chain(corpus):
    jspec, jb, pspec, pb = corpus.batch(_match_bodies(corpus, Q + 2, 5))
    assert pbd.supports_sparse(pspec)
    want = jbd.execute_sequential_sparse(corpus.jtree, jspec, jb, K)
    got = pbd.execute_sequential_sparse(corpus.ptree, pspec, pb, K)
    same_bits(want, got, "sparse")


def test_match_none_chain_takes_its_length(corpus):
    jspec, jb, pspec, pb = corpus.batch([{"match_none": {}}] * 3)
    want = jbd.execute_sequential(corpus.jtree, jspec, jb, K, length=3)
    got = pbd.execute_sequential(corpus.ptree, pspec, pb, K, length=3)
    same_bits(want, got, "match_none")
    assert got[0].shape == (3, K) and int(got[2].sum()) == 0
    with pytest.raises(ValueError):
        pbd.execute_sequential(corpus.ptree, pspec, pb, K)


def test_rescore_chain_matches_the_jax_chain(corpus):
    """BASELINE config 4's shape: matches rescored over a window by the
    cfg4 script over match_all."""
    bodies = _match_bodies(corpus, Q, 6)
    jspec, jb, pspec, pb = corpus.batch(bodies)
    rbody = {"script_score": {"query": {"match_all": {}}, "script": {
        "source": CFG4_SCRIPT, "params": CFG4_PARAMS}}}
    rjspec, rjb, rpspec, rpb = corpus.batch([rbody] * Q)
    window = 40
    want = jbd.execute_rescore_sequential(corpus.jtree, jspec, jb, rjspec,
                                          rjb, K, window, 1.0, 1.0)
    got = pbd.execute_rescore_sequential(corpus.ptree, pspec, pb, rpspec,
                                         rpb, K, window, 1.0, 1.0)
    same_bits(want, got, "rescore")
    for r in range(Q):
        one = pbd.execute_rescore(
            corpus.ptree, pspec, solo(pb, r), rpspec,
            solo(rpb, r), K, window, 1.0, 1.0)
        for a, b in zip(one, got):
            assert np.array_equal(a.numpy().reshape(-1).view(np.uint8),
                                  b[r].numpy().reshape(-1).view(np.uint8)), r


NEG_ZERO_BODIES = [
    ("bool", lambda t: {"bool": {"should": [{"match": {"body": t}}],
                                 "boost": -0.0}}),
    ("constant_score", lambda t: {"constant_score": {
        "filter": {"term": {"body": t}}, "boost": -0.0}}),
]


@pytest.mark.parametrize("name,make", NEG_ZERO_BODIES,
                         ids=[b[0] for b in NEG_ZERO_BODIES])
def test_negative_zero_boost_chains_score_positive_zero(corpus, name, make):
    """`execute` scores the hits of a -0.0-boosted plan -0.0; the chain
    adds +0.0 to the boost first, so both packages' chains score +0.0."""
    terms = corpus.by_df[:Q]
    jspec, jb, pspec, pb = corpus.batch([make(t) for t in terms])
    want = jbd.execute_sequential(corpus.jtree, jspec, jb, K)
    got = pbd.execute_sequential(corpus.ptree, pspec, pb, K)
    same_bits(want, got, name)
    neg_zero = np.float32(-0.0).view(np.int32)
    for r in range(Q):
        n = min(int(got[2][r]), K)
        assert n > 0
        assert np.all(got[0][r, :n].numpy().view(np.int32) == 0), name
        row = jax.tree.map(lambda x: np.asarray(x)[r], jb)
        js, _ji, _jt = jbd.execute(corpus.jtree, jspec, row, K)
        assert np.all(np.asarray(js)[:n].view(np.int32) == neg_zero), name
        ps, _pi, _pt = pbd.execute(corpus.ptree, pspec,
                                   solo(pb, r), K)
        assert np.all(ps[:n].numpy().view(np.int32) == neg_zero), name


def test_chains_leave_the_staged_plan_unwritten_and_launch_nothing(corpus):
    _jspec, _jb, pspec, pb = corpus.batch(NEG_ZERO_BODIES[0][1](
        corpus.by_df[0]) for _ in range(2))
    boost = pb["boost"].clone()
    kernels.reset_launches()
    pbd.execute_sequential(corpus.ptree, pspec, pb, K)
    assert torch.equal(pb["boost"].view(torch.int32), boost.view(torch.int32))
    assert pb["boost"].view(torch.int32)[0] == np.float32(-0.0).view(np.int32)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# Stacked shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards():
    pairs = [(build_zipf_segment(n, vocab_size=90, seed=60 + s),
              jax_zipf(n, vocab_size=90, seed=60 + s))
             for s, n in enumerate(SHARD_DOCS)]
    psegs = [p[1] for p, _ in pairs]
    jsegs = [j[1] for _, j in pairs]
    n_pad = max(SHARD_DOCS)
    min_tiles = {"body": max(len(s.fields["body"].doc_ids) // TILE + 2
                             for s in psegs)}
    pdevs = [pack_segment(s, device="cpu", pad_docs_to=n_pad,
                          field_min_tiles=min_tiles) for s in psegs]
    jdevs = [jax_pack(s, pad_docs_to=n_pad, field_min_tiles=min_tiles)
             for s in jsegs]
    return {
        "pmap": pairs[0][0][0], "jmap": pairs[0][1][0], "psegs": psegs,
        "pdevs": pdevs, "jdevs": jdevs, "n_pad": n_pad,
        "ptree": pbd.stack_segment_trees([pbd.segment_tree(d) for d in pdevs]),
        "jtree": jax.tree.map(lambda *xs: np.stack(xs),
                              *[jbd.segment_tree(d) for d in jdevs]),
    }


def _stacked_plans(sh, bodies):
    """Each body compiled per shard with the shard's statistics, all
    equalized to one spec, stacked [Q, S, ...] on each side."""
    def side(devs, mappings, compiler_cls, parse, equalize):
        flat = equalize([
            compiler_cls(d.fields, d.doc_values, mappings).compile(parse(b))
            for b in bodies for d in devs])
        s = len(devs)
        per_query = [jax.tree.map(lambda *xs: np.stack(xs),
                                  *[c.arrays for c in flat[q * s:(q + 1) * s]])
                     for q in range(len(bodies))]
        return flat[0].spec, per_query

    pspec, pplans = side(sh["pdevs"], sh["pmap"], pcomp.Compiler, parse_query,
                         pcomp.equalize_compiled)
    jspec, jplans = side(sh["jdevs"], sh["jmap"], jcomp.Compiler, jax_parse,
                         jcomp.equalize_compiled)
    assert pspec == jspec
    jb = jax.tree.map(lambda *xs: np.stack(xs), *jplans)
    pb = pbd.plan_to_torch(pspec, pbd.stack_plans(pplans), "cpu")
    return jspec, jb, pspec, pb


def test_shards_chain_matches_the_jax_chain(shards):
    """bench.py cfg3's shape, bool(must 2-term match + filter head term),
    over 3 stacked shards of unequal doc counts."""
    fld = shards["psegs"][0].fields["body"]
    by_df = sorted(fld.terms, key=lambda t: (-fld.df[fld.terms[t]], t))
    rng = np.random.default_rng(8)
    bodies = []
    for _ in range(Q):
        m1, m2 = rng.choice(by_df[6:50], 2, replace=False)
        bodies.append({"bool": {
            "must": [{"match": {"body": f"{m1} {m2}"}}],
            "filter": [{"term": {"body": str(rng.choice(by_df[:3]))}}]}})
    jspec, jb, pspec, pb = _stacked_plans(shards, bodies)
    n_pad = shards["n_pad"]
    want = jbd.execute_shards_sequential(shards["jtree"], jspec, jb, K, n_pad)
    got = pbd.execute_shards_sequential(shards["ptree"], pspec, pb, K, n_pad)
    same_bits(want, got, "shards")
    same_bits([np.asarray(x) for x in pbd.execute_shards_batch(
        shards["ptree"], pspec, pb, K, n_pad)], got, "shards batch")


# ---------------------------------------------------------------------------
# K15's plain version
# ---------------------------------------------------------------------------

LEAF_BITS = [
    0x00000000, 0x80000000,  # +0.0, -0.0
    0x3F800000, 0xBF800000,  # +1, -1
    0x7F800000, 0xFF800000,  # +inf, -inf
    0x00000001, 0x807FFFFF,  # subnormals
    0x7F7FFFFF, 0x00800000,  # f32 max, smallest normal
    0x7FC00000, 0xFFC00000,  # quiet NaNs of both signs
    0x7FC12345, 0xFFC54321,  # quiet NaNs with payloads
    0x7F800001, 0xFF812345,  # signalling NaNs with payloads
]


@pytest.mark.parametrize("prev", [None, 0, 7, 123456789])
def test_chain_perturb_plain_is_numpy_float32_addition(prev):
    leaf = np.array(LEAF_BITS, dtype=np.uint32).view(np.float32)
    carry = np.float32(0.0 if prev is None else prev)
    with np.errstate(invalid="ignore"):
        want = (leaf + carry * np.float32(0.0)).view(np.int32)
    got = kernels.chain_perturb(
        torch.from_numpy(leaf.copy()),
        None if prev is None else torch.tensor([prev], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want)
    # -0.0 became +0.0; a NaN kept its sign and payload, quieted.
    assert got.numpy().view(np.uint32)[1] == 0
    assert got.numpy().view(np.uint32)[-1] == 0xFFC12345


def test_chain_perturb_refuses_malformed_inputs():
    leaf = torch.ones(3)
    with pytest.raises(TypeError):
        kernels.chain_perturb(leaf.double(), None)
    with pytest.raises(TypeError):
        kernels.chain_perturb(leaf, torch.tensor([1], dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.chain_perturb(leaf, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.chain_perturb(torch.ones(4, 2).t(), None)
