"""Port batched execution against the JAX package: `execute_batch`,
`execute_batch_sparse` and `execute_many` on Q stacked plans.

The JAX side packs the segment, compiles each query, equalizes a batch's
specs with its own `unify_specs` + `pad_arrays_to_spec` (as its
micro-batcher does) and stacks the arrays with numpy; the port gets the
very same planes and the very same stacked arrays (`plan_to_torch`). The
tolerance is none: the whole [Q, k] outputs, -inf padding included, are
equal — ids, order, fp32 score bits and totals.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine
from elasticsearch_tpu.index.mapping import Mappings
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.compile import (
    CompiledQuery as JaxCompiled,
    pad_arrays_to_spec as jax_pad,
    unify_specs as jax_unify,
)
from elasticsearch_tpu.query.dsl import parse_query
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.ops import kernels as K
from elasticsearch_tpu_torch.query import compile as tcompile

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

VOCAB = [f"w{i:02d}" for i in range(28)]
TAGS = ["red", "green", "blue"]
TOP_K = 10


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    probs = 1.0 / (np.arange(1, len(VOCAB) + 1) ** 1.1)
    probs /= probs.sum()
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
        eng.index(
            {
                "body": " ".join(rng.choice(VOCAB, int(rng.integers(3, 16)), p=probs)),
                "tag": "rare" if i % 37 == 0 else str(rng.choice(TAGS)),
                "rank": int(rng.integers(0, 1000)),
            },
            f"d{i}",
        )
    eng.refresh()
    for i in range(0, 600, 11):
        eng.delete(f"d{i}")
    eng.refresh()
    handle = eng.segments[0]
    tree = jbd.segment_tree(handle.device)
    planes = {
        "fields": {
            name: tuple(np.asarray(x) for x in leaves)
            for name, leaves in tree["fields"].items()
        },
        "doc_values": {n: np.asarray(c) for n, c in tree["doc_values"].items()},
        "live": np.asarray(tree["live"]),
    }
    meta = {name: field_meta(f) for name, f in handle.device.fields.items()}
    pseg = device_segment_from_numpy(planes, meta, device="cpu")
    return eng.compiler_for(handle), tree, tbd.segment_tree(pseg)


def _words(rng, n: int, vocab=VOCAB) -> str:
    return " ".join(rng.choice(vocab, n))


# Each shape gives bodies that compile to one structure (equal clause and
# term counts), so a batch unifies to one spec with padded rows.
SHAPES = {
    "terms": lambda rng: {"match": {"body": _words(rng, 4)}},
    # Tail terms: a worklist of one or two tiles, fewer slots than k.
    "rare_terms": lambda rng: {"match": {"body": _words(rng, 2, VOCAB[20:])}},
    "should": lambda rng: {"bool": {"should": [
        {"match": {"body": _words(rng, 2)}},
        {"match": {"body": _words(rng, 1)}},
    ]}},
    # A head-term filter: the must's summed df undercuts it, so the must
    # leads (the BASELINE config-3 shape).
    "must_led": lambda rng: {"bool": {
        "must": [{"match": {"body": _words(rng, 2, VOCAB[8:])}}],
        "filter": [{"term": {"body": "w00"}}],
    }},
    "filter_led": lambda rng: {"bool": {
        "must": [{"match": {"body": _words(rng, 3)}}],
        "filter": [{"term": {"tag": "rare"}}],
    }},
    "must_not": lambda rng: {"bool": {
        "must": [{"match": {"body": _words(rng, 2)}}],
        "must_not": [{"term": {"tag": str(rng.choice(TAGS))}}],
    }},
    "dense_conj": lambda rng: {"bool": {
        "must": [{"match": {"body": _words(rng, 2)}}],
        "filter": [{"range": {"rank": {"gte": int(rng.integers(0, 900))}}},
                   {"terms": {"tag": ["red", "rare"]}}],
    }},
}


def _batch(compiler, shape: str, q: int, seed: int):
    """Q bodies of one shape compiled, unified to one spec and padded by
    the JAX package, then stacked on the host."""
    rng = np.random.default_rng(seed)
    compiled = [
        compiler.compile(parse_query(SHAPES[shape](rng))) for _ in range(q)
    ]
    target = jax_unify([c.spec for c in compiled])
    padded = [jax_pad(c.spec, target, c.arrays) for c in compiled]
    arrays_b = tbd.stack_plans(padded)
    return target, arrays_b, compiled


def _run_both(tree, ptree, spec, arrays_b, k):
    sparse = jbd.supports_sparse(spec)
    assert tbd.supports_sparse(spec) == sparse
    jfn = jbd.execute_batch_sparse if sparse else jbd.execute_batch
    tfn = tbd.execute_batch_sparse if sparse else tbd.execute_batch
    ref = tuple(np.asarray(x) for x in jfn(tree, spec, arrays_b, k))
    plan = tbd.plan_to_torch(spec, arrays_b, "cpu")
    got = tuple(x.numpy() for x in tfn(ptree, spec, plan, k))
    return got, ref


def _assert_equal(got, ref, label):
    (gs, gi, gt), (rs, ri, rt) = got, ref
    assert gs.shape == rs.shape and gi.shape == ri.shape, label
    assert np.array_equal(gt, rt), (label, gt, rt)
    assert np.array_equal(gi, ri.astype(gi.dtype)), (label, gi, ri)
    assert np.array_equal(gs.view(np.int32), rs.view(np.int32)), (label, gs, rs)


@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_execute_batch_matches_reference(corpus, shape, q):
    compiler, tree, ptree = corpus
    spec, arrays_b, compiled = _batch(compiler, shape, q, seed=q * 101 + len(shape))
    if shape == "filter_led":
        assert spec[6] >= 0  # the rare filter leads every row
    if shape == "must_led":
        assert spec[6] == -1
    got, ref = _run_both(tree, ptree, spec, arrays_b, TOP_K)
    _assert_equal(got, ref, (shape, q, spec))
    # Padded rows score exactly as their natural-bucket solo compiles.
    for row, c in enumerate(compiled):
        plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
        solo = tuple(x.numpy() for x in tbd.execute_auto(ptree, c.spec, plan, TOP_K))
        _assert_equal(
            tuple(x[None] for x in solo),
            tuple(np.asarray(x)[row : row + 1] for x in ref),
            (shape, q, "row", row),
        )


@pytest.mark.parametrize("shape", ["rare_terms", "filter_led", "should"])
def test_k_beyond_candidate_slots_and_corpus(corpus, shape):
    """k larger than a row's candidate slots (sparse: pads with -inf/0)
    and larger than the corpus (dense: clamps to N) — the batch's k_max
    above every rider's own k."""
    compiler, tree, ptree = corpus
    spec, arrays_b, _ = _batch(compiler, shape, 3, seed=77)
    got, ref = _run_both(tree, ptree, spec, arrays_b, 700)
    _assert_equal(got, ref, (shape, spec))
    n_docs = int(ptree["live"].shape[0])
    assert got[0].shape[1] == min(700, n_docs)
    if shape == "rare_terms":
        assert spec[2] * K.TILE < 600  # fewer candidate slots than k
        assert np.isneginf(got[0][:, -1]).all()


def test_execute_many_matches_reference(corpus):
    compiler, tree, ptree = corpus
    rng = np.random.default_rng(5)
    bodies = [SHAPES[s](rng) for s in sorted(SHAPES) for _ in range(3)]
    bodies += [{"match_none": {}}, {"match_all": {}},
               {"exists": {"field": "rank"}}, {"match": {"body": _words(rng, 40)}}]
    compiled = [compiler.compile(parse_query(b)) for b in bodies]
    ported = [tcompile.CompiledQuery(spec=c.spec, arrays=c.arrays) for c in compiled]
    got = tbd.execute_many(ptree, ported, TOP_K)
    # The reference's execute_many vmaps each spec group; match_none has no
    # array leaf to vmap over, so it runs alone (as its _device_batch does).
    plain = [c for c in compiled if c.spec[0] != "match_none"]
    ref = jbd.execute_many(tree, [JaxCompiled(c.spec, c.arrays) for c in plain], TOP_K)
    ref_iter = iter(ref)
    for body, c, g in zip(bodies, compiled, got):
        if c.spec[0] == "match_none":
            r = tuple(np.asarray(x) for x in jbd.execute_auto(tree, c.spec, c.arrays, TOP_K))
            r = (r[0], r[1], int(r[2]))
        else:
            r = next(ref_iter)
        assert g[2] == r[2], body
        assert np.array_equal(g[1], np.asarray(r[1]).astype(g[1].dtype)), body
        assert np.array_equal(
            np.asarray(g[0]).view(np.int32), np.asarray(r[0]).view(np.int32)
        ), body


def test_stacked_plan_keeps_dtypes_and_row_groups(corpus):
    compiler, _tree, _ptree = corpus
    spec, arrays_b, compiled = _batch(compiler, "should", 3, seed=9)
    plan = tbd.plan_to_torch(spec, arrays_b, "cpu")
    child = plan["children"][0]
    assert child["tile_ids"].shape[0] == 3 and child["tile_ids"].dtype == torch.int32
    groups = child["_groups"]
    assert groups.ndim == 3 and groups.shape[0] == 3
    for row in range(3):
        solo = K.term_groups(*(np.asarray(arrays_b["children"][0][key][row])
                               for key in ("tile_ids", "starts", "ends")))
        assert np.array_equal(groups[row, : len(solo)], solo)
        assert not groups[row, len(solo):].any()  # empty [0, 0) padding


def test_batched_wrappers_refuse_what_kernels_do_not_take(corpus):
    _compiler, _tree, ptree = corpus
    doc_tiles, tn, _tfs, norm, _present = ptree["fields"]["body"]
    live = ptree["live"]
    n = int(live.shape[0])
    w2 = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):  # rows differ between worklist arrays
        K.sparse_fold_batch(doc_tiles, tn, w2, w2[:1], w2, torch.zeros((2, 4)),
                            live, n, 4)
    with pytest.raises(ValueError):  # groups for the wrong row count
        K.terms_scatter_batch(doc_tiles, tn, norm, w2, w2, w2,
                              torch.zeros((2, 4)), n,
                              np.zeros((3, 1, 2), np.int32))
    with pytest.raises(ValueError):
        K.masked_topk_batch(torch.zeros((2, 5)), torch.ones((2, 4), dtype=torch.bool), 1)
    with pytest.raises(ValueError):  # span column out of range
        K.span_locate_batch(doc_tiles.reshape(-1), w2, w2, 4, w2)
    with pytest.raises(TypeError):
        K.masked_topk_batch(torch.zeros((2, 4), dtype=torch.float64),
                            torch.ones((2, 4), dtype=torch.bool), 1)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}  # CPU: plain only
