"""Port stacked single-device shards against the JAX package: padded
`pack_segment` planes, `equalize_compiled`, `execute_shards` and
`execute_shards_batch`, and the stacked kernel modes' plain versions.

Four shards of uneven size (one smaller than k) are packed by each
package with a common `pad_docs_to` and `field_min_tiles`, each query is
compiled per shard with that shard's own statistics and equalized to one
spec; the port runs its own pack, compiler and executors, the JAX package
its own. Tolerance: none — ids, order, fp32 score bits and totals equal.
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
from elasticsearch_tpu_torch.ops import kernels as K
from elasticsearch_tpu_torch.query.compile import Compiler, equalize_compiled
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

SHARD_DOCS = (1400, 1003, 610, 9)  # the last shard holds fewer docs than k
K_BIG = 20


def _pad_sizes(segments):
    n_pad = max(s.num_docs for s in segments)
    min_tiles = {
        "body": max(len(s.fields["body"].doc_ids) // TILE + 2 for s in segments)
    }
    return n_pad, min_tiles


@pytest.fixture(scope="module")
def shards():
    import jax

    pairs = [
        (build_zipf_segment(n, vocab_size=120, seed=40 + s),
         jzipf(n, vocab_size=120, seed=40 + s))
        for s, n in enumerate(SHARD_DOCS)
    ]
    psegs = [p[1] for p, _ in pairs]
    jsegs = [j[1] for _, j in pairs]
    n_pad, min_tiles = _pad_sizes(psegs)
    pdevs = [pack_segment(s, device="cpu", pad_docs_to=n_pad,
                          field_min_tiles=min_tiles) for s in psegs]
    jdevs = [jpack_segment(s, pad_docs_to=n_pad, field_min_tiles=min_tiles)
             for s in jsegs]
    ptree = tbd.stack_segment_trees([tbd.segment_tree(d) for d in pdevs])
    jtree = jax.tree.map(lambda *xs: np.stack(xs),
                         *[jbd.segment_tree(d) for d in jdevs])
    return {
        "pmap": pairs[0][0][0], "jmap": pairs[0][1][0],
        "psegs": psegs, "jsegs": jsegs, "pdevs": pdevs, "jdevs": jdevs,
        "ptree": ptree, "jtree": jtree, "n_pad": n_pad,
    }


def _terms_by_df(seg):
    fld = seg.fields["body"]
    return sorted(fld.terms, key=lambda t: (-fld.df[fld.terms[t]], t))


def _bodies(seg, shape: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    by_df = _terms_by_df(seg)
    head, mid = by_df[:4], by_df[6:80]
    out = []
    for _ in range(n):
        if shape == "match":
            out.append({"match": {"body": " ".join(rng.choice(mid, 3, replace=False))}})
        elif shape == "rare_match":
            out.append({"match": {"body": " ".join(rng.choice(by_df[-30:], 2))}})
        elif shape == "must_filter":  # bench.py cfg3's shape
            m1, m2 = rng.choice(mid, 2, replace=False)
            out.append({"bool": {
                "must": [{"match": {"body": f"{m1} {m2}"}}],
                "filter": [{"term": {"body": str(rng.choice(head))}}],
            }})
        elif shape == "filter_led":  # a tail filter leads the conjunction
            out.append({"bool": {
                "must": [{"match": {"body": " ".join(rng.choice(head, 2))}}],
                "filter": [{"term": {"body": str(rng.choice(by_df[-40:]))}}],
            }})
        elif shape == "terms_filter":  # a two-value filter: K1 matched-only
            m1, m2 = rng.choice(mid, 2, replace=False)
            out.append({"bool": {
                "must": [{"match": {"body": f"{m1} {m2}"}}],
                "filter": [{"terms": {"body": [str(t) for t in rng.choice(mid, 2)]}}],
            }})
        elif shape == "should":  # dense
            out.append({"bool": {"should": [
                {"match": {"body": " ".join(rng.choice(mid, 2))}},
                {"term": {"body": str(rng.choice(head))}},
            ]}})
    return out


def _compile_both(sh, bodies):
    """Per query: each package compiles it against every shard with that
    shard's statistics and equalizes; then every query's per-shard plans
    are equalized to one spec (mixed leads fold to -1) and stacked
    [Q, S, ...]. Returns (port spec, port plans, JAX spec, JAX plans)."""
    import jax

    def side(devs, mappings, compiler_cls, parse, equalize):
        flat = equalize([
            compiler_cls(d.fields, d.doc_values, mappings).compile(parse(b))
            for b in bodies for d in devs
        ])
        s = len(devs)
        per_query = [
            jax.tree.map(lambda *xs: np.stack(xs),
                         *[c.arrays for c in flat[q * s:(q + 1) * s]])
            for q in range(len(bodies))
        ]
        return flat[0].spec, per_query

    pspec, pplans = side(sh["pdevs"], sh["pmap"], Compiler, parse_query,
                         equalize_compiled)
    jspec, jplans = side(sh["jdevs"], sh["jmap"], JCompiler, jparse, jequalize)
    return pspec, pplans, jspec, jplans


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape)
        if g.dtype == np.float32:
            g, r = g.view(np.int32), r.view(np.int32)
        np.testing.assert_array_equal(g, r)


def test_padded_pack_segment_planes_equal_reference(shards):
    import jax

    for pdev, jdev, seg in zip(shards["pdevs"], shards["jdevs"], shards["psegs"]):
        pt, jt = tbd.segment_tree(pdev), jbd.segment_tree(jdev)
        for p, r in zip(pt["fields"]["body"], jt["fields"]["body"]):
            r = np.asarray(r)
            assert p.numpy().dtype == r.dtype
            assert np.array_equal(p.numpy(), r)
        live = pt["live"].numpy()
        assert np.array_equal(live, np.asarray(jt["live"]))
        assert live.shape == (shards["n_pad"],)
        # Padded docs are never live, never present.
        assert not live[seg.num_docs:].any() and live[: seg.num_docs].all()
        assert not pt["fields"]["body"][4].numpy()[seg.num_docs:].any()
        pf, jf = pdev.fields["body"], jdev.fields["body"]
        for attr in ("tile_max", "tile_doc_lo", "tile_doc_hi"):
            assert np.array_equal(getattr(pf, attr), getattr(jf, attr)), attr
        assert pf.pad_tile == jf.pad_tile
    # Equal shapes across shards: the trees stack.
    shapes = {tuple(d.fields["body"].doc_ids.shape) for d in shards["pdevs"]}
    assert len(shapes) == 1
    jstacked = shards["jtree"]
    for p, r in zip(shards["ptree"]["fields"]["body"], jstacked["fields"]["body"]):
        assert np.array_equal(p.numpy(), np.asarray(r))
    assert np.array_equal(shards["ptree"]["live"].numpy(), jax.device_get(jstacked["live"]))


def test_pack_field_min_tiles_pads_with_sentinel_tiles():
    _, seg = build_zipf_segment(300, vocab_size=50, seed=3)
    natural = pack_segment(seg, device="cpu").fields["body"]
    nt = natural.doc_ids.shape[0]
    padded = pack_segment(seg, device="cpu", pad_docs_to=350,
                          field_min_tiles={"body": nt + 3}).fields["body"]
    assert padded.doc_ids.shape == (nt + 3, TILE)
    assert (padded.doc_ids[nt - 1:] == 350).all()  # sentinel = padded N
    assert (padded.tn[nt:] == 0).all() and (padded.tfs[nt:] == 0).all()
    assert padded.norm_bytes.shape == (351,)


@pytest.mark.parametrize("shape", ["match", "must_filter", "should", "filter_led"])
def test_equalize_compiled_equals_reference(shards, shape):
    bodies = _bodies(shards["psegs"][0], shape, 3, seed=5)
    for body in bodies:
        pc = equalize_compiled([
            Compiler(d.fields, d.doc_values, shards["pmap"]).compile(parse_query(body))
            for d in shards["pdevs"]])
        jc = jequalize([
            JCompiler(d.fields, d.doc_values, shards["jmap"]).compile(jparse(body))
            for d in shards["jdevs"]])
        assert [c.spec for c in pc] == [c.spec for c in jc]
        assert len({c.spec for c in pc}) == 1
        import jax

        for p, j in zip(pc, jc):
            pl, jl = jax.tree.leaves(p.arrays), jax.tree.leaves(j.arrays)
            assert len(pl) == len(jl)
            for a, b in zip(pl, jl):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                assert np.array_equal(np.asarray(a), np.asarray(b))


def test_equalize_compiled_keeps_equal_specs():
    from elasticsearch_tpu_torch.query.compile import CompiledQuery

    plans = [CompiledQuery(spec=("match_all",), arrays={"boost": np.float32(1)})
             for _ in range(3)]
    assert equalize_compiled(plans) is plans


SHAPES = ["match", "rare_match", "must_filter", "filter_led", "terms_filter",
          "should"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [10, K_BIG])
def test_execute_shards_batch_equals_reference(shards, shape, k):
    bodies = _bodies(shards["psegs"][0], shape, 4, seed=11)
    pspec, pplans, jspec, jplans = _compile_both(shards, bodies)
    assert pspec == jspec
    assert tbd.supports_sparse(pspec) == jbd.supports_sparse(jspec)
    batched = tbd.stack_plans(jplans)
    ref = jbd.execute_shards_batch(shards["jtree"], jspec, batched, k,
                                   shards["n_pad"])
    plan = tbd.plan_to_torch(pspec, tbd.stack_plans(pplans), "cpu")
    got = tbd.execute_shards_batch(shards["ptree"], pspec, plan, k,
                                   shards["n_pad"])
    _assert_same([x.numpy() for x in got], ref)
    # And one query at a time through execute_shards.
    for q in range(len(bodies)):
        ref1 = jbd.execute_shards(shards["jtree"], jspec, jplans[q], k,
                                  shards["n_pad"])
        got1 = tbd.execute_shards(
            shards["ptree"], pspec, tbd.plan_to_torch(pspec, pplans[q], "cpu"),
            k, shards["n_pad"])
        _assert_same([x.numpy() for x in got1], ref1)


def test_execute_shards_matches_per_shard_merge(shards):
    """The stacked result is the per-shard results merged by (score desc,
    shard, rank), with global id = local + shard * docs_per_shard and the
    totals summed — checked with the port's own one-segment executor."""
    bodies = _bodies(shards["psegs"][0], "must_filter", 3, seed=2)
    pspec, pplans, _js, _jp = _compile_both(shards, bodies)
    n_pad = shards["n_pad"]
    for q in range(len(bodies)):
        got = tbd.execute_shards(
            shards["ptree"], pspec, tbd.plan_to_torch(pspec, pplans[q], "cpu"),
            K_BIG, n_pad)
        rows, total = [], 0
        for s, dev in enumerate(shards["pdevs"]):
            sc, ids, t = tbd.execute_auto(
                tbd.segment_tree(dev), pspec,
                tbd.plan_to_torch(pspec, _shard_plan(pplans[q], s), "cpu"),
                K_BIG)
            total += int(t)
            for rank in range(min(K_BIG, int(t))):
                rows.append((-float(sc[rank]), s, rank,
                             int(ids[rank]) + s * n_pad, float(sc[rank])))
        rows.sort(key=lambda r: r[:3])
        n = len(rows[:K_BIG])
        assert got[1][:n].tolist() == [r[3] for r in rows[:K_BIG]]
        assert got[0][:n].tolist() == [r[4] for r in rows[:K_BIG]]
        assert int(got[2]) == total
        assert (got[0][n:] == float("-inf")).all()


def _shard_plan(plan, s):
    """Shard s's plan out of a [S, ...] plan."""
    if isinstance(plan, dict):
        return {k: _shard_plan(v, s) for k, v in plan.items()}
    if isinstance(plan, tuple):
        return tuple(_shard_plan(v, s) for v in plan)
    return np.asarray(plan)[s]


def test_execute_shards_refuses_one_segment(shards):
    bodies = _bodies(shards["psegs"][0], "match", 1, seed=1)
    pspec, pplans, _js, _jp = _compile_both(shards, bodies)
    one = tbd.segment_tree(shards["pdevs"][0])
    with pytest.raises(ValueError, match="stacked"):
        tbd.execute_shards(one, pspec, tbd.plan_to_torch(pspec, pplans[0], "cpu"),
                           10, shards["n_pad"])


# ---------------------------------------------------------------------------
# The stacked kernel modes' plain versions against a per-shard loop
# ---------------------------------------------------------------------------


def _stacked_rows(shards, shape, q=3):
    """A [Q * S] row plan of one shape, and the stacked field planes."""
    bodies = _bodies(shards["psegs"][0], shape, q, seed=17)
    pspec, pplans, _js, _jp = _compile_both(shards, bodies)
    plan = tbd.plan_to_torch(pspec, tbd.stack_plans(pplans), "cpu")
    return pspec, tbd._pair_rows(plan), shards["ptree"]["fields"]["body"]


def test_stacked_k1_k2_plain_equal_per_shard_loop(shards):
    spec, rows, (doc_tiles, tn, _tfs, norm, _present) = _stacked_rows(shards, "match")
    s_count = doc_tiles.shape[0]
    live = shards["ptree"]["live"]
    n = live.shape[1]
    k2 = K.sparse_fold_stacked(doc_tiles, tn, rows["tile_ids"], rows["starts"],
                               rows["ends"], rows["weights"], live, n, spec[3])
    k1 = K.terms_scatter_stacked(doc_tiles, tn, norm, rows["tile_ids"],
                                 rows["starts"], rows["ends"], rows["weights"],
                                 n, rows["_groups"])
    k1m = K.terms_scatter_stacked(doc_tiles, tn, norm, rows["tile_ids"],
                                  rows["starts"], rows["ends"], None, n,
                                  rows["_groups"], matched_only=True)
    for r in range(rows["tile_ids"].shape[0]):
        s = r % s_count
        sl = slice(r, r + 1)
        want2 = K.sparse_fold_batch(doc_tiles[s], tn[s], rows["tile_ids"][sl],
                                    rows["starts"][sl], rows["ends"][sl],
                                    rows["weights"][sl], live[s], n, spec[3])
        for g, w in zip(k2, want2):
            assert torch.equal(g[r], w[0])
        want1 = K.terms_scatter_batch(doc_tiles[s], tn[s], norm[s],
                                      rows["tile_ids"][sl], rows["starts"][sl],
                                      rows["ends"][sl], rows["weights"][sl], n,
                                      rows["_groups"][sl])
        assert torch.equal(k1[0][r].view(torch.int32), want1[0][0].view(torch.int32))
        assert torch.equal(k1[1][r], want1[1][0])
        assert torch.equal(k1m[1][r], want1[1][0])
    assert K.LAUNCHES["sparse_fold_stacked"] == 0  # plain runs do not count


def test_stacked_k3_k4_plain_equal_per_shard_loop(shards):
    _spec, rows, (doc_tiles, *_rest) = _stacked_rows(shards, "filter_led")
    s_count = doc_tiles.shape[0]
    flat = doc_tiles.reshape(s_count, -1)
    must = rows["children"][0]
    r_count = must["term_starts"].shape[0]
    rng = np.random.default_rng(4)
    cands = torch.from_numpy(
        rng.integers(0, shards["n_pad"], (r_count, 300)).astype(np.int32))
    cands, _ = torch.sort(cands, dim=1)
    pos, found = K.span_locate_stacked(flat, must["term_starts"],
                                       must["term_ends"], 0, cands)
    key = torch.from_numpy(rng.standard_normal((r_count, 500)).astype(np.float32))
    key[:, ::7] = float("-inf")
    elig = torch.isfinite(key)
    top = K.masked_topk_stacked(key, elig, 12, s_count)
    for r in range(r_count):
        sl = slice(r, r + 1)
        wp, wf = K.span_locate_batch(flat[r % s_count], must["term_starts"][sl],
                                     must["term_ends"][sl], 0, cands[sl])
        assert torch.equal(pos[r], wp[0]) and torch.equal(found[r], wf[0])
        want = K.masked_topk_batch(key[sl], elig[sl], 12)
        for g, w in zip(top, want):
            assert torch.equal(g[r], w[0])


def test_stacked_wrappers_check_their_shapes(shards):
    spec, rows, (doc_tiles, tn, _tfs, norm, _p) = _stacked_rows(shards, "match")
    live = shards["ptree"]["live"]
    n = live.shape[1]
    with pytest.raises(ValueError, match="whole"):  # rows not Q x S pairs
        K.sparse_fold_stacked(doc_tiles, tn, rows["tile_ids"][:-1],
                              rows["starts"][:-1], rows["ends"][:-1],
                              rows["weights"][:-1], live, n, spec[3])
    with pytest.raises(ValueError, match="shards"):  # live of other shards
        K.sparse_fold_stacked(doc_tiles, tn, rows["tile_ids"], rows["starts"],
                              rows["ends"], rows["weights"], live[:2], n, spec[3])
    with pytest.raises(ValueError, match="3-d"):  # one segment's planes
        K.terms_scatter_stacked(doc_tiles[0], tn[0], norm[0], rows["tile_ids"],
                                rows["starts"], rows["ends"], rows["weights"],
                                n, rows["_groups"])
    with pytest.raises(ValueError, match="whole"):
        K.masked_topk_stacked(torch.zeros((5, 8)), torch.ones((5, 8), dtype=torch.bool),
                              3, 4)
