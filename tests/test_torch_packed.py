"""Port parity: packed multi-tenant execution (kernel-table row 13).

Eight small tenants (40-400 docs, default_rng(7), tenant 3 flooded with
the term "leak" that is rare elsewhere) are built by the same
SegmentBuilder calls in both packages. The JAX package packs each tenant
and concatenates them (`pack_segments_packed`); the port gets the very
same tenant planes (`device_segment_from_numpy`) and packs them with its
own `pack_segments_packed`. About 200 random queries of the reference
test's three shapes (tests/test_packed_multitenant.py: `match`,
bool(must match + filter term), bool(should [term, term], msm 1)) compile
through each side's `plane.member_fields(member)` and run through each
side's `execute_batch_packed`, grouped by spec.

Tolerance: exact. Per lane, the first min(k, total) slots (the slots the
serving path reads) have equal ids and order and bit-equal fp32 scores,
and the totals are equal; the slots past them are padding and are not
compared (the reference's padding ids are other tenants' ids minus lo).
Each lane also equals its query run on the tenant's own plane through
the port's solo executor. The plain versions of K2b's bounds mode and
K3b's window mode are held to direct torch formulas on edge windows.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JaxBuilder
from elasticsearch_tpu.index.tiles import pack_segment as jax_pack_segment
from elasticsearch_tpu.index.tiles import (
    pack_segments_packed as jax_pack_segments_packed,
)
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.compile import Compiler as JaxCompiler
from elasticsearch_tpu.query.dsl import parse_query as jax_parse
from elasticsearch_tpu_torch.exec.batcher import plan_spec_buckets
from elasticsearch_tpu_torch.exec.cost import coalesce_wins
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.tiles import (
    device_segment_from_numpy,
    field_meta,
    pack_segment,
    pack_segments_packed,
    packed_device_nbytes,
)
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.ops import kernels
from elasticsearch_tpu_torch.query.compile import (
    CompiledQuery,
    Compiler,
    pad_arrays_to_spec,
    unify_specs,
)
from elasticsearch_tpu_torch.query.dsl import parse_query

torch.set_num_threads(1)

K = 10
VOCAB = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "shared", "common", "leak",
]
PROPS = {"body": {"type": "text"}, "tag": {"type": "keyword"}}


def _docs(rng, n_docs, heavy_term=None, with_tag=False):
    """One tenant's documents, as the reference test draws them; with_tag
    adds a keyword field (so other tenants lack it)."""
    docs = []
    for i in range(n_docs):
        toks = list(rng.choice(VOCAB[:8], rng.integers(2, 7)))
        if heavy_term is not None:
            toks += [heavy_term] * int(rng.integers(3, 8))
        elif rng.random() < 0.05:
            toks.append("leak")
        doc = {"body": " ".join(toks)}
        if with_tag and i % 3:
            doc["tag"] = str(rng.choice(["x", "y"]))
        docs.append(doc)
    return docs


def _build(builder_cls, mappings, docs):
    builder = builder_cls(mappings)
    for i, doc in enumerate(docs):
        builder.add(doc, f"d{i}")
    return builder.build()


def _port_dev(jdev):
    """A JAX DeviceSegment's planes carried to the port, unchanged."""
    tree = jbd.segment_tree(jdev)
    planes = {
        "fields": {name: tuple(np.asarray(x) for x in leaves)
                   for name, leaves in tree["fields"].items()},
        "positions": {name: tuple(np.asarray(x) for x in pair)
                      for name, pair in tree["positions"].items()},
        "live": np.asarray(tree["live"]),
    }
    meta = {name: field_meta(f) for name, f in jdev.fields.items()}
    return device_segment_from_numpy(planes, meta, device="cpu")


@pytest.fixture(scope="module")
def tenants():
    """(JAX DeviceSegment, port DeviceSegment, port-built DeviceSegment,
    doc count) per tenant; tenant 5 alone has the keyword field `tag`."""
    rng = np.random.default_rng(7)
    jmap = JaxMappings(properties=PROPS)
    pmap = Mappings(properties=PROPS)
    out = []
    for t in range(8):
        docs = _docs(rng, int(rng.integers(40, 400)),
                     heavy_term="leak" if t == 3 else None, with_tag=t == 5)
        jdev = jax_pack_segment(_build(JaxBuilder, jmap, docs))
        pdev = pack_segment(_build(SegmentBuilder, pmap, docs), device="cpu")
        out.append((jdev, _port_dev(jdev), pdev, len(docs)))
    return out


@pytest.fixture(scope="module")
def planes(tenants):
    jplane = jax_pack_segments_packed([j for j, _p, _b, _n in tenants])
    pplane = pack_segments_packed([p for _j, p, _b, _n in tenants])
    return jplane, pplane


def random_query(rng) -> dict:
    roll = rng.random()
    if roll < 0.5:
        return {"match": {"body": " ".join(rng.choice(VOCAB, rng.integers(1, 4)))}}
    if roll < 0.8:
        return {"bool": {
            "must": [{"match": {"body": " ".join(rng.choice(VOCAB, rng.integers(1, 3)))}}],
            "filter": [{"term": {"body": str(rng.choice(VOCAB))}}],
        }}
    return {"bool": {
        "should": [{"term": {"body": str(rng.choice(VOCAB))}},
                   {"term": {"body": str(rng.choice(VOCAB))}}],
        "minimum_should_match": 1,
    }}


def _jax_lanes(jplane, lanes):
    """Each (member, body) lane through the JAX package's
    execute_batch_packed, one lane a launch (one jit trace per spec)."""
    tree = jbd.packed_segment_tree(jplane)
    jmap = JaxMappings(properties=PROPS)
    out = []
    for m, body in lanes:
        c = JaxCompiler(fields=jplane.member_fields(m), doc_values={},
                        mappings=jmap).compile(jax_parse(body))
        assert jbd.supports_packed(c.spec), c.spec
        lo, hi = jplane.member_bounds(m)
        s, i, t = (np.asarray(x) for x in jbd.execute_batch_packed(
            tree, c.spec, _stack([c.arrays]), np.array([lo], np.int32),
            np.array([hi], np.int32), K))
        out.append((c.spec, s[0], i[0], int(t[0])))
    return out


def _stack(arrays_list):
    first = arrays_list[0]
    if isinstance(first, dict):
        return {k: _stack([a[k] for a in arrays_list]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_stack(list(col)) for col in zip(*arrays_list))
    return np.stack([np.asarray(a) for a in arrays_list])


def _port_lanes(pplane, lanes, unify=False):
    """The lanes through the port's execute_batch_packed, grouped by spec
    (with `unify`, same-family groups merged as the executor merges them:
    plan_spec_buckets, unify_specs, pad_arrays_to_spec)."""
    tree = tbd.packed_segment_tree(pplane)
    pmap = Mappings(properties=PROPS)
    compiled = []
    for m, body in lanes:
        c = Compiler(fields=pplane.member_fields(m), doc_values={},
                     mappings=pmap).compile(parse_query(body))
        assert tbd.supports_packed(c.spec), c.spec
        compiled.append(c)
    groups: dict = {}
    for i, c in enumerate(compiled):
        groups.setdefault(c.spec, []).append(i)
    buckets = []
    if unify:
        for bucket in plan_spec_buckets([(s, len(ix)) for s, ix in groups.items()]):
            target = unify_specs(list(bucket))
            idxs = []
            for s in bucket:
                for i in groups[s]:
                    compiled[i] = CompiledQuery(target, pad_arrays_to_spec(
                        s, target, compiled[i].arrays))
                    idxs.append(i)
            buckets.append((target, idxs))
    else:
        buckets = list(groups.items())
    out: list = [None] * len(lanes)
    specs = [c.spec for c in compiled]
    for spec, idxs in buckets:
        arrays = tbd.plan_to_torch(
            spec, tbd.stack_plans([compiled[i].arrays for i in idxs]), "cpu")
        bounds = [pplane.member_bounds(lanes[i][0]) for i in idxs]
        s, ids, t = tbd.execute_batch_packed(
            tree, spec, arrays, [b[0] for b in bounds], [b[1] for b in bounds], K)
        for row, i in enumerate(idxs):
            out[i] = (specs[i], s[row].numpy(), ids[row].numpy(), int(t[row]))
    return out


def _solo(tenants, m, body):
    """The body on tenant m's own plane through the port's solo path."""
    dev = tenants[m][1]
    c = Compiler(fields=dev.fields, doc_values={},
                 mappings=Mappings(properties=PROPS)).compile(parse_query(body))
    s, i, t = tbd.execute_auto(
        tbd.segment_tree(dev), c.spec, tbd.plan_to_torch(c.spec, c.arrays, "cpu"), K)
    return s.numpy(), i.numpy(), int(t)


def _same(a, b, what):
    (sa, ia, ta), (sb, ib, tb) = a, b
    assert ta == tb, (what, ta, tb)
    n = min(K, ta)
    assert [int(x) for x in ia[:n]] == [int(x) for x in ib[:n]], what
    assert np.array_equal(np.asarray(sa[:n], np.float32).view(np.int32),
                          np.asarray(sb[:n], np.float32).view(np.int32)), what


@pytest.fixture(scope="module")
def fuzz_lanes(tenants):
    rng = np.random.default_rng(23)
    return [(int(rng.integers(0, len(tenants))), random_query(rng))
            for _ in range(200)]


@pytest.mark.parametrize("unify", [False, True], ids=["by_spec", "unified"])
def test_fuzz_parity_with_the_jax_package_and_solo(tenants, planes, fuzz_lanes,
                                                     unify):
    """~200 lanes of the three shapes: the port's packed lanes equal the
    JAX package's, and each equals the tenant's solo execution; the
    unified run pads cross-tenant buckets as the executor does."""
    jplane, pplane = planes
    want = _jax_lanes(jplane, fuzz_lanes)
    got = _port_lanes(pplane, fuzz_lanes, unify=unify)
    shapes = {"sparse": 0, "lead": 0, "dense": 0}
    for (m, body), (jspec, *jres), (pspec, *pres) in zip(fuzz_lanes, want, got):
        what = json.dumps([m, body])
        if not unify:
            assert pspec == jspec, what
        _same(pres, jres, what)
        _same(pres, _solo(tenants, m, body), what)
        n = min(K, pres[2])
        assert all(0 <= int(d) < tenants[m][3] for d in pres[1][:n]), what
        if not tbd.supports_sparse(pspec):
            shapes["dense"] += 1
        elif pspec[0] == "bool" and tbd._bool_lead(pspec) >= 0:
            shapes["lead"] += 1
        else:
            shapes["sparse"] += 1
    if not unify:  # unified buckets of mixed leads fold must-driven
        assert all(v > 0 for v in shapes.values()), shapes


def test_zero_cross_tenant_leakage(tenants, planes):
    """Tenant 3 floods "leak"; the others hold a few. Each tenant's search
    for it returns only its own docs and counts only its own matches."""
    jplane, pplane = planes
    lanes = [(m, {"match": {"body": "leak"}}) for m in range(len(tenants))]
    want = _jax_lanes(jplane, lanes)
    got = _port_lanes(pplane, lanes)
    for (m, body), (_js, *jres), (_ps, *pres) in zip(lanes, want, got):
        _same(pres, jres, m)
        _same(pres, _solo(tenants, m, body), m)
        n = min(K, pres[2])
        assert all(0 <= int(d) < tenants[m][3] for d in pres[1][:n])
    assert got[3][3] == tenants[3][3]  # every doc of the flooded tenant


def test_tenant_missing_term_returns_empty(tenants):
    """A term present only in other tenants gives zero hits and a zero
    total for a tenant without it: absence is per tenant."""
    rng = np.random.default_rng(5)
    docs = [{"body": " ".join(rng.choice(VOCAB[:5], 4))} for _ in range(50)]
    jdev = jax_pack_segment(_build(JaxBuilder, JaxMappings(properties=PROPS), docs))
    jplane = jax_pack_segments_packed([j for j, _p, _b, _n in tenants] + [jdev])
    pplane = pack_segments_packed([p for _j, p, _b, _n in tenants] + [_port_dev(jdev)])
    lanes = [(len(tenants), {"match": {"body": "leak"}}),
             (len(tenants), {"match": {"body": "leak alpha"}}),
             (3, {"match": {"body": "leak"}})]
    want = _jax_lanes(jplane, lanes)
    got = _port_lanes(pplane, lanes)
    assert got[0][3] == 0 and want[0][3] == 0
    for (_js, *jres), (_ps, *pres) in zip(want, got):
        _same(pres, jres, "missing term")


def test_supports_packed_agrees_with_the_reference(tenants):
    """supports_packed on the specs of every query shape, packable or not,
    compiled by each side against one tenant's own fields."""
    jdev, pdev = tenants[5][0], tenants[5][1]
    bodies = [
        {"match": {"body": "alpha bravo"}},
        {"term": {"tag": "x"}},
        {"terms": {"body": ["alpha", "leak"]}},
        {"constant_score": {"filter": {"term": {"body": "alpha"}}}},
        {"bool": {"must": [{"match": {"body": "alpha"}}],
                  "must_not": [{"term": {"tag": "y"}}]}},
        {"match_none": {}},
        {"match_all": {}},
        {"exists": {"field": "body"}},
        {"bool": {"should": [{"match_all": {}}, {"term": {"body": "alpha"}}]}},
        {"match_phrase": {"body": "alpha bravo"}},
    ]
    for body in bodies:
        jc = JaxCompiler(fields=jdev.fields, doc_values={},
                         mappings=JaxMappings(properties=PROPS)).compile(jax_parse(body))
        pc = Compiler(fields=pdev.fields, doc_values={},
                      mappings=Mappings(properties=PROPS)).compile(parse_query(body))
        assert pc.spec == jc.spec, body
        assert tbd.supports_packed(pc.spec) == jbd.supports_packed(jc.spec), body
    for spec in (None, (), ("range", "f"), ("script", ("match_all",), "1", (), False)):
        assert tbd.supports_packed(spec) == jbd.supports_packed(spec)


def test_packed_plane_matches_the_reference(tenants, planes):
    """The port's plane over the carried planes, and over the port's own
    segments, equals the JAX package's: global ids with every member's
    sentinel rewritten to the plane's, per-member impacts, norms and
    presence (zeros where a member lacks the field), live; and each
    member's view shifts offsets and per-tile metadata the same way."""
    jplane, pplane = planes
    bplane = pack_segments_packed([b for _j, _p, b, _n in tenants])
    n_total = jplane.num_docs
    for plane in (pplane, bplane):
        assert plane.num_docs == n_total
        assert plane.doc_base == list(jplane.doc_base)
        assert plane.doc_count == list(jplane.doc_count)
        assert set(plane.fields) == set(jplane.fields) == {"body", "tag"}
        assert np.array_equal(plane.live.numpy(), np.asarray(jplane.live))
        for name, jf in jplane.fields.items():
            pf = plane.fields[name]
            for attr in ("doc_ids", "tfs", "tn", "norm_bytes", "present"):
                assert np.array_equal(getattr(pf, attr).numpy(),
                                      np.asarray(getattr(jf, attr))), (name, attr)
            assert pf.tile_base == jf.tile_base
            for m, jv in jf.views.items():
                pv = pf.views[m]
                assert np.array_equal(pv.offsets, jv.offsets)
                lo, hi = pf.tile_base[m], pf.tile_base[m] + len(tenants[m][0].fields[name].tile_doc_lo)
                for attr in ("tile_max", "tile_doc_lo", "tile_doc_hi"):
                    assert np.array_equal(getattr(pv, attr)[lo:hi],
                                          np.asarray(getattr(jv, attr))[lo:hi]), attr
    # The sentinel rewrite: no member's own sentinel survives as an id, and
    # every padding slot names the plane's discard slot n_total.
    body = pplane.fields["body"]
    ids = body.doc_ids.numpy().reshape(-1)
    for m, (jdev, _p, _b, n) in enumerate(tenants):
        lo, hi = pplane.member_bounds(m)
        tiles = jdev.fields["body"].doc_ids.shape[0]
        own = body.doc_ids.numpy()[body.tile_base[m]: body.tile_base[m] + tiles]
        real = own[own != n_total]
        assert real.size and real.min() >= lo and real.max() < hi
    assert np.count_nonzero(ids == n_total) == sum(
        j.fields["body"].doc_ids.size - j.fields["body"].offsets[-1]
        for j, _p, _b, _n in tenants)
    # Absent members: `tag` only in tenant 5; the others read norm 0 and
    # not-present over their doc ranges.
    tag = pplane.fields["tag"]
    assert set(tag.views) == {5}
    for m in range(len(tenants)):
        lo, hi = pplane.member_bounds(m)
        if m != 5:
            assert not tag.present.numpy()[lo:hi].any()
            assert not tag.norm_bytes.numpy()[lo:hi].any()
    assert tag.norm_bytes.shape[0] == n_total + 1
    assert packed_device_nbytes(pplane) == sum(
        x.nbytes for pf in pplane.fields.values()
        for x in (pf.doc_ids, pf.tfs, pf.tn, pf.norm_bytes, pf.present)
    ) + pplane.live.nbytes


def _window_rows():
    """Edge windows over an [R, 40] plane: empty, lo = 0, hi = M, one
    narrower than k, the whole plane, and an ordinary one."""
    return [(5, 5), (0, 12), (31, 40), (17, 20), (0, 40), (8, 29)]


def test_k3b_window_plain_mode_equals_direct_formulas():
    rng = np.random.default_rng(3)
    m = 40
    windows = _window_rows()
    q = len(windows)
    scores = torch.from_numpy(np.round(rng.random((q, m)), 1).astype(np.float32))
    eligible = torch.from_numpy(rng.random((q, m)) < 0.7)
    key = torch.where(eligible, scores, float("-inf"))
    lo = torch.tensor([w[0] for w in windows], dtype=torch.int32)
    hi = torch.tensor([w[1] for w in windows], dtype=torch.int32)
    k = 10
    s, ids, tot = kernels.masked_topk_window(key, eligible, lo, hi, k)
    assert s.shape == ids.shape == (q, k)
    for r, (a, b) in enumerate(windows):
        assert int(tot[r]) == int(eligible[r, a:b].sum())
        # Direct: stable sort of the window by score descending.
        order = sorted(range(b - a), key=lambda j: (-float(key[r, a + j]), j))
        n = min(k, b - a)
        assert ids[r, :n].tolist() == order[:n]
        assert torch.equal(s[r, :n], key[r, a:b][order[:n]])
        assert torch.all(s[r, n:] == float("-inf")) and torch.all(ids[r, n:] == 0)
    bad = torch.tensor([3] * q, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.masked_topk_window(key, eligible, bad, bad - 1, k)
    assert kernels.LAUNCHES["masked_topk_window"] == 0  # plain runs


def test_k2b_bounds_plain_mode_equals_direct_formulas(tenants, planes):
    """K2b's bounds mode = K2's fold with eligibility also inside each
    row's [lo, hi): over the packed plane, rows whose worklists name their
    own tenant's tiles, and rows bounded to another tenant's range (no
    eligible head may survive), an empty range and the whole plane."""
    _jplane, pplane = planes
    tree = tbd.packed_segment_tree(pplane)
    pmap = Mappings(properties=PROPS)
    members = [0, 3, 3, 6, 1]
    cs = [Compiler(fields=pplane.member_fields(m), doc_values={}, mappings=pmap,
                   nt_floor=8).compile(parse_query({"match": {"body": "leak alpha"}}))
          for m in members]
    assert len({c.spec for c in cs}) == 1
    arrays = tbd.plan_to_torch(cs[0].spec, tbd.stack_plans([c.arrays for c in cs]), "cpu")
    n = pplane.num_docs
    bounds = [pplane.member_bounds(0), pplane.member_bounds(3),
              pplane.member_bounds(4), (7, 7), (0, n)]
    lo = torch.tensor([b[0] for b in bounds], dtype=torch.int32)
    hi = torch.tensor([b[1] for b in bounds], dtype=torch.int32)
    doc_tiles, tn = tree["fields"]["body"][0], tree["fields"]["body"][1]
    args = (doc_tiles, tn, arrays["tile_ids"], arrays["starts"], arrays["ends"],
            arrays["weights"], tree["live"], n, cs[0].spec[3])
    docs_b, sums_b, elig_b = kernels.sparse_fold_bounds(*args, lo, hi)
    docs, sums, elig = kernels.sparse_fold_batch(*args)
    assert torch.equal(docs_b, docs)
    assert torch.equal(sums_b.view(torch.int32), sums.view(torch.int32))
    direct = elig & (docs >= lo[:, None]) & (docs < hi[:, None])
    assert torch.equal(elig_b, direct)
    assert elig_b[0].sum() == elig[0].sum() > 0  # own tenant: unchanged
    assert elig_b[1].sum() == elig[1].sum() > 0
    assert not elig_b[2].any() and not elig_b[3].any()  # foreign, empty
    assert torch.equal(elig_b[4], elig[4])  # the whole plane
    assert kernels.LAUNCHES["sparse_fold_bounds"] == 0  # plain runs


def test_coalesce_wins_prices_total_cross_tenant_padding():
    """The merge rule sees the SUMMED padding of every tenant lane in a
    bucket: small waste across many tenants merges, a fat bill refuses."""
    per_lane = 20
    assert coalesce_wins(per_lane * 40)
    assert not coalesce_wins(per_lane * 40_000)


def _leaves(node, path=()):
    """(path, array) of every leaf of a plan's arrays pytree."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _leaves(node[key], path + (key,))
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(node)


SPANS = {"starts": "ends", "span_start": "span_end",
         "term_starts": "term_ends"}


def test_member_views_compile_the_solo_plan_shifted(tenants, planes, fuzz_lanes):
    """The unmodified Compiler over a member's views emits the member's own
    plan relocated by whole tiles: the same spec, weights and spans, tile
    ids + tile_base and positions + tile_base * 256 at every real entry
    (padding entries point at the plane's pad tile with empty spans)."""
    _jplane, pplane = planes
    pmap = Mappings(properties=PROPS)
    for m, body in fuzz_lanes[:60]:
        q = parse_query(body)
        packed = Compiler(fields=pplane.member_fields(m), doc_values={},
                          mappings=pmap).compile(q)
        solo = Compiler(fields=tenants[m][1].fields, doc_values={},
                        mappings=pmap).compile(q)
        assert packed.spec == solo.spec, body
        base = pplane.fields["body"].tile_base[m]
        got, want = dict(_leaves(packed.arrays)), dict(_leaves(solo.arrays))
        assert got.keys() == want.keys()
        for path, b in want.items():
            a, key = got[path], path[-1]
            if key == "tile_ids":
                real = b != tenants[m][1].fields["body"].pad_tile
                assert np.array_equal(a[real], b[real] + base), (body, path)
                assert np.all(a[~real] == pplane.fields["body"].views[m].pad_tile)
            elif key in SPANS or key in SPANS.values():
                lo_key = key if key in SPANS else next(
                    k for k, v in SPANS.items() if v == key)
                lo = want[path[:-1] + (lo_key,)]
                hi = want[path[:-1] + (SPANS[lo_key],)]
                real = hi > lo  # an absent term's span stays (0, 0)
                assert np.array_equal(a, np.where(real, b + base * 256, b)), (
                    body, path)
            else:
                assert np.array_equal(a, b), (body, path)
