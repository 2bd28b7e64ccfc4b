"""Port aggregation device programs (kernel-table row 22) against the JAX
package.

- K10 bucket_fold's plain version (ops/kernels.bucket_fold and
  range_fold on CPU tensors) against the reference's
  `_bucket_metric_planes` and `range` reductions (jnp under jit,
  XLA:CPU): counts, min and max EXACT (signed zeros, NaN as "no value",
  rows that do not contribute, discarded buckets, a gather through a
  docs plane, no rows at all); sums within rtol 1e-5, the bound the
  reference holds its own device sums to (tests/test_aggs.py:254), since
  XLA sums in its own order;
- the same sums bit for bit against K10's stated order, emulated one
  float32 add at a time in numpy (chunks of bucket_chunk_rows rows, each
  a left fold in row order, then the chunk partials in chunk order), on
  adversarial values (1e7 outliers among unit values) and past one chunk;
- the keyword ordinal plane `ord_terms` of the port's pack_segment
  against the reference's (an empty vocabulary included). EXACT;
- `execute_aggs` of both packages over the same numpy-seeded documents
  (two segments, with deletes), each package's engine packing its own
  segments, with the reference's compiled query and aggregation specs:
  every kept kind of `_eval_agg` (matched, terms with and without
  sub-metrics, histogram, range, empty_buckets, filter, filters, global,
  missing over numeric / inverted / absent fields, top_metric_score), a
  column no doc of a segment has, the postings' padding sentinels and
  match_none. EXACT, except every bucket sub-metric sum within rtol 1e-5;
  the largest relative difference measured here is 1.87e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.index.mapping import Mappings as JaxMappings
from elasticsearch_tpu.ops import aggs_device as jagg
from elasticsearch_tpu.query.dsl import parse_query as jparse_query
from elasticsearch_tpu.search.aggs import Aggregator as JaxAggregator
from elasticsearch_tpu.search.aggs import parse_aggs as jparse_aggs
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.ops import aggs_device as tagg
from elasticsearch_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

F32_MAX = np.float32(np.finfo(np.float32).max)
RTOL = 1e-5


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.float32:
        assert np.array_equal(_bits(got), _bits(want)), (got[:8], want[:8])
    else:
        assert np.array_equal(got, want), (got[:8], want[:8])


def _close(got, want) -> float:
    """Within rtol 1e-5; returns the largest relative difference."""
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if not got.size:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def _k10_order_sums(group, vals, nb, ch):
    """K10's sums one float32 add at a time: per chunk of `ch` rows a left
    fold in row order, then the chunk partials in chunk order."""
    total = np.zeros(nb, np.float32)
    for c0 in range(0, len(group), ch):
        part = np.zeros(nb, np.float32)
        for b, v in zip(group[c0:c0 + ch], vals[c0:c0 + ch]):
            if b < nb:
                part[b] = np.float32(part[b] + v)
        total = (total + part).astype(np.float32)
    return total


# ---------------------------------------------------------------------------
# K10 plain against the reference's scatters and against its own order
# ---------------------------------------------------------------------------

_jit_planes = jax.jit(jagg._bucket_metric_planes, static_argnums=3)


def _data(seed, p, n, nb, outliers=False):
    rng = np.random.default_rng(seed)
    vals = (rng.random(n) * 100).astype(np.float32)
    if outliers:
        vals = rng.standard_normal(n).astype(np.float32)
        vals[rng.random(n) < 0.02] *= np.float32(1e7)
    vals[rng.random(n) < 0.05] = np.nan
    vals[rng.random(n) < 0.05] = -0.0
    vals[rng.random(n) < 0.05] = 0.0
    bucket = rng.integers(0, nb + 1, p).astype(np.int32)
    contrib = rng.random(p) < 0.85
    docs = rng.integers(0, n, p).astype(np.int32)
    return vals, bucket, contrib, docs


def _fold(bucket, contrib, nb, vals, docs):
    t = torch.from_numpy
    return K.bucket_fold(t(bucket), t(contrib), nb, values=t(vals),
                         docs=None if docs is None else t(docs))


@pytest.mark.parametrize("seed,p,n,nb,gather", [
    (0, 5000, 5000, 7, False),  # long buckets over several chunks
    (1, 20000, 3000, 300, True),  # a gather, as terms subs read columns
    (2, 3000, 3000, 1, False),  # one bucket
    (3, 4096, 700, 4096, True),  # more buckets than rows
    (4, 0, 10, 4, False),  # no rows at all
])
def test_bucket_fold_plain_matches_the_reference_scatter(seed, p, n, nb, gather):
    vals, bucket, contrib, docs = _data(seed, p, n, nb)
    col = vals[docs] if gather else vals[:p]
    want = _jit_planes(jnp.asarray(col), jnp.asarray(contrib),
                       jnp.asarray(bucket), nb)
    got = _fold(bucket, contrib, nb, vals if gather else vals[:p].copy(),
                docs if gather else None)
    for name, g in zip(("count", "min", "max"), (got[0], got[2], got[3])):
        _same(g, want[name])
    assert _close(got[1], want["sum"]) < RTOL
    # count-only mode: the count scatter of terms / histogram
    ref_counts = jnp.zeros(nb + 1, jnp.int32).at[
        jnp.where(jnp.asarray(contrib), jnp.asarray(bucket), nb)
    ].add(jnp.asarray(contrib).astype(jnp.int32))[:nb]
    _same(K.bucket_fold(torch.from_numpy(bucket), torch.from_numpy(contrib),
                        nb), ref_counts)


@pytest.mark.parametrize("seed,p,nb", [(5, 3000, 5), (6, 70000, 40),
                                       (7, 2100, 1)])
def test_bucket_fold_sums_follow_the_stated_order(seed, p, nb):
    """Bit for bit against the numpy emulation of K10's order, on values
    where the order shows (1e7 outliers among unit values)."""
    vals, bucket, contrib, _ = _data(seed, p, p, nb, outliers=True)
    got = _fold(bucket, contrib, nb, vals, None)
    keep = contrib & ~np.isnan(vals) & (bucket < nb)
    group = np.where(keep, bucket, nb)
    want = _k10_order_sums(group, np.where(keep, vals, 0), nb,
                           K.bucket_chunk_rows(p, nb))
    _same(got[1], want)


def test_bucket_chunk_rows_bounds_the_partials():
    assert K.bucket_chunk_rows(5000, 7) == 1024
    assert K.bucket_chunk_rows(8_841_823, 32) == 1024
    ch = K.bucket_chunk_rows(300_000, 20_000)
    assert ch == 2048 and -(-300_000 // ch) * 20_000 <= K.BUCKET_MAX_PARTIALS
    # more buckets than partials allow: one chunk covers the rows
    assert K.bucket_chunk_rows(1000, 1 << 23) == 1024
    assert K.bucket_chunk_rows(5000, 1 << 23) == 8192


def test_doc_count_is_one_bucket():
    rng = np.random.default_rng(9)
    mask = rng.random(5000) < 0.3
    got = K.bucket_fold(None, torch.from_numpy(mask), 1)
    _same(got, np.array([mask.sum()], np.int32))


def test_bucket_fold_signed_zeros_as_the_reference():
    """+0.0 + -0.0 sums to +0.0; min picks -0.0 and max +0.0 whatever the
    order; an empty bucket has sum 0.0, min F32_MAX, max -F32_MAX."""
    vals = np.array([-0.0, 0.0, -0.0, 1e7, 1.0, 1.0, -1e7, 0.5, np.nan, 3.0],
                    dtype=np.float32)
    bucket = np.array([0, 0, 1, 2, 2, 2, 2, 2, 3, 3], dtype=np.int32)
    contrib = np.ones(10, dtype=bool)
    want = _jit_planes(jnp.asarray(vals), jnp.asarray(contrib),
                       jnp.asarray(bucket), 5)
    got = _fold(bucket, contrib, 5, vals, None)
    for name, g in zip(("count", "sum", "min", "max"), got):
        _same(g, want[name])
    assert np.signbit(got[2][1].item()) and not np.signbit(got[3][0].item())


@jax.jit
def _ref_range(col, sub, matched, los, his):
    has = matched & ~jnp.isnan(col)
    in_r = (has[None, :] & (col[None, :] >= los[:, None])
            & (col[None, :] < his[:, None]))
    sub_has = in_r & ~jnp.isnan(sub)[None, :]
    v = jnp.where(sub_has, sub[None, :], jnp.float32(0.0))
    return (jnp.sum(in_r, axis=1, dtype=jnp.int32),
            jnp.sum(sub_has, axis=1, dtype=jnp.int32),
            jnp.sum(v, axis=1, dtype=jnp.float32),
            jnp.min(jnp.where(sub_has, sub[None, :], F32_MAX), axis=1),
            jnp.max(jnp.where(sub_has, sub[None, :], -F32_MAX), axis=1))


@pytest.mark.parametrize("n", [5000, 1])
def test_range_mode_matches_the_reference(n):
    """Overlapping, empty and unbounded ranges, NaN and -0.0 sub values:
    counts and min / max EXACT against the reference's [R, N] reductions,
    sums within rtol 1e-5 and bit for bit in K10's order."""
    rng = np.random.default_rng(7)
    col = (rng.random(n) * 100).astype(np.float32)
    col[rng.random(n) < 0.1] = np.nan
    sub = (rng.random(n) * 50).astype(np.float32)
    sub[rng.random(n) < 0.1] = np.nan
    sub[rng.random(n) < 0.02] = -0.0
    matched = rng.random(n) < 0.8
    los = np.array([-np.inf, 10, 40, 40, 99], dtype=np.float32)
    his = np.array([20, 60, 41, np.inf, 99], dtype=np.float32)
    want = _ref_range(col, sub, matched, los, his)
    t = torch.from_numpy
    seg = {"doc_values": {"col": t(col), "sub": t(sub)}}
    arrays = {"los": los, "his": his}
    got = tagg._eval_agg(("range", "col", len(los), ("sub",)), arrays, seg,
                         t(matched), None, n)
    planes = got["subs"]["sub"]
    _same(got["counts"], want[0])
    _same(planes["count"], want[1])
    _same(planes["min"], want[3])
    _same(planes["max"], want[4])
    assert _close(planes["sum"], want[2]) < RTOL
    has = matched & ~np.isnan(col)
    ch = K.bucket_chunk_rows(n, len(los))
    for r in range(len(los)):
        members = has & (col >= los[r]) & (col < his[r]) & ~np.isnan(sub)
        emu = _k10_order_sums(np.where(members, 0, 1), np.where(members, sub, 0),
                              1, ch)
        _same(planes["sum"][r:r + 1], emu)
    counts_only = tagg._eval_agg(("range", "col", len(los), ()), arrays, seg,
                                 t(matched), None, n)
    _same(counts_only["counts"], want[0])


# ---------------------------------------------------------------------------
# Segments of both packages from the same documents
# ---------------------------------------------------------------------------

PROPS = {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "color": {"type": "keyword"},
    "long_tag": {"type": "keyword", "ignore_above": 2},  # empty vocabulary
    "price": {"type": "long"},
    "w": {"type": "float"},
    "late": {"type": "double"},  # only the second segment has values
    "absent": {"type": "double"},  # no doc has a value
}


def _docs(seed, n, offset):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(["x", "y", "z", "w"], 3)),
             "tag": f"t{int(rng.zipf(1.4)) % 25}",
             "long_tag": "abcdef",
             "w": float(np.float32(rng.random() * 10 ** rng.integers(0, 4)))}
        if (i + offset) % 7:
            d["price"] = int(rng.integers(0, 5000))
        if (i + offset) % 3 == 0:
            d["w"] = -0.0 if i % 2 else 0.0
        if offset:  # the second segment has a color and a column the first lacks
            d["color"] = str(rng.choice(["red", "blue"]))
            d["late"] = float(rng.random())
        out.append(d)
    return out


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxMappings(properties=PROPS))
    peng = Engine(Mappings(properties=PROPS), device="cpu")
    for seg_i, (seed, n) in enumerate(((11, 300), (12, 200))):
        for i, d in enumerate(_docs(seed, n, seg_i)):
            for eng in (jeng, peng):
                eng.index(d, f"s{seg_i}d{i}")
        for eng in (jeng, peng):
            eng.refresh()
    for i in range(0, 300, 11):
        for eng in (jeng, peng):
            eng.delete(f"s0d{i}")
    for eng in (jeng, peng):
        eng.refresh()
    assert len(jeng.segments) == len(peng.segments) == 2
    return jeng, peng


@pytest.mark.parametrize("field", ["tag", "color", "long_tag"])
def test_ordinal_plane_matches_reference(engines, field):
    jeng, peng = engines
    for jh, ph in zip(jeng.segments, peng.segments):
        jf, pf = jh.device.fields.get(field), ph.device.fields.get(field)
        assert (jf is None) == (pf is None)
        if jf is not None:
            _same(pf.ord_terms, np.asarray(jf.ord_terms))
    assert len(peng.segments[0].device.fields["long_tag"].terms) == 0


def _compare(got, want, path="") -> float:
    """Result trees equal; every bucket sub-metric sum (a "sum" under
    "subs") within rtol 1e-5. Returns the largest relative difference of
    those sums."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return max([0.0] + [_compare(got[key], want[key], f"{path}/{key}")
                            for key in want])
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        return max([0.0] + [_compare(g, w, f"{path}/{i}")
                            for i, (g, w) in enumerate(zip(got, want))])
    if "/subs/" in path and path.endswith("/sum"):
        return _close(got, want)
    _same(got, want)
    return 0.0


QUERY = {"bool": {"should": [{"match": {"body": "x y"}}],
                  "filter": [{"range": {"price": {"gte": 100}}}]}}

# One case per kept kind; each compiles with the reference's Aggregator.
AGG_CASES = {
    "matched": {"s": {"stats": {"field": "w"}}},
    "terms": {"t": {"terms": {"field": "tag"}}},
    "terms_subs": {"t": {"terms": {"field": "tag"}, "aggs": {
        "s": {"sum": {"field": "w"}}, "m": {"min": {"field": "price"}},
        "x": {"max": {"field": "w"}}}}},
    "terms_absent_field": {"t": {"terms": {"field": "color"}, "aggs": {
        "a": {"avg": {"field": "late"}}}}},
    "terms_empty_vocabulary": {"t": {"terms": {"field": "long_tag"}}},
    "histogram": {"h": {"histogram": {"field": "price", "interval": 250},
                        "aggs": {"a": {"avg": {"field": "w"}},
                                 "x": {"max": {"field": "w"}},
                                 "c": {"value_count": {"field": "late"}}}}},
    "histogram_offset": {"h": {"histogram": {"field": "w", "interval": 7.5,
                                             "offset": 2}}},
    "range": {"r": {"range": {"field": "price", "ranges": [
        {"to": 1000}, {"from": 500, "to": 2500}, {"from": 2500}]},
        "aggs": {"s": {"sum": {"field": "w"}}, "m": {"min": {"field": "w"}},
                 "x": {"stats": {"field": "late"}}}}},
    "empty_buckets": {"h": {"histogram": {"field": "late", "interval": 0.25}},
                      "r": {"range": {"field": "late",
                                      "ranges": [{"to": 0.5}]}}},
    "filter": {"f": {"filter": {"term": {"tag": "t1"}}, "aggs": {
        "h": {"histogram": {"field": "price", "interval": 1000}},
        "s": {"sum": {"field": "w"}}}}},
    "filters": {"f": {"filters": {"filters": {
        "a": {"match": {"body": "z"}},
        "b": {"range": {"w": {"gte": 1}}}}},
        "aggs": {"t": {"terms": {"field": "tag"}},
                 "r": {"range": {"field": "w", "ranges": [{"to": 5}]},
                       "aggs": {"s": {"sum": {"field": "price"}}}}}}},
    "global": {"g": {"global": {}, "aggs": {
        "t": {"terms": {"field": "tag", "size": 3},
              "aggs": {"s": {"sum": {"field": "price"}}}}}}},
    "missing_numeric": {"m": {"missing": {"field": "price"}, "aggs": {
        "t": {"terms": {"field": "tag", "size": 3}}}}},
    "missing_inverted": {"m": {"missing": {"field": "color"}}},
    "missing_none": {"m": {"missing": {"field": "nope"}}},
    "missing_all_missing_column": {"m": {"missing": {"field": "absent"}}},
}


def _run_both(engines, seg_i, specs, arrays, query=QUERY) -> float:
    jeng, peng = engines
    jh, ph = jeng.segments[seg_i], peng.segments[seg_i]
    compiled = jeng.compiler_for(jh).compile(jparse_query(query))
    j_total, j_res = jagg.execute_aggs(
        jagg.agg_segment_tree(jh.device), compiled.spec, compiled.arrays,
        specs, arrays)
    p_total, p_res = tagg.execute_aggs(
        tagg.agg_segment_tree(ph.device), compiled.spec, compiled.arrays,
        specs, arrays)
    assert int(p_total) == int(j_total)
    return _compare(p_res, jax.device_get(j_res))


@pytest.mark.parametrize("case", sorted(AGG_CASES))
@pytest.mark.parametrize("seg_i", [0, 1])
def test_execute_aggs_matches_reference(engines, case, seg_i):
    jeng, _ = engines
    jh = jeng.segments[seg_i]
    agg = JaxAggregator(jeng, jparse_aggs(AGG_CASES[case]))
    specs, arrays = agg.compile_for(jh, jeng.compiler_for(jh))
    assert _run_both(engines, seg_i, specs, arrays) < RTOL


@pytest.mark.parametrize("query", [{"match_all": {}},
                                   {"term": {"tag": "no-such-tag"}},
                                   {"match": {"body": "w"}}])
def test_execute_aggs_top_metric_score_and_match_none(engines, query):
    specs = (("terms", "tag", 32, ("w",)), ("histogram", "price", 16, ("w",)),
             ("top_metric_score",))
    arrays = ({}, {"interval": np.float32(400.0), "offset": np.float32(0.0),
                   "base": np.float32(0.0)}, {})
    for seg_i in (0, 1):
        assert _run_both(engines, seg_i, specs, arrays, query=query) < RTOL


def test_unknown_plan_node_raises(engines):
    _, peng = engines
    tree = tagg.agg_segment_tree(peng.segments[0].device)
    mask = torch.ones(tree["live"].shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown aggregation plan node"):
        tagg._eval_agg(("mesh_combine", "tag", 32), {}, tree, mask, None,
                       mask.shape[0])
