"""Port aggregation device programs of the later slice (kernel-table row
22's rest) against the JAX package's `execute_aggs`.

The same numpy-seeded documents go to an engine of each package (two
segments, with deletes); the reference's Aggregator compiles each case's
aggregation specs, and both packages' `execute_aggs` run them over their
own packed segments with the reference's compiled query:

- `hits_planes` (a top-level top_hits: the context mask and the query's
  scores), the trailing "mask" flag of `terms`, `histogram`, `range` and
  `empty_buckets` (a top_hits sub-aggregation), `sig_terms` (with sub
  metrics and a top_hits sub) and `sig_matched` (a field absent from the
  first segment), and the terms counts of `rare_terms` and keyword
  `cardinality`;
- `cardinality_terms`, which no body compiles to (the reference's
  Aggregator never emits it), from a hand-built spec;
- `date_histogram` over a `date` column: fixed intervals as the
  histogram plan, month / quarter / year as the range plan over the
  calendar edges, where documents planted within 60 s of every month
  edge meet the f32 column (2^17 ms apart near 1.7e12): both packages
  bucket them by the f32 stored value;
- a `boolean` column as a histogram and a range.

Tolerances (those of tests/test_torch_aggs.py): everything EXACT (masks,
score bits, counts, doc counts, distinct counts, min / max bits), except
each bucket sub-metric sum within rtol 1e-5 (K10's chunked order against
XLA's).
"""

from datetime import datetime, timezone

import jax
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

torch.set_num_threads(1)

RTOL = 1e-5

PROPS = {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "color": {"type": "keyword"},  # only the second segment has values
    "price": {"type": "long"},
    "w": {"type": "float"},
    "ts": {"type": "date"},
    "flag": {"type": "boolean"},
}

# 2023-01-01 .. 2025-12-31 UTC in epoch milliseconds
T0 = datetime(2023, 1, 1, tzinfo=timezone.utc).timestamp() * 1000.0
T1 = datetime(2025, 12, 31, tzinfo=timezone.utc).timestamp() * 1000.0


def month_edges():
    return [datetime(y, m, 1, tzinfo=timezone.utc).timestamp() * 1000.0
            for y in (2023, 2024, 2025) for m in range(1, 13)]


def _docs(seed, n, offset):
    rng = np.random.default_rng(seed)
    edges = month_edges()
    out = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(["x", "y", "z", "w"], 3)),
             "tag": f"t{int(rng.zipf(1.4)) % 25}",
             "w": float(np.float32(rng.random() * 10 ** rng.integers(0, 4))),
             "flag": bool(rng.random() < 0.3)}
        if (i + offset) % 7:
            d["price"] = int(rng.integers(0, 5000))
        if i % 5 == 0:  # within 60 s of a month edge
            edge = edges[int(rng.integers(0, len(edges)))]
            d["ts"] = int(edge + rng.integers(-60_000, 60_001))
        elif i % 11:
            d["ts"] = int(rng.integers(int(T0), int(T1)))
        if i % 13 == 0:
            d["ts"] = datetime.fromtimestamp(
                d.get("ts", T0) / 1000.0, tz=timezone.utc).isoformat()
        if offset:
            d["color"] = str(rng.choice(["red", "blue", "green"]))
        out.append(d)
    return out


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxMappings(properties=PROPS))
    peng = Engine(Mappings(properties=PROPS), device="cpu")
    for seg_i, (seed, n) in enumerate(((21, 400), (22, 300))):
        for i, d in enumerate(_docs(seed, n, seg_i)):
            for eng in (jeng, peng):
                eng.index(d, f"s{seg_i}d{i}")
        for eng in (jeng, peng):
            eng.refresh()
    for i in range(0, 400, 9):
        for eng in (jeng, peng):
            eng.delete(f"s0d{i}")
    for eng in (jeng, peng):
        eng.refresh()
    assert len(jeng.segments) == len(peng.segments) == 2
    for jh, ph in zip(jeng.segments, peng.segments):
        for f in ("ts", "flag"):
            np.testing.assert_array_equal(ph.segment.doc_values[f],
                                          jh.segment.doc_values[f])
    return jeng, peng


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.float32:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    else:
        assert np.array_equal(got, want), (got[:8], want[:8])


def _close(got, want) -> float:
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if not got.size:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def _compare(got, want, path="") -> float:
    """Result trees equal; each bucket sub-metric sum within rtol 1e-5.
    Returns the largest relative difference of those sums."""
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

TOP = {"th": {"top_hits": {"size": 2}}}
SUBS = {"s": {"sum": {"field": "w"}}, "m": {"min": {"field": "price"}}}

AGG_CASES = {
    "hits_planes": {"th": {"top_hits": {"size": 3}}},
    "terms_mask": {"t": {"terms": {"field": "tag"}, "aggs": {**TOP, **SUBS}}},
    "histogram_mask": {"h": {"histogram": {"field": "price", "interval": 500},
                             "aggs": {**TOP, **SUBS}}},
    "range_mask": {"r": {"range": {"field": "w", "ranges": [
        {"to": 10}, {"from": 5, "to": 500}]}, "aggs": {**TOP, **SUBS}}},
    "empty_buckets_mask": {"r": {"range": {"field": "nope", "ranges": [
        {"to": 1}]}, "aggs": TOP}},
    "filter_terms_mask": {"f": {"filter": {"term": {"tag": "t1"}}, "aggs": {
        "t": {"terms": {"field": "tag"}, "aggs": TOP}}}},
    "sig_terms": {"s": {"significant_terms": {"field": "tag"},
                        "aggs": {**TOP, **SUBS}}},
    "sig_terms_absent_field": {"s": {"significant_terms": {
        "field": "color"}}},
    "sig_terms_in_filters": {"f": {"filters": {"filters": {
        "a": {"match": {"body": "z"}}, "b": {"term": {"flag": True}}}},
        "aggs": {"s": {"significant_terms": {"field": "color"}}}}},
    "rare_terms": {"r": {"rare_terms": {"field": "tag"}}},
    "cardinality_keyword": {"c": {"cardinality": {"field": "tag"}},
                            "d": {"cardinality": {"field": "color"}}},
    "host_kinds": {"c": {"cardinality": {"field": "ts"}},
                   "p": {"percentiles": {"field": "w"}},
                   "m": {"matrix_stats": {"fields": ["w", "ts"]}},
                   "n": {"terms": {"field": "flag"}},
                   "k": {"composite": {"sources": [
                       {"t": {"terms": {"field": "tag"}}}]}}},
    "date_fixed_1d": {"d": {"date_histogram": {"field": "ts",
                                               "fixed_interval": "1d"}}},
    "date_fixed_12h": {"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "12h"}, "aggs": SUBS}},
    "date_month": {"d": {"date_histogram": {
        "field": "ts", "calendar_interval": "month"},
        "aggs": {**TOP, **SUBS}}},
    "date_quarter": {"d": {"date_histogram": {
        "field": "ts", "calendar_interval": "quarter"}}},
    "date_year": {"d": {"date_histogram": {"field": "ts",
                                           "calendar_interval": "1y"}}},
    "boolean_columns": {"h": {"histogram": {"field": "flag", "interval": 1}},
                        "r": {"range": {"field": "flag", "ranges": [
                            {"from": 0.5}]}}},
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


def _kinds(spec):
    """Every plan-node kind in a spec tree."""
    if isinstance(spec, tuple) and spec and isinstance(spec[0], str):
        out = {spec[0]}
        for part in spec[1:]:
            out |= _kinds(part)
        return out
    if isinstance(spec, tuple):
        return set().union(*(_kinds(s) for s in spec)) if spec else set()
    return set()


@pytest.mark.parametrize("case", sorted(AGG_CASES))
@pytest.mark.parametrize("seg_i", [0, 1])
def test_execute_aggs_matches_reference(engines, case, seg_i):
    jeng, _ = engines
    jh = jeng.segments[seg_i]
    agg = JaxAggregator(jeng, jparse_aggs(AGG_CASES[case]))
    specs, arrays = agg.compile_for(jh, jeng.compiler_for(jh))
    assert _run_both(engines, seg_i, specs, arrays) < RTOL


def test_cases_reach_every_new_plan_node(engines):
    """The cases above compile to each kind this slice added, and to the
    "mask" flag of every bucket kind that carries it."""
    jeng, _ = engines
    kinds, masked = set(), set()
    for seg_i in (0, 1):
        jh = jeng.segments[seg_i]
        for body in AGG_CASES.values():
            agg = JaxAggregator(jeng, jparse_aggs(body))
            specs, _ = agg.compile_for(jh, jeng.compiler_for(jh))
            kinds |= _kinds(specs)
            masked |= {s[0] for s in specs
                       if isinstance(s, tuple) and s and s[-1] == "mask"}
            for s in specs:
                if s and s[0] in ("filter", "filters"):
                    masked |= {t[0] for t in s[-1] if t and t[-1] == "mask"}
    assert {"hits_planes", "sig_terms", "sig_matched", "terms", "range",
            "histogram", "empty_buckets"} <= kinds
    assert {"terms", "histogram", "range", "empty_buckets",
            "sig_terms"} <= masked


@pytest.mark.parametrize("field,tp", [("tag", 32), ("color", 4),
                                      ("tag", 64)])
@pytest.mark.parametrize("query", [QUERY, {"match_all": {}},
                                   {"term": {"tag": "no-such-tag"}}])
def test_cardinality_terms_hand_built_spec(engines, field, tp, query):
    """`cardinality_terms` (no body compiles to it) from a hand-built spec,
    beside the counts it reduces, on both segments."""
    jeng, _ = engines
    for seg_i in (0, 1):
        fld = jeng.segments[seg_i].device.fields.get(field)
        if fld is None:
            continue
        specs = (("cardinality_terms", field, tp),
                 ("terms", field, tp, ()))
        assert _run_both(engines, seg_i, specs, ({}, {}), query=query) == 0.0


def test_month_edge_documents_bucket_by_the_f32_column(engines):
    """Some planted documents within 60 s of a month edge land in the
    other month on the device (the f32 column), and both packages count
    them there."""
    jeng, peng = engines
    edges = np.asarray(month_edges())
    moved = 0
    for h in peng.segments:
        col = h.segment.doc_values["ts"]
        ok = ~np.isnan(col)
        f64 = np.searchsorted(edges, col[ok], side="right")
        f32 = np.searchsorted(edges.astype(np.float32),
                              col[ok].astype(np.float32), side="right")
        moved += int((f64 != f32).sum())
    assert moved > 0
    body = {"d": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "month"}}}
    for seg_i in (0, 1):
        jh = jeng.segments[seg_i]
        agg = JaxAggregator(jeng, jparse_aggs(body))
        specs, arrays = agg.compile_for(jh, jeng.compiler_for(jh))
        assert specs[0][0] == "range" and specs[0][2] > 32
        assert _run_both(engines, seg_i, specs, arrays,
                         query={"match_all": {}}) == 0.0
