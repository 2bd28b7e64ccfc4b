"""Aggregation execution over device segments: the query's dense
(scores, matched) planes, then every aggregation off the shared mask.

Port of elasticsearch_tpu/ops/aggs_device.py (kernel-table row 22),
trimmed to this slice: `agg_segment_tree` (:78), `_bucket_metric_planes`
(:91), `_terms_postings` (:117), `execute_aggs` (:360) and `_eval_agg`
(:124) with the kinds `matched`, `empty_buckets`, `top_metric_score`,
`terms`, `histogram`, `range`, `filter`, `filters`, `global` and
`missing`. Left out: `hits_planes` and the trailing "mask" flag (top_hits),
`cardinality_terms`, `sig_terms` / `sig_matched` (significant_terms), and
`_mesh_combine_node` / `mesh_combine` (the in-program psum across a shard
mesh, with kernel-table row 23); a plan node of another kind raises.

The query and each filter's sub-query evaluate densely through
ops/bm25_device's `_eval_node`, as the reference's do. Every per-bucket
count and metric plane and every doc_count (one bucket) runs on K10
(ops/kernels.bucket_fold, csrc/bucket_fold.cu): `terms` over a keyword
field's postings, `histogram` over docs, and `range` in K10's range
mode. K10 sums in one fixed chunked order; the reference's is XLA's, so
the bucket sums agree with it within rtol 1e-5 and all else exactly. The
elementwise tail is plain torch ops in the reference's operation order:
the histogram bucket index, the postings' matched gather, and the
`missing` and `global` masks.

Spec/arrays convention as the reference's: `spec` a hashable tuple tree,
`arrays` numpy leaves (uploaded here to the segment's device). Results
are nested dicts / tuples of tensors on the device; the host merges and
renders them (search/aggs.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import kernels
from .bm25_device import _dense_rows, _rows1, compute_filter_mask, plan_to_torch, segment_tree


def agg_segment_tree(device_segment) -> dict[str, Any]:
    """Segment tree for the aggregation program: query planes + ordinals."""
    tree = segment_tree(device_segment)
    tree["ordinals"] = {
        name: f.ord_terms
        for name, f in device_segment.fields.items()
        if f.ord_terms is not None
    }
    return tree


def _bucket_metric_planes(col, contrib, bucket, nb: int, docs=None):
    """Per-bucket (count, sum, min, max) of `col` (read at `docs` when
    given) over the rows `contrib` gates, `bucket` in [0, nb] (nb:
    discard): K10."""
    count, total, vmin, vmax = kernels.bucket_fold(
        bucket, contrib, nb, values=col, docs=docs
    )
    return {"count": count, "sum": total, "min": vmin, "max": vmax}


def _doc_count(mask):
    """sum(mask) as K10's one-bucket count."""
    return kernels.bucket_fold(None, mask, 1)[0]


def _terms_postings(seg, field_name):
    """Flat (docs [P], ords [P]) planes of a keyword field's postings."""
    doc_tiles = seg["fields"][field_name][0]
    ords = seg["ordinals"][field_name]
    return doc_tiles.reshape(-1), ords.reshape(-1)


def _scalar(x, dev):
    return torch.as_tensor(np.float32(x), device=dev)


def _nested(sub_specs, sub_arrays, seg, m, scores, num_docs):
    return {
        "doc_count": _doc_count(m),
        "subs": tuple(
            _eval_agg(s, a, seg, m, scores, num_docs)
            for s, a in zip(sub_specs, sub_arrays)
        ),
    }


def _eval_agg(spec, arrays, seg, matched, scores, num_docs: int):
    kind = spec[0]
    dev = matched.device
    if kind == "empty_buckets":
        # A histogram/range over a column absent from this segment: zero
        # counts shaped like the segments that carry the column.
        return {"counts": torch.zeros(spec[1], dtype=torch.int32, device=dev)}
    if kind == "matched":
        # The f64-exact host metrics finish from the matched mask.
        return {"mask": matched}
    if kind == "top_metric_score":
        # max(where(matched, scores, -F32_MAX)): K10's max of the non-NaN
        # scores; a matched NaN score propagates as XLA's max does.
        _c, _s, _lo, mx = kernels.bucket_fold(None, matched, 1, values=scores)
        nan = matched & torch.isnan(scores)
        first_nan = scores[nan.to(torch.int8).argmax()]
        mx = torch.where(nan.any(), first_nan, mx[0])
        return {"max_score": mx, "any": _doc_count(matched) > 0}
    if kind == "terms":
        field_name, tp, sub_fields = spec[1], spec[2], spec[3]
        docs, ords = _terms_postings(seg, field_name)
        # matched at each posting's doc; the sentinel doc num_docs reads
        # False (the reference's m_ext[min(docs, num_docs)])
        m_ext = torch.cat([matched, matched.new_zeros(1)])
        m = m_ext[torch.clamp(docs, max=num_docs).long()]
        out = {"counts": kernels.bucket_fold(ords, m, tp)}
        if sub_fields:
            safe_docs = torch.clamp(docs, max=num_docs - 1)
            out["subs"] = {
                f: _bucket_metric_planes(
                    seg["doc_values"][f], m, ords, tp, docs=safe_docs
                )
                for f in sub_fields
            }
        return out
    if kind == "histogram":
        field_name, nb, sub_fields = spec[1], spec[2], spec[3]
        col = seg["doc_values"][field_name]
        has = matched & ~torch.isnan(col)
        rel = torch.floor(
            (col - _scalar(arrays["offset"], dev))
            / _scalar(arrays["interval"], dev)
        ) - _scalar(arrays["base"], dev)
        # jnp's clip-then-astype maps a NaN to 0; `has` excludes those docs
        rel = torch.clamp(torch.nan_to_num(rel, nan=0.0), -1, nb)
        rel = rel.to(torch.int32)
        in_window = has & (rel >= 0) & (rel < nb)
        bidx = torch.where(in_window, rel, torch.full_like(rel, nb))
        out = {"counts": kernels.bucket_fold(bidx, in_window, nb)}
        if sub_fields:
            out["subs"] = {
                f: _bucket_metric_planes(
                    seg["doc_values"][f], in_window, bidx, nb
                )
                for f in sub_fields
            }
        return out
    if kind == "range":
        field_name, sub_fields = spec[1], spec[3]
        col = seg["doc_values"][field_name]
        los = torch.as_tensor(np.asarray(arrays["los"], np.float32), device=dev)
        his = torch.as_tensor(np.asarray(arrays["his"], np.float32), device=dev)
        out = {"counts": kernels.range_fold(col, matched, los, his)}
        if sub_fields:
            subs = {}
            for f in sub_fields:
                _c, count, total, vmin, vmax = kernels.range_fold(
                    col, matched, los, his, sub=seg["doc_values"][f]
                )
                subs[f] = {"count": count, "sum": total, "min": vmin,
                           "max": vmax}
            out["subs"] = subs
        return out
    if kind == "filter":
        _, query_spec, sub_specs = spec
        m = matched & _filter_mask(query_spec, arrays["query"], seg)
        return _nested(sub_specs, arrays["subs"], seg, m, scores, num_docs)
    if kind == "filters":
        _, query_specs, sub_specs = spec
        return tuple(
            _nested(sub_specs, arrays["subs"], seg,
                    matched & _filter_mask(q_spec, q_arrays, seg), scores,
                    num_docs)
            for q_spec, q_arrays in zip(query_specs, arrays["queries"])
        )
    if kind == "global":
        return _nested(spec[1], arrays["subs"], seg, seg["live"],
                       scores, num_docs)
    if kind == "missing":
        _, field_name, field_kind, sub_specs = spec
        if field_kind == "inverted":
            present = seg["fields"][field_name][4]
        elif field_kind == "numeric":
            present = ~torch.isnan(seg["doc_values"][field_name])
        else:  # unmapped / absent from this segment: everything is missing
            present = torch.zeros_like(matched)
        return _nested(sub_specs, arrays["subs"], seg,
                       matched & ~present, scores, num_docs)
    raise ValueError(f"unknown aggregation plan node [{kind}]")


def _filter_mask(query_spec, query_arrays, seg):
    """A filter's matched plane bool[N] by the dense evaluation."""
    plan = plan_to_torch(query_spec, query_arrays, seg["live"].device)
    return compute_filter_mask(seg, query_spec, plan)


def execute_aggs(seg, query_spec, query_arrays, aggs_spec, aggs_arrays):
    """Evaluate the query once, then every aggregation off its mask.

    `seg` is agg_segment_tree's tree, `query_arrays` the compiled query's
    arrays (numpy leaves). Returns (total_hits i32[], a tuple of result
    trees), all on the segment's device."""
    live = seg["live"]
    num_docs = live.shape[0]
    plan = plan_to_torch(query_spec, query_arrays, live.device)
    scores, eligible = _dense_rows(seg, query_spec, _rows1(plan), 1)
    scores, eligible = scores[0], eligible[0]
    results = tuple(
        _eval_agg(s, a, seg, eligible, scores, num_docs)
        for s, a in zip(aggs_spec, aggs_arrays)
    )
    return _doc_count(eligible), results
