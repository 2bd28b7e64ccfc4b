"""Aggregation execution over device segments: the query's dense
(scores, matched) planes, then every aggregation off the shared mask.

Port of elasticsearch_tpu/ops/aggs_device.py (kernel-table row 22):
`agg_segment_tree` (:78), `_bucket_metric_planes` (:91), `_terms_postings`
(:117), `execute_aggs` (:360) and `_eval_agg` (:124) with every kind the
reference's has: `matched`, `hits_planes` (the context mask and the
query's scores, for top_hits), `top_metric_score`, `cardinality_terms`,
`sig_matched`, `terms` / `sig_terms` (significant_terms' foreground
counts and context doc count), `histogram`, `range`, `empty_buckets`,
`filter`, `filters`, `global` and `missing`, with the trailing "mask"
flag of `terms`, `sig_terms`, `histogram`, `range` and `empty_buckets`
(the node's context mask back for a top_hits sub-aggregation); and the
mesh half (row 22's, with row 23): `_mesh_combine_node` (:309) and
`mesh_combine` (:351), which join the shards' results of one mesh
request over parallel/mesh.py: integer count planes (histogram / range
bucket counts, the filter family's doc_counts) psum on the lead device
and come back replicated on a leading shard axis, as the reference's
out-specs give them; every other plane (masks for the host's float64
metric finish, keyword ordinal counts) comes back stacked [S, ...]. No
float plane is summed. A plan node of another kind raises.

The query and each filter's sub-query evaluate densely through
ops/bm25_device's `_eval_node`, as the reference's do. Every per-bucket
count and metric plane and every doc_count (one bucket) runs on K10
(ops/kernels.bucket_fold, csrc/bucket_fold.cu): `terms`, `sig_terms`
and `cardinality_terms` over a keyword field's postings, `histogram`
over docs, and `range` in K10's range mode. K10 sums in one fixed
chunked order; the reference's is XLA's, so the bucket sums agree with
it within rtol 1e-5 and all else exactly. The
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

from ..parallel import mesh
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


def _posting_matched(seg, field_name, matched, num_docs: int):
    """(docs, ords, matched at each posting's doc): the sentinel doc
    num_docs reads False (the reference's m_ext[min(docs, num_docs)])."""
    docs, ords = _terms_postings(seg, field_name)
    m_ext = torch.cat([matched, matched.new_zeros(1)])
    return docs, ords, m_ext[torch.clamp(docs, max=num_docs).long()]


def _eval_agg(spec, arrays, seg, matched, scores, num_docs: int):
    kind = spec[0]
    dev = matched.device
    if kind == "empty_buckets":
        # A histogram/range over a column absent from this segment: zero
        # counts shaped like the segments that carry the column; the
        # "mask" flag still reports the context mask (top_hits subs).
        out = {"counts": torch.zeros(spec[1], dtype=torch.int32, device=dev)}
        if len(spec) > 2:
            out["ctx_mask"] = matched
        return out
    if kind == "matched":
        # The f64-exact host metrics (and the host kinds: percentiles,
        # numeric terms and cardinality, composite, matrix_stats) finish
        # from the matched mask.
        return {"mask": matched}
    if kind == "hits_planes":
        # top_hits: the context mask and the query's per-doc scores; the
        # host selects each rendered bucket's top docs from them.
        return {"mask": matched, "scores": scores}
    if kind == "top_metric_score":
        # max(where(matched, scores, -F32_MAX)): K10's max of the non-NaN
        # scores; a matched NaN score propagates as XLA's max does.
        _c, _s, _lo, mx = kernels.bucket_fold(None, matched, 1, values=scores)
        nan = matched & torch.isnan(scores)
        first_nan = scores[nan.to(torch.int8).argmax()]
        mx = torch.where(nan.any(), first_nan, mx[0])
        return {"max_score": mx, "any": _doc_count(matched) > 0}
    if kind == "cardinality_terms":
        # distinct keyword values: K10's terms counts, then the occupied
        # buckets (the reference's boolean scatter-max, then a sum)
        _, field_name, tp = spec
        _docs, ords, m = _posting_matched(seg, field_name, matched, num_docs)
        counts = kernels.bucket_fold(ords, m, tp)
        return {"distinct": (counts > 0).sum(dtype=torch.int32)}
    if kind == "sig_matched":
        # significant_terms over a segment without the field: only the
        # context (subset) size contributes.
        return {"doc_count": _doc_count(matched)}
    if kind in ("terms", "sig_terms"):
        field_name, tp, sub_fields = spec[1], spec[2], spec[3]
        docs, ords, m = _posting_matched(seg, field_name, matched, num_docs)
        out = {"counts": kernels.bucket_fold(ords, m, tp)}
        if kind == "sig_terms":
            # the subset (foreground) size the significance heuristics
            # need beside the per-term counts
            out["doc_count"] = _doc_count(matched)
        if len(spec) > 4:  # top_hits subs need the context mask
            out["ctx_mask"] = matched
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
        if len(spec) > 4:
            out["ctx_mask"] = matched
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
        if len(spec) > 4:
            out["ctx_mask"] = matched
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


def _stack_shards(results: list, lead: torch.device):
    """The shards' result trees as one tree of [S, ...] planes on the
    lead device (mesh.all_gather of every leaf)."""
    first = results[0]
    if isinstance(first, dict):
        return {k: _stack_shards([r[k] for r in results], lead) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(
            _stack_shards([r[i] for r in results], lead)
            for i in range(len(first))
        )
    return mesh.all_gather(results, lead)


def _psum_replicated(planes: list, lead: torch.device) -> torch.Tensor:
    """The integer planes' sum, replicated on a leading shard axis."""
    summed = mesh.psum(planes, lead)
    return summed.unsqueeze(0).expand(len(planes), *summed.shape)


def _mesh_combine_node(spec, results: list, lead: torch.device):
    """Cross-shard combine of one agg node's per-shard results: integer
    count planes psum (exact in any order, so equal to the host loop's
    per-shard fold); per-shard planes pass through stacked."""
    kind = spec[0]
    if kind in ("histogram", "range", "empty_buckets"):
        out = _stack_shards(results, lead)
        out["counts"] = _psum_replicated([r["counts"] for r in results], lead)
        return out
    if kind in ("filter", "global", "missing"):
        sub_specs = spec[-1]
        return {
            "doc_count": _psum_replicated(
                [r["doc_count"] for r in results], lead),
            "subs": tuple(
                _mesh_combine_node(s, [r["subs"][i] for r in results], lead)
                for i, s in enumerate(sub_specs)
            ),
        }
    if kind == "filters":
        sub_specs = spec[2]
        return tuple(
            {
                "doc_count": _psum_replicated(
                    [r[b]["doc_count"] for r in results], lead),
                "subs": tuple(
                    _mesh_combine_node(
                        s, [r[b]["subs"][i] for r in results], lead)
                    for i, s in enumerate(sub_specs)
                ),
            }
            for b in range(len(results[0]))
        )
    # matched / terms / cardinality_terms / hits planes: per shard.
    return _stack_shards(results, lead)


def mesh_combine(aggs_spec, shard_results: list, lead: torch.device):
    """The combine across a whole agg spec tuple: `shard_results` holds
    each shard's tuple of node results, in shard order."""
    return tuple(
        _mesh_combine_node(s, [r[i] for r in shard_results], lead)
        for i, s in enumerate(aggs_spec)
    )
