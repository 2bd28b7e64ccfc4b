"""BM25 query execution over tiled device postings, in PyTorch.

Port of elasticsearch_tpu/ops/bm25_device.py, trimmed to this slice's
paths: `execute` (dense), `execute_sparse` (candidate-centric),
`execute_auto`, and their batched forms `execute_batch`,
`execute_batch_sparse` and `execute_many` (the JAX package's vmaps of the
same programs, which the micro-batcher's coalesced launches run), over the
plan node kinds terms, terms_gather, terms_const, const, exists, range,
match_all, match_none and bool. Left out: stacked-shard, rescore, sorted,
cursor, block-max and packed execution, and the positional, nested,
script, function_score, geo and dis_max nodes (see ROADMAP queue B).

Every executor here is batched: plan arrays carry a leading query axis
[Q, ...] and one call runs all Q rows, one kernel launch per primitive,
not one per query. A solo query is the batch of one (Q = 1).

The four primitives that carry the path are hand-written CUDA kernels
(ops/kernels.py), each with a row axis: K1 terms_scatter (worklist gather
+ BM25 impact + ordered scatter), K2 sparse_fold (stable radix sort + run
fold), K3 masked_topk (top-k by score desc, index asc, plus totals) and
K4 span_locate (binary-search membership). Everything around them is
torch elementwise ops in the reference's exact fp32 operation order, so
the results — top-k ids, order, fp32 score bits and totals — equal the
JAX package's, row for row.

Plans are the reference compiler's (spec, arrays) with the arrays as
tensors (`plan_to_torch`); a terms node additionally carries its
host-side worklist `_groups` (the K1 launch order).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import kernels

NEG_INF = float("-inf")

# Widest disjunction the sparse run fold covers; wider ones go dense.
SPARSE_TPAD_MAX = 32


# ---------------------------------------------------------------------------
# Plans and segment views
# ---------------------------------------------------------------------------


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(x))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def plan_to_torch(spec, arrays, device) -> Any:
    """A compiled plan's numpy (or JAX) arrays as device tensors.

    Walks the arrays pytree (dicts and tuples): every array or numpy
    scalar becomes a tensor of the same dtype and shape on `device`; every
    worklist node (a dict with tile_ids/starts/ends) also gets `_groups`,
    its host-side K1 launch groups — int32[G, 2] for one plan, int32[Q, G,
    2] for a plan stacked along a leading query axis (`stack_plans`).
    `spec` is accepted for symmetry with the executors; the conversion
    needs only the arrays."""
    device = torch.device(device)

    def walk(node):
        if isinstance(node, dict):
            out = {key: walk(val) for key, val in node.items()}
            if {"tile_ids", "starts", "ends"} <= node.keys():
                tile_ids = np.asarray(node["tile_ids"])
                groups = (
                    kernels.batch_groups
                    if tile_ids.ndim == 2
                    else kernels.term_groups
                )
                out["_groups"] = groups(
                    tile_ids, np.asarray(node["starts"]),
                    np.asarray(node["ends"]),
                )
            return out
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        return _to_tensor(node, device)

    return walk(arrays)


def stack_plans(arrays_list: list) -> Any:
    """Stack same-spec plans' numpy arrays along a new leading query axis,
    on the host, so that `plan_to_torch` uploads each leaf once per batch
    (as the reference's execute_many does: a per-query upload of every
    small array costs far more than the one stacked copy)."""

    def walk(*nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {key: walk(*(n[key] for n in nodes)) for key in first}
        if isinstance(first, (tuple, list)):
            return tuple(walk(*col) for col in zip(*nodes))
        return np.stack([np.asarray(n) for n in nodes])

    return walk(*arrays_list)


def _rows1(plan) -> Any:
    """A solo plan (torch leaves) as the batch of one: every leaf gains a
    leading axis of 1, `_groups` included."""
    if isinstance(plan, dict):
        return {
            key: (np.asarray(val)[None] if key == "_groups" else _rows1(val))
            for key, val in plan.items()
        }
    if isinstance(plan, (tuple, list)):
        return tuple(_rows1(v) for v in plan)
    return plan[None]


def segment_tree(device_segment) -> dict[str, Any]:
    """The executor's view of a DeviceSegment, in the reference's tuple
    order: fields -> (doc_ids, tn, tfs, norm_bytes, present)."""
    return {
        "fields": {
            name: (f.doc_ids, f.tn, f.tfs, f.norm_bytes, f.present)
            for name, f in device_segment.fields.items()
        },
        "doc_values": dict(device_segment.doc_values),
        "live": device_segment.live,
    }


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-row scalar [Q] as a column [Q, 1] that broadcasts over docs."""
    return x.reshape(-1, 1)


# ---------------------------------------------------------------------------
# Dense evaluation, Q rows at once
# ---------------------------------------------------------------------------


def _eval_node(spec, arrays, seg: dict[str, Any], num_docs: int, q: int):
    """Returns (scores f32[Q, num_docs], matched bool[Q, num_docs])."""
    kind = spec[0]
    device = seg["live"].device
    if kind in ("terms", "terms_gather"):
        return _eval_terms(spec, arrays, seg, num_docs)
    if kind == "terms_const":
        matched = _terms_matched(spec, arrays, seg, num_docs)
        return torch.where(matched, _col(arrays["boost"]), 0.0), matched
    if kind == "const":
        _, child_spec = spec
        _, matched = _eval_node(child_spec, arrays["child"], seg, num_docs, q)
        return torch.where(matched, _col(arrays["boost"]), 0.0), matched
    if kind == "exists":
        _, field_name, field_kind = spec
        if field_kind == "inverted":
            matched = seg["fields"][field_name][4]  # presence bitmap
        else:
            matched = ~torch.isnan(seg["doc_values"][field_name])
        matched = matched.expand(q, num_docs)
        return torch.where(matched, _col(arrays["boost"]), 0.0), matched
    if kind == "range":
        return _eval_range(spec, arrays, seg, num_docs)
    if kind == "match_all":
        matched = torch.ones((q, num_docs), dtype=torch.bool, device=device)
        return _col(arrays["boost"]).expand(q, num_docs), matched
    if kind == "match_none":
        return (
            torch.zeros((q, num_docs), dtype=torch.float32, device=device),
            torch.zeros((q, num_docs), dtype=torch.bool, device=device),
        )
    if kind == "bool":
        return _eval_bool(spec, arrays, seg, num_docs, q)
    raise ValueError(f"unknown plan node kind [{kind}]")


def _eval_terms(spec, arrays, seg, num_docs):
    """K1: precomputed impacts (`terms`) or tf x norm cache
    (`terms_gather`, non-default statistics or k1/b)."""
    doc_tiles, tn, tfs, norm_bytes, _present = seg["fields"][spec[1]]
    gather = spec[0] == "terms_gather"
    scores, matched = kernels.terms_scatter_batch(
        doc_tiles,
        tfs if gather else tn,
        norm_bytes,
        arrays["tile_ids"],
        arrays["starts"],
        arrays["ends"],
        arrays["weights"],
        num_docs,
        arrays["_groups"],
        cache=arrays["cache"] if gather else None,
    )
    return scores[:, :num_docs], matched[:, :num_docs]


def _terms_matched(spec, arrays, seg, num_docs):
    """K1 in matched-only mode: a constant terms clause's bitmaps."""
    doc_tiles, tn, _tfs, norm_bytes, _present = seg["fields"][spec[1]]
    _, matched = kernels.terms_scatter_batch(
        doc_tiles, tn, norm_bytes, arrays["tile_ids"], arrays["starts"],
        arrays["ends"], None, num_docs, arrays["_groups"],
        matched_only=True,
    )
    return matched[:, :num_docs]


def _eval_range(spec, arrays, seg, num_docs):
    _, field_name = spec
    col = seg["doc_values"][field_name]  # f32[N], NaN = missing
    # NaN compares False
    matched = (col >= _col(arrays["lo"])) & (col <= _col(arrays["hi"]))
    return torch.where(matched, _col(arrays["boost"]), 0.0), matched


def _eval_bool(spec, arrays, seg, num_docs, q):
    # spec[6] (the sparse lead-clause choice) is irrelevant dense-side.
    must_s, should_s, filter_s, must_not_s, msm = spec[1:6]
    children = arrays["children"]
    i = 0
    must, should, filt, must_not = [], [], [], []
    for group, out in (
        (must_s, must),
        (should_s, should),
        (filter_s, filt),
        (must_not_s, must_not),
    ):
        for child_spec in group:
            out.append(_eval_node(child_spec, children[i], seg, num_docs, q))
            i += 1

    device = seg["live"].device
    matched = torch.ones((q, num_docs), dtype=torch.bool, device=device)
    for _, m in must:
        matched = matched & m
    for _, m in filt:
        matched = matched & m
    for _, m in must_not:
        matched = matched & ~m

    effective_msm = msm
    if effective_msm < 0:  # default: 1 iff no must and no filter clauses
        effective_msm = 1 if (not must_s and not filter_s) else 0
    if should:
        if effective_msm == 1:
            any_should = torch.zeros((q, num_docs), dtype=torch.bool,
                                     device=device)
            for _, m in should:
                any_should = any_should | m
            matched = matched & any_should
        elif effective_msm > 1:
            n_should = torch.zeros((q, num_docs), dtype=torch.int32,
                                   device=device)
            for _, m in should:
                n_should = n_should + m.to(torch.int32)
            matched = matched & (n_should >= effective_msm)

    score = torch.zeros((q, num_docs), dtype=torch.float32, device=device)
    for s, _ in must:
        score = score + s
    for s, _ in should:
        score = score + s
    score = torch.where(matched, score * _col(arrays["boost"]), 0.0)
    return score, matched


def _execute_inner(seg, spec, arrays, k: int, q: int):
    live = seg["live"]
    num_docs = live.shape[0]
    scores, matched = _eval_node(spec, arrays, seg, num_docs, q)
    eligible = matched & live
    masked = torch.where(eligible, scores, NEG_INF)
    return kernels.masked_topk_batch(masked, eligible, min(k, num_docs))


def _batch_size(arrays) -> int:
    """Q of a stacked plan: the leading axis of its first leaf."""
    if isinstance(arrays, dict):
        for key, val in arrays.items():
            if key != "_groups":
                q = _batch_size(val)
                if q:
                    return q
        return 0
    if isinstance(arrays, (tuple, list)):
        for val in arrays:
            q = _batch_size(val)
            if q:
                return q
        return 0
    return int(arrays.shape[0])


def _rows(arrays, q: int | None) -> int:
    if q is None:
        q = _batch_size(arrays)
    if q < 1:
        raise ValueError(
            "a plan with no array leaves needs its row count (q=...)"
        )
    return q


def execute_batch(seg, spec, arrays_batched, k: int, q: int | None = None):
    """Run Q same-spec compiled queries densely in one program.

    `arrays_batched` leaves carry a leading query axis [Q, ...] (a plan
    with no array leaves, match_none, needs `q`). Returns (top_scores
    f32[Q, min(k, N)], top_ids i32[Q, min(k, N)], totals i32[Q]); slots
    past a row's total hits carry score -inf (the host trims them)."""
    return _execute_inner(seg, spec, arrays_batched, k,
                          _rows(arrays_batched, q))


def _unbatch(out):
    return tuple(t[0] for t in out)


def execute(seg, spec, arrays, k: int):
    """Run one compiled plan densely over one device segment: the batch of
    one. Returns (top_scores f32[min(k, N)], top_ids i32[min(k, N)],
    total i32[])."""
    return _unbatch(execute_batch(seg, spec, _rows1(arrays), k, q=1))


# ---------------------------------------------------------------------------
# Sparse (candidate-centric) execution, Q rows at once
# ---------------------------------------------------------------------------


def supports_sparse(spec) -> bool:
    """Sparse execution covers precomputed-impact term disjunctions with a
    bounded run-fold length, and bool conjunctions of one such disjunction
    with constant-score term filters/exclusions."""
    if spec[0] == "terms":
        return spec[3] <= SPARSE_TPAD_MAX
    if spec[0] == "bool":
        must_s, should_s, filter_s, must_not_s = spec[1:5]
        return (
            len(must_s) == 1
            and must_s[0][0] == "terms"
            and must_s[0][3] <= SPARSE_TPAD_MAX
            and not should_s
            and all(c[0] == "terms_const" for c in filter_s)
            and all(c[0] == "terms_const" for c in must_not_s)
        )
    return False


def _bool_lead(spec) -> int:
    """The compile-time lead-clause choice of a bool spec (-1 = the
    default must-driven fold)."""
    return spec[6] if len(spec) > 6 else -1


def _topk_padded(key, eligible, kk: int, ids_of):
    """K3 over each row's candidate keys [Q, P], mapped to doc ids and
    padded to kk exactly as the reference pads when there are fewer
    candidate slots than k."""
    q, p = key.shape
    kp = min(kk, p)
    top_scores, top_pos, total = kernels.masked_topk_batch(key, eligible, kp)
    top_ids = torch.gather(ids_of, 1, top_pos.to(torch.int64))
    if kp < kk:
        top_scores = torch.cat([
            top_scores,
            torch.full((q, kk - kp), NEG_INF, dtype=torch.float32,
                       device=key.device),
        ], dim=1)
        top_ids = torch.cat([
            top_ids,
            torch.zeros((q, kk - kp), dtype=top_ids.dtype, device=key.device),
        ], dim=1)
    return top_scores, top_ids.to(torch.int32), total


def _sparse_candidates(seg, spec, arrays, k: int):
    """K2: (sorted candidate docs, left-fold run sums, run-head
    eligibility, each [Q, P], and the clamped k) for a terms spec."""
    live = seg["live"]
    num_docs = live.shape[0]
    doc_tiles, tn, _tfs, _norm, _present = seg["fields"][spec[1]]
    docs_s, run_sum, eligible = kernels.sparse_fold_batch(
        doc_tiles, tn, arrays["tile_ids"], arrays["starts"], arrays["ends"],
        arrays["weights"], live, num_docs, spec[3],
    )
    return docs_s, run_sum, eligible, min(k, num_docs)


def _sparse_terms_inner(seg, spec, arrays, k: int):
    docs_s, run_sum, eligible, kk = _sparse_candidates(seg, spec, arrays, k)
    key = torch.where(eligible, run_sum, NEG_INF)
    return _topk_padded(key, eligible, kk, docs_s)


def _const_membership(seg, child_spec, carr, safe_docs, num_docs):
    """Constant-clause membership at each row's candidate docs [Q, P]: K4
    binary search for a single contiguous span, else the K1 matched
    bitmap gathered."""
    if len(child_spec) == 4 and child_spec[3] == 1:
        flat = seg["fields"][child_spec[1]][0].reshape(-1)
        _pos, found = kernels.span_locate_batch(
            flat, _col(carr["span_start"]), _col(carr["span_end"]), 0,
            safe_docs,
        )
        return found
    matched = _terms_matched(child_spec, carr, seg, num_docs)
    return torch.gather(matched, 1, safe_docs.to(torch.int64))


def _sparse_bool_inner(seg, spec, arrays, k: int):
    """bool(must=[terms], filter/must_not=[terms_const...]): candidates
    from the must disjunction's K2 fold, each filter/exclusion tested at
    the candidates, no [num_docs] score plane and no dense top-k."""
    must_s, filter_s, must_not_s = spec[1], spec[3], spec[4]
    children = arrays["children"]
    num_docs = seg["live"].shape[0]
    docs_s, run_sum, eligible, kk = _sparse_candidates(
        seg, must_s[0], children[0], k
    )
    safe_docs = torch.clamp(docs_s, max=num_docs - 1)
    for idx_child, child_spec in enumerate(filter_s):
        eligible = eligible & _const_membership(
            seg, child_spec, children[1 + idx_child], safe_docs, num_docs
        )
    base = 1 + len(filter_s)
    for idx_child, child_spec in enumerate(must_not_s):
        eligible = eligible & ~_const_membership(
            seg, child_spec, children[base + idx_child], safe_docs, num_docs
        )
    key = torch.where(eligible, run_sum * _col(arrays["boost"]), NEG_INF)
    return _topk_padded(key, eligible, kk, docs_s)


def _sparse_lead_inner(seg, spec, arrays, k: int):
    """Lead-driven conjunction: the most selective single-span filter's
    postings (already doc-ascending) are the candidates; each must term
    verifies and scores them with one K4 binary search plus an impact
    gather, folding contributions in term order."""
    must_s, filter_s, must_not_s = spec[1], spec[3], spec[4]
    lead = _bool_lead(spec)
    children = arrays["children"]
    live = seg["live"]
    num_docs = live.shape[0]
    lead_spec = filter_s[lead]
    larr = children[1 + lead]
    lead_tiles = seg["fields"][lead_spec[1]][0]
    tid = larr["tile_ids"].to(torch.int64)  # [Q, nt]
    q = tid.shape[0]
    lane = torch.arange(kernels.TILE, device=live.device, dtype=torch.int64)
    pos = tid[..., None] * kernels.TILE + lane
    valid = (pos >= larr["starts"].to(torch.int64)[..., None]) & (
        pos < larr["ends"].to(torch.int64)[..., None]
    )
    cand = torch.where(valid, lead_tiles[tid], num_docs).reshape(q, -1)
    p = cand.shape[1]
    safe = torch.clamp(cand, max=num_docs - 1)
    in_range = cand != num_docs
    must_spec = must_s[0]
    marr = children[0]
    field_planes = seg["fields"][must_spec[1]]
    flat_docs = field_planes[0].reshape(-1)
    flat_tn = field_planes[1].reshape(-1)
    score = torch.zeros((q, p), dtype=torch.float32, device=live.device)
    matched_any = torch.zeros((q, p), dtype=torch.bool, device=live.device)
    for j in range(must_spec[3]):
        at, found = kernels.span_locate_batch(
            flat_docs, marr["term_starts"], marr["term_ends"], j, safe
        )
        found = found & in_range
        w = marr["term_weights"][:, j : j + 1]
        contrib = w - w / (1.0 + flat_tn[at.to(torch.int64)])
        score = score + torch.where(found, contrib, 0.0)
        matched_any = matched_any | found
    eligible = matched_any & in_range & live[safe.to(torch.int64)]
    for idx_child, child_spec in enumerate(filter_s):
        if idx_child == lead:
            continue
        eligible = eligible & _const_membership(
            seg, child_spec, children[1 + idx_child], safe, num_docs
        )
    base = 1 + len(filter_s)
    for idx_child, child_spec in enumerate(must_not_s):
        eligible = eligible & ~_const_membership(
            seg, child_spec, children[base + idx_child], safe, num_docs
        )
    key = torch.where(eligible, score * _col(arrays["boost"]), NEG_INF)
    return _topk_padded(key, eligible, min(k, num_docs), cand)


def execute_batch_sparse(seg, spec, arrays_batched, k: int):
    """Candidate-centric execution of Q same-spec supports_sparse plans
    ([Q, ...] plan arrays) in one program. Returns (top_scores
    f32[Q, min(k, N)], top_ids i32[Q, min(k, N)], totals i32[Q])."""
    if spec[0] == "bool":
        if _bool_lead(spec) >= 0:
            return _sparse_lead_inner(seg, spec, arrays_batched, k)
        return _sparse_bool_inner(seg, spec, arrays_batched, k)
    return _sparse_terms_inner(seg, spec, arrays_batched, k)


def execute_sparse(seg, spec, arrays, k: int):
    """Candidate-centric execution of one supports_sparse plan: the batch
    of one. Returns (top_scores f32[min(k, N)], top_ids i32[min(k, N)],
    total i32[])."""
    return _unbatch(execute_batch_sparse(seg, spec, _rows1(arrays), k))


def execute_auto(seg, spec, arrays, k: int):
    """Single-query execution via the best path for the spec."""
    if supports_sparse(spec):
        return execute_sparse(seg, spec, arrays, k)
    return execute(seg, spec, arrays, k)


def execute_batch_auto(seg, spec, arrays_batched, k: int, q: int | None = None):
    """Batched execution via the best path for the spec (the reference's
    choice in execute_many and SearchService._device_batch)."""
    if supports_sparse(spec):
        return execute_batch_sparse(seg, spec, arrays_batched, k)
    return execute_batch(seg, spec, arrays_batched, k, q=q)


def execute_many(seg, compiled_queries, k: int) -> list:
    """Grouped msearch: batch same-spec queries, one launch per shape group.

    Queries keep their natural pow-2 worklist buckets (no padding to the
    global max); each group's plans stack on the host and upload once.
    Returns results in input order: a list of (scores f32[min(k, N)],
    ids i32[min(k, N)], total int), as numpy."""
    groups: dict[tuple, list[int]] = {}
    for pos, c in enumerate(compiled_queries):
        groups.setdefault(c.spec, []).append(pos)
    device = seg["live"].device
    results: list = [None] * len(compiled_queries)
    for spec, positions in groups.items():
        arrays_b = plan_to_torch(
            spec,
            stack_plans([compiled_queries[p].arrays for p in positions]),
            device,
        )
        s_b, i_b, t_b = execute_batch_auto(
            seg, spec, arrays_b, k, q=len(positions)
        )
        s_b, i_b, t_b = s_b.cpu().numpy(), i_b.cpu().numpy(), t_b.cpu().numpy()
        for row, p in enumerate(positions):
            results[p] = (s_b[row], i_b[row], int(t_b[row]))
    return results
