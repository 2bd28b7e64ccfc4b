"""BM25 query execution over tiled device postings, in PyTorch.

Port of elasticsearch_tpu/ops/bm25_device.py, trimmed to this slice's
paths: `execute` (dense), `execute_sparse` (candidate-centric),
`execute_auto`, and their batched forms `execute_batch`,
`execute_batch_sparse` and `execute_many` (the JAX package's vmaps of the
same programs, which the micro-batcher's coalesced launches run); the
stacked single-device shards `execute_shards` / `execute_shards_batch`
(with `stack_segment_trees`, the port's `jax.tree.map(np.stack, ...)`);
and the two-launch block-max execution `execute_batch_blockmax`,
`execute_batch_blockmax_conj` and `execute_shards_blockmax_conj` (with
`supports_blockmax_conj`); the dense planes `execute_dense` and
`scores_at`; the sorted and cursor programs `sort_key_plane`,
`execute_sorted`, `execute_sorted_after`, `execute_score_asc` and
`execute_score_after`; the fused rescore `execute_rescore`; and
`compute_filter_mask`, a filter plan's matched plane (the knn filter and
the filter cache's planes), and `compute_filter_mask_stacked`, its form
over stacked shards; the filter cache's `cached_mask` node, which reads a
resident plane (`_eval_node`) or gathers it at the sparse candidates
(`_const_membership`, so `supports_sparse` admits it) —
over the plan node kinds terms, terms_gather, terms_const, const,
exists, range, match_all, match_none, bool, script (whose vector
functions read the dense_vector planes through K7's script mode) and
the positional kinds phrase, span_near and span_not (`_eval_phrase`,
`_eval_span_near`, `_eval_span_not`: K11 position_events, then K12
position_walk into the score plane, for one segment's Q rows; they are
dense-only, so `supports_sparse` stays false for them); and the
structured tail (row 16b): `nested` (`_eval_nested`: the child in the
nested docs' space, then K13 doc_join's join mode into parent space) and
`doc_set` (K13's mark mode, ids queries), and `function_score`,
`geo_distance`, `geo_box`, `rank_feature`, `boosting`, `terms_set` and
`dismax`, whose children run as any node does and whose elementwise tail
is one K14 tail_eval launch (ops/tail_kernel.py), again dense-only; over
stacked shards the positional and structured kinds run through K11-K14's
stacked modes (`stack_segment_trees` keeps the positional planes and the
nested blocks). The strictly sequential chains of row 17,
`execute_sequential_sparse`, `execute_sequential`,
`execute_shards_sequential` and `execute_rescore_sequential`, run Q
plans one after another on one stream, each plan chained to the
previous step's total by K15 chain_perturb (`_chain_perturb`).
Packed multi-tenant execution (row 13) is here: `supports_packed`,
`packed_segment_tree` and `execute_batch_packed`, which carry each lane's
tenant doc bounds into the dense path (K3b's window mode), the sparse
candidates (K2b's bounds mode) and the lead-driven conjunction.

Every executor here is batched: plan arrays carry a leading query axis
[Q, ...] and one call runs all Q rows, one kernel launch per primitive,
not one per query. A solo query is the batch of one (Q = 1).

The primitives that carry the path are hand-written kernels
(ops/kernels.py), each with a row axis: K1 terms_scatter (worklist gather
+ BM25 impact + ordered scatter), K2 sparse_fold (stable radix sort + run
fold), K3 masked_topk (top-k by score desc, index asc, plus totals), K4
span_locate (binary-search membership; its fold mode scores a filter-led
conjunction's must terms in one launch), K3k keyed_topk (K3's keyed mode:
bottom-k, field sorts and cursors), K5 window_rescore (the rescore
window's gather, combine and top-k), K6 script_eval (the Triton kernel
generated from a script, ops/script_kernel.py) and, for phrase and span
plans, K11 position_events (the sorted position events) and K12
position_walk (per-doc walks -> frequency -> BM25), K13 doc_join, K14
tail_eval and K15 chain_perturb. Everything around them is
torch elementwise ops in the reference's exact fp32 operation order, so
the results — top-k ids, order, fp32 score bits and totals — equal the
JAX package's, row for row.

Stacked shards: a segment tree whose planes carry a leading shard axis
[S, ...] (`stack_segment_trees`) runs a plan's [Q * S] rows, row r the
pair (query r // S, shard r % S), through the kernels' stacked mode
(K1s-K4s, and K11s-K14s for the positional and structured nodes), which
reads shard r % S's planes; the torch ops between them take row r's
shard the same way (`_take`, `_per_row`).

Plans are the reference compiler's (spec, arrays) with the arrays as
tensors (`plan_to_torch`); a terms node additionally carries its
host-side worklist `_groups` (the K1 launch order).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..script import compile_script
from ..script.painless_lite import _param_value, referenced_vectors
from . import kernels, script_kernel, tail_kernel

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
    2] for a plan stacked along a leading query axis (`stack_plans`), and
    int32[Q, S, G, 2] for S stacked shards' plans of Q queries.
    `spec` is accepted for symmetry with the executors; the conversion
    needs only the arrays."""
    device = torch.device(device)

    def walk(node):
        if isinstance(node, dict):
            out = {key: walk(val) for key, val in node.items()}
            if {"tile_ids", "starts", "ends"} <= node.keys():
                out["_groups"] = _plan_groups(
                    np.asarray(node["tile_ids"]), np.asarray(node["starts"]),
                    np.asarray(node["ends"]),
                )
            return out
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        return _to_tensor(node, device)

    return walk(arrays)


def _plan_groups(tile_ids, starts, ends) -> np.ndarray:
    """K1 launch groups of a worklist [nt], or of each row of [..., nt]."""
    if tile_ids.ndim == 1:
        return kernels.term_groups(tile_ids, starts, ends)
    lead, nt = tile_ids.shape[:-1], tile_ids.shape[-1]
    groups = kernels.batch_groups(
        tile_ids.reshape(-1, nt), starts.reshape(-1, nt),
        ends.reshape(-1, nt),
    )
    return groups.reshape(*lead, *groups.shape[1:])


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
    order: fields -> (doc_ids, tn, tfs, norm_bytes, present); positions
    -> (pos_doc, pos_val, pos_bits) of each field with positions (the
    reference's pair plus the host-side width of K11's position field);
    vectors -> f32[N, dims]; nested -> {"tree", "parent_of"} of each path
    (the reference's) plus K13's "child_start"."""
    return {
        "fields": {
            name: (f.doc_ids, f.tn, f.tfs, f.norm_bytes, f.present)
            for name, f in device_segment.fields.items()
        },
        "positions": {
            name: (f.pos_doc, f.pos_val, f.pos_bits)
            for name, f in device_segment.fields.items()
            if getattr(f, "pos_doc", None) is not None
        },
        "doc_values": dict(device_segment.doc_values),
        "vectors": dict(device_segment.vectors),
        "live": device_segment.live,
        "nested": {
            path: {"tree": segment_tree(inner), "parent_of": parent_of,
                   "child_start": child_start}
            for path, (inner, parent_of, child_start)
            in device_segment.nested.items()
        },
    }


def stack_segment_trees(trees: list) -> dict[str, Any]:
    """S shards' segment trees as one tree of [S, ...] tensors on their
    device: the port's `jax.tree.map(np.stack, *trees)`. The shards must
    have equal shapes (pack_segment with a common `pad_docs_to`,
    `field_min_tiles` and, for positional fields, `field_pos_min_tiles`,
    as bench.py:952-959 and ShardedIndex.from_segments pack them); nested
    blocks stack only where every shard's block has the same shapes, as
    the reference's np.stack requires. Anything else raises a ValueError
    naming the first leaf that differs. A field's `pos_bits` (a host int,
    the width of K11's position field) becomes the shards' largest, whose
    event keys must still fit 64 bits at the padded doc count."""
    return _stack_tree("", trees)


def _stack_tree(where: str, trees: list) -> dict[str, Any]:
    keys = _same_keys(where or "tree", trees)
    num_docs = int(trees[0]["live"].shape[-1])
    out = {}
    for key in keys:
        vals = [t[key] for t in trees]
        at = where + key
        if key == "positions":
            out[key] = {
                name: _stack_positions(f"{at}.{name}",
                                       [v[name] for v in vals], num_docs)
                for name in _same_keys(at, vals)
            }
        elif key == "nested":
            out[key] = {
                path: {
                    "tree": _stack_tree(f"{at}.{path}.tree.",
                                        [v[path]["tree"] for v in vals]),
                    **{part: _stack_leaves(f"{at}.{path}.{part}",
                                           [v[path][part] for v in vals])
                       for part in ("parent_of", "child_start")},
                }
                for path in _same_keys(at, vals)
            }
        else:
            out[key] = _stack_leaves(at, vals)
    return out


def _same_keys(where: str, dicts: list) -> list:
    keys = list(dicts[0])
    if any(sorted(d) != sorted(keys) for d in dicts[1:]):
        raise ValueError(
            f"cannot stack shards: [{where}] differs across shards "
            f"({[sorted(d) for d in dicts]})"
        )
    return keys


def _stack_positions(where: str, leaves: list, num_docs: int) -> tuple:
    """(pos_doc, pos_val) stacked to [S, PT, 256], pos_bits the largest."""
    pos_bits = max(int(leaf[2]) for leaf in leaves)
    kernels.event_key_bits(num_docs, pos_bits, 0)
    return (_stack_leaves(where + "[0]", [leaf[0] for leaf in leaves]),
            _stack_leaves(where + "[1]", [leaf[1] for leaf in leaves]),
            pos_bits)


def _stack_leaves(where: str, nodes: list):
    first = nodes[0]
    if isinstance(first, dict):
        return {key: _stack_leaves(f"{where}.{key}", [n[key] for n in nodes])
                for key in _same_keys(where, nodes)}
    if isinstance(first, (tuple, list)):
        return tuple(_stack_leaves(f"{where}[{i}]", list(col))
                     for i, col in enumerate(zip(*nodes)))
    shapes = [tuple(n.shape) for n in nodes]
    if len(set(shapes)) > 1:
        raise ValueError(
            f"cannot stack shards: [{where}] has shapes {shapes} across "
            f"shards (pack them to equal shapes: pad_docs_to, "
            f"field_min_tiles, field_pos_min_tiles; nested blocks must be "
            f"alike)"
        )
    return torch.stack(nodes)


def _n_shards(seg) -> int:
    """S of a stacked segment tree ([S, N] live plane); 0 for one
    segment."""
    return seg["live"].shape[0] if seg["live"].dim() == 2 else 0


def _take(seg, plane, idx: torch.Tensor) -> torch.Tensor:
    """plane[idx] for rows of indices idx [R, ...]: one segment's plane
    [X, ...], or, stacked, shard r % S's slice of [S, X, ...] for row r."""
    n_shards = _n_shards(seg)
    if not n_shards:
        return plane[idx]
    shard = torch.arange(idx.shape[0], device=idx.device) % n_shards
    return plane[shard.view(-1, *([1] * (idx.dim() - 1))), idx]


def _per_row(seg, plane, q: int) -> torch.Tensor:
    """A per-doc plane as an operand of [q, N] row planes: one segment's
    [N] broadcasts; a stacked [S, N] repeats so row r holds shard
    r % S's."""
    n_shards = _n_shards(seg)
    return plane.repeat(q // n_shards, 1) if n_shards else plane


def _flat_plane(seg, tiles) -> torch.Tensor:
    """A [NT, 256] postings plane as the flat [NT * 256] plane K4
    searches; stacked [S, NT, 256] planes as [S, NT * 256]."""
    if _n_shards(seg):
        return tiles.reshape(tiles.shape[0], -1)
    return tiles.reshape(-1)


def _kernel(seg, name: str):
    """K1, K2 or K4's wrapper (or K4's fold mode, `span_fold`) for this
    tree: the stacked mode for stacked shards, the row mode for one
    segment."""
    return getattr(kernels, name + ("_stacked" if _n_shards(seg) else "_batch"))


def _k3(seg, key, eligible, k: int):
    n_shards = _n_shards(seg)
    if n_shards:
        return kernels.masked_topk_stacked(key, eligible, k, n_shards)
    return kernels.masked_topk_batch(key, eligible, k)


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
        matched = _per_row(seg, matched, q).expand(q, num_docs)
        return torch.where(matched, _col(arrays["boost"]), 0.0), matched
    if kind == "range":
        return _eval_range(spec, arrays, seg, num_docs, q)
    if kind == "cached_mask":
        # A filter-cache plane (index/filter_cache.py): the subtree's
        # matched set, evaluated once and kept on the device; the node
        # reads seg["masks"][slot] ([N] on one segment, broadcast to the
        # Q rows without a copy; [S, N] on a stacked tree, row r reading
        # shard r % S). The plane is shared state: nothing downstream
        # writes into it. Boost where matched, as every constant leaf.
        matched = _per_row(seg, seg["masks"][spec[1]], q).expand(q, num_docs)
        return torch.where(matched, _col(arrays["boost"]), 0.0), matched
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
    if kind == "script":
        return _eval_script(spec, arrays, seg, num_docs, q)
    if kind == "phrase":
        return _eval_phrase(spec, arrays, seg, num_docs, q)
    if kind == "span_near":
        return _eval_span_near(spec, arrays, seg, num_docs, q)
    if kind == "span_not":
        return _eval_span_not(spec, arrays, seg, num_docs, q)
    if kind in _STRUCTURED:
        return _STRUCTURED[kind](spec, arrays, seg, num_docs, q)
    raise ValueError(f"unknown plan node kind [{kind}]")


# ---------------------------------------------------------------------------
# The structured tail (row 16b): K13 for nested and doc_set, K14 for the
# elementwise tails; dense-only, one segment's Q rows or, over stacked
# shards, the Q x S (query, shard) rows through their stacked modes
# ---------------------------------------------------------------------------


def _rows_of(x: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """A child's plane (possibly broadcast) as a contiguous [Q, N]."""
    return x.expand(q, n).contiguous()


def _row_param(x: torch.Tensor, q: int) -> torch.Tensor:
    return x.reshape(q).to(torch.float32).contiguous()


def _tail(seg, key, q, n, planes=None, masks=None, columns=None,
          params=None):
    """One K14 launch over the node's inputs (its stacked mode over a
    stacked tree: the columns [S, N])."""
    return tail_kernel.tail_eval(
        key, q, n,
        {k: _rows_of(v, q, n) for k, v in (planes or {}).items()},
        {k: _rows_of(v, q, n) for k, v in (masks or {}).items()},
        dict(columns or {}),
        {k: _row_param(v, q) for k, v in (params or {}).items()},
        n_shards=_n_shards(seg),
    )


def _pick(arrays, *names):
    return {name: arrays[name] for name in names}


def _eval_geo_distance(spec, arrays, seg, num_docs, q):
    field = spec[1]
    dv = seg["doc_values"]
    return _tail(
        seg, ("geo_distance",), q, num_docs,
        columns={"lat": dv[field + ".lat"], "lon": dv[field + ".lon"]},
        params=_pick(arrays, "lat", "lon", "radius_m", "boost"),
    )


def _eval_geo_box(spec, arrays, seg, num_docs, q):
    field = spec[1]
    dv = seg["doc_values"]
    return _tail(
        seg, ("geo_box",), q, num_docs,
        columns={"lat": dv[field + ".lat"], "lon": dv[field + ".lon"]},
        params=_pick(arrays, "top", "left", "bottom", "right", "boost"),
    )


def _eval_rank_feature(spec, arrays, seg, num_docs, q):
    _, field, fn = spec
    return _tail(
        seg, ("rank_feature", fn), q, num_docs,
        columns={"col": seg["doc_values"][field]},
        params=_pick(arrays, "pivot", "scaling", "exponent", "boost"),
    )


def _eval_boosting(spec, arrays, seg, num_docs, q):
    _, pos_spec, neg_spec = spec
    ps, pm = _eval_node(pos_spec, arrays["positive"], seg, num_docs, q)
    _, nm = _eval_node(neg_spec, arrays["negative"], seg, num_docs, q)
    return _tail(
        seg, ("boosting",), q, num_docs,
        planes={"positive": ps}, masks={"positive": pm, "negative": nm},
        params=_pick(arrays, "negative_boost", "boost"),
    )


def _eval_dismax(spec, arrays, seg, num_docs, q):
    _, child_specs = spec
    planes, masks = {}, {}
    for i, (cspec, carr) in enumerate(zip(child_specs, arrays["children"])):
        planes[f"s{i}"], masks[f"m{i}"] = _eval_node(cspec, carr, seg,
                                                     num_docs, q)
    return _tail(seg, ("dismax", len(child_specs)), q, num_docs, planes, masks,
                 params=_pick(arrays, "tie", "boost"))


def _eval_terms_set(spec, arrays, seg, num_docs, q):
    """terms_set: the scored terms (K1), one matched-only K1 per term,
    then K14's coverage gate against a column or a script."""
    _, scored_spec, count_specs, msm_kind, msm_ref = spec
    s, _m = _eval_node(scored_spec, arrays["scored"], seg, num_docs, q)
    masks = {}
    for i, (cspec, carr) in enumerate(zip(count_specs, arrays["counts"])):
        _, masks[f"m{i}"] = _eval_node(cspec, carr, seg, num_docs, q)
    params = {"boost": arrays["boost"]}
    planes = {"scored": s}
    if msm_kind == "field":
        columns = {"required": seg["doc_values"][msm_ref]}
        key = ("terms_set", len(count_specs), "field", None)
    else:
        columns = seg["doc_values"]
        vec_planes, script_params = _tail_script_inputs(
            msm_ref[0], arrays["params"], seg, q, "")
        params.update(script_params)
        planes.update(vec_planes)
        key = ("terms_set", len(count_specs), "script", msm_ref)
    return _tail(seg, key, q, num_docs, planes, masks, columns, params)


def _eval_function_score(spec, arrays, seg, num_docs, q):
    """function_score: the child and the function filters as any node,
    then one K14 launch with query/functions.py's math."""
    (_, child_spec, fspecs, filter_specs, score_mode, boost_mode,
     has_min) = spec
    cs, cm = _eval_node(child_spec, arrays["child"], seg, num_docs, q)
    masks = {"child": cm}
    planes = {"child": cs}
    params = {"max_boost": arrays["max_boost"], "boost": arrays["boost"]}
    if has_min:
        params["min_score"] = arrays["min_score"]
    for i, (fspec, farr, fil_spec, fil_arr) in enumerate(zip(
        fspecs, arrays["functions"], filter_specs, arrays["filters"]
    )):
        if fil_spec is not None:
            _, masks[f"f{i}"] = _eval_node(fil_spec, fil_arr, seg, num_docs, q)
        for name, val in farr.items():
            if name == "params":
                vec_planes, script_params = _tail_script_inputs(
                    fspec[1], val, seg, q, f"f{i}.")
                params.update(script_params)
                planes.update(vec_planes)
            elif name == "seed":
                params[f"f{i}.seed"] = tail_kernel.seed_bits(val.reshape(q))
            else:
                params[f"f{i}.{name}"] = val
    key = ("function_score", fspecs, tuple(f is not None for f in filter_specs),
           score_mode, boost_mode, has_min)
    return _tail(seg, key, q, num_docs, planes, masks, seg["doc_values"],
                 params)


def _tail_script_inputs(source, params, seg, q, prefix):
    """The K14 inputs of a function_score or terms_set script: (planes,
    params). Each param the script reads as a number is the param
    `<prefix>p.<name>`; each vector call (param, field) reads K7's
    script-mode planes (`vector_planes`, as script_score stages them) as
    the planes `<prefix>v.<param>.<field>.dot` / `.norm` / `.dist` and |q|
    as the param `<prefix>v.<param>.<field>.qnorm`. A list where a number
    is read is a ValueError (a 400), as in K6."""
    script = compile_script(source)
    rows = {name: p.reshape(q, -1) for name, p in params.items()}
    planes, out = {}, {}
    staged = vector_planes(script, seg.get("vectors", {}), rows)
    for (name, field), (dot, norm, dist, qnorm) in staged.items():
        tag = tail_kernel.vector_tag(prefix, name, field)
        planes.update({tag + "dot": dot, tag + "norm": norm,
                       tag + "dist": dist})
        out[tag + "qnorm"] = qnorm
    for name in tail_kernel.script_value_params(source, rows):
        if rows[name].shape[1] != 1:
            raise ValueError(f"script param [{name}] must be a number")
        out[f"{prefix}p.{name}"] = rows[name]
    return planes, out


def _eval_nested(spec, arrays, seg, num_docs, q):
    """nested: the child in the path's nested-doc space, then K13's join
    of its matches and score reduction into parent space (over stacked
    shards, the stacked nested tree and K13's stacked join)."""
    _, path, child_spec, score_mode = spec
    blk = seg["nested"][path]
    ntree = blk["tree"]
    nn = ntree["live"].shape[-1]
    cs, cm = _eval_node(child_spec, arrays["child"], ntree, nn, q)
    cm = cm & _per_row(ntree, ntree["live"], q)
    matched, scores = kernels.doc_join(
        _rows_of(cm, q, nn), _rows_of(cs, q, nn), blk["child_start"],
        _row_param(arrays["boost"], q), score_mode, n_shards=_n_shards(seg),
    )
    return scores, matched


def _eval_doc_set(spec, arrays, seg, num_docs, q):
    """ids: K13's mark mode over the row's local ids (-1 padding)."""
    matched, scores = kernels.doc_mark(
        arrays["docs"].reshape(q, -1).to(torch.int32).contiguous(),
        _row_param(arrays["boost"], q), num_docs, n_shards=_n_shards(seg),
    )
    return scores, matched


_STRUCTURED = {
    "geo_distance": _eval_geo_distance,
    "geo_box": _eval_geo_box,
    "rank_feature": _eval_rank_feature,
    "boosting": _eval_boosting,
    "dismax": _eval_dismax,
    "terms_set": _eval_terms_set,
    "function_score": _eval_function_score,
    "nested": _eval_nested,
    "doc_set": _eval_doc_set,
}


def _position_walk(spec, arrays, seg, num_docs, q, lane_key, mode,
                   clause_bits, **walk):
    """K11 over the node's position worklist, then K12 into its [Q, N]
    score and matched planes (one launch each for the Q rows; their
    stacked modes over a stacked tree)."""
    stacked = "_stacked" if _n_shards(seg) else ""
    field_name = spec[1]
    pos_doc, pos_val, pos_bits = seg["positions"][field_name]
    keys, count = getattr(kernels, "position_events" + stacked)(
        pos_doc, pos_val, arrays["tile_ids"], arrays["starts"],
        arrays["ends"], arrays[lane_key], num_docs, pos_bits, clause_bits,
        kernels.EVENTS_PHRASE if mode == kernels.WALK_PHRASE
        else kernels.EVENTS_SPAN,
    )
    return getattr(kernels, "position_walk" + stacked)(
        keys, count, seg["fields"][field_name][3], arrays["weight"].reshape(q),
        arrays["cache"].reshape(q, -1), num_docs, pos_bits, clause_bits,
        mode, **walk,
    )


def _eval_phrase(spec, arrays, seg, num_docs, q):
    """Exact phrase (row 14): an occurrence is a (doc, aligned position)
    group of at least n_slots position events; its frequency scores
    through BM25 with the summed idf."""
    _, _field, _nt, n_slots = spec
    return _position_walk(spec, arrays, seg, num_docs, q, "shifts",
                          kernels.WALK_PHRASE, 0, n=n_slots)


def _eval_span_near(spec, arrays, seg, num_docs, q):
    """span_near / span_or / span_first / intervals over unit spans
    (row 15): chain ends within slop (both orders for an unordered pair),
    cut at end_limit, counted per doc."""
    _, _field, _nt, n_clauses, slop, ordered, end_limit = spec
    return _position_walk(
        spec, arrays, seg, num_docs, q, "clause_of", kernels.WALK_NEAR,
        kernels.clause_bits_for(n_clauses), n=n_clauses, slop=slop,
        ordered=ordered, end_limit=end_limit,
    )


def _eval_span_not(spec, arrays, seg, num_docs, q):
    """span_not over unit spans (row 15): includes (clause 0) with no
    exclude (clause 1) within [pos - pre, pos + post]."""
    _, _field, _nt, pre, post = spec
    return _position_walk(
        spec, arrays, seg, num_docs, q, "clause_of", kernels.WALK_NOT,
        kernels.clause_bits_for(2), n=2, pre=pre, post=post,
    )


def _eval_terms(spec, arrays, seg, num_docs):
    """K1: precomputed impacts (`terms`) or tf x norm cache
    (`terms_gather`, non-default statistics or k1/b)."""
    doc_tiles, tn, tfs, norm_bytes, _present = seg["fields"][spec[1]]
    gather = spec[0] == "terms_gather"
    scores, matched = _kernel(seg, "terms_scatter")(
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
    _, matched = _kernel(seg, "terms_scatter")(
        doc_tiles, tn, norm_bytes, arrays["tile_ids"], arrays["starts"],
        arrays["ends"], None, num_docs, arrays["_groups"],
        matched_only=True,
    )
    return matched[:, :num_docs]


def _eval_range(spec, arrays, seg, num_docs, q):
    _, field_name = spec
    col = _per_row(seg, seg["doc_values"][field_name], q)  # NaN = missing
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


def _eval_script(spec, arrays, seg, num_docs, q):
    """script_score (row 16a): the child's dense scores through the
    script, boost and min_score — K6 on the card, its plain torch
    evaluation for CPU tensors (ops/script_kernel). The script's vector
    functions read K7's script-mode planes (`vector_planes`)."""
    _, child_spec, source, _param_names, has_min_score = spec
    script = compile_script(source)
    params = {name: p.reshape(q, -1) for name, p in arrays["params"].items()}
    child_scores, matched = _eval_node(
        child_spec, arrays["child"], seg, num_docs, q
    )
    return script_kernel.script_eval(
        script,
        child_scores.expand(q, num_docs).contiguous(),
        matched.expand(q, num_docs).contiguous(),
        seg["doc_values"],
        params,
        arrays["boost"].reshape(q),
        arrays["min_score"].reshape(q) if has_min_score else None,
        n_shards=_n_shards(seg),
        vectors=vector_planes(script, seg.get("vectors", {}), params),
    )


def vector_planes(script, vectors: dict, params: dict) -> dict:
    """K7's script-mode planes for each (param, field) vector call of a
    script: {(param, field): (dot, |v|, |v - q|) f32[Q, N] and |q| f32[Q]},
    params name -> f32[Q, d]. An unknown field, or a query vector whose
    length is not the field's dims, is a ValueError (a 400)."""
    out = {}
    for name, field in referenced_vectors(script):
        if field not in vectors:
            raise ValueError(f"no dense_vector field [{field}]")
        plane = vectors[field]
        qv = _param_value(params, name)
        if qv.dim() != 2 or qv.shape[1] != plane.shape[-1]:
            raise ValueError(
                f"the query vector [params.{name}] has a different number "
                f"of dimensions [{qv.shape[-1] if qv.dim() else 1}] than "
                f"the document vectors [{plane.shape[-1]}]"
            )
        out[(name, field)] = kernels.vector_script_batch(
            plane, qv.to(torch.float32).contiguous()
        )
    return out


def _execute_inner(seg, spec, arrays, k: int, q: int, bounds=None):
    live = seg["live"]
    num_docs = live.shape[-1]
    scores, matched = _eval_node(spec, arrays, seg, num_docs, q)
    eligible = matched & _per_row(seg, live, q)
    masked = torch.where(eligible, scores, NEG_INF)
    if bounds is not None:
        # Packed plane: only this lane's tenant doc range [lo, hi) is
        # eligible. K3b's window mode reads just that window, counts the
        # total there and returns tenant-local ids (id - lo).
        return kernels.masked_topk_window(
            masked, eligible, bounds[0], bounds[1], min(k, num_docs)
        )
    return _k3(seg, masked, eligible, min(k, num_docs))


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
# Dense planes (row 8a), sorts and cursors (row 11): one dense evaluation,
# then K5's gather or one K3k launch. Public signatures are the
# reference's solo ones; inside, a plan is the batch of one.
# ---------------------------------------------------------------------------


def _dense_rows(seg, spec, arrays, q: int):
    """(scores f32[Q, N], eligible bool[Q, N] = matched & live), both
    materialized, of Q rows."""
    live = seg["live"]
    num_docs = live.shape[-1]
    scores, matched = _eval_node(spec, arrays, seg, num_docs, q)
    eligible = (matched & _per_row(seg, live, q)).expand(q, num_docs)
    return scores.expand(q, num_docs).contiguous(), eligible.contiguous()


def compute_filter_mask(seg, spec, arrays):
    """A filter plan's matched plane bool[N] over one segment: the dense
    evaluation's `matched`, live deliberately NOT applied (deletions AND
    in at query time) — the knn section's filter mask."""
    num_docs = seg["live"].shape[-1]
    _, matched = _eval_node(spec, _rows1(arrays), seg, num_docs, 1)
    return matched[0]


def compute_filter_mask_stacked(seg_stacked, spec, arrays_stacked):
    """A filter plan's matched planes bool[S, N] over S stacked shards
    ([S, ...] plan, each shard's row compiled with that shard's own
    statistics): the reference's vmap of compute_filter_mask, as the S
    rows of one evaluation (K1's stacked matched-only mode for terms
    clauses), live not applied."""
    n_shards = _n_shards(seg_stacked)
    if not n_shards:
        raise ValueError("compute_filter_mask_stacked needs a stacked tree")
    num_docs = seg_stacked["live"].shape[-1]
    _, matched = _eval_node(
        spec, _pair_rows(_rows1(arrays_stacked)), seg_stacked, num_docs,
        n_shards,
    )
    return matched.expand(n_shards, num_docs)


def execute_dense(seg, spec, arrays):
    """Dense (scores, matched) over all docs — for rescoring and sorts:
    (f32[N] scores, 0 where not eligible; bool[N] matched & live)."""
    scores, eligible = _dense_rows(seg, spec, _rows1(arrays), 1)
    return torch.where(eligible, scores, 0.0)[0], eligible[0]


def scores_at(seg, spec, arrays, ids):
    """Evaluate a query and gather (scores, matched) at specific doc ids
    (i32[W]): the rescore phase's primitive; the dense evaluation stays
    on the device and K5's gather mode reads the window out."""
    scores, eligible = _dense_rows(seg, spec, _rows1(arrays), 1)
    rs, rm = kernels.window_gather_batch(scores, eligible, ids[None])
    return rs[0], rm[0]


def sort_key_plane(seg, field_name: str, desc: bool, missing_first: bool):
    """(column, transformed ascending sort key) of a doc-values column:
    negated for desc, missing (NaN) pinned to -/+f32max per the missing
    directive. K3k builds the same key inside its kernel; this is its
    definition and the plain version's."""
    col = seg["doc_values"][field_name]
    return col, kernels.sort_key(col, desc, missing_first)


def _cursor(after_key, after_doc, device):
    return (
        torch.tensor([np.float32(after_key)], dtype=torch.float32).to(device),
        torch.tensor([int(after_doc)], dtype=torch.int32).to(device),
    )


def execute_sorted(seg, spec, arrays, field_name: str, desc: bool, k: int,
                   missing_first: bool = False):
    """Query + field sort: top-k by a doc-values column, missing first or
    last (default last), ties by ascending doc id. Returns (values f32[k']
    raw field values (NaN = missing), ids i32[k'], total i32[]), k' =
    min(k, N)."""
    _scores, eligible = _dense_rows(seg, spec, _rows1(arrays), 1)
    values, ids, total, _n = kernels.keyed_topk_batch(
        seg["doc_values"][field_name], eligible, k, kernels.KEYED_FIELD,
        desc=desc, missing_first=missing_first,
    )
    return values[0], ids[0], total[0]


def execute_sorted_after(seg, spec, arrays, field_name: str, desc: bool,
                         k: int, after_key, after_doc,
                         missing_first: bool = False):
    """Field-sorted top-k strictly after the (key, doc) cursor; `after_key`
    lives in the transformed ascending key space (negated for desc,
    missing = -/+f32max). Returns (values, ids, total, n_after)."""
    _scores, eligible = _dense_rows(seg, spec, _rows1(arrays), 1)
    out = kernels.keyed_topk_batch(
        seg["doc_values"][field_name], eligible, k, kernels.KEYED_FIELD,
        desc, missing_first, *_cursor(after_key, after_doc, eligible.device),
    )
    return tuple(t[0] for t in out)


def execute_score_asc(seg, spec, arrays, k: int):
    """Bottom-k by score (explicit {"_score": "asc"} sorts): ineligible
    docs mask to +inf, ties by ascending doc id. Returns (scores f32[k'],
    ids i32[k'], total i32[])."""
    scores, eligible = _dense_rows(seg, spec, _rows1(arrays), 1)
    values, ids, total, _n = kernels.keyed_topk_batch(
        scores, eligible, k, kernels.KEYED_SCORE_ASC,
    )
    return values[0], ids[0], total[0]


def execute_score_after(seg, spec, arrays, k: int, after_score, after_doc,
                        ascending: bool = False):
    """Score-ordered top-k strictly after the (score, doc) cursor. Returns
    (scores f32[k'], ids i32[k'], total i32[], n_after i32[]); totals
    stay the full match count."""
    scores, eligible = _dense_rows(seg, spec, _rows1(arrays), 1)
    out = kernels.keyed_topk_batch(
        scores, eligible, k,
        kernels.KEYED_SCORE_ASC if ascending else kernels.KEYED_SCORE_DESC,
        False, False, *_cursor(after_score, after_doc, eligible.device),
    )
    return tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# Fused rescore (row 10): the query's top window (K1-K4), the rescore
# plane (the dense evaluation, K6 for a script) and K5's fused gather,
# combine and top-k, with no host round trip between the phases.
# ---------------------------------------------------------------------------


def _rescore_inner(seg, spec, arrays, rspec, rarrays, k: int, window: int,
                   query_weight, rescore_weight, q: int):
    s, ids, total = _inner_for(spec)(seg, spec, arrays, window, q)
    rscores, relig = _dense_rows(seg, rspec, rarrays, q)
    top_s, top_ids = kernels.window_rescore_batch(
        s.contiguous(), ids.contiguous(), rscores, relig,
        query_weight, rescore_weight, k,
    )
    return top_s, top_ids, total


def execute_rescore(seg, spec, arrays, rspec, rarrays, k: int, window: int,
                    query_weight, rescore_weight):
    """score_mode=total rescore: qw*orig + rw*rescore for window docs the
    rescore query matches, qw*orig otherwise; ties keep original rank.
    Returns (scores f32[min(k, W)], ids i32[min(k, W)], total i32[]),
    W = min(window, N)."""
    return _unbatch(_rescore_inner(
        seg, spec, _rows1(arrays), rspec, _rows1(rarrays), k, window,
        query_weight, rescore_weight, 1,
    ))


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
        # Filter-cache planes verify at the candidates with one gather.
        const_kinds = ("terms_const", "cached_mask")
        return (
            len(must_s) == 1
            and must_s[0][0] == "terms"
            and must_s[0][3] <= SPARSE_TPAD_MAX
            and not should_s
            and all(c[0] in const_kinds for c in filter_s)
            and all(c[0] in const_kinds for c in must_not_s)
        )
    return False


def _bool_lead(spec) -> int:
    """The compile-time lead-clause choice of a bool spec (-1 = the
    default must-driven fold)."""
    return spec[6] if len(spec) > 6 else -1


def _topk_padded(seg, key, eligible, kk: int, ids_of):
    """K3 over each row's candidate keys [Q, P], mapped to doc ids and
    padded to kk exactly as the reference pads when there are fewer
    candidate slots than k."""
    q, p = key.shape
    kp = min(kk, p)
    top_scores, top_pos, total = _k3(seg, key, eligible, kp)
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


def _sparse_candidates(seg, spec, arrays, k: int, bounds=None):
    """K2: (sorted candidate docs, left-fold run sums, run-head
    eligibility, each [Q, P], and the clamped k) for a terms spec.
    `bounds` (lo, hi int32[Q]) are the packed plane's tenant doc ranges:
    K2b's bounds mode keeps a run head eligible only inside its row's."""
    live = seg["live"]
    num_docs = live.shape[-1]
    doc_tiles, tn, _tfs, _norm, _present = seg["fields"][spec[1]]
    args = (
        doc_tiles, tn, arrays["tile_ids"], arrays["starts"], arrays["ends"],
        arrays["weights"], live, num_docs, spec[3],
    )
    if bounds is None:
        docs_s, run_sum, eligible = _kernel(seg, "sparse_fold")(*args)
    else:
        docs_s, run_sum, eligible = kernels.sparse_fold_bounds(*args, *bounds)
    return docs_s, run_sum, eligible, min(k, num_docs)


def _sparse_terms_inner(seg, spec, arrays, k: int, bounds=None):
    docs_s, run_sum, eligible, kk = _sparse_candidates(
        seg, spec, arrays, k, bounds
    )
    key = torch.where(eligible, run_sum, NEG_INF)
    return _topk_padded(seg, key, eligible, kk, docs_s)


def _const_membership(seg, child_spec, carr, safe_docs, num_docs):
    """Constant-clause membership at each row's candidate docs [Q, P]: a
    filter-cache plane gathered there (row r reads shard r % S's row of a
    stacked [S, N] plane), K4 binary search for a single contiguous span,
    else the K1 matched bitmap gathered."""
    if child_spec[0] == "cached_mask":
        return _take(seg, seg["masks"][child_spec[1]],
                     safe_docs.to(torch.int64))
    if len(child_spec) == 4 and child_spec[3] == 1:
        flat = _flat_plane(seg, seg["fields"][child_spec[1]][0])
        _pos, found = _kernel(seg, "span_locate")(
            flat, _col(carr["span_start"]), _col(carr["span_end"]), 0,
            safe_docs,
        )
        return found
    matched = _terms_matched(child_spec, carr, seg, num_docs)
    return torch.gather(matched, 1, safe_docs.to(torch.int64))


def _sparse_bool_inner(seg, spec, arrays, k: int, bounds=None):
    """bool(must=[terms], filter/must_not=[terms_const...]): candidates
    from the must disjunction's K2 fold, each filter/exclusion tested at
    the candidates, no [num_docs] score plane and no dense top-k."""
    must_s, filter_s, must_not_s = spec[1], spec[3], spec[4]
    children = arrays["children"]
    num_docs = seg["live"].shape[-1]
    docs_s, run_sum, eligible, kk = _sparse_candidates(
        seg, must_s[0], children[0], k, bounds
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
    return _topk_padded(seg, key, eligible, kk, docs_s)


def _sparse_lead_inner(seg, spec, arrays, k: int, bounds=None):
    """Lead-driven conjunction: the most selective single-span filter's
    postings (already doc-ascending) are the candidates; the must terms
    verify and score them in one launch of K4's fold mode (per term a
    binary search plus an impact gather, contributions folded in term
    order)."""
    must_s, filter_s, must_not_s = spec[1], spec[3], spec[4]
    lead = _bool_lead(spec)
    children = arrays["children"]
    live = seg["live"]
    num_docs = live.shape[-1]
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
    cand = torch.where(valid, _take(seg, lead_tiles, tid), num_docs).reshape(q, -1)
    safe = torch.clamp(cand, max=num_docs - 1)
    in_range = cand != num_docs
    must_spec = must_s[0]
    marr = children[0]
    field_planes = seg["fields"][must_spec[1]]
    flat_docs = _flat_plane(seg, field_planes[0])
    flat_tn = _flat_plane(seg, field_planes[1])
    # K4's fold mode: every must term's search, tn gather and fold in one
    # launch (on the CPU, the per-term loop op for op).
    score, matched_any = _kernel(seg, "span_fold")(
        flat_docs, flat_tn, marr["term_starts"], marr["term_ends"],
        marr["term_weights"], safe, in_range,
    )
    eligible = matched_any & in_range & _take(seg, live, safe.to(torch.int64))
    if bounds is not None:
        eligible = eligible & (cand >= _col(bounds[0])) & (
            cand < _col(bounds[1]))
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
    return _topk_padded(seg, key, eligible, min(k, num_docs), cand)


def _sparse_inner(seg, spec, arrays, k: int, q: int | None = None,
                  bounds=None):
    if spec[0] == "bool":
        if _bool_lead(spec) >= 0:
            return _sparse_lead_inner(seg, spec, arrays, k, bounds)
        return _sparse_bool_inner(seg, spec, arrays, k, bounds)
    return _sparse_terms_inner(seg, spec, arrays, k, bounds)


def execute_batch_sparse(seg, spec, arrays_batched, k: int):
    """Candidate-centric execution of Q same-spec supports_sparse plans
    ([Q, ...] plan arrays) in one program. Returns (top_scores
    f32[Q, min(k, N)], top_ids i32[Q, min(k, N)], totals i32[Q])."""
    return _sparse_inner(seg, spec, arrays_batched, k)


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


# ---------------------------------------------------------------------------
# Packed multi-tenant execution (kernel-table row 13): B (query, tenant)
# lanes of one spec scored against one packed plane (index/tiles.py
# PackedPlane) in one program, each lane masked to its tenant's doc range
# [lo, hi) — K2b's bounds mode on the sparse path, a torch mask on the
# lead-driven conjunction's candidates, K3b's window mode on the dense
# path — and its ids returned tenant-local. A lane's plan is its solo
# plan shifted by whole tiles, so the fold order and the fp32 rounding
# are the solo ones.
# ---------------------------------------------------------------------------

_PACKED_KINDS = ("terms", "terms_gather", "terms_const", "match_none")


def supports_packed(spec) -> bool:
    """May this compiled spec execute on a packed multi-tenant plane?
    Trees of term-worklist nodes only (every match / term / terms query
    and bool / constant_score combinations of them): the plane holds only
    the inverted fields' postings planes."""
    if not isinstance(spec, tuple) or not spec:
        return False
    kind = spec[0]
    if kind in _PACKED_KINDS:
        return True
    if kind == "const":
        return supports_packed(spec[1])
    if kind == "bool":
        return all(supports_packed(c) for group in spec[1:5] for c in group)
    return False


def packed_segment_tree(plane) -> dict[str, Any]:
    """The executor's view of an index.tiles.PackedPlane (the packed
    counterpart of segment_tree; only inverted fields exist)."""
    return {
        "fields": {
            name: (pf.doc_ids, pf.tn, pf.tfs, pf.norm_bytes, pf.present)
            for name, pf in plane.fields.items()
        },
        "positions": {},
        "doc_values": {},
        "vectors": {},
        "live": plane.live,
        "nested": {},
    }


def execute_batch_packed(seg, spec, arrays_batched, lo_b, hi_b, k: int):
    """Score B same-spec lanes against one packed plane in one program.

    arrays_batched: plan arrays with a leading lane axis [B, ...], compiled
    in packed coordinates (each lane through its member's views). lo_b /
    hi_b: the lanes' tenant doc bounds, B ints each (numpy or a list).
    Returns (scores f32[B, min(k, N_total)], TENANT-LOCAL ids
    i32[B, min(k, N_total)], totals i32[B]): per lane, the first
    min(k, total) slots equal the lane's query run on its tenant's own
    plane; the slots past them are padding no caller reads."""
    device = seg["live"].device
    lo, hi = (
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)
        for x in (lo_b, hi_b)
    )
    if supports_sparse(spec):
        s, ids, t = _sparse_inner(seg, spec, arrays_batched, k,
                                  bounds=(lo, hi))
        return s, ids - _col(lo), t
    return _execute_inner(seg, spec, arrays_batched, k, int(lo.shape[0]),
                          bounds=(lo, hi))


# ---------------------------------------------------------------------------
# Stacked shards on one device: every shard's tree stacked on a leading
# axis (stack_segment_trees) and each (query, shard) pair a row of one
# program, then a merge to the global top-k — the single-device complement
# of the sharded coordinator, with the same merge contract: score desc,
# shard asc, per-shard rank asc (SearchPhaseController.java:398 as one
# top-k over the concatenated per-shard rank lists).
# ---------------------------------------------------------------------------


def _inner_for(spec):
    """The executor of a spec's rows: sparse when it supports_sparse,
    else dense."""
    return _sparse_inner if supports_sparse(spec) else _execute_inner


def _pair_rows(arrays) -> Any:
    """A [Q, S, ...] plan as the [Q * S, ...] rows of its (query, shard)
    pairs, `_groups` included."""
    if isinstance(arrays, dict):
        return {key: _pair_rows(val) for key, val in arrays.items()}
    if isinstance(arrays, (tuple, list)):
        return tuple(_pair_rows(v) for v in arrays)
    # Not reshape(-1, ...): an empty worklist's leaves (and `_groups`)
    # have no elements to infer the row count from.
    return arrays.reshape(arrays.shape[0] * arrays.shape[1], *arrays.shape[2:])


def _shards_inner(seg_stacked, spec, arrays, k: int, docs_per_shard: int,
                  q: int):
    n_shards = _n_shards(seg_stacked)
    if not n_shards:
        raise ValueError("execute_shards needs a stacked segment tree")
    s, i, t = _inner_for(spec)(
        seg_stacked, spec, _pair_rows(arrays), k, q * n_shards
    )
    kk = s.shape[1]
    offsets = torch.arange(n_shards, dtype=torch.int32, device=s.device)
    gids = (
        i.view(q, n_shards, kk) + (offsets * docs_per_shard)[:, None]
    ).reshape(q, n_shards * kk)
    # The flat order is (shard, rank); each shard's ranks already break
    # ties by doc id, so K3's lowest-index tie order is the merge order.
    flat_s = s.reshape(q, n_shards * kk)
    top_s, pos, _ = kernels.masked_topk_batch(
        flat_s, torch.ones_like(flat_s, dtype=torch.bool),
        min(k, n_shards * kk),
    )
    top_ids = torch.gather(gids, 1, pos.to(torch.int64))
    return top_s, top_ids, t.view(q, n_shards).sum(dim=1, dtype=torch.int32)


def execute_shards_batch(seg_stacked, spec, arrays_batched, k: int,
                         docs_per_shard: int, q: int | None = None):
    """Q same-spec queries over S stacked shards ([Q, S, ...] plans, each
    shard's row compiled with that shard's own statistics) in one program.
    Returns (top_scores f32[Q, k'], global ids i32[Q, k'], totals
    i32[Q]): global id = local id + shard * docs_per_shard, totals summed
    over shards."""
    return _shards_inner(seg_stacked, spec, arrays_batched, k,
                         docs_per_shard, _rows(arrays_batched, q))


def execute_shards(seg_stacked, spec, arrays_stacked, k: int,
                   docs_per_shard: int):
    """One query over S stacked shards ([S, ...] plan) -> its global
    top-k: execute_shards_batch over one query."""
    return _unbatch(execute_shards_batch(
        seg_stacked, spec, _rows1(arrays_stacked), k, docs_per_shard, q=1
    ))


# ---------------------------------------------------------------------------
# Strictly sequential chains (row 17): Q plans run one after another on
# one stream, each step's plan depending on the previous step's result,
# so no two queries overlap or batch — the reference's `lax.scan`s whose
# wall time / Q is the unbatched per-query latency (the bench's
# single-query p50). Step q takes row q of every leaf as a view (and row
# q of the host `_groups`), K15 perturbs the plan's top-level leaf by the
# previous step's total times 0.0, read on the device, and the step runs
# the batch-of-one executor. No host read between steps. The
# perturbation is +0.0, so a step equals the per-query kernel bit for bit
# except where the leaf is -0.0 (a -0.0 boost becomes +0.0, as in the
# reference's chain).
# ---------------------------------------------------------------------------


def _chain_perturb(arrays, prev_total):
    """The first of ("boost", "weights") at the plan's top level through
    K15 against the previous step's total (None for the first step): a
    new tensor, the staged plan untouched. A plan with neither (match_none
    compiles to no arrays) passes through unperturbed, as in the
    reference (:1085-1098)."""
    for key in ("boost", "weights"):
        if key in arrays:
            arrays = dict(arrays)
            arrays[key] = kernels.chain_perturb(arrays[key], prev_total)
            break
    return arrays


def _row_of(arrays, r: int) -> Any:
    """Row r of a [Q, ...] plan as a batch of one: every leaf's [r:r + 1]
    view, `_groups` included."""
    if isinstance(arrays, dict):
        return {key: _row_of(val, r) for key, val in arrays.items()}
    if isinstance(arrays, (tuple, list)):
        return tuple(_row_of(v, r) for v in arrays)
    return arrays[r : r + 1]


def _chain(n_steps: int, step):
    """Run step(r, prev_total) for r = 0 .. n_steps - 1, each fed the
    previous step's total tensor; stack the outputs as the scan does:
    (scores f32[Q, k'], ids i32[Q, k'], totals i32[Q])."""
    outs = []
    for r in range(n_steps):
        outs.append(step(r, outs[-1][2] if outs else None))
    return tuple(torch.cat(col) for col in zip(*outs))


def execute_sequential_sparse(seg, spec, arrays_batched, k: int):
    """Run Q same-spec supports_sparse plans ([Q, ...] arrays) STRICTLY
    one after another (the reference's :1058): each step is
    execute_batch_sparse over one row, its plan chained to the previous
    step's total through K15. Returns (scores f32[Q, k'], ids i32[Q, k'],
    totals i32[Q])."""
    return _chain(_rows(arrays_batched, None), lambda r, prev: _sparse_inner(
        seg, spec, _chain_perturb(_row_of(arrays_batched, r), prev), k))


def execute_sequential(seg, spec, arrays_batched, k: int, length=None):
    """Strictly sequential execution of any compiled spec (the
    reference's :1105): each step runs `_inner_for(spec)` (sparse or
    dense) over one row. `length` is the step count of a plan with no
    arrays at all (match_none), as the scan's `length`."""
    return _chain(_rows(arrays_batched, length), lambda r, prev: _inner_for(
        spec)(seg, spec, _chain_perturb(_row_of(arrays_batched, r), prev),
              k, 1))


def execute_shards_sequential(seg_stacked, spec, arrays_batched, k: int,
                              docs_per_shard: int):
    """Strictly sequential execution over S stacked shards ([Q, S, ...]
    plans; the reference's :1171): each step is execute_shards_batch over
    one query (`_shards_inner` at q = 1), chained on its merged total.
    Returns (scores f32[Q, k'], global ids i32[Q, k'], totals i32[Q])."""
    return _chain(_rows(arrays_batched, None), lambda r, prev: _shards_inner(
        seg_stacked, spec, _chain_perturb(_row_of(arrays_batched, r), prev),
        k, docs_per_shard, 1))


def execute_rescore_sequential(seg, spec, arrays_batched, rspec,
                               rarrays_batched, k: int, window: int,
                               query_weight, rescore_weight):
    """Strictly sequential fused rescore (the reference's :1225): each
    step is `_rescore_inner` over one row of the query plans and of the
    rescore plans; only the query plan is chained. Returns (scores
    f32[Q, min(k, W)], ids i32[Q, min(k, W)], totals i32[Q])."""
    return _chain(_rows(arrays_batched, None), lambda r, prev: _rescore_inner(
        seg, spec, _chain_perturb(_row_of(arrays_batched, r), prev), rspec,
        _row_of(rarrays_batched, r), k, window, query_weight, rescore_weight,
        1))


# ---------------------------------------------------------------------------
# Two-launch block-max execution, the block-max WAND analog (reference:
# search/query/TopDocsCollectorContext.java:68). Launch 1 scores each
# query's A highest-upper-bound worklist entries; θ = its k-th partial
# score lower-bounds the final k-th score. The host drops every entry whose
# tile bound plus the other terms' bounds cannot reach θ (with an fp32
# margin) and re-buckets the survivors; launch 2 scores them exactly. Both
# launches go through the batched sparse path (K2/K4/K3, K1 for filters),
# so θ is phase A's k-th fp32 score bit for bit. Top-k ids and scores are
# exact; totals are lower bounds ("gte") when any tile was pruned, so
# serving offers these paths only when totals are untracked.
# ---------------------------------------------------------------------------

# Worklist-entry planes that a phase subset reorders along the tile axis.
_BLOCKMAX_KEYS = ("tile_ids", "starts", "ends", "weights", "ub", "ub_other")


def _launch_numpy(executor, seg, spec, arrays, k: int, *extra):
    """Upload host plan arrays, run `executor`, bring the outputs back."""
    plan = plan_to_torch(spec, arrays, seg["live"].device)
    return tuple(t.cpu().numpy() for t in executor(seg, spec, plan, k, *extra))


def _thetas(scores_a: np.ndarray, k: int, q: int) -> np.ndarray:
    """Each query's k-th phase-A score (-inf for an underfull top-k)."""
    if scores_a.shape[-1] >= k:
        return scores_a[..., k - 1]
    return np.full(q, -np.inf, dtype=np.float32)


def _margin(thetas: np.ndarray) -> np.ndarray:
    return thetas.astype(np.float32) * np.float32(1 - 1e-6) - np.float32(1e-6)


def _rebucket(keep: np.ndarray):
    """(survivor counts, pow-2 bucket, stable front order) of a keep mask
    over the trailing tile axis; the order keeps survivors in worklist
    order (the exact left fold of launch 2 needs it)."""
    counts = keep.sum(axis=-1)
    nt_b = 1 << (max(1, int(counts.max())) - 1).bit_length()
    front = np.argsort(~keep, axis=-1, kind="stable")[..., :nt_b]
    return counts, nt_b, front


def _empty_pads(arrays: dict, counts: np.ndarray, nt_b: int) -> None:
    """Entries past each row's survivor count are padding: an empty span
    never validates, and the kept tile id keeps gathers in range."""
    pad = np.arange(nt_b) >= counts[..., None]
    arrays["starts"] = np.where(pad, 0, arrays["starts"])
    arrays["ends"] = np.where(pad, 0, arrays["ends"])


def execute_batch_blockmax(seg, spec, arrays_list, k: int, instruments=None):
    """Two-launch thresholded batch over one segment for a terms spec.

    `arrays_list` holds Q host plans (numpy). Returns (scores [Q, k'],
    ids [Q, k'], totals [Q], relation) as numpy, with relation "gte"
    when any pruning occurred, else "eq". `instruments`, if given, gets
    `blockmax_pruned(fraction)` per query."""
    nt = spec[2]
    kind, field_name, _, t_pad = spec
    a_bucket = max(8, nt // 4)
    stacked = {
        name: np.stack([a[name] for a in arrays_list])
        for name in _BLOCKMAX_KEYS
    }
    if a_bucket >= nt:  # tiny worklists: one launch, exact totals
        s, i, t = _launch_numpy(execute_batch_sparse, seg, spec, stacked, k)
        return s, i, t, "eq"
    # Launch 1 over each query's top-UB subset (reordering is safe: phase-A
    # scores are only lower bounds).
    spec_a = (kind, field_name, a_bucket, t_pad)
    order = np.argsort(-stacked["ub"], axis=1, kind="stable")[:, :a_bucket]
    arrays_a = {
        name: np.take_along_axis(stacked[name], order, axis=1)
        for name in stacked
    }
    scores_a, _, _ = _launch_numpy(execute_batch_sparse, seg, spec_a,
                                   arrays_a, k)
    thetas = _thetas(scores_a, k, len(arrays_list))
    keep = (stacked["ub"] + stacked["ub_other"]) >= _margin(thetas)[:, None]
    keep |= ~np.isfinite(thetas)[:, None]  # underfull top-k: keep all
    counts, nt_b, front = _rebucket(keep)
    if instruments is not None:
        for c in counts:
            instruments.blockmax_pruned(1.0 - float(c) / nt)
    arrays_b = {
        name: np.take_along_axis(stacked[name], front, axis=1)
        for name in stacked
    }
    _empty_pads(arrays_b, counts, nt_b)
    s, i, t = _launch_numpy(execute_batch_sparse, seg,
                            (kind, field_name, nt_b, t_pad), arrays_b, k)
    return s, i, t, ("gte" if bool((counts < nt).any()) else "eq")


def supports_blockmax_conj(spec) -> bool:
    """Two-phase pruned execution applies to the must-driven sparse
    conjunction: a scored terms must (whose worklist carries block-max
    upper bounds) with constant filters/exclusions and the default lead
    (-1; a filter-led fold has no sort worth pruning)."""
    return (
        isinstance(spec, tuple)
        and bool(spec)
        and spec[0] == "bool"
        and supports_sparse(spec)
        and _bool_lead(spec) == -1
        and bool(spec[1])
        and spec[1][0][0] == "terms"
    )


def _with_must_nt(spec, nt: int):
    """The bool spec with its single must child re-bucketed to nt."""
    must_spec = spec[1][0]
    return ("bool", ((must_spec[0], must_spec[1], nt, must_spec[3]),),
            *spec[2:])


def _subset_must_child(child: dict, order: np.ndarray) -> dict:
    """Reorder/subset the must child's worklist planes along the tile axis
    (the trailing axis of `order`); per-term planes pass through."""
    out = dict(child)
    for name in _BLOCKMAX_KEYS:
        if name in out:
            out[name] = np.take_along_axis(out[name], order, axis=-1)
    return out


def _blockmax_conj(run, spec, arrays_list, k: int, instruments, pruned_of):
    """The two launches of a must-driven conjunction around the host
    prune, over one segment ([Q, nt] must worklists) or S stacked shards
    ([Q, S, nt]). `run(spec, arrays)` launches; `pruned_of(counts row)`
    is a query's pruned count."""
    nt = spec[1][0][2]
    stacked = stack_plans(arrays_list)
    a_bucket = max(8, nt // 4)
    if a_bucket >= nt:  # tiny worklists: one launch, exact totals
        return (*run(spec, stacked), "eq")
    child0 = stacked["children"][0]
    ub, ub_other = child0["ub"], child0["ub_other"]
    q = ub.shape[0]
    order = np.argsort(-ub, axis=-1, kind="stable")[..., :a_bucket]
    arrays_a = {**stacked, "children": (
        _subset_must_child(child0, order), *stacked["children"][1:])}
    scores_a, _, _ = run(_with_must_nt(spec, a_bucket), arrays_a)
    thetas = _thetas(scores_a, k, q)
    # θ is in the bool's boosted score space, the bounds in term-weight
    # space: scale the bounds by the query's boost (uniform across
    # shards); a non-positive boost disables pruning.
    boost = np.asarray(stacked["boost"], dtype=np.float32).reshape(q, -1)[:, 0]
    extra = (1,) * (ub.ndim - 1)
    keep = (ub + ub_other) * boost.reshape(q, *extra) >= _margin(
        thetas).reshape(q, *extra)
    keep |= (~np.isfinite(thetas)).reshape(q, *extra)
    keep |= (boost <= 0).reshape(q, *extra)
    counts, nt_b, front = _rebucket(keep)
    if instruments is not None:
        for row in counts:
            instruments.blockmax_pruned(1.0 - pruned_of(row) / nt)
    child_b = _subset_must_child(child0, front)
    _empty_pads(child_b, counts, nt_b)
    arrays_b = {**stacked, "children": (child_b, *stacked["children"][1:])}
    s, i, t = run(_with_must_nt(spec, nt_b), arrays_b)
    return s, i, t, ("gte" if bool((counts < nt).any()) else "eq")


def execute_batch_blockmax_conj(seg, spec, arrays_list, k: int,
                                instruments=None):
    """Two-launch thresholded conjunction batch over one segment, for a
    spec that supports_blockmax_conj. Returns (scores [Q, k'], ids
    [Q, k'], totals [Q], relation) as numpy."""
    return _blockmax_conj(
        lambda sp, arr: _launch_numpy(execute_batch_sparse, seg, sp, arr, k),
        spec, arrays_list, k, instruments, float,
    )


def execute_shards_blockmax_conj(seg_stacked, spec, arrays_list, k: int,
                                 docs_per_shard: int, instruments=None):
    """Two-launch thresholded conjunction batch over S stacked shards.

    `arrays_list` holds per-query host plans with [S, ...] leaves. θ comes
    from each query's MERGED phase-A top-k, so one shard's strong
    candidates prune other shards' hopeless tiles too. Returns (scores
    [Q, k'], global ids [Q, k'], totals [Q], relation) as numpy."""
    return _blockmax_conj(
        lambda sp, arr: _launch_numpy(execute_shards_batch, seg_stacked, sp,
                                      arr, k, docs_per_shard),
        spec, arrays_list, k, instruments, lambda row: float(row.mean()),
    )
