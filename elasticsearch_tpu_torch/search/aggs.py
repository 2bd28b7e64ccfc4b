"""Aggregations: request parsing, per-segment planning, reduce, rendering.

Port of elasticsearch_tpu/search/aggs.py, trimmed to this slice. Kept as
the reference has them: `AggNode`, `AggParsingError`,
`TooManyBucketsError`, `parse_aggs` and `_validate` (its parse errors
with the reference's 400 reasons), the `Aggregator` (`compile_for`,
`_compile_node`, `_compile_subs`, `_compile_histogram` with a fixed
`interval`, `_fixed_hist_plan`, `run`, `render_states`, `run_states`),
`new_merge_state`, `_merge_bucket_planes`, `_host_values`,
`_fold_metric_values`, `merge_segment_result`, `_render_metric`,
`_sub_bucket_rendering`, `_render_array_sub`, `render` and
`_render_histogram`. The kinds served: the metrics `min`, `max`, `sum`,
`avg`, `value_count` and `stats` (top level, under the filter family, and
as sub-aggregations of the bucket kinds), `terms` over keyword fields
(size, order, min_doc_count, `sum_other_doc_count`), `histogram` (fixed
interval, offset, min_doc_count), `range`, `filter`, `filters` (keyed
and list), `global` and `missing`.

Left out (ROADMAP queue A): `significant_terms`, `rare_terms`,
`cardinality`, `top_hits`, `composite`, `matrix_stats`, the host metric
kinds (`percentiles`, `percentile_ranks`, `extended_stats`,
`median_absolute_deviation`), `date_histogram`, `terms` over a numeric
field (the reference's host fallback), and the mesh (`merge_mesh_result`)
and wire (`state_to_wire` onward) reduces. A request naming a left-out
kind gets the reference's 400 where the reference refuses the body too,
else `unknown aggregation type [kind]` (a 400).

Per segment, one device pass (ops/aggs_device.execute_aggs) evaluates the
query once and every aggregation off its matched mask; the cross-segment
(and cross-shard) merge by bucket key and the rendering run here on the
host, as in the reference. Metrics fold on the host in float64 from the
matched mask, segment by segment in handle order (`_fold_metric_values`,
the reference's double reduce); the per-bucket sub-metric planes come
from the device in f32 (K10) and merge in float64 across segments.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

METRIC_KINDS = {"min", "max", "sum", "avg", "value_count", "stats"}
# The reference's host-only metric kinds and bucket hosts, kept for its
# validation rules; this port serves SERVED_KINDS only.
HOST_METRIC_KINDS = {
    "percentiles", "percentile_ranks", "extended_stats",
    "median_absolute_deviation",
}
BUCKET_METRIC_HOSTS = {
    "terms", "significant_terms", "rare_terms", "histogram",
    "date_histogram", "range",
}
NESTING_KINDS = {"filter", "filters", "global", "missing"}
# The kinds this port serves; the reference's other kinds are refused.
SERVED_KINDS = METRIC_KINDS | {"terms", "histogram", "range"} | NESTING_KINDS
MAX_BUCKETS = 65536  # ES search.max_buckets default


class AggParsingError(ValueError):
    """400 aggregation_execution_exception / parsing error."""


class TooManyBucketsError(ValueError):
    """ES too_many_buckets_exception (search.max_buckets breaker)."""


@dataclass
class AggNode:
    name: str
    kind: str
    params: dict[str, Any]
    subs: list["AggNode"] = dc_field(default_factory=list)


def parse_aggs(body: dict[str, Any]) -> list[AggNode]:
    """Parse an ES `"aggs"`/`"aggregations"` object into AggNode trees:
    the reference's checks over the whole tree first (so a body it refuses
    gets its reason), then a kind this port does not serve, anywhere in
    the tree, is an unknown aggregation type."""
    nodes = _parse_tree(body)
    _refuse_unserved(nodes)
    return nodes


def _refuse_unserved(nodes: list[AggNode]) -> None:
    for node in nodes:
        if node.kind not in SERVED_KINDS:
            raise AggParsingError(f"unknown aggregation type [{node.kind}]")
        _refuse_unserved(node.subs)


def _parse_tree(body: dict[str, Any]) -> list[AggNode]:
    nodes = []
    for name, spec in body.items():
        if not isinstance(spec, dict):
            raise AggParsingError(f"aggregation [{name}] must be an object")
        sub_body = None
        kind = None
        params: dict[str, Any] = {}
        for key, val in spec.items():
            if key in ("aggs", "aggregations"):
                sub_body = val
            elif kind is None:
                kind, params = key, val if isinstance(val, dict) else {}
            else:
                raise AggParsingError(
                    f"aggregation [{name}] declares multiple types "
                    f"[{kind}] and [{key}]"
                )
        if kind is None:
            raise AggParsingError(f"aggregation [{name}] has no type")
        node = AggNode(name=name, kind=kind, params=dict(params))
        if sub_body:
            node.subs = _parse_tree(sub_body)
        _validate(node)
        nodes.append(node)
    return nodes


def _validate(node: AggNode) -> None:
    """The reference's checks, with its 400 reasons (leaving out its
    `composite` source checks: parse_aggs refuses the kind)."""
    k = node.kind
    known = (
        METRIC_KINDS
        | HOST_METRIC_KINDS
        | BUCKET_METRIC_HOSTS
        | NESTING_KINDS
        | {"cardinality", "top_hits", "composite", "matrix_stats"}
    )
    if k not in known:
        raise AggParsingError(f"unknown aggregation type [{k}]")
    if (
        k in METRIC_KINDS | HOST_METRIC_KINDS | {"cardinality", "top_hits"}
        and node.subs
    ):
        raise AggParsingError(
            f"metric aggregation [{node.name}] cannot hold sub-aggregations"
        )
    if k in BUCKET_METRIC_HOSTS:
        for sub in node.subs:
            if sub.kind not in METRIC_KINDS | {"top_hits"}:
                raise AggParsingError(
                    f"[{node.name}] supports metric and top_hits "
                    f"sub-aggregations only; [{sub.name}] is [{sub.kind}] "
                    f"(wrap it in a filter aggregation for bucket-in-bucket "
                    f"nesting)"
                )
    for sub in node.subs:
        if sub.kind == "composite":
            raise AggParsingError(
                "[composite] aggregation cannot be used with a parent "
                "aggregation"
            )
    if k != "global" and k != "filters" and k != "filter":
        if (
            k
            in METRIC_KINDS
            | HOST_METRIC_KINDS
            | {"cardinality", "missing"}
            | BUCKET_METRIC_HOSTS
        ):
            if "field" not in node.params:
                raise AggParsingError(
                    f"aggregation [{node.name}] of type [{k}] requires [field]"
                )
    if k == "matrix_stats":
        if not node.params.get("fields"):
            raise AggParsingError(
                f"matrix_stats [{node.name}] requires [fields]"
            )
    if k == "percentile_ranks" and not node.params.get("values"):
        raise AggParsingError(
            f"percentile_ranks [{node.name}] requires [values]"
        )


def _pow2(n: int, minimum: int = 1) -> int:
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


class Aggregator:
    """Plans, executes (per segment), reduces, and renders one request's aggs.

    Construction plans against the engine's current segments (or the
    caller's pinned `handles`, shared with the hits pass): histogram
    bases and bucket counts come from global column ranges, so every
    segment's result arrays align for the reduce."""

    def __init__(self, engine, nodes: list[AggNode], handles=None):
        self.engine = engine
        self.nodes = nodes
        segments = engine.segments if handles is None else handles
        self.handles = [h for h in segments if h.segment.num_docs > 0]
        # Per-request plan state, keyed by id(node) — names are not unique
        # across nesting levels.
        self._plan: dict[str, Any] = {}
        self._range_cache: dict[str, tuple[float, float]] = {}

    def _field_range(self, fname: str) -> tuple[float, float]:
        """Global [min, max] of a numeric column over the planned segments
        (host columns are float64; quantized to f32 = stored-value
        semantics)."""
        cached = self._range_cache.get(fname)
        if cached is not None:
            return cached
        lo, hi = np.inf, -np.inf
        for h in self.handles:
            col = h.segment.doc_values.get(fname)
            if col is None or not len(col) or np.all(np.isnan(col)):
                continue
            lo = min(lo, float(np.float32(np.nanmin(col))))
            hi = max(hi, float(np.float32(np.nanmax(col))))
        if not np.isfinite(lo):
            lo, hi = 0.0, 0.0
        self._range_cache[fname] = (lo, hi)
        return lo, hi

    def _term_pad(self, handle, fname: str) -> int:
        """Ordinal scatter width for a keyword field: the handle's own
        pow2 vocabulary bucket."""
        return _pow2(handle.device.fields[fname].num_terms)

    # ----------------------------------------------------------- compile

    def compile_for(self, handle, compiler) -> tuple[tuple, tuple]:
        """(aggs_spec, aggs_arrays) for one segment."""
        specs, arrays = [], []
        for node in self.nodes:
            s, a = self._compile_node(node, handle, compiler)
            specs.append(s)
            arrays.append(a)
        return tuple(specs), tuple(arrays)

    def _field_kind(self, handle, fname: str) -> str:
        if fname in handle.device.fields:
            return "inverted"
        if fname in handle.device.doc_values:
            return "numeric"
        return "none"

    def _keyword_ok(self, handle, fname: str) -> bool:
        f = handle.device.fields.get(fname)
        return f is not None and f.ord_terms is not None

    def _is_text(self, handle, fname: str) -> bool:
        """Field indexed with norms (text) in this segment — aggs reject it
        the way the reference rejects text fields without fielddata."""
        f = handle.device.fields.get(fname)
        return f is not None and f.has_norms

    def _require_numeric(self, fname: str) -> None:
        """Numeric-valued agg positions (metrics, histogram, range,
        sub-metrics) 400 on a mapped non-numeric field; unmapped fields
        stay permissive (empty result)."""
        fm = self.engine.mappings.get(fname)
        if fm is not None and not fm.is_numeric:
            raise AggParsingError(
                f"field [{fname}] of type [{fm.type}] is not supported "
                f"for numeric aggregations"
            )

    def _sub_fields(self, node: AggNode, handle) -> tuple:
        """Sub-metric fields present in this segment's doc values (a
        segment without the field contributes nothing to it)."""
        out = []
        for f in sorted(
            {s.params["field"] for s in node.subs if s.kind in METRIC_KINDS}
        ):
            self._require_numeric(f)
            if f in handle.device.doc_values:
                out.append(f)
        return tuple(out)

    def _compile_node(self, node: AggNode, handle, compiler):
        k = node.kind
        p = node.params
        if k in METRIC_KINDS:
            # Metrics reduce on the HOST in float64 from the device's
            # matched mask and the segment's f64 columns (the reference
            # accumulates in double, InternalSum.java:22).
            self._require_numeric(p["field"])
            return ("matched",), {}
        if k == "terms":
            fname = p["field"]
            if self._keyword_ok(handle, fname):
                tp = self._term_pad(handle, fname)
                return ("terms", fname, tp, self._sub_fields(node, handle)), {}
            if self._is_text(handle, fname):
                raise AggParsingError(
                    f"cannot run terms aggregation on field [{fname}]: text "
                    f"fields need keyword doc values (use a keyword field)"
                )
            if self._field_kind(handle, fname) == "numeric":
                if node.subs:
                    raise AggParsingError(
                        "sub-aggregations under a numeric terms "
                        "aggregation are not supported yet"
                    )
                raise AggParsingError(
                    f"terms aggregation over numeric field [{fname}] is not "
                    f"supported yet"
                )
            # a keyword field absent from this segment contributes nothing
            return ("matched",), {}
        if k == "histogram":
            return self._compile_histogram(node, handle)
        if k == "range":
            fname = p["field"]
            raw = p.get("ranges")
            if not raw:
                raise AggParsingError(
                    f"range aggregation [{node.name}] requires [ranges]"
                )
            self._require_numeric(fname)
            if fname not in handle.device.doc_values:
                return ("empty_buckets", len(raw)), {}
            los = np.asarray(
                [np.float32(r.get("from", -np.inf)) for r in raw],
                dtype=np.float32,
            )
            his = np.asarray(
                [np.float32(r.get("to", np.inf)) for r in raw],
                dtype=np.float32,
            )
            spec = ("range", fname, len(raw), self._sub_fields(node, handle))
            return spec, {"los": los, "his": his}
        if k == "filter":
            compiled = compiler.compile(_parse_query(p))
            sub_s, sub_a = self._compile_subs(node, handle, compiler)
            return ("filter", compiled.spec, sub_s), {
                "query": compiled.arrays,
                "subs": sub_a,
            }
        if k == "filters":
            _keys, queries = _filters_defs(node)
            compiled = [
                compiler.compile(_parse_query({"filter": q})) for q in queries
            ]
            sub_s, sub_a = self._compile_subs(node, handle, compiler)
            return (
                "filters",
                tuple(c.spec for c in compiled),
                sub_s,
            ), {"queries": tuple(c.arrays for c in compiled), "subs": sub_a}
        if k == "global":
            sub_s, sub_a = self._compile_subs(node, handle, compiler)
            return ("global", sub_s), {"subs": sub_a}
        if k == "missing":
            fname = p["field"]
            # "none" (unmapped or absent from this segment): every matched
            # doc counts as missing.
            fkind = self._field_kind(handle, fname)
            sub_s, sub_a = self._compile_subs(node, handle, compiler)
            return ("missing", fname, fkind, sub_s), {"subs": sub_a}
        raise AggParsingError(f"unknown aggregation type [{k}]")

    def _compile_subs(self, node: AggNode, handle, compiler):
        specs, arrays = [], []
        for sub in node.subs:
            s, a = self._compile_node(sub, handle, compiler)
            specs.append(s)
            arrays.append(a)
        return tuple(specs), tuple(arrays)

    def _compile_histogram(self, node: AggNode, handle):
        p = node.params
        fname = p["field"]
        self._require_numeric(fname)
        interval = p.get("interval")
        if interval is None or float(interval) <= 0:
            raise AggParsingError(
                f"[interval] must be a positive decimal in [{node.name}]"
            )
        offset, base, nb, nb_pad = self._fixed_hist_plan(node, float(interval))
        if fname not in handle.device.doc_values:
            # Keep the bucket-array shape of the segments that do carry
            # the column, so the cross-segment merge aligns.
            return ("empty_buckets", max(nb_pad, 1)), {}
        spec = ("histogram", fname, nb_pad, self._sub_fields(node, handle))
        arrays = {
            "interval": np.float32(interval),
            "offset": np.float32(offset),
            "base": np.float32(base),
        }
        return spec, arrays

    def _fixed_hist_plan(
        self, node: AggNode, interval: float
    ) -> tuple[float, float, int, int]:
        """(offset, base, nb, nb_pad) for a fixed-interval histogram; the
        bucket window derives from the GLOBAL column range so every
        segment's result arrays align for the reduce. Also records the
        render-time plan entry."""
        offset = float(node.params.get("offset", 0.0))
        lo, hi = self._field_range(node.params["field"])
        base = float(np.floor((lo - offset) / interval))
        last = float(np.floor((hi - offset) / interval))
        nb = int(last - base) + 1 if hi >= lo else 1
        if nb > MAX_BUCKETS:
            raise TooManyBucketsError(
                f"Trying to create too many buckets. Must be less than or "
                f"equal to: [{MAX_BUCKETS}] but was [{nb}]"
            )
        self._plan.setdefault("hist_params", {})[id(node)] = (
            interval,
            offset,
            base,
        )
        return offset, base, nb, _pow2(nb)

    # ----------------------------------------------------------- execute

    def run(self, query, stats=None) -> tuple[int, dict[str, Any]]:
        """Execute over every segment; returns (total_hits, rendered aggs)."""
        total, states = self.run_states(query, stats=stats)
        return total, self.render_states(states)

    def render_states(self, states) -> dict[str, Any]:
        """Render merged states to the ES response shape."""
        return {
            node.name: render(node, state, self.engine, self._plan)
            for node, state in zip(self.nodes, states)
        }

    def run_states(self, query, stats=None) -> tuple[int, list]:
        """Execute over every segment; returns (total_hits, merge states).

        One device pass per segment evaluates the query once and every
        aggregation off the shared matched mask (the reference's
        MultiBucketCollector single collection pass); the cross-segment
        merge happens here on the host. `stats` lets the caller share the
        statistics scope of the hits pass (the coordinator's global
        statistics on N shards)."""
        from ..ops import aggs_device

        if stats is None:
            stats = self.engine.field_stats()
        states = [new_merge_state(n) for n in self.nodes]
        total = 0
        for handle in self.handles:
            compiler = self.engine.compiler_for(handle, stats)
            compiled = compiler.compile(query)
            specs, arrays = self.compile_for(handle, compiler)
            seg_tree = aggs_device.agg_segment_tree(handle.device)
            tot, results = aggs_device.execute_aggs(
                seg_tree, compiled.spec, compiled.arrays, specs, arrays
            )
            total += int(tot)
            results = _to_host(results)
            for node, state, result in zip(self.nodes, states, results):
                merge_segment_result(node, state, result, handle)
        return total, states


def _to_host(tree):
    """A device result tree as numpy leaves."""
    if isinstance(tree, dict):
        return {key: _to_host(val) for key, val in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_host(v) for v in tree)
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _filters_defs(node: AggNode) -> tuple[list[str] | None, list[dict]]:
    """(keys, query bodies) of a filters agg; keys None for the list form."""
    raw = node.params.get("filters")
    if isinstance(raw, dict):
        keys = sorted(raw)
        return keys, [raw[key] for key in keys]
    if isinstance(raw, list):
        return None, raw
    raise AggParsingError(
        f"filters aggregation [{node.name}] requires [filters]"
    )


def _parse_query(params: dict) -> Any:
    """Parse the query body of a filter agg ({"filter": {...}} wrapper or
    the bare query object of the `filter` agg itself)."""
    from ..query.dsl import parse_query

    body = params.get("filter", params)
    return parse_query(body)


# ---------------------------------------------------------------- reduce


def new_merge_state(node: AggNode) -> dict[str, Any]:
    k = node.kind
    if k in METRIC_KINDS:
        return {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf}
    if k == "terms":
        return {"counts": {}, "subs": {}}
    if k in ("histogram", "range"):
        return {"counts": None, "subs": {}}
    if k in ("filter", "global", "missing"):
        return {
            "doc_count": 0,
            "subs": [new_merge_state(s) for s in node.subs],
        }
    if k == "filters":
        return {"buckets": None}
    raise AggParsingError(f"unknown aggregation type [{k}]")


def _merge_bucket_planes(tgt: dict, planes, keys):
    """Merge per-bucket metric planes into key->plane dicts."""
    counts = np.asarray(planes["count"])
    sums = np.asarray(planes["sum"])
    mins = np.asarray(planes["min"])
    maxs = np.asarray(planes["max"])
    for i, key in enumerate(keys):
        if key is None:
            continue
        cur = tgt.setdefault(
            key, {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf}
        )
        cur["count"] += int(counts[i])
        cur["sum"] += float(sums[i])
        cur["min"] = min(cur["min"], float(mins[i]))
        cur["max"] = max(cur["max"], float(maxs[i]))


def _host_values(result, handle, fname: str) -> np.ndarray:
    """Matched docs' non-NaN values from the host float64 column."""
    col = handle.segment.doc_values.get(fname)
    if col is None:
        return np.zeros(0, dtype=np.float64)
    mask = np.asarray(result["mask"])[: len(col)]
    vals = col[mask]
    return vals[~np.isnan(vals)]


def _fold_metric_values(state, vals: np.ndarray) -> None:
    """Fold one segment's matched f64 values into a metric merge state,
    segment by segment in handle order (the reference's fold)."""
    state["count"] += len(vals)
    if len(vals):
        state["sum"] += float(np.sum(vals))
        state["min"] = min(state["min"], float(np.min(vals)))
        state["max"] = max(state["max"], float(np.max(vals)))


def merge_segment_result(node: AggNode, state, result, handle) -> None:
    """Fold one segment's device result into the cross-segment state."""
    k = node.kind
    if k in METRIC_KINDS:
        # f64-exact host reduce over the matched mask (the device f32 sum
        # plane drifts user-visibly at 1M+ docs; InternalSum.java:22).
        _fold_metric_values(
            state, _host_values(result, handle, node.params["field"])
        )
        return
    if k == "terms":
        fname = node.params["field"]
        dfield = handle.device.fields.get(fname)
        if dfield is None or dfield.ord_terms is None:
            return  # a keyword field absent from this segment
        vocab = list(dfield.terms.keys())
        counts = np.asarray(result["counts"])
        nz = np.flatnonzero(counts[: len(vocab)])
        for i in nz:
            key = vocab[i]
            state["counts"][key] = state["counts"].get(key, 0) + int(counts[i])
        if node.subs and "subs" in result:
            keys = [
                vocab[i] if counts[i] > 0 else None
                for i in range(len(vocab))
            ]
            for f, planes in result["subs"].items():
                trimmed = {
                    name: np.asarray(arr)[: len(vocab)]
                    for name, arr in planes.items()
                }
                _merge_bucket_planes(
                    state["subs"].setdefault(f, {}), trimmed, keys
                )
        return
    if k in ("histogram", "range"):
        counts = np.asarray(result["counts"]).astype(np.int64)
        if state["counts"] is None:
            state["counts"] = counts.copy()
        else:
            state["counts"] += counts
        if node.subs and "subs" in result:
            for f, planes in result["subs"].items():
                cur = state["subs"].get(f)
                planes = {k2: np.asarray(v) for k2, v in planes.items()}
                if cur is None:
                    state["subs"][f] = {
                        "count": planes["count"].astype(np.int64),
                        "sum": planes["sum"].astype(np.float64),
                        "min": planes["min"].copy(),
                        "max": planes["max"].copy(),
                    }
                else:
                    cur["count"] += planes["count"]
                    cur["sum"] += planes["sum"]
                    cur["min"] = np.minimum(cur["min"], planes["min"])
                    cur["max"] = np.maximum(cur["max"], planes["max"])
        return
    if k in ("filter", "global", "missing"):
        state["doc_count"] += int(result["doc_count"])
        for sub_node, sub_state, sub_result in zip(
            node.subs, state["subs"], result["subs"]
        ):
            merge_segment_result(sub_node, sub_state, sub_result, handle)
        return
    if k == "filters":
        if state["buckets"] is None:
            state["buckets"] = [
                {
                    "doc_count": 0,
                    "subs": [new_merge_state(s) for s in node.subs],
                }
                for _ in result
            ]
        for bstate, bresult in zip(state["buckets"], result):
            bstate["doc_count"] += int(bresult["doc_count"])
            for sub_node, sub_state, sub_result in zip(
                node.subs, bstate["subs"], bresult["subs"]
            ):
                merge_segment_result(sub_node, sub_state, sub_result, handle)
        return
    raise AggParsingError(f"unknown aggregation type [{k}]")


# ---------------------------------------------------------------- render


def _render_metric(kind: str, state) -> dict[str, Any]:
    count = state["count"]
    if kind == "value_count":
        return {"value": count}
    if kind == "sum":
        return {"value": float(state["sum"])}
    if kind == "min":
        return {"value": float(state["min"]) if count else None}
    if kind == "max":
        return {"value": float(state["max"]) if count else None}
    if kind == "avg":
        return {"value": float(state["sum"]) / count if count else None}
    if kind == "stats":
        return {
            "count": count,
            "min": float(state["min"]) if count else None,
            "max": float(state["max"]) if count else None,
            "avg": float(state["sum"]) / count if count else None,
            "sum": float(state["sum"]),
        }
    raise AggParsingError(f"unknown metric [{kind}]")


def _sub_bucket_rendering(node: AggNode, key, sub_planes_by_field):
    out = {}
    for sub in node.subs:
        f = sub.params["field"]
        planes = sub_planes_by_field.get(f, {}).get(
            key, {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf}
        )
        out[sub.name] = _render_metric(sub.kind, planes)
    return out


def _render_array_sub(node: AggNode, idx: int, state) -> dict[str, Any]:
    out = {}
    for sub in node.subs:
        f = sub.params["field"]
        planes = state["subs"].get(f)
        if planes is None:
            p = {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf}
        else:
            p = {
                "count": int(planes["count"][idx]),
                "sum": float(planes["sum"][idx]),
                "min": float(planes["min"][idx]),
                "max": float(planes["max"][idx]),
            }
        out[sub.name] = _render_metric(sub.kind, p)
    return out


def _key_for_field(engine, fname: str, value: float):
    """Render a numeric bucket key with the field's type (int for longs)."""
    fm = engine.mappings.get(fname)
    if fm is not None and fm.type in ("long", "integer", "short", "byte"):
        return int(value)
    return float(value)


def render(node: AggNode, state, engine, plan: dict) -> dict[str, Any]:
    k = node.kind
    if k in METRIC_KINDS:
        return _render_metric(k, state)
    if k == "terms":
        size = int(node.params.get("size", 10))
        order = node.params.get("order", {"_count": "desc"})
        items = list(state["counts"].items())
        min_doc_count = int(node.params.get("min_doc_count", 1))
        items = [it for it in items if it[1] >= min_doc_count]
        ((order_key, order_dir),) = (
            order.items() if isinstance(order, dict) else [("_count", "desc")]
        )
        reverse = str(order_dir) == "desc"
        if order_key == "_key":
            items.sort(key=lambda kv: kv[0], reverse=reverse)
        else:  # _count order; key asc tiebreak like the reference
            items.sort(key=lambda kv: (-kv[1], kv[0]) if reverse else (kv[1], kv[0]))
        total = sum(state["counts"].values())
        top = items[:size]
        buckets = []
        for key, count in top:
            b = {"key": key, "doc_count": count}
            if node.subs:
                b.update(_sub_bucket_rendering(node, key, state["subs"]))
            buckets.append(b)
        return {
            "doc_count_error_upper_bound": 0,  # exact: full per-segment counts
            "sum_other_doc_count": total - sum(c for _, c in top),
            "buckets": buckets,
        }
    if k == "histogram":
        return _render_histogram(node, state, engine, plan)
    if k == "range":
        raw = node.params.get("ranges", [])
        counts = state["counts"]
        buckets = []
        for i, r in enumerate(raw):
            frm, to = r.get("from"), r.get("to")
            if "key" in r:
                key = r["key"]
            else:
                key = f"{_fmt_edge(frm)}-{_fmt_edge(to)}"
            b: dict[str, Any] = {"key": key}
            if frm is not None:
                b["from"] = float(frm)
            if to is not None:
                b["to"] = float(to)
            b["doc_count"] = int(counts[i]) if counts is not None else 0
            if node.subs:
                b.update(_render_array_sub(node, i, state))
            buckets.append(b)
        return {"buckets": buckets}
    if k == "filter" or k == "missing" or k == "global":
        out = {"doc_count": state["doc_count"]}
        for sub_node, sub_state in zip(node.subs, state["subs"]):
            out[sub_node.name] = render(sub_node, sub_state, engine, plan)
        return out
    if k == "filters":
        keys, queries = _filters_defs(node)
        bucket_states = state["buckets"]
        if bucket_states is None:  # no non-empty segments: zero buckets
            bucket_states = [
                {"doc_count": 0, "subs": [new_merge_state(s) for s in node.subs]}
                for _ in queries
            ]
        rendered = []
        for bstate in bucket_states:
            out = {"doc_count": bstate["doc_count"]}
            for sub_node, sub_state in zip(node.subs, bstate["subs"]):
                out[sub_node.name] = render(sub_node, sub_state, engine, plan)
            rendered.append(out)
        if keys is not None:
            return {"buckets": dict(zip(keys, rendered))}
        return {"buckets": rendered}
    raise AggParsingError(f"unknown aggregation type [{k}]")


def _fmt_edge(v) -> str:
    return "*" if v is None else str(float(v))


def _render_histogram(node: AggNode, state, engine, plan) -> dict[str, Any]:
    fname = node.params["field"]
    min_doc_count = int(node.params.get("min_doc_count", 0))
    params = plan.get("hist_params", {}).get(id(node))
    if params is None:  # no non-empty segments: nothing was planned
        return {"buckets": []}
    interval, offset, base = params
    counts = state["counts"]
    if counts is None:
        counts = np.zeros(0, dtype=np.int64)
    buckets = []
    for i in range(len(counts)):
        key = (base + i) * interval + offset
        buckets.append((key, int(counts[i]), i))
    # ES trims to [first, last] bucket with >= max(1, min_doc_count) docs,
    # keeping interior empties when min_doc_count == 0.
    occupied = [i for i, (_, c, _) in enumerate(buckets) if c > 0]
    if not occupied:
        return {"buckets": []}
    lo_i, hi_i = occupied[0], occupied[-1]
    out = []
    for key, count, idx in buckets[lo_i : hi_i + 1]:
        if count < min_doc_count:
            continue
        b: dict[str, Any] = {}
        b["key"] = _key_for_field(engine, fname, key) if float(
            key
        ).is_integer() else float(key)
        b["doc_count"] = count
        if node.subs:
            b.update(_render_array_sub(node, idx, state))
        out.append(b)
    return {"buckets": out}
