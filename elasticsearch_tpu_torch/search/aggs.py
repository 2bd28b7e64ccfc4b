"""Aggregations: request parsing, per-segment planning, reduce, rendering.

Port of elasticsearch_tpu/search/aggs.py. Kept as the reference has them:
`parse_aggs`, `_validate` and `_validate_composite` (with their 400
reasons), the `Aggregator` (`compile_for`, `_compile_node` for every
kind, `_compile_histogram` with `_fixed_hist_plan`,
`_histogram_interval` and `_calendar_edges`, `_has_top_hits`,
`_want_mask`, `run`, `render_states`, `run_states`), the merge
(`new_merge_state`, `merge_segment_result`, `_fold_metric_values`,
`_fold_chunk_values`, `_capture_hits_planes`, `_keyword_ords`,
`_merge_composite`, `_merge_matrix_stats`) and the rendering (`render`,
`_render_histogram` with date keys and `key_as_string`,
`_render_percentiles`, `_render_percentile_ranks`,
`_render_extended_stats`, `_render_top_hits`, `_render_composite`,
`_render_matrix_stats`, `_render_significant_terms` with `_sig_score`,
and the top_hits membership predicates). Served: the metrics `min`,
`max`, `sum`, `avg`, `value_count`, `stats`, `extended_stats`,
`percentiles`, `percentile_ranks`, `median_absolute_deviation`,
`cardinality`, `matrix_stats` and `top_hits`; the buckets `terms`
(keyword, and numeric and boolean over the host columns), `rare_terms`,
`significant_terms` (jlh, chi_square, percentage), `histogram`,
`date_histogram` (fixed and calendar intervals), `range`, `composite`
(terms, histogram and date_histogram sources, `after` paging), `filter`,
`filters`, `global` and `missing`.

The mesh reduce is here too: `mesh_agg_ineligible_reason`,
`merge_mesh_result` and the Aggregator's mesh-only arguments
(`term_pads`, `range_handles`), which parallel/mesh_serving.py's one
request over a shard mesh uses. Left out: the wire reduce of the
replicated cluster (`wire_agg_ineligible_reason` through
`render_wire_states`) and task polling.

Per segment, one device pass (ops/aggs_device.execute_aggs) evaluates the
query once and every aggregation off its matched mask; the cross-segment
(and cross-shard) merge by bucket key and the rendering run here on the
host, as in the reference. Metrics fold on the host in float64 from the
matched mask, segment by segment in handle order (the reference's double
reduce); the per-bucket counts and sub-metric planes come from the
device (K10, f32 sums) and merge in float64 across segments. Dates are
epoch milliseconds: K10 buckets them in the f32 doc-values column (a
calendar date_histogram runs as K10's range mode over f32 edges), while
top_hits membership tests the f64 host column, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

METRIC_KINDS = {"min", "max", "sum", "avg", "value_count", "stats"}
# Metric-like kinds computed on the host from the device matched mask and
# the float64 columns (f64-exact reduce; InternalSum.java:22 reduces in
# double) — they nest under filter-type parents like any metric.
HOST_METRIC_KINDS = {
    "percentiles", "percentile_ranks", "extended_stats",
    "median_absolute_deviation",
}
BUCKET_METRIC_HOSTS = {
    "terms", "significant_terms", "rare_terms", "histogram",
    "date_histogram", "range",
}
NESTING_KINDS = {"filter", "filters", "global", "missing"}
MAX_BUCKETS = 65536  # ES search.max_buckets default
# ES default percents for the percentiles aggregation.
DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

# Calendar/fixed interval units in milliseconds (fixed-width ones; month+
# use host-computed edges). ES treats day as fixed 86400000 ms in UTC.
_FIXED_UNIT_MS = {
    "ms": 1.0,
    "s": 1000.0,
    "second": 1000.0,
    "1s": 1000.0,
    "m": 60_000.0,
    "minute": 60_000.0,
    "1m": 60_000.0,
    "h": 3_600_000.0,
    "hour": 3_600_000.0,
    "1h": 3_600_000.0,
    "d": 86_400_000.0,
    "day": 86_400_000.0,
    "1d": 86_400_000.0,
    "w": 604_800_000.0,
    "week": 604_800_000.0,
    "1w": 604_800_000.0,
}


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
    """Parse an ES `"aggs"`/`"aggregations"` object into AggNode trees."""
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
            node.subs = parse_aggs(sub_body)
        _validate(node)
        nodes.append(node)
    return nodes


def _validate(node: AggNode) -> None:
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
    if k == "composite":
        _validate_composite(node)
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
        if node.subs:
            raise AggParsingError(
                f"metric aggregation [{node.name}] cannot hold sub-aggregations"
            )
        if not node.params.get("fields"):
            raise AggParsingError(
                f"matrix_stats [{node.name}] requires [fields]"
            )
    if k == "percentile_ranks" and not node.params.get("values"):
        raise AggParsingError(
            f"percentile_ranks [{node.name}] requires [values]"
        )


def _validate_composite(node: AggNode) -> None:
    """Normalize composite sources into node.params['_sources']:
    (name, kind, field, order, interval, offset) tuples."""
    raw = node.params.get("sources")
    if not isinstance(raw, list) or not raw:
        raise AggParsingError(
            f"composite [{node.name}] requires a non-empty [sources] array"
        )
    parsed = []
    for entry in raw:
        if not isinstance(entry, dict) or len(entry) != 1:
            raise AggParsingError(
                "each composite source must be an object with exactly one "
                "named source"
            )
        ((name, body),) = entry.items()
        if not isinstance(body, dict) or len(body) != 1:
            raise AggParsingError(
                f"composite source [{name}] must define exactly one type"
            )
        ((skind, sparams),) = body.items()
        if skind not in ("terms", "histogram", "date_histogram"):
            raise AggParsingError(
                f"unknown composite source type [{skind}] in [{name}]"
            )
        field = sparams.get("field")
        if field is None:
            raise AggParsingError(
                f"composite source [{name}] requires [field]"
            )
        order = str(sparams.get("order", "asc")).lower()
        if order not in ("asc", "desc"):
            raise AggParsingError(
                f"composite source [{name}] order must be asc or desc"
            )
        interval = None
        offset = float(sparams.get("offset", 0.0))
        if skind == "histogram":
            interval = float(sparams.get("interval", 0.0))
            if interval <= 0:
                raise AggParsingError(
                    f"composite histogram source [{name}] requires a "
                    f"positive [interval]"
                )
        elif skind == "date_histogram":
            unit = sparams.get("calendar_interval") or sparams.get(
                "fixed_interval"
            )
            if unit is None:
                raise AggParsingError(
                    f"composite date_histogram source [{name}] requires "
                    f"[fixed_interval] or [calendar_interval]"
                )
            unit = str(unit)
            if unit in _FIXED_UNIT_MS:
                interval = _FIXED_UNIT_MS[unit]
            else:
                import re as _re

                m = _re.fullmatch(r"(\d+)(ms|s|m|h|d)", unit)
                if m is None:
                    raise AggParsingError(
                        f"composite date_histogram source [{name}]: only "
                        f"fixed-width intervals are supported, got [{unit}]"
                    )
                interval = float(m.group(1)) * _FIXED_UNIT_MS[m.group(2)]
        parsed.append((name, skind, str(field), order, interval, offset))
    node.params["_sources"] = parsed
    for sub in node.subs:
        if sub.kind not in METRIC_KINDS:
            raise AggParsingError(
                f"composite [{node.name}] supports metric sub-aggregations "
                f"only; [{sub.name}] is [{sub.kind}]"
            )


def _pow2(n: int, minimum: int = 1) -> int:
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


class Aggregator:
    """Plans, executes (per segment), reduces, and renders one request's aggs.

    Construction plans against the engine's current segments: histogram
    bases/bucket counts are computed from global column ranges so every
    segment's result arrays align for the reduce.
    """

    def __init__(self, engine, nodes: list[AggNode], handles=None,
                 index_name: str = "index", term_pads=None,
                 range_handles=None):
        self.engine = engine
        self.nodes = nodes
        self.index_name = index_name
        # `handles` lets the caller share one segment snapshot between the
        # agg pass and the hits pass (concurrent refresh would otherwise
        # desynchronize totals from hits).
        segments = engine.segments if handles is None else handles
        self.handles = [h for h in segments if h.segment.num_docs > 0]
        # Uniform keyword ordinal-plane pads, {field: pow2 bucket}: the
        # mesh compiles ONE agg plan for every shard, so the scatter width
        # must cover the largest shard vocabulary; the per-handle pow2
        # default keeps the solo-segment behavior.
        self.term_pads = term_pads or {}
        # Histogram planning scope: the handles whose column ranges size
        # fixed-interval bucket windows. The mesh plans over the pinned
        # ENGINE handles (tombstoned values included, as the host-loop
        # coordinator does) while executing over merged shard segments,
        # so plan-time TooManyBuckets behavior matches the host loop.
        self.range_handles = range_handles if range_handles is not None else (
            self.handles
        )
        # Per-request plan state, keyed by id(node) — names are not unique
        # across nesting levels (a filter-nested histogram may shadow a
        # top-level one of the same name).
        self._plan: dict[str, Any] = {}
        self._range_cache: dict[str, tuple[float, float]] = {}

    def _field_range(self, fname: str) -> tuple[float, float]:
        """Global [min, max] of a numeric column over the planning scope's
        segments, lazily computed only for fields histogram aggs plan over
        (host columns are float64; quantized to f32 = stored-value
        semantics)."""
        cached = self._range_cache.get(fname)
        if cached is not None:
            return cached
        lo, hi = np.inf, -np.inf
        for h in self.range_handles:
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
        pow2 vocabulary bucket, or the caller's uniform pad."""
        override = self.term_pads.get(fname)
        if override is not None:
            return override
        return _pow2(handle.device.fields[fname].num_terms)

    # ----------------------------------------------------------- compile

    def compile_for(self, handle, compiler) -> tuple[tuple, tuple]:
        """(aggs_spec, aggs_arrays) for one segment. When any top_hits
        rides an array-bucket host (or the root), one extra trailing
        ("hits_planes",) spec fetches the root mask + scores."""
        specs, arrays = [], []
        for node in self.nodes:
            s, a = self._compile_node(node, handle, compiler)
            specs.append(s)
            arrays.append(a)
        if self._has_top_hits():
            specs.append(("hits_planes",))
            arrays.append({})
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
        sub-metrics) must not silently return empties for mapped
        non-numeric fields — the reference 400s 'field of type [keyword]
        is not supported'. Unmapped fields stay permissive (empty result),
        matching ES unmapped-field semantics."""
        fm = self.engine.mappings.get(fname)
        if fm is not None and not fm.is_numeric:
            raise AggParsingError(
                f"field [{fname}] of type [{fm.type}] is not supported "
                f"for numeric aggregations"
            )

    def _sub_fields(self, node: AggNode, handle) -> tuple:
        """Sub-metric fields present in this segment's doc values. A field
        some docs lack simply contributes nothing from segments without it
        (the reference's ValuesSource skips docs missing the field).
        top_hits subs carry no field — they ride the root hits planes."""
        out = []
        for f in sorted(
            {s.params["field"] for s in node.subs if s.kind in METRIC_KINDS}
        ):
            self._require_numeric(f)
            if f in handle.device.doc_values:
                out.append(f)
        return tuple(out)

    def _has_top_hits(self) -> bool:
        """True when any node needs the root (mask, scores) planes: a
        top-level top_hits, or one nested under an array-bucket host
        (whose per-bucket membership is recomputed host-side at render)."""

        def walk(nodes):
            for n in nodes:
                if n.kind == "top_hits":
                    return True
                if n.kind in BUCKET_METRIC_HOSTS and any(
                    s.kind == "top_hits" for s in n.subs
                ):
                    return True
                if walk(n.subs):
                    return True
            return False

        return walk(self.nodes)


    def _want_mask(self, node: AggNode) -> tuple:
        """("mask",) spec suffix when a top_hits sub needs the CONTEXT
        mask back from this bucket agg (the root planes would leak docs
        from outside a filter/missing/global parent's context)."""
        return ("mask",) if any(
            s.kind == "top_hits" for s in node.subs
        ) else ()

    def _compile_node(self, node: AggNode, handle, compiler):
        k = node.kind
        p = node.params
        if k in METRIC_KINDS | HOST_METRIC_KINDS:
            # Metrics reduce on the HOST in float64 from the device-
            # returned matched mask and the segment's f64 columns: the
            # reference accumulates sums/stats in double
            # (InternalSum.java:22), which the f32 device planes cannot
            # honor at 1M+ docs. The device still evaluates the query and
            # every bucket scatter; per-bucket sub-metric planes stay f32
            # on device (bucket populations are smaller) with f64 merge.
            self._require_numeric(p["field"])
            return ("matched",), {}
        if k == "top_hits":
            return ("hits_planes",), {}
        if k == "composite":
            for _, skind, fname, _, _, _ in p["_sources"]:
                if skind in ("histogram", "date_histogram"):
                    self._require_numeric(fname)
            return ("matched",), {}
        if k == "cardinality":
            fname = p["field"]
            if self._keyword_ok(handle, fname):
                tp = self._term_pad(handle, fname)
                return ("terms", fname, tp, ()), {}
            if self._is_text(handle, fname):
                raise AggParsingError(
                    f"cardinality aggregation on text field [{fname}] "
                    f"requires keyword doc values"
                )
            # numeric cardinality (exact host compute off the matched mask),
            # or field absent from this segment (host fallback yields none)
            return ("matched",), {}
        if k == "matrix_stats":
            for fname in p["fields"]:
                self._require_numeric(fname)
            return ("matched",), {}
        if k == "rare_terms":
            fname = p["field"]
            if node.subs:
                raise AggParsingError(
                    "[rare_terms] sub-aggregations are not supported yet"
                )
            if self._keyword_ok(handle, fname):
                tp = self._term_pad(handle, fname)
                return ("terms", fname, tp, ()), {}
            if self._is_text(handle, fname):
                raise AggParsingError(
                    f"rare_terms aggregation on text field [{fname}] "
                    f"requires keyword doc values"
                )
            return ("matched",), {}
        if k == "significant_terms":
            fname = p["field"]
            if self._keyword_ok(handle, fname):
                tp = self._term_pad(handle, fname)
                spec = ("sig_terms", fname, tp, self._sub_fields(node, handle))
                return spec + self._want_mask(node), {}
            if self._is_text(handle, fname):
                raise AggParsingError(
                    f"significant_terms aggregation on text field [{fname}] "
                    f"requires keyword doc values"
                )
            if self._field_kind(handle, fname) == "numeric":
                raise AggParsingError(
                    f"significant_terms on numeric field [{fname}] is not "
                    f"supported yet (use a keyword field)"
                )
            # absent from this segment: count the context size only
            return ("sig_matched",), {}
        if k == "terms":
            fname = p["field"]
            if self._keyword_ok(handle, fname):
                tp = self._term_pad(handle, fname)
                spec = ("terms", fname, tp, self._sub_fields(node, handle))
                return spec + self._want_mask(node), {}
            if self._is_text(handle, fname):
                raise AggParsingError(
                    f"cannot run terms aggregation on field [{fname}]: text "
                    f"fields need keyword doc values (use a keyword field)"
                )
            if node.subs and self._field_kind(handle, fname) == "numeric":
                raise AggParsingError(
                    "sub-aggregations under a numeric terms "
                    "aggregation are not supported yet"
                )
            # numeric terms host fallback; absent fields contribute nothing
            return ("matched",), {}
        if k in ("histogram", "date_histogram"):
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
                return ("empty_buckets", len(raw)) + self._want_mask(node), {}
            los = np.asarray(
                [np.float32(r.get("from", -np.inf)) for r in raw],
                dtype=np.float32,
            )
            his = np.asarray(
                [np.float32(r.get("to", np.inf)) for r in raw],
                dtype=np.float32,
            )
            spec = ("range", fname, len(raw), self._sub_fields(node, handle))
            return spec + self._want_mask(node), {"los": los, "his": his}
        if k == "filter":
            compiled = compiler.compile(_parse_query(p))
            sub_s, sub_a = self._compile_subs(node, handle, compiler)
            return ("filter", compiled.spec, sub_s), {
                "query": compiled.arrays,
                "subs": sub_a,
            }
        if k == "filters":
            keys, queries = _filters_defs(node)
            compiled = [compiler.compile(_parse_query({"filter": q})) for q in queries]
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
            fkind = self._field_kind(handle, fname)
            # fkind "none" (unmapped or absent from this segment): every
            # matched doc counts as missing, like the reference's missing
            # agg over an unmapped field.
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
        interval, edges = self._histogram_interval(node)
        if fname not in handle.device.doc_values:
            # Keep the bucket-array shape consistent with the segments that
            # do carry the column so the cross-segment merge aligns.
            if edges is not None:
                nb = len(edges) - 1
                self._plan.setdefault("hist_edges", {})[id(node)] = edges
            else:
                _, _, _, nb = self._fixed_hist_plan(node, interval)  # padded
            return ("empty_buckets", max(nb, 1)) + self._want_mask(node), {}
        if edges is not None:
            # Calendar intervals (month+): host-computed bucket edges run as
            # a range aggregation; keys render from the edges.
            sub_fields = self._sub_fields(node, handle)
            los = np.asarray(edges[:-1], dtype=np.float32)
            his = np.asarray(edges[1:], dtype=np.float32)
            self._plan.setdefault("hist_edges", {})[id(node)] = edges
            return ("range", fname, len(los), sub_fields) + self._want_mask(
                node
            ), {
                "los": los,
                "his": his,
            }
        offset, base, nb, nb_pad = self._fixed_hist_plan(node, interval)
        spec = ("histogram", fname, nb_pad, self._sub_fields(node, handle))
        spec = spec + self._want_mask(node)
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

    def _histogram_interval(self, node: AggNode):
        """(fixed_interval_ms_or_value, calendar_edges_or_None)."""
        p = node.params
        if node.kind == "histogram":
            interval = p.get("interval")
            if interval is None or float(interval) <= 0:
                raise AggParsingError(
                    f"[interval] must be a positive decimal in [{node.name}]"
                )
            return float(interval), None
        unit = p.get("calendar_interval") or p.get("fixed_interval") or p.get(
            "interval"
        )
        if unit is None:
            raise AggParsingError(
                f"date_histogram [{node.name}] requires [calendar_interval] "
                f"or [fixed_interval]"
            )
        unit = str(unit)
        if unit in _FIXED_UNIT_MS:
            return _FIXED_UNIT_MS[unit], None
        # fixed_interval like "30s", "12h", "90m", "7d"
        import re as _re

        m = _re.fullmatch(r"(\d+)(ms|s|m|h|d)", unit)
        if m:
            return float(m.group(1)) * _FIXED_UNIT_MS[m.group(2)], None
        if _is_calendar(node):
            return 0.0, self._calendar_edges(node, unit)
        raise AggParsingError(
            f"unknown date_histogram interval [{unit}] in [{node.name}]"
        )

    def _calendar_edges(self, node: AggNode, unit: str) -> list[float]:
        """UTC month/quarter/year bucket edges covering the field's range."""
        from datetime import datetime, timezone

        fname = node.params["field"]
        lo, hi = self._field_range(fname)
        months = {"month": 1, "1M": 1, "M": 1, "quarter": 3, "1q": 3, "q": 3}.get(
            unit, 12
        )
        start = datetime.fromtimestamp(lo / 1000.0, tz=timezone.utc)
        y, mo = start.year, ((start.month - 1) // months) * months + 1
        edges = []
        while True:
            edge = datetime(y, mo, 1, tzinfo=timezone.utc).timestamp() * 1000.0
            edges.append(edge)
            if edge > hi:
                break
            if len(edges) > MAX_BUCKETS:
                raise TooManyBucketsError(
                    f"Trying to create too many buckets. Must be less than "
                    f"or equal to: [{MAX_BUCKETS}]"
                )
            mo += months
            while mo > 12:
                mo -= 12
                y += 1
        return edges

    # ----------------------------------------------------------- execute

    def run(self, query, stats=None) -> tuple[int, dict[str, Any]]:
        """Execute over every segment; returns (total_hits, rendered aggs)."""
        total, states = self.run_states(query, stats=stats)
        return total, self.render_states(states)

    def render_states(self, states) -> dict[str, Any]:
        """Render merged states to the ES response shape."""
        return {
            node.name: render(
                node, state, self.engine, self._plan, self.index_name
            )
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
            root_planes = None
            if self._has_top_hits():
                root_planes = results[-1]
                results = results[: len(self.nodes)]
            for node, state, result in zip(self.nodes, states, results):
                merge_segment_result(
                    node, state, result, handle, root_planes=root_planes
                )
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
    if k in METRIC_KINDS | {"extended_stats"}:
        return {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf, "sumsq": 0.0}
    if k in ("percentiles", "percentile_ranks", "median_absolute_deviation"):
        return {"chunks": []}  # per-segment matched f64 value arrays
    if k == "top_hits":
        return {"segments": []}  # (handle, mask, scores) per segment
    if k == "composite":
        return {"counts": {}, "subs": {}}
    if k == "cardinality":
        return {"values": set()}
    if k in ("terms", "rare_terms"):
        return {"counts": {}, "subs": {}, "host": False, "hits_segments": []}
    if k == "significant_terms":
        return {
            "counts": {},
            "subs": {},
            "hits_segments": [],
            "doc_count": 0,       # subset (context) size
            "bg_total": 0,        # superset size: index live docs
            "bg_df": {},          # superset per-term doc counts
        }
    if k == "matrix_stats":
        return {"moments": None}
    if k in ("histogram", "date_histogram"):
        return {"counts": None, "subs": {}, "hits_segments": []}
    if k == "range":
        return {"counts": None, "subs": {}, "hits_segments": []}
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
        state["sumsq"] += float(np.sum(vals * vals))


def _fold_chunk_values(state, vals: np.ndarray) -> None:
    """Percentile-family fold: keep the raw f64 chunk (render sorts the
    concatenation, so chunk boundaries never affect the result)."""
    if len(vals):
        state["chunks"].append(vals)


def merge_segment_result(
    node: AggNode, state, result, handle, root_planes=None
) -> None:
    """Fold one segment's device result into the cross-segment state."""
    k = node.kind
    if k in METRIC_KINDS | {"extended_stats"}:
        # f64-exact host reduce over the matched mask (the device f32 sum
        # plane drifts user-visibly at 1M+ docs; InternalSum.java:22).
        _fold_metric_values(
            state, _host_values(result, handle, node.params["field"])
        )
        return
    if k in ("percentiles", "percentile_ranks", "median_absolute_deviation"):
        _fold_chunk_values(
            state, _host_values(result, handle, node.params["field"])
        )
        return
    if k == "top_hits":
        n = handle.segment.num_docs
        state["segments"].append(
            (
                handle,
                np.asarray(result["mask"])[:n],
                np.asarray(result["scores"])[:n],
            )
        )
        return
    if k == "composite":
        _merge_composite(node, state, result, handle)
        return
    if k == "cardinality":
        fname = node.params["field"]
        dfield = handle.device.fields.get(fname)
        if dfield is not None and dfield.ord_terms is not None:
            counts = np.asarray(result["counts"])
            vocab = list(dfield.terms.keys())
            nz = np.flatnonzero(counts[: len(vocab)])
            state["values"].update(vocab[i] for i in nz)
        else:  # numeric host fallback: exact distinct from the f64 column
            for v in _host_values(result, handle, fname):
                state["values"].add(float(v))
        return
    if k == "matrix_stats":
        _merge_matrix_stats(node, state, result, handle)
        return
    if k == "significant_terms":
        _capture_hits_planes(node, state, handle, result, root_planes)
        fname = node.params["field"]
        state["doc_count"] += int(np.asarray(result["doc_count"]))
        # Superset size counts ALL docs (deleted included), matching the
        # per-term bg df which is frozen at segment build — Lucene
        # statistics ignore liveDocs until merge, and mixing scopes would
        # let bg_pct exceed 1 and suppress real signals after deletes.
        state["bg_total"] += handle.segment.num_docs
        fld = handle.segment.fields.get(fname)
        if fld is not None:
            for term, tid in fld.terms.items():
                state["bg_df"][term] = state["bg_df"].get(term, 0) + int(
                    fld.df[tid]
                )
        dfield = handle.device.fields.get(fname)
        if dfield is None or dfield.ord_terms is None or "counts" not in result:
            return
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
    if k == "rare_terms":
        fname = node.params["field"]
        dfield = handle.device.fields.get(fname)
        if dfield is None or dfield.ord_terms is None:
            vals, counts = np.unique(
                _host_values(result, handle, fname), return_counts=True
            )
            if len(vals):
                state["host"] = True
            for v, c in zip(vals, counts):
                key = float(v)
                state["counts"][key] = state["counts"].get(key, 0) + int(c)
            return
        vocab = list(dfield.terms.keys())
        counts = np.asarray(result["counts"])
        nz = np.flatnonzero(counts[: len(vocab)])
        for i in nz:
            key = vocab[i]
            state["counts"][key] = state["counts"].get(key, 0) + int(counts[i])
        return
    if k == "terms":
        _capture_hits_planes(node, state, handle, result, root_planes)
        fname = node.params["field"]
        dfield = handle.device.fields.get(fname)
        if dfield is None or dfield.ord_terms is None:
            # numeric terms: exact host counts off the matched mask. A
            # keyword field absent from this segment also lands here but
            # contributes no values (and must not flip the numeric-key
            # rendering flag).
            vals, counts = np.unique(
                _host_values(result, handle, fname), return_counts=True
            )
            if len(vals):
                state["host"] = True
            for v, c in zip(vals, counts):
                key = float(v)
                state["counts"][key] = state["counts"].get(key, 0) + int(c)
            return
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
    if k in ("histogram", "date_histogram", "range"):
        _capture_hits_planes(node, state, handle, result, root_planes)
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
            merge_segment_result(
                sub_node, sub_state, sub_result, handle,
                root_planes=root_planes,
            )
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
                merge_segment_result(
                    sub_node, sub_state, sub_result, handle,
                    root_planes=root_planes,
                )
        return
    raise AggParsingError(f"unknown aggregation type [{k}]")


# ------------------------------------------------------ mesh (SPMD) merge


def mesh_agg_ineligible_reason(nodes: list[AggNode]) -> str | None:
    """Why this agg tree cannot ride the one mesh request (None =
    eligible). Eligible kinds are those whose combine equals the host
    loop's exactly: the metric and percentile families (per-shard masks
    from the launch + the same f64 host fold in handle-span order),
    integer-count planes (fixed-edge histogram / date_histogram / range,
    psum'd), keyword / numeric terms, rare_terms and cardinality (integer
    counts / distinct sets merged by key on the host), and the
    filter / filters / global / missing nesting family over eligible
    subs. Ineligible: array-bucket hosts with metric sub-aggs (their f32
    device planes accumulate in per-segment order), top_hits, composite,
    matrix_stats and significant_terms (its background statistics come
    from tombstoned engine segments the mesh snapshot does not carry)."""
    for node in nodes:
        k = node.kind
        if k in METRIC_KINDS | HOST_METRIC_KINDS or k == "cardinality":
            continue
        if k in ("terms", "rare_terms", "histogram", "date_histogram",
                 "range"):
            if node.subs:
                return "agg_shape"
            continue
        if k in NESTING_KINDS:
            reason = mesh_agg_ineligible_reason(node.subs)
            if reason:
                return reason
            continue
        return "agg_shape"
    return None


def merge_mesh_result(node: AggNode, state, stacked, handles) -> None:
    """Fold one agg node's stacked mesh result ([shard, ...] numpy
    planes; psum'd count leaves replicated over the shard axis) into a
    merge state exactly as the host loop's per-segment fold does.

    `handles` are the mesh shard handles (one merged live-doc segment per
    shard) carrying `spans`, the [lo, hi) of each original engine segment
    inside the merged doc space: metric folds walk the spans in
    shard-then-handle order, the host path's f64 partial-sum grouping."""
    k = node.kind
    if k in METRIC_KINDS | {"extended_stats"} or k in (
        "percentiles", "percentile_ranks", "median_absolute_deviation"
    ):
        fold = (
            _fold_chunk_values
            if k in ("percentiles", "percentile_ranks",
                     "median_absolute_deviation")
            else _fold_metric_values
        )
        fname = node.params["field"]
        masks = np.asarray(stacked["mask"])
        for s, handle in enumerate(handles):
            col = handle.segment.doc_values.get(fname)
            if col is None or not len(col):
                continue
            mask = masks[s][: handle.segment.num_docs]
            for lo, hi in handle.spans:
                vals = col[lo:hi][mask[lo:hi]]
                fold(state, vals[~np.isnan(vals)])
        return
    if k in ("cardinality", "terms", "rare_terms"):
        # Integer counts / distinct values keyed by shard-local
        # vocabularies: the per-segment merge applies verbatim, one merged
        # segment per shard.
        for s, handle in enumerate(handles):
            merge_segment_result(node, state, _shard_row(stacked, s), handle)
        return
    if k in ("histogram", "date_histogram", "range"):
        # Counts were psum'd (replicated rows): read once.
        state["counts"] = np.asarray(stacked["counts"])[0].astype(np.int64)
        return
    if k in ("filter", "global", "missing"):
        state["doc_count"] += int(np.asarray(stacked["doc_count"])[0])
        for sub_node, sub_state, sub_stacked in zip(
            node.subs, state["subs"], stacked["subs"]
        ):
            merge_mesh_result(sub_node, sub_state, sub_stacked, handles)
        return
    if k == "filters":
        if state["buckets"] is None:
            state["buckets"] = [
                {
                    "doc_count": 0,
                    "subs": [new_merge_state(s) for s in node.subs],
                }
                for _ in stacked
            ]
        for bstate, bstacked in zip(state["buckets"], stacked):
            bstate["doc_count"] += int(np.asarray(bstacked["doc_count"])[0])
            for sub_node, sub_state, sub_stacked in zip(
                node.subs, bstate["subs"], bstacked["subs"]
            ):
                merge_mesh_result(sub_node, sub_state, sub_stacked, handles)
        return
    raise AggParsingError(f"aggregation type [{k}] is not mesh-eligible")


def _shard_row(tree, s: int):
    """Row s of every leaf of a stacked numpy tree."""
    if isinstance(tree, dict):
        return {key: _shard_row(val, s) for key, val in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_shard_row(v, s) for v in tree)
    return np.asarray(tree)[s]


def _capture_hits_planes(node, state, handle, result, root_planes) -> None:
    """Array-bucket hosts with top_hits subs keep per-segment (context
    mask, scores) planes; bucket membership is recomputed at render time.
    The mask comes from THIS node's result (its spec carries the "mask"
    flag) so a terms/histogram/range nested under a filter-type parent
    only ever selects docs inside that parent's context; only the scores
    plane (context-independent) rides the root hits planes."""
    if root_planes is None or not any(
        s.kind == "top_hits" for s in node.subs
    ):
        return
    mask = result.get("ctx_mask", result.get("mask"))
    if mask is None:
        return
    n = handle.segment.num_docs
    state["hits_segments"].append(
        (
            handle,
            np.asarray(mask)[:n],
            np.asarray(root_planes["scores"])[:n],
        )
    )


def _keyword_ords(handle, fname: str):
    """(per-doc term ordinal i32[N] (-1 = none; multi-valued docs keep the
    LAST term in term-sort order — composite sources assume single-valued
    keywords), vocab list) — cached on the handle."""
    cache = handle.__dict__.setdefault("_keyword_ords_cache", {})
    got = cache.get(fname)
    if got is not None:
        return got
    fld = handle.segment.fields.get(fname)
    n = handle.segment.num_docs
    if fld is None or fld.has_norms:
        out = (None, [])
    else:
        ords = np.full(n, -1, dtype=np.int64)
        counts = np.diff(fld.offsets).astype(np.int64)
        per_posting = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        ords[fld.doc_ids] = per_posting
        out = (ords, list(fld.terms.keys()))
    cache[fname] = out
    return out


def _merge_composite(node: AggNode, state, result, handle) -> None:
    """Fold one segment's matched docs into the composite key space.

    Vectorized: each source factorizes to integer codes; np.unique over
    the stacked code rows buckets every matched doc at once; sub-metric
    planes group with np.add.at / minimum.at over the inverse index."""
    mask = np.asarray(result["mask"])[: handle.segment.num_docs]
    n = handle.segment.num_docs
    valid = mask.copy()
    codes = []
    decoders = []
    for name, skind, fname, order, interval, offset in node.params["_sources"]:
        if skind == "terms":
            ords, vocab = _keyword_ords(handle, fname)
            if ords is not None:
                valid &= ords >= 0
                codes.append(ords)
                decoders.append(("vocab", vocab))
                continue
            col = handle.segment.doc_values.get(fname)
            if col is None:
                valid &= False
                codes.append(np.zeros(n, dtype=np.int64))
                decoders.append(("values", np.zeros(0)))
                continue
            valid &= ~np.isnan(col)
            uniq, inv = np.unique(
                np.where(np.isnan(col), 0.0, col), return_inverse=True
            )
            codes.append(inv.astype(np.int64))
            decoders.append(("values", uniq))
        else:  # histogram / date_histogram (fixed intervals)
            col = handle.segment.doc_values.get(fname)
            if col is None:
                valid &= False
                codes.append(np.zeros(n, dtype=np.int64))
                decoders.append(("values", np.zeros(0)))
                continue
            valid &= ~np.isnan(col)
            keys = (
                np.floor((np.where(np.isnan(col), 0.0, col) - offset) / interval)
                * interval
                + offset
            )
            uniq, inv = np.unique(keys, return_inverse=True)
            codes.append(inv.astype(np.int64))
            decoders.append(("values", uniq))
    locs = np.flatnonzero(valid)
    if len(locs) == 0:
        return
    rows = np.stack([c[locs] for c in codes], axis=1)  # [M, S]
    uniq_rows, inv, counts = np.unique(
        rows, axis=0, return_inverse=True, return_counts=True
    )

    def decode(row) -> tuple:
        out = []
        for (dkind, data), code in zip(decoders, row):
            out.append(
                data[int(code)] if dkind == "vocab" else float(data[int(code)])
            )
        return tuple(out)

    keys = [decode(row) for row in uniq_rows]
    for key, count in zip(keys, counts):
        state["counts"][key] = state["counts"].get(key, 0) + int(count)
    if node.subs:
        nb = len(uniq_rows)
        for f in sorted({s.params["field"] for s in node.subs}):
            col = handle.segment.doc_values.get(f)
            if col is None:
                continue
            v = col[locs]
            has = ~np.isnan(v)
            vi = inv[has]
            vv = v[has]
            cnt = np.zeros(nb, dtype=np.int64)
            np.add.at(cnt, vi, 1)
            s = np.zeros(nb, dtype=np.float64)
            np.add.at(s, vi, vv)
            mn = np.full(nb, np.inf)
            np.minimum.at(mn, vi, vv)
            mx = np.full(nb, -np.inf)
            np.maximum.at(mx, vi, vv)
            sq = np.zeros(nb, dtype=np.float64)
            np.add.at(sq, vi, vv * vv)
            tgt = state["subs"].setdefault(f, {})
            for i, key in enumerate(keys):
                cur = tgt.setdefault(
                    key,
                    {
                        "count": 0,
                        "sum": 0.0,
                        "min": np.inf,
                        "max": -np.inf,
                        "sumsq": 0.0,
                    },
                )
                cur["count"] += int(cnt[i])
                cur["sum"] += float(s[i])
                cur["min"] = min(cur["min"], float(mn[i]))
                cur["max"] = max(cur["max"], float(mx[i]))
                cur["sumsq"] += float(sq[i])


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
        if sub.kind == "top_hits":
            continue  # rendered by the parent with a membership predicate
        f = sub.params["field"]
        planes = sub_planes_by_field.get(f, {}).get(
            key, {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf}
        )
        planes = dict(planes)
        planes.setdefault("sumsq", 0.0)
        out[sub.name] = _render_metric(sub.kind, planes)
    return out


def _render_array_sub(node: AggNode, idx: int, state) -> dict[str, Any]:
    out = {}
    for sub in node.subs:
        if sub.kind == "top_hits":
            continue  # rendered by the parent with a membership predicate
        f = sub.params["field"]
        planes = state["subs"].get(f)
        if planes is None:
            p = {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf, "sumsq": 0.0}
        else:
            p = {
                "count": int(planes["count"][idx]),
                "sum": float(planes["sum"][idx]),
                "min": float(planes["min"][idx]),
                "max": float(planes["max"][idx]),
                "sumsq": 0.0,
            }
        out[sub.name] = _render_metric(sub.kind, p)
    return out


def _key_for_field(engine, fname: str, value: float):
    """Render a numeric bucket key with the field's type (int for longs)."""
    fm = engine.mappings.get(fname)
    if fm is not None and fm.type in ("long", "integer", "short", "byte", "date"):
        return int(value)
    return float(value)


def _iso_utc(ms: float) -> str:
    from datetime import datetime, timezone

    dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def _percentile_values(state) -> np.ndarray:
    if not state["chunks"]:
        return np.zeros(0, dtype=np.float64)
    return np.sort(np.concatenate(state["chunks"]))


def _render_percentiles(node: AggNode, state) -> dict[str, Any]:
    """Exact quantiles with linear interpolation — where the reference's
    t-digest approximates (PercentilesAggregationBuilder.java:62), the
    host reduce over f64 columns is exact at every size (t-digest itself
    is exact until compression kicks in, so small-data values agree)."""
    percents = [
        float(p) for p in node.params.get("percents", DEFAULT_PERCENTS)
    ]
    vals = _percentile_values(state)
    keyed = bool(node.params.get("keyed", True))
    out_vals: list[tuple[str, float | None]] = []
    for p in percents:
        if len(vals) == 0:
            v = None
        else:
            v = float(np.percentile(vals, p, method="linear"))
        out_vals.append((f"{p:g}.0" if float(p).is_integer() else f"{p:g}", v))
    if keyed:
        return {"values": {key: v for key, v in out_vals}}
    return {
        "values": [
            {"key": float(key), "value": v} for key, v in out_vals
        ]
    }


def _render_percentile_ranks(node: AggNode, state) -> dict[str, Any]:
    values = [float(v) for v in node.params["values"]]
    vals = _percentile_values(state)
    keyed = bool(node.params.get("keyed", True))
    out = {}
    for v in values:
        if len(vals) == 0:
            rank = None
        else:
            rank = float(np.searchsorted(vals, v, side="right")) / len(vals) * 100.0
        out[f"{v:g}.0" if float(v).is_integer() else f"{v:g}"] = rank
    if keyed:
        return {"values": out}
    return {
        "values": [{"key": float(k), "value": v} for k, v in out.items()]
    }


def _render_extended_stats(state) -> dict[str, Any]:
    count = state["count"]
    if not count:
        return {
            "count": 0, "min": None, "max": None, "avg": None, "sum": 0.0,
            "sum_of_squares": None, "variance": None, "std_deviation": None,
            "std_deviation_bounds": {"upper": None, "lower": None},
        }
    mean = state["sum"] / count
    variance = max(0.0, state["sumsq"] / count - mean * mean)
    std = float(np.sqrt(variance))
    sigma = 2.0
    return {
        "count": count,
        "min": float(state["min"]),
        "max": float(state["max"]),
        "avg": mean,
        "sum": float(state["sum"]),
        "sum_of_squares": float(state["sumsq"]),
        "variance": variance,
        "std_deviation": std,
        "std_deviation_bounds": {
            "upper": mean + sigma * std,
            "lower": mean - sigma * std,
        },
    }


def _source_filter(src, source_param):
    if source_param is False:
        return None
    if source_param is True or source_param is None:
        return src
    wanted = (
        [source_param] if isinstance(source_param, str) else list(source_param)
    )
    return {k: v for k, v in src.items() if k in set(wanted)}


def _render_top_hits(
    node: AggNode, segments, index_name: str, predicate=None
) -> dict[str, Any]:
    """Select the context's top docs by (score desc, global doc asc).

    `segments` holds per-segment (handle, mask, scores) planes;
    `predicate(handle) -> bool[N]` restricts to one bucket's members
    (array-bucket parents recompute membership here — only rendered
    buckets pay, the TopHitsAggregator analog without a per-bucket
    device pass)."""
    size = int(node.params.get("size", 3))
    frm = int(node.params.get("from", 0))
    want = frm + size
    source_param = node.params.get("_source", True)
    cands: list[tuple[float, int, Any, int]] = []
    total = 0
    for handle, mask, scores in segments:
        member = mask
        if predicate is not None:
            member = member & predicate(handle)
        locs = np.flatnonzero(member)
        total += len(locs)
        if len(locs) == 0 or want <= 0:
            continue
        sc = scores[locs].astype(np.float64)
        order = np.lexsort((locs, -sc))[:want]
        for i in order:
            cands.append(
                (-float(sc[i]), handle.base + int(locs[i]), handle, int(locs[i]))
            )
    cands.sort(key=lambda t: (t[0], t[1]))
    page = cands[frm : frm + size]
    max_score = -cands[0][0] if cands else None
    hits = []
    for neg, _gdoc, handle, local in page:
        hit: dict[str, Any] = {
            "_index": index_name,
            "_id": handle.segment.ids[local],
            "_score": -neg,
        }
        src = _source_filter(handle.segment.sources[local], source_param)
        if src is not None:
            hit["_source"] = src
        hits.append(hit)
    return {
        "hits": {
            "total": {"value": total, "relation": "eq"},
            "max_score": max_score,
            "hits": hits,
        }
    }


def _cmp_composite(orders):
    """Comparator over decoded composite key tuples honoring per-source
    asc/desc (strings sort lexicographically, numbers numerically)."""

    def cmp(a, b):
        for order, va, vb in zip(orders, a, b):
            if va == vb:
                continue
            lt = va < vb
            if order == "asc":
                return -1 if lt else 1
            return 1 if lt else -1
        return 0

    return cmp


def _render_composite(node: AggNode, state, engine, plan, index_name):
    import functools

    sources = node.params["_sources"]
    orders = [s[3] for s in sources]
    names = [s[0] for s in sources]
    size = int(node.params.get("size", 10))
    cmp = _cmp_composite(orders)
    items = sorted(
        state["counts"].items(),
        key=functools.cmp_to_key(lambda a, b: cmp(a[0], b[0])),
    )
    after = node.params.get("after")
    if after:
        try:
            after_key = tuple(after[name] for name in names)
        except KeyError as e:
            raise AggParsingError(
                f"composite [after] is missing source {e}"
            ) from None
        items = [it for it in items if cmp(it[0], after_key) > 0]
    page = items[:size]

    def render_value(key_val, source):
        _, skind, fname, _, _, _ = source
        if isinstance(key_val, str):
            return key_val
        if skind in ("histogram", "date_histogram"):
            return _key_for_field(engine, fname, key_val) if float(
                key_val
            ).is_integer() else float(key_val)
        return _key_for_field(engine, fname, key_val)

    buckets = []
    for key, count in page:
        rendered_key = {
            name: render_value(v, src)
            for name, v, src in zip(names, key, sources)
        }
        b: dict[str, Any] = {"key": rendered_key, "doc_count": count}
        for sub in node.subs:
            planes = state["subs"].get(sub.params["field"], {}).get(
                key,
                {"count": 0, "sum": 0.0, "min": np.inf, "max": -np.inf,
                 "sumsq": 0.0},
            )
            b[sub.name] = _render_metric(sub.kind, planes)
        buckets.append(b)
    out: dict[str, Any] = {"buckets": buckets}
    if page and len(items) > size:
        out["after_key"] = buckets[-1]["key"]
    return out


def _merge_matrix_stats(node, state, result, handle) -> None:
    """Accumulate f64 raw power sums + cross-products over docs carrying
    ALL requested fields (rows with any missing value are excluded, the
    reference module's default; aggs-matrix-stats RunningStats)."""
    fields = [str(f) for f in node.params["fields"]]
    n = handle.segment.num_docs
    mask = np.asarray(result["mask"])[:n]
    cols = []
    for f in fields:
        col = handle.segment.doc_values.get(f)
        if col is None:
            return  # a wholly-absent field contributes no complete rows
        cols.append(col[:n].astype(np.float64))
    rows = mask.copy()
    for col in cols:
        rows &= ~np.isnan(col)
    if not rows.any():
        return
    x = np.stack([col[rows] for col in cols])  # [K, R]
    mom = state["moments"]
    if mom is None:
        kdim = len(fields)
        mom = state["moments"] = {
            "fields": fields,
            "n": 0,
            # Per-field pivot (the first observed value): power sums
            # accumulate over x - pivot so large-offset data (epoch
            # millis) doesn't catastrophically cancel when central
            # moments are derived — the same problem the reference's
            # Welford-style RunningStats updates avoid.
            "pivot": x[:, 0].copy(),
            "s1": np.zeros(kdim),
            "s2": np.zeros(kdim),
            "s3": np.zeros(kdim),
            "s4": np.zeros(kdim),
            "cross": np.zeros((kdim, kdim)),
        }
    x = x - mom["pivot"][:, None]
    mom["n"] += int(x.shape[1])
    mom["s1"] += x.sum(axis=1)
    mom["s2"] += (x**2).sum(axis=1)
    mom["s3"] += (x**3).sum(axis=1)
    mom["s4"] += (x**4).sum(axis=1)
    mom["cross"] += x @ x.T


def _render_matrix_stats(node: AggNode, state) -> dict[str, Any]:
    mom = state["moments"]
    if mom is None or mom["n"] == 0:
        return {"doc_count": 0, "fields": []}
    n = mom["n"]
    names = mom["fields"]
    sh_mean = mom["s1"] / n  # mean of the PIVOT-SHIFTED values
    mean = mom["pivot"] + sh_mean
    # Central moments from pivot-shifted power sums (shift-invariant).
    m2 = np.maximum(mom["s2"] / n - sh_mean**2, 0.0)
    m3 = mom["s3"] / n - 3 * sh_mean * mom["s2"] / n + 2 * sh_mean**3
    m4 = (
        mom["s4"] / n
        - 4 * sh_mean * mom["s3"] / n
        + 6 * sh_mean**2 * mom["s2"] / n
        - 3 * sh_mean**4
    )
    variance = m2 * n / max(n - 1, 1)  # unbiased, like RunningStats
    std = np.sqrt(m2)
    cov_pop = mom["cross"] / n - np.outer(sh_mean, sh_mean)
    cov = cov_pop * n / max(n - 1, 1)
    out_fields = []
    for i, name in enumerate(names):
        skew = float(m3[i] / std[i] ** 3) if std[i] > 0 else 0.0
        kurt = float(m4[i] / m2[i] ** 2) if m2[i] > 0 else 0.0
        covariance = {}
        correlation = {}
        for j, other in enumerate(names):
            covariance[other] = float(cov[i, j])
            denom = std[i] * std[j]
            correlation[other] = (
                float(cov_pop[i, j] / denom) if denom > 0 else 0.0
            )
        out_fields.append(
            {
                "name": name,
                "count": n,
                "mean": float(mean[i]),
                "variance": float(variance[i]),
                "skewness": skew,
                "kurtosis": kurt,
                "covariance": covariance,
                "correlation": correlation,
            }
        )
    return {"doc_count": n, "fields": out_fields}


_SIG_HEURISTICS = ("jlh", "chi_square", "percentage")


def _sig_score(heuristic: str, fg: int, subset: int, bg: int, superset: int,
               params: dict) -> float:
    """Significance heuristics (search/aggregations/bucket/terms/heuristic/):
    JLH (the default), chi_square, percentage."""
    subset = max(subset, 1)
    superset = max(superset, 1)
    fg_pct = fg / subset
    bg_pct = bg / superset
    if heuristic == "percentage":
        return fg / bg if bg > 0 else 0.0
    if heuristic == "chi_square":
        include_negatives = bool(params.get("include_negatives", False))
        if not include_negatives and fg_pct < bg_pct:
            return 0.0
        # 2x2 contingency chi-square, the reference's ChiSquare.java.
        a, b = fg, bg - fg
        c, d = subset - fg, superset - bg - (subset - fg)
        num = (a * d - b * c) ** 2 * (a + b + c + d)
        den = (a + b) * (c + d) * (a + c) * (b + d)
        return num / den if den > 0 else 0.0
    # JLH (JLHScore.java): absolute * relative change, 0 unless fg% > bg%.
    if fg_pct <= bg_pct or bg_pct == 0:
        return 0.0
    return (fg_pct - bg_pct) * (fg_pct / bg_pct)


def _render_significant_terms(node: AggNode, state, index_name: str) -> dict:
    p = node.params
    size = int(p.get("size", 10))
    min_doc_count = int(p.get("min_doc_count", 3))
    heuristic, hparams = "jlh", {}
    for h in _SIG_HEURISTICS:
        if h in p:
            heuristic = h
            hparams = p[h] if isinstance(p[h], dict) else {}
    subset = state["doc_count"]
    superset = state["bg_total"]
    scored = []
    for term, fg in state["counts"].items():
        if fg < min_doc_count:
            continue
        bg = state["bg_df"].get(term, fg)
        score = _sig_score(heuristic, fg, subset, bg, superset, hparams)
        if score <= 0:
            continue
        scored.append((-score, term, fg, bg))
    scored.sort()
    buckets = []
    for neg_score, term, fg, bg in scored[:size]:
        b = {
            "key": term,
            "doc_count": fg,
            "score": -neg_score,
            "bg_count": bg,
        }
        if node.subs:
            b.update(_sub_bucket_rendering(node, term, state["subs"]))
            for sub in node.subs:
                if sub.kind == "top_hits":
                    b[sub.name] = _render_top_hits(
                        sub,
                        state["hits_segments"],
                        index_name,
                        predicate=_terms_bucket_predicate(
                            node.params["field"], term, False
                        ),
                    )
        buckets.append(b)
    return {
        "doc_count": subset,
        "bg_count": superset,
        "buckets": buckets,
    }


def render(
    node: AggNode, state, engine, plan: dict, index_name: str = "index"
) -> dict[str, Any]:
    k = node.kind
    if k in METRIC_KINDS:
        return _render_metric(k, state)
    if k == "extended_stats":
        return _render_extended_stats(state)
    if k == "percentiles":
        return _render_percentiles(node, state)
    if k == "percentile_ranks":
        return _render_percentile_ranks(node, state)
    if k == "top_hits":
        return _render_top_hits(node, state["segments"], index_name)
    if k == "composite":
        return _render_composite(node, state, engine, plan, index_name)
    if k == "cardinality":
        return {"value": len(state["values"])}
    if k == "matrix_stats":
        return _render_matrix_stats(node, state)
    if k == "median_absolute_deviation":
        vals = (
            np.concatenate(state["chunks"])
            if state["chunks"]
            else np.zeros(0)
        )
        if not len(vals):
            return {"value": None}
        med = float(np.median(vals))
        return {"value": float(np.median(np.abs(vals - med)))}
    if k == "rare_terms":
        max_doc_count = int(node.params.get("max_doc_count", 1))
        fname = node.params["field"]
        items = [
            (k2, c) for k2, c in state["counts"].items()
            if c <= max_doc_count
        ]
        items.sort(key=lambda kv: (kv[1], kv[0]))
        buckets = []
        for key, count in items[:10_000]:
            out_key = (
                _key_for_field(engine, fname, key)
                if state.get("host")
                else key
            )
            buckets.append({"key": out_key, "doc_count": count})
        return {"buckets": buckets}
    if k == "significant_terms":
        return _render_significant_terms(node, state, index_name)
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
        fname = node.params["field"]
        for key, count in top:
            out_key = (
                _key_for_field(engine, fname, key)
                if state.get("host")
                else key
            )
            b = {"key": out_key, "doc_count": count}
            if node.subs:
                b.update(_sub_bucket_rendering(node, key, state["subs"]))
                for sub in node.subs:
                    if sub.kind == "top_hits":
                        b[sub.name] = _render_top_hits(
                            sub,
                            state["hits_segments"],
                            index_name,
                            predicate=_terms_bucket_predicate(
                                fname, key, bool(state.get("host"))
                            ),
                        )
            buckets.append(b)
        return {
            "doc_count_error_upper_bound": 0,  # exact: full per-segment counts
            "sum_other_doc_count": total - sum(c for _, c in top),
            "buckets": buckets,
        }
    if k in ("histogram", "date_histogram"):
        return _render_histogram(node, state, engine, plan, index_name)
    if k == "range":
        raw = node.params.get("ranges", [])
        fname = node.params["field"]
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
                for sub in node.subs:
                    if sub.kind == "top_hits":
                        b[sub.name] = _render_top_hits(
                            sub,
                            state["hits_segments"],
                            index_name,
                            predicate=_value_range_predicate(
                                fname,
                                float(frm) if frm is not None else -np.inf,
                                float(to) if to is not None else np.inf,
                            ),
                        )
            buckets.append(b)
        return {"buckets": buckets}
    if k == "filter" or k == "missing" or k == "global":
        out = {"doc_count": state["doc_count"]}
        for sub_node, sub_state in zip(node.subs, state["subs"]):
            out[sub_node.name] = render(
                sub_node, sub_state, engine, plan, index_name
            )
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
                out[sub_node.name] = render(
                    sub_node, sub_state, engine, plan, index_name
                )
            rendered.append(out)
        if keys is not None:
            return {"buckets": dict(zip(keys, rendered))}
        return {"buckets": rendered}
    raise AggParsingError(f"unknown aggregation type [{k}]")


def _fmt_edge(v) -> str:
    return "*" if v is None else str(float(v))


def _terms_bucket_predicate(fname: str, key, host_numeric: bool):
    """Membership mask for one terms bucket (top_hits rendering)."""
    if host_numeric:

        def pred(handle):
            col = handle.segment.doc_values.get(fname)
            if col is None:
                return np.zeros(handle.segment.num_docs, dtype=bool)
            with np.errstate(invalid="ignore"):
                return col == key

        return pred

    def pred(handle):
        member = np.zeros(handle.segment.num_docs, dtype=bool)
        fld = handle.segment.fields.get(fname)
        if fld is not None:
            docs, _ = fld.postings(key)
            member[docs] = True
        return member

    return pred


def _value_range_predicate(fname: str, lo: float, hi: float):
    """Membership mask for a [lo, hi) value window (histogram/range
    top_hits rendering); NaN (missing) never matches."""

    def pred(handle):
        col = handle.segment.doc_values.get(fname)
        if col is None:
            return np.zeros(handle.segment.num_docs, dtype=bool)
        with np.errstate(invalid="ignore"):
            return (col >= lo) & (col < hi)

    return pred


def _render_histogram(
    node: AggNode, state, engine, plan, index_name: str = "index"
) -> dict[str, Any]:
    fname = node.params["field"]
    min_doc_count = int(node.params.get("min_doc_count", 0))
    is_date = node.kind == "date_histogram"
    edges = plan.get("hist_edges", {}).get(id(node))
    buckets = []
    if edges is not None:  # calendar buckets executed as ranges
        counts = state["counts"]
        for i in range(len(edges) - 1):
            count = int(counts[i]) if counts is not None else 0
            buckets.append((edges[i], count, i))
    else:
        params = plan.get("hist_params", {}).get(id(node))
        if params is None:  # no non-empty segments: nothing was planned
            return {"buckets": []}
        interval, offset, base = params
        counts = state["counts"]
        if counts is None:
            counts = np.zeros(0, dtype=np.int64)
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
        if is_date:
            b["key_as_string"] = _iso_utc(key)
            b["key"] = int(key)
        else:
            b["key"] = _key_for_field(engine, fname, key) if float(
                key
            ).is_integer() else float(key)
        b["doc_count"] = count
        if node.subs:
            b.update(_render_array_sub(node, idx, state))
            for sub in node.subs:
                if sub.kind == "top_hits":
                    if edges is not None:
                        lo, hi = edges[idx], edges[idx + 1]
                    else:
                        lo, hi = key, key + interval
                    b[sub.name] = _render_top_hits(
                        sub,
                        state["hits_segments"],
                        index_name,
                        predicate=_value_range_predicate(
                            fname, float(lo), float(hi)
                        ),
                    )
        out.append(b)
    return {"buckets": out}


def _is_calendar(node: AggNode) -> bool:
    """A date_histogram over month / quarter / year edges."""
    unit = node.params.get("calendar_interval") or node.params.get(
        "fixed_interval"
    ) or node.params.get("interval")
    return str(unit) in (
        "month", "1M", "M", "quarter", "1q", "q", "year", "1y", "y"
    )

