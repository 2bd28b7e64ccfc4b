"""can_match shard pre-filtering.

Port copy of elasticsearch_tpu/search/can_match.py, whole.

The coordinator's pre-flight phase (the reference's TransportSearchAction
can-match round, action/search/CanMatchPreFilterSearchPhase.java): before
fanning a query out, each shard's numeric doc-value bounds decide whether
the query can possibly match there; shards that cannot are skipped and
reported in `_shards.skipped`. Deciding is strictly conservative — any
clause the walker doesn't understand counts as "can match".
"""

from __future__ import annotations

import numpy as np

from ..query.dsl import (
    BoolQuery,
    ConstantScoreQuery,
    MatchNoneQuery,
    NestedQuery,
    RangeQuery,
    TermQuery,
)


def shard_bounds(handles) -> dict[str, tuple[float, float]]:
    """(min, max) per numeric doc-values field across a shard's segments.

    Deleted docs are NOT excluded (bounds only ever widen — still
    conservative), mirroring the reference's use of Lucene PointValues
    min/max packed values which ignore liveDocs.
    """
    bounds: dict[str, tuple[float, float]] = {}
    for handle in handles:
        # Cache per handle: segments are immutable, so their bounds are
        # too.
        cached = getattr(handle, "_canmatch_bounds", None)
        if cached is None:
            cached = {}
            for fname, col in handle.segment.doc_values.items():
                finite = col[~np.isnan(col)]
                if len(finite):
                    cached[fname] = (float(finite.min()), float(finite.max()))
            try:
                handle._canmatch_bounds = cached
            except AttributeError:  # frozen handle types: just recompute
                pass
        for fname, (mn, mx) in cached.items():
            cur = bounds.get(fname)
            if cur is None:
                bounds[fname] = (mn, mx)
            else:
                bounds[fname] = (min(cur[0], mn), max(cur[1], mx))
    return bounds


def _range_overlaps(q: RangeQuery, bounds, mappings) -> bool:
    from ..index.mapping import coerce_numeric
    from ..query.compile import _f32_range_bounds

    fm = mappings.get(q.field_name) if mappings is not None else None
    entry = bounds.get(q.field_name)
    if entry is None:
        # No shard doc carries a value: a range/term can never match.
        # (Only safe when the field is known numeric; otherwise stay
        # conservative — the field may be inverted.)
        return not (fm is not None and fm.is_numeric)
    mn, mx = entry
    ftype = fm.type if fm is not None else "double"
    try:
        lo, hi = _f32_range_bounds(
            coerce_numeric(ftype, q.gte) if q.gte is not None else None,
            coerce_numeric(ftype, q.gt) if q.gt is not None else None,
            coerce_numeric(ftype, q.lte) if q.lte is not None else None,
            coerce_numeric(ftype, q.lt) if q.lt is not None else None,
        )
    except ValueError:
        return True  # unparsable bound: let the real search 400
    # Matching happens against f32-QUANTIZED stored values (the compiler's
    # stored-value semantics), so widen the f64 host bounds by one f32 ulp
    # each way before deciding — pruning must never beat quantization.
    mn32 = np.nextafter(np.float32(mn), np.float32(-np.inf))
    mx32 = np.nextafter(np.float32(mx), np.float32(np.inf))
    return not (lo > mx32 or hi < mn32)


def can_match(query, bounds, mappings=None) -> bool:
    """False only when the shard provably has no matching doc."""
    if isinstance(query, MatchNoneQuery):
        return False
    if isinstance(query, RangeQuery):
        return _range_overlaps(query, bounds, mappings)
    if isinstance(query, TermQuery):
        fm = mappings.get(query.field_name) if mappings is not None else None
        if fm is not None and fm.is_numeric:
            return _range_overlaps(
                RangeQuery(query.field_name, gte=query.value, lte=query.value),
                bounds,
                mappings,
            )
        return True
    if isinstance(query, ConstantScoreQuery):
        return can_match(query.filter, bounds, mappings)
    if isinstance(query, NestedQuery):
        return True  # nested bounds live in another doc space
    if isinstance(query, BoolQuery):
        for child in list(query.must) + list(query.filter):
            if not can_match(child, bounds, mappings):
                return False
        if query.should and not query.must and not query.filter:
            if query.minimum_should_match == 0:
                return True  # explicit msm=0: shoulds are optional
            return any(
                can_match(c, bounds, mappings) for c in query.should
            )
        return True
    return True
