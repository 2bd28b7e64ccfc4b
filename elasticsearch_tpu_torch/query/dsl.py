"""Query DSL: typed query builders + JSON parsing.

Port copy of elasticsearch_tpu/query/dsl.py, trimmed to this slice's query
types: `match`, `term`, `terms`, `bool`, `range`, `exists`, `match_all`,
`match_none`, `constant_score` and `script_score` (painless-lite, with
the vector functions: script/painless_lite.py); and the positional
queries `match_phrase`, `match_phrase_prefix`, `span_term`, `span_or`,
`span_near`, `span_first`, `span_not` and `intervals`, with the
flattening rules the compiler shares (`span_unit_terms`,
`span_clause_lists`, `span_not_lists`, `intervals_to_spans`) and the
reference's messages; and the structured tail: `multi_match` (types
`best_fields`, `most_fields`, `phrase` and `phrase_prefix`, lowered to
dis_max / bool / the per-field queries as the reference's
`_parse_multi_match` does), `dis_max`, `ids`, `boosting`,
`rank_feature`, `geo_distance` (with `parse_distance_meters`),
`geo_bounding_box`, `terms_set`, `function_score` (`ScoreFunction`,
every function kind) and `nested`. `multi_match` of type `bool_prefix`
needs match_bool_prefix and multi-term expansion, which the port does
not have yet: it is a 400. Any other query type raises the same
ValueError as the reference's `parse_query` (a parsing_exception-shaped
400 at the REST layer).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


class Query:
    """Base class for all query builders."""

    boost: float = 1.0


@dataclass
class MatchQuery(Query):
    """Full-text match: analyzed terms, OR'd (or AND'd) together."""

    field_name: str
    query: str
    operator: str = "or"  # "or" | "and"
    minimum_should_match: int = 0  # 0 = default for the operator
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class TermQuery(Query):
    """Exact (un-analyzed) term match; BM25-scored like Lucene TermQuery."""

    field_name: str
    value: Any
    boost: float = 1.0


@dataclass
class TermsQuery(Query):
    """Disjunction of exact terms, constant score (boost) per hit."""

    field_name: str
    values: list[Any]
    boost: float = 1.0


@dataclass
class RangeQuery(Query):
    """Numeric range over doc values, constant score (boost) per hit."""

    field_name: str
    gte: float | None = None
    gt: float | None = None
    lte: float | None = None
    lt: float | None = None
    boost: float = 1.0


@dataclass
class ExistsQuery(Query):
    """Docs that have any value for the field (constant score)."""

    field_name: str
    boost: float = 1.0


@dataclass
class MatchAllQuery(Query):
    boost: float = 1.0


@dataclass
class MatchNoneQuery(Query):
    boost: float = 1.0


@dataclass
class ConstantScoreQuery(Query):
    """Wraps a filter; every matching doc scores exactly `boost`."""

    filter: Query = None  # type: ignore[assignment]
    boost: float = 1.0


@dataclass
class ScriptScoreQuery(Query):
    """Replace the child query's score with a script-computed one
    (the reference's script_score query, with the painless-lite
    expression subset)."""

    query: Query = None  # type: ignore[assignment]
    source: str = ""
    params: dict = field(default_factory=dict)
    boost: float = 1.0
    min_score: float | None = None


@dataclass
class BoolQuery(Query):
    """Boolean combination with BoolQueryBuilder semantics: must scores and
    is required; filter is required, never scored; should is optional
    unless there is no must/filter (then >= 1 is required by default);
    must_not excludes, never scored."""

    must: list[Query] = field(default_factory=list)
    should: list[Query] = field(default_factory=list)
    filter: list[Query] = field(default_factory=list)
    must_not: list[Query] = field(default_factory=list)
    minimum_should_match: int = -1  # -1 = ES default rule
    boost: float = 1.0


@dataclass
class MatchPhraseQuery(Query):
    """Exact phrase over an analyzed text field's positions
    (MatchPhraseQueryBuilder): the query text analyzes to (term, position)
    pairs, stop-word gaps kept; a doc matches where every term occurs at
    its relative position, and the phrase frequency scores through BM25
    with the summed term idf. slop > 0 is refused, as in the reference."""

    field_name: str
    query: str
    slop: int = 0
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class MatchPhrasePrefixQuery(Query):
    """Phrase whose last term matches as a prefix
    (MatchPhrasePrefixQueryBuilder; Lucene's MultiPhraseQuery over the
    prefix's expansions, capped at max_expansions)."""

    field_name: str
    query: str
    max_expansions: int = 50
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class SpanTermQuery(Query):
    """One term's positions as unit spans (SpanTermQueryBuilder)."""

    field_name: str = ""
    value: str = ""
    boost: float = 1.0


@dataclass
class SpanOrQuery(Query):
    """Union of span clauses (SpanOrQueryBuilder)."""

    clauses: list[Query] = field(default_factory=list)
    boost: float = 1.0


@dataclass
class SpanNearQuery(Query):
    """Clauses within `slop` of each other (SpanNearQueryBuilder), over
    unit-span clauses of ONE field. Ordered: p1 < p2 < ... < pn with
    pn - p1 - (n - 1) <= slop; unordered for at most two clauses."""

    clauses: list[Query] = field(default_factory=list)
    slop: int = 0
    in_order: bool = True
    boost: float = 1.0


@dataclass
class SpanFirstQuery(Query):
    """Spans ending within the first `end` positions
    (SpanFirstQueryBuilder)."""

    match: Query = None  # type: ignore[assignment]
    end: int = 0
    boost: float = 1.0


@dataclass
class SpanNotQuery(Query):
    """Include spans with no exclude span within [pos - pre, pos + post]
    (SpanNotQueryBuilder); both sides unit-span producers."""

    include: Query = None  # type: ignore[assignment]
    exclude: Query = None  # type: ignore[assignment]
    pre: int = 0
    post: int = 0
    boost: float = 1.0


@dataclass
class IntervalsQuery(Query):
    """Interval matching over analyzed positions (IntervalQueryBuilder):
    the match, all_of, any_of and prefix sources, lowered onto the
    unit-span programs."""

    field_name: str = ""
    rule: dict = field(default_factory=dict)
    boost: float = 1.0


def span_unit_terms(q) -> tuple[str, list[str]]:
    """(field, term list) of a unit-span producer (span_term / span_or of
    span_terms), the one flattening rule of the compiler; compound spans
    inside compounds are rejected."""
    if isinstance(q, SpanTermQuery):
        return q.field_name, [q.value]
    if isinstance(q, SpanOrQuery):
        fields, terms = set(), []
        for c in q.clauses:
            f, ts = span_unit_terms(c)
            fields.add(f)
            terms.extend(ts)
        if len(fields) != 1:
            raise ValueError("[span_or] clauses must all target the same field")
        return fields.pop(), terms
    raise ValueError(
        "only span_term / span_or clauses are supported inside "
        f"span compounds, got [{type(q).__name__}]"
    )


def span_clause_lists(clauses) -> tuple[str, list[list[str]]]:
    """span_near clauses as per-clause term lists, one field."""
    fields, out = set(), []
    for c in clauses:
        f, ts = span_unit_terms(c)
        fields.add(f)
        out.append(ts)
    if len(fields) != 1:
        raise ValueError("[span_near] clauses must all target the same field")
    return fields.pop(), out


def span_not_lists(include, exclude) -> tuple[str, list[str], list[str]]:
    """span_not's include and exclude term lists, one field."""
    fi, inc = span_unit_terms(include)
    fe, exc = span_unit_terms(exclude)
    if fi != fe:
        raise ValueError(
            "[span_not] include and exclude must target the same field"
        )
    return fi, inc, exc


def _parse_span(body: dict[str, Any]) -> Query:
    q = parse_query(body)
    if not isinstance(
        q, (SpanTermQuery, SpanOrQuery, SpanNearQuery, SpanFirstQuery, SpanNotQuery)
    ):
        raise ValueError(
            f"span clauses must be span queries, got [{next(iter(body))}]"
        )
    return q


def intervals_to_spans(
    field_name: str, rule: dict, analyzer, expand_prefix
) -> tuple[list[list[str]], int, bool]:
    """(clause term lists, slop, ordered) of an intervals rule;
    `expand_prefix(prefix)` supplies the dictionary expansion. max_gaps is
    the span slop (total stretch between unit spans); -1 is unlimited."""
    if not isinstance(rule, dict) or len(rule) != 1:
        raise ValueError("[intervals] requires exactly one source")
    ((kind, params),) = rule.items()
    params = params or {}

    def unit_terms(sub_rule) -> list[str]:
        ((skind, sparams),) = sub_rule.items()
        sparams = sparams or {}
        if skind == "match":
            terms = analyzer.analyze(str(sparams.get("query", "")))
            if len(terms) != 1:
                raise ValueError(
                    "[intervals] sub-sources must analyze to one term"
                )
            return terms
        if skind == "prefix":
            return expand_prefix(str(sparams.get("prefix", "")))
        if skind == "any_of":
            out: list[str] = []
            for sub in sparams.get("intervals", []):
                out.extend(unit_terms(sub))
            return out
        raise ValueError(
            f"[intervals] unsupported sub-source [{skind}]"
        )

    unlimited = 1 << 28
    if kind == "match":
        terms = analyzer.analyze(str(params.get("query", "")))
        clauses = [[t] for t in terms]
        max_gaps = int(params.get("max_gaps", -1))
        ordered = bool(params.get("ordered", False))
    elif kind == "all_of":
        clauses = [unit_terms(sub) for sub in params.get("intervals", [])]
        max_gaps = int(params.get("max_gaps", -1))
        ordered = bool(params.get("ordered", False))
    elif kind in ("any_of", "prefix"):
        clauses = [unit_terms({kind: params})]
        max_gaps, ordered = -1, True
    else:
        raise ValueError(f"[intervals] unsupported source [{kind}]")
    if not clauses:
        return [], 0, True
    if not ordered and len(clauses) > 2:
        raise ValueError(
            "[intervals] unordered matching beyond 2 clauses is not "
            "supported"
        )
    slop = unlimited if max_gaps < 0 else max_gaps
    return clauses, slop, ordered


@dataclass
class ScoreFunction:
    """One function of a function_score query (WeightBuilder,
    FieldValueFactorFunctionBuilder, ScriptScoreFunctionBuilder,
    RandomScoreFunctionBuilder, the decay family). `weight` multiplies
    the function's value; a bare weight-only entry has kind "weight"."""

    kind: str  # weight | field_value_factor | script_score | random_score
    #           | gauss | exp | linear
    filter: "Query | None" = None
    weight: float | None = None
    # script_score (declared before the `field` attribute below, which
    # shadows dataclasses.field for the rest of the body)
    source: str = ""
    params: dict = field(default_factory=dict)
    # random_score
    seed: int = 0
    # field_value_factor / decay target
    field: str | None = None
    factor: float = 1.0
    modifier: str = "none"
    missing: float | None = None
    # decay
    origin: float = 0.0
    scale: float = 1.0
    offset: float = 0.0
    decay: float = 0.5


@dataclass
class FunctionScoreQuery(Query):
    """Modify the child query's score with (optionally filtered) functions
    (FunctionScoreQueryBuilder): score_mode combines the function values,
    the result is capped at max_boost, boost_mode merges it with the
    query score, and min_score finally filters."""

    query: Query = None  # type: ignore[assignment]
    functions: list[ScoreFunction] = field(default_factory=list)
    score_mode: str = "multiply"
    boost_mode: str = "multiply"
    max_boost: float = 3.4028235e38  # FLT_MAX, the reference default
    min_score: float | None = None
    boost: float = 1.0


@dataclass
class IdsQuery(Query):
    """Docs whose _id is in the given set (IdsQueryBuilder); constant score."""

    values: list[str] = field(default_factory=list)
    boost: float = 1.0


@dataclass
class DisMaxQuery(Query):
    """Disjunction-max: score = max(children) + tie_breaker * (sum - max)
    over matching children (DisMaxQueryBuilder)."""

    queries: list[Query] = field(default_factory=list)
    tie_breaker: float = 0.0
    boost: float = 1.0


@dataclass
class BoostingQuery(Query):
    """Demote (not exclude) docs matching `negative`: positive matches
    keep their score, those also matching negative multiply by
    negative_boost (BoostingQueryBuilder)."""

    positive: Query = None  # type: ignore[assignment]
    negative: Query = None  # type: ignore[assignment]
    negative_boost: float = 0.0
    boost: float = 1.0


@dataclass
class TermsSetQuery(Query):
    """Docs containing at least N of the given terms, N per doc from a
    numeric field or a script (TermsSetQueryBuilder / Lucene
    CoveringQuery); scores as the BM25 sum over the matching terms."""

    field_name: str = ""
    terms: list[str] = field(default_factory=list)
    minimum_should_match_field: str | None = None
    minimum_should_match_script: str | None = None
    script_params: dict[str, Any] = field(default_factory=dict)
    boost: float = 1.0


@dataclass
class RankFeatureQuery(Query):
    """Score docs by a rank_feature column through saturation / log /
    sigmoid (RankFeatureQueryBuilder)."""

    field_name: str = ""
    function: str = "saturation"  # saturation | log | sigmoid
    pivot: float | None = None
    scaling_factor: float = 1.0
    exponent: float = 1.0
    boost: float = 1.0


def parse_distance_meters(value) -> float:
    """"200km" / "5mi" / "1000m" / bare meters -> meters
    (common/unit/DistanceUnit); the longest suffix is tried first."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    units = [
        ("nmi", 1852.0), ("km", 1000.0), ("mi", 1609.344), ("yd", 0.9144),
        ("ft", 0.3048), ("cm", 0.01), ("mm", 0.001), ("m", 1.0),
    ]
    for suffix, factor in units:
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * factor
    return float(s)


@dataclass
class GeoDistanceQuery(Query):
    """Docs within `distance` meters of a center point
    (GeoDistanceQueryBuilder; haversine arc distance)."""

    field_name: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0
    boost: float = 1.0


@dataclass
class GeoBoundingBoxQuery(Query):
    """Docs inside a lat/lon box (GeoBoundingBoxQueryBuilder); boxes may
    cross the antimeridian."""

    field_name: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0
    boost: float = 1.0


@dataclass
class NestedQuery(Query):
    """Query over one nested path's hidden sub-documents, joined to parents
    with a per-parent score reduction (NestedQueryBuilder lowering to
    ToParentBlockJoinQuery + ScoreMode)."""

    path: str = ""
    query: Query = None  # type: ignore[assignment]
    score_mode: str = "avg"  # avg | sum | max | min | none
    ignore_unmapped: bool = False
    boost: float = 1.0


def _pop_boost(body: dict) -> float:
    return float(body.get("boost", 1.0))


def _single_field(kind: str, spec: dict) -> tuple[str, Any]:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise ValueError(f"[{kind}] expects exactly one field, got: {spec!r}")
    return next(iter(spec.items()))


def parse_query(body: dict[str, Any]) -> Query:
    """Parse an Elasticsearch-style query JSON body into a Query tree;
    raises ValueError on unknown queries (the reference's
    parsing_exception behaviour)."""
    if not isinstance(body, dict) or len(body) != 1:
        raise ValueError(
            "query body must be an object with exactly one query clause, "
            f"got: {body!r}"
        )
    kind, spec = next(iter(body.items()))

    if kind == "match_all":
        return MatchAllQuery(boost=_pop_boost(spec or {}))
    if kind == "match_none":
        return MatchNoneQuery()
    if kind == "match":
        fname, val = _single_field(kind, spec)
        if isinstance(val, dict):
            return MatchQuery(
                field_name=fname,
                query=str(val["query"]),
                operator=str(val.get("operator", "or")).lower(),
                minimum_should_match=int(val.get("minimum_should_match", 0)),
                analyzer=val.get("analyzer"),
                boost=_pop_boost(val),
            )
        return MatchQuery(field_name=fname, query=str(val))
    if kind == "term":
        fname, val = _single_field(kind, spec)
        if isinstance(val, dict):
            return TermQuery(fname, val["value"], boost=_pop_boost(val))
        return TermQuery(fname, val)
    if kind == "terms":
        spec = dict(spec)
        boost = _pop_boost(spec)
        spec.pop("boost", None)
        if len(spec) != 1:
            raise ValueError(f"[terms] expects exactly one field, got {spec}")
        fname, values = next(iter(spec.items()))
        return TermsQuery(fname, list(values), boost=boost)
    if kind == "range":
        fname, val = _single_field(kind, spec)
        return RangeQuery(
            field_name=fname,
            gte=val.get("gte"),
            gt=val.get("gt"),
            lte=val.get("lte"),
            lt=val.get("lt"),
            boost=_pop_boost(val),
        )
    if kind == "exists":
        return ExistsQuery(spec["field"], boost=_pop_boost(spec))
    if kind == "constant_score":
        return ConstantScoreQuery(
            filter=parse_query(spec["filter"]), boost=_pop_boost(spec)
        )
    if kind == "script_score":
        script = spec.get("script", {})
        return ScriptScoreQuery(
            query=parse_query(spec["query"]),
            source=str(script.get("source", "")),
            params=dict(script.get("params", {})),
            boost=_pop_boost(spec),
            min_score=spec.get("min_score"),
        )
    if kind == "intervals":
        fname, rule = _single_field(kind, spec)
        if not isinstance(rule, dict):
            raise ValueError("[intervals] requires a source object")
        rule = dict(rule)
        boost = _pop_boost(rule)
        rule.pop("boost", None)
        return IntervalsQuery(field_name=fname, rule=rule, boost=boost)
    if kind == "span_term":
        fname, val = _single_field(kind, spec)
        if isinstance(val, dict):
            return SpanTermQuery(fname, str(val["value"]), boost=_pop_boost(val))
        return SpanTermQuery(fname, str(val))
    if kind == "span_or":
        clauses = [_parse_span(c) for c in spec.get("clauses", [])]
        if not clauses:
            raise ValueError("[span_or] requires [clauses]")
        return SpanOrQuery(clauses=clauses, boost=_pop_boost(spec))
    if kind == "span_near":
        clauses = [_parse_span(c) for c in spec.get("clauses", [])]
        if not clauses:
            raise ValueError("[span_near] requires [clauses]")
        in_order = bool(spec.get("in_order", True))
        if not in_order and len(clauses) > 2:
            raise ValueError(
                "[span_near] with in_order=false supports at most 2 clauses"
            )
        return SpanNearQuery(
            clauses=clauses,
            slop=int(spec.get("slop", 0)),
            in_order=in_order,
            boost=_pop_boost(spec),
        )
    if kind == "span_first":
        if "match" not in spec or "end" not in spec:
            raise ValueError("[span_first] requires [match] and [end]")
        end = int(spec["end"])
        if end < 0:
            raise ValueError("[span_first] requires [end] to be non-negative")
        return SpanFirstQuery(
            match=_parse_span(spec["match"]),
            end=end,
            boost=_pop_boost(spec),
        )
    if kind == "span_not":
        if "include" not in spec or "exclude" not in spec:
            raise ValueError("[span_not] requires [include] and [exclude]")
        dist = int(spec.get("dist", 0))
        return SpanNotQuery(
            include=_parse_span(spec["include"]),
            exclude=_parse_span(spec["exclude"]),
            pre=int(spec.get("pre", dist)),
            post=int(spec.get("post", dist)),
            boost=_pop_boost(spec),
        )
    if kind == "match_phrase":
        fname, val = _single_field(kind, spec)
        if isinstance(val, dict):
            return MatchPhraseQuery(
                field_name=fname,
                query=str(val["query"]),
                slop=int(val.get("slop", 0)),
                analyzer=val.get("analyzer"),
                boost=_pop_boost(val),
            )
        return MatchPhraseQuery(field_name=fname, query=str(val))
    if kind == "match_phrase_prefix":
        fname, val = _single_field(kind, spec)
        if isinstance(val, dict):
            return MatchPhrasePrefixQuery(
                field_name=fname,
                query=str(val["query"]),
                max_expansions=int(val.get("max_expansions", 50)),
                analyzer=val.get("analyzer"),
                boost=_pop_boost(val),
            )
        return MatchPhrasePrefixQuery(field_name=fname, query=str(val))
    if kind == "bool":
        def _clauses(key: str) -> list[Query]:
            raw = spec.get(key, [])
            if isinstance(raw, dict):
                raw = [raw]
            return [parse_query(c) for c in raw]

        return BoolQuery(
            must=_clauses("must"),
            should=_clauses("should"),
            filter=_clauses("filter"),
            must_not=_clauses("must_not"),
            minimum_should_match=int(spec.get("minimum_should_match", -1)),
            boost=_pop_boost(spec),
        )
    if kind == "multi_match":
        return _parse_multi_match(spec)
    if kind == "dis_max":
        return DisMaxQuery(
            queries=[parse_query(q) for q in spec.get("queries", [])],
            tie_breaker=float(spec.get("tie_breaker", 0.0)),
            boost=_pop_boost(spec),
        )
    if kind == "ids":
        return IdsQuery(
            values=[str(v) for v in spec.get("values", [])],
            boost=_pop_boost(spec),
        )
    if kind == "boosting":
        for req in ("positive", "negative", "negative_boost"):
            if req not in spec:
                raise ValueError(f"[boosting] requires [{req}]")
        return BoostingQuery(
            positive=parse_query(spec["positive"]),
            negative=parse_query(spec["negative"]),
            negative_boost=float(spec["negative_boost"]),
            boost=_pop_boost(spec),
        )
    if kind == "rank_feature":
        return _parse_rank_feature(spec)
    if kind == "geo_distance":
        return _parse_geo_distance(spec)
    if kind == "geo_bounding_box":
        return _parse_geo_box(spec)
    if kind == "terms_set":
        return _parse_terms_set(spec)
    if kind == "function_score":
        return _parse_function_score(spec)
    if kind == "nested":
        if "path" not in spec or "query" not in spec:
            raise ValueError("[nested] requires [path] and [query]")
        score_mode = str(spec.get("score_mode", "avg")).lower()
        if score_mode not in ("avg", "sum", "max", "min", "none"):
            raise ValueError(f"[nested] unknown score_mode [{score_mode}]")
        return NestedQuery(
            path=str(spec["path"]),
            query=parse_query(spec["query"]),
            score_mode=score_mode,
            ignore_unmapped=bool(spec.get("ignore_unmapped", False)),
            boost=_pop_boost(spec),
        )
    raise ValueError(f"unknown query type [{kind}]")


def _parse_rank_feature(spec: dict) -> RankFeatureQuery:
    if "field" not in spec:
        raise ValueError("[rank_feature] requires [field]")
    fns = [f for f in ("saturation", "log", "sigmoid") if f in spec]
    if len(fns) > 1:
        raise ValueError("[rank_feature] accepts at most one scoring function")
    fn = fns[0] if fns else "saturation"
    params = spec.get(fn) or {}
    if fn == "log" and "scaling_factor" not in params:
        raise ValueError("[rank_feature] [log] requires [scaling_factor]")
    if fn == "sigmoid" and ("pivot" not in params or "exponent" not in params):
        raise ValueError(
            "[rank_feature] [sigmoid] requires [pivot] and [exponent]"
        )
    return RankFeatureQuery(
        field_name=str(spec["field"]),
        function=fn,
        pivot=float(params["pivot"]) if "pivot" in params else None,
        scaling_factor=float(params.get("scaling_factor", 1.0)),
        exponent=float(params.get("exponent", 1.0)),
        boost=_pop_boost(spec),
    )


def _parse_geo_distance(spec: dict) -> GeoDistanceQuery:
    from ..index.segment import parse_geo_point

    spec = dict(spec)
    boost = _pop_boost(spec)
    spec.pop("boost", None)
    distance = spec.pop("distance", None)
    spec.pop("distance_type", None)
    spec.pop("validation_method", None)
    if distance is None or len(spec) != 1:
        raise ValueError("[geo_distance] requires [distance] and exactly one field")
    ((fname, point),) = spec.items()
    lat, lon = parse_geo_point(point)
    return GeoDistanceQuery(
        field_name=fname, lat=lat, lon=lon,
        distance_m=parse_distance_meters(distance), boost=boost,
    )


def _parse_geo_box(spec: dict) -> GeoBoundingBoxQuery:
    from ..index.segment import parse_geo_point

    spec = dict(spec)
    boost = _pop_boost(spec)
    spec.pop("boost", None)
    spec.pop("validation_method", None)
    if len(spec) != 1:
        raise ValueError("[geo_bounding_box] requires exactly one field")
    ((fname, box),) = spec.items()
    if "top_left" in box and "bottom_right" in box:
        top, left = parse_geo_point(box["top_left"])
        bottom, right = parse_geo_point(box["bottom_right"])
    else:
        top = float(box["top"])
        left = float(box["left"])
        bottom = float(box["bottom"])
        right = float(box["right"])
    return GeoBoundingBoxQuery(
        field_name=fname, top=top, left=left, bottom=bottom, right=right,
        boost=boost,
    )


def _parse_terms_set(spec: dict) -> TermsSetQuery:
    fname, val = _single_field("terms_set", spec)
    if not isinstance(val, dict) or "terms" not in val:
        raise ValueError("[terms_set] requires [terms]")
    msm_field = val.get("minimum_should_match_field")
    script = val.get("minimum_should_match_script")
    src = params = None
    if script is not None:
        src = script.get("source") if isinstance(script, dict) else str(script)
        params = dict(script.get("params", {})) if isinstance(script, dict) else {}
    if (msm_field is None) == (src is None):
        raise ValueError(
            "[terms_set] requires exactly one of "
            "[minimum_should_match_field] or [minimum_should_match_script]"
        )
    return TermsSetQuery(
        field_name=fname,
        terms=[str(t) for t in val["terms"]],
        minimum_should_match_field=msm_field,
        minimum_should_match_script=src,
        script_params=params or {},
        boost=_pop_boost(val),
    )


_DECAY_KINDS = ("gauss", "exp", "linear")
_FN_KINDS = (
    "weight", "field_value_factor", "script_score", "random_score",
) + _DECAY_KINDS
_FVF_MODIFIERS = (
    "none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
    "square", "sqrt", "reciprocal",
)


def _parse_one_function(entry: dict) -> ScoreFunction:
    entry = dict(entry)
    filt = parse_query(entry.pop("filter")) if "filter" in entry else None
    weight = entry.pop("weight", None)
    weight = float(weight) if weight is not None else None
    kinds = [k for k in entry if k in _FN_KINDS]
    if len(kinds) > 1:
        raise ValueError(
            "failed to parse [function_score]: an entry may define at most "
            f"one score function, got {kinds}"
        )
    if not kinds:
        if weight is None:
            raise ValueError(
                "failed to parse [function_score]: an entry must have a "
                "function or a weight"
            )
        return ScoreFunction(kind="weight", filter=filt, weight=weight)
    kind = kinds[0]
    body = entry[kind] or {}
    if not isinstance(body, dict):
        raise ValueError(
            f"failed to parse [function_score]: [{kind}] body must be an "
            f"object, got {type(body).__name__}"
        )
    if kind == "field_value_factor":
        if "field" not in body:
            raise ValueError("[field_value_factor] requires a [field]")
        modifier = str(body.get("modifier", "none")).lower()
        if modifier not in _FVF_MODIFIERS:
            raise ValueError(
                f"Illegal value for field_value_factor modifier [{modifier}]"
            )
        missing = body.get("missing")
        return ScoreFunction(
            kind=kind, filter=filt, weight=weight, field=str(body["field"]),
            factor=float(body.get("factor", 1.0)), modifier=modifier,
            missing=float(missing) if missing is not None else None,
        )
    if kind == "script_score":
        script = body.get("script", {})
        if isinstance(script, str):
            script = {"source": script}
        return ScoreFunction(
            kind=kind, filter=filt, weight=weight,
            source=str(script.get("source", "")),
            params=dict(script.get("params", {})),
        )
    if kind == "random_score":
        return ScoreFunction(
            kind=kind, filter=filt, weight=weight,
            seed=int(body.get("seed", 0)),
        )
    # decay family: {"gauss": {"<field>": {origin, scale, offset, decay}}}
    decay_body = dict(body)
    if len(decay_body) != 1:
        raise ValueError(
            f"[{kind}] expects exactly one field, got {sorted(decay_body)}"
        )
    fname, dspec = next(iter(decay_body.items()))
    if not isinstance(dspec, dict):
        raise ValueError(
            f"[{kind}] on [{fname}] must be an object with origin/scale"
        )
    if "scale" not in dspec:
        raise ValueError(f"[{kind}] on [{fname}] requires [scale]")
    return ScoreFunction(
        kind=kind, filter=filt, weight=weight, field=str(fname),
        origin=float(dspec.get("origin", 0.0)),
        scale=float(dspec["scale"]),
        offset=float(dspec.get("offset", 0.0)),
        decay=float(dspec.get("decay", 0.5)),
    )


def _parse_function_score(spec: dict) -> FunctionScoreQuery:
    spec = dict(spec)
    boost = _pop_boost(spec)
    child = parse_query(spec["query"]) if "query" in spec else MatchAllQuery()
    functions = [_parse_one_function(e) for e in spec.get("functions", [])]
    # Single-function shorthand at the top level (a bare weight included).
    shorthand = {k: v for k, v in spec.items() if k in _FN_KINDS}
    if shorthand and functions:
        raise ValueError(
            "failed to parse [function_score]: use [functions] or a single "
            "inline function, not both"
        )
    if shorthand:
        functions = [_parse_one_function(dict(shorthand))]
    score_mode = str(spec.get("score_mode", "multiply")).lower()
    boost_mode = str(spec.get("boost_mode", "multiply")).lower()
    if score_mode not in ("multiply", "sum", "avg", "first", "max", "min"):
        raise ValueError(f"illegal score_mode [{score_mode}]")
    if boost_mode not in ("multiply", "replace", "sum", "avg", "max", "min"):
        raise ValueError(f"illegal boost_mode [{boost_mode}]")
    min_score = spec.get("min_score")
    return FunctionScoreQuery(
        query=child,
        functions=functions,
        score_mode=score_mode,
        boost_mode=boost_mode,
        max_boost=float(spec.get("max_boost", 3.4028235e38)),
        min_score=float(min_score) if min_score is not None else None,
        boost=boost,
    )


def _parse_multi_match(spec: dict) -> Query:
    """multi_match -> per-field queries, as MultiMatchQueryBuilder
    dispatches its type: best_fields = dis_max with tie_breaker,
    most_fields = bool should (scores sum), phrase / phrase_prefix =
    dis_max over per-field phrase queries."""
    text = str(spec.get("query", ""))
    raw_fields = spec.get("fields")
    if not raw_fields:
        raise ValueError("[multi_match] requires [fields]")
    if isinstance(raw_fields, str):
        raw_fields = [raw_fields]
    mm_type = str(spec.get("type", "best_fields"))
    if mm_type not in (
        "best_fields", "most_fields", "phrase", "phrase_prefix",
        "bool_prefix",
    ):
        # cross_fields blends term statistics across fields: rejected, as
        # the reference rejects it.
        raise ValueError(f"multi_match type [{mm_type}] is not supported yet")
    if mm_type == "bool_prefix":
        raise ValueError(
            "multi_match type [bool_prefix] is not supported by this port"
        )
    boost = _pop_boost(spec)
    tie = float(
        spec.get("tie_breaker", 0.0 if mm_type != "most_fields" else 1.0)
    )
    operator = str(spec.get("operator", "or")).lower()
    fields: list[tuple[str, float]] = []
    for f in raw_fields:
        if "^" in f:
            name, _, b = f.partition("^")
            fields.append((name, float(b)))
        else:
            fields.append((f, 1.0))
    per_field: list[Query] = []
    for name, fboost in fields:
        if mm_type == "phrase":
            per_field.append(MatchPhraseQuery(name, text, boost=fboost))
        elif mm_type == "phrase_prefix":
            per_field.append(MatchPhrasePrefixQuery(name, text, boost=fboost))
        else:
            per_field.append(
                MatchQuery(name, text, operator=operator, boost=fboost)
            )
    if len(per_field) == 1:
        q = per_field[0]
        q.boost *= boost
        return q
    if mm_type == "most_fields":
        return BoolQuery(should=per_field, boost=boost)
    return DisMaxQuery(queries=per_field, tie_breaker=tie, boost=boost)
