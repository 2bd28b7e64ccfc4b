"""Query DSL: typed query builders + JSON parsing.

Port copy of elasticsearch_tpu/query/dsl.py, trimmed to this slice's query
types: `match`, `term`, `terms`, `bool`, `range`, `exists`, `match_all`,
`match_none`, `constant_score` and `script_score` (painless-lite, with
the vector functions: script/painless_lite.py); and the positional
queries `match_phrase`, `match_phrase_prefix`, `span_term`, `span_or`,
`span_near`, `span_first`, `span_not` and `intervals`, with the
flattening rules the compiler shares (`span_unit_terms`,
`span_clause_lists`, `span_not_lists`, `intervals_to_spans`) and the
reference's messages. Any other query type raises the same ValueError
as the reference's `parse_query` (a parsing_exception-shaped 400 at the
REST layer).
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
    raise ValueError(f"unknown query type [{kind}]")
