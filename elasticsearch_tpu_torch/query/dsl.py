"""Query DSL: typed query builders + JSON parsing.

Port copy of elasticsearch_tpu/query/dsl.py, trimmed to this slice's query
types: `match`, `term`, `terms`, `bool`, `range`, `exists`, `match_all`,
`match_none`, `constant_score` and `script_score` (painless-lite, with
the vector functions: script/painless_lite.py). Any other query type
raises the same ValueError as the reference's `parse_query` (a
parsing_exception-shaped 400 at the REST layer).
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
