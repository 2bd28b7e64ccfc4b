"""Text analysis: tokenizers, token filters, analyzers.

Port copy of elasticsearch_tpu/analysis/analyzers.py, trimmed to this
slice: the `standard`, `whitespace` and `keyword` analyzers and an
`AnalysisRegistry` that builds custom analyzers from those tokenizers and
the lowercase / stop / asciifolding filters, and position analysis
(`Analyzer._carry_filters` and `analyze_positions`: the (token, position)
pairs of phrase and span queries, stop words leaving gaps). Left out: the
analysis-call metrics counter, offset analysis (highlighting), porter
stemming and the english / search_as_you_type chains.

Analysis runs on the host at index and query time; the only contract that
matters for score parity is that index-time and query-time analysis agree,
and that both agree with the reference's.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

Token = str
TokenFilter = Callable[[list[Token]], list[Token]]

# Unicode word pattern: letters/digits/underscore runs (the reference's
# approximation of Lucene's UAX#29 standard tokenizer).
_WORD_RE = re.compile(r"[\w]+", re.UNICODE)

# Lucene's default English stopword set (org.apache.lucene.analysis.en).
ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


@dataclass
class Analyzer:
    """A tokenizer plus an ordered chain of token filters."""

    name: str
    tokenizer: Callable[[str], list[Token]]
    filters: list[TokenFilter] = field(default_factory=list)

    def analyze(self, text: str) -> list[Token]:
        tokens = self.tokenizer(text)
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def __call__(self, text: str) -> list[Token]:
        return self.analyze(text)

    def _carry_filters(
        self, items: list[tuple[Token, Any]]
    ) -> list[tuple[Token, Any]]:
        """Thread (token, payload) pairs through the filter chain, keeping
        each surviving token's payload (here a position).

        Three filter shapes: marked drop filters (a `stopset` attribute)
        keep gaps; length-preserving outputs are 1:1 order-preserving
        maps; anything else is applied token by token."""
        for f in self.filters:
            stopset = getattr(f, "stopset", None)
            if stopset is not None:
                items = [it for it in items if it[0] not in stopset]
                continue
            mapped = f([tok for tok, _ in items])
            if len(mapped) == len(items):
                items = [(m, p) for m, (_, p) in zip(mapped, items)]
                continue
            out = []
            for tok, p in items:
                r = f([tok])
                if r:
                    out.append((r[0], p))
            items = out
        return items

    def analyze_positions(self, text: str) -> tuple[list[tuple[Token, int]], int]:
        """((token, position) pairs, total position span).

        A token removed by a stop filter leaves a GAP rather than shifting
        later tokens down (Lucene's position increments), which
        `match_phrase` relies on. The span is the tokenizer's position
        count (the base of a multi-valued field's next value)."""
        tokens = self.tokenizer(text)
        pairs = self._carry_filters([(t, i) for i, t in enumerate(tokens)])
        return pairs, len(tokens)


def _standard_tokenize(text: str) -> list[Token]:
    return _WORD_RE.findall(text)


def _whitespace_tokenize(text: str) -> list[Token]:
    return text.split()


def _keyword_tokenize(text: str) -> list[Token]:
    return [text] if text else []


def lowercase_filter(tokens: list[Token]) -> list[Token]:
    return [t.lower() for t in tokens]


def make_stop_filter(stopwords: Iterable[str]) -> TokenFilter:
    stopset = frozenset(stopwords)

    def stop_filter(tokens: list[Token]) -> list[Token]:
        return [t for t in tokens if t not in stopset]

    # Marks a pure drop filter: position analysis keeps its gaps.
    stop_filter.stopset = stopset
    return stop_filter


def asciifolding_filter(tokens: list[Token]) -> list[Token]:
    out = []
    for t in tokens:
        norm = unicodedata.normalize("NFKD", t)
        out.append("".join(c for c in norm if not unicodedata.combining(c)))
    return out


StandardAnalyzer = Analyzer("standard", _standard_tokenize, [lowercase_filter])
WhitespaceAnalyzer = Analyzer("whitespace", _whitespace_tokenize, [])
KeywordAnalyzer = Analyzer("keyword", _keyword_tokenize, [])

_BUILTIN = {
    a.name: a for a in (StandardAnalyzer, WhitespaceAnalyzer, KeywordAnalyzer)
}


class AnalysisRegistry:
    """Per-index analyzer registry: built-ins by name plus custom analyzers
    from a settings dict ({"tokenizer": ..., "filter": [...]})."""

    _TOKENIZERS = {
        "standard": _standard_tokenize,
        "whitespace": _whitespace_tokenize,
        "keyword": _keyword_tokenize,
    }
    _FILTERS = {
        "lowercase": lowercase_filter,
        "stop": make_stop_filter(ENGLISH_STOPWORDS),
        "asciifolding": asciifolding_filter,
    }

    def __init__(self, custom: dict[str, dict] | None = None):
        self._analyzers: dict[str, Analyzer] = dict(_BUILTIN)
        for name, spec in (custom or {}).items():
            self._analyzers[name] = self._build(name, spec)

    def _build(self, name: str, spec: dict) -> Analyzer:
        tokenizer_name = spec.get("tokenizer", "standard")
        try:
            tokenizer = self._TOKENIZERS[tokenizer_name]
        except KeyError:
            raise ValueError(f"unknown tokenizer [{tokenizer_name}]") from None
        filters: list[TokenFilter] = []
        for fname in spec.get("filter", []):
            try:
                filters.append(self._FILTERS[fname])
            except KeyError:
                raise ValueError(f"unknown token filter [{fname}]") from None
        return Analyzer(name, tokenizer, filters)

    def get(self, name: str) -> Analyzer:
        try:
            return self._analyzers[name]
        except KeyError:
            raise ValueError(f"unknown analyzer [{name}]") from None
