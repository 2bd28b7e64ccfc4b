"""Field mappings: the schema of an index.

Port copy of elasticsearch_tpu/index/mapping.py, trimmed to this slice:
`text`, `keyword` and the numeric types `long`, `integer`, `float` and
`double`, multi-fields (the dynamic `text` + `.keyword` pair) and dynamic
mapping of unseen fields from JSON value types. Left out: objects and
nested scopes, dates, booleans, vectors, geo, completion and the other
mapper-extras types, dynamic templates and `to_json` round-trips; any
such field is rejected at mapping or index time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..analysis.analyzers import AnalysisRegistry

TEXT = "text"
KEYWORD = "keyword"
LONG = "long"
INTEGER = "integer"
FLOAT = "float"
DOUBLE = "double"

NUMERIC_TYPES = {LONG, INTEGER, FLOAT, DOUBLE}
INVERTED_TYPES = {TEXT, KEYWORD}
ALL_TYPES = NUMERIC_TYPES | INVERTED_TYPES


def coerce_numeric(field_type: str, value: Any) -> float:
    """Coerce a query/document value to the numeric column representation
    (numeric strings parse; anything else raises ValueError)."""
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    return float(value)


@dataclass
class FieldMapping:
    name: str
    type: str
    analyzer: str = "standard"
    search_analyzer: str | None = None
    index: bool = True
    norms: bool | None = None  # None -> type default (text: True, keyword: False)
    fields: dict[str, "FieldMapping"] = field(default_factory=dict)
    ignore_above: int = 0  # keyword: longer values are not indexed

    def __post_init__(self):
        if self.type not in ALL_TYPES:
            raise ValueError(
                f"No handler for type [{self.type}] on field [{self.name}]"
            )
        if self.type == KEYWORD:
            self.analyzer = "keyword"
        if self.search_analyzer is None:
            self.search_analyzer = self.analyzer
        if self.norms is None:
            self.norms = self.type == TEXT

    @property
    def is_inverted(self) -> bool:
        return self.type in INVERTED_TYPES and self.index

    @property
    def is_numeric(self) -> bool:
        return self.type in NUMERIC_TYPES


class Mappings:
    """Parsed `mappings` for one index, with dynamic-mapping support:
    unmapped fields map on first sight from their JSON type (string ->
    text + .keyword, int -> long, float -> double)."""

    def __init__(
        self,
        properties: dict[str, dict[str, Any]] | None = None,
        analysis: AnalysisRegistry | None = None,
        dynamic: bool = True,
    ):
        self.fields: dict[str, FieldMapping] = {}
        self.analysis = analysis or AnalysisRegistry()
        self.dynamic = dynamic
        for name, spec in (properties or {}).items():
            self.fields[name] = self._parse_field(name, spec)

    @classmethod
    def _parse_field(cls, name: str, spec: dict[str, Any]) -> FieldMapping:
        if "properties" in spec:
            raise ValueError(
                f"object field [{name}] is not supported by this port"
            )
        norms = spec.get("norms")
        subs = {}
        for sub_name, sub_spec in (spec.get("fields") or {}).items():
            if sub_spec.get("fields"):
                raise ValueError(
                    f"cannot nest multi-fields inside multi-field "
                    f"[{name}.{sub_name}]"
                )
            subs[sub_name] = cls._parse_field(f"{name}.{sub_name}", sub_spec)
        return FieldMapping(
            name=name,
            type=spec.get("type", TEXT),
            analyzer=spec.get("analyzer", "standard"),
            search_analyzer=spec.get("search_analyzer"),
            index=bool(spec.get("index", True)),
            norms=None if norms is None else bool(norms),
            fields=subs,
            ignore_above=int(spec.get("ignore_above", 0)),
        )

    @classmethod
    def from_json(cls, mappings_json: dict[str, Any] | None, **kw) -> "Mappings":
        mappings_json = mappings_json or {}
        if "dynamic" not in kw:
            raw = mappings_json.get("dynamic", True)
            kw["dynamic"] = raw is True or str(raw).lower() == "true"
        return cls(properties=mappings_json.get("properties"), **kw)

    def get(self, name: str) -> FieldMapping | None:
        fm = self.fields.get(name)
        if fm is not None:
            return fm
        # "<field>.<sub>" resolves through the parent's multi-fields.
        if "." in name:
            parent, _, sub = name.rpartition(".")
            pfm = self.fields.get(parent)
            if pfm is not None:
                return pfm.fields.get(sub)
        return None

    def resolve_dynamic(
        self,
        name: str,
        value: Any,
        stage: dict[str, FieldMapping] | None = None,
    ) -> FieldMapping | None:
        """Map an unseen field from a concrete JSON value (or return None
        when dynamic mapping is off). New mappings land in `stage` when
        given, so a rejected document leaves no ghost mappings."""
        existing = self.get(name)
        if existing is not None:
            return existing
        if stage is not None and name in stage:
            return stage[name]
        if not self.dynamic:
            return None
        target = self.fields if stage is None else stage
        sample = value[0] if isinstance(value, list) and value else value
        if isinstance(sample, bool):
            raise ValueError(
                f"boolean field [{name}] is not supported by this port"
            )
        if isinstance(sample, int):
            fm = FieldMapping(name=name, type=LONG)
        elif isinstance(sample, float):
            fm = FieldMapping(name=name, type=DOUBLE)
        elif isinstance(sample, str):
            fm = FieldMapping(
                name=name,
                type=TEXT,
                fields={
                    "keyword": FieldMapping(
                        name=f"{name}.keyword", type=KEYWORD, ignore_above=256
                    )
                },
            )
        elif isinstance(sample, dict):
            raise ValueError(
                f"object field [{name}] is not supported by this port"
            )
        else:
            return None
        target[name] = fm
        return fm

    def analyzer_for(self, name: str, search: bool = False):
        fm = self.get(name)
        if fm is None:
            return self.analysis.get("standard")
        return self.analysis.get(fm.search_analyzer if search else fm.analyzer)
