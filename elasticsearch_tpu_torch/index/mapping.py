"""Field mappings: the schema of an index.

Port copy of elasticsearch_tpu/index/mapping.py, trimmed to this slice:
`text`, `keyword`, the numeric types `long`, `integer`, `float` and
`double`, and `dense_vector` (with `dims`, `similarity` — `cosine` by
default —, `MAX_DIMS` and the reference's up-front checks), multi-fields
(the dynamic `text` + `.keyword` pair) and dynamic mapping of unseen
fields from JSON value types (a dense_vector is never mapped
dynamically: a numeric array maps as a number, as in the reference);
`object` and `nested` scopes (`Mappings._register`: object leaves
flatten to dotted paths, a nested path gets its own `Mappings` scope in
`Mappings.nested`, dynamic objects map as `object`, and a dotted name
under a nested path never maps flat), `geo_point` (two doc-values
columns, `<field>.lat` / `<field>.lon`), `rank_feature` (a doc-values
column) and `rank_features` (one rank_feature column per key).
`merge_field` keeps the reference's mapping-update rules for the fields
it has: a type never changes, and a dense_vector's `dims` and
`similarity` are immutable. Left out: dates, booleans, completion,
percolator and the other mapper-extras types, dynamic templates and
`to_json` round-trips; any such field is rejected at mapping or index
time.
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
DENSE_VECTOR = "dense_vector"
OBJECT = "object"
NESTED = "nested"
GEO_POINT = "geo_point"
RANK_FEATURE = "rank_feature"
RANK_FEATURES = "rank_features"

NUMERIC_TYPES = {LONG, INTEGER, FLOAT, DOUBLE}
INVERTED_TYPES = {TEXT, KEYWORD}
# rank_feature materializes as a numeric doc-values column.
DOC_VALUE_TYPES = NUMERIC_TYPES | {RANK_FEATURE}
ALL_TYPES = NUMERIC_TYPES | INVERTED_TYPES | {
    DENSE_VECTOR, OBJECT, NESTED, GEO_POINT, RANK_FEATURE, RANK_FEATURES,
}


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
    dims: int = 0  # dense_vector dimension
    # dense_vector similarity: the knn section's scoring and the IVF
    # coarse scan.
    similarity: str = "cosine"
    # object / nested: the raw `properties` sub-schema as written (leaf
    # sub-fields are also registered flat under their dotted full paths).
    properties: dict[str, Any] | None = None

    # Max dense_vector dims (reference: DenseVectorFieldMapper MAX_DIMS).
    MAX_DIMS = 4096
    SIMILARITIES = ("cosine", "dot_product", "l2_norm")

    def __post_init__(self):
        if self.type not in ALL_TYPES:
            raise ValueError(
                f"No handler for type [{self.type}] on field [{self.name}]"
            )
        if self.type == DENSE_VECTOR:
            # dims are required up front: a mapping without them would
            # defer the shape error to ingest, or to the kernel.
            if self.dims < 1 or self.dims > self.MAX_DIMS:
                raise ValueError(
                    f"The number of dimensions for field [{self.name}] "
                    f"should be in the range [1, {self.MAX_DIMS}] but was "
                    f"[{self.dims}]"
                )
            if self.similarity not in self.SIMILARITIES:
                raise ValueError(
                    f"Unknown similarity [{self.similarity}] for field "
                    f"[{self.name}]; expected one of "
                    f"{list(self.SIMILARITIES)}"
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
        return self.type in DOC_VALUE_TYPES


class Mappings:
    """Parsed `mappings` for one index, with dynamic-mapping support:
    unmapped fields map on first sight from their JSON type (string ->
    text + .keyword, int -> long, float -> double, object -> object).
    Nested paths carry their own scope (`nested`: path -> a Mappings
    whose field names are full dotted paths)."""

    def __init__(
        self,
        properties: dict[str, dict[str, Any]] | None = None,
        analysis: AnalysisRegistry | None = None,
        dynamic: bool = True,
    ):
        self.fields: dict[str, FieldMapping] = {}
        self.analysis = analysis or AnalysisRegistry()
        self.dynamic = dynamic
        self.nested: dict[str, "Mappings"] = {}
        for name, spec in (properties or {}).items():
            self._register(name, spec)

    def _register(self, name: str, spec: dict[str, Any]) -> None:
        """Register one property, flattening object trees to dotted leaf
        names and splitting nested sub-schemas into their own scopes."""
        ftype = spec.get("type", OBJECT if "properties" in spec else TEXT)
        if ftype == NESTED:
            self.fields[name] = FieldMapping(
                name=name, type=NESTED, properties=spec.get("properties") or {}
            )
            scope = Mappings(analysis=self.analysis, dynamic=self.dynamic)
            for sub, subspec in (spec.get("properties") or {}).items():
                scope._register(f"{name}.{sub}", subspec)
            self.nested[name] = scope
        elif ftype == OBJECT:
            self.fields[name] = FieldMapping(
                name=name, type=OBJECT, properties=spec.get("properties") or {}
            )
            for sub, subspec in (spec.get("properties") or {}).items():
                self._register(f"{name}.{sub}", subspec)
        else:
            self.fields[name] = self._parse_field(name, spec)

    @classmethod
    def _parse_field(cls, name: str, spec: dict[str, Any]) -> FieldMapping:
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
            dims=int(spec.get("dims", 0)),
            similarity=str(spec.get("similarity", "cosine")),
        )

    @classmethod
    def from_json(cls, mappings_json: dict[str, Any] | None, **kw) -> "Mappings":
        mappings_json = mappings_json or {}
        if "dynamic" not in kw:
            raw = mappings_json.get("dynamic", True)
            kw["dynamic"] = raw is True or str(raw).lower() == "true"
        return cls(properties=mappings_json.get("properties"), **kw)

    def merge_field(self, name: str, spec: dict[str, Any]) -> None:
        """Add or update one field from a mapping update (PUT _mapping):
        a new field is added; an existing one keeps its type, and a
        dense_vector keeps its `dims` and `similarity` (the vectors and
        IVF planes were built under them), else ValueError with the
        reference's message."""
        if "properties" in spec or spec.get("type") in (OBJECT, NESTED):
            existing = self.fields.get(name)
            kind = spec.get("type", OBJECT)
            if existing is not None and existing.type != kind:
                raise ValueError(
                    f"mapper [{name}] cannot be changed from type "
                    f"[{existing.type}] to [{kind}]"
                )
            self._register(name, spec)
            return
        new = self._parse_field(name, spec)
        existing = self.fields.get(name)
        if existing is None:
            self.fields[name] = new
            return
        if existing.type != new.type:
            raise ValueError(
                f"mapper [{name}] cannot be changed from type "
                f"[{existing.type}] to [{new.type}]"
            )
        if existing.type == DENSE_VECTOR:
            for param in ("dims", "similarity"):
                if getattr(existing, param) != getattr(new, param):
                    raise ValueError(
                        f"Mapper for [{name}] conflicts with existing "
                        f"mapper: Cannot update parameter [{param}] from "
                        f"[{getattr(existing, param)}] to "
                        f"[{getattr(new, param)}]"
                    )
        for sub, sub_fm in new.fields.items():
            existing.fields.setdefault(sub, sub_fm)

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
        if "." in name:
            # A dotted name under a NESTED path never maps flat: the
            # document parser routes such keys into the nested scope.
            parts = name.split(".")
            for i in range(1, len(parts)):
                pfm = self.fields.get(".".join(parts[:i]))
                if pfm is not None and pfm.type == NESTED:
                    return None
        if isinstance(value, dict) or (
            isinstance(value, list) and value and isinstance(value[0], dict)
        ):
            # Dynamic objects (and arrays of objects without a nested
            # mapping) map as `object`; their leaves flatten to dotted
            # paths.
            fm = FieldMapping(name=name, type=OBJECT, properties={})
            target[name] = fm
            return fm
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
        else:
            return None
        target[name] = fm
        return fm

    def analyzer_for(self, name: str, search: bool = False):
        fm = self.get(name)
        if fm is None:
            return self.analysis.get("standard")
        return self.analysis.get(fm.search_analyzer if search else fm.analyzer)
