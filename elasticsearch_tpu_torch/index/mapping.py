"""Field mappings: the schema of an index.

Port copy of elasticsearch_tpu/index/mapping.py, trimmed to this slice:
`text`, `keyword`, the numeric types `long`, `integer`, `short`, `byte`,
`float` and `double`, `boolean` (a 1.0 / 0.0 doc-values column; JSON
`true` / `false` and the strings "true" / "false"), `date` and
`date_nanos` (epoch milliseconds in a doc-values column, from epoch
millis or ISO 8601 strings: `parse_date_millis`, `_trim_subsecond` and
the boolean and date branches of `coerce_numeric`), and `dense_vector`
(with `dims`, `similarity` — `cosine` by default —, `MAX_DIMS` and the
reference's up-front checks), multi-fields (the dynamic `text` +
`.keyword` pair) and dynamic mapping of unseen fields from JSON value
types (a JSON boolean maps as `boolean`; a dense_vector is never mapped
dynamically: a numeric array maps as a number, as in the reference);
`object` and `nested` scopes (`Mappings._register`: object leaves
flatten to dotted paths, a nested path gets its own `Mappings` scope in
`Mappings.nested`, dynamic objects map as `object`, and a dotted name
under a nested path never maps flat), `geo_point` (two doc-values
columns, `<field>.lat` / `<field>.lon`), `rank_feature` (a doc-values
column) and `rank_features` (one rank_feature column per key).
`merge_field` keeps the reference's mapping-update rules for the fields
it has: a type never changes, and a dense_vector's `dims` and
`similarity` are immutable; `to_json` serializes the schema as the
reference's `_mapping` response does. Left out: completion, percolator,
ip, binary and the other mapper-extras types (`half_float`,
`scaled_float`, `unsigned_long`, `token_count`, `search_as_you_type`)
and dynamic templates; any such field is rejected at mapping time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..analysis.analyzers import AnalysisRegistry

TEXT = "text"
KEYWORD = "keyword"
LONG = "long"
INTEGER = "integer"
SHORT = "short"
BYTE = "byte"
FLOAT = "float"
DOUBLE = "double"
BOOLEAN = "boolean"
DATE = "date"
DATE_NANOS = "date_nanos"
DENSE_VECTOR = "dense_vector"
OBJECT = "object"
NESTED = "nested"
GEO_POINT = "geo_point"
RANK_FEATURE = "rank_feature"
RANK_FEATURES = "rank_features"

NUMERIC_TYPES = {
    LONG, INTEGER, SHORT, BYTE, DOUBLE, FLOAT, DATE, BOOLEAN, DATE_NANOS,
}
INVERTED_TYPES = {TEXT, KEYWORD}
# rank_feature materializes as a numeric doc-values column.
DOC_VALUE_TYPES = NUMERIC_TYPES | {RANK_FEATURE}
ALL_TYPES = NUMERIC_TYPES | INVERTED_TYPES | {
    DENSE_VECTOR, OBJECT, NESTED, GEO_POINT, RANK_FEATURE, RANK_FEATURES,
}


def parse_date_millis(value: Any) -> float:
    """Parse a date value to epoch milliseconds (the doc-values unit):
    epoch millis (a number, or a string of digits) or an ISO 8601 date /
    datetime string, the reference's default
    `strict_date_optional_time||epoch_millis`; a zone-less datetime is
    UTC."""
    if isinstance(value, bool):
        raise ValueError(f"failed to parse date field [{value!r}]")
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        s = value.strip()
        try:
            return float(int(s))  # epoch_millis as string
        except ValueError:
            pass
        from datetime import datetime, timezone

        s = _trim_subsecond(s)
        try:
            dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
        except ValueError:
            raise ValueError(
                f"failed to parse date field [{value}] with format "
                f"[strict_date_optional_time||epoch_millis]"
            ) from None
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp() * 1000.0
    raise ValueError(f"failed to parse date field [{value!r}]")


def _trim_subsecond(s: str) -> str:
    """Truncate fractional seconds past microseconds (date_nanos inputs;
    fromisoformat accepts at most 6 fractional digits)."""
    import re

    return re.sub(r"(\.\d{6})\d+", r"\1", s)


def coerce_numeric(field_type: str, value: Any) -> float:
    """Coerce a query/document value to the numeric column representation:
    booleans map to 1.0 / 0.0 (a boolean field also takes "true" /
    "false"), dates parse to epoch millis, numeric strings parse; anything
    else raises ValueError."""
    if field_type == BOOLEAN:
        if value is True or value == "true":
            return 1.0
        if value is False or value == "false":
            return 0.0
        if isinstance(value, (int, float)):  # already-coerced column value
            return float(value)
        raise ValueError(
            f"Can't parse boolean value [{value!r}], expected [true] or [false]"
        )
    if field_type in (DATE, DATE_NANOS):
        return parse_date_millis(value)
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
    text + .keyword, bool -> boolean, int -> long, float -> double,
    object -> object).
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

    def _props_under(self, prefix: str) -> dict[str, Any]:
        """Relative `properties` of an object / nested parent, rebuilt from
        the registered flat fields (dynamic leaves included)."""
        dot = prefix + "."
        return {
            name[len(dot):]: self._spec_of(f)
            for name, f in self.fields.items()
            if name.startswith(dot) and "." not in name[len(dot):]
        }

    def _spec_of(self, f: FieldMapping) -> dict[str, Any]:
        if f.type == OBJECT:
            return {"type": OBJECT, "properties": self._props_under(f.name)}
        if f.type == NESTED:
            scope = self.nested.get(f.name)
            props = (scope._props_under(f.name) if scope is not None
                     else dict(f.properties or {}))
            return {"type": NESTED, "properties": props}
        return self._field_spec(f)

    @staticmethod
    def _field_spec(f: FieldMapping) -> dict[str, Any]:
        spec: dict[str, Any] = {"type": f.type}
        if f.type == TEXT and f.analyzer != "standard":
            spec["analyzer"] = f.analyzer
        if f.search_analyzer != f.analyzer:
            spec["search_analyzer"] = f.search_analyzer
        if f.type == DENSE_VECTOR:
            spec["dims"] = f.dims
            if f.similarity != "cosine":
                spec["similarity"] = f.similarity
        if not f.index:
            spec["index"] = False
        if f.norms != (f.type == TEXT):
            spec["norms"] = f.norms
        if f.ignore_above:
            spec["ignore_above"] = f.ignore_above
        if f.fields:
            spec["fields"] = {
                sub_name: Mappings._field_spec(sub)
                for sub_name, sub in f.fields.items()
            }
        return spec

    def _under_object(self, name: str) -> bool:
        """True when `name` is a flattened leaf of a registered object
        parent (it serializes inside the parent's `properties`)."""
        parts = name.split(".")
        for i in range(1, len(parts)):
            fm = self.fields.get(".".join(parts[:i]))
            if fm is not None and fm.type == OBJECT:
                return True
        return False

    def to_json(self) -> dict[str, Any]:
        """The schema as the `_mapping` response renders it."""
        out: dict[str, Any] = {
            "properties": {
                f.name: self._spec_of(f)
                for f in self.fields.values()
                if not self._under_object(f.name)
            }
        }
        if not self.dynamic:
            out["dynamic"] = False
        return out

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
        if isinstance(value, bool):
            fm = FieldMapping(name=name, type=BOOLEAN)
        elif isinstance(value, int):
            fm = FieldMapping(name=name, type=LONG)
        elif isinstance(value, float):
            fm = FieldMapping(name=name, type=DOUBLE)
        elif (isinstance(value, list) and value
              and isinstance(value[0], (int, float))):
            # A numeric array (a list of booleans included, as in the
            # reference) maps as a number: double if any value is a float.
            fm = FieldMapping(name=name, type=DOUBLE if any(
                isinstance(v, float) for v in value) else LONG)
        elif isinstance(value, str) or (
                isinstance(value, list) and value
                and isinstance(value[0], str)):
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
