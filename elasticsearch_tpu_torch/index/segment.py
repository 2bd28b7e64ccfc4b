"""Columnar inverted-index segments.

Port copy of elasticsearch_tpu/index/segment.py, trimmed to this slice:
`FieldIndex` (with its token positions: `pos_offsets`, `positions`,
`term_positions`), `Segment` and the Python path of `SegmentBuilder` for
text, keyword, numeric (dates and booleans among them: a doc-values
column through `coerce_numeric`) and dense_vector fields (with
multi-fields). A text field (one with norms) stages each value's token
positions (`Analyzer.analyze_positions`, stop words leaving gaps), the
values of a multi-valued field `POSITION_INCREMENT_GAP` apart, and
`build` lays them out as CSR arrays aligned with the postings, empty
arrays for a text field whose values analyzed to zero tokens; keyword
fields stay positionless. A dense_vector value is staged whole (never
flattened as a multi-value) and checked with the reference's messages:
rank, NaN / Infinity, dims, and zero magnitude under cosine and
dot_product. The reference's document parser (`_collect_values`):
objects flatten to dotted leaves, arrays of objects merge their leaves
as multi-values, `rank_features` flatten to one rank_feature column per
key, a geo_point (`parse_geo_point`) stages its `<field>.lat` /
`<field>.lon` columns, and each object under a `nested` path becomes one
hidden sub-document of that path's `NestedBlock` (an inner Segment plus
`parent_of`), staged in a candidate sub-builder and registered only when
the parent commits, so a rejected write leaves no nested block behind.
Left out: the native C++ accumulator, completion and percolator fields.

A Segment is an immutable columnar snapshot of a batch of documents, all
plain numpy: per inverted field a term dictionary plus CSR postings (doc
ids + term frequencies), SmallFloat norm bytes and the BM25 collection
statistics; per numeric field a dense float64 doc-values column (NaN =
missing); per dense_vector field a float32 [N, dims] matrix, zero rows
for docs without a vector; the stored `_source` documents for the fetch
phase; per text field the token positions of every posting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..utils import smallfloat
from .mapping import (
    BOOLEAN,
    DATE,
    DATE_NANOS,
    DENSE_VECTOR,
    GEO_POINT,
    NESTED,
    OBJECT,
    RANK_FEATURE,
    RANK_FEATURES,
    FieldMapping,
    Mappings,
    coerce_numeric,
)


def parse_geo_point(value) -> tuple[float, float]:
    """(lat, lon) from the reference's accepted forms: [lon, lat] arrays,
    {lat, lon} objects, "lat,lon" strings (geohash form unsupported)."""
    if isinstance(value, (list, tuple)) and len(value) == 2:
        try:
            lon, lat = float(value[0]), float(value[1])
        except (TypeError, ValueError):
            raise ValueError(f"failed to parse geo_point [{value!r}]") from None
        return lat, lon
    if isinstance(value, dict) and "lat" in value and "lon" in value:
        return float(value["lat"]), float(value["lon"])
    if isinstance(value, str) and "," in value:
        lat_s, lon_s = value.split(",", 1)
        return float(lat_s), float(lon_s)
    raise ValueError(f"failed to parse geo_point [{value!r}]")


@dataclass
class FieldIndex:
    """Immutable inverted index for one field within one segment."""

    name: str
    terms: dict[str, int]  # term -> term id (dense, 0..T-1, lexicographic)
    df: np.ndarray  # int32[T] document frequency per term
    offsets: np.ndarray  # int64[T+1] CSR offsets into doc_ids/tfs
    doc_ids: np.ndarray  # int32[P] local doc ids, ascending within a term
    tfs: np.ndarray  # float32[P] term frequency of (term, doc)
    norm_bytes: np.ndarray  # uint8[N] SmallFloat-encoded field length
    doc_count: int  # docs with >= 1 posting (BM25 docCount)
    sum_total_tf: int  # total terms across docs (BM25 sumTotalTermFreq)
    has_norms: bool = True  # keyword fields disable norms
    # bool[N]: the doc supplied a value for this field (exists semantics),
    # even if it analyzed to zero tokens.
    present: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))
    # Token positions (text fields; Lucene's .pos): CSR aligned with the
    # postings, posting p's occurrence positions ascending in
    # positions[pos_offsets[p]:pos_offsets[p + 1]]. None for fields
    # indexed without positions (keyword).
    pos_offsets: np.ndarray | None = None  # int64[P + 1]
    positions: np.ndarray | None = None  # int32[sum tf]

    @property
    def has_positions(self) -> bool:
        return self.positions is not None

    def term_positions(self, term: str, local_doc: int) -> np.ndarray:
        """Positions of `term` in `local_doc`; empty if absent or the
        field has no positions."""
        if self.positions is None:
            return np.empty(0, dtype=np.int32)
        tid = self.terms.get(term)
        if tid is None:
            return np.empty(0, dtype=np.int32)
        lo, hi = int(self.offsets[tid]), int(self.offsets[tid + 1])
        docs = self.doc_ids[lo:hi]
        hit = np.searchsorted(docs, local_doc)
        if hit >= len(docs) or docs[hit] != local_doc:
            return np.empty(0, dtype=np.int32)
        p = lo + int(hit)
        return self.positions[self.pos_offsets[p] : self.pos_offsets[p + 1]]

    @property
    def avgdl(self) -> float:
        if self.doc_count == 0:
            return 1.0
        return self.sum_total_tf / self.doc_count

    def postings(self, term: str) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids, tfs) for a term; empty arrays if absent."""
        tid = self.terms.get(term)
        if tid is None:
            return (
                np.empty(0, dtype=np.int32),
                np.empty(0, dtype=np.float32),
            )
        lo, hi = int(self.offsets[tid]), int(self.offsets[tid + 1])
        return self.doc_ids[lo:hi], self.tfs[lo:hi]


@dataclass
class Segment:
    """An immutable batch of indexed documents."""

    num_docs: int
    fields: dict[str, FieldIndex]
    doc_values: dict[str, np.ndarray]  # field -> float64[N] (NaN missing)
    vectors: dict[str, np.ndarray]  # field -> float32[N, dims]
    sources: list[dict[str, Any]]  # stored _source per local doc
    ids: list[str]  # external _id per local doc
    versions: np.ndarray | None = None  # int64[N]; None = all 1
    seqnos: np.ndarray | None = None  # int64[N]; None = all -1
    # path -> the nested objects of that path (NestedBlock)
    nested: dict[str, "NestedBlock"] = field(default_factory=dict)

    def doc_version(self, local: int) -> int:
        return int(self.versions[local]) if self.versions is not None else 1

    def doc_seqno(self, local: int) -> int:
        return int(self.seqnos[local]) if self.seqnos is not None else -1


@dataclass
class NestedBlock:
    """All nested objects of one path within a segment."""

    seg: Segment  # inner document space (fields named with full paths)
    parent_of: np.ndarray  # int32[seg.num_docs] -> parent local doc id


def _iter_field_values(value: Any) -> list[Any]:
    if isinstance(value, list):
        return value
    return [value]


# Positions of consecutive values of a multi-valued text field lie this
# far apart, so that phrases cannot match across values (the reference's
# TextFieldMapper position_increment_gap default).
POSITION_INCREMENT_GAP = 100


def _parse_vector(field_name: str, fm, value: Any) -> np.ndarray:
    """A dense_vector value as float32[dims], or ValueError (a 400 at index
    time) with the reference's messages: it must never surface later as a
    kernel shape error."""
    if isinstance(value, dict):
        raise ValueError(
            f"failed to parse field [{field_name}] of type [{fm.type}]: "
            f"found an object value"
        )
    try:
        vec = np.asarray(value, dtype=np.float32)
    except (TypeError, ValueError):
        raise ValueError(
            f"Failed to parse object: dense_vector field [{field_name}] "
            f"expects an array of numbers"
        ) from None
    if vec.ndim != 1:
        raise ValueError(
            f"dense_vector field [{field_name}] expects a flat array of "
            f"numbers, got an array of rank {vec.ndim}"
        )
    if not np.all(np.isfinite(vec)):
        raise ValueError(
            f"dense_vector field [{field_name}] must not contain NaN or "
            f"Infinity values"
        )
    if vec.shape[0] != fm.dims:
        raise ValueError(
            f"The [{field_name}] field has a different number of dimensions "
            f"[{vec.shape[0]}] than defined in the mapping [{fm.dims}]"
        )
    if fm.similarity in ("cosine", "dot_product") and not np.any(vec):
        # cosine (and unit-norm dot_product) cannot score a zero vector;
        # rejecting it also makes the kNN kernels' all-zero row = no
        # vector rule exact for these metrics.
        raise ValueError(
            f"The [{fm.similarity}] similarity does not support vectors "
            f"with zero magnitude (field [{field_name}])"
        )
    return vec


class SegmentBuilder:
    """Accumulates documents and freezes them into a Segment (the in-memory
    IndexWriter buffer of the write path)."""

    def __init__(self, mappings: Mappings):
        self.mappings = mappings
        self._sources: list[dict[str, Any]] = []
        self._ids: list[str] = []
        self._versions: list[int] = []
        self._seqnos: list[int] = []
        # field -> term -> doc -> tf
        self._inverted: dict[str, dict[str, dict[int, int]]] = {}
        # field -> term -> doc -> ascending token positions (text fields)
        self._positions: dict[str, dict[str, dict[int, list[int]]]] = {}
        self._lengths: dict[str, dict[int, int]] = {}  # field -> doc -> len
        self._present: dict[str, set[int]] = {}  # field -> docs with a value
        self._numeric: dict[str, dict[int, float]] = {}
        self._vectors: dict[str, dict[int, np.ndarray]] = {}
        # Nested paths: each accumulates its objects in a sub-builder over
        # the path's scope mappings, plus the parent doc of every object.
        self._nested: dict[str, tuple["SegmentBuilder", list[int]]] = {}

    def _nested_candidate(self, path: str) -> tuple["SegmentBuilder", list[int]]:
        """The accumulator a nested object WOULD commit into, existing or
        freshly built but never registered here: staging touches no
        builder state, so registration happens in _commit_doc."""
        acc = self._nested.get(path)
        if acc is None:
            scope = self.mappings.nested.get(path)
            if scope is None:  # defensive; NESTED mappings always have one
                scope = Mappings(analysis=self.mappings.analysis)
            acc = (SegmentBuilder(scope), [])
        return acc

    @property
    def num_docs(self) -> int:
        return len(self._sources)

    def _stage_field(self, field_name, fm, value, staged_postings,
                     staged_numeric, staged_vectors):
        """Stage one (field, value) pair: raises on mapper errors, touches
        no builder state."""
        if fm.type == GEO_POINT:
            # A bare [lon, lat] number pair is one point; a list of point
            # forms is multi-valued, and the first point wins.
            try:
                lat, lon = parse_geo_point(value)
            except ValueError:
                lat, lon = parse_geo_point(_iter_field_values(value)[0])
            if not (-90.0 <= lat <= 90.0) or not (-180.0 <= lon <= 180.0):
                raise ValueError(
                    f"failed to parse geo_point: [{lat}, {lon}] out of "
                    f"bounds for field [{field_name}]"
                )
            staged_numeric.append((f"{field_name}.lat", lat))
            staged_numeric.append((f"{field_name}.lon", lon))
        elif fm.type == DENSE_VECTOR:
            staged_vectors.append((field_name, _parse_vector(field_name, fm, value)))
        elif fm.is_inverted:
            analyzer = self.mappings.analysis.get(fm.analyzer)
            # Keyword fields index without positions (the reference's
            # KeywordFieldMapper default); text fields record the position
            # of every occurrence for phrase and span queries.
            with_positions = fm.norms
            total_len = 0
            tf: dict[str, int] = {}
            poss: dict[str, list[int]] = {}
            base = 0
            for v in _iter_field_values(value):
                if isinstance(v, (dict, list)):
                    raise ValueError(
                        f"failed to parse field [{field_name}] of type "
                        f"[{fm.type}]: found a structured value"
                    )
                if fm.ignore_above and len(str(v)) > fm.ignore_above:
                    continue
                if with_positions:
                    pairs, span = analyzer.analyze_positions(str(v))
                    total_len += len(pairs)
                    for tok, pos in pairs:
                        tf[tok] = tf.get(tok, 0) + 1
                        poss.setdefault(tok, []).append(base + pos)
                    base += span + POSITION_INCREMENT_GAP
                    continue
                tokens = analyzer.analyze(str(v))
                total_len += len(tokens)
                for tok in tokens:
                    tf[tok] = tf.get(tok, 0) + 1
            staged_postings.append((field_name, tf, total_len, poss))
        elif fm.is_numeric:
            # multi-valued: the first value (dates and booleans too); a
            # date parses from epoch millis or ISO 8601, a boolean from
            # true / false / "true" / "false", each with the reference's
            # reason when it does not
            v0 = _iter_field_values(value)[0]
            try:
                staged_numeric.append((field_name, coerce_numeric(fm.type, v0)))
            except (TypeError, ValueError) as e:
                if isinstance(e, ValueError) and fm.type in (
                        BOOLEAN, DATE, DATE_NANOS):
                    raise
                raise ValueError(
                    f"failed to parse field [{field_name}] of type "
                    f"[{fm.type}]: [{v0!r}]"
                ) from None

    def _collect_values(self, prefix, value, flat, nested_ops,
                        staged_mappings) -> None:
        """Flatten one source entry into leaf (field -> values) pairs:
        objects flatten to dotted paths and arrays of objects merge their
        leaves as multi-values; values under a `nested` path route to
        nested_ops, one hidden sub-document per object. New dynamic
        mappings land in `staged_mappings`, committed only with the doc."""
        if "." in prefix and self.mappings.get(prefix) is None:
            # Dot-expansion through a nested parent: {"c.author": "x"} with
            # `c` mapped nested becomes one nested sub-document.
            parts = prefix.split(".")
            for i in range(1, len(parts)):
                parent = ".".join(parts[:i])
                pfm = self.mappings.fields.get(parent)
                if pfm is not None and pfm.type == NESTED:
                    obj: Any = value
                    for part in reversed(parts[i:]):
                        obj = {part: obj}
                    self._collect_values(parent, obj, flat, nested_ops,
                                         staged_mappings)
                    return
        fm = self.mappings.resolve_dynamic(prefix, value, staged_mappings)
        if fm is not None and fm.type == NESTED:
            for obj in value if isinstance(value, list) else [value]:
                if not isinstance(obj, dict):
                    raise ValueError(
                        f"object mapping for [{prefix}] tried to parse "
                        f"field as object, but found a concrete value"
                    )
                nested_ops.append((prefix, obj))
            return
        if fm is not None and fm.type == GEO_POINT:
            flat.setdefault(prefix, (fm, []))[1].append(value)
            return
        if fm is not None and fm.type == RANK_FEATURES:
            # rank_features flatten to one rank_feature column per key.
            if not isinstance(value, dict):
                raise ValueError(
                    f"rank_features field [{prefix}] must hold an object "
                    f"mapping feature names to positive numbers"
                )
            for k, v in value.items():
                leaf = f"{prefix}.{k}"
                leaf_fm = self.mappings.get(leaf) or staged_mappings.get(leaf)
                if leaf_fm is None:
                    leaf_fm = FieldMapping(name=leaf, type=RANK_FEATURE)
                    staged_mappings[leaf] = leaf_fm
                try:
                    fv = float(v)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"rank_features field [{prefix}] feature [{k}] "
                        f"must be a number, got [{v!r}]"
                    ) from None
                self._collect_values(leaf, fv, flat, nested_ops,
                                     staged_mappings)
            return
        if isinstance(value, dict):
            if fm is not None and fm.type not in (OBJECT, NESTED):
                raise ValueError(
                    f"failed to parse field [{prefix}] of type [{fm.type}]: "
                    f"found an object value"
                )
            for k, v in value.items():
                if v is None:
                    continue
                self._collect_values(f"{prefix}.{k}", v, flat, nested_ops,
                                     staged_mappings)
            return
        if isinstance(value, list) and any(isinstance(v, dict) for v in value):
            for obj in value:
                if obj is None:
                    continue
                if not isinstance(obj, dict):
                    raise ValueError(
                        f"mapper [{prefix}] cannot mix objects and "
                        f"concrete values in one array"
                    )
                self._collect_values(prefix, obj, flat, nested_ops,
                                     staged_mappings)
            return
        if fm is None:
            return
        if fm.type == OBJECT:
            raise ValueError(
                f"object mapping for [{prefix}] tried to parse field "
                f"[{prefix}] as object, but found a concrete value"
            )
        # A dense_vector value IS the array: staged whole, never flattened.
        values = [value] if fm.type == DENSE_VECTOR else _iter_field_values(value)
        if not values:  # empty arrays index nothing
            return
        entry = flat.get(prefix)
        if entry is None:
            flat[prefix] = (fm, values)
        else:
            entry[1].extend(values)

    def _stage_doc(self, source: dict[str, Any]):
        """Validation pass: analyze and coerce everything, nested objects
        included, and touch no state (dynamic mappings stage in a side
        dict, nested objects in candidate sub-builders)."""
        staged_postings: list[tuple[str, dict[str, int], int, dict]] = []
        staged_numeric: list[tuple[str, float]] = []
        staged_vectors: list[tuple[str, np.ndarray]] = []
        staged_mappings: dict[str, Any] = {}
        flat: dict[str, tuple[Any, list[Any]]] = {}
        nested_ops: list[tuple[str, dict[str, Any]]] = []
        for name, value in source.items():
            if value is None:
                continue
            self._collect_values(name, value, flat, nested_ops, staged_mappings)
        for name, (fm, values) in flat.items():
            value = values if len(values) > 1 else values[0]
            # Multi-fields: the same value indexes under the parent AND
            # every "<name>.<sub>" sub-field with its own mapping.
            targets = [(name, fm)] + [
                (f"{name}.{sub}", sub_fm) for sub, sub_fm in fm.fields.items()
            ]
            for target_name, target_fm in targets:
                self._stage_field(
                    target_name, target_fm, value, staged_postings,
                    staged_numeric, staged_vectors,
                )
        staged_nested = []
        candidates: dict[str, tuple] = {}
        for path, obj in nested_ops:
            acc = candidates.get(path)
            if acc is None:
                acc = self._nested_candidate(path)
                candidates[path] = acc
            prefixed = {f"{path}.{k}": v for k, v in obj.items()}
            staged_nested.append(
                (path, acc, prefixed, acc[0]._stage_doc(prefixed))
            )
        return (staged_postings, staged_numeric, staged_vectors,
                staged_nested, staged_mappings)

    def add(
        self,
        source: dict[str, Any],
        doc_id: str | None = None,
        version: int = 1,
        seqno: int = -1,
    ) -> int:
        """Index one document; returns its local doc id. Atomic: everything
        that can fail runs in a staging pass that touches no state, for
        every nested object too."""
        staged = self._stage_doc(source)
        return self._commit_doc(source, doc_id, version, seqno, staged)

    def _commit_doc(self, source, doc_id, version, seqno, staged) -> int:
        (staged_postings, staged_numeric, staged_vectors, staged_nested,
         staged_mappings) = staged
        # ---- commit phase: nothing below raises -------------------------
        local = len(self._sources)
        for fname, fm in staged_mappings.items():
            self.mappings.fields.setdefault(fname, fm)
        self._sources.append(source)
        self._ids.append(doc_id if doc_id is not None else str(local))
        self._versions.append(int(version))
        self._seqnos.append(int(seqno))
        for field_name, tf, total_len, poss in staged_postings:
            self._present.setdefault(field_name, set()).add(local)
            postings = self._inverted.setdefault(field_name, {})
            for tok, count in tf.items():
                postings.setdefault(tok, {})[local] = count
            if poss:
                fpos = self._positions.setdefault(field_name, {})
                for tok, plist in poss.items():
                    fpos.setdefault(tok, {})[local] = plist
            # Docs analyzing to zero tokens do not count toward
            # docCount/sumTotalTermFreq (Lucene Terms.getDocCount).
            if total_len > 0:
                self._lengths.setdefault(field_name, {})[local] = total_len
        for field_name, v in staged_numeric:
            self._numeric.setdefault(field_name, {})[local] = v
        for field_name, vec in staged_vectors:
            self._vectors.setdefault(field_name, {})[local] = vec
        for path, acc, prefixed, sub_staged in staged_nested:
            self._nested.setdefault(path, acc)
            sub_builder, parents = acc
            sub_builder._commit_doc(prefixed, None, 1, -1, sub_staged)
            parents.append(local)
        return local

    def _build_positions(self, fname, terms, offsets, wants_positions):
        """(pos_offsets int64[P + 1], positions int32[sum tf]) aligned with
        the postings just built, or (None, None) for a positionless field.
        A text field ALWAYS carries (possibly empty) position arrays: a
        segment whose values all analyzed to zero tokens must not turn the
        field positionless."""
        if not wants_positions:
            return None, None
        fpos = self._positions.get(fname, {})
        total = int(offsets[-1])
        pos_counts = np.zeros(total, dtype=np.int64)
        chunks: list[list[int]] = [[]] * total
        for term, tid in terms.items():
            lo = int(offsets[tid])
            by_doc = fpos.get(term, {})
            for off, d in enumerate(sorted(by_doc)):
                plist = by_doc[d]
                pos_counts[lo + off] = len(plist)
                chunks[lo + off] = plist
        pos_offsets = np.zeros(total + 1, dtype=np.int64)
        pos_offsets[1:] = np.cumsum(pos_counts)
        positions = np.fromiter(
            (p for chunk in chunks for p in chunk),
            dtype=np.int32,
            count=int(pos_offsets[-1]),
        )
        return pos_offsets, positions

    def build(self) -> Segment:
        n = len(self._sources)
        fields: dict[str, FieldIndex] = {}
        for fname in sorted(self._inverted):
            postings = self._inverted[fname]
            terms = {t: i for i, t in enumerate(sorted(postings))}
            df = np.zeros(len(terms), dtype=np.int32)
            offsets = np.zeros(len(terms) + 1, dtype=np.int64)
            for term, tid in terms.items():
                df[tid] = len(postings[term])
            offsets[1:] = np.cumsum(df)
            total = int(offsets[-1])
            doc_ids = np.empty(total, dtype=np.int32)
            tfs = np.empty(total, dtype=np.float32)
            for term, tid in terms.items():
                lo = int(offsets[tid])
                by_doc = postings[term]
                docs_sorted = sorted(by_doc)
                doc_ids[lo : lo + len(docs_sorted)] = docs_sorted
                tfs[lo : lo + len(docs_sorted)] = [by_doc[d] for d in docs_sorted]
            lengths = self._lengths.get(fname, {})
            norm_bytes = np.zeros(n, dtype=np.uint8)
            if lengths:
                docs_with = np.fromiter(lengths.keys(), dtype=np.int64)
                lens = np.fromiter(lengths.values(), dtype=np.int64)
                norm_bytes[docs_with] = smallfloat.encode_lengths(lens)
            present = np.zeros(n, dtype=bool)
            present_docs = self._present.get(fname)
            if present_docs:
                present[np.fromiter(present_docs, dtype=np.int64)] = True
            fm = self.mappings.get(fname)
            pos_offsets, positions = self._build_positions(
                fname, terms, offsets, fm.norms if fm is not None else True
            )
            fields[fname] = FieldIndex(
                name=fname,
                terms=terms,
                df=df,
                offsets=offsets,
                doc_ids=doc_ids,
                tfs=tfs,
                norm_bytes=norm_bytes,
                doc_count=len(lengths),
                sum_total_tf=int(sum(lengths.values())),
                has_norms=fm.norms if fm is not None else True,
                present=present,
                pos_offsets=pos_offsets,
                positions=positions,
            )
        doc_values: dict[str, np.ndarray] = {}
        for fname, by_doc in self._numeric.items():
            col = np.full(n, np.nan, dtype=np.float64)
            for doc, v in by_doc.items():
                col[doc] = v
            doc_values[fname] = col
        vectors: dict[str, np.ndarray] = {}
        for fname, by_doc in self._vectors.items():
            fm = self.mappings.get(fname)
            dims = fm.dims if fm and fm.dims else len(next(iter(by_doc.values())))
            mat = np.zeros((n, dims), dtype=np.float32)
            for doc, vec in by_doc.items():
                mat[doc] = vec
            vectors[fname] = mat
        nested = {
            path: NestedBlock(
                seg=sub_builder.build(),
                parent_of=np.asarray(parents, dtype=np.int32),
            )
            for path, (sub_builder, parents) in sorted(self._nested.items())
        }
        return Segment(
            num_docs=n,
            fields=fields,
            doc_values=doc_values,
            vectors=vectors,
            sources=list(self._sources),
            ids=list(self._ids),
            versions=np.asarray(self._versions, dtype=np.int64),
            seqnos=np.asarray(self._seqnos, dtype=np.int64),
            nested=nested,
        )
