"""Device-resident tiled index layout, as torch tensors.

Port of elasticsearch_tpu/index/tiles.py, trimmed to this slice:
`TILE`, `_pad_to_tile`, `DeviceField`, `DeviceSegment`, `compute_tn`,
`pack_field` (with `min_tiles`), `pack_segment` (with the stacking pads
`pad_docs_to` and `field_min_tiles`) and `device_nbytes`, plus
`device_segment_from_numpy` to attach planes packed elsewhere; the
dense_vector planes (f32[N, dims], padding rows zero, as the reference
pads them), each with its vector-presence plane `has_vector` (bool[N],
any element non-zero: the kNN kernels' rule for docs without a vector,
computed once at pack time instead of per query); and the keyword
global-ordinal plane `ord_terms` (terms aggregations), packed for every
field without norms; and the positional planes of a text field
(`pos_doc`, `pos_val`, with `pos_offsets`, `term_pos_span` and
`pos_pad_tile`), which phrase and span queries read, plus `pos_bits`,
the width of the largest position (the packed sort key of K11,
ops/kernels.py); and the nested blocks (`DeviceSegment.nested`: per
path the inner DeviceSegment, `parent_of` i32[NN] and one plane derived
at pack time for K13 doc_join, the CSR `child_start` i32[N + 1] whose
parent p owns children [child_start[p], child_start[p + 1]); the pack
raises if `parent_of` is not nondecreasing); and the packed multi-tenant
plane (`PackedField`, `PackedPlane`, `pack_field_packed`,
`_shifted_tile_plane`, `pack_segments_packed`, `packed_device_nbytes`:
several small segments' postings concatenated on the device, with a
compile view per member); and the shard mesh's helpers: the stacking pad
of the positional planes (`pack_field(min_pos_tiles)` /
`pack_segment(field_pos_min_tiles)`, so that phrase plans index every
shard of a mesh alike) and `tile_doc_bounds` (the sharded compiler's
host-side per-tile doc-id extrema). Left out: `pack_segment_delta` and
`repack_tn` (ROADMAP queue A6).

A field's postings live on the device as flat CSR arrays padded to a tile
multiple plus one all-sentinel tile, viewed as [NT, 256]:

    doc_ids : int32[NT, 256]   local doc ids (sentinel = num_docs)
    tfs     : float32[NT, 256] term frequencies (0 for padding)
    tn      : float32[NT, 256] precomputed impact tf * normInverse
    norm_bytes : uint8[N + 1]  SmallFloat norms, one sentinel slot
    present : bool[N]          doc has a value for the field
    ord_terms : int32[NT, 256] keyword fields: the term id owning each
                               posting (sentinel T = the term count)
    pos_doc : int32[PT, 256]   text fields: the doc owning each position
                               entry (CSR term -> doc -> occurrence order,
                               sentinel = num_docs)
    pos_val : int32[PT, 256]   its position (sentinel -1)

The same dtypes and layout as the JAX package, so a plan compiled by
either side addresses either side's planes. The host-side planning
attributes (terms, df, offsets, tile_max, tile_doc_lo/hi, tn_avgdl/k1/b)
stay numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .segment import FieldIndex, Segment

TILE = 256  # postings per tile


def _pad_to_tile(arr: np.ndarray, pad_value, tile: int = TILE) -> np.ndarray:
    """Pad to a tile multiple PLUS one extra all-padding sentinel tile (the
    target of padding slots in plan worklists: its positions lie past every
    real posting, so the [start, end) mask never selects it)."""
    p = len(arr)
    p_pad = ((p + tile - 1) // tile) * tile + tile
    out = np.full(p_pad, pad_value, dtype=arr.dtype)
    out[:p] = arr
    return out


@dataclass
class DeviceField:
    """One field's postings resident on the device (plus the host-side
    term dictionary and planning data)."""

    name: str
    terms: dict[str, int]
    df: np.ndarray  # int32[T]
    offsets: np.ndarray  # int64[T+1]
    doc_count: int
    sum_total_tf: int
    has_norms: bool
    doc_ids: torch.Tensor  # int32[NT, TILE]
    tfs: torch.Tensor  # float32[NT, TILE]
    norm_bytes: torch.Tensor  # uint8[N + 1]
    present: torch.Tensor  # bool[N]
    tn: torch.Tensor  # float32[NT, TILE], valid for (tn_avgdl, tn_k1, tn_b)
    tn_avgdl: float
    tn_k1: float
    tn_b: float
    tile_max: np.ndarray | None = None  # f32[NT] per-tile max impact
    tile_doc_lo: np.ndarray | None = None  # per-tile min doc id
    tile_doc_hi: np.ndarray | None = None  # per-tile max doc id
    # Global ordinals of a keyword field (terms aggregations): the term id
    # owning each posting position, in the [NT, TILE] layout of doc_ids,
    # padding = T (the aggregation's discard slot). None for text fields.
    ord_terms: torch.Tensor | None = None  # int32[NT, TILE]
    # Positional planes (text fields; Lucene's .pos): flat position entries
    # in CSR term -> doc -> occurrence order, tiled like the postings. A
    # term's entries are the contiguous slice
    # [pos_offsets[offsets[tid]], pos_offsets[offsets[tid + 1]]), which the
    # compiler plans tile worklists over exactly as over postings tiles.
    pos_doc: torch.Tensor | None = None  # int32[PT, TILE], sentinel N
    pos_val: torch.Tensor | None = None  # int32[PT, TILE], sentinel -1
    pos_offsets: np.ndarray | None = None  # int64[P + 1] host copy
    pos_bits: int = 1  # bits of the largest position (>= 1)

    def term_pos_span(self, term: str) -> tuple[int, int]:
        """[start, end) position-entry span of a term; (0, 0) if absent."""
        tid = self.terms.get(term)
        if tid is None or self.pos_offsets is None:
            return (0, 0)
        return (
            int(self.pos_offsets[self.offsets[tid]]),
            int(self.pos_offsets[self.offsets[tid + 1]]),
        )

    @property
    def pos_pad_tile(self) -> int:
        """Tile id of the all-sentinel padding tile of the position planes."""
        return self.pos_doc.shape[0] - 1

    @property
    def pad_tile(self) -> int:
        """Tile id of the all-sentinel padding tile (always the last)."""
        return self.doc_ids.shape[0] - 1

    @property
    def avgdl(self) -> float:
        if self.doc_count == 0:
            return 1.0
        return self.sum_total_tf / self.doc_count

    @property
    def num_terms(self) -> int:
        return len(self.df)

    def term_span(self, term: str) -> tuple[int, int]:
        """[start, end) posting positions for a term; (0, 0) if absent."""
        tid = self.terms.get(term)
        if tid is None:
            return (0, 0)
        return int(self.offsets[tid]), int(self.offsets[tid + 1])

    def term_df(self, term: str) -> int:
        tid = self.terms.get(term)
        if tid is None:
            return 0
        return int(self.df[tid])


@dataclass
class DeviceSegment:
    """A Segment uploaded to the device (the refreshed, searchable form).
    `live` is the deletion mask: True = visible."""

    num_docs: int
    fields: dict[str, DeviceField]
    doc_values: dict[str, torch.Tensor]  # float32[N], NaN = missing
    live: torch.Tensor  # bool[N]
    sources: list[dict[str, Any]]
    ids: list[str]
    device: torch.device
    vectors: dict[str, torch.Tensor] = None  # float32[N, dims]
    has_vector: dict[str, torch.Tensor] = None  # bool[N]
    # path -> (inner DeviceSegment over the nested-doc space, parent_of
    # i32[NN], child_start i32[N + 1]): the block-join planes.
    nested: dict[str, tuple] = None

    def __post_init__(self):
        if self.nested is None:
            self.nested = {}
        if self.vectors is None:
            self.vectors = {}
        if self.has_vector is None:
            self.has_vector = _has_vector(self.vectors)


def _has_vector(vectors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Per dense_vector plane, which rows hold a vector (any element
    non-zero; ingest rejects zero vectors under cosine and dot_product)."""
    return {name: (mat != 0).any(dim=1) for name, mat in vectors.items()}


def compute_tn(field: FieldIndex, avgdl: float, k1: float, b: float) -> np.ndarray:
    """Per-posting impact tn = tf * normInverse(normByte) in fp32 — the
    oracle's (and Lucene's) exact product."""
    from ..ops.bm25 import BM25Params, norm_inverse_cache

    cache = norm_inverse_cache(avgdl, BM25Params(k1=k1, b=b))
    if not field.has_norms:
        cache = np.full(256, cache[1], dtype=np.float32)
    ninv = cache[field.norm_bytes[field.doc_ids]]
    return (field.tfs.astype(np.float32) * ninv).astype(np.float32)


def _fit_bool(present: np.ndarray, norm_bytes: np.ndarray, num_docs: int) -> np.ndarray:
    src = present if len(present) else norm_bytes > 0
    out = np.zeros(num_docs, dtype=bool)
    out[: len(src)] = src[:num_docs]
    return out


def _put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def pack_field(
    field: FieldIndex,
    num_docs: int,
    device=DEFAULT_DEVICE,
    min_tiles: int = 0,
    avgdl: float | None = None,
    k1: float = 1.2,
    b: float = 0.75,
    min_pos_tiles: int = 0,
) -> DeviceField:
    """Pack one FieldIndex into tiled device tensors.

    `num_docs` may exceed the segment's own doc count (stacked shards pad
    to a common size); the scatter sentinel is always `num_docs`.
    `min_tiles` pads the postings tile axis, and `min_pos_tiles` the
    positional planes' tile axis, with sentinel tiles so that the shards
    of a mesh share one set of shapes."""
    device = resolve_device(device)
    if avgdl is None:
        avgdl = field.avgdl
    doc_ids = _pad_to_tile(field.doc_ids.astype(np.int32), np.int32(num_docs))
    tfs = _pad_to_tile(field.tfs.astype(np.float32), np.float32(0.0))
    tn = _pad_to_tile(compute_tn(field, avgdl, k1, b), np.float32(0.0))
    if min_tiles and len(doc_ids) < min_tiles * TILE:
        extra = min_tiles * TILE - len(doc_ids)
        doc_ids = np.concatenate(
            [doc_ids, np.full(extra, num_docs, dtype=np.int32)]
        )
        tfs = np.concatenate([tfs, np.zeros(extra, dtype=np.float32)])
        tn = np.concatenate([tn, np.zeros(extra, dtype=np.float32)])
    norm_ext = np.zeros(num_docs + 1, dtype=np.uint8)
    norm_ext[: len(field.norm_bytes)] = field.norm_bytes
    doc_tiles = doc_ids.reshape(-1, TILE)
    ord_terms = None
    if not field.has_norms:
        # Per-posting owning term id (CSR expansion), padded with the
        # sentinel T, also for an empty vocabulary (all padding).
        t_count = len(field.df)
        ords = np.repeat(
            np.arange(t_count, dtype=np.int32),
            np.diff(field.offsets).astype(np.int64),
        )
        ords_pad = np.full(len(doc_ids), t_count, dtype=np.int32)
        ords_pad[: len(ords)] = ords
        ord_terms = _put(ords_pad.reshape(-1, TILE), device)
    pos = {}
    if field.positions is not None:
        # The owning doc of every position entry (CSR expansion over the
        # per-posting counts), then both planes tiled like the postings.
        counts = np.diff(field.pos_offsets).astype(np.int64)
        owners = np.repeat(field.doc_ids.astype(np.int32), counts)
        pd = _pad_to_tile(owners, np.int32(num_docs))
        pv = _pad_to_tile(field.positions.astype(np.int32), np.int32(-1))
        if min_pos_tiles and len(pd) < min_pos_tiles * TILE:
            extra = min_pos_tiles * TILE - len(pd)
            pd = np.concatenate([pd, np.full(extra, num_docs, dtype=np.int32)])
            pv = np.concatenate([pv, np.full(extra, -1, dtype=np.int32)])
        pos = {
            "pos_doc": _put(pd.reshape(-1, TILE), device),
            "pos_val": _put(pv.reshape(-1, TILE), device),
            "pos_offsets": field.pos_offsets,
            "pos_bits": position_bits(field.positions),
        }
    return DeviceField(
        name=field.name,
        terms=field.terms,
        df=field.df,
        offsets=field.offsets,
        doc_count=field.doc_count,
        sum_total_tf=field.sum_total_tf,
        has_norms=field.has_norms,
        doc_ids=_put(doc_tiles, device),
        tfs=_put(tfs.reshape(-1, TILE), device),
        norm_bytes=_put(norm_ext, device),
        present=_put(_fit_bool(field.present, field.norm_bytes, num_docs), device),
        tn=_put(tn.reshape(-1, TILE), device),
        tn_avgdl=float(avgdl),
        tn_k1=k1,
        tn_b=b,
        tile_max=tn.reshape(-1, TILE).max(axis=1),
        tile_doc_lo=doc_tiles.min(axis=1),
        tile_doc_hi=doc_tiles.max(axis=1),
        ord_terms=ord_terms,
        **pos,
    )


def child_starts(parent_of: np.ndarray, num_docs: int) -> np.ndarray:
    """K13's CSR plane: child_start i32[num_docs + 1], parent p owning the
    nested docs [child_start[p], child_start[p + 1]). The builder appends
    a parent's nested objects when it commits that parent, so parent_of
    is nondecreasing; anything else is refused (the per-parent ascending
    fold would not be the reference's scatter order)."""
    parent_of = np.asarray(parent_of, dtype=np.int64)
    if len(parent_of) and (
        np.any(np.diff(parent_of) < 0) or parent_of[0] < 0
        or parent_of[-1] >= num_docs
    ):
        raise ValueError("nested parent_of must be nondecreasing in [0, N)")
    return np.searchsorted(
        parent_of, np.arange(num_docs + 1), side="left"
    ).astype(np.int32)


def _nested_entry(inner: "DeviceSegment", parent_of, num_docs: int, device):
    parent_of = np.asarray(parent_of, dtype=np.int32)
    return (inner, _put(parent_of, device),
            _put(child_starts(parent_of, num_docs), device))


def position_bits(positions: np.ndarray) -> int:
    """Bits of the largest position (at least 1): the position field's
    width in K11's packed sort keys."""
    top = int(positions.max()) if len(positions) else 0
    return max(1, top.bit_length())


def pack_segment(
    segment: Segment,
    device=DEFAULT_DEVICE,
    deleted: np.ndarray | None = None,
    pad_docs_to: int = 0,
    field_min_tiles: dict[str, int] | None = None,
    field_avgdl: dict[str, float] | None = None,
    k1: float = 1.2,
    b: float = 0.75,
    field_pos_min_tiles: dict[str, int] | None = None,
) -> DeviceSegment:
    """Upload a whole Segment to the device (the refresh step).

    `pad_docs_to` / `field_min_tiles` / `field_pos_min_tiles` pad the doc,
    tile and position-tile axes so that several shards' segments share
    one set of shapes (`ops/bm25_device.stack_segment_trees`, the shard
    mesh of parallel/sharded.py); padding docs are dead:
    live False, doc values NaN, never present. `field_avgdl` supplies the
    statistics scope of the precomputed impacts (default: each field's
    own)."""
    device = resolve_device(device)
    n = max(segment.num_docs, pad_docs_to)
    min_tiles = field_min_tiles or {}
    avgdls = field_avgdl or {}
    pos_min_tiles = field_pos_min_tiles or {}
    fields = {
        name: pack_field(
            f, n, device, min_tiles.get(name, 0), avgdls.get(name), k1, b,
            pos_min_tiles.get(name, 0),
        )
        for name, f in segment.fields.items()
    }
    doc_values = {}
    for name, col in segment.doc_values.items():
        padded = np.full(n, np.nan, dtype=np.float32)
        padded[: len(col)] = col.astype(np.float32)
        doc_values[name] = _put(padded, device)
    vectors = {}
    for name, mat in segment.vectors.items():
        padded = np.zeros((n, mat.shape[1]), dtype=np.float32)
        padded[: len(mat)] = mat
        vectors[name] = _put(padded, device)
    live = np.zeros(n, dtype=bool)
    live[: segment.num_docs] = True
    if deleted is not None and len(deleted):
        live[deleted] = False
    nested = {
        path: _nested_entry(
            pack_segment(block.seg, device=device, k1=k1, b=b),
            block.parent_of, n, device,
        )
        for path, block in segment.nested.items()
    }
    return DeviceSegment(
        num_docs=n,
        fields=fields,
        doc_values=doc_values,
        live=_put(live, device),
        sources=segment.sources,
        ids=segment.ids,
        device=device,
        vectors=vectors,
        nested=nested,
    )


def tile_doc_bounds(
    doc_ids: np.ndarray, num_docs: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (min, max) doc id over a host postings array, padded the
    way pack_field pads (sentinel num_docs; bounds stay conservative):
    the host-side planning twin of DeviceField.tile_doc_lo/hi for the
    sharded compiler's _PlanField, which packs no DeviceField."""
    padded = _pad_to_tile(doc_ids.astype(np.int32), np.int32(num_docs))
    tiles = padded.reshape(-1, TILE)
    return tiles.min(axis=1), tiles.max(axis=1)


def device_nbytes(seg: DeviceSegment) -> int:
    """Device bytes held by a packed segment."""
    total = seg.live.nbytes
    for f in seg.fields.values():
        total += f.doc_ids.nbytes + f.tfs.nbytes + f.tn.nbytes
        total += f.norm_bytes.nbytes + f.present.nbytes
        if f.ord_terms is not None:
            total += f.ord_terms.nbytes
        if f.pos_doc is not None:
            total += f.pos_doc.nbytes + f.pos_val.nbytes
    for col in seg.doc_values.values():
        total += col.nbytes
    for mat in seg.vectors.values():
        total += mat.nbytes
    for present in seg.has_vector.values():
        total += present.nbytes
    for inner, parent_of, child_start in seg.nested.values():
        total += device_nbytes(inner) + parent_of.nbytes + child_start.nbytes
    return int(total)


# ---------------------------------------------------------------------------
# Packed multi-tenant planes: several small DeviceSegments concatenated into
# ONE set of shared postings planes, so that one launch scores queries of
# many small indices (ops/bm25_device.execute_batch_packed).
#
# Member m owns the global doc range [doc_base[m], doc_base[m] + n_m) and,
# per field, the tile range [tile_base[m], tile_base[m] + its tiles). Its
# compile view is an ordinary DeviceField over the shared planes whose
# posting offsets and per-tile metadata are shifted into plane coordinates,
# so the unmodified Compiler plans straight into the packed plane with the
# member's own term dictionary, statistics and impacts.
#
# Cross-tenant isolation is structural (a plan's worklist tiles all lie in
# its member's tile range) and enforced: the packed executor masks
# eligibility to the member's [lo, hi) doc bounds.
# ---------------------------------------------------------------------------


@dataclass
class PackedField:
    """One field's postings for ALL members, concatenated on the device."""

    name: str
    doc_ids: torch.Tensor  # int32[NT_total, TILE], GLOBAL ids, sentinel N_total
    tfs: torch.Tensor  # float32[NT_total, TILE]
    tn: torch.Tensor  # float32[NT_total, TILE] impacts (per-member stats)
    norm_bytes: torch.Tensor  # uint8[N_total + 1]
    present: torch.Tensor  # bool[N_total]
    tile_base: dict[int, int]  # member index -> first global tile
    views: dict[int, DeviceField]  # member index -> compile view


@dataclass
class PackedPlane:
    """Several small DeviceSegments concatenated into shared tile planes."""

    num_docs: int  # total packed doc space (sum of member doc spaces)
    doc_base: list[int]  # member index -> global doc-id base
    doc_count: list[int]  # member index -> member doc-space size
    fields: dict[str, PackedField]
    live: torch.Tensor  # bool[N_total], the members' live masks in order

    @property
    def n_members(self) -> int:
        return len(self.doc_base)

    def member_bounds(self, member: int) -> tuple[int, int]:
        """GLOBAL [lo, hi) doc-id bounds of one member: the per-lane mask
        the packed executor applies, so no other member's doc can appear
        in this member's results."""
        lo = self.doc_base[member]
        return lo, lo + self.doc_count[member]

    def member_fields(self, member: int) -> dict[str, DeviceField]:
        """Compile views of one member: a dict shaped exactly like
        DeviceSegment.fields, sharing the packed device planes."""
        return {
            name: pf.views[member]
            for name, pf in self.fields.items()
            if member in pf.views
        }


def _shifted_tile_plane(local, tile_base: int, total_tiles: int, fill=0.0,
                        out=None):
    """Host per-tile metadata (tile_max, doc bounds) of one member placed
    at its global tile range [tile_base, tile_base + len(local)) of a
    plane-wide array of `total_tiles` entries (`fill` elsewhere). With
    `out`, the member writes into that shared array instead: every view
    of a packed field shares one array, since a member's plan reads only
    its own tile range (one array per field, not one per member)."""
    if local is None:
        return out
    local = np.asarray(local)
    if out is None:
        out = np.full(total_tiles, fill, dtype=local.dtype)
    out[tile_base : tile_base + len(local)] = local
    return out


def pack_field_packed(
    name: str,
    members: list[tuple[DeviceField | None, int, int]],
    n_total: int,
) -> PackedField | None:
    """Concatenate one field's member planes into a packed field.

    `members`: (DeviceField or None when the member lacks the field,
    member doc base, member doc-space size) per member, in member order.
    Returns None when no member has the field.

    Doc ids become global ids, each member's padding sentinel (its local
    num_docs) rewritten to the GLOBAL sentinel n_total BEFORE the base
    shift, so a member's pad slot scatters into the plane's discard slot
    and never into the doc range of the member after it. Norm bytes and
    presence land at the member's doc range; a member without the field
    contributes zeros (norm 0, not present), never another member's
    bytes. Everything concatenates on the device: no postings, norms or
    presence come back to the host."""
    present_members = [df for df, _b, _n in members if df is not None]
    if not present_members:
        return None
    device = present_members[0].doc_ids.device
    id_parts, tf_parts, tn_parts = [], [], []
    norm_parts, present_parts = [], []
    tile_base: dict[int, int] = {}
    shifted: list[tuple[int, DeviceField, int, int, int]] = []
    tiles = 0
    for m, (dfield, base, n_member) in enumerate(members):
        if dfield is None:
            norm_parts.append(torch.zeros(n_member, dtype=torch.uint8,
                                          device=device))
            present_parts.append(torch.zeros(n_member, dtype=torch.bool,
                                             device=device))
            continue
        ids = dfield.doc_ids
        id_parts.append(torch.where(
            ids == n_member,
            torch.full_like(ids, n_total),
            ids + base,
        ))
        tf_parts.append(dfield.tfs)
        tn_parts.append(dfield.tn)
        norm_parts.append(dfield.norm_bytes[:n_member])
        present_parts.append(dfield.present[:n_member])
        tile_base[m] = tiles
        shifted.append((m, dfield, base, n_member, tiles))
        tiles += dfield.doc_ids.shape[0]
    doc_ids = torch.cat(id_parts)
    tfs = torch.cat(tf_parts)
    tn = torch.cat(tn_parts)
    norm_parts.append(torch.zeros(1, dtype=torch.uint8, device=device))
    norm_bytes = torch.cat(norm_parts)
    present = torch.cat(present_parts)
    # One plane-wide array per per-tile attribute, shared by every view.
    tile_max = tile_lo = tile_hi = None
    for m, dfield, base, n_member, tbase in shifted:
        lo, hi = dfield.tile_doc_lo, dfield.tile_doc_hi
        if lo is not None:
            # Real ids shift by the member base; a bound that IS the
            # member sentinel stays the (global) sentinel, so range
            # pruning stays conservative at partly padded tiles.
            lo = np.where(lo == n_member, n_total, lo + base).astype(np.int64)
            hi = np.where(hi == n_member, n_total, hi + base).astype(np.int64)
        tile_max = _shifted_tile_plane(dfield.tile_max, tbase, tiles,
                                       out=tile_max)
        tile_lo = _shifted_tile_plane(lo, tbase, tiles, fill=n_total,
                                      out=tile_lo)
        tile_hi = _shifted_tile_plane(hi, tbase, tiles, fill=n_total,
                                      out=tile_hi)
    views: dict[int, DeviceField] = {}
    for m, dfield, _base, _n_member, tbase in shifted:
        views[m] = DeviceField(
            name=name,
            terms=dfield.terms,
            df=dfield.df,
            # Posting positions shift with the member's tile range, so the
            # unmodified Compiler plans straight into packed coordinates.
            offsets=dfield.offsets + np.int64(tbase * TILE),
            doc_count=dfield.doc_count,
            sum_total_tf=dfield.sum_total_tf,
            has_norms=dfield.has_norms,
            doc_ids=doc_ids,
            tfs=tfs,
            norm_bytes=norm_bytes,
            present=present,
            tn=tn,
            tn_avgdl=dfield.tn_avgdl,
            tn_k1=dfield.tn_k1,
            tn_b=dfield.tn_b,
            tile_max=None if dfield.tile_max is None else tile_max,
            tile_doc_lo=None if dfield.tile_doc_lo is None else tile_lo,
            tile_doc_hi=None if dfield.tile_doc_hi is None else tile_hi,
        )
    return PackedField(
        name=name,
        doc_ids=doc_ids,
        tfs=tfs,
        tn=tn,
        norm_bytes=norm_bytes,
        present=present,
        tile_base=tile_base,
        views=views,
    )


def pack_segments_packed(segments: list[DeviceSegment]) -> PackedPlane:
    """Concatenate several small DeviceSegments into one PackedPlane.

    Member order fixes the tenant dimension: member m owns the doc range
    [doc_base[m], doc_base[m] + num_docs). Only the inverted fields' postings
    planes pack (doc values, vectors, positions, ordinals and nested blocks
    stay per tenant: the packed executor's eligibility gate routes queries
    needing them to the tenant's own path)."""
    doc_base: list[int] = []
    doc_count: list[int] = []
    n_total = 0
    for seg in segments:
        doc_base.append(n_total)
        doc_count.append(seg.num_docs)
        n_total += seg.num_docs
    field_names = sorted({n for seg in segments for n in seg.fields})
    fields: dict[str, PackedField] = {}
    for name in field_names:
        members = [
            (seg.fields.get(name), doc_base[m], seg.num_docs)
            for m, seg in enumerate(segments)
        ]
        pf = pack_field_packed(name, members, n_total)
        if pf is not None:
            fields[name] = pf
    return PackedPlane(
        num_docs=n_total,
        doc_base=doc_base,
        doc_count=doc_count,
        fields=fields,
        live=torch.cat([seg.live for seg in segments]),
    )


def packed_device_nbytes(plane: PackedPlane) -> int:
    """Device bytes the packed plane itself holds (it duplicates its
    members' postings: the price of one-launch multi-tenant scoring)."""
    total = plane.live.nbytes
    for pf in plane.fields.values():
        total += pf.doc_ids.nbytes + pf.tfs.nbytes + pf.tn.nbytes
        total += pf.norm_bytes.nbytes + pf.present.nbytes
    return int(total)


# Host planning attributes a DeviceField carries beside its planes.
FIELD_META_KEYS = (
    "terms", "df", "offsets", "doc_count", "sum_total_tf", "has_norms",
    "tn_avgdl", "tn_k1", "tn_b", "tile_max", "tile_doc_lo", "tile_doc_hi",
    "pos_offsets",
)


def field_meta(dfield) -> dict[str, Any]:
    """The host planning attributes of any device field (duck-typed)."""
    return {key: getattr(dfield, key, None) for key in FIELD_META_KEYS}


def device_segment_from_numpy(
    planes: dict,
    fields_meta: dict[str, dict[str, Any]],
    sources: list | None = None,
    ids: list | None = None,
    device=DEFAULT_DEVICE,
) -> DeviceSegment:
    """Build a DeviceSegment from numpy planes packed elsewhere.

    `planes` is a segment-tree view as numpy: {"fields": {name: (doc_ids,
    tn, tfs, norm_bytes, present)}, "doc_values": {name: f32[N]},
    "vectors": {name: f32[N, dims]}, "ordinals": {name: i32[NT, 256]},
    "positions": {name: (pos_doc, pos_val)}, "live": bool[N], "nested":
    {path: {"tree": <the inner segment's planes, this same layout>,
    "parent_of": i32[NN]}}} (the JAX package's `segment_tree(dev)` /
    `agg_segment_tree(dev)` leaves after np.asarray). `fields_meta` maps
    each field to its host planning attributes (`field_meta`); a nested
    block's fields are there too, under their full dotted names."""
    device = resolve_device(device)
    live = np.asarray(planes["live"], dtype=bool)
    n = int(live.shape[0])
    fields = {}
    ordinals = planes.get("ordinals", {})
    positions = planes.get("positions", {})
    for name, leaves in planes["fields"].items():
        doc_ids, tn, tfs, norm_bytes, present = (np.asarray(x) for x in leaves)
        meta = fields_meta[name]
        ords = ordinals.get(name)
        pos = {}
        if name in positions:
            pd, pv = (np.asarray(x, dtype=np.int32) for x in positions[name])
            pos = {"pos_doc": _put(pd, device), "pos_val": _put(pv, device),
                   "pos_bits": position_bits(pv.reshape(-1))}
        fields[name] = DeviceField(
            ord_terms=None if ords is None else _put(
                np.asarray(ords, dtype=np.int32), device),
            name=name,
            doc_ids=_put(doc_ids.astype(np.int32), device),
            tn=_put(tn.astype(np.float32), device),
            tfs=_put(tfs.astype(np.float32), device),
            norm_bytes=_put(norm_bytes.astype(np.uint8), device),
            present=_put(present.astype(bool), device),
            **meta,
            **pos,
        )
    doc_values = {
        name: _put(np.asarray(col, dtype=np.float32), device)
        for name, col in planes.get("doc_values", {}).items()
    }
    vectors = {
        name: _put(np.asarray(mat, dtype=np.float32), device)
        for name, mat in planes.get("vectors", {}).items()
    }
    nested = {
        path: _nested_entry(
            device_segment_from_numpy(blk["tree"], fields_meta, device=device),
            blk["parent_of"], n, device,
        )
        for path, blk in planes.get("nested", {}).items()
    }
    return DeviceSegment(
        num_docs=n,
        fields=fields,
        doc_values=doc_values,
        live=_put(live, device),
        sources=list(sources) if sources is not None else [None] * n,
        ids=list(ids) if ids is not None else [str(i) for i in range(n)],
        device=device,
        vectors=vectors,
        nested=nested,
    )
