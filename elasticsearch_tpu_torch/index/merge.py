"""Tokenization-free segment merges: posting concatenation as array ops.

Port of elasticsearch_tpu/index/merge.py, trimmed to what the mesh view
needs: `compact_segment` (one segment with its dead docs purged and its
locals renumbered, a `np.flatnonzero(live)` gather; nested blocks compact
with their parents), `concat_segments` (all-live segments concatenated
into one: per-field term-dictionary union, doc ids rebased by cumulative
offsets, postings re-sorted term-major with one stable argsort, positions
carried along, statistics folded arithmetically), their helpers
`_csr_term_of`, `_terms_by_tid`, `_gather_csr`, `_field_present`,
`compact_field` and `_concat_fields`, and `merged_live_segment`, the
composition of the two. The output equals what `SegmentBuilder` builds
from re-adding the same live docs in the same order, array for array
(tests/test_torch_merge.py holds both functions to the reference's), and
no analyzer runs here. Left out: the completion and percolator entries
(the port's segments have neither) and the engine's merge policy, which
calls these in the reference (ROADMAP queue A6).
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np

from .segment import FieldIndex, NestedBlock, Segment


def _csr_term_of(fi: FieldIndex) -> np.ndarray:
    """int64[P]: owning term id of every posting (CSR expansion)."""
    return np.repeat(
        np.arange(len(fi.df), dtype=np.int64),
        np.diff(fi.offsets).astype(np.int64),
    )


def _terms_by_tid(fi: FieldIndex) -> list[str]:
    """Term names indexed by term id (inverse of the terms dict)."""
    names: list[str] = [""] * len(fi.df)
    for term, tid in fi.terms.items():
        names[tid] = term
    return names


def _gather_csr(
    values: np.ndarray, offsets: np.ndarray, order: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Reorder a CSR payload by a row selection: row i of the output is
    the payload of input row order[i] (offsets int64[R + 1]). Returns
    (values', offsets')."""
    counts = np.diff(offsets).astype(np.int64)[order]
    out_off = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    total = int(out_off[-1])
    if total == 0:
        return values[:0].copy(), out_off
    starts = offsets[:-1][order]
    idx = (
        np.repeat(starts, counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(out_off[:-1], counts)
    )
    return values[idx], out_off


def _field_present(fi: FieldIndex) -> np.ndarray:
    """The presence bitmap, with the norm-byte fallback the packer uses
    (tiles._fit_bool), so that the two can never diverge."""
    if len(fi.present):
        return fi.present
    return fi.norm_bytes > 0


def compact_field(
    fi: FieldIndex, keep: np.ndarray, old_to_new: np.ndarray, n_new: int
) -> FieldIndex | None:
    """Live-only copy of one field, locals renumbered via `old_to_new`;
    None when no surviving doc carries the field (a re-add would not
    register it)."""
    keep_idx = np.flatnonzero(keep)
    present = _field_present(fi)[keep_idx]
    post_keep = keep[fi.doc_ids]
    if not present.any() and not post_keep.any():
        return None
    term_of = _csr_term_of(fi)[post_keep]
    doc_ids = old_to_new[fi.doc_ids[post_keep]].astype(np.int32)
    tfs = fi.tfs[post_keep]
    df_full = np.bincount(term_of, minlength=len(fi.df))
    keep_terms = df_full > 0
    # Surviving terms keep their sorted relative order: renumbering is a
    # prefix sum, and the dict stays in a fresh build's order.
    new_tid = np.cumsum(keep_terms) - 1
    names = _terms_by_tid(fi)
    terms = {
        names[tid]: int(new_tid[tid]) for tid in np.flatnonzero(keep_terms)
    }
    df = df_full[keep_terms].astype(np.int32)
    offsets = np.zeros(len(df) + 1, dtype=np.int64)
    np.cumsum(df, out=offsets[1:])
    pos_offsets = positions = None
    if fi.positions is not None:
        positions, pos_offsets = _gather_csr(
            fi.positions, fi.pos_offsets, np.flatnonzero(post_keep)
        )
    norm_bytes = fi.norm_bytes[keep_idx]
    doc_count = int(np.count_nonzero(np.bincount(doc_ids, minlength=n_new)))
    sum_total_tf = int(round(float(tfs.astype(np.float64).sum())))
    return FieldIndex(
        name=fi.name,
        terms=terms,
        df=df,
        offsets=offsets,
        doc_ids=doc_ids,
        tfs=tfs,
        norm_bytes=norm_bytes,
        doc_count=doc_count,
        sum_total_tf=sum_total_tf,
        has_norms=fi.has_norms,
        present=present.copy(),
        pos_offsets=pos_offsets,
        positions=positions,
    )


def compact_segment(segment: Segment, live: np.ndarray) -> Segment:
    """Purge dead docs from one segment; locals renumber densely, in
    ascending old local order. An inner nested doc survives iff its
    parent does; inner ids regenerate as str(local), as a fresh
    sub-builder numbers them. An all-live segment passes through."""
    live = np.asarray(live, dtype=bool)
    if live.all():
        return segment
    keep_idx = np.flatnonzero(live)
    n_new = len(keep_idx)
    old_to_new = np.full(segment.num_docs, -1, dtype=np.int64)
    old_to_new[keep_idx] = np.arange(n_new, dtype=np.int64)
    fields: dict[str, FieldIndex] = {}
    for name, fi in segment.fields.items():
        out = compact_field(fi, live, old_to_new, n_new)
        if out is not None:
            fields[name] = out
    doc_values = {}
    for name, col in segment.doc_values.items():
        new_col = col[keep_idx]
        if not np.all(np.isnan(new_col)):
            doc_values[name] = new_col
    vectors = {}
    for name, mat in segment.vectors.items():
        new_mat = mat[keep_idx]
        # Kept iff any row is non-zero: the kNN kernels' zero-row rule
        # (a zero row is a doc without a vector).
        if np.any(new_mat):
            vectors[name] = new_mat
    versions = (
        segment.versions[keep_idx]
        if segment.versions is not None
        else np.ones(n_new, dtype=np.int64)
    )
    seqnos = (
        segment.seqnos[keep_idx]
        if segment.seqnos is not None
        else np.full(n_new, -1, dtype=np.int64)
    )
    nested: dict[str, NestedBlock] = {}
    for path, block in segment.nested.items():
        inner_live = live[block.parent_of]
        inner = compact_segment(block.seg, inner_live)
        if inner.num_docs == 0:
            continue
        parent_of = old_to_new[
            block.parent_of[np.flatnonzero(inner_live)]
        ].astype(np.int32)
        inner = dc_replace(inner, ids=[str(i) for i in range(inner.num_docs)])
        nested[path] = NestedBlock(seg=inner, parent_of=parent_of)
    return Segment(
        num_docs=n_new,
        fields=fields,
        doc_values=doc_values,
        vectors=vectors,
        sources=[segment.sources[int(i)] for i in keep_idx],
        ids=[segment.ids[int(i)] for i in keep_idx],
        versions=versions,
        seqnos=seqnos,
        nested=nested,
    )


def _concat_fields(
    members: list[tuple[FieldIndex | None, int, int]], union_names: list[str]
) -> FieldIndex:
    """Merge one field across members, given per member (field or None,
    doc base, doc count) in member order, and the field's sorted
    cross-member vocabulary."""
    union = {name: i for i, name in enumerate(union_names)}
    t_union = len(union_names)
    term_parts, doc_parts, tf_parts = [], [], []
    pos_count_parts, pos_parts = [], []
    norm_parts, present_parts = [], []
    doc_count = 0
    sum_total_tf = 0
    has_norms = True
    # A text field's members all carry (possibly empty) position arrays.
    with_positions = any(
        fi is not None and fi.positions is not None for fi, _b, _n in members
    )
    for fi, base, n_member in members:
        if fi is None:
            norm_parts.append(np.zeros(n_member, dtype=np.uint8))
            present_parts.append(np.zeros(n_member, dtype=bool))
            continue
        has_norms = fi.has_norms
        names = _terms_by_tid(fi)
        tid_map = np.fromiter(
            (union[t] for t in names), dtype=np.int64, count=len(names)
        )
        term_parts.append(tid_map[_csr_term_of(fi)])
        doc_parts.append(fi.doc_ids.astype(np.int64) + base)
        tf_parts.append(fi.tfs)
        if with_positions:
            if fi.positions is not None:
                pos_count_parts.append(np.diff(fi.pos_offsets).astype(np.int64))
                pos_parts.append(fi.positions)
            else:
                pos_count_parts.append(np.zeros(len(fi.doc_ids), dtype=np.int64))
        norm_parts.append(fi.norm_bytes)
        present_parts.append(_field_present(fi))
        doc_count += fi.doc_count
        sum_total_tf += fi.sum_total_tf
    term_of = (
        np.concatenate(term_parts) if term_parts else np.empty(0, dtype=np.int64)
    )
    # Stable: within a term, member order and each member's ascending
    # locals hold, so the postings come out doc-ascending per term.
    order = np.argsort(term_of, kind="stable")
    doc_ids = (
        np.concatenate(doc_parts)[order].astype(np.int32)
        if doc_parts else np.empty(0, dtype=np.int32)
    )
    tfs = (
        np.concatenate(tf_parts)[order]
        if tf_parts else np.empty(0, dtype=np.float32)
    )
    df = np.bincount(term_of, minlength=t_union).astype(np.int32)
    offsets = np.zeros(t_union + 1, dtype=np.int64)
    np.cumsum(df, out=offsets[1:])
    pos_offsets = positions = None
    if with_positions:
        counts = (
            np.concatenate(pos_count_parts)
            if pos_count_parts else np.empty(0, dtype=np.int64)
        )
        flat = (
            np.concatenate(pos_parts) if pos_parts else np.empty(0, dtype=np.int32)
        )
        src_off = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=src_off[1:])
        positions, pos_offsets = _gather_csr(flat, src_off, order)
    return FieldIndex(
        name=next(fi.name for fi, _b, _n in members if fi is not None),
        terms=union,
        df=df,
        offsets=offsets,
        doc_ids=doc_ids,
        tfs=tfs,
        norm_bytes=np.concatenate(norm_parts),
        doc_count=doc_count,
        sum_total_tf=sum_total_tf,
        has_norms=has_norms,
        present=np.concatenate(present_parts),
        pos_offsets=pos_offsets,
        positions=positions,
    )


def concat_segments(segments: list[Segment]) -> Segment:
    """Concatenate all-live segments into one, doc ids rebased in order
    (pair with compact_segment). A single input passes through; none
    gives an empty segment."""
    if len(segments) == 1:
        return segments[0]
    if not segments:
        return Segment(
            num_docs=0, fields={}, doc_values={}, vectors={}, sources=[],
            ids=[], versions=np.empty(0, dtype=np.int64),
            seqnos=np.empty(0, dtype=np.int64),
        )
    bases: list[int] = []
    n_total = 0
    for seg in segments:
        bases.append(n_total)
        n_total += seg.num_docs
    fields: dict[str, FieldIndex] = {}
    for name in sorted({n for seg in segments for n in seg.fields}):
        vocab = sorted({
            t for seg in segments if name in seg.fields
            for t in seg.fields[name].terms
        })
        fields[name] = _concat_fields(
            [(seg.fields.get(name), bases[m], seg.num_docs)
             for m, seg in enumerate(segments)],
            vocab,
        )
    doc_values: dict[str, np.ndarray] = {}
    for name in sorted({n for seg in segments for n in seg.doc_values}):
        col = np.full(n_total, np.nan, dtype=np.float64)
        for m, seg in enumerate(segments):
            src = seg.doc_values.get(name)
            if src is not None:
                col[bases[m] : bases[m] + seg.num_docs] = src
        doc_values[name] = col
    vectors: dict[str, np.ndarray] = {}
    for name in sorted({n for seg in segments for n in seg.vectors}):
        dim = next(
            seg.vectors[name].shape[1] for seg in segments
            if name in seg.vectors
        )
        mat = np.zeros((n_total, dim), dtype=np.float32)
        for m, seg in enumerate(segments):
            src = seg.vectors.get(name)
            if src is not None:
                mat[bases[m] : bases[m] + seg.num_docs] = src
        vectors[name] = mat
    versions = np.concatenate([
        seg.versions if seg.versions is not None
        else np.ones(seg.num_docs, dtype=np.int64)
        for seg in segments
    ])
    seqnos = np.concatenate([
        seg.seqnos if seg.seqnos is not None
        else np.full(seg.num_docs, -1, dtype=np.int64)
        for seg in segments
    ])
    nested: dict[str, NestedBlock] = {}
    for path in sorted({p for seg in segments for p in seg.nested}):
        inner_segs, parent_parts = [], []
        for m, seg in enumerate(segments):
            block = seg.nested.get(path)
            if block is None:
                continue
            inner_segs.append(block.seg)
            parent_parts.append(block.parent_of.astype(np.int64) + bases[m])
        inner = concat_segments(inner_segs)
        inner = dc_replace(inner, ids=[str(i) for i in range(inner.num_docs)])
        nested[path] = NestedBlock(
            seg=inner,
            parent_of=np.concatenate(parent_parts).astype(np.int32),
        )
    sources: list = []
    ids: list[str] = []
    for seg in segments:
        sources.extend(seg.sources)
        ids.extend(seg.ids)
    return Segment(
        num_docs=n_total,
        fields=fields,
        doc_values=doc_values,
        vectors=vectors,
        sources=sources,
        ids=ids,
        versions=versions,
        seqnos=seqnos,
        nested=nested,
    )


def merged_live_segment(
    segments: list[Segment], live_masks: list[np.ndarray]
) -> Segment:
    """One live-docs-only segment from several (segment, live mask)
    pairs: compact each, then concatenate."""
    return concat_segments([
        compact_segment(seg, live) for seg, live in zip(segments, live_masks)
    ])
