"""Sharded search over a device mesh: the scatter-gather as collectives.

Port of elasticsearch_tpu/parallel/sharded.py (kernel-table row 23).
Kept: `_empty_field`, `union_schema`, `fill_union_schema`, `ShardedIndex`
(`from_docs`, `from_segments` with its nested refusal, `field_stats`,
`_tn_avgdl`, `shard_compiler`, `compile`, `compile_batch`,
`compile_batch_buckets`, `search`, `search_batch`, `locate`),
`_PlanField`, `_max_nt` and the three shard_map bodies,
`sharded_execute`, `sharded_execute_request` and `sharded_execute_batch`,
over parallel/mesh.py's mesh; and the filter cache's mesh half
(`filter_cache`, `cache_scope`, `cache_generation`,
`_apply_filter_cache`, and `search` with masks). Left out: `instruments`
/ `timed_launch` (device observability, A12).

The reference runs one SPMD program: every shard's planes stacked on a
leading mesh axis, one `shard_map` body per device, `all_gather` of the
shards' [k] top-k planes and `psum` of their totals. Here each shard
keeps its own device tree (`ShardedIndex.trees`), packed to the union
shapes (`n_pad` docs, `min_tiles` per field, `pos_min_tiles` per text
field, the union of doc-value and vector columns), so that the compiled
plan arrays, stacked [S, ...] on the host, index every shard alike. A
body is the port's single-segment path run on one shard's tree on its
own device: `execute_batch_auto` (K1-K4, and K11-K14 for positional and
structured plans) for a plain search, the dense evaluation then K3 / K3k
for sorted, cursored and aggregating requests, and `_eval_agg` over K10.
The bodies launch in shard order (mesh.run_bodies) and read nothing back
to the host before the gather. The merge of the gathered [S * kk] planes
runs on K3's merge mode (`masked_topk.cu`; rows longer than
`kernels.MERGE_MAX_M` on K3's row mode with an all-true mask), which also
takes the merged ids: the key is each shard's top scores, or, for a
field sort, the negated ascending merge key, as the reference's
`top_k(-all_key)` orders it;
equal keys keep the lower flat index, (shard, per-shard rank), first.
Totals, `n_after` and aggregation count planes are mesh.psum's integer
sums; float planes come back stacked.

Global term statistics: `field_stats` aggregates statistics across
shards at plan time (the DFS phase), so scores do not depend on routing.
Doc addressing: global doc = shard * docs_per_shard + local (`locate`).

Filter cache: the reference's [S, N] stacked plane of a cached clause is
here the tuple of its S rows, row s on shard s's device (`ShardPlanes`),
each row `compute_filter_mask` over shard s's tree and plan row, which is
bit for bit `compute_filter_mask_stacked` over the stacked tree; the
bodies read row s as their segment's `seg["masks"][slot]`
(`trees_with_masks`).
On a 2D (replica x shard) mesh the index is replicated over the replica
axis: the replica rows that sit on one device share that shard's tree,
and another device gets one copy, made on first use.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field, replace as dc_replace
from typing import Any

import itertools

import numpy as np
import torch

from ..index.mapping import Mappings
from ..index.segment import FieldIndex, Segment, SegmentBuilder
from ..index.tiles import TILE, pack_segment, tile_doc_bounds
from ..ops import bm25_device, kernels
from ..ops.aggs_device import agg_segment_tree
from ..ops.bm25 import BM25Params
from ..query.compile import (
    CompiledQuery,
    Compiler,
    FieldStats,
    SpecUnifyError,
    aggregate_field_stats,
    equalize_compiled,
    pad_arrays_to_spec,
    unify_specs,
)
from ..query.dsl import Query
from . import mesh as mesh_ops
from .mesh import Mesh
from .routing import shard_for_id

NEG_INF = float("-inf")

_SHARDED_UIDS = itertools.count(1)


class ShardPlanes(tuple):
    """A filter-cache plane over S shards: S bool[N] rows, row s on shard
    s's device (the reference's [S, N] stacked plane)."""

    @property
    def nbytes(self) -> int:
        return sum(r.numel() * r.element_size() for r in self)


def trees_with_masks(trees: list, masks: dict) -> list:
    """Each shard's tree carrying its rows of the request's filter-cache
    planes as `seg["masks"]`."""
    if not masks:
        return trees
    return [
        {**tree, "masks": {slot: rows[s] for slot, rows in masks.items()}}
        for s, tree in enumerate(trees)
    ]


def _empty_field(name: str, num_docs: int, has_norms: bool) -> FieldIndex:
    return FieldIndex(
        name=name,
        terms={},
        df=np.zeros(0, dtype=np.int32),
        offsets=np.zeros(1, dtype=np.int64),
        doc_ids=np.zeros(0, dtype=np.int32),
        tfs=np.zeros(0, dtype=np.float32),
        norm_bytes=np.zeros(num_docs, dtype=np.uint8),
        doc_count=0,
        sum_total_tf=0,
        has_norms=has_norms,
        present=np.zeros(num_docs, dtype=bool),
        # Text fields carry (empty) position planes so every shard's tree
        # has the same structure.
        pos_offsets=np.zeros(1, dtype=np.int64) if has_norms else None,
        positions=np.zeros(0, dtype=np.int32) if has_norms else None,
    )


def union_schema(
    segments: list[Segment],
) -> tuple[dict[str, bool], set[str], dict[str, int]]:
    """Cross-shard union of (field -> has_norms, doc-value names, vector
    field -> dim): the uniform-schema invariant every shard's tree
    keeps."""
    fields: dict[str, bool] = {}
    dv: set[str] = set()
    vec: dict[str, int] = {}
    for seg in segments:
        for name, fld in seg.fields.items():
            fields[name] = fld.has_norms
        dv.update(seg.doc_values)
        for name, mat in seg.vectors.items():
            vec[name] = mat.shape[1]
    return fields, dv, vec


def fill_union_schema(
    seg: Segment,
    fields: dict[str, bool],
    dv: set[str],
    vec: dict[str, int],
) -> Segment:
    """A shallow copy of `seg` carrying the union schema (missing fields
    empty, doc-value columns NaN, vector columns zero); `seg` itself is
    never changed (a serving snapshot may share it)."""
    new_fields = dict(seg.fields)
    for name, has_norms in fields.items():
        if name not in new_fields:
            new_fields[name] = _empty_field(name, seg.num_docs, has_norms)
    new_dv = dict(seg.doc_values)
    for name in dv:
        if name not in new_dv:
            new_dv[name] = np.full(seg.num_docs, np.nan)
    new_vec = dict(seg.vectors)
    for name, dim in vec.items():
        if name not in new_vec:
            new_vec[name] = np.zeros((seg.num_docs, dim), dtype=np.float32)
    return dc_replace(seg, fields=new_fields, doc_values=new_dv,
                      vectors=new_vec)


def _stack(arrays_list: list) -> Any:
    """Same-structure numpy plans stacked along a new leading axis (the
    reference's jax.tree.map(np.stack, ...))."""
    return bm25_device.stack_plans(arrays_list)


@dataclass
class ShardedIndex:
    """N shards, one device tree each on its mesh device, searchable as
    one request."""

    mesh: Mesh
    axis: str
    mappings: Mappings
    segments: list[Segment]  # host-side, for stats + fetch phase
    trees: list[dict]  # per-shard device trees (agg_segment_tree)
    docs_per_shard: int  # padded per-shard doc capacity (global id stride)
    params: BM25Params
    _stats_cache: dict[str, FieldStats] | None = None
    _id_indexes: list[dict[str, int] | None] | None = None
    # Memoized per-(shard, field) tile doc-id bounds for plan-time
    # conjunction range pruning (shards are immutable).
    _tile_bounds: dict | None = None
    # (shard, device) -> that shard's tree on another device of a 2D mesh.
    _replicas: dict = dc_field(default_factory=dict)
    # index.filter_cache.FilterCache: when set, `search` substitutes
    # cacheable filter-context clauses with per-shard planes (shards are
    # immutable, so they never go stale; the cache's LRU and byte budget
    # bound their residency).
    filter_cache: Any = None
    # Cache-key scope and generation: MeshView sets the engines' uid tuple
    # and their generation sum; None is this instance's own uid, pinned
    # at generation 0.
    cache_scope: Any = None
    cache_generation: int = 0
    _cache_uid: int = dc_field(default_factory=lambda: next(_SHARDED_UIDS))

    def _field_tile_bounds(self, shard: int, name: str):
        if self._tile_bounds is None:
            self._tile_bounds = {}
        key = (shard, name)
        if key not in self._tile_bounds:
            fld = self.segments[shard].fields.get(name)
            if fld is None or not len(fld.doc_ids):
                self._tile_bounds[key] = (None, None)
            else:
                self._tile_bounds[key] = tile_doc_bounds(
                    fld.doc_ids, self.segments[shard].num_docs
                )
        return self._tile_bounds[key]

    def _id_index(self, shard: int) -> dict[str, int]:
        """Memoized _id -> local map per shard."""
        if self._id_indexes is None:
            self._id_indexes = [None] * len(self.segments)
        if self._id_indexes[shard] is None:
            self._id_indexes[shard] = {
                d: i for i, d in enumerate(self.segments[shard].ids)
            }
        return self._id_indexes[shard]

    @classmethod
    def from_docs(
        cls,
        docs: list[tuple[str, dict]],
        mappings: Mappings,
        mesh: Mesh,
        axis: str = "shard",
        params: BM25Params = BM25Params(),
    ) -> "ShardedIndex":
        """Route (id, source) docs to shards and build the index."""
        n_shards = mesh.shape[axis]
        builders = [SegmentBuilder(mappings) for _ in range(n_shards)]
        for doc_id, source in docs:
            builders[shard_for_id(doc_id, n_shards)].add(source, doc_id)
        return cls.from_segments(
            [b.build() for b in builders], mappings, mesh, axis, params
        )

    @classmethod
    def from_segments(
        cls,
        segments: list[Segment],
        mappings: Mappings,
        mesh: Mesh,
        axis: str = "shard",
        params: BM25Params = BM25Params(),
    ) -> "ShardedIndex":
        n_shards = mesh.shape[axis]
        if len(segments) != n_shards:
            raise ValueError(
                f"{len(segments)} segments for a {n_shards}-shard mesh axis"
            )
        if any(s.nested for s in segments):
            raise ValueError(
                "nested blocks are not mesh-stackable yet; serve nested "
                "indices through the host-loop coordinator"
            )
        # Uniform schema: every shard carries the union of fields/columns.
        all_fields, all_dv, all_vec = union_schema(segments)
        n_pad = max([s.num_docs for s in segments] + [1])
        min_tiles: dict[str, int] = {}
        pos_min_tiles: dict[str, int] = {}
        for seg in segments:
            for name in all_fields:
                fld = seg.fields.get(name)
                postings = len(fld.doc_ids) if fld is not None else 0
                tiles = postings // TILE + 2  # data tiles + sentinel tile
                min_tiles[name] = max(min_tiles.get(name, 0), tiles)
                npos = (
                    len(fld.positions)
                    if fld is not None and fld.positions is not None
                    else 0
                )
                if all_fields[name]:  # text field: position planes too
                    pos_min_tiles[name] = max(
                        pos_min_tiles.get(name, 0), npos // TILE + 2
                    )
        # Global (cross-shard) avgdl so the precomputed impacts match the
        # DFS statistics the compiler scores with.
        global_stats = aggregate_field_stats(segments)
        global_avgdl = {name: s.avgdl for name, s in global_stats.items()}
        segments = [
            fill_union_schema(seg, all_fields, all_dv, all_vec)
            for seg in segments
        ]
        trees = [
            agg_segment_tree(pack_segment(
                seg,
                device=dev,
                pad_docs_to=n_pad,
                field_min_tiles=min_tiles,
                field_avgdl=global_avgdl,
                k1=params.k1,
                b=params.b,
                field_pos_min_tiles=pos_min_tiles,
            ))
            for seg, dev in zip(segments, mesh.axis_devices(axis))
        ]
        return cls(
            mesh=mesh,
            axis=axis,
            mappings=mappings,
            segments=segments,
            trees=trees,
            docs_per_shard=n_pad,
            params=params,
        )

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def tree_on(self, shard: int, device: torch.device) -> dict:
        """Shard `shard`'s tree on `device`: its own, or one copy per
        other device of a 2D mesh, made on first use."""
        tree = self.trees[shard]
        if tree["live"].device == device:
            return tree
        key = (shard, device)
        if key not in self._replicas:
            self._replicas[key] = _tree_to(tree, device)
        return self._replicas[key]

    def field_stats(self) -> dict[str, FieldStats]:
        """Cross-shard statistics (the DFS phase), computed at plan time
        and cached: shards are immutable."""
        if self._stats_cache is None:
            self._stats_cache = aggregate_field_stats(self.segments)
        return self._stats_cache

    def _tn_avgdl(self, shard: int, field: str, fstats) -> float:
        """The statistics scope the packed impact (tn) planes are valid
        for: the aggregated statistics `compile` scores with, so the
        precomputed-impact kernels apply. MeshIndex overrides it with the
        pack-time avgdl, so a drift since the pack routes the compiler to
        the norm-cache gather (`terms_gather`)."""
        return float(fstats.avgdl) if fstats else 1.0

    def shard_compiler(self, shard: int, nt_floor: int = 1) -> Compiler:
        """Host-side planning view of one shard over the offsets its tree
        holds: the per-shard Compiler behind `compile`, also used by the
        mesh view to lower aggregation plans into shard-uniform specs."""
        stats = self.field_stats()
        seg = self.segments[shard]
        fields = {}
        for name, fld in seg.fields.items():
            nt = len(fld.doc_ids) // TILE + 2
            fstats = stats.get(name)
            b_lo, b_hi = self._field_tile_bounds(shard, name)
            fields[name] = _PlanField(
                tile_doc_lo=b_lo,
                tile_doc_hi=b_hi,
                name=name,
                terms=fld.terms,
                df=fld.df,
                offsets=fld.offsets,
                doc_count=fld.doc_count,
                sum_total_tf=fld.sum_total_tf,
                has_norms=fld.has_norms,
                num_tiles_=max(nt, 0),
                tn_avgdl=self._tn_avgdl(shard, name, fstats),
                tn_k1=self.params.k1,
                tn_b=self.params.b,
                pos_offsets=fld.pos_offsets,
                pos_num_tiles_=(
                    len(fld.positions) // TILE + 2
                    if fld.positions is not None
                    else 0
                ),
            )
        return Compiler(
            fields=fields,
            doc_values={name: None for name in seg.doc_values},
            mappings=self.mappings,
            params=self.params,
            stats=stats,
            nt_floor=nt_floor,
            id_index=lambda s=shard: self._id_index(s),
        )

    def compile(self, query: Query, nt_floor: int = 1) -> CompiledQuery:
        """Compile per shard into one spec; arrays stacked [S, ...]."""
        first = [
            self.shard_compiler(i, nt_floor).compile(query)
            for i in range(len(self.segments))
        ]
        if len({c.spec for c in first}) != 1:
            # Per-node-position equalization: each clause's bucket rises
            # only to its own max across shards (padding, no recompile).
            try:
                first = equalize_compiled(first)
            except SpecUnifyError:
                nt_max = max(_max_nt(c.spec) for c in first)
                first = [
                    self.shard_compiler(i, nt_max).compile(query)
                    for i in range(len(self.segments))
                ]
            if len({c.spec for c in first}) != 1:
                raise AssertionError(
                    "sharded compile produced divergent specs even with a "
                    "common worklist floor"
                )
        return CompiledQuery(
            spec=first[0].spec, arrays=_stack([c.arrays for c in first])
        )

    def compile_batch(self, queries: list[Query]) -> CompiledQuery:
        """Compile a batch of same-shape queries; arrays [Q, S, ...].
        Shape buckets equalize by padding; the batch must lower to one
        operator tree."""
        compiled = [self.compile(q) for q in queries]
        specs = {c.spec for c in compiled}
        if len(specs) != 1:
            try:
                compiled = equalize_compiled(compiled)
            except SpecUnifyError:
                pass
            specs = {c.spec for c in compiled}
        if len(specs) != 1:
            raise ValueError(
                "batched queries must share one compiled operator tree; got "
                f"{len(specs)} distinct specs after bucket equalization"
            )
        return CompiledQuery(
            spec=compiled[0].spec, arrays=_stack([c.arrays for c in compiled])
        )

    def compile_batch_buckets(
        self, queries: list[Query]
    ) -> list[tuple[CompiledQuery, list[int]]]:
        """Adaptive worklist bucketing for a query batch: queries group
        into pow-2 sub-buckets, each padded only to its own bucket, one
        launch per bucket; a smaller group joins a larger bucket only when
        its padding costs less than the launch it saves
        (exec/cost.coalesce_wins). Returns [(batched CompiledQuery, query
        positions)] covering all queries."""
        from ..exec.batcher import plan_spec_buckets

        compiled = [self.compile(q) for q in queries]
        by_spec: dict[tuple, list[int]] = {}
        for pos, c in enumerate(compiled):
            by_spec.setdefault(c.spec, []).append(pos)
        buckets = plan_spec_buckets(
            list(by_spec.items()), n_shards=self.n_shards
        )
        out: list[tuple[CompiledQuery, list[int]]] = []
        for bucket_specs in buckets:
            positions = [p for s in bucket_specs for p in by_spec[s]]
            target = unify_specs(list(bucket_specs))
            arrays = _stack([
                pad_arrays_to_spec(compiled[p].spec, target, compiled[p].arrays)
                for p in positions
            ])
            out.append((CompiledQuery(spec=target, arrays=arrays), positions))
        return out

    def search_batch(self, queries: list[Query], k: int, batch_axis: str):
        """Batched sharded search over a 2D (batch x shard) mesh: (scores
        f32[Q, k'], global ids i32[Q, k'], totals i32[Q]) on the lead
        device."""
        compiled = self.compile_batch(queries)
        return sharded_execute_batch(
            self.mesh, self.axis, batch_axis, self, compiled.arrays,
            compiled.spec, k, self.docs_per_shard,
        )

    def locate(self, global_doc: int) -> tuple[int, int]:
        """global doc id -> (shard, local doc id) for the fetch phase."""
        return divmod(int(global_doc), self.docs_per_shard)

    def _shard_plan(self, arrays_stacked, s: int):
        """Shard s's row of a stacked numpy plan, on shard s's device."""
        return bm25_device.plan_to_torch(
            None, _map(lambda x: np.asarray(x)[s], arrays_stacked),
            self.trees[s]["live"].device,
        )

    def _apply_filter_cache(
        self, query: Query, compiled: CompiledQuery, record: bool = True,
        entries: list | None = None,
    ):
        """Substitute per-shard filter-cache planes for the plan's
        cacheable top-level filter clauses. Each body reads its own
        shard's row, bit-identical to evaluating the clause there.
        `record=False` records no sighting (the coordinator counted the
        request). Returns (compiled', masks)."""
        from ..index.filter_cache import apply_cached_masks, record_filter_usage

        cache = self.filter_cache
        if entries is None:
            entries = record_filter_usage(cache, query, record=record)
        if not entries:
            return compiled, {}

        def build(child_spec, child_arrays, _norm):
            plane = ShardPlanes(
                bm25_device.compute_filter_mask(
                    self.trees[s], child_spec,
                    self._shard_plan(child_arrays, s),
                ).clone()
                for s in range(self.n_shards)
            )
            return plane, plane.nbytes

        scope = (
            self.cache_scope
            if self.cache_scope is not None
            else ("sharded", self._cache_uid)
        )
        compiled, masks, _reused = apply_cached_masks(
            cache, (scope, int(self.cache_generation), 0), query, compiled,
            build,
            const_fill=lambda: {
                "boost": np.zeros(self.n_shards, dtype=np.float32)
            },
            entries=entries,
        )
        return compiled, masks

    def search(self, query: Query, k: int = 10):
        """One-call sharded search: (scores f32[k'], global ids, total) as
        numpy."""
        compiled = self.compile(query)
        masks = {}
        if self.filter_cache is not None:
            compiled, masks = self._apply_filter_cache(query, compiled)
        scores, ids, total = sharded_execute(
            self.mesh, self.axis, trees_with_masks(self.trees, masks),
            compiled.arrays, compiled.spec, k, self.docs_per_shard,
        )
        scores, ids, total = _host(scores), _host(ids), int(total)
        n = min(k, total)
        return scores[:n], ids[:n], total


def _tree_to(tree, device: torch.device):
    """A device tree's tensors copied to `device` (host values kept)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


@dataclass
class _PlanField:
    """Host-only planning stand-in for DeviceField (term dict + spans)."""

    name: str
    terms: dict
    df: Any
    offsets: Any
    doc_count: int
    sum_total_tf: int
    has_norms: bool
    num_tiles_: int
    tn_avgdl: float = -1.0
    tn_k1: float = 1.2
    tn_b: float = 0.75
    pos_offsets: Any = None  # int64[P+1] host copy (phrase planning)
    pos_num_tiles_: int = 0
    # Per-tile doc-id extrema (tiles.tile_doc_bounds) for plan-time
    # conjunction range pruning; None disables it.
    tile_doc_lo: Any = None
    tile_doc_hi: Any = None

    @property
    def avgdl(self) -> float:
        if self.doc_count == 0:
            return 1.0
        return self.sum_total_tf / self.doc_count

    @property
    def pad_tile(self) -> int:
        return self.num_tiles_ - 1

    @property
    def pos_pad_tile(self) -> int:
        return self.pos_num_tiles_ - 1

    @property
    def num_terms(self) -> int:
        return len(self.df)

    def term_span(self, term: str) -> tuple[int, int]:
        tid = self.terms.get(term)
        if tid is None:
            return (0, 0)
        return int(self.offsets[tid]), int(self.offsets[tid + 1])

    def term_pos_span(self, term: str) -> tuple[int, int]:
        tid = self.terms.get(term)
        if tid is None or self.pos_offsets is None:
            return (0, 0)
        return (
            int(self.pos_offsets[self.offsets[tid]]),
            int(self.pos_offsets[self.offsets[tid + 1]]),
        )

    def term_df(self, term: str) -> int:
        tid = self.terms.get(term)
        if tid is None:
            return 0
        return int(self.df[tid])


def _max_nt(spec: tuple) -> int:
    """Largest worklist bucket anywhere in a compiled spec."""
    kind = spec[0]
    if kind in ("terms", "terms_const", "terms_gather", "phrase",
                "span_near", "span_not"):
        return spec[2]
    if kind == "doc_set":
        return spec[1]
    if kind in ("const", "script"):
        return _max_nt(spec[1])
    if kind == "nested":
        return _max_nt(spec[2])
    if kind == "boosting":
        return max(_max_nt(spec[1]), _max_nt(spec[2]))
    if kind == "terms_set":
        return max(
            _max_nt(spec[1]),
            max((_max_nt(c) for c in spec[2]), default=1),
        )
    if kind == "function_score":
        out = _max_nt(spec[1])
        for fil in spec[3]:
            if fil is not None:
                out = max(out, _max_nt(fil))
        return out
    if kind == "dismax":
        return max((_max_nt(c) for c in spec[1]), default=1)
    if kind == "bool":
        out = 1
        for group in spec[1:5]:
            for child in group:
                out = max(out, _max_nt(child))
        return out
    return 1


# ---------------------------------------------------------------------------
# The three bodies (kernel-table row 23)
# ---------------------------------------------------------------------------


def _upload(node, device: torch.device):
    """A numpy plan tree as device tensors (no worklist groups)."""
    if isinstance(node, dict):
        return {k: _upload(v, device) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_upload(v, device) for v in node)
    return bm25_device._to_tensor(node, device)


def _shard_rows(host, dev_tree, s: int):
    """Shard s's [Q, ...] rows of a shard-major plan: the device leaves'
    row views, each worklist's K1 groups from the host rows."""
    if isinstance(host, dict):
        out = {k: _shard_rows(host[k], dev_tree[k], s) for k in host}
        if {"tile_ids", "starts", "ends"} <= host.keys():
            out["_groups"] = bm25_device._plan_groups(
                np.asarray(host["tile_ids"])[s], np.asarray(host["starts"])[s],
                np.asarray(host["ends"])[s],
            )
        return out
    if isinstance(host, (tuple, list)):
        return tuple(_shard_rows(h, d, s) for h, d in zip(host, dev_tree))
    return dev_tree[s]


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_map(fn, v) for v in node)
    return fn(node)


def shard_plans(arrays_shard_major, devices: list[torch.device]) -> list:
    """Per-shard device plans of a plan whose numpy leaves are
    shard-major [S, Q, ...]: the stacked arrays upload once to each
    distinct device, and shard s reads its [Q, ...] rows from there."""
    uploaded: dict = {}
    plans = []
    for s, dev in enumerate(devices):
        if dev not in uploaded:
            uploaded[dev] = _upload(arrays_shard_major, dev)
        plans.append(_shard_rows(arrays_shard_major, uploaded[dev], s))
    return plans


def _merge_topk(flat_key: torch.Tensor, k: int, ids=None):
    """The top min(k, S * kk) of each row of the gathered [Q, S * kk]
    plane by (key desc, flat index asc), as lax.top_k merges the
    all-gathered planes: K3's merge mode for rows of up to
    kernels.MERGE_MAX_M keys, K3's row mode (an all-true mask) for longer
    ones (S * kk reaches 80,000 at k = 10,000). Returns (keys, flat idx
    int64, the ids i32[Q, S * kk] at those indices or None)."""
    m = min(k, flat_key.shape[1])
    key = flat_key.contiguous()
    if 0 < key.shape[1] <= kernels.MERGE_MAX_M:
        return kernels.masked_topk_merge(
            key, m, None if ids is None else ids.contiguous())
    top, idx, _count = kernels.masked_topk_batch(
        key, torch.ones_like(key, dtype=torch.bool), m
    )
    idx = idx.to(torch.int64)
    return top, idx, None if ids is None else torch.gather(ids, 1, idx)


def sharded_execute(
    mesh: Mesh, axis: str, trees: list, arrays_stacked, spec, k: int,
    docs_per_shard: int,
):
    """Per-shard score + top-k, gather, K3 merge, psum of totals.

    `trees` are the shards' device trees, `arrays_stacked` the compiled
    plan's numpy leaves [S, ...]. Returns (scores f32[k'], global ids
    i32[k'], total i32[]) on the lead device, k' = min(k, S * kk)."""
    devices = [t["live"].device for t in trees]
    plans = shard_plans(_map(lambda x: np.asarray(x)[:, None], arrays_stacked),
                        devices)

    def body(s):
        tree = trees[s]
        kk = min(k, tree["live"].shape[0])
        local_s, local_i, count = bm25_device.execute_batch_auto(
            tree, spec, plans[s], kk, q=1
        )
        return local_s, local_i.to(torch.int32) + s * docs_per_shard, count

    outs = mesh_ops.run_bodies(devices, body)
    lead = mesh.lead
    all_s = mesh_ops.all_gather([o[0] for o in outs], lead)  # [S, 1, kk]
    all_i = mesh_ops.all_gather([o[1] for o in outs], lead)
    flat_s = all_s.transpose(0, 1).reshape(1, -1)
    flat_i = all_i.transpose(0, 1).reshape(1, -1)
    # Merge to min(k, S * kk), not kk: when k exceeds docs_per_shard the
    # union across shards can still fill k hits.
    top_s, _idx, top_i = _merge_topk(flat_s, k, flat_i)
    total = mesh_ops.psum([o[2] for o in outs], lead)
    return top_s[0], top_i[0], total[0]


def sharded_execute_batch(
    mesh: Mesh,
    shard_axis: str,
    batch_axis: str,
    index: ShardedIndex,
    arrays_batched,  # leaves [Q, S, ...]
    spec,
    k: int,
    docs_per_shard: int,
):
    """Query-batch x shard search over a 2D mesh: the index replicated
    over `batch_axis`, sharded over `shard_axis`; the Q queries split into
    equal sub-batches along `batch_axis`, sub-batch b scoring shard s on
    device [b, s]. The gathered planes merge on the lead device, one K3
    launch over all Q rows. Returns (scores f32[Q, k'], global ids
    i32[Q, k'], totals i32[Q])."""
    n_batch = mesh.shape[batch_axis]
    first = next(iter(_leaves(arrays_batched)))
    q_all = first.shape[0]
    if q_all % n_batch:
        raise ValueError(
            f"{q_all} queries do not split over {n_batch} replica rows"
        )
    qb = q_all // n_batch
    lead = mesh.lead
    rows_s, rows_i, rows_c = [], [], []
    for b in range(n_batch):
        devices = mesh.axis_devices(shard_axis, **{batch_axis: b})
        sub = _map(lambda x: np.swapaxes(np.asarray(x)[b * qb:(b + 1) * qb],
                                         0, 1), arrays_batched)
        plans = shard_plans(sub, devices)
        trees = [index.tree_on(s, dev) for s, dev in enumerate(devices)]

        def body(s, trees=trees, plans=plans):
            tree = trees[s]
            kk = min(k, tree["live"].shape[0])
            local_s, local_i, counts = bm25_device.execute_batch_auto(
                tree, spec, plans[s], kk, q=qb
            )
            return (local_s, local_i.to(torch.int32) + s * docs_per_shard,
                    counts)

        outs = mesh_ops.run_bodies(devices, body)
        rows_s.append(mesh_ops.all_gather([o[0] for o in outs], lead))
        rows_i.append(mesh_ops.all_gather([o[1] for o in outs], lead))
        rows_c.append(mesh_ops.psum([o[2] for o in outs], lead))
    all_s = torch.cat(rows_s, dim=1)  # [S, Q, kk]
    all_i = torch.cat(rows_i, dim=1)
    flat_s = all_s.transpose(0, 1).reshape(q_all, -1)  # [Q, S * kk]
    flat_i = all_i.transpose(0, 1).reshape(q_all, -1)
    top_s, _idx, top_i = _merge_topk(flat_s, k, flat_i)
    return top_s, top_i, torch.cat(rows_c)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _leaves(v)
    else:
        yield np.asarray(node)


def sharded_execute_request(
    mesh: Mesh,
    axis: str,
    trees: list,
    arrays_stacked,
    spec,
    k: int,
    docs_per_shard: int,
    sort_field: str | None = None,
    sort_desc: bool = False,
    missing_first: bool = False,
    has_after: bool = False,
    after_key=0.0,
    after_doc=0,
    aggs_spec: tuple | None = None,
    aggs_arrays_stacked=(),
):
    """One request's whole query phase over the mesh: scoring, sorted or
    score-ordered top-k with the search_after cursor applied before each
    shard's top-k, psum'd totals, and the aggregation planes.

    - Field sorts rank by the transformed ascending (sort key, shard, doc)
      composite: each shard's K3k (keyed mode) builds the key
      (kernels.sort_key: desc negated, missing pinned first / last); the
      merge is K3 over the negated gathered keys, whose stable lower
      flat index first order is the (shard, doc) tiebreak — the host
      loop's hit order.
    - search_after masks before each shard's top-k (K3k's cursor).
      `after_doc` is mesh-global (shard * docs_per_shard + local);
      key-only public cursors pass n_shards * docs_per_shard, so key
      ties never qualify.
    - Aggregations evaluate off each shard's eligibility mask as the
      single-segment program does (ops/aggs_device._eval_agg, K10);
      integer count planes psum, per-shard planes come back stacked
      [S, ...] for the host fold (aggs_device.mesh_combine).

    Returns (merge keys f32[k'] ascending, sort values f32[k'] (raw
    column values, or scores), global ids i32[k'], total i32[], n_after
    i32[], agg results with a leading shard axis), on the lead device."""
    from ..ops.aggs_device import _eval_agg, mesh_combine

    devices = [t["live"].device for t in trees]
    plans = shard_plans(_map(lambda x: np.asarray(x)[:, None], arrays_stacked),
                        devices)
    aggs_spec = tuple(aggs_spec) if aggs_spec is not None else None

    def body(s):
        tree = trees[s]
        dev = devices[s]
        n = tree["live"].shape[0]
        scores, eligible = bm25_device._dense_rows(tree, spec, plans[s], 1)
        count = eligible.sum(dim=1, dtype=torch.int32)  # [1]
        hits = None
        if k > 0:
            kk = min(k, n)
            cursor = ()
            if has_after:
                cursor = (
                    torch.tensor([np.float32(after_key)],
                                 dtype=torch.float32).to(dev),
                    torch.tensor([int(after_doc) - s * docs_per_shard],
                                 dtype=torch.int32).to(dev),
                )
            if sort_field is not None:
                col = tree["doc_values"][sort_field]
                vals, ids, _t, n_after = kernels.keyed_topk_batch(
                    col, eligible, kk, kernels.KEYED_FIELD, sort_desc,
                    missing_first, *cursor,
                )
                # The masked ascending key at each rank: the column's key
                # for the kept ranks, +inf past them (top_k(-masked)).
                rank = torch.arange(vals.shape[1], device=dev)
                key = kernels.sort_key(col, sort_desc, missing_first)[
                    ids.long()]
                local_key = torch.where(rank < n_after[:, None], key,
                                        float("inf"))
                local_val = vals
            else:
                if has_after:
                    vals, ids, _t, n_after = kernels.keyed_topk_batch(
                        scores, eligible, kk, kernels.KEYED_SCORE_DESC,
                        False, False, *cursor,
                    )
                else:
                    masked = torch.where(eligible, scores, NEG_INF)
                    vals, ids, n_after = kernels.masked_topk_batch(
                        masked, eligible, kk)
                local_key = -vals  # score desc == key asc
                local_val = vals
            gids = ids.to(torch.int32) + s * docs_per_shard
            hits = (local_key, local_val, gids, n_after)
        aggs = None
        if aggs_spec is not None:
            agg_arrays = _map(lambda x: np.asarray(x)[s], aggs_arrays_stacked)
            aggs = tuple(
                _eval_agg(sp, a, tree, eligible[0], scores[0], n)
                for sp, a in zip(aggs_spec, agg_arrays)
            )
        return count, hits, aggs

    outs = mesh_ops.run_bodies(devices, body)
    lead = mesh.lead
    total = mesh_ops.psum([o[0] for o in outs], lead)[0]
    if k > 0:
        all_key = mesh_ops.all_gather([o[1][0] for o in outs], lead).reshape(1, -1)
        all_val = mesh_ops.all_gather([o[1][1] for o in outs], lead).reshape(1, -1)
        all_gid = mesh_ops.all_gather([o[1][2] for o in outs], lead).reshape(1, -1)
        # Stable top-k over -key: equal keys favor the lower flat index,
        # (shard, per-shard rank), the host merge's tiebreak.
        _neg, idxm, gid = _merge_topk(-all_key, k, all_gid)
        out_key = torch.gather(all_key, 1, idxm)[0]
        out_val = torch.gather(all_val, 1, idxm)[0]
        out_gid = gid[0]
        n_after_total = mesh_ops.psum([o[1][3] for o in outs], lead)[0]
    else:  # agg-only / count-only request: no hits merge at all
        out_key = torch.zeros(0, dtype=torch.float32, device=lead)
        out_val = torch.zeros(0, dtype=torch.float32, device=lead)
        out_gid = torch.zeros(0, dtype=torch.int32, device=lead)
        n_after_total = torch.zeros((), dtype=torch.int32, device=lead)
    agg_out = ()
    if aggs_spec is not None:
        agg_out = mesh_combine(aggs_spec, [o[2] for o in outs], lead)
    return out_key, out_val, out_gid, total, n_after_total, agg_out
