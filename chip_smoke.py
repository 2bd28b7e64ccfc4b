#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elasticsearch_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card and the repo

Phases, each of which must pass (any failure exits non-zero and prints no
result line). Launch counters are zeroed just before each main-path phase
and read just after it.

  1. build       the four CUDA kernels, each with its row and stacked-shard
                 modes (csrc/*.cu -> one sm_90a library)
  2. corpus      the MS MARCO-sized Zipf corpus (8,841,823 passages, the
                 repo's own generator) with its body field's ~296 M token
                 positions (the generator's token stream re-drawn from its
                 seed), installed in a one-shard index; beside it, on one
                 pool of threads, the build of phase 1 and every later
                 phase's host-side draws (cfg3's shards, qa, the
                 stacked-tail streams, columns and qa shards, the packed
                 tenants), all joined before phase 3
  3. main        the REST server on loopback serves 64 sequential `_search`
                 requests: `match` of 4 terms (BASELINE config 2's shape),
                 bool(should) and bool(must match + filter term); one
                 untimed warm-up request per shape first; plus a
                 bulk-indexed small index
  4. check       match hits against the port's numpy oracle (ops/bm25),
                 bool hits against the plain PyTorch path on the same card
                 tensors: 0 mismatches in ids, order, fp32 bits and totals
  5. concurrent  each of the same 64 requests four times over (the copies
                 shuffled), from 16 client threads: the micro-batcher
                 coalesces them; every answer equals its sequential answer
  6. kernels     K1-K4 at Q = 1 and K2b/K4b (the batched sparse fold and
                 span search) at the concurrent phase's mean batch, K4's
                 fold mode at a filter-led conjunction's shape (Q = 1 and
                 the mean batch), each against its plain version on the
                 card (exact), timed beside its byte bound, the plain
                 version and one library call; the K4 rows also by the
                 profiler's device time (`device_ms`) and by events
                 around calls queued behind a sleep kernel (`queued_ms`),
                 as are K3's (and K3 again with fewer eligible entries
                 than k and -NaN keys, and at the rescore window's k =
                 1,000) and K1's matched-only mode on the head-term
                 filter; every phase logs K3's calls by design (the
                 select, the short-row sort, the large-k select)
  7. sharded     BASELINE config 3's deployment: 8 shards of the Zipf
                 generator (seed 100 + shard, 1,105,228 / 1,105,227 docs,
                 8,841,823 in all), one segment each, in an 8-shard index
  8. sharded sequential  32 bool(must 2-term match + filter head term) and
                 32 `match` of 4 terms over HTTP one at a time; match hits
                 against the numpy oracle per shard with the coordinator's
                 global statistics merged by (score desc, shard, rank);
                 every answer against the plain path on the card
  9. sharded concurrent  256 requests of that mix from 16 client threads;
                 every answer equals its sequential answer; QPS, p50/p99,
                 the batcher's stats and device ms per batched launch
 10. routed      500 documents `_bulk`-indexed into an 8-shard index, half
                 on auto ids; `_shards` counts and hits against the oracle
                 over all documents; a search_after walk sorted on a
                 numeric field over the 8 shards against the oracle
 11. batched kernels  K1b/K3b at the sharded concurrent phase's mean batch,
                 K3b also at k = 256 and k = 257 (both sides of the row
                 mode's switch: the threshold select, the large-k select)
 12. results     latencies, QPS, device times, peak device memory
 6b. blockmax    (on the one-shard corpus, before it is freed) the match
                 plans through execute_batch_blockmax and the must-led
                 bool(must + filter) plans through execute_batch_blockmax_conj,
                 per spec group at k = 10, each held to execute_batch_sparse
                 (ids, order, fp32 bits; totals a lower bound, equal when
                 "eq"); then those bodies with track_total_hits false, four
                 times over HTTP, on the node with its batcher set aside
                 and a fresh exec planner: every answer equals phase 3's
                 hits, and the planner decides both blockmax and
                 blockmax_conj
 6c. rescore     (one-shard corpus, columns f1/f2 = the first two draws of
                 default_rng(99), f3 = f1 missing at every tenth doc)
                 BASELINE config 4: phase 3's 32 `match` bodies with a
                 window of 1,000 rescored by the cfg4 script_score over
                 match_all, sequentially over HTTP (K1-K4, K6, K5's
                 gather), held bit for bit to a numpy two-phase oracle;
                 then execute_rescore (K5's fused mode) on the same plans,
                 held to the REST answers and the oracle
 6d. sorted      the same 32 queries sorted by f1 desc, f3 asc (missing
                 first), _score asc and (f3 desc, f2 asc) over HTTP (K3k);
                 search_after walks of five pages of 10 for f1 desc, f3
                 asc, _score desc and _score asc on 8 of them, each page
                 and each from/size page held to a numpy oracle (the match
                 mask, then a stable order by key and doc id; a key-only
                 cursor skips the docs that tie with it); then K3k, K5
                 (both modes) and K6 (cfg4's script and one script with
                 every grammar node) against their plain versions
 6e. aggs-full   (one-shard corpus, before it is freed) size: 0 bodies
                 over f1 / f2: a histogram of f1 (interval 0.001) with an
                 avg f2 sub-metric and 20 f1 ranges with a sum f2
                 sub-metric, each 10 times over HTTP, checked as phase 15
                 checks; then K10's histogram and range rows at 8,841,823
                 docs
 6f. phrase      (one-shard corpus, before it is freed) 84 positional bodies
                 over HTTP (default_rng(SEED + 8)): 32 match_phrase cut from
                 random docs, 8 over head terms, 4 with an absent term, 8
                 match_phrase_prefix, 8 span_near, 4 span_first, 4 span_not,
                 4 span_or, 4 intervals, 8 bool(must match_phrase + filter),
                 sequentially (one warm-up per shape): every answer against
                 the plain path (K11 / K12 / K3 plain), the first 3
                 match_phrase bodies of each shape against a numpy oracle
                 (slot keys intersected, counted per doc, the fp32 BM25
                 tail); then each body once, shuffled, from 16 clients,
                 each answer equal to its
                 sequential one; then K11 (phrase and span modes) and K12
                 (phrase, near, near-unordered, first, not) at Q = 1 and at
                 the concurrent phase's mean batch against their plain
                 versions
 6g. structured  (one-shard corpus, before it is freed; kernel-table row
                 16b) the corpus gains a Zipf `title` (2-12 tokens, seed
                 SEED + 9, with positions) and the columns loc (geo_point),
                 pop, pagerank (rank_feature) and req (default_rng(SEED +
                 9)): Rally `geonames`' location + population shape; a
                 nested index `qa` (Rally's `nested` track shape: 1,000,000
                 parents with a Zipf title, 0-8 nested answers each, ~4 M
                 nested docs, built vectorized); 112 bodies over HTTP
                 (default_rng(SEED + 9)): multi_match best_fields /
                 most_fields / phrase, dis_max, ids (100 each), boosting,
                 rank_feature (each function, and in bool.should),
                 bool(match + geo_distance filter), geo_bounding_box (two
                 across the antimeridian), terms_set (by field and by
                 script), function_score (every function kind and
                 score_mode, four boost modes, a min_score, a script
                 function) and nested on qa (all five score modes, some in
                 a bool with a parent filter); every answer against the
                 plain path (K13 / K14 plain included), up to 2 a shape
                 (every kind) against a numpy oracle written here (ids and totals
                 exact, scores exact or within 4 ulps where a logarithm,
                 exp or pow is in them); 32 of them x 4 from 16 clients,
                 each equal to its sequential answer; then K13 (each join
                 mode, mark) and K14 (each node kind) at Q = 1 against
                 their plain versions and bounds (K13 beside
                 torch.segment_reduce), and at Q > 1 bit for bit
 6h. sequential  (kernel-table row 17; K15 chain_perturb) the strictly
                 sequential chains, each where its corpus is alive:
                 execute_sequential_sparse over phase 3's 32 matches (cfg2,
                 after phase 6), execute_rescore_sequential over phase 6c's
                 32 rescores (window 1,000), execute_shards_sequential over
                 phase 8's 32 conjunctions on phase 13's stacked shards and
                 execute_sequential over cfg5's 16 script_score bodies (in
                 phase knn); each chain bit for bit against the same chain
                 on the plain path, each row's hits against the per-query
                 kernel (ids and totals exact, fp32 bits exact but where a
                 boost is -0.0, -inf past the hits); wall / Q after a
                 synchronize, CUDA-event device ms / Q, host enqueue ms / Q,
                 the batched executor's device ms / Q on the same plans and
                 the host syncs a step (set_sync_debug_mode("warn")); K15's
                 row at Q = 32 beside torch.add
 13. stacked     config 3 as the JAX bench serves it on one device: the 8
                 shards packed to equal shapes (pad_docs_to, field_min_tiles)
                 and stacked, each query compiled per shard with that shard's
                 statistics and equalized, bucketed by plan_spec_buckets;
                 execute_shards_batch (K1s-K4s) over phase 8's 64 queries
                 and 16 dense bool(should) held to the numpy oracle per
                 shard merged by (score desc, shard, rank), and
                 execute_shards_blockmax_conj to execute_shards_batch;
                 then the stacked filter cache: each conjunction's filter
                 as an [S, N] plane (compute_filter_mask_stacked, K1s's
                 matched-only mode) substituted into its plan, through
                 execute_shards and execute_shards_blockmax_conj, held to
                 the unmasked answers; then `stacked lead`: 8 filter-led
                 conjunctions of cfg3's shape (a filter rarer than the
                 must's two terms in every shard) through
                 execute_shards_batch (K4s's fold mode) against the oracle;
                 K1s-K4s, K4s's fold mode and K1s matched-only against
                 their plain versions; CUDA-event times
 13b. stacked-tail (kernel-table rows 14-15 and 16b over stacked shards;
                 K11s-K14s) cfg3's 8 shards gain their body positions
                 (TokenStream(n, 100 + s)) and phase 6g's title and columns
                 (default_rng(200 + s)); `qa` as 8 shards of 125,000 parents
                 (`reduced` from phase 6g's 1,000,000: one answers-per-parent
                 draw and one answers segment for every shard, each shard
                 laying the draw over its parents in its own permutation, so
                 the nested blocks have the equal shapes stacking needs);
                 both packed with common shapes (field_pos_min_tiles among
                 them) and stacked; 2-8 bodies of each of phase 6f's phrase
                 and span shapes and phase 6g's structured kinds, compiled
                 per shard, equalized, through execute_shards_batch: every
                 launch bit for bit against the plain path, every body with
                 a 6f / 6g oracle against it per shard merged by (score
                 desc, shard, rank); then K11s / K12s (each mode), K13s
                 (each join mode, mark) and K14s (each kind) rows at Q x 8

 15. aggs        the reference bench's cfg7 deployment (bench.py:346-432):
                 8 shards x 125,000 Zipf docs (vocabulary 20,000, seed
                 800 + s), price long in [0, 10,000) with ~10 % missing
                 (default_rng(88)), tag keyword x / y / z (default_rng(99),
                 as _cfg7_end_to_end draws it), and the same documents as
                 one 1,000,000-doc shard; cfg7's four REST bodies
                 (bench.py:604-615), a histogram at interval 500 with an
                 avg sub-metric, 20 ranges with a sum sub-metric, filters
                 over two term queries, missing on price and global with
                 stats, each 10 times sequentially over HTTP on each index:
                 every first answer against plain_kernels() (the whole JSON
                 but `took`) and against a numpy oracle over the raw
                 columns (counts exact, metrics in f64 as the reference
                 folds them, bucket sums in K10's stated order), every
                 repeat against the first; per-body p50 / p99, QPS, device
                 ms per request; K10's terms and doc_count rows
 15b. aggs-ext  (kernel-table row 22's rest) the same node and documents
                 with a `ts` date column (epoch ms drawn evenly over
                 2023-01-01 .. 2025-12-31 UTC, 5 docs a shard within 60 s
                 of each month edge, ~2 % missing) and a `flag` boolean
                 (default_rng(SEED + 11)): 25 bodies (significant_terms
                 with each heuristic, with stats and top_hits subs and
                 under a filter; rare_terms; cardinality on keyword,
                 numeric, boolean and date fields; top_hits at the top
                 level and under terms, a calendar date_histogram, range
                 and filter; matrix_stats; percentiles, percentile_ranks,
                 extended_stats, median_absolute_deviation;
                 date_histogram at 1d, 12h, month, quarter and year;
                 numeric and boolean terms; a date range query sorted on
                 ts; a match sorted on ts) 3 times each sequentially over
                 HTTP on each index, and a composite (terms + week
                 date_histogram + histogram sources, avg sub) paged to
                 its end with `after`: every first answer against
                 plain_kernels() and against ExtOracle (numpy over the
                 host columns: keys, counts, bg counts, significance
                 scores, hit ids and order and the f64 host metrics
                 exact, K10's bucket sums within rtol 1e-5), every repeat
                 against the first; p50 / p99 per body family, device ms
                 (CUDA events around execute_aggs), host ms and readback
                 ms per request; then K10's sig_terms counts, its range
                 mode over the 37 month edges (R > 32) and its 1d scatter
                 rows
 16. nan-pages   the C1 / C2 bodies (ROADMAP queue C's repro index, 1 and
                 3 shards; script_score pages sorted by score, by _score
                 asc and past an ascending cursor on a NaN, with and
                 without a boost) on the card against a CPU node: ids,
                 totals and every NaN score's bits equal

 17. packed      (kernel-table row 13) the reference bench's config 6 at the
                 plane budget, `reduced` to 500 one-shard tenants (sizes
                 [8, 64, 256] + 497 log-uniform 1k-10k draws of default_rng(61); Zipf
                 titles, vocabulary 4,000, seed 700 + t; one flooded with
                 a term rare elsewhere) plus BASELINE config 1's scifact
                 shape (5,000 docs) indexed over HTTP `_bulk`; two bodies a
                 tenant (60 % match of 3 terms, 25 % bool(must + filter),
                 15 % bool(should, msm 1)) and 12 leak bodies: a warm-up
                 touching every tenant from 32 clients (plane rebuilds), 64
                 bodies one at a time, every body from 32 clients, the
                 same on a Node(exec_packed=False); every answer against
                 its solo answer on the card, the numpy oracle and the
                 unpacked node, no foreign doc in any page; 100 docs
                 `_bulk`-indexed into one tenant: the plane rebuilds and
                 its answers track the new segment; then K2b's bounds mode
                 and K3b's window mode (also at k = 257) on the phase's
                 widest launch of each against their plain versions
 18. mesh        (kernel-table row 23 and row 22's mesh half) the shards of
                 one index as one mesh request (parallel/sharded.py,
                 parallel/mesh_serving.py) over [card] * 8 on one card (8
                 distinct cards where the machine has them; the layout is
                 printed): on cfg3's node (before it is freed),
                 IndexService.mesh_snapshot's ShardedIndex.search and
                 search_batch on a (1 x 8) mesh over phase 8's 64 bodies,
                 search_batch on a (2 replica x 4 shard) mesh over shard
                 segments 0-3 (each held to the same index's search), then
                 the 64 bodies over HTTP with a MeshView installed, every
                 answer held to phase 8's host-loop answer (the whole JSON
                 but `took`), one K3 merge-mode launch a request; the
                 merge's row ([1, S * kk] gathered keys and ids) beside
                 torch.topk; one body of size 600 (S * kk = 4,800 keys,
                 past MERGE_MAX_M) whose merge takes the long route, K3's
                 row mode, held to the host loop, and that route's row
                 beside its plain version; on cfg7's node (phase 15's),
                 the eligible aggregation bodies, four sorted searches
                 walked with search_after and four size-0 counts through
                 the view against the host loop, and one request of each
                 ineligible shape, which must fall back under its reason;
                 then a 2-shard index of 2 x 100,000 docs drawn as phase
                 6f draws its corpus, five match_phrase bodies through the
                 mesh and the host loop (and over cuda:0 + cuda:1 when the
                 machine has two cards); p50 / p99 against the host loop,
                 device ms per request (CUDA events around the bodies and
                 the merge), launches per request, snapshot seconds and
                 bytes, peak device memory, the view's counters; no
                 execute failure and no fallback of an eligible body
 18b. mesh cards (a machine with two or more cards) an index of one shard
                 a card (up to 8) on a default Node, which spreads it over
                 the cards: REST bodies, a sorted walk, counts and
                 aggregations through the view against the host loop,
                 mesh_snapshot's search, and search_batch on a (2 replica
                 x n/2 shard) grid of distinct cards

 19. filter-cache (kernel-table row 8b; the node's FilterCache, on by
                 default) on cfg3's node before it is freed and on cfg7's
                 documents (8 shards and one): 8 distinct filters (term,
                 terms, exists, range on cfg7, bools of them; in filter
                 and in must_not, cold: no earlier phase used them) each
                 under 4 two-term must matches, sent sequentially twice
                 (first sightings, then admission), then x 4 shuffled
                 from 16 clients, then a warm sequential pass, and through
                 a MeshView on [card] * 8 (cfg3's: phase 18's view); every
                 answer equal to a Node(filter_cache=False) over the same
                 documents (cfg3: the same node with its cache detached),
                 whole JSON but `took`; K1 launches per request cold and
                 warm, device ms and p50 cached against uncached, the
                 cache's stats; then on the one-shard index a budget of 3
                 planes (evictions, residency within it, allocated device
                 memory back after the clear) and POST /{index}/_cache/
                 clear over REST followed by a miss that is still right.
                 K1's matched-only mode for one segment (cfg2's head-term
                 filter, the filter cache's plane build) is a kernel row
                 of phase 6, K1s's (compute_filter_mask_stacked) of 13.

    python3 chip_smoke.py --cards    # phases 1, 18's phrase part and 18b
                                     # alone; needs two or more cards

The last lines are the card (nvidia-smi name, power limit), one JSON
object with the kernel table, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

N_DOCS = 8_841_823  # MS MARCO passage ranking collection size
N_SHARDS = 8
LONG_MERGE_SIZE = 600  # a mesh body whose S * kk = 4,800 keys pass MERGE_MAX_M
SEED = 13
TOP_K = 10
N_MATCH = 32
N_SHOULD = 16
N_MUST_FILTER = 16
N_CFG3 = 32  # sharded bool(must 2-term match + filter term) requests
N_CFG3_MATCH = 32  # sharded match requests of 4 terms
N_STACKED_SHOULD = 16  # dense bool(should) on the stacked shards (K1s)
N_STACKED_LEAD = 8  # filter-led stacked conjunctions (K4s's fold mode)
N_CLIENTS = 16
N_CONCURRENT = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (same)
DEVICE = "cuda"
REPO = Path(__file__).resolve().parent
KERNELS = ("terms_scatter", "sparse_fold", "masked_topk", "span_locate")
AGG_KERNELS = ("bucket_fold", "range_fold")  # K10's two modes
SOURCES = {name: f"elasticsearch_tpu_torch/csrc/{name}.cu" for name in KERNELS}
SOURCES["span_fold"] = SOURCES["span_locate"]  # K4's fold mode
SOURCES["masked_topk_merge"] = SOURCES["masked_topk"]  # K3's merge mode
# BASELINE config 4 (bench.py:1273-1353): window, script and weights.
CFG4_WINDOW = 1000
CFG4_SCRIPT = ("params.w0 * _score + params.w1 * doc['f1'].value"
               " + params.w2 * doc['f2'].value")
CFG4_PARAMS = {"w0": 0.3, "w1": 4.0, "w2": 2.0}
# One script over every grammar node of painless-lite (K6's second row).
GRAMMAR_SCRIPT = (
    "doc['f3'].empty ? -1.5 : where(doc['f2'].value > 0.5, "
    "Math.log(doc['f1'].value) / 3, -doc['f2'].value % 0.7) + Math.sqrt(_score)"
    " * Math.pow(doc['f1'].value, params.p) + Math.min(doc['f3'].value, 0.5)"
    " - Math.max(_score, params.c) + Math.abs(doc['f2'].value - 0.5)"
    " + Math.exp(-doc['f1'].value) + Math.log10(_score + 1) + Math.floor(_score)"
    " - Math.ceil(doc['f2'].value) + sigmoid(doc['f2'].value) + saturation(_score, 2)"
    " + (doc['f1'].value >= 0.5) * 2 + _score ** 2 + Math.E * Math.PI / 7"
)
GRAMMAR_PARAMS = {"p": 1.7, "c": 4.0}
N_WALK = 8  # queries whose search_after walks the sorted phase checks
WALK_PAGES = 5


class SmokeFailure(Exception):
    pass


T_START = time.monotonic()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script began."""
    print(f"[{time.monotonic() - T_START:7.1f}] {msg}", flush=True)


# Host-side draws of later phases that phase 2 starts beside the
# one-shard corpus (draw_ahead) and each phase takes (drawn).
_DRAWN: dict = {}


def draw_ahead(pool, name: str, fn, *args) -> None:
    """Start a later phase's host-side draw on `pool` now."""
    _DRAWN[name] = pool.submit(fn, *args)


def drawn(name: str, fn, *args):
    """The draw draw_ahead started under `name`, or fn(*args) now where
    none was started (a phase run on its own)."""
    f = _DRAWN.pop(name, None)
    return fn(*args) if f is None else f.result()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_kernels():
    """Route bm25_device through the plain PyTorch versions of K1-K4 (K4's
    fold mode and K3's merge mode too), solo, batched and stacked, K11,
    K12 (and their stacked modes), K13, K14 and K15, and aggs_device
    through K10's (on whatever device the tensors are) — the reference
    runs of the check phases."""
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.ops import tail_kernel

    names = ([n + s for n in KERNELS for s in kern.MODES]
             + ["span_fold_batch", "span_fold_stacked", "masked_topk_merge"]
             + list(AGG_KERNELS)
             + list(PHRASE_SOURCES) + ["doc_join", "doc_mark"]
             + list(PACKED_SOURCES) + [n + "_stacked" for n in PHRASE_SOURCES]
             + ["chain_perturb"])
    saved = {n: getattr(kern, n) for n in names}
    real_tail = tail_kernel.tail_eval
    try:
        for n in names:
            setattr(kern, n, getattr(kern, n + "_plain"))
        tail_kernel.tail_eval = tail_kernel.tail_eval_plain
        yield
    finally:
        for n, fn in saved.items():
            setattr(kern, n, fn)
        tail_kernel.tail_eval = real_tail


@contextlib.contextmanager
def counted(phase: str, totals: dict):
    """Zero the launch counts, run a main-path phase, read them after."""
    from elasticsearch_tpu_torch.ops import kernels as kern

    import torch

    torch.cuda.synchronize()
    kern.reset_launches()
    yield
    torch.cuda.synchronize()
    counts = dict(kern.LAUNCHES)
    # K1's matched-only launches (a subset of terms_scatter*), under
    # `<name>_matched_only`: the matched-only kernel rows' launch counts.
    counts.update({name + "_matched_only": c for name, c in
                   kern.MATCHED_ONLY_LAUNCHES.items()})
    for name, c in counts.items():
        totals[name] = totals.get(name, 0) + c
    log(f"  launches in {phase}: {counts}")
    # K3's calls by design (kernels.topk_route), summed beside the
    # launches: `<name>:select`, `<name>:short` (the short-row sort) and
    # `<name>:large` (the large-k select).
    routes = {name: c for name, c in kern.TOPK_ROUTES.items() if c}
    for name, c in routes.items():
        totals[name] = totals.get(name, 0) + c
    log(f"  K3 routes in {phase}: {routes}")


def http(base: str, method: str, path: str, body=None, raw: str | None = None):
    data = raw.encode() if raw is not None else (
        None if body is None else json.dumps(body).encode()
    )
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def without_took(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "took"}


def serve(node):
    from elasticsearch_tpu_torch.rest.server import RestServer

    server = RestServer(node).serve("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def sequential(base: str, index: str, bodies):
    latencies, responses = [], []
    t_all = time.monotonic()
    for body in bodies:
        t0 = time.monotonic()
        responses.append(http(base, "POST", f"/{index}/_search", body))
        latencies.append((time.monotonic() - t0) * 1e3)
    return latencies, responses, time.monotonic() - t_all


def concurrent(base: str, index: str, bodies, n_clients: int):
    """Send `bodies` from n_clients threads; returns (latencies in body
    order, responses in body order, wall seconds)."""
    latencies = [0.0] * len(bodies)
    responses: list = [None] * len(bodies)
    errors: list = []
    barrier = threading.Barrier(n_clients)

    def client(c):
        barrier.wait()
        for i in range(c, len(bodies), n_clients):
            try:
                t0 = time.monotonic()
                responses[i] = http(base, "POST", f"/{index}/_search", bodies[i])
                latencies[i] = (time.monotonic() - t0) * 1e3
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise SmokeFailure(f"concurrent requests failed: {errors[:3]}")
    return latencies, responses, wall


def score_bits(scores):
    import numpy as np

    return np.asarray(scores, np.float32).view(np.int32)


def same_hits(out: dict, ids, scores, total: int) -> bool:
    import numpy as np

    hits = out["hits"]["hits"]
    return (
        [h["_id"] for h in hits] == list(ids)
        and np.array_equal(score_bits([h["_score"] for h in hits]),
                           score_bits(scores))
        and out["hits"]["total"]["value"] == min(total, 10_000)
    )


def shard_oracle(shards, terms, stats, k):
    """The numpy oracle per shard (with the coordinator's global
    statistics), merged by (score desc, shard, rank): (ids, scores,
    total) over every document of the index."""
    import numpy as np

    from elasticsearch_tpu_torch.ops import bm25

    merged, total = [], 0
    for s, seg in enumerate(shards):
        fld = seg.fields["body"]
        matched = np.zeros(seg.num_docs, dtype=bool)
        scores = bm25.score_terms_dense(
            fld, terms, seg.num_docs, matched=matched, stats=stats
        )
        top_s, top_i = bm25.top_k(scores, k, matched)
        total += int(matched.sum())
        for rank, (sc, d) in enumerate(zip(top_s, top_i)):
            merged.append((-float(sc), s, rank, seg.ids[int(d)], sc))
    merged.sort(key=lambda t: (t[0], t[1], t[2]))
    page = merged[:k]
    return [t[3] for t in page], [t[4] for t in page], total


class LaunchTimer:
    """CUDA events around every batched execution (bm25_device.
    execute_batch_auto) while installed: device ms per batched launch."""

    def __init__(self):
        from elasticsearch_tpu_torch.ops import bm25_device

        self.mod = bm25_device
        self.real = bm25_device.execute_batch_auto
        self.events: list = []
        self.lock = threading.Lock()

    def __enter__(self):
        import torch

        def timed(seg, spec, arrays, k, q=None):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = self.real(seg, spec, arrays, k, q=q)
            ev1.record()
            with self.lock:
                self.events.append((int(out[2].shape[0]), ev0, ev1))
            return out

        self.mod.execute_batch_auto = timed
        return self

    def __exit__(self, *exc):
        import torch

        self.mod.execute_batch_auto = self.real
        torch.cuda.synchronize()

    def summary(self) -> dict:
        rows = [(q, a.elapsed_time(b)) for q, a, b in self.events]
        batched = [ms for q, ms in rows if q > 1]
        return {
            "launches": len(rows),
            "batched_launches": len(batched),
            "device_ms_per_launch_mean": (
                sum(ms for _q, ms in rows) / len(rows) if rows else 0.0
            ),
            "device_ms_per_batched_launch_mean": (
                sum(batched) / len(batched) if batched else 0.0
            ),
            "device_ms_per_batched_launch_p50": (
                percentile(batched, 50) if batched else 0.0
            ),
            "rows_per_launch_mean": (
                sum(q for q, _ms in rows) / len(rows) if rows else 0.0
            ),
        }


def run() -> dict:
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.tiles import device_nbytes
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import bm25, bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.utils.corpus import (
        build_zipf_segment,
        pick_query_terms,
    )

    card = card_line()
    dev = torch.device(DEVICE)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_run = time.monotonic()
    launches: dict = {}

    # -- 1. build and 2. corpus ---------------------------------------------
    # All host work that needs no card runs at once on a pool, beside the
    # one-shard corpus: the kernels' build (one nvcc a source), the
    # corpus's body token stream with its positions ordered (phase
    # `phrase`, re-drawn from the generator's seed), phase `structured`'s
    # title and columns and `qa`, cfg3's shards, phase stacked-tail's
    # streams, columns and qa shards, and phase packed's tenants (numpy
    # releases the GIL in the long calls). All are joined after the corpus
    # is on the card, before phase 3, so no draw runs beside a timed phase.
    t0 = time.monotonic()
    pool = ThreadPoolExecutor(max_workers=8)
    try:
        f_build = pool.submit(kern.ensure_built)
        f_stream = pool.submit(TokenStream, N_DOCS, SEED, positions=True)
        f_title = pool.submit(structured_parts, N_DOCS, SEED + 9)
        draw_ahead(pool, "cfg3 shards", cfg3_shards)
        draw_ahead(pool, "stacked-tail", stacked_tail_draws)
        draw_ahead(pool, "qa", qa_segment)
        draw_ahead(pool, "qa shards", build_qa_shards)
        draw_ahead(pool, "packed", packed_corpus)
        _mappings, segment = build_zipf_segment(N_DOCS, seed=SEED)
        built_s = time.monotonic() - t0
        t_pos = time.monotonic()
        stream = f_stream.result()
        stream.add_positions(segment.fields["body"])
        positions_s = time.monotonic() - t_pos
        title_parts = f_title.result()
        f_build.result()
        build_s = kern.BUILD_INFO.get("seconds", 0.0)
        for line in str(kern.BUILD_INFO.get("log", "")).splitlines():
            if "registers" in line or line.startswith("=="):
                log(f"  ptxas {line.strip()}")
        log(f"phase build: ok {build_s:.2f} s beside the corpus "
            f"(cached={kern.BUILD_INFO.get('cached')}) [{card}]")
        # BASELINE config 4's feature columns, as bench.py:3326-3335 draws
        # them, and f3: f1 missing at every tenth doc (the sorted phase's
        # missing values).
        rng99 = np.random.default_rng(99)
        f1 = rng99.random(N_DOCS, dtype=np.float32)
        f2 = rng99.random(N_DOCS, dtype=np.float32)
        f3 = f1.copy()
        f3[::10] = np.nan
        segment.doc_values.update(f1=f1, f2=f2, f3=f3)
        # Phase `structured`'s fields: title (with positions), loc, pop,
        # pagerank and req.
        title_s = attach_structured(segment, title_parts)
        gen_s = time.monotonic() - t0
        node = Node(device=DEVICE)
        node.create_index("msmarco", {"mappings": {"properties": {
            "body": {"type": "text"}, "f1": {"type": "float"},
            "f2": {"type": "float"}, "f3": {"type": "float"},
            **STRUCTURED_MAPPINGS}}})
        svc = node.indices["msmarco"]
        t1 = time.monotonic()
        handle = svc.engine._install_segment(segment)
        torch.cuda.synchronize()
        pack_s = time.monotonic() - t1
        for f in list(_DRAWN.values()):
            f.result()
        draws_s = time.monotonic() - t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    fld = segment.fields["body"]
    log(
        f"phase corpus: ok {N_DOCS} docs, {len(fld.doc_ids)} postings, "
        f"{len(fld.terms)} terms, {len(fld.positions)} positions; generate "
        f"{gen_s:.1f} s (the segment {built_s:.1f} s, then its positions "
        f"{positions_s:.1f} s; every later phase's draws joined at "
        f"{draws_s:.1f} s), pack+upload {pack_s:.1f} s, device bytes "
        f"{device_nbytes(handle.device)} [{card}]"
    )

    # -- 3. main path over HTTP -------------------------------------------
    rng = np.random.default_rng(SEED)
    match_terms = pick_query_terms(segment, rng, N_MATCH, terms_per_query=4)
    mid_terms = pick_query_terms(segment, rng, N_SHOULD + N_MUST_FILTER, 4)
    by_df = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])
    head = by_df[:10]
    bodies = [{"query": {"match": {"body": " ".join(t)}}, "size": TOP_K}
              for t in match_terms]
    for i in range(N_SHOULD):
        t = mid_terms[i]
        bodies.append({"query": {"bool": {"should": [
            {"match": {"body": f"{t[0]} {t[1]}"}},
            {"match": {"body": t[2]}},
            {"term": {"body": t[3]}},
        ]}}, "size": TOP_K})
    for i in range(N_MUST_FILTER):
        t = mid_terms[N_SHOULD + i]
        # even i: a frequent filter (must-led fold, K4 membership);
        # odd i: a rare filter that leads the conjunction (K4 scoring)
        filt = head[i % len(head)] if i % 2 == 0 else t[3]
        bodies.append({"query": {"bool": {
            "must": [{"match": {"body": f"{t[0]} {t[1]} {t[2]}"}}],
            "filter": [{"term": {"body": filt}}],
        }}, "size": TOP_K})
    shape_of = (["match"] * N_MATCH + ["bool_should"] * N_SHOULD
                + ["bool_must_filter"] * N_MUST_FILTER)

    server, base = serve(node)
    try:
        banner = http(base, "GET", "/")
        http(base, "PUT", "/docs", {"mappings": {"properties": {
            "body": {"type": "text"}, "tag": {"type": "keyword"}}}})
        small_terms = pick_query_terms(segment, np.random.default_rng(SEED + 1), 500, 4)
        bulk = "".join(
            json.dumps({"index": {"_id": f"p{i}"}}) + "\n"
            + json.dumps({"body": " ".join(t), "tag": "even" if i % 2 == 0 else "odd"})
            + "\n"
            for i, t in enumerate(small_terms)
        )
        if http(base, "POST", "/docs/_bulk", raw=bulk)["errors"]:
            raise SmokeFailure("bulk indexing reported errors")
        http(base, "POST", "/docs/_refresh")
        small_bodies = [
            {"query": {"match": {"body": " ".join(small_terms[3])}}},
            {"query": {"bool": {"must": [{"match": {"body": small_terms[5][0]}}],
                                "filter": [{"term": {"tag": "even"}}]}}},
        ]
        # One untimed warm-up request per shape (first kernel launches,
        # allocator growth), timed on its own.
        first_ms = {}
        for i in (0, N_MATCH, N_MATCH + N_SHOULD, N_MATCH + N_SHOULD + 1):
            t0 = time.monotonic()
            http(base, "POST", "/msmarco/_search", bodies[i])
            first_ms[f"{shape_of[i]}#{i}"] = (time.monotonic() - t0) * 1e3
        log(f"  first request of each shape (untimed warm-up), ms: {json.dumps(first_ms)}")
        with counted("main", launches):
            latencies, responses, wall_s = sequential(base, "msmarco", bodies)
            small_out = [http(base, "POST", "/docs/_search", b) for b in small_bodies]
    finally:
        server.shutdown()
        server.server_close()
    log(f"phase main: ok {len(bodies)} _search over HTTP on {banner['version']['number']}, "
        f"{wall_s:.2f} s [{card}]")
    for out in small_out:
        if out["hits"]["total"]["value"] < 1:
            raise SmokeFailure("small index returned no hits")

    # -- 4. check -----------------------------------------------------------
    mismatches = 0
    t0 = time.monotonic()
    for terms, out in zip(match_terms, responses[:N_MATCH]):
        o_s, o_i = bm25.search_field(fld, terms, N_DOCS, TOP_K)
        matched = np.zeros(N_DOCS, dtype=bool)
        for term in terms:
            matched[fld.postings(term)[0]] = True
        if not same_hits(out, [segment.ids[int(d)] for d in o_i], o_s,
                         int(matched.sum())):
            mismatches += 1
            log(f"  MISMATCH match {terms}")
    seg_tree = bm25_device.segment_tree(handle.device)
    compiler = svc.engine.compiler_for(handle)
    plans = []
    for body in bodies[N_MATCH:]:
        c = compiler.compile(parse_query(body["query"]))
        plans.append((c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev)))
    with plain_kernels():
        for (spec, plan), out in zip(plans, responses[N_MATCH:]):
            s, i, t = bm25_device.execute_auto(seg_tree, spec, plan, TOP_K)
            s, i, t = s.cpu().numpy(), i.cpu().numpy(), int(t.cpu())
            n = min(TOP_K, t, len(i))
            if not same_hits(out, [segment.ids[int(d)] for d in i[:n]], s[:n], t):
                mismatches += 1
                log(f"  MISMATCH bool {spec[0]} {spec[1:]}")
    log(f"phase check: {'ok' if mismatches == 0 else 'FAILED'} {mismatches} hit "
        f"mismatches over {len(bodies)} queries at {N_DOCS} docs "
        f"({time.monotonic() - t0:.1f} s) [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} hit mismatches")

    # -- 5. concurrent (one shard) ----------------------------------------
    # Each request four times, the copies shuffled as in the sharded
    # phase: only equal compiled specs share a bool query's launch.
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()  # fresh counters
    server, base = serve(node)
    order = np.random.default_rng(SEED + 2).permutation(
        np.tile(np.arange(len(bodies)), 4)
    )
    conc_bodies = [bodies[int(j)] for j in order]
    try:
        with counted("concurrent", launches):
            c_lat, c_resp, c_wall = concurrent(base, "msmarco", conc_bodies, N_CLIENTS)
    finally:
        server.shutdown()
        server.server_close()
    single_stats = node.exec_batcher.stats()
    bad = sum(
        without_took(c_resp[n]) != without_took(responses[int(j)])
        for n, j in enumerate(order)
    )
    single_conc = {
        "requests": len(conc_bodies),
        "qps": len(conc_bodies) / c_wall,
        "p50_ms": percentile(c_lat, 50),
        "p99_ms": percentile(c_lat, 99),
        "mismatches_vs_sequential": bad,
        "batcher": single_stats,
    }
    log(f"phase concurrent: {'ok' if bad == 0 else 'FAILED'} {json.dumps(single_conc)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} concurrent answers differ from sequential")

    # -- 6. kernels at main-path shapes (one shard) -----------------------
    q_single = max(2, round(single_stats["occupancy_mean"]))
    rows = kernel_rows_single(seg_tree, compiler, bodies, launches, dev, q_single)
    kernel_row_matched_only(seg_tree, compiler, head[0], dev, rows)
    log(f"phase kernels: ok 0 mismatches over {len(rows)} kernels [{card}]")

    # -- 6h. sequential (row 17): phase 3's 32 matches as one strict chain
    chains = {}
    m_spec, m_plan = _stacked_plan(compiler, bodies[:N_MATCH], dev)
    if not bm25_device.supports_sparse(m_spec):
        raise SmokeFailure(f"phase 3's matches are not sparse: {m_spec}")
    chains["cfg2_match_sparse"], m_out = run_chain(
        card, "cfg2 match (execute_sequential_sparse)",
        lambda: bm25_device.execute_sequential_sparse(seg_tree, m_spec, m_plan,
                                                      TOP_K),
        lambda: bm25_device.execute_batch_sparse(seg_tree, m_spec, m_plan, TOP_K),
        lambda r: bm25_device.execute_batch_sparse(
            seg_tree, m_spec, bm25_device._row_of(m_plan, r), TOP_K),
        N_MATCH, launches)
    kernel_row_chain(rows, m_plan["weights"], m_out[2])

    # -- 12a. results of the one-shard phases -----------------------------
    exec_ms, plan_ms = [], []
    for body in bodies:
        t0 = time.perf_counter()
        c = compiler.compile(parse_query(body["query"]))
        plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        bm25_device.execute_auto(seg_tree, c.spec, plan, TOP_K)
        ev1.record()
        torch.cuda.synchronize()
        exec_ms.append(ev0.elapsed_time(ev1))
    slowest = sorted(range(len(bodies)), key=lambda i: -latencies[i])[:3]
    log("  slowest sequential requests: " + json.dumps([
        {"shape": shape_of[i], "ms": latencies[i], "host_plan_ms": plan_ms[i],
         "device_ms": exec_ms[i]} for i in slowest
    ]))
    groups = {
        "match": slice(0, N_MATCH),
        "bool_should": slice(N_MATCH, N_MATCH + N_SHOULD),
        "bool_must_filter": slice(N_MATCH + N_SHOULD, len(bodies)),
    }
    single = {
        "search_p50_ms": percentile(latencies, 50),
        "search_p99_ms": percentile(latencies, 99),
        "qps_sequential": len(bodies) / wall_s,
        "device_execute_p50_ms": percentile(exec_ms, 50),
        "host_plan_p50_ms": percentile(plan_ms, 50),
        "per_shape_device_p50_ms": {k: percentile(exec_ms[s], 50) for k, s in groups.items()},
        "per_shape_host_plan_p50_ms": {k: percentile(plan_ms[s], 50) for k, s in groups.items()},
        "per_shape_p50_ms": {k: percentile(latencies[s], 50) for k, s in groups.items()},
        "first_request_ms": first_ms,
        "concurrent": single_conc,
        "sequential_chains": chains,
        "docs": N_DOCS,
    }
    log(f"phase results (one shard): {json.dumps(single)} [{card}]")

    # -- 6b. block-max on the one-shard corpus ----------------------------
    single["blockmax"] = run_blockmax(
        card, dev, node, segment, seg_tree, compiler, bodies, responses,
        launches
    )

    # -- 6c/6d. rescore (BASELINE config 4) and sorted, same corpus ------
    single["rescore"] = run_rescore(card, dev, node, seg_tree, compiler,
                                    segment, match_terms, launches)
    single["sorted"] = run_sorted(card, node, segment, match_terms, launches)
    rows.extend(kernel_rows_slice4(seg_tree, compiler, match_terms, dev))
    single["aggs_full"] = run_aggs_full(card, node, segment, launches)
    kernel_rows_aggs_full(seg_tree, dev, rows)
    single["phrase"] = run_phrase(card, dev, node, seg_tree, compiler,
                                  segment, stream, launches, rows)
    single["structured"] = run_structured(card, dev, node, segment, title_s,
                                          launches, rows)
    single["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    log(f"  one-shard phases: peak device memory "
        f"{single['max_memory_allocated_bytes']} B [{card}]")

    # Free the one-shard corpus before the sharded one.
    node.close()
    del node, svc, handle, segment, fld, seg_tree, compiler, plans, plan
    del f1, f2, f3, stream
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    sharded = run_sharded(card, dev, launches, rows)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    knn = run_knn(card, dev, launches, rows)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    aggs = run_aggs(card, dev, launches, rows)
    nan_pages = run_nan_pages(card, launches)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_phrase = run_mesh_phrase(card, dev, launches)
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        mesh_phrase["cards"] = run_mesh_cards(card, launches)
        gc.collect()
        torch.cuda.empty_cache()
    else:
        log(f"  mesh cards: not run (1 card on this machine) [{card}]")
    torch.cuda.reset_peak_memory_stats()
    packed = run_packed(card, dev, launches, rows)
    missing = [name for name in kern.LAUNCHES if launches.get(name, 0) <= 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the main path: {missing}")
    log(f"  launches over all main-path phases: {json.dumps(launches)}")
    log(f"  K3 routes over all main-path phases: "
        f"{json.dumps({n: c for n, c in launches.items() if ':' in n})}")
    for r in rows:
        if "launches_of" not in r:
            r["launches"] = launches[r["name"]]
    log(f"phase results: whole run {time.monotonic() - t_run:.1f} s [{card}]")
    return {"card": card, "kernels": rows,
            "result": {"one_shard": single, "sharded": sharded, "knn": knn,
                       "aggs": aggs, "nan_pages": nan_pages,
                       "mesh_phrase": mesh_phrase, "packed": packed}}


class PruneRecorder:
    """The `instruments` of the block-max calls: every pruned fraction."""

    def __init__(self):
        self.fractions: list[float] = []

    def blockmax_pruned(self, fraction: float) -> None:
        self.fractions.append(float(fraction))


def _same_topk(got, exact, row: int, k: int) -> bool:
    """A block-max row against the exact row: fp32 score bits of the whole
    row, ids over the hits, and a total that is a lower bound."""
    import numpy as np

    s, i, t = got
    s_e, i_e, t_e = exact
    n = min(k, int(t_e[row]))
    return (
        np.array_equal(score_bits(s[row]), score_bits(s_e[row]))
        and np.array_equal(i[row][:n], i_e[row][:n])
        and int(t[row]) <= int(t_e[row])
    )


def run_blockmax(card, dev, node, segment, seg_tree, compiler, bodies,
                 responses, launches) -> dict:
    """Block-max on the cfg2 corpus: execute_batch_blockmax on the match
    plans and execute_batch_blockmax_conj on the bool(must + filter)
    plans, per spec group at k = 10 as the JAX bench groups them, each
    held to execute_batch_sparse on the same plans; then the same bodies
    with untracked totals, four times over HTTP, on the corpus's node with
    its batcher set aside (a node without a batcher, as Node(exec_batcher=
    False) builds it) and a fresh planner, which explores both backends of
    every plan class."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.exec.planner import ExecPlanner
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query

    conj_lo = N_MATCH + N_SHOULD
    picked = list(range(N_MATCH)) + list(range(conj_lo, len(bodies)))
    groups: dict[tuple, list[int]] = {}
    compiled = {}
    for j in picked:
        compiled[j] = compiler.compile(parse_query(bodies[j]["query"]))
        groups.setdefault(compiled[j].spec, []).append(j)

    def exact(spec, rows):
        arrays = bm25_device.stack_plans([compiled[j].arrays for j in rows])
        out = bm25_device.execute_batch_sparse(
            seg_tree, spec, bm25_device.plan_to_torch(spec, arrays, dev), TOP_K)
        return tuple(t.cpu().numpy() for t in out)

    def pruned(spec, rows, rec=None):
        fn = (bm25_device.execute_batch_blockmax if spec[0] == "terms"
              else bm25_device.execute_batch_blockmax_conj)
        return fn(seg_tree, spec, [compiled[j].arrays for j in rows], TOP_K,
                  instruments=rec)

    eligible = {
        spec: rows for spec, rows in groups.items()
        if spec[0] == "terms" or bm25_device.supports_blockmax_conj(spec)
    }
    want = {spec: exact(spec, rows) for spec, rows in eligible.items()}
    rec = PruneRecorder()
    relations = {"eq": 0, "gte": 0}
    mismatches = 0
    with counted("blockmax", launches):
        got = {spec: pruned(spec, rows, rec) for spec, rows in eligible.items()}
    for spec, rows in eligible.items():
        relations[got[spec][3]] += len(rows)
        for row in range(len(rows)):
            ok = _same_topk(got[spec][:3], want[spec], row, TOP_K)
            if got[spec][3] == "eq":
                ok = ok and int(got[spec][2][row]) == int(want[spec][2][row])
            if not ok:
                mismatches += 1
                log(f"  MISMATCH blockmax {bodies[rows[row]]}")
    n_terms = sum(len(r) for sp, r in eligible.items() if sp[0] == "terms")
    n_conj = sum(len(r) for sp, r in eligible.items() if sp[0] == "bool")

    # Host clock, plans uploaded and results fetched in both: the block-max
    # calls include their host prune.
    def per_query_ms(fn, terms: bool, reps: int = 3) -> float:
        chosen = {sp: r for sp, r in eligible.items() if (sp[0] == "terms") == terms}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for spec, rows in chosen.items():
                fn(spec, rows)
        return (time.perf_counter() - t0) * 1e3 / (reps * sum(map(len, chosen.values())))

    timing = {
        "blockmax_ms_per_query": per_query_ms(pruned, True),
        "sparse_ms_per_query_terms": per_query_ms(exact, True),
        "blockmax_conj_ms_per_query": per_query_ms(pruned, False),
        "sparse_ms_per_query_conj": per_query_ms(exact, False),
    }
    summary = {
        "match_plans": n_terms, "conj_plans": n_conj,
        "conj_not_eligible": len(bodies) - conj_lo - n_conj,
        "spec_groups": len(eligible), "relations": relations,
        "pruned_tile_fraction_mean": float(np.mean(rec.fractions)) if rec.fractions else 0.0,
        "mismatches": mismatches, **timing,
    }
    log(f"phase blockmax: {'ok' if mismatches == 0 else 'FAILED'} {json.dumps(summary)} [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} block-max mismatches")
    if not n_terms or not n_conj:
        raise SmokeFailure("no plan eligible for one of the block-max paths")

    # The planner's routing on the solo path: the node without its batcher
    # (every search solo) and with a fresh planner, on the same corpus (a
    # second copy of it would cost a pack of 8.8 M docs).
    search = node.indices["msmarco"].search
    saved = (node.exec_batcher, node.exec_planner, search.planner)
    planner = ExecPlanner()
    node.exec_batcher, node.exec_planner, search.planner = None, planner, planner
    server, base = serve(node)
    bad = 0
    try:
        with counted("blockmax node", launches):
            latencies, outs, wall_s = sequential(
                base, "msmarco",
                [{**bodies[j], "track_total_hits": False} for j in picked] * 4)
    finally:
        server.shutdown()
        server.server_close()
        node.exec_batcher, node.exec_planner, search.planner = saved
    for n, out in enumerate(outs):
        ref = responses[picked[n % len(picked)]]
        if ("total" in out["hits"]
                or [h["_id"] for h in out["hits"]["hits"]]
                != [h["_id"] for h in ref["hits"]["hits"]]
                or not np.array_equal(
                    score_bits([h["_score"] for h in out["hits"]["hits"]]),
                    score_bits([h["_score"] for h in ref["hits"]["hits"]]))):
            bad += 1
            log(f"  MISMATCH solo untracked {bodies[picked[n % len(picked)]]}")
    stats = planner.stats()
    decisions = stats["decisions"]
    routed = {
        "requests": len(outs),
        "p50_ms": percentile(latencies, 50), "p99_ms": percentile(latencies, 99),
        "qps": len(outs) / wall_s, "mismatches": bad,
        "plan_classes": len(stats["ewma"]), "planner": stats,
    }
    log(f"phase blockmax node: {'ok' if bad == 0 else 'FAILED'} {json.dumps(routed)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} solo untracked answers differ")
    if decisions.get("blockmax", 0) <= 0 or decisions.get("blockmax_conj", 0) <= 0:
        raise SmokeFailure(f"the planner never chose a block-max path: {decisions}")
    return {**summary, "node": {k: v for k, v in routed.items() if k != "planner"},
            "decisions": decisions}


def _cfg4_rescore_query() -> dict:
    return {"script_score": {"query": {"match_all": {}},
                             "script": {"source": CFG4_SCRIPT,
                                        "params": CFG4_PARAMS}}}


def _matched_mask(fld, terms):
    import numpy as np

    matched = np.zeros(N_DOCS, dtype=bool)
    for term in terms:
        matched[fld.postings(term)[0]] = True
    return matched


def run_rescore(card, dev, node, seg_tree, compiler, segment, match_terms,
                launches) -> dict:
    """BASELINE config 4 over HTTP, then execute_rescore on the same plans;
    both held bit for bit to bench.py's two-phase oracle (bench.py:
    1317-1339): the numpy BM25 top-1000, the script's products and sums
    in numpy fp32, then the combined order (the REST stage breaks ties by
    doc id, the fused top-k by window position)."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import bm25, bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query

    fld = segment.fields["body"]
    f1, f2 = segment.doc_values["f1"], segment.doc_values["f2"]
    rescore = {"window_size": CFG4_WINDOW, "query": {
        "rescore_query": _cfg4_rescore_query(), "query_weight": 1.0,
        "rescore_query_weight": 1.0}}
    bodies = [{"query": {"match": {"body": " ".join(t)}}, "size": TOP_K,
               "rescore": rescore} for t in match_terms]
    server, base = serve(node)
    try:
        t0 = time.monotonic()
        http(base, "POST", "/msmarco/_search", bodies[0])  # untimed warm-up
        first_ms = (time.monotonic() - t0) * 1e3
        with counted("rescore", launches):
            latencies, responses, wall_s = sequential(base, "msmarco", bodies)
    finally:
        server.shutdown()
        server.server_close()

    w0, w1, w2 = (np.float32(CFG4_PARAMS[k]) for k in ("w0", "w1", "w2"))
    one = np.float32(1.0)
    mismatches = 0
    fused_want = []
    t0 = time.monotonic()
    for terms, out in zip(match_terms, responses):
        o_s, o_i = bm25.search_field(fld, terms, N_DOCS, CFG4_WINDOW)
        rs = (w0 * one + w1 * f1[o_i] + w2 * f2[o_i]).astype(np.float32)
        comb = (one * o_s + one * rs).astype(np.float32)
        total = int(_matched_mask(fld, terms).sum())
        order = np.lexsort((o_i, -comb.astype(np.float64)))[:TOP_K]
        if not same_hits(out, [segment.ids[int(d)] for d in o_i[order]],
                         comb[order], total):
            mismatches += 1
            log(f"  MISMATCH rescore {terms}")
        by_pos = np.argsort(-comb, kind="stable")[:TOP_K]
        fused_want.append((o_i[by_pos], comb[by_pos], total, out))
    oracle_s = time.monotonic() - t0

    rc = compiler.compile(parse_query(_cfg4_rescore_query()))
    rplan = bm25_device.plan_to_torch(rc.spec, rc.arrays, dev)
    plans = []
    for terms in match_terms:
        c = compiler.compile(parse_query({"match": {"body": " ".join(terms)}}))
        plans.append((c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev)))

    def fused():
        return [bm25_device.execute_rescore(seg_tree, spec, plan, rc.spec, rplan,
                                            TOP_K, CFG4_WINDOW, 1.0, 1.0)
                for spec, plan in plans]

    with counted("rescore fused", launches):
        outs = [tuple(t.cpu().numpy() for t in o) for o in fused()]
    fused_bad = 0
    for (s, i, t), (ids, comb, total, rest) in zip(outs, fused_want):
        n = len(ids)
        rest_ids = [h["_id"] for h in rest["hits"]["hits"]]
        rest_bits = score_bits([h["_score"] for h in rest["hits"]["hits"]])
        if not (np.array_equal(i[:n], ids)
                and np.array_equal(score_bits(s[:n]), score_bits(comb))
                and int(t) == total
                and [segment.ids[int(d)] for d in i[:n]] == rest_ids
                and np.array_equal(score_bits(s[:n]), rest_bits)):
            fused_bad += 1
            log(f"  MISMATCH execute_rescore {rest_ids[:3]}")
    fused_ms = cuda_ms(fused, reps=3) / len(plans)
    # Phase `sequential`: the same 32 rescores as one strict chain.
    q_n = len(match_terms)
    b_spec, b_plan = _stacked_plan(compiler, [
        {"query": {"match": {"body": " ".join(t)}}} for t in match_terms], dev)
    rb_plan = bm25_device.plan_to_torch(
        rc.spec, bm25_device.stack_plans([rc.arrays] * q_n), dev)
    row_of = bm25_device._row_of
    chain, _out = run_chain(
        card, "cfg4 rescore (execute_rescore_sequential)",
        lambda: bm25_device.execute_rescore_sequential(
            seg_tree, b_spec, b_plan, rc.spec, rb_plan, TOP_K, CFG4_WINDOW,
            1.0, 1.0),
        lambda: bm25_device._rescore_inner(
            seg_tree, b_spec, b_plan, rc.spec, rb_plan, TOP_K, CFG4_WINDOW,
            1.0, 1.0, q_n),
        lambda r: bm25_device._rescore_inner(
            seg_tree, b_spec, row_of(b_plan, r), rc.spec, row_of(rb_plan, r),
            TOP_K, CFG4_WINDOW, 1.0, 1.0, 1),
        q_n, launches)
    del _out, b_plan, rb_plan
    summary = {
        "requests": len(bodies), "window": CFG4_WINDOW,
        "search_p50_ms": percentile(latencies, 50),
        "search_p99_ms": percentile(latencies, 99),
        "qps_sequential": len(bodies) / wall_s, "first_request_ms": first_ms,
        "mismatches_vs_oracle": mismatches,
        "execute_rescore_mismatches": fused_bad,
        "execute_rescore_device_ms_per_query": fused_ms,
        "oracle_s": oracle_s,
        "sequential_chain": chain,
    }
    log(f"phase rescore: {'ok' if mismatches + fused_bad == 0 else 'FAILED'} "
        f"{json.dumps(summary)} [{card}]")
    if mismatches or fused_bad:
        raise SmokeFailure(f"{mismatches} rescore and {fused_bad} execute_rescore "
                           f"mismatches")
    return summary


# The sorted phase's sorts: (name, REST sort, [(field, desc, missing_first)]).
SORTS = [
    ("f1_desc", [{"f1": "desc"}], [("f1", True, False)]),
    ("f3_asc_missing_first", [{"f3": {"order": "asc", "missing": "_first"}}],
     [("f3", False, True)]),
    ("score_asc", [{"_score": "asc"}], [("_score", False, False)]),
    ("f3_desc_f2_asc", [{"f3": "desc"}, {"f2": "asc"}],
     [("f3", True, False), ("f2", False, False)]),
]
WALK_SORTS = [SORTS[0], SORTS[1],
              ("score_desc", [{"_score": "desc"}], [("_score", True, False)]),
              SORTS[2]]


class SortOracle:
    """One query's matched docs and their sort keys: the numpy oracle of
    the sorted phase (a stable order by the transformed keys, then doc
    id)."""

    def __init__(self, segment, terms):
        import numpy as np

        from elasticsearch_tpu_torch.ops import bm25

        fld = segment.fields["body"]
        matched = np.zeros(N_DOCS, dtype=bool)
        scores = bm25.score_terms_dense(fld, terms, N_DOCS, matched=matched)
        self.ids = np.flatnonzero(matched).astype(np.int64)
        self.scores = scores[self.ids].astype(np.float32)
        self.cols = {f: segment.doc_values[f][self.ids].astype(np.float32)
                     for f in ("f1", "f2", "f3")}
        self.segment = segment

    def raw(self, field):
        return self.scores if field == "_score" else self.cols[field]

    def key(self, field, desc, mfirst):
        import numpy as np

        v = self.raw(field)
        fmax = np.float32(np.finfo(np.float32).max)
        k = np.where(np.isnan(v), -fmax if mfirst else fmax, -v if desc else v)
        return k.astype(np.float64)

    def page(self, keys, start, count, after=None):
        """Hits [start, start + count) of the order, after the key-only
        cursor `after` (a REST sort value) when one is given: (_id, sort
        values, _score) each."""
        import numpy as np

        ks = [self.key(*k) for k in keys]
        sel = np.ones(len(self.ids), dtype=bool)
        if after is not None:
            f, desc, mfirst = keys[0]
            fmax = np.float64(np.finfo(np.float32).max)
            if after[0] is None:
                c = -fmax if mfirst else fmax
            else:
                c = float(np.float32(after[0]))
                c = -c if desc else c
            sel &= ks[0] > c
        idx = np.flatnonzero(sel)
        n = start + count
        if len(idx) > n:  # keep the n-th primary key's ties
            kth = np.partition(ks[0][idx], n - 1)[n - 1]
            idx = idx[ks[0][idx] <= kth]
        order = idx[np.lexsort((self.ids[idx],) + tuple(k[idx] for k in reversed(ks)))]
        out = []
        for j in order[start:n]:
            vals = [None if np.isnan(self.raw(f)[j]) else float(self.raw(f)[j])
                    for f, _d, _m in keys]
            score = float(self.scores[j]) if keys[0][0] == "_score" else None
            out.append((self.segment.ids[int(self.ids[j])], vals, score))
        return out


def _hits_of(out):
    return [(h["_id"], h.get("sort"), h["_score"]) for h in out["hits"]["hits"]]


def _same_page(got, want) -> bool:
    import numpy as np

    def bits(v):
        return None if v is None else int(np.float32(v).view(np.int32))

    return len(got) == len(want) and all(
        g[0] == w[0] and [bits(x) for x in g[1]] == [bits(x) for x in w[1]]
        and bits(g[2]) == bits(w[2]) for g, w in zip(got, want))


def run_sorted(card, node, segment, match_terms, launches) -> dict:
    """Field, `_score`-ascending and two-key sorts of phase 3's 32 match
    queries over HTTP, and search_after walks, each page against the
    numpy oracle; a walk page differs from the from/size page only where
    a key-only cursor skips the docs that tie with it."""
    bodies = [({"query": {"match": {"body": " ".join(t)}}, "sort": rest,
                "size": TOP_K}, qi, keys)
              for qi, t in enumerate(match_terms) for _n, rest, keys in SORTS]
    server, base = serve(node)
    walk_out: dict = {}
    try:
        http(base, "POST", "/msmarco/_search", bodies[0][0])  # warm-up
        with counted("sorted", launches):
            latencies, responses, wall_s = sequential(
                base, "msmarco", [b for b, _q, _k in bodies])
            t0 = time.monotonic()
            n_walk = 0
            for qi in range(N_WALK):
                query = {"match": {"body": " ".join(match_terms[qi])}}
                for name, rest, keys in WALK_SORTS:
                    after, pages, fsize = None, [], []
                    for p in range(WALK_PAGES):
                        body = {"query": query, "sort": rest, "size": TOP_K}
                        if after is not None:
                            body["search_after"] = after
                        out = http(base, "POST", "/msmarco/_search", body)
                        pages.append((after, _hits_of(out)))
                        fsize.append(_hits_of(http(
                            base, "POST", "/msmarco/_search",
                            {"query": query, "sort": rest, "size": TOP_K,
                             "from": p * TOP_K})))
                        n_walk += 2
                        if not out["hits"]["hits"]:
                            break
                        after = out["hits"]["hits"][-1]["sort"]
                    walk_out[(qi, name)] = (keys, pages, fsize)
            walk_s = time.monotonic() - t0
    finally:
        server.shutdown()
        server.server_close()

    mismatches = 0
    t0 = time.monotonic()
    oracles = {}
    for (body, qi, keys), out in zip(bodies, responses):
        if qi not in oracles:
            oracles[qi] = SortOracle(segment, match_terms[qi])
        o = oracles[qi]
        if not _same_page(_hits_of(out), o.page(keys, 0, TOP_K)) or (
                out["hits"]["total"]["value"] != min(len(o.ids), 10_000)):
            mismatches += 1
            log(f"  MISMATCH sorted {body['sort']} {match_terms[qi]}")
    walk_bad = 0
    tie_pages = 0
    for (qi, name), (keys, pages, fsize) in walk_out.items():
        o = oracles[qi]
        for p, ((after, got), fs) in enumerate(zip(pages, fsize)):
            want = o.page(keys, 0, TOP_K, after=after)
            want_fs = o.page(keys, p * TOP_K, TOP_K)
            if not _same_page(got, want) or not _same_page(fs, want_fs):
                walk_bad += 1
                log(f"  MISMATCH search_after {name} page {p} {match_terms[qi]}")
            elif not _same_page(got, fs):
                tie_pages += 1
    oracle_s = time.monotonic() - t0
    summary = {
        "requests": len(bodies), "search_p50_ms": percentile(latencies, 50),
        "search_p99_ms": percentile(latencies, 99),
        "qps_sequential": len(bodies) / wall_s,
        "per_sort_p50_ms": {
            name: percentile(latencies[i::len(SORTS)], 50)
            for i, (name, _r, _k) in enumerate(SORTS)},
        "walks": len(walk_out), "walk_requests": n_walk, "walk_s": walk_s,
        "mismatches": mismatches, "walk_mismatches": walk_bad,
        "walk_pages_past_a_tied_cursor": tie_pages, "oracle_s": oracle_s,
    }
    log(f"phase sorted: {'ok' if mismatches + walk_bad == 0 else 'FAILED'} "
        f"{json.dumps(summary)} [{card}]")
    if mismatches or walk_bad:
        raise SmokeFailure(f"{mismatches} sorted and {walk_bad} search_after "
                           f"mismatches")
    return summary


def cfg3_shard_docs() -> list[int]:
    """Docs a shard of cfg3's deployment: N_DOCS over N_SHARDS."""
    return [N_DOCS // N_SHARDS + (1 if s < N_DOCS % N_SHARDS else 0)
            for s in range(N_SHARDS)]


def cfg3_shards():
    """cfg3's 8 shards (build_zipf_segment, seed 100 + shard), drawn on
    four threads, with _ids unique across the shards."""
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    shard_docs = cfg3_shard_docs()

    def shard(s):
        _m, seg = build_zipf_segment(shard_docs[s], vocab_size=30_000,
                                     seed=100 + s)
        # Unique _ids across shards (the generator numbers docs from 0).
        return replace(seg, ids=[f"s{s}d{i}" for i in range(shard_docs[s])])

    with ThreadPoolExecutor(max_workers=4) as pool:  # independent draws
        return list(pool.map(shard, range(N_SHARDS)))


def run_sharded(card, dev, launches, rows) -> dict:
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.tiles import device_nbytes
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.search.service import SearchRequest

    # -- 7. sharded corpus (BASELINE config 3's layout) --------------------
    shard_docs = cfg3_shard_docs()
    t0 = time.monotonic()
    shards = drawn("cfg3 shards", cfg3_shards)
    gen_s = time.monotonic() - t0
    node = Node(device=DEVICE)
    node.create_index("cfg3", {
        "settings": {"index": {"number_of_shards": N_SHARDS}},
        "mappings": {"properties": {"body": {"type": "text"}}},
    })
    svc = node.indices["cfg3"]
    t1 = time.monotonic()
    with ThreadPoolExecutor(max_workers=4) as pool:  # a shard an engine
        handles = list(pool.map(lambda e, seg: e._install_segment(seg),
                                svc.engines, shards))
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t1
    postings = sum(len(seg.fields["body"].doc_ids) for seg in shards)
    nbytes = sum(device_nbytes(h.device) for h in handles)
    log(f"phase sharded corpus: ok {N_SHARDS} shards, {sum(shard_docs)} docs "
        f"({shard_docs[0]} / {shard_docs[-1]} a shard), {postings} postings; "
        f"generate {gen_s:.1f} s more (drawn beside phase 2), pack+upload {pack_s:.1f} s, device bytes "
        f"{nbytes} [{card}]")

    # -- 8. sharded sequential ---------------------------------------------
    fld0 = shards[0].fields["body"]
    by_df = sorted(fld0.terms, key=lambda t: -fld0.df[fld0.terms[t]])
    head = by_df[: len(by_df) // 100]
    mid = by_df[len(by_df) // 100 : len(by_df) // 4]
    rng = np.random.default_rng(7)
    bodies, match_terms = [], []
    for _ in range(N_CFG3):  # bench.py cfg3's shape
        m1, m2 = rng.choice(mid, 2, replace=False)
        bodies.append({"query": {"bool": {
            "must": [{"match": {"body": f"{m1} {m2}"}}],
            "filter": [{"term": {"body": str(rng.choice(head))}}],
        }}, "size": TOP_K})
    for _ in range(N_CFG3_MATCH):
        terms = [str(rng.choice(head))] + [str(t) for t in rng.choice(mid, 3, replace=False)]
        match_terms.append(terms)
        bodies.append({"query": {"match": {"body": " ".join(terms)}}, "size": TOP_K})
    server, base = serve(node)
    try:
        for i in (0, N_CFG3):  # one untimed warm-up request per shape
            http(base, "POST", "/cfg3/_search", bodies[i])
        with counted("sharded sequential", launches), LaunchTimer() as seq_timer:
            latencies, responses, wall_s = sequential(base, "cfg3", bodies)
    finally:
        server.shutdown()
        server.server_close()
    seq_stats = node.exec_batcher.stats()
    log(f"phase sharded sequential: ok {len(bodies)} _search over HTTP, "
        f"{wall_s:.2f} s [{card}]")

    mismatches = 0
    t0 = time.monotonic()
    stats = svc.search.global_stats()["body"]
    for terms, out in zip(match_terms, responses[N_CFG3:]):
        ids, scores, total = shard_oracle(shards, terms, stats, TOP_K)
        if not same_hits(out, ids, scores, total):
            mismatches += 1
            log(f"  MISMATCH sharded match {terms}")
    with plain_kernels():
        for body, out in zip(bodies, responses):
            want = svc.search.search(SearchRequest.from_json(body)).to_json("cfg3")
            if without_took(want) != without_took(out):
                mismatches += 1
                log(f"  MISMATCH sharded plain {body}")
    for out in responses:
        if out["_shards"] != {"total": 8, "successful": 8, "skipped": 0, "failed": 0}:
            mismatches += 1
            log(f"  MISMATCH _shards {out['_shards']}")
    log(f"phase sharded check: {'ok' if mismatches == 0 else 'FAILED'} "
        f"{mismatches} mismatches over {len(bodies)} queries "
        f"({time.monotonic() - t0:.1f} s) [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} sharded mismatches")

    # -- 9. sharded concurrent ---------------------------------------------
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()  # defaults, fresh counters
    order = np.random.default_rng(SEED + 3).permutation(N_CONCURRENT)
    conc_bodies = [bodies[int(j) % len(bodies)] for j in order]
    server, base = serve(node)
    try:
        with counted("sharded concurrent", launches), LaunchTimer() as timer:
            c_lat, c_resp, c_wall = concurrent(base, "cfg3", conc_bodies, N_CLIENTS)
    finally:
        server.shutdown()
        server.server_close()
    batcher = node.exec_batcher.stats()
    bad = sum(
        without_took(c_resp[n]) != without_took(responses[int(j) % len(bodies)])
        for n, j in enumerate(order)
    )
    conc = {
        "requests": N_CONCURRENT,
        "clients": N_CLIENTS,
        "qps": N_CONCURRENT / c_wall,
        "p50_ms": percentile(c_lat, 50),
        "p99_ms": percentile(c_lat, 99),
        "mismatches_vs_sequential": bad,
        "batcher": batcher,
        "device": timer.summary(),
    }
    log(f"phase sharded concurrent: {'ok' if bad == 0 else 'FAILED'} {json.dumps(conc)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} sharded concurrent answers differ from sequential")
    if batcher["occupancy_mean"] < 2:
        raise SmokeFailure(f"mean batch occupancy {batcher['occupancy_mean']} < 2")

    # -- 10. routed small index ----------------------------------------------
    routed_mismatches = run_routed(node, fld0, card, launches)

    # -- 11. batched kernels at the sharded path's shapes -----------------
    q_batch = max(2, round(batcher["occupancy_mean"]))
    rows.extend(kernel_rows_sharded(svc, handles, bodies, dev, q_batch))
    log(f"phase batched kernels: ok 0 mismatches, Q = {q_batch} [{card}]")

    # The coordinator's dense 8-shard path, device time per request (the
    # sum over its per-shard launches), to set the stacked phase beside.
    dense = {
        "sequential_device_ms_per_request":
            sum(a.elapsed_time(b) for _q, a, b in seq_timer.events) / len(bodies),
        "concurrent_device_ms_per_request":
            sum(a.elapsed_time(b) for _q, a, b in timer.events) / N_CONCURRENT,
    }
    log(f"  coordinator dense path: {json.dumps(dense)}")
    sharded_peak = int(torch.cuda.max_memory_allocated())

    # -- 19. filter-cache on cfg3's node (its mesh part inside phase 18) --
    fc_musts = [" ".join(str(t) for t in rng.choice(mid, 2, replace=False))
                for _ in range(4)]
    fc = run_filter_cache(card, dev, node, None, fc_musts,
                          {"cfg3": _cfg3_fc_filters(by_df)}, launches,
                          mesh=False)
    fc_pending = fc.pop("pending")

    # -- 18. mesh: the same shards and bodies served as one mesh request --
    mesh = run_mesh_cfg3(card, dev, node, shards, bodies, responses,
                         latencies, launches, rows,
                         fc_check=fc_pending.get("cfg3"))
    fc["cfg3"]["mesh"] = mesh.pop("filter_cache")
    node.close()
    del node, svc, handles, timer, seq_timer
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13. stacked shards on one device (row 9b, row 12's shard form) ---
    stacked = run_stacked(card, dev, shards, bodies, match_terms, launches, rows)
    stacked["coordinator_dense"] = dense
    stacked["tail"] = run_stacked_tail(card, dev, shards, launches, rows)
    log(f"  cfg3 mesh / host loop / stacked: sequential p50 "
        f"{mesh['mesh_p50_ms']} / {mesh['host_loop_p50_ms']} ms, p99 "
        f"{mesh['mesh_p99_ms']} / {mesh['host_loop_p99_ms']} ms; device ms "
        f"per request {mesh['device_ms_per_request_mean']} (mesh) / "
        f"{dense['sequential_device_ms_per_request']} (host loop) / "
        f"{stacked['device_ms_per_query_q1']} (stacked, Q = 1) / "
        f"{stacked['device_ms_per_query_batched']} (stacked, batched) [{card}]")

    result = {
        "docs": sum(shard_docs),
        "shards": N_SHARDS,
        "search_p50_ms": percentile(latencies, 50),
        "search_p99_ms": percentile(latencies, 99),
        "per_shape_p50_ms": {
            "bool_must_filter": percentile(latencies[:N_CFG3], 50),
            "match": percentile(latencies[N_CFG3:], 50),
        },
        "qps_sequential": len(bodies) / wall_s,
        "sequential_batcher": seq_stats,
        "concurrent": conc,
        "routed_mismatches": routed_mismatches,
        "max_memory_allocated_bytes": sharded_peak,
        "stacked": stacked,
        "mesh": mesh,
        "filter_cache": fc,
    }
    log(f"phase results (sharded): {json.dumps(result)} [{card}]")
    return result


def _oracle_topk(scores, eligible, k: int):
    """Doc ids of the top k eligible docs by (score desc, doc asc)."""
    import numpy as np

    idx = np.flatnonzero(eligible)
    if len(idx) > k:  # keep the k-th score's ties, drop what cannot win
        sc = scores[idx]
        idx = idx[sc >= np.partition(sc, len(sc) - k)[len(sc) - k]]
    return idx[np.lexsort((idx, -scores[idx].astype(np.float64)))[:k]]


def stacked_oracle(shards, query, k: int, docs_per_shard: int):
    """The numpy oracle per shard with that shard's own statistics,
    merged by (score desc, shard, rank) as bench.py:931-938 merges it:
    (global ids, scores, total). `query` is ("match", terms),
    ("conj", must terms, filter term) or ("should", match terms, term)."""
    import numpy as np

    from elasticsearch_tpu_torch.ops import bm25

    merged, total = [], 0
    for s, seg in enumerate(shards):
        fld, n = seg.fields["body"], seg.num_docs
        matched = np.zeros(n, dtype=bool)
        scores = bm25.score_terms_dense(fld, query[1], n, matched=matched)
        if query[0] == "conj":
            has_filter = np.zeros(n, dtype=bool)
            has_filter[fld.postings(query[2])[0]] = True
            matched &= has_filter
        elif query[0] == "should":
            m2 = np.zeros(n, dtype=bool)
            s2 = bm25.score_terms_dense(fld, [query[2]], n, matched=m2)
            scores = (np.float32(0.0) + scores) + s2
            matched |= m2
        total += int(matched.sum())
        for rank, d in enumerate(_oracle_topk(scores, matched, k)):
            merged.append((-float(scores[d]), s, rank,
                           s * docs_per_shard + int(d), scores[d]))
    merged.sort(key=lambda t: t[:3])
    page = merged[:k]
    return [t[3] for t in page], [t[4] for t in page], total


def run_stacked(card, dev, shards, bodies, match_terms, launches, rows) -> dict:
    """BASELINE config 3 the way the JAX bench serves it on one device
    (bench.py:931-1168): the 8 shards packed to equal shapes and stacked,
    every query compiled per shard with that shard's own statistics and
    equalized, bucketed with plan_spec_buckets(n_shards=8), run through
    execute_shards_batch (K1s-K4s, the merge on K3b) and held to the
    numpy oracle per shard; the conjunctions also through
    execute_shards_blockmax_conj, held to execute_shards_batch."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.mapping import Mappings
    from elasticsearch_tpu_torch.index.tiles import TILE, pack_segment
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.compile import pad_arrays_to_spec, unify_specs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    n_pad = max(seg.num_docs for seg in shards)
    min_tiles = {"body": max(len(seg.fields["body"].doc_ids) // TILE + 2
                             for seg in shards)}
    with ThreadPoolExecutor(max_workers=4) as pool:  # numpy releases the GIL
        devs = list(pool.map(lambda seg: pack_segment(
            seg, device=dev, pad_docs_to=n_pad, field_min_tiles=min_tiles),
            shards))
    stree = bm25_device.stack_segment_trees(
        [bm25_device.segment_tree(d) for d in devs])
    fields = [(d.fields, d.doc_values) for d in devs]  # the compilers' view
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0

    # The queries: phase 8's 32 conjunctions and 32 matches, plus 16 dense
    # bool(should) (K1s's path).
    fld0 = shards[0].fields["body"]
    by_df = sorted(fld0.terms, key=lambda t: -fld0.df[fld0.terms[t]])
    head, mid = by_df[: len(by_df) // 100], by_df[len(by_df) // 100 : len(by_df) // 4]
    queries = []
    for body in bodies[:N_CFG3]:
        b = body["query"]["bool"]
        queries.append(("conj", b["must"][0]["match"]["body"].split(),
                        b["filter"][0]["term"]["body"]))
    queries += [("match", terms) for terms in match_terms]
    rng = np.random.default_rng(SEED + 5)
    should_bodies = []
    for _ in range(N_STACKED_SHOULD):
        a, b = (str(t) for t in rng.choice(mid, 2, replace=False))
        h = str(rng.choice(head))
        queries.append(("should", [a, b], h))
        should_bodies.append({"query": {"bool": {"should": [
            {"match": {"body": f"{a} {b}"}}, {"term": {"body": h}}]}}})
    all_bodies = list(bodies) + should_bodies
    mappings = Mappings(properties={"body": {"type": "text"}})
    t0 = time.monotonic()
    per_query, buckets = _stacked_buckets(all_bodies, fields, mappings, dev)
    torch.cuda.synchronize()
    plan_s = time.monotonic() - t0

    def run_batch():
        return [bm25_device.execute_shards_batch(stree, spec, plan, TOP_K, n_pad)
                for spec, _p, plan, _h in buckets]

    conj_buckets = [(spec, pos, host) for spec, pos, _a, host in buckets
                    if bm25_device.supports_blockmax_conj(spec)]
    rec = PruneRecorder()
    with counted("stacked", launches):
        outs = [tuple(t.cpu().numpy() for t in out) for out in run_batch()]
        bm_outs = [bm25_device.execute_shards_blockmax_conj(
            stree, spec, host, TOP_K, n_pad, instruments=rec)
            for spec, _pos, host in conj_buckets]

    t0 = time.monotonic()
    mismatches = 0
    results = {}
    for (spec, positions, _a, _h), (s_b, g_b, t_b) in zip(buckets, outs):
        for row, p in enumerate(positions):
            results[p] = (s_b, g_b, t_b, row)
            ids, scores, total = stacked_oracle(shards, queries[p], TOP_K, n_pad)
            n = len(ids)
            ok = (list(g_b[row][:n]) == ids
                  and np.array_equal(score_bits(s_b[row][:n]), score_bits(scores))
                  and bool(np.all(s_b[row][n:] == -np.inf))
                  and int(t_b[row]) == total)
            if not ok:
                mismatches += 1
                log(f"  MISMATCH stacked {queries[p]}")
    oracle_s = time.monotonic() - t0
    # Block-max against execute_shards_batch on the same plans.
    relations = {"eq": 0, "gte": 0}
    bm_mismatches = 0
    for (spec, positions, _h), (s, g, t, rel) in zip(conj_buckets, bm_outs):
        relations[rel] += len(positions)
        for row, p in enumerate(positions):
            s_b, g_b, t_b, r = results[p]
            n = min(TOP_K, int(t_b[r]))
            if not (np.array_equal(score_bits(s[row]), score_bits(s_b[r]))
                    and np.array_equal(g[row][:n], g_b[r][:n])
                    and int(t[row]) <= int(t_b[r])
                    and (rel == "gte" or int(t[row]) == int(t_b[r]))):
                bm_mismatches += 1
                log(f"  MISMATCH stacked blockmax {queries[p]}")
    # The stacked filter cache (kernel-table row 8b's second half).
    fc = _stacked_filter_cache(stree, per_query, all_bodies, results, n_pad,
                               dev, launches)
    log(f"  stacked filter-cache: {json.dumps(fc)} [{card}]")
    kernel_row_matched_only_stacked(stree, fields, mappings, all_bodies[0],
                                    n_pad, dev, rows)

    # Device time by CUDA events: the batched calls over every bucket, and
    # one query at a time at its own equalized spec.
    n_q = len(all_bodies)
    batch_ms = cuda_ms(run_batch, reps=5) / n_q
    singles = [bm25_device.plan_to_torch(c.spec, c.arrays, dev) for c in per_query]
    one_ms = cuda_ms(lambda: [
        bm25_device.execute_shards(stree, c.spec, plan, TOP_K, n_pad)
        for c, plan in zip(per_query, singles)], reps=3) / n_q
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for spec, _pos, host in conj_buckets:
        bm25_device.execute_shards_blockmax_conj(stree, spec, host, TOP_K, n_pad)
    n_conj = sum(len(pos) for _s, pos, _h in conj_buckets)
    bm_ms = (time.perf_counter() - t1) * 1e3 / max(1, n_conj)
    t1 = time.perf_counter()
    for spec, pos, host in conj_buckets:
        out = bm25_device.execute_shards_batch(
            stree, spec, bm25_device.plan_to_torch(
                spec, bm25_device.stack_plans(host), dev), TOP_K, n_pad)
        [t.cpu() for t in out]
    exact_ms = (time.perf_counter() - t1) * 1e3 / max(1, n_conj)

    lead, lead_buckets = run_stacked_lead(card, shards, stree, fields,
                                          mappings, n_pad, dev, launches)
    rows.extend(kernel_rows_stacked(stree, buckets + lead_buckets, dev))
    # Phase `sequential`: phase 8's 32 conjunctions as one strict chain
    # over the stacked shards.
    conj = list(range(N_CFG3))
    c_spec = unify_specs([per_query[p].spec for p in conj])
    c_plan = bm25_device.plan_to_torch(c_spec, bm25_device.stack_plans([
        pad_arrays_to_spec(per_query[p].spec, c_spec, per_query[p].arrays)
        for p in conj]), dev)
    chain, _out = run_chain(
        card, "cfg3 stacked bool(must + filter) (execute_shards_sequential)",
        lambda: bm25_device.execute_shards_sequential(stree, c_spec, c_plan,
                                                      TOP_K, n_pad),
        lambda: bm25_device.execute_shards_batch(stree, c_spec, c_plan, TOP_K,
                                                 n_pad),
        lambda r: bm25_device.execute_shards_batch(
            stree, c_spec, bm25_device._row_of(c_plan, r), TOP_K, n_pad),
        len(conj), launches)
    del _out, c_plan
    summary = {
        "shards": N_SHARDS, "docs_per_shard_padded": n_pad,
        "sequential_chain": chain,
        "queries": n_q, "buckets": [[sp[0], len(pos)] for sp, pos, _a, _h in buckets],
        "pack_stack_s": pack_s, "compile_s": plan_s, "oracle_check_s": oracle_s,
        "mismatches": mismatches, "blockmax_conj_queries": n_conj,
        "filter_cache": fc, "lead": lead,
        "blockmax_relations": relations, "blockmax_mismatches": bm_mismatches,
        "pruned_tile_fraction_mean": float(np.mean(rec.fractions)) if rec.fractions else 0.0,
        "device_ms_per_query_batched": batch_ms,
        "device_ms_per_query_q1": one_ms,
        "blockmax_conj_ms_per_query": bm_ms,
        "shards_batch_ms_per_query_conj": exact_ms,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
    }
    bad = mismatches + bm_mismatches + fc["mismatches"]
    log(f"phase stacked: {'ok' if bad == 0 else 'FAILED'} "
        f"{json.dumps(summary)} [{card}]")
    if bad:
        raise SmokeFailure(f"{mismatches} stacked, {bm_mismatches} stacked "
                           f"block-max and {fc['mismatches']} stacked "
                           f"filter-cache mismatches")
    if not fc["masked_queries"]:
        raise SmokeFailure("no stacked conjunction read a filter-cache plane")
    if not conj_buckets:
        raise SmokeFailure("no stacked conjunction was eligible for block-max")
    del stree, buckets, singles, fields, devs
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def _stacked_buckets(bodies, fields, mappings, dev):
    """Each body compiled per shard with that shard's own statistics and
    equalized, then bucketed with plan_spec_buckets(n_shards=8) as the JAX
    bench buckets them: (the per-query plans, the buckets (spec, positions,
    device plan [Qb, S, ...], host rows))."""
    from elasticsearch_tpu_torch.exec.batcher import plan_spec_buckets
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.compile import (
        CompiledQuery,
        Compiler,
        equalize_compiled,
        pad_arrays_to_spec,
        unify_specs,
    )
    from elasticsearch_tpu_torch.query.dsl import parse_query

    per_query = []
    for body in bodies:
        q = parse_query(body["query"])
        cs = equalize_compiled([Compiler(f, dv, mappings).compile(q)
                                for f, dv in fields])
        per_query.append(CompiledQuery(
            spec=cs[0].spec, arrays=bm25_device.stack_plans([c.arrays for c in cs])))
    by_spec: dict[tuple, list[int]] = {}
    for pos, c in enumerate(per_query):
        by_spec.setdefault(c.spec, []).append(pos)
    buckets = []
    for bucket_specs in plan_spec_buckets(list(by_spec.items()), n_shards=N_SHARDS):
        positions = [p for sp in bucket_specs for p in by_spec[sp]]
        target = unify_specs(list(bucket_specs))
        host_rows = [pad_arrays_to_spec(per_query[p].spec, target, per_query[p].arrays)
                     for p in positions]
        buckets.append((target, positions, bm25_device.plan_to_torch(
            target, bm25_device.stack_plans(host_rows), dev), host_rows))
    return per_query, buckets


def run_stacked_lead(card, shards, stree, fields, mappings, n_pad, dev,
                     launches):
    """Filter-led conjunctions on the stacked shards: cfg3's shape (a
    two-term must and a term filter) with a filter rarer than the must's
    terms in every shard, so the lead path runs (K4s's fold mode), through
    execute_shards_batch and held to the numpy oracle per shard. Returns
    (summary, the lead buckets)."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device

    fld0 = shards[0].fields["body"]
    by_df = sorted(fld0.terms, key=lambda t: -fld0.df[fld0.terms[t]])
    everywhere = set.intersection(*(set(seg.fields["body"].terms)
                                    for seg in shards))
    mid = by_df[len(by_df) // 100 : len(by_df) // 4]
    rare = [t for t in by_df[len(by_df) // 4 : len(by_df) // 2] if t in everywhere]
    rng = np.random.default_rng(SEED + 6)
    queries, bodies = [], []
    for _ in range(N_STACKED_LEAD):
        m1, m2 = (str(t) for t in rng.choice(mid, 2, replace=False))
        f = str(rng.choice(rare))
        queries.append(("conj", [m1, m2], f))
        bodies.append({"query": {"bool": {
            "must": [{"match": {"body": f"{m1} {m2}"}}],
            "filter": [{"term": {"body": f}}]}}})
    _per_query, buckets = _stacked_buckets(bodies, fields, mappings, dev)
    lead_buckets = [b for b in buckets if b[0][0] == "bool" and b[0][6] >= 0]
    n_lead = sum(len(b[1]) for b in lead_buckets)
    with counted("stacked lead", launches):
        outs = [tuple(t.cpu().numpy() for t in bm25_device.execute_shards_batch(
            stree, spec, plan, TOP_K, n_pad)) for spec, _p, plan, _h in buckets]
    mismatches = 0
    for (_spec, positions, _a, _h), (s_b, g_b, t_b) in zip(buckets, outs):
        for row, p in enumerate(positions):
            ids, scores, total = stacked_oracle(shards, queries[p], TOP_K, n_pad)
            n = len(ids)
            if not (list(g_b[row][:n]) == ids
                    and np.array_equal(score_bits(s_b[row][:n]), score_bits(scores))
                    and bool(np.all(s_b[row][n:] == -np.inf))
                    and int(t_b[row]) == total):
                mismatches += 1
                log(f"  MISMATCH stacked lead {queries[p]}")
    summary = {"queries": len(bodies), "led_by_the_filter": n_lead,
               "buckets": [[b[0][6], len(b[1])] for b in buckets],
               "mismatches": mismatches}
    log(f"phase stacked lead: {'ok' if mismatches == 0 else 'FAILED'} "
        f"{json.dumps(summary)} [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} stacked filter-led mismatches")
    if not n_lead:
        raise SmokeFailure("no stacked conjunction took the lead path")
    torch.cuda.synchronize()
    return summary, lead_buckets


def _stacked_filter_cache(stree, per_query, bodies, results, n_pad, dev,
                          launches) -> dict:
    """Phase stacked's filter cache: each conjunction's filter as an [S, N]
    plane (compute_filter_mask_stacked, K1s matched-only, built once per
    distinct filter), substituted into its [S, ...] plan and run through
    execute_shards (the plane gathered at each row's candidates, row r
    reading shard r % S) and execute_shards_blockmax_conj (phase A's
    filter check reads it too), each held bit for bit to the unmasked
    batch's answer (`results`)."""
    import numpy as np

    from elasticsearch_tpu_torch.index.filter_cache import (
        FilterCache,
        apply_cached_masks,
        record_filter_usage,
    )
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query

    cache = FilterCache(min_freq=1)

    def build(cs, ca, _norm):
        plane = bm25_device.compute_filter_mask_stacked(
            stree, cs, bm25_device.plan_to_torch(cs, ca, dev)).clone()
        return plane, plane.numel()

    def fill():
        return {"boost": np.zeros(N_SHARDS, dtype=np.float32)}

    bad = masked = blockmax = 0
    with counted("stacked filter-cache", launches):
        for p in range(N_CFG3):
            q = parse_query(bodies[p]["query"])
            mc, masks, _reused = apply_cached_masks(
                cache, ("stacked", 0, 0), q, per_query[p], build,
                const_fill=fill, entries=record_filter_usage(cache, q))
            if not masks:
                continue  # a filter-led conjunction keeps its lead filter
            masked += 1
            seg_m = {**stree, "masks": masks}
            s, g, t = (x.cpu().numpy() for x in bm25_device.execute_shards(
                seg_m, mc.spec, bm25_device.plan_to_torch(
                    mc.spec, mc.arrays, dev), TOP_K, n_pad))
            s_b, g_b, t_b, r = results[p]
            n = min(TOP_K, int(t_b[r]))
            ok = (int(t) == int(t_b[r])
                  and np.array_equal(g[:n], g_b[r][:n])
                  and np.array_equal(score_bits(s[:n]), score_bits(s_b[r][:n])))
            if ok and bm25_device.supports_blockmax_conj(mc.spec):
                blockmax += 1
                s2, g2, t2, _rel = bm25_device.execute_shards_blockmax_conj(
                    seg_m, mc.spec, [mc.arrays], TOP_K, n_pad)
                ok = (np.array_equal(g2[0][:n], g_b[r][:n])
                      and np.array_equal(score_bits(s2[0][:n]),
                                         score_bits(s_b[r][:n]))
                      and int(t2[0]) <= int(t_b[r]))
            if not ok:
                bad += 1
                log(f"  MISMATCH stacked filter-cache {bodies[p]}")
    return {"masked_queries": masked, "blockmax_masked": blockmax,
            "mismatches": bad, "cache": cache.stats()}


def kernel_row_matched_only_stacked(stree, fields, mappings, body, n_pad, dev,
                                    rows):
    """K1s's matched-only mode (compute_filter_mask_stacked, kernel-table
    row 8b's second half) on cfg3's stacked tree: the first conjunction's
    head-term filter compiled per shard and equalized, S = 8 rows, held
    bit for bit to terms_scatter_batch_plain(matched_only=True)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.compile import Compiler, equalize_compiled
    from elasticsearch_tpu_torch.query.dsl import parse_query

    filt = body["query"]["bool"]["filter"][0]
    q = parse_query({"bool": {"filter": [filt]}})
    cs = equalize_compiled([Compiler(f, dv, mappings).compile(q)
                            for f, dv in fields])
    spec = cs[0].spec[3][0]
    if spec[0] != "terms_const":
        raise SmokeFailure(f"stacked filter compiled to {spec[0]}")
    a = bm25_device.plan_to_torch(spec, bm25_device.stack_plans(
        [c.arrays["children"][0] for c in cs]), dev)
    args, flat, n_valid, n_real = _matched_only_args(
        stree, spec, a, n_pad, stacked=True)
    n_rows = a["tile_ids"].shape[0]
    _row(rows, "terms_scatter_stacked_matched_only",
         "elasticsearch_tpu/ops/bm25_device.py:1812", n_rows,
         lambda: kern.terms_scatter_stacked(*args, matched_only=True),
         lambda: kern.terms_scatter_batch_plain(*args, matched_only=True),
         lambda: torch.zeros(n_rows * (n_pad + 1), dtype=torch.bool,
                             device=dev).index_fill_(0, flat, True),
         "torch.zeros(S * (N + 1), dtype=bool).index_fill_ over the gathered "
         "postings",
         n_valid * 4 + n_real * 12 + n_rows * (n_pad + 1),
         source=SOURCES["terms_scatter"], device=True,
         case=f"compute_filter_mask_stacked of {json.dumps(filt)} over S = {n_rows} "
              f"stacked shards of {n_pad:,} docs, {n_valid:,} postings")


def run_routed(node, fld0, card, launches) -> int:
    """500 documents through `_bulk` into an 8-shard index, half on auto
    ids: `_shards` counts and hits against the oracle over every doc; then
    a search_after walk sorted on a numeric field (distinct values) over
    the 8 shards, each page against the oracle's order."""
    import numpy as np

    from elasticsearch_tpu_torch.parallel.routing import shard_for_id
    from elasticsearch_tpu_torch.utils.corpus import zipf_probs

    rng = np.random.default_rng(SEED + 4)
    vocab = sorted(fld0.terms, key=lambda t: -fld0.df[fld0.terms[t]])[:400]
    probs = zipf_probs(len(vocab))
    docs = [" ".join(rng.choice(vocab, int(rng.integers(4, 30)), p=probs))
            for _ in range(500)]
    price = (rng.permutation(500) * 0.25 + 0.125).astype(np.float32)
    lines = []
    for i, text in enumerate(docs):
        meta = {"_id": f"r{i}"} if i % 2 == 0 else {}
        lines += [json.dumps({"index": meta}),
                  json.dumps({"body": text, "price": float(price[i])})]
    server, base = serve(node)
    bad = 0
    try:
        http(base, "PUT", "/routed", {
            "settings": {"index": {"number_of_shards": N_SHARDS}},
            "mappings": {"properties": {"body": {"type": "text"},
                                        "price": {"type": "float"}}},
        })
        out = http(base, "POST", "/routed/_bulk", raw="\n".join(lines) + "\n")
        refreshed = http(base, "POST", "/routed/_refresh")
        items = [it["index"] for it in out["items"]]
        bad += out["errors"] or any(
            it["_shards"] != {"total": 1, "successful": 1, "failed": 0}
            or it["status"] != 201 for it in items
        )
        bad += refreshed != {"_shards": {"total": 8, "successful": 8, "failed": 0}}
        svc = node.indices["routed"]
        for it in items:  # every doc on its murmur3 shard
            bad += it["_id"] not in svc.engines[shard_for_id(it["_id"], N_SHARDS)]._live_ids
        if any(len(e.segments) != 1 for e in svc.engines):
            raise SmokeFailure("a routed shard does not hold exactly one segment")
        shards = [e.segments[0].segment for e in svc.engines]
        stats = svc.search.global_stats()["body"]
        queries = [[str(t) for t in rng.choice(vocab[:200], 3, replace=False)]
                   for _ in range(16)]
        with counted("routed", launches):
            outs = [http(base, "POST", "/routed/_search",
                         {"query": {"match": {"body": " ".join(q)}}, "size": TOP_K})
                    for q in queries]
        for q, res in zip(queries, outs):
            ids, scores, total = shard_oracle(shards, q, stats, TOP_K)
            if not same_hits(res, ids, scores, total) or res["_shards"] != {
                "total": 8, "successful": 8, "skipped": 0, "failed": 0,
            }:
                bad += 1
                log(f"  MISMATCH routed {q}")
        # The walk: price desc over every doc, five pages of 10.
        order = np.argsort(-price, kind="stable")
        want = [(items[int(j)]["_id"], [float(price[j])]) for j in order]
        after, pages = None, []
        with counted("routed sorted", launches):
            for _p in range(WALK_PAGES):
                body = {"query": {"match_all": {}}, "sort": [{"price": "desc"}],
                        "size": TOP_K}
                if after is not None:
                    body["search_after"] = after
                page = http(base, "POST", "/routed/_search", body)["hits"]["hits"]
                pages.append([(h["_id"], h["sort"]) for h in page])
                after = page[-1]["sort"]
        for p, page in enumerate(pages):
            if page != want[p * TOP_K:(p + 1) * TOP_K]:
                bad += 1
                log(f"  MISMATCH routed search_after page {p}")
    finally:
        server.shutdown()
        server.server_close()
    auto = sum(1 for it in items if it["_id"].startswith("_auto_"))
    per_shard = [e.num_docs for e in node.indices["routed"].engines]
    log(f"phase routed: {'ok' if bad == 0 else 'FAILED'} {bad} mismatches; "
        f"500 docs ({auto} auto ids), per shard {per_shard}, 16 queries, a "
        f"{WALK_PAGES}-page search_after walk [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} routed-index mismatches")
    return bad


# ---------------------------------------------------------------------------
# kNN (BASELINE config 5)
# ---------------------------------------------------------------------------

N_VECTORS = 1_000_000  # BASELINE config 5: GloVe-100d, 1M vectors
VEC_DIMS = 100
N_KNN_QUERIES = 16
N_KNN_FILTERED = 8
CFG5_SCRIPT = "cosineSimilarity(params.qv, 'vec') + 1.0"
KNN_KERNELS = (
    "vector_score_batch", "vector_score_gather_batch", "vector_script_batch",
    "masked_topk_ids_batch",
)


@contextlib.contextmanager
def plain_knn_kernels():
    """plain_kernels() plus the plain versions of K6, K7 and K3i: the
    reference runs of the knn phase's checks."""
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.ops import script_kernel

    swaps = [(kern, n) for n in KNN_KERNELS] + [(script_kernel, "script_eval")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in swaps]
    try:
        for mod, n in swaps:
            setattr(mod, n, getattr(mod, n + "_plain"))
        with plain_kernels():
            yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def ulp_close(a, b, ulps: int) -> bool:
    """bench.py's ulp_close: |a - b| <= ulps * spacing(max(|a|, |b|))."""
    import numpy as np

    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return False
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return bool(np.all(np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol))


def ranked_match(dev_ids, dev_scores, o_ids, o_scores, ulps: int) -> bool:
    """bench.py's ranked_match (a copy): the same doc set, scores within
    `ulps` at every rank, and a doc at another rank only where its oracle
    score is within `ulps` of the oracle's at that rank."""
    import numpy as np

    n = len(o_ids)
    dev_ids = [int(x) for x in dev_ids[:n]]
    if sorted(dev_ids) != sorted(int(x) for x in o_ids):
        return False
    if not ulp_close(dev_scores[:n], o_scores, ulps=ulps):
        return False
    by_id = {int(i): np.float32(s) for i, s in zip(o_ids, o_scores)}
    for rank, did in enumerate(dev_ids):
        if did != int(o_ids[rank]) and not ulp_close(
            by_id[did], np.float32(o_scores[rank]), ulps=ulps
        ):
            return False
    return True


def _hit_ids(out) -> list[int]:
    return [int(h["_id"][1:]) for h in out["hits"]["hits"]]


def _same_knn(out, scores, ids, total) -> bool:
    """A REST answer against a plain run: the finite-score prefix of
    (scores, ids), the total."""
    import numpy as np

    scores, ids = np.asarray(scores), np.asarray(ids)
    n = min(len(out["hits"]["hits"]), int(np.sum(scores > -np.inf)))
    return (
        len(out["hits"]["hits"]) == n
        and _hit_ids(out) == [int(i) for i in ids[:n]]
        and np.array_equal(score_bits([h["_score"] for h in out["hits"]["hits"]]),
                           score_bits(scores[:n]))
        and out["hits"]["total"]["value"] == min(int(total), 10_000)
    )


class BuildTimer:
    """Wall time of the IVF build (index/ann.build_partitions) and of its
    K9 assignment passes (ops/ann_device.assign_all) while installed."""

    def __init__(self):
        from elasticsearch_tpu_torch.index import ann
        from elasticsearch_tpu_torch.ops import ann_device

        self.ann, self.dev = ann, ann_device
        self.build_real, self.assign_real = ann.build_partitions, ann.assign_all
        self.build_s = self.assign_s = 0.0
        self.builds = 0

    def __enter__(self):
        def build(*a, **kw):
            t0 = time.monotonic()
            out = self.build_real(*a, **kw)
            self.build_s += time.monotonic() - t0
            self.builds += 1
            return out

        def assign(*a, **kw):
            t0 = time.monotonic()
            out = self.assign_real(*a, **kw)
            self.assign_s += time.monotonic() - t0
            return out

        self.ann.build_partitions, self.ann.assign_all = build, assign
        return self

    def __exit__(self, *exc):
        self.ann.build_partitions = self.build_real
        self.ann.assign_all = self.assign_real


def run_knn(card, dev, launches, rows) -> dict:
    """BASELINE config 5 on the card: script_score over the vectors, the
    knn section (IVF probe + exact re-rank), filtered knn, _knn_search,
    k = 10,000, concurrent knn, then K7 / K9 / K3i rows."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.segment import Segment
    from elasticsearch_tpu_torch.index.tiles import device_nbytes
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import ann_device, bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.search.service import KnnSpec

    # -- 14. corpus: bench.py:1369-1387's draws ---------------------------
    t0 = time.monotonic()
    rng = np.random.default_rng(31)
    vecs = rng.standard_normal((N_VECTORS, VEC_DIMS), dtype=np.float32)
    qvs = rng.standard_normal((N_KNN_QUERIES, VEC_DIMS), dtype=np.float32)
    pop = np.random.default_rng(32).random(N_VECTORS)
    segment = Segment(
        num_docs=N_VECTORS, fields={}, doc_values={"pop": pop},
        vectors={"vec": vecs}, sources=[{}] * N_VECTORS,
        ids=[f"d{i}" for i in range(N_VECTORS)],
    )
    gen_s = time.monotonic() - t0
    # No exec planner: every knn of a segment with IVF planes serves
    # ann_ivf, so each answer has one plain run to equal.
    node = Node(device=DEVICE, exec_planner=False)
    node.create_index("glove", {"mappings": {"properties": {
        "vec": {"type": "dense_vector", "dims": VEC_DIMS,
                "similarity": "cosine"},
        "pop": {"type": "float"}}}})
    svc = node.indices["glove"]
    t1 = time.monotonic()
    handle = svc.engine._install_segment(segment)
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t1
    vec_dev = handle.device.vectors["vec"]
    live = handle.device.live
    seg_tree = bm25_device.segment_tree(handle.device)
    compiler = svc.engine.compiler_for(handle)
    log(f"phase knn corpus: ok {N_VECTORS} x {VEC_DIMS} vectors; generate "
        f"{gen_s:.1f} s, install {pack_s:.1f} s, device bytes "
        f"{device_nbytes(handle.device)} [{card}]")

    def script_body(source, q):
        return {"query": {"script_score": {"query": {"match_all": {}},
                "script": {"source": source, "params": {"qv": q.tolist()}}}},
                "size": TOP_K, "_source": False}

    def knn_body(q, k=TOP_K, num_candidates=100, **extra):
        knn = {"field": "vec", "query_vector": q.tolist(), "k": k,
               "num_candidates": num_candidates, **extra}
        return {"knn": knn, "_source": False,
                "size": max(TOP_K, k) if k > TOP_K else TOP_K}

    scripts = [(CFG5_SCRIPT, q) for q in qvs]
    scripts += [("dotProduct(params.qv, 'vec')", qvs[0]),
                ("1 / (1 + l2norm(params.qv, 'vec'))", qvs[1])]
    script_bodies = [script_body(src, q) for src, q in scripts]
    # Fault C4's shape: vector functions inside function_score scripts
    # (K7's script planes read by K14 as node inputs).
    c4_bodies = [
        {"query": {"function_score": {
            "query": {"range": {"pop": {"lt": 0.7}}},
            "functions": [
                {"script_score": {"script": {
                    "source": "cosineSimilarity(params.qv, 'vec') + 1.0",
                    "params": {"qv": qvs[3].tolist()}}}},
                {"filter": {"range": {"pop": {"lt": 0.2}}}, "weight": 2}],
            "score_mode": "sum"}}, "size": TOP_K, "_source": False},
        {"query": {"function_score": {
            "query": {"match_all": {}},
            "functions": [{"script_score": {"script": {
                "source": "dotProduct(params.qv, 'vec') * params.w"
                          " - l2norm(params.qv, 'vec')",
                "params": {"qv": qvs[4].tolist(), "w": 0.5}}}}],
            "boost_mode": "replace"}}, "size": TOP_K, "_source": False},
    ]
    knn_bodies = [knn_body(q) for q in qvs]
    filtered = [knn_body(q, filter={"range": {"pop": {"lt": 0.5}}})
                for q in qvs[:N_KNN_FILTERED]]
    big = knn_body(qvs[2], k=10_000, num_candidates=10_000)

    server, base = serve(node)
    try:
        # Warm-up (untimed): the first script request (K6's Triton build)
        # and the first knn request (the IVF build), each timed alone.
        t0 = time.monotonic()
        http(base, "POST", "/glove/_search", script_bodies[0])
        first_script_ms = (time.monotonic() - t0) * 1e3
        with counted("knn", launches), BuildTimer() as bt:
            t0 = time.monotonic()
            first_knn = http(base, "POST", "/glove/_search", knn_bodies[0])
            first_knn_ms = (time.monotonic() - t0) * 1e3
            s_lat, s_resp, s_wall = sequential(base, "glove", script_bodies)
            _c4_lat, c4_resp, _c4_wall = sequential(base, "glove", c4_bodies)
            k_lat, k_resp, k_wall = sequential(base, "glove", knn_bodies)
            f_lat, f_resp, _f_wall = sequential(base, "glove", filtered)
            knn_search = http(base, "POST", "/glove/_knn_search", {
                "knn": {k: v for k, v in filtered[0]["knn"].items()
                        if k != "filter"},
                "filter": filtered[0]["knn"]["filter"], "_source": False})
            t0 = time.monotonic()
            big_out = http(base, "POST", "/glove/_search", big)
            big_ms = (time.monotonic() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
    if bt.builds != 1:
        raise SmokeFailure(f"expected one IVF build, saw {bt.builds}")
    parts = next(iter(node.ann_cache._entries.values()))
    _p, plan_nprobe, _m, _pc, _b = svc.search._knn_plan(
        handle, KnnSpec.from_json(knn_bodies[0]["knn"]))
    build = {
        "build_s": bt.build_s, "assign_k9_s": bt.assign_s,
        "first_knn_request_ms": first_knn_ms,
        "first_script_request_ms": first_script_ms,
        "partitions": parts.n_partitions, "clusters": parts.n_clusters,
        "pmax": parts.pmax, "plane_bytes": parts.nbytes,
    }
    log(f"phase knn: ok {len(script_bodies)} script_score, "
        f"{len(c4_bodies)} function_score with vector scripts, "
        f"{len(knn_bodies) + 1} knn, {len(filtered)} filtered knn, one "
        f"_knn_search and one k = 10,000 knn over HTTP; build "
        f"{json.dumps(build)} [{card}]")

    # -- 15. checks ----------------------------------------------------------
    mismatches = 0
    t0 = time.monotonic()
    vnorm = np.sqrt(np.einsum("ij,ij->i", vecs, vecs, dtype=np.float32))
    with plain_knn_kernels():
        for (source, q), body, out in zip(scripts, script_bodies, s_resp):
            c = compiler.compile(parse_query(body["query"]))
            s, i, t = bm25_device.execute(
                seg_tree, c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev),
                TOP_K)
            if not _same_knn(out, s.cpu().numpy(), i.cpu().numpy(), int(t)):
                mismatches += 1
                log(f"  MISMATCH script (plain path) {source}")
            # bench.py:1418-1434's numpy oracle, by ranked_match's 64 ulps.
            if source == CFG5_SCRIPT:
                qn = np.float32(np.sqrt(np.sum(q * q)))
                denom = vnorm * qn
                sims = np.where(denom > 0, (vecs @ q) / denom, np.float32(0.0)
                                ).astype(np.float32) + np.float32(1.0)
            elif source.startswith("dot"):
                sims = (vecs @ q).astype(np.float32)
            else:
                dist = np.sqrt(np.einsum("ij,ij->i", vecs - q, vecs - q,
                                         dtype=np.float32))
                sims = (np.float32(1) / (np.float32(1) + dist)).astype(np.float32)
            part = np.argpartition(-sims, TOP_K)[: TOP_K * 4]
            order = part[np.lexsort((part, -sims[part]))][:TOP_K]
            if not ranked_match(_hit_ids(out), [h["_score"] for h in out["hits"]["hits"]],
                                order, sims[order], ulps=64):
                mismatches += 1
                log(f"  MISMATCH script (numpy oracle) {source}")

        for body, out in zip(c4_bodies, c4_resp):
            c = compiler.compile(parse_query(body["query"]))
            s, i, t = bm25_device.execute(
                seg_tree, c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev),
                TOP_K)
            if not _same_knn(out, s.cpu().numpy(), i.cpu().numpy(), int(t)):
                mismatches += 1
                log("  MISMATCH function_score vector script (plain path) "
                    f"{body['query']['function_score']['functions'][0]}")

        def plain_ivf(body):
            knn = KnnSpec.from_json(body["knn"])
            _p, nprobe, metric, _pc, backend = svc.search._knn_plan(handle, knn)
            if backend != "ann_ivf":
                raise SmokeFailure(f"knn served by {backend}, not ann_ivf")
            fmask = None
            if knn.filter is not None:
                fmask = svc.search._knn_filter_mask(
                    handle, seg_tree, knn.filter, svc.engine.field_stats())
            return ann_device.ann_ivf_search(
                parts.tree(), live, knn.query_vector, knn.k, nprobe, metric,
                filter_mask=fmask)

        for body, out in zip(knn_bodies + filtered + [big],
                             k_resp + f_resp + [big_out]):
            s, i, t, _c = plain_ivf(body)
            if not _same_knn(out, s.cpu().numpy(), i.cpu().numpy(), int(t)):
                mismatches += 1
                log(f"  MISMATCH knn (plain ann_ivf_search) k={body['knn']['k']}")
        if without_took(knn_search) != without_took(f_resp[0]):
            mismatches += 1
            log("  MISMATCH _knn_search against its _search form")
        if without_took(first_knn) != without_took(k_resp[0]):
            mismatches += 1
            log("  MISMATCH the first knn request (with the build) against its repeat")
    # Each hit's score equals K7's exact_scores; a full probe gives
    # knn_exact's ids and bits; recall@10 at the default nprobe.
    recalls, fractions = [], []
    full_probe_bad = 0
    for j, q in enumerate(qvs):
        exact = ann_device.exact_scores(vec_dev, q, "cosine")
        ids = torch.tensor(_hit_ids(k_resp[j]), dtype=torch.int64, device=dev)
        got = score_bits([h["_score"] for h in k_resp[j]["hits"]["hits"]])
        if not np.array_equal(got, score_bits(exact[ids].cpu().numpy())):
            mismatches += 1
            log(f"  MISMATCH knn hit scores against exact_scores, query {j}")
        ex_s, ex_i, ex_t = ann_device.knn_exact(
            vec_dev, live, q, TOP_K, "cosine",
            has_vec=handle.device.has_vector["vec"])
        fs, fi, ft, _fc = ann_device.ann_ivf_search(
            parts.tree(), live, q, TOP_K, parts.n_partitions, "cosine")
        if not (torch.equal(fi, ex_i) and torch.equal(fs.view(torch.int32),
                                                      ex_s.view(torch.int32))
                and int(ft) == int(ex_t)):
            full_probe_bad += 1
            log(f"  MISMATCH full probe against knn_exact, query {j}")
        _s, _i, _t, n_cand = ann_device.ann_ivf_search(
            parts.tree(), live, q, TOP_K, plan_nprobe, "cosine")
        recalls.append(len(set(_hit_ids(k_resp[j])) & set(ex_i.tolist())) / TOP_K)
        fractions.append(int(n_cand) / N_VECTORS)
    mismatches += full_probe_bad
    check_s = time.monotonic() - t0
    knn_checks = {
        "mismatches": mismatches,
        "recall_at_10_default_nprobe_mean": float(np.mean(recalls)),
        "recall_at_10_default_nprobe_min": float(np.min(recalls)),
        "candidate_fraction_mean": float(np.mean(fractions)),
        "default_nprobe": plan_nprobe,
        "filtered_hits_pop_below_half": all(
            pop[i] < 0.5 for out in f_resp for i in _hit_ids(out)),
        "k10000_hits": len(big_out["hits"]["hits"]),
        "check_s": check_s,
    }
    log(f"phase knn check: {'ok' if mismatches == 0 else 'FAILED'} "
        f"{json.dumps(knn_checks)} [{card}]")
    if mismatches or not knn_checks["filtered_hits_pop_below_half"]:
        raise SmokeFailure(f"{mismatches} knn mismatches")
    if knn_checks["k10000_hits"] != 10_000:
        raise SmokeFailure("the k = 10,000 knn returned "
                           f"{knn_checks['k10000_hits']} hits")

    # -- 16. concurrent knn ------------------------------------------------
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()
    server, base = serve(node)
    order = np.random.default_rng(SEED + 5).permutation(
        np.tile(np.arange(len(knn_bodies)), 4))
    conc_bodies = [knn_bodies[int(j)] for j in order]
    try:
        with counted("knn concurrent", launches):
            c_lat, c_resp, c_wall = concurrent(base, "glove", conc_bodies, N_CLIENTS)
    finally:
        server.shutdown()
        server.server_close()
    bad = sum(without_took(c_resp[n]) != without_took(k_resp[int(j)])
              for n, j in enumerate(order))
    conc = {
        "requests": len(conc_bodies), "qps": len(conc_bodies) / c_wall,
        "p50_ms": percentile(c_lat, 50), "p99_ms": percentile(c_lat, 99),
        "mismatches_vs_sequential": bad, "batcher": node.exec_batcher.stats(),
    }
    log(f"phase knn concurrent: {'ok' if bad == 0 else 'FAILED'} "
        f"{json.dumps(conc)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} concurrent knn answers differ from sequential")

    # -- 17. device time per request --------------------------------------
    dev_ms = {"script": [], "knn": []}
    for body in script_bodies[:N_KNN_QUERIES]:
        c = compiler.compile(parse_query(body["query"]))
        plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
        dev_ms["script"].append(cuda_ms(
            lambda: bm25_device.execute(seg_tree, c.spec, plan, TOP_K), 3))
    for q in qvs:
        dev_ms["knn"].append(cuda_ms(lambda: ann_device.ann_ivf_search(
            parts.tree(), live, q, TOP_K, plan_nprobe, "cosine"), 3))
    q_batch = max(2, round(conc["batcher"]["occupancy_mean"]))
    rows.extend(kernel_rows_knn(vec_dev, qvs, parts, plan_nprobe, q_batch, dev))
    # Phase `sequential`: cfg5's script_score bodies as one strict chain.
    s_spec, s_plan = _stacked_plan(compiler, script_bodies[:N_KNN_QUERIES], dev)
    chain, _out = run_chain(
        card, "cfg5 script_score (execute_sequential)",
        lambda: bm25_device.execute_sequential(seg_tree, s_spec, s_plan, TOP_K),
        lambda: bm25_device.execute_batch(seg_tree, s_spec, s_plan, TOP_K),
        lambda r: bm25_device.execute_batch(
            seg_tree, s_spec, bm25_device._row_of(s_plan, r), TOP_K),
        N_KNN_QUERIES, launches)
    del _out, s_plan
    result = {
        "vectors": N_VECTORS, "dims": VEC_DIMS,
        "script_p50_ms": percentile(s_lat[:N_KNN_QUERIES], 50),
        "script_p99_ms": percentile(s_lat[:N_KNN_QUERIES], 99),
        "script_qps_sequential": N_KNN_QUERIES / sum(s_lat[:N_KNN_QUERIES]) * 1e3,
        "script_device_p50_ms": percentile(dev_ms["script"], 50),
        "dot_ms": s_lat[N_KNN_QUERIES], "l2_ms": s_lat[N_KNN_QUERIES + 1],
        "knn_p50_ms": percentile(k_lat, 50), "knn_p99_ms": percentile(k_lat, 99),
        "knn_qps_sequential": len(k_lat) / k_wall,
        "knn_device_p50_ms": percentile(dev_ms["knn"], 50),
        "filtered_knn_p50_ms": percentile(f_lat, 50),
        "k10000_ms": big_ms,
        "build": build, "checks": knn_checks, "concurrent": conc,
        "sequential_chain": chain,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
    }
    log(f"phase results (knn): {json.dumps(result)} [{card}]")
    node.close()
    return result


def _k9_edge_cases(seed: int) -> dict:
    """K9's edge cases (numpy, from `seed`): (centroids, rows) at d = 16,
    at d = 33 (one past a slab), at d = 384 (past 128: the wide kernel's
    staged groups), and at d = 100 with signed zeros,
    subnormals, exact ties (duplicated centroids, rows equal to them),
    a NaN and an inf row."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(n, d):
        return rng.normal(size=(n, d)).astype(np.float32)

    cases = {"d = 16": (normal(1000, 16), normal(8192, 16)),
             "d = 33": (normal(1000, 33), normal(8192, 33)),
             "d = 384, the wide kernel": (normal(1000, 384), normal(2048, 384))}
    cents, rows = normal(1000, 100), normal(8192, 100)
    cents[500:600] = cents[0:100]
    cents[10] = -0.0
    cents[11] = 0.0
    cents[12, ::2] = -0.0
    cents[20:40] = np.float32(1e-40) * normal(20, 100)
    rows[:100] = cents[:100]
    rows[100:200] = 0.0
    rows[150:200] = -0.0
    rows[200:300] = np.float32(3e-39) * normal(100, 100)
    rows[300:310] = np.float32(1e-41)
    rows[310, 5] = np.nan
    rows[311] = np.inf
    cases["signed zeros, subnormals, ties"] = (cents, rows)
    return cases


def kernel_rows_knn(vec_dev, qvs, parts, nprobe, q_batch, dev):
    """K7 (dense at Q = 1 and at the concurrent phase's mean batch, gather
    at the default nprobe, script at cfg5), K9 at [8,192, 100] x [C, 100]
    and its edge cases (_k9_edge_cases), K3i at the IVF merge's shape, and
    the k = 10,000 request's K3b per-partition ranks (k = pmax) and K3i
    merge (k = 10,000), each against its plain version."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    rows = []
    n, d = vec_dev.shape
    vs_src = "elasticsearch_tpu_torch/csrc/vector_score.cu"
    q1 = torch.from_numpy(qvs[:1]).to(dev).contiguous()
    qb = torch.from_numpy(qvs[:q_batch]).to(dev).contiguous()
    _row(rows, "vector_score", "elasticsearch_tpu/ops/ann_device.py:119", 1,
         lambda: kern.vector_score_batch(vec_dev, q1, "cosine"),
         lambda: kern.vector_score_batch_plain(vec_dev, q1, "cosine"),
         lambda: torch.mv(vec_dev, q1[0]), "torch.mv over the plane (the dot only)",
         n * d * 4 + d * 4 + n * 4, source=vs_src, case="dense, Q = 1")
    _row(rows, "vector_score", "elasticsearch_tpu/ops/ann_device.py:162", q_batch,
         lambda: kern.vector_score_batch(vec_dev, qb, "cosine"),
         lambda: kern.vector_score_batch_plain(vec_dev, qb, "cosine"),
         lambda: torch.matmul(qb, vec_dev.T),
         "torch.matmul over the plane (the dots only)",
         n * d * 4 + q_batch * d * 4 + q_batch * n * 4, source=vs_src,
         case=f"dense, Q = {q_batch}", reps=5)
    coarse = kern.vector_score_batch(parts.centroids, q1, "cosine")
    _s, probes, _t = kern.masked_topk_batch(
        coarse, torch.ones_like(coarse, dtype=torch.bool), nprobe)
    kp, pmax = probes.shape[1], parts.pmax
    _row(rows, "vector_score_gather", "elasticsearch_tpu/ops/ann_device.py:189", 1,
         lambda: kern.vector_score_gather_batch(parts.part_vectors, q1, probes, "cosine"),
         lambda: kern.vector_score_gather_batch_plain(parts.part_vectors, q1, probes,
                                                      "cosine"),
         None, None, kp * pmax * d * 4 + kp * 4 + d * 4 + kp * pmax * 4,
         source=vs_src, case=f"gather, nprobe = {kp}, pmax = {pmax}")
    _row(rows, "vector_score_script", "elasticsearch_tpu/script/painless_lite.py:178", 1,
         lambda: kern.vector_script_batch(vec_dev, q1),
         lambda: kern.vector_script_batch_plain(vec_dev, q1),
         lambda: torch.mv(vec_dev, q1[0]), "torch.mv over the plane (the dot only)",
         n * d * 4 + d * 4 + 3 * n * 4 + 4, source=vs_src, case="script, cfg5")
    rows_m = vec_dev[:8192].contiguous()
    cents = parts.centroids[:: max(1, parts.n_partitions // 1000)][:1000].contiguous()
    c = cents.shape[0]
    _row(rows, "ivf_assign", "elasticsearch_tpu/ops/ann_device.py:280", 8192,
         lambda: kern.ivf_assign(cents, rows_m),
         lambda: kern.ivf_assign_plain(cents, rows_m),
         lambda: torch.argmin(
             (rows_m * rows_m).sum(1, keepdim=True) - 2 * (rows_m @ cents.T)
             + (cents * cents).sum(1), dim=1),
         "torch.matmul + argmin", (8192 + c) * d * 4 + 8192 * 4,
         source="elasticsearch_tpu_torch/csrc/ivf_assign.cu",
         case=f"[8192, {d}] x [{c}, {d}]", flops=2 * 8192 * c * d, reps=5)
    # K9's edge cases, each bit-equal to the plain version.
    for case, (cents_np, rows_np) in _k9_edge_cases(SEED + 16).items():
        ec = torch.from_numpy(cents_np).to(dev).contiguous()
        er = torch.from_numpy(rows_np).to(dev).contiguous()
        em, ed = er.shape
        en = ec.shape[0]
        _row(rows, "ivf_assign", "elasticsearch_tpu/ops/ann_device.py:280", em,
             lambda ec=ec, er=er: kern.ivf_assign(ec, er),
             lambda ec=ec, er=er: kern.ivf_assign_plain(ec, er),
             lambda ec=ec, er=er: torch.argmin(
                 (er * er).sum(1, keepdim=True) - 2 * (er @ ec.T)
                 + (ec * ec).sum(1), dim=1),
             "torch.matmul + argmin", (em + en) * ed * 4 + em * 4,
             source="elasticsearch_tpu_torch/csrc/ivf_assign.cu",
             case=f"{case}: [{em}, {ed}] x [{en}, {ed}]",
             flops=2 * em * en * ed, reps=5)
    # K3i at the merge's shape: kp partitions x k survivors of one query.
    g = kern.vector_score_gather_batch(parts.part_vectors, q1, probes, "cosine")
    part_s, part_pos, _pt = kern.masked_topk_batch(
        g.reshape(kp, pmax), torch.ones((kp, pmax), dtype=torch.bool, device=dev),
        TOP_K)
    part_d = torch.gather(parts.part_docs[probes[0].long()], 1, part_pos.long())
    flat_s = part_s.reshape(1, -1).contiguous()
    flat_d = part_d.reshape(1, -1).contiguous()
    ones = torch.ones_like(flat_s, dtype=torch.bool)
    m = flat_s.shape[1]

    def two_sorts():
        o1 = torch.sort(flat_d, dim=1, stable=True).indices
        return torch.sort(-flat_s.gather(1, o1), dim=1, stable=True)

    _row(rows, "masked_topk_ids", "elasticsearch_tpu/ops/ann_device.py:236", 1,
         lambda: kern.masked_topk_ids_batch(flat_s, flat_d, ones, TOP_K),
         lambda: kern.masked_topk_ids_batch_plain(flat_s, flat_d, ones, TOP_K),
         two_sorts, "two stable torch.sorts", m * 9 + TOP_K * 8 + 4,
         source=SOURCES["masked_topk"], case=f"merge of {m} survivors, k = {TOP_K}")
    # Phase knn's k = 10,000 request: each probed partition ranked whole
    # (K3b at k = pmax: the short-row sort), then K3i over the kp x pmax
    # survivors at k = 10,000 (the large-k select), as _ivf_rows runs them.
    cand_d = parts.part_docs[probes[0].long()]
    valid = cand_d < n
    pkey = torch.where(valid, g.reshape(kp, pmax), float("-inf")).contiguous()
    _row(rows, "masked_topk_batch", "elasticsearch_tpu/ops/ann_device.py:232",
         kp, lambda: kern.masked_topk_batch(pkey, valid, pmax),
         lambda: kern.masked_topk_batch_plain(pkey, valid, pmax),
         lambda: torch.topk(pkey, pmax, dim=1), "torch.topk over [Q, M]",
         kp * pmax * 5 + kp * (pmax * 8 + 4), device=True,
         case=f"the per-partition ranks, [{kp}, {pmax}] at k = {pmax} "
              f"({kern.topk_route(pmax, pmax)})")
    ps, ppos, _pt = kern.masked_topk_batch(pkey, valid, pmax)
    big_s = ps.reshape(1, -1).contiguous()
    big_d = torch.gather(cand_d, 1, ppos.long()).reshape(1, -1).contiguous()
    big_ones = torch.ones_like(big_s, dtype=torch.bool)
    mb = big_s.shape[1]
    kb = min(10_000, mb)

    def two_sorts_big():
        o1 = torch.sort(big_d, dim=1, stable=True).indices
        return torch.sort(-big_s.gather(1, o1), dim=1, stable=True)

    _row(rows, "masked_topk_ids", "elasticsearch_tpu/ops/ann_device.py:236", 1,
         lambda: kern.masked_topk_ids_batch(big_s, big_d, big_ones, kb),
         lambda: kern.masked_topk_ids_batch_plain(big_s, big_d, big_ones, kb),
         two_sorts_big, "two stable torch.sorts", mb * 9 + kb * 8 + 4,
         source=SOURCES["masked_topk"], device=True,
         case=f"merge of {mb:,} survivors, k = {kb:,} "
              f"({kern.topk_route(kb, mb)})")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# Kernel rows
# ---------------------------------------------------------------------------


def _same(got, want, name):
    import torch

    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SmokeFailure(f"{name}: shape/dtype differ from the plain version")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise SmokeFailure(f"{name}: differs from the plain version")


def profiled_ms(fn, reps: int = 20):
    """Mean summed device time of fn()'s kernels and copies per call, by
    torch.profiler's CUDA activity (no host time); "not measured" where
    the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
             for evt in prof.key_averages())
    return us / 1e3 / reps if us else "not measured"


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() by CUDA events around `reps` calls queued
    behind a ~50 ms sleep kernel: the card starts them only after the
    host has enqueued them all, so the host's enqueue time drops out (the
    card's own gaps between back-to-back launches stay). No profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _row(rows, name, replaces, q, fn, plain, library, library_call, nbytes,
         reps=20, route="cuda", source=None, case=None, flops=0,
         launches=None, device=False):
    """Hold a kernel to its plain version (exact) and time both, its bound
    (the larger of its bytes over the memory rate and its fp32 `flops`
    over the card's fp32 rate outside the tensor cores) and one library
    call (None where no one PyTorch call computes the same function).
    `launches`: the row's own main-path count where one wrapper serves
    several rows (else the wrapper's total over the main-path phases).
    `device`: also `device_ms`, the profiler's device time of a call, and
    `queued_ms`, the events' time of calls queued behind a sleep kernel,
    beside `ms` (CUDA events over back-to-back calls, which time the
    host where it enqueues slower than the card runs)."""
    import torch

    got, want = fn(), plain()
    torch.cuda.synchronize()
    _same(got, want, name)
    base = name.removesuffix("_batch").removesuffix("_stacked")
    r = {
        "name": name,
        "route": route,
        "source": source or SOURCES[base],
        "replaces": replaces,
        "rows": q,
        "launches": 0 if launches is None else int(launches),
        "mismatches": 0,
        "max_abs_err": 0.0,
        "ms": cuda_ms(fn, reps),
        **({"device_ms": profiled_ms(fn, reps), "queued_ms": queued_ms(fn, reps)}
           if device else {}),
        "plain_ms": cuda_ms(plain, 1, warmup=0),  # `want` warmed it
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3,
        "bound_by": (
            "operations" if flops / FP32_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes"
        ),
        "library_ms": None if library is None else cuda_ms(library, reps),
        "library_call": library_call,
        "bound_bytes": int(nbytes),
    }
    if flops:
        r["bound_flops"] = int(flops)
    if case is not None:
        r["case"] = case
    if launches is not None:
        r["launches_of"] = "this row's calls on the main path"
    log(f"  kernel {json.dumps(r)}")
    rows.append(r)


def _worklist(a, lane):
    """(tile ids as int64, valid [..., NT, 256] mask, real postings)."""
    import torch

    tid = a["tile_ids"].to(torch.int64)
    pos = tid[..., None] * 256 + lane
    valid = (pos >= a["starts"].to(torch.int64)[..., None]) & (
        pos < a["ends"].to(torch.int64)[..., None])
    return tid, valid


def _stacked_plan(compiler, bodies, dev):
    """Compile bodies of one shape, equalize them to one spec as the
    batched query phase does, stack on the host, upload once."""
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.compile import pad_arrays_to_spec, unify_specs
    from elasticsearch_tpu_torch.query.dsl import parse_query

    cs = [compiler.compile(parse_query(b["query"])) for b in bodies]
    spec = unify_specs([c.spec for c in cs])
    arrays = bm25_device.stack_plans(
        [pad_arrays_to_spec(c.spec, spec, c.arrays) for c in cs]
    )
    return spec, bm25_device.plan_to_torch(spec, arrays, dev)


def kernel_rows_single(seg_tree, compiler, bodies, launches, dev, q):
    """K1-K4 at Q = 1 (one-shard sequential shapes, through the batched
    wrappers over one row, as the serving path calls them for one
    request) and K2b/K4b at Q rows (the one-shard concurrent phase's mean
    batch)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    num_docs = seg_tree["live"].shape[0]
    doc_tiles, tn, _tfs, norm_bytes, _present = seg_tree["fields"]["body"]
    live = seg_tree["live"]
    lane = torch.arange(256, device=dev, dtype=torch.int64)
    rows = []

    def plan(body):
        """One request's plan as the batch of one the serving path runs."""
        c = compiler.compile(parse_query(body["query"]))
        return c.spec, bm25_device._rows1(
            bm25_device.plan_to_torch(c.spec, c.arrays, dev))

    def n_real_of(a):
        groups = a["_groups"][0]
        return int(groups[-1][1]) if len(groups) else 0

    # K1: the first child of the first bool(should) query (dense path).
    _spec, sa = plan(bodies[N_MATCH])
    a = sa["children"][0]
    tid, valid = _worklist(a, lane)
    n_real = n_real_of(a)
    args = (doc_tiles, tn, norm_bytes, a["tile_ids"], a["starts"], a["ends"],
            a["weights"], num_docs, a["_groups"])
    w = a["weights"][..., None]
    idx = doc_tiles[tid][valid].to(torch.int64)
    contrib = (w - w / (1.0 + tn[tid]))[valid]
    _row(rows, "terms_scatter", "elasticsearch_tpu/ops/bm25_device.py:436", 1,
         lambda: kern.terms_scatter_batch(*args),
         lambda: kern.terms_scatter_batch_plain(*args),
         lambda: torch.zeros(num_docs + 1, device=dev).index_add_(0, idx, contrib),
         "index_add_",
         # postings read (doc id + impact), worklist read, both planes written
         int(valid.sum()) * 8 + n_real * 16 + (num_docs + 1) * 5)

    # K2 and K3: the first cfg2 match query (sparse path).
    spec, a = plan(bodies[0])
    tid, valid = _worklist(a, lane)
    n_real = n_real_of(a)
    args = (doc_tiles, tn, a["tile_ids"], a["starts"], a["ends"], a["weights"],
            live, num_docs, spec[3])
    docs_s, run_sum, elig = kern.sparse_fold_batch(*args)
    p = docs_s.shape[1]
    cand_keys = torch.where(valid, doc_tiles[tid], num_docs).reshape(-1)
    _row(rows, "sparse_fold", "elasticsearch_tpu/ops/bm25_device.py:977", 1,
         lambda: kern.sparse_fold_batch(*args),
         lambda: kern.sparse_fold_batch_plain(*args),
         lambda: torch.sort(cand_keys, stable=True), "torch.sort(stable=True)",
         # tiles and worklist read; docs_s, run_sum, eligible written
         n_real * 256 * 8 + n_real * 16 + p * 9)
    key = torch.where(elig, run_sum, float("-inf"))
    _row(rows, "masked_topk", "elasticsearch_tpu/ops/bm25_device.py:1031", 1,
         lambda: kern.masked_topk_batch(key, elig, TOP_K),
         lambda: kern.masked_topk_batch_plain(key, elig, TOP_K),
         lambda: torch.topk(key[0], TOP_K), "torch.topk",
         p * 5 + TOP_K * 8 + 4, device=True)
    # The same candidates with fewer eligible entries than k and -NaN keys
    # (below -inf in lax.top_k's order): the select's fill past the
    # eligible docs, held to the plain version.
    few = torch.zeros_like(elig)
    few[0, : min(3, p)] = True
    nan_key = torch.where(few, run_sum, float("-inf"))
    nan_key[0, 3::7] = -float("nan")
    nan_key = nan_key.contiguous()
    _row(rows, "masked_topk", "elasticsearch_tpu/ops/bm25_device.py:1031", 1,
         lambda: kern.masked_topk_batch(nan_key, few, TOP_K),
         lambda: kern.masked_topk_batch_plain(nan_key, few, TOP_K),
         lambda: torch.topk(nan_key[0], TOP_K), "torch.topk",
         p * 5 + TOP_K * 8 + 4, device=True,
         case=f"{int(few.sum())} eligible entries of {p}, k = {TOP_K}, "
              f"-NaN keys at every 7th entry past the third")
    # The rescore's first phase at cfg4's window (k = 1,000, past the
    # select) on the same candidates: the short-row sort or the large-k
    # select by their count (kernels.topk_route).
    kw = min(CFG4_WINDOW, p)
    _row(rows, "masked_topk", "elasticsearch_tpu/ops/bm25_device.py:1031", 1,
         lambda: kern.masked_topk_batch(key, elig, CFG4_WINDOW),
         lambda: kern.masked_topk_batch_plain(key, elig, CFG4_WINDOW),
         lambda: torch.topk(key[0], kw), "torch.topk",
         p * 5 + kw * 8 + 4, device=True,
         case=f"the rescore window: k = {CFG4_WINDOW} over {p:,} candidates "
              f"({kern.topk_route(kw, p)})")

    # K4: a filter-led conjunction's candidates in its first must span.
    lead_bodies = []
    for body in bodies[N_MATCH + N_SHOULD:]:
        spec, la = plan(body)
        if spec[6] >= 0:
            lead_bodies.append(body)
    if not lead_bodies:
        raise SmokeFailure("no filter-led conjunction among the queries")
    spec, la = plan(lead_bodies[0])
    tid, valid = _worklist(la["children"][1 + spec[6]], lane)
    cands = torch.clamp(
        torch.where(valid, doc_tiles[tid], num_docs).reshape(1, -1),
        max=num_docs - 1,
    )
    m = la["children"][0]
    flat = doc_tiles.reshape(-1)
    args = (flat, m["term_starts"], m["term_ends"], 0, cands)
    s0, e0 = int(m["term_starts"][0, 0]), int(m["term_ends"][0, 0])
    span = flat[s0:e0]
    _row(rows, "span_locate", "elasticsearch_tpu/ops/bm25_device.py:949", 1,
         lambda: kern.span_locate_batch(*args),
         lambda: kern.span_locate_batch_plain(*args),
         lambda: torch.searchsorted(span, cands[0]), "torch.searchsorted",
         # candidates and the span read once; pos and found written
         cands.numel() * 9 + (e0 - s0) * 4, device=True)

    # K4's fold mode: the same conjunction's must terms searched and scored
    # in one launch, as _sparse_lead_inner calls it.
    fargs = _fold_args(la["children"][1 + spec[6]], m, doc_tiles, tn, 1,
                       num_docs, lane)
    _row(rows, "span_fold", "elasticsearch_tpu/ops/bm25_device.py:911", 1,
         lambda: kern.span_fold_batch(*fargs),
         lambda: kern.span_fold_batch_plain(*fargs),
         None, "none", _fold_nbytes(*fargs), device=True,
         case=f"cfg2's first filter-led conjunction: T = "
              f"{fargs[2].shape[1]}, P = {fargs[5].shape[1]}")

    # K2b: Q cfg2 match queries, equalized and stacked as a batch is.
    spec, a = _stacked_plan(compiler, bodies[:q], dev)
    tid, valid = _worklist(a, lane)
    n_real = int(valid.any(dim=-1).sum())
    args = (doc_tiles, tn, a["tile_ids"], a["starts"], a["ends"], a["weights"],
            live, num_docs, spec[3])
    docs_s, _run_sum, _elig = kern.sparse_fold_batch(*args)
    p_all = docs_s.numel()
    cand_keys = torch.where(valid, doc_tiles[tid], num_docs).reshape(q, -1)
    _row(rows, "sparse_fold_batch", "elasticsearch_tpu/ops/bm25_device.py:1050", q,
         lambda: kern.sparse_fold_batch(*args),
         lambda: kern.sparse_fold_batch_plain(*args),
         lambda: torch.sort(cand_keys, dim=1, stable=True),
         "torch.sort(stable=True) over [Q, P]",
         n_real * 256 * 8 + n_real * 16 + p_all * 9)

    # K4b: Q filter-led conjunctions' candidates against their first must
    # term's span (each row its own span).
    lead_q = (lead_bodies * q)[:q]
    spec, la = _stacked_plan(compiler, lead_q, dev)
    tid, valid = _worklist(la["children"][1 + spec[6]], lane)
    cands = torch.clamp(
        torch.where(valid, doc_tiles[tid], num_docs).reshape(q, -1),
        max=num_docs - 1,
    )
    m = la["children"][0]
    args = (flat, m["term_starts"], m["term_ends"], 0, cands)
    spans = [flat[int(m["term_starts"][r, 0]):int(m["term_ends"][r, 0])]
             for r in range(q)]
    _row(rows, "span_locate_batch", "elasticsearch_tpu/ops/bm25_device.py:1050", q,
         lambda: kern.span_locate_batch(*args),
         lambda: kern.span_locate_batch_plain(*args),
         lambda: [torch.searchsorted(spans[r], cands[r]) for r in range(q)],
         "torch.searchsorted per row",
         cands.numel() * 9 + sum(s.numel() for s in spans) * 4, device=True)
    fargs = _fold_args(la["children"][1 + spec[6]], m, doc_tiles, tn, q,
                       num_docs, lane)
    _row(rows, "span_fold_batch", "elasticsearch_tpu/ops/bm25_device.py:1050", q,
         lambda: kern.span_fold_batch(*fargs),
         lambda: kern.span_fold_batch_plain(*fargs),
         None, "none", _fold_nbytes(*fargs), device=True)
    return rows


def _fold_args(lead, m, doc_tiles, tn, r_count, num_docs, lane):
    """K4's fold-mode arguments as _sparse_lead_inner builds them from a
    lead filter's worklist `lead` and the must's plan `m` over R rows (a
    stacked tree's planes [S, NT, 256] serve row r from shard r % S)."""
    import torch

    tid, valid = _worklist(lead, lane)
    if doc_tiles.dim() == 3:
        shard = (torch.arange(r_count, device=tid.device) % doc_tiles.shape[0])
        docs = doc_tiles[shard[:, None], tid]
        flat, flat_tn = (x.reshape(x.shape[0], -1) for x in (doc_tiles, tn))
    else:
        docs = doc_tiles[tid]
        flat, flat_tn = doc_tiles.reshape(-1), tn.reshape(-1)
    cand = torch.where(valid, docs, num_docs).reshape(r_count, -1)
    return (flat, flat_tn, m["term_starts"], m["term_ends"], m["term_weights"],
            torch.clamp(cand, max=num_docs - 1), cand != num_docs)


def _fold_nbytes(flat, flat_tn, starts, ends, weights, cands, in_range) -> int:
    """Bytes the fold mode must move for these inputs: the candidates and
    in_range read (5 B each), each row's spans and weights (12 B a term),
    each distinct plane slot the reference's searches read up to their
    fixed point (4 B) and the tn of each distinct found slot (4 B), and
    score and matched written (5 B a candidate)."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    q, p = cands.shape
    length = flat.shape[-1]
    limit = length - 1
    base = torch.zeros((q, 1), dtype=torch.int64, device=cands.device)
    if flat.dim() == 2:
        base = (torch.arange(q, device=cands.device) % flat.shape[0])[:, None] * length
    flat1 = flat.reshape(-1)
    read, found_at = [], []
    for j in range(starts.shape[1]):
        lo = starts[:, j : j + 1].expand(q, p).clone()
        hi = ends[:, j : j + 1].expand(q, p).clone()
        end = hi.clone()
        active = torch.ones((q, p), dtype=torch.bool, device=cands.device)
        for _ in range(kern.search_steps(length)):
            at = base + torch.clamp((lo + hi) >> 1, 0, limit).to(torch.int64)
            read.append(at[active])
            go = flat1[at] < cands
            nlo = torch.where(go, ((lo + hi) >> 1) + 1, lo)
            nhi = torch.where(go, hi, (lo + hi) >> 1)
            active = active & ((nlo != lo) | (nhi != hi))
            lo, hi = nlo, nhi
        at = base + torch.clamp(lo, 0, limit).to(torch.int64)
        read.append(at.reshape(-1))
        found_at.append(at[(lo < end) & (flat1[at] == cands) & in_range])
    probes = torch.unique(torch.cat(read)).numel()
    tn_reads = torch.unique(torch.cat(found_at)).numel()
    return int(q * p * 5 + starts.numel() * 12 + probes * 4 + tn_reads * 4
               + q * p * 5)


def _matched_only_args(tree, spec, a, num_docs, stacked: bool):
    """K1's matched-only arguments for a terms_const plan `a` (one row
    [1, nt], or S stacked rows [S, nt]), and the gathered postings as flat
    indices into the [rows, num_docs + 1] plane (the library call's
    input)."""
    import torch

    doc_tiles, tn, _tfs, norm_bytes, _present = tree["fields"][spec[1]]
    lane = torch.arange(256, device=doc_tiles.device, dtype=torch.int64)
    tid, valid = _worklist(a, lane)
    n_rows = tid.shape[0]
    if stacked:
        shard = torch.arange(n_rows, device=tid.device).view(-1, 1)
        docs = doc_tiles[shard.expand_as(tid), tid]
    else:
        docs = doc_tiles[tid]
    row = torch.arange(n_rows, device=tid.device).view(-1, 1, 1).expand(docs.shape)
    flat = (row * (num_docs + 1) + docs.to(torch.int64))[valid]
    args = (doc_tiles, tn, norm_bytes, a["tile_ids"], a["starts"], a["ends"],
            None, num_docs, a["_groups"])
    n_real = int(valid.any(dim=-1).sum())
    return args, flat, int(valid.sum()), n_real


def kernel_row_matched_only(seg_tree, compiler, term, dev, rows):
    """K1's matched-only mode for one segment (kernel-table row 8b's
    first half, compute_filter_mask: a filter-cache plane's build): cfg2's
    head-term filter over the one-shard corpus, held bit for bit to
    terms_scatter_batch_plain(matched_only=True)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    num_docs = seg_tree["live"].shape[0]
    c = compiler.compile(parse_query(
        {"bool": {"filter": [{"term": {"body": term}}]}}))
    spec = c.spec[3][0]
    if spec[0] != "terms_const":
        raise SmokeFailure(f"head-term filter compiled to {spec[0]}")
    a = bm25_device._rows1(bm25_device.plan_to_torch(
        spec, c.arrays["children"][0], dev))
    args, flat, n_valid, n_real = _matched_only_args(
        seg_tree, spec, a, num_docs, stacked=False)
    _row(rows, "terms_scatter_matched_only",
         "elasticsearch_tpu/ops/bm25_device.py:1797", 1,
         lambda: kern.terms_scatter_batch(*args, matched_only=True),
         lambda: kern.terms_scatter_batch_plain(*args, matched_only=True),
         lambda: torch.zeros(num_docs + 1, dtype=torch.bool,
                             device=dev).index_fill_(0, flat, True),
         "torch.zeros(N + 1, dtype=bool).index_fill_ over the gathered postings",
         # the valid postings' doc ids and the worklist read, the plane
         # written once
         n_valid * 4 + n_real * 12 + (num_docs + 1),
         source=SOURCES["terms_scatter"], device=True,
         case=f"head-term filter [{term}], {n_valid:,} postings over "
              f"{num_docs:,} docs")


def _k3k_cases(seg_tree, compiler, match_terms, scores, elig, dev):
    """K3k's added cases over the corpus: (case, replaced line, the
    keyed_topk_batch arguments, the library call over the same masked
    key). An ascending timestamp-like column (f32, 1 s apart) sorted desc
    and asc; f1 with all but every 997th value missing; the match's
    scores bottom-k past a cursor at their median; 16 match rows over
    f1; and k = 10,000, past KEYED_SELECT_MAX_K (the large-k select), on
    f1, on the mostly-missing column and on the ascending one."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    num_docs = seg_tree["live"].shape[0]
    f1 = seg_tree["doc_values"]["f1"]
    ninf = float("-inf")

    def topk_of(key, el, desc, mf, k):
        sk = kern.sort_key(key, desc, mf)
        masked = torch.where(el, -sk, ninf).contiguous()
        return lambda: torch.topk(masked, k, dim=-1)

    ts = (torch.arange(num_docs, dtype=torch.float32, device=dev) * 1000.0
          + 1.7e12)
    missing = torch.full_like(f1, float("nan"))
    missing[::997] = f1[::997]
    sc = scores.contiguous()
    live = torch.where(elig, sc, torch.zeros_like(sc))
    med = float(torch.median(sc[elig]))
    after = (torch.tensor([med], dtype=torch.float32, device=dev),
             torch.tensor([num_docs // 2], dtype=torch.int32, device=dev))
    iota = torch.arange(num_docs, device=dev)
    past = elig & ((live > med) | ((live == med) & (iota > num_docs // 2)))
    asc_masked = torch.where(past, -live, ninf).contiguous()
    planes = []
    for terms in match_terms[:16]:
        c = compiler.compile(parse_query({"match": {"body": " ".join(terms)}}))
        plan = bm25_device._rows1(bm25_device.plan_to_torch(c.spec, c.arrays, dev))
        planes.append(bm25_device._dense_rows(seg_tree, c.spec, plan, 1)[1][0])
    elig16 = torch.stack(planes).contiguous()
    fld, srt = kern.KEYED_FIELD, "elasticsearch_tpu/ops/bm25_device.py:1774"
    return [
        ("ascending ts-like column, desc", srt,
         (ts, elig, TOP_K, fld, True, False), topk_of(ts, elig, True, False, TOP_K)),
        ("ascending ts-like column, asc", srt,
         (ts, elig, TOP_K, fld, False, False), topk_of(ts, elig, False, False, TOP_K)),
        ("f1 mostly missing, desc", srt,
         (missing, elig, TOP_K, fld, True, False),
         topk_of(missing, elig, True, False, TOP_K)),
        ("_score asc past a cursor", "elasticsearch_tpu/ops/bm25_device.py:1313",
         (live, elig, TOP_K, kern.KEYED_SCORE_ASC, False, False, *after),
         lambda: torch.topk(asc_masked, TOP_K, dim=-1)),
        ("Q = 16 over the shared f1", srt,
         (f1, elig16, TOP_K, fld, True, False),
         topk_of(f1, elig16, True, False, TOP_K)),
        ("f1 desc, k = 10,000 (the large-k select)", srt,
         (f1, elig, 10_000, fld, True, False),
         topk_of(f1, elig, True, False, 10_000)),
        ("f1 mostly missing, desc, k = 10,000 (the large-k select)", srt,
         (missing, elig, 10_000, fld, True, False),
         topk_of(missing, elig, True, False, 10_000)),
        ("ascending ts-like column, desc, k = 10,000 (the large-k select)",
         srt, (ts, elig, 10_000, fld, True, False),
         topk_of(ts, elig, True, False, 10_000)),
    ]


def kernel_rows_slice4(seg_tree, compiler, match_terms, dev):
    """K3k, K5 (fused and gather modes) and K6 at the rescore and sorted
    phases' shapes: K3k on f1 over N = 8,841,823 docs at k = 10, K5 at a
    window of 1,024, K6 on cfg4's script over N and on one script with
    every grammar node (with min_score, and again over two rows)."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device, script_kernel
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.script import compile_script

    rows = []
    num_docs = seg_tree["live"].shape[0]
    dv = seg_tree["doc_values"]
    c = compiler.compile(parse_query({"match": {"body": " ".join(match_terms[0])}}))
    plan = bm25_device._rows1(bm25_device.plan_to_torch(c.spec, c.arrays, dev))
    scores, elig = bm25_device._dense_rows(seg_tree, c.spec, plan, 1)

    # K3k: f1 desc over the match's eligible docs (the sorted phase's key).
    masked = torch.where(elig[0], -kern.sort_key(dv["f1"], True, False),
                         float("-inf")).contiguous()
    args = (dv["f1"], elig, TOP_K, kern.KEYED_FIELD, True, False)
    _row(rows, "keyed_topk", "elasticsearch_tpu/ops/bm25_device.py:1774", 1,
         lambda: kern.keyed_topk_batch(*args),
         lambda: kern.keyed_topk_batch_plain(*args),
         lambda: torch.topk(masked, TOP_K), "torch.topk over the masked key",
         num_docs * 5 + TOP_K * 8 + 8, source=SOURCES["masked_topk"],
         case=f"f1 desc, N = {num_docs}, k = {TOP_K}")
    # K3 at cfg4's window over the same match's dense [1, N] plane: the
    # large-k select on the one-shard corpus's longest row.
    dkey = torch.where(elig, scores, float("-inf")).contiguous()
    _row(rows, "masked_topk", "elasticsearch_tpu/ops/bm25_device.py:741", 1,
         lambda: kern.masked_topk_batch(dkey, elig, CFG4_WINDOW),
         lambda: kern.masked_topk_batch_plain(dkey, elig, CFG4_WINDOW),
         lambda: torch.topk(dkey[0], CFG4_WINDOW), "torch.topk",
         num_docs * 5 + CFG4_WINDOW * 8 + 4, device=True,
         case=f"dense [1, {num_docs:,}], k = {CFG4_WINDOW} (the rescore "
              f"window; {kern.topk_route(CFG4_WINDOW, num_docs)})")
    for case, replaces, kargs, lib in _k3k_cases(
            seg_tree, compiler, match_terms, scores, elig, dev):
        q_rows, n_cols = kargs[1].shape
        kp = min(kargs[2], n_cols)
        key_bytes = kargs[0].numel() * 4
        _row(rows, "keyed_topk", replaces, q_rows,
             lambda kargs=kargs: kern.keyed_topk_batch(*kargs),
             lambda kargs=kargs: kern.keyed_topk_batch_plain(*kargs),
             lib, "torch.topk over the masked key",
             key_bytes + q_rows * n_cols + q_rows * (kp * 8 + 8),
             source=SOURCES["masked_topk"], case=case,
             reps=5 if kp > kern.KEYED_SELECT_MAX_K or q_rows > 1 else 20,
             device=kp > kern.KEYED_SELECT_MAX_K)

    # K5 at a window of 1,024: the match's top window and the cfg4 plane.
    w = 1024
    s, ids, _t = bm25_device._inner_for(c.spec)(seg_tree, c.spec, plan, w, 1)
    s, ids = s.contiguous(), ids.contiguous()
    rc = compiler.compile(parse_query(_cfg4_rescore_query()))
    rplan = bm25_device._rows1(bm25_device.plan_to_torch(rc.spec, rc.arrays, dev))
    rscores, relig = bm25_device._dense_rows(seg_tree, rc.spec, rplan, 1)
    rs, rm = kern.window_gather_batch_plain(rscores, relig, ids)
    comb = torch.where(s > float("-inf"), torch.where(rm, s + rs, s),
                       float("-inf"))
    fused = (s, ids, rscores, relig, 1.0, 1.0, TOP_K)
    _row(rows, "window_rescore", "elasticsearch_tpu/ops/bm25_device.py:1197", 1,
         lambda: kern.window_rescore_batch(*fused),
         lambda: kern.window_rescore_batch_plain(*fused),
         lambda: torch.topk(comb, TOP_K), "torch.topk over the combined window",
         w * 13 + TOP_K * 8, source="elasticsearch_tpu_torch/csrc/window_rescore.cu")
    ids64 = ids.to(torch.int64)
    _row(rows, "window_rescore_gather", "elasticsearch_tpu/ops/bm25_device.py:1835",
         1, lambda: kern.window_gather_batch(rscores, relig, ids),
         lambda: kern.window_gather_batch_plain(rscores, relig, ids),
         lambda: torch.gather(rscores, 1, ids64),
         "torch.gather (the scores only; the matched half is a second call)",
         w * 14, source="elasticsearch_tpu_torch/csrc/window_rescore.cu")

    # K6: cfg4's script over match_all (the rescore plane), then the
    # every-node script over the match's scores with min_score.
    cols = {f: dv[f] for f in ("f1", "f2", "f3")}
    one = torch.ones(1, dtype=torch.float32, device=dev)
    ones = torch.ones((1, num_docs), dtype=torch.float32, device=dev)
    all_docs = torch.ones((1, num_docs), dtype=torch.bool, device=dev)
    cfg4 = (compile_script(CFG4_SCRIPT), ones, all_docs, cols,
            {k: torch.full((1,), v, device=dev) for k, v in CFG4_PARAMS.items()},
            one)
    _row(rows, "script_eval", "elasticsearch_tpu/ops/bm25_device.py:338", 1,
         lambda: script_kernel.script_eval(*cfg4),
         lambda: script_kernel.script_eval_plain(*cfg4), None, None,
         num_docs * 17, route="triton",
         source="elasticsearch_tpu_torch/ops/script_kernel.py",
         case="cfg4 script")
    gram = (compile_script(GRAMMAR_SCRIPT), scores, elig, cols,
            {k: torch.full((1,), v, device=dev) for k, v in GRAMMAR_PARAMS.items()},
            one, torch.full((1,), 2.0, device=dev))
    _row(rows, "script_eval", "elasticsearch_tpu/ops/bm25_device.py:338", 1,
         lambda: script_kernel.script_eval(*gram),
         lambda: script_kernel.script_eval_plain(*gram), None, None,
         num_docs * 22, route="triton",
         source="elasticsearch_tpu_torch/ops/script_kernel.py",
         case="every grammar node, min_score")
    q2 = (gram[0], scores.repeat(2, 1), elig.repeat(2, 1), cols,
          {k: torch.tensor([v, v * 0.5], device=dev) for k, v in GRAMMAR_PARAMS.items()},
          torch.tensor([1.0, 2.0], device=dev), torch.tensor([2.0, 0.0], device=dev))
    _same(script_kernel.script_eval(*q2), script_kernel.script_eval_plain(*q2),
          "script_eval over two rows")
    torch.cuda.synchronize()
    return rows


def kernel_rows_sharded(svc, handles, bodies, dev, q):
    """K1b (gather mode: the coordinator compiles with global statistics)
    and K3b at the sharded concurrent phase's mean batch, on shard 0."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern

    handle = handles[0]
    seg_tree = bm25_device.segment_tree(handle.device)
    num_docs = seg_tree["live"].shape[0]
    doc_tiles, _tn, tfs, norm_bytes, _present = seg_tree["fields"]["body"]
    compiler = svc.engines[0].compiler_for(handle, svc.search.global_stats())
    lane = torch.arange(256, device=dev, dtype=torch.int64)
    rows = []
    match_bodies = bodies[N_CFG3 : N_CFG3 + q]
    spec, a = _stacked_plan(compiler, match_bodies, dev)
    if spec[0] != "terms_gather":
        raise SmokeFailure(f"sharded match compiled to {spec[0]}, not terms_gather")
    tid, valid = _worklist(a, lane)
    n_real = int(valid.any(dim=-1).sum())
    args = (doc_tiles, tfs, norm_bytes, a["tile_ids"], a["starts"], a["ends"],
            a["weights"], num_docs, a["_groups"])
    kwargs = {"cache": a["cache"]}
    # index_add_ yardstick: the same contributions into the flattened
    # [Q * (N + 1)] plane.
    row_of = torch.arange(q, device=dev)[:, None, None].expand_as(valid)
    docs = doc_tiles[tid]
    flat_idx = (row_of * (num_docs + 1) + docs)[valid].to(torch.int64)
    w = a["weights"][..., None]
    x = tfs[tid] * a["cache"][torch.arange(q, device=dev)[:, None, None],
                              norm_bytes[docs.to(torch.int64)].to(torch.int64)]
    contrib = (w - w / (1.0 + x))[valid]
    _row(rows, "terms_scatter_batch", "elasticsearch_tpu/ops/bm25_device.py:1261", q,
         lambda: kern.terms_scatter_batch(*args, **kwargs),
         lambda: kern.terms_scatter_batch_plain(*args, **kwargs),
         lambda: torch.zeros(q * (num_docs + 1), device=dev).index_add_(
             0, flat_idx, contrib),
         "index_add_ over [Q * (N + 1)]",
         # postings (doc id, tf, norm byte) read, worklists read, planes written
         int(valid.sum()) * 9 + n_real * 16 + q * (num_docs + 1) * 5)
    scores, matched = kern.terms_scatter_batch(*args, **kwargs)
    elig = (matched[:, :num_docs] & seg_tree["live"]).contiguous()
    key = torch.where(elig, scores[:, :num_docs], float("-inf")).contiguous()
    _row(rows, "masked_topk_batch", "elasticsearch_tpu/ops/bm25_device.py:1261", q,
         lambda: kern.masked_topk_batch(key, elig, TOP_K),
         lambda: kern.masked_topk_batch_plain(key, elig, TOP_K),
         lambda: torch.topk(key, TOP_K, dim=1), "torch.topk over [Q, M]",
         key.numel() * 5 + q * (TOP_K * 8 + 4), device=True)
    # Both sides of the row mode's switch (kern.ROW_SELECT_MAX_K): the
    # select at k = 256, the large-k select at k = 257, on the same keys.
    for kk in (kern.ROW_SELECT_MAX_K, kern.ROW_SELECT_MAX_K + 1):
        _row(rows, "masked_topk_batch", "elasticsearch_tpu/ops/bm25_device.py:1261",
             q, lambda kk=kk: kern.masked_topk_batch(key, elig, kk),
             lambda kk=kk: kern.masked_topk_batch_plain(key, elig, kk),
             lambda kk=kk: torch.topk(key, kk, dim=1), "torch.topk over [Q, M]",
             key.numel() * 5 + q * (kk * 8 + 4), device=True,
             case=f"k = {kk} ({kern.topk_route(kk, key.shape[1])})")
    return rows


def kernel_rows_stacked(stree, buckets, dev):
    """K1s-K4s, the stacked-shard modes, at the stacked phase's shapes:
    R = Q x S rows of its largest bucket of each shape (K2s/K3s: the
    matches, K4s: the conjunctions' filter membership and, in its fold
    mode, the filter-led conjunctions' must terms, K1s: the dense
    bool(should)'s first clause)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern

    doc_tiles, tn, _tfs, norm_bytes, _present = stree["fields"]["body"]
    live = stree["live"]
    n_shards, num_docs = live.shape
    lane = torch.arange(256, device=dev, dtype=torch.int64)
    rows = []

    def largest(pred):
        spec, pos, plan, _h = max((b for b in buckets if pred(b[0])),
                                  key=lambda b: len(b[1]))
        return spec, len(pos) * n_shards, bm25_device._pair_rows(plan)

    def shard_of(r_count):
        """Row r's shard, as a column that indexes beside [R, nt] tile ids."""
        return (torch.arange(r_count, device=dev) % n_shards)[:, None]

    def worklist(a, r_count):
        tid, valid = _worklist(a, lane)
        return tid, valid, doc_tiles[shard_of(r_count), tid]

    # K2s and K3s: the largest match bucket.
    spec, r_count, a = largest(lambda sp: sp[0] == "terms")
    tid, valid, docs = worklist(a, r_count)
    n_real = int(valid.any(dim=-1).sum())
    args = (doc_tiles, tn, a["tile_ids"], a["starts"], a["ends"], a["weights"],
            live, num_docs, spec[3])
    docs_s, run_sum, elig = kern.sparse_fold_stacked(*args)
    p_all = docs_s.numel()
    cand_keys = torch.where(valid, docs, num_docs).reshape(r_count, -1)
    _row(rows, "sparse_fold_stacked", "elasticsearch_tpu/ops/bm25_device.py:1161",
         r_count, lambda: kern.sparse_fold_stacked(*args),
         lambda: kern.sparse_fold_stacked_plain(*args),
         lambda: torch.sort(cand_keys, dim=1, stable=True),
         "torch.sort(stable=True) over [Q*S, P]",
         n_real * 256 * 8 + n_real * 16 + p_all * 9)
    key = torch.where(elig, run_sum, float("-inf"))
    _row(rows, "masked_topk_stacked", "elasticsearch_tpu/ops/bm25_device.py:1137",
         r_count, lambda: kern.masked_topk_stacked(key, elig, TOP_K, n_shards),
         lambda: kern.masked_topk_stacked_plain(key, elig, TOP_K, n_shards),
         lambda: torch.topk(key, TOP_K, dim=1), "torch.topk over [Q*S, P]",
         key.numel() * 5 + r_count * (TOP_K * 8 + 4), device=True)

    # K4s: the largest conjunction bucket's filter membership at its
    # must's candidates.
    spec, r_count, a = largest(lambda sp: sp[0] == "bool" and sp[3] and sp[6] < 0)
    m = a["children"][0]
    docs_s, _run, _el = kern.sparse_fold_stacked(
        doc_tiles, tn, m["tile_ids"], m["starts"], m["ends"], m["weights"],
        live, num_docs, spec[1][0][3])
    cands = torch.clamp(docs_s, max=num_docs - 1)
    f = a["children"][1]
    starts, ends = f["span_start"].reshape(-1, 1), f["span_end"].reshape(-1, 1)
    flat = doc_tiles.reshape(n_shards, -1)
    args = (flat, starts, ends, 0, cands)
    spans = [flat[r % n_shards][int(starts[r, 0]):int(ends[r, 0])]
             for r in range(r_count)]
    _row(rows, "span_locate_stacked", "elasticsearch_tpu/ops/bm25_device.py:1161",
         r_count, lambda: kern.span_locate_stacked(*args),
         lambda: kern.span_locate_stacked_plain(*args),
         lambda: [torch.searchsorted(spans[r], cands[r]) for r in range(r_count)],
         "torch.searchsorted per row",
         cands.numel() * 9 + sum(x.numel() for x in spans) * 4, device=True)

    # K4s's fold mode: the largest filter-led bucket's must terms at its
    # lead filter's candidates.
    spec, r_count, a = largest(lambda sp: sp[0] == "bool" and sp[3] and sp[6] >= 0)
    fargs = _fold_args(a["children"][1 + spec[6]], a["children"][0], doc_tiles,
                       tn, r_count, num_docs, lane)
    _row(rows, "span_fold_stacked", "elasticsearch_tpu/ops/bm25_device.py:1161",
         r_count, lambda: kern.span_fold_stacked(*fargs),
         lambda: kern.span_fold_stacked_plain(*fargs),
         None, "none", _fold_nbytes(*fargs), device=True,
         case=f"stacked filter-led cfg3 conjunctions: T = "
              f"{fargs[2].shape[1]}, P = {fargs[5].shape[1]}")

    # K1s: the dense bool(should)'s first clause.
    spec, r_count, a = largest(lambda sp: not bm25_device.supports_sparse(sp))
    c = a["children"][0]
    tid, valid, docs = worklist(c, r_count)
    n_real = int(valid.any(dim=-1).sum())
    args = (doc_tiles, tn, norm_bytes, c["tile_ids"], c["starts"], c["ends"],
            c["weights"], num_docs, c["_groups"])
    row_of = torch.arange(r_count, device=dev)[:, None, None].expand_as(valid)
    flat_idx = (row_of * (num_docs + 1) + docs)[valid].to(torch.int64)
    w = c["weights"][..., None]
    contrib = (w - w / (1.0 + tn[shard_of(r_count), tid]))[valid]
    _row(rows, "terms_scatter_stacked", "elasticsearch_tpu/ops/bm25_device.py:1137",
         r_count, lambda: kern.terms_scatter_stacked(*args),
         lambda: kern.terms_scatter_stacked_plain(*args),
         lambda: torch.zeros(r_count * (num_docs + 1), device=dev).index_add_(
             0, flat_idx, contrib),
         "index_add_ over [Q*S * (N + 1)]",
         int(valid.sum()) * 8 + n_real * 16 + r_count * (num_docs + 1) * 5)
    return rows


# ---------------------------------------------------------------------------
# Aggregations (kernel-table row 22, K10) and the NaN-scored pages
# ---------------------------------------------------------------------------

N_AGG_DOCS = 1_000_000  # bench.py:346-432, cfg7's kernel half
AGG_SHARDS = 8
AGG_SEQ_REPS = 10  # sequential requests of each aggs body
AGG_SOURCE = "elasticsearch_tpu_torch/csrc/bucket_fold.cu"
AGG_TAGS = ["x", "y", "z"]  # _cfg7_end_to_end's tag values (bench.py:570)


def _keyword_field(name: str, values: list, codes):
    """A single-valued keyword FieldIndex (doc i has values[codes[i]], the
    values sorted), as SegmentBuilder builds one: postings doc-ascending."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import FieldIndex
    from elasticsearch_tpu_torch.utils import smallfloat

    n = len(codes)
    df = np.bincount(codes, minlength=len(values)).astype(np.int32)
    offsets = np.zeros(len(values) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(df)
    return FieldIndex(
        name=name, terms={v: i for i, v in enumerate(values)}, df=df,
        offsets=offsets,
        doc_ids=np.argsort(codes, kind="stable").astype(np.int32),
        tfs=np.ones(n, dtype=np.float32),
        norm_bytes=smallfloat.encode_lengths(np.ones(n, dtype=np.int64)),
        doc_count=n, sum_total_tf=n, has_norms=False,
        present=np.ones(n, dtype=bool),
    )


def _concat_segments(segments):
    """One segment holding the given segments' documents in order (the
    one-shard index of the aggs phase): postings regrouped by the union
    term dictionary, doc values and ids concatenated."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import FieldIndex, Segment

    bases = np.cumsum([0] + [s.num_docs for s in segments])
    fields = {}
    for name in segments[0].fields:
        parts = [s.fields[name] for s in segments]
        vocab = sorted(set().union(*(f.terms for f in parts)))
        gid = {t: i for i, t in enumerate(vocab)}
        tids, docs, tfs = [], [], []
        for base, f in zip(bases, parts):
            to_global = np.empty(len(f.terms), dtype=np.int64)
            for t, i in f.terms.items():
                to_global[i] = gid[t]
            tids.append(np.repeat(to_global, np.diff(f.offsets)))
            docs.append(f.doc_ids.astype(np.int64) + base)
            tfs.append(f.tfs)
        tid = np.concatenate(tids)
        order = np.argsort(tid, kind="stable")  # shard order: docs ascend
        df = np.bincount(tid, minlength=len(vocab)).astype(np.int32)
        offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(df)
        fields[name] = FieldIndex(
            name=name, terms=gid, df=df, offsets=offsets,
            doc_ids=np.concatenate(docs)[order].astype(np.int32),
            tfs=np.concatenate(tfs)[order],
            norm_bytes=np.concatenate([f.norm_bytes for f in parts]),
            doc_count=sum(f.doc_count for f in parts),
            sum_total_tf=sum(f.sum_total_tf for f in parts),
            has_norms=parts[0].has_norms,
            present=np.concatenate([f.present for f in parts]),
        )
    return Segment(
        num_docs=int(bases[-1]), fields=fields,
        doc_values={k: np.concatenate([s.doc_values[k] for s in segments])
                    for k in segments[0].doc_values},
        vectors={}, sources=sum((s.sources for s in segments), []),
        ids=sum((s.ids for s in segments), []),
    )


class AggTimer:
    """CUDA events around every aggs_device.execute_aggs call while
    installed: the device time of each segment's aggregation pass."""

    def __init__(self):
        from elasticsearch_tpu_torch.ops import aggs_device

        self.mod = aggs_device
        self.real = aggs_device.execute_aggs
        self.events: list = []

    def __enter__(self):
        import torch

        def timed(*args):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = self.real(*args)
            ev1.record()
            self.events.append((ev0, ev1))
            return out

        self.mod.execute_aggs = timed
        return self

    def __exit__(self, *exc):
        import torch

        self.mod.execute_aggs = self.real
        torch.cuda.synchronize()

    def total_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def _agg_bodies(match_terms, filter_term):
    """cfg7's four REST bodies (bench.py:604-615, the match words drawn
    from the Zipf vocabulary) and this slice's additions."""
    match = {"match": {"body": " ".join(match_terms)}}
    stats = {"stats": {"field": "price"}}
    ranges = [{"from": i * 500, "to": (i + 1) * 500} for i in range(20)]
    return {
        "cfg7_sorted": {"query": match, "sort": [{"price": "desc"}],
                        "size": 10},
        "cfg7_sorted_aggs": {
            "query": match,
            "sort": [{"price": {"order": "asc", "missing": "_first"}}],
            "size": 10,
            "aggs": {"st": stats,
                     "h": {"histogram": {"field": "price", "interval": 250}}}},
        "cfg7_terms": {"query": {"match_all": {}}, "size": 0,
                       "aggs": {"tags": {"terms": {"field": "tag"}},
                                "st": stats}},
        "cfg7_after": {"query": match, "sort": [{"price": "asc"}],
                       "size": 10, "search_after": [2500]},
        "histogram_500": {"size": 0, "aggs": {"h500": {"histogram": {
            "field": "price", "interval": 500},
            "aggs": {"a": {"avg": {"field": "price"}}}}}},
        "range_20": {"size": 0, "aggs": {"r20": {"range": {
            "field": "price", "ranges": ranges},
            "aggs": {"s": {"sum": {"field": "price"}}}}}},
        "filters": {"size": 0, "aggs": {"f": {"filters": {"filters": {
            "x": {"term": {"tag": "x"}},
            "t": {"term": {"body": filter_term}}}}}}},
        "missing": {"query": match, "size": 0,
                    "aggs": {"m": {"missing": {"field": "price"}}}},
        "global": {"query": match, "size": 0,
                   "aggs": {"g": {"global": {}, "aggs": {"st": stats}}}},
    }


def _full_agg_bodies():
    """The histogram and range bodies over the 8,841,823-doc corpus's
    f1 / f2 columns (f1 in [0, 1): 1,000 buckets of 0.001, 20 ranges of
    0.05)."""
    ranges = [{"from": i / 20, "to": (i + 1) / 20} for i in range(20)]
    return {
        "histogram_f1": {"size": 0, "aggs": {"h": {"histogram": {
            "field": "f1", "interval": 0.001},
            "aggs": {"a": {"avg": {"field": "f2"}}}}}},
        "range_f1": {"size": 0, "aggs": {"r": {"range": {
            "field": "f1", "ranges": ranges},
            "aggs": {"s": {"sum": {"field": "f2"}}}}}},
    }


def _k10_sums(rows, groups, values, nb: int, ch: int, n_rows: int):
    """K10's f32 sums of one segment in its stated order, in numpy: the
    rows (ascending) cut into chunks of `ch`; np.add.at applies the adds
    one at a time in row order, so each (chunk, bucket) partial is a left
    fold; the partials then fold in chunk order."""
    import numpy as np

    part = np.zeros((-(-n_rows // ch), nb), dtype=np.float32)
    np.add.at(part, (rows // ch, groups), values.astype(np.float32))
    total = np.zeros(nb, dtype=np.float32)
    for c in range(part.shape[0]):
        total = (total + part[c]).astype(np.float32)
    return total


def _hist_oracle(segs, masks, field, interval, sub, sub_kind):
    """A fixed-interval histogram's rendered buckets (keys, doc_counts and
    the sub-metric) from the host columns: the reference's window over
    the global f32 range, each segment's sub sums in K10's order, f64
    across segments."""
    import numpy as np

    from elasticsearch_tpu_torch.ops.kernels import bucket_chunk_rows

    lo = min(float(np.float32(np.nanmin(s.doc_values[field]))) for s in segs)
    hi = max(float(np.float32(np.nanmax(s.doc_values[field]))) for s in segs)
    base = np.floor(lo / interval)
    nb = int(np.floor(hi / interval) - base) + 1
    nb_pad = 1 << (nb - 1).bit_length()
    counts = np.zeros(nb_pad, np.int64)
    sub_counts = np.zeros(nb_pad, np.int64)
    sums = np.zeros(nb_pad, np.float64)
    for seg, mask in zip(segs, masks):
        col = seg.doc_values[field].astype(np.float32)
        rel = np.floor(col / np.float32(interval)) - np.float32(base)
        ok = mask & ~np.isnan(col) & (rel >= 0) & (rel < nb_pad)
        b = np.where(ok, rel, 0).astype(np.int64)
        counts += np.bincount(b[ok], minlength=nb_pad)
        if sub is not None:
            sv = seg.doc_values[sub].astype(np.float32)
            ok2 = ok & ~np.isnan(sv)
            sub_counts += np.bincount(b[ok2], minlength=nb_pad)
            sums += _k10_sums(np.flatnonzero(ok2), b[ok2], sv[ok2], nb_pad,
                              bucket_chunk_rows(seg.num_docs, nb_pad),
                              seg.num_docs).astype(np.float64)
    occ = np.flatnonzero(counts)
    out = []
    for i in range(int(occ[0]), int(occ[-1]) + 1) if len(occ) else ():
        key = (base + i) * interval
        b = {"key": int(key) if float(key).is_integer() else float(key),
             "doc_count": int(counts[i])}
        if sub is not None:
            c = int(sub_counts[i])
            v = (float(sums[i]) / c if c else None) if sub_kind == "avg" \
                else float(sums[i])
            b["a"] = {"value": v}
        out.append(b)
    return out


def _range_oracle(segs, masks, field, ranges, sub, sub_name):
    """Range buckets from the host columns: f32 stored values against the
    f32 bounds, each segment's sub sums in K10's range-mode order, f64
    across segments."""
    import numpy as np

    from elasticsearch_tpu_torch.ops.kernels import bucket_chunk_rows

    r = len(ranges)
    out = []
    for i, rg in enumerate(ranges):
        lo = np.float32(rg.get("from", -np.inf))
        hi = np.float32(rg.get("to", np.inf))
        count, total = 0, 0.0
        for seg, mask in zip(segs, masks):
            col = seg.doc_values[field].astype(np.float32)
            member = mask & (col >= lo) & (col < hi)
            count += int(member.sum())
            sv = seg.doc_values[sub].astype(np.float32)
            ok = member & ~np.isnan(sv)
            rows = np.flatnonzero(ok)
            total += float(_k10_sums(
                rows, np.zeros(len(rows), np.int64), sv[ok], 1,
                bucket_chunk_rows(seg.num_docs, r), seg.num_docs)[0])
        b = {"key": f"{float(rg['from']) if 'from' in rg else '*'}-"
                    f"{float(rg['to']) if 'to' in rg else '*'}"}
        if "from" in rg:
            b["from"] = float(rg["from"])
        if "to" in rg:
            b["to"] = float(rg["to"])
        b["doc_count"] = count
        b[sub_name] = {"value": total}
        out.append(b)
    return out


def _oracle_stats(segs, masks, field):
    """Top-level stats as the reference folds them: per segment the
    matched f64 values, np.sum / min / max, in segment order."""
    import numpy as np

    count, s, lo, hi = 0, 0.0, np.inf, -np.inf
    for seg, m in zip(segs, masks):
        v = seg.doc_values[field][m]
        v = v[~np.isnan(v)]
        count += len(v)
        if len(v):
            s += float(np.sum(v))
            lo, hi = min(lo, float(np.min(v))), max(hi, float(np.max(v)))
    return {"count": count, "min": lo if count else None,
            "max": hi if count else None, "avg": s / count if count else None,
            "sum": s}


def _term_mask(seg, field, terms):
    import numpy as np

    mask = np.zeros(seg.num_docs, dtype=bool)
    for t in terms:
        mask[seg.fields[field].postings(t)[0]] = True
    return mask


def agg_oracle(body, out, segs) -> bool:
    """One answer's totals and aggregations against numpy over the host
    columns: integer counts exact, metrics in f64 as the reference folds
    them, sub-metric sums in K10's stated order."""
    import numpy as np

    query = body.get("query", {"match_all": {}})
    if "match" in query:
        masks = [_term_mask(s, "body", query["match"]["body"].split())
                 for s in segs]
    else:
        masks = [np.ones(s.num_docs, dtype=bool) for s in segs]
    total = sum(int(m.sum()) for m in masks)
    if out["hits"]["total"]["value"] != min(total, 10_000):
        return False
    want = {}
    for name, spec in body.get("aggs", {}).items():
        kind = next(k for k in spec if k != "aggs")
        p = spec[kind]
        if kind == "stats":
            want[name] = _oracle_stats(segs, masks, p["field"])
        elif kind == "histogram":
            sub = next(iter(spec.get("aggs", {}).values()), None)
            want[name] = {"buckets": _hist_oracle(
                segs, masks, p["field"], p["interval"],
                None if sub is None else sub["avg"]["field"], "avg")}
        elif kind == "range":
            want[name] = {"buckets": _range_oracle(
                segs, masks, p["field"], p["ranges"],
                spec["aggs"]["s"]["sum"]["field"], "s")}
        elif kind == "terms":
            counts = {}
            for seg, m in zip(segs, masks):
                f = seg.fields[p["field"]]
                for term, tid in f.terms.items():
                    docs = f.doc_ids[f.offsets[tid]:f.offsets[tid + 1]]
                    counts[term] = counts.get(term, 0) + int(m[docs].sum())
            items = sorted(((t, c) for t, c in counts.items() if c),
                           key=lambda kv: (-kv[1], kv[0]))
            top = items[:10]
            want[name] = {
                "doc_count_error_upper_bound": 0,
                "sum_other_doc_count": sum(counts.values())
                - sum(c for _, c in top),
                "buckets": [{"key": t, "doc_count": c} for t, c in top]}
        elif kind == "filters":
            buckets = {}
            for key, q in sorted(p["filters"].items()):
                ((fname, term),) = q["term"].items()
                buckets[key] = {"doc_count": sum(
                    int((m & _term_mask(s, fname, [term])).sum())
                    for s, m in zip(segs, masks))}
            want[name] = {"buckets": buckets}
        elif kind == "missing":
            want[name] = {"doc_count": sum(
                int((m & np.isnan(s.doc_values[p["field"]])).sum())
                for s, m in zip(segs, masks))}
        elif kind == "global":
            everything = [np.ones(s.num_docs, dtype=bool) for s in segs]
            want[name] = {"doc_count": sum(s.num_docs for s in segs),
                          "st": _oracle_stats(segs, everything, "price")}
    return out.get("aggregations", {}) == want


def _serve_aggs(card, node, index, bodies, segs, launches, phase):
    """Each body AGG_SEQ_REPS times sequentially (round robin) over HTTP,
    checked three ways: the first answer against the same body served
    with plain_kernels() on the same card tensors (the whole JSON but
    `took`), against the numpy oracle, and every repeat against the
    first answer. Latency percentiles per body (AGG_SEQ_REPS samples
    each) and over the whole mix; device ms per request by CUDA events
    around each segment's aggregation pass."""
    from elasticsearch_tpu_torch.search.service import SearchRequest

    names = list(bodies)
    svc = node.indices[index]
    server, base = serve(node)
    try:
        for nm in names:  # one untimed warm-up request per body
            http(base, "POST", f"/{index}/_search", bodies[nm])
        seq_names = names * AGG_SEQ_REPS
        with counted(phase, launches), AggTimer() as timer:
            lat, seq_resp, wall = sequential(
                base, index, [bodies[n] for n in seq_names])
    finally:
        server.shutdown()
        server.server_close()
    first = seq_resp[: len(names)]
    vs_plain = vs_oracle = 0
    with plain_kernels():
        for nm, out in zip(names, first):
            want = svc.search.search(
                SearchRequest.from_json(bodies[nm])).to_json(index)
            if without_took(json.loads(json.dumps(want))) != without_took(out):
                vs_plain += 1
                log(f"  MISMATCH {phase} plain path {nm}")
    for nm, out in zip(names, first):
        if not agg_oracle(bodies[nm], out, segs):
            vs_oracle += 1
            log(f"  MISMATCH {phase} oracle {nm}: "
                f"{json.dumps(out.get('aggregations'))[:600]}")
    vs_first = sum(without_took(out) != without_took(first[i % len(names)])
                   for i, out in enumerate(seq_resp))
    stats = {
        "requests": len(seq_names), "requests_per_body": AGG_SEQ_REPS,
        "qps_sequential": len(seq_names) / wall,
        "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
        "device_ms_per_request": timer.total_ms() / len(seq_names),
        "per_body": {nm: {"p50_ms": percentile(lat[j::len(names)], 50),
                          "p99_ms": percentile(lat[j::len(names)], 99)}
                     for j, nm in enumerate(names)},
        "mismatches_vs_plain": vs_plain,
        "mismatches_vs_oracle": vs_oracle,
        "mismatches_vs_first": vs_first,
    }
    bad = vs_plain + vs_oracle + vs_first
    log(f"phase {phase}: {'ok' if bad == 0 else 'FAILED'} {json.dumps(stats)} "
        f"[{card}]")
    if bad:
        raise SmokeFailure(f"{bad} aggs mismatches in phase {phase}")
    return stats


def run_aggs_full(card, node, segment, launches) -> dict:
    """The histogram and range bodies over the 8,841,823-doc one-shard
    corpus (columns f1, f2): K10 at the full width, over HTTP."""
    return _serve_aggs(card, node, "msmarco", _full_agg_bodies(), [segment],
                       launches, "aggs-full")


def run_aggs(card, dev, launches, rows) -> dict:
    """The reference bench's cfg7 deployment (bench.py:346-432): 8 shards
    of the Zipf generator (125,000 docs each, vocabulary 20,000, seed
    800 + shard), `price` long in [0, 10,000) with ~10 % missing
    (default_rng(88), drawn as bench.py:388-390 draws it), `tag` keyword
    x / y / z (default_rng(99).choice, as _cfg7_end_to_end draws it); the
    same documents as one 1,000,000-doc shard. The bodies of
    _agg_bodies on both indices, then K10's terms and doc_count rows on
    one shard."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.tiles import device_nbytes
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import aggs_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.utils.corpus import (
        build_zipf_segment,
        pick_query_terms,
    )

    t0 = time.monotonic()
    per_shard = N_AGG_DOCS // AGG_SHARDS
    rng_price = np.random.default_rng(88)
    rng_tag = np.random.default_rng(99)
    rng_ext = np.random.default_rng(SEED + 11)
    shards = []
    for s in range(AGG_SHARDS):
        _m, seg = build_zipf_segment(per_shard, vocab_size=20_000, seed=800 + s)
        price = rng_price.integers(0, 10_000, per_shard).astype(np.float64)
        price[rng_price.random(per_shard) < 0.1] = np.nan  # ~10% missing
        codes = rng_tag.choice(len(AGG_TAGS), size=per_shard)
        seg.fields["tag"] = _keyword_field("tag", AGG_TAGS, codes)
        seg.doc_values["price"] = price
        # phase aggs-ext's date and boolean columns
        seg.doc_values["ts"], seg.doc_values["flag"] = _ext_columns(
            rng_ext, per_shard)
        shards.append(replace(seg, ids=[f"s{s}d{i}" for i in range(per_shard)]))
    whole = _concat_segments(shards)
    gen_s = time.monotonic() - t0
    mappings = {"properties": {"body": {"type": "text"},
                               "price": {"type": "long"},
                               "tag": {"type": "keyword"},
                               "ts": {"type": "date"},
                               "flag": {"type": "boolean"}}}
    node = Node(device=DEVICE)
    node.create_index("cfg7", {"settings": {"index": {
        "number_of_shards": AGG_SHARDS}}, "mappings": mappings})
    node.create_index("cfg7one", {"mappings": mappings})
    t1 = time.monotonic()
    handles = [e._install_segment(seg) for e, seg in
               zip(node.indices["cfg7"].engines, shards)]
    one = node.indices["cfg7one"].engine._install_segment(whole)
    torch.cuda.synchronize()
    log(f"phase aggs corpus: ok {AGG_SHARDS} shards x {per_shard} docs + one "
        f"{whole.num_docs}-doc shard; generate {gen_s:.1f} s, pack+upload "
        f"{time.monotonic() - t1:.1f} s, device bytes "
        f"{sum(device_nbytes(h.device) for h in handles)} (8 shards), "
        f"{device_nbytes(one.device)} (one) [{card}]")

    match_terms = pick_query_terms(shards[0], np.random.default_rng(SEED + 6),
                                   1, terms_per_query=2)[0]
    fld = shards[0].fields["body"]
    head = max(fld.terms, key=lambda t: fld.df[fld.terms[t]])
    bodies = _agg_bodies(match_terms, head)
    result = {"docs": N_AGG_DOCS, "shards": AGG_SHARDS}
    for index, segs in (("cfg7", shards), ("cfg7one", [whole])):
        result[index] = _serve_aggs(card, node, index, bodies, segs, launches,
                                    f"aggs {index}")

    # K10's count rows at one shard's shapes: terms over the tag postings
    # and one doc_count.
    tree = aggs_device.agg_segment_tree(handles[0].device)
    live = tree["live"]
    n = live.shape[0]
    docs, ords = aggs_device._terms_postings(tree, "tag")
    m_ext = torch.cat([live, live.new_zeros(1)])
    m = m_ext[torch.clamp(docs, max=n).long()]
    tp = 1 << (len(AGG_TAGS) - 1).bit_length()
    p = docs.shape[0]
    idx = torch.where(m, ords, tp).long()
    _row(rows, "bucket_fold", "elasticsearch_tpu/ops/aggs_device.py:172", 1,
         lambda: (kern.bucket_fold(ords, m, tp),),
         lambda: (kern.bucket_fold_plain(ords, m, tp),),
         lambda: torch.bincount(idx, minlength=tp + 1), "torch.bincount",
         p * 5 + tp * 4, source=AGG_SOURCE,
         case=f"terms counts over the tag postings, {p:,} rows")
    _row(rows, "bucket_fold", "elasticsearch_tpu/ops/aggs_device.py:284", 1,
         lambda: (kern.bucket_fold(None, live, 1),),
         lambda: (kern.bucket_fold_plain(None, live, 1),),
         lambda: live.sum(dtype=torch.int32), "torch.sum",
         n + 4, source=AGG_SOURCE, case=f"one doc_count over {n:,} docs")
    result["aggs_ext"] = run_aggs_ext(card, node, shards, whole, one,
                                      match_terms, launches, rows)
    result["mesh"] = run_mesh_aggs(card, dev, node, bodies, match_terms,
                                   launches)
    # -- 19. filter-cache on cfg7's documents: 8 shards and one ----------
    plain = Node(device=DEVICE, filter_cache=False)
    for index, segs in (("cfg7", shards), ("cfg7one", [whole])):
        plain.create_index(index, {"settings": {"index": {
            "number_of_shards": len(segs)}}, "mappings": mappings})
        for engine, seg in zip(plain.indices[index].engines, segs):
            engine._install_segment(seg)
    fc_musts = [" ".join(t) for t in pick_query_terms(
        shards[0], np.random.default_rng(SEED + 13), 4, terms_per_query=2)]
    fc = run_filter_cache(
        card, dev, node, plain, fc_musts,
        {"cfg7": CFG7_FC_FILTERS, "cfg7one": CFG7_FC_FILTERS}, launches)
    fc.pop("pending")
    fc["evict"] = run_filter_cache_evict(card, node, plain, "cfg7one",
                                         fc_musts, CFG7_FC_FILTERS, launches)
    result["filter_cache"] = fc
    plain.close()
    del plain
    node.close()
    return result


def kernel_rows_aggs_full(seg_tree, dev, rows):
    """K10 at the aggs-full phase's shapes over the 8,841,823-doc corpus:
    the f1 histogram (1,024 buckets) with the f2 sub-metric (scatter
    mode), and 20 f1 ranges with the f2 sum (range mode), each held to
    its plain version. Library yardsticks, not ports: index_add_ +
    scatter_reduce_(amin, amax) over the same rows, and a masked [R, N]
    sum (with its min and max). Byte bounds: each input read once, each
    output written once."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    live = seg_tree["live"]
    n = live.shape[0]
    col, sub = seg_tree["doc_values"]["f1"], seg_tree["doc_values"]["f2"]
    has = live & ~torch.isnan(col)
    lo_v = float(torch.nan_to_num(col, nan=2.0).min())
    base = float(torch.floor(torch.tensor(lo_v / 0.001)))
    nb = 1024
    rel = torch.floor(col / torch.tensor(0.001, device=dev)) - base
    rel = torch.clamp(torch.nan_to_num(rel, nan=0.0), -1, nb).to(torch.int32)
    inw = has & (rel >= 0) & (rel < nb)
    bidx = torch.where(inw, rel, torch.full_like(rel, nb))
    hs = inw & ~torch.isnan(sub)
    idx = torch.where(hs, bidx, nb).long()
    v = torch.where(hs, sub, 0.0)
    f32max = torch.tensor(kern.F32_MAX, device=dev)

    def scatter_library():
        s = torch.zeros(nb + 1, device=dev).index_add_(0, idx, v)
        lo = f32max.expand(nb + 1).clone().scatter_reduce_(0, idx, v, "amin")
        hi = (-f32max).expand(nb + 1).clone().scatter_reduce_(0, idx, v, "amax")
        return s, lo, hi

    _row(rows, "bucket_fold", "elasticsearch_tpu/ops/aggs_device.py:91", 1,
         lambda: kern.bucket_fold(bidx, inw, nb, values=sub),
         lambda: kern.bucket_fold_plain(bidx, inw, nb, values=sub),
         scatter_library, "index_add_ + scatter_reduce_(amin, amax)",
         n * 9 + nb * 16, source=AGG_SOURCE, reps=10,
         case=f"histogram f1 ({nb} buckets) + f2 sub-metric, {n:,} docs")
    r = 20
    lo = torch.arange(r, device=dev, dtype=torch.float64).float() / r
    hi = (torch.arange(1, r + 1, device=dev, dtype=torch.float64) / r).float()

    def range_library():
        member = (live[None, :] & (col[None, :] >= lo[:, None])
                  & (col[None, :] < hi[:, None]) & ~torch.isnan(sub)[None, :])
        return (torch.where(member, sub[None, :], 0.0).sum(dim=1),
                torch.where(member, sub[None, :], f32max).amin(dim=1),
                torch.where(member, sub[None, :], -f32max).amax(dim=1))

    _row(rows, "bucket_fold_range", "elasticsearch_tpu/ops/aggs_device.py:217",
         r, lambda: kern.range_fold(col, live, lo, hi, sub=sub),
         lambda: kern.range_fold_plain(col, live, lo, hi, sub=sub),
         range_library, "masked [R, N] sum, amin, amax", n * 9 + r * 20,
         source=AGG_SOURCE, reps=10,
         case=f"{r} f1 ranges + f2 sum sub-metric, {n:,} docs")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# aggs-ext: the rest of kernel-table row 22 (significant_terms, rare_terms,
# cardinality, top_hits, composite, matrix_stats, the host metrics,
# date_histogram) over the cfg7 corpus with a date and a boolean column
# ---------------------------------------------------------------------------

AGG_EXT_REPS = 3  # timed sequential requests of each aggs-ext body
EXT_EDGE_DOCS = 5  # docs a shard plants within 60 s of each month edge
EXT_MONTHS = [(y, m) for y in (2023, 2024, 2025) for m in range(1, 13)]
DAY_MS = 86_400_000


def _utc_ms(*ymd_hms) -> float:
    from datetime import datetime, timezone

    return datetime(*ymd_hms, tzinfo=timezone.utc).timestamp() * 1000.0


def _ext_columns(rng, n: int):
    """(ts, flag) for one shard: ts epoch milliseconds drawn evenly over
    2023-01-01 .. 2025-12-31 UTC, EXT_EDGE_DOCS docs within 60 s of each
    of the 36 month edges, ~2 % missing; flag a boolean (1.0 / 0.0), 30 %
    true."""
    import numpy as np

    ts = np.round(rng.uniform(_utc_ms(2023, 1, 1), _utc_ms(2025, 12, 31), n))
    edges = np.repeat([_utc_ms(y, m, 1) for y, m in EXT_MONTHS],
                      EXT_EDGE_DOCS)
    at = rng.choice(n, size=len(edges), replace=False)
    ts[at] = edges + rng.integers(-60_000, 60_001, len(edges))
    ts[rng.random(n) < 0.02] = np.nan
    flag = (rng.random(n) < 0.3).astype(np.float64)
    return ts, flag


def _ext_bodies(match_terms):
    """(family, body) of phase aggs-ext's bodies, by name."""
    match = {"match": {"body": " ".join(match_terms)}}
    sig = {"field": "tag", "min_doc_count": 1}
    top2 = {"th": {"top_hits": {"size": 2}}}
    return {
        "sig_jlh": ("significant_terms", {"query": match, "size": 0, "aggs": {
            "s": {"significant_terms": sig, "aggs": {
                "st": {"stats": {"field": "price"}},
                "th": {"top_hits": {"size": 3}}}}}}),
        "sig_chi_square_negatives": ("significant_terms", {
            "query": match, "size": 0, "aggs": {"s": {"significant_terms": {
                **sig, "chi_square": {"include_negatives": True}}}}}),
        "sig_chi_square": ("significant_terms", {
            "query": match, "size": 0, "aggs": {"s": {"significant_terms": {
                "field": "tag", "chi_square": {}}}}}),
        "sig_percentage": ("significant_terms", {
            "query": match, "size": 0, "aggs": {"s": {"significant_terms": {
                **sig, "percentage": {}}}}}),
        "sig_under_filter": ("significant_terms", {
            "query": match, "size": 0, "aggs": {"f": {
                "filter": {"term": {"flag": True}},
                "aggs": {"s": {"significant_terms": sig}}}}}),
        "rare_price": ("rare_terms", {"size": 0, "aggs": {
            "r": {"rare_terms": {"field": "price", "max_doc_count": 72}}}}),
        "rare_tag": ("rare_terms", {"query": match, "size": 0, "aggs": {
            "r": {"rare_terms": {"field": "tag",
                                 "max_doc_count": 1_000_000}}}}),
        "cardinality": ("cardinality", {"size": 0, "aggs": {
            "tag": {"cardinality": {"field": "tag"}},
            "price": {"cardinality": {"field": "price"}},
            "flag": {"cardinality": {"field": "flag"}}}}),
        "cardinality_ts": ("cardinality", {"query": match, "size": 0, "aggs": {
            "ts": {"cardinality": {"field": "ts"}}}}),
        "top_hits": ("top_hits", {"query": match, "size": 0, "aggs": {
            "th": {"top_hits": {"size": 5}},
            "paged": {"top_hits": {"size": 3, "from": 2,
                                   "_source": False}}}}),
        "top_hits_terms": ("top_hits", {"query": match, "size": 0, "aggs": {
            "t": {"terms": {"field": "tag"}, "aggs": top2}}}),
        "top_hits_month": ("top_hits", {"query": match, "size": 0, "aggs": {
            "d": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "month"},
                  "aggs": {"th": {"top_hits": {"size": 1}}}}}}),
        "top_hits_range": ("top_hits", {"query": match, "size": 0, "aggs": {
            "r": {"range": {"field": "price", "ranges": [
                {"to": 2500}, {"from": 2500, "to": 7500}, {"from": 7500}]},
                  "aggs": top2}}}),
        "top_hits_filter": ("top_hits", {"query": match, "size": 0, "aggs": {
            "f": {"filter": {"term": {"flag": True}}, "aggs": {
                "th": {"top_hits": {"size": 3}},
                "t": {"terms": {"field": "tag"}, "aggs": top2}}}}}),
        "matrix_stats": ("host_metrics", {"query": match, "size": 0, "aggs": {
            "m": {"matrix_stats": {"fields": ["price", "ts", "flag"]}}}}),
        "host_metrics": ("host_metrics", {"size": 0, "aggs": {
            "p": {"percentiles": {"field": "price"}},
            "pr": {"percentile_ranks": {"field": "price",
                                        "values": [100, 5000, 9990]}},
            "es": {"extended_stats": {"field": "price"}},
            "mad": {"median_absolute_deviation": {"field": "price"}}}}),
        "date_1d": ("date_histogram", {"size": 0, "aggs": {
            "d": {"date_histogram": {"field": "ts", "fixed_interval": "1d"}}}}),
        "date_12h": ("date_histogram", {"size": 0, "aggs": {
            "d": {"date_histogram": {"field": "ts",
                                     "fixed_interval": "12h"}}}}),
        "date_month": ("date_histogram", {"size": 0, "aggs": {
            "d": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "month"},
                  "aggs": {"s": {"sum": {"field": "price"}}}}}}),
        "date_quarter": ("date_histogram", {"size": 0, "aggs": {
            "d": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "quarter"}}}}),
        "date_year": ("date_histogram", {"size": 0, "aggs": {
            "d": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "year"}}}}),
        "terms_price": ("terms", {"size": 0, "aggs": {
            "t": {"terms": {"field": "price"}}}}),
        "terms_flag": ("terms", {"size": 0, "aggs": {
            "t": {"terms": {"field": "flag"}}}}),
        "date_range_query": ("date_query", {
            "query": {"range": {"ts": {"gte": "2024-03-01",
                                       "lt": "2024-09-01T12:00:00Z"}}},
            "size": 10, "sort": [{"ts": "desc"}],
            "aggs": {"d": {"date_histogram": {
                "field": "ts", "calendar_interval": "month"}}}}),
        "sort_ts": ("date_query", {"query": match, "size": 10,
                                   "sort": [{"ts": "asc"}]}),
    }


def _ext_composite(match_terms, after=None) -> dict:
    comp = {"size": 500, "sources": [
        {"tag": {"terms": {"field": "tag"}}},
        {"week": {"date_histogram": {"field": "ts",
                                     "calendar_interval": "week"}}},
        {"price": {"histogram": {"field": "price", "interval": 2500}}}]}
    if after is not None:
        comp["after"] = after
    return {"query": {"match": {"body": " ".join(match_terms)}}, "size": 0,
            "aggs": {"c": {"composite": comp,
                           "aggs": {"a": {"avg": {"field": "price"}}}}}}


class _Rel:
    """An expected float that an answer matches within rtol 1e-5 (K10's
    f32 bucket sums)."""

    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return f"~{self.value!r}"


def _ext_equal(got, want) -> bool:
    import math

    if isinstance(want, _Rel):
        return (isinstance(got, float)
                and math.isclose(got, want.value, rel_tol=1e-5))
    if isinstance(want, dict):
        return (isinstance(got, dict) and set(got) == set(want)
                and all(_ext_equal(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_ext_equal(g, w) for g, w in zip(got, want)))
    return got == want and type(got) is type(want)


def _iso(ms: float) -> str:
    from datetime import datetime, timezone

    dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def _date_ms(text: str) -> float:
    from datetime import datetime, timezone

    dt = datetime.fromisoformat(text.replace("Z", "+00:00"))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp() * 1000.0


class ExtOracle:
    """Phase aggs-ext's answers from the host columns in numpy: each
    query's mask (match: the union of the terms' postings; a date range
    on the f32 stored values) and BM25 scores (ops/bm25's numpy scorer
    with the node's statistics), then every aggregation kind as its
    semantics define it. Counts, keys, bg counts, significance scores,
    hit ids and order and the f64 host metrics are exact; K10's f32
    bucket sums (a terms or date_histogram sub-metric sum) within rtol
    1e-5."""

    def __init__(self, segs, stats, index):
        self.segs, self.stats, self.index = segs, stats, index

    # -- contexts -------------------------------------------------------

    def masks(self, query):
        import numpy as np

        if query is None or "match_all" in query:
            return [np.ones(s.num_docs, dtype=bool) for s in self.segs]
        if "match" in query:
            return [_term_mask(s, "body", query["match"]["body"].split())
                    for s in self.segs]
        (field, bounds), = query["range"].items()
        lo = np.float32(_date_ms(bounds["gte"]))
        hi = np.float32(_date_ms(bounds["lt"]))
        return [(s.doc_values[field].astype(np.float32) >= lo)
                & (s.doc_values[field].astype(np.float32) < hi)
                for s in self.segs]

    def scores(self, query):
        import numpy as np

        from elasticsearch_tpu_torch.ops import bm25

        if query is None or "match" not in query:
            return [np.ones(s.num_docs, dtype=np.float32) for s in self.segs]
        terms = query["match"]["body"].split()
        return [bm25.score_terms_dense(s.fields["body"], terms, s.num_docs,
                                       stats=self.stats) for s in self.segs]

    def values(self, masks, field):
        import numpy as np

        out = []
        for s, m in zip(self.segs, masks):
            v = s.doc_values[field][m]
            out.append(v[~np.isnan(v)])
        return out

    # -- kinds ----------------------------------------------------------

    def top_hits(self, p, members, scores):
        import numpy as np

        size, frm = int(p.get("size", 3)), int(p.get("from", 0))
        cands, total = [], 0
        for si, (seg, m, sc) in enumerate(zip(self.segs, members, scores)):
            locs = np.flatnonzero(m)
            total += len(locs)
            s64 = sc[locs].astype(np.float64)
            for i in np.lexsort((locs, -s64))[:frm + size]:
                cands.append((-float(s64[i]), int(locs[i]), si))
        cands.sort()
        hits = [{"_index": self.index, "_id": self.segs[si].ids[d],
                 "_score": -neg} for neg, d, si in cands[frm:frm + size]]
        return {"hits": {"total": {"value": total, "relation": "eq"},
                         "max_score": -cands[0][0] if cands else None,
                         "hits": hits}}

    def stats_of(self, vals, rel=False):
        """stats over per-segment f64 value arrays; `rel`: a K10 bucket
        plane (f32 sums, compared within rtol 1e-5)."""
        import numpy as np

        count = sum(len(v) for v in vals)
        total = sum(float(np.sum(v)) for v in vals)
        lo = min((float(np.min(v)) for v in vals if len(v)), default=None)
        hi = max((float(np.max(v)) for v in vals if len(v)), default=None)
        wrap = _Rel if rel else float
        return {"count": count, "min": lo, "max": hi,
                "avg": wrap(total / count) if count else None,
                "sum": wrap(total)}

    def subs(self, spec, members, scores, members32=None):
        """A bucket's sub-aggregations: top_hits over `members` (the host
        f64 membership), K10's metric planes over `members32` (the device
        f32 membership, where it differs)."""
        m32 = members if members32 is None else members32
        out = {}
        for name, sub in (spec.get("aggs") or {}).items():
            kind, p = next(iter(sub.items()))
            if kind == "top_hits":
                out[name] = self.top_hits(p, members, scores)
            elif kind == "stats":
                out[name] = self.stats_of(self.values(m32, p["field"]),
                                          rel=True)
            elif kind == "sum":
                vals = self.values(m32, p["field"])
                out[name] = {"value": _Rel(sum(float(v.sum()) for v in vals))}
        return out

    def significant_terms(self, spec, masks, scores):
        import numpy as np

        p = spec["significant_terms"]
        field = p["field"]
        heuristic, hp = "jlh", {}
        for h in ("jlh", "chi_square", "percentage"):
            if h in p:
                heuristic, hp = h, p[h]
        subset = int(sum(int(m.sum()) for m in masks))
        superset = int(sum(s.num_docs for s in self.segs))
        fg, bg = {}, {}
        for s, m in zip(self.segs, masks):
            f = s.fields[field]
            for term, tid in f.terms.items():
                docs = f.doc_ids[f.offsets[tid]:f.offsets[tid + 1]]
                fg[term] = fg.get(term, 0) + int(m[docs].sum())
                bg[term] = bg.get(term, 0) + int(f.df[tid])
        n_sub, n_sup = max(subset, 1), max(superset, 1)

        def score(a: int, b: int) -> float:
            fp, bp = a / n_sub, b / n_sup
            if heuristic == "percentage":
                return a / b if b > 0 else 0.0
            if heuristic == "chi_square":
                if not hp.get("include_negatives", False) and fp < bp:
                    return 0.0
                x, y = a, b - a
                z, w = n_sub - a, n_sup - b - (n_sub - a)
                den = (x + y) * (z + w) * (x + z) * (y + w)
                return ((x * w - y * z) ** 2 * (x + y + z + w)) / den \
                    if den > 0 else 0.0
            if fp <= bp or bp == 0:
                return 0.0
            return (fp - bp) * (fp / bp)

        kept = []
        for term, a in fg.items():
            if a < int(p.get("min_doc_count", 3)):
                continue
            sc = score(a, bg[term])
            if sc > 0:
                kept.append((-sc, term))
        kept.sort()
        buckets = []
        for neg, term in kept[:int(p.get("size", 10))]:
            members = [m & _term_mask(s, field, [term])
                       for s, m in zip(self.segs, masks)]
            buckets.append({"key": term, "doc_count": fg[term],
                            "score": -neg, "bg_count": bg[term],
                            **self.subs(spec, members, scores)})
        return {"doc_count": subset, "bg_count": superset,
                "buckets": buckets}

    def terms(self, spec, masks, scores):
        """keyword terms (with subs), or numeric / boolean terms over the
        host columns."""
        import numpy as np

        p = spec["terms"]
        field = p["field"]
        counts = {}
        if field in self.segs[0].fields:
            for s, m in zip(self.segs, masks):
                f = s.fields[field]
                for term, tid in f.terms.items():
                    docs = f.doc_ids[f.offsets[tid]:f.offsets[tid + 1]]
                    counts[term] = counts.get(term, 0) + int(m[docs].sum())
            counts = {k: c for k, c in counts.items() if c}
        else:
            vals, cnt = np.unique(np.concatenate(self.values(masks, field)),
                                  return_counts=True)
            counts = {float(v): int(c) for v, c in zip(vals, cnt)}
        items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        top = items[:int(p.get("size", 10))]
        buckets = []
        for key, c in top:
            b = {"key": int(key) if field == "price" else key, "doc_count": c}
            if spec.get("aggs"):
                members = [m & _term_mask(s, field, [key])
                           for s, m in zip(self.segs, masks)]
                b.update(self.subs(spec, members, scores))
            buckets.append(b)
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": sum(counts.values())
                - sum(c for _, c in top),
                "buckets": buckets}

    def rare_terms(self, p, masks):
        import numpy as np

        field = p["field"]
        if field in self.segs[0].fields:
            counts = self.terms({"terms": {"field": field, "size": 1 << 30}},
                                masks, None)
            items = [(b["key"], b["doc_count"]) for b in counts["buckets"]]
        else:
            vals, cnt = np.unique(np.concatenate(self.values(masks, field)),
                                  return_counts=True)
            items = [(int(v), int(c)) for v, c in zip(vals, cnt)]
        items = sorted(((k, c) for k, c in items
                        if c <= int(p.get("max_doc_count", 1))),
                       key=lambda kv: (kv[1], kv[0]))
        return {"buckets": [{"key": k, "doc_count": c}
                            for k, c in items[:10_000]]}

    def cardinality(self, p, masks):
        import numpy as np

        field = p["field"]
        if field in self.segs[0].fields:
            seen = set()
            for s, m in zip(self.segs, masks):
                f = s.fields[field]
                for term, tid in f.terms.items():
                    if m[f.doc_ids[f.offsets[tid]:f.offsets[tid + 1]]].any():
                        seen.add(term)
            return {"value": len(seen)}
        return {"value": int(np.unique(
            np.concatenate(self.values(masks, field))).size)}

    def date_histogram(self, spec, masks, scores):
        """Fixed intervals: the global f32 window and f32 bucket index of
        the device plan; calendar units: UTC edges from the f32 minimum,
        counted on the f32 column against f32 edges; a top_hits sub's
        members test the f64 column against the f64 edges."""
        import math
        from datetime import datetime, timezone

        import numpy as np

        p = spec["date_histogram"]
        field = p["field"]
        cols = [s.doc_values[field] for s in self.segs]
        lo = min(float(np.float32(np.nanmin(c))) for c in cols)
        hi = max(float(np.float32(np.nanmax(c))) for c in cols)
        unit = p.get("calendar_interval") or p.get("fixed_interval")
        fixed = {"1d": DAY_MS, "12h": DAY_MS / 2}.get(unit)
        if fixed is not None:
            base = math.floor(lo / fixed)
            nb = int(math.floor(hi / fixed) - base) + 1
            nb_pad = 1 << (nb - 1).bit_length()
            counts = np.zeros(nb_pad, np.int64)
            for c, m in zip(cols, masks):
                rel = (np.floor(c.astype(np.float32) / np.float32(fixed))
                       - np.float32(base))
                ok = m & ~np.isnan(c) & (rel >= 0) & (rel < nb_pad)
                counts += np.bincount(rel[ok].astype(np.int64),
                                      minlength=nb_pad)
            edges = [(base + i) * fixed for i in range(nb_pad + 1)]
        else:
            step = {"month": 1, "quarter": 3, "year": 12}[unit]
            start = datetime.fromtimestamp(lo / 1000.0, tz=timezone.utc)
            y, mo = start.year, ((start.month - 1) // step) * step + 1
            edges = []
            while True:
                edges.append(_utc_ms(y, mo, 1))
                if edges[-1] > hi:
                    break
                mo += step
                y, mo = y + (mo - 1) // 12, (mo - 1) % 12 + 1
            counts = np.zeros(len(edges) - 1, np.int64)
            for c, m in zip(cols, masks):
                c32 = c.astype(np.float32)
                for i in range(len(edges) - 1):
                    counts[i] += int((m & (c32 >= np.float32(edges[i]))
                                      & (c32 < np.float32(edges[i + 1]))).sum())
        occ = np.flatnonzero(counts)
        buckets = []
        for i in range(int(occ[0]), int(occ[-1]) + 1) if len(occ) else ():
            b = {"key_as_string": _iso(edges[i]), "key": int(edges[i]),
                 "doc_count": int(counts[i])}
            if spec.get("aggs"):
                members = [m & (c >= edges[i]) & (c < edges[i + 1])
                           for c, m in zip(cols, masks)]
                members32 = [
                    m & (c.astype(np.float32) >= np.float32(edges[i]))
                    & (c.astype(np.float32) < np.float32(edges[i + 1]))
                    for c, m in zip(cols, masks)]
                b.update(self.subs(spec, members, scores, members32))
            buckets.append(b)
        return {"buckets": buckets}

    def range_agg(self, spec, masks, scores):
        import numpy as np

        p = spec["range"]
        buckets = []
        for r in p["ranges"]:
            lo, hi = r.get("from"), r.get("to")
            b = {"key": f"{'*' if lo is None else float(lo)}-"
                        f"{'*' if hi is None else float(hi)}"}
            if lo is not None:
                b["from"] = float(lo)
            if hi is not None:
                b["to"] = float(hi)
            cols = [s.doc_values[p["field"]] for s in self.segs]
            lo32 = np.float32(-np.inf if lo is None else lo)
            hi32 = np.float32(np.inf if hi is None else hi)
            members32 = [m & (c.astype(np.float32) >= lo32)
                         & (c.astype(np.float32) < hi32)
                         for c, m in zip(cols, masks)]
            b["doc_count"] = sum(int(m.sum()) for m in members32)
            members = [m & (c >= (-np.inf if lo is None else lo))
                       & (c < (np.inf if hi is None else hi))
                       for c, m in zip(cols, masks)]
            b.update(self.subs(spec, members, scores, members32))
            buckets.append(b)
        return {"buckets": buckets}

    def host_metric(self, kind, p, masks):
        import numpy as np

        vals = self.values(masks, p["field"])
        flat = np.sort(np.concatenate(vals))

        def label(v):
            return f"{v:g}.0" if float(v).is_integer() else f"{v:g}"

        if kind == "percentiles":
            pct = p.get("percents", (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0))
            return {"values": {label(float(q)): float(np.percentile(
                flat, float(q), method="linear")) for q in pct}}
        if kind == "percentile_ranks":
            return {"values": {label(float(v)): float(np.searchsorted(
                flat, float(v), side="right")) / len(flat) * 100.0
                for v in p["values"]}}
        if kind == "median_absolute_deviation":
            med = float(np.median(flat))
            return {"value": float(np.median(np.abs(flat - med)))}
        count = sum(len(v) for v in vals)
        total = sumsq = 0.0
        for v in vals:
            total += float(np.sum(v))
            sumsq += float(np.sum(v * v))
        mean = total / count
        var = max(0.0, sumsq / count - mean * mean)
        std = float(np.sqrt(var))
        return {"count": count, "min": float(flat[0]), "max": float(flat[-1]),
                "avg": mean, "sum": total, "sum_of_squares": sumsq,
                "variance": var, "std_deviation": std,
                "std_deviation_bounds": {"upper": mean + 2.0 * std,
                                         "lower": mean - 2.0 * std}}

    def matrix_stats(self, fields, masks):
        """Per-field moments from power sums about the first complete
        row's values, folded segment by segment; covariance and
        correlation from the cross products."""
        import numpy as np

        n, pivot = 0, None
        s1 = s2 = s3 = s4 = cross = 0.0
        for s, m in zip(self.segs, masks):
            cols = [s.doc_values[f].astype(np.float64) for f in fields]
            rows = m.copy()
            for c in cols:
                rows &= ~np.isnan(c)
            if not rows.any():
                continue
            x = np.stack([c[rows] for c in cols])
            if pivot is None:
                pivot = x[:, 0].copy()
                s1 = s2 = s3 = s4 = np.zeros(len(fields))
                cross = np.zeros((len(fields), len(fields)))
            x = x - pivot[:, None]
            n += int(x.shape[1])
            s1 = s1 + x.sum(axis=1)
            s2 = s2 + (x ** 2).sum(axis=1)
            s3 = s3 + (x ** 3).sum(axis=1)
            s4 = s4 + (x ** 4).sum(axis=1)
            cross = cross + x @ x.T
        mu = s1 / n
        m2 = np.maximum(s2 / n - mu ** 2, 0.0)
        m3 = s3 / n - 3 * mu * s2 / n + 2 * mu ** 3
        m4 = s4 / n - 4 * mu * s3 / n + 6 * mu ** 2 * s2 / n - 3 * mu ** 4
        std = np.sqrt(m2)
        cov_pop = cross / n - np.outer(mu, mu)
        out = []
        for i, f in enumerate(fields):
            out.append({
                "name": f, "count": n, "mean": float(pivot[i] + mu[i]),
                "variance": float(m2[i] * n / max(n - 1, 1)),
                "skewness": float(m3[i] / std[i] ** 3) if std[i] > 0 else 0.0,
                "kurtosis": float(m4[i] / m2[i] ** 2) if m2[i] > 0 else 0.0,
                "covariance": {g: float(cov_pop[i, j] * n / max(n - 1, 1))
                               for j, g in enumerate(fields)},
                "correlation": {g: float(cov_pop[i, j] / (std[i] * std[j]))
                                if std[i] * std[j] > 0 else 0.0
                                for j, g in enumerate(fields)}})
        return {"doc_count": n, "fields": out}

    def composite(self, body):
        """Every bucket of the composite body (keys in source order,
        ascending), its doc count and f64 avg sub-metric, then the page
        after body's `after`."""
        import numpy as np

        comp = body["aggs"]["c"]["composite"]
        masks = self.masks(body.get("query"))
        acc = {}
        for s, m in zip(self.segs, masks):
            tag = np.full(s.num_docs, -1)
            f = s.fields["tag"]
            tag[f.doc_ids] = np.repeat(np.arange(len(f.terms)),
                                       np.diff(f.offsets))
            vocab = sorted(f.terms, key=f.terms.get)
            ts, price = s.doc_values["ts"], s.doc_values["price"]
            ok = m & (tag >= 0) & ~np.isnan(ts) & ~np.isnan(price)
            week = np.floor(ts[ok] / 604_800_000.0) * 604_800_000.0
            band = np.floor(price[ok] / 2500.0) * 2500.0
            rows = np.stack([tag[ok], week, band], axis=1)
            uniq, inv = np.unique(rows, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            cnt = np.bincount(inv, minlength=len(uniq))
            tot = np.zeros(len(uniq))
            np.add.at(tot, inv, price[ok])
            for i, (t, w, b) in enumerate(uniq):
                key = (vocab[int(t)], int(w), int(b))
                c, sm = acc.get(key, (0, 0.0))
                acc[key] = (c + int(cnt[i]), sm + float(tot[i]))
        items = sorted(acc.items())
        after = comp.get("after")
        if after:
            cut = (after["tag"], after["week"], after["price"])
            items = [it for it in items if it[0] > cut]
        page = items[:comp["size"]]
        buckets = [{"key": {"tag": k[0], "week": k[1], "price": k[2]},
                    "doc_count": c, "a": {"value": sm / c}}
                   for k, (c, sm) in page]
        out = {"buckets": buckets}
        if page and len(items) > comp["size"]:
            out["after_key"] = buckets[-1]["key"]
        return out

    def sorted_hits(self, body, masks):
        import numpy as np

        (field, order), = body["sort"][0].items()
        rows = []
        for si, (s, m) in enumerate(zip(self.segs, masks)):
            v = s.doc_values[field].astype(np.float32)
            locs = np.flatnonzero(m)
            key = np.where(np.isnan(v[locs]), np.inf,
                           -v[locs] if order == "desc" else v[locs])
            for i in np.lexsort((locs, key.astype(np.float64)))[:body["size"]]:
                d = int(locs[i])
                rows.append((float(key[i]), si, d,
                             None if np.isnan(v[d]) else float(v[d])))
        rows.sort()
        return [(self.segs[si].ids[d], [val])
                for _k, si, d, val in rows[:body["size"]]]

    # -- one answer -----------------------------------------------------

    def check(self, body, out) -> bool:
        masks = self.masks(body.get("query"))
        total = sum(int(m.sum()) for m in masks)
        if out["hits"]["total"]["value"] != min(total, 10_000):
            return False
        if body.get("sort"):
            got = [(h["_id"], h["sort"]) for h in out["hits"]["hits"]]
            if got != self.sorted_hits(body, masks):
                return False
        aggs = body.get("aggs") or {}
        if "composite" in aggs.get("c", {}):
            want = {"c": self.composite(body)}
        else:
            scores = self.scores(body.get("query"))
            want = {name: self.one(spec, masks, scores)
                    for name, spec in aggs.items()}
        return _ext_equal(out.get("aggregations", {}), want) if want else True

    def one(self, spec, masks, scores):
        kind = next(k for k in spec if k != "aggs")
        p = spec[kind]
        if kind == "significant_terms":
            return self.significant_terms(spec, masks, scores)
        if kind == "terms":
            return self.terms(spec, masks, scores)
        if kind == "rare_terms":
            return self.rare_terms(p, masks)
        if kind == "cardinality":
            return self.cardinality(p, masks)
        if kind == "top_hits":
            return self.top_hits(p, masks, scores)
        if kind == "date_histogram":
            return self.date_histogram(spec, masks, scores)
        if kind == "range":
            return self.range_agg(spec, masks, scores)
        if kind == "matrix_stats":
            return self.matrix_stats(p["fields"], masks)
        if kind == "filter":
            (field, value), = p["term"].items()
            sub = [m & (s.doc_values[field] == float(value))
                   for s, m in zip(self.segs, masks)]
            return {"doc_count": sum(int(m.sum()) for m in sub),
                    **{n: self.one(sp, sub, scores)
                       for n, sp in spec["aggs"].items()}}
        return self.host_metric(kind, p, masks)


class ReadbackTimer:
    """Host time of every aggs._to_host call while installed: the device
    result trees' readback (top_hits' [N] mask and score planes among
    them)."""

    def __init__(self):
        from elasticsearch_tpu_torch.search import aggs

        self.mod = aggs
        self.real = aggs._to_host
        self.ms: list = []

    def __enter__(self):
        def timed(tree):
            t0 = time.perf_counter()
            out = self.real(tree)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.mod._to_host = timed
        return self

    def __exit__(self, *exc):
        self.mod._to_host = self.real


def run_aggs_ext(card, node, shards, whole, one, match_terms, launches,
                 rows) -> dict:
    """Phase aggs-ext on the aggs phase's node: the bodies of _ext_bodies
    and the composite walked to its end with `after`, on the 8-shard and
    the one-shard index, over HTTP. Each body once untimed, then
    AGG_EXT_REPS times sequentially (round robin), the composite walk
    inside the same counted run; every first answer against the same
    body served with plain_kernels() (the whole JSON but `took`) and
    against ExtOracle, every repeat against the first. Per family p50 /
    p99 ms, device ms per request (CUDA events around execute_aggs), host
    ms per request (the rest) and readback ms; then K10's rows at the
    phase's widest launches on the one-shard index."""
    from elasticsearch_tpu_torch.search.service import SearchRequest

    t_phase = time.monotonic()
    bodies = _ext_bodies(match_terms)
    names = list(bodies)
    result = {}
    for index, segs in (("cfg7", shards), ("cfg7one", [whole])):
        svc = node.indices[index]
        stats = (svc.search.global_stats() if len(segs) > 1
                 else svc.engines[0].field_stats())["body"]
        oracle = ExtOracle(segs, stats, index)
        server, base = serve(node)
        try:
            for nm in names:  # one untimed warm-up request per body
                http(base, "POST", f"/{index}/_search", bodies[nm][1])
            lat, resp, marks, reads = [], [], [], []
            with counted(f"aggs-ext {index}", launches), AggTimer() as timer, \
                    ReadbackTimer() as rb:
                for _rep in range(AGG_EXT_REPS):
                    for nm in names:
                        e0, r0 = len(timer.events), len(rb.ms)
                        t0 = time.monotonic()
                        resp.append(http(base, "POST", f"/{index}/_search",
                                         bodies[nm][1]))
                        lat.append((time.monotonic() - t0) * 1e3)
                        marks.append((e0, len(timer.events)))
                        reads.append(sum(rb.ms[r0:]))
                pages, page_bodies, after = [], [], None
                while True:
                    page_bodies.append(_ext_composite(match_terms, after))
                    t0 = time.monotonic()
                    pages.append(http(base, "POST", f"/{index}/_search",
                                      page_bodies[-1]))
                    lat.append((time.monotonic() - t0) * 1e3)
                    after = pages[-1]["aggregations"]["c"].get("after_key")
                    if after is None:
                        break
        finally:
            server.shutdown()
            server.server_close()
        dev_ms = [sum(a.elapsed_time(b) for a, b in timer.events[e0:e1])
                  for e0, e1 in marks]
        first = resp[:len(names)]
        checked = list(zip([bodies[n][1] for n in names], first)) + list(
            zip(page_bodies, pages))
        vs_plain = vs_oracle = 0
        with plain_kernels():
            for body, out in checked:
                want = svc.search.search(
                    SearchRequest.from_json(body)).to_json(index)
                if without_took(json.loads(json.dumps(want))) != \
                        without_took(out):
                    vs_plain += 1
                    log(f"  MISMATCH aggs-ext {index} plain path "
                        f"{json.dumps(body)[:200]}")
        for body, out in checked:
            if not oracle.check(body, out):
                vs_oracle += 1
                log(f"  MISMATCH aggs-ext {index} oracle "
                    f"{json.dumps(body)[:200]}: "
                    f"{json.dumps(out.get('aggregations'))[:600]}")
        vs_first = sum(without_took(out) != without_took(first[i % len(names)])
                       for i, out in enumerate(resp))
        # month buckets whose f32 doc_count and f64 top_hits membership
        # differ (documents within 60 s of an edge)
        month = first[names.index("top_hits_month")]["aggregations"]["d"]
        split = sum(b["th"]["hits"]["total"]["value"] != b["doc_count"]
                    for b in month["buckets"])
        n = len(names)
        families = {}
        for j, nm in enumerate(names):
            families.setdefault(bodies[nm][0], []).append(j)
        per_family = {}
        for fam, js in families.items():
            idx = [r * n + j for r in range(AGG_EXT_REPS) for j in js]
            per_family[fam] = {
                "bodies": len(js),
                "p50_ms": percentile([lat[i] for i in idx], 50),
                "p99_ms": percentile([lat[i] for i in idx], 99),
                "device_ms_per_request": sum(dev_ms[i] for i in idx) / len(idx),
                "host_ms_p50": percentile([lat[i] - dev_ms[i] for i in idx], 50),
                "readback_ms_p50": percentile([reads[i] for i in idx], 50),
            }
        page_lat = lat[len(resp):]
        per_family["composite"] = {
            "pages": len(pages), "p50_ms": percentile(page_lat, 50),
            "p99_ms": percentile(page_lat, 99),
            "buckets": sum(len(p["aggregations"]["c"]["buckets"])
                           for p in pages)}
        stats_out = {
            "requests": len(resp) + len(pages),
            "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
            "device_ms_per_request": sum(dev_ms) / len(dev_ms),
            "host_ms_per_request": (sum(lat[:len(resp)]) - sum(dev_ms))
            / len(dev_ms),
            "per_family": per_family,
            "month_buckets_f32_f64_split": split,
            "mismatches_vs_plain": vs_plain,
            "mismatches_vs_oracle": vs_oracle,
            "mismatches_vs_first": vs_first,
        }
        bad = vs_plain + vs_oracle + vs_first
        log(f"phase aggs-ext {index}: {'ok' if bad == 0 else 'FAILED'} "
            f"{json.dumps(stats_out)} [{card}]")
        if bad:
            raise SmokeFailure(f"{bad} mismatches in phase aggs-ext {index}")
        result[index] = stats_out
    kernel_rows_aggs_ext(node.indices["cfg7one"].engines[0], one,
                         bodies["sig_jlh"][1], rows)
    result["phase_s"] = time.monotonic() - t_phase
    log(f"phase aggs-ext: ok {result['phase_s']:.1f} s [{card}]")
    return result


def kernel_rows_aggs_ext(engine, handle, sig_body, rows):
    """K10 at phase aggs-ext's widest launches on the one-shard index
    (1,000,000 docs): terms-count mode over the tag postings under
    sig_jlh's match mask (significant_terms), range mode over the 37
    month edges of `ts` with the price sum (R > 32: two groups of 32
    ranges), and scatter mode for the 1d date_histogram (counts). Each
    held to its plain version bit for bit, beside its byte bound and one
    library call (torch.bincount; a masked [R, N] sum, amin, amax)."""
    import math
    from datetime import datetime, timezone

    import torch

    from elasticsearch_tpu_torch.ops import aggs_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    tree = aggs_device.agg_segment_tree(handle.device)
    live = tree["live"]
    n = live.shape[0]
    dev = live.device
    compiled = engine.compiler_for(handle).compile(
        parse_query(sig_body["query"]))
    _tot, res = aggs_device.execute_aggs(tree, compiled.spec, compiled.arrays,
                                         (("hits_planes",),), ({},))
    mask = res[0]["mask"]
    _docs, ords, m = aggs_device._posting_matched(tree, "tag", mask, n)
    tp = 1 << (len(AGG_TAGS) - 1).bit_length()
    p = ords.shape[0]
    idx = torch.where(m, ords, tp).long()
    _row(rows, "bucket_fold", "elasticsearch_tpu/ops/aggs_device.py:165", 1,
         lambda: (kern.bucket_fold(ords, m, tp),),
         lambda: (kern.bucket_fold_plain(ords, m, tp),),
         lambda: torch.bincount(idx, minlength=tp + 1), "torch.bincount",
         p * 5 + tp * 4, source=AGG_SOURCE,
         case=f"sig_terms counts over the tag postings, {p:,} rows")

    ts, price = tree["doc_values"]["ts"], tree["doc_values"]["price"]
    lo_v = float(torch.nan_to_num(ts, nan=float("inf")).min())
    hi_v = float(torch.nan_to_num(ts, nan=float("-inf")).max())
    start = datetime.fromtimestamp(lo_v / 1000.0, tz=timezone.utc)
    y, mo, edges = start.year, start.month, []
    while True:
        edges.append(_utc_ms(y, mo, 1))
        if edges[-1] > hi_v:
            break
        y, mo = y + mo // 12, mo % 12 + 1
    r = len(edges) - 1
    if r <= 32:
        raise SmokeFailure(f"aggs-ext month edges: {r} ranges, want > 32")
    lo = torch.tensor(edges[:-1], dtype=torch.float64, device=dev).float()
    hi = torch.tensor(edges[1:], dtype=torch.float64, device=dev).float()
    f32max = torch.tensor(kern.F32_MAX, device=dev)

    def range_library():
        member = (live[None, :] & (ts[None, :] >= lo[:, None])
                  & (ts[None, :] < hi[:, None]) & ~torch.isnan(price)[None, :])
        return (torch.where(member, price[None, :], 0.0).sum(dim=1),
                torch.where(member, price[None, :], f32max).amin(dim=1),
                torch.where(member, price[None, :], -f32max).amax(dim=1))

    _row(rows, "bucket_fold_range", "elasticsearch_tpu/ops/aggs_device.py:217",
         r, lambda: kern.range_fold(ts, live, lo, hi, sub=price),
         lambda: kern.range_fold_plain(ts, live, lo, hi, sub=price),
         range_library, "masked [R, N] sum, amin, amax", n * 9 + r * 20,
         source=AGG_SOURCE, reps=10,
         case=f"{r} month ranges of ts (R > 32) + price sum, {n:,} docs")

    interval = float(DAY_MS)
    base = math.floor(lo_v / interval)
    nb = int(math.floor(hi_v / interval) - base) + 1
    nb_pad = 1 << (nb - 1).bit_length()
    rel = (torch.floor((ts - torch.tensor(0.0, device=dev))
                       / torch.tensor(interval, device=dev))
           - torch.tensor(float(base), device=dev))
    rel = torch.clamp(torch.nan_to_num(rel, nan=0.0), -1, nb_pad).to(torch.int32)
    inw = live & ~torch.isnan(ts) & (rel >= 0) & (rel < nb_pad)
    bidx = torch.where(inw, rel, torch.full_like(rel, nb_pad))
    _row(rows, "bucket_fold", "elasticsearch_tpu/ops/aggs_device.py:191", 1,
         lambda: (kern.bucket_fold(bidx, inw, nb_pad),),
         lambda: (kern.bucket_fold_plain(bidx, inw, nb_pad),),
         lambda: torch.bincount(bidx.long(), minlength=nb_pad + 1),
         "torch.bincount", n * 5 + nb_pad * 4, source=AGG_SOURCE, reps=10,
         case=f"date_histogram 1d counts ({nb_pad} buckets), {n:,} docs")
    torch.cuda.synchronize()


NAN_PAGE_SCRIPTS = (
    "doc['f'].value",
    "Math.max(doc['f'].value, 0.0)",
    "Math.min(doc['f'].value, 0.0)",
    "Math.sqrt(doc['f'].value)",
    "Math.log(doc['f'].value)",
    "Math.log10(doc['f'].value)",
    "Math.pow(doc['f'].value, 0.5)",
    "sigmoid(doc['f'].value) * 2 + 1",
)


def _page_diff(card_out, cpu_out):
    """Where two hits pages differ, or None: totals and ids exactly, every
    NaN score or sort value with the same bits (sign and payload), other
    values within rtol = atol = 1e-5 (libdevice's log / exp and the CPU's
    round differently)."""
    import numpy as np

    def same(a, b):
        if a is None or b is None or not isinstance(a, float):
            return a == b
        fa, fb = np.float32(a), np.float32(b)
        if np.isnan(fa) or np.isnan(fb):
            return fa.view(np.uint32) == fb.view(np.uint32)
        return bool(np.isclose(fa, fb, rtol=1e-5, atol=1e-5))

    a, b = card_out["hits"], cpu_out["hits"]
    if a["total"] != b["total"]:
        return f"totals {a['total']} != {b['total']}"
    ids = ([h["_id"] for h in a["hits"]], [h["_id"] for h in b["hits"]])
    if ids[0] != ids[1]:
        return f"ids {ids[0]} != {ids[1]}"
    for ha, hb in zip(a["hits"], b["hits"]):
        va = [ha["_score"], *ha.get("sort", [])]
        vb = [hb["_score"], *hb.get("sort", [])]
        if len(va) != len(vb) or not all(map(same, va, vb)):
            return f"doc {ha['_id']}: score / sort {va} != {vb}"
    return None


def run_nan_pages(card, launches) -> dict:
    """The C1 / C2 bodies on the card: ROADMAP queue C's repro index (48
    docs, `r = i`, `f = (i % 7) - 3`, no `f` where i % 4 == 0) on 1 and
    3 shards; `script_score{range r gte 8, S}` pages (size 48) sorted by
    score descending, by `{"_score": "asc"}` and past an ascending cursor
    on a NaN, with and without a boost, served by the card's node and by
    a CPU node (whose NaN rules the tests hold to the JAX package): ids
    and totals equal, every NaN score and sort value with the same bits,
    the others within 1e-5."""
    from elasticsearch_tpu_torch.node import Node

    t0 = time.monotonic()
    lines = []
    for i in range(48):
        doc = {"r": i}
        if i % 4:
            doc["f"] = float((i % 7) - 3)
        lines += [json.dumps({"index": {"_id": str(i)}}), json.dumps(doc)]
    nodes = [Node(device=DEVICE), Node(device="cpu")]
    pages = bad = 0
    try:
        requests = []
        for shards in (1, 3):
            index = f"nan{shards}"
            body = {"settings": {"index": {"number_of_shards": shards}},
                    "mappings": {"properties": {"r": {"type": "long"},
                                                "f": {"type": "float"}}}}
            for n in nodes:
                n.create_index(index, body)
                n.bulk("\n".join(lines) + "\n", default_index=index,
                       refresh=True)
            for src in NAN_PAGE_SCRIPTS:
                for boost in (None, 2.5):
                    query = {"query": {"range": {"r": {"gte": 8}}},
                             "script": {"source": src}}
                    if boost is not None:
                        query["boost"] = boost
                    base = {"query": {"script_score": query}, "size": 48}
                    for extra in ({}, {"sort": [{"_score": "asc"}]},
                                  {"sort": [{"_score": "asc"}],
                                   "search_after": [float("nan")]}):
                        requests.append((index, {**base, **extra}))
        with counted("nan-pages", launches):
            card_out = [nodes[0].search(i, req) for i, req in requests]
        for (index, req), out in zip(requests, card_out):
            diff = _page_diff(out, nodes[1].search(index, req))
            pages += 1
            if diff is not None:
                bad += 1
                log(f"  MISMATCH nan-pages {index} {json.dumps(req)}: {diff}")
    finally:
        for n in nodes:
            n.close()
    stats = {"pages": pages, "mismatches_vs_cpu": bad,
             "seconds": time.monotonic() - t0}
    log(f"phase nan-pages: {'ok' if bad == 0 else 'FAILED'} {json.dumps(stats)} "
        f"[{card}]")
    if bad:
        raise SmokeFailure(f"{bad} NaN-scored pages differ between the card "
                           f"and the CPU")
    return stats


PHRASE_SOURCES = {
    "position_events": "elasticsearch_tpu_torch/csrc/position_events.cu",
    "position_walk": "elasticsearch_tpu_torch/csrc/position_walk.cu",
}
PHRASE_HEAD = [f"t{i}" for i in range(10)]  # the widest position gathers
PHRASE_ORACLE_PER_SHAPE = 3  # match_phrase bodies a shape held to numpy
PHRASE_COPIES = 1  # copies of each body in the concurrent run


class TokenStream:
    """The token stream of build_zipf_segment's corpus, re-drawn from its
    seed (default_rng(seed) -> lengths, then tokens), as int16 token
    numbers ("t<i>") with each doc's [start, start + length) slice.
    `positions=True` also orders the field's positions from the stream
    alone (`order_positions`), so that a thread can do it while the
    segment is still being built."""

    def __init__(self, n_docs: int, seed: int, vocab_size: int = 30_000,
                 min_len: int = 8, max_len: int = 60, positions: bool = False):
        import numpy as np

        from elasticsearch_tpu_torch.utils.corpus import zipf_probs

        rng = np.random.default_rng(seed)
        self.lengths = rng.integers(min_len, max_len, size=n_docs)
        total = int(self.lengths.sum())
        tokens = rng.choice(vocab_size, size=total, p=zipf_probs(vocab_size))
        if vocab_size >= 2**15:
            raise SmokeFailure("token numbers must fit int16")
        self.tokens = tokens.astype(np.int16)
        del tokens
        self.starts = np.cumsum(self.lengths) - self.lengths
        self.n_docs = n_docs
        self.vocab_size = vocab_size
        self.ordered = None
        if positions:
            self.order_positions()

    def order_positions(self) -> None:
        """The positions in the field's CSR order, from the stream alone:
        the term ids are the lexicographic ranks of the token names the
        stream uses (build_zipf_segment's term dictionary); a stable order
        by term id keeps doc and position ascending inside a term (the
        stream's own order). Keeps (terms, positions, each position's
        doc) for add_positions."""
        import numpy as np

        used = np.flatnonzero(np.bincount(self.tokens, minlength=self.vocab_size))
        names = np.array([f"t{t}" for t in used])
        lex = np.argsort(names)
        if len(used) > 2**15:
            raise SmokeFailure("a token has no term id of 16 bits")
        tid_of = np.full(self.vocab_size, -1, dtype=np.int16)
        tid_of[used[lex]] = np.arange(len(used), dtype=np.int16)
        order = np.argsort(tid_of[self.tokens], kind="stable")
        pin = (np.arange(len(self.tokens), dtype=np.int64)
               - np.repeat(self.starts, self.lengths)).astype(np.int32)
        positions = pin[order]
        del pin
        doc_of = np.repeat(np.arange(self.n_docs, dtype=np.int32),
                           self.lengths)[order]
        terms = {str(names[i]): j for j, i in enumerate(lex)}
        self.ordered = (terms, positions, doc_of)

    def cut(self, doc: int, at: int, k: int) -> list[str]:
        lo = int(self.starts[doc]) + at
        return [f"t{int(t)}" for t in self.tokens[lo:lo + k]]

    def add_positions(self, fld) -> None:
        """Give the field built from this stream its token positions
        (order_positions, unless a thread already ran it): positions =
        position in doc, pos_offsets = [0, cumsum(tf)] — SegmentBuilder's
        CSR layout. The stream's term dictionary must be the field's, and
        each position's doc the posting's it falls in."""
        import numpy as np

        if self.ordered is None:
            self.order_positions()
        terms, positions, doc_of = self.ordered
        self.ordered = None
        if terms != fld.terms:
            raise SmokeFailure("the stream's term dictionary is not the field's")
        fld.positions = positions
        fld.pos_offsets = np.zeros(len(fld.tfs) + 1, dtype=np.int64)
        fld.pos_offsets[1:] = np.cumsum(fld.tfs.astype(np.int64))
        if not np.array_equal(
                doc_of, np.repeat(fld.doc_ids, fld.tfs.astype(np.int64))):
            raise SmokeFailure("positions do not line up with the postings")


def _phrase_bodies(stream: TokenStream, fld):
    """The phrase phase's traffic (names, bodies) over `body`, drawn from
    default_rng(SEED + 8)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)

    def doc_cut(k):
        while True:
            d = int(rng.integers(0, stream.n_docs))
            n = int(stream.lengths[d])
            if n >= k:
                return stream.cut(d, int(rng.integers(0, n - k + 1)), k)

    def body(q):
        return {"query": q, "size": TOP_K}

    out = []
    for _ in range(32):
        out.append(("phrase", body({"match_phrase": {"body": " ".join(
            doc_cut(int(rng.integers(2, 5))))}})))
    for _ in range(8):
        k = int(rng.integers(2, 4))
        words = [str(w) for w in rng.choice(PHRASE_HEAD, k)]
        out.append(("phrase_head", body({"match_phrase": {"body": " ".join(words)}})))
    for i in range(4):
        words = doc_cut(2)
        words.insert(i % 3, f"absent{i}")
        out.append(("phrase_absent", body({"match_phrase": {"body": " ".join(words)}})))
    for _ in range(8):
        words = doc_cut(int(rng.integers(2, 4)))
        last = words[-1]
        words[-1] = last[: max(2, len(last) - 1)]
        out.append(("phrase_prefix", body({"match_phrase_prefix": {"body": " ".join(words)}})))
    for i in range(8):
        k = 2 + i % 2
        words = doc_cut(k + 2)
        clauses = [{"span_term": {"body": w}} for w in words[::2][:k]]
        ordered = k == 3 or i % 4 < 2
        out.append(("span_near", body({"span_near": {
            "clauses": clauses, "slop": i % 4, "in_order": ordered}})))
    for i in range(4):
        out.append(("span_first", body({"span_first": {
            "match": {"span_term": {"body": PHRASE_HEAD[i]}}, "end": 3}})))
    for i in range(4):
        inc, exc = doc_cut(2)
        out.append(("span_not", body({"span_not": {
            "include": {"span_term": {"body": inc}},
            "exclude": {"span_term": {"body": exc}}, "pre": 1, "post": 1}})))
    for i in range(4):
        words = doc_cut(2 + i % 2)
        out.append(("span_or", body({"span_or": {
            "clauses": [{"span_term": {"body": w}} for w in words]}})))
    for _ in range(4):
        words = doc_cut(int(rng.integers(2, 4)))
        out.append(("intervals", body({"intervals": {"body": {"match": {
            "query": " ".join(words), "max_gaps": 2, "ordered": True}}}})))
    for i in range(8):
        words = doc_cut(2)
        out.append(("bool_phrase_filter", body({"bool": {
            "must": [{"match_phrase": {"body": " ".join(words)}}],
            "filter": [{"term": {"body": PHRASE_HEAD[i % 4]}}]}})))
    return out


def phrase_oracle(fld, n_docs: int, words: list[str], stats_weight):
    """Exact phrase in numpy: per slot the (doc, pos - offset) keys of its
    term, intersected over the slots, counted per doc, then the fp32 BM25
    tail. Returns (ids, scores, total) of the top TOP_K."""
    import numpy as np

    keys = None
    for off, term in enumerate(words):
        tid = fld.terms.get(term)
        if tid is None:
            return [], [], 0
        lo, hi = int(fld.offsets[tid]), int(fld.offsets[tid + 1])
        plo, phi = int(fld.pos_offsets[lo]), int(fld.pos_offsets[hi])
        docs = np.repeat(fld.doc_ids[lo:hi].astype(np.int64),
                         fld.tfs[lo:hi].astype(np.int64))
        apos = fld.positions[plo:phi].astype(np.int64) - off
        k = (docs << 8) | np.where(apos >= 0, apos, 0)
        k = k[apos >= 0]  # ascending: CSR order is (doc, pos)
        if keys is None:
            keys = k
        else:
            small, big = (keys, k) if len(keys) < len(k) else (k, keys)
            at = np.minimum(np.searchsorted(big, small), max(len(big) - 1, 0))
            keys = small[big[at] == small] if len(big) else small[:0]
    docs, freq = np.unique(keys >> 8, return_counts=True)
    w = stats_weight(words)
    ninv = _norm_inverse(fld.sum_total_tf / fld.doc_count)[fld.norm_bytes[docs]]
    f = freq.astype(np.float32)
    scores = (w - w / (np.float32(1.0) + f * ninv)).astype(np.float32)
    order = np.lexsort((docs, -scores))[:TOP_K]
    return [f"d{int(d)}" for d in docs[order]], scores[order], len(docs)


def _norm_inverse(avgdl: float):
    """float32[256]: Lucene's BM25 cache 1 / (k1 * (1 - b + b * dl / avgdl))
    over the 256 norm bytes, dl decoded from SmallFloat's 4-bit form (bytes
    below 24 exact, then (8 | low 3 bits) << (high bits - 1), plus 24),
    written here from the formulas, apart from the port's own helpers."""
    import numpy as np

    b8 = np.arange(256, dtype=np.int64)
    v = np.maximum(b8 - 24, 0)
    shift = (v >> 3) - 1
    big = 24 + np.where(shift < 0, v & 7, (8 | (v & 7)) << np.maximum(shift, 0))
    dl = np.where(b8 < 24, b8, big).astype(np.float32)
    k1, b = np.float32(1.2), np.float32(0.75)
    return (np.float32(1.0) / (k1 * ((np.float32(1.0) - b)
                                    + b * dl / np.float32(avgdl)))
            ).astype(np.float32)


def _phrase_weight(fld, n_docs):
    """Summed fp32 weight of a phrase's terms (Lucene's PhraseWeight),
    from the formulas: idf = log(1 + (N - df + 0.5) / (df + 0.5)) in
    float64 rounded to fp32, times (k1 + 1) in fp32."""
    import numpy as np

    k1_plus_1 = np.float32(np.float32(1.0) * np.float32(1.2 + 1.0))

    def weight(words):
        w = np.float32(0.0)
        for t in words:
            df = float(fld.df[fld.terms[t]])
            idf = np.float32(np.log(1.0 + (fld.doc_count - df + 0.5)
                                    / (df + 0.5)))
            w = np.float32(w + np.float32(k1_plus_1 * idf))
        return w

    return weight


def run_phrase(card, dev, node, seg_tree, compiler, segment, stream,
               launches, rows) -> dict:
    """Phase `phrase`: positional queries over the one-shard corpus with
    positions, over HTTP: sequential (each shape warmed once), held to the
    plain path and (match_phrase) a numpy oracle, then each body
    PHRASE_COPIES times from 16 clients; then K11 / K12 rows."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    fld = segment.fields["body"]
    named = _phrase_bodies(stream, fld)
    names = [n for n, _b in named]
    bodies = [b for _n, b in named]
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()
    server, base = serve(node)
    try:
        first_ms = {}
        for i, name in enumerate(names):
            if name not in first_ms:
                t0 = time.monotonic()
                http(base, "POST", "/msmarco/_search", bodies[i])
                first_ms[name] = (time.monotonic() - t0) * 1e3
        with counted("phrase", launches):
            latencies, responses, wall_s = sequential(base, "msmarco", bodies)
    finally:
        server.shutdown()
        server.server_close()
    log(f"  phrase: first request of each shape (untimed warm-up), ms: "
        f"{json.dumps(first_ms)}")

    # Plain path on the same card tensors, device ms per request, and the
    # K11 rows each request gives (its solo launches).
    vs_plain, exec_ms, plan_ms, plans, k11_rows = 0, [], [], [], []
    for body in bodies:
        t0 = time.perf_counter()
        c = compiler.compile(parse_query(body["query"]))
        plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        plans.append((c.spec, plan))
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        k11_before = kern.LAUNCHES["position_events"]
        ev0.record()
        bm25_device.execute_auto(seg_tree, c.spec, plan, TOP_K)
        ev1.record()
        torch.cuda.synchronize()
        exec_ms.append(ev0.elapsed_time(ev1))
        k11_rows.append(kern.LAUNCHES["position_events"] - k11_before)
    with plain_kernels():
        for (spec, plan), out, name in zip(plans, responses, names):
            s, i, t = bm25_device.execute_auto(seg_tree, spec, plan, TOP_K)
            s, i, t = s.cpu().numpy(), i.cpu().numpy(), int(t.cpu())
            n = min(TOP_K, t, len(i))
            if not same_hits(out, [segment.ids[int(d)] for d in i[:n]], s[:n], t):
                vs_plain += 1
                log(f"  MISMATCH phrase plain {name} {spec[:4]}")
    # The numpy oracle for the first PHRASE_ORACLE_PER_SHAPE match_phrase
    # bodies of each shape.
    vs_oracle, n_oracle = 0, 0
    weight = _phrase_weight(fld, segment.num_docs)
    t0 = time.monotonic()
    per_shape = {}
    for name, body, out in zip(names, bodies, responses):
        if name not in ("phrase", "phrase_head", "phrase_absent"):
            continue
        per_shape[name] = per_shape.get(name, 0) + 1
        if per_shape[name] > PHRASE_ORACLE_PER_SHAPE:
            continue
        words = body["query"]["match_phrase"]["body"].split()
        ids, scores, total = phrase_oracle(fld, segment.num_docs, words, weight)
        n_oracle += 1
        if not same_hits(out, ids, scores, total):
            vs_oracle += 1
            log(f"  MISMATCH phrase oracle {words}")
    oracle_s = time.monotonic() - t0

    # Concurrent: each body PHRASE_COPIES times, shuffled, from 16 clients.
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()
    order = np.random.default_rng(SEED + 9).permutation(
        np.tile(np.arange(len(bodies)), PHRASE_COPIES))
    conc_bodies = [bodies[int(j)] for j in order]
    server, base = serve(node)
    k11_before = launches.get("position_events", 0)
    try:
        with counted("phrase concurrent", launches):
            c_lat, c_resp, c_wall = concurrent(base, "msmarco", conc_bodies,
                                               N_CLIENTS)
    finally:
        server.shutdown()
        server.server_close()
    batcher = node.exec_batcher.stats()
    k11_conc = launches.get("position_events", 0) - k11_before
    k11_rows_per_launch = (sum(k11_rows[int(j)] for j in order)
                           / max(1, k11_conc))
    vs_seq = sum(
        without_took(c_resp[n]) != without_took(responses[int(j)])
        for n, j in enumerate(order)
    )
    by_shape = {}
    for name, ms in zip(names, latencies):
        by_shape.setdefault(name, []).append(ms)
    stats = {
        "requests": len(bodies),
        "p50_ms": percentile(latencies, 50),
        "p99_ms": percentile(latencies, 99),
        "qps_sequential": len(bodies) / wall_s,
        "device_ms_p50": percentile(exec_ms, 50),
        "device_ms_mean": float(np.mean(exec_ms)),
        "per_shape_p50_ms": {k: percentile(v, 50) for k, v in by_shape.items()},
        "per_shape_device_ms_p50": {
            k: percentile([e for n2, e in zip(names, exec_ms) if n2 == k], 50)
            for k in by_shape},
        "host_plan_ms_p50": percentile(plan_ms, 50),
        "per_shape_host_plan_ms_p50": {
            k: percentile([e for n2, e in zip(names, plan_ms) if n2 == k], 50)
            for k in by_shape},
        "matched_total": sum(o["hits"]["total"]["value"] for o in responses),
        "concurrent": {
            "requests": len(conc_bodies),
            "qps": len(conc_bodies) / c_wall,
            "p50_ms": percentile(c_lat, 50),
            "p99_ms": percentile(c_lat, 99),
            "batcher": batcher,
            "k11_launches": k11_conc,
            "k11_rows_per_launch": k11_rows_per_launch,
        },
        "mismatches_vs_plain": vs_plain,
        "mismatches_vs_oracle": vs_oracle,
        "oracle_bodies": n_oracle,
        "oracle_s": oracle_s,
        "mismatches_vs_sequential": vs_seq,
    }
    bad = vs_plain + vs_oracle + vs_seq
    log(f"phase phrase: {'ok' if bad == 0 else 'FAILED'} {json.dumps(stats)} "
        f"[{card}]")
    if bad:
        raise SmokeFailure(f"{bad} phrase mismatches")
    # The batched rows' Q: the rows a concurrent K11 launch took (at least
    # 2, so that a batch is timed and checked).
    q = max(2, round(k11_rows_per_launch))
    kernel_rows_phrase(seg_tree, compiler, named, dev, q, rows)
    return stats


def kernel_rows_phrase(seg_tree, compiler, named, dev, q, rows):
    """K11 (phrase and span modes) and K12 (phrase, near, near-unordered,
    first and not modes), timed at Q = 1 on the phase's widest body of
    each kind and at Q rows (the concurrent phase's rows per K11 launch,
    at least 2) over head phrases; every mode also checked at Q rows; each
    against its plain version (exact)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    num_docs = seg_tree["live"].shape[0]
    pos_doc, pos_val, pos_bits = seg_tree["positions"]["body"]
    norm_bytes = seg_tree["fields"]["body"][3]

    compiled = [compiler.compile(parse_query(body["query"]))
                for _name, body in named]

    def widest(kind, pred=lambda spec: True):
        best = None
        for c in compiled:
            if c.spec[0] == kind and pred(c.spec) and (
                    best is None or c.spec[2] > best[0][2]):
                best = (c.spec, c.arrays)
        if best is None:
            raise SmokeFailure(f"no [{kind}] body for the kernel rows")
        return best

    def rows_of(spec, arrays_list):
        a = bm25_device.plan_to_torch(
            spec, bm25_device.stack_plans(arrays_list), dev)
        return a

    def events_row(spec, a, qq, case):
        phrase = spec[0] == "phrase"
        lane_key = "shifts" if phrase else "clause_of"
        cb = 0 if phrase else kern.clause_bits_for(
            spec[3] if spec[0] == "span_near" else 2)
        mode = kern.EVENTS_PHRASE if phrase else kern.EVENTS_SPAN
        args = (pos_doc, pos_val, a["tile_ids"], a["starts"], a["ends"],
                a[lane_key], num_docs, pos_bits, cb, mode)
        keys, count = kern.position_events(*args)
        unsorted, _valid = kern.event_keys(*args)
        n_valid = int(count.sum())
        _row(rows, "position_events", "elasticsearch_tpu/ops/bm25_device.py:470"
             if phrase else "elasticsearch_tpu/ops/bm25_device.py:545", qq,
             lambda: kern.position_events(*args),
             lambda: kern.position_events_plain(*args),
             lambda: torch.sort(unsorted, dim=1),
             "torch.sort over the packed keys",
             # the valid lanes' doc + position read and their keys
             # written, the worklist (4 planes of i32) read, counts written
             n_valid * 16 + a["tile_ids"].numel() * 16 + qq * 4,
             source=PHRASE_SOURCES["position_events"], case=case, reps=5)
        return keys, count, cb

    def walk_row(spec, a, keys, count, cb, qq, case, **walk):
        args = (keys, count, norm_bytes, a["weight"].reshape(qq),
                a["cache"].reshape(qq, -1), num_docs, pos_bits, cb)
        n_valid = int(count.sum())
        _row(rows, "position_walk", {
            "phrase": "elasticsearch_tpu/ops/bm25_device.py:503",
            "span_near": "elasticsearch_tpu/ops/bm25_device.py:567",
            "span_not": "elasticsearch_tpu/ops/bm25_device.py:641"}[spec[0]], qq,
             lambda: kern.position_walk(*args, **walk),
             lambda: kern.position_walk_plain(*args, **walk),
             None, "none: no one PyTorch call walks each doc's runs",
             # the valid events read once; both [Q, N] planes written
             n_valid * 8 + qq * num_docs * 5,
             source=PHRASE_SOURCES["position_walk"], case=case, reps=5)

    cases = [("phrase", widest("phrase"))]
    for label, pred in (
            ("near", lambda s: s[5] and s[3] > 1 and s[6] < 0),
            ("near-unordered", lambda s: not s[5] and s[3] == 2),
            ("first", lambda s: s[6] >= 0)):
        cases.append((label, widest("span_near", pred)))
    cases.append(("not", widest("span_not")))

    def walk_args(spec):
        if spec[0] == "phrase":
            return {"mode": kern.WALK_PHRASE, "n": spec[3]}
        if spec[0] == "span_near":
            return {"mode": kern.WALK_NEAR, "n": spec[3], "slop": spec[4],
                    "ordered": spec[5], "end_limit": spec[6]}
        return {"mode": kern.WALK_NOT, "n": 2, "pre": spec[3],
                "post": spec[4]}

    for label, (spec, arr) in cases:
        a = rows_of(spec, [arr])
        kind = "phrase" if spec[0] == "phrase" else f"span {label}"
        keys, count, cb = events_row(spec, a, 1, f"{kind}, NT {spec[2]}")
        walk_row(spec, a, keys, count, cb, 1, label, **walk_args(spec))
    # Q head phrases (the concurrent phase's rows per K11 launch),
    # equalized and stacked as a batch is, timed; then every mode at Q rows
    # (its Q = 1 plan repeated) held to the plain versions.
    from elasticsearch_tpu_torch.query.compile import pad_arrays_to_spec, unify_specs

    heads = [c for (n, _b), c in zip(named, compiled) if n == "phrase_head"]
    by_slots = {}
    for c in heads:
        by_slots.setdefault(c.spec[3], []).append(c)
    group = (max(by_slots.values(), key=len) * q)[:q]
    spec = unify_specs([c.spec for c in group])
    a = rows_of(spec, [pad_arrays_to_spec(c.spec, spec, c.arrays) for c in group])
    keys, count, cb = events_row(spec, a, q, f"phrase batch, NT {spec[2]}")
    walk_row(spec, a, keys, count, cb, q, "phrase batch", **walk_args(spec))
    for label, (spec, arr) in cases:
        a = rows_of(spec, [arr] * q)
        lane_key = "shifts" if spec[0] == "phrase" else "clause_of"
        cb = 0 if spec[0] == "phrase" else kern.clause_bits_for(
            spec[3] if spec[0] == "span_near" else 2)
        ev = (pos_doc, pos_val, a["tile_ids"], a["starts"], a["ends"],
              a[lane_key], num_docs, pos_bits, cb,
              kern.EVENTS_PHRASE if spec[0] == "phrase" else kern.EVENTS_SPAN)
        keys, count = kern.position_events(*ev)
        _same((keys, count), kern.position_events_plain(*ev),
              f"position_events {label} Q = {q}")
        wa = (keys, count, norm_bytes, a["weight"].reshape(q),
              a["cache"].reshape(q, -1), num_docs, pos_bits, cb)
        _same(kern.position_walk(*wa, **walk_args(spec)),
              kern.position_walk_plain(*wa, **walk_args(spec)),
              f"position_walk {label} Q = {q}")
    torch.cuda.synchronize()
    log(f"  phrase kernels: K11 / K12 bit-equal to their plain versions in "
        f"every mode at Q = 1 and Q = {q}")


# ---------------------------------------------------------------------------
# Phase `structured`: the structured query tail (kernel-table row 16b),
# K13 doc_join and K14 tail_eval
# ---------------------------------------------------------------------------

STRUCT_SOURCES = {
    "doc_join": "elasticsearch_tpu_torch/csrc/doc_join.cu",
    "tail_eval": "elasticsearch_tpu_torch/ops/tail_kernel.py",
}
JOIN_MODES = ("none", "sum", "avg", "max", "min")
TAIL_KINDS = ("function_score", "geo_distance", "geo_box", "rank_feature",
              "dismax", "boosting", "terms_set")
N_QA = 1_000_000  # Rally `nested` track's shape: questions with answers
STRUCT_CONC = 32  # bodies of the concurrent run (x 4, from 16 clients)
ORACLE_PER_SHAPE = 2  # bodies of a shape held to the numpy oracle
TERMS_SET_SCRIPT = "Math.min(params.num_terms, doc['req'].value)"
FS_SCRIPT = "_score * params.a + doc['req'].value"


def structured_parts(n_docs: int, seed: int):
    """The cfg2 corpus's new fields (phase `structured`), drawn apart from
    the corpus: a Zipf `title` of 2-12 tokens (with its positions) and the
    columns loc (geo_point), pop, pagerank and req, from default_rng(seed)
    — Rally `geonames`' location + population shape. Returns (title
    field, columns, seconds)."""
    import numpy as np

    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    t0 = time.monotonic()
    _m, tseg = build_zipf_segment(n_docs, seed=seed, min_len=2,
                                  max_len=12, field="title")
    title = tseg.fields["title"]
    TokenStream(n_docs, seed, min_len=2, max_len=12).add_positions(title)
    rng = np.random.default_rng(seed)
    cols = {
        "loc.lat": rng.uniform(-60, 70, n_docs).astype(np.float32),
        "loc.lon": rng.uniform(-180, 180, n_docs).astype(np.float32),
        "pop": rng.lognormal(8.0, 2.0, n_docs).astype(np.float32),
        "pagerank": rng.lognormal(0.0, 1.0, n_docs).astype(np.float32),
        "req": rng.integers(1, 4, n_docs).astype(np.float32),
    }
    return title, cols, time.monotonic() - t0


def attach_structured(segment, parts) -> float:
    """Give `segment` the title and columns of structured_parts; returns
    the seconds they took to draw."""
    title, cols, seconds = parts
    segment.fields["title"] = title
    segment.doc_values.update(cols)
    return seconds


def structured_fields(segment, n_docs: int | None = None, seed: int = SEED + 9):
    """structured_parts attached to `segment` (over N_DOCS by default;
    phase `stacked-tail` draws a cfg3 shard's from its own seed)."""
    n_docs = N_DOCS if n_docs is None else n_docs
    return attach_structured(segment, structured_parts(n_docs, seed))


STRUCTURED_MAPPINGS = {
    "title": {"type": "text"}, "loc": {"type": "geo_point"},
    "pop": {"type": "float"}, "pagerank": {"type": "rank_feature"},
    "req": {"type": "integer"},
}


def qa_segment():
    """`qa`'s segment (Rally's `nested` track shape, StackOverflow
    questions with nested answers; `reduced`: synthetic Zipf text):
    1,000,000 parents with a Zipf title of 4-16 tokens, 0-8 nested
    `answers` each (body Zipf of 8-40 tokens, votes a long), built
    vectorized: the inner segment is one build_zipf_segment call and
    parent_of = repeat(arange(N), counts). Returns (segment, seconds)."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import NestedBlock
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 10)
    counts = rng.integers(0, 9, N_QA)
    _m, seg = build_zipf_segment(N_QA, seed=SEED + 10, min_len=4, max_len=16,
                                 field="title")
    nn = int(counts.sum())
    _m, inner = build_zipf_segment(nn, seed=SEED + 11, min_len=8, max_len=40,
                                   field="answers.body")
    inner.doc_values["answers.votes"] = rng.integers(-5, 200, nn).astype(np.float64)
    seg.nested = {"answers": NestedBlock(
        seg=inner, parent_of=np.repeat(np.arange(N_QA, dtype=np.int32), counts))}
    return seg, time.monotonic() - t0


def build_qa(node):
    """Index `qa` (qa_segment) on `node`. Returns (parent segment, handle,
    draw seconds, pack seconds, device bytes)."""
    import torch

    from elasticsearch_tpu_torch.index.tiles import device_nbytes

    seg, build_s = drawn("qa", qa_segment)
    node.create_index("qa", {"mappings": {"properties": {
        "title": {"type": "text"},
        "answers": {"type": "nested", "properties": {
            "body": {"type": "text"}, "votes": {"type": "long"}}}}}})
    t1 = time.monotonic()
    handle = node.indices["qa"].engine._install_segment(seg)
    torch.cuda.synchronize()
    return seg, handle, build_s, time.monotonic() - t1, device_nbytes(handle.device)


def _mid_terms(fld):
    by_df = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])
    return by_df[:len(by_df) // 100 or 1], by_df[len(by_df) // 100: len(by_df) // 4]


def _structured_bodies(segment, qa_seg):
    """The phase's traffic, drawn from default_rng(SEED + 9): (shape, index,
    body) triples, 112 in all."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    t_head, t_mid = _mid_terms(segment.fields["title"])
    b_head, b_mid = _mid_terms(segment.fields["body"])
    _a, a_mid = _mid_terms(qa_seg.nested["answers"].seg.fields["answers.body"])
    qt_head, _q = _mid_terms(qa_seg.fields["title"])

    def words(pool, k):
        return " ".join(str(w) for w in rng.choice(pool, k, replace=False))

    def body(q):
        return {"query": q, "size": TOP_K}

    out = []
    for _ in range(16):
        out.append(("multi_match_best", "msmarco", body({"multi_match": {
            "query": words(t_mid, int(rng.integers(2, 5))),
            "fields": ["title^2", "body"], "tie_breaker": 0.3}})))
    for _ in range(8):
        out.append(("multi_match_most", "msmarco", body({"multi_match": {
            "query": words(t_mid, int(rng.integers(2, 4))),
            "fields": ["title^2", "body"], "type": "most_fields"}})))
    for _ in range(4):
        out.append(("multi_match_phrase", "msmarco", body({"multi_match": {
            "query": words(t_head, 2), "fields": ["title^2", "body"],
            "type": "phrase"}})))
    for _ in range(8):
        out.append(("dis_max", "msmarco", body({"dis_max": {"queries": [
            {"match": {"title": words(t_mid, 2)}},
            {"term": {"body": words(b_mid, 1)}}], "tie_breaker": 0.2}})))
    for _ in range(8):
        ids = [f"d{int(i)}" for i in rng.choice(N_DOCS, 100, replace=False)]
        out.append(("ids", "msmarco", body({"ids": {"values": ids}})))
    for _ in range(8):
        out.append(("boosting", "msmarco", body({"boosting": {
            "positive": {"match": {"body": words(b_mid, 2)}},
            "negative": {"term": {"title": words(t_head, 1)}},
            "negative_boost": 0.3}})))
    rank_fns = [{"saturation": {"pivot": 1.5}}, {"log": {"scaling_factor": 2.0}},
                {"sigmoid": {"pivot": 1.0, "exponent": 0.6}}]
    for i in range(8):
        rf = {"rank_feature": {"field": "pagerank", **rank_fns[i % 3]}}
        if i >= 6:
            rf = {"bool": {"should": [{"match": {"body": words(b_mid, 2)}}, rf]}}
        out.append(("rank_feature", "msmarco", body(rf)))
    for _ in range(8):
        km = float(rng.uniform(10, 500))
        out.append(("geo_distance", "msmarco", body({"bool": {
            "must": [{"match": {"body": words(b_head, 2)}}],
            "filter": [{"geo_distance": {
                "distance": f"{km:.1f}km",
                "loc": {"lat": float(rng.uniform(-50, 60)),
                        "lon": float(rng.uniform(-170, 170))}}}]}})))
    for i in range(4):
        if i < 2:
            left = float(rng.uniform(-170, 150))
            box = {"top": 10.0 + i, "left": left, "bottom": -10.0 - i,
                   "right": left + 3.0}
        else:
            box = {"top": 5.0 + i, "left": 178.5, "bottom": -5.0 - i,
                   "right": -178.0}
        out.append(("geo_bounding_box", "msmarco", body({"geo_bounding_box": {
            "loc": box}})))
    for i in range(8):
        terms = [str(t) for t in rng.choice(b_head[:40], 4, replace=False)]
        msm = ({"minimum_should_match_field": "req"} if i < 4 else
               {"minimum_should_match_script": {"source": TERMS_SET_SCRIPT}})
        out.append(("terms_set", "msmarco", body({"terms_set": {"body": {
            "terms": terms, **msm}}})))
    score_modes = ("multiply", "sum", "avg", "first", "max", "min")
    boost_modes = ("multiply", "sum", "replace", "max")
    fns = [
        {"filter": {"term": {"title": str(t_head[0])}}, "weight": 2.0},
        {"field_value_factor": {"field": "pop", "modifier": "log1p",
                                "factor": 0.5}},
        {"random_score": {"seed": 7}},
        {"gauss": {"pop": {"origin": 3000.0, "scale": 1500.0,
                           "decay": 0.5}}},
        {"linear": {"req": {"origin": 1, "scale": 2, "decay": 0.4}},
         "weight": 1.5},
        {"field_value_factor": {"field": "pagerank", "modifier": "sqrt"}},
        {"exp": {"pagerank": {"origin": 0.0, "scale": 2.0, "offset": 0.5}}},
        {"script_score": {"script": {"source": FS_SCRIPT,
                                     "params": {"a": 0.25}}}},
    ]
    for i in range(16):
        chosen = [fns[i % 8], fns[(i + 3) % 8]] if i < 12 else [fns[i % 8]]
        fs = {"query": {"match": {"body": words(b_mid, 2)}},
              "functions": chosen, "score_mode": score_modes[i % 6],
              "boost_mode": boost_modes[i % 4]}
        if i == 13:
            fs["min_score"] = 1.0
        out.append(("function_score", "msmarco", body({"function_score": fs})))
    for i in range(16):
        nq = {"nested": {"path": "answers", "score_mode": JOIN_MODES[i % 5],
                         "query": {"match": {"answers.body": words(
                             a_mid, int(rng.integers(1, 4)))}}}}
        if i >= 10:
            nq = {"bool": {"must": [nq], "filter": [
                {"term": {"title": str(rng.choice(qt_head))}}]}}
        out.append(("nested", "qa", body(nq)))
    return out


# -- the numpy oracle, written from the reference's formulas --------------

def _np_weight(fld, term, boost):
    """Lucene's fp32 BM25 weight of a term from its formulas:
    f32(f32(boost) * f32(k1 + 1)) * f32(idf), idf in float64."""
    import numpy as np

    df = float(fld.df[fld.terms[term]])
    idf = np.float32(np.log(1.0 + (fld.doc_count - df + 0.5) / (df + 0.5)))
    return np.float32(np.float32(np.float32(boost) * np.float32(2.2)) * idf)


def _np_terms(fld, terms, n, boost=1.0):
    """A disjunction of terms in numpy: (scores f32[n], matched bool[n],
    per-term matched list), the contributions w - w / (1 + tf * ninv)
    folded term by term in query order."""
    import numpy as np

    ninv = _norm_inverse(fld.sum_total_tf / fld.doc_count)
    scores = np.zeros(n, dtype=np.float32)
    matched = np.zeros(n, dtype=bool)
    per_term = []
    for term in terms:
        m = np.zeros(n, dtype=bool)
        tid = fld.terms.get(term)
        if tid is not None:
            lo, hi = int(fld.offsets[tid]), int(fld.offsets[tid + 1])
            docs = fld.doc_ids[lo:hi]
            w = _np_weight(fld, term, boost)
            tn = (fld.tfs[lo:hi] * ninv[fld.norm_bytes[docs]]).astype(np.float32)
            scores[docs] = (scores[docs] + (w - w / (np.float32(1.0) + tn))
                            ).astype(np.float32)
            m[docs] = True
        matched |= m
        per_term.append(m)
    return scores, matched, per_term


def _np_dismax(parts, tie, boost=1.0):
    import numpy as np

    best = np.zeros_like(parts[0][0])
    total = np.zeros_like(parts[0][0])
    matched = np.zeros(len(best), dtype=bool)
    for s, m in parts:
        s = np.where(m, s, np.float32(0.0)).astype(np.float32)
        best = np.maximum(best, s)
        total = (total + s).astype(np.float32)
        matched |= m
    scores = (best + np.float32(tie) * (total - best)).astype(np.float32)
    return np.where(matched, scores * np.float32(boost), np.float32(0.0)), matched


def _np_haversine(lat, lon, qlat, qlon):
    """The reference's `_haversine_m` term for term, in float32 numpy."""
    import numpy as np

    f = np.float32
    rad = f(0.017453292519943295)
    phi1, phi2 = lat * rad, f(qlat) * rad
    dphi = (f(qlat) - lat) * rad
    dlmb = (f(qlon) - lon) * rad
    s1, s2 = np.sin(dphi / f(2)), np.sin(dlmb / f(2))
    a = s1 * s1 + np.cos(phi1) * np.cos(phi2) * s2 * s2
    return f(6371008.7714 * 2) * np.arctan2(np.sqrt(a), np.sqrt(f(1) - a))


def _np_function(fn, child, dv, n):
    """One score function's raw value (un-weighted), numpy float32."""
    import math

    import numpy as np

    f = np.float32
    if "field_value_factor" in fn:
        spec = fn["field_value_factor"]
        col = dv[spec["field"]]
        v = f(spec.get("factor", 1.0)) * np.where(np.isnan(col), f(1), col)
        mod = spec.get("modifier", "none")
        return {"none": v, "log1p": np.log10(v + f(1)),
                "sqrt": np.sqrt(v)}[mod].astype(np.float32)
    if "random_score" in fn:
        x = (np.arange(n, dtype=np.uint32) + np.uint32(fn["random_score"]["seed"])
             ) * np.uint32(2654435761)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(2246822519)
        x = x ^ (x >> np.uint32(13))
        return (x >> np.uint32(8)).astype(np.float32) * f(1.0 / (1 << 24))
    for kind in ("gauss", "exp", "linear"):
        if kind in fn:
            (field, spec), = fn[kind].items()
            scale, decay = float(spec["scale"]), float(spec.get("decay", 0.5))
            const = {"gauss": math.log(decay) / (scale * scale),
                     "exp": math.log(decay) / scale,
                     "linear": scale / (1.0 - decay)}[kind]
            col = dv[field]
            d = np.maximum(f(0), np.abs(col - f(spec.get("origin", 0.0)))
                           - f(spec.get("offset", 0.0)))
            c = f(const)
            if kind in ("gauss", "exp"):
                v = np.exp(c * d * d if kind == "gauss" else c * d)
                # the reference's (XLA's CPU) exp gives +0.0 for a
                # subnormal result
                v = np.where(v < np.finfo(np.float32).tiny, f(0), v)
            else:
                v = np.maximum(f(0), (c - d) / c)
            return np.where(np.isnan(col), f(1), v).astype(np.float32)
    if "script_score" in fn:
        a = f(fn["script_score"]["script"]["params"]["a"])
        return (child * a + dv["req"]).astype(np.float32)
    return np.ones(n, dtype=np.float32)  # weight


def _np_function_score(fs, child, matched, dv, title_fld, n):
    """FunctionScoreQuery's combine in numpy (score_mode, boost_mode,
    max_boost = FLT_MAX, boost 1, min_score)."""
    import numpy as np

    f = np.float32
    values, applies, weights = [], [], []
    for fn in fs["functions"]:
        w = f(fn.get("weight", 1.0))
        values.append((w * _np_function(fn, child, dv, n)).astype(np.float32))
        a = matched
        if "filter" in fn:
            term = fn["filter"]["term"]["title"]
            _s, fm, _p = _np_terms(title_fld, [term], n)
            a = matched & fm
        applies.append(a)
        weights.append(w)
    any_a = np.zeros(n, dtype=bool)
    for a in applies:
        any_a |= a
    mode = fs["score_mode"]
    if mode == "multiply":
        factor = np.ones(n, dtype=np.float32)
        for a, v in zip(applies, values):
            factor = (factor * np.where(a, v, f(1))).astype(np.float32)
    elif mode in ("sum", "avg"):
        total = np.zeros(n, dtype=np.float32)
        wsum = np.zeros(n, dtype=np.float32)
        for a, v, w in zip(applies, values, weights):
            total = (total + np.where(a, v, f(0))).astype(np.float32)
            wsum = (wsum + np.where(a, w, f(0))).astype(np.float32)
        if mode == "sum":
            factor = np.where(any_a, total, f(1))
        else:
            denom = np.where(wsum != 0, wsum, f(1))
            factor = np.where(wsum != 0, total / denom, f(1))
    elif mode == "first":
        factor = np.ones(n, dtype=np.float32)
        taken = np.zeros(n, dtype=bool)
        for a, v in zip(applies, values):
            factor = np.where(a & ~taken, v, factor)
            taken |= a
    else:
        op = np.maximum if mode == "max" else np.minimum
        best = np.full(n, f(-np.inf if mode == "max" else np.inf))
        for a, v in zip(applies, values):
            best = op(best, np.where(a, v, best.dtype.type(
                -np.inf if mode == "max" else np.inf)))
        factor = np.where(any_a, best, f(1))
    factor = np.minimum(factor, f(3.4028235e38)).astype(np.float32)  # max_boost
    bm = fs["boost_mode"]
    scores = {"multiply": lambda: child * factor, "sum": lambda: child + factor,
              "replace": lambda: factor,
              "max": lambda: np.maximum(child, factor)}[bm]().astype(np.float32)
    scores = np.where(matched, scores * f(1), f(0)).astype(np.float32)
    if "min_score" in fs:
        matched = matched & (scores >= f(fs["min_score"]))
        scores = np.where(matched, scores, f(0)).astype(np.float32)
    return scores, matched


def _np_nested(q, qa_seg):
    """nested in numpy: the inner match, then each parent's matched
    children folded in ascending order (sum / avg / max / min / none)."""
    import numpy as np

    blk = qa_seg.nested["answers"]
    inner = blk.seg
    nn = inner.num_docs
    text = q["query"]["match"]["answers.body"]
    cs, cm, _p = _np_terms(inner.fields["answers.body"], text.split(), nn)
    mode = q["score_mode"]
    parent = blk.parent_of[cm]
    vals = cs[cm]
    n = qa_seg.num_docs
    matched = np.zeros(n, dtype=bool)
    matched[parent] = True
    if mode == "none":
        return np.zeros(n, dtype=np.float32), matched
    # rank of each matched child within its parent (children ascending)
    first = np.searchsorted(parent, parent, side="left")
    rank = np.arange(len(parent)) - first
    acc = np.full(n, np.float32(-np.inf) if mode in ("max", "min")
                  else np.float32(0.0), dtype=np.float32)
    count = np.zeros(n, dtype=np.float32)
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = rank == r
        p, v = parent[sel], vals[sel]
        if mode in ("max", "min"):
            acc[p] = np.maximum(acc[p], v if mode == "max" else -v)
        else:
            acc[p] = (acc[p] + v).astype(np.float32)
            count[p] += np.float32(1.0)
    if mode == "avg":
        acc = (acc / np.maximum(count, np.float32(1.0))).astype(np.float32)
    elif mode == "min":
        acc = -acc
    return np.where(matched, acc * np.float32(1.0), np.float32(0.0)), matched


def structured_oracle(shape, index, body, segment, qa_seg):
    """(scores f32[n], matched bool[n], ulps, live) of a body in numpy, or
    None where the oracle does not cover the body (multi_match phrase,
    nested inside a bool: the plain path holds those)."""
    import numpy as np

    q = body["query"]
    n = segment.num_docs
    title, fbody = segment.fields.get("title"), segment.fields.get("body")
    dv = segment.doc_values
    f = np.float32
    if shape in ("multi_match_best", "multi_match_most"):
        words = q["multi_match"]["query"].split()
        st, mt, _ = _np_terms(title, words, n, 2.0)
        sb, mb, _ = _np_terms(fbody, words, n)
        if shape == "multi_match_most":
            s = ((f(0) + st) + sb).astype(np.float32)
            m = mt | mb
            return np.where(m, s * f(1), f(0)), m, 0
        s, m = _np_dismax([(st, mt), (sb, mb)], 0.3)
        return s, m, 0
    if shape == "dis_max":
        a, b = q["dis_max"]["queries"]
        st, mt, _ = _np_terms(title, a["match"]["title"].split(), n)
        sb, mb, _ = _np_terms(fbody, [b["term"]["body"]], n)
        s, m = _np_dismax([(st, mt), (sb, mb)], 0.2)
        return s, m, 0
    if shape == "ids":
        m = np.zeros(n, dtype=bool)
        m[[int(v[1:]) for v in q["ids"]["values"]]] = True
        return np.where(m, f(1), f(0)), m, 0
    if shape == "boosting":
        bq = q["boosting"]
        ps, pm, _ = _np_terms(fbody, bq["positive"]["match"]["body"].split(), n)
        _s, nm, _ = _np_terms(title, [bq["negative"]["term"]["title"]], n)
        factor = np.where(nm, f(bq["negative_boost"]), f(1))
        return np.where(pm, ps * factor * f(1), f(0)), pm, 0
    if shape == "rank_feature":
        rf = q.get("rank_feature")
        extra = None
        if rf is None:
            match, rf = q["bool"]["should"][0], q["bool"]["should"][1]["rank_feature"]
            extra = _np_terms(fbody, match["match"]["body"].split(), n)
        col = dv["pagerank"].astype(np.float32)
        m = ~np.isnan(col)
        v = np.where(m, col, f(0))
        ulps = 0
        if "saturation" in rf:
            s = v / (v + f(rf["saturation"]["pivot"]))
        elif "log" in rf:
            s, ulps = np.log(f(rf["log"]["scaling_factor"]) + v), 4
        else:
            e = float(np.float32(rf["sigmoid"]["exponent"]))
            ve = (v.astype(np.float64) ** e).astype(np.float32)
            pe = np.float32(float(np.float32(rf["sigmoid"]["pivot"])) ** e)
            s, ulps = ve / (ve + pe), 4
        s = np.where(m, f(1) * s, f(0)).astype(np.float32)
        if extra is None:
            return s, m, ulps
        sm, mm, _ = extra
        score = ((f(0) + np.where(mm, sm, f(0))) + s).astype(np.float32)
        any_m = mm | m
        return np.where(any_m, score * f(1), f(0)), any_m, ulps
    if shape == "geo_distance":
        must = q["bool"]["must"][0]["match"]["body"].split()
        gd = dict(q["bool"]["filter"][0]["geo_distance"])
        radius = f(float(gd.pop("distance")[:-2]) * 1000.0)
        (_fld, point), = gd.items()
        sm, mm, _ = _np_terms(fbody, must, n)
        d = _np_haversine(dv["loc.lat"], dv["loc.lon"], point["lat"], point["lon"])
        m = mm & ~np.isnan(dv["loc.lat"]) & (d <= radius)
        return np.where(m, (f(0) + sm) * f(1), f(0)), m, 0
    if shape == "geo_bounding_box":
        box = q["geo_bounding_box"]["loc"]
        lat, lon = dv["loc.lat"], dv["loc.lon"]
        top, bottom = f(box["top"]), f(box["bottom"])
        left, right = f(box["left"]), f(box["right"])
        in_lon = ((lon >= left) | (lon <= right)) if left > right else (
            (lon >= left) & (lon <= right))
        m = ~np.isnan(lat) & (lat <= top) & (lat >= bottom) & in_lon
        return np.where(m, f(1), f(0)), m, 0
    if shape == "terms_set":
        ts = q["terms_set"]["body"]
        s, _m, per_term = _np_terms(fbody, ts["terms"], n)
        count = np.zeros(n, dtype=np.float32)
        for m in per_term:
            count = count + m.astype(np.float32)
        req = dv["req"].astype(np.float32)
        if "minimum_should_match_script" in ts:
            req = np.minimum(f(len(ts["terms"])), req)
        required = np.maximum(req, f(1))
        m = count >= required
        return np.where(m, s * f(1), f(0)), m, 0
    if shape == "function_score":
        fs = q["function_score"]
        child, cm, _ = _np_terms(fbody, fs["query"]["match"]["body"].split(), n)
        ulps = 4 if any(k in fn for fn in fs["functions"]
                        for k in ("gauss", "exp", "field_value_factor")) else 0
        s, m = _np_function_score(fs, child, cm, dv, title, n)
        return s, m, ulps
    if shape == "nested" and "nested" in q:
        s, m = _np_nested(q["nested"], qa_seg)
        return s, m, 0
    return None


def _oracle_page(scores, matched, ids_of, k=TOP_K):
    import numpy as np

    docs = np.flatnonzero(matched)
    order = np.lexsort((docs, -scores[docs]))[:k]
    return [ids_of(int(d)) for d in docs[order]], scores[docs[order]], len(docs)


def _structured_plain(compiler_of, triples):
    """Each body on the plain path (every kernel's plain version, K13 and
    K14 included) over the same card tensors: (ids, scores, total)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query

    out = []
    with plain_kernels():
        for _shape, index, body in triples:
            compiler, seg_tree, segment = compiler_of[index]
            c = compiler.compile(parse_query(body["query"]))
            plan = bm25_device.plan_to_torch(c.spec, c.arrays, seg_tree["live"].device)
            s, i, t = bm25_device.execute_auto(seg_tree, c.spec, plan, TOP_K)
            s, i, t = s.cpu().numpy(), i.cpu().numpy(), int(t.cpu())
            k = min(TOP_K, t, len(i))
            out.append(([segment.ids[int(d)] for d in i[:k]], s[:k], t))
    torch.cuda.synchronize()
    return out


def run_structured(card, dev, node, segment, title_s, launches, rows) -> dict:
    """Phase `structured`: the structured tail over HTTP on cfg2's corpus
    (title, loc, pop, pagerank, req added) and on the nested `qa` index:
    112 bodies sequentially (each shape warmed once), each against the
    plain path on the card and, where the oracle covers it, a numpy oracle;
    then 32 of them x 4 from 16 clients through the batcher; then K13 and
    K14 rows at Q = 1 and their checks at Q > 1."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query

    t_phase = time.monotonic()
    qa_seg, qa_handle, qa_build_s, qa_pack_s, qa_bytes = build_qa(node)
    log(f"  structured: qa built in {qa_build_s:.1f} s ({qa_seg.num_docs} "
        f"parents, {qa_seg.nested['answers'].seg.num_docs} nested answers), "
        f"pack+upload {qa_pack_s:.1f} s, device bytes {qa_bytes} [{card}]")
    svc = node.indices["msmarco"]
    handle = svc.engine.segments[0]
    added = 0
    for name in STRUCTURED_MAPPINGS:
        for col in (name, name + ".lat", name + ".lon"):
            if col in handle.device.doc_values:
                added += handle.device.doc_values[col].nbytes
    tf = handle.device.fields["title"]
    added += sum(t.nbytes for t in (tf.doc_ids, tf.tn, tf.tfs, tf.norm_bytes,
                                    tf.present, tf.pos_doc, tf.pos_val))
    triples = _structured_bodies(segment, qa_seg)
    shapes = [s for s, _i, _b in triples]
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()
    server, base = serve(node)
    try:
        first_ms = {}
        for shape, index, body in triples:
            if shape not in first_ms:
                t0 = time.monotonic()
                http(base, "POST", f"/{index}/_search", body)
                first_ms[shape] = (time.monotonic() - t0) * 1e3
        latencies, responses = [], []
        with counted("structured", launches):
            t_all = time.monotonic()
            for _shape, index, body in triples:
                t0 = time.monotonic()
                responses.append(http(base, "POST", f"/{index}/_search", body))
                latencies.append((time.monotonic() - t0) * 1e3)
            wall_s = time.monotonic() - t_all
    finally:
        server.shutdown()
        server.server_close()
    log(f"  structured: first request of each shape (untimed warm-up), ms: "
        f"{json.dumps(first_ms)}")
    for name in [f"doc_join_{m}" for m in JOIN_MODES] + ["doc_mark"] + [
            f"tail_eval_{k}" for k in TAIL_KINDS]:
        if launches.get(name, 0) < 1:
            raise SmokeFailure(f"structured traffic never launched {name}")

    compiler_of = {
        "msmarco": (svc.engine.compiler_for(handle),
                    bm25_device.segment_tree(handle.device), segment),
        "qa": (node.indices["qa"].engine.compiler_for(qa_handle),
               bm25_device.segment_tree(qa_handle.device), qa_seg),
    }
    # Device ms (CUDA events) and host plan ms per body.
    exec_ms, plan_ms = [], []
    for _shape, index, body in triples:
        compiler, seg_tree, _seg = compiler_of[index]
        t0 = time.perf_counter()
        c = compiler.compile(parse_query(body["query"]))
        plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        bm25_device.execute_auto(seg_tree, c.spec, plan, TOP_K)
        ev1.record()
        torch.cuda.synchronize()
        exec_ms.append(ev0.elapsed_time(ev1))
    # Every body against the plain path on the card.
    vs_plain = 0
    for (shape, _i, _b), out, (ids, scores, total) in zip(
            triples, responses, _structured_plain(compiler_of, triples)):
        if not same_hits(out, ids, scores, total):
            vs_plain += 1
            log(f"  MISMATCH structured plain {shape}")
    # The numpy oracle where it covers the body.
    vs_oracle, n_oracle, kinds_checked, per_shape = 0, 0, set(), {}
    t0 = time.monotonic()
    for (shape, index, body), out in zip(triples, responses):
        if per_shape.get(shape, 0) >= ORACLE_PER_SHAPE:
            continue
        seg = segment if index == "msmarco" else qa_seg
        got = structured_oracle(shape, index, body, seg, qa_seg)
        if got is None:
            continue
        scores, matched, ulps = got
        ids, o_scores, total = _oracle_page(scores, matched,
                                            lambda d, s=seg: s.ids[d])
        n_oracle += 1
        per_shape[shape] = per_shape.get(shape, 0) + 1
        kinds_checked.add(shape)
        hits = out["hits"]["hits"]
        ok = out["hits"]["total"]["value"] == min(total, 10_000)
        if ulps:
            ok = ok and ranked_match([int(h["_id"][1:]) for h in hits],
                                     [h["_score"] for h in hits],
                                     [int(i[1:]) for i in ids], o_scores, ulps)
        else:
            ok = ok and same_hits(out, ids, o_scores, total)
        if not ok:
            vs_oracle += 1
            log(f"  MISMATCH structured oracle {shape} {json.dumps(body)[:300]}")
    oracle_s = time.monotonic() - t0
    if n_oracle < 10 * ORACLE_PER_SHAPE or len(kinds_checked) < 11:
        raise SmokeFailure(f"the oracle covered {n_oracle} bodies of "
                           f"{sorted(kinds_checked)}")

    # Concurrent: 64 bodies (every shape) x 4, shuffled, from 16 clients.
    pick = np.random.default_rng(SEED + 9).permutation(len(triples))[:STRUCT_CONC]
    order = np.random.default_rng(SEED + 10).permutation(np.tile(pick, 4))
    node.exec_batcher.close()
    node.exec_batcher = type(node.exec_batcher)()
    server, base = serve(node)
    conc_lat = [0.0] * len(order)
    conc_out: list = [None] * len(order)
    errors: list = []
    barrier = threading.Barrier(N_CLIENTS)

    def client(cl):
        barrier.wait()
        for j in range(cl, len(order), N_CLIENTS):
            _s, index, body = triples[int(order[j])]
            try:
                t0 = time.monotonic()
                conc_out[j] = http(base, "POST", f"/{index}/_search", body)
                conc_lat[j] = (time.monotonic() - t0) * 1e3
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

    before = dict(launches)
    try:
        with counted("structured concurrent", launches):
            threads = [threading.Thread(target=client, args=(cl,))
                       for cl in range(N_CLIENTS)]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            c_wall = time.monotonic() - t0
    finally:
        server.shutdown()
        server.server_close()
    if errors:
        raise SmokeFailure(f"structured concurrent requests failed: {errors[:3]}")
    batcher = node.exec_batcher.stats()
    vs_seq = sum(without_took(conc_out[j]) != without_took(responses[int(i)])
                 for j, i in enumerate(order))
    struct_launch = {k: launches.get(k, 0) - before.get(k, 0)
                     for k in launches if k.startswith(("doc_", "tail_eval_"))}
    solo_launch = {}
    for j in order:
        for k in _kernels_of(*triples[int(j)][::2]):
            solo_launch[k] = solo_launch.get(k, 0) + 1
    rows_per_launch = {k: solo_launch[k] / max(1, struct_launch.get(k, 0))
                       for k in solo_launch}

    by_shape: dict = {}
    for i, shape in enumerate(shapes):
        by_shape.setdefault(shape, []).append(i)
    stats = {
        "requests": len(triples),
        "p50_ms": percentile(latencies, 50),
        "p99_ms": percentile(latencies, 99),
        "qps_sequential": len(triples) / wall_s,
        "per_shape": {
            k: {"p50_ms": percentile([latencies[i] for i in v], 50),
                "p99_ms": percentile([latencies[i] for i in v], 99),
                "device_ms_p50": percentile([exec_ms[i] for i in v], 50),
                "host_plan_ms_p50": percentile([plan_ms[i] for i in v], 50)}
            for k, v in by_shape.items()},
        "title_and_columns_build_s": title_s,
        "title_and_columns_device_bytes": int(added),
        "qa_build_s": qa_build_s,
        "qa_pack_s": qa_pack_s,
        "qa_device_bytes": int(qa_bytes),
        "qa_nested_docs": int(qa_seg.nested["answers"].seg.num_docs),
        "matched_total": sum(o["hits"]["total"]["value"] for o in responses),
        "oracle_bodies": n_oracle,
        "oracle_kinds": sorted(kinds_checked),
        "oracle_s": oracle_s,
        "concurrent": {
            "requests": len(order),
            "qps": len(order) / c_wall,
            "p50_ms": percentile(conc_lat, 50),
            "p99_ms": percentile(conc_lat, 99),
            "batcher": batcher,
            "launches": struct_launch,
            "rows_per_launch": rows_per_launch,
        },
        "mismatches_vs_plain": vs_plain,
        "mismatches_vs_oracle": vs_oracle,
        "mismatches_vs_sequential": vs_seq,
    }
    bad = vs_plain + vs_oracle + vs_seq
    log(f"phase structured: {'ok' if bad == 0 else 'FAILED'} {json.dumps(stats)} "
        f"[{card}]")
    if bad:
        raise SmokeFailure(f"{bad} structured mismatches")
    q = max(2, round(max(rows_per_launch.values())))
    kernel_rows_structured(compiler_of, triples, dev, q, rows)
    node.delete_index("qa")
    stats["kernel_rows_q"] = q
    stats["phase_s"] = time.monotonic() - t_phase
    log(f"  structured: phase {stats['phase_s']:.1f} s (title and columns "
        f"{title_s:.1f} s more, at corpus time) [{card}]")
    return stats


def _kernels_of(shape, body):
    """The K13 / K14 launch names a body of this shape makes (one each)."""
    if shape == "nested":
        q = body["query"]
        q = q["bool"]["must"][0] if "bool" in q else q
        return [f"doc_join_{q['nested']['score_mode']}"]
    return {
        "multi_match_best": ["tail_eval_dismax"],
        "multi_match_phrase": ["tail_eval_dismax"],
        "dis_max": ["tail_eval_dismax"],
        "ids": ["doc_mark"],
        "boosting": ["tail_eval_boosting"],
        "rank_feature": ["tail_eval_rank_feature"],
        "geo_distance": ["tail_eval_geo_distance"],
        "geo_bounding_box": ["tail_eval_geo_box"],
        "terms_set": ["tail_eval_terms_set"],
        "function_score": ["tail_eval_function_score"],
    }.get(shape, [])


def kernel_rows_structured(compiler_of, triples, dev, q, rows):
    """K13 (each join mode, and mark) and K14 (each node kind) at Q = 1 on
    the phase's own plans, timed beside their bounds and plain versions
    (and torch.segment_reduce for K13's join); then each at Q rows (the
    concurrent phase's rows per launch, at least 2) held to its plain
    version (exact)."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.ops import tail_kernel
    from elasticsearch_tpu_torch.query.dsl import parse_query

    captured: dict = {}
    real_join, real_mark, real_tail = kern.doc_join, kern.doc_mark, tail_kernel.tail_eval

    def cap_join(cm, cs, start, boost, mode, n_shards=0):
        captured.setdefault(f"doc_join_{mode}", (cm, cs, start, boost, mode))
        return real_join(cm, cs, start, boost, mode, n_shards=n_shards)

    def cap_mark(ids, boost, n, n_shards=0):
        captured.setdefault("doc_mark", (ids, boost, n))
        return real_mark(ids, boost, n, n_shards=n_shards)

    def cap_tail(key, qq, n, planes, masks, columns, params, n_shards=0):
        captured.setdefault(f"tail_eval_{key[0]}",
                            (key, qq, n, planes, masks, columns, params))
        return real_tail(key, qq, n, planes, masks, columns, params,
                         n_shards=n_shards)

    kern.doc_join, kern.doc_mark, tail_kernel.tail_eval = cap_join, cap_mark, cap_tail
    try:
        for _shape, index, body in triples:
            compiler, seg_tree, _seg = compiler_of[index]
            c = compiler.compile(parse_query(body["query"]))
            bm25_device.execute_auto(
                seg_tree, c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev),
                TOP_K)
    finally:
        kern.doc_join, kern.doc_mark, tail_kernel.tail_eval = (
            real_join, real_mark, real_tail)
    torch.cuda.synchronize()

    for mode in JOIN_MODES:
        cm, cs, start, boost, _m = captured[f"doc_join_{mode}"]
        nn, n = cs.shape[1], start.shape[0] - 1
        lengths = (start[1:] - start[:-1]).to(torch.int64)
        reduce = {"none": "max", "sum": "sum", "avg": "mean", "max": "max",
                  "min": "min"}[mode]
        data = torch.where(cm[0], cs[0], 0.0)
        _row(rows, f"doc_join_{mode}", "elasticsearch_tpu/ops/bm25_device.py:271",
             1, lambda a=(cm, cs, start, boost, mode): kern.doc_join(*a),
             lambda a=(cm, cs, start, boost, mode): kern.doc_join_plain(*a),
             lambda d=data, ln=lengths, r=reduce: torch.segment_reduce(
                 d, r, lengths=ln),
             "torch.segment_reduce over the children (no fixed order)",
             nn * 5 + (n + 1) * 4 + n * 5, source=STRUCT_SOURCES["doc_join"],
             case=f"nested {mode}, {nn} children, {n} parents")
        rep = (cm.repeat(q, 1), cs.repeat(q, 1), start, boost.repeat(q), mode)
        _same(kern.doc_join(*rep), kern.doc_join_plain(*rep),
              f"doc_join {mode} Q = {q}")
    ids, boost, n = captured["doc_mark"]
    # -1 padding and out-of-range ids land in the discard slot n.
    slots = torch.where((ids[0] >= 0) & (ids[0] < n), ids[0], n).to(torch.int64)
    _row(rows, "doc_mark", "elasticsearch_tpu/ops/bm25_device.py:200", 1,
         lambda: kern.doc_mark(ids, boost, n),
         lambda: kern.doc_mark_plain(ids, boost, n),
         lambda: torch.zeros(n + 1, dtype=torch.bool,
                             device=ids.device).index_fill_(0, slots, True),
         "torch.zeros(N + 1, dtype=bool).index_fill_ over the padded ids "
         "(the matched plane only; the scores are a second call)",
         ids.numel() * 4 + n * 5, source=STRUCT_SOURCES["doc_join"],
         case=f"ids, {ids.shape[1]} slots, {n} docs")
    rep = (ids.repeat(q, 1), boost.repeat(q), n)
    _same(kern.doc_mark(*rep), kern.doc_mark_plain(*rep), f"doc_mark Q = {q}")

    replaces = {
        "function_score": "elasticsearch_tpu/ops/bm25_device.py:367",
        "geo_distance": "elasticsearch_tpu/ops/bm25_device.py:120",
        "geo_box": "elasticsearch_tpu/ops/bm25_device.py:128",
        "rank_feature": "elasticsearch_tpu/ops/bm25_device.py:141",
        "dismax": "elasticsearch_tpu/ops/bm25_device.py:208",
        "boosting": "elasticsearch_tpu/ops/bm25_device.py:178",
        "terms_set": "elasticsearch_tpu/ops/bm25_device.py:232",
    }
    for kind in TAIL_KINDS:
        key, qq, n, planes, masks, columns, params = captured[f"tail_eval_{kind}"]
        _src, _consts, be = tail_kernel.generate_source(key)
        calls = sum(line.count("libdevice.") for line in be.lines)
        # One operation a statement; a libdevice call (sin, cos, atan2,
        # exp, log, pow) counted as 20.
        flops = (len(be.lines) + 19 * calls) * n
        used_cols = [columns[c] for c in be.column_names]
        nbytes = n * (4 * len(be.plane_names) + len(be.mask_names) + 5) + sum(
            c.numel() * 4 for c in used_cols)
        args = (key, 1, n, planes, masks, columns, params)
        _row(rows, f"tail_eval_{kind}", replaces[kind], 1,
             lambda a=args: tail_kernel.tail_eval(*a),
             lambda a=args: tail_kernel.tail_eval_plain(*a), None,
             "none: no one PyTorch call computes the node's tail",
             nbytes, route="triton", source=STRUCT_SOURCES["tail_eval"],
             case=f"{key[0]}: {len(be.lines)} statements, {calls} libdevice "
                  f"calls", flops=flops)
        rep = (key, q, n, {k: v.repeat(q, 1) for k, v in planes.items()},
               {k: v.repeat(q, 1) for k, v in masks.items()}, columns,
               {k: v.repeat(q) for k, v in params.items()})
        _same(tail_kernel.tail_eval(*rep), tail_kernel.tail_eval_plain(*rep),
              f"tail_eval {kind} Q = {q}")
    torch.cuda.synchronize()
    log(f"  structured kernels: K13 / K14 bit-equal to their plain versions "
        f"in every mode and kind at Q = 1 and Q = {q}")


# ---------------------------------------------------------------------------
# Phase `packed` (kernel-table row 13): many small one-shard indices scored
# by coalesced packed launches over one plane (exec/packed.py)
# ---------------------------------------------------------------------------

# The reference's config 6 (bench.py:712-760) has 900 tenants at the plane
# budget; `reduced` to 500 so that the whole run fits half its time limit.
N_TENANTS = 500
TENANT_VOCAB = 4_000
PACKED_CLIENTS = 32
PACKED_SEQ = 64  # bodies sent one at a time (each rides solo)
PACKED_FRESH = 100  # docs `_bulk`-indexed into one tenant after the passes
LEAK_TERM = "zzleak"  # floods one tenant; a few docs of a few others hold it
PACKED_SOURCES = {
    "sparse_fold_bounds": "elasticsearch_tpu_torch/csrc/sparse_fold.cu",
    "masked_topk_window": "elasticsearch_tpu_torch/csrc/masked_topk.cu",
}


def _flood(seg, term: str, docs, tf: int):
    """The segment with `term` added `tf` times to each doc of `docs` in its
    title field (a new last term: the name sorts after every `t<i>`; the
    lengths, norms and statistics follow)."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import FieldIndex
    from elasticsearch_tpu_torch.utils import smallfloat

    fld = seg.fields["title"]
    docs = np.asarray(docs, dtype=np.int32)
    lengths = np.bincount(fld.doc_ids, weights=fld.tfs,
                          minlength=seg.num_docs).astype(np.int64)
    lengths[docs] += tf
    terms = dict(fld.terms)
    terms[term] = len(terms)
    new = FieldIndex(
        name="title", terms=terms,
        df=np.append(fld.df, np.int32(len(docs))).astype(np.int32),
        offsets=np.append(fld.offsets, fld.offsets[-1] + len(docs)),
        doc_ids=np.concatenate([fld.doc_ids, docs]),
        tfs=np.concatenate([fld.tfs, np.full(len(docs), tf, np.float32)]),
        norm_bytes=smallfloat.encode_lengths(lengths),
        doc_count=fld.doc_count, sum_total_tf=fld.sum_total_tf + tf * len(docs),
        has_norms=True, present=fld.present,
    )
    return replace(seg, fields={"title": new})


def _zipf_docs(seg):
    """The documents of a generated title segment as JSON bodies (each
    term tf times; the order of tokens leaves BM25 unchanged)."""
    import numpy as np

    fld = seg.fields["title"]
    names = sorted(fld.terms, key=fld.terms.get)
    term_of = np.repeat(np.arange(len(names)), np.diff(fld.offsets))
    toks: list[list[str]] = [[] for _ in range(seg.num_docs)]
    for d, t, tf in zip(fld.doc_ids.tolist(), term_of.tolist(),
                        fld.tfs.astype(np.int64).tolist()):
        toks[d].extend([names[t]] * tf)
    return [{"title": " ".join(tk)} for tk in toks]


def _packed_bodies(tenants, rng):
    """Two bodies per tenant in the reference test's three shapes: 60 %
    `match` of 3 terms (pick_query_terms), 25 % bool(must match of 1-2
    terms + filter term; the filter a head term or, every other time, a
    mid one that leads the conjunction), 15 % bool(should [term, term],
    minimum_should_match 1). Returns [(index, body, (shape, terms))]."""
    from elasticsearch_tpu_torch.utils.corpus import pick_query_terms

    out = []
    n_bool = 0
    for index, seg in tenants:
        for _ in range(2):
            t = pick_query_terms(seg, rng, 1, terms_per_query=3,
                                 field="title")[0]
            roll = rng.random()
            if roll < 0.60:
                q, shape = {"match": {"title": " ".join(t)}}, ("match", t)
            elif roll < 0.85:
                n_must = int(rng.integers(1, 3))
                filt = t[0] if n_bool % 2 == 0 else t[2]
                must = [w for w in t if w != filt][:n_must]
                n_bool += 1
                q = {"bool": {"must": [{"match": {"title": " ".join(must)}}],
                              "filter": [{"term": {"title": filt}}]}}
                shape = ("must_filter", (must, filt))
            else:
                pair = [t[1], t[0] if rng.random() < 0.5 else t[2]]
                q = {"bool": {"should": [{"term": {"title": w}} for w in pair],
                              "minimum_should_match": 1}}
                shape = ("should", pair)
            out.append((index, {"query": q, "size": TOP_K}, shape))
    return out


def packed_oracle(engine, shape, k=TOP_K):
    """(ids, scores, total) of one body on its own tenant, in numpy: each
    segment scored with the engine's statistics (ops/bm25), live docs only,
    merged by (score desc, global doc id)."""
    import numpy as np

    from elasticsearch_tpu_torch.ops import bm25

    kind, terms = shape
    stats = engine.field_stats()["title"]
    merged, total = [], 0
    for h in engine.segments:
        fld, n = h.segment.fields["title"], h.segment.num_docs
        matched = np.zeros(n, dtype=bool)
        scoring = terms[0] if kind == "must_filter" else terms
        scores = bm25.score_terms_dense(fld, scoring, n, matched=matched,
                                        stats=stats)
        if kind == "must_filter":
            keep = np.zeros(n, dtype=bool)
            keep[fld.postings(terms[1])[0]] = True
            matched &= keep
        matched &= h.live_host
        total += int(matched.sum())
        top_s, top_i = bm25.top_k(scores, k, matched)
        merged += [(-float(sc), h.base + int(d), h.segment.ids[int(d)], sc)
                   for sc, d in zip(top_s, top_i)]
    merged.sort(key=lambda c: (c[0], c[1]))
    page = merged[:k]
    return [c[2] for c in page], [c[3] for c in page], total


class LaunchRecorder:
    """Keeps the inputs of the widest launch (most rows) of one kernel
    wrapper while installed: the kernel rows replay the phase's largest
    launch."""

    def __init__(self, name):
        from elasticsearch_tpu_torch.ops import kernels as kern

        self.kern, self.name = kern, name
        self.real = getattr(kern, name)
        self.args = None
        self.lock = threading.Lock()

    def __enter__(self):
        def record(*args):
            with self.lock:
                if self.args is None or args[2].shape[0] > self.args[2].shape[0]:
                    self.args = args
            return self.real(*args)

        setattr(self.kern, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.kern, self.name, self.real)


def _leak_free(out, prefix) -> bool:
    """Every hit of the page names a doc of the tenant (ids `<prefix>i`)."""
    return all(h["_id"].startswith(prefix) for h in out["hits"]["hits"])


PACKED_LEAK = 3  # the tenant flooded with LEAK_TERM


def packed_corpus():
    """Phase packed's tenants and scifact (see run_packed). Returns
    (sizes, segments, scifact, seconds)."""
    import numpy as np

    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    t0 = time.monotonic()
    rng61 = np.random.default_rng(61)
    sizes = [8, 64, 256] + [int(10 ** rng61.uniform(3.0, 4.0))
                            for _ in range(N_TENANTS - 3)]
    segs = []
    for t, n in enumerate(sizes):
        _m, seg = build_zipf_segment(n, vocab_size=TENANT_VOCAB, seed=700 + t,
                                     min_len=3, max_len=12, field="title")
        segs.append(replace(seg, ids=[f"{t}-{i}" for i in range(n)]))
    segs[PACKED_LEAK] = _flood(segs[PACKED_LEAK], LEAK_TERM,
                               np.arange(sizes[PACKED_LEAK]), 3)
    for t in range(4, 9):
        segs[t] = _flood(segs[t], LEAK_TERM, [1, sizes[t] // 2], 1)
    _m, scifact = build_zipf_segment(5_000, vocab_size=8_000, seed=17,
                                     min_len=3, max_len=12, field="title")
    scifact = replace(scifact, ids=[f"s-{i}" for i in range(5_000)])
    return sizes, segs, scifact, time.monotonic() - t0


def run_packed(card, dev, launches, rows) -> dict:
    """The reference bench's config 6, `reduced` to N_TENANTS = 500 tenants
    (sizes [8, 64, 256] + 497 draws of int(10 ** uniform(3, 4)) from
    default_rng(61); build_zipf_segment(n, vocab 4,000, seed 700 + t,
    3-12 title tokens), installed with `_install_segment`, one of them
    flooded with LEAK_TERM and five holding it in a few docs; plus BASELINE
    config 1's scifact shape (5,000 docs, vocab 8,000, seed 17) indexed over
    HTTP `_bulk`. Two bodies a tenant (default_rng(SEED + 10)) and 12 leak
    bodies; passes: a warm-up touching every tenant once from 32 clients,
    64 bodies one at a time, every body from 32 clients, the same on a
    Node(exec_packed=False). Every concurrent answer equals its solo
    answer on the card (`svc.search.search`), the numpy oracle and the
    unpacked node's answer, and names only its own
    tenant's docs; then 100 docs `_bulk`-indexed into one tenant
    and a refresh: the plane rebuilds and that tenant's packed answers
    track the new segment. Then K2b's bounds mode and K3b's window mode
    replayed on the phase's widest launch of each."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.exec.batcher import MicroBatcher
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.search.service import SearchRequest

    t_phase = time.monotonic()
    sizes, segs, scifact, gen_s = drawn("packed", packed_corpus)
    leak_t = PACKED_LEAK
    mappings = {"mappings": {"properties": {"title": {"type": "text"}}}}
    node = Node(device=DEVICE)
    flat = Node(device=DEVICE, exec_packed=False)
    names = [f"tenant{t:03d}" for t in range(N_TENANTS)]
    t0 = time.monotonic()
    for name, seg in zip(names, segs):
        for n in (node, flat):
            n.create_index(name, mappings)
            n.indices[name].engine._install_segment(seg)
    torch.cuda.synchronize()
    install_s = time.monotonic() - t0
    server, base = serve(node)
    try:
        http(base, "PUT", "/scifact", mappings)
        docs = _zipf_docs(scifact)
        bulk = "".join(json.dumps({"index": {"_id": scifact.ids[i]}}) + "\n"
                       + json.dumps(d) + "\n" for i, d in enumerate(docs))
        t0 = time.monotonic()
        if http(base, "POST", "/scifact/_bulk", raw=bulk)["errors"]:
            raise SmokeFailure("scifact _bulk reported errors")
        http(base, "POST", "/scifact/_refresh")
        ingest_s = time.monotonic() - t0
    finally:
        server.shutdown()
        server.server_close()
    sci_seg = node.indices["scifact"].engine.segments[0].segment
    got_f, want_f = sci_seg.fields["title"], scifact.fields["title"]
    if not (got_f.terms == want_f.terms
            and all(np.array_equal(getattr(got_f, a), getattr(want_f, a))
                    for a in ("df", "offsets", "doc_ids", "tfs", "norm_bytes"))):
        raise SmokeFailure("the scifact tenant's _bulk ingest differs from "
                           "its generated segment")
    flat.create_index("scifact", mappings)
    flat.indices["scifact"].engine._install_segment(sci_seg)
    names.append("scifact")
    tenant_segs = list(zip(names, segs + [scifact]))
    prefix = {name: f"{t}-" for t, name in enumerate(names[:-1])}
    prefix["scifact"] = "s-"
    all_docs = sum(sizes) + 5_000
    log(f"phase packed corpus: ok {N_TENANTS} tenants + scifact, {all_docs} "
        f"docs, {sum(len(s.fields['title'].doc_ids) for s in segs)} postings; "
        f"generate {gen_s:.1f} s (beside phase 2), install (both nodes) "
        f"{install_s:.1f} s, "
        f"scifact _bulk + refresh {ingest_s:.1f} s [{card}]")

    rng = np.random.default_rng(SEED + 10)
    traffic = _packed_bodies(tenant_segs, rng)
    leak_names = [names[t] for t in (leak_t, 4, 5, 6, 7, 8, 0, 1, 2, 10, 11, 12)]
    traffic += [(nm, {"query": {"match": {"title": LEAK_TERM}}, "size": TOP_K},
                 ("match", [LEAK_TERM])) for nm in leak_names]
    shape_counts = {}
    for _i, _b, (kind, _t) in traffic:
        shape_counts[kind] = shape_counts.get(kind, 0) + 1

    def send(base_url, items, n_clients):
        lat = [0.0] * len(items)
        out: list = [None] * len(items)
        errors: list = []
        barrier = threading.Barrier(n_clients)

        def client(c):
            barrier.wait()
            for i in range(c, len(items), n_clients):
                try:
                    t1 = time.monotonic()
                    out[i] = http(base_url, "POST", f"/{items[i][0]}/_search",
                                  items[i][1])
                    lat[i] = (time.monotonic() - t1) * 1e3
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        t1 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise SmokeFailure(f"packed requests failed: {errors[:3]}")
        wall = time.monotonic() - t1
        return lat, out, {"requests": len(items), "qps": len(items) / wall,
                          "p50_ms": percentile(lat, 50),
                          "p99_ms": percentile(lat, 99), "wall_s": wall}

    order = np.random.default_rng(SEED + 11).permutation(len(traffic))
    shuffled = [traffic[int(j)] for j in order]
    warm = [next(x for x in traffic if x[0] == nm) for nm in names]
    warm = [warm[int(j)] for j in np.random.default_rng(SEED + 12).permutation(len(warm))]
    passes = {}
    recorders = [LaunchRecorder(n) for n in PACKED_SOURCES]
    server, base = serve(node)
    try:
        # 1. warm-up: every tenant once from 32 clients (plane builds).
        node.exec_batcher.close()
        node.exec_batcher = MicroBatcher()
        with counted("packed warm-up", launches):
            _l, warm_out, passes["warm_up"] = send(base, warm, PACKED_CLIENTS)
        warm_stats = node.packed_exec.stats()
        passes["warm_up"]["plane_rebuilds"] = warm_stats["plane_rebuilds"]
        passes["warm_up"]["plane_rebuild_s"] = warm_stats["plane_rebuild_s"]
        # 2. sequential: each rides solo.
        with counted("packed sequential", launches):
            _l, seq_out, passes["sequential"] = send(base, shuffled[:PACKED_SEQ], 1)
        # 3. every body from 32 clients.
        node.exec_batcher.close()
        node.exec_batcher = MicroBatcher()
        before = node.packed_exec.stats()
        with counted("packed concurrent", launches), \
                recorders[0], recorders[1]:
            _l, conc_out, passes["concurrent"] = send(base, shuffled,
                                                      PACKED_CLIENTS)
        after = node.packed_exec.stats()
        passes["concurrent"]["batcher"] = node.exec_batcher.stats()
    finally:
        server.shutdown()
        server.server_close()
    # The concurrent pass's launches and lanes; maxima and histograms
    # over the phase's passes so far.
    packed = dict(after)
    for key in ("launches", "lanes", "plane_rebuilds"):
        packed[key] = after[key] - before[key]
    packed["lanes_per_launch_mean"] = (
        packed["lanes"] / packed["launches"] if packed["launches"] else 0.0)
    retried = passes["concurrent"]["batcher"]["retried_individually"]

    # 4. the same pass on Node(exec_packed=False), for comparison only.
    def again(n, name):
        n.exec_batcher.close()
        n.exec_batcher = MicroBatcher()
        server, base = serve(n)
        try:
            _l, out, passes[name] = send(base, shuffled, PACKED_CLIENTS)
            passes[name]["batcher"] = n.exec_batcher.stats()
        finally:
            server.shutdown()
            server.server_close()
        return out

    flat_out = again(flat, "unpacked")

    # Checks: solo on the card, the numpy oracle, no foreign doc.
    t0 = time.monotonic()
    vs_solo = vs_oracle = vs_flat = leaks = 0
    solo_cache = {}
    for n, (index, body, shape) in enumerate(shuffled):
        out = conc_out[n]
        key = (index, json.dumps(body, sort_keys=True))
        if key not in solo_cache:
            svc = node.indices[index]
            solo_cache[key] = json.loads(json.dumps(
                svc.search.search(SearchRequest.from_json(body)).to_json(index)))
        if without_took(out) != without_took(solo_cache[key]):
            vs_solo += 1
            log(f"  MISMATCH packed vs solo {index} {json.dumps(body)}")
        if without_took(flat_out[n]) != without_took(out):
            vs_flat += 1
            log(f"  MISMATCH packed vs unpacked {index} {json.dumps(body)}")
        if not same_hits(out, *packed_oracle(node.indices[index].engine, shape)):
            vs_oracle += 1
            log(f"  MISMATCH packed vs oracle {index} {json.dumps(body)}")
        if not _leak_free(out, prefix[index]):
            leaks += 1
            log(f"  LEAK {index} {json.dumps(body)}")
    for n, (index, body, shape) in enumerate(shuffled[:PACKED_SEQ]):
        key = (index, json.dumps(body, sort_keys=True))
        if without_took(seq_out[n]) != without_took(solo_cache[key]):
            vs_solo += 1
            log(f"  MISMATCH sequential vs solo {index} {json.dumps(body)}")
    leak_totals = {}
    for n, (index, body, shape) in enumerate(shuffled):
        if shape[1] == [LEAK_TERM]:
            leak_totals[index] = conc_out[n]["hits"]["total"]["value"]
    if leak_totals.get(names[leak_t]) != sizes[leak_t]:
        leaks += 1
        log(f"  LEAK totals {leak_totals}")
    check_s = time.monotonic() - t0

    # 5. 100 docs into one tenant over `_bulk`, a refresh, then its bodies
    # again among others from 32 clients: the plane tracks the segment.
    fresh_t = 17
    fresh = names[fresh_t]
    rng_f = np.random.default_rng(SEED + 13)
    vocab = sorted(segs[fresh_t].fields["title"].terms)
    bulk = "".join(
        json.dumps({"index": {"_id": f"{fresh_t}-new{i}"}}) + "\n"
        + json.dumps({"title": " ".join(["zzfresh"] + list(
            rng_f.choice(vocab, int(rng_f.integers(2, 11)))))}) + "\n"
        for i in range(PACKED_FRESH))
    rebuilds0 = node.packed_exec.stats()["plane_rebuilds"]
    server, base = serve(node)
    try:
        if http(base, "POST", f"/{fresh}/_bulk", raw=bulk)["errors"]:
            raise SmokeFailure("fresh _bulk reported errors")
        http(base, "POST", f"/{fresh}/_refresh")
        again = [x for x in traffic if x[0] == fresh] + [
            (fresh, {"query": {"match": {"title": "zzfresh"}}, "size": TOP_K},
             ("match", ["zzfresh"]))]
        others = [x for x in shuffled if x[0] != fresh][:PACKED_CLIENTS * 2]
        items = again + others
        with counted("packed refresh", launches):
            _l, fresh_out, _st = send(base, items, PACKED_CLIENTS)
    finally:
        server.shutdown()
        server.server_close()
    rebuilt = node.packed_exec.stats()["plane_rebuilds"] - rebuilds0
    fresh_bad = 0
    for (index, body, shape), out in zip(items, fresh_out):
        want = node.indices[index].search.search(SearchRequest.from_json(body))
        if without_took(out) != without_took(json.loads(json.dumps(
                want.to_json(index)))):
            fresh_bad += 1
        if not same_hits(out, *packed_oracle(node.indices[index].engine, shape)):
            fresh_bad += 1
        if not _leak_free(out, prefix[index]):
            fresh_bad += 1
    if fresh_out[len(again) - 1]["hits"]["total"]["value"] != PACKED_FRESH:
        fresh_bad += 1
    stats = {
        "tenants": N_TENANTS + 1, "docs": all_docs,
        "bodies": len(traffic), "shapes": shape_counts, "passes": passes,
        "packed": packed, "retried_individually": retried,
        "mismatches_vs_solo": vs_solo, "mismatches_vs_oracle": vs_oracle,
        "mismatches_vs_unpacked": vs_flat,
        "cross_tenant_hits": leaks,
        "leak_totals": leak_totals, "check_s": check_s,
        "refresh": {"rebuilds": rebuilt, "mismatches": fresh_bad,
                    "bodies": len(items)},
    }
    log(f"phase packed: {json.dumps(stats)} [{card}]")
    bad = vs_solo + vs_oracle + vs_flat + leaks + fresh_bad
    if bad or rebuilt < 1:
        raise SmokeFailure(f"phase packed: {bad} mismatches or leaks, "
                           f"{rebuilt} rebuilds after the refresh")
    if packed["launches"] < 1 or packed["lanes"] <= packed["launches"]:
        raise SmokeFailure(f"phase packed: no coalesced packed launch {packed}")
    fallbacks = node.packed_exec.stats()["fallback_solo"]
    if fallbacks or retried:
        raise SmokeFailure(f"phase packed: {fallbacks} solo fallbacks (no "
                           f"ineligible body was sent), {retried} riders "
                           f"retried alone")
    kernel_rows_packed(recorders, dev, rows)
    flat.close()
    node.close()
    stats["seconds"] = time.monotonic() - t_phase
    log(f"phase packed: ok {stats['seconds']:.1f} s [{card}]")
    return stats


def kernel_rows_packed(recorders, dev, rows):
    """K2b's bounds mode and K3b's window mode replayed on the concurrent
    pass's widest launch of each (Q = its lanes), against their plain
    versions, bit for bit."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    lane = torch.arange(256, device=dev, dtype=torch.int64)
    fold, window = recorders
    if fold.args is None or window.args is None:
        raise SmokeFailure("phase packed launched no K2b bounds or K3b window")
    (doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs, t_pad,
     lo, hi) = fold.args
    q, nt = tile_ids.shape
    a = {"tile_ids": tile_ids, "starts": starts, "ends": ends}
    tid, valid = _worklist(a, lane)
    n_real = int(valid.any(dim=-1).sum())
    cand_keys = torch.where(valid, doc_tiles[tid], num_docs).reshape(q, -1)
    _row(rows, "sparse_fold_bounds", "elasticsearch_tpu/ops/bm25_device.py:1014", q,
         lambda: kern.sparse_fold_bounds(*fold.args),
         lambda: kern.sparse_fold_bounds_plain(*fold.args),
         lambda: torch.sort(cand_keys, dim=1, stable=True),
         "torch.sort(stable=True) over [Q, P]",
         # valid postings (doc id + impact), the worklist, the bounds read;
         # docs_s, run_sum and eligible written
         int(valid.sum()) * 8 + n_real * 16 + q * 8 + q * nt * 256 * 9,
         source=PACKED_SOURCES["sparse_fold_bounds"],
         case=f"the widest packed sparse launch, {q} lanes over "
              f"{num_docs:,} plane docs")
    key, eligible, wlo, whi, k = window.args
    q = key.shape[0]
    spans = [(int(a_), int(b_)) for a_, b_ in zip(wlo.tolist(), whi.tolist())]
    width = sum(b_ - a_ for a_, b_ in spans)
    _row(rows, "masked_topk_window", "elasticsearch_tpu/ops/bm25_device.py:741", q,
         lambda: kern.masked_topk_window(*window.args),
         lambda: kern.masked_topk_window_plain(*window.args),
         lambda: [torch.topk(key[r, a_:b_], min(k, b_ - a_))
                  for r, (a_, b_) in enumerate(spans)],
         "torch.topk per row window",
         # each row's window of keys and eligibility read once; the bounds
         # read; scores, ids and totals written
         width * 5 + q * 8 + q * min(k, key.shape[1]) * 8 + q * 4,
         source=PACKED_SOURCES["masked_topk_window"], device=True,
         case=f"the widest packed dense launch, {q} lanes, windows of "
              f"{width:,} docs in all over a {key.shape[1]:,}-doc plane")
    # The same windows past the select's k.
    kk = kern.ROW_SELECT_MAX_K + 1
    wargs = (key, eligible, wlo, whi, kk)
    wmax = max(b_ - a_ for a_, b_ in spans)
    _row(rows, "masked_topk_window", "elasticsearch_tpu/ops/bm25_device.py:741", q,
         lambda: kern.masked_topk_window(*wargs),
         lambda: kern.masked_topk_window_plain(*wargs),
         lambda: [torch.topk(key[r, a_:b_], min(kk, b_ - a_))
                  for r, (a_, b_) in enumerate(spans)],
         "torch.topk per row window",
         width * 5 + q * 8 + q * min(kk, key.shape[1]) * 8 + q * 4,
         source=PACKED_SOURCES["masked_topk_window"], device=True,
         case=f"the same windows at k = {kk} "
              f"({kern.topk_route(min(kk, key.shape[1], wmax), wmax)})")


# ---------------------------------------------------------------------------
# Phase filter-cache (kernel-table row 8b, ROADMAP A2): repeated filter
# clauses served from the node's FilterCache on the solo, batched,
# concurrent and mesh paths, against a node without one
# ---------------------------------------------------------------------------

FC_CLIENTS = 16
FC_CONC_COPIES = 4  # each body this many times in the concurrent pass


def _cfg3_fc_filters(by_df) -> list[tuple[str, dict]]:
    """Phase filter-cache's 8 filters on cfg3's documents (a text body
    only: term, terms, exists and bools of them, in filter and must_not),
    over terms ranked 400-411 by df (no earlier phase filters on them, so
    the cache starts cold)."""
    t = [str(x) for x in by_df[400:412]]
    return [
        ("filter", {"term": {"body": t[0]}}),
        ("filter", {"terms": {"body": [t[1], t[2]]}}),
        ("filter", {"exists": {"field": "body"}}),
        ("filter", {"bool": {"filter": [{"term": {"body": t[3]}}],
                             "must_not": [{"term": {"body": t[4]}}]}}),
        ("must_not", {"term": {"body": t[5]}}),
        ("must_not", {"terms": {"body": [t[6], t[7]]}}),
        ("must_not", {"bool": {"should": [{"term": {"body": t[8]}},
                                          {"term": {"body": t[9]}}]}}),
        ("filter", {"bool": {"filter": [{"exists": {"field": "body"}}],
                             "must_not": [{"terms": {"body": [t[10], t[11]]}}]}}),
    ]


# cfg7's 8 filters over its tag keyword and price long: term, terms, range,
# exists and bools of them, in filter and must_not.
CFG7_FC_FILTERS = [
    ("filter", {"term": {"tag": "x"}}),
    ("filter", {"terms": {"tag": ["y", "z"]}}),
    ("filter", {"range": {"price": {"gte": 2000, "lt": 7000}}}),
    ("filter", {"exists": {"field": "price"}}),
    ("filter", {"bool": {"filter": [{"term": {"tag": "y"}}],
                         "must_not": [{"range": {"price": {"lt": 1000}}}]}}),
    ("must_not", {"term": {"tag": "z"}}),
    ("must_not", {"range": {"price": {"gte": 9000}}}),
    ("must_not", {"bool": {"filter": [{"terms": {"tag": ["x", "y"]}}],
                           "must_not": [{"exists": {"field": "price"}}]}}),
]


def _fc_bodies(musts: list[str], filters: list[tuple[str, dict]]):
    """Each (context, filter) under each 2-term must match: the body's
    filter sits in `filter` or in `must_not`."""
    return [
        {"query": {"bool": {"must": [{"match": {"body": m}}], ctx: [f]}},
         "size": TOP_K}
        for ctx, f in filters for m in musts
    ]


def _k1_total(counts: dict) -> int:
    """K1 launches (every terms_scatter mode) in a launch-count dict."""
    return sum(c for name, c in counts.items()
               if name.startswith("terms_scatter")
               and not name.endswith("_matched_only"))


@contextlib.contextmanager
def cache_detached(node, index: str):
    """The index served as a node without a filter cache serves it: its
    coordinator (if any), every shard's service and its mesh view see no
    cache while inside."""
    search = node.indices[index].search
    holders = [search] + list(getattr(search, "services", []))
    saved = [h.filter_cache for h in holders]
    for h in holders:
        h.filter_cache = None
    try:
        yield
    finally:
        for h, c in zip(holders, saved):
            h.filter_cache = c


def _fc_index_pass(card, dev, node, index, bodies, yard, launches) -> dict:
    """One index of phase filter-cache. `yard()` answers the bodies on the
    yardstick (a node without a cache over the same documents). Then the
    cached node over HTTP: a cold sequential pass (the cache holds none of
    these filters), a second (admission), the bodies x 4 shuffled from 16
    clients, and a warm sequential pass; every answer equal to the
    yardstick's, whole JSON but `took`. K1 launches per request cold and
    warm from the launch counters, device ms per request (CUDA events
    around the batched executions) and p50 on the warm pass against the
    yardstick's."""
    import numpy as np

    import torch

    cache = node.filter_cache
    want, yard_lat, yard_dev = yard()
    stats0 = cache.stats()
    out = {"bodies": len(bodies), "mismatches": 0}
    server, base = serve(node)
    try:
        passes = {}
        for name in ("cold", "admit"):
            before = dict(launches)
            with counted(f"filter-cache {index} {name}", launches):
                lat, resp, _wall = sequential(base, index, bodies)
            passes[name] = (lat, resp, _k1_total(launches) - _k1_total(before))
        order = np.random.default_rng(SEED + 12).permutation(
            np.tile(np.arange(len(bodies)), FC_CONC_COPIES))
        with counted(f"filter-cache {index} concurrent", launches):
            c_lat, c_resp, c_wall = concurrent(
                base, index, [bodies[int(j)] for j in order], FC_CLIENTS)
        before = dict(launches)
        with counted(f"filter-cache {index} warm", launches), \
                LaunchTimer() as timer:
            w_lat, w_resp, _wall = sequential(base, index, bodies)
        passes["warm"] = (w_lat, w_resp, _k1_total(launches) - _k1_total(before))
    finally:
        server.shutdown()
        server.server_close()
    for name, (_lat, resp, _k1) in passes.items():
        for body, got, w in zip(bodies, resp, want):
            if without_took(got) != w:
                out["mismatches"] += 1
                log(f"  MISMATCH filter-cache {index} {name} {body}")
    for n, j in enumerate(order):
        if without_took(c_resp[n]) != want[int(j)]:
            out["mismatches"] += 1
            log(f"  MISMATCH filter-cache {index} concurrent {bodies[int(j)]}")
    stats = cache.stats()
    cached_dev = [a.elapsed_time(b) for _q, a, b in timer.events]
    out.update({
        "k1_launches_per_request_cold": passes["cold"][2] / len(bodies),
        "k1_launches_per_request_admit": passes["admit"][2] / len(bodies),
        "k1_launches_per_request_warm": passes["warm"][2] / len(bodies),
        "p50_ms_cached_warm": percentile(w_lat, 50),
        "p50_ms_uncached": percentile(yard_lat, 50),
        "p50_ms_cold": percentile(passes["cold"][0], 50),
        "device_ms_per_request_cached_warm": sum(cached_dev) / len(bodies),
        "device_ms_per_request_uncached": sum(yard_dev) / len(bodies),
        "concurrent_qps": len(order) / c_wall,
        "concurrent_p50_ms": percentile(c_lat, 50),
        "hits": stats["hit_count"] - stats0["hit_count"],
        "misses": stats["miss_count"] - stats0["miss_count"],
        "admissions": stats["admissions"] - stats0["admissions"],
    })
    torch.cuda.synchronize()
    return out, want


def _fc_yard(base_of, index, bodies):
    """A yardstick runner: the bodies sequentially over HTTP on the server
    `base_of()` opens, with CUDA events around the batched executions.
    Returns (answers without `took`, latencies, device ms per request)."""

    def run():
        server, base = base_of()
        try:
            with LaunchTimer() as timer:
                lat, resp, _wall = sequential(base, index, bodies)
        finally:
            server.shutdown()
            server.server_close()
        dev_ms = [a.elapsed_time(b) for _q, a, b in timer.events]
        return [without_took(r) for r in resp], lat, dev_ms

    return run


def _fc_mesh(card, dev, node, index, bodies, want, launches, view=None) -> dict:
    """The bodies twice through a MeshView over [card] * 8 with the node's
    cache (rows cached per shard, built on a body's second sighting), each
    answer held to the yardstick's; every body served on the mesh. `view`:
    the index's installed view (else one is installed here and removed
    after)."""
    svc = node.indices[index]
    own = view is None
    if own:
        view = _install_view(svc, [dev] * len(svc.engines))
    served0 = view.stats()["served"]
    stats0 = node.filter_cache.stats()
    server, base = serve(node)
    bad = 0
    try:
        with counted(f"filter-cache {index} mesh", launches):
            for _rep in range(2):
                _lat, resp, _wall = sequential(base, index, bodies)
                bad += sum(without_took(g) != w for g, w in zip(resp, want))
    finally:
        server.shutdown()
        server.server_close()
        if own:
            svc.search.mesh_view = None
    counters = view.stats()
    stats = node.filter_cache.stats()
    rows_resident = sum(1 for k in node.filter_cache.keys()
                        if isinstance(k[1], tuple) and k[1][0] == "row")
    served = counters["served"] - served0
    if served != 2 * len(bodies) or counters["fallbacks"]:
        raise SmokeFailure(f"filter-cache mesh view declined bodies: {counters}")
    out = {"mismatches": int(bad), "served": served,
           "row_hits": stats["hit_count"] - stats0["hit_count"],
           "rows_resident": rows_resident}
    log(f"  filter-cache {index} mesh: {json.dumps(out)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} filter-cache mesh mismatches on {index}")
    if out["row_hits"] <= 0:
        raise SmokeFailure(f"filter-cache {index} mesh: no row hit")
    return out


def run_filter_cache(card, dev, node, plain, match_musts, filters_of,
                     launches, mesh: bool = True) -> dict:
    """Phase filter-cache on one node's indices. `filters_of` maps an
    index to its 8 (context, filter) pairs; `plain` is a node without a
    cache over the same documents and indices, or None: the node itself
    with its cache detached (`cache_detached`, what Node(filter_cache=
    False) builds), where a second copy of the index would not fit the
    phase's time. `mesh`: also run each multi-shard index's bodies
    through a MeshView here (else the caller does, on its own view, with
    the returned `pending` bodies and answers)."""
    import gc as _gc

    import torch

    t_phase = time.monotonic()
    result: dict = {}
    pending: dict = {}
    bad = 0
    for index, filters in filters_of.items():
        bodies = _fc_bodies(match_musts, filters)
        if plain is not None:
            yard = _fc_yard(lambda: serve(plain), index, bodies)
        else:
            def yard(index=index, bodies=bodies):
                with cache_detached(node, index):
                    return _fc_yard(lambda: serve(node), index, bodies)()
        r, want = _fc_index_pass(card, dev, node, index, bodies, yard,
                                 launches)
        if len(node.indices[index].engines) > 1:
            if mesh:
                r["mesh"] = _fc_mesh(card, dev, node, index, bodies, want,
                                     launches)
            else:
                pending[index] = (bodies, want)
        bad += r["mismatches"]
        if r["hits"] <= 0:
            raise SmokeFailure(f"filter-cache {index}: no cache hit")
        if r["k1_launches_per_request_warm"] >= r["k1_launches_per_request_cold"]:
            raise SmokeFailure(
                f"filter-cache {index}: warm requests launch K1 "
                f"{r['k1_launches_per_request_warm']} times, cold ones "
                f"{r['k1_launches_per_request_cold']}")
        result[index] = r
        log(f"  filter-cache {index}: {json.dumps(r)} [{card}]")
    result["stats"] = node.filter_cache.stats()
    result["phase_s"] = time.monotonic() - t_phase
    _gc.collect()
    torch.cuda.synchronize()
    log(f"phase filter-cache: {'ok' if bad == 0 else 'FAILED'} "
        f"{json.dumps(result)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} filter-cache mismatches")
    result["pending"] = pending
    return result


def run_filter_cache_evict(card, node, plain, index, match_musts, filters,
                           launches) -> dict:
    """Phase filter-cache's forced eviction and `_cache/clear` on one
    one-shard index: a budget of three planes under the 8 filters
    (evictions, residency within the budget, every answer equal to the
    yardstick's), allocated device memory back where it was once the
    cache is cleared, then `POST /{index}/_cache/clear` over REST and a
    miss that is still correct."""
    import gc as _gc

    import torch

    cache = node.filter_cache
    bodies = _fc_bodies(match_musts, filters)
    want = _fc_yard(lambda: serve(plain), index, bodies)()[0]
    plane_bytes = int(node.indices[index].engine.segments[0].device.live.numel())
    saved_budget = cache.max_bytes
    cache.clear()
    _gc.collect()
    torch.cuda.synchronize()
    alloc_before = torch.cuda.memory_allocated()
    cache.max_bytes = 3 * plane_bytes
    stats0 = cache.stats()
    bad = 0
    peak_resident = 0
    server, base = serve(node)
    try:
        with counted(f"filter-cache {index} evict", launches):
            for body, w in zip(bodies, want):
                got = http(base, "POST", f"/{index}/_search", body)
                bad += without_took(got) != w
                peak_resident = max(peak_resident, cache.stats()["bytes_resident"])
        stats1 = cache.stats()
        cache.max_bytes = saved_budget
        cleared_direct = cache.clear()
        _gc.collect()
        torch.cuda.synchronize()
        alloc_after = torch.cuda.memory_allocated()
        # REST clear: admit this index's planes again, clear them over
        # REST, then one miss that must still be right.
        with counted(f"filter-cache {index} clear", launches):
            for body in bodies[:4]:
                http(base, "POST", f"/{index}/_search", body)
            cleared = http(base, "POST", f"/{index}/_cache/clear")
            misses0 = cache.stats()["miss_count"]
            again = http(base, "POST", f"/{index}/_search", bodies[0])
            bad += without_took(again) != want[0]
            miss_after_clear = cache.stats()["miss_count"] - misses0
    finally:
        server.shutdown()
        server.server_close()
        cache.max_bytes = saved_budget
    out = {
        "budget_bytes": 3 * plane_bytes,
        "plane_bytes": plane_bytes,
        "evictions": stats1["evictions"] - stats0["evictions"],
        "admissions": stats1["admissions"] - stats0["admissions"],
        "peak_bytes_resident": peak_resident,
        "planes_cleared_after": cleared_direct,
        "allocated_before": alloc_before,
        "allocated_after_clear": alloc_after,
        "rest_clear": cleared,
        "misses_after_rest_clear": miss_after_clear,
        "mismatches": int(bad),
    }
    log(f"  filter-cache evict {index}: {json.dumps(out)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} filter-cache mismatches under eviction")
    if out["evictions"] <= 0 or peak_resident > 3 * plane_bytes:
        raise SmokeFailure(f"filter-cache budget not held: {out}")
    if alloc_after - alloc_before >= plane_bytes:
        raise SmokeFailure(f"filter-cache planes still allocated: {out}")
    if cleared["cleared"]["filter_cache"] <= 0 or miss_after_clear <= 0:
        raise SmokeFailure(f"_cache/clear dropped nothing: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase mesh (kernel-table row 23 and row 22's mesh half): the shards of one
# index served as one mesh request (parallel/sharded.py, mesh_serving.py)
# ---------------------------------------------------------------------------

MESH_PHRASE_DOCS = 100_000  # docs a shard of the phrase mesh index (2 shards)
MESH_PHRASE_BODIES = 5
MESH_WALK_PAGES = 3
MESH_CARDS_DOCS = 100_000  # docs a shard of phase mesh cards


def _mesh_devices(dev, n: int):
    """n distinct cards when the machine has them, else n entries of one
    card; and the layout's name."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], f"{n} distinct cards"
    return [dev] * n, f"{n} shards on one card ({dev})"


def _tree_nbytes(tree) -> int:
    import torch

    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_nbytes(v) for v in tree)
    return int(tree.nbytes) if isinstance(tree, torch.Tensor) else 0


def _install_view(svc, devices):
    """A MeshView over `devices` on a multi-shard index's coordinator."""
    from elasticsearch_tpu_torch.parallel.mesh_serving import maybe_mesh_view

    view = maybe_mesh_view(svc.engines, svc.mappings, svc.engines[0].params,
                           devices, filter_cache=svc.search.filter_cache)
    if view is None:
        raise SmokeFailure("no mesh view for the index (fewer devices than shards?)")
    svc.search.mesh_view = view
    return view


class MeshTimer:
    """CUDA events around every mesh request's bodies and merge
    (mesh_serving's sharded_execute / sharded_execute_request) while
    installed; the first merge's gathered key plane and ids (K3's merge
    mode's row) and the number of merges (one K3 launch each)."""

    def __init__(self):
        from elasticsearch_tpu_torch.parallel import mesh_serving, sharded

        self.ms, self.sh = mesh_serving, sharded
        self.real = (mesh_serving.sharded_execute,
                     mesh_serving.sharded_execute_request, sharded._merge_topk)
        self.events: list = []
        self.merge_input = None
        self.merges = 0

    def __enter__(self):
        import torch

        def timed(real):
            def run(*args, **kw):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                out = real(*args, **kw)
                ev1.record()
                self.events.append((ev0, ev1))
                return out
            return run

        def capture(flat_key, k, ids=None):
            self.merges += 1
            if self.merge_input is None:
                self.merge_input = (flat_key.contiguous().clone(), k,
                                    None if ids is None else ids.contiguous().clone())
            return self.real[2](flat_key, k, ids)

        self.ms.sharded_execute = timed(self.real[0])
        self.ms.sharded_execute_request = timed(self.real[1])
        self.sh._merge_topk = capture
        return self

    def __exit__(self, *exc):
        import torch

        (self.ms.sharded_execute, self.ms.sharded_execute_request,
         self.sh._merge_topk) = self.real
        torch.cuda.synchronize()

    def device_ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events]


def _launch_total(before: dict, after: dict) -> int:
    return sum(after.get(k, 0) - before.get(k, 0) for k in after)


def _batch_rows(index, queries, want, batch_axis_size: int) -> int:
    """search_batch over each compile_batch_buckets bucket (a bucket of
    odd size padded with its last query when the batch axis has 2 rows),
    each row held to the same index's `search`: ids, score bits, totals.
    Returns the mismatches."""
    import numpy as np

    bad = 0
    for _c, positions in index.compile_batch_buckets(queries):
        pos = list(positions)
        while len(pos) % batch_axis_size:
            pos.append(pos[-1])
        s_b, g_b, t_b = index.search_batch([queries[p] for p in pos], TOP_K,
                                           "batch")
        s_b, g_b, t_b = s_b.cpu().numpy(), g_b.cpu().numpy(), t_b.cpu().numpy()
        for row, p in enumerate(pos):
            scores, gids, total = want[p]
            n = len(gids)
            if not (int(t_b[row]) == total
                    and np.array_equal(g_b[row][:n], gids)
                    and np.array_equal(score_bits(s_b[row][:n]),
                                       score_bits(scores))):
                bad += 1
                log(f"  MISMATCH mesh search_batch row {p}")
    return bad


def run_mesh_cfg3(card, dev, node, shards, bodies, responses, host_lat,
                  launches, rows, fc_check=None) -> dict:
    """Phase mesh on cfg3's 8-shard node (run_sharded's): mesh_snapshot's
    ShardedIndex.search and search_batch on a (1 x 8) mesh; search_batch
    on a (2 replica x 4 shard) mesh over shard segments 0-3; then REST
    with a MeshView installed; every answer held to the host loop's
    (phase 8's responses, or the same index's search). `fc_check`:
    phase filter-cache's (bodies, yardstick answers), sent through the
    same view before it is removed."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.parallel import sharded as psh
    from elasticsearch_tpu_torch.parallel.mesh import Mesh
    from elasticsearch_tpu_torch.query.dsl import parse_query

    svc = node.indices["cfg3"]
    devices, layout = _mesh_devices(dev, N_SHARDS)
    log(f"phase mesh: layout {layout}: {[str(d) for d in devices]} [{card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.monotonic()
    queries = [parse_query(b["query"]) for b in bodies]
    mismatches = 0

    # 1. IndexService.mesh_snapshot, ShardedIndex.search
    t0 = time.monotonic()
    sidx = svc.mesh_snapshot(Mesh(np.array(devices, dtype=object), ("shard",)))
    torch.cuda.synchronize()
    snapshot_s = time.monotonic() - t0
    snapshot_bytes = _tree_nbytes(sidx.trees)
    with counted("mesh ShardedIndex.search", launches):
        outs = [sidx.search(q, TOP_K) for q in queries]
    for body, out, (scores, gids, total) in zip(bodies, responses, outs):
        ids = [sidx.segments[s].ids[loc] for s, loc in map(sidx.locate, gids)]
        if not same_hits(out, ids, scores, total):
            mismatches += 1
            log(f"  MISMATCH mesh search {body}")
    # 2. search_batch on (1 x 8), then (2 x 4) over shard segments 0-3
    b18 = replace(sidx, mesh=Mesh(np.array([devices], dtype=object),
                                  ("batch", "shard")), _replicas={})
    with counted("mesh search_batch (1 x 8)", launches):
        mismatches += _batch_rows(b18, queries, outs, 1)
    del b18, sidx
    gc.collect()
    grid = (np.array(devices, dtype=object).reshape(2, 4) if layout.endswith(
        "distinct cards") else np.full((2, 4), dev, dtype=object))
    idx24 = psh.ShardedIndex.from_segments(
        shards[:4], svc.mappings, Mesh(grid, ("batch", "shard")))
    want24 = [idx24.search(q, TOP_K) for q in queries]
    with counted("mesh search_batch (2 x 4)", launches):
        mismatches += _batch_rows(idx24, queries, want24, 2)
    del idx24, want24
    gc.collect()
    torch.cuda.empty_cache()

    # 3. REST through the MeshView
    view = _install_view(svc, devices)
    t0 = time.monotonic()
    view._ensure()
    torch.cuda.synchronize()
    view_build_s = time.monotonic() - t0
    server, base = serve(node)
    try:
        for i in (0, N_CFG3):  # one untimed warm-up request per shape
            http(base, "POST", "/cfg3/_search", bodies[i])
        before = dict(launches)
        with counted("mesh REST cfg3", launches), MeshTimer() as timer:
            lat, mresp, _wall = sequential(base, "cfg3", bodies)
        n_launch = _launch_total(before, launches)
        counters = view.stats()
        # One body past the merge mode's rows: S * kk = 8 * 600 keys take
        # the merge's long route (K3's row mode), held to the host loop.
        long_body = dict(bodies[0], size=LONG_MERGE_SIZE)
        before_long = dict(launches)
        with counted("mesh REST cfg3, long merge", launches), \
                MeshTimer() as long_timer:
            got_long, want_long, used_long = _mesh_and_host(
                base, svc, view, "cfg3", long_body)
    finally:
        server.shutdown()
        server.server_close()
    for body, got, want in zip(bodies, mresp, responses):
        if without_took(got) != without_took(want):
            mismatches += 1
            log(f"  MISMATCH mesh REST {body}")
    if got_long != want_long:
        mismatches += 1
        log(f"  MISMATCH mesh REST {long_body}")
    long_merge_mode = launches.get("masked_topk_merge", 0) - before_long.get(
        "masked_topk_merge", 0)
    if not used_long or long_timer.merges != 1 or long_merge_mode or \
            long_timer.merge_input[0].shape[1] <= kern.MERGE_MAX_M:
        raise SmokeFailure(
            f"the size-{LONG_MERGE_SIZE} mesh request did not take the long "
            f"merge route: served {used_long}, {long_timer.merges} merges, "
            f"{long_merge_mode} merge-mode launches")
    if counters["served"] != len(bodies) + 2 or counters["fallbacks"] or \
            counters["exec_failures"]:
        raise SmokeFailure(f"mesh view fell back on eligible bodies: {counters}")
    merge_launches = launches.get("masked_topk_merge", 0) - before.get(
        "masked_topk_merge", 0)
    if timer.merges != len(bodies) or merge_launches != len(bodies):
        raise SmokeFailure(f"{timer.merges} merges and {merge_launches} K3 "
                           f"merge-mode launches for {len(bodies)} mesh "
                           "requests")
    flat, m, ids = timer.merge_input
    kp = min(m, flat.shape[1])
    _row(rows, "masked_topk_merge", "elasticsearch_tpu/parallel/sharded.py:717", 1,
         lambda: kern.masked_topk_merge(flat, m, ids),
         lambda: kern.masked_topk_merge_plain(flat, m, ids),
         lambda: torch.topk(flat, kp), "torch.topk",
         # the keys read; the ranked keys, int64 indices and ids written
         # (the ids read only at the winners)
         flat.numel() * 4 + kp * (4 + 8 + 4 + 4), device=True,
         case=f"mesh merge: [1, {flat.shape[1]}] gathered keys (S = "
              f"{N_SHARDS}, kk = {flat.shape[1] // N_SHARDS}), k = {m}, "
              f"ids taken")
    flat_l, m_l, ids_l = long_timer.merge_input
    kp_l = min(m_l, flat_l.shape[1])

    def long_plain():
        top, idx, _total = kern.masked_topk_batch_plain(
            flat_l, torch.ones_like(flat_l, dtype=torch.bool), m_l)
        idx = idx.to(torch.int64)
        return top, idx, torch.gather(ids_l, 1, idx)

    _row(rows, "masked_topk", "elasticsearch_tpu/parallel/sharded.py:717", 1,
         lambda: psh._merge_topk(flat_l, m_l, ids_l), long_plain,
         lambda: torch.topk(flat_l, kp_l), "torch.topk",
         flat_l.numel() * 4 + kp_l * (4 + 8 + 4 + 4), device=True,
         launches=long_timer.merges,
         case=f"mesh merge, long route: [1, {flat_l.shape[1]}] gathered "
              f"keys (S = {N_SHARDS}, kk = {flat_l.shape[1] // N_SHARDS}) > "
              f"MERGE_MAX_M, k = {m_l}, K3's row mode, a cast and a gather "
              f"of the ids")
    dev_ms = timer.device_ms()
    peak = int(torch.cuda.max_memory_allocated())
    fc_mesh = None
    if fc_check is not None:
        fc_mesh = _fc_mesh(card, dev, node, "cfg3", *fc_check, launches,
                           view=view)
    svc.search.mesh_view = None
    del view
    gc.collect()
    torch.cuda.empty_cache()
    result = {
        "layout": layout,
        "mismatches": mismatches,
        "snapshot_build_s": snapshot_s,
        "snapshot_bytes": snapshot_bytes,
        "view_build_s": view_build_s,
        "view_plane_bytes": counters["plane_bytes"],
        "mesh_p50_ms": percentile(lat, 50),
        "mesh_p99_ms": percentile(lat, 99),
        "host_loop_p50_ms": percentile(host_lat, 50),
        "host_loop_p99_ms": percentile(host_lat, 99),
        "device_ms_per_request_p50": percentile(dev_ms, 50),
        "device_ms_per_request_mean": sum(dev_ms) / len(dev_ms),
        "launches_per_request": n_launch / len(bodies),
        "merge_launches_per_request": timer.merges / len(bodies),
        "peak_device_bytes": peak,
        "view": counters,
        "phase_s": time.monotonic() - t_phase,
    }
    log(f"phase mesh cfg3: {'ok' if mismatches == 0 else 'FAILED'} "
        f"{json.dumps(result)} [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} mesh mismatches on cfg3")
    result["filter_cache"] = fc_mesh
    return result


def _mesh_and_host(base, svc, view, index, body):
    """(mesh answer, host-loop answer, served on the mesh) for one body
    over HTTP: the view installed, then set aside."""
    before = view.served
    got = http(base, "POST", f"/{index}/_search", body)
    used = view.served > before
    svc.search.mesh_view = None
    try:
        want = http(base, "POST", f"/{index}/_search", body)
    finally:
        svc.search.mesh_view = view
    return without_took(got), without_took(want), used


def run_mesh_aggs(card, dev, node, bodies, match_terms, launches) -> dict:
    """Phase mesh on cfg7's 8 x 125,000 index (run_aggs's node): the
    eligible aggregation bodies, four sorted searches walked with
    search_after and size-0 counts through a MeshView, each held to the
    host loop; one request of each ineligible shape, each falling back
    under the reference's reason."""
    from elasticsearch_tpu_torch.parallel.mesh_serving import MeshView
    from elasticsearch_tpu_torch.search.service import SearchRequest

    svc = node.indices["cfg7"]
    devices, layout = _mesh_devices(dev, AGG_SHARDS)
    view = _install_view(svc, devices)
    match = {"match": {"body": " ".join(match_terms)}}
    eligible = {nm: b for nm, b in bodies.items()
                if MeshView.eligible(SearchRequest.from_json(b))}
    walks = {
        "price_asc": {"query": match, "sort": [{"price": "asc"}]},
        "price_desc_missing_first": {"query": {"match_all": {}}, "sort": [
            {"price": {"order": "desc", "missing": "_first"}}]},
        "tag_x_price_asc": {"query": {"term": {"tag": "x"}},
                            "sort": [{"price": "asc"}, "_doc"]},
        "score_desc": {"query": match, "sort": [{"_score": "desc"}]},
    }
    counts = {
        "count_match": {"query": match, "size": 0},
        "count_tag": {"query": {"term": {"tag": "y"}}, "size": 0},
        "count_range": {"query": {"range": {"price": {"gte": 2000,
                                                      "lt": 7000}}},
                        "size": 0},
        "count_all": {"query": {"match_all": {}}, "size": 0,
                      "track_total_hits": True},
    }
    ineligible = [
        ("ineligible_shape", {"query": match, "rescore": {
            "window_size": 50, "query": {"rescore_query": {
                "term": {"tag": "x"}}}}}),
        ("sort_shape", {"query": match,
                        "sort": [{"price": "asc"}, {"ts": "desc"}]}),
        ("sort_shape", {"query": match, "sort": [{"_score": "asc"}]}),
        ("agg_shape", {"size": 0, "aggs": {"t": {"terms": {"field": "tag"},
                                                 "aggs": {"s": {"sum": {
                                                     "field": "price"}}}}}}),
        ("agg_shape", {"size": 0, "aggs": {"c": {"composite": {"sources": [
            {"t": {"terms": {"field": "tag"}}}]}}}}),
        ("agg_shape", {"query": match, "size": 0,
                       "aggs": {"h": {"top_hits": {"size": 3}}}}),
    ] + [("agg_shape", b) for nm, b in bodies.items() if nm not in eligible]
    mismatches = wrong_route = 0
    lat_mesh: list[float] = []
    server, base = serve(node)
    try:
        http(base, "POST", "/cfg7/_search", next(iter(eligible.values())))
        with counted("mesh REST cfg7", launches), MeshTimer() as timer:
            for nm, body in list(eligible.items()) + list(counts.items()):
                t0 = time.monotonic()
                got, want, used = _mesh_and_host(base, svc, view, "cfg7", body)
                lat_mesh.append((time.monotonic() - t0) * 1e3)
                if got != want:
                    mismatches += 1
                    log(f"  MISMATCH mesh cfg7 {nm}")
                if not used:
                    wrong_route += 1
                    log(f"  NOT SERVED on the mesh: cfg7 {nm} "
                        f"({view.last_fallback_reason})")
            pages = 0
            for nm, walk in walks.items():
                cursor = None
                for _page in range(MESH_WALK_PAGES):
                    body = {**walk, "size": 10}
                    if cursor is not None:
                        body["search_after"] = cursor
                    got, want, used = _mesh_and_host(base, svc, view, "cfg7",
                                                     body)
                    pages += 1
                    if got != want or not used:
                        mismatches += got != want
                        wrong_route += not used
                        log(f"  MISMATCH mesh cfg7 walk {nm} page {_page}")
                    hits = got["hits"]["hits"]
                    if not hits:
                        break
                    cursor = hits[-1]["sort"]
        reasons_bad = 0
        for reason, body in ineligible:
            before = dict(view.fallbacks)
            got, want, used = _mesh_and_host(base, svc, view, "cfg7", body)
            if used or view.fallbacks.get(reason, 0) != before.get(reason, 0) + 1:
                reasons_bad += 1
                log(f"  WRONG FALLBACK cfg7 {reason}: {view.fallbacks}")
            if got != want:
                mismatches += 1
                log(f"  MISMATCH mesh cfg7 fallback {reason}")
    finally:
        server.shutdown()
        server.server_close()
    counters = view.stats()
    svc.search.mesh_view = None
    del view
    dev_ms = timer.device_ms()
    result = {
        "layout": layout,
        "eligible_bodies": list(eligible),
        "walk_pages": pages,
        "mismatches": mismatches,
        "not_served": wrong_route,
        "wrong_fallbacks": reasons_bad,
        "device_ms_per_request_p50": percentile(dev_ms, 50),
        "mesh_plus_host_wall_p50_ms": percentile(lat_mesh, 50),
        "view": counters,
    }
    bad = mismatches + wrong_route + reasons_bad + counters["exec_failures"]
    log(f"phase mesh cfg7: {'ok' if bad == 0 else 'FAILED'} "
        f"{json.dumps(result)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} mesh faults on cfg7")
    return result


def run_mesh_phrase(card, dev, launches) -> dict:
    """Phase mesh's positional part: a 2-shard index of 2 x 100,000 docs
    drawn as phase phrase draws its corpus (build_zipf_segment and its
    TokenStream positions, seeds SEED + 30 + shard); five match_phrase
    bodies through the mesh and through the host loop; then, when the
    machine has two cards, the same over cuda:0 and cuda:1."""
    import torch

    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    t0 = time.monotonic()
    segs = []
    for s in range(2):
        _m, seg = build_zipf_segment(MESH_PHRASE_DOCS, seed=SEED + 30 + s)
        TokenStream(MESH_PHRASE_DOCS, SEED + 30 + s).add_positions(
            seg.fields["body"])
        segs.append(replace(seg, ids=[f"p{s}d{i}" for i in
                                      range(MESH_PHRASE_DOCS)]))
    stream = TokenStream(MESH_PHRASE_DOCS, SEED + 30)
    bodies = [b for name, b in _phrase_bodies(stream, segs[0].fields["body"])
              if name == "phrase"][:MESH_PHRASE_BODIES]
    del stream
    node = Node(device=DEVICE, mesh_devices=[dev, dev])
    node.create_index("mphrase", {
        "settings": {"index": {"number_of_shards": 2}},
        "mappings": {"properties": {"body": {"type": "text"}}},
    })
    svc = node.indices["mphrase"]
    for e, seg in zip(svc.engines, segs):
        e._install_segment(seg)
    build_s = time.monotonic() - t0
    views = {"one card": svc.search.mesh_view}
    if torch.cuda.device_count() >= 2:
        views["cuda:0 + cuda:1"] = None  # installed below
    else:
        log(f"  mesh distinct cards: not run ({torch.cuda.device_count()} "
            f"card on this machine) [{card}]")
    mismatches = not_served = hits = 0
    server, base = serve(node)
    try:
        for layout in list(views):
            view = views[layout]
            if view is None:
                view = _install_view(svc, [torch.device("cuda", 0),
                                           torch.device("cuda", 1)])
                views[layout] = view
            svc.search.mesh_view = view
            with counted(f"mesh phrase ({layout})", launches):
                for body in bodies:
                    got, want, used = _mesh_and_host(base, svc, view,
                                                     "mphrase", body)
                    hits += len(got["hits"]["hits"])
                    if got != want or not used:
                        mismatches += got != want
                        not_served += not used
                        log(f"  MISMATCH mesh phrase ({layout}) {body}")
    finally:
        server.shutdown()
        server.server_close()
    result = {
        "docs": 2 * MESH_PHRASE_DOCS, "bodies": len(bodies),
        "layouts": list(views), "hits": hits, "build_s": build_s,
        "mismatches": mismatches, "not_served": not_served,
        "views": {k: v.stats() for k, v in views.items()},
    }
    del views
    node.close()
    log(f"phase mesh phrase: "
        f"{'ok' if mismatches + not_served == 0 and hits else 'FAILED'} "
        f"{json.dumps(result)} [{card}]")
    if mismatches + not_served or not hits:
        raise SmokeFailure(f"mesh phrase: {mismatches} mismatches, "
                           f"{not_served} not served, {hits} hits")
    return result


def run_mesh_cards(card, launches, devices=None) -> dict:
    """Phase mesh on distinct cards: an index of one shard a card (n = the
    visible cards, at most 8) of MESH_CARDS_DOCS Zipf docs a shard
    (vocabulary 20,000, seed SEED + 40 + shard) with cfg7's `price` and
    `tag` columns, on a default Node, which takes every visible card and
    so serves the index over them. Held to the host loop: 16 bool(must +
    filter) and 16 match bodies, a search_after walk sorted on price,
    size-0 counts and a terms / histogram aggregation; mesh_snapshot's
    search on the same cards; with four or more cards, search_batch on a
    (2 replica x n/2 shard) grid of distinct cards, held to that index's
    search. `devices` replaces the cards (a rehearsal off the card)."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.parallel import sharded as psh
    from elasticsearch_tpu_torch.parallel.mesh import Mesh
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    if devices is None:
        n = min(torch.cuda.device_count(), N_SHARDS)
        devices = [torch.device("cuda", i) for i in range(n)]
        node = Node(device=DEVICE)  # mesh_devices: every visible card
    else:
        n = len(devices)
        node = Node(device=DEVICE, mesh_devices=devices)
    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 40)
    segs = []
    for s in range(n):
        _m, seg = build_zipf_segment(MESH_CARDS_DOCS, vocab_size=20_000,
                                     seed=SEED + 40 + s)
        price = rng.integers(0, 10_000, MESH_CARDS_DOCS).astype(np.float64)
        price[rng.random(MESH_CARDS_DOCS) < 0.1] = np.nan
        seg.fields["tag"] = _keyword_field(
            "tag", AGG_TAGS, rng.choice(len(AGG_TAGS), size=MESH_CARDS_DOCS))
        seg.doc_values["price"] = price
        segs.append(replace(seg, ids=[f"c{s}d{i}"
                                      for i in range(MESH_CARDS_DOCS)]))
    node.create_index("mcards", {
        "settings": {"index": {"number_of_shards": n}},
        "mappings": {"properties": {"body": {"type": "text"},
                                    "price": {"type": "long"},
                                    "tag": {"type": "keyword"}}},
    })
    svc = node.indices["mcards"]
    for e, seg in zip(svc.engines, segs):
        e._install_segment(seg)
    build_s = time.monotonic() - t0
    view = svc.search.mesh_view
    layout = [str(d) for d in devices]
    if view is None or [str(d) for d in view.mesh.devices.ravel()] != layout:
        raise SmokeFailure(f"mesh cards: the node's view is not over {layout}")
    log(f"phase mesh cards: layout {layout}, {n} x {MESH_CARDS_DOCS} docs "
        f"[{card}]")

    fld = segs[0].fields["body"]
    by_df = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])
    head = by_df[: len(by_df) // 100]
    mid = by_df[len(by_df) // 100 : len(by_df) // 4]
    qrng = np.random.default_rng(SEED + 41)
    bodies = []
    for _ in range(16):
        m1, m2 = qrng.choice(mid, 2, replace=False)
        bodies.append({"query": {"bool": {
            "must": [{"match": {"body": f"{m1} {m2}"}}],
            "filter": [{"term": {"body": str(qrng.choice(head))}}],
        }}, "size": TOP_K})
    for _ in range(16):
        terms = [str(qrng.choice(head))] + [
            str(t) for t in qrng.choice(mid, 3, replace=False)]
        bodies.append({"query": {"match": {"body": " ".join(terms)}},
                       "size": TOP_K})
    match = bodies[-1]["query"]
    others = [
        {"query": match, "size": 0},
        {"query": {"term": {"tag": "y"}}, "size": 0,
         "track_total_hits": True},
        {"query": match, "size": 0, "aggs": {
            "t": {"terms": {"field": "tag"}},
            "h": {"histogram": {"field": "price", "interval": 1000}}}},
    ]
    walk = {"query": match, "sort": [{"price": "asc"}], "size": TOP_K}
    mismatches = not_served = pages = 0
    host_hits = []
    server, base = serve(node)
    try:
        with counted("mesh cards REST", launches), MeshTimer() as timer:
            for body in bodies + others:
                got, want, used = _mesh_and_host(base, svc, view, "mcards",
                                                 body)
                if body in bodies:
                    host_hits.append(want)
                if got != want or not used:
                    mismatches += got != want
                    not_served += not used
                    log(f"  MISMATCH mesh cards {body} (served {used})")
            cursor = None
            for _page in range(MESH_WALK_PAGES):
                body = dict(walk)
                if cursor is not None:
                    body["search_after"] = cursor
                got, want, used = _mesh_and_host(base, svc, view, "mcards",
                                                 body)
                pages += 1
                if got != want or not used:
                    mismatches += got != want
                    not_served += not used
                    log(f"  MISMATCH mesh cards walk page {_page}")
                if not got["hits"]["hits"]:
                    break
                cursor = got["hits"]["hits"][-1]["sort"]
    finally:
        server.shutdown()
        server.server_close()
    counters = view.stats()
    svc.search.mesh_view = None
    del view

    queries = [parse_query(b["query"]) for b in bodies]
    sidx = svc.mesh_snapshot(Mesh(np.array(devices, dtype=object), ("shard",)))
    with counted("mesh cards ShardedIndex.search", launches):
        outs = [sidx.search(q, TOP_K) for q in queries]
    for body, out, (scores, gids, total) in zip(bodies, host_hits, outs):
        ids = [sidx.segments[s].ids[loc] for s, loc in map(sidx.locate, gids)]
        if not same_hits(out, ids, scores, total):
            mismatches += 1
            log(f"  MISMATCH mesh cards snapshot search {body}")
    del sidx
    grid_shape = None
    if n >= 4:
        m = n // 2
        grid = np.array(devices[: 2 * m], dtype=object).reshape(2, m)
        grid_shape = [2, m]
        idx = psh.ShardedIndex.from_segments(segs[:m], svc.mappings,
                                             Mesh(grid, ("batch", "shard")))
        want = [idx.search(q, TOP_K) for q in queries]
        with counted(f"mesh cards search_batch (2 x {m})", launches):
            mismatches += _batch_rows(idx, queries, want, 2)
        del idx, want
    node.close()
    gc.collect()
    result = {
        "layout": layout, "docs": n * MESH_CARDS_DOCS, "build_s": build_s,
        "bodies": len(bodies) + len(others), "walk_pages": pages,
        "grid": grid_shape, "mismatches": mismatches,
        "not_served": not_served, "merges": timer.merges,
        "device_ms_per_request_p50": percentile(timer.device_ms(), 50),
        "view": counters,
    }
    bad = mismatches + not_served + counters["exec_failures"]
    log(f"phase mesh cards: {'ok' if bad == 0 else 'FAILED'} "
        f"{json.dumps(result)} [{card}]")
    if bad:
        raise SmokeFailure(f"{bad} mesh faults on distinct cards")
    return result


# ---------------------------------------------------------------------------
# Phase `sequential` (kernel-table row 17): the strictly sequential chains,
# K15 chain_perturb
# ---------------------------------------------------------------------------

CHAIN_SOURCE = "elasticsearch_tpu_torch/csrc/chain_perturb.cu"
NEG_ZERO_BITS = -2147483648  # -0.0f as int32


def _bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def run_chain(card, name, chain, batched, per_query, n_q, launches,
              neg_zero_rows=()) -> tuple[dict, tuple]:
    """One chain of phase `sequential`: run it once with the launch counts
    zeroed (K15 must launch), hold it bit for bit to the same chain on the
    plain path, and each row's valid region to the per-query kernel
    (`per_query(r)`, the batch of one): ids and totals exact, scores exact
    but on `neg_zero_rows` (a -0.0 boost, which the chain makes +0.0),
    -inf past the row's hits. Then wall / Q after a synchronize, CUDA-event
    device ms / Q, host enqueue ms / Q, the batched executor's device ms /
    Q on the same plans, and the host syncs a step counted under
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    before = launches.get("chain_perturb", 0)
    with counted(f"sequential {name}", launches):
        out = chain()
    k15 = launches.get("chain_perturb", 0) - before
    if k15 < 1:
        raise SmokeFailure(f"chain {name}: K15 chain_perturb never launched")
    with plain_kernels():
        plain = chain()
    torch.cuda.synchronize()
    mismatches = sum(not _bits_equal(g, w) for g, w in zip(out, plain))
    if mismatches:
        log(f"  MISMATCH chain {name} against its plain chain")
    s, ids, tot = (x.cpu() for x in out)
    kk = s.shape[1]
    for r in range(n_q):
        s1, i1, t1 = (x.cpu()[0] for x in per_query(r))
        n = min(int(t1), kk)
        want = kern.chain_perturb_plain(s1[:n], None) if r in neg_zero_rows else s1[:n]
        if not (int(t1) == int(tot[r]) and torch.equal(i1[:n], ids[r, :n])
                and _bits_equal(s[r, :n], want)
                and bool(torch.all(s[r, n:] == float("-inf")))):
            mismatches += 1
            log(f"  MISMATCH chain {name} row {r} against the per-query kernel")
    # Three timed runs, the median of each time: one run's events also
    # take in any pause of the host thread (a collection) mid-chain.
    enqueue, wall, device = [], [], []
    for _ in range(3):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        chain()
        ev1.record()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        device.append(ev0.elapsed_time(ev1))
    enqueue_s, wall_s, device_ms = (sorted(x)[1] for x in (enqueue, wall, device))
    batched_ms = cuda_ms(batched, reps=3)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            chain()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    summary = {
        "queries": n_q, "k15_launches": k15, "mismatches": mismatches,
        "wall_ms_per_query": wall_s * 1e3 / n_q,
        "device_ms_per_query": device_ms / n_q,
        "host_enqueue_ms_per_query": enqueue_s * 1e3 / n_q,
        "batched_device_ms_per_query": batched_ms / n_q,
        "host_syncs_per_step": syncs / n_q,
    }
    log(f"phase sequential {name}: {'ok' if not mismatches else 'FAILED'} "
        f"{json.dumps(summary)} [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} chain {name} mismatches")
    return summary, out


def kernel_row_chain(rows, leaves, totals):
    """K15 over a chain's Q steps (Q = 32, cfg2's match plans): step r
    perturbs row r's top-level leaf against step r - 1's total, held to
    the plain version (exact) and timed beside one torch.add a step (the
    same sum, leaf + 0.0 * total; it returns the card's canonical NaN for
    a NaN leaf, where K15 keeps the operand's bits)."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    q = leaves.shape[0]
    prev = [None] + [totals[r - 1:r] for r in range(1, q)]
    zero = torch.zeros(1, dtype=torch.int32, device=leaves.device)
    steps = [(leaves[r:r + 1], prev[r]) for r in range(q)]
    _row(rows, "chain_perturb", "elasticsearch_tpu/ops/bm25_device.py:1085", q,
         lambda: [kern.chain_perturb(leaf, t) for leaf, t in steps],
         lambda: [kern.chain_perturb_plain(leaf, t) for leaf, t in steps],
         lambda: [torch.add(leaf, zero if t is None else t, alpha=0.0)
                  for leaf, t in steps],
         "torch.add(leaf, total, alpha=0.0) a step (no NaN bits kept)",
         # each step: the leaf read, the total read, the leaf written
         q * (8 * leaves[0].numel() + 4), source=CHAIN_SOURCE,
         case=f"{q} steps of a [1, {leaves[0].numel()}] leaf")


# ---------------------------------------------------------------------------
# Phase `stacked-tail` (kernel-table rows 14-15 and 16b over stacked
# shards): K11s-K14s
# ---------------------------------------------------------------------------

# Bodies of a shape the phase sends (index into the shape's bodies in
# _phrase_bodies / _structured_bodies order; 2 of every other shape).
STACKED_TAIL_PICK = {
    "span_near": [0, 1, 2, 3], "rank_feature": [0, 1, 2, 6],
    "geo_bounding_box": [0, 2], "terms_set": [0, 4],
    "function_score": [0, 1, 2, 3, 4, 5, 12, 13],
    "nested": [0, 1, 2, 3, 4, 10],
}
QA_SHARD_PARENTS = N_QA // N_SHARDS  # 125,000
STACKED_TAIL_ORACLE_PER_SHAPE = 2  # bodies of a shape held to the oracle
# Worklist lanes one stacked launch gathers at most (its rows x their
# tiles x 256): keeps the plain path's [rows, lanes] planes near 1 GB.
STACKED_TAIL_LANES = 1 << 27


def _pick_bodies(named):
    """The phase's subset: STACKED_TAIL_PICK's bodies of a shape, else its
    first two."""
    seen: dict = {}
    out = []
    for item in named:
        i = seen.get(item[0], 0)
        seen[item[0]] = i + 1
        if i in STACKED_TAIL_PICK.get(item[0], (0, 1)):
            out.append(item)
    return out


def build_qa_shards():
    """`qa` as 8 shards of 125,000 parents (phase `structured`'s 1,000,000
    cut into cfg3's shard count): each shard its own Zipf titles (seed
    SEED + 110 + s); ONE answers-per-parent draw (0-8 a parent,
    default_rng(SEED + 10)) and one inner answers segment (seed SEED + 11)
    for every shard, each shard laying the draw over its parents in its
    own permutation. So the nested blocks have equal shapes, which the
    reference's np.stack of the shards' trees requires, and each shard its
    own parent_of."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import NestedBlock
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    rng = np.random.default_rng(SEED + 10)
    counts = rng.integers(0, 9, QA_SHARD_PARENTS)
    nn = int(counts.sum())
    _m, inner = build_zipf_segment(nn, seed=SEED + 11, min_len=8, max_len=40,
                                   field="answers.body")
    inner.doc_values["answers.votes"] = rng.integers(-5, 200, nn).astype(np.float64)
    out = []
    for s in range(N_SHARDS):
        _m, seg = build_zipf_segment(QA_SHARD_PARENTS, seed=SEED + 110 + s,
                                     min_len=4, max_len=16, field="title")
        seg = replace(seg, ids=[f"q{s}d{i}" for i in range(QA_SHARD_PARENTS)])
        mine = np.random.default_rng(SEED + 120 + s).permutation(counts)
        seg.nested = {"answers": NestedBlock(seg=inner, parent_of=np.repeat(
            np.arange(QA_SHARD_PARENTS, dtype=np.int32), mine))}
        out.append(seg)
    return out


def _pack_stacked(segs, dev):
    """Pack shards to common shapes (ShardedIndex.from_segments' pads:
    docs, postings tiles, position tiles) and stack them: (devices,
    stacked tree, padded docs a shard)."""
    from elasticsearch_tpu_torch.index.tiles import TILE, pack_segment
    from elasticsearch_tpu_torch.ops import bm25_device

    n_pad = max(seg.num_docs for seg in segs)
    min_tiles: dict = {}
    pos_tiles: dict = {}
    for seg in segs:
        for name, fld in seg.fields.items():
            min_tiles[name] = max(min_tiles.get(name, 0),
                                  len(fld.doc_ids) // TILE + 2)
            if fld.positions is not None:
                pos_tiles[name] = max(pos_tiles.get(name, 0),
                                      len(fld.positions) // TILE + 2)
    with ThreadPoolExecutor(max_workers=4) as pool:  # numpy releases the GIL
        devs = list(pool.map(lambda seg: pack_segment(
            seg, device=dev, pad_docs_to=n_pad, field_min_tiles=min_tiles,
            field_pos_min_tiles=pos_tiles), segs))
    stree = bm25_device.stack_segment_trees(
        [bm25_device.segment_tree(d) for d in devs])
    return devs, stree, n_pad


def _worklist_tiles(arrays) -> int:
    """Worklist tiles a plan row gathers (its tile_ids leaves' widths)."""
    if isinstance(arrays, dict):
        own = arrays["tile_ids"].shape[-1] if "tile_ids" in arrays else 0
        return own + sum(_worklist_tiles(v) for k, v in arrays.items()
                         if k != "tile_ids")
    if isinstance(arrays, (tuple, list)):
        return sum(_worklist_tiles(v) for v in arrays)
    return 0


def _walk_label(mode, kw) -> str:
    from elasticsearch_tpu_torch.ops import kernels as kern

    if mode == kern.WALK_PHRASE:
        return "phrase"
    if mode == kern.WALK_NOT:
        return "not"
    if kw.get("end_limit", -1) >= 0:
        return "first"
    return "near" if kw.get("ordered", True) else "near-unordered"


@contextlib.contextmanager
def capture_stacked(captured: dict):
    """Record the first stacked launch's inputs of each K11s mode, K12s
    walk, K13s mode and K14s kind (the kernel rows replay them); every
    call still runs the real wrapper."""
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.ops import tail_kernel

    names = ("position_events_stacked", "position_walk_stacked", "doc_join",
             "doc_mark")
    real = {n: getattr(kern, n) for n in names}
    real_tail = tail_kernel.tail_eval
    last_events: list = []

    def events(*a, **kw):
        captured.setdefault(("events", a[9]), a)
        last_events[:] = [a]
        return real["position_events_stacked"](*a, **kw)

    def walk(*a, **kw):
        # The walk's inputs but K11's keys: the row recomputes them.
        captured.setdefault(("walk", _walk_label(a[8], kw)),
                            (last_events[0], a[2:], kw))
        return real["position_walk_stacked"](*a, **kw)

    def join(*a, **kw):
        if kw.get("n_shards"):
            captured.setdefault(("join", a[4]), (a, kw))
        return real["doc_join"](*a, **kw)

    def mark(*a, **kw):
        if kw.get("n_shards"):
            captured.setdefault(("mark",), (a, kw))
        return real["doc_mark"](*a, **kw)

    def tail(*a, **kw):
        if kw.get("n_shards"):
            captured.setdefault(("tail", a[0][0]), (a, kw))
        return real_tail(*a, **kw)

    for n, fn in zip(names, (events, walk, join, mark)):
        setattr(kern, n, fn)
    tail_kernel.tail_eval = tail
    try:
        yield captured
    finally:
        for n, fn in real.items():
            setattr(kern, n, fn)
        tail_kernel.tail_eval = real_tail


def _merged_page(pages, n_pad: int):
    """Per-shard oracle pages [(local ids, scores, total)] merged by (score
    desc, shard, rank): (global ids, scores, total)."""
    merged, total = [], 0
    for s, (ids, scores, t) in enumerate(pages):
        total += int(t)
        for rank, (d, sc) in enumerate(zip(ids, scores)):
            merged.append((-float(sc), s, rank, s * n_pad + int(d), sc))
    merged.sort(key=lambda t: t[:3])
    page = merged[:TOP_K]
    return [t[3] for t in page], [t[4] for t in page], total


def _stacked_tail_oracle(shape, index, body, segs, qa_segs, n_pad):
    """The numpy oracle of a body over the stacked shards, per shard with
    that shard's statistics (as the shards' plans are compiled), merged by
    (score desc, shard, rank): (ids, scores, total, ulps), or None where
    phases 6f / 6g have no oracle for the shape."""
    import numpy as np

    q = body["query"]
    if shape in ("phrase", "phrase_head", "phrase_absent"):
        words = q["match_phrase"]["body"].split()
        pages = []
        for seg in segs:
            fld = seg.fields["body"]
            ids, scores, t = phrase_oracle(
                fld, seg.num_docs, words, _phrase_weight(fld, seg.num_docs))
            pages.append(([int(d[1:]) for d in ids], scores, t))
        return (*_merged_page(pages, n_pad), 0)
    if shape == "ids":
        pages = []
        for s, seg in enumerate(segs):
            m = np.zeros(seg.num_docs, dtype=bool)
            prefix = f"s{s}d"
            m[[int(v[len(prefix):]) for v in q["ids"]["values"]
               if v.startswith(prefix)]] = True
            pages.append(_oracle_page(np.where(m, np.float32(1), np.float32(0)),
                                      m, int))
        return (*_merged_page(pages, n_pad), 0)
    pages, ulps = [], 0
    for seg, qa_seg in zip(segs, qa_segs):
        got = structured_oracle(shape, index, body,
                                qa_seg if index == "qa" else seg, qa_seg)
        if got is None:
            return None
        scores, matched, ulps = got
        pages.append(_oracle_page(scores, matched, int))
    return (*_merged_page(pages, n_pad), ulps)


def stacked_tail_draws():
    """Phase stacked-tail's draws for cfg3's shards, on four threads: each
    shard's body TokenStream (seed 100 + s, positions ordered) and
    structured_parts (seed 200 + s)."""
    def one(s, n):
        return TokenStream(n, 100 + s, positions=True), structured_parts(n, 200 + s)

    with ThreadPoolExecutor(max_workers=4) as pool:  # a shard a task
        out = list(pool.map(one, range(N_SHARDS), cfg3_shard_docs()))
    return [o[0] for o in out], [o[1] for o in out]


def run_stacked_tail(card, dev, shards, launches, rows) -> dict:
    """Phase `stacked-tail`: the positional and structured plans over
    stacked shards, the vmaps of the reference's execute_shards_batch.
    cfg3's 8 shards (seed 100 + s) gain their body positions
    (TokenStream(n, 100 + s), re-drawn from each shard's seed) and phase
    6g's title and columns (drawn from default_rng(200 + s)); `qa` is 8
    shards of 125,000 parents (build_qa_shards: one answers-per-parent
    draw, so the nested blocks stack). Both are packed to common shapes
    (field_pos_min_tiles among them) and stacked on the card. Traffic:
    _pick_bodies of phase 6f's phrase and span shapes and of phase 6g's
    structured kinds, each body compiled per shard with that shard's
    statistics, equalized, bucketed by plan_spec_buckets and run through
    execute_shards_batch (K11s-K14s); every answer bit for bit against the
    same launches on the plain path, and, where 6f / 6g have one, against
    the numpy oracle per shard merged by (score desc, shard, rank); then
    the K11s-K14s rows."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.exec.batcher import plan_spec_buckets
    from elasticsearch_tpu_torch.index.mapping import Mappings
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.query.compile import (
        CompiledQuery,
        Compiler,
        equalize_compiled,
        pad_arrays_to_spec,
        unify_specs,
    )
    from elasticsearch_tpu_torch.query.dsl import parse_query

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    streams, parts = drawn("stacked-tail", stacked_tail_draws)
    for seg, stream, part in zip(shards, streams, parts):
        stream.add_positions(seg.fields["body"])
        attach_structured(seg, part)
    qa_segs = drawn("qa shards", build_qa_shards)
    gen_s = time.monotonic() - t0
    t0 = time.monotonic()
    devs, stree, n_pad = _pack_stacked(shards, dev)
    qa_devs, qa_tree, qa_pad = _pack_stacked(qa_segs, dev)
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    log(f"  stacked-tail: shards with positions, title and columns built in "
        f"{gen_s:.1f} s ({sum(len(sg.fields['body'].positions) for sg in shards)} "
        f"body positions); stacked {N_SHARDS} x {n_pad} docs and qa "
        f"{N_SHARDS} x {qa_pad} parents ({qa_tree['nested']['answers']['tree']['live'].shape[-1]} "
        f"answers a shard) in {pack_s:.1f} s [{card}]")

    named = [(shape, "msmarco", body)
             for shape, body in _pick_bodies(_phrase_bodies(
                 streams[0], shards[0].fields["body"]))]
    for shape, index, body in _pick_bodies(_structured_bodies(shards[0],
                                                              qa_segs[0])):
        if shape == "ids":  # the shards' own ids: s<shard>d<doc>
            body = {**body, "query": {"ids": {"values": [
                f"s{int(v[1:]) % N_SHARDS}d{int(v[1:]) // N_SHARDS}"
                for v in body["query"]["ids"]["values"]]}}}
        named.append((shape, index, body))
    del streams
    mappings = {
        "msmarco": Mappings(properties={"body": {"type": "text"},
                                        **STRUCTURED_MAPPINGS}),
        "qa": Mappings(properties={"title": {"type": "text"}, "answers": {
            "type": "nested", "properties": {
                "body": {"type": "text"}, "votes": {"type": "long"}}}}),
    }
    compilers = {
        "msmarco": [Compiler(d.fields, d.doc_values, mappings["msmarco"],
                             id_index={i: j for j, i in enumerate(sg.ids)})
                    for d, sg in zip(devs, shards)],
        "qa": [Compiler(d.fields, d.doc_values, mappings["qa"], nested=d.nested)
               for d in qa_devs],
    }
    trees = {"msmarco": (stree, n_pad), "qa": (qa_tree, qa_pad)}
    t0 = time.monotonic()
    per_body = []
    for _shape, index, body in named:
        q = parse_query(body["query"])
        cs = equalize_compiled([c.compile(q) for c in compilers[index]])
        per_body.append(CompiledQuery(
            spec=cs[0].spec, arrays=bm25_device.stack_plans([c.arrays for c in cs])))
    launch_list = []  # (index, spec, positions, device plan [Qb, S, ...])
    for index in ("msmarco", "qa"):
        by_spec: dict = {}
        for pos, (c, (_s, ix, _b)) in enumerate(zip(per_body, named)):
            if ix == index:
                by_spec.setdefault(c.spec, []).append(pos)
        for bucket in plan_spec_buckets(list(by_spec.items()), n_shards=N_SHARDS):
            positions = [p for sp in bucket for p in by_spec[sp]]
            target = unify_specs(list(bucket))
            host = [pad_arrays_to_spec(per_body[p].spec, target, per_body[p].arrays)
                    for p in positions]
            lanes = max(1, _worklist_tiles(host[0])) * 256 * N_SHARDS
            per = max(1, min(8, STACKED_TAIL_LANES // lanes))
            for i in range(0, len(positions), per):
                launch_list.append((index, target, positions[i:i + per],
                                    bm25_device.plan_to_torch(
                                        target, bm25_device.stack_plans(
                                            host[i:i + per]), dev)))
    torch.cuda.synchronize()
    plan_s = time.monotonic() - t0

    def run_all():
        return [bm25_device.execute_shards_batch(
            trees[index][0], spec, plan, TOP_K, trees[index][1])
            for index, spec, _pos, plan in launch_list]

    captured: dict = {}
    with counted("stacked-tail", launches), capture_stacked(captured):
        outs = [tuple(t.cpu() for t in o) for o in run_all()]
    stacked_names = (["position_events_stacked", "position_walk_stacked",
                      "doc_mark_stacked"]
                     + [f"doc_join_{m}_stacked" for m in JOIN_MODES]
                     + [f"tail_eval_{k}_stacked" for k in TAIL_KINDS])
    missing = [n for n in stacked_names if launches.get(n, 0) < 1]
    if missing:
        raise SmokeFailure(f"stacked-tail traffic never launched {missing}")
    t0 = time.monotonic()
    with plain_kernels():
        plain = [tuple(t.cpu() for t in o) for o in run_all()]
    plain_s = time.monotonic() - t0
    vs_plain = vs_oracle = oracle_checked = 0
    per_shape: dict = {}
    for (index, _spec, positions, _p), got, want in zip(launch_list, outs, plain):
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            vs_plain += 1
            log(f"  MISMATCH stacked-tail plain {[named[p][0] for p in positions]}")
        s_b, g_b, t_b = (x.numpy() for x in got)
        for row, p in enumerate(positions):
            shape, _ix, body = named[p]
            if per_shape.get(shape, 0) >= STACKED_TAIL_ORACLE_PER_SHAPE:
                continue
            o = _stacked_tail_oracle(shape, index, body, shards, qa_segs,
                                     trees[index][1])
            if o is None:
                continue
            per_shape[shape] = per_shape.get(shape, 0) + 1
            oracle_checked += 1
            ids, scores, total, ulps = o
            n = len(ids)
            ok = int(t_b[row]) == total and bool(np.all(s_b[row][n:] == -np.inf))
            if ulps == 0:
                ok = ok and (list(g_b[row][:n]) == ids and np.array_equal(
                    score_bits(s_b[row][:n]), score_bits(scores)))
            else:
                ok = ok and ranked_match(g_b[row], s_b[row], ids, scores, ulps)
            if not ok:
                vs_oracle += 1
                log(f"  MISMATCH stacked-tail oracle {shape} {json.dumps(body)[:200]}")
    n_bodies = len(named)
    device_ms = cuda_ms(run_all, reps=1, warmup=0) / n_bodies
    kernel_rows_stacked_tail(captured, rows)
    summary = {
        "shards": N_SHARDS, "docs_per_shard_padded": n_pad,
        "qa_parents_per_shard": qa_pad, "bodies": n_bodies,
        "shapes": sorted({s for s, _i, _b in named}),
        "launches_batched": len(launch_list), "generate_s": gen_s,
        "pack_stack_s": pack_s, "compile_s": plan_s, "plain_s": plain_s,
        "mismatches_vs_plain": vs_plain, "oracle_checked": oracle_checked,
        "mismatches_vs_oracle": vs_oracle,
        "device_ms_per_body_batched": device_ms,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
    }
    log(f"phase stacked-tail: {'ok' if vs_plain + vs_oracle == 0 else 'FAILED'} "
        f"{json.dumps(summary)} [{card}]")
    if vs_plain or vs_oracle:
        raise SmokeFailure(f"{vs_plain} stacked-tail launches differ from the "
                           f"plain path, {vs_oracle} bodies from the oracle")
    del devs, qa_devs, stree, qa_tree, trees, launch_list, captured, outs, plain
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def kernel_rows_stacked_tail(captured, rows):
    """K11s (phrase and span modes) and K12s (each walk) on the phase's
    first stacked launch of each, K13s (each join mode, mark) and K14s
    (each node kind) likewise, at their Q x 8 rows, each against its plain
    version (exact), its bound, and one library call where there is one."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.ops import tail_kernel

    ref = "elasticsearch_tpu/ops/bm25_device.py"
    for mode, label in ((kern.EVENTS_PHRASE, "phrase"), (kern.EVENTS_SPAN, "span")):
        args = captured[("events", mode)]
        rr = args[2].shape[0]
        keys, count = kern.position_events_stacked(*args)
        unsorted, _valid = kern.event_keys(*args)
        _row(rows, "position_events_stacked",
             f"{ref}:{470 if label == 'phrase' else 545} (vmapped, :1161)", rr,
             lambda a=args: kern.position_events_stacked(*a),
             lambda a=args: kern.position_events_plain(*a),
             lambda u=unsorted: torch.sort(u, dim=1),
             "torch.sort over the packed keys",
             int(count.sum()) * 16 + args[2].numel() * 16 + rr * 4,
             source=PHRASE_SOURCES["position_events"], reps=3,
             case=f"{label} mode, {rr // N_SHARDS} x {N_SHARDS} rows, NT "
                  f"{args[2].shape[1]}")
        del keys, count, unsorted
    for label in ("phrase", "near", "near-unordered", "first", "not"):
        if ("walk", label) not in captured:
            raise SmokeFailure(f"stacked-tail traffic never walked [{label}]")
        ev, wargs, kw = captured[("walk", label)]
        keys, count = kern.position_events_stacked(*ev)
        args = (keys, count, *wargs)
        rr, num_docs = keys.shape[0], wargs[3]
        _row(rows, "position_walk_stacked",
             f"{ref}:{ {'phrase': 503, 'not': 641}.get(label, 567) } (vmapped, :1161)",
             rr, lambda a=args, k=kw: kern.position_walk_stacked(*a, **k),
             lambda a=args, k=kw: kern.position_walk_plain(*a, **k),
             None, "none: no one PyTorch call walks each doc's runs",
             int(count.sum()) * 8 + rr * num_docs * 5,
             source=PHRASE_SOURCES["position_walk"], reps=3,
             case=f"{label}, {rr // N_SHARDS} x {N_SHARDS} rows")
        del keys, count, args
    for mode in JOIN_MODES:
        (cm, cs, start, boost, _m), kw = captured[("join", mode)]
        rr, nn = cs.shape
        ns, n = start.shape[0], start.shape[1] - 1
        lengths = (start[:, 1:] - start[:, :-1]).to(torch.int64).repeat(
            rr // ns, 1).reshape(-1)
        data = torch.where(cm, cs, 0.0).reshape(-1)
        reduce = {"none": "max", "sum": "sum", "avg": "mean", "max": "max",
                  "min": "min"}[mode]
        a = (cm, cs, start, boost, mode)
        _row(rows, f"doc_join_{mode}_stacked", f"{ref}:271 (vmapped, :1161)", rr,
             lambda a=a, k=kw: kern.doc_join(*a, **k),
             lambda a=a: kern.doc_join_plain(*a),
             lambda d=data, ln=lengths, r=reduce: torch.segment_reduce(
                 d, r, lengths=ln),
             "torch.segment_reduce over every row's children (no fixed order)",
             rr * nn * 5 + ns * (n + 1) * 4 + rr * n * 5,
             source=STRUCT_SOURCES["doc_join"],
             case=f"nested {mode}, {rr // ns} x {ns} rows, {nn} children, "
                  f"{n} parents a shard")
    (ids, boost, n), kw = captured[("mark",)]
    rr = ids.shape[0]
    valid = (ids >= 0) & (ids < n)
    slots = (torch.arange(rr, device=ids.device).reshape(-1, 1) * (n + 1)
             + torch.where(valid, ids, n)).reshape(-1).to(torch.int64)
    _row(rows, "doc_mark_stacked", f"{ref}:200 (vmapped, :1161)", rr,
         lambda: kern.doc_mark(ids, boost, n, **kw),
         lambda: kern.doc_mark_plain(ids, boost, n),
         lambda: torch.zeros(rr * (n + 1), dtype=torch.bool,
                             device=ids.device).index_fill_(0, slots, True),
         "index_fill_ over every row's padded ids (the matched planes only)",
         ids.numel() * 4 + rr * n * 5, source=STRUCT_SOURCES["doc_join"],
         case=f"ids, {rr // N_SHARDS} x {N_SHARDS} rows, {ids.shape[1]} slots, "
              f"{n} docs a shard")
    replaces = {
        "function_score": 367, "geo_distance": 120, "geo_box": 128,
        "rank_feature": 141, "dismax": 208, "boosting": 178, "terms_set": 232,
    }
    for kind in TAIL_KINDS:
        (key, qq, n, planes, masks, columns, params), kw = captured[("tail", kind)]
        _src, _consts, be = tail_kernel.generate_source(key, stacked=True)
        calls = sum(line.count("libdevice.") for line in be.lines)
        flops = (len(be.lines) + 19 * calls) * n * qq
        nbytes = qq * n * (4 * len(be.plane_names) + len(be.mask_names) + 5) + sum(
            columns[c].numel() * 4 for c in be.column_names)
        args = (key, qq, n, planes, masks, columns, params)
        _row(rows, f"tail_eval_{kind}_stacked",
             f"{ref}:{replaces[kind]} (vmapped, :1161)", qq,
             lambda a=args, k=kw: tail_kernel.tail_eval(*a, **k),
             lambda a=args, k=kw: tail_kernel.tail_eval_plain(*a, **k), None,
             "none: no one PyTorch call computes the node's tail",
             nbytes, route="triton", source=STRUCT_SOURCES["tail_eval"],
             case=f"{kind}: {qq // N_SHARDS} x {N_SHARDS} rows, "
                  f"{len(be.lines)} statements, {calls} libdevice calls",
             flops=flops)
    torch.cuda.synchronize()
    log("  stacked-tail kernels: K11s-K14s bit-equal to their plain versions "
        "in every mode and kind")


def run_cards() -> dict:
    """`--cards`: the build, then phase mesh's distinct-card parts alone."""
    import torch

    from elasticsearch_tpu_torch.ops import kernels as kern

    card = card_line()
    if torch.cuda.device_count() < 2:
        raise SmokeFailure(f"--cards needs two or more cards, "
                           f"{torch.cuda.device_count()} visible")
    t0 = time.monotonic()
    kern.ensure_built()
    log(f"phase build: ok {time.monotonic() - t0:.2f} s [{card}]")
    launches: dict = {}
    result = {"mesh_phrase": run_mesh_phrase(card, torch.device(DEVICE),
                                             launches),
              "mesh_cards": run_mesh_cards(card, launches)}
    log(f"  launches over the distinct-card phases: {json.dumps(launches)}")
    return {"card": card, "kernels": [], "result": result}


def main() -> int:
    if not (REPO / "elasticsearch_tpu_torch" / "ops" / "kernels.py").exists():
        print("chip_smoke.py: the elasticsearch_tpu_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the port "
              "on the card and has nothing to report without one",
              file=sys.stderr)
        return 2
    try:
        report = run_cards() if sys.argv[1:] == ["--cards"] else run()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"{report['card']}", flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
