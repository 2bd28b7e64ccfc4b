"""The port's hand-written Hopper kernels, their bindings and their plain
PyTorch versions.

    K1 terms_scatter  csrc/terms_scatter.cu  worklist gather + BM25 impact +
                      ordered scatter (bm25_device._gather_tiles /
                      _eval_terms / _eval_terms_gather / _scatter_scored /
                      _terms_matched in the JAX package)
    K2 sparse_fold    csrc/sparse_fold.cu    candidate pairs, stable radix
                      sort by doc, run fold (_sparse_candidates); its
                      bounds mode (K2b bounds) also keeps a run head
                      eligible only inside its row's [lo, hi) doc range
                      (the packed plane's tenant mask, execute_batch_packed)
    K3 masked_topk    csrc/masked_topk.cu    top-k by (score desc, index
                      asc) + eligible count (the masked lax.top_k): every
                      mode but the merge mode takes one of three designs
                      (`topk_route`): the threshold select for k <=
                      ROW_SELECT_MAX_K, else the short-row sort (sorted
                      runs merged by rank) on rows of at most
                      SHORT_ROW_MAX entries and the large-k select (a
                      radix select on the composite) on longer ones; its
                      window mode (K3b window) reads only each row's
                      [lo, hi) of the plane and returns window-local ids
                      (the packed plane's dense lanes)
    K4 span_locate    csrc/span_locate.cu    binary search in a sorted
                      posting span (_span_locate / _span_member), each
                      thread stopping at the search's fixed point; its
                      fold mode (`span_fold_*`) searches and scores a
                      filter-led conjunction's must terms in one launch
                      (the must-term loop of _sparse_lead_inner)
    K3k keyed_topk    csrc/masked_topk.cu    K3's keyed mode: bottom-k,
                      field sorts and cursors (execute_score_asc /
                      execute_score_after / execute_sorted(_after)), its
                      key built in the kernel, on K3's three designs
    K5 window_rescore csrc/window_rescore.cu the rescore window's gather,
                      combine and top-k (_rescore_inner; scores_at's
                      gather in its gather mode)
    K7 vector_score   csrc/vector_score.cu   per-row dense_vector
                      similarity in one fixed reduction order: dense
                      mode (ann_device._scored_rows / exact_scores /
                      similarity_scores), gather mode (the IVF re-rank of
                      part_vectors[probes]) and script mode (the dot /
                      norm / distance planes of the script functions)
    K9 ivf_assign     csrc/ivf_assign.cu     nearest centroid of each row
                      (ann_device.assign_chunk)
    K3i masked_topk_ids csrc/masked_topk.cu  K3's id mode: top-k by (score
                      desc, id asc) with the ids from an int32 array (the
                      IVF survivors' merge)
    K3m masked_topk_merge csrc/masked_topk.cu  K3's merge mode: the top-k
                      of rows of at most MERGE_MAX_M gathered per-shard
                      keys, ranked in registers, with int64 indices and
                      the ids taken (the mesh merge, sharded._merge_topk)
    K10 bucket_fold   csrc/bucket_fold.cu    per-bucket count, sum, min and
                      max over rows cut into fixed chunks (aggs_device.
                      _bucket_metric_planes, the count scatters and
                      doc_counts of _eval_agg); its range mode reduces R
                      overlapping [lo, hi) ranges (`range`)

    K11 position_events csrc/position_events.cu  the position events of
                      phrase and span worklists, packed into 64-bit keys
                      and radix-sorted per row (the gather and sort of
                      bm25_device._eval_phrase / _gather_span_events)
    K12 position_walk csrc/position_walk.cu  one thread per doc walks its
                      sorted events: the phrase run count, the span chain
                      DP (_span_chain_ends with _segmented_cummax, the
                      unordered relabel, span_first's end limit), the
                      span_not scans, then freq -> BM25 over the row's
                      [N] planes (_span_freq_scores)
    K13 doc_join      csrc/doc_join.cu       the nested block join: one
                      thread per (row, parent) folds its children in
                      ascending order (sum / avg / max / min / none of
                      _eval_nested's scatters); its mark mode sets the
                      doc_set of ids queries
    K15 chain_perturb csrc/chain_perturb.cu  one step of the strictly
                      sequential chains: a plan's top-level leaf plus the
                      previous step's total (read on the device) times
                      0.0 (bm25_device._chain_perturb)

K6 script_eval, the Triton kernel generated from a script, lives in
ops/script_kernel.py, and K14 tail_eval, the Triton kernel generated per
structured plan node, in ops/tail_kernel.py; both count their launches
here.

Every kernel takes a leading row axis Q: the `*_batch` wrappers run Q
queries of one plan in one launch (the JAX package's vmapped
execute_batch / execute_batch_sparse), and each solo wrapper is its
`*_batch` wrapper over one row (x[None] in, [0] out), the call the
serving path makes for one request. The `*_stacked` wrappers (K1s-K4s)
are the same kernels in their stacked-shard mode (the vmaps of
execute_shards / execute_shards_batch): the planes are S shards' planes
stacked to equal shapes ([S, ...]) and row r is the pair (query r // S,
shard r % S), which reads shard r % S's planes; one launch serves all
Q x S pairs. K11-K14 take the same rows in their stacked modes
(`position_events_stacked`, `position_walk_stacked`, `doc_join(...,
n_shards=S)`, `doc_mark(..., n_shards=S)` and K14's `n_shards=`): K11
reads shard r % S's positional planes [S, PT, 256], K12 its norm_bytes
[S, N + 1], K13's join its child_start [S, N + 1] (the mark mode takes
the rows' shard-local ids as they are) and K14 its columns [S, N].

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The build runs on the first launch
(or `ensure_built()`), into `_build/<sources hash>/` beside the package,
and again whenever the sources change. Each source compiles in its own
nvcc process, all started together, then one link.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. For tensors on the CPU it runs the
plain version below it (for a batch, the solo plain version row by row);
for CUDA tensors it launches the kernel (on the current stream, without
synchronising) or raises — there is no fallback. `LAUNCHES` counts kernel
launches: under the kernel's name for one row, under `<name>_batch` for
more, under `<name>_stacked` in the stacked mode (plain runs do not
count); K3k, K5 and K6 count every launch under one name each
(`keyed_topk`, `window_rescore` / `window_rescore_gather`,
`script_eval`), as do K7 by mode (`vector_score`, `vector_score_gather`,
`vector_score_script`), K9 (`ivf_assign`), K3i (`masked_topk_ids`),
K10 by mode (`bucket_fold`, `bucket_fold_range`), K11
(`position_events`), K12 (`position_walk`), K13 by mode (`doc_join_none`,
`doc_join_sum`, `doc_join_avg`, `doc_join_max`, `doc_join_min`,
`doc_mark`), K14 by node kind (`tail_eval_<kind>`), K11-K14's stacked
modes under the same names plus `_stacked`, K15 (`chain_perturb`), K2's
bounds mode (`sparse_fold_bounds`) and K3's window mode (`masked_topk_window`),
whatever its row count. K1's matched-only launches (a constant filter's
bitmap, the filter cache's planes) count in `terms_scatter*` as every K1
launch does, and also in `MATCHED_ONLY_LAUNCHES` under the same names.
K4's fold mode counts as `span_fold`, `span_fold_batch` and
`span_fold_stacked` (by rows and mode, as K1-K4), K3's merge mode as
`masked_topk_merge`, whatever its row count. Every wrapper passes its
stream as the raw handle (`_stream`); K4's wrappers and its fold mode,
every K3 mode and K1's matched-only mode launch through `_launch` (one
pass of checks, the device switched only where it differs); K3's calls
also count by design in `TOPK_ROUTES` (`<name>:select`, `:short`,
`:large`).
Launches from several threads (the REST
handlers and the micro-batcher) share the one library and the caller's
current stream; the library loads once under `_lib_lock` and the counts
move under `_count_lock`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

TILE = 256

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # IEEE fp32 throughout: bit-identical scores need exact division, no
    # flush-to-zero and no mul+add contraction.
    "-prec-div=true", "-prec-sqrt=true", "-ftz=false", "-fmad=false",
    "-Xptxas", "-v",
)

# Longest row K3's short-row sort ranks whole (csrc/masked_topk.cu
# LK_SHORT_MAX); the large-k select ranks at most as many candidates
# (LK_FINAL_CAP), so a longer row ranks at most SHORT_ROW_MAX - 1.
SHORT_ROW_MAX = 16384
# The large-k select's constants (csrc/masked_topk.cu LK_*): a row's
# histogram bins and state ints, its S a quarter of the row at most, the
# candidates it ranks at the end; and the sorted runs (LK_RUN entries
# each) that the short-row sort and that last step merge by rank.
LK_BINS = 4096
LK_ROW_INTS = 16
LK_BCAP_DIV = 4
LK_FINAL_CAP = 16384
LK_RUN = 2048
# The threshold select's round and candidate buffer (KS_ROUND, KS_CAP).
KS_ROUND = 4096
KS_CAP = 2 * KS_ROUND + 8

KERNELS = ("terms_scatter", "sparse_fold", "masked_topk", "span_locate",
           "span_fold")

MODES = ("", "_batch", "_stacked")

# Kernels counted under one name whatever their row count.
ONE_NAME_KERNELS = (
    "keyed_topk", "window_rescore", "window_rescore_gather", "script_eval",
    "vector_score", "vector_score_gather", "vector_score_script",
    "ivf_assign", "masked_topk_ids", "bucket_fold", "bucket_fold_range",
    "position_events", "position_walk",
    "doc_join_none", "doc_join_sum", "doc_join_avg", "doc_join_max",
    "doc_join_min", "doc_mark",
    "tail_eval_function_score", "tail_eval_geo_distance",
    "tail_eval_geo_box", "tail_eval_rank_feature", "tail_eval_dismax",
    "tail_eval_boosting", "tail_eval_terms_set",
    "sparse_fold_bounds", "masked_topk_window", "chain_perturb",
    "masked_topk_merge",
)
# K11-K14's stacked modes, counted as `<name>_stacked`.
STACKED_ONE_NAME_KERNELS = tuple(
    name + "_stacked" for name in ONE_NAME_KERNELS
    if name.startswith(("position_", "doc_", "tail_eval_"))
)

LAUNCHES: dict[str, int] = {
    **{name + suffix: 0 for name in KERNELS for suffix in MODES},
    **{name: 0 for name in ONE_NAME_KERNELS + STACKED_ONE_NAME_KERNELS},
}
# K1's matched-only launches, a subset of LAUNCHES' terms_scatter counts.
MATCHED_ONLY_LAUNCHES: dict[str, int] = {
    "terms_scatter" + suffix: 0 for suffix in MODES
}
# K3's calls on the card by launch name and design (`topk_route`):
# "<name>:select", "<name>:short" and "<name>:large".
TOPK_ROUTE_NAMES = ("masked_topk", "masked_topk_batch", "masked_topk_stacked",
                    "masked_topk_ids", "masked_topk_window", "keyed_topk")
TOPK_ROUTES: dict[str, int] = {
    name + ":" + route: 0 for name in TOPK_ROUTE_NAMES
    for route in ("select", "short", "large")
}

# Longest row K3's merge mode ranks in one block (csrc/masked_topk.cu
# MERGE_MAX_M); longer merges go to K3's row mode.
MERGE_MAX_M = 4096

# Largest k of the threshold select (csrc/masked_topk.cu KS_MAX_K), which
# every K3 mode but the merge mode takes for 1 <= min(k, M) <= 256; a
# larger k takes the short-row sort (rows of at most SHORT_ROW_MAX) or the
# large-k select (`topk_route`).
ROW_SELECT_MAX_K = 256

# Largest rescore window K5 sorts in one block's shared memory (128 KB).
WINDOW_MAX = 16384

# Pairs one K2 launch sorts at most (16 B of scratch each): larger batches
# run as several launches over consecutive rows, with identical results.
SPARSE_FOLD_MAX_PAIRS = 1 << 28

BUILD_INFO: dict[str, object] = {}

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for name in MATCHED_ONLY_LAUNCHES:
            MATCHED_ONLY_LAUNCHES[name] = 0
        for name in TOPK_ROUTES:
            TOPK_ROUTES[name] = 0


def count_launch(name: str, n_shards: int = 0) -> None:
    """One launch of a kernel counted under one name (ONE_NAME_KERNELS),
    plus `_stacked` for a stacked-shard launch (n_shards > 0)."""
    if n_shards:
        name += "_stacked"
    with _count_lock:
        LAUNCHES[name] += 1


def _count(name: str, n_rows: int, n_shards: int = 0,
           matched_only: bool = False) -> None:
    """One launch of `name`: stacked (n_shards > 0), else by row count;
    K1's matched-only mode also counts in MATCHED_ONLY_LAUNCHES."""
    if n_shards:
        name += "_stacked"
    elif n_rows > 1:
        name += "_batch"
    with _count_lock:
        LAUNCHES[name] += 1
        if matched_only:
            MATCHED_ONLY_LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of elasticsearch_tpu_torch cannot be built"
    )


def _sources_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library (cached by content)."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    out_dir = BUILD_ROOT / _sources_hash(sources + headers)
    so_path = out_dir / "libesk.so"
    if so_path.exists():
        BUILD_INFO.setdefault("cached", True)
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so_path.exists():
            return so_path
        nvcc = _find_nvcc()
        t0 = time.monotonic()
        procs = []
        for src in sources:
            obj = out_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log = []
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        tmp = out_dir / "libesk.so.tmp"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *[str(o) for _s, o, _p in procs]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, so_path)
        BUILD_INFO.update(
            cached=False,
            seconds=time.monotonic() - t0,
            log="\n".join(log),
            path=str(so_path),
        )
    return so_path


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.esk_terms_scatter.argtypes = (
        [P] * 11 + [I, I, I, L, P, P, I, L, L, P]
    )
    lib.esk_terms_matched.argtypes = [P, P, P, P, I, I, L, P, I, L, P]
    lib.esk_sparse_fold.argtypes = (
        [P] * 6 + [I] * 5 + [P] * 9 + [I, I, L, P, P, P]
    )
    lib.esk_masked_topk.argtypes = [P, P, P, I, I, I, P, P, L, P, P, P]
    lib.esk_masked_topk_window.argtypes = [P] * 4 + [I] * 5 + [P, P, L, P, P, P]
    lib.esk_span_locate.argtypes = [P, L, P, P, I, I, P, I, I, I, P, P, I, P]
    lib.esk_span_fold.argtypes = [P, P, L, P, P, P, I, P, P, I, I, I, P, P, I, P]
    lib.esk_topk_merge.argtypes = [P, P, I, I, I, P, P, P, P]
    lib.esk_keyed_topk.argtypes = [P, L, P] + [I] * 6 + [P] * 4 + [L, P, P, P]
    lib.esk_window_gather.argtypes = [P, P, L, P, I, I, P, P, P]
    F = ctypes.c_float
    lib.esk_window_rescore.argtypes = [P, P, I, I, P, P, L, F, F, I, I, P, P, P]
    lib.esk_vector_score.argtypes = [P, L, I, P, I, P, I, I, I, I, I, L] + [P] * 5
    lib.esk_ivf_assign.argtypes = [P, I, P, I, I, P, P, P]
    lib.esk_bucket_fold.argtypes = [P, P, P, P, L, I, L] + [P] * 9
    lib.esk_range_fold.argtypes = [P, P, P, P, P, L, I, L] + [P] * 11
    lib.esk_position_events.argtypes = [P] * 6 + [I] * 8 + [I, L, I] + [P] * 5
    lib.esk_position_walk.argtypes = (
        [P] * 5 + [I] * 7 + [F, I, I, F, F] + [I, L, I] + [P] * 4
    )
    lib.esk_doc_join.argtypes = [P] * 4 + [I] * 5 + [P] * 3
    lib.esk_doc_mark.argtypes = [P, P, I, I, I, P, P, P]
    lib.esk_chain_perturb.argtypes = [P, P, L, P, P]
    for fn in (
        lib.esk_chain_perturb,
        lib.esk_doc_join,
        lib.esk_doc_mark,
        lib.esk_terms_scatter,
        lib.esk_terms_matched,
        lib.esk_sparse_fold,
        lib.esk_masked_topk,
        lib.esk_masked_topk_window,
        lib.esk_span_locate,
        lib.esk_span_fold,
        lib.esk_topk_merge,
        lib.esk_keyed_topk,
        lib.esk_window_gather,
        lib.esk_window_rescore,
        lib.esk_vector_score,
        lib.esk_ivf_assign,
        lib.esk_bucket_fold,
        lib.esk_range_fold,
        lib.esk_position_events,
        lib.esk_position_walk,
    ):
        fn.restype = ctypes.c_int


def ensure_built():
    """Build (if needed) and load the kernel library; returns it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build_library()))
                _bind(lib)
                _lib = lib
    return _lib


def _ptr(t: torch.Tensor | None, offset: int = 0):
    """Device address of t's first element (plus `offset` elements), as
    the int a c_void_p argument takes."""
    if t is None:
        return None
    return t.data_ptr() + offset * t.element_size()


def _stream(device: torch.device):
    """`device`'s current stream as its raw handle (Triton's launcher
    takes it the same way; no torch.cuda.Stream object is built)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def _check(t, name: str, dtype, ndim: int, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_all(device: torch.device, specs) -> None:
    """`_check` over (tensor, name, dtype, ndim) specs in one pass: a
    tensor that passes costs a few attribute reads, and the first that
    does not goes through `_check` for its message."""
    for t, name, dtype, ndim in specs:
        if not (isinstance(t, torch.Tensor) and t.dtype == dtype
                and t.dim() == ndim and t.device == device
                and t.is_contiguous()):
            _check(t, name, dtype, ndim, device)


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Call the C entry point fn(*args, stream) on `device`'s current
    stream (`_stream`), switching the current device only where it
    differs from the tensors' (a node over several cards). Raises on a
    non-zero return code."""
    if device.index == torch._C._cuda_getDevice():
        rc = fn(*args, _stream(device))
    else:
        with torch.cuda.device(device.index):
            rc = fn(*args, _stream(device))
    _check_rc(name, rc)


def _launchable(device: torch.device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); anything else is refused."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _f32_order(key: torch.Tensor) -> torch.Tensor:
    """Order-preserving unsigned bits of fp32 keys (as int64) under IEEE
    totalOrder, lax.top_k's order (-NaN < -inf < -0.0 < +0.0 < +inf <
    +NaN) — the composite K3, K3k and K5 sort by."""
    bits = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits & 0x80000000) != 0
    return torch.where(neg, (~bits) & 0xFFFFFFFF, bits | 0x80000000)


def stable_order(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Permutation that stably sorts non-negative integer keys ascending:
    an LSD radix sort one bit a pass, each pass a stable partition by
    `nonzero` (which returns indices in ascending order)."""
    order = torch.arange(keys.numel(), device=keys.device)
    keys = keys.to(torch.int64)
    for b in range(bits):
        bit = (keys[order] >> b) & 1
        order = order[
            torch.cat([torch.nonzero(bit == 0).flatten(),
                       torch.nonzero(bit == 1).flatten()])
        ]
    return order


def key_bits(num_docs: int) -> int:
    """Bits of a sparse candidate key: docs run 0..num_docs (the sentinel),
    ceil(log2(num_docs + 2)) bits."""
    return max(1, int(num_docs + 1).bit_length())




def _check_rows(name: str, t: torch.Tensor, n_rows: int, width: int) -> None:
    if tuple(t.shape) != (n_rows, width):
        raise ValueError(
            f"{name} must be [{n_rows}, {width}], got {tuple(t.shape)}"
        )


def _shard_stride(planes: torch.Tensor) -> int:
    """Elements of one shard's [NT, 256] plane: a stacked launch's shard
    stride."""
    return int(planes.shape[-2] * planes.shape[-1])


def _check_shards(n_shards: int, n_rows: int, planes: dict) -> None:
    """A stacked launch: S >= 1 shards, every plane [S, ...], and R rows
    that are whole (query, shard) pairs."""
    if n_shards < 1:
        raise ValueError("a stacked launch needs at least one shard")
    for name, t in planes.items():
        if t.shape[0] != n_shards:
            raise ValueError(
                f"{name} stacks {t.shape[0]} shards, expected {n_shards}"
            )
    if n_rows % n_shards:
        raise ValueError(
            f"{n_rows} rows are not whole (query, shard) pairs of "
            f"{n_shards} shards"
        )


def _shard(x: torch.Tensor, r: int, stacked: bool) -> torch.Tensor:
    """Row r's plane: shard r % S of a stacked [S, ...] plane, else x."""
    return x[r % x.shape[0]] if stacked else x


# ---------------------------------------------------------------------------
# Worklist groups (K1 ordering)
# ---------------------------------------------------------------------------


def term_groups(tile_ids, starts, ends) -> np.ndarray:
    """int32[G, 2] [e0, e1) runs of one term occurrence in a worklist:
    consecutive non-empty entries with the same [start, end) span and
    strictly increasing tile ids. Within a run every doc appears at most
    once; runs in order give the reference's accumulation order."""
    tile_ids = np.asarray(tile_ids, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    n = len(tile_ids)
    if n == 0:
        return np.zeros((0, 2), dtype=np.int32)
    real = starts < ends
    cont = np.zeros(n, dtype=bool)
    cont[1:] = (
        real[1:]
        & real[:-1]
        & (starts[1:] == starts[:-1])
        & (ends[1:] == ends[:-1])
        & (tile_ids[1:] > tile_ids[:-1])
    )
    heads = np.flatnonzero(real & ~cont)
    breaks = np.append(np.flatnonzero(~cont), n)
    tails = breaks[np.searchsorted(breaks, heads, side="right")]
    return np.stack([heads, tails], axis=1).astype(np.int32)


def batch_groups(tile_ids, starts, ends) -> np.ndarray:
    """int32[Q, G, 2]: term_groups of each row of [Q, nt] worklists, padded
    to the largest group count with empty [0, 0) groups."""
    tile_ids = np.asarray(tile_ids)
    rows = [
        term_groups(tile_ids[q], np.asarray(starts)[q], np.asarray(ends)[q])
        for q in range(tile_ids.shape[0])
    ]
    out = np.zeros((len(rows), max([len(g) for g in rows] + [0]), 2),
                   dtype=np.int32)
    for q, g in enumerate(rows):
        out[q, : len(g)] = g
    return out


# ---------------------------------------------------------------------------
# K1 terms_scatter
# ---------------------------------------------------------------------------


def _gather_valid(doc_tiles, tile_ids, starts, ends):
    tid = tile_ids.to(torch.int64)
    docs = doc_tiles[tid]  # [NT, TILE]
    lane = torch.arange(TILE, device=doc_tiles.device, dtype=torch.int64)
    pos = tid[:, None] * TILE + lane
    valid = (pos >= starts.to(torch.int64)[:, None]) & (
        pos < ends.to(torch.int64)[:, None]
    )
    return tid, docs, valid


def terms_scatter_plain(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs: int, groups, cache=None, matched_only: bool = False,
):
    tid, docs, valid = _gather_valid(doc_tiles, tile_ids, starts, ends)
    dev = doc_tiles.device
    matched = torch.zeros(num_docs + 1, dtype=torch.bool, device=dev)
    matched[docs[valid].to(torch.int64)] = True
    if matched_only:
        return None, matched
    x = vals[tid]
    if cache is not None:
        x = x * cache[norm_bytes[docs.to(torch.int64)].to(torch.int64)]
    w = weights[:, None]
    contrib = w - w / (1.0 + x)
    scores = torch.zeros(num_docs + 1, dtype=torch.float32, device=dev)
    for e0, e1 in np.asarray(groups).reshape(-1, 2).tolist():
        v = valid[e0:e1]
        d = docs[e0:e1][v].to(torch.int64)
        scores[d] = scores[d] + contrib[e0:e1][v]
    return scores, matched


def terms_scatter_batch_plain(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs: int, groups, cache=None, matched_only: bool = False,
):
    """The batched K1 as the solo plain version row by row; with stacked
    planes ([S, NT, 256], [S, N + 1]), row q reads shard q % S's."""
    st = doc_tiles.dim() == 3
    outs = [
        terms_scatter_plain(
            _shard(doc_tiles, q, st), _shard(vals, q, st),
            _shard(norm_bytes, q, st), tile_ids[q], starts[q], ends[q],
            None if matched_only else weights[q], num_docs, groups[q],
            cache=None if cache is None else cache[q],
            matched_only=matched_only,
        )
        for q in range(tile_ids.shape[0])
    ]
    matched = torch.stack([m for _s, m in outs])
    if matched_only:
        return None, matched
    return torch.stack([s for s, _m in outs]), matched


def terms_scatter_batch(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs: int, groups, cache=None, matched_only: bool = False,
):
    """BM25 term-disjunction scatter over Q tile worklists at once.

    tile_ids/starts/ends/weights are [Q, nt], cache [Q, 256] or None, and
    `groups` is the host-side batch_groups(...) int32[Q, G, 2] of the
    worklists. Returns (scores f32[Q, num_docs + 1] or None in
    matched-only mode, matched bool[Q, num_docs + 1]); slot num_docs of
    each row is the discard slot. Matched-only mode reads no weights,
    groups, cache or norm plane: on the card it is one host call into the
    library (esk_terms_matched: the plane's memset, then one launch)."""
    return _terms_scatter(
        doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
        num_docs, groups, cache, matched_only, 0,
    )


def terms_scatter_stacked(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs: int, groups, cache=None, matched_only: bool = False,
):
    """K1s: terms_scatter_batch over R = Q x S rows of S stacked shards.

    doc_tiles/vals are [S, NT, 256] and norm_bytes [S, num_docs + 1]
    (num_docs: the padded per-shard doc count); row r of the [R, ...]
    worklists is (query r // S, shard r % S) and reads shard r % S's
    planes. Returns [R, num_docs + 1] planes as terms_scatter_batch."""
    return _terms_scatter(
        doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
        num_docs, groups, cache, matched_only, doc_tiles.shape[0],
    )


terms_scatter_stacked_plain = terms_scatter_batch_plain


def _terms_scatter(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs, groups, cache, matched_only, n_shards,
):
    """Check K1's inputs (planes stacked iff n_shards > 0), then run the
    plain version for CPU tensors or launch the kernel."""
    if matched_only:
        return _terms_matched(
            doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
            num_docs, groups, cache, n_shards,
        )
    dev = doc_tiles.device
    st = 1 if n_shards else 0
    _check(doc_tiles, "doc_tiles", torch.int32, 2 + st, dev)
    _check(vals, "vals", torch.float32, 2 + st, dev)
    _check(norm_bytes, "norm_bytes", torch.uint8, 1 + st, dev)
    _check(tile_ids, "tile_ids", torch.int32, 2, dev)
    q, nt = tile_ids.shape
    for name, t, dt in (("starts", starts, torch.int32),
                        ("ends", ends, torch.int32)):
        _check(t, name, dt, 2, dev)
        _check_rows(name, t, q, nt)
    if doc_tiles.shape[-1] != TILE or vals.shape != doc_tiles.shape:
        raise ValueError("tile planes must be [NT, 256] and alike")
    if norm_bytes.shape[-1] != num_docs + 1:
        raise ValueError("norm_bytes must have num_docs + 1 slots")
    if n_shards:
        _check_shards(n_shards, q, {"doc_tiles": doc_tiles,
                                    "norm_bytes": norm_bytes})
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    _check(weights, "weights", torch.float32, 2, dev)
    _check_rows("weights", weights, q, nt)
    if cache is not None:
        _check(cache, "cache", torch.float32, 2, dev)
        _check_rows("cache", cache, q, 256)
    groups = np.ascontiguousarray(np.asarray(groups, dtype=np.int32))
    if groups.ndim != 3 or groups.shape[0] != q or groups.shape[2] != 2:
        raise ValueError(f"groups must be [{q}, G, 2], got {groups.shape}")
    if not _launchable(dev):
        return terms_scatter_batch_plain(
            doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
            num_docs, groups, cache=cache,
        )
    return _terms_scatter_launch(
        doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
        num_docs, groups, cache, n_shards,
    )


def _terms_matched(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs, groups, cache, n_shards,
):
    """K1's matched-only mode: check what its kernel reads (the postings
    and the worklists; it takes no weights, groups, cache or norm plane),
    then run the plain version for CPU tensors or make one host call into
    the library, esk_terms_matched (the plane's memset and one launch).
    Returns (None, matched bool[Q, num_docs + 1])."""
    dev = doc_tiles.device
    _check_all(dev, ((doc_tiles, "doc_tiles", torch.int32, 3 if n_shards else 2),
                     (tile_ids, "tile_ids", torch.int32, 2),
                     (starts, "starts", torch.int32, 2),
                     (ends, "ends", torch.int32, 2)))
    q, nt = tile_ids.shape
    if starts.shape != tile_ids.shape or ends.shape != tile_ids.shape:
        raise ValueError(f"starts and ends must be [{q}, {nt}] like tile_ids")
    if doc_tiles.shape[-1] != TILE:
        raise ValueError("doc_tiles must be [NT, 256] tiles")
    if n_shards:
        _check_shards(n_shards, q, {"doc_tiles": doc_tiles})
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if not _launchable(dev):
        return terms_scatter_batch_plain(
            doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
            num_docs, groups, cache=cache, matched_only=True,
        )
    if doc_tiles.data_ptr() % 16:
        raise ValueError("doc_tiles must be 16-byte aligned (16-byte loads)")
    matched = torch.empty((q, num_docs + 1), dtype=torch.bool, device=dev)
    _launch(
        "terms_scatter", dev, ensure_built().esk_terms_matched,
        doc_tiles.data_ptr(), tile_ids.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), q, nt, num_docs + 1, matched.data_ptr(),
        max(1, n_shards), _shard_stride(doc_tiles),
    )
    _count("terms_scatter", q, n_shards, matched_only=True)
    return None, matched


def _terms_scatter_launch(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs, groups, cache, n_shards,
):
    """Launch K1 on checked inputs: worklists [Q, nt], groups
    int32[Q, G, 2]; outputs [Q, num_docs + 1]."""
    dev = doc_tiles.device
    lib = ensure_built()
    q, nt = tile_ids.shape
    n_groups = groups.shape[1]
    out_shape = (q, num_docs + 1)
    group_len = bounds = None
    if q > 1:
        group_len = np.ascontiguousarray(
            (groups[:, :, 1] - groups[:, :, 0]).max(axis=0, initial=0),
            dtype=np.int32,
        )
        # Pinned and asynchronous: a pageable copy would stall the host
        # until the stream drains. One row passes its bounds as launch
        # arguments instead.
        bounds = torch.from_numpy(groups).pin_memory().to(dev, non_blocking=True)
    matched = torch.zeros(out_shape, dtype=torch.bool, device=dev)
    scores = torch.zeros(out_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_terms_scatter(
            _ptr(doc_tiles), _ptr(vals), _ptr(norm_bytes), _ptr(cache),
            _ptr(tile_ids), _ptr(starts), _ptr(ends), _ptr(weights),
            ctypes.c_void_p(groups.ctypes.data),  # host int32[Q, G, 2]
            _ptr(bounds),
            # host int32[G], or None: one row's own group lengths
            None if group_len is None else ctypes.c_void_p(group_len.ctypes.data),
            int(n_groups), int(q), int(nt), int(num_docs + 1),
            _ptr(scores), _ptr(matched),
            max(1, n_shards), _shard_stride(doc_tiles),
            int(norm_bytes.shape[-1]),
            _stream(dev),
        )
    _check_rc("terms_scatter", rc)
    _count("terms_scatter", q, n_shards)
    return scores, matched


def terms_scatter(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs: int, groups, cache=None, matched_only: bool = False,
):
    """K1 for one worklist: terms_scatter_batch over one row. Returns
    (scores f32[num_docs + 1] or None in matched-only mode, matched
    bool[num_docs + 1]); `groups` is term_groups(...) of the worklist."""
    scores, matched = terms_scatter_batch(
        doc_tiles, vals, norm_bytes, tile_ids[None], starts[None],
        ends[None], None if weights is None else weights[None], num_docs,
        np.asarray(groups, dtype=np.int32).reshape(1, -1, 2),
        cache=None if cache is None else cache[None],
        matched_only=matched_only,
    )
    return (None if scores is None else scores[0]), matched[0]


# ---------------------------------------------------------------------------
# K2 sparse_fold
# ---------------------------------------------------------------------------


def sparse_fold_plain(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int, lo=None, hi=None,
):
    tid, docs, valid = _gather_valid(doc_tiles, tile_ids, starts, ends)
    w = weights[:, None]
    contrib = w - w / (1.0 + tn[tid])
    docs = torch.where(valid, docs, num_docs).reshape(-1)
    contrib = torch.where(valid, contrib, 0.0).reshape(-1)
    order = stable_order(docs, key_bits(num_docs))
    docs_s = docs[order]
    c_s = contrib[order]
    p = docs_s.shape[0]
    pad_docs = torch.full((t_pad,), num_docs + 1, dtype=docs_s.dtype,
                          device=docs_s.device)
    docs_ext = torch.cat([docs_s, pad_docs])
    c_ext = torch.cat([c_s, torch.zeros(t_pad, dtype=c_s.dtype,
                                        device=c_s.device)])
    run_sum = c_s
    for j in range(1, t_pad):
        same = docs_ext[j : j + p] == docs_s
        run_sum = run_sum + torch.where(same, c_ext[j : j + p], 0.0)
    head = torch.ones(p, dtype=torch.bool, device=docs_s.device)
    head[1:] = docs_s[1:] != docs_s[:-1]
    in_range = docs_s != num_docs
    live_at = live[torch.clamp(docs_s, max=num_docs - 1).to(torch.int64)]
    eligible = head & in_range & live_at
    if lo is not None:
        eligible = eligible & (docs_s >= lo) & (docs_s < hi)
    return docs_s, run_sum, eligible


def sparse_fold_batch_plain(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int,
):
    """The batched K2 as the solo plain version row by row; with stacked
    planes ([S, NT, 256], live [S, N]), row q reads shard q % S's."""
    st = doc_tiles.dim() == 3
    outs = [
        sparse_fold_plain(
            _shard(doc_tiles, q, st), _shard(tn, q, st), tile_ids[q],
            starts[q], ends[q], weights[q], _shard(live, q, st), num_docs,
            t_pad,
        )
        for q in range(tile_ids.shape[0])
    ]
    return tuple(torch.stack(col) for col in zip(*outs))


def sparse_fold_batch(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int,
):
    """Candidate-centric fold of Q terms worklists ([Q, nt] each).

    Returns (docs_s i32[Q, P], run_sum f32[Q, P], eligible bool[Q, P]) with
    P = nt * 256: each row's (doc, contrib) pairs stably sorted by doc,
    each position's left fold over its run (at most t_pad entries), and
    eligible = run head & doc < num_docs & live[doc]. A batch of more than
    SPARSE_FOLD_MAX_PAIRS pairs runs as several launches over consecutive
    rows."""
    return _sparse_fold(
        doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs,
        t_pad, 0,
    )


def sparse_fold_stacked(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int,
):
    """K2s: sparse_fold_batch over R = Q x S rows of S stacked shards.

    doc_tiles/tn are [S, NT, 256] and live [S, num_docs] (num_docs: the
    padded per-shard doc count, which sets the sentinel and the key
    width); row r of the [R, nt] worklists is (query r // S, shard
    r % S) and reads shard r % S's planes."""
    return _sparse_fold(
        doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs,
        t_pad, doc_tiles.shape[0],
    )


sparse_fold_stacked_plain = sparse_fold_batch_plain


def sparse_fold_bounds_plain(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int, lo, hi,
):
    """K2b bounds mode as the solo plain version row by row, row q's run
    heads also required to lie in [lo[q], hi[q])."""
    outs = [
        sparse_fold_plain(
            doc_tiles, tn, tile_ids[q], starts[q], ends[q], weights[q], live,
            num_docs, t_pad, lo[q], hi[q],
        )
        for q in range(tile_ids.shape[0])
    ]
    return tuple(torch.stack(col) for col in zip(*outs))


def sparse_fold_bounds(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int, lo, hi,
):
    """K2b's bounds mode: sparse_fold_batch over Q worklists of one
    packed plane, where a run head is eligible only if its doc is in
    range, live AND inside its row's [lo[q], hi[q]) (lo, hi: int32[Q],
    the lanes' tenant doc bounds). Counted as `sparse_fold_bounds`."""
    dev = doc_tiles.device
    for name, t in (("lo", lo), ("hi", hi)):
        _check(t, name, torch.int32, 1, dev)
        if t.shape[0] != tile_ids.shape[0]:
            raise ValueError(f"{name} must have one bound per row")
    return _sparse_fold(
        doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs,
        t_pad, 0, bounds=(lo, hi),
    )


def _sparse_fold(
    doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs, t_pad,
    n_shards, bounds=None,
):
    dev = doc_tiles.device
    st = 1 if n_shards else 0
    _check(doc_tiles, "doc_tiles", torch.int32, 2 + st, dev)
    _check(tn, "tn", torch.float32, 2 + st, dev)
    _check(tile_ids, "tile_ids", torch.int32, 2, dev)
    q, nt = tile_ids.shape
    for name, t, dt in (("starts", starts, torch.int32),
                        ("ends", ends, torch.int32),
                        ("weights", weights, torch.float32)):
        _check(t, name, dt, 2, dev)
        _check_rows(name, t, q, nt)
    _check(live, "live", torch.bool, 1 + st, dev)
    if doc_tiles.shape[-1] != TILE or tn.shape != doc_tiles.shape:
        raise ValueError("tile planes must be [NT, 256] and alike")
    if live.shape[-1] != num_docs or num_docs < 1:
        raise ValueError("live must have num_docs >= 1 entries")
    if n_shards:
        _check_shards(n_shards, q, {"doc_tiles": doc_tiles, "live": live})
    if not 1 <= t_pad <= 1024:
        raise ValueError(f"t_pad {t_pad} out of range")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    p = nt * TILE
    if p >= 2**31:
        raise ValueError("worklist too large for int32 positions")
    if not _launchable(dev):
        if bounds is not None:
            return sparse_fold_bounds_plain(
                doc_tiles, tn, tile_ids, starts, ends, weights, live,
                num_docs, t_pad, *bounds,
            )
        return sparse_fold_batch_plain(
            doc_tiles, tn, tile_ids, starts, ends, weights, live,
            num_docs, t_pad,
        )
    return _sparse_fold_launch(
        doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs,
        t_pad, n_shards, bounds,
    )


def _sparse_fold_launch(
    doc_tiles, tn, tile_ids, starts, ends, weights, live, num_docs, t_pad,
    n_shards, bounds=None,
):
    """Launch K2 on checked [Q, nt] worklists, in as many launches over
    consecutive rows as SPARSE_FOLD_MAX_PAIRS asks; outputs [Q, P]."""
    dev = doc_tiles.device
    lib = ensure_built()
    q, nt = tile_ids.shape
    p = nt * TILE
    out_shape = (q, p)
    i32, f32 = torch.int32, torch.float32
    per = max(1, min(q, SPARSE_FOLD_MAX_PAIRS // max(1, p)))
    n = per * p
    keys_a = torch.empty(n, dtype=i32, device=dev)
    vals_a = torch.empty(n, dtype=f32, device=dev)
    keys_b = torch.empty(n, dtype=i32, device=dev)
    vals_b = torch.empty(n, dtype=f32, device=dev)
    counts = torch.empty(256 * per * max(1, -(-p // 4096)), dtype=i32,
                         device=dev)
    docs_s = torch.empty(out_shape, dtype=i32, device=dev)
    run_sum = torch.empty(out_shape, dtype=f32, device=dev)
    eligible = torch.empty(out_shape, dtype=torch.bool, device=dev)
    lo, hi = bounds if bounds is not None else (None, None)
    for r0 in range(0, q, per):
        rows = min(per, q - r0)
        with torch.cuda.device(dev):
            rc = lib.esk_sparse_fold(
                _ptr(doc_tiles), _ptr(tn), _ptr(tile_ids, r0 * nt),
                _ptr(starts, r0 * nt), _ptr(ends, r0 * nt),
                _ptr(weights, r0 * nt), int(rows), int(nt), int(num_docs),
                int(t_pad), key_bits(num_docs), _ptr(live), _ptr(keys_a),
                _ptr(vals_a), _ptr(keys_b), _ptr(vals_b), _ptr(counts),
                _ptr(docs_s, r0 * p), _ptr(run_sum, r0 * p),
                _ptr(eligible, r0 * p), int(r0), max(1, n_shards),
                _shard_stride(doc_tiles), _ptr(lo, r0), _ptr(hi, r0),
                _stream(dev),
            )
        _check_rc("sparse_fold", rc)
        if bounds is not None:
            count_launch("sparse_fold_bounds")
        else:
            _count("sparse_fold", q, n_shards)
    return docs_s, run_sum, eligible


def sparse_fold(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int,
):
    """K2 for one worklist: sparse_fold_batch over one row. Returns
    (docs_s i32[P], run_sum f32[P], eligible bool[P]), P = nt * 256."""
    out = sparse_fold_batch(
        doc_tiles, tn, tile_ids[None], starts[None], ends[None],
        weights[None], live, num_docs, t_pad,
    )
    return tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# K3 masked_topk
# ---------------------------------------------------------------------------


def _check_topk_limit(k: int, kp: int, width: int) -> None:
    """A row longer than SHORT_ROW_MAX ranks at most SHORT_ROW_MAX - 1."""
    if kp >= SHORT_ROW_MAX and width > SHORT_ROW_MAX:
        raise ValueError(
            f"k={k} exceeds the top-k kernel's window ({SHORT_ROW_MAX - 1})"
        )


def topk_route(kp: int, width: int) -> str:
    """The design a K3 call takes on the card (csrc/masked_topk.cu
    `topk_run`) for kp = min(k, width) ranks over rows of `width` entries
    (the window mode: min(k, M, the widest window) over the widest
    window): "select" (the threshold select) for 1 <= kp <=
    ROW_SELECT_MAX_K, else "short" (the short-row sort) for width <=
    SHORT_ROW_MAX, else "large" (the large-k select)."""
    if 1 <= kp <= ROW_SELECT_MAX_K:
        return "select"
    return "short" if width <= SHORT_ROW_MAX else "large"


def large_k_bcap(width: int) -> int:
    """The large-k select's S a row (composites): a quarter of the row
    (LK_BCAP_DIV), at least LK_FINAL_CAP, at most the row."""
    return min(width, max(LK_FINAL_CAP, width // LK_BCAP_DIV))


def _topk_buffers(dev, q: int, width: int, kp: int, out_k: int):
    """A K3 call's one allocation, as csrc/masked_topk.cu's TopkCall lays
    it out: an int64 tensor whose int32 words hold the outputs (values
    f32 [q, out_k], ids i32 [q, out_k]), then the counts (total, n_after,
    the select's tickets, a spare plane; the large-k select's row states
    and histograms after them), then the scratch (u64: the select's
    survivors, the short-row sort's sorted runs for rows longer than one
    run, or the large-k select's F (LK_FINAL_CAP a row) then S). Returns
    (values, ids, counts, addresses (values, ids, counts, scratch),
    scratch_row, route)."""
    route = topk_route(kp, width)
    n_counts = 4 * q
    scratch_row = 0
    n_scratch = 0
    if route == "select":
        scratch_row = max(1, min(-(-width // KS_ROUND), KS_CAP // kp)) * kp
        n_scratch = q * scratch_row
    elif route == "short":
        scratch_row = -(-width // LK_RUN) * LK_RUN if width > LK_RUN else 0
        n_scratch = q * scratch_row
    else:
        n_counts += q * (LK_ROW_INTS + LK_BINS)
        scratch_row = large_k_bcap(width)
        n_scratch = q * (LK_FINAL_CAP + scratch_row)
    head = q * out_k + n_counts // 2  # int64 words of outputs and counts
    buf = torch.empty(head + n_scratch, dtype=torch.int64, device=dev)
    words = buf.view(torch.int32)
    n_out = q * out_k
    values = words[:n_out].view(torch.float32).view(q, out_k)
    ids = words[n_out : 2 * n_out].view(q, out_k)
    counts = words[2 * n_out : 2 * n_out + n_counts]
    base = buf.data_ptr()
    addrs = (base, base + 4 * n_out, base + 8 * n_out, base + 8 * head)
    return values, ids, counts, addrs, scratch_row, route


def _count_route(name: str, route: str) -> None:
    with _count_lock:
        TOPK_ROUTES[name + ":" + route] += 1


def masked_topk_plain(key, eligible, k: int):
    m = key.shape[0]
    kp = min(k, m)
    total = eligible.sum(dtype=torch.int32)
    order = stable_order(0xFFFFFFFF - _f32_order(key), 32)[:kp]
    return key[order], order.to(torch.int32), total


def masked_topk_batch_plain(key, eligible, k: int):
    """The batched K3 as the solo plain version row by row."""
    outs = [masked_topk_plain(key[q], eligible[q], k)
            for q in range(key.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


def masked_topk_batch(key, eligible, k: int):
    """Top-k of each row of `key` by (score desc, index asc) —
    jax.lax.top_k's order — and total = each row's count of `eligible`.

    key f32[Q, M] must already hold -inf at ineligible entries (the kernel
    ranks the key as it is, as the plain version does). Returns
    (top_scores f32[Q, min(k, M)], top_idx i32[Q, min(k, M)],
    total i32[Q]). Callers pad to k exactly as the reference does when
    M < k.

    On the card, esk_masked_topk takes one of three hand-written designs
    of csrc/masked_topk.cu (`topk_route`), all bit-equal to the plain
    version: 1 <= min(k, M) <= ROW_SELECT_MAX_K (256) takes the threshold
    select (one memset and one launch: each key and eligible byte read
    once, the row's last block merging the survivors); a larger k takes
    the short-row sort on rows of at most SHORT_ROW_MAX (16,384) entries
    (a memset and one launch sorting runs of LK_RUN entries in shared
    memory, then, for rows of more than one run, one launch merging them
    by rank) and the large-k select on longer rows (a radix select on the
    composite: a memset and nine launches whatever M and k)."""
    _check_topk(key, eligible, k)
    if not _launchable(key.device):
        return masked_topk_batch_plain(key, eligible, k)
    return _masked_topk_launch(key, eligible, k, 0)


def masked_topk_stacked(key, eligible, k: int, n_shards: int):
    """K3s: masked_topk_batch over R = Q x S rows, row r the candidates of
    (query r // S, shard r % S). A row's keys are its pair's own, so the
    kernel reads no shard plane: the mode is the row mode over Q x S
    rows, counted apart."""
    _check_topk(key, eligible, k)
    _check_shards(n_shards, key.shape[0], {})
    if not _launchable(key.device):
        return masked_topk_stacked_plain(key, eligible, k, n_shards)
    return _masked_topk_launch(key, eligible, k, n_shards)


def masked_topk_stacked_plain(key, eligible, k: int, n_shards: int):
    """The stacked K3 is the batched K3's plain version over Q x S rows."""
    return masked_topk_batch_plain(key, eligible, k)


def _check_topk(key, eligible, k: int) -> None:
    dev = key.device
    _check_all(dev, ((key, "key", torch.float32, 2),
                     (eligible, "eligible", torch.bool, 2)))
    q, m = key.shape
    if eligible.shape != key.shape:
        raise ValueError("eligible differs in shape from key")
    if k < 0:
        raise ValueError("k must be >= 0")
    if m >= 2**31:
        raise ValueError("key rows too long for int32 indices")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")


def _masked_topk_launch(key, eligible, k, n_shards, ids=None):
    """Launch K3 on checked [Q, M] inputs (K3i with tie-break `ids`) in
    one host call and one allocation (`_topk_buffers`); outputs
    [Q, min(k, M)] and [Q]."""
    dev = key.device
    q, m = key.shape
    kp = min(k, m)
    _check_topk_limit(k, kp, m)
    top_scores, top_idx, counts, addr, row, route = _topk_buffers(
        dev, q, m, kp, kp)
    _launch(
        "masked_topk", dev, ensure_built().esk_masked_topk,
        key.data_ptr(), None if ids is None else ids.data_ptr(),
        eligible.data_ptr(), q, m, kp, addr[2], addr[3], row, addr[0],
        addr[1],
    )
    if ids is not None:
        name = "masked_topk_ids"
        count_launch(name)
    else:
        name = ("masked_topk_stacked" if n_shards else
                "masked_topk_batch" if q > 1 else "masked_topk")
        _count("masked_topk", q, n_shards)
    _count_route(name, route)
    return top_scores, top_idx, counts[:q]


def masked_topk(key, eligible, k: int):
    """K3 for one row: masked_topk_batch over one row. key f32[M] (-inf
    at ineligible entries) -> (top_scores f32[min(k, M)], top_idx
    i32[min(k, M)], total i32[])."""
    out = masked_topk_batch(key[None], eligible[None], k)
    return tuple(t[0] for t in out)


def masked_topk_window_plain(key, eligible, lo, hi, k: int):
    """K3b window mode as the solo plain version over each row's slice
    [lo[q], hi[q]) of the plane, padded to min(k, M) slots with (-inf, 0)."""
    q, m = key.shape
    kk = min(k, m)
    scores = torch.full((q, kk), float("-inf"), dtype=torch.float32,
                        device=key.device)
    ids = torch.zeros((q, kk), dtype=torch.int32, device=key.device)
    totals = torch.zeros(q, dtype=torch.int32, device=key.device)
    for r in range(q):
        a, b = int(lo[r]), int(hi[r])
        s, i, t = masked_topk_plain(key[r, a:b], eligible[r, a:b], kk)
        scores[r, : s.shape[0]] = s
        ids[r, : i.shape[0]] = i
        totals[r] = t
    return scores, ids, totals


def masked_topk_window(key, eligible, lo, hi, k: int):
    """K3b's window mode: per row q, the top min(k, w) of key[q, lo:hi]
    (w = hi - lo) by (score desc, index asc) — lax.top_k's order, which a
    contiguous window does not change — with the ids window-local
    (index - lo[q]), and total = the count of eligible[q, lo:hi].

    key f32[Q, M] (-inf at ineligible entries), eligible bool[Q, M], lo /
    hi int32[Q] with 0 <= lo <= hi <= M. Returns (top_scores f32[Q, kk],
    top_ids i32[Q, kk], total i32[Q]) with kk = min(k, M): the packed
    plane's output shape; slots past min(k, w) of a row are padding
    (-inf, 0). Counted as `masked_topk_window`. On the card the design is
    chosen as masked_topk_batch's (`topk_route`) on min(k, M, the widest
    window) over the widest window, each row offset by its lo."""
    _check_topk(key, eligible, k)
    q, m = key.shape
    for name, t in (("lo", lo), ("hi", hi)):
        _check(t, name, torch.int32, 1, key.device)
        if t.shape[0] != q:
            raise ValueError(f"{name} must have one bound per row")
    # One host read of the bounds: their checks and the widest window
    # (the launch's grid).
    lo_h, hi_h = (t.cpu().numpy().astype(np.int64) for t in (lo, hi))
    if np.any(lo_h < 0) or np.any(hi_h < lo_h) or np.any(hi_h > m):
        raise ValueError("window bounds must satisfy 0 <= lo <= hi <= M")
    if not _launchable(key.device):
        return masked_topk_window_plain(key, eligible, lo_h, hi_h, k)
    return _masked_topk_window_launch(
        key, eligible, lo, hi, k, int((hi_h - lo_h).max(initial=0))
    )


def _masked_topk_window_launch(key, eligible, lo, hi, k, wmax):
    """Launch K3b's window mode in one host call and one allocation: the
    design is chosen on kw = min(k, M, wmax) over the widest window."""
    dev = key.device
    q, m = key.shape
    out_k = min(k, m)
    kw = min(out_k, wmax)  # the ranks a row's window can hold
    _check_topk_limit(k, kw, wmax)
    top_scores, top_idx, counts, addr, row, route = _topk_buffers(
        dev, q, wmax, kw, out_k)
    _launch(
        "masked_topk_window", dev, ensure_built().esk_masked_topk_window,
        key.data_ptr(), eligible.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        q, m, wmax, kw, out_k, addr[2], addr[3], row, addr[0], addr[1],
    )
    count_launch("masked_topk_window")
    _count_route("masked_topk_window", route)
    return top_scores, top_idx, counts[:q]


def masked_topk_ids_plain(key, ids, eligible, k: int):
    """One row of K3i: the top min(k, M) of `key` by (score desc, id asc)
    in lax.sort's canonical float order (-0.0 equal to +0.0, every NaN
    last) — two stable sorts, by id and then by the score — and total =
    the count of `eligible`. The scores come back canonical (+0.0 for a
    zero, NaN as 0x7fc00000), as the kernel decodes them."""
    m = key.shape[0]
    kp = min(k, m)
    nan = torch.isnan(key)
    canon = torch.where(key == 0, torch.zeros_like(key), key)
    canon = torch.where(nan, torch.full_like(key, float("nan")), canon)
    order_bits = torch.where(nan, torch.zeros_like(ids, dtype=torch.int64),
                             _f32_order(canon))
    by_id = stable_order(ids.to(torch.int64) & 0xFFFFFFFF, 32)
    order = by_id[stable_order(0xFFFFFFFF - order_bits[by_id], 32)][:kp]
    return canon[order], ids[order], eligible.sum(dtype=torch.int32)


def masked_topk_ids_batch_plain(key, ids, eligible, k: int):
    outs = [masked_topk_ids_plain(key[q], ids[q], eligible[q], k)
            for q in range(key.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


def masked_topk_ids_batch(key, ids, eligible, k: int):
    """K3i over Q rows: the top min(k, M) of each row of `key` by (score
    desc, id asc) with the ids from `ids` i32[Q, M] (non-negative) —
    `lax.sort((-s, id, s), num_keys=2)`'s order, zeros equal and NaN
    last — and total = each row's count of `eligible`. Returns (scores f32[Q, kk], ids i32[Q, kk],
    total i32[Q]). On the card the design is chosen as masked_topk_batch's
    (`topk_route`), with the id as the composite's low word."""
    _check_topk(key, eligible, k)
    _check(ids, "ids", torch.int32, 2, key.device)
    if ids.shape != key.shape:
        raise ValueError("ids differ in shape from key")
    if not _launchable(key.device):
        return masked_topk_ids_batch_plain(key, ids, eligible, k)
    return _masked_topk_launch(key, eligible, k, 0, ids=ids)


def masked_topk_merge_plain(key, k: int, ids=None):
    """K3's merge mode as masked_topk_batch_plain defines a row, without
    the total: each row's top min(k, M) in lax.top_k's order, their
    indices as int64 and, with `ids`, the ids at those indices."""
    kp = min(k, key.shape[1])
    orders = [stable_order(0xFFFFFFFF - _f32_order(key[r]), 32)[:kp]
              for r in range(key.shape[0])]
    idx = torch.stack(orders)
    top = torch.stack([key[r][o] for r, o in enumerate(orders)])
    taken = None if ids is None else torch.stack(
        [ids[r][o] for r, o in enumerate(orders)])
    return top, idx, taken


def masked_topk_merge(key, k: int, ids=None):
    """K3's merge mode (K3m): the top min(k, M) of each row of key
    f32[Q, M] (0 < M <= MERGE_MAX_M: the gathered per-shard tops) by
    (key desc, index asc), lax.top_k's order over IEEE totalOrder, with
    no eligibility plane and no total. Returns (top f32[Q, kp], idx
    int64[Q, kp], taken): `taken` is ids i32[Q, M] at those indices, or
    None without `ids`. Counted as `masked_topk_merge`."""
    dev = key.device
    _check_all(dev, ((key, "key", torch.float32, 2),
                     *(() if ids is None else ((ids, "ids", torch.int32, 2),))))
    q, m = key.shape
    if ids is not None and ids.shape != key.shape:
        raise ValueError("ids differ in shape from key")
    if k < 0:
        raise ValueError("k must be >= 0")
    if not 1 <= m <= MERGE_MAX_M:
        raise ValueError(
            f"merge rows hold 1..{MERGE_MAX_M} keys, got {m}: longer rows "
            f"take K3's row mode")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if not _launchable(dev):
        return masked_topk_merge_plain(key, k, ids)
    kp = min(k, m)
    top = torch.empty((q, kp), dtype=torch.float32, device=dev)
    idx = torch.empty((q, kp), dtype=torch.int64, device=dev)
    taken = (None if ids is None
             else torch.empty((q, kp), dtype=torch.int32, device=dev))
    if kp == 0:
        return top, idx, taken
    _launch(
        "masked_topk_merge", dev, ensure_built().esk_topk_merge,
        key.data_ptr(), None if ids is None else ids.data_ptr(), q, m, kp,
        top.data_ptr(), idx.data_ptr(),
        None if taken is None else taken.data_ptr(),
    )
    count_launch("masked_topk_merge")
    return top, idx, taken


# ---------------------------------------------------------------------------
# K7 vector_score
# ---------------------------------------------------------------------------

VS_DENSE, VS_GATHER, VS_SCRIPT = 0, 1, 2
METRIC_CODES = {"cosine": 0, "dot_product": 1, "l2_norm": 2}


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in K7's fixed order: padded with +0.0 to a
    multiple of 32, lane l sums elements l, l + 32, ... in ascending
    order, then the lanes fold in halves (l += l + 16, + 8, + 4, + 2, + 1)."""
    d = x.shape[-1]
    slabs = max(1, -(-d // 32))
    x = torch.nn.functional.pad(x, (0, slabs * 32 - d))
    x = x.reshape(*x.shape[:-1], slabs, 32)
    acc = x[..., 0, :]
    for s in range(1, slabs):
        acc = acc + x[..., s, :]
    for w in (16, 8, 4, 2, 1):
        acc = acc[..., :w] + acc[..., w : 2 * w]
    return acc[..., 0]


def _consts(dev):
    one = torch.ones((), dtype=torch.float32, device=dev)
    return one, torch.full((), 0.5, dtype=torch.float32, device=dev)


def similarity_plain(rows, q, metric: str):
    """K7's dense and gather score of each row of rows f32[R, d] against
    q f32[d], in the kernel's order: the ES similarity (cosine (1 + cos)
    / 2, dot_product (1 + dot) / 2, l2_norm 1 / (1 + |q - v|^2))."""
    one, half = _consts(rows.device)
    if metric == "l2_norm":
        diff = rows - q
        return torch.div(one, torch.add(one, lane_sum(diff * diff)))
    dot = lane_sum(rows * q)
    if metric == "dot_product":
        return torch.mul(torch.add(one, dot), half)
    vnorm = torch.sqrt(lane_sum(rows * rows))
    qnorm = torch.sqrt(lane_sum(q * q))
    denom = vnorm * qnorm
    cos = torch.where(denom > 0, dot / denom, torch.zeros_like(dot))
    return torch.mul(torch.add(one, cos), half)


def vector_score_batch_plain(vectors, queries, metric: str):
    return torch.stack([similarity_plain(vectors, queries[q], metric)
                        for q in range(queries.shape[0])])


def vector_score_gather_batch_plain(part_vectors, queries, probes,
                                    metric: str):
    d = part_vectors.shape[-1]
    return torch.stack([
        similarity_plain(
            part_vectors[probes[q].to(torch.int64)].reshape(-1, d),
            queries[q], metric,
        )
        for q in range(queries.shape[0])
    ])


def vector_script_plain(rows, q):
    """One row of K7's script mode: (dot f32[R], |v| f32[R], |v - q|
    f32[R], |q| f32[])."""
    diff = rows - q
    return (lane_sum(rows * q), torch.sqrt(lane_sum(rows * rows)),
            torch.sqrt(lane_sum(diff * diff)), torch.sqrt(lane_sum(q * q)))


def vector_script_batch_plain(vectors, queries):
    stacked = vectors.dim() == 3
    outs = [vector_script_plain(_shard(vectors, q, stacked), queries[q])
            for q in range(queries.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


def _check_vectors(vectors, queries, ndim: int):
    dev = vectors.device
    _check(vectors, "vectors", torch.float32, vectors.dim(), dev)
    if vectors.dim() not in ndim:
        raise ValueError(f"vectors must be {ndim}-d, got {tuple(vectors.shape)}")
    _check(queries, "queries", torch.float32, 2, dev)
    q, d = queries.shape
    if d != vectors.shape[-1] or d < 1:
        raise ValueError(
            f"query vectors have {d} dims, the plane {vectors.shape[-1]}"
        )
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    return q, d


def _metric_code(metric: str) -> int:
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown dense_vector similarity [{metric}]")
    return METRIC_CODES[metric]


def _vector_score_launch(vectors, queries, probes, n_rows, mode, metric,
                         n_shards, outs, qnorm, pmax=0):
    dev = vectors.device
    lib = ensure_built()
    q, d = queries.shape
    kp = 0 if probes is None else probes.shape[1]
    with torch.cuda.device(dev):
        rc = lib.esk_vector_score(
            _ptr(vectors), int(n_rows), int(d), _ptr(queries), int(q),
            _ptr(probes), int(kp), int(pmax), int(mode), int(metric),
            max(1, n_shards), int(vectors.shape[-2] * d) if n_shards else 0,
            *[_ptr(o) for o in outs], _ptr(qnorm), _stream(dev),
        )
    _check_rc("vector_score", rc)
    count_launch({VS_DENSE: "vector_score", VS_GATHER: "vector_score_gather",
                  VS_SCRIPT: "vector_score_script"}[mode])


def vector_score_batch(vectors, queries, metric: str):
    """K7 dense mode: the ES similarity of each of Q query vectors
    (queries f32[Q, d]) against every row of vectors f32[N, d] ->
    f32[Q, N]."""
    code = _metric_code(metric)
    q, _d = _check_vectors(vectors, queries, (2,))
    n = vectors.shape[0]
    if not _launchable(vectors.device):
        return vector_score_batch_plain(vectors, queries, metric)
    out = torch.empty((q, n), dtype=torch.float32, device=vectors.device)
    _vector_score_launch(vectors, queries, None, n, VS_DENSE, code, 0,
                         (out, None, None), None)
    return out


def vector_score_gather_batch(part_vectors, queries, probes, metric: str):
    """K7 gather mode: the ES similarity of query q against every slot of
    its probed partitions, read in place from part_vectors f32[C, pmax, d]
    through probes i32[Q, kp] -> f32[Q, kp * pmax] (slot s of probe p at
    p * pmax + s)."""
    code = _metric_code(metric)
    q, _d = _check_vectors(part_vectors, queries, (3,))
    dev = part_vectors.device
    _check(probes, "probes", torch.int32, 2, dev)
    if probes.shape[0] != q:
        raise ValueError(f"probes must be [{q}, kp]")
    c, pmax = part_vectors.shape[0], part_vectors.shape[1]
    kp = probes.shape[1]
    if not _launchable(dev):
        return vector_score_gather_batch_plain(part_vectors, queries, probes,
                                               metric)
    if kp and (int(probes.min()) < 0 or int(probes.max()) >= c):
        raise ValueError("a probe names no partition")
    out = torch.empty((q, kp * pmax), dtype=torch.float32, device=dev)
    _vector_score_launch(part_vectors, queries, probes, kp * pmax, VS_GATHER,
                         code, 0, (out, None, None), None, pmax=pmax)
    return out


def vector_script_batch(vectors, queries):
    """K7 script mode: for Q query vectors (queries f32[Q, d]) against a
    plane vectors f32[N, d] (or f32[S, N, d] stacked shards, row q
    reading shard q % S): (dot f32[Q, N], |v| f32[Q, N], |v - q| f32[Q, N],
    |q| f32[Q]) — the planes the script functions cosineSimilarity,
    dotProduct and l2norm compose."""
    q, _d = _check_vectors(vectors, queries, (2, 3))
    n_shards = vectors.shape[0] if vectors.dim() == 3 else 0
    if not _launchable(vectors.device):
        return vector_script_batch_plain(vectors, queries)
    n = vectors.shape[-2]
    dev = vectors.device
    outs = tuple(torch.empty((q, n), dtype=torch.float32, device=dev)
                 for _ in range(3))
    qnorm = torch.empty((q,), dtype=torch.float32, device=dev)
    _vector_score_launch(vectors, queries, None, n, VS_SCRIPT, 0, n_shards,
                         outs, qnorm)
    return (*outs, qnorm)


# ---------------------------------------------------------------------------
# K9 ivf_assign
# ---------------------------------------------------------------------------


def ivf_assign_plain(centroids, rows, chunk: int = 64):
    """K9's plain version: argmin_c (|x|^2 - 2 x.c) + |c|^2 with each sum
    in K7's fixed order (lane_sum), first index on ties; rows in chunks
    of `chunk` so the [chunk, C, d] products stay small."""
    cc = lane_sum(centroids * centroids)
    two = torch.full((), 2.0, dtype=torch.float32, device=rows.device)
    out = []
    for r0 in range(0, rows.shape[0], chunk):
        x = rows[r0 : r0 + chunk]
        xx = lane_sum(x * x)
        xc = lane_sum(x[:, None, :] * centroids[None, :, :])
        d2 = (xx[:, None] - torch.mul(two, xc)) + cc[None, :]
        out.append(torch.argmin(d2, dim=1).to(torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=rows.device)
    return torch.cat(out)


def ivf_assign(centroids, rows):
    """K9: the nearest centroid (squared L2) of each row: centroids
    f32[C, d], rows f32[M, d] -> i32[M], the first index on ties (the
    first NaN distance, as torch.argmin). On the card, the register-tiled
    kernel of csrc/ivf_assign.cu, bit-equal to `ivf_assign_plain`."""
    dev = rows.device
    _check(centroids, "centroids", torch.float32, 2, dev)
    _check(rows, "rows", torch.float32, 2, dev)
    c, d = centroids.shape
    if rows.shape[1] != d or d < 1 or c < 1:
        raise ValueError("rows and centroids must share d >= 1, with C >= 1")
    if not _launchable(dev):
        return ivf_assign_plain(centroids, rows)
    lib = ensure_built()
    m = rows.shape[0]
    cc = torch.empty((c,), dtype=torch.float32, device=dev)
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_ivf_assign(
            _ptr(rows), int(m), _ptr(centroids), int(c), int(d), _ptr(cc),
            _ptr(out), _stream(dev),
        )
    _check_rc("ivf_assign", rc)
    count_launch("ivf_assign")
    return out


# ---------------------------------------------------------------------------
# K3k keyed_topk (K3's keyed mode)
# ---------------------------------------------------------------------------

KEYED_SCORE_DESC, KEYED_SCORE_ASC, KEYED_FIELD = 0, 1, 2

# Largest k of K3k's threshold select (csrc/masked_topk.cu KS_MAX_K); a
# larger k takes the short-row sort or the large-k select.
KEYED_SELECT_MAX_K = ROW_SELECT_MAX_K

F32_MAX = float(np.finfo(np.float32).max)


def sort_key(col: torch.Tensor, desc: bool, missing_first: bool) -> torch.Tensor:
    """The transformed ascending sort key of a doc-values column: negated
    for desc, NaN (missing) pinned to -/+f32max for missing first/last
    (bm25_device.sort_key_plane)."""
    key = -col if desc else col
    miss = -F32_MAX if missing_first else F32_MAX
    return torch.where(torch.isnan(key), torch.full_like(key, miss), key)


def keyed_topk_plain(key, eligible, k: int, mode: int, desc=False,
                     missing_first=False, after_key=None, after_doc=None):
    """One row of K3k as the reference composes it: key f32[M] (scores,
    or a doc-values column for KEYED_FIELD), eligible bool[M], the cursor
    (after_key, after_doc) as Python numbers or None. Returns (values
    f32[min(k, M)], ids i32[min(k, M)], total i32[], n_after i32[])."""
    m = key.shape[0]
    dev = key.device
    if mode == KEYED_FIELD:
        sk = sort_key(key, desc, missing_first)
    else:
        sk = key
    keep = eligible
    if after_key is not None:
        ak = torch.tensor(after_key, dtype=torch.float32, device=dev)
        iota = torch.arange(m, dtype=torch.int32, device=dev)
        past = sk < ak if mode == KEYED_SCORE_DESC else sk > ak
        keep = eligible & (past | ((sk == ak) & (iota > int(after_doc))))
    neg = mode != KEYED_SCORE_DESC
    inf = float("inf") if neg else float("-inf")
    masked = torch.where(keep, sk, torch.full_like(sk, inf))
    # The negation keeps a NaN's sign, as the reference serves it (XLA
    # folds `-masked` into the script's `* boost`): +NaN scores lead a
    # bottom-k, -NaN ones trail the ineligible docs.
    seen = torch.where(torch.isnan(masked), masked, -masked) if neg else masked
    kp = min(k, m)
    order = stable_order(0xFFFFFFFF - _f32_order(seen), 32)[:kp]
    if mode == KEYED_FIELD:
        values = key[order]
    else:
        values = masked[order]
        if neg:  # the reference's `-top_k(-masked)` flips a NaN's sign
            values = torch.where(torch.isnan(values), flip_sign(values),
                                 values)
    return (values, order.to(torch.int32), eligible.sum(dtype=torch.int32),
            keep.sum(dtype=torch.int32))


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """x with its sign bit flipped, NaN payloads included."""
    return (x.view(torch.int32) ^ torch.tensor(-2**31, dtype=torch.int32,
                                               device=x.device)).view(
        torch.float32)


def keyed_topk_batch_plain(key, eligible, k: int, mode: int, desc=False,
                           missing_first=False, after_key=None,
                           after_doc=None):
    """The batched K3k as the solo plain version row by row."""
    outs = []
    for q in range(eligible.shape[0]):
        cursor = (None, None) if after_key is None else (
            float(after_key[q]), int(after_doc[q]))
        outs.append(keyed_topk_plain(
            key if key.dim() == 1 else key[q], eligible[q], k, mode, desc,
            missing_first, *cursor,
        ))
    return tuple(torch.stack(col) for col in zip(*outs))


def keyed_topk_batch(key, eligible, k: int, mode: int, desc=False,
                     missing_first=False, after_key=None, after_doc=None):
    """K3k over Q rows: the masked `lax.top_k` of the sorted and cursor
    programs, its key built in the kernel.

    key f32[M] (one plane for every row: a doc-values column) or
    f32[Q, M]; eligible bool[Q, M]; mode KEYED_SCORE_DESC (the descending
    score cursor), KEYED_SCORE_ASC (bottom-k, with or without a cursor)
    or KEYED_FIELD (a field sort, `desc` / `missing_first`); the cursor
    after_key f32[Q] (in the transformed key space) and after_doc i32[Q],
    or None. Returns (values f32[Q, min(k, M)] — the column's raw values
    for a field sort, the masked scores for a score order —, ids
    i32[Q, min(k, M)], total i32[Q], n_after i32[Q]).

    On the card, esk_keyed_topk takes K3's three hand-written designs of
    csrc/masked_topk.cu as masked_topk_batch does (`topk_route`), all
    bit-equal to the plain version: 1 <= min(k, M) <= KEYED_SELECT_MAX_K
    (256) takes the threshold select (one pass over the keys, the row's
    last block merging the survivors); a larger k the short-row sort on
    rows of at most SHORT_ROW_MAX entries and the large-k select (a radix
    select on the keyed composite) on longer ones. One host call, one
    allocation."""
    dev = eligible.device
    _check(eligible, "eligible", torch.bool, 2, dev)
    q, m = eligible.shape
    _check(key, "key", torch.float32, key.dim(), dev)
    if key.shape[-1] != m or key.dim() not in (1, 2) or (
            key.dim() == 2 and key.shape[0] != q):
        raise ValueError(f"key must be [{m}] or [{q}, {m}]")
    if mode not in (KEYED_SCORE_DESC, KEYED_SCORE_ASC, KEYED_FIELD):
        raise ValueError(f"unknown keyed mode {mode}")
    if (after_key is None) != (after_doc is None):
        raise ValueError("a cursor needs both after_key and after_doc")
    if after_key is not None:
        _check(after_key, "after_key", torch.float32, 1, dev)
        _check(after_doc, "after_doc", torch.int32, 1, dev)
        if after_key.shape[0] != q or after_doc.shape[0] != q:
            raise ValueError(f"cursor planes must be [{q}]")
    if k < 0:
        raise ValueError("k must be >= 0")
    if m >= 2**31:
        raise ValueError("key rows too long for int32 indices")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if not _launchable(dev):
        return keyed_topk_batch_plain(key, eligible, k, mode, desc,
                                      missing_first, after_key, after_doc)
    kp = min(k, m)
    _check_topk_limit(k, kp, m)
    values, ids, counts, addr, row, route = _topk_buffers(dev, q, m, kp, kp)
    _launch(
        "keyed_topk", dev, ensure_built().esk_keyed_topk,
        key.data_ptr(), m if key.dim() == 2 else 0, eligible.data_ptr(),
        q, m, kp, int(mode), int(bool(desc)), int(bool(missing_first)),
        None if after_key is None else after_key.data_ptr(),
        None if after_doc is None else after_doc.data_ptr(),
        addr[2], addr[3], row, addr[0], addr[1],
    )
    count_launch("keyed_topk")
    _count_route("keyed_topk", route)
    return values, ids, counts[:q], counts[q : 2 * q]


def keyed_topk(key, eligible, k: int, mode: int, desc=False,
               missing_first=False, after_key=None, after_doc=None):
    """K3k for one row: keyed_topk_batch over one row. key f32[M],
    eligible bool[M], the cursor as Python numbers (after_key in the
    transformed key space) or None -> (values f32[min(k, M)], ids
    i32[min(k, M)], total i32[], n_after i32[])."""
    dev = eligible.device
    cursor = (None, None)
    if after_key is not None:
        cursor = (
            torch.tensor([after_key], dtype=torch.float32).to(dev),
            torch.tensor([after_doc], dtype=torch.int32).to(dev),
        )
    out = keyed_topk_batch(key, eligible[None], k, mode, desc, missing_first,
                           *cursor)
    return tuple(t[0] for t in out)


# ---------------------------------------------------------------------------
# K5 window_rescore
# ---------------------------------------------------------------------------


def window_chunk(w: int) -> int:
    """K5's shared window: the power of two >= w."""
    return 1 << max(0, w - 1).bit_length()


def window_gather_plain(scores, eligible, ids):
    """One row of K5's gather mode: (where(eligible, scores, 0)[ids],
    eligible[ids]), ids clamped to the plane as JAX's gather clamps."""
    d = torch.clamp(ids.to(torch.int64), 0, scores.shape[0] - 1)
    return torch.where(eligible, scores, 0.0)[d], eligible[d]


def window_gather_batch_plain(scores, eligible, ids):
    outs = [window_gather_plain(scores[q], eligible[q], ids[q])
            for q in range(ids.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


def _check_plane(scores, eligible, q: int):
    dev = scores.device
    _check(scores, "scores", torch.float32, 2, dev)
    _check(eligible, "eligible", torch.bool, 2, dev)
    if scores.shape[0] != q or eligible.shape != scores.shape:
        raise ValueError(f"the plane must be [{q}, N] with its eligibility")
    if scores.shape[1] < 1:
        raise ValueError("the plane is empty")


def window_gather_batch(scores, eligible, ids):
    """K5 gather mode over Q rows: scores f32[Q, N] and eligible bool[Q, N]
    (a dense evaluation), ids i32[Q, W] -> (f32[Q, W] the scores where
    eligible else 0, bool[Q, W] the eligibility) at the ids."""
    dev = ids.device
    _check(ids, "ids", torch.int32, 2, dev)
    q, w = ids.shape
    _check_plane(scores, eligible, q)
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if not _launchable(dev):
        return window_gather_batch_plain(scores, eligible, ids)
    lib = ensure_built()
    out_s = torch.empty((q, w), dtype=torch.float32, device=dev)
    out_m = torch.empty((q, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_window_gather(
            _ptr(scores), _ptr(eligible), int(scores.shape[1]), _ptr(ids),
            int(q), int(w), _ptr(out_s), _ptr(out_m), _stream(dev),
        )
    _check_rc("window_gather", rc)
    count_launch("window_rescore_gather")
    return out_s, out_m


def window_rescore_plain(s, ids, rscores, relig, qw: float, rw: float,
                         k: int):
    """One row of K5's fused mode, as `_rescore_inner` computes it after
    the window: (top combined scores f32[min(k, W)], their doc ids
    i32[min(k, W)])."""
    rs, rm = window_gather_plain(rscores, relig, ids)
    qw_t = torch.tensor(qw, dtype=torch.float32, device=s.device)
    rw_t = torch.tensor(rw, dtype=torch.float32, device=s.device)
    a = torch.mul(qw_t, s)
    comb = torch.where(rm, torch.add(a, torch.mul(rw_t, rs)), a)
    comb = torch.where(s > float("-inf"), comb, float("-inf"))
    kk = min(k, comb.shape[0])
    pos = stable_order(0xFFFFFFFF - _f32_order(comb), 32)[:kk]
    return comb[pos], ids[pos]


def window_rescore_batch_plain(s, ids, rscores, relig, qw, rw, k: int):
    outs = [window_rescore_plain(s[q], ids[q], rscores[q], relig[q], qw, rw, k)
            for q in range(ids.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


def window_rescore_batch(s, ids, rscores, relig, qw: float, rw: float,
                         k: int):
    """K5 fused mode over Q rows: the first phase's window (scores
    f32[Q, W], -inf in padding slots, and doc ids i32[Q, W]) re-scored
    with the rescore plane (rscores f32[Q, N], relig bool[Q, N] = its
    matched & live): comb = qw*s + rw*rscore where the window doc is
    relig, else qw*s, -inf where s is; returns its top min(k, W) in
    lax.top_k order — (scores f32[Q, kk], ids i32[Q, kk])."""
    dev = s.device
    _check(s, "s", torch.float32, 2, dev)
    _check(ids, "ids", torch.int32, 2, dev)
    q, w = s.shape
    if ids.shape != s.shape:
        raise ValueError("ids differ in shape from the window scores")
    _check_plane(rscores, relig, q)
    if k < 0:
        raise ValueError("k must be >= 0")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if w > WINDOW_MAX:
        raise ValueError(
            f"rescore window {w} exceeds the kernel's window ({WINDOW_MAX})"
        )
    qw = float(np.float32(qw))
    rw = float(np.float32(rw))
    if not _launchable(dev):
        return window_rescore_batch_plain(s, ids, rscores, relig, qw, rw, k)
    kk = min(k, w)
    lib = ensure_built()
    top_s = torch.empty((q, kk), dtype=torch.float32, device=dev)
    top_ids = torch.empty((q, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_window_rescore(
            _ptr(s), _ptr(ids), int(q), int(w), _ptr(rscores), _ptr(relig),
            int(rscores.shape[1]), qw, rw, int(kk), window_chunk(w),
            _ptr(top_s), _ptr(top_ids), _stream(dev),
        )
    _check_rc("window_rescore", rc)
    count_launch("window_rescore")
    return top_s, top_ids


# ---------------------------------------------------------------------------
# K4 span_locate
# ---------------------------------------------------------------------------


def search_steps(flat_len: int) -> int:
    return max(1, int(flat_len).bit_length())


def span_locate_plain(flat, starts, ends, j: int, cands):
    p = cands.shape[0]
    start = starts[j].to(torch.int32)
    end = ends[j].to(torch.int32)
    lo = start.expand(p).clone()
    hi = end.expand(p).clone()
    limit = flat.shape[0] - 1
    for _ in range(search_steps(flat.shape[0])):
        mid = (lo + hi) >> 1
        v = flat[torch.clamp(mid, 0, limit).to(torch.int64)]
        go = v < cands
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    pos = torch.clamp(lo, 0, limit)
    found = (lo < end) & (flat[pos.to(torch.int64)] == cands)
    return pos.to(torch.int32), found


def span_locate_batch_plain(flat, starts, ends, j: int, cands):
    """The batched K4 as the solo plain version row by row; with stacked
    planes ([S, L]), row q searches shard q % S's."""
    st = flat.dim() == 2
    outs = [span_locate_plain(_shard(flat, q, st), starts[q], ends[q], j,
                              cands[q])
            for q in range(cands.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


span_locate_stacked_plain = span_locate_batch_plain


def span_locate_batch(flat, starts, ends, j: int, cands):
    """(pos i32[Q, P], found bool[Q, P]) of each row's candidate docs
    against that row's sorted slice [starts[q, j], ends[q, j]) of a flat
    postings plane. starts/ends are i32[Q, T], cands i32[Q, P]."""
    return _span_locate(flat, starts, ends, j, cands, 0)


def span_locate_stacked(flat, starts, ends, j: int, cands):
    """K4s: span_locate_batch over R = Q x S rows of S stacked shards:
    flat is [S, L] (equal-length planes) and row r, the pair (query
    r // S, shard r % S), searches shard r % S's plane."""
    return _span_locate(flat, starts, ends, j, cands, flat.shape[0])


def _span_locate(flat, starts, ends, j, cands, n_shards):
    dev = flat.device
    _check_all(dev, (
        (flat, "flat", torch.int32, 2 if n_shards else 1),
        (starts, "starts", torch.int32, 2),
        (ends, "ends", torch.int32, 2),
        (cands, "cands", torch.int32, 2),
    ))
    q, p = cands.shape
    n_spans = starts.shape[1]
    _check_rows("starts", starts, q, n_spans)
    _check_rows("ends", ends, q, n_spans)
    if not 0 <= j < n_spans:
        raise ValueError(f"span column {j} out of range")
    if flat.shape[-1] == 0:
        raise ValueError("flat plane is empty")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if n_shards:
        _check_shards(n_shards, q, {"flat": flat})
    if not _launchable(dev):
        return span_locate_batch_plain(flat, starts, ends, j, cands)
    flat_len = flat.shape[-1]
    pos = torch.empty((q, p), dtype=torch.int32, device=dev)
    found = torch.empty((q, p), dtype=torch.bool, device=dev)
    _launch(
        "span_locate", dev, ensure_built().esk_span_locate,
        flat.data_ptr(), flat_len, starts.data_ptr(), ends.data_ptr(),
        n_spans, j, cands.data_ptr(), q, p, search_steps(flat_len),
        pos.data_ptr(), found.data_ptr(), max(1, n_shards),
    )
    _count("span_locate", q, n_shards)
    return pos, found


def span_locate(flat, starts, ends, j: int, cands):
    """K4 for one row: span_locate_batch over one row. (pos i32[P], found
    bool[P]) of each candidate doc against the sorted slice
    [starts[j], ends[j]) of a flat postings plane."""
    out = span_locate_batch(flat, starts[None], ends[None], j, cands[None])
    return tuple(t[0] for t in out)


def _take_rows(plane, idx: torch.Tensor) -> torch.Tensor:
    """plane[idx] for rows of indices idx [R, P]: a flat plane [L], or,
    stacked [S, L], shard r % S's for row r (bm25_device._take)."""
    if plane.dim() == 1:
        return plane[idx]
    shard = torch.arange(idx.shape[0], device=idx.device) % plane.shape[0]
    return plane[shard.view(-1, 1), idx]


def span_fold_batch_plain(flat_docs, flat_tn, starts, ends, weights, cands,
                          in_range):
    """K4's fold mode as bm25_device._sparse_lead_inner folded its must
    terms, op for op: per term j in order, the row's K4 search, found &
    in_range, contrib = w - w / (1 + tn[pos]), score + where(found,
    contrib, 0) from +0.0, and matched | found. Stacked planes ([S, L])
    serve row r from shard r % S."""
    q, p = cands.shape
    score = torch.zeros((q, p), dtype=torch.float32, device=cands.device)
    matched = torch.zeros((q, p), dtype=torch.bool, device=cands.device)
    for j in range(starts.shape[1]):
        at, found = span_locate_batch_plain(flat_docs, starts, ends, j, cands)
        found = found & in_range
        w = weights[:, j : j + 1]
        contrib = w - w / (1.0 + _take_rows(flat_tn, at.to(torch.int64)))
        score = score + torch.where(found, contrib, 0.0)
        matched = matched | found
    return score, matched


span_fold_stacked_plain = span_fold_batch_plain


def span_fold_batch(flat_docs, flat_tn, starts, ends, weights, cands,
                    in_range):
    """K4's fold mode: a filter-led conjunction's must terms searched and
    scored at each row's candidates in one launch. flat_docs i32[L] and
    flat_tn f32[L] are the must field's flat planes; starts / ends i32 and
    weights f32 [Q, T] the terms' spans and weights; cands i32[Q, P] the
    candidates clamped in range (the reference's `safe`), in_range
    bool[Q, P] their cand != num_docs. Returns (score f32[Q, P], matched
    bool[Q, P]), the must-term loop of `_sparse_lead_inner` bit for
    bit."""
    return _span_fold(flat_docs, flat_tn, starts, ends, weights, cands,
                      in_range, 0)


def span_fold_stacked(flat_docs, flat_tn, starts, ends, weights, cands,
                      in_range):
    """K4s's fold mode: span_fold_batch over R = Q x S rows of S stacked
    shards, the planes [S, L] and row r reading shard r % S's."""
    return _span_fold(flat_docs, flat_tn, starts, ends, weights, cands,
                      in_range, flat_docs.shape[0])


def _span_fold(flat_docs, flat_tn, starts, ends, weights, cands, in_range,
               n_shards):
    dev = flat_docs.device
    nd = 2 if n_shards else 1
    _check_all(dev, (
        (flat_docs, "flat_docs", torch.int32, nd),
        (flat_tn, "flat_tn", torch.float32, nd),
        (starts, "starts", torch.int32, 2),
        (ends, "ends", torch.int32, 2),
        (weights, "weights", torch.float32, 2),
        (cands, "cands", torch.int32, 2),
        (in_range, "in_range", torch.bool, 2),
    ))
    q, p = cands.shape
    n_terms = starts.shape[1]
    _check_rows("ends", ends, q, n_terms)
    _check_rows("weights", weights, q, n_terms)
    _check_rows("starts", starts, q, n_terms)
    _check_rows("in_range", in_range, q, p)
    if flat_tn.shape != flat_docs.shape:
        raise ValueError("flat_tn differs in shape from flat_docs")
    if flat_docs.shape[-1] == 0:
        raise ValueError("flat plane is empty")
    if not 1 <= q <= 65535:
        raise ValueError(f"row count {q} out of range [1, 65535]")
    if n_shards:
        _check_shards(n_shards, q, {"flat_docs": flat_docs})
    if not _launchable(dev):
        return span_fold_batch_plain(flat_docs, flat_tn, starts, ends,
                                     weights, cands, in_range)
    flat_len = flat_docs.shape[-1]
    score = torch.empty((q, p), dtype=torch.float32, device=dev)
    matched = torch.empty((q, p), dtype=torch.bool, device=dev)
    _launch(
        "span_fold", dev, ensure_built().esk_span_fold,
        flat_docs.data_ptr(), flat_tn.data_ptr(), flat_len,
        starts.data_ptr(), ends.data_ptr(), weights.data_ptr(), n_terms,
        cands.data_ptr(), in_range.data_ptr(), q, p, search_steps(flat_len),
        score.data_ptr(), matched.data_ptr(), max(1, n_shards),
    )
    _count("span_fold", q, n_shards)
    return score, matched


# ---------------------------------------------------------------------------
# K10 bucket_fold
# ---------------------------------------------------------------------------

# The order of K10's fp32 sums (csrc/bucket_fold.cu): rows cut into chunks
# of bucket_chunk_rows(P, nb) consecutive rows, each chunk's partial a left
# fold of its rows in row order, each sum a left fold of the partials in
# chunk order.
BUCKET_CHUNK = 1024
BUCKET_MAX_PARTIALS = 1 << 22


def bucket_chunk_rows(p: int, nb: int) -> int:
    """Rows a chunk: 1,024, doubled while the [C, nb] partials would
    exceed 2^22 entries and a chunk is shorter than the rows."""
    ch = BUCKET_CHUNK
    while ch < p and -(-p // ch) * nb > BUCKET_MAX_PARTIALS:
        ch *= 2
    return ch


def _from_f32_order(o: torch.Tensor) -> torch.Tensor:
    """fp32 values of _f32_order's keys (its inverse)."""
    bits = torch.where(o >= 0x80000000, o & 0x7FFFFFFF, (~o) & 0xFFFFFFFF)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _extrema(group: torch.Tensor, vals: torch.Tensor, nb: int):
    """Per-group IEEE minimum / maximum (-0.0 < +0.0) of non-NaN values,
    F32_MAX / -F32_MAX where a group is empty (or is the discard group
    nb): an amin / amax of the values' total-order keys, which no order of
    reduction changes."""
    key = _f32_order(vals)
    edge = torch.tensor([F32_MAX, -F32_MAX], dtype=torch.float32,
                        device=vals.device)
    lo, hi = _f32_order(edge).tolist()
    vmin = torch.full((nb + 1,), lo, dtype=torch.int64, device=vals.device)
    vmax = torch.full((nb + 1,), hi, dtype=torch.int64, device=vals.device)
    vmin.scatter_reduce_(0, group, key, "amin")
    vmax.scatter_reduce_(0, group, key, "amax")
    return _from_f32_order(vmin[:nb]), _from_f32_order(vmax[:nb])


def _chunk_sums(group: torch.Tensor, vals: torch.Tensor, nb: int,
                ch: int) -> torch.Tensor:
    """K10's sums in its order: group int64[P] in [0, nb] (nb: no bucket)
    and vals f32[P] (0.0 where no bucket) in row order. Column j of the
    [C, ch] chunk grid adds the j-th row of every chunk into its (chunk,
    bucket) partial — distinct targets, so each partial is a left fold
    in row order — then the partials fold in chunk order."""
    p = group.numel()
    dev = vals.device
    n_chunks = -(-p // ch)
    pad = n_chunks * ch - p
    grid = torch.nn.functional.pad(group, (0, pad), value=nb)
    grid = grid.view(n_chunks, ch) + (
        torch.arange(n_chunks, device=dev) * (nb + 1))[:, None]
    v = torch.nn.functional.pad(vals, (0, pad)).view(n_chunks, ch)
    part = torch.zeros(n_chunks * (nb + 1), dtype=torch.float32, device=dev)
    for j in range(min(ch, p)):
        part.index_add_(0, grid[:, j], v[:, j])
    part = part.view(n_chunks, nb + 1)[:, :nb]
    total = torch.zeros(nb, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        total = total + part[c]
    return total


def bucket_fold_plain(bucket, contrib, nb: int, values=None, docs=None):
    """K10's scatter mode in PyTorch, in the kernel's order (see
    bucket_fold)."""
    dev = contrib.device
    p = contrib.shape[0]
    b = (torch.zeros(p, dtype=torch.int64, device=dev) if bucket is None
         else bucket.to(torch.int64))
    counts = contrib & (b >= 0) & (b < nb)
    v = None
    if values is not None:
        v = values if docs is None else values[docs.to(torch.int64)]
        counts = counts & ~torch.isnan(v)
    group = torch.where(counts, b, torch.full_like(b, nb))
    count = torch.bincount(group, minlength=nb + 1)[:nb].to(torch.int32)
    if values is None:
        return count
    vals = torch.where(counts, v, torch.zeros_like(v))
    vmin, vmax = _extrema(group, vals, nb)
    return (count, _chunk_sums(group, vals, nb, bucket_chunk_rows(p, nb)),
            vmin, vmax)


def bucket_fold(bucket, contrib, nb: int, values=None, docs=None):
    """K10 scatter mode: per-bucket counts over P rows and, with values,
    the per-bucket f32 sum, min and max.

    bucket int32[P] in [0, nb] (nb: discard) or None (every row in bucket
    0: a doc_count), contrib bool[P]; values f32[N] (NaN: no value), read
    at docs int32[P] in [0, N) or, without docs, aligned to the rows
    (N = P). Row i counts in bucket[i] iff contrib[i], the bucket is in
    [0, nb) and its value (with values) is not NaN. Returns count i32[nb],
    or (count i32[nb], sum f32[nb], min f32[nb], max f32[nb]); an empty
    bucket has sum 0.0, min F32_MAX and max -F32_MAX. Sums fold in the
    order of bucket_chunk_rows (csrc/bucket_fold.cu)."""
    dev = contrib.device
    _check(contrib, "contrib", torch.bool, 1, dev)
    p = contrib.shape[0]
    if bucket is not None:
        _check(bucket, "bucket", torch.int32, 1, dev)
        if bucket.shape[0] != p:
            raise ValueError(f"bucket must be [{p}]")
    if not 1 <= nb < 2**30:
        raise ValueError(f"bucket count {nb} out of range")
    if docs is not None and values is None:
        raise ValueError("docs gather from values")
    if values is not None:
        _check(values, "values", torch.float32, 1, dev)
        if docs is None:
            if values.shape[0] != p:
                raise ValueError(f"values must be [{p}] without docs")
        else:
            _check(docs, "docs", torch.int32, 1, dev)
            if docs.shape[0] != p:
                raise ValueError(f"docs must be [{p}]")
    if not _launchable(dev):
        return bucket_fold_plain(bucket, contrib, nb, values, docs)
    lib = ensure_built()
    ch = bucket_chunk_rows(p, nb)
    n_part = max(1, -(-p // ch) * nb)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    count = torch.empty(nb, **i32)
    p_count = torch.empty(n_part, **i32)
    planes = parts = [None] * 3
    if values is not None:
        planes = [torch.empty(nb, **f32) for _ in range(3)]
        parts = [torch.empty(n_part, **f32) for _ in range(3)]
    with torch.cuda.device(dev):
        rc = lib.esk_bucket_fold(
            _ptr(bucket), _ptr(contrib), _ptr(values), _ptr(docs), int(p),
            int(nb), int(ch), _ptr(p_count), *[_ptr(t) for t in parts],
            _ptr(count), *[_ptr(t) for t in planes], _stream(dev),
        )
    _check_rc("bucket_fold", rc)
    count_launch("bucket_fold")
    return count if values is None else (count, *planes)


def range_fold_plain(col, contrib, lo, hi, sub=None):
    """K10's range mode in PyTorch, in the kernel's order (see
    range_fold): the members' sub values (0.0 elsewhere, which adds no
    bit) fold along each chunk of docs, column by column, then across the
    chunks in order."""
    n = col.shape[0]
    r = lo.shape[0]
    member = (contrib[None, :] & (col[None, :] >= lo[:, None])
              & (col[None, :] < hi[:, None]))
    counts = member.sum(dim=1, dtype=torch.int32)
    if sub is None:
        return counts
    has = member & ~torch.isnan(sub)[None, :]
    vals = torch.where(has, sub[None, :], torch.zeros_like(sub)[None, :])
    group = torch.where(has, torch.arange(r, device=col.device)[:, None], r)
    vmin, vmax = _extrema(group.reshape(-1), vals.reshape(-1), r)
    ch = bucket_chunk_rows(n, r)
    n_chunks = -(-n // ch)
    grid = torch.nn.functional.pad(vals, (0, n_chunks * ch - n))
    grid = grid.view(r, n_chunks, ch)
    part = torch.zeros((r, n_chunks), dtype=torch.float32, device=col.device)
    for j in range(min(ch, n)):
        part = part + grid[:, :, j]
    total = torch.zeros(r, dtype=torch.float32, device=col.device)
    for c in range(n_chunks):
        total = total + part[:, c]
    return counts, has.sum(dim=1, dtype=torch.int32), total, vmin, vmax


def range_fold(col, contrib, lo, hi, sub=None):
    """K10 range mode: R ranges over N docs. Doc i is a member of range r
    iff contrib[i] and lo[r] <= col[i] < hi[r] (ranges may overlap; each
    reduces alone). col f32[N], contrib bool[N], lo / hi f32[R], sub
    f32[N] or None. Returns counts i32[R] (members), or with sub (counts,
    sub_count i32[R], sum f32[R], min f32[R], max f32[R]) over the members
    whose sub value is not NaN; the sums fold in scatter mode's order with
    the docs as rows (csrc/bucket_fold.cu)."""
    dev = col.device
    _check(col, "col", torch.float32, 1, dev)
    _check(contrib, "contrib", torch.bool, 1, dev)
    _check(lo, "lo", torch.float32, 1, dev)
    _check(hi, "hi", torch.float32, 1, dev)
    n = col.shape[0]
    r = lo.shape[0]
    if contrib.shape[0] != n or hi.shape[0] != r:
        raise ValueError("contrib must be [N] and hi [R]")
    if not 1 <= r < 2**21:
        raise ValueError(f"range count {r} out of range")
    if sub is not None:
        _check(sub, "sub", torch.float32, 1, dev)
        if sub.shape[0] != n:
            raise ValueError(f"sub must be [{n}]")
    if not _launchable(dev):
        return range_fold_plain(col, contrib, lo, hi, sub)
    lib = ensure_built()
    ch = bucket_chunk_rows(n, r)
    n_part = max(1, -(-n // ch) * r)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    counts = torch.empty(r, **i32)
    p_count = torch.empty(n_part, **i32)
    outs = parts = [None] * 4
    if sub is not None:
        outs = [torch.empty(r, **i32)] + [torch.empty(r, **f32)
                                          for _ in range(3)]
        parts = [torch.empty(n_part, **i32)] + [torch.empty(n_part, **f32)
                                                for _ in range(3)]
    with torch.cuda.device(dev):
        rc = lib.esk_range_fold(
            _ptr(col), _ptr(contrib), _ptr(sub), _ptr(lo), _ptr(hi), int(n),
            int(r), int(ch), _ptr(p_count), *[_ptr(t) for t in parts],
            _ptr(counts), *[_ptr(t) for t in outs], _stream(dev),
        )
    _check_rc("bucket_fold_range", rc)
    count_launch("bucket_fold_range")
    return counts if sub is None else (counts, *outs)


# ---------------------------------------------------------------------------
# K11 position_events and K12 position_walk (phrase and span queries)
# ---------------------------------------------------------------------------

# K11's modes: the phrase's (doc, aligned position) keys, the spans'
# (doc, position, clause) keys.
EVENTS_PHRASE, EVENTS_SPAN = 0, 1
# K12's modes; `first` is WALK_NEAR with an end limit, the unordered
# two-clause near WALK_NEAR with ordered false.
WALK_PHRASE, WALK_NEAR, WALK_NOT = 0, 1, 2

# Keys one K11 launch sorts at most (16 B of scratch each): larger
# batches run as several launches over consecutive rows, with identical
# results.
POSITION_EVENTS_MAX_KEYS = 1 << 28
# Rows one K11 or K12 launch takes (the grid's y extent).
MAX_GRID_ROWS = 65535

# The span programs' fp32 sentinels (bm25_device._span_chain_ends).
SPAN_NEG = -(2.0**31)
SPAN_INVALID_POS = 2**30


def event_key_bits(num_docs: int, pos_bits: int, clause_bits: int) -> int:
    """Width of K11's packed keys: the doc (0..num_docs, the sentinel
    included), then the position, then (span mode) the clause."""
    bits = int(num_docs).bit_length() + pos_bits + clause_bits
    if bits > 63:
        raise ValueError(
            f"position event keys need {bits} bits (at most 63): "
            f"{num_docs} docs, positions of {pos_bits} bits"
        )
    return bits


def clause_bits_for(n_clauses: int) -> int:
    """Bits of the clause field of a span key (at least 1)."""
    return max(1, (int(n_clauses) - 1).bit_length())


def event_keys(pos_doc, pos_val, tile_ids, starts, ends, lane_arg,
               num_docs: int, pos_bits: int, clause_bits: int, mode: int):
    """The unsorted packed keys int64[Q, P] of Q worklists and their
    validity bool[Q, P]: the worklist gather of `_eval_phrase` (:486-502)
    / `_gather_span_events` (:545-565)."""
    tid = tile_ids.to(torch.int64)
    lane = torch.arange(TILE, device=pos_doc.device, dtype=torch.int64)
    idx = tid[..., None] * TILE + lane
    valid = (idx >= starts.to(torch.int64)[..., None]) & (
        idx < ends.to(torch.int64)[..., None])
    if pos_doc.dim() == 3:  # stacked planes: row r reads shard r % S's
        shard = torch.arange(tid.shape[0], device=tid.device) % pos_doc.shape[0]
        tid = (shard.view(-1, 1), tid)
    docs = pos_doc[tid].to(torch.int64)
    poss = pos_val[tid].to(torch.int64)
    extra = lane_arg.to(torch.int64)[..., None]
    if mode == EVENTS_PHRASE:
        poss = poss - extra
        valid = valid & (poss >= 0)
        key = (docs << pos_bits) | poss
        low = pos_bits
    else:
        key = (((docs << pos_bits) | poss) << clause_bits) | extra
        low = pos_bits + clause_bits
    key = torch.where(valid, key, int(num_docs) << low)
    q = tile_ids.shape[0]
    return key.reshape(q, -1), valid.reshape(q, -1)


def position_events_plain(pos_doc, pos_val, tile_ids, starts, ends, lane_arg,
                          num_docs: int, pos_bits: int, clause_bits: int,
                          mode: int):
    """K11's plain version: `event_keys`, ordered by torch.sort. Returns
    (keys int64[Q, P] ascending, the row's valid events first; count
    int32[Q])."""
    key, valid = event_keys(pos_doc, pos_val, tile_ids, starts, ends,
                            lane_arg, num_docs, pos_bits, clause_bits, mode)
    keys, _ = torch.sort(key, dim=1)
    return keys, valid.sum(dim=1).to(torch.int32)


def position_events(pos_doc, pos_val, tile_ids, starts, ends, lane_arg,
                    num_docs: int, pos_bits: int, clause_bits: int,
                    mode: int):
    """K11: the position events of Q worklists, sorted.

    pos_doc / pos_val int32[PT, 256] (a field's positional planes);
    tile_ids / starts / ends / lane_arg int32[Q, NT], lane_arg the
    entry's shift (EVENTS_PHRASE) or clause (EVENTS_SPAN). An entry lane
    is valid where starts <= tile * 256 + lane < ends (and, phrase mode,
    apos = pos - shift >= 0). Keys: doc << pos_bits | apos (phrase) or
    (doc << pos_bits | pos) << clause_bits | clause (span); an invalid
    lane's key is num_docs shifted past the low fields, above every valid
    key. Returns (keys int64[Q, NT * 256] ascending, so a row's `count`
    valid events come first in (doc, apos) or (doc, pos, clause) order;
    count int32[Q]). Equal keys are indistinguishable, so the order is
    unique."""
    return _position_events(pos_doc, pos_val, tile_ids, starts, ends,
                            lane_arg, num_docs, pos_bits, clause_bits, mode, 0)


def position_events_stacked(pos_doc, pos_val, tile_ids, starts, ends,
                            lane_arg, num_docs: int, pos_bits: int,
                            clause_bits: int, mode: int):
    """K11s: position_events over R = Q x S rows of S stacked shards.

    pos_doc / pos_val are int32[S, PT, 256] (the shards' planes, packed
    with a common `field_pos_min_tiles`) and num_docs the padded
    per-shard doc count; row r of the [R, NT] worklists is (query r // S,
    shard r % S) and reads shard r % S's planes. Keys and ids stay
    shard-local. Returns (keys int64[R, NT * 256], count int32[R])."""
    return _position_events(pos_doc, pos_val, tile_ids, starts, ends,
                            lane_arg, num_docs, pos_bits, clause_bits, mode,
                            int(pos_doc.shape[0]))


def _position_events(pos_doc, pos_val, tile_ids, starts, ends, lane_arg,
                     num_docs, pos_bits, clause_bits, mode, n_shards):
    """Check K11's inputs (planes stacked iff n_shards > 0), then run the
    plain version for CPU tensors or launch the kernel."""
    dev = pos_doc.device
    st = 1 if n_shards else 0
    for t, name in ((pos_doc, "pos_doc"), (pos_val, "pos_val")):
        _check(t, name, torch.int32, 2 + st, dev)
    if pos_val.shape != pos_doc.shape or pos_doc.shape[-1] != TILE:
        raise ValueError("pos_doc / pos_val must be [PT, 256] planes")
    _check(tile_ids, "tile_ids", torch.int32, 2, dev)
    q, nt = tile_ids.shape
    for t, name in ((starts, "starts"), (ends, "ends"),
                    (lane_arg, "lane_arg")):
        _check(t, name, torch.int32, 2, dev)
        _check_rows(name, t, q, nt)
    if n_shards:
        _check_shards(n_shards, q, {"pos_doc": pos_doc})
    if mode not in (EVENTS_PHRASE, EVENTS_SPAN):
        raise ValueError(f"unknown position_events mode {mode}")
    if mode == EVENTS_PHRASE:
        clause_bits = 0
    bits = event_key_bits(num_docs, pos_bits, clause_bits)
    if not _launchable(dev):
        return position_events_plain(pos_doc, pos_val, tile_ids, starts,
                                     ends, lane_arg, num_docs, pos_bits,
                                     clause_bits, mode)
    lib = ensure_built()
    p = nt * TILE
    keys = torch.empty((q, p), dtype=torch.int64, device=dev)
    count = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0 or p == 0:
        return keys, count
    step = max(1, min(MAX_GRID_ROWS, POSITION_EVENTS_MAX_KEYS // p))
    chunk = events_chunk(p)
    nblocks = -(-p // chunk)
    scratch = torch.empty(min(q, step) * p, dtype=torch.int64, device=dev)
    counts = torch.empty(min(q, step) * 256 * (nblocks + 1), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        for r0 in range(0, q, step):
            rows = min(step, q - r0)
            rc = lib.esk_position_events(
                _ptr(pos_doc), _ptr(pos_val), _ptr(tile_ids, r0 * nt),
                _ptr(starts, r0 * nt), _ptr(ends, r0 * nt),
                _ptr(lane_arg, r0 * nt), int(rows), int(nt), int(num_docs),
                int(pos_bits), int(clause_bits), int(bits), int(mode),
                int(chunk), max(1, n_shards), _shard_stride(pos_doc),
                int(r0), _ptr(keys, r0 * p), _ptr(scratch), _ptr(counts),
                _ptr(count, r0), _stream(dev),
            )
            _check_rc("position_events", rc)
            count_launch("position_events", n_shards)
    return keys, count


position_events_stacked_plain = position_events_plain


def events_chunk(p: int) -> int:
    """Keys one K11 radix block histograms and scatters: at least 4,096,
    and enough that a row needs at most ~2,048 blocks (a multiple of
    256)."""
    per_block = -(-p // 2048)
    return max(4096, -(-per_block // 256) * 256)


def _segmented_cummax(seg_ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inclusive running max within runs of equal seg_ids along the last
    axis: the doubling form of the reference's associative scan (max is
    exact, so any association gives the same bits)."""
    out = vals.clone()
    n = vals.shape[-1]
    step = 1
    while step < n:
        same = seg_ids[..., step:] == seg_ids[..., :-step]
        out[..., step:] = torch.where(
            same, torch.maximum(out[..., step:], out[..., :-step]),
            out[..., step:])
        step <<= 1
    return out


def _decode_events(keys, num_docs: int, pos_bits: int, clause_bits: int,
                   mode: int):
    """(doc, position, clause) int64 planes of K11's keys; invalid lanes
    decode as the reference carries them (doc num_docs; position -1 in
    phrase mode, 2^30 and clause 0 in span mode)."""
    low = pos_bits + (clause_bits if mode != WALK_PHRASE else 0)
    d = keys >> low
    sentinel = d == num_docs
    if mode == WALK_PHRASE:
        p = keys & ((1 << pos_bits) - 1)
        return d, torch.where(sentinel, -1, p), None
    p = (keys >> clause_bits) & ((1 << pos_bits) - 1)
    c = keys & ((1 << clause_bits) - 1)
    return (d, torch.where(sentinel, SPAN_INVALID_POS, p),
            torch.where(sentinel, 0, c))


def _span_chain_ends(d, p, c, n_clauses: int, slop: int):
    """Events that END an ordered chain c0 < c1 < ... with total stretch
    <= slop (bm25_device._span_chain_ends :567, op for op)."""
    neg = torch.tensor(SPAN_NEG, dtype=torch.float32, device=d.device)
    pf = p.to(torch.float32)
    dp = torch.where(c == 0, pf, neg)
    n = d.shape[-1]
    idx = torch.arange(n, device=d.device).expand_as(d)
    is_new = torch.ones_like(d, dtype=torch.bool)
    is_new[..., 1:] = (d[..., 1:] != d[..., :-1]) | (p[..., 1:] != p[..., :-1])
    group_start = torch.cummax(torch.where(is_new, idx, -1), dim=-1).values
    prev_idx = torch.clamp(group_start - 1, min=0)
    has_prev = (group_start > 0) & (torch.gather(d, -1, prev_idx) == d)
    for level in range(1, n_clauses):
        vals = torch.where(c == level - 1, dp, neg)
        run = _segmented_cummax(d, vals)
        carry = torch.where(has_prev, torch.gather(run, -1, prev_idx), neg)
        dp = torch.where(c == level, carry, neg)
    ok = (c == n_clauses - 1) & (dp > neg)
    stretch = pf - dp - torch.tensor(float(n_clauses - 1), dtype=torch.float32)
    return ok & (stretch <= torch.tensor(float(slop), dtype=torch.float32))


def _walk_ok(d, p, c, n_docs: int, mode: int, n: int, slop: int,
             ordered: bool, end_limit: int, pre: int, post: int):
    """Per event: does it count toward its doc's frequency."""
    if mode == WALK_PHRASE:
        # `_eval_phrase` :503-514: an occurrence is a (doc, apos) group of
        # at least n_slots events, counted at its first event.
        q, m = d.shape
        d_ext = torch.cat([d, torch.full((q, n), n_docs + 1, dtype=d.dtype,
                                         device=d.device)], dim=1)
        a_ext = torch.cat([p, torch.full((q, n), -2, dtype=p.dtype,
                                         device=p.device)], dim=1)
        full = torch.ones_like(d, dtype=torch.bool)
        for j in range(1, n):
            full &= (d_ext[:, j:j + m] == d) & (a_ext[:, j:j + m] == p)
        is_start = torch.ones_like(full)
        is_start[:, 1:] = (d[:, 1:] != d[:, :-1]) | (p[:, 1:] != p[:, :-1])
        return full & is_start
    if mode == WALK_NEAR:
        ok = _span_chain_ends(d, p, c, n, slop)
        if not ordered and n == 2:
            ok = ok | _span_chain_ends(d, p, 1 - c, n, slop)
        if end_limit >= 0:
            ok = ok & (p + 1 <= end_limit)
        return ok
    # WALK_NOT (`_eval_span_not` :641-666): clause 0 include, 1 exclude.
    pf = p.to(torch.float32)
    neg = torch.tensor(SPAN_NEG, dtype=torch.float32, device=d.device)
    before = _segmented_cummax(d, torch.where(c == 1, pf, neg))
    after = -_segmented_cummax(
        d.flip(-1), torch.where(c.flip(-1) == 1, -pf.flip(-1), neg)
    ).flip(-1)
    violated = (before >= pf - torch.tensor(float(pre), dtype=torch.float32)) | (
        after <= pf + torch.tensor(float(post), dtype=torch.float32))
    return (c == 0) & ~violated


def position_walk_plain(keys, count, norm_bytes, weight, cache,
                        num_docs: int, pos_bits: int, clause_bits: int,
                        mode: int, n: int, slop: int = 0,
                        ordered: bool = True, end_limit: int = -1,
                        pre: int = 0, post: int = 0):
    """K12's plain version, the JAX programs step by step over all of a
    row's keys (the invalid ones included): the phrase run count, the
    span chain DP with its segmented cummax as a loop over levels, the
    span_not scans, then frequency by index_add_ of ones and the fp32
    BM25 tail (`_span_freq_scores` :598)."""
    d, p, c = _decode_events(keys, num_docs, pos_bits, clause_bits, mode)
    ok = _walk_ok(d, p, c, num_docs, mode, n, slop, ordered, end_limit,
                  pre, post) & (d != num_docs)
    q = keys.shape[0]
    dev = keys.device
    freq = torch.zeros((q, num_docs + 1), dtype=torch.float32, device=dev)
    idx = torch.where(ok, d, num_docs)
    freq.scatter_add_(1, idx, ok.to(torch.float32))
    freq = freq[:, :num_docs]
    matched = freq > 0
    nb = norm_bytes[..., :num_docs].to(torch.int64)
    if nb.dim() == 2:  # stacked [S, N + 1]: row r reads shard r % S's
        nb = nb.repeat(q // nb.shape[0], 1)
    ninv = torch.gather(cache, 1, nb.expand(q, num_docs))
    w = weight.reshape(q, 1)
    scores = w - w / (1.0 + freq * ninv)
    return torch.where(matched, scores, 0.0), matched


position_walk_stacked_plain = position_walk_plain


def position_walk(keys, count, norm_bytes, weight, cache, num_docs: int,
                  pos_bits: int, clause_bits: int, mode: int, n: int,
                  slop: int = 0, ordered: bool = True, end_limit: int = -1,
                  pre: int = 0, post: int = 0):
    """K12: per-doc walks over K11's sorted events -> frequency -> BM25.

    keys int64[Q, P] and count int32[Q] are position_events' output;
    norm_bytes uint8[num_docs + 1], weight f32[Q], cache f32[Q, 256].
    Modes: WALK_PHRASE (n = n_slots: a (doc, apos) group of >= n events
    is one occurrence), WALK_NEAR (n clauses, `slop`, `ordered` (two
    clauses), `end_limit` >= 0 for span_first) and WALK_NOT (include 0,
    exclude 1, `pre` / `post`). Returns (scores f32[Q, num_docs],
    w - w / (1 + freq * cache[norm]) where freq > 0, else 0; matched
    bool[Q, num_docs])."""
    return _position_walk(keys, count, norm_bytes, weight, cache, num_docs,
                          pos_bits, clause_bits, mode, n, slop, ordered,
                          end_limit, pre, post, 0)


def position_walk_stacked(keys, count, norm_bytes, weight, cache,
                          num_docs: int, pos_bits: int, clause_bits: int,
                          mode: int, n: int, slop: int = 0,
                          ordered: bool = True, end_limit: int = -1,
                          pre: int = 0, post: int = 0):
    """K12s: position_walk over R = Q x S rows of S stacked shards:
    norm_bytes is uint8[S, num_docs + 1] and row r (query r // S, shard
    r % S) reads shard r % S's; keys, count, weight and cache are the
    rows' own ([R, ...], position_events_stacked's output)."""
    return _position_walk(keys, count, norm_bytes, weight, cache, num_docs,
                          pos_bits, clause_bits, mode, n, slop, ordered,
                          end_limit, pre, post, int(norm_bytes.shape[0]))


def _position_walk(keys, count, norm_bytes, weight, cache, num_docs,
                   pos_bits, clause_bits, mode, n, slop, ordered, end_limit,
                   pre, post, n_shards):
    """Check K12's inputs (norm_bytes stacked iff n_shards > 0), then run
    the plain version for CPU tensors or launch the kernel."""
    dev = keys.device
    _check(keys, "keys", torch.int64, 2, dev)
    q, p = keys.shape
    _check(count, "count", torch.int32, 1, dev)
    _check(norm_bytes, "norm_bytes", torch.uint8, 2 if n_shards else 1, dev)
    _check(weight, "weight", torch.float32, 1, dev)
    _check(cache, "cache", torch.float32, 2, dev)
    if count.shape[0] != q or weight.shape[0] != q or tuple(cache.shape) != (q, 256):
        raise ValueError("count / weight / cache must have the keys' rows")
    if norm_bytes.shape[-1] < num_docs:
        raise ValueError("norm_bytes must cover num_docs")
    if n_shards:
        _check_shards(n_shards, q, {"norm_bytes": norm_bytes})
    if mode not in (WALK_PHRASE, WALK_NEAR, WALK_NOT) or n < 1:
        raise ValueError(f"bad position_walk mode {mode} / n {n}")
    if mode == WALK_PHRASE:
        clause_bits = 0
    event_key_bits(num_docs, pos_bits, clause_bits)
    if not _launchable(dev):
        return position_walk_plain(keys, count, norm_bytes, weight, cache,
                                   num_docs, pos_bits, clause_bits, mode, n,
                                   slop, ordered, end_limit, pre, post)
    lib = ensure_built()
    scores = torch.zeros((q, num_docs), dtype=torch.float32, device=dev)
    matched = torch.zeros((q, num_docs), dtype=torch.bool, device=dev)
    if q == 0 or p == 0:
        return scores, matched
    # A chain of more than two clauses keeps each level's DP value of
    # every event (the reference's dp plane).
    dp = (torch.empty((q, p), dtype=torch.float32, device=dev)
          if mode == WALK_NEAR and n > 2 else None)
    end_limit = min(int(end_limit), 2**31 - 1)
    with torch.cuda.device(dev):
        for r0 in range(0, q, MAX_GRID_ROWS):
            rows = min(MAX_GRID_ROWS, q - r0)
            rc = lib.esk_position_walk(
                _ptr(keys, r0 * p), _ptr(count, r0), _ptr(norm_bytes),
                _ptr(weight, r0), _ptr(cache, r0 * 256), int(rows), int(p),
                int(num_docs), int(pos_bits), int(clause_bits), int(mode),
                int(n), float(np.float32(slop)), int(bool(ordered)),
                end_limit, float(np.float32(pre)), float(np.float32(post)),
                max(1, n_shards), int(norm_bytes.shape[-1]), int(r0),
                _ptr(dp, r0 * p), _ptr(scores, r0 * num_docs),
                _ptr(matched, r0 * num_docs), _stream(dev),
            )
            _check_rc("position_walk", rc)
            count_launch("position_walk", n_shards)
    return scores, matched


# ---------------------------------------------------------------------------
# K13 doc_join
# ---------------------------------------------------------------------------

JOIN_MODES = ("none", "sum", "avg", "max", "min")  # csrc/doc_join.cu codes

_DEFAULT_NAN = -float("nan")  # x86's default NaN, 0xffc00000


def _propagate(r, a, b) -> torch.Tensor:
    """r with a NaN result replaced by the first NaN operand, else by x86's
    default NaN (csrc/doc_join.cu `esk_propagate`)."""
    dflt = torch.full((), _DEFAULT_NAN, dtype=torch.float32, device=r.device)
    nan = torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, dflt))
    return torch.where(torch.isnan(r), nan, r)


def _scatter_add(acc, v) -> torch.Tensor:
    """The reference scatter's add: a NaN update wins, then a NaN sum."""
    dflt = torch.full((), _DEFAULT_NAN, dtype=torch.float32, device=acc.device)
    r = acc + v
    r = torch.where(torch.isnan(r), dflt, r)
    return torch.where(torch.isnan(v), v, torch.where(torch.isnan(acc), acc, r))


def _scatter_max(acc, v) -> torch.Tensor:
    """The reference scatter's max: a NaN wins; of two NaNs the
    accumulator if its sign is set, else the update; +0.0 over -0.0."""
    na, nv = torch.isnan(acc), torch.isnan(v)
    plain = torch.where(acc == v, torch.where(acc.view(torch.int32) == 0, acc, v),
                        torch.where(acc > v, acc, v))
    both = torch.where(torch.signbit(acc), acc, v)
    return torch.where(na & nv, both,
                       torch.where(na, acc, torch.where(nv, v, plain)))


def doc_join_plain(child_matched, child_scores, child_start, boost, mode: str,
                   n_shards: int = 0):
    """K13's join mode in PyTorch, folding by child rank: step r folds the
    r-th child of every parent, so each parent's children fold in
    ascending order (an exact left fold, without index_add_), under the
    kernel's rules (csrc/doc_join.cu). A stacked child_start [S, N + 1]
    (n_shards = S) serves row r from shard r % S's. Returns (matched
    bool[Q, N], scores f32[Q, N])."""
    q = child_scores.shape[0]
    dev = child_scores.device
    if child_start.dim() == 2:  # stacked [S, N + 1]: row r reads shard r % S's
        starts = child_start.repeat(q // child_start.shape[0], 1)
    else:
        starts = child_start.expand(q, -1)
    n = starts.shape[1] - 1
    lo = starts[:, :-1].to(torch.int64)
    n_children = starts[:, 1:].to(torch.int64) - lo
    extremum = mode in ("max", "min")
    acc = torch.full((q, n), -float("inf") if extremum else 0.0,
                     dtype=torch.float32, device=dev)
    count = torch.zeros((q, n), dtype=torch.float32, device=dev)
    any_m = torch.zeros((q, n), dtype=torch.bool, device=dev)
    top = int(n_children.max()) if n else 0
    nn = child_scores.shape[1]
    for r in range(top):
        has = n_children > r
        idx = torch.clamp(lo + r, max=max(nn - 1, 0))
        m = torch.gather(child_matched, 1, idx).to(torch.bool) & has
        v = torch.gather(child_scores, 1, idx)
        if extremum:
            if mode == "min":  # -1 * v: a NaN keeps its sign
                v = torch.where(torch.isnan(v), v, flip_sign(v))
            acc = torch.where(m, _scatter_max(acc, v), acc)
        else:
            acc = torch.where(m, _scatter_add(acc, v), acc)
            count = torch.where(m, count + 1.0, count)
        any_m = any_m | m
    if mode == "none":
        return any_m, torch.zeros((q, n), dtype=torch.float32, device=dev)
    reduced = acc
    if mode == "avg":
        denom = torch.clamp(count, min=1.0)
        reduced = _propagate(acc / denom, acc, denom)
    elif mode == "min":
        reduced = flip_sign(acc)  # -best, a NaN's sign flipped too
    b = boost.reshape(q, 1)
    scores = _propagate(reduced * b, reduced, b.expand(q, n))
    return any_m, torch.where(any_m, scores, 0.0)


def doc_join(child_matched, child_scores, child_start, boost, mode: str,
             n_shards: int = 0):
    """K13 join mode: nested docs' results joined to their parents.

    child_matched bool[Q, NN] (the child's matched & the inner live
    plane), child_scores f32[Q, NN], child_start int32[N + 1] (the CSR of
    tiles.child_starts), boost f32[Q], mode one of JOIN_MODES. Returns
    (matched bool[Q, N], scores f32[Q, N]) as `_eval_nested` composes
    them. Stacked mode (n_shards = S > 0): child_start is int32[S, N + 1]
    and row r, the pair (query r // S, shard r % S), joins through shard
    r % S's; the child planes are the rows' own."""
    dev = child_scores.device
    _check(child_matched, "child_matched", torch.bool, 2, dev)
    _check(child_scores, "child_scores", torch.float32, 2, dev)
    _check(child_start, "child_start", torch.int32, 2 if n_shards else 1, dev)
    _check(boost, "boost", torch.float32, 1, dev)
    q, nn = child_scores.shape
    if tuple(child_matched.shape) != (q, nn) or boost.shape[0] != q:
        raise ValueError("child_matched / boost must have the scores' rows")
    if mode not in JOIN_MODES:
        raise ValueError(f"unknown nested score_mode [{mode}]")
    if not 1 <= q <= MAX_GRID_ROWS:
        raise ValueError(f"row count {q} out of range [1, {MAX_GRID_ROWS}]")
    if n_shards:
        _check_shards(n_shards, q, {"child_start": child_start})
    n = child_start.shape[-1] - 1
    if n < 0:
        raise ValueError("child_start must hold N + 1 offsets")
    if not _launchable(dev):
        return doc_join_plain(child_matched, child_scores, child_start,
                              boost, mode)
    lib = ensure_built()
    matched = torch.empty((q, n), dtype=torch.bool, device=dev)
    scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_doc_join(
            _ptr(child_matched), _ptr(child_scores), _ptr(child_start),
            _ptr(boost), int(q), int(nn), int(n), JOIN_MODES.index(mode),
            max(1, n_shards), _ptr(matched), _ptr(scores), _stream(dev),
        )
    _check_rc("doc_join", rc)
    count_launch("doc_join_" + mode, n_shards)
    return matched, scores


def doc_mark_plain(ids, boost, n: int, n_shards: int = 0):
    """K13's mark mode in PyTorch: (matched bool[Q, n], scores f32[Q, n]),
    boost where an id of the row points (the rows' ids are their shards'
    own over stacked shards, so `n_shards` changes nothing)."""
    q = ids.shape[0]
    dev = ids.device
    valid = (ids >= 0) & (ids < n)
    rows = torch.arange(q, device=dev).reshape(q, 1).expand_as(ids)
    matched = torch.zeros((q, n), dtype=torch.bool, device=dev)
    matched[rows[valid], ids[valid].to(torch.int64)] = True
    return matched, torch.where(matched, boost.reshape(q, 1), 0.0)


def doc_mark(ids, boost, n: int, n_shards: int = 0):
    """K13 mark mode (ids queries): ids int32[Q, ND] with -1 padding,
    boost f32[Q] -> (matched bool[Q, n], scores f32[Q, n]). Over S
    stacked shards (n_shards = S > 0) the rows are the (query, shard)
    pairs and their ids already shard-local, so the launch is the same;
    it counts as `doc_mark_stacked`."""
    dev = ids.device
    _check(ids, "ids", torch.int32, 2, dev)
    _check(boost, "boost", torch.float32, 1, dev)
    q, nd = ids.shape
    if boost.shape[0] != q:
        raise ValueError("boost must have the ids' rows")
    if not 1 <= q <= MAX_GRID_ROWS:
        raise ValueError(f"row count {q} out of range [1, {MAX_GRID_ROWS}]")
    if not _launchable(dev):
        return doc_mark_plain(ids, boost, n)
    lib = ensure_built()
    matched = torch.empty((q, n), dtype=torch.bool, device=dev)
    scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_doc_mark(
            _ptr(ids), _ptr(boost), int(q), int(nd), int(n), _ptr(matched),
            _ptr(scores), _stream(dev),
        )
    _check_rc("doc_mark", rc)
    count_launch("doc_mark", n_shards)
    return matched, scores


# ---------------------------------------------------------------------------
# K15 chain_perturb
# ---------------------------------------------------------------------------

_QUIET_BIT = 0x00400000


def chain_perturb_plain(leaf, prev_total):
    """K15's plain version: leaf + (float(prev_total) or 0.0) * 0.0 in
    fp32, a NaN leaf returned as its quieted self (XLA:CPU's add)."""
    carry = (torch.zeros((), dtype=torch.float32, device=leaf.device)
             if prev_total is None
             else prev_total.reshape(()).to(torch.float32))
    out = leaf + carry * 0.0
    quiet = (leaf.view(torch.int32) | _QUIET_BIT).view(torch.float32)
    return torch.where(torch.isnan(leaf), quiet, out)


def chain_perturb(leaf, prev_total):
    """K15: one chain step's perturbed leaf.

    leaf f32[...] (a plan row's boost or weights, contiguous), prev_total
    int32[1] (the previous step's total, on the leaf's device) or None
    for the first step. Returns a new f32 tensor of the leaf's shape:
    leaf + prev_total * 0.0, which is the leaf bit for bit but -0.0 ->
    +0.0, with a NaN leaf quieted (sign and payload kept). The total is
    read on the device: no host read between steps."""
    dev = leaf.device
    _check(leaf, "leaf", torch.float32, leaf.dim(), dev)
    if prev_total is not None:
        _check(prev_total, "prev_total", torch.int32, prev_total.dim(), dev)
        if prev_total.numel() != 1:
            raise ValueError("prev_total must hold one total")
    if not _launchable(dev):
        return chain_perturb_plain(leaf, prev_total)
    lib = ensure_built()
    out = torch.empty_like(leaf)
    if leaf.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.esk_chain_perturb(
            _ptr(leaf), _ptr(prev_total), int(leaf.numel()), _ptr(out),
            _stream(dev),
        )
    _check_rc("chain_perturb", rc)
    count_launch("chain_perturb")
    return out
