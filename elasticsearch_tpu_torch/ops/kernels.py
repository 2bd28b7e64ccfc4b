"""The port's four hand-written Hopper kernels, their bindings and their
plain PyTorch versions.

    K1 terms_scatter  csrc/terms_scatter.cu  worklist gather + BM25 impact +
                      ordered scatter (bm25_device._gather_tiles /
                      _eval_terms / _eval_terms_gather / _scatter_scored /
                      _terms_matched in the JAX package)
    K2 sparse_fold    csrc/sparse_fold.cu    candidate pairs, stable radix
                      sort by doc, run fold (_sparse_candidates)
    K3 masked_topk    csrc/masked_topk.cu    top-k by (score desc, index
                      asc) + eligible count (the masked lax.top_k)
    K4 span_locate    csrc/span_locate.cu    binary search in a sorted
                      posting span (_span_locate / _span_member)

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The build runs on the first launch
(or `ensure_built()`), into `_build/<sources hash>/` beside the package,
and again whenever the sources change. Each source compiles in its own
nvcc process, all started together, then one link.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take. For tensors on the CPU it runs the
plain version below it; for CUDA tensors it launches the kernel (on the
current stream, without synchronising) or raises — there is no fallback.
`LAUNCHES` counts kernel launches per wrapper (plain runs do not count).
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

# Largest shared-memory chunk K3 sorts per block (16384 u64 = 128 KB).
TOPK_MAX_CHUNK = 16384

LAUNCHES: dict[str, int] = {
    "terms_scatter": 0,
    "sparse_fold": 0,
    "masked_topk": 0,
    "span_locate": 0,
}

BUILD_INFO: dict[str, object] = {}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    lib.esk_terms_scatter.argtypes = [
        P, P, P, P, P, P, P, P, P, I, I, P, P, I, P,
    ]
    lib.esk_sparse_fold.argtypes = [
        P, P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P, P,
    ]
    lib.esk_masked_topk.argtypes = [P, P, I, I, I, P, P, P, P, P, P]
    lib.esk_span_locate.argtypes = [P, L, P, P, I, P, I, I, P, P, P]
    for fn in (
        lib.esk_terms_scatter,
        lib.esk_sparse_fold,
        lib.esk_masked_topk,
        lib.esk_span_locate,
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


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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


def _launchable(device: torch.device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); anything else is refused."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _f32_order(key: torch.Tensor) -> torch.Tensor:
    """Order-preserving unsigned bits of fp32 keys (as int64), with -0.0
    canonicalised to +0.0 — the composite K3 sorts by."""
    bits = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
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


def terms_scatter(
    doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
    num_docs: int, groups, cache=None, matched_only: bool = False,
):
    """BM25 term-disjunction scatter over a tile worklist.

    Returns (scores f32[num_docs + 1] or None in matched-only mode,
    matched bool[num_docs + 1]); slot num_docs is the discard slot.
    `groups` is term_groups(...) of the worklist, host-side."""
    dev = doc_tiles.device
    _check(doc_tiles, "doc_tiles", torch.int32, 2, dev)
    _check(vals, "vals", torch.float32, 2, dev)
    _check(norm_bytes, "norm_bytes", torch.uint8, 1, dev)
    for name, t, dt in (("tile_ids", tile_ids, torch.int32),
                        ("starts", starts, torch.int32),
                        ("ends", ends, torch.int32)):
        _check(t, name, dt, 1, dev)
    nt = tile_ids.shape[0]
    if starts.shape[0] != nt or ends.shape[0] != nt:
        raise ValueError("worklist arrays differ in length")
    if doc_tiles.shape[1] != TILE or vals.shape != doc_tiles.shape:
        raise ValueError("tile planes must be [NT, 256] and alike")
    if norm_bytes.shape[0] != num_docs + 1:
        raise ValueError("norm_bytes must have num_docs + 1 slots")
    if not matched_only:
        _check(weights, "weights", torch.float32, 1, dev)
        if weights.shape[0] != nt:
            raise ValueError("weights differ in length from the worklist")
    if cache is not None:
        _check(cache, "cache", torch.float32, 1, dev)
        if cache.shape[0] != 256:
            raise ValueError("cache must have 256 entries")
    groups = np.ascontiguousarray(np.asarray(groups, dtype=np.int32).reshape(-1, 2))
    if not _launchable(dev):
        return terms_scatter_plain(
            doc_tiles, vals, norm_bytes, tile_ids, starts, ends, weights,
            num_docs, groups, cache=cache, matched_only=matched_only,
        )
    lib = ensure_built()
    matched = torch.zeros(num_docs + 1, dtype=torch.bool, device=dev)
    scores = (
        None if matched_only
        else torch.zeros(num_docs + 1, dtype=torch.float32, device=dev)
    )
    with torch.cuda.device(dev):
        rc = lib.esk_terms_scatter(
            _ptr(doc_tiles), _ptr(vals), _ptr(norm_bytes), _ptr(cache),
            _ptr(tile_ids), _ptr(starts), _ptr(ends),
            None if matched_only else _ptr(weights),
            ctypes.c_void_p(groups.ctypes.data),  # host int32[G, 2]
            int(groups.shape[0]), int(nt),
            _ptr(scores), _ptr(matched), int(bool(matched_only)),
            _stream(dev),
        )
    _check_rc("terms_scatter", rc)
    LAUNCHES["terms_scatter"] += 1
    return scores, matched


# ---------------------------------------------------------------------------
# K2 sparse_fold
# ---------------------------------------------------------------------------


def sparse_fold_plain(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int,
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
    return docs_s, run_sum, head & in_range & live_at


def sparse_fold(
    doc_tiles, tn, tile_ids, starts, ends, weights, live,
    num_docs: int, t_pad: int,
):
    """Candidate-centric fold of a terms worklist.

    Returns (docs_s i32[P], run_sum f32[P], eligible bool[P]) with
    P = NT * 256: the (doc, contrib) pairs stably sorted by doc, each
    position's left fold over its run (at most t_pad entries), and
    eligible = run head & doc < num_docs & live[doc]."""
    dev = doc_tiles.device
    _check(doc_tiles, "doc_tiles", torch.int32, 2, dev)
    _check(tn, "tn", torch.float32, 2, dev)
    for name, t, dt in (("tile_ids", tile_ids, torch.int32),
                        ("starts", starts, torch.int32),
                        ("ends", ends, torch.int32),
                        ("weights", weights, torch.float32)):
        _check(t, name, dt, 1, dev)
    _check(live, "live", torch.bool, 1, dev)
    nt = tile_ids.shape[0]
    if starts.shape[0] != nt or ends.shape[0] != nt or weights.shape[0] != nt:
        raise ValueError("worklist arrays differ in length")
    if doc_tiles.shape[1] != TILE or tn.shape != doc_tiles.shape:
        raise ValueError("tile planes must be [NT, 256] and alike")
    if live.shape[0] != num_docs or num_docs < 1:
        raise ValueError("live must have num_docs >= 1 entries")
    if not 1 <= t_pad <= 1024:
        raise ValueError(f"t_pad {t_pad} out of range")
    p = nt * TILE
    if p >= 2**31:
        raise ValueError("worklist too large for int32 positions")
    if not _launchable(dev):
        return sparse_fold_plain(
            doc_tiles, tn, tile_ids, starts, ends, weights, live,
            num_docs, t_pad,
        )
    lib = ensure_built()
    i32, f32 = torch.int32, torch.float32
    keys_a = torch.empty(p, dtype=i32, device=dev)
    vals_a = torch.empty(p, dtype=f32, device=dev)
    keys_b = torch.empty(p, dtype=i32, device=dev)
    vals_b = torch.empty(p, dtype=f32, device=dev)
    counts = torch.empty(256 * max(1, -(-p // 4096)), dtype=i32, device=dev)
    docs_s = torch.empty(p, dtype=i32, device=dev)
    run_sum = torch.empty(p, dtype=f32, device=dev)
    eligible = torch.empty(p, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_sparse_fold(
            _ptr(doc_tiles), _ptr(tn), _ptr(tile_ids), _ptr(starts),
            _ptr(ends), _ptr(weights), int(nt), int(num_docs), int(t_pad),
            key_bits(num_docs), _ptr(live), _ptr(keys_a), _ptr(vals_a),
            _ptr(keys_b), _ptr(vals_b), _ptr(counts), _ptr(docs_s),
            _ptr(run_sum), _ptr(eligible), _stream(dev),
        )
    _check_rc("sparse_fold", rc)
    LAUNCHES["sparse_fold"] += 1
    return docs_s, run_sum, eligible


# ---------------------------------------------------------------------------
# K3 masked_topk
# ---------------------------------------------------------------------------


def topk_chunk(k: int) -> int:
    """Per-block chunk of K3: a power of two above 2k, in [1024, 16384]."""
    return min(TOPK_MAX_CHUNK, max(1024, 1 << max(0, 2 * k - 1).bit_length()))


def masked_topk_plain(key, eligible, k: int):
    m = key.shape[0]
    kp = min(k, m)
    total = eligible.sum(dtype=torch.int32)
    order = stable_order(0xFFFFFFFF - _f32_order(key), 32)[:kp]
    return key[order], order.to(torch.int32), total


def masked_topk(key, eligible, k: int):
    """Top-k of `key` by (score desc, index asc) — jax.lax.top_k's order —
    and total = count of `eligible`.

    key f32[M] must already hold -inf at ineligible entries. Returns
    (top_scores f32[min(k, M)], top_idx i32[min(k, M)], total i32[]).
    Callers pad to k exactly as the reference does when M < k."""
    dev = key.device
    _check(key, "key", torch.float32, 1, dev)
    _check(eligible, "eligible", torch.bool, 1, dev)
    m = key.shape[0]
    if eligible.shape[0] != m:
        raise ValueError("eligible differs in length from key")
    if k < 0:
        raise ValueError("k must be >= 0")
    if m >= 2**31:
        raise ValueError("key too long for int32 indices")
    if not _launchable(dev):
        return masked_topk_plain(key, eligible, k)
    kp = min(k, m)
    ch = topk_chunk(kp)
    if kp >= ch and m > ch:
        raise ValueError(
            f"k={k} exceeds the top-k kernel's window ({TOPK_MAX_CHUNK - 1})"
        )
    lib = ensure_built()
    nb = max(1, -(-m // ch))
    buf_a = torch.empty(max(1, nb * kp), dtype=torch.int64, device=dev)
    buf_b = torch.empty(max(1, nb * kp), dtype=torch.int64, device=dev)
    top_scores = torch.empty(kp, dtype=torch.float32, device=dev)
    top_idx = torch.empty(kp, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_masked_topk(
            _ptr(key), _ptr(eligible), int(m), int(kp), int(ch),
            _ptr(buf_a), _ptr(buf_b), _ptr(top_scores), _ptr(top_idx),
            _ptr(total), _stream(dev),
        )
    _check_rc("masked_topk", rc)
    LAUNCHES["masked_topk"] += 1
    return top_scores, top_idx, total


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


def span_locate(flat, starts, ends, j: int, cands):
    """(pos i32[P], found bool[P]) of each candidate doc against the sorted
    slice [starts[j], ends[j]) of a flat postings plane."""
    dev = flat.device
    _check(flat, "flat", torch.int32, 1, dev)
    _check(starts, "starts", torch.int32, 1, dev)
    _check(ends, "ends", torch.int32, 1, dev)
    _check(cands, "cands", torch.int32, 1, dev)
    if not 0 <= j < starts.shape[0] or ends.shape[0] != starts.shape[0]:
        raise ValueError(f"span row {j} out of range")
    if flat.shape[0] == 0:
        raise ValueError("flat plane is empty")
    if not _launchable(dev):
        return span_locate_plain(flat, starts, ends, j, cands)
    lib = ensure_built()
    p = cands.shape[0]
    pos = torch.empty(p, dtype=torch.int32, device=dev)
    found = torch.empty(p, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.esk_span_locate(
            _ptr(flat), int(flat.shape[0]), _ptr(starts), _ptr(ends), int(j),
            _ptr(cands), int(p), search_steps(flat.shape[0]), _ptr(pos),
            _ptr(found), _stream(dev),
        )
    _check_rc("span_locate", rc)
    LAUNCHES["span_locate"] += 1
    return pos, found
