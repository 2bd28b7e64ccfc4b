"""CPU models of K3's three designs on the card (csrc/masked_topk.cu
`topk_run`), held bit for bit to the unchanged plain versions and to the
JAX package.

The kernels run only on the card, so these tests model their schedules in
numpy, step for step, over the 64-bit composites every mode ranks (the
key's IEEE total-order bits above the inverted index, or K3i's canonical
score bits above the inverted id), and hold each model to the plain
version the card's checks use (`masked_topk_batch_plain`,
`masked_topk_stacked_plain`, `keyed_topk_batch_plain`,
`masked_topk_ids_batch_plain`, `masked_topk_window_plain`) and to
`jax.lax.top_k` plus the eligible count (`lax.sort((-s, id, s),
num_keys=2)` for the id mode):

- the route (`kernels.topk_route`): the threshold select for 1 <= kk <=
  256 (modelled by `_select_block` of test_torch_kernel_schedules.py,
  with the window offset and the id composite), the short-row sort for
  rows of at most SHORT_ROW_MAX entries, else the large-k select;
- the short-row sort: the row's composites in sorted runs of LK_RUN,
  merged by rank (an entry's place in its run plus the entries above it
  in the other runs, equal ones counted in the runs before its own), the
  top kk decoded;
- the large-k select: pass 0's histogram of the top digit and its bucket
  search; each later pass's digit histogram of the bucket and its search;
  the store (the first pass whose bucket fits S writes the winners above
  the bucket to F's front and the bucket to S, which later passes read
  instead of the input); the done test (stored, and winners plus bucket
  within LK_FINAL_CAP, or every digit fixed); the collect (S's entries,
  or the input's for a row that never stored, above the bucket after the
  front winners and the bucket's own up to F's capacity); the runs and
  their merge by rank over F, and the decode.

Each model runs at the kernel's constants and at small ones (4-bit
digits, 64-entry runs, a 600-entry F, a 512-entry short-row limit) that
force every path: buckets too large for S, a third read of the input, all
sixteen digits, equal composites cut to F's capacity, many runs.

Exact: every model output equals the plain version's and the reference's
bits. One CPU core, each JAX shape compiled once.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import kernels as K
from test_torch_kernel_schedules import KS_CAP, KS_ROUND, KS_SAMPLE, _keyed, _order, _select_block

torch.set_num_threads(1)

U64 = np.uint64
LOW = U64(0xFFFFFFFF)
F32_MAX = np.float32(np.finfo(np.float32).max)

# The kernel's constants, and small ones that force every path.
KERNEL = {"short_max": K.SHORT_ROW_MAX, "digit": 12, "ndig": 6,
          "final_cap": K.LK_FINAL_CAP, "bcap_div": K.LK_BCAP_DIV,
          "run": K.LK_RUN, "round": KS_ROUND, "sample": KS_SAMPLE,
          "cap": KS_CAP, "sms": 132}
SMALL = {"short_max": 512, "digit": 4, "ndig": 16, "final_cap": 600,
         "bcap_div": 4, "run": 64, "round": 256, "sample": 128,
         "cap": 2 * 256 + 8, "sms": 8}
PARAMS = {"kernel": KERNEL, "small": SMALL}


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def route(kp: int, width: int, p: dict) -> str:
    if 1 <= kp <= K.ROW_SELECT_MAX_K:
        return "select"
    return "short" if width <= p["short_max"] else "large"


# ---------------------------------------------------------------------------
# Composites and decodes
# ---------------------------------------------------------------------------


def raw_composites(key: np.ndarray) -> np.ndarray:
    """The row and window modes' composites (KEYED_RAW), window-local."""
    idx = np.arange(key.shape[0], dtype=np.uint64)
    return (_order(key) << U64(32)) | (~idx & LOW)


def id_composites(key: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """K3i's (KEYED_IDS): lax.sort's canonical order bits (zeros equal,
    NaN 0) above the inverted id."""
    canon = np.where(key == 0, np.float32(0), key).astype(np.float32)
    hi = np.where(np.isnan(key), U64(0), _order(canon))
    return (hi << U64(32)) | (~ids.astype(np.int64).astype(np.uint64) & LOW)


def decode_ids(top: np.ndarray):
    o = (top >> U64(32)).astype(np.uint32)
    b = np.where(o == 0, np.uint32(0x7FC00000),
                 np.where(o & np.uint32(0x80000000), o & np.uint32(0x7FFFFFFF), ~o))
    return b.astype(np.uint32).view(np.float32), (~top & LOW).astype(np.int64).astype(np.int32)


def _pos(top: np.ndarray) -> np.ndarray:
    return (~top & LOW).astype(np.int64)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def _find(hist: np.ndarray, need: int):
    """The bin (from the top) that holds rank `need`: (bin, above, size)."""
    cum = 0
    for b in range(hist.shape[0] - 1, -1, -1):
        if cum + int(hist[b]) >= need:
            return b, cum, int(hist[b])
        cum += int(hist[b])
    raise AssertionError("rank past the histogram")


def runs_rank(cand: np.ndarray, kq: int, run: int, stats: dict) -> np.ndarray:
    """The runs of `run` entries, each sorted, merged by rank: entry x at
    place p of run i goes to p + (entries above x in the runs after i) +
    (entries at or above x in the runs before i); ranks below kq kept."""
    runs = [np.sort(cand[i : i + run])[::-1] for i in range(0, cand.shape[0], run)]
    stats["runs"] = max(stats.get("runs", 0), len(runs))
    asc = [r[::-1] for r in runs]
    out = np.zeros(kq, dtype=np.uint64)
    filled = np.zeros(kq, dtype=bool)
    for i, r in enumerate(runs):
        x = r[:kq]
        rank = np.arange(x.shape[0])
        for j, other in enumerate(asc):
            if j != i:
                side = "left" if j < i else "right"  # at or above / above
                rank = rank + (other.shape[0] - np.searchsorted(other, x, side=side))
        keep = rank < kq
        assert not filled[rank[keep]].any()
        out[rank[keep]] = x[keep]
        filled[rank[keep]] = True
    assert filled.all()
    return out


def large_k_row(comp: np.ndarray, kq: int, width: int, p: dict, stats: dict):
    """The large-k select over one row's composites: its top kq."""
    d, ndig = p["digit"], p["ndig"]

    def shift(i):
        return 64 - d * (i + 1) if i < ndig - 1 else 0

    def nbits(i):
        return d if i < ndig - 1 else 64 - d * (ndig - 1)

    bcap = min(width, max(p["final_cap"], width // p["bcap_div"]))
    stats["reads"] = 1
    if kq == 0:
        return comp[:0]
    # Pass 0: every composite's top digit.
    digit, above, size = _find(np.bincount((comp >> U64(shift(0))).astype(np.int64),
                                           minlength=1 << nbits(0)), kq)
    prefix = U64(digit) << U64(shift(0))
    mask = U64((1 << nbits(0)) - 1) << U64(shift(0))
    digits, stored, done = 1, None, False
    front = comp[:0]
    for pss in range(1, ndig):
        if done:
            break  # the row's blocks return at once
        store = stored is None and size <= bcap
        if stored is not None:
            src = stored
        else:
            src = comp
            stats["reads"] += 1
        inb = (src & mask) == prefix
        if store:
            front = src[(src & mask) > prefix]
            stored = src[inb]
            stats["stored_at"] = pss
        dd = ((src[inb] >> U64(shift(pss))) & U64((1 << nbits(pss)) - 1)).astype(np.int64)
        digit, a2, size = _find(np.bincount(dd, minlength=1 << nbits(pss)), kq - above)
        prefix |= U64(digit) << U64(shift(pss))
        mask |= U64((1 << nbits(pss)) - 1) << U64(shift(pss))
        above += a2
        digits += 1
        done = (stored is not None and above + size <= p["final_cap"]) or digits == ndig
    assert done
    stats["digits"] = max(stats.get("digits", 0), digits)
    # The collect: from S, or from the input for a row that never stored.
    if stored is None:
        stats["reads"] += 1
        src = comp
    else:
        src = stored
    strict = src[(src & mask) > prefix]
    bucket = src[(src & mask) == prefix]
    assert front.shape[0] + strict.shape[0] == above < kq
    if above + bucket.shape[0] > p["final_cap"]:
        stats["cut"] = True
        assert digits == ndig and np.all(bucket == bucket[0])
    cand = np.concatenate([front, strict, bucket[: p["final_cap"] - above]])
    return runs_rank(cand, kq, p["run"], stats)


def select_row(comp: np.ndarray, kq: int, kp: int, width: int, q: int,
               head_of, p: dict, stats: dict):
    """The threshold select over one row: `ks_launch`'s blocks and
    stripes (over the widest row), each block's `_select_block` (its top
    kq, 0-padded), the last block's merge above the largest floor."""
    rounds = -(-width // p["round"])
    surv_row = max(1, min(rounds, p["cap"] // kp)) * kp  # the wrapper's
    nb = max(min(rounds, surv_row // kp, 2 * p["sms"] // q), 1)
    stripe = -(-(-(-width // nb)) // 4) * 4
    nb = max(-(-width // stripe), 1)
    stats["blocks"] = nb
    n = comp.shape[0]
    surv = []
    for b in range(nb):
        lo, hi = b * stripe, min(n, (b + 1) * stripe)
        if lo >= hi:
            surv.append(np.zeros(kq, dtype=np.uint64))
            continue
        surv.append(_select_block(comp, lo, hi, kq, {**p, "head": head_of(lo)}, stats))
    if kq == 0:
        return comp[:0]
    floor = max(s.min() for s in surv)
    assert floor > 0  # block 0 holds kq real composites
    gathered = np.concatenate([s[s >= floor] for s in surv])
    return np.sort(gathered)[::-1][:kq]


def top_rows(comps, kp: int, width: int, p: dict, heads=None):
    """Each row's top min(kp, its length) composites by the call's route."""
    r = route(kp, width, p)
    stats = {"route": r, "cuts": 0, "reads": 0}
    tops = []
    for i, comp in enumerate(comps):
        kq = min(kp, comp.shape[0])
        if r == "select":
            head_of = heads[i] if heads is not None else (lambda lo: 0)
            tops.append(select_row(comp, kq, kp, width, len(comps), head_of, p, stats))
        elif r == "short":
            tops.append(runs_rank(comp, kq, p["run"], stats))
        else:
            row_stats = {}
            tops.append(large_k_row(comp, kq, width, p, row_stats))
            stats["reads"] = max(stats["reads"], row_stats["reads"])
            stats["digits"] = max(stats.get("digits", 0), row_stats.get("digits", 0))
            stats["cut"] = stats.get("cut", False) or row_stats.get("cut", False)
            stats["runs"] = max(stats.get("runs", 0), row_stats.get("runs", 0))
            stats.setdefault("stored_at", []).append(row_stats.get("stored_at"))
    return tops, stats


def _pad(rows, out_k, fill, dtype):
    out = np.full((len(rows), out_k), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


def row_schedule(key, eligible, k, p):
    """masked_topk_batch's card schedule: (top_scores, top_idx, total)."""
    q, m = key.shape
    kp = min(k, m)
    tops, stats = top_rows([raw_composites(key[r]) for r in range(q)], kp, m, p,
                           heads=[(lambda lo, r=r: (-(r * m + lo)) % 4) for r in range(q)])
    pos = [_pos(t) for t in tops]
    out = (_pad([key[r][pos[r]] for r in range(q)], kp, -np.inf, np.float32),
           _pad([x.astype(np.int32) for x in pos], kp, 0, np.int32),
           eligible.sum(axis=1).astype(np.int32))
    return out, stats


def window_schedule(key, eligible, lo, hi, k, p):
    """masked_topk_window's: window-local ids, padding past min(k, w)."""
    q, m = key.shape
    out_k = min(k, m)
    wmax = int((hi - lo).max(initial=0))
    kw = min(out_k, wmax)
    comps = [raw_composites(key[r, lo[r]:hi[r]]) for r in range(q)]
    tops, stats = top_rows(comps, kw, wmax, p,
                           heads=[(lambda x, r=r: (-(r * m + lo[r] + x)) % 4) for r in range(q)])
    pos = [_pos(t) for t in tops]
    out = (_pad([key[r, lo[r]:hi[r]][pos[r]] for r in range(q)], out_k, -np.inf, np.float32),
           _pad([x.astype(np.int32) for x in pos], out_k, 0, np.int32),
           np.array([eligible[r, lo[r]:hi[r]].sum() for r in range(q)], np.int32))
    return out, stats


def ids_schedule(key, ids, eligible, k, p):
    """masked_topk_ids_batch's: (scores, ids, total)."""
    q, m = key.shape
    kp = min(k, m)
    tops, stats = top_rows([id_composites(key[r], ids[r]) for r in range(q)], kp, m, p,
                           heads=[(lambda lo, r=r: (-(r * m + lo)) % 4) for r in range(q)])
    dec = [decode_ids(t) for t in tops]
    out = (_pad([d[0] for d in dec], kp, -np.inf, np.float32),
           _pad([d[1] for d in dec], kp, 0, np.int32),
           eligible.sum(axis=1).astype(np.int32))
    return out, stats


def keyed_schedule(key, eligible, k, mode, desc, mf, after_key, after_doc, p):
    """keyed_topk_batch's: (values, ids, total, n_after)."""
    q, m = eligible.shape
    kp = min(k, m)
    comps, keeps, mks, raws = [], [], [], []
    for r in range(q):
        raw = (key if key.ndim == 1 else key[r]).astype(np.float32)
        ak = None if after_key is None else np.float32(after_key[r])
        ad = None if after_doc is None else int(after_doc[r])
        comp, keep, mk = _keyed(raw, eligible[r], mode, desc, mf, ak, ad)
        comps.append(comp)
        keeps.append(keep)
        mks.append(mk)
        raws.append(raw)
    tops, stats = top_rows(comps, kp, m, p)
    vals = []
    for r, t in enumerate(tops):
        i = _pos(t)
        if mode == K.KEYED_FIELD:
            v = raws[r][i]
        else:
            v = mks[r][i]
            if mode == K.KEYED_SCORE_ASC:
                v = np.where(np.isnan(v), (v.view(np.uint32) ^ np.uint32(0x80000000))
                             .view(np.float32), v)
        vals.append(v.astype(np.float32))
    out = (_pad(vals, kp, -np.inf, np.float32),
           _pad([_pos(t).astype(np.int32) for t in tops], kp, 0, np.int32),
           eligible.sum(axis=1).astype(np.int32),
           np.array([kk.sum() for kk in keeps], np.int32))
    return out, stats


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def _keys(kind, rng, q, m):
    """(key f32[q, m], eligible bool[q, m]) for the row and id modes."""
    key = rng.normal(size=(q, m)).astype(np.float32)
    elig = rng.random((q, m)) < 0.4
    if kind == "signed zeros and NaN":
        key[:, ::5] = np.nan
        key[:, 1::7] = -np.nan
        key[:, 2::11] = 0.0
        key[:, 3::13] = -0.0
        key[:, 4::17] = np.inf
        key[:, 6::19] = -np.inf
    elif kind == "-inf padding, finite ineligible keys":
        key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
        key[:, 3::97] = 50.0  # breaks the row-mode contract: ranked anyway
    elif kind == "fewer eligible than k":
        elig[:] = False
        elig[:, 7::401] = True
        key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
        key[-1, 40:50] = -np.nan  # below -inf
    elif kind == "all equal":
        key[:] = 3.0
    elif kind == "ties":
        key = np.round(key * 2).astype(np.float32)
    elif kind == "uniform":  # distinct keys over one binade and more
        key = rng.random((q, m), dtype=np.float32)
    return key, elig


# (q, m, k, keys) at the kernel's constants; SMALL_ROWS at the small ones.
ROW_CASES = {
    "k = 257": (2, 30_011, 257, "-inf padding, finite ineligible keys"),
    "k = 1,000": (2, 30_011, 1_000, "signed zeros and NaN"),
    "k = 4,097": (1, 30_011, 4_097, "ties"),
    "k = 10,000": (1, 30_011, 10_000, "uniform"),
    "k = M (short)": (2, 3_001, 3_001, "signed zeros and NaN"),
    "k = M - 1 (short)": (2, 3_001, 3_000, "ties"),
    "fewer eligible than k": (3, 30_011, 1_000, "fewer eligible than k"),
    "all equal": (1, 30_011, 5_000, "all equal"),
    "just under the short-row limit": (1, 16_384, 300, "signed zeros and NaN"),
    "just over the short-row limit": (1, 16_385, 300, "signed zeros and NaN"),
    "stacked, Q x S = 2 x 3": (6, 20_000, 400, "-inf padding, finite ineligible keys"),
}
SMALL_ROWS = {
    "k = 257": (2, 3_001, 257, "-inf padding, finite ineligible keys"),
    "k = 400": (2, 3_001, 400, "signed zeros and NaN"),
    "k = 511": (1, 3_001, 511, "uniform"),
    "k = M (short)": (2, 500, 500, "signed zeros and NaN"),
    "k = M - 1 (short)": (1, 500, 499, "ties"),
    "fewer eligible than k": (3, 3_001, 300, "fewer eligible than k"),
    "all equal": (1, 3_001, 300, "all equal"),
    "just under the short-row limit": (1, 512, 300, "ties"),
    "just over the short-row limit": (1, 513, 300, "ties"),
    "stacked, Q x S = 2 x 3": (6, 2_000, 300, "-inf padding, finite ineligible keys"),
    "more rows than 2 x 132": (300, 700, 300, "signed zeros and NaN"),
}
ROW_SETS = {"kernel": ROW_CASES, "small": SMALL_ROWS}

_JAX = {}


def _jax_top_k(key, k):
    sig = ("top_k", key.shape, k)
    if sig not in _JAX:
        _JAX[sig] = jax.jit(jax.vmap(lambda x: jax.lax.top_k(x, k)))
    top, idx = _JAX[sig](jnp.asarray(key))
    return np.asarray(top), np.asarray(idx).astype(np.int32)


def _jax_total(eligible):
    return np.asarray(jnp.sum(jnp.asarray(eligible), axis=1, dtype=jnp.int32))


def _same(got, want) -> bool:
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return False
        if w.dtype == np.float32:
            g, w = _bits(g), _bits(w)
        if not np.array_equal(g, w):
            return False
    return True


@pytest.fixture(scope="module")
def reference():
    """Each case's inputs with its plain and JAX answers, computed once."""
    cache = {}

    def get(kind, name, make):
        if (kind, name) not in cache:
            cache[kind, name] = make()
        return cache[kind, name]

    return get


def _row_case(params, name):
    q, m, k, kind = ROW_SETS[params][name]
    rng = np.random.default_rng(sorted(ROW_SETS[params]).index(name) + 31)
    key, elig = _keys(kind, rng, q, m)
    if name.startswith("stacked"):
        plain = K.masked_topk_stacked(_t(key), _t(elig), k, 3)
    else:
        plain = K.masked_topk_batch(_t(key), _t(elig), k)
    plain = tuple(t.numpy() for t in plain)
    top, idx = _jax_top_k(key, min(k, m))
    return key, elig, k, plain, (top, idx, _jax_total(elig))


@pytest.mark.parametrize("name", list(ROW_CASES))
def test_row_schedule_at_the_kernels_constants(name, reference):
    key, elig, k, plain, jax_out = reference("row", name, lambda: _row_case("kernel", name))
    got, stats = row_schedule(key, elig, k, KERNEL)
    assert _same(got, plain) and _same(got, jax_out)
    assert stats["route"] == K.topk_route(min(k, key.shape[1]), key.shape[1])
    if stats["route"] == "large" and name not in ("all equal", "fewer eligible than k"):
        # No long run of equal keys at rank k: the input is read twice.
        assert stats["reads"] == 2, stats


@pytest.mark.parametrize("name", list(SMALL_ROWS))
def test_row_schedule_at_small_constants(name, reference):
    key, elig, k, plain, jax_out = reference("small", name, lambda: _row_case("small", name))
    got, stats = row_schedule(key, elig, k, SMALL)
    assert _same(got, plain) and _same(got, jax_out)
    assert stats["route"] == route(min(k, key.shape[1]), key.shape[1], SMALL)


def test_small_constants_take_every_large_k_path():
    """Under the small constants: a bucket too large for S (a third
    read), all sixteen digits, and equal composites cut to the final
    block's capacity all happen, and the answer stays the plain one."""
    rng = np.random.default_rng(5)
    m = 3_001
    key = np.full((1, m), 2.0, np.float32)  # one bucket of 3,001: > S
    elig = np.ones((1, m), dtype=bool)
    got, stats = row_schedule(key, elig, 300, SMALL)
    assert stats["reads"] >= 3 and stats["digits"] > 8 and stats["runs"] > 1
    assert _same(got, tuple(t.numpy() for t in K.masked_topk_batch(_t(key), _t(elig), 300)))
    # Repeated id composites past the final block's capacity.
    s = np.full((1, m), -np.inf, np.float32)
    s[0, :100] = rng.random(100, dtype=np.float32)
    ids = np.full((1, m), 9_999, np.int32)
    ids[0, :100] = np.arange(100)
    got, stats = ids_schedule(s, ids, elig, 500, SMALL)
    assert stats["cut"] and stats["digits"] == SMALL["ndig"]
    want = K.masked_topk_ids_batch(_t(s), _t(ids), _t(elig), 500)
    assert _same(got, tuple(t.numpy() for t in want))
    # Keys over many magnitudes store their first 4-bit bucket: the input
    # is read twice.
    key = (np.sign(rng.normal(size=(1, m))) * 10.0 ** rng.uniform(-30, 30, (1, m))
           ).astype(np.float32)
    _got, stats = row_schedule(key, elig, 300, SMALL)
    assert stats["reads"] == 2 and stats["stored_at"] == [1]


# The id mode: (q, m, k) with repeated padding composites (-inf scores at
# the sentinel id) and the IVF merge's shape scaled down.
ID_CASES = {
    "k = 10 (the select)": (1, 1_250, 10, KERNEL),
    "k = 300 (short)": (2, 3_008, 300, KERNEL),
    "k = M (short)": (1, 1_504, 1_504, KERNEL),
    "k = 10,000, padding repeated (large)": (1, 30_080, 10_000, KERNEL),
    "k past the real entries (large)": (1, 20_000, 12_000, KERNEL),
    "small: k past the real entries": (1, 3_000, 500, SMALL),
}


def _id_case(name):
    q, m, k, p = ID_CASES[name]
    rng = np.random.default_rng(sorted(ID_CASES).index(name) + 3)
    s = (rng.random((q, m), dtype=np.float32) * 0.5 + 0.5).astype(np.float32)
    ids = rng.permutation(4 * m)[: q * m].reshape(q, m).astype(np.int32)
    pad = rng.random((q, m)) < (0.7 if "past" in name else 0.35)
    s[pad] = -np.inf
    ids[pad] = 4 * m  # the sentinel: one composite, repeated
    s[:, 1::53] = np.round(s[:, 1::53], 2)  # score ties: the id decides
    s[:, 5] = -0.0
    s[:, 6] = 0.0
    elig = np.ones((q, m), dtype=bool)
    plain = tuple(t.numpy() for t in K.masked_topk_ids_batch(_t(s), _t(ids), _t(elig), k))
    return s, ids, elig, k, p, plain


@pytest.mark.parametrize("name", list(ID_CASES))
def test_id_schedule_equals_plain_and_lax_sort(name, reference):
    s, ids, elig, k, p, plain = reference("ids", name, lambda: _id_case(name))
    got, stats = ids_schedule(s, ids, elig, k, p)
    assert _same(got, plain)
    kp = min(k, s.shape[1])
    assert stats["route"] == route(kp, s.shape[1], p)
    for r in range(s.shape[0]):
        _neg, doc, ss = (np.asarray(x) for x in jax.lax.sort(
            (-jnp.asarray(s[r]), jnp.asarray(ids[r]), jnp.asarray(s[r])), num_keys=2))
        assert np.array_equal(got[1][r], doc[:kp])
        canon = np.where(ss[:kp] == 0, np.float32(0), ss[:kp]).astype(np.float32)
        assert np.array_equal(_bits(got[0][r]), _bits(canon))


# K3k: (keys, k, mode, desc, missing_first, cursor) over [q, m].
def _keyed_case(name):
    rng = np.random.default_rng(len(name) * 7 + 1)
    m = 20_011 if not name.startswith("small") else 2_003
    p = SMALL if name.startswith("small") else KERNEL
    elig = rng.random((1, m)) < 0.5
    f1 = rng.random(m, dtype=np.float32)
    none = (None, None)
    if name.endswith("f1 desc, k = 10,000"):
        return f1, elig, 10_000, K.KEYED_FIELD, True, False, none, p
    if name.endswith("mostly missing, desc"):
        miss = np.full(m, np.nan, np.float32)
        miss[::997] = f1[::997]
        return miss, elig, min(1_000, m // 4), K.KEYED_FIELD, True, False, none, p
    if name.endswith("mostly missing, missing first"):
        miss = np.full(m, np.nan, np.float32)
        miss[::997] = f1[::997]
        return miss, elig, 400, K.KEYED_FIELD, False, True, none, p
    if name.endswith("ascending ts-like, desc"):
        ts = (np.arange(m, dtype=np.float32) * 1000.0 + np.float32(1.7e12)).astype(np.float32)
        return ts, elig, 2_000 if m > 5_000 else 400, K.KEYED_FIELD, True, False, none, p
    if name.endswith("cursor keeps almost nothing"):
        sc = (rng.random((1, m)) * 10).astype(np.float32)
        return sc, elig, 500, K.KEYED_SCORE_ASC, False, False, (
            np.array([9.999], np.float32), np.array([3], np.int32)), p
    if name.endswith("+-NaN bottom-k"):
        sc = rng.normal(size=(2, m)).astype(np.float32)
        sc[:, ::5] = np.nan
        sc[:, 1::7] = -np.nan
        return sc, rng.random((2, m)) < 0.5, 300, K.KEYED_SCORE_ASC, False, False, none, p
    if name.endswith("desc cursor, Q = 2"):
        sc = (rng.random((2, m)) * 4).astype(np.float32)
        return sc, rng.random((2, m)) < 0.6, 700 if m > 5_000 else 300, K.KEYED_SCORE_DESC, \
            False, False, (np.array([3.0, 2.0], np.float32), np.array([10, 20], np.int32)), p
    raise KeyError(name)


KEYED_CASES = [
    "f1 desc, k = 10,000", "mostly missing, desc", "mostly missing, missing first",
    "ascending ts-like, desc", "cursor keeps almost nothing", "+-NaN bottom-k",
    "desc cursor, Q = 2", "small: mostly missing, desc", "small: ascending ts-like, desc",
    "small: +-NaN bottom-k", "small: desc cursor, Q = 2",
]


@pytest.mark.parametrize("name", KEYED_CASES)
def test_keyed_schedule_equals_plain_and_lax_top_k(name, reference):
    def make():
        key, elig, k, mode, desc, mf, (ak, ad), p = _keyed_case(name)
        plain = K.keyed_topk_batch_plain(
            _t(key), _t(elig), k, mode, desc, mf,
            None if ak is None else _t(ak), None if ad is None else _t(ad))
        return key, elig, k, mode, desc, mf, ak, ad, p, tuple(t.numpy() for t in plain)

    key, elig, k, mode, desc, mf, ak, ad, p, plain = reference("keyed", name, make)
    got, stats = keyed_schedule(key, elig, k, mode, desc, mf, ak, ad, p)
    assert _same(got, plain)
    m = elig.shape[1]
    assert stats["route"] == route(min(k, m), m, p)
    # lax.top_k over the value the composites rank (keyed_value_m's).
    seen = np.stack([_keyed((key if key.ndim == 1 else key[r]).astype(np.float32), elig[r],
                            mode, desc, mf, None if ak is None else np.float32(ak[r]),
                            None if ad is None else int(ad[r]))[0] for r in range(elig.shape[0])])
    ranked = ((seen >> U64(32)).astype(np.uint32))
    vals = np.where(ranked & np.uint32(0x80000000), ranked & np.uint32(0x7FFFFFFF),
                    ~ranked).astype(np.uint32).view(np.float32)
    _top, idx = _jax_top_k(vals, min(k, m))
    assert np.array_equal(got[1], idx)


def _window_case(params):
    p = PARAMS[params]
    m = 20_000 if params == "kernel" else 1_500
    rng = np.random.default_rng(17 if params == "kernel" else 18)
    key = rng.normal(size=(5, m)).astype(np.float32)
    elig = rng.random((5, m)) < 0.5
    key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
    key[:, ::37] = np.round(key[:, ::37])
    wide = p["short_max"] + 3
    lo = np.array([0, 5, 10, m - 100, 7], np.int32)
    hi = np.array([0, 105, 10 + wide, m, 7 + wide // 2], np.int32)  # 0, < k, > limit
    return key, elig, lo, hi, p


@pytest.mark.parametrize("k", [10, 257, 300])
@pytest.mark.parametrize("params", sorted(PARAMS))
def test_window_schedule_equals_plain_and_lax_top_k(params, k, reference):
    key, elig, lo, hi, p = reference("window", params, lambda: _window_case(params))
    got, stats = window_schedule(key, elig, lo, hi, k, p)
    plain = K.masked_topk_window(_t(key), _t(elig), _t(lo), _t(hi), k)
    assert _same(got, tuple(t.numpy() for t in plain))
    wmax = int((hi - lo).max())
    assert stats["route"] == route(min(k, key.shape[1], wmax), wmax, p)
    for r in range(key.shape[0]):
        w = int(hi[r] - lo[r])
        n = min(k, w)
        if n:
            top, idx = _jax_top_k(key[r : r + 1, lo[r] : hi[r]], n)
            assert np.array_equal(got[1][r, :n], idx[0])
            assert np.array_equal(_bits(got[0][r, :n]), _bits(top[0]))
        assert np.all(got[0][r, n:] == -np.inf) and np.all(got[1][r, n:] == 0)
        assert got[2][r] == int(_jax_total(elig[r : r + 1, lo[r] : hi[r]])[0])


# ---------------------------------------------------------------------------
# The wrappers' card path and the names the source shares with them
# ---------------------------------------------------------------------------


def test_switches_are_named_alike_in_the_wrappers_and_the_source():
    """The 256 switch, the short-row limit and the large-k select's
    constants are the same numbers in kernels.py and masked_topk.cu, and
    the wrappers' docstrings name the switch and the limit."""
    src = (K.CSRC_DIR / "masked_topk.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("KS_MAX_K") == K.ROW_SELECT_MAX_K == K.KEYED_SELECT_MAX_K == 256
    assert define("LK_SHORT_MAX") == K.SHORT_ROW_MAX == 16384
    assert define("LK_FINAL_CAP") == K.LK_FINAL_CAP
    assert define("LK_ROW_INTS") == K.LK_ROW_INTS
    assert define("LK_BCAP_DIV") == K.LK_BCAP_DIV
    assert 1 << define("LK_DIGIT") == K.LK_BINS
    assert define("KS_THREADS") * 8 == K.KS_ROUND and K.KS_CAP == 2 * K.KS_ROUND + 8
    assert define("LK_RUN_THREADS") * define("LK_RUN_E") == K.LK_RUN
    assert "c.kp >= 1 && c.kp <= KS_MAX_K" in src and "c.width <= LK_SHORT_MAX" in src
    for fn in (K.masked_topk_batch, K.keyed_topk_batch):
        assert "SHORT_ROW_MAX" in fn.__doc__
    assert "ROW_SELECT_MAX_K" in K.masked_topk_batch.__doc__
    # The chunk sorts are gone.
    for gone in ("topk_block_kernel", "keyed_block_kernel", "merge_passes",
                 "topk_survivors", "count_true_kernel", "keyed_count_kernel",
                 "topk_decode_kernel", "topk_decode_window_kernel"):
        assert gone not in src


class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("esk_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorded(monkeypatch):
    lib = _Lib()
    launches = []

    def launch(name, device, fn, *args):
        launches.append(name)
        fn(*args)

    monkeypatch.setattr(K, "_launchable", lambda dev: True)
    monkeypatch.setattr(K, "ensure_built", lambda: lib)
    monkeypatch.setattr(K, "_launch", launch)
    K.reset_launches()
    yield lib, launches
    K.reset_launches()


@pytest.mark.parametrize("m, k, want", [
    (20_000, 10, "select"), (20_000, 300, "large"), (16_384, 300, "short"),
    (16_385, 300, "large"), (3_000, 0, "short"), (20_000, 0, "large"),
])
def test_every_wrapper_makes_one_host_call_with_one_allocation(recorded, m, k, want):
    """Each K3 wrapper on the card's path: one library call, the outputs,
    the counts and the scratch of one tensor at the addresses the source
    reads (TopkCall), the route counted under its launch name."""
    lib, launches = recorded
    q = 2
    key = torch.zeros((q, m), dtype=torch.float32)
    elig = torch.ones((q, m), dtype=torch.bool)
    ids = torch.zeros((q, m), dtype=torch.int32)
    kp = min(k, m)
    assert K.topk_route(kp, m) == want
    row = {"select": max(1, min(-(-m // K.KS_ROUND), K.KS_CAP // max(kp, 1))) * max(kp, 1),
           "short": -(-m // K.LK_RUN) * K.LK_RUN if m > K.LK_RUN else 0,
           "large": K.large_k_bcap(m)}[want]
    calls = [
        ("masked_topk_batch", lambda: K.masked_topk_batch(key, elig, k)),
        ("masked_topk_ids", lambda: K.masked_topk_ids_batch(key, ids, elig, k)),
        ("masked_topk_stacked", lambda: K.masked_topk_stacked(key, elig, k, 2)),
        ("keyed_topk", lambda: K.keyed_topk_batch(key[0], elig, k, K.KEYED_FIELD, True)),
        ("masked_topk_window", lambda: K.masked_topk_window(
            key, elig, torch.zeros(q, dtype=torch.int32), torch.full((q,), m, dtype=torch.int32), k)),
    ]
    for name, call in calls:
        lib.calls.clear()
        out = call()
        ((entry, args),) = lib.calls
        if name == "masked_topk_window":
            (_k, _e, _lo, _hi, aq, am, wmax, kw, out_k, counts, scratch, srow,
             values, idx) = args
            assert (aq, am, wmax, kw, out_k) == (q, m, m, kp, kp)
        elif name == "keyed_topk":
            (_k, stride, _e, aq, am, akp, mode, desc, mf, _ak, _ad, counts,
             scratch, srow, values, idx) = args
            assert (stride, aq, am, akp, mode, desc) == (0, q, m, kp, K.KEYED_FIELD, 1)
        else:
            _k, aids, _e, aq, am, akp, counts, scratch, srow, values, idx = args
            assert (aq, am, akp) == (q, m, kp) and (aids is None) == (name != "masked_topk_ids")
        assert srow == row
        n_counts = 4 * q + (q * (K.LK_ROW_INTS + K.LK_BINS) if want == "large" else 0)
        assert idx == values + 4 * q * kp and counts == values + 8 * q * kp
        assert scratch == counts + 4 * n_counts and scratch % 8 == 0
        if kp:
            assert out[0].data_ptr() == values and out[1].data_ptr() == idx
        assert out[2].data_ptr() == counts and out[2].shape == (q,)
        if name == "keyed_topk":
            assert out[3].data_ptr() == counts + 4 * q
        assert K.TOPK_ROUTES[f"{name}:{want}"] == 1
    assert launches == ["masked_topk", "masked_topk", "masked_topk", "keyed_topk",
                        "masked_topk_window"]
    assert sum(K.TOPK_ROUTES.values()) == 5


def test_limit_keeps_its_message():
    """Past 16,384 entries a row ranks at most 16,383 (LK_FINAL_CAP - 1)."""
    key = torch.zeros((1, 16_385))
    with pytest.raises(ValueError, match=r"exceeds the top-k kernel's window \(16383\)"):
        K._check_topk_limit(16_384, 16_384, 16_385)
    K._check_topk_limit(16_383, 16_383, key.shape[1])
    K._check_topk_limit(16_384, 16_384, 16_384)  # a short row sorts whole
