"""CPU models of the operation order of two hand-written kernels, held
bit for bit to their unchanged plain versions.

K9 ivf_assign (csrc/ivf_assign.cu) and K3k keyed_topk's threshold select
(csrc/masked_topk.cu) run only on the card, so these tests model their
schedules in numpy / torch, step for step, and hold each model to the
plain version the card's checks use (`kernels.ivf_assign_plain`,
`kernels.keyed_topk_batch_plain`):

- K9: each (row, centroid) pair's 32 lane partials are the leaves of
  lane_sum's fold, taken in 5-bit bit-reversed lane order onto a pairwise
  stack, each leaf summing its slabs in ascending order (a padded column
  adds +0.0); d2 = (|x|^2 - 2 x.c) + |c|^2; each thread's running best
  over its columns (4 consecutive centroids of every 128-centroid tile) in
  ascending order, then the warp's butterfly under (NaN first, smaller,
  lower index). Cases: d in {1, 16, 31, 32, 33, 100} and a wide d, signed
  zeros, subnormals, duplicated centroids, NaN and inf rows.
- K3k: the block count and stripes of `ks_launch`, each block's sampled
  threshold (64 runs of 32), its rounds with the cut to the top k past a
  round's worth of candidates, the last block's merge over the blocks'
  floors, the decode, and the switch on k above KEYED_SELECT_MAX_K to the
  large-k select (modelled in test_torch_k3_large_select.py). Cases: random, ascending and descending columns,
  all-equal and mostly-missing columns, +/-NaN, k above the eligible
  count, cursors, Q > 1 over a shared and per-row keys, at the kernel's
  constants and at small ones that force many blocks and cuts.

Exact: every model output equals the plain version's bits.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import kernels as kern

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def _brev5(v: int) -> int:
    return int(f"{v:05b}"[::-1], 2)


def _fold32(acc: torch.Tensor) -> torch.Tensor:
    """The warp's shuffle-down fold of 32 lane values (last axis)."""
    for off in (16, 8, 4, 2, 1):
        acc = acc[..., :off] + acc[..., off : 2 * off]
    return acc[..., 0]


def _row_sq(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 as one warp a row sums it: slabs in ascending order per lane
    (the first slab as is), then the fold."""
    slabs = -(-x.shape[1] // 32)
    xp = torch.nn.functional.pad(x, (0, slabs * 32 - x.shape[1]))
    sq = (xp * xp).reshape(x.shape[0], slabs, 32)
    acc = sq[:, 0]
    for s in range(1, slabs):
        acc = acc + sq[:, s]
    return _fold32(acc)


def _leaf_stack_dot(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x.c of every (row, centroid) pair as the kernel's threads sum it:
    leaf position p = 0..31 reads lane brev5(p); a leaf is the product of
    its first slab plus the next slabs' products, padded columns +0.0
    (staged zeros); the pairwise stack merges while p's low bits are set,
    the older subtree on the left."""
    d = x.shape[1]
    slabs = -(-d // 32)
    xp = torch.nn.functional.pad(x, (0, slabs * 32 - d)).reshape(-1, slabs, 32)
    cp = torch.nn.functional.pad(c, (0, slabs * 32 - d)).reshape(-1, slabs, 32)
    stack: list = [None] * 5
    part = None
    for p in range(32):
        lane = _brev5(p)
        part = xp[:, 0, lane][:, None] * cp[:, 0, lane][None, :]
        for s in range(1, slabs):
            part = part + xp[:, s, lane][:, None] * cp[:, s, lane][None, :]
        lv = 0
        while lv < 5 and (p >> lv) & 1:
            part = stack[lv] + part
            lv += 1
        if lv < 5:
            stack[lv] = part
    return part


def _before(da, ia, db, ib):
    """(da, ia) ranks before (db, ib): ib < 0 empty, a NaN first, then the
    smaller distance, then the lower index."""
    na, nb = torch.isnan(da), torch.isnan(db)
    smaller = ~na & ~nb & (da < db)
    tie = ((na & nb) | (~na & ~nb & (da == db))) & (ia < ib)
    better = (na & ~nb) | smaller | tie
    return (ib < 0) & (ia >= 0) | (ia >= 0) & (ib >= 0) & better


def k9_schedule(centroids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K9's assignment in the kernel's operation order."""
    cc = _row_sq(centroids)
    xx = _row_sq(rows)
    xc = _leaf_stack_dot(rows, centroids)
    two = torch.full((), 2.0, dtype=torch.float32)
    d2 = (xx[:, None] - torch.mul(two, xc)) + cc[None, :]
    m, c_n = d2.shape
    # Lane t of a warp owns centroids c0 + 4t + b of every 128-tile c0.
    best = torch.zeros((32, m), dtype=torch.float32)
    best_i = torch.full((32, m), -1, dtype=torch.int64)
    for c0 in range(0, c_n, 128):
        for lane in range(32):
            for b in range(4):
                col = c0 + lane * 4 + b
                if col >= c_n:
                    continue
                take = _before(d2[:, col], torch.full((m,), col), best[lane],
                               best_i[lane])
                best[lane] = torch.where(take, d2[:, col], best[lane])
                best_i[lane] = torch.where(take, col, best_i[lane])
    for off in (16, 8, 4, 2, 1):
        other = [lane ^ off for lane in range(32)]
        od, oi = best[other], best_i[other]
        take = _before(od, oi, best, best_i)
        best = torch.where(take, od, best)
        best_i = torch.where(take, oi, best_i)
    return torch.clamp(best_i[0], min=0).to(torch.int32)


def _k9_case(name, rng):
    if name.startswith("d="):
        d = int(name[2:])
        return (rng.normal(size=(150, d)).astype(np.float32),
                rng.normal(size=(200, d)).astype(np.float32))
    d = 100
    cents = rng.normal(size=(150, d)).astype(np.float32)
    rows = rng.normal(size=(200, d)).astype(np.float32)
    if name == "signed zeros":
        cents[3] = -0.0
        cents[4] = 0.0
        cents[5, ::2] = -0.0
        rows[:40] = 0.0
        rows[20:40] = -0.0
        rows[40:50, ::3] = -0.0
    elif name == "subnormals":
        sub = np.float32(1e-40)
        cents[:30] = sub * rng.normal(size=(30, d)).astype(np.float32)
        rows[:60] = np.float32(3e-39) * rng.normal(size=(60, d)).astype(np.float32)
        rows[60:70] = sub
    elif name == "duplicated centroids":
        cents[100:150] = cents[0:50]
        rows[:50] = cents[:50]
        ints = rng.integers(-2, 3, size=(150, 16)).astype(np.float32)
        return ints, rng.integers(-2, 3, size=(300, 16)).astype(np.float32)
    elif name == "nan and inf rows":
        rows[0, 3] = np.nan
        rows[1] = np.inf
        rows[2, 0] = -np.inf
        cents[7, 1] = np.nan
    return cents, rows


K9_CASES = ["d=1", "d=16", "d=31", "d=32", "d=33", "d=100", "d=200",
            "signed zeros", "subnormals", "duplicated centroids",
            "nan and inf rows"]


@pytest.mark.parametrize("name", K9_CASES)
def test_k9_schedule_equals_ivf_assign_plain(name):
    rng = np.random.default_rng(K9_CASES.index(name) + 90)
    cents, rows = (torch.from_numpy(a) for a in _k9_case(name, rng))
    got = k9_schedule(cents, rows)
    want = kern.ivf_assign_plain(cents, rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [1, 16, 33, 100])
def test_k9_leaf_stack_is_lane_sums_association(d):
    """The bit-reversed leaves on the pairwise stack give lane_sum's x.c
    bit for bit (signed zeros included), not only the same argmin."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(40, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(30, d)).astype(np.float32))
    x[:5] = -0.0
    c[:3, ::2] = -0.0
    got = _leaf_stack_dot(x, c)
    want = kern.lane_sum(x[:, None, :] * c[None, :, :])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(_row_sq(x).view(torch.int32),
                       kern.lane_sum(x * x).view(torch.int32))


# ---------------------------------------------------------------------------
# K3k
# ---------------------------------------------------------------------------

KS_ROUND = 4096
KS_SAMPLE = 2048
KS_CAP = 2 * KS_ROUND + 8
F32_MAX = np.float32(np.finfo(np.float32).max)


def _order(x: np.ndarray) -> np.ndarray:
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _keyed(raw, elig, mode, desc, mf, ak, ad):
    """keyed_value_m over a row: (composites u64, keep, masked)."""
    idx = np.arange(raw.shape[0], dtype=np.int64)
    key = raw
    if mode == kern.KEYED_FIELD:
        k0 = -raw if desc else raw
        key = np.where(np.isnan(k0), -F32_MAX if mf else F32_MAX, k0)
    keep = elig.copy()
    if ak is not None:
        past = key < ak if mode == kern.KEYED_SCORE_DESC else key > ak
        keep &= past | ((key == ak) & (idx > ad))
    neg = mode != kern.KEYED_SCORE_DESC
    mk = np.where(keep, key, np.float32(np.inf if neg else -np.inf))
    seen = np.where(neg & ~np.isnan(mk), -mk, mk).astype(np.float32)
    comp = (_order(seen) << np.uint64(32)) | (~idx.astype(np.uint64)
                                             & np.uint64(0xFFFFFFFF))
    return comp, keep, mk.astype(np.float32)


def _kth(values: np.ndarray, k: int) -> np.uint64:
    return np.sort(values)[::-1][k - 1]


def _select_block(comp, lo, hi, kp, p, stats):
    """One block: its sampled threshold, rounds, cuts, top kp (0-padded)."""
    length = hi - lo
    t = np.uint64(0)
    if length >= 2 * p["sample"] and kp <= p["sample"]:
        runs = p["sample"] // 32
        gap = (length - 32) // (runs - 1)
        at = lo + (np.arange(runs)[:, None] * gap + np.arange(32)[None, :])
        t = _kth(comp[at.ravel()], kp)
    buf = np.zeros(0, dtype=np.uint64)
    # Round 0 holds the head (entries before both planes align), the first
    # round of 4-entry groups and the tail (< 4 entries past the groups).
    head = min(p.get("head", 0), length)
    tail = hi - (length - head) % 4
    bounds = list(range(lo + head, tail, p["round"])) + [tail]
    for r in range(max(1, len(bounds) - 1)):
        part = comp[bounds[r] : bounds[r + 1]] if len(bounds) > 1 else comp[:0]
        if r == 0:
            part = np.concatenate([comp[lo : lo + head], part, comp[tail:hi]])
        buf = np.concatenate([buf, part[part >= t]])
        if buf.shape[0] > p["round"]:
            stats["cuts"] += 1
            t = _kth(buf, kp)
            buf = buf[buf >= t]
    if buf.shape[0] > kp:
        buf = buf[buf >= _kth(buf, kp)]
    out = np.zeros(kp, dtype=np.uint64)
    out[: buf.shape[0]] = buf
    return out


def _above_select(comp, kp):
    """Past the select's k (kp > 256), at the kernel's constants: the
    short-row sort or the large-k select's schedule, as
    test_torch_k3_large_select.py models them."""
    from test_torch_k3_large_select import KERNEL, top_rows

    tops, _stats = top_rows([comp], kp, comp.shape[0], KERNEL)
    return tops[0]


def k3k_schedule(key, eligible, k, mode, desc=False, missing_first=False,
                 after_key=None, after_doc=None, params=None):
    """keyed_topk_batch's card schedule on numpy: (values, ids, total,
    n_after) and the number of buffer cuts."""
    p = {"round": KS_ROUND, "sample": KS_SAMPLE, "cap": KS_CAP, "sms": 132,
         **(params or {})}
    q, m = eligible.shape
    kp = min(k, m)
    stats = {"cuts": 0, "blocks": 0}
    values, ids, totals, afters = [], [], [], []
    if kp <= kern.KEYED_SELECT_MAX_K:
        rounds = -(-m // p["round"])
        surv_row = max(1, min(rounds, p["cap"] // kp)) * kp  # the wrapper's
        nb = max(min(rounds, surv_row // kp, 2 * p["sms"] // q), 1)
        stripe = -(-(-(-m // nb)) // 4) * 4
        nb = -(-m // stripe)
        stats["blocks"] = nb
    for r in range(q):
        raw = (key if key.ndim == 1 else key[r]).astype(np.float32)
        ak = None if after_key is None else np.float32(after_key[r])
        ad = None if after_doc is None else int(after_doc[r])
        comp, keep, mk = _keyed(raw, eligible[r], mode, desc, missing_first,
                                ak, ad)
        if kp > kern.KEYED_SELECT_MAX_K:
            top = _above_select(comp, kp)
        else:
            surv = [_select_block(comp, b * stripe, min(m, (b + 1) * stripe),
                                  kp, p, stats) for b in range(nb)]
            floor = max(s.min() for s in surv)
            gathered = np.concatenate([s[s >= floor] for s in surv])
            top = np.sort(gathered)[::-1][:kp]
        idx = (~top & np.uint64(0xFFFFFFFF)).astype(np.int64)
        if mode == kern.KEYED_FIELD:
            val = raw[idx]
        else:
            val = mk[idx]
            if mode == kern.KEYED_SCORE_ASC:
                flip = np.isnan(val)
                val = np.where(flip, (val.view(np.uint32) ^ np.uint32(0x80000000))
                               .view(np.float32), val)
        values.append(val.astype(np.float32))
        ids.append(idx.astype(np.int32))
        totals.append(int(eligible[r].sum()))
        afters.append(int(keep.sum()))
    out = (np.stack(values), np.stack(ids), np.array(totals, np.int32),
           np.array(afters, np.int32))
    return out, stats


def _k3k_inputs(name, rng, m):
    """(key [M] or [Q, M], eligible [Q, M], k, mode, desc, mf, cursor)."""
    elig = rng.random((1, m)) < 0.4
    rand = rng.random(m).astype(np.float32)
    rand[::17] = np.nan
    asc = (np.arange(m, dtype=np.float32) * 3.0 + 1000.0).astype(np.float32)
    cur = (None, None)
    if name == "random, desc":
        return rand, elig, 10, kern.KEYED_FIELD, True, False, cur
    if name == "ascending, desc":
        return asc, elig, 10, kern.KEYED_FIELD, True, False, cur
    if name == "ascending, asc":
        return asc, elig, 25, kern.KEYED_FIELD, False, False, cur
    if name == "descending, desc":
        return asc[::-1].copy(), elig, 10, kern.KEYED_FIELD, True, False, cur
    if name == "all equal":
        return np.full(m, 3.0, np.float32), elig, 40, kern.KEYED_FIELD, True, False, cur
    if name == "mostly missing, missing last":
        miss = np.full(m, np.nan, np.float32)
        miss[::997] = rand[::997]
        return miss, elig, 10, kern.KEYED_FIELD, True, False, cur
    if name == "mostly missing, missing first":
        miss = np.full(m, np.nan, np.float32)
        miss[::997] = rand[::997]
        return miss, elig, 10, kern.KEYED_FIELD, False, True, cur
    nan = rng.normal(size=(3, m)).astype(np.float32)
    nan[:, ::5] = np.nan
    nan[:, 1::7] = -np.nan
    nan[:, 2::11] = 0.0
    nan[:, 3::13] = -0.0
    e3 = rng.random((3, m)) < 0.5
    if name == "+-NaN scores, bottom-k":
        return nan, e3, 30, kern.KEYED_SCORE_ASC, False, False, cur
    if name == "+-NaN scores, desc cursor":
        return nan, e3, 30, kern.KEYED_SCORE_DESC, False, False, (
            np.array([0.5, 0.0, -1.0], np.float32),
            np.array([5, m // 2, m - 1], np.int32))
    if name == "+-NaN field, missing first":
        return nan, e3, 30, kern.KEYED_FIELD, True, True, cur
    if name == "k above the eligible count":
        few = np.zeros((3, m), dtype=bool)
        few[0, 7] = True
        few[1, ::9000] = True
        return nan, few, 40, kern.KEYED_FIELD, False, False, cur
    if name == "score asc cursor":
        sc = (rng.random((1, m)) * 10).astype(np.float32)
        return sc, elig, 10, kern.KEYED_SCORE_ASC, False, False, (
            np.array([5.0], np.float32), np.array([1234], np.int32))
    if name == "cursor keeps almost nothing":
        sc = (rng.random((1, m)) * 10).astype(np.float32)
        return sc, elig, 10, kern.KEYED_SCORE_ASC, False, False, (
            np.array([9.9999], np.float32), np.array([3], np.int32))
    if name == "Q = 5, shared key":
        return rand, rng.random((5, m)) < 0.3, 10, kern.KEYED_FIELD, True, False, cur
    if name == "Q = 4, per-row keys and cursors":
        sc = (rng.random((4, m)) * 4).astype(np.float32)
        return sc, rng.random((4, m)) < 0.6, 12, kern.KEYED_SCORE_DESC, False, False, (
            np.array([3.0, 2.0, 1.0, 4.5], np.float32),
            np.array([10, 20, 30, 40], np.int32))
    if name == "k = 256, at the bound":
        return asc, elig, 256, kern.KEYED_FIELD, True, False, cur
    if name == "k = 257, the chunk sorts":  # (the case's old name): the large-k select
        return rand, elig, 257, kern.KEYED_FIELD, True, False, cur
    raise KeyError(name)


K3K_CASES = [
    "random, desc", "ascending, desc", "ascending, asc", "descending, desc",
    "all equal", "mostly missing, missing last", "mostly missing, missing first",
    "+-NaN scores, bottom-k", "+-NaN scores, desc cursor",
    "+-NaN field, missing first", "k above the eligible count",
    "score asc cursor", "cursor keeps almost nothing", "Q = 5, shared key",
    "Q = 4, per-row keys and cursors", "k = 256, at the bound",
    "k = 257, the chunk sorts",
]
# The kernel's constants on a small card (a few blocks a row, sampled
# stripes); and small constants, which force many blocks and cuts.
K3K_PARAMS = {
    "kernel": {"sms": 2},
    "small": {"round": 256, "sample": 128, "cap": 2 * 256 + 8, "sms": 8,
              "head": 3},
}


def _same(got, want):
    for g, w in zip(got, want):
        w = w.numpy()
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        if not np.array_equal(g, w):
            return False
    return True


@pytest.mark.parametrize("params", sorted(K3K_PARAMS))
@pytest.mark.parametrize("name", K3K_CASES)
def test_k3k_schedule_equals_keyed_topk_plain(name, params):
    rng = np.random.default_rng(K3K_CASES.index(name) + 7)
    m = 30_011
    key, elig, k, mode, desc, mf, (ak, ad) = _k3k_inputs(name, rng, m)
    got, stats = k3k_schedule(key, elig, k, mode, desc, mf, ak, ad,
                              K3K_PARAMS[params])
    want = kern.keyed_topk_batch_plain(
        torch.from_numpy(key), torch.from_numpy(elig), k, mode, desc, mf,
        None if ak is None else torch.from_numpy(ak),
        None if ad is None else torch.from_numpy(ad))
    assert _same(got, want)
    if k <= kern.KEYED_SELECT_MAX_K and params == "small":
        assert stats["blocks"] > 1


def test_k3k_small_constants_cut_the_buffer():
    """A monotone column under the small constants overflows rounds, so
    the model exercises the cut to the top k (and still equals plain)."""
    rng = np.random.default_rng(3)
    m = 30_011
    key, elig, _k, mode, desc, mf, _cur = _k3k_inputs("ascending, desc", rng, m)
    elig[:] = True
    got, stats = k3k_schedule(key, elig, 200, mode, desc, mf,
                              params={"round": 256, "sample": 64,
                                      "cap": 520, "sms": 1})
    want = kern.keyed_topk_batch_plain(torch.from_numpy(key),
                                       torch.from_numpy(elig), 200, mode,
                                       desc, mf)
    assert stats["cuts"] > 0
    assert _same(got, want)


def test_k3k_switch_is_named_in_the_wrapper():
    """The switch between the select and the designs past it sits at
    KEYED_SELECT_MAX_K, and the wrapper's docstring names it."""
    assert kern.KEYED_SELECT_MAX_K == 256
    assert "KEYED_SELECT_MAX_K" in kern.keyed_topk_batch.__doc__
