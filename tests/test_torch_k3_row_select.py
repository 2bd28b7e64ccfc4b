"""CPU models of K3's row mode on the threshold select and of K1's
matched-only kernel, held bit for bit to their unchanged plain versions
and to the JAX package.

Both run only on the card (csrc/masked_topk.cu, csrc/terms_scatter.cu),
so these tests model their schedules in numpy, step for step, and hold
each model to the plain version the card's checks use:

- K3's row mode (K3, K3b, K3s without ids), min(k, M) <= ROW_SELECT_MAX_K:
  `ks_select_kernel` with the raw key as its composite source. The
  composite is the key's IEEE total-order bits above the inverted
  position, with no mask (an ineligible entry keeps whatever key it
  holds); the block count and stripes of `ks_launch`; each block's sampled
  threshold, rounds (the head before the eligible row's 4-byte alignment,
  4-entry groups, the tail), cuts and top k; the row's last block merging
  the blocks' survivors above the largest block floor; the decode reading
  the key back; total counted over the eligible bytes of every stripe.
  Above ROW_SELECT_MAX_K, the short-row sort or the large-k select
  (modelled in test_torch_k3_large_select.py). Cases: ties, +/-0.0, NaN of
  both signs, -inf padding with finite keys at ineligible entries, fewer
  eligible entries than k, k = 0, k = M, k = 256 and k = 257, M not a
  multiple of 4, stacked Q x S rows and more rows than 2 x 132 (one block
  a row). Held to `masked_topk_batch_plain` (and `masked_topk_stacked`'s
  CPU path) and to `jax.lax.top_k` plus the eligible count as the JAX
  package's `_execute_inner` composes them, vmapped over the rows.
- K1's matched-only mode (`terms_matched_kernel`): a warp an entry, the
  tile skipped when it holds no posting of [start, end), each lane's
  16-byte loads of four consecutive doc ids, the bytes of those inside
  [start, end) set in a cleared plane. Cases: entries that start or end
  mid-tile, padding entries, several rows, stacked shards. Held to
  `terms_scatter_batch_plain(matched_only=True)` and to the JAX
  package's `_terms_matched`.

The wrappers' card path is checked with the library call recorded in
place of the launch: one host call each, K1's never touching `groups`.

Exact: every model output equals the plain version's and the
reference's bits. One CPU core, a few JAX shapes (each compiled once).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu_torch.ops import kernels as K
from test_torch_kernel_schedules import KS_CAP, KS_ROUND, KS_SAMPLE, _above_select, _order, _select_block

torch.set_num_threads(1)

TILE = 256
M = 30_011  # not a multiple of 4: every row starts at another alignment


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K3's row mode
# ---------------------------------------------------------------------------


def row_select_schedule(key, eligible, k, params=None):
    """masked_topk_batch's card schedule on numpy: (top_scores, top_idx,
    total) and the select's block count and cuts."""
    p = {"round": KS_ROUND, "sample": KS_SAMPLE, "cap": KS_CAP, "sms": 132,
         **(params or {})}
    q, m = key.shape
    kp = min(k, m)
    stats = {"cuts": 0, "blocks": 0}
    select = 1 <= kp <= K.ROW_SELECT_MAX_K
    if select:
        rounds = -(-m // p["round"])
        surv_row = max(1, min(rounds, p["cap"] // kp)) * kp  # the wrapper's
        nb = max(min(rounds, surv_row // kp, 2 * p["sms"] // q), 1)
        stripe = -(-(-(-m // nb)) // 4) * 4
        nb = -(-m // stripe)
        stats["blocks"] = nb
    tops, ids, totals = [], [], []
    for r in range(q):
        raw = key[r].astype(np.float32)
        idx = np.arange(m, dtype=np.uint64)
        comp = (_order(raw) << np.uint64(32)) | (~idx & np.uint64(0xFFFFFFFF))
        total = 0
        if not select:
            top = _above_select(comp, kp) if kp else comp[:0]
            total = int(eligible[r].sum())
        else:
            surv = []
            for b in range(nb):
                lo, hi = b * stripe, min(m, (b + 1) * stripe)
                # The eligible row starts 4-byte aligned at row 0; the
                # head runs to the stripe's next aligned entry.
                head = (-(r * m + lo)) % 4
                surv.append(_select_block(comp, lo, hi, kp,
                                          {**p, "head": head}, stats))
                total += int(eligible[r, lo:hi].sum())
            floor = max(s.min() for s in surv)
            gathered = np.concatenate([s[s >= floor] for s in surv])
            top = np.sort(gathered)[::-1][:kp]
        pos = (~top & np.uint64(0xFFFFFFFF)).astype(np.int64)
        tops.append(raw[pos])
        ids.append(pos.astype(np.int32))
        totals.append(total)
    out = (np.stack(tops).reshape(q, kp), np.stack(ids).reshape(q, kp),
           np.array(totals, np.int32))
    return out, stats


def _row_keys(name, rng, q, m):
    """(key f32[q, m], eligible bool[q, m]) of a named case."""
    key = rng.normal(size=(q, m)).astype(np.float32)
    elig = rng.random((q, m)) < 0.35
    if name == "ties":
        key = np.round(key * 2).astype(np.float32)
        key[:, m // 2:] = key[:, : m - m // 2]
    elif name == "signed zeros and NaN":
        key[:, ::5] = np.nan
        key[:, 1::7] = -np.nan
        key[:, 2::11] = 0.0
        key[:, 3::13] = -0.0
        key[:, 4::17] = np.inf
        key[:, 6::19] = -np.inf
        odd = key[:, 8::23].view(np.uint32)  # NaN payloads of both signs
        key[:, 8::23] = (odd | np.uint32(0x7F800001)).view(np.float32)
        key[:, 9::29] = np.float32(-np.nan) * 1.0
    elif name == "-inf padding, finite ineligible keys":
        key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
        key[:, 3::97] = 50.0  # breaks the row-mode contract: ranked anyway
    elif name == "fewer eligible than k":
        elig[:] = False
        elig[0, [3, 17]] = True
        elig[1, -1] = True
        key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
        key[1, 40:50] = -np.nan  # below -inf
        key[2, 5] = -np.nan
    elif name == "ascending":
        key = np.tile(np.arange(m, dtype=np.float32) * 0.5, (q, 1))
        elig[:] = True
    return key, elig


# (q, m, k, case); q = 6 is the stacked case's Q x S = 2 x 3 rows.
ROW_CASES = {
    "ties": (3, M, 10),
    "signed zeros and NaN": (3, M, 10),
    "-inf padding, finite ineligible keys": (3, M, 10),
    "fewer eligible than k": (3, M, 10),
    "ascending": (3, M, 10),
    "k = 0": (3, M, 0),
    "k = 256": (3, M, 256),
    "k = 257, the chunk sorts": (3, M, 257),  # (its old name): large-k select
    "k = M": (2, 1_003, 1_003),
    "stacked, Q x S = 2 x 3": (6, M, 10),
    "more rows than 2 x 132": (300, 513, 10),
}
# Two constant sets: the kernel's on a 2-multiprocessor card (one block a
# row, sampled stripes) and small ones that force many blocks and cuts.
ROW_PARAMS = {
    "kernel": {"sms": 2},
    "small": {"round": 256, "sample": 128, "cap": 2 * 256 + 8, "sms": 8},
}


def _case_inputs(name):
    q, m, k = ROW_CASES[name]
    rng = np.random.default_rng(sorted(ROW_CASES).index(name) + 11)
    kind = {"k = 0": "ties", "k = 256": "signed zeros and NaN",
            "k = 257, the chunk sorts": "signed zeros and NaN",
            "k = M": "signed zeros and NaN",
            "stacked, Q x S = 2 x 3": "-inf padding, finite ineligible keys",
            "more rows than 2 x 132": "signed zeros and NaN"}.get(name, name)
    key, elig = _row_keys(kind, rng, q, m)
    return key, elig, k


@jax.jit
def _jax_row_stats(eligible):
    return jax.vmap(lambda e: jnp.sum(e, dtype=jnp.int32))(eligible)


_JAX_TOPK = {}


def _jax_rows(key, eligible, k):
    """jax.lax.top_k + the eligible count, as `_execute_inner` :741-742
    composes them, vmapped over the rows; one jitted function a k."""
    if k not in _JAX_TOPK:
        _JAX_TOPK[k] = jax.jit(jax.vmap(lambda x: jax.lax.top_k(x, k)))
    top, idx = _JAX_TOPK[k](jnp.asarray(key))
    return np.asarray(top), np.asarray(idx).astype(np.int32), np.asarray(
        _jax_row_stats(jnp.asarray(eligible)))


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
    """Each case's plain and JAX answers, computed once for both
    constant sets."""
    cache = {}

    def get(name):
        if name not in cache:
            key, elig, k = _case_inputs(name)
            q = key.shape[0]
            if name.startswith("stacked"):
                plain = K.masked_topk_stacked(_t(key), _t(elig), k, 3)
            else:
                plain = K.masked_topk_batch(_t(key), _t(elig), k)
            plain = tuple(t.numpy() for t in plain)
            kp = min(k, key.shape[1])
            jax_out = _jax_rows(key, elig, kp)
            assert plain[0].shape == (q, kp)
            cache[name] = (key, elig, k, plain, jax_out)
        return cache[name]

    return get


@pytest.mark.parametrize("params", sorted(ROW_PARAMS))
@pytest.mark.parametrize("name", list(ROW_CASES))
def test_row_select_schedule_equals_plain_and_lax_top_k(name, params, reference):
    key, elig, k, plain, jax_out = reference(name)
    got, stats = row_select_schedule(key, elig, k, ROW_PARAMS[params])
    assert _same(got, plain)
    assert _same(got, jax_out)
    if 1 <= min(k, key.shape[1]) <= K.ROW_SELECT_MAX_K and params == "small" \
            and key.shape[1] > 2048:
        assert stats["blocks"] > 1


def test_row_select_many_rows_take_one_block_a_row():
    """Past 2 x 132 rows the grid is one block a row: 2 * sms // q is 0,
    and the block count is held at 1 (grid rows up to 65,535)."""
    key, elig, k = _case_inputs("more rows than 2 x 132")
    _got, stats = row_select_schedule(key, elig, k)
    assert stats["blocks"] == 1
    _got, stats = row_select_schedule(key[:6], elig[:6], k)
    assert stats["blocks"] == 1  # 513 entries: one round's worth


def test_row_select_small_constants_cut_the_buffer():
    """An ascending row under the small constants overflows rounds, so the
    model exercises the cut to the top k (and still equals plain)."""
    key = np.tile(np.arange(M, dtype=np.float32), (1, 1))
    elig = np.ones_like(key, dtype=bool)
    got, stats = row_select_schedule(key, elig, 200, {
        "round": 256, "sample": 64, "cap": 520, "sms": 1})
    assert stats["cuts"] > 0
    want = K.masked_topk_batch_plain(_t(key), _t(elig), 200)
    assert _same(got, tuple(t.numpy() for t in want))


def test_row_select_switch_is_named_alike_in_the_wrapper_and_the_source():
    """The row mode's switch between the select and the designs past it
    sits at ROW_SELECT_MAX_K in the wrapper and KS_MAX_K in the source,
    and every mode's dispatch (`topk_run`) takes the select on it."""
    src = (K.CSRC_DIR / "masked_topk.cu").read_text()
    assert int(re.search(r"#define KS_MAX_K (\d+)", src).group(1)) == \
        K.ROW_SELECT_MAX_K == K.KEYED_SELECT_MAX_K == 256
    assert "c.kp >= 1 && c.kp <= KS_MAX_K" in src
    assert "ROW_SELECT_MAX_K" in K.masked_topk_batch.__doc__


class _Lib:
    """Stands in for the kernel library: records each entry point call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("esk_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' card path on CPU tensors, the library call recorded
    where the launch would be."""
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


@pytest.mark.parametrize("k, select", [(10, True), (256, True), (257, False), (0, False)])
def test_row_mode_wrapper_makes_one_host_call(recorded, k, select):
    lib, launches = recorded
    key, elig = _row_keys("ties", np.random.default_rng(1), 3, 2_000)
    top, idx, total = K.masked_topk_batch(_t(key), _t(elig), k)
    assert launches == ["masked_topk"]
    ((name, args),) = lib.calls
    assert name == "esk_masked_topk"
    ptr = dict(zip(["key", "ids", "eligible", "q", "m", "k", "counts",
                    "scratch", "scratch_row", "scores", "idx"], args))
    assert ptr["ids"] is None and (ptr["q"], ptr["m"], ptr["k"]) == (3, 2_000, k)
    # The select's scratch holds each row's block survivors; the short-row
    # sort (k = 257 or 0 on these 2,000-entry rows) needs none.
    assert (ptr["scratch_row"] > 0) == select
    assert K.TOPK_ROUTES["masked_topk_batch:" + ("select" if select else "short")] == 1
    # Outputs, then total and the tickets (one memset), then the scratch,
    # all in one tensor.
    if k:  # an empty view's data_ptr is 0
        assert ptr["scores"] == top.data_ptr() and ptr["idx"] == idx.data_ptr()
    assert ptr["counts"] == total.data_ptr()
    assert ptr["scratch"] == ptr["counts"] + 4 * 4 * 3
    assert top.shape == idx.shape == (3, k) and total.shape == (3,)
    assert K.LAUNCHES["masked_topk_batch"] == 1


class _Untouchable:
    """A `groups` argument that fails on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"groups touched: {name}")

    def __getitem__(self, i):
        raise AssertionError("groups indexed")

    def __array__(self, *a, **kw):
        raise AssertionError("groups converted")


# ---------------------------------------------------------------------------
# K1's matched-only mode
# ---------------------------------------------------------------------------


def _postings(seed, n_docs=3_000, n_terms=5):
    """A tiled postings plane and each term's [start, end): CSR order,
    padded with the sentinel n_docs to whole tiles plus one."""
    rng = np.random.default_rng(seed)
    offsets, docs = [0], []
    for _ in range(n_terms):
        df = int(rng.integers(1, n_docs // 2))
        d = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.int32)
        docs.append(d)
        offsets.append(offsets[-1] + df)
    flat = np.concatenate(docs)
    p_pad = (-(-len(flat) // TILE) + 1) * TILE
    tiles = np.full(p_pad, n_docs, np.int32)
    tiles[: len(flat)] = flat
    return tiles.reshape(-1, TILE), offsets


def _worklists(offsets_of, terms_of_row, nt):
    """[Q, nt] worklists: each row's terms' tiles, then padding entries."""
    q = len(terms_of_row)
    tid = np.zeros((q, nt), np.int32)
    st = np.zeros((q, nt), np.int32)
    en = np.zeros((q, nt), np.int32)
    for r, terms in enumerate(terms_of_row):
        i = 0
        for t in terms:
            offs = offsets_of(r)
            s, e = offs[t], offs[t + 1]
            for tile in range(s // TILE, (e - 1) // TILE + 1):
                tid[r, i], st[r, i], en[r, i] = tile, s, e
                i += 1
        tid[r, i:] = 0  # padding: tile 0, an empty span
    return tid, st, en


def k1_matched_schedule(doc_tiles, tile_ids, starts, ends, num_docs):
    """esk_terms_matched on numpy: the plane cleared, then per (row,
    entry) warp the tile test and each lane's two 16-byte loads of four
    ids. Returns (matched bool[Q, num_docs + 1], stats)."""
    tiles = doc_tiles if doc_tiles.ndim == 3 else doc_tiles[None]
    q, nt = tile_ids.shape
    out = np.zeros((q, num_docs + 1), bool)
    stats = {"skipped": 0, "loads": 0, "partial": 0}
    lane = np.arange(32)
    for r in range(q):
        flat = tiles[r % tiles.shape[0]].reshape(-1)
        for e in range(nt):
            t, s, en = int(tile_ids[r, e]), int(starts[r, e]), int(ends[r, e])
            base = t * TILE
            if s >= en or base >= en or base + TILE <= s:
                stats["skipped"] += 1
                continue
            for h in range(2):
                pos = base + h * (TILE // 2) + lane * 4  # each lane's group
                load = ~((pos + 4 <= s) | (pos >= en))
                assert np.all(pos % 4 == 0)  # 16-byte aligned loads
                stats["loads"] += int(load.sum())
                ids = flat[pos[load][:, None] + np.arange(4)]  # [lanes, 4]
                p4 = pos[load][:, None] + np.arange(4)
                inside = (p4 >= s) & (p4 < en)
                stats["partial"] += int((~inside).any(axis=1).sum())
                out[r, ids[inside]] = True
    return out, stats


def _jax_terms_matched(tiles, tid, st, en, num_docs):
    """The JAX package's `_terms_matched` on one row's worklist."""
    vals = jnp.zeros(tiles.shape, jnp.float32)  # read, unused
    seg = {"fields": {"body": (jnp.asarray(tiles), vals, vals, None, None)}}
    arrays = {"tile_ids": jnp.asarray(tid), "starts": jnp.asarray(st),
              "ends": jnp.asarray(en)}
    return np.asarray(jbd._terms_matched(("terms_const", "body", 0), arrays,
                                         seg, num_docs))


K1_CASES = {
    "one row": (1, [[0, 2, 2]]),
    "three rows": (1, [[1], [0, 3, 4], [2]]),
    "stacked, Q x S = 2 x 3": (3, [[0], [1, 2], [4], [3], [2], [0, 1]]),
}


@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_matched_schedule_equals_plain_and_terms_matched(name):
    n_shards, terms_of_row = K1_CASES[name]
    n_docs = 3_000
    planes = [_postings(40 + s, n_docs) for s in range(n_shards)]
    nt_max = max(p[0].shape[0] for p in planes)
    tiles = np.stack([np.concatenate([p[0], np.full((nt_max - p[0].shape[0], TILE),
                                                    n_docs, np.int32)])
                      for p in planes])
    nt = max(sum(-(-(planes[r % n_shards][1][t + 1]) // TILE)
                 - planes[r % n_shards][1][t] // TILE for t in terms)
             for r, terms in enumerate(terms_of_row)) + 2
    tid, st, en = _worklists(lambda r: planes[r % n_shards][1], terms_of_row, nt)
    stacked = name.startswith("stacked")
    dt = tiles if stacked else tiles[0]
    got, stats = k1_matched_schedule(dt, tid, st, en, n_docs)
    args = (_t(dt), torch.zeros(dt.shape), torch.zeros(
        (n_shards, n_docs + 1) if stacked else (n_docs + 1,), dtype=torch.uint8),
        _t(tid), _t(st), _t(en), None, n_docs,
        K.batch_groups(tid, st, en))
    _none, plain = K.terms_scatter_batch_plain(*args, matched_only=True)
    wrapper = K.terms_scatter_stacked if stacked else K.terms_scatter_batch
    none, via = wrapper(*args, matched_only=True)
    assert none is None and torch.equal(via, plain)
    assert np.array_equal(got, plain.numpy())
    for r in range(tid.shape[0]):
        want = _jax_terms_matched(tiles[r % n_shards], tid[r], st[r], en[r], n_docs)
        assert np.array_equal(got[r, :n_docs], want)
    # Terms start and end mid-tile (partial groups), padding entries skip.
    assert stats["partial"] > 0 and stats["skipped"] >= 2 * tid.shape[0]


@pytest.mark.parametrize("stacked", [False, True])
def test_k1_matched_only_wrapper_is_one_host_call(recorded, stacked):
    """terms_scatter_batch / _stacked(matched_only=True) on the card path:
    one call of esk_terms_matched, groups never touched, (None, matched)
    with the plane's shape, one matched-only launch counted."""
    lib, launches = recorded
    tiles, offsets = _postings(3)
    q = 2
    tid, st, en = _worklists(lambda r: offsets, [[0], [1, 2]], 40)
    dt = np.stack([tiles, tiles]) if stacked else tiles
    fn = K.terms_scatter_stacked if stacked else K.terms_scatter_batch
    none, matched = fn(_t(dt), _t(dt).float(), _t(np.zeros(10, np.uint8)),
                       _t(tid), _t(st), _t(en), None, 3_000, _Untouchable(),
                       matched_only=True)
    assert none is None and matched.shape == (q, 3_001)
    assert matched.dtype == torch.bool
    assert launches == ["terms_scatter"]
    ((name, args),) = lib.calls
    assert name == "esk_terms_matched"
    assert args[4:7] == (q, 40, 3_001) and args[7] == matched.data_ptr()
    assert args[8:] == ((2, tiles.size) if stacked else (1, tiles.size))
    key = "terms_scatter_stacked" if stacked else "terms_scatter_batch"
    assert K.LAUNCHES[key] == K.MATCHED_ONLY_LAUNCHES[key] == 1
