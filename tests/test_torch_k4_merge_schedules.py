"""CPU models of K4's redesigned search, K4's fold mode and K3's merge
mode, held bit for bit to their unchanged plain versions and to the JAX
package.

The three run only on the card (csrc/span_locate.cu, csrc/masked_topk.cu),
so these tests model their schedules in numpy, step for step, and hold
each model to the plain version the card's checks use:

- K4 (`span_locate_kernel`, `span_fold_kernel`): one thread a candidate
  runs the reference's step map of (lo, hi) and leaves at the first step
  that changes neither bound, within the reference's fixed step count.
  Cases: candidates below, inside, between and above the span, the
  num_docs sentinel clamped, empty spans, a span ending at the plane's
  last slot, planes of 2^k - 1, 2^k and 2^k + 1 slots, Q = 3 rows and
  S = 3 stacked shards. The model also counts the probes a thread makes:
  at most bit_length(span) + 2, against the reference's
  bit_length(plane).
- K4's fold mode: per candidate, each must term's search, found &
  in_range, contrib = w - w / (1 + tn) and score + (found ? contrib : 0)
  from +0.0, each op rounded in fp32; held to `span_fold_batch_plain`,
  to the per-term loop `_sparse_lead_inner` ran before the mode, and to
  the JAX package's loop; `execute_auto` / `execute_batch_sparse` /
  `execute_shards_batch` over filter-led conjunctions against the JAX
  package's.
- K3's merge mode (`topk_merge_kernel`): P = 32 W E composites in E
  registers of 32 W threads, entry e * 32 W + t in register e of thread
  t, the bitonic network over element g = t * E + e, the first min(k, M)
  ranks decoded; held to `masked_topk_merge_plain` and to jax.lax.top_k
  plus the take of the ids, M from 1 to MERGE_MAX_M and the route past it.

Exact: every output equals the plain version's and the reference's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine
from elasticsearch_tpu.index.mapping import Mappings
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.dsl import parse_query
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.ops import kernels as K
from elasticsearch_tpu_torch.parallel import sharded
from test_torch_stacked import _compile_both, _terms_by_df, shards  # noqa: F401

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

N_DOCS = 5000


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# K4: the search that leaves at its fixed point
# ---------------------------------------------------------------------------


def _plane(length: int, seed: int):
    """A flat postings plane of `length` slots: sorted runs (spans) of doc
    ids < N_DOCS, the last run ending at the plane's last slot and holding
    the last doc (N_DOCS - 1). Returns (plane i32[length], span offsets)."""
    rng = np.random.default_rng(seed)
    flat = np.empty(length, np.int32)
    offs = [0]
    while offs[-1] < length:
        n = int(min(length - offs[-1], rng.integers(1, 300)))
        docs = np.sort(rng.choice(N_DOCS - 1, n, replace=False))
        flat[offs[-1]:offs[-1] + n] = docs
        offs.append(offs[-1] + n)
    flat[-1] = N_DOCS - 1
    flat[offs[-2]:] = np.sort(flat[offs[-2]:])
    return flat, np.asarray(offs)


def _spans(offs, rng, n: int):
    """n spans of a plane: random runs, an empty span, a span ending at
    the plane's last slot and one starting at slot 0."""
    starts, ends = [], []
    for _ in range(n - 3):
        a = int(rng.integers(0, len(offs) - 1))
        starts.append(offs[a])
        ends.append(offs[a + 1])
    mid = int(offs[len(offs) // 2])
    starts += [mid, offs[-2], 0]
    ends += [mid, offs[-1], offs[1]]
    return np.asarray(starts, np.int32), np.asarray(ends, np.int32)


def _cands(flat, starts, ends, rng, p: int):
    """Candidates (clamped in range, as `safe`) and in_range: members of
    the spans, docs between them, below and above them, and the num_docs
    sentinel, doc-ascending as the lead filter's postings are."""
    members = np.concatenate([flat[s:e] for s, e in zip(starts, ends)] + [flat[:1]])
    pool = np.concatenate([
        rng.choice(members, p // 2),
        members.min(initial=N_DOCS) - rng.integers(0, 3, 4),
        rng.integers(0, N_DOCS, p // 2),
        [N_DOCS - 1, N_DOCS, N_DOCS, 0],
    ])
    cand = np.sort(np.clip(pool, 0, N_DOCS))[:p].astype(np.int32)
    cand[-3:] = N_DOCS  # padding slots
    return np.minimum(cand, N_DOCS - 1).astype(np.int32), cand != N_DOCS


def _k4_model(flat, start: int, end: int, cands):
    """span_locate.cu's threads: the reference's map of (lo, hi) from
    (start, end), leaving at the first step that changes neither bound
    (at most search_steps(plane) steps). Returns (pos, lo < end and
    flat[pos] == c, probes a thread)."""
    limit = len(flat) - 1
    steps = K.search_steps(len(flat))
    pos, found, probes = [], [], []
    for c in cands:
        lo, hi, n = int(start), int(end), 0
        for _ in range(steps):
            mid = (lo + hi) >> 1
            n += 1
            go = flat[min(max(mid, 0), limit)] < c
            nlo, nhi = (mid + 1, hi) if go else (lo, mid)
            if (nlo, nhi) == (lo, hi):
                break
            lo, hi = nlo, nhi
        at = min(max(lo, 0), limit)
        pos.append(at)
        found.append(lo < end and flat[at] == c)
        probes.append(n)
    return (np.asarray(pos, np.int32), np.asarray(found, bool),
            np.asarray(probes))


def _jax_locate(flat, start, end, cands):
    pos, found = jbd._span_locate(jnp.asarray(flat), np.int32(start),
                                  np.int32(end), jnp.asarray(cands))
    return np.asarray(pos), np.asarray(found)


@pytest.mark.parametrize("length", [1023, 1024, 1025, 4097])
@pytest.mark.parametrize("n_shards", [0, 3])
def test_k4_fixed_point_exit_equals_plain_and_reference(length, n_shards):
    rng = np.random.default_rng(length + n_shards)
    planes = [_plane(length, 7 * s + length) for s in range(max(1, n_shards))]
    rows = 3 if not n_shards else 2 * n_shards
    n_spans = 6
    starts = np.zeros((rows, n_spans), np.int32)
    ends = np.zeros((rows, n_spans), np.int32)
    cands = []
    for r in range(rows):
        flat, offs = planes[r % len(planes)]
        starts[r], ends[r] = _spans(offs, rng, n_spans)
        cands.append(_cands(flat, starts[r], ends[r], rng, 96)[0])
    cands = np.stack(cands)
    flat_all = np.stack([p[0] for p in planes]) if n_shards else planes[0][0]
    locate = K.span_locate_stacked if n_shards else K.span_locate_batch
    steps = K.search_steps(length)
    for j in range(n_spans):
        pos, found = locate(_t(flat_all), _t(starts), _t(ends), j, _t(cands))
        for r in range(rows):
            flat = planes[r % len(planes)][0]
            s, e = int(starts[r, j]), int(ends[r, j])
            m_pos, m_found, probes = _k4_model(flat, s, e, cands[r])
            j_pos, j_found = _jax_locate(flat, s, e, cands[r])
            assert np.array_equal(pos[r].numpy(), m_pos)
            assert np.array_equal(found[r].numpy(), m_found)
            assert np.array_equal(m_pos, j_pos)
            assert np.array_equal(m_found, j_found)
            assert probes.max() <= min(steps, max(0, e - s).bit_length() + 2)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}  # CPU: plain only


@pytest.mark.parametrize("seed", range(6))
def test_k4_model_on_random_spans_and_candidates(seed):
    """Random planes, spans (reversed and out-of-plane bounds among them)
    and candidates: the early exit never changes a bit, and a thread stops
    within bit_length(span) + 2 probes."""
    rng = np.random.default_rng(100 + seed)
    length = int(rng.integers(1, 3000))
    flat = np.sort(rng.integers(0, N_DOCS, length)).astype(np.int32)
    steps = K.search_steps(length)
    for _ in range(8):
        s, e = sorted(int(x) for x in rng.integers(0, length + 1, 2))
        if rng.random() < 0.2:
            s, e = e, s  # a reversed span: the fixed point still holds
        cands = rng.integers(-2, N_DOCS + 2, 64).astype(np.int32)
        m_pos, m_found, probes = _k4_model(flat, s, e, cands)
        p_pos, p_found = K.span_locate_plain(
            _t(flat), _t(np.asarray([s], np.int32)), _t(np.asarray([e], np.int32)),
            0, _t(cands))
        j_pos, j_found = _jax_locate(flat, s, e, cands)
        assert np.array_equal(p_pos.numpy(), m_pos)
        assert np.array_equal(p_found.numpy(), m_found)
        assert np.array_equal(j_pos, m_pos) and np.array_equal(j_found, m_found)
        assert probes.max() <= steps
        if s <= e:
            assert probes.max() <= (e - s).bit_length() + 2


# ---------------------------------------------------------------------------
# K4's fold mode
# ---------------------------------------------------------------------------


def _fold_inputs(n_terms: int, n_shards: int, seed: int):
    rng = np.random.default_rng(seed)
    length = 3000
    planes = [_plane(length, seed + 11 * s) for s in range(max(1, n_shards))]
    rows = 3 if not n_shards else 2 * n_shards
    starts = np.zeros((rows, n_terms), np.int32)
    ends = np.zeros((rows, n_terms), np.int32)
    weights = (rng.random((rows, n_terms)) * 3).astype(np.float32)
    safe, in_range = [], []
    for r in range(rows):
        flat, offs = planes[r % len(planes)]
        sp_s, sp_e = _spans(offs, rng, max(4, n_terms))
        pick = rng.permutation(len(sp_s))[:n_terms]
        starts[r], ends[r] = sp_s[pick], sp_e[pick]
        if n_terms > 1:  # a padded term: an empty span of weight 0
            starts[r, -1] = ends[r, -1] = 0
            weights[r, -1] = 0.0
        s_r, i_r = _cands(flat, starts[r], ends[r], rng, 128)
        safe.append(s_r)
        in_range.append(i_r)
    tn = [(rng.random(length) * 4).astype(np.float32) for _ in planes]
    tn[0][::97] = 0.0
    flat = np.stack([p[0] for p in planes]) if n_shards else planes[0][0]
    flat_tn = np.stack(tn) if n_shards else tn[0]
    return (flat, flat_tn, starts, ends, weights, np.stack(safe),
            np.stack(in_range))


def _lead_loop(flat, flat_tn, starts, ends, weights, safe, in_range, n_shards):
    """The must-term loop `_sparse_lead_inner` ran before the fold mode:
    one K4 launch a term, then the gather and elementwise ops."""
    seg = {"live": torch.zeros((n_shards, 1)) if n_shards else torch.zeros(1)}
    locate = K.span_locate_stacked if n_shards else K.span_locate_batch
    q, p = safe.shape
    score = torch.zeros((q, p), dtype=torch.float32)
    matched_any = torch.zeros((q, p), dtype=torch.bool)
    for j in range(starts.shape[1]):
        at, found = locate(flat, starts, ends, j, safe)
        found = found & in_range
        w = weights[:, j : j + 1]
        contrib = w - w / (1.0 + tbd._take(seg, flat_tn, at.to(torch.int64)))
        score = score + torch.where(found, contrib, 0.0)
        matched_any = matched_any | found
    return score, matched_any


def _fold_model(flat, flat_tn, starts, ends, weights, safe, in_range):
    """span_fold_kernel's threads in numpy fp32 scalars: each term's early-
    exit search, then score = score + (found ? w - w / (1 + tn) : +0.0)."""
    q, p = safe.shape
    score = np.zeros((q, p), np.float32)
    matched = np.zeros((q, p), bool)
    one = np.float32(1.0)
    for r in range(q):
        f = flat[r % flat.shape[0]] if flat.ndim == 2 else flat
        tn = flat_tn[r % flat.shape[0]] if flat.ndim == 2 else flat_tn
        for j in range(starts.shape[1]):
            pos, found, _n = _k4_model(f, int(starts[r, j]), int(ends[r, j]), safe[r])
            found &= in_range[r]
            w = weights[r, j]
            for i in range(p):
                add = np.float32(0.0)
                if found[i]:
                    add = np.float32(w - np.float32(w / np.float32(one + tn[pos[i]])))
                score[r, i] = np.float32(score[r, i] + add)
            matched[r] |= found
    return score, matched


def _jax_fold(flat, flat_tn, starts, ends, weights, safe, in_range):
    """The JAX package's must-term loop (bm25_device.py:906-919), row by
    row (the batch is its vmap), each row on its shard's planes."""
    scores, matched = [], []
    one = jnp.float32(1.0)
    for r in range(safe.shape[0]):
        f = flat[r % flat.shape[0]] if flat.ndim == 2 else flat
        tn = jnp.asarray(flat_tn[r % flat.shape[0]] if flat.ndim == 2 else flat_tn)
        score = jnp.zeros(safe.shape[1], dtype=jnp.float32)
        m = jnp.zeros(safe.shape[1], dtype=bool)
        for j in range(starts.shape[1]):
            pos, found = jbd._span_locate(jnp.asarray(f), starts[r, j], ends[r, j],
                                          jnp.asarray(safe[r]))
            found &= jnp.asarray(in_range[r])
            w = jnp.float32(weights[r, j])
            contrib = w - w / (one + tn[pos])
            score = score + jnp.where(found, contrib, jnp.float32(0.0))
            m |= found
        scores.append(np.asarray(score))
        matched.append(np.asarray(m))
    return np.stack(scores), np.stack(matched)


@pytest.mark.parametrize("n_terms", [1, 2, 4, 8])
@pytest.mark.parametrize("n_shards", [0, 3])
def test_fold_mode_equals_the_lead_loop_and_reference(n_terms, n_shards):
    args = _fold_inputs(n_terms, n_shards, seed=30 + n_terms)
    targs = [_t(a) for a in args]
    fold = K.span_fold_stacked if n_shards else K.span_fold_batch
    score, matched = fold(*targs)
    assert score.dtype == torch.float32 and matched.dtype == torch.bool
    p_score, p_matched = K.span_fold_batch_plain(*targs)
    l_score, l_matched = _lead_loop(*targs, n_shards)
    m_score, m_matched = _fold_model(*args)
    j_score, j_matched = _jax_fold(*args)
    for s, m in ((p_score.numpy(), p_matched.numpy()),
                 (l_score.numpy(), l_matched.numpy()),
                 (m_score, m_matched), (j_score, j_matched)):
        assert np.array_equal(_bits(score.numpy()), _bits(s))
        assert np.array_equal(matched.numpy(), m)
    in_range = args[-1]
    assert not matched.numpy()[~in_range].any()  # padding never matches
    assert (_bits(score.numpy())[~in_range] == 0).all()  # +0.0 there
    assert matched.numpy().any()


VOCAB = [f"w{i:02d}" for i in range(24)]


@pytest.fixture(scope="module")
def corpus():
    """A one-segment JAX engine (with deletes) and the port's tree over
    the very same planes."""
    rng = np.random.default_rng(23)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.05
    probs /= probs.sum()
    eng = Engine(Mappings(properties={"body": {"type": "text"},
                                      "tag": {"type": "keyword"}}))
    for i in range(700):
        eng.index({"body": " ".join(rng.choice(VOCAB, int(rng.integers(3, 14)), p=probs)),
                   "tag": "rare" if i % 37 == 0 else ("odd" if i % 2 else "even")},
                  f"d{i}")
    eng.refresh()
    for i in range(0, 700, 9):
        eng.delete(f"d{i}")
    eng.refresh()
    handle = eng.segments[0]
    tree = jbd.segment_tree(handle.device)
    planes = {
        "fields": {name: tuple(np.asarray(x) for x in leaves)
                   for name, leaves in tree["fields"].items()},
        "doc_values": {name: np.asarray(c) for name, c in tree["doc_values"].items()},
        "live": np.asarray(tree["live"]),
    }
    meta = {name: field_meta(f) for name, f in handle.device.fields.items()}
    ptree = tbd.segment_tree(device_segment_from_numpy(planes, meta, device="cpu"))
    return eng, handle, tree, ptree


def _lead_body(musts: list[str], extra: str):
    body = {"bool": {"must": [{"match": {"body": " ".join(musts)}}],
                     "filter": [{"term": {"tag": "rare"}}]}}
    if extra == "second_filter":
        body["bool"]["filter"].append({"term": {"body": musts[0]}})
    elif extra == "must_not":
        body["bool"]["must_not"] = [{"term": {"body": VOCAB[3]}}]
    return body


def _same_out(got, ref):
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, (g.shape, r.shape)
        if g.dtype == np.float32:
            g, r = g.view(np.int32), r.view(np.int32)
        assert np.array_equal(g, r.astype(g.dtype))


# Each case compiles the JAX package's programs anew; one case per must
# count (T pads to 1, 2, 4, 8) and each extra clause once keeps the file
# light beside the timing-sensitive suites of parallel workers.
@pytest.mark.parametrize("n_must, extra", [(1, "must_not"), (2, ""),
                                           (3, "second_filter"), (5, "")])
def test_execute_auto_filter_led_matches_jax(corpus, n_must, extra):
    eng, handle, tree, ptree = corpus
    rng = np.random.default_rng(n_must)
    bodies = [_lead_body([str(t) for t in rng.choice(VOCAB[:12], n_must, replace=False)],
                         extra) for _ in range(3)]
    comp = eng.compiler_for(handle)
    compiled = [comp.compile(parse_query(b)) for b in bodies]
    for c in compiled:
        assert c.spec[6] >= 0  # the rare tag leads
        plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
        _same_out([x.numpy() for x in tbd.execute_auto(ptree, c.spec, plan, 10)],
                  jbd.execute_auto(tree, c.spec, c.arrays, 10))
    same_spec = [c for c in compiled if c.spec == compiled[0].spec]
    arrays = tbd.stack_plans([c.arrays for c in same_spec])
    got = tbd.execute_batch_sparse(
        ptree, compiled[0].spec, tbd.plan_to_torch(compiled[0].spec, arrays, "cpu"), 10)
    ref = jbd.execute_batch_sparse(tree, compiled[0].spec, arrays, 10)
    _same_out([x.numpy() for x in got], ref)


@pytest.mark.parametrize("n_must", [2, 5])
def test_execute_shards_batch_filter_led_matches_jax(shards, n_must):
    """The stacked lead path (K4s's fold mode) over four uneven shards,
    each compiled with its own statistics, against the JAX package."""
    by_df = _terms_by_df(shards["psegs"][0])
    rng = np.random.default_rng(40 + n_must)
    bodies = [{"bool": {
        "must": [{"match": {"body": " ".join(rng.choice(by_df[:6], n_must, replace=False))}}],
        "filter": [{"term": {"body": str(rng.choice(by_df[-40:]))}}],
    }} for _ in range(3)]
    pspec, pplans, jspec, jplans = _compile_both(shards, bodies)
    assert pspec == jspec and pspec[6] >= 0
    ref = jbd.execute_shards_batch(shards["jtree"], jspec, tbd.stack_plans(jplans),
                                   10, shards["n_pad"])
    got = tbd.execute_shards_batch(
        shards["ptree"], pspec, tbd.plan_to_torch(pspec, tbd.stack_plans(pplans), "cpu"),
        10, shards["n_pad"])
    _same_out([x.numpy() for x in got], ref)


def test_lead_path_calls_the_fold_mode_once(corpus, monkeypatch):
    """The must terms take one fold-mode call, not one K4 call a term."""
    eng, handle, _tree, ptree = corpus
    calls = {"fold": 0, "locate": 0}
    fold, locate = K.span_fold_batch, K.span_locate_batch

    def spy_fold(*a):
        calls["fold"] += 1
        return fold(*a)

    def spy_locate(*a):
        calls["locate"] += 1
        return locate(*a)

    monkeypatch.setattr(K, "span_fold_batch", spy_fold)
    monkeypatch.setattr(K, "span_locate_batch", spy_locate)
    c = eng.compiler_for(handle).compile(parse_query(_lead_body(VOCAB[:5], "")))
    assert c.spec[1][0][3] == 8
    tbd.execute_auto(ptree, c.spec, tbd.plan_to_torch(c.spec, c.arrays, "cpu"), 10)
    assert calls == {"fold": 1, "locate": 0}


# ---------------------------------------------------------------------------
# K3's merge mode
# ---------------------------------------------------------------------------


def _merge_config(m: int):
    """esk_topk_merge's (E, W) for a row of m keys."""
    for limit, config in ((128, (4, 1)), (256, (8, 1)), (512, (8, 2)),
                          (1024, (8, 4)), (2048, (8, 8))):
        if m <= limit:
            return config
    return 8, 16


def _composites(key_row: np.ndarray) -> np.ndarray:
    b = key_row.view(np.uint32).astype(np.uint64)
    order = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    idx = np.arange(len(key_row), dtype=np.uint64)
    return (order << np.uint64(32)) | (~idx & np.uint64(0xFFFFFFFF))


def _merge_model(key: np.ndarray, k: int, ids=None):
    """topk_merge_kernel row by row: register e of thread t starts with
    entry e * T + t (0 past M), the bitonic network over g = t * E + e in
    the kernel's stage order (in-thread below E, across lanes or warps
    above: the partner is thread t ^ (j / E), register e), then rank g
    decoded from thread g / E, register g % E."""
    q, m = key.shape
    e_, w_ = _merge_config(m)
    t_n = 32 * w_
    p = t_n * e_
    kp = min(k, m)
    tops, idxs, taken = [], [], []
    g = np.arange(p).reshape(t_n, e_)
    for r in range(q):
        comp = _composites(key[r])
        v = np.zeros((t_n, e_), np.uint64)
        for e in range(e_):
            for t in range(t_n):
                i = e * t_n + t
                v[t, e] = comp[i] if i < m else 0
        for ls in range(1, p.bit_length()):
            size = 1 << ls
            for lj in range(ls - 1, -1, -1):
                j = 1 << lj
                if j < e_:
                    for e in range(e_):
                        if e & j:
                            continue
                        desc = (g[:, e] & size) == 0
                        a, b = v[:, e].copy(), v[:, e | j].copy()
                        swap = np.where(desc, a < b, a > b)
                        v[:, e] = np.where(swap, b, a)
                        v[:, e | j] = np.where(swap, a, b)
                else:
                    o = v[np.arange(t_n) ^ (j // e_)]
                    keep_max = ((g & j) == 0) == ((g & size) == 0)
                    v = np.where(keep_max, np.maximum(v, o), np.minimum(v, o))
        ranked = v.reshape(-1)[:kp]
        idx = (~ranked & np.uint64(0xFFFFFFFF)).astype(np.int64)
        tops.append(key[r][idx])
        idxs.append(idx)
        if ids is not None:
            taken.append(ids[r][idx])
    return np.stack(tops), np.stack(idxs), (np.stack(taken) if ids is not None else None)


def _merge_keys(q: int, m: int, seed: int):
    """Gathered per-shard tops: shards of equal keys (ties across shards),
    +/-0.0, +/-NaN, integers (ties within a row) and -inf padding."""
    rng = np.random.default_rng(seed)
    key = rng.standard_normal((q, m)).astype(np.float32)
    if m >= 8:
        kk = m // 8
        key[:, kk:2 * kk] = key[:, :kk]  # shard 1 repeats shard 0
    key[:, ::5] = np.round(key[:, ::5])
    specials = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf], np.float32)
    sel = rng.random((q, m)) < 0.15
    key[sel] = rng.choice(specials, int(sel.sum()))
    key[:, m - m // 4:] = -np.inf  # shards with fewer than kk hits
    ids = rng.integers(0, 1 << 30, (q, m)).astype(np.int32)
    return key, ids


@pytest.mark.parametrize("m", [1, 8, 80, 128, 129, 256, 257, 600, 1500, 2049,
                               K.MERGE_MAX_M])
def test_merge_mode_equals_lax_top_k_and_its_model(m):
    key, ids = _merge_keys(2, m, seed=m)
    for k in sorted({1, 10, m, m + 3}):
        top, idx, taken = K.masked_topk_merge(_t(key), k, _t(ids))
        kp = min(k, m)
        assert top.shape == idx.shape == taken.shape == (2, kp)
        assert idx.dtype == torch.int64 and taken.dtype == torch.int32
        p_top, p_idx, p_taken = K.masked_topk_merge_plain(_t(key), k, _t(ids))
        m_top, m_idx, m_taken = _merge_model(key, k, ids)
        j_top, j_idx = jax.lax.top_k(jnp.asarray(key), kp)
        j_taken = np.take_along_axis(ids, np.asarray(j_idx), axis=1)
        for t_, i_, g_ in ((p_top.numpy(), p_idx.numpy(), p_taken.numpy()),
                           (m_top, m_idx, m_taken),
                           (np.asarray(j_top), np.asarray(j_idx), j_taken)):
            assert np.array_equal(_bits(top.numpy()), _bits(t_))
            assert np.array_equal(idx.numpy(), i_.astype(np.int64))
            assert np.array_equal(taken.numpy(), g_)
        t2, i2, none = K.masked_topk_merge(_t(key), k)
        assert none is None
        assert torch.equal(t2.view(torch.int32), top.view(torch.int32))
        assert torch.equal(i2, idx)


@pytest.mark.parametrize("m", [80, K.MERGE_MAX_M, K.MERGE_MAX_M + 1])
def test_merge_topk_routes_by_row_length(m, monkeypatch):
    """Rows up to MERGE_MAX_M take K3's merge mode; longer rows K3's row
    mode with an all-true mask, then a gather of the ids. Both equal
    lax.top_k and its take of the ids."""
    calls = {"merge": 0, "row": 0}
    merge, row = K.masked_topk_merge, K.masked_topk_batch

    def spy_merge(*a):
        calls["merge"] += 1
        return merge(*a)

    def spy_row(*a):
        calls["row"] += 1
        return row(*a)

    monkeypatch.setattr(K, "masked_topk_merge", spy_merge)
    monkeypatch.setattr(K, "masked_topk_batch", spy_row)
    key, ids = _merge_keys(1, m, seed=3)
    top, idx, taken = sharded._merge_topk(_t(key), 10, _t(ids))
    assert calls == ({"merge": 1, "row": 0} if m <= K.MERGE_MAX_M
                     else {"merge": 0, "row": 1})
    j_top, j_idx = jax.lax.top_k(jnp.asarray(key), 10)
    assert np.array_equal(_bits(top.numpy()), _bits(j_top))
    assert idx.dtype == torch.int64
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(taken.numpy(), np.take_along_axis(ids, np.asarray(j_idx), 1))
    _top, _idx, none = sharded._merge_topk(_t(key), 10)
    assert none is None


# ---------------------------------------------------------------------------
# The new entry points refuse what their kernels do not take
# ---------------------------------------------------------------------------


def _good_fold():
    return [_t(a) for a in _fold_inputs(2, 0, seed=1)]


def _fold_case(i, value):
    args = _good_fold()
    args[i] = value
    return args


FOLD_REFUSALS = {
    "flat_docs_dtype": (lambda: _fold_case(0, _good_fold()[0].to(torch.int64)), TypeError),
    "flat_tn_dtype": (lambda: _fold_case(1, _good_fold()[1].double()), TypeError),
    "starts_rank": (lambda: _fold_case(2, _good_fold()[2][0]), ValueError),
    "weights_dtype": (lambda: _fold_case(4, _good_fold()[4].half()), TypeError),
    "weights_rows": (lambda: _fold_case(4, _good_fold()[4][:2]), ValueError),
    "ends_width": (lambda: _fold_case(3, _good_fold()[3][:, :1].contiguous()), ValueError),
    "in_range_dtype": (lambda: _fold_case(6, _good_fold()[6].to(torch.uint8)), TypeError),
    "in_range_shape": (lambda: _fold_case(6, _good_fold()[6][:, :5].contiguous()), ValueError),
    "tn_length": (lambda: _fold_case(1, _good_fold()[1][:-1].contiguous()), ValueError),
    "empty_plane": (lambda: [torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                             *_good_fold()[2:]], ValueError),
    "not_contiguous": (lambda: _fold_case(5, _good_fold()[5].t().contiguous().t()), ValueError),
    "other_device": (lambda: _fold_case(5, _good_fold()[5].to("meta")), ValueError),
    "not_a_tensor": (lambda: _fold_case(2, np.zeros((3, 2), np.int32)), TypeError),
}


@pytest.mark.parametrize("case", sorted(FOLD_REFUSALS))
def test_fold_mode_refuses_what_its_kernel_does_not_take(case):
    make, err = FOLD_REFUSALS[case]
    with pytest.raises(err):
        K.span_fold_batch(*make())
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}


def test_fold_stacked_refuses_rows_that_are_not_whole_pairs():
    flat, tn, st, en, w, safe, inr = (_t(a) for a in _fold_inputs(2, 3, seed=2))
    with pytest.raises(ValueError):  # 5 rows over 3 shards
        K.span_fold_stacked(flat, tn, st[:5].contiguous(), en[:5].contiguous(),
                            w[:5].contiguous(), safe[:5].contiguous(),
                            inr[:5].contiguous())
    with pytest.raises(ValueError):  # a one-segment plane
        K.span_fold_stacked(flat[0], tn[0], st, en, w, safe, inr)
    with pytest.raises(ValueError):
        K.span_fold_batch(flat, tn, st, en, w, safe, inr)  # stacked planes


MERGE_REFUSALS = {
    "key_dtype": (lambda: (torch.zeros((1, 8), dtype=torch.float64), 2, None), TypeError),
    "key_rank": (lambda: (torch.zeros(8), 2, None), ValueError),
    "ids_dtype": (lambda: (torch.zeros((1, 8)), 2, torch.zeros((1, 8), dtype=torch.int64)), TypeError),
    "ids_shape": (lambda: (torch.zeros((1, 8)), 2, torch.zeros((1, 7), dtype=torch.int32)), ValueError),
    "ids_device": (lambda: (torch.zeros((1, 8)), 2, torch.zeros((1, 8), dtype=torch.int32, device="meta")), ValueError),
    "negative_k": (lambda: (torch.zeros((1, 8)), -1, None), ValueError),
    "empty_rows": (lambda: (torch.zeros((1, 0)), 2, None), ValueError),
    "rows_too_long": (lambda: (torch.zeros((1, K.MERGE_MAX_M + 1)), 2, None), ValueError),
    "no_rows": (lambda: (torch.zeros((0, 8)), 2, None), ValueError),
    "too_many_rows": (lambda: (torch.zeros((65536, 1)), 1, None), ValueError),
    "not_contiguous": (lambda: (torch.zeros((8, 2)).t(), 2, None), ValueError),
}


@pytest.mark.parametrize("case", sorted(MERGE_REFUSALS))
def test_merge_mode_refuses_what_its_kernel_does_not_take(case):
    make, err = MERGE_REFUSALS[case]
    with pytest.raises(err):
        K.masked_topk_merge(*make())
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}

