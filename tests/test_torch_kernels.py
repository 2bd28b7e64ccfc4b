"""Port kernels K1-K4 (their plain versions, as the CPU runs them) against
the JAX package's device functions on identical numpy inputs.

Tolerance is exact: integer outputs equal, fp32 outputs bit-equal
(compared as int32). On the card the same wrappers launch the CUDA
kernels, and chip_smoke.py holds each kernel to its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu_torch.ops import kernels as K

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

TILE = 256


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _corpus(seed: int, n_docs: int = 3000, n_terms: int = 6):
    """Synthetic CSR postings, tiled like pack_field, and a worklist over
    every term plus a duplicate of term 0, with one doc in every term."""
    rng = np.random.default_rng(seed)
    everywhere = int(rng.integers(0, n_docs))
    offsets, docs, tfs = [0], [], []
    for _ in range(n_terms):
        df = int(rng.integers(1, n_docs // 3))
        d = rng.choice(n_docs, df, replace=False)
        d = np.unique(np.append(d, everywhere)).astype(np.int32)
        docs.append(d)
        tfs.append(rng.integers(1, 6, len(d)).astype(np.float32))
        offsets.append(offsets[-1] + len(d))
    flat = np.concatenate(docs)
    tf = np.concatenate(tfs)
    p = len(flat)
    p_pad = ((p + TILE - 1) // TILE) * TILE + TILE
    doc_tiles = np.full(p_pad, n_docs, np.int32)
    doc_tiles[:p] = flat
    norm = rng.integers(1, 120, n_docs + 1).astype(np.uint8)
    cache = (rng.random(256).astype(np.float32) * 2 + 0.05).astype(np.float32)
    tn = np.zeros(p_pad, np.float32)
    tn[:p] = tf * cache[norm[flat]]
    tfp = np.zeros(p_pad, np.float32)
    tfp[:p] = tf
    entries = []
    for t in list(range(n_terms)) + [0]:
        s, e = offsets[t], offsets[t + 1]
        w = np.float32(0.5 + rng.random() * 3)
        for tile in range(s // TILE, (e - 1) // TILE + 1):
            entries.append((tile, s, e, w))
    nt = 1 << (len(entries) - 1).bit_length()
    arrays = {
        "tile_ids": np.full(nt, p_pad // TILE - 1, np.int32),
        "starts": np.zeros(nt, np.int32),
        "ends": np.zeros(nt, np.int32),
        "weights": np.zeros(nt, np.float32),
        "cache": cache,
        "boost": np.float32(1.0),
    }
    for i, (tile, s, e, w) in enumerate(entries):
        arrays["tile_ids"][i] = tile
        arrays["starts"][i] = s
        arrays["ends"][i] = e
        arrays["weights"][i] = w
    live = rng.random(n_docs) > 0.15
    present = np.ones(n_docs, bool)
    planes = (doc_tiles.reshape(-1, TILE), tn.reshape(-1, TILE),
              tfp.reshape(-1, TILE), norm, present)
    return {
        "n_docs": n_docs,
        "planes": planes,
        "arrays": arrays,
        "live": live,
        "offsets": np.asarray(offsets, np.int32),
        "everywhere": everywhere,
        "t_pad": 1 << n_terms.bit_length(),
    }


def _jax_seg(c):
    return {
        "fields": {"body": tuple(jnp.asarray(x) for x in c["planes"])},
        "live": jnp.asarray(c["live"]),
    }


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _k1(c, gather=False, matched_only=False):
    doc_tiles, tn, tfp, norm, _ = c["planes"]
    a = c["arrays"]
    groups = K.term_groups(a["tile_ids"], a["starts"], a["ends"])
    return K.terms_scatter(
        _t(doc_tiles), _t(tfp if gather else tn), _t(norm), _t(a["tile_ids"]),
        _t(a["starts"]), _t(a["ends"]), None if matched_only else _t(a["weights"]),
        c["n_docs"], groups, cache=_t(a["cache"]) if gather else None,
        matched_only=matched_only,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_terms_scatter_matches_eval_terms(seed):
    c = _corpus(seed)
    n = c["n_docs"]
    ref_s, ref_m = jbd._eval_terms(("terms", "body", 0, c["t_pad"]),
                                   c["arrays"], _jax_seg(c), n)
    s, m = _k1(c)
    assert np.array_equal(_bits(s[:n].numpy()), _bits(ref_s))
    assert np.array_equal(m[:n].numpy(), np.asarray(ref_m))
    # the doc in every term collects every contribution, duplicate included
    assert float(s[c["everywhere"]]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_norm_cache_variant_matches_eval_terms_gather(seed):
    c = _corpus(seed)
    n = c["n_docs"]
    ref_s, ref_m = jbd._eval_terms_gather(("terms_gather", "body", 0, 8),
                                          c["arrays"], _jax_seg(c), n)
    s, m = _k1(c, gather=True)
    assert np.array_equal(_bits(s[:n].numpy()), _bits(ref_s))
    assert np.array_equal(m[:n].numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_matched_only_matches_terms_matched(seed):
    c = _corpus(seed)
    n = c["n_docs"]
    ref = jbd._terms_matched(("terms_const", "body", 0), c["arrays"],
                             _jax_seg(c), n)
    scores, m = _k1(c, matched_only=True)
    assert scores is None
    assert np.array_equal(m[:n].numpy(), np.asarray(ref))


def test_term_groups_split_term_occurrences():
    tile_ids = np.array([3, 4, 5, 5, 6, 3, 4, 9, 9], np.int32)
    starts = np.array([700, 700, 700, 1300, 1300, 700, 700, 0, 0], np.int32)
    ends = np.array([1300, 1300, 1300, 1700, 1700, 1300, 1300, 0, 0], np.int32)
    groups = K.term_groups(tile_ids, starts, ends)
    assert groups.tolist() == [[0, 3], [3, 5], [5, 7]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k2_sparse_fold_matches_sparse_candidates(seed):
    c = _corpus(seed)
    n = c["n_docs"]
    spec = ("terms", "body", len(c["arrays"]["tile_ids"]), c["t_pad"])
    docs_s, run_sum, elig, _p, _kk = jbd._sparse_candidates(
        _jax_seg(c), spec, c["arrays"], 10
    )
    doc_tiles, tn, _tfp, _norm, _ = c["planes"]
    a = c["arrays"]
    d, r, e = K.sparse_fold(
        _t(doc_tiles), _t(tn), _t(a["tile_ids"]), _t(a["starts"]),
        _t(a["ends"]), _t(a["weights"]), _t(c["live"]), n, c["t_pad"],
    )
    assert np.array_equal(d.numpy(), np.asarray(docs_s))
    assert np.array_equal(_bits(r.numpy()), _bits(run_sum))
    assert np.array_equal(e.numpy(), np.asarray(elig))
    # the doc hit by every term (and the duplicate) folds a full run
    head = int(np.flatnonzero(d.numpy() == c["everywhere"])[0])
    run = int(np.count_nonzero(d.numpy() == c["everywhere"]))
    assert run == len(c["offsets"])  # n_terms + 1 duplicate occurrence
    assert e.numpy()[head] == c["live"][c["everywhere"]]


def _k3_case(seed, m, k, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        key = rng.integers(0, 4, m).astype(np.float32)
    elif kind == "signed_zero":
        key = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), m)
    else:
        key = rng.standard_normal(m).astype(np.float32)
    elig = rng.random(m) > (1.0 if kind == "none" else 0.4)
    key = np.where(elig, key, np.float32(-np.inf)).astype(np.float32)
    return key, elig


@pytest.mark.parametrize(
    "seed,m,k,kind",
    [
        (0, 5000, 10, "normal"),
        (1, 5000, 10, "ties"),
        (2, 300, 1000, "ties"),  # k above the eligible count and above M
        (3, 4000, 3000, "normal"),  # k above the eligible count
        (4, 2000, 10, "none"),  # all -inf
        (5, 20000, 10000, "ties"),  # ES max_result_window
        (6, 3000, 50, "signed_zero"),
    ],
)
def test_k3_masked_topk_matches_lax_top_k(seed, m, k, kind):
    key, elig = _k3_case(seed, m, k, kind)
    kk = min(k, m)
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(key), kk)
    ref_total = int(jnp.sum(jnp.asarray(elig), dtype=jnp.int32))
    s, i, total = K.masked_topk(_t(key), _t(elig), k)
    assert int(total) == ref_total
    assert np.array_equal(i.numpy(), np.asarray(ref_i))
    assert np.array_equal(_bits(s.numpy()), _bits(ref_s))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k4_span_locate_matches_span_locate(seed):
    c = _corpus(seed)
    rng = np.random.default_rng(seed)
    flat = c["planes"][0].reshape(-1)
    offs = c["offsets"]
    cands = np.sort(rng.integers(0, c["n_docs"] + 1, 2000)).astype(np.int32)
    for j in range(len(offs) - 1):
        ref_pos, ref_found = jbd._span_locate(
            jnp.asarray(flat), int(offs[j]), int(offs[j + 1]), jnp.asarray(cands)
        )
        pos, found = K.span_locate(_t(flat), _t(offs[:-1].copy()),
                                   _t(offs[1:].copy()), j, _t(cands))
        assert np.array_equal(pos.numpy(), np.asarray(ref_pos))
        assert np.array_equal(found.numpy(), np.asarray(ref_found))


def test_wrappers_refuse_what_kernels_do_not_take():
    c = _corpus(0, n_docs=500, n_terms=2)
    a = c["arrays"]
    doc_tiles, tn, _tfp, norm, _ = c["planes"]
    with pytest.raises(TypeError):
        K.masked_topk(_t(np.zeros(4, np.float64)), _t(np.ones(4, bool)), 2)
    with pytest.raises(ValueError):
        K.masked_topk(_t(np.zeros(4, np.float32)), _t(np.ones(3, bool)), 2)
    with pytest.raises(ValueError):
        K.span_locate(_t(doc_tiles.reshape(-1)), _t(a["starts"]),
                      _t(a["ends"]), len(a["starts"]), _t(np.zeros(3, np.int32)))
    with pytest.raises(ValueError):
        K.terms_scatter(_t(doc_tiles), _t(tn), _t(norm[:-1]), _t(a["tile_ids"]),
                        _t(a["starts"]), _t(a["ends"]), _t(a["weights"]),
                        c["n_docs"], np.zeros((0, 2), np.int32))
    with pytest.raises(ValueError):
        K.sparse_fold(_t(doc_tiles), _t(tn), _t(a["tile_ids"]),
                      _t(a["starts"]), _t(a["ends"]), _t(a["weights"]),
                      _t(c["live"][:-1]), c["n_docs"], 4)
    with pytest.raises(ValueError):
        K.masked_topk(_t(np.zeros(4, np.float32)).t().contiguous()[::2],
                      _t(np.ones(2, bool)), 1)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}  # CPU: plain only


def test_key_bits_and_topk_chunk():
    assert K.key_bits(8_841_823) == 24  # three 8-bit radix passes
    assert K.key_bits(254) == 8 and K.key_bits(255) == 9
    # K3's design by k and row length (topk_chunk's successor).
    assert K.topk_route(10, 8_841_823) == "select"
    assert K.topk_route(10_000, 8_841_823) == "large"
    assert K.topk_route(1_504, 1_504) == "short"
