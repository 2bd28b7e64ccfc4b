"""The port's kNN kernels (ops/ann_device, index/ann) against the JAX
package's ann_device / index/ann on identical numpy inputs.

The port runs the plain versions of K7 (vector_score), K9 (ivf_assign),
K3 and K3i here; chip_smoke.py holds each kernel to its plain version on
the card.

Tolerances, stated per test:
- Against the JAX package: ids, order and totals equal; scores within
  the reference's own bound for vector scores, rtol = atol = 1e-5
  (tests/test_script_knn.py:107). The two sum in other orders: XLA's
  reduction against K7's fixed lane order. Where two neighbours' JAX
  scores lie within that tolerance of each other, their order may differ:
  `near_tie_match` allows exactly that swap and counts it.
- Within the port: exact (fp32 bits as int32) — IVF re-rank scores
  against `exact_scores`, a full probe against `knn_exact`, batch lanes
  against solo calls, and the plain K7 reduction against an explicit
  emulation of the kernel's warp order.
- The k-means build: `part_docs` and `pmax` equal, centroids within
  1e-5; an assignment that a near-tie flips between K9's order and XLA's
  matmul is reported with its distance gap (`assign_flips`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index import ann as jann
from elasticsearch_tpu.ops import ann_device as jad
from elasticsearch_tpu_torch.index import ann as tann
from elasticsearch_tpu_torch.ops import ann_device as tad
from elasticsearch_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

METRICS = ("cosine", "dot_product", "l2_norm")
TOL = 1e-5


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def clustered(rng, n, d, n_centers=16, spread=3.0):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * spread
    assign = rng.integers(0, n_centers, n)
    vecs = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    return vecs.astype(np.float32), centers


def corpus(seed, n, d, metric, vectorless=0):
    rng = np.random.default_rng(seed)
    vecs, centers = clustered(rng, n, d)
    if metric == "dot_product":
        vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(np.float32)
    if vectorless:
        vecs[rng.choice(n, vectorless, replace=False)] = 0.0
    live = rng.random(n) > 0.05
    return rng, vecs, centers, live


def near_tie_match(ids_p, s_p, ids_j, s_j, jax_scores):
    """Port hits (ids_p, s_p) against the JAX package's (ids_j, s_j):
    scores within TOL position by position, and ids equal except where the
    two docs' JAX scores are within TOL of each other (a near-tie whose
    order the summation order may flip). Returns the number of swapped
    positions."""
    assert len(ids_p) == len(ids_j)
    np.testing.assert_allclose(s_p, s_j, rtol=TOL, atol=TOL)
    swaps = 0
    for a, b in zip(ids_p, ids_j):
        if a != b:
            gap = abs(float(jax_scores[a]) - float(jax_scores[b]))
            assert gap <= TOL * (1 + abs(float(jax_scores[b]))), (a, b, gap)
            swaps += 1
    return swaps


def test_lane_sum_is_the_kernels_warp_order():
    """The plain K7 reduction spells the kernel's order: lane l sums
    elements l, l + 32, ... in ascending order in fp32, then lanes fold
    l += l + 16, + 8, + 4, + 2, + 1 (an explicit float32 emulation)."""
    rng = np.random.default_rng(5)
    for d in (1, 16, 31, 32, 33, 100, 130):
        x = rng.standard_normal((7, d)).astype(np.float32)
        got = K.lane_sum(_t(x)).numpy()
        slabs = max(1, -(-d // 32))
        pad = np.zeros((7, slabs * 32), np.float32)
        pad[:, :d] = x
        want = np.empty(7, np.float32)
        for r in range(7):
            lanes = [np.float32(pad[r, lane]) for lane in range(32)]
            for s in range(1, slabs):
                lanes = [np.float32(lanes[lane] + pad[r, s * 32 + lane])
                         for lane in range(32)]
            for w in (16, 8, 4, 2, 1):
                lanes = [np.float32(lanes[lane] + lanes[lane + w])
                         for lane in range(w)]
            want[r] = lanes[0]
        assert np.array_equal(_bits(got), _bits(want)), d


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [16, 100])
def test_exact_scores_against_jax(metric, d):
    _rng, vecs, _c, _live = corpus(11 + d, 3000, d, metric)
    q = vecs[17] + np.float32(0.1)
    ref = np.asarray(jad.exact_scores(jnp.asarray(vecs), jnp.asarray(q), metric))
    got = tad.exact_scores(_t(vecs), _t(q), metric).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    # The host oracle's formula agrees too.
    oracle = tad.similarity_scores(np, vecs, q, metric)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("filtered", [False, True])
def test_knn_exact_against_jax(metric, filtered):
    rng, vecs, centers, live = corpus(21, 2500, 16, metric, vectorless=40)
    fmask = rng.random(len(vecs)) > 0.4 if filtered else None
    q = (centers[3] + 0.3 * rng.standard_normal(16)).astype(np.float32)
    for k in (1, 10, 57):
        s_j, i_j, t_j = jad.knn_exact(
            jnp.asarray(vecs), jnp.asarray(live), jnp.asarray(q), k, metric,
            None if fmask is None else jnp.asarray(fmask),
        )
        s_p, i_p, t_p = tad.knn_exact(
            _t(vecs), _t(live), _t(q), k, metric,
            None if fmask is None else _t(fmask),
        )
        assert int(t_p) == int(t_j)
        s_j, i_j = np.asarray(s_j), np.asarray(i_j)
        s_p, i_p = s_p.numpy(), i_p.numpy()
        fin = s_j > -np.inf
        assert np.array_equal(s_p > -np.inf, fin)
        jax_all = np.asarray(jad.exact_scores(jnp.asarray(vecs), jnp.asarray(q), metric))
        near_tie_match(i_p[fin], s_p[fin], i_j[fin], s_j[fin], jax_all)
        # Vector-less, dead and filtered-out docs never rank.
        hits = i_p[fin]
        assert np.all(live[hits]) and np.all(np.any(vecs[hits] != 0, axis=1))
        if fmask is not None:
            assert np.all(fmask[hits])


@pytest.mark.parametrize("metric", METRICS)
def test_knn_exact_batch_lanes_equal_solo(metric):
    rng, vecs, centers, live = corpus(31, 1500, 16, metric, vectorless=10)
    qs = (centers[:5] + 0.5 * rng.standard_normal((5, 16))).astype(np.float32)
    s_b, i_b, t_b = tad.knn_exact_batch(_t(vecs), _t(live), _t(qs), 12, metric)
    for r in range(5):
        s, i, t = tad.knn_exact(_t(vecs), _t(live), _t(qs[r]), 12, metric)
        assert np.array_equal(_bits(s_b[r]), _bits(s))
        assert torch.equal(i_b[r], i) and int(t_b[r]) == int(t)


def _jax_parts(vecs, metric, n_partitions=None):
    parts = jann.build_partitions(
        "vec", vecs, jnp.asarray(vecs), num_docs=len(vecs), metric=metric,
        n_partitions=n_partitions,
    )
    return parts, tann.ann_partitions_from_numpy(
        "vec", metric, np.asarray(parts.centroids),
        np.asarray(parts.part_vectors), np.asarray(parts.part_docs),
        parts.n_vectors, parts.num_docs, parts.n_clusters, "cpu",
    )


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("filtered", [False, True])
def test_ann_ivf_search_against_jax(metric, filtered):
    """The same carried-across planes through both packages' IVF search:
    ids, order, totals and candidate counts equal, scores within TOL."""
    rng, vecs, centers, live = corpus(41, 4000, 16, metric, vectorless=25)
    jparts, tparts = _jax_parts(vecs, metric)
    fmask = rng.random(len(vecs)) > 0.5 if filtered else None
    jax_live = jnp.asarray(live)
    for j in range(4):
        q = (centers[j] + 0.4 * rng.standard_normal(16)).astype(np.float32)
        nprobe = jann.default_nprobe(jparts.n_partitions)
        for k in (5, 40):
            s_j, i_j, t_j, c_j = jad.ann_ivf_search(
                jparts.tree(), jax_live, jnp.asarray(q), k, nprobe, metric,
                None if fmask is None else jnp.asarray(fmask),
            )
            s_p, i_p, t_p, c_p = tad.ann_ivf_search(
                tparts.tree(), _t(live), _t(q), k, nprobe, metric,
                None if fmask is None else _t(fmask),
            )
            assert (int(t_p), int(c_p)) == (int(t_j), int(c_j))
            s_j, i_j = np.asarray(s_j), np.asarray(i_j)
            s_p, i_p = s_p.numpy(), i_p.numpy()
            fin = s_j > -np.inf
            assert np.array_equal(s_p > -np.inf, fin)
            jax_all = np.asarray(jad.exact_scores(jnp.asarray(vecs), jnp.asarray(q), metric))
            near_tie_match(i_p[fin], s_p[fin], i_j[fin], s_j[fin], jax_all)
            if fmask is not None:
                assert np.all(fmask[i_p[fin]])


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_rerank_equals_exact_scores_and_full_probe_equals_exact(metric):
    """The port's parity law: every IVF hit's score is bit-equal to the
    port's own exact_scores for that doc, and a full probe returns
    knn_exact's ids and bits."""
    rng, vecs, centers, live = corpus(51, 3000, 16, metric, vectorless=15)
    _jparts, tparts = _jax_parts(vecs, metric)
    for j in range(3):
        q = (centers[j] + 0.4 * rng.standard_normal(16)).astype(np.float32)
        exact = tad.exact_scores(_t(vecs), _t(q), metric)
        s, i, _t_, _c = tad.ann_ivf_search(tparts.tree(), _t(live), _t(q), 30,
                                           6, metric)
        fin = s > -np.inf
        assert np.array_equal(_bits(s[fin]), _bits(exact[i[fin].long()]))
        full = tad.ann_ivf_search(tparts.tree(), _t(live), _t(q), 30,
                                  tparts.n_partitions, metric)
        ex = tad.knn_exact(_t(vecs), _t(live), _t(q), 30, metric)
        fin = ex[0] > -np.inf
        assert torch.equal(full[1][fin], ex[1][fin])
        assert np.array_equal(_bits(full[0][fin]), _bits(ex[0][fin]))
        assert int(full[2]) == int(ex[2])


@pytest.mark.parametrize("metric", METRICS)
def test_ann_ivf_batch_lanes_equal_solo_and_jax(metric):
    rng, vecs, centers, live = corpus(61, 3000, 16, metric)
    jparts, tparts = _jax_parts(vecs, metric)
    qs = (centers[:6] + 0.4 * rng.standard_normal((6, 16))).astype(np.float32)
    nprobe = jann.default_nprobe(tparts.n_partitions)
    out_b = tad.ann_ivf_search_batch(tparts.tree(), _t(live), _t(qs), 9,
                                     nprobe, metric)
    ref_b = jad.ann_ivf_search_batch(jparts.tree(), jnp.asarray(live),
                                     jnp.asarray(qs), 9, nprobe, metric)
    for r in range(6):
        solo = tad.ann_ivf_search(tparts.tree(), _t(live), _t(qs[r]), 9,
                                  nprobe, metric)
        assert np.array_equal(_bits(out_b[0][r]), _bits(solo[0]))
        for a, b in zip(out_b[1:], solo[1:]):
            assert torch.equal(a[r], b)
        assert int(out_b[2][r]) == int(ref_b[2][r])
        assert int(out_b[3][r]) == int(ref_b[3][r])
        jax_all = np.asarray(jad.exact_scores(jnp.asarray(vecs), jnp.asarray(qs[r]), metric))
        near_tie_match(out_b[1][r].numpy(), out_b[0][r].numpy(),
                       np.asarray(ref_b[1][r]), np.asarray(ref_b[0][r]), jax_all)


def test_masked_topk_ids_orders_by_score_then_id():
    """K3i (plain): (score desc, id asc) as lax.sort((-s, id, s),
    num_keys=2) orders them: -0.0 equal to +0.0 (the id decides) and every
    NaN last. Ids and order exact; scores bit-equal after lax.sort's own
    canonicalisation (a zero as +0.0, a NaN as NaN), which K3i returns."""
    rng = np.random.default_rng(3)
    key = rng.integers(0, 5, (3, 300)).astype(np.float32)
    key[0, :5] = [-0.0, 0.0, -np.inf, np.nan, -np.inf]
    ids = rng.permutation(1000)[:900].reshape(3, 300).astype(np.int32)
    s, i, _tot = K.masked_topk_ids_batch(_t(key), _t(ids),
                                         torch.ones(3, 300, dtype=torch.bool), 40)
    for r in range(3):
        _neg, doc, ss = (np.asarray(x) for x in jax.lax.sort(
            (-jnp.asarray(key[r]), jnp.asarray(ids[r]), jnp.asarray(key[r])),
            num_keys=2,
        ))
        assert np.array_equal(i[r].numpy(), doc[:40])
        canon = np.where(ss[:40] == 0, np.float32(0), ss[:40]).astype(np.float32)
        canon[np.isnan(canon)] = np.float32(np.nan)
        assert np.array_equal(_bits(s[r]), _bits(canon))
    # A NaN and a zero reach the top when k covers the row.
    s, i, _tot = K.masked_topk_ids_batch(_t(key[:1]), _t(ids[:1]),
                                         torch.ones(1, 300, dtype=torch.bool), 300)
    _neg, doc, _ss = jax.lax.sort((-jnp.asarray(key[0]), jnp.asarray(ids[0]),
                                   jnp.asarray(key[0])), num_keys=2)
    assert np.array_equal(i[0].numpy(), np.asarray(doc))
    assert np.isnan(s[0, -1]) and not np.isnan(s[0, :-1]).any()


def assign_flips(got, ref, rows, centroids):
    """Rows whose nearest centroid differs between the port and the JAX
    package, each with the relative gap of their two squared distances
    (float64): a flip is a near-tie of XLA's matmul against K9's order."""
    flips = []
    for r in np.flatnonzero(got != ref):
        d = ((rows[r].astype(np.float64) - centroids.astype(np.float64)) ** 2).sum(1)
        flips.append(abs(d[got[r]] - d[ref[r]]) / max(d[ref[r]], 1e-30))
    return flips


@pytest.mark.parametrize("d", [16, 100])
def test_assign_chunk_against_jax(d):
    rng = np.random.default_rng(71 + d)
    rows, centers = clustered(rng, 3000, d, n_centers=40)
    cents = (centers + 0.1 * rng.standard_normal(centers.shape)).astype(np.float32)
    got = tad.assign_all(_t(cents), rows, chunk_rows=1024)
    ref = np.asarray(jad.assign_all(jnp.asarray(cents), rows))
    flips = assign_flips(got, ref, rows, cents)
    assert all(g <= 1e-5 for g in flips), flips
    assert len(flips) <= 3, flips


@pytest.mark.parametrize("metric", METRICS)
def test_build_partitions_against_jax(metric):
    _rng, vecs, _c, _live = corpus(81, 2500, 16, metric, vectorless=20)
    jparts = jann.build_partitions(
        "vec", vecs, jnp.asarray(vecs), num_docs=len(vecs), metric=metric
    )
    tparts = tann.build_partitions(
        "vec", vecs, _t(vecs), num_docs=len(vecs), metric=metric
    )
    assert tparts.pmax == jparts.pmax
    assert tparts.n_clusters == jparts.n_clusters
    assert tparts.n_vectors == jparts.n_vectors == 2480
    assert np.array_equal(tparts.part_docs.numpy(), np.asarray(jparts.part_docs))
    np.testing.assert_allclose(tparts.centroids.numpy(),
                               np.asarray(jparts.centroids), rtol=TOL, atol=TOL)
    assert np.array_equal(_bits(tparts.part_vectors),
                          _bits(np.asarray(jparts.part_vectors)))
    # Slots are doc-ascending within every partition; padding is the
    # sentinel with zero rows.
    docs = tparts.part_docs.numpy()
    for row in docs:
        real = row[row < len(vecs)]
        assert np.all(np.diff(real) > 0)
    pad = docs == len(vecs)
    assert not tparts.part_vectors.numpy()[pad].any()


def test_ann_cache_lru_prune_and_clear():
    class H:
        def __init__(self, uid, vecs):
            self.uid = uid
            self.segment = type("S", (), {"vectors": {"vec": vecs}})()
            self.device = type("D", (), {"vectors": {"vec": _t(vecs)},
                                         "num_docs": len(vecs)})()

    class E:
        def __init__(self, uid, handles):
            self.uid, self.segments = uid, handles

    _rng, vecs, _c, _l = corpus(91, 600, 8, "cosine")
    cache = tann.AnnCache(min_docs=512)
    small = H(1, vecs[:100])
    eng = E(7, [small])
    assert cache.get_or_build(eng, small, "vec", "cosine") is None
    h1, h2 = H(2, vecs), H(3, vecs)
    eng.segments = [h1, h2]
    p1 = cache.get_or_build(eng, h1, "vec", "cosine")
    assert cache.get_or_build(eng, h1, "vec", "cosine") is p1
    cache.get_or_build(eng, h2, "vec", "cosine")
    st = cache.stats()
    assert (st["planes"], st["builds"], st["hit_count"], st["miss_count"]) == (2, 2, 1, 2)
    assert cache.prune_dead(7, frozenset({3})) == 1
    cache.max_bytes = p1.nbytes  # room for one plane: LRU evicts the other
    eng.segments = [h1, h2]
    cache.get_or_build(eng, h1, "vec", "cosine")
    assert cache.stats()["planes"] == 1
    assert tann.clear_index_ann(cache, [eng]) == 1
    assert cache.stats()["planes"] == 0
    assert tann.default_nprobe(10) == 4 and tann.default_nprobe(1000) == 125
