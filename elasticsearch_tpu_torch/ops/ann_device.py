"""kNN over the dense_vector plane: brute-force exact and IVF probe +
exact re-rank, in PyTorch over the port's kernels.

Port of elasticsearch_tpu/ops/ann_device.py: `METRICS`,
`similarity_scores` (the host oracle's formula, kept for tests and
recall checks), `exact_scores`, `knn_exact`, `knn_exact_batch`,
`ann_ivf_search`, `ann_ivf_search_batch`, `assign_chunk` and
`assign_all`. The jitted programs become compositions of:

    K7 vector_score  dense mode: the scorer of record (`_scored_rows`) over
                     [N, d], and the coarse scan over the centroids;
                     gather mode: the IVF re-rank of part_vectors[probes],
                     read in place
    K3 masked_topk   the masked top-k (K3b for Q rows): the brute-force
                     top-k, the top-nprobe partitions, the per-partition
                     top-k
    K3i              K3's id mode: the (score desc, doc asc) merge of the
                     partitions' survivors
    K9 ivf_assign    the nearest centroid of each row (the IVF build)

**Parity law.** The reference makes every IVF candidate's score bit-equal
to its brute-force score by scoring both through one barrier-pinned
elementwise reduction. Here K7 is that one reduction: a row's score is
the same fixed-order fp32 sum whether the row comes from the [N, d]
plane or from a probed partition, so an IVF candidate's score equals
the port's own `exact_scores` for that doc bit for bit, and a full probe
returns `knn_exact`'s ids and bits. Against the JAX package the scores
agree to the reference's own tolerance for vector scores (XLA's
reduction order differs from K7's), ids, order and totals exactly.

Batches: the `*_batch` forms run Q query vectors through the same
kernels with a row axis; each row's program is the solo program, so a
batched lane is bit-identical to its solo call (the reference's
`lax.map`).

Totals are request-shaped, as in the reference: `knn_exact` ranks live ∧
filter ∧ has-a-vector, but counts live ∧ filter; IVF counts live ∧ filter
over the whole doc space and returns `n_candidates`, the eligible
candidates its probe examined. Slots past the hits carry -inf scores
(the caller trims to the finite prefix).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

NEG_INF = float("-inf")

# The similarity names the dense_vector mapping accepts.
METRICS = ("cosine", "dot_product", "l2_norm")


def similarity_scores(xp, vectors, q, metric: str):
    """ES vector-similarity scores of `q` against each row of `vectors`
    — the reference's plain formulation (xp = numpy: the host oracle of
    the tests and recall checks). The serving kernels score through K7
    (`exact_scores`), which this matches to float rounding, not bit for
    bit."""
    if metric not in METRICS:
        raise ValueError(f"unknown dense_vector similarity [{metric}]")
    q = xp.asarray(q, dtype=xp.float32)
    half = xp.float32(0.5)
    one = xp.float32(1.0)
    if metric == "l2_norm":
        diff = vectors - q
        d2 = xp.sum(diff * diff, axis=-1)
        return (one / (one + d2)).astype(xp.float32)
    dots = xp.sum(vectors * q, axis=-1)
    if metric == "dot_product":
        return ((one + dots) * half).astype(xp.float32)
    vnorm = xp.sqrt(xp.sum(vectors * vectors, axis=-1))
    qnorm = xp.sqrt(xp.sum(q * q))
    denom = vnorm * qnorm
    cos = xp.where(denom > 0, dots / denom, xp.float32(0.0))
    return ((one + cos) * half).astype(xp.float32)


def _queries(qs, device) -> torch.Tensor:
    """Query vectors as a contiguous f32[Q, d] tensor on `device`."""
    t = torch.as_tensor(np.asarray(qs, dtype=np.float32)) if not isinstance(
        qs, torch.Tensor) else qs
    t = t.to(device=device, dtype=torch.float32)
    return (t[None] if t.dim() == 1 else t).contiguous()


def exact_scores(vectors, q, metric: str) -> torch.Tensor:
    """Per-doc exact similarity scores f32[N] (K7 dense mode) — the values
    every IVF candidate's re-rank score equals bit for bit."""
    return kernels.vector_score_batch(
        vectors, _queries(q, vectors.device), metric
    )[0]


def _exact_rows(vectors, live, qs, k: int, metric: str, filter_mask,
                has_vec):
    q = qs.shape[0]
    scores = kernels.vector_score_batch(vectors, qs, metric)  # [Q, N]
    eligible = live if filter_mask is None else live & filter_mask
    if has_vec is None:  # rows that hold a vector: any element non-zero
        has_vec = (vectors != 0).any(dim=-1)
    masked = torch.where(eligible & has_vec, scores, NEG_INF)
    kk = min(k, masked.shape[1])
    return kernels.masked_topk_batch(
        masked, eligible.expand(q, -1).contiguous(), kk
    )


def knn_exact(vectors, live, q, k: int, metric: str, filter_mask=None,
              has_vec=None):
    """Exact top-k over the whole [N, d] plane: (scores f32[k], local ids
    i32[k], the live ∧ filter total i32[]). Vector-less rows never rank;
    slots past the eligible hits carry -inf. `has_vec` is the plane's
    presence mask when the caller holds it (DeviceSegment.has_vector)."""
    out = _exact_rows(vectors, live, _queries(q, vectors.device), k, metric,
                      filter_mask, has_vec)
    return tuple(t[0] for t in out)


def knn_exact_batch(vectors, live, qs, k: int, metric: str, has_vec=None):
    """Q query vectors against one plane in one launch per kernel:
    ([Q, k] scores, [Q, k] ids, [Q] totals), each row equal to its solo
    `knn_exact`."""
    return _exact_rows(vectors, live, _queries(qs, vectors.device), k,
                       metric, None, has_vec)


def _topk_rows(key, eligible, k: int):
    """K3b over any number of rows, in launches of at most 65,535 rows
    (rows are independent, so the split changes no result)."""
    outs = [
        kernels.masked_topk_batch(key[r : r + 65535], eligible[r : r + 65535], k)
        for r in range(0, key.shape[0], 65535)
    ]
    return tuple(torch.cat(col) for col in zip(*outs))


def _ivf_rows(ann: dict, live, qs, k: int, nprobe: int, metric: str,
              filter_mask):
    centroids = ann["centroids"]
    part_vectors = ann["part_vectors"]
    part_docs = ann["part_docs"]
    num_docs = live.shape[0]
    q = qs.shape[0]
    n_parts, pmax = part_docs.shape
    dev = live.device
    # Coarse scan: the similarity of each centroid, top-nprobe partitions
    # (score desc, partition asc, as lax.top_k ranks them).
    coarse = kernels.vector_score_batch(centroids, qs, metric)  # [Q, C]
    kp = min(nprobe, n_parts)
    every = torch.ones_like(coarse, dtype=torch.bool)
    _, probes, _ = kernels.masked_topk_batch(coarse, every, kp)  # [Q, kp]
    # Exact re-rank of the probed partitions' slots, read in place.
    scores = kernels.vector_score_gather_batch(part_vectors, qs, probes, metric)
    cand_d = part_docs[probes.to(torch.int64)]  # [Q, kp, pmax]
    valid = cand_d < num_docs
    safe = torch.where(valid, cand_d, 0).to(torch.int64)
    eligible = valid & live[safe]
    if filter_mask is not None:
        # Before the rank: a filtered-out doc never takes a candidate slot.
        eligible = eligible & filter_mask[safe]
    # Per-partition top-k: slots within a partition are doc-ascending, so
    # K3's lowest-index tie-break is the doc-id rule.
    kk = min(k, num_docs)
    kk_part = min(kk, pmax)
    masked = torch.where(eligible.reshape(q, -1), scores, NEG_INF)
    part_s, part_pos, part_tot = _topk_rows(
        masked.reshape(q * kp, pmax), eligible.reshape(q * kp, pmax), kk_part
    )
    part_d = torch.gather(
        cand_d.reshape(q * kp, pmax), 1, part_pos.to(torch.int64)
    )
    # Merge of the kp * kk_part survivors by (score desc, doc asc): K3i.
    flat_s = part_s.reshape(q, kp * kk_part).contiguous()
    flat_d = part_d.reshape(q, kp * kk_part).contiguous()
    kk = min(kk, flat_s.shape[1])
    top_s, top_d, _ = kernels.masked_topk_ids_batch(
        flat_s, flat_d, torch.ones_like(flat_s, dtype=torch.bool), kk
    )
    hit = top_s > NEG_INF
    top_s = torch.where(hit, top_s, NEG_INF)
    top_i = torch.where(hit, top_d, torch.zeros_like(top_d))
    total_elig = live if filter_mask is None else live & filter_mask
    total = total_elig.sum(dtype=torch.int32).reshape(1).expand(q)
    n_candidates = part_tot.reshape(q, kp).sum(dim=1, dtype=torch.int32)
    return top_s, top_i, total.to(dev), n_candidates


def ann_ivf_search(ann: dict, live, q, k: int, nprobe: int, metric: str,
                   filter_mask=None):
    """One IVF query: coarse scan -> nprobe partitions -> exact re-rank ->
    top-k. `ann` is AnnPartitions.tree() ({"centroids": f32[C, d],
    "part_vectors": f32[C, pmax, d], "part_docs": i32[C, pmax], sentinel
    = num_docs}). Returns (scores f32[kk], local ids i32[kk], the live ∧
    filter total i32[], the eligible candidates examined i32[])."""
    out = _ivf_rows(ann, live, _queries(q, live.device), k, nprobe, metric,
                    filter_mask)
    return tuple(t[0] for t in out)


def ann_ivf_search_batch(ann: dict, live, qs, k: int, nprobe: int,
                         metric: str):
    """Q query vectors through the IVF kernels at once (every lane probes
    its own partitions): [Q, kk] scores and ids, [Q] totals and
    candidate counts, each row equal to its solo `ann_ivf_search`."""
    return _ivf_rows(ann, live, _queries(qs, live.device), k, nprobe, metric,
                     None)


# ---------------------------------------------------------------------------
# Build-time assignment: K9 over chunks (index/ann.py drives the k-means
# loop on the host).
# ---------------------------------------------------------------------------


def assign_chunk(centroids, chunk) -> torch.Tensor:
    """Nearest centroid (squared L2) per row of `chunk` -> i32[M] (K9)."""
    return kernels.ivf_assign(centroids, chunk)


def assign_all(centroids, vectors, chunk_rows: int = 8192) -> np.ndarray:
    """Nearest-centroid assignment for every row of `vectors` (a host
    array, or a tensor on the centroids' device), in chunks of
    `chunk_rows`; returns host i32[N]."""
    dev = centroids.device
    n = vectors.shape[0]
    out = np.empty(n, dtype=np.int32)
    for start in range(0, n, chunk_rows):
        chunk = vectors[start : start + chunk_rows]
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        out[start : start + chunk_rows] = (
            assign_chunk(centroids, chunk.to(dev).contiguous()).cpu().numpy()
        )
    return out
