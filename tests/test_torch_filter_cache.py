"""The port's filter cache (index/filter_cache.py) against the JAX package.

Mirrors tests/test_filter_cache.py: TestParityFuzz, TestAdmission,
TestEviction (LRU, stale purge), TestCrossRefreshReuse,
TestBatcherPlaneSharing, TestNormalization, TestCostAndPlanner and the
REST parts of TestRestAndObs. What is parity there (cached against
uncached on one package) is parity here against the JAX `Node` on the
same documents and bodies, made from numpy seeds: a port node with its
cache, a port `Node(filter_cache=False)` and the JAX node with its cache
must give equal responses, whole JSON but `took` (ids, order, fp32
scores, totals and `_shards`), and the two caches equal `stats()` counts
after the same request sequence. Also: `compute_filter_mask_stacked`
and stacked `execute_shards` with [S, N] planes against the JAX
package's vmaps, `ShardedIndex` and the mesh view with the cache
(`[cpu] * 3`), the sparse route the cache opens, the knn filter's plane,
and `test_cached_planes_are_never_written`.

The JAX file's breaker, `_nodes/stats` / metrics, environment opt-out and
replicated-cluster tests have no port counterpart yet (the HBM breaker,
the metrics registry, `_nodes/stats` and clusters are not ported); the
opt-out is `Node(filter_cache=False)` here. Tolerance: none.
"""

import hashlib
import json
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.query.compile import (
    cacheable_filter_key as jcacheable_filter_key,
)
from elasticsearch_tpu.query.dsl import parse_query as jparse
from elasticsearch_tpu_torch.exec.batcher import MicroBatcher
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.filter_cache import (
    FilterCache,
    mask_group_token,
    mesh_cache_scope,
)
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.query.compile import (
    cacheable_filter_key,
    collect_cacheable_filters,
)
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.rest.server import RestServer
from elasticsearch_tpu_torch.search.service import SearchRequest, SearchService

torch.set_num_threads(1)

CPU = torch.device("cpu")
WORDS = [f"w{i}" for i in range(40)]
TAGS = ["red", "green", "blue", "teal"]
MAPPINGS = {
    "properties": {
        "title": {"type": "text"},
        "tag": {"type": "keyword"},
        "price": {"type": "long"},
    }
}
# The JAX node with its filter cache on (the default) and the switches
# the port leaves to their own tests off, so both nodes take the same
# paths: no planner routing, no packed group, no mesh for a host loop.
JAX_ENV = {"ESTPU_EXEC_PLANNER": "0", "ESTPU_EXEC_PACKED": "0",
           "ESTPU_MESH_SERVING": "0"}


def _doc(rng) -> dict:
    doc = {
        "title": " ".join(rng.choice(WORDS, 6)),
        "tag": str(rng.choice(TAGS)),
    }
    if rng.random() < 0.9:  # some docs miss the price (exists filters)
        doc["price"] = int(rng.integers(0, 100))
    return doc


def _rand_filter(rng) -> dict:
    kind = int(rng.integers(0, 5))
    if kind == 0:
        return {"term": {"tag": str(rng.choice(TAGS))}}
    if kind == 1:
        return {"terms": {"tag": [str(t) for t in
                                  rng.choice(TAGS, int(rng.integers(1, 3)),
                                             replace=False)]}}
    if kind == 2:
        lo = int(rng.integers(0, 80))
        return {"range": {"price": {"gte": lo, "lt": lo + 40}}}
    if kind == 3:
        return {"exists": {"field": "price"}}
    return {"bool": {"filter": [{"term": {"tag": str(rng.choice(TAGS))}}],
                     "must_not": [{"range": {"price": {"lt": 20}}}]}}


def _rand_body(rng) -> dict:
    """A random filtered bool body: scored musts, cacheable filters and
    exclusions; a quarter sorted by price (the solo path), the rest plain
    (the batched path)."""
    must = [{"match": {"title": " ".join(rng.choice(WORDS, int(rng.integers(1, 4)),
                                                    replace=False))}}]
    bool_q: dict = {"must": must,
                    "filter": [_rand_filter(rng)
                               for _ in range(int(rng.integers(1, 3)))]}
    if rng.random() < 0.3:
        bool_q["must_not"] = [_rand_filter(rng)]
    body: dict = {"query": {"bool": bool_q}, "size": 10}
    if rng.random() < 0.25:
        body["sort"] = [{"price": "desc"}]
    return body


def _bulk_lines(rng, ids) -> str:
    lines = []
    for i in ids:
        lines.append(json.dumps({"index": {"_id": str(i)}}))
        lines.append(json.dumps(_doc(rng)))
    return "\n".join(lines) + "\n"


def _jax_node(index: str, body: dict, **env) -> JaxNode:
    """The JAX node with one index, both made under `env` (the node reads
    some switches at index creation)."""
    with pytest.MonkeyPatch.context() as mp:
        for key, val in {**JAX_ENV, **env}.items():
            mp.setenv(key, val)
        node = JaxNode()
        node.create_index(index, body)
    return node


def _close(*nodes) -> None:
    for n in nodes:
        if isinstance(n, JaxNode):
            if n.exec_batcher is not None:
                n.exec_batcher.close()
        else:
            n.close()


def _strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "took"}


STAT_KEYS = ("entries", "bytes_resident", "hit_count", "miss_count",
             "admissions", "evictions", "mask_reuse")


def _counts(cache) -> dict:
    stats = cache.stats()
    return {k: stats[k] for k in STAT_KEYS}


class Nodes:
    """One index on three nodes: the port with its cache, the port without
    one, and the JAX node with its cache, fed the same writes."""

    def __init__(self, n_shards: int, min_freq: int = 2, seed: int = 7,
                 n_docs: int = 300, **port_kwargs):
        body = {"settings": {"index": {"number_of_shards": n_shards}},
                "mappings": MAPPINGS}
        self.cache = FilterCache(min_freq=min_freq)
        self.port = Node(device="cpu", exec_planner=False, exec_packed=False,
                         mesh_devices=[], filter_cache=self.cache,
                         **port_kwargs)
        self.plain = Node(device="cpu", exec_planner=False, exec_packed=False,
                          mesh_devices=[], filter_cache=False)
        self.ref = _jax_node("f", body,
                             ESTPU_FILTER_CACHE_MIN_FREQ=str(min_freq))
        self.nodes = (self.port, self.plain, self.ref)
        for n in (self.port, self.plain):
            n.create_index("f", body)
        rng = np.random.default_rng(seed)
        # Two segments per shard: two bulks, each refreshed.
        half = n_docs // 2
        self.bulk(_bulk_lines(rng, range(half)))
        self.bulk(_bulk_lines(rng, range(half, n_docs)))

    def bulk(self, body: str) -> None:
        for n in self.nodes:
            out = n.bulk(body, default_index="f", refresh=True)
            assert not out["errors"]

    def delete(self, doc_id: str) -> None:
        for n in self.nodes:
            n.delete_doc("f", doc_id)
            n.refresh("f")

    def answers(self, body: dict, plain: bool = True):
        """(port, uncached port or None, JAX) answers to one body."""
        port = _strip(self.port.search("f", json.loads(json.dumps(body))))
        want = (_strip(self.plain.search("f", json.loads(json.dumps(body))))
                if plain else None)
        ref = _strip(self.ref.search("f", json.loads(json.dumps(body)),
                                     request_cache=False))
        return port, want, ref

    def close(self) -> None:
        _close(*self.nodes)


# ---------------------------------------------------------------------------
# TestParityFuzz
# ---------------------------------------------------------------------------


class TestParityFuzz:
    @pytest.mark.parametrize("n_shards", [1, 3])
    def test_cached_vs_uncached_vs_jax_64_bodies(self, n_shards):
        """64 random filtered bodies, each sent three times (miss, admit,
        hit) to the port with its cache, once to the port without one and
        three times to the JAX node; an update and a delete, each
        refreshed, land mid-sequence. Every answer equals, and the two
        caches count alike."""
        t = Nodes(n_shards)
        try:
            rng = np.random.default_rng(11 + n_shards)
            wrng = np.random.default_rng(99)
            for i in range(64):
                if i == 21:  # update: docs enter and leave filters
                    t.bulk(_bulk_lines(wrng, range(0, 40, 3)))
                if i == 42:
                    for doc_id in ("1", "5", "8", "160"):
                        t.delete(doc_id)
                body = _rand_body(rng)
                for rep in range(3):
                    port, plain, ref = t.answers(body, plain=rep == 0)
                    assert port == ref, body
                    if plain is not None:
                        assert port == plain, body
            assert _counts(t.cache) == _counts(t.ref.filter_cache)
            stats = t.cache.stats()
            assert stats["admissions"] > 0 and stats["hit_count"] > 0
        finally:
            t.close()

    def test_sparse_route_flips_and_bits_do_not_move(self):
        """bool(must terms + range filter) runs dense on its first two
        sightings; once the range is cached the plan supports_sparse and
        runs K2. The same body three times gives identical pages, equal
        to the JAX node's."""
        t = Nodes(1)
        try:
            body = {"query": {"bool": {
                "must": [{"match": {"title": "w1 w2 w3"}}],
                "filter": [{"range": {"price": {"gte": 10, "lt": 70}}}],
            }}, "size": 10}
            svc = t.port.get_index("f").search
            handle = svc.engine.segments[0]
            req = SearchRequest.from_json(body)
            compiled = svc.engine.compiler_for(handle).compile(req.query)
            assert not tbd.supports_sparse(compiled.spec)
            pages = []
            for _ in range(3):
                port, plain, ref = t.answers(body)
                assert port == ref == plain
                pages.append(port)
            assert pages[0] == pages[1] == pages[2]
            seg_tree = tbd.segment_tree(handle.device)
            masked, masks = svc._apply_filter_cache(
                handle, req.query, compiled, seg_tree)
            assert masks and tbd.supports_sparse(masked.spec)
        finally:
            t.close()

    def test_masked_blockmax_conj_bit_exact(self):
        """A masked plan on the two-launch block-max conjunction equals the
        masked execute_auto (phase A's filter check and the exact launch
        both gather the plane), and its hits equal the unmasked plan's."""
        eng = _engine(600, seed=13, segments=1)
        svc = SearchService(eng, filter_cache=FilterCache(min_freq=1))
        handle = eng.segments[0]
        seg_tree = tbd.segment_tree(handle.device)
        rng = np.random.default_rng(13)
        checked = 0
        for _ in range(16):
            body = {"query": {"bool": {
                "must": [{"match": {"title": " ".join(rng.choice(WORDS, 2))}}],
                "filter": [
                    {"term": {"tag": str(rng.choice(TAGS))}},
                    {"range": {"price": {"gte": int(rng.integers(0, 50))}}},
                ],
            }}, "size": 10, "track_total_hits": False}
            req = SearchRequest.from_json(body)
            svc.search(SearchRequest.from_json(body))  # admit the planes
            compiled = eng.compiler_for(handle).compile(req.query)
            masked, masks = svc._apply_filter_cache(
                handle, req.query, compiled, seg_tree)
            if not masks or not tbd.supports_blockmax_conj(masked.spec):
                continue
            seg_m = {**seg_tree, "masks": masks}
            plan = tbd.plan_to_torch(masked.spec, masked.arrays, CPU)
            s_a, i_a, t_a = tbd.execute_auto(seg_m, masked.spec, plan, 10)
            s_b, i_b, t_b, _rel = tbd.execute_batch_blockmax_conj(
                seg_m, masked.spec, [masked.arrays], 10)
            s_u, i_u, _t_u = tbd.execute_auto(
                seg_tree, compiled.spec,
                tbd.plan_to_torch(compiled.spec, compiled.arrays, CPU), 10)
            assert np.array_equal(i_a.numpy(), i_b[0]), body
            assert np.array_equal(s_a.numpy().view(np.int32),
                                  s_b[0].view(np.int32)), body
            assert np.array_equal(i_a.numpy(), i_u.numpy()), body
            assert np.array_equal(s_a.numpy().view(np.int32),
                                  s_u.numpy().view(np.int32)), body
            assert int(t_b[0]) <= int(t_a)
            checked += 1
        assert checked > 0

    def test_parity_right_after_refresh_update_delete(self):
        """Writes and refreshes mint new segment handles, so the next
        search builds (or re-admits) its planes and stays equal to the
        uncached node and the JAX node."""
        t = Nodes(1, min_freq=1)
        try:
            body = {"query": {"bool": {
                "must": [{"match": {"title": "w1 w2 w3"}}],
                "filter": [{"term": {"tag": "red"}},
                           {"exists": {"field": "price"}}],
            }}, "size": 10}
            for _ in range(2):
                t.answers(body)
            t.bulk(json.dumps({"index": {"_id": "0"}}) + "\n" + json.dumps(
                {"title": "w1 w2 w3", "tag": "red", "price": 1}) + "\n")
            port, plain, ref = t.answers(body)
            assert port == plain == ref
            assert any(h["_id"] == "0" for h in port["hits"]["hits"])
            victim = port["hits"]["hits"][0]["_id"]
            t.delete(victim)
            port, plain, ref = t.answers(body)
            assert port == plain == ref
            assert all(h["_id"] != victim for h in port["hits"]["hits"])
            assert _counts(t.cache) == _counts(t.ref.filter_cache)
        finally:
            t.close()


def _engine(n_docs: int, seed: int, segments: int) -> Engine:
    rng = np.random.default_rng(seed)
    eng = Engine(Mappings.from_json(MAPPINGS), device="cpu")
    per_seg = max(1, n_docs // segments)
    for i in range(n_docs):
        eng.index(_doc(rng), str(i))
        if (i + 1) % per_seg == 0:
            eng.refresh()
    eng.refresh()
    return eng


def test_cached_planes_are_never_written():
    """Every plane the cache stores is hashed at store time; after a fuzz
    of solo, batched, sorted, sparse and coalesced traffic over them,
    every resident plane still hashes the same."""
    stored: dict = {}

    class Recording(FilterCache):
        def put(self, key, plane, nbytes, live_uids=None):
            stored[key] = (plane, _hash(plane))
            return super().put(key, plane, nbytes, live_uids=live_uids)

    cache = Recording(min_freq=1)
    node = Node(device="cpu", exec_packed=False, filter_cache=cache)
    try:
        node.create_index("f", {"mappings": MAPPINGS})
        rng = np.random.default_rng(3)
        node.bulk(_bulk_lines(rng, range(200)), default_index="f",
                  refresh=True)
        node.bulk(_bulk_lines(rng, range(200, 400)), default_index="f",
                  refresh=True)
        qrng = np.random.default_rng(4)
        bodies = [_rand_body(qrng) for _ in range(24)]
        for body in bodies * 2:
            node.search("f", json.loads(json.dumps(body)))
        _fan_out(node, "f", bodies, clients=8)
        svc = node.get_index("f").search
        reqs = [SearchRequest.from_json(b) for b in bodies
                if "sort" not in b]
        svc.search_many(reqs)
        for body in bodies:
            untracked = {**body, "track_total_hits": False}
            untracked.pop("sort", None)
            svc.search(SearchRequest.from_json(untracked))
        resident = set(cache.keys())
        assert resident
        for key in resident:
            plane, digest = stored[key]
            assert _hash(plane) == digest, key
    finally:
        node.close()


def _hash(plane) -> str:
    rows = plane if isinstance(plane, tuple) else (plane,)
    h = hashlib.sha256()
    for r in rows:
        h.update(r.cpu().numpy().tobytes())
    return h.hexdigest()


def _fan_out(node, index, bodies, clients: int):
    """Send `bodies` from `clients` threads; returns the answers in body
    order."""
    out: dict = {}
    errors: list = []

    def go(c):
        try:
            for j in range(c, len(bodies), clients):
                out[j] = _strip(node.search(index, json.loads(json.dumps(bodies[j]))))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    return [out[j] for j in range(len(bodies))]


# ---------------------------------------------------------------------------
# TestAdmission
# ---------------------------------------------------------------------------

ONE_FILTER = {"query": {"bool": {
    "must": [{"match": {"title": "w1"}}],
    "filter": [{"term": {"tag": "red"}}],
}}}
TWO_FILTERS = {"query": {"bool": {
    "must": [{"match": {"title": "w1 w2"}}],
    # One filter may win the lead fold (never substituted); the range is
    # the plane that is cached.
    "filter": [{"term": {"tag": "red"}}, {"range": {"price": {"gte": 5}}}],
}}}


class TestAdmission:
    def test_one_off_filters_never_admitted(self):
        eng = _engine(200, seed=1, segments=1)
        cache = FilterCache(min_freq=2)
        svc = SearchService(eng, filter_cache=cache)
        svc.search(SearchRequest.from_json(ONE_FILTER))
        assert cache.stats()["entries"] == 0  # one sighting: not admitted
        svc.search(SearchRequest.from_json(ONE_FILTER))
        assert cache.stats()["admissions"] == 1  # the second: stored
        hits = cache.stats()["hit_count"]
        svc.search(SearchRequest.from_json(ONE_FILTER))
        assert cache.stats()["hit_count"] == hits + 1

    def test_history_ring_bounds_frequency(self):
        cache = FilterCache(min_freq=2, history=4)
        cache.record([("term", "tag", "red")])
        for i in range(4):  # four other sightings roll the first off
            cache.record([("term", "tag", f"other{i}")])
        cache.record([("term", "tag", "red")])
        assert not cache.should_admit(("term", "tag", "red"))

    def test_min_freq_one_admits_immediately(self):
        cache = FilterCache(min_freq=1)
        cache.record([("exists", "price")])
        assert cache.should_admit(("exists", "price"))

    def test_duplicate_clauses_in_one_request_count_one_sighting(self):
        eng = _engine(200, seed=2, segments=1)
        cache = FilterCache(min_freq=2)
        svc = SearchService(eng, filter_cache=cache)
        body = {"query": {"bool": {
            "must": [{"match": {"title": "w1"}}],
            "filter": [{"term": {"tag": "red"}}, {"term": {"tag": "red"}}],
        }}}
        svc.search(SearchRequest.from_json(body))
        assert not cache.should_admit(("term", "tag", "red"))
        assert cache.stats()["entries"] == 0

    def test_sharded_scatter_counts_one_sighting_per_request(self):
        """An n-shard scatter is one user request: the coordinator records
        once, the per-shard passes do not."""
        from elasticsearch_tpu_torch.search.coordinator import (
            ShardedSearchCoordinator,
        )

        engines = [_engine(60, seed=s, segments=1) for s in (1, 2, 3)]
        cache = FilterCache(min_freq=2)
        coord = ShardedSearchCoordinator(engines, filter_cache=cache)
        coord.search(SearchRequest.from_json(ONE_FILTER))
        assert cache.stats()["entries"] == 0
        assert not cache.should_admit(("term", "tag", "red"))
        coord.search(SearchRequest.from_json(ONE_FILTER))
        assert cache.stats()["admissions"] >= 1
        # The batched scatter counts one sighting per rider too.
        cache2 = FilterCache(min_freq=2)
        coord2 = ShardedSearchCoordinator(engines, filter_cache=cache2)
        coord2.search_many([SearchRequest.from_json(ONE_FILTER)])
        assert not cache2.should_admit(("term", "tag", "red"))

    def test_knn_filter_plane_is_admitted_and_served(self):
        """A filtered knn records its filter's sighting once per request;
        from the second sighting its plane comes from the cache, and the
        answers equal the uncached node's and count like the JAX node's."""
        mappings = {"properties": {
            "vec": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
            "tag": {"type": "keyword"},
        }}
        body = {"mappings": mappings}
        rng = np.random.default_rng(31)
        lines = []
        for i in range(120):
            lines.append(json.dumps({"index": {"_id": str(i)}}))
            lines.append(json.dumps({
                "vec": [float(x) for x in rng.standard_normal(4)],
                "tag": str(rng.choice(TAGS)),
            }))
        bulk = "\n".join(lines) + "\n"
        cache = FilterCache(min_freq=2)
        port = Node(device="cpu", exec_planner=False, ann_cache=False,
                    filter_cache=cache)
        plain = Node(device="cpu", exec_planner=False, ann_cache=False,
                     filter_cache=False)
        ref = _jax_node("v", body, ESTPU_ANN="0")
        try:
            for n in (port, plain):
                n.create_index("v", body)
            for n in (port, plain, ref):
                assert not n.bulk(bulk, default_index="v", refresh=True)["errors"]
            knn = {"knn": {"field": "vec", "query_vector": [0.5, -0.2, 0.1, 0.9],
                           "k": 5, "num_candidates": 20,
                           "filter": {"term": {"tag": "red"}}}}
            for _ in range(3):
                a = _strip(port.search("v", json.loads(json.dumps(knn))))
                b = _strip(plain.search("v", json.loads(json.dumps(knn))))
                ref.search("v", json.loads(json.dumps(knn)), request_cache=False)
                assert a == b
            stats = cache.stats()
            assert stats["admissions"] == 1 and stats["hit_count"] == 1
            assert _counts(cache) == _counts(ref.filter_cache)
        finally:
            _close(port, plain, ref)


# ---------------------------------------------------------------------------
# TestEviction
# ---------------------------------------------------------------------------


def _plane(n: int = 64) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.bool)


class TestEviction:
    def test_lru_eviction_order(self):
        cache = FilterCache(max_bytes=200)
        a, b, c = ("k", "a"), ("k", "b"), ("k", "c")
        cache.put((1, 0, 0, a), _plane(), 80)
        cache.put((1, 0, 0, b), _plane(), 80)
        assert cache.get((1, 0, 0, a)) is not None  # touch a: b is LRU
        cache.put((1, 0, 0, c), _plane(), 80)
        assert cache.get((1, 0, 0, b)) is None
        assert cache.get((1, 0, 0, a)) is not None
        assert cache.get((1, 0, 0, c)) is not None
        assert cache.stats()["evictions"] == 1

    def test_budget_declines_a_plane_larger_than_itself(self):
        cache = FilterCache(max_bytes=100)
        assert cache.put((1, 0, 0, ("k", "a")), _plane(), 100)
        assert not cache.put((1, 0, 0, ("k", "b")), _plane(), 500)
        assert cache.stats()["entries"] == 1
        assert cache.clear() == 1
        assert cache.stats()["bytes_resident"] == 0

    def test_stale_generation_purged_on_store(self):
        cache = FilterCache()
        cache.put((1, 3, 10, ("k", "a")), _plane(), 64)
        cache.put((1, 4, 11, ("k", "a")), _plane(), 64)  # a newer generation
        assert cache.get((1, 3, 10, ("k", "a"))) is None
        assert cache.get((1, 4, 11, ("k", "a"))) is not None

    def test_purge_scope_keeps_live_rows(self):
        cache = FilterCache()
        scope = ("sharded", (1, 2))
        live, dead = ("row", 0, ((5, 0),), 128), ("row", 1, ((6, 0),), 128)
        cache.put((scope, live, 0, ("k",)), _plane(), 64)
        cache.put((scope, dead, 0, ("k",)), _plane(), 64)
        cache.put((7, 0, 9, ("k",)), _plane(), 64)
        assert cache.purge_scope(scope, {live}) == 1
        assert set(cache.keys()) == {(scope, live, 0, ("k",)), (7, 0, 9, ("k",))}

    def test_small_budget_evicts_and_answers_stay_equal(self):
        """A budget of three planes under many distinct filters: evictions
        happen, residency stays within the budget, and every answer still
        equals the uncached node's and the JAX node's (same budget)."""
        t = Nodes(1, min_freq=1)
        try:
            handle_docs = t.port.get_index("f").engines[0].segments[0]
            plane_bytes = handle_docs.device.live.numel()
            budget = 3 * plane_bytes
            t.cache.max_bytes = budget
            t.ref.filter_cache.max_bytes = budget
            rng = np.random.default_rng(5)
            for _ in range(12):
                body = _rand_body(rng)
                for _rep in range(2):
                    port, plain, ref = t.answers(body)
                    assert port == plain == ref
                assert t.cache.stats()["bytes_resident"] <= budget
            assert t.cache.stats()["evictions"] > 0
            assert _counts(t.cache) == _counts(t.ref.filter_cache)
        finally:
            t.close()


# ---------------------------------------------------------------------------
# TestCrossRefreshReuse
# ---------------------------------------------------------------------------

RANGE_BODY = {"query": {"bool": {
    "must": [{"match": {"title": "w1 w2 w3"}}],
    "filter": [{"range": {"price": {"gte": 10, "lt": 90}}}],
}}}


class TestCrossRefreshReuse:
    def test_planes_survive_refresh_of_other_segments(self):
        """Solo keys scope on the segment-handle uid: a refresh that only
        adds a segment leaves the existing planes resident and serving."""
        eng = _engine(200, seed=11, segments=1)
        cache = FilterCache(min_freq=1)
        svc = SearchService(eng, filter_cache=cache)
        svc.search(SearchRequest.from_json(RANGE_BODY))
        assert cache.stats()["admissions"] >= 1
        keys_before = set(cache.keys())
        rng = np.random.default_rng(99)
        for i in range(20):
            eng.index(_doc(rng), f"new{i}")
        eng.refresh()
        hits = cache.stats()["hit_count"]
        svc.search(SearchRequest.from_json(RANGE_BODY))
        assert keys_before <= set(cache.keys())
        assert cache.stats()["hit_count"] > hits

    def test_dead_handle_planes_pruned_on_store_and_refresh(self):
        """A plane whose segment handle is no longer live is dropped on the
        next store of its scope (`live_uids`) and by the node's refresh
        (`prune_dead`); the port has no merges, so the handle is retired
        by hand here."""
        cache = FilterCache()
        cache.put((1, 0, 10, ("k", "a")), _plane(), 64)
        cache.put((1, 0, 11, ("k", "a")), _plane(), 64, live_uids={11})
        assert cache.keys() == [(1, 0, 11, ("k", "a"))]
        node = Node(device="cpu", filter_cache=FilterCache(min_freq=1))
        try:
            node.create_index("f", {"mappings": MAPPINGS})
            rng = np.random.default_rng(6)
            node.bulk(_bulk_lines(rng, range(100)), default_index="f",
                      refresh=True)
            node.search("f", json.loads(json.dumps(RANGE_BODY)))
            assert node.filter_cache.stats()["entries"] == 1
            engine = node.get_index("f").engines[0]
            engine.segments.clear()  # the handle retires
            node.refresh("f")
            assert node.filter_cache.stats()["entries"] == 0
        finally:
            node.close()


# ---------------------------------------------------------------------------
# TestBatcherPlaneSharing
# ---------------------------------------------------------------------------


class TestBatcherPlaneSharing:
    BODIES = [
        {"query": {"bool": {
            "must": [{"match": {"title": f"w{j} w9"}}],
            "filter": [{"term": {"tag": "red"}},
                       {"range": {"price": {"gte": 5}}}],
        }}, "size": 5}
        for j in range(4)
    ]

    def test_coalesced_batchmates_share_one_plane(self):
        """Four same-filter batchmates in one search_many use one plane per
        filter (one entry each, reuse counted per lane), ride one launch
        group per spec, and each answer equals its solo run."""
        eng = _engine(300, seed=17, segments=1)
        cache = FilterCache(min_freq=1)
        svc = SearchService(eng, filter_cache=cache)
        plain = SearchService(eng)
        svc.search_many([SearchRequest.from_json(b) for b in self.BODIES])
        entries = cache.stats()["entries"]
        assert 1 <= entries <= 2  # the term may lead; never one per lane
        reuse = cache.stats()["mask_reuse"]
        many = svc.search_many([SearchRequest.from_json(b) for b in self.BODIES])
        assert cache.stats()["mask_reuse"] >= reuse + 4 * entries
        assert cache.stats()["entries"] == entries
        handle = eng.segments[0]
        seg_tree = tbd.segment_tree(handle.device)
        tokens = set()
        for b in self.BODIES:
            req = SearchRequest.from_json(b)
            compiled = eng.compiler_for(handle).compile(req.query)
            _m, masks = svc._apply_filter_cache(handle, req.query, compiled,
                                               seg_tree)
            tokens.add(mask_group_token(masks))
        assert len(tokens) == 1 and tokens != {()}
        for m, b in zip(many, self.BODIES):
            s = plain.search(SearchRequest.from_json(b))
            assert m.to_json() == {**s.to_json(), "took": m.took_ms}

    def test_concurrent_clients_coalesce_over_shared_planes(self):
        """16 clients through the micro-batcher: launches coalesce over the
        shared planes, and every answer equals the JAX node's."""
        t = Nodes(1, min_freq=1)
        try:
            t.port.exec_batcher.close()
            t.port.exec_batcher = MicroBatcher(max_wait_s=0.05)
            bodies = [json.loads(json.dumps(b)) for b in self.BODIES] * 8
            for b in self.BODIES:  # admit
                t.answers(b)
            got = _fan_out(t.port, "f", bodies, clients=16)
            for body, out in zip(bodies, got):
                ref = _strip(t.ref.search("f", json.loads(json.dumps(body)),
                                          request_cache=False))
                assert out == ref
            assert t.port.exec_batcher.stats()["occupancy_max"] >= 2
        finally:
            t.close()

    def test_failed_launch_retry_records_no_second_sighting(self):
        eng = _engine(200, seed=19, segments=1)
        cache = FilterCache(min_freq=2)
        svc = SearchService(eng, filter_cache=cache)
        req = SearchRequest.from_json(RANGE_BODY)
        key = collect_cacheable_filters(req.query)[0][2]
        svc.search_many([req])  # the coalesced attempt: one sighting
        svc.search(req, record_filter_usage=False)  # the batcher's retry
        assert not cache.should_admit(key)
        assert cache.stats()["entries"] == 0

    def test_batcher_retry_passes_record_false(self):
        seen = []

        class Searcher:
            def search_many(self, requests):
                return [RuntimeError("launch failed") for _ in requests]

            def search(self, request, record_filter_usage=True):
                seen.append(record_filter_usage)
                return "solo"

        batcher = MicroBatcher(max_wait_s=0.0)
        try:
            assert batcher.execute(Searcher(), "r") == "solo"
        finally:
            batcher.close()
        assert seen == [False]


# ---------------------------------------------------------------------------
# TestNormalization
# ---------------------------------------------------------------------------

KEY_BODIES = [
    {"terms": {"tag": ["red", "blue"]}},
    {"terms": {"tag": ["blue", "red"], "boost": 3.0}},
    {"term": {"tag": "red"}},
    {"range": {"price": {"gte": 5, "lt": 9}}},
    {"exists": {"field": "price"}},
    {"constant_score": {"filter": {"term": {"tag": "red"}}}},
    {"bool": {"filter": [{"term": {"tag": "red"}}],
              "must_not": [{"range": {"price": {"lt": 10}}}]}},
    {"bool": {"should": [{"term": {"tag": "red"}}, {"term": {"tag": "teal"}}],
              "minimum_should_match": 1}},
    {"match": {"title": "x"}},
    {"match_phrase": {"title": "a b"}},
    {"terms": {"tag": []}},
]


class TestNormalization:
    def test_boost_and_order_insensitive(self):
        q1 = parse_query({"terms": {"tag": ["red", "blue"]}})
        q2 = parse_query({"terms": {"tag": ["blue", "red"], "boost": 3.0}})
        assert cacheable_filter_key(q1) == cacheable_filter_key(q2)

    def test_statistics_dependent_shapes_refused(self):
        assert cacheable_filter_key(parse_query({"match": {"title": "x"}})) is None
        assert cacheable_filter_key(
            parse_query({"match_phrase": {"title": "a b"}})) is None

    def test_pure_filter_bool_composite_cacheable(self):
        q = parse_query({"bool": {
            "filter": [{"term": {"tag": "red"}}],
            "must_not": [{"range": {"price": {"lt": 10}}}],
        }})
        assert cacheable_filter_key(q) is not None

    def test_collect_targets_top_level_filter_context_only(self):
        q = parse_query({"bool": {
            "must": [{"term": {"tag": "red"}}],
            "filter": [{"term": {"tag": "blue"}}, {"match": {"title": "x"}}],
            "must_not": [{"exists": {"field": "price"}}],
        }})
        groups = {(g, i) for g, i, _k in collect_cacheable_filters(q)}
        assert groups == {("filter", 0), ("must_not", 0)}

    @pytest.mark.parametrize("body", KEY_BODIES)
    def test_keys_equal_the_reference(self, body):
        assert cacheable_filter_key(parse_query(body)) == \
            jcacheable_filter_key(jparse(body))


# ---------------------------------------------------------------------------
# TestCostAndPlanner
# ---------------------------------------------------------------------------


class TestCostAndPlanner:
    def test_cached_mask_backend_registered_and_seeded(self):
        from elasticsearch_tpu_torch.exec.cost import PlanFeatures, seed_ms
        from elasticsearch_tpu_torch.exec.planner import ExecPlanner

        assert "cached_mask" in ExecPlanner.BACKENDS
        full = seed_ms("device", PlanFeatures(n_docs=1_000_000, work_tiles=4096))
        masked = seed_ms("cached_mask",
                         PlanFeatures(n_docs=1_000_000, work_tiles=256))
        assert masked < full and np.isfinite(masked)

    def test_planner_counts_cached_mask_decisions(self):
        from elasticsearch_tpu_torch.exec.planner import ExecPlanner

        eng = _engine(200, seed=23, segments=1)
        planner = ExecPlanner()
        svc = SearchService(eng, planner=planner,
                            filter_cache=FilterCache(min_freq=1))
        for _ in range(4):
            svc.search(SearchRequest.from_json(TWO_FILTERS))
        assert planner.decisions.get("cached_mask", 0) > 0


# ---------------------------------------------------------------------------
# TestRestAndObs (the REST parts)
# ---------------------------------------------------------------------------


@pytest.fixture()
def rest_node():
    node = Node(device="cpu")
    node.create_index("idx", {"mappings": MAPPINGS})
    rng = np.random.default_rng(9)
    node.bulk(_bulk_lines(rng, range(200)), default_index="idx", refresh=True)
    yield node
    node.close()


class TestRestAndObs:
    def test_cache_clear_api_reports_counts(self, rest_node):
        rest = RestServer(rest_node)
        for _ in range(3):
            status, _ = rest.dispatch("POST", "/idx/_search", {},
                                      json.dumps(TWO_FILTERS))
            assert status == 200
        assert rest_node.filter_cache.stats()["entries"] > 0
        status, out = rest.dispatch("POST", "/idx/_cache/clear", {}, "")
        assert status == 200
        assert out["cleared"]["filter_cache"] >= 1
        assert out["_shards"] == {"total": 1, "successful": 1, "failed": 0}
        assert set(out["cleared"]) == {"filter_cache", "request_cache", "ann"}
        assert rest_node.filter_cache.stats()["entries"] == 0
        status, out = rest.dispatch("POST", "/_cache/clear", {}, "")
        assert status == 200 and out["cleared"]["filter_cache"] == 0
        assert rest.dispatch("POST", "/nope/_cache/clear", {}, "")[0] == 404
        assert rest.dispatch("POST", "/idx,nope/_cache/clear", {}, "")[0] == 404
        status, out = rest.dispatch("POST", "/nomatch*/_cache/clear", {}, "")
        assert status == 200 and out["_shards"]["total"] == 0
        # A miss after the clear is still correct.
        status, after = rest.dispatch("POST", "/idx/_search", {},
                                      json.dumps(TWO_FILTERS))
        plain = Node(device="cpu", filter_cache=False)
        try:
            plain.create_index("idx", {"mappings": MAPPINGS})
            rng = np.random.default_rng(9)
            plain.bulk(_bulk_lines(rng, range(200)), default_index="idx",
                       refresh=True)
            want = plain.search("idx", json.loads(json.dumps(TWO_FILTERS)))
        finally:
            plain.close()
        assert _strip(after) == _strip(want)

    def test_delete_index_drops_planes(self, rest_node):
        for _ in range(3):
            rest_node.search("idx", json.loads(json.dumps(TWO_FILTERS)))
        assert rest_node.filter_cache.stats()["entries"] > 0
        rest_node.delete_index("idx")
        assert rest_node.filter_cache.stats()["entries"] == 0
        assert rest_node.filter_cache.stats()["bytes_resident"] == 0

    def test_opt_out(self):
        node = Node(device="cpu", filter_cache=False)
        try:
            assert node.filter_cache is None
            node.create_index("idx", {"mappings": MAPPINGS})
            assert node.get_index("idx").search.filter_cache is None
            out = node.clear_cache()
            assert out["cleared"]["filter_cache"] == 0
            assert FilterCache.disabled_stats()["enabled"] is False
        finally:
            node.close()
