"""Port exec planner against the JAX package: `seed_ms`, `CostModel` and
`ExecPlanner` decide alike on the same feature and observation sequence;
a `Node(exec_batcher=False)` routes `track_total_hits: false` searches
between the device and the block-max backends with hits equal to the JAX
node's; and the `exec_batcher` / `exec_planner` switches each take
effect. Tolerance: none (decisions, EWMA tables, hit ids and fp32 score
bits equal).
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.exec.cost import CostModel as JCostModel
from elasticsearch_tpu.exec.cost import PlanFeatures as JPlanFeatures
from elasticsearch_tpu.exec.cost import coalesce_wins as jcoalesce_wins
from elasticsearch_tpu.exec.cost import seed_ms as jseed_ms
from elasticsearch_tpu.exec.planner import ExecPlanner as JExecPlanner
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu_torch.exec.cost import (
    CostModel,
    PlanFeatures,
    coalesce_wins,
    seed_ms,
)
from elasticsearch_tpu_torch.exec.planner import ExecPlanner
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.query.dsl import parse_query

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

BACKENDS = ("device", "blockmax", "blockmax_conj", "device_batched", "custom")
SPECS = [
    ("terms", "body", 32, 4),
    ("terms", "body", 8, 2),
    ("bool", (("terms", "body", 16, 2),), (), (("terms_const", "body", 64, 1),),
     (), -1, -1),
    ("match_all",),
]


def _feats(rng):
    return dict(
        n_docs=int(rng.integers(0, 3_000_000)),
        work_tiles=int(rng.choice([0, 8, 64, 1024])),
        n_clauses=int(rng.integers(1, 6)),
        n_shards=int(rng.integers(1, 9)),
    )


@pytest.mark.parametrize("seed", range(4))
def test_seed_ms_and_coalesce_wins_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        f = _feats(rng)
        for backend in BACKENDS:
            assert seed_ms(backend, PlanFeatures(**f)) == jseed_ms(
                backend, JPlanFeatures(**f)
            ), (backend, f)
    for tiles in (-5, 0, 100, 2250, 2251, 10_000):
        assert coalesce_wins(tiles) == jcoalesce_wins(tiles)


CANDIDATE_SETS = [
    ["device", "blockmax"],
    ["device", "blockmax_conj"],
    ["device"],
    ["device", "device_batched", "custom"],
]


@pytest.mark.parametrize("seed", range(3))
def test_planner_decisions_equal_reference(seed):
    """Drive both planners through one random sequence of (class,
    candidates, features) decisions, each followed by the same latency
    sample for the chosen backend: every decision, the decision counts
    and the EWMA tables are equal."""
    rng = np.random.default_rng(100 + seed)
    port, ref = ExecPlanner(), JExecPlanner()
    assert port.MIN_OBS == ref.MIN_OBS == 2
    chosen = set()
    for step in range(300):
        plan_class = port.classify(SPECS[int(rng.integers(len(SPECS)))],
                                   int(rng.choice([1, 10, 100])))
        assert plan_class == ref.classify(*plan_class)
        cands = CANDIDATE_SETS[int(rng.integers(len(CANDIDATE_SETS)))]
        f = _feats(rng) if rng.random() < 0.9 else None
        got = port.decide(plan_class, list(cands),
                          None if f is None else PlanFeatures(**f))
        want = ref.decide(plan_class, list(cands),
                          None if f is None else JPlanFeatures(**f))
        assert got == want, step
        chosen.add(got)
        seconds = float(rng.lognormal(-6, 1))
        if rng.random() < 0.1:
            port.note(got)
            ref.note(got)
        else:
            port.record(plan_class, got, seconds)
            ref.record(plan_class, got, seconds)
    assert {"device", "blockmax", "blockmax_conj"} <= chosen
    ref_counts = {b: c for b, c in ref.decisions.items() if c}
    assert {b: c for b, c in port.decisions.items() if c} == ref_counts
    assert port.stats()["ewma"] == ref.stats()["ewma"]
    assert port.stats()["decisions"] == port.decisions


def test_cost_model_lru_and_estimates_equal_reference():
    port, ref = CostModel(), JCostModel()
    rng = np.random.default_rng(9)
    for _ in range(700):  # past MAX_CLASSES: the oldest entries leave
        cls = (("terms", "body", int(rng.integers(0, 300)), 4), 10)
        backend = str(rng.choice(["device", "blockmax"]))
        sec = float(rng.random())
        port.observe(cls, backend, sec)
        ref.observe(cls, backend, sec)
    assert port.snapshot(limit=600) == ref.snapshot(limit=600)
    f = {"n_docs": 10_000, "work_tiles": 16}
    for t in range(300):
        cls = (("terms", "body", t, 4), 10)
        for backend in ("device", "blockmax"):
            assert port.observations(cls, backend) == ref.observations(cls, backend)
            assert port.predicted_ms(cls, backend, PlanFeatures(**f)) == (
                ref.predicted_ms(cls, backend, JPlanFeatures(**f)))
            assert port.predicted_ms(cls, backend, None) == ref.predicted_ms(
                cls, backend, None)


# ---------------------------------------------------------------------------
# The node: solo path routed by the planner
# ---------------------------------------------------------------------------

VOCAB = [f"w{i}" for i in range(240)]
MAPPINGS = {"mappings": {"properties": {"body": {"type": "text"}}}}
REPEATS = 4  # MIN_OBS = 2 explores both backends of every plan class


def _docs(n=3000):
    rng = np.random.default_rng(31)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    return [
        {"body": " ".join(rng.choice(VOCAB, int(rng.integers(6, 30)), p=probs))}
        for _ in range(n)
    ]


def _bodies():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):  # head-heavy disjunctions: wide worklists
        terms = [VOCAB[int(rng.integers(0, 4))]] + list(rng.choice(VOCAB[10:60], 3))
        out.append({"query": {"match": {"body": " ".join(terms)}}})
    for _ in range(3):  # must-led conjunctions with a head filter
        m1, m2 = rng.choice(VOCAB[10:60], 2, replace=False)
        out.append({"query": {"bool": {
            "must": [{"match": {"body": f"{m1} {m2}"}}],
            "filter": [{"term": {"body": VOCAB[int(rng.integers(0, 3))]}}],
        }}})
    return [{**b, "size": 10, "track_total_hits": False} for b in out]


def _view(out):
    return (
        "total" in out["hits"],
        [(h["_id"], np.float32(h["_score"]).view(np.int32).item())
         for h in out["hits"]["hits"]],
        out["hits"]["max_score"],
    )


def _bulk(node, docs):
    body = "".join(
        json.dumps({"index": {"_index": "docs", "_id": f"d{i}"}}) + "\n"
        + json.dumps(d) + "\n"
        for i, d in enumerate(docs)
    )
    out = node.bulk(body, refresh=True)
    assert not out["errors"]


@pytest.fixture(scope="module")
def jax_node():
    with pytest.MonkeyPatch.context() as mp:
        for key, val in {"ESTPU_EXEC_BATCHER": "0", "ESTPU_FILTER_CACHE": "0",
                         "ESTPU_EXEC_PACKED": "0", "ESTPU_MESH_SERVING": "0"}.items():
            mp.setenv(key, val)
        ref = JaxNode()
    ref.create_index("docs", MAPPINGS)
    _bulk(ref, _docs())
    return ref


def _port_node(**switches):
    # The filter cache off, as the reference fixture's ESTPU_FILTER_CACHE=0:
    # a masked plan is its own plan class, priced as `cached_mask`.
    node = Node(device="cpu", filter_cache=False, **switches)
    node.create_index("docs", MAPPINGS)
    _bulk(node, _docs())
    return node


def test_solo_node_explores_both_backends_with_reference_hits(jax_node):
    node = _port_node(exec_batcher=False)
    try:
        assert node.exec_batcher is None and node.exec_planner is not None
        specs = set()
        for body in _bodies():
            compiled = node.indices["docs"].engine.compiler_for(
                node.indices["docs"].engine.segments[0]
            ).compile(parse_query(body["query"]))
            specs.add(compiled.spec[0])
            want = _view(jax_node.search("docs", body))
            for _ in range(REPEATS):
                assert _view(node.search("docs", body)) == want, body
        decisions = node.exec_planner.stats()["decisions"]
        assert decisions["device"] > 0
        assert decisions["blockmax"] > 0 and decisions["blockmax_conj"] > 0
        assert decisions["device_batched"] == 0
        assert sum(decisions.values()) == REPEATS * len(_bodies())
        assert specs == {"terms", "bool"}
        # Every plan class was explored on both of its backends.
        for backends in node.exec_planner.stats()["ewma"].values():
            assert len(backends) == 2
            assert all(b["observations"] >= 2 for b in backends.values())
    finally:
        node.close()


def test_tracked_totals_stay_on_the_device(jax_node):
    node = _port_node(exec_batcher=False)
    try:
        for body in _bodies():
            tracked = {**body, "track_total_hits": True}
            out = node.search("docs", tracked)
            assert _view(out) == _view(jax_node.search("docs", tracked))
            assert out["hits"]["total"]["relation"] == "eq"
        decisions = node.exec_planner.decisions
        assert decisions["device"] == len(_bodies())
        assert decisions["blockmax"] == decisions["blockmax_conj"] == 0
    finally:
        node.close()


def test_exec_planner_false_takes_effect(jax_node):
    node = _port_node(exec_batcher=False, exec_planner=False)
    try:
        assert node.exec_planner is None
        assert node.indices["docs"].search.planner is None
        for body in _bodies():
            assert _view(node.search("docs", body)) == _view(
                jax_node.search("docs", body))
    finally:
        node.close()


def test_exec_batcher_switch_takes_effect(jax_node):
    """With the batcher (the default) untracked searches ride it, as in
    the reference, and the planner decides nothing; without it they take
    the solo path and the planner decides every one. A small index's
    search rides the packed group (the default), whose lone rider runs
    solo, so the planner decides it, as the reference's PackedExecutor
    does; `exec_packed=False` keeps the index's own batcher group."""
    on = _port_node(exec_packed=False)
    off = _port_node(exec_batcher=False)
    packed = _port_node()
    try:
        body = _bodies()[0]
        for node in (on, off, packed):
            assert _view(node.search("docs", body)) == _view(
                jax_node.search("docs", body))
        assert on.exec_batcher.stats()["requests"] == 1
        assert sum(on.exec_planner.decisions.values()) == 0
        assert sum(off.exec_planner.decisions.values()) == 1
        assert packed.exec_batcher.stats()["requests"] == 1
        assert sum(packed.exec_planner.decisions.values()) == 1
        assert packed.packed_exec.stats()["fallback_solo"] == 0
    finally:
        on.close()
        off.close()
        packed.close()


def test_sharded_index_never_takes_blockmax():
    """The coordinator compiles every shard with index-wide statistics, so
    its specs are terms_gather and never qualify for block-max: every
    shard decision is the device."""
    node = Node(device="cpu", exec_batcher=False, filter_cache=False)
    try:
        node.create_index("docs", {**MAPPINGS, "settings": {
            "index": {"number_of_shards": 3}}})
        _bulk(node, _docs(600))
        for body in _bodies():
            node.search("docs", body)
        decisions = node.exec_planner.decisions
        assert decisions["blockmax"] == decisions["blockmax_conj"] == 0
        assert decisions["device"] == 3 * len(_bodies())
    finally:
        node.close()
