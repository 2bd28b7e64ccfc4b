"""Port painless-lite and script_score against the JAX package.

The same numpy-seeded columns, scores and params go through the JAX
package's `compile_script(...).evaluate(np | jnp, ...)` and the port's
torch evaluation (the plain version of K6); `_eval_script` (with boost
and min_score) through the JAX package's `execute_dense` / `execute` and
the port's on identical planes and plans; and `script_score` requests
through both nodes over REST.

Tolerances, stated per test:
- EXACT: fp32 bits equal (compared as int32; a NaN matches a NaN, whose
  payload no two CPU libraries agree on) — a script of arithmetic,
  comparisons, selects, abs, floor, ceil, min and max against the numpy
  evaluation;
- ULPS: the `ranked_match` rule of bench.py (ulps = 4, this file's own
  copy): values within 4 ulps, NaN where the other is NaN, and for a
  top-k the same doc set with any reordering only among near-ties. XLA
  contracts multiply-adds into FMAs and its log/exp/pow, like torch's
  CPU kernels (sqrt too), round differently from numpy's, so every script value
  held to the JAX package (and a transcendental one held to numpy) is
  held by this rule. Ids, order and totals of non-script queries stay
  exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine
from elasticsearch_tpu.index.mapping import Mappings
from elasticsearch_tpu.node import Node as JaxNode
from elasticsearch_tpu.ops import bm25_device as jbd
from elasticsearch_tpu.query.dsl import parse_query
from elasticsearch_tpu.script import compile_script as ref_compile
from elasticsearch_tpu_torch.index.tiles import device_segment_from_numpy, field_meta
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import bm25_device as tbd
from elasticsearch_tpu_torch.ops import script_kernel
from elasticsearch_tpu_torch.script import compile_script
from elasticsearch_tpu_torch.script.painless_lite import TorchBackend, boosted, lower

torch.set_num_threads(1)

N = 257
JAX_ENV = {
    "ESTPU_MESH_SERVING": "0",
    "ESTPU_EXEC_PLANNER": "0",
    "ESTPU_FILTER_CACHE": "0",
    "ESTPU_EXEC_PACKED": "0",
}


def ulp_close(a, b, ulps: int = 4) -> bool:
    """bench.py's ulp_close, with NaN equal to NaN and equal values
    (infinities included) equal."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return False
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if not np.array_equal(nan_a, nan_b):
        return False
    a, b = a[~nan_a], b[~nan_b]
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    with np.errstate(invalid="ignore"):
        near = np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol
    return bool(np.all(near | (a == b)))


def same_bits(a, b) -> bool:
    """EXACT: fp32 bits equal, a NaN matching a NaN (torch's CPU minimum
    and numpy's return NaNs of other payloads)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    return a.shape == b.shape and np.array_equal(nan_a, nan_b) and np.array_equal(
        _bits(a[~nan_a]), _bits(b[~nan_b]))


def ranked_match(ids, scores, o_ids, o_scores, ulps: int = 4) -> bool:
    """bench.py's ranked_match: the same doc set, scores within `ulps` at
    every rank, and a doc at another rank only where the oracle's scores
    at the two ranks are within `ulps` of each other."""
    n = len(o_ids)
    ids = [int(x) for x in ids[:n]]
    if sorted(ids) != sorted(int(x) for x in o_ids):
        return False
    if not ulp_close(np.asarray(scores)[:n], o_scores, ulps):
        return False
    by_id = {int(i): np.float32(s) for i, s in zip(o_ids, o_scores)}
    return all(
        did == int(o_ids[rank])
        or ulp_close(by_id[did], np.float32(o_scores[rank]), ulps)
        for rank, did in enumerate(ids)
    )


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(41)
    f1 = rng.random(N, dtype=np.float32)
    f2 = (rng.random(N, dtype=np.float32) * 4 - 2).astype(np.float32)
    f3 = f1.copy()
    f3[::10] = np.nan
    f2[5] = 0.0
    score = (rng.random(N, dtype=np.float32) * 10).astype(np.float32)
    params = {"a": np.float32(0.3), "b": np.float32(-1.25), "p": np.float32(1.7),
              "c": np.float32(4.0)}
    return score, {"f1": f1, "f2": f2, "f3": f3}, params


# (source, tolerance against numpy): every grammar node at least once.
SCRIPTS = [
    ("params.a * _score + params.b * doc['f1'].value + 2 * doc['f2'].value", "exact"),
    ("_score - doc['f2'].value / 3", "exact"),
    ("-doc['f2'].value + +_score", "exact"),
    ("return _score * 1.5;", "exact"),
    ("Math.abs(doc['f2'].value) + Math.floor(_score) - Math.ceil(doc['f1'].value)", "exact"),
    ("Math.sqrt(_score + 1) * doc['f1'].value", "ulps"),  # torch's CPU sqrt
    ("Math.min(doc['f3'].value, 0.5) + Math.max(_score, params.c)", "exact"),
    ("doc['f2'].value > 0 ? _score : doc['f1'].value", "exact"),
    ("doc['f2'].value >= 0.5 ? 1 : 0", "exact"),
    ("doc['f1'].value < 0.3 ? params.a : params.b", "exact"),
    ("doc['f2'].value <= 0 ? _score * 2 : _score", "exact"),
    ("doc['f2'].value == 0 ? 7 : doc['f2'].value != 1 ? 1 : 2", None),  # refused: nested
    ("doc['f3'].empty ? -1 : doc['f3'].value * 2", "exact"),
    ("where(doc['f2'].value > 0, doc['f1'].value, -doc['f1'].value) * 3", "exact"),
    ("saturation(_score, 2)", "exact"),
    ("Math.E * Math.PI / 7 + _score", "exact"),
    ("(2 + 3) * 0.1 * _score", "exact"),
    ("true ? _score : 0", "exact"),
    ("params['a'] * doc['f1'].value", "exact"),
    ("doc['f2'].value % 0.7 + _score % 3", "ulps"),  # numpy signs a zero remainder
    ("Math.log(doc['f1'].value + 1) + Math.log10(_score + 1)", "ulps"),
    ("Math.exp(-doc['f1'].value) + Math.pow(doc['f1'].value, params.p)", "ulps"),
    ("sigmoid(doc['f2'].value) * _score", "ulps"),
    ("_score ** 2 + doc['f1'].value ** 0.5", "ulps"),
    ("Math.log(doc['f2'].value)", "ulps"),  # NaN for negatives
]


def _port_eval(src, score, cols, params):
    out = compile_script(src).evaluate(
        torch.from_numpy(score),
        {k: torch.from_numpy(v) for k, v in cols.items()},
        {k: torch.tensor(v) for k, v in params.items()},
    )
    return np.broadcast_to(out.numpy(), score.shape).astype(np.float32)


def _ref_eval(xp, src, score, cols, params):
    out = ref_compile(src).evaluate(
        xp, xp.asarray(score), {k: xp.asarray(v) for k, v in cols.items()},
        {}, {k: xp.asarray(v) for k, v in params.items()},
    )
    return np.broadcast_to(np.asarray(out, dtype=np.float32), score.shape)


@pytest.mark.parametrize("src,tol", [s for s in SCRIPTS if s[1] is not None])
def test_evaluate_matches_reference(inputs, src, tol):
    """EXACT or ULPS against numpy, as SCRIPTS states; ULPS against jnp."""
    score, cols, params = inputs
    got = _port_eval(src, score, cols, params)
    want_np = _ref_eval(np, src, score, cols, params)
    if tol == "exact":
        assert same_bits(got, want_np), src
    else:
        assert ulp_close(got, want_np), src
    assert ulp_close(got, _ref_eval(jnp, src, score, cols, params)), src


@pytest.mark.parametrize(
    "src",
    [
        "doc['f2'].value == 0 ? 7 : doc['f2'].value != 1 ? 1 : 2",
        "_score +",
        "lambda x: x",
        "__import__('os')",
        "foo(_score)",
        "Math.random()",
        "(1.0).__class__",
        "doc[params.a].value",
        "doc['f1'].size",
        "params._secret",
    ],
)
def test_refused_scripts_match_reference(src):
    """EXACT: the same ValueError message as the reference's compiler."""
    with pytest.raises(ValueError) as ref_err:
        ref_compile(src)
    with pytest.raises(ValueError) as port_err:
        compile_script(src)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("fn", ["cosineSimilarity", "dotProduct", "l2norm"])
def test_vector_functions_are_refused_until_knn(fn):
    """The vector functions compile since the port serves dense_vector
    fields (tests/test_torch_knn_service.py evaluates them); over docs
    without the dense_vector field they are refused with the reference's
    message (EXACT)."""
    src = f"{fn}(params.qv, 'vec') + 1.0"
    script = compile_script(src)
    with pytest.raises(ValueError) as ref_err:
        ref_compile(src).evaluate(np, np.ones(3, np.float32), {}, {},
                                  {"qv": [1.0, 2.0]})
    with pytest.raises(ValueError) as port_err:
        tbd.vector_planes(script, {}, {"qv": torch.ones((1, 2))})
    assert str(port_err.value) == str(ref_err.value)


def test_evaluate_errors_match_reference(inputs):
    """EXACT: a missing param or doc-values field raises the reference's
    message."""
    score, cols, params = inputs
    for src in ("params.nope * _score", "doc['nope'].value + 1"):
        with pytest.raises(ValueError) as ref_err:
            _ref_eval(np, src, score, cols, params)
        with pytest.raises(ValueError) as port_err:
            _port_eval(src, score, cols, params)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize(
    "src",
    [
        "doc['f3'].empty + doc['f3'].empty",
        "-doc['f3'].empty",
        "doc['f1'].value > 0.5 and _score > 1",
        "0 < doc['f1'].value < 0.5",
        "doc['f1'] * 2",
        "'text'",
    ],
)
def test_untypeable_scripts_raise_on_both_paths(inputs, src):
    """What the walk cannot type raises ValueError, in the plain version and
    in the generator alike (generating needs no triton)."""
    score, cols, params = inputs
    script = compile_script(src)
    with pytest.raises(ValueError):
        _port_eval(src, score, cols, params)
    with pytest.raises(ValueError):
        script_kernel.generate_source(script)


def test_script_eval_rows_and_stacked_shards_match_row_loop(inputs):
    """EXACT: K6's plain version over Q rows (and Q x S stacked rows)
    equals itself one row at a time."""
    score, cols, params = inputs
    script = compile_script(
        "params.a * _score + doc['f1'].value - where(doc['f3'].empty, 1, 0)"
    )
    rng = np.random.default_rng(5)
    q, s = 4, 2
    sc = torch.from_numpy(rng.random((q, N), dtype=np.float32))
    m = torch.from_numpy(rng.random((q, N)) < 0.7)
    a = torch.tensor([0.5, -1.0, 2.0, 0.0], dtype=torch.float32)
    boost = torch.tensor([1.0, 2.0, 0.5, 3.0], dtype=torch.float32)
    mins = torch.tensor([0.2, 0.0, 1.0, -5.0], dtype=torch.float32)
    stacked = {k: torch.from_numpy(np.stack([v, v[::-1].copy()])) for k, v in cols.items()}
    for cols_t, n_shards in (({k: torch.from_numpy(v) for k, v in cols.items()}, 0),
                             (stacked, s)):
        out_s, out_m = script_kernel.script_eval(
            script, sc, m, cols_t, {"a": a}, boost, mins, n_shards=n_shards)
        for r in range(q):
            row_cols = {k: (v[r % s] if n_shards else v) for k, v in cols_t.items()}
            rs, rm = script_kernel.script_eval(
                script, sc[r:r + 1], m[r:r + 1], row_cols, {"a": a[r:r + 1]},
                boost[r:r + 1], mins[r:r + 1])
            assert same_bits(out_s[r].numpy(), rs[0].numpy())
            assert torch.equal(out_m[r], rm[0])


# ---------------------------------------------------------------------------
# _eval_script on identical planes and plans
# ---------------------------------------------------------------------------


def _port_segment(handle):
    tree = jbd.segment_tree(handle.device)
    planes = {
        "fields": {n: tuple(np.asarray(x) for x in leaves)
                   for n, leaves in tree["fields"].items()},
        "doc_values": {n: np.asarray(c) for n, c in tree["doc_values"].items()},
        "live": np.asarray(tree["live"]),
    }
    meta = {n: field_meta(f) for n, f in handle.device.fields.items()}
    return device_segment_from_numpy(planes, meta, device="cpu")


VOCAB = [f"w{i}" for i in range(24)]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(9)
    eng = Engine(Mappings(properties={
        "body": {"type": "text"}, "f1": {"type": "float"},
        "f2": {"type": "float"},
    }))
    for i in range(300):
        doc = {"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 9)))),
               "f2": float(rng.random() * 2)}
        if i % 7:
            doc["f1"] = float(rng.random())
        eng.index(doc, f"d{i}")
    eng.refresh()
    for i in range(0, 300, 11):
        eng.delete(f"d{i}")
    eng.refresh()
    handle = eng.segments[0]
    return eng, handle, tbd.segment_tree(_port_segment(handle))


SCRIPT_QUERIES = [
    ({"match": {"body": "w1 w2 w3"}},
     "params.w0 * _score + params.w1 * doc['f1'].value + params.w2 * doc['f2'].value",
     {"w0": 0.3, "w1": 4.0, "w2": 2.0}, None, 1.0),
    ({"match": {"body": "w4 w5"}}, "_score * 2 - doc['f2'].value", {}, 1.5, 2.0),
    ({"match_all": {}}, "doc['f2'].value > 1 ? doc['f2'].value : 0", {}, 0.5, 1.0),
    ({"bool": {"should": [{"match": {"body": "w6"}}, {"match": {"body": "w7 w8"}}]}},
     "Math.log(_score + 1) + Math.sqrt(Math.abs(doc['f2'].value))", {}, None, 0.7),
]


def _script_body(child, src, params, min_score, boost):
    body = {"query": child, "script": {"source": src, "params": params},
            "boost": boost}
    if min_score is not None:
        body["min_score"] = min_score
    return {"script_score": body}


@pytest.mark.parametrize("case", range(len(SCRIPT_QUERIES)))
def test_eval_script_matches_reference(corpus, case):
    """ULPS against the JAX package (dense plane and top-k); matched masks
    and totals EXACT; EXACT against numpy for arithmetic scripts (the
    reference's numpy evaluation over the child's plane)."""
    eng, handle, ptree = corpus
    jtree = jbd.segment_tree(handle.device)
    child, src, params, min_score, boost = SCRIPT_QUERIES[case]
    c = eng.compiler_for(handle).compile(
        parse_query(_script_body(child, src, params, min_score, boost)))
    assert c.spec[0] == "script"
    plan = tbd.plan_to_torch(c.spec, c.arrays, "cpu")
    j_s, j_m = (np.asarray(x) for x in jbd.execute_dense(jtree, c.spec, c.arrays))
    p_s, p_m = (x.numpy() for x in tbd.execute_dense(ptree, c.spec, plan))
    assert np.array_equal(j_m, p_m)
    assert ulp_close(p_s, j_s)
    if "Math" not in src:
        # numpy: the child's plane (BM25 bits equal the port's) through the
        # reference's evaluate(np), then boost and min_score.
        cs, cm = (np.asarray(x) for x in jbd.execute_dense(
            jtree, c.spec[1], c.arrays["child"]))
        dv = {k: np.asarray(v) for k, v in jtree["doc_values"].items()}
        r = ref_compile(src).evaluate(
            np, cs, dv, {}, {k: np.float32(v) for k, v in params.items()})
        r = np.broadcast_to(np.asarray(r, np.float32), cs.shape)
        want = np.where(cm, (r * np.float32(boost)).astype(np.float32), np.float32(0))
        if min_score is not None:
            keep = cm & (want >= np.float32(min_score))
            want = np.where(keep, want, np.float32(0))
        want = np.where(p_m, want, np.float32(0)).astype(np.float32)
        assert same_bits(p_s, want)
    j_top = [np.asarray(x) for x in jbd.execute(jtree, c.spec, c.arrays, 10)]
    p_top = [x.numpy() for x in tbd.execute(ptree, c.spec, plan, 10)]
    assert int(j_top[2]) == int(p_top[2])
    n = min(10, int(j_top[2]))
    assert ranked_match(p_top[1][:n], p_top[0][:n], j_top[1][:n], j_top[0][:n])


# ---------------------------------------------------------------------------
# script_score through the nodes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nodes():
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
    port = Node(device="cpu")
    rng = np.random.default_rng(13)
    lines = []
    for i in range(240):
        doc = {"body": " ".join(rng.choice(VOCAB, int(rng.integers(2, 9)))),
               "f2": float(rng.random() * 2)}
        if i % 5:
            doc["f1"] = float(rng.random())
        lines += [json.dumps({"index": {"_id": f"n{i}"}}), json.dumps(doc)]
    for n in (port, ref):
        n.create_index("scripted", {"mappings": {"properties": {
            "body": {"type": "text"}, "f1": {"type": "float"},
            "f2": {"type": "float"}}}})
        n.bulk("\n".join(lines) + "\n", default_index="scripted", refresh=True)
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


@pytest.mark.parametrize("case", range(len(SCRIPT_QUERIES)))
def test_script_score_over_rest_matches_reference(nodes, case):
    """ULPS: `_score` and `max_score` by the ranked_match rule; totals EXACT."""
    port, ref = nodes
    body = {"query": _script_body(*SCRIPT_QUERIES[case]), "size": 10}
    p = port.search("scripted", body)
    r = ref.search("scripted", body)
    assert p["hits"]["total"] == r["hits"]["total"]
    ph, rh = p["hits"]["hits"], r["hits"]["hits"]
    assert len(ph) == len(rh)
    assert ranked_match([h["_id"][1:] for h in ph], [h["_score"] for h in ph],
                        [h["_id"][1:] for h in rh], [h["_score"] for h in rh])
    if rh:
        assert ulp_close(p["hits"]["max_score"], r["hits"]["max_score"])


def test_script_errors_over_rest_match_reference(nodes):
    """EXACT: status and reason of a refused script and of a missing
    param."""
    port, ref = nodes
    from elasticsearch_tpu.node import ApiError as JaxApiError
    from elasticsearch_tpu_torch.node import ApiError

    for body in (
        {"query": _script_body({"match_all": {}}, "_score +", {}, None, 1.0)},
        {"query": _script_body({"match_all": {}}, "params.x * 2", {}, None, 1.0)},
        {"query": _script_body({"match_all": {}}, "doc['zz'].value", {}, None, 1.0)},
    ):
        with pytest.raises(JaxApiError) as r:
            ref.search("scripted", body)
        with pytest.raises(ApiError) as p:
            port.search("scripted", body)
        assert (p.value.status, p.value.reason) == (r.value.status, r.value.reason)


def test_script_score_rides_the_batcher(nodes):
    """A script_score query is a plain score-sorted search: it rides the
    micro-batcher (its rows are K6's row axis), as in the reference."""
    port, _ref = nodes
    body = {"query": _script_body(*SCRIPT_QUERIES[0]), "size": 5}
    before = port.exec_batcher.stats()["requests"]
    port.search("scripted", body)
    assert port.exec_batcher.stats()["requests"] == before + 1


# ---------------------------------------------------------------------------
# NaN results: the sign (and payload) bits the reference serves
# ---------------------------------------------------------------------------
#
# Scripts whose values are NaN (a missing doc value, or a math function of
# a negative) rank by IEEE total order, so the NaN's sign decides where a
# doc lands. EXACT: the NaN bits of every op against the reference's
# `evaluate(jnp, ...)` under jit (XLA:CPU), also under an arithmetic that
# returns only the card's canonical NaN; through both nodes, ids, order,
# totals and the scores' NaN sign bits (the other scores by the ULPS rule).

NAN_SPECIALS = np.array([np.nan, -np.nan, -1.0, -0.0, 0.0, np.inf, -np.inf,
                         2.0, -2.5, 0.5, 3.0, -7.0], dtype=np.float32)

NAN_OPS = [
    "doc['f'].value + doc['g'].value",
    "doc['f'].value - doc['g'].value",
    "doc['f'].value * doc['g'].value",
    "doc['f'].value / doc['g'].value",
    "doc['f'].value % doc['g'].value",
    "doc['f'].value * 2 + 1",
    "Math.max(doc['f'].value, doc['g'].value)",
    "Math.min(doc['f'].value, doc['g'].value)",
    "Math.max(doc['f'].value, 0.0)",
    "Math.min(0.0, doc['f'].value)",
    "Math.max(_score, doc['f'].value)",
    "Math.sqrt(doc['f'].value)",
    "Math.log(doc['f'].value)",
    "Math.log10(doc['f'].value)",
    "Math.pow(doc['f'].value, 0.5)",
    "doc['f'].value ** 0.5",
    "Math.pow(doc['f'].value, 3.0)",
    "Math.pow(doc['f'].value, params.p)",
    "Math.pow(doc['f'].value, doc['g'].value)",
    "Math.pow(2, doc['f'].value)",
    "Math.exp(doc['f'].value) + Math.abs(doc['g'].value)",
    "Math.floor(doc['f'].value) - Math.ceil(doc['g'].value)",
    "sigmoid(doc['f'].value)",
    "Math.max(Math.sqrt(doc['f'].value), Math.log(doc['g'].value))",
    "Math.min(Math.sqrt(doc['f'].value), Math.sqrt(doc['g'].value))",
    "doc['f'].value > 0 ? Math.sqrt(doc['g'].value) : Math.log(doc['f'].value)",
    "-doc['f'].value",
    "-Math.sqrt(doc['f'].value)",
    "Math.abs(doc['f'].value)",
    "Math.exp(-doc['f'].value)",
    "Math.floor(Math.log(doc['f'].value))",
    "Math.ceil(-Math.sqrt(doc['f'].value))",
]


def _nan_cols():
    """f x g over every pair of specials (144 docs, past torch's vector
    width, so its vectorized CPU kernels run as well as its scalar tail)."""
    return (np.repeat(NAN_SPECIALS, len(NAN_SPECIALS)),
            np.tile(NAN_SPECIALS, len(NAN_SPECIALS)))


def _same_nan_bits(got, want, shape):
    want = np.broadcast_to(np.asarray(want, dtype=np.float32), shape)
    got = np.broadcast_to(np.asarray(got, dtype=np.float32), shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[nan].view(np.uint32), want[nan].view(np.uint32)), (
        [hex(x) for x in got[nan].view(np.uint32)[:8]],
        [hex(x) for x in want[nan].view(np.uint32)[:8]])
    assert ulp_close(got[~nan], want[~nan])


def _jitted_reference(src, score, f, g, boost=None):
    def run(s, f, g, p, b):
        out = ref_compile(src).evaluate(jnp, s, {"f": f, "g": g}, {}, {"p": p})
        return out if boost is None else out * b

    return np.asarray(jax.jit(run)(
        jnp.asarray(score), jnp.asarray(f), jnp.asarray(g), jnp.float32(0.5),
        jnp.float32(1.0 if boost is None else boost)))


@pytest.mark.parametrize("src", NAN_OPS)
def test_nan_bits_match_the_jitted_reference(src):
    f, g = _nan_cols()
    score = np.linspace(-3, 3, len(f)).astype(np.float32)
    got = compile_script(src).evaluate(
        torch.from_numpy(score),
        {"f": torch.from_numpy(f), "g": torch.from_numpy(g)},
        {"p": torch.tensor(0.5)}).numpy()
    _same_nan_bits(got, _jitted_reference(src, score, f, g), f.shape)


class _CardArithmetic(TorchBackend):
    """The card's arithmetic on the CPU: every NaN that an arithmetic or
    math operation returns is the canonical NaN 0x7fffffff (sign-bit
    operations and selects keep their bits, as they do there)."""

    CANONICAL = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)

    def _canonical(self, r):
        return torch.where(torch.isnan(r), self.CANONICAL, r)

    def binary(self, op, a, b):
        return self._canonical(super().binary(op, a, b))

    def math(self, fn, args):
        r = super().math(fn, args)
        return r if fn == "abs" else self._canonical(r)


@pytest.mark.parametrize("src", NAN_OPS)
def test_nan_bits_survive_the_cards_canonical_nan(src):
    """The walk's selects, not the arithmetic, decide every NaN's bits, the
    boost's product included: under an arithmetic that returns only the
    canonical NaN the result still has the reference's bits."""
    f, g = _nan_cols()
    score = np.linspace(-3, 3, len(f)).astype(np.float32)
    be = _CardArithmetic(
        torch.from_numpy(score),
        {"f": torch.from_numpy(f), "g": torch.from_numpy(g)},
        {"p": torch.tensor(0.5)}, "cpu")
    got = boosted(be, lower(compile_script(src), be), torch.tensor(2.0)).numpy()
    _same_nan_bits(got, _jitted_reference(src, score, f, g, boost=2.0), f.shape)


# The ROADMAP's repro index through both nodes: 48 docs, r = i, f = (i % 7)
# - 3 except where i % 4 == 0 (no f); script_score{range r gte 8, S}.
NAN_SCRIPTS = [
    "doc['f'].value",
    "Math.max(doc['f'].value, 0.0)",
    "Math.min(doc['f'].value, 0.0)",
    "Math.sqrt(doc['f'].value)",
    "Math.log(doc['f'].value)",
    "Math.log10(doc['f'].value)",
    "Math.pow(doc['f'].value, 0.5)",
    "Math.max(_score, doc['f'].value)",
    "doc['f'].value > 0 ? Math.sqrt(doc['f'].value) : Math.sqrt(-1 - doc['f'].value)",
    "doc['f'].value * 2 + 1",
    "Math.exp(doc['f'].value)",
    "sigmoid(doc['f'].value)",
]


@pytest.fixture(scope="module", params=[1, 3])
def nan_nodes(request):
    body = {"settings": {"index": {"number_of_shards": request.param}},
            "mappings": {"properties": {"r": {"type": "long"},
                                        "f": {"type": "float"}}}}
    with pytest.MonkeyPatch.context() as mp:
        for key, val in JAX_ENV.items():
            mp.setenv(key, val)
        ref = JaxNode()
        ref.create_index("nan", body)
    port = Node(device="cpu")
    port.create_index("nan", body)
    lines = []
    for i in range(48):
        doc = {"r": i}
        if i % 4:
            doc["f"] = float((i % 7) - 3)
        lines += [json.dumps({"index": {"_id": str(i)}}), json.dumps(doc)]
    for n in (port, ref):
        n.bulk("\n".join(lines) + "\n", default_index="nan", refresh=True)
    yield port, ref
    port.close()
    if ref.exec_batcher is not None:
        ref.exec_batcher.close()


def _nan_page(out):
    hits = out["hits"]
    scores = np.array([np.nan if h["_score"] is None else h["_score"]
                       for h in hits["hits"]], dtype=np.float32)
    return hits["total"], [h["_id"] for h in hits["hits"]], scores


def _same_nan_page(port_out, ref_out):
    p_total, p_ids, p_scores = _nan_page(port_out)
    r_total, r_ids, r_scores = _nan_page(ref_out)
    assert (p_total, p_ids) == (r_total, r_ids)
    nan = np.isnan(r_scores)
    assert np.array_equal(np.isnan(p_scores), nan)
    assert np.array_equal(np.signbit(p_scores[nan]), np.signbit(r_scores[nan]))
    assert ulp_close(p_scores[~nan], r_scores[~nan])


def _nan_body(src, boost=None, **extra):
    query = {"query": {"range": {"r": {"gte": 8}}}, "script": {"source": src}}
    if boost is not None:
        query["boost"] = boost
    return {"query": {"script_score": query}, "size": 48, **extra}


@pytest.mark.parametrize("src", NAN_SCRIPTS)
def test_nan_scored_pages_match_the_jax_node(nan_nodes, src):
    """Sorted by score descending and by `{"_score": "asc"}`, with and
    without a query boost (the product keeps the NaN's sign, as the
    reference's `result * boost` does), and the ascending search_after
    page past -1.0, on 0.0 and on a NaN score (which keeps nothing)."""
    port, ref = nan_nodes
    asc = {"sort": [{"_score": "asc"}]}
    bodies = [_nan_body(src), _nan_body(src, **asc),
              _nan_body(src, boost=2.5), _nan_body(src, boost=2.5, **asc)]
    bodies += [_nan_body(src, search_after=[after], **asc)
               for after in (-1.0, 0.0, float("nan"))]
    for body in bodies:
        _same_nan_page(port.search("nan", body), ref.search("nan", body))
