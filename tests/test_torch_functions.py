"""The port's query/functions.py against the reference's.

The port keeps a whole copy of the reference's function_score math and
runs it with xp = ops/tail_kernel's facade over torch ops (K14's plain
version; the same body generates K14). Here the same numpy-seeded inputs
(a doc-values column with missing values, child scores, filters) go
through both:

- `lower_function`: the static spec and the fp32 constants, equal;
- `eval_function` for every function kind and every field_value_factor
  modifier, against the reference's under jax.jit;
- `combine_function_score` for every score_mode x boost_mode, with
  max_boost and min_score;
- K14's generator emits a kernel for every node kind and reads only the
  inputs the math uses.

Tolerance: exact (fp32 bits) for rational arithmetic, sqrt and the
random hash; 4 ulps where exp or a logarithm is involved (the
field_value_factor log modifiers and the gauss / exp decays: XLA's CPU
exp and log are not glibc's).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.query import dsl as jdsl
from elasticsearch_tpu.query import functions as jfn
from elasticsearch_tpu_torch.ops import tail_kernel
from elasticsearch_tpu_torch.query import dsl as pdsl
from elasticsearch_tpu_torch.query import functions as pfn

torch.set_num_threads(1)

N = 512
MODIFIERS = ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
             "square", "sqrt", "reciprocal")
TRANSCENDENTAL = {"log", "log1p", "log2p", "ln", "ln1p", "ln2p"}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    col = (rng.lognormal(1.0, 1.0, N) + 0.05).astype(np.float32)
    col[::9] = np.nan
    child = (rng.random(N, dtype=np.float32) * 8).astype(np.float32)
    return {"f": col, "child": child}


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _close(a, b, ulps: int) -> bool:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if ulps == 0:
        return np.array_equal(_bits(a), _bits(b))
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    with np.errstate(invalid="ignore"):
        return bool(np.all((np.abs(a.astype(np.float64) - b) <= tol)
                           | (a == b) | np.isnan(a)))


def _port_xp(data, params):
    be = tail_kernel.TorchTail(
        {"child": torch.from_numpy(data["child"]).reshape(1, N)}, {},
        {"f": torch.from_numpy(data["f"])},
        {k: torch.as_tensor(np.asarray(v, np.float32)).reshape(1)
         for k, v in params.items()}, N, torch.device("cpu"))
    return tail_kernel.TailXP(be, N)


def _port_farrays(xp, farrays):
    out = {}
    for key, val in farrays.items():
        if key == "seed":
            out[key] = xp.param_u32(key)
        elif key == "params":
            out[key] = {name: xp.param("p." + name) for name in val}
        else:
            out[key] = xp.param(key)
    return out


def _flat_params(farrays):
    out = {}
    for key, val in farrays.items():
        if key == "seed":
            out[key] = tail_kernel.seed_bits(
                torch.tensor([int(val)], dtype=torch.int64)).numpy()
        elif key == "params":
            out.update({"p." + k: v for k, v in val.items()})
        else:
            out[key] = val
    return out


FUNCTIONS = (
    [("weight", {"weight": 2.5}, 0)]
    + [(f"fvf_{m}", {"field_value_factor": {"field": "f", "factor": 1.3,
                                            "modifier": m, "missing": 2.0}},
        4 if m in TRANSCENDENTAL else 0) for m in MODIFIERS]
    + [("fvf_absent_field", {"field_value_factor": {"field": "nope",
                                                    "missing": 3.0}}, 0),
       ("random", {"random_score": {"seed": 12345}}, 0),
       ("random_high_seed", {"random_score": {"seed": 2**32 - 3}}, 0),
       ("gauss", {"gauss": {"f": {"origin": 3, "scale": 2, "offset": 0.5,
                                  "decay": 0.3}}}, 4),
       ("exp", {"exp": {"f": {"origin": 1, "scale": 4}}}, 4),
       ("linear", {"linear": {"f": {"origin": 2, "scale": 5, "decay": 0.2}},
                   "weight": 1.5}, 0),
       ("decay_absent_field", {"gauss": {"nope": {"origin": 1, "scale": 1}}}, 0),
       ("script", {"script_score": {"script": {
           "source": "_score * params.a + doc['f'].value",
           "params": {"a": 0.25}}}}, 0)]
)


@pytest.mark.parametrize("name,entry,ulps", FUNCTIONS, ids=[f[0] for f in FUNCTIONS])
def test_eval_function_matches_the_reference(data, name, entry, ulps):
    has_column = lambda field: field == "f"  # noqa: E731
    jspec, jarr = jfn.lower_function(jdsl._parse_one_function(entry), has_column)
    pspec, parr = pfn.lower_function(pdsl._parse_one_function(entry), has_column)
    assert jspec == pspec
    assert set(jarr) == set(parr)
    for key in jarr:
        if key == "params":
            assert {k: float(v) for k, v in jarr[key].items()} == {
                k: float(v) for k, v in parr[key].items()}
        else:
            assert np.asarray(jarr[key]).dtype == np.asarray(parr[key]).dtype
            assert np.asarray(jarr[key]) == np.asarray(parr[key]), key
    # Every input is an argument of the jitted program, as when the
    # reference serves (closed-over arrays would fold as constants).
    def ref(child, cols, farrays):
        return jfn.eval_function(
            jnp, jspec, farrays, num_docs=N, column=lambda f: cols.get(f),
            child_scores=child, doc_values=cols, vectors={})

    want = np.asarray(jax.jit(ref)(jnp.asarray(data["child"]),
                                   {"f": jnp.asarray(data["f"])}, jarr))
    xp = _port_xp(data, _flat_params(parr))
    got = pfn.eval_function(
        xp, pspec, _port_farrays(xp, parr), num_docs=N,
        column=lambda f: xp.column(f) if f == "f" else None,
        child_scores=xp.plane("child"), doc_values=None, vectors=None)
    got = torch.broadcast_to(got.v, (1, N))[0].numpy()
    assert _close(got, want, ulps), (name, got[:5], want[:5])


SCORE_MODES = ("multiply", "sum", "avg", "first", "max", "min")
BOOST_MODES = ("multiply", "replace", "sum", "avg", "max", "min")


@pytest.mark.parametrize("score_mode,boost_mode",
                         list(itertools.product(SCORE_MODES, BOOST_MODES)))
def test_combine_matches_the_reference(data, score_mode, boost_mode):
    rng = np.random.default_rng(
        SCORE_MODES.index(score_mode) * 6 + BOOST_MODES.index(boost_mode))
    k = 3
    values = (rng.random((k, N), dtype=np.float32) * 4).astype(np.float32)
    applies = rng.random((k, N)) < 0.6
    matched = rng.random(N) < 0.8
    weights = np.array([1.5, 0.5, 2.0], dtype=np.float32)
    has_min = score_mode in ("sum", "max")
    consts = {"max_boost": np.float32(3.0 if score_mode != "first" else 3.4e38),
              "boost": np.float32(1.25), "min_score": np.float32(2.0)}

    def ref(child, vals, app, m, w, c):
        return jfn.combine_function_score(
            jnp, child_scores=child, matched=m, values=list(vals),
            applies=[a & m for a in app], weights=list(w),
            score_mode=score_mode, boost_mode=boost_mode,
            max_boost=c["max_boost"], boost=c["boost"],
            min_score=c["min_score"] if has_min else None)

    ws, wm = jax.jit(ref)(jnp.asarray(data["child"]), jnp.asarray(values),
                          jnp.asarray(applies), jnp.asarray(matched),
                          jnp.asarray(weights), consts)
    planes = {"child": torch.from_numpy(data["child"]).reshape(1, N)}
    planes.update({f"v{i}": torch.from_numpy(values[i]).reshape(1, N)
                   for i in range(k)})
    masks = {f"a{i}": torch.from_numpy(applies[i]).reshape(1, N)
             for i in range(k)}
    masks["m"] = torch.from_numpy(matched).reshape(1, N)
    params = {f"w{i}": weights[i] for i in range(k)}
    params.update(consts)
    be = tail_kernel.TorchTail(
        planes, masks, {},
        {n: torch.tensor([float(v)], dtype=torch.float32) for n, v in params.items()},
        N, torch.device("cpu"))
    xp = tail_kernel.TailXP(be, N)
    m = xp.mask("m")
    gs, gm = pfn.combine_function_score(
        xp, child_scores=xp.plane("child"), matched=m,
        values=[xp.plane(f"v{i}") for i in range(k)],
        applies=[xp.mask(f"a{i}") & m for i in range(k)],
        weights=[xp.param(f"w{i}") for i in range(k)],
        score_mode=score_mode, boost_mode=boost_mode,
        max_boost=xp.param("max_boost"), boost=xp.param("boost"),
        min_score=xp.param("min_score") if has_min else None)
    gs = torch.broadcast_to(gs.v, (1, N))[0].numpy()
    gm = torch.broadcast_to(gm.v, (1, N))[0].numpy()
    assert np.array_equal(np.asarray(wm), gm)
    assert np.array_equal(_bits(ws), _bits(gs)), (score_mode, boost_mode)


KEYS = [
    (("geo_distance",), ["lat", "lon"], ["lat", "lon", "radius_m", "boost"]),
    (("geo_box",), ["lat", "lon"], ["top", "left", "bottom", "right", "boost"]),
    (("rank_feature", "log"), ["col"], ["scaling", "boost"]),
    (("dismax", 2), [], ["tie", "boost"]),
    (("boosting",), [], ["negative_boost", "boost"]),
    (("terms_set", 3, "field", None), ["required"], ["boost"]),
    (("function_score", (("weight", None, None, False, True, True),),
      (True,), "sum", "replace", False), [], ["f0.weight", "max_boost",
                                              "boost"]),
]


@pytest.mark.parametrize("key,columns,params", KEYS, ids=[k[0][0] for k in KEYS])
def test_generator_emits_one_kernel_per_node_key(key, columns, params):
    """K14's generator walks the same body as the plain version: one
    statement per operation, the inputs in first-use order, no fused
    multiply-add and IEEE division / square root throughout."""
    src, consts, be = tail_kernel.generate_source(key)
    assert be.column_names == columns
    assert sorted(be.names) == sorted(params)
    assert "def tail_eval_kernel(" in src and "tl.store(out_ptr" in src
    assert "fma" not in src
    for line in be.lines:
        assert " / " not in line, line  # div_rn only
    assert all(np.isnan(c) or np.float32(c) == c for c in consts)
