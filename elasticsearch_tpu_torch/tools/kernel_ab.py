#!/usr/bin/env python3
"""Time the port's kernels against another build of them, on one GPU.

    git archive <commit> elasticsearch_tpu_torch | tar -x -C <dir>
    python3 -m elasticsearch_tpu_torch.tools.kernel_ab --baseline <dir>
        [--docs N] [--q Q]

Loads the baseline package from <dir>/elasticsearch_tpu_torch under
another module name, beside this checkout's, so both kernel libraries are
built and loaded in one process on one card. On the one-shard Zipf corpus
(the repo's generator, seed 13) it times each solo wrapper (Q = 1) of
K1-K4 and K1's matched-only mode (a head-term filter's plane, the filter
cache's build) on identical inputs, in the turns baseline, current,
current, baseline (in this checkout the solo wrapper is the batched
wrapper over one row, the call the serving path makes for one request),
and each batched wrapper on Q rows the same way; then, for this checkout
only, each batched wrapper on Q rows against Q solo calls on the same
rows; then the call sites redesigned with K4's fold mode and K3's merge
mode (`lead_path_ab`: a filter-led body through execute_auto and the mesh
merge, baseline against current, with the kernels each launches for one
request by the profiler, on the cfg2 corpus and on one cfg3 shard), and
K3's row mode on that shard's dense keys (6 match bodies, [6, N]: K3b as
cfg3's batched phase runs it, at k = 10 and past the select at k = 257),
and K3k at k = 10,000 on the cfg2 corpus (a uniform f1 column, desc, over
a match's eligible docs); the profiler's kernels a call of the two past
the select do not grow with k. Last (`large_k_paths_ab`), the main-path
calls that run K3 past the select, baseline against current: cfg4's
execute_rescore (window 1,000: the first phase's top-k at k = 1,000) and
a kNN request at k = 10,000 over BASELINE config 5's shape (--knn-docs
random-normal 100-d vectors, seed 5, cosine, IVF planes built once, nprobe
an eighth of the partitions: the per-partition ranks at k = pmax and the
id-mode merge at k = 10,000).
Each turn gives two times a call:
`ms`, the CUDA-event mean over back-to-back calls (at these sizes it
includes the host's launch cost), and `device_ms`, the summed duration of
the kernels and copies the call ran on the card (torch.profiler), which
leaves the host out. Prints one JSON line per measurement and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]


def load_alias(root: Path, alias: str):
    pkg = root / "elasticsearch_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.kernels")


def cuda_ms(fn, reps: int) -> float:
    import time

    import torch

    if not torch.cuda.is_available():  # dry run on the CPU: host clock
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> dict:
    """Mean device time of fn()'s kernels and copies per call, by the
    profiler's CUDA activity: the sum and each kernel's share (empty
    where it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            per[evt.key[:60]] = per.get(evt.key[:60], 0.0) + us / 1e3 / reps
    return {"device_ms": sum(per.values()), "device_ms_by_kernel": per} if per else {}


def timed(fn, reps: int) -> dict:
    return {"ms": cuda_ms(fn, reps), **device_ms(fn, reps)}


def launched(fn) -> dict:
    """The device activities of one fn() call by torch.profiler: kernels
    launched (by name), and copies and memsets apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, other = {}, 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if not us:
            continue
        if evt.key.startswith(("Memcpy", "Memset")):
            other += evt.count
        else:
            kernels[evt.key[:60]] = kernels.get(evt.key[:60], 0) + evt.count
    return {"kernels": sum(kernels.values()), "copies_and_memsets": other,
            "by_kernel": kernels}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, type=Path)
    parser.add_argument("--docs", type=int, default=8_841_823)
    parser.add_argument("--q", type=int, default=4)
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--knn-docs", type=int, default=1_000_000)
    parser.add_argument("--device", default="cuda",
                        help="cpu runs the plain versions (a dry run)")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as cur
    from elasticsearch_tpu_torch.query.compile import pad_arrays_to_spec, unify_specs
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment, pick_query_terms

    base = load_alias(args.baseline.resolve(), "baseline_torch")
    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (plain versions)"
    if dev.type == "cuda":
        cur.ensure_built()
        base.ensure_built()
    mappings, seg = build_zipf_segment(args.docs, seed=13)
    eng = Engine(mappings, device=dev)
    handle = eng._install_segment(seg)
    tree = bm25_device.segment_tree(handle.device)
    comp = eng.compiler_for(handle)
    n = args.docs
    doc_tiles, tn, _tfs, norm, _present = tree["fields"]["body"]
    live = tree["live"]
    rng = np.random.default_rng(13)
    match_terms = pick_query_terms(seg, rng, 32, 4)
    mid = pick_query_terms(seg, rng, 32, 4)
    q = args.q

    def plan(body):
        c = comp.compile(parse_query(body))
        return c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev)

    def stacked(bodies):
        cs = [comp.compile(parse_query(b)) for b in bodies]
        spec = unify_specs([c.spec for c in cs])
        arrays = bm25_device.stack_plans(
            [pad_arrays_to_spec(c.spec, spec, c.arrays) for c in cs])
        return spec, bm25_device.plan_to_torch(spec, arrays, dev)

    fld = seg.fields["body"]
    heads = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])[:q]
    filters = [{"bool": {"filter": [{"term": {"body": t}}]}} for t in heads]
    should = [{"bool": {"should": [
        {"match": {"body": f"{t[0]} {t[1]}"}}, {"match": {"body": t[2]}},
        {"term": {"body": t[3]}}]}} for t in mid[:16]]
    matches = [{"match": {"body": " ".join(t)}} for t in match_terms]
    leads = []
    for t in mid[16:]:
        body = {"bool": {"must": [{"match": {"body": f"{t[0]} {t[1]} {t[2]}"}}],
                         "filter": [{"term": {"body": t[3]}}]}}
        if plan(body)[0][6] >= 0:
            leads.append(body)

    def emit(rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)

    # -- solo wrappers, baseline vs current --------------------------------
    _s, sa = plan(should[0])
    a = sa["children"][0]
    k1 = (doc_tiles, tn, norm, a["tile_ids"], a["starts"], a["ends"],
          a["weights"], n, a["_groups"])
    spec, m = plan(matches[0])
    k2 = (doc_tiles, tn, m["tile_ids"], m["starts"], m["ends"], m["weights"],
          live, n, spec[3])
    docs_s, run_sum, elig = cur.sparse_fold(*k2)
    key = torch.where(elig, run_sum, float("-inf"))
    spec, la = plan(leads[0])
    lw = la["children"][1 + spec[6]]
    tid = lw["tile_ids"].to(torch.int64)
    pos = tid[:, None] * 256 + torch.arange(256, device=dev)
    valid = (pos >= lw["starts"].to(torch.int64)[:, None]) & (
        pos < lw["ends"].to(torch.int64)[:, None])
    cands = torch.clamp(torch.where(valid, doc_tiles[tid], n).reshape(-1), max=n - 1)
    mm = la["children"][0]
    k4 = (doc_tiles.reshape(-1), mm["term_starts"], mm["term_ends"], 0, cands)
    _s, fa = plan(filters[0])
    f = bm25_device._rows1(fa["children"][0])
    k1mo = (doc_tiles, tn, norm, f["tile_ids"], f["starts"], f["ends"], None,
            n, f["_groups"])
    solo = {
        "terms_scatter": lambda K: K.terms_scatter(*k1),
        "terms_scatter_matched_only": lambda K: K.terms_scatter_batch(
            *k1mo, matched_only=True),
        "sparse_fold": lambda K: K.sparse_fold(*k2),
        "masked_topk": lambda K: K.masked_topk(key, elig, 10),
        "span_locate": lambda K: K.span_locate(*k4),
    }
    for name, fn in solo.items():
        turns = []
        for label, K in (("baseline", base), ("current", cur),
                         ("current", cur), ("baseline", base)):
            turns.append((label, timed(lambda: fn(K), args.reps)))
        emit({"kernel": name, "rows": 1, "turns": turns})

    # -- batched wrapper (one launch, Q rows) vs Q solo launches ------------
    _s, sb = stacked(should[:q])
    b1 = sb["children"][0]
    _s, fb = stacked(filters[:q])
    f1 = fb["children"][0]
    solo1 = [plan(b)[1]["children"][0] for b in should[:q]]
    spec, mb = stacked(matches[:q])
    solo2 = [plan(b) for b in matches[:q]]
    lead_q = (leads * q)[:q]
    spec4, l4 = stacked(lead_q)
    lw = l4["children"][1 + spec4[6]]
    tid = lw["tile_ids"].to(torch.int64)
    pos = tid[..., None] * 256 + torch.arange(256, device=dev)
    valid = (pos >= lw["starts"].to(torch.int64)[..., None]) & (
        pos < lw["ends"].to(torch.int64)[..., None])
    cands_b = torch.clamp(torch.where(valid, doc_tiles[tid], n).reshape(q, -1),
                          max=n - 1)
    m4 = l4["children"][0]
    keys_b = key.expand(q, -1).contiguous()
    elig_b = elig.expand(q, -1).contiguous()
    batch = {
        "terms_scatter": lambda K: K.terms_scatter_batch(
            doc_tiles, tn, norm, b1["tile_ids"], b1["starts"], b1["ends"],
            b1["weights"], n, b1["_groups"]),
        "terms_scatter_matched_only": lambda K: K.terms_scatter_batch(
            doc_tiles, tn, norm, f1["tile_ids"], f1["starts"], f1["ends"],
            None, n, f1["_groups"], matched_only=True),
        "sparse_fold": lambda K: K.sparse_fold_batch(
            doc_tiles, tn, mb["tile_ids"], mb["starts"], mb["ends"],
            mb["weights"], live, n, spec[3]),
        "masked_topk": lambda K: K.masked_topk_batch(keys_b, elig_b, 10),
        "span_locate": lambda K: K.span_locate_batch(
            doc_tiles.reshape(-1), m4["term_starts"], m4["term_ends"], 0, cands_b),
    }
    for name, fn in batch.items():
        turns = []
        for label, K in (("baseline", base), ("current", cur),
                         ("current", cur), ("baseline", base)):
            turns.append((label, timed(lambda: fn(K), args.reps)))
        emit({"kernel": name, "rows": q, "ab": "batched", "turns": turns})
    pairs = {
        "terms_scatter": (
            lambda: batch["terms_scatter"](cur),
            lambda: [cur.terms_scatter(
                doc_tiles, tn, norm, c["tile_ids"], c["starts"], c["ends"],
                c["weights"], n, c["_groups"]) for c in solo1]),
        "sparse_fold": (
            lambda: batch["sparse_fold"](cur),
            lambda: [cur.sparse_fold(
                doc_tiles, tn, p["tile_ids"], p["starts"], p["ends"],
                p["weights"], live, n, s[3]) for s, p in solo2]),
        "masked_topk": (
            lambda: batch["masked_topk"](cur),
            lambda: [cur.masked_topk(keys_b[r], elig_b[r], 10) for r in range(q)]),
        "span_locate": (
            lambda: batch["span_locate"](cur),
            lambda: [cur.span_locate(
                doc_tiles.reshape(-1), m4["term_starts"][r], m4["term_ends"][r], 0,
                cands_b[r].contiguous()) for r in range(q)]),
    }
    for name, (batched, loop) in pairs.items():
        turns = []
        for label, fn in (("batched", batched), ("solo_loop", loop),
                          ("solo_loop", loop), ("batched", batched)):
            turns.append((label, timed(fn, args.reps)))
        emit({"kernel": name, "rows": q, "turns": turns})
    lead_path_ab(args, base, cur, dev, comp, tree, leads, matches[0], emit)
    large_k_paths_ab(args, base, cur, dev, comp, tree, matches, emit)
    print(card, flush=True)
    return 0


def lead_path_ab(args, base, cur, dev, comp, tree, leads, match, emit) -> None:
    """The two redesigned call sites, baseline against current in the
    turns baseline, current, current, baseline: one filter-led body
    through execute_auto (the must terms' K4 loop against K4's fold mode)
    and the mesh merge of [1, S * kk] = [1, 80] gathered keys with their
    ids (K3's row mode, a cast and a gather against K3's merge mode);
    then the kernels each launches for one such request on the cfg2
    corpus and on one cfg3 shard (the profiler's count, before and
    after); then K3b and K3k past the select."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.parallel import sharded
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    root = base.__name__.rsplit(".", 2)[0]
    base_bm25 = importlib.import_module(f"{root}.ops.bm25_device")
    base_sharded = importlib.import_module(f"{root}.parallel.sharded")

    def one_request(tree_, comp_, body):
        c = comp_.compile(parse_query(body))
        plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
        return {"baseline": lambda: base_bm25.execute_auto(tree_, c.spec, plan, 10),
                "current": lambda: bm25_device.execute_auto(tree_, c.spec, plan, 10)}

    def ab(fns):
        return [(label, timed(fns[label], args.reps))
                for label in ("baseline", "current", "current", "baseline")]

    def same(fns):
        a, b = fns["baseline"](), fns["current"]()
        return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y)
                   for x, y in zip(a, b))

    cfg2 = one_request(tree, comp, leads[0])
    emit({"call": "execute_auto, cfg2 filter-led body (3 must terms)",
          "equal": same(cfg2), "turns": ab(cfg2),
          "launched": {k: launched(f) for k, f in cfg2.items()}})

    rng = np.random.default_rng(31)
    flat = torch.from_numpy(rng.standard_normal((1, 80)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 1 << 30, (1, 80)).astype(np.int32)).to(dev)

    merge = {"baseline": lambda: base_sharded._merge_topk(flat, 10, ids),
             "current": lambda: sharded._merge_topk(flat, 10, ids)}
    emit({"call": "mesh merge [1, 80] -> 10 with ids", "equal": same(merge),
          "turns": ab(merge),
          "launched": {k: launched(f) for k, f in merge.items()}})

    # cfg3's shard 0: the cfg2 corpus's docs over its 8 shards (seed 100).
    mappings, seg = build_zipf_segment(-(-args.docs // 8), vocab_size=30_000,
                                       seed=100)
    eng = Engine(mappings, device=dev)
    handle = eng._install_segment(seg)
    tree3 = bm25_device.segment_tree(handle.device)
    comp3 = eng.compiler_for(handle)
    fld = seg.fields["body"]
    by_df = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])
    mid = by_df[len(by_df) // 100 : len(by_df) // 4]
    rare = by_df[len(by_df) // 4 : len(by_df) // 2]
    m1, m2 = (str(t) for t in rng.choice(mid, 2, replace=False))
    body = {"bool": {"must": [{"match": {"body": f"{m1} {m2}"}}],
                     "filter": [{"term": {"body": str(rng.choice(rare))}}]}}
    c = comp3.compile(parse_query(body))
    cfg3 = one_request(tree3, comp3, body)
    emit({"call": "execute_auto, cfg3 filter-led body (one shard, 2 must terms)",
          "lead": int(c.spec[6]), "equal": same(cfg3), "turns": ab(cfg3),
          "launched": {k: launched(f) for k, f in cfg3.items()}})

    # K3b on the shard's dense keys: 6 match bodies' K1 planes, masked.
    n3 = tree3["live"].shape[0]
    dt3, tn3, _tf3, norm3, _p3 = tree3["fields"]["body"]
    rows = []
    for t in rng.choice(mid, (6, 4), replace=False):
        plan3 = comp3.compile(parse_query(
            {"bool": {"should": [{"match": {"body": " ".join(map(str, t))}}]}}))
        a3 = bm25_device._rows1(bm25_device.plan_to_torch(
            plan3.spec, plan3.arrays, dev)["children"][0])
        scores, matched = cur.terms_scatter_batch(
            dt3, tn3, norm3, a3["tile_ids"], a3["starts"], a3["ends"],
            a3["weights"], n3, a3["_groups"])
        el = matched[0, :n3] & tree3["live"]
        rows.append((torch.where(el, scores[0, :n3], float("-inf")), el))
    key6 = torch.stack([r[0] for r in rows]).contiguous()
    elig6 = torch.stack([r[1] for r in rows]).contiguous()
    for kk in (10, 257):
        k3b = {"baseline": lambda kk=kk: base.masked_topk_batch(key6, elig6, kk),
               "current": lambda kk=kk: cur.masked_topk_batch(key6, elig6, kk)}
        emit({"call": f"K3b masked_topk_batch [6, {n3}] k = {kk} (cfg3 shard "
                      f"0's dense match keys)", "equal": same(k3b),
              "turns": ab(k3b),
              "launched": {k: launched(f) for k, f in k3b.items()}})

    # K3k at k = 10,000: f1 desc over a match's eligible docs on the cfg2
    # corpus (the sorted phase's key at the node's largest page).
    n = tree["live"].shape[0]
    dt, tn, _tf, norm, _p = tree["fields"]["body"]
    c = comp.compile(parse_query({"bool": {"should": [match]}}))
    a1 = bm25_device._rows1(bm25_device.plan_to_torch(
        c.spec, c.arrays, dev)["children"][0])
    _scores, matched = cur.terms_scatter_batch(
        dt, tn, norm, a1["tile_ids"], a1["starts"], a1["ends"], a1["weights"],
        n, a1["_groups"])
    el1 = (matched[:, :n] & tree["live"]).contiguous()
    f1 = torch.from_numpy(
        np.random.default_rng(99).random(n, dtype=np.float32)).to(dev)
    k3k = {"baseline": lambda: base.keyed_topk_batch(
               f1, el1, 10_000, base.KEYED_FIELD, True),
           "current": lambda: cur.keyed_topk_batch(
               f1, el1, 10_000, cur.KEYED_FIELD, True)}
    emit({"call": f"K3k keyed_topk_batch f1 desc, N = {n}, k = 10,000 "
                  f"({int(el1.sum())} eligible)", "equal": same(k3k),
          "turns": ab(k3k),
          "launched": {k: launched(f) for k, f in k3k.items()}})


def large_k_paths_ab(args, base, cur, dev, comp, tree, matches, emit) -> None:
    """cfg4's execute_rescore at a window of 1,000 (a match's first phase,
    rescored by another match) and a kNN request at k = 10,000, baseline
    against current in the turns baseline, current, current, baseline,
    with the kernels each launches."""
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.ann import build_partitions, default_nprobe
    from elasticsearch_tpu_torch.ops import ann_device, bm25_device
    from elasticsearch_tpu_torch.query.dsl import parse_query

    root = base.__name__.rsplit(".", 2)[0]
    base_bm25 = importlib.import_module(f"{root}.ops.bm25_device")
    base_ann = importlib.import_module(f"{root}.ops.ann_device")

    def ab(fns):
        return [(label, timed(fns[label], max(5, args.reps // 5)))
                for label in ("baseline", "current", "current", "baseline")]

    def same(fns):
        a, b = fns["baseline"](), fns["current"]()
        return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y)
                   for x, y in zip(a, b))

    c = comp.compile(parse_query(matches[0]))
    rc = comp.compile(parse_query(matches[1]))
    plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
    rplan = bm25_device.plan_to_torch(rc.spec, rc.arrays, dev)
    rescore = {
        "baseline": lambda: base_bm25.execute_rescore(
            tree, c.spec, plan, rc.spec, rplan, 10, 1000, 1.0, 1.0),
        "current": lambda: bm25_device.execute_rescore(
            tree, c.spec, plan, rc.spec, rplan, 10, 1000, 1.0, 1.0)}
    emit({"call": "execute_rescore, window 1,000 (cfg4's first phase at k = "
                  "1,000)", "equal": same(rescore), "turns": ab(rescore),
          "launched": {k: launched(f) for k, f in rescore.items()}})

    n, d = args.knn_docs, 100
    vecs = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    dvecs = torch.from_numpy(vecs).to(dev)
    parts = build_partitions("vec", vecs, dvecs, n, "cosine")
    nprobe = default_nprobe(parts.n_partitions)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    q = np.random.default_rng(6).standard_normal(d).astype(np.float32)
    knn = {"baseline": lambda: base_ann.ann_ivf_search(
               parts.tree(), live, q, 10_000, nprobe, "cosine"),
           "current": lambda: ann_device.ann_ivf_search(
               parts.tree(), live, q, 10_000, nprobe, "cosine")}
    emit({"call": f"kNN ann_ivf_search k = 10,000 over {n} x {d} "
                  f"(nprobe {nprobe} of {parts.n_partitions}, pmax "
                  f"{parts.pmax})", "equal": same(knn), "turns": ab(knn),
          "launched": {k: launched(f) for k, f in knn.items()}})


if __name__ == "__main__":
    sys.exit(main())
