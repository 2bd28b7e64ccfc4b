#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elasticsearch_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card and the repo

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

  1. build    the four CUDA kernels (csrc/*.cu -> one sm_90a library)
  2. corpus   the MS MARCO-sized Zipf corpus (8,841,823 passages, the
              repo's own generator) attached to an index through the port
              engine, packed on the card
  3. main     the port's REST server on loopback serves `_search` over HTTP:
              `match` queries of 4 terms (BASELINE config 2's shape),
              bool(should) and bool(must match + filter term) queries, plus
              a bulk-indexed small index; launch counters are zeroed just
              before and read just after
  4. check    match hits against the port's numpy oracle (ops/bm25
              search_field), bool hits against the port's plain PyTorch
              path on the same card tensors: 0 mismatches in ids, order,
              fp32 score bits and totals
  5. kernels  each kernel against its plain version on the card at the
              main path's shapes (exact), timed beside its memory bound,
              the plain version and one library call as a yardstick
  6. results  `_search` p50/p99 and QPS, device execute p50 (CUDA events),
              peak device memory

The last lines are the card (nvidia-smi name, power limit), one JSON
object with the kernel table, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

N_DOCS = 8_841_823  # MS MARCO passage ranking collection size
SEED = 13
TOP_K = 10
N_MATCH = 32
N_SHOULD = 16
N_MUST_FILTER = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
REPO = Path(__file__).resolve().parent


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
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


@contextlib.contextmanager
def plain_kernels():
    """Route bm25_device through the plain PyTorch versions of K1-K4 (on
    whatever device the tensors are) — the reference run of phase 4."""
    from elasticsearch_tpu_torch.ops import kernels as kern

    names = ("terms_scatter", "sparse_fold", "masked_topk", "span_locate")
    saved = {n: getattr(kern, n) for n in names}
    try:
        for n in names:
            setattr(kern, n, getattr(kern, n + "_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kern, n, fn)


def http(base: str, method: str, path: str, body=None, raw: str | None = None):
    data = raw.encode() if raw is not None else (
        None if body is None else json.dumps(body).encode()
    )
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def run() -> dict:
    import numpy as np
    import torch

    from elasticsearch_tpu_torch.index.tiles import device_nbytes
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import bm25, bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.rest.server import RestServer
    from elasticsearch_tpu_torch.utils.corpus import (
        build_zipf_segment,
        pick_query_terms,
    )

    card = card_line()
    dev = torch.device("cuda")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.monotonic()
    kern.ensure_built()
    build_s = time.monotonic() - t0
    for line in str(kern.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")
    log(f"phase build: ok {build_s:.2f} s (cached={kern.BUILD_INFO.get('cached')}) [{card}]")

    # -- 2. corpus ----------------------------------------------------------
    t0 = time.monotonic()
    mappings, segment = build_zipf_segment(N_DOCS, seed=SEED)
    gen_s = time.monotonic() - t0
    node = Node(device="cuda")
    node.create_index("msmarco", {"mappings": {"properties": {"body": {"type": "text"}}}})
    svc = node.indices["msmarco"]
    t1 = time.monotonic()
    handle = svc.engine._install_segment(segment)
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t1
    fld = segment.fields["body"]
    log(
        f"phase corpus: ok {N_DOCS} docs, {len(fld.doc_ids)} postings, "
        f"{len(fld.terms)} terms; generate {gen_s:.1f} s, pack+upload "
        f"{pack_s:.1f} s, device bytes {device_nbytes(handle.device)} [{card}]"
    )

    # -- 3. main path over HTTP -------------------------------------------
    rng = np.random.default_rng(SEED)
    match_terms = pick_query_terms(segment, rng, N_MATCH, terms_per_query=4)
    mid_terms = pick_query_terms(segment, rng, N_SHOULD + N_MUST_FILTER, 4)
    by_df = sorted(fld.terms, key=lambda t: -fld.df[fld.terms[t]])
    head = by_df[:10]
    bodies = [{"query": {"match": {"body": " ".join(t)}}, "size": TOP_K}
              for t in match_terms]
    for i in range(N_SHOULD):
        t = mid_terms[i]
        bodies.append({"query": {"bool": {"should": [
            {"match": {"body": f"{t[0]} {t[1]}"}},
            {"match": {"body": t[2]}},
            {"term": {"body": t[3]}},
        ]}}, "size": TOP_K})
    for i in range(N_MUST_FILTER):
        t = mid_terms[N_SHOULD + i]
        # even i: a frequent filter (must-led fold, K4 membership);
        # odd i: a rare filter that leads the conjunction (K4 scoring)
        filt = head[i % len(head)] if i % 2 == 0 else t[3]
        bodies.append({"query": {"bool": {
            "must": [{"match": {"body": f"{t[0]} {t[1]} {t[2]}"}}],
            "filter": [{"term": {"body": filt}}],
        }}, "size": TOP_K})

    rest = RestServer(node)
    server = rest.serve("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        banner = http(base, "GET", "/")
        http(base, "PUT", "/docs", {"mappings": {"properties": {
            "body": {"type": "text"}, "tag": {"type": "keyword"}}}})
        small_terms = pick_query_terms(segment, np.random.default_rng(SEED + 1), 500, 4)
        bulk = "".join(
            json.dumps({"index": {"_id": f"p{i}"}}) + "\n"
            + json.dumps({"body": " ".join(t), "tag": "even" if i % 2 == 0 else "odd"})
            + "\n"
            for i, t in enumerate(small_terms)
        )
        out = http(base, "POST", "/docs/_bulk", raw=bulk)
        if out["errors"]:
            raise SmokeFailure("bulk indexing reported errors")
        http(base, "POST", "/docs/_refresh")
        small_bodies = [
            {"query": {"match": {"body": " ".join(small_terms[3])}}},
            {"query": {"bool": {"must": [{"match": {"body": small_terms[5][0]}}],
                                "filter": [{"term": {"tag": "even"}}]}}},
        ]
        # warm-up outside the counted window (first launches of each
        # kernel, allocator growth): one query of each shape
        for i in (0, N_MATCH, N_MATCH + N_SHOULD, N_MATCH + N_SHOULD + 1):
            http(base, "POST", "/msmarco/_search", bodies[i])
        torch.cuda.synchronize()
        kern.reset_launches()
        latencies, responses = [], []
        t_all = time.monotonic()
        for body in bodies:
            t0 = time.monotonic()
            responses.append(http(base, "POST", "/msmarco/_search", body))
            latencies.append((time.monotonic() - t0) * 1e3)
        wall_s = time.monotonic() - t_all
        small_out = [http(base, "POST", "/docs/_search", b) for b in small_bodies]
        launches = dict(kern.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
    log(f"phase main: ok {len(bodies)} _search over HTTP on {banner['version']['number']}, "
        f"{wall_s:.2f} s; launches {launches} [{card}]")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the main path: {missing}")
    for out in small_out:
        if out["hits"]["total"]["value"] < 1:
            raise SmokeFailure("small index returned no hits")

    # -- 4. check -----------------------------------------------------------
    mismatches = 0
    t0 = time.monotonic()
    for terms, out in zip(match_terms, responses[:N_MATCH]):
        o_s, o_i = bm25.search_field(fld, terms, N_DOCS, TOP_K)
        matched = np.zeros(N_DOCS, dtype=bool)
        for term in terms:
            matched[fld.postings(term)[0]] = True
        hits = out["hits"]["hits"]
        got_ids = [h["_id"] for h in hits]
        want_ids = [segment.ids[int(d)] for d in o_i]
        got_bits = np.asarray([h["_score"] for h in hits], np.float32).view(np.int32)
        if (
            got_ids != want_ids
            or not np.array_equal(got_bits, np.asarray(o_s, np.float32).view(np.int32))
            or out["hits"]["total"]["value"] != min(int(matched.sum()), 10_000)
        ):
            mismatches += 1
            log(f"  MISMATCH match {terms}")
    seg_tree = bm25_device.segment_tree(handle.device)
    compiler = svc.engine.compiler_for(handle)
    bool_bodies = bodies[N_MATCH:]
    plans = []
    for body in bool_bodies:
        c = compiler.compile(parse_query(body["query"]))
        plans.append((c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev)))
    with plain_kernels():
        for (spec, plan), out in zip(plans, responses[N_MATCH:]):
            s, i, t = bm25_device.execute_auto(seg_tree, spec, plan, TOP_K)
            s, i, t = s.cpu().numpy(), i.cpu().numpy(), int(t.cpu())
            n = min(TOP_K, t, len(i))
            hits = out["hits"]["hits"]
            got_bits = np.asarray([h["_score"] for h in hits], np.float32).view(np.int32)
            if (
                [h["_id"] for h in hits] != [segment.ids[int(d)] for d in i[:n]]
                or not np.array_equal(got_bits, s[:n].view(np.int32))
                or out["hits"]["total"]["value"] != min(t, 10_000)
            ):
                mismatches += 1
                log(f"  MISMATCH bool {spec[0]} {spec[1:]}")
    log(f"phase check: {'ok' if mismatches == 0 else 'FAILED'} {mismatches} hit "
        f"mismatches over {len(bodies)} queries at {N_DOCS} docs "
        f"({time.monotonic() - t0:.1f} s) [{card}]")
    if mismatches:
        raise SmokeFailure(f"{mismatches} hit mismatches")

    # -- 5. kernels at main-path shapes -----------------------------------
    rows = kernel_rows(seg_tree, compiler, bodies, launches, dev)
    log(f"phase kernels: ok 0 mismatches over {len(rows)} kernels [{card}]")

    # -- 6. results -------------------------------------------------------
    exec_ms, plan_ms = [], []
    for body in bodies:
        t0 = time.perf_counter()
        c = compiler.compile(parse_query(body["query"]))
        plan = bm25_device.plan_to_torch(c.spec, c.arrays, dev)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        bm25_device.execute_auto(seg_tree, c.spec, plan, TOP_K)
        ev1.record()
        torch.cuda.synchronize()
        exec_ms.append(ev0.elapsed_time(ev1))
    groups = {
        "match": latencies[:N_MATCH],
        "bool_should": latencies[N_MATCH:N_MATCH + N_SHOULD],
        "bool_must_filter": latencies[N_MATCH + N_SHOULD:],
    }
    result = {
        "search_p50_ms": percentile(latencies, 50),
        "search_p99_ms": percentile(latencies, 99),
        "qps_sequential": len(bodies) / wall_s,
        "device_execute_p50_ms": percentile(exec_ms, 50),
        "host_plan_p50_ms": percentile(plan_ms, 50),
        "per_shape_device_p50_ms": {
            "match": percentile(exec_ms[:N_MATCH], 50),
            "bool_should": percentile(exec_ms[N_MATCH:N_MATCH + N_SHOULD], 50),
            "bool_must_filter": percentile(exec_ms[N_MATCH + N_SHOULD:], 50),
        },
        "per_shape_p50_ms": {k: percentile(v, 50) for k, v in groups.items()},
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "docs": N_DOCS,
    }
    log(f"phase results: {json.dumps(result)} [{card}]")
    return {"card": card, "kernels": rows, "result": result}


def kernel_rows(seg_tree, compiler, bodies, launches, dev):
    """Each kernel against its plain version on the card at shapes the
    main path gave it (exact), timed by CUDA events beside its byte bound,
    the plain version and one PyTorch call as a yardstick."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_device
    from elasticsearch_tpu_torch.ops import kernels as kern
    from elasticsearch_tpu_torch.query.dsl import parse_query

    num_docs = seg_tree["live"].shape[0]
    doc_tiles, tn, _tfs, norm_bytes, _present = seg_tree["fields"]["body"]
    live = seg_tree["live"]
    lane = torch.arange(256, device=dev, dtype=torch.int64)
    rows = []

    def plan(body):
        c = compiler.compile(parse_query(body["query"]))
        return c.spec, bm25_device.plan_to_torch(c.spec, c.arrays, dev)

    def worklist(a):
        """(tile ids as int64, valid [NT, 256] mask, real entries)."""
        tid = a["tile_ids"].to(torch.int64)
        pos = tid[:, None] * 256 + lane
        valid = (pos >= a["starts"].to(torch.int64)[:, None]) & (
            pos < a["ends"].to(torch.int64)[:, None])
        n_real = int(a["_groups"][-1][1]) if len(a["_groups"]) else 0
        return tid, valid, n_real

    def same(got, want, name):
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            if g.shape != w.shape or g.dtype != w.dtype:
                raise SmokeFailure(f"{name}: shape/dtype differ from the plain version")
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise SmokeFailure(f"{name}: differs from the plain version")

    def row(name, source, replaces, fn, plain, library, nbytes, reps=20):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        same(got, want, name)
        r = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "mismatches": 0,
            "max_abs_err": 0.0,
            "ms": cuda_ms(fn, reps),
            "plain_ms": cuda_ms(plain, 2),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": cuda_ms(library, reps),
            "bound_bytes": int(nbytes),
        }
        log(f"  kernel {json.dumps(r)}")
        rows.append(r)

    # K1: the first child of the first bool(should) query (dense path).
    _spec, sa = plan(bodies[N_MATCH])
    a = sa["children"][0]
    tid, valid, n_real = worklist(a)
    args = (doc_tiles, tn, norm_bytes, a["tile_ids"], a["starts"], a["ends"],
            a["weights"], num_docs, a["_groups"])
    w = a["weights"][:, None]
    idx = doc_tiles[tid][valid].to(torch.int64)
    contrib = (w - w / (1.0 + tn[tid]))[valid]
    row("terms_scatter", "elasticsearch_tpu_torch/csrc/terms_scatter.cu",
        "elasticsearch_tpu/ops/bm25_device.py:436",
        lambda: kern.terms_scatter(*args), lambda: kern.terms_scatter_plain(*args),
        lambda: torch.zeros(num_docs + 1, device=dev).index_add_(0, idx, contrib),
        # postings read (doc id + impact), worklist read, both planes written
        int(valid.sum()) * 8 + n_real * 16 + (num_docs + 1) * 5)

    # K2 and K3: the first cfg2 match query (sparse path).
    spec, a = plan(bodies[0])
    tid, valid, n_real = worklist(a)
    args = (doc_tiles, tn, a["tile_ids"], a["starts"], a["ends"], a["weights"],
            live, num_docs, spec[3])
    docs_s, run_sum, elig = kern.sparse_fold(*args)
    p = docs_s.shape[0]
    cand_keys = torch.where(valid, doc_tiles[tid], num_docs).reshape(-1)
    row("sparse_fold", "elasticsearch_tpu_torch/csrc/sparse_fold.cu",
        "elasticsearch_tpu/ops/bm25_device.py:977",
        lambda: kern.sparse_fold(*args), lambda: kern.sparse_fold_plain(*args),
        lambda: torch.sort(cand_keys, stable=True),
        # tiles and worklist read; docs_s, run_sum, eligible written; live read
        n_real * 256 * 8 + n_real * 16 + p * 10)
    key = torch.where(elig, run_sum, float("-inf"))
    row("masked_topk", "elasticsearch_tpu_torch/csrc/masked_topk.cu",
        "elasticsearch_tpu/ops/bm25_device.py:1031",
        lambda: kern.masked_topk(key, elig, TOP_K),
        lambda: kern.masked_topk_plain(key, elig, TOP_K),
        lambda: torch.topk(key, TOP_K),
        p * 5 + TOP_K * 8 + 4)

    # K4: a filter-led conjunction's candidates in its first must span.
    for body in bodies[N_MATCH + N_SHOULD:]:
        spec, la = plan(body)
        if spec[6] >= 0:
            break
    else:
        raise SmokeFailure("no filter-led conjunction among the queries")
    tid, valid, _ = worklist(la["children"][1 + spec[6]])
    cands = torch.clamp(torch.where(valid, doc_tiles[tid], num_docs).reshape(-1),
                        max=num_docs - 1)
    m = la["children"][0]
    flat = doc_tiles.reshape(-1)
    args = (flat, m["term_starts"], m["term_ends"], 0, cands)
    s0, e0 = int(m["term_starts"][0]), int(m["term_ends"][0])
    span = flat[s0:e0]
    row("span_locate", "elasticsearch_tpu_torch/csrc/span_locate.cu",
        "elasticsearch_tpu/ops/bm25_device.py:949",
        lambda: kern.span_locate(*args), lambda: kern.span_locate_plain(*args),
        lambda: torch.searchsorted(span, cands),
        # candidates and the span read once; pos and found written
        cands.shape[0] * 9 + (e0 - s0) * 4)
    return rows



def main() -> int:
    if not (REPO / "elasticsearch_tpu_torch" / "ops" / "kernels.py").exists():
        print("chip_smoke.py: the elasticsearch_tpu_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the port "
              "on the card and has nothing to report without one",
              file=sys.stderr)
        return 2
    try:
        report = run()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"{report['card']}", flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
