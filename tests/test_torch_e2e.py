"""Port end to end: the port's Node/RestServer (on the CPU) and the JAX
package's node index the same documents through the same REST bodies, and
`_search` answers identically: hit ids, order, `_score` (fp32 bits),
`hits.total` and `max_score`, before and after deletes and a second
segment. Plus the port's import boundary and its device default.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from elasticsearch_tpu.rest.server import RestServer as JaxRestServer
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestServer

# One intra-op thread: these CPU checks share the cores with timing-
# sensitive suites running in parallel test workers.
torch.set_num_threads(1)

PORT_DIR = Path(__file__).resolve().parent.parent / "elasticsearch_tpu_torch"
VOCAB = [f"v{i}" for i in range(60)]
TAGS = ["alpha", "beta", "gamma", "delta"]
MAPPINGS = {
    "mappings": {
        "properties": {
            "body": {"type": "text"},
            "title": {"type": "text"},
            "tag": {"type": "keyword"},
            "rank": {"type": "long"},
            "price": {"type": "double"},
        }
    }
}


def _docs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    out = []
    for i in range(n):
        doc = {
            "body": " ".join(rng.choice(VOCAB, int(rng.integers(3, 25)), p=probs)),
            "tag": str(rng.choice(TAGS)),
            "rank": int(rng.integers(0, 500)),
        }
        if i % 3:
            doc["title"] = " ".join(rng.choice(VOCAB[:15], 3))
        if i % 5:
            doc["price"] = float(np.round(rng.random() * 100, 2))
        out.append(doc)
    return out


def _search_bodies() -> list[dict]:
    return [
        {"query": {"match": {"body": "v0 v3 v7 v11"}}},
        {"query": {"match": {"body": "v12"}}, "size": 5},
        {"query": {"match": {"body": "v1 v1 v2"}}, "size": 20},
        {"query": {"match": {"body": {"query": "v4 v9", "operator": "and"}}}},
        {"query": {"match": {"body": {"query": "v2 v5 v8", "minimum_should_match": 2}}}},
        {"query": {"term": {"tag": "beta"}}, "size": 7},
        {"query": {"terms": {"tag": ["gamma", "delta"]}}},
        {"query": {"bool": {"should": [{"match": {"body": "v5"}},
                                       {"match": {"title": "v2 v3"}}]}}},
        {"query": {"bool": {"must": [{"match": {"body": "v0 v6"}}],
                            "filter": [{"term": {"tag": "alpha"}}]}}},
        {"query": {"bool": {"must": [{"match": {"body": "v1 v2 v3"}}],
                            "filter": [{"term": {"body": "v40"}}]}}},
        {"query": {"bool": {"must": [{"match": {"body": "v3"}}],
                            "must_not": [{"term": {"tag": "gamma"}}],
                            "filter": [{"range": {"rank": {"gte": 100, "lt": 400}}}]}}},
        {"query": {"range": {"price": {"gt": 20.5, "lte": 80}}}, "size": 15},
        {"query": {"exists": {"field": "title"}}, "size": 3},
        {"query": {"constant_score": {"filter": {"term": {"tag": "delta"}},
                                      "boost": 1.5}}},
        {"query": {"match_all": {}}, "from": 5, "size": 5},
        {"query": {"match_none": {}}},
        {"query": {"match": {"body": "v10 v20 v30"}}, "from": 3, "size": 4,
         "_source": ["tag"]},
        {"query": {"match": {"body": "v0"}}, "track_total_hits": 50},
        {"query": {"match": {"body": "v0 v1"}}, "track_total_hits": False},
        {"query": {"bool": {"should": [{"term": {"body": "v7"}},
                                       {"term": {"body": "v8"}},
                                       {"term": {"body": "v9"}}],
                            "minimum_should_match": 2}}},
        {"query": {"match": {"body": "unknownterm"}}},
    ]


def _call(rest, method, path, body=None):
    payload = body if isinstance(body, str) else (
        json.dumps(body) if body is not None else ""
    )
    status, out = rest.dispatch(method, path, {}, payload)
    return status, out


def _hits_view(out: dict) -> dict:
    hits = out["hits"]
    return {
        "total": hits.get("total"),
        "max_score": hits["max_score"],
        "hits": [(h["_id"], h["_score"], h.get("_source")) for h in hits["hits"]],
    }


def _compare_all(port, ref, stage: str):
    for body in _search_bodies():
        ps, pout = _call(port, "POST", "/docs/_search", body)
        rs, rout = _call(ref, "POST", "/docs/_search", body)
        assert ps == rs == 200, (stage, body, pout, rout)
        assert _hits_view(pout) == _hits_view(rout), (stage, body)


@pytest.fixture(scope="module")
def pair():
    port = RestServer(Node(device="cpu"))
    ref = JaxRestServer()
    for rest in (port, ref):
        status, out = _call(rest, "PUT", "/docs", MAPPINGS)
        assert status == 200 and out["acknowledged"]
    docs = _docs(7, 300)
    bulk = "".join(
        json.dumps({"index": {"_id": f"b{i}"}}) + "\n" + json.dumps(d) + "\n"
        for i, d in enumerate(docs[:200])
    )
    for rest in (port, ref):
        status, out = _call(rest, "POST", "/docs/_bulk", bulk)
        assert status == 200 and not out["errors"]
        for i, d in enumerate(docs[200:]):
            path = "/docs/_doc" if i % 2 else f"/docs/_doc/x{i}"
            status, _ = _call(rest, "POST", path, d)
            assert status == 200
        assert _call(rest, "POST", "/docs/_refresh")[0] == 200
    return port, ref


def test_search_matches_reference(pair):
    port, ref = pair
    _compare_all(port, ref, "initial")


def test_search_matches_after_delete_and_second_segment(pair):
    port, ref = pair
    for rest in (port, ref):
        for i in range(0, 200, 9):
            status, out = _call(rest, "DELETE", f"/docs/_doc/b{i}")
            assert status == 200 and out["result"] == "deleted"
        assert _call(rest, "POST", "/docs/_refresh")[0] == 200
    _compare_all(port, ref, "after delete")
    extra = _docs(11, 40)
    for rest in (port, ref):
        bulk = "".join(
            json.dumps({"index": {"_index": "docs", "_id": f"e{i}"}}) + "\n"
            + json.dumps(d) + "\n"
            for i, d in enumerate(extra)
        )
        status, out = _call(rest, "POST", "/_bulk", bulk)
        assert status == 200 and not out["errors"]
        assert _call(rest, "POST", "/docs/_refresh")[0] == 200
    _compare_all(port, ref, "two segments")


def test_write_and_error_responses_match_reference(pair):
    port, ref = pair
    for method, path, body in (
        ("GET", "/nosuch/_search", {"query": {"match_all": {}}}),
        ("POST", "/docs/_search", {"query": {"nosuch_query": {}}}),
        ("PUT", "/docs", MAPPINGS),
        ("DELETE", "/docs/_doc/never", None),
    ):
        ps, pout = _call(port, method, path, body)
        rs, rout = _call(ref, method, path, body)
        assert ps == rs, (path, pout, rout)
        if ps >= 400:
            assert pout["error"]["type"] == rout["error"]["type"] or ps == 400
        else:
            assert pout["result"] == rout["result"]
    ps, pout = _call(port, "GET", "/")
    assert ps == 200 and pout["version"]["number"].startswith("8.")


def test_rest_over_a_socket_on_cpu():
    import threading
    import urllib.request

    rest = RestServer(Node(device="cpu"))
    server = rest.serve("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def req(method, path, body=None):
            data = None if body is None else json.dumps(body).encode()
            r = urllib.request.Request(
                base + path, data=data, method=method,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(r) as resp:
                return json.loads(resp.read())

        req("PUT", "/s", {"mappings": {"properties": {"t": {"type": "text"}}}})
        req("POST", "/s/_doc/1", {"t": "hello world"})
        req("POST", "/s/_doc/2", {"t": "hello"})
        req("POST", "/s/_refresh")
        out = req("POST", "/s/_search", {"query": {"match": {"t": "hello"}}})
        assert [h["_id"] for h in out["hits"]["hits"]] == ["2", "1"]
        assert out["hits"]["total"] == {"value": 2, "relation": "eq"}
    finally:
        server.shutdown()
        server.server_close()


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "elasticsearch_tpu"), (path, name)


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys; import elasticsearch_tpu_torch.rest.server, "
        "elasticsearch_tpu_torch.ops.bm25_device, "
        "elasticsearch_tpu_torch.utils.corpus, "
        "elasticsearch_tpu_torch.exec.cost, "
        "elasticsearch_tpu_torch.search.can_match, "
        "elasticsearch_tpu_torch.ops.aggs_device, "
        "elasticsearch_tpu_torch.search.aggs; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'elasticsearch_tpu' or m.startswith('elasticsearch_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT_DIR.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert Node().device.type == "cuda"
        return
    from elasticsearch_tpu_torch.index.tiles import pack_segment
    from elasticsearch_tpu_torch.utils.corpus import build_zipf_segment

    with pytest.raises(RuntimeError, match="CUDA"):
        Node()
    with pytest.raises(RuntimeError, match="CUDA"):
        RestServer()
    _, seg = build_zipf_segment(50, vocab_size=40, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pack_segment(seg)
