"""HTTP/REST layer: Elasticsearch-compatible endpoints over a Node.

Port of elasticsearch_tpu/rest/server.py, trimmed to this slice's routes,
on the stdlib ThreadingHTTPServer:

    GET  /                          node banner
    PUT  /{index}                   create index
    DELETE /{index}                 delete index (and its IVF planes)
    GET  /{index}/_mapping          the mappings
    PUT  /{index}/_mapping          add fields to the mappings
    POST /{index}/_doc[/{id}]       index document (PUT with an id too)
    DELETE /{index}/_doc/{id}       delete document
    POST [/{index}]/_bulk           NDJSON bulk
    POST|GET /{index}/_refresh      refresh
    GET|POST /{index}/_search       search (with a `knn` section too)
    POST /{index}/_knn_search       kNN search: the body's `knn` object,
                                    a top-level filter folded into it
    POST [/{index}]/_cache/clear    drop filter-cache and IVF planes (of
                                    an index, a comma list or wildcard,
                                    or node-wide)

Responses and error payloads have the reference's shapes; a search shed
by the node's micro-batcher answers 429 with a Retry-After header. The
server runs one thread per connection: handler threads compile and
assemble concurrently, plain searches meet in the micro-batcher's thread,
and every thread launches on its current CUDA stream through the one
kernel library (ops/kernels.py loads it once under a lock). Left out:
every other API of the reference (cluster, cat, stats, aliases,
templates, scroll, async search, tracing and metrics headers).

Run a server:  python -m elasticsearch_tpu_torch.rest.server --port 9200
(the node runs on the CUDA device; --device cpu runs the plain versions).
"""

from __future__ import annotations

import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from ..device import DEFAULT_DEVICE
from ..node import ApiError, Node

Handler = Callable[[dict, dict, str], Any]


def _json(body: str) -> dict:
    return json.loads(body) if body and body.strip() else {}


def _knn_search_body(body: dict) -> dict:
    """`_knn_search` request body -> the equivalent `_search` body with a
    top-level `knn` section: the endpoint's own keys are the knn object,
    an optional top-level filter (folded into the section), and the
    ordinary fetch and paging keys, which pass through."""
    if "knn" not in body:
        raise ApiError(
            400, "parsing_exception", "[_knn_search] requires a [knn] body"
        )
    knn = dict(body["knn"]) if isinstance(body["knn"], dict) else body["knn"]
    out: dict = {}
    for key, value in body.items():
        if key == "knn":
            continue
        if key == "filter":
            if isinstance(knn, dict):
                knn = {**knn, "filter": value}
            continue
        out[key] = value
    out["knn"] = knn
    return out


def _flag(q: dict, name: str) -> bool:
    return q.get(name) in ("true", "")


class RestServer:
    """Routes REST requests to a Node (by default a node on the card)."""

    max_content_length = 100 * 1024 * 1024

    def __init__(self, node: Node | None = None, device=DEFAULT_DEVICE):
        self.node = node if node is not None else Node(device=device)
        self.routes: list[tuple[str, re.Pattern, Handler]] = []
        self._register_routes()

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        # {name} -> named group; literal _-prefixed routes register first.
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self.routes.append((method, re.compile(f"^{regex}$"), handler))

    def _register_routes(self) -> None:
        n = self.node
        r = self.route
        r("GET", "/", lambda p, q, b: {
            "name": n.node_name,
            "cluster_name": n.cluster_name,
            "version": {
                "number": "8.0.0-torch",
                "distribution": "elasticsearch-tpu-torch",
            },
            "tagline": "You Know, for Search",
        })
        r("POST", "/_bulk", lambda p, q, b: n.bulk(
            b, refresh=_flag(q, "refresh")
        ))
        r("PUT", "/_bulk", lambda p, q, b: n.bulk(
            b, refresh=_flag(q, "refresh")
        ))
        r("POST", "/{index}/_bulk", lambda p, q, b: n.bulk(
            b, default_index=p["index"], refresh=_flag(q, "refresh")
        ))
        for method in ("GET", "POST"):
            r(method, "/{index}/_search", lambda p, q, b: n.search(
                p["index"], _json(b)
            ))
            r(method, "/{index}/_refresh", lambda p, q, b: n.refresh(p["index"]))
        r("POST", "/{index}/_knn_search", lambda p, q, b: n.search(
            p["index"], _knn_search_body(_json(b))
        ))
        # The clear-cache API (the reference's RestClearIndicesCacheAction):
        # per-cache cleared counts; a missing concrete name is a 404.
        r("POST", "/_cache/clear", lambda p, q, b: n.clear_cache())
        r("POST", "/{index}/_cache/clear", lambda p, q, b: n.clear_cache(
            p["index"]
        ))
        r("GET", "/{index}/_mapping", lambda p, q, b: n.get_mapping(p["index"]))
        for method in ("PUT", "POST"):
            r(method, "/{index}/_mapping", lambda p, q, b: n.put_mapping(
                p["index"], _json(b)
            ))
        r("POST", "/{index}/_doc", lambda p, q, b: n.index_doc(
            p["index"], _json(b), None, refresh=_flag(q, "refresh")
        ))
        for method in ("PUT", "POST"):
            r(method, "/{index}/_doc/{id}", lambda p, q, b: n.index_doc(
                p["index"], _json(b), p["id"], refresh=_flag(q, "refresh")
            ))
        r("DELETE", "/{index}/_doc/{id}", lambda p, q, b: n.delete_doc(
            p["index"], p["id"], refresh=_flag(q, "refresh")
        ))
        r("PUT", "/{index}", lambda p, q, b: n.create_index(p["index"], _json(b)))
        r("DELETE", "/{index}", lambda p, q, b: n.delete_index(p["index"]))

    def dispatch(self, method: str, path: str, query: dict, body: str):
        """Returns (status, payload), ES-style error payloads on failure."""
        status, payload, _headers = self.dispatch_with_headers(
            method, path, query, body
        )
        return status, payload

    def dispatch_with_headers(
        self, method: str, path: str, query: dict, body: str
    ):
        """(status, payload, extra response headers): a shed search's 429
        carries Retry-After."""
        try:
            lookup = "GET" if method == "HEAD" else method
            path_matched = False
            for m, regex, handler in self.routes:
                match = regex.match(path)
                if not match:
                    continue
                if m != lookup:
                    path_matched = True
                    continue
                return 200, handler(match.groupdict(), query, body), {}
            if path_matched:
                raise ApiError(
                    405,
                    "method_not_allowed_exception",
                    f"Incorrect HTTP method for uri [{path}] and method "
                    f"[{method}]",
                )
            raise ApiError(
                400, "invalid_request", f"no handler found for uri [{path}]"
            )
        except ApiError as e:
            payload = {
                "error": {
                    "type": e.err_type,
                    "reason": e.reason,
                    "root_cause": [{"type": e.err_type, "reason": e.reason}],
                },
                "status": e.status,
            }
            headers = (
                {} if e.retry_after_s is None
                else {"Retry-After": str(e.retry_after_s)}
            )
            return e.status, payload, headers
        except json.JSONDecodeError as e:
            return 400, {
                "error": {"type": "parsing_exception", "reason": str(e)},
                "status": 400,
            }, {}
        except ValueError as e:
            return 400, {
                "error": {"type": "illegal_argument_exception", "reason": str(e)},
                "status": 400,
            }, {}

    def serve(self, host: str = "127.0.0.1", port: int = 9200) -> ThreadingHTTPServer:
        """A threading HTTP server over this REST front (not yet serving:
        call serve_forever(), e.g. on a thread)."""
        rest = self

        class RequestHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _handle(self):
                parsed = urlparse(self.path)
                query = {
                    key: vals[0]
                    for key, vals in parse_qs(
                        parsed.query, keep_blank_values=True
                    ).items()
                }
                length = int(self.headers.get("Content-Length") or 0)
                if length > rest.max_content_length:
                    headers = {}
                    status, payload = 413, {
                        "error": {
                            "type": "content_too_long_exception",
                            "reason": f"entity content is too long [{length}]",
                        },
                        "status": 413,
                    }
                    self.close_connection = True
                else:
                    body = self.rfile.read(length).decode("utf-8") if length else ""
                    status, payload, headers = rest.dispatch_with_headers(
                        self.command, parsed.path.rstrip("/") or "/", query, body
                    )
                data = json.dumps(payload).encode("utf-8")
                self.send_response(status)
                for name, value in headers.items():
                    self.send_header(name, value)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-elastic-product", "Elasticsearch")
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _handle

            def log_message(self, *args):  # quiet
                pass

        return _HttpServer((host, port), RequestHandler)


class _HttpServer(ThreadingHTTPServer):
    # A burst of concurrent clients must not overflow the accept queue:
    # socketserver's default backlog of 5 resets the sixth simultaneous
    # connect where the kernel aborts on overflow.
    request_queue_size = 128


def create_server(host: str = "127.0.0.1", port: int = 9200, device=DEFAULT_DEVICE):
    """(http_server, rest) pair; call http_server.serve_forever() to run."""
    rest = RestServer(device=device)
    return rest.serve(host, port), rest


def main():
    import argparse

    parser = argparse.ArgumentParser(description="elasticsearch-tpu-torch node")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9200)
    parser.add_argument("--device", default=DEFAULT_DEVICE)
    args = parser.parse_args()
    server, rest = create_server(args.host, args.port, device=args.device)
    print(json.dumps({
        "message": "started", "host": args.host, "port": args.port,
        "node": rest.node.node_name,
    }), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
