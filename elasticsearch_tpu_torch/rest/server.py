"""HTTP JSON REST API.

Counterpart of `elasticsearch_tpu/rest/server.py` (ref: RestController
PathTrie dispatch + the rest/action handlers), trimmed to the write and
search path: `GET /`, `PUT` / `DELETE /{index}`, documents
(`PUT|POST /{index}/_doc|{type}/{id}`, `POST /{index}/_doc`,
`GET|DELETE /{index}/_doc|{type}/{id}`, `POST /{index}/_update/{id}`),
`_bulk`, `_refresh`, `_flush`, `_forcemerge`, `_recovery`, `_search`
(with `scroll` and `search_type`), `GET|POST /_search/scroll`,
`DELETE /_search/scroll`, `_msearch`, `_count` and `GET /_nodes/stats`. `_bulk` and `_msearch` take NDJSON bodies; other
bodies are JSON. The server is the standard library's
ThreadingHTTPServer: the control plane is host Python, the card does the
searching.

    python -m elasticsearch_tpu_torch.rest.server --port 9200 \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from .. import __version__
from ..node import Node
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError


class Route:
    def __init__(self, method: str, pattern: str, handler):
        self.method = method
        self.handler = handler
        parts = pattern.strip("/").split("/")
        regex = []
        self.params: list[str] = []
        for p in parts:
            if p.startswith("{"):
                name = p[1:-1]
                self.params.append(name)
                regex.append(r"(?P<%s>[^/]+)" % name)
            else:
                regex.append(re.escape(p))
        self.regex = re.compile("^/" + "/".join(regex) + "/?$")
        # literal segments outrank {param} segments position by position
        # (ref: RestController PathTrie); the smallest key wins
        self.spec_key = tuple(1 if p.startswith("{") else 0 for p in parts)

    def match(self, method: str, path: str):
        if method != self.method:
            return None
        m = self.regex.match(path)
        if m is None:
            return None
        # decoded after the split: %2F inside an id stays one segment
        return {k: unquote(v) for k, v in m.groupdict().items()}


class RestDispatcher:
    """Method+path -> handler registry (ref: RestController PathTrie)."""

    def __init__(self, node: Node):
        self.node = node
        self.routes: list[Route] = []
        register_routes(self)

    def route(self, method: str, pattern: str):
        def deco(fn):
            self.routes.append(Route(method, pattern, fn))
            return fn
        return deco

    def dispatch(self, method: str, path: str, params: dict, body):
        effective = "GET" if method == "HEAD" else method
        best = None
        for r in self.routes:
            kw = r.match(effective, path)
            if kw is not None and (best is None
                                   or r.spec_key < best[0].spec_key):
                best = (r, kw)
        if best is not None:
            return best[0].handler(self.node, params, body, **best[1])
        raise IllegalArgumentError(
            f"no handler found for uri [{path}] and method [{method}]")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _truthy(params: dict, key: str) -> bool:
    """REST boolean params accept true / 1 / '' (a bare flag)."""
    return params.get(key) in ("true", "1", "", "wait_for")


class RestStatus:
    """A payload with an explicit HTTP status (e.g. a 404 delete)."""

    def __init__(self, status: int, payload):
        self.status = status
        self.payload = payload


def _search_body(params: dict, body) -> dict:
    """Search body + the URL params every search route honours (ref:
    RestSearchAction.parseSearchRequest)."""
    b = _body_query(params, body)
    if params.get("query_cache") is not None:
        b = dict(b)
        b["query_cache"] = params["query_cache"]
    if params.get("timeout") is not None:
        b = dict(b)
        b["timeout"] = params["timeout"]
    if params.get("allow_partial_search_results") is not None:
        b = dict(b)
        b["allow_partial_search_results"] = _truthy(
            params, "allow_partial_search_results")
    return b


def _body_query(params: dict, body) -> dict:
    """Merge URI params (q, size, from, sort, _source) into a search
    body (ref: RestSearchAction.parseSearchRequest)."""
    body = dict(body or {})
    q = params.get("q")
    if q and "query" not in body:
        body["query"] = {"query_string": {"query": q}}
    for key in ("size", "from"):
        if key in params:
            body[key] = int(params[key])
    if "sort" in params and "sort" not in body:
        entries = []
        for part in params["sort"].split(","):
            if ":" in part:
                f, o = part.split(":", 1)
                entries.append({f: o})
            else:
                entries.append({part: "asc"})
        body["sort"] = entries
    inc = params.get("_source_include") or params.get("_source_includes")
    exc = params.get("_source_exclude") or params.get("_source_excludes")
    if inc or exc:
        body["_source"] = {"includes": inc.split(",") if inc else [],
                           "excludes": exc.split(",") if exc else []}
    elif "_source" in params:
        v = params["_source"]
        body["_source"] = (True if v == "true" else
                           False if v == "false" else v.split(","))
    return body


def register_routes(d: RestDispatcher) -> None:
    @d.route("GET", "/")
    def root(node, params, body):
        return {
            "name": node.name,
            "cluster_name": node.cluster_name,
            "version": {"number": __version__,
                        "build_flavor": "torch-cuda"},
            "tagline": "You Know, for Search",
        }

    @d.route("GET", "/_nodes/stats")
    @d.route("GET", "/_nodes/stats/{metric}")
    def nodes_stats(node, params, body, metric=None):
        r = node.nodes_stats()
        if metric:
            keep = {m.strip() for m in metric.split(",")}
            for nid, stats in r.get("nodes", {}).items():
                base = {k: stats[k] for k in ("name", "timestamp")
                        if k in stats}
                base.update({k: v for k, v in stats.items() if k in keep})
                r["nodes"][nid] = base
        return r

    # -- scroll (ref: RestSearchScrollAction / RestClearScrollAction) -----
    @d.route("POST", "/_search/scroll")
    @d.route("GET", "/_search/scroll")
    def scroll(node, params, body, **kw):
        body = body or {}
        sid = body.get("scroll_id") or params.get("scroll_id")
        keepalive = body.get("scroll") or params.get("scroll")
        return node.scroll(sid, keepalive, tenant=params.get("tenant_id"))

    @d.route("DELETE", "/_search/scroll")
    def clear_scroll(node, params, body, **kw):
        ids = (body or {}).get("scroll_id")
        if isinstance(ids, str):
            ids = [ids]
        r = node.clear_scroll(ids)
        if r.pop("_missing", False):
            return RestStatus(404, r)
        return r

    # -- search (registered before the /{index} wildcards) ----------------
    @d.route("GET", "/_search")
    @d.route("POST", "/_search")
    def search_all(node, params, body):
        return node.search(None, _search_body(params, body),
                           scroll=params.get("scroll"),
                           search_type=params.get("search_type"),
                           tenant=params.get("tenant_id"))

    @d.route("GET", "/{index}/_search")
    @d.route("POST", "/{index}/_search")
    def search(node, params, body, index):
        return node.search(index, _search_body(params, body),
                           scroll=params.get("scroll"),
                           search_type=params.get("search_type"),
                           tenant=params.get("tenant_id"))

    @d.route("POST", "/_msearch")
    @d.route("POST", "/{index}/_msearch")
    def msearch(node, params, body, index=None):
        # NDJSON (header, body) pairs; the whole batch rides one
        # dispatch-scheduler pass, each item with its own took / status
        requests = []
        lines = body if isinstance(body, list) else []
        for i in range(0, len(lines) - 1, 2):
            header, search_body = lines[i] or {}, lines[i + 1]
            requests.append((header.get("index", index), search_body,
                             header.get("search_type",
                                        params.get("search_type"))))
        return node.msearch(requests, tenant=params.get("tenant_id"))

    @d.route("GET", "/_count")
    @d.route("POST", "/_count")
    def count_all(node, params, body):
        return node.count(None, _body_query(params, body))

    @d.route("GET", "/{index}/_count")
    @d.route("POST", "/{index}/_count")
    def count(node, params, body, index):
        return node.count(index, _body_query(params, body))

    # -- bulk -------------------------------------------------------------
    @d.route("POST", "/_bulk")
    @d.route("PUT", "/_bulk")
    @d.route("POST", "/{index}/_bulk")
    def bulk(node, params, body, index=None, type=None):
        lines = body if isinstance(body, list) else []
        ops = []
        i = 0
        while i < len(lines):
            action, meta = next(iter(lines[i].items()))
            meta = meta or {}
            did = meta.get("_id")
            payload = {"_index": meta.get("_index", index),
                       "_id": str(did) if did is not None else None,
                       "_type": meta.get("_type", type),
                       "_routing": meta.get("_routing",
                                            meta.get("routing"))}
            if action in ("index", "create", "update"):
                i += 1
                payload["doc"] = lines[i] if i < len(lines) else {}
            ops.append((action, payload))
            i += 1
        refresh = params.get("refresh") in ("true", "", "wait_for")
        return node.bulk(ops, refresh=refresh)

    # -- maintenance ------------------------------------------------------
    @d.route("POST", "/_refresh")
    @d.route("POST", "/{index}/_refresh")
    @d.route("GET", "/{index}/_refresh")
    def refresh(node, params, body, index=None):
        return node.refresh(index)

    @d.route("POST", "/_flush")
    @d.route("POST", "/{index}/_flush")
    def flush(node, params, body, index=None):
        return node.flush(index)

    @d.route("GET", "/_recovery")
    @d.route("GET", "/{index}/_recovery")
    def recovery(node, params, body, index=None):
        return node.recovery_status(index)

    @d.route("POST", "/{index}/_forcemerge")
    @d.route("POST", "/{index}/_optimize")  # legacy 2.x name
    def forcemerge(node, params, body, index):
        return node.force_merge(index,
                                int(params.get("max_num_segments", 1)))

    # -- documents --------------------------------------------------------
    @d.route("POST", "/{index}/_doc")
    def index_auto_id(node, params, body, index):
        return node.index_doc(index, None, body or {},
                              refresh=params.get("refresh") == "true")

    @d.route("PUT", "/{index}/_doc/{id}")
    @d.route("POST", "/{index}/_doc/{id}")
    def index_doc(node, params, body, index, id, doc_type=None):
        version = params.get("version")
        if params.get("op_type") == "create":
            from ..utils.errors import VersionConflictError
            try:
                node.get_doc(index, id, routing=params.get("routing"))
                exists = True
            except ElasticsearchTpuError:
                exists = False
            if exists:
                raise VersionConflictError(index, id, -1, -1)
        return node.index_doc(index, id, body or {},
                              version=int(version) if version else None,
                              routing=params.get("routing"),
                              refresh=_truthy(params, "refresh"),
                              doc_type=doc_type,
                              version_type=params.get("version_type",
                                                      "internal"),
                              timestamp=params.get("timestamp"))

    @d.route("GET", "/{index}/_doc/{id}")
    def get_doc(node, params, body, index, id, doc_type=None):
        realtime = params.get("realtime") not in ("false", "0")
        if _truthy(params, "refresh"):
            node.refresh(index)
        r = node.get_doc(index, id, routing=params.get("routing"),
                         doc_type=doc_type, realtime=realtime)
        src = r.get("_source")
        r["_source"] = (json.loads(src) if isinstance(src, (bytes, str))
                        else (src or {}))
        if params.get("_source") == "false":
            r.pop("_source", None)
        return r

    @d.route("DELETE", "/{index}/_doc/{id}")
    def delete_doc(node, params, body, index, id, doc_type=None):
        version = params.get("version")
        r = node.delete_doc(index, id,
                            version=int(version) if version else None,
                            routing=params.get("routing"),
                            refresh=_truthy(params, "refresh"),
                            doc_type=doc_type,
                            version_type=params.get("version_type",
                                                    "internal"))
        if not r.get("found"):
            return RestStatus(404, {**r, "found": False})
        return r

    @d.route("POST", "/{index}/_update/{id}")
    def update_doc(node, params, body, index, id, doc_type=None):
        version = params.get("version")
        return node.update_doc(index, id, dict(body or {}),
                               refresh=_truthy(params, "refresh"),
                               doc_type=doc_type,
                               routing=params.get("routing"),
                               version=int(version) if version else None)

    # -- index admin and typed documents (last: bare /{index} patterns) ---
    @d.route("PUT", "/{index}")
    def create_index(node, params, body, index):
        body = body or {}
        return node.create_index(index, body.get("settings"),
                                 body.get("mappings"),
                                 aliases=body.get("aliases"),
                                 warmers=body.get("warmers"))

    @d.route("DELETE", "/{index}")
    def delete_index(node, params, body, index):
        return node.delete_index(index)

    @d.route("PUT", "/{index}/{type}/{id}")
    @d.route("POST", "/{index}/{type}/{id}")
    def index_doc_typed(node, params, body, index, type, id):
        if type.startswith("_"):
            raise IllegalArgumentError(f"no handler for type [{type}]")
        return index_doc(node, params, body, index, id, doc_type=type)

    @d.route("GET", "/{index}/{type}/{id}")
    def get_doc_typed(node, params, body, index, type, id):
        if type.startswith("_") and type != "_all":
            raise IllegalArgumentError(f"no handler for type [{type}]")
        return get_doc(node, params, body, index, id, doc_type=type)

    @d.route("DELETE", "/{index}/{type}/{id}")
    def delete_doc_typed(node, params, body, index, type, id):
        if type.startswith("_") and type != "_all":
            raise IllegalArgumentError(f"no handler for type [{type}]")
        return delete_doc(node, params, body, index, id, doc_type=type)


def parse_request_body(path: str, raw: bytes):
    """The body of a request: NDJSON lines for `_bulk` / `_msearch`, one
    JSON value otherwise, None when empty."""
    if not raw.strip():
        return None
    if path.rstrip("/").endswith(("_bulk", "_msearch")):
        return [json.loads(line) for line in raw.decode("utf-8").splitlines()
                if line.strip()]
    return json.loads(raw)


class RestServer:
    """HTTP front end for a Node (ref: HttpServer + RestController)."""

    def __init__(self, node: Node, host: str = "127.0.0.1", port: int = 9200):
        self.node = node
        self.dispatcher = RestDispatcher(node)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _respond(self, status: int, payload, pretty: bool = False,
                         head_only: bool = False,
                         headers: dict | None = None):
                data = json.dumps(payload,
                                  indent=2 if pretty else None).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for hk, hv in (headers or {}).items():
                    self.send_header(hk, hv)
                self.end_headers()
                if not head_only:
                    self.wfile.write(data)

            def _handle(self, method: str):
                parsed = urlparse(self.path)
                req_path = parsed.path
                params = {k: v[0] for k, v in parse_qs(parsed.query).items()
                          if v}
                for flag in parsed.query.split("&"):
                    if flag and "=" not in flag:
                        params[flag] = "true"
                tenant_hdr = self.headers.get("X-Tenant-Id")
                if tenant_hdr and "tenant_id" not in params:
                    params["tenant_id"] = tenant_hdr
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                try:
                    body = parse_request_body(req_path, raw)
                    result = outer.dispatcher.dispatch(
                        method, req_path, params, body)
                    status = 200
                    if isinstance(result, RestStatus):
                        status, result = result.status, result.payload
                    elif method in ("POST", "PUT") \
                            and isinstance(result, dict) \
                            and result.get("created"):
                        status = 201
                    self._respond(status, result,
                                  pretty=params.get("pretty") == "true",
                                  head_only=(method == "HEAD"))
                except ElasticsearchTpuError as e:
                    hdrs = None
                    ra = getattr(e, "retry_after_s", None)
                    if ra is not None:
                        from ..search.traffic import retry_after_header
                        hdrs = {"Retry-After": retry_after_header(ra)}
                    self._respond(e.status, {"error": e.to_dict(),
                                             "status": e.status},
                                  head_only=(method == "HEAD"),
                                  headers=hdrs)
                except json.JSONDecodeError as e:
                    self._respond(400, {"error": {
                        "type": "parse_exception",
                        "reason": f"request body is not valid JSON: {e}"},
                        "status": 400})
                except Exception as e:  # noqa: BLE001 - the 500 boundary
                    self._respond(500, {"error": {
                        "type": type(e).__name__, "reason": str(e)},
                        "status": 500})

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_DELETE(self):
                self._handle("DELETE")

            def do_HEAD(self):
                self._handle("HEAD")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> "RestServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def main():
    import argparse

    ap = argparse.ArgumentParser(description="elasticsearch_tpu_torch node")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--shards", type=int, default=None)
    args = ap.parse_args()
    overrides: dict = {}
    if args.shards is not None:
        overrides["index.number_of_shards"] = args.shards
    node = Node(overrides, device=args.device)
    server = RestServer(node, args.host, args.port).start()
    print(f"node [{node.name}] listening on http://{server.host}:"
          f"{server.port} ({node.device})")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
        node.close()


if __name__ == "__main__":
    main()
