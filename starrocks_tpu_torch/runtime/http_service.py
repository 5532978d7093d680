"""HTTP SQL service.

Reference behavior: the BE/FE HTTP surfaces (be/src/service/service_be/
http_service.h, http/action/*: SQL execute, metrics, profile endpoints; FE
http/rest/ExecuteSqlAction.java). Minimal but real server:

  POST /query   {"sql": "..."}  -> {"columns": [...], "rows": [...], "ms": t}
  PUT  /api/load/{table}        -> stream load: CSV/JSON body staged +
                                   micro-batch committed by the ingest
                                   plane (?format=csv|json&label=...&
                                   columns=a,b&column_separator=,);
                                   429 on staging backpressure
  GET  /api/ingest              -> ingest plane stats + routine-load jobs
  GET  /metrics                 -> Prometheus text
  GET  /profile                 -> last query's RuntimeProfile render
  GET  /tables                  -> catalog listing

Runs on the stdlib http.server (threaded) over a serving tier
(runtime/serving.py): each request executes on a per-request Session
sharing the tier's catalog/device-cache/store, dispatched through the
priority executor pool — concurrent requests genuinely overlap, and warm
repeats take the tier's inline fast path.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import metrics
from .serving import ServingTier
from .session import Session


def make_handler(session: Session, tier: ServingTier):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # quiet; metrics cover observability

        def _send(self, code: int, body: str, ctype="application/json"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            import re

            m = re.fullmatch(r"/api/query/(\d+)/(profile|trace|otel)",
                             self.path)
            if m is not None:
                from .profile import PROFILE_MANAGER, otel_json, trace_json

                e = PROFILE_MANAGER.get(int(m.group(1)))
                if e is None:
                    self._send(404, json.dumps(
                        {"error": f"no profile retained for query "
                                  f"{m.group(1)}"}))
                elif m.group(2) == "trace":
                    # Chrome trace_event format — loads directly in
                    # Perfetto / chrome://tracing
                    self._send(200, json.dumps(trace_json(e)))
                elif m.group(2) == "otel":
                    # OTLP/JSON ResourceSpans — POSTable verbatim to any
                    # OpenTelemetry collector's /v1/traces
                    self._send(200, json.dumps(otel_json(e)))
                else:
                    body = {k: e.get(k) for k in (
                        "query_id", "user", "sql", "state", "ms", "rows",
                        "queue_wait_ms", "slow", "stage", "profile")}
                    body["text"] = e.get("text", "")
                    self._send(200, json.dumps(body, default=str))
                return
            if self.path == "/metrics":
                from . import failpoint

                # failpoint armed/hit series ride the same payload so a
                # chaos run is observable from the standard scrape
                self._send(200, metrics.render_prometheus()
                           + failpoint.render_prometheus(), "text/plain")
            elif self.path == "/profile":
                prof = session.last_profile
                self._send(200, prof.render() if prof else "no queries yet",
                           "text/plain")
            elif self.path == "/tables":
                self._send(200, json.dumps(sorted(session.catalog.tables)))
            elif self.path == "/api/queries":
                from .lifecycle import REGISTRY

                cols = ("id", "user", "state", "elapsed_ms", "group",
                        "mem_bytes", "stage", "sql")
                self._send(200, json.dumps(
                    [dict(zip(cols, r)) for r in REGISTRY.snapshot()]))
            elif self.path == "/api/audit":
                from .audit import AUDIT

                self._send(200, json.dumps(
                    {"audit": AUDIT.snapshot(limit=500),
                     "stats": AUDIT.stats()}, default=str))
            elif self.path == "/api/events":
                from .events import EVENTS

                self._send(200, json.dumps(
                    {"events": EVENTS.snapshot(limit=500),
                     "counts": EVENTS.stats()}, default=str))
            elif self.path == "/api/metrics/history":
                from .metrics import HISTORY

                self._send(200, json.dumps(
                    {"samples": HISTORY.snapshot()}, default=str))
            elif self.path == "/api/workload":
                from .workload import WORKLOAD

                self._send(200, json.dumps(
                    {"workload": WORKLOAD.snapshot(limit=500),
                     "stats": WORKLOAD.stats()}, default=str))
            elif self.path == "/api/alerts":
                from .alerts import ALERTS

                self._send(200, json.dumps(
                    {"alerts": ALERTS.snapshot(),
                     "stats": ALERTS.stats()}, default=str))
            elif self.path == "/api/ingest":
                plane = session.ingest_plane()
                self._send(200, json.dumps(
                    {"ingest": plane.stats(),
                     "jobs": plane.poller.snapshot()}, default=str))
            elif self.path == "/api/debug/bundle":
                from .audit import diagnostic_bundle

                self._send(200, json.dumps(
                    diagnostic_bundle(session), default=str))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def _auth_user(self):
            """HTTP Basic auth against the shared auth manager (reference:
            the FE http server's BaseAction auth). No header = root, which
            only authenticates while root's password is empty."""
            import base64

            auth = session.auth()
            hdr = self.headers.get("Authorization", "")
            user, pw = "root", ""
            if hdr.startswith("Basic "):
                try:
                    user, _, pw = base64.b64decode(
                        hdr[6:]).decode().partition(":")
                except Exception:  # lint: swallow-ok — bad header = deny
                    return None
            return user if auth.verify_plain(user, pw) else None

        def do_PUT(self):
            """Stream load (reference: the BE's `PUT /api/{db}/{table}/
            _stream_load`): body rows stage into the ingest plane and
            this request returns once its micro-batch commit is visible,
            with the txn-label receipt. A replayed label answers with
            the ORIGINAL receipt (exactly-once); staging over budget
            answers 429 and the client retries with the SAME label."""
            import re
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            m = re.fullmatch(r"/api/load/([A-Za-z_][A-Za-z0-9_]*)", u.path)
            if m is None:
                self._send(404, json.dumps({"error": "not found"}))
                return
            user = self._auth_user()
            if user is None:
                self.send_response(401)
                self.send_header("WWW-Authenticate",
                                 'Basic realm="starrocks_tpu"')
                self.end_headers()
                return
            from ..ingest import IngestBackpressure

            table = m.group(1).lower()
            q = {k: v[-1] for k, v in parse_qs(u.query).items()}
            columns = [c for c in q.get("columns", "").split(",")
                       if c.strip()] or None
            t0 = time.time()
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode("utf-8", errors="replace")
                auth = session.auth()
                if not auth.is_admin(user):
                    auth.require(user, table, "insert")
                plane = session.ingest_plane()
                rows = plane.parse_body(
                    session, table, body,
                    fmt=q.get("format", "csv").lower(), columns=columns,
                    sep=q.get("column_separator", ","))
                receipt = dict(plane.load(
                    tier.new_session(user), table, rows,
                    label=q.get("label"), user=user))
                receipt["ms"] = round((time.time() - t0) * 1000, 1)
                self._send(200, json.dumps(
                    {"status": "ok", **receipt}, default=str))
            except IngestBackpressure as e:
                self._send(429, json.dumps(
                    {"status": "backpressure", "error": str(e)}))
            except PermissionError as e:
                self._send(403, json.dumps({"error": str(e)}))
            except Exception as e:  # lint: swallow-ok — typed error -> 400
                self._send(
                    400,
                    json.dumps({"error": f"{type(e).__name__}: {e}"}),
                )

        def do_POST(self):
            import re

            m = re.fullmatch(r"/api/query/(\d+)/cancel", self.path)
            if m is not None:
                # tier-free by design: the executor pool may be saturated
                # by the very query being cancelled; cancellation is a
                # registry flag the running query observes at its next
                # stage boundary
                from .lifecycle import REGISTRY

                user = self._auth_user()
                if user is None:
                    self.send_response(401)
                    self.send_header("WWW-Authenticate",
                                     'Basic realm="starrocks_tpu"')
                    self.end_headers()
                    return
                try:
                    ok = REGISTRY.cancel(
                        int(m.group(1)), requester=user,
                        admin=session.auth().is_admin(user))
                except PermissionError as e:
                    self._send(403, json.dumps({"error": str(e)}))
                    return
                self._send(200, json.dumps({
                    "cancelled": ok,
                    "note": ("cooperative: takes effect at the next stage "
                             "boundary" if ok else
                             "query not running; cancel is a no-op")}))
                return
            if self.path != "/query":
                self._send(404, json.dumps({"error": "not found"}))
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                sql = payload["sql"]
            except Exception as e:  # lint: swallow-ok — 400 response
                self._send(400, json.dumps({"error": f"bad request: {e}"}))
                return
            user = self._auth_user()
            if user is None:
                self.send_response(401)
                self.send_header("WWW-Authenticate",
                                 'Basic realm="starrocks_tpu"')
                self.end_headers()
                return
            from .failpoint import fail_point

            t0 = time.time()
            try:
                fail_point("http::query")
                # per-request session over the shared tier: user identity
                # and any SET in this request stay request-local
                sess = tier.new_session(user)
                res = tier.execute(sess, sql)
                if res is None:
                    body = {"ok": True}
                elif isinstance(res, (list, str, int)):
                    body = {"result": res}
                else:
                    body = {"columns": res.column_names, "rows": res.rows()}
                body["ms"] = round((time.time() - t0) * 1000, 1)
                self._send(200, json.dumps(body, default=str))
            except Exception as e:  # lint: swallow-ok — typed error -> 400
                self._send(
                    400,
                    json.dumps({"error": f"{type(e).__name__}: {e}"}),
                )

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # burst connects from client fleets overflow the default backlog of 5
    request_queue_size = 128


class SqlHttpServer:
    def __init__(self, session: Session, host: str = "127.0.0.1",
                 port: int = 0, tier: ServingTier | None = None):
        self.session = session
        self.tier = tier or ServingTier(session)
        self.httpd = _Server(
            (host, port), make_handler(session, self.tier)
        )
        self.port = self.httpd.server_address[1]
        # lint: unguarded-ok — written once by the owner thread in start()
        self._thread: threading.Thread | None = None

    def start(self):
        from .metrics import HISTORY
        from .watchdog import WATCHDOG

        # a serving surface is up: start the metrics-history sampler so
        # /api/metrics/history has trajectory data, and the stuck-query
        # watchdog (both idempotent; gated by their enable knobs)
        HISTORY.ensure_started()
        WATCHDOG.ensure_started()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self.tier.shutdown()


def serve(data_dir: str | None = None, port: int = 8030,
          mysql_port: int = 9030, device=None):
    """CLI entry: python -m starrocks_tpu_torch.runtime.http_service
    [data_dir [port [mysql_port]]] [--device cpu]

    Serves BOTH front doors over ONE serving tier (the reference FE
    listens on http_port 8030 and query_port 9030 the same way): HTTP
    JSON on `port`, MySQL protocol on `mysql_port` (0 disables). The
    shared tier means shared caches, shared admission, one executor
    pool. The template Session runs on the card unless `device` asks for
    another (e.g. "cpu")."""
    s = Session(data_dir=data_dir, device=device)
    tier = ServingTier(s)
    srv = SqlHttpServer(s, port=port, tier=tier)
    if mysql_port:
        from .mysql_service import MySQLServer

        try:
            my = MySQLServer(s, port=mysql_port, tier=tier).start()
            print(f"starrocks_tpu MySQL protocol on 127.0.0.1:{my.port}")
        except OSError as e:
            # HTTP service must survive a busy query port (9030 may host a
            # real FE on shared boxes); pass mysql_port=0 to silence
            print(f"mysql port {mysql_port} unavailable ({e}); "
                  "continuing HTTP-only")
    print(f"starrocks_tpu SQL service on http://127.0.0.1:{srv.port} "
          f"({s.device})")
    srv.httpd.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="the port's SQL service: HTTP and MySQL front doors "
                    "over one serving tier")
    ap.add_argument("data_dir", nargs="?", default=None)
    ap.add_argument("port", nargs="?", type=int, default=8030)
    ap.add_argument("mysql_port", nargs="?", type=int, default=9030)
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card; 'cpu' "
                         "runs every operator on the CPU)")
    a = ap.parse_args()
    serve(data_dir=a.data_dir, port=a.port, mysql_port=a.mysql_port,
          device=a.device)
