"""Live metrics endpoint — a stdlib-only scrape target
(``repro.obs.server``).

``MetricsServer(obs)`` runs a ``http.server.ThreadingHTTPServer`` on a
daemon thread serving the shared :class:`~repro_torch.obs.Observability`
bundle:

- ``GET /metrics`` — Prometheus text exposition
  (``registry.to_prometheus()``, content type ``text/plain;
  version=0.0.4``) for scrapers;
- ``GET /metrics.json`` — the full registry snapshot + tracer summary
  (``obs.snapshot()``) for humans and tests.

Both render at REQUEST time from the registry's current state, so
whatever the engine mirrored at its last flush is what a scrape sees —
the server never touches the engine or the device.  ``port=0`` binds
an ephemeral port (read it back from ``.port``); ``close()`` shuts the
listener down and joins the thread, which is what ``serve
--metrics-port`` does when the engine winds down.  No dependencies
beyond the standard library.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["MetricsServer"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background scrape endpoint over an ``Observability`` bundle."""

    def __init__(self, obs, host: str = "127.0.0.1", port: int = 0):
        self.obs = obs
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = outer.obs.registry.to_prometheus().encode()
                    ctype = PROM_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(outer.obs.snapshot(),
                                      indent=1).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "unknown path "
                                    f"{path!r} (try /metrics)")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass                # scrapes must not spam the console

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-metrics-server", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
