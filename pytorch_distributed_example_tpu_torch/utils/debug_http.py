"""Debug HTTP frontend — live observability over a local port.

A copy of the reference's `utils/debug_http.py`; its routes read the
port's `distributed._world`, its `ProcessGroupStatus`, the flight
recorder, `DDPLogger` and `ServeMetrics`.

Parity surface: torch's debug worker server + frontend
(`torch/distributed/debug/_frontend.py:12-70`, `_WorkerServer` binding
`_C/_distributed_c10d.pyi:105`): an in-process HTTP
endpoint that exposes the distributed runtime's state — process-group
status, flight-recorder trace, DDP logging data — so a hung or slow job
can be inspected with `curl` instead of a debugger.

Routes (all JSON):
  /            index of routes
  /world       mode, process rank, groups and their ranks/backends
  /status      per-group ProcessGroupStatus (last enqueued/completed op)
  /flight_recorder   ring-buffer dump (the dump-on-timeout payload, live)
  /ddp_logging tables from registered DDPLogger instances
  /serve       ServeMetrics snapshots from registered serve engines
               (queue depth, slot occupancy, TTFT/TPOT/e2e percentiles,
               goodput tokens/s)

Usage:
    from pytorch_distributed_example_tpu_torch.utils.debug_http import DebugServer
    srv = DebugServer()          # port=0 -> ephemeral; .port tells you
    srv.register_ddp_logger("model", ddp.logger)
    srv.register_serve_metrics("engine", engine.metrics)
    ...
    srv.shutdown()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict


class _UnknownRoute(Exception):
    """Raised only by route dispatch — a KeyError from inside a handler
    must surface as a 500 with the real exception, not a fake 404."""


class DebugServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._loggers: Dict[str, object] = {}
        self._serve_metrics: Dict[str, object] = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def do_GET(self):
                try:
                    payload = outer._route(self.path)
                except _UnknownRoute:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b'{"error": "unknown route"}')
                    return
                except Exception as e:  # route handler failure -> 500
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(
                        json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                    )
                    return
                body = json.dumps(payload, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tdx-debug-http", daemon=True
        )
        self._thread.start()

    # -- routes ------------------------------------------------------------
    def _route(self, path: str):
        path = path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/":
            return {
                "routes": [
                    "/world",
                    "/status",
                    "/flight_recorder",
                    "/ddp_logging",
                    "/serve",
                ]
            }
        if path == "/world":
            return self._world()
        if path == "/status":
            return self._status()
        if path == "/flight_recorder":
            from .flight_recorder import global_recorder

            return global_recorder().dump()
        if path == "/ddp_logging":
            return {
                name: lg.get_ddp_logging_data()
                for name, lg in self._loggers.items()
            }
        if path == "/serve":
            return {
                name: m.snapshot()
                for name, m in self._serve_metrics.items()
            }
        raise _UnknownRoute(path)

    def _world(self):
        from .. import distributed as dist

        if not dist.is_initialized():
            return {"initialized": False}
        w = dist._world
        return {
            "initialized": True,
            "mode": w.mode,
            "process_rank": w.process_rank,
            "generation": w.generation,
            "groups": {
                name: {
                    "ranks": pg.ranks,
                    "backend": pg.backend_name,
                    "size": pg.size(),
                }
                for name, pg in w.pg_map.items()
            },
        }

    def _status(self):
        from .. import distributed as dist

        if not dist.is_initialized():
            return {}
        return {
            name: pg.status.as_dict()
            for name, pg in dist._world.pg_map.items()
        }

    # -- registration / lifecycle ------------------------------------------
    def register_ddp_logger(self, name: str, logger) -> None:
        self._loggers[name] = logger

    def register_serve_metrics(self, name: str, metrics) -> None:
        """Expose a ServeMetrics block (serve/metrics.py) at /serve."""
        self._serve_metrics[name] = metrics

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
