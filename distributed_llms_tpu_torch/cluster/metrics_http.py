"""Prometheus-format HTTP exposition for the coordinator (PyTorch port of
``distributed_llms_tpu/cluster/metrics_http.py``), a dependency-free
asyncio HTTP/1.1 server over the process-wide registry
(``core/observability.py``):

- ``GET /metrics``  -> Prometheus text exposition (version 0.0.4)
- ``GET /healthz``  -> 200 ``ok`` (a liveness/readiness probe target)
- ``GET /status``   -> coordinator status as JSON (worker registry, shard
  assignment, queue depth — the REPL's ``status`` verb over HTTP)
"""

from __future__ import annotations

import asyncio
import json
from typing import Callable

from ..core.observability import METRICS, get_logger

log = get_logger("metrics_http")

_MAX_REQUEST_LINE = 8192


class MetricsServer:
    """Serves the process-wide METRICS registry plus an optional status
    callback over plain HTTP."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 9100,
        status_fn: Callable[[], dict] | None = None,
    ) -> None:
        self.host = host
        self.port = port
        self.status_fn = status_fn
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.StreamWriter] = set()

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        log.info("metrics endpoint on http://%s:%s/metrics", addr[0], addr[1])
        return addr[0], addr[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Python 3.12's wait_closed waits for in-flight handlers; kick
            # idle/slow connections loose so shutdown can't be held hostage.
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conns.add(writer)

        async def read_phase() -> tuple[str, str] | None:
            line = await reader.readline()
            if len(line) > _MAX_REQUEST_LINE:
                await self._respond(writer, 414, "text/plain", "request line too long")
                return None
            parts = line.decode("latin-1", "replace").split()
            if len(parts) < 2:
                await self._respond(writer, 400, "text/plain", "bad request")
                return None
            # Drain headers (we never need them; the count cap plus the
            # outer deadline keep this bounded).
            for _ in range(100):
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            else:
                await self._respond(writer, 431, "text/plain", "too many headers")
                return None
            return parts[0], parts[1]

        try:
            # One deadline for the whole read phase: an idle or trickling
            # client can hold a connection (and therefore wait_closed at
            # shutdown) for at most this long.  (wait_for, not
            # asyncio.timeout: pyproject allows Python 3.10.)
            parsed = await asyncio.wait_for(read_phase(), 10.0)
            if parsed is None:
                return
            method, path = parsed
            if method != "GET":
                await self._respond(writer, 405, "text/plain", "method not allowed")
            elif path == "/metrics":
                await self._respond(
                    writer,
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    METRICS.prometheus_text(),
                )
            elif path == "/healthz":
                await self._respond(writer, 200, "text/plain", "ok\n")
            elif path == "/status" and self.status_fn is not None:
                await self._respond(
                    writer, 200, "application/json", json.dumps(self.status_fn()) + "\n"
                )
            else:
                await self._respond(writer, 404, "text/plain", "not found")
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError):
            # ValueError: StreamReader raises it (via LimitOverrunError) when
            # a line exceeds the reader's own buffer limit.
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _respond(
        self, writer: asyncio.StreamWriter, code: int, ctype: str, body: str
    ) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 414: "URI Too Long",
                  431: "Request Header Fields Too Large"}.get(code, "")
        payload = body.encode()
        writer.write(
            (
                f"HTTP/1.1 {code} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n"
            ).encode()
            + payload
        )
        await writer.drain()
