"""Clients of the port's two planes (PyTorch port of
``distributed_llms_tpu/cluster/client.py``).

- :class:`CoordinatorClient`: asks the coordinator
  (``cluster/coordinator.py``) for status or metrics over the JSON control
  protocol (``cluster/protocol.py``).
- :class:`ServingClient`: an overload-aware HTTP client of the serving
  gateway (``runtime/server.py``) or the fleet's router.  429/503 answers
  carry ``Retry-After``; the client honours it with jittered exponential
  backoff on top, and rotates through several endpoints on failure.
"""

from __future__ import annotations

import asyncio
import json
import random
import uuid
from typing import Any

from . import protocol


class CoordinatorClient:
    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None

    async def __aenter__(self) -> "CoordinatorClient":
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        return self

    async def __aexit__(self, *exc) -> None:
        if self._writer:
            self._writer.close()

    async def request(self, type_: str, payload: Any = None, timeout: float = 30.0) -> Any:
        assert self._reader and self._writer, "use 'async with'"
        msg_id = uuid.uuid4().hex
        await protocol.send_message(
            self._writer, protocol.message(type_, payload, msg_id=msg_id)
        )
        try:
            while True:
                msg = await protocol.receive_message(
                    self._reader, timeout=timeout, writer=self._writer
                )
                if msg.get("msg_id") == msg_id:
                    if msg["type"] == "ERROR":
                        raise RuntimeError(str(msg.get("payload")))
                    return msg.get("payload")
        except TimeoutError:
            # a timeout can strand a half-read frame; this stream is dead
            self._writer.close()
            self._reader = self._writer = None
            raise

    async def status(self) -> dict:
        return await self.request("GET_STATUS")

    async def metrics(self) -> dict:
        return await self.request("GET_METRICS")


class ServingClient:
    """Async HTTP client for the serving gateway with overload-aware
    retries.

    A 429 (queue full / cost gate) or 503 (draining / shed) answer is
    retried up to ``max_retries`` times: the wait honors the server's
    ``Retry-After`` header (clamped to ``retry_after_cap_s`` when set — CI
    and benches cannot sleep 30 s per hint) PLUS a jittered exponential
    term ``U(0,1) * min(backoff_cap_s, backoff_base_s * 2^attempt)``, so a
    thundering herd that was shed together does not come back together.
    Connection errors retry on the same schedule (the server may be
    mid-restart) — NOTE that a connection dying mid-response therefore
    re-submits a request the server may have fully served (at-least-once
    semantics; fine for the benches/tests this client drives, not for
    billing-sensitive traffic).  ``retries_taken`` counts backoff waits
    for tests/bench.

    Multi-endpoint mode: construct with ``endpoints=[(host, port), ...]``
    (every replica of a fleet, or several routers) and every failure
    ROTATES to the next endpoint before retrying — a dead endpoint fails
    over immediately to a not-yet-tried one, while 429/503 answers still
    honor ``Retry-After`` before the rotated retry.  ``failovers`` counts
    rotations.
    """

    def __init__(self, host: str | None = None, port: int | None = None,
                 max_retries: int = 4,
                 backoff_base_s: float = 0.25, backoff_cap_s: float = 8.0,
                 retry_after_cap_s: float | None = None,
                 rng: random.Random | None = None,
                 endpoints: "list[tuple[str, int]] | None" = None,
                 tenant: str | None = None) -> None:
        # Client-side failover: pass ``endpoints`` (a list of (host, port)
        # pairs — e.g. every replica of a fleet, or several routers) and a
        # connect error or 429/503 ROTATES to the next endpoint for the
        # retry.  A fresh endpoint after a connection failure is tried
        # immediately (the backoff sleep protects overloaded servers, not
        # dead sockets); once every endpoint failed in the current
        # rotation, the usual Retry-After-honoring jittered backoff
        # applies.  ``host``/``port`` remain the single-endpoint spelling.
        if endpoints:
            self.endpoints = [(h, int(p)) for h, p in endpoints]
        elif host is not None and port is not None:
            self.endpoints = [(host, int(port))]
        else:
            raise ValueError("pass host+port or a non-empty endpoints list")
        self.host, self.port = self.endpoints[0]
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.retry_after_cap_s = retry_after_cap_s
        self.retries_taken = 0
        self.failovers = 0  # endpoint rotations taken (tests/bench)
        # Multi-tenant QoS: every request this client sends carries the
        # tenant id as the X-Tenant header; a per-tenant 429
        # (reason "tenant_quota") is retried on the SERVER's per-tenant
        # Retry-After through the existing backoff, and the last shed's
        # machine-readable reason is surfaced for callers/bench.
        # The id is interpolated into the raw request preamble, so it
        # must pass the gateway's canonical rule (one definition — a
        # crafted value could otherwise inject headers and desync the
        # HTTP framing).
        from ..runtime.server import valid_tenant_id

        if tenant is not None and not valid_tenant_id(tenant):
            raise ValueError(
                f"tenant must be 1-64 chars of [A-Za-z0-9._-] "
                f"('-' is reserved), got {tenant!r}"
            )
        self.tenant = tenant
        self.last_shed_reason: str | None = None
        self.tenant_sheds = 0  # 429s with reason tenant_quota observed
        self._ep = 0
        self._rng = rng if rng is not None else random.Random()

    def _rotate(self) -> None:
        self._ep = (self._ep + 1) % len(self.endpoints)
        self.host, self.port = self.endpoints[self._ep]
        self.failovers += 1

    async def _once(self, path: str, body: dict) -> tuple[int, dict, dict]:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            payload = json.dumps(body).encode()
            tenant_line = (f"X-Tenant: {self.tenant}\r\n"
                           if self.tenant else "")
            writer.write(
                f"POST {path} HTTP/1.1\r\nHost: {self.host}\r\n"
                f"{tenant_line}"
                f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
            )
            await writer.drain()
            status = int((await reader.readline()).split()[1])
            headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            raw = await reader.read()
            out = json.loads(raw) if raw.strip() else {}
            return status, headers, out
        finally:
            writer.close()

    def _delay_s(self, attempt: int, headers: dict[str, str]) -> float:
        try:
            hinted = float(headers.get("retry-after", 0) or 0)
        except ValueError:
            hinted = 0.0
        if self.retry_after_cap_s is not None:
            hinted = min(hinted, self.retry_after_cap_s)
        jittered = self._rng.random() * min(
            self.backoff_cap_s, self.backoff_base_s * (2 ** attempt)
        )
        return hinted + jittered

    async def completions(
        self, body: dict, path: str = "/v1/completions",
    ) -> tuple[int, dict]:
        """POST a completion request; returns (status, response body).
        Retries 429/503 (and connection failures) with Retry-After-honoring
        jittered exponential backoff, rotating through ``endpoints`` on
        each failure; any other status returns as-is.  A dead endpoint
        fails over to a not-yet-tried one IMMEDIATELY (no sleep) — the
        backoff protects busy servers, not severed sockets."""
        attempt = 0
        fresh = len(self.endpoints) - 1  # endpoints untried this rotation
        while True:
            headers: dict[str, str] = {}
            try:
                status, headers, out = await self._once(path, body)
            except (ConnectionError, OSError, IndexError, ValueError):
                status, out = None, {}
            if status in (429, 503) and isinstance(out, dict):
                # Surface the shed's machine-readable reason (the server
                # stamps it next to the overloaded_error): callers can
                # tell "MY tenant quota is exhausted" (honor Retry-After
                # instead of hot-retrying; quota ledgers are PER REPLICA,
                # so a rotation may find headroom elsewhere — see the
                # README's quota note) from generic fleet overload.
                reason = (out.get("error") or {}).get("reason")
                if reason is not None:
                    self.last_shed_reason = reason
                    if reason == "tenant_quota":
                        self.tenant_sheds += 1
            if status is not None and status not in (429, 503):
                return status, out
            if attempt >= self.max_retries:
                return (status if status is not None else 599), out
            attempt += 1
            if len(self.endpoints) > 1:
                self._rotate()
            if status is None and fresh > 0:
                # Connect failure with an untried endpoint left: fail over
                # now instead of sleeping at a dead host.
                fresh -= 1
                continue
            fresh = len(self.endpoints) - 1
            await asyncio.sleep(self._delay_s(attempt - 1, headers))
            self.retries_taken += 1
