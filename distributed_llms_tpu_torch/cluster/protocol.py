"""Wire framing of the port's control plane and KV-handoff plane (PyTorch
port of ``distributed_llms_tpu/cluster/protocol.py``): length-prefixed
JSON over asyncio TCP, frame for frame the reference's bytes.

- an 8-byte big-endian length prefix whose top byte holds the flags
  (``0x01``: the body is zlib-compressed);
- bodies at least ``COMPRESS_MIN`` bytes are compressed when that shrinks
  them; ``MAX_FRAME`` (64 MiB) bounds the LOGICAL body, checked before
  compression at the sender and after a bounded inflate at the receiver;
- every message carries ``type`` + ``payload`` (``msg_id`` for replies);
  ``BATCH`` wraps several messages in one frame.

The messages are the coordinator/worker plane's (``cluster/coordinator.py``,
``cluster/worker.py``: REGISTER, REGISTER_ACK, HEARTBEAT, PLACE_SHARDS,
UNLOAD_SHARDS, GENERATE, SCHEDULE_COMPUTATION, RESULT, ERROR, GET_STATUS,
GET_METRICS, SHUTDOWN), the handoff pair of ``cluster/kv_transfer.py``
(``KV_PAGES``: page payload + chained digests + checksum; ``KV_ACK``: a
verified import or a structured NACK) and ``BATCH``.  Tensors never ride
the control plane: a worker loads its shards from the store itself.

Fault sites (runtime/faults.py): ``proto.send`` / ``proto.recv``, tag =
message type, through a process-wide plane (:func:`set_fault_plane`).
"""

from __future__ import annotations

import asyncio
import json
import struct
import zlib
from typing import Any

MAX_FRAME = 64 * 1024 * 1024  # control plane only; nothing big belongs here
COMPRESS_MIN = 2048  # frames at least this large get zlib'd
_FLAG_ZLIB = 0x01  # stored in the top byte of the 8-byte length prefix
_LEN_MASK = (1 << 56) - 1

MESSAGE_TYPES = frozenset(
    {
        "REGISTER",
        "REGISTER_ACK",
        "HEARTBEAT",
        "PLACE_SHARDS",
        "UNLOAD_SHARDS",
        "GENERATE",
        "SCHEDULE_COMPUTATION",
        "RESULT",
        "ERROR",
        "GET_STATUS",
        "GET_METRICS",
        "SHUTDOWN",
        "BATCH",
        # KV-handoff plane (cluster/kv_transfer.py): a prefill-role engine
        # ships a finished row's KV pages (payload + chained page digests +
        # checksum) to a decode-role engine, which verifies and acks.  Page
        # payloads ride base64 in the JSON body, bounded by MAX_FRAME like
        # every frame (an oversized handoff fails loudly at send time).
        "KV_PAGES",
        "KV_ACK",
    }
)


class ProtocolError(Exception):
    pass


# -- deterministic fault injection (runtime/faults.py) ----------------------
#
# A process-wide FaultPlane consulted by send_message / receive_message at
# sites "proto.send" / "proto.recv", tagged with the message type — so a
# test (or an operator drill) can drop, delay, or sever exact control-plane
# frames instead of killing processes and sleeping past wall-clock
# deadlines.  Process-global on purpose: the framing functions are free
# functions with no instance to hang state on.  Tests MUST uninstall
# (set_fault_plane(None)) in teardown.

_FAULTS = None


def set_fault_plane(plane) -> None:
    """Install (or with ``None`` uninstall) the process-wide FaultPlane for
    protocol framing.  Returns nothing; idempotent."""
    global _FAULTS
    _FAULTS = plane


def get_fault_plane():
    return _FAULTS


async def _apply_frame_fault(site: str, msg: dict,
                             writer: asyncio.StreamWriter | None) -> str | None:
    """Consult the installed plane for one frame.  Returns "drop" when the
    caller must swallow the frame; applies "delay" here; "close" severs the
    stream and raises so both peers observe a real connection failure."""
    if _FAULTS is None:
        return None
    # defer_stall: this function runs ON the event loop — a stall rule
    # gets awaited-delay semantics instead of a blocking sleep (which
    # would freeze every peer sharing the loop, /healthz included).
    rule = _FAULTS.fire(site, tag=msg.get("type"), defer_stall=True)
    if rule is None:
        return None
    if rule.action == "drop":
        return "drop"
    if rule.action in ("delay", "stall"):
        await asyncio.sleep(rule.arg or 0.0)
        return "delay"
    if rule.action == "close":
        if writer is not None:
            writer.close()
        raise ConnectionResetError(
            f"fault injection: connection closed at {site} "
            f"({msg.get('type')})"
        )
    return rule.action


def _dump_body(msg: dict[str, Any]) -> bytes:
    """Validate + JSON-encode one message body (no compression)."""
    if msg.get("type") not in MESSAGE_TYPES:
        raise ProtocolError(f"unknown message type {msg.get('type')!r}")
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        # Check the *logical* size pre-compression: the receiver enforces the
        # same bound post-decompression, so an over-limit-but-compressible
        # frame must fail at send time, not as a silent connection drop.
        raise ProtocolError(f"frame too large ({len(body)} bytes)")
    return body


def _frame(body: bytes, flags: int) -> bytes:
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(body)} bytes)")
    return struct.pack(">Q", (flags << 56) | len(body)) + body


def _compress_frame(body: bytes) -> bytes:
    """zlib the body and frame whichever representation is smaller.
    CPU-bound (hundreds of ms on a multi-MB KV payload): event-loop
    senders reach this only through :func:`encode_on_loop`'s
    ``asyncio.to_thread`` hop — graftflow's GF201 pins that."""
    packed = zlib.compress(body, 6)
    if len(packed) < len(body):
        return _frame(packed, _FLAG_ZLIB)
    return _frame(body, 0)


def encode(msg: dict[str, Any], compress: bool | None = None) -> bytes:
    """Frame one message (synchronous).  ``compress=None`` auto-compresses
    bodies >= COMPRESS_MIN when it actually shrinks them.  Event-loop
    callers must use :func:`encode_on_loop` (or wrap this in
    ``asyncio.to_thread``, as cluster/kv_transfer.py does): the zlib pass
    over a large frame would stall the same loop that answers /healthz."""
    body = _dump_body(msg)
    if compress is None:
        compress = len(body) >= COMPRESS_MIN
    if compress:
        return _compress_frame(body)
    return _frame(body, 0)


async def encode_on_loop(msg: dict[str, Any]) -> bytes:
    """Event-loop-side encode: the WHOLE pass (json dump + zlib + frame)
    runs off the loop.  A message's size is unknowable before it is
    dumped, and json.dumps of a near-MAX_FRAME payload stalls the loop as
    the zlib pass does; the thread hop is noise against the transfer."""
    return await asyncio.to_thread(encode, msg)


def decode_header(header: bytes) -> tuple[int, int]:
    """-> (body length, flags)."""
    (v,) = struct.unpack(">Q", header)
    flags, n = v >> 56, v & _LEN_MASK
    if n > MAX_FRAME:
        raise ProtocolError(f"frame too large ({n} bytes)")
    return n, flags


def _inflate(body: bytes) -> bytes:
    """Bounded inflate: cap the output BEFORE allocating it, so a
    decompression bomb can't balloon past MAX_FRAME.  CPU-bound — the
    receive path runs it through ``asyncio.to_thread``."""
    try:
        d = zlib.decompressobj()
        out = d.decompress(body, MAX_FRAME + 1)
    except zlib.error as e:
        raise ProtocolError(f"bad compressed frame: {e}") from e
    if len(out) > MAX_FRAME or d.unconsumed_tail:
        raise ProtocolError("decompressed frame too large")
    return out


async def send_message(writer: asyncio.StreamWriter, msg: dict[str, Any]) -> None:
    if _FAULTS is not None:
        if await _apply_frame_fault("proto.send", msg, writer) == "drop":
            return  # frame swallowed: the wire never sees it
    writer.write(await encode_on_loop(msg))
    await writer.drain()


async def receive_message(
    reader: asyncio.StreamReader, timeout: float | None = None,
    *, writer: asyncio.StreamWriter | None = None
) -> dict[str, Any]:
    """Read one frame.  A TimeoutError may fire mid-frame (header consumed,
    body pending) which desynchronizes the stream — callers must treat the
    connection as dead after a timeout and reconnect (CoordinatorClient
    does).  ``writer`` is the stream's paired writer, used only by an
    installed FaultPlane: a ``proto.recv ... close`` rule severs it so the
    PEER observes a real connection failure too, not just a local raise."""
    async def _recv() -> dict[str, Any]:
        while True:
            header = await reader.readexactly(8)
            n, flags = decode_header(header)
            body = await reader.readexactly(n)
            if flags & _FLAG_ZLIB:
                # Inflate OFF the loop: compressed frames are >= COMPRESS_MIN
                # by construction and can inflate to MAX_FRAME — a receive
                # path must never stall the loop it shares with /healthz.
                body = await asyncio.to_thread(_inflate, body)
            try:
                msg = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ProtocolError(f"invalid frame body: {e}") from e
            if not isinstance(msg, dict) or msg.get("type") not in MESSAGE_TYPES:
                raise ProtocolError(f"invalid message: {str(msg)[:200]}")
            if _FAULTS is not None:
                # "drop" on receive: pretend this frame was lost in flight
                # and keep reading (the sender believes it was delivered).
                if await _apply_frame_fault("proto.recv", msg, writer) == "drop":
                    continue
            return msg

    if timeout is None:
        return await _recv()
    return await asyncio.wait_for(_recv(), timeout)


def message(type_: str, payload: Any = None, msg_id: str | None = None, **extra) -> dict:
    out: dict[str, Any] = {"type": type_, "payload": payload}
    if msg_id is not None:
        out["msg_id"] = msg_id
    out.update(extra)
    return out


# -- batching ---------------------------------------------------------------

def batch(msgs: list[dict]) -> dict:
    """Wrap several messages into one frame (one syscall, one compression
    context).  Receivers expand with :func:`unbatch`."""
    return message("BATCH", {"messages": list(msgs)})


def unbatch(msg: dict) -> list[dict]:
    """Expand a BATCH message; any other message passes through as [msg]."""
    if msg.get("type") != "BATCH":
        return [msg]
    inner = (msg.get("payload") or {}).get("messages")
    if not isinstance(inner, list):
        raise ProtocolError("BATCH payload must carry a 'messages' list")
    for m in inner:
        if not isinstance(m, dict) or m.get("type") not in MESSAGE_TYPES or m.get("type") == "BATCH":
            raise ProtocolError(f"invalid batched message: {str(m)[:200]}")
    return inner


async def send_messages(writer: asyncio.StreamWriter, msgs: list[dict]) -> None:
    """Send several messages in one frame (BATCH)."""
    if len(msgs) == 1:
        await send_message(writer, msgs[0])
        return
    writer.write(await encode_on_loop(batch(msgs)))
    await writer.drain()
