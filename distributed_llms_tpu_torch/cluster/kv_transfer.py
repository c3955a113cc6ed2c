"""KV-handoff plane: ship finished prefill KV pages to another engine
(PyTorch port of ``distributed_llms_tpu/cluster/kv_transfer.py``).

Disaggregated serving splits prefill and decode into separate engines so a
long prompt never stalls another request's decode tokens, and a replica
fleet reuses a sibling's cached prompt instead of prefilling it again.
The seam is the handoff: one engine's finished KV pages must reach another
engine's page pool byte-exactly, over a wire that drops, corrupts,
duplicates and stalls.  This module is that seam, on ``cluster/protocol.py``
framing (length-prefixed JSON over asyncio TCP), message for message the
reference's:

- **KV_PAGES** carries one transfer: the prompt's token ids, the prefix
  cache's chained page digests, the k/v page payload ``[L, P, BLK, KVH,
  HD]`` (base64), its dtype and shape, and a blake2b checksum.  A bf16
  payload goes over the wire as the raw bytes of its uint16 view under the
  dtype label ``"bfloat16"`` (the reference's ``ml_dtypes`` spelling), so a
  port frame is byte-equal to the reference's for the same pages.
- **KV_ACK** answers every frame: ``ok`` plus a structured ``reason``
  ("imported", "duplicate", "digest mismatch", "no capacity", ...).  No
  ack within the deadline means the frame or its ack was lost; the sender
  retries.

Safety contract: the receiver recomputes the checksum over the decoded
payload AND the chained digests from the carried token ids (a corrupted
payload, digest list or a sender-side hashing bug NACKs instead of
poisoning the decode cache); each attempt has a deadline, and timeouts,
connection failures and retryable NACKs back off exponentially with
jitter up to ``max_retries``; permanent failures (frame too large, a
NACK in ``_PERMANENT_NACKS``) stop early; duplicate delivery is absorbed
by the receiver's digest check.

Fault sites (runtime/faults.py): ``xfer.send`` (drop / corrupt / dup /
delay / stall on the sender), ``xfer.recv`` (drop / corrupt / delay on the
receiver), ``xfer.verify`` (``corrupt`` forces a verification failure).
All three are traversed by asyncio event loops, so ``fire`` is called with
``defer_stall=True`` and stalls are applied as awaited delays.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.observability import METRICS, get_logger
from . import protocol

log = get_logger("kv_transfer")

# Reasons a receiver may NACK with.  "permanent" reasons tell the sender a
# byte-identical retry cannot succeed either — it must stop retrying and
# let the caller degrade to colocated prefill.
_PERMANENT_NACKS = frozenset({"bad frame", "not a decode-role engine",
                              "pool shape mismatch"})


@dataclass
class KVTransferPayload:
    """One transfer's content, independent of the wire encoding."""

    transfer_id: str
    token_ids: list[int]        # the tokens the shipped pages cover
    page_size: int
    digests: list[bytes]        # chained page digests, one per shipped page
    k_pages: torch.Tensor       # [L, P, BLK, KVH, HD], host memory
    v_pages: torch.Tensor


def _wire_array(t) -> tuple[bytes, str, list[int]]:
    """(raw bytes, dtype label, shape) of a host tensor or numpy array —
    the reference's ``tobytes`` / ``str(dtype)`` / ``list(shape)``."""
    if isinstance(t, np.ndarray):
        a = np.ascontiguousarray(t)
        return a.tobytes(), str(a.dtype), list(a.shape)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # numpy has no bf16: the raw bytes of the uint16 view, under the
        # reference's (ml_dtypes') label.
        return (t.view(torch.uint16).numpy().tobytes(), "bfloat16",
                list(t.shape))
    a = t.numpy()
    return a.tobytes(), str(a.dtype), list(a.shape)


def _wire_dtype(label: str) -> tuple[torch.dtype, int]:
    """(torch dtype, itemsize) of a wire dtype label; raises TypeError on
    an unknown label (a bad frame, as ``np.dtype`` raises for the
    reference)."""
    if label == "bfloat16":
        return torch.bfloat16, 2
    nd = np.dtype(label)
    return torch.from_numpy(np.zeros(0, nd)).dtype, nd.itemsize


def _from_wire(raw: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def checksum(token_ids: list[int], digests: list[bytes],
             k_bytes: bytes, v_bytes: bytes) -> str:
    """Transport-integrity digest over everything the import trusts."""
    h = hashlib.blake2b(b"dlt-kv-transfer-v1", digest_size=16)
    h.update(np.asarray(token_ids, np.int64).tobytes())
    for d in digests:
        h.update(d)
    h.update(k_bytes)
    h.update(v_bytes)
    return h.hexdigest()


def encode_kv_pages(p: KVTransferPayload) -> dict:
    """Build the KV_PAGES message for one transfer.  An oversized payload
    raises :class:`protocol.ProtocolError` at send time (``protocol.encode``)
    — it fails loudly at the sender, never as a silent connection drop."""
    kb, dtype, shape = _wire_array(p.k_pages)
    vb, _, _ = _wire_array(p.v_pages)
    return protocol.message("KV_PAGES", {
        "transfer_id": p.transfer_id,
        "token_ids": list(map(int, p.token_ids)),
        "page_size": int(p.page_size),
        "digests": [d.hex() for d in p.digests],
        "shape": shape,
        "dtype": dtype,
        "k": base64.b64encode(kb).decode("ascii"),
        "v": base64.b64encode(vb).decode("ascii"),
        "checksum": checksum(p.token_ids, p.digests, kb, vb),
    })


def _corrupt_b64(s: str) -> str:
    """Flip one payload character to a different valid base64 symbol, so
    the frame still parses but the checksum no longer matches — the
    in-flight bit-flip a verify pass exists to catch."""
    if not s:
        return s
    i = len(s) // 2
    repl = "A" if s[i] != "A" else "B"
    return s[:i] + repl + s[i + 1:]


def corrupt_payload(msg: dict) -> dict:
    """A copy of a KV_PAGES message with its k-payload corrupted (fault
    actions ``corrupt`` at xfer.send / xfer.recv)."""
    out = dict(msg)
    out["payload"] = dict(msg["payload"])
    out["payload"]["k"] = _corrupt_b64(out["payload"]["k"])
    return out


def verify_and_decode(msg: dict, page_digests_fn) -> tuple[KVTransferPayload | None, str]:
    """Receiver-side verification: structural checks, checksum over the
    decoded payload, and a digest-chain recompute from the carried token
    ids via ``page_digests_fn(ids, page_size, n_pages) -> list[bytes]``
    (the prefix cache's own hashing — the ONE definition of page
    content addressing).  Returns ``(payload, "ok")`` or ``(None,
    reason)``; every failure reason is a stable string the ack carries."""
    p = msg.get("payload")
    if not isinstance(p, dict):
        return None, "bad frame"
    try:
        tid = str(p["transfer_id"])
        ids = [int(t) for t in p["token_ids"]]
        page_size = int(p["page_size"])
        digests = [bytes.fromhex(d) for d in p["digests"]]
        shape = tuple(int(s) for s in p["shape"])
        dtype, itemsize = _wire_dtype(str(p["dtype"]))
        kb = base64.b64decode(p["k"], validate=True)
        vb = base64.b64decode(p["v"], validate=True)
        want_sum = str(p["checksum"])
    except (KeyError, TypeError, ValueError) as e:
        return None, f"bad frame: {type(e).__name__}"
    if page_size < 1 or len(shape) != 5 or shape[2] != page_size \
            or shape[1] != len(digests):
        return None, "bad frame: inconsistent geometry"
    if checksum(ids, digests, kb, vb) != want_sum:
        METRICS.inc("xfer.verify_failures")
        return None, "checksum mismatch"
    expect = page_digests_fn(ids, page_size, len(digests))
    if expect != digests:
        # The payload arrived intact but its digests do not commit to the
        # carried tokens — a sender-side hashing bug.  Publishing these
        # pages would serve wrong KV to every later prefix match.
        METRICS.inc("xfer.verify_failures")
        return None, "digest mismatch"
    n = int(np.prod(shape))
    if len(kb) != n * itemsize or len(vb) != n * itemsize:
        METRICS.inc("xfer.verify_failures")
        return None, "checksum mismatch"  # size lies are payload corruption
    k = _from_wire(kb, dtype, shape)
    v = _from_wire(vb, dtype, shape)
    return KVTransferPayload(
        transfer_id=tid, token_ids=ids, page_size=page_size,
        digests=digests, k_pages=k, v_pages=v,
    ), "ok"


@dataclass
class SendResult:
    ok: bool
    reason: str
    attempts: int
    bytes_sent: int = 0
    elapsed_s: float = 0.0


async def _apply_deferred(rule):
    """Await a ``delay``/``stall`` rule fired with ``defer_stall=True`` on
    an event loop (a blocking sleep would freeze every transfer and the
    router with it).  Returns the rule for context actions."""
    if rule is not None and rule.action in ("delay", "stall"):
        await asyncio.sleep(rule.arg or 0.0)
    return rule


async def send_kv_pages(
    host: str, port: int, msg: dict, *,
    faults=None,
    attempt_s: float = 5.0,
    max_retries: int = 3,
    backoff_base_s: float = 0.05,
    backoff_cap_s: float = 1.0,
    rng: random.Random | None = None,
) -> SendResult:
    """Ship one KV_PAGES message and await its KV_ACK, retrying with
    jittered exponential backoff on timeout / connection failure /
    retryable NACK.  ``msg`` is the encoded frame (``encode_kv_pages``);
    the ``xfer.send`` fault site is consulted once per attempt."""
    rng = rng or random.Random()
    t0 = time.perf_counter()
    attempts = 0
    reason = "unsent"
    try:
        # Encode (and, for large frames, compress) exactly ONCE, OFF the
        # event loop: retries rewrite the same bytes, and zlib over a
        # multi-MB page payload costs hundreds of ms — run synchronously
        # it would stall the same loop that answers /healthz probes,
        # turning a busy prefill replica into a flapping-unhealthy one.
        frame = await asyncio.to_thread(protocol.encode, msg)
    except protocol.ProtocolError as e:
        # Permanent: an over-MAX_FRAME handoff can never be delivered.
        return SendResult(False, f"frame too large: {e}", 0)
    while attempts <= max_retries:
        if attempts:
            METRICS.inc("xfer.retries")
            back = min(backoff_cap_s, backoff_base_s * (2 ** (attempts - 1)))
            await asyncio.sleep(back * (0.5 + rng.random()))
        attempts += 1
        METRICS.inc("xfer.sends")
        rule = await _apply_deferred(
            faults.fire("xfer.send", tag=msg["payload"]["transfer_id"],
                        defer_stall=True)
            if faults is not None else None
        )
        send_frame, send_twice, swallow = frame, False, False
        if rule is not None:
            if rule.action == "drop":
                swallow = True          # the wire never sees the frame
            elif rule.action == "corrupt":
                send_frame = await asyncio.to_thread(
                    protocol.encode, corrupt_payload(msg)
                )
            elif rule.action == "dup":
                send_twice = True
        try:
            conn = asyncio.open_connection(host, port)
            reader, writer = await asyncio.wait_for(conn, attempt_s)
            try:
                if not swallow:
                    writer.write(send_frame)
                    if send_twice:
                        writer.write(send_frame)
                    await writer.drain()
                    METRICS.inc("xfer.bytes",
                                len(send_frame) * (2 if send_twice else 1))
                ack = await protocol.receive_message(
                    reader, timeout=attempt_s, writer=writer
                )
            finally:
                writer.close()
        except (ConnectionError, OSError, EOFError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, protocol.ProtocolError) as e:
            reason = f"{type(e).__name__}: {e}"
            log.warning("kv transfer %s attempt %d failed (%s)",
                        msg["payload"]["transfer_id"], attempts, reason)
            continue
        if ack.get("type") != "KV_ACK":
            reason = f"unexpected ack type {ack.get('type')!r}"
            continue
        body = ack.get("payload") or {}
        if body.get("ok"):
            el = time.perf_counter() - t0
            METRICS.observe("xfer.send_seconds", el)
            return SendResult(True, str(body.get("reason", "imported")),
                              attempts, len(frame), el)
        reason = str(body.get("reason", "nack"))
        if reason in _PERMANENT_NACKS:
            break  # a byte-identical retry cannot succeed
    return SendResult(False, reason, attempts, 0,
                      time.perf_counter() - t0)


@dataclass
class ReceiverStats:
    imported: int = 0
    duplicates: int = 0
    rejected: int = 0
    last_reason: str = ""


async def handle_kv_connection(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
    page_digests_fn, import_fn, faults=None, import_timeout_s: float = 60.0,
    stats: ReceiverStats | None = None,
) -> None:
    """Decode-role receiver loop for one connection: read KV_PAGES frames,
    fire ``xfer.recv`` / ``xfer.verify``, verify, hand verified payloads to
    ``import_fn(payload) -> awaitable (ok, reason)`` (the engine-thread
    import), and answer each frame with a KV_ACK.  Every structured
    failure is acked with its reason; a ``drop`` rule swallows the frame
    silently so the sender exercises its timeout path."""
    stats = stats if stats is not None else ReceiverStats()
    try:
        while True:
            try:
                msg = await protocol.receive_message(reader, writer=writer)
            except (asyncio.IncompleteReadError, ConnectionError, OSError,
                    EOFError):
                return  # peer hung up
            except protocol.ProtocolError:
                await protocol.send_message(writer, protocol.message(
                    "KV_ACK", {"ok": False, "reason": "bad frame"}
                ))
                return
            if msg.get("type") != "KV_PAGES":
                await protocol.send_message(writer, protocol.message(
                    "KV_ACK", {"ok": False, "reason": "bad frame"}
                ))
                continue
            tid = (msg.get("payload") or {}).get("transfer_id")
            rule = await _apply_deferred(
                faults.fire("xfer.recv", tag=tid, defer_stall=True)
                if faults is not None else None
            )
            if rule is not None and rule.action == "drop":
                continue  # pretend the frame was lost in flight: no ack
            if rule is not None and rule.action == "corrupt":
                msg = corrupt_payload(msg)
            # Verification decodes + checksums a multi-MB payload: run it
            # off the loop so concurrent imports never stall the decode
            # replica's own /healthz.
            payload, reason = await asyncio.to_thread(
                verify_and_decode, msg, page_digests_fn
            )
            vrule = await _apply_deferred(
                faults.fire("xfer.verify", tag=tid, defer_stall=True)
                if faults is not None else None
            )
            if payload is not None and vrule is not None \
                    and vrule.action == "corrupt":
                METRICS.inc("xfer.verify_failures")
                payload, reason = None, "digest mismatch"
            if payload is None:
                stats.rejected += 1
                stats.last_reason = reason
                await protocol.send_message(writer, protocol.message(
                    "KV_ACK", {"ok": False, "reason": reason,
                               "transfer_id": tid}
                ))
                if reason.startswith("bad frame"):
                    return
                continue
            try:
                ok, reason = await asyncio.wait_for(
                    import_fn(payload), import_timeout_s
                )
            except asyncio.TimeoutError:
                ok, reason = False, "import timed out"
            if ok and reason == "duplicate":
                stats.duplicates += 1
                METRICS.inc("xfer.dup_deliveries")
            elif ok:
                stats.imported += 1
            else:
                stats.rejected += 1
            stats.last_reason = reason
            await protocol.send_message(writer, protocol.message(
                "KV_ACK", {"ok": ok, "reason": reason, "transfer_id": tid}
            ))
    finally:
        writer.close()
