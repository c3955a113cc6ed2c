"""The KV-handoff wire (``cluster/protocol.py``, ``cluster/kv_transfer.py``)
of the port against the JAX package's, on the CPU.

- Framing: the same messages frame to the same bytes in both stacks
  (plain, zlib-compressed, BATCH), each stack decodes the other's frames,
  the logical size is checked before compression, and a decompression bomb
  is refused by the bounded inflate.
- ``KV_PAGES``: for the same pages a port frame is byte-equal to the
  reference's ``encode_kv_pages`` output, checksum included, in float32 and
  in bf16 (the port's uint16 view under the label ``"bfloat16"``, the
  reference's ``ml_dtypes`` array); each side's ``verify_and_decode``
  accepts the other's frame and returns the same pages.
- Every NACK reason, each the reference's string for the same frame: a
  checksum mismatch, a digest mismatch, inconsistent geometry, a bad
  frame; and over a live connection ``send_kv_pages`` /
  ``handle_kv_connection`` with the ``xfer.*`` sites: a corrupted frame is
  NACKed and the retry lands, a dropped frame times out and retries, a
  duplicate is absorbed, a permanent NACK stops early, and a frame over
  ``MAX_FRAME`` fails as "frame too large" without a send.
"""

import asyncio
import base64
import json
import struct
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llms_tpu.cluster import kv_transfer as jkv
from distributed_llms_tpu.cluster import protocol as jproto
from distributed_llms_tpu.runtime.batcher import PrefixCache as JPrefixCache
from distributed_llms_tpu_torch.cluster import kv_transfer as tkv
from distributed_llms_tpu_torch.cluster import protocol as tproto
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime.batcher import PrefixCache
from distributed_llms_tpu_torch.runtime.faults import FaultPlane

PAGE = 4
IDS = [int(t) for t in np.random.default_rng(1).integers(1, 500, 13)]
DIGESTS = PrefixCache.page_digests(IDS, PAGE, 3)


def digests_fn(ids, page_size, n):
    return PrefixCache.page_digests(ids, page_size, n)


def _pages(dtype):
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, PAGE, 2, 8)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    if dtype == "float32":
        return (k, v), (torch.from_numpy(k), torch.from_numpy(v))
    return ((k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)),
            (torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()))


def _messages(dtype, tid="t0"):
    (jk, jv), (tk, tv) = _pages(dtype)
    jm = jkv.encode_kv_pages(jkv.KVTransferPayload(
        tid, IDS[:12], PAGE, DIGESTS, jk, jv))
    tm = tkv.encode_kv_pages(tkv.KVTransferPayload(
        tid, IDS[:12], PAGE, DIGESTS, tk, tv))
    return jm, tm, (tk, tv)


def test_page_digests_equal_reference():
    for bits in (16, 8):
        assert PrefixCache.page_digests(IDS, PAGE, 3, kv_bits=bits) == \
            JPrefixCache.page_digests(IDS, PAGE, 3, kv_bits=bits)


# -- framing ----------------------------------------------------------------

FRAMES = [
    tproto.message("KV_ACK", {"ok": True, "reason": "imported",
                              "transfer_id": "x"}),
    tproto.message("KV_ACK", {"ok": False, "reason": "n" * 5000}),
    tproto.batch([tproto.message("KV_ACK", {"ok": True}),
                  tproto.message("KV_ACK", {"ok": False}, msg_id="7")]),
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_byte_equal_reference(i):
    msg = FRAMES[i]
    frame = tproto.encode(msg)
    assert frame == jproto.encode(msg)
    assert tproto.encode(msg, compress=False) == \
        jproto.encode(msg, compress=False)
    n, flags = tproto.decode_header(frame[:8])
    assert (n, flags) == jproto.decode_header(frame[:8])
    body = frame[8:]
    if flags & 1:
        assert tproto._inflate(body) == jproto._inflate(body)
    assert tproto.unbatch(msg) == jproto.unbatch(msg)


def test_frame_limits_match_reference(monkeypatch):
    assert tproto.MAX_FRAME == jproto.MAX_FRAME == 64 * 1024 * 1024
    assert tproto.COMPRESS_MIN == jproto.COMPRESS_MIN
    # The control plane's types are the port's too since it was ported.
    assert tproto.MESSAGE_TYPES == jproto.MESSAGE_TYPES
    with pytest.raises(tproto.ProtocolError, match="unknown message type"):
        tproto.encode({"type": "EVIL", "payload": None})
    bomb = zlib.compress(b"\0" * 4096, 9)
    for mod in (tproto, jproto):
        monkeypatch.setattr(mod, "MAX_FRAME", 1024)
        with pytest.raises(mod.ProtocolError,
                           match="decompressed frame too large"):
            mod._inflate(bomb)
        # The logical (uncompressed) size is checked at the sender.
        with pytest.raises(mod.ProtocolError, match="frame too large"):
            mod.encode(mod.message("KV_ACK", {"r": "x" * 4096}))
        with pytest.raises(mod.ProtocolError, match="frame too large"):
            mod.decode_header(struct.pack(">Q", 4096))


def test_each_stack_reads_the_others_frames():
    async def main():
        got = []

        async def echo(reader, writer):
            got.append(await tproto.receive_message(reader))
            await jproto.send_message(writer, jproto.message(
                "KV_ACK", {"ok": True, "reason": "r" * 3000}))
            writer.close()

        srv = await asyncio.start_server(echo, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await jproto.send_message(writer, FRAMES[1])
        ack = await tproto.receive_message(reader, timeout=5)
        writer.close()
        srv.close()
        await srv.wait_closed()
        return got[0], ack

    sent, ack = asyncio.run(main())
    assert sent == FRAMES[1]
    assert ack["payload"]["reason"] == "r" * 3000


# -- KV_PAGES ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_pages_frame_byte_equal_reference(dtype):
    jm, tm, (tk, tv) = _messages(dtype)
    assert tm == jm
    assert tm["payload"]["dtype"] == dtype
    assert tproto.encode(tm) == jproto.encode(jm)
    # Each side accepts the other's frame and gets the same pages back.
    pay, why = tkv.verify_and_decode(jm, digests_fn)
    assert why == "ok" and pay.digests == DIGESTS
    assert pay.k_pages.dtype == tk.dtype and torch.equal(pay.k_pages, tk)
    assert torch.equal(pay.v_pages, tv)
    jpay, why = jkv.verify_and_decode(tm, digests_fn)
    assert why == "ok"
    assert str(np.asarray(jpay.k_pages).dtype) == dtype
    assert np.asarray(jpay.k_pages).tobytes() == \
        tk.view(torch.int16 if dtype == "bfloat16" else torch.float32
                ).numpy().tobytes()


def _tamper(msg, **fields):
    out = dict(msg)
    out["payload"] = {**msg["payload"], **fields}
    return out


@pytest.mark.parametrize("case", [
    "corrupt", "digests", "geometry", "page_size", "dtype", "missing",
    "size_lie", "not_a_dict",
])
def test_verify_reasons_equal_reference(case):
    jm, tm, _ = _messages("float32")
    p = tm["payload"]
    if case == "corrupt":
        msg = tkv.corrupt_payload(tm)
        assert msg == jkv.corrupt_payload(jm)
    elif case == "digests":
        # A sender-side hashing bug: intact payload, digests of other ids.
        wrong = [d.hex() for d in PrefixCache.page_digests(
            [t + 1 for t in IDS], PAGE, 3)]
        # The checksum is recomputed over the lie: only the digest-chain
        # recompute can catch it.
        kb, vb = (base64.b64decode(p[x]) for x in ("k", "v"))
        msg = _tamper(tm, digests=wrong, checksum=tkv.checksum(
            p["token_ids"], [bytes.fromhex(d) for d in wrong], kb, vb))
    elif case == "geometry":
        msg = _tamper(tm, shape=[2, 2, PAGE, 2, 8])
    elif case == "page_size":
        msg = _tamper(tm, page_size=0)
    elif case == "dtype":
        msg = _tamper(tm, dtype="no-such-dtype")
    elif case == "missing":
        msg = dict(tm, payload={k: v for k, v in p.items() if k != "k"})
    elif case == "size_lie":
        msg = _tamper(tm, dtype="float64")
    else:
        msg = dict(tm, payload="junk")
    fails0 = METRICS.get_counter("xfer.verify_failures")
    mine = tkv.verify_and_decode(msg, digests_fn)
    theirs = jkv.verify_and_decode(msg, digests_fn)
    assert mine[0] is None and theirs[0] is None
    assert mine[1] == theirs[1]
    if case in ("corrupt", "digests", "size_lie"):
        assert METRICS.get_counter("xfer.verify_failures") == fails0 + 1
    expect = {"corrupt": "checksum mismatch", "digests": "digest mismatch",
              "geometry": "bad frame: inconsistent geometry",
              "page_size": "bad frame: inconsistent geometry",
              "dtype": "bad frame: TypeError",
              "missing": "bad frame: KeyError",
              "size_lie": "checksum mismatch", "not_a_dict": "bad frame"}
    assert mine[1] == expect[case]


# -- the live wire: send_kv_pages <-> handle_kv_connection --------------------

def _live(msg, *, faults=None, import_reason=("imported",), sends=1,
          **send_kw):
    """One listener (verify + a recording import) and ``sends`` transfers
    of ``msg``; returns (send results, imports seen, receiver stats)."""
    async def main():
        imported = []
        stats = tkv.ReceiverStats()
        reasons = list(import_reason)

        async def import_fn(payload):
            imported.append(payload)
            why = reasons.pop(0) if len(reasons) > 1 else reasons[0]
            return why in ("imported", "duplicate"), why

        async def handler(reader, writer):
            await tkv.handle_kv_connection(
                reader, writer, page_digests_fn=digests_fn,
                import_fn=import_fn, faults=faults, stats=stats)

        srv = await asyncio.start_server(handler, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        res = []
        for _ in range(sends):
            res.append(await tkv.send_kv_pages(
                "127.0.0.1", port, msg, faults=faults,
                backoff_base_s=0.001, **send_kw))
        srv.close()
        await srv.wait_closed()
        return res, imported, stats

    return asyncio.run(main())


def test_send_and_import_over_the_wire():
    _, tm, (tk, _) = _messages("bfloat16")
    sent0 = METRICS.get_counter("xfer.sends")
    (res,), imported, stats = _live(tm)
    assert res.ok and res.reason == "imported" and res.attempts == 1
    assert res.bytes_sent == len(tproto.encode(tm))
    assert len(imported) == 1 and torch.equal(imported[0].k_pages, tk)
    assert stats.imported == 1
    assert METRICS.get_counter("xfer.sends") == sent0 + 1


@pytest.mark.parametrize("rule,attempts,imports", [
    ("xfer.send:corrupt@1", 2, 1),   # NACK (checksum), the retry lands
    ("xfer.recv:corrupt@1", 2, 1),
    ("xfer.verify:corrupt@1", 2, 1),  # forced digest mismatch
    ("xfer.send:drop@1", 2, 1),      # never sent: the ack times out
    ("xfer.recv:drop@1", 2, 1),      # swallowed by the receiver
])
def test_fault_drills_retry_and_land(rule, attempts, imports):
    _, tm, _ = _messages("float32")
    faults = FaultPlane.parse(rule, strict=True)
    retries0 = METRICS.get_counter("xfer.retries")
    (res,), imported, stats = _live(tm, faults=faults, attempt_s=0.3)
    assert res.ok and res.attempts == attempts, res
    assert len(imported) == imports
    assert faults.rules[0].fired == 1
    assert METRICS.get_counter("xfer.retries") == retries0 + attempts - 1
    if "corrupt" in rule:
        assert stats.rejected == 1


def test_duplicate_delivery_is_absorbed():
    _, tm, _ = _messages("float32")
    faults = FaultPlane.parse("xfer.send:dup@1", strict=True)
    dup0 = METRICS.get_counter("xfer.dup_deliveries")
    (res,), imported, stats = _live(
        tm, faults=faults, import_reason=("imported", "duplicate"))
    assert res.ok and res.reason == "imported"
    # The second copy of the frame rode the same connection: the receiver
    # imported it again and the (batcher's) import acked "duplicate".
    asyncio.run(asyncio.sleep(0.05))
    assert len(imported) in (1, 2)
    assert stats.imported == 1
    assert stats.duplicates + stats.imported == len(imported)
    assert METRICS.get_counter("xfer.dup_deliveries") - dup0 == \
        stats.duplicates


def test_no_capacity_retries_then_fails_and_permanent_nacks_stop():
    _, tm, _ = _messages("float32")
    (res,), imported, stats = _live(tm, import_reason=("no capacity",),
                                    max_retries=2)
    assert not res.ok and res.reason == "no capacity"
    assert res.attempts == 3 and len(imported) == 3
    assert "no capacity" not in tkv._PERMANENT_NACKS
    assert tkv._PERMANENT_NACKS == jkv._PERMANENT_NACKS
    # A permanent NACK stops after one attempt.
    (res,), imported, _ = _live(tm, import_reason=("pool shape mismatch",),
                                max_retries=3)
    assert not res.ok and res.attempts == 1
    assert res.reason == "pool shape mismatch" and len(imported) == 1
    # A frame whose geometry lies NACKs "bad frame: inconsistent geometry"
    # (not the permanent "bad frame"): the reference's sender retries it
    # to the budget, and so does the port's.
    (res,), imported, _ = _live(_tamper(tm, shape=[1]), max_retries=2)
    assert not res.ok and res.attempts == 3
    assert res.reason == "bad frame: inconsistent geometry"
    assert imported == []


def test_frame_too_large_is_permanent_and_unsent(monkeypatch):
    _, tm, _ = _messages("float32")
    monkeypatch.setattr(tproto, "MAX_FRAME", 1024)
    sends0 = METRICS.get_counter("xfer.sends")
    (res,), imported, _ = _live(tm)
    assert not res.ok and res.attempts == 0
    assert res.reason.startswith("frame too large")
    assert imported == [] and METRICS.get_counter("xfer.sends") == sends0
    # The reference answers the same for the same frame.
    monkeypatch.setattr(jproto, "MAX_FRAME", 1024)
    jres = asyncio.run(jkv.send_kv_pages("127.0.0.1", 9, tm))
    assert (jres.ok, jres.reason, jres.attempts) == \
        (res.ok, res.reason, res.attempts)
    assert json.dumps(tm)  # the message itself stays a plain JSON body
