"""Named prefixes (``register_prefix`` / ``submit(prefix=)``) on the port's
batcher against the JAX package's, on the CPU.

- The reference's cases (tests/runtime/test_batcher.py's
  ``test_prefix_cached_requests_match_concatenated_solo``,
  ``test_long_prefix_short_suffix_bucket_does_not_overflow``,
  ``test_prefix_errors``; test_paged_batcher.py's
  ``test_paged_prefix_caching``): temperature-0 streams of requests naming
  a prefix, beside a plain request, equal the reference batcher's exactly,
  contiguous and paged, with the dispatch-ahead loop on and off; and they
  equal the port's own streams of prefix + suffix submitted whole.
- A long prefix with a suffix whose bucket overflows the row is clamped.
- Chunked admission with a prefix, and prefixed rows preempted under pool
  pressure (swap and recompute), equal the reference.
- The errors: an unknown name (KeyError), a prefix that does not fit its
  slot, a prefix + prompt + budget over the slot (ValueError).
- The HTTP ``prefix`` field serves the engine-side stream; an unknown or
  non-string name is a 400; registered prefixes survive a supervisor
  restart of the engine.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import json

import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights
from test_torch_serving import _post

TOK = ByteTokenizer()
PREFIX = [50, 51, 52, 53, 54, 55, 56]
SUFFIXES = [[7, 1, 9], [4, 4], [9, 8, 7, 6]]
MODES = {"contiguous": {}, "paged": dict(paged_pages=9, page_size=16)}
OVERLAP = pytest.mark.parametrize("overlap", [True, False],
                                  ids=["overlap", "sync"])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def batcher(mod, w, **kw):
    kw = {"batch_slots": 2, "max_len": 64, "chunk_steps": 4, **kw}
    if mod is jb:
        kw.pop("overlap", None)
        return jb.ContinuousBatcher(w[0], w[2], **kw)
    return tb.ContinuousBatcher(w[1], w[3], **kw)


def prefixed(mod, w, prefix=PREFIX, suffixes=SUFFIXES, n_new=6, **kw):
    b = batcher(mod, w, **kw)
    b.register_prefix("sys", prefix)
    rids = [b.submit(s, max_new_tokens=n_new, prefix="sys")
            for s in suffixes]
    plain = b.submit([3, 3, 3], max_new_tokens=5)  # no prefix, same batch
    res = b.run()
    if b.paged:
        b.assert_pool_consistent()
    return [res[r] for r in rids] + [res[plain]], b.preemptions


_REFERENCE: dict = {}


def against_reference(case, w, overlap, **kw):
    if case not in _REFERENCE:
        _REFERENCE[case] = prefixed(jb, w, **kw)
    got = prefixed(tb, w, overlap=overlap, **kw)
    assert got == _REFERENCE[case]
    return got


@OVERLAP
@pytest.mark.parametrize("mode", list(MODES))
def test_prefixed_streams_equal_the_reference(w, mode, overlap):
    toks, _ = against_reference(mode, w, overlap, **MODES[mode])
    whole = batcher(tb, w, overlap=overlap, **MODES[mode])
    rids = [whole.submit(PREFIX + s, max_new_tokens=6) for s in SUFFIXES]
    res = whole.run()
    assert toks[:3] == [res[r] for r in rids]


@pytest.mark.parametrize("mode", list(MODES))
def test_long_prefix_short_suffix_is_clamped(w, mode):
    """50 prefix tokens in a 64-slot row leave 14 for a 10-token suffix
    whose bucket (16) would overflow it."""
    against_reference(f"long_{mode}", w, True, prefix=list(range(100, 150)),
                      suffixes=[[7, 1, 9, 4, 2, 8, 6, 5, 3, 11]], n_new=4,
                      **MODES[mode])


@OVERLAP
@pytest.mark.parametrize("mode", list(MODES))
def test_chunked_admission_with_a_prefix(w, mode, overlap):
    against_reference(f"chunked_{mode}", w, overlap, prefill_chunk=2,
                      **MODES[mode])


@pytest.mark.parametrize("host_pages", [0, 16], ids=["recompute", "swap"])
def test_prefixed_rows_under_pool_pressure(w, host_pages):
    toks, preempted = against_reference(
        f"pressure_{host_pages}", w, True, batch_slots=3, page_size=16,
        paged_pages=7, host_pages=host_pages, n_new=40)
    assert preempted >= 1


def test_prefix_errors(w):
    for mod in (jb, tb):
        b = batcher(mod, w, batch_slots=1, max_len=32)
        with pytest.raises(KeyError, match="unknown prefix"):
            b.submit([1, 2], prefix="nope")
        with pytest.raises(ValueError, match="does not fit"):
            b.register_prefix("big", list(range(40)))
        b.register_prefix("sys", [5, 6, 7])
        with pytest.raises(ValueError, match="exceeds"):
            b.submit(list(range(20)), max_new_tokens=20, prefix="sys")


def _http_batcher(w):
    b = batcher(tb, w, tokenizer=TOK, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
                **MODES["paged"])
    b.register_prefix("sys", "You are a terse assistant. ")
    return b


async def test_http_prefix_field_and_restart(w):
    """The ``prefix`` field serves the engine-side stream of the same
    request; after the engine crashes before the request's first token,
    the supervisor's fresh batcher still knows the prefix and the
    re-admitted request gets the same stream."""
    engine = _http_batcher(w)
    rid = engine.submit("hello", max_new_tokens=8, prefix="sys")
    want = [TOK.decode([t]) for t in engine.run()[rid]]
    bat = _http_batcher(w)
    server = InferenceServer(bat, host="127.0.0.1", port=0)
    await server.start()
    try:
        port = server.bound_port
        body = {"prompt": "hello", "max_tokens": 8, "logprobs": True,
                "prefix": "sys"}
        status, got = await _post(port, "/v1/completions", body)
        assert status == 200, got
        assert json.loads(got)["choices"][0]["logprobs"]["tokens"] == want
        for bad in ("nope", 3):
            status, got = await _post(port, "/v1/completions",
                                      {**body, "prefix": bad})
            assert status == 400, got
        # Crash the engine before the next admission streams anything.
        admit = bat._admit_pending
        crashed = []

        def crash_once():
            if not crashed:
                crashed.append(1)
                raise RuntimeError("injected engine crash")
            admit()

        bat._admit_pending = crash_once
        status, got = await _post(port, "/v1/completions", body)
        assert status == 200, got
        assert json.loads(got)["choices"][0]["logprobs"]["tokens"] == want
        assert crashed and server.batcher is not bat
        assert "sys" in server.batcher.prefixes
    finally:
        await server.stop()
    server.batcher.assert_pool_consistent()
