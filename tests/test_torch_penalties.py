"""Presence/frequency penalties on the port's batcher against the JAX
package's, on the CPU.

- Penalized temperature-0 streams (four requests, four penalty pairs, one
  pair zero) equal the reference batcher's exactly, paged with the prefix
  cache and contiguous, under the synchronous loop, the dispatch-ahead loop
  and the mixed schedule with chunked prefill (and the alternate one).
- The histogram is rebuilt from every token a request emitted when it
  comes back: after a recompute preemption (at its admission) and after a
  swap preemption (at its restore); the rows' device counts equal the
  emitted tokens' counts, and the streams equal the reference's.
- Penalties take effect: a penalized stream differs from the plain one.
- ``submit`` refuses a penalty outside [-2, 2] (and NaN) as the reference
  does; the HTTP gateway accepts the two OpenAI fields and serves the
  engine-side stream, and answers 400 to a bad value.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import json
import math

import numpy as np
import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights
from test_torch_serving import _post

TOK = ByteTokenizer()
RNG = np.random.default_rng(1)
PROMPTS = [[int(t) for t in RNG.integers(1, 256, n)] for n in (5, 9, 30, 12)]
PENALTIES = [(0.6, 0.4), (0.0, 0.0), (-0.5, 1.2), (1.5, 0.0)]
LOOPS = {
    "sync": dict(overlap=False),
    "overlap": dict(overlap=True),
    "mixed": dict(overlap=True, prefill_chunk=8),
    "alternate": dict(overlap=True, prefill_chunk=8, schedule="alternate"),
}
MODES = {"paged": dict(paged_pages=9, page_size=16, prefix_cache=True),
         "contiguous": {}}


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
    kw = {"batch_slots": 3, "max_len": 64, "chunk_steps": 4, **kw}
    if mod is jb:
        kw.pop("overlap", None)
        return jb.ContinuousBatcher(w[0], w[2], **kw)
    return tb.ContinuousBatcher(w[1], w[3], **kw)


def penalized(mod, w, **kw):
    b = batcher(mod, w, **kw)
    rids = [b.submit(p, max_new_tokens=30, presence_penalty=pp,
                     frequency_penalty=fp)
            for p, (pp, fp) in zip(PROMPTS, PENALTIES)]
    res = b.run()
    if b.paged:
        b.assert_pool_consistent()
    return [res[r] for r in rids], b.preemptions


_REFERENCE: dict = {}


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("mode", list(MODES))
def test_penalized_streams_equal_the_reference(w, mode, loop):
    kw = {**MODES[mode], **LOOPS[loop]}
    key = (mode, "prefill_chunk" in kw, kw.get("schedule"))
    if key not in _REFERENCE:
        _REFERENCE[key] = penalized(jb, w, **kw)
    assert penalized(tb, w, **kw) == _REFERENCE[key]


def test_penalties_take_effect(w):
    b = batcher(tb, w)
    plain = b.submit(PROMPTS[0], max_new_tokens=30)
    pen = b.submit(PROMPTS[0], max_new_tokens=30, presence_penalty=1.0,
                   frequency_penalty=1.0)
    res = b.run()
    assert res[plain] != res[pen]


STORM = [([7, 1, 9, 2], 44), ([4, 4, 4, 4], 44), ([9, 8, 7, 3], 44)]
STORM_PEN = [(0.6, 0.4), (-0.3, 0.9), (1.1, -0.2)]


def storm(mod, w, **kw):
    b = batcher(mod, w, page_size=16, paged_pages=9, **kw)
    rids = [b.submit(ids, max_new_tokens=n, presence_penalty=pp,
                     frequency_penalty=fp)
            for (ids, n), (pp, fp) in zip(STORM, STORM_PEN)]
    res = b.run()
    b.assert_pool_consistent()
    return [res[r] for r in rids], b.preemptions


def _counts_of(tokens, v):
    return np.bincount(np.asarray(tokens, np.int64), minlength=v)


@pytest.mark.parametrize("host_pages", [0, 16], ids=["recompute", "swap"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_histogram_rebuilt_after_preemption(w, host_pages, overlap,
                                            monkeypatch):
    """Every request is penalized and one is preempted: its resume
    (recompute or swap restore) rebuilds its histogram row from all the
    tokens it emitted, and the streams equal the reference's."""
    checked = []
    restore, activate = (tb.ContinuousBatcher._try_restore_swapped,
                         tb.ContinuousBatcher._activate_row)

    def restore_checked(self, i, req):
        got = restore(self, i, req)
        if got:
            checked.append("swap")
            assert np.array_equal(
                self.tok_counts[i].numpy(),
                _counts_of(self.rows[i].emitted, self.cfg.vocab_size))
        return got

    def activate_checked(self, i, req, tok, *a, **kw):
        activate(self, i, req, tok, *a, **kw)
        if req.resume_emitted:
            checked.append("recompute")
            assert np.array_equal(
                self.tok_counts[i].numpy(),
                _counts_of(self.rows[i].emitted, self.cfg.vocab_size))

    monkeypatch.setattr(tb.ContinuousBatcher, "_try_restore_swapped",
                        restore_checked)
    monkeypatch.setattr(tb.ContinuousBatcher, "_activate_row",
                        activate_checked)
    key = ("storm", host_pages)
    if key not in _REFERENCE:
        _REFERENCE[key] = storm(jb, w, host_pages=host_pages)
    swaps0 = METRICS.get_counter("batcher.kv_swaps.in")
    got = storm(tb, w, host_pages=host_pages, overlap=overlap)
    assert got == _REFERENCE[key] and got[1] >= 1
    assert checked and set(checked) == {"swap" if host_pages else "recompute"}
    assert (METRICS.get_counter("batcher.kv_swaps.in") > swaps0) == bool(
        host_pages)


@pytest.mark.parametrize("bad", [2.5, -2.01, math.nan, math.inf])
def test_submit_refuses_out_of_range_penalties(w, bad):
    for mod in (jb, tb):
        b = batcher(mod, w)
        for name in ("presence_penalty", "frequency_penalty"):
            with pytest.raises(ValueError, match=name):
                b.submit([1, 2, 3], max_new_tokens=4, **{name: bad})
        b.submit([1, 2, 3], max_new_tokens=4, presence_penalty=-2.0,
                 frequency_penalty=2.0)


async def test_http_penalty_fields(w):
    prompt = "penalties over http"
    want_b = batcher(tb, w, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
                     tokenizer=TOK, **MODES["paged"])
    rid = want_b.submit(prompt, max_new_tokens=12, presence_penalty=0.6,
                        frequency_penalty=0.4)
    want = [TOK.decode([t]) for t in want_b.run()[rid]]
    server = InferenceServer(
        batcher(tb, w, eos_id=TOK.eos_id, pad_id=TOK.pad_id, tokenizer=TOK,
                **MODES["paged"]), host="127.0.0.1", port=0)
    await server.start()
    try:
        port = server.bound_port
        status, body = await _post(port, "/v1/completions", {
            "prompt": prompt, "max_tokens": 12, "logprobs": True,
            "presence_penalty": 0.6, "frequency_penalty": 0.4})
        assert status == 200, body
        assert json.loads(body)["choices"][0]["logprobs"]["tokens"] == want
        for bad in ({"presence_penalty": 3}, {"frequency_penalty": "x"},
                    {"presence_penalty": True}):
            status, body = await _post(port, "/v1/completions", {
                "prompt": prompt, "max_tokens": 4, **bad})
            assert status == 400, body
    finally:
        await server.stop()
    server.batcher.assert_pool_consistent()
