"""Constrained output through the port's HTTP gateway and CLI, on the CPU
(the reference's ``tests/runtime/test_constrain.py`` server cases).

- A malformed schema or regex answers a structured 400
  (``invalid_request_error``) before any admission state exists (no
  mailbox, nothing queued), and the engine serves the next request.
- A schema-constrained completion parses and validates; its text equals
  the port batcher's engine-side stream and the JAX batcher's for the same
  prompt, schema and weights; streamed (SSE) it is the same text.
- ``n`` choices admit as rows sharing the prompt's pages (greedy: equal
  texts, ``cached_tokens`` >= two pages, a clean pool audit).
- ``constrained=False`` (``--no-constrained``) answers every constrained
  request 400, ``logit_bias`` and ``banned_tokens`` included;
  ``--constrain-cache`` sizes the compiled-automaton LRU.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import json

import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JTok
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import constrain as TC
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights
from test_torch_serving import _post

TOK = ByteTokenizer()
SMALL = {"type": "object",
         "properties": {"name": {"enum": ["get_weather", "get_time"]},
                        "ok": {"type": "boolean"}},
         "required": ["name", "ok"]}
RF = {"type": "json_schema", "json_schema": {"schema": SMALL}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def paged(mod, w, **kw):
    kw = {"batch_slots": 3, "max_len": 64, "chunk_steps": 4,
          "page_size": 16, "paged_pages": 9, "prefix_cache": True,
          "eos_id": TOK.eos_id, "pad_id": TOK.pad_id, **kw}
    if mod is jb:
        return jb.ContinuousBatcher(w[0], w[2], tokenizer=JTok(), **kw)
    return tb.ContinuousBatcher(w[1], w[3], tokenizer=TOK, **kw)


def engine_side(mod, w, prompt, n):
    b = paged(mod, w)
    rid = b.submit(prompt, max_new_tokens=n, response_format=RF)
    toks = b.run()[rid]
    return TOK.decode(toks[:-1] if toks[-1] == TOK.eos_id else toks)


def _sse_text(body: bytes) -> str:
    text = ""
    for line in body.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            text += json.loads(line[6:])["choices"][0]["text"]
    return text


async def test_server_constrained_end_to_end(w):
    srv = InferenceServer(paged(tb, w), host="127.0.0.1", port=0)
    await srv.start()
    try:
        port = srv.bound_port
        for bad in ({"type": "json_schema", "json_schema": {"schema": {
                        "type": "object",
                        "properties": {"a": {"type": "null"}},
                        "required": []}}},
                    {"type": "regex", "regex": "["},
                    {"type": "xml"}):
            status, body = await _post(port, "/v1/completions", {
                "prompt": "x", "max_tokens": 4, "response_format": bad})
            assert status == 400, body
            assert json.loads(body)["error"]["type"] == \
                "invalid_request_error"
            assert srv._inflight() == 0 and not srv.batcher.has_queued()
        for bad in ({"logit_bias": {"65": 500}}, {"banned_tokens": [-1]}):
            status, _ = await _post(port, "/v1/completions", {
                "prompt": "x", "max_tokens": 4, **bad})
            assert status == 400
        status, body = await _post(port, "/v1/completions", {
            "prompt": "tool:", "max_tokens": 40, "response_format": RF})
        assert status == 200, body
        text = json.loads(body)["choices"][0]["text"]
        assert TC.validates(SMALL, json.loads(text)), text
        ids = TOK.encode("tool:")
        assert text == engine_side(tb, w, ids, 40) == engine_side(jb, w, ids,
                                                                  40)
        status, body = await _post(port, "/v1/completions", {
            "prompt": "tool:", "max_tokens": 40, "response_format": RF,
            "stream": True})
        assert status == 200 and _sse_text(body) == text
        # n choices share the prompt's pages through the refcounted pool.
        status, body = await _post(port, "/v1/completions", {
            "prompt": "n" * 40, "max_tokens": 6, "n": 3})
        assert status == 200, body
        resp = json.loads(body)
        texts = [c["text"] for c in resp["choices"]]
        assert len(texts) == 3 and len(set(texts)) == 1
        assert resp["usage"]["prompt_tokens_details"]["cached_tokens"] >= 32
    finally:
        await srv.stop()
    srv.batcher.assert_pool_consistent()


async def test_server_constrained_kill_switch(w):
    srv = InferenceServer(paged(tb, w), host="127.0.0.1", port=0,
                          constrained=False)
    await srv.start()
    try:
        for extra in ({"response_format": {"type": "regex",
                                           "regex": "[0-9]+"}},
                      {"logit_bias": {"5": 1}}, {"banned_tokens": [5]}):
            status, body = await _post(srv.bound_port, "/v1/completions", {
                "prompt": "x", "max_tokens": 4, **extra})
            assert status == 400 and b"disabled" in body
        status, _ = await _post(srv.bound_port, "/v1/completions", {
            "prompt": "x", "max_tokens": 4})
        assert status == 200
    finally:
        await srv.stop()


@pytest.mark.parametrize("flags,status", [
    (["--no-constrained"], 400), (["--constrained"], 200),
    (["--constrain-cache", "3"], 200)], ids=["off", "on", "cache"])
async def test_cli_constrained_flags(flags, status):
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "12",
        "--page-size", "16", "--prefix-cache", "--slots", "2",
        "--host", "127.0.0.1", "--port", "0", "--max-len", "64", *flags,
    ])
    server = serve_main.build_server(args)
    await server.start()
    try:
        got, body = await _post(server.bound_port, "/v1/completions", {
            "prompt": "date:", "max_tokens": 12,
            "response_format": {"type": "regex",
                                "regex": r"\d{4}-\d{2}-\d{2}"}})
        assert got == status, body
        if status == 200:
            text = json.loads(body)["choices"][0]["text"]
            dfa = TC.regex_to_char_dfa(r"\d{4}-\d{2}-\d{2}")
            assert TC.char_dfa_matches(dfa, text.encode()), text
        want_cap = 3 if "--constrain-cache" in flags else 64
        assert TC.cache_stats()["capacity"] == want_cap
    finally:
        await server.stop()
        TC.configure_cache(64)
