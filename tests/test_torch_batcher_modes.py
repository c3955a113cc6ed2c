"""Contiguous mode (with and without a sliding window) and int8 KV pages of
the port's batcher, against the JAX package, end to end on the CPU.

- The contiguous ``ContinuousBatcher`` (no ``paged_pages``; the JAX
  package's default mode) gives temperature-0 streams IDENTICAL to the JAX
  batcher's (``overlap=False``) on the same weights and prompts: on
  llama-tiny, and on llama-tiny with ``sliding_window=8`` and prompts
  longer than the window, so every decode step reads a window band.  On
  the CPU both decode through their plain versions: the JAX batcher's
  masked dense path (its decode-attention mode is "fallback" there), the
  port's ``ragged_decode_attention`` plain version — the same function.
- The int8 paged, prefix-cached batcher (``kv_bits=8``) gives streams
  identical to the JAX int8 batcher's, with equal prefix hits, and equal
  preemptions under pool pressure.  ``kv_quantize`` is bit-exact
  (tests/test_torch_quantize.py); the pools' int8 codes agree within one
  step (see the test for why a few flip).
- The constructors' checks: a window with a page pool, int8 or the prefix
  cache without one raise ``ValueError``, as in the reference.
- Serving: ``GET /metrics`` answers 200 on a contiguous server, and the
  HTTP gateway boots on the CPU both over a contiguous windowed tiny model
  and as ``dlt-serve-torch --kv-bits 8``.
- The kernels' build key covers the shared headers.

float32 on the CPU, llama-tiny width (4 layers, d_model 64, GQA 4/2) with
vocab 512 so the byte tokenizer's ids fit.
"""

import asyncio
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import jax

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.ops import build
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(**overrides):
    cfg_j = jax_preset("llama-tiny", vocab_size=512, **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, **overrides)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def windowed():
    return _weights(sliding_window=8)


def _prompts(seed, long=False):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    if long:  # every prompt longer than an 8-slot window
        return [pick(30), pick(12), pick(9), pick(45), pick(20)]
    return [shared + pick(5), pick(7), shared + pick(9), pick(30), pick(3),
            shared + pick(20)]


def _run_both(w, budgets, prompts, **kw):
    cfg_j, cfg_t, pj, pt = w
    jbat = jb.ContinuousBatcher(cfg_j, pj, JaxByteTokenizer(),
                                **{"overlap": False, **kw})
    tbat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), **kw)
    for prompt, n in zip(prompts, budgets):
        assert jbat.submit(prompt, max_new_tokens=n) == tbat.submit(
            prompt, max_new_tokens=n)
    return jbat, jbat.run(), tbat, tbat.run()


# -- contiguous mode ------------------------------------------------------------

def test_contiguous_streams_identical_to_jax(weights):
    budgets = [12, 9, 12, 6, 10, 8]
    jbat, want, tbat, got = _run_both(
        weights, budgets, _prompts(1), batch_slots=3, max_len=96,
        chunk_steps=4)
    assert not tbat.paged and tbat.pool is None
    assert got == want
    assert [len(got[rid]) for rid in range(6)] == budgets
    assert tbat.decode_steps > 0
    tbat.assert_pool_consistent()  # a no-op without a pool


def test_contiguous_rows_reach_the_end_of_their_cache(weights):
    """prompt + budget == max_len: a row's last decode write lands on slot
    S - 1, and a finished row idles at real_lens == S - 1 while the others
    decode — no write or read past the cache."""
    prompts = [list(range(1, 41)), list(range(50, 60))]
    jbat, want, tbat, got = _run_both(
        weights, [24, 54], prompts, batch_slots=2, max_len=64,
        chunk_steps=5)
    assert got == want
    assert int(tbat.real_lens.max()) <= 63


def test_windowed_contiguous_streams_identical_to_jax(windowed):
    """Sliding window 8, prompts of 9-45 tokens: prefill masks the window,
    every decode step reads only its row's 8-slot band."""
    budgets = [14, 9, 20, 6, 11]
    jbat, want, tbat, got = _run_both(
        windowed, budgets, _prompts(2, long=True), batch_slots=3,
        max_len=96, chunk_steps=4)
    assert got == want
    assert [len(got[rid]) for rid in range(5)] == budgets


def test_window_changes_the_stream(weights, windowed):
    """The windowed runs above would pass vacuously if the window never
    bit: the same weights without it give other tokens."""
    prompts = _prompts(2, long=True)[:2]
    outs = []
    for cfg, _, pt in ((windowed[1], None, windowed[3]),
                       (weights[1], None, weights[3])):
        bat = tb.ContinuousBatcher(cfg, pt, ByteTokenizer(), batch_slots=2,
                                   max_len=96, chunk_steps=4)
        for p in prompts:
            bat.submit(p, max_new_tokens=12)
        outs.append(bat.run())
    assert outs[0] != outs[1]


def test_contiguous_valid_mirror_is_a_prefix(weights):
    cfg_j, cfg_t, pj, pt = weights
    bat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), batch_slots=2,
                               max_len=64, chunk_steps=3, overlap=False)
    bat.submit(list(range(1, 20)), max_new_tokens=30)
    bat.submit(list(range(1, 5)), max_new_tokens=4)
    bat._admit_pending()
    assert bat.valid[0].tolist() == [s < 19 for s in range(64)]
    bat._decode_span(bat.active.copy())
    assert bat.valid[0].tolist() == [s < int(bat.real_lens[0])
                                     for s in range(64)]
    assert int(bat.real_lens[0]) == 22
    bat.valid[0, 40] = True  # a stale slot past the prefix is caught
    with pytest.raises(AssertionError, match="prefix"):
        bat._decode_span(bat.active.copy())


# -- int8 KV pages ---------------------------------------------------------------

def test_int8_paged_streams_identical_to_jax(weights):
    budgets = [12, 9, 12, 6, 10, 8]
    # Both loops synchronous: the pools are compared to the byte, and a
    # chunk dispatched ahead writes an idle row's K/V where the
    # synchronous loop writes nothing (tests/test_torch_overlap.py holds
    # the dispatch-ahead loop's streams).
    jbat, want, tbat, got = _run_both(
        weights, budgets, _prompts(1), batch_slots=3, max_len=96,
        chunk_steps=4, paged_pages=24, page_size=16, prefix_cache=True,
        kv_bits=8, overlap=False)
    assert isinstance(tbat.cache, tm.QuantKVCache)
    assert tbat.cache.k.dtype == torch.int8
    assert got == want
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits >= 2
    assert tbat.prefix_cache.hit_tokens == jbat.prefix_cache.hit_tokens
    tbat.assert_pool_consistent()
    # The pools: the K/V vectors the two stacks quantize come out of four
    # layers of float32 matmuls summed in another order (they agree to
    # ~1e-4 relative, like the logits in tests/test_torch_model.py), so an
    # absmax scale moves in its fourth digit and a value near a rounding
    # boundary flips its int8 code by one step (a few hundredths of a
    # percent of the pool here; the streams agree all the same).  Held:
    # every code within one step, flips rare, the positions named when it
    # fails, scales within 1e-3 relative.
    for name in ("k", "v"):
        got_q = getattr(tbat.cache, name).numpy().astype(np.int32)
        want_q = np.asarray(getattr(jbat.cache, name)).astype(np.int32)
        flips = np.argwhere(got_q != want_q)
        assert np.abs(got_q - want_q).max() <= 1 and len(flips) <= \
            1e-3 * got_q.size, f"{name} pool flips at {flips[:10].tolist()}"
        np.testing.assert_allclose(
            getattr(tbat.cache, name + "_scale").numpy(),
            np.asarray(getattr(jbat.cache, name + "_scale")), rtol=1e-3)


def test_int8_streams_identical_under_pool_pressure(weights):
    jbat, want, tbat, got = _run_both(
        weights, [40, 30, 40, 25, 30, 28], _prompts(1), batch_slots=3,
        max_len=96, chunk_steps=4, paged_pages=13, page_size=16,
        prefix_cache=True, kv_bits=8)
    assert got == want
    assert tbat.preemptions == jbat.preemptions > 0
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits
    tbat.assert_pool_consistent()


def test_int8_pool_costs_about_half(weights):
    cfg = get_preset("llama-3-8b")
    b16 = tb.pool_page_bytes(cfg, 64, 16)
    b8 = tb.pool_page_bytes(cfg, 64, 8)
    assert b16 == 32 * 64 * 4096 and b8 == 32 * 64 * 2112
    assert b16 == jb.pool_page_bytes(jax_preset("llama-3-8b"), 64, 16)
    assert b8 == jb.pool_page_bytes(jax_preset("llama-3-8b"), 64, 8)


def test_int8_digests_are_salted(weights):
    cfg_j, cfg_t, pj, pt = weights
    ids = list(range(1, 40))
    kw = dict(batch_slots=2, max_len=64, paged_pages=12, page_size=16,
              prefix_cache=True)
    d8 = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), kv_bits=8,
                              **kw)._page_digests(ids, 2)
    d16 = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(),
                               **kw)._page_digests(ids, 2)
    assert d8 != d16
    assert d8 == jb.PrefixCache.page_digests(ids, 16, 2, kv_bits=8)


# -- the constructors' checks -----------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"paged_pages": 12, "page_size": 16}, "sliding-window"),
    ({"kv_bits": 8}, "paged pool"),
    ({"prefix_cache": True}, "paged KV pool"),
    ({"kv_bits": 4}, "kv_bits must be"),
])
def test_batcher_refuses_what_the_reference_refuses(windowed, kw, match):
    cfg_t, pt = windowed[1], windowed[3]
    if "sliding" not in match:
        cfg_t = dataclasses.replace(cfg_t, sliding_window=None)
    with pytest.raises(ValueError, match=match):
        tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), batch_slots=2,
                             max_len=64, **kw)


def test_paged_forward_with_a_window_raises(windowed):
    cfg_t, pt = windowed[1], windowed[3]
    pool = tb._paged_pool(cfg_t, 5, 8)
    with pytest.raises(ValueError, match="sliding_window"):
        tm.forward(pt, cfg_t, torch.zeros((1, 1), dtype=torch.long),
                   positions=torch.zeros((1, 1), dtype=torch.long),
                   cache=pool, cache_index=torch.zeros(1, dtype=torch.int32),
                   kv_tables=torch.ones((1, 2), dtype=torch.int32))


def test_engine_knob_policy(weights):
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    cfg_t, pt = weights[1], weights[3]
    eng = InferenceEngine(cfg_t, RuntimeConfig(kv_bits=8, prefix_cache=True),
                          pt, tokenizer=ByteTokenizer(), device="cpu")
    # Config-inherited paged knobs on a contiguous engine are dropped.
    bat = eng.continuous_batcher(batch_slots=2, max_len=64)
    assert not bat.paged and bat.kv_bits == 16 and bat.prefix_cache is None
    with pytest.raises(ValueError, match="int8 KV pages"):
        eng.continuous_batcher(batch_slots=2, max_len=64, kv_bits=8)
    bat = eng.continuous_batcher(batch_slots=2, max_len=64, paged_pages=9,
                                 page_size=16)
    assert bat.paged and bat.kv_bits == 8 and bat.prefix_cache is not None


# -- serving ---------------------------------------------------------------------

async def _request(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
        f"{len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def _cli_server(flags):
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--preset", "llama-tiny", "--device", "cpu", "--slots", "2",
        "--host", "127.0.0.1", "--port", "0", "--max-len", "96", *flags])
    return serve_main.build_server(args)


async def _ask(server, prompt, max_tokens):
    await server.start()
    try:
        port = server.bound_port
        status, body = await _request(port, "POST", "/v1/completions", {
            "prompt": prompt, "max_tokens": max_tokens})
        assert status == 200, body
        resp = json.loads(body)
        assert resp["usage"]["completion_tokens"] == max_tokens
        status, metrics = await _request(port, "GET", "/metrics")
        assert status == 200, metrics
    finally:
        await server.stop()
    return resp, metrics


async def test_metrics_answer_on_a_contiguous_server():
    server = _cli_server([])
    _, metrics = await _ask(server, "hello", 3)
    assert server.batcher.pool is None
    assert b"batcher_admitted" in metrics


async def test_http_boot_contiguous_windowed_model():
    """No preset is a windowed tiny model (the CLI, like the reference's,
    serves presets as published), so the engine is built with the window
    and the gateway boots over its default-mode batcher."""
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llms_tpu_torch.runtime.server import InferenceServer

    eng = InferenceEngine.from_preset("llama-tiny", device="cpu",
                                      vocab_size=512, sliding_window=8)
    server = InferenceServer(eng.continuous_batcher(batch_slots=2,
                                                    max_len=96),
                             host="127.0.0.1", port=0)
    await _ask(server, "a prompt longer than the window", 5)
    b = server.batcher
    assert not b.paged and b.cfg.sliding_window == 8
    assert b.capacity_tokens() == 2 * 96


async def test_http_boot_int8_pages():
    server = _cli_server(["--paged-pages", "14", "--page-size", "16",
                          "--prefix-cache", "--kv-bits", "8"])
    _, metrics = await _ask(server, "int8 pages hold this prompt", 4)
    assert isinstance(server.batcher.cache, tm.QuantKVCache)
    assert b"batcher_pool_free_pages" in metrics


# -- the kernels' build key ------------------------------------------------------

def test_build_key_covers_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    before = {s: build.library_path(s, csrc) for s in sources}
    assert before == {s: build.library_path(s) for s in sources}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {s: build.library_path(s, csrc) for s in sources}
    assert all(after[s] != before[s] for s in sources)
    assert all(after[s].name.startswith(s.removesuffix(".cu") + "-")
               for s in sources)
