"""Serving with ``attn_impl="flash"`` against the JAX package, end to end
on the CPU.

- The contiguous ``ContinuousBatcher`` (with and without a sliding window)
  and the paged, prefix-cached one give temperature-0 streams IDENTICAL to
  the JAX batcher's on the same weights and prompts, both models built
  with ``attn_impl="flash"``: the JAX engine runs its Pallas flash kernel
  in interpret mode, the port the kernels' plain version.
- Admissions route as in the reference: every multi-token admission
  without a prefix hit prefills through the dynamic flash kernel (K4,
  one call per layer, ``k_valid`` masking the unwritten tail of the row),
  prefix-hit admissions (an explicit continuation mask) stay on the dense
  path, and decode steps never reach it.
- ``dlt-serve-torch --store DIR --device cpu`` over a store whose
  manifest says ``attn_impl: "flash"`` answers over HTTP, its admission
  through K4's route.

float32 on the CPU, llama-tiny width (4 layers, d_model 64, GQA 4/2) with
vocab 512 so the byte tokenizer's ids fit.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.ops import flash
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(**overrides):
    cfg_j = jax_preset("llama-tiny", vocab_size=512, attn_impl="flash",
                       **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, attn_impl="flash",
                       **overrides)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def windowed():
    return _weights(sliding_window=8)


@pytest.fixture
def routes(monkeypatch):
    """The (route, k_valid given) of every flash call the port makes."""
    calls = []
    real = flash.flash_attention

    def spy(q, k, v, q_positions=None, k_positions=None, k_valid=None,
            causal=True, window=None):
        route = flash.is_static(q, k, q_positions, k_positions, k_valid,
                                causal)
        calls.append(("static" if route else "dynamic", k_valid is not None))
        return real(q, k, v, q_positions, k_positions, k_valid, causal, window)

    monkeypatch.setattr(flash, "flash_attention", spy)
    return calls


def _prompts(seed, long=False):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    if long:  # every prompt longer than an 8-slot window
        return [pick(30), pick(12), pick(9), pick(45), pick(20)]
    return [shared + pick(5), pick(7), shared + pick(9), pick(30), [65],
            shared + pick(20)]


def _run_both(w, budgets, prompts, **kw):
    cfg_j, cfg_t, pj, pt = w
    jbat = jb.ContinuousBatcher(cfg_j, pj, JaxByteTokenizer(), overlap=False,
                                **kw)
    tbat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), **kw)
    for prompt, n in zip(prompts, budgets):
        assert jbat.submit(prompt, max_new_tokens=n) == tbat.submit(
            prompt, max_new_tokens=n)
    return jbat, jbat.run(), tbat, tbat.run()


CONTIGUOUS = dict(batch_slots=3, max_len=96, chunk_steps=4)
PAGED = dict(batch_slots=3, max_len=96, chunk_steps=4, paged_pages=24,
             page_size=16, prefix_cache=True)


def test_contiguous_streams_identical_to_jax(weights, routes):
    budgets = [12, 9, 12, 6, 10, 8]
    _, want, tbat, got = _run_both(weights, budgets, _prompts(1),
                                   **CONTIGUOUS)
    assert got == want
    assert [len(got[rid]) for rid in range(6)] == budgets
    # Six admissions, the one-token prompt too (padded to its length
    # bucket, so every admission prefill is multi-token): K4 once per layer
    # each, with the row's unwritten tail masked.
    layers = weights[1].num_layers
    assert routes == [("dynamic", True)] * (6 * layers)
    assert tbat.decode_steps > 0


def test_windowed_contiguous_streams_identical_to_jax(windowed, routes):
    """Sliding window 8, prompts of 9-45 tokens: the admission prefill
    rides K4's window band, every decode step reads its row's band."""
    budgets = [14, 9, 20, 6, 11]
    _, want, _, got = _run_both(windowed, budgets, _prompts(2, long=True),
                                **CONTIGUOUS)
    assert got == want
    assert routes == [("dynamic", True)] * (5 * windowed[1].num_layers)


def test_paged_prefix_cached_streams_identical_to_jax(weights, routes):
    """A miss prefills through K4; a prefix hit continues under an explicit
    mask on the dense path, as in the reference."""
    budgets = [12, 9, 12, 6, 10, 8]
    jbat, want, tbat, got = _run_both(weights, budgets, _prompts(1), **PAGED)
    assert got == want
    hits = tbat.prefix_cache.hits
    assert hits == jbat.prefix_cache.hits >= 2
    assert tbat.prefix_cache.hit_tokens == jbat.prefix_cache.hit_tokens
    layers = weights[1].num_layers
    assert routes == [("dynamic", True)] * ((6 - hits) * layers)
    tbat.assert_pool_consistent()


async def _post(port, path, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(payload)}"
        "\r\n\r\n".encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


async def test_dlt_serve_torch_flash_store_answers_over_http(
        weights, routes, tmp_path):
    from distributed_llms_tpu_torch.checkpoint.store import (load_manifest,
                                                             save_shards)
    from distributed_llms_tpu_torch.cli import serve_main

    _, cfg_t, _, pt = weights
    save_shards(pt, str(tmp_path), num_shards=2, model_config=cfg_t)
    assert load_manifest(str(tmp_path))["model_config"]["attn_impl"] == "flash"
    args = serve_main.parser().parse_args([
        "--store", str(tmp_path), "--device", "cpu", "--slots", "2",
        "--host", "127.0.0.1", "--port", "0", "--max-len", "96",
    ])
    server = serve_main.build_server(args)
    assert server.batcher.cfg.attn_impl == "flash"
    await server.start()
    try:
        status, body = await _post(server.bound_port, "/v1/completions", {
            "prompt": "hello flash", "max_tokens": 5, "logprobs": True})
        assert status == 200, body
        assert json.loads(body)["usage"]["completion_tokens"] == 5
    finally:
        await server.stop()
    assert routes == [("dynamic", True)] * cfg_t.num_layers
