"""Serving a shard store, plain and weight-only quantized, against the JAX
package end to end on the CPU.

- A llama-tiny store written by the JAX package's ``save_shards`` (int8
  and int4): the JAX ``InferenceEngine.from_store`` with
  ``serve_quantized=True`` and the port's (``device="cpu"``) give
  IDENTICAL temperature-0 streams through the continuous batcher, paged
  with the automatic prefix cache and contiguous, with equal prefix hits.
  On the CPU the JAX engine dequantizes and contracts (its dequant-matmul
  mode is "fallback" there) and the port runs the kernel's plain version,
  the same function; the decoder-block weights stay quantized in the
  port's engine.
- Plain ``--store`` serving (every leaf dequantized to the model dtype at
  load, ``reconstruct``) matches too.
- ``serve_quantized`` on an unquantized store raises ``ValueError``, as in
  the reference; a store without a model config raises too.
- ``dlt-serve-torch --store DIR --override runtime.serve_quantized=true
  --device cpu`` answers an HTTP request through ``build_server``, with
  the store's directory name as the model name.

float32 on the CPU, llama-tiny width (4 layers, d_model 64, GQA 4/2, MLP
176 — its scale blocks shrink to gcd(176, 128) = 16) with vocab 512 so the
byte tokenizer's ids fit.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

import jax

from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.core.config import RuntimeConfig as JaxRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.engine import InferenceEngine as JaxEngine
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{None | "int8" | "int4": a llama-tiny store written by the JAX
    package}, one set of weights."""
    cfg = jax_preset("llama-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(0), cfg)
    out = {}
    for quant in (None, "int8", "int4"):
        path = str(tmp_path_factory.mktemp(f"store_{quant}"))
        jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                           quantization=quant)
        out[quant] = path
    return out


def _prompts(seed):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    return [shared + pick(5), pick(7), shared + pick(9), pick(30), pick(3),
            shared + pick(20)]


def _run_both(store_dir, quantized, budgets, **kw):
    jeng = JaxEngine.from_store(
        store_dir, rt=JaxRuntimeConfig(serve_quantized=quantized))
    teng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(serve_quantized=quantized), device="cpu")
    jbat = jb.ContinuousBatcher(jeng.cfg, jeng.params, JaxByteTokenizer(),
                                overlap=False, **kw)
    tbat = tb.ContinuousBatcher(teng.cfg, teng.params, ByteTokenizer(), **kw)
    for prompt, n in zip(_prompts(1), budgets):
        assert jbat.submit(prompt, max_new_tokens=n) == tbat.submit(
            prompt, max_new_tokens=n)
    return teng, jbat, jbat.run(), tbat, tbat.run()


BUDGETS = [12, 9, 12, 6, 10, 8]
PAGED = dict(batch_slots=3, max_len=96, chunk_steps=4, paged_pages=24,
             page_size=16, prefix_cache=True)
CONTIGUOUS = dict(batch_slots=3, max_len=96, chunk_steps=4)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_paged_streams_identical_to_jax(stores, quant):
    teng, jbat, want, tbat, got = _run_both(stores[quant], True, BUDGETS,
                                            **PAGED)
    assert got == want
    assert [len(got[rid]) for rid in range(6)] == BUDGETS
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits >= 2
    assert tbat.prefix_cache.hit_tokens == jbat.prefix_cache.hit_tokens
    tbat.assert_pool_consistent()
    # The decoder-block weights stayed quantized; the rest was rehydrated.
    attn = teng.params["blocks"]["attn"]
    assert isinstance(attn["wq"], QuantizedTensor)
    assert attn["wq"].bits == (8 if quant == "int8" else 4)
    assert isinstance(teng.params["blocks"]["mlp"]["w_down"], QuantizedTensor)
    assert teng.params["embed"]["wte"].dtype == torch.float32
    assert teng.params["lm_head"]["w"].shape == (64, 512)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_contiguous_streams_identical_to_jax(stores, quant):
    _, _, want, tbat, got = _run_both(stores[quant], True, BUDGETS,
                                      **CONTIGUOUS)
    assert got == want
    assert not tbat.paged


@pytest.mark.parametrize("quant", [None, "int8"])
def test_plain_store_streams_identical_to_jax(stores, quant):
    """Without serve_quantized every leaf is dequantized at load."""
    teng, _, want, _, got = _run_both(stores[quant], False, BUDGETS, **PAGED)
    assert got == want
    assert not isinstance(teng.params["blocks"]["attn"]["wq"],
                          QuantizedTensor)


def test_serve_quantized_refuses_an_unquantized_store(stores):
    with pytest.raises(ValueError, match="not quantized"):
        InferenceEngine.from_store(
            stores[None], rt=RuntimeConfig(serve_quantized=True),
            device="cpu")


def test_store_without_model_config_raises(tmp_path):
    from distributed_llms_tpu_torch.checkpoint import store as tstore

    tstore.save_shards({"w": torch.ones(2, 2)}, str(tmp_path))
    with pytest.raises(ValueError, match="model_config"):
        InferenceEngine.from_store(str(tmp_path), device="cpu")


def test_store_on_a_mesh_is_refused(stores):
    """A store serves on a mesh now (tests/test_torch_quantized_mesh.py,
    one rank a process); in ONE process a two-device mesh is refused with
    the reference's mesh-size error, and a one-device mesh config serves
    as one device."""
    from distributed_llms_tpu_torch.core.config import MeshConfig

    with pytest.raises(ValueError, match="needs 2 devices, got 1"):
        InferenceEngine.from_store(stores["int8"], mesh_cfg=MeshConfig(model=2),
                                   device="cpu")
    eng = InferenceEngine.from_store(stores["int8"], mesh_cfg=MeshConfig(),
                                     device="cpu")
    assert eng.pm is None


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


async def test_dlt_serve_torch_store_answers_over_http(stores):
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--store", stores["int4"], "--override",
        "runtime.serve_quantized=true", "--device", "cpu", "--paged-pages",
        "40", "--page-size", "16", "--prefix-cache", "--slots", "2",
        "--host", "127.0.0.1", "--port", "0", "--max-len", "96",
    ])
    server = serve_main.build_server(args)
    assert isinstance(server.batcher.params["blocks"]["attn"]["wo"],
                      QuantizedTensor)
    await server.start()
    try:
        status, body = await _post(server.bound_port, "/v1/completions", {
            "prompt": "hello store", "max_tokens": 5, "logprobs": True})
        assert status == 200, body
        resp = json.loads(body)
        assert resp["usage"]["completion_tokens"] == 5
        assert resp["model"] == os.path.basename(stores["int4"])
    finally:
        await server.stop()
    server.batcher.assert_pool_consistent()
