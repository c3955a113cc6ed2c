"""The port's serving slice against the JAX package, end to end.

- ``PrefixCache.page_digests``: byte-identical chains.
- Sampling masks: identical top-k / top-p survivor sets on the same logits.
- The slice as a whole: the JAX ``ContinuousBatcher`` and the port's, both
  paged (page size 16) with the automatic prefix cache, on the same
  weights (``params_from_numpy``) and the same prompt mix (two share a
  prefix), give IDENTICAL temperature-0 token streams and prefix-hit
  counts — also under pool pressure, where rows grow and preempt.
- The port's HTTP server answers completions on the CPU.
- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points without an explicit device raise when CUDA is missing;
  flags of later slices (and their config twins) raise
  ``NotImplementedError``; ``--token-budget``,
  ``--prefill-chunk`` and ``--overlap on`` serve the default's answer.

Contiguous mode and int8 pages are held against the JAX package in
tests/test_torch_batcher_modes.py.

float32 on the CPU, llama-tiny width (4 layers, d_model 64, GQA 4/2) with
vocab 512 so the byte tokenizer's ids fit.
"""

import ast
import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import sampling as js
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import sampling as ts
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jax_preset("llama-tiny", vocab_size=512)
    cfg_t = get_preset("llama-tiny", vocab_size=512)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


# -- prefix-cache digests ---------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 8])
def test_page_digests_are_byte_identical(kv_bits):
    ids = [int(x) for x in np.random.default_rng(0).integers(0, 128256, 200)]
    for page in (16, 64):
        n = len(ids) // page
        assert (tb.PrefixCache.page_digests(ids, page, n, kv_bits=kv_bits)
                == jb.PrefixCache.page_digests(ids, page, n, kv_bits=kv_bits))


# -- sampling masks -----------------------------------------------------------

def _logits(seed, b=4, v=300):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[:, :8] = x[:, :1]  # ties at the top
    return x


def _kept(a) -> np.ndarray:
    return np.isfinite(np.asarray(a))


@pytest.mark.parametrize("k", [1, 5, 40, 299])
def test_top_k_survivors_identical(k):
    x = _logits(1)
    np.testing.assert_array_equal(
        _kept(ts._mask_top_k(torch.from_numpy(x), k)),
        _kept(js._mask_top_k(jnp.asarray(x), k)))


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 0.999])
def test_top_p_survivors_identical(p):
    x = _logits(2) * 3
    np.testing.assert_array_equal(
        _kept(ts._mask_top_p(torch.from_numpy(x), p)),
        _kept(js._mask_top_p(jnp.asarray(x), p)))


def test_per_row_masks_identical():
    x = _logits(3)
    k = np.array([0, 1, 7, 50], np.int32)
    p = np.array([1.0, 0.3, 0.8, 0.95], np.float32)
    np.testing.assert_array_equal(
        _kept(ts._mask_top_k_rows(torch.from_numpy(x), torch.from_numpy(k))),
        _kept(js._mask_top_k_rows(jnp.asarray(x), jnp.asarray(k))))
    np.testing.assert_array_equal(
        _kept(ts._mask_top_p_rows(torch.from_numpy(x), torch.from_numpy(p))),
        _kept(js._mask_top_p_rows(jnp.asarray(x), jnp.asarray(p))))


def test_sampled_tokens_stay_inside_the_survivor_set():
    x = torch.from_numpy(_logits(4))
    g = torch.Generator().manual_seed(0)
    kept = _kept(ts.warp_logits(x, 0.7, 5, 0.8))
    for _ in range(20):
        tok = ts.sample(g, x, 0.7, 5, 0.8).numpy()
        assert kept[np.arange(len(tok)), tok].all()
    rows = ts.sample_rows(g, x, torch.tensor([0.0, 1.0, 0.5, 0.0]),
                          top_k_rows=torch.tensor([0, 3, 3, 0]))
    greedy = torch.argmax(x, dim=-1)
    assert rows[0] == greedy[0] and rows[3] == greedy[3]


# -- the slice as a whole -----------------------------------------------------

def _prompts(seed):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    return [shared + pick(5), pick(7), shared + pick(9), pick(30), pick(3),
            shared + pick(20)]


def _run_both(weights, budgets, **kw):
    cfg_j, cfg_t, pj, pt = weights
    jbat = jb.ContinuousBatcher(cfg_j, pj, JaxByteTokenizer(), overlap=False,
                                **kw)
    tbat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), **kw)
    for prompt, n in zip(_prompts(1), budgets):
        assert jbat.submit(prompt, max_new_tokens=n) == tbat.submit(
            prompt, max_new_tokens=n)
    return jbat, jbat.run(), tbat, tbat.run()


def test_temperature_zero_streams_identical_to_jax(weights):
    jbat, want, tbat, got = _run_both(
        weights, [12, 9, 12, 6, 10, 8], batch_slots=3, max_len=96,
        chunk_steps=4, paged_pages=24, page_size=16, prefix_cache=True,
    )
    assert got == want
    assert [len(got[rid]) for rid in range(6)] == [12, 9, 12, 6, 10, 8]
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits >= 2
    assert tbat.prefix_cache.hit_tokens == jbat.prefix_cache.hit_tokens
    assert tbat.decode_steps > 0
    tbat.assert_pool_consistent()
    jbat.assert_pool_consistent()


def test_streams_identical_under_pool_pressure(weights):
    """A pool of 12 usable pages for 3 slots of up to 6 pages each: rows
    grow on demand and preempt for recompute, in both stacks alike."""
    jbat, want, tbat, got = _run_both(
        weights, [40, 30, 40, 25, 30, 28], batch_slots=3, max_len=96,
        chunk_steps=4, paged_pages=13, page_size=16, prefix_cache=True,
    )
    assert got == want
    assert tbat.preemptions == jbat.preemptions > 0
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits
    tbat.assert_pool_consistent()


def test_streaming_deliveries_concatenate_to_results(weights):
    cfg_j, cfg_t, pj, pt = weights
    bat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), batch_slots=2,
                               max_len=64, chunk_steps=3, paged_pages=12,
                               page_size=16, prefix_cache=True)
    rids = [bat.submit(p, max_new_tokens=7, temperature=0.8, top_p=0.9)
            for p in _prompts(2)[:3]]
    seen: dict = {r: [] for r in rids}
    done: dict = {}

    def on_tokens(rid, toks, is_done, lps):
        seen[rid] += toks
        assert lps is None or len(lps) == len(toks)
        if is_done:
            done[rid] = done.get(rid, 0) + 1

    results = bat.run(on_tokens=on_tokens)
    assert seen == results and all(done[r] == 1 for r in rids)
    assert all(len(v) == 7 for v in results.values())


# -- serving over HTTP ---------------------------------------------------------

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


async def test_http_server_answers_on_cpu(weights):
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "40",
        "--page-size", "16", "--prefix-cache", "--slots", "2",
        "--host", "127.0.0.1", "--port", "0", "--max-len", "128",
    ])
    server = serve_main.build_server(args)
    await server.start()
    try:
        port = server.bound_port
        status, body = await _post(port, "/v1/completions", {
            "prompt": "hello port", "max_tokens": 6, "logprobs": True})
        assert status == 200, body
        resp = json.loads(body)
        assert resp["usage"]["completion_tokens"] == 6
        assert len(resp["choices"][0]["logprobs"]["token_logprobs"]) == 6
        status, body = await _post(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "stream": True})
        assert status == 200 and body.rstrip().endswith(b"data: [DONE]")
        status, body = await _post(port, "/v1/completions", {
            "prompt": "x", "tenant": "a", "max_tokens": 2})
        assert status == 200, body
        status, body = await _post(port, "/v1/completions", {
            "prompt": "x", "tenant": "no spaces"})
        assert status == 400 and b"'tenant' must be 1-64 chars" in body
        status, body = await _post(port, "/v1/completions", {
            "prompt": "x", "response_format": {"type": "regex"}})
        assert status == 400 and b"'regex' string" in body
    finally:
        await server.stop()
    server.batcher.assert_pool_consistent()


# -- boundaries ---------------------------------------------------------------

PORT_FILES = sorted((REPO / "distributed_llms_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "distributed_llms_tpu"), (
                f"{path.name} imports {name}")


def test_serve_main_import_pulls_in_no_jax():
    code = ("import sys; import distributed_llms_tpu_torch.cli.serve_main; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'distributed_llms_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine.from_preset("llama-tiny", vocab_size=512)
    args = serve_main.parser().parse_args(
        ["--preset", "llama-tiny", "--paged-pages", "40"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main.build_server(args)


@pytest.mark.parametrize("flags", [
    ["--replicas-min", "2"], ["--replicas-max", "3"],
    ["--prefill-replicas-max", "2"], ["--decode-replicas-max", "2"],
    ["--autoscale-interval", "2"], ["--autoscale-up-load", "0.5"],
    ["--autoscale-down-load", "0.1"], ["--autoscale-hysteresis", "2"],
    ["--autoscale-cooldown", "5"],
])
def test_later_slice_flags_raise(flags):
    """The autoscaler's nine flags are wired (they were refused before the
    elastic fleet was ported).  Each one alone is refused as the
    reference refuses it: a floor or a knob without a ceiling, a tier
    ceiling without tiers; a ceiling alone asks for a fleet, which
    ``build_server`` does not build."""
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args(
        ["--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "40"]
        + flags)
    match = {"--replicas-max": "build it with build_fleet",
             "--prefill-replicas-max": "needs --disaggregate",
             "--decode-replicas-max": "needs --disaggregate"}.get(
        flags[0], rf"{flags[0]} need --replicas-max")
    with pytest.raises(SystemExit, match=match):
        serve_main.build_server(args)
    # With a ceiling (and tiers, for a tier ceiling) the flag is taken.
    extra = (["--disaggregate", "--prefix-cache"]
             if flags[0].endswith(("fill-replicas-max", "code-replicas-max"))
             else [] if flags[0] == "--replicas-max"
             else ["--replicas-max", "3"])
    args = serve_main.parser().parse_args(
        ["--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "40"]
        + flags + extra)
    serve_main.check_fleet_flags(args)
    dest = flags[0][2:].replace("-", "_")
    assert getattr(args, dest) == type(getattr(args, dest))(flags[1])


async def _greedy_answer(flags):
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "40",
        "--page-size", "16", "--prefix-cache", "--slots", "2",
        "--host", "127.0.0.1", "--port", "0", "--max-len", "128", *flags,
    ])
    server = serve_main.build_server(args)
    await server.start()
    try:
        # 97 prompt tokens: past the chunk (32) and the budget (64).
        status, body = await _post(server.bound_port, "/v1/completions", {
            "prompt": "served flags, " * 6 + "then a tail", "max_tokens": 8,
            "temperature": 0.0, "logprobs": True})
    finally:
        await server.stop()
    assert status == 200, body
    server.batcher.assert_pool_consistent()
    return server.batcher, json.loads(body)["choices"][0]["logprobs"]


@pytest.mark.parametrize("flags", [
    ["--token-budget", "64"], ["--prefill-chunk", "32"], ["--overlap", "on"],
])
async def test_slice_flags_serve_as_the_default(flags):
    """--token-budget, --prefill-chunk and --overlap on are served now: the
    CPU server built with each answers a greedy completion (a prompt that
    chunks under the first two) with the default server's tokens, and
    logprobs within float drift (a chunked prefill reduces the same
    attention in other shapes)."""
    bat, got = await _greedy_answer(flags)
    _, want = await _greedy_answer([])
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                               atol=1e-3)
    if flags[0] == "--overlap":
        assert bat.overlap
    else:
        assert bat.sched.chunk_threshold() == int(flags[1])


async def test_spec_decode_flag_serves_as_the_default():
    """--spec-decode (refused before speculative decoding was ported) boots
    the server through the normal entry point with the int4 self-draft;
    a greedy completion is answered with the default server's tokens, and
    logprobs within float drift (the verify pass reduces in other
    shapes)."""
    bat, got = await _greedy_answer(["--spec-decode"])
    assert bat.speculative and bat.spec_k == 4
    assert bat.draft_params["blocks"]["attn"]["wq"].bits == 4
    _, want = await _greedy_answer([])
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                               atol=1e-3)


async def test_host_pages_flag_boots_the_tier():
    """--host-pages N (refused before the host tier was ported) boots the
    server through the normal entry point with an N-page tier behind the
    pool, and a request is answered with the default server's tokens."""
    bat, got = await _greedy_answer(["--host-pages", "64"])
    assert bat.host_tier is not None and bat.host_tier.pages == 64
    assert bat.host_tier.stats()["used"] == 0
    _, want = await _greedy_answer([])
    assert got["tokens"] == want["tokens"]


def test_later_slice_batcher_options_raise(weights):
    """The host tier is ported: its options raise the reference's
    ValueErrors — a negative size, and a tier without the paged pool."""
    cfg_j, cfg_t, pj, pt = weights
    base = dict(batch_slots=2, max_len=64, paged_pages=12, page_size=16)
    with pytest.raises(ValueError, match="host_pages"):
        tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(),
                             **{**base, "host_pages": -1})
    with pytest.raises(ValueError, match="paged"):
        tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), batch_slots=2,
                             max_len=64, host_pages=8)
