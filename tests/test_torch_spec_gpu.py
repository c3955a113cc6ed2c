"""Speculative rounds on the card (marked ``gpu``: skipped without a CUDA
device; run with ``python -m pytest --noconftest -m gpu
tests/test_torch_spec_gpu.py``).  Imports no JAX.

- A round replayed from its captured graph equals the eager round to the
  bit — packed output, both caches, the generator's state — greedy and
  sampled, over a paged bf16 pool, an int8 pool and a contiguous cache
  with a sliding window, with the int4 self-draft (K5 for every draft
  projection, K2 for every draft step) and a per-row ``k_row`` clamp.
- A round's launches: K1 (or K1q) once a layer (the one-launch verify
  window), K2 k+1 times a layer (k draft steps and the backfill), K5 7 x
  (k+1) a layer; a replay adds what its capture recorded.
- The one-launch verify window (B*T virtual rows) equals the T
  single-offset launches of the reference's formulation, and the plain
  version, for K1 and K1q: every output row within 1% of the plain row's
  L2 norm, plus 2^-7 on the int8 leg (chip_smoke.py's decode rule; the two
  launches split the rows differently, so they agree to rounding, not to
  the bit).
"""

import numpy as np
import pytest
import torch

from distributed_llms_tpu_torch.ops import decode_attn
from distributed_llms_tpu_torch.runtime import chunk_graph

gpu = pytest.mark.gpu
K = 4


@pytest.fixture
def card():
    """Decided in the test, not at import: every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and the round's graph "
                    "have no CPU mode)")


def _small(window=None):
    from distributed_llms_tpu_torch.core.config import ModelConfig
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime.engine import _quantize_blocks

    cfg = ModelConfig(family="llama", vocab_size=512, hidden_size=512,
                      intermediate_size=1024, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=128, max_seq_len=256,
                      tie_embeddings=False, dtype="bfloat16",
                      sliding_window=window)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    draft = {**params, "blocks": _quantize_blocks(params["blocks"], 4)}
    return cfg, params, draft


def _caches(cfg, mode, b, s=256):
    """Target cache (pool or rows) and tables, the draft's rows: random
    contents, the same for every route (reset from saved copies)."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import batcher

    gen = torch.Generator(device="cuda").manual_seed(2)
    draft = model_lib.init_cache(cfg, b, s + K + 1, device="cuda")
    torch.nn.init.normal_(draft.k, generator=gen)
    draft.v.copy_(draft.k.flip(2))
    if mode == "contiguous":
        cache = model_lib.init_cache(cfg, b, s + K + 1, device="cuda")
        torch.nn.init.normal_(cache.k, generator=gen)
        cache.v.copy_(cache.k.flip(2))
        return cache, None, draft
    p = -(-(s + K + 1) // 64)
    cache = batcher._paged_pool(cfg, 1 + p * b, 64, device="cuda",
                                kv_bits=8 if mode == "int8" else 16)
    if mode == "paged":
        torch.nn.init.normal_(cache.k, generator=gen)
        cache.v.copy_(cache.k.flip(1))
    tables = torch.arange(1, 1 + p * b, dtype=torch.int32,
                          device="cuda").reshape(b, p)
    return cache, tables, draft


def _carry(b, seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(10, 90, b).astype(np.int32)
    return torch.from_numpy(np.stack([
        rng.integers(1, 500, b), lens, np.ones(b), np.full(b, 20)]).astype(
            np.int32)).cuda()


def _leaves(c):
    return [getattr(c, f) for f in ("k", "v", "k_scale", "v_scale")
            if hasattr(c, f)]


@gpu
@pytest.mark.parametrize("mode", ["paged", "int8", "contiguous"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_round_graph_replay_equals_eager(card, mode, temperature):
    from distributed_llms_tpu_torch.runtime import batcher

    cfg, params, draft = _small(window=32 if mode == "contiguous" else None)
    b = 4
    cache, tables, dcache = _caches(cfg, mode, b)
    leaves = _leaves(cache) + _leaves(dcache)
    saved = [t.clone() for t in leaves]
    k_row = torch.tensor([K, 2, K, 1], dtype=torch.int32, device="cuda")
    graphs = chunk_graph.ChunkGraphs()
    gen = torch.Generator(device="cuda")
    outs = {}
    for route in ("eager", "graph", "graph_again"):
        for t, s0 in zip(leaves, saved):
            t.copy_(s0)
        gen.manual_seed(5)
        kw = dict(temperature=temperature, top_p=0.9, eos_id=-1, pad_id=0,
                  tables=tables, k_row=k_row)
        if route == "eager":
            packed = batcher._spec_steps(params, cfg, draft, cfg, cache,
                                         dcache, _carry(b), gen, K, **kw)
        else:
            packed = batcher.spec_chunk(params, cfg, draft, cfg, cache,
                                        dcache, _carry(b), gen, K,
                                        graphs=graphs, **kw)
        torch.cuda.synchronize()
        outs[route] = ([packed.cpu()] + [t.float().cpu() for t in leaves]
                       + [gen.get_state()])
    for route in ("graph", "graph_again"):
        for got, want in zip(outs[route], outs["eager"]):
            assert torch.equal(got, want), route
    assert graphs.captures == 1 and graphs.replays == 2
    toks, _, m, carry = batcher.unpack_chunk(outs["eager"][0].numpy(), b,
                                             K + 1, commits=True)
    assert ((m >= 1) & (m <= k_row.cpu().numpy() + 1)).all()


@gpu
def test_round_launch_counts(card):
    from distributed_llms_tpu_torch.ops import quant_matmul
    from distributed_llms_tpu_torch.runtime import batcher

    cfg, params, draft = _small()
    b = 4
    cache, tables, dcache = _caches(cfg, "paged", b)
    graphs = chunk_graph.ChunkGraphs()
    gen = torch.Generator(device="cuda").manual_seed(0)
    counters = [(decode_attn.paged_decode_attention, "launches"),
                (decode_attn.ragged_decode_attention, "launches"),
                (quant_matmul.quant_matmul, "int4_launches")]
    n0 = [getattr(f, a) for f, a in counters]
    for _ in range(3):
        batcher.spec_chunk(params, cfg, draft, cfg, cache, dcache,
                           _carry(b), gen, K, tables=tables,
                           k_row=torch.full((b,), K, dtype=torch.int32,
                                            device="cuda"), graphs=graphs)
    got = [getattr(f, a) - n for (f, a), n in zip(counters, n0)]
    rounds = 4  # one eager warm-up and three replays
    layers = cfg.num_layers
    assert got == [rounds * layers, rounds * layers * (K + 1),
                   rounds * layers * 7 * (K + 1)]


def _row_rel(got, want):
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-6)).max().item()


@gpu
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
def test_one_launch_window_equals_per_offset_launches(card, quant):
    from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize
    from distributed_llms_tpu_torch.models.model import paged_window_rows

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, t, h, kvh, d, blk, p = 8, K + 1, 32, 8, 128, 64, 17
    nb = 1 + b * p
    pool = [torch.randn((nb, blk, kvh, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2)]
    scales = {}
    if quant:
        (kq, ks), (vq, vs) = (kv_quantize(a) for a in pool)
        pool, scales = [kq, vq], dict(k_scale=ks, v_scale=vs)
    tables = torch.randperm(nb - 1, generator=gen, device="cuda")[
        : b * p].reshape(b, p).to(torch.int32) + 1
    cache_index = torch.tensor([0, 1, 63, 64, 300, 511, 700, 1023],
                               dtype=torch.int32, device="cuda")
    q = torch.randn((b, t, h, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    _, _, lengths, rep = paged_window_rows(tables, cache_index, t, blk)
    one = decode_attn.paged_decode_attention(
        q.reshape(b * t, 1, h, d), *pool, lengths, rep, **scales)
    each = torch.cat([decode_attn.paged_decode_attention(
        q[:, j:j + 1].contiguous(), *pool, cache_index + 1 + j, tables,
        **scales) for j in range(t)], dim=1)
    plain = decode_attn.paged_reference(
        q.reshape(b * t, 1, h, d).cpu(), *(a.cpu() for a in pool),
        lengths.cpu(), rep.cpu(), *(s.cpu() for s in scales.values()))
    limit = 1e-2 + (2.0 ** -7 if quant else 0.0)
    assert _row_rel(one.reshape(b, t, h, d), each) <= limit
    assert _row_rel(one.cpu(), plain) <= limit
