"""The host tier's pinned arena and the penalized decode chunk on the card.

Marked ``gpu`` (skipped without a CUDA device; on the card:
``python -m pytest --noconftest -m gpu tests/test_torch_host_tier_gpu.py``):

- a parcel's round trip through the pinned arena — the gather, the
  device-to-host copies, the worker's checksum, the host-to-device copies
  and the scatter into other pages — gives the pool's pages back to the
  bit, bf16 and int8 codes with their scales, swap and spill alike;
- a penalized decode chunk replayed from its captured graph equals the
  eager chunk to the bit: tokens, logprobs, carry, the histogram it
  updated and the generator, greedy and sampled; the warm-up before the
  capture leaves the histogram as it was.
"""

import numpy as np
import pytest
import torch

from distributed_llms_tpu_torch.runtime import batcher, chunk_graph
from distributed_llms_tpu_torch.runtime.kv_tier import HostTier

from test_torch_chunk_graph import _state, _tiny

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device (pinned memory, CUDA "
                              "events and graphs have no CPU mode)"),
]


def _filled_pool(cfg, kv_bits, pages=24):
    pool = batcher._paged_pool(cfg, pages, 64, device="cuda",
                               kv_bits=kv_bits)
    g = torch.Generator(device="cuda").manual_seed(3)
    for t in (pool.k, pool.v):
        if kv_bits == 8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device="cuda", dtype=torch.int8))
        else:
            torch.nn.init.normal_(t, generator=g)
    if kv_bits == 8:
        for t in (pool.k_scale, pool.v_scale):
            torch.nn.init.uniform_(t, generator=g)
    return pool


def _leaves(pool):
    return [getattr(pool, f) for f in ("k", "v", "k_scale", "v_scale")
            if hasattr(pool, f)]


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_pinned_arena_round_trip(kv_bits):
    cfg, _ = _tiny()
    pool = _filled_pool(cfg, kv_bits)
    tier = HostTier(16, batcher.page_layout(pool), pin=True)
    assert tier._arena[0].is_pinned() and tier.pinned_bytes > 0
    src = [3, 4, 5, 9, 10, 11, 12, 17, 2]
    ids = torch.tensor(src, dtype=torch.int32, device="cuda")
    spill = [20, 21]
    tier.park_spill([b"p", b"q"], batcher._export_pages_raw(
        pool, torch.tensor(spill, dtype=torch.int32, device="cuda")))
    h = tier.park_swap(batcher._export_pages_raw(pool, ids), len(src))
    want = [t.clone() for t in _leaves(pool)]
    dest = [1, 6, 7, 8, 13, 14, 15, 16, 22]
    parcel = tier.take_swap(h)
    batcher._import_pages_raw(
        pool, torch.tensor(dest, dtype=torch.int32, device="cuda"),
        *parcel.to("cuda"))
    one = tier.take_spill(b"q")
    batcher._import_pages_raw(
        pool, torch.tensor([23], dtype=torch.int32, device="cuda"),
        *one.to("cuda"))
    torch.cuda.synchronize()
    for got, w in zip(_leaves(pool), want):
        assert torch.equal(got[:, dest], w[:, src])
        assert torch.equal(got[:, 23], w[:, 21])
    tier.assert_consistent([])
    assert tier.stats()["used"] == 1  # the spilled "p" is still parked


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_penalized_chunk_replay_equals_eager(temperature):
    cfg, params = _tiny()
    b, k = 4, 6
    cache = batcher._paged_pool(cfg, 1 + 4 * b, 64, device="cuda")
    torch.nn.init.normal_(cache.k, generator=torch.Generator(
        device="cuda").manual_seed(2))
    cache.v.copy_(cache.k.flip(1))
    tables = torch.arange(1, 1 + 4 * b, dtype=torch.int32,
                          device="cuda").reshape(b, 4)
    saved = [cache.k.clone(), cache.v.clone()]
    rng = np.random.default_rng(4)
    counts0 = torch.from_numpy(
        rng.integers(0, 3, (b, cfg.vocab_size)).astype(np.int32)).cuda()
    pres = torch.tensor([0.6, 0.0, -0.5, 1.5], device="cuda")
    freq = torch.tensor([0.4, 0.0, 1.2, -0.3], device="cuda")
    counts = counts0.clone()  # the graph route's carried buffer
    graphs = chunk_graph.ChunkGraphs()
    gen = torch.Generator(device="cuda")
    outs = {}
    for route in ("eager", "graph", "graph_again"):
        cache.k.copy_(saved[0])
        cache.v.copy_(saved[1])
        gen.manual_seed(5)
        kw = dict(temperature=temperature, top_k=20, top_p=0.9, eos_id=-1,
                  pad_id=0, tables=tables, pres_row=pres, freq_row=freq)
        if route == "eager":
            own = counts0.clone()
            packed = batcher._decode_steps(params, cfg, cache, _state(torch),
                                           gen, k, counts=own, **kw)
        else:
            counts.copy_(counts0)
            own = counts
            packed = batcher.decode_chunk(params, cfg, cache, _state(torch),
                                          gen, k, counts=counts,
                                          graphs=graphs, **kw)
        torch.cuda.synchronize()
        outs[route] = (packed.cpu(), own.cpu(), gen.get_state())
    for route in ("graph", "graph_again"):
        for got, want in zip(outs[route], outs["eager"]):
            assert torch.equal(got, want), route
    # The chunk counted every step of every row (all rows live).
    assert int((outs["eager"][1] - counts0.cpu()).sum()) == b * k
    assert graphs.captures == 1 and graphs.replays == 2
