"""The decode chunk's CUDA graphs (``runtime/chunk_graph.py``).

On the CPU (CUDA's graph API replaced by a recording stand-in), the
bookkeeping of :class:`ChunkGraphs`: one capture per key, after one eager
warm-up whose generator draws are taken back; the capture's own launch
counts are taken back and every replay adds them; inputs are copied into
the static buffers before each replay; each call returns a fresh copy of
the output; the graphs share one pool; the generator is registered.

Marked ``gpu`` (skipped without a CUDA device; run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_chunk_graph.py``):
a tiny llama's decode chunk replayed from its graph against the eager
chunk, paged bf16, int8 pages and contiguous with a window, greedy and
sampled (the same bits, the same generator state after), the launch
counters through replays, and a capture that finds a host sync raising.
Imports no JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from distributed_llms_tpu_torch.ops import decode_attn
from distributed_llms_tpu_torch.runtime import chunk_graph


class _FakeGraph:
    """Records what ChunkGraphs asks of a CUDA graph; ``replay`` re-runs
    the function the chunk registered while capturing."""

    capturing = None
    pools = []

    def __init__(self):
        self.generators = []
        self.rerun = None
        self.replays = 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        self.rerun()


@contextlib.contextmanager
def _fake_capture(graph, pool=None, capture_error_mode="global"):
    assert capture_error_mode == "thread_local"
    _FakeGraph.pools.append(pool)
    _FakeGraph.capturing = graph
    try:
        yield
    finally:
        _FakeGraph.capturing = None


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _FakeGraph.pools = []
    yield


def test_chunk_graphs_bookkeeping(fake_cuda, monkeypatch):
    monkeypatch.setattr(decode_attn.paged_decode_attention, "launches", 0)
    gen = torch.Generator().manual_seed(3)
    calls = []

    def chunk(ins):
        """Stands in for a decode chunk: one counted launch, one draw."""
        decode_attn.paged_decode_attention.launches += 1
        noise = torch.rand((), generator=gen)
        calls.append("capture" if _FakeGraph.capturing else "eager")
        out = ins["carry"] * 2 + (noise > 2).int()
        g = _FakeGraph.capturing
        if g is not None:
            def rerun(out=out, ins=ins):
                out.copy_(ins["carry"] * 2)
            g.rerun = rerun
        return out

    graphs = chunk_graph.ChunkGraphs()
    state0 = gen.get_state()
    first = graphs.run("k", chunk, {"carry": torch.tensor([1, 2])}, gen)
    # Warm-up (eager), capture, replay: the warm-up's draw taken back.
    assert calls == ["eager", "capture"]
    assert torch.equal(first, torch.tensor([2, 4]))
    # The warm-up launched for real (1); the capture's launch was taken
    # back and the replay added it again (1).
    assert decode_attn.paged_decode_attention.launches == 2
    second = graphs.run("k", chunk, {"carry": torch.tensor([5, 6])}, gen)
    assert calls == ["eager", "capture"]  # no second capture
    assert torch.equal(second, torch.tensor([10, 12]))
    assert torch.equal(first, torch.tensor([2, 4]))  # a copy, not the buffer
    assert decode_attn.paged_decode_attention.launches == 3
    graphs.run("other", chunk, {"carry": torch.tensor([0, 0])}, gen)
    assert graphs.captures == 2 and graphs.replays == 3
    assert _FakeGraph.pools == ["pool", "pool"]  # one pool for both
    g = graphs._graphs["k"].graph
    assert g.generators == [gen] and g.replays == 2
    # The capture itself consumed the draw the graph replays (on a card
    # a replay advances the generator by it); the warm-up's was refunded.
    expect = torch.Generator().manual_seed(3)
    expect.set_state(state0)
    torch.rand((), generator=expect)
    torch.rand((), generator=expect)
    assert torch.equal(gen.get_state(), expect.get_state())


def test_launch_counters_cover_every_kernel():
    from distributed_llms_tpu_torch.ops import flash, quant_matmul

    names = {(fn.__name__, attr) for fn, attr in chunk_graph.LAUNCH_COUNTERS}
    assert names == {
        ("paged_decode_attention", "launches"),
        ("paged_decode_attention", "int8_launches"),
        ("ragged_decode_attention", "launches"),
        ("ragged_decode_attention", "int8_launches"),
        ("quant_matmul", "launches"), ("quant_matmul", "int4_launches"),
        ("flash_attention", "static_launches"),
        ("flash_attention", "dynamic_launches"),
        ("tile_summary", "launches"),
    }
    before = chunk_graph.read_launches()
    chunk_graph.add_launches([1] * len(before))
    assert chunk_graph.read_launches() == [n + 1 for n in before]
    chunk_graph.add_launches([-1] * len(before))
    assert flash.tile_summary.launches == before[-1]
    assert quant_matmul.quant_matmul.launches == before[4]


# -- on the card ---------------------------------------------------------------

gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device (the decode "
                                       "chunk's graph has no CPU mode)")


def _tiny(window=None):
    from distributed_llms_tpu_torch.core.config import ModelConfig
    from distributed_llms_tpu_torch.models import model as model_lib

    cfg = ModelConfig(family="llama", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=64, max_seq_len=256,
                      tie_embeddings=False, dtype="bfloat16",
                      sliding_window=window)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    return cfg, params


def _state(torch_mod, b=4, s=256, seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(10, 90, b).astype(np.int32)
    carry = np.stack([rng.integers(1, 500, b), lens, np.ones(b),
                      np.full(b, 20)]).astype(np.int32)
    return torch.from_numpy(carry).cuda()


@gpu
@needs_cuda
@pytest.mark.parametrize("mode", ["paged", "int8", "contiguous"])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_graph_replay_equals_eager(mode, temperature):
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import batcher

    cfg, params = _tiny(window=32 if mode == "contiguous" else None)
    b, k = 4, 6

    def fresh_cache():
        if mode == "contiguous":
            c = model_lib.init_cache(cfg, b, 256, device="cuda")
            torch.nn.init.normal_(c.k, generator=torch.Generator(
                device="cuda").manual_seed(2))
            c.v.copy_(c.k.flip(2))
            return c, None
        c = batcher._paged_pool(cfg, 1 + 4 * b, 64, device="cuda",
                                kv_bits=8 if mode == "int8" else 16)
        if mode == "paged":
            torch.nn.init.normal_(c.k, generator=torch.Generator(
                device="cuda").manual_seed(2))
            c.v.copy_(c.k.flip(1))
        tables = torch.arange(1, 1 + 4 * b, dtype=torch.int32,
                              device="cuda").reshape(b, 4)
        return c, tables

    # One cache for every route (a graph is tied to the buffers it was
    # captured on), reset to the same contents before each.
    cache, tables = fresh_cache()
    leaves = [getattr(cache, f) for f in ("k", "v", "k_scale", "v_scale")
              if hasattr(cache, f)]
    saved = [t.clone() for t in leaves]
    graphs = chunk_graph.ChunkGraphs()
    # One generator too: a graph draws from the generator it was captured
    # with (a batcher owns one for its life).
    gen = torch.Generator(device="cuda")
    outs = {}
    for route in ("eager", "graph", "graph_again"):
        for t, s0 in zip(leaves, saved):
            t.copy_(s0)
        gen.manual_seed(5)
        kw = dict(temperature=temperature, top_k=20, top_p=0.9, eos_id=-1,
                  pad_id=0, tables=tables)
        carry = _state(torch)
        if route == "eager":
            packed = batcher._decode_steps(params, cfg, cache, carry, gen,
                                           k, **kw)
        else:
            packed = batcher.decode_chunk(params, cfg, cache, carry, gen, k,
                                          graphs=graphs, **kw)
        torch.cuda.synchronize()
        outs[route] = (packed.cpu(), cache.k.float().cpu(), gen.get_state())
    for route in ("graph", "graph_again"):
        assert torch.equal(outs[route][0], outs["eager"][0]), route
        assert torch.equal(outs[route][1], outs["eager"][1]), route
        assert torch.equal(outs[route][2], outs["eager"][2]), route
    assert graphs.captures == 1 and graphs.replays == 2


@gpu
@needs_cuda
def test_replays_count_their_launches():
    from distributed_llms_tpu_torch.runtime import batcher

    cfg, params = _tiny()
    b, k = 4, 3
    cache = batcher._paged_pool(cfg, 1 + 4 * b, 64, device="cuda")
    tables = torch.arange(1, 1 + 4 * b, dtype=torch.int32,
                          device="cuda").reshape(b, 4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    graphs = chunk_graph.ChunkGraphs()
    n0 = decode_attn.paged_decode_attention.launches
    for _ in range(3):
        batcher.decode_chunk(params, cfg, cache, _state(torch), gen, k,
                             tables=tables, graphs=graphs)
    per_chunk = cfg.num_layers * k
    # One eager warm-up and three replays, nothing for the capture.
    assert decode_attn.paged_decode_attention.launches - n0 == 4 * per_chunk


@gpu
@needs_cuda
def test_a_host_sync_in_the_capture_raises():
    graphs = chunk_graph.ChunkGraphs()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def syncing(ins):
        if int(ins["carry"].sum()) < 0:  # reads the device: a sync
            return ins["carry"]
        return ins["carry"] + 1

    with pytest.raises(Exception):
        graphs.run("sync", syncing, {"carry": torch.ones(4, device="cuda",
                                                         dtype=torch.int32)},
                   gen)
