"""What the ranks of the port's mesh tests run (a helper module, not a test
file): module-level functions that ``torch_world.World`` calls on every
rank of a spawned gloo world.  They import torch and the port only; the
test modules hold the reference's results against what they return.

Weights and prompts arrive as numpy trees (made by the test from a seed,
the same arrays the JAX package runs on), and every function returns
numpy or plain Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.parallel import api
from distributed_llms_tpu_torch.runtime.batcher import ContinuousBatcher
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

_MODELS: dict = {}


def _pm(cfg, data: int, model: int, **kw):
    return api.make_parallel_model(cfg, MeshConfig(data=data, model=model),
                                   device="cpu", **kw)


def load(key: str, cfg, params_np) -> None:
    """Keep a model's full weights on this rank under ``key`` (so later
    cases need not ship them again)."""
    _MODELS[key] = (cfg, params_from_numpy(params_np, cfg, device="cpu"))


def rank_info() -> dict:
    import torch.distributed as dist

    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend()}


def forward_logits(key: str, data: int, model: int, tokens, positions=None,
                   with_cache: bool = False) -> dict:
    """Full-batch logits of a no-cache forward (or a prefill into a
    contiguous cache followed by one decode step) on a data x model mesh,
    with the collectives each took."""
    cfg, params = _MODELS[key]
    pm = _pm(cfg, data, model)
    local = pm.shard_params(params)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
    pos = None if positions is None else torch.as_tensor(np.asarray(positions))
    calls0 = pm.mesh.stats["calls"]
    if not with_cache:
        logits, _ = pm.forward(local, toks, positions=pos)
        out = {"logits": logits.numpy()}
    else:
        b, t = toks.shape
        cache = pm.init_cache(b, t + 4)
        logits, cache = pm.forward(local, toks, cache=cache, cache_index=0)
        nxt = logits[:, -1].argmax(-1)
        ci = torch.full((b,), t, dtype=torch.int32)
        step, _ = pm.forward(local, nxt[:, None], positions=ci[:, None],
                             cache=cache, cache_index=ci)
        out = {"logits": logits.numpy(), "step": step.numpy(),
               "cache_heads": int(cache.k.shape[3])}
    out["collectives"] = pm.mesh.stats["calls"] - calls0
    return out


def local_shapes(key: str, data: int, model: int) -> dict:
    """The shape of every local leaf on this rank."""
    cfg, params = _MODELS[key]
    local = _pm(cfg, data, model).shard_params(params)

    def walk(t, path=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(walk(v, f"{path}/{k}"))
            return out
        return {path: tuple(t.shape)}

    return walk(local)


def batcher_streams(key: str, data: int, model: int, reqs, kw: dict,
                    prefix=None, checks: bool = True) -> dict:
    """Greedy streams of a mesh ``ContinuousBatcher`` over ``reqs``
    ([(ids, n)]), every rank fed the same requests, with the counters the
    tests read."""
    cfg, params = _MODELS[key]
    pm = _pm(cfg, data, model)
    b = ContinuousBatcher(cfg, pm.shard_params(params), parallel=pm, **kw)
    if prefix is not None:
        b.register_prefix("sys", prefix)
    rids = []
    for ids, n, *extra in reqs:
        rids.append(b.submit(ids, max_new_tokens=n, **(extra[0] if extra
                                                         else {})))
    res = b.run()
    if checks and b.paged:
        b.assert_pool_consistent()
    out = {
        "streams": [res[r] for r in rids],
        "preemptions": b.preemptions,
        "overlap": b.overlap,
        "dispatched_ahead": b.overlap_stats["dispatched_ahead"],
        "loop": b.loop_kind,
        "cached": {int(k): int(v) for k, v in b.prefix_cached_tokens.items()},
        "hit_tokens": (b.prefix_cache.hit_tokens if b.prefix_cache is not None
                       else 0),
        "pool_heads": int(b.cache.k.shape[3]),
    }
    # Each rank's pool copy: the bytes every data rank must agree on.
    out["pool_sum"] = _pool_sum(b)
    return out


def engine_batcher(store_dir: str, data: int, model: int, reqs,
                   batch_slots: int, **kw) -> dict:
    """``InferenceEngine.from_store(mesh_cfg=)`` on this rank and its
    ``continuous_batcher``: slots, mode and greedy streams."""
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    rt_kw = kw.pop("rt", {})
    eng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(max_decode_steps=8, **rt_kw),
        mesh_cfg=MeshConfig(data=data, model=model), device="cpu")
    try:
        b = eng.continuous_batcher(batch_slots=batch_slots, max_len=64, **kw)
    except ValueError as e:
        return {"error": str(e)}
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    return {"slots": b.b, "paged": b.paged, "pm": b.pm is not None,
            "prefix": b.prefix_cache is not None,
            "streams": [res[r] for r in rids]}


def engine_generate(store_dir: str, data: int, model: int, prompts,
                    n_new: int, **rt_kw) -> dict:
    """``generate_text`` on a mesh engine over a store (quantized leaves
    resident when ``serve_quantized``)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(max_decode_steps=n_new, **rt_kw),
        mesh_cfg=MeshConfig(data=data, model=model), device="cpu")
    out = eng.generate_text(prompts, max_new_tokens=n_new)
    blocks = eng.params["blocks"]
    leaves = {f"{g}/{k}": v for g in blocks for k, v in blocks[g].items()}
    quant = {k: (tuple(v.unpacked_shape), v.bits) for k, v in leaves.items()
             if isinstance(v, QuantizedTensor)}
    return {"tokens": out.tokens.tolist(), "text": out.text, "quant": quant}


def lockstep_streams(key: str, data: int, model: int, reqs, kw: dict,
                     cancel: int | None = None) -> dict:
    """Requests reach rank 0 only: its batcher journals them and every
    other rank follows the broadcasts (``runtime/lockstep.py``).  Rank 0
    submits, runs and stops; the others follow until it stops."""
    from distributed_llms_tpu_torch.runtime.lockstep import follow

    cfg, params = _MODELS[key]
    pm = _pm(cfg, data, model)
    b = ContinuousBatcher(cfg, pm.shard_params(params), parallel=pm, **kw)
    lock = b.enable_lockstep()
    if not lock.leader:
        follow(b)
        return {"syncs": lock.syncs, "pool_sum": _pool_sum(b)}
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    if cancel is not None:
        b.cancel_row(rids[cancel])
    res = b.run()
    lock.stop()
    return {"streams": [res.get(r) for r in rids], "syncs": lock.syncs,
            "pool_sum": _pool_sum(b)}


def _pool_sum(b) -> float | None:
    if not b.paged:
        return None
    return float(b.cache.k.double().abs().sum() + b.cache.v.double().abs().sum())


# -- the pipeline (parallel/pipeline.py) ---------------------------------------

def _ppm(cfg, data: int = 1, pipe: int = 2, model: int = 1,
         microbatches: int = 1):
    return api.make_parallel_model(
        cfg, MeshConfig(data=data, pipe=pipe, model=model), device="cpu",
        num_microbatches=microbatches)


def pipe_blocks(key: str, microbatches: int, x, positions,
                cache_len: int | None = None) -> dict:
    """``pipeline.pipeline_blocks`` over this rank's stage (pipe = the
    world): the last stage's output, and each stage's cache after a
    prefill into a ``cache_len``-slot cache when one is given."""
    from distributed_llms_tpu_torch.parallel import pipeline

    cfg, params = _MODELS[key]
    import torch.distributed as dist

    pm = _ppm(cfg, pipe=dist.get_world_size(), microbatches=microbatches)
    local = pm.shard_params(params)
    xt = torch.as_tensor(np.asarray(x))
    pos = torch.as_tensor(np.asarray(positions))
    cache = None if cache_len is None else pm.init_cache(xt.shape[0],
                                                         cache_len)
    with pm.activate():
        y = pipeline.pipeline_blocks(
            pm.mesh, pm.local_cfg, local["blocks"],
            xt if pm.stage == 0 else None, pos, microbatches,
            cache_k=None if cache is None else cache.k,
            cache_v=None if cache is None else cache.v,
            cache_index=None if cache is None else 0)
    return {"stage": pm.stage, "y": None if y is None else y.numpy(),
            "k": None if cache is None else cache.k.numpy(),
            "v": None if cache is None else cache.v.numpy(),
            "groups": sorted(local), "ticks": microbatches + pm.num_stages - 1,
            "shifts": pm.mesh.stats["shift_calls"]}


def pipe_generate(key: str, data: int, pipe: int, model: int,
                  microbatches: int, prompt, lens, n_new: int,
                  eos_id: int = -1, temperature: float = 0.0,
                  top_k: int = 0) -> dict:
    """``runtime.generate.generate_tokens`` on a data x pipe x model mesh
    through the pipelined forward and the wavefront decode."""
    from distributed_llms_tpu_torch.runtime import generate as gen

    cfg, params = _MODELS[key]
    pm = _ppm(cfg, data, pipe, model, microbatches)
    local = pm.shard_params(params)
    gen_ = torch.Generator().manual_seed(0)
    with pm.activate():
        out = gen.generate_tokens(
            local, pm.local_cfg, torch.as_tensor(np.asarray(prompt)),
            torch.as_tensor(np.asarray(lens)), gen_, n_new,
            temperature=temperature, top_k=top_k, eos_id=eos_id, pad_id=0,
            forward_fn=pm.as_forward_fn(), make_cache=pm.as_make_cache(),
            decode_fn=pm.as_decode_fn())
    return {"tokens": out.tolist(), "shifts": pm.mesh.stats["shift_calls"]}


def pipe_engine_generate(store_dir: str, prompts, n_new: int,
                         microbatches: int, **rt_kw) -> dict:
    """``generate_text`` on a pipelined engine over a store (pipe = the
    world): tokens, the groups this stage holds and its quantized
    leaves."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(max_decode_steps=n_new,
                                    microbatches=microbatches, **rt_kw),
        mesh_cfg=MeshConfig(pipe=dist.get_world_size()), device="cpu")
    out = eng.generate_text(prompts, max_new_tokens=n_new)
    blocks = eng.params["blocks"]
    leaves = {f"{g}/{k}": v for g in blocks for k, v in blocks[g].items()}
    quant = {k: (tuple(v.unpacked_shape), v.bits) for k, v in leaves.items()
             if isinstance(v, QuantizedTensor)}
    try:
        eng.continuous_batcher()
        batcher = None
    except ValueError as e:
        batcher = str(e)
    return {"tokens": out.tokens.tolist(), "quant": quant,
            "groups": sorted(eng.params), "batcher": batcher,
            "multiple": eng._batch_multiple()}


def pipe_worker_requests(store_dir: str, requests, microbatches: int,
                         eos_id: int) -> dict:
    """A control-plane worker's mixed-budget batch on a pipelined engine
    (its grouped fallback), the tokenizer's EOS moved to ``eos_id``."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.cluster.worker import WorkerHost
    from distributed_llms_tpu_torch.core.config import RuntimeConfig

    rt = RuntimeConfig(microbatches=microbatches)
    host = WorkerHost("127.0.0.1", 1, rt=rt,
                      mesh_cfg=MeshConfig(pipe=dist.get_world_size()),
                      device="cpu")
    host.engine = host.engine_factory(store_dir, [0], rt)
    host.engine.tokenizer = EosTokenizer(eos_id)
    out = host._generate_requests(requests)
    return {"text": out["text"], "generated_tokens": out["generated_tokens"]}


class EosTokenizer(ByteTokenizer):
    """The byte tokenizer with its EOS moved to ``eos`` (a token random
    weights emit), so that a test sees rows stop."""

    def __init__(self, eos: int) -> None:
        self._eos = eos

    @property
    def eos_id(self) -> int:
        return self._eos


def pipe_engine_session(store_dir: str, turns, n_new: int,
                        microbatches: int) -> list:
    """A multi-turn session on a pipelined engine (pipe = the world): each
    turn's tokens (the prefill and every step through the GPipe
    forward into the stages' caches)."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(microbatches=microbatches),
        mesh_cfg=MeshConfig(pipe=dist.get_world_size()), device="cpu")
    sid, res = eng.start_session(turns[0], max_new_tokens=n_new)
    out = [res.tokens.tolist()]
    for prompts in turns[1:]:
        out.append(eng.continue_session(sid, prompts,
                                        max_new_tokens=n_new).tokens.tolist())
    return out


# -- sequence parallelism (ops/ring.py, ops/ulysses.py) -------------------------

def _smesh(seq: int, data: int = 1, model: int = 1):
    from distributed_llms_tpu_torch.core.mesh import build_mesh

    return build_mesh(MeshConfig(data=data, seq=seq, model=model),
                      device="cpu")


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def seq_collectives(piece_bytes: int) -> dict:
    """The seq line's collectives on rank-dependent tensors, every
    all-gather in pieces of ``piece_bytes``: the max and the sum, the
    all-to-all both ways, the shift, and the calls counted by kind."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.core import mesh as mesh_lib

    n, r = dist.get_world_size(), dist.get_rank()
    mesh = _smesh(n)
    saved, mesh_lib.PIECE_BYTES = mesh_lib.PIECE_BYTES, piece_bytes
    try:
        x = torch.arange(2 * 3 * 4 * n, dtype=torch.float32).reshape(
            2, 3, 4 * n) + 100 * r
        out = {
            "max": mesh.all_reduce(x, "seq", op="max").numpy(),
            "sum": mesh.all_reduce(x, "seq").numpy(),
            "a2a": mesh.all_to_all(x, 2, 1, "seq").numpy(),
            "back": mesh.all_to_all(mesh.all_to_all(x, 2, 1, "seq"), 1, 2,
                                    "seq").numpy(),
            "gather": mesh.all_gather(x, 1, "seq").numpy(),
            "shift": mesh.shift(x, "seq").numpy(),
        }
    finally:
        mesh_lib.PIECE_BYTES = saved
    try:
        mesh.all_reduce(x, "seq", op="min")
    except ValueError as e:
        out["bad_op"] = str(e)
    out["stats"] = dict(mesh.stats)
    return out


def seq_attention(impl: str, q, k, v, q_pos, k_pos, k_valid,
                  causal: bool = True) -> dict:
    """``ring_attention`` or ``ulysses_attention`` on a seq line of the
    whole world: each rank passes its contiguous block of the global
    inputs and returns its block of the output, with the collectives it
    took; a refusal comes back as its message."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.ops import ring, ulysses

    n, r = dist.get_world_size(), dist.get_rank()
    mesh = _smesh(n)
    t = np.asarray(q).shape[1]
    blk = slice(r * t // n, (r + 1) * t // n)
    q_, k_, v_ = (_t(x)[:, blk] for x in (q, k, v))
    qp, kp = _t(q_pos)[:, blk], _t(k_pos)[:, blk]
    kv = None if k_valid is None else _t(k_valid)[:, blk]
    try:
        if impl == "ring":
            out = ring.ring_attention(q_, k_, v_, qp, kp, causal=causal,
                                      k_valid=kv, mesh=mesh)
        else:
            out = ulysses.ulysses_attention(q_, k_, v_, qp, causal=causal,
                                            k_valid=kv, mesh=mesh)
    except ValueError as e:
        return {"error": str(e)}
    return {"out": out.numpy(), "stats": dict(mesh.stats)}


def ring_self(q, k, v, positions, causal: bool = True) -> np.ndarray:
    """``ring_self_attention`` over the whole world's seq line: the global
    inputs on every rank, the global output back."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.ops import ring

    mesh = _smesh(dist.get_world_size())
    return ring.ring_self_attention(mesh, _t(q), _t(k), _t(v), _t(positions),
                                    causal=causal).numpy()


def seq_decode(q, ck, cv, dk, dv, mask_pref, mask_dec) -> dict:
    """``seq_cached_decode_attention`` with the prompt region cut over the
    world's seq line (each rank its block of ck / cv / mask_pref)."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.ops import ring

    n, r = dist.get_world_size(), dist.get_rank()
    mesh = _smesh(n)
    s = np.asarray(ck).shape[1]
    blk = slice(r * s // n, (r + 1) * s // n)
    out = ring.seq_cached_decode_attention(
        _t(q), _t(ck)[:, blk], _t(cv)[:, blk], _t(dk), _t(dv),
        _t(mask_pref)[:, blk], _t(mask_dec), mesh=mesh)
    return {"out": out.numpy(), "stats": dict(mesh.stats)}


def _seq_pm(key: str, data: int, seq: int, model: int, attn_impl: str):
    import dataclasses

    cfg, params = _MODELS[key]
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    pm = api.make_parallel_model(
        cfg, MeshConfig(data=data, seq=seq, model=model), device="cpu")
    return pm, pm.shard_params(params)


def seq_forward(key: str, data: int, seq: int, model: int, attn_impl: str,
                tokens, attn_mask=None) -> dict:
    """A no-cache forward on a data x seq x model mesh: the full logits
    every rank returns, and the collectives it took."""
    pm, local = _seq_pm(key, data, seq, model, attn_impl)
    logits, cache = pm.forward(local, _t(tokens).long(),
                               attn_mask=_t(attn_mask))
    return {"logits": logits.numpy(), "cache": cache,
            "stats": dict(pm.mesh.stats)}


def seq_generate(key: str, data: int, seq: int, model: int, attn_impl: str,
                 prompt, lens, n_new: int) -> dict:
    """``runtime.generate.generate_tokens`` through a seq mesh's forward
    and two-region cache: the tokens, and this rank's cache regions."""
    from distributed_llms_tpu_torch.runtime import generate as gen

    pm, local = _seq_pm(key, data, seq, model, attn_impl)
    made = []

    def make_cache(*a, **kw):
        made.append(pm.as_make_cache()(*a, **kw))
        return made[-1]

    with pm.activate():
        out = gen.generate_tokens(
            local, pm.local_cfg, _t(prompt), _t(lens), None, n_new, pad_id=0,
            forward_fn=pm.as_forward_fn(), make_cache=make_cache)
    cache = made[0]
    return {"tokens": out.tolist(),
            "regions": [tuple(t.shape) for t in cache.k],
            "stats": dict(pm.mesh.stats)}


def seq_engine(store_dir: str, prompts, n_new: int, **rt_kw) -> dict:
    """``generate_text`` on a seq engine over a store (seq = the world),
    with what the engine refuses on that mesh."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(max_decode_steps=n_new, **rt_kw),
        mesh_cfg=MeshConfig(seq=dist.get_world_size()), device="cpu")
    out = eng.generate_text(prompts, max_new_tokens=n_new)
    refused = {}
    for name, call in (("batcher", eng.continuous_batcher),
                       ("session", lambda: eng.start_session(prompts))):
        try:
            call()
        except ValueError as e:
            refused[name] = str(e)
    blocks = eng.params["blocks"]
    n_quant = sum(isinstance(v, QuantizedTensor) for g in blocks.values()
                  for v in g.values())
    arr, _, _ = eng._encode_rows(prompts, batch=None)
    return {"tokens": out.tokens.tolist(), "refused": refused,
            "quantized_leaves": n_quant, "padded_width": int(arr.shape[1]),
            "shifts": eng.pm.mesh.stats["shift_calls"]}


def seq_worker_requests(store_dir: str, requests, eos_id: int) -> dict:
    """A control-plane worker's mixed-budget batch on a seq engine (its
    grouped fallback), the tokenizer's EOS moved to ``eos_id``."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.cluster.worker import WorkerHost
    from distributed_llms_tpu_torch.core.config import RuntimeConfig

    rt = RuntimeConfig()
    host = WorkerHost("127.0.0.1", 1, rt=rt,
                      mesh_cfg=MeshConfig(seq=dist.get_world_size()),
                      device="cpu")
    host.engine = host.engine_factory(store_dir, [0], rt)
    host.engine.tokenizer = EosTokenizer(eos_id)
    out = host._generate_requests(requests)
    return {"text": out["text"], "generated_tokens": out["generated_tokens"]}
