"""What the ranks of the port's expert-axis and mesh-training tests run (a
helper module, not a test file): module-level functions that
``torch_world.World`` calls on every rank of a spawned gloo world.  They
import torch and the port only; the test modules hold the reference's
results against what they return.

A mesh arrives as a dict of axis sizes (``{"data": 2, "expert": 2}``);
weights and prompts as numpy trees made by the test from a seed; every
function returns numpy or plain Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.parallel import api
from distributed_llms_tpu_torch.runtime.batcher import ContinuousBatcher

_MODELS: dict = {}


def load(key: str, cfg, params_np) -> None:
    """Keep a model's full weights on this rank under ``key``."""
    _MODELS[key] = (cfg, params_from_numpy(params_np, cfg, device="cpu"))


def _pm(cfg, mesh: dict):
    return api.make_parallel_model(cfg, MeshConfig(**mesh), device="cpu")


def moe_forward(key: str, mesh: dict, tokens) -> dict:
    """Full-batch logits and the MoE term of a no-cache forward on the
    mesh, this rank's expert range and the local expert stack's shape,
    and the collectives each axis took."""
    cfg, params = _MODELS[key]
    pm = _pm(cfg, mesh)
    local = pm.shard_params(params)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
    with torch.no_grad():
        logits, _, aux = pm.forward(local, toks, return_aux=True)
    st = pm.mesh.stats
    return {"logits": logits.numpy(), "aux": float(aux),
            "experts": pm.plan.experts,
            "w_gate": tuple(local["blocks"]["mlp"]["w_gate"].shape),
            "expert_calls": st["axis_expert_calls"],
            "model_calls": st["axis_model_calls"]}


def moe_batcher(key: str, mesh: dict, reqs, kw: dict) -> dict:
    """Greedy streams of a mesh ``ContinuousBatcher`` over ``reqs``
    ([(ids, n)]), every rank fed the same requests."""
    cfg, params = _MODELS[key]
    pm = _pm(cfg, mesh)
    b = ContinuousBatcher(cfg, pm.shard_params(params), parallel=pm, **kw)
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    if b.paged:
        b.assert_pool_consistent()
    return {"streams": [res[r] for r in rids], "loop": b.loop_kind,
            "overlap": b.overlap,
            "expert_calls": pm.mesh.stats["axis_expert_calls"]}


def store_batcher(store_dir: str, mesh: dict, reqs, kw: dict) -> dict:
    """``InferenceEngine.from_store(mesh_cfg=)`` with ``serve_quantized``
    and a mesh batcher over its weights: the greedy streams, and each expert
    leaf's type, code shape and bits as this rank holds it."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine.from_store(
        store_dir, rt=RuntimeConfig(serve_quantized=True),
        mesh_cfg=MeshConfig(**mesh), device="cpu")
    b = ContinuousBatcher(eng.cfg, eng.params, parallel=eng.pm, **kw)
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    leaves = {}
    for name, leaf in eng.params["blocks"]["mlp"].items():
        quant = isinstance(leaf, QuantizedTensor)
        leaves[name] = {
            "type": type(leaf).__name__,
            "unpacked": tuple(leaf.unpacked_shape) if quant else None,
            "bits": leaf.bits if quant else None}
    return {"streams": [res[r] for r in rids], "leaves": leaves,
            "experts": eng.pm.plan.experts}


# -- the mesh training step (runtime/train.py Trainer(parallel=)) --------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _gather_tree(pm, local) -> dict:
    """Every leaf whole, by its "/"-joined path."""
    from distributed_llms_tpu_torch.parallel import specs

    out = {}

    def walk(t, rules, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, rules[k], f"{path}/{k}" if path else k)
        else:
            out[path] = specs.gather_leaf(t, rules, pm.mesh).numpy().copy()

    walk(local, pm.rules, "")
    return out


def train_steps(key: str, mesh: dict, tokens, mask, lr: float, steps: int,
                ckpt_dir: str | None = None) -> dict:
    """``steps`` mesh ``Trainer`` steps from the model's weights: every
    step's loss, the gradients' global norm before the first, the whole
    parameters (gathered) after the first and the last step, and, with
    ``ckpt_dir``, the state saved there after the last step and restored
    onto the same mesh (its leaves and moments against the live ones)."""
    from distributed_llms_tpu_torch.runtime import train, train_ckpt

    cfg, params = _MODELS[key]
    pm = _pm(cfg, mesh)
    local = pm.shard_params(_clone(params))
    tr = train.Trainer(cfg, train.default_optimizer(lr), parallel=pm)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
    msk = None if mask is None else torch.as_tensor(np.asarray(mask))
    _, _, norm = tr.gradients(local, toks, msk)
    state, step = tr.init(local), tr.make_step()
    out = {"norm": float(norm), "losses": [], "after": {},
           "splits_rows": pm.splits_rows(toks.shape[0])}
    for i in range(steps):
        local, state, loss = step(local, state, toks, msk)
        out["losses"].append(float(loss))
        if i + 1 in (1, steps):
            out["after"][i + 1] = _gather_tree(pm, local)
    if ckpt_dir is not None:
        train_ckpt.save_train_state(ckpt_dir, steps, local, state,
                                    parallel=pm)
        at, back, opt = train_ckpt.restore_train_state(ckpt_dir,
                                                       parallel=pm)
        live = train._leaves(local)
        out["restored"] = {
            "step": at, "count": opt["count"] == state["count"],
            "params": all(torch.equal(a, b) for a, b in
                          zip(train._leaves(back), live)),
            "moments": all(torch.equal(a, b) for a, b in
                           zip(opt["mu"] + opt["nu"],
                               state["mu"] + state["nu"]))}
    return out


def worker_requests(store_dir: str, mesh: dict | None, requests) -> dict:
    """A control-plane worker's batch (``WorkerHost._generate_requests``:
    the engine's mesh batcher) over an int4 store served quantized, on
    ``mesh`` (None: one device)."""
    from distributed_llms_tpu_torch.cluster.worker import WorkerHost
    from distributed_llms_tpu_torch.core.config import RuntimeConfig

    rt = RuntimeConfig(serve_quantized=True)
    host = WorkerHost("127.0.0.1", 1, rt=rt, device="cpu",
                      mesh_cfg=None if mesh is None else MeshConfig(**mesh))
    host.engine = host.engine_factory(store_dir, [0], rt)
    out = host._generate_requests(requests)
    pm = host.engine.pm
    return {"text": out["text"], "generated_tokens": out["generated_tokens"],
            "experts": None if pm is None else pm.plan.experts}
