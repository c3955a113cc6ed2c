"""Shard rules: which mesh axis shards which axis of each parameter
(PyTorch port of ``distributed_llms_tpu/parallel/specs.py``).

A rule is a :class:`P`, one entry per tensor axis: the mesh axis that
shards it, or None (replicated along it), exactly the reference's
``PartitionSpec`` per leaf, including "shard only when divisible, else
replicate".  :func:`shard_params` then takes each rank's slice (the
reference's ``device_put`` onto the mesh): every rank holds only its own
block of each sharded leaf, made contiguous (the kernels read 16-byte
aligned rows).

Conventions (the reference's):
- stacked layer axis L    -> 'pipe'  (when it divides)
- attention head axis     -> 'model' (KV heads only when divisible: GQA
                                      with few KV heads replicates KV)
- MLP hidden axis F       -> 'model'
- vocab axis              -> 'model'
- expert axis             -> 'expert'
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core.config import ModelConfig
from ..core.observability import get_logger

Params = Any

log = get_logger("parallel")


class P(tuple):
    """A shard rule: one mesh axis name (or None) per tensor axis; axes
    past its length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axis_size(mesh, name) -> int:
    """Size of a rule entry (an axis name or None) on a mesh."""
    if name is None:
        return 1
    return mesh.shape.get(name, 1)


def param_specs(cfg: ModelConfig, mesh) -> Params:
    """The rule tree matching ``models.model`` parameter trees."""
    tp = _axis_size(mesh, "model")
    pipe_sz = _axis_size(mesh, "pipe")
    pipe = "pipe" if pipe_sz > 1 and cfg.num_layers % pipe_sz == 0 else None
    q_ax = "model" if cfg.num_heads % max(tp, 1) == 0 else None
    kv_ax = "model" if cfg.num_kv_heads % max(tp, 1) == 0 else None
    vocab_ax = "model" if cfg.vocab_size % max(tp, 1) == 0 else None
    f_ax = "model" if cfg.intermediate_size % max(tp, 1) == 0 else None

    specs: Params = {
        "embed": {"wte": P(vocab_ax, None)},
        "final_norm": {"scale": P(None)},
    }
    attn = {
        "wq": P(pipe, None, q_ax, None),
        "wk": P(pipe, None, kv_ax, None),
        "wv": P(pipe, None, kv_ax, None),
        "wo": P(pipe, q_ax, None, None),
    }
    if cfg.qkv_bias or cfg.family in ("gpt2", "opt", "neox"):
        attn.update(bq=P(pipe, q_ax, None), bk=P(pipe, kv_ax, None),
                    bv=P(pipe, kv_ax, None))
    if cfg.family in ("gpt2", "opt", "neox"):
        if cfg.family != "neox":  # neox is rotary: no position table
            specs["embed"]["wpe"] = P(None, None)
        specs["final_norm"]["bias"] = P(None)
        attn["bo"] = P(pipe, None)
        mlp = {
            "w_in": P(pipe, None, f_ax), "b_in": P(pipe, f_ax),
            "w_out": P(pipe, f_ax, None), "b_out": P(pipe, None),
        }
        norm = {"scale": P(pipe, None), "bias": P(pipe, None)}
    elif cfg.num_experts > 0:
        ep_size = _axis_size(mesh, "expert")
        ep = ("expert" if ep_size > 1 and cfg.num_experts % ep_size == 0
              else None)
        mlp = {
            "router": P(pipe, None, None),
            "w_gate": P(pipe, ep, None, f_ax), "w_up": P(pipe, ep, None, f_ax),
            "w_down": P(pipe, ep, f_ax, None),
        }
        norm = {"scale": P(pipe, None)}
    else:
        mlp = {
            "w_gate": P(pipe, None, f_ax), "w_up": P(pipe, None, f_ax),
            "w_down": P(pipe, f_ax, None),
        }
        norm = {"scale": P(pipe, None)}
    specs["blocks"] = {"ln1": dict(norm), "ln2": dict(norm), "attn": attn,
                       "mlp": mlp}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": P(None, vocab_ax)}
    return specs


def page_pool_specs(cfg: ModelConfig, mesh, kv_bits: int = 16,
                    row_dtype: str | None = None) -> Any:
    """The rules of the paged KV pool: data leaves ``[L, NB, BLK, KVH,
    HD]`` shard the KV-head axis over 'model' (per-rank pool bytes divide
    by tp), int8 scales ``[L, NB, BLK, KVH]`` the same axis.  Pages are
    shared across rows (the prefix cache, handoff imports), so the page
    axis never shards over 'data'.  KV heads that do not divide
    replicate (the batcher refuses that combination up front)."""
    from ..models.model import KVCache, QuantKVCache

    tp = _axis_size(mesh, "model")
    kv_ax = "model" if cfg.num_kv_heads % max(tp, 1) == 0 else None
    data = P(None, None, None, kv_ax, None)
    if kv_bits == 8:
        scale = P(None, None, None, kv_ax)
        return QuantKVCache(k=data, v=data, k_scale=scale, v_scale=scale,
                            row_dtype=row_dtype or cfg.dtype)
    return KVCache(k=data, v=data)


def local_slice(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (contiguous); every
    sharded axis must divide."""
    for ax, name in enumerate(spec):
        n = _axis_size(mesh, name)
        if n == 1:
            continue
        size = x.shape[ax]
        if size % n:
            raise ValueError(
                f"axis {ax} of {tuple(x.shape)} does not divide over "
                f"{name!r} ({n})")
        per = size // n
        i = mesh.coords[name]
        x = x.narrow(ax, i * per, per)
    return x.contiguous()


def gather_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block under ``spec`` (the inverse
    of :func:`local_slice`): each sharded axis gathered over its line.
    Every rank of the mesh must call it alike."""
    for ax, name in enumerate(spec):
        if _axis_size(mesh, name) > 1:
            x = mesh.all_gather(x, ax, name)
    return x


def shard_leaf(x: Any, spec: P, mesh, path: str = "") -> Any:
    """This rank's part of one leaf: a tensor's block, or a quantized
    leaf placed by :func:`place_quantized`."""
    from ..checkpoint.quantize import QuantizedTensor

    if isinstance(x, QuantizedTensor):
        return place_quantized(x, spec, mesh, path)
    return local_slice(x, spec, mesh)


def shard_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """Each rank's slice of a parameter tree (tensors already on the
    rank's device stay there)."""
    return shard_tree(params, param_specs(cfg, mesh), mesh)


def shard_tree(params: Params, specs: Params, mesh, path: str = "") -> Params:
    if isinstance(params, dict):
        return {k: shard_tree(v, specs[k], mesh, f"{path}/{k}")
                for k, v in params.items()}
    return shard_leaf(params, specs, mesh, path)


class ReplicatedQuantized:
    """A quantized leaf whose layout cannot shard under its rule, kept
    whole on every rank (loudly, as the reference replicates it).  The
    layer code still hands its contraction this rank's activations, so
    :meth:`contract` adapts: a leaf sharded on an output axis computes
    the whole product and keeps this rank's columns; one sharded on a
    contracted axis gathers the activations' contracted block from the
    'model' line, and only the line's first rank contributes the product
    to the layer's sum."""

    def __init__(self, qt, spec: P, mesh) -> None:
        self.qt = qt
        self.spec = spec
        self.mesh = mesh

    def to(self, device) -> "ReplicatedQuantized":
        return ReplicatedQuantized(self.qt.to(device), self.spec, self.mesh)

    def __getitem__(self, i) -> "ReplicatedQuantized":
        """Layer ``i`` of a stacked leaf (the rule loses its layer axis)."""
        return ReplicatedQuantized(self.qt[i], P(*self.spec[1:]), self.mesh)

    def contract(self, x: torch.Tensor, k_lead: int) -> torch.Tensor:
        from ..ops.quant_matmul import quant_contract

        spec = tuple(self.spec) + (None,) * (self.qt.data.dim() - len(self.spec))
        k_axes = [a for a in range(k_lead) if spec[a] is not None]
        n_axes = [a for a in range(k_lead, len(spec)) if spec[a] is not None]
        mesh = self.mesh
        if k_axes:
            x_ax = x.dim() - k_lead + k_axes[0]
            full = mesh.all_gather(x, dim=x_ax, axis=spec[k_axes[0]])
            y = quant_contract(full, self.qt, k_lead)
            return y if mesh.coord(spec[k_axes[0]]) == 0 else torch.zeros_like(y)
        y = quant_contract(x, self.qt, k_lead)
        for a in n_axes:
            y_ax = (x.dim() - k_lead) + (a - k_lead)
            n = _axis_size(mesh, spec[a])
            per = y.shape[y_ax] // n
            y = y.narrow(y_ax, mesh.coord(spec[a]) * per, per)
        return y


def place_quantized(leaf, spec: P, mesh, path: str = ""):
    """This rank's part of a ``QuantizedTensor`` under the plain weight's
    rule (the reference's ``_place_quantized``).  Codes shard exactly
    like the weight (int4 pairs along the pack axis: a contiguous block of
    packed rows unpacks to the same contiguous rows); scales have the
    weight's shape with the last axis in blocks, and when the rule shards
    that last axis they are refined first (each block's scale repeated
    block / g times, g = gcd(block, shard width): numerically identical)
    so shard edges fall on block edges.  A layout that cannot shard (an
    axis that does not divide, an int4 pack axis at a sharded last axis)
    stays whole on every rank, with a warning
    (:class:`ReplicatedQuantized`)."""
    from ..checkpoint.quantize import QuantizedTensor

    data, scale = leaf.data, leaf.scale
    s = tuple(spec) + (None,) * (data.dim() - len(spec))

    def replicate(reason: str):
        log.warning("quantized leaf %s cannot shard under %s (%s); "
                    "replicating", path, P(*s), reason)
        return ReplicatedQuantized(leaf, P(*s), mesh)

    if all(_axis_size(mesh, n) == 1 for n in s):
        return leaf
    pack_ax = data.dim() + leaf.pack_axis if leaf.bits == 4 else None
    for ax, name in enumerate(s):
        n = _axis_size(mesh, name)
        if n > 1 and data.shape[ax] % n:
            return replicate(f"data axis {ax} ({data.shape[ax]}) % shards")
    last = data.dim() - 1
    tp_last = _axis_size(mesh, s[last])
    if tp_last > 1 and pack_ax == last:
        return replicate("the rule shards the int4 pack axis at the last dim")
    if tp_last > 1:
        dim = data.shape[last]
        block = dim // scale.shape[-1]
        per_shard = dim // tp_last
        if per_shard % block:
            g = math.gcd(block, per_shard)
            scale = torch.repeat_interleave(scale, block // g, dim=-1)
    spec_full = P(*s)
    q = local_slice(data, spec_full, mesh)
    sc = local_slice(scale, spec_full, mesh)
    shape = list(q.shape)
    if leaf.bits == 4:
        shape[leaf.pack_axis] *= 2
    return QuantizedTensor(data=q, scale=sc, bits=leaf.bits,
                           orig_shape=tuple(shape), pack_axis=leaf.pack_axis)
