"""Carry the JAX package's parameters across to the port.

``params_from_numpy(tree, cfg, device, dtype)`` takes the reference's
parameter pytree after ``jax.tree.map(np.asarray, params)`` — the nested
dict of numpy arrays that ``distributed_llms_tpu.models.model.init_params``
and the shard store produce — and returns the port's parameters.  Both
stacks keep the same tree and the same layouts, so every leaf maps
one-to-one, unchanged in shape and element order:

=================================  ==================  ====================
leaf                               shape               notes
=================================  ==================  ====================
embed.wte                          [V, D]              row gather
final_norm.scale                   [D]
lm_head.w (untied only)            [D, V]              tied: embed.wte.T
blocks.ln1.scale, blocks.ln2.scale [L, D]              stacked over layers
blocks.attn.wq                     [L, D, H, hd]       head axis explicit
blocks.attn.wk, blocks.attn.wv     [L, D, KVH, hd]
blocks.attn.wo                     [L, H, hd, D]
blocks.attn.bq/bk/bv (qkv_bias)    [L, H|KVH, hd]
blocks.mlp.w_gate, blocks.mlp.w_up [L, D, F]
blocks.mlp.w_down                  [L, F, D]
gpt2/opt/neox: embed.wpe           [S (+2 opt), D]     no wpe for neox
  final_norm.bias, ln1/ln2.bias    [D], [L, D]
  blocks.attn.bq/bk/bv, bo         [L, H|KVH, hd], [L, D]
  blocks.mlp.w_in, b_in            [L, D, F], [L, F]   in place of the
  blocks.mlp.w_out, b_out          [L, F, D], [L, D]   gated MLP
MoE (llama): blocks.mlp.router     [L, D, E]
  blocks.mlp.w_gate, w_up          [L, E, D, F]
  blocks.mlp.w_down                [L, E, F, D]
=================================  ==================  ====================

Values convert through float32 to ``dtype`` (default ``cfg.dtype``), so a
bfloat16 tree (numpy carries it as ``ml_dtypes.bfloat16``) round-trips
exactly.  A weight-only quantized leaf (the JAX package's
``QuantizedTensor``, its codes and scales numpy arrays) crosses as the
port's ``checkpoint.quantize.QuantizedTensor`` with its int8 codes and
float32 scales unchanged; it is recognised by its fields, not imported.
Every family of the reference crosses.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device
from ..models import model as model_lib
from .quantize import QuantizedTensor

# The leaves the port's forward reads for ``cfg``, with their shapes.
def _expected(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KVH, HD, V = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                     cfg.vocab_size)
    out = {
        "embed.wte": (V, D),
        "final_norm.scale": (D,),
        "blocks.ln1.scale": (L, D),
        "blocks.ln2.scale": (L, D),
        "blocks.attn.wq": (L, D, H, HD),
        "blocks.attn.wk": (L, D, KVH, HD),
        "blocks.attn.wv": (L, D, KVH, HD),
        "blocks.attn.wo": (L, H, HD, D),
    }
    if model_lib.layernorm_family(cfg):
        off = model_lib.learned_pos_offset(cfg)
        if off is not None:
            out["embed.wpe"] = (cfg.max_seq_len + off, D)
        out.update({
            "final_norm.bias": (D,),
            "blocks.ln1.bias": (L, D), "blocks.ln2.bias": (L, D),
            "blocks.attn.bq": (L, H, HD), "blocks.attn.bk": (L, KVH, HD),
            "blocks.attn.bv": (L, KVH, HD), "blocks.attn.bo": (L, D),
            "blocks.mlp.w_in": (L, D, F), "blocks.mlp.b_in": (L, F),
            "blocks.mlp.w_out": (L, F, D), "blocks.mlp.b_out": (L, D),
        })
    elif cfg.num_experts > 0:
        E = cfg.num_experts
        out.update({
            "blocks.mlp.router": (L, D, E),
            "blocks.mlp.w_gate": (L, E, D, F),
            "blocks.mlp.w_up": (L, E, D, F),
            "blocks.mlp.w_down": (L, E, F, D),
        })
    else:
        out.update({
            "blocks.mlp.w_gate": (L, D, F),
            "blocks.mlp.w_up": (L, D, F),
            "blocks.mlp.w_down": (L, F, D),
        })
    if cfg.family == "llama" and cfg.qkv_bias:
        out.update({"blocks.attn.bq": (L, H, HD), "blocks.attn.bk": (L, KVH, HD),
                    "blocks.attn.bv": (L, KVH, HD)})
    if not cfg.tie_embeddings:
        out["lm_head.w"] = (D, V)
    return out


def _is_quantized(leaf: Any) -> bool:
    # "bits" first: an ndarray has a .data buffer too.
    return all(hasattr(leaf, f) for f in ("bits", "pack_axis", "orig_shape",
                                          "scale", "data"))


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: "str | torch.device | None" = None,
                      dtype: Any = None) -> dict:
    """The JAX package's numpy parameter tree -> the port's tensors on
    ``device`` (default CUDA; raises without a GPU unless ``device='cpu'``).
    Raises ValueError on a missing, extra or misshapen leaf."""
    model_lib.check_supported(cfg)
    dev = resolve_device(device)
    dt = model_lib.torch_dtype(dtype or cfg.dtype)
    flat = _flatten(tree)
    want = _expected(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"parameter tree does not match {cfg.family} config: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}"
        )
    out = {}
    for path, arr in flat.items():
        if _is_quantized(arr):
            qt = QuantizedTensor(
                data=torch.from_numpy(np.array(arr.data, np.int8)),
                scale=torch.from_numpy(np.array(arr.scale, np.float32)),
                bits=int(arr.bits), orig_shape=tuple(arr.orig_shape),
                pack_axis=int(arr.pack_axis))
            shape, value = qt.unpacked_shape, qt.to(dev)
        else:
            arr = np.asarray(arr)
            shape = arr.shape
            value = torch.from_numpy(
                np.ascontiguousarray(arr.astype(np.float32))
            ).to(device=dev, dtype=dt)
        if shape != want[path]:
            raise ValueError(f"{path}: shape {shape}, expected {want[path]}")
        out[path] = value
    return _unflatten(out)
