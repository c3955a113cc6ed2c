"""HF checkpoint -> the port's stacked parameter tree (PyTorch port of
``distributed_llms_tpu/checkpoint/convert.py``).

Input is a flat ``{name: tensor}`` state dict (numpy arrays are taken
too), read from a HuggingFace snapshot directory by
:func:`load_state_dict`; output is the stacked-layer tree that
``models.model.forward`` consumes (``checkpoint/from_jax.py`` lists its
leaves), as host tensors in ``cfg.dtype``.  Each family has an explicit
name-mapping table: llama (with Mistral, Mixtral's experts, Qwen2's
biases, Gemma's folded norms and Phi-3's fused projections), gpt2, opt
and neox.  :func:`config_from_hf` maps a ``config.json`` onto a
``ModelConfig`` and rejects what the model code cannot serve.

Weight files are read without the ``safetensors`` package: a
``.safetensors`` file is an 8-byte little-endian header length, a JSON
header naming each tensor's dtype, shape and byte range, then the raw
little-endian bytes, which :func:`read_safetensors` maps straight onto
tensors (bfloat16 included).  A ``.bin`` goes through
``torch.load(weights_only=True)``, memory-mapped.  Tensors keep the
checkpoint's dtype until :func:`convert_state_dict` casts them.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from ..core.config import ModelConfig

StateDict = Mapping[str, Any]

# safetensors dtype tag -> torch dtype (the format's little-endian bytes
# are torch's own layout on every supported host).
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


# ---------------------------------------------------------------------------
# State-dict loading
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, in its stored dtype: each
    read straight into its own host tensor (no second copy of the file)."""
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES.get(meta["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has unsupported "
                                 f"dtype {meta['dtype']!r}")
            begin, end = meta["data_offsets"]
            shape = tuple(meta["shape"])
            t = torch.empty(shape, dtype=dtype)
            if end - begin != t.numel() * t.element_size():
                raise ValueError(f"{path}: tensor {name!r} spans {end - begin}"
                                 f" bytes, its shape {shape} needs "
                                 f"{t.numel() * t.element_size()}")
            view = memoryview(t.reshape(-1).view(torch.uint8).numpy())
            f.seek(8 + n + begin)
            got = 0
            while got < len(view):  # readinto may stop short of a large read
                k = f.readinto(view[got:])
                if not k:
                    raise ValueError(f"{path}: tensor {name!r} is truncated")
                got += k
            out[name] = t
    return out


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """Load all weight files of a HF snapshot directory (``.safetensors``
    first, else ``.bin``) as host tensors in their stored dtype."""
    out: dict[str, torch.Tensor] = {}
    names = sorted(os.listdir(model_dir))
    st_files = [n for n in names if n.endswith(".safetensors")]
    bin_files = [n for n in names if n.endswith(".bin") and "training" not in n]
    if st_files:
        for name in st_files:
            out.update(read_safetensors(os.path.join(model_dir, name)))
    elif bin_files:
        for name in bin_files:
            out.update(torch.load(os.path.join(model_dir, name),
                                  map_location="cpu", weights_only=True,
                                  mmap=True))
    else:
        raise FileNotFoundError(f"no .safetensors or .bin weights under {model_dir}")
    return out


# ---------------------------------------------------------------------------
# Family mapping tables
# ---------------------------------------------------------------------------

def _tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _t(w: torch.Tensor) -> torch.Tensor:
    """[out, in] (nn.Linear) -> [in, out]."""
    return w.transpose(0, 1)


def _strip_prefix(sd: StateDict, prefixes: Iterable[str]) -> dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def _stack(sd: StateDict, template: str, num_layers: int,
           fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    per_layer = []
    for i in range(num_layers):
        key = template.format(i=i)
        if key not in sd:
            raise KeyError(f"missing checkpoint key {key!r}")
        per_layer.append(fn(_tensor(sd[key])))
    return torch.stack(per_layer)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def convert_gpt2(sd: StateDict, cfg: ModelConfig) -> dict[str, Any]:
    """GPT-2 uses Conv1D layers: weights are stored [in, out] already (no
    transpose needed); c_attn fuses q,k,v along the output axis."""
    sd = _strip_prefix(sd, ("transformer.",))
    D, H, HD = cfg.hidden_size, cfg.num_heads, cfg.head_dim_

    def q_of(w):  # [D, 3D] -> [D, H, HD]
        return w[:, :D].reshape(D, H, HD)

    def k_of(w):
        return w[:, D : 2 * D].reshape(D, H, HD)

    def v_of(w):
        return w[:, 2 * D :].reshape(D, H, HD)

    def qb_of(b):  # [3D] -> [H, HD]
        return b[:D].reshape(H, HD)

    def kb_of(b):
        return b[D : 2 * D].reshape(H, HD)

    def vb_of(b):
        return b[2 * D :].reshape(H, HD)

    L = cfg.num_layers
    return {
        "embed": {
            "wte": _tensor(sd["wte.weight"]),
            "wpe": _tensor(sd["wpe.weight"]),
        },
        "final_norm": {
            "scale": _tensor(sd["ln_f.weight"]),
            "bias": _tensor(sd["ln_f.bias"]),
        },
        "blocks": {
            "ln1": {
                "scale": _stack(sd, "h.{i}.ln_1.weight", L, _same),
                "bias": _stack(sd, "h.{i}.ln_1.bias", L, _same),
            },
            "ln2": {
                "scale": _stack(sd, "h.{i}.ln_2.weight", L, _same),
                "bias": _stack(sd, "h.{i}.ln_2.bias", L, _same),
            },
            "attn": {
                "wq": _stack(sd, "h.{i}.attn.c_attn.weight", L, q_of),
                "wk": _stack(sd, "h.{i}.attn.c_attn.weight", L, k_of),
                "wv": _stack(sd, "h.{i}.attn.c_attn.weight", L, v_of),
                "bq": _stack(sd, "h.{i}.attn.c_attn.bias", L, qb_of),
                "bk": _stack(sd, "h.{i}.attn.c_attn.bias", L, kb_of),
                "bv": _stack(sd, "h.{i}.attn.c_attn.bias", L, vb_of),
                "wo": _stack(sd, "h.{i}.attn.c_proj.weight", L,
                             lambda w: w.reshape(H, HD, D)),
                "bo": _stack(sd, "h.{i}.attn.c_proj.bias", L, _same),
            },
            "mlp": {
                "w_in": _stack(sd, "h.{i}.mlp.c_fc.weight", L, _same),
                "b_in": _stack(sd, "h.{i}.mlp.c_fc.bias", L, _same),
                "w_out": _stack(sd, "h.{i}.mlp.c_proj.weight", L, _same),
                "b_out": _stack(sd, "h.{i}.mlp.c_proj.bias", L, _same),
            },
        },
    }


def _stack_experts(
    sd: StateDict, template: str, num_layers: int, num_experts: int,
    fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Stack [L, E, ...] from per-layer per-expert keys."""
    per_layer = []
    for i in range(num_layers):
        per_expert = []
        for j in range(num_experts):
            key = template.format(i=i, j=j)
            if key not in sd:
                raise KeyError(f"missing checkpoint key {key!r}")
            per_expert.append(fn(_tensor(sd[key])))
        per_layer.append(torch.stack(per_expert))
    return torch.stack(per_layer)


def _split_phi3_fused(sd: StateDict, cfg: ModelConfig) -> dict[str, Any]:
    """Phi-3 fuses attention into one ``qkv_proj`` (rows: q | k | v) and the
    gated MLP into one ``gate_up_proj`` (rows: gate | up), both [out, in].
    Split them into the separate llama projection names so convert_llama's
    single mapping serves the family."""
    H, KVH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    out = dict(sd)
    for i in range(cfg.num_layers):
        qkv = _tensor(out.pop(f"layers.{i}.self_attn.qkv_proj.weight"))
        q, k, v = torch.split(qkv, [H * HD, KVH * HD, KVH * HD], dim=0)
        out[f"layers.{i}.self_attn.q_proj.weight"] = q
        out[f"layers.{i}.self_attn.k_proj.weight"] = k
        out[f"layers.{i}.self_attn.v_proj.weight"] = v
        gu = _tensor(out.pop(f"layers.{i}.mlp.gate_up_proj.weight"))
        gate, up = torch.chunk(gu, 2, dim=0)
        out[f"layers.{i}.mlp.gate_proj.weight"] = gate
        out[f"layers.{i}.mlp.up_proj.weight"] = up
    return out


def convert_llama(sd: StateDict, cfg: ModelConfig) -> dict[str, Any]:
    """Llama/Llama-3 (and Mistral, Qwen2, Gemma, Phi-3, Mixtral) use
    nn.Linear: stored [out, in] -> transpose.  With cfg.num_experts > 0 the
    MLP mapping follows Mixtral's ``block_sparse_moe`` layout (gate router
    + per-expert w1/w2/w3)."""
    sd = _strip_prefix(sd, ("model.",))
    if "layers.0.self_attn.qkv_proj.weight" in sd:  # Phi-3 fused layout
        sd = _split_phi3_fused(sd, cfg)
    D, H, KVH, HD = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    L = cfg.num_layers
    # Gemma's RMSNorm computes with (1 + weight); fold the +1 into the
    # stored scales so the runtime rms_norm stays one implementation.
    norm_of = (lambda w: w + 1.0) if cfg.norm_plus_one else _same
    attn = {
        "wq": _stack(sd, "layers.{i}.self_attn.q_proj.weight", L,
                     lambda w: _t(w).reshape(D, H, HD)),
        "wk": _stack(sd, "layers.{i}.self_attn.k_proj.weight", L,
                     lambda w: _t(w).reshape(D, KVH, HD)),
        "wv": _stack(sd, "layers.{i}.self_attn.v_proj.weight", L,
                     lambda w: _t(w).reshape(D, KVH, HD)),
        "wo": _stack(sd, "layers.{i}.self_attn.o_proj.weight", L,
                     lambda w: _t(w).reshape(H, HD, D)),
    }
    if cfg.qkv_bias:  # Qwen2: llama layout plus q/k/v biases
        attn.update({
            "bq": _stack(sd, "layers.{i}.self_attn.q_proj.bias", L,
                         lambda b: b.reshape(H, HD)),
            "bk": _stack(sd, "layers.{i}.self_attn.k_proj.bias", L,
                         lambda b: b.reshape(KVH, HD)),
            "bv": _stack(sd, "layers.{i}.self_attn.v_proj.bias", L,
                         lambda b: b.reshape(KVH, HD)),
        })
    if cfg.num_experts > 0:
        # Mixtral: w1 = gate, w3 = up, w2 = down (all [out, in]).
        moe = "layers.{i}.block_sparse_moe."
        mlp = {
            "router": _stack(sd, moe + "gate.weight", L, _t),
            "w_gate": _stack_experts(sd, moe + "experts.{j}.w1.weight", L,
                                     cfg.num_experts, _t),
            "w_up": _stack_experts(sd, moe + "experts.{j}.w3.weight", L,
                                   cfg.num_experts, _t),
            "w_down": _stack_experts(sd, moe + "experts.{j}.w2.weight", L,
                                     cfg.num_experts, _t),
        }
    else:
        mlp = {
            "w_gate": _stack(sd, "layers.{i}.mlp.gate_proj.weight", L, _t),
            "w_up": _stack(sd, "layers.{i}.mlp.up_proj.weight", L, _t),
            "w_down": _stack(sd, "layers.{i}.mlp.down_proj.weight", L, _t),
        }
    params = {
        "embed": {"wte": _tensor(sd["embed_tokens.weight"])},
        "final_norm": {"scale": norm_of(_tensor(sd["norm.weight"]))},
        "blocks": {
            "ln1": {"scale": _stack(sd, "layers.{i}.input_layernorm.weight",
                                    L, norm_of)},
            "ln2": {"scale": _stack(
                sd, "layers.{i}.post_attention_layernorm.weight", L, norm_of)},
            "attn": attn,
            "mlp": mlp,
        },
    }
    if not cfg.tie_embeddings:
        # Some checkpoints tie even when the config says otherwise.
        head = sd.get("lm_head.weight", sd["embed_tokens.weight"])
        params["lm_head"] = {"w": _t(_tensor(head))}
    return params


def convert_opt(sd: StateDict, cfg: ModelConfig) -> dict[str, Any]:
    """OPT (the source system's default model): gpt2-layout blocks with
    separate nn.Linear q/k/v/out projections ([out, in] -> transpose),
    ReLU MLP, and a learned position table carrying HF's offset of 2 —
    kept in the table, applied in models.model.embed.  Covers the pre-LN,
    unprojected-embedding variants (125m and 1.3b+); 350m's
    word_embed_proj_dim and post-LN are rejected in config_from_hf."""
    sd = _strip_prefix(sd, ("model.decoder.", "decoder.", "model."))
    D, H, HD = cfg.hidden_size, cfg.num_heads, cfg.head_dim_
    L = cfg.num_layers

    def w_of(w):  # [D, D] stored [out, in] -> [D(in), H, HD]
        return _t(w).reshape(D, H, HD)

    def b_of(b):  # [D] -> [H, HD]
        return b.reshape(H, HD)

    params = {
        "embed": {
            "wte": _tensor(sd["embed_tokens.weight"]),
            "wpe": _tensor(sd["embed_positions.weight"]),  # rows 0-1 = offset
        },
        "final_norm": {
            "scale": _tensor(sd["final_layer_norm.weight"]),
            "bias": _tensor(sd["final_layer_norm.bias"]),
        },
        "blocks": {
            "ln1": {
                "scale": _stack(sd, "layers.{i}.self_attn_layer_norm.weight",
                                L, _same),
                "bias": _stack(sd, "layers.{i}.self_attn_layer_norm.bias",
                               L, _same),
            },
            "ln2": {
                "scale": _stack(sd, "layers.{i}.final_layer_norm.weight", L,
                                _same),
                "bias": _stack(sd, "layers.{i}.final_layer_norm.bias", L,
                               _same),
            },
            "attn": {
                "wq": _stack(sd, "layers.{i}.self_attn.q_proj.weight", L, w_of),
                "wk": _stack(sd, "layers.{i}.self_attn.k_proj.weight", L, w_of),
                "wv": _stack(sd, "layers.{i}.self_attn.v_proj.weight", L, w_of),
                "bq": _stack(sd, "layers.{i}.self_attn.q_proj.bias", L, b_of),
                "bk": _stack(sd, "layers.{i}.self_attn.k_proj.bias", L, b_of),
                "bv": _stack(sd, "layers.{i}.self_attn.v_proj.bias", L, b_of),
                "wo": _stack(sd, "layers.{i}.self_attn.out_proj.weight", L,
                             lambda w: _t(w).reshape(H, HD, D)),
                "bo": _stack(sd, "layers.{i}.self_attn.out_proj.bias", L,
                             _same),
            },
            "mlp": {
                "w_in": _stack(sd, "layers.{i}.fc1.weight", L, _t),
                "b_in": _stack(sd, "layers.{i}.fc1.bias", L, _same),
                "w_out": _stack(sd, "layers.{i}.fc2.weight", L, _t),
                "b_out": _stack(sd, "layers.{i}.fc2.bias", L, _same),
            },
        },
    }
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight", sd["embed_tokens.weight"])
        params["lm_head"] = {"w": _t(_tensor(head))}
    return params


def convert_neox(sd: StateDict, cfg: ModelConfig) -> dict[str, Any]:
    """GPT-NeoX/Pythia: fused ``query_key_value`` is INTERLEAVED PER HEAD —
    torch weight [(H*3*HD), D] reshapes to (H, 3, HD, D) with q/k/v adjacent
    within each head, unlike Phi-3's q|k|v block layout.  nn.Linear
    weights are [out, in] -> transpose."""
    sd = _strip_prefix(sd, ("gpt_neox.",))
    D, H, HD = cfg.hidden_size, cfg.num_heads, cfg.head_dim_
    L = cfg.num_layers
    if cfg.num_kv_heads != H:
        raise ValueError("neox is multi-head only (num_kv_heads == num_heads)")

    def qkv_w(which):  # [(H*3*HD), D] -> [D, H, HD]
        return lambda w: w.reshape(H, 3, HD, D)[:, which].permute(2, 0, 1)

    def qkv_b(which):  # [(H*3*HD)] -> [H, HD]
        return lambda b: b.reshape(H, 3, HD)[:, which]

    fused = "layers.{i}.attention.query_key_value."
    return {
        "embed": {"wte": _tensor(sd["embed_in.weight"])},
        "final_norm": {
            "scale": _tensor(sd["final_layer_norm.weight"]),
            "bias": _tensor(sd["final_layer_norm.bias"]),
        },
        "blocks": {
            "ln1": {"scale": _stack(sd, "layers.{i}.input_layernorm.weight",
                                    L, _same),
                    "bias": _stack(sd, "layers.{i}.input_layernorm.bias",
                                   L, _same)},
            "ln2": {"scale": _stack(
                        sd, "layers.{i}.post_attention_layernorm.weight", L,
                        _same),
                    "bias": _stack(
                        sd, "layers.{i}.post_attention_layernorm.bias", L,
                        _same)},
            "attn": {
                "wq": _stack(sd, fused + "weight", L, qkv_w(0)),
                "wk": _stack(sd, fused + "weight", L, qkv_w(1)),
                "wv": _stack(sd, fused + "weight", L, qkv_w(2)),
                "bq": _stack(sd, fused + "bias", L, qkv_b(0)),
                "bk": _stack(sd, fused + "bias", L, qkv_b(1)),
                "bv": _stack(sd, fused + "bias", L, qkv_b(2)),
                "wo": _stack(sd, "layers.{i}.attention.dense.weight", L,
                             lambda w: _t(w).reshape(H, HD, D)),
                "bo": _stack(sd, "layers.{i}.attention.dense.bias", L, _same),
            },
            "mlp": {
                "w_in": _stack(sd, "layers.{i}.mlp.dense_h_to_4h.weight", L,
                               _t),
                "b_in": _stack(sd, "layers.{i}.mlp.dense_h_to_4h.bias", L,
                               _same),
                "w_out": _stack(sd, "layers.{i}.mlp.dense_4h_to_h.weight", L,
                                _t),
                "b_out": _stack(sd, "layers.{i}.mlp.dense_4h_to_h.bias", L,
                                _same),
            },
        },
        "lm_head": {"w": _t(_tensor(sd["embed_out.weight"]))},
    }


CONVERTERS: dict[str, Callable[[StateDict, ModelConfig], dict[str, Any]]] = {
    "gpt2": convert_gpt2,
    "opt": convert_opt,
    "llama": convert_llama,
    "neox": convert_neox,
}


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype).contiguous()


def convert_state_dict(sd: StateDict, cfg: ModelConfig,
                       dtype: Any = None) -> dict[str, Any]:
    """A HF state dict (tensors or numpy arrays) -> the stacked parameter
    tree as contiguous host tensors in ``dtype`` (default ``cfg.dtype``)."""
    from ..models.model import torch_dtype

    if cfg.family not in CONVERTERS:
        raise ValueError(f"no converter for family {cfg.family!r}")
    target = dtype if isinstance(dtype, torch.dtype) else torch_dtype(
        dtype or cfg.dtype)
    return _cast(CONVERTERS[cfg.family](sd, cfg), target)


def _gelu_relu_activation(name: str, what: str) -> str:
    """Map HF activation names onto layers.mlp_gelu's (HF 'gelu' is the
    exact erf form; 'gelu_new'/'gelu_fast' the tanh approximation) — shared
    by the OPT and NeoX config branches so the alias table lives once."""
    table = {"relu": "relu", "gelu": "gelu_exact", "gelu_new": "gelu",
             "gelu_fast": "gelu"}
    if name not in table:
        raise ValueError(f"unsupported {what} {name!r}")
    return table[name]


def _opt_activation(name: str) -> str:
    return _gelu_relu_activation(name, "OPT activation_function")


def config_from_hf(hf_config: Mapping[str, Any]) -> ModelConfig:
    """Build a ModelConfig from a HF config.json dict (gpt2, opt, neox, or
    llama-like: llama, mistral, mixtral, qwen2, gemma, phi3)."""
    arch = (hf_config.get("architectures") or [""])[0].lower()
    model_type = hf_config.get("model_type", "")
    if model_type == "gpt2" or "gpt2" in arch:
        return ModelConfig(
            family="gpt2",
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["n_embd"],
            intermediate_size=hf_config.get("n_inner") or 4 * hf_config["n_embd"],
            num_layers=hf_config["n_layer"],
            num_heads=hf_config["n_head"],
            num_kv_heads=hf_config["n_head"],
            max_seq_len=hf_config["n_positions"],
            norm_eps=hf_config.get("layer_norm_epsilon", 1e-5),
            tie_embeddings=True,
        )
    if model_type == "opt" or "optfor" in arch:
        hidden = hf_config["hidden_size"]
        if not hf_config.get("do_layer_norm_before", True):
            raise ValueError(
                "OPT variant with do_layer_norm_before=False (350m-style "
                "post-LN) is not supported"
            )
        if hf_config.get("word_embed_proj_dim", hidden) != hidden:
            raise ValueError(
                "OPT variant with word_embed_proj_dim != hidden_size "
                "(350m-style embedding projection) is not supported"
            )
        return ModelConfig(
            family="opt",
            vocab_size=hf_config["vocab_size"],
            hidden_size=hidden,
            intermediate_size=hf_config["ffn_dim"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config["num_attention_heads"],
            max_seq_len=hf_config["max_position_embeddings"],
            norm_eps=1e-5,  # torch LayerNorm default; OPTConfig has no knob
            tie_embeddings=hf_config.get("tie_word_embeddings", True),
            # HF "gelu" is the exact erf form; "gelu_new" the tanh approx.
            # Anything else is rejected rather than silently approximated.
            activation=_opt_activation(hf_config.get("activation_function", "relu")),
        )
    if model_type == "qwen2" or "qwen2for" in arch:
        # Qwen2 = llama layout + q/k/v biases.  A config that enables
        # sliding-window attention is rejected rather than silently
        # attending globally.
        if hf_config.get("use_sliding_window", False):
            raise ValueError(
                "Qwen2 with use_sliding_window=True is not supported "
                "(global attention only)"
            )
        if hf_config.get("rope_scaling"):
            raise ValueError(
                "qwen2 rope_scaling is not supported (plain RoPE only)"
            )
        return ModelConfig(
            family="llama",
            qkv_bias=True,
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get(
                "num_key_value_heads", hf_config["num_attention_heads"]
            ),
            max_seq_len=hf_config.get("max_position_embeddings", 32768),
            rope_theta=hf_config.get("rope_theta", 1e6),
            norm_eps=hf_config.get("rms_norm_eps", 1e-6),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
        )
    if model_type == "gemma" or "gemmafor" in arch:
        # Gemma-1 = llama layout with GeGLU, (1+w) RMSNorm (folded at
        # convert), sqrt(hidden) embedding scale, explicit head_dim, tied
        # embeddings.  Gemma-2 (model_type "gemma2") is a different
        # architecture and falls through to the ValueError below.
        if hf_config.get("rope_scaling"):
            raise ValueError(
                "gemma rope_scaling is not supported (plain RoPE only)"
            )
        act = hf_config.get("hidden_activation") or hf_config.get("hidden_act")
        if act not in (None, "gelu_pytorch_tanh"):
            raise ValueError(
                f"gemma hidden_activation {act!r} is not supported "
                "(gelu_pytorch_tanh only)"
            )
        hidden = hf_config["hidden_size"]
        return ModelConfig(
            family="llama",
            gate_act="gelu_tanh",
            qkv_bias=bool(hf_config.get("attention_bias", False)),
            norm_plus_one=True,
            embed_scale=float(hidden) ** 0.5,
            vocab_size=hf_config["vocab_size"],
            hidden_size=hidden,
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get(
                "num_key_value_heads", hf_config["num_attention_heads"]
            ),
            head_dim=hf_config.get("head_dim"),
            max_seq_len=hf_config.get("max_position_embeddings", 8192),
            rope_theta=hf_config.get("rope_theta", 10000.0),
            norm_eps=hf_config.get("rms_norm_eps", 1e-6),
            tie_embeddings=hf_config.get("tie_word_embeddings", True),
        )
    if model_type == "mistral" or "mistralfor" in arch:
        # Mistral = llama layout (identical weight names) + sliding-window
        # attention.  v0.1 ships window 4096; v0.2+ set sliding_window null
        # (global attention).  window >= max_position_embeddings is global
        # causal: keep None there so the mask stays the cheap one.
        if hf_config.get("rope_scaling"):
            raise ValueError(
                "mistral rope_scaling is not supported (plain RoPE only)"
            )
        window = hf_config.get("sliding_window")
        max_len = hf_config.get("max_position_embeddings", 32768)
        if window is not None and window >= max_len:
            window = None
        return ModelConfig(
            family="llama",
            sliding_window=window,
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get(
                "num_key_value_heads", hf_config["num_attention_heads"]
            ),
            head_dim=hf_config.get("head_dim"),
            max_seq_len=max_len,
            rope_theta=hf_config.get("rope_theta", 10000.0),
            norm_eps=hf_config.get("rms_norm_eps", 1e-5),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
        )
    if model_type == "gpt_neox" or "gptneoxfor" in arch:
        # GPT-NeoX / Pythia: LayerNorm + partial rotary + parallel residual
        # (models.model's neox block, convert_neox).
        if hf_config.get("tie_word_embeddings", False):
            # The neox model is untied (embed_out); a tied checkpoint would
            # carry a dead lm_head tensor on the device.
            raise ValueError("tied-embedding gpt_neox is not supported")
        if hf_config.get("rope_scaling"):
            raise ValueError(
                "gpt_neox rope_scaling is not supported (plain rotary only)"
            )
        if hf_config.get("attention_bias", True) is False:
            raise ValueError("gpt_neox without attention biases unsupported")
        return ModelConfig(
            family="neox",
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config["num_attention_heads"],
            max_seq_len=hf_config.get("max_position_embeddings", 2048),
            rope_theta=float(hf_config.get("rotary_emb_base", 10000)),
            rotary_pct=float(hf_config.get("rotary_pct", 1.0)),
            parallel_residual=bool(
                hf_config.get("use_parallel_residual", True)
            ),
            norm_eps=hf_config.get("layer_norm_eps", 1e-5),
            tie_embeddings=False,
            activation=_gelu_relu_activation(
                hf_config.get("hidden_act", "gelu"), "neox hidden_act"
            ),
        )
    if model_type == "phi3" or "phi3for" in arch:
        # Phi-3 = llama layout with fused qkv/gate_up projections (split at
        # convert) + sliding-window attention.  The 128k "longrope"
        # variants carry rope_scaling, another position scheme: rejected.
        if hf_config.get("rope_scaling"):
            raise ValueError(
                "phi3 rope_scaling (longrope 128k variants) is not supported"
            )
        pr = hf_config.get("partial_rotary_factor", 1.0) or 1.0
        if pr != 1.0:
            raise ValueError(
                f"phi3 partial_rotary_factor {pr} is not supported (full "
                "rotary only)"
            )
        window = hf_config.get("sliding_window")
        max_len = hf_config.get("max_position_embeddings", 4096)
        if window is not None and window >= max_len:
            window = None
        return ModelConfig(
            family="llama",
            sliding_window=window,
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get(
                "num_key_value_heads", hf_config["num_attention_heads"]
            ),
            max_seq_len=max_len,
            rope_theta=hf_config.get("rope_theta", 10000.0),
            norm_eps=hf_config.get("rms_norm_eps", 1e-5),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
        )
    if model_type in ("llama", "mixtral") or "llama" in arch or "mixtral" in arch:
        rs = hf_config.get("rope_scaling") or {}
        rope_kw = {}
        if rs:
            # Llama-3.1/3.2's "llama3" frequency rescale is implemented
            # (models/layers.rope_frequencies); any other scheme (linear,
            # dynamic NTK, yarn) would silently serve wrong positions.
            rtype = rs.get("rope_type") or rs.get("type")
            if rtype != "llama3":
                raise ValueError(
                    f"unsupported rope_scaling type {rtype!r} "
                    "(llama3 only)"
                )
            if "factor" not in rs:
                raise ValueError("llama3 rope_scaling needs a 'factor'")
            low = float(rs.get("low_freq_factor", 1.0))
            high = float(rs.get("high_freq_factor", 4.0))
            if high <= low:
                # The smooth band divides by (high - low): equal factors
                # would serve NaN frequencies, inverted ones a reversed ramp.
                raise ValueError(
                    f"llama3 rope_scaling needs high_freq_factor ({high}) "
                    f"> low_freq_factor ({low})"
                )
            rope_kw = dict(
                rope_scaling_factor=float(rs["factor"]),
                rope_low_freq_factor=low,
                rope_high_freq_factor=high,
                rope_original_max_len=int(
                    rs.get("original_max_position_embeddings", 8192)
                ),
            )
        return ModelConfig(
            family="llama",
            **rope_kw,
            # Fine-tunes sometimes enable projection biases on the llama
            # architecture; dropping them would give wrong logits.
            qkv_bias=bool(hf_config.get("attention_bias", False)),
            vocab_size=hf_config["vocab_size"],
            hidden_size=hf_config["hidden_size"],
            intermediate_size=hf_config["intermediate_size"],
            num_layers=hf_config["num_hidden_layers"],
            num_heads=hf_config["num_attention_heads"],
            num_kv_heads=hf_config.get("num_key_value_heads", hf_config["num_attention_heads"]),
            max_seq_len=hf_config.get("max_position_embeddings", 4096),
            rope_theta=hf_config.get("rope_theta", 10000.0),
            norm_eps=hf_config.get("rms_norm_eps", 1e-5),
            tie_embeddings=hf_config.get("tie_word_embeddings", False),
            # Mixtral MoE knobs (0 experts -> dense llama).
            num_experts=hf_config.get("num_local_experts", 0) or 0,
            num_experts_per_token=hf_config.get("num_experts_per_tok", 2) or 2,
        )
    raise ValueError(f"unsupported HF model_type {model_type!r}")
