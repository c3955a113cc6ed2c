"""Named model presets covering the BASELINE.json ladder configs
(GPT-2-125M -> TinyLlama-1.1B -> Llama-2-7B -> Llama-2-13B -> Llama-3-70B)
plus tiny variants for tests.  Replaces the reference's single hard-coded
model id (run_master.py:17, "facebook/opt-125m")."""

from __future__ import annotations

from dataclasses import replace

from ..core.config import ModelConfig

PRESETS: dict[str, ModelConfig] = {
    "gpt2-125m": ModelConfig(
        family="gpt2", vocab_size=50257, hidden_size=768, intermediate_size=3072,
        num_layers=12, num_heads=12, num_kv_heads=12, max_seq_len=1024,
        norm_eps=1e-5, tie_embeddings=True,
    ),
    "gpt2-medium": ModelConfig(
        family="gpt2", vocab_size=50257, hidden_size=1024, intermediate_size=4096,
        num_layers=24, num_heads=16, num_kv_heads=16, max_seq_len=1024,
        norm_eps=1e-5, tie_embeddings=True,
    ),
    # The reference's default model (run_master.py:17).
    "opt-125m": ModelConfig(
        family="opt", vocab_size=50272, hidden_size=768, intermediate_size=3072,
        num_layers=12, num_heads=12, num_kv_heads=12, max_seq_len=2048,
        norm_eps=1e-5, tie_embeddings=True, activation="relu",
    ),
    "tinyllama-1.1b": ModelConfig(
        family="llama", vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, max_seq_len=2048,
        rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=False,
    ),
    "llama-2-7b": ModelConfig(
        family="llama", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=4096,
        rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=False,
    ),
    "llama-2-13b": ModelConfig(
        family="llama", vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_layers=40, num_heads=40, num_kv_heads=40, max_seq_len=4096,
        rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=False,
    ),
    "llama-3-8b": ModelConfig(
        family="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
        rope_theta=500000.0, norm_eps=1e-5, tie_embeddings=False,
    ),
    "llama-3.1-8b": ModelConfig(
        family="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=131072,
        rope_theta=500000.0, norm_eps=1e-5, tie_embeddings=False,
        rope_scaling_factor=8.0, rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0, rope_original_max_len=8192,
    ),
    "llama-3-70b": ModelConfig(
        family="llama", vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, max_seq_len=8192,
        rope_theta=500000.0, norm_eps=1e-5, tie_embeddings=False,
    ),
    "qwen2-7b": ModelConfig(
        family="llama", qkv_bias=True, vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        max_seq_len=32768, rope_theta=1e6, norm_eps=1e-6, tie_embeddings=False,
    ),
    "gemma-7b": ModelConfig(
        family="llama", gate_act="gelu_tanh", norm_plus_one=True,
        embed_scale=3072.0**0.5, vocab_size=256000, hidden_size=3072,
        intermediate_size=24576, num_layers=28, num_heads=16, num_kv_heads=16,
        head_dim=256, max_seq_len=8192, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True,
    ),
    "phi-3-mini-4k": ModelConfig(
        family="llama", sliding_window=2047, vocab_size=32064,
        hidden_size=3072, intermediate_size=8192, num_layers=32,
        num_heads=32, num_kv_heads=32, max_seq_len=4096,
        rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=False,
    ),
    "mistral-7b": ModelConfig(
        family="llama", sliding_window=4096, vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        max_seq_len=32768, rope_theta=10000.0, norm_eps=1e-5,
        tie_embeddings=False,
    ),
    "pythia-6.9b": ModelConfig(
        family="neox", vocab_size=50432, hidden_size=4096,
        intermediate_size=16384, num_layers=32, num_heads=32,
        num_kv_heads=32, max_seq_len=2048, rope_theta=10000.0,
        rotary_pct=0.25, parallel_residual=True, norm_eps=1e-5,
        tie_embeddings=False, activation="gelu_exact",
    ),
    "mixtral-8x7b": ModelConfig(
        family="llama", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=32768,
        rope_theta=1e6, norm_eps=1e-5, tie_embeddings=False,
        num_experts=8, num_experts_per_token=2,
    ),
    # Tiny configs for unit tests / CPU fake-mesh integration tests.
    "moe-tiny": ModelConfig(
        family="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
        tie_embeddings=False, dtype="float32",
        num_experts=4, num_experts_per_token=2,
    ),
    "gpt2-tiny": ModelConfig(
        family="gpt2", vocab_size=256, hidden_size=64, intermediate_size=256,
        num_layers=4, num_heads=4, num_kv_heads=4, max_seq_len=128,
        tie_embeddings=True, dtype="float32",
    ),
    "opt-tiny": ModelConfig(
        family="opt", vocab_size=256, hidden_size=64, intermediate_size=256,
        num_layers=4, num_heads=4, num_kv_heads=4, max_seq_len=128,
        tie_embeddings=True, dtype="float32", activation="relu",
    ),
    "neox-tiny": ModelConfig(
        family="neox", vocab_size=256, hidden_size=64, intermediate_size=176,
        num_layers=3, num_heads=4, num_kv_heads=4, max_seq_len=128,
        rotary_pct=0.25, parallel_residual=True, tie_embeddings=False,
        dtype="float32", activation="gelu_exact",
    ),
    "llama-tiny": ModelConfig(
        family="llama", vocab_size=256, hidden_size=64, intermediate_size=176,
        num_layers=4, num_heads=4, num_kv_heads=2, max_seq_len=128,
        tie_embeddings=False, dtype="float32",
    ),
}

# HF hub repo ids for the checkpoint converter.
HF_REPOS: dict[str, str] = {
    "gpt2-125m": "gpt2",
    "gpt2-medium": "gpt2-medium",
    "opt-125m": "facebook/opt-125m",
    "tinyllama-1.1b": "TinyLlama/TinyLlama-1.1B-Chat-v1.0",
    "llama-2-7b": "meta-llama/Llama-2-7b-hf",
    "llama-2-13b": "meta-llama/Llama-2-13b-hf",
    "llama-3-8b": "meta-llama/Meta-Llama-3-8B",
    "llama-3.1-8b": "meta-llama/Llama-3.1-8B",
    "llama-3-70b": "meta-llama/Meta-Llama-3-70B",
    "qwen2-7b": "Qwen/Qwen2-7B",
    "gemma-7b": "google/gemma-7b",
    "mistral-7b": "mistralai/Mistral-7B-v0.1",
    "phi-3-mini-4k": "microsoft/Phi-3-mini-4k-instruct",
    "pythia-6.9b": "EleutherAI/pythia-6.9b",
}


def get_preset(name: str, **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg
