"""Typed configuration system (PyTorch/CUDA port).

The port's own copy of ``distributed_llms_tpu/core/config.py``: the same
dataclass tree and the same JSON/YAML + ``key=value`` loader, so one config
file drives either stack.  The port never imports the JAX package, so it
keeps this copy instead of sharing the module.  Knobs that name later port
slices (contiguous mode, chunked prefill, int8 KV, the host tier,
speculative decoding, tenants, ...) parse here and are refused with
``NotImplementedError`` by the runtime that would have to honor them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

try:  # yaml is available in the image; gate anyway.
    import yaml

    _HAVE_YAML = True
except Exception:  # pragma: no cover
    _HAVE_YAML = False


_ATTN_IMPLS = {"dot", "ring", "flash", "ulysses"}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only transformer.

    One dataclass covers every supported family (GPT-2, OPT, TinyLlama,
    Llama-2, Llama-3, Mixtral); ``family`` selects the block flavour
    (LayerNorm+learned-pos vs RMSNorm+RoPE+GQA).  "opt" is the gpt2 layout
    with separate q/k/v projections folded in conversion, a ReLU MLP, and
    HF OPT's position-table offset of 2 — the reference's own default model
    (run_master.py:17, facebook/opt-125m).
    """

    family: str = "gpt2"  # "gpt2" | "opt" | "llama" | "neox"
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12  # < num_heads => grouped-query attention
    head_dim: int | None = None  # default hidden_size // num_heads
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    # Llama-3.1-style rope scaling ("rope_type": "llama3"): piecewise
    # frequency rescale that stretches low-frequency (long-wavelength)
    # components by `factor` while keeping high-frequency ones, with a
    # smooth ramp between — how 3.1/3.2 extend 8k-trained RoPE to 128k.
    # factor == 1.0 disables (plain RoPE).  Other HF rope_type values
    # (linear, dynamic, yarn, longrope) are rejected at convert.
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    # GPT-NeoX/Pythia: rotate only the first rotary_pct of each head's dims
    # (partial rotary); the rest pass through position-free.
    rotary_pct: float = 1.0
    # GPT-NeoX/Pythia parallel residual: x + attn(ln1 x) + mlp(ln2 x)
    # (HF use_parallel_residual; False = sequential pre-LN like GPT-2).
    parallel_residual: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # MLP activation for the gpt2-layout families ("gelu" for GPT-2, "relu"
    # for OPT); the llama family is SwiGLU regardless.
    activation: str = "gelu"
    # Attention implementation: "dot" (XLA-fused), "flash" (Pallas fused
    # blockwise kernel, ops/flash.py: prefill and training forwards use it —
    # note the backward recomputes attention densely at O(T^2) memory —
    # while single-token decode falls back to dot), "ring" (sequence-parallel
    # ppermute ring over the 'seq' mesh axis; prefill/training only), or
    # "ulysses" (sequence-parallel all-to-all head scatter over 'seq';
    # needs num_heads and num_kv_heads divisible by the seq axis).
    attn_impl: str = "dot"
    # Llama-layout blocks with q/k/v projection biases (Qwen2's one
    # architectural delta from Llama); gpt2/opt layouts always carry theirs.
    qkv_bias: bool = False
    # Gated-MLP activation for the llama family: "silu" (Llama/Qwen2) or
    # "gelu_tanh" (Gemma's GeGLU).  MoE blocks stay silu (Mixtral).
    gate_act: str = "silu"
    # Embedding multiplier applied after lookup (Gemma: sqrt(hidden_size)).
    embed_scale: float = 1.0
    # CONVERTER-ONLY flag: the checkpoint's RMSNorm computes with
    # (1 + weight) (Gemma); convert folds the +1 into the stored scales so
    # the runtime rms_norm stays unchanged.  Random init (ones) is already
    # the folded identity.
    norm_plus_one: bool = False
    # Ragged single-token decode attention (ops/decode_attn.py): row b reads
    # only its cache prefix [0, cache_index[b]] instead of the full width S.
    # Opt-in CONTRACT flag, not just a speed knob: setting it asserts the
    # caller's attn_mask on the per-row-cache_index decode path is exactly
    # that prefix mask (the ContinuousBatcher's is; arbitrary masks are not).
    ragged_decode: bool = False
    # Sliding-window attention (Mistral): query at position p attends keys in
    # (p - window, p].  None = global causal.  Enforced via masks on the dot
    # paths; the flash and ragged-decode kernels carry the window natively
    # (flash skips out-of-window tiles without DMAing them; ragged decode
    # reads only each row's window span).  The paged decode kernel and the
    # seq-parallel impls reject it (full-prefix / global-causal by
    # construction).  The KV cache keeps max_seq_len slots (no rolling
    # buffer yet) — masking is what bounds the attention span, not cache
    # size.
    sliding_window: int | None = None

    def __post_init__(self):
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r}; choose from {sorted(_ATTN_IMPLS)}"
            )
        if self.gate_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"unknown gate_act {self.gate_act!r}; choose silu or gelu_tanh"
            )
        if self.gate_act != "silu" and self.num_experts > 0:
            # moe_swiglu hardcodes silu (Mixtral); accepting another
            # activation here would silently ignore it.
            raise ValueError("MoE blocks support gate_act='silu' only")
        if not 0.0 < self.rotary_pct <= 1.0:
            raise ValueError(
                f"rotary_pct must be in (0, 1], got {self.rotary_pct}"
            )
        if self.rotary_pct < 1.0:
            rot = int(self.head_dim_ * self.rotary_pct)
            if rot < 2 or rot % 2:
                raise ValueError(
                    f"rotary_pct {self.rotary_pct} of head_dim "
                    f"{self.head_dim_} gives {rot} rotary dims; need an "
                    "even count >= 2"
                )
        if self.sliding_window is not None:
            if self.sliding_window < 1:
                raise ValueError(
                    f"sliding_window must be >= 1, got {self.sliding_window}"
                )
            if self.attn_impl in ("ring", "ulysses"):
                # The seq-parallel impls attend the full (causal) global
                # sequence; silently ignoring the window would be wrong
                # numerics for any prompt longer than it.
                raise ValueError(
                    "sliding_window is not supported with ring/ulysses "
                    "sequence parallelism (global causal attention only)"
                )
            # ragged_decode composes: the kernel takes a window bound and
            # reads only [length - window, length) per row — exact for the
            # contract layout (slot == position), which is the same layout
            # the ragged contract already demands.
    # MoE (expert parallelism); num_experts == 0 -> dense MLP.
    num_experts: int = 0
    num_experts_per_token: int = 2
    # Per-expert buffer = capacity_factor * k * tokens / num_experts; tokens
    # routed past a full expert are dropped (standard GShard semantics).
    moe_capacity_factor: float = 1.25
    # Weight of the Switch-style load-balance aux loss added by lm_loss.
    moe_aux_loss_weight: float = 0.02

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh.  Axes follow the scaling-book convention:

    - ``data``:  batch sharding (data parallelism)
    - ``pipe``:  pipeline stages (the reference's layer-sharding, done right)
    - ``model``: tensor parallelism (attention heads / MLP hidden)
    - ``seq``:   sequence/context parallelism (ring attention)
    - ``expert``: expert parallelism for MoE layers
    """

    data: int = 1
    pipe: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("data", "pipe", "model", "seq", "expert")

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.pipe, self.model, self.seq, self.expert)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class RuntimeConfig:
    """Serving/runtime knobs (decode loop, KV cache, microbatching)."""

    max_seq_len: int = 1024
    max_decode_steps: int = 64
    microbatches: int = 1  # pipeline microbatches per step
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0
    kv_cache_dtype: str = "bfloat16"
    # Session KV residency: with kv_host_spill, at most max_resident_sessions
    # session caches stay in HBM; least-recently-used ones spill to host DRAM
    # and are restored (async device_put) on their next turn.
    kv_host_spill: bool = False
    max_resident_sessions: int = 4
    # Weight-only quantized serving: keep an int8/int4 store's decoder-block
    # weights quantized in device memory; the blockwise dequant fuses into
    # each layer's matmuls (halves/quarters weight HBM + read bandwidth).
    serve_quantized: bool = False
    remat: bool = False  # jax.checkpoint on decoder blocks
    seed: int = 0
    profile_dir: str | None = None  # capture jax.profiler traces of generate
    # Persistent compilation cache of the JAX package: a serving process
    # restarted on the same model skips its first-compile wait.  Parsed so
    # one config file drives either stack; the port runs eagerly and
    # compiles no graph.
    compilation_cache_dir: str | None = None
    # Paged KV cache for continuous batching (runtime/batcher.py): rows
    # allocate pages from a shared pool instead of owning max_seq_len slots;
    # a dry pool back-pressures admission.  None = contiguous per-slot KV.
    paged_pages: int | None = None
    page_size: int = 64
    # Automatic prefix caching over the paged pool (runtime/batcher.py
    # PrefixCache): full prompt pages are content-hashed and shared
    # copy-free across rows (refcounted; LRU eviction under pool
    # pressure), so repeated prompt prefixes — system prompts, few-shot
    # templates, multi-turn history — prefill only their un-cached
    # suffix.  Requires paged_pages; ignored (with a warning) otherwise.
    prefix_cache: bool = False
    # KV memory tiering (runtime/batcher.py, paged mode only):
    # kv_bits=8 stores pool pages as int8 with blockwise absmax scales —
    # roughly half the KV bytes per token, so ~1.9x concurrent rows per
    # pool byte; dequant fuses into the decode-attention read and greedy
    # outputs are parity-bounded (not bit-exact) vs bf16 pages.  16 = the
    # full-width kv_cache_dtype pool.
    kv_bits: int = 16
    # Host-RAM tier behind the paged pool, in pages: preemption SWAPS
    # victim rows out (byte-exact restore instead of prefix recompute;
    # exact-recompute fallback when the budget is dry) and cold
    # prefix-cache pages spill there before LRU eviction (a later hit
    # restores instead of re-prefilling).  0 disables.
    host_pages: int = 0
    # Dispatch-ahead engine loop: while no scheduling work is pending,
    # decode chunk N+1 dispatches from chunk N's device-resident carry
    # and chunk N's host work (token copy, delivery, digest hashing,
    # metrics) runs while N+1 executes.  Temp-0 outputs are identical to
    # the synchronous loop (overlap=False).
    overlap: bool = True
    # Scheduling policy (runtime/scheduler.py): "mixed" (default) fuses
    # pending prefill-chunk bites into the decode step as one compiled
    # token-budget program, so resident decode rows never stall for a
    # serialized prefill forward and the dispatch-ahead span keeps
    # running while a long prompt admits; "alternate" keeps the classic
    # serialized prefill_chunk_step rounds.  Temp-0 token streams are
    # byte-identical either way — this is a latency knob, not a
    # semantics knob.
    schedule: str = "mixed"
    # Per-step token budget the mixed policy sizes prefill bites
    # against: each fused step runs one decode leg per active slot plus
    # up to token_budget - n_active prompt tokens of the head pending
    # prefill.  Set, it also auto-chunks any prompt longer than the
    # budget even when prefill_chunk was never configured.  None/0 =
    # prefill_chunk-sized bites (fusion without re-budgeting).
    token_budget: int | None = None
    # Speculative decoding (runtime/speculative.py).  With spec_decode=True
    # on a single-device full-precision engine, generate_text transparently
    # routes greedy requests through the speculative loop (results are
    # bit-identical by construction — the draft only changes speed); the
    # draft is the engine's own blocks weight-only quantized to
    # spec_draft_quantize bits (self-speculation).  temperature > 0 and
    # mesh engines fall back to the plain decode loop.
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft_quantize: int = 4
    # Adaptive spec_k downshift (greedy engines, schedule=mixed): per-row
    # acceptance-rate EMAs feed the scheduler's spec_round_k hook, which
    # clamps each row's COMMITTED tokens per round against the per-step
    # token budget.  The clamp is a ledger bound (a round never commits
    # more than the budget; cancel/deadline checks run at bounded
    # intervals) — the compiled round's device work is CONSTANT by design
    # (full k-draft + (k+1)-token verify, one compile key), so the clamp
    # trades commit granularity, never flops.  Streams stay byte-exact at
    # any clamp (the forced stop emits the target's own token); only
    # arrival granularity changes.
    spec_adaptive_k: bool = True
    # Deterministic fault injection (runtime/faults.py): a comma-separated
    # spec like "batcher.decode:raise@3,proto.send/HEARTBEAT:drop@1+".
    # Engine/batcher hot paths and the cluster protocol framing consult the
    # parsed FaultPlane; the serving supervisor's restart/re-admit path is
    # what this exists to exercise.  None disables.
    faults: str | None = None
    # Default per-request wall-clock deadline (seconds) applied by the
    # serving gateway when a request carries no "timeout_s" field of its
    # own.  An expired request cancels at the next chunk boundary and
    # returns finish_reason "timeout" with the tokens produced so far; one
    # that expires while still QUEUED is shed with 503 + Retry-After.
    # None = no default deadline.
    request_timeout_s: float | None = None
    # Estimated-cost admission gate (runtime/server.py): new requests 429
    # (with Retry-After) once queued + resident token mass exceeds this
    # multiple of the batcher's KV capacity — sustained overload sheds at
    # the front door instead of queueing work doomed to time out.
    # None/0 disables the gate.
    shed_cost_factor: float | None = 2.0
    # Grammar-constrained structured output (runtime/constrain.py): the
    # serving gateway's response_format={"type": "json_schema"|"regex"}
    # fields plus the logit_bias / banned_tokens ride-alongs.  False
    # answers every constrained request 400 (operator kill-switch —
    # automaton compiles are host CPU work an adversarial schema could
    # lean on).
    constrained_decoding: bool = True
    # LRU capacity of the compiled (constraint, tokenizer) -> token-mask
    # automaton cache: each entry holds two [n_states, vocab] tables, so
    # the capacity bounds host RAM spent on remembered schemas.
    constrain_cache_size: int = 64
    # Multi-tenant QoS (runtime/scheduler.py TenantScheduler + the
    # serving gateway's per-tenant quota gate).  tenant_weights turns on
    # weighted-fair admission: "gold:4,free:1"-style shares ("*" sets
    # the default weight unknown/anonymous tenants serve at), billed via
    # per-tenant virtual token counters — a tenant flooding the queue
    # advances its own counter and cannot crowd out a lighter tenant's
    # share.  None/"" = tenant-blind scheduling.
    tenant_weights: str | None = None
    # Per-tenant token-RATE quota at the serving gateway: admitted token
    # mass (prompt + budget) per second, PER UNIT WEIGHT — a tenant over
    # its rate sheds 429 with a per-tenant Retry-After before any
    # admission state exists.  None/0 disables rate quotas.
    tenant_quota_tps: float | None = None
    # Per-tenant RESIDENT-row cap in the batcher: a tenant at the cap
    # defers admission (others admit past it), so one tenant can never
    # hold every batch slot.  None/0 = uncapped.
    tenant_max_rows: int | None = None


@dataclass(frozen=True)
class ClusterConfig:
    """Control-plane knobs.  Replaces the reference's hard-coded ports and
    timers (src/master/node.py:15, src/worker/node.py:35,273)."""

    coordinator_host: str = "0.0.0.0"
    coordinator_port: int = 65432
    heartbeat_interval_s: float = 5.0
    heartbeat_timeout_s: float = 15.0  # deadline eviction (reference never evicts, D10)
    connect_retry_s: float = 5.0
    connect_max_retries: int = 5
    task_timeout_s: float = 60.0
    # Prometheus /metrics + /healthz + /status HTTP port on the coordinator
    # (implementation.md:34-37 parity). None disables; 0 binds ephemeral.
    metrics_port: int | None = None
    # jax.distributed settings for multi-host slices
    distributed_coordinator: str | None = None
    num_processes: int = 1
    process_id: int = 0


@dataclass(frozen=True)
class CheckpointConfig:
    """Shard-store / conversion knobs (successor of shard_info.json,
    src/model/shard_manager.py:63-74)."""

    cache_dir: str = "./models"
    shard_dir: str = "./shards"
    num_shards: int = 2
    quantization: str | None = None  # None | "int8" | "int4"
    quant_block_size: int = 128


@dataclass(frozen=True)
class Config:
    """Root config: everything the framework needs in one place."""

    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    model_id: str = "gpt2"


def _dataclass_from_dict(cls: type, data: dict[str, Any]) -> Any:
    """Recursively build a (frozen) dataclass from a plain dict, rejecting
    unknown keys so config typos fail loudly."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs: dict[str, Any] = {}
    for name, value in data.items():
        ftype = fields[name].type
        target = _nested_dataclass(ftype)
        if target is not None and isinstance(value, dict):
            kwargs[name] = _dataclass_from_dict(target, value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


_NESTED = {
    "ModelConfig": ModelConfig,
    "MeshConfig": MeshConfig,
    "RuntimeConfig": RuntimeConfig,
    "ClusterConfig": ClusterConfig,
    "CheckpointConfig": CheckpointConfig,
}


def _nested_dataclass(ftype: Any) -> type | None:
    name = ftype if isinstance(ftype, str) else getattr(ftype, "__name__", "")
    return _NESTED.get(name)


def config_to_dict(cfg: Any) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def load_config(path: str | None = None, overrides: list[str] | None = None) -> Config:
    """Load a :class:`Config` from a JSON/YAML file plus dotted overrides.

    Overrides look like ``model.num_layers=24`` or ``mesh.pipe=4``; values are
    parsed as JSON when possible, else kept as strings.
    """
    data: dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                if not _HAVE_YAML:  # pragma: no cover
                    raise RuntimeError("yaml not available; use JSON config")
                data = yaml.safe_load(f) or {}
            else:
                data = json.load(f)
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override must be key=value, got {ov!r}")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _dataclass_from_dict(Config, data)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        if path.endswith((".yaml", ".yml")) and _HAVE_YAML:
            yaml.safe_dump(config_to_dict(cfg), f)
        else:
            json.dump(config_to_dict(cfg), f, indent=2)
