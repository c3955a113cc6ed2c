"""Inference engine: config + parameters + device -> a continuous batcher
(PyTorch port of the serving part of
``distributed_llms_tpu/runtime/engine.py``).

The engine owns the weights on one device and hands out
:class:`~.batcher.ContinuousBatcher` instances over them: random seeded
weights of a preset (:meth:`InferenceEngine.from_preset`) or a shard store
(:meth:`InferenceEngine.from_store`), whose decoder-block weights can stay
int8/int4 on the device (``runtime.serve_quantized``).  With
``runtime.spec_decode`` the engine attaches a self-draft (its own decoder
blocks, weight-only quantized to ``runtime.spec_draft_quantize`` bits)
and its batchers speculate (:meth:`InferenceEngine.attach_draft`).  Entry
points run on CUDA unless the caller asks for the CPU by name
(``device="cpu"``); without a GPU and without that request they raise.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..core.config import ModelConfig, RuntimeConfig
from ..core.device import resolve_device
from ..core.observability import get_logger
from ..models import model as model_lib
from ..models.presets import get_preset
from .tokenizer import get_tokenizer

log = get_logger("engine")


class InferenceEngine:
    """Single-device inference engine.  ``params`` is the JAX package's
    parameter tree as tensors (``models.model.init_params`` or
    ``checkpoint.from_jax.params_from_numpy``), moved to ``device``."""

    def __init__(
        self,
        cfg: ModelConfig,
        rt: RuntimeConfig,
        params: Any,
        tokenizer=None,
        device: "str | torch.device | None" = None,
    ) -> None:
        model_lib.check_supported(cfg)
        self.cfg = cfg
        self.rt = rt
        self.device = resolve_device(device)
        if rt.kv_host_spill:
            raise NotImplementedError(
                "runtime.kv_host_spill is not ported yet")
        self.tokenizer = tokenizer or get_tokenizer(None)
        # Out-of-vocab ids would index past the embedding table; reject the
        # mismatch loudly.
        tok_vocab = getattr(self.tokenizer, "vocab_size", None)
        if tok_vocab is not None and tok_vocab > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tok_vocab}, incl. specials) exceeds model "
                f"vocab ({cfg.vocab_size}); token ids would be out of range"
            )
        self.params = _to_device(params, self.device)
        self.draft_cfg: ModelConfig | None = None
        self.draft_params: Any = None
        if rt.spec_decode:
            # The reference's construction policy: malformed configs raise;
            # an engine that cannot self-draft serves plain with a warning
            # (an explicit attach_draft(cfg, params) still works there).
            if cfg.ragged_decode:
                raise ValueError(
                    "runtime.spec_decode is incompatible with "
                    "model.ragged_decode; unset one"
                )
            if rt.spec_k < 1:
                raise ValueError(f"runtime.spec_k must be >= 1, got {rt.spec_k}")
            if self._serves_quantized():
                log.warning(
                    "spec_decode requested but the engine serves quantized "
                    "weights; serving PLAIN (no self-draft to quantize). "
                    "Attach an explicit draft for speculative serving."
                )
            else:
                self.attach_draft(quantize_bits=rt.spec_draft_quantize)

    @classmethod
    def from_preset(
        cls, name: str, rt: RuntimeConfig | None = None, rng_seed: int = 0,
        device: "str | torch.device | None" = None, **overrides,
    ) -> "InferenceEngine":
        """Random-weight engine for a named preset, drawn on the device
        from a ``torch.Generator`` seeded with ``rng_seed``."""
        dev = resolve_device(device)
        cfg = get_preset(name, **overrides)
        gen = torch.Generator(device=dev)
        gen.manual_seed(rng_seed)
        params = model_lib.init_params(cfg, generator=gen, device=dev)
        return cls(cfg, rt or RuntimeConfig(), params, device=dev)

    @classmethod
    def from_store(
        cls,
        store_dir: str,
        rt: RuntimeConfig | None = None,
        mesh_cfg: Any = None,  # core.config.MeshConfig
        tokenizer=None,
        device: "str | torch.device | None" = None,
    ) -> "InferenceEngine":
        """An engine over a shard store (``checkpoint.store``, written by
        either stack): the model config comes from its manifest, the
        tokenizer from its ``tokenizer`` dir (the byte tokenizer, with a
        warning, when it has none).  With ``rt.serve_quantized`` the
        decoder-block weights stay int8/int4 on the device and every
        projection runs the dequant-matmul kernel; the embedding and the
        unembedding are dequantized to ``cfg.dtype`` (a gather cannot read
        quantized rows).  Otherwise every leaf is dequantized at load."""
        from ..checkpoint import quantize as quant_lib
        from ..checkpoint import store as store_lib
        from ..models.layers import K_LEAD
        from ..models.model import torch_dtype
        from ..ops.quant_matmul import check_pack_axis
        from .tokenizer import ByteTokenizer

        if mesh_cfg is not None and mesh_cfg.num_devices > 1:
            raise NotImplementedError(
                "serving a store on a multi-device mesh is not ported yet")
        rt = rt or RuntimeConfig()
        dev = resolve_device(device)
        manifest = store_lib.load_manifest(store_dir)
        if manifest.get("model_config") is None:
            raise ValueError(f"store {store_dir} has no embedded model_config")
        cfg = ModelConfig(**manifest["model_config"])
        model_lib.check_supported(cfg)
        if tokenizer is None:
            tok_rel = manifest.get("tokenizer")
            if tok_rel:
                tokenizer = get_tokenizer(os.path.join(store_dir, tok_rel))
            if (tokenizer is None or isinstance(tokenizer, ByteTokenizer)) \
                    and cfg.vocab_size > ByteTokenizer.vocab_size:
                log.warning(
                    "store %s has no usable tokenizer (manifest tokenizer=%r) "
                    "but the model vocab is %d; falling back to byte-level "
                    "ids — decoded text will be wrong for a real checkpoint. "
                    "Re-save the store with tokenizer_src=<checkpoint dir>.",
                    store_dir, tok_rel, cfg.vocab_size,
                )
        dtype = torch_dtype(cfg.dtype)
        if rt.serve_quantized:
            if not manifest.get("quantization"):
                raise ValueError(
                    f"serve_quantized=True but store {store_dir} is not "
                    "quantized; save it with quantization='int8'|'int4'"
                )
            params = store_lib.load_shards(store_dir, device=dev)
            for group in params["blocks"].values():
                for name, leaf in group.items():
                    if isinstance(leaf, quant_lib.QuantizedTensor):
                        check_pack_axis(leaf, K_LEAD[name], stacked=1)
            params = {k: (v if k == "blocks"
                          else quant_lib.dequantize_tree(v, dtype))
                      for k, v in params.items()}
        else:
            params = store_lib.reconstruct(store_dir, dtype=dtype, device=dev)
        return cls(cfg, rt, params, tokenizer=tokenizer, device=dev)

    def continuous_batcher(
        self, batch_slots: int = 8, max_len: int | None = None,
        chunk_steps: int = 8, paged_pages: int | None = None,
        page_size: int | None = None,
        prefix_cache: bool | None = None,  # None -> rt.prefix_cache
        speculative: bool | None = None,
        prefill_chunk: int | None = None,  # chunked prefill: admit at most
        #   this many prompt tokens per round per pending prefill
        prefill_concurrency: int = 2,  # chunked prefills in flight at once
        kv_bits: int | None = None,
        host_pages: int | None = None,
        overlap: bool | None = None,  # None -> rt.overlap
        schedule: str | None = None,  # None -> rt.schedule
        token_budget: int | None = None,
        tenant_weights: "str | dict | None" = None,
        tenant_max_rows: int | None = None,
        faults: Any = None,
    ):
        """A ContinuousBatcher over this engine's model: contiguous KV
        (``paged_pages`` None or 0, from the argument or the config), or a
        paged pool with the optional automatic prefix cache and int8 pages
        (``kv_bits=8``).  The paged-only knobs follow the reference's
        policy: an explicit request on a contiguous engine raises
        ``ValueError``, a config-inherited one is dropped with a warning.
        ``overlap`` (None: ``rt.overlap``, on by default) runs the
        dispatch-ahead loop; ``prefill_chunk`` / ``prefill_concurrency`` /
        ``token_budget`` (None: ``rt.token_budget``; 0 disables) chunk long
        prompts.  ``speculative`` (None: ``rt.spec_decode`` at temperature
        0 with a draft attached) drafts with the attached draft and
        verifies ``rt.spec_k + 1`` tokens a round; inherited from the
        config it yields to chunked prefill with a warning, asked for
        explicitly the batcher refuses the pair.  Knobs of later port
        slices raise ``NotImplementedError``, whether passed here or
        inherited from the config."""
        from .batcher import ContinuousBatcher

        for what, requested in (
            ("multi-tenant scheduling (tenant_weights/tenant_max_rows)",
             tenant_weights or self.rt.tenant_weights or tenant_max_rows
             or self.rt.tenant_max_rows),
            ("fault injection (faults)", faults or self.rt.faults),
        ):
            if requested:
                raise NotImplementedError(f"{what} is not ported yet")
        # RuntimeConfig knobs are the defaults; explicit arguments win
        # (paged_pages=0 explicitly requests contiguous).
        paged = (self.rt.paged_pages if paged_pages is None
                 else paged_pages) or None
        # The host tier backs the paged pool: asked for explicitly on a
        # contiguous engine it raises, inherited from the config it is
        # dropped with a warning (the reference's rule).
        explicit_host = host_pages is not None
        if host_pages is None:
            host_pages = self.rt.host_pages
        if host_pages and paged is None:
            if explicit_host:
                raise ValueError(
                    "the host-RAM KV tier backs the paged pool; pass "
                    "paged_pages (or set runtime.paged_pages)"
                )
            log.warning(
                "runtime.host_pages ignored: this engine serves "
                "contiguous KV (no paged pool to tier)"
            )
            host_pages = 0
        if paged is None:
            for what, explicit, inherited in (
                    ("automatic prefix caching", prefix_cache,
                     self.rt.prefix_cache),
                    ("int8 KV pages", None if kv_bits is None
                     else kv_bits == 8, self.rt.kv_bits == 8)):
                if explicit:
                    raise ValueError(
                        f"{what} needs the paged KV pool; pass paged_pages "
                        f"(or set runtime.paged_pages)"
                    )
                if explicit is None and inherited:
                    log.warning("%s from the config ignored: this engine "
                                "serves contiguous KV", what)
            prefix_cache, kv_bits = False, 16
        explicit_spec = speculative is not None
        if speculative is None:
            # The config's default speculates only where it keeps the plain
            # batcher's streams: greedy, with a draft attached.  Sampled
            # speculation (the target's distribution, another random
            # stream) takes speculative=True.
            speculative = (self.rt.spec_decode and self.rt.temperature == 0.0
                           and self.draft_params is not None)
        if speculative and prefill_chunk is not None and not explicit_spec:
            log.warning(
                "runtime.spec_decode ignored: chunked prefill is "
                "configured (prefill_chunk=%d) and the speculative draft "
                "admission prefills monolithically; serving plain",
                prefill_chunk,
            )
            speculative = False
        spec_kwargs = {}
        if speculative:
            if self.draft_params is None:
                raise ValueError(
                    "speculative batching needs a draft: call "
                    "attach_draft(...) first"
                )
            spec_kwargs = dict(
                draft_params=self.draft_params, draft_cfg=self.draft_cfg,
                spec_k=self.rt.spec_k,
                spec_adaptive_k=self.rt.spec_adaptive_k,
            )
        return ContinuousBatcher(
            self.cfg, self.params, tokenizer=self.tokenizer, **spec_kwargs,
            batch_slots=batch_slots,
            max_len=min(max_len or self.rt.max_seq_len, self.cfg.max_seq_len),
            chunk_steps=chunk_steps,
            temperature=self.rt.temperature, top_k=self.rt.top_k,
            top_p=self.rt.top_p, eos_id=self.tokenizer.eos_id,
            pad_id=self.tokenizer.pad_id,
            kv_dtype=self.rt.kv_cache_dtype,
            paged_pages=paged,
            page_size=page_size or self.rt.page_size,
            prefix_cache=bool(self.rt.prefix_cache if prefix_cache is None
                              else prefix_cache),
            prefill_chunk=prefill_chunk,
            prefill_concurrency=prefill_concurrency,
            token_budget=(self.rt.token_budget if token_budget is None
                          else token_budget) or None,
            kv_bits=self.rt.kv_bits if kv_bits is None else kv_bits,
            host_pages=host_pages,
            overlap=self.rt.overlap if overlap is None else overlap,
            schedule=schedule or self.rt.schedule,
        )


    # -- speculative decoding: the draft -----------------------------------

    def _serves_quantized(self) -> bool:
        """Whether the decoder-block weights are resident as
        ``QuantizedTensor`` leaves (a ``serve_quantized`` store): such
        weights cannot be quantized again into a self-draft."""
        from ..checkpoint.quantize import QuantizedTensor

        def leaves(t):
            if isinstance(t, dict):
                for v in t.values():
                    yield from leaves(v)
            else:
                yield t

        return any(isinstance(x, QuantizedTensor)
                   for x in leaves(self.params.get("blocks", {})))

    def attach_draft(self, draft_cfg: ModelConfig | None = None,
                     draft_params: Any = None,
                     quantize_bits: int | None = None) -> None:
        """Attach the draft model speculative batchers use: an explicit
        ``(draft_cfg, draft_params)`` pair (any model sharing this
        engine's vocabulary), or ``quantize_bits=4|8`` for the self-draft
        — this engine's own decoder blocks weight-only quantized
        (``checkpoint/quantize.py``'s layout), every projection then
        running the dequant-matmul kernel; the embedding and the
        unembedding are shared with the target.  Exactness at temperature
        0 never depends on the draft."""
        if quantize_bits is not None:
            if draft_cfg is not None or draft_params is not None:
                raise ValueError("pass draft_cfg/draft_params OR quantize_bits")
            if self._serves_quantized():
                raise ValueError(
                    "engine already serves quantized weights; build the "
                    "draft explicitly (attach_draft(draft_cfg, draft_params))"
                )
            draft_cfg = self.cfg
            draft_params = {**self.params,
                            "blocks": _quantize_blocks(self.params["blocks"],
                                                       quantize_bits)}
        if draft_cfg is None or draft_params is None:
            raise ValueError("need draft_cfg + draft_params (or quantize_bits)")
        if draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size}"
            )
        model_lib.check_supported(draft_cfg)
        self.draft_cfg = draft_cfg
        self.draft_params = _to_device(draft_params, self.device)


def _quantize_blocks(blocks: Any, bits: int) -> Any:
    """``checkpoint.quantize.quantize_tree`` of the stacked decoder blocks,
    one layer at a time (the float32 temporaries of a whole stacked leaf
    would take several times its bytes), the layers' codes and scales
    stacked back: the same codes, since every scale block and int4 pair
    lies within one layer."""
    from ..checkpoint import quantize as quant_lib
    from ..models.layers import K_LEAD
    from ..ops.quant_matmul import check_pack_axis

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        should, pack_axis = quant_lib.leaf_plan(path, tree[0])
        if not should:
            return tree
        per = [quant_lib.quantize(tree[i], bits=bits, pack_axis=pack_axis)
               for i in range(tree.shape[0])]
        qt = quant_lib.QuantizedTensor(
            data=torch.stack([q.data for q in per]),
            scale=torch.stack([q.scale for q in per]),
            bits=bits, orig_shape=tuple(tree.shape), pack_axis=pack_axis)
        check_pack_axis(qt, K_LEAD[path.split("/")[-1]], stacked=1)
        return qt

    return walk(blocks, "")


def _to_device(tree: Any, device: torch.device) -> Any:
    """Move a parameter tree (tensors and ``QuantizedTensor`` leaves)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
