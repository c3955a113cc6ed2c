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
and its batchers speculate (:meth:`InferenceEngine.attach_draft`).

Besides the batchers, the engine serves whole batches itself, as the
source system's worker calls it: :meth:`InferenceEngine.generate_text`
(one prefill and a decode loop over the right-padded batch; routed
through the standalone speculative loop under ``runtime.spec_decode`` at
temperature 0), multi-turn sessions whose KV cache persists between turns
(:meth:`~InferenceEngine.start_session`,
:meth:`~InferenceEngine.continue_session`,
:meth:`~InferenceEngine.end_session`; with ``runtime.kv_host_spill`` at
most ``runtime.max_resident_sessions`` caches stay on the device, the rest
wait in host memory) and :meth:`~InferenceEngine.generate_text_speculative`.
Entry points run on CUDA unless the caller asks for the CPU by name
(``device="cpu"``); without a GPU and without that request they raise.

On a data x pipeline x tensor x sequence x expert-parallel mesh
(``from_store(mesh_cfg=)``, or ``parallel=`` with this rank's parameters)
every process is one rank:
it holds its block of the weights (quantized leaves stay quantized; an
MoE model's expert stacks cut along ``E`` over 'expert'), runs the
forwards on the mesh (``parallel/api.py``) and, on a data x tensor x
expert mesh, hands out mesh batchers; every rank must be fed the same calls (the
control plane's ``generate_spmd``), or rank 0 journals them
(``runtime/lockstep.py``).  A pipelined mesh (``pipe`` above 1) serves
whole batches and sessions through the pipeline's schedules: the prefill
and session turns through its GPipe forward, ``generate_text``'s decode
through the wavefront (``parallel/pipeline.py``); its batches round up to
``data x runtime.microbatches`` rows, and the continuous batcher refuses
it, as the reference's does.  A sequence-parallel mesh (``seq`` above 1)
serves whole batches through its seq forwards and the two-region cache
(prompts right-padded to a multiple of the 'seq' axis, no bucket ladder);
the continuous batcher refuses it, and so do sessions (their cache has no
prompt length to split at), as in the reference.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import profiling
from ..core.config import ModelConfig, RuntimeConfig
from ..core.device import resolve_device
from ..core.observability import METRICS, get_logger
from ..models import model as model_lib
from ..models.presets import get_preset
from . import generate as gen_lib
from . import shapes as shapes_lib
from .session import SessionManager, session_step
from .tokenizer import get_tokenizer, pad_batch

log = get_logger("engine")


def _to_host(out: torch.Tensor) -> np.ndarray:
    """Device -> host for generation outputs (waits for the device)."""
    return out.cpu().numpy()


@dataclass
class GenerationResult:
    text: list[str]
    tokens: np.ndarray  # [B, N]
    prompt_tokens: int
    generated_tokens: int
    seconds: float

    @property
    def tokens_per_second(self) -> float:
        return self.generated_tokens / max(self.seconds, 1e-9)


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
        parallel: Any = None,  # parallel.api.ParallelModel; ``params`` are
        #   then this rank's (ParallelModel.shard_params)
    ) -> None:
        model_lib.check_supported(cfg)
        self.cfg = cfg
        self.rt = rt
        self.pm = parallel
        # The forward, cache and decode loop of generate_text and of
        # sessions: the single-device model's (also under a data x tensor
        # plan), or a pipelined or sequence-parallel mesh's schedules.
        self._forward_fn = self._decode_fn = None
        own_schedules = parallel is not None and (parallel.pipelined
                                                  or parallel.seq_parallel)
        if parallel is not None:
            device = parallel.device
            if own_schedules:
                self._forward_fn = parallel.as_forward_fn()
                self._decode_fn = parallel.as_decode_fn()
        # The config the device work runs at: the rank's local widths.
        self.run_cfg = parallel.local_cfg if parallel is not None else cfg
        self.device = resolve_device(device)
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
        if rt.spec_decode and parallel is not None:
            log.warning(
                "runtime.spec_decode is single-device; this mesh engine "
                "serves PLAIN (generate_text / continuous_batcher keep "
                "working, just without speculation)"
            )
        elif rt.spec_decode:
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
        # The KV cache of generate_text and of sessions: rt.kv_cache_dtype
        # on the engine's device.
        self._make_cache = lambda cfg_, b, s, prompt_len=None: \
            model_lib.init_cache(cfg_, b, s, dtype=rt.kv_cache_dtype,
                                 device=self.device)
        if own_schedules:
            self._make_cache = parallel.as_make_cache()
        self._timer = profiling.StepTimer("engine.generate")
        # Session store: caches persist across turns; with kv_host_spill
        # only the most recent max_resident_sessions stay on the device.
        self.sessions = SessionManager(
            max_resident=rt.max_resident_sessions if rt.kv_host_spill
            else (1 << 30))

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
        projection runs the dequant-matmul kernel (an MoE block's router
        and experts are rehydrated layer by layer in each forward, as in
        the reference); the embedding (with a learned position table) and
        the unembedding are dequantized to ``cfg.dtype`` (a gather cannot
        read quantized rows).  Otherwise every leaf is dequantized at
        load."""
        from ..checkpoint import quantize as quant_lib
        from ..checkpoint import store as store_lib
        from ..models.layers import K_LEAD, kernel_leaves
        from ..models.model import torch_dtype
        from ..ops.quant_matmul import check_pack_axis, repack_legacy_int4
        from .tokenizer import ByteTokenizer

        rt = rt or RuntimeConfig()
        manifest = store_lib.load_manifest(store_dir)
        if manifest.get("model_config") is None:
            raise ValueError(f"store {store_dir} has no embedded model_config")
        cfg = ModelConfig(**manifest["model_config"])
        model_lib.check_supported(cfg)
        parallel = None
        if mesh_cfg is not None and mesh_cfg.num_devices > 1:
            from ..parallel.api import make_parallel_model

            parallel = make_parallel_model(
                cfg, mesh_cfg, device=device, kv_dtype=rt.kv_cache_dtype,
                num_microbatches=max(rt.microbatches, 1))
            dev = parallel.device
        else:
            dev = resolve_device(device)
        # Each leaf is cut to this rank's block on the host as it is read,
        # so only the rank's share reaches its device; a group the rank
        # does not hold (a pipeline stage's other end of the head) is not
        # kept at all.
        place = parallel.place_leaf if parallel is not None else None
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
            moe = cfg.num_experts > 0

            def prepare(name, leaf):
                # A legacy int4 store's pairs move onto the contracted axis
                # the dequant-matmul reads (exact), before any placement;
                # an MoE block's router and experts never reach it (they
                # are rehydrated per layer), and their pairs stay where
                # they are, off the expert axis the rule cuts.  The
                # embedding and unembedding are dequantized (a gather
                # cannot read quantized rows).
                if isinstance(leaf, quant_lib.QuantizedTensor):
                    base = name.rsplit("/", 1)[-1]
                    if name.startswith("blocks/"):
                        if base in K_LEAD and not (
                                moe and name.startswith("blocks/mlp/")):
                            leaf = repack_legacy_int4(leaf, K_LEAD[base],
                                                      stacked=1)
                    else:
                        leaf = quant_lib.dequantize(leaf.to(dev), dtype)
                return leaf

            params = store_lib.load_shards(
                store_dir, device=dev,
                place=prepare if place is None
                else lambda name, leaf: place(name, leaf, before=prepare))
            # The packing check belongs to the leaves the dequant-matmul
            # reads; an MoE block's experts are rehydrated per layer.
            for name, leaf in kernel_leaves(params["blocks"]):
                if isinstance(leaf, quant_lib.QuantizedTensor):
                    check_pack_axis(leaf, K_LEAD[name], stacked=1)
        else:
            params = store_lib.reconstruct(store_dir, dtype=dtype, device=dev,
                                           place=place)
        return cls(cfg, rt, params, tokenizer=tokenizer, device=dev,
                   parallel=parallel)

    # -- whole-batch generation -------------------------------------------

    def _generator(self, seed: int | None) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.rt.seed if seed is None else seed)
        return gen

    def _profile(self):
        return (profiling.trace(self.rt.profile_dir) if self.rt.profile_dir
                else contextlib.nullcontext())

    def _result(self, out: np.ndarray, lens: torch.Tensor, n_real: int,
                seconds: float) -> GenerationResult:
        """The result of ``out`` [n_real, N], with the engine's metrics."""
        gen_count = int(out.shape[0] * out.shape[1])
        METRICS.inc("engine.generated_tokens", gen_count)
        METRICS.observe("engine.generate_seconds", seconds)
        return GenerationResult(
            text=[self.tokenizer.decode(row) for row in out], tokens=out,
            prompt_tokens=int(lens[:n_real].sum()),
            generated_tokens=gen_count, seconds=seconds,
        )

    def generate_text(self, prompts: list[str],
                      max_new_tokens: int | None = None,
                      seed: int | None = None) -> GenerationResult:
        """Generate ``max_new_tokens`` (None: ``rt.max_decode_steps``) for
        each prompt: one prefill of the right-padded batch, then the decode
        loop (``runtime.generate.generate_tokens``), sampling with the
        runtime config's knobs from a generator seeded with ``seed``
        (None: ``rt.seed``).  Under ``rt.spec_decode`` at temperature 0
        with a draft attached, the batch goes through the speculative loop
        instead — the same tokens — unless its verify window would not fit
        under the sequence limit."""
        tok = self.tokenizer
        prompt_arr, lens, n_real = self._encode_rows(prompts, batch=None)
        n_new = (self.rt.max_decode_steps if max_new_tokens is None
                 else max_new_tokens)
        gen_lib.check_sequence_budget(prompt_arr.shape[1], n_new, self.rt,
                                      self.cfg)
        limit = min(self.rt.max_seq_len, self.cfg.max_seq_len)
        if (
            self.rt.spec_decode
            and self.rt.temperature == 0.0
            and self.draft_params is not None
            and n_new >= 1
            # The verify writes up to k+1 slots past the budget; near the
            # sequence cap the plain loop still fits, so fall through.
            and prompt_arr.shape[1] + self.rt.spec_k + 1 + n_new <= limit
        ):
            return self._speculative_result(prompt_arr, lens, n_real, n_new,
                                            self.rt.spec_k)
        # Bucket only on the plain path, after the budget check (which sees
        # the raw width) and the speculative gate (whose near-cap test on
        # the raw width keeps routing prompts the loop can still fit).
        prompt_arr = self._bucket_prompt(prompt_arr, n_new)
        t0 = time.perf_counter()
        with self._profile(), self._timer.step(tokens=n_real * n_new), \
                self._on_mesh():
            out = gen_lib.generate_tokens(
                self.params, self.run_cfg, prompt_arr, lens,
                self._generator(seed),
                max_new_tokens=n_new, temperature=self.rt.temperature,
                top_k=self.rt.top_k, top_p=self.rt.top_p,
                eos_id=tok.eos_id, pad_id=tok.pad_id,
                forward_fn=self._forward_fn, make_cache=self._make_cache,
                decode_fn=self._decode_fn,
            )
            out = _to_host(out)[:n_real]
        dt = time.perf_counter() - t0
        profiling.record_memory_stats()
        return self._result(out, lens, n_real, dt)

    def _bucket_prompt(self, prompt_arr: torch.Tensor,
                       n_new: int) -> torch.Tensor:
        """Pad the prompt width up the shared bucket ladder
        (``runtime/shapes.py``), as the reference pads it to bound its
        compiled programs; exact, since pad slots sit to the right of every
        real token and the decode mask admits only real prompt slots and
        generated slots.  Skipped when the bucket would not fit the
        sequence budget, and on a sequence-parallel mesh (T stays the
        'seq' multiple :meth:`_encode_rows` padded it to)."""
        if self.pm is not None and self.pm.seq_parallel:
            return prompt_arr
        t = int(prompt_arr.shape[1])
        limit = min(self.rt.max_seq_len, self.cfg.max_seq_len)
        target = shapes_lib.generate_pad_len(t, n_new, limit)
        if target <= t:
            return prompt_arr
        return torch.nn.functional.pad(prompt_arr, (0, target - t),
                                       value=self.tokenizer.pad_id)

    # -- sessions: KV persists across turns; host spill under kv_host_spill

    def _batch_multiple(self) -> int:
        """Rows a batch must be a multiple of: the mesh's 'data' axis (1 on
        one device), so that the rows split evenly over it, times the
        microbatches when the pipeline schedule splits the batch."""
        if self.pm is None:
            return 1
        mb = self.pm.num_microbatches if self.pm.pipelined else 1
        return self.pm.mesh.size("data") * max(mb, 1)

    def _on_mesh(self):
        """The mesh plan for the forwards of this block (a no-op on one
        device)."""
        return (self.pm.activate() if self.pm is not None
                else contextlib.nullcontext())

    def _session_max_len(self) -> int:
        return min(self.rt.max_seq_len, self.cfg.max_seq_len)

    def _encode_rows(self, prompts: list[str], batch: int | None) -> tuple:
        """Encode and right-pad the rows: (tokens [B, T] int32, lens [B]
        int32, both on the engine's device; the caller's row count).
        ``batch=None``: a new batch, rows padded up to
        :meth:`_batch_multiple`; otherwise a continuation, padded to the
        session's ``batch`` rows by repeating row 0.  On a
        sequence-parallel mesh T is right-padded up to a multiple of the
        'seq' axis (the prefill splits it over the line; pad slots are
        masked out of the decode like any padding)."""
        tok = self.tokenizer
        seqs = [tok.encode(p) for p in prompts]
        n_real = len(seqs)
        want = (-(-n_real // self._batch_multiple()) * self._batch_multiple()
                if batch is None else batch)
        seqs += [seqs[0]] * (want - n_real)
        arr, lens = pad_batch(seqs, tok.pad_id)
        if self.pm is not None and self.pm.seq_parallel:
            s = self.pm.mesh.size("seq")
            arr = np.pad(arr, ((0, 0), (0, -arr.shape[1] % s)),
                         constant_values=tok.pad_id)
        return (torch.from_numpy(arr).to(self.device),
                torch.from_numpy(lens).to(self.device), n_real)

    def _session_turn(self, sess, chunk, lens, n_new: int,
                      seed: int | None) -> GenerationResult:
        t = int(chunk.shape[1])
        if sess.base + t + n_new > sess.max_len:
            raise ValueError(
                f"session {sess.sid}: {sess.base} used + {t} chunk + {n_new} "
                f"new tokens exceeds session max_len {sess.max_len}"
            )
        tok = self.tokenizer
        t0 = time.perf_counter()
        with self._timer.step(tokens=sess.n_real * n_new), self._on_mesh():
            toks, cache, valid, real, spos = session_step(
                self.params, self.run_cfg, chunk, lens, sess.real_lens,
                sess.valid_mask, sess.cache, sess.base, self._generator(seed),
                max_new_tokens=n_new, temperature=self.rt.temperature,
                top_k=self.rt.top_k, top_p=self.rt.top_p,
                eos_id=tok.eos_id, pad_id=tok.pad_id,
                forward_fn=self._forward_fn,
                slot_positions=sess.slot_positions,
            )
            out = _to_host(toks)[:sess.n_real]
        dt = time.perf_counter() - t0
        sess.cache, sess.valid_mask, sess.real_lens = cache, valid, real
        sess.slot_positions = spos
        sess.base += t + n_new
        return self._result(out, lens, sess.n_real, dt)

    def start_session(self, prompts: list[str],
                      max_new_tokens: int | None = None,
                      seed: int | None = None) -> tuple[str, GenerationResult]:
        """Open a session: prefill and decode, keeping the KV cache for
        continuation turns.  Returns (session_id, result)."""
        n_new = (self.rt.max_decode_steps if max_new_tokens is None
                 else max_new_tokens)
        max_len = self._session_max_len()
        chunk, lens, n_real = self._encode_rows(prompts, batch=None)
        b, t = int(chunk.shape[0]), int(chunk.shape[1])
        if t + n_new > max_len:  # validate BEFORE allocating/registering
            raise ValueError(
                f"prompt ({t} padded tokens) + {n_new} new tokens exceeds "
                f"session max_len {max_len}"
            )
        self.sessions.make_room()  # spill an LRU cache before allocating
        cache = self._make_cache(self.run_cfg, b, max_len)
        valid = torch.zeros((b, max_len), dtype=torch.bool, device=self.device)
        real = torch.zeros((b,), dtype=torch.int32, device=self.device)
        sess = self.sessions.new_session(cache, valid, real, base=0,
                                         max_len=max_len)
        sess.n_real = n_real
        if self.cfg.sliding_window is not None:
            # The padded multi-turn layout makes slot != position and the
            # window compares positions: session_step keeps the map.
            sess.slot_positions = torch.zeros((b, max_len), dtype=torch.int32,
                                              device=self.device)
        try:
            res = self._session_turn(sess, chunk, lens, n_new, seed)
        except Exception:
            self.sessions.drop(sess.sid)  # no orphaned device cache
            raise
        return sess.sid, res

    def continue_session(self, sid: str, prompts: list[str],
                         max_new_tokens: int | None = None,
                         seed: int | None = None) -> GenerationResult:
        """Append a turn to a session (copying its cache back from host
        memory first if it was spilled)."""
        sess = self.sessions.get(sid)
        if len(prompts) != sess.n_real:
            raise ValueError(
                f"session {sid} has {sess.n_real} rows; got {len(prompts)} "
                "prompts"
            )
        self.sessions.ensure_resident(sess)
        self.sessions.touch(sess)
        n_new = (self.rt.max_decode_steps if max_new_tokens is None
                 else max_new_tokens)
        chunk, lens, _ = self._encode_rows(
            prompts, batch=int(sess.valid_mask.shape[0]))
        return self._session_turn(sess, chunk, lens, n_new, seed)

    def end_session(self, sid: str) -> None:
        self.sessions.drop(sid)

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
        tenant_weights: "str | dict | None" = None,  # None ->
        #   rt.tenant_weights; "gold:4,free:1"-style weights turn the
        #   mixed policy into per-tenant weighted-fair admission
        #   (runtime/scheduler.py TenantScheduler)
        tenant_max_rows: int | None = None,  # None -> rt.tenant_max_rows;
        #   per-tenant resident-row cap (0 = uncapped)
        faults: Any = None,  # FaultPlane | None; None -> parse rt.faults
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
        explicitly the batcher refuses the pair.  ``faults`` (a
        :class:`~.faults.FaultPlane`; None parses ``rt.faults`` strictly,
        a fresh plane per batcher) arms the batcher's injection sites.
        ``tenant_weights`` / ``tenant_max_rows`` (None: the config's; ""
        and 0 disable) schedule tenants weighted-fair; inherited from the
        config they turn the config's speculation off with a warning."""
        from .batcher import ContinuousBatcher

        if self.pm is not None and (self.pm.pipelined
                                    or self.pm.seq_parallel):
            raise ValueError(
                "continuous batching requires a single-device engine or a "
                "pure data/tensor-parallel mesh (no pipe/seq axes)"
            )
        if tenant_weights is None:
            tenant_weights = self.rt.tenant_weights
        if tenant_weights == "":  # the CLI/config "disable" spelling
            tenant_weights = None
        if tenant_max_rows is None:
            tenant_max_rows = self.rt.tenant_max_rows
        if tenant_max_rows == 0:
            tenant_max_rows = None
        if faults is None and self.rt.faults:
            # Each batcher gets its own plane (a respawn shares it by
            # reference, so once-only rules stay once-only); strict, so a
            # rule naming a site the port does not wire fails here
            # instead of never firing.
            from .faults import FaultPlane

            faults = FaultPlane.parse(self.rt.faults, strict=True)
        # RuntimeConfig knobs are the defaults; explicit arguments win
        # (paged_pages=0 explicitly requests contiguous).
        paged = (self.rt.paged_pages if paged_pages is None
                 else paged_pages) or None
        if paged is not None and self.pm is not None:
            # The pool shards its KV-head axis over 'model': an explicit
            # request that cannot shard raises, a config-inherited one
            # degrades to contiguous with a warning (the reference's
            # policy).
            tp = self.pm.mesh.size("model")
            if tp > 1 and self.cfg.num_kv_heads % tp:
                if paged_pages is not None:
                    raise ValueError(
                        f"paged KV on this mesh shards the pool on the "
                        f"KV-head axis: num_kv_heads "
                        f"{self.cfg.num_kv_heads} does not divide over "
                        f"'model' ({tp}); pass paged_pages=0 or reshape "
                        f"the mesh"
                    )
                log.warning(
                    "runtime.paged_pages=%d ignored: num_kv_heads %d does "
                    "not divide over the mesh 'model' axis (%d); serving "
                    "contiguous", paged, self.cfg.num_kv_heads, tp,
                )
                paged = None
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
        if speculative and (tenant_weights or tenant_max_rows) \
                and not explicit_spec:
            # Same config-inherited degrade: tenant weighted-fair
            # scheduling and the speculative round ledger do not compose
            # (make_scheduler refuses the pair when speculative=True is
            # explicit).
            log.warning(
                "runtime.spec_decode ignored: tenant weighted-fair "
                "scheduling is configured and does not compose with "
                "speculative rounds yet; serving plain",
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
        # Slot counts that do not divide the mesh's 'data' axis round up.
        mult = self._batch_multiple()
        return ContinuousBatcher(
            self.cfg, self.params, tokenizer=self.tokenizer, **spec_kwargs,
            batch_slots=-(-batch_slots // mult) * mult, parallel=self.pm,
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
            faults=faults,
            tenant_weights=tenant_weights, tenant_max_rows=tenant_max_rows,
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


    def generate_text_speculative(
        self, prompts: list[str], max_new_tokens: int | None = None,
        k: int = 4, seed: int | None = None,
    ) -> GenerationResult:
        """Generation through the standalone speculative loop
        (``runtime.speculative.speculative_generate_tokens``): at
        temperature 0 exactly ``generate_text``'s tokens; above it an exact
        sample of the same warped target distribution from another random
        stream.  Needs an attached draft."""
        if self.draft_params is None:
            raise ValueError("no draft attached; call attach_draft(...) first")
        prompt_arr, lens, n_real = self._encode_rows(prompts, batch=None)
        n_new = (self.rt.max_decode_steps if max_new_tokens is None
                 else max_new_tokens)
        gen_lib.check_sequence_budget(prompt_arr.shape[1] + k + 1, n_new,
                                      self.rt, self.cfg)
        return self._speculative_result(prompt_arr, lens, n_real, n_new, k,
                                        seed)

    def _speculative_result(self, prompt_arr, lens, n_real: int, n_new: int,
                            k: int, seed: int | None = None
                            ) -> GenerationResult:
        """The shared tail of generate_text's speculative routing and
        generate_text_speculative (inputs encoded and budget-checked): the
        plain path's trace, timer and metrics, and the acceptance rate
        (``engine.spec_acceptance``)."""
        from .speculative import speculative_generate_tokens

        tok = self.tokenizer
        gen = self._generator(seed) if self.rt.temperature > 0.0 else None
        t0 = time.perf_counter()
        with self._profile(), self._timer.step(tokens=n_real * n_new):
            out, stats = speculative_generate_tokens(
                self.params, self.cfg, self.draft_params, self.draft_cfg,
                prompt_arr, lens, k=k, max_new_tokens=n_new,
                eos_id=tok.eos_id, pad_id=tok.pad_id, return_stats=True,
                temperature=self.rt.temperature, top_k=self.rt.top_k,
                top_p=self.rt.top_p, generator=gen,
            )
            out = _to_host(out)[:n_real]
        dt = time.perf_counter() - t0
        profiling.record_memory_stats()
        METRICS.observe("engine.spec_acceptance",
                        stats["accepted"] / max(stats["drafted"], 1))
        return self._result(out, lens, n_real, dt)


def _quantize_blocks(blocks: Any, bits: int) -> Any:
    """``checkpoint.quantize.quantize_tree`` of the stacked decoder blocks,
    one layer at a time (the float32 temporaries of a whole stacked leaf
    would take several times its bytes), the layers' codes and scales
    stacked back: the same codes, since every scale block and int4 pair
    lies within one layer."""
    from ..checkpoint import quantize as quant_lib
    from ..models.layers import K_LEAD, kernel_leaves
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
        return quant_lib.QuantizedTensor(
            data=torch.stack([q.data for q in per]),
            scale=torch.stack([q.scale for q in per]),
            bits=bits, orig_shape=tuple(tree.shape), pack_axis=pack_axis)

    out = walk(blocks, "")
    for name, qt in kernel_leaves(out):
        if isinstance(qt, quant_lib.QuantizedTensor):
            check_pack_axis(qt, K_LEAD[name], stacked=1)
    return out


def _to_device(tree: Any, device: torch.device) -> Any:
    """Move a parameter tree (tensors and ``QuantizedTensor`` leaves)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
