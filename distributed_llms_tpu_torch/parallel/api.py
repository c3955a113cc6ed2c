"""ParallelModel: one object that places a model on a mesh and runs it
(PyTorch port of ``distributed_llms_tpu/parallel/api.py``).

Data x pipeline x tensor x sequence x expert parallelism over
``torch.distributed``, one process a mesh position (``core/mesh.py``):

- tensor parallelism: every rank holds its block of the heads, the MLP
  hidden axis and the vocabulary (``parallel/specs.py``), runs the model
  at its local widths (:attr:`ParallelModel.local_cfg`), and sums the
  row-parallel products and gathers the logits over its 'model' line
  (``models/layers.py``, ``models/model.py``);
- data parallelism: a batch whose rows divide over 'data' runs each
  rank's block of rows; the new K/V of every row is gathered before the
  cache write, so every rank's cache (contiguous rows or page pool, its
  KV heads) holds every row, and the logits gather at the end.  Every
  rank thus ends a forward with the same full-batch logits and samples
  the same tokens from the same generator state;
- pipeline parallelism: each rank of a 'pipe' line is one stage, holding
  its contiguous block of L/pipe layers and their KV cache; a forward
  runs the GPipe schedule and generation the wavefront decode
  (``parallel/pipeline.py``, :meth:`ParallelModel.as_decode_fn`).  The
  head is split between the ends of the line
  (:meth:`ParallelModel.place_leaf`), the logits reach every rank from
  the last stage.  Pipelined meshes keep contiguous caches and serve
  whole batches (``InferenceEngine.generate_text``); the continuous
  batcher refuses them, as the reference's does;
- sequence parallelism: each rank of a 'seq' line runs its contiguous
  block of the tokens and positions through the model (the port's
  counterpart of the reference's ``shard_map`` over 'seq'), attention
  being the ring or Ulysses (``ops/ring.py``, ``ops/ulysses.py``), and
  the final hidden states are gathered over the line, so that every
  rank unembeds and returns the whole sequence (``[B, T, D]`` through
  the host, not ``[B, T, V]``).  Generation keeps the
  two-region cache (:meth:`ParallelModel.init_cache` with
  ``prompt_len``): each rank's block of the prompt's K/V, and the
  decode region whole on every rank, read by the one-reduce decode.  It
  composes with 'data' and 'model'; it is inference only (the forwards
  run under ``no_grad``) and, like the pipeline, serves whole batches;
- expert parallelism: an MoE model's expert stacks shard over 'expert'
  (``E`` divides over the axis; else they stay whole on every rank, as
  the reference's rule replicates them).  Every rank routes every row,
  runs its own experts and sums the claims' rows over its 'expert' line
  (``models/layers.py`` ``moe_swiglu``, :attr:`Plan.experts`).  It
  composes with every other axis, and on data x model x expert meshes
  (no 'pipe' or 'seq') the forward carries gradients: the training step
  (``runtime/train.py`` ``Trainer(parallel=)``) differentiates through it
  and ``return_aux`` returns the MoE term.

Pipelined and sequence-parallel training (gradients through the ring
shift and the all-to-all) and the NCCL leg are later slices of the port:
``Trainer`` refuses a pipe or seq mesh, naming them
(:data:`_LATER_SLICES`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from ..core.config import MeshConfig, ModelConfig
from ..models import model as model_lib
from ..models.model import KVCache
from . import pipeline as pipeline_lib
from . import specs as specs_lib
from .plan import Plan

Params = Any

_LATER_SLICES = ("pipelined and sequence-parallel training (gradients "
                 "through the ring shift and the all-to-all) and the NCCL "
                 "leg come in later slices of the port")


class ParallelModel:
    """A model placed on a mesh.  Build with :func:`make_parallel_model`."""

    def __init__(self, cfg: ModelConfig, mesh, num_microbatches: int = 1,
                 kv_dtype: str | None = None) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.kv_dtype = kv_dtype
        tp = mesh.size("model")
        self.heads = cfg.num_heads % tp == 0 and tp > 1
        kv_sharded = cfg.num_kv_heads % tp == 0
        ffn = cfg.intermediate_size % tp == 0 and tp > 1
        vocab = cfg.vocab_size % tp == 0 and tp > 1
        kv_map = None
        if self.heads and not kv_sharded:
            h_loc, group = cfg.num_heads // tp, cfg.q_per_kv
            r = mesh.coord("model")
            kv_map = tuple((r * h_loc + j) // group for j in range(h_loc))
        ep = mesh.size("expert")
        experts = None
        if ep > 1 and cfg.num_experts > 0 and cfg.num_experts % ep == 0:
            per = cfg.num_experts // ep
            lo = mesh.coord("expert") * per
            experts = (lo, lo + per)
        self.plan = Plan(mesh=mesh, heads=self.heads, kv_map=kv_map, ffn=ffn,
                         vocab=vocab, experts=experts)
        # The rank's widths; ring/Ulysses need the seq forwards' bound
        # line, so every other path runs them dense (the reference's
        # ``_local_cfg``; :attr:`seq_cfg` for the seq forwards).
        self.local_cfg = dataclasses.replace(
            cfg,
            num_heads=cfg.num_heads // tp if self.heads else cfg.num_heads,
            num_kv_heads=(cfg.num_kv_heads // tp if self.heads and kv_sharded
                          else cfg.num_kv_heads),
            intermediate_size=(cfg.intermediate_size // tp if ffn
                               else cfg.intermediate_size),
            head_dim=cfg.head_dim_,
            attn_impl=("dot" if cfg.attn_impl in ("ring", "ulysses")
                       else cfg.attn_impl),
        )
        self._seq_plans = {kind: dataclasses.replace(self.plan, seq=kind)
                           for kind in ("block", "whole")}
        # The rules this rank cuts its leaves by; a pipelined mesh takes
        # the stage's layers first (:meth:`place_leaf`), so the layer axis
        # is not cut again.
        self.rules = specs_lib.param_specs(cfg, mesh)
        if self.pipelined:
            self.rules["blocks"] = pipeline_lib.map_leaves(
                lambda r: specs_lib.P(None, *tuple(r)[1:]),
                self.rules["blocks"])

    @property
    def num_stages(self) -> int:
        return self.mesh.size("pipe")

    @property
    def pipelined(self) -> bool:
        return self.num_stages > 1

    @property
    def seq_parallel(self) -> bool:
        return self.mesh.size("seq") > 1

    @property
    def seq_cfg(self) -> ModelConfig:
        """The config of the seq forwards (the reference's ``_seq_cfg``):
        the rank's widths, the user's Ulysses kept and anything else the
        ring (a sliding-window model is refused here, as by the
        reference's config)."""
        return dataclasses.replace(
            self.local_cfg,
            attn_impl="ulysses" if self.cfg.attn_impl == "ulysses" else "ring")

    def splits_rows(self, b: int) -> bool:
        """Whether a ``b``-row forward gives each 'data' rank its block of
        the rows (so a training step's gradients are partial sums over
        'data'); an MoE model never splits."""
        return self.plan.row_split(b, self.cfg.num_experts > 0) is not None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def stage(self) -> int:
        return self.mesh.coord("pipe")

    # -- placement ----------------------------------------------------------

    def _holds(self, group: str) -> bool:
        """Whether this rank keeps the top-level parameter group ``group``
        ("embed", "blocks", "final_norm", "lm_head").  Every rank holds
        its blocks; on a pipelined mesh stage 0 alone embeds and the last
        stage alone unembeds (the embedding there too when it is tied), so
        each end holds one of the two vocabulary-sized matrices."""
        if not self.pipelined or group == "blocks":
            return True
        first, last = self.stage == 0, self.stage == self.num_stages - 1
        if group == "embed":
            return first or (last and self.cfg.tie_embeddings)
        return last

    def place_leaf(self, name: str, leaf: Any,
                   before: Callable[[str, Any], Any] | None = None) -> Any:
        """This rank's part of the leaf at ``name`` ("blocks/attn/wq"), or
        None for a leaf of a group the rank does not keep (a pipeline
        stage's other end of the head).  ``before(name, leaf)`` runs first
        on a leaf that is kept.  On a pipelined mesh a block leaf's stage
        comes first ([L, ...] -> this stage's [L/pipe, ...]), then its
        block under the rule (``QuantizedTensor`` leaves stay quantized,
        scales refined where a shard edge would split a block; a layout
        that cannot shard stays whole, loudly)."""
        if not self._holds(name.split("/", 1)[0]):
            return None
        if before is not None:
            leaf = before(name, leaf)
        rule = self.rules
        for part in name.split("/"):
            rule = rule[part]
        if self.pipelined and name.startswith("blocks/"):
            leaf = pipeline_lib.split_stages(leaf, self.num_stages)[self.stage]
        return specs_lib.shard_leaf(leaf, rule, self.mesh, "/" + name)

    def shard_params(self, params: Params) -> Params:
        """This rank's part of ``params`` on its device (:meth:`place_leaf`
        on every leaf; a group it does not keep is left out)."""
        def walk(t, path):
            if isinstance(t, dict):
                kept = {k: walk(v, f"{path}/{k}") for k, v in t.items()}
                return {k: v for k, v in kept.items() if v is not None} or None
            leaf = self.place_leaf(path, t)
            return None if leaf is None else leaf.to(self.device)

        kept = {k: walk(v, k) for k, v in params.items()}
        return {k: v for k, v in kept.items() if v is not None}

    def init_cache(self, batch: int, max_len: int,
                   prompt_len: int | None = None) -> KVCache:
        """This rank's contiguous cache ``[L, B, S, KVH_local, HD]`` (``L``
        its stage's layers on a pipelined mesh): its KV heads of every row
        (rows are not sharded over 'data': each step's K/V of every row
        reaches every rank, see the module docstring).

        On a sequence-parallel mesh the two-region cache instead, split at
        ``prompt_len`` (the padded prompt, a multiple of the 'seq' axis):
        k and v are each ``(prefill [L, B, prompt_len / S, ...], decode
        [L, B, max_len - prompt_len, ...])``, this rank's block of the
        prompt and the whole decode region."""
        dtype = self.kv_dtype or self.cfg.dtype
        if self.seq_parallel:
            s = self.mesh.size("seq")
            if prompt_len is None:
                raise ValueError(
                    "sequence-parallel KV cache needs prompt_len (the region "
                    "split point); the session path does not support "
                    "seq-parallel decode"
                )
            if prompt_len % s:
                raise ValueError(
                    f"padded prompt length {prompt_len} not divisible by "
                    f"seq axis {s}"
                )

            def region(length):
                return model_lib.init_cache(self.local_cfg, batch, length,
                                            dtype=dtype, device=self.device)

            pref, dec = region(prompt_len // s), region(max_len - prompt_len)
            return KVCache(k=(pref.k, dec.k), v=(pref.v, dec.v))
        cfg = dataclasses.replace(
            self.local_cfg, num_layers=self.cfg.num_layers // self.num_stages)
        return model_lib.init_cache(cfg, batch, max_len, dtype=dtype,
                                    device=self.device)

    @contextlib.contextmanager
    def activate(self):
        """Run the forwards of this block on the mesh (the model code
        reads the plan on this thread)."""
        with self.plan.active():
            yield self

    # -- adapters for runtime.generate and runtime.session -----------------

    def _guard_windowed_decode(self) -> None:
        """Data, tensor and pipeline meshes serve sliding-window models
        (their adapters carry the slot -> position map the window reads);
        the sequence-parallel cached paths do not: ring and Ulysses are
        causal only, so decoding there would attend past the window."""
        if self.cfg.sliding_window is not None and self.seq_parallel:
            raise ValueError(
                "sequence-parallel decode of sliding_window models is "
                "unsupported (ring/Ulysses attention is causal-only, no "
                "window bound); use a data/model/pipe mesh"
            )

    def as_forward_fn(self):
        self._guard_windowed_decode()
        return self._forward_adapter

    def as_make_cache(self):
        self._guard_windowed_decode()
        return self._make_cache_adapter

    def as_decode_fn(self):
        """The fused wavefront decode loop (``pipeline.pipeline_decode``)
        for ``runtime.generate``: only a pipelined mesh has one."""
        self._guard_windowed_decode()
        return self._decode_adapter if self.pipelined else None

    def _forward_adapter(self, params, cfg, tokens, positions=None,
                         cache=None, cache_index=None, attn_mask=None,
                         key_positions=None):
        del cfg  # self.cfg is authoritative
        return self.forward(params, tokens, positions=positions, cache=cache,
                            cache_index=cache_index, attn_mask=attn_mask,
                            key_positions=key_positions)

    def _make_cache_adapter(self, cfg, batch, max_len, prompt_len=None):
        del cfg
        return self.init_cache(batch, max_len, prompt_len=prompt_len)

    def _decode_adapter(self, params, tok0, prompt_lens, prompt_pad_len,
                        cache, generator, max_new_tokens, temperature, top_k,
                        top_p, eos_id, pad_id):
        with self.activate(), torch.no_grad():
            return pipeline_lib.pipeline_decode(
                self.mesh, self.local_cfg, params, tok0, prompt_lens,
                prompt_pad_len, cache.k, cache.v, max_new_tokens,
                self.num_microbatches, generator, temperature=temperature,
                top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id)

    # -- execution ----------------------------------------------------------

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor | None = None, cache=None,
                cache_index=None, attn_mask: torch.Tensor | None = None,
                remat: bool = False, return_aux: bool = False,
                key_positions: torch.Tensor | None = None,
                kv_tables: torch.Tensor | None = None):
        """``models.model.forward``'s contract on the mesh: ``params`` are
        this rank's (:meth:`shard_params`), the inputs are the full batch
        on every rank, and every rank returns the full-batch logits.  A
        pipelined mesh runs the GPipe schedule (inference only: its
        shifts carry no gradient) with a scalar ``cache_index``, and
        returns a zero MoE term, as the reference's schedule does.  A
        sequence-parallel mesh runs its seq forwards (inference only,
        zero MoE term): the no-cache forward, the prefill into the
        two-region cache and the one-token decode over it; a no-cache
        forward with a caller's mask runs dense on every rank, as in the
        reference."""
        if kv_tables is not None and (self.pipelined or self.seq_parallel):
            raise NotImplementedError(
                "paged decode (kv_tables) runs on pure data/tensor-parallel "
                "meshes only — pipelined/seq-parallel schedules keep "
                "contiguous caches"
            )
        if self.seq_parallel and key_positions is not None:
            raise NotImplementedError(
                "sequence-parallel paths do not thread key_positions "
                "(ring/Ulysses are causal-only)"
            )
        seq_out = None
        if self.seq_parallel and cache is not None:
            if tokens.shape[1] > 1:
                if attn_mask is not None:
                    # Loud, not silently causal: ring/Ulysses are causal
                    # only.
                    raise NotImplementedError(
                        "sequence-parallel cached prefill supports causal "
                        "masking only; got an explicit attn_mask"
                    )
                seq_out = self._seq_prefill_cached(params, tokens, positions,
                                                   cache, cache_index, remat)
            else:
                seq_out = self._seq_decode_cached(params, tokens, positions,
                                                  cache, cache_index,
                                                  attn_mask, remat)
        elif self.seq_parallel and attn_mask is None:
            seq_out = (self._seq_forward(params, tokens, positions, remat),
                       None)
        if seq_out is not None:
            if return_aux:
                return (*seq_out, torch.zeros((), dtype=torch.float32,
                                              device=seq_out[0].device))
            return seq_out
        if self.pipelined:
            with self.activate(), torch.no_grad():
                out = self._pipe_forward(params, tokens, positions, cache,
                                         cache_index, attn_mask, remat,
                                         key_positions, kv_tables)
            if return_aux:
                return (*out, torch.zeros((), dtype=torch.float32,
                                          device=out[0].device))
            return out
        with self.activate():
            return model_lib.forward(
                params, self.local_cfg, tokens, positions=positions,
                cache=cache, cache_index=cache_index, attn_mask=attn_mask,
                kv_tables=kv_tables, remat=remat,
                key_positions=key_positions, return_aux=return_aux)

    # -- sequence parallelism ------------------------------------------------

    def _seq_block(self, t: int) -> slice:
        """This rank's contiguous block of ``t`` tokens over 'seq'."""
        s, r = self.mesh.size("seq"), self.mesh.coord("seq")
        if t % s:
            raise ValueError(
                f"prompt length {t} not divisible by seq axis {s} "
                "(the engine pads prompts to the mesh multiple)"
            )
        return slice(r * t // s, (r + 1) * t // s)

    def _seq_run(self, kind, params, tokens, positions, **kw):
        """``models.model.forward`` at the seq config under the seq plan
        of ``kind`` ("block": this rank's block of the tokens, the hidden
        states gathered over 'seq' before the unembedding; "whole"): the
        ring or Ulysses find their line there."""
        with self._seq_plans[kind].active(), torch.no_grad():
            return model_lib.forward(params, self.seq_cfg, tokens,
                                     positions=positions, **kw)

    def _positions(self, b: int, t: int, device) -> torch.Tensor:
        return torch.arange(t, device=device).expand(b, t)

    def _seq_forward(self, params, tokens, positions, remat):
        """The no-cache forward: each rank runs its block of the tokens at
        their global positions; every rank returns the whole ``[B, T,
        V]`` (the reference's ``out_specs=P(None, "seq", None)``)."""
        b, t = tokens.shape
        if positions is None:
            positions = self._positions(b, t, tokens.device)
        blk = self._seq_block(t)
        logits, _ = self._seq_run("block", params, tokens[:, blk],
                                  positions[:, blk], remat=remat)
        return logits

    def _seq_prefill_cached(self, params, tokens, positions, cache,
                            cache_index, remat):
        """The prefill into the two-region cache: each rank writes its
        block of the prompt's K/V into its prefill region; every rank
        returns the whole sequence's logits."""
        if cache_index is not None and int(cache_index) != 0:
            raise ValueError(
                "the sequence-parallel prefill fills the prefill region "
                f"from slot 0; got cache_index {int(cache_index)}")
        b, t = tokens.shape
        if positions is None:
            positions = self._positions(b, t, tokens.device)
        blk = self._seq_block(t)
        logits, _ = self._seq_run("block", params, tokens[:, blk],
                                  positions[:, blk], cache=cache,
                                  cache_index=0, remat=remat)
        return logits, cache

    def _seq_decode_cached(self, params, tokens, positions, cache,
                           cache_index, attn_mask, remat):
        """One token a row over the two-region cache: the decode loop's
        ``[B, 1, 1, S]`` mask is cut into this rank's block of the prompt
        region and the decode region; the query is on every rank, and so
        are the logits."""
        if attn_mask is None:
            raise ValueError(
                "seq-parallel cached decode needs the decode loop's explicit "
                "attention mask (runtime.generate supplies it)"
            )
        if torch.is_tensor(cache_index) and cache_index.dim() > 0:
            raise ValueError(
                "the sequence-parallel decode writes one decode slot for the "
                "whole batch: pass a scalar cache_index")
        t_loc = cache.k[0].shape[2]
        t_pref = t_loc * self.mesh.size("seq")
        r = self.mesh.coord("seq")
        m = attn_mask[:, 0, 0, :]
        masks = (m[:, r * t_loc:(r + 1) * t_loc], m[:, t_pref:])
        return self._seq_run("whole", params, tokens, positions, cache=cache,
                             cache_index=cache_index, attn_mask=masks,
                             remat=remat)

    # -- the pipeline ---------------------------------------------------------

    def _pipe_forward(self, params, tokens, positions, cache, cache_index,
                      attn_mask, remat, key_positions, kv_tables):
        """Embed on stage 0, the blocks through the pipeline, unembed on
        the last stage; the logits broadcast over 'pipe'."""
        if torch.is_tensor(cache_index) and cache_index.dim() > 0:
            raise ValueError(
                "the pipeline schedule writes one slot range for the whole "
                "batch: pass a scalar cache_index")
        cfg = self.local_cfg
        b, t = tokens.shape
        std_layout = positions is None and (cache is None
                                            or cache_index is None)
        if positions is None:
            base = 0 if cache_index is None else int(cache_index)
            positions = (torch.arange(t, device=tokens.device)
                         + base).expand(b, t)
        x = (model_lib.embed(params, cfg, tokens, positions)
             if self.stage == 0 else None)
        y = pipeline_lib.pipeline_blocks(
            self.mesh, cfg, params["blocks"], x, positions,
            self.num_microbatches,
            cache_k=cache.k if cache is not None else None,
            cache_v=cache.v if cache is not None else None,
            cache_index=None if cache is None else int(cache_index),
            attn_mask=attn_mask, remat=remat, key_positions=key_positions,
            std_layout=std_layout)
        last = self.num_stages - 1
        logits = (model_lib.unembed(params, cfg, y) if self.stage == last
                  else torch.empty((b, t, cfg.vocab_size),
                                   dtype=torch.float32, device="meta"))
        return self.mesh.broadcast(logits, last, "pipe"), cache


def make_parallel_model(cfg: ModelConfig, mesh_cfg: MeshConfig,
                        device: "str | torch.device | None" = None,
                        kv_dtype: str | None = None, mesh=None,
                        num_microbatches: int = 1) -> ParallelModel:
    """The model on ``mesh_cfg`` over the initialized process group (or
    on an explicit layout ``mesh``), with the reference's checks."""
    from ..core.mesh import build_mesh

    mesh = mesh if mesh is not None else build_mesh(mesh_cfg, device=device)
    if mesh_cfg.pipe > 1 and cfg.num_layers % mesh_cfg.pipe:
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by pipe {mesh_cfg.pipe}"
        )
    if mesh_cfg.pipe > 1 and mesh_cfg.seq > 1:
        raise ValueError(
            f"seq={mesh_cfg.seq} cannot combine with pipe={mesh_cfg.pipe}: "
            "ring attention and the pipeline schedule are alternative "
            "shardings of the layer loop — use one, with 'data'/'model' axes"
        )
    return ParallelModel(cfg, mesh, num_microbatches=num_microbatches,
                         kv_dtype=kv_dtype)
