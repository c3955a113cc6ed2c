"""ParallelModel: one object that places a model on a mesh and runs it
(PyTorch port of ``distributed_llms_tpu/parallel/api.py``).

Data x tensor parallelism over ``torch.distributed``, one process a mesh
position (``core/mesh.py``):

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
  the same tokens from the same generator state.

A mesh with a ``pipe``, ``seq`` or ``expert`` axis above 1 builds (its
rules, its stage assignment), but its forward, decode and cache raise
``NotImplementedError``: the pipeline, sequence parallelism and the expert
axis are the port's last slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from ..core.config import MeshConfig, ModelConfig
from ..models import model as model_lib
from ..models.model import KVCache
from . import specs as specs_lib
from .plan import Plan

Params = Any

_LAST_SLICE = ("is not ported yet: the pipeline (parallel/pipeline.py), "
               "sequence parallelism (ops/ring.py, ops/ulysses.py) and the "
               "expert axis come in the port's last slice")


def staged_param_specs(cfg: ModelConfig, mesh) -> Params:
    """Rules for a tree whose blocks were reshaped [L, ...] -> [pipe,
    L/pipe, ...]: 'pipe' on the new leading axis of every block leaf."""
    base = specs_lib.param_specs(cfg, mesh)

    def retag(t):
        if isinstance(t, dict):
            return {k: retag(v) for k, v in t.items()}
        return specs_lib.P("pipe", None, *tuple(t)[1:])

    return {**base, "blocks": retag(base["blocks"])}


class ParallelModel:
    """A model placed on a mesh.  Build with :func:`make_parallel_model`."""

    def __init__(self, cfg: ModelConfig, mesh,
                 kv_dtype: str | None = None) -> None:
        self.cfg = cfg
        self.mesh = mesh
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
        self.plan = Plan(mesh=mesh, heads=self.heads, kv_map=kv_map, ffn=ffn,
                         vocab=vocab)
        self.local_cfg = dataclasses.replace(
            cfg,
            num_heads=cfg.num_heads // tp if self.heads else cfg.num_heads,
            num_kv_heads=(cfg.num_kv_heads // tp if self.heads and kv_sharded
                          else cfg.num_kv_heads),
            intermediate_size=(cfg.intermediate_size // tp if ffn
                               else cfg.intermediate_size),
            head_dim=cfg.head_dim_,
        )

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
    def expert_parallel(self) -> bool:
        return self.mesh.size("expert") > 1

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def as_decode_fn(self):
        """The fused pipelined decode loop of ``runtime.generate``: only a
        pipelined mesh has one, and it is the last slice's."""
        if self.pipelined:
            raise NotImplementedError(f"the pipelined decode loop {_LAST_SLICE}")
        return None

    def _require_dp_tp(self, what: str) -> None:
        if self.pipelined or self.seq_parallel or self.expert_parallel:
            raise NotImplementedError(
                f"{what} on a mesh with pipe={self.num_stages}, "
                f"seq={self.mesh.size('seq')}, "
                f"expert={self.mesh.size('expert')} {_LAST_SLICE}")

    # -- placement ----------------------------------------------------------

    def shard_params(self, params: Params) -> Params:
        """This rank's part of ``params`` on its device: each leaf's block
        under its rule; ``QuantizedTensor`` leaves stay quantized (scales
        refined where a shard edge would split a block; a layout that
        cannot shard stays whole, loudly).  A pipelined mesh stages the
        blocks first ([L, ...] -> [pipe, L/pipe, ...])."""
        def to_dev(t):
            if isinstance(t, dict):
                return {k: to_dev(v) for k, v in t.items()}
            return t.to(self.device)

        if self.pipelined:
            blocks = _split_stages(params["blocks"], self.num_stages)
            placed = specs_lib.shard_tree({**params, "blocks": blocks},
                                          staged_param_specs(self.cfg,
                                                             self.mesh),
                                          self.mesh)
        else:
            placed = specs_lib.shard_params(params, self.cfg, self.mesh)
        return to_dev(placed)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """This rank's contiguous cache ``[L, B, S, KVH_local, HD]``: its
        KV heads of every row (rows are not sharded over 'data': each
        step's K/V of every row reaches every rank, see the module
        docstring)."""
        self._require_dp_tp("the KV cache")
        return model_lib.init_cache(self.local_cfg, batch, max_len,
                                    dtype=self.kv_dtype or self.cfg.dtype,
                                    device=self.device)

    @contextlib.contextmanager
    def activate(self):
        """Run the forwards of this block on the mesh (the model code
        reads the plan on this thread)."""
        self._require_dp_tp("a forward")
        with self.plan.active():
            yield self

    # -- execution ----------------------------------------------------------

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor | None = None, cache=None,
                cache_index=None, attn_mask: torch.Tensor | None = None,
                remat: bool = False, return_aux: bool = False,
                key_positions: torch.Tensor | None = None,
                kv_tables: torch.Tensor | None = None):
        """``models.model.forward``'s contract on the mesh: ``params`` are
        this rank's (:meth:`shard_params`), the inputs are the full batch
        on every rank, and every rank returns the full-batch logits."""
        with self.activate():
            return model_lib.forward(
                params, self.local_cfg, tokens, positions=positions,
                cache=cache, cache_index=cache_index, attn_mask=attn_mask,
                kv_tables=kv_tables, remat=remat,
                key_positions=key_positions, return_aux=return_aux)


def _split_stages(blocks: Params, stages: int) -> Params:
    """[L, ...] -> [stages, L/stages, ...] on every block leaf."""
    from ..checkpoint.quantize import QuantizedTensor

    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(split(t.data), split(t.scale), t.bits,
                                   t.orig_shape, t.pack_axis)
        return t.reshape(stages, t.shape[0] // stages, *t.shape[1:])

    return split(blocks)


def make_parallel_model(cfg: ModelConfig, mesh_cfg: MeshConfig,
                        device: "str | torch.device | None" = None,
                        kv_dtype: str | None = None, mesh=None
                        ) -> ParallelModel:
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
    return ParallelModel(cfg, mesh, kv_dtype=kv_dtype)
