"""Device meshes over ``torch.distributed`` (PyTorch port of
``distributed_llms_tpu/core/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` with axes
``(data, pipe, model, seq, expert)`` and lets GSPMD insert the
collectives.  Here one PROCESS is one mesh position: rank r sits at
``numpy.unravel_index(r, shape)`` (the reference's row-major reshape of
its device list), runs on ``cuda:(local_rank % device_count)`` (two ranks
on a one-GPU machine share ``cuda:0``), and the model code calls the
collectives itself (:meth:`Mesh.all_reduce` with a sum or a max,
:meth:`Mesh.all_gather`, :meth:`Mesh.broadcast`, the ring
:meth:`Mesh.shift` of the pipeline and of ring attention, and Ulysses'
:meth:`Mesh.all_to_all`) over one process group per ``data``, ``pipe``,
``model`` and ``seq`` line, built with ``dist.new_group`` in the same
order on every rank, each with the world's timeout
(``cluster/distributed.py``).

Under gloo a CUDA tensor is staged through host memory for each
collective; under NCCL it goes as it is.  :attr:`Mesh.stats` counts the
collectives and the seconds spent in them (staging included), and the
shares of the ring shifts, the broadcasts, the all-to-alls and the
reductions (by op) apart.

The model code finds the mesh of the forward it runs through
``parallel/plan.py`` (thread-local), so a single-device forward pays
nothing.
"""

from __future__ import annotations

import datetime
import time
from typing import Any

import numpy as np
import torch

from .config import MeshConfig

__all__ = ["Mesh", "build_mesh"]

AXES = ("data", "pipe", "model", "seq", "expert")
PIECE_BYTES = 1 << 28  # the most one all-gather message carries


class Mesh:
    """This rank's view of the mesh: axis sizes, its coordinates, its
    device, and the process groups of its ``data``, ``pipe``, ``model``,
    ``seq`` and ``expert`` lines.  :attr:`stats` also counts each axis's
    collectives apart (``axis_<name>_calls`` / ``_seconds``).

    Without an initialized process group (``world_size``/``rank`` given
    explicitly) the mesh carries the layout only: the placement rules
    (``parallel/specs.py``) read it, and a collective raises."""

    def __init__(self, cfg: MeshConfig, rank: int, world_size: int,
                 device: "torch.device | str", groups: bool) -> None:
        self.cfg = cfg
        self.shape = dict(zip(AXES, cfg.shape))
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, cfg.shape))))
        self.backend: str | None = None
        self._groups: dict[str, Any] = {}
        self.stats = {"calls": 0, "seconds": 0.0}
        for kind in ("shift", "broadcast", "a2a", "reduce_sum",
                     "reduce_max", *(f"axis_{a}" for a in AXES)):
            self.stats.update({f"{kind}_calls": 0, f"{kind}_seconds": 0.0})
        if groups:
            self._build_groups()

    # -- layout --------------------------------------------------------------

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def _line(self, axis: str, coords: dict) -> list[int]:
        """Global ranks of the line through ``coords`` along ``axis``."""
        shape = self.cfg.shape
        k = AXES.index(axis)
        out = []
        for i in range(shape[k]):
            c = [coords[a] for a in AXES]
            c[k] = i
            out.append(int(np.ravel_multi_index(c, shape)))
        return out

    def _build_groups(self) -> None:
        import torch.distributed as dist

        from ..cluster.distributed import DEFAULT_TIMEOUT_S

        self.backend = dist.get_backend()
        # A new group takes torch's own default timeout (30 min under
        # gloo), not the world's: give every line the world's.
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        shape = self.cfg.shape
        for axis in AXES:
            k = AXES.index(axis)
            # Every line of this axis, in one order on every rank
            # (new_group is collective over the whole world).
            seen = set()
            for r in range(self.world_size):
                c = dict(zip(AXES, np.unravel_index(r, shape)))
                line = tuple(self._line(axis, {a: int(v) for a, v in
                                               c.items()}))
                if line in seen:
                    continue
                seen.add(line)
                g = (dist.new_group(list(line), timeout=timeout)
                     if shape[k] > 1 else None)
                if self.rank in line:
                    self._groups[axis] = g
        # Host objects (the lockstep journal) ride a gloo group; under gloo
        # that is the world group itself.
        self._groups["host"] = (None if self.backend == "gloo"
                                else dist.new_group(backend="gloo",
                                                    timeout=timeout))

    # -- collectives ----------------------------------------------------------

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def all_reduce(self, x: torch.Tensor, axis: str = "model",
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over the ``axis`` line by ``op`` ("sum" or "max",
        the reference's ``psum`` / ``pmax``): a new tensor on x's
        device."""
        if op not in ("sum", "max"):
            raise ValueError(
                f"all_reduce op must be 'sum' or 'max', got {op!r}")
        if self.size(axis) == 1:
            return x
        import torch.distributed as dist

        t0 = time.perf_counter()
        y = x.detach().cpu() if self._staged(x) else x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self._groups[axis])
        out = y.to(x.device, non_blocking=False)
        self._note(t0, f"reduce_{op}", axis)
        return out

    def _gather_parts(self, x: torch.Tensor, axis: str) -> list:
        """Every rank's ``x`` of the ``axis`` line, in line order (on the
        host when staged).  A large tensor (a long prefill's float32
        logits run to GBs) goes in pieces of at most :data:`PIECE_BYTES`,
        so that no one message of the collective carries all of it."""
        import torch.distributed as dist

        y = (x.detach().cpu() if self._staged(x) else x.detach()).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size(axis))]
        flat, outs = y.view(-1), [p.view(-1) for p in parts]
        step = max(1, PIECE_BYTES // y.element_size())
        for a in range(0, flat.numel(), step):
            dist.all_gather([o[a:a + step] for o in outs], flat[a:a + step],
                            group=self._groups[axis])
        return parts

    def all_gather(self, x: torch.Tensor, dim: int,
                   axis: str = "model") -> torch.Tensor:
        """Concatenate every rank's ``x`` of the ``axis`` line along
        ``dim``, in line order.  Each piece is copied into its place in
        the output on x's device: no concatenated copy is made on the
        host."""
        n = self.size(axis)
        if n == 1:
            return x
        t0 = time.perf_counter()
        parts = self._gather_parts(x, axis)
        out = _concat(parts, dim, x.device)
        self._note(t0, None, axis)
        return out

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   axis: str = "seq") -> torch.Tensor:
        """The reference's tiled ``all_to_all``: ``x`` is cut into n
        pieces along ``split_dim``, piece i goes to the rank at
        coordinate i of the ``axis`` line, and the pieces a rank receives
        are concatenated along ``concat_dim`` in line order.  Built on the
        line's all-gather, as :meth:`shift` is (gloo has no all-to-all):
        one collective every rank enters alike, of which each rank keeps
        its own piece of every rank's ``x``."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[split_dim] % n:
            raise ValueError(
                f"all_to_all splits dim {split_dim} ({x.shape[split_dim]}) "
                f"over {n} ranks of {axis!r}")
        t0 = time.perf_counter()
        i = self.coord(axis)
        pieces = [p.chunk(n, dim=split_dim)[i]
                  for p in self._gather_parts(x, axis)]
        out = _concat(pieces, concat_dim, x.device)
        self._note(t0, "a2a", axis)
        return out

    def broadcast(self, x: torch.Tensor, src: int,
                  axis: str = "pipe") -> torch.Tensor:
        """The ``axis`` line's rank at coordinate ``src`` sends ``x``;
        every rank of the line returns it, a new tensor on the mesh's
        device.  The others pass a tensor of the same shape and dtype
        whose values are not read: one on the 'meta' device, so that the
        buffer it is received into (on the host when staged) is the only
        one allocated."""
        if self.size(axis) == 1:
            return x
        import torch.distributed as dist

        t0 = time.perf_counter()
        if self.coord(axis) == src:
            y = x.detach().cpu() if self._staged(x) else x.detach().clone()
        else:
            staged = self.backend == "gloo" and self.device.type == "cuda"
            y = torch.empty(x.shape, dtype=x.dtype,
                            device="cpu" if staged else self.device)
        line = self._line(axis, self.coords)
        dist.broadcast(y, src=line[src], group=self._groups[axis])
        out = y.to(self.device)
        self._note(t0, "broadcast", axis)
        return out

    def shift(self, x: torch.Tensor, axis: str = "pipe") -> torch.Tensor:
        """One step around the ``axis`` ring: the rank at coordinate ``i``
        sends ``x`` to ``(i + 1) % n`` and returns what its predecessor
        sent (the reference's ``ppermute``).  Built on the line's
        all-gather, of which each rank keeps its predecessor's piece: one
        collective every rank enters alike, so no ordering of sends and
        receives can deadlock the ring.  Every rank passes a tensor of one
        shape and dtype."""
        n = self.size(axis)
        if n == 1:
            return x
        t0 = time.perf_counter()
        parts = self._gather_parts(x, axis)
        out = parts[(self.coord(axis) - 1) % n].to(x.device)
        self._note(t0, "shift", axis)
        return out

    # -- collectives that carry a gradient (training) -----------------------

    def sum_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ``axis`` line (Megatron's g): the
        gradient passes through unchanged."""
        if self.size(axis) == 1:
            return x
        if _recording(x):
            return _SumReduce.apply(x, self, axis)
        return self.all_reduce(x, axis)

    def copy_in(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` unchanged (Megatron's f); the gradient is summed over the
        ``axis`` line."""
        if self.size(axis) == 1 or not _recording(x):
            return x
        return _CopyIn.apply(x, self, axis)

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """:meth:`all_gather`; each rank keeps its own block of the
        gradient (every rank of the line differentiates the same function
        of the gathered tensor)."""
        if self.size(axis) == 1:
            return x
        if _recording(x):
            return _Gather.apply(x, self, dim, axis)
        return self.all_gather(x, dim, axis)

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """``obj`` of global rank ``src``, on every rank (host objects)."""
        import torch.distributed as dist

        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self._groups["host"])
        return box[0]

    def _note(self, t0: float, kind: str | None = None,
              axis: str | None = None) -> None:
        dt = time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["seconds"] += dt
        for key in (kind, None if axis is None else f"axis_{axis}"):
            if key is not None:
                self.stats[f"{key}_calls"] += 1
                self.stats[f"{key}_seconds"] += dt

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.at = mesh.coord(axis) * ctx.n
        return mesh.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at, ctx.n), None, None, None


def _concat(parts: list, dim: int, device) -> torch.Tensor:
    """``torch.cat(parts, dim)`` on ``device``, each part copied into its
    slice of one output tensor."""
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    out = torch.empty(shape, dtype=parts[0].dtype, device=device)
    at = 0
    for p in parts:
        out.narrow(dim, at, p.shape[dim]).copy_(p)
        at += p.shape[dim]
    return out


def rank_device(rank: int, device: "str | torch.device | None" = None
                ) -> torch.device:
    """The device of a rank: ``cuda:(LOCAL_RANK % device_count)`` (the
    rank itself without LOCAL_RANK), or the CPU when asked for."""
    import os

    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "mesh on the CPU explicitly")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def build_mesh(cfg: MeshConfig, device: "str | torch.device | None" = None,
               rank: int | None = None,
               world_size: int | None = None) -> Mesh:
    """The mesh over the initialized process group (axis sizes multiply to
    the world size, the reference's ``ValueError`` otherwise), or a
    layout-only mesh at an explicit ``rank`` of ``world_size``."""
    import torch.distributed as dist

    live = rank is None and dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if live else 0
        world_size = dist.get_world_size() if live else 1
    if cfg.num_devices != world_size:
        raise ValueError(
            f"mesh shape {cfg.shape} needs {cfg.num_devices} devices, "
            f"got {world_size}"
        )
    dev = rank_device(rank, device) if live else torch.device(device or "cpu")
    return Mesh(cfg, rank, world_size, dev, groups=live)
