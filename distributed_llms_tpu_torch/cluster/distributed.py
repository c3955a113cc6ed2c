"""Multi-process initialization over ``torch.distributed`` (PyTorch port of
``distributed_llms_tpu/cluster/distributed.py``).

The reference joins its processes into one ``jax.distributed`` runtime;
here :func:`initialize_distributed` joins them into one default process
group, after which ``core.mesh.build_mesh`` lays the mesh over it.  One
process never calls it (a no-op).

The backend follows from the layout, with no knob of its own: NCCL when
every rank of this host has a GPU of its own, gloo on the CPU or when
ranks share a GPU (NCCL does not put two ranks of one communicator on one
device; gloo stages each collective through host memory).  The choice is
logged, and a failed rendezvous raises.
"""

from __future__ import annotations

import datetime
import os

import torch

from ..core.config import ClusterConfig
from ..core.observability import get_logger

log = get_logger("distributed")

# How long a rendezvous or a collective may wait before it fails.
DEFAULT_TIMEOUT_S = 600.0


def choose_backend(local_world: int,
                   device: "str | torch.device | None" = None) -> str:
    """``"nccl"`` when this host's ``local_world`` ranks each get a GPU of
    their own, else ``"gloo"`` (the CPU, or ranks sharing a GPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize_distributed(cfg: ClusterConfig,
                           device: "str | torch.device | None" = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Join this process into the ``cfg.num_processes``-process group at
    ``tcp://<cfg.distributed_coordinator>`` as rank ``cfg.process_id``.
    Returns the backend, or None for one process (nothing to join)."""
    if cfg.num_processes <= 1:
        return None
    if cfg.distributed_coordinator is None:
        raise ValueError(
            "cluster.distributed_coordinator (host:port) is required when "
            f"num_processes={cfg.num_processes}"
        )
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", cfg.num_processes))
    backend = choose_backend(local_world, device)
    return _init(backend, f"tcp://{cfg.distributed_coordinator}",
                 cfg.num_processes, cfg.process_id, timeout_s)


def initialize_from_env(device: "str | torch.device | None" = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Join the group ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    None when it describes one process or nothing."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(local_world, device)
    return _init(backend, "env://", world, int(os.environ["RANK"]),
                 timeout_s)


def _init(backend: str, init_method: str, world: int, rank: int,
          timeout_s: float) -> str:
    import torch.distributed as dist

    log.info("torch.distributed init: backend=%s, %s, world_size=%d, "
             "rank=%d", backend, init_method, world, rank)
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return backend
