"""Worker host CLI of the port (PyTorch port of
``distributed_llms_tpu/cli/host_main.py``): connect to the coordinator,
serve its commands on one GPU (``--device cpu`` for the CPU), stop
cleanly on Ctrl-C.

``dlt-host-torch --host COORD --port 65432 --worker-id pod-0``: the worker
registers under a stable id (``--worker-id`` or ``$DLT_WORKER_ID``), so a
restarted host keeps its shard assignment.  With
``cluster.num_processes > 1`` each process is one rank of a mesh: it
joins the ``torch.distributed`` group at ``cluster.distributed_coordinator``
as rank ``cluster.process_id`` (``cluster/distributed.py``; NCCL when
every rank has a GPU of its own, gloo otherwise) and serves its rank's
shard of ``mesh`` (whose size must be the group's, checked at boot).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from ..cluster.distributed import initialize_distributed
from ..cluster.worker import WorkerHost
from ..core.config import load_config


async def amain(args: argparse.Namespace) -> None:
    cfg = load_config(args.config, args.override)
    world = cfg.cluster.num_processes
    if cfg.mesh.num_devices > 1 and cfg.mesh.num_devices != world:
        raise ValueError(
            f"mesh shape {cfg.mesh.shape} needs {cfg.mesh.num_devices} "
            f"processes, got cluster.num_processes={world}")
    initialize_distributed(cfg.cluster, device=args.device)
    # CLI flags win when given; otherwise the config file decides.
    host = args.host if args.host is not None else cfg.cluster.coordinator_host
    port = args.port if args.port is not None else cfg.cluster.coordinator_port
    if host == "0.0.0.0":  # bind-any is not a connect address
        host = "localhost"
    worker = WorkerHost(host, port, cfg=cfg.cluster, rt=cfg.runtime,
                        mesh_cfg=cfg.mesh, device=args.device)
    if args.worker_id:
        # Stable identity across restarts (e.g. a StatefulSet pod name):
        # the coordinator re-registers the same id, so the shard assignment
        # and pinned tasks survive a host bounce.
        worker.worker_id = args.worker_id
    await worker.run()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="distributed-llms worker host (PyTorch port)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--override", action="append", default=[], metavar="K=V")
    ap.add_argument("--host", default=None,
                    help="coordinator host (default: from config)")
    ap.add_argument("--port", type=int, default=None,
                    help="coordinator port (default: from config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU explicitly)")
    ap.add_argument("--worker-id", default=os.environ.get("DLT_WORKER_ID"),
                    help="stable worker identity to register under (default: "
                         "$DLT_WORKER_ID; unset -> coordinator assigns one)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        print("stopping worker")
        sys.exit(0)


if __name__ == "__main__":
    main()
