"""A world of spawned rank processes for the port's mesh tests (a helper
module, not a test file).

:class:`World` spawns ``n`` processes (the ``spawn`` context, never fork),
joins them into one gloo group that rendezvouses through a ``FileStore``
in a test's temporary directory (never a fixed TCP port: the suite runs
several workers at once), and then runs module-level functions on every
rank, returning each rank's result.  Every collective and every wait has
a timeout of 60 s or less, so a hung world fails the test instead of
stalling the suite.  The ranks import only torch and the port: the
functions they run live in modules that import nothing of JAX.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import queue
import sys
import traceback

TIMEOUT_S = 60.0


def _rank_main(rank, world, store_path, inq, outq, paths, env) -> None:
    sys.path[:0] = [p for p in paths if p not in sys.path]
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            msg = inq.get()
            if msg is None:
                break
            mod, name, args, kwargs = msg
            try:
                fn = getattr(importlib.import_module(mod), name)
                outq.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``n`` gloo ranks on the CPU, fed functions one case at a time."""

    def __init__(self, n: int, tmp_dir: str, env: dict | None = None) -> None:
        ctx = mp.get_context("spawn")
        here = os.path.dirname(os.path.abspath(__file__))
        paths = [here, os.path.dirname(here)]
        store = os.path.join(tmp_dir, "world_store")
        self.n = n
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(n)]
        self.procs = [
            ctx.Process(target=_rank_main,
                        args=(r, n, store, self.inqs[r], self.outq, paths,
                              dict(env or {})),
                        daemon=True)
            for r in range(n)
        ]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 2 * TIMEOUT_S, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; their results by rank.
        A rank that raised, died or did not answer fails the call."""
        for q in self.inqs:
            q.put((fn.__module__, fn.__name__, args, kwargs))
        got: dict[int, object] = {}
        errors = []
        while len(got) + len(errors) < self.n:
            try:
                rank, ok, value = self.outq.get(timeout=timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                raise RuntimeError(
                    f"{fn.__name__}: no answer in {timeout} s (dead ranks: "
                    f"{dead})") from None
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed\n" + "\n".join(errors))
        return [got[r] for r in range(self.n)]

    def close(self) -> None:
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=TIMEOUT_S)
            if p.is_alive():
                p.kill()
