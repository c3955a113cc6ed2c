"""Coordinator CLI of the port (PyTorch port of
``distributed_llms_tpu/cli/coordinator_main.py``): the source system's
master REPL over the port's control plane.

``dlt-coordinator-torch --local-proc 1`` starts a coordinator, spawns one
worker process (``dlt-host-torch``) on the GPU, and reads commands:

  init <checkpoint dir> [num_shards]  - convert a local HF checkpoint and
                                        write the shard store
  assign [num_shards] [policy]        - plan the shard -> worker assignment
  distribute                          - workers load their shards (place)
  rebalance                           - re-plan over the current workers
  inference                           - prompt for text, generate, print
  batch                               - "<max_new_tokens> <prompt>" lines,
                                        a blank line runs the batch
  status / metrics                    - registry + counters
  exit

``--local N`` runs N workers in this process instead; ``--serve`` runs
headless (no REPL) until SIGTERM.  Workers run on CUDA unless ``--device
cpu`` asks for the CPU; the flag is passed on to spawned hosts, as are
``--config`` and every ``--override`` (so ``--override
runtime.paged_pages=256`` shapes the workers' batchers).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

from ..checkpoint import convert, store
from ..checkpoint.download import fetch_model
from ..cluster.coordinator import Coordinator
from ..cluster.worker import WorkerHost
from ..core.config import Config, load_config
from ..core.observability import METRICS, get_logger

log = get_logger("cli")


async def _ainput(prompt: str) -> str:
    return await asyncio.to_thread(input, prompt)


def init_store(model_id: str, num_shards: int, cfg: Config) -> str:
    """Fetch (a local directory only), convert to the parameter tree, and
    write the shard store with the checkpoint's own tokenizer files."""
    local = fetch_model(model_id)
    t0 = time.perf_counter()
    with open(os.path.join(local, "config.json")) as f:
        model_cfg = convert.config_from_hf(json.load(f))
    params = convert.convert_state_dict(convert.load_state_dict(local),
                                        model_cfg)
    t1 = time.perf_counter()
    out_dir = cfg.checkpoint.shard_dir
    store.save_shards(
        params, out_dir, num_shards=num_shards, model_config=model_cfg,
        quantization=cfg.checkpoint.quantization,
        quant_block=cfg.checkpoint.quant_block_size,
        tokenizer_src=local,  # ship the model's own tokenizer with the store
    )
    t2 = time.perf_counter()
    print(f"sharded {model_id} -> {out_dir} ({num_shards} shards; convert "
          f"{t1 - t0:.2f} s, write {t2 - t1:.2f} s)")
    return out_dir


async def repl(coord: Coordinator, cfg: Config) -> None:
    print("commands: init <model> [shards] | assign [shards] [policy] | "
          "distribute | rebalance | inference | batch | status | metrics | exit")
    store_dir: str | None = None
    while True:
        try:
            line = (await _ainput("> ")).strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        cmd, *rest = line.split()
        try:
            if cmd == "init":
                model_id = rest[0] if rest else cfg.model_id
                shards = int(rest[1]) if len(rest) > 1 else cfg.checkpoint.num_shards
                # Conversion and the store write are host work: off the loop,
                # so the workers' heartbeats keep being answered.
                store_dir = await asyncio.to_thread(init_store, model_id,
                                                    shards, cfg)
            elif cmd == "assign":
                shards = int(rest[0]) if rest else cfg.checkpoint.num_shards
                policy = rest[1] if len(rest) > 1 else "capacity"
                plan = coord.plan_shards(
                    shards, store_dir=store_dir or cfg.checkpoint.shard_dir,
                    policy=policy,
                )
                print(json.dumps({str(k): v for k, v in plan.items()}, indent=1))
            elif cmd == "distribute":
                t0 = time.perf_counter()
                placed = await coord.place_shards()
                print(json.dumps(placed, indent=1))
                print(f"[placed in {time.perf_counter() - t0:.2f} s]")
            elif cmd == "rebalance":
                plan = await coord.rebalance()
                print(json.dumps({str(k): v for k, v in plan.items()}, indent=1))
            elif cmd == "inference":
                text = await _ainput("prompt: ")
                out = await coord.generate([text])
                print(out["text"][0])
                print(f"[{out['generated_tokens']} tokens, "
                      f"{out['tokens_per_second']:.1f} tok/s]")
            elif cmd == "batch":
                # Mixed-budget batch: N lines of "<max_new_tokens> <prompt>",
                # blank line ends; served via continuous batching.
                print("one request per line: <max_new_tokens> <prompt>; "
                      "blank line runs the batch")
                reqs = []
                while True:
                    line2 = (await _ainput("req: ")).strip()
                    if not line2:
                        break
                    n_str, _, ptext = line2.partition(" ")
                    try:
                        n_new = int(n_str)
                    except ValueError:
                        n_new = 0
                    if n_new < 1 or not ptext.strip():
                        # Don't let one malformed line discard the batch.
                        print(f"expected '<max_new_tokens> <prompt>' with a "
                              f"positive budget, got {line2!r}; line skipped")
                        continue
                    reqs.append({"prompt": ptext, "max_new_tokens": n_new})
                if reqs:
                    out = await coord.generate_requests(reqs)
                    for i, t in enumerate(out["text"]):
                        print(f"[{i}] {json.dumps(t)}")
                    print(f"[{out['generated_tokens']} tokens, "
                          f"{out['tokens_per_second']:.1f} tok/s]")
            elif cmd == "status":
                print(json.dumps(coord.status(), indent=1))
            elif cmd == "metrics":
                print(json.dumps(METRICS.snapshot(), indent=1))
            elif cmd in ("exit", "quit"):
                break
            else:
                print(f"unknown command {cmd!r}")
        except Exception as e:
            print(f"error: {e}")


async def amain(args: argparse.Namespace) -> None:
    import dataclasses

    cfg = load_config(args.config, args.override)
    ccfg = dataclasses.replace(
        cfg.cluster,
        coordinator_host=args.host or cfg.cluster.coordinator_host,
        coordinator_port=args.port if args.port is not None else cfg.cluster.coordinator_port,
        metrics_port=args.metrics_port if args.metrics_port is not None
        else cfg.cluster.metrics_port,
    )
    coord = Coordinator(ccfg)
    await coord.start()
    local_tasks = []
    procs = []
    if args.local:
        for _ in range(args.local):
            w = WorkerHost("127.0.0.1", coord.port, cfg=ccfg, rt=cfg.runtime,
                           mesh_cfg=cfg.mesh, device=args.device)
            local_tasks.append(asyncio.create_task(w.run()))
        log.info("spawned %d local in-process workers", args.local)
    if args.local_proc:
        # Process isolation: each worker is a separate interpreter running
        # the host entry point.
        for _ in range(args.local_proc):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "distributed_llms_tpu_torch.cli.host_main",
                 "--host", "127.0.0.1", "--port", str(coord.port),
                 *(["--device", args.device] if args.device else []),
                 *(["--config", args.config] if args.config else []),
                 *(x for ov in args.override for x in ("--override", ov))],
            ))
        log.info("spawned %d local worker processes", args.local_proc)
    expected = args.local + args.local_proc
    if expected:
        # Don't hand the REPL (or a piped script) over until the local
        # workers are registered: the first `assign` would race them.
        for _ in range(600):
            if len(coord.workers) >= expected:
                break
            await asyncio.sleep(0.1)
        else:
            log.warning(
                "only %d/%d local workers registered", len(coord.workers), expected
            )
    try:
        if args.serve:
            # Headless daemon mode: a container has no interactive stdin.
            # As PID 1, Python's default SIGTERM action would kill the
            # interpreter before the cleanup below runs; catch it.
            import signal

            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop.set)
            log.info("serving headless (no REPL); SIGTERM/Ctrl-C stops")
            await stop.wait()
            log.info("stop signal received; shutting down")
        else:
            await repl(coord, cfg)
    finally:
        for t in local_tasks:
            t.cancel()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                await asyncio.to_thread(p.wait, 30)
            except subprocess.TimeoutExpired:
                p.kill()
        await coord.stop()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="distributed-llms coordinator (PyTorch port)")
    ap.add_argument("--config", default=None, help="JSON/YAML config file")
    ap.add_argument("--override", action="append", default=[], metavar="K=V",
                    help="dotted config override, e.g. runtime.paged_pages=256")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (+/healthz, /status) here")
    ap.add_argument("--serve", action="store_true",
                    help="headless daemon mode (no REPL), for containers "
                         "where stdin is closed; default is the interactive "
                         "REPL, which also accepts piped command scripts")
    ap.add_argument("--local", type=int, default=0, metavar="N",
                    help="run N workers in this process")
    ap.add_argument("--local-proc", type=int, default=0, metavar="N",
                    help="spawn N worker processes (dlt-host-torch)")
    ap.add_argument("--device", default=None,
                    help="the workers' torch device (default: cuda; 'cpu' "
                         "runs them on the CPU explicitly)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
