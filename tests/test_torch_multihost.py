"""Several processes, one mesh: the counterpart of
tests/cluster/test_multihost.py for the port.

- ``cluster/distributed.py`` ``initialize_distributed``: a no-op for one
  process, the reference's ``ValueError`` without a coordinator address,
  and two real processes joining one gloo group over TCP (the backend
  chosen from the layout: no GPU here) and summing across it.
- The control plane's multi-process leg: two ``dlt-host-torch``
  processes (``cluster.num_processes=2``, a ``model=2`` mesh) register
  with an in-process ``Coordinator`` reporting ``process_count`` 2, place
  their rank's shard of a store, and serve ``generate_spmd`` and a
  mixed-budget ``generate_requests`` in lockstep: the texts equal the
  JAX package's single-process engine's.
- ``dlt-serve-torch`` on two ranks (``mesh.model=2``): rank 0 serves HTTP,
  rank 1 follows its journal; greedy completions equal one process's.

Ports come from the OS (bind to port 0), never fixed; every child has a
time limit.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import pytest
import torch

from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.core.config import RuntimeConfig as JRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llms_tpu_torch.cluster.coordinator import Coordinator
from distributed_llms_tpu_torch.cluster.distributed import (
    choose_backend, initialize_distributed)
from distributed_llms_tpu_torch.core.config import ClusterConfig

ROOT = Path(__file__).resolve().parents[1]
CHILD_ENV = {**{k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
             "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    cfg = jax_preset("llama-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(0), cfg)
    path = str(tmp_path_factory.mktemp("multihost_store"))
    jstore.save_shards(params, path, num_shards=2, model_config=cfg)
    return path


def test_one_process_is_a_no_op_and_two_need_a_coordinator():
    assert initialize_distributed(ClusterConfig()) is None
    with pytest.raises(ValueError, match="distributed_coordinator"):
        initialize_distributed(ClusterConfig(num_processes=2))


def test_backend_follows_the_layout(monkeypatch):
    assert choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(2) == "gloo"  # two ranks share one GPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend(2) == "nccl"


CHILD = """
import sys
import torch
import torch.distributed as dist
from distributed_llms_tpu_torch.cluster.distributed import initialize_distributed
from distributed_llms_tpu_torch.core.config import ClusterConfig
rank, port = int(sys.argv[1]), int(sys.argv[2])
backend = initialize_distributed(ClusterConfig(
    num_processes=2, process_id=rank,
    distributed_coordinator=f"127.0.0.1:{port}"), device="cpu",
    timeout_s=60)
x = torch.full((2,), float(rank + 1))
dist.all_reduce(x)
print("CHILD_OK", backend, dist.get_rank(), dist.get_world_size(),
      x.tolist(), flush=True)
dist.destroy_process_group()
"""


def test_two_processes_join_one_group():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=CHILD_ENV, cwd=ROOT)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert f"CHILD_OK gloo {r} 2 [3.0, 3.0]" in out, out[-2000:]


def _host(rank: int, dist_port: int, coord_port: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_llms_tpu_torch.cli.host_main",
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(coord_port),
         "--worker-id", f"rank-{rank}",
         "--override", "cluster.num_processes=2",
         "--override", f"cluster.process_id={rank}",
         "--override", f"cluster.distributed_coordinator=127.0.0.1:{dist_port}",
         "--override", "cluster.heartbeat_interval_s=0.2",
         "--override", "mesh.model=2",
         "--override", "runtime.max_decode_steps=8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=CHILD_ENV, cwd=ROOT)


async def test_two_process_generate_roundtrip(store):
    """Two worker processes form one model=2 mesh, place their shards of a
    store and serve one GENERATE dispatched to both at once; then a
    mixed-budget batch through the mesh batcher.  Texts equal the JAX
    package's single-process engine's."""
    coord = Coordinator(ClusterConfig(
        coordinator_host="127.0.0.1", coordinator_port=0,
        heartbeat_interval_s=0.2, heartbeat_timeout_s=60.0,
        task_timeout_s=120.0))
    await coord.start()
    dist_port = _free_port()
    procs = [_host(r, dist_port, coord.port) for r in range(2)]
    try:
        for _ in range(600):
            if len(coord.workers) == 2:
                break
            assert all(p.poll() is None for p in procs), "a worker died"
            await asyncio.sleep(0.1)
        assert len(coord.workers) == 2, list(coord.workers)
        assert all(w.capabilities["process_count"] == 2
                   for w in coord.workers.values())
        coord.plan_shards(2, store_dir=store)
        placed = await coord.place_shards(timeout=120.0)
        assert all("mesh" in r.get("resident", "") for r in placed.values()), \
            placed

        ref = JEngine.from_store(store, rt=JRuntimeConfig(max_decode_steps=8))
        out = await coord.generate_spmd(["hello multi host"], max_new_tokens=8)
        assert out["text"] == ref.generate_text(["hello multi host"],
                                                max_new_tokens=8).text
        mixed = [{"prompt": "hello multi host", "max_new_tokens": 3},
                 {"prompt": "second request", "max_new_tokens": 8}]
        out2 = await coord.generate_requests(mixed, timeout=120.0)
        for i, req in enumerate(mixed):
            want = ref.generate_text([req["prompt"]],
                                     max_new_tokens=req["max_new_tokens"])
            assert out2["text"][i] == want.text[0], (i, out2["text"])
        for wid in list(coord.workers):
            await coord.submit("SHUTDOWN", {}, worker_id=wid, timeout=30.0)
        outs = [await asyncio.to_thread(lambda p=p: p.communicate(
            timeout=60)[0]) for p in procs]
        for p, log in zip(procs, outs):
            assert p.returncode == 0, log[-2000:]
            assert "torch.distributed init: backend=gloo" in log, log[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        await coord.stop()


def _serve(port: int, extra: list[str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_llms_tpu_torch.cli.serve_main",
         "--device", "cpu", "--port", str(port), "--paged-pages", "40",
         "--page-size", "16", "--prefix-cache", "--max-len", "128",
         "--slots", "4", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=CHILD_ENV,
        cwd=ROOT)


def _complete(port: int, prompt: str) -> str:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": prompt, "max_tokens": 12,
                         "temperature": 0}).encode())
    return json.load(urllib.request.urlopen(req, timeout=30))[
        "choices"][0]["text"]


def _ready(proc, deadline: float) -> str:
    """Read a server's log until it says it is ready (or fail at the
    deadline, or when it exits); returns what it read."""
    import selectors

    fd = proc.stdout.fileno()
    sel = selectors.DefaultSelector()
    sel.register(fd, selectors.EVENT_READ)
    seen = b""
    while b"ready on http" not in seen:
        left = deadline - time.monotonic()
        assert left > 0 and sel.select(timeout=left), "no server was ready"
        chunk = os.read(fd, 65536)
        assert chunk, "a server exited before it was ready:\n" + seen.decode()
        seen += chunk
    return seen.decode()


def test_serve_on_two_ranks_matches_one_process(store):
    dist_port, mesh_port, one_port = _free_port(), _free_port(), _free_port()
    ranks = [_serve(mesh_port, [
        "--store", store, "--override", "mesh.model=2",
        "--override", "cluster.num_processes=2",
        "--override", f"cluster.process_id={r}",
        "--override", f"cluster.distributed_coordinator=127.0.0.1:{dist_port}"])
        for r in range(2)]
    one = _serve(one_port, ["--store", store])
    procs = ranks + [one]
    try:
        deadline = time.monotonic() + 90
        _ready(ranks[0], deadline)
        _ready(one, deadline)
        prompts = ["hello world", "the quick brown fox", "hello world again"]
        got = [_complete(mesh_port, p) for p in prompts]
        assert got == [_complete(one_port, p) for p in prompts]
    finally:
        for p in procs:
            p.terminate()
        outs = [p.communicate(timeout=60)[0].decode() for p in procs]
    assert "following rank 0" in outs[1], outs[1][-2000:]
    assert "rank 0 stopped serving" in outs[1], outs[1][-2000:]


def test_serve_mesh_must_match_the_world(store):
    """A mesh whose size is not the group's fails at boot."""
    p = _serve(_free_port(), ["--store", store, "--override", "mesh.model=2"])
    out = p.communicate(timeout=60)[0].decode()
    assert p.returncode != 0
    assert "needs 2 processes, got 1" in out, out[-2000:]
