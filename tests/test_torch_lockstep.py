"""Lockstep determinism of the port's scheduling decisions: the counterpart
of tests/runtime/test_lockstep.py.

Every rank of a mesh takes every scheduling decision from the same state,
so a decision may not depend on hash or set order: ``PYTHONHASHSEED``
differs per process unless pinned.  The reference's scenario (tenant-fair
admission with client-minted tenant strings, the mixed policy's bite and
victim hooks, the speculative round clamp, the sync triggers) replays
against the port's ``runtime/scheduler.py`` in fresh interpreters under
PYTHONHASHSEED 0 and 1: the traces must be byte-identical to each other
and to the reference's.  A second scenario drives the port's batcher
itself (tenants, priorities, a dry paged pool that preempts, swaps and
restores) and prints its admission order, preemptions and streams.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _reference_driver() -> str:
    """The reference test's scenario (its ``DRIVER`` string), read from
    tests/runtime/test_lockstep.py."""
    tree = ast.parse((ROOT / "tests" / "runtime" / "test_lockstep.py")
                     .read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "DRIVER":
            return ast.literal_eval(node.value)
    raise AssertionError("no DRIVER in the reference's lockstep test")


DRIVER = _reference_driver()

BATCHER_DRIVER = '''
import sys
import torch
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime.batcher import ContinuousBatcher

torch.set_num_threads(1)
cfg = get_preset("llama-tiny", vocab_size=512)
g = torch.Generator()
g.manual_seed(0)
params = tm.init_params(cfg, generator=g)
b = ContinuousBatcher(cfg, params, batch_slots=3, max_len=64, chunk_steps=4,
                      page_size=16, paged_pages=9, host_pages=16,
                      prefix_cache=True, tenant_weights="gold:4,free:1,zinc:2",
                      tenant_max_rows=2)
order = []
orig = b._activate_row
def spy(i, req, *a, **k):
    order.append((req.rid, req.tenant, i))
    return orig(i, req, *a, **k)
b._activate_row = spy
tenants = ["gold", "free", "bronze", None, "gold", "zinc", "free", "iron"]
rids = [b.submit([3 + i, 1, 4, 1, 5, 9][: 3 + i % 3], max_new_tokens=24,
                 tenant=t, priority=i % 3) for i, t in enumerate(tenants)]
res = b.run()
print("order", order)
print("preemptions", b.preemptions)
print("streams", [res[r] for r in rids])
'''


def _trace(tmp_path: Path, driver: str, hashseed: str) -> str:
    path = tmp_path / f"driver_{abs(hash(driver))}.py"
    path.write_text(driver, encoding="utf-8")
    env = dict(os.environ, PYTHONHASHSEED=hashseed, PYTHONPATH=str(ROOT),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(path)], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_scheduler_traces_identical_across_seeds_and_to_the_reference(
        tmp_path):
    port = DRIVER.replace("from distributed_llms_tpu.runtime.scheduler",
                          "from distributed_llms_tpu_torch.runtime.scheduler")
    assert port != DRIVER
    t0 = _trace(tmp_path, port, "0")
    t1 = _trace(tmp_path, port, "1")
    assert t0.count("admit rid=") == 10 and "sync " in t0
    assert t0 == t1, "port decisions diverged under PYTHONHASHSEED skew"
    assert t0 == _trace(tmp_path, DRIVER, "0"), "port trace != reference"


def test_batcher_decisions_identical_across_seeds(tmp_path):
    t0 = _trace(tmp_path, BATCHER_DRIVER, "0")
    t1 = _trace(tmp_path, BATCHER_DRIVER, "1")
    assert "order" in t0 and "preemptions" in t0
    assert t0 == t1, ("batcher decisions diverged under PYTHONHASHSEED "
                      "skew:\n" + t0 + "\n" + t1)
