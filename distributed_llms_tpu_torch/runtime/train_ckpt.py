"""Training-state checkpoint and resume (PyTorch port of
``distributed_llms_tpu/runtime/train_ckpt.py``).

The reference saves through Orbax; here a step's state is plain
``torch.save`` files under ``ckpt_dir/step_<n>``: the parameters
(``params.pt``, the parameter tree of tensors) and the AdamW state
(``opt_state.pt``: the step count and the two moment lists in
``runtime.train._leaves`` order), both read back with
``torch.load(weights_only=True)``, so a checkpoint can hold tensors and
plain containers only.  The reference's commit contract holds:

- the commit marker (``COMMITTED``, holding the step) is written LAST, by
  an atomic rename of a synced temporary file;
- :func:`list_checkpoints` ignores directories without it, and never
  deletes them (another writer's save in flight, or foreign data);
- ``keep`` prunes the oldest committed checkpoints.

:func:`restore_train_state` onto a mesh (``parallel=``) gives each rank its
block of every parameter and of its two moments (``parallel/specs.py``);
:func:`save_train_state` of a mesh-trained state (``parallel=``) gathers
every leaf whole over the lines that shard it, and rank 0 writes it, so a
checkpoint is the same files whatever mesh wrote it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch

_MARKER = "COMMITTED"
_PARAMS = "params.pt"
_OPT = "opt_state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _write(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _gathered(params: Any, opt_state: dict, parallel: Any) -> tuple:
    """The whole tree and moments from every rank's blocks (collective)."""
    from ..parallel import specs as specs_lib
    from .train import _leaves

    mesh = parallel.mesh

    def walk(t, rules):
        if isinstance(t, dict):
            return {k: walk(v, rules[k]) for k, v in t.items()}
        return specs_lib.gather_leaf(t, rules, mesh)

    rules = _leaves(parallel.rules)
    return walk(params, parallel.rules), {
        "count": opt_state["count"],
        "mu": [specs_lib.gather_leaf(t, r, mesh)
               for t, r in zip(opt_state["mu"], rules)],
        "nu": [specs_lib.gather_leaf(t, r, mesh)
               for t, r in zip(opt_state["nu"], rules)]}


def save_train_state(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                     keep: int = 3, parallel: Any = None) -> str:
    """Write ``step``'s training state under ``ckpt_dir/step_<n>``, commit
    it, and prune to the newest ``keep`` committed checkpoints.  Returns
    the written path.  With ``parallel`` (the ``ParallelModel`` the state
    was trained on; every rank calls it) the whole tree is gathered and
    rank 0 writes it; every rank returns once it is committed."""
    if parallel is not None and parallel.mesh.world_size > 1:
        import torch.distributed as dist

        params, opt_state = _gathered(params, opt_state, parallel)
        path = _step_dir(ckpt_dir, step)
        if parallel.mesh.rank == 0:
            save_train_state(ckpt_dir, step, params, opt_state, keep)
        dist.barrier()
        return path
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, _MARKER)
    if os.path.exists(marker):
        os.unlink(marker)  # rewriting a step: uncommitted until it is whole
    _write(_cpu(params), os.path.join(path, _PARAMS))
    _write({"count": int(opt_state["count"]), "mu": _cpu(opt_state["mu"]),
            "nu": _cpu(opt_state["nu"])}, os.path.join(path, _OPT))
    tmp = marker + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{step}\n")
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, marker)
    for old in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(os.path.abspath(ckpt_dir), old),
                      ignore_errors=True)
    return path


def _is_committed(step_dir: str) -> bool:
    return os.path.exists(os.path.join(step_dir, _MARKER))


def list_checkpoints(ckpt_dir: str) -> list[str]:
    """Committed ``step_<n>`` directory names, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and _is_committed(os.path.join(ckpt_dir, d))
    )


def latest_step(ckpt_dir: str) -> int | None:
    names = list_checkpoints(ckpt_dir)
    return int(names[-1][len("step_"):]) if names else None


def restore_train_state(ckpt_dir: str, step: int | None = None,
                        device: "str | torch.device | None" = None,
                        parallel: Any = None) -> tuple[int, Any, Any]:
    """Restore (step, params, opt_state); ``step=None`` takes the latest.
    Tensors land on ``device`` (None: where they were saved from, the
    CPU), or, with ``parallel`` (a ``parallel.api.ParallelModel``), each
    rank's block on its device."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if not _is_committed(path):
        raise RuntimeError(
            f"checkpoint at {path} has no {_MARKER} marker: the save "
            "crashed before committing")
    params = torch.load(os.path.join(path, _PARAMS), weights_only=True,
                        map_location="cpu")
    opt = torch.load(os.path.join(path, _OPT), weights_only=True,
                     map_location="cpu")
    if parallel is not None:
        from ..parallel import specs as specs_lib
        from .train import _leaves

        rules = specs_lib.param_specs(parallel.cfg, parallel.mesh)
        flat = _leaves(rules)
        cut = [lambda t, r=r: specs_lib.local_slice(t, r, parallel.mesh)
               for r in flat]
        params = specs_lib.shard_tree(params, rules, parallel.mesh)
        opt["mu"] = [f(t) for f, t in zip(cut, opt["mu"])]
        opt["nu"] = [f(t) for f, t in zip(cut, opt["nu"])]
        device = parallel.device
    if device is not None:
        params = _to(params, device)
        opt["mu"] = [t.to(device) for t in opt["mu"]]
        opt["nu"] = [t.to(device) for t in opt["nu"]]
    return step, params, opt


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
