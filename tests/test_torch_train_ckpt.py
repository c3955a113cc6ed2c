"""Training-state checkpoints of the port (``runtime/train_ckpt.py``): the
four cases of tests/runtime/test_train_ckpt.py, the commit-marker
contract, and a restore onto a tensor-parallel mesh.

- save, list, restore: parameters bit-identical, and the next step's loss
  after a restore equals the uninterrupted run's;
- ``keep`` prunes the oldest committed checkpoints, a directory without
  its marker is ignored and never deleted, and restoring it raises;
- a restore with ``parallel=`` gives each rank of a model=2 mesh its block
  of every parameter and of both AdamW moments;
- a missing checkpoint raises ``FileNotFoundError``; the files load with
  ``torch.load(weights_only=True)``.

The loss is also held against the JAX package's checkpointed run
(``Trainer`` + optax, restored through Orbax) on the same weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import train as jtrain
from distributed_llms_tpu.runtime import train_ckpt as jckpt
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.core.mesh import build_mesh
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.parallel import api as tapi
from distributed_llms_tpu_torch.parallel import specs as tspecs
from distributed_llms_tpu_torch.runtime import train as ttrain
from distributed_llms_tpu_torch.runtime import train_ckpt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg_j = jax_preset("llama-tiny")
    pj = jm.init_params(jax.random.key(0), cfg_j)
    return cfg_j, get_preset("llama-tiny"), pj, jax.tree.map(np.asarray, pj)


def _tokens(cfg, key=1, batch=4):
    return np.array(jax.random.randint(jax.random.key(key), (batch, 17), 0,
                                       cfg.vocab_size, dtype=jnp.int32))


def _setup(weights):
    _, cfg, _, pn = weights
    params = params_from_numpy(pn, cfg, device="cpu")
    trainer = ttrain.Trainer(cfg, ttrain.default_optimizer(1e-2))
    return cfg, params, trainer


def test_save_restore_roundtrip(weights, tmp_path):
    cfg, params, trainer = _setup(weights)
    opt = trainer.init(params)
    step = trainer.make_step()
    params, opt, _ = step(params, opt, torch.as_tensor(_tokens(cfg)), None)
    train_ckpt.save_train_state(str(tmp_path), 1, params, opt)
    assert train_ckpt.latest_step(str(tmp_path)) == 1
    s, p2, o2 = train_ckpt.restore_train_state(str(tmp_path))
    assert s == 1 and o2["count"] == opt["count"] == 1
    for a, b in zip(ttrain._leaves(params), ttrain._leaves(p2)):
        assert torch.equal(a, b)
    for a, b in zip(opt["mu"] + opt["nu"], o2["mu"] + o2["nu"]):
        assert torch.equal(a, b)
    toks2 = torch.as_tensor(_tokens(cfg, key=2))
    _, _, loss_resumed = step(p2, o2, toks2, None)
    _, _, loss_cont = step(params, opt, toks2, None)
    assert float(loss_resumed) == float(loss_cont)


def test_resumed_loss_matches_the_reference(weights, tmp_path):
    """Two steps, save, restore, a third step: the loss equals the JAX
    package's same run through its own checkpoint."""
    cfg_j, cfg, pj, _ = weights
    jt = jtrain.Trainer(cfg_j, jtrain.default_optimizer(1e-2))
    jstep = jt.make_step()
    jp, jo = pj, jt.init(pj)
    cfg, params, trainer = _setup(weights)
    step = trainer.make_step()
    opt = trainer.init(params)
    for key in (1, 2):
        toks = _tokens(cfg, key=key)
        jp, jo, _ = jstep(jp, jo, jnp.asarray(toks), None)
        params, opt, _ = step(params, opt, torch.as_tensor(toks), None)
    jckpt.save_train_state(str(tmp_path / "jax"), 2, jp, jo)
    train_ckpt.save_train_state(str(tmp_path / "torch"), 2, params, opt)
    _, jp2, jo2 = jckpt.restore_train_state(str(tmp_path / "jax"))
    _, p2, o2 = train_ckpt.restore_train_state(str(tmp_path / "torch"))
    toks = _tokens(cfg, key=3)
    _, _, jloss = jstep(jp2, jo2, jnp.asarray(toks), None)
    _, _, loss = step(p2, o2, torch.as_tensor(toks), None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_restore_onto_a_tensor_parallel_mesh(weights, tmp_path):
    cfg, params, trainer = _setup(weights)
    opt = trainer.init(params)
    params, opt, _ = trainer.make_step()(params, opt,
                                         torch.as_tensor(_tokens(cfg)), None)
    train_ckpt.save_train_state(str(tmp_path), 7, params, opt)
    for rank in range(2):
        mcfg = MeshConfig(model=2)
        pm = tapi.make_parallel_model(
            cfg, mcfg, mesh=build_mesh(mcfg, rank=rank, world_size=2))
        s, p2, o2 = train_ckpt.restore_train_state(str(tmp_path),
                                                   parallel=pm)
        assert s == 7
        want = pm.shard_params(params)
        rules = ttrain._leaves(tspecs.param_specs(cfg, pm.mesh))
        for a, b in zip(ttrain._leaves(want), ttrain._leaves(p2)):
            assert torch.equal(a, b)
        assert p2["blocks"]["attn"]["wq"].shape == (4, 64, 2, 16)
        for moments, got in ((opt["mu"], o2["mu"]), (opt["nu"], o2["nu"])):
            for full, rule, part in zip(moments, rules, got):
                assert torch.equal(tspecs.local_slice(full, rule, pm.mesh),
                                   part)


def test_keep_prunes_and_uncommitted_is_ignored(weights, tmp_path):
    cfg, params, trainer = _setup(weights)
    opt = trainer.init(params)
    for s in range(5):
        train_ckpt.save_train_state(str(tmp_path), s, params, opt, keep=2)
    assert train_ckpt.list_checkpoints(str(tmp_path)) == [
        "step_00000003", "step_00000004"]
    # A directory without its marker (a save in flight, foreign data): not
    # listed, not pruned, not restorable.
    foreign = tmp_path / "step_00000009"
    foreign.mkdir()
    (foreign / "params.pt").write_bytes(b"partial")
    assert train_ckpt.latest_step(str(tmp_path)) == 4
    train_ckpt.save_train_state(str(tmp_path), 5, params, opt, keep=1)
    assert train_ckpt.list_checkpoints(str(tmp_path)) == ["step_00000005"]
    assert foreign.exists()
    with pytest.raises(RuntimeError, match="COMMITTED"):
        train_ckpt.restore_train_state(str(tmp_path), step=9)


def test_files_are_weights_only_and_the_marker_is_last(weights, tmp_path):
    cfg, params, trainer = _setup(weights)
    path = train_ckpt.save_train_state(str(tmp_path), 3, params,
                                       trainer.init(params))
    names = sorted(os.listdir(path))
    assert names == ["COMMITTED", "opt_state.pt", "params.pt"]
    marker_t = os.stat(os.path.join(path, "COMMITTED")).st_mtime_ns
    assert all(os.stat(os.path.join(path, n)).st_mtime_ns <= marker_t
               for n in names)
    torch.load(os.path.join(path, "params.pt"), weights_only=True)
    torch.load(os.path.join(path, "opt_state.pt"), weights_only=True)


def test_restore_missing_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        train_ckpt.restore_train_state(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        train_ckpt.restore_train_state(str(tmp_path), step=3)
