"""The port's mesh training step (``Trainer(parallel=)``) against the JAX
package's on its CPU fake mesh (tests/conftest.py), and training
checkpoints of a mesh-trained state.

The port runs on worlds of 2 and 4 spawned gloo ranks
(``torch_world.py``), every rank fed the same batch; the reference runs
``Trainer(cfg, default_optimizer(lr), parallel=make_parallel_model(...))``
on the same weights and batch.  llama-tiny (vocab 512) at ``data=2``,
``model=2`` and ``(data=2, model=2)``; moe-tiny (vocab 512) at
``expert=2`` and ``(model=2, expert=2)``; float32.

- Before the first step, the gradients' global norm (each rank's blocks,
  each sharded leaf's squares summed over its lines, each replicated leaf
  once) against optax's ``global_norm`` of the reference's gradients of
  the whole tree: rtol 1e-5.  Every case's norm is above 1, so each step
  is clipped across shards.
- Every step's loss, and every parameter gathered whole after the first
  and after the third step, against the reference's: atol = rtol = 1e-5
  (the bound of ``test_torch_train.py``'s losses).  lr 1e-4: Adam
  normalises each entry by its own ``sqrt(nu)``, so an entry whose
  gradient is float32 rounding noise in both stacks moves by a share of
  lr that follows the noise.  Measured on these cases: at lr 1e-2 and at
  lr 1e-3 a few entries after the first step differ by 2.0e-5 to 3.0e-5
  (0.2% and 2.5% of lr), at lr 1e-4 none is past the bound; a gradient of
  the wrong sign still moves an entry by 2 lr.
- A step whose rows split over 'data' sums the gradients over that line;
  an MoE model never splits (every rank routes every row).
- A state saved from the expert mesh (gathered, rank 0 writing) restores
  onto the same mesh leaf for leaf, and onto one device as the whole tree
  the ranks gathered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_expert_cases as cases
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.runtime import train as jt
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import train_ckpt
from torch_world import World

TOL = dict(atol=1e-5, rtol=1e-5)
LR = 1e-4
STEPS = 3
CASES = {"dp2": ("llama", {"data": 2}), "tp2": ("llama", {"model": 2}),
         "dp2tp2": ("llama", {"data": 2, "model": 2}),
         "ep2": ("moe", {"expert": 2}),
         "tp2ep2": ("moe", {"model": 2, "expert": 2})}


def _model(preset, seed):
    cfg_j = jax_preset(preset, vocab_size=512)
    cfg_t = get_preset(preset, vocab_size=512)
    pj = jm.init_params(jax.random.key(seed), cfg_j)
    return cfg_j, cfg_t, jax.tree.map(np.asarray, pj)


@pytest.fixture(scope="module")
def models():
    return {"llama": _model("llama-tiny", 0), "moe": _model("moe-tiny", 1)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, models):
    made: dict = {}

    def get(n):
        if n not in made:
            w = World(n, str(tmp_path_factory.mktemp(f"train_world{n}")))
            for key, (_, cfg_t, pn) in models.items():
                w.run(cases.load, key, cfg_t, pn)
            made[n] = w
        return made[n]

    yield get
    for w in made.values():
        w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, b=2, t=17):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    return toks, mask


def _size(mesh):
    return int(np.prod(list(mesh.values())))


_NORMS: dict = {}


def _reference_norm(key, cfg_j, pn, toks, mask) -> float:
    """optax's global norm of the reference's gradients of the whole tree
    (one device; the same for every mesh of a model)."""
    if key not in _NORMS:
        grads = jax.grad(jt.lm_loss)(jax.tree.map(jnp.asarray, pn), cfg_j,
                                     jnp.asarray(toks), jnp.asarray(mask))
        _NORMS[key] = float(optax.global_norm(grads))
    return _NORMS[key]


def _reference(cfg_j, pn, mesh, devices8, toks, mask):
    """The reference's losses and parameters after step 1 and after the
    last."""
    pj = jax.tree.map(jnp.asarray, pn)
    pm = japi.make_parallel_model(cfg_j, JMeshConfig(**mesh),
                                  devices=devices8[:_size(mesh)])
    tr = jt.Trainer(cfg_j, jt.default_optimizer(LR), parallel=pm)
    params = pm.shard_params(pj)
    state, step = tr.init(params), tr.make_step()
    losses, after = [], {}
    for i in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(toks),
                                   jnp.asarray(mask))
        losses.append(float(loss))
        if i + 1 in (1, STEPS):
            after[i + 1] = {
                "/".join(k.key for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]}
    return losses, after


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_the_reference_trainer(models, worlds, devices8,
                                                name):
    key, mesh = CASES[name]
    cfg_j, cfg_t, pn = models[key]
    toks, mask = _batch()
    norm = _reference_norm(key, cfg_j, pn, toks, mask)
    assert norm > 1.0  # the first step clips
    losses, after = _reference(cfg_j, pn, mesh, devices8, toks, mask)
    outs = worlds(_size(mesh)).run(cases.train_steps, key, mesh, toks, mask,
                                   LR, STEPS)
    split = mesh.get("data", 1) > 1 and key == "llama"
    for out in outs:
        assert out["splits_rows"] == split
        np.testing.assert_allclose(out["norm"], norm, rtol=1e-5)
        np.testing.assert_allclose(out["losses"], losses, **TOL)
        assert out["losses"][-1] < out["losses"][0]
        for at in (1, STEPS):
            got = out["after"][at]
            assert set(got) == set(after[at])
            for path, want in after[at].items():
                np.testing.assert_allclose(got[path], want, **TOL,
                                           err_msg=f"{path} after {at}")
    # Every rank gathers the same whole tree.
    for out in outs[1:]:
        for path, leaf in out["after"][STEPS].items():
            assert np.array_equal(leaf, outs[0]["after"][STEPS][path])


def test_a_save_from_the_expert_mesh_restores_anywhere(models, worlds,
                                                       tmp_path):
    ckpt = str(tmp_path / "ckpt")
    outs = worlds(2).run(cases.train_steps, "moe", {"expert": 2},
                         *_batch(1), LR, 1, ckpt_dir=ckpt)
    for out in outs:
        assert out["restored"] == {"step": 1, "count": True, "params": True,
                                   "moments": True}
    # Onto one device: the whole tree the ranks gathered.
    step, params, opt = train_ckpt.restore_train_state(ckpt, device="cpu")
    assert step == 1 and opt["count"] == 1
    whole = outs[0]["after"][1]

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{path}/{k}" if path else k)
        else:
            yield path, t

    got = dict(walk(params))
    assert set(got) == set(whole)
    for path, leaf in got.items():
        assert np.array_equal(leaf.numpy(), whole[path]), path
    cfg = get_preset("moe-tiny", vocab_size=512)
    assert tuple(params["blocks"]["mlp"]["w_gate"].shape) == (
        cfg.num_layers, cfg.num_experts, cfg.hidden_size,
        cfg.intermediate_size)
