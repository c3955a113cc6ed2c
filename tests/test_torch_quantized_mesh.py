"""Weight-only quantized serving on a data x tensor-parallel mesh: the
counterpart of tests/parallel/test_quantized_mesh.py.

The JAX package writes an int8 or int4 store (quant_block 32) of
llama-tiny; the port's mesh engine (``from_store(mesh_cfg=)`` with
``serve_quantized``) on a world of 4 spawned gloo ranks keeps the block
weights quantized at each rank's local shape — output-sharded leaves
(q/k/v, gate/up) run as they are, contracted-sharded ones (``wo``,
``w_down``) give partial products the layer sums over 'model' — with the
scales refined where a shard edge splits a block (model 4 over
intermediate 176: 44 % 32, 4-wide blocks), and generates the reference's
single-device quantized engine's tokens.  A legacy int4 store (no
``pack_axis`` in its manifest: pairs along the last axis) serves the same
tokens after its exact repack at load.
"""

import json
import os

import jax
import pytest
import torch

import torch_mesh_cases as cases
from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.core.config import RuntimeConfig as JRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from torch_world import World

PROMPTS = ["hello quantized mesh", "a second row"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("qmesh_world")))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    cfg = jax_preset("llama-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(0), cfg)
    out = {}
    for q in ("int8", "int4"):
        path = str(tmp_path_factory.mktemp(f"qstore_{q}"))
        jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                           quantization=q, quant_block=32)
        out[q] = path
    # A legacy int4 store: the same codes re-packed along the last axis,
    # the manifest without pack_axis (what stores written before the key
    # held).
    legacy = str(tmp_path_factory.mktemp("qstore_legacy"))
    from distributed_llms_tpu.checkpoint import quantize as jq

    def repack(tree, path=""):
        if isinstance(tree, dict):
            return {k: repack(v, f"{path}/{k}") for k, v in tree.items()}
        if not path.startswith("/blocks") or tree.ndim < 3:
            return tree
        return jq.quantize(tree, bits=4, block=32, pack_axis=-1)

    qparams = {k: (repack(v, f"/{k}") if k == "blocks" else v)
               for k, v in params.items()}
    jstore.save_shards(qparams, legacy, num_shards=2, model_config=cfg)
    man_path = os.path.join(legacy, "manifest.json")
    man = json.load(open(man_path))
    man["quantization"] = "int4"
    for entry in man["params"].values():
        entry.pop("pack_axis", None)
    json.dump(man, open(man_path, "w"))
    out["legacy"] = legacy
    return out


def _reference_tokens(path):
    eng = JEngine.from_store(path, rt=JRuntimeConfig(max_decode_steps=6,
                                                     serve_quantized=True))
    return eng.generate_text(PROMPTS, max_new_tokens=6).tokens.tolist()


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: f"dp{m[0]}tp{m[1]}")
@pytest.mark.parametrize("kind", ["int8", "int4", "legacy"])
def test_mesh_serves_quantized_resident(world, stores, kind, mesh):
    want = _reference_tokens(stores[kind])
    outs = world.run(cases.engine_generate, stores[kind], *mesh, PROMPTS, 6,
                     serve_quantized=True)
    tp = mesh[1]
    bits = 8 if kind == "int8" else 4
    for out in outs:
        assert out["tokens"] == want
        q = out["quant"]
        # Every projection stays quantized, at this rank's local shape.
        assert q["mlp/w_gate"] == ((4, 64, 176 // tp), bits)
        assert q["mlp/w_down"] == ((4, 176 // tp, 64), bits)
        assert q["attn/wq"] == ((4, 64, 4 // tp, 16), bits)
        assert q["attn/wo"] == ((4, 4 // tp, 16, 64), bits)
        kv = 2 // tp if 2 % tp == 0 else 2
        assert q["attn/wk"] == ((4, 64, kv, 16), bits)


def test_legacy_store_is_what_the_reference_reads(stores):
    """The legacy fixture is a legacy store to the reference: its leaves
    decode with pack_axis -1."""
    leaves = jstore.load_shards(stores["legacy"])
    wq = leaves["blocks"]["attn"]["wq"]
    assert wq.bits == 4 and wq.pack_axis == -1
