"""Serving on a sequence-parallel mesh: the port's ``InferenceEngine``
over a store with ``mesh_cfg`` seq=2, and the control plane worker's
grouped fallback on that mesh (the reference worker's
``_generate_requests`` on a seq mesh, reference ``cluster/worker.py``).

The JAX package writes the stores (llama-tiny, an int8 one at quant block
32) and its engines give the tokens to hold: the single-device quantized
engine, and for the worker its seq=2 engine on two of the conftest's CPU
devices.  The port's engine runs on a spawned world of 2 gloo ranks
(``tests/torch_world.py``), each holding half of every prompt's K/V.
"""

import dataclasses

import jax
import pytest
import torch

import torch_mesh_cases as cases
from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.cluster.worker import WorkerHost as JWorkerHost
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.core.config import RuntimeConfig as JRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.runtime import tokenizer as jtok
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from torch_world import World

PROMPTS = ["hello sequence parallel", "second row", "a third, odd row"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("seq_serving_world")))
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
    for q in ("int8", None):
        path = str(tmp_path_factory.mktemp(f"sstore_{q}"))
        jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                           quantization=q, quant_block=32)
        out[q] = path
    return out


def test_int8_store_serves_the_reference_tokens(world, stores):
    """Quantized blocks stay QuantizedTensor leaves on both ranks, the
    prompt width is padded to a multiple of 'seq' (the longest prompt has
    23 tokens with BOS), the prefill takes the ring, and the tokens equal
    the reference's quantized engine's; the continuous batcher and
    sessions are refused with the reference's messages."""
    ref = JEngine.from_store(stores["int8"], rt=JRuntimeConfig(
        max_decode_steps=6, serve_quantized=True))
    want = ref.generate_text(PROMPTS, max_new_tokens=6).tokens.tolist()
    outs = world.run(cases.seq_engine, stores["int8"], PROMPTS, 6,
                     serve_quantized=True)
    for out in outs:
        assert out["tokens"] == want
        assert out["quantized_leaves"] == 7
        assert out["padded_width"] % 2 == 0
        assert out["shifts"] > 0
        assert "no pipe/seq axes" in out["refused"]["batcher"]
        assert "needs prompt_len" in out["refused"]["session"]


def _jax_seq_engine(store_dir: str, rt: JRuntimeConfig) -> JEngine:
    """The reference's engine over ``store_dir`` on a seq=2 mesh of the
    first two of the conftest's CPU devices (its ``from_store`` would lay
    the mesh over all eight)."""
    one = JEngine.from_store(store_dir, rt=rt)
    pm = japi.make_parallel_model(one.cfg, JMeshConfig(seq=2),
                                  devices=jax.devices()[:2])
    return JEngine(one.cfg, rt, one.params, tokenizer=one.tokenizer,
                   parallel=pm)


class _JEosTokenizer(jtok.ByteTokenizer):
    """The reference's byte tokenizer with its EOS moved to ``eos``."""

    def __init__(self, eos: int) -> None:
        self._eos = eos

    @property
    def eos_id(self) -> int:
        return self._eos


def test_worker_groups_mixed_budgets_on_a_seq_mesh(world, stores):
    """The worker's mixed-budget batch on a seq engine: one generate_text
    at the longest budget, each row cut to its own budget and after its
    first EOS.  Texts and token count equal the reference worker's on the
    same seq=2 mesh."""
    rt = JRuntimeConfig()
    ref = JWorkerHost("127.0.0.1", 1, rt=rt, mesh_cfg=JMeshConfig(seq=2))
    ref.engine = _jax_seq_engine(stores[None], rt)
    prompts = PROMPTS + ["and a fourth"]
    budgets = [3, 7, 5, 2]
    eos = int(ref.engine.generate_text(prompts, max_new_tokens=7)
              .tokens[1][2])
    ref.engine.tokenizer = _JEosTokenizer(eos)  # row 1 stops at its 3rd
    reqs = [{"prompt": p, "max_new_tokens": n}
            for p, n in zip(prompts, budgets)]
    want = ref._generate_requests(reqs)
    assert want["generated_tokens"] < sum(budgets)  # the EOS cut fired
    for out in world.run(cases.seq_worker_requests, stores[None], reqs,
                         eos_id=eos):
        assert out["text"] == want["text"]
        assert out["generated_tokens"] == want["generated_tokens"]


def test_windowed_models_are_refused_on_a_seq_engine():
    """The engine takes the mesh's adapters at construction, which refuse
    a sliding-window model on a seq mesh (the reference refuses there
    too); the config refuses ring/Ulysses with a window outright."""
    from distributed_llms_tpu_torch.core.config import MeshConfig, RuntimeConfig
    from distributed_llms_tpu_torch.core.mesh import build_mesh
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.parallel import api as tapi
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    cfg = get_preset("llama-tiny", vocab_size=512, sliding_window=4)
    m = MeshConfig(seq=2)
    pm = tapi.make_parallel_model(cfg, m, mesh=build_mesh(m, rank=0,
                                                          world_size=2))
    with pytest.raises(ValueError, match="sliding_window"):
        InferenceEngine(cfg, RuntimeConfig(), {}, parallel=pm)
    with pytest.raises(ValueError, match="sliding_window"):
        dataclasses.replace(cfg, attn_impl="ring")
