"""Serving on a pipelined mesh: the port's ``InferenceEngine`` over a
store with ``mesh_cfg`` pipe=2 (the counterpart of
tests/parallel/test_quantized_mesh.py's pipelined case) and the control
plane worker's grouped fallback (tests/cluster: the reference worker's
``_generate_requests`` on a pipelined mesh).

The JAX package writes an int8 store (quant_block 32) of llama-tiny and
its engines give the tokens to hold: the single-device quantized engine,
and for the worker and the sessions its pipe=2 engine on the conftest's
CPU devices.  The port's engine runs on a spawned world of 2 gloo ranks
(``tests/torch_world.py``), one stage each, every projection of each
stage on its quantized leaves.
"""

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
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llms_tpu.runtime import tokenizer as jtok
from torch_world import World

PROMPTS = ["hello quantized pipeline", "second row", "third", "a fourth row"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("pipe_serving_world")))
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
        path = str(tmp_path_factory.mktemp(f"pstore_{q}"))
        jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                           quantization=q, quant_block=32)
        out[q] = path
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_int8_store_serves_the_reference_tokens(world, stores, microbatches):
    """Quantized blocks stay QuantizedTensor leaves through staging (each
    stage its 2 of 4 layers), and the pipelined engine's tokens equal the
    reference engine's; batches round up to data x microbatches rows and
    the continuous batcher refuses the mesh."""
    ref = JEngine.from_store(stores["int8"], rt=JRuntimeConfig(
        max_decode_steps=6, serve_quantized=True))
    want = ref.generate_text(PROMPTS[:3], max_new_tokens=6).tokens.tolist()
    outs = world.run(cases.pipe_engine_generate, stores["int8"], PROMPTS[:3],
                     6, microbatches, serve_quantized=True)
    for stage, out in enumerate(outs):
        assert out["tokens"] == want
        assert out["quant"]["mlp/w_gate"] == ((2, 64, 176), 8)
        assert out["quant"]["attn/wo"] == ((2, 4, 16, 64), 8)
        assert len(out["quant"]) == 7
        assert out["groups"] == (["blocks", "embed"] if stage == 0
                                 else ["blocks", "final_norm", "lm_head"])
        assert "no pipe/seq axes" in out["batcher"]
        assert out["multiple"] == microbatches


def _jax_pipe_engine(store_dir: str, rt: JRuntimeConfig) -> JEngine:
    """The reference's engine over ``store_dir`` on a pipe=2 mesh of the
    first two of the conftest's CPU devices (its ``from_store`` would lay
    the mesh over all eight)."""
    one = JEngine.from_store(store_dir, rt=rt)
    pm = japi.make_parallel_model(one.cfg, JMeshConfig(pipe=2),
                                  num_microbatches=rt.microbatches,
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


def test_worker_groups_mixed_budgets_and_cuts_at_eos(world, stores):
    """The worker's mixed-budget batch on a pipelined engine: one
    generate_text at the longest budget, each row cut to its own budget
    and after its first EOS (here a token the greedy streams emit).  The
    texts and the token count are the reference worker's on the same
    pipe=2 mesh (the conftest's CPU devices)."""
    rt = JRuntimeConfig(microbatches=2)
    ref = JWorkerHost("127.0.0.1", 1, rt=rt, mesh_cfg=JMeshConfig(pipe=2))
    ref.engine = _jax_pipe_engine(stores[None], rt)
    budgets = [3, 7, 5, 2]
    eos = int(ref.engine.generate_text(PROMPTS, max_new_tokens=7)
              .tokens[1][2])
    ref.engine.tokenizer = _JEosTokenizer(eos)  # row 1 stops at its 3rd
    reqs = [{"prompt": p, "max_new_tokens": n}
            for p, n in zip(PROMPTS, budgets)]
    want = ref._generate_requests(reqs)
    assert want["generated_tokens"] < sum(budgets)  # the EOS cut fired
    for out in world.run(cases.pipe_worker_requests, stores[None], reqs, 2,
                         eos_id=eos):
        assert out["text"] == want["text"]
        assert out["generated_tokens"] == want["generated_tokens"]


def test_sessions_run_through_the_pipelined_forward(world, stores):
    """Multi-turn sessions on a pipelined engine (every turn's prefill and
    step through the GPipe forward into the stages' caches) give the
    reference's pipelined engine's tokens (pipe=2, 2 microbatches)."""
    turns = [PROMPTS[:2], ["and then", "more"], ["last turn", "x"]]
    ref = _jax_pipe_engine(stores[None], JRuntimeConfig(microbatches=2))
    sid, res = ref.start_session(turns[0], max_new_tokens=4)
    want = [res.tokens.tolist()] + [
        ref.continue_session(sid, t, max_new_tokens=4).tokens.tolist()
        for t in turns[1:]]
    for out in world.run(cases.pipe_engine_session, stores[None], turns, 4,
                         2):
        assert out == want
