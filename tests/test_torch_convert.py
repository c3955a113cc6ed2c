"""The port's HF checkpoint conversion (``checkpoint/convert.py``,
``checkpoint/download.py``) held against the JAX package's, on the CPU.

- ``config_from_hf`` gives the reference's ``ModelConfig``, field for
  field, for every family's ``config.json`` (llama, Llama-3.1's rope
  scaling, mistral with and without a window, mixtral, qwen2, gemma,
  phi3, gpt2, opt, neox), and refuses what the reference refuses, with
  the same message.  Exact.
- ``convert_state_dict`` on one numpy HF state dict (tiny random models
  built by ``transformers``, the real parameter names) equals the
  reference's tree carried through ``checkpoint/from_jax.py``, leaf for
  leaf, at float32: exact (``torch.equal``).  llama, Mixtral's experts,
  Phi-3's fused projections, Qwen2's biases, Gemma's folded norms, gpt2,
  opt and neox.  A llama's converted tree gives the ``transformers``
  model's logits (atol = rtol = 1e-4).
- The hand-written safetensors reader equals ``safetensors`` itself for
  f32, f16, bf16 and i64 (bytes equal); ``load_state_dict`` reads a
  sharded ``.safetensors`` snapshot and a ``.bin`` alike; a bf16
  checkpoint converts to the reference's bf16 tree exactly.
- ``fetch_model`` returns a local directory and refuses a hub id; the
  port imports neither ``safetensors`` nor ``transformers`` nor
  ``huggingface_hub``.
"""

import dataclasses
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from distributed_llms_tpu.checkpoint import convert as jconvert
from distributed_llms_tpu_torch.checkpoint import convert as tconvert
from distributed_llms_tpu_torch.checkpoint.download import fetch_model
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy

transformers = pytest.importorskip("transformers")
REPO = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# -- config_from_hf -----------------------------------------------------------

_CONFIGS = {
    "llama": dict(model_type="llama", architectures=["LlamaForCausalLM"],
                  vocab_size=128256, hidden_size=4096,
                  intermediate_size=14336, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=8,
                  max_position_embeddings=8192, rope_theta=500000.0,
                  rms_norm_eps=1e-5, tie_word_embeddings=False),
    "llama3.1": dict(model_type="llama", vocab_size=128256, hidden_size=4096,
                     intermediate_size=14336, num_hidden_layers=32,
                     num_attention_heads=32, num_key_value_heads=8,
                     max_position_embeddings=131072, rope_theta=500000.0,
                     rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                   "low_freq_factor": 1.0,
                                   "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 8192}),
    "mistral": dict(model_type="mistral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, sliding_window=4096),
    "mistral-global": dict(model_type="mistral", vocab_size=32000,
                           hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           max_position_embeddings=1024,
                           sliding_window=4096),
    "mixtral": dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    num_local_experts=8, num_experts_per_tok=2,
                    max_position_embeddings=32768, rope_theta=1e6),
    "qwen2": dict(model_type="qwen2", vocab_size=151936, hidden_size=896,
                  intermediate_size=4864, num_hidden_layers=24,
                  num_attention_heads=14, num_key_value_heads=2,
                  tie_word_embeddings=True),
    "gemma": dict(model_type="gemma", vocab_size=256000, hidden_size=2048,
                  intermediate_size=16384, num_hidden_layers=18,
                  num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                  hidden_activation="gelu_pytorch_tanh"),
    "phi3": dict(model_type="phi3", vocab_size=32064, hidden_size=3072,
                 intermediate_size=8192, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=32,
                 max_position_embeddings=4096, sliding_window=2047),
    "gpt2": dict(model_type="gpt2", vocab_size=50257, n_embd=768, n_layer=12,
                 n_head=12, n_positions=1024),
    "opt": dict(model_type="opt", vocab_size=50272, hidden_size=768,
                ffn_dim=3072, num_hidden_layers=12, num_attention_heads=12,
                max_position_embeddings=2048, activation_function="relu"),
    "neox": dict(model_type="gpt_neox", vocab_size=50432, hidden_size=4096,
                 intermediate_size=16384, num_hidden_layers=32,
                 num_attention_heads=32, max_position_embeddings=2048,
                 rotary_pct=0.25, rotary_emb_base=10000,
                 use_parallel_residual=True, hidden_act="gelu"),
}

_REFUSED = [
    dict(model_type="llama", vocab_size=8, hidden_size=8,
         intermediate_size=8, num_hidden_layers=1, num_attention_heads=1,
         rope_scaling={"rope_type": "yarn", "factor": 2.0}),
    dict(model_type="llama", vocab_size=8, hidden_size=8,
         intermediate_size=8, num_hidden_layers=1, num_attention_heads=1,
         rope_scaling={"rope_type": "llama3", "factor": 2.0,
                       "low_freq_factor": 4.0, "high_freq_factor": 4.0}),
    dict(model_type="qwen2", use_sliding_window=True),
    dict(model_type="gemma", hidden_activation="gelu"),
    dict(model_type="phi3", partial_rotary_factor=0.5),
    dict(model_type="gpt_neox", tie_word_embeddings=True),
    dict(model_type="opt", hidden_size=8, do_layer_norm_before=False),
    dict(model_type="opt", hidden_size=8, word_embed_proj_dim=4),
    dict(model_type="gemma2"),
]


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_config_from_hf_equals_the_reference(name):
    got = tconvert.config_from_hf(_CONFIGS[name])
    want = jconvert.config_from_hf(_CONFIGS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("i", range(len(_REFUSED)))
def test_config_from_hf_refuses_as_the_reference(i):
    with pytest.raises(ValueError) as e_t:
        tconvert.config_from_hf(_REFUSED[i])
    with pytest.raises(ValueError) as e_j:
        jconvert.config_from_hf(_REFUSED[i])
    assert str(e_t.value) == str(e_j.value)


# -- convert_state_dict -------------------------------------------------------

_TINY = dict(vocab_size=96, hidden_size=32, intermediate_size=56,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)


def _hf_model(family):
    t = transformers
    if family == "llama":
        cfg = t.LlamaConfig(**_TINY, num_key_value_heads=2,
                            tie_word_embeddings=False)
        cls = t.LlamaForCausalLM
    elif family == "mixtral":
        cfg = t.MixtralConfig(**_TINY, num_key_value_heads=2,
                              num_local_experts=4, num_experts_per_tok=2)
        cls = t.MixtralForCausalLM
    elif family == "phi3":
        cfg = t.Phi3Config(**_TINY, num_key_value_heads=2, pad_token_id=0,
                           sliding_window=16)
        cls = t.Phi3ForCausalLM
    elif family == "qwen2":
        cfg = t.Qwen2Config(**_TINY, num_key_value_heads=2)
        cls = t.Qwen2ForCausalLM
    elif family == "gemma":
        cfg = t.GemmaConfig(**_TINY, num_key_value_heads=1, head_dim=16)
        cls = t.GemmaForCausalLM
    elif family == "gpt2":
        cfg = t.GPT2Config(vocab_size=96, n_embd=32, n_layer=2, n_head=4,
                           n_positions=64)
        cls = t.GPT2LMHeadModel
    elif family == "opt":
        cfg = t.OPTConfig(vocab_size=96, hidden_size=32, ffn_dim=56,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=64,
                          word_embed_proj_dim=32)
        cls = t.OPTForCausalLM
    elif family == "neox":
        cfg = t.GPTNeoXConfig(**_TINY, rotary_pct=0.5,
                              use_parallel_residual=True)
        cls = t.GPTNeoXForCausalLM
    torch.manual_seed(0)
    model = cls(cfg).eval()
    sd = {k: v.detach().float().numpy() for k, v in
          model.state_dict().items()}
    for k in sd:  # every weight, norms included, off its initial value
        noise = np.random.default_rng(zlib.crc32(k.encode()))
        sd[k] = sd[k] + 0.02 * noise.standard_normal(sd[k].shape).astype(
            np.float32)
    return cfg.to_dict(), model, sd


FAMILIES = ["llama", "mixtral", "phi3", "qwen2", "gemma", "gpt2", "opt",
            "neox"]


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_equals_the_reference_tree(family):
    hf, _, sd = _hf_model(family)
    jcfg = dataclasses.replace(jconvert.config_from_hf(hf), dtype="float32")
    tcfg = dataclasses.replace(tconvert.config_from_hf(hf), dtype="float32")
    want = params_from_numpy(
        jax.tree.map(np.asarray, jconvert.convert_state_dict(sd, jcfg)),
        tcfg, device="cpu")
    got = tconvert.convert_state_dict(sd, tcfg)
    want, got = _flat(want), _flat(got)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k
    # The same tree from torch tensors as from numpy arrays.
    got_t = _flat(tconvert.convert_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg))
    assert all(torch.equal(got_t[k], got[k]) for k in got)


def test_converted_llama_gives_the_hf_logits():
    from distributed_llms_tpu_torch.models import model as model_lib

    hf, model, _ = _hf_model("llama")
    cfg = dataclasses.replace(tconvert.config_from_hf(hf), dtype="float32")
    params = tconvert.convert_state_dict(model.state_dict(), cfg)
    toks = torch.tensor([[3, 17, 9, 41, 2, 77, 5, 11]])
    with torch.no_grad():
        ref = model(toks).logits
        ours, _ = model_lib.forward(params, cfg, toks)
    torch.testing.assert_close(ours, ref, atol=1e-4, rtol=1e-4)


def test_missing_key_names_the_key():
    hf, _, sd = _hf_model("llama")
    cfg = tconvert.config_from_hf(hf)
    del sd["model.layers.1.mlp.down_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.mlp.down_proj.weight"):
        tconvert.convert_state_dict(sd, cfg)


# -- weight files -------------------------------------------------------------

def test_safetensors_reader_equals_safetensors(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    st_t = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i64": rng.integers(-2**40, 2**40, (2, 2, 3)),
        "scalar": np.array(1.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    st_np.save_file(arrays, str(tmp_path / "a.safetensors"))
    got = tconvert.read_safetensors(str(tmp_path / "a.safetensors"))
    want = st_np.load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype
        assert got[k].numpy().tobytes() == want[k].tobytes()
        assert tuple(got[k].shape) == want[k].shape
    # bf16 (numpy has no bfloat16; safetensors' torch reader is the oracle).
    bf = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
          .to(torch.bfloat16), "b": torch.randn(6).to(torch.bfloat16)}
    st_t.save_file(bf, str(tmp_path / "b.safetensors"))
    got = tconvert.read_safetensors(str(tmp_path / "b.safetensors"))
    want = st_t.load_file(str(tmp_path / "b.safetensors"))
    for k in want:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), want[k].view(torch.int16))


def test_load_state_dict_reads_shards_and_bin(tmp_path):
    st_t = pytest.importorskip("safetensors.torch")
    hf, model, _ = _hf_model("llama")
    sd = {k: v.detach().clone().contiguous()
          for k, v in model.state_dict().items()}
    names = sorted(sd)
    (tmp_path / "st").mkdir()
    st_t.save_file({k: sd[k] for k in names[::2]},
                   str(tmp_path / "st" / "model-00001-of-00002.safetensors"))
    st_t.save_file({k: sd[k] for k in names[1::2]},
                   str(tmp_path / "st" / "model-00002-of-00002.safetensors"))
    (tmp_path / "bin").mkdir()
    torch.save(sd, tmp_path / "bin" / "pytorch_model.bin")
    for sub in ("st", "bin"):
        got = tconvert.load_state_dict(str(tmp_path / sub))
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd), sub
    # The reference reads the same snapshot to the same values (float32).
    ref = jconvert.load_state_dict(str(tmp_path / "bin"))
    assert all(np.array_equal(ref[k], sd[k].numpy()) for k in sd)
    with pytest.raises(FileNotFoundError):
        tconvert.load_state_dict(str(tmp_path))


def test_bf16_checkpoint_converts_as_the_reference(tmp_path):
    st_t = pytest.importorskip("safetensors.torch")
    hf, _, sd = _hf_model("llama")
    st_t.save_file({k: torch.from_numpy(v).to(torch.bfloat16)
                    for k, v in sd.items()},
                   str(tmp_path / "model.safetensors"))
    cfg = tconvert.config_from_hf(hf)  # dtype bfloat16
    got = _flat(tconvert.convert_state_dict(
        tconvert.load_state_dict(str(tmp_path)), cfg))
    sd_bf = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
             for k, v in sd.items()}
    jcfg = jconvert.config_from_hf(hf)
    want = _flat(params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32),
                     jconvert.convert_state_dict(sd_bf, jcfg)),
        cfg, device="cpu"))
    for k in want:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], want[k]), k


# -- download and imports -----------------------------------------------------

def test_fetch_model_takes_a_local_dir_and_refuses_a_hub_id(tmp_path):
    assert fetch_model(str(tmp_path)) == str(tmp_path)
    with pytest.raises(RuntimeError, match="fetches nothing"):
        fetch_model("meta-llama/Meta-Llama-3-8B")


def test_the_port_imports_no_hub_packages():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('safetensors', 'transformers',\n"
        "                'huggingface_hub', 'jax', 'distributed_llms_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import distributed_llms_tpu_torch.cli.coordinator_main\n"
        "import distributed_llms_tpu_torch.cli.host_main\n"
        "import distributed_llms_tpu_torch.cli.serve_main\n"
        "import distributed_llms_tpu_torch.cluster.autoscale\n"
        "import distributed_llms_tpu_torch.cluster.client\n"
        "import distributed_llms_tpu_torch.runtime.workload\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
