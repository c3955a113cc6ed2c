"""The standalone speculative loop in the port against the JAX package, on
the CPU.

``runtime/speculative.py``'s ``speculative_generate_tokens`` at
temperature 0 gives tokens AND stats (rounds, drafted, accepted) equal to
the reference's on the same weights: an unrelated 2-layer draft at k 1 over a
ragged batch, the target as its own draft (full acceptance, the
budget ending mid-round), an EOS inside a round and on the first token,
a budget under k, a sliding-window target over a ragged batch (the gapped
layout's ``key_positions``, k 3), and the target's int4 self-draft.  Its tokens
also equal the port's ``generate_tokens``.  The reference's loop is one
``lax.while_loop`` program per case, which the JAX package's own tests
compile only in a fresh process (``tests/runtime/test_isolated.py``): its
outputs come from one such process here too.

The engine: ``generate_text_speculative`` equals ``generate_text``;
``runtime.spec_decode`` routes ``generate_text`` through the loop (the
``engine.spec_acceptance`` observation) and falls through to the plain
loop near the sequence cap; the refusals.  Sampled rounds are held to the
reference's semantics: a self-draft accepts every draft, and the joint
law of two sampled tokens matches plain sampling within the reference's
total-variation test (vocabulary 16, 1200 rows in one batch).

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import generate as tgen
from distributed_llms_tpu_torch.runtime.engine import (InferenceEngine,
                                                       _quantize_blocks)
from distributed_llms_tpu_torch.runtime.speculative import \
    speculative_generate_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (target overrides, draft: "unrelated" | "self" | "int4",
#          prompt rows, k, max_new_tokens, EOS id: the free greedy run's
#          token at [row, col], or None)
CASES = {
    "any_draft_k1": ({}, "unrelated", [[7, 1, 9, 4], [11, 12, 13, 14, 15, 16]],
                     1, 13, None),
    "self_n12_k3": ({}, "self", [[3, 5, 8]], 3, 12, None),
    "self_n5_k7": ({}, "self", [[3, 5, 8]], 7, 5, None),
    "eos_mid_round": ({}, "unrelated", [[7, 1, 9, 4], [2, 2, 2, 2]], 4, 12,
                      (0, 4)),
    "eos_first_token": ({}, "unrelated", [[7, 1, 9, 4]], 3, 6, (0, 0)),
    "budget_under_k": ({}, "unrelated", [[5, 6, 7]], 5, 4, None),
    "window_ragged": ({"sliding_window": 3}, "unrelated",
                      [[7, 1, 9], [4, 4, 4, 4, 4, 4, 4, 4]], 3, 12, None),
    "int4_self_draft": ({}, "int4", [[9, 8, 7, 6]], 4, 10, None),
}

# Runs every case through the reference in a fresh process on the weights
# of the npz file argv[2]; prints JSON.
_REFERENCE = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[1])
from test_torch_spec_generate import CASES, padded, unflatten
from distributed_llms_tpu.checkpoint.quantize import QuantizedTensor
from distributed_llms_tpu.models.presets import get_preset
from distributed_llms_tpu.runtime.speculative import speculative_generate_tokens

def leaf(a, meta):
    if meta is None:
        return jnp.asarray(a)
    data, scale = a
    return QuantizedTensor(jnp.asarray(data), jnp.asarray(scale), bits=4,
                           orig_shape=tuple(meta[0]), pack_axis=meta[1])

with np.load(sys.argv[2]) as z:
    flat = dict(z)
meta = json.loads(sys.argv[3])
trees = unflatten(flat, meta, leaf)
eos_ids = json.loads(sys.argv[4])
out = {}
for name, (over, draft, rows, k, n, _) in CASES.items():
    tcfg = get_preset("llama-tiny", vocab_size=512, **over)
    dcfg = (get_preset("llama-tiny", vocab_size=512, num_layers=2)
            if draft == "unrelated" else tcfg)
    dp = trees["target" if draft == "self" else draft]
    prompt, lens = padded(rows)
    toks, st = speculative_generate_tokens(
        trees["target"], tcfg, dp, dcfg, jnp.asarray(prompt),
        jnp.asarray(lens), k=k, max_new_tokens=n, eos_id=eos_ids[name],
        return_stats=True)
    out[name] = {"tokens": np.asarray(toks).tolist(),
                 "stats": {key: int(v) for key, v in st.items()}}
print(json.dumps(out))
"""


def padded(rows):
    t = max(len(r) for r in rows)
    return (np.asarray([r + [0] * (t - len(r)) for r in rows], np.int32),
            np.asarray([len(r) for r in rows], np.int32))


@functools.lru_cache(maxsize=None)
def port_trees():
    """{"target", "unrelated", "int4"} -> (port cfg, params): the
    reference's init_params (seed 0, llama-tiny; seed 99, its 2-layer
    draft) through params_from_numpy, and the target's int4 self-draft
    quantized by the port (the reference's codes and scales)."""
    out = {}
    for name, seed, layers in (("target", 0, 4), ("unrelated", 99, 2)):
        cfg_j = jax_preset("llama-tiny", vocab_size=512, num_layers=layers)
        cfg_t = get_preset("llama-tiny", vocab_size=512, num_layers=layers)
        pj = jm.init_params(jax.random.key(seed), cfg_j)
        out[name] = (cfg_t, params_from_numpy(jax.tree.map(np.asarray, pj),
                                              cfg_t, device="cpu"))
    cfg_t, pt = out["target"]
    out["int4"] = (cfg_t, {**pt, "blocks": _quantize_blocks(pt["blocks"], 4)})
    return out


def flatten(tree, prefix, flat, meta):
    """Nested dicts of tensors / QuantizedTensors -> {"a/b": array} plus
    {"a/b": (orig_shape, pack_axis)} for each quantized leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}/{k}", flat, meta)
    elif hasattr(tree, "pack_axis"):
        flat[prefix + "#data"] = tree.data.numpy()
        flat[prefix + "#scale"] = tree.scale.numpy()
        meta[prefix] = (list(tree.orig_shape), tree.pack_axis)
    else:
        flat[prefix] = tree.numpy()


def unflatten(flat, meta, leaf):
    """The inverse of :func:`flatten`, each leaf built by ``leaf(array or
    (data, scale), meta or None)``."""
    out = {}
    for key in sorted({k.split("#")[0] for k in flat}):
        node = out
        *path, last = key.strip("/").split("/")
        for p in path:
            node = node.setdefault(p, {})
        if key in meta:
            node[last] = leaf((flat[key + "#data"], flat[key + "#scale"]),
                              meta[key])
        else:
            node[last] = leaf(flat[key], None)
    return out


def torch_pair(over, draft):
    """(target cfg, params, draft cfg, params) in the port."""
    trees = port_trees()
    ct = get_preset("llama-tiny", vocab_size=512, **over)
    pt = trees["target"][1]
    if draft == "self":
        return ct, pt, ct, pt
    dc, dp = trees[draft]
    return ct, pt, (ct if draft == "int4" else dc), dp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(EOS ids, the reference's outputs): the EOS ids from the port's
    free greedy runs (equal to the reference's: test_torch_generate.py),
    the outputs computed in a fresh process started with the module's
    first test (the port-only tests run meanwhile)."""
    eos_ids = {}
    for name, (over, draft, rows, _, n, eos_at) in CASES.items():
        eos_ids[name] = -1
        if eos_at is not None:
            ct, pt, _, _ = torch_pair(over, draft)
            prompt, lens = padded(rows)
            free = tgen.generate_tokens(pt, ct, torch.from_numpy(prompt),
                                        torch.from_numpy(lens), None,
                                        max_new_tokens=n)
            eos_ids[name] = int(free[eos_at])
    flat, meta = {}, {}
    for name, (_, params) in port_trees().items():
        flatten(params, name, flat, meta)
    npz = tmp_path_factory.mktemp("spec_reference") / "weights.npz"
    np.savez(npz, **flat)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get(
               "PYTHONPATH", "")])}
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, os.path.join(REPO, "tests"),
         str(npz), json.dumps(meta), json.dumps(eos_ids)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    box = {}

    def result():
        if not box:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            box.update(json.loads(out.strip().splitlines()[-1]))
        return eos_ids, box

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    yield


# -- the engine and the sampled rounds (port only; the reference process
# runs meanwhile) -------------------------------------------------------------

def _engine(**rt_kw):
    from test_torch_generate import weights

    _, cfg_t, _, pt = weights(12, max_seq_len=64)
    return InferenceEngine(cfg_t, RuntimeConfig(max_seq_len=64, **rt_kw), pt,
                           device="cpu")


def test_engine_speculative_equals_generate_text_and_routes():
    plain = _engine(max_decode_steps=8)
    spec = _engine(max_decode_steps=8, spec_decode=True, spec_k=3)
    assert spec.draft_params is not None  # the int4 self-draft, at boot

    def observed():
        h = METRICS.snapshot()["histograms"].get("engine.spec_acceptance", {})
        return h.get("count", 0)

    prompts = ["hello world", "abc"]
    want = plain.generate_text(prompts)
    before = observed()
    got = spec.generate_text(prompts)
    assert observed() == before + 1  # routed through the loop
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.text == want.text
    plain.attach_draft(quantize_bits=4)
    explicit = plain.generate_text_speculative(prompts, k=2)
    np.testing.assert_array_equal(explicit.tokens, want.tokens)
    assert observed() == before + 2
    # 52 prompt bytes + BOS + 8 new + k + 1 > 64: the plain loop serves.
    long_prompt = ["x" * 52]
    got2 = spec.generate_text(long_prompt)
    assert observed() == before + 2
    np.testing.assert_array_equal(
        got2.tokens, _engine(max_decode_steps=8).generate_text(
            long_prompt).tokens)


def test_engine_speculative_guards():
    eng = _engine(max_decode_steps=8)
    with pytest.raises(ValueError, match="no draft"):
        eng.generate_text_speculative(["x"])
    with pytest.raises(ValueError, match="OR quantize_bits"):
        eng.attach_draft(eng.cfg, eng.params, quantize_bits=4)
    with pytest.raises(ValueError, match="exceeds sequence limit"):
        eng.attach_draft(quantize_bits=8)
        eng.generate_text_speculative(["x" * 50], max_new_tokens=8, k=5)
    sampled = _engine(max_decode_steps=6, temperature=0.7)
    sampled.attach_draft(quantize_bits=8)
    res = sampled.generate_text_speculative(["hello"], k=3, seed=11)
    assert res.tokens.shape == (1, 6)
    assert (res.tokens >= 0).all() and (res.tokens < 512).all()


def test_loop_refusals():
    ct, pt, dc, dp = torch_pair({}, "unrelated")
    p, n = torch.tensor([[1, 2]]), torch.tensor([2])
    with pytest.raises(ValueError, match="k must be"):
        speculative_generate_tokens(pt, ct, dp, dc, p, n, k=0)
    with pytest.raises(ValueError, match="max_new_tokens must be"):
        speculative_generate_tokens(pt, ct, dp, dc, p, n, max_new_tokens=0)
    with pytest.raises(ValueError, match="requires a generator"):
        speculative_generate_tokens(pt, ct, dp, dc, p, n, temperature=0.5)
    with pytest.raises(ValueError, match="ragged_decode"):
        import dataclasses

        speculative_generate_tokens(
            pt, dataclasses.replace(ct, ragged_decode=True), dp, dc, p, n)
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate_tokens(
            pt, ct, dp, get_preset("llama-tiny", vocab_size=256,
                                   num_layers=2), p, n)


def test_sampled_self_draft_accepts_every_draft():
    ct, pt, _, _ = torch_pair({}, "self")
    g = torch.Generator().manual_seed(42)
    toks, stats = speculative_generate_tokens(
        pt, ct, pt, ct, torch.tensor([[3, 5, 8]]), torch.tensor([3]), k=3,
        max_new_tokens=12, return_stats=True, temperature=0.8, generator=g)
    assert toks.shape == (1, 12)
    assert stats["accepted"] == stats["drafted"] > 0


def test_sampled_distribution_matches_plain_sampling():
    """Speculative sampling preserves the target's law: over 1200 rows
    (one batch), the joint distribution of the first two sampled tokens
    with an UNRELATED draft sits at the plain-vs-plain total-variation
    noise floor (the reference's self-calibrated test)."""
    rows = 1200
    cfg = get_preset("llama-tiny", vocab_size=16, num_layers=1, num_heads=2,
                     num_kv_heads=2, hidden_size=16, intermediate_size=44)
    params = tm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    dparams = tm.init_params(cfg, generator=torch.Generator().manual_seed(77),
                             device="cpu")
    prompt = torch.tensor([[7, 1, 9]]).expand(rows, 3).contiguous()
    lens = torch.full((rows,), 3)

    def joint(toks):
        h = np.zeros((16, 16))
        np.add.at(h, (toks[:, 0].numpy(), toks[:, 1].numpy()), 1)
        return h / rows

    spec = speculative_generate_tokens(
        params, cfg, dparams, cfg, prompt, lens, k=2, max_new_tokens=2,
        temperature=0.9, generator=torch.Generator().manual_seed(1))
    plain = [tgen.generate_tokens(params, cfg, prompt, lens,
                                  torch.Generator().manual_seed(s),
                                  max_new_tokens=2, temperature=0.9)
             for s in (2, 3)]
    hs, ha, hb = joint(spec), joint(plain[0]), joint(plain[1])
    null_tv = 0.5 * np.abs(ha - hb).sum()
    test_tv = 0.5 * np.abs(hs - ha).sum()
    assert test_tv < 1.5 * null_tv + 0.04, (test_tv, null_tv)


# -- against the reference ----------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_greedy_loop_equals_the_reference(reference, name):
    over, draft, rows, k, n, _ = CASES[name]
    eos_ids, outputs = reference()
    want = {**outputs[name], "eos_id": eos_ids[name]}
    ct, pt, dc, dp = torch_pair(over, draft)
    prompt, lens = padded(rows)
    p, pl = torch.from_numpy(prompt), torch.from_numpy(lens)
    toks, stats = speculative_generate_tokens(
        pt, ct, dp, dc, p, pl, k=k, max_new_tokens=n,
        eos_id=want["eos_id"], return_stats=True)
    assert toks.dtype == torch.int32 and toks.shape == (len(rows), n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want["tokens"]))
    assert stats == want["stats"]
    plain = tgen.generate_tokens(pt, ct, p, pl, None, max_new_tokens=n,
                                 eos_id=want["eos_id"])
    assert torch.equal(toks, plain)
    if draft == "self":
        assert stats["accepted"] == stats["drafted"] > 0
        assert stats["rounds"] == -(-(n - 1) // (k + 1))
    if name == "eos_first_token":
        assert toks[0].tolist() == [want["eos_id"]] + [0] * (n - 1)
