"""Multi-turn sessions with host KV spill in the port against the JAX
package, on the CPU.

- ``runtime/session.py``'s ``session_step`` (the chunk prefill under
  ``continuation_mask``, then the decode loop) over two turns equals the
  reference's: tokens, valid slots, lengths and the ``slot_positions``
  state exactly, the cache within atol = rtol = 1e-4 — global attention
  and a sliding window of 4 over a ragged batch.
- The engine's sessions: the first turn equals ``generate_text``; a
  continuation equals ``generate_tokens`` run one-shot over the whole
  token history (prompt 1, turn 1's tokens, prompt 2); a windowed ragged
  session equals the reference engine's and each row's solo session.
- Host spill (``kv_host_spill``, ``max_resident_sessions=1``): opening a
  second session spills the first; the host copy is byte-identical to
  the device cache, the restore is byte-identical to the host copy, and
  the continued session's tokens equal an engine's without spill; the
  ``kv_spill.*`` counters and gauges move; budgets, unknown and ended
  sessions raise.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32
weights from the reference's ``init_params``; the engines' caches are
``rt.kv_cache_dtype`` (bfloat16) on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.core.config import RuntimeConfig as JaxRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.runtime import session as jsess
from distributed_llms_tpu.runtime.engine import InferenceEngine as JaxEngine
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.runtime import generate as tgen
from distributed_llms_tpu_torch.runtime import session as tsess
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

from test_torch_generate import ragged_prompts, weights

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("window", [None, 4])
def test_session_step_equals_the_reference(window):
    """Two turns of ``session_step`` on a ragged 2-row batch: the state
    each turn returns equals the reference's."""
    cfg_j, cfg_t, pj, pt = weights(7, sliding_window=window)
    s = 48
    b = 2
    cj, ct = jm.init_cache(cfg_j, b, s), tm.init_cache(cfg_t, b, s)
    st_j = dict(valid_mask=jnp.zeros((b, s), bool),
                real_lens=jnp.zeros((b,), jnp.int32))
    st_t = dict(valid_mask=torch.zeros((b, s), dtype=torch.bool),
                real_lens=torch.zeros((b,), dtype=torch.int32))
    if window is not None:
        st_j["slot_positions"] = jnp.zeros((b, s), jnp.int32)
        st_t["slot_positions"] = torch.zeros((b, s), dtype=torch.int32)
    base = 0
    for turn, (lens, n) in enumerate((([5, 2], 6), ([3, 7], 5))):
        chunk, clens = ragged_prompts(10 + turn, lens)
        tj, cj, vj, rj, sj = jsess.session_step(
            pj, cfg_j, jnp.asarray(chunk), jnp.asarray(clens),
            st_j["real_lens"], st_j["valid_mask"], cj, jnp.int32(base),
            jax.random.key(0), max_new_tokens=n,
            slot_positions=st_j.get("slot_positions"))
        tt, ct, vt, rt_, stt = tsess.session_step(
            pt, cfg_t, torch.from_numpy(chunk), torch.from_numpy(clens),
            st_t["real_lens"], st_t["valid_mask"], ct, base, None,
            max_new_tokens=n, slot_positions=st_t.get("slot_positions"))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(rt_.numpy(), np.asarray(rj))
        np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL)
        np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), **TOL)
        if window is None:
            assert stt is None and sj is None
        else:
            np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))
        st_j.update(valid_mask=vj, real_lens=rj, slot_positions=sj)
        st_t.update(valid_mask=vt, real_lens=rt_, slot_positions=stt)
        base += chunk.shape[1] + n
    if window is not None:
        with pytest.raises(ValueError, match="slot_positions"):
            tsess.session_step(pt, cfg_t, torch.from_numpy(chunk),
                               torch.from_numpy(clens), st_t["real_lens"],
                               st_t["valid_mask"], ct, base, None, 1)


def engine(w, **rt_kw):
    rt = dict(max_decode_steps=4, max_seq_len=96)
    rt.update(rt_kw)
    return InferenceEngine(w[1], RuntimeConfig(**rt), w[3], device="cpu")


def test_first_turn_and_growing_continuation():
    """Turn 1 equals ``generate_text``; turn 2 equals ``generate_tokens``
    over the concatenated history — and both equal the reference
    engine's sessions."""
    w = weights(8)
    eng = engine(w)
    jeng = JaxEngine(w[0], JaxRuntimeConfig(max_decode_steps=4,
                                            max_seq_len=96), w[2])
    sid, r1 = eng.start_session(["abcd"], max_new_tokens=5)
    assert r1.text == eng.generate_text(["abcd"], max_new_tokens=5).text
    r2 = eng.continue_session(sid, ["efgh"], max_new_tokens=5)
    tok = eng.tokenizer
    history = tok.encode("abcd") + list(r1.tokens[0]) + tok.encode("efgh")
    out = tgen.generate_tokens(eng.params, eng.cfg, torch.tensor([history]),
                               torch.tensor([len(history)]), None,
                               max_new_tokens=5, eos_id=tok.eos_id,
                               pad_id=tok.pad_id)
    np.testing.assert_array_equal(r2.tokens[0], out[0].numpy())
    jsid, j1 = jeng.start_session(["abcd"], max_new_tokens=5)
    j2 = jeng.continue_session(jsid, ["efgh"], max_new_tokens=5)
    np.testing.assert_array_equal(r1.tokens, j1.tokens)
    np.testing.assert_array_equal(r2.tokens, j2.tokens)


def test_windowed_ragged_session_equals_reference_and_solo():
    """A sliding-window (5) ragged 2-row session: both turns equal the
    reference engine's and each row's solo session (solo rows have no pad
    gap, so they are layout-free ground truth)."""
    w = weights(9, sliding_window=5)
    eng = engine(w, max_decode_steps=6, max_seq_len=128)
    jeng = JaxEngine(w[0], JaxRuntimeConfig(max_decode_steps=6,
                                            max_seq_len=128), w[2])
    turn1, turn2 = ["hello world", "hi"], ["more text", "y"]
    sid, r1 = eng.start_session(turn1)
    r2 = eng.continue_session(sid, turn2)
    jsid, j1 = jeng.start_session(turn1)
    j2 = jeng.continue_session(jsid, turn2)
    np.testing.assert_array_equal(r1.tokens, j1.tokens)
    np.testing.assert_array_equal(r2.tokens, j2.tokens)
    for i in range(2):
        ssid, s1 = eng.start_session([turn1[i]])
        s2 = eng.continue_session(ssid, [turn2[i]])
        np.testing.assert_array_equal(r1.tokens[i], s1.tokens[0])
        np.testing.assert_array_equal(r2.tokens[i], s2.tokens[0])
        eng.end_session(ssid)


def test_spill_and_restore_are_byte_copies():
    """``max_resident_sessions=1``: opening B spills A (its host copy
    byte-identical to the device cache); continuing A restores it (byte-
    identical again) and spills B; A's turns equal a no-spill engine's."""
    w = weights(10)
    eng = engine(w, kv_host_spill=True, max_resident_sessions=1)
    ctl = engine(w)
    sid_a, a1 = eng.start_session(["first conversation", "row two"])
    sess_a = eng.sessions.get(sid_a)
    dev_k, dev_v = sess_a.cache.k.clone(), sess_a.cache.v.clone()
    spills = METRICS.snapshot()["counters"].get("kv_spill.spills", 0)
    restores = METRICS.snapshot()["counters"].get("kv_spill.restores", 0)
    sid_b, _ = eng.start_session(["second conversation"])
    assert sess_a.spilled and not eng.sessions.get(sid_b).spilled
    host = sess_a.cache
    assert host.leaves["k"].device.type == "cpu"
    assert torch.equal(host.leaves["k"].view(torch.int16),
                       dev_k.view(torch.int16))
    assert torch.equal(host.leaves["v"].view(torch.int16),
                       dev_v.view(torch.int16))
    snap = METRICS.snapshot()
    assert snap["counters"]["kv_spill.spills"] == spills + 1
    assert snap["gauges"]["kv_spill.host_bytes"] == host.nbytes > 0
    assert snap["gauges"]["kv_spill.spilled_sessions"] == 1
    assert snap["gauges"]["kv_spill.resident_sessions"] == 1

    eng.sessions.ensure_resident(sess_a)
    assert not sess_a.spilled and sess_a.cache.k.device == eng.device
    assert torch.equal(sess_a.cache.k.view(torch.int16), dev_k.view(torch.int16))
    assert torch.equal(sess_a.cache.v.view(torch.int16), dev_v.view(torch.int16))
    assert eng.sessions.get(sid_b).spilled  # made room for A
    assert METRICS.snapshot()["counters"]["kv_spill.restores"] == restores + 1

    ca, c1 = ctl.start_session(["first conversation", "row two"])
    ctl.start_session(["second conversation"])
    np.testing.assert_array_equal(a1.tokens, c1.tokens)
    for turn in (["next turn", "two"], ["and again", "2"]):
        r = eng.continue_session(sid_a, turn)
        np.testing.assert_array_equal(r.tokens,
                                      ctl.continue_session(ca, turn).tokens)
    assert eng.sessions.get(sid_b).spilled


def test_session_guards():
    eng = engine(weights(11))
    sid, _ = eng.start_session(["hello"], max_new_tokens=6)
    with pytest.raises(ValueError, match="exceeds session max_len"):
        eng.continue_session(sid, ["x" * 200], max_new_tokens=6)
    with pytest.raises(ValueError, match="has 1 rows"):
        eng.continue_session(sid, ["a", "b"])
    with pytest.raises(ValueError, match="exceeds session max_len"):
        eng.start_session(["x" * 95], max_new_tokens=6)
    with pytest.raises(KeyError, match="unknown session"):
        eng.continue_session("session-999", ["x"])
    eng.end_session(sid)
    with pytest.raises(KeyError):
        eng.continue_session(sid, ["x"])
    with pytest.raises(ValueError, match="max_resident"):
        tsess.SessionManager(max_resident=0)


def test_kv_host_spill_config_boots():
    """``runtime.kv_host_spill`` is served now: the engine takes it, and
    ``dlt-serve-torch --override runtime.kv_host_spill=true`` boots."""
    from distributed_llms_tpu_torch.cli import serve_main

    eng = engine(weights(12), kv_host_spill=True, max_resident_sessions=2)
    assert eng.sessions.max_resident == 2
    args = serve_main.parser().parse_args(
        ["--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "40",
         "--override", "runtime.kv_host_spill=true"])
    server = serve_main.build_server(args)
    assert server.batcher.paged
