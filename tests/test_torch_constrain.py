"""Constrained output on the port (``runtime/constrain.py`` and the batcher's
mask leg) against the JAX package's, on the CPU.

- The compiler: for the same constraint, tokenizer and vocabulary the two
  stacks build array-equal automata (``bias``, ``next``, ``accept``,
  ``allowed``, the EOS id, the pattern) and array-equal span stacks
  (``build_stack``: tables and offsets, padded or not); the char DFA's
  tables and its matches agree; the reference's rejection cases raise the
  same ``ConstraintError`` text.  The LRU hit path returns the same object.
- The device leg: ``gather_bias`` / ``advance_states`` and
  ``sample_rows(mask_rows=)`` equal the reference's on the same arrays.
- Streams: temperature-0 constrained streams (a regex, a JSON schema, a
  ``logit_bias`` and a ``banned_tokens`` request beside a free one) equal
  the reference batcher's token for token, paged with the prefix cache and
  contiguous, under the synchronous loop, the dispatch-ahead loop and the
  mixed schedule with chunked prefill; with int8 pages; and across a swap
  preemption, where they also equal the unpressured run.
- Mask semantics where bytes cannot match (sampled rows): every token a
  sampled constrained row emits is allowed in its automaton state, and
  the finished outputs match their pattern.
- Free rows next to constrained rows equal a constraint-free batch, tokens
  and logprobs to the bit; ``logit_bias`` and ``banned_tokens`` ride the
  one mask path; a speculative batcher refuses every constraint.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import constrain as JC
from distributed_llms_tpu.runtime import sampling as js
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JTok
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import constrain as TC
from distributed_llms_tpu_torch.runtime import sampling as ts
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights

TOK = ByteTokenizer()
V = 512
TOOL_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"enum": ["get_weather", "get_time"]},
        "args": {
            "type": "object",
            "properties": {
                "city": {"type": "string", "maxLength": 8},
                "celsius": {"type": "boolean"},
            },
            "required": ["city", "celsius"],
        },
    },
    "required": ["name", "args"],
}
CASES = {
    "regex_digits": dict(response_format={"type": "regex",
                                          "regex": "[0-9]{2,6}"}),
    "regex_alt": dict(response_format={"type": "regex",
                                       "regex": r"(?:ab|a[0-9]{2,3})c?"}),
    "regex_date": dict(response_format={"type": "regex",
                                        "regex": r"\d{4}-\d{2}-\d{2}"}),
    "schema_tool": dict(response_format={
        "type": "json_schema", "json_schema": {"schema": TOOL_SCHEMA}}),
    "schema_array": dict(response_format={
        "type": "json_schema", "schema": {
            "type": "array", "items": {"type": "integer"}, "maxItems": 4}}),
    "schema_mixed": dict(response_format={"type": "json_schema", "schema": {
        "type": "object",
        "properties": {"s": {"type": "string", "maxLength": 16},
                       "n": {"type": "integer"}, "b": {"type": "boolean"},
                       "e": {"enum": ["red", "green", 3]},
                       "x": {"type": "number", "minimum": 0},
                       "z": {"type": "null"}},
        "required": ["s", "n", "b", "e", "x", "z"]}}),
    "bias": dict(logit_bias={"65": 5.5, "66": -100, "300": 1}),
    "banned": dict(banned_tokens=[65, 1, 258]),
    "regex_bias_banned": dict(
        response_format={"type": "regex", "regex": "[a-f]{3,9}"},
        logit_bias={"97": 2.0, "98": -3.0}, banned_tokens=[99]),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def compiled(mod, case):
    tok = JTok() if mod is JC else TOK
    return mod.compile_request(**CASES[case], tokenizer=tok, vocab_size=V,
                               eos_id=tok.eos_id)


def _tables(d):
    return (d.bias, d.next, d.accept, d.allowed)


# -- the compiler ---------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_automata_are_array_equal(case):
    want, got = compiled(JC, case), compiled(TC, case)
    for a, b in zip(_tables(want), _tables(got)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got.eos_id, got.pattern, got.n_states) == (
        want.eos_id, want.pattern, want.n_states)
    if got.pattern:
        cw, cg = JC.regex_to_char_dfa(got.pattern), TC.regex_to_char_dfa(
            got.pattern)
        assert np.array_equal(cw.trans, cg.trans)
        assert np.array_equal(cw.accept, cg.accept)


@pytest.mark.parametrize("pad", [None, 256], ids=["tight", "padded"])
def test_stacks_are_array_equal(pad):
    names = ["regex_digits", "schema_tool", "bias", "regex_bias_banned"]
    bw, nw, ow = JC.build_stack([compiled(JC, c) for c in names], V,
                                pad_states_to=pad)
    bt, nt, ot = TC.build_stack([compiled(TC, c) for c in names], V,
                                pad_states_to=pad)
    assert np.array_equal(bw, bt) and np.array_equal(nw, nt) and ow == ot
    assert bt.shape[0] == (pad or 1 + sum(
        compiled(TC, c).n_states for c in names))


def test_char_dfa_matches_agree():
    pat = r"(?:ab|a[0-9]{2,3})c?"
    dw, dt = JC.regex_to_char_dfa(pat), TC.regex_to_char_dfa(pat)
    for s in ("ab", "a12", "a123c", "abc", "a1", "a1234", "", "b"):
        assert TC.char_dfa_matches(dt, s.encode()) == \
            JC.char_dfa_matches(dw, s.encode()) == bool(
                re.fullmatch(pat, s)), s
    rx = TC.schema_to_regex(TOOL_SCHEMA)
    assert rx == JC.schema_to_regex(TOOL_SCHEMA)
    good = {"name": "get_time", "args": {"city": "oslo", "celsius": True}}
    assert TC.validates(TOOL_SCHEMA, good)
    assert not TC.validates(TOOL_SCHEMA, {**good, "name": "nope"})


REJECTIONS = {
    "empty_language": lambda m: m.regex_to_char_dfa(r"a[^\x00-\xff]b"),
    "bad_repeat": lambda m: m.regex_to_char_dfa("a{3,2}"),
    "bad_escape": lambda m: m.regex_to_char_dfa(r"\ba\b"),
    "open_class": lambda m: m.regex_to_char_dfa("["),
    "not_required": lambda m: m.schema_to_regex(
        {"type": "object", "properties": {"a": {"type": "null"}},
         "required": []}),
    "bad_type": lambda m: m.schema_to_regex({"type": "frobnicate"}),
    "any_of": lambda m: m.schema_to_regex({"anyOf": [{"type": "null"}]}),
    "empty_enum": lambda m: m.schema_to_regex({"enum": []}),
    "maximum": lambda m: m.schema_to_regex({"type": "integer",
                                            "maximum": 10}),
    "minimum": lambda m: m.schema_to_regex({"type": "integer",
                                            "minimum": 5}),
    "additional": lambda m: m.schema_to_regex(
        {"type": "object", "properties": {}, "required": [],
         "additionalProperties": True}),
    "format_type": lambda m: m.compile_request(
        {"type": "xml"}, tokenizer=TOK, vocab_size=V, eos_id=258),
    "bias_range": lambda m: m.compile_request(
        logit_bias={"65": 101.0}, vocab_size=V, eos_id=258),
    "bias_key": lambda m: m.compile_request(
        logit_bias={"x": 1.0}, vocab_size=V, eos_id=258),
    "banned_vocab": lambda m: m.compile_request(
        banned_tokens=[V], vocab_size=V, eos_id=258),
    "banned_empty": lambda m: m.compile_request(
        banned_tokens=[], vocab_size=V, eos_id=258),
    "ban_dead_end": lambda m: m.compile_request(
        {"type": "regex", "regex": "a"}, banned_tokens=[97],
        tokenizer=TOK, vocab_size=V, eos_id=258),
    "no_eos": lambda m: m.compile_request(
        {"type": "regex", "regex": "a"}, tokenizer=TOK, vocab_size=V,
        eos_id=-1),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejections_raise_the_reference_errors(case):
    with pytest.raises(JC.ConstraintError) as want:
        REJECTIONS[case](JC)
    with pytest.raises(TC.ConstraintError) as got:
        REJECTIONS[case](TC)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_compile_cache_hit_path():
    TC.clear_cache()
    rf = {"type": "regex", "regex": "[0-9]{1,4}"}
    hits0 = METRICS.get_counter("batcher.constrain.cache_hits")
    a = TC.compile_request(rf, tokenizer=TOK, vocab_size=V, eos_id=258)
    st = TC.cache_stats()
    b = TC.compile_request(rf, tokenizer=TOK, vocab_size=V, eos_id=258)
    assert b is a
    assert TC.cache_stats()["hits"] == st["hits"] + 1
    assert TC.cache_stats()["misses"] == st["misses"]
    assert METRICS.get_counter("batcher.constrain.cache_hits") == hits0 + 1
    TC.configure_cache(1)
    TC.compile_request({"type": "regex", "regex": "x"}, tokenizer=TOK,
                       vocab_size=V, eos_id=258)
    assert TC.cache_stats()["size"] == 1
    with pytest.raises(ValueError):
        TC.configure_cache(0)
    TC.configure_cache(64)


# -- the device leg --------------------------------------------------------------


def test_gather_and_advance_equal_the_reference():
    rng = np.random.default_rng(0)
    bias = np.where(rng.random((24, V)) < 0.3, TC.MASK, 0).astype(np.float32)
    nxt = rng.integers(0, 24, (24, V)).astype(np.int32)
    st = rng.integers(0, 24, 6).astype(np.int32)
    tok = rng.integers(0, V, 6).astype(np.int32)
    assert np.array_equal(
        TC.gather_bias(torch.from_numpy(bias), torch.from_numpy(st)).numpy(),
        np.asarray(JC.gather_bias(jnp.asarray(bias), jnp.asarray(st))))
    assert np.array_equal(
        TC.advance_states(torch.from_numpy(nxt), torch.from_numpy(st),
                          torch.from_numpy(tok)).numpy(),
        np.asarray(JC.advance_states(jnp.asarray(nxt), jnp.asarray(st),
                                     jnp.asarray(tok))))


def test_masked_greedy_rows_take_the_reference_argmax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, V)).astype(np.float32)
    mask = np.where(rng.random((4, V)) < 0.9, TC.MASK, 0).astype(np.float32)
    mask[1] = 0.0  # a free row rides an all-zero mask row
    temp = np.zeros((4,), np.float32)
    got = ts.sample_rows(None, torch.from_numpy(logits),
                         torch.from_numpy(temp),
                         mask_rows=torch.from_numpy(mask)).numpy()
    want = np.asarray(js.sample_rows(jax.random.key(0), jnp.asarray(logits),
                                     jnp.asarray(temp),
                                     mask_rows=jnp.asarray(mask)))
    assert np.array_equal(got, want)
    assert got[1] == logits[1].argmax()


# -- streams against the reference ---------------------------------------------

MODES = {"paged": dict(paged_pages=9, page_size=16, prefix_cache=True),
         "contiguous": {}}
LOOPS = {"sync": dict(overlap=False), "overlap": dict(overlap=True),
         "mixed": dict(overlap=True, prefill_chunk=8)}
REQS = [
    (list(range(40, 58)), 14, "regex_digits"),
    ([7, 1, 9], 40, "schema_tool"),
    ([60, 2, 3, 5, 5], 10, "bias"),
    ([4, 4, 4], 12, "banned"),
    ([9, 8, 7, 3, 1], 12, None),
]


def batcher(mod, w, **kw):
    kw = {"batch_slots": 3, "max_len": 64, "chunk_steps": 4,
          "eos_id": TOK.eos_id, "pad_id": TOK.pad_id, **kw}
    if mod is jb:
        kw.pop("overlap", None)
        return jb.ContinuousBatcher(w[0], w[2], tokenizer=JTok(), **kw)
    return tb.ContinuousBatcher(w[1], w[3], tokenizer=TOK, **kw)


def constrained(mod, w, reqs=REQS, temperature=None, **kw):
    b = batcher(mod, w, **kw)
    rids = [b.submit(ids, max_new_tokens=n, temperature=temperature,
                     **(CASES[c] if c else {}))
            for ids, n, c in reqs]
    res = b.run()
    if b.paged:
        b.assert_pool_consistent()
    return [res[r] for r in rids], b.preemptions


_REFERENCE: dict = {}


def reference(key, w, **kw):
    if key not in _REFERENCE:
        _REFERENCE[key] = constrained(jb, w, **kw)
    return _REFERENCE[key]


def _valid(toks, case):
    pat = CASES[case]["response_format"]
    rx = (pat["regex"] if pat["type"] == "regex"
          else TC.schema_to_regex(pat.get("schema")
                                  or pat["json_schema"]["schema"]))
    body = toks[:-1] if toks and toks[-1] == TOK.eos_id else toks
    text = TOK.decode(body).encode()
    dfa = TC.regex_to_char_dfa(rx)
    if toks and toks[-1] == TOK.eos_id:
        return TC.char_dfa_matches(dfa, text)
    state = 0  # cut by the budget: a live prefix
    for byte in text:
        state = int(dfa.trans[state, byte])
        if state < 0:
            return False
    return True


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("mode", list(MODES))
def test_constrained_streams_equal_the_reference(w, mode, loop):
    kw = {**MODES[mode], **LOOPS[loop]}
    want = reference((mode, "prefill_chunk" in kw), w, **kw)
    got = constrained(tb, w, **kw)
    assert got == want
    toks = got[0]
    assert _valid(toks[0], "regex_digits") and _valid(toks[1], "schema_tool")
    assert not set(CASES["banned"]["banned_tokens"]) & set(toks[3])


def test_int8_constrained_streams_equal_the_reference(w):
    kw = dict(MODES["paged"], kv_bits=8, overlap=True)
    want = reference("int8", w, **kw)
    got = constrained(tb, w, **kw)
    assert got == want
    assert _valid(got[0][0], "regex_digits")


STORM = [([7, 1, 9, 2], 44, "long_digits"), ([4, 4, 4, 4], 44, "long_digits"),
         ([9, 8, 7, 3], 44, "long_digits")]
CASES["long_digits"] = dict(response_format={"type": "regex",
                                             "regex": "[0-9]{40,60}"})


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_swap_preempted_constrained_rows_equal_the_reference(w, overlap,
                                                             monkeypatch):
    """Three 44-token rows on 9 pages with a host tier: rows swap out and
    back; each restored row's automaton state is the replay of its emitted
    tokens, and the streams equal the reference's and the unpressured
    run's."""
    replays = []
    restore = tb.ContinuousBatcher._try_restore_swapped

    def restore_checked(self, i, req):
        got = restore(self, i, req)
        if got:
            replays.append(int(self.dfa_row[i]))
            assert self.dfa_row[i] == req.constraint.advance(
                0, self.rows[i].emitted)
        return got

    monkeypatch.setattr(tb.ContinuousBatcher, "_try_restore_swapped",
                        restore_checked)
    kw = dict(page_size=16, paged_pages=9, host_pages=16)
    swaps0 = METRICS.get_counter("batcher.kv_swaps.in")
    want = reference("swap", w, reqs=STORM, **kw)
    got = constrained(tb, w, reqs=STORM, overlap=overlap, **kw)
    assert got == want and got[1] >= 1 and replays
    assert METRICS.get_counter("batcher.kv_swaps.in") > swaps0
    roomy, preempted = constrained(tb, w, reqs=STORM, page_size=16,
                                   paged_pages=16, overlap=overlap)
    assert preempted == 0 and roomy == got[0]
    for toks in got[0]:
        assert _valid(toks, "long_digits")


# -- mask semantics, isolation, the one mask path ------------------------------


def test_sampled_rows_draw_only_allowed_tokens(w):
    """Sampled constrained rows, paged and contiguous: every emitted token
    is allowed in the state its prefix leads to, and every finished output
    matches its pattern."""
    reqs = [([7, 1, 9], 12, "regex_digits"), ([4, 4], 40, "schema_tool"),
            ([9, 8], 16, "regex_bias_banned"), ([3, 3], 8, None)]
    for kw in (MODES["paged"], {}):
        outs, _ = constrained(tb, w, reqs=reqs, temperature=1.2, seed=3,
                              **kw)
        for toks, (_, _, case) in zip(outs, reqs):
            if case is None:
                continue
            dfa = compiled(TC, case)
            state = 0
            for t in toks:
                assert dfa.allowed[state, t], (case, toks)
                if t == TOK.eos_id:
                    break
                state = int(dfa.next[state, t])
            assert _valid(toks, case) if "response_format" in CASES[case] \
                else True
        assert not {99} & set(outs[2])


def test_free_rows_equal_a_constraint_free_batch(w):
    """The same batch with the third request constrained or free: the
    free rows' tokens and logprobs are identical to the bit."""

    def drive(kind):
        b = batcher(tb, w, seed=5)
        rids = [b.submit([7, 1, 9], max_new_tokens=10),
                b.submit([4, 4, 4], max_new_tokens=8, temperature=1.3)]
        b.submit([2, 2], max_new_tokens=16, **(CASES[kind] if kind else {}))
        res = b.run()
        return ([res[r] for r in rids], [b.result_logprobs[r] for r in rids])

    free = drive(None)
    for kind in ("regex_alt", "bias", "banned"):
        assert drive(kind) == free


def test_bias_and_bans_ride_the_mask_path(w):
    b0 = batcher(tb, w)
    r0 = b0.submit([7, 1, 9], max_new_tokens=8)
    free = b0.run()[r0]
    b = batcher(tb, w)
    r = b.submit([7, 1, 9], max_new_tokens=4, logit_bias={"65": 100.0})
    assert b.run()[r][:1] == [65]
    rows0 = METRICS.get_counter("batcher.constrain.rows")
    b2 = batcher(tb, w)
    rb = b2.submit([7, 1, 9], max_new_tokens=8, banned_tokens=[free[0]])
    rn = b2.submit([7, 1, 9], max_new_tokens=8)
    res = b2.run()
    assert free[0] not in res[rb] and res[rb] != free and res[rn] == free
    assert METRICS.get_counter("batcher.constrain.rows") == rows0 + 1
    for bad, what in (({"logit_bias": {"65": 101.0}}, "logit_bias"),
                      ({"banned_tokens": [V]}, "banned")):
        with pytest.raises(ValueError, match=what):
            b2.submit([1], max_new_tokens=2, **bad)


def test_speculative_batcher_refuses_constraints(w):
    msgs = []
    for mod in (jb, tb):
        cfg, params = (w[0], w[2]) if mod is jb else (w[1], w[3])
        b = mod.ContinuousBatcher(
            cfg, params, batch_slots=2, max_len=64, chunk_steps=4,
            tokenizer=TOK, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
            draft_params=params, draft_cfg=cfg, spec_k=2)
        for case in ("regex_digits", "bias", "banned"):
            with pytest.raises(ValueError, match="speculative") as e:
                b.submit([1, 2, 3], max_new_tokens=4, **CASES[case])
            msgs.append(str(e.value))
    assert msgs[:3] == msgs[3:]


def test_constrained_rows_compose_with_the_prefix_cache(w):
    prompt = [5] * 33
    rf = CASES["regex_digits"]
    b = batcher(tb, w, **MODES["paged"])
    r1 = b.submit(prompt, max_new_tokens=10, **rf)
    first = b.run()[r1]
    r2 = b.submit(prompt, max_new_tokens=10, **rf)
    assert b.run()[r2] == first and b.prefix_cached_tokens[r2] >= 32
    assert _valid(first, "regex_digits")
    b.assert_pool_consistent()


def test_schema_output_parses(w):
    outs, _ = constrained(tb, w, reqs=[([60, 2, 3], 70, "schema_tool"),
                                       ([61, 2, 3], 70, "schema_mixed")],
                          batch_slots=2, max_len=96)
    for toks, case in zip(outs, ("schema_tool", "schema_mixed")):
        assert _valid(toks, case)
        if toks[-1] == TOK.eos_id:
            rf = CASES[case]["response_format"]
            schema = rf.get("schema") or rf["json_schema"]["schema"]
            assert TC.validates(schema, json.loads(TOK.decode(toks[:-1])))
