"""The port's traffic replay (``runtime/workload.py``) held against the JAX
package's, on the CPU.

- ``generate`` gives the reference's trace, arrival for arrival and field
  for field, for the same specs, horizon and seed: bursty two-state
  tenants, a diurnal envelope, shared prefixes, priorities.  Exact (the
  same ``random.Random`` draws).
- ``summarize`` returns the identical dict on the same records.  Exact.
- ``replay`` drives the port's gateway over HTTP: every answer is a 200
  whose streamed text equals the batcher's temperature-0 stream for the
  prompt (byte-exact), and its records score as the reference's
  ``summarize`` scores them.
- The specs are validated as the reference validates them.
"""

import asyncio
import dataclasses

import pytest
import torch

from distributed_llms_tpu.runtime import workload as jw
from distributed_llms_tpu_torch.runtime import workload as tw
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights

TOK = ByteTokenizer()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(mod):
    return [
        mod.TenantSpec("a", rate_rps=3.0, prompt_len=(200, 600),
                       output_len=(32, 96), shared_frac=0.5,
                       burst_rate_x=4.0, burst_enter_hz=0.2,
                       burst_exit_hz=1.0),
        mod.TenantSpec("b", rate_rps=1.5, weight=2.0, prompt_len=(16, 64),
                       output_len=(8, 32), shared_frac=0.1,
                       shared_prefix_len=24, priority=1),
    ]


@pytest.mark.parametrize("seed,diurnal", [(0, None), (7, 60.0), (3, 13.0)])
def test_generate_equals_the_reference(seed, diurnal):
    kw = dict(horizon_s=60.0, seed=seed)
    if diurnal:
        kw.update(diurnal_period_s=diurnal, diurnal_amp=0.9)
    got = tw.generate(_specs(tw), **kw)
    want = jw.generate(_specs(jw), **kw)
    assert len(got) == len(want) > 50
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert any(a.shared for a in got) and not all(a.shared for a in got)
    for spec_t, spec_j in zip(_specs(tw), _specs(jw)):
        assert tw.shared_prefix(spec_t, seed) == jw.shared_prefix(spec_j,
                                                                   seed)


def test_the_diurnal_envelope_thins_the_trough():
    """Amplitude 0.9 over a period of the horizon: the first half (the
    sine's crest) expects (0.5 + 0.9/pi) / (0.5 - 0.9/pi) = 3.7 times the
    second half's arrivals; bursts add noise, so this asks for 2x."""
    arr = tw.generate(_specs(tw), 60.0, seed=1, diurnal_period_s=60.0,
                      diurnal_amp=0.9)
    first = sum(1 for a in arr if a.t < 30.0)
    assert first > 2 * (len(arr) - first)


def _records(mod):
    R = mod.Record
    return [
        R("a", 0.1, status=200, ttft_s=0.05, latency_s=0.4, tokens=12,
          itl_s=[0.01, 0.02, 0.03], text="x" * 12),
        R("a", 0.2, status=200, ttft_s=0.9, latency_s=2.5, tokens=30,
          itl_s=[0.05] * 5),
        R("a", 0.3, status=429, latency_s=0.01, retry_after=1.0,
          shed_reason="tenant_quota"),
        R("a", 0.4, status=503, latency_s=0.01),
        R("b", 0.5, status=200, ttft_s=None, latency_s=0.3, tokens=4),
        R("b", 0.6, status=0, latency_s=3.0),
        R("b", 0.7, status=200, ttft_s=0.2, latency_s=0.6, tokens=9,
          itl_s=[0.02, 0.04]),
    ]


@pytest.mark.parametrize("slo", [dict(), dict(ttft_slo_s=0.5),
                                 dict(ttft_slo_s=0.5, latency_slo_s=1.0)])
def test_summarize_equals_the_reference(slo):
    got = tw.summarize(_records(tw), 10.0, **slo)
    want = jw.summarize(_records(jw), 10.0, **slo)
    assert got == want
    assert got["a"]["shed"] == 2 and got["a"]["shed_with_retry_after"] == 1
    assert got["b"]["failed"] == 1


@pytest.mark.parametrize("bad", [
    dict(rate_rps=0.0), dict(shared_frac=1.5), dict(burst_rate_x=0.5),
    dict(prompt_len=(0, 4)), dict(output_len=(9, 3)),
])
def test_specs_validate_as_the_reference(bad):
    kw = dict(name="t", rate_rps=1.0, **{k: v for k, v in bad.items()
                                          if k != "rate_rps"})
    if "rate_rps" in bad:
        kw["rate_rps"] = bad["rate_rps"]
    with pytest.raises(ValueError) as e_t:
        tw.TenantSpec(**kw)
    with pytest.raises(ValueError) as e_j:
        jw.TenantSpec(**kw)
    assert str(e_t.value) == str(e_j.value)
    for args in ((-1.0,), (10.0, 0, None, 1.0)):
        with pytest.raises(ValueError):
            tw.generate(_specs(tw), *args)


def test_replay_through_the_gateway_is_exact():
    w = numpy_weights()

    def batcher(**kw):
        return tb.ContinuousBatcher(
            w[1], w[3], **{**dict(tokenizer=TOK, eos_id=TOK.eos_id,
                                  pad_id=TOK.pad_id, batch_slots=2,
                                  max_len=96, chunk_steps=4, paged_pages=24,
                                  page_size=16, prefix_cache=True), **kw})

    specs = [tw.TenantSpec("a", rate_rps=8.0, prompt_len=(8, 24),
                           output_len=(3, 6), shared_frac=0.5,
                           shared_prefix_len=20),
             tw.TenantSpec("b", rate_rps=6.0, prompt_len=(8, 24),
                           output_len=(3, 6))]
    arrivals = tw.generate(specs, 0.8, seed=4)
    assert len(arrivals) >= 4
    solo = batcher(paged_pages=40, prefix_cache=False)
    rids = [solo.submit(a.prompt, max_new_tokens=a.max_tokens)
            for a in arrivals]
    res = solo.run()
    want = [TOK.decode(res[r]) for r in rids]

    async def fn():
        server = InferenceServer(batcher(), model_name="tiny",
                                 host="127.0.0.1", port=0)
        _, port = await server.start()
        try:
            return await tw.replay("127.0.0.1", port, arrivals,
                                   time_scale=0.2, request_timeout_s=60.0)
        finally:
            await server.stop()
            server.batcher.assert_pool_consistent()

    recs = asyncio.run(fn())
    assert [r.status for r in recs] == [200] * len(arrivals)
    assert [r.text for r in recs] == want
    assert all(r.ttft_s is not None and r.latency_s >= r.ttft_s
               for r in recs)
    jrecs = [jw.Record(**dataclasses.asdict(r)) for r in recs]
    assert tw.summarize(recs, 0.8, ttft_slo_s=30.0) == jw.summarize(
        jrecs, 0.8, ttft_slo_s=30.0)
