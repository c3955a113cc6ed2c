"""Traffic replay (PyTorch port of ``distributed_llms_tpu/runtime/workload.py``):
the "many users" proxy that drives a serving endpoint with realistic
traffic and scores what came back.

- **Arrival process.**  Per tenant, a Markov-modulated Poisson process
  (MMPP): a two-state calm/burst chain where the burst state multiplies
  the Poisson rate (``burst_rate_x``), entered and left at exponential
  rates, with an optional sinusoidal diurnal envelope over the horizon.
  Seeded ``random.Random`` per tenant: the same specs + horizon + seed
  replay the identical trace (the reference's trace, arrival for
  arrival), so two serving configurations (a fixed fleet and an elastic
  one) are measured against byte-identical offered load.
- **Request shape.**  Per-tenant prompt and output length ranges, and a
  ``shared_frac`` of requests opening with the tenant's shared prefix,
  which exercises the prefix cache and the router's affinity as template
  traffic does.
- **Scoring.**  :func:`summarize` turns replay records into per-tenant
  GOODPUT (tokens/s from requests that met their SLO — work delivered
  late is not goodput) and SLO ATTAINMENT (the fraction of accepted
  requests meeting the TTFT/latency SLOs), plus shed counts and latency
  percentiles.

Pure host code, stdlib only: :func:`replay` drives any HTTP endpoint that
speaks the serving gateway's protocol (``runtime/server.py`` or the
router).
"""

from __future__ import annotations

import asyncio
import json
import math
import random
import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's offered-load model.  ``rate_rps`` is the CALM-state
    Poisson arrival rate; the burst state multiplies it by
    ``burst_rate_x`` and is entered/left at ``burst_enter_hz`` /
    ``burst_exit_hz`` (expected bursts per second / exits per second —
    mean burst length is ``1/burst_exit_hz`` seconds).  ``shared_frac``
    of requests open with this tenant's shared prefix."""

    name: str
    rate_rps: float
    weight: float = 1.0
    prompt_len: tuple[int, int] = (16, 64)   # chars, inclusive range
    output_len: tuple[int, int] = (8, 32)    # max_tokens range
    shared_frac: float = 0.0
    shared_prefix_len: int = 48
    burst_rate_x: float = 1.0
    burst_enter_hz: float = 0.0
    burst_exit_hz: float = 1.0
    priority: int = 0

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"tenant {self.name}: rate_rps must be > 0")
        if not 0.0 <= self.shared_frac <= 1.0:
            raise ValueError(
                f"tenant {self.name}: shared_frac must be in [0, 1]"
            )
        if self.burst_rate_x < 1.0:
            raise ValueError(
                f"tenant {self.name}: burst_rate_x must be >= 1 (the "
                "burst state intensifies, calm is the base rate)"
            )
        for nm, (lo, hi) in (("prompt_len", self.prompt_len),
                             ("output_len", self.output_len)):
            if lo < 1 or hi < lo:
                raise ValueError(
                    f"tenant {self.name}: {nm} must be 1 <= lo <= hi"
                )


@dataclass(frozen=True)
class Arrival:
    """One generated request: submit at ``t`` (seconds from replay
    start), billed to ``tenant``."""

    t: float
    tenant: str
    prompt: str
    max_tokens: int
    priority: int = 0
    shared: bool = False  # opened with the tenant's shared prefix


# Word pool for synthetic prompts: byte-tokenizer-friendly plain text,
# deterministic under the per-tenant RNG.
_WORDS = ("the quick brown fox jumps over a lazy dog while many users "
          "send serving traffic at all hours of the day and night").split()


def _text(rng: random.Random, n_chars: int) -> str:
    out: list[str] = []
    size = 0
    while size < n_chars:
        w = rng.choice(_WORDS)
        out.append(w)
        size += len(w) + 1
    return " ".join(out)[:n_chars].rstrip() or "x"


def shared_prefix(spec: TenantSpec, seed: int = 0) -> str:
    """The tenant's deterministic shared prefix (its "system prompt"):
    a pure function of (tenant name, seed), so every generation run and
    every serving leg sees the same prefix bytes — which is what lets
    the prefix cache and router affinity actually hit across requests."""
    rng = random.Random(f"prefix:{spec.name}:{seed}")
    return _text(rng, spec.shared_prefix_len) + " "


def generate(specs: list[TenantSpec], horizon_s: float, seed: int = 0,
             diurnal_period_s: float | None = None,
             diurnal_amp: float = 0.0) -> list[Arrival]:
    """Generate the merged multi-tenant arrival trace over
    ``[0, horizon_s)``.  Deterministic in (specs, horizon, seed).

    Each tenant runs its own MMPP: exponential inter-arrival gaps at the
    CURRENT rate, with calm<->burst state flips drawn as competing
    exponentials (the flip nearest in time wins — the exact simulation,
    not a discretization).  ``diurnal_period_s`` adds a sinusoidal
    envelope ``1 + diurnal_amp * sin(2*pi*t/period)`` on top (thinning:
    arrivals are kept with probability envelope/max — exact for an
    inhomogeneous Poisson process)."""
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
    if not 0.0 <= diurnal_amp < 1.0:
        raise ValueError(f"diurnal_amp must be in [0, 1), got {diurnal_amp}")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    out: list[Arrival] = []
    for spec in specs:
        rng = random.Random(f"workload:{spec.name}:{seed}")
        prefix = shared_prefix(spec, seed)
        t = 0.0
        burst = False
        while True:
            rate = spec.rate_rps * (spec.burst_rate_x if burst else 1.0)
            gap = rng.expovariate(rate)
            flip_hz = (spec.burst_exit_hz if burst else spec.burst_enter_hz)
            flip_in = (rng.expovariate(flip_hz) if flip_hz > 0
                       else math.inf)
            if flip_in < gap:
                # The state flips before the next arrival would land:
                # advance to the flip and redraw (memorylessness makes
                # the redraw exact).
                t += flip_in
                burst = not burst
                if t >= horizon_s:
                    break
                continue
            t += gap
            if t >= horizon_s:
                break
            if diurnal_period_s:
                envelope = 1.0 + diurnal_amp * math.sin(
                    2.0 * math.pi * t / diurnal_period_s
                )
                # Thinning against the max envelope (1 + amp).
                if rng.random() > envelope / (1.0 + diurnal_amp):
                    continue
            shared = rng.random() < spec.shared_frac
            body = _text(rng, rng.randint(*spec.prompt_len))
            out.append(Arrival(
                t=t, tenant=spec.name,
                prompt=(prefix + body) if shared else body,
                max_tokens=rng.randint(*spec.output_len),
                priority=spec.priority, shared=shared,
            ))
    out.sort(key=lambda a: (a.t, a.tenant, a.prompt))
    return out


@dataclass
class Record:
    """One replayed request's outcome."""

    tenant: str
    t_arrival: float         # scheduled offset (trace time)
    status: int = 0          # HTTP status; 0 = transport failure
    ttft_s: float | None = None   # submit -> first token (stream) or
    #                               submit -> response (buffered)
    latency_s: float = 0.0   # submit -> fully answered
    tokens: int = 0          # completion tokens billed
    itl_s: list[float] = field(default_factory=list)  # inter-token gaps
    retry_after: float | None = None  # the shed's Retry-After hint
    shed_reason: str | None = None    # machine-readable shed reason
    text: str = ""           # concatenated completion deltas — lets a
    #                          caller check byte-exactness against a
    #                          reference, not just count tokens


async def _one_request(host: str, port: int, arr: Arrival,
                       timeout_s: float) -> Record:
    """POST one completion (streamed, so TTFT/ITL are real), one record
    out.  Sheds and transport failures are RECORDS, not exceptions — the
    harness scores them."""
    rec = Record(tenant=arr.tenant, t_arrival=arr.t)
    body = json.dumps({
        "prompt": arr.prompt, "max_tokens": arr.max_tokens,
        "priority": arr.priority, "stream": True,
    }).encode()
    t0 = time.perf_counter()
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except (ConnectionError, OSError):
        rec.latency_s = time.perf_counter() - t0
        return rec
    try:
        writer.write(
            f"POST /v1/completions HTTP/1.1\r\nHost: workload\r\n"
            f"X-Tenant: {arr.tenant}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        await writer.drain()

        async def drive() -> None:
            rec.status = int((await reader.readline()).split()[1])
            headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            if rec.status != 200:
                raw = b""
                clen = headers.get("content-length")
                if clen:
                    raw = await reader.readexactly(int(clen))
                try:
                    rec.retry_after = float(headers.get("retry-after", ""))
                except ValueError:
                    pass
                try:
                    rec.shed_reason = (json.loads(raw)["error"]
                                       .get("reason"))
                except (ValueError, KeyError, TypeError):
                    pass
                return
            # SSE: every data: payload with text counts as a delivery.
            last = None
            buf = b""
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n\n" in buf:
                    evt, buf = buf.split(b"\n\n", 1)
                    if not evt.startswith(b"data: "):
                        continue
                    payload = evt[len(b"data: "):]
                    if payload.strip() == b"[DONE]":
                        return
                    try:
                        obj = json.loads(payload)
                    except ValueError:
                        continue
                    choices = obj.get("choices") or [{}]
                    text = choices[0].get("text") or \
                        (choices[0].get("delta") or {}).get("content", "")
                    if not text and "error" in obj:
                        return
                    if text:
                        now = time.perf_counter()
                        if rec.ttft_s is None:
                            rec.ttft_s = now - t0
                        elif last is not None:
                            rec.itl_s.append(now - last)
                        last = now
                        # Completion CHARS — exactly tokens under the
                        # byte tokenizer every bench/test replica runs;
                        # a close proxy elsewhere.
                        rec.tokens += len(text)
                        rec.text += text
        await asyncio.wait_for(drive(), timeout_s)
    except (asyncio.TimeoutError, ConnectionError, OSError, EOFError,
            ValueError, IndexError, asyncio.IncompleteReadError):
        pass
    finally:
        rec.latency_s = time.perf_counter() - t0
        writer.close()
    return rec


async def replay(host: str, port: int, arrivals: list[Arrival],
                 time_scale: float = 1.0,
                 request_timeout_s: float = 120.0) -> list[Record]:
    """Replay a generated trace against a live endpoint (gateway or
    router): each arrival fires at ``t * time_scale`` seconds after
    start, concurrently (open-loop — a slow server does NOT slow the
    offered load, which is exactly what makes overload measurable).
    Returns one :class:`Record` per arrival, trace order."""

    t_start = time.perf_counter()

    async def fire(arr: Arrival) -> Record:
        delay = arr.t * time_scale - (time.perf_counter() - t_start)
        if delay > 0:
            await asyncio.sleep(delay)
        return await _one_request(host, port, arr, request_timeout_s)

    return list(await asyncio.gather(*[fire(a) for a in arrivals]))


def _pct(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(q * len(vs)))]


def summarize(records: list[Record], horizon_s: float,
              ttft_slo_s: float | None = None,
              latency_slo_s: float | None = None) -> dict[str, dict]:
    """Per-tenant goodput / SLO-attainment curves from replay records.

    - ``slo_attainment``: of the requests the server ACCEPTED (status
      200), the fraction meeting every configured SLO (TTFT and/or
      end-to-end latency).  Sheds are not attainment failures — they are
      counted separately (a 429 with Retry-After is the contract working,
      silent starvation is what attainment catches).
    - ``goodput_tok_s``: completion tokens of SLO-meeting requests per
      second of horizon — late work is not goodput (Shepherd's framing).
    """
    out: dict[str, dict] = {}
    for tenant in sorted({r.tenant for r in records}):
        rs = [r for r in records if r.tenant == tenant]
        ok = [r for r in rs if r.status == 200]

        def met(r: Record) -> bool:
            if ttft_slo_s is not None and (r.ttft_s is None
                                           or r.ttft_s > ttft_slo_s):
                return False
            if latency_slo_s is not None and r.latency_s > latency_slo_s:
                return False
            return True

        good = [r for r in ok if met(r)]
        shed = [r for r in rs if r.status in (429, 503)]
        itls = [g for r in ok for g in r.itl_s]
        out[tenant] = {
            "offered": len(rs),
            "completed": len(ok),
            "shed": len(shed),
            "shed_with_retry_after": sum(
                1 for r in shed if r.retry_after is not None
            ),
            "failed": len(rs) - len(ok) - len(shed),
            "slo_attainment": (len(good) / len(ok)) if ok else 0.0,
            "goodput_tok_s": sum(r.tokens for r in good) / horizon_s,
            "tok_s": sum(r.tokens for r in ok) / horizon_s,
            "ttft_p50_s": _pct([r.ttft_s for r in ok
                                if r.ttft_s is not None], 0.50),
            "ttft_p95_s": _pct([r.ttft_s for r in ok
                                if r.ttft_s is not None], 0.95),
            "itl_p95_s": _pct(itls, 0.95),
        }
    return out
