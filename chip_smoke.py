#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``distributed_llms_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing result lines:

1. ``build``  — compile every kernel source under
   ``distributed_llms_tpu_torch/ops/csrc`` (one nvcc per source, started
   together) and print the build seconds and the register report; for the
   split-K decode kernels (K1, K1q, K2, K2q) and K5 also each function's
   registers, spills and static shared memory from ``-Xptxas -v`` and, at
   the served heads (D 128, group 4) or K5's served rows (M 8 and 512,
   int8 and int4) and the flash kernels K3 and K4 (head dims 64, 128 and
   256: threads, query and key tile, ring stages), the threads, dynamic
   shared memory, local (spill) bytes and resident blocks per SM.
2. ``kernel`` — hold each kernel against its plain PyTorch version on the
   card, at its path's shapes: K1 and K1q at Llama-3-8B's heads (H=32,
   KVH=8, D=128; K1q's pools quantized by the port's ``kv_quantize``):
   B=8, page size 64, ragged lengths 1..2048, a shuffled page table, with
   and without garbage past every row's depth; one 8192-slot row at batch
   1 (the model's published context); 16-slot pages over 2048 slots
   (tiles straddling pages); and rows at every edge of the split plan
   (lengths 0, 1, 63-65, each split edge +- 1, 2048, 2049), rows of
   length 0 exactly zero; the same at group 1 for path m's heads
   (Pythia-6.9B's H = KVH = 32, D 128; OPT-125M's H = KVH = 12, D 64):
   the timing shape, one 2048-slot row at batch 1 and the plan's edges
   at those head counts; K2 and its int8 leg K2q at
   Mistral-7B's (B=8, H=32, KVH=8, D=128, S=6144, ragged lengths 1..6144,
   window 4096 and none; and one row of 32768 slots at batch 1, window
   4096 and none), each decode output row within 1% of the plain row's L2
   norm (1% + 2^-7 for the int8 legs), K5 (int8 and int4 weights, bf16 x) at
   Llama-3-8B's projections: M=8 (decode) for wq, wk/wv, gate/up, down and
   wo through ``k_lead=2``, M=512 (prefill) for gate/up, OPT-125M's MLP
   (768 x 3072, 3072 x 768) at M=8, and at the edges of its split plan (M of 1, 16, 17, 64 and 65; a K off the tiles
   cut into uneven splits), each output within 2e-2 + 2^-7 |plain|
   elementwise; the flash
   kernels K3 at path g's shapes (B=1, T=4096, H=32, KVH=8, D=128, causal;
   and window 4096 at T=8192; T=4097 and 127, off the 128-row query
   tiles; head dims 64 and 256 at small sizes) and K4 at path f's
   admission (8192 queries over a 32768-slot row with the first 8192
   slots written, window 4096; the same without causality or window;
   1000 queries at positions 5000 and at 4097, where each query tile ends
   on a key tile's first slot; 16 queries over the 32768 slots; two rows
   written to different lengths; shuffled positions; rows with no live
   key, held to exact zeros; head dims 64 and 256), each output row within
   1% of the plain row's L2 norm; K4's pre-pass (the per-key-tile
   summary) equal to its plain version; and K3's backward (gradients
   through the kernel's autograd function, the bf16 dense recompute)
   within 1% of the float32 gradient.
3. ``timing`` — CUDA-event times of each kernel, its plain version and one
   PyTorch library call computing the same function, beside the least
   time the card could take (the byte and operation bounds).  The decode
   kernels' lines carry their split plan and profiler device time (split
   and merge kernels), the kernel and its SDPA rotated over copies of the
   cache or page pool so that no launch finds its rows in the 50 MB L2
   cache: K1 and K1q at the kernel phase's first shape and at path a's
   own (B=8, 16 pages, lengths 300..364; SDPA over rows gathered before
   the timer) and at path m's group-1 heads (Pythia's and OPT's, the
   timing shape's lengths), K2 and K2q also at batch 1 over one
   32768-slot row (window 4096); K5 at each projection, int8 and int4, with its plan, profiler
   device time, host enqueue time and cuBLAS's device time over the
   dequantized bf16 weight, operands rotated over >= 150 MB; then, for
   information, K1, K2 and K2q at sweeps of split lengths and K5 at sweeps
   of split counts (down, wk/wv).  K3 and K4 carry their tile
   configuration and profiler device time by function (K4's pre-pass
   apart, and timed alone), SDPA's device time beside them, and K4 a
   short admission's time (16 queries over 32768 slots).
4. ``model``  — a small bf16 llama decoding through each kernel on the
   card against the same weights through the plain versions on the CPU:
   a paged bf16 pool (K1), an int8 pool (K1q), a contiguous cache with a
   64-slot sliding window, decoded past the window (K2), int8 and int4
   quantized blocks over a paged bf16 pool (K5 and K1), and with
   ``attn_impl="flash"`` contiguous admissions prefilled through K4
   (plain, and windowed past the window) and one training step's loss and
   gradients (K3 forward, dense-recompute backward).
5. ``serve``  — the port's paths as a user runs them, each through
   ``serve_main.build_server`` at full width with random seeded weights,
   answering concurrent HTTP requests:
   a. ``dlt-serve-torch --preset llama-3-8b --paged-pages 256 --page-size
      64 --prefix-cache`` (K1): completions and chat completions, greedy
      and sampled, one streamed over SSE, three sharing a long prompt
      prefix;
   b. the same with ``--kv-bits 8`` (K1q), the same requests;
   c. ``dlt-serve-torch --preset mistral-7b --max-len 6144`` (contiguous,
      sliding window 4096; K2): one request with a 4400-byte prompt, so
      its decode reads past the window, beside three short ones;
   d. ``dlt-serve-torch --store D8 --override runtime.serve_quantized=true
      --paged-pages 256 --page-size 64 --prefix-cache`` (K5 int8 and K1),
      path a's requests, where D8 is a store of Llama-3-8B's width cut
      to STORE_LAYERS (8) layers (random weights, seed 0) written by the
      port's ``save_shards`` with
      ``quantization="int8"``, 2 raw shards, into a temporary directory
      removed when the path ends;
   e. the same over an int4 store D4 (K5 int4 and K1);
   f. ``dlt-serve-torch --store DF --max-len 32768`` (contiguous, 8 slots,
      Mistral-7B's full context; K4 prefills every admission, K2 decodes),
      where DF is a Mistral-7B store (random weights, seed 0, ``attn_impl
      ="flash"`` in its model config) written with
      ``quantization="int8"`` and dequantized to bf16 at load: one
      streamed request with an 8000-byte prompt (an 8192-token
      admission, past the 4096 window) beside three short ones; then,
      outside HTTP, a prompt of that length admitted alone, its time to
      first token read engine-side from submit to the admission token;
   h. ``dlt-serve-torch --store DL --max-len 32768 --slots 4
      --prefill-chunk 1024``, DL a bf16 store of Mistral-7B's width cut
      to LONG_LAYERS (8) layers (contiguous, dense ``attn_impl="dot"``,
      window 4096, the mixed schedule; K2): three short greedy SSE
      streams decode while a 30000-byte prompt (30001 tokens, no cut)
      admits in 1024-token bites over its 32768-slot row; then, outside
      HTTP, the same traffic timed engine-side (the long prompt's time to
      first token, the short streams' delivery gaps before and while it
      admits, the peak memory), and again on a server booted with
      ``--schedule alternate``: the short greedy streams must be
      identical under the two schedules.
   i. (run by the ``tier`` phase) ``dlt-serve-torch --store DI
      --paged-pages 40 --page-size 64 --prefix-cache --host-pages 128
      --max-len 1024`` (K1) over a bf16 store of Llama-3-8B's width cut to
      STORE_LAYERS (8) layers (random weights, seed 0; a temporary
      directory): a pool of
      39 usable pages (2 MiB each) under 9 streamed greedy requests of
      300-400 bytes and 192 new tokens each — three over a shared
      256-byte prefix (the first alone until admitted), four more without
      it (one with presence/frequency penalties 0.6/0.4), one naming the
      prefix "sys" registered through ``batcher.register_prefix``, and
      after that wave one more over the shared prefix.  Rows must swap out
      and back (>= 2 each, no fallback to recompute), cached pages must
      spill and a hit be restored from the host tier, the pool-and-tier
      audit must pass with no swap parcel left, and every stream must
      equal the same requests' submitted in order engine-side to an
      unpressured batcher (256 pages, no tier) over the same weights; the
      same pair of runs engine-side with ``--kv-bits 8`` (K1q, int8 codes
      and scales swapped verbatim) too.  The penalized stream must differ
      from the plain one and be identical under the three engine loops
      (path i's batcher, pressured: swaps run under each loop); the named
      prefix's first-token logits (``admit_row_with_prefix_paged``'s
      prefill) must agree with the whole prompt's (``admit_row_paged``'s)
      within 5% of the logit scale; a 9-page parcel (bf16, and int8 codes
      with scales) must come back from the pinned host arena equal to the
      bit, its swap-out and restore timed in parts.
   j. (run by the ``spec`` phase) ``dlt-serve-torch --store DJ
      --paged-pages 256 --page-size 64 --prefix-cache --spec-decode
      --max-len 1024``, DJ a bf16 store of Llama-3-8B's width cut to
      SPEC_LAYERS (8) layers (random weights, seed 0; a temporary
      directory removed once booted), (spec_k 4, the int4 self-draft: K5 for the draft's
      projections, K2 for its 4 steps and backfill over its contiguous
      cache, K1 once a layer for the 5-token verify window over 40
      virtual rows): path a's seven prompts, all greedy, 64 new tokens,
      three over the shared prefix, one over SSE, one naming the
      registered prefix "sys".  Then, engine-side over the same weights:
      (a) the HTTP streams against a plain batcher's; (b) the same with
      ``kv_bits=8`` (K1q's window) against the plain int8 batcher; (c)
      an explicit draft, ``attach_draft(cfg, params)`` with the bf16
      target itself, against the plain batcher (its acceptance printed),
      and its streams equal to the int4 self-draft's to the token (a
      greedy round commits the verify's tokens, whatever the draft);
      a greedy stream that leaves the plain one must stay within 4x the
      plain streams' own worst teacher-forced margin of the target's
      greedy choice at every position (the verify's 40-row products round
      differently from a plain step's 8); (d) a sampled batcher
      (temperature 0.8, seed 7): the same streams under the eager loop,
      the graph and the graph with the overlap; (e) the one-launch
      window against 5 single-offset K1 and K1q launches and the plain
      version at path j's shape, every row within 1% of its norm (+ 2^-7
      int8).  The round's cost: 8 requests (300-token prompts, 64 new)
      timed on the speculative batcher and on the plain one, and under
      the profiler the round's device split (draft K5, draft K2, verify
      K1, cuBLAS, the rest).  K1 must launch once a layer a round, K2
      5 times, K5 (int4) 35 times.  Path j's launches ride in the JSON
      line as ``spec_launches``.
   k. (run by the ``constrain`` phase) path a's flags with ``--max-len
      1024`` (K1) over a bf16 store of Llama-3-8B's width cut to
      STORE_LAYERS (8) layers (``--store``, every boot of the path):
      eight concurrent completions of 64 new tokens — two
      JSON-schema ``response_format`` requests (an object with a string of
      at most 16 bytes, an integer, a boolean and an enum; an array of at
      most 4 integers), a regex (``\\d{4}-\\d{2}-\\d{2}``), one with
      ``banned_tokens`` (the first 8 tokens its prompt gives greedily
      unconstrained) and a ``logit_bias``, three free ones (greedy over
      path a's prefix, top-p over SSE, top-k) and the object schema
      sampled at 0.8.  Every constrained output that ended on EOS matches
      its pattern (the JSON ones parse and validate), one cut by the
      budget is a live prefix, no banned token appears, the free greedy
      stream equals the same free requests' served engine-side without the
      constrained ones, and a malformed schema answers 400.  Engine-side
      over the same weights: the constrained greedy set under the three
      engine loops (identical streams, equal to the served ones), with
      int8 pages (K1q; valid outputs), and 8 constrained rows of 192 new
      tokens on path i's 40-page pool with 128 host pages, where rows swap
      out and back (streams equal the unpressured run's).  For
      information: each constraint's compile at V=128256 (cold, then an
      LRU hit), the automaton stack's padded states and MB, and decode ms
      a step with 8 constrained rows against 8 free.  Then two more boots:
      ``--fault batcher.decode:raise@3`` (10 requests on 8 slots: the
      supervisor respawns the batcher, a fresh graph set is captured, the
      requests still queued re-admit and equal an undisturbed run, the
      streamed ones end in the structured ``engine_error``; the respawn's
      wall time and the crash's distance to the first decode delivery
      after it printed) and ``--no-constrained --fault
      batcher.decode:stall@2:3 --watchdog-timeout 1`` (a constrained
      request answers 400; ``/healthz`` turns unhealthy during the stall
      and healthy after).  Path k's launches ride in the JSON line as
      ``constrain_launches``.
   l. (run by the ``generate`` phase) the engine's batch API, as the
      source system's worker calls it, engine-side (no HTTP):
      ``InferenceEngine.from_preset("llama-3-8b", num_layers=8)`` (the
      published width cut to STORE_LAYERS layers since PR 17; bf16,
      max_seq_len 1024, ``kv_host_spill`` with
      ``max_resident_sessions=1``):
      ``generate_text`` on path a's seven prompts and one more (8 ragged
      rows, padded up the bucket ladder to 512, 64 new tokens, greedy;
      the eager decode loop, dense attention under the gapped mask)
      against the paged batcher's greedy streams for the same prompts on
      the same engine (path a's flags); sessions: A (2 rows) opened, B
      opened (A spills to host memory), A continued twice (A restored, B
      spilled), A's turns equal to the same turns on an engine without
      spill, A's first turn held to ``generate_text``, each spill's and
      restore's MB and ms and the ``kv_spill.*`` gauges printed;
      ``runtime.spec_decode`` (the int4 self-draft, spec_k 4):
      ``generate_text`` must route through the standalone speculative
      loop (a spy on ``speculative_generate_tokens``), its greedy streams
      held to the plain ``generate_text``'s, K5 (int4) at least 7 x layers x
      5 x rounds launches, one sampled run (0.8, 16 new tokens) with
      tokens in range and accepted <= drafted; then ``mistral-7b`` with
      ``attn_impl="flash"`` (max_seq_len 6144): ``generate_text`` on
      path c's 4400-byte prompt beside 3 short ones (32 new tokens; the
      short rows' generated slots sit past T at positions len + j, the
      gapped windowed layout), K4 at least once a layer, against the
      contiguous batcher's streams on the same engine, and a session on
      the long prompt whose second turn is held to ``generate_tokens``
      run one-shot over the token history.  Streams are compared by the
      near-tie rule (``GEN_NEAR_TIE``): where one leaves the other, the
      step is recomputed once in float32 and the two tokens' logits must
      lie within 0.1.  Path l's launches ride in the JSON line as
      ``generate_launches``.
   m. (run by the ``families`` phase) the other block families and
      Mixtral-style MoE, each at its published width, random weights from
      seed 0, each engine freed before the next boots:
      ``dlt-serve-torch --preset pythia-6.9b --paged-pages 256
      --page-size 64 --prefix-cache --max-len 2048`` (neox: LayerNorm,
      rotary on 32 of 128 dims, parallel residual, erf gelu; K1 at group
      1) answering path a's seven requests; engine-side path l's eight
      greedy prompts through the paged batcher with bf16 and with int8
      pages (K1q) and through ``generate_text``; ``--preset opt-125m``
      (learned positions with OPT's offset 2, relu, tied embeddings; K1
      at D 64) the same requests, then an int8 store of it written by
      ``save_shards`` and served with ``runtime.serve_quantized=true``
      (every block projection through K5, 6 a layer a step, biases
      added), engine-side the greedy prompts on both, ``generate_text``
      with a 2016-token prompt whose 32 new tokens fill the 2048-slot
      table, and ``gpt2-125m``'s ``generate_text`` (tanh gelu, positions
      without offset); Mixtral-8x7B as an int4 store (experts, router
      and attention int4; drawn and quantized on the card a layer at a
      time; depth cut from 32 to MIXTRAL_LAYERS (8) layers, the published
      width, to keep the whole smoke in its time as path p joined it;
      written once into the process's shared directory, which path s
      serves too) on one engine with ``runtime.serve_quantized`` and
      path m's pool (128 pages of 64, max_len 2048; attention through
      K5, decode through K1, each layer's experts rehydrated to bf16 in
      every forward; its HTTP leg went when path s began to serve it over
      HTTP on its expert mesh): the 8 greedy prompts as one
      batch at 8 slots (capacity 3 a decode step, so claims drop),
      first through the eager chunk with every routing decision
      recorded (the share of claims the decode steps dropped), then
      through the captured chunk graph under the profiler (ms a step,
      the profiler's split, one layer's rehydration timed), whose
      streams must equal the eager ones; and
      one ``Trainer`` step at Mixtral's width cut to 2 layers
      (``attn_impl="flash"``, K3, a [1, 1025] batch): loss, aux term,
      seconds, peak memory, and layer 0's w_gate expert gradient within
      path g's 5% of a float32 recompute on the card that routes every
      claim as the bf16 pass did.  Every greedy stream is held to the
      oracle, the port's uncached float32 forward of the same weights on
      the card (dense attention, weights upcast or dequantized a layer at
      a time, no kernel), teacher-forced on the stream: it equals the
      oracle's greedy choice at every step or leaves it first at a
      near-tie (``FAM_NEAR_TIE``), the gap printed; for Mixtral's
      eager batch the oracle replays the recorded routing — each row's
      padded admission, then its decode tokens with the claims the
      batch dropped — and holds every served expert choice to its own
      float32 router logits by the same margin.  Path m's launches
      ride in the JSON line as ``families_launches``.
   n. (run by the ``fleet`` phase) replica fleets over ONE copy of the
      weights of ``llama-3-8b``'s width cut to STORE_LAYERS layers (a
      bf16 store, random from seed 0, built once by
      ``serve_main._build_engine`` and handed to every fleet through
      ``build_fleet(args, engine_parts=)``), every replica with path a's
      pool flags and ``--max-len 2048``, the fleet's replicas booted at
      once:
      n1. ``--replicas 2`` behind the router: path a's seven requests;
      the three shared-prefix prompts again (each lands by affinity on
      the replica holding its run and hits); a fresh 4-page prefix served
      once and a second prompt over it with ``router.place:drop`` tagged
      at the holder, so the router pulls the run into the cold sibling
      (4 pages imported, a hit); a 5-page prompt's TTFT colocated; a
      crash drill: a fresh prompt held in flight on r0 (its engine gated)
      while ``replica.crash:close`` fires by count at r0's next probe
      tick, the request failing over to r1, then r0 respawned and six
      prompts served by both while r0 captures its graphs.  Engine-side,
      8 greedy requests (300 + 64) timed on one batcher alone and on two
      at once from two threads.
      n2. ``--disaggregate --prefill-replicas 1 --decode-replicas 1``:
      path a's seven requests, three 5-page prompts over path a's prefix
      handed off one at a time (each served from the imported pages), a
      5-page prompt's TTFT handed off, the decode replica's imported
      pages held to the bit against the prefill replica's for the same
      digests on the card; a 1700-byte prompt (26 pages, over MAX_FRAME)
      falls back to colocated prefill ("frame too large"), then
      ``xfer.send:corrupt@1`` (a NACK, the retry lands) and
      ``prefill.crash:close@1`` (colocated fallback), each counted.
      Every handoff's parts timed where they run (export gather, message
      build, frame encode, send to ack, inflate, verify, import).  The
      same handed-off traffic with ``--kv-bits 8`` on both tiers: codes
      and scales byte-equal to the sender's, decode through K1q.
      n3. ``--tenant-weights a:3,b:1 --tenant-max-rows 6
      --tenant-quota-tps 57.6`` on one engine: 16 requests (8 a tenant,
      40-token prompts, 32 new) queued before the first admission; the
      admission order printed, no tenant over 6 rows, tenant a at least 5
      of the first 8; tenant b's 9th request answers 429 with
      ``Retry-After`` (its 8 fill its 576-token window).  Then behind a
      2-replica router tenant b's burst of 9 at once: 8 admitted across
      both replicas and one shed by the router's one ledger.
      Every greedy stream of n1 and n2 is held to a single engine's
      stream for its prompt over the same weights (n2's handed-off ones
      also to the engine's second serving of the prompt, a hit over its
      own pages) by ``GEN_NEAR_TIE``.  Launch counts are process-wide:
      under a fleet they sum every replica's kernels; each leg's K1 (n2's
      int8 leg: K1q) must reach layers x its busiest replica's decode
      steps.  Path n's launches ride in the JSON line as
      ``fleet_launches``.
   o. (run by the ``elastic`` phase) the elastic fleet and the source
      system's control plane:
      o1. ``--store`` path n's store (``llama-3-8b``'s width cut to
      STORE_LAYERS layers, bf16, ONE copy of the weights) with
      path a's pool flags and ``--max-len 1024`` under ``--replicas-min 1
      --replicas-max 2 --autoscale-interval 0.25 --autoscale-hysteresis 2
      --autoscale-cooldown 3`` and ``ELASTIC_UP_LOAD`` /
      ``ELASTIC_DOWN_LOAD``, ``--fault fleet.scale_up:raise@1``, through
      ``build_fleet`` with the autoscaler started and stopped around the
      fleet; the unembedding columns past the byte range scaled by 1/64 so
      the greedy streams decode to text.  A ``runtime/workload.py`` trace
      (two tenants, 200-600-byte prompts, 32-96 new tokens, bursts x4, half
      of tenant a's prompts over a 160-byte shared prefix, a diurnal
      envelope of amplitude 0.9 whose period is the 60 s horizon) replayed
      over HTTP through the router, then a quiet tail.  It fails unless the
      injected scale-up failure is counted, a later scale-up brings the
      fleet to 2 through the boot-time factory, a graceful scale-down
      brings it back to 1, the fleet never leaves [1, 2], the added replica
      captures a decode graph while the first one decodes,
      ``torch.cuda.memory_allocated`` after the scale-down is at least 80%
      of one replica's pool below the two-replica peak, every answer is a
      200 or a 429/503 with ``Retry-After``, the survivor's pool audits
      clean (free + cached = pages - 1, nothing held), and K1 launched 32 x
      the busiest replica's decode steps.  Printed: ``summarize``'s goodput
      and SLO attainment, TTFT p50/p99, sheds, each scale action's seconds.
      o2. an HF checkpoint of Llama-3-8B's published config cut to 8 layers
      (2.8 B parameters from seed 0, a 5.6 GB ``pytorch_model.bin``, the
      unembedding rows past the byte range scaled as in o1), ``python -m
      distributed_llms_tpu_torch.cli.coordinator_main --local-proc 1`` fed
      ``init`` / ``assign`` / ``distribute`` / ``batch`` (8 requests,
      budgets 16-64) / ``status`` / ``exit`` with path a's pool as
      ``--override``s, the worker a second process on the card; then an
      in-process Coordinator + WorkerHost on the same store: the same
      batch, its texts equal to the worker process's and none empty, K1
      counted (8 layers x 63 steps at least), and a
      ``worker.result/GENERATE:close`` drill whose task is retried on a
      worker respawned under the same id.  Printed: convert, store write
      and PLACE_SHARDS seconds, the batch's tokens/s, the worker process's
      device memory at peak (``torch.cuda.mem_get_info`` over the run, less
      what was in use before it).  Path o's launches ride in the JSON line
      as ``elastic_launches``.
   Every path runs the default engine loop: the decode chunk replays a
   captured CUDA graph (``runtime/chunk_graph.py``) and chunks are
   dispatched ahead (``overlap``).  A replay adds the launches its
   capture recorded to each kernel's count.  Paths a, d and i also run 8
   greedy requests (300-token prompts, 64 new tokens, cold admissions)
   on fresh batchers over the served weights under three engine loops —
   graphs with the overlap, graphs without it, and the eager synchronous
   loop (the batcher module's own ``_decode_steps``) — and their token
   streams must be identical.
   Every kernel's launch count is reset just before each path and read
   just after; the run fails unless the path's kernels launched at least
   layers x decode steps times (7 x that for K5, one per projection).
   Each engine is freed before the next boots.  The device memory an
   engine holds once booted (its weights and KV pool, measured with
   ``torch.cuda.memory_allocated``) must be below path a's on paths d and
   e — path a's less its block weights and pool pages of the layers the
   8-layer stores lack — by at least 90% of what their quantized block
   weights save over bf16 (computed from the served leaves), and path d
   must peak below
   path a.  Path f must launch K4 at least 32 times per admission, and
   K4's pre-pass once per K4 launch.
6. ``tier`` — path i (in ``serve``'s list above): the host tier, swap
   preemption, prefix-cache spill, penalties and named prefixes, over a
   bf16 store of Llama-3-8B's width cut to STORE_LAYERS layers.
   ``--phases build,tier`` runs it alone.
6b. ``spec`` — path j (in ``serve``'s list above): speculative decoding.
   ``--phases build,spec`` runs it alone.
6c. ``constrain`` — path k (in ``serve``'s list above): constrained output
   and the fault drills.  ``--phases build,constrain`` runs it alone.
6d. ``generate`` — path l (in ``serve``'s list above): one-shot generation,
   sessions with host spill and the standalone speculative loop.
   ``--phases build,generate`` runs it alone.
6e. ``families`` — path m (in ``serve``'s list above): the gpt2, opt and
   neox families and Mixtral-style MoE.  ``--phases build,families`` runs
   it alone.
6e'. ``expert`` — path s: expert parallelism, on two gloo rank processes
   sharing the one card (:func:`expert_rank`, spawned as path p's).
   s1: ``dlt-serve-torch --store <path m's Mixtral int4 store> --override
   runtime.serve_quantized=true --paged-pages 128 --page-size 64
   --prefix-cache --max-len 2048 --override mesh.expert=2`` (four experts
   a rank, cut along E and still int4; attention, embeddings and the
   pool whole on both) answers path a's seven requests, all greedy, 32 new
   (streams checked for length and vocabulary); before the server
   starts, each rank runs path m's 8 greedy prompts as one batch at 8
   slots engine-side (the same pool and synchronous loop as path m's),
   held to path m's one-rank batch: streams equal, or the earliest
   divergence a near-tie (a token pair or a flipped expert choice within
   FAM_NEAR_TIE of the mesh's logits); each rank's expert bytes must be
   half of the one-rank engine's, its resident memory under
   EXPERT_MEM_SHARE of it, K1 at least layers x its decode steps and K5
   (int4) 4 x that.  Printed: one layer's rehydration a rank beside path
   m's, ms a decode step, the combine's share of it (``Mesh.stats``,
   the 'expert' line), the greedy agreement.  s2: one
   ``Trainer(parallel=)`` step at ``expert=2`` on Mixtral's width cut to
   MIXTRAL_TRAIN_LAYERS layers (path m's weights, batch and lr), held to
   path m's one-rank step: the loss, and layer 0's expert w_gate gradient
   and update (each rank's block) within TRAIN_GRAD_REL, under path m's
   recorded routing where a choice flipped (counted); K3 once a layer.
   s3: one step of path p3's ``Trainer`` (Llama-3-8B's width cut to
   TRAIN_CKPT_LAYERS layers) at ``model=2`` on the same two ranks, held
   to a one-rank step on the same weights and batch: the loss and layer
   0's w_gate gradient within TRAIN_GRAD_REL, and its update there on
   the entries whose sign both gradients determine (AdamW's first step
   moves an entry by lr times its gradient's sign, and the partial sums
   over 'model' round differently in bf16).  When the ``families`` phase
   did not run in the process, path m's Mixtral parts run first.
   ``--phases build,expert`` runs it alone.
6f. ``fleet`` — path n (in ``serve``'s list above): replica fleets, the
   disaggregated KV handoff and tenant QoS.  ``--phases build,fleet``
   runs it alone.
6g. ``elastic`` — path o (in ``serve``'s list above): the autoscaled
   fleet under a replayed trace and the coordinator/worker control
   plane.  ``--phases build,elastic`` runs it alone.
6h. ``mesh`` — path p: data and tensor parallelism, two gloo rank
   processes sharing the one card (spawned through the users' CLIs by
   :func:`mesh_rank`, their counters read from files).  p1:
   ``dlt-serve-torch --store SB --override mesh.model=2`` (SB a bf16
   store of Llama-3-8B at its full width cut to STORE_LAYERS layers,
   seed 0) answers path a's requests over HTTP (rank 0 serves, rank 1
   follows); each rank must launch K1 at least layers x its decode
   steps, only at the local
   heads (H 16 / KVH 4), hold under 60% of a one-rank engine's memory
   after boot, and agree with the one-rank engine's greedy choice on at
   least 90% of the committed tokens (each fed the stream's context);
   the first decode step's logits against the one-rank engine, the ms a
   decode step a rank and the collectives' share are printed.  p2: path
   d's int8 store (int8 pages) through two ``dlt-host-torch`` ranks
   (``cluster.num_processes=2``) under an in-process ``Coordinator``, a
   ``model=2`` mesh and then a ``data=2`` one: an 8-request batch through
   ``generate_requests`` and 4 prompts through ``generate_spmd``; each
   rank must launch K1q and K5 (int8) at its local shapes, the ranks'
   streams must be equal and agree with one rank's engine by p1's rule,
   and under ``data=2`` a row on data rank 1 must reuse a prefix page
   that data rank 0's row wrote.  p3: SB read by the native reader and
   by the plain one (the same bytes and CRC32s, both timed; warm page
   cache), a ``Trainer`` at path g's width cut to 2 layers (2 steps,
   save, restore into a fresh ``Trainer``, 1 step: its loss within 1e-3
   of 3 straight steps'), and a legacy int4 store (pairs along the last
   axis, no ``pack_axis``) serving the same greedy tokens through K5 as
   the current layout.  ``--phases build,mesh`` runs it alone.
6i. ``pipe`` — path q: pipeline parallelism, a Llama-3-8B int8 store at
   its full width and published 32 layers (seed 0; written once, path r
   serves it too) through two
   ``dlt-host-torch`` ranks (``mesh.pipe=2``, ``runtime.microbatches=2``,
   16 layers a stage; :func:`pipe_rank`) sharing the card over gloo under
   an in-process ``Coordinator``: an 8-request mixed-budget batch through
   ``generate_requests`` (the grouped fallback: one wavefront at the
   longest budget) and 4 prompts through ``generate_spmd``, one sampled
   (0.8, top-k 50).  Each rank must hold under 60% of a one-rank engine's
   memory after boot and launch K5 (int8) at least 7 x 16 x its stage
   computes; the ranks' rows must be equal, the sampled one included, and
   the greedy ones agree with the one-rank engine by p1's rule; the
   first decode step's logits against the one-rank engine, the ticks, ms
   a tick and a token round, the ring shift's share and each rank's
   memory are printed.  ``--phases build,pipe`` runs it alone.
6j. ``seq`` — path r: sequence parallelism, a Llama-3-8B int8 store at
   its full width, published 32 layers and 8192-token context (seed 0)
   through two ``dlt-host-torch`` ranks (``mesh.seq=2``;
   :func:`seq_rank`) sharing the card over gloo under an in-process
   ``Coordinator``.  First K4 is held against its plain version and
   timed (beside SDPA's causal kernel) at r2's local shape (B 1, H 16,
   KVH 4, D 128, 8002 x 8002 causal by position).  r1 (ring): an
   8001-token prompt (right-padded to 8002: a 4001-token block a rank)
   beside a short one through ``generate_spmd``, greedy, 16 new tokens,
   then 4 mixed-budget requests through ``generate_requests`` (the
   grouped fallback); r2 (Ulysses, from the store's manifest): the long
   prompt alone.  Each rank must launch K5 (int8) at least 7 x 32 x its
   forwards, under Ulysses K4 at least 32 x its prefills at the local
   shape (none under the ring), hold half the one-rank cache's prompt
   region, and return the same rows as the other rank; the greedy rows
   agree with a one-rank engine (dense, batch 1) by p1's rule; the long
   row's first decode step's logits against it, the shifts, all-to-alls
   and reductions with their seconds, the ms a decode step and the
   long prefill's wall time are printed (``seq_r``).  ``--phases
   build,seq`` runs it alone.
7. ``train`` — path g: ``runtime.train.Trainer`` on Llama-3-8B's width
   (d_model 4096, 32/8 heads, FFN 14336, vocab 128256) cut to 8 layers,
   ``attn_impl="flash"``, random weights from seed 0, AdamW at lr 1e-3:
   3 steps on one fixed batch [2, 4097], then one with ``remat=True``.
   The loss must be finite and fall over the 3 steps, and K3 must launch
   8 times per step (16 under remat).
8. ``profile`` — on paths a and d, the eager synchronous loop and the
   default loop (graphs and overlap) run the 8-request batch once more
   under ``torch.profiler``: device kernel time by class (K5, the
   decode-attention kernels, other matrix products, the rest) and the
   device's busy share, beside each loop's ms per decode step, chunks
   dispatched ahead, carry syncs and mean device gap; path f's weights
   admit one 8000-byte prompt, and path g takes one step, under the
   profiler too, split the same way with the flash kernels apart
   (information, not a gate).

Then the card's name and power limit (nvidia-smi), one JSON line of
per-kernel numbers, and last ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line; so does a machine without CUDA
or a directory without the repository.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bounds below are the least time for the work at these rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

_COMMON_ARGS = ["--slots", "8", "--host", "127.0.0.1", "--port", "0",
                "--seed", "0"]
SERVE_ARGS = ["--preset", "llama-3-8b", "--paged-pages", "256",
              "--page-size", "64", "--prefix-cache", *_COMMON_ARGS]
SERVE_INT8_ARGS = [*SERVE_ARGS, "--kv-bits", "8"]
SERVE_WINDOW_ARGS = ["--preset", "mistral-7b", "--max-len", "6144",
                     *_COMMON_ARGS]
# Paths d and e: SERVE_ARGS over a quantized store in place of the preset.
SERVE_STORE_ARGS = ["--override", "runtime.serve_quantized=true",
                    *SERVE_ARGS[2:]]
# Path h: Mistral-7B at its published context on the default dense
# attention, long prompts admitted by chunked prefill under the mixed
# schedule (and once more under --schedule alternate).
LONG_MAX_LEN = 32768
LONG_PROMPT_BYTES = 30000  # + BOS: 30001 prompt tokens, no cut
PREFILL_CHUNK = 1024
SERVE_LONG_ARGS = ["--preset", "mistral-7b", "--max-len", str(LONG_MAX_LEN),
                   "--slots", "4", "--prefill-chunk", str(PREFILL_CHUNK),
                   "--host", "127.0.0.1", "--port", "0", "--seed", "0"]
SHORT_NEW = 512  # the short streams decode through the long admission
# Path h's depth, cut from Mistral-7B's 32 layers (to keep the whole
# smoke near half its time limit beside path m): every layer
# keeps the published width and the 32768-slot context, so each 1024-token
# bite and decode step is the full model's a layer; served from a bf16
# store of the cut model (the CLI takes no depth for a preset).
LONG_LAYERS = 8
# Paths d and e: Llama-3-8B's int8 and int4 stores cut from 32 layers to
# 8 (the same reason): each layer keeps the published width, so
# every K5 launch is at the full model's shapes.
STORE_LAYERS = 8
# Path f: a flash-config Mistral-7B store at its published context.
FLASH_MAX_LEN = 32768
FLASH_PROMPT_BYTES = 8000  # + BOS: an 8192-token admission bucket
SERVE_FLASH_ARGS = ["--max-len", str(FLASH_MAX_LEN), *_COMMON_ARGS]

# The kernels of the port's paths: name -> (wrapper, counter attribute).
CSRC = "distributed_llms_tpu_torch/ops/csrc/"
KERNELS = {
    "paged_decode_attention": {
        "route": "cuda", "source": CSRC + "paged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:470"},
    "paged_decode_attention_int8": {
        "route": "cuda", "source": CSRC + "paged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:470"},
    "ragged_decode_attention": {
        "route": "cuda", "source": CSRC + "ragged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:338"},
    "ragged_decode_attention_int8": {
        "route": "cuda", "source": CSRC + "ragged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:338"},
    "flash_attention_static": {
        "route": "cuda", "source": CSRC + "flash_attn.cu",
        "replaces": "distributed_llms_tpu/ops/flash.py:291"},
    "flash_attention_dynamic": {
        "route": "cuda", "source": CSRC + "flash_attn.cu",
        "replaces": "distributed_llms_tpu/ops/flash.py:335"},
    # K4's pre-pass: the per-tile summary that stands in for the TPU
    # kernel's per-tile liveness test (pl.when(jnp.any(mask)), :201).
    "flash_tile_summary": {
        "route": "cuda", "source": CSRC + "flash_attn.cu",
        "replaces": "distributed_llms_tpu/ops/flash.py:335"},
    "quant_matmul": {
        "route": "cuda", "source": CSRC + "quant_matmul.cu",
        "replaces": "distributed_llms_tpu/ops/quant_matmul.py:139"},
    "quant_matmul_int4": {
        "route": "cuda", "source": CSRC + "quant_matmul.cu",
        "replaces": "distributed_llms_tpu/ops/quant_matmul.py:139"},
}


def _counters():
    from distributed_llms_tpu_torch.ops import decode_attn, flash, quant_matmul

    return {
        "quant_matmul": (quant_matmul.quant_matmul, "launches"),
        "quant_matmul_int4": (quant_matmul.quant_matmul, "int4_launches"),
        "paged_decode_attention": (decode_attn.paged_decode_attention,
                                   "launches"),
        "paged_decode_attention_int8": (decode_attn.paged_decode_attention,
                                        "int8_launches"),
        "ragged_decode_attention": (decode_attn.ragged_decode_attention,
                                    "launches"),
        "ragged_decode_attention_int8": (decode_attn.ragged_decode_attention,
                                         "int8_launches"),
        "flash_attention_static": (flash.flash_attention, "static_launches"),
        "flash_attention_dynamic": (flash.flash_attention,
                                    "dynamic_launches"),
        "flash_tile_summary": (flash.tile_summary, "launches"),
    }


def reset_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# What one phase leaves for a later one in the same process: stores that
# two paths serve (written once) and path m's one-rank Mixtral results,
# which path s holds its expert mesh against.  The directory goes when
# main() ends.
_SHARED: dict = {}


def _shared_dir() -> str:
    if "dir" not in _SHARED:
        _SHARED["dir"] = tempfile.mkdtemp(prefix="dlt_shared_")
    return _SHARED["dir"]


def shared_store(torch, key: str, write) -> tuple:
    """The store ``key`` under the shared directory, written by
    ``write(torch, out_dir) -> info`` on first use: (its path, its info,
    whether this call wrote it)."""
    got = _SHARED.setdefault("stores", {}).get(key)
    if got is not None:
        return got[0], got[1], False
    path = f"{_shared_dir()}/{key}"
    info = write(torch, path)
    _SHARED["stores"][key] = (path, info)
    return path, info, True


def drop_shared_store(key: str) -> None:
    """Remove the shared store ``key`` once no later path serves it."""
    got = _SHARED.get("stores", {}).pop(key, None)
    if got is not None:
        shutil.rmtree(got[0], ignore_errors=True)


# -- phase 1: build ---------------------------------------------------------

def phase_build() -> None:
    from distributed_llms_tpu_torch.ops import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    check(bool(sources), "no kernel sources found")
    t0 = time.perf_counter()
    built = build.build(sources)
    wall = time.perf_counter() - t0
    for src, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        emit("build", source=src, seconds=round(info["seconds"], 3),
             ptxas=regs)
    emit("build", ok=True, sources=len(sources), wall_s=round(wall, 3))
    from distributed_llms_tpu_torch.ops import decode_attn

    for source, kernel, resources in (
            (decode_attn.PAGED_SOURCE, "K1",
             decode_attn.paged_kernel_resources),
            (decode_attn.RAGGED_SOURCE, "K2",
             decode_attn.ragged_kernel_resources)):
        got = {kernel + ("q" if quant else "") + "_at_D128_G4":
               resources(128, 4, quant) for quant in (False, True)}
        emit("build", source=source,
             functions=ptxas_functions(built[source]["log"]), **got)
    from distributed_llms_tpu_torch.ops import flash

    emit("build", source=flash.SOURCE,
         functions=ptxas_functions(built[flash.SOURCE]["log"]),
         **{f"{'K4' if dynamic else 'K3'}_at_D{d}":
            flash.flash_kernel_resources(d, dynamic)
            for d in flash.HEAD_DIMS for dynamic in (False, True)})
    from distributed_llms_tpu_torch.ops import quant_matmul

    emit("build", source=quant_matmul.SOURCE,
         functions=ptxas_functions(built[quant_matmul.SOURCE]["log"]),
         **{f"K5_int{bits}_M{m}_N{n}":
            quant_matmul.quant_matmul_resources(m, n, bits)
            for m, n in ((8, 14336), (8, 1024), (512, 14336))
            for bits in (8, 4)})


def ptxas_functions(log: str) -> list:
    """Each kernel function's registers, spill stores / loads (bytes) and
    static shared memory from an ``nvcc -Xptxas -v`` report."""
    import re

    funcs, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            if not funcs or funcs[-1]["function"] != m.group(1):
                cur = {"function": m.group(1)}
                funcs.append(cur)
            continue
        if cur is None:
            continue
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return funcs


# -- phase 2/3: kernel checks and timing -----------------------------------

def paged_case(torch, *, b=8, h=32, kvh=8, d=128, blk=64, max_len=2048,
               seed=0, garbage=False, lengths=None):
    """Main-path inputs: bf16 q and pools, ragged lengths in [1, max_len]
    (both ends included; at B=1 the one row is max_len long) unless
    ``lengths`` gives them (B = their count), each row's pages a shuffled
    run of the pool; ``garbage`` puts ids outside the pool in every table
    entry past a row's depth."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = max_len // blk
    if lengths is None:
        lengths = torch.randint(1, max_len + 1, (b,), generator=g)
        lengths[0], lengths[-1] = 1, max_len
    else:
        lengths = torch.tensor(lengths)
        b = len(lengths)
    nb = b * p + 1  # + scratch page 0
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = perm[: b * p].reshape(b, p).to(torch.int32)
    if garbage:
        depth = (lengths.clamp(0, max_len) + blk - 1) // blk
        junk = torch.randint(-(2 ** 30), 2 ** 30, (b, p), generator=g,
                             dtype=torch.int32)
        past = torch.arange(p)[None, :] >= depth[:, None]
        tables = torch.where(past, junk, tables)
    q = torch.randn(b, 1, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(nb, blk, kvh, d, generator=g).to(torch.bfloat16)
    v = torch.randn(nb, blk, kvh, d, generator=g).to(torch.bfloat16)
    dev = torch.device("cuda")
    return (q.to(dev), k.to(dev), v.to(dev),
            lengths.to(torch.int32).to(dev), tables.to(dev))


def quantize_pools(torch, k, v):
    """The int8 leg's pools: the port's kv_quantize of the bf16 pools."""
    from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize

    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    return kq, vq, ks, vs


def ragged_case(torch, *, b=8, h=32, kvh=8, d=128, s=6144, seed=0):
    """Path c's inputs (Mistral-7B at --max-len 6144): bf16 q and a
    contiguous cache, ragged lengths in [1, S] (both ends included; at
    B=1 the one row is S long)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0], lengths[-1] = 1, s
    q = torch.randn(b, 1, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, kvh, d, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, kvh, d, generator=g).to(torch.bfloat16)
    dev = torch.device("cuda")
    return q.to(dev), k.to(dev), v.to(dev), lengths.to(torch.int32).to(dev)


WINDOW = 4096  # Mistral-7B's sliding window

# The flash kernels' main-path shapes: path g's training sequence (K3) and
# path f's admission (K4): a prompt bucket of 8192 tokens prefilled into a
# 32768-slot row, of which the first 8192 are written.
TRAIN_T = 4096
ADMIT_T = 8192


def flash_case(torch, *, b=1, tq, s=None, h=32, kvh=8, d=128, seed=0):
    """bf16 q [B, Tq, H, D] and k/v [B, S, KVH, D] on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = s or tq

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    return draw(b, tq, h, d), draw(b, s, kvh, d), draw(b, s, kvh, d)


def admission_args(torch, tq, s, first=0, window=WINDOW, causal=True):
    """K4's arguments as the cached prefill passes them: queries at
    positions first..first+tq-1 over slots 0..s-1, the first first+tq of
    them written."""
    qpos = (torch.arange(tq, device="cuda") + first)[None]
    kpos = torch.arange(s, device="cuda")[None]
    return {"q_positions": qpos, "k_positions": kpos,
            "k_valid": kpos < first + tq, "causal": causal, "window": window}


def live_pairs(torch, tq, s, kw=None) -> int:
    """(query row, key slot) pairs a flash call attends: K3's causal
    triangle in closed form, K4's counted from its vectors in row chunks."""
    if kw is None:
        return tq * (tq + 1) // 2
    total = 0
    kp = kw["k_positions"][0]
    for r0 in range(0, tq, 1024):
        qp = kw["q_positions"][0, r0:r0 + 1024, None]
        m = kw["k_valid"][0][None, :].expand(qp.shape[0], s)
        if kw["causal"]:
            m = m & (kp[None, :] <= qp)
        if kw["window"] is not None:
            m = m & (kp[None, :] > qp - kw["window"])
        total += int(m.sum())
    return total

# Absolute tolerance of a library yardstick against the plain version, and
# of K5 (plus TOL_REL_QMM below), on bf16 outputs of magnitude ~1.
TOL = 2e-2
# The decode kernels (K1, K1q, K2, K2q) against their plain versions, per
# output row (one query, one head): L2 error <= DECODE_ROW_REL x the plain
# row's L2 norm.  A row over n slots is ~sqrt(e / n) in size (0.026 over
# K2's 4096-slot band), so the absolute 2e-2 used before would pass a wrong
# band edge, a dropped split or a wrong merge.  Sound kernels differ from
# the plain versions by where bf16 rounds the probabilities (per 8-slot
# update and unnormalized in the split kernels, per 64-slot tile in K1,
# normalized in the plain versions) and by the bf16 output rounding.  The
# int8 legs add one bf16 ulp (2^-7) of each term: the plain version rounds
# the dequantized V (bf16(v_i8 * v_scale)) where the kernels, like the TPU
# kernel, round p * v_scale to bf16 and multiply v_i8 exactly.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md): sound rows at most
# 0.0043 (K1, K2) and 0.0062 (K1q, K2q), so the limits keep 2.3x and 2.9x;
# each fault planted in K2/K2q by decode_mutations.py (a band or length
# edge off by one, a dropped split, a merge without its exp(m_s - M)
# rescale, K2q's sum taken after v_scale) reads 0.17-56 at some shape
# below, the weakest 0.028 (the band edge at batch 1).
DECODE_ROW_REL = 1e-2
DECODE_ROW_REL_INT8 = 1e-2 + 2.0 ** -7
# K5 against its plain version: both round the dequantized weight to bf16
# the same way (float32(q) * scale, round to nearest) and accumulate in
# float32, so they differ by the summation order (WMMA tiles of 16 against
# cuBLAS's float32 product, ~1e-6 relative) and then by at most one bf16
# ulp of the output, 2^-7 |out|; outputs here are of scale ~1-5.
TOL_REL_QMM = 2.0 ** -7
# The flash kernels against flash_reference, per output row (one query,
# one head): L2 error <= FLASH_ROW_REL x the row's L2 norm.  A row that
# averages n live keys is ~sqrt(e / n) in size (0.02 at path f's 4096-key
# window), so an absolute limit would pass a wrong key set at these
# lengths.  Sound kernels differ from the plain version by where bf16
# rounds the probabilities (per 128-slot tile under the running max in
# the kernels, under the row's final max in the plain version), exp2 of
# pre-scaled scores against exp, and the bf16 output rounding; planted
# faults are read by decode_mutations.py (PERF.md).
FLASH_ROW_REL = 1e-2
# K3's bf16 backward against the float32 gradient, relative L2 error of
# each of dq, dk, dv: 0.0023-0.0029 measured on the H100.
GRAD_REL = 1e-2

# K5 at Llama-3-8B's projections, in the weights' own layouts: (label, M,
# weight shape, k_lead, int4 pack axis).  M=8 is a decode step of 8 rows,
# M=512 an admission prefill.
QMM_SHAPES = [
    ("wq", 8, (4096, 32, 128), 1, -3),
    ("wk_wv", 8, (4096, 8, 128), 1, -3),
    ("gate_up", 8, (4096, 14336), 1, -2),
    ("down", 8, (14336, 4096), 1, -2),
    ("wo", 8, (32, 128, 4096), 2, -2),
    ("gate_up_prefill", 512, (4096, 14336), 1, -2),
    # Path m's OPT-125M MLP (w_in, w_out) at a decode step of 8 rows.
    ("opt_w_in", 8, (768, 3072), 1, -2),
    ("opt_w_out", 8, (3072, 768), 1, -2),
    # Path p's local blocks: one rank of Llama-3-8B over model=2 (gate/up
    # N-sharded to 7168 columns; down K-sharded to 7168 rows, a partial
    # product the layer sums over 'model').
    ("tp2_gate_up", 8, (4096, 7168), 1, -2),
    ("tp2_down", 8, (7168, 4096), 1, -2),
]
QMM_REPORTED = "gate_up"  # the shape of K5's entries in the JSON line
QMM_ALSO_REPORTED = "down"  # ... and of the "down" entry inside each
QMM_NAMES = {8: "quant_matmul", 4: "quant_matmul_int4"}
# K5 at the edges of its plan (``qmm_plan`` on 132 SMs), each for int8 and
# int4 codes, block 128: (label, M, K, N).  M of 1 and 16 (the decode
# tiles' ends), 17 and 64 (the 64-row prefill tile's: its M tail, and
# full), 65 (the 128-row tile with one row of 65 past the first 64);
# K = 4320 at M = 8 is 67.5 K tiles, cut into 14 splits of 5 with a last
# split of 3 whose last tile is half (uneven splits, a K tail off the
# tiles, int4 pairs at every split edge); the prefill tiles at N = 1024
# split K 16 ways.
QMM_EDGES = [
    ("m1", 1, 4096, 4096),
    ("m16", 16, 4096, 4096),
    ("m17", 17, 4096, 1024),
    ("m64", 64, 4096, 4096),
    ("m65", 65, 4096, 1024),
    ("k_uneven", 8, 4320, 4096),
]


def _held(torch, name, got, want, rel=0.0, **info) -> float:
    """K5's output against its plain version: |err| <= TOL + rel x
    |plain| elementwise; returns the largest |err|.  The line also gives
    the largest |err| / (TOL + rel x |plain|), which passes at <= 1."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} output {tuple(got.shape)}/{got.dtype} vs plain "
          f"{tuple(want.shape)}/{want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} output not finite")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ratio = (diff / (rel * want.float().abs() + TOL)).max().item()
    tol = f"{TOL} + {rel} * |plain|" if rel else TOL
    emit("kernel", name=name, max_abs_err=err, err_over_limit=ratio, tol=tol,
         **info)
    check(ratio <= 1, f"{name} |err| exceeds {tol} (max |err| {err})")
    return err


def qmm_case(torch, m, wshape, k_lead, pack_axis, bits, seed):
    """bf16 activations [M, K-axes] and a weight drawn like ``init_params``'
    (normal / sqrt(fan_in)), rounded to bf16 and quantized by the port's
    ``quantize``, as ``save_shards`` quantizes a bf16 model."""
    from distributed_llms_tpu_torch.checkpoint.quantize import quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    k = math.prod(wshape[:k_lead])
    w = torch.randn(wshape, generator=g, device="cuda") * k ** -0.5
    qt = quantize(w.to(torch.bfloat16), bits=bits, pack_axis=pack_axis)
    x = torch.randn((m, *wshape[:k_lead]), generator=g,
                    device="cuda").to(torch.bfloat16)
    return x, qt


def qmm_edge_case(torch, m, k, n, bits, seed):
    """bf16 x [M, K] and a [K, N] weight, block 128, as ``qmm_case``."""
    from distributed_llms_tpu_torch.checkpoint.quantize import quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
    qt = quantize(w.to(torch.bfloat16), bits=bits, pack_axis=-2)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    return x, qt


def qmm_kernel_checks(torch) -> dict:
    """K5 (int8 and int4) against its plain version at every
    Llama-3-8B projection of QMM_SHAPES and every plan edge of QMM_EDGES;
    returns each width's largest |err|."""
    from distributed_llms_tpu_torch.ops import quant_matmul

    worst = {}
    for bits, name in QMM_NAMES.items():
        cases = [(label, *qmm_case(torch, m, wshape, k_lead, pack, bits,
                                   seed=20 + i), k_lead,
                  {"M": m, "weight": list(wshape), "k_lead": k_lead})
                 for i, (label, m, wshape, k_lead, pack)
                 in enumerate(QMM_SHAPES)]
        cases += [(label, *qmm_edge_case(torch, m, k, n, bits, seed=60 + i),
                   1, {"M": m, "K": k, "N": n})
                  for i, (label, m, k, n) in enumerate(QMM_EDGES)]
        for label, x, qt, k_lead, info in cases:
            q2, s2 = quant_matmul.flatten_qt(qt, k_lead)
            plan = quant_matmul.qmm_plan(
                x.shape[0], s2.shape[0], q2.shape[1],
                quant_matmul._sm_count(x.device))
            err = _held(torch, name,
                        quant_matmul.quant_contract(x, qt, k_lead),
                        qmm_plain(torch, x, qt, k_lead), rel=TOL_REL_QMM,
                        shape=label, plan=list(plan), **info)
            worst[name] = max(worst.get(name, 0.0), err)
        del cases
    _free(torch)
    return worst


def qmm_plain(torch, x, qt, k_lead):
    """K5's plain version on the flat operands, shaped like the output."""
    from distributed_llms_tpu_torch.ops import quant_matmul

    q2, s2 = quant_matmul.flatten_qt(qt, k_lead)
    out = quant_matmul.quant_matmul_plain(x.reshape(x.shape[0], -1), q2, s2,
                                          qt.bits)
    return out.reshape(x.shape[0], *qt.data.shape[k_lead:])


def paged_edge_lengths(torch, b0=8, p=32, blk=64, kvh=8) -> list:
    """Row lengths at every edge of K1's plan for a [B, p] table of
    ``blk``-slot pages: 0, 1, blk - 1, blk, blk + 1, each split edge +- 1,
    P x blk and P x blk + 1.  B is the count of these lengths (the plan
    follows B, so the edges are searched at the B they produce)."""
    from distributed_llms_tpu_torch.ops import decode_attn

    sm = decode_attn._sm_count(torch.device("cuda"))
    reach, n = p * blk, b0
    for _ in range(8):  # B -> plan -> edges -> B, to a fixed point
        split_len, n_splits = decode_attn.paged_split_plan(n, kvh, p, blk,
                                                           sm)
        lengths = {0, 1, blk - 1, blk, blk + 1, reach, reach + 1}
        for i in range(1, n_splits):
            lengths |= {i * split_len - 1, i * split_len + 1}
        if len(lengths) == n:
            break
        n = len(lengths)
    return sorted(lengths)


# K1/K1q kernel-check shapes: (label, paged_case arguments).  Path a's
# timing shape with and without garbage past each row's depth (2-page
# splits), one row at Llama-3-8B's published 8192-token context at batch 1
# (128 one-page splits), 16-slot pages over 2048 slots (8-page splits,
# tiles straddling pages), and every edge of the plan at the timing shape.
# Then path m's heads at group 1 (a query head per KV head, so the plan
# sees 4x path a's KV heads): Pythia-6.9B's (H = KVH = 32, D 128) and
# OPT-125M's (H = KVH = 12, D 64) at the timing shape, over one
# 2048-slot row at batch 1 (their published context), and at every edge
# of the plan at their head counts.
PAGED_CHECKS = [
    ("timing", dict(seed=1)),
    ("timing_garbage", dict(seed=2, garbage=True)),
    ("batch1_8192", dict(b=1, max_len=8192, seed=12, garbage=True)),
    ("page16", dict(blk=16, seed=13, garbage=True)),
    ("edges", dict(seed=14, garbage=True)),
    ("g1_d128", dict(h=32, kvh=32, seed=15, garbage=True)),
    ("g1_d128_batch1", dict(b=1, h=32, kvh=32, seed=16, garbage=True)),
    ("g1_d128_edges", dict(h=32, kvh=32, seed=17, garbage=True)),
    ("g1_d64", dict(h=12, kvh=12, d=64, seed=18, garbage=True)),
    ("g1_d64_batch1", dict(b=1, h=12, kvh=12, d=64, seed=19, garbage=True)),
    ("g1_d64_edges", dict(h=12, kvh=12, d=64, seed=20, garbage=True)),
    # Path p's local heads: one rank of Llama-3-8B over model=2 (H 16,
    # KVH 4), path a's table reach.
    ("tp2_local", dict(h=16, kvh=4, max_len=1024, seed=23, garbage=True)),
    ("tp2_local_edges", dict(h=16, kvh=4, seed=24, garbage=True)),
]


def paged_kernel_checks(torch) -> dict:
    """K1 and K1q at PAGED_CHECKS' shapes; rows of length 0 must be exact
    zeros.  Returns the largest |err| of each."""
    from distributed_llms_tpu_torch.ops import decode_attn

    worst = {"paged_decode_attention": 0.0, "paged_decode_attention_int8": 0.0}
    for label, case in PAGED_CHECKS:
        if label.endswith("edges"):
            case = dict(case, lengths=paged_edge_lengths(
                torch, kvh=case.get("kvh", 8)))
        q, k, v, lengths, tables = paged_case(torch, **case)
        b, blk, p = q.shape[0], k.shape[1], tables.shape[1]
        info = {"shape": label, "B": b, "H": q.shape[2], "KVH": k.shape[2],
                "D": q.shape[3], "BLK": blk, "P": p,
                "split_plan": decode_attn.paged_split_plan(
                    b, k.shape[2], p, blk, decode_attn._sm_count(q.device)),
                "garbage_tables": bool(case.get("garbage"))}
        dead = lengths <= 0
        err = _row_held(torch, "paged_decode_attention",
                        decode_attn.paged_decode_attention(q, k, v, lengths,
                                                           tables),
                        decode_attn.paged_reference(q, k, v, lengths, tables),
                        DECODE_ROW_REL, dead=dead, **info)
        worst["paged_decode_attention"] = max(worst["paged_decode_attention"],
                                              err)
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        err = _row_held(torch, "paged_decode_attention_int8",
                        decode_attn.paged_decode_attention(
                            q, kq, vq, lengths, tables, k_scale=ks,
                            v_scale=vs),
                        decode_attn.paged_reference(q, kq, vq, lengths,
                                                    tables, ks, vs),
                        DECODE_ROW_REL_INT8, dead=dead, **info)
        worst["paged_decode_attention_int8"] = max(
            worst["paged_decode_attention_int8"], err)
        del q, k, v, kq, vq, ks, vs
    _free(torch)
    return worst


def ragged_kernel_checks(torch) -> dict:
    """K2 and K2q at path c's shapes and at batch 1 over one row at
    Mistral-7B's full context, window 4096 and none; returns the largest
    |err| of each."""
    from distributed_llms_tpu_torch.ops import decode_attn

    worst = {"ragged_decode_attention": 0.0,
             "ragged_decode_attention_int8": 0.0}
    for case in (dict(seed=4), dict(b=1, s=FLASH_MAX_LEN, seed=7)):
        q, k, v, lengths = ragged_case(torch, **case)
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        shape = {"B": q.shape[0], "S": k.shape[1]}
        for window in (WINDOW, None):
            plan = decode_attn.ragged_split_plan(
                q.shape[0], k.shape[2], k.shape[1], window,
                decode_attn._sm_count(q.device))
            err = _row_held(torch, "ragged_decode_attention",
                            decode_attn.ragged_decode_attention(
                                q, k, v, lengths, window=window),
                            decode_attn.dense_reference(q, k, v, lengths,
                                                        window),
                            DECODE_ROW_REL, window=window, split_plan=plan,
                            **shape)
            worst["ragged_decode_attention"] = max(
                worst["ragged_decode_attention"], err)
            err = _row_held(torch, "ragged_decode_attention_int8",
                            decode_attn.ragged_decode_attention(
                                q, kq, vq, lengths, window=window,
                                k_scale=ks, v_scale=vs),
                            decode_attn.ragged_reference(
                                q, kq, vq, lengths, window, ks, vs),
                            DECODE_ROW_REL_INT8, window=window,
                            split_plan=plan, **shape)
            worst["ragged_decode_attention_int8"] = max(
                worst["ragged_decode_attention_int8"], err)
        del q, k, v, kq, vq, ks, vs
    _free(torch)
    return worst


def phase_kernel(torch) -> dict:
    worst = {name: 0.0 for name in KERNELS}
    worst.update(paged_kernel_checks(torch))
    worst.update(ragged_kernel_checks(torch))
    worst.update(flash_kernel_checks(torch))
    worst.update(qmm_kernel_checks(torch))
    return {name: {"max_abs_err": e} for name, e in worst.items()}


def row_rel_err(torch, got, want) -> float:
    """The largest error of an attention output row (one query, one head:
    its D values) relative to that row of the plain version, in the L2
    norm.  A zero row of the plain version (a query with no live key)
    must be zero: its ratio is 0 if so, else infinite."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    ratio = torch.where(ref > 0, diff / ref.clamp_min(1e-30),
                        torch.where(diff > 0, math.inf, 0.0))
    return ratio.max().item()


def _row_held(torch, name, got, want, limit, dead=None, **info) -> float:
    """An attention kernel's output against its plain version, row by row:
    L2 error <= ``limit`` x the plain row's L2 norm; returns the largest
    |err| for the JSON line.  ``dead`` ([B] bool): rows with no live slot,
    which must be exact zeros (the plain version averages every slot
    there, so they are held apart)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} output {tuple(got.shape)}/{got.dtype} vs plain "
          f"{tuple(want.shape)}/{want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} output not finite")
    if dead is not None and bool(dead.any()):
        dead_max = got[dead].float().abs().max().item()
        info["dead_rows"], info["dead_rows_max_abs"] = int(dead.sum()), dead_max
        check(dead_max == 0.0, f"{name} row with no live slot is not zero "
              f"({dead_max})")
        got, want = got[~dead], want[~dead]
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(torch, got, want)
    emit("kernel", name=name, max_abs_err=err, max_row_rel_err=rel,
         tol=f"row L2 error <= {limit} x row L2 norm",
         plain_mean_abs=want.float().abs().mean().item(), **info)
    check(rel <= limit, f"{name} row error {rel} exceeds {limit} of the row")
    return err


# K3 against flash_reference: (case, B, T, H, KVH, D, window).  Path g's
# sequence and twice it under Mistral-7B's window; lengths off the 128-row
# query tiles (4097: one row past, 127: one short); head dims 64 and 256.
FLASH_STATIC_CHECKS = [
    ("train", 1, TRAIN_T, 32, 8, 128, None),
    ("train_window", 1, 2 * TRAIN_T, 32, 8, 128, WINDOW),
    ("off_tiles_4097", 1, TRAIN_T + 1, 32, 8, 128, None),
    ("off_tiles_127", 1, 127, 32, 8, 128, None),
    ("d64", 2, 1000, 8, 2, 64, 300),
    ("d256", 1, 600, 16, 16, 256, None),
]


def flash_dynamic_checks(torch):
    """K4's cases: (case, B, Tq, S, KVH, D, keyword arguments).  Path f's
    admission, without causality or window, offset queries (first position
    5000, and 4097, where each 128-row query tile ends on the first slot
    of a key tile: a dead-tile rule that is off by one drops a live tile
    there), two rows written to different lengths (the summary is per
    row), shuffled positions (the summary is loose), a short admission of
    16 queries over 32768 slots, query rows with no live key, and head
    dims 64 and 256."""
    s = FLASH_MAX_LEN
    dev = "cuda"
    cases = [("admission", 1, ADMIT_T, s, 8, 128,
              admission_args(torch, ADMIT_T, s)),
             ("admission_not_causal", 1, ADMIT_T, s, 8, 128,
              admission_args(torch, ADMIT_T, s, 0, None, False)),
             ("offset_5000", 1, 1000, s, 8, 128,
              admission_args(torch, 1000, s, 5000)),
             ("first_off_tiles_4097", 1, 1000, s, 8, 128,
              admission_args(torch, 1000, s, 4097)),
             ("short_admission", 1, 16, s, 8, 128,
              admission_args(torch, 16, s, 8000))]
    # Rows written to 3000 and 8192 slots, each admitting its last 1024.
    written = torch.tensor([[3000], [8192]], device=dev)
    kpos = torch.arange(8192, device=dev).expand(2, 8192)
    cases.append(("per_row_lengths", 2, 1024, 8192, 8, 128, {
        "q_positions": written - 1024 + torch.arange(1024, device=dev),
        "k_positions": kpos, "k_valid": kpos < written, "window": WINDOW}))
    g = torch.Generator(device="cpu").manual_seed(70)
    perm = torch.randperm(8192, generator=g).to(dev)[None]
    cases.append(("shuffled", 1, 1024, 8192, 8, 128, {
        "q_positions": perm[:, :1024], "k_positions": perm, "window": 700}))
    # Row 0 sees slots from position 100 on: its queries at 0..99 have no
    # live key; row 1 is an ordinary prefill at an offset.
    kpos = torch.arange(2048, device=dev).expand(2, 2048)
    first = torch.tensor([[0], [1500]], device=dev)
    cases.append(("rows_without_keys", 2, 256, 2048, 8, 128, {
        "q_positions": first + torch.arange(256, device=dev),
        "k_positions": kpos,
        "k_valid": torch.stack([kpos[0] >= 100, kpos[1] < 1756])}))
    cases.append(("d64", 2, 300, 1500, 2, 64, {
        "q_positions": first + torch.arange(300, device=dev),
        "k_positions": kpos[:, :1500], "k_valid": kpos[:, :1500] < first + 300,
        "window": 100}))
    cases.append(("d256", 1, 200, 700, 4, 256, {
        "q_positions": 500 + torch.arange(200, device=dev)[None],
        "k_positions": kpos[:1, :700]}))
    return cases


def _dead_rows(torch, kw, b, tq, s):
    """[B, Tq] bool: query rows with no live key slot (small cases only)."""
    qp = kw["q_positions"].expand(b, tq).long()[:, :, None]
    kp = kw["k_positions"].expand(b, s).long()[:, None, :]
    live = kw.get("k_valid", torch.ones(b, s, dtype=torch.bool,
                                        device=qp.device))[:, None, :]
    if kw.get("causal", True):
        live = live & (kp <= qp)
    if kw.get("window") is not None:
        live = live & (kp > qp - kw["window"])
    return ~live.any(-1)


def flash_kernel_checks(torch) -> dict:
    """K3 (FLASH_STATIC_CHECKS) and K4 (flash_dynamic_checks) against
    ``flash_reference``, each output row within FLASH_ROW_REL of the plain
    row and rows with no live key exactly zero; K4's pre-pass against its
    plain version, exactly; K3's backward (bf16) against the float32
    gradient of ``dense_reference``."""
    from distributed_llms_tpu_torch.ops import flash

    worst = {"flash_attention_static": 0.0, "flash_attention_dynamic": 0.0,
             "flash_tile_summary": 0.0}
    for case, b, t, h, kvh, d, window in FLASH_STATIC_CHECKS:
        q, k, v = flash_case(torch, b=b, tq=t, h=h, kvh=kvh, d=d,
                             seed=30 + t)
        err = _row_held(torch, "flash_attention_static",
                        flash.flash_attention(q, k, v, window=window),
                        flash.flash_reference(q, k, v, window=window),
                        FLASH_ROW_REL, case=case, B=b, T=t, H=h, KVH=kvh,
                        D=d, window=window)
        worst["flash_attention_static"] = max(
            worst["flash_attention_static"], err)
        del q, k, v
    for case, b, tq, s, kvh, d, kw in flash_dynamic_checks(torch):
        q, k, v = flash_case(torch, b=b, tq=tq, s=s, kvh=kvh, d=d,
                             seed=40 + tq)
        dead = (_dead_rows(torch, kw, b, tq, s) if s * tq <= 1 << 24
                else None)
        err = _row_held(torch, "flash_attention_dynamic",
                        flash.flash_attention(q, k, v, **kw),
                        flash.flash_reference(q, k, v, **kw),
                        FLASH_ROW_REL, dead=dead, case=case, B=b, Tq=tq,
                        S=s, KVH=kvh, D=d, causal=kw.get("causal", True),
                        window=kw.get("window"))
        worst["flash_attention_dynamic"] = max(
            worst["flash_attention_dynamic"], err)
        kp = kw["k_positions"].expand(b, s).to(torch.int32).contiguous()
        kv = kw.get("k_valid", torch.ones(b, s, dtype=torch.bool,
                                          device="cuda")).to(torch.int32)
        got = flash.tile_summary(kp, kv, flash.KEY_TILE[d])
        want = flash.tile_summary_reference(kp, kv, flash.KEY_TILE[d])
        torch.cuda.synchronize()
        diff = (got.long() - want.long()).abs().max().item()
        emit("kernel", name="flash_tile_summary", case=case, B=b, S=s,
             key_tile=flash.KEY_TILE[d], tiles=got.shape[1],
             max_abs_err=diff, tol="exact")
        check(torch.equal(got, want),
              f"flash_tile_summary differs from its plain version ({case})")
        worst["flash_tile_summary"] = max(worst["flash_tile_summary"], diff)
        del q, k, v
    # K3's backward is the dense recompute in bf16; held against the exact
    # (float32) gradient of the same attention, it shows that the recompute
    # differentiates the attention the forward computed.
    q, k, v = flash_case(torch, tq=TRAIN_T, seed=50)
    cot = flash_case(torch, tq=TRAIN_T, seed=51)[0]
    grads = []
    for f, dtype in ((flash.flash_attention, torch.bfloat16),
                     (flash.dense_reference, torch.float32)):
        args = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        (f(*args).float() * cot.float()).sum().backward()
        grads.append([a.grad.float() for a in args])
        del args
    for name, got, want in zip("qkv", *grads):
        rel = ((got - want).norm() / want.norm()).item()
        emit("kernel", name="flash_attention_static_backward", grad_of=name,
             T=TRAIN_T, rel_err=rel, tol=GRAD_REL)
        check(rel <= GRAD_REL,
              f"K3 backward: d{name} off the float32 gradient by {rel}")
    del grads
    _free(torch)
    return worst


def cuda_ms(torch, fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(kv_bytes: int, io_bytes: int, flops: int) -> tuple[float, str]:
    """The least time for the work: the larger of its bytes over the
    memory rate and its operations over the bf16 peak."""
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _turns(torch, kernel, plain, library, plain_iters=20, iters=50,
           plain_warmup=5) -> dict:
    """Turns (plain, kernel, kernel, plain) in one call: compare within
    it.  The library yardstick last."""
    plain_a = cuda_ms(torch, plain, iters=plain_iters, warmup=plain_warmup)
    kern_a = cuda_ms(torch, kernel, iters=iters)
    kern_b = cuda_ms(torch, kernel, iters=iters)
    plain_b = cuda_ms(torch, plain, iters=plain_iters, warmup=plain_warmup)
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "library_ms": (cuda_ms(torch, library, iters=iters)
                           if library else None),
            "kernel_ms_turns": [kern_a, kern_b],
            "plain_ms_turns": [plain_a, plain_b]}


def _timed(name, shapes, t, bound_ms, bound_by, data_bytes, **info) -> dict:
    """Emit one timing line; ``data_bytes`` is the bulk the kernel streams
    (K/V slots, or weight codes and scales)."""
    emit("timing", name=name, shapes=shapes, kernel_ms=t["kernel_ms_turns"],
         plain_ms=t["plain_ms_turns"], library_ms=t["library_ms"],
         bound_ms=bound_ms, bound_by=bound_by, data_bytes=data_bytes,
         achieved_tb_s=data_bytes / (t["ms"] * 1e-3) / 1e12, **info)
    return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"]}


def phase_timing(torch) -> dict:
    out = {}
    out.update(paged_timing(torch))
    out.update(ragged_timing(torch))
    out.update(flash_timing(torch))
    out.update(qmm_timing(torch))
    return out


def _paged_timed(torch, name, q, k, v, lengths, tables, scales=(),
                 **info) -> dict:
    """K1 (or K1q, with ``scales``) on these inputs against its plain
    version and SDPA over each row's pages gathered and padded (over the
    dequantized rows for K1q), the kernel and SDPA rotated over copies of
    the pool holding >= L2_ROTATION_BYTES of live K/V.  SDPA's rows are
    gathered before the timer starts: it is spared the gather."""
    import torch.nn.functional as F

    from distributed_llms_tpu_torch.checkpoint.quantize import kv_dequantize
    from distributed_llms_tpu_torch.ops import decode_attn

    b, _, h, d = q.shape
    _, blk, kvh, _ = k.shape
    p = tables.shape[1]
    lens = lengths.long().clamp(0, p * blk)
    live = int(lens.sum())
    depth = (lens + blk - 1) // blk
    # Least work the function needs on these inputs: each live slot's K
    # and V once (and, int8, its two scales), q and out once, the lengths
    # and the table entries in reach; 2 operations per multiply-add for QK
    # and for PV.
    kv_bytes = live * kvh * ((d + 4) * 2 if scales else d * 2 * 2)
    io_bytes = 2 * q.numel() * 2 + b * 4 + int(depth.sum()) * 4
    copies = _kv_copies(torch, k, v, scales, kv_bytes)
    qt = q.transpose(1, 2).contiguous()  # [B, H, 1, D]
    safe = torch.where(torch.arange(p, device=q.device)[None, :]
                       < depth[:, None], tables.long(), 0)
    mask = (torch.arange(p * blk, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]

    def rows(kc, vc, *sc):  # each row's pages gathered, [B, KVH, S, D] bf16
        if sc:
            kc = kv_dequantize(kc, sc[0], torch.bfloat16)
            vc = kv_dequantize(vc, sc[1], torch.bfloat16)
        return tuple(pool[safe].reshape(b, p * blk, kvh, d).transpose(1, 2)
                     .contiguous() for pool in (kc, vc))

    def kern(c):
        kc, vc, *sc = c
        return lambda: decode_attn.paged_decode_attention(
            q, kc, vc, lengths, tables,
            **({"k_scale": sc[0], "v_scale": sc[1]} if sc else {}))

    def lib(kr, vr):
        return lambda: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=mask, enable_gqa=True)

    lib_kv = [rows(*c) for c in copies]
    ref = decode_attn.paged_reference(q, k, v, lengths, tables, *scales)
    lib_err = (lib(*lib_kv[0])().transpose(1, 2).float()
               - ref.float()).abs().max().item()
    check(lib_err <= TOL, f"{name} library yardstick disagrees ({lib_err})")
    del ref
    t = _turns(torch, _rotate([kern(c) for c in copies]),
               lambda: decode_attn.paged_reference(q, k, v, lengths, tables,
                                                   *scales),
               _rotate([lib(*kv) for kv in lib_kv]), plain_iters=5)
    split_len, n_splits = decode_attn.paged_split_plan(
        b, kvh, p, blk, decode_attn._sm_count(q.device))
    timed = _timed(
        name, {"B": b, "H": h, "KVH": kvh, "D": d, "BLK": blk, "P": p,
               "sum_lengths": live, "min_length": int(lens.min()),
               "max_length": int(lens.max())},
        t, *_bound(kv_bytes, io_bytes, 4 * live * h * d), kv_bytes,
        split_len=split_len, n_splits=n_splits, pool_copies=len(copies),
        device_ms_per_call=_device_ms(torch, _rotate([kern(c)
                                                      for c in copies])),
        host_enqueue_ms_per_call=_enqueue_ms(
            torch, _rotate([kern(c) for c in copies])),
        library="F.scaled_dot_product_attention(attn_mask=lengths, "
                "enable_gqa=True) over each row's pages gathered and "
                "padded before the timer (spared the gather)"
                + (", dequantized" if scales else ""), **info)
    del copies, lib_kv
    return timed


PAGED_SPLIT_SWEEP = (1, 2, 4, 8, 16, 32)  # pages a split


def paged_split_sweep(torch, q, k, v, lengths, tables) -> None:
    """K1 at each split of PAGED_SPLIT_SWEEP pages on these inputs, the
    pool rotated as in the timing lines: CUDA-event ms per call and the
    device ms of its two kernels — what the planner's choice costs against
    the others.  Information, not a gate."""
    from distributed_llms_tpu_torch.ops import decode_attn

    b, blk, kvh = q.shape[0], k.shape[1], k.shape[2]
    p = tables.shape[1]
    live = int(lengths.long().clamp(0, p * blk).sum())
    copies = _kv_copies(torch, k, v, (), live * kvh * k.shape[3] * 4)
    planner = decode_attn.paged_split_plan
    times, device = {}, {}
    try:
        for pages in PAGED_SPLIT_SWEEP:
            if pages > p:
                continue
            decode_attn.paged_split_plan = (
                lambda *a, _p=(pages * blk, -(-p // pages)): _p)
            run = _rotate([
                lambda c=c: decode_attn.paged_decode_attention(
                    q, c[0], c[1], lengths, tables) for c in copies])
            times[pages * blk] = cuda_ms(torch, run)
            device[pages * blk] = sum(_device_ms(torch, run).values())
    finally:
        decode_attn.paged_split_plan = planner
    emit("split_sweep", name="paged_decode_attention", B=b, BLK=blk, P=p,
         planned=planner(b, kvh, p, blk, decode_attn._sm_count(q.device)),
         kernel_ms_by_split_len=times, device_ms_by_split_len=device,
         pool_copies=len(copies))


# Path a's decode rows: 300-token prompts (the profile phase's) and up to
# 64 new tokens, in a table of max_len 1024 / 64 = 16 pages.
PATH_A_LENGTHS = (300, 364)


def paged_timing(torch) -> dict:
    """K1 and K1q at the smoke's timing shape (B=8, 2048-slot tables,
    lengths 1..2048), at path a's own (B=8, 16 pages, lengths 300..364)
    and at the timing shape with path m's group-1 heads (Pythia-6.9B's,
    OPT-125M's), rotated over pool copies; the split-length sweep of K1
    at the first two and at batch 1 over one 8192-slot row."""
    out = {}
    gen = torch.Generator().manual_seed(9)
    path_a = torch.randint(PATH_A_LENGTHS[0], PATH_A_LENGTHS[1] + 1, (8,),
                           generator=gen).tolist()
    for label, case in (("timing", dict(seed=3)),
                        ("path_a", dict(max_len=1024, lengths=path_a,
                                        seed=10)),
                        ("pythia_g1_d128", dict(h=32, kvh=32, seed=21)),
                        ("opt_g1_d64", dict(h=12, kvh=12, d=64, seed=22)),
                        ("tp2_local_path_a", dict(h=16, kvh=4, max_len=1024,
                                                  lengths=path_a, seed=25))):
        q, k, v, lengths, tables = paged_case(torch, **case)
        timed = _paged_timed(torch, "paged_decode_attention", q, k, v,
                             lengths, tables, shape=label)
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        timed_q = _paged_timed(torch, "paged_decode_attention_int8", q, kq,
                               vq, lengths, tables, (ks, vs), shape=label)
        if label == "timing":
            out["paged_decode_attention"] = timed
            out["paged_decode_attention_int8"] = timed_q
        if not label.startswith(("pythia", "opt", "tp2")):
            paged_split_sweep(torch, q, k, v, lengths, tables)
        del q, k, v, kq, vq, ks, vs
        _free(torch)
    q, k, v, lengths, tables = paged_case(torch, b=1, max_len=8192, seed=11)
    paged_split_sweep(torch, q, k, v, lengths, tables)
    del q, k, v
    _free(torch)
    return out


def _ragged_bytes(k, lengths, window, quant) -> tuple[int, int]:
    """(band slots summed over the rows, bytes of K/V the function must
    read): each row's band is [length - window, length) cut to the
    cache; a slot and head is D x 2 bytes of bf16 K and V, or D int8 bytes
    and a float32 scale of each for K2q."""
    s, kvh, d = k.shape[1], k.shape[2], k.shape[3]
    lens = lengths.long()
    end = lens.clamp(min=0, max=s)
    lo = 0 if window is None else (lens - window).clamp(min=0)
    band = int((end - lo).clamp(min=0).sum())
    return band, band * kvh * ((d + 4) * 2 if quant else d * 2 * 2)


def _kv_copies(torch, k, v, scales, kv_bytes):
    """The cache (or page pool) and its copies: enough that a rotation over
    them reads at least L2_ROTATION_BYTES of live K/V (``kv_bytes`` a
    call), so no launch finds its rows in the L2 cache, as a decode step
    finds each layer's cache cold."""
    n = max(1, math.ceil(L2_ROTATION_BYTES / kv_bytes))
    return [(k, v, *scales)] + [tuple(t.clone() for t in (k, v, *scales))
                                for _ in range(n - 1)]


def _ragged_timed(torch, name, q, k, v, lengths, window, scales=()) -> dict:
    """K2 (or K2q, with ``scales``) on these inputs against its plain
    version and SDPA with the band mask (over the dequantized cache for
    K2q), the kernel and SDPA rotated over copies of the cache."""
    import torch.nn.functional as F

    from distributed_llms_tpu_torch.checkpoint.quantize import kv_dequantize
    from distributed_llms_tpu_torch.ops import decode_attn

    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    lens = lengths.long()
    band, kv_bytes = _ragged_bytes(k, lengths, window, bool(scales))
    copies = _kv_copies(torch, k, v, scales, kv_bytes)
    slots = torch.arange(s, device=q.device)[None, :]
    m = slots < lens[:, None]
    if window is not None:
        m = m & (slots >= lens[:, None] - window)
    m = m[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()

    def dense(kc, vc, *sc):  # [B, KVH, S, D] bf16 for SDPA
        if sc:
            kc = kv_dequantize(kc, sc[0], torch.bfloat16)
            vc = kv_dequantize(vc, sc[1], torch.bfloat16)
        return (kc.transpose(1, 2).contiguous(),
                vc.transpose(1, 2).contiguous())

    lib_kv = [dense(*c) for c in copies]

    def kern(c):
        kc, vc, *sc = c
        return lambda: decode_attn.ragged_decode_attention(
            q, kc, vc, lengths, window=window,
            **({"k_scale": sc[0], "v_scale": sc[1]} if sc else {}))

    def lib(kr, vr):
        return lambda: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=m, enable_gqa=True)

    ref = decode_attn.ragged_reference(q, k, v, lengths, window, *scales)
    lib_err = (lib(*lib_kv[0])().transpose(1, 2).float()
               - ref.float()).abs().max().item()
    check(lib_err <= TOL, f"{name} library yardstick disagrees ({lib_err})")
    del ref
    t = _turns(torch, _rotate([kern(c) for c in copies]),
               lambda: decode_attn.ragged_reference(q, k, v, lengths, window,
                                                    *scales),
               _rotate([lib(*kv) for kv in lib_kv]), plain_iters=5)
    split_len, n_splits = decode_attn.ragged_split_plan(
        b, kvh, s, window, decode_attn._sm_count(q.device))
    device_ms = _device_ms(torch, _rotate([kern(c) for c in copies]))
    enqueue_ms = _enqueue_ms(torch, _rotate([kern(c) for c in copies]))
    timed = _timed(
        name, {"B": b, "H": h, "KVH": kvh, "D": d, "S": s, "window": window,
               "sum_band": band},
        t, *_bound(kv_bytes, 2 * q.numel() * 2 + b * 4, 4 * band * h * d),
        kv_bytes,
        split_len=split_len, n_splits=n_splits, cache_copies=len(copies),
        device_ms_per_call=device_ms, host_enqueue_ms_per_call=enqueue_ms,
        library="F.scaled_dot_product_attention(attn_mask=band, "
                "enable_gqa=True)" + (" over the dequantized cache"
                                      if scales else ""))
    del copies, lib_kv
    return timed


def _enqueue_ms(torch, fn, calls=50) -> float:
    """Host milliseconds per call of ``fn`` to enqueue its work (no
    synchronisation between calls): where it reaches the CUDA-event time,
    the calls are bound by the host, not the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def _device_ms(torch, fn, calls=20) -> dict:
    """Device milliseconds per call of ``fn``, by kernel (the profiler's
    CUDA events), beside the CUDA-event time of the calls, which also
    counts the gaps between kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, _, ms in _device_events(torch, prof):
        name = ("merge" if "split_decode_merge" in name else
                "split" if "decode_kernel" in name else _function_name(name))
        out[name] = out.get(name, 0.0) + ms / calls
    return out


def _device_events(torch, prof) -> list:
    """(name, start ns, device ms) of every device activity a profile
    recorded, read from the profiler's raw records: building its event
    tree (``prof.events()``) takes tens of seconds for a decode batch's
    hundreds of thousands of launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _function_name(name: str) -> str:
    """A device function's name without its template arguments and
    parameters (the first 60 characters where none is found)."""
    import re

    m = re.search(r"(\w+)(?:<|\()", name)
    return m.group(1) if m else name[:60]


SPLIT_SWEEP = (64, 128, 256, 512, 1024, 4096)


def ragged_split_sweep(torch, name, q, k, v, lengths, window,
                       scales=()) -> None:
    """K2 (K2q) at each split length of SPLIT_SWEEP on these inputs, the
    cache rotated as in the timing lines: CUDA-event ms per call and the
    device ms of its two kernels — what the planner's choice costs against
    the others.  Information, not a gate."""
    from distributed_llms_tpu_torch.ops import decode_attn

    s, kvh = k.shape[1], k.shape[2]
    span = s if window is None else min(s, window)
    copies = _kv_copies(torch, k, v, scales,
                        _ragged_bytes(k, lengths, window, bool(scales))[1])
    kw = [{"k_scale": c[2], "v_scale": c[3]} if scales else {} for c in copies]
    planner = decode_attn.ragged_split_plan
    times, device = {}, {}
    try:
        for split_len in SPLIT_SWEEP:
            if split_len > span and split_len != SPLIT_SWEEP[0]:
                continue
            n_splits = math.ceil(span / split_len)
            decode_attn.ragged_split_plan = (
                lambda *a, _p=(split_len, n_splits): _p)
            run = _rotate([
                lambda c=c, x=x: decode_attn.ragged_decode_attention(
                    q, c[0], c[1], lengths, window=window, **x)
                for c, x in zip(copies, kw)])
            times[split_len] = cuda_ms(torch, run)
            device[split_len] = sum(_device_ms(torch, run).values())
    finally:
        decode_attn.ragged_split_plan = planner
    emit("split_sweep", name=name, B=q.shape[0], S=s, window=window,
         planned=planner(q.shape[0], kvh, s, window,
                         decode_attn._sm_count(q.device)),
         kernel_ms_by_split_len=times, device_ms_by_split_len=device,
         cache_copies=len(copies))


def ragged_timing(torch) -> dict:
    """K2 at path c's shapes (window 4096 and none) and at batch 1 over one
    row of Mistral-7B's full context (window 4096); K2q at both with the
    window; then the split-length sweep."""
    out = {}
    for case in (dict(seed=5), dict(b=1, s=FLASH_MAX_LEN, seed=8)):
        q, k, v, lengths = ragged_case(torch, **case)
        batch1 = q.shape[0] == 1
        for window in ((WINDOW,) if batch1 else (WINDOW, None)):
            timed = _ragged_timed(torch, "ragged_decode_attention", q, k, v,
                                  lengths, window)
            if window == WINDOW and not batch1:
                out["ragged_decode_attention"] = timed
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        timed = _ragged_timed(torch, "ragged_decode_attention_int8", q, kq,
                              vq, lengths, WINDOW, (ks, vs))
        if not batch1:
            out["ragged_decode_attention_int8"] = timed
        ragged_split_sweep(torch, "ragged_decode_attention", q, k, v,
                           lengths, WINDOW)
        ragged_split_sweep(torch, "ragged_decode_attention_int8", q, kq, vq,
                           lengths, WINDOW, (ks, vs))
        del q, k, v, kq, vq, ks, vs
        _free(torch)
    return out


def flash_timing(torch) -> dict:
    """K3 at path g's shapes and K4 at path f's admission against the plain
    version and SDPA.  Bound: 4 operations (QK and PV, a multiply-add
    each) per live (row, key) pair, head dim and head at the bf16 peak,
    against q, k, v and out read or written once (and K4's vectors)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from distributed_llms_tpu_torch.ops import flash

    out = {}
    # K3: causal self-attention over the training sequence.  Library:
    # SDPA's causal kernel with grouped-query attention.
    q, k, v = flash_case(torch, tq=TRAIN_T, seed=60)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    ref = flash.flash_reference(q, k, v)
    lib_err = (library().transpose(1, 2).float() - ref.float()).abs().max().item()
    check(lib_err <= TOL, f"K3 library yardstick disagrees ({lib_err})")
    pairs = live_pairs(torch, t, t)
    io = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    tm = _turns(torch, lambda: flash.flash_attention(q, k, v),
                lambda: flash.flash_reference(q, k, v), library,
                plain_iters=3, iters=20, plain_warmup=1)
    dev = _device_ms(torch, lambda: flash.flash_attention(q, k, v))
    out["flash_attention_static"] = _timed(
        "flash_attention_static",
        {"B": b, "T": t, "H": h, "KVH": kvh, "D": d, "causal": True,
         "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h * b), io,
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        achieved_tflop_s=4 * pairs * d * h * b / (tm["ms"] * 1e-3) / 1e12,
        device_ms_per_call=dev,
        device_tflop_s=4 * pairs * d * h * b / (dev["flash_kernel"] * 1e-3)
        / 1e12,
        library_device_ms_per_call=_device_ms(torch, library),
        tiles=_tile_config(flash, d, False))
    del q, k, v, qt, kt, vt, ref

    # K4: path f's admission.  Library: SDPA with the boolean mask of the
    # same live pairs, K/V heads expanded (SDPA's masked kernels take no
    # grouped heads); the expansion and the mask are built outside the
    # timed call.
    s = FLASH_MAX_LEN
    q, k, v = flash_case(torch, tq=ADMIT_T, s=s, seed=61)
    kw = admission_args(torch, ADMIT_T, s)
    g = h // kvh
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    kp = kw["k_positions"][0]
    qp = kw["q_positions"][0]
    mask = ((kp[None, :] <= qp[:, None]) & kw["k_valid"][0][None, :]
            & (kp[None, :] > qp[:, None] - WINDOW))[None, None]

    def library():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    ref = flash.flash_reference(q, k, v, **kw)
    try:
        lib_out = library()
    except RuntimeError as e:  # no masked kernel takes these shapes
        emit("timing", name="flash_attention_dynamic", library_error=str(e))
        library = lib_out = None
    if lib_out is not None:
        lib_err = (lib_out.transpose(1, 2).float() - ref.float()).abs().max().item()
        check(lib_err <= TOL, f"K4 library yardstick disagrees ({lib_err})")
    del ref, lib_out
    pairs = live_pairs(torch, ADMIT_T, s, kw)
    io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (ADMIT_T + 2 * s)
    tm = _turns(torch, lambda: flash.flash_attention(q, k, v, **kw),
                lambda: flash.flash_reference(q, k, v, **kw), library,
                plain_iters=1, iters=10, plain_warmup=1)
    # Device time by function: the kernel, its pre-pass, and the wrapper's
    # int32 conversions of the position and validity vectors.
    dev = _device_ms(torch, lambda: flash.flash_attention(q, k, v, **kw))
    out["flash_attention_dynamic"] = _timed(
        "flash_attention_dynamic",
        {"B": b, "Tq": ADMIT_T, "S": s, "H": h, "KVH": kvh, "D": d,
         "window": WINDOW, "written": ADMIT_T, "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h * b), io,
        library="F.scaled_dot_product_attention(attn_mask=bool) under "
                "EFFICIENT_ATTENTION/CUDNN_ATTENTION, K/V heads expanded",
        achieved_tflop_s=4 * pairs * d * h * b / (tm["ms"] * 1e-3) / 1e12,
        device_ms_per_call=dev,
        device_tflop_s=4 * pairs * d * h * b / (dev["flash_kernel"] * 1e-3)
        / 1e12,
        library_device_ms_per_call=(_device_ms(torch, library) if library
                                    else None),
        tiles=_tile_config(flash, d, True))
    del qt, kt, vt, mask

    # K4's pre-pass alone at the admission's vectors.  Plain version: the
    # same table from torch reductions on the card.  Bound: the vectors
    # read once and the table written once.
    bk = flash.KEY_TILE[d]
    kp = kw["k_positions"].to(torch.int32).contiguous()
    kv = kw["k_valid"].to(torch.int32).contiguous()
    n_tiles = -(-s // bk)
    io = 4 * 2 * s + 16 * n_tiles
    tm = _turns(torch, lambda: flash.tile_summary(kp, kv, bk),
                lambda: flash.tile_summary_reference(kp, kv, bk), None)
    out["flash_tile_summary"] = _timed(
        "flash_tile_summary", {"B": b, "S": s, "key_tile": bk,
                               "tiles": n_tiles},
        tm, *_bound(0, io, 0), io,
        device_ms_per_call=_device_ms(
            torch, lambda: flash.tile_summary(kp, kv, bk)))

    # A short admission (information): 16 queries over the 32768 slots
    # launch one query tile a head, 32 blocks on 132 SMs.
    q16 = q[:, :16].contiguous()
    kw16 = admission_args(torch, 16, s, 8000)
    pairs = live_pairs(torch, 16, s, kw16)
    emit("timing", name="flash_attention_dynamic", shape="short_admission",
         shapes={"B": b, "Tq": 16, "S": s, "first_position": 8000,
                 "window": WINDOW, "live_pairs_per_head": pairs},
         kernel_ms=cuda_ms(torch, lambda: flash.flash_attention(
             q16, k, v, **kw16), iters=20),
         device_ms_per_call=_device_ms(torch, lambda: flash.flash_attention(
             q16, k, v, **kw16)),
         bound_ms=_bound(0, 2 * (2 * q16.numel() + k.numel() + v.numel()),
                         4 * pairs * d * h * b)[0])
    del q, k, v, q16
    _free(torch)
    return out


def _tile_config(flash, d, dynamic) -> dict:
    """The tile configuration of a flash kernel instantiation."""
    got = flash.flash_kernel_resources(d, dynamic)
    return {key: got[key] for key in ("threads", "query_tile", "key_tile",
                                      "stages", "smem_bytes")}


# A decode step reads each layer's weights once, cold; a weight that fits
# in the 50 MB L2 cache would time warm if launched on itself.  The K5
# timings rotate over copies of their operands that hold at least this
# many bytes in all.
L2_ROTATION_BYTES = 150e6


def _rotate(fns):
    """One callable that runs ``fns`` in turn."""
    state = {"i": 0}

    def run():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()

    return run


QMM_SPLIT_SWEEP = (1, 2, 4, 8, 16)  # splits of K (at most MAX_SPLITS)
QMM_SWEPT = ("down", "wk_wv")


def qmm_timing(torch) -> dict:
    """K5 at each Llama-3-8B projection shape, int8 and int4, against its
    plain version and cuBLAS over the pre-dequantized bf16 weight, each
    rotated over >= L2_ROTATION_BYTES of operand copies: CUDA-event times,
    the plan, the profiler's device time of K5 and of cuBLAS, and the
    host's enqueue time per call; then, at down and wk/wv, a sweep of split
    counts."""
    from distributed_llms_tpu_torch.checkpoint.quantize import (
        QuantizedTensor, dequantize)
    from distributed_llms_tpu_torch.ops import quant_matmul

    out, also = {}, {}
    for bits, name in QMM_NAMES.items():
        for i, (label, m, wshape, k_lead, pack) in enumerate(QMM_SHAPES):
            x, qt = qmm_case(torch, m, wshape, k_lead, pack, bits, seed=40 + i)
            q2, s2 = quant_matmul.flatten_qt(qt, k_lead)
            k, n = s2.shape[0], q2.shape[1]
            w_bytes = q2.numel() + s2.numel() * 4
            copies = max(1, math.ceil(L2_ROTATION_BYTES / w_bytes))
            qts = [qt] + [QuantizedTensor(qt.data.clone(), qt.scale.clone(),
                                          qt.bits, qt.orig_shape,
                                          qt.pack_axis)
                          for _ in range(copies - 1)]
            x2 = x.reshape(m, k)
            w16 = [dequantize(q, torch.bfloat16).reshape(k, n) for q in
                   qts[:math.ceil(L2_ROTATION_BYTES / (2 * k * n))]]
            plain = qmm_plain(torch, x, qt, k_lead).reshape(m, n).float()
            lib_err = ((torch.matmul(x2, w16[0]).float() - plain).abs()
                       - TOL_REL_QMM * plain.abs()).max().item()
            check(lib_err <= TOL, f"K5 library yardstick disagrees ({label})")

            def kern():
                return _rotate([lambda q=q: quant_matmul.quant_contract(
                    x, q, k_lead) for q in qts])

            def lib():
                return _rotate([lambda w=w: torch.matmul(x2, w) for w in w16])

            t = _turns(
                torch, kern(),
                _rotate([lambda q=q: qmm_plain(torch, x, q, k_lead)
                         for q in qts]), lib())
            io_bytes = 2 * m * k + 2 * m * n
            timed = _timed(
                name, {"shape": label, "M": m, "K": k, "N": n,
                       "weight": list(wshape), "k_lead": k_lead,
                       "bits": bits, "operand_copies": copies},
                t, *_bound(w_bytes, io_bytes, 2 * m * k * n), w_bytes,
                plan=list(quant_matmul.qmm_plan(
                    m, k, n, quant_matmul._sm_count(x.device))),
                device_ms_per_call=_device_ms(torch, kern()),
                library_device_ms_per_call=_device_ms(torch, lib()),
                host_enqueue_ms_per_call=_enqueue_ms(torch, kern()),
                library="torch.matmul over the pre-dequantized bf16 weight "
                        "(cuBLAS; reads 2 bytes per weight, twice int8's "
                        "codes and four times int4's)")
            if label == QMM_REPORTED:
                out[name] = timed
            elif label == QMM_ALSO_REPORTED:
                also[name] = timed
            if label in QMM_SWEPT:
                qmm_split_sweep(torch, name, label, x, qts, k_lead)
            del qts, w16
            _free(torch)
    for name, timed in out.items():
        timed[QMM_ALSO_REPORTED] = also[name]
    return out


def qmm_split_sweep(torch, name, label, x, qts, k_lead) -> None:
    """K5 at each split count of QMM_SPLIT_SWEEP on these operands (rotated
    as in the timing lines): CUDA-event and device ms per call — what the
    planner's choice costs against the others.  Information, not a gate."""
    from distributed_llms_tpu_torch.ops import quant_matmul

    q2, s2 = quant_matmul.flatten_qt(qts[0], k_lead)
    m, k, n = x.shape[0], s2.shape[0], q2.shape[1]
    planner = quant_matmul.qmm_plan
    planned = planner(m, k, n, quant_matmul._sm_count(x.device))
    k_tiles = -(-k // quant_matmul.BK)
    times, device = {}, {}
    try:
        for splits in QMM_SPLIT_SWEEP:
            per = -(-k_tiles // splits)
            plan = (*planned[:2], per * quant_matmul.BK, -(-k_tiles // per))
            quant_matmul.qmm_plan = lambda *a, _p=plan: _p
            run = _rotate([lambda q=q: quant_matmul.quant_contract(
                x, q, k_lead) for q in qts])
            times[plan[3]] = cuda_ms(torch, run)
            device[plan[3]] = sum(_device_ms(torch, run).values())
    finally:
        quant_matmul.qmm_plan = planner
    emit("split_sweep", name=name, shape=label, M=m, K=k, N=n,
         planned=list(planned), kernel_ms_by_splits=times,
         device_ms_by_splits=device, operand_copies=len(qts))


# -- phase 4: a small model through each kernel vs the plain version -------

def _small_cfg(**overrides):
    from distributed_llms_tpu_torch.core.config import ModelConfig

    return ModelConfig(family="llama", vocab_size=512, hidden_size=512,
                       intermediate_size=1024, num_layers=2, num_heads=8,
                       num_kv_heads=2, head_dim=128, max_seq_len=256,
                       tie_embeddings=False, dtype="bfloat16", **overrides)


def _decode_logits(torch, cfg, params_cpu, dev, mode, lens, toks, steps):
    """Admit each row's prompt through the batcher's own admission program
    (prefill + splice into the pool or the row), then decode ``steps``
    teacher-forced tokens; returns the logits of every step on the CPU."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    params = _tree_to(params_cpu, torch.device(dev))
    b = len(lens)
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = None
    if mode == "contiguous":
        cache = model_lib.init_cache(cfg, b, 256, device=dev)
        for r in range(b):
            batcher_lib.admit_row(params, cfg, cache, r,
                                  toks[r, :lens[r]].to(dev), lens[r], gen)
    else:
        cache = batcher_lib._paged_pool(cfg, 1 + 4 * b, 64, device=dev,
                                        kv_bits=8 if mode == "int8" else 16)
        tables = torch.arange(1, 1 + 4 * b, dtype=torch.int32,
                              device=dev).reshape(b, 4)
        for r in range(b):
            batcher_lib.admit_row_paged(params, cfg, cache, tables[r],
                                        toks[r, :lens[r]].to(dev), lens[r],
                                        gen)
    out = []
    pos = torch.tensor(lens, dtype=torch.int32)
    for j in range(steps):
        last = toks[torch.arange(b), pos.long()].to(dev)
        logits, cache = model_lib.forward(
            params, cfg, last[:, None], positions=pos.to(dev)[:, None],
            cache=cache, cache_index=pos.to(dev), kv_tables=tables)
        out.append(logits.float().cpu())
        pos = pos + 1
    return torch.cat(out, dim=1)


def phase_model(torch) -> None:
    """Same bf16 weights and tokens on the card (kernels) and on the CPU
    (plain versions): paged bf16 (K1), int8 pages (K1q), a contiguous
    cache with a 64-slot sliding window decoded past it (K2), and int8 and
    int4 quantized blocks over a paged bf16 pool (K5 for every projection
    of every admission and decode step, K1).  Logits must agree to bf16
    noise, and each kernel must have run for every layer of every step."""
    from distributed_llms_tpu_torch.checkpoint.quantize import quantize_tree
    from distributed_llms_tpu_torch.models import model as model_lib

    legs = [  # (decode kernel, cache, config overrides, weight bits)
        ("paged_decode_attention", "paged", {}, None),
        ("paged_decode_attention_int8", "int8", {}, None),
        ("ragged_decode_attention", "contiguous", {"sliding_window": 64},
         None),
        ("paged_decode_attention", "paged", {}, 8),
        ("paged_decode_attention", "paged", {}, 4),
        # attn_impl="flash": each admission prefills through K4.
        ("ragged_decode_attention", "contiguous", {"attn_impl": "flash"},
         None),
        ("ragged_decode_attention", "contiguous",
         {"attn_impl": "flash", "sliding_window": 64}, None),
    ]
    steps = 3
    for name, mode, overrides, bits in legs:
        cfg = _small_cfg(**overrides)
        params_cpu = model_lib.init_params(
            cfg, generator=torch.Generator(device="cpu").manual_seed(7),
            device="cpu")
        if bits:  # quantized blocks, as serve_quantized loads a store
            params_cpu["blocks"] = quantize_tree(params_cpu["blocks"],
                                                 bits=bits)
        gen = torch.Generator(device="cpu").manual_seed(11)
        lens = [97, 150] if overrides else [37, 50]
        toks = torch.randint(0, 512, (2, 200), generator=gen)
        logits = {}
        for dev in ("cpu", "cuda"):
            reset_launches()
            logits[dev] = _decode_logits(torch, cfg, params_cpu, dev, mode,
                                         lens, toks, steps)
        launched = read_launches()
        check(bool(torch.isfinite(logits["cuda"]).all()),
              f"model logits not finite ({name})")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        scale = logits["cpu"].abs().max().item()
        agree = (logits["cuda"].argmax(-1)
                 == logits["cpu"].argmax(-1)).float().mean().item()
        emit("model", kernel=name, cache=mode, attn_impl=cfg.attn_impl,
             window=cfg.sliding_window,
             weight_bits=bits, lengths=lens, decode_steps=steps,
             launches={k: v for k, v in launched.items() if v},
             max_abs_logit_err=err, logit_scale=scale, argmax_agree=agree)
        check(launched[name] == cfg.num_layers * steps,
              f"{name} launched {launched[name]} times for {steps} steps x "
              f"{cfg.num_layers} layers")
        if cfg.attn_impl == "flash":  # one K4 launch per layer per admission
            want = cfg.num_layers * len(lens)
            check(launched["flash_attention_dynamic"] == want,
                  f"K4 launched {launched['flash_attention_dynamic']} times, "
                  f"not {want}")
        if bits:
            # 7 projections per layer per forward: each row's admission
            # prefill and each decode step.
            want = 7 * cfg.num_layers * (steps + len(lens))
            qname = QMM_NAMES[bits]
            check(launched[qname] == want,
                  f"{qname} launched {launched[qname]} times, not {want}")
        # Tolerance: 5% of the logit scale — bf16 activations round
        # differently through cuBLAS and the CPU's matmuls, on top of the
        # kernels' own bf16-probability rounding.
        check(err <= 0.05 * max(scale, 1.0),
              f"model logits disagree ({name}: {err})")
    model_train_step(torch)


# A training step on the card (K3) against the CPU (plain versions), the
# small bf16 llama: relative loss error and the worst leaf's relative L2
# gradient error.  On the H100 the sound kernel reads at most 1.2e-4 and
# 0.013; K3 with a planted fault (a key off by one at the diagonal or the
# window edge, a skipped edge tile, a zeroed output) 1.8e-3..1.9e-2 and
# 0.18..10.5.  Attention moves the loss of a random-init model little, so
# the gradients are the sharper test.
TRAIN_LOSS_REL = 5e-4
TRAIN_GRAD_REL = 5e-2


def model_train_step(torch) -> None:
    """One training step's loss and gradients on the small bf16 llama with
    attn_impl="flash", without and with a sliding window shorter than the
    batch: on the card (K3 forward, dense-recompute backward) against the
    CPU (plain versions), same weights and batch."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import train

    toks = torch.randint(0, 512, (2, 200),
                         generator=torch.Generator().manual_seed(12))
    for window in (None, 64):
        cfg = _small_cfg(attn_impl="flash", sliding_window=window)
        params_cpu = model_lib.init_params(
            cfg, generator=torch.Generator(device="cpu").manual_seed(8),
            device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            params = _tree_to(params_cpu, torch.device(dev))
            leaves = train._leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            reset_launches()
            loss = train.lm_loss(params, cfg, toks.to(dev))
            grads = torch.autograd.grad(loss, leaves)
            out[dev] = (loss.item(), [g.float().cpu() for g in grads],
                        read_launches()["flash_attention_static"])
        (loss_c, grads_c, _), (loss_g, grads_g, launched) = (out["cpu"],
                                                            out["cuda"])
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        rel = max((gg - gc).norm().item() / max(gc.norm().item(), 1e-30)
                  for gg, gc in zip(grads_g, grads_c))
        emit("model", kernel="flash_attention_static", training_step=True,
             window=window, loss_cuda=loss_g, loss_cpu=loss_c,
             loss_rel_err=loss_rel, worst_grad_rel_err=rel,
             tol={"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL},
             launches={"flash_attention_static": launched})
        check(math.isfinite(loss_g), "training loss not finite")
        check(launched == cfg.num_layers, f"K3 launched {launched} times, "
              f"not {cfg.num_layers} (one per layer)")
        check(loss_rel <= TRAIN_LOSS_REL,
              f"training loss disagrees ({loss_g} vs {loss_c})")
        check(rel <= TRAIN_GRAD_REL,
              f"gradients disagree (worst relative error {rel})")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- phase 5: serving --------------------------------------------------------

async def _http(port: int, path: str, body: dict, stream: bool = False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
        f"\r\nContent-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if not stream:
        return status, json.loads(rest)
    events = [json.loads(line[6:]) for line in rest.decode().split("\n\n")
              if line.startswith("data: ") and line != "data: [DONE]"]
    return status, {"events": events, "done": b"data: [DONE]" in rest}


PATH_A_PREFIX = (
    "You are a careful assistant for a logistics company. Answer in one "
    "short paragraph, cite the relevant policy number, and never invent "
    "shipment identifiers. Policy 12 covers delayed freight; policy 19 "
    "covers damaged goods; policy 31 covers customs holds; policy 44 covers "
    "refused deliveries at the dock. ")


async def _serve_requests(port: int, greedy_new: int | None = None) -> dict:
    """Path a's seven requests; with ``greedy_new`` every one greedy with
    that many new tokens (path m's Mixtral)."""
    prefix = PATH_A_PREFIX
    # Byte tokenizer: one token per byte (+ BOS).
    check(len(prefix) >= 256, "shared prefix under 256 tokens")
    reqs = [
        ("/v1/completions", {"prompt": prefix + "Case A: a pallet arrived late.",
                             "max_tokens": 48, "temperature": 0.0,
                             "logprobs": True}, False),
        ("/v1/completions", {"prompt": prefix + "Case B: a crate is dented.",
                             "max_tokens": 48, "temperature": 0.0}, False),
        ("/v1/completions", {"prompt": prefix + "Case A: a pallet arrived late.",
                             "max_tokens": 48, "temperature": 0.0,
                             "logprobs": True}, False),
        ("/v1/chat/completions", {"messages": [
            {"role": "user", "content": "Summarise policy 12 in a line."}],
            "max_tokens": 40, "temperature": 0.8, "top_p": 0.9}, False),
        ("/v1/completions", {"prompt": "Streaming check: count to ten.",
                             "max_tokens": 40, "stream": True,
                             "logprobs": True}, True),
        ("/v1/completions", {"prompt": "Top-k sampling check.",
                             "max_tokens": 32, "temperature": 1.0,
                             "top_k": 40, "logprobs": True}, False),
        ("/v1/chat/completions", {"messages": [
            {"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Name three ports."}],
            "max_tokens": 24}, False),
    ]
    if greedy_new is not None:
        reqs = [(path, {**{k: v for k, v in body.items()
                           if k not in ("top_p", "top_k")},
                        "temperature": 0.0, "max_tokens": greedy_new}, stream)
                for path, body, stream in reqs]
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[
        _http(port, path, body, stream) for path, body, stream in reqs
    ])
    wall = time.perf_counter() - t0
    n_tokens = 0
    for (path, body, stream), (status, resp) in zip(reqs, outs):
        check(status == 200, f"{path} answered {status}: {resp}")
        want = body["max_tokens"]
        if stream:
            check(resp["done"], "SSE stream did not end with [DONE]")
            finals = [e["choices"][0] for e in resp["events"]
                      if e["choices"][0].get("finish_reason")]
            check(len(finals) == 1, "SSE stream has no single final chunk")
            got = sum(len(e["choices"][0]["logprobs"]["tokens"])
                      for e in resp["events"]
                      if e["choices"][0].get("logprobs"))
            reason = finals[0]["finish_reason"]
        else:
            got = resp["usage"]["completion_tokens"]
            reason = resp["choices"][0]["finish_reason"]
            lp = resp["choices"][0].get("logprobs")
            if lp:
                vals = lp["token_logprobs"]
                check(all(math.isfinite(x) and x <= 0 for x in vals),
                      "non-finite or positive logprob")
        check(got == want or reason == "stop",
              f"{path} produced {got}/{want} tokens (finish {reason})")
        n_tokens += got
    # Greedy agreement of the two identical prompts, one prefilled cold and
    # the other over the cached prefix pages (information, not a gate):
    # the leading run of positions whose token piece and logprob (within
    # 0.1, bf16 noise) agree, over the budget.  The API exposes decoded
    # pieces, not ids, and random weights mostly pick pieces that decode
    # to nothing, so the logprob carries the identity.
    la = outs[0][1]["choices"][0]["logprobs"]
    lc = outs[2][1]["choices"][0]["logprobs"]
    run = 0
    for pa, pc, va, vc in zip(la["tokens"], lc["tokens"], la["token_logprobs"],
                              lc["token_logprobs"]):
        if pa != pc or abs(va - vc) > 0.1:
            break
        run += 1
    agree = run / reqs[0][1]["max_tokens"]
    return {"requests": len(reqs), "completion_tokens": n_tokens,
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "cached_vs_cold_greedy_agreement": agree,
            "cached_tokens": [o[1].get("usage", {}).get(
                "prompt_tokens_details", {}).get("cached_tokens")
                for o in outs if "usage" in o[1]]}


async def _serve_window_requests(port: int) -> dict:
    """Path c's burst: one request whose 4400-byte prompt (4401 tokens
    with BOS) puts every decode step past Mistral-7B's 4096-slot window,
    beside three short concurrent requests, greedy and sampled."""
    long_prompt = ("Freight log, dock 7, one line per pallet: " + "".join(
        f"pallet {i:04d} checked in at bay {i % 13:02d}; " for i in range(200)
    ))[:4400]
    check(len(long_prompt) == 4400, "long prompt under 4400 bytes")
    reqs = [
        {"prompt": long_prompt, "max_tokens": 48, "temperature": 0.0,
         "logprobs": True},
        {"prompt": "Short check one: name a colour.", "max_tokens": 32,
         "temperature": 0.0},
        {"prompt": "Short check two: count to five.", "max_tokens": 32,
         "temperature": 0.8, "top_p": 0.9},
        {"prompt": "Short check three.", "max_tokens": 24, "top_k": 40,
         "temperature": 1.0},
    ]

    async def one(body):
        t0 = time.perf_counter()
        status, resp = await _http(port, "/v1/completions", body)
        return status, resp, time.perf_counter() - t0

    t0 = time.perf_counter()
    outs = await asyncio.gather(*[one(body) for body in reqs])
    wall = time.perf_counter() - t0
    n_tokens = 0
    for body, (status, resp, _) in zip(reqs, outs):
        check(status == 200, f"window request answered {status}: {resp}")
        got = resp["usage"]["completion_tokens"]
        reason = resp["choices"][0]["finish_reason"]
        check(got == body["max_tokens"] or reason == "stop",
              f"window request produced {got}/{body['max_tokens']} tokens")
        n_tokens += got
    long_usage = outs[0][1]["usage"]
    check(long_usage["prompt_tokens"] > WINDOW,
          "the long request does not decode past the window")
    lp = outs[0][1]["choices"][0]["logprobs"]["token_logprobs"]
    check(all(math.isfinite(x) and x <= 0 for x in lp),
          "non-finite or positive logprob")
    return {"requests": len(reqs), "completion_tokens": n_tokens,
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "request_wall_s": [o[2] for o in outs],
            "long_prompt_tokens": long_usage["prompt_tokens"],
            "long_completion_tokens": long_usage["completion_tokens"]}


async def _serve_flash_requests(port: int) -> dict:
    """Path f's burst: one greedy request whose 8000-byte prompt (8001
    tokens with BOS, an 8192-token admission past the 4096 window) beside
    three short concurrent requests."""
    long_prompt = ("Warehouse ledger, aisle by aisle: " + "".join(
        f"crate {i:05d} holds {i % 97:02d} units of part {i % 211:03d}; "
        for i in range(400)))[:FLASH_PROMPT_BYTES]
    check(len(long_prompt) == FLASH_PROMPT_BYTES,
          f"long prompt under {FLASH_PROMPT_BYTES} bytes")
    short = [
        {"prompt": "Short check one: name a colour.", "max_tokens": 32,
         "temperature": 0.0},
        {"prompt": "Short check two: count to five.", "max_tokens": 32,
         "temperature": 0.8, "top_p": 0.9},
        {"prompt": "Short check three.", "max_tokens": 24, "top_k": 40,
         "temperature": 1.0},
    ]
    t0 = time.perf_counter()
    (status, long_resp), *outs = await asyncio.gather(*[
        _http(port, "/v1/completions", body) for body in
        [{"prompt": long_prompt, "max_tokens": 32, "temperature": 0.0,
          "logprobs": True}, *short]])
    wall = time.perf_counter() - t0
    check(status == 200, f"long request answered {status}: {long_resp}")
    n_tokens = long_resp["usage"]["completion_tokens"]
    check(n_tokens == 32, f"long request produced {n_tokens}/32 tokens")
    check(long_resp["usage"]["prompt_tokens"] > WINDOW,
          "the long request does not prefill past the window")
    lps = long_resp["choices"][0]["logprobs"]["token_logprobs"]
    check(all(math.isfinite(x) and x <= 0 for x in lps),
          "non-finite or positive logprob")
    for body, (status, resp) in zip(short, outs):
        check(status == 200, f"short request answered {status}: {resp}")
        n = resp["usage"]["completion_tokens"]
        check(n == body["max_tokens"]
              or resp["choices"][0]["finish_reason"] == "stop",
              f"short request produced {n}/{body['max_tokens']} tokens")
        n_tokens += n
    return {"requests": 1 + len(short), "admissions": 1 + len(short),
            "completion_tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "long_prompt_tokens": long_resp["usage"]["prompt_tokens"]}


def _free(torch) -> None:
    """Return the device memory of a dropped engine before the next boots."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def serve_path(torch, label, argv, kernels, requests, check_cfg,
               setup=None, **info) -> tuple:
    """Boot ``dlt-serve-torch argv`` in-process through the user's entry
    point, answer ``requests(port)`` over HTTP, and hold the path to its
    kernels: every count 0 just before, read just after, each of the
    path's ``kernels`` ({name: launches per layer per decode step}) at
    least that many times layers x decode steps.  ``setup(server)`` runs
    between the boot and the first request.  Returns (launches, server,
    {"resident_gb": device memory the booted engine holds, "peak_mem_gb":
    peak over boot and serving})."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.observability import METRICS

    args = serve_main.parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = serve_main.build_server(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    mem = {"resident_gb": (torch.cuda.memory_allocated() - before) / 1e9}
    cfg = server.batcher.cfg
    check_cfg(cfg)
    if setup is not None:
        setup(server)

    async def run():
        await server.start()
        try:
            return await requests(server.bound_port)
        finally:
            await server.stop()

    reset_launches()
    result = asyncio.run(run())
    launches = read_launches()
    b = server.batcher
    steps = b.decode_steps
    b.assert_pool_consistent()
    extra = {}
    if b.prefix_cache is not None:
        extra = {"prefix_cache_hits": b.prefix_cache.hits,
                 "prefix_hit_tokens": b.prefix_cache.hit_tokens}
    ttft = METRICS.snapshot()["histograms"].get("server.ttft_seconds", {})
    mem["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit("serve", path=label, argv=argv, boot_s=boot_s, decode_steps=steps,
         launches=launches, kv_bits=b.kv_bits, paged=b.paged,
         sliding_window=cfg.sliding_window, max_len=b.s,
         num_layers=cfg.num_layers,
         ttft_s_cumulative={k: ttft.get(k) for k in ("p50", "max", "count")},
         **mem, **info, **extra, **result)
    check(steps > 0, f"{label}: no decode step ran")
    for kernel, per_step in kernels.items():
        want = per_step * cfg.num_layers * steps
        check(launches[kernel] >= want,
              f"{label}: {kernel} launched {launches[kernel]} times, under "
              f"{per_step} x {steps} decode steps x {cfg.num_layers} layers")
    return launches, server, mem


def _llama_3_8b(cfg) -> None:
    check(cfg.hidden_size == 4096 and cfg.num_layers == 32
          and cfg.vocab_size == 128256, "not the full-width llama-3-8b")


def _llama_3_8b_cut(cfg) -> None:
    check(cfg.hidden_size == 4096 and cfg.num_layers == STORE_LAYERS
          and cfg.vocab_size == 128256,
          f"not llama-3-8b's width at {STORE_LAYERS} layers")


def _mistral_7b(cfg) -> None:
    check(cfg.hidden_size == 4096 and cfg.num_layers == 32
          and cfg.num_kv_heads == 8 and cfg.vocab_size == 32000
          and cfg.sliding_window == WINDOW, "not the full-width mistral-7b")


def _mistral_7b_flash(cfg) -> None:
    _mistral_7b(cfg)
    check(cfg.attn_impl == "flash", "the store's model is not flash")


def serve_flash(torch, profile: bool) -> dict:
    """Path f: write the flash-config Mistral-7B store into a temporary
    directory, serve it at 32768 slots, remove it.  Returns the launches
    of K4 and of its pre-pass on the path."""
    tmp = tempfile.mkdtemp(prefix="dlt_store_flash_")
    try:
        info = write_store(torch, "int8", tmp, "mistral-7b",
                           attn_impl="flash")
        launches, server, _ = serve_path(
            torch, "flash_prefill", ["--store", tmp, *SERVE_FLASH_ARGS],
            {"ragged_decode_attention": 1}, _serve_flash_requests,
            _mistral_7b_flash, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = server.batcher
    check(not b.paged and b.s == FLASH_MAX_LEN,
          f"flash_prefill: not contiguous at {FLASH_MAX_LEN} slots")
    admissions = 4  # every admission is multi-token (a bucket of >= 16)
    want = b.cfg.num_layers * admissions
    check(launches["flash_attention_dynamic"] >= want,
          f"flash_prefill: K4 launched {launches['flash_attention_dynamic']}"
          f" times, under {want} (32 layers x {admissions} admissions)")
    check(launches["flash_tile_summary"] ==
          launches["flash_attention_dynamic"],
          f"flash_prefill: K4's pre-pass launched "
          f"{launches['flash_tile_summary']} times, not once per K4 launch")
    flash_admission(torch, b, profile)
    del server, b
    _free(torch)
    return {name: launches[name]
            for name in ("flash_attention_dynamic", "flash_tile_summary")}


def write_store(torch, quantization: str, out_dir: str,
                preset: str = "llama-3-8b", **overrides) -> dict:
    """A store of ``preset`` (random weights drawn on the card from seed
    0; ``overrides`` land in its model config) written by the port's
    ``save_shards``: 2 raw shards, quantized leaf by leaf on the card.
    Returns what it cost."""
    from distributed_llms_tpu_torch.checkpoint.store import save_shards
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset

    cfg = get_preset(preset, **overrides)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    t0 = time.perf_counter()
    save_shards(params, out_dir, num_shards=2, model_config=cfg,
                quantization=quantization, storage="raw")
    write_s = time.perf_counter() - t0
    del params
    _free(torch)
    disk = sum(p.stat().st_size for p in Path(out_dir).iterdir())
    return {"store": quantization, "store_preset": preset,
            "store_bytes": disk, "store_write_s": write_s}


def serve_store(torch, label, quantization, bits, **info) -> tuple:
    """Path d or e: write the store into a temporary directory, serve it
    quantized, remove it.  Returns (launches, server, memory as
    :func:`serve_path`, with "saved_gb": the bytes its quantized block
    weights save over bf16)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor

    tmp = tempfile.mkdtemp(prefix=f"dlt_store_{quantization}_")
    try:
        info.update(write_store(torch, quantization, tmp,
                                num_layers=STORE_LAYERS))
        launches, server, mem = serve_path(
            torch, label, ["--store", tmp, *SERVE_STORE_ARGS],
            {QMM_NAMES[bits]: 7, "paged_decode_attention": 1},
            _serve_requests, _llama_3_8b_cut, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(server.batcher.prefix_cache.hits > 0, f"{label}: no prefix-cache hit")
    saved = 0
    for group in server.batcher.params["blocks"].values():
        for name, leaf in group.items():
            check(isinstance(leaf, QuantizedTensor) or name == "scale",
                  f"{label}: block weight {name} is not quantized")
            if isinstance(leaf, QuantizedTensor):
                saved += (2 * math.prod(leaf.unpacked_shape)
                          - leaf.data.nbytes - leaf.scale.nbytes)
    mem["saved_gb"] = saved / 1e9
    emit("serve_memory", path=label, **mem)
    return launches, server, mem


def _check_resident(label, mem, mem_a) -> None:
    """A quantized path holds less device memory than path a's engine at
    the store's depth (path a's resident bytes less its block weights and
    pool pages of the layers the store lacks), by most of what its block
    weights save (the rest of both engines is alike)."""
    bf16 = mem_a["resident_gb"] - (
        (mem_a["num_layers"] - STORE_LAYERS) * mem_a["layer_gb"])
    gained = bf16 - mem["resident_gb"]
    check(gained >= 0.9 * mem["saved_gb"],
          f"{label} holds {mem['resident_gb']:.3f} GB once booted, only "
          f"{gained:.3f} GB below the bf16 path's {bf16:.3f} GB at "
          f"{STORE_LAYERS} layers; its quantized blocks should save "
          f"{mem['saved_gb']:.3f} GB")


def phase_serve(torch, profile: bool) -> dict:
    """The serving paths, one engine at a time.  Returns each kernel's
    launches on its own path."""
    lap = _lap("serve_time")
    launches, server, mem_a = serve_path(
        torch, "paged", SERVE_ARGS, {"paged_decode_attention": 1},
        _serve_requests, _llama_3_8b)
    check(server.batcher.prefix_cache.hits > 0, "paged: no prefix-cache hit")
    out = {"paged_decode_attention": launches["paged_decode_attention"]}
    b = server.batcher
    mem_a["num_layers"] = b.cfg.num_layers
    mem_a["layer_gb"] = (sum(t.nbytes for g in b.params["blocks"].values()
                             for t in g.values())
                         + b.cache.k.nbytes + b.cache.v.nbytes
                         ) / b.cfg.num_layers / 1e9
    del b
    loop_variants(torch, "paged", server.batcher, profile)
    del server
    _free(torch)
    lap("a")

    launches, server, _ = serve_path(
        torch, "paged_int8", SERVE_INT8_ARGS,
        {"paged_decode_attention_int8": 1}, _serve_requests, _llama_3_8b)
    check(server.batcher.kv_bits == 8, "paged_int8: the pool is not int8")
    check(server.batcher.prefix_cache.hits > 0,
          "paged_int8: no prefix-cache hit")
    out["paged_decode_attention_int8"] = launches["paged_decode_attention_int8"]
    del server
    _free(torch)
    lap("b")

    launches, server, _ = serve_path(
        torch, "windowed", SERVE_WINDOW_ARGS, {"ragged_decode_attention": 1},
        _serve_window_requests, _mistral_7b)
    check(not server.batcher.paged, "windowed: not contiguous mode")
    out["ragged_decode_attention"] = launches["ragged_decode_attention"]
    del server
    _free(torch)
    lap("c")

    launches, server, mem = serve_store(
        torch, "store_int8", "int8", 8, path_a_mem_gb=mem_a)
    _check_resident("store_int8", mem, mem_a)
    check(mem["peak_mem_gb"] < mem_a["peak_mem_gb"],
          f"store_int8 peaked at {mem['peak_mem_gb']:.2f} GB, not below the "
          f"bf16 path's {mem_a['peak_mem_gb']:.2f} GB")
    out["quant_matmul"] = launches["quant_matmul"]
    loop_variants(torch, "store_int8", server.batcher, profile)
    del server
    _free(torch)
    lap("d")

    launches, server, mem = serve_store(
        torch, "store_int4", "int4", 4, path_a_mem_gb=mem_a)
    _check_resident("store_int4", mem, mem_a)
    out["quant_matmul_int4"] = launches["quant_matmul_int4"]
    del server
    _free(torch)
    lap("e")

    out.update(serve_flash(torch, profile))
    lap("f")
    # Path h runs K2 too; path c's count stays the line's (its own path).
    serve_long(torch)
    lap("h")
    return out


# -- phase 6: path g, the training step ---------------------------------------

TRAIN_LAYERS = 8  # Llama-3-8B's width; AdamW state for 32 layers won't fit


def phase_train(torch, profile: bool) -> int:
    """Path g: three AdamW steps of ``runtime.train.Trainer`` on one fixed
    batch through K3, then one with ``remat=True``.  Returns K3's launches
    over the three steps."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import train

    cfg = get_preset("llama-3-8b", attn_impl="flash", num_layers=TRAIN_LAYERS)
    check(cfg.hidden_size == 4096 and cfg.num_heads == 32
          and cfg.num_kv_heads == 8 and cfg.intermediate_size == 14336
          and cfg.vocab_size == 128256, "not Llama-3-8B's width")
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    n_params = sum(p.numel() for p in train._leaves(params))
    batch = torch.randint(0, cfg.vocab_size, (2, TRAIN_T + 1), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    trainer = train.Trainer(cfg, train.default_optimizer(1e-3))
    state = trainer.init(params)
    step = trainer.make_step()
    losses, times = [], []
    reset_launches()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, None)
        losses.append(float(loss))  # synchronises
        times.append(time.perf_counter() - t0)
    launched = read_launches()["flash_attention_static"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = batch.shape[0] * TRAIN_T
    # One step more with every block rematerialised in the backward.
    remat_step = train.Trainer(cfg, trainer.optimizer, remat=True).make_step()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, loss = remat_step(params, state, batch, None)
    remat_loss = float(loss)
    remat_s = time.perf_counter() - t0
    remat_launched = read_launches()["flash_attention_static"]
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    emit("train", config="llama-3-8b", num_layers=cfg.num_layers,
         params=n_params, batch=list(batch.shape), attn_impl=cfg.attn_impl,
         losses=losses, step_s=times, tokens_per_s=[tokens / t for t in times],
         peak_mem_gb=peak, launches={"flash_attention_static": launched},
         remat_loss=remat_loss, remat_step_s=remat_s,
         remat_peak_mem_gb=remat_peak,
         remat_launches={"flash_attention_static": remat_launched})
    check(all(math.isfinite(x) for x in losses + [remat_loss]),
          f"training loss not finite: {losses + [remat_loss]}")
    check(losses[0] > losses[1] > losses[2],
          f"training loss does not fall: {losses}")
    check(launched == 3 * cfg.num_layers,
          f"K3 launched {launched} times in 3 steps, not {3 * cfg.num_layers}")
    check(remat_launched == 2 * cfg.num_layers,
          f"K3 launched {remat_launched} times in a remat step, not "
          f"{2 * cfg.num_layers} (forward + recompute)")
    if profile:
        split, wall = _profiled(
            torch, lambda: step(params, state, batch, None))
        busy = sum(split.values())
        emit("profile", path="train", step_wall_ms=wall,
             device_kernel_ms=split,
             flash_share_of_device=split["flash_kernel"] / busy if busy else
             "not measured",
             decode_attention_share_of_device=(
                 split["decode_attention_kernel"] / busy if busy else
                 "not measured"),
             device_busy_share=busy / wall if busy else "not measured")
    del params, state, batch
    _free(torch)
    return launched


# -- phase 7: where a full-width batch's time goes ---------------------------

LOOP_PROMPT_TOKENS = 300
LOOP_NEW_TOKENS = 64
LOOP_TIMED_RUNS = 1  # one timed run after the capturing one (a median of
# three cost two more runs of every loop on paths a, d and i)
# The engine loops a served batcher is driven through: (name, overlap,
# eager).  "eager_sync" is the loop of the port before the chunk graphs:
# every kernel of a decode chunk launched from Python, one host round trip
# per chunk.  It is reached through the batcher module's own eager chunk
# (``_decode_steps``); nothing a user sets selects it.
LOOPS = (("graph_overlap", True, False), ("graph_sync", False, False),
         ("eager_sync", False, True))


def _eager_decode_chunk(*args, graphs=None, eager=None, **kw):
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    return batcher_lib._decode_steps(*args, **kw)


def _run_batch(torch, b, prompts, penalties=None,
               new=LOOP_NEW_TOKENS) -> tuple:
    """Run ``prompts`` (greedy, ``new`` tokens each; the first with
    ``penalties``) to the end on batcher ``b``: (streams, wall seconds,
    decode steps, overlap counters)."""
    steps0 = b.decode_steps
    stats0 = dict(b.overlap_stats)
    # Cold admissions every run: a prefix-cache hit prefills only the
    # suffix, whose bf16 rounding differs from the cold prefill's.
    rids = [b.submit(p, max_new_tokens=new, prefix_cache=False,
                     **(penalties if penalties and j == 0 else {}))
            for j, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: v - stats0[k] for k, v in b.overlap_stats.items()}
    return [res[r] for r in rids], wall, b.decode_steps - steps0, stats


def loop_variants(torch, label, batcher, profile: bool, penalties=None,
                  timed_runs=LOOP_TIMED_RUNS) -> None:
    """Paths a, d and i: a fresh batcher over the served weights (and with
    the served batcher's options) runs 8 greedy requests (300-token
    prompts, 64 new tokens; on path i the first penalized) under each of
    LOOPS — once to capture the chunk graphs, then ``timed_runs`` times
    timed (the median kept; with none, the capturing run's wall) — and
    every run's token streams must be identical across runs and loops.
    With
    ``profile``, the eager synchronous loop and the default (graphs and
    overlap) run once more under the profiler: device kernel time by
    class and the device's busy share.  Each loop's line gives ms per
    decode step, chunks dispatched ahead, carry syncs and the mean device
    gap."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (LOOP_PROMPT_TOKENS,),
                             generator=g).tolist() for _ in range(batcher.b)]
    graph_chunk = batcher_lib.decode_chunk
    streams = {}
    for name, overlap, eager in LOOPS:
        b = batcher_lib.ContinuousBatcher(
            **{**batcher._ctor_args, "overlap": overlap})
        if eager:
            batcher_lib.decode_chunk = _eager_decode_chunk
        try:
            got, wall, steps, stats = _run_batch(torch, b, prompts,
                                                 penalties)
            first = got
            walls = []
            for _ in range(timed_runs):
                got, wall, steps, stats = _run_batch(torch, b, prompts,
                                                     penalties)
                check(got == first,
                      f"{label}/{name}: a second run gave other tokens")
                walls.append(wall)
            # timed_runs=0: the one run's wall, its graph captures included.
            wall = sorted(walls)[len(walls) // 2] if walls else wall
            line = {}
            if profile and name != "graph_sync":
                split, prof_wall = _profiled(
                    torch, lambda: _run_batch(torch, b, prompts, penalties))
                busy = sum(split.values())
                line = {"profiled_wall_ms": prof_wall,
                        "device_kernel_ms": split,
                        "device_busy_share": (busy / prof_wall if busy
                                              else "not measured")}
        finally:
            batcher_lib.decode_chunk = graph_chunk
        streams[name] = got
        gaps = stats["gap_samples"]
        emit("profile", path=label, loop=name, requests=len(prompts),
             penalties=penalties,
             prompt_tokens=LOOP_PROMPT_TOKENS, new_tokens=LOOP_NEW_TOKENS,
             decode_steps=steps, wall_ms=wall * 1e3,
             wall_ms_runs=[w * 1e3 for w in walls],
             wall_ms_per_decode_step=wall * 1e3 / max(steps, 1),
             chunks=stats["chunks"],
             dispatched_ahead=stats["dispatched_ahead"],
             carry_syncs=stats["carry_syncs"],
             mean_device_gap_ms=(stats["device_gap_s"] * 1e3 / gaps if gaps
                                 else "not measured"),
             host_lag_ms=stats["host_lag_s"] * 1e3,
             graph_captures=b._graphs.captures,
             graph_replays=b._graphs.replays, **line)
        check(all(len(t) == LOOP_NEW_TOKENS for t in got),
              f"{label}/{name}: a request ended early")
        if overlap:
            check(stats["dispatched_ahead"] > 0,
                  f"{label}/{name}: no chunk was dispatched ahead")
        check((b._graphs.replays > 0) != eager,
              f"{label}/{name}: graph replays {b._graphs.replays}")
        del b
        _free(torch)
    check(streams["graph_overlap"] == streams["graph_sync"]
          == streams["eager_sync"],
          f"{label}: temperature-0 streams differ between the engine loops")


# -- path h: long context through chunked dense prefill ----------------------

def _long_prompt() -> str:
    text = "Shipping manifest, container by container: " + "".join(
        f"container {i:05d} sealed at gate {i % 17:02d} with {i % 89:02d} "
        f"crates; " for i in range(600))
    check(len(text) >= LONG_PROMPT_BYTES, "long prompt under 30000 bytes")
    return text[:LONG_PROMPT_BYTES]


SHORT_PROMPTS = ("Short stream one: list the days of the week.",
                 "Short stream two: name the planets in order.",
                 "Short stream three: count from one to twenty.")


async def _serve_long_requests(port: int) -> dict:
    """Path h's burst over HTTP: three short greedy SSE streams start
    decoding, then a 30000-byte prompt (30001 tokens with BOS, past path
    c's 6144-slot cut) arrives and admits in 1024-token bites."""
    shorts = [asyncio.create_task(_http(port, "/v1/completions", {
        "prompt": p, "max_tokens": SHORT_NEW, "temperature": 0.0,
        "stream": True, "logprobs": True}, stream=True))
        for p in SHORT_PROMPTS]
    await asyncio.sleep(2.0)  # the shorts are admitted and decoding
    t0 = time.perf_counter()
    status, resp = await _http(port, "/v1/completions", {
        "prompt": _long_prompt(), "max_tokens": 16, "temperature": 0.0,
        "logprobs": True})
    long_s = time.perf_counter() - t0
    outs = await asyncio.gather(*shorts)
    check(status == 200, f"long request answered {status}: {resp}")
    usage = resp["usage"]
    check(usage["prompt_tokens"] == LONG_PROMPT_BYTES + 1,
          f"long prompt of {usage['prompt_tokens']} tokens")
    check(usage["completion_tokens"] == 16
          or resp["choices"][0]["finish_reason"] == "stop",
          f"long request produced {usage['completion_tokens']}/16 tokens")
    lps = resp["choices"][0]["logprobs"]["token_logprobs"]
    check(all(math.isfinite(x) and x <= 0 for x in lps),
          "non-finite or positive logprob")
    n_tokens = usage["completion_tokens"]
    for status, out in outs:
        check(status == 200 and out["done"], "a short stream did not end")
        finals = [e["choices"][0] for e in out["events"]
                  if e["choices"][0].get("finish_reason")]
        check(len(finals) == 1, "a short stream has no single final chunk")
        got = sum(len(e["choices"][0]["logprobs"]["tokens"])
                  for e in out["events"] if e["choices"][0].get("logprobs"))
        check(got == SHORT_NEW or finals[0]["finish_reason"] == "stop",
              f"a short stream produced {got}/{SHORT_NEW} tokens")
        n_tokens += got
    return {"requests": 1 + len(outs), "completion_tokens": n_tokens,
            "long_prompt_tokens": usage["prompt_tokens"],
            "long_request_s": long_s}


def long_context_run(torch, batcher, label) -> dict:
    """Path h's traffic outside HTTP, timed engine-side: the three short
    greedy streams admit, and once each has 16 tokens the long prompt is
    submitted from the delivery callback.  Returns the streams (rid order:
    the three shorts, then the long one) and emits the long prompt's time
    to first token and the short streams' delivery gaps before and while
    it admits."""
    tok = batcher.tokenizer
    # Warm-up: the decode chunk's graph is captured before the timed run.
    batcher.submit(tok.encode(SHORT_PROMPTS[0]), max_new_tokens=16)
    batcher.run()
    deliveries: dict = {}
    streams: dict = {}
    long = []
    shorts = [batcher.submit(tok.encode(p), max_new_tokens=SHORT_NEW)
              for p in SHORT_PROMPTS]

    def on_tokens(rid, toks, done, lps):
        now = time.perf_counter()
        if toks:
            deliveries.setdefault(rid, []).append(now)
        streams.setdefault(rid, []).extend(toks)
        if not long and all(len(streams.get(r, [])) >= 16 for r in shorts):
            long.append((batcher.submit(tok.encode(_long_prompt()),
                                        max_new_tokens=16),
                         time.perf_counter()))

    # Host time inside each fused dispatch (the bite's eager launches) and
    # each chunk fetch (the wait for the device): where the host spends a
    # step while a prompt admits.
    host = {"_dispatch_mixed": [], "_fetch_chunk": []}

    def timed(name):
        fn = getattr(batcher, name)

        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name].append(time.perf_counter() - t)
        return run

    for name in host:
        setattr(batcher, name, timed(name))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = batcher.run(on_tokens=on_tokens)
    finally:
        for name in host:
            delattr(batcher, name)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(long), f"{label}: the long prompt was never submitted")
    long_rid, t_sub = long[0]
    first = deliveries[long_rid][0]
    before, during, at = [], [], []
    for r in shorts:
        times = deliveries[r]
        for a, b in zip(times, times[1:]):
            if b <= t_sub:
                before.append(b - a)
            elif a < first:
                during.append(b - a)
                at.append(b - t_sub)
    check(bool(during), f"{label}: no short stream decoded while the long "
          "prompt admitted")
    out = [res[r] for r in shorts] + [res[long_rid]]
    check(all(len(t) == SHORT_NEW for t in out[:3]) and len(out[3]) == 16,
          f"{label}: a request ended early")
    emit("serve_long", path=label, schedule=batcher.sched.name,
         prompt_tokens=LONG_PROMPT_BYTES + 1, prefill_chunk=PREFILL_CHUNK,
         short_new_tokens=SHORT_NEW, ttft_s=first - t_sub, wall_s=wall,
         short_gap_ms_before={"median": 1e3 * sorted(before)[len(before) // 2]
                              if before else "not measured",
                              "max": 1e3 * max(before) if before else
                              "not measured"},
         short_gap_ms_while_admitting={
             "median": 1e3 * sorted(during)[len(during) // 2],
             "max": 1e3 * max(during), "deliveries": len(during),
             "max_ends_s_after_arrival": at[during.index(max(during))]},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         host_ms={name: {"calls": len(v), "first": 1e3 * v[0],
                         "median": 1e3 * sorted(v)[len(v) // 2],
                         "max": 1e3 * max(v)} if v else "none"
                  for name, v in host.items()},
         dispatched_ahead=batcher.overlap_stats["dispatched_ahead"],
         carry_syncs=batcher.overlap_stats["carry_syncs"])
    return out


def serve_long(torch) -> int:
    """Path h: ``dlt-serve-torch --store DL --max-len 32768 --slots 4
    --prefill-chunk 1024`` over a bf16 store DL of Mistral-7B's width at
    LONG_LAYERS layers, written into a temporary directory and removed
    after both boots (contiguous, dense ``attn_impl="dot"``,
    window 4096, the mixed schedule) answers the HTTP burst, then runs the
    engine-side traffic; then the same server with ``--schedule
    alternate`` runs the engine-side traffic too.  The short greedy
    streams must be identical under the two schedules.  Returns K2's
    launches on the HTTP burst."""
    from distributed_llms_tpu_torch.cli import serve_main

    tmp = tempfile.mkdtemp(prefix="dlt_store_long_")
    try:
        info = write_store(torch, None, tmp, "mistral-7b",
                           num_layers=LONG_LAYERS)
        args = ["--store", tmp, *SERVE_LONG_ARGS[2:]]
        mixed, alternate, launches = _serve_long_store(torch, serve_main,
                                                       args, info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("serve_long_streams", short_streams_identical=mixed[:3] ==
         alternate[:3], long_stream_identical=mixed[3] == alternate[3])
    check(mixed[:3] == alternate[:3],
          "long_context: the short greedy streams differ between the mixed "
          "and alternate schedules")
    return launches["ragged_decode_attention"]


def _mistral_7b_cut(cfg) -> None:
    check(cfg.hidden_size == 4096 and cfg.num_layers == LONG_LAYERS
          and cfg.num_kv_heads == 8 and cfg.vocab_size == 32000
          and cfg.sliding_window == WINDOW,
          f"not mistral-7b's width at {LONG_LAYERS} layers")


def _serve_long_store(torch, serve_main, args, info) -> tuple:
    """Path h's two boots over the cut store: (mixed streams, alternate
    streams, the HTTP burst's launches)."""
    launches, server, _ = serve_path(
        torch, "long_context", args, {"ragged_decode_attention": 1},
        _serve_long_requests, _mistral_7b_cut, **info)
    b = server.batcher
    check(not b.paged and b.s == LONG_MAX_LEN and b.cfg.attn_impl == "dot"
          and b.sched.name == "mixed" and b.overlap,
          "long_context: not contiguous dense mixed at 32768 slots")
    mixed = long_context_run(torch, b, "long_context")
    del server, b
    _free(torch)
    alt_server = serve_main.build_server(serve_main.parser().parse_args(
        args + ["--schedule", "alternate"]))
    check(alt_server.batcher.sched.name == "alternate",
          "long_context: --schedule alternate not taken")
    alternate = long_context_run(torch, alt_server.batcher,
                                 "long_context_alternate")
    del alt_server
    _free(torch)
    return mixed, alternate, launches


# -- path i: the host tier, penalties and named prefixes ----------------------

# Path i: Llama-3-8B's width at STORE_LAYERS layers (a bf16 store) over a
# pool too small for its traffic (39 usable pages of 2 MiB: 8 layers x 64
# slots x 8 KV heads x 128 x bf16, K and V), with 128 pages of pinned host
# RAM behind it.
TIER_ARGS = ["--paged-pages", "40", "--page-size", "64", "--prefix-cache",
             "--host-pages", "128", "--max-len", "1024", *_COMMON_ARGS]
TIER_NEW = 192
TIER_PENALTIES = {"presence_penalty": 0.6, "frequency_penalty": 0.4}
# 4 full pages of 64 tokens with the BOS: the shared run of every request
# that starts with it, and the named prefix "sys".
TIER_PREFIX = ("You are a careful assistant for a logistics company. Answer "
               "in one short paragraph, cite the relevant policy number, and "
               "never invent shipment identifiers. Policy 12 covers delayed "
               "freight; policy 19 covers damaged goods; policy 31 covers "
               "customs holds; po")
PARCEL_PAGES = 9  # a row of path i at its full depth (576 slots)


def _tier_text(tag: str, n: int) -> str:
    """``n`` bytes of distinct filler for request ``tag``."""
    text = "".join(f"{tag} item {i:03d} waits at bay {i % 11:02d}; "
                   for i in range(40))
    return text[:n]


def tier_requests() -> list:
    """Path i's traffic in submission order: three requests over the
    shared prefix (300-400 bytes), four more of the same lengths without it
    (the second one penalized), one naming the prefix "sys", and, after
    that wave, one more over the shared prefix (the spill hit).  The four
    and the named one come at priority 1: once the pool is dry their
    admissions preempt the first three (an admission preempts only
    strictly lower priority), so the wave swaps rows out by design, not
    by the timing of growth."""
    check(len(TIER_PREFIX) == 256, "path i's prefix is not 256 bytes")
    shared = [TIER_PREFIX + _tier_text(f"case {c}", n)
              for c, n in (("A", 130), ("B", 136), ("C", 144))]
    pressure = [_tier_text(f"load {c}", n)
                for c, n in (("D", 384), ("E", 392), ("F", 400), ("G", 388))]
    reqs = [{"prompt": p, "max_tokens": TIER_NEW, "temperature": 0.0}
            for p in shared + pressure]
    reqs[4].update(TIER_PENALTIES)
    reqs.append({"prompt": _tier_text("named H", 90), "prefix": "sys",
                 "max_tokens": TIER_NEW, "temperature": 0.0})
    for r in reqs[3:]:
        r["priority"] = 1
    reqs.append({"prompt": TIER_PREFIX + _tier_text("case S", 120),
                 "max_tokens": TIER_NEW, "temperature": 0.0})
    return reqs


async def _sse(port: int, body: dict) -> tuple:
    """One streamed completion: (status, seconds to the first event, wall
    seconds).  An event carries text, so the first comes with the first
    token that decodes to some."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps({**body, "stream": True}).encode()
    t0 = time.perf_counter()
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
        f"application/json\r\nContent-Length: {len(payload)}\r\n\r\n"
        .encode() + payload)
    await writer.drain()
    raw, first = b"", None
    while True:
        got = await reader.read(1 << 16)
        if not got:
            break
        raw += got
        if first is None and b"data: " in raw:
            first = time.perf_counter() - t0
    writer.close()
    status = int(raw.split(b"\r\n", 1)[0].split()[1])
    check(status == 200 and b"data: [DONE]" in raw,
          f"a streamed request answered {status}: {raw[-300:]!r}")
    return status, first, time.perf_counter() - t0


def _record_streams(b) -> tuple:
    """Wrap the served batcher so every delivered token id is kept per
    request, {(prompt ids, prefix): ids}, and each request's time from its
    submit to its first token, engine-side (the SSE stream shows a token
    only once it decodes to text, which random weights rarely pick)."""
    rid_of, ids, t_submit, ttft = {}, {}, {}, {}
    submit, run = b.submit, b.run

    def submit_rec(prompt, *a, prefix=None, **kw):
        t0 = time.perf_counter()
        rid = submit(prompt, *a, prefix=prefix, **kw)
        rid_of[rid] = (tuple(prompt), prefix)
        t_submit[rid] = t0
        return rid

    def run_rec(on_tokens=None):
        def rec(rid, toks, done, lps):
            if toks and rid not in ttft:
                ttft[rid] = time.perf_counter() - t_submit[rid]
            ids.setdefault(rid_of[rid], []).extend(toks)
            return on_tokens(rid, toks, done, lps)

        return run(on_tokens=rec)

    b.submit, b.run = submit_rec, run_rec
    return ids, ttft


def _tier_key(b, body) -> tuple:
    return (tuple(b.tokenizer.encode(body["prompt"])), body.get("prefix"))


async def _serve_tier_requests(server, reqs) -> dict:
    """Path i over HTTP, every request streamed: the first shared-prefix
    request alone until it is admitted (its cold prefill publishes the
    prefix's pages), then the rest of the wave at once, then the spill
    hit."""
    from distributed_llms_tpu_torch.core.observability import METRICS

    port = server.bound_port
    admitted = METRICS.get_counter("batcher.admitted")
    t0 = time.perf_counter()
    first = asyncio.create_task(_sse(port, reqs[0]))
    while METRICS.get_counter("batcher.admitted") == admitted:
        await asyncio.sleep(0.005)
    outs = await asyncio.gather(first, *[_sse(port, r) for r in reqs[1:-1]])
    outs.append(await _sse(port, reqs[-1]))
    wall = time.perf_counter() - t0
    return {"requests": len(reqs), "wall_s": wall,
            "first_text_event_s": [o[1] for o in outs],
            "request_wall_s": [o[2] for o in outs]}


def _tier_engine_run(torch, b, reqs, extra=()) -> tuple:
    """``reqs`` submitted engine-side to batcher ``b`` as the HTTP run
    submits them: the first alone, the rest of the wave (and ``extra``)
    once the first has its admission token, the last once the wave is
    done.  Returns (streams in ``reqs + extra`` order, wall seconds,
    decode steps)."""
    if "sys" not in b.prefixes:
        b.register_prefix("sys", TIER_PREFIX)

    def submit(r):
        return b.submit(r["prompt"], max_new_tokens=r["max_tokens"],
                        prefix=r.get("prefix"),
                        presence_penalty=r.get("presence_penalty", 0.0),
                        frequency_penalty=r.get("frequency_penalty", 0.0),
                        priority=r.get("priority", 0))

    rids = [submit(reqs[0])]
    wave: set = set()
    streams: dict = {}

    def on_tokens(rid, toks, done, lps):
        streams.setdefault(rid, []).extend(toks)
        if rid == rids[0] and len(rids) == 1:
            rids.extend(submit(r) for r in [*reqs[1:-1], *extra])
            wave.update(rids)
        if done:
            wave.discard(rid)
            if not wave and len(rids) == len(reqs) + len(extra) - 1:
                rids.insert(len(reqs) - 1, submit(reqs[-1]))

    steps0 = b.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.run(on_tokens=on_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b.assert_pool_consistent()
    check(len(rids) == len(reqs) + len(extra), "path i: a request was "
          "never submitted engine-side")
    return [streams[r] for r in rids], wall, b.decode_steps - steps0


_TIER_COUNTERS = ("batcher.kv_swaps.out", "batcher.kv_swaps.in",
                  "batcher.kv_swaps.fallback",
                  "batcher.host_tier.spilled_pages",
                  "batcher.host_tier.restored_pages",
                  "batcher.host_tier.hits",
                  "batcher.host_tier.spill_evictions",
                  "batcher.preemptions_total")


def _tier_counts(before=None) -> dict:
    from distributed_llms_tpu_torch.core.observability import METRICS

    now = {n.removeprefix("batcher."): METRICS.get_counter(n)
           for n in _TIER_COUNTERS}
    return now if before is None else {k: v - before[k]
                                       for k, v in now.items()}


def _check_swapped(label, c) -> None:
    check(c["kv_swaps.out"] >= 2 and c["kv_swaps.in"] >= 2,
          f"{label}: swapped out {c['kv_swaps.out']} and in "
          f"{c['kv_swaps.in']} times, under 2")
    check(c["kv_swaps.fallback"] == 0,
          f"{label}: {c['kv_swaps.fallback']} swap(s) fell back to "
          f"recompute")


def _first_diff(got, want) -> str:
    for j, (a, w) in enumerate(zip(got, want)):
        if a != w:
            return f"token {j}: {a} vs {w}"
    return f"lengths {len(got)} vs {len(want)}"


def _same_streams(label, reqs, got, want) -> None:
    for r, g, w in zip(reqs, got, want):
        check(g == w, f"{label}: the stream of {r['prompt'][:24]!r} "
                      f"(prefix {r.get('prefix')}) differs from the "
                      f"unpressured run's at {_first_diff(g, w)}")


def serve_tiered(torch) -> dict:
    """Path i: ``dlt-serve-torch --preset llama-3-8b --paged-pages 40
    --page-size 64 --prefix-cache --host-pages 128 --max-len 1024`` answers
    :func:`tier_requests` over HTTP under pool pressure: rows swap out and
    back, the shared prefix's cached pages spill to the host tier and a
    later hit restores them, one request is penalized and one names a
    registered prefix.  Every stream must equal the same requests' on an
    unpressured batcher over the same weights (256 pages, no tier), at bf16
    (K1) and, engine-side, at int8 (K1q).  Then the penalized stream's
    eager and graph loops, the named prefix's first-token logits, and a
    parcel's round trip at full width.  Returns path i's K1 and K1q
    launches."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    reqs = tier_requests()
    parcel_round_trip(torch)
    box: dict = {}

    def setup(server) -> None:
        server.batcher.register_prefix("sys", TIER_PREFIX)
        box["streams"], box["ttft"] = _record_streams(server.batcher)
        box["server"] = server
        # The serving peak, not the boot's (random weights are drawn in
        # float32 leaf by leaf).
        torch.cuda.reset_peak_memory_stats()

    async def requests(_port):
        return await _serve_tier_requests(box["server"], reqs)

    counts0 = _tier_counts()
    # Llama-3-8B's width at STORE_LAYERS layers (a bf16 store of the cut
    # model, as paths d, e and j): the pool's page dynamics follow token
    # counts, not depth.
    tmp = tempfile.mkdtemp(prefix="dlt_store_tier_")
    try:
        info = write_store(torch, None, tmp, "llama-3-8b",
                           num_layers=STORE_LAYERS)
        launches, server, mem = serve_path(
            torch, "tiered", ["--store", tmp, *TIER_ARGS],
            {"paged_decode_attention": 1}, requests, _llama_3_8b_cut,
            setup=setup, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = server.batcher
    streams = box.pop("streams")
    ttft = sorted(box.pop("ttft").values())
    box.clear()
    served = _tier_counts(counts0)
    tier = b.host_tier.stats()
    emit("serve_tier", path="tiered", counters=served, host_tier=tier,
         pinned_host_bytes=b.host_tier.pinned_bytes,
         http_decode_steps=b.decode_steps,
         ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
         ttft_s=ttft, serving_peak_mem_gb=mem["peak_mem_gb"])
    _check_swapped("tiered", served)
    check(served["host_tier.spilled_pages"] > 0,
          "tiered: no cached page spilled to the host tier")
    check(served["host_tier.hits"] > 0,
          "tiered: no prefix-cache hit was restored from the host tier")
    b.assert_pool_consistent()
    check(tier["swap_parcels"] == 0 and tier["used"] == tier["spill_entries"],
          f"tiered: the host tier still holds swap parcels: {tier}")
    got = [streams.get(_tier_key(b, r)) for r in reqs]
    check(all(g is not None for g in got), "tiered: a stream was not seen")

    ctor = dict(b._ctor_args)
    calm_b = batcher_lib.ContinuousBatcher(
        **{**ctor, "paged_pages": 256, "host_pages": 0})
    plain_pen = {k: v for k, v in reqs[4].items()
                 if k not in TIER_PENALTIES}
    calm, calm_wall, calm_steps = _tier_engine_run(
        torch, calm_b, reqs, extra=[plain_pen])
    _same_streams("tiered", reqs, got, calm[:-1])
    check(calm[4] != calm[-1], "tiered: the penalized stream equals the "
          "same prompt's without penalties")
    del calm_b
    _free(torch)
    c0 = _tier_counts()
    busy_b = batcher_lib.ContinuousBatcher(**ctor)
    pressed, pressed_wall, pressed_steps = _tier_engine_run(torch, busy_b,
                                                            reqs)
    _same_streams("tiered/engine-side", reqs, pressed, calm[:-1])
    emit("serve_tier_walls", path="tiered",
         pressured_ms_per_decode_step=pressed_wall * 1e3 / pressed_steps,
         unpressured_ms_per_decode_step=calm_wall * 1e3 / calm_steps,
         pressured_decode_steps=pressed_steps,
         unpressured_decode_steps=calm_steps,
         pressured_wall_s=pressed_wall, unpressured_wall_s=calm_wall,
         counters=_tier_counts(c0))
    del busy_b
    _free(torch)
    named_prefix_logits(torch, b)
    # The penalized request's three engine loops (and swaps under them),
    # one run each: the streams are the check here, not the walls.
    loop_variants(torch, "tiered", b, False, penalties=TIER_PENALTIES,
                  timed_runs=0)

    # The int8 leg (K1q): the same pair of runs, int8 codes and scales
    # swapped and spilled verbatim.
    reset_launches()
    c0 = _tier_counts()
    q_b = batcher_lib.ContinuousBatcher(**{**ctor, "kv_bits": 8})
    q_pressed, q_wall, q_steps = _tier_engine_run(torch, q_b, reqs)
    q_launches = read_launches()
    q_counts = _tier_counts(c0)
    del q_b
    _free(torch)
    q_calm_b = batcher_lib.ContinuousBatcher(
        **{**ctor, "kv_bits": 8, "paged_pages": 256, "host_pages": 0})
    q_calm, _, _ = _tier_engine_run(torch, q_calm_b, reqs)
    del q_calm_b
    _free(torch)
    emit("serve_tier_int8", path="tiered", counters=q_counts,
         decode_steps=q_steps, ms_per_decode_step=q_wall * 1e3 / q_steps,
         launches={k: v for k, v in q_launches.items() if v})
    _check_swapped("tiered/int8", q_counts)
    want = b.cfg.num_layers * q_steps
    check(q_launches["paged_decode_attention_int8"] >= want,
          f"tiered/int8: K1q launched "
          f"{q_launches['paged_decode_attention_int8']} times, under {want}")
    _same_streams("tiered/int8", reqs, q_pressed, q_calm)
    del server, b
    _free(torch)
    return {"paged_decode_attention": launches["paged_decode_attention"],
            "paged_decode_attention_int8":
                q_launches["paged_decode_attention_int8"]}


def named_prefix_logits(torch, b) -> None:
    """The named prefix at full width: the first-token logits of a
    prefix-seeded admission (``admit_row_with_prefix_paged``'s prefill)
    against the whole prompt's (``admit_row_paged``'s), by phase_model's
    rule; and each admission samples its logits' argmax."""
    from distributed_llms_tpu_torch.runtime import batcher as bl
    from distributed_llms_tpu_torch.runtime.shapes import bucket_length

    pfx = b.prefixes["sys"]
    suffix = b.tokenizer.encode(_tier_text("named H", 90))
    whole = pfx.ids + suffix
    chunk = torch.zeros(min(bucket_length(len(suffix)), b.s - len(pfx.ids)),
                        dtype=torch.int32)
    chunk[:len(suffix)] = torch.tensor(suffix)
    prompt = torch.zeros(min(bucket_length(len(whole)), b.s),
                         dtype=torch.int32)
    prompt[:len(whole)] = torch.tensor(whole)
    chunk, prompt = chunk.cuda(), prompt.cuda()
    with torch.no_grad():
        lp, _ = bl._prefill_row_with_prefix(b.params, b.cfg, pfx.k.clone(),
                                            pfx.v.clone(), len(pfx.ids),
                                            chunk)
        lw, _ = bl._prefill_row(b.params, b.cfg, pfx.k.dtype, b.s, prompt)
    lp, lw = lp[0, len(suffix) - 1].float(), lw[0, len(whole) - 1].float()
    err = (lp - lw).abs().max().item()
    scale = lw.abs().max().item()
    pool = bl._paged_pool(b.cfg, 1 + b.pages_per_row, b.page_size,
                          device="cuda")
    pages = torch.arange(1, 1 + b.pages_per_row, dtype=torch.int32,
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, tok_p, _ = bl.admit_row_with_prefix_paged(
        b.params, b.cfg, pool, pages, pfx.k, pfx.v, len(pfx.ids), chunk,
        len(suffix), gen)
    _, tok_w, _ = bl.admit_row_paged(b.params, b.cfg, pool, pages, prompt,
                                     len(whole), gen)
    emit("named_prefix", prefix_tokens=len(pfx.ids),
         suffix_tokens=len(suffix), max_abs_logit_err=err, logit_scale=scale,
         argmax_agree=int(lp.argmax()) == int(lw.argmax()))
    check(err <= 0.05 * max(scale, 1.0),
          f"named prefix: first-token logits off by {err} (scale {scale})")
    check(int(tok_p) == int(lp.argmax()) and int(tok_w) == int(lw.argmax()),
          "named prefix: an admission did not sample its logits' argmax")
    del pool
    _free(torch)


def parcel_round_trip(torch) -> None:
    """A 9-page parcel of Llama-3-8B pages (bf16, and int8 codes with
    their f32 scales) through the pinned arena and back into other pages
    of the pool: equal to the bit.  Timed in parts (median of 3): the
    swap-out's gather, device-to-host copy and checksum, the restore's
    verification, host-to-device copy and scatter."""
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import batcher as bl
    from distributed_llms_tpu_torch.runtime.kv_tier import HostTier

    cfg = get_preset("llama-3-8b")
    n = PARCEL_PAGES
    src = torch.arange(1, 1 + n, dtype=torch.int32, device="cuda")
    dest = torch.arange(1 + n, 1 + 2 * n, dtype=torch.int32, device="cuda")
    for kv_bits in (16, 8):
        pool = bl._paged_pool(cfg, 1 + 2 * n, 64, device="cuda",
                              kv_bits=kv_bits)
        g = torch.Generator(device="cuda").manual_seed(1)
        leaves = [pool.k, pool.v] + ([pool.k_scale, pool.v_scale]
                                     if kv_bits == 8 else [])
        for t in leaves:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
            elif t.dtype == torch.float32:
                torch.nn.init.uniform_(t, generator=g)
            else:
                torch.nn.init.normal_(t, generator=g)
        tier = HostTier(n, bl.page_layout(pool), pin=True)
        parcel_bytes = sum(t[:, :n].numel() * t.element_size()
                           for t in leaves)
        parts: dict = {}
        for _ in range(3):
            for t in leaves:
                t[:, 1 + n:].zero_()
            marks = []
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            payload = bl._export_pages_raw(pool, src)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            h = tier.park_swap(payload, n)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            entry = tier._swaps[h]
            entry.future.result()
            t0 = time.perf_counter()
            tier._checksum(entry.slots)
            checksum = time.perf_counter() - t0
            t0 = time.perf_counter()
            parcel = tier.take_swap(h)
            verify = time.perf_counter() - t0
            check(parcel is not None, "parcel round trip: verification "
                                      "failed")
            t0 = time.perf_counter()
            arrays = parcel.to("cuda")
            torch.cuda.synchronize()
            h2d = time.perf_counter() - t0
            t0 = time.perf_counter()
            bl._import_pages_raw(pool, dest, *arrays)
            torch.cuda.synchronize()
            scatter = time.perf_counter() - t0
            for name, v in (("gather", marks[1] - marks[0]),
                            ("d2h", marks[2] - marks[1]),
                            ("checksum", checksum), ("verify", verify),
                            ("h2d", h2d), ("scatter", scatter)):
                parts.setdefault(name, []).append(v * 1e3)
            for t in leaves:
                check(torch.equal(t[:, dest.long()], t[:, src.long()]),
                      f"parcel round trip (kv_bits {kv_bits}): the pages "
                      f"came back changed")
        med = {k: sorted(v)[1] for k, v in parts.items()}
        emit("parcel", kv_bits=kv_bits, pages=n, parcel_bytes=parcel_bytes,
             pinned_host_bytes=tier.pinned_bytes,
             **{f"{k}_ms": v for k, v in med.items()},
             swap_out_ms=med["gather"] + med["d2h"] + med["checksum"],
             restore_ms=med["verify"] + med["h2d"] + med["scatter"],
             d2h_gb_per_s=parcel_bytes / med["d2h"] / 1e6,
             h2d_gb_per_s=parcel_bytes / med["h2d"] / 1e6)
        tier.assert_consistent([])
        del pool, tier, payload, parcel, arrays
        _free(torch)


# -- path j: speculative decoding on path a's model ---------------------------

SPEC_K = 4  # runtime.spec_k's default: --spec-decode alone gives it
SPEC_NEW = 64
SPEC_ARGS = ["--paged-pages", "256", "--page-size", "64", "--prefix-cache",
             "--spec-decode", "--max-len", "1024", *_COMMON_ARGS]
# Path j's depth, cut from Llama-3-8B's 32 layers (to keep the whole smoke
# near its time as path n joined it): every layer keeps the published
# width, so each draft step, verify window and K5 launch is the full
# model's a layer; served from a bf16 store of the cut model, as path h.
SPEC_LAYERS = STORE_LAYERS
# Check (a)'s bound on a greedy stream that left the plain batcher's: at
# every position the committed token's logit under a teacher-forced
# reference forward (one no-cache forward over prompt + stream, dense
# attention) lies within this many times the plain stream's own worst
# margin under the same forward (the plain decode's bf16 rounding against
# the reference's) of the maximum.  A wrong commit lands O(1) logits
# below (random weights: logits ~N(0, 1), the top ~4.5 above the mean).
SPEC_MARGIN_FACTOR = 4.0
SPEC_SAMPLED_TEMPERATURE = 0.8
SPEC_WINDOW_LENGTHS = (0, 1, 63, 64, 303, 352, 700, 1023)  # cache_index
# The profiled batch of the round's cost: 16 new tokens (15 rounds, ~60k
# device kernels) keep the profiler's own host-side processing short.
SPEC_PROFILED_NEW = 16


def _lap(phase: str):
    """A stopwatch emitting ``{"phase": phase, "part": ..., "seconds":
    ...}`` lines: each call times the part since the previous one."""
    last = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        emit(phase, part=part, seconds=now - last[0])
        last[0] = now
    return lap


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def spec_requests() -> list:
    """Path j's traffic: path a's seven prompts, all greedy, 64 new tokens
    each — three over path a's 303-byte prefix, one over SSE, one naming
    the registered prefix "sys" (path a's top-p and top-k requests would
    now be refused: a speculative engine samples with its own config)."""
    def completion(prompt, **kw):
        return ("/v1/completions", {"prompt": prompt, "max_tokens": SPEC_NEW,
                                    "temperature": 0.0, **kw})

    def chat(*messages):
        return ("/v1/chat/completions", {
            "messages": [{"role": r, "content": c} for r, c in messages],
            "max_tokens": SPEC_NEW, "temperature": 0.0})

    return [
        completion(PATH_A_PREFIX + "Case A: a pallet arrived late.",
                   logprobs=True),
        completion(PATH_A_PREFIX + "Case B: a crate is dented."),
        completion(PATH_A_PREFIX + "Case A: a pallet arrived late.",
                   logprobs=True),
        completion("Summarise policy 12 in a line.", prefix="sys"),
        completion("Streaming check: count to ten.", stream=True),
        completion("Top-k sampling check."),
        chat(("system", "Be brief."), ("user", "Name three ports.")),
    ]


def _record_submits(b) -> tuple:
    """Wrap batcher ``b`` so that each submit's (rid, prompt ids, prefix) is
    kept in order, and each request's delivered token ids by rid."""
    subs, streams = [], {}
    submit, run = b.submit, b.run

    def submit_rec(prompt, *a, prefix=None, **kw):
        rid = submit(prompt, *a, prefix=prefix, **kw)
        ids = b.tokenizer.encode(prompt) if isinstance(prompt, str) else prompt
        subs.append((rid, list(ids), prefix))
        return rid

    def run_rec(on_tokens=None):
        def rec(rid, toks, done, lps):
            streams.setdefault(rid, []).extend(toks)
            return on_tokens(rid, toks, done, lps)
        return run(on_tokens=rec)

    b.submit, b.run = submit_rec, run_rec
    return subs, streams


async def _serve_spec_requests(port: int, reqs) -> dict:
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[
        _sse(port, body) if body.get("stream") else _http(port, path, body)
        for path, body in reqs])
    wall = time.perf_counter() - t0
    n = 0
    for (path, body), out in zip(reqs, outs):
        if body.get("stream"):
            continue  # _sse checked the status and the [DONE]
        status, resp = out
        check(status == 200, f"spec: {path} answered {status}: {resp}")
        got = resp["usage"]["completion_tokens"]
        check(got == SPEC_NEW or resp["choices"][0]["finish_reason"] == "stop",
              f"spec: {path} produced {got}/{SPEC_NEW} tokens")
        n += got
        lp = resp["choices"][0].get("logprobs")
        if lp:
            check(all(math.isfinite(x) and x <= 0
                      for x in lp["token_logprobs"]),
                  "spec: non-finite or positive logprob")
    return {"requests": len(reqs), "completion_tokens_non_sse": n,
            "wall_s": wall}


def _engine_run(torch, b, subs, new=SPEC_NEW) -> tuple:
    """``subs`` [(rid, ids, prefix)] submitted to batcher ``b`` engine-side
    in order: (streams in that order, wall seconds)."""
    if "sys" not in b.prefixes:
        b.register_prefix("sys", PATH_A_PREFIX)
    rids = [b.submit(ids, max_new_tokens=new, prefix=pfx)
            for _, ids, pfx in subs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b.assert_pool_consistent()
    return [res[r] for r in rids], wall


def _margins(torch, b, ctx, stream) -> list:
    """Teacher-forced greedy margins of ``stream`` after context ``ctx``:
    at each position the maximum logit less the streamed token's, from one
    no-cache forward of the target over ctx + stream (dense attention)."""
    from distributed_llms_tpu_torch.models import model as model_lib

    toks = torch.tensor([ctx + stream[:-1]], device=b.device)
    with torch.no_grad():
        logits, _ = model_lib.forward(b.params, b.cfg, toks)
    lg = logits[0, len(ctx) - 1:]
    chosen = lg.gather(-1, torch.tensor(stream, device=b.device)[:, None])
    return (lg.max(-1).values - chosen[:, 0]).float().cpu().tolist()


def _held_to_plain(torch, label, b, subs, got, want) -> dict:
    """Check (a)/(b)/(c): the speculative streams ``got`` against the plain
    batcher's ``want`` for the same requests.  Identical streams pass; a
    stream that leaves the plain one must be the target's greedy stream up
    to rounding: its worst teacher-forced margin within SPEC_MARGIN_FACTOR
    x the plain streams' worst (both against the same reference forward).
    Returns what it measured."""
    identical = [g == w for g, w in zip(got, want)]
    first = [next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                  None if len(g) == len(w) else min(len(g), len(w)))
             for g, w in zip(got, want)]
    out = {"streams": len(got), "identical": sum(identical),
           "first_divergence": first}
    if not all(identical):
        pfx = b.prefixes["sys"].ids
        spec_m, plain_m = [], []
        for (_, ids, p), g, w in zip(subs, got, want):
            ctx = (pfx if p else []) + ids
            spec_m += _margins(torch, b, ctx, g)
            plain_m += _margins(torch, b, ctx, w)
        bound = SPEC_MARGIN_FACTOR * max(max(plain_m), 1e-3)
        out.update(spec_margin_max=max(spec_m), plain_margin_max=max(plain_m),
                   margin_bound=bound,
                   spec_positions_off_argmax=sum(m > 0 for m in spec_m),
                   plain_positions_off_argmax=sum(m > 0 for m in plain_m),
                   positions=len(spec_m))
        check(max(spec_m) <= bound,
              f"{label}: a speculative stream commits a token "
              f"{max(spec_m):.4f} logits below the target's greedy choice "
              f"(plain streams' worst {max(plain_m):.4f}, bound {bound:.4f})")
    return out


def _spec_kernel_split(torch, prof) -> dict:
    """Device milliseconds of a speculative profile: draft K5, draft K2,
    verify K1 (each with its split-merge launches: a merge is charged to
    the decode kernel launched before it), cuBLAS, the rest."""
    split = {"draft_k5": 0.0, "draft_k2": 0.0, "verify_k1": 0.0,
             "cublas": 0.0, "rest": 0.0}
    last = "rest"
    for name, _, ms in sorted(_device_events(torch, prof),
                              key=lambda e: e[1]):
        if "quant_matmul" in name:
            cls = "draft_k5"
        elif "ragged_decode_kernel" in name:
            cls = last = "draft_k2"
        elif "paged_decode_kernel" in name:
            cls = last = "verify_k1"
        elif "split_decode_merge" in name:
            cls = last
        elif _kernel_class(name) == "matmul":
            cls = "cublas"
        else:
            cls = "rest"
        split[cls] += ms
    return split


def _spec_loops(torch, label, ctor, subs) -> dict:
    """Check (d): a sampled speculative batcher (temperature 0.8, seed 7)
    gives the same streams under the eager loop (every kernel launched
    from Python, ``_spec_steps``), the graph without the overlap and the
    default (graph and overlap)."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    graph_round = batcher_lib.spec_chunk
    streams, stats = {}, {}
    for name, overlap, eager in LOOPS:
        b = batcher_lib.ContinuousBatcher(**{
            **ctor, "temperature": SPEC_SAMPLED_TEMPERATURE, "seed": 7,
            "overlap": overlap})
        if eager:
            batcher_lib.spec_chunk = (
                lambda *a, graphs=None, **kw: batcher_lib._spec_steps(*a, **kw))
        try:
            streams[name], wall = _engine_run(torch, b, subs)
        finally:
            batcher_lib.spec_chunk = graph_round
        stats[name] = {"rounds": b.spec_stats["rounds"], "wall_s": wall,
                       "graph_replays": b._graphs.replays,
                       "dispatched_ahead": b.overlap_stats["dispatched_ahead"]}
        check((b._graphs.replays > 0) != eager,
              f"{label}/{name}: graph replays {b._graphs.replays}")
        del b
        _free(torch)
    same = (streams["graph_overlap"] == streams["graph_sync"]
            == streams["eager_sync"])
    emit("serve_spec_sampled", path=label, card=_card(),
         temperature=SPEC_SAMPLED_TEMPERATURE, loops=stats,
         streams_identical=same)
    check(same, f"{label}: sampled streams differ between the engine loops")
    check(stats["graph_overlap"]["dispatched_ahead"] > 0,
          f"{label}: no round was dispatched ahead")
    return stats


def spec_window_checks(torch) -> dict:
    """Check (e): the verify window's one K1/K1q launch over B*T virtual
    rows at path j's shape (B=8, T=k+1, 32/8 heads of 128, 64-slot pages,
    a 17-page table: 1029 slots) against T single-offset launches (the
    reference's formulation) and the plain version, every row within 1%
    of its L2 norm (+ 2^-7 int8)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize
    from distributed_llms_tpu_torch.models.model import paged_window_rows
    from distributed_llms_tpu_torch.ops import decode_attn

    gen = torch.Generator(device="cuda").manual_seed(21)
    b, t, h, kvh, d, blk = 8, SPEC_K + 1, 32, 8, 128, 64
    p = -(-(1024 + SPEC_K + 1) // blk)
    nb = 1 + b * p
    bf = [torch.randn((nb, blk, kvh, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16) for _ in range(2)]
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[: b * p]
              .reshape(b, p).to(torch.int32) + 1)
    cache_index = torch.tensor(SPEC_WINDOW_LENGTHS, dtype=torch.int32,
                               device="cuda")
    q = torch.randn((b, t, h, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    _, _, lengths, rep = paged_window_rows(tables, cache_index, t, blk)
    out = {}
    for quant in (False, True):
        pool, scales = bf, {}
        if quant:
            (kq, ks), (vq, vs) = (kv_quantize(a) for a in bf)
            pool, scales = [kq, vq], dict(k_scale=ks, v_scale=vs)
        one = decode_attn.paged_decode_attention(
            q.reshape(b * t, 1, h, d), *pool, lengths, rep, **scales)
        each = torch.cat([decode_attn.paged_decode_attention(
            q[:, j:j + 1].contiguous(), *pool, cache_index + 1 + j, tables,
            **scales) for j in range(t)], dim=1)
        plain = decode_attn.paged_reference(
            q.reshape(b * t, 1, h, d), *pool, lengths, rep, *scales.values())
        limit = DECODE_ROW_REL + (2.0 ** -7 if quant else 0.0)
        vs_each = row_rel_err(torch, one.reshape(b, t, h, d), each)
        vs_plain = row_rel_err(torch, one, plain)
        name = ("paged_decode_attention_int8" if quant
                else "paged_decode_attention")
        emit("kernel", name=name, shape="spec_window", B=b, T=t,
             cache_index=list(SPEC_WINDOW_LENGTHS), pages=p,
             max_row_rel_err_vs_per_offset=vs_each,
             max_row_rel_err_vs_plain=vs_plain, limit=limit)
        check(vs_each <= limit and vs_plain <= limit,
              f"{name}: the one-launch window disagrees ({vs_each:.4g} vs "
              f"the per-offset launches, {vs_plain:.4g} vs plain)")
        out[name] = vs_plain
    return out


def _timed_batch(torch, b, prompts, profile) -> dict:
    """8 greedy requests (300-token prompts, 64 new, cold admissions) on
    batcher ``b``: wall, rounds or decode steps, committed tokens; with
    ``profile`` once more, with SPEC_PROFILED_NEW new tokens, under the
    profiler (its device split also per round or decode step)."""
    rounds0 = b.spec_stats["rounds"]
    steps0 = b.decode_steps
    stats0 = dict(b.spec_stats)
    got, wall, _, _ = _run_batch(torch, b, prompts)
    committed = sum(len(t) - 1 for t in got)  # decode tokens (admission's not)
    line = {"wall_ms": wall * 1e3, "decode_steps": b.decode_steps - steps0,
            "committed_decode_tokens": committed}
    if b.speculative:
        r = b.spec_stats["rounds"] - rounds0
        acc = b.spec_stats["accepted"] - stats0["accepted"]
        rej = b.spec_stats["rejected"] - stats0["rejected"]
        line.update(rounds=r, ms_per_round=wall * 1e3 / r,
                    tokens_per_round_per_row=committed / (r * len(prompts)),
                    acceptance=acc / max(acc + rej, 1),
                    ms_per_committed_token_per_row=(
                        wall * 1e3 * len(prompts) / committed))
    else:
        line.update(ms_per_decode_step=wall * 1e3 / max(line["decode_steps"],
                                                         1))
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        steps0, rounds0 = b.decode_steps, b.spec_stats["rounds"]
        with profiler(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _run_batch(torch, b, prompts, new=SPEC_PROFILED_NEW)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        split = (_spec_kernel_split(torch, prof) if b.speculative
                 else _kernel_split(torch, prof))
        busy = sum(split.values())
        n = (b.spec_stats["rounds"] - rounds0 if b.speculative
             else b.decode_steps - steps0)
        line.update(profiled_new_tokens=SPEC_PROFILED_NEW,
                    profiled_wall_ms=pwall, profiled_steps=n,
                    device_kernel_ms=split,
                    device_kernel_ms_per_step={k: v / max(n, 1)
                                               for k, v in split.items()},
                    device_busy_share=busy / pwall if busy else "not measured")
    return line, got


def serve_spec(torch, profile: bool) -> dict:
    """Path j: ``dlt-serve-torch --store DJ --paged-pages 256
    --page-size 64 --prefix-cache --spec-decode --max-len 1024 --slots 8``
    over a bf16 store of Llama-3-8B's width at SPEC_LAYERS layers
    (spec_k 4, the int4 self-draft) answers :func:`spec_requests` over
    HTTP, then checks (a)-(e) engine-side over the same weights: (a) the
    HTTP streams against a plain batcher's; (b) the same with int8 pages
    (K1q's window) against the plain int8 batcher; (c) an explicit draft
    ``attach_draft(cfg, params)`` (the bf16 target itself); (d) a sampled
    batcher under the three engine loops; (e) the one-launch window
    against per-offset K1/K1q launches.  Then the round's cost: 8 requests
    timed on the speculative batcher and the plain one, and (with
    ``profile``) the round's device split.  Returns path j's launches of
    K1, K1q, K2 and K5 int4."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    card = _card()
    lap = _lap("spec_time")
    reqs = spec_requests()
    box: dict = {}

    def setup(server) -> None:
        b = server.batcher
        check(b.speculative and b.spec_k == SPEC_K and b.paged,
              "spec: the served batcher does not speculate")
        wq = b.draft_params["blocks"]["attn"]["wq"]
        check(isinstance(wq, QuantizedTensor) and wq.bits == 4,
              "spec: the draft is not the int4 self-draft")
        b.register_prefix("sys", PATH_A_PREFIX)
        box["subs"], box["streams"] = _record_submits(b)
        torch.cuda.reset_peak_memory_stats()

    per_round = {"paged_decode_attention": 1,
                 "ragged_decode_attention": SPEC_K + 1,
                 "quant_matmul_int4": 7 * (SPEC_K + 1)}
    tmp = tempfile.mkdtemp(prefix="dlt_store_spec_")
    try:
        info = write_store(torch, None, tmp, "llama-3-8b",
                           num_layers=SPEC_LAYERS)
        launches, server, mem = serve_path(
            torch, "spec", ["--store", tmp, *SPEC_ARGS], per_round,
            lambda port: _serve_spec_requests(port, reqs), _llama_3_8b_cut,
            setup=setup, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = server.batcher
    subs, streams = box.pop("subs"), box.pop("streams")
    got = [streams[rid] for rid, _, _ in subs]
    out = {k: launches[k] for k in per_round}
    acc, rej = b.spec_stats["accepted"], b.spec_stats["rejected"]
    emit("serve_spec", path="spec", card=card, rounds=b.spec_stats["rounds"],
         spec_stats=b.spec_stats, acceptance=acc / max(acc + rej, 1),
         committed_decode_tokens=sum(len(t) - 1 for t in got),
         tokens_per_round_per_row_http=(
             sum(len(t) - 1 for t in got) / max(b.spec_stats["rounds"], 1)
             / len(got)),
         serving_peak_mem_gb=mem["peak_mem_gb"],
         resident_gb=mem["resident_gb"],
         draft_cache_gb=2 * b.draft_cache.k.nbytes / 1e9,
         prefix_cache_hits=b.prefix_cache.hits)
    check(b.prefix_cache.hits > 0, "spec: no prefix-cache hit")
    lap("boot_and_http")
    ctor = dict(b._ctor_args)
    plain_ctor = {**ctor, "draft_params": None, "draft_cfg": None}

    # (a) the HTTP streams against the plain batcher's, engine-side.
    plain_b = batcher_lib.ContinuousBatcher(**plain_ctor)
    want, _ = _engine_run(torch, plain_b, subs)
    del plain_b
    _free(torch)
    emit("serve_spec_check", path="spec", check="a_http_vs_plain", card=card,
         **_held_to_plain(torch, "spec/a", b, subs, got, want))
    lap("a")

    # (b) int8 pages: the speculative int8 batcher (K1q's window) against
    # the plain int8 batcher.
    reset_launches()
    q_spec = batcher_lib.ContinuousBatcher(**{**ctor, "kv_bits": 8})
    q_got, _ = _engine_run(torch, q_spec, subs)
    q_launches = read_launches()
    q_rounds = q_spec.spec_stats["rounds"]
    del q_spec
    _free(torch)
    check(q_launches["paged_decode_attention_int8"]
          >= b.cfg.num_layers * q_rounds,
          f"spec/int8: K1q launched {q_launches['paged_decode_attention_int8']}"
          f" times, under {b.cfg.num_layers} x {q_rounds} rounds")
    q_plain = batcher_lib.ContinuousBatcher(**{**plain_ctor, "kv_bits": 8})
    q_want, _ = _engine_run(torch, q_plain, subs)
    del q_plain
    _free(torch)
    out["paged_decode_attention_int8"] = q_launches[
        "paged_decode_attention_int8"]
    emit("serve_spec_check", path="spec", check="b_int8_vs_plain_int8",
         card=card, rounds=q_rounds,
         launches={k: v for k, v in q_launches.items() if v},
         **_held_to_plain(torch, "spec/b", b, subs, q_got, q_want))
    lap("b")

    # (c) an explicit draft through attach_draft: the bf16 target itself.
    eng = InferenceEngine(b.cfg, RuntimeConfig(spec_k=SPEC_K), b.params,
                          tokenizer=b.tokenizer, device=b.device)
    eng.attach_draft(b.cfg, b.params)
    x_b = eng.continuous_batcher(batch_slots=b.b, max_len=b.s,
                                 paged_pages=ctor["paged_pages"],
                                 page_size=b.page_size, prefix_cache=True,
                                 speculative=True)
    x_got, _ = _engine_run(torch, x_b, subs)
    x_acc, x_rej = x_b.spec_stats["accepted"], x_b.spec_stats["rejected"]
    # A greedy round commits the verify's own tokens, so the stream does
    # not depend on the draft: the bf16 draft's streams equal the int4
    # self-draft's (path j's HTTP streams) to the token.
    emit("serve_spec_check", path="spec", check="c_explicit_draft_vs_plain",
         card=card, spec_stats=x_b.spec_stats,
         acceptance=x_acc / max(x_acc + x_rej, 1),
         streams_equal_the_int4_draft=x_got == got,
         **_held_to_plain(torch, "spec/c", b, subs, x_got, want))
    check(x_got == got, "spec/c: the bf16 draft's greedy streams differ from "
          "the int4 self-draft's")
    del x_b, eng
    _free(torch)
    lap("c")

    # (d) a sampled batcher under the three engine loops.
    _spec_loops(torch, "spec", ctor, subs)
    lap("d")

    # (e) the one-launch verify window at path j's shape.
    spec_window_checks(torch)
    lap("e")

    # The round's cost against a plain decode step at the same batch.
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (LOOP_PROMPT_TOKENS,),
                             generator=g).tolist() for _ in range(b.b)]
    lines = {}
    for name, kw in (("spec", ctor), ("plain", plain_ctor)):
        tb_ = batcher_lib.ContinuousBatcher(**kw)
        _run_batch(torch, tb_, prompts)  # captures the graphs
        lines[name], _ = _timed_batch(torch, tb_, prompts, profile)
        if name == "spec":
            lines[name]["peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                          / 1e9)
        del tb_
        _free(torch)
    lap("cost")
    emit("serve_spec_cost", path="spec", card=card, requests=b.b,
         prompt_tokens=LOOP_PROMPT_TOKENS, new_tokens=LOOP_NEW_TOKENS,
         spec=lines["spec"], plain=lines["plain"],
         spec_ms_per_token_over_plain_ms_per_step=(
             lines["spec"]["ms_per_committed_token_per_row"]
             / lines["plain"]["ms_per_decode_step"]))
    del server, b
    _free(torch)
    return out


def _kernel_class(name: str) -> str:
    if "flash_kernel" in name:
        return "flash_kernel"
    if "quant_matmul" in name:
        return "quant_matmul_kernel"
    if any(k in name for k in ("paged_decode_kernel", "ragged_decode_kernel",
                               "split_decode_merge")):
        return "decode_attention_kernel"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "splitK",
                               "sm90_xmma")):
        return "matmul"
    return "other"


def _kernel_split(torch, prof) -> dict:
    """Device kernel milliseconds of a profile, by kernel class."""
    split = {"flash_kernel": 0.0, "quant_matmul_kernel": 0.0,
             "decode_attention_kernel": 0.0, "matmul": 0.0, "other": 0.0}
    for name, _, ms in _device_events(torch, prof):
        split[_kernel_class(name)] += ms
    return split


def _profiled(torch, fn) -> tuple[dict, float]:
    """Run ``fn`` once under the profiler: (device ms by kernel class,
    wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _kernel_split(torch, prof), wall * 1e3


def flash_admission(torch, batcher, profile: bool) -> None:
    """Path f's served batcher once more, outside HTTP (a second
    32768-slot cache would not fit beside it): one FLASH_PROMPT_BYTES-token
    prompt admitted alone and decoded 16 tokens.  The admission token's
    time from submit is the admission's time to first token (random
    weights mostly emit bytes that decode to no text, so an SSE client
    sees no early event to time).  Then, with ``profile``, the same under
    the profiler: K4's share of the admission.  Information, not a gate."""
    g = torch.Generator().manual_seed(6)

    def run():
        prompt = torch.randint(0, 256, (FLASH_PROMPT_BYTES,),
                               generator=g).tolist()
        first = []
        t0 = time.perf_counter()
        batcher.submit(prompt, max_new_tokens=16)
        batcher.run(on_tokens=lambda *a: first or first.append(
            time.perf_counter() - t0))
        torch.cuda.synchronize()
        return first[0], time.perf_counter() - t0

    ttft, total = run()
    emit("serve_ttft", path="flash_prefill", prompt_tokens=FLASH_PROMPT_BYTES,
         new_tokens=16, ttft_s=ttft, request_s=total)
    if profile:
        split, wall = _profiled(torch, run)
        busy = sum(split.values())
        emit("profile", path="flash_prefill", requests=1,
             prompt_tokens=FLASH_PROMPT_BYTES, new_tokens=16,
             profiled_wall_ms=wall, device_kernel_ms=split,
             flash_share_of_device=split["flash_kernel"] / busy if busy else
             "not measured",
             decode_attention_share_of_device=(
                 split["decode_attention_kernel"] / busy if busy else
                 "not measured"),
             device_busy_share=busy / wall if busy else "not measured")


# -- path k: constrained output and the fault plane ---------------------------

# Path k serves a bf16 store of Llama-3-8B's width cut to STORE_LAYERS
# layers since PR 17 (``--store`` before these flags), as paths d, e, h,
# i, j: the smoke's time with path p.
CON_ARGS = [*SERVE_ARGS[2:], "--max-len", "1024"]
CON_NEW = 64
CON_OBJECT = {"type": "object",
              "properties": {"name": {"type": "string", "maxLength": 16},
                             "count": {"type": "integer"},
                             "ok": {"type": "boolean"},
                             "colour": {"enum": ["red", "green", "blue"]}},
              "required": ["name", "count", "ok", "colour"]}
CON_ARRAY = {"type": "array", "items": {"type": "integer"}, "maxItems": 4}
CON_DATE = r"\d{4}-\d{2}-\d{2}"
CON_BIAS = {"65": 5.0, "97": -5.0}
CON_SAMPLED_TEMPERATURE = 0.8
# Rows that never end before their budget (EOS banned): the swap leg and
# the timed leg.  Two automaton states a row.
CON_LONG = {"response_format": {"type": "regex", "regex": "[0-9a-f ]+"},
            "banned_tokens": [258]}  # the byte tokenizer's EOS
CON_SWAP_ARGS = dict(paged_pages=40, host_pages=128)  # path i's pool and tier
CON_SWAP_NEW = 192
CON_STALL_S = 3.0
CON_WATCHDOG_S = 1.0
CON_CRASH_REQUESTS = 10  # 8 slots: at least 2 still queued at the crash
CON_CRASH_NEW = 32


def _rf(schema=None, regex=None) -> dict:
    if schema is not None:
        return {"type": "json_schema", "json_schema": {"schema": schema}}
    return {"type": "regex", "regex": regex}


def con_requests(banned: list) -> list:
    """Path k's traffic: (kind, body), all completions with distinct
    prompts, 64 new tokens: two JSON schemas, a regex, banned tokens with
    a logit bias, three free requests (greedy over path a's prefix, top-p
    over SSE, top-k) and one constrained request sampled at 0.8."""
    def body(prompt, **kw):
        return {"prompt": prompt, "max_tokens": CON_NEW, "temperature": 0.0,
                **kw}

    return [
        ("object", body("Return the crate record as JSON: ",
                        response_format=_rf(CON_OBJECT))),
        ("array", body("Return the bay numbers as a JSON list: ",
                       response_format=_rf(CON_ARRAY))),
        ("date", body("The delivery date was ",
                      response_format=_rf(regex=CON_DATE))),
        ("banned", body(_con_ban_prompt(), banned_tokens=banned,
                        logit_bias=CON_BIAS)),
        ("free_greedy", body(PATH_A_PREFIX + "Case K: a seal is broken.")),
        ("free_top_p", body("Free top-p check over SSE.", temperature=0.8,
                            top_p=0.9, stream=True)),
        ("free_top_k", body("Free top-k check.", temperature=1.0,
                            top_k=40)),
        ("sampled_object", body("Sample a crate record as JSON: ",
                                temperature=CON_SAMPLED_TEMPERATURE,
                                response_format=_rf(CON_OBJECT))),
    ]


def _con_ban_prompt() -> str:
    return "Banned-token check: describe dock seven."


def _con_pattern(kind_or_body) -> tuple:
    """(regex, schema or None) of a constrained body."""
    from distributed_llms_tpu_torch.runtime import constrain

    rf = kind_or_body["response_format"]
    if rf["type"] == "regex":
        return rf["regex"], None
    schema = rf["json_schema"]["schema"]
    return constrain.schema_to_regex(schema), schema


def _con_valid(label, ids, body, eos) -> dict:
    """A constrained stream: ended on EOS, its bytes match the pattern (and
    a JSON one parses and validates); cut by the budget, the bytes are a
    live prefix (the char DFA never dead).  Returns its facts."""
    from distributed_llms_tpu_torch.runtime import constrain

    regex, schema = _con_pattern(body)
    ended = bool(ids) and ids[-1] == eos
    text_ids = ids[:-1] if ended else ids
    check(all(0 <= t < 256 for t in text_ids),
          f"{label}: a constrained stream holds a non-byte token")
    data = bytes(text_ids)
    dfa = constrain.regex_to_char_dfa(regex)
    if ended:
        check(constrain.char_dfa_matches(dfa, data),
              f"{label}: {data!r} does not match {regex!r}")
        if schema is not None:
            check(constrain.validates(schema, json.loads(data)),
                  f"{label}: {data!r} does not validate")
    else:
        state = 0
        for byte in data:
            state = int(dfa.trans[state, byte])
            check(state >= 0, f"{label}: {data!r} leaves {regex!r}")
    return {"ended_on_eos": ended, "bytes": len(data),
            "text": data.decode("utf-8", "replace")}


def _record_con(b, subs: list, streams: dict) -> None:
    """Keep, on batcher ``b``, each submit's (rid, prompt ids, keyword
    arguments) in order and each rid's delivered token ids (into the given
    containers, so a respawned batcher can record into them too)."""
    submit, run = b.submit, b.run

    def submit_rec(prompt, *a, **kw):
        rid = submit(prompt, *a, **kw)
        ids = b.tokenizer.encode(prompt) if isinstance(prompt, str) else prompt
        subs.append((rid, list(ids), dict(kw)))
        return rid

    def run_rec(on_tokens=None):
        def rec(rid, toks, done, lps):
            streams.setdefault(rid, []).extend(toks)
            streams.setdefault(("t", rid), []).append(time.perf_counter())
            return on_tokens(rid, toks, done, lps)
        return run(on_tokens=rec)

    b.submit, b.run = submit_rec, run_rec


def _con_submit_kw(body) -> dict:
    kw = {"max_new_tokens": body["max_tokens"]}
    for k in ("temperature", "top_p", "top_k", "response_format",
              "logit_bias", "banned_tokens"):
        if k in body:
            kw[k] = body[k]
    return kw


def _con_engine(torch, b, bodies) -> tuple:
    """``bodies`` submitted engine-side to batcher ``b`` in order: (streams
    in that order, wall seconds, decode steps)."""
    rids = [b.submit(body["prompt"], **_con_submit_kw(body))
            for body in bodies]
    steps0 = b.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b.assert_pool_consistent()
    return [res[r] for r in rids], wall, b.decode_steps - steps0


def _con_compile_ms(b, bodies) -> list:
    """Each constraint's compile at the served vocabulary, cold then an
    LRU hit (the cache cleared first; the tokenizer's byte table timed
    apart, as the first compile would build it)."""
    from distributed_llms_tpu_torch.runtime import constrain

    constrain.clear_cache()
    t0 = time.perf_counter()
    constrain._token_byte_table(b.tokenizer, b.cfg.vocab_size)
    out = [{"what": "token_byte_table",
            "ms": (time.perf_counter() - t0) * 1e3}]
    seen = []
    for kind, body in bodies:
        kw = {k: body[k] for k in ("response_format", "logit_bias",
                                   "banned_tokens") if k in body}
        if not kw or kw in seen:
            continue
        seen.append(kw)
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            dfa = constrain.compile_request(
                **kw, tokenizer=b.tokenizer, vocab_size=b.cfg.vocab_size,
                eos_id=b.eos_id)
            ms.append((time.perf_counter() - t0) * 1e3)
        out.append({"what": kind, "states": dfa.n_states, "cold_ms": ms[0],
                    "lru_hit_ms": ms[1]})
    return out


async def _con_http(server, reqs) -> dict:
    port = server.bound_port
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[
        _http(port, "/v1/completions", body, stream=bool(body.get("stream")))
        for _, body in reqs])
    wall = time.perf_counter() - t0
    # A malformed schema: a structured 400 before any admission state.
    bad_status, bad = await _http(port, "/v1/completions", {
        "prompt": "x", "max_tokens": 4, "response_format": _rf({
            "type": "object", "properties": {"a": {"type": "null"}},
            "required": []})})
    check(bad_status == 400
          and bad["error"]["type"] == "invalid_request_error",
          f"constrain: a malformed schema answered {bad_status}: {bad}")
    check(server._inflight() == 0 and not server.batcher.has_queued(),
          "constrain: the malformed request left admission state")
    return {"outs": outs, "wall_s": wall}


def _con_timed(torch, ctor) -> dict:
    """Decode ms a step with and without constrained rows: 8 requests of
    300 random bytes and 64 new tokens on a fresh batcher, free or each
    under CON_LONG, once to capture the graphs, then twice timed (the
    faster kept).  The host time of the span plans' stack builds (numpy
    stack, pinned copy) is read apart and taken out of a second figure."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (LOOP_PROMPT_TOKENS,),
                             generator=g).tolist() for _ in range(8)]
    out = {}
    for label, extra in (("free", {}), ("constrained", CON_LONG)):
        b = batcher_lib.ContinuousBatcher(**ctor)
        planned = [0.0]
        plan = b._plan_constraints

        def timed_plan(p, plan=plan, planned=planned):
            t0 = time.perf_counter()
            plan(p)
            planned[0] += time.perf_counter() - t0

        b._plan_constraints = timed_plan
        walls = []
        for _ in range(3):
            rids = [b.submit(p, max_new_tokens=LOOP_NEW_TOKENS,
                             prefix_cache=False, **extra) for p in prompts]
            steps0 = b.decode_steps
            planned[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = b.run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0,
                          b.decode_steps - steps0, planned[0]))
            check(all(len(res[r]) == LOOP_NEW_TOKENS for r in rids),
                  f"constrain/timed {label}: a request ended early")
        wall, steps, plan_s = min(walls[1:])
        out[label] = {"ms_per_decode_step": wall * 1e3 / steps,
                      "plan_host_ms": plan_s * 1e3,
                      "ms_per_decode_step_less_plans":
                          (wall - plan_s) * 1e3 / steps,
                      "decode_steps": steps, "wall_ms": wall * 1e3,
                      "graph_captures": b._graphs.captures,
                      "stack_rungs": sorted(b._con_bufs)}
        del b
        _free(torch)
    for key in ("ms_per_decode_step", "ms_per_decode_step_less_plans"):
        out["constrained_over_free_" + key] = (out["constrained"][key]
                                               / out["free"][key])
    return out


def serve_constrain(torch) -> dict:
    """Path k: ``dlt-serve-torch --store DK --paged-pages 256 --page-size
    64 --prefix-cache --max-len 1024 --slots 8`` (DK a bf16 store of
    Llama-3-8B's width at STORE_LAYERS layers) answers
    :func:`con_requests` over HTTP (the default loop: graphs, overlap):
    every constrained output valid, no banned token, the free greedy
    stream equal to the same requests served engine-side without the
    constrained ones, a malformed schema 400.  Engine-side over the same
    weights: the constrained greedy set under the three engine loops
    (identical streams, equal to the HTTP ones), with int8 pages (K1q;
    valid), and on path i's 40-page pool with a host tier, where
    constrained rows swap out and back (streams equal the unpressured
    run).  Then the fault drills on two more boots: ``--fault
    batcher.decode:raise@3`` (respawn, zero-streamed requests re-admitted
    exactly, partly streamed ones a structured engine_error) and
    ``--no-constrained --fault batcher.decode:stall@2:3
    --watchdog-timeout 1`` (a constrained request 400; /healthz unhealthy,
    then healthy).  Returns path k's launches of K1 and K1q."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    lap = _lap("constrain_time")
    box: dict = {"subs": [], "streams": {}}

    def setup(server) -> None:
        b = server.batcher
        check(b.paged and b.prefix_cache is not None and b.s == 1024,
              "constrain: not path a's paged, prefix-cached batcher")
        eos = b.eos_id
        # The banned request's list: the first 8 tokens its prompt gives
        # greedily unconstrained, on a batcher like the served one.
        pb = batcher_lib.ContinuousBatcher(**b._ctor_args)
        rid = pb.submit(_con_ban_prompt(), max_new_tokens=8)
        first8 = pb.run()[rid]
        del pb
        _free(torch)
        box["banned"] = sorted({t for t in first8 if t != eos})
        box["reqs"] = con_requests(box["banned"])
        emit("constrain_compile", card=_card(), vocab=b.cfg.vocab_size,
             compiles=_con_compile_ms(b, box["reqs"]))
        _record_con(b, box["subs"], box["streams"])
        box["server"] = server
        torch.cuda.reset_peak_memory_stats()

    async def requests(_port):
        got = await _con_http(box["server"], box["reqs"])
        box["http"] = got
        return {"requests": len(box["reqs"]), "wall_s": got["wall_s"]}

    store = tempfile.mkdtemp(prefix="dlt_store_constrain_")
    info = write_store(torch, None, store, "llama-3-8b",
                       num_layers=STORE_LAYERS)
    try:
        return _serve_constrain(torch, lap, box, setup, requests, store,
                                info)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _serve_constrain(torch, lap, box, setup, requests, store, info) -> dict:
    """Path k over the store ``store`` (see :func:`serve_constrain`)."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    launches, server, mem = serve_path(
        torch, "constrain", ["--store", store, *CON_ARGS],
        {"paged_decode_attention": 1}, requests, _llama_3_8b_cut,
        setup=setup, **info)
    lap("boot_and_http")
    b = server.batcher
    eos = b.eos_id
    reqs, outs = box["reqs"], box["http"]["outs"]
    rid_of = {tuple(ids): rid for rid, ids, _ in box["subs"]}
    streams = {}
    facts = {}
    for (kind, body), (status, resp) in zip(reqs, outs):
        check(status == 200, f"constrain: {kind} answered {status}: {resp}")
        rid = rid_of[tuple(b.tokenizer.encode(body["prompt"]))]
        ids = box["streams"][rid]
        streams[kind] = ids
        if "response_format" in body:
            facts[kind] = _con_valid(f"constrain/{kind}", ids, body, eos)
            if not body.get("stream"):
                check(resp["choices"][0]["text"] == facts[kind]["text"],
                      f"constrain/{kind}: the served text is not the "
                      f"stream's bytes")
    check(not set(box["banned"]) & set(streams["banned"]),
          f"constrain: a banned token was emitted: {streams['banned']}")
    bufs = {n: 8 * n * b.cfg.vocab_size / 1e6 for n in b._con_bufs}
    emit("constrain_served", card=_card(), outputs=facts,
         banned=box["banned"], banned_stream_head=streams["banned"][:16],
         stack_rungs_states_mb=bufs, graph_captures=b._graphs.captures,
         graph_replays=b._graphs.replays, decode_steps=b.decode_steps,
         launches={k: v for k, v in launches.items() if v},
         peak_mem_gb=mem["peak_mem_gb"])
    check(bufs, "constrain: no constrained span ran")
    ctor = dict(b._ctor_args)

    # Free greedy streams equal the same free requests served without the
    # constrained ones (rows are independent of their slot mates).
    free = [body for kind, body in reqs if "response_format" not in body
            and "banned_tokens" not in body]
    fb = batcher_lib.ContinuousBatcher(**ctor)
    got, _, _ = _con_engine(torch, fb, [dict(r, stream=False) for r in free])
    want = streams["free_greedy"]
    check(got[0] == want, f"constrain: the free greedy stream moved next to "
          f"constrained rows, at {_first_diff(want, got[0])}")
    del fb
    _free(torch)
    lap("free_replay")

    # The constrained greedy set under the three engine loops.
    greedy = [body for kind, body in reqs
              if kind in ("object", "array", "date", "banned",
                          "free_greedy")]
    kinds = [kind for kind, _ in reqs
             if kind in ("object", "array", "date", "banned", "free_greedy")]
    graph_chunk = batcher_lib.decode_chunk
    loop_streams = {}
    for name, overlap, eager in LOOPS:
        lb = batcher_lib.ContinuousBatcher(**{**ctor, "overlap": overlap})
        if eager:
            batcher_lib.decode_chunk = _eager_decode_chunk
        try:
            got, wall, steps = _con_engine(torch, lb, greedy)
        finally:
            batcher_lib.decode_chunk = graph_chunk
        loop_streams[name] = got
        emit("constrain_loop", loop=name, decode_steps=steps,
             wall_ms=wall * 1e3, graph_captures=lb._graphs.captures,
             stack_rungs=sorted(lb._con_bufs))
        del lb
        _free(torch)
    check(loop_streams["graph_overlap"] == loop_streams["graph_sync"]
          == loop_streams["eager_sync"],
          "constrain: the constrained streams differ between the loops")
    for kind, got in zip(kinds, loop_streams["graph_overlap"]):
        check(got == streams[kind], f"constrain: the engine-side {kind} "
              f"stream differs from the served one at "
              f"{_first_diff(got, streams[kind])}")
    lap("loops")

    # int8 pages (K1q): the same set, every output valid.
    reset_launches()
    qb = batcher_lib.ContinuousBatcher(**{**ctor, "kv_bits": 8})
    q_got, q_wall, q_steps = _con_engine(torch, qb, greedy)
    q_launches = read_launches()
    del qb
    _free(torch)
    q_facts = {}
    for kind, body, got in zip(kinds, greedy, q_got):
        if "response_format" in body:
            q_facts[kind] = _con_valid(f"constrain/int8/{kind}", got, body,
                                       eos)
    check(not set(box["banned"]) & set(q_got[kinds.index("banned")]),
          "constrain/int8: a banned token was emitted")
    want = b.cfg.num_layers * q_steps
    check(q_launches["paged_decode_attention_int8"] >= want,
          f"constrain/int8: K1q launched "
          f"{q_launches['paged_decode_attention_int8']} times, under {want}")
    emit("constrain_int8", outputs=q_facts, decode_steps=q_steps,
         launches={k: v for k, v in q_launches.items() if v})
    lap("int8")

    # Path i's pool and tier: constrained rows swap out and back; their
    # streams equal the unpressured run's.
    swap_bodies = [{"prompt": _tier_text(f"swap {c}", n),
                    "max_tokens": CON_SWAP_NEW, "temperature": 0.0,
                    **CON_LONG}
                   for c, n in zip("ABCDEFGH", (300, 320, 340, 360, 380,
                                                 400, 310, 330))]
    calm_b = batcher_lib.ContinuousBatcher(**ctor)
    calm, _, _ = _con_engine(torch, calm_b, swap_bodies)
    check(calm_b.preemptions == 0, "constrain: the unpressured run preempted")
    del calm_b
    _free(torch)
    c0 = _tier_counts()
    swap_b = batcher_lib.ContinuousBatcher(**{**ctor, **CON_SWAP_ARGS})
    pressed, p_wall, p_steps = _con_engine(torch, swap_b, swap_bodies)
    counts = _tier_counts(c0)
    emit("constrain_swap", counters=counts, preemptions=swap_b.preemptions,
         decode_steps=p_steps, ms_per_decode_step=p_wall * 1e3 / p_steps,
         stack_rungs=sorted(swap_b._con_bufs))
    del swap_b
    _free(torch)
    check(counts["kv_swaps.in"] >= 1 and counts["kv_swaps.fallback"] == 0,
          f"constrain: no constrained row swapped back exactly: {counts}")
    for j, (g, w) in enumerate(zip(pressed, calm)):
        check(g == w, f"constrain: swapped stream {j} differs from the "
                      f"unpressured run's at {_first_diff(g, w)}")
        _con_valid(f"constrain/swap/{j}", g, swap_bodies[j], eos)
    lap("swap")

    emit("constrain_timed", card=_card(), **_con_timed(torch, ctor))
    lap("timed")
    del server, b
    _free(torch)

    con_crash_drill(torch, store)
    lap("crash_drill")
    con_stall_drill(torch, store)
    lap("stall_drill")
    return {"paged_decode_attention": launches["paged_decode_attention"],
            "paged_decode_attention_int8":
                q_launches["paged_decode_attention_int8"]}


def con_crash_drill(torch, store: str) -> None:
    """``--fault batcher.decode:raise@3`` on path k's flags: 10 greedy
    requests on 8 slots; the third decode dispatch raises.  The supervisor
    respawns the batcher (a fresh graph set is captured); the requests
    still queued re-admit under their rids and their streams equal an
    undisturbed run's; the ones that streamed end in the structured
    ``engine_error``.  Prints the respawn's wall time and the time to the
    first decode delivery after it (the graph recapture included)."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    args = serve_main.parser().parse_args(
        ["--store", store, *CON_ARGS, "--fault", "batcher.decode:raise@3"])
    server = serve_main.build_server(args)
    plane = server.batcher.faults
    check(plane is not None and plane.describe() == "batcher.decode:raise@3",
          "crash drill: the fault plane is not armed")
    subs, streams, marks = [], {}, {}
    old = server.batcher
    _record_con(old, subs, streams)
    factory, recover = server._batcher_factory, server._recover_engine

    def factory_rec():
        nb = factory()
        _record_con(nb, subs, streams)
        marks["respawned"] = nb
        return nb

    def recover_timed():
        marks["t_crash"] = time.perf_counter()
        recover()
        marks["t_respawned"] = time.perf_counter()

    server._batcher_factory = factory_rec
    server._recover_engine = recover_timed
    prompts = [_tier_text(f"drill {j}", 120) for j in range(CON_CRASH_REQUESTS)]

    async def run():
        await server.start()
        try:
            return await asyncio.gather(*[
                _http(server.bound_port, "/v1/completions",
                      {"prompt": p, "max_tokens": CON_CRASH_NEW,
                       "temperature": 0.0}) for p in prompts])
        finally:
            await server.stop()

    outs = asyncio.run(run())
    new = server.batcher
    check(server._restarts == 1 and new is not old
          and new is marks.get("respawned"),
          f"crash drill: {server._restarts} restart(s)")
    check(new.faults is plane and plane.rules[0].fired == 1,
          "crash drill: the respawn does not share the fired plane")
    check(new._graphs.captures >= 1, "crash drill: no graph recaptured")
    rid_of = {}
    for rid, ids, _ in subs:
        rid_of.setdefault(tuple(ids), rid)
    retried, failed = [], []
    for p, (status, resp) in zip(prompts, outs):
        if status == 200:
            retried.append(p)
        else:
            check(status == 500 and resp["error"]["type"] == "engine_error"
                  and "restarted" in resp["error"]["message"],
                  f"crash drill: a streamed request answered {status}: "
                  f"{resp}")
            failed.append(p)
    check(retried and failed, f"crash drill: {len(retried)} re-admitted, "
          f"{len(failed)} failed")
    calm = batcher_lib.ContinuousBatcher(**{**new._ctor_args,
                                            "faults": None})
    want, _, _ = _con_engine(torch, calm, [
        {"prompt": p, "max_tokens": CON_CRASH_NEW, "temperature": 0.0}
        for p in retried])
    del calm
    t_first = None
    for p, w in zip(retried, want):
        rid = rid_of[tuple(new.tokenizer.encode(p))]
        check(streams[rid] == w, f"crash drill: re-admitted rid {rid} "
              f"differs from the undisturbed run at "
              f"{_first_diff(streams[rid], w)}")
        stamps = streams[("t", rid)]
        if len(stamps) > 1:  # the first decode delivery after the respawn
            t_first = min(t_first or stamps[1], stamps[1])
    emit("constrain_crash_drill", restarts=server._restarts,
         re_admitted=len(retried), failed_streamed=len(failed),
         respawn_s=marks["t_respawned"] - marks["t_crash"],
         crash_to_first_decode_delivery_s=(
             t_first - marks["t_crash"] if t_first else "not measured"),
         graph_captures_after=new._graphs.captures)
    del server, old, new
    _free(torch)


def con_stall_drill(torch, store: str) -> None:
    """``--no-constrained --fault batcher.decode:stall@2:3
    --watchdog-timeout 1`` on path k's flags: a constrained request answers
    400; one request's second decode dispatch stalls 3 s, /healthz turns
    unhealthy (engine_stalled) while it does and healthy once the request
    completes."""
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args(
        ["--store", store, *CON_ARGS, "--no-constrained", "--fault",
         f"batcher.decode:stall@2:{CON_STALL_S:g}", "--watchdog-timeout",
         f"{CON_WATCHDOG_S:g}"])
    server = serve_main.build_server(args)

    async def health(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, rest = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), json.loads(rest)

    async def run():
        await server.start()
        port = server.bound_port
        try:
            status, resp = await _http(port, "/v1/completions", {
                "prompt": "x", "max_tokens": 4,
                "response_format": _rf(regex=CON_DATE)})
            check(status == 400 and "disabled" in resp["error"]["message"],
                  f"stall drill: --no-constrained answered {status}")
            t0 = time.perf_counter()
            req = asyncio.create_task(_http(port, "/v1/completions", {
                "prompt": "wedge the engine", "max_tokens": CON_NEW,
                "temperature": 0.0}))
            flipped = None
            while not req.done():
                code, rep = await health(port)
                if code == 503 and rep["engine_stalled"] and flipped is None:
                    flipped = time.perf_counter() - t0
                await asyncio.sleep(0.1)
            status, _ = await req
            check(status == 200, f"stall drill: the request answered {status}")
            healthy = None
            for _ in range(50):
                code, _ = await health(port)
                if code == 200:
                    healthy = time.perf_counter() - t0
                    break
                await asyncio.sleep(0.1)
            return flipped, healthy, time.perf_counter() - t0
        finally:
            await server.stop()

    flipped, healthy, wall = asyncio.run(run())
    emit("constrain_stall_drill", stall_s=CON_STALL_S,
         watchdog_timeout_s=CON_WATCHDOG_S, unhealthy_after_s=flipped,
         healthy_again_after_s=healthy, wall_s=wall,
         fired=server.batcher.faults.rules[0].fired)
    check(flipped is not None, "stall drill: /healthz never turned unhealthy")
    check(healthy is not None, "stall drill: /healthz never healthy again")
    check(server.batcher.faults.rules[0].fired == 1,
          "stall drill: the stall rule did not fire once")
    del server
    _free(torch)


# -- path l: one-shot generation, sessions and the standalone loop ------------

GEN_NEW = 64
GEN_MAX_LEN = 1024
# Path a's seven prompts (the chat messages' text as plain prompts) and one
# more: 8 ragged rows, 23-335 tokens with BOS.
GEN_PROMPTS = (
    PATH_A_PREFIX + "Case A: a pallet arrived late.",
    PATH_A_PREFIX + "Case B: a crate is dented.",
    PATH_A_PREFIX + "Case A: a pallet arrived late.",
    "Summarise policy 12 in a line.",
    "Streaming check: count to ten.",
    "Top-k sampling check.",
    "Be brief. Name three ports.",
    "Which policy covers a customs hold at the port of Rotterdam?",
)
GEN_SESSION_NEW = 32
GEN_SESSION_TURNS = (
    (PATH_A_PREFIX + "Case C: a refused delivery.", "Short question two."),
    ("Follow-up: which policy number?", "And the second?"),
    ("Thanks. One more line.", "Done."),
)
GEN_SAMPLED_TEMPERATURE = 0.8
GEN_SAMPLED_NEW = 16
GEN_WINDOW_MAX_LEN = 6144  # path c's
GEN_WINDOW_PROMPT_BYTES = 4400  # path c's long prompt: past the window
GEN_WINDOW_NEW = 32
# The near-tie rule: where a stream of the path leaves the stream it is
# held to, the step is recomputed once in float32 (a no-cache forward of
# the shared context, dense attention) and the two tokens' logits there
# must lie within this many logits of each other.  Stated before the
# first run: 3x the worst teacher-forced bf16 margin path j's speculative
# streams showed on the card (0.033); a wrong token on random weights
# lands O(1) logits below.
GEN_NEAR_TIE = 0.1


def _cut(stream, eos: int) -> list:
    """A stream up to and including its first EOS."""
    stream = [int(x) for x in stream]
    return stream[:stream.index(eos) + 1] if eos in stream else stream


def _f32_last_logits(torch, params, cfg, ids):
    """Float32 logits [V] after ``ids``: one no-cache forward, dense
    attention, each layer's weights upcast as it runs (the bf16 weights
    exactly, the arithmetic float32)."""
    import dataclasses

    from distributed_llms_tpu_torch.models import model as model_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="dot")
    dev = params["embed"]["wte"].device

    def layer(tree, i):
        return {k: (layer(v, i) if isinstance(v, dict) else v[i:i + 1].float())
                for k, v in tree.items()}

    with torch.no_grad():
        toks = torch.tensor([ids], device=dev)
        x = model_lib.embed(params, cfg32, toks)
        pos = torch.arange(len(ids), device=dev)[None]
        for i in range(cfg.num_layers):
            x = model_lib.run_blocks(x, layer(params["blocks"], i), cfg32,
                                     pos, None, None, None)[0]
        head = {"final_norm": {"scale": params["final_norm"]["scale"].float()},
                "embed": params["embed"]}
        if "lm_head" in params:
            head["lm_head"] = {"w": params["lm_head"]["w"]}
        return model_lib.unembed(head, cfg32, x[:, -1:])[0, 0]


def _near_ties(torch, label, params, cfg, contexts, got, want, eos) -> dict:
    """``got`` against ``want`` (streams after ``contexts``): identical, or
    leaving it at a near-tie — at the first differing step the float32
    logits of the two tokens within GEN_NEAR_TIE.  Returns what it
    measured."""
    gaps, first = [], []
    for ctx, g, w in zip(contexts, got, want):
        g, w = _cut(g, eos), _cut(w, eos)
        j = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y), None)
        first.append(j)
        if j is None:
            check(len(g) == len(w), f"{label}: streams of unequal length "
                  f"{len(g)} / {len(w)} agree to the shorter's end")
            continue
        lg = _f32_last_logits(torch, params, cfg, list(ctx) + g[:j])
        gap = abs(float(lg[g[j]] - lg[w[j]]))
        gaps.append(gap)
        check(gap <= GEN_NEAR_TIE,
              f"{label}: a stream leaves its reference at step {j} with a "
              f"float32 gap of {gap:.4f} logits (near-tie margin "
              f"{GEN_NEAR_TIE})")
    return {"streams": len(got),
            "identical": sum(j is None for j in first),
            "first_divergence": first, "f32_gaps": gaps,
            "near_tie_margin": GEN_NEAR_TIE}


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _batcher_streams(torch, b, id_lists, new) -> list:
    """The same prompts as token ids through batcher ``b`` (greedy, cold
    admissions): their streams in order."""
    rids = [b.submit(ids, max_new_tokens=new, prefix_cache=False)
            for ids in id_lists]
    res = b.run()
    torch.cuda.synchronize()
    return [res[r] for r in rids]


def _spill_timers(torch, sessions) -> list:
    """Time each spill and restore of ``sessions`` (a SessionManager):
    records (kind, MB, ms)."""
    log = []
    spill, restore = sessions._spill, sessions.ensure_resident

    def timed_spill(sess):
        nbytes = sum(t.nbytes for t in (sess.cache.k, sess.cache.v))
        _, dt = _sync_time(torch, lambda: spill(sess))
        log.append(("spill", nbytes / 1e6, dt * 1e3))

    def timed_restore(sess):
        if not sess.spilled:
            return restore(sess)
        sessions.make_room(keep=sess.sid)  # its spill timed on its own
        nbytes = sess.cache.nbytes
        _, dt = _sync_time(torch, lambda: restore(sess))
        log.append(("restore", nbytes / 1e6, dt * 1e3))

    sessions._spill, sessions.ensure_resident = timed_spill, timed_restore
    return log


def generate_llama(torch, card) -> dict:
    """Path l, steps 1-3 on ``llama-3-8b``'s width cut to STORE_LAYERS
    layers (bf16, max_seq_len 1024):
    ``generate_text`` against the paged batcher, sessions with host spill,
    and ``generate_text`` routed through the speculative loop.  Returns the
    launches of the path's own calls."""
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.core.observability import METRICS
    from distributed_llms_tpu_torch.runtime import speculative as spec_lib
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    lap = _lap("generate_time")
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    rt = RuntimeConfig(max_seq_len=GEN_MAX_LEN, max_decode_steps=GEN_NEW,
                       kv_host_spill=True, max_resident_sessions=1)
    torch.cuda.reset_peak_memory_stats()
    # Llama-3-8B's width at STORE_LAYERS layers since PR 17 (as paths d,
    # e, h, i, j): the smoke's time with path p.
    eng = InferenceEngine.from_preset("llama-3-8b", rt=rt, rng_seed=0,
                                      num_layers=STORE_LAYERS)
    _llama_3_8b_cut(eng.cfg)
    tok = eng.tokenizer
    ids = [tok.encode(p) for p in GEN_PROMPTS]
    lap("boot")

    # 1. generate_text against the paged batcher (path a's flags).
    eng.generate_text(list(GEN_PROMPTS), max_new_tokens=1)  # warm-up
    reset_launches()
    res, wall = _sync_time(torch, lambda: eng.generate_text(
        list(GEN_PROMPTS)))
    add(read_launches())
    _, wall1 = _sync_time(torch, lambda: eng.generate_text(
        list(GEN_PROMPTS), max_new_tokens=1))
    check(res.tokens.shape == (len(GEN_PROMPTS), GEN_NEW),
          f"generate: tokens of shape {res.tokens.shape}")
    width = eng._bucket_prompt(eng._encode_rows(list(GEN_PROMPTS), None)[0],
                               GEN_NEW).shape[1]
    b = eng.continuous_batcher(batch_slots=8, max_len=GEN_MAX_LEN,
                               paged_pages=256, page_size=64,
                               prefix_cache=True)
    want = _batcher_streams(torch, b, ids, GEN_NEW)
    del b
    _free(torch)
    held = _near_ties(torch, "generate/text_vs_batcher", eng.params, eng.cfg,
                      ids, res.tokens.tolist(), want, tok.eos_id)
    emit("generate", path="l", step="text_vs_paged_batcher", card=card,
         rows=len(ids), prompt_tokens=[len(x) for x in ids],
         padded_width=width, new_tokens=GEN_NEW, wall_ms=wall * 1e3,
         prefill_and_one_step_ms=wall1 * 1e3,
         eager_ms_per_decode_step=(wall - wall1) * 1e3 / (GEN_NEW - 1),
         tokens_per_second=res.tokens_per_second,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **held)
    lap("text")

    # 2. Sessions with host spill, against the same turns without it.
    ctl = InferenceEngine(eng.cfg, RuntimeConfig(
        max_seq_len=GEN_MAX_LEN, max_decode_steps=GEN_SESSION_NEW),
        eng.params, tokenizer=tok, device=eng.device)
    moves = _spill_timers(torch, eng.sessions)
    reset_launches()
    a_turns = []
    sid_a, r = eng.start_session(list(GEN_SESSION_TURNS[0]),
                                 max_new_tokens=GEN_SESSION_NEW)
    a_turns.append(r.tokens.tolist())
    sid_b, _ = eng.start_session(["A second conversation opens here."],
                                 max_new_tokens=GEN_SESSION_NEW)
    check(eng.sessions.get(sid_a).spilled, "sessions: opening B did not "
          "spill A")
    for turn in GEN_SESSION_TURNS[1:]:
        a_turns.append(eng.continue_session(
            sid_a, list(turn), max_new_tokens=GEN_SESSION_NEW).tokens.tolist())
        check(eng.sessions.get(sid_b).spilled and not
              eng.sessions.get(sid_a).spilled,
              "sessions: continuing A did not restore A and spill B")
    add(read_launches())
    gauges = {k: v for k, v in METRICS.snapshot()["gauges"].items()
              if k.startswith("kv_spill.")}
    counters = {k: v for k, v in METRICS.snapshot()["counters"].items()
                if k.startswith("kv_spill.")}
    c_turns = []
    cid, r = ctl.start_session(list(GEN_SESSION_TURNS[0]),
                               max_new_tokens=GEN_SESSION_NEW)
    c_turns.append(r.tokens.tolist())
    ctl.start_session(["A second conversation opens here."],
                      max_new_tokens=GEN_SESSION_NEW)
    for turn in GEN_SESSION_TURNS[1:]:
        c_turns.append(ctl.continue_session(
            cid, list(turn), max_new_tokens=GEN_SESSION_NEW).tokens.tolist())
    check(a_turns == c_turns, "sessions: a spilled-and-restored session's "
          "turns differ from the same turns without spill")
    one = eng.generate_text(list(GEN_SESSION_TURNS[0]),
                            max_new_tokens=GEN_SESSION_NEW)
    first_ids = [tok.encode(p) for p in GEN_SESSION_TURNS[0]]
    held = _near_ties(torch, "generate/session_vs_text", eng.params, eng.cfg,
                      first_ids, a_turns[0], one.tokens.tolist(), tok.eos_id)
    check([k for k, _, _ in moves] == ["spill", "spill", "restore"],
          f"sessions: spills and restores {[k for k, _, _ in moves]}, "
          "not A's spill, B's spill and A's restore")
    emit("generate", path="l", step="sessions_spill", card=card,
         turns=len(a_turns), rows=2, new_tokens=GEN_SESSION_NEW,
         turns_equal_without_spill=True,
         moves=[{"kind": k, "mb": mb, "ms": ms} for k, mb, ms in moves],
         kv_spill_gauges=gauges, kv_spill_counters=counters,
         first_turn_vs_generate_text=held)
    for sid in list(eng.sessions.sessions):
        eng.end_session(sid)
    del ctl
    _free(torch)
    lap("sessions")

    # 3. Transparent speculation: the int4 self-draft, spec_k 4.
    spec_rt = RuntimeConfig(max_seq_len=GEN_MAX_LEN, max_decode_steps=GEN_NEW,
                            spec_decode=True, spec_k=SPEC_K)
    spec = InferenceEngine(eng.cfg, spec_rt, eng.params, tokenizer=tok,
                           device=eng.device)
    wq = spec.draft_params["blocks"]["attn"]["wq"]
    check(getattr(wq, "bits", None) == 4, "generate/spec: no int4 self-draft")
    calls = []
    loop = spec_lib.speculative_generate_tokens

    def spy(*a, **kw):
        out = loop(*a, **kw)
        calls.append(out[1])
        return out

    spec_lib.speculative_generate_tokens = spy
    try:
        reset_launches()
        got, spec_wall = _sync_time(torch, lambda: spec.generate_text(
            list(GEN_PROMPTS)))
        spec_launches = read_launches()
        add(spec_launches)
        check(len(calls) == 1, "generate/spec: generate_text did not route "
              "through the speculative loop")
        stats = calls[-1]
        held = _near_ties(torch, "generate/spec_vs_text", eng.params,
                          eng.cfg, ids, got.tokens.tolist(),
                          res.tokens.tolist(), tok.eos_id)
        want_k5 = 7 * eng.cfg.num_layers * (SPEC_K + 1) * stats["rounds"]
        check(spec_launches["quant_matmul_int4"] >= want_k5,
              f"generate/spec: K5 int4 launched "
              f"{spec_launches['quant_matmul_int4']} times, under {want_k5}")
        sampled = InferenceEngine(eng.cfg, RuntimeConfig(
            max_seq_len=GEN_MAX_LEN, temperature=GEN_SAMPLED_TEMPERATURE),
            eng.params, tokenizer=tok, device=eng.device)
        sampled.attach_draft(spec.draft_cfg, spec.draft_params)
        s_res = sampled.generate_text_speculative(
            list(GEN_PROMPTS), max_new_tokens=GEN_SAMPLED_NEW, k=SPEC_K,
            seed=7)
        s_stats = calls[-1]
    finally:
        spec_lib.speculative_generate_tokens = loop
    check(bool(((s_res.tokens >= 0) & (s_res.tokens < eng.cfg.vocab_size))
               .all()), "generate/spec: a sampled token out of range")
    check(0 <= s_stats["accepted"] <= s_stats["drafted"],
          f"generate/spec: sampled stats {s_stats}")
    emit("generate", path="l", step="spec_routed", card=card, k=SPEC_K,
         stats=stats, acceptance=stats["accepted"] / max(stats["drafted"], 1),
         wall_ms=spec_wall * 1e3, plain_wall_ms=wall * 1e3,
         ms_per_position=spec_wall * 1e3 / GEN_NEW,
         plain_ms_per_position=wall * 1e3 / GEN_NEW,
         k5_int4_launches=spec_launches["quant_matmul_int4"],
         k5_int4_floor=want_k5, sampled_stats=s_stats,
         sampled_temperature=GEN_SAMPLED_TEMPERATURE,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **held)
    del spec, sampled, eng, res, got
    _free(torch)
    lap("spec")
    return launches


def generate_mistral(torch, card) -> dict:
    """Path l, step 4 on ``mistral-7b`` with ``attn_impl="flash"``: a long
    prompt beside three short ones through ``generate_text`` (K4 prefill,
    the gapped windowed decode) against the contiguous batcher, then a
    session on the long prompt against ``generate_tokens`` over the whole
    history.  Returns the launches of the path's own calls."""
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime import generate as gen_lib
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    lap = _lap("generate_time")
    rt = RuntimeConfig(max_seq_len=GEN_WINDOW_MAX_LEN,
                       max_decode_steps=GEN_WINDOW_NEW)
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine.from_preset("mistral-7b", rt=rt, rng_seed=0,
                                      attn_impl="flash")
    _mistral_7b_flash(eng.cfg)
    tok = eng.tokenizer
    long_prompt = ("Freight log, dock 7, one line per pallet: " + "".join(
        f"pallet {i:04d} checked in at bay {i % 13:02d}; "
        for i in range(200)))[:GEN_WINDOW_PROMPT_BYTES]
    prompts = [long_prompt, "Short check one: name a colour.",
               "Short check two: count to five.", "Short check three."]
    ids = [tok.encode(p) for p in prompts]
    lap("boot")
    eng.generate_text(prompts, max_new_tokens=1)  # warm-up
    reset_launches()
    res, wall = _sync_time(torch, lambda: eng.generate_text(prompts))
    launches = read_launches()
    _, wall1 = _sync_time(torch, lambda: eng.generate_text(
        prompts, max_new_tokens=1))
    check(launches["flash_attention_dynamic"] >= eng.cfg.num_layers,
          f"generate/flash: K4 launched "
          f"{launches['flash_attention_dynamic']} times, under "
          f"{eng.cfg.num_layers}")
    width = eng._bucket_prompt(eng._encode_rows(prompts, None)[0],
                               GEN_WINDOW_NEW).shape[1]
    b = eng.continuous_batcher(batch_slots=8, max_len=GEN_WINDOW_MAX_LEN)
    check(not b.paged, "generate/flash: the batcher is not contiguous")
    want = _batcher_streams(torch, b, ids, GEN_WINDOW_NEW)
    del b
    _free(torch)
    held = _near_ties(torch, "generate/flash_vs_batcher", eng.params,
                      eng.cfg, ids, res.tokens.tolist(), want, tok.eos_id)
    emit("generate", path="l", step="flash_window_text_vs_contiguous_batcher",
         card=card, prompt_tokens=[len(x) for x in ids], padded_width=width,
         new_tokens=GEN_WINDOW_NEW, wall_ms=wall * 1e3,
         prefill_and_one_step_ms=wall1 * 1e3,
         eager_ms_per_decode_step=(wall - wall1) * 1e3 / (GEN_WINDOW_NEW - 1),
         k4_launches=launches["flash_attention_dynamic"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **held)
    lap("text")

    # A session on the long prompt; its second turn against one-shot
    # generate_tokens over the token history.
    reset_launches()
    sid, r1 = eng.start_session([long_prompt])
    turn2 = "Which bay held pallet 0042, and when did it check in?"
    r2 = eng.continue_session(sid, [turn2])
    add_launches = read_launches()
    for k, v in add_launches.items():
        launches[k] += v
    history = ids[0] + r1.tokens[0].tolist() + tok.encode(turn2)
    check(len(history) + GEN_WINDOW_NEW > WINDOW,
          "generate/session: the history does not cross the window")
    one = gen_lib.generate_tokens(
        eng.params, eng.cfg, torch.tensor([history], device=eng.device),
        torch.tensor([len(history)], device=eng.device), None,
        max_new_tokens=GEN_WINDOW_NEW, eos_id=tok.eos_id, pad_id=tok.pad_id,
        make_cache=eng._make_cache)
    held2 = _near_ties(torch, "generate/session_vs_oneshot", eng.params,
                       eng.cfg, [history], [r2.tokens[0].tolist()],
                       one.cpu().tolist(), tok.eos_id)
    emit("generate", path="l", step="flash_window_session_vs_oneshot",
         card=card, history_tokens=len(history), window=WINDOW,
         session_launches={k: v for k, v in add_launches.items() if v},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **held2)
    eng.end_session(sid)
    del eng, res
    _free(torch)
    lap("session")
    return launches


def serve_generate(torch) -> dict:
    """Path l: the engine's batch API as the worker calls it.  Returns the
    launches of the path's own calls (the comparison batchers' apart)."""
    card = _card()
    got = generate_llama(torch, card)
    for k, v in generate_mistral(torch, card).items():
        got[k] = got.get(k, 0) + v
    return got


# -- path m: the gpt2, opt and neox families and Mixtral-style MoE ------------

FAM_NEW = 32
FAM_MAX_LEN = 2048  # Pythia-6.9B's and OPT-125M's published context
# Path a's seven prompts and one more, greedy (path l's rows).
FAM_PROMPTS = GEN_PROMPTS
PYTHIA_PRESET = "pythia-6.9b"
OPT_PRESET = "opt-125m"
GPT2_PRESET = "gpt2-125m"
MIXTRAL_PRESET = "mixtral-8x7b"
_FAM_PAGED = ["--page-size", "64", "--prefix-cache", "--max-len",
              str(FAM_MAX_LEN), *_COMMON_ARGS]
PYTHIA_ARGS = ["--preset", PYTHIA_PRESET, "--paged-pages", "256",
               *_FAM_PAGED]
OPT_ARGS = ["--preset", OPT_PRESET, "--paged-pages", "256", *_FAM_PAGED]
OPT_STORE_ARGS = ["--override", "runtime.serve_quantized=true",
                  "--paged-pages", "256", *_FAM_PAGED]
# Mixtral-8x7B as an int4 store: 128 pages of 64 slots x MIXTRAL_LAYERS
# layers x 8 KV heads x 128 x 2 (K, V) x 2 bytes (2 MiB a page at 8).
MIXTRAL_ARGS = ["--override", "runtime.serve_quantized=true",
                "--paged-pages", "128", *_FAM_PAGED]
# Depth cut from the published 32 layers (a 24.8 GB int4 store) to 8 since
# PR 17, as paths d, e, h, i and j: the smoke's time with path p.
MIXTRAL_LAYERS = STORE_LAYERS
MIXTRAL_TRAIN_LAYERS = 2  # AdamW state of 32 layers (47 B params) won't fit
MIXTRAL_TRAIN_TOKENS = 1025  # a [1, 1025] batch: 1024 positions through K3
MIXTRAL_TRAIN_LR = 1e-3
# The near-tie rule of path l (GEN_NEAR_TIE), against path m's oracle: the
# port's own uncached float32 forward of the same weights on the card
# (dense attention, each layer upcast or dequantized to float32 as it
# runs: no kernel), teacher-forced on the stream.  A stream equals the
# oracle's greedy choice at every position, or leaves it first where the
# oracle's logits of the two tokens lie within FAM_NEAR_TIE; past that
# step the two are no longer comparable.
FAM_NEAR_TIE = GEN_NEAR_TIE


def _pythia(cfg) -> None:
    check(cfg.family == "neox" and cfg.hidden_size == 4096
          and cfg.num_layers == 32 and cfg.num_heads == cfg.num_kv_heads == 32
          and cfg.head_dim_ == 128 and cfg.rotary_pct == 0.25
          and cfg.parallel_residual and cfg.activation == "gelu_exact"
          and cfg.vocab_size == 50432, "not the full-width pythia-6.9b")


def _opt_125m(cfg) -> None:
    check(cfg.family == "opt" and cfg.hidden_size == 768
          and cfg.num_layers == 12 and cfg.num_heads == cfg.num_kv_heads == 12
          and cfg.head_dim_ == 64 and cfg.activation == "relu"
          and cfg.tie_embeddings and cfg.intermediate_size == 3072,
          "not the full-width opt-125m")


def _gpt2_125m(cfg) -> None:
    check(cfg.family == "gpt2" and cfg.hidden_size == 768
          and cfg.num_layers == 12 and cfg.activation == "gelu"
          and cfg.vocab_size == 50257, "not the full-width gpt2-125m")


def _mixtral(cfg) -> None:
    check(cfg.family == "llama" and cfg.hidden_size == 4096
          and cfg.num_heads == 32 and cfg.num_kv_heads == 8
          and cfg.num_experts == 8 and cfg.num_experts_per_token == 2
          and cfg.intermediate_size == 14336 and cfg.vocab_size == 32000,
          "not Mixtral-8x7B's width")


def _f32_leaf(torch, v):
    from distributed_llms_tpu_torch.checkpoint.quantize import (
        QuantizedTensor, dequantize)

    return (dequantize(v, torch.float32) if isinstance(v, QuantizedTensor)
            else v.float())


def oracle_logits(torch, params, cfg, seqs) -> list:
    """The oracle's float32 logits of each teacher-forced sequence: one
    uncached forward, dense attention, the weights upcast (or dequantized)
    to float32 one layer at a time, every sequence through a layer before
    the next layer is built.  ``seqs``: dicts with ``ids``, ``pos`` (RoPE
    or table positions), ``rows`` (the rows whose logits are returned),
    and, for an MoE model, ``mask`` ([L, L] bool), ``block`` (the rows of
    the served admission, routed together) and ``routes``: for each layer
    and each part (the block, then the decode tokens) the served pass's
    expert choices (``moe_route``'s claim order) and whether each claim
    kept its place.  The oracle routes by them — its gates from its own
    float32 logits, a claim the served pass dropped contributes nothing
    — while ``routing`` (a dict) collects where its own top-k would have
    chosen otherwise and by how many float32 router logits.  Returns
    [rows, V] float32 tensors."""
    import dataclasses

    from distributed_llms_tpu_torch.models import layers
    from distributed_llms_tpu_torch.models import model as model_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="dot")
    dev = params["embed"]["wte"].device
    moe, route = layers.moe_swiglu, layers.moe_route

    def replay(eid, keep, routing):
        def forced(logits, c, cap):
            k, e = c.num_experts_per_token, c.num_experts
            topi = eid.reshape(k, -1).T
            own = torch.sort(logits, dim=-1, descending=True,
                             stable=True)[1][:, :k]
            gap = (logits.gather(1, own) - logits.gather(1, topi)).amax(1)
            routing["claims"] += eid.numel()
            routing["rows_routed_otherwise"] += int((own != topi).any(1).sum())
            routing["max_f32_gap"] = max(routing["max_f32_gap"],
                                         float(gap.max()))
            oh = torch.nn.functional.one_hot(eid, e).float()
            pos = ((oh.cumsum(dim=0) - 1.0) * oh).sum(dim=-1)
            slot = torch.where(keep, eid * cap + pos.long(), e * cap)
            return (torch.softmax(logits.gather(1, topi), dim=-1), eid, oh,
                    keep, slot)
        return forced

    def split_moe(sq, layer_of):
        block = sq["block"]
        # Capacity s: a row claims an expert at most once, so every
        # claim finds a place and only the replayed drops apply.
        lossless = dataclasses.replace(
            cfg32, moe_capacity_factor=cfg.num_experts
            / cfg.num_experts_per_token)

        def run(x, p, c):
            parts = []
            for i, part in enumerate((x[:, :block], x[:, block:])):
                layers.moe_route = replay(*sq["routes"][layer_of[0]][i],
                                          sq["routing"])
                try:
                    parts.append(moe(part, p, lossless)[0])
                finally:
                    layers.moe_route = route
            layer_of[0] += 1
            return torch.cat(parts, dim=1), torch.zeros((), device=x.device)
        return run

    def layer(tree, i):
        return {k: (layer(v, i) if isinstance(v, dict)
                    else _f32_leaf(torch, v[i:i + 1]))
                for k, v in tree.items()}

    emb = {"embed": {k: v.float() for k, v in params["embed"].items()}}
    with torch.no_grad():
        ins = []
        for sq in seqs:
            pos = torch.tensor([sq["pos"]], device=dev)
            mask = (None if sq.get("mask") is None
                    else sq["mask"].to(dev)[None, None])
            ins.append((pos, mask))
        xs = [model_lib.embed(emb, cfg32, torch.tensor([sq["ids"]],
                                                       device=dev), pos)
              for sq, (pos, _) in zip(seqs, ins)]
        runs = [split_moe(sq, [0]) if sq.get("block") else moe for sq in seqs]
        try:
            for i in range(cfg.num_layers):
                lp = layer(params["blocks"], i)
                for n, (pos, mask) in enumerate(ins):
                    layers.moe_swiglu = runs[n]
                    xs[n] = model_lib.run_blocks(xs[n], lp, cfg32, pos, None,
                                                 None, None, mask)[0]
                del lp
        finally:
            layers.moe_swiglu, layers.moe_route = moe, route
        head = {"final_norm": {k: v.float()
                               for k, v in params["final_norm"].items()},
                "embed": emb["embed"]}
        if "lm_head" in params:
            head["lm_head"] = {"w": _f32_leaf(torch, params["lm_head"]["w"])}
        return [model_lib.unembed(head, cfg32,
                                  x[:, torch.tensor(sq["rows"], device=dev)])[0]
                for sq, x in zip(seqs, xs)]


def _teacher_forced(ctx, stream) -> dict:
    """The oracle's sequence for ``stream`` after ``ctx``: the context
    and every stream token but the last, standard positions."""
    ids = list(ctx) + list(stream[:-1])
    return {"ids": ids, "pos": list(range(len(ids))),
            "rows": list(range(len(ctx) - 1, len(ids)))}


def _admission_seq(torch, ctx, stream, width, pad_id) -> dict:
    """The oracle's sequence for an MoE stream of a batch (a cold
    admission, every row admitted before the first decode step): the
    admission prefilled ``ctx`` padded with ``pad_id`` to ``width``
    (positions 0..width-1, routed together: the pads claim capacity),
    then each stream token at position len(ctx) + j attending the real
    prompt and the tokens before it (its steps routed beside the other
    rows: the served drops are replayed, see :func:`oracle_logits`)."""
    t, n = len(ctx), len(stream)
    ids = list(ctx) + [pad_id] * (width - t) + list(stream[:-1])
    pos = list(range(width)) + [t + j for j in range(n - 1)]
    size = len(ids)
    i = torch.arange(size)[:, None]
    j = torch.arange(size)[None, :]
    mask = (j <= i) & ((i < width) | (j < t) | (j >= width))
    return {"ids": ids, "pos": pos, "mask": mask, "block": width,
            "rows": [t - 1] + [width + j for j in range(n - 1)]}


def _held_to_oracle(label, logits, streams, eos, vocab, new) -> dict:
    """Each stream against its oracle's logits (rows predicting its
    tokens): tokens in the vocabulary, ``new`` of them unless an EOS ends
    the stream (a live prefix), equal to the oracle's greedy choice or
    leaving it first at a near-tie.  Returns what it measured."""
    gaps, first = [], []
    for lg, stream in zip(logits, streams):
        raw = [int(x) for x in stream]
        st = _cut(raw, eos)
        check(all(0 <= x < vocab for x in st),
              f"{label}: a token outside the vocabulary")
        check(len(st) == new or st[-1] == eos,
              f"{label}: a stream of {len(st)}/{new} tokens without EOS")
        pred = lg[:len(st)].argmax(dim=-1).tolist()
        j = next((i for i, (a, b) in enumerate(zip(pred, st)) if a != b),
                 None)
        first.append(j)
        if j is None:
            continue
        gap = float(lg[j, pred[j]] - lg[j, st[j]])
        gaps.append(gap)
        check(gap <= FAM_NEAR_TIE,
              f"{label}: a stream leaves its float32 oracle at step {j} "
              f"with a gap of {gap:.4f} logits (near-tie margin "
              f"{FAM_NEAR_TIE})")
    return {"streams": len(streams),
            "equal_to_oracle": sum(j is None for j in first),
            "first_divergence": first, "f32_gaps": gaps,
            "near_tie_margin": FAM_NEAR_TIE}


def _hold_streams(torch, label, params, cfg, ctxs, streams_by_leg, eos,
                  card, **info) -> None:
    """Every leg's greedy streams after ``ctxs`` held to the oracle (one
    teacher-forced forward a stream, the legs' sequences batched through
    each layer together)."""
    legs = list(streams_by_leg)
    seqs = [_teacher_forced(c, _cut(s, eos)) for leg in legs
            for c, s in zip(ctxs, streams_by_leg[leg])]
    (logits, dt) = _sync_time(torch, lambda: oracle_logits(
        torch, params, cfg, seqs))
    n = len(ctxs)
    for k, leg in enumerate(legs):
        held = _held_to_oracle(f"{label}/{leg}", logits[k * n:(k + 1) * n],
                               streams_by_leg[leg], eos, cfg.vocab_size,
                               FAM_NEW)
        emit("families", path="m", model=label, leg=leg, card=card,
             new_tokens=FAM_NEW, oracle_s=dt, **info, **held)


def _engine_over(torch, b, **rt):
    """An engine over a served batcher's weights (no copy)."""
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine(b.cfg, RuntimeConfig(
        max_seq_len=FAM_MAX_LEN, max_decode_steps=FAM_NEW, **rt), b.params,
        tokenizer=b.tokenizer, device=b.device)


def _paged_streams(torch, eng, ids, kv_bits=16, slots=8, pages=256,
                   new=FAM_NEW, prefix_cache=True) -> tuple:
    """Greedy streams of ``ids`` through a fresh paged batcher on
    ``eng``: (streams, launches, decode steps, wall s)."""
    b = eng.continuous_batcher(batch_slots=slots, max_len=FAM_MAX_LEN,
                               paged_pages=pages, page_size=64,
                               prefix_cache=prefix_cache, kv_bits=kv_bits)
    reset_launches()
    streams, wall = _sync_time(torch, lambda: _batcher_streams(
        torch, b, ids, new))
    out = (streams, read_launches(), b.decode_steps, wall)
    del b
    _free(torch)
    return out


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def families_pythia(torch, card, lap) -> dict:
    """Pythia-6.9B: path a's requests over HTTP (K1); engine-side the
    greedy prompts through the paged batcher with bf16 and int8 pages
    (K1q) and through ``generate_text``, every stream held to the
    oracle."""
    launches, server, mem = serve_path(
        torch, "pythia", PYTHIA_ARGS, {"paged_decode_attention": 1},
        _serve_requests, _pythia)
    check(server.batcher.prefix_cache.hits > 0, "pythia: no prefix-cache hit")
    out = {"paged_decode_attention": launches["paged_decode_attention"]}
    eng = _engine_over(torch, server.batcher)
    del server
    _free(torch)
    lap("pythia_http")
    tok = eng.tokenizer
    ids = [tok.encode(p) for p in FAM_PROMPTS]
    streams = {}
    for leg, bits, kernel in (("paged_bf16", 16, "paged_decode_attention"),
                              ("paged_int8", 8,
                               "paged_decode_attention_int8")):
        streams[leg], got, steps, wall = _paged_streams(torch, eng, ids, bits)
        want = eng.cfg.num_layers * steps
        check(got[kernel] >= want, f"pythia/{leg}: {kernel} launched "
              f"{got[kernel]} times, under {want}")
        _add(out, {kernel: got[kernel]})
        emit("families", path="m", model="pythia", leg=leg, card=card,
             decode_steps=steps, wall_s=wall, launches=got)
    reset_launches()
    res, wall = _sync_time(torch, lambda: eng.generate_text(
        list(FAM_PROMPTS), max_new_tokens=FAM_NEW))
    streams["generate_text"] = res.tokens.tolist()
    emit("families", path="m", model="pythia", leg="generate_text",
         card=card, wall_s=wall, launches=read_launches(),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    lap("pythia_engine")
    _hold_streams(torch, "pythia", eng.params, eng.cfg, ids, streams,
                  tok.eos_id, card, **mem)
    del eng
    _free(torch)
    lap("pythia_oracle")
    return out


def families_opt(torch, card, lap) -> dict:
    """OPT-125M over HTTP in bf16 (K1) and as an int8 store served
    quantized (K5 at 768/3072 with biases, K1); engine-side its greedy
    streams, ``generate_text`` with a prompt that runs to the end of the
    2048-slot table, and gpt2-125m's ``generate_text``, each held to the
    oracle."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    out = {}
    launches, server, _ = serve_path(
        torch, "opt", OPT_ARGS, {"paged_decode_attention": 1},
        _serve_requests, _opt_125m)
    _add(out, {"paged_decode_attention": launches["paged_decode_attention"]})
    eng = _engine_over(torch, server.batcher)
    del server
    _free(torch)
    tok = eng.tokenizer
    ids = [tok.encode(p) for p in FAM_PROMPTS]
    streams = {"paged_bf16": _paged_streams(torch, eng, ids)[0]}
    # A prompt that, with its FAM_NEW tokens, fills the 2048-slot table
    # (positions up to 2046 fed: table rows 2 + 2046 of OPT's 2050).
    long_prompt = (PATH_A_PREFIX * 8)[:FAM_MAX_LEN - FAM_NEW - 1]
    gen_prompts = [long_prompt, FAM_PROMPTS[3]]
    res = eng.generate_text(gen_prompts, max_new_tokens=FAM_NEW)
    gen_ids = [tok.encode(p) for p in gen_prompts]
    check(len(gen_ids[0]) + FAM_NEW == FAM_MAX_LEN,
          f"opt: the long prompt has {len(gen_ids[0])} tokens")
    _hold_streams(torch, "opt", eng.params, eng.cfg, ids, streams,
                  tok.eos_id, card)
    _hold_streams(torch, "opt", eng.params, eng.cfg, gen_ids,
                  {"generate_text_to_table_end": res.tokens.tolist()},
                  tok.eos_id, card, prompt_tokens=[len(x) for x in gen_ids])
    del eng
    _free(torch)
    lap("opt_bf16")

    tmp = tempfile.mkdtemp(prefix="dlt_store_opt_")
    try:
        info = write_store(torch, "int8", tmp, OPT_PRESET)
        launches, server, _ = serve_path(
            torch, "opt_store_int8", ["--store", tmp, *OPT_STORE_ARGS],
            {"quant_matmul": 6, "paged_decode_attention": 1},
            _serve_requests, _opt_125m, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for group in ("attn", "mlp"):
        for name, leaf in server.batcher.params["blocks"][group].items():
            want = name.startswith("w")
            check(isinstance(leaf, QuantizedTensor) == want,
                  f"opt_store_int8: {group}.{name} quantized: "
                  f"{isinstance(leaf, QuantizedTensor)}")
    _add(out, {k: launches[k] for k in ("quant_matmul",
                                        "paged_decode_attention")})
    eng = _engine_over(torch, server.batcher)
    del server
    _free(torch)
    streams, got, steps, _ = _paged_streams(torch, eng, ids)
    check(got["quant_matmul"] >= 6 * eng.cfg.num_layers * steps,
          f"opt_store_int8: K5 launched {got['quant_matmul']} times")
    _hold_streams(torch, "opt_store_int8", eng.params, eng.cfg, ids,
                  {"paged_int8_weights": streams}, tok.eos_id, card)
    del eng
    _free(torch)
    lap("opt_store")

    eng = InferenceEngine.from_preset(GPT2_PRESET, rt=RuntimeConfig(
        max_seq_len=1024, max_decode_steps=FAM_NEW), rng_seed=0,
        device="cuda")
    _gpt2_125m(eng.cfg)
    res = eng.generate_text(list(FAM_PROMPTS), max_new_tokens=FAM_NEW)
    _hold_streams(torch, "gpt2", eng.params, eng.cfg, ids,
                  {"generate_text": res.tokens.tolist()}, tok.eos_id, card)
    del eng
    _free(torch)
    lap("gpt2")
    return out


def mixtral_int4_params(torch, cfg) -> dict:
    """Mixtral-shaped random weights drawn on the card from seed 0 (as
    ``init_params`` draws them) and quantized to int4 one layer at a time:
    the bf16 model (93 GB) never exists at once.  Returns the tree with
    ``QuantizedTensor`` block leaves, ready for ``save_shards``."""
    from distributed_llms_tpu_torch.checkpoint import quantize as quant_lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KVH, HD, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                     cfg.num_experts)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda")
        return (w * fan_in ** -0.5).to(torch.bfloat16)

    def stacked(shape, fan_in, path):
        _, pack = quant_lib.leaf_plan(path, torch.empty(shape,
                                                        device="meta"))
        per = [quant_lib.quantize(dense(shape, fan_in), bits=4,
                                  pack_axis=pack) for _ in range(L)]
        return quant_lib.QuantizedTensor(
            data=torch.stack([q.data for q in per]),
            scale=torch.stack([q.scale for q in per]), bits=4,
            orig_shape=(L, *shape), pack_axis=pack)

    ones = torch.ones((L, D), dtype=torch.bfloat16, device="cuda")
    return {
        "embed": {"wte": dense((cfg.vocab_size, D), D)},
        "final_norm": {"scale": ones[0].clone()},
        "lm_head": {"w": dense((D, cfg.vocab_size), D)},
        "blocks": {
            "ln1": {"scale": ones}, "ln2": {"scale": ones.clone()},
            "attn": {"wq": stacked((D, H, HD), D, "wq"),
                     "wk": stacked((D, KVH, HD), D, "wk"),
                     "wv": stacked((D, KVH, HD), D, "wv"),
                     "wo": stacked((H, HD, D), H * HD, "wo")},
            "mlp": {"router": stacked((D, E), D, "router"),
                    "w_gate": stacked((E, D, F), D, "w_gate"),
                    "w_up": stacked((E, D, F), D, "w_up"),
                    "w_down": stacked((E, F, D), F, "w_down")},
        },
    }


def _rehydrate_ms(torch, mlp, pairs_on_experts: bool = False) -> float:
    """CUDA-event ms of one layer's expert rehydration (router and the
    three expert stacks dequantized to bf16), as ``moe_swiglu`` does it.
    ``pairs_on_experts``: the stacks' int4 pairs moved onto the expert
    axis first, the layout a load that repacks them as projections gives
    them (the engine's load keeps an MoE block's pairs where they are)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import dequantize_tree
    from distributed_llms_tpu_torch.ops.quant_matmul import repack_legacy_int4

    layer0 = {k: v[0] for k, v in mlp.items()}
    if pairs_on_experts:
        layer0 = {k: v if k == "router" else repack_legacy_int4(v, 1)
                  for k, v in layer0.items()}
    return cuda_ms(torch, lambda: dequantize_tree(layer0, torch.bfloat16),
                   iters=5, warmup=1)


def _mixtral_batch(torch, eng, ids, record=None, mem=None) -> tuple:
    """``ids`` as one greedy batch (cold admissions, every row admitted
    before the first decode step, the synchronous loop) on a paged
    batcher of one slot a prompt over ``eng``'s weights: (streams,
    launches, decode steps, graph replays).  With ``record`` (a list)
    the eager chunk runs, and every ``moe_route`` call appends its
    expert choices and kept claims; ``mem`` (a list) gets the device
    bytes allocated once the batcher is built."""
    from distributed_llms_tpu_torch.models import layers
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    route, graph_chunk = layers.moe_route, batcher_lib.decode_chunk

    def recorded(logits, cfg, cap):
        out = route(logits, cfg, cap)
        record.append((out[1].clone(), out[3].clone()))
        return out

    b = eng.continuous_batcher(**_mixtral_batcher_kw(ids))
    if mem is not None:
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    try:
        if record is not None:
            layers.moe_route = recorded
            batcher_lib.decode_chunk = _eager_decode_chunk
        reset_launches()
        streams = _batcher_streams(torch, b, ids, FAM_NEW)
        out = (streams, read_launches(), b.decode_steps, b._graphs.replays)
    finally:
        layers.moe_route, batcher_lib.decode_chunk = route, graph_chunk
    del b
    _free(torch)
    return out


def _mixtral_batcher_kw(ids) -> dict:
    """The batcher of Mixtral's 8-row batch (paths m and s): one slot a
    prompt, path m's pool, the synchronous loop."""
    return dict(batch_slots=len(ids), max_len=FAM_MAX_LEN, paged_pages=128,
                page_size=64, prefix_cache=True, overlap=False)


def _batch_routes(torch, calls, cuts, widths, n_layers, k) -> tuple:
    """The recorded routing of an eager :func:`_mixtral_batch` split by
    row: (each row's ``routes`` for the oracle — a layer's (choices,
    kept) of its admission, then of the decode steps that made its
    tokens — and the kept claims and claims of every decode step).  The
    calls come as the batcher made them: each row's admission (a layer
    a call, ``k * width`` claims), then each step's layers (``k * rows``
    claims, choice-major)."""
    rows = len(cuts)
    adm = rows * n_layers
    dec = calls[adm:]
    steps = len(dec) // n_layers
    check(all(calls[r * n_layers + i][0].numel() == k * widths[r]
              for r in range(rows) for i in range(n_layers))
          and len(dec) == steps * n_layers
          and all(e.numel() == k * rows for e, _ in dec)
          and steps >= max(len(c) for c in cuts) - 1,
          f"mixtral/batch: {len(calls)} routing calls do not split into "
          f"{rows} admissions of {n_layers} layers and the decode steps")
    kept_all = torch.stack([kp for _, kp in dec])
    drops = (int(kept_all.sum()), kept_all.numel())
    routes = []
    for r, cut in enumerate(cuts):
        n = len(cut) - 1  # the decode steps that made tokens 1..n

        def tail(i, part):
            got = [dec[j * n_layers + i][part].reshape(k, rows)[:, r]
                   for j in range(n)]
            return torch.stack(got, dim=1).reshape(-1)
        routes.append([(calls[r * n_layers + i], (tail(i, 0), tail(i, 1)))
                       for i in range(n_layers)])
    return routes, drops


def _write_mixtral(torch, out_dir: str) -> dict:
    """Paths m and s's store: Mixtral-8x7B's width cut to MIXTRAL_LAYERS
    layers, int4 (experts, router and attention), drawn and quantized on
    the card a layer at a time.  Returns what it cost."""
    from distributed_llms_tpu_torch.checkpoint.store import save_shards
    from distributed_llms_tpu_torch.models.presets import get_preset

    cfg = get_preset(MIXTRAL_PRESET, num_layers=MIXTRAL_LAYERS)
    _mixtral(cfg)
    free_disk = shutil.disk_usage(_shared_dir()).free
    torch.cuda.reset_peak_memory_stats()
    params, quant_s = _sync_time(torch, lambda: mixtral_int4_params(
        torch, cfg))
    t0 = time.perf_counter()
    save_shards(params, out_dir, num_shards=2, model_config=cfg,
                quantization="int4", storage="raw")
    write_s = time.perf_counter() - t0
    del params
    _free(torch)
    return {"store_bytes": sum(p.stat().st_size
                               for p in Path(out_dir).iterdir()),
            "draw_and_quantize_s": quant_s, "write_s": write_s,
            "disk_free_before_bytes": free_disk,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _expert_bytes(mlp) -> int:
    """Device bytes of an MoE block's expert stacks (codes and scales)."""
    return sum(mlp[k].data.nbytes + mlp[k].scale.nbytes
               for k in ("w_gate", "w_up", "w_down"))


def families_mixtral(torch, card, lap) -> dict:
    """Mixtral-8x7B as an int4 store (written layer by layer) on one
    engine, served quantized (the attention through K5, decode through K1,
    the experts rehydrated per layer; path s serves it over HTTP on its
    expert mesh).  The 8 greedy prompts as one batch at 8 slots (decode
    drops claims): through the eager chunk with every routing decision
    recorded — the share of claims the decode steps dropped, and each
    stream held to the oracle replaying that routing — then through the
    captured chunk graph under the profiler, whose streams must equal the
    eager ones.  What path s holds its expert mesh against stays in
    ``_SHARED["mixtral"]``."""
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    store, info, wrote = shared_store(torch, "mixtral_int4", _write_mixtral)
    emit("families", path="m", model="mixtral", step="store", card=card,
         num_layers=MIXTRAL_LAYERS, written_here=wrote, **info)
    lap("mixtral_store")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = InferenceEngine.from_store(store, rt=RuntimeConfig(
        serve_quantized=True, max_seq_len=FAM_MAX_LEN,
        max_decode_steps=FAM_NEW))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    _mixtral(eng.cfg)
    mlp = eng.params["blocks"]["mlp"]
    check(all(mlp[k].bits == 4 and mlp[k].data.dim() == 4
              for k in ("w_gate", "w_up", "w_down")),
          "mixtral_int4: the expert stacks are not int4-resident")
    out = {"quant_matmul_int4": 0, "paged_decode_attention": 0}
    lap("mixtral_boot")

    tok = eng.tokenizer
    n_layers, k = eng.cfg.num_layers, eng.cfg.num_experts_per_token
    ids = [tok.encode(p) for p in FAM_PROMPTS]
    calls, mem = [], []
    (eager, got, steps, replays), wall = _sync_time(
        torch, lambda: _mixtral_batch(torch, eng, ids, calls, mem))
    check(replays == 0, f"mixtral/batch_eager: {replays} graph replays")
    _add(out, {name: got[name] for name in out})
    shared = {"store": store, "ids": ids, "eager": eager,
              "routes": [(e.cpu(), kp.cpu()) for e, kp in calls],
              "engine_and_batcher_bytes": mem[0] - held,
              "expert_bytes": _expert_bytes(mlp), "boot_s": boot_s}
    cuts = [_cut(st, tok.eos_id) for st in eager]
    widths = [min(batcher_lib._bucket(len(c)), FAM_MAX_LEN) for c in ids]
    routes, (kept, claims) = _batch_routes(torch, calls, cuts, widths,
                                           n_layers, k)
    del calls
    seqs = []
    for ctx, cut, w, rt in zip(ids, cuts, widths, routes):
        sq = _admission_seq(torch, ctx, cut, w, tok.pad_id)
        sq["routes"] = rt
        sq["routing"] = {"claims": 0, "rows_routed_otherwise": 0,
                         "max_f32_gap": 0.0}
        seqs.append(sq)
    logits, dt = _sync_time(torch, lambda: oracle_logits(
        torch, eng.params, eng.cfg, seqs))
    routing = {key: sum(sq["routing"][key] for sq in seqs)
               for key in ("claims", "rows_routed_otherwise")}
    routing["max_f32_gap"] = max(sq["routing"]["max_f32_gap"]
                                 for sq in seqs)
    check(routing["max_f32_gap"] <= FAM_NEAR_TIE,
          f"mixtral/batch_eager: a served expert choice is "
          f"{routing['max_f32_gap']:.4f} float32 router logits below "
          f"the oracle's (near-tie margin {FAM_NEAR_TIE})")
    held = _held_to_oracle("mixtral/batch_eager", logits, eager, tok.eos_id,
                           eng.cfg.vocab_size, FAM_NEW)
    emit("families", path="m", model="mixtral", leg="batch8_eager",
         card=card, rows=len(ids), admission_widths=widths,
         decode_steps=steps, wall_s=wall, decode_claims=claims,
         decode_claims_dropped=claims - kept,
         decode_drop_share=(claims - kept) / claims, oracle_s=dt,
         oracle_routing=routing, new_tokens=FAM_NEW, **held)
    del logits, seqs, routes
    _free(torch)
    lap("mixtral_eager")

    # The same batch on the captured decode graph, under the profiler:
    # ms a decode step and where the device time goes.
    res = []
    split, pwall = _profiled(torch, lambda: res.append(_mixtral_batch(
        torch, eng, ids)))
    streams, got, steps, replays = res[0]
    check(replays > 0, "mixtral/batch_graph: no graph replay")
    check(streams == eager, "mixtral/batch_graph: the captured decode "
          "graph's streams differ from the eager chunk's")
    _add(out, {name: got[name] for name in out})
    reh = _rehydrate_ms(torch, eng.params["blocks"]["mlp"])
    reh_on_e = _rehydrate_ms(torch, eng.params["blocks"]["mlp"], True)
    busy = sum(split.values())
    shared["rehydrate_ms_a_layer"] = reh
    _SHARED["mixtral"] = shared
    emit("families", path="m", model="mixtral", leg="batch8_graph",
         card=card, rows=len(ids), decode_steps=steps, graph_replays=replays,
         streams_equal_eager=True, profiled_wall_ms=pwall,
         ms_per_decode_step_incl_admissions=pwall / steps,
         device_kernel_ms=split,
         device_busy_share=busy / pwall if busy else "not measured",
         rehydrate_ms_a_layer=reh, rehydrate_ms_a_forward=reh * n_layers,
         rehydrate_ms_a_layer_pairs_on_experts=reh_on_e,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    _free(torch)
    lap("mixtral_graph")
    return out


def families_train(torch, card, lap) -> int:
    """One ``Trainer`` step at Mixtral's width cut to MIXTRAL_TRAIN_LAYERS
    layers, ``attn_impl="flash"`` (K3), a [1, 1025] batch: the loss, the
    aux term, seconds and peak memory; before it, the bf16 gradient of
    layer 0's w_gate experts against a float32 recompute on the card
    (dense attention), within path g's TRAIN_GRAD_REL.  The recompute
    routes every claim to the expert the bf16 pass chose (its gates from
    its own float32 logits): on random weights many rows' second and
    third router logits lie within bf16 rounding of each other, and a
    flipped choice moves a row's whole contribution between experts — a
    discrete decision, not arithmetic error.  The recompute with its own
    routing is printed beside it.  Returns K3's launches in the step."""
    import dataclasses

    from distributed_llms_tpu_torch.models import layers
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import train

    cfg = get_preset(MIXTRAL_PRESET, attn_impl="flash",
                     num_layers=MIXTRAL_TRAIN_LAYERS)
    _mixtral(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    n_params = sum(p.numel() for p in train._leaves(params))
    batch = torch.randint(0, cfg.vocab_size, (1, MIXTRAL_TRAIN_TOKENS),
                          device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))

    def expert_grad(p, c):
        leaf = p["blocks"]["mlp"]["w_gate"]
        leaf.requires_grad_(True)
        try:
            loss = train.lm_loss(p, c, batch)
            (g,) = torch.autograd.grad(loss, [leaf])
        finally:
            leaf.requires_grad_(False)
        return float(loss), g[0].float()

    route = layers.moe_route
    decisions = []

    def recorded(logits, c, cap):
        out = route(logits, c, cap)
        decisions.append([t.detach() for t in out[1:]])
        return out

    def replayed(logits, c, cap):
        eid, oh, keep, slot = decisions.pop(0)
        topi = eid.reshape(c.num_experts_per_token, -1).T
        return (torch.softmax(logits.gather(1, topi), dim=-1), eid, oh, keep,
                slot)

    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="dot")
    try:
        layers.moe_route = recorded
        loss16, g16 = expert_grad(params, cfg)
        bf16_eids = [d[0].clone() for d in decisions]
        routes = [[t.cpu() for t in d] for d in decisions]
        p32 = _tree_to_dtype(params, torch.float32)
        layers.moe_route = replayed
        loss32, g32 = expert_grad(p32, cfg32)
        layers.moe_route = recorded
        _, g32_own = expert_grad(p32, cfg32)
        flipped = sum(int((a != b).sum()) for a, b in zip(
            bf16_eids, [d[0] for d in decisions]))
    finally:
        layers.moe_route = route
    del p32, decisions
    _free(torch)
    grad_rel = ((g16 - g32).norm() / g32.norm()).item()
    grad_rel_own = ((g16 - g32_own).norm() / g32_own.norm()).item()
    claims = sum(e.numel() for e in bf16_eids)
    grad0 = g16.cpu()
    del g16, g32, g32_own
    with torch.no_grad():
        aux = float(model_lib.forward(params, cfg, batch[:, :-1],
                                      return_aux=True)[2])
    trainer = train.Trainer(cfg, train.default_optimizer(MIXTRAL_TRAIN_LR))
    state = trainer.init(params)
    step = trainer.make_step()
    before0 = params["blocks"]["mlp"]["w_gate"][0].to("cpu", copy=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch, None)
    loss = float(loss)
    step_s = time.perf_counter() - t0
    launched = read_launches()["flash_attention_static"]
    # What path s holds its expert=2 step against: the same weights,
    # batch and routing.
    _SHARED["mixtral_train"] = {
        "loss": loss, "routes": routes, "batch": batch.cpu(),
        "grad0": grad0, "before0": before0, "step_s": step_s,
        "after0": params["blocks"]["mlp"]["w_gate"][0].cpu()}
    emit("families", path="m", model="mixtral", step="train", card=card,
         num_layers=cfg.num_layers, params=n_params, batch=list(batch.shape),
         loss=loss, aux=aux, aux_weight=cfg.moe_aux_loss_weight,
         loss_bf16_before=loss16, loss_f32_before=loss32, step_s=step_s,
         expert_grad_rel_err=grad_rel, tol={"grad_rel": TRAIN_GRAD_REL},
         expert_grad_rel_err_own_routing=grad_rel_own,
         claims_routed_otherwise_in_float32=flipped, claims=claims,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches={"flash_attention_static": launched})
    check(math.isfinite(loss) and math.isfinite(aux), "mixtral train: "
          f"loss {loss} or aux {aux} not finite")
    check(launched == cfg.num_layers, f"mixtral train: K3 launched "
          f"{launched} times, not {cfg.num_layers}")
    check(grad_rel <= TRAIN_GRAD_REL, f"mixtral train: the expert gradient "
          f"is {grad_rel:.4f} from the float32 recompute")
    del params, state, batch
    _free(torch)
    lap("mixtral_train")
    return launched


def _tree_to_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def serve_families(torch) -> dict:
    """Path m: Pythia-6.9B, OPT-125M (and gpt2-125m's generation),
    Mixtral-8x7B as an int4 store, and a Trainer step at Mixtral's width.
    Returns the launches of the path's own calls."""
    card = _card()
    lap = _lap("families_time")
    out = {}
    _add(out, families_pythia(torch, card, lap))
    _add(out, families_opt(torch, card, lap))
    _add(out, families_mixtral(torch, card, lap))
    out["flash_attention_static"] = families_train(torch, card, lap)
    return out


# -- path n: replica fleets, disaggregated prefill/decode, tenants ------------

# Path n serves Llama-3-8B's width cut from 32 layers to STORE_LAYERS (a
# bf16 store, ``--store``) since path r joined the smoke, to keep it near
# 1000 s of phases: every layer keeps the published width and path a's
# pool flags.  Its max-len holds the frame-limit prompt below.
FLEET_MAX_LEN = 2048
FLEET_NEW = 48
# Path a's prefix with tails of equal length: 333-353 prompt tokens (with
# BOS), 5 full 64-token pages each, all handed off / pulled.
FLEET_TAILS = ("Case C: a refused delivery at dock 4.",
               "Case D: a customs hold on two crates.",
               "Case E: a damaged pallet was refused.")
FLEET_PROBE_BYTES = 330  # + BOS: 331 tokens, 5 full pages
PULL_DEADLINE_S = 5.0  # ReplicaRouter's default
# n2's handoff deadline: a 5-page handoff is ~5-6 s of host wire work at
# this width and a drilled retry ~10 s (PERF.md §5), against the
# router's default 15 s; the drills must not race it.
HANDOFF_DEADLINE_S = 60.0


def _probe(label: str) -> str:
    """A fresh 5-page prompt (no prefix any replica holds)."""
    text = f"TTFT probe {label}: " + "".join(
        f"freight line {i:02d}; " for i in range(20))
    check(len(text) >= FLEET_PROBE_BYTES, "fleet: the probe prompt is short")
    return text[:FLEET_PROBE_BYTES]
# The pull drill's own shared prefix (4 full pages), so that only the
# replica that served its first prompt holds it: path a's traffic leaves
# PATH_A_PREFIX's pages on both replicas.
PULL_BASE = ("Dock roster for the night shift, one crew per bay, names "
             "withheld: " + "".join(f"bay {i:02d} crew {(7 * i) % 23:02d}; "
                                    for i in range(24)))[:280]
# 1700 prompt bytes (1701 tokens, 26 full pages): 26 x 2 MiB of K+V at 8
# layers, 69 MiB base64'd, over MAX_FRAME (64 MiB, the logical body; 24
# pages would be 64 MiB before the message's own bytes) — the
# reference's permanent "frame too large".
FLEET_LONG_BYTES = 1700
FLEET_LONG_PAGES = FLEET_LONG_BYTES // 64
FLEET_LONG = ("A ledger past the frame limit: " + "".join(
    f"crate {i:03d} on aisle {i % 17:02d}; " for i in range(80)))[
        :FLEET_LONG_BYTES]
TENANT_NEW = 32
TENANT_PROMPT_BYTES = 39  # + BOS: 40 tokens; est = 40 + 32 = 72 a request
TENANT_WINDOW_S = 10.0  # the gateway's and router's default window
# Tenant b (weight 1) holds exactly 8 requests' est in its window: the
# 9th of its burst is over quota.  Tenant a (weight 3) holds 24.
TENANT_QUOTA_TPS = 8 * (TENANT_PROMPT_BYTES + 1 + TENANT_NEW) \
    / TENANT_WINDOW_S
TENANT_ARGS = ["--tenant-weights", "a:3,b:1", "--tenant-max-rows", "6",
               "--tenant-quota-tps", str(TENANT_QUOTA_TPS)]


class _FleetRecorder:
    """Every batcher's submits and finished streams, whichever replica,
    respawn or engine-side run owns it (the class's ``submit`` and ``run``
    wrapped for the length of path n): token ids are read engine-side
    because an HTTP answer carries text, which random weights mostly
    decode to nothing."""

    def __init__(self, cls) -> None:
        self.cls = cls
        self.subs, self.streams, self.first, self.done = {}, {}, {}, []
        self._serial = [0]
        self._orig = (cls.submit, cls.run)

    def key(self, b, rid):
        if "_smoke_serial" not in b.__dict__:
            self._serial[0] += 1
            b._smoke_serial = self._serial[0]
        return (b._smoke_serial, rid)

    def install(self):
        submit, run = self._orig
        rec = self

        def submit_rec(b, prompt, max_new_tokens=32, *a, **kw):
            t0 = time.perf_counter()
            rid = submit(b, prompt, max_new_tokens, *a, **kw)
            ids = (b.tokenizer.encode(prompt) if isinstance(prompt, str)
                   else list(prompt))
            t = kw.get("temperature")
            greedy = (b.sampling["temperature"] if t is None else t) == 0.0
            rec.subs[rec.key(b, rid)] = dict(ids=ids, new=max_new_tokens,
                                             greedy=greedy, t0=t0)
            return rid

        def run_rec(b, on_tokens=None):
            def on(rid, toks, done, lps):
                k = rec.key(b, rid)
                if toks and k not in rec.first:
                    rec.first[k] = time.perf_counter()
                rec.streams.setdefault(k, []).extend(toks)
                if done:
                    rec.done.append(k)
                if on_tokens is not None:
                    return on_tokens(rid, toks, done, lps)
            return run(b, on_tokens=on)

        self.cls.submit, self.cls.run = submit_rec, run_rec
        return self

    def uninstall(self):
        self.cls.submit, self.cls.run = self._orig

    def finished(self, since=0, serials=None) -> list:
        """[(key, ids, new, stream)] of greedy requests that finished
        (done delivered) since mark ``since``, 1-token prefill admissions
        left out, on the batchers ``serials`` (None: any)."""
        out = []
        for k in self.done[since:]:
            s = self.subs.get(k)
            if s is None or not s["greedy"] or s["new"] <= 1:
                continue
            if serials is not None and k[0] not in serials:
                continue
            out.append((k, s["ids"], s["new"], self.streams.get(k, [])))
        return out


class _HandoffTimers:
    """Times each part of a KV handoff where the code runs it: the export
    gather (engine thread, to host memory), the KV_PAGES message build
    (base64 + checksum), the frame encode (JSON + zlib), the send to its
    ack, the receiver's inflate, verify (base64 decode + checksum +
    digest chain) and the import (the scatter, synchronized)."""

    def __init__(self, torch) -> None:
        from distributed_llms_tpu_torch.cluster import kv_transfer, protocol
        from distributed_llms_tpu_torch.runtime import batcher as tb

        self.torch = torch
        self.parts = {k: [] for k in ("export", "message", "encode", "send",
                                      "inflate", "verify", "import")}
        self.pages = []  # pages of each export
        self.sends = []
        self.mods = (kv_transfer, protocol, tb.ContinuousBatcher)
        self.saved = []

    def _wrap(self, owner, name, part, sync=False, big=None):
        fn = getattr(owner, name)
        self.saved.append((owner, name, fn))
        parts, torch = self.parts[part], self.torch

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            if big is None or big(a, out):
                parts.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(owner, name, timed)

    def install(self):
        kvt, proto, cls = self.mods
        self._wrap(cls, "export_prefix_pages", "export")
        export, pages = cls.export_prefix_pages, self.pages

        def counted_export(b, ids):
            out = export(b, ids)
            pages.append(0 if out is None else len(out[0]))
            return out
        cls.export_prefix_pages = counted_export
        self._wrap(kvt, "encode_kv_pages", "message")
        self._wrap(proto, "encode", "encode",
                   big=lambda a, out: len(out) > 1 << 20)
        self._wrap(proto, "_inflate", "inflate",
                   big=lambda a, out: len(out) > 1 << 20)
        self._wrap(kvt, "verify_and_decode", "verify")
        self._wrap(cls, "_import_kv_pages", "import", sync=True)
        send = kvt.send_kv_pages
        self.saved.append((kvt, "send_kv_pages", send))
        sends, parts = self.sends, self.parts["send"]

        async def timed_send(*a, **kw):
            res = await send(*a, **kw)
            sends.append(res)
            parts.append(res.elapsed_s * 1e3)
            return res
        kvt.send_kv_pages = timed_send
        return self

    def uninstall(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def _counters_by_prefix(prefixes) -> dict:
    """Every counter under one of ``prefixes`` (reasons included)."""
    from distributed_llms_tpu_torch.core.observability import METRICS

    return {k: v for k, v in METRICS.snapshot()["counters"].items()
            if k.startswith(prefixes)}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def _fleet_base(store: str) -> list:
    """Path n's ``dlt-serve-torch`` flags over the cut store."""
    return ["--store", store, *SERVE_ARGS[2:], "--max-len",
            str(FLEET_MAX_LEN)]


def _fleet_args(base: list, *extra) -> list:
    from distributed_llms_tpu_torch.cli import serve_main

    return serve_main.parser().parse_args([*base, *extra])


async def _fleet_boot(fleet, router) -> float:
    """Boot every replica at once (each factory off the loop), the router,
    and wait for the first healthy probe of each: seconds."""
    t0 = time.perf_counter()
    await fleet.start()
    await router.start()
    check(await fleet.wait_healthy(timeout_s=120.0),
          f"fleet: not every replica probed healthy: {fleet.report()}")
    return time.perf_counter() - t0


def _launch_floor(label, launches, kernel, layers, steps) -> None:
    check(launches[kernel] >= layers * steps,
          f"{label}: {kernel} launched {launches[kernel]} times, under "
          f"{layers} layers x {steps} decode steps")


def _hold_fleet(torch, label, eng, rows, want_fn) -> dict:
    """Hold each finished greedy stream ``rows`` [(key, ids, new, stream)]
    to ``want_fn(ids, new)`` by the near-tie rule."""
    eos = eng.tokenizer.eos_id
    got = [r[3] for r in rows]
    want = [want_fn(r[1], r[2]) for r in rows]
    return _near_ties(torch, label, eng.params, eng.cfg,
                      [r[1] for r in rows], got, want, eos)


def _single_engine(torch, eng, rows, kv_bits=16, second_pass=False) -> dict:
    """The streams a single colocated engine gives the prompts of
    ``rows`` [(key, ids, new, stream)] (greedy, path a's pool): cold
    admissions, or with ``second_pass`` each prompt served once (1 token)
    and then again as a prefix hit over its own pages.
    {(ids, new): stream}."""
    b = eng.continuous_batcher(batch_slots=8, max_len=FLEET_MAX_LEN,
                               paged_pages=256, page_size=64,
                               prefix_cache=True, kv_bits=kv_bits)
    out = {}
    todo = sorted({(tuple(r[1]), r[2]) for r in rows})
    if second_pass:
        for ids, _ in todo:
            b.submit(list(ids), max_new_tokens=1)
        b.run()
    for i in range(0, len(todo), 8):
        part = todo[i:i + 8]
        rids = [b.submit(list(ids), max_new_tokens=new,
                         prefix_cache=second_pass) for ids, new in part]
        res = b.run()
        for (ids, new), r in zip(part, rids):
            out[(ids, new)] = res[r]
    torch.cuda.synchronize()
    del b
    _free(torch)
    return out


async def _greedy(port, prompt, new=FLEET_NEW, **extra) -> dict:
    status, resp = await _http(port, "/v1/completions", {
        "prompt": prompt, "max_tokens": new, "temperature": 0.0, **extra})
    check(status == 200, f"fleet: a greedy request answered {status}: "
          f"{resp}")
    return resp


def _cached(resp) -> int:
    return (resp.get("usage", {}).get("prompt_tokens_details") or {}).get(
        "cached_tokens", 0)


def _gate_engine(server):
    """Hold a replica's engine before its next ``run``: a request sent
    now is provably in flight with nothing streamed."""
    import threading

    gate = threading.Event()
    b = server.batcher
    run = b.run

    def gated(on_tokens=None):
        gate.wait(60)
        b.run = run
        return run(on_tokens=on_tokens)

    b.run = gated
    return gate


async def _await_inflight(h) -> None:
    for _ in range(6000):
        if h.inflight and h.server._inflight():
            return
        await asyncio.sleep(0.005)
    raise SmokeFailure(f"fleet: no request went in flight on {h.name}")


def _step_ms(torch, eng) -> dict:
    """Decode ms a step of 8 greedy requests (300-token prompts, 64 new)
    on one batcher alone, then on two batchers over the same weights run
    at once from two threads — the replicas' engine threads share the
    card (and its one legacy default stream)."""
    import threading

    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (LOOP_PROMPT_TOKENS,),
                             generator=g).tolist() for _ in range(8)]

    def fresh():
        return eng.continuous_batcher(batch_slots=8, max_len=FLEET_MAX_LEN,
                                      paged_pages=256, page_size=64,
                                      prefix_cache=True)

    b1, b2 = fresh(), fresh()
    for b in (b1, b2):
        _run_batch(torch, b, prompts)  # capture the graphs
    alone = _run_batch(torch, b1, prompts)
    out = [None, None]

    def worker(i, b):
        out[i] = _run_batch(torch, b, prompts)

    threads = [threading.Thread(target=worker, args=(i, b))
               for i, b in enumerate((b1, b2))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(all(o is not None for o in out), "fleet: a concurrent run failed")
    check(out[0][0] == alone[0] and out[1][0] == alone[0],
          "fleet: two batchers at once gave other streams than one alone")
    res = {"one_replica_ms_per_step": alone[1] / alone[2] * 1e3,
           "two_replicas_ms_per_step": [o[1] / o[2] * 1e3 for o in out],
           "two_replicas_wall_s": wall, "one_replica_wall_s": alone[1],
           "decode_steps": alone[2]}
    del b1, b2
    _free(torch)
    return res


def fleet_replicas(torch, card, lap, parts, rec, base) -> dict:
    """n1: ``--replicas 2`` through ``build_fleet`` and the router."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.observability import METRICS
    from distributed_llms_tpu_torch.runtime.faults import FaultPlane

    eng = parts[0]
    args = _fleet_args(base, "--replicas", "2")
    fleet, router, _ = serve_main.build_fleet(args, engine_parts=parts)
    # The shared plane of the replica.* and router.* sites, armed by count
    # below.
    fleet.faults = router.faults = FaultPlane()
    torch.cuda.reset_peak_memory_stats()
    mark = len(rec.done)
    counters = ("router.affinity_hits", "directory.hits", "directory.pulls",
                "batcher.kv_pages_imported", "batcher.kv_pages_exported",
                "router.failovers", "router.respawns")
    prefixes = ("router.", "directory.", "batcher.kv_pages_", "xfer.")
    c0 = _counters_by_prefix(prefixes)
    info: dict = {}

    async def drive():
        info["boot_s"] = await _fleet_boot(fleet, router)
        port = router.bound_port
        reset_launches()
        info["path_a"] = await _serve_requests(port)
        # The three shared-prefix prompts again: each lands on the replica
        # that holds its longest cached run (epoch-valid affinity) and hits.
        hits0 = METRICS.get_counter("router.affinity_hits")
        repeats = []
        for tail in ("Case A: a pallet arrived late.",
                     "Case B: a crate is dented.",
                     "Case A: a pallet arrived late."):
            resp = await _greedy(port, PATH_A_PREFIX + tail)
            repeats.append(_cached(resp))
        check(METRICS.get_counter("router.affinity_hits") - hits0 == 3,
              "fleet: the repeats did not all follow affinity")
        check(all(c >= 256 for c in repeats),
              f"fleet: a repeat missed the prefix pages: {repeats}")
        info["repeats_cached_tokens"] = repeats
        # The pull: a fresh prefix served once lands on one replica (the
        # holder); the holder is vetoed once for a second prompt over the
        # same prefix, which lands cold on the sibling, and the router
        # pulls the run from the holder instead of prefilling it.
        await _greedy(port, PULL_BASE + " First: which bay is free?")
        digests = router._digests(eng.tokenizer.encode(
            PULL_BASE + " Second: which crew is late?"))
        holder = router._affinity_lookup(digests[3])
        check(holder is not None, "fleet: no affinity recorded for the "
              "pull drill's prefix")
        info["pull_holder"] = holder
        rule = router.faults.add("router.place", "drop", when="1",
                                 tag=holder)
        pull0 = {c: METRICS.get_counter(c) for c in counters}
        # At this width a 4-page pull's host work (JSON + zlib of ~30 MB)
        # takes ~4 s of the reference's 5 s deadline: the drill, which
        # must pull, gets the handoff's 15 s.
        router.pull_deadline_s = router.handoff_deadline_s
        t0 = time.perf_counter()
        pulled = await _greedy(port, PULL_BASE + " Second: which crew is "
                               "late?")
        info["pull_request_s"] = time.perf_counter() - t0
        router.pull_deadline_s = PULL_DEADLINE_S
        check(rule.fired == 1, "fleet: the router.place drop never fired")
        pulled_delta = {c: METRICS.get_counter(c) - pull0[c]
                        for c in counters}
        info["pull"] = {"cached_tokens": _cached(pulled), **pulled_delta}
        check(pulled_delta["directory.hits"] == 1
              and pulled_delta["directory.pulls"] == 1
              and pulled_delta["batcher.kv_pages_imported"] == 4,
              f"fleet: the drill did not pull 4 pages: {pulled_delta}")
        check(_cached(pulled) >= 256, "fleet: the pulled run was not hit")
        # TTFT of a colocated cold prompt (5 pages), for path n2's
        # handed-off one.
        t0 = time.perf_counter()
        await _greedy(port, _probe("colocated"),
                      new=8)
        info["probe_sent_t"] = t0
        # Crash drill: a fresh greedy prompt (no affinity: it places on the
        # least committed replica, ties by name, r0) held in flight there,
        # then replica.crash:close fired by count at r0's next probe tick;
        # it fails over to r1.
        victim = fleet["r0"]
        gate = _gate_engine(victim.server)
        task = asyncio.create_task(_greedy(
            port, _probe("crash")))
        await _await_inflight(victim)
        crash = fleet.faults.add("replica.crash", "close", when="1",
                                 tag=victim.name)
        for _ in range(4000):
            if crash.fired:
                break
            await asyncio.sleep(0.005)
        check(crash.fired == 1, "fleet: replica.crash never fired")
        failed_over = await task
        gate.set()
        for _ in range(4000):
            if victim.state == "dead" and not victim.server._engine.is_alive():
                break
            await asyncio.sleep(0.005)
        check(victim.state == "dead", "fleet: the crashed replica is not "
              "dead")
        info["failover_cached_tokens"] = _cached(failed_over)
        # Respawn under traffic: the sibling serves while the new
        # replica's graphs are captured.
        t0 = time.perf_counter()
        await fleet.respawn(victim.name, wait_healthy_s=120.0)
        info["respawn_s"] = time.perf_counter() - t0
        check(victim.state == "healthy", "fleet: the respawn never probed "
              "healthy")
        outs = await asyncio.gather(*[
            _greedy(port, _probe(f"after {i}"))
            for i in range(6)])
        info["after_respawn"] = len(outs)
        info["captures"] = {h.name: h.server.batcher._graphs.captures
                            for h in fleet.replicas}
        check(victim.server.batcher._graphs.captures > 0,
              "fleet: the respawned replica captured no graph")
        check(victim.server.batcher.decode_steps > 0,
              "fleet: the respawned replica decoded nothing")
        info["launches"] = read_launches()
        info["steps"] = {h.name: h.server.batcher.decode_steps
                         for h in fleet.replicas}
        info["report"] = fleet.report()
        await router.stop()
        await fleet.stop()

    asyncio.run(drive())
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    delta = _delta(_counters_by_prefix(prefixes), c0)
    check(delta.get("router.failovers", 0) >= 1, "fleet: no failover")
    first = rec.first
    probe = [k for k, s in rec.subs.items()
             if s["t0"] >= info["probe_sent_t"] and s["new"] == 8]
    ttft = (first[probe[0]] - info["probe_sent_t"]) if probe else None
    _launch_floor("fleet n1", info["launches"], "paged_decode_attention",
                  eng.cfg.num_layers, max(info["steps"].values()))
    lap("n1_traffic")
    rows = rec.finished(mark)
    single = _single_engine(torch, eng, rows)
    held = _hold_fleet(torch, "fleet n1", eng, rows,
                       lambda ids, new: single[(tuple(ids), new)])
    lap("n1_held")
    step = _step_ms(torch, eng)
    lap("n1_step_times")
    emit("fleet", path="n1", card=card, replicas=2,
         colocated_probe_ttft_s=ttft, counters=delta, held=held,
         step_times=step, **{k: v for k, v in info.items()
                             if k != "probe_sent_t"})
    del fleet, router
    _free(torch)
    return info["launches"]


def _pool_bytes_equal(torch, a, b, digests) -> dict:
    """The pages holding ``digests`` in batchers a and b, compared on the
    card: k and v (and an int8 pool's scales) equal to the bit."""
    pa, pb = a.prefix_cache.match(digests), b.prefix_cache.match(digests)
    check(len(pa) == len(pb) == len(digests),
          f"fleet: pages not resident on both ({len(pa)}, {len(pb)} of "
          f"{len(digests)})")
    ia = torch.tensor(pa, device=a.cache.k.device)
    ib = torch.tensor(pb, device=b.cache.k.device)
    names = ["k", "v"] + (["k_scale", "v_scale"]
                          if hasattr(a.cache, "k_scale") else [])
    out = {}
    for n in names:
        x, y = getattr(a.cache, n)[:, ia], getattr(b.cache, n)[:, ib]
        out[n] = bool(torch.equal(x, y))
        check(out[n], f"fleet: imported {n} pages differ from the sender's")
    return {"pages": len(pa), "equal": out}


def fleet_disagg(torch, card, lap, parts, rec, base, kv_bits) -> dict:
    """n2: ``--disaggregate --prefill-replicas 1 --decode-replicas 1``."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.observability import METRICS

    eng = parts[0]
    extra = ["--kv-bits", "8"] if kv_bits == 8 else []
    args = _fleet_args(base, "--disaggregate", "--prefill-replicas", "1",
                       "--decode-replicas", "1", *extra)
    fleet, router, _ = serve_main.build_fleet(args, engine_parts=parts)
    router.handoff_deadline_s = HANDOFF_DEADLINE_S
    torch.cuda.reset_peak_memory_stats()
    mark = len(rec.done)
    prefixes = ("router.", "directory.", "batcher.kv_pages_", "xfer.")
    c0 = _counters_by_prefix(prefixes)
    timers = _HandoffTimers(torch).install()
    info: dict = {}
    tok = eng.tokenizer
    handed = [PATH_A_PREFIX + t for t in FLEET_TAILS]

    async def drive():
        from distributed_llms_tpu_torch.runtime.faults import FaultPlane

        info["boot_s"] = await _fleet_boot(fleet, router)
        port = router.bound_port
        reset_launches()
        if kv_bits == 16:
            info["path_a"] = await _serve_requests(port)
        # Handed-off prompts one at a time, so each handoff's parts line
        # up; their repeats hit the imported pages.
        info["handoff_cached_tokens"] = [
            _cached(await _greedy(port, p)) for p in handed]
        check(all(c >= 256 for c in info["handoff_cached_tokens"]),
              f"fleet: a handed-off prompt was not served from the "
              f"imported pages: {info['handoff_cached_tokens']}")
        # TTFT of a handed-off cold prompt (5 pages), against n1's
        # colocated one.
        info["probe_sent_t"] = time.perf_counter()
        await _greedy(port, _probe("handoff"),
                      new=8)
        p0, d0 = fleet["p0"], fleet["d0"]
        distinct = set()
        for p in handed:
            ids = tok.encode(p)
            digests = p0.server.batcher._page_digests(ids,
                                                      (len(ids) - 1) // 64)
            distinct.update(digests)
            info.setdefault("pages_equal", []).append(_pool_bytes_equal(
                torch, p0.server.batcher, d0.server.batcher, digests))
        info["distinct_handed_pages"] = len(distinct)
        if kv_bits == 16:
            # Over MAX_FRAME: the prefill replica's send fails permanently
            # and the router serves colocated.
            rej = METRICS.get_counter("router.handoff_fallbacks.rejected")
            check(len(FLEET_LONG) == FLEET_LONG_BYTES, "fleet: the long "
                  "prompt is short")
            resp = await _greedy(port, FLEET_LONG, new=32)
            check(METRICS.get_counter("router.handoff_fallbacks.rejected")
                  == rej + 1, f"fleet: the {FLEET_LONG_PAGES}-page handoff "
                  "did not fall back")
            check(_cached(resp) == 0, f"fleet: the {FLEET_LONG_PAGES}-page "
                  "prompt hit pages")
            # The drills, on the prefill replica's own plane.
            plane = p0.server.batcher.faults
            if plane is None:
                plane = p0.server.batcher.faults = FaultPlane()
            corrupt = plane.add("xfer.send", "corrupt", when="1")
            retries = METRICS.get_counter("xfer.retries")
            resp = await _greedy(port, _probe("corrupt"))
            check(corrupt.fired == 1, "fleet: xfer.send corrupt never fired")
            check(METRICS.get_counter("xfer.retries") == retries + 1,
                  "fleet: the corrupted frame was not retried")
            check(_cached(resp) >= 256, "fleet: the retried handoff missed")
            crash = plane.add("prefill.crash", "close", when="1")
            err = METRICS.get_counter("router.handoff_fallbacks.error")
            resp = await _greedy(port, _probe("crash"))
            check(crash.fired == 1, "fleet: prefill.crash never fired")
            check(METRICS.get_counter("router.handoff_fallbacks.error")
                  == err + 1, "fleet: the prefill crash did not fall back")
            check(_cached(resp) == 0, "fleet: a crashed handoff hit pages")
        info["launches"] = read_launches()
        info["steps"] = {h.name: h.server.batcher.decode_steps
                         for h in fleet.replicas if h.server is not None}
        info["report"] = fleet.report()
        await router.stop()
        await fleet.stop()

    try:
        asyncio.run(drive())
    finally:
        timers.uninstall()
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    delta = _delta(_counters_by_prefix(prefixes), c0)
    kernel = ("paged_decode_attention_int8" if kv_bits == 8
              else "paged_decode_attention")
    _launch_floor(f"fleet n2/{kv_bits}", info["launches"], kernel,
                  eng.cfg.num_layers, info["steps"]["d0"])
    check(delta.get("batcher.kv_pages_imported", 0)
          >= info["distinct_handed_pages"],
          f"fleet: too few imported pages: {delta}")
    first = rec.first
    probe = [k for k, s in rec.subs.items()
             if s["t0"] >= info["probe_sent_t"] and s["new"] == 8]
    ttft = (first[probe[0]] - info["probe_sent_t"]) if probe else None
    lap(f"n2_{kv_bits}_traffic")
    rows = rec.finished(mark)
    # The decode replica's streams of handed-off prompts against a
    # colocated engine's second serving (a hit over its own pages); every
    # stream (the colocated fallbacks and short prompts too) against its
    # cold serving.
    cold_only = {tuple(tok.encode(p)) for p in (
        FLEET_LONG,
        _probe("crash"))}
    hit_rows = [r for r in rows
                if len(r[1]) > 64 and tuple(r[1]) not in cold_only]
    hit = _single_engine(torch, eng, hit_rows, kv_bits, second_pass=True)
    cold = _single_engine(torch, eng, rows, kv_bits)
    held = {
        "hit": _hold_fleet(torch, f"fleet n2/{kv_bits} handed off", eng,
                           hit_rows,
                           lambda ids, new: hit[(tuple(ids), new)]),
        "all_vs_cold": _hold_fleet(torch, f"fleet n2/{kv_bits}", eng, rows,
                                   lambda ids, new: cold[(tuple(ids), new)]),
    }
    lap(f"n2_{kv_bits}_held")
    sends = [(s.ok, s.reason, s.attempts, s.bytes_sent)
             for s in timers.sends]
    emit("fleet", path="n2", card=card, kv_bits=kv_bits,
         handoff_probe_ttft_s=ttft, counters=delta, held=held,
         handoff_ms=timers.parts, export_pages=timers.pages, sends=sends,
         **{k: v for k, v in info.items() if k != "probe_sent_t"})
    del fleet, router
    _free(torch)
    return info["launches"]


def _tenant_prompt(tenant: str, i: int) -> str:
    p = f"Tenant {tenant} request {i:02d}: " + "x" * TENANT_PROMPT_BYTES
    return p[:TENANT_PROMPT_BYTES]


async def _tenant_post(port, tenant, i):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps({"prompt": _tenant_prompt(tenant, i),
                          "max_tokens": TENANT_NEW,
                          "temperature": 0.0}).encode()
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: x\r\nX-Tenant: {tenant}\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), headers.get("Retry-After"), rest


def fleet_tenants(torch, card, lap, parts, rec, base) -> dict:
    """n3: tenants on one engine, then behind a 2-replica router."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.observability import METRICS

    eng, name, rt, faults, _spec = parts
    args = _fleet_args(base, *TENANT_ARGS)
    server = serve_main._server_factory(args, eng, name, rt, faults)()
    sched = server.batcher.sched
    check(type(sched).__name__ == "TenantScheduler",
          "fleet: the tenant flags did not make a TenantScheduler")
    torch.cuda.reset_peak_memory_stats()
    order, resident, peak = [], {}, {}
    admitted, freed = sched.note_admitted, sched.note_freed

    def note_admitted(req, est):
        order.append(req.tenant)
        resident[req.tenant] = resident.get(req.tenant, 0) + 1
        peak[req.tenant] = max(peak.get(req.tenant, 0),
                               resident[req.tenant])
        return admitted(req, est)

    def note_freed(req, emitted):
        resident[req.tenant] = resident.get(req.tenant, 0) - 1
        return freed(req, emitted)

    sched.note_admitted, sched.note_freed = note_admitted, note_freed
    info: dict = {}

    async def drive():
        await server.start()
        port = server.bound_port
        try:
            reset_launches()
            # All 16 queued before the first admission: the engine is held
            # until every request is registered.
            gate = _gate_engine(server)
            tasks = [asyncio.create_task(_tenant_post(port, t, i))
                     for i in range(8) for t in ("b", "a")]
            for _ in range(6000):
                if server._inflight() == 16:
                    break
                await asyncio.sleep(0.005)
            check(server._inflight() == 16, "fleet: 16 tenant requests "
                  "never all registered")
            gate.set()
            outs = await asyncio.gather(*tasks)
            check(all(o[0] == 200 for o in outs),
                  f"fleet: a tenant request failed: "
                  f"{[o[0] for o in outs]}")
            over = await _tenant_post(port, "b", 8)
            info["over_quota"] = {"status": over[0], "retry_after": over[1]}
            check(over[0] == 429 and over[1] is not None
                  and b"tenant_quota" in over[2],
                  f"fleet: tenant b's 9th request answered {over[0]}")
            info["launches"] = read_launches()
            info["steps"] = server.batcher.decode_steps
        finally:
            await server.stop()

    asyncio.run(drive())
    info["admission_order"] = "".join(order)
    info["peak_resident"] = peak
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(max(peak.values()) <= 6, f"fleet: a tenant held over 6 rows: "
          f"{peak}")
    check(order[:8].count("a") >= 5, f"fleet: tenant a (weight 3) got "
          f"{order[:8].count('a')} of the first 8 admissions: {order}")
    _launch_floor("fleet n3", info["launches"], "paged_decode_attention",
                  eng.cfg.num_layers, info["steps"])
    del server
    _free(torch)
    lap("n3_one_engine")
    # Behind a 2-replica router the fleet ledger holds ONE quota.
    fargs = _fleet_args(base, "--replicas", "2", *TENANT_ARGS)
    fleet, router, _ = serve_main.build_fleet(fargs, engine_parts=parts)
    sheds0 = METRICS.get_counter("router.ledger.sheds")

    async def drive_fleet():
        await _fleet_boot(fleet, router)
        port = router.bound_port
        # Tenant b's burst of 9 at once: placement spreads it over both
        # replicas (least committed), each replica's own gate is a 2x
        # backstop, so only the router's one ledger can shed the 9th.
        got = await asyncio.gather(*[_tenant_post(port, "b", 100 + i)
                                     for i in range(9)])
        served = [h.server.batcher.sched._vtc.get("b", 0.0) > 0
                  for h in fleet.replicas]
        await router.stop()
        await fleet.stop()
        return got, served

    got, served = asyncio.run(drive_fleet())
    statuses = sorted(g[0] for g in got)
    info["fleet_statuses"] = statuses
    info["fleet_replicas_serving_b"] = served
    check(statuses == [200] * 8 + [429], f"fleet: the router's ledger "
          f"admitted {statuses.count(200)} of tenant b's 9, not 8")
    check(all(served), "fleet: tenant b's burst did not reach both "
          "replicas")
    check(METRICS.get_counter("router.ledger.sheds") == sheds0 + 1,
          "fleet: the router's ledger did not shed")
    emit("fleet", path="n3", card=card, quota_tps=TENANT_QUOTA_TPS, **info)
    del fleet, router
    _free(torch)
    lap("n3_fleet")
    return info["launches"]


def serve_fleet(torch) -> dict:
    """Path n: replica fleets over one copy of the weights of Llama-3-8B's
    width cut to STORE_LAYERS layers, the disaggregated handoff (bf16 and
    int8 pools) and tenant QoS.  Returns
    the launches of the path's own calls (process-wide counters: every
    replica's launches together)."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.runtime import batcher as tb

    card = _card()
    lap = _lap("fleet_time")
    store, info, _ = shared_store(torch, "llama_bf16_cut", _write_llama_cut)
    base = _fleet_base(store)
    t0 = time.perf_counter()
    parts = serve_main._build_engine(_fleet_args(base))
    torch.cuda.synchronize()
    _llama_3_8b_cut(parts[0].cfg)
    emit("fleet", part="weights", card=card,
         build_s=time.perf_counter() - t0,
         resident_gb=torch.cuda.memory_allocated() / 1e9, **info)
    lap("weights")
    rec = _FleetRecorder(tb.ContinuousBatcher).install()
    out = {}
    try:
        _add(out, fleet_replicas(torch, card, lap, parts, rec, base))
        _add(out, fleet_disagg(torch, card, lap, parts, rec, base, 16))
        _add(out, fleet_disagg(torch, card, lap, parts, rec, base, 8))
        _add(out, fleet_tenants(torch, card, lap, parts, rec, base))
    finally:
        rec.uninstall()
    del parts
    _free(torch)
    return out


def _write_llama_cut(torch, out_dir: str) -> dict:
    """Paths n and o1's store: Llama-3-8B's width cut to STORE_LAYERS
    layers, bf16."""
    return write_store(torch, None, out_dir, num_layers=STORE_LAYERS)


# -- path o: the elastic fleet and the control plane -------------------------

# o1: the autoscaler over replicas of path a's model at its full width,
# cut from 32 to STORE_LAYERS layers (path n's bf16 store, weights
# shared) since path s joined the smoke.  A replica's 8 rows turn over a
# ~470-token request (~400 prompt + ~64 new) in ~1.3 s at a 32-layer
# replica's ~19 ms decode step, ~0.45 s at ~7 ms for 8 layers; on the
# card admissions and a second replica's thread stretch that several-fold.
# The trace (seed 0: 120 arrivals, 101 in the first half) offers 2.0
# requests/s at the envelope's mean, 3.8 at its crest, bursts x4: its peak
# holds a few requests in flight on one replica, its trough about none.
# The thresholds were 0.10 and 0.03 at 32 layers (~3.5 and ~1 such
# requests); a replica 2.8 times faster holds 2.8 times fewer, so up at
# 0.04 of one replica's 16320-token pool is ~1.4 requests in flight,
# down at 0.01 ~0.35.
ELASTIC_HORIZON_S = 60.0
ELASTIC_UP_LOAD = 0.04
ELASTIC_DOWN_LOAD = 0.01
ELASTIC_COOLDOWN_S = 3.0
ELASTIC_TAIL_S = 45.0  # the longest the quiet tail waits for a scale-down
ELASTIC_ARGS = ["--replicas-min", "1", "--replicas-max", "2",
                "--autoscale-interval", "0.25", "--autoscale-hysteresis", "2",
                "--autoscale-cooldown", str(ELASTIC_COOLDOWN_S),
                "--autoscale-up-load", str(ELASTIC_UP_LOAD),
                "--autoscale-down-load", str(ELASTIC_DOWN_LOAD),
                "--fault", "fleet.scale_up:raise@1"]
ELASTIC_TTFT_SLO_S = 2.0

# o2: Llama-3-8B's published config.json (meta-llama/Meta-Llama-3-8B), cut
# from 32 to 8 layers: 2.8 B parameters, 5.6 GB of bf16 in one .bin.
CP_LAYERS = 8
CP_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_hidden_layers": CP_LAYERS, "vocab_size": 128256,
    "rope_theta": 500000.0, "max_position_embeddings": 8192,
    "rms_norm_eps": 1e-05, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 128000, "eos_token_id": 128001,
}
CP_SHARDS = 4
CP_OVERRIDES = ["runtime.max_seq_len=1024", "runtime.paged_pages=256",
                "runtime.page_size=64", "runtime.prefix_cache=true",
                "cluster.heartbeat_timeout_s=120",
                "cluster.task_timeout_s=600"]
CP_REQUESTS = [(f"Worker batch request {i}: summarize the shipping "
                f"manifest for dock {i} in one line.", n)
               for i, n in enumerate((16, 64, 24, 48, 32, 56, 40, 64))]


def elastic_specs(workload) -> list:
    """Two tenants, 200-600-byte prompts, 32-96 new tokens, bursts x4;
    half of tenant a's prompts open with its 160-byte shared prefix."""
    common = dict(prompt_len=(200, 600), output_len=(32, 96),
                  burst_rate_x=4.0, burst_enter_hz=0.2, burst_exit_hz=1.0)
    return [workload.TenantSpec("a", rate_rps=1.2, shared_frac=0.5,
                                shared_prefix_len=160, **common),
            workload.TenantSpec("b", rate_rps=0.8, **common)]


def _pct(vals, q):
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(q * len(vs)))] if vs else None


def elastic_fleet(torch, card, lap, rec) -> dict:
    """o1: ``--replicas-min 1 --replicas-max 2`` through ``build_fleet``:
    a ``workload.generate`` trace replayed over HTTP through the router,
    the autoscaler started and stopped around it."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.cluster.autoscale import Autoscaler
    from distributed_llms_tpu_torch.core.observability import METRICS
    from distributed_llms_tpu_torch.runtime import chunk_graph, workload

    store, _, _ = shared_store(torch, "llama_bf16_cut", _write_llama_cut)
    args = _fleet_args(["--store", store, *SERVE_ARGS[2:], "--max-len",
                        "1024"], *ELASTIC_ARGS)
    t0 = time.perf_counter()
    parts = serve_main._build_engine(args)
    eng = parts[0]
    torch.cuda.synchronize()
    _llama_3_8b_cut(eng.cfg)
    info = {"weights_gb": torch.cuda.memory_allocated() / 1e9,
            "build_s": time.perf_counter() - t0}
    # The byte tokenizer decodes ids under 256 only: with the unembedding
    # columns of the other 128000 ids scaled by 1/64 the greedy streams
    # stay in the byte range, so the replay's clients see text (TTFT,
    # inter-token gaps and characters are read off the SSE deltas).
    eng.params["lm_head"]["w"][:, 256:].div_(64)
    fleet, router, scaler = serve_main.build_fleet(args, engine_parts=parts)
    check(type(scaler) is Autoscaler, "elastic: build_fleet armed no "
          f"autoscaler ({scaler!r})")
    check(scaler.factory is fleet.replicas[0].factory,
          "elastic: scale-ups do not go through the boot-time factory")
    rule = scaler.faults.rules[0]
    arrivals = workload.generate(elastic_specs(workload), ELASTIC_HORIZON_S,
                                 seed=0, diurnal_period_s=ELASTIC_HORIZON_S,
                                 diurnal_amp=0.9)
    half = ELASTIC_HORIZON_S / 2
    info["arrivals"] = len(arrivals)
    info["arrivals_first_half"] = sum(1 for a in arrivals if a.t < half)
    pool_bytes = (2 * eng.cfg.num_layers * 256 * 64 * eng.cfg.num_kv_heads
                  * eng.cfg.head_dim_ * 2)
    actions, captures, samples = [], [], []
    add, remove = fleet.add_replica, fleet.remove_replica

    async def timed_add(*a, **kw):
        t = time.perf_counter()
        try:
            h = await add(*a, **kw)
        except Exception:
            actions.append(("up", t, time.perf_counter(), False, None))
            raise
        actions.append(("up", t, time.perf_counter(), True, h.name))
        return h

    async def timed_remove(name, *a, **kw):
        t = time.perf_counter()
        await remove(name, *a, **kw)
        actions.append(("down", t, time.perf_counter(), True, name))

    fleet.add_replica, fleet.remove_replica = timed_add, timed_remove
    capture = chunk_graph.ChunkGraphs._capture

    def timed_capture(graphs, *a, **kw):
        t = time.perf_counter()
        try:
            return capture(graphs, *a, **kw)
        finally:
            captures.append((id(graphs), t, time.perf_counter()))

    locked = chunk_graph.ChunkGraphs._capture_locked
    held = []  # (id(ChunkGraphs), start, end) inside the capture lock

    def timed_locked(graphs, *a, **kw):
        t = time.perf_counter()
        try:
            return locked(graphs, *a, **kw)
        finally:
            held.append((id(graphs), t, time.perf_counter()))

    chunk_graph.ChunkGraphs._capture = timed_capture
    chunk_graph.ChunkGraphs._capture_locked = timed_locked
    names_of = {}  # id(ChunkGraphs) -> replica name
    steps = {}     # replica name -> its batcher's decode steps, the most seen
    f0 = METRICS.get_counter("autoscale.scale_failures")
    mark = len(rec.done)

    async def monitor(stop):
        while not stop.is_set():
            row = {"t": time.perf_counter(), "n": len(fleet.replicas),
                   "alloc": torch.cuda.memory_allocated(), "steps": {},
                   "rows": {}}
            for h in list(fleet.replicas):
                b = getattr(h.server, "batcher", None)
                if b is None:
                    continue
                names_of[id(b._graphs)] = h.name
                row["steps"][h.name] = b.decode_steps
                row["rows"][h.name] = sum(1 for r in b.rows
                                          if r.rid is not None)
                steps[h.name] = max(steps.get(h.name, 0), b.decode_steps)
            samples.append(row)
            await asyncio.sleep(0.05)

    async def drive():
        info["boot_s"] = await _fleet_boot(fleet, router)
        stop = asyncio.Event()
        mon = None
        try:
            port = router.bound_port
            await scaler.start()
            mon = asyncio.create_task(monitor(stop))
            reset_launches()
            t_start = time.perf_counter()
            records = await workload.replay("127.0.0.1", port, arrivals,
                                            request_timeout_s=120.0)
            info["replay_s"] = time.perf_counter() - t_start
            t_tail = time.perf_counter()
            while time.perf_counter() - t_tail < ELASTIC_TAIL_S:
                if len(fleet.replicas) == 1 and any(
                        a[0] == "down" for a in actions):
                    break
                await asyncio.sleep(0.1)
            info["tail_s"] = time.perf_counter() - t_tail
            info["launches"] = read_launches()
            await scaler.stop()
            stop.set()
            await mon
            import gc

            gc.collect()
            torch.cuda.synchronize()
            info["alloc_after_down_gb"] = torch.cuda.memory_allocated() / 1e9
            for h in fleet.replicas:  # the survivor's pool audits clean
                b = h.server.batcher
                b.assert_pool_consistent()
                pool = b.pool
                cached = (len(pool.prefix_cache.lru) if pool.prefix_cache
                          else 0)
                check(not b.page_refs and len(b.free_pages) + cached
                      == pool.num_pages - 1,
                      f"elastic: {h.name}'s pool does not audit clean: "
                      f"{len(b.free_pages)} free + {cached} cached + "
                      f"{len(b.page_refs)} held of {pool.num_pages - 1}")
                info["survivor"] = {"name": h.name, "free_pages":
                                    len(b.free_pages), "cached_pages": cached,
                                    "held_pages": len(b.page_refs)}
            return records
        finally:
            stop.set()
            await scaler.stop()
            if mon is not None:
                await mon
            await router.stop()
            await fleet.stop()

    try:
        records = asyncio.run(drive())
    finally:
        chunk_graph.ChunkGraphs._capture = capture
        chunk_graph.ChunkGraphs._capture_locked = locked
    lap("o1_traffic")
    # -- the checks ----------------------------------------------------------
    ups = [a for a in actions if a[0] == "up" and a[3]]
    downs = [a for a in actions if a[0] == "down"]
    info["scale_actions"] = [
        {"kind": k, "at_s": t - samples[0]["t"], "seconds": e - t, "ok": ok,
         "replica": name} for k, t, e, ok, name in actions]
    info["scale_failures"] = METRICS.get_counter(
        "autoscale.scale_failures") - f0
    check(rule.fired == 1 and info["scale_failures"] >= 1,
          f"elastic: the injected scale-up failure did not happen "
          f"(fired {rule.fired}, failures {info['scale_failures']})")
    check(ups, "elastic: no scale-up succeeded after the injected failure")
    check(downs, "elastic: no graceful scale-down happened")
    sizes = sorted({s["n"] for s in samples})
    info["sizes_seen"] = sizes
    check(set(sizes) <= {1, 2} and 2 in sizes and samples[-1]["n"] == 1,
          f"elastic: fleet sizes {sizes}, last {samples[-1]['n']}")
    added = {a[4] for a in ups}
    first = [h for h in steps if h not in added]
    # The added replica captured its decode graph while the first replica
    # decoded: the first replica's steps advanced across a capture window.
    overlap = []
    for gid, c0, c1 in captures:
        name = names_of.get(gid)
        if name not in added:
            continue
        before = [s for s in samples if s["t"] <= c0]
        after = [s for s in samples if s["t"] >= c1]
        if not before or not after:
            continue
        adv = {n: after[0]["steps"].get(n, 0) - before[-1]["steps"].get(n, 0)
               for n in first}
        overlap.append({"replica": name, "capture_s": c1 - c0,
                        "locked_s": next((e - b for g, b, e in held
                                          if g == gid and c0 <= b
                                          and e <= c1), None),
                        "first_replica_steps_during": adv})
    info["added_captures"] = overlap
    info["captures"] = [
        {"replica": names_of.get(gid), "at_s": c0 - samples[0]["t"],
         "wall_s": c1 - c0,
         "locked_s": next((e - b for g, b, e in held
                           if g == gid and c0 <= b and e <= c1), None)}
        for gid, c0, c1 in captures]
    check(any(any(v > 0 for v in o["first_replica_steps_during"].values())
              for o in overlap),
          f"elastic: no capture of the added replica overlapped the first "
          f"replica's decoding: {overlap}")
    peak2 = max((s["alloc"] for s in samples if s["n"] == 2), default=0)
    info["alloc_peak_two_gb"] = peak2 / 1e9
    info["pool_gb"] = pool_bytes / 1e9
    check(peak2 - info["alloc_after_down_gb"] * 1e9 >= 0.8 * pool_bytes,
          f"elastic: memory after the scale-down "
          f"{info['alloc_after_down_gb']:.2f} GB is not one pool "
          f"({pool_bytes / 1e9:.2f} GB) below the two-replica peak "
          f"{peak2 / 1e9:.2f} GB")
    bad = [(r.status, r.retry_after) for r in records
           if r.status != 200 and not (r.status in (429, 503)
                                       and r.retry_after is not None)]
    check(not bad, f"elastic: answers other than 200 or a structured "
          f"429/503 with Retry-After: {bad[:8]}")
    info["steps"] = steps
    _launch_floor("elastic o1", info["launches"], "paged_decode_attention",
                  eng.cfg.num_layers, max(steps.values()))
    summary = workload.summarize(records, ELASTIC_HORIZON_S,
                                 ttft_slo_s=ELASTIC_TTFT_SLO_S)
    ok = [r for r in records if r.status == 200]
    ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
    done = rec.finished(mark)
    info["served"] = {
        "completed": len(ok), "shed": sum(1 for r in records
                                          if r.status in (429, 503)),
        "ttft_p50_s": _pct(ttfts, 0.50), "ttft_p99_s": _pct(ttfts, 0.99),
        "latency_p50_s": _pct([r.latency_s for r in ok], 0.50),
        "tokens_engine_side": sum(len(r[3]) for r in done),
        "tokens_per_s_engine_side": sum(len(r[3]) for r in done)
        / max(info["replay_s"], 1e-9),
    }
    emit("elastic", path="o1", card=card, summary=summary, **info)
    del fleet, router, scaler, parts, eng
    _free(torch)
    return info["launches"]


def write_hf_checkpoint(torch, out_dir: str) -> dict:
    """An HF checkpoint directory of Llama-3-8B's width cut to
    ``CP_LAYERS`` layers: ``config.json`` with the published values and
    ``pytorch_model.bin`` under HF's names, bf16, weights drawn on the card
    from seed 0 (normal, std 0.02; norms 1).  The unembedding rows past
    the byte tokenizer's 256 ids are scaled by 1/64, so the greedy streams
    stay in the byte range and the decoded texts carry the tokens (the
    store has no tokenizer of its own)."""
    c = CP_HF_CONFIG
    D, F, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    H, KVH = c["num_attention_heads"], c["num_key_value_heads"]
    HD = D // H
    g = torch.Generator(device="cuda").manual_seed(0)

    def w(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 0.02).to(
            torch.bfloat16).cpu()

    def ones():
        return torch.ones(D, dtype=torch.bfloat16)

    t0 = time.perf_counter()
    sd = {"model.embed_tokens.weight": w(V, D)}
    for i in range(CP_LAYERS):
        p = f"model.layers.{i}."
        sd.update({
            p + "self_attn.q_proj.weight": w(H * HD, D),
            p + "self_attn.k_proj.weight": w(KVH * HD, D),
            p + "self_attn.v_proj.weight": w(KVH * HD, D),
            p + "self_attn.o_proj.weight": w(D, H * HD),
            p + "mlp.gate_proj.weight": w(F, D),
            p + "mlp.up_proj.weight": w(F, D),
            p + "mlp.down_proj.weight": w(D, F),
            p + "input_layernorm.weight": ones(),
            p + "post_attention_layernorm.weight": ones(),
        })
    sd["model.norm.weight"] = ones()
    head = w(V, D)
    head[256:] = (head[256:].float() / 64).to(torch.bfloat16)
    sd["lm_head.weight"] = head
    params = sum(t.numel() for t in sd.values())
    torch.save(sd, str(Path(out_dir) / "pytorch_model.bin"))
    (Path(out_dir) / "config.json").write_text(json.dumps(c, indent=1))
    del sd, head
    return {"params": params, "write_s": time.perf_counter() - t0,
            "bin_bytes": (Path(out_dir) / "pytorch_model.bin").stat().st_size}


def _device_used(torch) -> int:
    free, total = torch.cuda.mem_get_info()
    return total - free


def _repl_out(label, text) -> dict:
    """The numbers and texts a coordinator REPL run printed."""
    import re

    out = {"texts": {}}
    for line in text.splitlines():
        m = re.search(r'\[(\d+)\] ("(?:[^"\\]|\\.)*")\s*$', line)
        if m:
            out["texts"][int(m.group(1))] = json.loads(m.group(2))
        m = re.search(r"convert ([\d.]+) s, write ([\d.]+) s\)", line)
        if m:
            out["convert_s"], out["store_write_s"] = map(float, m.groups())
        m = re.search(r"\[placed in ([\d.]+) s\]", line)
        if m:
            out["place_s"] = float(m.group(1))
        m = re.search(r"\[(\d+) tokens, ([\d.]+) tok/s\]", line)
        if m:
            out["generated_tokens"] = int(m.group(1))
            out["tokens_per_s"] = float(m.group(2))
    i = text.find('{\n "workers"')
    if i >= 0:
        out["status"] = json.JSONDecoder().raw_decode(text, i)[0]
    check("error:" not in text and len(out["texts"]) == len(CP_REQUESTS)
          and "place_s" in out and "status" in out,
          f"{label}: the REPL run did not finish: {text[-3000:]}")
    return out


def control_plane(torch, card, lap) -> dict:
    """o2: ``dlt-coordinator-torch --local-proc 1`` over a piped REPL script
    (init / assign / distribute / batch / status / exit) on a generated HF
    checkpoint, then an in-process Coordinator + WorkerHost on the same
    store: the same batch, and a ``worker.result:close`` drill retried on
    a respawned worker."""
    import dataclasses
    import threading

    from distributed_llms_tpu_torch.cluster.coordinator import Coordinator
    from distributed_llms_tpu_torch.cluster.worker import WorkerHost
    from distributed_llms_tpu_torch.core.config import load_config
    from distributed_llms_tpu_torch.core.observability import METRICS
    from distributed_llms_tpu_torch.runtime.faults import FaultPlane

    ckpt = tempfile.mkdtemp(prefix="dlt_hf_ckpt_")
    store = tempfile.mkdtemp(prefix="dlt_store_cp_")
    info = {}
    try:
        info["checkpoint"] = write_hf_checkpoint(torch, ckpt)
        _free(torch)
        lap("o2_checkpoint")
        script = "\n".join([
            f"init {ckpt} {CP_SHARDS}", f"assign {CP_SHARDS}", "distribute",
            "batch", *(f"{n} {p}" for p, n in CP_REQUESTS), "", "status",
            "exit"]) + "\n"
        overrides = [f"checkpoint.shard_dir={store}", *CP_OVERRIDES]
        base = _device_used(torch)
        peak = [base]
        done = threading.Event()

        def sample():
            while not done.is_set():
                peak[0] = max(peak[0], _device_used(torch))
                done.wait(0.2)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributed_llms_tpu_torch.cli.coordinator_main",
             "--host", "127.0.0.1", "--port", "0", "--local-proc", "1",
             *(x for o in overrides for x in ("--override", o))],
            cwd=str(REPO), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = proc.communicate(script, timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            raise SmokeFailure(f"control plane: the coordinator REPL timed "
                               f"out: {stdout[-2000:]} {stderr[-2000:]}")
        finally:
            done.set()
            sampler.join()
        info["repl_wall_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"control plane: the coordinator exited "
              f"{proc.returncode}: {stderr[-3000:]}")
        repl = _repl_out("control plane", stdout)
        info["worker_process_device_peak_gb"] = (peak[0] - base) / 1e9
        (caps,) = [w["capabilities"]
                   for w in repl["status"]["workers"].values()]
        check(caps["platform"] == "gpu" and caps["process_count"] == 1,
              f"control plane: the worker registered {caps}")
        check(repl["status"]["num_shards"] == CP_SHARDS,
              f"control plane: status {repl['status']}")
        info["repl"] = {k: v for k, v in repl.items()
                        if k not in ("texts", "status")}
        info["worker_caps"] = caps
        lap("o2_subprocess")
        # -- the in-process pair on the same store ----------------------------
        cfg = load_config(None, overrides)
        rt = cfg.runtime
        ccfg = dataclasses.replace(cfg.cluster, coordinator_host="127.0.0.1",
                                   coordinator_port=0)
        reqs = [{"prompt": p, "max_new_tokens": n} for p, n in CP_REQUESTS]
        want = [repl["texts"][i] for i in range(len(CP_REQUESTS))]
        info["text_chars"] = [len(t) for t in want]
        check(min(info["text_chars"]) > 0, "control plane: a batch text is "
              f"empty: {info['text_chars']}")

        async def pair():
            coord = Coordinator(ccfg)
            await coord.start()
            plane = FaultPlane()

            async def worker(faults):
                w = WorkerHost("127.0.0.1", coord.port, cfg=ccfg, rt=rt,
                               faults=faults)
                w.worker_id = "pod-0"  # a stable id: a respawn rejoins
                task = asyncio.create_task(w.run())
                for _ in range(3000):
                    if "pod-0" in coord.workers:
                        break
                    await asyncio.sleep(0.01)
                check("pod-0" in coord.workers, "control plane: the "
                      "in-process worker never registered")
                return w, task

            try:
                w, task = await worker(plane)
                coord.plan_shards(CP_SHARDS, store_dir=store)
                t = time.perf_counter()
                placed = await coord.place_shards()
                info["pair_place_s"] = time.perf_counter() - t
                check(placed["pod-0"]["loaded"] == list(range(CP_SHARDS)),
                      f"control plane: placed {placed}")
                reset_launches()
                t = time.perf_counter()
                out = await coord.generate_requests(reqs)
                info["pair_batch_s"] = time.perf_counter() - t
                info["launches"] = read_launches()
                info["pair_tokens_per_s"] = out["tokens_per_second"]
                check(out["text"] == want, "control plane: the in-process "
                      "pair's texts differ from the worker process's")
                # The drill: the worker dies at its answer; the task waits,
                # the worker respawns under its id, is re-placed, and the
                # retry lands.
                r0 = METRICS.get_counter("coordinator.tasks_retried")
                e0 = METRICS.get_counter("coordinator.evictions")
                rule = plane.add("worker.result", "close", when="1",
                                 tag="GENERATE")
                job = asyncio.create_task(coord.generate_requests(reqs))
                await task  # run() ends when its connection is cut
                check(rule.fired == 1, "control plane: the close drill "
                      "never fired")
                for _ in range(500):
                    if "pod-0" not in coord.workers:
                        break
                    await asyncio.sleep(0.01)
                w.engine = None
                del w
                _free(torch)
                t = time.perf_counter()
                w2, task2 = await worker(None)
                again = await asyncio.wait_for(job, 600)
                info["drill_recovery_s"] = time.perf_counter() - t
                check(again["text"] == want, "control plane: the retried "
                      "batch's texts differ")
                info["drill"] = {
                    "retried": METRICS.get_counter(
                        "coordinator.tasks_retried") - r0,
                    "evictions": METRICS.get_counter(
                        "coordinator.evictions") - e0}
                check(info["drill"]["retried"] >= 1
                      and info["drill"]["evictions"] >= 1,
                      f"control plane: no retry after the close: "
                      f"{info['drill']}")
                w2.stop()
                task2.cancel()
                w2.engine = None
            finally:
                await coord.stop()

        asyncio.run(pair())
        _free(torch)
        lap("o2_pair")
        longest = max(n for _, n in CP_REQUESTS)
        _launch_floor("control plane", info["launches"],
                      "paged_decode_attention", CP_LAYERS, longest - 1)
        emit("elastic", path="o2", card=card, layers=CP_LAYERS, **info)
        return info["launches"]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(store, ignore_errors=True)


def serve_elastic(torch) -> dict:
    """Path o: the elastic fleet (o1) and the source system's control
    plane (o2).  Returns the launches of both legs' own runs, summed."""
    from distributed_llms_tpu_torch.runtime import batcher as tb

    card = _card()
    lap = _lap("elastic_time")
    rec = _FleetRecorder(tb.ContinuousBatcher).install()
    out = {}
    try:
        _add(out, elastic_fleet(torch, card, lap, rec))
    finally:
        rec.uninstall()
    _add(out, control_plane(torch, card, lap))
    return out


# -- path p: data and tensor parallelism ---------------------------------------

# Path p's ranks are processes of one gloo group on the one card (two CUDA
# contexts on cuda:0: NCCL puts no two ranks of one communicator on one
# GPU), spawned through the users' entry points (dlt-serve-torch,
# dlt-host-torch) by :func:`mesh_rank`.  Their collectives are staged
# through host memory: a gloo number on one card, not a multi-GPU one.
MESH_TP = 2
MESH_ARGS = ["--paged-pages", "256", "--page-size", "64", "--prefix-cache",
             "--max-len", "1024", "--slots", "8", "--host", "127.0.0.1"]
MESH_BOOT_S = 300.0  # a rank's boot: python, torch, a 16 GB store's half
MESH_MEM_SHARE = 0.6  # each p1 rank under this share of the one-rank engine
MESH_AGREEMENT = 0.9  # teacher-forced greedy agreement (ROADMAP's bf16 rule)
MESH_LOGIT_PROMPT = ("Path p's logit check: the first decode step after "
                     "this prompt, on the mesh and on one rank.")
MESH_CP_PREFIX = ("Dispatch note for the quantized mesh: every reply quotes "
                  "the manifest line, the dock and the carrier, then a one-"
                  "line plan. Keep it short and factual; no invented ids. ")
MESH_CP_REQUESTS = [(MESH_CP_PREFIX + f"Case {i}: crate {i} at dock "
                     f"{3 + i}.", 16 + 8 * (i % 4)) for i in range(8)]
TRAIN_CKPT_LAYERS = 2
TRAIN_CKPT_T = 1025
LEGACY_LAYERS = 2
LEGACY_NEW = 16


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mesh_rank(kind: str, argv: list, stats_path: str) -> None:
    """One rank of path p, in its own process: ``dlt-serve-torch``
    (``kind`` "serve") or ``dlt-host-torch`` ("host") run through its
    ``main`` with counters around the kernels' wrappers, the decode steps
    and the batchers, and, for "serve", the first decode step's logits of
    :data:`MESH_LOGIT_PROMPT` on the mesh after boot (every rank takes the
    same forwards); at the end, what they saw goes to ``stats_path``
    (JSON; the logits beside it as .npy on rank 0).  ``kind`` "pipe" is
    path q's rank (:func:`pipe_rank`)."""
    if kind == "pipe":
        return pipe_rank(argv, stats_path)
    if kind == "seq":
        return seq_rank(argv, stats_path)
    if kind == "expert":
        return expert_rank(argv, stats_path)
    import numpy as np
    import torch

    from distributed_llms_tpu_torch.ops import decode_attn, quant_matmul
    from distributed_llms_tpu_torch.runtime import batcher as bl
    from distributed_llms_tpu_torch.runtime import engine as engine_lib

    stats = {"shapes": {}, "decode_steps_timed": 0, "decode_s": 0.0,
             "decode_collective_s": 0.0, "decode_collective_calls": 0,
             "streams": [], "rank": None}
    box: dict = {}

    def count(key):
        stats["shapes"][key] = stats["shapes"].get(key, 0) + 1

    pda = decode_attn.paged_decode_attention

    def paged(q, k, v, lengths, tables, *a, **kw):
        if q.is_cuda:
            quant = kw.get("k_scale") is not None or len(a) > 0
            count(f"K1{'q' if quant else ''}_H{q.shape[2]}_KVH{k.shape[2]}")
        return pda(q, k, v, lengths, tables, *a, **kw)

    qmm = quant_matmul.quant_matmul

    def qmatmul(x2, q2, s2, bits):
        if x2.is_cuda:
            count(f"K5_int{bits}_K{x2.shape[1]}_N{q2.shape[1]}")
        return qmm(x2, q2, s2, bits)

    for fn, attrs in ((paged, ("launches", "int8_launches")),
                      (qmatmul, ("launches", "int4_launches"))):
        for attr in attrs:
            setattr(fn, attr, 0)
    decode_attn.paged_decode_attention = paged
    quant_matmul.quant_matmul = qmatmul

    steps_fn = bl._decode_steps

    def decode_steps(*a, **kw):
        mesh = box["engine"].pm.mesh
        torch.cuda.synchronize()
        c0, n0 = mesh.stats["seconds"], mesh.stats["calls"]
        t0 = time.perf_counter()
        out = steps_fn(*a, **kw)
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t0
        stats["decode_steps_timed"] += a[5]
        stats["decode_collective_s"] += mesh.stats["seconds"] - c0
        stats["decode_collective_calls"] += mesh.stats["calls"] - n0
        return out

    bl._decode_steps = decode_steps
    cls = bl.ContinuousBatcher
    init, submit, run, activate = (cls.__init__, cls.submit, cls.run,
                                   cls._activate_row)

    def b_init(self, *a, **kw):
        init(self, *a, **kw)
        torch.cuda.synchronize()
        stats["mem_after_batcher"] = torch.cuda.memory_allocated()
        self._p_log = {"prompts": {}, "slots": {}}

    def b_submit(self, prompt, *a, **kw):
        rid = submit(self, prompt, *a, **kw)
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        self._p_log["prompts"][rid] = (ids, kw.get("temperature"))
        return rid

    def b_activate(self, i, req, *a, **kw):
        self._p_log["slots"][req.rid] = i
        return activate(self, i, req, *a, **kw)

    def b_run(self, *a, **kw):
        res = run(self, *a, **kw)
        for rid, toks in res.items():
            ids, temp = self._p_log["prompts"].get(rid, (None, None))
            if ids is not None:
                stats["streams"].append({
                    "rid": rid, "prompt": ids, "temperature": temp,
                    "stream": list(toks), "slot": self._p_log["slots"].get(rid),
                    "cached": int(self.prefix_cached_tokens.get(rid, 0))})
        stats["decode_steps"] = self.decode_steps
        stats["slots"] = self.b
        stats["loop"] = self.loop_kind
        return res

    cls.__init__, cls.submit, cls.run, cls._activate_row = (
        b_init, b_submit, b_run, b_activate)

    from_store = engine_lib.InferenceEngine.from_store.__func__

    def engine_from_store(c, *a, **kw):
        eng = from_store(c, *a, **kw)
        torch.cuda.synchronize()
        box["engine"] = eng
        stats["rank"] = eng.pm.mesh.rank
        stats["mesh"] = eng.pm.mesh.shape
        stats["backend"] = eng.pm.mesh.backend
        stats["mem_after_engine"] = torch.cuda.memory_allocated()
        if kind == "serve":
            logits = first_step_logits(torch, eng)
            if eng.pm.mesh.rank == 0:
                np.save(stats_path + ".logits.npy", logits)
        return eng

    engine_lib.InferenceEngine.from_store = classmethod(engine_from_store)
    try:
        if kind == "serve":
            from distributed_llms_tpu_torch.cli import serve_main

            serve_main.main(argv)
        else:
            from distributed_llms_tpu_torch.cli import host_main

            host_main.main(argv)
    finally:
        stats["launches"] = {
            "paged_decode_attention": decode_attn.paged_decode_attention.launches,
            "paged_decode_attention_int8":
                decode_attn.paged_decode_attention.int8_launches,
            "quant_matmul": quant_matmul.quant_matmul.launches,
            "quant_matmul_int4": quant_matmul.quant_matmul.int4_launches}
        if "engine" in box:
            stats["collectives_total"] = dict(box["engine"].pm.mesh.stats)
        with open(stats_path, "w") as f:
            json.dump(stats, f)


def first_step_logits(torch, eng):
    """float32 logits [V] of the first decode step after
    :data:`MESH_LOGIT_PROMPT` (its prefill into a contiguous cache, then
    the greedy token), through ``eng`` (a mesh engine or one rank)."""
    from distributed_llms_tpu_torch.models import model as model_lib

    ids = eng.tokenizer.encode(MESH_LOGIT_PROMPT)
    toks = torch.tensor([ids], device=eng.device)
    t = len(ids)
    cache = eng._make_cache(eng.run_cfg, 1, t + 1)
    with torch.no_grad(), eng._on_mesh():
        logits, cache = model_lib.forward(eng.params, eng.run_cfg, toks,
                                          cache=cache, cache_index=0)
        ci = torch.full((1,), t, dtype=torch.int32, device=eng.device)
        step, _ = model_lib.forward(
            eng.params, eng.run_cfg, logits[:, -1].argmax(-1)[:, None],
            positions=ci[:, None], cache=cache, cache_index=ci)
    return step[0, -1].float().cpu().numpy()


def _spawn_rank(kind, argv, stats_path, log_path):
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "chip_smoke.mesh_rank(%r, %r, %r)" % (str(REPO), kind, argv,
                                                    stats_path))
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    log = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-c", code], stdout=log,
                            stderr=subprocess.STDOUT, env=env, cwd=REPO)


def _reap(procs, logs, label, timeout=120.0) -> None:
    """Wait for every rank; a rank that fails, or does not end, fails the
    path (its log's tail in the message)."""
    deadline = time.monotonic() + timeout
    for p, log in zip(procs, logs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            tail = Path(log).read_text()[-3000:]
            raise SmokeFailure(f"{label}: a rank exited {p.returncode}:\n"
                               f"{tail}")


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _mesh_agreement(torch, eng, streams) -> dict:
    """Greedy agreement of ``streams`` (prompt ids, committed tokens) with
    ``eng``'s own greedy choice at every position, each fed the stream's
    context (one forward over prompt + stream)."""
    from distributed_llms_tpu_torch.models import model as model_lib

    agree = total = 0
    for s in streams:
        seq = s["prompt"] + s["stream"]
        if len(s["stream"]) < 1:
            continue
        toks = torch.tensor([seq[:-1]], device=eng.device)
        with torch.no_grad(), eng._on_mesh():
            logits, _ = model_lib.forward(eng.params, eng.run_cfg, toks)
        want = logits[0, len(s["prompt"]) - 1:].argmax(-1).tolist()
        agree += sum(int(a == b) for a, b in zip(want, s["stream"]))
        total += len(s["stream"])
        del logits
    return {"agree": agree, "tokens": total,
            "agreement": agree / max(total, 1)}


def _read_stats(paths) -> list:
    return [json.loads(Path(p).read_text()) for p in paths]


def mesh_tensor_parallel(torch, card, lap, store, tmp) -> dict:
    """p1: ``dlt-serve-torch --store SB`` on two ranks (model=2) over the
    one card, path a's requests over HTTP, held to a one-rank engine over
    the same store."""
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    dist_port, port = _free_port(), _free_port()
    stats = [f"{tmp}/p1_rank{r}.json" for r in range(MESH_TP)]
    logs = [f"{tmp}/p1_rank{r}.log" for r in range(MESH_TP)]
    procs = []
    for r in range(MESH_TP):
        argv = ["--store", store, *MESH_ARGS, "--port", str(port),
                "--override", f"mesh.model={MESH_TP}",
                "--override", f"cluster.num_processes={MESH_TP}",
                "--override", f"cluster.process_id={r}",
                "--override",
                f"cluster.distributed_coordinator=127.0.0.1:{dist_port}"]
        procs.append(_spawn_rank("serve", argv, stats[r], logs[r]))
    try:
        _wait_http(port, procs, logs, "mesh/p1")
        lap("p1_boot")
        t0 = time.perf_counter()
        served = asyncio.run(_serve_requests(port))
        http_s = time.perf_counter() - t0
        lap("p1_requests")
        procs[0].terminate()  # rank 0 drains and stops its followers
        _reap(procs, logs, "mesh/p1")
    finally:
        _kill(procs)
    from distributed_llms_tpu_torch.models.presets import get_preset

    cfg = get_preset("llama-3-8b", num_layers=STORE_LAYERS)
    ranks = _read_stats(stats)
    logits_mesh = __import__("numpy").load(stats[0] + ".logits.npy")
    local = (f"K1_H{cfg.num_heads // MESH_TP}"
             f"_KVH{cfg.num_kv_heads // MESH_TP}")
    for r, st in enumerate(ranks):
        steps = st["decode_steps"]
        k1 = st["launches"]["paged_decode_attention"]
        check(st["backend"] == "gloo" and st["loop"] == "eager",
              f"mesh/p1: rank {r} not on gloo's eager step loop")
        check(steps > 0 and k1 >= cfg.num_layers * steps,
              f"mesh/p1: rank {r} launched K1 {k1} times, under "
              f"{cfg.num_layers} layers x {steps} decode steps")
        check(set(st["shapes"]) == {local},
              f"mesh/p1: rank {r} launched K1 at {st['shapes']}, not only "
              f"at the local heads ({local})")
    # The one-rank engine over the same store, its batcher as the ranks'.
    eng = InferenceEngine.from_store(store)
    b = eng.continuous_batcher(batch_slots=8, max_len=1024, paged_pages=256,
                               page_size=64, prefix_cache=True)
    torch.cuda.synchronize()
    one_mem = torch.cuda.memory_allocated()
    logits_one = first_step_logits(torch, eng)
    greedy = [s for s in ranks[0]["streams"]
              if s["temperature"] in (None, 0.0) and s["stream"]]
    tf = _mesh_agreement(torch, eng, greedy)
    del b, eng
    _free(torch)
    lap("p1_one_rank")
    diff = float(abs(logits_mesh - logits_one).max())
    per_rank = [{
        "rank": st["rank"], "loop": st["loop"],
        "decode_steps": st["decode_steps"],
        "k1_launches": st["launches"]["paged_decode_attention"],
        "launch_shapes": st["shapes"],
        "mem_after_boot_gb": st["mem_after_batcher"] / 1e9,
        "mem_share_of_one_rank": st["mem_after_batcher"] / one_mem,
        "ms_per_decode_step": st["decode_s"] * 1e3
        / max(st["decode_steps_timed"], 1),
        "collective_share_of_step": st["decode_collective_s"]
        / max(st["decode_s"], 1e-9),
        "collectives_per_step": st["decode_collective_calls"]
        / max(st["decode_steps_timed"], 1)} for st in ranks]
    emit("mesh_p1", card=card, mesh={"model": MESH_TP}, backend="gloo",
         ranks=per_rank, one_rank_mem_gb=one_mem / 1e9,
         first_step_logits_max_abs_diff=diff,
         first_step_logits_scale=float(abs(logits_one).max()),
         teacher_forced=tf, greedy_streams=len(greedy), http_s=http_s,
         served={k: v for k, v in served.items() if k != "texts"})
    for r in per_rank:
        check(r["mem_share_of_one_rank"] < MESH_MEM_SHARE,
              f"mesh/p1: rank {r['rank']} holds "
              f"{r['mem_share_of_one_rank']:.2f} of the one-rank engine")
    check(tf["tokens"] > 0 and tf["agreement"] >= MESH_AGREEMENT,
          f"mesh/p1: greedy agreement {tf['agreement']:.3f} under "
          f"{MESH_AGREEMENT}")
    return {"paged_decode_attention": [r["k1_launches"] for r in per_rank]}


def _wait_http(port, procs, logs, label) -> None:
    import urllib.request

    deadline = time.monotonic() + MESH_BOOT_S
    while time.monotonic() < deadline:
        for p, log in zip(procs, logs):
            if p.poll() is not None:
                raise SmokeFailure(f"{label}: a rank exited {p.returncode} "
                                   f"at boot:\n{Path(log).read_text()[-3000:]}")
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=2)
            return
        except OSError:
            time.sleep(0.5)
    raise SmokeFailure(f"{label}: no server after {MESH_BOOT_S} s")


def mesh_control_plane(torch, card, lap, store, tmp, data, model) -> dict:
    """p2: two ``dlt-host-torch`` processes (``cluster.num_processes=2``,
    a data x model mesh) over path d's int8 store with int8 pages, under
    an in-process ``Coordinator``: PLACE_SHARDS, the 8-request batch
    through ``generate_requests`` (broadcast to both, the mesh batcher)
    and its prompts through ``generate_spmd``."""
    from distributed_llms_tpu_torch.cluster.coordinator import Coordinator
    from distributed_llms_tpu_torch.core.config import ClusterConfig

    label = f"mesh/p2_dp{data}tp{model}"
    tag = f"p2_dp{data}tp{model}"
    dist_port = _free_port()
    stats = [f"{tmp}/{tag}_rank{r}.json" for r in range(2)]
    logs = [f"{tmp}/{tag}_rank{r}.log" for r in range(2)]
    reqs = [{"prompt": p, "max_new_tokens": n} for p, n in MESH_CP_REQUESTS]

    async def drive():
        coord = Coordinator(ClusterConfig(
            coordinator_host="127.0.0.1", coordinator_port=0,
            heartbeat_interval_s=0.5, heartbeat_timeout_s=600.0,
            task_timeout_s=600.0))
        await coord.start()
        procs = []
        try:
            for r in range(2):
                argv = ["--host", "127.0.0.1", "--port", str(coord.port),
                        "--worker-id", f"{tag}-rank{r}",
                        "--override", "cluster.num_processes=2",
                        "--override", f"cluster.process_id={r}",
                        "--override", "cluster.distributed_coordinator="
                                      f"127.0.0.1:{dist_port}",
                        "--override", "cluster.heartbeat_interval_s=0.5",
                        "--override", f"mesh.data={data}",
                        "--override", f"mesh.model={model}",
                        *_p2_runtime_overrides()]
                procs.append(_spawn_rank("host", argv, stats[r], logs[r]))
            deadline = time.monotonic() + MESH_BOOT_S
            while len(coord.workers) < 2:
                for p, log in zip(procs, logs):
                    if p.poll() is not None:
                        raise SmokeFailure(
                            f"{label}: a host exited {p.returncode}:\n"
                            f"{Path(log).read_text()[-3000:]}")
                check(time.monotonic() < deadline, f"{label}: no workers")
                await asyncio.sleep(0.2)
            check(all(w.capabilities["process_count"] == 2
                      for w in coord.workers.values()),
                  f"{label}: workers do not report 2 processes")
            coord.plan_shards(2, store_dir=store)
            placed = await coord.place_shards(timeout=600.0)
            check(all("mesh" in r.get("resident", "")
                      for r in placed.values()), f"{label}: {placed}")
            lap(f"{tag}_place")
            t0 = time.perf_counter()
            batch = await coord.generate_requests(reqs, timeout=600.0)
            batch_s = time.perf_counter() - t0
            spmd = await coord.generate_spmd([r["prompt"] for r in reqs[:4]],
                                             max_new_tokens=16)
            lap(f"{tag}_batch")
            for wid in list(coord.workers):
                await coord.submit("SHUTDOWN", {}, worker_id=wid,
                                   timeout=60.0)
            await asyncio.to_thread(_reap, procs, logs, label)
            return batch, batch_s, spmd
        finally:
            _kill(procs)
            await coord.stop()

    from distributed_llms_tpu_torch.models.presets import get_preset

    batch, batch_s, spmd = asyncio.run(drive())
    ranks = _read_stats(stats)
    cfg = get_preset("llama-3-8b")
    d, f = cfg.hidden_size, cfg.intermediate_size // model
    want_k1q = (f"K1q_H{cfg.num_heads // model}"
                f"_KVH{cfg.num_kv_heads // model}")
    per_rank = []
    for r, st in enumerate(ranks):
        shapes = st["shapes"]
        check(shapes.get(want_k1q, 0) > 0,
              f"{label}: rank {r} launched no K1q at {want_k1q}: {shapes}")
        check(all(not k.startswith("K1_") for k in shapes),
              f"{label}: rank {r} launched K1 on an int8 pool: {shapes}")
        check(shapes.get(f"K5_int8_K{d}_N{f}", 0) > 0
              and shapes.get(f"K5_int8_K{f}_N{d}", 0) > 0,
              f"{label}: rank {r} ran no K5 at the local gate/up and down "
              f"shapes: {shapes}")
        per_rank.append({"rank": st["rank"], "launch_shapes": shapes,
                         "launches": st["launches"],
                         "decode_steps": st.get("decode_steps"),
                         "mem_after_engine_gb": st["mem_after_engine"] / 1e9,
                         "ms_per_decode_step": st["decode_s"] * 1e3
                         / max(st["decode_steps_timed"], 1),
                         "collective_share_of_step":
                             st["decode_collective_s"]
                             / max(st["decode_s"], 1e-9)})
    streams = [s for s in ranks[0]["streams"] if s["stream"]]
    check(len(streams) == len(reqs), f"{label}: {len(streams)} streams seen")
    check(all(s["stream"] == t["stream"] for s, t in
              zip(streams, ranks[1]["streams"])),
          f"{label}: the ranks' streams differ")
    cross = None
    if data > 1:
        half = ranks[0]["slots"] // data
        writers = [s for s in streams if s["slot"] < half and s["cached"] == 0]
        readers = [s for s in streams if s["slot"] >= half and s["cached"] > 0]
        check(writers and readers, f"{label}: no request on data rank 1 "
              "reused a prefix page that data rank 0 wrote: "
              f"{[(s['slot'], s['cached']) for s in streams]}")
        cross = {"reader_slot": readers[0]["slot"],
                 "cached_tokens": readers[0]["cached"],
                 "writer_slot": writers[0]["slot"]}
    return {"per_rank": per_rank, "streams": streams, "batch_s": batch_s,
            "spmd_texts": spmd["text"], "batch_texts": batch["text"],
            "cross_data_hit": cross}


def _p2_runtime_overrides() -> list:
    return [a for kv in ("runtime.serve_quantized=true", "runtime.kv_bits=8",
                         "runtime.paged_pages=256", "runtime.page_size=64",
                         "runtime.prefix_cache=true",
                         "runtime.max_seq_len=1024",
                         "runtime.max_decode_steps=16")
            for a in ("--override", kv)]


def mesh_p2(torch, card, lap, tmp) -> dict:
    """p2 on both meshes, held to one rank's worker engine."""
    from distributed_llms_tpu_torch.core.config import load_config
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    store = f"{tmp}/p2_store"
    info = write_store(torch, "int8", store, "llama-3-8b",
                       num_layers=STORE_LAYERS)
    lap("p2_store")
    legs = {}
    try:
        for data, model in ((1, 2), (2, 1)):
            legs[f"dp{data}tp{model}"] = mesh_control_plane(
                torch, card, lap, store, tmp, data, model)
        rt = load_config(None, [kv for kv in _p2_runtime_overrides()
                                if kv != "--override"]).runtime
        eng = InferenceEngine.from_store(store, rt=rt)
        out = {}
        for name, leg in legs.items():
            tf = _mesh_agreement(torch, eng, leg["streams"])
            out[name] = {**{k: v for k, v in leg.items() if k != "streams"},
                         "teacher_forced": tf}
            check(tf["agreement"] >= MESH_AGREEMENT,
                  f"mesh/p2 {name}: greedy agreement {tf['agreement']:.3f} "
                  f"under {MESH_AGREEMENT}")
        del eng
        _free(torch)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    lap("p2_one_rank")
    emit("mesh_p2", card=card, store=info, legs=out)
    return {
        "quant_matmul": [r["launches"]["quant_matmul"]
                         for leg in legs.values() for r in leg["per_rank"]],
        "paged_decode_attention_int8": [
            r["launches"]["paged_decode_attention_int8"]
            for leg in legs.values() for r in leg["per_rank"]]}


def mesh_native_read(torch, card, store) -> None:
    """p3: every array of store SB read by the native reader and by the
    plain one: the same bytes and CRC32s; both times (the store was
    written earlier in this process, by path n or here, and nothing drops
    the page cache: warm unless the host evicted some of it)."""
    import numpy as np

    from distributed_llms_tpu_torch import native
    from distributed_llms_tpu_torch.checkpoint import store as store_lib

    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    man = store_lib.load_manifest(store)
    metas = list(man["arrays"].values())
    tasks = [(f"{store}/shard_{m['shard']}.bin", m["offset"], m["nbytes"])
             for m in metas]
    total = sum(m["nbytes"] for m in metas)
    native_s = plain_s = 0.0
    i = 0
    while i < len(tasks):
        j, size = i, 0
        while j < len(tasks) and (size == 0
                                  or size + tasks[j][2] <= 1 << 30):
            size += tasks[j][2]
            j += 1
        t0 = time.perf_counter()
        bufs, crcs = native.read_segments(tasks[i:j])
        native_s += time.perf_counter() - t0
        for (path, off, nb), buf, crc, m in zip(tasks[i:j], bufs, crcs,
                                                metas[i:j]):
            t0 = time.perf_counter()
            plain = store_lib._read_checked(path, off, nb, m["crc32"])
            plain_s += time.perf_counter() - t0
            check(crc == m["crc32"], f"mesh/p3: native CRC of {path}@{off}")
            check(np.array_equal(buf, plain), f"mesh/p3: bytes of {path}@{off}")
        del bufs
        i = j
    emit("mesh_p3_read", card=card, store_bytes=total, arrays=len(tasks),
         native_s=native_s, plain_s=plain_s, native_build_s=build_s,
         native_gb_per_s=total / native_s / 1e9,
         plain_gb_per_s=total / plain_s / 1e9, page_cache="written earlier in this process, not dropped")


def mesh_train_ckpt(torch, card, tmp) -> None:
    """p3: a ``Trainer`` at path g's width cut to TRAIN_CKPT_LAYERS layers:
    2 steps, save, restore into a fresh ``Trainer``, 1 step; its loss
    equals 3 uninterrupted steps' within 1e-3."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import train, train_ckpt

    cfg = get_preset("llama-3-8b", attn_impl="flash",
                     num_layers=TRAIN_CKPT_LAYERS)
    batch = torch.randint(0, cfg.vocab_size, (2, TRAIN_CKPT_T), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))

    def fresh():
        params = model_lib.init_params(
            cfg, generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        trainer = train.Trainer(cfg, train.default_optimizer(1e-3))
        return params, trainer, trainer.init(params)

    params, trainer, state = fresh()
    step = trainer.make_step()
    straight = []
    for _ in range(3):
        params, state, loss = step(params, state, batch, None)
        straight.append(float(loss))
    del params, state
    _free(torch)
    params, trainer, state = fresh()
    step = trainer.make_step()
    for _ in range(2):
        params, state, _ = step(params, state, batch, None)
    ckpt = f"{tmp}/train_ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = train_ckpt.save_train_state(ckpt, 2, params, state)
    save_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in Path(path).iterdir())
    del params, state, trainer, step
    _free(torch)
    t0 = time.perf_counter()
    n, params, state = train_ckpt.restore_train_state(ckpt, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    trainer = train.Trainer(cfg, train.default_optimizer(1e-3))
    params, state, loss = trainer.make_step()(params, state, batch, None)
    resumed = float(loss)
    shutil.rmtree(ckpt, ignore_errors=True)
    del params, state
    _free(torch)
    emit("mesh_p3_train_ckpt", card=card, layers=TRAIN_CKPT_LAYERS,
         batch=[2, TRAIN_CKPT_T], losses_straight=straight,
         loss_resumed=resumed, checkpoint_bytes=nbytes, save_s=save_s,
         restore_s=restore_s, restored_step=n)
    check(n == 2 and abs(resumed - straight[2]) <= 1e-3,
          f"mesh/p3: resumed loss {resumed} vs {straight[2]}")


def mesh_legacy_int4(torch, card, tmp) -> int:
    """p3: a legacy int4 store (pairs along each weight's last axis, no
    pack_axis in the manifest) serves through K5 with the same greedy
    tokens as the same codes in the current layout.  Returns the legacy
    engine's int4 K5 launches."""
    from distributed_llms_tpu_torch.checkpoint import quantize as quant_lib
    from distributed_llms_tpu_torch.checkpoint.store import (load_manifest,
                                                             save_shards)
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    cfg = get_preset("llama-3-8b", num_layers=LEGACY_LAYERS)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    outs = {}
    for name in ("legacy", "current"):
        def quant(tree, path):
            if isinstance(tree, dict):
                return {k: quant(v, f"{path}/{k}") for k, v in tree.items()}
            should, axis = quant_lib.leaf_plan(path.lstrip("/"), tree[0])
            if not should or tree.dim() < 3:
                return tree
            return quant_lib.quantize(tree, bits=4,
                                      pack_axis=-1 if name == "legacy"
                                      else axis)

        tree = {k: (quant(v, f"/{k}") if k == "blocks" else v)
                for k, v in params.items()}
        path = f"{tmp}/legacy_{name}"
        save_shards(tree, path, num_shards=2, model_config=cfg)
        man = load_manifest(path)
        man["quantization"] = "int4"
        if name == "legacy":
            for entry in man["params"].values():
                entry.pop("pack_axis", None)
        Path(path, "manifest.json").write_text(json.dumps(man))
        del tree
        reset_launches()
        eng = InferenceEngine.from_store(path, rt=RuntimeConfig(
            serve_quantized=True, max_decode_steps=LEGACY_NEW))
        out = eng.generate_text(list(GEN_PROMPTS[:4]),
                                max_new_tokens=LEGACY_NEW)
        outs[name] = (out.tokens.tolist(), read_launches()["quant_matmul_int4"],
                      eng.params["blocks"]["attn"]["wq"].pack_axis)
        del eng
        _free(torch)
        shutil.rmtree(path, ignore_errors=True)
    del params
    _free(torch)
    emit("mesh_p3_legacy_int4", card=card, layers=LEGACY_LAYERS,
         k5_int4_launches={k: v[1] for k, v in outs.items()},
         wq_pack_axis={k: v[2] for k, v in outs.items()},
         tokens_equal=outs["legacy"][0] == outs["current"][0])
    check(outs["legacy"][1] > 0, "mesh/p3: the legacy store ran no K5 int4")
    check(outs["legacy"][0] == outs["current"][0],
          "mesh/p3: the legacy store's greedy tokens differ from the "
          "current layout's")
    return outs["legacy"][1]


def serve_mesh(torch) -> dict:
    """Path p: tensor parallelism over HTTP at Llama-3-8B's full width
    cut to STORE_LAYERS layers (p1), data and tensor parallelism through the control plane over
    an int8 store (p2), and the leftovers (p3: the native reader, training
    checkpoints, a legacy int4 store).  Returns each kernel's launches per
    rank on the mesh legs."""
    card = _card()
    lap = _lap("mesh_time")
    tmp = tempfile.mkdtemp(prefix="dlt_mesh_")
    out: dict = {}
    try:
        # Cut from 32 layers (to keep the whole smoke near 1000 s of
        # phases beside path r): every layer keeps the published width,
        # so each K1 launch is at the full model's local heads.  The store
        # is paths n and o1's, written once.
        store, info, wrote = shared_store(torch, "llama_bf16_cut",
                                          _write_llama_cut)
        emit("mesh_store", card=card, written_here=wrote, **info)
        lap("p1_store")
        out.update(mesh_tensor_parallel(torch, card, lap, store, tmp))
        mesh_native_read(torch, card, store)
        lap("p3_read")
        drop_shared_store("llama_bf16_cut")
        out.update(mesh_p2(torch, card, lap, tmp))
        mesh_train_ckpt(torch, card, tmp)
        lap("p3_train_ckpt")
        out["quant_matmul_int4"] = [mesh_legacy_int4(torch, card, tmp)]
        lap("p3_legacy")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- path q: the pipeline --------------------------------------------------

PIPE_STAGES = 2
PIPE_MICROBATCHES = 2
PIPE_MEM_SHARE = 0.6  # each stage under this share of the one-rank engine
PIPE_PROMPT = "Pipeline note {i}: route crate {i} via dock {d}."
PIPE_REQUESTS = [(PIPE_PROMPT.format(i=i, d=3 + i), 8 + 4 * (i % 4))
                 for i in range(8)]
PIPE_SPMD_NEW = 16
# The one sampled generate_spmd call: its ranks serve it at this
# temperature and top-k (the control plane's generate carries no sampling
# knobs; pipe_rank switches them for this prompt alone).
PIPE_SAMPLED_PROMPT = "Pipeline note 9: a sampled reply, seed 0."
PIPE_SAMPLING = {"temperature": 0.8, "top_k": 50}


def pipe_rank(argv: list, stats_path: str) -> None:
    """One rank of path q, in its own process: ``dlt-host-torch`` run
    through its ``main`` on a pipelined mesh, with counters around K5's
    wrapper (int8 launches by shape), the stage computes
    (``pipeline.stage_forward``), the wavefront decode (device-synced wall
    time, ticks, ring-shift seconds) and ``generate_text`` (each row's
    prompt ids and tokens); after boot, its memory and the first decode
    step's logits of :data:`MESH_LOGIT_PROMPT` through the pipelined
    forward.  At the end, what it saw goes to ``stats_path`` (JSON; the
    logits beside it as .npy on rank 0)."""
    import dataclasses

    import numpy as np
    import torch

    from distributed_llms_tpu_torch.ops import quant_matmul
    from distributed_llms_tpu_torch.parallel import pipeline
    from distributed_llms_tpu_torch.runtime import engine as engine_lib

    stats = {"shapes": {}, "stage_computes": 0, "decodes": [], "rows": [],
             "rank": None}
    box: dict = {}
    qmm = quant_matmul.quant_matmul

    def qmatmul(x2, q2, s2, bits):
        if x2.is_cuda:
            key = f"K5_int{bits}_K{x2.shape[1]}_N{q2.shape[1]}"
            stats["shapes"][key] = stats["shapes"].get(key, 0) + 1
        return qmm(x2, q2, s2, bits)

    qmatmul.launches = qmatmul.int4_launches = 0
    quant_matmul.quant_matmul = qmatmul
    stage_fn = pipeline.stage_forward

    def stage_forward(*a, **kw):
        stats["stage_computes"] += 1
        return stage_fn(*a, **kw)

    pipeline.stage_forward = stage_forward
    decode_fn = pipeline.pipeline_decode

    def pipeline_decode(mesh, cfg, params, tok0, lens, t, ck, cv, n, m,
                        *a, **kw):
        torch.cuda.synchronize()
        s0, c0 = mesh.stats["shift_seconds"], stats["stage_computes"]
        t0 = time.perf_counter()
        out = decode_fn(mesh, cfg, params, tok0, lens, t, ck, cv, n, m,
                        *a, **kw)
        torch.cuda.synchronize()
        p = mesh.size("pipe")
        q = max(m, p)
        stats["decodes"].append({
            "rows": int(tok0.shape[0]), "new_tokens": n, "microbatches": m,
            "ticks": (n - 1) * q + m + p - 1, "ticks_per_round": q,
            "stage_computes": stats["stage_computes"] - c0,
            "seconds": time.perf_counter() - t0,
            "shift_seconds": mesh.stats["shift_seconds"] - s0})
        return out

    pipeline.pipeline_decode = pipeline_decode
    cls = engine_lib.InferenceEngine
    generate_text = cls.generate_text

    def gen_text(self, prompts, max_new_tokens=None, seed=None):
        rt = self.rt
        if list(prompts) == [PIPE_SAMPLED_PROMPT]:
            self.rt = dataclasses.replace(rt, **PIPE_SAMPLING)
        try:
            res = generate_text(self, prompts, max_new_tokens, seed)
        finally:
            self.rt = rt
        for prompt, row in zip(prompts, res.tokens):
            stats["rows"].append({
                "prompt": self.tokenizer.encode(prompt),
                "tokens": [int(x) for x in row],
                "sampled": prompt == PIPE_SAMPLED_PROMPT})
        return res

    cls.generate_text = gen_text
    from_store = cls.from_store.__func__

    def engine_from_store(c, *a, **kw):
        eng = from_store(c, *a, **kw)
        torch.cuda.synchronize()
        box["engine"] = eng
        mesh = eng.pm.mesh
        stats.update(rank=mesh.rank, stage=eng.pm.stage, mesh=mesh.shape,
                     backend=mesh.backend, groups=sorted(eng.params),
                     mem_after_engine=torch.cuda.memory_allocated())
        logits = pipe_first_step_logits(torch, eng)
        if mesh.rank == 0:
            np.save(stats_path + ".logits.npy", logits)
        return eng

    cls.from_store = classmethod(engine_from_store)
    try:
        from distributed_llms_tpu_torch.cli import host_main

        host_main.main(argv)
    finally:
        stats["k5_int8_launches"] = qmatmul.launches
        stats["k5_int4_launches"] = qmatmul.int4_launches
        if "engine" in box:
            stats["collectives"] = dict(box["engine"].pm.mesh.stats)
        with open(stats_path, "w") as f:
            json.dump(stats, f)


def pipe_first_step_logits(torch, eng):
    """float32 logits [V] of the first decode step after
    :data:`MESH_LOGIT_PROMPT` through a pipelined engine's forward: the
    prompt's prefill into the stages' caches (one row a microbatch), then
    the greedy token at the next slot; every rank returns them."""
    pm = eng.pm
    ids = eng.tokenizer.encode(MESH_LOGIT_PROMPT)
    rows = pm.num_microbatches
    toks = torch.tensor([ids] * rows, device=eng.device)
    t = len(ids)
    cache = pm.init_cache(rows, t + 1)
    logits, cache = pm.forward(eng.params, toks, cache=cache, cache_index=0)
    step, _ = pm.forward(eng.params, logits[:, -1].argmax(-1)[:, None],
                         cache=cache, cache_index=t)
    return step[0, -1].float().cpu().numpy()


def _pipe_streams(ranks) -> tuple:
    """Rank 0's greedy and sampled rows as committed: the batch's rows cut
    to each request's budget, every row at its first EOS (the worker's
    grouped fallback)."""
    from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

    eos = ByteTokenizer().eos_id
    budgets = [n for _, n in PIPE_REQUESTS]
    rows = ranks[0]["rows"]

    def cut(toks, n):
        toks = toks[:n]
        return toks[:toks.index(eos) + 1] if eos in toks else toks

    batch = [cut(r["tokens"], n) for r, n in zip(rows[:8], budgets)]
    rest = [cut(r["tokens"], len(r["tokens"])) for r in rows[8:]]
    streams = [{"prompt": r["prompt"], "stream": s, "sampled": r["sampled"]}
               for r, s in zip(rows, batch + rest)]
    return ([s for s in streams if not s["sampled"]],
            [s for s in streams if s["sampled"]])


def _write_llama_int8(torch, out_dir: str) -> dict:
    """Paths q and r's store: Llama-3-8B at its full width and published
    32 layers, weight-only int8."""
    return write_store(torch, "int8", out_dir, "llama-3-8b")


def serve_pipe(torch) -> dict:
    """Path q: pipeline parallelism at Llama-3-8B's full width and its
    published 32 layers, weight-only int8 (random weights, seed 0): two
    ``dlt-host-torch`` ranks (``mesh.pipe=2``, ``runtime.microbatches=2``,
    16 layers a stage, K5 on every projection) share the card over gloo
    under an in-process ``Coordinator``.  The 8-request mixed-budget batch
    through ``generate_requests`` (the grouped fallback: the wavefront at
    the longest budget), then four prompts through ``generate_spmd``, one
    of them sampled; held to a one-rank engine over the same store.
    Returns K5's launches, one count a rank."""
    from distributed_llms_tpu_torch.cluster.coordinator import Coordinator
    from distributed_llms_tpu_torch.core.config import (ClusterConfig,
                                                         load_config)
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    card = _card()
    lap = _lap("pipe_time")
    label = "pipe/q"
    tmp = tempfile.mkdtemp(prefix="dlt_pipe_")
    overrides = ["runtime.serve_quantized=true", "runtime.max_seq_len=1024",
                 f"runtime.max_decode_steps={PIPE_SPMD_NEW}",
                 f"runtime.microbatches={PIPE_MICROBATCHES}"]
    stats = [f"{tmp}/q_rank{r}.json" for r in range(PIPE_STAGES)]
    logs = [f"{tmp}/q_rank{r}.log" for r in range(PIPE_STAGES)]
    reqs = [{"prompt": p, "max_new_tokens": n} for p, n in PIPE_REQUESTS]
    greedy_spmd = [p for p, _ in PIPE_REQUESTS[:3]]

    async def drive():
        coord = Coordinator(ClusterConfig(
            coordinator_host="127.0.0.1", coordinator_port=0,
            heartbeat_interval_s=0.5, heartbeat_timeout_s=600.0,
            task_timeout_s=600.0))
        await coord.start()
        dist_port = _free_port()
        procs = []
        try:
            for r in range(PIPE_STAGES):
                argv = ["--host", "127.0.0.1", "--port", str(coord.port),
                        "--worker-id", f"q-rank{r}",
                        "--override", f"cluster.num_processes={PIPE_STAGES}",
                        "--override", f"cluster.process_id={r}",
                        "--override", "cluster.distributed_coordinator="
                                      f"127.0.0.1:{dist_port}",
                        "--override", "cluster.heartbeat_interval_s=0.5",
                        "--override", f"mesh.pipe={PIPE_STAGES}",
                        *[a for kv in overrides for a in ("--override", kv)]]
                procs.append(_spawn_rank("pipe", argv, stats[r], logs[r]))
            deadline = time.monotonic() + MESH_BOOT_S
            while len(coord.workers) < PIPE_STAGES:
                for p, log in zip(procs, logs):
                    if p.poll() is not None:
                        raise SmokeFailure(
                            f"{label}: a host exited {p.returncode}:\n"
                            f"{Path(log).read_text()[-3000:]}")
                check(time.monotonic() < deadline, f"{label}: no workers")
                await asyncio.sleep(0.2)
            check(all(w.capabilities["process_count"] == PIPE_STAGES
                      for w in coord.workers.values()),
                  f"{label}: workers do not report {PIPE_STAGES} processes")
            coord.plan_shards(2, store_dir=store)
            placed = await coord.place_shards(timeout=600.0)
            check(all("'pipe': 2" in r.get("resident", "")
                      for r in placed.values()), f"{label}: {placed}")
            lap("boot_place")
            t0 = time.perf_counter()
            batch = await coord.generate_requests(reqs, timeout=600.0)
            batch_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            spmd = await coord.generate_spmd(greedy_spmd,
                                             max_new_tokens=PIPE_SPMD_NEW)
            spmd_s = time.perf_counter() - t0
            sampled = await coord.generate_spmd([PIPE_SAMPLED_PROMPT],
                                                max_new_tokens=PIPE_SPMD_NEW)
            lap("requests")
            for wid in list(coord.workers):
                await coord.submit("SHUTDOWN", {}, worker_id=wid,
                                   timeout=60.0)
            await asyncio.to_thread(_reap, procs, logs, label)
            return batch, batch_s, spmd, spmd_s, sampled
        finally:
            _kill(procs)
            await coord.stop()

    try:
        store, info, _ = shared_store(torch, "llama_int8", _write_llama_int8)
        lap("store")
        batch, batch_s, spmd, spmd_s, sampled = asyncio.run(drive())
        ranks = _read_stats(stats)
        logits_pipe = __import__("numpy").load(stats[0] + ".logits.npy")
        greedy, sampled_rows = _pipe_streams(ranks)
        rt = load_config(None, overrides).runtime
        # The engine's own bytes: what the process still holds from the
        # phases before is not the one-rank engine's.
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        eng = InferenceEngine.from_store(store, rt=rt)
        torch.cuda.synchronize()
        one_mem = torch.cuda.memory_allocated() - held
        logits_one = first_step_logits(torch, eng)
        tf = _mesh_agreement(torch, eng, greedy)
        del eng
        _free(torch)
        lap("one_rank")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = get_preset("llama-3-8b")
    per_stage = cfg.num_layers // PIPE_STAGES
    diff = float(abs(logits_pipe - logits_one).max())
    per_rank = []
    for r, st in enumerate(ranks):
        computes = st["stage_computes"]
        k5 = st["k5_int8_launches"]
        check(st["backend"] == "gloo" and st["stage"] == r,
              f"{label}: rank {r} is stage {st['stage']} on {st['backend']}")
        check(computes > 0 and k5 >= 7 * per_stage * computes,
              f"{label}: rank {r} launched K5 {k5} times, under 7 x "
              f"{per_stage} layers x {computes} stage computes")
        check(st["k5_int4_launches"] == 0,
              f"{label}: rank {r} launched K5 int4 on an int8 store")
        dec = st["decodes"]
        dec_s = sum(d["seconds"] for d in dec)
        ticks = sum(d["ticks"] for d in dec)
        shift_s = sum(d["shift_seconds"] for d in dec)
        per_rank.append({
            "rank": st["rank"], "stage": st["stage"], "groups": st["groups"],
            "k5_int8_launches": k5, "stage_computes": computes,
            "launch_shapes": st["shapes"],
            "mem_after_boot_gb": st["mem_after_engine"] / 1e9,
            "mem_share_of_one_rank": st["mem_after_engine"] / one_mem,
            "decodes": dec, "decode_ticks": ticks,
            "ms_per_tick": dec_s * 1e3 / max(ticks, 1),
            "ms_per_token_round": dec_s * 1e3 / max(ticks, 1)
            * max(PIPE_MICROBATCHES, PIPE_STAGES),
            "shift_share_of_decode": shift_s / max(dec_s, 1e-9),
            "collectives": st.get("collectives")})
    emit("pipe_q", card=card, mesh={"pipe": PIPE_STAGES},
         microbatches=PIPE_MICROBATCHES, backend="gloo", store=info,
         ranks=per_rank, one_rank_mem_gb=one_mem / 1e9,
         first_step_logits_max_abs_diff=diff,
         first_step_logits_scale=float(abs(logits_one).max()),
         teacher_forced=tf, greedy_streams=len(greedy),
         sampled_rows=len(sampled_rows), batch_s=batch_s, spmd_s=spmd_s,
         batch_generated_tokens=batch["generated_tokens"])
    check(len(ranks[0]["rows"]) == len(reqs) + len(greedy_spmd) + 1
          and ranks[0]["rows"] == ranks[1]["rows"],
          f"{label}: the ranks' generated rows differ")
    check(len(batch["text"]) == len(reqs) and len(spmd["text"]) == 3
          and len(sampled["text"]) == 1 and len(sampled_rows) == 1,
          f"{label}: {len(batch['text'])} batch, {len(spmd['text'])} spmd "
          f"texts")
    for r in per_rank:
        check(r["mem_share_of_one_rank"] < PIPE_MEM_SHARE,
              f"{label}: rank {r['rank']} holds "
              f"{r['mem_share_of_one_rank']:.3f} of the one-rank engine")
    check(tf["tokens"] > 0 and tf["agreement"] >= MESH_AGREEMENT,
          f"{label}: greedy agreement {tf['agreement']:.3f} under "
          f"{MESH_AGREEMENT}")
    return {"quant_matmul": [r["k5_int8_launches"] for r in per_rank]}


# -- path r: sequence parallelism ------------------------------------------------

SEQ_RANKS = 2
SEQ_MAX_LEN = 8192  # Llama-3-8B's published context
SEQ_NEW = 16
# 8000 prompt bytes + BOS: 8001 tokens, right-padded to 8002 (a multiple
# of the 'seq' axis), so each rank holds a 4001-token block: off the
# 64- and 128-slot tiles.
SEQ_LONG_BYTES = 8000
SEQ_T = SEQ_LONG_BYTES + 2
SEQ_LONG = ("Long-context ledger for the sequence-parallel path: " + "".join(
    f"entry {i:04d} ships crate {(31 * i) % 997:03d} from dock {i % 13:02d}; "
    for i in range(200)))[:SEQ_LONG_BYTES]
SEQ_SHORT = "Sequence path, short row: a note beside the long ledger."
SEQ_REQUESTS = [(f"Sequence batch request {i}: route crate {i} via dock "
                 f"{3 + i}.", n) for i, n in enumerate((2, 6, 4, 8))]
# A rank's prefill region against the one-rank cache's at the same length.
SEQ_KV_SHARE = (0.45, 0.55)
SEQ_IMPL = {"r1": "ring", "r2": "ulysses"}


def seq_rank(argv: list, stats_path: str) -> None:
    """One rank of path r, in its own process: ``dlt-host-torch`` run
    through its ``main`` on a sequence-parallel mesh, with counters
    around K4's wrapper (calls by shape), the seq prefill and decode
    (device-synced wall time, the collectives each took), the two-region
    caches it allocates (bytes by region) and ``generate_text`` (each
    row's prompt ids and tokens).  After boot every launch count is set
    to 0; the first decode step after a long prefill saves its row 0
    logits beside ``stats_path`` (.npy, rank 0).  At the end, what it saw
    goes to ``stats_path`` (JSON)."""
    import numpy as np
    import torch

    from distributed_llms_tpu_torch.ops import flash, quant_matmul
    from distributed_llms_tpu_torch.parallel import api
    from distributed_llms_tpu_torch.runtime import engine as engine_lib

    stats = {"rank": None, "forwards": [], "rows": [], "caches": [],
             "k4_shapes": {}}
    box: dict = {}
    fa = flash.flash_attention

    def flash_attention(q, k, v, *a, **kw):
        key = (f"K4_B{q.shape[0]}_Tq{q.shape[1]}_S{k.shape[1]}"
               f"_H{q.shape[2]}_KVH{k.shape[2]}")
        stats["k4_shapes"][key] = stats["k4_shapes"].get(key, 0) + 1
        return fa(q, k, v, *a, **kw)

    # The kernel's wrapper counts on the module's flash_attention: this one.
    flash_attention.static_launches = flash_attention.dynamic_launches = 0
    flash.flash_attention = flash_attention
    pm_cls = api.ParallelModel

    def timed(kind, fn):
        def wrapped(self, params, tokens, *a, **kw):
            mesh = self.mesh
            torch.cuda.synchronize()
            before = dict(mesh.stats)
            t0 = time.perf_counter()
            out = fn(self, params, tokens, *a, **kw)
            torch.cuda.synchronize()
            stats["forwards"].append({
                "kind": kind, "rows": int(tokens.shape[0]),
                "tokens": int(tokens.shape[1]),
                "seconds": time.perf_counter() - t0,
                "collectives": {k: mesh.stats[k] - before[k]
                                for k in mesh.stats}})
            if kind == "decode" and box.pop("first_step", False) \
                    and mesh.rank == 0:
                np.save(stats_path + ".logits.npy",
                        out[0][0, -1].float().cpu().numpy())
            if kind == "prefill":
                box["first_step"] = tokens.shape[1] >= SEQ_LONG_BYTES
            return out
        return wrapped

    pm_cls._seq_prefill_cached = timed("prefill", pm_cls._seq_prefill_cached)
    pm_cls._seq_decode_cached = timed("decode", pm_cls._seq_decode_cached)
    init_cache = pm_cls.init_cache

    def init(self, batch, max_len, prompt_len=None):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        cache = init_cache(self, batch, max_len, prompt_len=prompt_len)
        torch.cuda.synchronize()
        stats["caches"].append({
            "batch": batch, "max_len": max_len, "prompt_len": prompt_len,
            "prefill_shape": list(cache.k[0].shape),
            "prefill_bytes": cache.k[0].nbytes + cache.v[0].nbytes,
            "decode_bytes": cache.k[1].nbytes + cache.v[1].nbytes,
            "allocated": torch.cuda.memory_allocated() - m0})
        return cache

    pm_cls.init_cache = init
    cls = engine_lib.InferenceEngine
    generate_text = cls.generate_text

    def gen_text(self, prompts, max_new_tokens=None, seed=None):
        res = generate_text(self, prompts, max_new_tokens, seed)
        for prompt, row in zip(prompts, res.tokens):
            stats["rows"].append({"prompt": self.tokenizer.encode(prompt),
                                  "tokens": [int(x) for x in row]})
        return res

    cls.generate_text = gen_text
    from_store = cls.from_store.__func__

    def engine_from_store(c, *a, **kw):
        eng = from_store(c, *a, **kw)
        torch.cuda.synchronize()
        box["engine"] = eng
        mesh = eng.pm.mesh
        stats.update(rank=mesh.rank, seq=mesh.coord("seq"), mesh=mesh.shape,
                     backend=mesh.backend, attn_impl=eng.pm.seq_cfg.attn_impl,
                     mem_after_engine=torch.cuda.memory_allocated())
        # Every count 0 just before the path's requests.
        quant_matmul.quant_matmul.launches = 0
        quant_matmul.quant_matmul.int4_launches = 0
        flash_attention.static_launches = flash_attention.dynamic_launches = 0
        flash.tile_summary.launches = 0
        return eng

    cls.from_store = classmethod(engine_from_store)
    try:
        from distributed_llms_tpu_torch.cli import host_main

        host_main.main(argv)
    finally:
        stats["k5_int8_launches"] = quant_matmul.quant_matmul.launches
        stats["k5_int4_launches"] = quant_matmul.quant_matmul.int4_launches
        stats["k4_launches"] = flash_attention.dynamic_launches
        stats["k3_launches"] = flash_attention.static_launches
        stats["tile_summary_launches"] = flash.tile_summary.launches
        if "engine" in box:
            stats["collectives"] = dict(box["engine"].pm.mesh.stats)
        with open(stats_path, "w") as f:
            json.dump(stats, f)


def seq_k4_local(torch, card) -> dict:
    """K4 at path r2's local shape (one rank of Ulysses over seq=2: B 1,
    H 16, KVH 4, D 128, the 8002 gathered positions, causal by position)
    held against its plain version and timed beside it and SDPA's causal
    kernel.  Bound: 4 operations per live (row, key) pair, head dim and
    head at the bf16 peak, against q, k, v, out and the two position
    vectors read or written once."""
    import torch.nn.functional as F

    from distributed_llms_tpu_torch.ops import flash

    h, kvh, t = 16, 4, SEQ_T
    q, k, v = flash_case(torch, tq=t, h=h, kvh=kvh, seed=70)
    d = q.shape[3]
    pos = torch.arange(t, device="cuda")[None]
    kw = {"q_positions": pos, "k_positions": pos}
    ref = flash.flash_reference(q, k, v, **kw)
    err = _row_held(torch, "flash_attention_dynamic",
                    flash.flash_attention(q, k, v, **kw), ref, FLASH_ROW_REL,
                    case="ulysses_local", B=1, Tq=t, S=t, H=h, KVH=kvh, D=d)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = (library().transpose(1, 2).float() - ref.float()).abs().max()
    check(lib_err.item() <= TOL, f"K4 local: SDPA disagrees ({lib_err})")
    del ref
    pairs = t * (t + 1) // 2
    io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * 2 * t
    tm = _turns(torch, lambda: flash.flash_attention(q, k, v, **kw),
                lambda: flash.flash_reference(q, k, v, **kw), library,
                plain_iters=1, iters=10, plain_warmup=1)
    dev = _device_ms(torch, lambda: flash.flash_attention(q, k, v, **kw))
    got = _timed(
        "flash_attention_dynamic",
        {"B": 1, "Tq": t, "S": t, "H": h, "KVH": kvh, "D": d,
         "causal": "by position", "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h), io, shape="ulysses_local",
        card=card, max_abs_err=err,
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        device_ms_per_call=dev,
        library_device_ms_per_call=_device_ms(torch, library))
    del q, k, v, qt, kt, vt
    _free(torch)
    return got


def _seq_set_attn_impl(store: str, impl: str) -> None:
    """The attention the store's manifest names (the engine takes its
    model config from there; the CLI has no knob for it)."""
    path = Path(store) / "manifest.json"
    man = json.loads(path.read_text())
    man["model_config"]["attn_impl"] = impl
    path.write_text(json.dumps(man))


async def _seq_leg(leg, store, tmp, overrides, lap) -> dict:
    """One leg of path r: two ``dlt-host-torch`` ranks on ``mesh.seq=2``
    under an in-process ``Coordinator``; r1 sends the long prompt beside
    the short one through ``generate_spmd``, then the mixed-budget batch
    through ``generate_requests``; r2 the long prompt alone."""
    from distributed_llms_tpu_torch.cluster.coordinator import Coordinator
    from distributed_llms_tpu_torch.core.config import ClusterConfig

    label = f"seq/{leg}"
    stats = [f"{tmp}/{leg}_rank{r}.json" for r in range(SEQ_RANKS)]
    logs = [f"{tmp}/{leg}_rank{r}.log" for r in range(SEQ_RANKS)]
    coord = Coordinator(ClusterConfig(
        coordinator_host="127.0.0.1", coordinator_port=0,
        heartbeat_interval_s=0.5, heartbeat_timeout_s=600.0,
        task_timeout_s=600.0))
    await coord.start()
    dist_port = _free_port()
    procs, out = [], {"stats": stats}
    try:
        for r in range(SEQ_RANKS):
            argv = ["--host", "127.0.0.1", "--port", str(coord.port),
                    "--worker-id", f"{leg}-rank{r}",
                    "--override", f"cluster.num_processes={SEQ_RANKS}",
                    "--override", f"cluster.process_id={r}",
                    "--override", "cluster.distributed_coordinator="
                                  f"127.0.0.1:{dist_port}",
                    "--override", "cluster.heartbeat_interval_s=0.5",
                    "--override", f"mesh.seq={SEQ_RANKS}",
                    *[a for kv in overrides for a in ("--override", kv)]]
            procs.append(_spawn_rank("seq", argv, stats[r], logs[r]))
        deadline = time.monotonic() + MESH_BOOT_S
        while len(coord.workers) < SEQ_RANKS:
            for p, log in zip(procs, logs):
                if p.poll() is not None:
                    raise SmokeFailure(
                        f"{label}: a host exited {p.returncode}:\n"
                        f"{Path(log).read_text()[-3000:]}")
            check(time.monotonic() < deadline, f"{label}: no workers")
            await asyncio.sleep(0.2)
        coord.plan_shards(2, store_dir=store)
        placed = await coord.place_shards(timeout=600.0)
        check(all("'seq': 2" in r.get("resident", "")
                  for r in placed.values()), f"{label}: {placed}")
        lap(f"{leg}_boot_place")
        prompts = [SEQ_LONG, SEQ_SHORT] if leg == "r1" else [SEQ_LONG]
        t0 = time.perf_counter()
        out["spmd"] = await coord.generate_spmd(prompts,
                                                max_new_tokens=SEQ_NEW)
        out["spmd_s"] = time.perf_counter() - t0
        if leg == "r1":
            reqs = [{"prompt": p, "max_new_tokens": n}
                    for p, n in SEQ_REQUESTS]
            t0 = time.perf_counter()
            out["batch"] = await coord.generate_requests(reqs, timeout=600.0)
            out["batch_s"] = time.perf_counter() - t0
        lap(f"{leg}_requests")
        for wid in list(coord.workers):
            await coord.submit("SHUTDOWN", {}, worker_id=wid, timeout=60.0)
        await asyncio.to_thread(_reap, procs, logs, label)
        return out
    finally:
        _kill(procs)
        await coord.stop()


def _seq_reference(torch, eng, rows, eos) -> dict:
    """Each greedy row against the one-rank engine, fed the row's context
    (one dense forward over prompt + row, batch 1): the agreement of its
    greedy choice, and the first decode step's logits of the long row
    (the position after its first token)."""
    from distributed_llms_tpu_torch.models import model as model_lib

    agree = total = 0
    first = None
    for row in rows:
        stream = _cut(row["tokens"], eos)
        ids = row["prompt"] + stream[:-1]
        toks = torch.tensor([ids], device=eng.device)
        with torch.no_grad():
            logits, _ = model_lib.forward(eng.params, eng.run_cfg, toks)
        n = len(row["prompt"])
        want = logits[0, n - 1:].argmax(-1).tolist()
        agree += sum(int(a == b) for a, b in zip(want, stream))
        total += len(stream)
        if n >= SEQ_LONG_BYTES and first is None:
            check(len(stream) >= 2, "seq: the long row ended at its first "
                  "token")
            first = logits[0, n].float().cpu().numpy()
        del logits
    return {"agree": agree, "tokens": total,
            "agreement": agree / max(total, 1), "first_step_logits": first}


def _seq_rank_line(label, name, st, r, cfg, one_mem) -> dict:
    """One rank of a leg of path r held to its counts (K5 on every
    projection of every forward; under Ulysses K4 on every layer of every
    prefill, at the local shape, each after its pre-pass; under the ring
    no flash launch) and to its share of the prompt's K/V; what it
    measured, for the ``seq_r`` line."""
    n_layers = cfg.num_layers
    fw = st["forwards"]
    pre = [f for f in fw if f["kind"] == "prefill"]
    dec = [f for f in fw if f["kind"] == "decode"]
    k5, k4 = st["k5_int8_launches"], st["k4_launches"]
    check(st["backend"] == "gloo" and st["seq"] == r
          and st["attn_impl"] == SEQ_IMPL[name],
          f"{label}: rank {r} is seq {st['seq']} ({st['attn_impl']}) on "
          f"{st['backend']}")
    check(bool(pre and dec) and k5 >= 7 * n_layers * len(fw),
          f"{label}: rank {r} launched K5 {k5} times, under 7 x "
          f"{n_layers} layers x {len(fw)} forwards")
    check(st["k5_int4_launches"] == 0,
          f"{label}: rank {r} launched K5 int4 on an int8 store")
    if SEQ_IMPL[name] == "ulysses":
        local = (f"K4_B1_Tq{SEQ_T}_S{SEQ_T}_H{cfg.num_heads // SEQ_RANKS}"
                 f"_KVH{cfg.num_kv_heads // SEQ_RANKS}")
        check(k4 >= n_layers * len(pre) and local in st["k4_shapes"],
              f"{label}: rank {r} launched K4 {k4} times "
              f"({st['k4_shapes']}), under {n_layers} layers x {len(pre)} "
              f"prefills or not at {local}")
        check(st["tile_summary_launches"] == k4,
              f"{label}: rank {r}: {st['tile_summary_launches']} pre-passes "
              f"for {k4} K4 launches")
    else:
        check(k4 == 0 and st["k3_launches"] == 0,
              f"{label}: rank {r} launched flash on the ring")
    long_cache = next(c for c in st["caches"]
                      if c["prompt_len"] >= SEQ_LONG_BYTES)
    # The one-rank cache's prefill region at the same length: K and V of
    # every layer, row and padded prompt slot, in bf16.
    one_pref = (2 * n_layers * long_cache["batch"] * long_cache["prompt_len"]
                * cfg.num_kv_heads * cfg.head_dim_ * 2)
    share = long_cache["prefill_bytes"] / one_pref
    check(SEQ_KV_SHARE[0] <= share <= SEQ_KV_SHARE[1],
          f"{label}: rank {r} holds {share:.3f} of the one-rank prefill "
          "region")
    long_pre = next(f for f in pre if f["tokens"] >= SEQ_LONG_BYTES)
    dec_s = sum(f["seconds"] for f in dec)

    def coll(fs, kind):
        return {"calls": sum(f["collectives"][f"{kind}_calls"] for f in fs),
                "seconds": sum(f["collectives"][f"{kind}_seconds"]
                               for f in fs)}

    return {
        "rank": st["rank"], "seq": st["seq"], "attn_impl": st["attn_impl"],
        "k5_int8_launches": k5, "k4_launches": k4,
        "tile_summary_launches": st["tile_summary_launches"],
        "k4_shapes": st["k4_shapes"], "prefills": len(pre),
        "decode_steps": len(dec),
        "mem_after_boot_gb": st["mem_after_engine"] / 1e9,
        "boot_mem_share_of_one_rank": st["mem_after_engine"] / one_mem,
        "long_cache": long_cache,
        "prefill_share_of_one_rank_cache": share,
        "cache_allocated_share": long_cache["allocated"] / one_pref,
        "long_prefill_s": long_pre["seconds"],
        "long_prefill_rows": long_pre["rows"],
        "long_prefill_collectives": {
            k: coll([long_pre], k)
            for k in ("shift", "a2a", "reduce_sum", "reduce_max")},
        "long_prefill_all_collectives": {
            "calls": long_pre["collectives"]["calls"],
            "seconds": long_pre["collectives"]["seconds"]},
        "ms_per_decode_step": dec_s * 1e3 / len(dec),
        "decode_collectives_per_step": sum(
            f["collectives"]["calls"] for f in dec) / len(dec),
        "decode_collective_share": sum(
            f["collectives"]["seconds"] for f in dec) / max(dec_s, 1e-9),
        "decode_collectives": {k: coll(dec, k)
                               for k in ("reduce_sum", "reduce_max")},
        "collectives_total": st.get("collectives")}


def serve_seq(torch) -> dict:
    """Path r: sequence parallelism at Llama-3-8B's full width and its
    published 32 layers and 8192-token context, weight-only int8 (random
    weights, seed 0): two ``dlt-host-torch`` ranks (``mesh.seq=2``) share
    the card over gloo under an in-process ``Coordinator``.  r1 (the
    ring, the default): an 8001-token prompt beside a short one through
    ``generate_spmd``, greedy, 16 new tokens, then 4 mixed-budget
    requests through ``generate_requests`` (the grouped fallback); r2
    (Ulysses, the store's manifest set to ``attn_impl="ulysses"``): the
    long prompt alone.  Each leg is held to a one-rank engine over the
    same store (``attn_impl="dot"``, batch 1).  K4 is first held and
    timed at r2's local shape.  Returns K5's, K4's and K4's pre-pass's
    launches, one count a rank of each leg."""
    import numpy as np

    from distributed_llms_tpu_torch.core.config import load_config
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

    check(len(SEQ_LONG) == SEQ_LONG_BYTES, "seq: the long prompt is short")
    card = _card()
    lap = _lap("seq_time")
    tmp = tempfile.mkdtemp(prefix="dlt_seq_")
    overrides = ["runtime.serve_quantized=true",
                 f"runtime.max_seq_len={SEQ_MAX_LEN}",
                 f"runtime.max_decode_steps={SEQ_NEW}"]
    legs: dict = {}
    eos = ByteTokenizer().eos_id
    try:
        k4_local = seq_k4_local(torch, card)
        lap("k4_local")
        store, info, _ = shared_store(torch, "llama_int8", _write_llama_int8)
        lap("store")
        for leg, impl in SEQ_IMPL.items():
            _seq_set_attn_impl(store, impl)
            legs[leg] = asyncio.run(_seq_leg(leg, store, tmp, overrides,
                                             lap))
            legs[leg]["ranks"] = _read_stats(legs[leg]["stats"])
            legs[leg]["logits"] = np.load(legs[leg]["stats"][0]
                                          + ".logits.npy")
        _seq_set_attn_impl(store, "dot")
        rt = load_config(None, overrides).runtime
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        eng = InferenceEngine.from_store(store, rt=rt)
        torch.cuda.synchronize()
        one_mem = torch.cuda.memory_allocated() - held
        for leg in legs.values():
            leg["reference"] = _seq_reference(torch, eng,
                                              leg["ranks"][0]["rows"], eos)
        del eng
        _free(torch)
        lap("one_rank")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = get_preset("llama-3-8b")
    out: dict = {"quant_matmul": {}, "flash_attention_dynamic": {},
                 "flash_tile_summary": {}}
    for name, leg in legs.items():
        label = f"seq/{name}"
        ranks, ref = leg["ranks"], leg["reference"]
        per_rank = [_seq_rank_line(label, name, st, r, cfg, one_mem)
                    for r, st in enumerate(ranks)]
        first = ref.pop("first_step_logits")
        emit("seq_r", leg=name, card=card, mesh={"seq": SEQ_RANKS},
             attn_impl=SEQ_IMPL[name], backend="gloo", store=info,
             prompt_tokens=SEQ_LONG_BYTES + 1, padded_prompt=SEQ_T,
             ranks=per_rank, one_rank_mem_gb=one_mem / 1e9,
             first_step_logits_max_abs_diff=float(
                 abs(leg["logits"] - first).max()),
             first_step_logits_scale=float(abs(first).max()),
             teacher_forced=ref, one_rank_reference="attn_impl=dot, batch 1",
             spmd_s=leg["spmd_s"], batch_s=leg.get("batch_s"),
             k4_local=k4_local)
        rows = [st["rows"] for st in ranks]
        check(rows[0] == rows[1] and len(rows[0]) == (
            2 + len(SEQ_REQUESTS) if name == "r1" else 1),
              f"{label}: the ranks' generated rows differ")
        check(leg["logits"].shape == (cfg.vocab_size,)
              and bool(np.isfinite(leg["logits"]).all()),
              f"{label}: first-step logits not finite [V]")
        check(ref["tokens"] > 0 and ref["agreement"] >= MESH_AGREEMENT,
              f"{label}: greedy agreement {ref['agreement']:.3f} under "
              f"{MESH_AGREEMENT}")
        if name == "r1":
            check(len(leg["batch"]["text"]) == len(SEQ_REQUESTS)
                  and len(leg["spmd"]["text"]) == 2,
                  f"{label}: {len(leg['batch']['text'])} batch, "
                  f"{len(leg['spmd']['text'])} spmd texts")
        for key, kernel in (("k5_int8_launches", "quant_matmul"),
                            ("k4_launches", "flash_attention_dynamic"),
                            ("tile_summary_launches", "flash_tile_summary")):
            out[kernel][name] = [r[key] for r in per_rank]
    return out


# -- main -------------------------------------------------------------------

# -- path s: expert parallelism -------------------------------------------------

# Path s's ranks are two processes of one gloo group on the one card, as
# path p's (:func:`mesh_rank`), each holding half of Mixtral's experts.
EXPERT_RANKS = 2
EXPERT_MEM_SHARE = 0.65  # a rank's resident memory under this share of one
#   rank's engine (expected 0.55-0.6: attention, embeddings and the pool
#   stay whole on every rank; the experts, ~85% of the int4 weights, halve)
EXPERT_TOPK = 8  # logits kept a sampling call, for the near-tie rule


def expert_rank(argv: list, stats_path: str) -> None:
    """One rank of path s, in its own process: ``dlt-serve-torch --store
    <Mixtral int4> --override mesh.expert=2`` run through its ``main``.
    Once the mesh engine is built, before the server starts: s2, one
    ``Trainer(parallel=)`` step at Mixtral's width cut to
    MIXTRAL_TRAIN_LAYERS layers on the same mesh (:func:`expert_train`),
    s3, path p3's step at ``model=2`` (:func:`tp_train`), then s1's
    engine-side leg, path m's 8 greedy prompts as one batch at 8
    slots (:func:`expert_batch`), and each rank's rehydration of one layer
    timed in turn; then the server answers over HTTP (rank 0 serves,
    rank 1 follows).  Counters around the decode steps (device-synced
    wall time, the collectives and the 'expert' line's share) and the
    batchers (memory once built, streams).  At the end, what it saw goes
    to ``stats_path`` (JSON; the batch's logits and routing, and the
    step's expert gradient and update, beside it as .pt)."""
    import torch

    from distributed_llms_tpu_torch.runtime import batcher as bl
    from distributed_llms_tpu_torch.runtime import engine as engine_lib

    stats = {"rank": None, "legs": {}, "streams": []}
    box: dict = {"leg": "boot"}
    reset_launches()

    def leg_stats():
        return stats["legs"].setdefault(box["leg"], {
            "decode_s": 0.0, "steps": 0, "collective_s": 0.0,
            "collective_calls": 0, "expert_s": 0.0, "expert_calls": 0})

    steps_fn = bl._decode_steps

    def decode_steps(*a, **kw):
        mesh, st = box["engine"].pm.mesh.stats, leg_stats()
        torch.cuda.synchronize()
        before = dict(mesh)
        t0 = time.perf_counter()
        out = steps_fn(*a, **kw)
        torch.cuda.synchronize()
        st["decode_s"] += time.perf_counter() - t0
        st["steps"] += a[5]
        for key, name in (("collective", ""), ("expert", "axis_expert_")):
            st[f"{key}_s"] += mesh[f"{name}seconds"] - before[f"{name}seconds"]
            st[f"{key}_calls"] += mesh[f"{name}calls"] - before[f"{name}calls"]
        return out

    bl._decode_steps = decode_steps
    cls = bl.ContinuousBatcher
    init, run = cls.__init__, cls.run

    def b_init(self, *a, **kw):
        init(self, *a, **kw)
        torch.cuda.synchronize()
        leg_stats()["mem_after_batcher"] = torch.cuda.memory_allocated()
        box["batcher"] = self

    def b_run(self, *a, **kw):
        res = run(self, *a, **kw)
        stats["streams"].extend(list(map(int, t)) for t in res.values())
        return res

    cls.__init__, cls.run = b_init, b_run
    from_store = engine_lib.InferenceEngine.from_store.__func__

    def engine_from_store(c, *a, **kw):
        eng = from_store(c, *a, **kw)
        torch.cuda.synchronize()
        box["engine"] = eng
        pm = eng.pm
        stats["rank"], stats["mesh"] = pm.mesh.rank, pm.mesh.shape
        stats["backend"], stats["experts"] = pm.mesh.backend, pm.plan.experts
        stats["mem_after_engine"] = torch.cuda.memory_allocated()
        mlp = eng.params["blocks"]["mlp"]
        stats["expert_bytes"] = _expert_bytes(mlp)
        stats["expert_leaves"] = {k: [type(mlp[k]).__name__,
                                      list(mlp[k].unpacked_shape)]
                                  for k in ("w_gate", "w_up", "w_down")}
        box["leg"] = "train"
        stats["train"] = expert_train(torch, pm, stats_path)
        stats["train_tp"] = tp_train(torch, stats_path)
        box["leg"] = "batch"
        stats["batch"] = expert_batch(torch, eng, stats_path)
        box["leg"] = "http"
        return eng

    engine_lib.InferenceEngine.from_store = classmethod(engine_from_store)
    try:
        from distributed_llms_tpu_torch.cli import serve_main

        serve_main.main(argv)
    finally:
        stats["launches"] = read_launches()
        b = box.get("batcher")
        if b is not None and b.prefix_cache is not None:
            stats["http_prefix_hits"] = b.prefix_cache.hits
        with open(stats_path, "w") as f:
            json.dump(stats, f)


def expert_train(torch, pm, stats_path: str) -> dict:
    """s2 on this rank: one ``Trainer(parallel=)`` step at Mixtral's width
    cut to MIXTRAL_TRAIN_LAYERS layers (``attn_impl="flash"``, K3) on an
    'expert' mesh over the engine's group, from path m's weights (seed 0)
    and batch.  A forward without gradients first records this rank's
    own routing, counted against path m's step's; where a choice flipped
    (a bf16 near-tie), the step replays path m's routing, as path m's
    float32 recompute does.  Layer 0's expert w_gate gradient and update
    (this rank's block) go beside ``stats_path``."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.core.config import MeshConfig
    from distributed_llms_tpu_torch.models import layers
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.parallel.api import make_parallel_model
    from distributed_llms_tpu_torch.runtime import train

    inp = torch.load(f"{Path(stats_path).parent}/s2_inputs.pt",
                     weights_only=True)
    cfg = get_preset(MIXTRAL_PRESET, attn_impl="flash",
                     num_layers=MIXTRAL_TRAIN_LAYERS)
    tpm = make_parallel_model(cfg, MeshConfig(expert=EXPERT_RANKS))
    dev = tpm.device
    full = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device=dev)
    local = tpm.shard_params(full)
    del full
    _free(torch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = inp["batch"].to(dev)
    ref = [[t.to(dev) for t in d] for d in inp["routes"]]
    route, own = layers.moe_route, []

    def recorded(logits, c, cap):
        out = route(logits, c, cap)
        own.append(out[1])
        return out

    replay = list(ref)

    def replayed(logits, c, cap):
        eid, oh, keep, slot = replay.pop(0)
        topi = eid.reshape(c.num_experts_per_token, -1).T
        return (torch.softmax(logits.gather(1, topi), dim=-1), eid, oh, keep,
                slot)

    def fwd(params, c, inputs, remat=False, return_aux=False):
        return tpm.forward(params, inputs, remat=remat, return_aux=return_aux)

    trainer = train.Trainer(cfg, train.default_optimizer(MIXTRAL_TRAIN_LR),
                            parallel=tpm)
    state = trainer.init(local)
    w_gate = local["blocks"]["mlp"]["w_gate"]
    at = next(i for i, t in enumerate(train._leaves(local)) if t is w_gate)
    before0 = w_gate[0].clone()
    try:
        layers.moe_route = recorded
        with torch.no_grad():
            train.lm_loss(local, cfg, batch, forward_fn=fwd)
        flipped = sum(int((a != b[0]).sum()) for a, b in zip(own, ref))
        layers.moe_route = replayed if flipped else route
        k3 = read_launches()["flash_attention_static"]
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, norm = trainer.gradients(local, batch)
        state = trainer.optimizer.update(grads, state, local, norm=norm)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        k3 = read_launches()["flash_attention_static"] - k3
    finally:
        layers.moe_route = route
    torch.save({"grad0": grads[at][0].cpu(), "before0": before0.cpu(),
                "after0": w_gate[0].to("cpu", copy=True)},
               stats_path + ".train.pt")
    out = {"loss": float(loss), "global_norm": float(norm),
           "routing_flipped": flipped,
           "claims": sum(e.numel() for e in own),
           "replayed_reference_routing": bool(flipped), "step_s": step_s,
           "resident_gb": held / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_peak_over_resident_gb":
               (torch.cuda.max_memory_allocated() - held) / 1e9,
           "k3_launches": k3, "experts": tpm.plan.experts,
           "local_w_gate": list(w_gate.shape)}
    del local, state, grads, batch, ref, own
    _free(torch)
    return out


def tp_train(torch, stats_path: str) -> dict:
    """s3 on this rank: one ``Trainer(parallel=)`` step of path p3's
    ``Trainer`` (path g's width cut to TRAIN_CKPT_LAYERS layers,
    ``attn_impl="flash"``, seed 0, lr 1e-3) at ``model=2`` over the same
    two processes, on path p3's batch.  Layer 0's w_gate gradient and
    update (this rank's columns) go beside ``stats_path``."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.core.config import MeshConfig
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.parallel.api import make_parallel_model
    from distributed_llms_tpu_torch.runtime import train

    batch = torch.load(f"{Path(stats_path).parent}/s2_inputs.pt",
                       weights_only=True)["tp_batch"]
    cfg = get_preset("llama-3-8b", attn_impl="flash",
                     num_layers=TRAIN_CKPT_LAYERS)
    tpm = make_parallel_model(cfg, MeshConfig(model=EXPERT_RANKS))
    full = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device=tpm.device)
    local = tpm.shard_params(full)
    del full
    _free(torch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = batch.to(tpm.device)
    trainer = train.Trainer(cfg, train.default_optimizer(1e-3), parallel=tpm)
    state = trainer.init(local)
    w_gate = local["blocks"]["mlp"]["w_gate"]
    at = next(i for i, t in enumerate(train._leaves(local)) if t is w_gate)
    before0 = w_gate[0].clone()
    calls = tpm.mesh.stats["calls"]
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, norm = trainer.gradients(local, batch)
    state = trainer.optimizer.update(grads, state, local, norm=norm)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    torch.save({"grad0": grads[at][0].cpu(), "before0": before0.cpu(),
                "after0": w_gate[0].to("cpu", copy=True)},
               stats_path + ".train_tp.pt")
    out = {"loss": float(loss), "global_norm": float(norm),
           "step_s": step_s, "collectives": tpm.mesh.stats["calls"] - calls,
           "resident_gb": held / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "local_w_gate": list(w_gate.shape)}
    del local, state, grads, batch
    _free(torch)
    return out


def _tp_train_reference(torch) -> dict:
    """s3's one-rank step: path p3's ``Trainer`` on its weights and batch
    (seed 0, seed 1), one step: the loss, layer 0's w_gate gradient and
    update, and the batch the ranks take."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import train

    cfg = get_preset("llama-3-8b", attn_impl="flash",
                     num_layers=TRAIN_CKPT_LAYERS)
    batch = torch.randint(0, cfg.vocab_size, (2, TRAIN_CKPT_T), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    trainer = train.Trainer(cfg, train.default_optimizer(1e-3))
    state = trainer.init(params)
    w_gate = params["blocks"]["mlp"]["w_gate"]
    at = next(i for i, t in enumerate(train._leaves(params)) if t is w_gate)
    before0 = w_gate[0].to("cpu", copy=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, _ = trainer.gradients(params, batch)
    state = trainer.optimizer.update(grads, state, params)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "step_s": time.perf_counter() - t0,
           "grad0": grads[at][0].cpu(), "before0": before0,
           "after0": w_gate[0].to("cpu", copy=True), "batch": batch.cpu()}
    del params, state, grads
    _free(torch)
    return out


def _step_held(lo: int, hi: int, dim: int, got: dict, want: dict) -> dict:
    """A rank's block ``[lo, hi)`` along ``dim`` of layer 0's w_gate
    gradient and update against the one-rank step's.  AdamW's first step
    moves each entry by lr times its gradient's sign (plus the decay), so
    an entry whose gradient lies within the two steps' difference of zero
    may move the other way: the update is also compared on the entries
    whose sign both gradients determine (|g| above their difference)."""
    def block(t):
        return t.narrow(dim, lo, hi - lo).float()

    g1, gr = block(want["grad0"]), got["grad0"].float()
    d1 = block(want["after0"]) - block(want["before0"])
    dr = got["after0"].float() - got["before0"].float()
    check(got["before0"].equal(want["before0"].narrow(dim, lo, hi - lo)),
          "a rank's step starts from other weights than the one-rank step")
    sure = g1.abs() > (gr - g1).abs()
    return {"grad_rel_err": float((gr - g1).norm() / g1.norm()),
            "update_rel_err": float((dr - d1).norm() / d1.norm()),
            "update_sign_agreement": float(
                (dr.sign() == d1.sign()).float().mean()),
            "sign_determined_share": float(sure.float().mean()),
            "update_rel_err_sign_determined": float(
                ((dr - d1) * sure).norm() / (d1 * sure).norm())}


def expert_batch(torch, eng, stats_path: str) -> dict:
    """s1's engine-side leg on this rank: path m's 8 greedy prompts as one
    batch at 8 slots on the mesh engine (``_mixtral_batcher_kw``: the
    same pool and loop as path m's), every sampling call's top
    EXPERT_TOPK logits and every routing decision (experts, kept claims
    and the float32 router logits) recorded beside ``stats_path`` on rank
    0; then each rank's rehydration of one layer's experts timed in turn
    (the other rank waiting)."""
    import torch.distributed as dist

    from distributed_llms_tpu_torch.models import layers
    from distributed_llms_tpu_torch.runtime import sampling

    ids = [eng.tokenizer.encode(p) for p in FAM_PROMPTS]
    route, sample, sample_rows = (layers.moe_route, sampling.sample,
                                  sampling.sample_rows)
    routes, tops = [], []

    def top(src):
        v, i = torch.topk(src.float(), EXPERT_TOPK, dim=-1)
        tops.append((v.cpu(), i.cpu()))

    def recorded(logits, c, cap):
        out = route(logits, c, cap)
        routes.append((out[1].cpu(), out[3].cpu(), logits.float().cpu()))
        return out

    def s1(gen, src, *a, **kw):
        top(src)
        return sample(gen, src, *a, **kw)

    def s2(gen, src, *a, **kw):
        top(src)
        return sample_rows(gen, src, *a, **kw)

    b = eng.continuous_batcher(**_mixtral_batcher_kw(ids))
    slots = {}
    activate = b._activate_row

    def b_activate(i, req, *a, **kw):
        slots[req.rid] = i
        return activate(i, req, *a, **kw)

    b._activate_row = b_activate
    try:
        layers.moe_route, sampling.sample = recorded, s1
        sampling.sample_rows = s2
        streams, wall = _sync_time(torch, lambda: _batcher_streams(
            torch, b, ids, FAM_NEW))
    finally:
        layers.moe_route, sampling.sample = route, sample
        sampling.sample_rows = sample_rows
    rank = eng.pm.mesh.rank
    if rank == 0:
        torch.save({"tops": tops, "routes": routes},
                   stats_path + ".batch.pt")
    out = {"streams": [list(map(int, s)) for s in streams], "wall_s": wall,
           "decode_steps": b.decode_steps, "slots": [slots[r] for r in
                                                     sorted(slots)]}
    del b
    _free(torch)
    for r in range(eng.pm.mesh.world_size):
        dist.barrier()
        if r == rank:
            out["rehydrate_ms_a_layer"] = _rehydrate_ms(
                torch, eng.params["blocks"]["mlp"])
    dist.barrier()
    return out


def _first_diff_at(a: list, b: list) -> int | None:
    """The first position where two streams differ, or None."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def _expert_agreement(got: list, want: list, saved: dict, one_routes: list,
                      slots: list, n_layers: int, eos: int) -> dict:
    """The mesh batch's streams against the one-rank engine's (the same
    prompts, batch and loop): the share of committed tokens before each
    row's first divergence, and whether the earliest divergence is a
    near-tie.  Capacity couples the rows, so once one token or one routing
    choice differs, every later step of every row may; what must hold is
    the first event: at the earliest step where a token or a routing
    choice differs (the admissions count as step -1), a flipped expert
    choice lies within FAM_NEAR_TIE of the mesh's float32 router logits,
    or, with none flipped there, each diverging row's two tokens lie
    within FAM_NEAR_TIE of the mesh's logits."""
    rows = len(got)

    def step_of_call(c):
        return -1 if c < rows * n_layers else (c - rows * n_layers) // n_layers

    flip = None  # (step, |router logit gap|, call) of the first flip
    for c, ((e1, _), (e2, _, logits)) in enumerate(zip(one_routes,
                                                       saved["routes"])):
        if e1.shape != e2.shape:
            flip = (step_of_call(c), float("inf"), c)
            break
        bad = (e1 != e2).nonzero()
        if len(bad):
            claim = int(bad[0])
            row = claim % logits.shape[0]
            gap = abs(float(logits[row, int(e1[claim])]
                            - logits[row, int(e2[claim])]))
            flip = (step_of_call(c), gap, c)
            break
    # Sampling calls: each row's admission (batch 1), then the decode
    # steps (every slot).
    adm = [t for t in saved["tops"] if t[0].shape[0] == 1]
    dec = [t for t in saved["tops"] if t[0].shape[0] > 1]
    agree = total = 0
    diverged = []
    for r in range(rows):
        a, b = _cut(got[r], eos), _cut(want[r], eos)
        j = _first_diff_at(a, b)
        total += len(b)
        agree += len(b) if j is None else j
        if j is None:
            continue
        v, i = adm[r] if j == 0 else dec[j - 1]
        row = 0 if j == 0 else slots[r]
        ids, vals = i[row].tolist(), v[row].tolist()
        gap = (vals[0] - vals[ids.index(b[j])]
               if j < len(b) and b[j] in ids else float("inf"))
        diverged.append({"row": r, "at": j, "step": j - 1,
                         "token_gap": gap})
    steps = [d["step"] for d in diverged] + ([flip[0]] if flip else [])
    first_ok = True
    if steps:
        first = min(steps)
        if flip is not None and flip[0] == first:
            first_ok = flip[1] <= FAM_NEAR_TIE
        else:
            first_ok = all(d["token_gap"] <= FAM_NEAR_TIE for d in diverged
                           if d["step"] == first)
    return {"agreement": agree / max(total, 1), "tokens": total,
            "rows_equal": rows - len(diverged), "diverged": diverged,
            "first_routing_flip": None if flip is None else {
                "step": flip[0], "call": flip[2],
                "router_logit_gap": flip[1]},
            "first_event_near_tie": first_ok}


def serve_expert(torch) -> dict:
    """Path s: expert parallelism.  s1: Mixtral-8x7B as an int4 store
    (path m's, MIXTRAL_LAYERS layers, at its published width) on two
    gloo ranks sharing the card (``mesh.expert=2``: four experts a rank),
    ``dlt-serve-torch --store <it> --override mesh.expert=2`` with path
    m's pool flags serving path a's requests (all greedy, FAM_NEW new:
    streams checked for length and vocabulary), and engine-side path m's
    8-row batch held to path m's one-rank engine (same store, batch and
    loop).  s2: one ``Trainer(parallel=)`` step at ``expert=2`` held to
    path m's one-rank step on the same weights; s3: path p3's step at
    ``model=2`` held to its one-rank step.  When the ``families`` phase
    did not run in this process, path m's Mixtral parts run first.
    Returns each kernel's launches, one count a rank."""
    import numpy as np

    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

    card = _card()
    lap = _lap("expert_time")
    if "mixtral" not in _SHARED:
        families_mixtral(torch, card, lap)
    if "mixtral_train" not in _SHARED:
        families_train(torch, card, lap)
    one, one_train = _SHARED["mixtral"], _SHARED["mixtral_train"]
    cfg = get_preset(MIXTRAL_PRESET, num_layers=MIXTRAL_LAYERS)
    label = "expert/s"
    tp_one = _tp_train_reference(torch)
    lap("s3_one_rank")
    tmp = tempfile.mkdtemp(prefix="dlt_expert_")
    try:
        torch.save({"batch": one_train["batch"],
                    "routes": one_train["routes"],
                    "tp_batch": tp_one["batch"]}, f"{tmp}/s2_inputs.pt")
        dist_port, port = _free_port(), _free_port()
        stats = [f"{tmp}/s_rank{r}.json" for r in range(EXPERT_RANKS)]
        logs = [f"{tmp}/s_rank{r}.log" for r in range(EXPERT_RANKS)]
        procs = []
        try:
            for r in range(EXPERT_RANKS):
                argv = ["--store", one["store"], *MIXTRAL_ARGS,
                        "--port", str(port),
                        "--override", f"mesh.expert={EXPERT_RANKS}",
                        "--override",
                        f"cluster.num_processes={EXPERT_RANKS}",
                        "--override", f"cluster.process_id={r}",
                        "--override", "cluster.distributed_coordinator="
                                      f"127.0.0.1:{dist_port}"]
                procs.append(_spawn_rank("expert", argv, stats[r], logs[r]))
            _wait_http(port, procs, logs, label)
            lap("s_boot_train_batch")
            t0 = time.perf_counter()
            served = asyncio.run(_serve_requests(port, greedy_new=FAM_NEW))
            http_s = time.perf_counter() - t0
            lap("s1_http")
            procs[0].terminate()  # rank 0 drains and stops its follower
            _reap(procs, logs, label)
        finally:
            _kill(procs)
        ranks = _read_stats(stats)
        saved = torch.load(stats[0] + ".batch.pt", weights_only=True)
        trained = [torch.load(p + ".train.pt", weights_only=True)
                   for p in stats]
        trained_tp = [torch.load(p + ".train_tp.pt", weights_only=True)
                      for p in stats]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    eos = ByteTokenizer().eos_id
    per = cfg.num_experts // EXPERT_RANKS
    per_rank, launches = [], {}
    for r, st in enumerate(ranks):
        check(st["backend"] == "gloo" and st["experts"] == [r * per,
                                                            (r + 1) * per],
              f"{label}: rank {r} on {st['backend']} holds experts "
              f"{st['experts']}")
        batch, http, tr = (st["legs"]["batch"], st["legs"]["http"],
                           st["train"])
        steps = batch["steps"] + http["steps"]
        got = st["launches"]
        check(steps > 0 and got["paged_decode_attention"]
              >= cfg.num_layers * steps
              and got["quant_matmul_int4"] >= 4 * cfg.num_layers * steps,
              f"{label}: rank {r} launched K1 {got['paged_decode_attention']}"
              f" and K5 {got['quant_matmul_int4']} times over {steps} decode "
              f"steps of {cfg.num_layers} layers")
        check(tr["k3_launches"] == MIXTRAL_TRAIN_LAYERS,
              f"{label}: rank {r}'s step launched K3 {tr['k3_launches']} "
              f"times, not {MIXTRAL_TRAIN_LAYERS}")
        for name in ("paged_decode_attention", "quant_matmul_int4",
                     "flash_attention_static"):
            launches.setdefault(name, []).append(got[name])
        check(all(t < cfg.vocab_size for s in st["streams"] for t in s),
              f"{label}: rank {r} served a token past the vocabulary")
        per_rank.append({
            "rank": st["rank"], "experts": st["experts"],
            "expert_leaves": st["expert_leaves"],
            "expert_bytes": st["expert_bytes"],
            "expert_bytes_share_of_one_rank": st["expert_bytes"]
            / one["expert_bytes"],
            "mem_after_boot_gb": http["mem_after_batcher"] / 1e9,
            "mem_share_of_one_rank": http["mem_after_batcher"]
            / one["engine_and_batcher_bytes"],
            "rehydrate_ms_a_layer": st["batch"]["rehydrate_ms_a_layer"],
            "decode_steps": {"batch": batch["steps"], "http": http["steps"]},
            "ms_per_decode_step": {
                k: v["decode_s"] * 1e3 / max(v["steps"], 1)
                for k, v in (("batch", batch), ("http", http))},
            "collective_share_of_step": batch["collective_s"]
            / max(batch["decode_s"], 1e-9),
            "combine_share_of_step": batch["expert_s"]
            / max(batch["decode_s"], 1e-9),
            "combines_per_step": batch["expert_calls"]
            / max(batch["steps"], 1),
            "launches": {k: got[k] for k in launches}})
    # s1: the batch against path m's one-rank engine.
    b0 = ranks[0]["batch"]
    check(b0["streams"] == ranks[1]["batch"]["streams"],
          f"{label}: the ranks' batch streams differ")
    held = _expert_agreement(b0["streams"], one["eager"], saved,
                             one["routes"], b0["slots"], cfg.num_layers, eos)
    emit("expert_s1", card=card, mesh={"expert": EXPERT_RANKS},
         backend="gloo", ranks=per_rank,
         one_rank={"engine_and_batcher_gb":
                   one["engine_and_batcher_bytes"] / 1e9,
                   "expert_bytes": one["expert_bytes"],
                   "rehydrate_ms_a_layer": one["rehydrate_ms_a_layer"]},
         batch_wall_s=b0["wall_s"], held_to_one_rank=held,
         http_s=http_s, http_prefix_hits=ranks[0].get("http_prefix_hits"),
         served={k: v for k, v in served.items() if k != "texts"})
    for r in per_rank:
        check(r["expert_bytes_share_of_one_rank"] == 0.5,
              f"{label}: rank {r['rank']} holds "
              f"{r['expert_bytes_share_of_one_rank']} of one rank's experts")
        check(r["mem_share_of_one_rank"] < EXPERT_MEM_SHARE,
              f"{label}: rank {r['rank']} holds "
              f"{r['mem_share_of_one_rank']:.3f} of the one-rank engine")
    check(held["first_event_near_tie"],
          f"{label}: the batch left the one-rank engine's first away from "
          f"a near-tie: tokens {held['diverged']}, routing "
          f"{held['first_routing_flip']}")
    lap("s1_held")
    # s2: the step against path m's one-rank step.
    loss_rel = abs(ranks[0]["train"]["loss"] - one_train["loss"]) / abs(
        one_train["loss"])
    s2 = [{**st["train"], **_step_held(*st["train"]["experts"], 0, t,
                                         one_train)}
          for st, t in zip(ranks, trained)]
    emit("expert_s2", card=card, mesh={"expert": EXPERT_RANKS},
         layers=MIXTRAL_TRAIN_LAYERS, one_rank_loss=one_train["loss"],
         one_rank_step_s=one_train["step_s"], loss_rel_err=loss_rel,
         ranks=s2, tol={"rel": TRAIN_GRAD_REL})
    check(all(st["train"]["loss"] == ranks[0]["train"]["loss"]
              for st in ranks), f"{label}: the ranks' losses differ")
    check(math.isfinite(ranks[0]["train"]["loss"])
          and loss_rel <= TRAIN_GRAD_REL,
          f"{label}: the step's loss is {loss_rel:.2e} from the one-rank "
          f"step's")
    for r in s2:
        check(r["grad_rel_err"] <= TRAIN_GRAD_REL
              and r["update_rel_err"] <= TRAIN_GRAD_REL,
              f"{label}: layer 0's w_gate experts {r['experts']}: gradient "
              f"{r['grad_rel_err']:.4f}, update {r['update_rel_err']:.4f} "
              f"from the one-rank step's")
    # s3: path p3's step at model=2 against its one-rank step.
    cols = trained_tp[0]["grad0"].shape[1]
    s3 = [{**st["train_tp"], **_step_held(r * cols, (r + 1) * cols, 1, t,
                                          tp_one)}
          for r, (st, t) in enumerate(zip(ranks, trained_tp))]
    tp_loss_rel = abs(s3[0]["loss"] - tp_one["loss"]) / abs(tp_one["loss"])
    emit("expert_s3", card=card, mesh={"model": EXPERT_RANKS},
         layers=TRAIN_CKPT_LAYERS, one_rank_loss=tp_one["loss"],
         one_rank_step_s=tp_one["step_s"], loss_rel_err=tp_loss_rel,
         ranks=s3, tol={"rel": TRAIN_GRAD_REL})
    check(all(r["loss"] == s3[0]["loss"] for r in s3)
          and tp_loss_rel <= TRAIN_GRAD_REL,
          f"{label}: the model=2 step's loss is {tp_loss_rel:.2e} from the "
          f"one-rank step's")
    # The partial sums over 'model' round differently from one rank's
    # products, so the gradients differ in bf16 and the update is held
    # where their signs are determined (``_step_held``).
    for r, t in enumerate(s3):
        check(t["grad_rel_err"] <= TRAIN_GRAD_REL
              and t["update_rel_err_sign_determined"] <= TRAIN_GRAD_REL,
              f"{label}: rank {r}'s layer 0 w_gate columns at model=2: "
              f"gradient {t['grad_rel_err']:.4f}, update "
              f"{t['update_rel_err_sign_determined']:.4f} where its sign is "
              f"determined, from the one-rank step's")
    del trained, trained_tp, saved, tp_one
    # Nothing after path s reads Mixtral's store or path m's results.
    for key in ("mixtral", "mixtral_train"):
        _SHARED.pop(key, None)
    drop_shared_store("mixtral_int4")
    _free(torch)
    return launches


PHASES = ("build", "kernel", "timing", "model", "serve", "tier", "spec",
          "constrain", "generate", "families", "expert", "fleet", "elastic",
          "mesh", "pipe", "seq", "train", "profile")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    if not (REPO / "distributed_llms_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(distributed_llms_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    kernels = {name: {"name": name, **info, "launches": None,
                      "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None, "library_ms": None}
               for name, info in KERNELS.items()}
    t_start = time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            emit("phase_time", name=phase,
                 seconds=time.perf_counter() - t0,
                 since_start_s=time.perf_counter() - t_start)

    profile = "profile" in phases
    try:
        if "build" in phases:
            timed("build", phase_build)
        if "kernel" in phases:
            for name, got in timed("kernel", phase_kernel, torch).items():
                kernels[name].update(got)
        if "timing" in phases:
            for name, got in timed("timing", phase_timing, torch).items():
                kernels[name].update(got)
        if "model" in phases:
            timed("model", phase_model, torch)
        if "serve" in phases:
            for name, n in timed("serve", phase_serve, torch,
                                 profile).items():
                kernels[name]["launches"] = n
        if "tier" in phases:
            # Path i runs K1 and K1q too; paths a and b keep the line's
            # counts (their own paths).
            emit("serve_tier_launches", **timed("tier", serve_tiered, torch))
        if "spec" in phases:
            # Path j's launches ride beside each kernel's own path's.
            for name, n in timed("spec", serve_spec, torch, profile).items():
                kernels[name]["spec_launches"] = n
        if "constrain" in phases:
            # Path k's launches ride beside each kernel's own path's.
            for name, n in timed("constrain", serve_constrain,
                                 torch).items():
                kernels[name]["constrain_launches"] = n
        if "generate" in phases:
            # Path l's launches ride beside each kernel's own path's.
            for name, n in timed("generate", serve_generate, torch).items():
                kernels[name]["generate_launches"] = n
        if "families" in phases:
            # Path m's launches ride beside each kernel's own path's.
            for name, n in timed("families", serve_families, torch).items():
                kernels[name]["families_launches"] = n
        if "expert" in phases:
            # Path s's launches, one count a rank.
            for name, n in timed("expert", serve_expert, torch).items():
                kernels[name]["expert_launches"] = n
        if "fleet" in phases:
            # Path n's launches (every replica's, process-wide) ride
            # beside each kernel's own path's.
            for name, n in timed("fleet", serve_fleet, torch).items():
                kernels[name]["fleet_launches"] = n
        if "elastic" in phases:
            # Path o's launches (o1's replicas and o2's in-process worker)
            # ride beside each kernel's own path's.
            for name, n in timed("elastic", serve_elastic, torch).items():
                kernels[name]["elastic_launches"] = n
        if "mesh" in phases:
            # Path p's launches, one count a rank of each mesh leg.
            for name, n in timed("mesh", serve_mesh, torch).items():
                kernels[name]["mesh_launches"] = n
        if "pipe" in phases:
            # Path q's launches, one count a stage.
            for name, n in timed("pipe", serve_pipe, torch).items():
                kernels[name]["pipe_launches"] = n
        if "seq" in phases:
            # Path r's launches, one count a rank of each leg.
            for name, n in timed("seq", serve_seq, torch).items():
                kernels[name]["seq_launches"] = n
        if "train" in phases:
            kernels["flash_attention_static"]["launches"] = timed(
                "train", phase_train, torch, profile)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if "dir" in _SHARED:
            shutil.rmtree(_SHARED["dir"], ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    if set(phases) != set(PHASES):
        print("partial run: no result line", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
