#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``singa_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero:

1. ``build``      - compiles every kernel source of ``singa_tpu_torch/csrc``
                    (flash attention, the ResNet bottleneck, paged
                    attention) with nvcc for
                    sm_90a, one nvcc process per source, all at once; then
                    reports each kernel's registers and spills (ptxas
                    ``-v``) and counts its warp-level (HMMA) and
                    warpgroup (HGMMA) tensor-core instructions, its TMA
                    loads (UTMALDG) and its local-memory (LDL/STL)
                    instructions in its SASS (``cuobjdump -sass``); fails
                    if a tensor-core kernel (``TENSOR_CORE_KERNELS``: the
                    three flash kernels and the bottleneck) is missing, if
                    a ``*_tc_kernel`` has no tensor-core instruction, or
                    if a Hopper ``*_wg_kernel`` lacks HGMMA or UTMALDG.
2. ``kernels``    - holds ``flash_fwd``, ``flash_bwd_dq`` and
                    ``flash_bwd_dkv`` against their plain PyTorch versions
                    on the card: at GPT-2 small's attention shape (B=8,
                    H=12, S=1024, D=64, causal, bf16 and float16), at
                    BERT-base's (B=16, H=12, S=512, D=64, non-causal,
                    with no mask as its training step runs them and under
                    a ragged key-padding mask, bf16 and float16, timed
                    against PyTorch's fused attention with the same
                    additive mask or none), and at edge shapes in float32, bf16
                    and float16 (key mask, a fully -inf-masked row,
                    general masks, sliding windows, no mask at S=200,
                    S=1/65/129/1000,
                    D=8/13/72/96/128/160/320/512/640/1000/1024/1792), where
                    bf16 and float16 with D <= 128 run the tensor-core
                    kernels
                    (``fwd_wg_kernel`` / ``dkv_wg_kernel`` on wgmma and
                    TMA, ``dq_tc_kernel`` on mma.sync; D = 13 through a
                    zero-padded copy) and the rest the CUDA-core ones
                    (past D = 512 their 8-row rung); and times each
                    kernel, its plain
                    version and PyTorch's fused attention, forward and
                    backward (a yardstick the port never calls).
3. ``slice``      - trains GPT-2 small (124M, n_positions 1024, so
                    attention runs through the flash kernels) with bf16 amp
                    and SGD(lr=1e-4, momentum=0.9) on a batch of 8 x 1024
                    random ids, as ``bench.py``'s ``bench_gpt2`` configures
                    the JAX package, in graph mode (``use_graph=True``: the
                    step captured as a CUDA graph and replayed), 5 steps,
                    against 5 eager steps from the same weights: losses and
                    weights within ``CAPTURE_RTOL`` (worst difference
                    logged), host-clock step medians of both, exactly 12
                    launches of each kernel per replayed step, all on the
                    tensor-core route, the flash kernels named by the
                    profiler in a replayed step, ``graph.cache_miss`` flat
                    after the first step, the time of copying out the
                    logits, the dropout pin (``dropout_pin``), and the
                    logits of an eval forward against the same weights on
                    the plain ("fused") attention path; then two graph-mode
                    steps under ``amp.set_compute_dtype("float16")``
                    (``slice_f16``): finite losses, every flash launch on
                    the tensor-core route (the kernels line's ``_f16``
                    rows); and ``train.mfu`` (``slice_mfu``): a fresh
                    graph-mode model with the monitor on, its step's FLOPs
                    counted at the first call (aten's products and the
                    flash wrappers' credits), 20 replays, the meter's MFU
                    against tokens/s x (6 N_mm + 12 L S d) over the same
                    peak (989e12 on an H100 SXM), within
                    ``MFU_AGREEMENT``.
4. ``profile``    - device time per kernel group (flash, GEMMs, the rest)
                    and the device's busy share over 2 more steps of each
                    mode, from torch.profiler; fails if the profiler
                    records no device time.
4a. ``io``        - the data and persistence layer at the slice's
                    configuration (GPT-2 small, 8 x 1024, bf16 amp,
                    SGD(1e-4, 0.9), graph mode, the three flash kernels):
                    64 windows of 1025 random token ids written to a
                    BinFile dataset by ``io.loader.write_dataset`` through
                    the native codec (fails unless it built), 6 captured
                    steps fed by ``DataLoader(num_workers=1)``, checkpoints
                    by ``save_checkpoint`` at steps 2 and 4 (``keep=2``,
                    the step, the loader's epoch seed and batch in
                    ``aux_states``); one byte of step 4's states flipped,
                    ``restore_latest_checkpoint`` must fall back to step 2
                    with ``resilience.checkpoint_fallbacks`` + 1, and a
                    fresh model replays steps 3-6 from the loader: losses
                    and every state (weights, momentum, step counter) bit
                    for bit the uninterrupted run's, under
                    deterministic algorithms; a ``Snapshot`` of the
                    weights written and read back bit for bit; the
                    seconds of a save and of the restore, the loader's
                    host ms a batch at 1 and 4 workers beside the
                    captured step's ms, and ``augment_batch``'s images/s
                    on 128 uint8 images at 256 x 256 -> 224 x 224.
5. ``bert``       - trains BERT-base (``BertConfig.base()``, 110M in the
                    trunk) as ``bench.py``'s ``bench_bert`` configures it:
                    batch 16 x 512 random ids and labels from a numpy seed,
                    bf16 amp, SGD(1e-4, 0.9), default dropout, graph mode
                    against eager from one state (``CAPTURE_RTOL``, under
                    deterministic algorithms), once on the fused attention
                    path and once with ``use_flash=True`` (12 launches of
                    each flash kernel a replayed step); host ms a step,
                    device ms by group, busy share, samples/s; eval
                    forwards through the kernels against the fused path,
                    float32 and bf16, with no mask and a ragged
                    ``attention_mask`` (``BERT_LOGITS_ATOL``), the mask
                    dropped on purpose refused.
6. ``onnx``       - ONNX interop at BERT-base's full width (133.5M
                    float32 parameters with the masked-LM head): the
                    model built with ``use_flash=True`` and no dropout
                    from a seed, exported by ``sonnx.to_onnx`` at batch
                    2 x 512 in float32 (the flash forward kernel,
                    ``fwd_kernel``, runs inside the export's record: 12
                    launches), saved, loaded and imported; the imported
                    graph's op types as the record predicts them; its
                    sequence and pooled outputs against the native flash
                    forward in float32 (``BERT_LOGITS_ATOL``) and under
                    bf16 amp (``fwd_wg_kernel``), and a second export with
                    an ``attention_mask`` against the native forward under
                    a ragged mask.  Then the imported graph, wrapped in
                    ``SONNXModel``, trains at ``bench_bert``'s
                    configuration (16 x 512, bf16 amp, SGD(1e-4, 0.9),
                    the masked-LM loss): eager against graph mode under
                    deterministic algorithms, bit for bit, finite losses;
                    its first loss against a native fused BERT loaded with
                    its weights through a ``save_states`` zip (1e-2
                    relative); each mode timed (host ms a step, device ms
                    by group, busy share, samples/s) beside the same
                    native model (fused, no dropout).  Last, the repo's
                    foreign ONNX fixtures imported on the card against
                    their goldens.
7. ``charrnn``    - trains the char-RNN as ``bench_charrnn`` configures
                    it (batch 64 x 100, vocab 100, hidden 256, 2 LSTM
                    layers, SGD(0.1), float32), graph mode against eager,
                    then ``train_n_batches`` over 10 stacked batches; host
                    ms a step, device ms, busy share; cuDNN's LSTM on the
                    same weights as a yardstick the port never calls.
8. ``resnet``     - trains ResNet-50 (25.6M parameters, full depth and
                    width) at ``bench.py``'s ``bench_resnet50``
                    configuration: batch 128 x 3 x 224 x 224 random images
                    and labels from a numpy seed, 1000 classes, bf16 amp,
                    SGD(lr=0.1, momentum=0.9), graph mode against eager as
                    in ``slice``; checks finite losses and running
                    statistics; then ``resnet_profile``: device time by
                    group (convolutions, batch norm, the rest) over 2 more
                    eager steps, and the busy share of both modes.
9. ``bottleneck`` - the trained ResNet-50 in eval mode: the activation
                    that enters ``layer1[1]`` (stem + ``layer1[0]``, batch
                    128, 56 x 56 x 256, channels-last bf16) goes through
                    ``megakernel_block`` with ``fold_bottleneck(layer1[1])``
                    (the one launch counted for the tensor-core
                    ``bottleneck_tc_kernel``), is held
                    element by element against ``megakernel_block_plain``
                    and, loosely, against the port's own eval forward of
                    ``layer1[1]``; the same gate must refuse two planted
                    faults (y1's ring padded with relu(b1), the skip left
                    out of one column);
                    then edge cases (B=1, 7 x 7, 56 x 28, C=128 with CM=32,
                    CM=128, b1=+1, random scales and biases) and times of
                    the kernel, its plain version and the cuDNN chain
                    (three channels-last bf16 convs and the elementwise
                    work; no single PyTorch call computes the block).
10. ``zoo``        - the CNN zoo at its published widths and input sizes,
                    each trained through ``Model.compile(use_graph=True)``
                    and ``train_one_batch`` with bf16 amp, a batch of 32
                    random images from a numpy seed and
                    ``examples/cnn/train_cnn.py``'s SGD(0.005, 0.9, wd
                    1e-5): CNN (28², 1 channel), AlexNet, VGG-16 and
                    MobileNetV2 (224²), Xception (299²) and
                    ``UNet(num_classes=2, base_channels=16, depth=3)``
                    (256², per-pixel labels); 3 eager steps against 3 in
                    graph mode from one state and one generator seed
                    (losses and weights within ``CAPTURE_RTOL``, finite
                    losses), then one profiled step of each mode: host
                    ms a step, device ms, busy share and images/s beside
                    the card's name and power limit.  Then the VGG-16
                    checkpoint check (``checkpoint_check``: the step
                    after ``save_states``/``load_states`` into a fresh
                    model and optimizer, and after an ``async_save``
                    taken between replays, bit for bit equal to the
                    uninterrupted step), the MLP at
                    ``examples/mlp/train.py``'s configuration (float32,
                    batch 64) the same way, that script's flow (eval
                    accuracy > 0.9), and ``schedule_probe`` (an
                    ``ExponentialDecay`` rate read off replayed steps
                    against its formula).
10a. ``dist``      - data-parallel training, BASELINE config 5: ResNet-152
                    (60.2M), 64 x 224² random images from a seed, bf16
                    amp, ``DistOpt(SGD(0.005, 0.9, wd 1e-5))``, spars
                    0.05 (``examples/cnn/train_dist.py``'s defaults), one
                    process joined to a one-rank NCCL group
                    (``initialize_distributed`` on a localhost port).
                    Each ``dist_option`` (plain, fp16, partialUpdate,
                    sparseTopK, sparseThreshold), under deterministic
                    algorithms: 4 eager steps against 4 graph-mode ones
                    (eager first call, capture, replays) from one seed,
                    every state bit for bit, the collectives traced while
                    the step was captured (``comms/*`` events), the bytes
                    issued against ``dist_wire_bytes``; then host ms of 6
                    replays, images/s, a 2-replay profile (busy share,
                    device ms by group), ``comms.collectives`` and
                    ``comms.bytes`` a step.  The bare SGD and top-K at
                    spars 1.0 equal plain bit for bit.  Then two ranks
                    on the one card over gloo (NCCL takes one rank a
                    GPU): this script spawned twice with ``--dist-rank``
                    (joined within 300 s; a rank that fails fails the
                    phase), an MLP (64 -> 256 -> 10, float32) 4 eager
                    steps of partialUpdate and of sparseTopK on CUDA
                    tensors and then on the CPU from the same weights,
                    every parameter and residual within
                    ``DIST_TWIN_ATOL``.
10b. ``shard``     - sharded training (``parallel/{sharding,
                    ring_attention,pipeline}.py``, the planned step).
                    This script spawned twice with ``--shard-rank``, two
                    gloo ranks on the one card (joined within
                    ``SHARD_JOIN_S``), both starting from zips of seeded
                    one-card models: the zigzag causal ring at GPT-2
                    small's attention shape and the contiguous ring under
                    a ragged key mask at BERT-base's, bf16, through the
                    flash kernels, forward and dQ/dK/dV held element by
                    element against the same ring on the plain versions
                    and one ``flash_attention_lse`` over the whole
                    sequence (``TOL[bf16]``, as ``torch.allclose``), the
                    same check refusing each planted ring fault
                    (``RING_FAULTS``), fwd + bwd ms of each; GPT-2
                    small at (dp, tp, sp) = (1, 1, 2) and BERT-base at
                    tp = 2, full width, bf16 amp, no dropout, eager steps
                    against the serial model from the same zip on rank 0
                    (losses within ``SHARD_LOSS_RTOL``, every state within
                    ``SHARD_WITNESS_MAX`` of the serial bf16 run's distance
                    from the float32 serial run, ``float32_witness``),
                    and the same steps in float32 against the serial
                    float32 run, losses and states (``SHARD_F32``); the
                    flash launches of the planned
                    steps counted from 0 around them (each kernel at
                    least once), ms a step, tokens/s a card, a profiled
                    step's busy share.  Then GPT-2 small under a plan of
                    every axis 1 over a one-rank NCCL group and without a
                    plan: graph-mode steps equal eager ones, and the
                    planned ones the plan-less ones, bit for bit, 12
                    launches of each kernel a captured step.
11. ``serve``      - serves GPT-2 small (124M, 12 layers, n_positions 1024,
                    random weights from a seed) through the paged engine,
                    ``model.serve(max_slots=8, paged=PagedConfig(
                    block_size=32, num_blocks=256))``, every decode step a
                    replay of its width bucket's captured graph: 24
                    requests at once, prompts of 16-512 tokens, 32-128 new
                    tokens, alternately greedy and at temperature 0.9 with
                    their own seeds.  In float32: the captured engine's
                    streams equal the eager engine's (``capture=False``),
                    the gather oracle's and offline ``generate``'s token
                    for token, ``paged_attn`` launches 12 times a decode
                    step, no block is in use after the drain, every
                    request completes by its length, and the serve census
                    (``jit_cache_size``) grows by one graph per width
                    bucket used and then stays flat.  In bf16: the same
                    traffic timed, captured and eager (TTFT and TPOT
                    medians, decode tokens/s), once each under
                    torch.profiler (the device's busy share), once eager
                    with every step's logits held against the gather
                    oracle on a copy of the pool (``SERVE_BF16_LOGITS_ATOL``)
                    and against a gather engine's streams up to each
                    request's first token whose top-2 margin is below it.
                    Then, float32 and captured: a pressured priority engine
                    (8 slots, ``PagedConfig(block_size=32, num_blocks=64)``,
                    12 requests of 200-500-token prompts and 32 new
                    tokens, a priority-0 wave then a higher-priority one)
                    that must preempt and resume, streams equal to offline
                    ``generate``, no block left, the census flat; and
                    ``GPT2Config.tiny`` (D = 16) served on the card,
                    streams equal to offline ``generate``.  Last, the
                    traffic captured in float16 (``paged_attn`` on float16
                    pools: the kernels line's ``paged_attn_f16`` row), 12
                    launches a decode step.
12. ``serve_int8`` - the same model and traffic on int8 pools
                    (``cache_dtype="int8"``): float32 streams equal the
                    int8 gather oracle's and offline int8 ``generate``'s,
                    the int8 kernel 12 launches a decode step, no block
                    left; the pressured priority engine on int8 pools
                    preempts and swaps (scales with the values) and
                    matches offline int8 ``generate``; bf16 timed (TTFT,
                    TPOT, decode tokens/s) and profiled (busy share), the
                    int8 kernels' main path, beside the bf16 pools.
13. ``serve_slots`` - the same traffic through ``model.serve()`` without
                    ``paged=`` (the slot arena, 8 slots of 1024 lanes),
                    dense and int8: float32 streams equal offline
                    ``generate``'s at the same ``cache_dtype``, exactly
                    one captured graph, the census flat; bf16 timed and
                    profiled.
14. ``generate``  - the serve phase's float32 GPT-2 small past
                    n_positions: a 1000-token prompt and 40 greedy tokens
                    take the windowed path (12 flash forward launches a
                    token), equal to the KV-cached ``generate`` over the
                    24 tokens that fit; ``min_p`` and
                    ``repetition_penalty`` on the KV-cached path.
14a. ``prefix``    - GPT-2 small in bf16 on the paged arena (8 slots,
                    ``PagedConfig(block_size=32, num_blocks=256)``) with
                    the radix prefix cache on its blocks
                    (``PrefixCacheConfig(block_size=32, num_blocks=256)``):
                    a primer request, then 24 greedy requests sharing a
                    512-token system prompt, each with its own 32-96-token
                    suffix and 64 new tokens (the hit share of their
                    prompt tokens must exceed 0.8; some decode steps must
                    read shared blocks through ``paged_attn``, 12 launches
                    a decode step), each stream equal to the same request
                    on an engine without the cache up to its first token
                    whose top-2 margin is under ``SERVE_BF16_LOGITS_ATOL``;
                    the batch again with no decode graph captured; 4
                    three-turn ``pin_session`` conversations, each turn the
                    whole history, held the same way; block accounting
                    (``used == cached + live_referenced``) after every
                    step; TTFT of prompts alone, warm (system prompt
                    cached), cold on the cache-less engine and cold
                    through the chunked path; then a 64-block pool the
                    traffic overflows: the tree evicts, a pinned session's
                    blocks survive, the streams hold.
14b. ``spec``      - speculative decoding on the serve phase's engine and
                    traffic, ``spec_k`` 4, with a 2-layer draft of GPT-2
                    small's widths holding the target's embeddings, first
                    blocks and final LN, and with the target as its own
                    draft: float32 greedy streams equal the
                    non-speculative engine's (paged, slot arena, int8
                    pools), every verify one ``paged_attn`` launch a
                    layer at Q = 4 (``paged_attn.chunk_launches``), the
                    census flat; bf16 timed (acceptance, tokens a step,
                    TTFT, TPOT, decode tokens/s beside the
                    non-speculative engine's), greedy streams equal the
                    non-speculative bf16 ones up to the first low-margin
                    token; offline ``generate_speculative`` == greedy
                    ``generate``.
14c. ``longctx``   - float32: the chunked-prefill budget (7 chats
                    decoding, then a 960-token prompt admitted with
                    ``prefill_token_budget=256`` and without: streams
                    equal, the step-to-step gaps while it admits, its
                    TTFT); GPT-2 small with ``attn_window=256`` serving 8
                    requests to 1024 positions (== offline windowed
                    ``generate``, block accounting every step, at most 9
                    blocks a slot, a 512-token prompt admitted in window,
                    TPOT past position 700 beside the dense model's),
                    then on int8 pools and with the 2-layer draft.
14d. ``fork``      - best-of-n and tree search on the serve phase's
                    engine: 6 prompts of 128-512 tokens, ``n = 4``, 64 new
                    tokens.  float32 greedy, twice on one engine: every
                    branch equals the ``n = 1`` engine's stream and offline
                    ``generate``'s, the second pass captures no graph.
                    bf16 at temperature 0.8, after a warm-up pass: the
                    measured pass (``paged_attn`` one launch a layer a
                    step over tables whose prompt blocks several slots
                    name: the ``paged_attn_fork`` row's main path; no
                    graph captured), branch 0 equals the ``n = 1`` stream
                    up to its first low-margin token, the siblings
                    diverge, ``ranked()`` orders by score; peak blocks,
                    copy-on-write copies, ``serve.fork.*`` and TPOT beside
                    the same requests unforked four times.  float32: a
                    request forked twice mid-stream and one branch pruned
                    (the parent equals offline ``generate``, the pruned
                    branch's private blocks come back), and a forked group
                    preempted by higher-priority arrivals on a 40-block
                    pool, resumed with the roomy pool's streams.
14e. ``structured`` - ``JsonSchemaAutomaton`` (integer, boolean, string
                    and enum properties) over a 50257-string vocabulary
                    from a seed (no GPT-2 tokenizer in the repo): 8 float32
                    greedy requests, twice on one engine, equal to a
                    masked-greedy oracle on the dense cache, each output
                    JSON of the schema; the second pass captures no graph;
                    mask-building ms a step (first visits, memoized) and
                    TPOT beside the requests unconstrained; one ``n = 2``
                    sampled structured request, both branches valid.
14f. ``beam``      - ``generate_beam`` with 4 beams on 8 prompts of 64
                    tokens and 8 ragged ones, 32 new tokens: one beam
                    equals greedy ``generate`` (float32), every beam's
                    total equals its teacher-forced rescoring, the top
                    beam's total beside greedy's, and ms a generated
                    token in bf16 beside ``generate``'s (the dense cache,
                    as in the JAX package: no hand-written kernel).
14g. ``observe``   - the serve phase's model, arena (8 slots, 256 blocks
                    of 32) and 24 requests, each run twice on one engine
                    (a warm-up pass, then the measured pass, which must
                    capture no graph and launch ``paged_attn`` 12 times a
                    decode step).  float32 with the request ledger, the
                    step profiler, the monitor (watchdog, flight recorder,
                    MFU meter), tracing and ``slo=SLO(...)`` all on, then
                    all off: the streams equal each other and offline
                    ``generate``, every request's ledger TTFT equals its
                    handle's.  bf16, one call: TPOT medians with the hooks
                    off, with the ledger, monitor and SLO on, and with the
                    step profiler on; the profiler's device span a step
                    beside torch.profiler's device time of the same 20
                    steps.  ``health_report()`` JSON, Prometheus text and
                    a Chrome trace (spans, request tracks, step lanes)
                    written to a temporary directory: sizes, keys.
14h. ``supervisor`` - ``EngineSupervisor`` over the same engine and
                    requests, float32: ``FailAfterN(2, times=1)`` at
                    ``serve.decode_step`` makes one restart
                    (``resilience.engine_restarts`` + 1); the requests the
                    dead engine had not started stream as offline
                    ``generate`` does, those in flight fail with
                    ``EngineFailedError(started=True)``; the rebuild's
                    seconds and the graphs the new engine captures (it
                    re-captures each width: ROADMAP "Divergences").
                    ``FailRate(1.0)`` with a budget of 1 ends in
                    ``RestartBudgetExceededError``, every handle typed.
                    A priority engine with ``SLO(queue_depth_max=4)`` and
                    ``shed_on_slo_pressure``: the 24 requests in a burst;
                    the shed handles raise ``LoadShedError`` and the
                    refused arrivals raise at submit, counted exactly by
                    ``serve.shed_requests{reason=slo_pressure|
                    slo_admission}``.
14h2. ``fleet``   - the in-process fleet over GPT-2 small replicas, each
                    the serve phase's engine (8 slots, 256 blocks of 32)
                    with a prefix cache and top-k 50: threefry on the card
                    first (an 8 x 50257 draw's bits and uniforms equal the
                    host chain's, its Gumbels within ``GUMBEL_TOL``, the
                    ``THREEFRY_KNOWN`` answers taken from ``jax.random``,
                    the draw's device ms beside a bf16 decode step's at 8
                    slots).  float32, the serve traffic (the sampled half
                    at 0.8): 3 mixed replicas' streams equal one engine's
                    and offline ``generate``; roles (prefill, decode,
                    decode) on 4 prompts of 512-960 tokens: 4 ships,
                    streams equal ``generate``'s, ms and bytes a ship; one
                    more long prompt alone, its TTFT cold on the mixed
                    fleet and shipped (streams equal); a ``serve.kv_ship``
                    fault requeues cold, stream kept; the decode replicas'
                    tables recorded for row 5d.  Failover (the 12 sampled
                    requests, 2 slots a replica, restart budget 0):
                    ``FailAfterN(4, times=1)`` at ``serve.decode_step``
                    fails one replica over, its never-started requests
                    requeue with their streams, started ones fail typed,
                    seconds from the fault to the last requeued first
                    token; ``revive``, then hedges with the router pinned
                    to replica 0.  The autoscaler under an injected clock:
                    a burst adds a replica (its captures and their
                    seconds), quiet drains and retires one.  bf16, no
                    prefix cache: 3 replicas against one engine on the 24
                    requests after a warm-up pass of 8 a replica, TPOT
                    medians and decode tokens/s.
14h3. ``dist_fleet`` - the fleet across the process boundary
                    (``serve/dist``): ``DistFleet`` over ``gpt2_spec`` of
                    the same GPT-2 small, each worker a spawned process
                    with its own CUDA context, engine (the fleet phase's:
                    8 slots, 256 blocks of 32, prefix cache, top-k 50)
                    and captured steps.  float32, the serve traffic: 2
                    workers' streams equal the in-process 2-replica
                    fleet's; a ``blip_worker`` mid-decode resumes without
                    failover (resume seconds); a controller ``crash``
                    mid-decode and ``DistFleet.adopt`` (adopt seconds,
                    every request resumed, delivered once or requeued,
                    none rejected, streams equal); a ``kill_worker``
                    mid-decode fails over, the never-started requests
                    requeue onto the survivor with their streams (seconds
                    kill -> replica down -> requeued -> last requeued
                    first token), no block leaked on the survivor; roles
                    (prefill, decode) on the fleet phase's long prompts:
                    every ship streamed layer-wise while the source
                    prefills, the staged image admitted against the
                    source export's header and crc32, streams equal the
                    in-process disaggregated fleet's, ship seconds, bytes
                    and hidden share, no leaked block; one float32 pass
                    with worker threads.  bf16, no prefix cache, the step
                    profiler on: one engine and the in-process 3-replica
                    fleet, then 2 workers and 3 (one added to the running
                    fleet), each after a warm-up pass: TPOT medians,
                    decode tokens/s and device seconds over run seconds
                    (the workers' profilers, pulled over the wire).
                    ``paged_attn`` launches pulled from every worker's
                    telemetry; fails if a decoding worker launched none.
14i. ``moe``       - GPT-2 small with every second MLP a mixture of 8
                    experts (top-2, capacity 1.25, aux weight 0.01; 0.32B
                    parameters), trained as ``slice`` trains GPT-2 small
                    (8 x 1024, bf16 amp, SGD(1e-4, 0.9), dropout 0): 4
                    eager against 4 graph-mode steps from one seed under
                    deterministic algorithms (``CAPTURE_RTOL``), 12
                    launches of each flash kernel a replayed step on the
                    tensor-core route (credited to the kernels line),
                    host ms a step, tokens/s, busy share, and each MoE
                    layer's kept tokens per expert and dropped share
                    (``parallel.moe.dispatch_load``); then the same
                    model served on the serve phase's engine and traffic
                    (``observed_run``: a warm-up pass, then a measured
                    pass that captures no graph and launches
                    ``paged_attn`` 12 times a step): float32 streams
                    equal the gather oracle's and offline ``generate``'s;
                    bf16 TTFT and TPOT medians.
14j. ``serve_shard`` - sharded serving (``serve/tp.py``, ``ep.py``,
                    ``pp.py``): two gloo ranks on the card, rank 0 the
                    engine and rank 1 its mirror (``serve.shard``),
                    ``capture=False`` (gloo cannot be captured), GPT-2
                    small at full width from a seed: tp = 2, pp = 2 (4
                    microbatches), ep = 2 on the MoE model of ``moe``
                    (served, not trained: its random init), and tp = 2
                    with the ring-attention prefill on prompts of
                    512-1000 tokens.  Each serves its float32 greedy
                    requests (``serve_shard_traffic``) with streams equal
                    to the one-card engine's and ``generate``'s, then one
                    bf16 pass: TPOT and decode tokens/s beside the
                    one-card engine's (host staging through gloo, not a
                    throughput).  Every rank's ``paged_attn`` and flash
                    launches a sharded engine; the tp = 2 ones are row
                    ``paged_attn_tp2`` (6 heads a rank), timed with the
                    kernel at 3 heads (tp = 4) over tables of the
                    traffic's positions (row 5tp).  Then a fleet of 2
                    tp = 2 replicas on 3 gloo ranks
                    (``serve_fleet_controller``: rank 0 both replicas'
                    engines and first shards, ranks 1 and 2 a mirror
                    each), eager: float32 streams equal the one-card
                    engine's, each replica's ranks, ``add_replica``
                    refused, bf16 TPOT beside one card's; its launches on
                    every rank join row 5tp's.
15. ``paged_kernels`` - ``paged_attn`` (its split and combine kernels)
                    against ``paged_attn_plain``, on float32, bf16 and
                    float16 pools and on int8 pools with float32, bf16
                    and float16 q, at the edge cases of
                    ``paged_edge_cases`` (block sizes 1 to 32, partial and
                    full last blocks, all-trash and one-block tables, GQA
                    g = 3, D = 16/20/40/80/128/256/640/1024, Q = 4 with a
                    tril mask, GQA groups of 32 query rows and of 6 heads
                    at D = 1024 (launched in groups of heads), Q = 24
                    and 40 query positions (launched in runs of
                    positions), windows, 1000-lane slots, a long slot beside short
                    ones; one split of the key range and several), and at
                    tables of 12 layers' pools: one decode step's real
                    tables from the serve phase with bf16 pools, with
                    int8 pools (bf16 q), with float16 pools and with int8
                    pools (float16 q), and two 1000-lane slots, where it
                    times the kernels, their plain version and SDPA on
                    rows gathered from the pool (the yardstick; the
                    gather, and the dequantization of int8 pools, not
                    timed); then, timed the same way, at the spec
                    phase's verify step (Q = 4,
                    bf16 and int8 pools) and the longctx phase's windowed
                    step (float32; read from table entry 0 as the engine
                    reads it, and from the JAX engine's bound), and at the
                    fork phase's step (bf16 pools: row ``paged_attn_fork``;
                    int8 pools, logged).
16. ``device``    - the card's name and power limit from nvidia-smi.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the
main path (the graph-mode runs: a replay credits the launches its graph
holds), error, times and bound, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Needs a CUDA GPU; there is no CPU
mode.

    python3 chip_smoke.py --dist-world N

runs only the ``dist`` phase's ResNet-152 modes, one process a GPU over
NCCL, at world size 1 and then N (``dist_world``): each rank draws its
own 64 images from seed 1000 + rank, and in every mode checks its
graph-mode steps against as many eager ones from the same weights (at
W > 1 partialUpdate takes ``dist_steps``: every phase's graph captured
and then replayed), bit for bit at W = 1 and within ``DIST_WORLD_RTOL``
of each state's update at W > 1, and every state against rank 0's bit
for bit.  One JSON line a world size: rank 0's report for each mode and
every rank's ms a step.  Then ``shard_world`` at N (``--phases dist``
or ``--phases shard`` runs one of the two): one process a GPU over NCCL,
GPT-2 small at (dp, tp, sp) = (2, 1, 2) and (1, 1, 4) and BERT-base at
tp 2 x sp 2 (bf16 amp), eager steps against graph-mode ones bit for bit
(the ring's point-to-point hops and the collectives inside the graph)
and every rank's states against the ranks holding the same shards; GPipe
over the pipe axis at GPT-2 small's width and depth against one card
(float32); one JSON line.  Needs N GPUs.

    python3 chip_smoke.py --dist-world N --phases serve_shard

runs ``serve_shard`` at N ranks, one a GPU, over NCCL: tp = N, pp = N
(4 microbatches), ep = N and tp = N with the ring prefill, each mode's
captured streams against its eager ones and its float32 streams against
the one-card engine's, token for token; bf16 TPOT, decode tokens/s and
the busy share of rank 0's decode steps beside the one-card engine's.
A fleet of sharded replicas runs on one card over gloo only (phase
``serve_shard``): over NCCL, with rank 0 holding a first shard on each
of two cards, it hung (``singa_tpu_torch/serve/shard.py`` refuses that
layout with ``FleetLayoutError``).  ``python3 chip_smoke.py --phases
serve_shard`` runs the one-card phase alone.

    python3 chip_smoke.py --shard-faults

runs only the shard phase's two ranks, with each of
``SHARD_TRAIN_FAULTS`` planted after the sound runs: one JSON line of
every gate's readings, sound and planted; exits 0 only when the sound
runs pass both training gates and both gates refuse every planted fault.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# cuBLAS reads its workspace configuration when it first runs: a fixed one
# keeps its GEMMs deterministic, which ``deterministic`` relies on
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM data-sheet peaks (dense), used for the bound of each kernel;
# float16's tensor-core peak equals bf16's
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

DEVICE = torch.device("cuda")
GPT2_SHAPE = dict(b=8, h=12, s=1024, d=64)
#: BERT-base's attention at bench_bert's batch 16 x 512
BERT_SHAPE = dict(b=16, h=12, s=512, d=64)
FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# kernel vs plain version, allclose(rtol, atol):
#   float32 - both sum in float32, in another order: 1e-4;
#   bf16    - inputs and outputs are bf16 (8-bit mantissa, 2^-8 = 0.4%
#             relative), and p / dS are rounded to bf16 against the
#             running max in the kernel but the final max in the plain
#             version: 2e-2 on O, lse and dQ/dK/dV.
#   bottleneck - per element (``bottleneck_stats``): bf16 in and out,
#             float32 sums in other orders, y1, y2 and out rounded to bf16
#             at the same points.  An output whose sum lands on the other
#             side of a rounding boundary moves by one bf16 ulp of itself;
#             a y1 or y2 element that rounded the other way moves the
#             float32 sum of an output by one ulp of one of its CM terms,
#             far below 2^-7 of the outputs' RMS.  So every element within
#             1 ulp_bf16(|want|) + 2^-7 * rms(want); and such roundings
#             are rare (on an H100, the tensor-core kernel: 2.4e-4 of the
#             elements at the real layer1[1] input, at most 5.0e-4 on the
#             edge cases), so at most 0.2% of the elements may differ at
#             all.
#   float16 - inputs and outputs are float16 (11-bit significand, 2^-11 =
#             0.05% relative, 8x finer than bf16), rounded at the same
#             points as bf16; its 5 exponent bits make p and dS terms
#             below 2^-14 subnormal (absolute steps of 2^-24, rounded
#             alike by the plain version): 1e-2 on every output.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
       torch.float16: (1e-2, 1e-2),
       "bottleneck": dict(ulps=1, rtol=0.0, rms_atol=2.0 ** -7,
                          max_differing=2e-3)}
# GPT-2 small logits, flash kernels vs the plain attention path, both
# under bf16 amp: 12 blocks of bf16 activations round differently along
# the two paths; logits here are O(1).
LOGITS_ATOL = 0.1
#: train.mfu (the counted step FLOPs x the step rate) against tokens/s x
#: the analytic FLOPs a token, over the same peak: the two may differ by
#: this share (what aten counts beyond 6 N_mm + 12 L S d, timing spread)
MFU_AGREEMENT = 0.10
# BERT-base MLM logits, the flash kernels vs the fused path on the same
# weights (``bert_eval_check``, 4 rows of 512).  Near init they are small:
# max |logit| 0.94 at init on the CPU, 1.10 after three SGD steps on an
# H100; rms 0.22.  float32: both paths sum in float32 in other orders,
# 1.3e-6 apart on the CPU and 1.9e-6 on the H100, so 1e-4.  bf16 amp: 12
# blocks of bf16 activations round differently along the two paths, 0.010
# apart on the CPU and 0.0117 on the H100 (3 bf16 ulps of the largest
# logits), so 2^-5, 8 ulps.  Dropping the ragged mask moves the logits by
# 0.134 (CPU, float32) and 0.162-0.167 (H100): over 4x the bf16 limit.
BERT_LOGITS_ATOL = {"float32": 1e-4, "bf16": 2.0 ** -5}
# the kernel vs the port's eval forward of ``layer1[1]`` under bf16 amp,
# per element: the port rounds each conv's output, the BN affine (with its
# scale and shift in bf16) and the ReLU to bf16, about nine roundings of
# 2^-9 relative on the way to an output, where the kernel rounds only y1
# and y2; each element within 2^-4 |want| + 2^-4 rms(want), the second
# term for outputs where the skip and the block's sum cancel.  Every
# element may differ.
BLOCK_TOL = dict(ulps=0, rtol=2.0 ** -4, rms_atol=2.0 ** -4,
                 max_differing=1.0)
# the float64 witness (``f64_witness``) at random full-size bottleneck
# inputs, where rms(want) is O(1) and the gate's limit is tight: float32
# sums in any order round a few of the 25.7M y2 the other way, and such a
# y2 times a large w3 entry moves an output past the limit, for the plain
# version as for the kernel, but by well under twice it.  A wrong pixel,
# channel or tap moves outputs by O(rms(want)), tens of times the limit.
WITNESS_MAX_OVER = 2.0
RESNET_SHAPE = dict(batch=128, hw=224, classes=1000)


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
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


def device_ms_by_kernel(fn, iters, warmup=2, attempts=2):
    """Device time of ``fn()`` per call by kernel name: the CUDA kernels
    it launches over ``iters`` calls, by torch.profiler (CUPTI).  A
    recording that holds no device time at all (CUPTI now and then
    returns none for one recording of a run) is taken again;
    ``attempts`` empty ones raise."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.key] = out.get(e.key, 0.0) + \
                    e.self_device_time_total / 1e3 / iters
        if sum(out.values()) > 0:
            break
        print(f"chip_smoke.py: torch.profiler recorded no device time "
              f"(attempt {attempt + 1} of {attempts})", file=sys.stderr)
    else:
        raise AssertionError(f"torch.profiler recorded no device time in "
                             f"{attempts} attempts")
    return out


def device_ms_per_call(fn, iters, warmup=2):
    """Device time of ``fn()`` per call: every CUDA kernel it launches
    over ``iters`` calls, summed (``device_ms_by_kernel``).  Unlike
    ``cuda_time_ms`` it leaves out the gaps in which the device waits for
    the host, which set the event time of a kernel shorter than its
    wrapper's launch overhead."""
    return sum(device_ms_by_kernel(fn, iters, warmup).values())


# ---------------------------------------------------------------- kernels


def _case_inputs(b, h, s, d, dtype, seed, mask=None, causal=False,
                 window=None):
    """Flattened kernel inputs for one case, made from a numpy seed."""
    from singa_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed)

    def rand(*shape):
        return torch.from_numpy(
            rng.randn(*shape).astype(np.float32)).to(DEVICE)

    q, k, v, do = (rand(b, h, s, d).to(dtype) for _ in range(4))
    (qf, kf, vf), kmask, qmask, qmap = fa._prep(
        q, k, v, None if mask is None else mask.to(DEVICE))
    scale = 1.0 / math.sqrt(d)
    cfg = (kmask, qmask, qmap, scale, causal, window)
    dof = do.reshape(b * h, s, d).contiguous()
    dlse = 0.1 * rand(b * h, s)
    return (qf, kf, vf), cfg, dof, dlse


def check_case(name, b, h, s, d, dtype, seed, mask=None, causal=False,
               window=None):
    """Each kernel against its plain version on one case; returns
    ``{kernel: max |kernel - plain|}`` and raises past the tolerance."""
    from singa_tpu_torch.ops import flash_attention as fa

    (q, k, v), cfg, do, dlse = _case_inputs(b, h, s, d, dtype, seed, mask,
                                            causal, window)
    rtol, atol = TOL[dtype]
    errs = {}

    def compare(kernel, got, want):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: {kernel} gave non-finite values")
        err = (got - want).abs().max().item()
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{name}: {kernel} differs from its plain version by "
                f"{err} (rtol {rtol}, atol {atol})")

    o, lse = fa.flash_fwd(q, k, v, *cfg)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, *cfg)
    compare("flash_fwd", o, o_ref)
    compare("flash_fwd", lse, lse_ref)
    delta = ((do.float() * o_ref.float()).sum(-1) - dlse).contiguous()
    bwd = (do, lse_ref, delta)
    compare("flash_bwd_dq", fa.flash_bwd_dq(q, k, v, *cfg, *bwd),
            fa.flash_bwd_dq_plain(q, k, v, *cfg, *bwd))
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, *cfg, *bwd),
                         fa.flash_bwd_dkv_plain(q, k, v, *cfg, *bwd)):
        compare("flash_bwd_dkv", got, want)
    torch.cuda.synchronize()
    return errs


def edge_cases():
    """(name, kwargs) of the small shapes that pin the semantics."""
    b, h = 2, 3
    key_mask = torch.zeros(b, 1, 1, 200)
    key_mask[:, :, :, 150:] = -1e9
    dead_row = torch.zeros(b, 1, 1, 128)
    dead_row[0] = float("-inf")  # batch row 0: every key masked to -inf
    rng = np.random.RandomState(7)

    def gmask(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    cases = [
        ("causal", dict(s=256, d=64, causal=True)),
        ("key_mask_s200", dict(s=200, d=64, mask=key_mask)),
        ("neg_inf_row", dict(s=128, d=64, mask=dead_row)),
        ("general_mask_m1", dict(s=128, d=64, mask=gmask(128, 128),
                                 causal=True)),
        ("general_mask_mB", dict(s=128, d=64, mask=gmask(b, 1, 128, 128))),
        ("general_mask_mH", dict(s=128, d=64, mask=gmask(1, h, 128, 128))),
        ("general_mask_mBH", dict(s=128, d=64,
                                  mask=gmask(b, h, 128, 128))),
        ("window", dict(s=256, d=64, causal=True, window=48)),
        ("s1000_d128", dict(s=1000, d=128, causal=True)),
        ("d96", dict(s=192, d=96)),
        ("d160_window", dict(s=160, d=160, causal=True, window=33)),
        # the edges of the tensor-core kernels' 64-row tiles and 64 / 128
        # wide rows: one row, one past a tile, a window of one key and one
        # across 128-row tiles, D far below a row and not a multiple of 16
        # or of 8 (element loads instead of cp.async, odd stores)
        ("s1", dict(s=1, d=64, causal=True)),
        ("s65_causal", dict(s=65, d=64, causal=True)),
        ("s129_causal", dict(s=129, d=64, causal=True)),
        ("window1", dict(s=200, d=64, causal=True, window=1)),
        ("window130_s384", dict(s=384, d=64, causal=True, window=130)),
        ("d8", dict(s=128, d=8)),
        ("d72_causal", dict(s=160, d=72, causal=True)),
        ("d13_s100", dict(s=100, d=13, causal=True)),
        ("d128_general_mask_causal", dict(s=192, d=128, causal=True,
                                          mask=gmask(b, h, 192, 192))),
        # the widest rung of the CUDA-core kernels (16-row tiles, rows of
        # 512): D past 256 and not a multiple of 64, a key mask, a window
        ("d320_key_mask", dict(s=200, d=320, mask=key_mask)),
        ("d512_window", dict(s=96, d=512, causal=True, window=40)),
        # the 8-row rung (a warp a row, rows up to 1792): D past 512 and
        # not a multiple of 32, a window across tiles, a general mask,
        # the widest row
        ("d640_window", dict(s=72, d=640, causal=True, window=20)),
        ("d1000_causal", dict(s=45, d=1000, causal=True)),
        ("d1024_general_mask", dict(s=40, d=1024,
                                    mask=gmask(b, h, 40, 40))),
        ("d1792", dict(s=20, d=1792)),
        # non-causal with no mask at D = 64 (BERT's training route), the
        # last key tile part-filled
        ("full_s200", dict(s=200, d=64)),
    ]
    return [(n, dict(b=b, h=h, **kw)) for n, kw in cases]


def _work(b, h, s, d, causal, elem_bytes):
    """(products' multiply-adds in pair units, bytes of one (B·H, S, D)
    operand, bytes of one (B·H, S) float32 row vector) for the bounds."""
    bh = b * h
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    return pairs, bh * s * d * elem_bytes, bh * s * 4


def bounds_ms(b, h, s, d, causal, dtype):
    """Least time the card could take for each kernel's work: the larger
    of its FLOPs over the peak rate for the dtype and its bytes (each
    input read once, each output written once) over memory bandwidth."""
    elem = torch.finfo(dtype).bits // 8
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    pairs, mat, row = _work(b, h, s, d, causal, elem)
    work = {
        # QKᵀ and P·V; reads q, k, v; writes o and lse
        "flash_fwd": (2 * 2 * pairs * d, 4 * mat + row),
        # QKᵀ, dO·Vᵀ, dS·K; reads q, k, v, dO, lse, delta; writes dq
        "flash_bwd_dq": (3 * 2 * pairs * d, 5 * mat + 2 * row),
        # QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q; reads q, k, v, dO, lse, delta;
        # writes dk, dv
        "flash_bwd_dkv": (4 * 2 * pairs * d, 6 * mat + 2 * row),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_full_shape(dtype=torch.bfloat16):
    """Times of each kernel, its plain version and SDPA at GPT-2 small's
    attention shape in ``dtype``, and the kernel-vs-plain errors there."""
    import torch.nn.functional as F

    from singa_tpu_torch.ops import flash_attention as fa

    sh = GPT2_SHAPE
    errs = check_case(f"gpt2_small/{str(dtype)[6:]}", sh["b"], sh["h"],
                      sh["s"], sh["d"], dtype, seed=0, causal=True)
    (q, k, v), cfg, do, dlse = _case_inputs(
        sh["b"], sh["h"], sh["s"], sh["d"], dtype, seed=0, causal=True)
    o, lse = fa.flash_fwd(q, k, v, *cfg)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    bwd = (do, lse, delta)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *cfg),
                      lambda: fa.flash_fwd_plain(q, k, v, *cfg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, *cfg, *bwd),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, *cfg, *bwd)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, *cfg, *bwd),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, *cfg,
                                                         *bwd)),
    }
    times = {n: (cuda_time_ms(kern, 50), cuda_time_ms(plain, 5))
             for n, (kern, plain) in calls.items()}

    # yardstick: PyTorch's fused attention on the same (B, H, S, D) inputs
    shape = (sh["b"], sh["h"], sh["s"], sh["d"])
    q4, k4, v4 = (t.reshape(shape) for t in (q, k, v))
    sdpa_fwd = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        50)
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    do4 = do.reshape(shape)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    sdpa_train = cuda_time_ms(sdpa_fwd_bwd, 10)
    sdpa_bwd, sdpa_bwd_err = sdpa_backward(q4, k4, v4, do4)
    return errs, times, sdpa_fwd, sdpa_train, sdpa_bwd, sdpa_bwd_err


def bert_key_mask(b, s, seed=0):
    """A ragged (B, 1, 1, S) additive key-padding mask, as BERT's
    ``attention_mask`` gives it (-1e9 past each row's length): row i keeps
    between S/4 and S keys (the last row all of them), from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    keep = rng.randint(s // 4, s + 1, b)
    keep[-1] = s
    mask = torch.zeros(b, 1, 1, s)
    for i, n in enumerate(keep):
        mask[i, ..., n:] = -1e9
    return mask


def time_bert_shape(dtype):
    """BERT-base's attention at ``bench_bert``'s shape (16 x 12 x 512 x
    64, non-causal), once with no mask (the training step's path: it
    passes no ``attention_mask``) and once under a ragged key-padding
    mask (the masked eval's path: the key-mask edge path of the Hopper
    kernels): the three kernels against their plain versions at ``TOL``,
    their times beside their bounds, and PyTorch's fused attention with
    the same additive mask or none (forward, and forward with backward
    through autograd) as the yardstick."""
    import torch.nn.functional as F

    from singa_tpu_torch.ops import flash_attention as fa

    sh = BERT_SHAPE
    dt = str(dtype)[6:]
    shape = (sh["b"], sh["h"], sh["s"], sh["d"])
    bounds = bounds_ms(*shape, False, dtype)
    out = {"shape": dict(sh, causal=False, dtype=dt),
           "bounds_ms": {n: b for n, (b, _) in bounds.items()}}
    for name, mask in (("no_mask", None),
                       ("ragged_key_mask", bert_key_mask(sh["b"], sh["s"]))):
        errs = check_case(f"bert_base/{name}/{dt}", *shape, dtype, seed=1,
                          mask=mask)
        (q, k, v), cfg, do, dlse = _case_inputs(*shape, dtype, seed=1,
                                                mask=mask)
        o, lse = fa.flash_fwd(q, k, v, *cfg)
        delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
        bwd = (do, lse, delta)
        times = {
            "flash_fwd": cuda_time_ms(lambda: fa.flash_fwd(q, k, v, *cfg),
                                      50),
            "flash_bwd_dq": cuda_time_ms(
                lambda: fa.flash_bwd_dq(q, k, v, *cfg, *bwd), 50),
            "flash_bwd_dkv": cuda_time_ms(
                lambda: fa.flash_bwd_dkv(q, k, v, *cfg, *bwd), 50)}
        q4, k4, v4, do4 = (t.reshape(shape) for t in (q, k, v, do))
        m4 = None if mask is None else mask.to(DEVICE, dtype)
        sdpa_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4), 50)
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q4, k4, v4))

        def sdpa_fwd_bwd():
            o4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
            torch.autograd.grad(o4, (qg, kg, vg), do4)

        out[name] = {"max_abs_err": errs, "tol": TOL[dtype],
                     "times_ms": times, "fwd_bwd_ms": sum(times.values()),
                     "sdpa_fwd_ms": sdpa_fwd,
                     "sdpa_fwd_bwd_ms": cuda_time_ms(sdpa_fwd_bwd, 10)}
    out["ragged_key_mask"]["rows_keep"] = "128..512 keys"
    return out


def sdpa_backward(q4, k4, v4, do4):
    """Time of PyTorch's fused flash-attention backward, which computes
    dQ, dK and dV in one call, on (B, H, S, D) inputs; and its largest
    |difference| from the port's dQ/dK/dV kernels given each side's own
    forward (dlse = 0)."""
    from singa_tpu_torch.ops import flash_attention as fa

    aten = torch.ops.aten
    o4, lse4, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)

    def bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, True, seed,
            offset)

    ms = cuda_time_ms(bwd, 50)
    b, h, s, d = q4.shape
    q, k, v, do = (t.reshape(b * h, s, d) for t in (q4, k4, v4, do4))
    cfg = (None, None, None, 1.0 / math.sqrt(d), True, None)
    o, lse = fa.flash_fwd(q, k, v, *cfg)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    ours = (fa.flash_bwd_dq(q, k, v, *cfg, do, lse, delta),
            *fa.flash_bwd_dkv(q, k, v, *cfg, do, lse, delta))
    err = max((a.float().reshape(b, h, s, d) - w.float()).abs().max().item()
              for a, w in zip(ours, bwd()))
    return ms, err


def phase_kernels():
    """The flash kernels against their plain versions at every edge case
    in float32, bf16 and float16; timed at GPT-2 small's shape in bf16
    (the kernels line's rows) and float16 (its ``_f16`` rows), and at
    BERT-base's shape in both, with no mask and under a ragged key
    mask."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    worst = {str(dt)[6:]: {n: 0.0 for n in kernels} for dt in FLASH_DTYPES}
    n_cases = 0
    for dtype in FLASH_DTYPES:
        for seed, (name, kw) in enumerate(edge_cases()):
            errs = check_case(f"{name}/{str(dtype)[6:]}", dtype=dtype,
                              seed=seed, **kw)
            n_cases += 1
            for kname, e in errs.items():
                w = worst[str(dtype)[6:]]
                w[kname] = max(w[kname], e)
    sh = GPT2_SHAPE
    rows, shapes = {}, {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float16, "_f16")):
        full_errs, times, sdpa_fwd, sdpa_train, sdpa_bwd, sdpa_bwd_err = \
            time_full_shape(dtype)
        bounds = bounds_ms(sh["b"], sh["h"], sh["s"], sh["d"], True, dtype)
        for name in kernels:
            ms, plain_ms = times[name]
            bound, by = bounds[name]
            rows[name + suffix] = dict(
                name=name + suffix, route="cuda",
                source="singa_tpu_torch/csrc/flash_attention.cu",
                replaces=REPLACES[name], launches=None,
                max_abs_err=full_errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by,
                # the library's backward is one call for dQ, dK and dV
                # together, so both backward rows carry its time
                library_ms=sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
                library_call=LIBRARY_CALL[name], dtype=str(dtype)[6:])
        shapes[str(dtype)[6:]] = {
            "times_ms": {n: {"kernel": rows[n + suffix]["ms"],
                             "plain": rows[n + suffix]["plain_ms"],
                             "bound": rows[n + suffix]["bound_ms"]}
                         for n in kernels},
            "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_train,
            "sdpa_bwd_ms": sdpa_bwd,
            "sdpa_bwd_max_abs_diff_vs_kernels": sdpa_bwd_err}
    log({"phase": "kernels", "edge_cases": n_cases,
         "edge_max_abs_err": worst,
         "tol": {str(k)[6:]: v for k, v in TOL.items()
                 if isinstance(k, torch.dtype)},
         "shape": dict(sh, causal=True), "gpt2_shape": shapes,
         "bert_shape": {str(dt)[6:]: time_bert_shape(dt)
                        for dt in (torch.bfloat16, torch.float16)}})
    return rows


LIBRARY_CALL = {
    "flash_fwd": "torch.nn.functional.scaled_dot_product_attention "
                 "(forward)",
    "flash_bwd_dq": "aten._scaled_dot_product_flash_attention_backward "
                    "(dQ, dK and dV in one call)",
    "flash_bwd_dkv": "aten._scaled_dot_product_flash_attention_backward "
                     "(dQ, dK and dV in one call)",
}

REPLACES = {
    "flash_fwd": "singa_tpu/ops/pallas/flash_attention.py:183",
    "flash_bwd_dq": "singa_tpu/ops/pallas/flash_attention.py:357",
    "flash_bwd_dkv": "singa_tpu/ops/pallas/flash_attention.py:385",
    "paged_attn": "singa_tpu/models/gpt2_decode.py:841",
    # _paged_attn's int8 branch: its (values, scales) pools (:861), the
    # scaled scores (:885-889) and current lanes (:909-912)
    "paged_attn_int8": "singa_tpu/models/gpt2_decode.py:861",
    # _paged_attn at Q = spec_k under the verify chunk's tril cur_mask, as
    # _block_chunk_paged calls it (:989, the call :1015), bf16 and int8
    # pools
    "paged_attn_spec": "singa_tpu/models/gpt2_decode.py:1015",
    "paged_attn_spec_int8": "singa_tpu/models/gpt2_decode.py:1015",
    # _paged_attn's window band (:897-901) over a windowed slot's table of
    # dropped (trash) blocks, as _block_decode_paged calls it (:963)
    "paged_attn_window": "singa_tpu/models/gpt2_decode.py:897",
    # _paged_attn over fork branches' block tables, which name the same
    # blocks (the JAX engine's _spawn_branch shares them, serve/engine.py
    # :2973), one decode step of the fork round
    "paged_attn_fork": "singa_tpu/models/gpt2_decode.py:841",
    # _paged_attn over a decode replica's tables whose prefix blocks a
    # KV ship landed (the JAX engine's admit_prefix_image adopts them,
    # serve/engine.py:4045), one decode step of the fleet's
    # disaggregated run
    "paged_attn_ship": "singa_tpu/models/gpt2_decode.py:841",
}


# ------------------------------------------------------------------ slice

#: eager against captured training from the same weights, the largest
#: difference allowed in losses and weights, relative (a weight tensor's
#: to its largest magnitude).  A replay runs the eager step's kernels in
#: the same order on the same memory, so the two agree to the bit unless
#: cuBLAS or cuDNN choose other algorithms under capture: then float32
#: keeps 1e-5 and bf16 amp, whose activations round to 8 bits, 1e-3.
CAPTURE_RTOL = {"float32": 1e-5, "bf16": 1e-3}


def _relative_diff(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def flash_counts():
    """``{kernel: launches}`` of the three flash wrappers."""
    from singa_tpu_torch.ops import flash_attention as fa

    return {k.__name__: k.launches
            for k in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}


def reset_flash_counts():
    from singa_tpu_torch.ops import flash_attention as fa

    for k in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        k.launches = k.tensor_core_launches = 0


def train_eager_and_captured(build, x, y, steps, rtol, profiles,
                             before_run=None):
    """Train ``build(False)`` (eager) and ``build(True)`` (graph mode: the
    first call eager, the second captured, the rest replays) for
    ``steps`` steps each on the same batch from the same initial state,
    then profile each over 2 more steps (``profiles``: ``profile_steps``
    keywords by mode; None profiles neither).  ``before_run()`` is called
    before each mode's steps (to seed the device generator, so dropout
    draws the same masks in both).  Raises unless losses and weights agree within ``rtol``
    (``_relative_diff``), the flash kernels (if the model runs them)
    launch the same number of times in both and ``graph.cache_miss``
    moves once.  Returns ``(graph-mode model, report)``."""
    from singa_tpu_torch.observe.registry import registry
    from singa_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    misses = registry().counter("graph.cache_miss")
    graph = build(True)
    init = {k: v.detach().clone() for k, v in graph.get_states().items()}
    eager = build(False)
    eager.set_states(init)
    del init
    report = {}

    def run(m, mode):
        if before_run is not None:
            before_run()
        reset_flash_counts()
        miss0 = misses.value
        losses, step_ms, miss = [], [], []
        for _ in range(steps):
            _sync(x.device)
            t = time.perf_counter()
            _, loss = m(x, y)
            losses.append(loss.item())  # synchronizes
            step_ms.append((time.perf_counter() - t) * 1e3)
            miss.append(misses.value - miss0)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{mode}: non-finite loss: {losses}")
        # the eager mode's first step, the captured mode's first two
        # (eager warm-up, capture) build and allocate: not steady
        steady = step_ms[1:] if mode == "eager" else step_ms[2:]
        report[mode] = dict(
            losses=losses, step_ms=step_ms,
            median_step_ms=statistics.median(steady),
            cache_miss_after_each_step=miss,
            launches={k.__name__: k.launches for k in kernels},
            tensor_core_launches={k.__name__: k.tensor_core_launches
                                  for k in kernels})
        if profiles is not None:
            report[mode]["profile"] = profile_steps(m, x, y, **profiles[mode])

    run(eager, "eager")
    final = {k: v.detach().clone() for k, v in eager.get_states().items()}
    del eager
    run(graph, "captured")
    e, c = report["eager"], report["captured"]
    if c["cache_miss_after_each_step"] != [1] * steps or any(
            e["cache_miss_after_each_step"]):
        raise AssertionError(f"graph.cache_miss moved after warm-up: "
                             f"{c['cache_miss_after_each_step']}")
    if c["launches"] != e["launches"] or \
            c["tensor_core_launches"] != e["tensor_core_launches"]:
        raise AssertionError(f"replayed steps credited {c['launches']} "
                             f"flash launches, eager steps made "
                             f"{e['launches']}")
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                        e["losses"]))
    diffs = {k: _relative_diff(v, final[k])
             for k, v in graph.get_states().items()}
    worst = max(diffs, key=diffs.get)
    weight_diff = diffs[worst]
    report["max_loss_rel_diff"] = loss_diff
    report["max_weight_rel_diff"] = weight_diff
    report["bitwise_equal"] = loss_diff == 0 and weight_diff == 0
    report["rtol"] = rtol
    if loss_diff > rtol or weight_diff > rtol:
        raise AssertionError(f"captured steps differ from eager ones: loss "
                             f"{loss_diff}, weights {weight_diff} (at "
                             f"{worst}) > {rtol}")
    return graph, report


def replayed_kernels(m, x, y):
    """The device kernels of one replayed step by name and count
    (torch.profiler): the replay calls no wrapper, so only this shows
    that the kernels ran inside the graph."""
    return {k[:80]: round(v, 6) for k, v in device_ms_by_kernel(
        lambda: m(x, y), 1, warmup=0).items()}


def dropout_pin(dev, seed=0):
    """Graph mode with lr 0: under dropout 0.1 three replays of one batch
    give three losses (the device generator is registered with the graph,
    so each replay draws a fresh mask); under dropout 0 they give one."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    ids = np.random.RandomState(seed).randint(0, 256, (2, 64)) \
        .astype(np.int32)
    x = tensor.from_numpy(ids, dev)
    y = tensor.from_numpy(np.roll(ids, -1, axis=1).astype(np.int32), dev)
    out = {}
    for p in (0.1, 0.0):
        m = GPT2LMHead(GPT2Config.tiny(dropout=p, attn_impl="flash"))
        m.set_optimizer(opt.SGD(lr=0.0))
        m.compile([x], is_train=True, use_graph=True)
        out[p] = [m(x, y)[1].item() for _ in range(5)]
    replays = {p: v[2:] for p, v in out.items()}
    if len(set(replays[0.1])) != 3 or len(set(replays[0.0])) != 1:
        raise AssertionError(f"dropout under replay: {out}")
    return {f"dropout_{p}": v for p, v in out.items()}


def phase_slice(rows, steps=5, batch=8, seq=1024, seed=0):
    """GPT-2 small training as ``bench_gpt2`` configures it, graph mode
    (``use_graph=True``): captured steps against eager ones from the same
    weights, the flash launches of the replayed steps, the kernels the
    profiler sees in a replay, the dropout pin; eval logits against the
    plain attention path."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    dev = device.create_cuda_gpu()
    amp.enable()
    cfg = GPT2Config.small(dropout=0.0)
    if cfg.attn_impl != "flash":
        raise AssertionError(f"GPT-2 small resolved attn_impl="
                             f"{cfg.attn_impl!r}, expected 'flash'")
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    x, y = tensor.from_numpy(ids, dev), tensor.from_numpy(labels, dev)
    compile_s = {}

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = GPT2LMHead(cfg)
        m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
        t0 = time.perf_counter()
        m.compile([x], is_train=True, use_graph=use_graph)
        torch.cuda.synchronize()
        compile_s["captured" if use_graph else "eager"] = \
            time.perf_counter() - t0
        return m

    m, report = train_eager_and_captured(
        build, x, y, steps, CAPTURE_RTOL["bf16"],
        {"eager": {}, "captured": {}})
    c = report["captured"]
    want = cfg.n_layer * steps
    if any(n != want for n in (*c["launches"].values(),
                               *c["tensor_core_launches"].values())):
        raise AssertionError(f"kernel launches {c['launches']} (tensor-core "
                             f"route: {c['tensor_core_launches']}) over "
                             f"{steps} steps, expected {want} each")
    for name, n in c["launches"].items():
        rows[name]["launches"] = n
    in_replay = replayed_kernels(m, x, y)
    found = {g: [k for k in in_replay if rx.search(k)]
             for g, rx in KERNEL_GROUPS[:1]}["flash_attention"]
    if not all(any(f"{n}<" in k for k in found)
               for n in TENSOR_CORE_KERNELS["flash_attention"]):
        raise AssertionError(f"a replayed step ran no flash tensor-core "
                             f"kernel: {sorted(in_replay)}")
    logits, _ = m(x, y)
    torch.cuda.synchronize()
    clone_ms = cuda_time_ms(lambda: logits.clone(), 5)
    pin = dropout_pin(dev, seed)

    # eval logits: flash kernels vs the same weights on the plain path
    m.eval()
    states = {k: v.detach() for k, v in m.get_states().items()}
    plain = GPT2LMHead(GPT2Config.small(dropout=0.0, attn_impl="fused"))
    plain.compile([x[:1, :8]], is_train=False)
    plain.set_states(states)
    probe = x[:2]
    with torch.no_grad():
        lf = m(probe).float()
        lp = plain(probe).float()
    if lf.shape != (2, seq, cfg.vocab_size) or not torch.isfinite(lf).all():
        raise AssertionError(f"bad logits: shape {tuple(lf.shape)}")
    logits_err = (lf - lp).abs().max().item()
    if logits_err > LOGITS_ATOL:
        raise AssertionError(f"flash vs plain-path logits differ by "
                             f"{logits_err} > {LOGITS_ATOL}")
    profiles = {mode: report[mode].pop("profile")
                for mode in ("eager", "captured")}
    med = c["median_step_ms"]
    log({"phase": "slice", "model": "gpt2-small", "params": sum(
        p.numel() for p in m.parameters()), "batch": batch, "seq": seq,
        "amp": "bf16", "optimizer": "SGD(lr=1e-4, momentum=0.9)",
        "use_graph": True, "compile_s": compile_s, **report,
        "median_step_ms": med, "tokens_per_s": batch * seq / med * 1e3,
        "launches_per_step": {n: k / steps
                              for n, k in c["launches"].items()},
        "kernels_in_a_replayed_step": in_replay,
        "logits_clone_ms": clone_ms,
        "logits_clone_bytes": logits.numel() * logits.element_size(),
        "dropout_pin": pin,
        "logits_max_abs_err_vs_plain": logits_err,
        "logits_atol": LOGITS_ATOL,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    log(dict(phase="profile", **profiles["captured"],
             eager=profiles["eager"]))
    del m, plain, logits
    log(dict(phase="slice_mfu", model="gpt2-small", batch=batch, seq=seq,
             **slice_mfu(cfg, x, y, dev, seed), nvidia_smi=nvidia_smi()))
    log(slice_f16(dev, x, y, rows, seed))
    amp.enable(False)


def slice_f16(dev, x, y, rows, seed=0, steps=2):
    """GPT-2 small under ``amp.set_compute_dtype("float16")``, graph mode,
    ``steps`` steps on the slice's batch (the first eager, the second
    captured): finite losses, and every flash launch on the tensor-core
    route, which credits the kernels line's ``_f16`` rows."""
    from singa_tpu_torch import amp, opt
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    amp.set_compute_dtype("float16")
    try:
        dev.SetRandSeed(seed)
        m = GPT2LMHead(GPT2Config.small(dropout=0.0))
        m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
        m.compile([x], is_train=True, use_graph=True)
        for k in kernels:
            k.launches = k.tensor_core_launches = 0
        step_ms, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, loss = m(x, y)
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t) * 1e3)
        launches = {k.__name__: k.launches for k in kernels}
        tc = {k.__name__: k.tensor_core_launches for k in kernels}
    finally:
        amp.enable()
    want = m.cfg.n_layer * steps
    if not all(math.isfinite(v) for v in losses) or \
            logits.dtype != torch.float16:
        raise AssertionError(f"float16 steps: losses {losses}, logits "
                             f"{logits.dtype}")
    if any(n != want for n in (*launches.values(), *tc.values())):
        raise AssertionError(f"float16 flash launches {launches} (tensor-"
                             f"core route: {tc}) over {steps} steps, "
                             f"expected {want} each")
    for name, n in launches.items():
        rows[name + "_f16"]["launches"] = n
    return {"phase": "slice_f16", "model": "gpt2-small", "amp": "float16",
            "steps": steps, "losses": losses, "step_ms": step_ms,
            "launches": launches, "tensor_core_launches": tc}


KERNEL_GROUPS = (
    ("flash_attention",
     re.compile(r"\b(fwd|dq|dkv)(_tc|_wg|_narrow)?_kernel<")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
)


def profile_steps(m, x, y, steps=2, groups=KERNEL_GROUPS, ranges=()):
    """Device time by kernel over ``steps`` training steps (torch.profiler,
    CUPTI): the sum per group (kernels whose names match a group's
    pattern; then each ``(group, names)`` of ``ranges``, the device time
    of every kernel launched inside the CPU ranges (ops, autograd nodes)
    of those names; everything else), the ten costliest kernels, and the
    device's busy share of the host wall time of the window.  The host's
    ops are traced only for ``ranges``: tracing them slows an eager step
    and takes the profiler seconds a step to read."""
    from torch.profiler import ProfilerActivity, profile

    range_names = {n for _, names in ranges for n in names}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * bool(ranges) +
                 [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            m(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in range_names]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms == 0:
        raise AssertionError("torch.profiler recorded no device time: no "
                             "breakdown of the step")
    out = {}
    for e in kernels:
        group = next((g for g, rx in groups if rx.search(e.key)), "other")
        out[group] = out.get(group, 0.0) + \
            e.self_device_time_total / 1e3 / steps
    for group, names in ranges:
        found = {e.key: e for e in events if e.key in names and
                 e.device_type == torch.autograd.DeviceType.CPU}
        if set(found) != set(names):
            raise AssertionError(f"profile has no range named "
                                 f"{sorted(set(names) - set(found))}")
        ms = sum(e.device_time_total for e in found.values()) / 1e3
        out[group] = ms / steps
        out["other"] = out.get("other", 0.0) - ms / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": total_ms / steps,
        "device_busy_share": total_ms / wall_ms,
        "group_ms_per_step": out,
        "top_kernels": [{"name": e.key[:120], "calls_per_step":
                         e.count / steps, "ms_per_step":
                         e.self_device_time_total / 1e3 / steps}
                        for e in top]}


# ------------------------------------------------------------ io

#: the io phase: GPT-2 small at the slice's configuration fed from a
#: BinFile dataset of IO_WINDOWS windows of seq + 1 token ids, trained
#: IO_STEPS captured steps with checkpoints at IO_SAVE_AT (keep=2)
IO_WINDOWS = 64
IO_STEPS = 6
IO_SAVE_AT = (2, 4)
IO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_scratch", "chip_smoke_io")
#: augment_batch's timing: 128 uint8 images, 256 x 256 -> 224 x 224
AUGMENT_SHAPE = dict(n=128, hw=256, patch=224)


def io_batches(dl, dev, epoch_seed, skip=0):
    """``(epoch seed, batch index, ids, labels)`` of the loader's windows
    from epoch seed ``epoch_seed`` on, the first ``skip`` batches left
    out: ids are a window's first ``seq`` tokens, labels its last."""
    from singa_tpu_torch import tensor

    dl.seed = epoch_seed
    while True:
        seed = dl.seed
        for i, (xb, _) in enumerate(dl):
            if skip:
                skip -= 1
                continue
            w = xb.astype(np.int32)
            yield (seed, i, tensor.from_numpy(w[:, :-1], dev),
                   tensor.from_numpy(w[:, 1:], dev))


def loader_ms(path, workers, batch, epochs=2):
    """Host ms a batch of ``DataLoader(path, batch, num_workers=workers)``
    over ``epochs`` epochs, the decode of each window included."""
    from singa_tpu_torch.io import loader

    dl = loader.DataLoader(path, batch, num_workers=workers, seed=1)
    n, t0 = 0, time.perf_counter()
    for _ in range(epochs):
        for _ in dl:
            n += 1
    return (time.perf_counter() - t0) * 1e3 / n


def augment_rate(seed=0, reps=5):
    """``image_tool.augment_batch`` (the native fused crop, mirror and
    normalisation, every host core) on ``AUGMENT_SHAPE``: images/s of the
    median of ``reps`` calls, train mode, and its output checked against
    the eval-mode centre crop's shape."""
    from singa_tpu_torch import image_tool

    a = AUGMENT_SHAPE
    imgs = np.random.RandomState(seed).randint(
        0, 256, (a["n"], a["hw"], a["hw"], 3)).astype(np.uint8)
    kw = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    secs = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = image_tool.augment_batch(imgs, a["patch"], train=True, seed=r,
                                       **kw)
        secs.append(time.perf_counter() - t0)
    if out.shape != (a["n"], 3, a["patch"], a["patch"]) or \
            not np.isfinite(out).all():
        raise AssertionError(f"augment_batch gave {out.shape}")
    return {"images": a["n"], "from": a["hw"], "to": a["patch"],
            "median_s": statistics.median(secs),
            "images_per_s": a["n"] / statistics.median(secs),
            "threads": os.cpu_count()}


def phase_io(rows, batch=8, seq=1024, seed=0):
    """GPT-2 small trained from a BinFile dataset and resumed past a
    corrupted checkpoint (module docstring): the uninterrupted run, the
    fallback, the bit-equal replay, a ``Snapshot`` of the weights, and the
    timings of the save, the restore, the loader and ``augment_batch``.
    Adds the phase's flash launches to ``rows``."""
    from singa_tpu_torch import amp, device, opt
    from singa_tpu_torch.io import binfile, loader
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.observe.registry import registry
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.resilience.checkpoint import (STATES_NAME,
                                                       CheckpointManager)
    from singa_tpu_torch.snapshot import Snapshot

    if not binfile.native_available():
        raise AssertionError(f"the native BinFile codec did not build: "
                             f"{binfile._lib_err!r}")
    shutil.rmtree(IO_DIR, ignore_errors=True)
    os.makedirs(IO_DIR)
    dev = device.create_cuda_gpu()
    amp.enable()
    cfg = GPT2Config.small(dropout=0.0)
    rng = np.random.RandomState(seed)
    windows = rng.randint(0, cfg.vocab_size, (IO_WINDOWS, seq + 1))
    ds = os.path.join(IO_DIR, "train.bin")
    t0 = time.perf_counter()
    loader.write_dataset(ds, windows, np.arange(IO_WINDOWS))
    write_s = time.perf_counter() - t0
    root = os.path.join(IO_DIR, "ckpt")
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    launches = {k.__name__: 0 for k in kernels}

    def count_from_here():
        for k in kernels:
            k.launches = k.tensor_core_launches = 0

    def counted():
        """Add the launches since ``count_from_here`` (the training
        steps': ``compile`` runs a forward of its own)."""
        for k in kernels:
            if k.tensor_core_launches != k.launches:
                raise AssertionError(f"io: {k.__name__} left the "
                                     f"tensor-core route")
            launches[k.__name__] += k.launches

    def build():
        dev.SetRandSeed(seed)
        m = GPT2LMHead(cfg)
        m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
        m.compile([torch.zeros((batch, seq), dtype=torch.int32,
                               device=dev.torch_device)],
                  is_train=True, use_graph=True)
        return m

    losses, step_ms, save_s = [], [], {}
    with deterministic():
        m = build()
        count_from_here()
        dl = loader.DataLoader(ds, batch, num_workers=1, seed=seed)
        it = io_batches(dl, dev, seed)
        for step in range(1, IO_STEPS + 1):
            epoch_seed, i, x, y = next(it)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss = m(x, y)
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t) * 1e3)
            if step in IO_SAVE_AT:
                t = time.perf_counter()
                m.save_checkpoint(root, step, keep=2, aux_states={
                    "step": step, "epoch_seed": epoch_seed, "batch": i})
                save_s[step] = time.perf_counter() - t
        counted()
        final = {k: v.detach().clone()
                 for k, v in m.persistent_tensors().items()}
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"io: non-finite loss {losses}")
        mgr = CheckpointManager(root)
        if mgr.steps() != list(IO_SAVE_AT):
            raise AssertionError(f"io: checkpoints {mgr.steps()} kept")
        # a Snapshot of the weights, written and read back on the card
        snap_path = os.path.join(IO_DIR, "weights")
        t = time.perf_counter()
        with Snapshot(snap_path, Snapshot.kWrite) as sn:
            for k, v in m.get_states().items():
                sn.write(k, v)
        snap_write_s = time.perf_counter() - t
        t = time.perf_counter()
        with Snapshot(snap_path, Snapshot.kRead) as sn:
            back = sn.read(dev)
        snap_read_s = time.perf_counter() - t
        n_snap = len(back)
        bad = [k for k, v in m.get_states().items()
               if not torch.equal(back[k], v.detach())]
        if bad or set(back) != set(m.get_states()):
            raise AssertionError(f"snapshot round trip differs: {bad[:5]}")
        del m, back
        # one byte of the newest checkpoint's states flipped
        zpath = os.path.join(mgr.step_dir(IO_SAVE_AT[-1]), STATES_NAME)
        with open(zpath, "r+b") as fh:
            fh.seek(os.path.getsize(zpath) // 2)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0xFF]))
        fallbacks = registry().counter("resilience.checkpoint_fallbacks")
        before = fallbacks.value
        fresh = build()
        count_from_here()
        t = time.perf_counter()
        step, aux = fresh.restore_latest_checkpoint(root)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        if step != IO_SAVE_AT[0] or fallbacks.value != before + 1:
            raise AssertionError(f"io: restored step {step} with "
                                 f"{fallbacks.value - before} fallbacks, "
                                 f"expected step {IO_SAVE_AT[0]} after one")
        dl2 = loader.DataLoader(ds, batch, num_workers=1)
        it2 = io_batches(dl2, dev, int(aux["epoch_seed"]),
                         skip=int(aux["batch"]) + 1)
        replay = []
        for _ in range(step + 1, IO_STEPS + 1):
            _, _, x, y = next(it2)
            replay.append(fresh(x, y)[1].item())
        counted()
        differ = [k for k, v in fresh.persistent_tensors().items()
                  if not torch.equal(v, final[k])]
        if replay != losses[step:] or differ:
            raise AssertionError(f"io: resumed steps differ: losses {replay} "
                                 f"against {losses[step:]}, states "
                                 f"{differ[:5]}")
        del fresh, final
    amp.enable(False)
    want = cfg.n_layer * (IO_STEPS + IO_STEPS - IO_SAVE_AT[0])
    if any(n != want for n in launches.values()):
        raise AssertionError(f"io: flash launches {launches}, expected "
                             f"{want} each")
    for name, n in launches.items():
        rows[name]["launches"] += n
    ms_1 = loader_ms(ds, 1, batch)
    ms_4 = loader_ms(ds, 4, batch)
    captured_ms = statistics.median(step_ms[2:])
    log({"phase": "io", "model": "gpt2-small", "batch": batch, "seq": seq,
         "amp": "bf16", "optimizer": "SGD(lr=1e-4, momentum=0.9)",
         "dataset": {"windows": IO_WINDOWS, "bytes": os.path.getsize(ds),
                     "write_s": write_s, "native_codec": True},
         "losses": losses, "step_ms": step_ms,
         "captured_step_median_ms": captured_ms,
         "checkpoints": {"save_s": save_s, "restore_s": restore_s,
                         "zip_bytes": os.path.getsize(os.path.join(
                             mgr.step_dir(IO_SAVE_AT[0]), STATES_NAME)),
                         "corrupted_step": IO_SAVE_AT[-1],
                         "restored_step": step, "fallbacks": 1},
         "resumed_steps_bitwise_equal": True,
         "flash_launches": launches,
         "snapshot": {"write_s": snap_write_s, "read_s": snap_read_s,
                      "tensors": n_snap, "bitwise_equal": True},
         "loader_ms_per_batch": {"num_workers_1": ms_1, "num_workers_4": ms_4,
                                 "captured_step_ms": captured_ms},
         "augment_batch": dict(augment_rate(seed),
                               resnet50_captured_images_per_s=1663),
         "nvidia_smi": nvidia_smi()})
    shutil.rmtree(IO_DIR, ignore_errors=True)


# ------------------------------------------------------------ bert

#: bench_bert's configuration: BERT-base masked LM, batch 16 x 512 random
#: ids and labels from a numpy seed, bf16 amp, SGD(1e-4, 0.9), graph mode
BERT_RUN = dict(batch=16, seq=512, steps=3, sgd=dict(lr=1e-4, momentum=0.9))


def phase_bert(seed=0):
    """BERT-base masked-LM training at ``bench_bert``'s configuration
    (``BERT_RUN``, default dropout), once on the fused attention path that
    ``bench_bert`` runs and once with ``use_flash=True``: eager against
    graph mode from one state and one generator seed (dropout draws the
    same masks; deterministic algorithms, so an embedding's gradient is
    summed in one order), within ``CAPTURE_RTOL``; with flash, 12
    launches of each flash kernel a replayed step, all on the
    tensor-core route.  Then each mode timed on a fresh model with the
    deterministic algorithms off, as ``bench_bert`` runs
    (``time_steps``): host ms a step, device ms by group and busy share
    (profiled), samples/s.  Last, ``bert_eval_check``: eval forwards
    through the flash kernels against the fused path on the same
    weights."""
    import gc

    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_cuda_gpu()
    smi = nvidia_smi()
    amp.enable()
    r = BERT_RUN
    cfg = BertConfig.base()
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (r["batch"], r["seq"]))
    labels = rng.randint(0, cfg.vocab_size, (r["batch"], r["seq"]))
    x = tensor.from_numpy(ids.astype(np.int32), dev)
    y = tensor.from_numpy(labels.astype(np.int32), dev)
    out = {}
    try:
        for use_flash in (False, True):
            def build(use_graph, use_flash=use_flash):
                dev.SetRandSeed(seed)
                m = BertForMaskedLM(BertConfig.base(use_flash=use_flash))
                m.set_optimizer(opt.SGD(**r["sgd"]))
                m.compile([x], is_train=True, use_graph=use_graph)
                return m

            t0 = time.perf_counter()
            with deterministic():
                m, rep = train_eager_and_captured(
                    build, x, y, r["steps"], CAPTURE_RTOL["bf16"], None,
                    before_run=lambda: dev.SetRandSeed(seed + 1))
            c = rep["captured"]
            want = cfg.num_hidden_layers * r["steps"] if use_flash else 0
            if any(n != want for n in (*c["launches"].values(),
                                       *c["tensor_core_launches"].values())):
                raise AssertionError(
                    f"BERT use_flash={use_flash}: flash launches "
                    f"{c['launches']} (tensor-core route: "
                    f"{c['tensor_core_launches']}) over {r['steps']} "
                    f"steps, expected {want} each")
            key = "flash" if use_flash else "fused"
            params = sum(p.numel() for p in m.get_params().values())
            if use_flash:
                out[key] = m
            else:
                states = {k: v.detach().clone()
                          for k, v in m.get_states().items()}
            del m
            gc.collect()
            torch.cuda.empty_cache()
            timed = {mode: time_steps(build, x, y, use_graph,
                                      ZOO_PROFILED_STEPS[mode],
                                      groups=KERNEL_GROUPS)
                     for mode, use_graph in (("eager", False),
                                             ("captured", True))}
            prof = {mode: timed[mode].pop("profile") for mode in timed}
            med = timed["captured"]["median_step_ms"]
            log({"phase": "bert", "attention": key, "params": params,
                 "batch": r["batch"], "seq": r["seq"], "amp": "bf16",
                 "optimizer": "SGD(lr=1e-4, momentum=0.9)",
                 "dropout": cfg.hidden_dropout, "use_graph": True,
                 "compare": rep,
                 "eager_ms": timed["eager"]["median_step_ms"],
                 "captured_ms": med,
                 "step_ms": {mode: timed[mode]["step_ms"] for mode in timed},
                 "samples_per_s": r["batch"] / med * 1e3,
                 "launches_per_step": {n: k / r["steps"]
                                       for n, k in c["launches"].items()},
                 "device_ms": {mode: prof[mode]["device_ms_per_step"]
                               for mode in prof},
                 "busy_share": {mode: prof[mode]["device_busy_share"]
                                for mode in prof},
                 "group_ms_per_step": {mode: prof[mode]["group_ms_per_step"]
                                       for mode in prof},
                 "profiled_steps": ZOO_PROFILED_STEPS,
                 "top_kernels": prof["captured"]["top_kernels"],
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                 "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
            gc.collect()
            torch.cuda.empty_cache()

        # eval: the flash kernels against the fused path on the same
        # weights, with and without a ragged attention_mask
        flash = out.pop("flash")
        fused = BertForMaskedLM(BertConfig.base())
        fused.compile([x[:1, :8]], is_train=False)
        fused.set_states(states)
        flash.set_states(states)
        log(dict(phase="bert_eval", **bert_eval_check(
            flash, fused, x[:min(4, r["batch"])], seed)))
    finally:
        amp.enable(False)


def bert_eval_check(flash, fused, x, seed=0):
    """BERT eval forwards of ``x``'s rows through the flash kernels
    (``flash``: ``use_flash=True``) against the fused path (``fused``) on
    the same weights, in float32 and under bf16 amp, with no mask (the
    route a training step takes) and with a ragged ``attention_mask``
    (the kernels' key-mask row).  Each within ``BERT_LOGITS_ATOL``; and
    the unmasked flash logits against the masked fused ones, the mask
    dropped on purpose, must differ by more than twice the limit, so a
    lost mask could not pass.  Returns the readings; raises on a miss."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.ops import flash_attention as fa

    flash.eval()
    fused.eval()
    prev = amp._compute_dtype
    n, seq = x.shape
    keep = (bert_key_mask(n, seq, seed) == 0)[:, 0, 0, :]
    am = keep.to(x.device, torch.int32)
    layers = flash.cfg.num_hidden_layers
    report = {"rows": n, "keys_kept": keep.sum(-1).tolist(),
              "logits_atol": BERT_LOGITS_ATOL}
    try:
        for dt in ("float32", "bf16"):
            amp.enable(dt == "bf16")
            logits, launched = {}, {}
            with torch.no_grad():
                for name, mask in (("masked", am), ("unmasked", None)):
                    before = fa.flash_fwd.launches
                    logits["flash_" + name] = flash(x, None, mask).float()
                    launched[name] = fa.flash_fwd.launches - before
                    logits["fused_" + name] = fused(x, None, mask).float()
            lf = logits["flash_masked"]
            if lf.shape != (n, seq, flash.cfg.vocab_size) or any(
                    not torch.isfinite(v).all() for v in logits.values()) \
                    or any(k != layers for k in launched.values()):
                raise AssertionError(f"BERT eval, {dt}: shape "
                                     f"{tuple(lf.shape)}, flash forward "
                                     f"launches {launched}")

            def diff(a, b):
                return (logits[a] - logits[b]).abs().max().item()

            want = logits["fused_masked"]
            got = {"masked": diff("flash_masked", "fused_masked"),
                   "unmasked": diff("flash_unmasked", "fused_unmasked"),
                   "mask_dropped": diff("flash_unmasked", "fused_masked")}
            limit = BERT_LOGITS_ATOL[dt]
            report[dt] = dict(
                max_abs_err_vs_fused=got, flash_fwd_launches=launched,
                fused_logits_max_abs=want.abs().max().item(),
                fused_logits_rms=want.pow(2).mean().sqrt().item())
            if got["masked"] > limit or got["unmasked"] > limit:
                raise AssertionError(f"BERT eval logits, flash vs fused, "
                                     f"{dt}: {got} > {limit}")
            if got["mask_dropped"] <= 2 * limit:
                raise AssertionError(f"BERT eval, {dt}: dropping the mask "
                                     f"moves the logits by only "
                                     f"{got['mask_dropped']}, within twice "
                                     f"the limit {limit}")
    finally:
        amp.enable(prev is not None)
    return report


# ---------------------------------------------------------------- onnx

#: the ONNX phase's exports: BERT-base with the masked-LM head, no
#: dropout, ``use_flash=True``, float32, at batch 2 x 512 for the forward
#: checks; the graph bakes its reshape shapes, so the training import is
#: exported again at ``BERT_RUN``'s batch
ONNX_EXPORT = dict(batch=2, seq=512)
ONNX_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch", "chip_smoke_onnx")
#: the repo's foreign ONNX files, with the JAX package's tolerances for
#: them (rtol, atol)
ONNX_FIXTURES = (("gemm", 1e-5, 1e-6), ("ct_lstm", 2e-4, 1e-5),
                 ("trilu_scatternd", 2e-5, 1e-6))
#: the ONNX node types of each recorded op that sonnx decomposes (the rest
#: map one to one through ``sonnx._EXPORT_OPS``); Constant nodes are
#: shared by name, so they are not counted
ONNX_DECOMPOSED = {
    "Embedding": {"Gather": 1}, "FirstToken": {"Gather": 1},
    "AttnMask": {"Sub": 1, "Mul": 1, "Unsqueeze": 1},
    "TPAttention": {"Transpose": 1, "MatMul": 2, "Mul": 1, "Softmax": 1},
    "Attention": {"Transpose": 1, "MatMul": 2, "Mul": 1, "Softmax": 1},
}


def onnx_bert(cfg):
    """BERT-base with the masked-LM head whose forward also returns the
    trunk's sequence and pooled outputs (named ``BertForMaskedLM``, so
    its states are that model's)."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.models.bert import BertForMaskedLM

    class BertForMaskedLMTrunk(BertForMaskedLM):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.name = "BertForMaskedLM"

        def forward(self, input_ids, token_type_ids=None,
                    attention_mask=None):
            seq, pooled = self.bert.forward(input_ids, token_type_ids,
                                            attention_mask)
            h = self.ln(autograd.gelu(self.transform(seq)))
            return self.decoder(h), seq, pooled

    return BertForMaskedLMTrunk(cfg)


def onnx_predicted_types(ops):
    """Node-type counts that the recorded ``ops`` export as (Constant
    nodes left out)."""
    from collections import Counter

    from singa_tpu_torch import sonnx

    want = Counter()
    for op in ops:
        base = op.name.split("#")[0]
        if base in ONNX_DECOMPOSED:
            want.update(ONNX_DECOMPOSED[base])
            if base.endswith("Attention"):
                want["Add"] += (len(op.src) > 3) + bool(
                    op.params.get("causal"))
        else:
            want[sonnx._EXPORT_OPS[base]] += 1
    return want


def onnx_export(m, inputs, path):
    """Export ``m`` on ``inputs`` to ``path``: the flash forward launches
    it made, its node-type counts against the record's prediction,
    sizes and seconds; returns (report, the model read back)."""
    from collections import Counter

    from singa_tpu_torch import sonnx
    from singa_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = fa.flash_fwd.tensor_core_launches = 0
    t0 = time.perf_counter()
    proto = sonnx.to_onnx(m, inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "tensor_core": fa.flash_fwd.tensor_core_launches}
    sonnx.save(proto, path)
    t2 = time.perf_counter()
    loaded = sonnx.load(path)
    t3 = time.perf_counter()
    rec, _ = sonnx._record_forward(m, inputs)
    predicted = onnx_predicted_types(rec.ops)
    del rec
    got = Counter(n.op_type for n in loaded.graph.node
                  if n.op_type != "Constant")
    if got != predicted:
        raise AssertionError(f"ONNX import of {path}: node types {got}, "
                             f"the record predicts {predicted}")
    params = {i.name: int(np.prod(i.dims)) for i in loaded.graph.initializer
              if not i.name.startswith("const_")}
    native = {k: v.numel() for k, v in m.get_params().items()}
    if params != native:
        raise AssertionError(f"ONNX initializers {len(params)} differ from "
                             f"the model's {len(native)} parameters")
    return {"nodes": len(loaded.graph.node),
            "node_types": dict(sorted(got.items())),
            "initializers": len(loaded.graph.initializer),
            "float32_params": sum(params.values()),
            "bytes": os.path.getsize(path), "flash_fwd_launches": launches,
            "seconds": {"export": t1 - t0, "save": t2 - t1,
                        "load": t3 - t2}}, loaded


def onnx_forward_check(native, rep, feeds, limits):
    """The imported graph's sequence and pooled outputs against the
    native model's (flash) forward on ``feeds``, in float32 and under
    bf16 amp; each within ``limits[dtype]``.  Returns the readings and
    the flash forward launches (all and tensor-core) of each dtype."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.ops import flash_attention as fa

    report = {}
    prev = amp._compute_dtype
    try:
        for dt, limit in limits.items():
            amp.enable(dt == "bf16")
            k0 = (fa.flash_fwd.launches, fa.flash_fwd.tensor_core_launches)
            with torch.no_grad():
                want = native(*feeds)
                k1 = (fa.flash_fwd.launches,
                      fa.flash_fwd.tensor_core_launches)
                got = rep.run(list(feeds))
            err = {name: (g.float() - w.float()).abs().max().item()
                   for name, g, w in zip(("logits", "seq", "pooled"), got,
                                         want)}
            report[dt] = {"max_abs_err": err, "limit": limit,
                          "native_flash_fwd": k1[0] - k0[0],
                          "native_tensor_core": k1[1] - k0[1]}
            if not all(torch.isfinite(g).all() for g in got) or \
                    err["seq"] > limit or err["pooled"] > limit:
                raise AssertionError(f"ONNX import vs native, {dt}: {err} "
                                     f"> {limit}")
    finally:
        amp.enable(prev is not None)
    return report


def zip_states(path):
    """The model states of a ``save_states`` zip, by name."""
    import io
    import zipfile

    from singa_tpu_torch.model import _from_npy

    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            k = name[:-len(".npy")]
            if not k.startswith(("__opt__", "__aux__")):
                out[k] = _from_npy(np.load(io.BytesIO(zf.read(name))))
    return out


def phase_onnx(seed=0):
    """ONNX interop at BERT-base's full width (docstring, phase 6): export
    through the flash forward kernel, import, forwards against the
    native model, the import trained at ``bench_bert``'s configuration
    eager against captured, and the foreign fixtures."""
    import gc

    from singa_tpu_torch import amp, autograd, device, opt, sonnx, tensor
    from singa_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device.create_cuda_gpu()
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    os.makedirs(ONNX_DIR, exist_ok=True)
    cfg = BertConfig.base(use_flash=True, hidden_dropout=0.0,
                          attn_dropout=0.0)
    layers = cfg.num_hidden_layers
    rng = np.random.RandomState(seed)
    e, r = ONNX_EXPORT, BERT_RUN
    x2 = tensor.from_numpy(
        rng.randint(0, cfg.vocab_size, (e["batch"], e["seq"]))
        .astype(np.int32), dev)
    tt2 = torch.zeros_like(x2)
    am2 = (bert_key_mask(e["batch"], e["seq"], seed) == 0)[:, 0, 0, :].to(
        dev.torch_device, torch.float32)
    x = tensor.from_numpy(rng.randint(0, cfg.vocab_size, (r["batch"],
                                                          r["seq"]))
                          .astype(np.int32), dev)
    y = tensor.from_numpy(rng.randint(0, cfg.vocab_size, (r["batch"],
                                                          r["seq"]))
                          .astype(np.int32), dev)
    dev.SetRandSeed(seed)
    native = onnx_bert(cfg)
    native.compile([x2], is_train=False)
    log_ = {"phase": "onnx", "model": "BertForMaskedLM (base) + trunk "
            "outputs", "use_flash": True, "dropout": 0.0,
            "export_batch": [e["batch"], e["seq"]], "nvidia_smi": smi}

    # 1. export through the flash forward kernel (float32: fwd_kernel)
    exp, loaded = onnx_export(native, [x2],
                              os.path.join(ONNX_DIR, "bert_base.onnx"))
    if exp["flash_fwd_launches"] != {"flash_fwd": layers, "tensor_core": 0}:
        raise AssertionError(f"ONNX export: flash forward launches "
                             f"{exp['flash_fwd_launches']}, expected "
                             f"{layers} on the float32 CUDA-core route")
    t0 = time.perf_counter()
    rep = sonnx.prepare(loaded, dev)
    exp["seconds"]["prepare"] = time.perf_counter() - t0
    log_["export"] = exp

    # 2. imported forwards against the native flash forward
    log_["forward"] = onnx_forward_check(native, rep, [x2],
                                         BERT_LOGITS_ATOL)
    for dt, tc in (("float32", 0), ("bf16", layers)):
        f = log_["forward"][dt]
        if (f["native_flash_fwd"], f["native_tensor_core"]) != (layers, tc):
            raise AssertionError(f"native {dt} forward: flash launches "
                                 f"{f}, expected {layers} ({tc} on tensor "
                                 f"cores)")
    exp_m, loaded_m = onnx_export(
        native, [x2, tt2, am2], os.path.join(ONNX_DIR, "bert_base_mask.onnx"))
    rep_m = sonnx.prepare(loaded_m, dev)
    log_["export_mask"] = exp_m
    log_["forward_mask"] = onnx_forward_check(
        native, rep_m, [x2, tt2, am2],
        {"float32": BERT_LOGITS_ATOL["float32"]})
    with torch.no_grad():
        dropped = (rep.run([x2])[1] - native(x2, tt2, am2)[1]).abs().max()
    log_["forward_mask"]["mask_dropped_err"] = dropped.item()
    if dropped.item() <= 2 * BERT_LOGITS_ATOL["float32"]:
        raise AssertionError(f"ONNX import: dropping the mask moves the "
                             f"sequence output by only {dropped.item()}")
    del rep, rep_m, loaded_m
    gc.collect()

    # 3. the import trained at bench_bert's configuration
    exp_t, loaded_t = onnx_export(
        native, [x], os.path.join(ONNX_DIR, "bert_base_train.onnx"))
    log_["export_train"] = exp_t
    del native
    gc.collect()
    torch.cuda.empty_cache()

    class OnnxMaskedLM(sonnx.SONNXModel):
        def train_one_batch(self, ids, labels):
            logits = self.forward(ids)[0]
            b, s, v = logits.shape
            loss = autograd.softmax_cross_entropy(
                autograd.reshape(logits, (b * s, v)),
                autograd.reshape(labels, (b * s,)))
            self.optimizer(loss)
            return logits, loss

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = OnnxMaskedLM(loaded_t, dev)
        m.set_optimizer(opt.SGD(**r["sgd"]))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    amp.enable()
    try:
        t0 = time.perf_counter()
        with deterministic():
            m, rep_t = train_eager_and_captured(
                build, x, y, r["steps"], CAPTURE_RTOL["bf16"], None)
        if not rep_t["bitwise_equal"]:
            raise AssertionError(
                f"imported BERT: captured steps differ from eager ones "
                f"(loss {rep_t['max_loss_rel_diff']}, weights "
                f"{rep_t['max_weight_rel_diff']})")
        zpath = os.path.join(ONNX_DIR, "bert_base_import.zip")
        m.save_states(zpath)
        del m
        gc.collect()
        torch.cuda.empty_cache()
        # a native fused BERT with the imported model's weights
        states = zip_states(zpath)

        def build_native(use_graph):
            dev.SetRandSeed(seed)
            nat = BertForMaskedLM(BertConfig.base(hidden_dropout=0.0,
                                                  attn_dropout=0.0))
            nat.set_optimizer(opt.SGD(**r["sgd"]))
            nat.compile([x], is_train=True, use_graph=use_graph)
            nat.set_states({k: states[k] for k in nat.get_states()})
            return nat

        nat = build_native(False)
        extra = sorted(set(states) - set(nat.get_states()))
        if any(not k.startswith("const_") for k in extra):
            raise AssertionError(f"imported states {extra[:5]} name no "
                                 f"native state")
        with deterministic():
            native_loss = nat(x, y)[1].item()
        del nat
        gc.collect()
        torch.cuda.empty_cache()
        # the same model natively, no dropout either, timed in this call
        native_timed = {mode: time_steps(build_native, x, y, use_graph,
                                         ZOO_PROFILED_STEPS[mode],
                                         groups=KERNEL_GROUPS)
                        for mode, use_graph in (("eager", False),
                                                ("captured", True))}
        gc.collect()
        torch.cuda.empty_cache()
        first = rep_t["eager"]["losses"][0]
        rel = abs(first - native_loss) / abs(native_loss)
        if rel > 1e-2:
            raise AssertionError(f"imported BERT's first loss {first} vs "
                                 f"the native fused model's {native_loss}: "
                                 f"{rel} relative > 1e-2")
        timed = {mode: time_steps(build, x, y, use_graph,
                                  ZOO_PROFILED_STEPS[mode],
                                  groups=KERNEL_GROUPS)
                 for mode, use_graph in (("eager", False),
                                         ("captured", True))}
        prof = {mode: timed[mode].pop("profile") for mode in timed}
        med = timed["captured"]["median_step_ms"]
        log_["train"] = {
            "batch": r["batch"], "seq": r["seq"], "amp": "bf16",
            "optimizer": "SGD(lr=1e-4, momentum=0.9)", "compare": rep_t,
            "native_fused_first_loss": native_loss,
            "first_loss_rel_diff": rel, "baked_constants": extra,
            "eager_ms": timed["eager"]["median_step_ms"],
            "captured_ms": med,
            "step_ms": {mode: timed[mode]["step_ms"] for mode in timed},
            "samples_per_s": r["batch"] / med * 1e3,
            "device_ms": {mode: prof[mode]["device_ms_per_step"]
                          for mode in prof},
            "busy_share": {mode: prof[mode]["device_busy_share"]
                           for mode in prof},
            "group_ms_per_step": {mode: prof[mode]["group_ms_per_step"]
                                  for mode in prof},
            "profiled_steps": ZOO_PROFILED_STEPS,
            "top_kernels": prof["captured"]["top_kernels"],
            "native_fused_no_dropout": {
                mode: {"median_step_ms": t["median_step_ms"],
                       "device_ms": t["profile"]["device_ms_per_step"],
                       "busy_share": t["profile"]["device_busy_share"],
                       "group_ms_per_step":
                           t["profile"]["group_ms_per_step"]}
                for mode, t in native_timed.items()},
            "seconds": time.perf_counter() - t0}
    finally:
        amp.enable(False)
    del loaded_t
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the repo's foreign ONNX files on the card
    fdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures")
    fixtures = {}
    for name, rtol, atol in ONNX_FIXTURES:
        with open(os.path.join(fdir, f"foreign_{name}.onnx"), "rb") as f:
            blob = f.read()
        io = np.load(os.path.join(fdir, f"foreign_{name}_io.npz"))
        (out,) = sonnx.prepare(blob, dev).run(
            [tensor.from_numpy(io["x"], dev)])
        got = tensor.to_numpy(out)
        fixtures[name] = float(np.abs(got - io["y"]).max())
        if got.shape != io["y"].shape or not np.allclose(
                got, io["y"], rtol=rtol, atol=atol):
            raise AssertionError(f"foreign ONNX fixture {name}: max abs "
                                 f"error {fixtures[name]} (rtol {rtol}, "
                                 f"atol {atol})")
    log_["foreign_fixtures_max_abs_err"] = fixtures
    shutil.rmtree(ONNX_DIR, ignore_errors=True)  # 1.6 GB of exports
    log_["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    log_["seconds"] = time.perf_counter() - t_phase
    log(log_)


# ---------------------------------------------------------------- charrnn

#: bench_charrnn's configuration: batch 64 x 100 one-hot characters,
#: vocab 100, hidden 256, 2 LSTM layers, SGD(0.1), float32
CHARRNN_RUN = dict(batch=64, seq=100, vocab=100, hidden=256, layers=2,
                   steps=3, n_batches=10, lr=0.1)


def cudnn_lstm_ms(m, x):
    """The yardstick: cuDNN's LSTM (``torch._VF.lstm``) over the model's
    own packed weight (``RNNHandle``'s slices viewed in cuDNN's order,
    which is the same: W_ih, W_hh, b_ih, b_hh, gates i, f, g, o), forward
    and backward on the same input; the largest difference of its
    output from the port's LSTM.  The port never calls it."""
    rnn = m.lstm
    h = rnn.handle
    flat = rnn.W.detach().clone().requires_grad_(True)
    weights = [h.unpack(flat, l, 0)[n] for l in range(h.num_layers)
               for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
    zeros = torch.zeros(h.num_layers, x.shape[0], h.hidden_size,
                        device=x.device)

    def run():
        return torch._VF.lstm(x, (zeros, zeros), weights, True,
                              h.num_layers, 0.0, True, False, True)[0]

    def fwd_bwd():
        torch.autograd.grad(run().sum(), flat)

    with torch.no_grad():
        ours = rnn(x)[0]
        err = (run() - ours).abs().max().item()
    return {"fwd_bwd_ms": cuda_time_ms(fwd_bwd, 10),
            "max_abs_diff_vs_port": err}


def phase_charrnn(seed=0):
    """The char-RNN at ``bench_charrnn``'s configuration
    (``CHARRNN_RUN``): eager against graph mode from one state within
    ``CAPTURE_RTOL["float32"]``, host ms a step of both modes, device ms
    and busy share (profiled); then ``train_n_batches`` over
    ``n_batches`` stacked batches (one replay each), its losses finite;
    and cuDNN's LSTM on the same weights as a yardstick."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.char_rnn import CharRNN, one_hot

    amp.enable(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device.create_cuda_gpu()
    r = CHARRNN_RUN
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, r["vocab"], (r["n_batches"], r["batch"], r["seq"]))
    xs = tensor.from_numpy(one_hot(ids.reshape(-1, r["seq"]), r["vocab"])
                           .reshape(*ids.shape, r["vocab"]), dev)
    ys = tensor.from_numpy(np.roll(ids, -1, axis=2).astype(np.int32), dev)
    x, y = xs[0], ys[0]

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = CharRNN(r["vocab"], r["hidden"], r["layers"], r["seq"])
        m.set_optimizer(opt.SGD(lr=r["lr"]))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    t0 = time.perf_counter()
    m, rep = train_eager_and_captured(
        build, x, y, r["steps"], CAPTURE_RTOL["float32"],
        {"eager": {}, "captured": {}})
    prof = {mode: rep[mode].pop("profile") for mode in ("eager", "captured")}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, losses = m.train_n_batches(xs, ys)
    losses = losses.float().cpu()
    n_ms = (time.perf_counter() - t) * 1e3 / r["n_batches"]
    if losses.shape != (r["n_batches"],) or \
            not torch.isfinite(losses).all():
        raise AssertionError(f"train_n_batches losses: {losses}")
    med = rep["captured"]["median_step_ms"]
    log({"phase": "charrnn", **{k: v for k, v in r.items()},
         "params": sum(p.numel() for p in m.get_params().values()),
         "amp": "float32", "optimizer": f"SGD(lr={r['lr']})", **rep,
         "eager_ms": rep["eager"]["median_step_ms"], "captured_ms": med,
         "samples_per_s": r["batch"] / med * 1e3,
         "device_ms": {mode: prof[mode]["device_ms_per_step"]
                       for mode in prof},
         "busy_share": {mode: prof[mode]["device_busy_share"]
                        for mode in prof},
         "top_kernels": prof["captured"]["top_kernels"],
         "train_n_batches": {"losses": losses.tolist(),
                             "host_ms_per_step": n_ms},
         "cudnn_lstm_yardstick": cudnn_lstm_ms(m, x),
         "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})


# ----------------------------------------------------------------- resnet

RESNET_GROUPS = (
    # cuDNN convolutions (forward, dgrad, wgrad, layout transforms) and
    # the fc layer's GEMM
    ("conv_and_gemm", re.compile(
        r"conv|fprop|dgrad|wgrad|implicit|cudnn|xmma|cutlass|nvjet|gemm|"
        r"nchwToNhwc|nhwcToNchw", re.I)),
)
# the forward and backward autograd nodes of ops/batchnorm.py's training
# op: the profiler records each as a CPU range holding its kernels
BN_RANGES = (("batchnorm", ("_BatchNormTrain", "_BatchNormTrainBackward")),)


def phase_resnet(steps=5, seed=0):
    """ResNet-50 training at ``bench_resnet50``'s configuration, graph mode
    (cuDNN convolutions and the plain-torch batch norm captured), against
    eager steps from the same state; returns the graph-mode model (amp
    still on) and its input batch.  The eager run's profile gives the
    breakdown by group (a replay records no CPU ranges, so the batch
    norm's autograd nodes are found only there)."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.resnet import resnet50

    sh = RESNET_SHAPE
    dev = device.create_cuda_gpu()
    amp.enable()
    rng = np.random.RandomState(seed)
    images = rng.randn(sh["batch"], 3, sh["hw"], sh["hw"]).astype(np.float32)
    labels = rng.randint(0, sh["classes"], sh["batch"]).astype(np.int32)
    x, y = tensor.from_numpy(images, dev), tensor.from_numpy(labels, dev)
    compile_s = {}

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = resnet50(num_classes=sh["classes"])
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        t0 = time.perf_counter()
        m.compile([x], is_train=True, use_graph=use_graph)
        torch.cuda.synchronize()
        compile_s["captured" if use_graph else "eager"] = \
            time.perf_counter() - t0
        return m

    torch.cuda.reset_peak_memory_stats()
    m, report = train_eager_and_captured(
        build, x, y, steps, CAPTURE_RTOL["bf16"],
        {"eager": dict(groups=RESNET_GROUPS, ranges=BN_RANGES),
         "captured": dict(groups=RESNET_GROUPS)})
    stats = {k: v for k, v in m.get_states().items()
             if k.endswith(("running_mean", "running_var"))}
    bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite running statistics: {bad[:5]}")
    if not any(v.abs().max().item() > 0 for k, v in stats.items()
               if k.endswith("running_mean")):
        raise AssertionError("no running mean moved during training")
    profiles = {mode: report[mode].pop("profile")
                for mode in ("eager", "captured")}
    med = report["captured"]["median_step_ms"]
    log({"phase": "resnet", "model": "resnet50", "params": sum(
        p.numel() for p in m.get_params().values()),
        "running_stat_buffers": len(stats), **sh, "amp": "bf16",
        "optimizer": "SGD(lr=0.1, momentum=0.9)", "use_graph": True,
        "compile_s": compile_s, **report, "median_step_ms": med,
        "images_per_s": sh["batch"] / med * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    log(dict(phase="resnet_profile", **profiles["eager"],
             captured=profiles["captured"]))
    return m, x


# -------------------------------------------------------------------- zoo

ZOO_BATCH = 32
ZOO_SEED = 0
#: (name, module of singa_tpu_torch.models, factory, kwargs, input
#: (C, H, W), classes): the published widths and input sizes
ZOO_MODELS = (
    ("cnn", "cnn", "CNN", {}, (1, 28, 28), 10),
    ("alexnet", "alexnet", "AlexNet", {}, (3, 224, 224), 1000),
    ("vgg16", "vgg", "vgg16", {}, (3, 224, 224), 1000),
    ("mobilenet_v2", "mobilenet", "mobilenet_v2", {}, (3, 224, 224), 1000),
    ("xception", "xceptionnet", "Xception", {}, (3, 299, 299), 1000),
    ("unet", "unet", "UNet", dict(num_classes=2, base_channels=16,
                                  depth=3), (3, 256, 256), 2),
)
#: ``examples/cnn/train_cnn.py``'s optimizer for the zoo (its defaults):
#: ``bench_resnet50``'s SGD(0.1, 0.9) drives AlexNet's and VGG's losses
#: past 1e7 and MobileNetV2's to NaN within three steps (a CPU run at
#: small sizes), as those nets have no batch norm or a thin one
ZOO_SGD = dict(lr=0.005, momentum=0.9, weight_decay=1e-5)
ZOO_GROUPS = RESNET_GROUPS
#: steps of each mode the eager ≡ captured comparison takes (the captured
#: mode's first call runs eagerly, its second captures); steps each
#: mode is then timed over, and profiled over, on a fresh model (an
#: eager step's trace takes the profiler seconds to read)
ZOO_COMPARE_STEPS = 3
ZOO_TIMED_STEPS = 5
ZOO_PROFILED_STEPS = {"eager": 3, "captured": 5}
#: where the zoo phase writes its checkpoints (gitignored), under the
#: checkout it runs from
ZOO_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_scratch", "chip_smoke_ckpt")


def mlp_data(n=400, seed=0):
    """``examples/mlp/train.py``'s data: two gaussian blobs, 2 classes."""
    rng = np.random.RandomState(seed)
    x0 = rng.randn(n // 2, 2).astype(np.float32) + np.array([2, 2],
                                                            np.float32)
    x1 = rng.randn(n // 2, 2).astype(np.float32) + np.array([-2, -2],
                                                            np.float32)
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(np.int32)
    idx = rng.permutation(n)
    return x[idx], y[idx]


def mlp_flow(dev, epochs=10, batch=64):
    """``examples/mlp/train.py``'s ``run --use-graph`` on the port:
    ``MLP(2, 3, 2)``,
    SGD(0.05, momentum 0.9, weight decay 1e-5), compiled on a
    ``tensor.Tensor((batch, 2), dev)`` placeholder, ``epochs`` passes in
    batches of 64, then the eval accuracy on the held-out fifth, which
    the example requires to pass 0.9.  Returns (model, losses,
    accuracy)."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.models.mlp import MLP

    x_np, y_np = mlp_data()
    n_train = int(0.8 * len(x_np))
    m = MLP(data_size=2, perceptron_size=3, num_classes=2)
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9, weight_decay=1e-5))
    m.compile([tensor.Tensor((batch, 2), dev)], is_train=True,
              use_graph=True, sequential=False)
    losses = []
    for _ in range(epochs):
        for i in range(0, n_train - batch + 1, batch):
            _, loss = m(tensor.from_numpy(x_np[i:i + batch], dev),
                        tensor.from_numpy(y_np[i:i + batch], dev))
            losses.append(loss.item())
    m.eval()
    out = m(tensor.from_numpy(x_np[n_train:], dev))
    acc = float((tensor.to_numpy(out).argmax(-1) == y_np[n_train:]).mean())
    if not all(math.isfinite(v) for v in losses) or acc <= 0.9:
        raise AssertionError(f"examples/mlp flow: accuracy {acc}, losses "
                             f"{losses[:3]} ... {losses[-3:]}")
    return m, losses, acc


def zoo_batch(shape, classes, seed, dev, unet=False):
    """A batch of ``ZOO_BATCH`` random images and labels (per pixel for
    the U-Net) from a numpy seed, on ``dev``."""
    from singa_tpu_torch import tensor

    rng = np.random.RandomState(seed)
    images = rng.randn(ZOO_BATCH, *shape).astype(np.float32)
    lab = (ZOO_BATCH, shape[1], shape[2]) if unet else (ZOO_BATCH,)
    labels = rng.randint(0, classes, lab).astype(np.int32)
    return tensor.from_numpy(images, dev), tensor.from_numpy(labels, dev)


def zoo_maker(module, factory, kwargs, x, dev, seed=ZOO_SEED,
                sgd=ZOO_SGD):
    """``build(use_graph)``: the model from a seeded device generator,
    ``SGD(**sgd)``, compiled on ``x``."""
    import importlib

    from singa_tpu_torch import opt

    make = getattr(importlib.import_module(
        f"singa_tpu_torch.models.{module}"), factory)

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = make(**kwargs)
        m.set_optimizer(opt.SGD(**sgd))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    return build


def time_steps(build, x, y, use_graph, profiled, timed=ZOO_TIMED_STEPS,
               groups=ZOO_GROUPS):
    """``build(use_graph)`` after two warm-up steps (graph mode: the eager
    call and the capture), cuDNN free to choose its algorithms: the host
    ms of ``timed`` steps, each read to its loss (which synchronizes),
    their median, and ``profile_steps`` over ``profiled`` more."""
    t0 = time.perf_counter()
    m = build(use_graph)
    for _ in range(2):
        m(x, y)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step_ms, losses = [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss = m(x, y)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in timed steps: {losses}")
    t2 = time.perf_counter()
    prof = profile_steps(m, x, y, steps=profiled, groups=groups)
    del m
    return {"step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
            "profile": prof, "seconds": {
                "build_and_warm": t1 - t0, "timed": t2 - t1,
                "profiled": time.perf_counter() - t2}}


def _states_equal(a, b):
    """Names of the persistent tensors (states, optimizer state) of two
    models that differ in any bit."""
    pa, pb = a.persistent_tensors(), b.persistent_tensors()
    if set(pa) != set(pb):
        raise AssertionError(f"state names differ: "
                             f"{sorted(set(pa) ^ set(pb))[:5]}")
    return [k for k in pa if not torch.equal(pa[k], pb[k])]


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (cuDNN's
    deterministic convolutions, and an embedding's gradient, which BERT's
    all-zero token types and repeated positions would otherwise sum by
    atomics in a varying order): two runs of one step on equal inputs
    then agree to the bit, which a comparison of eager with captured
    steps, or of a reloaded model with the one that saved it, relies on.
    An op without a deterministic version warns and runs as it is."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def checkpoint_check(build, x, y, dev, path, seed=ZOO_SEED):
    """A graph-mode model trains 3 steps (eager, captured, replay), saves
    its states with momentum and aux, and a fresh model and optimizer
    load the zip; the next step of each (the first a replay, the second
    the fresh model's eager first call), from one generator seed, must
    agree bit for bit in the loss and every state.  Then the same with
    ``async_save`` taken between two replays, the file loaded after the
    second.  Deterministic algorithms run meanwhile (``deterministic``),
    so equal inputs give equal bits.  Returns a report; raises on a mismatch."""
    with deterministic():
        m = build(True)
        for _ in range(3):
            m(x, y)
        m.save_states(path, aux_states={"steps": 3})
        fresh = build(True)
        if fresh.load_states(path)["steps"] != 3:
            raise AssertionError("checkpoint: aux states did not load")
        dev.SetRandSeed(seed + 1)
        _, l1 = m(x, y)
        dev.SetRandSeed(seed + 1)
        _, l2 = fresh(x, y)
        differ = _states_equal(m, fresh)
        if l1.item() != l2.item() or differ:
            raise AssertionError(f"reloaded step differs: loss {l2.item()} "
                                 f"against {l1.item()}, states {differ[:5]}")
        del fresh
        handle = m.save_states(path, aux_states={"steps": 4},
                               async_save=True)
        dev.SetRandSeed(seed + 2)
        _, l3 = m(x, y)                      # a replay, right after the save
        handle.wait()
        fresh = build(True)
        if fresh.load_states(path)["steps"] != 4:
            raise AssertionError("async checkpoint: aux states did not load")
        dev.SetRandSeed(seed + 2)
        _, l4 = fresh(x, y)
        differ = _states_equal(m, fresh)
        if l3.item() != l4.item() or differ:
            raise AssertionError(f"step after an async save differs: loss "
                                 f"{l4.item()} against {l3.item()}, states "
                                 f"{differ[:5]}")
        os.remove(path)
        return {"reload_step_bitwise_equal": True,
                "async_save_step_bitwise_equal": True,
                "losses": [l1.item(), l3.item()],
                "tensors": len(m.persistent_tensors())}


def schedule_probe(dev, steps=6, init=0.1, decay_steps=2, rate=0.5):
    """``ExponentialDecay`` read off a captured step: a bias-free
    ``Linear(1)`` whose loss is the sum of its outputs on ones has
    gradient 1 in every weight, so SGD without momentum moves each weight
    by exactly the step's rate; steps 2 onward are replays.  Each step's
    move must be ``init · rate^(step / decay_steps)`` within rtol 1e-5
    (float32 weights of magnitude < 1).  Returns the rates."""
    from singa_tpu_torch import autograd, layer, model, opt, tensor

    class RateProbe(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(1, bias=False)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x):
            loss = autograd.reduce_sum(self.forward(x))
            self.optimizer(loss)
            return loss

    x = tensor.from_numpy(np.ones((1, 8), np.float32), dev)
    m = RateProbe()
    m.set_optimizer(opt.SGD(lr=opt.ExponentialDecay(init, decay_steps,
                                                     rate)))
    m.compile([x], is_train=True, use_graph=True)
    m.set_states({"RateProbe.fc.W": np.zeros((8, 1), np.float32)})
    w = [np.zeros(8)]
    for _ in range(steps):
        m(x)
        w.append(tensor.to_numpy(m.fc.W)[:, 0].astype(np.float64))
    got = [float(np.mean(a - b)) for a, b in zip(w, w[1:])]
    want = [init * rate ** (k / decay_steps) for k in range(steps)]
    if not np.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"ExponentialDecay under replay: {got} "
                             f"against {want}")
    return {"rates": got, "formula": want}


def phase_zoo(seed=ZOO_SEED):
    """The CNN zoo at its published widths and input sizes, each trained
    as ``phase_resnet`` trains ResNet-50 (bf16 amp, a batch of 32, with
    ``examples/cnn/train_cnn.py``'s SGD, ``ZOO_SGD``): eager against
    graph mode from one state (the device generator seeded before each,
    so dropout draws the same masks; deterministic algorithms, so equal
    inputs give equal bits), then each mode timed and profiled on a fresh
    model with those algorithms free (``time_steps``); the VGG-16 checkpoint check; the
    MLP at ``examples/mlp/train.py``'s configuration, then that script's
    flow; and the schedule probe."""
    import gc

    from singa_tpu_torch import amp, device, tensor

    dev = device.create_cuda_gpu()
    smi = nvidia_smi()
    prev_amp = amp._compute_dtype
    os.makedirs(ZOO_CKPT_DIR, exist_ok=True)
    report = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def run(name, build, x, y, batch, dtype, optimizer):
        t0 = time.perf_counter()
        with deterministic():
            m, rep = train_eager_and_captured(
                build, x, y, ZOO_COMPARE_STEPS, CAPTURE_RTOL[dtype], None,
                before_run=lambda: dev.SetRandSeed(seed + 1))
        params = sum(p.numel() for p in m.get_params().values())
        del m
        free()
        seconds = {"compare": time.perf_counter() - t0}
        timed = {}
        for mode, use_graph in (("eager", False), ("captured", True)):
            timed[mode] = time_steps(build, x, y, use_graph,
                                     ZOO_PROFILED_STEPS[mode])
            free()
        prof = {mode: timed[mode].pop("profile") for mode in timed}
        seconds.update({mode: timed[mode]["seconds"] for mode in timed})
        med = timed["captured"]["median_step_ms"]
        row = {
            "phase": "zoo", "model": name, "params": params,
            "batch": batch, "input": list(x.shape[1:]), "amp": dtype,
            "optimizer": optimizer, "use_graph": True,
            "eager_ms": timed["eager"]["median_step_ms"], "captured_ms": med,
            "step_ms": {mode: timed[mode]["step_ms"] for mode in timed},
            "device_ms": {mode: prof[mode]["device_ms_per_step"]
                          for mode in prof},
            "busy_share": {mode: prof[mode]["device_busy_share"]
                           for mode in prof},
            "profiled_steps": ZOO_PROFILED_STEPS,
            "images_per_s": batch / med * 1e3,
            "losses": {mode: rep[mode]["losses"] for mode in prof},
            "max_loss_rel_diff": rep["max_loss_rel_diff"],
            "max_weight_rel_diff": rep["max_weight_rel_diff"],
            "bitwise_equal": rep["bitwise_equal"],
            "group_ms_per_step": prof["captured"]["group_ms_per_step"],
            "seconds": dict(seconds, total=time.perf_counter() - t0),
            "nvidia_smi": smi}
        log(row)
        report[name] = row

    try:
        amp.enable()
        for name, module, factory, kwargs, shape, classes in ZOO_MODELS:
            x, y = zoo_batch(shape, classes, seed, dev,
                             unet=factory == "UNet")
            build = zoo_maker(module, factory, kwargs, x, dev, seed)
            run(name, build, x, y, ZOO_BATCH, "bf16",
                "SGD(lr=0.005, momentum=0.9, weight_decay=1e-5)")
            if name == "vgg16":
                t0 = time.perf_counter()
                ck = checkpoint_check(build, x, y, dev, os.path.join(
                    ZOO_CKPT_DIR, "vgg16.zip"), seed)
                log({"phase": "zoo_checkpoint", "model": name, **ck,
                     "seconds": time.perf_counter() - t0})
                free()
        # the MLP at examples/mlp/train.py's configuration (float32)
        amp.enable(False)
        x_np, y_np = mlp_data()
        x = tensor.from_numpy(x_np[:64], dev)
        y = tensor.from_numpy(y_np[:64], dev)
        run("mlp", zoo_maker("mlp", "MLP", dict(
            data_size=2, perceptron_size=3, num_classes=2), x, dev, seed,
            sgd=dict(lr=0.05, momentum=0.9, weight_decay=1e-5)), x, y, 64,
            "float32", "SGD(lr=0.05, momentum=0.9, weight_decay=1e-5)")
        t0 = time.perf_counter()
        _, losses, acc = mlp_flow(dev)
        log({"phase": "zoo_mlp_flow", "steps": len(losses),
             "first_loss": losses[0], "last_loss": losses[-1],
             "eval_accuracy": acc, "seconds": time.perf_counter() - t0})
        log({"phase": "zoo_schedule", **schedule_probe(dev)})
    finally:
        amp.set_compute_dtype(prev_amp)
    return report


# ------------------------------------------------------------------- dist

#: BASELINE.json config 5 as ``examples/cnn/train_dist.py`` defaults it:
#: ResNet-152, batch 64 of 224², bf16 amp, SGD(0.005, 0.9, wd 1e-5),
#: spars 0.05 for the sparse modes; DIST_STEPS graph-mode steps (eager,
#: capture, replays) against as many eager ones, then DIST_TIMED replays
#: timed and DIST_PROFILED profiled
DIST_RUN = dict(batch=64, hw=224, classes=1000, spars=0.05,
                sgd=dict(lr=0.005, momentum=0.9, weight_decay=1e-5))
DIST_MODES = ("plain", "fp16", "partialUpdate", "sparseTopK",
              "sparseThreshold")
DIST_STEPS = 4
DIST_TIMED = 2
DIST_PROFILED = 2
#: the two ranks' twin run: an MLP (64 -> 256 -> 10) on a batch of 32
#: (16 a rank), float32, SGD(0.05, 0.9), DIST_TWIN_STEPS eager steps of
#: partialUpdate and of sparseTopK (spars 0.05), once on CUDA tensors and
#: once on the CPU in the same two processes over one gloo group
DIST_TWIN = dict(batch=32, features=64, hidden=256, classes=10, spars=0.05,
                 sgd=dict(lr=0.05, momentum=0.9))
DIST_TWIN_STEPS = 4
#: card against CPU after 4 steps: float32 products summed in other
#: orders (cuBLAS against the CPU's GEMM), values O(0.1)
DIST_TWIN_ATOL = 1e-5
DIST_JOIN_S = 300
#: ``--dist-world``, W > 1: a state's largest difference between the
#: captured and the eager steps, against its largest change over those
#: steps.  NCCL may sum in another order under capture, and bf16 amp
#: carries that on; a phase of partialUpdate that skips its sync leaves
#: its parameters a synced update (a third or more of their change) short
DIST_WORLD_RTOL = 0.05
DIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch", "chip_smoke_dist")


def free_port():
    """A free TCP port on this host, for a one-machine rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_wire_bytes(mode, sizes, world, spars, step=0):
    """The bytes one rank sends in a step of ``mode``, as the
    communicator reckons them (``comms.bytes``): every float32 gradient
    (plain, the threshold mode's masked one), bf16 (``fp16``: half), the
    round-robin turn's gradients (``partialUpdate``: 1/W of them), or
    ceil(spars · n) (int32 index, float32 value) pairs a tensor
    (``sparseTopK``; the gather brings back W of them)."""
    if mode == "fp16":
        return 2 * sum(sizes)
    if mode == "partialUpdate":
        return 4 * sum(n for i, n in enumerate(sizes)
                       if i % world == step % world)
    if mode == "sparseTopK":
        return sum(8 * max(1, math.ceil(spars * n)) for n in sizes)
    return 4 * sum(sizes)


def comms_counts():
    """``comms.collectives`` and ``comms.bytes`` summed over their ops."""
    from singa_tpu_torch.observe.registry import registry

    ops = ("all_reduce", "fused_synch", "synch_half", "fused_synch_half",
           "sparse_topk", "sparse_threshold", "all_gather")
    reg = registry()
    return (sum(reg.counter("comms.collectives", op=o).value for o in ops),
            sum(reg.counter("comms.bytes", op=o).value for o in ops))


def dist_resnet(mode, dev, x, seed, use_graph, dist=True, spars=None):
    """ResNet-152 with ``DIST_RUN``'s SGD (wrapped in ``DistOpt`` unless
    ``dist`` is False) whose ``train_one_batch`` takes ``mode``, compiled
    on ``x`` right after seeding (its weights come from ``seed``)."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.models.resnet import resnet152
    from singa_tpu_torch.parallel.dist_opt import DistOpt

    r = DIST_RUN
    dev.SetRandSeed(seed)
    m = resnet152(num_classes=r["classes"])
    sgd = opt.SGD(**r["sgd"])
    m.set_optimizer(DistOpt(sgd) if dist else sgd)
    base = m.train_one_batch
    sp = r["spars"] if spars is None else spars
    m.train_one_batch = lambda xb, yb: base(xb, yb, dist_option=mode,
                                            spars=sp)
    # parameters take their shapes from any batch: compile on two images
    m.compile([x[:2]], is_train=True, use_graph=use_graph)
    return m


def dist_steps(mode, world):
    """Graph-mode steps compared with eager ones: ``DIST_STEPS`` (eager
    first call, capture, two replays), and for partialUpdate at W > 1,
    which keys one graph a phase, 3(W - 1) more, so that W + 1 eager
    calls and W captures are followed by W replays."""
    return DIST_STEPS + (3 * (world - 1) if mode == "partialUpdate" else 0)


def comms_in_capture(m, x, y, steps=2):
    """Run ``steps`` of ``m``'s graph-mode steps (by default the eager
    first call and the capture), tracing: the ``comms/*`` events issued,
    and those issued while the stream captured (the all-reduces baked
    into the graphs)."""
    from singa_tpu_torch.observe import trace as tr

    tr.clear()
    tr.enable()
    try:
        for _ in range(steps):
            m(x, y)
    finally:
        tr.disable()
    ev = [e for e in tr.drain() if e["name"].startswith("comms/")]
    return {"issued": len(ev),
            "while_capturing": sum(bool((e.get("args") or {}).get(
                "captured")) for e in ev)}


def phase_dist(seed=0):
    """BASELINE config 5, DistOpt's five modes over NCCL at world size 1,
    then the two-rank gloo twin (module docstring)."""
    import torch.distributed as tdist

    from singa_tpu_torch import amp, device, tensor
    from singa_tpu_torch.parallel import communicator

    r = DIST_RUN
    communicator.initialize_distributed(
        coordinator_address=f"localhost:{free_port()}", num_processes=1,
        process_id=0, backend="nccl", initialization_timeout=300)
    try:
        dev = device.create_cuda_gpu()
        amp.enable()
        rng = np.random.RandomState(seed)
        images = rng.randn(r["batch"], 3, r["hw"], r["hw"]).astype(
            np.float32)
        labels = rng.randint(0, r["classes"], r["batch"]).astype(np.int32)
        x, y = tensor.from_numpy(images, dev), tensor.from_numpy(labels,
                                                                 dev)
        modes, marks = {}, [("start", time.perf_counter())]
        with deterministic():
            for mode in DIST_MODES:
                modes[mode], st = dist_mode(mode, dev, x, y, seed)
                marks.append((mode, time.perf_counter()))
                if mode == "plain":
                    plain = st
                del st
                torch.cuda.empty_cache()
            # plain DistOpt at world 1 against the bare SGD; top-K at
            # spars 1.0 against plain: bit for bit
            bare = dist_resnet("plain", dev, x, seed, True, dist=False)
            for _ in range(DIST_STEPS):
                bare(x, y)
            full = dist_resnet("sparseTopK", dev, x, seed, True, spars=1.0)
            for _ in range(DIST_STEPS):
                full(x, y)
            sizes = [p.numel() for p in bare.get_params().values()]
            for name, m in (("sgd_without_distopt", bare),
                            ("sparseTopK_spars_1", full)):
                diff = [k for k, v in m.get_states().items()
                        if not torch.equal(v, plain[k])]
                if diff:
                    raise AssertionError(f"{name}: {len(diff)} states differ "
                                         f"from DistOpt plain's, e.g. "
                                         f"{diff[:3]}")
        sgd_ms = time_replays(bare, x, y)
        marks.append(("sgd_and_spars_1", time.perf_counter()))
        del bare, full, plain
        torch.cuda.empty_cache()
        amp.enable(False)
    finally:
        # free the captured graphs (their NCCL work) before the group
        gc.collect()
        torch.cuda.synchronize()
        tdist.destroy_process_group()
    twin = dist_twin()
    marks.append(("two_ranks_gloo", time.perf_counter()))
    log({"phase": "dist", "model": "resnet152", "params": sum(sizes),
         "batch": r["batch"], "hw": r["hw"], "amp": "bf16",
         "optimizer": "DistOpt(SGD(lr=0.005, momentum=0.9, "
                      "weight_decay=1e-5))", "spars": r["spars"],
         "world": 1, "backend": "nccl", "modes": modes,
         "sgd_without_distopt_captured_ms": sgd_ms,
         "plain_equals_sgd_bitwise": True,
         "sparseTopK_spars_1_equals_plain_bitwise": True,
         "two_ranks_gloo": twin,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})


def time_replays(m, x, y, n=DIST_TIMED):
    """Host ms of ``n`` replays of ``m``'s captured step, each read to its
    loss; their median."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss = m(x, y)
        loss.item()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def dist_mode(mode, dev, x, y, seed, world=1):
    """One mode: ``dist_steps`` eager steps against graph-mode ones from
    one state (bit for bit at world size 1, within ``DIST_WORLD_RTOL``
    above it), the collectives baked into the capture, then timed and
    profiled replays; returns (report, the states after the compared
    steps)."""
    r = DIST_RUN
    n = dist_steps(mode, world)
    eager = dist_resnet(mode, dev, x, seed, False)
    start = {k: v.detach().clone() for k, v in eager.get_states().items()} \
        if world > 1 else None
    n0, b0 = comms_counts()
    e_loss = []
    for _ in range(n):
        e_loss.append(eager(x, y)[1].item())
    n1, b1 = comms_counts()
    sizes = [p.numel() for p in eager.get_params().values()]
    want = sum(dist_wire_bytes(mode, sizes, world, r["spars"], s)
               for s in range(n))
    if b1 - b0 < want:
        raise AssertionError(f"{mode}: {b1 - b0} bytes issued over "
                             f"{n} steps, the sync alone needs {want}")
    final = {k: v.detach().clone() for k, v in eager.get_states().items()}
    del eager
    graph = dist_resnet(mode, dev, x, seed, True)
    cap = comms_in_capture(graph, x, y, n - 2)
    if cap["while_capturing"] == 0:
        raise AssertionError(f"{mode}: no collective issued while the step "
                             f"was captured: {cap}")
    g_loss = [None] * (n - 2) + [graph(x, y)[1].item() for _ in range(2)]
    states = {k: v.detach().clone() for k, v in graph.get_states().items()}
    diff = [k for k, v in states.items() if not torch.equal(v, final[k])]
    worst = 0.0
    if world == 1:
        if diff:
            raise AssertionError(f"{mode}: captured steps differ from eager "
                                 f"ones in {len(diff)} states, e.g. "
                                 f"{diff[:3]}")
        if g_loss[2:] != e_loss[2:]:
            raise AssertionError(f"{mode}: replayed losses {g_loss[2:]} != "
                                 f"eager {e_loss[2:]}")
    for k in diff:
        moved = (final[k].float() - start[k].float()).abs().max().item()
        off = (states[k].float() - final[k].float()).abs().max().item()
        rel = off / moved if moved else math.inf
        worst = max(worst, rel)
        if rel > DIST_WORLD_RTOL:
            raise AssertionError(
                f"{mode}: captured steps differ from eager ones in {k} by "
                f"{off}, {rel:.3g} of its change {moved} over {n} steps "
                f"(> {DIST_WORLD_RTOL})")
    del final, start
    med = time_replays(graph, x, y)
    prof = profile_steps(graph, x, y, steps=DIST_PROFILED,
                         groups=RESNET_GROUPS)
    return {"captured_ms": med, "images_per_s": r["batch"] / med * 1e3,
            "device_busy_share": prof["device_busy_share"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "group_ms_per_step": prof["group_ms_per_step"],
            "compared_steps": n,
            "comms_collectives_per_step": (n1 - n0) / n,
            "comms_bytes_per_step": (b1 - b0) / n,
            "wire_bytes_per_step_reckoned": want / n,
            "dense_bytes_per_step": 4 * sum(sizes),
            "collectives_in_capture": cap,
            "eager_losses": e_loss, "captured_losses": g_loss[n - 2:],
            "captured_equal_eager_bitwise": not diff,
            "captured_vs_eager_max_rel": worst}, states


def dist_twin():
    """Two ranks on the one card over gloo (NCCL takes one rank a GPU):
    spawn this script twice as ``--dist-rank``, join each within
    ``DIST_JOIN_S``; every rank's parameters and residuals on CUDA tensors
    must equal its CPU run's within ``DIST_TWIN_ATOL``."""
    os.makedirs(DIST_DIR, exist_ok=True)
    init = os.path.join(DIST_DIR, f"rendezvous-{os.getpid()}")
    if os.path.exists(init):
        os.unlink(init)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", str(rk),
         "--dist-init", f"file://{init}"]) for rk in range(2)]
    deadline = time.monotonic() + DIST_JOIN_S
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"two-rank gloo run: exit codes {rcs}")
    out = [json.load(open(os.path.join(DIST_DIR, f"twin-r{rk}.json")))
           for rk in range(2)]
    worst = max(v for o in out for v in o["max_abs_diff"].values())
    if worst > DIST_TWIN_ATOL:
        raise AssertionError(f"card vs CPU: {worst} > {DIST_TWIN_ATOL}: "
                             f"{out}")
    return {"ranks": out, "max_abs_diff": worst, "atol": DIST_TWIN_ATOL}


def dist_rank_main(rank, init):
    """One rank of ``dist_twin``: partialUpdate and sparseTopK on CUDA
    tensors, then on the CPU, from one seed; writes the largest
    differences of parameters and residuals to ``twin-r<rank>.json``."""
    from singa_tpu_torch import device, opt, tensor
    from singa_tpu_torch.models.mlp import MLP
    from singa_tpu_torch.parallel import communicator
    from singa_tpu_torch.parallel.dist_opt import DistOpt

    t = DIST_TWIN
    communicator.initialize_distributed(
        init_method=init, num_processes=2, process_id=rank, backend="gloo",
        initialization_timeout=120)
    try:
        rng = np.random.RandomState(0)
        xs = rng.randn(DIST_TWIN_STEPS, t["batch"], t["features"]) \
            .astype(np.float32)
        ys = rng.randint(0, t["classes"], (DIST_TWIN_STEPS, t["batch"])) \
            .astype(np.int32)
        half = t["batch"] // 2
        sl = slice(rank * half, (rank + 1) * half)

        cpu = device.create_cpu_device()
        cpu.SetRandSeed(0)
        init_states = {}

        def run(mode, dev):
            m = MLP(perceptron_size=t["hidden"], num_classes=t["classes"])
            dopt = DistOpt(opt.SGD(**t["sgd"]))
            m.set_optimizer(dopt)
            m.compile([tensor.from_numpy(xs[0, sl], dev)], is_train=True,
                      use_graph=False)
            # every rank and both devices start from the CPU's seeded
            # weights
            if not init_states:
                init_states.update({k: v.detach().cpu().clone()
                                    for k, v in m.get_states().items()})
            m.set_states(init_states)
            for i in range(DIST_TWIN_STEPS):
                m.train_one_batch(tensor.from_numpy(xs[i, sl], dev),
                                  tensor.from_numpy(ys[i, sl], dev),
                                  dist_option=mode, spars=t["spars"])
            out = {k: v.detach().cpu() for k, v in m.get_params().items()}
            out.update({f"residual/{k}": v.cpu()
                        for k, v in dopt.residuals().items()})
            return out

        diffs = {}
        for mode in ("partialUpdate", "sparseTopK"):
            host = run(mode, cpu)
            card = run(mode, device.create_cuda_gpu())
            if set(card) != set(host) or not any(
                    k.startswith("residual/") for k in card):
                raise AssertionError(f"{mode}: states {sorted(card)}")
            diffs[mode] = max((card[k] - host[k]).abs().max().item()
                              for k in card)
        with open(os.path.join(DIST_DIR, f"twin-r{rank}.json"), "w") as f:
            json.dump({"rank": rank, "max_abs_diff": diffs,
                       "device": torch.cuda.get_device_name(0)}, f)
    finally:
        import torch.distributed as tdist

        tdist.destroy_process_group()


def dist_world(world):
    """``--dist-world``: ``world`` ranks, one a GPU, spawned as
    ``--dist-world-rank`` over an NCCL group on a localhost port; each
    must exit 0 within ``DIST_JOIN_S`` (a rank whose report is written
    and that then hangs leaving the group is killed 30 s after the last
    report and named in ``rank_exit``).  Returns rank 0's report a mode
    with the run's images/s and every rank's ms a step."""
    os.makedirs(DIST_DIR, exist_ok=True)
    port = free_port()
    outs = [os.path.join(DIST_DIR, f"world{world}-r{rk}.json")
            for rk in range(world)]
    for o in outs:
        if os.path.exists(o):
            os.unlink(o)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-world-rank",
         str(rk), "--dist-world", str(world), "--dist-port", str(port)])
        for rk in range(world)]
    deadline, reported = time.monotonic() + DIST_JOIN_S, None
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if reported is None and all(os.path.exists(o) for o in outs):
                reported = now
            if now > deadline or (reported is not None
                                  and now - reported > 30):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if not all(os.path.exists(o) for o in outs) or any(
            rc != 0 for rc, p in zip(rcs, procs) if reported is None):
        raise AssertionError(f"world {world}: exit codes {rcs}")
    ranks = [json.load(open(o)) for o in outs]
    r0 = ranks[0]["modes"]
    return {"world": world, "batch_a_rank": DIST_RUN["batch"],
            "rank_exit": rcs, "modes": {m: dict(
                r0[m], images_per_s_all_ranks=world * r0[m]["images_per_s"],
                rank_captured_ms=[rk["modes"][m]["captured_ms"]
                                  for rk in ranks]) for m in DIST_MODES}}


def dist_world_rank_main(rank, world, port):
    """One rank of ``dist_world``: every mode through ``dist_mode`` on
    this rank's images, then its states gathered and held against rank
    0's bit for bit; writes its reports to ``world<W>-r<rank>.json``."""
    import torch.distributed as tdist

    from singa_tpu_torch import amp, device, tensor
    from singa_tpu_torch.parallel import communicator

    r = DIST_RUN
    communicator.initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank, backend="nccl", initialization_timeout=DIST_JOIN_S)
    try:
        comm = communicator.Communicator()
        dev = device.create_cuda_gpu_on(torch.cuda.current_device())
        amp.enable()
        rng = np.random.RandomState(1000 + rank)
        x = tensor.from_numpy(rng.randn(r["batch"], 3, r["hw"], r["hw"])
                              .astype(np.float32), dev)
        y = tensor.from_numpy(rng.randint(0, r["classes"], r["batch"])
                              .astype(np.int32), dev)
        modes = {}
        with deterministic():
            for mode in DIST_MODES:
                modes[mode], st = dist_mode(mode, dev, x, y, 0, world)
                flat = torch.cat([st[k].float().reshape(-1)
                                  for k in sorted(st)])
                every = comm.all_gather(flat)
                differ = [rk for rk in range(world)
                          if not torch.equal(every[rk], every[0])]
                if differ:
                    raise AssertionError(f"{mode}: ranks {differ} hold "
                                         f"other states than rank 0")
                modes[mode]["replicas_equal"] = True
                del st, flat, every
                # the models (cycles through their train_one_batch) and
                # their graphs go before the next mode's
                gc.collect()
                torch.cuda.empty_cache()
        out = os.path.join(DIST_DIR, f"world{world}-r{rank}.json")
        with open(out + ".tmp", "w") as f:
            json.dump({"rank": rank, "modes": modes,
                       "device": torch.cuda.get_device_name()}, f)
        os.replace(out + ".tmp", out)
    finally:
        # graphs holding NCCL work are freed before the group: a group
        # destroyed under live ones hung at world size 4
        gc.collect()
        torch.cuda.synchronize()
        tdist.destroy_process_group()


def main_dist_world(n, phases=("dist", "shard")):
    """``--dist-world N [--phases dist,shard]``: ``dist_world`` at world
    size 1, then N; then ``shard_world`` at N."""
    if torch.cuda.device_count() < n:
        print(f"chip_smoke.py --dist-world {n}: needs {n} GPUs, sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    smi = nvidia_smi().splitlines()
    if "dist" in phases:
        for world in sorted({1, n}):
            log(dict(dist_world(world), nvidia_smi=smi))
    if "shard" in phases and n > 1:
        from singa_tpu_torch.ops import _build

        _build.build("flash_attention")  # once, before the ranks load it
        log(dict(shard_world(n), nvidia_smi=smi))
    if "serve_shard" in phases and n > 1:
        main_serve_shard_world(n)
    return 0


def main_phases(phases):
    """``--phases serve,serve_shard,fleet`` (one card): the build and the
    named phases alone, for working on them and for comparing two trees
    on one card (``serve``: its seconds and its bf16 figures, the host
    split of its bf16 run among them, go into the line before the last
    two); the run without arguments drives every phase."""
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(phases) - {"serve", "serve_shard", "fleet", "dist_fleet"}
    if unknown:
        print(f"chip_smoke.py --phases: {sorted(unknown)} run only inside "
              f"the whole run", file=sys.stderr)
        return 1
    phase_build()
    line = {"kernels": []}
    if "serve" in phases:
        t0 = time.perf_counter()
        _, real = phase_serve()
        line.update(serve_seconds=time.perf_counter() - t0,
                    serve_bf16=real["bf16"])
    if "serve_shard" in phases:
        row, other, ring = phase_serve_shard()
        line["kernels"].append(row)
        line.update(paged_attn_launches=other, flash_fwd_launches=ring)
    if "fleet" in phases:
        model = gpt2_small()
        launches, ship = phase_fleet(model)
        line["kernels"].append(paged_ship_row(ship, model.cfg))
        line["fleet_paged_attn_launches"] = launches
    if "dist_fleet" in phases:
        t0 = time.perf_counter()
        line["dist_fleet_paged_attn_launches"] = phase_dist_fleet(
            gpt2_small())
        line["dist_fleet_seconds"] = time.perf_counter() - t0
    print(json.dumps(line))
    print(nvidia_smi().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ shard

#: the shard phase's files (zips, rendezvous, reports), gitignored
SHARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_scratch", "chip_smoke_shard")
#: the ring against one card: (name, B, H, S, D, layout, key mask), bf16;
#: zigzag causal at GPT-2 small's attention shape, the contiguous ring
#: with a ragged key-padding mask at BERT-base's
SHARD_RING_CASES = (("zigzag_gpt2", 8, 12, 1024, 64, "zigzag", False),
                    ("contiguous_bert_mask", 16, 12, 512, 64, "contiguous",
                     True))
#: ring outputs and dQ/dK/dV, bf16, against the same ring on the plain
#: versions and against one flash call over the whole sequence, element
#: by element at the kernel checks' bf16 tolerance (``TOL``, as
#: ``torch.allclose``): each hop's partial is rounded to bf16 before the
#: float32 merge (and its dK/dV before the float32 sum), where one call
#: keeps its running sums in float32, so they differ by bf16 roundings of
#: partials no larger than the values themselves.  The check must refuse
#: ``RING_FAULTS`` (``planted``): the last square call of every hop from
#: a later rank skipped, forward and backward (zigzag: the last rows lose
#: the keys of the stripe before theirs, a share of their keys, where a
#: limit scaled by the largest |value|, set by the first rows, is loose);
#: one dV accumulator left behind at the backward's first rotation
RING_FAULTS = ("late_call_skipped", "dv_not_rotated")
#: GPT-2 small at (dp, tp, sp) = (1, 1, 2) and BERT-base at tp = 2 on two
#: gloo ranks of the one card, bf16 amp, no dropout, eager steps (the
#: first a warm-up for the timing), against the one-card serial model
#: from the same zip on the same global batch.  SGD at 0.01: at the
#: benches' 1e-4 a layer norm's scale (1.0) moves by about one float32
#: ulp a step, and the comparison would read rounding, not gradients
SHARD_GPT2 = dict(batch=8, seq=1024, steps=3,
                  sgd=dict(lr=0.01, momentum=0.9))
SHARD_BERT = dict(batch=16, seq=512, steps=2,
                  sgd=dict(lr=0.01, momentum=0.9))
#: planned against serial, both gated.  bf16 amp: the ring and the tp
#: sums add in other orders and round hop partials to bf16, so logits
#: move by bf16 ulps: the loss (~10.9 at random weights) within 2e-3 of
#: itself; and the states by ``float32_witness``: each state of the
#: planned bf16 run at most ``SHARD_WITNESS_MAX`` times as far from the
#: serial float32 run as the serial bf16 run is (the ring rounds each
#: hop's dQ/dK/dV partial to bf16 where one call rounds the whole sum
#: once, so the two bf16 runs stand about equally far from it).  float32,
#: where nothing rounds to bf16: losses within 1e-5, each state's change
#: within ``SHARD_F32["state_rtol"]`` (``update_diff``).  Both limits sit
#: between the sound runs' readings and those of the planted faults
#: (``SHARD_TRAIN_FAULTS``, ``--shard-faults``; PERF.md)
#: (H100, ``--shard-faults``: the witness read 1.01 and 1.63 sound, 5.48
#: to 18.9 planted; the float32 changes 0.32% and 0.84% sound, 49.6% to
#: 120% planted)
SHARD_LOSS_RTOL = 2e-3
SHARD_WITNESS_MAX = 3.0
SHARD_F32 = dict(loss_rtol=1e-5, state_rtol=3e-2)
#: the witness's floor: ``SHARD_NOISE_FLOOR`` of the median state's
#: float32 change (a key projection's bias, whose exact gradient is 0
#: because softmax does not see a constant added to a row's scores,
#: moves by rounding alone)
SHARD_NOISE_FLOOR = DIST_WORLD_RTOL
#: the planted faults of the planned step (``planted``) and the models
#: they are planted in: the ``data`` x ``seq`` gradient average skipped
#: (each rank steps on its own half of the batch), the dK/dV of every
#: hop from another rank halved, the backward all-reduce of a
#: tensor-parallel layer's input skipped
SHARD_TRAIN_FAULTS = {"grad_average_skipped": "gpt2",
                      "ring_dkv_halved": "gpt2",
                      "tp_input_grad_unreduced": "bert"}
#: the world-1 NCCL plan: GPT-2 small, eager / captured / plan=None
SHARD_WORLD1 = dict(batch=8, seq=1024, steps=4,
                    sgd=dict(lr=1e-4, momentum=0.9))
SHARD_JOIN_S = 400


@contextlib.contextmanager
def planted(fault):
    """The port with ``fault`` planted (``RING_FAULTS``,
    ``SHARD_TRAIN_FAULTS``; None plants nothing) while the block runs:
    every rank must plant the same fault, as each still issues every
    collective of the sound code."""
    from singa_tpu_torch.parallel import dist_opt
    from singa_tpu_torch.parallel import ring_attention as ra
    from singa_tpu_torch.parallel import tensor_parallel as tp

    state, patches = {}, []
    schedule, rotate, functions = ra._schedule, ra._rotate, ra._functions
    if fault == "late_call_skipped":
        def skip(src, rank, causal, zigzag):
            calls = schedule(src, rank, causal, zigzag)
            return calls[:-1] if src > rank else calls
        patches.append((ra, "_schedule", skip))
    elif fault == "dv_not_rotated":
        def left_behind(tensors, axis):
            moved = rotate(tensors, axis)
            acc = sorted(n for n in tensors if n.startswith("dv:"))
            if acc and not state:
                state["left"] = acc[-1]
                moved[acc[-1]] = tensors[acc[-1]]
            return moved
        patches.append((ra, "_rotate", left_behind))
    elif fault == "ring_dkv_halved":
        def hop(src, rank, causal, zigzag):
            state["scale"] = 1.0 if src == rank else 0.5
            return schedule(src, rank, causal, zigzag)

        def halved(use_flash):
            fwd, dq, dkv = functions(use_flash)

            def scaled(*args):
                return tuple(t * state["scale"] for t in dkv(*args))
            return fwd, dq, scaled
        patches += [(ra, "_schedule", hop), (ra, "_functions", halved)]
    elif fault == "grad_average_skipped":
        patches.append((dist_opt.DistOpt, "sync_dense",
                        lambda self, pairs, *a, **k: pairs))
    elif fault == "tp_input_grad_unreduced":
        patches.append((tp._CopyToAxis, "backward",
                        staticmethod(lambda ctx, g: (g, None))))
    elif fault is not None:
        raise ValueError(f"no planted fault {fault!r}")
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    try:
        for obj, name, fake in patches:
            setattr(obj, name, fake)
        yield
    finally:
        for obj, name, real in saved:
            setattr(obj, name, real)


def allclose_share(got, want, tol):
    """The largest ``|got - want| / (atol + rtol |want|)`` over the
    elements: ``torch.allclose(got, want, rtol, atol)`` holds where it is
    at most 1."""
    rtol, atol = tol
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def ring_check(case, mesh, dev, seed=0, reps=3):
    """One ring case on this rank (module docstring): the ring through the
    kernels, the same ring on the plain versions and one
    ``flash_attention_lse`` over the whole sequence, each with the
    gradients of ``sum(o · w)`` summed over the ranks to global ones; the
    kernel ring within ``TOL[bf16]`` of both, element by element, and each
    of ``RING_FAULTS`` outside it against one card; the ring's and the one
    call's forward + backward ms (host clock, ``reps`` runs)."""
    from singa_tpu_torch.ops.flash_attention import flash_attention_lse
    from singa_tpu_torch.parallel import communicator as comm
    from singa_tpu_torch.parallel import ring_attention as ra
    from singa_tpu_torch.parallel.tensor_parallel import gather_from_axis

    name, b, h, s, d, layout, masked = case
    tol = TOL[torch.bfloat16]
    axis = mesh.axis("seq")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, w = (torch.randn(b, h, s, d, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    mask = bert_key_mask(b, s, seed).to(dev) if masked else None

    def ring(use_flash):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        if layout == "zigzag":
            o = ra.zigzag_ring_attention_sharded(qq, kk, vv, mesh=mesh,
                                                 use_flash=use_flash)
        else:
            n = s // axis.size
            sl = slice(axis.index * n, (axis.index + 1) * n)
            ol = ra.ring_self_attention(
                qq[:, :, sl], kk[:, :, sl], vv[:, :, sl], axis,
                causal=False, kv_mask=mask[..., sl], use_flash=use_flash)
            o = gather_from_axis(ol, axis, dim=2)
        (o.float() * w.float()).sum().backward()
        grads = [comm.group_all_reduce(t.grad.float(), axis.group)
                 for t in (qq, kk, vv)]
        return [o.float()] + grads

    def one_card():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o, _ = flash_attention_lse(qq, kk, vv, mask,
                                   causal=layout == "zigzag")
        (o.float() * w.float()).sum().backward()
        return [o.float()] + [t.grad.float() for t in (qq, kk, vv)]

    def ms(fn):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3 / reps

    parts = ("o", "dq", "dk", "dv")
    reset_flash_counts()
    got = ring(True)
    launches = flash_counts()
    plain, single = ring(False), one_card()
    errs, shares = {}, {}
    for ref_name, ref in (("plain_ring", plain), ("one_card", single)):
        for part, a, r in zip(parts, got, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name}: ring {part} not finite")
            key = f"{part}_vs_{ref_name}"
            errs[key] = (a - r).abs().max().item()
            shares[key] = allclose_share(a, r, tol)
            if shares[key] > 1.0:
                raise AssertionError(
                    f"{name}: ring {part} differs from the {ref_name} by "
                    f"{errs[key]}, {shares[key]} times its allowance "
                    f"(allclose, rtol/atol {tol})")
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"{name}: the ring launched {launches}")
    faults = {}
    for fault in RING_FAULTS:
        with planted(fault):
            bad = ring(True)
        # what a limit set by the largest |value| (atol + rtol max |r|)
        # would have read, beside the element-wise share
        faults[fault] = {p: {
            "share": allclose_share(a, r, tol),
            "max_abs_err": (a - r).abs().max().item(),
            "share_of_max_scaled_limit": (a - r).abs().max().item()
            / (tol[1] + tol[0] * r.abs().max().item())}
            for p, a, r in zip(parts, bad, single)}
        if all(f["share"] <= 1.0 for f in faults[fault].values()):
            raise AssertionError(f"{name}: the ring check passed the "
                                 f"planted fault {fault}: {faults[fault]}")
    return {"case": name, "shape": [b, h, s, d], "layout": layout,
            "key_mask": masked, "world": axis.size,
            "launches_fwd_bwd": launches, "max_abs_err": errs,
            "allclose_share": shares,
            "tolerance": dict(zip(("rtol", "atol"), tol)),
            "planted_faults_refused": faults,
            "ring_fwd_bwd_ms": ms(lambda: ring(True)),
            "plain_ring_fwd_bwd_ms": ms(lambda: ring(False)),
            "one_card_flash_fwd_bwd_ms": ms(one_card)}


def update_diff(got, want, init):
    """The worst state of ``got`` against ``want`` (both trained from
    ``init``): ``(max |got - want| / scale, name)``, the scale the larger
    of the state's largest change and the median state's.  A state whose
    gradient is rounding noise (a key projection's bias: softmax does not
    see a constant added to every score of a row) changes by noise, and
    is held against the typical change instead."""
    steps = {k: (v.float() - init[k].float()).abs().max().item()
             for k, v in want.items()}
    floor = statistics.median(steps.values())
    worst, at = 0.0, None
    for k, v in want.items():
        err = (got[k].float() - v.float()).abs().max().item()
        rel = err / max(steps[k], floor, 1e-30)
        if rel > worst:
            worst, at = rel, k
    return worst, at


def _rms(t):
    return t.float().square().mean().sqrt().item()


def float32_witness(got, serial, exact, init):
    """Each state of the planned bf16 run ``got`` against the float32 run
    ``exact`` (all trained from ``init``), beside the serial bf16 run's
    distance from it, both as the RMS of the difference (rounding spreads
    over every element, so the two bf16 runs' distances agree closely,
    where their largest elements scatter): the worst ratio of the two,
    each distance at least 4 float32 ulps of the state's RMS plus
    ``SHARD_NOISE_FLOOR`` of the median state's RMS change; its state,
    and the states past ``SHARD_WITNESS_MAX``."""
    floor = SHARD_NOISE_FLOOR * statistics.median(
        _rms(v - init[k]) for k, v in exact.items())
    worst, at, past = 0.0, None, []
    for k, want in exact.items():
        slack = 4 * 2.0 ** -23 * _rms(want) + floor
        ratio = _rms(got[k] - want) / max(_rms(serial[k] - want), slack,
                                          1e-30)
        if ratio > SHARD_WITNESS_MAX:
            past.append(k)
        if ratio > worst:
            worst, at = ratio, k
    return {"worst_ratio": worst, "worst_at": at, "states_past": past[:5]}


def shard_batch(cfg_vocab, batch, seq, seed, dev):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg_vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev))


def shard_build(kind, cfg, plan, dev, run, x, use_graph=False, zpath=None,
                seed=0):
    """GPT-2 (``kind == "gpt2"``) or BERT's MLM model on ``dev`` under
    ``plan`` (None: serial), SGD ``run["sgd"]``, compiled on the global
    batch ``x``, from the zip ``zpath`` (else from ``seed``)."""
    from singa_tpu_torch import device, opt
    from singa_tpu_torch.models.bert import BertForMaskedLM
    from singa_tpu_torch.models.gpt2 import GPT2LMHead

    sdev = device.create_cpu_device() if dev.type == "cpu" else \
        device.create_cuda_gpu_on(dev.index or 0)
    sdev.SetRandSeed(seed)
    m = (GPT2LMHead if kind == "gpt2" else BertForMaskedLM)(cfg, plan)
    if plan is not None:
        m.set_sharding_plan(plan)
    m.set_optimizer(opt.SGD(**run["sgd"]))
    m.compile([x], is_train=True, use_graph=use_graph)
    if zpath is not None:
        m.load_states(zpath)
    return m


def shard_steps(m, x, y, steps, dev):
    """``steps`` training steps: the losses and each step's host ms (the
    step ends in the loss's read)."""
    losses, step_ms = [], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        _, loss = m(x, y)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return losses, step_ms


def shard_configs(spec):
    """The phase's GPT-2 and BERT configurations: full width on the card,
    ``spec["tiny"]`` for a rehearsal on the CPU."""
    from singa_tpu_torch.models.bert import BertConfig
    from singa_tpu_torch.models.gpt2 import GPT2Config

    if spec.get("tiny"):
        return (GPT2Config.tiny(dropout=0.0),
                BertConfig.tiny(hidden_dropout=0.0, attn_dropout=0.0,
                                use_flash=True))
    return (GPT2Config.small(dropout=0.0),
            BertConfig.base(hidden_dropout=0.0, attn_dropout=0.0,
                            use_flash=True))


def planned_vs_serial(kind, cfg, run, mesh_sizes, spec, rank, dev):
    """``kind`` at ``mesh_sizes`` (dp, tp, sp) on the phase's ranks from
    the phase's zip, ``run["steps"]`` eager steps under bf16 amp (timed,
    its flash launches counted from 0 around them, one more step
    profiled) and two in float32; with ``spec["faults"]`` the same again
    under each of ``SHARD_TRAIN_FAULTS`` planted in ``kind``; then rank 0
    trains the serial model from the same zip on the same global batch
    both ways and reads the gates (``shard_gates``).  The sound run must
    pass them; a planted fault's readings are reported (``--shard-faults``
    holds them)."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.parallel import sharding as shd

    zpath = spec[f"{kind}_zip"]
    plan = shd.ShardingPlan(shd.create_mesh(*mesh_sizes, device=dev))
    x, y = shard_batch(cfg.vocab_size, run["batch"], run["seq"], 1, dev)

    def train(p, bf16, fault=None):
        amp.enable(bf16)
        with planted(fault):
            m = shard_build(kind, cfg, p, dev, run, x, zpath=zpath)
            reset_flash_counts()
            # float32 is the gate's run: one step past the warm-up is
            # enough
            steps = run["steps"] if bf16 else 2
            losses, step_ms = shard_steps(m, x, y, steps, dev)
            launches = flash_counts()
            # copies: a replicated state comes back as the parameter
            states = {k: v.detach().float().clone()
                      for k, v in m.get_states().items()}
            # the sound planned run takes one more step, traced: its busy
            # share
            prof = profile_steps(m, x, y, steps=1) if p is not None \
                and bf16 and fault is None and dev.type == "cuda" else None
        del m
        gc.collect()
        return dict(losses=losses, step_ms=step_ms, launches=launches,
                    states=states, profile=prof)

    faults = [f for f, k in SHARD_TRAIN_FAULTS.items()
              if k == kind and spec.get("faults")]
    try:
        p16, p32 = train(plan, True), train(plan, False)
        med = statistics.median(p16["step_ms"][1:])
        out = {"mesh": dict(zip(("dp", "tp", "sp"), mesh_sizes)),
               "batch": run["batch"], "seq": run["seq"],
               "steps": run["steps"], "amp": "bf16",
               "losses": p16["losses"], "step_ms": p16["step_ms"],
               "median_step_ms": med,
               "tokens_per_s_per_card": run["batch"] * run["seq"]
               / med * 1e3 / plan.world,
               "launches": p16["launches"],
               "launches_per_step": {k: n / run["steps"]
                                     for k, n in p16["launches"].items()},
               "profile": p16["profile"],
               "float32": {"losses": p32["losses"],
                           "step_ms": p32["step_ms"]}}
        if dev.type == "cuda" and not all(p16["launches"].values()):
            raise AssertionError(f"{kind} {mesh_sizes}: flash launches "
                                 f"{p16['launches']}")
        bad = {f: (train(plan, True, f), train(plan, False, f))
               for f in faults}
        if rank == 0:
            serial = train(None, True), train(None, False)
            init = np.load(zpath)
            init = {k: torch.from_numpy(init[k]).to(dev)
                    for k in serial[1]["states"]}
            gates = shard_gates((p16, p32), serial, init)
            out.update(gates, serial_losses=serial[0]["losses"],
                       serial_median_step_ms=statistics.median(
                           serial[0]["step_ms"][1:]),
                       serial_float32_losses=serial[1]["losses"])
            out["planted_faults"] = {f: shard_gates(r, serial, init)
                                     for f, r in bad.items()}
            if gates["refused_by"]:
                raise AssertionError(
                    f"{kind} {mesh_sizes} against serial: refused by "
                    f"{gates['refused_by']}: {gates}")
        return out
    finally:
        amp.enable(False)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def shard_gates(planned, serial, init):
    """The planned ``(bf16, float32)`` runs against the serial ones (all
    trained from ``init``): the readings of the bf16 gate (losses within
    ``SHARD_LOSS_RTOL``, ``float32_witness`` within
    ``SHARD_WITNESS_MAX``) and of the float32 gate (``SHARD_F32``), and
    the gates that refuse them."""
    def rel(a, b):
        return max(abs(u - v) / abs(v) for u, v in zip(a, b))

    (p16, p32), (s16, s32) = planned, serial
    witness = float32_witness(p16["states"], s16["states"], s32["states"],
                              init)
    upd, upd_at = update_diff(p32["states"], s32["states"], init)
    g = {"loss_max_rel_diff": rel(p16["losses"], s16["losses"]),
         "witness": witness,
         "float32_loss_max_rel_diff": rel(p32["losses"], s32["losses"]),
         "float32_update_max_rel_diff": upd,
         "float32_update_max_rel_diff_at": upd_at,
         "tolerance": dict(loss_rtol=SHARD_LOSS_RTOL,
                           witness_max=SHARD_WITNESS_MAX, float32=SHARD_F32)}
    refused = []
    if g["loss_max_rel_diff"] > SHARD_LOSS_RTOL \
            or witness["worst_ratio"] > SHARD_WITNESS_MAX:
        refused.append("bf16")
    if g["float32_loss_max_rel_diff"] > SHARD_F32["loss_rtol"] \
            or upd > SHARD_F32["state_rtol"]:
        refused.append("float32")
    g["refused_by"] = refused
    return g


def shard_rank_main(rank, spec_path):
    """One of the shard phase's two ranks on the card (gloo): the ring
    cases, GPT-2 small at sp = 2 and BERT-base at tp = 2 against their
    serial runs; writes ``shard-r<rank>.json``."""
    import torch.distributed as tdist

    from singa_tpu_torch.parallel import communicator
    from singa_tpu_torch.parallel import sharding as shd

    spec = json.load(open(spec_path))
    dev = torch.device(spec["device"])
    communicator.initialize_distributed(
        init_method=spec["init"], num_processes=2, process_id=rank,
        backend="gloo", initialization_timeout=SHARD_JOIN_S)
    try:
        gpt2_cfg, bert_cfg = shard_configs(spec)
        def done(name, report):
            # each part as it ends, so a later part's failure leaves it
            if rank == 0:
                log({"shard_rank0": name, **(
                    {"cases": report} if isinstance(report, list)
                    else report)})
            return report

        t0 = time.perf_counter()
        mesh = shd.create_mesh(sp=2, device=dev)
        rings = done("ring", [ring_check(c, mesh, dev)
                              for c in spec["ring_cases"]])
        t1 = time.perf_counter()
        gpt2 = done("gpt2_sp2", planned_vs_serial(
            "gpt2", gpt2_cfg, spec["gpt2_run"], (1, 1, 2), spec, rank, dev))
        t2 = time.perf_counter()
        bert = done("bert_tp2", planned_vs_serial(
            "bert", bert_cfg, spec["bert_run"], (1, 2, 1), spec, rank, dev))
        t3 = time.perf_counter()
        out = os.path.join(spec["dir"], f"shard-r{rank}.json")
        with open(out + ".tmp", "w") as f:
            json.dump({"rank": rank, "ring": rings, "gpt2_sp2": gpt2,
                       "bert_tp2": bert,
                       "seconds": {"ring": t1 - t0, "gpt2_sp2": t2 - t1,
                                   "bert_tp2": t3 - t2}}, f)
        os.replace(out + ".tmp", out)
    finally:
        gc.collect()
        tdist.destroy_process_group()


def shard_zips(spec, dev):
    """The one-card serial models' initial states, seeded, as zips: the
    ranks and the serial runs all start from them."""
    gpt2_cfg, bert_cfg = shard_configs(spec)
    for kind, cfg, run in (("gpt2", gpt2_cfg, spec["gpt2_run"]),
                           ("bert", bert_cfg, spec["bert_run"])):
        x, _ = shard_batch(cfg.vocab_size, 2, run["seq"], 1, dev)
        m = shard_build(kind, cfg, None, dev, run, x)
        path = os.path.join(spec["dir"], f"{kind}.zip")
        m.save_states(path)
        spec[f"{kind}_zip"] = path
        del m


def shard_two_ranks(spec):
    """Spawn this script twice as ``--shard-rank`` on ``spec`` and join
    both within ``SHARD_JOIN_S``; returns their reports."""
    path = os.path.join(spec["dir"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(rk),
         "--shard-spec", path]) for rk in range(2)]
    deadline = time.monotonic() + SHARD_JOIN_S
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"shard ranks: exit codes {rcs}")
    return [json.load(open(os.path.join(spec["dir"], f"shard-r{rk}.json")))
            for rk in range(2)]


def shard_world1(dev, tiny=False, seed=0):
    """GPT-2 small under a plan with every axis 1 over a one-rank NCCL
    group (gloo on the CPU), and without a plan: each in graph mode
    (eager first call, capture, replays) against eager steps
    (``train_eager_and_captured``), all from one seed under deterministic
    algorithms; every state and loss bit for bit the same in all four
    runs, 12 launches of each kernel a captured step."""
    import torch.distributed as tdist

    from singa_tpu_torch import amp
    from singa_tpu_torch.parallel import communicator
    from singa_tpu_torch.parallel import sharding as shd

    gpt2_cfg, _ = shard_configs({"tiny": tiny})
    run = dict(SHARD_WORLD1, batch=2, seq=32) if tiny else SHARD_WORLD1
    communicator.initialize_distributed(
        coordinator_address=f"localhost:{free_port()}", num_processes=1,
        process_id=0, backend="nccl" if dev.type == "cuda" else "gloo",
        initialization_timeout=300)
    try:
        plan = shd.ShardingPlan(shd.create_mesh(device=dev))
        x, y = shard_batch(gpt2_cfg.vocab_size, run["batch"], run["seq"], 2,
                           dev)
        amp.enable()
        report, states = {}, {}
        with deterministic():
            for name, p in (("plan", plan), ("plan_none", None)):
                m, report[name] = train_eager_and_captured(
                    lambda graph: shard_build("gpt2", gpt2_cfg, p, dev, run,
                                              x, use_graph=graph, seed=seed),
                    x, y, run["steps"], 0.0, None)
                states[name] = {k: v.detach().clone()
                                for k, v in m.get_states().items()}
                del m
                gc.collect()
        amp.enable(False)
        diff = [k for k, v in states["plan"].items()
                if not torch.equal(v, states["plan_none"][k])]
        if diff or report["plan"]["captured"]["losses"] != \
                report["plan_none"]["captured"]["losses"]:
            raise AssertionError(f"world-1 plan: captured steps differ "
                                 f"from plan=None ones at {diff[:3]}")
        want = gpt2_cfg.n_layer * run["steps"]
        got = report["plan"]["captured"]["launches"]
        if dev.type == "cuda" and any(n != want for n in got.values()):
            raise AssertionError(f"world-1 plan: captured flash launches "
                                 f"{got}, expected {want} each")
        report["plan_equal_plan_none_bitwise"] = True
        return report
    finally:
        gc.collect()
        _sync(dev)
        tdist.destroy_process_group()


def shard_spec(dev, faults=False):
    """What the shard phase's ranks run (``shard_rank_main``): full width
    on the card, tiny shapes on the CPU; ``faults`` plants
    ``SHARD_TRAIN_FAULTS`` too."""
    os.makedirs(SHARD_DIR, exist_ok=True)
    init = os.path.join(SHARD_DIR, f"rendezvous-{os.getpid()}")
    if os.path.exists(init):
        os.unlink(init)
    spec = {"dir": SHARD_DIR, "init": f"file://{init}", "device": str(dev),
            "tiny": dev.type == "cpu", "ring_cases": SHARD_RING_CASES,
            "gpt2_run": SHARD_GPT2, "bert_run": SHARD_BERT,
            "faults": faults}
    if spec["tiny"]:
        spec["ring_cases"] = [("zigzag_tiny", 2, 2, 32, 8, "zigzag", False),
                              ("contiguous_tiny_mask", 2, 2, 16, 8,
                               "contiguous", True)]
        spec["gpt2_run"] = dict(SHARD_GPT2, batch=2, seq=32)
        spec["bert_run"] = dict(SHARD_BERT, batch=2, seq=32)
    return spec


def phase_shard(rows, seed=0):
    """Sharded training on one card (module docstring): the ring against
    one card and GPT-2 small at sp = 2 and BERT-base at tp = 2 on two
    gloo ranks against their serial runs, then GPT-2 small under a
    world-1 plan over NCCL.  Adds the ranks' and the world-1 run's flash
    launches to ``rows``."""
    dev = DEVICE if DEVICE.type == "cpu" else torch.device("cuda", 0)
    spec = shard_spec(dev)
    t0 = time.perf_counter()
    shard_zips(spec, dev)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    t1 = time.perf_counter()
    ranks = shard_two_ranks(spec)
    t2 = time.perf_counter()
    world1 = shard_world1(dev, tiny=spec["tiny"], seed=seed)
    t3 = time.perf_counter()
    # the planned runs' launches (the ring checks' are comparisons)
    for rk in ranks:
        for part in (rk["gpt2_sp2"], rk["bert_tp2"]):
            for name, n in part["launches"].items():
                rows[name]["launches"] += n
    for name, n in world1["plan"]["captured"]["launches"].items():
        rows[name]["launches"] += n
    r0 = ranks[0]
    log({"phase": "shard", "ring": r0["ring"], "gpt2_sp2": r0["gpt2_sp2"],
         "bert_tp2": r0["bert_tp2"],
         "rank1": {"gpt2_sp2_median_step_ms":
                   ranks[1]["gpt2_sp2"]["median_step_ms"],
                   "bert_tp2_median_step_ms":
                   ranks[1]["bert_tp2"]["median_step_ms"]},
         "world1_plan_nccl": world1,
         "seconds": {"zips": t1 - t0, "two_ranks": t2 - t1,
                     "ranks": r0["seconds"], "world1": t3 - t2},
         "nvidia_smi": nvidia_smi() if dev.type == "cuda" else None})


def main_shard_faults():
    """``--shard-faults``: the shard phase's two gloo ranks on one card
    with each of ``SHARD_TRAIN_FAULTS`` planted in turn after the sound
    runs (and the ring's ``RING_FAULTS``, as every run plants them).
    Prints every gate's readings of the sound and the planted runs; exit
    0 only when the sound runs pass both gates and both refuse every
    planted fault."""
    if not torch.cuda.is_available():
        print("chip_smoke.py --shard-faults: no CUDA device", file=sys.stderr)
        return 1
    from singa_tpu_torch.ops import _build

    _build.build("flash_attention")  # once, before the ranks load it
    dev = torch.device("cuda", 0)
    spec = shard_spec(dev, faults=True)
    shard_zips(spec, dev)
    r0 = shard_two_ranks(spec)[0]
    keys = ("loss_max_rel_diff", "witness", "float32_loss_max_rel_diff",
            "float32_update_max_rel_diff", "float32_update_max_rel_diff_at",
            "refused_by")
    report = {part: {"sound": {k: r0[part][k] for k in keys},
                     "planted": {f: {k: g[k] for k in keys} for f, g in
                                 r0[part]["planted_faults"].items()}}
              for part in ("gpt2_sp2", "bert_tp2")}
    report["ring"] = {c["case"]: c["planted_faults_refused"]
                      for c in r0["ring"]}
    log({"phase": "shard_faults", **report, "tolerance": {
        "loss_rtol": SHARD_LOSS_RTOL, "witness_max": SHARD_WITNESS_MAX,
        "float32": SHARD_F32}, "nvidia_smi": nvidia_smi()})
    passed = [(part, f) for part in ("gpt2_sp2", "bert_tp2")
              for f, g in report[part]["planted"].items()
              if sorted(g["refused_by"]) != ["bf16", "float32"]]
    if passed:
        print(f"chip_smoke.py --shard-faults: planted faults not refused by "
              f"both gates: {passed}", file=sys.stderr)
        return 1
    return 0


#: ``--dist-world N``'s sharded runs, one process a GPU over NCCL: GPT-2
#: small at (dp, tp, sp) = (2, 1, 2) and (1, 1, 4) and BERT-base at tp 2 x
#: sp 2, bf16 amp, eager steps against graph-mode ones (eager first
#: call, capture, replays) from one seed under deterministic algorithms;
#: and GPipe over the pipe axis at GPT-2 small's width and depth against
#: one card, float32
SHARD_WORLD_RUNS = (("gpt2", (2, 1, 2)), ("gpt2", (1, 1, 4)),
                    ("bert", (1, 2, 2)))
SHARD_WORLD_STEPS = 4
SHARD_PIPE = dict(batch=8, seq=512, microbatches=8, steps=3,
                  sgd=dict(lr=0.01, momentum=0.9))
#: GPipe against one card, float32: the microbatches change the GEMMs'
#: row counts, and cuBLAS may sum in another order: ``SHARD_F32``


class PipeGPT2:
    """GPT-2 small's width and depth as a GPipe trunk: token embedding,
    ``PipelinedTransformer`` (12 blocks of 768, 12 heads, 3072), a
    linear head over the 50257 tokens."""

    @staticmethod
    def build(plan, dev, x, seed=0, tiny=False):
        from singa_tpu_torch import autograd, device, layer, model, opt
        from singa_tpu_torch.parallel.pipeline import PipelinedTransformer

        vocab, d, layers, heads, inner = (256, 64, 4, 4, 128) if tiny \
            else (50257, 768, 12, 12, 3072)

        class Net(model.Model):
            def __init__(self):
                super().__init__()
                self.embed = layer.Embedding(vocab, d)
                self.trunk = PipelinedTransformer(
                    layers, heads, inner, plan=plan,
                    num_microbatches=SHARD_PIPE["microbatches"])
                self.head = layer.Linear(vocab)
                self.loss_fn = layer.SoftMaxCrossEntropy()

            def forward(self, ids):
                return self.head(self.trunk(self.embed(ids)))

            def train_one_batch(self, ids, labels):
                logits = self.forward(ids)
                b, s, v = logits.shape
                loss = self.loss_fn(autograd.reshape(logits, (b * s, v)),
                                    autograd.reshape(labels, (b * s,)))
                self.optimizer(loss)
                return logits, loss

        sdev = device.create_cpu_device() if dev.type == "cpu" else \
            device.create_cuda_gpu_on(dev.index or 0)
        sdev.SetRandSeed(seed)
        m = Net()
        if plan is not None:
            m.set_sharding_plan(plan)
        m.set_optimizer(opt.SGD(**SHARD_PIPE["sgd"]))
        m.compile([x], is_train=True)
        return m


def shard_world_run(kind, sizes, dev, tiny, comm):
    """One of ``SHARD_WORLD_RUNS`` on this rank: graph-mode steps bit for
    bit equal to eager ones (``train_eager_and_captured``, which then
    profiles two steps of each), every rank's states equal to those of the
    ranks that hold the same shards; step ms, tokens/s a card, flash
    launches a replayed step."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.parallel import sharding as shd

    gpt2_cfg, bert_cfg = shard_configs({"tiny": tiny})
    cfg, run = (gpt2_cfg, SHARD_GPT2) if kind == "gpt2" else \
        (bert_cfg, SHARD_BERT)
    if tiny:
        run = dict(run, batch=4, seq=32)
    plan = shd.ShardingPlan(shd.create_mesh(*sizes, device=dev))
    x, y = shard_batch(cfg.vocab_size, run["batch"], run["seq"], 1, dev)
    n = SHARD_WORLD_STEPS
    amp.enable()
    try:
        with deterministic():
            m, rep = train_eager_and_captured(
                lambda graph: shard_build(kind, cfg, plan, dev, run, x,
                                          use_graph=graph),
                x, y, n, 0.0, {"eager": {"steps": 2}, "captured": {
                    "steps": 2}} if dev.type == "cuda" else None)
        # ranks that hold the same shards hold the same bits
        flat = torch.cat([v.float().reshape(-1) for _, v in
                          sorted(m.persistent_tensors().items())])
        del m
        gc.collect()
        every = comm.all_gather(flat)
        mesh = plan.mesh
        me = {a: mesh.axis_index(a) for a in ("model", "pipe", "expert")}
        twins = [r for r in range(mesh.size)
                 if {a: mesh.coords_of(r)[a] for a in me} == me]
        differ = [r for r in twins if not torch.equal(every[r], flat)]
        if differ:
            raise AssertionError(f"{kind} {sizes}: ranks {differ} hold "
                                 f"other states than rank {mesh.rank}")
        cap = rep["captured"]
        if dev.type == "cuda" and not all(cap["launches"].values()):
            raise AssertionError(f"{kind} {sizes}: captured flash launches "
                                 f"{cap['launches']}")
        return {"model": kind, "mesh": dict(zip(("dp", "tp", "sp"), sizes)),
                "batch": run["batch"], "seq": run["seq"], "amp": "bf16",
                "eager": rep["eager"], "captured": cap,
                "captured_equal_eager_bitwise": rep["bitwise_equal"],
                "replica_ranks_equal": twins,
                "median_replay_ms": cap["median_step_ms"],
                "tokens_per_s_per_card": run["batch"] * run["seq"]
                / cap["median_step_ms"] * 1e3 / mesh.size,
                "flash_launches_per_step": {
                    k: v / n for k, v in cap["launches"].items()},
                "layers": cfg.num_hidden_layers if kind == "bert"
                else cfg.n_layer}
    finally:
        amp.enable(False)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def shard_pipe_run(world, dev, tiny, rank):
    """GPipe at pp = ``world`` against one card (rank 0), float32."""
    from singa_tpu_torch.parallel import sharding as shd

    r = SHARD_PIPE
    plan = shd.ShardingPlan(shd.create_mesh(pp=world, device=dev))
    batch, seq = (r["batch"], 32) if tiny else (r["batch"], r["seq"])
    vocab = 256 if tiny else 50257
    x, y = shard_batch(vocab, batch, seq, 3, dev)
    m = PipeGPT2.build(plan, dev, x, tiny=tiny)
    losses, step_ms = shard_steps(m, x, y, r["steps"], dev)
    planned = {k: v.detach().float().clone()
               for k, v in m.get_states().items()}
    del m
    out = {"pp": world, "microbatches": r["microbatches"], "batch": batch,
           "seq": seq, "dtype": "float32", "losses": losses,
           "step_ms": step_ms, "median_step_ms":
           statistics.median(step_ms[1:]), "tokens_per_s_per_card":
           batch * seq / statistics.median(step_ms[1:]) * 1e3 / world}
    if rank == 0:
        s = PipeGPT2.build(None, dev, x, tiny=tiny)
        init = {k: v.float().clone() for k, v in s.get_states().items()}
        s_losses, s_ms = shard_steps(s, x, y, r["steps"], dev)
        worst, at = update_diff(planned, s.get_states(), init)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           s_losses))
        out.update(serial_losses=s_losses, serial_median_step_ms=
                   statistics.median(s_ms[1:]), loss_max_rel_diff=loss_rel,
                   state_max_rel_diff=worst, state_max_rel_diff_at=at,
                   tolerance=SHARD_F32)
        if loss_rel > SHARD_F32["loss_rtol"] \
                or worst > SHARD_F32["state_rtol"]:
            raise AssertionError(f"GPipe pp={world} against one card: "
                                 f"losses {losses} vs {s_losses}, worst "
                                 f"state {at} at {worst}")
        del s
    gc.collect()
    return out


def shard_world_rank_main(rank, world, port, tiny=False):
    """One rank of ``shard_world``: every run of ``SHARD_WORLD_RUNS`` and
    GPipe; writes ``shard-world<W>-r<rank>.json``."""
    import torch.distributed as tdist

    from singa_tpu_torch.parallel import communicator

    cpu = tiny and not torch.cuda.is_available()
    communicator.initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank, backend="gloo" if cpu else "nccl",
        initialization_timeout=SHARD_JOIN_S)
    try:
        dev = torch.device("cpu") if cpu else \
            torch.device("cuda", torch.cuda.current_device())
        comm = communicator.Communicator()
        t0 = time.perf_counter()
        runs = [shard_world_run(kind, sizes, dev, tiny, comm)
                for kind, sizes in SHARD_WORLD_RUNS]
        pipe = shard_pipe_run(world, dev, tiny, rank)
        out = os.path.join(SHARD_DIR, f"shard-world{world}-r{rank}.json")
        with open(out + ".tmp", "w") as f:
            json.dump({"rank": rank, "runs": runs, "pipe": pipe,
                       "seconds": time.perf_counter() - t0,
                       "device": torch.cuda.get_device_name()
                       if not cpu else "cpu"}, f)
        os.replace(out + ".tmp", out)
    except BaseException:
        # the other ranks may wait in a collective this rank never joins:
        # leaving the group would wait with them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    # graphs holding NCCL work are freed before the group
    gc.collect()
    if not cpu:
        torch.cuda.synchronize()
    tdist.destroy_process_group()


def shard_world(world, tiny=False):
    """``--dist-world``'s sharded runs: ``world`` ranks, one a GPU, over an
    NCCL group on a localhost port (``shard_world_rank_main``); each must
    exit 0 within ``SHARD_JOIN_S``.  Returns rank 0's report with every
    rank's replay ms."""
    os.makedirs(SHARD_DIR, exist_ok=True)
    port = free_port()
    outs = [os.path.join(SHARD_DIR, f"shard-world{world}-r{rk}.json")
            for rk in range(world)]
    for o in outs:
        if os.path.exists(o):
            os.unlink(o)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-world-rank",
         str(rk), "--dist-world", str(world), "--dist-port", str(port)]
        + ["--tiny"] * tiny) for rk in range(world)]
    deadline = time.monotonic() + SHARD_JOIN_S
    try:
        # until all end, one fails (the rest may wait on it) or time is up
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if None not in rcs or any(rcs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs) or not all(os.path.exists(o) for o in outs):
        raise AssertionError(f"shard world {world}: exit codes {rcs}")
    ranks = [json.load(open(o)) for o in outs]
    r0 = ranks[0]
    for i, run in enumerate(r0["runs"]):
        run["rank_median_replay_ms"] = [rk["runs"][i]["median_replay_ms"]
                                        for rk in ranks]
    return {"phase": "shard_world", "world": world, "runs": r0["runs"],
            "pipe": r0["pipe"], "seconds": max(rk["seconds"]
                                               for rk in ranks)}


# ------------------------------------------------------------ serve_shard

#: the serve_shard phase: sharded serving (``serve/tp.py``, ``ep.py``,
#: ``pp.py``, ``shard.py``) of GPT-2 small at full width from a seed.
#: Rank 0 runs the engine, the other ranks mirror it
#: (``serve.shard.worker_loop``).  One card: two gloo ranks on it,
#: ``capture=False`` (gloo moves CUDA tensors through the host and
#: cannot be captured), a correctness run whose times are host staging,
#: not throughput.  ``--dist-world 4 --phases serve_shard``: four ranks,
#: one a card, over NCCL, captured steps against eager ones.  Each mode
#: serves ``SERVE_SHARD_N`` float32 greedy requests (prompts 16-512,
#: ``SERVE_SHARD_NEW`` new tokens) whose streams must equal the
#: single-device engine's and ``generate``'s token for token; the ring
#: mode ``SERVE_SHARD_RING_N`` prompts of 512-1000 tokens, prefilled by
#: ring attention.  One bf16 pass a mode logs TPOT and decode tokens/s
#: beside the one-card engine's on the same requests.
SERVE_SHARD_N = 8
SERVE_SHARD_NEW = 16
SERVE_SHARD_RING_N = 2
SERVE_SHARD_RING_MIN = 512
#: the ``moe`` phase's GPT-2 small MoE: 6 of the 12 blocks with 8
#: experts, top-2
SERVE_SHARD_MOE = dict(moe_every=2, moe_experts=8, moe_top_k=2)
#: decode microbatches of the pipeline modes
SERVE_SHARD_MB = 4
SERVE_SHARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "_scratch", "chip_smoke_serve_shard")
SERVE_SHARD_JOIN_S = 600
#: the bf16 busy-share window of the four-card runs: steps profiled
#: after ``SERVE_SHARD_WARM`` decode steps
SERVE_SHARD_WARM = 3
SERVE_SHARD_PROFILED = 6


def serve_shard_modes(world):
    """``(name, knob, config, moe)`` of the sharded engines at ``world``
    ranks: tensor, pipeline (``SERVE_SHARD_MB`` microbatches), expert
    (the MoE model) parallel, and tensor parallel with the ring
    prefill."""
    return [(f"tp{world}", "tp", world, False),
            (f"pp{world}", "pp", dict(stages=world,
                                      microbatches=SERVE_SHARD_MB), False),
            (f"ep{world}", "ep", world, True),
            (f"tp{world}_ring", "tp", dict(
                tp=world, ring_prefill=True,
                ring_min_tokens=SERVE_SHARD_RING_MIN), False)]


def serve_shard_traffic(ring, seed=0, vocab=50257):
    """Greedy requests: ``SERVE_SHARD_N`` prompts of 16-512 tokens, or
    (``ring``) ``SERVE_SHARD_RING_N`` of 512-1000."""
    rng = np.random.RandomState(seed + ring)
    lo, hi, n = (SERVE_SHARD_RING_MIN, 1001, SERVE_SHARD_RING_N) if ring \
        else (16, 513, SERVE_SHARD_N)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(lo, hi))
                 .astype(np.int32), max_new=SERVE_SHARD_NEW,
                 temperature=0.0, seed=int(rng.randint(0, 2 ** 31 - 1)))
            for _ in range(n)]


def _serve_counts():
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import paged_attention as pa

    return {"paged_attn": pa.paged_attn.launches,
            "flash_fwd": fa.flash_fwd.launches}


def _reset_serve_counts():
    _reset_paged_counts()
    reset_flash_counts()


def serve_tpot(model, traffic, dtype, capture, **kw):
    """TPOT (the requests' mean) and decode tokens/s of a second pass of
    ``traffic`` on one engine of the serve phase's size, the first pass
    its warm-up (a captured engine's graphs made there), and the
    engine's executor snapshot."""
    from singa_tpu_torch.observe import trace as tr
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype,
                      paged=PagedConfig(block_size=c["block_size"],
                                        num_blocks=c["num_blocks"]),
                      capture=capture, **kw)
    try:
        for measured in (False, True):
            if measured:
                tr.drain()
                tr.enable()
            hs = [eng.submit(GenerationRequest(
                w["prompt"], max_new_tokens=w["max_new"],
                temperature=w["temperature"], seed=w["seed"]))
                for w in traffic]
            eng.run_until_complete()
            torch.cuda.synchronize()
        tr.disable()
        dec_s = sum(e["dur"] for e in tr.drain()
                    if e["name"] == "serve/decode_step")
        res = [h.result() for h in hs]
        shard = None if eng._shard is None else eng._shard.snapshot()
    finally:
        tr.disable()
        eng.close(force=True)
    return dict(tpot_ms=1e3 * statistics.mean(r.tpot for r in res),
                decode_tok_s=sum(w["max_new"] - 1 for w in traffic) / dec_s,
                shard=shard)


def sharded_busy(model, traffic, dtype, knob, conf):
    """The device's busy share of rank 0's decode steps, bf16, captured
    (torch.profiler over ``SERVE_SHARD_PROFILED`` steps after
    ``SERVE_SHARD_WARM``)."""
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype,
                      paged=PagedConfig(block_size=c["block_size"],
                                        num_blocks=c["num_blocks"]),
                      **{knob: conf})
    try:
        for w in traffic:
            eng.submit(GenerationRequest(
                w["prompt"], max_new_tokens=w["max_new"],
                temperature=w["temperature"], seed=w["seed"]))
        for _ in range(1 + SERVE_SHARD_WARM):
            eng.step()
        out = profile_steps(lambda _x, _y: eng.step(), None, None,
                            steps=SERVE_SHARD_PROFILED, groups=SERVE_GROUPS)
        eng.run_until_complete()
    finally:
        eng.close(force=True)
    return {k: out[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                "device_busy_share", "group_ms_per_step")}


def serve_shard_controller(world, nccl, dev, seed=0):
    """Rank 0 of the serve_shard ranks: the models, the one-card
    references and every sharded engine (``serve_shard_modes``); returns
    the report, with rank 0's launches of each sharded engine in build
    order (``engines``)."""
    from singa_tpu_torch import amp, device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    amp.enable(False)
    cdev = device.create_cuda_gpu()
    models = {}
    for key, kw in (("dense", {}), ("moe", SERVE_SHARD_MOE)):
        cdev.SetRandSeed(seed)
        m = GPT2LMHead(GPT2Config.small(dropout=0.0, **kw))
        m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), cdev)],
                  is_train=False)
        models[key] = m
    engines, report, refs = [], {}, {}

    def counted(label, fn, *a, **kw):
        _reset_serve_counts()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        engines.append(dict(label=label, **_serve_counts()))
        return out

    for name, knob, conf, moe in serve_shard_modes(world):
        t0 = time.perf_counter()
        ring = name.endswith("_ring")
        model = models["moe" if moe else "dense"]
        traffic = serve_shard_traffic(ring, seed)
        key = ("moe" if moe else "dense", ring)
        if key not in refs:
            one, _, _, _ = run_engine(model, traffic, "block")
            gen = offline_streams(model, traffic)
            _same_streams(f"{key}: one card against generate", one, gen)
            ref16 = serve_tpot(model, traffic, torch.bfloat16, True)
            del ref16["shard"]
            refs[key] = dict(streams=one, bf16=ref16)
        ref = refs[key]
        eager, _, sec, _ = counted(f"{name}/float32/eager", run_engine,
                                   model, traffic, "block", capture=False,
                                   **{knob: conf})
        _same_streams(f"{name}: sharded float32 against one card", eager,
                      ref["streams"])
        row = dict(requests=len(traffic), float32_eager_s=sec,
                   launches_rank0=engines[-1])
        if nccl:
            cap, snap, csec, _ = counted(f"{name}/float32/captured",
                                         run_engine, model, traffic, "block",
                                         capture=True, **{knob: conf})
            _same_streams(f"{name}: captured against eager", cap, eager)
            row.update(captured_equals_eager=True, float32_captured_s=csec,
                       graphs=snap["graphs"]["census_at_end"])
        row["bf16"] = dict(counted(f"{name}/bf16", serve_tpot, model,
                                   traffic, torch.bfloat16, nccl,
                                   **{knob: conf}), one_card=ref["bf16"])
        if nccl:
            row["bf16"]["busy"] = counted(f"{name}/busy", sharded_busy,
                                          model, traffic, torch.bfloat16,
                                          knob, conf)
        row["seconds"] = time.perf_counter() - t0
        report[name] = row
    return dict(modes=report, engines=engines)


#: the sharded fleet: replicas of tp = 2, each a rank group of its own
#: (rank 0 and one mirror rank: 3 ranks in all)
SERVE_FLEET_REPLICAS = 2
SERVE_FLEET_TP = 2
SERVE_FLEET_JOIN_S = 300


def serve_fleet_tpot(model, traffic, dtype, capture, **kw):
    """A second pass of ``traffic`` on the sharded fleet, the first its
    warm-up: TPOT mean and median, decode tokens/s over the measured
    pass's wall seconds."""
    from singa_tpu_torch.serve import PagedConfig

    c = SERVE_ENGINE
    fleet = model.serve_fleet(
        replicas=SERVE_FLEET_REPLICAS, max_slots=c["max_slots"],
        dtype=dtype, capture=capture,
        paged=PagedConfig(block_size=c["block_size"],
                          num_blocks=c["num_blocks"]), **kw)
    try:
        for tag in ("w", "t"):
            hs = fleet_submit(fleet, traffic, tag)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.run_until_complete()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        res = [h.result() for h in hs]
    finally:
        fleet.close()
    return dict(tpot_ms=1e3 * statistics.mean(r.tpot for r in res),
                tpot_median_ms=1e3 * statistics.median(r.tpot for r in res),
                decode_tok_s=sum(w["max_new"] - 1 for w in traffic) / sec,
                seconds=sec)


def serve_fleet_controller(seed=0):
    """Rank 0 of the sharded fleet's gloo ranks: GPT-2 small from a seed,
    a fleet of ``SERVE_FLEET_REPLICAS`` tp = ``SERVE_FLEET_TP`` replicas
    (``serve/shard.py``: rank groups of their own, eager) against one
    card's engine: float32 streams equal,
    each replica's ranks and cards, its refusal to grow, and bf16 TPOT
    beside one card's."""
    from singa_tpu_torch import amp, device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.serve import PagedConfig

    amp.enable(False)
    cdev = device.create_cuda_gpu()
    cdev.SetRandSeed(seed)
    model = GPT2LMHead(GPT2Config.small(dropout=0.0))
    model.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), cdev)],
                  is_train=False)
    traffic = serve_shard_traffic(False, seed)
    one, _, _, _ = run_engine(model, traffic, "block")
    c = SERVE_ENGINE
    engines = []
    _reset_serve_counts()
    t0 = time.perf_counter()
    fleet = model.serve_fleet(
        replicas=SERVE_FLEET_REPLICAS, tp=SERVE_FLEET_TP,
        max_slots=c["max_slots"], capture=False,
        paged=PagedConfig(block_size=c["block_size"],
                          num_blocks=c["num_blocks"]))
    try:
        groups = []
        for i in range(SERVE_FLEET_REPLICAS):
            x = fleet.supervisor(i).engine._shard
            groups.append(dict(
                ranks=[int(r) for r in x.mesh.ranks.reshape(-1)],
                rank0_card=str(fleet.supervisor(i).engine._params["wte"]
                               .device),
                cards=[None if d is None else int(d)
                       for d in _fleet_cards(x.group)]))
        hs = fleet_submit(fleet, traffic, "s")
        fleet_drain(fleet, hs, one, "tp fleet")
        try:
            fleet.add_replica()
            raise AssertionError("a sharded fleet grew")
        except ValueError as e:
            refused = str(e)
        snap = fleet.snapshot()
    finally:
        fleet.close()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    engines.append(dict(label="fleet/float32", **_serve_counts()))
    if min(snap["routed"].values()) < 1:
        raise AssertionError(f"tp fleet routing: {snap['routed']}")
    _reset_serve_counts()
    bf16 = serve_fleet_tpot(model, traffic, torch.bfloat16, False,
                            tp=SERVE_FLEET_TP)
    torch.cuda.synchronize()
    engines.append(dict(label="fleet/bf16", **_serve_counts()))
    one16 = serve_tpot(model, traffic, torch.bfloat16, True)
    del one16["shard"]
    return dict(modes={"tp_fleet": dict(
        replicas=SERVE_FLEET_REPLICAS, tp=SERVE_FLEET_TP,
        requests=len(traffic), rank_groups=groups,
        routed=snap["routed"], float32_streams_equal_one_card=True,
        captured=False, float32_s=sec, add_replica_refused=refused,
        bf16=dict(bf16, one_card=one16))}, engines=engines)


def _fleet_cards(group):
    """The card of each of a replica group's shards, as its layout gave
    them (rank 0 knows every replica's)."""
    from singa_tpu_torch.serve import shard

    for ranks, _, devs in shard.fleet_layout(
            (len(group.ranks),), SERVE_FLEET_REPLICAS,
            torch.cuda.device_count()):
        if ranks == group.ranks:
            return devs
    return [None] * len(group.ranks)


def serve_shard_rank_main(rank, world, port, nccl, fleet=False):
    """One rank of the serve_shard run: rank 0 the controller, the others
    ``worker_loop`` (their launches counted a mirror, at its close);
    writes ``serve-shard<W>-r<rank>.json``."""
    import torch.distributed as tdist

    from singa_tpu_torch.parallel import communicator
    from singa_tpu_torch.serve import shard

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    stem = "serve-fleet" if fleet else "serve-shard"
    communicator.initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank, backend="nccl" if nccl else "gloo",
        initialization_timeout=SERVE_SHARD_JOIN_S)
    try:
        t0 = time.perf_counter()
        if rank == 0:
            try:
                out = (serve_fleet_controller() if fleet
                       else serve_shard_controller(world, nccl, dev))
            finally:
                shard.stop_workers()
        else:
            mirrors = []

            def closed(eng):
                torch.cuda.synchronize()
                mirrors.append(dict(kind=eng._shard.kind, **_serve_counts()))
                _reset_serve_counts()

            _reset_serve_counts()
            with torch.no_grad():
                shard.worker_loop(on_close=closed)
            out = dict(engines=mirrors)
        out.update(rank=rank, seconds=time.perf_counter() - t0)
        path = os.path.join(SERVE_SHARD_DIR, f"{stem}{world}-r{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)
    except BaseException:
        # the other ranks may wait in a collective this rank never joins
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    gc.collect()
    torch.cuda.synchronize()
    tdist.destroy_process_group()


def serve_shard_world(world, nccl, fleet=False):
    """Spawn this script ``world`` times as ``--serve-shard-rank`` (one
    card a rank over NCCL, or every rank on card 0 over gloo) and join
    them within ``SERVE_SHARD_JOIN_S``; returns rank 0's report with
    every rank's launches a sharded engine (``fleet``: the sharded
    fleet's ranks, ``serve_fleet_controller``; every rank's launches
    summed)."""
    os.makedirs(SERVE_SHARD_DIR, exist_ok=True)
    port = free_port()
    stem = "serve-fleet" if fleet else "serve-shard"
    outs = [os.path.join(SERVE_SHARD_DIR, f"{stem}{world}-r{rk}.json")
            for rk in range(world)]
    for o in outs:
        if os.path.exists(o):
            os.unlink(o)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-shard-rank",
         str(rk), "--dist-world", str(world), "--dist-port", str(port)]
        + ["--nccl"] * nccl + ["--fleet"] * fleet) for rk in range(world)]
    deadline = time.monotonic() + (SERVE_FLEET_JOIN_S if fleet
                                   else SERVE_SHARD_JOIN_S)
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if None not in rcs or any(rcs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs) or not all(os.path.exists(o) for o in outs):
        raise AssertionError(f"serve_shard world {world}: exit codes {rcs}")
    ranks = [json.load(open(o)) for o in outs]
    r0 = ranks[0]
    if fleet:
        # a worker rank mirrors its own replica's engines only: one entry
        # of every rank's fleet launches
        total = {"label": "fleet_all_ranks"}
        for k in ("paged_attn", "flash_fwd"):
            total[f"{k}_ranks"] = [sum(e[k] for e in rk["engines"])
                                   for rk in ranks]
        r0["engines"] = r0["engines"] + [total]
        return r0
    for rk in ranks[1:]:
        if len(rk["engines"]) != len(r0["engines"]):
            raise AssertionError(
                f"rank {rk['rank']} mirrored {len(rk['engines'])} engines, "
                f"rank 0 built {len(r0['engines'])}")
    # every rank's launches, engine by engine
    for i, e in enumerate(r0["engines"]):
        for k in ("paged_attn", "flash_fwd"):
            e[f"{k}_ranks"] = [e[k]] + [rk["engines"][i][k]
                                         for rk in ranks[1:]]
    return r0


def serve_shard_launches(engines, prefix):
    """``{kernel: launches}`` on every rank of the engines whose label
    starts with ``prefix``."""
    out = {"paged_attn": 0, "flash_fwd": 0}
    for e in engines:
        if e["label"].startswith(prefix):
            for k in out:
                out[k] += sum(e[f"{k}_ranks"])
    return out


def rank_cfg(cfg, tp):
    """GPT-2 small's attention as one of ``tp`` ranks sees it: its
    ``n_head / tp`` heads (``real_args`` reads the shape off a config)."""
    import types

    return types.SimpleNamespace(n_head=cfg.n_head // tp,
                                 n_kv_head=cfg.n_kv_head // tp,
                                 n_embd=cfg.n_embd // tp,
                                 n_layer=cfg.n_layer)


def phase_serve_shard():
    """Sharded serving on one card (module docstring): two gloo ranks, every
    mode of ``serve_shard_modes(2)``; then ``paged_attn`` timed at a
    rank's 6 heads (tp = 2) and 3 heads (tp = 4) over tables of the
    traffic's positions.  Returns the kernels line's ``paged_attn_tp2``
    row and the launches to add to the ``paged_attn`` and ``flash_fwd``
    rows."""
    from singa_tpu_torch.models.gpt2 import GPT2Config

    t0 = time.perf_counter()
    r0 = serve_shard_world(2, nccl=False)
    tf = time.perf_counter()
    rf = serve_shard_world(1 + SERVE_FLEET_REPLICAS * (SERVE_FLEET_TP - 1),
                           nccl=False, fleet=True)
    t1 = time.perf_counter()
    eng = r0["engines"]
    tp_launch = serve_shard_launches(eng, "tp2")
    # the fleet's replicas run at a tp = 2 rank's 6 heads too
    fleet_launch = serve_shard_launches(rf["engines"], "fleet_all_ranks")
    if fleet_launch["paged_attn"] == 0:
        raise AssertionError(f"the sharded fleet launched no paged_attn: "
                             f"{rf['engines']}")
    for k, v in fleet_launch.items():
        tp_launch[k] += v
    other = serve_shard_launches(eng, "pp2")
    for k, v in serve_shard_launches(eng, "ep2").items():
        other[k] += v
    if tp_launch["paged_attn"] == 0 or other["paged_attn"] == 0 \
            or tp_launch["flash_fwd"] == 0:
        raise AssertionError(f"a sharded engine launched no kernel: {eng}")
    cfg = GPT2Config.small()
    lens = [len(w["prompt"]) + SERVE_SHARD_NEW // 2
            for w in serve_shard_traffic(False)]
    tables = {f"tp{tp}": time_paged_table(paged_table(lens, rank_cfg(cfg, tp),
                                                      seed=20 + tp))
              for tp in (2, 4)}
    log({"phase": "serve_shard", "world": 2, "backend": "gloo",
         "modes": r0["modes"], "engines": eng,
         "fleet": dict(rf["modes"], world=3, engines=rf["engines"]),
         "paged_attn_rank_heads_row_5tp": tables,
         "seconds": {"ranks": tf - t0, "rank0": r0["seconds"],
                     "fleet_ranks": t1 - tf, "fleet_rank0": rf["seconds"],
                     "tables": time.perf_counter() - t1},
         "nvidia_smi": nvidia_smi()})
    t = tables["tp2"]
    ms = t["device_ms"]
    row = dict(
        name="paged_attn_tp2", route="cuda",
        source="singa_tpu_torch/csrc/paged_attention.cu",
        replaces=REPLACES["paged_attn"], launches=tp_launch["paged_attn"],
        max_abs_err=t["max_abs_err_vs_plain"], ms=ms["kernel"],
        plain_ms=ms["plain"], bound_ms=ms["bound"], bound_by=t["bound_by"],
        library_ms=ms["sdpa_alone"],
        library_call="torch.nn.functional.scaled_dot_product_attention on "
                     "rows gathered from the pool (the gather not timed)",
        kernels="paged_attn_kernel<T, T> (split) + paged_combine_kernel<T, "
                "T> at a tp = 2 rank's 6 heads (the sharded decode steps "
                "and the tp = 2 fleet's replicas, float32 and bf16, every "
                "rank)")
    return row, other, tp_launch["flash_fwd"]


def _build_serving():
    from singa_tpu_torch.ops import _build

    for src in ("flash_attention", "paged_attention"):
        _build.build(src)  # once, before the ranks load them


def main_serve_shard_world(n):
    """``--dist-world N --phases serve_shard``: ``serve_shard_world`` at N
    over NCCL."""
    _build_serving()
    r0 = serve_shard_world(n, nccl=True)
    log({"phase": "serve_shard_world", "world": n, "backend": "nccl",
         "modes": r0["modes"], "engines": r0["engines"],
         "seconds": r0["seconds"],
         "nvidia_smi": nvidia_smi().splitlines()})


# ------------------------------------------------------------- bottleneck


def bottleneck_inputs(b, h, w, c, cm, seed, affine="unit"):
    """Kernel arguments for one case, from a numpy seed: x ~ N(0, 1) and
    weights ~ N(0, 2/fan_in) in bf16, so every stage is O(1); ``affine``
    is ``"unit"`` (s = 1, b = 0), ``"random"`` (s ~ U(0.5, 1.5), b ~
    N(0, 0.5²)) or ``"b1_plus_one"`` (s = 1, b1 = +1: a halo padded with
    relu(b1) instead of 0 would show)."""
    rng = np.random.RandomState(seed)

    def rand(shape, std, dtype=torch.bfloat16):
        a = rng.randn(*shape).astype(np.float32) * std
        return torch.from_numpy(a).to(DEVICE).to(dtype)

    x = rand((b, h, w, c), 1.0)
    w1 = rand((c, cm), math.sqrt(2.0 / c))
    w2 = rand((3, 3, cm, cm), math.sqrt(2.0 / (9 * cm)))
    w3 = rand((cm, c), math.sqrt(2.0 / cm))
    sb = []
    for n in (cm, cm, c):
        if affine == "random":
            s_ = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(
                np.float32)).to(DEVICE)
            sb += [s_, rand((n,), 0.5, torch.float32)]
        else:
            sb += [torch.ones(n, device=DEVICE),
                   torch.zeros(n, device=DEVICE)]
    if affine == "b1_plus_one":
        sb[1] = torch.ones(cm, device=DEVICE)
    s1, b1, s2, b2, s3, b3 = sb
    return x, w1, s1, b1, w2, s2, b2, w3, s3, b3


def ulp_bf16(t):
    """One bf16 ulp at each |t| (float32): 2^(e-8) for |t| in [2^(e-1),
    2^e)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def bottleneck_stats(got, want, tol):
    """Per-element comparison of a block's output with its reference under
    ``tol`` (a ``TOL["bottleneck"]``-style dict): each |got - want| against
    ulps * ulp_bf16(want) + rtol * |want| + rms_atol * rms(want).  Returns
    the max |difference|, the RMS and max |want|, the share of elements
    that differ at all and of those past the limit, the largest
    difference over its limit, and ``ok``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"got shape {tuple(got.shape)} (want "
                             f"{tuple(want.shape)}) or non-finite values")
    d = (got - want).abs()
    rms = want.square().mean().sqrt().item()
    limit = (tol["ulps"] * ulp_bf16(want) + tol["rtol"] * want.abs()
             + tol["rms_atol"] * rms)
    stats = dict(max_abs_err=d.max().item(), rms_want=rms,
                 max_abs_want=want.abs().max().item(),
                 share_differing=(d > 0).double().mean().item(),
                 share_past_limit=(d > limit).double().mean().item(),
                 max_err_over_limit=(d / limit).max().item())
    stats["ok"] = (stats["share_past_limit"] == 0
                   and stats["share_differing"] <= tol["max_differing"])
    return stats


def _compare_bottleneck(name, got, want, tol):
    """``bottleneck_stats``; raises unless they pass."""
    stats = bottleneck_stats(got, want, tol)
    if not stats["ok"]:
        raise AssertionError(f"{name}: megakernel_block fails its gate "
                             f"{tol}: {stats}")
    return stats


def check_bottleneck_case(name, b, h, w, c, cm, seed, affine="unit"):
    """``megakernel_block`` against its plain version on one case from
    ``bottleneck_inputs``; returns ``bottleneck_stats`` and raises past
    ``TOL["bottleneck"]``."""
    from singa_tpu_torch.ops import bottleneck as bk

    # the plain version's float32 convs, not cuDNN's default TF32
    torch.backends.cudnn.allow_tf32 = False
    args = bottleneck_inputs(b, h, w, c, cm, seed, affine)
    got = bk.megakernel_block(*args)
    want = bk.megakernel_block_plain(*args)
    torch.cuda.synchronize()
    return _compare_bottleneck(name, got, want, TOL["bottleneck"])


def bottleneck_f64(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, images=16):
    """The block in float64 with y1, y2 and out rounded to x's dtype at the
    kernel's rounding points: the exact sums, ``images`` at a time."""
    import torch.nn.functional as F

    dt = x.dtype
    k1 = w1.double().t()[:, :, None, None]
    k2 = w2.double().permute(3, 2, 0, 1)
    k3 = w3.double().t()[:, :, None, None]
    s1, b1, s2, b2, s3, b3 = (t.double()[:, None, None]
                              for t in (s1, b1, s2, b2, s3, b3))
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], images):
        xf = x[i:i + images].double().permute(0, 3, 1, 2)
        y1 = torch.relu(F.conv2d(xf, k1) * s1 + b1).to(dt).double()
        y2 = torch.relu(F.conv2d(y1, k2, padding=1) * s2 + b2).to(dt).double()
        y3 = F.conv2d(y2, k3) * s3 + b3
        out[i:i + images] = torch.relu(y3 + xf).to(dt).permute(0, 2, 3, 1)
    return out


def f64_witness(got, plain, exact):
    """The kernel's output ``got`` and its plain version's ``plain``, each
    held against ``exact`` (``bottleneck_f64``) by ``bottleneck_stats``
    under ``TOL["bottleneck"]``, with the gate's own ``got`` against
    ``plain``.  ``ok`` when the kernel is no farther from exact than the
    plain version: it differs from ``exact`` on no larger a share of the
    elements (and within the gate's share), and no element by more than
    ``WITNESS_MAX_OVER`` times the gate's limit."""
    tol = TOL["bottleneck"]
    out = {"vs_plain": bottleneck_stats(got, plain, tol),
           "kernel_vs_f64": bottleneck_stats(got, exact, tol),
           "plain_vs_f64": bottleneck_stats(plain, exact, tol)}
    k, p = out["kernel_vs_f64"], out["plain_vs_f64"]
    out["ok"] = (k["share_differing"] <= min(p["share_differing"],
                                             tol["max_differing"])
                 and k["max_err_over_limit"] <= WITNESS_MAX_OVER)
    return out


def refuse_planted_faults(args, want):
    """``bottleneck_stats`` of each of ``planted_faults(*args)`` against
    the right output ``want``; raises if the gate passes one."""
    faults = {}
    for fault, wrong in planted_faults(*args).items():
        faults[fault] = bottleneck_stats(wrong, want, TOL["bottleneck"])
        if faults[fault]["ok"]:
            raise AssertionError(f"the bottleneck gate passes the planted "
                                 f"fault {fault}: {faults[fault]}")
    return faults


def planted_faults(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """Outputs of two wrong blocks, from the plain version's float32
    arithmetic, that the gate must refuse: ``halo_relu_b1`` pads y1's SAME
    ring with relu(b1) (y1 computed on a zero-padded x) instead of 0, and
    ``no_skip_one_column`` leaves the skip out of the middle column.  The
    first is left out where relu(b1) is 0 everywhere, as it then changes
    nothing."""
    import torch.nn.functional as F

    dt = x.dtype
    xf = x.float().permute(0, 3, 1, 2)

    def conv(y, wt, s, b, padding=0):
        y = F.conv2d(y, wt.float(), padding=padding)
        return y * s[:, None, None] + b[:, None, None]

    k1 = w1.t()[:, :, None, None]
    k2 = w2.permute(3, 2, 0, 1)
    k3 = w3.t()[:, :, None, None]

    def tail(y1, padding):
        y2 = torch.relu(conv(y1, k2, s2, b2, padding)).to(dt).float()
        return conv(y2, k3, s3, b3)

    y1 = torch.relu(conv(xf, k1, s1, b1)).to(dt).float()
    ring = torch.relu(conv(F.pad(xf, (1, 1, 1, 1)), k1, s1, b1))
    skip = xf.clone()
    skip[..., xf.shape[-1] // 2] = 0
    out = {"no_skip_one_column": torch.relu(tail(y1, 1) + skip)}
    if (b1 > 0).any():
        out["halo_relu_b1"] = torch.relu(tail(ring.to(dt).float(), 0) + xf)
    return {n: t.to(dt).permute(0, 2, 3, 1) for n, t in out.items()}


def bottleneck_edge_cases():
    """(name, kwargs) of the shapes that pin the kernel's semantics."""
    full = dict(h=56, w=56, c=256, cm=64)
    return [
        ("b1", dict(full, b=1)),
        ("hw7_bands_ragged", dict(b=2, h=7, w=7, c=256, cm=64)),
        ("h56_w28", dict(b=2, h=56, w=28, c=256, cm=64)),
        ("c128_cm32", dict(b=2, h=14, w=14, c=128, cm=32)),
        # the kernel's CM <= 128 instantiation, with 165 KB of shared
        # memory (one block an SM)
        ("cm128_w56", dict(b=1, h=8, w=56, c=256, cm=128)),
        ("odd_h5_w9_cm8", dict(b=3, h=5, w=9, c=64, cm=8)),
        ("b1_plus_one", dict(b=2, h=14, w=14, c=256, cm=64,
                             affine="b1_plus_one")),
        ("random_affine", dict(full, b=2, affine="random")),
    ]


def bottleneck_bound_ms(b, h, w, c, cm):
    """Least time for the block: x read and out written once (bf16), the
    weights and scales read once, against 2·B·H·W·(C·CM + 9·CM² + CM·C)
    FLOP at the bf16 peak."""
    macs = c * cm + 9 * cm * cm + cm * c
    flops = 2 * b * h * w * macs
    nbytes = 2 * b * h * w * c * 2 + macs * 2 + (4 * cm + 2 * c) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cudnn_chain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The block as cuDNN runs it: three channels-last bf16 convs, each
    followed by the folded BN and ReLU in bf16 (the yardstick the
    experiment used; the port never calls it).  Returns a callable."""
    import torch.nn.functional as F

    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)  # an NCHW view in channels-last memory
    k1 = w1.t()[:, :, None, None].contiguous(memory_format=cl)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    k3 = w3.t()[:, :, None, None].contiguous(memory_format=cl)
    sb = [t.to(torch.bfloat16)[None, :, None, None]
          for t in (s1, b1, s2, b2, s3, b3)]

    def run():
        y = torch.relu_(torch.addcmul(sb[1], F.conv2d(xc, k1), sb[0]))
        y = torch.relu_(torch.addcmul(sb[3], F.conv2d(y, k2, padding=1),
                                      sb[2]))
        y = torch.addcmul(sb[5], F.conv2d(y, k3), sb[4])
        return torch.relu_(y.add_(xc))

    return run


def phase_bottleneck(m, images):
    """The kernel on the real ``layer1[1]`` input of the trained model,
    its edge cases and its times; returns its row of the kernels line."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.ops import bottleneck as bk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m.eval()
    block = m.layer1[1]
    with torch.no_grad():
        act = m.layer1[0](m.stem(images)).to(torch.bfloat16)
        ref = block(act).float().permute(0, 2, 3, 1)
    x = act.permute(0, 2, 3, 1).contiguous()
    args = (x,) + bk.fold_bottleneck(block)

    bk.megakernel_block.launches = 0
    out = bk.megakernel_block(*args)
    torch.cuda.synchronize()
    launches = bk.megakernel_block.launches
    if launches != 1:
        raise AssertionError(f"megakernel_block launched {launches} times "
                             f"on the main path, expected 1")
    plain = bk.megakernel_block_plain(*args)
    gate = _compare_bottleneck("layer1[1]", out, plain, TOL["bottleneck"])
    vs_block = _compare_bottleneck("layer1[1] vs the port's eval block",
                                   out, ref, BLOCK_TOL)
    amp.enable(False)
    # the gate's power: it must refuse the planted faults at this input
    # and where b1 = +1 makes a relu(b1) ring large
    faults = {"layer1[1]": refuse_planted_faults(args, plain)}
    del ref, plain
    b1_args = bottleneck_inputs(2, 14, 14, 256, 64, seed=0,
                                affine="b1_plus_one")
    faults["b1_plus_one"] = refuse_planted_faults(
        b1_args, bk.megakernel_block_plain(*b1_args))

    edge = {}
    for seed, (name, kw) in enumerate(bottleneck_edge_cases()):
        st = check_bottleneck_case(name, seed=seed, **kw)
        edge[name] = {k: st[k] for k in ("max_abs_err", "share_differing")}

    # random inputs at the main path's shape, refereed by float64 sums
    witness = {}
    for affine in ("unit", "random"):
        full_args = bottleneck_inputs(*x.shape, args[1].shape[1], seed=0,
                                      affine=affine)
        witness[affine] = f64_witness(bk.megakernel_block(*full_args),
                                      bk.megakernel_block_plain(*full_args),
                                      bottleneck_f64(*full_args))
        del full_args
        if not witness[affine]["ok"]:
            raise AssertionError(f"random {tuple(x.shape)} input, {affine} "
                                 f"affine: the kernel is farther from float64 "
                                 f"than its plain version: {witness[affine]}")

    chain = cudnn_chain(*args)
    chain_err = (chain().float() - out.float().permute(0, 3, 1, 2)
                 ).abs().max().item()
    ms = cuda_time_ms(lambda: bk.megakernel_block(*args), 10)
    plain_ms = cuda_time_ms(lambda: bk.megakernel_block_plain(*args), 3)
    chain_ms = cuda_time_ms(chain, 10)
    b, h, w, c = x.shape
    cm = args[1].shape[1]
    bound, by = bottleneck_bound_ms(b, h, w, c, cm)
    log({"phase": "bottleneck", "shape": dict(b=b, h=h, w=w, c=c, cm=cm),
         "input": "ResNet-50 layer1[1] input after the resnet phase's "
                  "steps, eval mode, channels-last bf16",
         "launches_main_path": launches, "vs_plain": gate,
         "tol": TOL["bottleneck"], "vs_eval_block": vs_block,
         "block_tol": BLOCK_TOL, "planted_faults": faults,
         "max_abs_diff_cudnn_chain": chain_err, "edge": edge,
         "random_full_vs_f64": witness,
         "smem_bytes": bk.smem_bytes(w, cm),
         "times_ms": {"kernel": ms, "plain": plain_ms,
                      "cudnn_chain": chain_ms, "bound": bound}})
    return dict(name="megakernel_block", route="cuda",
                source="singa_tpu_torch/csrc/resnet_bottleneck.cu",
                replaces="experiments/resnet_megakernel.py:40",
                launches=launches, max_abs_err=gate["max_abs_err"],
                share_differing=gate["share_differing"],
                rms_want=gate["rms_want"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                library_call="none: no single PyTorch call computes the "
                             "block",
                cudnn_chain_ms=chain_ms)


# ------------------------------------------------------------ paged attn

# paged_attn vs paged_attn_plain, allclose(rtol, atol):
#   float32 - both sum in float32, the kernel in 32-key tiles a warp then
#             across warps, the plain version block by block: outputs are
#             convex combinations of N(0, 1) values, and sums of up to
#             1000 terms differ by a few float32 ulps: 2e-5;
#   bf16    - pools, queries and outputs bf16 (2^-8 relative), sums
#             float32 in both: the outputs differ by at most one bf16
#             rounding, 2^-7 of values below 2: 1e-2;
#   float16 - the same with float16's 2^-11 relative rounding: one
#             rounding is 2^-10 of values below 2: 2e-3.
PAGED_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2),
             torch.float16: (2e-3, 2e-3)}
PAGED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# value of every element of the trash block in the edge cases: a kernel
# that read it unmasked would move outputs by O(10)
PAGED_TRASH_VALUE = 50.0


def paged_inputs(lens, block, d, n_kv, g, nq, dtype, seed, window=None,
                 spare=3, trash_at=(), from_block0=False, quant=False,
                 share=()):
    """Kernel arguments for one paged case, made from a numpy seed: slot
    s attends ``lens[s]`` pool lanes (0: a dead slot with an all-trash
    table) through ``ceil(lens[s] / block)`` distinct random blocks, its
    table trash-padded one entry past the longest slot's; ``spare``
    unused blocks; the trash block filled with ``PAGED_TRASH_VALUE``.
    ``trash_at``: (slot, entry) table entries set to the trash block
    below ``lens[slot]`` (lanes the function masks, as the JAX engine's
    dropped out-of-window blocks).  ``share``: (slots, n) groups whose
    slots' first n entries name the first slot's blocks, as the tables of
    a fork group's branches do (their own blocks there go unused).  With
    a ``window``, ``blk_lo`` is the
    first block holding an in-window lane of any live slot, or None
    (read from block 0) with ``from_block0``.  ``quant``: the same draws,
    the pools and current K/V quantized to int8 (values, scales) pairs
    (``gpt2_decode._quantize_kv``, the trash block's values 127 at scale
    50 / 127), q in ``dtype``."""
    rng = np.random.RandomState(seed)
    need = [-(-p // block) for p in lens]
    n_blocks = sum(need) + spare
    width = max(need + [0]) + 1
    ids = rng.permutation(n_blocks)
    tables = np.full((len(lens), width), n_blocks, np.int32)
    at = 0
    for s, n in enumerate(need):
        tables[s, :n] = ids[at:at + n]
        at += n
    for s, j in trash_at:
        tables[s, j] = n_blocks
    for slots, n in share:
        for s in slots[1:]:
            tables[s, :n] = tables[slots[0], :n]

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    pool_k, pool_v = (rand(n_blocks + 1, n_kv, block, d) for _ in range(2))
    pool_k[-1] = pool_v[-1] = PAGED_TRASH_VALUE
    q = rand(len(lens), n_kv, g, nq, d)
    k_cur, v_cur = (rand(len(lens), n_kv, nq, d) for _ in range(2))
    live = [p for p in lens if p > 0]
    blk_lo = None
    if window is not None and not from_block0:
        blk_lo = min((max(0, (p - window + 1) // block) for p in live),
                     default=0)
    if quant:
        from singa_tpu_torch.models.gpt2_decode import _quantize_kv

        def on(t):
            return tuple(x.to(DEVICE).contiguous() for x in _quantize_kv(t))
    else:
        def on(t):
            return t.to(DEVICE, dtype).contiguous()
    return dict(
        q=q.to(DEVICE, dtype).contiguous(), pool_k=on(pool_k),
        pool_v=on(pool_v), tables=torch.from_numpy(tables).to(DEVICE),
        p_limit=torch.tensor(lens, dtype=torch.int32, device=DEVICE),
        k_cur=on(k_cur), v_cur=on(v_cur),
        cur_mask=torch.ones(nq, nq, dtype=torch.bool,
                            device=DEVICE).tril(),
        scale=1.0 / math.sqrt(d), window=window, blk_lo=blk_lo)


def paged_edge_cases():
    """(name, kwargs of ``paged_inputs`` but dtype and seed): the edges of
    ``tests/test_paged.py::test_kernel_edge_geometry`` and of the
    kernel's tiles: whole 32-key tiles masked by the window before any
    live lane (the explicit zero of masked probabilities), trash entries
    inside a table.  GPT-2 small's decode is n_kv 12, g 1, Q 1, D 64."""
    base = dict(d=64, n_kv=2, g=1, nq=1)
    cases = [
        ("b1", dict(lens=[5, 1, 9], block=1)),
        ("b8_partial_last_block", dict(lens=[13, 21, 3], block=8)),
        ("b16_pos_on_boundary", dict(lens=[32, 16, 48], block=16)),
        ("b32_tiles", dict(lens=[100, 64, 31], block=32)),
        ("dead_slots_all_trash", dict(lens=[0, 17, 0], block=8)),
        ("one_block_tables", dict(lens=[7, 16, 1], block=16)),
        ("g3_n_kv4", dict(lens=[40, 9], block=8, n_kv=4, g=3)),
        ("d128", dict(lens=[33, 70], block=16, d=128)),
        ("q4_tril", dict(lens=[12, 30], block=8, nq=4)),
        ("g3_q4_d128", dict(lens=[25, 8], block=8, d=128, g=3, nq=4)),
        ("window", dict(lens=[50, 29, 33], block=8, window=20)),
        ("window_q4_g3", dict(lens=[41, 17], block=8, nq=4, g=3,
                              window=10)),
        ("window_from_block0", dict(lens=[150, 90], block=8, window=16,
                                    from_block0=True)),
        ("trash_inside_table", dict(lens=[40, 20], block=8,
                                    trash_at=[(0, 1), (0, 3), (1, 0)])),
        ("long_b32", dict(lens=[1000, 300, 640], block=32)),
        ("long_b1", dict(lens=[200, 130], block=1)),
        # the split plan: a long slot beside short ones (their higher
        # splits empty), a window whose live keys all fall in the last
        # split of each slot (read from block 0)
        ("long_beside_short", dict(lens=[900, 40, 7], block=16)),
        ("window_in_one_split", dict(lens=[700, 650], block=32, window=50,
                                     from_block0=True)),
        # head dims off the 64 / 128 rows: rounded up to 16 / 64 / 128 /
        # 256 with the tail zero-filled; D = 20 in bf16 is 40 bytes a row,
        # so element copies instead of 16-byte ones
        ("d16", dict(lens=[45, 3, 130], block=8, d=16)),
        ("d40_g3", dict(lens=[70, 20], block=16, d=40, g=3)),
        ("d80_q4", dict(lens=[33, 64], block=8, d=80, nq=4)),
        ("d256_g2_q2", dict(lens=[300, 17], block=32, d=256, g=2, nq=2)),
        ("d20_element_loads", dict(lens=[37, 90], block=8, d=20)),
        # rows past 512: the 1024-wide rung (one stage; float32 takes K
        # and V in turns), and GQA groups of more query rows than a launch
        # holds, launched in groups of heads (32 rows at D = 64 in two
        # groups of 16; 6 heads at D = 1024 in groups of 4 and 2)
        ("d640", dict(lens=[70, 33], block=16, d=640)),
        ("d1024_g6", dict(lens=[45, 100], block=8, d=1024, g=6)),
        ("g8_q4_32_rows", dict(lens=[40, 75], block=8, g=8, nq=4)),
        # more query positions than one launch holds (a speculative
        # verify's Q = spec_k): runs of max_rows(D) positions, each
        # launch taking all Q current lanes and its rows of the tril
        # cur_mask (and, under a window, its positions' offset)
        ("q24_tril", dict(lens=[30, 12], block=8, nq=24)),
        ("q40_d256", dict(lens=[50, 20], block=16, d=256, nq=40)),
        ("q24_g2_window", dict(lens=[60, 33], block=8, g=2, nq=24,
                               window=20)),
        # the combine's scores of 16 rows by 800 current lanes pass the
        # 48 KB of shared memory a launch gets without the attribute
        ("q800_combine_past_48kb", dict(lens=[20, 7], block=8, nq=800)),
        # fork groups: several slots' tables name the same prompt blocks
        # (the last one of them partly filled), a dead slot between
        ("fork_shared_blocks", dict(lens=[37, 40, 45, 0, 29, 26], block=8,
                                    share=[((0, 1, 2), 4), ((4, 5), 3)])),
    ]
    return [(n, {**base, **kw}) for n, kw in cases]


def paged_serving_cases():
    """(name, kwargs of ``paged_inputs`` but dtype and seed) at the shapes
    of the ``spec`` and ``longctx`` phases' steps: GPT-2 small's 12 kv
    heads at D 64, blocks of 32, 8 slots: a verify chunk at Q = 4 (a dead
    slot, chunks across a block edge) and a windowed decode step and
    verify chunk (window 256) whose tables hold the trash block below
    each slot's window, read from table entry 0 as the engine reads
    them; the ``fork`` phase's decode step, two fork groups whose
    branches' tables share their prompt blocks; and the ``fleet`` phase's
    ship destination: long slots whose first blocks a shipped image
    landed in, two of them naming one shipped prefix (a second request
    warm on it)."""
    base = dict(d=64, n_kv=12, g=1, block=32)
    spec = [400, 37, 129, 0, 511, 64, 250, 1000]
    win = [700, 1000, 300, 260, 575, 831, 960, 1019]
    dropped = [(s, j) for s, p in enumerate(win)
               for j in range(max(0, (p - LONGCTX_WINDOW + 1) // 32))]
    wkw = dict(base, lens=win, window=LONGCTX_WINDOW, trash_at=dropped,
               from_block0=True)
    fork = [300, 302, 305, 299, 520, 518, 530, 0]
    ship = [655, 688, 556, 560, 746, 767, 767, 0]
    return [("spec_q4", dict(base, lens=spec, nq=SPEC_K)),
            ("window_q1", dict(wkw, nq=1)),
            ("window_q4", dict(wkw, nq=SPEC_K)),
            ("fork_q1", dict(base, lens=fork, nq=1,
                             share=[((0, 1, 2, 3), 9), ((4, 5, 6), 16)])),
            ("ship_q1", dict(base, lens=ship, nq=1,
                             share=[((5, 6), 22)]))]


def check_paged_case(name, dtype, seed, quant=False, **kw):
    """The kernel against its plain version on one case (``quant``: int8
    pools, q in ``dtype``): returns max |kernel - plain| and raises past
    ``PAGED_TOL[dtype]``."""
    from singa_tpu_torch.ops import paged_attention as pa

    args = paged_inputs(dtype=dtype, seed=seed, quant=quant, **kw)
    got = pa.paged_attn(**args).float()
    want = pa.paged_attn_plain(**args).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: paged_attn gave non-finite values")
    err = (got - want).abs().max().item()
    rtol, atol = PAGED_TOL[dtype]
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: paged_attn differs from its plain "
                             f"version by {err} (rtol {rtol}, atol {atol})")
    return err


def paged_bound_ms(lens, n_kv, g, nq, d, dtype, quant=False, window=None,
                   tables=None, block=None):
    """Least time for one call: the live K/V lanes read once, q and the
    current K/V read and the output written once, over memory bandwidth;
    against 4 FLOPs per (query row, live lane, element) over the peak
    rate for q's dtype.  ``quant``: int8 lanes, D bytes and a float32
    scale each.  ``window``: a slot's live pool lanes are those its first
    query sees, at most ``window - 1``.  ``tables`` (and ``block``): a
    block that several slots' tables name (a fork group's prompt blocks)
    is read once, its lanes the most any of them sees.  Returns ``(ms,
    "bytes" or "operations")``."""
    elem = torch.finfo(dtype).bits // 8
    row = d + 4 if quant else d * elem                # bytes of a K or V lane
    lanes = int(sum(lens if window is None
                    else [min(p, window - 1) for p in lens]))
    read = lanes
    if tables is not None and window is None:
        seen = {}
        for t, p in zip(np.asarray(tables), lens):
            for j in range(-(-p // block)):
                seen[t[j]] = max(seen.get(t[j], 0), min(block, p - j * block))
        read = sum(seen.values())
    s_ = len(lens)
    nbytes = (2 * read * n_kv * row                  # live K and V lanes
              + 2 * s_ * n_kv * g * nq * d * elem    # q and the output
              + 2 * s_ * n_kv * nq * row)            # k_cur and v_cur
    flops = 4 * (lanes + s_ * nq) * n_kv * g * nq * d
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _rotating(calls):
    """One callable that makes the next of ``calls`` each time, in turn:
    timed over the layers of a decode step, each launch reads another
    layer's pool, as the serve step does, and the working set outgrows
    the 50 MB L2 cache."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def sdpa_yardstick(layers):
    """The library yardstick at one decode step's inputs, layer by layer:
    each slot's live blocks gathered into dense (S, H, n_blk * B + B, D)
    rows
    with the current K/V at lane ``p_limit`` (not timed; int8 pools
    dequantized to q's dtype first, not timed either), then
    ``scaled_dot_product_attention`` with a mask of lanes <= ``p_limit``
    (timed alone, over the layers in turn: no one PyTorch call computes
    paged attention).  Returns (device ms of SDPA, its event ms, event ms
    of one layer's gather, max |SDPA - kernel| at the first layer)."""
    import torch.nn.functional as F

    from singa_tpu_torch.models.gpt2_decode import _dequantize_kv
    from singa_tpu_torch.ops import paged_attention as pa

    kernel_out = pa.paged_attn(**layers[0])
    window = layers[0].get("window")
    if isinstance(layers[0]["pool_k"], tuple):
        # int8 pools: SDPA reads them dequantized to q's dtype (not timed)
        layers = [dict(a, **{k: _dequantize_kv(*a[k], a["q"].dtype)
                             for k in ("pool_k", "pool_v", "k_cur",
                                       "v_cur")}) for a in layers]
    a0 = layers[0]
    q = a0["q"]
    s_, n_kv, g, nq, d = q.shape
    block = a0["pool_k"].shape[2]
    n_blk = max(-(-p // block) for p in a0["p_limit"].tolist())
    width = (n_blk + 1) * block
    tbl = torch.cat([a0["tables"][:, :n_blk].long(),
                     torch.full((s_, 1), a0["pool_k"].shape[0] - 1,
                                device=q.device)], 1)
    lanes = torch.arange(s_, device=q.device)[:, None]
    qpos = a0["p_limit"].long()[:, None] + torch.arange(nq, device=q.device)
    t = torch.arange(width, device=q.device)
    live = t <= qpos[:, :, None]                         # (S, Q, width)
    if window is not None:
        live = live & (t > qpos[:, :, None] - window)
    mask = live[:, None]
    qq = q.reshape(s_, n_kv * g, nq, d)

    def gather(a):
        def row(pool, cur):
            r = pool[tbl].permute(0, 2, 1, 3, 4)       # (S, H, nb, B, D)
            r = r.reshape(s_, n_kv, width, d).clone()
            r[lanes, :, qpos] = cur.transpose(1, 2)
            return r.repeat_interleave(g, 1) if g > 1 else r
        return row(a["pool_k"], a["k_cur"]), row(a["pool_v"], a["v_cur"])

    gather_ms = cuda_time_ms(lambda: gather(a0), 10)
    rows = [gather(a) for a in layers]
    calls = [lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask) for kk, vv in rows]
    err = (calls[0]().float().reshape(q.shape)
           - kernel_out.float()).abs().max().item()
    sdpa = _rotating(calls)
    return (device_ms_per_call(sdpa, 4 * len(calls)),
            cuda_time_ms(sdpa, 4 * len(calls)), gather_ms, err)


#: calls of ``paged_attn``'s plain version a timed table times (its
#: first ``PAGED_PLAIN_CALLS`` layers; the plain version is about 200x
#: the kernel and host-bound, so a few calls fix its time, and profiling
#: a layer's worth of its small kernels takes seconds)
PAGED_PLAIN_CALLS = 2


def time_paged_table(layers):
    """Times of ``paged_attn`` at one table over its layers' pools in turn
    (device time: the split and combine kernels summed), on the first
    layer alone (its K/V then stays in L2), of its plain version
    (``PAGED_PLAIN_CALLS`` calls) and of the SDPA yardstick, beside the
    bound; and the kernel's largest difference from its plain version
    there (raises past ``PAGED_TOL``)."""
    from singa_tpu_torch.ops import paged_attention as pa

    args = layers[0]
    got = pa.paged_attn(**args)
    want = pa.paged_attn_plain(**args)
    err = (got.float() - want.float()).abs().max().item()
    rtol, atol = PAGED_TOL[args["q"].dtype]
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"paged_attn at a timed table differs from its "
                             f"plain version by {err}")
    n = len(layers)
    kernel = _rotating([functools.partial(pa.paged_attn, **a)
                        for a in layers])
    plain = _rotating([functools.partial(pa.paged_attn_plain, **a)
                       for a in layers])
    sdpa_ms, sdpa_events_ms, gather_ms, sdpa_err = sdpa_yardstick(layers)
    s_, n_kv, g, nq, d = args["q"].shape
    lens = args["p_limit"].tolist()
    quant = isinstance(args["pool_k"], tuple)
    window = args.get("window")
    pool = pa._values(args["pool_k"])
    block = pool.shape[2]
    bound, by = paged_bound_ms(lens, n_kv, g, nq, d, args["q"].dtype, quant,
                               window, args["tables"].cpu().numpy(), block)
    by_kernel = device_ms_by_kernel(kernel, 4 * n)
    extra = {}
    if window is not None:
        # the engine's steps read from table entry 0 (blk_lo None: a
        # captured step cannot hold a host bound); the JAX engine's bound,
        # the lowest live slot's first in-window block, beside it, its
        # split plan, and entry 0 timed again after it (an order check)
        lo = min(max(0, (p - window + 1) // block) for p in lens)
        exact = _rotating([functools.partial(pa.paged_attn,
                                             **dict(a, blk_lo=lo))
                           for a in layers])
        by_exact = device_ms_by_kernel(exact, 4 * n)
        extra = dict(
            blk_lo_exact=lo, kernel_blk_lo_exact=sum(by_exact.values()),
            kernel_blk_lo_exact_by_name={k[:60]: v
                                         for k, v in by_exact.items()},
            n_split_blk_lo_exact=pa.split_count(
                d, pool.dtype, args["tables"].shape[1], lo, block,
                s_ * n_kv, torch.cuda.get_device_properties(
                    0).multi_processor_count),
            kernel_after_exact=sum(device_ms_by_kernel(kernel,
                                                       4 * n).values()))
    return dict(
        slots=s_, p_limit=lens, table_width=args["tables"].shape[1],
        block=block, layers=n, dtype=str(args["q"].dtype)[6:],
        pool_dtype=str(pool.dtype)[6:],
        n_split=pa.split_count(d, pool.dtype, args["tables"].shape[1],
                               0, block, s_ * n_kv,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count),
        kernel_device_ms_by_name={k[:60]: v for k, v in by_kernel.items()},
        device_ms={"kernel": sum(by_kernel.values()),
                   "kernel_one_layer_l2_hot": device_ms_per_call(
                       lambda: pa.paged_attn(**args), 4 * n),
                   "plain": device_ms_per_call(plain,
                                               PAGED_PLAIN_CALLS),
                   "sdpa_alone": sdpa_ms, "bound": bound, **extra},
        query_positions=nq, window=window,
        bound_by=by,
        event_ms={"kernel": cuda_time_ms(kernel, 4 * n),
                  "plain": cuda_time_ms(plain, PAGED_PLAIN_CALLS),
                  "sdpa_alone": sdpa_events_ms,
                  "gather_for_sdpa": gather_ms},
        max_abs_err_vs_plain=err, sdpa_max_abs_diff_vs_kernel=sdpa_err)


#: the few-long-slots table: two slots of 1000 lanes, where a grid of one
#: block a (kv head, slot) would be 24 blocks
LONG_TABLE_LENS = (1000, 1000)


def paged_row(name, t, launches, kernels):
    """A kernels-line row of ``paged_attn`` timed at one step's tables
    (``time_paged_table``'s ``t``)."""
    ms = t["device_ms"]
    return dict(
        name=name, route="cuda",
        source="singa_tpu_torch/csrc/paged_attention.cu",
        replaces=REPLACES[name.removesuffix("_f16")], launches=launches,
        max_abs_err=t["max_abs_err_vs_plain"], ms=ms["kernel"],
        plain_ms=ms["plain"], bound_ms=ms["bound"],
        bound_by=t["bound_by"], library_ms=ms["sdpa_alone"],
        library_call="torch.nn.functional.scaled_dot_product_attention"
                     " on rows gathered from the pool (the gather not "
                     "timed: no one PyTorch call computes paged "
                     "attention)" + ("; int8 pools dequantized first, "
                                     "not timed" if "int8" in name
                                     else ""),
        kernels=kernels)


def paged_ship_row(ship, cfg):
    """Row 5d: ``paged_attn`` timed, and held against its plain version,
    at a ship destination's recorded decode step (``ship``: its tables,
    whose first blocks a shipped image landed in, and the launches of
    the disaggregated run), float32 pools and q: the dtype of that run,
    whose launches the row reports."""
    t = time_paged_table(real_args(ship, cfg, seed=10, dtype=torch.float32))
    log({"phase": "paged_kernels", "ship_table_row_5d":
         dict(t, step=ship["step"])})
    return paged_row("paged_attn_ship", t, ship["launches"],
                     "paged_attn_kernel<float, float> (split) + "
                     "paged_combine_kernel<float, float> over a decode "
                     "replica's tables after KV ships (the float32 "
                     "disaggregated run)")


def phase_paged_kernels(real, real8, cfg, spec, win, fork, ship):
    """``paged_attn`` against its plain version at every edge case in
    float32, bf16 and float16, and on int8 pools with float32, bf16 and
    float16 q (their split counts logged: some take one split of the key
    range, some several), then timed at tables for GPT-2 small's 12
    layers: one decode step of the serve phase (``real``: its tables and
    positions) with bf16 pools, as row 5c with int8 pools and bf16 q,
    with float16 pools (the ``paged_attn_f16`` row; its launches are the
    serve phase's float16 run's) and with int8 pools and float16 q; and
    ``LONG_TABLE_LENS`` with bf16 pools.  The times in the kernels line
    are the serve step's device times (``device_ms_per_call``): the
    wrapper's launch overhead exceeds the kernels' time, so CUDA events
    around back-to-back calls would time the host (logged too, as
    ``event_ms``).  ``real8``: the int8 kernels' launches on the
    ``serve_int8`` main path.  Then timed, and held against the plain
    version, at the ``spec`` phase's verify step (Q = 4; ``spec``: its
    tables, the Q = 4 launches of its bf16 main path and of its float32
    int8 run) with bf16 pools and with int8 pools under float32 q, the
    dtypes those runs launch (the ``paged_attn_spec`` and
    ``paged_attn_spec_int8`` rows), and at the ``longctx`` phase's
    windowed step (``win``) with float32 pools, read from table entry 0
    and, beside it, from the JAX engine's bound (``paged_attn_window``);
    and at the ``fork`` phase's decode step (``fork``: its tables, whose
    prompt blocks several slots name, and the launches of its bf16 main
    path) with bf16 pools (row 5k, ``paged_attn_fork``) and int8 pools
    (logged; the bound reads a shared block once); and at the ``fleet``
    phase's ship destination (``ship``, row 5d: ``paged_ship_row``).
    Returns the kernels line's rows."""
    from singa_tpu_torch.ops import paged_attention as pa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, splits = {}, {}
    for quant, dtype in itertools.product((False, True), PAGED_DTYPES):
        key = ("int8/" if quant else "") + str(dtype)[6:]
        for seed, (name, kw) in enumerate(paged_edge_cases()):
            e = check_paged_case(f"{name}/{key}", dtype, seed, quant, **kw)
            worst[key] = max(worst.get(key, 0.0), e)
            a = paged_inputs(dtype=dtype, seed=seed, quant=quant, **kw)
            s_, n_kv, _, _, d = a["q"].shape
            pool = pa._values(a["pool_k"])
            splits[f"{name}/{key}"] = pa.split_count(
                d, pool.dtype, a["tables"].shape[1], a["blk_lo"],
                pool.shape[2], s_ * n_kv, n_sm)
    if not {1} < set(splits.values()):
        raise AssertionError(f"the edge cases should take both one split "
                             f"and several: {splits}")
    serve = time_paged_table(real["layers"])
    serve8 = time_paged_table(real_args(real, cfg, seed=2, quant=True))
    serve_h = time_paged_table(real_args(real, cfg, seed=3,
                                         dtype=torch.float16))
    serve8_h = time_paged_table(real_args(real, cfg, seed=4, quant=True,
                                          dtype=torch.float16))
    long = time_paged_table(paged_table(LONG_TABLE_LENS, cfg, seed=1))
    spec_t = time_paged_table(real_args(spec, cfg, seed=5, nq=SPEC_K))
    spec8_t = time_paged_table(real_args(spec, cfg, seed=6, quant=True,
                                         dtype=torch.float32, nq=SPEC_K))
    win_t = time_paged_table(real_args(win, cfg, seed=7,
                                       dtype=torch.float32,
                                       window=LONGCTX_WINDOW))
    fork_t = time_paged_table(real_args(fork, cfg, seed=8))
    fork8_t = time_paged_table(real_args(fork, cfg, seed=9, quant=True))
    log({"phase": "paged_kernels",
         "edge_cases": 2 * len(PAGED_DTYPES) * len(paged_edge_cases()),
         "edge_max_abs_err": worst, "edge_n_split": splits,
         "tol": {str(k)[6:]: v for k, v in PAGED_TOL.items()},
         "tol_int8": "PAGED_TOL of q's dtype",
         "serve_table": dict(serve, step=real["step"]),
         "serve_table_int8_row_5c": dict(serve8, step=real["step"]),
         "serve_table_float16": dict(serve_h, step=real["step"]),
         "serve_table_int8_float16_q": dict(serve8_h, step=real["step"]),
         "long_table": long,
         "spec_verify_table": dict(spec_t, step=spec["step"]),
         "spec_verify_table_int8": dict(spec8_t, step=spec["step"]),
         "windowed_table": dict(win_t, step=win["step"]),
         "fork_table_row_5k": dict(fork_t, step=fork["step"]),
         "fork_table_int8": dict(fork8_t, step=fork["step"])})

    row = paged_row
    return [row("paged_attn", serve, real["launches"],
                "paged_attn_kernel<T, T> (split) + paged_combine_kernel<T, "
                "T>, T float or bf16"),
            row("paged_attn_int8", serve8, real8["launches"],
                "paged_attn_kernel<T, int8> (split) + "
                "paged_combine_kernel<T, int8>, T float or bf16 (the int8 "
                "branch)"),
            row("paged_attn_f16", serve_h, real["launches_f16"],
                "paged_attn_kernel<__half, __half> (split) + "
                "paged_combine_kernel<__half, __half>"),
            row("paged_attn_spec", spec_t, spec["launches"],
                "paged_attn_kernel<bf16, bf16> (split) + paged_combine_kernel"
                "<bf16, bf16> at Q = 4 under a tril cur_mask (the "
                "speculative verify)"),
            row("paged_attn_spec_int8", spec8_t, spec["launches8"],
                "paged_attn_kernel<float, int8> (split) + "
                "paged_combine_kernel<float, int8> at Q = 4 (the speculative "
                "verify on int8 pools, float32 q, as the int8 run launches "
                "it)"),
            row("paged_attn_window", win_t, win["launches"],
                "paged_attn_kernel<float, float> (split) + "
                "paged_combine_kernel<float, float> with the window 256 "
                "over tables of dropped blocks"),
            row("paged_attn_fork", fork_t, fork["launches"],
                "paged_attn_kernel<bf16, bf16> (split) + paged_combine_kernel"
                "<bf16, bf16> over fork groups' tables, several slots naming "
                "the same prompt blocks"),
            paged_ship_row(ship, cfg)]


# ------------------------------------------------------------------ serve

SERVE_REQUESTS = 24
SERVE_ENGINE = dict(max_slots=8, block_size=32, num_blocks=256)
# per-step logits of the bf16 engine, paged kernel against the gather
# oracle on the same pool: the two attention outputs differ in float32
# summation order only, so a few of them round to the other bf16
# neighbour (2^-8 of themselves); 12 layers of bf16 activations carry
# that to logits of magnitude O(1) (GPT-2 small, random weights, std
# 0.02).  Streams are compared up to the first step whose top-2 margin
# (of the logits a token is chosen from) is below this.
SERVE_BF16_LOGITS_ATOL = 0.05


def serve_traffic(seed=0, n=SERVE_REQUESTS, vocab=50257):
    """The serve phase's requests: prompts of 16-512 random tokens,
    ``max_new_tokens`` 32-128, alternately greedy and at temperature 0.9,
    each with its own seed."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(16, 513))
                 .astype(np.int32),
                 max_new=int(rng.randint(32, 129)),
                 temperature=0.0 if i % 2 == 0 else 0.9,
                 seed=int(rng.randint(0, 2 ** 31 - 1))) for i in range(n)]


def drain_counting_graphs(eng, max_steps=5000, per_step=None):
    """Drive ``eng`` until it drains; raise unless the serve census
    (``jit_cache_size``) only grows by the engine's own captures, at most
    one per decode-width bucket, and stays flat once every width in use
    has been captured; ``per_step(eng)`` runs after every step.  Returns
    ``{"buckets", "census_at_end", "census_changes": [(step, census),
    ...]}``."""
    from singa_tpu_torch.serve import jit_cache_size

    buckets, w = set(), eng.max_slots
    while w >= 1:
        buckets.add(w)
        w //= 2
    base = jit_cache_size() - len(eng._steps)
    changes, last = [], None
    for step in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        if per_step is not None:
            per_step(eng)
        census = jit_cache_size() - base
        if census != len(eng._steps) or census > len(buckets) \
                or not set(eng._steps) <= buckets:
            raise AssertionError(f"serve census {census} at step {step}: "
                                 f"captured widths {sorted(eng._steps)}")
        if census != last:
            changes.append((step, census))
            last = census
    else:
        raise AssertionError(f"engine did not drain in {max_steps} steps")
    return {"buckets": sorted(buckets), "census_at_end": last,
            "census_changes": changes}


def run_engine(model, traffic, kernel, dtype=None, trace=False,
               wrap=None, capture=True, cache_dtype=None, per_step=None,
               on_engine=None, paged_kw=None, **serve_kw):
    """Submit ``traffic`` at once to ``model.serve`` with the serve
    phase's engine (its decode steps captured unless ``capture`` is
    False; ``kernel`` None: the slot arena, ``model.serve`` without
    ``paged=``, at ``max_slots`` and ``max_len`` 1024), drain it, and
    check what a drain must leave: every request completed by its length,
    no rejection, no block in use, the serve census flat
    (``drain_counting_graphs``; the slot arena: exactly one graph).
    ``wrap(engine)`` may replace the engine's executor, ``on_engine(engine)``
    sees it before the first submit, ``per_step(engine)`` after every
    step; ``paged_kw`` adds ``PagedConfig`` arguments and ``serve_kw``
    engine arguments (``draft_model``, ``spec_k``).  Returns ``(streams,
    engine stats snapshot with the census under "graphs", seconds,
    decode-step seconds (speculative steps' on a speculative
    engine))``."""
    from singa_tpu_torch.observe import trace as tr
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    paged = None if kernel is None else PagedConfig(
        block_size=c["block_size"], num_blocks=c["num_blocks"],
        kernel=kernel, **(paged_kw or {}))
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype, paged=paged,
                      capture=capture, cache_dtype=cache_dtype, **serve_kw)
    if wrap is not None:
        eng._x = wrap(eng)
    if on_engine is not None:
        on_engine(eng)
    if trace:
        tr.drain()
        tr.enable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["max_new"],
        temperature=w["temperature"], seed=w["seed"], request_id=f"r{i}"))
        for i, w in enumerate(traffic)]
    graphs = drain_counting_graphs(eng, per_step=per_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    decode_s = None
    if trace:
        tr.disable()
        spans = tr.drain()
        decode_s = sum(e["dur"] for e in spans
                       if e["name"] in ("serve/decode_step",
                                        "serve/spec_step"))
        prefill_s = sum(e["dur"] for e in spans
                        if e["name"] == "serve/prefill")
    results = [h.result() for h in hs]
    snap = dict(eng.stats.snapshot(), graphs=graphs)
    if trace:
        snap["prefill_seconds"] = prefill_s
    if kernel is None:
        if capture and graphs["census_at_end"] != 1:
            raise AssertionError(f"the slot arena holds {graphs} graphs, "
                                 f"not one")
    elif eng.paged_arena.blocks_used != 0:
        raise AssertionError(f"{eng.paged_arena.blocks_used} blocks in use "
                             f"after the drain")
    eng.check_block_accounting()
    req = snap["requests"]
    if (req["completed"] != len(traffic) or req["rejected_deadline"]
            or req["rejected_queue_full"]
            or any(r.finish_reason != "length" for r in results)):
        raise AssertionError(f"not every request completed cleanly: {req}")
    streams = [r.tokens for r in results]
    for w, s in zip(traffic, streams):
        if len(s) != len(w["prompt"]) + w["max_new"] \
                or s.min() < 0 or s.max() >= model.cfg.vocab_size:
            raise AssertionError(f"bad stream of length {len(s)}")
    eng.close()
    return streams, snap, seconds, decode_s


def admission_key(seed):
    """(1, 2) ``uint32`` key a serve engine samples a request's first
    token with: ``split(split(PRNGKey(seed), 1)[0])[0]``."""
    from singa_tpu_torch.ops import prng

    return prng.split(prng.split(prng.PRNGKey(seed), 1)[0])[:1]


def offline_streams(model, traffic, cache_dtype=None, top_k=0):
    """Offline ``generate`` of the traffic, float32: the greedy requests
    in one batch, the sampled ones in another with their seeds, each
    batch to its longest ``max_new_tokens`` and then cut to each
    request's (a stream's prefix does not depend on its length);
    ``cache_dtype="int8"``: on int8 caches; ``top_k``: the engines'
    filter."""
    out = [None] * len(traffic)
    for greedy in (True, False):
        idx = [i for i, w in enumerate(traffic)
               if (w["temperature"] <= 0) == greedy]
        if not idx:
            continue
        n_new = max(traffic[i]["max_new"] for i in idx)
        rows = model.generate(
            [traffic[i]["prompt"] for i in idx], max_new_tokens=n_new,
            temperature=0.0 if greedy else traffic[idx[0]]["temperature"],
            seed=[traffic[i]["seed"] for i in idx], cache_dtype=cache_dtype,
            top_k=top_k)
        for i, r in zip(idx, rows):
            out[i] = r[:len(traffic[i]["prompt"]) + traffic[i]["max_new"]]
    return out


class _LogitsProbe:
    """Executor for the bf16 logits check, on an engine that runs its
    decode steps eagerly (``capture=False``: the probe reads the device
    on the host): each decode step runs the gather oracle on a copy of
    the pools, then the paged kernel on the pools themselves, and records,
    per live request, the largest logit difference and the top-2 margin of
    the oracle's logits as the sampler sees them (tempered plus the
    request's noise when sampled).  Keeps one step's tables and positions
    (the step with the most live lanes) as the paged kernel's real serve
    shapes."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = eng._x
        self.max_err = 0.0
        self.first_low = {}     # request id -> first low-margin token index
        self.real = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill_batch(self, params, ids):
        return self.inner.prefill_batch(params, ids)

    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        from singa_tpu_torch.models import gpt2_decode as gd
        from singa_tpu_torch.ops import prng

        eng = self.eng
        lanes = [i for i, s in enumerate(eng._slots) if s is not None]
        n = len(lanes)
        pos = inp["pos"][:n].cpu().numpy()
        want = self.inner.paged_decode_step(
            params, pool_k.clone(), pool_v.clone(), inp, block,
            kernel="gather", n_rb=int(pos.max()) // block + 1)
        if self.real is None or n > len(self.real["p_limit"]) or (
                n == len(self.real["p_limit"])
                and pos.sum() > sum(self.real["p_limit"])):
            self.real = dict(tables=inp["tables"][:n].cpu().numpy(),
                             p_limit=pos.astype(np.int32).tolist(),
                             step=eng.step_count)
        got = self.inner.paged_decode_step(params, pool_k, pool_v, inp,
                                           block)
        g, w = got[:n].float(), want[:n].float()
        self.max_err = max(self.max_err, (g - w).abs().max().item())
        noise = prng.gumbel_t(inp["keys"][:n, 0], w.shape[-1])
        for r, i in enumerate(lanes):
            row = w[r]
            if eng._temps[i] > 0:
                row = gd._filter_logits(row[None], float(eng._temps[i]),
                                        eng._top_p, eng._top_k)[0] + noise[r]
            top2 = torch.topk(row, 2).values
            rid = eng._slots[i].handle.request.request_id
            if (top2[0] - top2[1]).item() < SERVE_BF16_LOGITS_ATOL \
                    and rid not in self.first_low:
                self.first_low[rid] = len(eng._slots[i].emitted)
        return got


def phase_serve(seed=0):
    """GPT-2 small (124M, 12 layers, n_positions 1024, random weights from
    a seed) served by the paged engine: 24 requests at once, float32 and
    bf16, then the pressured engine and the tiny one (module docstring).
    Returns the model and, for the kernel phase, the paged kernel's
    launches on the timed bf16 run and the real tables it times."""
    from singa_tpu_torch import amp, device
    from singa_tpu_torch.ops import paged_attention as pa

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    amp.enable(False)
    dev = device.create_cuda_gpu()
    model = gpt2_small(seed)
    cfg = model.cfg
    traffic = serve_traffic(seed, vocab=cfg.vocab_size)
    mark("model")

    # float32: captured == eager == gather == offline generate, launches
    pa.paged_attn.launches = 0
    block32, snap32, sec32, _ = run_engine(model, traffic, "block")
    launches32 = pa.paged_attn.launches
    mark("float32_captured")
    steps32 = snap32["throughput"]["decode_steps"]
    eager32, _, eager_sec32, _ = run_engine(model, traffic, "block",
                                            capture=False)
    mark("float32_eager")
    gather32, _, _, _ = run_engine(model, traffic, "gather")
    mark("float32_gather")
    offline = offline_streams(model, traffic)
    mark("float32_generate")
    for i, (a, e, b, c) in enumerate(zip(block32, eager32, gather32,
                                         offline)):
        if not np.array_equal(a, e):
            raise AssertionError(f"float32 request {i}: the captured "
                                 f"engine's stream differs from the eager "
                                 f"engine's")
        if not np.array_equal(a, b):
            raise AssertionError(f"float32 request {i}: the paged kernel's "
                                 f"stream differs from the gather oracle's")
        if not np.array_equal(a, c):
            raise AssertionError(f"float32 request {i}: the engine's stream "
                                 f"differs from offline generate")
    if launches32 != cfg.n_layer * steps32:
        raise AssertionError(f"paged_attn launched {launches32} times over "
                             f"{steps32} decode steps, expected "
                             f"{cfg.n_layer} a step")
    pressured = serve_pressured(model, pressure_traffic(
        seed, vocab=cfg.vocab_size))
    mark("float32_pressured")
    tiny = serve_tiny(dev, seed)
    mark("float32_tiny_d16")

    # bf16: the timed main path (captured) against the same traffic with
    # eager steps, profiled runs of both, the logits check
    bf = torch.bfloat16
    pa.paged_attn.launches = 0
    block16, snap16, sec16, decode_s = run_engine(model, traffic, "block",
                                                  dtype=bf, trace=True)
    launches16 = pa.paged_attn.launches
    mark("bf16_captured")
    steps16 = snap16["throughput"]["decode_steps"]
    if launches16 != cfg.n_layer * steps16:
        raise AssertionError(f"bf16: paged_attn launched {launches16} times "
                             f"over {steps16} decode steps")
    eager16, esnap16, esec16, edecode_s = run_engine(
        model, traffic, "block", dtype=bf, trace=True, capture=False)
    mark("bf16_eager")
    profile = profile_serve(model, traffic, bf)
    profile_eager = profile_serve(model, traffic, bf, capture=False)
    host_split = serve_host_split(model, traffic, bf)
    mark("bf16_profiles")
    probes = []
    probed, _, _, _ = run_engine(
        model, traffic, "block", dtype=bf, capture=False,
        wrap=lambda e: probes.append(_LogitsProbe(e)) or probes[-1])
    probe = probes[0]
    mark("bf16_logits_probe")
    if probe.max_err > SERVE_BF16_LOGITS_ATOL:
        raise AssertionError(f"bf16 logits, paged kernel vs gather oracle: "
                             f"{probe.max_err} > {SERVE_BF16_LOGITS_ATOL}")
    gather16, _, _, _ = run_engine(model, traffic, "gather", dtype=bf)
    mark("bf16_gather")
    # float16: the same traffic captured, paged_attn on float16 pools and
    # q (the kernels line's paged_attn_f16 row)
    pa.paged_attn.launches = 0
    _, snap_h, sec_h, _ = run_engine(model, traffic, "block",
                                     dtype=torch.float16)
    launches_h = pa.paged_attn.launches
    mark("float16_captured")
    steps_h = snap_h["throughput"]["decode_steps"]
    if launches_h != cfg.n_layer * steps_h:
        raise AssertionError(f"float16: paged_attn launched {launches_h} "
                             f"times over {steps_h} decode steps")
    compared = {}
    for i, (w, a, e, b, c) in enumerate(zip(traffic, block16, eager16,
                                            probed, gather16)):
        plen = len(w["prompt"])
        if not (np.array_equal(a, b) and np.array_equal(a, e)):
            raise AssertionError(f"bf16 request {i}: the captured and eager "
                                 f"paged engines gave different streams")
        upto = probe.first_low.get(f"r{i}", w["max_new"])
        compared[i] = upto
        if not np.array_equal(a[:plen + upto], c[:plen + upto]):
            raise AssertionError(
                f"bf16 request {i}: paged and gather streams differ before "
                f"token {upto}, the first whose top-2 margin is under "
                f"{SERVE_BF16_LOGITS_ATOL}")
    real = probe.real

    log({"phase": "serve", "model": "gpt2-small",
         "params": sum(p.numel() for p in model.parameters()),
         "engine": SERVE_ENGINE, "requests": len(traffic),
         "prompt_lens": [len(w["prompt"]) for w in traffic],
         "max_new_tokens": [w["max_new"] for w in traffic],
         "float32": {"decode_steps": steps32, "paged_attn_launches":
                     launches32, "seconds": sec32,
                     "eager_seconds": eager_sec32,
                     "graphs": snap32["graphs"],
                     "streams_equal_eager_gather_and_generate": True},
         "float32_pressured": dict(
             PRESSURE_ENGINE, requests=12, paged=pressured,
             streams_equal_generate=True),
         "float32_tiny": dict(tiny, streams_equal_generate=True),
         "bf16": {"decode_steps": steps16, "paged_attn_launches": launches16,
                  **serve_timing(snap16, sec16, decode_s, len(traffic)),
                  "eager": serve_timing(esnap16, esec16, edecode_s,
                                        len(traffic)),
                  "graphs": snap16["graphs"],
                  "streams_equal_eager": True,
                  "logits_max_abs_diff_kernel_vs_gather": probe.max_err,
                  "logits_atol": SERVE_BF16_LOGITS_ATOL,
                  "streams_compared_up_to_token": compared,
                  "low_margin_requests": len(probe.first_low)},
         "float16": {"decode_steps": steps_h,
                     "paged_attn_launches": launches_h, "seconds": sec_h,
                     "graphs": snap_h["graphs"]},
         "profile_bf16_run": profile,
         "profile_bf16_eager_run": profile_eager,
         "host_split_bf16_run": host_split,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
         "nvidia_smi": nvidia_smi()})
    return model, dict(launches=launches16, launches_f16=launches_h,
                       step=real["step"],
                       tables=real["tables"], p_limit=real["p_limit"],
                       layers=real_args(real, model.cfg, seed),
                       traffic=traffic, offline=offline,
                       bf16_streams=block16, first_low=probe.first_low,
                       bf16=dict(serve_timing(snap16, sec16, decode_s,
                                              len(traffic)),
                                 busy_share=profile["device_busy_share"],
                                 host_split=host_split))


def serve_timing(snap, sec, dec_s, n_requests):
    """The timed figures of one drained engine: wall seconds, TTFT and
    TPOT medians, tokens/s over the drain and decode tokens/s over the
    decode steps' traced seconds (every token but each request's first,
    which its prefill samples)."""
    lat = snap["latency"]
    decode_tokens = snap["throughput"]["tokens_out"] - n_requests
    return {"seconds": sec, "ttft_median_s": lat["ttft"]["p50"],
            "tpot_median_s": lat["tpot"]["p50"],
            "tokens_per_s": snap["throughput"]["tokens_per_s"],
            "decode_tokens_per_s": decode_tokens / dec_s,
            "decode_step_seconds": dec_s,
            "prefill_seconds": snap["prefill_seconds"]}


def _same_streams(what, got, want):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: {what}")


def phase_serve_int8(model, real):
    """The serve phase's model and traffic on int8 pools
    (``cache_dtype="int8"``, ``PagedConfig(block_size=32,
    num_blocks=256)``).  float32: the captured engine's streams equal the
    int8 gather oracle's and offline int8 ``generate``'s, the int8 kernel
    launches 12 times a decode step, no block is left; the pressured
    priority engine on int8 pools preempts, swaps (the scales with the
    values) and matches offline int8 ``generate``.  bf16 (the main path
    of the int8 kernels' launches: every count set to 0 just before, read
    just after): TTFT/TPOT medians, decode tokens/s and the busy share of
    a profiled window, beside the serve phase's bf16 pools.  Returns the
    int8 kernels' launches and the offline int8 streams."""
    from singa_tpu_torch.ops import paged_attention as pa

    marks = [("start", time.perf_counter())]
    cfg, traffic = model.cfg, real["traffic"]
    pa.paged_attn.launches = pa.paged_attn.int8_launches = 0
    block8, snap8, sec8, _ = run_engine(model, traffic, "block",
                                        cache_dtype="int8")
    launches8, all8 = pa.paged_attn.int8_launches, pa.paged_attn.launches
    steps8 = snap8["throughput"]["decode_steps"]
    if not launches8 == all8 == cfg.n_layer * steps8:
        raise AssertionError(f"int8: paged_attn launched {all8} times, the "
                             f"int8 kernel {launches8}, over {steps8} decode "
                             f"steps")
    if not snap8["paged"]["quant"]:
        raise AssertionError("the int8 engine's arena is not quantized")
    marks.append(("float32_captured", time.perf_counter()))
    gather8, _, _, _ = run_engine(model, traffic, "gather",
                                  cache_dtype="int8")
    offline8 = offline_streams(model, traffic, "int8")
    marks.append(("float32_gather_and_generate", time.perf_counter()))
    _same_streams("the int8 kernel's stream differs from the int8 gather "
                  "oracle's", block8, gather8)
    _same_streams("the int8 engine's stream differs from offline int8 "
                  "generate", block8, offline8)
    differ = sum(not np.array_equal(a, b)
                 for a, b in zip(block8, real["offline"]))
    pressured = serve_pressured(model, pressure_traffic(
        0, vocab=cfg.vocab_size), cache_dtype="int8")
    marks.append(("float32_pressured", time.perf_counter()))

    bf = torch.bfloat16
    pa.paged_attn.launches = pa.paged_attn.int8_launches = 0
    b16, snap16, sec16, decode_s = run_engine(
        model, traffic, "block", dtype=bf, trace=True, cache_dtype="int8")
    launches16 = pa.paged_attn.int8_launches
    steps16 = snap16["throughput"]["decode_steps"]
    if launches16 != cfg.n_layer * steps16:
        raise AssertionError(f"bf16 int8: the int8 kernel launched "
                             f"{launches16} times over {steps16} steps")
    profile = profile_serve(model, traffic, bf, cache_dtype="int8")
    marks.append(("bf16_timed_and_profiled", time.perf_counter()))
    log({"phase": "serve_int8", "model": "gpt2-small",
         "engine": dict(SERVE_ENGINE, cache_dtype="int8"),
         "requests": len(traffic),
         "float32": {"decode_steps": steps8, "int8_launches": launches8,
                     "seconds": sec8, "graphs": snap8["graphs"],
                     "streams_equal_gather_and_int8_generate": True,
                     "streams_differing_from_float_pools": differ},
         "float32_pressured": dict(PRESSURE_ENGINE, requests=12,
                                   paged=pressured,
                                   streams_equal_int8_generate=True),
         "bf16": {"decode_steps": steps16, "int8_launches": launches16,
                  **serve_timing(snap16, sec16, decode_s, len(traffic)),
                  "graphs": snap16["graphs"],
                  "busy_share": profile["device_busy_share"]},
         "bf16_pools_same_run": real["bf16"],
         "profile_bf16_run": profile,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return dict(launches=launches16, offline=offline8)


def phase_serve_slots(model, real, real8):
    """The serve phase's traffic through ``model.serve()`` without
    ``paged=`` (the slot arena: ``max_slots`` 8, ``max_len`` 1024, every
    slot a dense row), dense and int8.  float32: streams equal offline
    ``generate``'s at the same ``cache_dtype`` (the serve phases' own
    offline streams), exactly one captured graph, the census flat.
    bf16: TTFT/TPOT medians, decode tokens/s and the busy share of a
    profiled window."""
    marks = [("start", time.perf_counter())]
    traffic = real["traffic"]
    out = {}
    for cd, want in ((None, real["offline"]), ("int8", real8["offline"])):
        name = cd or "dense"
        streams, snap, sec, _ = run_engine(model, traffic, None,
                                           cache_dtype=cd)
        _same_streams(f"the slot arena's ({name}) stream differs from "
                      f"offline generate", streams, want)
        marks.append((f"float32_{name}", time.perf_counter()))
        b16, snap16, sec16, decode_s = run_engine(
            model, traffic, None, dtype=torch.bfloat16, trace=True,
            cache_dtype=cd)
        profile = profile_serve(model, traffic, torch.bfloat16,
                                cache_dtype=cd, slots=True)
        marks.append((f"bf16_{name}", time.perf_counter()))
        out[name] = {
            "float32": {"decode_steps": snap["throughput"]["decode_steps"],
                        "seconds": sec, "graphs": snap["graphs"],
                        "streams_equal_generate": True},
            "bf16": {"decode_steps": snap16["throughput"]["decode_steps"],
                     **serve_timing(snap16, sec16, decode_s, len(traffic)),
                     "busy_share": profile["device_busy_share"]},
            "profile_bf16_run": profile}
    log({"phase": "serve_slots", "model": "gpt2-small",
         "engine": dict(max_slots=SERVE_ENGINE["max_slots"], max_len=1024,
                        paged=None),
         "requests": len(traffic), **out,
         "bf16_paged_pools_same_run": real["bf16"],
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})


#: the pressured engine: a pool of 2048 lanes for 8 slots of up to 532
PRESSURE_ENGINE = dict(max_slots=8, block_size=32, num_blocks=64)


def pressure_traffic(seed=0, n=12, vocab=50257):
    """Prompts of 200-500 random tokens, 32 new tokens each, alternately
    greedy and at temperature 0.9; the first half at priority 0, the
    rest at 1 and 2 in turn."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(200, 501))
                 .astype(np.int32), max_new=32,
                 temperature=0.0 if i % 2 == 0 else 0.9,
                 seed=int(rng.randint(0, 2 ** 31 - 1)),
                 priority=0 if i < n // 2 else 1 + i % 2)
            for i in range(n)]


def serve_host_split(model, traffic, dtype=torch.bfloat16):
    """Where the host time of the serve phase's captured bf16 run goes:
    the same engine and traffic drained again with stepprof on, which
    fences every ``engine.step()`` into host segments and the device
    windows of its dispatches (each dispatch waited for, so nothing
    overlaps), and two timers inside it: the numpy split of the host
    key chain each decode step (``_step_keys``) and each admission's
    first-token sample (``_sample`` called from ``_admit``: the host
    seconds to its return, and its device span by CUDA events; greedy
    admissions draw nothing and are counted apart).  ``rest_host_s`` is
    stepprof's host total less the two."""
    from singa_tpu_torch.observe import stepprof
    from singa_tpu_torch.serve import engine as engine_mod

    acc = dict(key_split_s=0.0, key_splits=0, admit_sample_host_s=0.0,
               admit_sample_device_ms=0.0, sampled_admissions=0,
               greedy_admissions=0)
    events = []
    inner_sample = engine_mod._sample
    in_admit = [False]

    def sample(logits, temps, keys, *a, **kw):
        if not in_admit[0]:
            return inner_sample(logits, temps, keys, *a, **kw)
        if keys is None:
            acc["greedy_admissions"] += 1
            return inner_sample(logits, temps, keys, *a, **kw)
        acc["sampled_admissions"] += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner_sample(logits, temps, keys, *a, **kw)
        end.record()
        acc["admit_sample_host_s"] += time.perf_counter() - t0
        events.append((start, end))
        return out

    def on_engine(eng):
        step_keys, admit = eng._step_keys, eng._admit

        def timed_keys(*a):
            t0 = time.perf_counter()
            out = step_keys(*a)
            acc["key_split_s"] += time.perf_counter() - t0
            acc["key_splits"] += 1
            return out

        def flagged_admit(*a, **kw):
            in_admit[0] = True
            try:
                return admit(*a, **kw)
            finally:
                in_admit[0] = False

        eng._step_keys, eng._admit = timed_keys, flagged_admit

    engine_mod._sample = sample
    prof = stepprof.enable()
    try:
        run_engine(model, traffic, "block", dtype=dtype, on_engine=on_engine)
        sec = prof.section()
    finally:
        stepprof.disable()
        engine_mod._sample = inner_sample
    torch.cuda.synchronize()
    acc["admit_sample_device_ms"] = sum(a.elapsed_time(b)
                                        for a, b in events)
    (eng_sec,) = sec["engines"].values()
    wall = eng_sec["wall_s_total"]
    host = eng_sec["host_s_total"]
    return dict(
        acc, steps=eng_sec["steps"], wall_s=wall,
        device_s=eng_sec["device_s_total"], host_s=host,
        segments_s={k: v * wall for k, v in eng_sec["fractions"].items()},
        rest_host_s=host - acc["key_split_s"] - acc["admit_sample_host_s"],
        key_split_ms_each=1e3 * acc["key_split_s"] / max(acc["key_splits"],
                                                         1))


def serve_pressured(model, traffic, engine=PRESSURE_ENGINE, lead=4,
                    cache_dtype=None):
    """A priority engine whose pool cannot hold every slot's KV: the
    priority-0 requests of ``traffic`` are submitted first and decode
    ``lead`` steps, then the rest arrive and preempt them (their KV to
    host memory), and every request is resumed and finishes.  Holds every
    stream against offline ``generate``, and checks that preemption and
    resume happened and that no block is left after the drain; returns
    the arena's snapshot.  ``cache_dtype="int8"``: int8 pools, whose
    swaps carry the scales, against offline int8 ``generate``."""
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    eng = model.serve(max_slots=engine["max_slots"], scheduler="priority",
                      paged=PagedConfig(block_size=engine["block_size"],
                                        num_blocks=engine["num_blocks"]),
                      cache_dtype=cache_dtype)

    def submit(w):
        return eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            priority=w["priority"]))

    hs = {i: submit(w) for i, w in enumerate(traffic) if w["priority"] == 0}
    for _ in range(lead):
        eng.step()
    hs.update({i: submit(w) for i, w in enumerate(traffic)
               if w["priority"] != 0})
    hs = [hs[i] for i in range(len(traffic))]
    graphs = drain_counting_graphs(eng)
    snap = dict(eng.stats.snapshot()["paged"], graphs=graphs)
    eng.check_block_accounting()
    eng.close()
    if snap["preemptions"] == 0 or snap["swap_in"] == 0:
        raise AssertionError(f"the pressured engine never preempted: {snap}")
    if snap["blocks_used"] != 0:
        raise AssertionError(f"{snap['blocks_used']} blocks in use after "
                             f"the pressured drain")
    for i, (h, want) in enumerate(zip(hs, offline_streams(
            model, traffic, cache_dtype))):
        if not np.array_equal(h.result().tokens, want):
            raise AssertionError(f"pressured request {i}: the resumed "
                                 f"stream differs from offline generate")
    return snap


def serve_tiny(dev, seed=0):
    """``GPT2Config.tiny`` (D = 16) served on the card, float32, greedy:
    streams equal offline ``generate`` and ``paged_attn`` launches once a
    layer a decode step."""
    from singa_tpu_torch import tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import paged_attention as pa
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), dev)],
              is_train=False)
    rng = np.random.RandomState(seed)
    work = [(rng.randint(0, 256, rng.randint(3, 60)).astype(np.int32),
             int(rng.randint(2, 40))) for _ in range(6)]
    eng = m.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                 num_blocks=64))
    before = pa.paged_attn.launches
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n))
          for p, n in work]
    eng.run_until_complete(max_steps=500)
    steps = eng.stats.decode_steps
    launches = pa.paged_attn.launches - before
    if launches != m.cfg.n_layer * steps:
        raise AssertionError(f"tiny engine: paged_attn launched {launches} "
                             f"times over {steps} decode steps")
    for i, (h, (p, n)) in enumerate(zip(hs, work)):
        if not np.array_equal(h.result().tokens,
                              m.generate(p, max_new_tokens=n,
                                         temperature=0.0)):
            raise AssertionError(f"tiny engine request {i}: stream differs "
                                 f"from offline generate")
    eng.close()
    return dict(head_dim=m.cfg.n_embd // m.cfg.n_head, requests=len(work),
                decode_steps=steps, paged_attn_launches=launches)


def profile_serve(model, traffic, dtype, warm=40, steps=20, capture=True,
                  cache_dtype=None, slots=False):
    """Device time by kernel group and the device's busy share over
    ``steps`` engine steps of the traffic after ``warm`` steps (the eight
    slots full, decoding), from torch.profiler, with captured or eager
    decode steps (``slots``: the slot arena's engine; ``cache_dtype``:
    int8 KV); then closes the engine undrained (the timed runs hold the
    drain)."""
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    paged = None if slots else PagedConfig(block_size=c["block_size"],
                                           num_blocks=c["num_blocks"])
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype, paged=paged,
                      capture=capture, cache_dtype=cache_dtype)
    for w in traffic:
        eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"]))
    for _ in range(warm):
        eng.step()
    live = eng.live_slots
    out = profile_steps(lambda _x, _y: eng.step(), None, None, steps=steps,
                        groups=SERVE_GROUPS)
    if capture:
        # one replay of the full-width step alone, by CUDA events: the
        # graph's device span, its kernels and the gaps between them
        out["replay_ms_width_8"] = cuda_time_ms(eng._steps[c["max_slots"]],
                                                20)
    eng.close(force=True)
    return dict(out, warm_steps=warm, live_slots=live)


SERVE_GROUPS = (
    ("paged_attn", re.compile(r"paged_(attn|combine)_kernel<")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
)


# ------------------------------------------------------------ prefix

#: the prefix phase's engine: GPT-2 small in bf16 on the serve phase's
#: paged arena, with the radix prefix cache on its blocks
PREFIX_ENGINE = dict(max_slots=8, block_size=32, num_blocks=256)
#: its traffic: PREFIX_REQUESTS greedy requests sharing a system prompt
#: of PREFIX_SYSTEM tokens, each with its own suffix of 32-96 tokens and
#: PREFIX_NEW new tokens; PREFIX_SESSIONS conversations of
#: PREFIX_TURNS turns (pin_session, each turn the whole history and
#: 16-32 new user tokens)
PREFIX_REQUESTS = 24
PREFIX_SYSTEM = 512
PREFIX_NEW = 64
PREFIX_SESSIONS = 4
PREFIX_TURNS = 3
#: the pressured run's pool: small enough that the tree must evict
PREFIX_PRESSURE_BLOCKS = 64
#: the shared-prompt batch's hit share must exceed this
PREFIX_MIN_HIT_SHARE = 0.8


def prefix_traffic(seed=0, vocab=50257):
    """The system prompt, the 24 prompts of the shared-prompt batch, a
    primer (the system prompt and a suffix of its own, which fills the
    tree before the batch) and the sessions' first prompts."""
    rng = np.random.RandomState(seed + 17)
    system = rng.randint(0, vocab, PREFIX_SYSTEM).astype(np.int32)

    def suffixed(lo=32, hi=97):
        return np.concatenate([system, rng.randint(
            0, vocab, rng.randint(lo, hi)).astype(np.int32)])

    primer = suffixed()
    prompts = [suffixed() for _ in range(PREFIX_REQUESTS)]
    sessions = [suffixed() for _ in range(PREFIX_SESSIONS)]
    users = [[rng.randint(0, vocab, rng.randint(16, 33)).astype(np.int32)
              for _ in range(PREFIX_TURNS - 1)]
             for _ in range(PREFIX_SESSIONS)]
    return dict(system=system, primer=primer, prompts=prompts,
                sessions=sessions, users=users)


class _MarginProbe:
    """Executor of the cache-less reference engine (``capture=False``: it
    reads the device on the host): records, per request, the index of
    the first token whose logits' top-2 margin is under
    ``SERVE_BF16_LOGITS_ATOL``, up to which bf16 streams must agree (the
    first token's margins are keyed by prompt; greedy traffic)."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = eng._x
        self.first_low = {}     # request id -> first low-margin token index
        self.prompt_margin = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @staticmethod
    def _margins(logits):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).tolist()

    def prefill_batch(self, params, ids):
        logits, kc, vc = self.inner.prefill_batch(params, ids)
        for row, m in zip(ids.cpu().numpy(), self._margins(logits)):
            self.prompt_margin[row.astype(np.int32).tobytes()] = m
        return logits, kc, vc

    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        got = self.inner.paged_decode_step(params, pool_k, pool_v, inp,
                                           block, kernel, n_rb)
        eng = self.eng
        lanes = [i for i, s in enumerate(eng._slots) if s is not None]
        for i, m in zip(lanes, self._margins(got[:len(lanes)])):
            slot = eng._slots[i]
            if m < SERVE_BF16_LOGITS_ATOL:
                self.first_low.setdefault(slot.handle.request.request_id,
                                          len(slot.emitted))
        return got

    def upto(self, rid, prompt, n_new):
        """Tokens of request ``rid`` a bf16 stream must match."""
        if self.prompt_margin[np.asarray(prompt, np.int32).tobytes()] < \
                SERVE_BF16_LOGITS_ATOL:
            return 0
        return self.first_low.get(rid, n_new)


def prefix_engine(model, num_blocks=None, cache=True, capture=True,
                  dtype=torch.bfloat16):
    """``model.serve`` on the prefix phase's paged arena (bf16 unless
    ``dtype``), with the cache (its blocks the arena's) or without."""
    from singa_tpu_torch.serve import PagedConfig, PrefixCacheConfig

    c = PREFIX_ENGINE
    n = num_blocks or c["num_blocks"]
    return model.serve(
        max_slots=c["max_slots"], dtype=dtype, capture=capture,
        paged=PagedConfig(block_size=c["block_size"], num_blocks=n),
        prefix_cache=(PrefixCacheConfig(block_size=c["block_size"],
                                        num_blocks=n) if cache else None))


def prefix_drain(eng, requests, census=None, max_steps=5000):
    """Submit ``requests`` (``(id, prompt, n_new, pin)``) at once and step
    ``eng`` until it drains, checking ``used == cached +
    live_referenced`` after every step; with ``census`` (the serve
    census to hold) no step may prepare a new decode graph.  Returns
    ``(results by id, decode steps, lane-steps whose table held shared
    cached blocks, paged_attn launches)``."""
    from singa_tpu_torch.ops import paged_attention as pa
    from singa_tpu_torch.serve import GenerationRequest, jit_cache_size

    hs = {rid: eng.submit(GenerationRequest(
        p, max_new_tokens=n, pin_session=pin, request_id=rid))
        for rid, p, n, pin in requests}
    steps = shared = 0
    launches0 = pa.paged_attn.launches
    for _ in range(max_steps):
        if not eng.pending:
            break
        shared += sum(s.n_shared > 0 for s in eng._slots if s is not None)
        eng.step()
        steps += 1
        eng.check_block_accounting()
        if census is not None and jit_cache_size() != census:
            raise AssertionError(f"prefix: a decode graph was captured after "
                                 f"warm-up (census {jit_cache_size()} != "
                                 f"{census})")
    else:
        raise AssertionError(f"prefix: engine did not drain in {max_steps} "
                             f"steps")
    out = {rid: h.result() for rid, h in hs.items()}
    bad = [r.request_id for r in out.values() if r.finish_reason != "length"]
    if bad:
        raise AssertionError(f"prefix: requests {bad} did not complete")
    return out, steps, shared, pa.paged_attn.launches - launches0


def prefix_reference(model, requests):
    """The same requests on the engine without a cache (eager steps, the
    margin probe): ``(results by id, probe)``."""
    eng = prefix_engine(model, cache=False, capture=False)
    probe = eng._x = _MarginProbe(eng)
    out = prefix_drain(eng, requests)[0]
    eng.close()
    return out, probe


def prefix_compare(what, got, want, probe, requests):
    """Raise unless each stream of ``got`` equals ``want``'s up to its
    first low-margin token; returns the compared token counts."""
    compared = {}
    for rid, p, n, _ in requests:
        upto = probe.upto(rid, p, n)
        compared[rid] = upto
        a, b = got[rid].tokens, want[rid].tokens
        if not np.array_equal(a[:len(p) + upto], b[:len(p) + upto]):
            raise AssertionError(
                f"prefix {what} {rid}: the cached engine's stream differs "
                f"from the cache-less engine's before token {upto}, the "
                f"first whose top-2 margin is under {SERVE_BF16_LOGITS_ATOL}")
    return compared


def prefix_ttft(model, eng, prompts):
    """Each prompt alone on an idle ``eng`` with one new token: its TTFT
    (submit to first token, the prefill) on the engine's clock."""
    from singa_tpu_torch.serve import GenerationRequest

    out = []
    for p in prompts:
        torch.cuda.synchronize()
        h = eng.submit(GenerationRequest(p, max_new_tokens=1))
        eng.run_until_complete(max_steps=10)
        eng.check_block_accounting()
        out.append(h.result().ttft)
    return out


def phase_prefix(model, seed=0):
    """GPT-2 small served in bf16 with the prefix cache on the paged arena
    (module docstring): the shared-prompt batch, then again with no new
    capture, the sessions, TTFT warm against cold, and a pressured pool
    that must evict.  Returns the phase's ``paged_attn`` launches."""
    from singa_tpu_torch.serve import jit_cache_size

    cfg = model.cfg
    t = prefix_traffic(seed, vocab=cfg.vocab_size)
    n_new = PREFIX_NEW
    batch = [(f"p{i}", p, n_new, False) for i, p in enumerate(t["prompts"])]
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    # float32: with the cache (a primer first, so most admissions are
    # warm) the streams equal the cache-less engine's whole
    streams = []
    for cache in (True, False):
        e32 = prefix_engine(model, cache=cache, dtype=torch.float32)
        if cache:
            prefix_drain(e32, [("primer", t["primer"], 2, False)])
        streams.append(prefix_drain(e32, batch)[0])
        e32.close()
    for rid, _, _, _ in batch:
        if not np.array_equal(streams[0][rid].tokens, streams[1][rid].tokens):
            raise AssertionError(f"prefix float32 {rid}: the cached engine's "
                                 f"stream differs from the cache-less one's")
    mark("float32")
    ref, probe = prefix_reference(model, batch)
    mark("reference")
    eng = prefix_engine(model)
    # warm-up: the primer at every decode width (1, 2, 4, 8 live slots)
    # captures each width's graph and puts the system prompt in the tree
    launches = 0
    w = 1
    while w <= PREFIX_ENGINE["max_slots"]:
        launches += prefix_drain(eng, [(f"primer{w}.{i}", t["primer"], 2,
                                        False) for i in range(w)])[3]
        w *= 2
    census = jit_cache_size()
    graphs = sorted(eng._steps)
    snap0 = eng.stats.snapshot()["prefix"]
    got, steps1, shared1, n = prefix_drain(eng, batch, census=census)
    launches += n
    snap1 = eng.stats.snapshot()["prefix"]
    hit_share = ((snap1["hit_tokens"] - snap0["hit_tokens"])
                 / (snap1["lookup_tokens"] - snap0["lookup_tokens"]))
    if hit_share <= PREFIX_MIN_HIT_SHARE:
        raise AssertionError(f"prefix: shared-prompt batch hit share "
                             f"{hit_share} <= {PREFIX_MIN_HIT_SHARE}")
    if shared1 == 0:
        raise AssertionError("prefix: no decode step read shared blocks")
    compared = prefix_compare("batch", got, ref, probe, batch)
    mark("batch")
    again, steps2, _, n = prefix_drain(
        eng, [(f"q{i}", p, n_new, False) for i, p in enumerate(t["prompts"])],
        census=census)
    launches += n
    for i in range(PREFIX_REQUESTS):
        if not np.array_equal(again[f"q{i}"].tokens, got[f"p{i}"].tokens):
            raise AssertionError(f"prefix: request {i} differs between two "
                                 f"warm runs of the batch")
    mark("batch_again")
    # sessions: each turn of every conversation at once, then the same
    # prompts on the reference engine
    histories = [s for s in t["sessions"]]
    handles = [None] * PREFIX_SESSIONS
    session_compared, session_hits = {}, []
    for turn in range(PREFIX_TURNS):
        reqs = [(f"s{c}t{turn}", histories[c], n_new, True)
                for c in range(PREFIX_SESSIONS)]
        before = eng.stats.snapshot()["prefix"]
        out, _, _, n = prefix_drain(eng, reqs, census=census)
        launches += n
        after = eng.stats.snapshot()["prefix"]
        session_hits.append((after["hit_tokens"] - before["hit_tokens"])
                            / (after["lookup_tokens"]
                               - before["lookup_tokens"]))
        sref, sprobe = prefix_reference(model, reqs)
        session_compared.update(prefix_compare(f"session turn {turn}", out,
                                               sref, sprobe, reqs))
        for c in range(PREFIX_SESSIONS):
            if handles[c] is not None:
                handles[c].release()
            handles[c] = out[f"s{c}t{turn}"].session
            if handles[c] is None or handles[c].pinned_blocks == 0:
                raise AssertionError(f"prefix: session {c} pinned nothing")
            if turn + 1 < PREFIX_TURNS:
                histories[c] = handles[c].request(t["users"][c][turn]) \
                    .prompt_ids
    for h in handles:
        h.release()
    mark("sessions")
    decode_steps = eng.stats.snapshot()["throughput"]["decode_steps"]
    if launches != cfg.n_layer * decode_steps:
        raise AssertionError(f"prefix: paged_attn launched {launches} times "
                             f"over {decode_steps} decode steps")
    # TTFT, each prompt alone: warm (the cache holds the system prompt),
    # cold on the cache-less engine, cold through the chunked path (a
    # system prompt the tree has never seen)
    rng = np.random.RandomState(seed + 5)
    probes = [np.concatenate([t["system"], rng.randint(
        0, cfg.vocab_size, len(p) - PREFIX_SYSTEM).astype(np.int32)])
        for p in t["prompts"][:8]]
    novel = [rng.randint(0, cfg.vocab_size, len(p)).astype(np.int32)
             for p in probes]
    ttft_warm = prefix_ttft(model, eng, probes)
    ttft_cold_chunked = prefix_ttft(model, eng, novel)
    final_snap = eng.stats.snapshot()
    eng.close()
    plain = prefix_engine(model, cache=False)
    prefix_ttft(model, plain, probes[:1])      # the first prefill builds
    ttft_cold = prefix_ttft(model, plain, probes)
    plain.close()
    mark("ttft")
    # a pool the traffic overflows: the tree must evict, never a block a
    # pinned session or a live slot references, and admissions whose
    # prefix went fall back to cold prefill
    small = prefix_engine(model, num_blocks=PREFIX_PRESSURE_BLOCKS)
    pin_prompt = np.random.RandomState(seed + 9).randint(
        0, cfg.vocab_size, 200).astype(np.int32)
    pinned, _, _, n_pin = prefix_drain(small, [("pin", pin_prompt, 8, True)])
    sess = pinned["pin"].session
    held = [(n.block, n.key) for n in sess._nodes]
    pressured, _, pshared, n = prefix_drain(small, batch)
    launches += n_pin + n
    psnap = small.stats.snapshot()
    if psnap["prefix"]["evictions"] == 0:
        raise AssertionError(f"prefix: the pressured pool evicted nothing: "
                             f"{psnap['prefix']}")
    if [(n.block, n.key) for n in sess._nodes] != held or \
            len(small.prefix_cache.lookup(pin_prompt)) != len(held):
        raise AssertionError("prefix: a pinned session's block was evicted")
    pressured_compared = prefix_compare("pressured", pressured, ref, probe,
                                        batch)
    sess.release()
    small.close()
    mark("pressured")
    log({"phase": "prefix", "model": "gpt2-small", "dtype": "bf16",
         "engine": PREFIX_ENGINE, "requests": PREFIX_REQUESTS,
         "system_prompt": PREFIX_SYSTEM, "new_tokens": n_new,
         "prompt_lens": [len(p) for p in t["prompts"]],
         "float32_streams_equal_cacheless": True,
         "hit_share_shared_prompt_batch": hit_share,
         "prefix_after_batch": snap1,
         "decode_steps_batch": steps1, "decode_steps_batch_again": steps2,
         "lane_steps_over_shared_blocks": shared1,
         "graphs": graphs, "census_after_warmup": census,
         "no_capture_after_warmup": True,
         "paged_attn_launches": launches,
         "decode_steps_cached_engine": decode_steps,
         "streams_compared_up_to_token": compared,
         "low_margin_requests": len(probe.first_low) + sum(
             m < SERVE_BF16_LOGITS_ATOL for m in probe.prompt_margin.values()),
         "sessions": {"conversations": PREFIX_SESSIONS,
                      "turns": PREFIX_TURNS,
                      "hit_share_by_turn": session_hits,
                      "streams_compared_up_to_token": session_compared},
         "ttft_median_s": {"warm": statistics.median(ttft_warm),
                           "cold_no_cache": statistics.median(ttft_cold),
                           "cold_chunked": statistics.median(
                               ttft_cold_chunked)},
         "ttft_s": {"warm": ttft_warm, "cold_no_cache": ttft_cold,
                    "cold_chunked": ttft_cold_chunked},
         "admission_s": final_snap["latency"]["admission"],
         "pressured": {"num_blocks": PREFIX_PRESSURE_BLOCKS,
                       "prefix": psnap["prefix"], "paged": psnap["paged"],
                       "pinned_blocks_kept": len(held),
                       "lane_steps_over_shared_blocks": pshared,
                       "streams_compared_up_to_token": pressured_compared},
         "seconds": {n: tt - marks[i][1]
                     for i, (n, tt) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return launches


def phase_generate(model, seed=0, prompt_len=1000, n_new=40):
    """GPT-2 small (the serve phase's float32 model) past n_positions: a
    ``prompt_len``-token prompt and ``n_new`` greedy tokens take
    ``generate``'s windowed path, one 1024-wide forward a token through
    the flash forward kernel (12 launches a token); its tokens equal the
    KV-cached ``generate``'s while the generation fits n_positions.  Then
    ``min_p`` and ``repetition_penalty`` on the KV-cached path: with
    min_p = 1 a sampled stream is the greedy one."""
    from singa_tpu_torch.ops import flash_attention as fa

    cfg = model.cfg
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, prompt_len).astype(np.int32)
    before = fa.flash_fwd.launches
    t0 = time.perf_counter()
    windowed = model.generate(prompt, max_new_tokens=n_new, temperature=0.0)
    seconds = time.perf_counter() - t0
    launches = fa.flash_fwd.launches - before
    if launches != cfg.n_layer * n_new:
        raise AssertionError(f"windowed generate launched the flash forward "
                             f"{launches} times for {n_new} tokens")
    fits = cfg.n_positions - prompt_len
    cached = model.generate(prompt, max_new_tokens=fits, temperature=0.0,
                            use_cache=True)
    if len(windowed) != prompt_len + n_new or not np.array_equal(
            windowed[:cfg.n_positions], cached):
        raise AssertionError("windowed generate differs from the KV-cached "
                             "one inside n_positions")
    short = prompt[:200]
    kw = dict(max_new_tokens=24, repetition_penalty=1.3)
    greedy = model.generate(short, temperature=0.0, **kw)
    sampled = model.generate(short, temperature=0.9, min_p=1.0, seed=3, **kw)
    filtered = model.generate(short, temperature=0.9, min_p=0.05, top_k=50,
                              seed=3, **kw)
    if not np.array_equal(sampled, greedy):
        raise AssertionError("min_p = 1 sampling differs from greedy")
    if len(filtered) != len(short) + 24 or filtered.max() >= cfg.vocab_size:
        raise AssertionError("min_p / repetition_penalty generate gave a "
                             "bad stream")
    log({"phase": "generate", "model": "gpt2-small", "dtype": "float32",
         "prompt_len": prompt_len, "max_new_tokens": n_new,
         "windowed_seconds": seconds, "flash_fwd_launches": launches,
         "equal_to_kv_cached_tokens": fits,
         "min_p_one_equals_greedy": True})


SPEC_K = 4
#: draft (a) of the spec phase: GPT-2 small's widths at this depth, holding
#: the target's embeddings, first blocks and final LN
SPEC_DRAFT_LAYERS = 2
#: the windowed model of the longctx phase: GPT-2 small with this
#: attn_window and the dense model's weights; no slot may hold more than
#: (window - 1) // block + 2 blocks
LONGCTX_WINDOW = 256
LONGCTX_BUDGET = 256
#: the longctx budget run: chats decoding, then one long admission
LONGCTX_CHATS = 7
LONGCTX_LONG = dict(prompt=960, max_new=64)
LONGCTX_CHAT = dict(prompt=(16, 65), max_new=256)
#: the windowed traffic: prompts of ``LONGCTX_PROMPTS`` tokens generating
#: to 1024 positions in all; the int8 and draft runs take its first
#: ``LONGCTX_CUT`` requests (the script's time limit)
LONGCTX_WINDOWED = 8
LONGCTX_CUT = 4
LONGCTX_TPOT_FROM = 700


class _StageRecorder:
    """Keeps the host arrays an engine stages for its step with the most
    live lanes (ties: the largest positions), wrapping
    ``DecodeInputs.stage``: one real step's tables and positions, read
    without a device sync, for the kernel phase to time."""

    def __init__(self, eng):
        self.eng, self.real, self._key = eng, None, None
        self._inner = eng._inputs.stage
        eng._inputs.stage = self.stage

    def stage(self, toks, pos, live, keys, temps, tables):
        live = np.asarray(live, bool)
        p = np.asarray(pos)[live]
        key = (int(live.sum()), int(p.sum()))
        if self._key is None or key > self._key:
            self._key = key
            self.real = dict(tables=np.array(tables[live], np.int32),
                             p_limit=p.astype(np.int32).tolist(),
                             step=self.eng.step_count)
        return self._inner(toks, pos, live, keys, temps, tables)


def spec_draft(model):
    """Draft (a): GPT-2 small's widths at ``SPEC_DRAFT_LAYERS`` layers, its
    weights the target's embeddings, first blocks and final LN, copied by
    state name."""
    from singa_tpu_torch import device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    draft = GPT2LMHead(GPT2Config.small(dropout=0.0,
                                        n_layer=SPEC_DRAFT_LAYERS))
    draft.compile([tensor.from_numpy(np.zeros((1, 8), np.int32),
                                     device.create_cuda_gpu())],
                  is_train=False)
    states = model.get_states()
    draft.set_states({k: states[k] for k in draft.get_states()})
    return draft


def _reset_paged_counts():
    from singa_tpu_torch.ops import paged_attention as pa

    for name in ("launches", "int8_launches", "chunk_launches",
                 "window_launches"):
        setattr(pa.paged_attn, name, 0)


def _paged_counts():
    from singa_tpu_torch.ops import paged_attention as pa

    return {name: getattr(pa.paged_attn, name)
            for name in ("launches", "int8_launches", "chunk_launches",
                         "window_launches")}


def _greedy_equal(what, traffic, got, want, upto=None):
    """Raise unless every greedy request's stream in ``got`` equals
    ``want``'s, whole or up to token ``upto[i]`` past its prompt."""
    for i, w in enumerate(traffic):
        if w["temperature"] > 0:
            continue
        n = len(w["prompt"]) + (w["max_new"] if upto is None
                                else upto.get(f"r{i}", w["max_new"]))
        if not np.array_equal(got[i][:n], want[i][:n]):
            raise AssertionError(f"request {i}: {what}")


def phase_spec(model, real, real8):
    """Speculative decoding on the serve phase's engine (8 slots, paged,
    blocks of 32, 256 blocks), its 24 requests, ``spec_k`` 4, with draft
    (a) (``spec_draft``) and draft (b), the target itself (every proposal
    accepted, the bonus token drawn).  float32: each draft's greedy
    streams equal the non-speculative engine's whole (the serve phase's,
    equal to offline ``generate``), as do draft (a)'s on the slot arena
    and on int8 pools (against the int8 engine's); every verify is one
    ``paged_attn`` launch a layer at Q = 4 (``chunk_launches``, apart
    from Q = 1 ones: none), the census flat.  bf16, timed, both drafts:
    greedy streams equal the non-speculative bf16 engine's up to each
    request's first low-margin token (the serve phase's probe), TTFT,
    TPOT and decode tokens/s beside the non-speculative engine's; draft
    (a)'s run is the main path of the ``paged_attn_spec`` row (counts set
    to 0 just before, read just after) and gives its real tables.
    Offline ``generate_speculative`` equals greedy ``generate`` on two
    prompts.  Returns the tables and the Q = 4 launches."""
    from singa_tpu_torch.models import gpt2_decode as gd

    marks = [("start", time.perf_counter())]
    cfg, traffic = model.cfg, real["traffic"]
    draft = spec_draft(model)
    drafts = (("draft_2_layer", draft), ("self_draft", model))
    kw = {name: dict(draft_model=d, spec_k=SPEC_K) for name, d in drafts}
    n_layer = cfg.n_layer

    def checked(what, snap, quant=False):
        counts = _paged_counts()
        steps = snap["throughput"]["decode_steps"]
        want = n_layer * steps
        if not (counts["launches"] == counts["chunk_launches"] == want
                and counts["int8_launches"] == (want if quant else 0)):
            raise AssertionError(f"{what}: paged_attn launches {counts} over "
                                 f"{steps} speculative steps")
        spec = snap["spec"]
        return dict(steps=steps, paged_attn=counts, graphs=snap["graphs"],
                    acceptance_rate=spec["acceptance_rate"],
                    tokens_per_chunk=spec["tokens_per_chunk"],
                    chunks=spec["chunks"])

    f32 = {}
    for name, _ in drafts:
        _reset_paged_counts()
        streams, snap, sec, _ = run_engine(model, traffic, "block",
                                           **kw[name])
        f32[name] = dict(checked(f"float32 {name}", snap), seconds=sec)
        _greedy_equal(f"float32 {name}: the speculative stream differs from "
                      f"the non-speculative engine's", traffic, streams,
                      real["offline"])
        marks.append((f"float32_{name}", time.perf_counter()))
    if f32["self_draft"]["acceptance_rate"] != 1.0:
        raise AssertionError(f"the target as its own draft accepted "
                             f"{f32['self_draft']['acceptance_rate']}")
    _reset_paged_counts()
    slots, ssnap, ssec, _ = run_engine(model, traffic, None,
                                       **kw["draft_2_layer"])
    if _paged_counts()["launches"]:
        raise AssertionError("the slot arena's speculative step launched "
                             "paged_attn")
    _greedy_equal("slot arena, draft (a): the speculative stream differs "
                  "from the non-speculative engine's", traffic, slots,
                  real["offline"])
    marks.append(("float32_slot_arena", time.perf_counter()))
    _reset_paged_counts()
    s8, snap8, sec8, _ = run_engine(model, traffic, "block",
                                    cache_dtype="int8", **kw["draft_2_layer"])
    int8 = dict(checked("float32 int8 pools", snap8, quant=True),
                seconds=sec8)
    _greedy_equal("int8 pools, draft (a): the speculative stream differs "
                  "from the int8 engine's", traffic, s8, real8["offline"])
    marks.append(("float32_int8", time.perf_counter()))

    bf, rec, bf16 = torch.bfloat16, [], {}
    for name, _ in drafts:
        _reset_paged_counts()
        streams, snap, sec, dec_s = run_engine(
            model, traffic, "block", dtype=bf, trace=True,
            on_engine=lambda e: rec.append(_StageRecorder(e)), **kw[name])
        bf16[name] = dict(checked(f"bf16 {name}", snap),
                          **serve_timing(snap, sec, dec_s, len(traffic)))
        _greedy_equal(f"bf16 {name}: the speculative stream differs from "
                      f"the non-speculative bf16 engine's before the first "
                      f"low-margin token", traffic, streams,
                      real["bf16_streams"], upto=real["first_low"])
        marks.append((f"bf16_{name}", time.perf_counter()))
    spec_real = rec[0].real

    prompts = [traffic[i]["prompt"] for i, w in enumerate(traffic)
               if w["temperature"] <= 0][:2]
    want = [real["offline"][i][:len(traffic[i]["prompt"]) + 32]
            for i, w in enumerate(traffic) if w["temperature"] <= 0][:2]
    t0 = time.perf_counter()
    got, ostats = gd.generate_speculative(model, draft, prompts,
                                          max_new_tokens=32, spec_k=SPEC_K)
    offline_s = time.perf_counter() - t0
    for g, w in zip(got, want):
        if not np.array_equal(g, w):
            raise AssertionError("generate_speculative differs from greedy "
                                 "generate")
    marks.append(("offline", time.perf_counter()))
    log({"phase": "spec", "model": "gpt2-small", "engine": SERVE_ENGINE,
         "spec_k": SPEC_K, "requests": len(traffic),
         "drafts": {"draft_2_layer": f"GPT-2 small widths, "
                                     f"{SPEC_DRAFT_LAYERS} layers: the "
                                     f"target's embeddings, first blocks "
                                     f"and final LN",
                    "self_draft": "the target itself"},
         "float32": dict(f32, greedy_streams_equal_non_speculative=True),
         "float32_slot_arena": dict(
             seconds=ssec, graphs=ssnap["graphs"],
             acceptance_rate=ssnap["spec"]["acceptance_rate"],
             greedy_streams_equal_non_speculative=True),
         "float32_int8": dict(int8, greedy_streams_equal_int8_engine=True),
         "bf16": dict(bf16, non_speculative=real["bf16"],
                      greedy_streams_equal_up_to_low_margin=True),
         "offline_generate_speculative": dict(
             ostats, seconds=offline_s, equal_to_greedy_generate=True),
         "verify_table": dict(step=spec_real["step"],
                              p_limit=spec_real["p_limit"]),
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return dict(spec_real, launches=bf16["draft_2_layer"]["paged_attn"][
        "chunk_launches"], launches8=int8["paged_attn"]["chunk_launches"])


def longctx_budget_run(model, budget, seed=0):
    """``LONGCTX_CHATS`` chat requests decode on the serve engine
    (float32), then the long prompt is admitted, under ``budget`` or
    whole; the engine is stepped by hand.  Returns the streams, the
    step-to-step gaps (seconds) before the long admission and while it
    admits, its TTFT, the budget's chunk passes and the stats."""
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    rng = np.random.RandomState(seed)
    vocab = model.cfg.vocab_size
    eng = model.serve(max_slots=c["max_slots"], paged=PagedConfig(
        block_size=c["block_size"], num_blocks=c["num_blocks"],
        prefill_token_budget=budget))
    reqs = [GenerationRequest(
        rng.randint(0, vocab, rng.randint(*LONGCTX_CHAT["prompt"])),
        max_new_tokens=LONGCTX_CHAT["max_new"],
        temperature=0.0 if i % 2 == 0 else 0.9, seed=i, request_id=f"c{i}")
        for i in range(LONGCTX_CHATS)]
    long = GenerationRequest(rng.randint(0, vocab, LONGCTX_LONG["prompt"]),
                             max_new_tokens=LONGCTX_LONG["max_new"],
                             request_id="long")
    hs = [eng.submit(r) for r in reqs]
    times = []

    def step():
        eng.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter())

    while eng.live_slots < LONGCTX_CHATS:
        step()
    for _ in range(16):
        step()
    before = len(times)
    hs.append(eng.submit(long))
    while "long" not in eng.live_request_ids:
        step()
    admitting = np.diff(times[before - 1:]).tolist()
    steady = np.diff(times[before - 12:before]).tolist()
    while eng.pending:
        step()
        eng.check_block_accounting()
    streams = [h.result().tokens for h in hs]
    snap = eng.stats.snapshot()
    ttft = hs[-1].result().ttft
    eng.close()
    return streams, dict(gap_max_s=max(admitting),
                         gap_median_s=statistics.median(admitting),
                         steps_while_admitting=len(admitting),
                         steady_gap_median_s=statistics.median(steady),
                         long_ttft_s=ttft,
                         budget_chunks=snap["budget_chunks"],
                         decode_steps=snap["throughput"]["decode_steps"])


#: the windowed requests' prompt lengths, four of each: offline
#: ``generate``, the streams' reference, takes one generation length a
#: batch and ~24 ms a step on the host, so two lengths keep it to two
#: batches (1280 steps)
LONGCTX_PROMPTS = (512, 256)


def windowed_traffic(seed=0, vocab=50257):
    """``LONGCTX_WINDOWED`` greedy requests, prompts of
    ``LONGCTX_PROMPTS`` tokens, each generating to 1024 positions."""
    rng = np.random.RandomState(seed)
    lens = [n for n in LONGCTX_PROMPTS
            for _ in range(LONGCTX_WINDOWED // len(LONGCTX_PROMPTS))]
    return [dict(prompt=rng.randint(0, vocab, n).astype(np.int32),
                 max_new=1024 - n, temperature=0.0, seed=i)
            for i, n in enumerate(lens)]


def offline_by_length(model, traffic, cache_dtype=None):
    """Offline greedy ``generate`` of requests of one generation length a
    batch (``offline_streams`` takes one length for all)."""
    out = [None] * len(traffic)
    for n_new in sorted({w["max_new"] for w in traffic}):
        idx = [i for i, w in enumerate(traffic) if w["max_new"] == n_new]
        rows = model.generate([traffic[i]["prompt"] for i in idx],
                              max_new_tokens=n_new, temperature=0.0,
                              cache_dtype=cache_dtype)
        for i, r in zip(idx, rows):
            out[i] = r
    return out


class _WindowWatch:
    """Per step of a windowed (or the dense) engine: the block accounting,
    the most blocks a slot holds, the step's wall time and the lowest
    live position, and the table entries below a 512-token prompt's
    window when it is admitted.  A step's wall time runs from the end of
    the previous call to the start of this one, so it holds the engine's
    step (and the census read between the two) but none of these
    checks, whose host work grows with the blocks a slot holds."""

    def __init__(self, window, block):
        self.window, self.block = window, block
        self.most, self.steps, self.long_lead = 0, [], None
        self.t = None

    def __call__(self, eng):
        now = time.perf_counter()
        eng.check_block_accounting()
        trash = eng.paged_arena.trash
        live = [(i, s) for i, s in enumerate(eng._slots) if s is not None]
        if live:
            self.most = max(self.most, max(sum(b != trash for b in s.blocks)
                                           for _, s in live))
            low = min(int(eng._pos[i]) for i, _ in live)
            if self.t is not None:
                self.steps.append((now - self.t, low, len(live)))
            for _, s in live:
                if len(s.handle.request.prompt_ids) == 512 \
                        and self.long_lead is None:
                    self.long_lead = sum(b == trash for b in s.blocks)
        self.t = time.perf_counter()

    def tpot_past(self, pos):
        """Median wall time of the steps whose every live slot is at
        ``pos`` or past it: each of them is one token of each live
        request."""
        late = [t for t, low, _ in self.steps if low >= pos]
        return statistics.median(late) if late else None


def phase_longctx(model, seed=0):
    """Long-context serving on GPT-2 small, float32, paged, blocks of 32.
    (a) The chunked-prefill budget: ``LONGCTX_CHATS`` chats (prompts of
    16-64 tokens, 256 new) decode, then a 960-token prompt (64 new) is
    admitted with ``prefill_token_budget=256`` and without; every stream
    equal between the two engines, the longest and median step-to-step
    gap while it admits, its TTFT, the budget's chunk passes.  (b)
    Windowed serving: GPT-2 small with ``attn_window=256`` and the dense
    weights, 8 requests (prompts of 512 and 256 tokens) generating to
    1024 positions: streams equal offline windowed ``generate`` (its rolling
    cache), the block accounting after every step, no slot above 9
    blocks, the 512-token prompt admitted with its in-window blocks only,
    every ``paged_attn`` launch with the window (the ``paged_attn_window``
    row's main path), TPOT past position 700 beside the dense model's
    at the same positions; then the first ``LONGCTX_CUT`` requests on
    int8 pools (== offline windowed int8 ``generate``) and with draft (a)
    (== the windowed engine's streams).  Returns the windowed step's
    tables and its launches."""
    from singa_tpu_torch import device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    marks = [("start", time.perf_counter())]
    cfg = model.cfg
    budget = {}
    streams = {}
    for name, b in (("unbudgeted", None), ("budgeted", LONGCTX_BUDGET)):
        streams[name], budget[name] = longctx_budget_run(model, b, seed)
        marks.append((f"budget_{name}", time.perf_counter()))
    _same_streams("the budgeted engine's stream differs from the "
                  "unbudgeted engine's", streams["budgeted"],
                  streams["unbudgeted"])

    wcfg = GPT2Config.small(dropout=0.0, attn_window=LONGCTX_WINDOW)
    wmodel = GPT2LMHead(wcfg)
    wmodel.compile([tensor.from_numpy(np.zeros((1, 8), np.int32),
                                      device.create_cuda_gpu())],
                   is_train=False)
    wmodel.set_states(model.get_states())
    traffic = windowed_traffic(seed, cfg.vocab_size)
    block = SERVE_ENGINE["block_size"]
    most_blocks = (LONGCTX_WINDOW - 1) // block + 2
    watch, rec = _WindowWatch(LONGCTX_WINDOW, block), []
    _reset_paged_counts()
    wstreams, wsnap, wsec, _ = run_engine(
        wmodel, traffic, "block", per_step=watch,
        on_engine=lambda e: rec.append(_StageRecorder(e)))
    counts = _paged_counts()
    steps = wsnap["throughput"]["decode_steps"]
    if not counts["launches"] == counts["window_launches"] \
            == cfg.n_layer * steps:
        raise AssertionError(f"windowed: paged_attn launches {counts} over "
                             f"{steps} steps")
    if watch.most > most_blocks:
        raise AssertionError(f"a windowed slot held {watch.most} blocks, "
                             f"more than {most_blocks}")
    lead = (512 - LONGCTX_WINDOW + 1) // block
    if watch.long_lead != lead:
        raise AssertionError(f"the 512-token prompt admitted with "
                             f"{watch.long_lead} trash entries, not {lead}")
    marks.append(("windowed_engine", time.perf_counter()))
    offline = offline_by_length(wmodel, traffic)
    _same_streams("the windowed engine's stream differs from offline "
                  "windowed generate", wstreams, offline)
    marks.append(("windowed_generate", time.perf_counter()))
    dwatch = _WindowWatch(None, block)
    _, dsnap, dsec, _ = run_engine(model, traffic, "block", per_step=dwatch)
    marks.append(("dense_engine", time.perf_counter()))

    cut = traffic[:LONGCTX_CUT]
    w8, _, sec8, _ = run_engine(wmodel, cut, "block", cache_dtype="int8")
    _same_streams("the windowed int8 engine's stream differs from offline "
                  "windowed int8 generate", w8,
                  offline_by_length(wmodel, cut, "int8"))
    marks.append(("windowed_int8", time.perf_counter()))
    # a verify chunk needs spec_k - 1 positions of headroom
    short = [dict(w, max_new=w["max_new"] - SPEC_K + 1) for w in cut]
    wd, wdsnap, secd, _ = run_engine(wmodel, short, "block",
                                     draft_model=spec_draft(model),
                                     spec_k=SPEC_K)
    _same_streams("the windowed speculative engine's stream differs from "
                  "the windowed engine's", wd,
                  [s_[:len(s_) - SPEC_K + 1] for s_ in wstreams[:LONGCTX_CUT]])
    marks.append(("windowed_draft", time.perf_counter()))
    wreal = rec[0].real
    log({"phase": "longctx", "model": "gpt2-small", "dtype": "float32",
         "engine": SERVE_ENGINE,
         "budget": dict(budget, prefill_token_budget=LONGCTX_BUDGET,
                        chats=LONGCTX_CHATS, chat=LONGCTX_CHAT,
                        long=LONGCTX_LONG,
                        streams_equal_unbudgeted=True),
         "windowed": dict(
             attn_window=LONGCTX_WINDOW, requests=len(traffic),
             prompt_lens=[len(w["prompt"]) for w in traffic],
             seconds=wsec, decode_steps=steps, paged_attn=counts,
             graphs=wsnap["graphs"], window_drops=wsnap["paged"][
                 "window_drops"],
             most_blocks_a_slot=watch.most, limit=most_blocks,
             prompt_512_trash_entries=watch.long_lead,
             streams_equal_offline_windowed_generate=True,
             tpot_past_s={"windowed": watch.tpot_past(LONGCTX_TPOT_FROM),
                          "dense": dwatch.tpot_past(LONGCTX_TPOT_FROM),
                          "from_position": LONGCTX_TPOT_FROM},
             dense_seconds=dsec, dense_decode_steps=dsnap["throughput"][
                 "decode_steps"],
             int8=dict(requests=LONGCTX_CUT, seconds=sec8,
                       streams_equal_offline_int8_generate=True),
             draft_2_layer=dict(requests=LONGCTX_CUT, seconds=secd,
                                acceptance_rate=wdsnap["spec"][
                                    "acceptance_rate"],
                                streams_equal_windowed_engine=True),
             step_table=dict(step=wreal["step"],
                             p_limit=wreal["p_limit"])),
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return dict(wreal, launches=counts["window_launches"])


# ------------------------------------------------------------------- fork

#: best-of-n: requests, branches, new tokens, prompt lengths, temperature
FORK_REQUESTS = 6
FORK_N = 4
FORK_NEW = 64
FORK_PROMPTS = (128, 513)
FORK_TEMP = 0.8
#: tree search: the prompt, new tokens, the steps after which the parent
#: forks (twice) and one branch is pruned
FORK_TREE = dict(prompt=256, new=64, fork_after=(10, 10), prune_after=5)
#: a forked group beside higher-priority arrivals on a pool too small for
#: both: the group's prompt, the arrivals' prompts, the tight pool
FORK_PRESSURE = dict(prompt=200, hi_prompts=(500, 480), num_blocks=40,
                     lead=8)
#: structured decoding: requests, new tokens (every output of the schema
#: is shorter), prompt lengths
STRUCT_REQUESTS = 8
STRUCT_NEW = 80
STRUCT_PROMPTS = (32, 129)
STRUCT_SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"}, "ok": {"type": "boolean"},
    "name": {"type": "string", "maxLength": 8},
    "mode": {"enum": ["fast", "slow", "auto"]}}}
STRUCT_MAX_DIGITS = 6


def fork_traffic(seed=0, vocab=50257):
    """The fork phase's prompts (``FORK_PROMPTS`` tokens from a numpy
    seed) and their sampling seeds."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(*FORK_PROMPTS))
                 .astype(np.int32), seed=int(rng.randint(0, 2 ** 31 - 1)))
            for _ in range(FORK_REQUESTS)]


def fork_engine(model, dtype=None, capture=True, num_blocks=None, **kw):
    """The serve phase's paged engine (8 slots, blocks of 32, 256 blocks
    unless ``num_blocks``)."""
    from singa_tpu_torch.serve import PagedConfig

    c = SERVE_ENGINE
    return model.serve(max_slots=c["max_slots"], dtype=dtype,
                       capture=capture, paged=PagedConfig(
                           block_size=c["block_size"],
                           num_blocks=num_blocks or c["num_blocks"]), **kw)


def fork_drain(eng, max_steps=5000):
    """Step ``eng`` until it drains, checking the block accounting
    (``used == cached + live_referenced``, shared blocks once) after
    every step; raise unless no block is left.  Returns (steps, the
    most blocks in use after a step)."""
    peak = 0
    for step in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        eng.check_block_accounting()
        peak = max(peak, eng.paged_arena.blocks_used)
    else:
        raise AssertionError(f"engine did not drain in {max_steps} steps")
    if eng.paged_arena.blocks_used:
        raise AssertionError(f"{eng.paged_arena.blocks_used} blocks in use "
                             f"after the drain")
    return step, peak


def fork_submit(eng, traffic, n, temperature, reps=1, tag="f"):
    """Every request of ``traffic`` ``reps`` times (seed + rep), each with
    ``n`` branches; returns the handles."""
    from singa_tpu_torch.serve import GenerationRequest

    return [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=FORK_NEW, temperature=temperature,
        seed=w["seed"] + r, n=n, request_id=f"{tag}{i}.{r}"))
        for r in range(reps) for i, w in enumerate(traffic)]


def _branches(handles):
    """Each handle's results (a fork group's, branch order)."""
    return [h.results() if hasattr(h, "results") else [h.result()]
            for h in handles]


class _SampledMarginProbe:
    """Executor of an eager engine (``capture=False``: it reads the device
    on the host): records, per request, the index of the first token
    whose top-2 margin, on the logits as the sampler sees them (tempered
    plus the request's noise when sampled), is under
    ``SERVE_BF16_LOGITS_ATOL``, up to which bf16 streams of two engines
    must agree (the first token's margin is the prefill's, by prompt)."""

    def __init__(self, eng, traffic):
        self.eng, self.inner = eng, eng._x
        self.first_low, self.prompt_low = {}, set()
        self.by_prompt = {w["prompt"].tobytes(): w for w in traffic}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _margin(self, row, temp, noise):
        """``noise``: the row's Gumbel draw (the key it is sampled
        with)."""
        from singa_tpu_torch.models import gpt2_decode as gd

        row = row.float()
        if temp > 0:
            row = gd._filter_logits(row[None], float(temp), self.eng._top_p,
                                    self.eng._top_k)[0] + noise
        top2 = torch.topk(row, 2).values
        return (top2[0] - top2[1]).item()

    def prefill_batch(self, params, ids):
        from singa_tpu_torch.models import gpt2_decode as gd
        from singa_tpu_torch.ops import prng

        logits, kc, vc = self.inner.prefill_batch(params, ids)
        rows = ids.cpu().numpy().astype(np.int32)
        ws = [self.by_prompt[row.tobytes()] for row in rows]
        noise = prng.gumbel_t(gd.keys_on(np.concatenate(
            [admission_key(w["seed"]) for w in ws]), logits.device),
            logits.shape[-1])
        for row, lg, nz in zip(rows, logits, noise):
            if self._margin(lg, FORK_TEMP, nz) < SERVE_BF16_LOGITS_ATOL:
                self.prompt_low.add(row.tobytes())
        return logits, kc, vc

    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        got = self.inner.paged_decode_step(params, pool_k, pool_v, inp,
                                           block, kernel, n_rb)
        from singa_tpu_torch.ops import prng

        eng = self.eng
        lanes = [i for i, s in enumerate(eng._slots) if s is not None]
        noise = prng.gumbel_t(inp["keys"][:len(lanes), 0], got.shape[-1])
        for r, i in enumerate(lanes):
            slot = eng._slots[i]
            rid = slot.handle.request.request_id
            if rid not in self.first_low and self._margin(
                    got[r], eng._temps[i], noise[r]) < \
                    SERVE_BF16_LOGITS_ATOL:
                self.first_low[rid] = len(slot.emitted)
        return got

    def upto(self, rid, prompt):
        if prompt.tobytes() in self.prompt_low:
            return 0
        return self.first_low.get(rid, FORK_NEW)


def fork_tree(model, w):
    """Tree search on one float32 request at ``FORK_TEMP``: the parent
    forks twice mid-stream, one branch is pruned; the parent's stream is
    offline ``generate``'s at its seed (its children's writes went to
    copies), each branch holds the parent's tokens up to its fork, the
    pruned branch's private blocks return at once, and nothing is left
    after the drain."""
    from singa_tpu_torch.models import gpt2_decode as gd
    from singa_tpu_torch.serve import GenerationRequest

    t = FORK_TREE
    prompt = w["prompt"][:t["prompt"]]
    eng = fork_engine(model)
    arena = eng.paged_arena
    h = eng.submit(GenerationRequest(prompt, max_new_tokens=t["new"],
                                     temperature=FORK_TEMP, seed=w["seed"]))
    rid = h.request.request_id
    kids, at = [], []
    for n in t["fork_after"]:
        for _ in range(n):
            eng.step()
            eng.check_block_accounting()
        parent = next(s for s in eng._slots
                      if s is not None and s.handle is h)
        at.append(len(parent.emitted))
        kids.append(eng.fork(rid))
    for _ in range(t["prune_after"]):
        eng.step()
        eng.check_block_accounting()
    victim = next(s for s in eng._slots
                  if s is not None and s.handle is kids[0]._handle)
    private = [b for b in victim.blocks if arena.ref_count(b) == 1]
    used = arena.blocks_used
    kids[0].prune()
    freed = used - arena.blocks_used
    if not private or freed != len(private):
        raise AssertionError(f"prune freed {freed} blocks, the branch held "
                             f"{len(private)} private ones")
    fork_drain(eng)
    snap = eng.stats.snapshot()["fork"]
    eng.close()
    want = gd.generate(model, prompt, max_new_tokens=t["new"],
                       temperature=FORK_TEMP, seed=w["seed"])
    if not np.array_equal(h.result().tokens, want):
        raise AssertionError("tree: the parent's stream changed under its "
                             "children's writes")
    pruned = kids[0].result()
    if pruned.finish_reason != "pruned":
        raise AssertionError(f"the pruned branch finished "
                             f"{pruned.finish_reason!r}")
    for k, n in zip(kids, at):
        r = k.result()
        if not np.array_equal(r.tokens[:len(prompt) + n],
                              want[:len(prompt) + n]):
            raise AssertionError("a branch lost its parent's tokens")
    if not any(not np.array_equal(k.result().tokens[:len(want)], want)
               for k in kids):
        raise AssertionError("tree: the branches never diverged")
    return dict(forked_at_tokens=at, pruned_private_blocks=len(private),
                pruned_freed_blocks=freed, fork=snap,
                parent_equals_offline_generate=True)


def fork_pressured(model, w):
    """A float32 group of ``FORK_N`` sampled branches, then, ``lead`` steps
    in, two higher-priority requests on a pool too small for all: the
    branches are preempted (a byte copy to the host) and resume; every
    stream equals the same traffic's on the roomy pool."""
    from singa_tpu_torch.serve import GenerationRequest

    p = FORK_PRESSURE
    rng = np.random.RandomState(7)
    his = [rng.randint(0, model.cfg.vocab_size, n).astype(np.int32)
           for n in p["hi_prompts"]]

    def run(num_blocks):
        eng = fork_engine(model, num_blocks=num_blocks, scheduler="priority")
        fh = eng.submit(GenerationRequest(
            w["prompt"][:p["prompt"]], max_new_tokens=FORK_NEW,
            temperature=FORK_TEMP, seed=w["seed"], n=FORK_N))
        for _ in range(p["lead"]):
            eng.step()
            eng.check_block_accounting()
        hs = [eng.submit(GenerationRequest(x, max_new_tokens=FORK_NEW,
                                           priority=5)) for x in his]
        fork_drain(eng)
        snap = eng.stats.snapshot()
        eng.close()
        return ([r.tokens for r in fh.results()]
                + [h.result().tokens for h in hs], snap["paged"])

    roomy, _ = run(None)
    tight, paged = run(p["num_blocks"])
    if not paged["preemptions"]:
        raise AssertionError("the tight pool never preempted")
    for a, b in zip(roomy, tight):
        if not np.array_equal(a, b):
            raise AssertionError("a preempted forked stream differs from "
                                 "the roomy pool's")
    return dict(num_blocks=p["num_blocks"], preemptions=paged["preemptions"],
                swap_out=paged["swap_out"], swap_in=paged["swap_in"],
                streams_equal_roomy_pool=True)


def phase_fork(model, seed=0):
    """Fork on GPT-2 small (the serve phase's model and engine: 8 slots,
    blocks of 32, 256 blocks, captured).  Best-of-n: ``FORK_REQUESTS``
    prompts of 128-512 tokens, ``n = FORK_N``, ``FORK_NEW`` new tokens.
    float32 greedy, the traffic twice on one engine: every branch equals
    the ``n = 1`` engine's stream and offline ``generate``'s, and the
    second pass captures no graph.  bf16 at ``FORK_TEMP``: a warm-up pass,
    then the measured one (the main path of the ``paged_attn_fork`` row:
    counts set to 0 just before, read just after; one launch a layer a
    decode step; no graph captured; its step with the most live lanes
    kept, tables whose prompt blocks several slots share); branch 0 equals
    the ``n = 1`` stream (an eager engine's, up to its first low-margin
    token), the siblings diverge, ``ranked()`` orders by score; peak
    blocks and TPOT beside the same requests unforked four times.  Then
    tree search (``fork_tree``) and preemption (``fork_pressured``), float32.
    Returns the fork tables and launches."""
    from singa_tpu_torch.models import gpt2_decode as gd
    from singa_tpu_torch.serve import jit_cache_size

    marks = [("start", time.perf_counter())]
    cfg = model.cfg
    traffic = fork_traffic(seed, cfg.vocab_size)
    prompts = [w["prompt"] for w in traffic]

    eng = fork_engine(model)
    passes = []
    for p in range(2):
        census = jit_cache_size()
        hs = fork_submit(eng, traffic, FORK_N, 0.0, tag=f"g{p}.")
        fork_drain(eng)
        passes.append(_branches(hs))
        if p and jit_cache_size() != census:
            raise AssertionError("float32: the second pass captured a graph")
    f32_keys = sorted(map(str, eng._steps))
    eng.close()
    eng = fork_engine(model)
    hs = fork_submit(eng, traffic, 1, 0.0)
    fork_drain(eng)
    n1 = _branches(hs)
    eng.close()
    offline = gd.generate(model, prompts, max_new_tokens=FORK_NEW,
                          temperature=0)
    for i, want in enumerate(offline):
        if not np.array_equal(n1[i][0].tokens, want):
            raise AssertionError(f"float32 request {i}: n = 1 engine != "
                                 f"offline generate")
        for res in (passes[0][i], passes[1][i]):
            if len(res) != FORK_N or any(
                    not np.array_equal(r.tokens, want) for r in res):
                raise AssertionError(f"float32 request {i}: a greedy "
                                     f"branch differs from n = 1")
    marks.append(("float32_greedy", time.perf_counter()))

    bf = torch.bfloat16
    eng = fork_engine(model, dtype=bf)
    fork_submit(eng, traffic, FORK_N, FORK_TEMP, tag="w")
    fork_drain(eng)
    census, keys = jit_cache_size(), set(eng._steps)
    rec = _StageRecorder(eng)
    before = eng.stats.snapshot()
    _reset_paged_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = fork_submit(eng, traffic, FORK_N, FORK_TEMP)
    steps, peak = fork_drain(eng)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _paged_counts()
    snap = eng.stats.snapshot()
    decode_steps = (snap["throughput"]["decode_steps"]
                    - before["throughput"]["decode_steps"])
    if counts["launches"] != cfg.n_layer * decode_steps \
            or counts["int8_launches"] or counts["chunk_launches"]:
        raise AssertionError(f"bf16 fork: paged_attn launches {counts} over "
                             f"{decode_steps} decode steps")
    if jit_cache_size() != census or set(eng._steps) != keys:
        raise AssertionError("bf16 fork: the measured pass captured a graph")
    groups = _branches(hs)
    fork_keys = sorted(map(str, eng._steps))
    eng.close()
    real = rec.real
    names, n_share = np.unique(real["tables"][real["tables"]
                                              != SERVE_ENGINE["num_blocks"]],
                               return_counts=True)
    if n_share.max() < FORK_N:
        raise AssertionError(f"the recorded step's tables share no block "
                             f"among {FORK_N} slots: {real['tables']}")
    marks.append(("bf16_fork", time.perf_counter()))

    eng = fork_engine(model, dtype=bf, capture=False)
    probe = _SampledMarginProbe(eng, traffic)
    eng._x = probe
    n1_hs = fork_submit(eng, traffic, 1, FORK_TEMP)
    fork_drain(eng)
    n1b = _branches(n1_hs)
    eng.close()
    compared = []
    for i, (res, ref) in enumerate(zip(groups, n1b)):
        upto = probe.upto(f"f{i}.0", prompts[i])
        n = len(prompts[i]) + upto
        if not np.array_equal(res[0].tokens[:n], ref[0].tokens[:n]):
            raise AssertionError(f"bf16 request {i}: branch 0 differs from "
                                 f"n = 1 before its first low-margin token")
        compared.append(upto)
        if all(np.array_equal(r.tokens, res[0].tokens) for r in res[1:]):
            raise AssertionError(f"bf16 request {i}: the siblings never "
                                 f"diverged")
        ranked = hs[i].ranked()
        if len(ranked) != FORK_N or [r.score for r in ranked] != sorted(
                (r.score for r in res), reverse=True) \
                or hs[i].best() is not ranked[0]:
            raise AssertionError(f"bf16 request {i}: ForkHandle.ranked() "
                                 f"does not order the branches by score")
    marks.append(("bf16_n1_eager", time.perf_counter()))

    eng = fork_engine(model, dtype=bf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uhs = fork_submit(eng, traffic, 1, FORK_TEMP, reps=FORK_N, tag="u")
    _, upeak = fork_drain(eng)
    torch.cuda.synchronize()
    usec = time.perf_counter() - t0
    usnap = eng.stats.snapshot()
    eng.close()
    marks.append(("bf16_unforked", time.perf_counter()))

    tree = fork_tree(model, traffic[0])
    marks.append(("tree", time.perf_counter()))
    pressure = fork_pressured(model, traffic[1])
    marks.append(("pressure", time.perf_counter()))

    def tpot(results):
        return statistics.median(r.tpot for res in results for r in res
                                 if r.tpot is not None)

    log({"phase": "fork", "model": "gpt2-small", "engine": SERVE_ENGINE,
         "requests": FORK_REQUESTS, "n": FORK_N, "new_tokens": FORK_NEW,
         "prompt_lens": [len(p) for p in prompts],
         "float32_greedy": dict(branches_equal_n1_and_offline=True,
                                second_pass_graphs_captured=0,
                                step_keys=f32_keys),
         "bf16": dict(
             temperature=FORK_TEMP, seconds=sec, decode_steps=decode_steps,
             paged_attn=counts, graphs_captured_after_warm_up=0,
             step_keys=fork_keys,
             fork={k: v - before["fork"][k] for k, v in snap["fork"].items()
                   if k != "shared_blocks"},
             peak_blocks_used=peak,
             peak_blocks_used_unforked_x4=upeak,
             tpot_median_s={"forked": tpot(groups),
                            "unforked_x4": tpot(_branches(uhs))},
             seconds_unforked_x4=usec,
             unforked_decode_steps=usnap["throughput"]["decode_steps"],
             branch0_equal_n1_tokens=compared,
             scores=[[r.score for r in res] for res in groups],
             table=dict(step=real["step"], p_limit=real["p_limit"],
                        most_slots_on_one_block=int(n_share.max()))),
         "tree": tree, "preemption": pressure,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return dict(real, launches=counts["launches"])


def structured_vocab(seed=0, size=50257):
    """A stand-in for GPT-2's vocabulary (the repo holds no tokenizer):
    the 256 single characters, then strings of 2-4 characters from a
    numpy seed over the schema's alphabet and a few others."""
    import string

    rng = np.random.RandomState(seed)
    alpha = list(string.ascii_letters + string.digits + '{}":,_ -.\n[]')
    out = [chr(c) for c in range(256)]
    while len(out) < size:
        out.append("".join(rng.choice(alpha, rng.randint(2, 5))))
    return out


class _MaskClock:
    """An automaton that times its wrapped automaton's ``mask`` calls, a
    state's first visit (the mask built) apart from memoized ones."""

    def __init__(self, a):
        self.a, self.vocab_size = a, a.vocab_size
        self.first, self.memo = [], []

    def initial(self):
        return self.a.initial()

    def advance(self, state, token):
        return self.a.advance(state, token)

    def done(self, state):
        return self.a.done(state)

    def mask(self, state):
        fresh = state not in self.a._mask_memo
        t0 = time.perf_counter()
        m = self.a.mask(state)
        (self.first if fresh else self.memo).append(time.perf_counter() - t0)
        return m


def masked_greedy_oracle(model, prompts, automaton, n_new):
    """Structured greedy decoding without the engine: dense ``prefill``
    and ``decode_step`` in float32, each row's logits
    ``masked_fill(~mask, NEG_INF).argmax()`` under its automaton state,
    until every row's automaton completes.  Returns the token rows."""
    from singa_tpu_torch.models import gpt2_decode as gd

    cfg = model.cfg
    params = gd.extract_params(model)
    rows = [np.asarray(p, np.int32) for p in prompts]
    out = [[] for _ in rows]
    states = [automaton.initial() for _ in rows]
    with torch.no_grad():
        kc, vc, logits, lens = gd._prefill_rows(params, rows, n_new, cfg)
        pos = torch.as_tensor(lens, device=DEVICE)
        for _ in range(n_new):
            live = [not automaton.done(s) for s in states]
            if not any(live):
                break
            masks = torch.as_tensor(np.stack([
                automaton.mask(s) if ok else np.ones(cfg.vocab_size, bool)
                for s, ok in zip(states, live)]), device=DEVICE)
            toks = logits.float().masked_fill(~masks, gd.NEG_INF).argmax(-1)
            for r, t in enumerate(toks.tolist()):
                if live[r]:
                    out[r].append(t)
                    states[r] = automaton.advance(states[r], t)
            x = (params["wte"][toks] + params["wpe"][pos])[:, None]
            logits, kc, vc = gd.decode_step(params, x, kc, vc, pos,
                                            cfg.n_head,
                                            float(cfg.layer_norm_eps))
            pos = pos + 1
    return [np.concatenate([p, np.asarray(o, np.int32)])
            for p, o in zip(rows, out)]


def check_schema_output(text):
    """Raise unless ``text`` parses as JSON and matches
    ``STRUCT_SCHEMA``."""
    obj = json.loads(text)
    props = STRUCT_SCHEMA["properties"]
    if list(obj) != list(props):
        raise AssertionError(f"structured output keys {list(obj)}")
    if type(obj["id"]) is not int or type(obj["ok"]) is not bool \
            or not isinstance(obj["name"], str) \
            or len(obj["name"]) > props["name"]["maxLength"] \
            or obj["mode"] not in props["mode"]["enum"]:
        raise AssertionError(f"structured output off the schema: {obj}")
    return obj


def phase_structured(model, seed=0):
    """Structured decoding on GPT-2 small (float32, the serve phase's
    engine, captured): ``JsonSchemaAutomaton`` over ``STRUCT_SCHEMA``
    (integer, boolean, string and enum properties) and a 50257-string
    vocabulary from a seed (``structured_vocab``).  ``STRUCT_REQUESTS``
    greedy requests, twice on one engine: each stream equals the
    masked-greedy oracle (``masked_greedy_oracle``), parses with
    ``json.loads`` and matches the schema, retires ``"stop"``; the second
    pass captures no graph and is the path whose ``paged_attn`` launches
    the kernels line adds to the ``paged_attn`` row.  The host time a
    step spent building masks (steps with a state's first visit apart
    from memoized ones) and the TPOT beside the same requests
    unconstrained.  Then one ``n = 2`` sampled structured request: both
    branches valid.  Returns the second pass's launches."""
    from singa_tpu_torch.serve import (GenerationRequest,
                                       JsonSchemaAutomaton, jit_cache_size)

    marks = [("start", time.perf_counter())]
    cfg = model.cfg
    vocab = structured_vocab(seed, cfg.vocab_size)
    auto = JsonSchemaAutomaton(STRUCT_SCHEMA, vocab,
                               max_digits=STRUCT_MAX_DIGITS)
    clock = _MaskClock(auto)
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(*STRUCT_PROMPTS))
               .astype(np.int32) for _ in range(STRUCT_REQUESTS)]
    eng = fork_engine(model)
    inner = eng._mask_pass
    pass_ms = []

    def timed_pass():
        n0 = len(clock.first)
        t0 = time.perf_counter()
        out = inner()
        pass_ms.append(((time.perf_counter() - t0) * 1e3,
                        len(clock.first) > n0))
        return out

    eng._mask_pass = timed_pass
    streams, results = [], []
    for p in range(2):
        census = jit_cache_size()
        if p:
            _reset_paged_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [eng.submit(GenerationRequest(
            x, max_new_tokens=STRUCT_NEW, structured=clock,
            request_id=f"s{p}.{i}")) for i, x in enumerate(prompts)]
        fork_drain(eng)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        results.append([h.result() for h in hs])
        streams.append([r.tokens for r in results[-1]])
        if p and jit_cache_size() != census:
            raise AssertionError("structured: the second pass captured a "
                                 "graph")
    launches = _paged_counts()["launches"]
    keys = sorted(map(str, eng._steps))
    eng.close()
    marks.append(("engine", time.perf_counter()))
    want = masked_greedy_oracle(model, prompts, auto, STRUCT_NEW)
    marks.append(("oracle", time.perf_counter()))
    texts = []
    for i, w in enumerate(want):
        for s_, r in zip(streams, results):
            if not np.array_equal(s_[i], w):
                raise AssertionError(f"structured request {i}: the engine's "
                                     f"stream differs from the masked-greedy "
                                     f"oracle")
            if r[i].finish_reason != "stop":
                raise AssertionError(f"structured request {i} finished "
                                     f"{r[i].finish_reason!r}")
        text = "".join(vocab[t] for t in w[len(prompts[i]):])
        check_schema_output(text)
        texts.append(text)

    eng = fork_engine(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    free = [eng.submit(GenerationRequest(x, max_new_tokens=STRUCT_NEW))
            for x in prompts]
    fork_drain(eng)
    torch.cuda.synchronize()
    free_sec = time.perf_counter() - t0
    eng.close()
    eng = fork_engine(model)
    fh = eng.submit(GenerationRequest(prompts[0], max_new_tokens=STRUCT_NEW,
                                      temperature=FORK_TEMP, seed=seed, n=2,
                                      structured=auto))
    fork_drain(eng)
    eng.close()
    branch_texts = []
    for r in fh.results():
        if r.finish_reason != "stop":
            raise AssertionError(f"structured n = 2: a branch finished "
                                 f"{r.finish_reason!r}")
        branch_texts.append("".join(vocab[t]
                                    for t in r.tokens[len(prompts[0]):]))
        check_schema_output(branch_texts[-1])
    marks.append(("unconstrained_and_n2", time.perf_counter()))

    def med(xs):
        return statistics.median(xs) if xs else None

    log({"phase": "structured", "model": "gpt2-small", "dtype": "float32",
         "engine": SERVE_ENGINE, "schema": STRUCT_SCHEMA,
         "vocab": "256 single characters + 2-4-character strings from a "
                  "seed (no GPT-2 tokenizer in the repo)",
         "requests": STRUCT_REQUESTS, "outputs": texts,
         "streams_equal_masked_greedy_oracle": True,
         "graphs_captured_second_pass": 0, "step_keys": keys,
         "paged_attn_launches_second_pass": launches,
         "mask_ms": {"first_visit_per_state": med([t * 1e3
                                                   for t in clock.first]),
                     "memoized_per_state": med([t * 1e3
                                                for t in clock.memo]),
                     "states_built": len(clock.first),
                     "pass_ms_steps_with_a_first_visit": med(
                         [m for m, f in pass_ms if f]),
                     "pass_ms_memoized_steps": med(
                         [m for m, f in pass_ms if not f])},
         "tpot_median_s": {
             "structured_second_pass": med([r.tpot for r in results[1]
                                            if r.tpot is not None]),
             "unconstrained": med([h.result().tpot for h in free
                                   if h.result().tpot is not None])},
         "seconds_second_pass": sec, "seconds_unconstrained": free_sec,
         "n2_branches": branch_texts,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return launches


# ------------------------------------------------------------------- beam

BEAM = dict(beams=4, prompts=8, prompt_len=64, ragged=(33, 65), new=32)
#: a beam's total (32 float32 log-probabilities, about -270) against its
#: rescoring by one prefill, whose logits differ from the decode steps'
#: by float32 rounding
BEAM_RESCORE_ATOL = 5e-3


def beam_rescore(params, cfg, prompt, seqs):
    """Each continuation in ``seqs`` (K, n) after ``prompt``, scored by one
    teacher-forced float32 ``prefill``: the sum of its tokens'
    log-probabilities, (K,)."""
    from singa_tpu_torch.models import gpt2_decode as gd

    n = seqs.shape[1]
    ids = torch.cat([torch.as_tensor(prompt, device=seqs.device).long()
                     .expand(len(seqs), -1), seqs], 1)
    with torch.no_grad():
        hidden, _, _ = gd.prefill(params, ids, cfg.n_head,
                                  float(cfg.layer_norm_eps))
        lp = torch.log_softmax(gd._logits(hidden[:, len(prompt) - 1:-1],
                                          params).float(), -1)
    return lp.gather(-1, seqs[..., None])[..., 0].sum(-1)


def phase_beam(model, seed=0):
    """``generate_beam`` on GPT-2 small: ``BEAM["beams"]`` beams, 8 prompts
    of 64 tokens in one batch and 8 ragged ones (33-64 tokens), 32 new
    tokens.  float32: one beam equals greedy ``generate`` token for token;
    every beam's total log-probability (``_beam_search``) equals its
    teacher-forced rescoring (``beam_rescore``, atol ``BEAM_RESCORE_ATOL``)
    and the beams come best first; the top beam's total beside one
    beam's (greedy's), logged with the prompts where it is lower (4 beams
    can prune greedy's prefix).  bf16: ms a generated token of
    ``generate_beam`` beside greedy ``generate``'s on the same prompts
    (one warm-up call each, then one timed).  Beam search runs on the
    dense cache, as the JAX package's does: no hand-written kernel."""
    from singa_tpu_torch.models import gpt2_decode as gd

    b = BEAM
    cfg = model.cfg
    rng = np.random.RandomState(seed)
    sets = {"batch": [rng.randint(0, cfg.vocab_size, b["prompt_len"])
                      .astype(np.int32) for _ in range(b["prompts"])],
            "ragged": [rng.randint(0, cfg.vocab_size,
                                   rng.randint(*b["ragged"]))
                       .astype(np.int32) for _ in range(b["prompts"])]}
    params = gd.extract_params(model)
    out = {}
    for name, prompts in sets.items():
        one = gd.generate_beam(model, prompts, max_new_tokens=b["new"],
                               num_beams=1)
        greedy = gd.generate(model, prompts, max_new_tokens=b["new"],
                             temperature=0)
        for o, g in zip(one, greedy):
            if not np.array_equal(o, g):
                raise AssertionError(f"beam {name}: one beam differs from "
                                     f"greedy generate")
        with torch.no_grad():
            seqs, scores = gd._beam_search(params, prompts, b["new"], cfg,
                                           b["beams"])
            _, s1 = gd._beam_search(params, prompts, b["new"], cfg, 1)
        err = 0.0
        for p, sq, sc in zip(prompts, seqs, scores):
            err = max(err, (beam_rescore(params, cfg, p, sq)
                            - sc).abs().max().item())
            if not (sc[:-1] >= sc[1:]).all():
                raise AssertionError(f"beam {name}: beams not best first")
        if not err <= BEAM_RESCORE_ATOL:
            raise AssertionError(f"beam {name}: a beam's total differs from "
                                 f"its teacher-forced rescoring by {err}")
        top, g1 = scores[:, 0].cpu().numpy(), s1[:, 0].cpu().numpy()
        full = gd.generate_beam(model, prompts, max_new_tokens=b["new"],
                                num_beams=b["beams"])
        for f, s_, p in zip(full, seqs.cpu().numpy(), prompts):
            if not np.array_equal(f[len(p):], s_[0]):
                raise AssertionError(f"beam {name}: generate_beam is not "
                                     f"the top beam")
        timed = {}
        for what, fn in (
                ("beam", lambda: gd.generate_beam(
                    model, prompts, max_new_tokens=b["new"],
                    num_beams=b["beams"], dtype=torch.bfloat16)),
                ("greedy_generate", lambda: gd.generate(
                    model, prompts, max_new_tokens=b["new"], temperature=0,
                    dtype=torch.bfloat16))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            timed[what] = (time.perf_counter() - t0) * 1e3 / (
                len(prompts) * b["new"])
            if any(r.min() < 0 or r.max() >= cfg.vocab_size for r in res):
                raise AssertionError(f"beam {name} bf16: a token off the "
                                     f"vocabulary")
        out[name] = dict(prompt_lens=[len(p) for p in prompts],
                         one_beam_equals_greedy=True,
                         rescore_max_abs_err=err,
                         top_beam_logprob=top.tolist(),
                         greedy_logprob=g1.tolist(),
                         prompts_top_beam_below_greedy=np.flatnonzero(
                             top < g1).tolist(),
                         bf16_ms_per_generated_token=timed)
    log({"phase": "beam", "model": "gpt2-small", "beams": b["beams"],
         "new_tokens": b["new"], "rescore_atol": BEAM_RESCORE_ATOL, **out,
         "nvidia_smi": nvidia_smi()})


# ------------------------------------------------------------ observe

#: the observe phase's SLO: targets the bf16 serve traffic can breach (a
#: 24-request burst into 8 slots queues 16), so the violation counters
#: move; float32 runs count against the same targets
OBSERVE_SLO = dict(ttft_p99_s=0.5, tpot_p50_s=0.02, queue_depth_max=8)
#: the shedding run: a priority scheduler whose queue may hold this many
#: before SLO-pressure admission sheds
SHED_QUEUE_MAX = 4


@contextlib.contextmanager
def observe_hooks(ledger=False, prof=False, mon=False, trace=False):
    """The observability hooks asked for, on for the block and off after
    (the request ledger, the step profiler, the monitor's watchdog and
    recorder without its thread, tracing)."""
    from singa_tpu_torch.observe import monitor, requests, stepprof
    from singa_tpu_torch.observe import trace as tr

    if ledger:
        requests.enable(capacity=4096)
    if prof:
        stepprof.enable(ring=4096)
    if mon:
        monitor.start(thread=False)
    if trace:
        tr.clear()
        tr.enable()
    try:
        yield
    finally:
        if trace:
            tr.disable()
        if mon:
            monitor.stop()
        if prof:
            stepprof.disable(unregister=False)
        if ledger:
            requests.disable()


def observed_run(model, traffic, dtype=None, slo=None, per_step=None,
                 after=None):
    """The serve traffic twice on one paged engine (``SERVE_ENGINE``): a
    warm-up pass that captures every decode width, then the measured
    pass, which must capture no graph and launch ``paged_attn`` 12 times
    a decode step (the count set to 0 just before it, read just after).
    ``per_step(eng)`` runs after each measured step; ``after(eng)`` on the
    engine before it closes.  Returns ``(results of the measured pass,
    its paged_attn launches, its decode steps, its seconds, the
    engine's stats snapshot)``."""
    from singa_tpu_torch.ops import paged_attention as pa
    from singa_tpu_torch.serve import (GenerationRequest, PagedConfig,
                                       jit_cache_size)

    c = SERVE_ENGINE
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype, slo=slo,
                      paged=PagedConfig(block_size=c["block_size"],
                                        num_blocks=c["num_blocks"]))

    def submit(tag):
        return [eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            request_id=f"{tag}{i}")) for i, w in enumerate(traffic)]

    submit("w")
    drain_counting_graphs(eng)
    graphs, census = len(eng._steps), jit_cache_size()
    steps0 = eng.stats.decode_steps
    torch.cuda.synchronize()
    pa.paged_attn.launches = 0
    t0 = time.perf_counter()
    hs = submit("r")
    while eng.pending:
        eng.step()
        if per_step is not None:
            per_step(eng)
        if len(eng._steps) != graphs or jit_cache_size() != census:
            raise AssertionError(f"a graph was captured after warm-up: "
                                 f"widths {sorted(eng._steps)}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pa.paged_attn.launches
    steps = eng.stats.decode_steps - steps0
    if launches != model.cfg.n_layer * steps:
        raise AssertionError(f"paged_attn launched {launches} times over "
                             f"{steps} decode steps")
    results = [h.result() for h in hs]
    if any(r.finish_reason != "length" for r in results):
        raise AssertionError("a measured request did not complete")
    if after is not None:
        after(eng)
    snap = eng.stats.snapshot()
    eng.check_block_accounting()
    eng.close()
    return results, launches, steps, seconds, snap


def _tpot_ms(results):
    return statistics.median(r.tpot for r in results
                             if r.tpot is not None) * 1e3


def phase_observe(model, real, seed=0):
    """The serve phase's model, arena and requests with every
    observability hook on (module docstring, phase 14g).  Returns the
    ``paged_attn`` launches of its measured passes."""
    from singa_tpu_torch.observe import SLO, requests, stepprof
    from singa_tpu_torch.observe.registry import registry

    traffic, want = real["traffic"], real["offline"]
    slo = SLO(**OBSERVE_SLO)
    launches = 0
    out = {"phase": "observe", "slo": OBSERVE_SLO}

    # float32: every hook on, then every hook off; the greedy and the
    # seeded streams equal (and equal offline generate, as in the serve
    # phase); each request's ledger TTFT equals its handle's
    ttfts = {}
    with observe_hooks(ledger=True, prof=True, mon=True, trace=True):
        on, n, steps, sec_on, snap_on = observed_run(
            model, traffic, slo=slo,
            after=lambda eng: out.__setitem__("export", export_files(eng)))
        led = {e["request_id"]: e for e in requests.ledger().entries()}
        for r in on:
            e = led[r.request_id]
            if e["outcome"] != "length" or e["ttft_s"] != r.ttft:
                raise AssertionError(f"{r.request_id}: ledger TTFT "
                                     f"{e['ttft_s']} != the handle's "
                                     f"{r.ttft}")
            ttfts[r.request_id] = r.ttft
        anatomy = stepprof.section()
    launches += n
    off, n, _, sec_off, _ = observed_run(model, traffic)
    launches += n
    for i, (a, b, c) in enumerate(zip(on, off, want)):
        if not (np.array_equal(a.tokens, b.tokens)
                and np.array_equal(a.tokens, c)):
            raise AssertionError(f"float32 request {i}: the stream with "
                                 f"the hooks on differs from the one with "
                                 f"them off or from offline generate")
    out["float32"] = {
        "streams_equal_hooks_on_off_and_generate": True,
        "decode_steps": steps, "seconds_hooks_on": sec_on,
        "seconds_hooks_off": sec_off, "no_graph_after_warm_up": True,
        "ledger_ttft_equals_handle": len(ttfts),
        "slo_violations": snap_on["slo"]["violations"],
        "step_anatomy": {k: v for k, v in anatomy.items()
                         if k != "engines"},
        "watchdog_hangs": out["export"].pop("watchdog_hangs")}

    # bf16, one call: TPOT with the hooks off, with the ledger, monitor
    # and SLO on, and with the step profiler on
    bf = torch.bfloat16
    tpot = {}
    res, n, _, _, _ = observed_run(model, traffic, dtype=bf)
    tpot["hooks_off"], launches = _tpot_ms(res), launches + n
    with observe_hooks(ledger=True, mon=True):
        res, n, _, _, snap = observed_run(model, traffic, dtype=bf, slo=slo)
    tpot["ledger_monitor_slo"], launches = _tpot_ms(res), launches + n
    bf_viol = snap["slo"]["violations"]
    with observe_hooks(prof=True):
        res, n, _, _, _ = observed_run(
            model, traffic, dtype=bf,
            after=lambda eng: out.__setitem__(
                "stepprof_vs_profiler", stepprof_window(eng, traffic)))
    tpot["stepprof"], launches = _tpot_ms(res), launches + n
    out["bf16"] = {"tpot_median_ms": tpot, "slo_violations": bf_viol}

    out["registry_metrics"] = len(registry().metrics())
    out["nvidia_smi"] = nvidia_smi()
    log(out)
    return launches


def export_files(eng):
    """With every hook on and ``eng`` still open: ``health_report()`` JSON
    (with the engine's snapshot), Prometheus text and a Chrome trace (the
    trace buffer's spans, the ledger's request tracks, the profiler's
    step lanes) written to a temporary directory; their sizes, the
    trace's events and the report's keys."""
    import tempfile

    from singa_tpu_torch.observe import (export, health_report, requests,
                                         stepprof)
    from singa_tpu_torch.observe import trace as tr

    events = tr.events()
    if not any(e["name"] == "serve/decode_step" for e in events):
        raise AssertionError("tracing recorded no decode step")
    with tempfile.TemporaryDirectory() as d:
        rep = health_report(engine_snapshots=[eng.stats.snapshot()])
        paths = {n: os.path.join(d, n) for n in ("health.json",
                                                 "metrics.prom",
                                                 "trace.json")}
        with open(paths["health.json"], "w") as f:
            json.dump(export.json_sanitize(rep), f)
        export.write_prometheus(paths["metrics.prom"])
        n_ev = export.write_chrome_trace(
            paths["trace.json"], events, requests=requests.ledger().entries(),
            steps=stepprof.records())
        json.load(open(paths["health.json"]))
        json.load(open(paths["trace.json"]))
        prom = open(paths["metrics.prom"]).read()
        for name in ("serve_tpot_bucket", "serve_step_wall_s_bucket",
                     "serve_slo_violations"):
            if f"singa_tpu_{name}" not in prom:
                raise AssertionError(f"the Prometheus text has no {name}")
        if not rep["serve"]["why_slow"].get("enabled") \
                or not rep["serve"]["step_anatomy"].get("enabled") \
                or not rep["watchdog"]["active"]:
            raise AssertionError("health_report is missing a live section")
        return {"bytes": {k: os.path.getsize(p) for k, p in paths.items()},
                "trace_events": len(events), "chrome_trace_events": n_ev,
                "health_report_keys": sorted(rep),
                "health_serve_keys": sorted(rep["serve"]),
                "watchdog_hangs": rep["watchdog"]["hangs"]}


def stepprof_window(eng, traffic, warm=40, steps=20):
    """The step profiler's device span of ``steps`` engine steps (the
    sum of its records' device windows, after ``warm`` steps of the
    traffic) beside torch.profiler's device time of the same steps; then
    the engine drains."""
    from singa_tpu_torch.observe import stepprof
    from singa_tpu_torch.serve import GenerationRequest

    for i, w in enumerate(traffic):
        eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            request_id=f"p{i}"))
    for _ in range(warm):
        eng.step()
    prof = profile_steps(lambda _x, _y: eng.step(), None, None, steps=steps,
                         groups=SERVE_GROUPS)
    lbl = eng.stats.engine_label
    recs = [r for r in stepprof.records() if r["engine"] == lbl][-steps:]
    while eng.pending:
        eng.step()
    span = sum(r["device_s"] for r in recs) * 1e3 / steps
    wall = sum(r["wall_s"] for r in recs) * 1e3 / steps
    return {"steps": steps, "stepprof_device_ms_per_step": span,
            "stepprof_wall_ms_per_step": wall,
            "stepprof_bubble_frac": statistics.mean(
                r["bubble_frac"] for r in recs),
            "profiler_device_ms_per_step": prof["device_ms_per_step"],
            "profiler_wall_ms_per_step": prof["wall_ms_per_step"],
            "segments_ms_per_step": {
                k: sum(r["segments"].get(k, 0.0) for r in recs) * 1e3
                / steps for k in sorted({k for r in recs
                                         for k in r["segments"]})}}


def phase_supervisor(model, real, seed=0):
    """``EngineSupervisor`` over the serve phase's engine (module
    docstring, phase 14h).  Returns the ``paged_attn`` launches of the
    supervised run."""
    from singa_tpu_torch.observe import SLO
    from singa_tpu_torch.observe.registry import registry
    from singa_tpu_torch.ops import paged_attention as pa
    from singa_tpu_torch.resilience import FailAfterN, FailRate, faults
    from singa_tpu_torch.serve import (EngineFailedError, EngineSupervisor,
                                       GenerationRequest, LoadShedError,
                                       PagedConfig,
                                       RestartBudgetExceededError)

    traffic, want = real["traffic"], real["offline"]
    c = SERVE_ENGINE
    paged = dict(block_size=c["block_size"], num_blocks=c["num_blocks"])
    out = {"phase": "supervisor", "engine": SERVE_ENGINE}

    def submit(sup, tag, ws, **kw):
        return [sup.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            request_id=f"{tag}{i}", **kw)) for i, w in enumerate(ws)]

    # one injected decode fault: one restart; the requests the dead
    # engine had not started are requeued and stream as uninterrupted
    # (float32: offline generate), those in flight fail typed
    restarts0 = registry().counter("resilience.engine_restarts").value
    sup = EngineSupervisor(model, restart_budget=2,
                           max_slots=c["max_slots"],
                           paged=PagedConfig(**paged))
    first = sup.engine
    rebuild = {}
    recover = sup._recover

    def timed_recover():
        t0 = time.perf_counter()
        recover()
        torch.cuda.synchronize()
        rebuild["seconds"] = time.perf_counter() - t0

    sup._recover = timed_recover
    hs = submit(sup, "s", traffic)
    pa.paged_attn.launches = 0
    faults.inject("serve.decode_step", FailAfterN(2, times=1))
    capture_s, steps_after = 0.0, 0
    try:
        while sup.pending:
            eng = sup.engine
            n = len(eng._steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sup.step()
            torch.cuda.synchronize()
            if sup.engine is eng and eng is not first:
                steps_after += 1
                if len(eng._steps) > n:
                    # the step that ran eagerly and captured a width
                    capture_s += time.perf_counter() - t0
    finally:
        faults.clear()
    launches = pa.paged_attn.launches
    second = sup.engine
    steps = first.stats.decode_steps + second.stats.decode_steps
    if launches != model.cfg.n_layer * steps:
        raise AssertionError(f"supervised: paged_attn launched {launches} "
                             f"times over {steps} decode steps")
    restarts = registry().counter("resilience.engine_restarts").value \
        - restarts0
    if sup.restarts != 1 or restarts != 1 or second is first:
        raise AssertionError(f"expected one restart, got {sup.restarts} "
                             f"({restarts} counted)")
    requeued, failed = 0, 0
    for i, h in enumerate(hs):
        try:
            toks = h.result().tokens
        except EngineFailedError as e:
            if e.started is not True or type(e) is not EngineFailedError:
                raise AssertionError(f"request {i} failed untyped: {e!r}")
            failed += 1
            continue
        if not np.array_equal(toks, want[i]):
            raise AssertionError(f"requeued request {i}: its stream "
                                 f"differs from the uninterrupted run")
        requeued += 1
    if not requeued or not failed:
        raise AssertionError(f"the fault did not land mid-stream: "
                             f"{requeued} requeued, {failed} failed")
    second.check_block_accounting()
    graphs_after = len(second._steps)
    sup.close()
    out["restart"] = {
        "restarts": 1, "requeued_streams_equal_uninterrupted": requeued,
        "in_flight_failed_typed": failed,
        "rebuild_seconds": rebuild["seconds"],
        "graphs_captured_after_restart": graphs_after,
        "capture_step_seconds_after_restart": capture_s,
        "decode_steps_before_fault": first.stats.decode_steps,
        "decode_steps_after_restart": second.stats.decode_steps,
        "paged_attn_launches": launches}

    # FailRate(1.0): every engine dies; the budget runs out typed
    sup = EngineSupervisor(model, restart_budget=1,
                           max_slots=c["max_slots"],
                           paged=PagedConfig(**paged))
    # 8 admit and fail in flight, the 16 queued are requeued and 8 of
    # them fail the rebuilt engine: the second restart is past the budget
    hs = submit(sup, "b", traffic)
    faults.inject("serve.decode_step", FailRate(1.0, seed=seed))
    try:
        sup.run_until_complete(max_steps=100)
        raise AssertionError("the restart budget was not exhausted")
    except RestartBudgetExceededError:
        pass
    finally:
        faults.clear()
    kinds = sorted({type(h._error).__name__ for h in hs})
    if not all(h.done() and isinstance(h._error, EngineFailedError)
               for h in hs) or sup.pending:
        raise AssertionError(f"handles left unresolved after the budget "
                             f"ran out: {kinds}")
    try:
        submit(sup, "x", traffic[:1])
        raise AssertionError("a dead supervisor took a request")
    except RestartBudgetExceededError:
        pass
    sup.close(force=True)
    out["budget"] = {"restart_budget": 1, "restarts": sup.restarts,
                     "errors": kinds}

    # SLO-pressure shedding: a burst of the 24 requests at priorities 0-2
    # into a priority scheduler whose SLO allows SHED_QUEUE_MAX queued
    counts0 = {r: registry().counter("serve.shed_requests",
                                     reason=r).value
               for r in ("slo_pressure", "slo_admission")}
    sup = EngineSupervisor(model, shed_on_slo_pressure=True,
                           slo=SLO(queue_depth_max=SHED_QUEUE_MAX),
                           scheduler="priority", max_slots=c["max_slots"],
                           paged=PagedConfig(**paged), dtype=torch.bfloat16)
    hs, refused = [], 0
    for i, w in enumerate(traffic):
        try:
            hs.append(sup.submit(GenerationRequest(
                w["prompt"], max_new_tokens=w["max_new"],
                temperature=w["temperature"], seed=w["seed"],
                request_id=f"q{i}", priority=i % 3)))
        except LoadShedError:
            refused += 1
    shed = sum(1 for h in hs if h.done())
    sup.run_until_complete(max_steps=5000)
    counts = {r: registry().counter("serve.shed_requests",
                                    reason=r).value - counts0[r]
              for r in counts0}
    shed_err = 0
    for h in hs:
        try:
            h.result()
        except LoadShedError:
            shed_err += 1
    if shed_err != shed or counts["slo_pressure"] != shed \
            or counts["slo_admission"] != refused or not shed + refused:
        raise AssertionError(f"shedding: {shed} shed handles "
                             f"({shed_err} raising LoadShedError), "
                             f"{refused} refused, counters {counts}")
    sup.close()
    out["shedding"] = {"queue_depth_max": SHED_QUEUE_MAX,
                       "burst": len(traffic), "shed_queued": shed,
                       "refused_on_arrival": refused,
                       "counters": counts,
                       "completed": len(hs) - shed}
    out["nvidia_smi"] = nvidia_smi()
    log(out)
    return launches


# ------------------------------------------------------------------ fleet

#: the fleet phase's replicas: the serve phase's engine with a prefix
#: cache of its block size (the ship format is the paged image, and a
#: replica's residency lives in its radix tree), engine-wide top-k 50
FLEET_REPLICAS = 3
FLEET_TOP_K = 50
FLEET_TEMP = 0.8
#: the disaggregated prefill's long prompts: 512-960 tokens, 32-64 new
FLEET_LONG = 4
#: threefry's known answers, as ``jax.random`` gives them (JAX 0.9.0) at
#: PRNGKey(42): split in 3, fold_in 7, 8 bits, 4 uniforms' bits; and the
#: last 7 of bits(PRNGKey(1), (2, 50257)) (the counter past a row of
#: GPT-2's vocabulary)
THREEFRY_KNOWN = dict(
    split3=[[1832780943, 270669613], [64467757, 2916123636],
            [2465931498, 255383827]],
    fold_in7=[2547012911, 1371500959],
    bits8=[2098992034, 2919706841, 2646866425, 2409546199, 1935504149,
           2516274904, 321304473, 3329172656],
    uniform4_bits=[1056585764, 1059981104, 1058915320, 1057988288],
    row_tail=[3015957629, 4147172050, 4260404170, 2641025899, 4003422046,
              699060600, 3255117096])
#: the card's Gumbels against numpy's: their two float32 logarithms may
#: round apart, a few ulp of the value (bits and uniforms: exactly)
GUMBEL_TOL = dict(rtol=2.0 ** -20, atol=2.0 ** -20)


def fleet_traffic(seed=0, vocab=50257):
    """The serve phase's 24 requests, the sampled half at
    ``FLEET_TEMP``."""
    return [dict(w, temperature=FLEET_TEMP if w["temperature"] > 0 else 0.0)
            for w in serve_traffic(seed, vocab=vocab)]


def fleet_long_traffic(seed=0, vocab=50257):
    """``FLEET_LONG`` + 1 long prompts (512-960 tokens, 32-64 new),
    alternately greedy and sampled: the disaggregated prefill's requests
    and one more."""
    rng = np.random.RandomState(seed + 17)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(512, 961))
                 .astype(np.int32), max_new=int(rng.randint(32, 65)),
                 temperature=0.0 if i % 2 == 0 else FLEET_TEMP,
                 seed=int(rng.randint(0, 2 ** 31 - 1)))
            for i in range(FLEET_LONG + 1)]


def threefry_check(dev, rows=8, vocab=50257, seed=0):
    """The device draw against the host chain: bits and uniforms of an
    (rows, vocab) draw, one key a row, bit for bit; Gumbels within
    ``GUMBEL_TOL``; the known answers; and the draw's device ms (a
    categorical over bf16-step-shaped float32 logits)."""
    from singa_tpu_torch.ops import prng

    keys = prng.split(prng.PRNGKey(seed), rows)
    kt = prng.key_words(keys, dev)
    bits = prng.random_bits_t(kt, vocab).cpu().numpy()
    want = prng.random_bits(keys, (vocab,))
    if not (bits == want).all():
        raise AssertionError("threefry: the card's bits differ from the "
                             "host chain's")
    u = prng.uniform_t(kt, vocab).cpu().numpy()
    if not (u.view(np.uint32) == prng.uniform(keys, (vocab,))
            .view(np.uint32)).all():
        raise AssertionError("threefry: the card's uniforms differ")
    g = prng.gumbel_t(kt, vocab).cpu().numpy()
    g_host = prng.gumbel(keys, (vocab,))
    g_err = float(np.abs(g - g_host).max())
    if not np.allclose(g, g_host, **GUMBEL_TOL):
        raise AssertionError(f"threefry: Gumbels differ by {g_err}")
    k42 = prng.key_words(prng.PRNGKey(42), dev)
    k1 = prng.key_words(prng.PRNGKey(1), dev)
    known = dict(
        split3=prng.split_t(k42, 3).tolist(),
        fold_in7=prng.fold_in(prng.PRNGKey(42), 7).tolist(),
        bits8=prng.random_bits_t(k42, 8).tolist(),
        uniform4_bits=prng.uniform_t(k42, 4).cpu().numpy().view(np.uint32)
        .tolist(),
        row_tail=prng.random_bits_t(k1, 2 * 50257)[50257 + 50250:]
        .tolist())
    if known != THREEFRY_KNOWN:
        raise AssertionError(f"threefry known answers: {known}")
    logits = torch.randn(rows, vocab, device=dev)
    ms = device_ms_per_call(lambda: prng.categorical_t(kt, logits), 20)
    return {"rows": rows, "vocab": vocab, "bits_equal": True,
            "uniforms_equal": True, "gumbel_max_abs_err": g_err,
            "known_answers_equal": True, "draw_device_ms": ms}


FLEET_EVENTS = ("serve/fleet_failover", "serve/fleet_requeue",
                "serve/fleet_failover_done", "serve/dist_resume")


@contextlib.contextmanager
def fleet_trace():
    """Trace the block and yield ``{name: [event, ...]}`` of the fleet's
    failover and resume instants (``FLEET_EVENTS``: a replica down, each
    requeue, the failover's end, a resumed session with its seconds),
    filled when the block ends; their ``ts`` are ``perf_counter``
    seconds."""
    from singa_tpu_torch.observe import trace as tr

    out = {n: [] for n in FLEET_EVENTS}
    tr.clear()
    tr.enable()
    try:
        yield out
    finally:
        tr.disable()
        for e in tr.drain():
            if e["name"] in out:
                out[e["name"]].append(e)


class _FirstTokens:
    """``on_token`` clock: each request's first-token time
    (``perf_counter``)."""

    def __init__(self):
        self.first = {}

    def __call__(self, request, token):
        self.first.setdefault(request.request_id, time.perf_counter())


def fleet_submit(fleet, traffic, tag, clock=None, **kw):
    """Submit ``traffic`` to ``fleet`` (request ids ``tag<i>``); with
    ``clock`` (a ``_FirstTokens``) each request streams its tokens to it
    and its submit time is kept there too."""
    from singa_tpu_torch.serve import GenerationRequest

    hs = []
    for i, w in enumerate(traffic):
        if clock is not None:
            clock.first.setdefault(("submit", f"{tag}{i}"),
                                   time.perf_counter())
        hs.append(fleet.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            request_id=f"{tag}{i}",
            on_token=clock, **kw)))
    return hs


def fleet_drain(fleet, hs, want, what, max_steps=20000):
    """Drive ``fleet`` until it drains; every handle's stream equals
    ``want``'s (None: the request must have failed typed, started).
    Returns the failed count."""
    from singa_tpu_torch.serve import EngineFailedError

    fleet.run_until_complete(max_steps=max_steps)
    failed = 0
    for i, (h, w) in enumerate(zip(hs, want)):
        try:
            toks = h.result().tokens
        except EngineFailedError as e:
            if e.started is not True:
                raise AssertionError(f"{what} request {i}: failed "
                                     f"{e!r}") from e
            failed += 1
            continue
        if not np.array_equal(toks, w):
            raise AssertionError(f"{what} request {i}: its stream differs "
                                 f"from the reference")
    return failed


def gpt2_small(seed=0):
    """GPT-2 small with random weights from ``seed``: the serve phase's
    model (``--phases fleet`` runs the fleet phase on it alone)."""
    from singa_tpu_torch import device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    dev = device.create_cuda_gpu()
    dev.SetRandSeed(seed)
    model = GPT2LMHead(GPT2Config.small(dropout=0.0))
    model.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), dev)],
                  is_train=False)
    return model


def phase_fleet(model, seed=0):
    """The in-process fleet over GPT-2 small replicas (module docstring,
    phase 14h2).  Returns ``(paged_attn launches of the fleet runs, the
    ship destination's recorded step for row 5d with its launches)``."""
    from singa_tpu_torch import amp, device
    from singa_tpu_torch.ops import paged_attention as pa
    from singa_tpu_torch.resilience import FailAfterN, FailOnce, faults
    from singa_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                       GenerationRequest, PagedConfig,
                                       PrefixCacheConfig)

    marks = {}

    def mark(name, t0=[time.perf_counter()]):
        marks[name] = time.perf_counter() - t0[0]
        t0[0] = time.perf_counter()

    amp.enable(False)
    dev = device.create_cuda_gpu()
    cfg = model.cfg
    c = SERVE_ENGINE
    out = {"phase": "fleet", "replicas": FLEET_REPLICAS,
           "engine": dict(SERVE_ENGINE, prefix_cache_block=c["block_size"],
                          top_k=FLEET_TOP_K)}
    out["threefry"] = threefry_check(dev.torch_device, seed=seed)
    mark("threefry")

    def engine_kw(dtype=None, cache=True, **kw):
        return dict(dict(max_slots=c["max_slots"], dtype=dtype,
                         top_k=FLEET_TOP_K,
                         paged=PagedConfig(block_size=c["block_size"],
                                           num_blocks=c["num_blocks"]),
                         prefix_cache=PrefixCacheConfig(
                             block_size=c["block_size"]) if cache else None),
                    **kw)

    traffic = fleet_traffic(seed, vocab=cfg.vocab_size)
    sampled = [i for i, w in enumerate(traffic) if w["temperature"] > 0]
    # the long prompts: FLEET_LONG shipped at once, one timed alone cold
    # and shipped, one that meets a serve.kv_ship fault
    long = fleet_long_traffic(seed, vocab=cfg.vocab_size) + \
        fleet_long_traffic(seed + 1, vocab=cfg.vocab_size)[:1]
    # apart: one batch's longest generation must fit n_positions
    offline = offline_streams(model, traffic, top_k=FLEET_TOP_K)
    long_off = offline_streams(model, long, top_k=FLEET_TOP_K)
    (alone, fault_req), (alone_off, fault_off) = long[-2:], long_off[-2:]
    long, long_off = long[:FLEET_LONG], long_off[:FLEET_LONG]
    mark("generate")
    # one engine of the replicas' configuration: the fleet's reference
    eng = model.serve(**engine_kw())
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["max_new"],
        temperature=w["temperature"], seed=w["seed"]))
        for w in traffic]
    eng.run_until_complete()
    one = [h.result().tokens for h in hs]
    eng.close()
    _same_streams("one float32 engine vs offline generate", one, offline)
    mark("one_engine")

    pa.paged_attn.launches = 0
    # mixed: 3 replicas, the 24 requests at once, float32; then one long
    # prompt alone, cold, its TTFT clocked
    fleet = model.serve_fleet(replicas=FLEET_REPLICAS, **engine_kw())
    hs = fleet_submit(fleet, traffic, "m")
    fleet_drain(fleet, hs, one, "mixed fleet")
    snap = fleet.snapshot()
    if min(snap["routed"].values()) < 1 or snap["failovers"]:
        raise AssertionError(f"mixed fleet routing: {snap['routed']}")
    out["mixed"] = {"routed": snap["routed"], "requests": len(traffic),
                    "streams_equal_one_engine_and_generate": True,
                    "graphs_by_replica": [len(fleet.supervisor(i).engine
                                              ._steps)
                                          for i in range(FLEET_REPLICAS)]}
    cold_clock = _FirstTokens()
    hs = fleet_submit(fleet, [alone], "c", clock=cold_clock)
    fleet_drain(fleet, hs, [alone_off], "mixed fleet, a long prompt")
    fleet.close()
    mark("mixed")

    # disaggregated prefill: a prefill specialist ships each long
    # prompt's blocks to a decode replica
    fleet = model.serve_fleet(replicas=FLEET_REPLICAS,
                              roles=("prefill", "decode", "decode"),
                              **engine_kw())
    recs = [_StageRecorder(fleet.supervisor(i).engine) for i in (1, 2)]
    ships = []
    complete = fleet._complete_ship

    def timed_ship(sjob, src_rep):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n0 = fleet._c_ship_bytes.value
        complete(sjob, src_rep)
        torch.cuda.synchronize()
        ships.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          bytes=fleet._c_ship_bytes.value - n0))

    fleet._complete_ship = timed_ship
    n0 = pa.paged_attn.launches
    hs = fleet_submit(fleet, long, "d")
    fleet_drain(fleet, hs, long_off, "disaggregated fleet")
    ship_launches = pa.paged_attn.launches - n0
    snap = fleet.snapshot()
    if snap["ships"] != len(long) or snap["ship_fallbacks"] \
            or snap["routed"]["0"]:
        raise AssertionError(f"disaggregated fleet: {snap['ships']} ships, "
                             f"{snap['ship_fallbacks']} fallbacks, "
                             f"routed {snap['routed']}")
    ship_clock = _FirstTokens()
    hs = fleet_submit(fleet, [alone], "s", clock=ship_clock)
    fleet_drain(fleet, hs, [alone_off], "a shipped long prompt")
    ttft = {k: clock.first[f"{tag}0"] - clock.first[("submit", f"{tag}0")]
            for k, tag, clock in (("cold", "c", cold_clock),
                                  ("shipped", "s", ship_clock))}
    # a serve.kv_ship fault: the request requeues cold, its stream kept
    pol = faults.inject("serve.kv_ship", FailOnce())
    try:
        hs = fleet_submit(fleet, [fault_req], "k")
        fleet_drain(fleet, hs, [fault_off], "kv_ship fault")
    finally:
        faults.clear()
    snap = fleet.snapshot()
    if pol.fired != 1 or snap["ship_fallbacks"] != 1:
        raise AssertionError("the serve.kv_ship fault did not fall back")
    for i in range(FLEET_REPLICAS):
        fleet.supervisor(i).engine.check_block_accounting()
    real = max((r.real for r in recs if r.real is not None),
               key=lambda r: (len(r["p_limit"]), sum(r["p_limit"])))
    fleet.close()
    out["disaggregated"] = {
        "roles": ["prefill", "decode", "decode"], "requests": len(long),
        "prompt_lens": [len(w["prompt"]) for w in long],
        "ships": snap["ships"], "ship_bytes": snap["ship_bytes"],
        "ship_ms": [s["ms"] for s in ships],
        "ship_bytes_each": [s["bytes"] for s in ships],
        "alone_prompt_len": len(alone["prompt"]),
        "ttft_alone_cold_s": ttft["cold"],
        "ttft_alone_shipped_s": ttft["shipped"],
        "streams_equal_generate": True,
        "alone_stream_equal_mixed_fleet": True,
        "kv_ship_fault": {"fallbacks": 1, "stream_equal": True},
        "paged_attn_launches": ship_launches}
    mark("disaggregated")

    # failover: one replica's restart budget runs out at an injected
    # decode fault; 2 slots a replica for the 12 sampled requests, so
    # each holds queued ones
    work = [traffic[i] for i in sampled]
    want = [offline[i] for i in sampled]
    fleet = model.serve_fleet(replicas=FLEET_REPLICAS, restart_budget=0,
                              **engine_kw(max_slots=2))
    clock = _FirstTokens()
    hs = fleet_submit(fleet, work, "f", clock=clock)
    faults.inject("serve.decode_step", FailAfterN(4, times=1))
    try:
        with fleet_trace() as ev:
            failed = fleet_drain(fleet, hs, want, "failover")
    finally:
        faults.clear()
    downs = ev["serve/fleet_failover"]
    requeued = [e["args"]["request"] for e in ev["serve/fleet_requeue"]]
    if len(downs) != 1 or not requeued or not failed:
        raise AssertionError(f"failover: {len(downs)} replicas down, "
                             f"{len(requeued)} requeued, {failed} failed")
    dead = next(r.idx for r in fleet._replicas if not r.healthy)
    requeue_s = max(clock.first[r] for r in requeued) - downs[0]["ts"]
    # revive, then hedges: the router pinned to replica 0, whose queue
    # backs up until its requests are re-dispatched to the siblings
    fleet.revive(dead)
    fleet.hedge_after_steps = 2
    rank = fleet.router.rank
    fleet.router.rank = lambda views: sorted(v["replica"] for v in views)
    hs = fleet_submit(fleet, work[:6], "h")
    fleet_drain(fleet, hs, want[:6], "hedged")
    fleet.router.rank = rank
    snap = fleet.snapshot()
    if snap["hedges"] < 1 or snap["failovers"] != 1:
        raise AssertionError(f"hedge: {snap['hedges']} hedges")
    fleet.close()
    out["failover"] = {"max_slots": 2, "requests": len(work),
                       "replica_failed": dead, "requeued": len(requeued),
                       "failed_typed": failed,
                       "requeued_streams_equal_uninterrupted": True,
                       "fault_to_last_requeued_first_token_s": requeue_s,
                       "revived": dead, "hedges": snap["hedges"],
                       "hedged_streams_equal": True}
    mark("failover")

    # the autoscaler under an injected clock: a burst adds a replica,
    # quiet drains one and retires it
    now = [0.0]
    fleet = model.serve_fleet(replicas=1, clock=lambda: now[0],
                              **engine_kw())
    sc = Autoscaler(fleet, AutoscaleConfig(
        min_replicas=1, max_replicas=2, scale_up_cooldown_s=1.0,
        scale_down_cooldown_s=2.0, queue_high=2.0, queue_low=0.5,
        occupancy_high=1.5, occupancy_low=0.6), clock=lambda: now[0])
    hs = fleet_submit(fleet, work[:4], "a")
    if (sc.check() or {}).get("action") != "scale_up" \
            or fleet.replicas != 2:
        raise AssertionError("the burst did not add a replica")
    added = fleet.supervisor(1).engine
    hs += fleet_submit(fleet, work[4:8], "b")
    added_graphs, capture_s = 0, 0.0
    while fleet.pending:
        n = len(added._steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet.step()
        torch.cuda.synchronize()
        if len(added._steps) > n:
            added_graphs += len(added._steps) - n
            capture_s += time.perf_counter() - t0
        now[0] += 0.5
        sc.check()
    fleet_drain(fleet, hs, want[:8], "autoscaled")
    for _ in range(20):
        if any(e["action"] == "drain_done" for e in sc.scaling_events):
            break
        now[0] += 1.0
        sc.check()
    actions = [e["action"] for e in sc.scaling_events]
    if "drain_done" not in actions or not added_graphs \
            or sum(r.retired for r in fleet._replicas) != 1:
        raise AssertionError(f"autoscaler: {actions}, the added replica "
                             f"captured {added_graphs} graphs")
    out["autoscale"] = {"actions": actions,
                        "added_replica_graphs": added_graphs,
                        "added_replica_capture_step_seconds": capture_s,
                        "streams_equal": True}
    sc.close()
    fleet.close()
    launches = pa.paged_attn.launches
    if launches < 1 or ship_launches < 1:
        raise AssertionError(f"the fleet runs launched paged_attn "
                             f"{launches} times ({ship_launches} after "
                             f"ships)")
    mark("autoscale")

    # bf16, no prefix cache (no chunk passes: a decode step's TPOT): 3
    # replicas against one engine on the same 24 requests, each timed
    # after a warm-up pass of 8 requests a replica (every replica then
    # holds every width's graph)
    bf = torch.bfloat16

    def timed(build):
        srv = build()
        fleet = hasattr(srv, "router")
        warm = traffic[:c["max_slots"] * (srv.replicas if fleet else 1)]
        for tag, ws in (("w", warm), ("t", traffic)):
            hs = fleet_submit(srv, ws, tag) if fleet else \
                [srv.submit(GenerationRequest(
                    w["prompt"], max_new_tokens=w["max_new"],
                    temperature=w["temperature"], seed=w["seed"]))
                 for w in ws]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.run_until_complete()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        res = [h.result() for h in hs]
        srv.close()
        dec = sum(len(r.tokens) - len(w["prompt"]) - 1
                  for r, w in zip(res, traffic))
        return {"seconds": sec,
                "tpot_median_s": statistics.median(r.tpot for r in res
                                                   if r.tpot),
                "decode_tokens_per_s": dec / sec}

    out["bf16"] = {
        "one_engine": timed(lambda: model.serve(**engine_kw(bf, False))),
        "fleet": timed(lambda: model.serve_fleet(
            replicas=FLEET_REPLICAS, **engine_kw(bf, False)))}
    # the whole decode step at 8 slots (one replay) beside the draw
    eng = model.serve(**engine_kw(bf, False))
    for w in traffic[:c["max_slots"]]:
        eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"]))
    for _ in range(4):
        eng.step()
    step_ms = device_ms_per_call(eng._steps[c["max_slots"]], 20)
    eng.close(force=True)
    out["threefry"]["decode_step_device_ms_bf16_8_slots"] = step_ms
    out["threefry"]["draw_share_of_step"] = \
        out["threefry"]["draw_device_ms"] / step_ms
    mark("bf16")
    out["seconds"] = marks
    out["nvidia_smi"] = nvidia_smi()
    log(out)
    real["launches"] = ship_launches
    return launches, real


# ------------------------------------------------------------- dist_fleet

#: the bf16 timings' worker counts (the second grown from the first by
#: ``add_replica``: one spawn, not three)
DIST_FLEET_WORKERS = (2, 3)
#: the crash's requests' new tokens, and the seconds the orphaned
#: workers decode (one step a redial) before the successor adopts them
DIST_CRASH_NEW = 6
DIST_CRASH_WAIT_S = 8.0


def fleet_streams(fleet, traffic, tag):
    """Submit ``traffic`` to a reference fleet and drain it: every
    request's tokens (a failed request raises)."""
    hs = fleet_submit(fleet, traffic, tag)
    fleet.run_until_complete(max_steps=20000)
    return [h.result().tokens for h in hs]


def _no_leaks(what, fleet):
    """Used minus tree-cached blocks on every healthy replica: zero (the
    step replies carry both)."""
    for rep in fleet._replicas:
        eng = rep.sup.engine
        if rep.healthy and eng.paged_arena is not None:
            cached = (eng.prefix_cache.cached_blocks
                      if eng.prefix_cache is not None else 0)
            if eng.paged_arena.blocks_used != cached:
                raise AssertionError(
                    f"{what}: replica {rep.idx} holds "
                    f"{eng.paged_arena.blocks_used} blocks, its tree "
                    f"{cached}")


def _step_shares(dumps):
    """``serve.step.device_s`` and ``wall_s`` sums of registry dumps (the
    step profiler's), by engine label."""
    out = {}
    for dump in dumps:
        for m in dump["metrics"]:
            if m["name"] in ("serve.step.device_s", "serve.step.wall_s"):
                eng = dict(map(tuple, m["labels"])).get("engine")
                out.setdefault(eng, {})[m["name"].split(".")[-1]] = m["sum"]
    return out


def _busy(before, after):
    """Device seconds over step wall seconds between two
    :func:`_step_shares` readings, summed over the engines."""
    dev = sum(v.get("device_s", 0.0) - before.get(k, {}).get("device_s", 0.0)
              for k, v in after.items())
    wall = sum(v.get("wall_s", 0.0) - before.get(k, {}).get("wall_s", 0.0)
               for k, v in after.items())
    return dev, wall


def _dist_telemetry(fleet):
    """Every healthy worker's registry dump, over the wire."""
    return [rep.sup._rpc("telemetry", {"registry": True},
                         timeout=30.0)["registry"]
            for rep in fleet._replicas if rep.healthy]


def timed_serving(srv, traffic, replicas, tag, dist=False):
    """bf16 timing of a server (one engine, or a fleet of ``replicas``):
    a warm-up pass of ``max_slots`` requests a replica (every replica then
    holds every width's captured step), then ``traffic`` timed; seconds,
    TPOT median, decode tokens/s, and the step profiler's device seconds
    over step wall seconds of the timed pass (the workers' own, over the
    wire, for a ``DistFleet``)."""
    from singa_tpu_torch.observe import stepprof
    from singa_tpu_torch.observe.registry import registry
    from singa_tpu_torch.serve import GenerationRequest

    c = SERVE_ENGINE
    fleet = hasattr(srv, "router")

    def shares():
        return _step_shares(_dist_telemetry(srv) if dist
                            else [registry().dump()])

    for pre, ws in (("w", traffic[:c["max_slots"] * replicas]),
                    ("t", traffic)):
        hs = fleet_submit(srv, ws, f"{tag}{pre}") if fleet else \
            [srv.submit(GenerationRequest(
                w["prompt"], max_new_tokens=w["max_new"],
                temperature=w["temperature"], seed=w["seed"]))
             for w in ws]
        torch.cuda.synchronize()
        before = shares()
        t0 = time.perf_counter()
        srv.run_until_complete()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    dev_s, wall_s = _busy(before, shares())
    res = [h.result() for h in hs]
    dec = sum(len(r.tokens) - len(w["prompt"]) - 1
              for r, w in zip(res, traffic))
    out = {"seconds": sec,
           "tpot_median_s": statistics.median(r.tpot for r in res if r.tpot),
           "decode_tokens_per_s": dec / sec,
           "step_device_s": dev_s, "step_wall_s": wall_s,
           "device_s_over_run_s": dev_s / sec}
    if not dist:
        out["busy_share_of_steps"] = dev_s / wall_s if wall_s else None
    return out


def phase_dist_fleet(model, seed=0):
    """The fleet across the process boundary over GPT-2 small workers
    (module docstring, phase 14h3).  Returns the ``paged_attn`` launches
    pulled from the workers."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.observe import stepprof
    from singa_tpu_torch.serve import (DistFleet, PagedConfig,
                                       PrefixCacheConfig, gpt2_spec)

    marks = {}

    def mark(name, t0=[time.perf_counter()]):
        marks[name] = time.perf_counter() - t0[0]
        t0[0] = time.perf_counter()

    amp.enable(False)
    cfg = model.cfg
    c = SERVE_ENGINE
    spec = gpt2_spec(model)

    def engine_kw(dtype=None, cache=True, **kw):
        return dict(dict(max_slots=c["max_slots"], dtype=dtype,
                         top_k=FLEET_TOP_K,
                         paged=PagedConfig(block_size=c["block_size"],
                                           num_blocks=c["num_blocks"]),
                         prefix_cache=PrefixCacheConfig(
                             block_size=c["block_size"]) if cache else None),
                    **kw)

    out = {"phase": "dist_fleet", "spawn": "process",
           "engine": dict(SERVE_ENGINE, top_k=FLEET_TOP_K)}
    traffic = fleet_traffic(seed, vocab=cfg.vocab_size)
    # the reference: the in-process fleet of 2 replicas, float32
    with model.serve_fleet(replicas=2, **engine_kw()) as f:
        ref = fleet_streams(f, traffic, "r")
    mark("reference")
    #: each worker process's paged_attn launches (its own counts are
    #: cumulative: the largest pull of each pid)
    launches = {}

    def pull(fleet):
        for idx, k in fleet.kernel_launches().items():
            pid = fleet.supervisor(idx).pid
            launches[pid] = max(launches.get(pid, 0),
                                k["paged_attn.launches"])

    # A: 2 worker processes, every stream equal to the reference
    t0 = time.perf_counter()
    a = DistFleet(spec, replicas=2, spawn="process", **engine_kw())
    spawn_s = time.perf_counter() - t0
    procs = [a.supervisor(i)._proc for i in range(2)]
    decoders = [a.supervisor(i).pid for i in range(2)]
    try:
        t0 = time.perf_counter()
        if fleet_drain(a, fleet_submit(a, traffic, "p"), ref, "dist fleet"):
            raise AssertionError("dist fleet: a request failed")
        parity_s = time.perf_counter() - t0
        pids = [a.supervisor(i).pid for i in range(2)]
        mark("parity")
        # a blip: the controller's socket to worker 0 severed mid-decode;
        # the worker redials and the session resumes, no failover
        hs = fleet_submit(a, traffic[:8], "b")
        for _ in range(3):
            a.step()
        with fleet_trace() as ev:
            a.blip_worker(0)
            fleet_drain(a, hs, ref[:8], "after a blip")
        resumes = [e["args"]["seconds"] for e in ev["serve/dist_resume"]]
        snap = a.snapshot()
        if snap["failovers"] or not snap["dist"]["reconnects"] \
                or a.healthy_replicas != 2 or not resumes \
                or not all(e["args"]["resumed"]
                           for e in ev["serve/dist_resume"]):
            raise AssertionError(f"blip: {snap['failovers']} failovers, "
                                 f"{snap['dist']['reconnects']} resumes")
        out["blip"] = {"requests": 8, "streams_equal": True,
                       "reconnects": snap["dist"]["reconnects"],
                       "resumed_calls": snap["dist"]["resumed_calls"],
                       "failovers": 0, "resume_s": resumes}
        mark("blip")
        # a controller crash mid-decode: the workers go on decoding while
        # they redial, and park what finishes; a successor adopts them.
        # ``DIST_CRASH_NEW`` tokens a request, so most finish before the
        # adoption (a stream's prefix does not depend on its length)
        crash_work = [dict(w, max_new=min(w["max_new"], DIST_CRASH_NEW))
                      for w in traffic[8:16]]
        crash_ref = [r[:len(w["prompt"]) + w["max_new"]]
                     for r, w in zip(ref[8:16], crash_work)]
        hs = fleet_submit(a, crash_work, "c")
        for _ in range(2):
            a.step()
        if any(h.done() for h in hs):
            raise AssertionError("crash: a request finished before it")
        port, token = a._listener.port, a._token
        pull(a)
        a.crash()
        time.sleep(DIST_CRASH_WAIT_S)
        t0 = time.perf_counter()
        b = DistFleet.adopt(spec, port=port, token=token, replicas=2,
                            spawn="process", **engine_kw())
        adopt_s = time.perf_counter() - t0
        with b:
            rep = b.adoption
            handles = {**rep["resumed"], **rep["delivered"],
                       **rep["requeued"]}
            kinds = sum(len(rep[k]) for k in ("resumed", "delivered",
                                               "requeued"))
            if rep["rejected"] or kinds != len(handles) \
                    or not rep["delivered"] or sorted(handles) != sorted(
                        f"c{i}" for i in range(len(crash_work))):
                raise AssertionError(f"adoption: {sorted(handles)}, "
                                     f"rejected {rep['rejected']}")
            fleet_drain(b, [handles[f"c{i}"]
                            for i in range(len(crash_work))], crash_ref,
                        "after adoption")
            snap = b.snapshot()
            out["adopt"] = {
                "requests": len(crash_work), "new_tokens": DIST_CRASH_NEW,
                "waited_s": DIST_CRASH_WAIT_S, "adopt_s": adopt_s,
                "resumed": len(rep["resumed"]),
                "delivered": len(rep["delivered"]),
                "requeued": len(rep["requeued"]), "rejected": 0,
                "parked_results": snap["dist"]["parked_results"],
                "epoch": snap["dist"]["epoch"], "streams_equal": True}
            mark("adopt")
            # a worker killed mid-decode: failover, and its requests
            # requeued onto the survivor (none streams its tokens to the
            # caller, so none has started and each replays its chain)
            pull(b)
            hs = fleet_submit(b, traffic[16:], "k")
            b.step()
            with fleet_trace() as ev:
                t_kill = time.perf_counter()
                b.kill_worker(0)
                fleet_drain(b, hs, ref[16:], "after a kill")
            res = {h.request.request_id: h.result() for h in hs}
            t_down = [e["ts"] for e in ev["serve/fleet_failover"]]
            t_req = [e["ts"] for e in ev["serve/fleet_failover_done"]]
            requeued = [e["args"]["request"]
                        for e in ev["serve/fleet_requeue"]]
            if len(t_down) != 1 or len(t_req) != 1 or not requeued:
                raise AssertionError(f"kill: {len(t_down)} down, "
                                     f"{len(requeued)} requeued")
            # a requeued request's TTFT runs from its submit on the
            # survivor, just after the requeue
            first = max(res[r].ttft for r in requeued)
            _no_leaks("after a kill", b)
            pull(b)
            out["kill"] = {
                "requests": len(traffic) - 16, "requeued": len(requeued),
                "streams_equal": True,
                "kill_to_down_s": t_down[0] - t_kill,
                "down_to_requeued_s": t_req[0] - t_down[0],
                "requeued_to_last_first_token_s": first,
                "fault_to_last_requeued_first_token_s":
                    t_req[0] - t_kill + first,
                "survivor_blocks_leaked": 0}
            mark("kill")
    finally:
        if not a._closed:
            a.__exit__(*sys.exc_info())
        for p in procs:
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    out["process_parity"] = {"workers": 2, "pids": pids,
                             "requests": len(traffic),
                             "streams_equal_in_process_fleet": True,
                             "spawn_s": spawn_s, "run_s": parity_s}

    # D: disaggregated, a prefill worker streaming layer-wise KV frames to
    # a decode worker while it prefills
    long = fleet_long_traffic(seed, vocab=cfg.vocab_size)
    roles = ("prefill", "decode")
    with model.serve_fleet(replicas=2, roles=roles, **engine_kw()) as f:
        long_ref = fleet_streams(f, long, "L")
    with DistFleet(spec, replicas=2, spawn="process", roles=roles,
                   **engine_kw()) as d:
        fleet_drain(d, fleet_submit(d, long, "d"), long_ref,
                    "streamed ships")
        snap = d.snapshot()
        if snap["ships"] != len(long) or snap["ship_fallbacks"] \
                or not snap["dist"]["frames"]:
            raise AssertionError(f"streamed ships: {snap['ships']} ships, "
                                 f"{snap['ship_fallbacks']} fallbacks")
        _no_leaks("after the ships", d)
        pull(d)
    dd = snap["dist"]
    out["disaggregated"] = {
        "roles": list(roles), "requests": len(long),
        "prompt_lens": [len(w["prompt"]) for w in long],
        "streams_equal_in_process_fleet": True, "ships": snap["ships"],
        "ship_bytes": snap["ship_bytes"], "frames": dd["frames"],
        "frame_bytes": dd["frame_bytes"],
        "ship_exposed_s_mean": dd["ship_s_mean"],
        "ship_wire_hidden_s": dd["ship_wire_hidden_s"],
        "ship_wire_exposed_s": dd["ship_wire_exposed_s"],
        "ship_overlap_efficiency": dd["ship_overlap_efficiency"],
        "image_checked_against_source_crc32": True, "blocks_leaked": 0}
    mark("disaggregated")

    # T: worker threads of this process, one short float32 pass
    with DistFleet(spec, replicas=2, spawn="thread", **engine_kw()) as t:
        fleet_drain(t, fleet_submit(t, traffic[:8], "t"), ref[:8],
                    "thread workers")
    out["thread"] = {"requests": 8, "streams_equal": True}
    mark("thread")

    # bf16: one engine, the in-process 3-replica fleet, and 2 then 3
    # worker processes (the third added to the running fleet)
    bf = torch.bfloat16
    stepprof.enable()
    try:
        eng = model.serve(**engine_kw(bf, False))
        one = timed_serving(eng, traffic, 1, "o")
        eng.close()
        f = model.serve_fleet(replicas=3, **engine_kw(bf, False))
        local = timed_serving(f, traffic, 3, "l")
        f.close()
    finally:
        stepprof.disable()
    mark("bf16_in_process")
    workers = {}
    with DistFleet(spec, replicas=DIST_FLEET_WORKERS[0], spawn="process",
                   **engine_kw(bf, False)) as w:
        for n in DIST_FLEET_WORKERS:
            while w.replicas < n:
                w.add_replica()
            workers[n] = timed_serving(w, traffic, n, f"x{n}", dist=True)
        decoders += [w.supervisor(i).pid for i in range(w.replicas)]
        pull(w)
    out["bf16"] = {"one_engine": one, "in_process_fleet_3": local,
                   **{f"dist_workers_{n}": v for n, v in workers.items()}}
    mark("bf16_dist")
    total = sum(launches.values())
    if total < 1 or any(launches.get(pid, 0) < 1 for pid in decoders):
        raise AssertionError(f"the worker processes launched paged_attn "
                             f"{launches} (by pid)")
    out["paged_attn_launches_by_worker_pid"] = {
        str(k): v for k, v in launches.items()}
    out["paged_attn_launches"] = total
    out["seconds"] = marks
    out["nvidia_smi"] = nvidia_smi()
    log(out)
    return total


def slice_mfu(cfg, x, y, dev, seed=0, steps=20):
    """``train.mfu`` of GPT-2 small's captured step with the monitor on
    (its FLOPs counted at the signature's first call: aten's products and
    the flash kernels' credits), beside tokens/s x the analytic FLOPs a
    token (6 N_mm + 12 L S d) over the same peak; within
    ``MFU_AGREEMENT``."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.models.gpt2 import GPT2LMHead
    from singa_tpu_torch.observe import monitor
    from singa_tpu_torch.observe.registry import registry

    monitor.start(thread=False)
    try:
        dev.SetRandSeed(seed)
        m = GPT2LMHead(cfg)
        m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
        m.compile([x], is_train=True, use_graph=True)
        for _ in range(2):        # the counted eager call, the capture
            _, loss = m(x, y)
            loss.item()
        flops = monitor.step_flops()
        meter = monitor.mfu_meter()
        time.sleep(monitor.MfuMeter.MIN_INTERVAL_S)
        meter.sample()            # opens the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        # at least ``steps`` steps, and long enough for the meter to take
        # the window (it ignores one shorter than MIN_INTERVAL_S)
        while n < steps or time.perf_counter() - t0 \
                < 2 * monitor.MfuMeter.MIN_INTERVAL_S:
            _, loss = m(x, y)
            loss.item()
            n += 1
        seconds = time.perf_counter() - t0
        s = meter.sample()
        gauge = registry().snapshot()["gauges"]["train.mfu"]
    finally:
        monitor.stop()
    b, t = x.shape
    d, L = cfg.n_embd, cfg.n_layer
    n_mm = L * (4 * d * d + 2 * d * cfg.n_inner) + cfg.vocab_size * d
    per_token = 6 * n_mm + 12 * L * t * d
    tokens_s = n * b * t / seconds
    analytic = tokens_s * per_token / s["peak_flops_per_s"]
    ratio = s["mfu"] / analytic
    if not (math.isfinite(s["mfu"]) and gauge == s["mfu"]
            and abs(ratio - 1) <= MFU_AGREEMENT):
        raise AssertionError(f"train.mfu {s['mfu']} (gauge {gauge}) vs "
                             f"the analytic {analytic}: ratio {ratio}")
    del m
    return {"train_mfu": s["mfu"], "analytic_mfu": analytic,
            "ratio": ratio, "step_flops_counted": flops,
            "step_flops_analytic": per_token * b * t,
            "peak_flops_per_s": s["peak_flops_per_s"],
            "steps_per_s": s["steps_per_s"], "tokens_per_s": tokens_s,
            "timed_steps": n}


def real_args(real, cfg, seed, quant=False, dtype=torch.bfloat16, nq=1,
              window=None):
    """``paged_attn`` arguments for each layer of one recorded serve step:
    its tables and positions, a bf16 pool of the serve engine's size for
    each layer with random contents, random queries and current K/V, drawn
    on the device from ``seed`` (the kernel's time does not depend on the
    values), in ``dtype``.  ``quant``: the pools and current K/V int8
    (values, scales) pairs (values uniform in [-127, 127], scales in
    [0.005, 0.015)), q in ``dtype``.  ``nq``: query positions (a
    speculative verify chunk, under a tril ``cur_mask``); ``window``: the
    sliding band, read from table entry 0 as the engine's steps read
    it."""
    c = SERVE_ENGINE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    d = cfg.n_embd // cfg.n_head
    s_ = len(real["p_limit"])

    def rand(*shape):
        if quant:
            return (torch.randint(-127, 128, shape, generator=gen,
                                  device=DEVICE, dtype=torch.int8),
                    0.005 + 0.01 * torch.rand(shape[:-1], generator=gen,
                                              device=DEVICE))
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=dtype)

    block = c["block_size"]
    p_limit = real["p_limit"]
    step = dict(
        q=torch.randn((s_, cfg.n_kv_head, cfg.n_head // cfg.n_kv_head, nq,
                       d), generator=gen, device=DEVICE, dtype=dtype),
        tables=torch.from_numpy(real["tables"]).to(DEVICE),
        p_limit=torch.tensor(p_limit, dtype=torch.int32, device=DEVICE),
        k_cur=rand(s_, cfg.n_kv_head, nq, d),
        v_cur=rand(s_, cfg.n_kv_head, nq, d),
        cur_mask=torch.ones(nq, nq, dtype=torch.bool, device=DEVICE).tril(),
        scale=1.0 / math.sqrt(d))
    if window is not None:
        step["window"] = window
    shape = (c["num_blocks"] + 1, cfg.n_kv_head, block, d)
    return [dict(step, pool_k=rand(*shape), pool_v=rand(*shape))
            for _ in range(cfg.n_layer)]


def paged_table(lens, cfg, seed):
    """``real_args`` for slots at positions ``lens``, each holding its
    own random blocks of the serve engine's pool (numpy ``seed``), the
    tables 1024 positions wide."""
    c = SERVE_ENGINE
    block = c["block_size"]
    rng = np.random.RandomState(seed)
    ids = rng.permutation(c["num_blocks"])
    tables = np.full((len(lens), 1024 // block), c["num_blocks"], np.int32)
    at = 0
    for s_, p in enumerate(lens):
        n = -(-p // block)
        tables[s_, :n] = ids[at:at + n]
        at += n
    return real_args(dict(tables=tables, p_limit=list(lens)), cfg, seed)


# -------------------------------------------------------------------- moe

#: GPT-2 small with every second block's MLP a MoE (8 experts, top-2,
#: capacity factor 1.25, aux weight 0.01: the JAX package's defaults),
#: trained as the slice phase trains GPT-2 small (8 x 1024, bf16 amp,
#: SGD(1e-4, 0.9)), dropout 0 so that eager and captured steps compare
MOE_RUN = dict(batch=8, seq=1024, steps=4, sgd=dict(lr=1e-4, momentum=0.9))


def moe_dispatch_load(m, x):
    """Every MoE layer's routing of one forward over ``x``, as the step
    routes it (float32 router, top-2 with capacity): the tokens each
    expert kept and the share of the assignments capacity dropped
    (``parallel.moe.dispatch_load``)."""
    from singa_tpu_torch.parallel import moe

    seen = []
    hooks = [blk.mlp.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0].detach())))
        for blk in m.transformer.blocks if isinstance(blk.mlp, moe.MoEFFN)]
    try:
        with torch.no_grad():
            m.forward(x)
    finally:
        for h in hooks:
            h.remove()
    out = []
    for mod, h in seen:
        xt = h.reshape(1, -1, h.shape[-1])
        n = xt.shape[1]
        probs = torch.softmax((xt @ mod.Wg.to(xt.dtype)).float(), dim=-1)
        route = moe._top2_dispatch if mod.top_k == 2 else \
            moe._top1_dispatch
        dispatch, _, _ = route(probs, mod._capacity(n))
        kept, dropped = moe.dispatch_load(dispatch, mod.top_k)
        out.append({"kept_per_expert": kept.tolist(),
                    "dropped": int(dropped),
                    "dropped_share": int(dropped) / (mod.top_k * n),
                    "capacity": mod._capacity(n)})
        del dispatch, probs
    return out


def phase_moe(rows, seed=0):
    """GPT-2 small MoE: training eager against captured through the flash
    kernels, then served by the serve phase's engine and traffic (module
    docstring).  Adds the phase's flash launches to ``rows``; returns
    its ``paged_attn`` launches."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import paged_attention as pa

    r = MOE_RUN
    dev = device.create_cuda_gpu()
    amp.enable()
    cfg = GPT2Config.small(moe_every=2, dropout=0.0)
    if cfg.attn_impl != "flash":
        raise AssertionError(f"attn_impl={cfg.attn_impl!r}, expected flash")
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (r["batch"], r["seq"])) \
        .astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    x, y = tensor.from_numpy(ids, dev), tensor.from_numpy(labels, dev)

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = GPT2LMHead(cfg)
        m.set_optimizer(opt.SGD(**r["sgd"]))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with deterministic():
        m, report = train_eager_and_captured(
            build, x, y, r["steps"], CAPTURE_RTOL["bf16"],
            {"eager": {}, "captured": {}})
    c = report["captured"]
    want = cfg.n_layer * r["steps"]
    if any(n != want for n in (*c["launches"].values(),
                               *c["tensor_core_launches"].values())):
        raise AssertionError(f"MoE steps: flash launches {c['launches']} "
                             f"(tensor-core route "
                             f"{c['tensor_core_launches']}), expected "
                             f"{want} each")
    for name, n in c["launches"].items():
        rows[name]["launches"] += n
    n_moe = sum(1 for blk in m.transformer.blocks if hasattr(blk.mlp, "Wg"))
    load = moe_dispatch_load(m, x)
    if len(load) != n_moe or n_moe != cfg.n_layer // cfg.moe_every:
        raise AssertionError(f"{n_moe} MoE blocks, {len(load)} routed")
    profiles = {mode: report[mode].pop("profile")
                for mode in ("eager", "captured")}
    med = c["median_step_ms"]
    params = sum(p.numel() for p in m.get_params().values())
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    m._graph_runner.clear()
    amp.enable(False)
    m.eval()

    # serving: the serve phase's engine and traffic
    traffic = serve_traffic(seed, vocab=cfg.vocab_size)
    t1 = time.perf_counter()
    res32, l32, steps32, sec32, _ = observed_run(m, traffic)
    gather, _, _, _ = run_engine(m, traffic, "gather")
    offline = offline_streams(m, traffic)
    for i, (a, b, o) in enumerate(zip(res32, gather, offline)):
        if not (np.array_equal(a.tokens, b) and np.array_equal(b, o)):
            raise AssertionError(f"MoE float32 request {i}: engine, gather "
                                 f"oracle and generate disagree")
    res16, l16, steps16, sec16, snap16 = observed_run(
        m, traffic, dtype=torch.bfloat16)
    serve_s = time.perf_counter() - t1
    log({"phase": "moe", "model": "gpt2-small-moe", "params": params,
         "moe_blocks": n_moe, "experts": cfg.moe_experts,
         "top_k": cfg.moe_top_k, "capacity_factor": cfg.moe_capacity_factor,
         "aux_weight": cfg.moe_aux_weight, "batch": r["batch"],
         "seq": r["seq"], "amp": "bf16",
         "optimizer": "SGD(lr=1e-4, momentum=0.9)", **report,
         "median_step_ms": med,
         "tokens_per_s": r["batch"] * r["seq"] / med * 1e3,
         "launches_per_step": {n: k / r["steps"]
                               for n, k in c["launches"].items()},
         "profile_captured": profiles["captured"],
         "profile_eager": profiles["eager"], "dispatch_load": load,
         "peak_mem_gb": peak, "train_seconds": train_s,
         "serve": {"engine": SERVE_ENGINE, "requests": len(traffic),
                   "float32": {"paged_attn_launches": l32,
                               "decode_steps": steps32, "seconds": sec32,
                               "streams_equal_gather_and_generate": True,
                               "graphs_after_warm_up": 0},
                   "bf16": {"paged_attn_launches": l16,
                            "decode_steps": steps16, "seconds": sec16,
                            "ttft_median_s": statistics.median(
                                q.ttft for q in res16),
                            "tpot_median_ms": _tpot_ms(res16),
                            "tokens_per_s": snap16["throughput"][
                                "tokens_per_s"],
                            "graphs_after_warm_up": 0},
                   "seconds": serve_s},
         "nvidia_smi": nvidia_smi()})
    del m
    torch.cuda.empty_cache()
    return l32 + l16


# ----------------------------------------------------------------- main

#: every kernel source of the port (``singa_tpu_torch/csrc/<name>.cu``)
SOURCES = ("flash_attention", "resnet_bottleneck", "paged_attention")


def kernel_report(lib):
    """Per kernel of a built library, by its name as ``cu++filt``
    demangles it: registers and spill bytes from ptxas's ``-v`` report of
    the build, and the counts of warp-level (HMMA) and warpgroup (HGMMA)
    tensor-core instructions, TMA loads (UTMALDG) and local-memory (LDL,
    STL) instructions in its SASS (``cuobjdump -sass``)."""
    from singa_tpu_torch.ops import _build

    tools = os.path.dirname(_build.nvcc_path())
    out = {}
    with open(_build.ptxas_report(lib)) as fh:
        ptxas = fh.read()
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            ptxas, re.S):
        row = out.setdefault(name, {})
        for key, rx in (("registers", r"Used (\d+) registers"),
                        ("stack_bytes", r"(\d+) bytes stack frame"),
                        ("spill_store_bytes", r"(\d+) bytes spill stores"),
                        ("spill_load_bytes", r"(\d+) bytes spill loads")):
            m = re.search(rx, body)
            if m:
                row[key] = int(m.group(1))
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    for name, body in re.findall(
            r"Function : (\S+)\n(.*?)(?=Function : |\Z)", sass, re.S):
        row = out.setdefault(name, {})
        for key, rx in (("hmma", r"\bHMMA\."), ("hgmma", r"\bHGMMA\."),
                        ("utmaldg", r"\bUTMALDG\b")):
            row[key] = len(re.findall(rx, body))
        row["local_memory_instructions"] = len(
            re.findall(r"\b(?:LDL|STL)(?:\.\w+)*\s", body))
    names = sorted(out)
    readable = subprocess.run([os.path.join(tools, "cu++filt"), *names],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
    return dict(zip(readable, (out[n] for n in names), strict=True))


#: the tensor-core kernels each build must hold, by library; a kernel is
#: known by its demangled name, ``(anonymous namespace)::<name><...>(...)``:
#: ``*_tc_kernel`` on warp-level mma.sync, ``*_wg_kernel`` on Hopper's
#: warpgroup wgmma fed by TMA
TENSOR_CORE_KERNELS = {
    "flash_attention": ("fwd_wg_kernel", "dq_tc_kernel", "dkv_wg_kernel"),
    "resnet_bottleneck": ("bottleneck_tc_kernel",),
    # decode attention does ~1 FLOP a byte: CUDA cores, by design
    "paged_attention": (),
}


def check_tensor_cores(report):
    """Raise unless every kernel of ``TENSOR_CORE_KERNELS`` is in its
    library's ``kernel_report``, every ``*_tc_kernel`` instantiation there
    has tensor-core instructions (HMMA or HGMMA) and every Hopper
    ``*_wg_kernel`` instantiation has both HGMMA and UTMALDG (HMMA alone
    would mean the warpgroup design was lost); returns the tensor-core
    kernels' rows by name."""
    tc = {}
    for lib, names in TENSOR_CORE_KERNELS.items():
        rows = {k: v for k, v in report.get(lib, {}).items()
                if re.search(r"::\w+_(?:tc|wg)_kernel<", k)}
        missing = [n for n in names
                   if not any(f"::{n}<" in k for k in rows)]
        if missing:
            raise AssertionError(f"{lib}: no {missing} in the build report")
        bare = {k: v for k, v in rows.items()
                if not (v.get("hmma") or v.get("hgmma"))}
        if bare:
            raise AssertionError(f"tensor-core kernels without HMMA/HGMMA "
                                 f"in their SASS: {bare}")
        no_tma = {k: v for k, v in rows.items()
                  if re.search(r"::\w+_wg_kernel<", k)
                  and not (v.get("hgmma") and v.get("utmaldg"))}
        if no_tma:
            raise AssertionError(f"Hopper kernels without HGMMA and UTMALDG "
                                 f"in their SASS: {no_tma}")
        tc.update(rows)
    return tc


def phase_build():
    """Builds every source at once and reports each kernel's SASS; fails
    if a tensor-core kernel is missing or has no tensor-core
    instruction."""
    from singa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    seconds = time.perf_counter() - t0
    for name in SOURCES:
        _build.load(name)
    report = {name: kernel_report(lib) for name, lib in zip(SOURCES, libs)}
    check_tensor_cores(report)
    log({"phase": "build", "libraries": libs, "seconds": seconds,
         "kernels": report})


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs "
              "one GPU", file=sys.stderr)
        return 1
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    timed("slice", phase_slice, rows)
    timed("io", phase_io, rows)
    timed("bert", phase_bert)
    timed("onnx", phase_onnx)
    timed("charrnn", phase_charrnn)
    model, images = timed("resnet", phase_resnet)
    rows["megakernel_block"] = timed("bottleneck", phase_bottleneck, model,
                                     images)
    del model, images
    timed("zoo", phase_zoo)
    timed("dist", phase_dist)
    timed("shard", phase_shard, rows)
    model, real = timed("serve", phase_serve)
    real8 = timed("serve_int8", phase_serve_int8, model, real)
    timed("serve_slots", phase_serve_slots, model, real, real8)
    timed("generate", phase_generate, model)
    prefix_launches = timed("prefix", phase_prefix, model)
    spec = timed("spec", phase_spec, model, real, real8)
    win = timed("longctx", phase_longctx, model)
    fork = timed("fork", phase_fork, model)
    struct_launches = timed("structured", phase_structured, model)
    timed("beam", phase_beam, model)
    observe_launches = timed("observe", phase_observe, model, real)
    supervisor_launches = timed("supervisor", phase_supervisor, model, real)
    fleet_launches, ship = timed("fleet", phase_fleet, model)
    dist_launches = timed("dist_fleet", phase_dist_fleet, model)
    cfg = model.cfg
    del model
    moe_launches = timed("moe", phase_moe, rows)
    tp_row, shard_launches, ring_launches = timed("serve_shard",
                                                  phase_serve_shard)
    for row in timed("paged_kernels", phase_paged_kernels, real, real8, cfg,
                     spec, win, fork, ship):
        rows[row["name"]] = row
    # the sharded engines' launches on every rank: the pipeline and
    # expert modes' at the full 12 heads, the ring prefill's flash
    # forward; the tensor-parallel ones at a rank's 6 heads, row 5tp
    rows["paged_attn"]["launches"] += shard_launches["paged_attn"]
    rows["flash_fwd"]["launches"] += ring_launches \
        + shard_launches["flash_fwd"]
    rows[tp_row["name"]] = tp_row
    # the prefix phase decodes on bf16 pools through paged_attn, the
    # structured phase on float32 ones, the observe and moe phases on
    # both, the supervisor and fleet phases' runs on float32 ones
    rows["paged_attn"]["launches"] += prefix_launches + struct_launches \
        + observe_launches + supervisor_launches + moe_launches \
        + fleet_launches + dist_launches

    smi = nvidia_smi()
    log({"phase": "device", "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "phase_seconds": seconds,
         "script_seconds": time.perf_counter() - start})
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    def arg(name):
        return sys.argv[sys.argv.index(name) + 1]

    if "--dist-rank" in sys.argv:  # one rank of the dist phase's twin run
        dist_rank_main(int(arg("--dist-rank")), arg("--dist-init"))
        sys.exit(0)
    if "--shard-rank" in sys.argv:  # one rank of the shard phase
        shard_rank_main(int(arg("--shard-rank")), arg("--shard-spec"))
        sys.exit(0)
    if "--shard-world-rank" in sys.argv:  # one sharded rank of --dist-world
        shard_world_rank_main(int(arg("--shard-world-rank")),
                              int(arg("--dist-world")),
                              int(arg("--dist-port")),
                              tiny="--tiny" in sys.argv)
        sys.exit(0)
    if "--serve-shard-rank" in sys.argv:  # one rank of serve_shard
        serve_shard_rank_main(int(arg("--serve-shard-rank")),
                              int(arg("--dist-world")),
                              int(arg("--dist-port")),
                              nccl="--nccl" in sys.argv,
                              fleet="--fleet" in sys.argv)
        sys.exit(0)
    if "--dist-world-rank" in sys.argv:  # one rank of --dist-world
        dist_world_rank_main(int(arg("--dist-world-rank")),
                             int(arg("--dist-world")),
                             int(arg("--dist-port")))
        sys.exit(0)
    if "--shard-faults" in sys.argv:
        sys.exit(main_shard_faults())
    if "--dist-world" in sys.argv:
        sys.exit(main_dist_world(
            int(arg("--dist-world")),
            arg("--phases").split(",") if "--phases" in sys.argv
            else ("dist", "shard")))
    if "--phases" in sys.argv:
        sys.exit(main_phases(arg("--phases").split(",")))
    sys.exit(main())
