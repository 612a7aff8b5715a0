#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: compile every CUDA kernel of the serving and training paths
   from ``deepspeed_tpu_torch/csrc`` with ``nvcc`` (one process per source,
   all started together).  The serving phases (3, 4, 7, 8 below) need the
   forward and decode kernels only and run as soon as those are built,
   first, while the other sources (backward, optimizers, block-sparse)
   finish in the background; they are joined, and this line printed,
   before the kernel checks.
2. ``kernel``: every kernel against its plain PyTorch version at the main
   paths' shapes (B1 and B2 run bf16 on their tensor-core bodies and f32
   on their CUDA-core bodies, each row naming its ``body``; flash prefill
   at B=4, H=12, d=64, T=256/512/200 in bf16 and
   f32, and at the training shape B=8, T=1024 with its lse, and the
   tensor-core bodies at every head dim, d=16/32/64/128 with H=768/d, B=8,
   T=1024, causal, B1 with its lse and B2; and with
   BERT-large's key-padding bias at B=8, H=16, T=512 with its lse; flash decode
   over an 8-slot, 1024-position cache in f32, bf16 and int8, with and
   without a key-padding mask (split over keys: every row the same bits
   over two launches, f32 within 1e-6 of its split plain version), and in
   bf16 at a tensor-parallel rank's heads (3 at d 64: GPT-2 over 4 ranks;
   5 at d 128: GPT-Neo-2.7B over 4), the paged decode likewise; flash
   backward at B=8, H=12, d=64, T=1024 in
   bf16 and f32, T=256 and a ragged T=1000, and with the key-padding bias
   at B=8, H=16, T=512 in bf16 and f32; fused Adam over GPT-2 124M's
   ``wte``, stacked ``qkv_w`` and ragged ``lnf_g`` leaves and over a whole
   step's 16 leaves; fused LAMB's two passes over BERT-large's
   ``tok_emb``, stacked ``qkv_w``, ragged ``mlm_bias`` and ``nsp_b`` and
   over a whole step's 26 leaves, with and without bias correction;
   paged flash decode at the paged pool's serving shape,
   8 slots x 8 pages of 128 over a permuted 129-page pool, in bf16, f32 and
   int8, also against flash decode over the gathered view, bit for bit;
   flash forward and backward with BERT-large's padding bias and attention
   dropout 0.1 (in-kernel Threefry bits against the host twin's) and with
   a (B, 1, T, T) mask read through its strides, at B=8, H=16, T=512 in
   bf16 and f32, and a trainable (1, 16, 512, 512) bias's cotangent under
   dropout; the two-pass backward B6a/B6b at B=1, H=16, T=9216 in bf16
   (tensor-core bodies) and f32, against its plain version and the
   single-pass kernel, its dq the same bits over two launches, and the
   bf16 pair at GPT-2's training shape beside B2 (``flash_bwd2_gpt2``:
   the two-pass route's cost); the block-sparse forward B8 and backward
   B9a/B9b at B=1, H=12, d=64, T=8192 and 16384 with GPT-2's default
   BigBird layout (block 256, causal) in bf16 (on their tensor-core
   bodies) and f32, their outputs and gradients the same bits over two
   launches, and a per-head, an untouched-column and a zero-degree-row
   layout at T=1024, whose empty columns' dk/dv must be exactly 0 and
   whose empty rows' output 0 with lse +inf, and BigBird with blocks of
   96 at T=1536 and of 16 at T=512),
   with the tolerance stated, and the times of the kernel, the plain
   version and one PyTorch library call beside the least time the card
   could take (``bound_ms``; with dropout the slower of the dots and
   Threefry's integer operations on the INT32 pipe).  B2's, B6's, B9a's
   and B9b's bf16 gradients (and their plain versions') are held to the
   float64 function within the bound of the bf16 contract
   (``flash_bwd_float64``, ``splash_bwd_float64``), the f32 ones to the
   plain version entry by entry; every B2 row's dq, dk and dv must be the
   same bits over two launches (dq summed in a fixed order).  The bf16
   forwards B1 (training shape) and B8 (T 8192 and 16384), kernel and
   plain version, are also read against their float64 functions
   (``flash_fwd_float64``, ``splash_fwd_float64``), the kernel held to
   2e-2 there.
3. ``serve_f32``: GPT-2 124M at full width and depth (random weights from
   a seed) behind ``init_serving``: 8 slots, 64-token prefill chunks, 16
   requests with 64..384-token prompts, drained; every request's greedy
   tokens must equal the port's solo ``generate()`` of the same prompt
   (the JAX package's serving contract) unless the first differing token
   sits on a near-tie of the top-2 logits.
4. ``serve_bf16``: the same flow in bf16 plus a ``generate()`` with B=4 and
   T=256, the serving main path.  Kernel launch counters are zeroed just
   before it and read just after: both serving kernels must have launched.
   Logits of the kernel path and of the plain path on the card must agree.
   Every prefill launch of B1 must have run its tensor-core body.
5. ``train_f32``: GPT-2 124M at full width and depth through
   ``deepspeed_tpu_torch.initialize`` in f32, B=2, T=1024, 3 ``train_batch``
   steps, TF32 off: the kernel path against the same steps with
   ``use_flash_attention=False`` (the plain attention); per-step losses
   must agree within the tolerance stated.
6. ``train_bf16``: the training main path, GPT-2 124M in bf16 with f32
   masters, micro-batch 8, gradient accumulation 2, T=1024, AdamW with
   ``WarmupDecayLR`` (lr 6e-5 rising to 6e-4 over 2 steps) and clipping
   1.0, 4 steps on one fixed batch.  First, a reading (not a gate): two
   first steps from the same state, through fresh engines, compared bit
   for bit (loss, parameters, every B1/B2 launch's outputs), naming the
   first launch and the parameters that differ, if any.  The
   counters are zeroed just before and read just after: the flash forward,
   flash backward and fused Adam kernels must have launched, B1 and B2 on
   their tensor-core bodies only; every loss finite and the last below the
   first.  Prints tokens/s, ms a step, peak
   memory and model-FLOPs utilization.  Then its ``telemetry`` object
   (:func:`train_telemetry`): fresh engines on the same model, config and
   batch, 4 steps each, with the plane off, registry-only (the default)
   and fully armed (trace, attribution, the JSONL / Prometheus /
   TensorBoard sinks, ``wall_clock_breakdown``, the flops profiler): ms a
   step of each; the synchronizing calls of a step under
   ``torch.cuda.set_sync_debug_mode("warn")``, off and registry-only
   equal; the armed trace passes ``validate_chrome_trace`` with the step
   phases (``train/data_wait``, ``train/compute`` from CUDA events); the
   counted first step's ``matmul`` bucket within 1 % of ``6 N`` tokens,
   its attention bucket holding every B1 / B2 launch of that step, the
   timed second step's kernel events likewise and the buckets' device ms
   the profiled kernels' sum within 1 %; the MFU gauge.
   Then ``train_resume_bf16``: the same config over a 96 x 1024 dataset
   read through ``DeepSpeedDataLoader(16, shuffle)`` ->
   ``engine.prefetch_loader``: engine A takes 6 steps; engine B 3, a
   synchronous save, an async save, a step while that commit runs, and
   the drain; fresh engines C and D load the sync and the async tag and
   take 3 steps each.  Their losses, masters, Adam moments and batches
   must equal A's bit for bit, both tags' state must hash alike, and the
   6 steps fed without the prefetcher must give A's losses (counters
   zeroed before, read after: ``training_resume``).  Prints the saves'
   ms and GB/s, the async stall beside its commit, the loads, and the
   step ms with and without the prefetcher and its ``data_wait``.
   Then ``train_zero_bf16``: ZeRO across ranks at world size 1.  A child
   process under the launcher environment (``WORLD_SIZE=1``, ``RANK=0``,
   ``LOCAL_RANK=0``, ``MASTER_ADDR``, a free ``MASTER_PORT``) runs
   ``deepspeed_tpu_torch/tools/zero_worker.py``: NCCL starts, the
   collectives (all-reduce, reduce-scatter, all-gather, the stage-3
   autograd gather) are checked on CUDA tensors in f32 and bf16 at odd
   sizes, then train_bf16's 4 steps run at ZeRO stages 0-3 on ``mesh:
   {data: 1, fsdp: 1}``.  Each stage's losses and state (masters, Adam
   moments, step, scaler: a sha256 each) must be train_bf16's bit for bit,
   0 bytes counted (the models say 0 at one rank), and B1/B2/B3 launched
   as in train_bf16 on the tensor-core bodies (the child zeroes the
   counters before each stage and reads them after: ``training_zero``).
   Prints ms a step and peak memory by stage beside train_bf16's.
   Then ``train_tp_seq_bf16``: tensor and sequence parallelism on one
   card.  (a) Ring attention's schedule over 4 virtual ranks in one
   process (``parallel.sequence.VirtualRing``) at GPT-2's widths, (1, 12,
   8192, 64) bf16, causal, forward and backward: B1 with its lse and B2
   with the merged lse, 10 launches each on the tensor-core bodies
   (counters zeroed before, read after); the output within 2e-2 of dense
   B1 and of the float64 function, the lse within 1e-4 of B1's; the
   gradients within the bf16 contract's bound of ``flash_bwd_float64``
   (as dense B2's), a second backward the same bits; ms beside the ring's
   plain body and SDPA.  (b) In ``train_zero_bf16``'s child: GPT-2 124M
   with vocab 50304 on ``mesh {model: 1, seq: 1}``, 4 steps with
   ``attention_mode`` ring and ulysses, losses and state bit for bit the
   flash run's (one rank: both fall back to flash attention); the
   vocab-parallel embedding and NLL over a group of one at GPT-2's widths
   against the plain embedding (exact) and ``token_nll`` (1e-5).
   ``training_tp_seq`` counts (a)'s pass and (b)'s two runs.
   Then ``serve_tp_bf16``: tensor-parallel serving at world size 1.
   ``train_zero_bf16``'s child also saves GPT-2 124M's initial state
   (``init_params`` seed 0) as a tag; a second child under the launcher
   environment runs ``deepspeed_tpu_torch/tools/serve_worker.py`` over
   NCCL: ``init_serving(mp_size=1, checkpoint=<tag>)`` in bf16 (a
   ``model`` group of one) serves ``request_mix(seed=0)`` through the slot
   pool, ``paged_request_mix(seed=0)`` through the paged pool and
   ``serve_bf16``'s ``generate()``: every token bit for bit those of
   ``serve_bf16`` and ``serve_paged_bf16``, 0 bytes counted, B1 (tc), B4
   and B5 launched (``serving_tp``); then the same engine with
   ``kvcache.tiers.enabled`` under the group (``serve_tiers_bf16``'s
   16 sessions x 3 turns, a flush to disk before the last turn): every
   turn bit for bit the all-device pool's, the tiers' agreements the only
   bytes counted; an ``init_on_device`` engine holds
   GPT-2 124M's shapes in bf16, finite.
7. ``serve_paged_f32``: GPT-2 124M behind ``init_serving`` with the paged
   pool (8 slots x 1024 positions, 64-token chunks, 128-token pages) on
   ``paged_request_mix(seed=0)``: 16 requests sharing a 200-token prefix
   and a 3-turn session.  Served tokens must equal the slot engine's on the
   same prompts (the near-tie rule above); at least 6 prefix hits, a
   copy-on-write, 2 session rebinds, no leaked page; paged flash decode
   launched, slot flash decode not.
8. ``serve_paged_bf16``: the same mix in bf16, the paged serving main path
   (counters zeroed just before and read just after), against the slot
   engine on the same mix (decode tokens/s, TTFT, prefill chunks run);
   then the session is spilled to disk and a fourth turn restores it: the
   restored rows must equal the spilled ones bit for bit.  Then its
   ``telemetry`` object (:func:`serve_telemetry`): the mix's first 8
   requests on three fresh paged engines with the plane off, the registry only and
   fully armed (registry, trace, JSONL and Prometheus sinks), two drains
   each in turns: decode tokens/s and TTFT of each; the armed trace passes
   ``validate_chrome_trace`` with one lane per request, TTFT from each
   lane's spans equals its ``serving/ttft_ms`` sample within 1 ms; one
   counted and two timed serving steps (prefill chunks, which take the
   plain path on the paged pool, and decode): the attention bucket holds
   every B5 launch (and B1's, none), the buckets' device ms the profiled
   kernels' sum within 1 %.
   Then ``serve_tiers_bf16``: GPT-2 124M (weights drawn on the card) in
   bf16 on the paged pool (8 slots x 1024 positions, pages of 128, 160
   pages), 16 sessions x 3 turns of 96..192 new prompt tokens and 32 greedy
   tokens, tiers off (the reference, every session warm) and on (watermark
   0.3, residency window 256, 24 host pages, then disk): every turn bit
   for bit the reference's, demotions, promotions, T1 and T2 hits, one
   prefill and one decode signature, B5 launched (``serving_tiers``);
   the gather's and scatter's ms a page (CUDA events) beside their bound
   over the host link, ``swap_hidden_ratio``, decode tokens/s beside the
   reference's.  Then ``serve_resilience_bf16``: ``tools/serving_chaos.py``
   in child processes (a real ``kill -9`` mid-decode replayed bit for bit;
   SIGTERM mid-drain on the tiered engine, exit 43, the next turns
   rebinding from disk bit for bit; two tenants, one deferred by its page
   quota, the bill equal to the journal's), B4 and B5 launched in the
   children (``serving_resilience``).  Then ``serve_fleet_bf16``:
   ``tools/fleet_chaos.py``, GPT-2 124M bf16 replicas in child processes
   behind one ``FleetRouter`` over the framed stdio transport: three
   slot-pool replicas, 18 requests, one replica killed mid-decode (rc -9,
   zero acknowledged loss, the restart replays the journal's incomplete
   set); then an elastic fleet: a burst scales up off the warm pool,
   sessions park, a victim dies inside ``migrate.export`` (rc -9), clean
   scale-downs migrate the sessions to a replica whose final turns rebind
   them; every output equal to solo ``generate()`` or first different on
   a near-tie, B4 and B5 launched in the children (``serving_fleet``).
   Then ``serve_frontdoor_bf16``: ``tools/frontdoor_chaos.py``, a
   ``FrontDoor`` server child: 429 for a starved tenant, ``kill -9``
   mid-stream, the same ``client_key`` resumed under its id after a
   restart, SIGTERM: the stream completes, 503 with ``Retry-After``, exit
   43, the journal's bill equal to what the client read; B4 launched in
   the server (``serving_frontdoor``).
   Then models from outside the repo.  ``serve_injected_bf16``: GPT-Neo
   2.7B at its published widths (hidden 2560, 32 layers, 20 heads of 128,
   vocab 50257, 2048 positions), weights drawn on the card (seed 0) and
   handed over as a ``GPTNeoForCausalLM`` stand-in (``state_dict()``
   under HF GPT-Neo's key names, a ``.config``; the card has no
   ``transformers``), injected by ``init_inference(model=<stand-in>)``:
   the tree bit for bit the preset engine's fed the same weights through
   ``params=``, the prefill logits within the tolerance stated, 8
   requests on the paged pool equal to solo ``generate()`` or first
   different on a near-tie of 0.1 of logit (B1 and B5 launched:
   ``serving_injected``).  ``serve_int8_bf16``: the same model with
   ``quantize_bits=8`` (int8 codes and f32 per-channel scales on the card,
   the same as packing on the host): weight bytes beside bf16's, the
   prefill logits within the tolerance stated of a bf16 engine over the
   dequantized ``q * s``, 8 requests on the slot and the paged pools
   equal to int8 ``generate()`` or near-ties (B1, B4, B5:
   ``serving_int8``), decode tokens/s and TTFT at batch 8 beside bf16's, in
   turns.  ``serve_megatron_bf16``: Megatron-LM's GPT-2 345M written from
   a seed as two tensor-parallel shards (``mp_rank_0X_model_states.pt``,
   ``latest``, the newer interleaved QKV) and read through
   ``find_megatron_checkpoints`` → ``SDLoaderFactory.get_sd_loader(...)
   .load()`` → ``init_serving(model=merged)``: logits bit for bit the
   unsplit weights', 8 requests on the slot pool (B1, B4:
   ``serving_megatron``).
9. ``train_bert_f32``: BERT-large at full width and depth (random weights
   from a seed) through ``initialize`` in f32, B=2, T=512 with a
   key-padding mask, LAMB, 3 steps, TF32 off: the kernel path (biased
   flash forward and backward, fused LAMB) against
   ``use_flash_attention=False``; per-step losses must agree within the
   tolerance stated; the LAMB kernels must launch and fused Adam not.
10. ``train_bert_bf16``: the BERT pretraining main path, BERT-large in bf16
   over f32 masters, micro-batch 8, gradient accumulation 2, T=512 with
   the padded synthetic MLM + NSP batch, LAMB with bing_bert's phase-2
   settings (lr 2e-3, weight decay 0.01, no bias correction, trust ratio
   in [0.01, 0.3]), ``WarmupDecayLR``, clipping 1.0, 4 steps.  Counters
   zeroed just before and read just after: the biased flash forward and
   backward and both LAMB kernels must have launched; every loss finite
   and the last below the first.  Prints tokens/s, ms a step, peak memory
   and model-FLOPs utilization.
11. ``train_bert_drop_f32``: BERT-large with its published dropout (hidden
   and attention-probability 0.1) in f32, B=2, T=512, LAMB, 3 steps, TF32
   off: the kernel path against ``use_flash_attention=False`` on the same
   seeds (the same keep-bits, the same hidden masks); per-step losses
   within the tolerance stated.
12. ``train_bert_drop_bf16``: this slice's main path, BERT-large with its
   published dropout, otherwise ``train_bert_bf16``'s settings.  Counters
   zeroed just before and read just after: every flash forward and
   backward launch ran with the bias and dropout on the tensor-core body,
   both LAMB kernels launched, fused Adam and the two-pass backward not;
   every loss finite.
   Prints tokens/s, ms a step, peak memory and model-FLOPs utilization.
   Then ``train_resume_bert_drop_bf16``: the same BERT-large, depth cut
   to 4 layers, 2 steps + save + a fresh engine's load + 2 against 4
   uninterrupted steps, bit for bit, LAMB's moments included (the gate on
   the generator and the Threefry keys resuming; ``training_resume_bert``).
13. ``transformer_layer``: ``DeepSpeedTransformerLayer`` at BERT-large
   width (pre-LN, the op's default dropout 0.1 and 0.1): 24 layers in bf16
   at B=8, T=512, forward and backward, with a (B, T) mask (the key-row
   bias) and with a (B, 1, T, T) seq2seq mask (the full bias), each a main
   path (counters zeroed before, read after) timed with two more passes
   (their median beside the counted one); the same stack in f32 at
   B=2 against plain attention on the same seeds; the 24-layer stack at
   B=1, T=9216 with a (B, T) mask keeping 8,000 positions (a main path:
   counters zeroed before, read after), whose backward must be the
   two-pass B6a/B6b, 24 launches each on the tensor-core bodies, and not
   B2; the median of three passes after a warm one.
14. ``train_sparse_f32``: GPT-2 with ``attention_mode="sparse"`` (124M
   width, 8 layers, the default BigBird layout, block 256) in f32, B=1,
   T=8192, 3 steps, TF32 off: the splash kernels against the same steps
   with the sparse op on its gather path; per-step losses within the
   tolerance stated; every splash launch on its CUDA-core body.
15. ``train_sparse_bf16``: this slice's main path, the sparse GPT-2 in bf16
   over f32 masters at T=8192 and T=16384 (8 layers, B=1, Adam at lr 1e-4,
   remat, cross-entropy in chunks of 512), 4 steps, beside the dense flash
   path at the same T and depth.  Counters zeroed just before and read just
   after each sparse run: B8 16, B9a 8 and B9b 8 launches a micro-step
   (all on their tensor-core bodies), fused Adam launched,
   B1/B2 not; losses finite and falling.  Prints ms a
   step, tokens/s, peak memory, MFU and sparse-over-dense tokens/s.
16. ``train_moe_bf16``: GPT-2 124M's widths with 8-expert top-2 MoE
   FFNs (~522M parameters, the JAX package's MoE defaults) in bf16 over
   f32 masters, micro 8 x T 1024, AdamW, 4 steps through ``initialize``
   (a main path: counters zeroed before, read after; B1, B2, B3), beside
   the same steps with plain attention (MOE_BF16_LOSS_RTOL); ms a step,
   tokens/s, peak GiB, the dropped share of routed assignments.
17. ``serve_moe_bf16``: that model through ``init_serving`` on the slot
   pool and the paged pool, 8 requests of 64-256 prompt tokens and 48 new
   (main paths: B1 for ``generate()``'s prefill, B4 / B5); a request whose
   steps dropped no pick is held to solo ``generate()``, the rest to a
   replay of the same batches through the plain bodies, both under the
   near-tie rule; no leaked page; decode tokens/s, TTFT p50, the drops.
18. ``train_pipe_bf16``: GPT-2 124M assembled here as a
   ``PipelineModule`` (:func:`gpt2_pipe_module`: a tied embedding, 12
   blocks of the port's GPT-2 block, the final LayerNorm and the tied
   head) over two stage processes sharing the card (gloo, pinned host
   copies; ``tools/pipe_worker.py``), ``1f1b``, 4 micro-batches of 8 x
   1024, 3 steps, against the same module at one stage in this process
   (PIPE_BF16_LOSS_RTOL); B1, B2 and B3 on each stage; ms a step, each
   stage's idle share.
19. ``train_offload_bf16``: ``train_bf16``'s config and batch with
   ``offload_optimizer: {device: cpu}`` (f32 masters and Adam moments in
   pinned host memory, the native host Adam), 4 steps (a main path:
   counters zeroed before, read after): the first loss train_bf16's bit
   for bit, the rest within OFFLOAD_LOSS_RTOL; a fresh engine's first-step
   masters within OFFLOAD_STEP1_REL of B3's (``train_bf16_first_step_bits``'
   first run); B1/B2 on the tensor-core bodies, B3 not launched, the host
   kernels run; peak memory below train_bf16's by OFFLOAD_PEAK_SHARE of 10
   bytes a parameter; a fresh engine loading the tag saved after step 2
   repeats steps 3-4 bit for bit (losses, host masters and moments, bf16
   parameters).  Prints ms a step split into device compute, device ->
   host, host Adam, cast and host -> device, the host Adam's GB/s, the
   host link's pinned GB/s each way and a host memcpy's.
20. ``train_offload_nvme_bf16``: the same with ``device: nvme`` (the
   moments only through the disk): losses and final masters
   train_offload_bf16's bit for bit, m and v read and written each step
   (16 bytes a parameter); ``used_kernel_aio`` read, not gated.
21. ``train_infinity_bf16``: ``offload_param: {device: cpu, buffer_count:
   1}``, 12 one-layer groups streamed through the card: the first loss
   train_offload_bf16's bit for bit, the rest within INFINITY_LOSS_RTOL of
   its, the group gradients live (each tensor counted until it is freed)
   never above two groups', peak memory below train_offload_bf16's by
   INFINITY_PEAK_SHARE of what the device stops holding (the f32
   accumulator and the blocks' bf16 parameters, less the two group
   buffers), B1/B2 on the tensor-core bodies; the last step serialized
   (``train_batch(timing=)``); B1 launches a layer a micro-step.
22. ``train_infinity_nvme_bf16``: ``offload_param: {device: nvme,
   buffer_count: 2}``, 6 two-layer groups read from their files: the
   losses train_infinity_bf16's bit for bit, the same memory gates, and
   the bytes the aio engine was asked to read what the sweeps need (gas x
   2 sweeps x the blocks' bf16 bytes a step).
23. ``train_offload_ranks_bf16``: ``train_bf16``'s model, config and
   batch at ``mesh: {data: 2}`` over two rank processes sharing the card
   (gloo; ``tools/zero_worker.py``, each rank's rows train_bf16's
   micro-batches), 1 step without offload, 2 with ``offload_optimizer:
   cpu`` (each rank its flat half of the masters and moments, the slices
   all-gathered as pinned f32 tensors), 1 with ``nvme``: the first loss
   the same ranks' without offload bit for bit, step-1 masters within
   OFFLOAD_STEP1_REL of theirs, the rest within OFFLOAD_LOSS_RTOL of
   train_bf16's, each
   rank's host master bytes half of one rank's (up to the pad), nvme the
   cpu losses bit for bit, and ``DS_OFFLOAD_SHARDS=2`` in this process
   train_offload_bf16's masters bit for bit.
24. ``train_infinity_ranks_bf16``: ``offload_param: cpu`` (12 one-layer
   groups) at ``mesh: {fsdp: 2}`` over two rank processes: each rank its
   fsdp half of the block masters and moments, the groups all-gathered,
   their gradients reduce-scattered; the first loss train_infinity_bf16's
   bit for bit, the rest within INFINITY_LOSS_RTOL; a two-rank tag loads in
   one process and a one-rank tag at two ranks with the same masters.
25. ``train_infinity_sparse_bf16``: the sparse GPT-2 of train_sparse_bf16
   (T 8192, 8 layers) streamed one layer at a time on one rank, 2 steps
   (a main path: B8 twice, B9a/B9b once a layer a step, tensor-core
   bodies): the losses within INFINITY_LOSS_RTOL of the in-memory engine's.
26. ``train_onebit_bf16``: ``OneBitAdam`` (freeze_step 2, 4 steps) and
   ``OneBitLamb`` (3 steps) and AdamW under ``comm.strategy`` int8 (3
   steps) and onebit (1 step) at ``mesh: {data: 2}`` over two rank
   processes: losses finite, every
   compressed step's ``grad-exchange`` bytes ``step_comm_bytes``' model and
   at least ONEBIT_WIRE_FACTOR below dense, one exchange of fixed rows on
   the card within ONEBIT_ROWS_ATOL of the plain rows functions.
27. ``train_compose_bf16``: the compositions (PR 23) in the same spawn,
   train_bf16's config and batch over two rank processes: ``{model: 2}`` +
   ``offload_optimizer: cpu`` (GPT-2's vocabulary padded to 50304; 3
   steps) within COMPOSE_TP_LOSS_RTOL of the one-rank offload engine, its
   ``tp-all-reduce`` bytes the model's, each rank's host masters its
   blocks, B1 24 and B2 12 a micro-step on each rank's 6 heads;
   ``{data: 2}`` stage 2 + 8-bit Adam state rounding to nearest (3 steps)
   against the one-rank engine, the block-scale bytes the cut leaves';
   ``{fsdp: 2}`` stage 2 + ``OneBitAdam`` past ``freeze_step`` (4 steps)
   and ``{fsdp: 2}`` stage 3 + ``comm.strategy: int8`` (3 steps) against
   train_onebit_bf16's same-rows runs: each first loss the reference's
   bits, the rest within COMPOSE_ZERO_LOSS_RTOL, the compressed steps'
   ``grad-exchange`` (and stage 3's ``all-gather``) bytes the models'.
   Phases 23-27 print ms a step, each rank's profiled step (its kernels'
   busy share of the step's window) and host and device peaks.
28. ``train_large_q8_bf16``: the JAX package's ``q8`` recipe
   (``tools/sweep_774m.py``) on GPT-2 774M at full width and depth (36
   layers, drawn on the card from seed 0), micro 4 x T 1024,
   ``xent_chunk_size`` 512, AdamW, bf16 over f32 masters, 3 steps a run:
   (a) f32 Adam state under ``nothing_saveable``, (b)
   ``state_precision="8bit"`` under ``remat_save_names=SAVE_FLASH``.  (b)'s
   first loss (a)'s bits, its step-1 masters within LARGE_STEP1_BOUND *
   (|p| + lr) of (a)'s, later losses within LARGE_LOSS_RTOL; B1 36 launches
   a micro-step in (b) (the recompute takes the kept output and lse)
   against 72 in (a), B2 36 in both; B3 in (a) only (the reduced state's
   update is plain torch, as the JAX package's is XLA); (b)'s state bytes
   the count ``_v_blocks`` gives (~3 B a parameter against 8) and its peak
   below (a)'s; ms a step and the update's ms a step (CUDA events).
29. ``train_extras_bf16``: train_bf16's model, config and batch, 3 steps a
   run: (c) bf16 Adam state (losses within EXTRAS_BF16_LOSS_RTOL of
   train_bf16's, the first its bits); (d) progressive layer drop (theta
   0.5, gamma 0.001, hidden dropout 0.1): theta the host formula's, B1
   launches twice and B2 once a kept block, and one forward at theta 0.5
   skipping blocks (B1 once a kept block); (e) MoQ 16 -> 8 bits from step
   1 after an eigenvalue probe (10 iterations at most, micro 1 x T 256,
   plain attention) scales its period, trained until the updates reach 8
   bits: every matmul weight at most 2^8 levels a layer; (f)
   ``activation_checkpointing.cpu_checkpointing``: the first loss
   train_bf16's bits, the peak below train_bf16's; TiledLinear on the card
   within TILED_TOL of ``F.linear``.
30. ``kernels``: one entry per kernel with its launches on each main path
   (B1, B2, B6a, B6b, B8, B9a and B9b: the tensor-core body's source, the
   f32 body's beside it)
   (``launches_by_path``: serving, serving_paged, serving_tp, serving_tiers,
   serving_resilience, serving_fleet, serving_frontdoor, serving_injected,
   serving_int8, serving_megatron, training,
   training_resume, training_zero, training_tp_seq, training_bert, training_resume_bert,
   training_bert_dropout, transformer_layer, training_sparse, training_moe,
   serving_moe, training_pipe, training_offload, training_offload_nvme,
   training_infinity, training_infinity_nvme, training_offload_ranks,
   training_infinity_ranks, training_infinity_sparse, training_onebit,
   training_compose, training_large_f32, training_large_q8,
   training_extras) and their sum; B1's and B2's rows also at a
   tensor-parallel rank's 6 heads (``h6``).

Then the card's name and power limit (``nvidia-smi``) and, last, the
``{"ok": true, "device": ...}`` line.  Any failing phase raises, so the
script exits non-zero; without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by
# operand type (bf16 on the tensor cores, f32 on the CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain version on the same inputs:
#  * f32: 2e-5, the JAX kernel tests' own bound; both sides sum in f32
#    in different orders (TF32 is off, see below)
#  * bf16 outputs: 2e-2; both sides round the output (and the prefill's p)
#    to bf16, whose spacing is 2**-8 relative, after f32 sums taken in
#    different orders
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# f32 serving vs solo generate(): a differing greedy token is accepted only
# where the top-2 logits at that step lie within this gap; the two paths'
# f32 logits differ by sums taken in other orders (~1e-5 at most)
F32_NEAR_TIE = 1e-3
# bf16 kernel path vs bf16 plain path, first-step logits (absolute): the
# two round attention (p, and its output) to bf16 at different points and
# carry that through 12 bf16 residual layers; the random-init logits span
# about +-3, and a wrong mask or offset moves them far more than this
BF16_LOGIT_TOL = 0.1

FLUSH_BYTES = 512 << 20  # > the 50 MB L2: every timed launch starts cold

# attention dropout's keep-bits on the INT32 pipe, for the dropout rows'
# bound: Threefry-2x32 as flash_common.cuh computes it, integer operations
# a score: the counter's multiply-add, 2 key adds, 20 rounds of add,
# rotate (one funnel shift) and xor (60), 5 key injections of 2 adds (10),
# the compare and the select (75 in all); the rate: 64 INT32 lanes a clock
# on each of the H100 SXM's 132 SMs at its 1.98 GHz boost clock (NVIDIA
# H100 Tensor Core GPU Architecture white paper), 16.7e12 operations a
# second
THREEFRY_OPS_PER_SCORE = 75
PEAK_INT32_OPS = 64 * 132 * 1.98e9

# the head dims the tensor-core bodies serve beside GPT-2's 64 (whose rows
# are the training shape's), each at GPT-2's width (768 = H x d) and
# training shape (B 8, T 1024, causal)
TC_DIMS = (16, 32, 128)
# a tensor-parallel rank's heads in training at model 2 (train_compose_bf16):
# GPT-2's 12 heads of d 64 over two ranks, B1 and B2 at the training shape
TP_TRAIN_HEADS = 6

# flash backward vs its plain version, entry by entry:
#   |got - ref| <= tol * (|ref| + BWD_RMS_SHARE * rms(ref))
# with tol the f32/bf16 bound above.  The relative term takes a bf16
# output that rounds the other way (one spacing, <= 2**-7 of the entry)
# and dq's f32 sum, taken with atomics in an order that changes between
# runs; the rms term takes entries near zero.  With random causal inputs
# the entries shrink like sqrt(e / position) (rms ~0.1 at T=1024), so a
# kernel that drops or misplaces one 64-row tile's share of a late row
# moves it by several times its bound
BWD_RMS_SHARE = 0.5
# fused Adam vs its plain version (f32 p), each of p, m and v relative to
# its own largest entry: the kernel rounds each product and sum as the
# plain version does, so at most an ulp may differ (the runs read 0)
ADAM_RTOL = 1e-6
# train_f32, flash kernels vs plain attention, per-step loss (relative):
# the same f32 math in other summation orders; the runs read 0, 0 and
# 9.1e-8, so this leaves two orders of margin
TRAIN_F32_LOSS_RTOL = 1e-5
# Adam's operations per element of the keep-folded body (multiplies, adds,
# two divides, a square root, a select), for the bound; bytes per f32
# element: p read+write, g read, m read+write, v read+write
ADAM_FLOPS_PER_ELEM = 24
ADAM_BYTES_PER_ELEM = 28
# fused LAMB vs its plain version (f32 p): m, v and p each within 1e-6 of
# its own largest entry (each product and sum rounded as the plain version
# rounds it, so at most an ulp may differ); the trust ratio within 1e-5
# relative, since its norms sum per block, in another order than
# torch.linalg.vector_norm
LAMB_RTOL = 1e-6
LAMB_TRUST_RTOL = 1e-5
# LAMB's bytes per f32 element: pass 1 reads p and g, reads and writes m
# and v, writes dir (28); pass 2 reads p and dir and writes p (12).  Its
# operations: pass 1's keep-folded body with the decay term and the two
# squares summed (~26), pass 2's multiply and subtract (2)
LAMB_DIR_BYTES, LAMB_APPLY_BYTES = 28, 12
LAMB_DIR_FLOPS, LAMB_APPLY_FLOPS = 26, 2
# the key-padding pattern of the biased attention checks: batch row b
# keeps BIAS_KEEP[b % 4] of its 512 keys (the rest carry a -1e9 bias)
BIAS_KEEP = (512, 448, 300, 129)
# attention dropout: BERT-Large's published rate, and the key words of the
# kernel checks (both above 2**31, so the uint32 arithmetic is exercised)
DROP_RATE = 0.1
DROP_KEY = (0x9E3779B9, 0xBB67AE85)
# the two-pass backward's check: one sequence past d 64's 8,192-row bound
# of the fused backward, keeping LONG_KEEP of its keys
LONG_T, LONG_KEEP = 9216, 8000
# its entry bound's rms share: BWD_RMS_SHARE was set for sums over at most
# 1,024 terms; here each gradient sums LONG_T terms that nearly cancel,
# and the f32 rounding of such a sum grows as the square root of its
# length.  Against the float64 function (`flash_bwd_float64`, on an H100) the
# f32 dk and dv read 1.24x and 1.01x the unscaled bound, the kernel's and
# the plain version's alike (the same bits), and dq 0.46x (kernel) and
# 1.05x (plain, cuBLAS's order): the error is the f32 sum's own, and the
# kernel's dq is the closer of the two
LONG_RMS_SHARE = BWD_RMS_SHARE * (LONG_T / 1024) ** 0.5
# f32 autograd through the kernels vs the plain path (dq, dk, dv and a
# trainable bias's cotangent), each relative to its largest entry: the
# same f32 math in other summation orders (the card tests read ~1e-6)
AUTOGRAD_F32_RTOL = 1e-4
# train_bert_drop_f32, kernels vs plain attention with dropout on both
# (the same keep-bits, the same hidden masks), per-step loss (relative):
# as train_f32's bound (train_bert_f32, without dropout, reads ~1e-7 on
# an H100)
TRAIN_DROP_F32_LOSS_RTOL = 1e-5
# flash decode (f32) vs its split plain version (flash_decode_split_reference:
# the same chunks of 128 keys and the same combine, summed in another order
# inside a chunk): a few f32 roundings of outputs below 1 in magnitude
DECODE_SPLIT_TOL = 1e-6
# the sparse slice: GPT-2 124M's attention (12 heads of 64) at the lengths
# of the JAX package's long-context records, 8 layers, batch 1
SPARSE_TS = (8192, 16384)
SPARSE_LAYERS = 8
# serve_tiers_bf16: 16 sessions x 3 turns of 96..192 new prompt tokens and
# 32 greedy tokens each on the paged pool (8 slots x 1024 positions, pages
# of 128, 160 pages), with tiers off (the reference: every session warm)
# and on (a residency window of 256 tokens, 24 host pages, then disk).
# The watermark is 0.15 of the pool: at 0.3 the parked sessions (2-5 pages
# each) stay under it once the learned prefixes have moved out, and no
# session reaches the disk before its next turn (a CPU rehearsal at these
# page counts: 0 disk hits at 0.3, 2 and 5 after turns 2 and 3 at 0.15)
TIER_SESSIONS, TIER_TURNS, TIER_TAIL, TIER_NEW = 16, 3, (96, 192), 32
TIER_SERVING = {"num_slots": 8, "prefill_chunk": 64, "max_len": 1024,
                "kvcache": {"enabled": True, "page_len": 128, "num_pages": 160}}
TIER_KNOBS = {"enabled": True, "demote_watermark": 0.15, "residency_window": 256,
              "host_pages": 24, "demote_batch": 8, "prefetch_ahead": 2}
# a tier move's bound: the page's bytes over the host link, PCIe 5.0 x16
# at 64 GB/s each way (the PCI-SIG rate of the H100 SXM's host interface)
HOST_LINK_BYTES = 64e9
# transformer_layer's f32 check, 24 layers at B 2 through the kernels vs
# plain attention on the same seeds: the output and the input's gradient
# within this share of their largest entries (f32 sums in other orders,
# carried through 24 pre-LN layers)
LAYER_F32_RTOL = 1e-4


_T0 = time.perf_counter()
_LAST_PHASE = [_T0]  # when the previous phase line was printed


class BackgroundBuild(threading.Thread):
    """``kernels.build(names, force=True)`` on a thread of its own (its
    ``nvcc`` processes run beside the caller's work; a kernel's first call
    waits for its own source's compile); :meth:`wait` joins it and returns
    its seconds, or raises its error.  ``BackgroundBuild.running`` is the
    one in flight, whose overlap with each phase that phase's line notes."""

    running = None

    def __init__(self, kernels, names):
        super().__init__(daemon=True)
        self.kernels, self.names = kernels, names
        self.result = self.error = None
        self.t0 = time.perf_counter()
        self.t1 = self.wall_s = None
        BackgroundBuild.running = self
        self.start()

    def run(self):
        try:
            self.result = self.kernels.build(self.names, force=True)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self.error = e
        self.t1 = time.perf_counter()
        self.wall_s = self.t1 - self.t0

    def overlap_s(self, t0, t1):
        """Seconds of ``[t0, t1]`` that the compile ran."""
        return max(0.0, min(t1, self.t1 or t1) - max(t0, self.t0))

    def wait(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.result


def emit(obj) -> None:
    """One JSON line; a phase's line notes the script's seconds so far and
    the seconds since the previous phase line that the background compile
    ran beside it (its host numbers shared the CPU with ``nvcc`` then)."""
    if "phase" in obj:
        now, build = time.perf_counter(), BackgroundBuild.running
        obj = {**obj, "script_elapsed_s": now - _T0,
               "nvcc_overlap_s": build.overlap_s(_LAST_PHASE[0], now) if build else 0.0}
        _LAST_PHASE[0] = now
    print(json.dumps(obj), flush=True)


class Fail(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise Fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, flush, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each after
    an L2 flush, from CUDA events around the launch alone."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound_ms(nbytes, flops, dtype_name, int_ops=0):
    """The least time for the work: bytes over the memory rate, or the
    operations over their pipe's peak (the dots' on the tensor or CUDA
    cores, dropout's integer operations on the INT32 pipe; the pipes run
    side by side, so the slower of them), whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype_name], int_ops / PEAK_INT32_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def body(dtype_name):
    """The B1/B2/B6 body a dtype takes: bf16 the tensor cores', f32 the CUDA cores'."""
    return "tc" if dtype_name == "bfloat16" else "simt"


def only_tc(variants):
    """Whether an attention launch count by variant holds tensor-core launches only."""
    return bool(variants) and all(v.endswith("/tc") for v in variants)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def grad_err(a, b, tol, rms_share=BWD_RMS_SHARE):
    """``(max |a - b|, max of |a - b| over its bound)`` for the backward's
    entry-by-entry bound ``tol * (|b| + rms_share * rms(b))``; the check
    passes where the second is at most 1."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    bound = tol * (b.abs() + rms_share * b.square().mean().sqrt())
    worst = (diff / bound.clamp_min(1e-30)).max()
    return float(diff.max()), float(worst)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash_fwd(torch, dev, flush):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, d = 4, 12, 64
    rows = []
    for T in (256, 512, 200):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(T)
            q, k, v = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype) for _ in range(3))
            scale = d ** -0.5
            out, _ = fa.flash_fwd_cuda(q, k, v, causal=True, sm_scale=scale)
            ref, _ = fa.flash_fwd_reference(q, k, v, True, scale)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            err, tol = max_err(out, ref), TOL[name]
            check(torch.isfinite(out).all().item(), f"flash_fwd T={T} {name}: non-finite output")
            check(err <= tol, f"flash_fwd T={T} {name}: max_err {err} > tol {tol}")
            item = dtype.itemsize
            nbytes = 4 * B * H * T * d * item
            flops = 4 * B * H * d * T * (T + 1) / 2
            b_ms, b_by = bound_ms(nbytes, flops, name)
            row = {
                "phase": "kernel", "kernel": "flash_fwd", "body": body(name), "B": B, "H": H,
                "T": T, "d": d, "dtype": name, "causal": True, "max_err": err, "tol": tol,
                "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale), flush),
                "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, True, scale), flush),
                "library_ms": device_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), flush),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            rows.append(row)
    return rows


def _decode_inputs(torch, dev, kv, masked, B=8, H=12, S=1024, d=64):
    from deepspeed_tpu_torch.ops.transformer.inference import _kv_quant

    g = torch.Generator(device=dev).manual_seed(1234)
    qdtype = torch.float32 if kv == "float32" else torch.bfloat16
    q = torch.randn(B, H, 1, d, generator=g, device=dev).to(qdtype)
    k32 = torch.randn(B, H, S, d, generator=g, device=dev)
    v32 = torch.randn(B, H, S, d, generator=g, device=dev)
    if kv == "int8":
        kc, vc = (dict(zip(("q", "s"), _kv_quant(t))) for t in (k32, v32))
    else:
        kc, vc = k32.to(qdtype), v32.to(qdtype)
    # per-slot positions: a fresh slot (0), a full cache (S-1), the rest between
    pos = torch.tensor([0, S - 1, 100, 511, 777, 1, 300, 1000][:B], dtype=torch.int32, device=dev)
    kpm = None
    if masked:
        kpm = torch.rand(B, S, generator=g, device=dev) > 0.3
        kpm[:, 0] = True
        kpm[5, :2] = False  # slot 5 (pos 1) has no attendable key: uniform over S
    return q, kc, vc, pos, kpm


def _decode_cost(kv, pos, kpm, B, H, S, d, q_item):
    """Bytes and flops this call's data needs: each attendable K and V row
    once (all S rows of a slot with no attendable key), q, out, pos, and
    the int8 scales and mask prefix where present."""
    kv_item = {"float32": 4, "bfloat16": 2, "int8": 1}[kv]
    rows = 0
    for b in range(B):
        n = min(int(pos[b]), S - 1) + 1
        if kpm is not None and not bool(kpm[b, :n].any()):
            n = S
        rows += n
    nbytes = rows * H * d * 2 * kv_item + 2 * B * H * d * q_item + 4 * B
    if kv == "int8":
        nbytes += rows * H * 2 * 4
    if kpm is not None:
        nbytes += rows
    return nbytes, 4 * rows * H * d


# a tensor-parallel rank's heads at mp_size 4 (serve_tp_bf16): GPT-2's 12
# (d 64) and GPT-Neo-2.7B's 20 (d 128) over four ranks
TP_DECODE_HEADS = ((3, 64), (5, 128))


def _decode_row(torch, F, fd, dev, flush, kv, masked, B, H, S, d):
    q, kc, vc, pos, kpm = _decode_inputs(torch, dev, kv, masked, B, H, S, d)
    out = fd.flash_decode_cuda(q, kc, vc, pos, key_padding_mask=kpm)
    again = fd.flash_decode_cuda(q, kc, vc, pos, key_padding_mask=kpm)
    ref = fd.flash_decode_reference(q, kc, vc, pos, key_padding_mask=kpm)
    split = fd.flash_decode_split_reference(q, kc, vc, pos, key_padding_mask=kpm)
    torch.cuda.synchronize()
    qname = str(q.dtype).replace("torch.", "")
    label = f"flash_decode {kv} masked={masked} H={H} d={d}"
    err, tol = max_err(out, ref), TOL[qname]
    split_err = max_err(out, split)
    check(torch.isfinite(out).all().item(), f"{label}: non-finite")
    check(err <= tol, f"{label}: max_err {err} > tol {tol}")
    check(torch.equal(out, again), f"{label}: differs between two launches")
    if qname == "float32":
        check(split_err <= DECODE_SPLIT_TOL, f"{label}: {split_err} from its split plain "
                                             f"version > {DECODE_SPLIT_TOL}")
    pos_h, kpm_h = pos.cpu(), (kpm.cpu() if kpm is not None else None)
    nbytes, flops = _decode_cost(kv, pos_h, kpm_h, B, H, S, d, q.element_size())
    b_ms, b_by = bound_ms(nbytes, flops, qname)
    library_ms = None
    if kv != "int8":
        allowed = torch.arange(S, device=dev)[None, :] <= pos[:, None].long()
        if kpm is not None:
            allowed = allowed & kpm
        amask = allowed[:, None, None, :]
        library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=amask), flush)
    row = {
        "phase": "kernel", "kernel": "flash_decode", "B": B, "H": H, "S": S, "d": d,
        "kv": kv, "q_dtype": qname, "masked": masked, "pos": pos_h.tolist(),
        "max_err": err, "tol": tol, "split_plain_max_err": split_err,
        "split_plain_tol": DECODE_SPLIT_TOL if qname == "float32" else None,
        "splits": -(-S // fd.DECODE_CHUNK), "bitwise_repeatable": True,
        "kernel_ms": device_ms(torch, lambda: fd.flash_decode_cuda(
            q, kc, vc, pos, key_padding_mask=kpm), flush),
        "plain_ms": device_ms(torch, lambda: fd.flash_decode_reference(
            q, kc, vc, pos, key_padding_mask=kpm), flush),
        "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(row)
    return row


def check_flash_decode(torch, dev, flush):
    """B4 at the slot pool's serving shape (8 slots x 1024 positions, GPT-2's
    12 heads) in bf16, int8 and f32, with and without a key mask; then in
    bf16 at a tensor-parallel rank's heads (:data:`TP_DECODE_HEADS`)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.kernels import flash_decode as fd

    B, S = 8, 1024
    rows = [_decode_row(torch, F, fd, dev, flush, kv, masked, B, 12, S, 64)
            for kv in ("bfloat16", "int8", "float32") for masked in (False, True)]
    rows += [_decode_row(torch, F, fd, dev, flush, "bfloat16", False, B, H, S, d)
             for H, d in TP_DECODE_HEADS]
    return rows


def check_flash_decode_paged(torch, dev, flush):
    """B5 at the paged pool's serving shape: 8 slots x 8 pages of 128 rows
    over a permuted 129-page pool (the default 1 + 2 x 64), ragged
    positions, in bf16, f32 and int8 at GPT-2's 12 heads and in bf16 at a
    tensor-parallel rank's (:data:`TP_DECODE_HEADS`); against its plain
    version and, bit for bit, against B4 over the gathered contiguous
    view."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.kernels import flash_decode as fd
    from deepspeed_tpu_torch.ops.transformer.inference import _kv_quant

    B, P, page_len = 8, 8, 128
    S, NP = P * page_len, 1 + 2 * B * P
    rows = []
    shapes = [(kv, 12, 64) for kv in ("bfloat16", "int8", "float32")]
    shapes += [("bfloat16", H, d) for H, d in TP_DECODE_HEADS]  # a tensor-parallel rank's
    for kv, H, d in shapes:
        g = torch.Generator(device=dev).manual_seed(4321)
        qdtype = torch.float32 if kv == "float32" else torch.bfloat16
        q = torch.randn(B, H, 1, d, generator=g, device=dev).to(qdtype)
        k32 = torch.randn(NP, H, page_len, d, generator=g, device=dev)
        v32 = torch.randn(NP, H, page_len, d, generator=g, device=dev)
        if kv == "int8":
            kc, vc = (dict(zip(("q", "s"), _kv_quant(t))) for t in (k32, v32))
        else:
            kc, vc = k32.to(qdtype), v32.to(qdtype)
        del k32, v32
        perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(5)) + 1
        table = perm[:B * P].reshape(B, P).to(torch.int32).to(dev)
        pos = torch.tensor([0, S - 1, 100, 511, 777, 1, 300, 1000], dtype=torch.int32, device=dev)
        out = fd.flash_decode_paged_cuda(q, kc, vc, table, pos)
        again = fd.flash_decode_paged_cuda(q, kc, vc, table, pos)
        ref = fd.flash_decode_paged_reference(q, kc, vc, table, pos)
        b4 = fd.flash_decode_cuda(q, fd.paged_gather(kc, table), fd.paged_gather(vc, table), pos)
        torch.cuda.synchronize()
        qname = str(qdtype).replace("torch.", "")
        err, tol = max_err(out, ref), TOL[qname]
        label = f"flash_decode_paged {kv} H={H} d={d}"
        check(torch.isfinite(out).all().item(), f"{label}: non-finite")
        check(err <= tol, f"{label}: max_err {err} > tol {tol}")
        check(torch.equal(out, again), f"{label}: differs between two launches")
        check(torch.equal(out, b4), f"{label}: differs from flash_decode over the "
                                    f"gathered view by {max_err(out, b4)} (one body: must be equal)")
        pos_h = pos.cpu()
        nbytes, flops = _decode_cost(kv, pos_h, None, B, H, S, d, q.element_size())
        nbytes += B * P * 4  # the page table
        b_ms, b_by = bound_ms(nbytes, flops, qname)
        library_ms = None
        if kv != "int8":
            ids = table.reshape(-1).long()

            def gather_sdpa():
                gk, gv = (c.index_select(0, ids).view(B, P, H, page_len, d).transpose(1, 2)
                          .reshape(B, H, S, d) for c in (kc, vc))
                return F.scaled_dot_product_attention(q, gk, gv, attn_mask=amask)

            amask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
            library_ms = device_ms(torch, gather_sdpa, flush)
        row = {
            "phase": "kernel", "kernel": "flash_decode_paged", "B": B, "H": H, "P": P,
            "page_len": page_len, "num_pages": NP, "d": d, "kv": kv, "q_dtype": qname,
            "pos": pos_h.tolist(), "max_err": err, "tol": tol, "equal_to_flash_decode_gathered": True,
            "bitwise_repeatable": True,
            "kernel_ms": device_ms(torch, lambda: fd.flash_decode_paged_cuda(q, kc, vc, table, pos),
                                   flush),
            "plain_ms": device_ms(torch, lambda: fd.flash_decode_paged_reference(
                q, kc, vc, table, pos), flush),
            # no single PyTorch call computes this function: two calls,
            # index_select of the pages then SDPA with a boolean mask
            "library_ms": library_ms, "library_calls": "index_select + scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        rows.append(row)
        del kc, vc
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------

def serve(srv, reqs):
    """Submit ``reqs`` (ten, two steps, then the rest, so slots churn
    mid-decode), drain, and return the finished requests in order with
    the drain's wall seconds."""
    import torch

    from deepspeed_tpu_torch.tools.profile_serving import drain_request_mix

    t0 = time.perf_counter()
    out = drain_request_mix(srv, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, (p, n) in zip(out, reqs):
        check(r.finish_reason == "length" and len(r.generated) == n,
              f"request {r.request_id}: finish {r.finish_reason}, {len(r.generated)} of {n} tokens")
        check(all(0 <= t < 50257 for t in r.generated), f"request {r.request_id}: token out of vocab")
    return out, wall


def top2_gap(eng, tokens):
    """Top-1 minus top-2 logit of the next token after ``tokens``."""
    import torch

    k, v = eng.init_cache(1, len(tokens))
    logits, _, _ = eng.prefill(np.asarray(tokens)[None, :], k, v)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def near_tie_flips(eng, done, wants, label):
    """The first token where each served request's tokens differ from
    the expected ones, which must sit on a near-tie of the top-2 logits
    of ``eng`` (f32)."""
    flips = []
    for r, want in zip(done, wants):
        got = r.tokens()
        if np.array_equal(want, got):
            continue
        i = int(np.nonzero(want != got)[0][0])
        gap = top2_gap(eng, got[:i])
        flips.append({"request": r.request_id, "at": i - r.prompt_len, "top2_gap": gap})
        check(gap < F32_NEAR_TIE,
              f"{label} request {r.request_id}: served token {i - r.prompt_len} differs with "
              f"top-2 gap {gap} >= {F32_NEAR_TIE}")
    return flips


def phase_serve_f32(torch, params, reqs):
    import deepspeed_tpu_torch

    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", params=params, dtype=torch.float32,
        serving={"num_slots": 8, "prefill_chunk": 64})
    done, wall = serve(srv, reqs)
    eng = srv.engine
    solo = [eng.generate(r.prompt[None, :], max_new_tokens=len(r.generated))[0] for r in done]
    flips = near_tie_flips(eng, done, solo, "serve_f32 vs solo generate()")
    emit({"phase": "serve_f32", "requests": len(done),
          "tokens": int(sum(len(r.generated) for r in done)),
          "equal_to_solo_generate": len(done) - len(flips), "near_tie_flips": flips,
          "near_tie_tol": F32_NEAR_TIE, "wall_s": wall})
    del srv, eng


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


GEN_NEW = 16


def generate_ids():
    """``serve_bf16``'s ``generate()`` prompts: 4 rows of 256 tokens."""
    return np.random.default_rng(7).integers(1, 50257, (4, 256), dtype=np.int32)


def phase_serve_bf16(torch, params, reqs):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.transformer.inference import forward_with_cache, init_kv_cache

    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", params=params, dtype=torch.bfloat16,
        serving={"num_slots": 8, "prefill_chunk": 64})
    eng = srv.engine
    gen_ids = generate_ids()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    done, wall = serve(srv, reqs)
    t0 = time.perf_counter()
    gen = eng.generate(gen_ids, max_new_tokens=GEN_NEW)
    gen_wall = time.perf_counter() - t0
    launches = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------

    check(gen.shape == (4, 256 + GEN_NEW) and np.array_equal(gen[:, :256], gen_ids),
          f"generate() returned {gen.shape}")
    for name in ("flash_fwd", "flash_decode"):
        check(launches[name] > 0, f"kernel {name} was not launched on the serving main path")
    check(only_tc(variants["flash_fwd"]),
          f"serve_bf16: the bf16 prefill ran {variants['flash_fwd']}, not only the tensor-core body")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    n_tok = int(sum(len(r.generated) for r in done))
    stats = srv.stats()
    emit({"phase": "serve_bf16", "requests": len(done), "tokens": n_tok,
          "ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
          # TTFT counts the queue wait for a slot; decode tokens/s is the
          # decode steps' tokens over their host wall time
          "tokens_per_s": n_tok / wall, "wall_s": wall,
          "decode_tokens_per_s": (n_tok - len(done)) / stats["phase_seconds"]["decode"],
          "decode_steps": stats["decode_steps"], "prefill_chunks": stats["prefill_chunks"],
          "phase_seconds": stats["phase_seconds"],
          "generate": {"B": 4, "T": 256, "new": GEN_NEW, "wall_s": gen_wall},
          "launches": launches, "flash_fwd_variants": variants["flash_fwd"]})

    # -- kernel path vs plain path on the card, first-step logits ----------
    cfg = eng.model_config
    S = 256 + 16
    icfg = eng.inference_config(S)
    plain = dataclasses.replace(icfg, use_flash_attention=False)
    toks = torch.from_numpy(gen_ids.astype(np.int64)).to(eng.device)
    errs = {}
    with torch.inference_mode():
        outs = {}
        for name, c in (("kernel", icfg), ("plain", plain)):
            k, v = init_kv_cache(cfg.n_layer, 4, cfg.n_head, S, cfg.head_dim, torch.bfloat16,
                                 device=eng.device)
            pre, _, _ = forward_with_cache(eng.params, toks, k, v, 0, c)
            nxt = torch.argmax(pre[:, -1], dim=-1)[:, None]
            pos = torch.full((4,), 256, dtype=torch.int32, device=eng.device)
            dec, _, _ = forward_with_cache(eng.params, nxt, k, v, pos, c)
            outs[name] = (pre, nxt, dec)
        kp, kn, kd = outs["kernel"]
        pp, pn, pd = outs["plain"]
        errs["prefill"] = max_err(kp, pp)
        errs["decode"] = max_err(kd, pd) if torch.equal(kn, pn) else None
    check(all(torch.isfinite(t).all().item() for t in (kp, kd, pp, pd)), "non-finite logits")
    check(errs["prefill"] <= BF16_LOGIT_TOL, f"bf16 prefill logits differ by {errs['prefill']}")
    check(errs["decode"] is not None and errs["decode"] <= BF16_LOGIT_TOL,
          f"bf16 decode logits differ by {errs['decode']}")
    emit({"phase": "logits_bf16", "B": 4, "T": 256, "max_abs_err": errs, "tol": BF16_LOGIT_TOL,
          "logit_range": [float(pp.min()), float(pp.max())]})
    return launches, {"slot": [r.tokens().tolist() for r in done], "generate": gen.tolist()}


# ---------------------------------------------------------------------------
# phases 7 and 8: the paged serving path
# ---------------------------------------------------------------------------

PAGED = {"num_slots": 8, "prefill_chunk": 64, "kvcache": {"enabled": True, "page_len": 128}}


def accounted_pages(pool):
    """Pages the host bookkeeping holds: index entries, parked sessions
    and mapped slots (the leak check of the JAX package's tests)."""
    pages = set()
    for e in pool.index.entries():
        pages.update(e.pages)
    for s in pool.sessions.warm():
        pages.update(s.pages)
    for ps in pool._slot_pages.values():
        pages.update(ps)
    return pages


def slot_replay(srv, done):
    """Serve the prompts of ``done`` (with their budgets) on ``srv`` and
    return its tokens in order."""
    rids = [srv.submit(r.prompt, max_new_tokens=len(r.generated)) for r in done]
    res = srv.drain()
    return [res[r].tokens() for r in rids]


def phase_serve_paged_f32(torch, params, mix):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import drain_paged_mix

    srv = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=torch.float32,
                                           serving=PAGED)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    done, turns = drain_paged_mix(srv, mix)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check(launches["flash_decode_paged"] > 0 and launches["flash_decode"] == 0,
          f"serve_paged_f32: decode launches {launches}")
    kv = srv.stats()["kvcache"]
    check(kv["prefix_hits"] >= 6 and kv["cow_copies"] >= 1 and kv["session_rebinds"] == 2,
          f"serve_paged_f32: kvcache counters {kv}")
    check(srv.pool.live_slots == 0 and kv["pages_live"] == len(accounted_pages(srv.pool)),
          f"serve_paged_f32: {kv['pages_live']} live pages, "
          f"{len(accounted_pages(srv.pool))} accounted for")
    allreq = done + turns
    for r in allreq:
        check(r.finish_reason == "length" and all(0 <= t < 50257 for t in r.generated),
              f"serve_paged_f32 request {r.request_id}: {r.finish_reason}")
    eng = srv.engine
    del srv
    from deepspeed_tpu_torch.serving import ServingEngine

    want = slot_replay(ServingEngine(eng, num_slots=8, prefill_chunk=64), allreq)
    flips = near_tie_flips(eng, allreq, want, "serve_paged_f32 vs the slot engine")
    emit({"phase": "serve_paged_f32", "requests": len(allreq), "session_turns": len(turns),
          "tokens": int(sum(len(r.generated) for r in allreq)),
          "equal_to_slot_engine": len(allreq) - len(flips), "near_tie_flips": flips,
          "near_tie_tol": F32_NEAR_TIE, "kvcache": kv, "launches": launches, "wall_s": wall})
    del eng
    torch.cuda.empty_cache()


def _served_summary(srv, done, wall):
    st = srv.stats()
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    n_tok = int(sum(len(r.generated) for r in done))
    return {"ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
            "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "decode_tokens_per_s": (n_tok - len(done)) / st["phase_seconds"]["decode"],
            "decode_ms_per_step": st["phase_seconds"]["decode"] / st["decode_steps"] * 1e3,
            "decode_steps": st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
            "phase_seconds": st["phase_seconds"]}


# ---------------------------------------------------------------------------
# telemetry: the plane's checks inside serve_paged_bf16 and train_bf16
# ---------------------------------------------------------------------------

TEL_RTOL = 0.01  # bucket ms vs the kernels' summed ms; the matmul bucket vs 6N
TTFT_MATCH_MS = 1.0  # TTFT from a request's spans vs its serving/ttft_ms sample
# the attributed serving steps' prompts: one 64-token chunk, or four
TEL_SERVE_PROMPTS = (32, 32, 32, 32, 200, 200, 200, 200)
# the off / registry-only / armed comparison: training in windows of
# TEL_WINDOW_STEPS steps closed by one synchronize, TEL_WINDOWS windows a
# setting, interleaved (off, registry, armed; armed, registry, off; ...);
# every setting prints every TEL_PRINT steps, so each window holds one
# print step.  Serving: each engine one cold drain of the paged mix's
# requests, then TEL_SERVE_DRAINS warm ones a setting, interleaved alike
TEL_WINDOW_STEPS, TEL_WINDOWS, TEL_PRINT = 5, 4, 5
TEL_SERVE_DRAINS = 2


def sync_count(torch, fn):
    """``(sites, fn())``: ``fn`` under
    ``torch.cuda.set_sync_debug_mode("warn")``; ``sites`` names the Python
    line of each synchronizing call it made (each warning it raised)."""
    import warnings

    import traceback

    sites = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message).lower():
            stack = traceback.extract_stack()[:-1]
            sites.append(" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                     for f in reversed(stack[-6:])))

    torch.cuda.synchronize()
    # armed outside the capture: arming warns once itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites, out


def check_trace(label, path, lanes=None):
    """The exported trace: it passes the schema check; with ``lanes`` (a
    list of request ids) each request has a lane of its own holding its
    queue and prefill spans.  Returns ``(doc, spans by lane)``."""
    from deepspeed_tpu_torch import telemetry

    doc = json.load(open(path))
    problems = telemetry.validate_chrome_trace(doc)
    check(not problems, f"{label}: trace schema: {problems[:5]}")
    by_lane = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X" and e["pid"] == telemetry.PID_REQUESTS:
            by_lane.setdefault(e["tid"], {})[e["name"]] = e
    if lanes is not None:
        check(sorted(by_lane) == sorted(lanes),
              f"{label}: {len(by_lane)} request lanes for {len(lanes)} requests")
        check(all({"queue", "prefill"} <= set(v) for v in by_lane.values()),
              f"{label}: a lane without its queue or prefill span")
    return doc, by_lane


def check_attention_launches(label, attr, counted, timed, names):
    """The attention bucket holds every launch of ``names``: the counted
    step's kernel launches (the static part) and the timed window's kernel
    events (the timed part) against the launch counters of the same
    calls; the buckets' device ms sum to the kernels' summed ms; and the
    timed attention bucket also holds kernels of the attention modules'
    own aten ops (each linked through its op's range, as the counted step
    buckets that op), so its ms and its counted bytes cover the same work."""
    from deepspeed_tpu_torch.telemetry.attribution import class_bucket

    static = attr.launches("attention")
    for name in names:
        check(static.get(name, 0) == counted.get(name, 0),
              f"{label}: attention bucket holds {static.get(name, 0)} {name} launches of "
              f"{counted.get(name, 0)}")
    tm = attr.timing or {}
    check(tm.get("device_ms") is not None,
          f"{label}: the profiler window traced no kernel of the card")
    events = tm.get("launches_by_class") or {}
    for name in names:
        check(class_bucket(name) == "attention" and events.get(name, 0) == timed.get(name, 0),
              f"{label}: {events.get(name, 0)} {name} kernel events for "
              f"{timed.get(name, 0)} launches in the timed window")
    total = sum((tm.get("device_ms") or {}).values())
    kernels_ms = tm.get("kernels_ms") or 0.0
    check(abs(total - kernels_ms) <= TEL_RTOL * kernels_ms,
          f"{label}: buckets {total} ms vs kernels {kernels_ms} ms")
    hand = sum(events.get(name, 0) for name in names)
    check(tm["kernel_events"]["attention"] > hand,
          f"{label}: the attention bucket holds {tm['kernel_events']['attention']} kernel "
          f"events, the {hand} hand launches alone: its aten ops' kernels found no range "
          f"({tm.get('unranged_kernels')} unranged)")
    return {"device_ms": tm.get("device_ms"), "kernels_ms": tm.get("kernels_ms"),
            "busy_ms": tm.get("busy_ms"), "window_ms": tm.get("window_ms"),
            "kernel_events": tm.get("kernel_events"),
            "unranged_kernels": tm.get("unranged_kernels"), "launches_counted": counted,
            "launches_timed": timed,
            "flops": {b: attr.buckets[b].flops for b in attr.buckets},
            "bytes": {b: attr.buckets[b].bytes for b in attr.buckets},
            "recompute": attr.meta.get("recompute")}


def _spread(samples):
    """A setting's samples: their median, and their spread (max - min)."""
    return {"median": float(np.median(samples)),
            "spread": float(max(samples) - min(samples)), "samples": list(samples)}


def _compare(rows, key):
    """Each setting against ``off`` on ``key``: the difference of the
    medians, resolved only where it exceeds the larger of the two
    settings' spreads."""
    off = rows["off"][key]
    out = {}
    for name in ("registry", "armed"):
        got = rows[name][key]
        diff = got["median"] - off["median"]
        out[name] = {"diff": diff, "rel": diff / off["median"],
                     "resolved": abs(diff) > max(got["spread"], off["spread"])}
    return out


def _mix_rates(torch, srv, mix):
    """One drain of ``paged_request_mix``'s requests (the shared prefix
    among them, the slots churning mid-decode; the session's turns, each a
    drain of one request, left out) on ``srv``: ``(requests, rates)``, the
    rates of this drain alone (decode tokens/s over its decode phase's
    seconds, TTFT p50/p99, wall)."""
    dec0 = srv.stats()["phase_seconds"]["decode"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=n) for p, n in mix[0][:10]]
    srv.step()
    srv.step()
    rids += [srv.submit(p, max_new_tokens=n) for p, n in mix[0][10:]]
    res = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [res[r] for r in rids]
    dec = srv.stats()["phase_seconds"]["decode"] - dec0
    n_tok = int(sum(len(r.generated) for r in reqs))
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs]
    return reqs, {"decode_tokens_per_s": (n_tok - len(reqs)) / dec,
                  "ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
                  "tokens": n_tok, "wall_s": wall}


def serve_telemetry(torch, params, mix, cfg, off_summary):
    """serve_paged_bf16's telemetry: three fresh paged engines on the
    mix's 16 requests, with the plane off, the registry only and
    everything armed (registry, trace, JSONL and Prometheus sinks; the
    process's plane switched before each drain): each engine one cold
    drain (off, registry, armed), then TEL_SERVE_DRAINS warm drains a
    setting in turns (armed, registry, off; off, registry, armed), whose
    decode tokens/s and TTFT p50 are compared (median and spread); the
    armed cold drain's trace validates with one lane per request, and
    TTFT from each lane's spans equals its ``serving/ttft_ms`` sample
    within TTFT_MATCH_MS; then one counted and two timed serving steps
    (prefill chunks and decode) for the attribution checks."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.profiling.flops_profiler import device_name
    from deepspeed_tpu_torch.telemetry import attribution

    t_start = time.perf_counter()
    out = {"main_path": off_summary, "cold": {}, "off": [], "registry": [], "armed": []}
    with tempfile.TemporaryDirectory() as tel_dir:
        blocks = {"off": {"enabled": False}, "registry": {"enabled": True},
                  "armed": {"enabled": True, "trace": True, "exporters": ["jsonl", "prometheus"],
                            "output_path": tel_dir, "export_interval_seconds": 3600}}
        engines = {}
        for name, block in blocks.items():  # each engine attaches to the plane armed now
            telemetry.configure(block, label="serving")
            engines[name] = deepspeed_tpu_torch.init_serving(
                model="gpt2", params=params, dtype=torch.bfloat16, serving=cfg)
        hist = telemetry.get_registry().histogram("serving/ttft_ms", engine="serving")
        # each engine one cold drain (its prefix cache and allocator), then
        # the warm drains in turns
        warm = [(("armed", "registry", "off"), ("off", "registry", "armed"))[i % 2]
                for i in range(TEL_SERVE_DRAINS)]
        order = ("off", "registry", "armed", *[name for turn in warm for name in turn])
        for turn, name in enumerate(order):
            telemetry.configure(blocks[name], label="serving")
            if turn == 2:
                telemetry.get_tracer().clear()
                before = len(hist._ring)
            reqs, rates = _mix_rates(torch, engines[name], mix)
            if turn < 3:
                out["cold"][name] = rates
            else:
                out[name].append(rates)
            if turn != 2:
                continue
            doc, lanes = check_trace("serve_paged_bf16 telemetry", telemetry.export_trace(),
                                     [r.request_id for r in reqs])
            rebuilt = sorted((v["prefill"]["ts"] + v["prefill"]["dur"] - v["queue"]["ts"]) / 1e3
                             for v in lanes.values())
            samples = sorted(list(hist._ring)[before:])
            worst = max(abs(a - b) for a, b in zip(rebuilt, samples))
            check(len(samples) == len(rebuilt) and worst <= TTFT_MATCH_MS,
                  f"serve_paged_bf16 telemetry: TTFT from spans vs histogram differ by {worst} ms "
                  f"({len(rebuilt)} lanes, {len(samples)} samples)")
            telemetry.flush()
            files = sorted(os.listdir(tel_dir))
            check({"metrics_rank0.jsonl", "metrics_rank0.prom", "trace.json"} <= set(files),
                  f"serve_paged_bf16 telemetry: files {files}")
        for name in blocks:
            out[name] = {"drains": out[name], **{key: _spread([r[key] for r in out[name]])
                                                 for key in ("decode_tokens_per_s", "ttft_ms_p50")}}
        out["vs_off"] = {key: _compare(out, key) for key in ("decode_tokens_per_s", "ttft_ms_p50")}
        srv = engines.pop("armed")
        del engines
        torch.cuda.empty_cache()

        # attribution: one counted step and two timed ones, prefill and decode
        rng = np.random.default_rng(22)
        for n in TEL_SERVE_PROMPTS:
            srv.submit(rng.integers(1, srv.engine.model_config.vocab_size, n, dtype=np.int32),
                       max_new_tokens=16)
        for _ in range(64):  # until decoding, with prompts still prefilling
            if srv.decode_steps > 0:
                break
            srv.step()
        dev = device_name()
        with attribution.counting("serving_step", dev) as count:
            kernels.reset_launches()
            srv.step()
            counted = kernels.launches()
        attr = count.attribution(dev)
        kernels.reset_launches()
        with attribution.timing(steps=2) as win:
            srv.step()
            srv.step()
            torch.cuda.synchronize()
        timed = kernels.launches()
        check(not win.refused, "serve_paged_bf16 telemetry: profiler window refused")
        attr.set_timing(win.timing)
        # the paged pool's prefill chunks take the plain path (no B1), as
        # the main path's launches show; B5 decodes
        check(counted["flash_decode_paged"] > 0 and timed["flash_decode_paged"] > 0,
              f"serve_paged_bf16 telemetry: attributed steps launched {counted} / {timed}")
        out["attribution"] = check_attention_launches(
            "serve_paged_bf16 attribution", attr, counted, timed,
            ("flash_fwd", "flash_decode_paged"))
        srv.drain()
        out["trace_events"] = len(doc["traceEvents"])
        out["request_lanes"] = len(lanes)
        out["ttft_spans_vs_histogram_max_ms"] = worst
        del srv
        # disarm before the directory goes: the sinks' last flush lands in it
        telemetry.configure({"enabled": False})
    telemetry.get_registry().reset()
    telemetry.get_tracer().clear()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def train_telemetry(torch, cfg, params, config, batch, tokens):
    """train_bf16's telemetry: three fresh engines on the main path's
    model, config and batch, printing every TEL_PRINT steps, with the
    plane off, registry only (the default) and everything armed
    (registry, trace, attribution, the JSONL / Prometheus / TensorBoard
    sinks, ``wall_clock_breakdown``, the flops profiler at step 3), the
    process's plane switched before each window: two warm steps each (the
    armed engine's counted and timed steps), then TEL_WINDOWS windows of
    TEL_WINDOW_STEPS steps each, interleaved (off, registry, armed;
    armed, registry, off; ...), a window's wall closed by one
    synchronize (the steps read nothing on the host); the step ms are
    compared by median and spread; then the steps off and registry-only
    up to and through the next print step under the sync debug mode,
    whose synchronizing calls must be as many; the armed engine's trace
    (valid, the step phases: data_wait on the host, compute from CUDA
    events), the counted step's matmul bucket against 6N, the attention
    bucket against the B1/B2 launches, the MFU gauge."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.telemetry.attribution import analytic_matmul_flops

    t_start = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tel_dir:
        config = {**config, "steps_per_print": TEL_PRINT}
        cfgs = {"off": {**config, "telemetry": {"enabled": False}},
                "registry": {**config, "telemetry": {"enabled": True}},
                "armed": {**config, "wall_clock_breakdown": True,
                          "telemetry": {"enabled": True, "trace": True, "attribution": True,
                                        "exporters": ["jsonl", "prometheus", "tensorboard"],
                                        "output_path": tel_dir, "export_interval_seconds": 3600},
                          "tensorboard": {"enabled": True, "output_path": tel_dir},
                          "flops_profiler": {"enabled": True, "profile_step": 3}}}
        engines = {}
        for name, cfg_run in cfgs.items():
            engines[name], _, _, _ = deepspeed_tpu_torch.initialize(
                model=gpt2.make_model(cfg)[0], model_parameters=params, config=cfg_run)

        def arm(name):
            telemetry.configure(cfgs[name]["telemetry"], label="train",
                                monitor=engines[name].monitor)

        def window(name, steps):
            """ms a step over ``steps`` steps, one synchronize at the end."""
            arm(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engines[name].train_batch(batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps * 1e3

        launches = []
        for name in cfgs:
            for _ in range(2):
                kernels.reset_launches()
                window(name, 1)
                if name == "armed":
                    launches.append(kernels.launches())
        walls = {name: [] for name in cfgs}
        for i in range(TEL_WINDOWS):
            for name in (("off", "registry", "armed"), ("armed", "registry", "off"))[i % 2]:
                walls[name].append(window(name, TEL_WINDOW_STEPS))
        for name, ms in walls.items():
            out[name] = {"step_ms": _spread(ms), "steps": len(ms) * TEL_WINDOW_STEPS,
                         "tokens_per_s": tokens / float(np.median(ms)) * 1e3}
        out["vs_off"] = _compare(out, "step_ms")

        def to_print_step(name):
            """The steps up to and through the engine's next print step."""
            engine, steps = engines[name], []
            while not steps or engine.global_steps % TEL_PRINT:
                steps.append(engine.train_batch(batch))
            return len(steps)

        for name in ("off", "registry"):
            arm(name)
            sites, n = sync_count(torch, lambda: to_print_step(name))
            out[f"{name}_sync_sites"] = sites
            out[f"{name}_sync_steps"] = n
        off, reg = out["off_sync_sites"], out["registry_sync_sites"]
        check(len(off) == len(reg),
              f"train_bf16 telemetry: {len(off)} synchronizing calls off ({off}), "
              f"{len(reg)} registry-only ({reg})")
        arm("armed")
        engine = engines.pop("armed")
        del engines
        torch.cuda.empty_cache()
        attr = engine.train_step_attribution()
        check(attr is not None, "train_bf16 telemetry: no attribution table")
        want = analytic_matmul_flops(cfg.num_params(), tokens)
        got = attr.buckets["matmul"].flops
        check(abs(got - want) <= TEL_RTOL * want,
              f"train_bf16 attribution: matmul bucket {got} FLOPs vs 6N {want}")
        out["attribution"] = check_attention_launches(
            "train_bf16 attribution", attr, launches[0], launches[1], ("flash_fwd", "flash_bwd"))
        out["attribution"].update(matmul_flops=got, analytic_matmul_flops=want,
                                  table=attr.format_table(), roofline=attr.roofline())
        doc, _ = check_trace("train_bf16 telemetry", telemetry.export_trace())
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        compute = [e for e in spans if e["name"] == "train/compute"]
        armed_steps = 2 + TEL_WINDOWS * TEL_WINDOW_STEPS
        check(len(compute) == armed_steps
              and sum(e["name"] == "train/data_wait" for e in spans) == armed_steps,
              f"train_bf16 telemetry: {len(compute)} compute spans for {armed_steps} steps, "
              f"phases {sorted({e['name'] for e in spans})}")
        out["trace_compute_span_ms"] = [e["dur"] / 1e3 for e in compute]
        reg = telemetry.get_registry()
        out["mfu_gauge"] = reg.gauge("mfu", engine="train").value
        out["flops_per_step"] = reg.gauge("flops_per_step", engine="train").value
        out["flops_profiler"] = engine.flops_profiler.results
        # disarm before the monitor and the directory go: the sinks' last
        # flush lands in them
        telemetry.configure({"enabled": False})
        engine.monitor.close()
        files = sorted(os.listdir(tel_dir))
        check({"metrics_rank0.jsonl", "metrics_rank0.prom", "trace.json"} <= set(files)
              and os.listdir(os.path.join(tel_dir, "DeepSpeedJobName")),
              f"train_bf16 telemetry: files {files}")
        out["tensorboard_files"] = os.listdir(os.path.join(tel_dir, "DeepSpeedJobName"))
        del engine
    telemetry.get_registry().reset()
    telemetry.get_tracer().clear()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def phase_serve_paged_bf16(torch, params, mix):
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import drain_paged_mix

    out = {}
    # the slot engine on the same mix first (session turns are plain
    # requests there), then the paged engine: the paged serving main path
    slot = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=torch.bfloat16,
                                            serving={"num_slots": 8, "prefill_chunk": 64})
    t0 = time.perf_counter()
    done, turns = drain_paged_mix(slot, mix)
    torch.cuda.synchronize()
    out["slot"] = _served_summary(slot, done + turns, time.perf_counter() - t0)
    del slot
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as spill:
        cfg = {**PAGED, "kvcache": {**PAGED["kvcache"], "spill_dir": spill}}
        srv = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=torch.bfloat16,
                                               serving=cfg)
        # -- the main path: counters zeroed just before, read just after ---
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        done, turns = drain_paged_mix(srv, mix)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        # ------------------------------------------------------------------
        out["paged"] = _served_summary(srv, done + turns, wall)
        check(launches["flash_decode_paged"] > 0 and launches["flash_decode"] == 0,
              f"serve_paged_bf16: launches {launches}")
        kv = srv.stats()["kvcache"]
        check(kv["session_rebinds"] == 2 and kv["prefix_hits"] >= 6,
              f"serve_paged_bf16: kvcache counters {kv}")

        # -- a bf16 spill -> restore of the session -------------------------
        pool = srv.pool
        sess = pool.sessions.peek("chat-1")
        n_pages = len(sess.pages)
        before = pool._gather_host(sess.pages)
        check(pool.spill_sessions(time.monotonic()) == 1 and pool.sessions.is_spilled("chat-1"),
              "serve_paged_bf16: session not spilled")
        files = sorted(os.listdir(os.path.join(spill, os.listdir(spill)[0])))
        prompt = np.concatenate([turns[-1].tokens(), mix[1][1][0]])
        rid = srv.submit(prompt, max_new_tokens=8, session_id="chat-1")
        t4 = srv.drain()[rid]
        kv = srv.stats()["kvcache"]
        check(kv["session_restores"] == 1 and kv["session_rebinds"] == 3 and t4.prefix_hint > 0,
              f"serve_paged_bf16: restore {kv}, hit {t4.prefix_hint}")
        # the restored pages hold the spilled rows [0, hit) untouched: the
        # turn wrote positions >= hit only, and parked them again
        after = pool._gather_host(pool.sessions.peek("chat-1").pages[:n_pages])
        hit = t4.prefix_hint

        def head(leaf):  # (L, pages, H, page_len, x) -> (L, H, hit, x)
            L, n, Hh, pl, x = leaf.shape
            return leaf.permute(0, 2, 1, 3, 4).reshape(L, Hh, n * pl, x)[:, :, :hit]

        check(all(torch.equal(head(before[k]), head(after[k])) for k in before),
              "serve_paged_bf16: restored rows differ from the spilled ones")
        check(files == ["kv.npz", "manifest.json", "meta.json"], f"spill files {files}")
        del srv, pool
        torch.cuda.empty_cache()
        tel = serve_telemetry(torch, params, mix, PAGED, out["paged"])
        emit({"phase": "serve_paged_bf16", "requests": len(done) + len(turns),
              "paged": out["paged"], "slot": out["slot"], "kvcache": kv,
              "tokens_saved": kv["tokens_saved"],
              "prefill_chunks_saved": out["slot"]["prefill_chunks"] - out["paged"]["prefill_chunks"],
              "spill_restore": {"files": files, "restored_rows": hit, "leaves": sorted(before),
                                "dtype": str(before["k"].dtype)},
              "launches": launches, "telemetry": tel})
    torch.cuda.empty_cache()
    return launches, [r.tokens().tolist() for r in done + turns]


# ---------------------------------------------------------------------------
# serve_tiers_bf16 and serve_resilience_bf16: serving that survives a restart
# ---------------------------------------------------------------------------

def tier_turns(srv, seed=0):
    """``TIER_SESSIONS`` sessions x ``TIER_TURNS`` turns on ``srv``: each
    turn's prompt is the session's previous tokens plus a seeded tail;
    every session's turn is submitted, then drained.  Between turns the
    users think: with tiers, until the migration worker is idle (its disk
    writes done, as a think time of a few hundred ms would leave them).
    Returns the tokens by (turn, session) and the drained requests."""
    rng = np.random.default_rng(seed)
    vocab = srv.engine.model_config.vocab_size
    tails = [[rng.integers(1, vocab, int(rng.integers(TIER_TAIL[0], TIER_TAIL[1] + 1)),
                           dtype=np.int32) for _ in range(TIER_SESSIONS)]
             for _ in range(TIER_TURNS)]
    hist, out, done = {}, {}, []
    for turn in range(TIER_TURNS):
        rids = {}
        for s, tail in enumerate(tails[turn]):
            sid = f"chat-{s}"
            prompt = tail if turn == 0 else np.concatenate([hist[sid], tail]).astype(np.int32)
            rids[sid] = srv.submit(prompt, max_new_tokens=TIER_NEW, session_id=sid)
        res = srv.drain()
        for sid, rid in rids.items():
            hist[sid] = res[rid].tokens()
            out[(turn, sid)] = hist[sid].tolist()
            done.append(res[rid])
        while srv._tiers is not None and srv._tiers.inflight():
            time.sleep(0.005)
    return out, done


def link_ms_per_page(torch, pool, n_pages=8, iters=10):
    """The device ms a page of one gather (``index_select`` of both caches
    then a ``non_blocking`` copy into host memory pinned beforehand) and
    of one scatter (the copy back, then ``index_copy_``) over ``n_pages``
    pages, CUDA events around ``iters`` of each: the host link's share of
    a tier move, without the tier's own page-locking of new memory."""
    ids = torch.arange(1, n_pages + 1, dtype=torch.int64, device=pool.k.device)
    bufs = (pool.k, pool.v)
    host = [torch.empty((b.shape[0], n_pages) + tuple(b.shape[2:]), dtype=b.dtype,
                        pin_memory=True) for b in bufs]

    def gather():
        for h, b in zip(host, bufs):
            h.copy_(b.index_select(1, ids), non_blocking=True)

    def scatter():
        for h, b in zip(host, bufs):
            b.index_copy_(1, ids, h.to(b.device, non_blocking=True))

    out = {}
    for name, fn in (("gather", gather), ("scatter", scatter)):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / iters / n_pages
    return out


def phase_serve_tiers_bf16(torch):
    """GPT-2 124M (weights drawn on the card, seed 0) in bf16 on the paged
    pool, 16 sessions x 3 turns, first with tiers off (every session stays
    warm: the reference), then with tiers on (device → pinned host → disk
    in a temp dir): every turn's tokens bit for bit the reference's;
    demotions, promotions, T1 and T2 hits; the prefill and the decode calls
    one signature each (the page tables rewritten in place); B5 launched
    and B4 not (counters zeroed just before the tiered run and read just
    after: ``serving_tiers``).  Prints the T0→T1 gather's and T1→T0
    scatter's ms a page (CUDA events around each move) beside the bound
    (page bytes over the host link) and beside the same copies into
    memory pinned beforehand, ``swap_hidden_ratio`` and decode tokens/s
    beside the reference's."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.serving import engine as engine_mod

    eng = deepspeed_tpu_torch.init_inference(model="gpt2", dtype=torch.bfloat16,
                                             init_on_device=True, seed=0, max_out_tokens=1024)
    ref = ServingEngine(eng, TIER_SERVING)
    t0 = time.perf_counter()
    want, _ = tier_turns(ref)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    ref_st = ref.stats()
    kv = ref_st["kvcache"]
    check(kv["session_rebinds"] == TIER_SESSIONS * (TIER_TURNS - 1) and kv["session_drops"] == 0
          and kv["session_spills"] == 0,
          f"serve_tiers_bf16: the reference's sessions did not all stay warm: {kv}")
    del ref
    torch.cuda.empty_cache()

    sigs = {"prefill": set(), "decode": set()}
    real = engine_mod.forward_with_cache

    def spy(params, toks, k, v, pos, icfg, **kw):
        table = kw.get("page_table")
        kind = "decode" if "write_mask" in kw else "prefill"
        sigs[kind].add((tuple(toks.shape), tuple(pos.shape),
                        None if table is None else tuple(table.shape)))
        return real(params, toks, k, v, pos, icfg, **kw)

    disk = tempfile.mkdtemp()
    engine_mod.forward_with_cache = spy
    try:
        cfg = {**TIER_SERVING, "kvcache": {**TIER_SERVING["kvcache"],
                                           "tiers": {**TIER_KNOBS, "disk_dir": disk}}}
        srv = ServingEngine(eng, cfg)
        # -- the main path: counters zeroed just before, read just after ---
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got, done = tier_turns(srv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        # ------------------------------------------------------------------
        st = srv.stats()
        tiers = st["kvcache"]["tiers"]
        srv._tiers.close()
        link = link_ms_per_page(torch, srv.pool)
    finally:
        engine_mod.forward_with_cache = real
        shutil.rmtree(disk, ignore_errors=True)
    differ = [k for k in want if got.get(k) != want[k]]
    check(not differ, f"serve_tiers_bf16: turns {differ[:8]} differ from the all-device run")
    check(tiers["demote_t0_t1"] > 0 and tiers["demote_t1_t2"] > 0
          and tiers["promote_t1_t0"] + tiers["promote_t2_t0"] > 0
          and tiers["hits_t1"] >= 1 and tiers["hits_t2"] >= 1,
          f"serve_tiers_bf16: the tier cascade did not run: {tiers}")
    check(len(sigs["prefill"]) == 1 and len(sigs["decode"]) == 1,
          f"serve_tiers_bf16: call signatures {sigs}")
    # a prefill chunk at an offset attends the pages through the plain
    # gather + attention, as the JAX package's paged_cache_attention does
    # for more than one query: B1 runs in generate()'s prefill, not here
    check(launches["flash_decode_paged"] > 0 and launches["flash_decode"] == 0,
          f"serve_tiers_bf16: launches {launches}")
    cfg_m = eng.model_config
    for r in done:
        check(r.finish_reason == "length" and all(0 <= t < cfg_m.vocab_size for t in r.generated),
              f"serve_tiers_bf16 request {r.request_id}: {r.finish_reason}")
    page_len = TIER_SERVING["kvcache"]["page_len"]
    page_bytes = 2 * cfg_m.n_layer * cfg_m.n_head * page_len * cfg_m.head_dim * 2  # K, V: bf16
    bound = page_bytes / HOST_LINK_BYTES * 1e3
    n_new = TIER_SESSIONS * TIER_TURNS * (TIER_NEW - 1)  # decode-step tokens
    emit({"phase": "serve_tiers_bf16", "sessions": TIER_SESSIONS, "turns": TIER_TURNS,
          "turns_equal": len(want) - len(differ), "tiers": tiers,
          "page_bytes": page_bytes,
          "gather_ms_per_page": tiers["gather_ms_per_page"],
          "scatter_ms_per_page": tiers["scatter_ms_per_page"],
          "move_bound_ms_per_page": bound, "host_link_bytes_per_s": HOST_LINK_BYTES,
          "prepinned_gather_ms_per_page": link["gather"],
          "prepinned_scatter_ms_per_page": link["scatter"],
          "swap_hidden_ratio": tiers["swap_hidden_ratio"],
          "decode_tokens_per_s": n_new / st["phase_seconds"]["decode"],
          "ref_decode_tokens_per_s": n_new / ref_st["phase_seconds"]["decode"],
          "wall_s": wall, "ref_wall_s": ref_wall, "phase_seconds": st["phase_seconds"],
          "ref_phase_seconds": ref_st["phase_seconds"],
          "signatures": {k: [list(map(str, s)) for s in v] for k, v in sigs.items()},
          "launches": {k: v for k, v in launches.items() if v}})
    del srv, eng
    torch.cuda.empty_cache()
    return launches


def phase_serve_resilience_bf16(torch):
    """``deepspeed_tpu_torch/tools/serving_chaos.py`` on the card: GPT-2
    124M in bf16 (weights drawn on the card, seed 0) in child processes.
    (a) A real ``kill -9`` at the victim's 3rd decode (slot pool, journal,
    7 greedy requests and 1 seeded-sampling one); a fresh child's
    ``recover()`` replays exactly the journal's incomplete set, bit for bit
    the uninterrupted child's tokens.  (b) SIGTERM mid-drain on the tiered
    paged engine: exit 43 after the journal commits, every warm session
    flushed to disk; a fresh child's ``recover()`` and next turn of every
    session rebind from disk (``hits_t2`` >= 1), bit for bit the
    uninterrupted child's.  (c) Two tenants, one under a page quota below
    its requests' need: it defers, the other does not, the tokens equal
    the engine's without tenants, and the bill equals
    ``journal_tenant_totals``.  A failed child fails the phase.  Returns
    the children's launches (``serving_resilience``)."""
    from deepspeed_tpu_torch.tools import serving_chaos

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = serving_chaos.run("cuda")
    check(out["ok"], "serve_resilience_bf16: " + "\n".join(out["failures"]))
    for name in ("flash_decode", "flash_decode_paged"):  # the slot and the paged pools
        check(out["launches"].get(name, 0) > 0,
              f"serve_resilience_bf16: {name} not launched in the children: {out['launches']}")
    emit({"phase": "serve_resilience_bf16", **out})
    return out["launches"]


def phase_serve_fleet_bf16(torch):
    """``deepspeed_tpu_torch/tools/fleet_chaos.py`` on the card: GPT-2 124M
    in bf16 (weights drawn on the card, seed 0) in replica child processes
    behind one ``FleetRouter`` over ``ProcessTransport``.  (a) Three
    slot-pool replicas (4 slots x 1024 positions, chunks of 64), 18
    requests (seeded Poisson router steps between submits, prompts of
    64-256 tokens, 32-64 new, 2 seeded-sampling), the first replica killed
    by ``DS_FAULT_PLAN`` at a decode: rc -9, zero acknowledged loss, the
    restart replays exactly the journal's incomplete set, and every output
    equals solo ``generate()`` or first differs on a near-tie.  (b) One
    paged replica (pages of 128, 96 pages) under the autoscaler: a burst
    of 16 scales up off the warm pool, 6 sessions x 3 turns park on the
    elastic replicas, a victim dies inside ``migrate.export`` (rc -9,
    journal replay), clean scale-downs migrate the rest to the first
    replica, whose final turns rebind the migrated KV.  A failed or hung
    child fails the phase.  Returns the children's launches
    (``serving_fleet``)."""
    from deepspeed_tpu_torch.tools import fleet_chaos

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = fleet_chaos.run("cuda")
    check(out["ok"], "serve_fleet_bf16: " + "\n".join(out["failures"]))
    check(out["failover"]["launches"].get("flash_decode", 0) > 0,
          f"serve_fleet_bf16: flash_decode not launched in the replicas: {out['launches']}")
    check(out["elastic"]["launches"].get("flash_decode_paged", 0) > 0,
          f"serve_fleet_bf16: flash_decode_paged not launched in the replicas: "
          f"{out['launches']}")
    emit({"phase": "serve_fleet_bf16", **out})
    return out["launches"]


def phase_serve_frontdoor_bf16(torch):
    """``deepspeed_tpu_torch/tools/frontdoor_chaos.py`` on the card: one
    ``FrontDoor`` server child (GPT-2 124M bf16, journal, two tenants):
    the starved tenant's 429 with ``Retry-After``; ``kill -9`` mid-stream
    (rc -9); a fresh server over the journal answers the same
    ``client_key`` with the original id and a stream that extends the
    prefix and equals solo ``generate()`` (near-tie rule); TTFT through
    HTTP beside in-process; SIGTERM after a stream's first chunk: the
    stream completes, a probe answers 503 with ``Retry-After``, exit 43;
    the journal's per-tenant bill equals what the client read.  Returns
    the recovered server's launches (``serving_frontdoor``)."""
    from deepspeed_tpu_torch.tools import frontdoor_chaos

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = frontdoor_chaos.run("cuda")
    check(out["ok"], "serve_frontdoor_bf16: " + "\n".join(out["failures"]))
    check(out["launches"].get("flash_decode", 0) > 0,
          f"serve_frontdoor_bf16: flash_decode not launched in the server: {out['launches']}")
    emit({"phase": "serve_frontdoor_bf16", **out})
    return out["launches"]


# ---------------------------------------------------------------------------
# models from outside the repo: injection, int8 weights at rest, Megatron
# ---------------------------------------------------------------------------

# GPT-Neo 2.7B at its published widths (EleutherAI/gpt-neo-2.7B: hidden
# 2560, 32 layers, 20 heads of 128, vocab 50257, 2048 positions, MLP 4 x
# hidden): the port's "gpt-neo-2.7b" preset.  Its requests: 8 prompts of
# 64..256 tokens, 48 greedy tokens each, on 8 slots (batch 8 decode)
NEO_PROMPTS, NEO_NEW = (64, 256), 48
NEO_SLOT = {"num_slots": 8, "prefill_chunk": 64, "max_len": 1024}
NEO_PAGED = {**NEO_SLOT, "kvcache": {"enabled": True, "page_len": 128}}
# bf16 serving against bf16 solo generate(): a differing greedy token is
# accepted where the step's own argmax flips once this much logit moves
# between the two tokens (tools/fleet_chaos.py first_difference).  The
# served decode runs batch 8 and the solo one batch 1, GEMMs of other
# shapes that round 24-32 bf16 layers another way, so the two logits
# differ by a few of bf16's spacings at the logits' magnitude (2 of them,
# 0.0625, at GPT-Neo 2.7B's +-5.5 on the first card run): the tolerance is
# 8 spacings at the largest |logit| of the model's prefill check
NEAR_TIE_SPACINGS = 8


def near_tie_tol(logits) -> float:
    """:data:`NEAR_TIE_SPACINGS` bf16 spacings (2**-7 relative) at the
    largest |logit| of ``logits``."""
    top = float(logits.float().abs().max())
    return float(NEAR_TIE_SPACINGS * 2.0 ** (np.floor(np.log2(top)) - 7))
# the int8 engine's prefill logits against a bf16 engine over the
# dequantized weights q * s: the two round each weight's scale or product
# to bf16 (2**-9 relative) at other points and carry that through 32
# layers, so they differ by a few of bf16's spacings at the logits'
# magnitude (GPT-Neo 2.7B's random-init logits span +-5.5, where the
# spacing is 2**-5: the first card run read 0.111, 3.6 spacings); the
# bound is near_tie_tol's 8 spacings at the largest |logit|
# Megatron-LM's GPT-2 345M (24 layers, hidden 1024, 16 heads, 1024
# positions; its vocabulary padded to a multiple of 128 x 2 ranks, 50304)
MEGATRON_345M = {"vocab_size": 50304, "n_positions": 1024, "n_embd": 1024, "n_layer": 24,
                 "n_head": 16}


class HFLayout:
    """An HF-layout stand-in for a ``transformers`` model (the card has no
    ``transformers``): ``state_dict()`` under the model's key names and a
    ``.config`` naming its architecture."""

    def __init__(self, sd, config):
        self._sd, self.config = sd, config

    def state_dict(self):
        return self._sd


def gpt_neo_standin(tree, cfg):
    """GPT-Neo's layout of the port's tree ``tree`` (its ``transformer.h.N``
    keys, (out, in) Linears, separate q/k/v without biases, the queries
    without the sqrt(head_dim) the policy folds back in); a view of
    ``tree``'s tensors but for the queries."""
    from types import SimpleNamespace

    d, b, scale = cfg.n_embd, tree["blocks"], float(np.sqrt(cfg.head_dim))
    sd = {"transformer.wte.weight": tree["wte"], "transformer.wpe.weight": tree["wpe"],
          "transformer.ln_f.weight": tree["lnf_g"], "transformer.ln_f.bias": tree["lnf_b"],
          "lm_head.weight": tree["wte"]}
    for i in range(cfg.n_layer):
        p, a = f"transformer.h.{i}.", f"transformer.h.{i}.attn.attention."
        qkv = b["qkv_w"][i]
        sd.update({
            p + "ln_1.weight": b["ln1_g"][i], p + "ln_1.bias": b["ln1_b"][i],
            a + "q_proj.weight": (qkv[:, :d].float() / scale).to(qkv.dtype).t(),
            a + "k_proj.weight": qkv[:, d:2 * d].t(), a + "v_proj.weight": qkv[:, 2 * d:].t(),
            a + "out_proj.weight": b["proj_w"][i].t(), a + "out_proj.bias": b["proj_b"][i],
            p + "ln_2.weight": b["ln2_g"][i], p + "ln_2.bias": b["ln2_b"][i],
            p + "mlp.c_fc.weight": b["fc_w"][i].t(), p + "mlp.c_fc.bias": b["fc_b"][i],
            p + "mlp.c_proj.weight": b["fc_proj_w"][i].t(),
            p + "mlp.c_proj.bias": b["fc_proj_b"][i]})
    config = SimpleNamespace(
        architectures=["GPTNeoForCausalLM"], num_layers=cfg.n_layer, hidden_size=d,
        num_heads=cfg.n_head, vocab_size=cfg.vocab_size,
        max_position_embeddings=cfg.n_positions, layer_norm_epsilon=cfg.layer_norm_epsilon,
        attention_types=[[["global", "local"], cfg.n_layer // 2]], window_size=256)
    return HFLayout(sd, config)


def neo_requests(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 50257, int(n), dtype=np.int32), NEO_NEW)
            for n in rng.integers(NEO_PROMPTS[0], NEO_PROMPTS[1] + 1, 8)]


def near_tie_check(eng, done, reqs, solo, tie, label):
    """Each served request in ``done`` ran to its length and its tokens
    equal ``solo`` ones (solo ``generate()``) or first differ on a
    near-tie within ``tie``; returns the differing ones."""
    from deepspeed_tpu_torch.tools.fleet_chaos import first_difference

    flips = []
    for i, (r, (p, n), want) in enumerate(zip(done, reqs, solo)):
        check(r.finish_reason == "length" and len(r.generated) == n,
              f"{label} request {i}: {r.finish_reason}, {len(r.generated)} of {n} tokens")
        diff = first_difference(eng, len(p), r.tokens(), want, tie)
        if diff is not None:
            check(diff["ok"], f"{label} request {i}: differs from solo generate() at token "
                              f"{diff['at']}, gap {diff['gap']} above {tie}")
            flips.append({"request": i, **diff})
    return flips


def _serve_rates(srv, done, wall):
    n_tok = int(sum(len(r.generated) for r in done))
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    st = srv.stats()
    return {"requests": len(done), "tokens": n_tok, "wall_s": wall,
            "decode_tokens_per_s": (n_tok - len(done)) / st["phase_seconds"]["decode"],
            "ttft_ms_p50": _percentile(ttft, 50), "decode_steps": st["decode_steps"],
            "prefill_chunks": st["prefill_chunks"]}


def _decode_window(torch, eng, steps=8, B=8, T=128):
    """``steps`` greedy decode steps at batch ``B`` after a ``T``-token
    prefill, under ``torch.profiler``: host wall ms a step (each ends in
    its tokens' copy to the host) and device-busy ms a step."""
    from deepspeed_tpu_torch.tools.profile_serving import profile_summary

    ids = np.random.default_rng(3).integers(1, eng.model_config.vocab_size, (B, T))
    k, v = eng.init_cache(B, T + steps + 1)
    logits, k, v = eng.prefill(ids, k, v)
    tok = logits[:, -1].argmax(-1)[:, None].cpu().numpy()
    logits, k, v = eng.decode_step(tok, k, v, np.full(B, T))  # warm
    tok = logits[:, -1].argmax(-1)[:, None].cpu().numpy()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, k, v = eng.decode_step(tok, k, v, np.full(B, T + 1 + i))
            tok = logits[:, -1].argmax(-1)[:, None].cpu().numpy()
        wall = time.perf_counter() - t0
    out = profile_summary(prof)
    busy = out["device_busy_ms"]
    return {"wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": None if busy is None else busy / steps,
            "device_idle_share": out["device_idle_share"],
            "top_kernels_ms": out["top_kernels_ms"][:6]}


def _main_path_launches(label, launches, variants, decode):
    check(launches.get("flash_fwd", 0) > 0 and only_tc(variants.get("flash_fwd", {})),
          f"{label}: generate()'s prefill ran {variants.get('flash_fwd')}")
    check(any(launches.get(n, 0) > 0 for n in decode),
          f"{label}: none of {decode} launched: {launches}")


def phase_serve_injected_bf16(torch):
    """GPT-Neo 2.7B at its published widths injected from an HF layout:
    weights drawn on the card (seed 0) in the port's layout, handed over
    as a ``GPTNeoForCausalLM`` stand-in (:func:`gpt_neo_standin`), and
    ``init_inference(model=<stand-in>)`` through ``HFGPTNEOLayerPolicy``.
    Gates: the injected tree equals the preset engine's (``params=``: the
    drawn tree, its queries as the policy folds them) leaf for leaf, bit
    for bit; their prefill logits (4 x 256) within BF16_LOGIT_TOL; 8
    requests served on the paged pool (counters zeroed just before, with
    a ``generate()`` of 4 x 256 prompts, and read just after: B1 and B5
    launched, ``serving_injected``) each equal solo ``generate()`` or
    first different on a near-tie.  Returns the launches, the drawn tree
    and the stand-in (for ``serve_int8_bf16``)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.runtime.engine import tree_from_paths, tree_items

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = gpt2.PRESETS["gpt-neo-2.7b"]
    tree = gpt2.init_params_device(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    standin = gpt_neo_standin(tree, cfg)
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(model=standin, dtype=torch.bfloat16,
                                             max_out_tokens=cfg.n_positions)
    torch.cuda.synchronize()
    inject_s = time.perf_counter() - t0
    check(eng.model_config == dataclasses.replace(cfg, remat=False),
          f"serve_injected_bf16: injected config {eng.model_config}")
    # the preset engine on the same weights: the drawn tree, its queries
    # as the policy folds them back (the stand-in's divided by sqrt(hd))
    d, scale = cfg.n_embd, float(np.sqrt(cfg.head_dim))
    qkv = torch.cat([torch.stack([standin.state_dict()[
        f"transformer.h.{i}.attn.attention.q_proj.weight"].t() * scale
        for i in range(cfg.n_layer)]), tree["blocks"]["qkv_w"][:, :, d:]], dim=2)
    ref_tree = tree_from_paths({p: (qkv if p == "blocks/qkv_w" else t)
                                for p, t in tree_items(tree)})
    preset = deepspeed_tpu_torch.init_inference(model="gpt-neo-2.7b", params=ref_tree,
                                                dtype=torch.bfloat16)
    got, want = dict(tree_items(eng.params)), dict(tree_items(preset.params))
    differ = sorted(p for p in want if not torch.equal(got[p], want[p]))
    check(set(got) == set(want) and not differ,
          f"serve_injected_bf16: injected leaves {differ} differ from the preset engine's")
    q_fold_err = float(((qkv[:, :, :d].float() - tree["blocks"]["qkv_w"][:, :, :d].float()).abs()
                        / tree["blocks"]["qkv_w"][:, :, :d].float().abs().clamp_min(1e-6)).max())
    ids = generate_ids()
    with torch.inference_mode():
        lg = [e.prefill(ids, *e.init_cache(4, 256))[0] for e in (eng, preset)]
    err = max_err(lg[0], lg[1])
    check(bool(torch.isfinite(lg[0]).all()) and err <= BF16_LOGIT_TOL,
          f"serve_injected_bf16: prefill logits differ from the preset engine's by {err}")
    logit_range = [float(lg[0].min()), float(lg[0].max())]
    tie = near_tie_tol(lg[0])
    del preset, ref_tree, qkv, lg

    from deepspeed_tpu_torch.serving import ServingEngine

    srv = ServingEngine(eng, config=NEO_PAGED)
    reqs = neo_requests()
    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ids_sub = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    res = srv.drain()
    gen = eng.generate(ids, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = kernels.launches(), kernels.launch_variants()
    # ----------------------------------------------------------------------
    _main_path_launches("serve_injected_bf16", launches, variants, ("flash_decode_paged",))
    check(gen.shape == (4, 256 + GEN_NEW), f"serve_injected_bf16: generate() gave {gen.shape}")
    solo = [eng.generate(p[None], max_new_tokens=n)[0] for p, n in reqs]
    flips = near_tie_check(eng, [res[r] for r in ids_sub], reqs, solo, tie,
                           "serve_injected_bf16")
    kv = srv.stats()["kvcache"]
    emit({"phase": "serve_injected_bf16", "model": "gpt-neo-2.7b", "source": "GPTNeoForCausalLM "
          "layout (drawn on the card, seed 0)", "params": cfg.num_params(),
          "inject_s": inject_s, "weight_bytes": eng.weight_bytes(),
          "leaves_equal_preset": len(want), "query_fold_max_rel": q_fold_err,
          "prefill_logits_max_abs_err": err, "tol": BF16_LOGIT_TOL, "logit_range": logit_range,
          "served": len(reqs), "equal_to_solo_generate": len(reqs) - len(flips),
          "near_tie_flips": flips, "near_tie_tol": tie, "wall_s": wall,
          "prefix_hits": kv["prefix_hits"], "launches": {n: c for n, c in launches.items() if c}})
    del srv
    return launches, eng, standin, solo


def _dequantized(torch, eng):
    """A packed engine's tree with every ``{"q", "s"}`` pair as ``q * s``
    in bf16."""
    def deq(v):
        if isinstance(v, dict):
            return (v["q"].float() * v["s"].unsqueeze(-2)).to(torch.bfloat16)
        return v
    return {k: ({n: deq(x) for n, x in v.items()} if k == "blocks" else v)
            for k, v in eng.params.items()}


def phase_serve_int8_bf16(torch, bf16_eng, standin, solo_bf16):
    """``serve_injected_bf16``'s GPT-Neo 2.7B with ``quantize_bits=8``: the
    stand-in injected and every matmul weight packed whole on the card
    (int8 codes, f32 per-channel scales).  Gates: codes and scales as a
    packing of the same weights on the host (layers 0 and 31 of ``qkv_w``,
    ``proj_w``, ``fc_w``, ``fc_proj_w``); the prefill logits (4 x 256)
    within :func:`near_tie_tol` of a bf16 engine over the dequantized
    weights ``q * s``; 8 requests on the slot pool and on the paged pool (counters
    zeroed just before, with a ``generate()`` of 4 x 256, read just after:
    B1, B4 and B5 launched, ``serving_int8``) each equal solo int8
    ``generate()`` or first different on a near-tie.  Reports the weight
    bytes on the card against bf16's, decode tokens/s and TTFT p50 of the
    same 8 requests at batch 8 on the slot pool, bf16 then int8 (one pair),
    and a profiled window of 8 decode steps at
    batch 8 each (host ms and device-busy ms a step).  Returns the
    launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.runtime.weight_quantizer import pack_one
    from deepspeed_tpu_torch.serving import ServingEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(model=standin, dtype=torch.bfloat16,
                                             quantize_bits=8, max_out_tokens=2048)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    blocks = eng.params["blocks"]
    kinds = {n: (str(v["q"].dtype), str(v["s"].dtype), v["q"].device.type)
             for n, v in blocks.items() if isinstance(v, dict)}
    check(sorted(kinds) == ["fc_proj_w", "fc_w", "proj_w", "qkv_w"]
          and all(k == ("torch.int8", "torch.float32", "cuda") for k in kinds.values()),
          f"serve_int8_bf16: packed leaves {kinds}")
    host_check = {}
    for name in ("qkv_w", "proj_w", "fc_w", "fc_proj_w"):
        for layer in (0, bf16_eng.model_config.n_layer - 1):
            w = bf16_eng.params["blocks"][name][layer]
            host = pack_one(w.cpu())
            same = torch.equal(host["q"], blocks[name]["q"][layer].cpu())
            s_err = float(((host["s"] - blocks[name]["s"][layer].cpu()).abs()
                           / host["s"].abs()).max())
            check(same and s_err <= 1e-6, f"serve_int8_bf16: {name}[{layer}] packed on the card "
                  f"differs from the host's (codes equal {same}, scales {s_err})")
            host_check[f"{name}[{layer}]"] = s_err
    int8_bytes, bf16_bytes = eng.weight_bytes(), bf16_eng.weight_bytes()
    ids = generate_ids()
    deq = deepspeed_tpu_torch.init_inference(model="gpt-neo-2.7b", params=_dequantized(torch, eng),
                                             dtype=torch.bfloat16)
    with torch.inference_mode():
        lg = [e.prefill(ids, *e.init_cache(4, 256))[0] for e in (eng, deq)]
    err = max_err(lg[0], lg[1])
    tie = near_tie_tol(lg[1])
    check(bool(torch.isfinite(lg[0]).all()) and err <= tie,
          f"serve_int8_bf16: prefill logits differ from the dequantized bf16 engine's by {err} "
          f"(bound {tie})")
    del deq, lg
    torch.cuda.empty_cache()

    reqs = neo_requests()
    slot, paged = ServingEngine(eng, config=NEO_SLOT), ServingEngine(eng, config=NEO_PAGED)
    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sub = [(slot, [slot.submit(p, max_new_tokens=n) for p, n in reqs]),
           (paged, [paged.submit(p, max_new_tokens=n) for p, n in reqs])]
    res = [srv.drain() for srv, _ in sub]
    gen = eng.generate(ids, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = kernels.launches(), kernels.launch_variants()
    # ----------------------------------------------------------------------
    _main_path_launches("serve_int8_bf16", launches, variants, ("flash_decode",))
    check(launches.get("flash_decode_paged", 0) > 0,
          f"serve_int8_bf16: the paged pool's decode did not launch B5: {launches}")
    check(gen.shape == (4, 256 + GEN_NEW), f"serve_int8_bf16: generate() gave {gen.shape}")
    solo = [eng.generate(p[None], max_new_tokens=n)[0] for p, n in reqs]
    flips = {label: near_tie_check(eng, [done[r] for r in rids], reqs, solo, tie,
                                   f"serve_int8_bf16 {label}")
             for label, (srv, rids), done in zip(("slot", "paged"), sub, res)}
    same_as_bf16 = sum(int(np.array_equal(a, b)) for a, b in zip(solo, solo_bf16))
    del slot, paged

    # decode tokens/s and TTFT at batch 8, bf16 then int8 (one pair), then a
    # profiled decode window each
    rates = {"bf16": [], "int8": []}
    turns = [("bf16", bf16_eng), ("int8", eng)]
    for label, e in turns:
        srv = ServingEngine(e, config=NEO_SLOT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        done = srv.drain()
        torch.cuda.synchronize()
        rates[label].append(_serve_rates(srv, [done[r] for r in rids], time.perf_counter() - t0))
    mean = {k: float(np.median([r["decode_tokens_per_s"] for r in v])) for k, v in rates.items()}
    ttft = {k: float(np.median([r["ttft_ms_p50"] for r in v])) for k, v in rates.items()}
    window = {label: _decode_window(torch, e) for label, e in turns}
    emit({"phase": "serve_int8_bf16", "model": "gpt-neo-2.7b", "pack_s": pack_s,
          "weight_bytes": {"int8": int8_bytes, "bf16": bf16_bytes,
                           "ratio": int8_bytes / bf16_bytes},
          "packed_on_card_vs_host_scale_rel": host_check,
          "prefill_logits_vs_dequantized_max_abs_err": err, "tol": tie,
          "served": len(reqs), "near_tie_flips": flips, "near_tie_tol": tie,
          "solo_tokens_equal_to_bf16": same_as_bf16, "main_path_wall_s": wall,
          "rates": rates, "decode_tokens_per_s": mean,
          "decode_int8_over_bf16": mean["int8"] / mean["bf16"], "ttft_ms_p50": ttft,
          "ttft_int8_over_bf16": ttft["int8"] / ttft["bf16"], "decode_window": window,
          "launches": {n: c for n, c in launches.items() if c}})
    return launches


def megatron_state_dict(torch, tree, cfg):
    """Megatron-LM's GPT layout of the port's tree (CPU tensors): (out, in)
    Linears under ``language_model.transformer.layers.N``, the fused
    ``query_key_value`` interleaved by head, (heads, 3, head_dim)."""
    H, hd, d = cfg.n_head, cfg.head_dim, cfg.n_embd
    b = tree["blocks"]
    sd = {"language_model.embedding.word_embeddings.weight": tree["wte"],
          "language_model.embedding.position_embeddings.weight": tree["wpe"],
          "language_model.transformer.final_layernorm.weight": tree["lnf_g"],
          "language_model.transformer.final_layernorm.bias": tree["lnf_b"]}
    for i in range(cfg.n_layer):
        L = f"language_model.transformer.layers.{i}."
        qkv_w = b["qkv_w"][i].t().reshape(3, H, hd, d).transpose(0, 1).reshape(3 * d, d)
        qkv_b = b["qkv_b"][i].reshape(3, H, hd).transpose(0, 1).reshape(3 * d)
        sd.update({
            L + "input_layernorm.weight": b["ln1_g"][i], L + "input_layernorm.bias": b["ln1_b"][i],
            L + "attention.query_key_value.weight": qkv_w.contiguous(),
            L + "attention.query_key_value.bias": qkv_b.contiguous(),
            L + "attention.dense.weight": b["proj_w"][i].t().contiguous(),
            L + "attention.dense.bias": b["proj_b"][i],
            L + "post_attention_layernorm.weight": b["ln2_g"][i],
            L + "post_attention_layernorm.bias": b["ln2_b"][i],
            L + "mlp.dense_h_to_4h.weight": b["fc_w"][i].t().contiguous(),
            L + "mlp.dense_h_to_4h.bias": b["fc_b"][i],
            L + "mlp.dense_4h_to_h.weight": b["fc_proj_w"][i].t().contiguous(),
            L + "mlp.dense_4h_to_h.bias": b["fc_proj_b"][i]})
    return {k: v.clone() for k, v in sd.items()}


def megatron_shards(sd, tp):
    """Megatron's tensor-parallel cut of a whole state dict: column-parallel
    and vocab-parallel weights by rows (each rank its heads' interleaved
    QKV rows), row-parallel by columns, the rest replicated."""
    col = ("query_key_value.weight", "query_key_value.bias", "dense_h_to_4h.weight",
           "dense_h_to_4h.bias", "word_embeddings.weight")
    row = ("attention.dense.weight", "mlp.dense_4h_to_h.weight")
    out = []
    for r in range(tp):
        out.append({k: (v.chunk(tp, dim=0)[r].clone() if k.endswith(col)
                        else v.chunk(tp, dim=1)[r].clone() if k.endswith(row) else v)
                    for k, v in sd.items()})
    return out


def phase_serve_megatron_bf16(torch):
    """Megatron-LM's GPT-2 345M from a checkpoint of two tensor-parallel
    shards: weights drawn on the card (seed 0, biases drawn too so that
    the QKV bias's layout shows), written as Megatron's layout
    (:func:`megatron_state_dict`, the newer interleaved QKV) in
    ``mp_rank_00_model_states.pt`` / ``mp_rank_01_model_states.pt`` under
    a tag a ``latest`` file names, in a temporary directory; then
    ``find_megatron_checkpoints`` → ``SDLoaderFactory.get_sd_loader(...,
    version=3.0).load()`` → ``init_serving(model=merged)``.  Gates: the
    merged dict equals the unsplit one bit for bit; the served engine's
    prefill logits (4 x 256) equal, bit for bit, an engine over the
    unsplit weights; 8 requests on the slot pool (counters zeroed just
    before, with a ``generate()`` of 4 x 256, read just after: B1 and B4
    launched, ``serving_megatron``) each equal solo ``generate()`` or
    first differ on a near-tie.  Returns the launches."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.checkpoint import SDLoaderFactory, find_megatron_checkpoints
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = gpt2.GPT2Config(**MEGATRON_345M)
    tree = gpt2.init_params_device(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for name in ("qkv_b", "proj_b", "fc_b", "fc_proj_b"):
        tree["blocks"][name].normal_(0.0, 0.02, generator=g)
    host = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in tree.items()}
    del tree
    full = megatron_state_dict(torch, host, cfg)
    root = tempfile.mkdtemp()
    try:
        tag = "iter_0001000"
        os.makedirs(os.path.join(root, tag))
        with open(os.path.join(root, "latest"), "w") as f:
            f.write(tag)
        t0 = time.perf_counter()
        for r, shard in enumerate(megatron_shards(full, 2)):
            torch.save({"model": shard, "checkpoint_version": 3.0, "iteration": 1000},
                       os.path.join(root, tag, f"mp_rank_{r:02d}_model_states.pt"))
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(root, tag, n))
                         for n in os.listdir(os.path.join(root, tag)))
        t0 = time.perf_counter()
        paths = find_megatron_checkpoints(root)
        merged = SDLoaderFactory.get_sd_loader(paths, version=3.0).load()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check([os.path.basename(p) for p in paths] == ["mp_rank_00_model_states.pt",
                                                   "mp_rank_01_model_states.pt"],
          f"serve_megatron_bf16: found {paths}")
    differ = sorted(k for k in full if not torch.equal(merged[k], full[k]))
    check(set(merged) == set(full) and not differ,
          f"serve_megatron_bf16: merged keys {differ[:6]} differ from the unsplit dict")
    t0 = time.perf_counter()
    srv = deepspeed_tpu_torch.init_serving(model=merged, dtype=torch.bfloat16,
                                           serving={"num_slots": 8, "prefill_chunk": 64})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = srv.engine
    whole = deepspeed_tpu_torch.init_inference(model=full, dtype=torch.bfloat16)
    ids = generate_ids()
    with torch.inference_mode():
        lg = [e.prefill(ids, *e.init_cache(4, 256))[0] for e in (eng, whole)]
    check(torch.equal(lg[0], lg[1]) and bool(torch.isfinite(lg[0]).all()),
          f"serve_megatron_bf16: logits differ from the unsplit weights' by "
          f"{max_err(lg[0], lg[1])} (bit for bit expected)")
    tie = near_tie_tol(lg[0])
    del whole, lg, merged, full, host
    reqs = [(p % cfg.vocab_size, n) for p, n in neo_requests(seed=1)]
    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    res = srv.drain()
    gen = eng.generate(ids, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = kernels.launches(), kernels.launch_variants()
    # ----------------------------------------------------------------------
    _main_path_launches("serve_megatron_bf16", launches, variants, ("flash_decode",))
    check(gen.shape == (4, 256 + GEN_NEW), f"serve_megatron_bf16: generate() gave {gen.shape}")
    solo = [eng.generate(p[None], max_new_tokens=n)[0] for p, n in reqs]
    flips = near_tie_check(eng, [res[r] for r in rids], reqs, solo, tie, "serve_megatron_bf16")
    emit({"phase": "serve_megatron_bf16", "model": "megatron-gpt2-345m", "config": MEGATRON_345M,
          "tp_shards": 2, "checkpoint_bytes": ckpt_bytes, "write_s": write_s,
          "load_merge_s": load_s,
          "inject_place_s": build_s, "logits_bit_equal_unsplit": True, "served": len(reqs),
          "equal_to_solo_generate": len(reqs) - len(flips), "near_tie_flips": flips,
          "near_tie_tol": tie, "wall_s": wall,
          "launches": {n: c for n, c in launches.items() if c}})
    return launches


# ---------------------------------------------------------------------------
# phase 2 (training kernels): flash forward lse, flash backward, fused Adam
# ---------------------------------------------------------------------------

def _fwd_float64_fields(out, ref, exact, label):
    """A bf16 forward's ``out`` (the kernel) and ``ref`` (its plain version)
    against the float64 function of the same inputs ``exact`` (``(out,
    lse)``, float64): the kernel within the bf16 tolerance (the output and
    p rounded to bf16), the plain version read beside it."""
    got = {who: float((x.double() - exact[0]).abs().max()) for who, x in (("kernel", out),
                                                                        ("plain", ref))}
    check(got["kernel"] <= TOL["bfloat16"],
          f"{label}: {got['kernel']} from the float64 function > {TOL['bfloat16']}")
    return {"kernel_vs_float64_max_err": got["kernel"], "plain_vs_float64_max_err": got["plain"]}


def check_flash_fwd_training(torch, dev, flush):
    """B1 at the training shape with its lse (the residual the backward
    consumes); the bf16 kernel and its plain version are also read against
    the float64 function of the same inputs (``flash_fwd_float64``), the
    kernel held to the bf16 tolerance there too."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 12, 1024, 64
    g = torch.Generator(device=dev).manual_seed(1024)
    q, k, v = (torch.randn(B, H, T, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, True, scale)
    torch.cuda.synchronize()
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    check(err <= TOL["bfloat16"], f"flash_fwd training shape: max_err {err}")
    check(lse_err <= 1e-4, f"flash_fwd training shape: lse max_err {lse_err} > 1e-4")
    f64 = _fwd_float64_fields(out, ref, fa.flash_fwd_float64(q, k, v, True, scale),
                              "flash_fwd training shape")
    b_ms, b_by = bound_ms(4 * B * H * T * d * 2 + B * H * T * 4, 4 * B * H * d * T * (T + 1) / 2,
                          "bfloat16")
    row = {
        "phase": "kernel", "kernel": "flash_fwd", "body": "tc", "B": B, "H": H, "T": T, "d": d,
        "dtype": "bfloat16", "causal": True, "lse": True, "max_err": err, "lse_max_err": lse_err,
        "tol": TOL["bfloat16"], "lse_tol": 1e-4, **f64,
        "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True),
                               flush),
        "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, True, scale), flush,
                              iters=5),
        "library_ms": device_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(row)
    return row


def check_flash_bwd(torch, dev, flush):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    rows = []
    for B, T, dtype in ((8, 1024, torch.bfloat16), (8, 1024, torch.float32),
                        (8, 256, torch.bfloat16), (8, 1000, torch.bfloat16)):
        H, d = 12, 64
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device=dev).manual_seed(T + 7)
        q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype) for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale)
        ref = fa.flash_bwd_reference(q, k, v, do, lse, delta, True, scale)
        torch.cuda.synchronize()
        fields = _bwd_fields(fa, got, ref, (q, k, v, do, lse, delta, True, scale),
                             f"flash_bwd B={B} T={T} {name}")
        rms = [float(b.float().square().mean().sqrt()) for b in ref]
        item = dtype.itemsize
        pairs = T * (T + 1) / 2  # causal (query, key) pairs
        nbytes = 7 * B * H * T * d * item + 2 * B * H * T * 4
        flops = 5 * 2 * d * pairs * B * H  # s, dp, dv, dk, dq products
        b_ms, b_by = bound_ms(nbytes, flops, name)
        # the library yardstick: SDPA's backward through autograd, timed only
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        row = {
            "phase": "kernel", "kernel": "flash_bwd", "body": body(name), "B": B, "H": H, "T": T,
            "d": d, "dtype": name, "causal": True, **fields, "rms_dq_dk_dv": rms,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale),
                                   flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, True,
                                                                         scale), flush, iters=5),
            "library_ms": device_ms(torch, lambda: torch.autograd.grad(
                lout, (ql, kl, vl), do, retain_graph=True), flush, iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        del lout
        emit(row)
        rows.append(row)
    return rows


def check_flash_tc_dims(torch, dev, flush):
    """B1 (with lse) and B2 on the tensor-core bodies at the head dims
    they serve beside 64 (``TC_DIMS``; d 64 is the training rows'), bf16,
    causal, at GPT-2's width and training shape: B 8, T 1024, H = 768 / d;
    and at d 64 on a tensor-parallel rank's ``TP_TRAIN_HEADS`` heads (keyed
    ``h6``).
    Out within 2e-2 and lse within 1e-4 of the plain version, the
    gradients (the kernel's and the plain version's) within the float64
    bound (:func:`_bwd_fields`); each launch counted as ``tc``.  Library:
    SDPA (causal) and its backward by autograd."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, T = 8, 1024
    rows = {}
    shapes = [(d, 768 // d, d) for d in TC_DIMS] + [(64, TP_TRAIN_HEADS, f"h{TP_TRAIN_HEADS}")]
    for d, H, key in shapes:
        g = torch.Generator(device=dev).manual_seed(2000 + d if key == d else 3000 + H)
        q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        scale = d ** -0.5
        kernels.reset_launches()
        out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale)
        torch.cuda.synchronize()
        variants = kernels.launch_variants()
        check(variants["flash_fwd"] == {"none/tc": 1} and variants["flash_bwd"] == {"none/tc": 1},
              f"d={d} H={H}: bf16 launches ran {variants['flash_fwd']} / {variants['flash_bwd']}")
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, True, scale)
        err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
        del ref
        check(torch.isfinite(out).all().item(), f"flash_fwd tc d={d} H={H}: non-finite output")
        check(err <= TOL["bfloat16"], f"flash_fwd tc d={d} H={H}: max_err {err}")
        check(lse_err <= 1e-4, f"flash_fwd tc d={d} H={H}: lse max_err {lse_err} > 1e-4")
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, True, scale)
        fields = _bwd_fields(fa, got, refb, (q, k, v, do, lse, delta, True, scale),
                             f"flash_bwd tc d={d} H={H}")
        del refb
        torch.cuda.empty_cache()
        pairs = T * (T + 1) / 2
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * 2 + B * H * T * 4, 4 * B * H * d * pairs,
                                "bfloat16")
        rows[("flash_fwd", key)] = {
            "phase": "kernel", "kernel": "flash_fwd", "body": "tc", "B": B, "H": H, "T": T,
            "d": d, "dtype": "bfloat16", "causal": True, "lse": True, "max_err": err,
            "lse_max_err": lse_err, "tol": TOL["bfloat16"], "lse_tol": 1e-4,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, True, scale, want_lse=True), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, True, scale),
                                  flush, iters=3),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * 2 + 2 * B * H * T * 4,
                                5 * 2 * d * pairs * B * H, "bfloat16")
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, is_causal=True)
        rows[("flash_bwd", key)] = {
            "phase": "kernel", "kernel": "flash_bwd", "body": "tc", "B": B, "H": H, "T": T,
            "d": d, "dtype": "bfloat16", "causal": True, **fields,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, True, scale), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, True, scale), flush, iters=3),
            "library_ms": device_ms(torch, sdpa_bwd, flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del sdpa_bwd, q, k, v, do, out, lse, delta, got
        torch.cuda.empty_cache()
        emit(rows[("flash_fwd", key)])
        emit(rows[("flash_bwd", key)])
    return rows


def check_fused_adam(torch, dev, flush):
    """B3 per leaf (wte, stacked qkv_w, ragged lnf_g) and over one step's
    16 leaves of GPT-2 124M, f32 masters and grads."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.kernels import fused_update as fu

    cfg = gpt2.PRESETS["gpt2"]
    d, L = cfg.n_embd, cfg.n_layer
    step_shapes = [(cfg.vocab_size, d), (cfg.n_positions, d), (d,), (d,),
                   (L, d), (L, d), (L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d),
                   (L, d), (L, d), (L, d, 4 * d), (L, 4 * d), (L, 4 * d, d), (L, d)]
    check(sum(int(np.prod(s)) for s in step_shapes) == cfg.num_params(), "GPT-2 leaf shapes")
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, adam_w_mode=True)
    g = torch.Generator(device=dev).manual_seed(3)

    def leaves(shapes):
        out = []
        for shp in shapes:
            p = torch.randn(shp, generator=g, device=dev) * 0.02
            out.append((p, torch.randn(shp, generator=g, device=dev) * 1e-3,
                        torch.randn(shp, generator=g, device=dev) * 1e-4,
                        torch.rand(shp, generator=g, device=dev) * 1e-7))
        return out

    scal = torch.tensor([6e-4, 1.0, 1.0 - 0.9 ** 3, 1.0 - 0.95 ** 3], device=dev)

    def run_kernel(ls):
        for p, gr, m, v in ls:
            fu.adam_leaf_cuda(p, gr, m, v, scal, **hyper)

    def run_plain(ls):
        for p, gr, m, v in ls:
            fu._adam_keep_body(p, gr, m, v, *scal.unbind(0), **hyper)

    def library(ls):
        params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in ls]
        for prm, (_, gr, _, _) in zip(params, ls):
            prm.grad = gr
        opt = torch.optim.AdamW(params, lr=6e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                                fused=True)
        return opt.step

    rows = []
    for label, shapes in (("wte", [step_shapes[0]]), ("qkv_w", [step_shapes[6]]),
                          ("lnf_g", [step_shapes[2]]), ("step_16_leaves", step_shapes)):
        ls = leaves(shapes)
        ref = [fu._adam_keep_body(p, gr, m, v, *scal.unbind(0), **hyper) for p, gr, m, v in ls]
        work = [tuple(t.clone() for t in leaf) for leaf in ls]
        run_kernel(work)
        torch.cuda.synchronize()
        got = {"p": [w[0] for w in work], "m": [w[2] for w in work], "v": [w[3] for w in work]}
        errs, tols = {}, {}
        for i, part in enumerate(("p", "m", "v")):
            ref_i = [r[i] for r in ref]
            errs[part] = max(max_err(a, b) for a, b in zip(got[part], ref_i))
            tols[part] = ADAM_RTOL * max(float(b.abs().max()) for b in ref_i)
            check(errs[part] <= tols[part],
                  f"fused_adam {label}: {part} max_err {errs[part]} > tol {tols[part]} "
                  f"({ADAM_RTOL} of its largest entry)")
        err = max(errs.values())
        n = sum(int(np.prod(s)) for s in shapes)
        b_ms, b_by = bound_ms(ADAM_BYTES_PER_ELEM * n, ADAM_FLOPS_PER_ELEM * n, "float32")
        row = {
            "phase": "kernel", "kernel": "fused_adam", "leaves": label, "launches_per_call": len(shapes),
            "elements": n, "p_dtype": "float32", "max_err": err, "max_err_p_m_v": errs,
            "tol_p_m_v": tols,
            "kernel_ms": device_ms(torch, lambda: run_kernel(work), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: run_plain(work), flush, iters=5),
            "library_ms": device_ms(torch, library(work), flush, iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        rows.append(row)
        del ls, ref, work
    return rows


def bert_leaf_shapes(cfg):
    """The 26 leaf shapes of a BERT parameter tree (the layers stacked on
    a leading dim), checked against ``num_params``."""
    d, L, i, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size, cfg.vocab_size
    shapes = [(V, d), (cfg.max_position_embeddings, d), (cfg.type_vocab_size, d), (d,), (d,),
              (L, d), (L, d), (L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d),
              (L, d), (L, d), (L, d, i), (L, i), (L, i, d), (L, d),
              (d, d), (d,), (d, d), (d,), (d,), (d,), (V,), (d, 2), (2,)]
    check(len(shapes) == 26 and sum(int(np.prod(s)) for s in shapes) == cfg.num_params(),
          "BERT leaf shapes")
    return shapes


def check_fused_lamb(torch, dev, flush):
    """B7a and B7b per leaf (``tok_emb``, stacked ``qkv_w``, ragged
    ``mlm_bias`` and ``nsp_b``) and over one step's 26 leaves of
    BERT-large, f32 masters and grads, with and without bias correction.
    Leaves alternate between weight scale 0.02 and 1, and the 1-D
    ``mlm_bias`` is zero (its init), so the trust ratio takes its three
    branches: inside the clamp, at ``max_coeff`` 0.3, and 1."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.kernels import fused_update as fu

    shapes = bert_leaf_shapes(bert.BERT_LARGE)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    clamp = dict(min_coeff=0.01, max_coeff=0.3)
    g = torch.Generator(device=dev).manual_seed(17)

    def leaves(idx):
        out = []
        for j in idx:
            shp = shapes[j]
            scale = 0.0 if j == 23 else (0.02 if j % 2 == 0 else 1.0)
            p = torch.randn(shp, generator=g, device=dev) * scale
            out.append((p, torch.randn(shp, generator=g, device=dev) * 1e-3,
                        torch.randn(shp, generator=g, device=dev) * 1e-4,
                        torch.rand(shp, generator=g, device=dev) * 1e-7))
        return out

    rows = []
    for bias_correction in (True, False):
        c1, c2 = (1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3) if bias_correction else (1.0, 1.0)
        scal = torch.tensor([2e-3, 1.0, c1, c2], device=dev)
        for label, idx in (("tok_emb", [0]), ("qkv_w", [7]), ("mlm_bias", [23]), ("nsp_b", [25]),
                           ("step_26_leaves", list(range(26)))):
            if label != "step_26_leaves" and not bias_correction:
                continue  # the single leaves once; the whole step in both modes
            ls = leaves(idx)
            ref = [fu._lamb_math(p, gr, m, v, *scal.unbind(0), **hyper, **clamp)
                   for p, gr, m, v in ls]
            work = [tuple(t.clone() for t in leaf) for leaf in ls]
            dir_buf = torch.empty(max(p.numel() for p, _, _, _ in ls), device=dev)
            trusts = [fu.lamb_leaf_cuda(*w, scal, dir_buf=dir_buf, **hyper, **clamp) for w in work]
            torch.cuda.synchronize()
            errs, tols = {}, {}
            # work leaves are (p, g, m, v); _lamb_math returns (p, m, v, trust)
            for part, wi, ri in (("p", 0, 0), ("m", 2, 1), ("v", 3, 2)):
                ref_i = [r[ri] for r in ref]
                errs[part] = max(max_err(w[wi], b) for w, b in zip(work, ref_i))
                tols[part] = LAMB_RTOL * max(float(b.abs().max()) for b in ref_i)
                check(errs[part] <= tols[part],
                      f"fused_lamb {label}: {part} max_err {errs[part]} > tol {tols[part]} "
                      f"({LAMB_RTOL} of its largest entry)")
            t_ref = torch.stack([r[3].reshape(()) for r in ref])
            t_got = torch.cat(trusts)
            t_rel = float(((t_got - t_ref).abs() / t_ref).max())
            check(t_rel <= LAMB_TRUST_RTOL, f"fused_lamb {label}: trust off by {t_rel} relative")
            branches = {"at_max": int((t_ref == 0.3).sum()), "one": int((t_ref == 1.0).sum()),
                        "inside": int(((t_ref > 0.01) & (t_ref < 0.3)).sum())}
            n = sum(p.numel() for p, _, _, _ in ls)
            # each pass timed alone: pass 1 over every leaf (m and v move on
            # each repeat), pass 2 over every leaf with the trusts found above
            dir_k = device_ms(torch, lambda: [fu.lamb_dir_cuda(*w, scal, dir_buf, **hyper)
                                              for w in work], flush, iters=10)
            apply_k = device_ms(torch, lambda: [fu.lamb_apply_cuda(w[0], dir_buf, scal, t)
                                                for w, t in zip(work, trusts)], flush, iters=10)

            def plain_dir():
                for p, gr, m, v in work:
                    d, _, _ = fu._lamb_dir_body(p, gr, m, v, *scal.unbind(0)[1:], **hyper)
                    torch.linalg.vector_norm(p), torch.linalg.vector_norm(d)

            def plain_apply():
                lr, keep = scal[0], scal[1]
                for (p, _, _, _), t in zip(work, trusts):
                    (p - keep * lr * t * dir_buf[:p.numel()].view_as(p)).to(p.dtype)

            both = device_ms(torch, lambda: [fu.lamb_leaf_cuda(*w, scal, dir_buf=dir_buf, **hyper,
                                                               **clamp) for w in work],
                             flush, iters=10)
            for kernel, k_ms, plain_fn, nbytes, flops in (
                ("fused_lamb_dir", dir_k, plain_dir, LAMB_DIR_BYTES, LAMB_DIR_FLOPS),
                ("fused_lamb_apply", apply_k, plain_apply, LAMB_APPLY_BYTES, LAMB_APPLY_FLOPS),
            ):
                b_ms, b_by = bound_ms(nbytes * n, flops * n, "float32")
                row = {
                    "phase": "kernel", "kernel": kernel, "leaves": label,
                    "bias_correction": bias_correction, "launches_per_call": len(ls),
                    "elements": n, "p_dtype": "float32", "max_err": max(errs.values()),
                    "max_err_p_m_v": errs, "tol_p_m_v": tols, "trust_max_rel_err": t_rel,
                    "trust_tol": LAMB_TRUST_RTOL, "trust_branches": branches,
                    "kernel_ms": k_ms, "both_passes_with_trust_ms": both,
                    "plain_ms": device_ms(torch, plain_fn, flush, iters=5),
                    # torch.optim has no LAMB: no one PyTorch call computes it
                    "library_ms": None, "library": "none (torch.optim has no LAMB)",
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                emit(row)
                rows.append(row)
            del ls, ref, work, dir_buf
    return rows


def _bias_inputs(torch, dev, B, H, T, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype) for _ in range(4))
    keep = [BIAS_KEEP[b % len(BIAS_KEEP)] * T // 512 for b in range(B)]
    kb = torch.zeros(B, T, device=dev)
    for b, n in enumerate(keep):
        kb[b, n:] = -1e9
    return q, k, v, do, kb, keep


def check_flash_bias(torch, dev, flush):
    """B1 (with lse) and B2 with BERT-large's key-padding bias at B=8,
    H=16, T=512, d=64, non-causal, in bf16 and f32: rows keep 512, 448, 300
    and 129 keys.  A padded key's p must be exactly 0, so its dk and dv
    rows must be exactly 0."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 16, 512, 64
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v, do, kb, keep = _bias_inputs(torch, dev, B, H, T, d, dtype, seed=512)
        scale = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, kbias=kb)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, False, scale, kb)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, False, scale, kbias=kb)
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, False, scale, kb)
        torch.cuda.synchronize()
        err, lse_err, tol = max_err(out, ref), max_err(lse, ref_lse), TOL[name]
        check(torch.isfinite(out).all().item(), f"flash_fwd kbias {name}: non-finite output")
        check(err <= tol, f"flash_fwd kbias {name}: max_err {err} > tol {tol}")
        check(lse_err <= 1e-4, f"flash_fwd kbias {name}: lse max_err {lse_err} > 1e-4")
        fields = _bwd_fields(fa, got, refb, (q, k, v, do, lse, delta, False, scale, kb),
                             f"flash_bwd kbias {name}")
        padded = max(float(torch.cat([got[1][b, :, n:], got[2][b, :, n:]]).abs().max())
                     for b, n in enumerate(keep) if n < T)
        check(padded == 0.0, f"flash_bwd kbias {name}: a padded key's dk/dv is {padded}, not 0")
        item = dtype.itemsize
        mask = kb[:, None, None, :].to(dtype)  # SDPA's float mask, in q's type
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * item + B * H * T * 4 + B * T * 4,
                                4 * B * H * d * T * T, name)
        rows[("flash_fwd", name)] = {
            "phase": "kernel", "kernel": "flash_fwd", "body": body(name),
            "bias": "kbias (B, 1, 1, T)", "B": B,
            "H": H, "T": T, "d": d, "dtype": name, "causal": False, "lse": True,
            "keys_kept": keep, "max_err": err, "lse_max_err": lse_err, "tol": tol, "lse_tol": 1e-4,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, False, scale, want_lse=True, kbias=kb), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, False, scale, kb),
                                  flush, iters=5),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * item + 2 * B * H * T * 4 + B * T * 4,
                                5 * 2 * d * T * T * B * H, name)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        rows[("flash_bwd", name)] = {
            "phase": "kernel", "kernel": "flash_bwd", "body": body(name),
            "bias": "kbias (B, 1, 1, T)", "B": B,
            "H": H, "T": T, "d": d, "dtype": name, "causal": False, "keys_kept": keep,
            **fields, "padded_keys_dk_dv_max": padded,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, False, scale, kbias=kb), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, False, scale, kb), flush, iters=5),
            "library_ms": device_ms(torch, lambda: torch.autograd.grad(
                lout, (ql, kl, vl), do, retain_graph=True), flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del lout
        emit(rows[("flash_fwd", name)])
        emit(rows[("flash_bwd", name)])
    return rows


def _sdpa_grad(torch, F, q, k, v, do, **kw):
    """SDPA's backward through autograd on fresh leaves, for timing: a
    callable that recomputes the gradients of one forward."""
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lout = F.scaled_dot_product_attention(ql, kl, vl, **kw)
    return lambda: torch.autograd.grad(lout, (ql, kl, vl), do, retain_graph=True)


def _check_bwd_rows(got, ref, tol, label, rms_share=BWD_RMS_SHARE):
    errs, over = zip(*(grad_err(a, b, tol, rms_share) for a, b in zip(got, ref)))
    for grad, e, w in zip(("dq", "dk", "dv"), errs, over):
        check(w <= 1.0, f"{label}: {grad} max_err {e} is {w:.3g}x its entry bound "
                        f"{tol} * (|ref| + {rms_share} * rms(ref))")
    check(all(a.isfinite().all().item() for a in got), f"{label}: non-finite gradient")
    return list(errs), list(over)


def _bwd_fields(fa, got, ref, args, label, launch=None):
    """B2's gradients ``got`` checked, and the row's error fields.  Another
    launch on ``args`` (``launch``, default B2's ``flash_bwd_cuda``) must
    give the same bits: dq, dk and dv are summed in a fixed order.  f32
    (the CUDA-core body): against the plain version ``ref`` entry by entry
    (:func:`_check_bwd_rows`).  bf16 (the tensor-core body): the kernel's
    gradients and the plain version's against the float64 function of the
    same inputs ``args`` (``flash_bwd_float64``), each within the bound of
    the bf16 contract, which holds for any summation order; the max error
    against the plain version is reported beside it.  The entry bound is
    not a bound of that contract (a bf16 P or dS next to a rounding tie
    rounds either way): ``entry_bound_vs_float64`` gives the kernel's and
    the plain version's readings of it against float64, for the record."""
    again = (launch or fa.flash_bwd_cuda)(*args)
    check(all(bool(a.eq(b).all()) for a, b in zip(got, again)),
          f"{label}: dq, dk or dv differs between two launches")
    del again
    name = str(got[0].dtype).replace("torch.", "")
    tol = TOL[name]
    if name != "bfloat16":
        errs, over = _check_bwd_rows(got, ref, tol, label)
        return {"max_err": max(errs), "max_err_dq_dk_dv": errs, "err_over_bound_dq_dk_dv": over,
                "tol": tol, "tol_rms_share": BWD_RMS_SHARE, "bitwise_repeatable": True}
    witness = fa.flash_bwd_float64(*args)
    over = {"kernel": fa.float64_over_bound(got, witness),
            "plain": fa.float64_over_bound(ref, witness)}
    for who, ratios in over.items():
        for grad, w in zip(("dq", "dk", "dv"), ratios):
            check(w <= 1.0, f"{label}: the {who}'s {grad} is {w:.3g}x its float64 bound")
    check(all(a.isfinite().all().item() for a in got), f"{label}: non-finite gradient")
    entry = {who: [grad_err(g, x, tol)[1] for g, x in zip(grads, witness[0])]
             for who, grads in (("kernel", got), ("plain", ref))}
    errs = [max_err(a, b) for a, b in zip(got, ref)]
    return {"max_err": max(errs), "max_err_dq_dk_dv": errs,
            "kernel_over_float64_bound_dq_dk_dv": over["kernel"],
            "plain_over_float64_bound_dq_dk_dv": over["plain"],
            "entry_bound_vs_float64": entry, "tol": tol, "tol_rms_share": BWD_RMS_SHARE,
            "bitwise_repeatable": True}


def _padded_zero(got, keep, T):
    """The largest |dk|, |dv| over padded keys (must be exactly 0)."""
    return max(float(max(got[1][b, :, n:].abs().max(), got[2][b, :, n:].abs().max()))
               for b, n in enumerate(keep) if n < T)


def check_flash_dropout(torch, dev, flush):
    """B1 (with lse) and B2 with BERT-large's key-padding bias and
    attention dropout 0.1 (in-kernel Threefry bits) at B=8, H=16, T=512,
    d=64, non-causal, in bf16 and f32, against the plain versions on the
    same key words (the host twin's bits).  A single wrong keep-bit moves
    an f32 output by ~|v| / (0.9 T) ~ 2e-3, a hundred times the bound.
    Library: SDPA with ``dropout_p`` 0.1 and the float mask (its own random
    stream: the time alone is compared)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 16, 512, 64
    drop = fa.make_dropout(DROP_RATE, DROP_KEY)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v, do, kb, keep = _bias_inputs(torch, dev, B, H, T, d, dtype, seed=513)
        scale = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, kbias=kb, drop=drop)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, False, scale, kb, None, drop)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, False, scale, kb, None, drop)
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, False, scale, kb, None, drop)
        torch.cuda.synchronize()
        err, lse_err, tol = max_err(out, ref), max_err(lse, ref_lse), TOL[name]
        check(torch.isfinite(out).all().item(), f"flash_fwd kbias+dropout {name}: non-finite")
        check(err <= tol, f"flash_fwd kbias+dropout {name}: max_err {err} > tol {tol}")
        check(lse_err <= 1e-4, f"flash_fwd kbias+dropout {name}: lse max_err {lse_err} > 1e-4")
        fields = _bwd_fields(fa, got, refb,
                             (q, k, v, do, lse, delta, False, scale, kb, None, drop),
                             f"flash_bwd kbias+dropout {name}")
        padded = _padded_zero(got, keep, T)
        check(padded == 0.0, f"flash_bwd kbias+dropout {name}: a padded key's dk/dv is {padded}")
        item = dtype.itemsize
        mask = kb[:, None, None, :].to(dtype)
        keep_ops = THREEFRY_OPS_PER_SCORE * B * H * T * T  # one keep-bit a score
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * item + B * H * T * 4 + B * T * 4,
                                4 * B * H * d * T * T, name, keep_ops)
        rows[("flash_fwd", name)] = {
            "phase": "kernel", "kernel": "flash_fwd", "body": body(name),
            "bias": "kbias (B, 1, 1, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "lse": True, "keys_kept": keep, "max_err": err,
            "lse_max_err": lse_err, "tol": tol, "lse_tol": 1e-4,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, False, scale, want_lse=True, kbias=kb, drop=drop), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, False, scale, kb, None, drop), flush, iters=3),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=DROP_RATE), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
            "bound_note": "the slower of the dots on the tensor (f32: CUDA) cores and "
                          "Threefry's integer operations on the INT32 pipe",
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * item + 2 * B * H * T * 4 + B * T * 4,
                                5 * 2 * d * T * T * B * H, name, keep_ops)
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=mask, dropout_p=DROP_RATE)
        rows[("flash_bwd", name)] = {
            "phase": "kernel", "kernel": "flash_bwd", "body": body(name),
            "bias": "kbias (B, 1, 1, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "keys_kept": keep, **fields, "padded_keys_dk_dv_max": padded,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, False, scale, kb, None, drop), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, False, scale, kb, None, drop), flush, iters=3),
            "library_ms": device_ms(torch, sdpa_bwd, flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del sdpa_bwd
        emit(rows[("flash_fwd", name)])
        emit(rows[("flash_bwd", name)])
    return rows


def check_flash_fbias(torch, dev, flush):
    """B1 and B2 with the full bias form, read through its broadcast
    strides, at B=8, H=16, T=512, d=64 with dropout 0.1: a (8, 1, 512, 512)
    mask (the key padding plus a seq2seq pattern: each row's second half
    attends causally within it) in bf16 and f32 against the plain
    versions, and, in f32, a trainable (1, 16, 512, 512) bias through
    ``flash_attention``'s autograd (its cotangent under dropout) against
    the plain path with the host twin's keep-mask."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa
    from deepspeed_tpu_torch.tools.profile_training import seq2seq_mask

    B, H, T, d = 8, 16, 512, 64
    drop = fa.make_dropout(DROP_RATE, DROP_KEY)
    scale = d ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v, do, kb, keep = _bias_inputs(torch, dev, B, H, T, d, dtype, seed=514)
        mask4 = seq2seq_mask(kb, T)
        fb = mask4.expand(B, H, T, T)
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, fbias=fb, drop=drop)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, False, scale, None, fb, drop)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, False, scale, None, fb, drop)
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, False, scale, None, fb, drop)
        torch.cuda.synchronize()
        err, lse_err, tol = max_err(out, ref), max_err(lse, ref_lse), TOL[name]
        check(torch.isfinite(out).all().item(), f"flash_fwd fbias {name}: non-finite")
        check(err <= tol, f"flash_fwd fbias {name}: max_err {err} > tol {tol}")
        check(lse_err <= 1e-4, f"flash_fwd fbias {name}: lse max_err {lse_err} > 1e-4")
        fields = _bwd_fields(fa, got, refb, (q, k, v, do, lse, delta, False, scale, None, fb, drop),
                             f"flash_bwd fbias {name}")
        item = dtype.itemsize
        smask = mask4.to(dtype)
        bias_bytes = B * T * T * 4  # the (8, 1, 512, 512) f32 mask, read once
        keep_ops = THREEFRY_OPS_PER_SCORE * B * H * T * T  # one keep-bit a score
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * item + B * H * T * 4 + bias_bytes,
                                4 * B * H * d * T * T, name, keep_ops)
        rows[("flash_fwd", name)] = {
            "phase": "kernel", "kernel": "flash_fwd", "body": body(name),
            "bias": "fbias (B, 1, T, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "lse": True, "max_err": err, "lse_max_err": lse_err, "tol": tol,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, False, scale, want_lse=True, fbias=fb, drop=drop), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, False, scale, None, fb, drop), flush, iters=3),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=smask, dropout_p=DROP_RATE), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * item + 2 * B * H * T * 4 + bias_bytes,
                                5 * 2 * d * T * T * B * H, name, keep_ops)
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=smask, dropout_p=DROP_RATE)
        rows[("flash_bwd", name)] = {
            "phase": "kernel", "kernel": "flash_bwd", "body": body(name),
            "bias": "fbias (B, 1, T, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, **fields,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, False, scale, None, fb, drop), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, False, scale, None, fb, drop), flush, iters=3),
            "library_ms": device_ms(torch, sdpa_bwd, flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del sdpa_bwd
        emit(rows[("flash_fwd", name)])
        emit(rows[("flash_bwd", name)])

    # a trainable per-head bias under dropout, through the autograd function
    g = torch.Generator(device=dev).manual_seed(515)
    q, k, v, w = (torch.randn(B, H, T, d, generator=g, device=dev) for _ in range(4))
    bias = torch.randn(1, H, T, T, generator=g, device=dev) * 0.5
    grads = {}
    for label in ("kernels", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        if label == "kernels":
            out = fa.flash_attention(*leaves[:3], bias=leaves[3], dropout_rate=DROP_RATE,
                                     dropout_rng=DROP_KEY)
        else:
            m4 = fa.dropout_keep_mask_host(DROP_KEY, B, H, T, T, 1 - DROP_RATE, dev)
            out = fa.mha_reference(*leaves[:3], bias=leaves[3], dropout_mask=m4.view(B, H, T, T),
                                   keep_prob=1 - DROP_RATE)
        (out * w).sum().backward()
        grads[label] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    rel = [max_err(a, b) / float(b.abs().max()) for a, b in zip(grads["kernels"], grads["plain"])]
    check(max(rel) <= AUTOGRAD_F32_RTOL,
          f"trainable fbias under dropout: dq/dk/dv/dbias differ by {rel} of their largest "
          f"entries > {AUTOGRAD_F32_RTOL}")
    rows["trainable_bias"] = {
        "phase": "kernel", "kernel": "flash_attention (B1, B2, the bias cotangent)",
        "bias": "trainable (1, H, T, T)", "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d,
        "dtype": "float32", "rel_err_dq_dk_dv_dbias": rel, "tol": AUTOGRAD_F32_RTOL}
    emit(rows["trainable_bias"])
    return rows


def check_flash_bwd2(torch, dev, flush):
    """B6a (dq pass) and B6b (dk/dv pass) at one long sequence, B=1, H=16,
    T=9216, d=64 (past d 64's 8,192-row bound of the fused backward), in
    bf16 (the tensor-core bodies) and f32 (the CUDA-core bodies), with a
    key-padding bias keeping 8,000 keys and dropout 0.1, and dq the same
    bits over two launches.  bf16: the kernels' gradients, the plain
    version's and B2's on the same inputs within the float64 bound of the
    bf16 contract (``flash_bwd_float64``); their max errors against the
    plain version and B2 beside it.  f32: against the two-pass plain
    version and B2 entry by entry, and against the float64 function (the
    plain version's own error beside the kernel's).  Bound: the dots (the
    dq pass 6 T^2 d B H, the dk/dv pass 8 T^2 d B H, 14 together) or each
    pass's Threefry keep-bits on the INT32 pipe, the slower.  Library:
    SDPA's whole backward with the float mask and ``dropout_p`` 0.1, for
    both rows (no PyTorch call computes either pass alone).  Then the
    tensor-core pair at GPT-2's training shape (8, 12, 1024, 64, causal, no
    bias) beside B2: the deterministic route's cost (``flash_bwd2_gpt2``)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d, kept = 1, 16, LONG_T, 64, LONG_KEEP
    drop = fa.make_dropout(DROP_RATE, DROP_KEY)
    scale = d ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device=dev).manual_seed(9216)
        q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype)
                       for _ in range(4))
        kb = torch.zeros(B, T, device=dev)
        kb[:, kept:] = -1e9
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, kbias=kb, drop=drop)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, False, scale, kb, None, drop)
        got = fa.flash_bwd2_cuda(*args)
        again = fa.flash_bwd_dq_cuda(*args)
        b2 = fa.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        tol = TOL[name]
        check(torch.equal(got[0], again), f"flash_bwd_dq {name}: dq differs between two launches")
        check(all(a.isfinite().all().item() for a in got), f"flash_bwd2 {name}: non-finite gradient")
        torch.cuda.empty_cache()
        ref = fa.flash_bwd2_reference(*args)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            torch.cuda.empty_cache()
            witness = fa.flash_bwd_float64(*args)
            over = {"kernel": fa.float64_over_bound(got, witness),
                    "plain": fa.float64_over_bound(ref, witness),
                    "flash_bwd": fa.float64_over_bound(b2, witness)}
            del witness
            for who, ratios in over.items():
                for grad, w in zip(("dq", "dk", "dv"), ratios):
                    check(w <= 1.0, f"flash_bwd2 {name}: the {who}'s {grad} is {w:.3g}x its "
                                    f"float64 bound")
            fields = {
                "kernel_over_float64_bound_dq_dk_dv": over["kernel"],
                "plain_over_float64_bound_dq_dk_dv": over["plain"],
                "flash_bwd_over_float64_bound_dq_dk_dv": over["flash_bwd"],
                "max_err_dq_dk_dv": [max_err(a, b) for a, b in zip(got, ref)],
                "vs_flash_bwd_max_err_dq_dk_dv": [max_err(a, b) for a, b in zip(got, b2)],
                "dk_dv_equal_flash_bwd_bits": bool(torch.equal(got[1], b2[1])
                                                   and torch.equal(got[2], b2[2])),
            }
        else:
            b2_errs, b2_over = _check_bwd_rows(got, b2, tol, f"flash_bwd2 vs flash_bwd {name}",
                                               LONG_RMS_SHARE)
            errs, over = _check_bwd_rows(got, ref, tol, f"flash_bwd2 {name}", LONG_RMS_SHARE)
            # both f32 results against float64, at the unscaled rms share
            torch.cuda.empty_cache()
            exact = fa.flash_bwd_float64(*args)[0]
            f64 = {label + "_vs_f64_over_bound_dq_dk_dv": [grad_err(a, b, tol)[1]
                                                           for a, b in zip(res, exact)]
                   for label, res in (("kernel", got), ("plain", ref))}
            emit({"phase": "kernel", "kernel": "flash_bwd2 vs float64", "dtype": name, "T": T,
                  "tol": tol, "tol_rms_share": BWD_RMS_SHARE, **f64})
            _check_bwd_rows(got, exact, tol, f"flash_bwd2 {name} vs float64", LONG_RMS_SHARE)
            del exact
            fields = {"max_err_dq_dk_dv": errs, "err_over_bound_dq_dk_dv": over,
                      "vs_flash_bwd_max_err_dq_dk_dv": b2_errs, "vs_flash_bwd_over_bound": b2_over,
                      "tol_rms_share": LONG_RMS_SHARE, **f64}
        del ref
        torch.cuda.empty_cache()
        padded = _padded_zero(got, [kept], T)
        check(padded == 0.0, f"flash_bwd2 {name}: a padded key's dk/dv is {padded}")
        item = dtype.itemsize
        small = 2 * B * H * T * 4 + B * T * 4  # lse, delta, the bias row
        keep_ops = THREEFRY_OPS_PER_SCORE * B * H * T * T  # each pass regenerates the bits
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=kb[:, None, None, :].to(dtype),
                              dropout_p=DROP_RATE)
        library_ms = device_ms(torch, sdpa_bwd, flush, iters=3, warmup=1)
        del sdpa_bwd
        for kernel, fn, plain, nbytes, flops in (
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq_cuda(*args),
             lambda: fa.flash_bwd_dq_reference(*args), 5 * B * H * T * d * item + small,
             6 * T * T * d * B * H),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv_cuda(*args),
             lambda: fa.flash_bwd_dkv_reference(*args), 6 * B * H * T * d * item + small,
             8 * T * T * d * B * H),
        ):
            b_ms, b_by = bound_ms(nbytes, flops, name, keep_ops)
            rows[(kernel, name)] = {
                "phase": "kernel", "kernel": kernel, "body": body(name),
                "bias": "kbias (B, 1, 1, T)", "dropout": DROP_RATE, "B": B, "H": H, "T": T,
                "d": d, "dtype": name, "causal": False, "keys_kept": kept,
                "max_err": max(fields["max_err_dq_dk_dv"]), **fields,
                "dq_bitwise_repeatable": True, "padded_keys_dk_dv_max": padded, "tol": tol,
                "kernel_ms": device_ms(torch, fn, flush, iters=3, warmup=1),
                "plain_ms": device_ms(torch, plain, flush, iters=1, warmup=0),
                "library_ms": library_ms,
                "library": "SDPA's whole backward (float mask, dropout_p 0.1)",
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_note": "the slower of the dots and the pass's Threefry keep-bits on "
                              "the INT32 pipe",
            }
            torch.cuda.empty_cache()
        rows[("flash_bwd", name)] = {
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(*args), flush, iters=3,
                                   warmup=1)}
        emit(rows[("flash_bwd_dq", name)])
        emit(rows[("flash_bwd_dkv", name)])
        emit({"phase": "kernel", "kernel": "flash_bwd", "body": body(name), "B": B, "H": H,
              "T": T, "d": d, "dtype": name, "bias": "kbias (B, 1, 1, T)", "dropout": DROP_RATE,
              "kernel_ms": rows[("flash_bwd", name)]["kernel_ms"],
              "pair_over_flash_bwd": (rows[("flash_bwd_dq", name)]["kernel_ms"]
                                      + rows[("flash_bwd_dkv", name)]["kernel_ms"])
              / rows[("flash_bwd", name)]["kernel_ms"],
              "note": "B2 on B6's inputs, for comparison"})
        del q, k, v, do, out, lse, delta, got, again, b2, args
        torch.cuda.empty_cache()
    rows["gpt2"] = _check_flash_bwd2_gpt2(torch, dev, flush)
    return rows


def _check_flash_bwd2_gpt2(torch, dev, flush):
    """The tensor-core B6a + B6b pair at GPT-2's training shape (bf16, B=8,
    H=12, T=1024, d=64, causal, no bias) beside B2 on the same inputs (both
    the same bits every launch since B2 sums dq in a fixed order; the pair
    is the two-pass route's cost).  Gradients (the pair's and the plain
    version's) within the float64 bound."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 12, 1024, 64
    g = torch.Generator(device=dev).manual_seed(T + 7)
    q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    got = fa.flash_bwd2_cuda(*args)
    ref = fa.flash_bwd2_reference(*args)
    fields = _bwd_fields(fa, got, ref, args, "flash_bwd2 GPT-2 shape", fa.flash_bwd2_cuda)
    del ref
    pairs = T * (T + 1) / 2  # causal (query, key) pairs
    b_ms, b_by = bound_ms(7 * B * H * T * d * 2 + 2 * B * H * T * 4, 14 * d * pairs * B * H,
                          "bfloat16")
    sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, is_causal=True)
    row = {
        "phase": "kernel", "kernel": "flash_bwd2_gpt2", "pair": "flash_bwd_dq + flash_bwd_dkv",
        "body": "tc", "B": B, "H": H, "T": T, "d": d, "dtype": "bfloat16", "causal": True,
        **fields,
        "kernel_ms": device_ms(torch, lambda: fa.flash_bwd2_cuda(*args), flush, iters=10),
        "flash_bwd_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(*args), flush, iters=10),
        "plain_ms": device_ms(torch, lambda: fa.flash_bwd2_reference(*args), flush, iters=3),
        "library_ms": device_ms(torch, sdpa_bwd, flush, iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["pair_over_flash_bwd"] = row["kernel_ms"] / row["flash_bwd_ms"]
    del sdpa_bwd
    emit(row)
    return row


def _splash_work(layout, block, causal=True):
    """The (query, key) pairs the splash kernels compute over a layout's
    sparse rows (dense rows excluded, as the kernels exclude them), summed
    over the heads: causal inside diagonal blocks."""
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    dense = sp._dense_row_mask(layout, exempt_uniform_full=True)
    active = (layout != 0) & ~dense[:, :, None]
    nb = layout.shape[1]
    diag = np.eye(nb, dtype=bool)[None]
    per_edge = np.where(diag, block * (block + 1) // 2, block * block) if causal else block * block
    above = np.triu(np.ones((nb, nb), bool), 1)[None] if causal else np.zeros((1, nb, nb), bool)
    return int((active * per_edge * ~above).sum())


def _splash_grad_errs(got, ref, tol, layout, block, label, enforce=True):
    """Check the splash backward entry by entry against
    ``sparse.splash_grad_bound`` (share BWD_RMS_SHARE, grown per layout
    block as √(terms / 1024) of that block's sum); ``enforce=False`` only
    reads.  Returns ``(max_err, max of the error over its bound, largest
    share)``, each dq, dk, dv."""
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    errs, over, shares = [], [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        bound, share = sp.splash_grad_bound(name, b, layout, block, tol, BWD_RMS_SHARE)
        diff = (a.double() - b.double()).abs()
        errs.append(float(diff.max()))
        over.append(float((diff / bound.clamp_min(1e-30)).max()))
        shares.append(share)
        if enforce:
            check(over[-1] <= 1.0, f"{label}: {name} max_err {errs[-1]} is {over[-1]:.3g}x its "
                                   f"entry bound {tol} * (|ref| + share * rms(ref's block))")
            check(bool(a.isfinite().all()), f"{label}: non-finite {name}")
    return errs, over, shares


def _splash_bwd_float64(torch, args):
    """The splash backward's function in float64, head by head, dense over
    the layout expanded to (T, T) and the causal triangle, on the same
    inputs (lse, delta): the yardstick that tells the f32 kernels'
    summation error from the f32 plain versions' (as ``flash_bwd_float64``
    for B6).  Returns ``(dq, dk, dv)`` in float64."""
    q, k, v, do, lse, delta, layout, block, causal, scale = args
    T = q.shape[2]
    grads = ([], [], [])
    for h in range(q.shape[1]):
        blocks = torch.as_tensor(layout[h % layout.shape[0]], device=q.device).bool()
        allowed = blocks.repeat_interleave(block, 0).repeat_interleave(block, 1)
        if causal:
            allowed &= torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        qh, kh, vh, doh = (t[0, h].double() for t in (q, k, v, do))
        s = (qh @ kh.T * scale).masked_fill_(~allowed, float("-inf"))
        del allowed
        p = torch.exp(s.sub_(lse[0, h].double()[:, None]))  # +inf lse: a zero row
        del s
        ds = p * (doh @ vh.T - delta[0, h].double()[:, None]) * scale
        for out, g in zip(grads, (ds @ kh, ds.T @ qh, p.T @ doh)):
            out.append(g)
        del p, ds
    return tuple(torch.stack(g)[None] for g in grads)


def _check_splash_bodies(kernels, name, label):
    """Since the last reset, two launches each of B9a and B9b, on the body
    q's type takes: bf16 the tensor cores' (``splash_attn_tc.cu``), f32 the
    CUDA cores'."""
    form = "none/" + body(name)
    for kernel in ("splash_bwd_dq", "splash_bwd_dkv"):
        ran = kernels.launch_variants()[kernel]
        check(ran == {form: 2}, f"{label}: {kernel} ran {ran}, not {form} twice")


def _check_splash_fwd_body(kernels, name, label):
    """Since the last reset, two launches of B8 on the body q's type takes:
    bf16 the tensor cores' (``splash_attn_tc.cu``), f32 the CUDA cores'."""
    ran = kernels.launch_variants()["splash_fwd"]
    form = "none/" + body(name)
    check(ran == {form: 2}, f"{label}: splash_fwd ran {ran}, not {form} twice")


def _splash_bf16_fields(fa, sp, got, ref, args, label):
    """The bf16 B9a/B9b gradients ``got`` (the tensor-core bodies) and the
    plain version's ``ref`` against the float64 function of the same inputs
    ``args``, each within the bound of the bf16 contract
    (``sparse.splash_bwd_float64``), which holds for any summation order: a
    bf16 P or dS next to a rounding tie rounds either way.  Returns the
    row's fields."""
    witness = sp.splash_bwd_float64(*args)
    over = {"kernel": fa.float64_over_bound(got, witness),
            "plain": fa.float64_over_bound(ref, witness)}
    for who, ratios in over.items():
        for grad, w in zip(("dq", "dk", "dv"), ratios):
            check(w <= 1.0, f"{label}: the {who}'s {grad} is {w:.3g}x its float64 bound")
    check(all(bool(a.isfinite().all()) for a in got), f"{label}: non-finite gradient")
    return {"kernel_over_float64_bound_dq_dk_dv": over["kernel"],
            "plain_over_float64_bound_dq_dk_dv": over["plain"]}


def check_splash(torch, dev, flush):
    """B8 (splash_fwd, with lse), B9a (splash_bwd_dq) and B9b
    (splash_bwd_dkv) at the sparse main path's shapes, B=1, H=12, d=64, T
    8192 and 16384 with GPT-2's default sparse layout (unidirectional
    BigBird, block 256, causal), in bf16 (on their tensor-core bodies) and
    f32: the forward against its plain version (the bf16 one also against
    the float64 function, :func:`_fwd_float64_fields`); the bf16
    backward, kernels and plain version, against the float64 function
    within the bf16 contract's bound (:func:`_splash_bf16_fields`); the
    f32 backward against its plain version entry by entry
    (``sparse.splash_grad_bound``), and the f32 kernels and plain versions
    against the float64 function (:func:`_splash_bwd_float64`); out, lse
    and dq/dk/dv the same bits over two launches, each launch on the body
    its dtype takes, the lse of a row with no block +inf where the plain
    version's is; then a per-head, an untouched-column and a
    zero-degree-row layout at (1, 2, 1024, 64), block 256, whose empty
    columns' dk/dv must be exactly 0 and whose empty rows' output 0, and
    BigBird at (1, 2, 1536, 64) with a block of 96 and at (1, 2, 512, 64)
    with a block of 16, both dtypes.  Bound by operations over the
    layout's scores (causal inside diagonal blocks): 4 d a score forward,
    6 d for the dq pass, 8 d for the dk/dv pass.  Library: SDPA with the
    layout expanded to a (1, 1, T, T) boolean mask, and its backward by
    autograd (for both backward rows)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    B, H, d = 1, 12, 64
    scale = d ** -0.5
    rows = {}
    for T in SPARSE_TS:
        cfg = dataclasses.replace(gpt2.PRESETS["gpt2"], n_positions=T, attention_mode="sparse")
        layout, block = gpt2.sparse_layout(cfg, T)
        check(not sp._dense_row_mask(layout, True).any(), f"splash T={T}: a dense row")
        scores = _splash_work(layout, block)
        blocks = torch.as_tensor(layout[0], device=dev).bool()
        allowed = blocks.repeat_interleave(block, 0).repeat_interleave(block, 1)
        allowed &= torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        allowed = allowed[None, None]
        del blocks
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            tol = TOL[name]
            g = torch.Generator(device=dev).manual_seed(T)
            q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            kernels.reset_launches()
            out, lse = sp.splash_fwd_cuda(q, k, v, layout, block, True, scale, want_lse=True)
            out2, lse2 = sp.splash_fwd_cuda(q, k, v, layout, block, True, scale, want_lse=True)
            ref, ref_lse = sp.splash_fwd_reference(q, k, v, layout, block, True, scale)
            torch.cuda.synchronize()
            _check_splash_fwd_body(kernels, name, f"splash_fwd T={T} {name}")
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"splash_fwd T={T} {name}: out or lse differs between two launches")
            del out2, lse2
            fwd_err = max_err(out, ref)
            check(fwd_err <= tol, f"splash_fwd T={T} {name}: max_err {fwd_err} > {tol}")
            inf = torch.isinf(ref_lse)
            check(torch.equal(torch.isinf(lse), inf), f"splash_fwd T={T} {name}: +inf lse rows differ")
            lse_err = max_err(lse[~inf], ref_lse[~inf])
            check(lse_err <= 1e-4, f"splash_fwd T={T} {name}: lse max_err {lse_err} > 1e-4")
            fwd_f64 = {}
            if dtype == torch.bfloat16:
                fwd_f64 = _fwd_float64_fields(
                    out, ref, sp.splash_fwd_float64(q, k, v, layout, block, True, scale),
                    f"splash_fwd T={T} {name}")
                torch.cuda.empty_cache()
            del ref, ref_lse
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta, layout, block, True, scale)
            kernels.reset_launches()
            got = (sp.splash_bwd_dq_cuda(*args), *sp.splash_bwd_dkv_cuda(*args))
            again = (sp.splash_bwd_dq_cuda(*args), *sp.splash_bwd_dkv_cuda(*args))
            torch.cuda.synchronize()
            _check_splash_bodies(kernels, name, f"splash T={T} {name}")
            for label, a, b in zip(("dq", "dk", "dv"), got, again):
                check(torch.equal(a, b), f"splash T={T} {name}: {label} differs between two launches")
            del again
            ref = (sp.splash_bwd_dq_reference(*args), *sp.splash_bwd_dkv_reference(*args))
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                errs = [max_err(a, b) for a, b in zip(got, ref)]
                f64 = _splash_bf16_fields(fa, sp, got, ref, args, f"splash T={T} {name}")
            else:
                errs, over, shares = _splash_grad_errs(got, ref, tol, layout, block,
                                                       f"splash T={T} {name}")
                f64 = {"err_over_bound_dq_dk_dv": list(over), "tol_rms_share_dq_dk_dv": list(shares)}
                # both f32 results against float64, under the per-block bound
                # (the kernel's held to it) and under the whole tensor's rms
                # with share √(T/1024), the bound first tried
                exact = _splash_bwd_float64(torch, args)
                whole = BWD_RMS_SHARE * (T / 1024) ** 0.5
                f64["kernel_vs_plain_over_whole_tensor_bound_dq_dk_dv"] = [
                    grad_err(a, b, tol, whole)[1] for a, b in zip(got, ref)]
                for label, res in (("kernel", got), ("plain", ref)):
                    e, o, _ = _splash_grad_errs(res, exact, tol, layout, block,
                                                f"splash T={T} {label} vs float64",
                                                enforce=label == "kernel")
                    f64[label + "_vs_f64_max_err_dq_dk_dv"] = e
                    f64[label + "_vs_f64_over_bound_dq_dk_dv"] = o
                    f64[label + "_vs_f64_over_whole_tensor_bound_dq_dk_dv"] = [
                        grad_err(a, b, tol, whole)[1] for a, b in zip(res, exact)]
                emit({"phase": "kernel", "kernel": "splash_bwd vs float64", "dtype": name,
                      "T": T, "tol": tol, "whole_tensor_share": whole, **f64})
                del exact
            del ref, got
            torch.cuda.empty_cache()
            item = dtype.itemsize
            tensor_bytes = B * H * T * d * item
            sdpa_fwd = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
            fwd_lib_ms = device_ms(torch, sdpa_fwd, flush, iters=3, warmup=1)
            sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=allowed)
            bwd_lib_ms = device_ms(torch, sdpa_bwd, flush, iters=3, warmup=1)
            del sdpa_bwd
            torch.cuda.empty_cache()
            for kernel, fn, plain, nbytes, flops, err, lib, lib_name in (
                ("splash_fwd",
                 lambda: sp.splash_fwd_cuda(q, k, v, layout, block, True, scale, want_lse=True),
                 lambda: sp.splash_fwd_reference(q, k, v, layout, block, True, scale),
                 4 * tensor_bytes + B * H * T * 4, 4 * d * scores * B, fwd_err, fwd_lib_ms,
                 "SDPA (bool mask)"),
                ("splash_bwd_dq", lambda: sp.splash_bwd_dq_cuda(*args),
                 lambda: sp.splash_bwd_dq_reference(*args), 5 * tensor_bytes + 2 * B * H * T * 4,
                 6 * d * scores * B, errs[0], bwd_lib_ms, "SDPA's whole backward (bool mask)"),
                ("splash_bwd_dkv", lambda: sp.splash_bwd_dkv_cuda(*args),
                 lambda: sp.splash_bwd_dkv_reference(*args), 6 * tensor_bytes + 2 * B * H * T * 4,
                 8 * d * scores * B, max(errs[1:]), bwd_lib_ms,
                 "SDPA's whole backward (bool mask)"),
            ):
                b_ms, b_by = bound_ms(nbytes, flops, name)
                row = {
                    "phase": "kernel", "kernel": kernel, "layout": "bigbird-uni",
                    "variant": body(name),
                    "block": block, "B": B, "H": H, "T": T, "d": d, "dtype": name,
                    "causal": True, "active_blocks_per_head": int(layout[0].sum()),
                    "scores": scores * B, "max_err": err, "tol": tol,
                    "kernel_ms": device_ms(torch, fn, flush, iters=5, warmup=1),
                    "plain_ms": device_ms(torch, plain, flush, iters=3, warmup=1),
                    "library_ms": lib, "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
                    "bitwise_repeatable": True,
                }
                if kernel != "splash_fwd":
                    row.update({"max_err_dq_dk_dv": list(errs), **f64})
                else:
                    row.update({"lse_max_err": lse_err, "lse_tol": 1e-4, **fwd_f64})
                rows[(kernel, T, name)] = row
                emit(row)
                torch.cuda.empty_cache()
            del q, k, v, do, out, lse, delta, args
            torch.cuda.empty_cache()
        del allowed
        torch.cuda.empty_cache()

    # -- layouts the main path does not reach, at a small shape: per-head,
    # untouched columns, and BigBird with a block of 96 (its 64-row tiles
    # also hold the next block's rows) ---------------------------------------
    small = {}
    for label, T, block in (("per-head", 1024, 256), ("untouched-columns", 1024, 256),
                            ("zero-degree-row", 1024, 256), ("bigbird-uni", 1536, 96),
                            ("bigbird-uni", 512, 16)):
        layout = (sp.BigBirdSparsityConfig(num_heads=2, block=block, attention="unidirectional")
                  .make_layout(T) if label == "bigbird-uni" else sp.check_layouts(T // block)[label])
        label = f"{label} block {block}"
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            g = torch.Generator(device=dev).manual_seed(7)
            q, k, v, do = (torch.randn(1, 2, T, d, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            kernels.reset_launches()
            out, lse = sp.splash_fwd_cuda(q, k, v, layout, block, True, scale, want_lse=True)
            out2, lse2 = sp.splash_fwd_cuda(q, k, v, layout, block, True, scale, want_lse=True)
            ref, ref_lse = sp.splash_fwd_reference(q, k, v, layout, block, True, scale)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta, layout, block, True, scale)
            got = (sp.splash_bwd_dq_cuda(*args), *sp.splash_bwd_dkv_cuda(*args))
            again = (sp.splash_bwd_dq_cuda(*args), *sp.splash_bwd_dkv_cuda(*args))
            refb = (sp.splash_bwd_dq_reference(*args), *sp.splash_bwd_dkv_reference(*args))
            torch.cuda.synchronize()
            _check_splash_fwd_body(kernels, name, f"splash_fwd {label} {name}")
            _check_splash_bodies(kernels, name, f"splash {label} {name}")
            fwd_err = max_err(out, ref)
            check(fwd_err <= TOL[name], f"splash_fwd {label} {name}: max_err {fwd_err}")
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"splash_fwd {label} {name}: out or lse differs between two launches")
            inf = torch.isinf(ref_lse)
            check(torch.equal(torch.isinf(lse), inf), f"splash_fwd {label} {name}: +inf lse rows "
                                                      f"differ")
            lse_err = max_err(lse[~inf], ref_lse[~inf])
            check(lse_err <= 1e-4, f"splash_fwd {label} {name}: lse max_err {lse_err} > 1e-4")
            check(not out[inf].any(), f"splash_fwd {label} {name}: a row with no block is not 0")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"splash {label} {name}: gradients differ between two launches")
            if dtype == torch.bfloat16:
                errs = [max_err(a, b) for a, b in zip(got, refb)]
                over = _splash_bf16_fields(fa, sp, got, refb, args, f"splash {label} {name}")
            else:
                errs, over, _ = _splash_grad_errs(got, refb, TOL[name], layout, block,
                                                  f"splash {label} {name}")
            zero = None
            if label.startswith("untouched-columns"):
                zero = max(float(x.reshape(1, 2, T // block, block, d)[:, h, c].abs().max())
                           for x in got[1:] for h, c in sp.UNTOUCHED_COLUMNS)
                check(zero == 0.0, f"splash {label} {name}: an untouched column's dk/dv is {zero}")
            small[(label, name)] = {"T": T, "fwd_max_err": fwd_err, "lse_max_err": lse_err,
                                    "inf_lse_rows": int(inf.sum()), "max_err_dq_dk_dv": errs,
                                    "err_over_bound_dq_dk_dv": over, "empty_columns_max": zero}
    emit({"phase": "kernel", "kernel": "splash (per-head, untouched columns, zero-degree row, "
                                       "blocks 96 and 16)", "B": 1,
          "H": 2, "d": d, "causal": True,
          "results": {f"{a}/{b}": r for (a, b), r in small.items()}})
    return rows


# ---------------------------------------------------------------------------
# phases 5 and 6: the training path
# ---------------------------------------------------------------------------

ALLOC_EVENTS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _train(torch, model_fn, params, config, batch, steps, probe=None):
    """``steps`` train_batch calls on one batch: ``(engine, losses, wall
    seconds a step)``.  With a list ``probe``, each step appends what the
    host spent around the card's work: the garbage collector's pauses (ms
    and count, by the generation collected) and the caching allocator's
    cudaMalloc and cudaFree calls and retries."""
    import deepspeed_tpu_torch

    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=params,
                                                     config=config)
    losses, walls, pauses = [], [], []

    def on_gc(phase, info):
        pauses.append((phase, info["generation"], time.perf_counter()))

    if probe is not None:
        gc.callbacks.append(on_gc)
    try:
        for _ in range(steps):
            pauses.clear()
            before = torch.cuda.memory_stats() if probe is not None else None
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            losses.append(float(loss))  # the host read ends the step
            walls.append(time.perf_counter() - t0)
            if probe is not None:
                after = torch.cuda.memory_stats()
                ms, count = [0.0] * 3, [0] * 3
                for (_, _, t0), (_, g, t1) in zip(pauses[::2], pauses[1::2]):
                    ms[g] += (t1 - t0) * 1e3
                    count[g] += 1
                probe.append({"gc_ms_by_generation": ms, "gc_count_by_generation": count,
                              **{n: after.get(n, 0) - before.get(n, 0) for n in ALLOC_EVENTS}})
    finally:
        if probe is not None:
            gc.callbacks.remove(on_gc)
    return engine, losses, walls


def phase_train_f32(torch, params):
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    cfg = gpt2.PRESETS["gpt2"]
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}}}
    batch = {"input_ids": np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 1024),
                                                             dtype=np.int32)}
    out = {}
    for name, c in (("kernels", cfg), ("plain_attention", dataclasses.replace(
            cfg, use_flash_attention=False))):
        kernels.reset_launches()
        engine, losses, walls = _train(torch, gpt2.make_model(c)[0], params, config, batch, 3)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": kernels.launches(), "variants": kernels.launch_variants()}
        del engine
        torch.cuda.empty_cache()
    check(out["kernels"]["launches"]["flash_bwd"] > 0 and out["plain_attention"]["launches"]["flash_bwd"] == 0,
          f"train_f32: flash launches {out['kernels']['launches']} / {out['plain_attention']['launches']}")
    for name in ("flash_fwd", "flash_bwd"):
        check(out["kernels"]["variants"][name] == {"none/simt": out["kernels"]["launches"][name]},
              f"train_f32: {name} ran {out['kernels']['variants'][name]}, not only the f32 body")
    k, p = out["kernels"]["losses"], out["plain_attention"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_f32: non-finite loss {k} / {p}")
    check(max(rel) <= TRAIN_F32_LOSS_RTOL,
          f"train_f32: kernel vs plain losses differ by {max(rel)} > {TRAIN_F32_LOSS_RTOL}")
    emit({"phase": "train_f32", "B": 2, "T": 1024, "steps": 3, "allow_tf32": False,
          "losses": out, "max_rel_diff": max(rel), "tol": TRAIN_F32_LOSS_RTOL})


def _first_step_bits(torch, model_fn, params, config, batch):
    """The ROADMAP C3 reading (not a gate): two first ``train_batch`` steps
    from the same state and batch, each through a fresh engine, compared
    bit for bit: the loss, every parameter after the update, and every
    output of every B1 and B2 launch in launch order (each kernel's outputs
    kept for the comparison).  Where they differ, the first kernel launch
    that differs and the parameters that differ name the op."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa
    from deepspeed_tpu_torch.runtime.engine import tree_items

    runs = []
    wrapped = ("flash_fwd_cuda", "flash_bwd_cuda")
    real = {name: getattr(fa, name) for name in wrapped}
    try:
        for _ in range(2):
            outs = []

            def keep(name, fn):
                def run(*args, **kwargs):
                    res = fn(*args, **kwargs)
                    outs.append((name, [t.clone() for t in res if t is not None]))
                    return res
                return run

            for name in wrapped:
                setattr(fa, name, keep(name, real[name]))
            engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=params,
                                                             config=config)
            loss = engine.train_batch(batch)
            runs.append((float(loss), outs, dict(tree_items(engine.params))))
            del engine
    finally:
        for name in wrapped:
            setattr(fa, name, real[name])
    (loss_a, outs_a, par_a), (loss_b, outs_b, par_b) = runs
    first = next(({"op": na, "launch": i, "of": len(outs_a)}
                  for i, ((na, a), (_, b)) in enumerate(zip(outs_a, outs_b))
                  if not all(torch.equal(x, y) for x, y in zip(a, b))), None)
    differ = [name for name in par_a if not torch.equal(par_a[name], par_b[name])]
    row = {"phase": "train_bf16_first_step_bits", "same_loss": loss_a == loss_b,
           "same_params": not differ, "params_differing": differ,
           "kernel_launches_compared": len(outs_a), "first_kernel_launch_differing": first,
           "note": "ROADMAP C3 reading, not a gate"}
    # the first step's updated masters (B3's update), on the host: the
    # offload phases hold the host Adam's first step to them
    step1 = {name: t.detach().cpu() for name, t in par_a.items()}
    del runs, outs_a, outs_b, par_a, par_b
    torch.cuda.empty_cache()
    emit(row)
    return row, step1


def _gpt2_bf16_config(mb, gas):
    return {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                  "weight_decay": 0.1}},
        # warmup_min_lr > 0: the log warmup's first step would otherwise run
        # at lr 0 and update nothing
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 6e-5,
            "warmup_max_lr": 6e-4}},
    }


def phase_train_bf16(torch, params):
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    cfg = gpt2.PRESETS["gpt2"]
    mb, gas, T, steps = 8, 2, 1024, 4
    config = _gpt2_bf16_config(mb, gas)
    batch = {"input_ids": np.random.default_rng(12).integers(0, cfg.vocab_size, (mb * gas, T),
                                                             dtype=np.int32)}
    _, step1 = _first_step_bits(torch, gpt2.make_model(cfg)[0], params, config, batch)
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    engine, losses, walls = _train(torch, gpt2.make_model(cfg)[0], params, config, batch, steps)
    launches = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------

    for name in ("flash_fwd", "flash_bwd", "fused_adam"):
        check(launches[name] > 0, f"kernel {name} was not launched on the training main path")
    for name in ("flash_fwd", "flash_bwd"):
        check(only_tc(variants[name]),
              f"train_bf16: {name} ran {variants[name]}, not only the tensor-core body")
    check(all(np.isfinite(losses)), f"train_bf16: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_bf16: loss did not fall: {losses}")
    tokens = mb * gas * T
    # all the tokens over all the time of the steps after the first (which
    # includes the kernels' first load)
    step_s = float(sum(walls[1:])) / (steps - 1)
    # model FLOPs a step: 6 N per token for the weights (the tied head
    # included) and 6 L T d per token for causal attention, forward and
    # backward; remat's recompute is not counted
    flops = tokens * (6 * cfg.num_params() + 6 * cfg.n_layer * T * cfg.n_embd)
    one_process = {"losses": losses, "batch": batch["input_ids"],
                   "digests": _state_digests(torch, engine),
                   "launches": launches, "step_ms_median": float(np.median(walls[1:])) * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "peak_bytes": torch.cuda.max_memory_allocated(), "step1_masters": step1}
    global_steps = engine.global_steps
    del engine
    torch.cuda.empty_cache()
    tel = train_telemetry(torch, cfg, params, config, batch, tokens)
    emit({"phase": "train_bf16", "micro_batch": mb, "gas": gas, "T": T, "steps": steps,
          "losses": losses, "step_ms": [w * 1e3 for w in walls], "step_ms_mean_after_first": step_s * 1e3,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": one_process["peak_gib"],
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "variants": {n: variants[n] for n in ("flash_fwd", "flash_bwd")},
          "global_steps": global_steps, "telemetry": tel})
    return launches, float(np.median(walls[1:])) * 1e3, one_process


def _state_digests(torch, engine):
    """A sha256 of every tensor of the engine's state (masters, moments,
    step, loss scaler), by checkpoint name: ``tools/zero_worker.py``'s
    ``record: digest``."""
    import hashlib

    from deepspeed_tpu_torch.runtime.checkpointing import _state_tensors

    return {n: hashlib.sha256(t.detach().cpu().reshape(-1).contiguous().view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for n, t in _state_tensors(engine).items()}


# ---------------------------------------------------------------------------
# resumable training: checkpoints, the resumable loader, prefetch, async saves
# ---------------------------------------------------------------------------

RESUME_ROWS = 96  # 6 global batches of 16 x 1024 tokens: one shuffled epoch


class _Recording:
    """A loader that keeps a copy of each batch it yields (the ids the
    engines consumed) and passes the resume cursor through."""

    def __init__(self, loader, key):
        self.loader, self.key, self.seen = loader, key, []

    def __iter__(self):
        return self._gen(iter(self.loader))

    def _gen(self, it):
        for batch in it:
            self.seen.append(np.array(batch[self.key]))
            yield batch

    def state_dict(self):
        return self.loader.state_dict()

    def load_state_dict(self, sd):
        self.loader.load_state_dict(sd)


def _run_steps(engine, feed, steps):
    """``steps`` train_batch calls over ``feed``: losses and the wall
    seconds of each step, the batch's wait included (the host read of the
    loss ends the step)."""
    losses, walls = [], []
    it = iter(feed)
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(next(it))))
        walls.append(time.perf_counter() - t0)
    it.close()  # stops a prefetcher's threads
    return losses, walls


def _optimizer_tensors(engine):
    st = engine.opt_state
    return [*engine._params, st.step, *st.exp_avg, *st.exp_avg_sq]


def _same_tensors(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _resume_run(torch, make, data, key, steps, cut, root, async_too):
    """Engine A: ``steps`` steps uninterrupted through
    ``DeepSpeedDataLoader`` -> ``prefetch_loader``; engine B: ``cut`` steps,
    a synchronous save (and with ``async_too`` an async save, a step taken
    while its commit runs, then the drain); engines C (and D) fresh, loading
    the sync (async) tag before their ``steps - cut`` steps.  Returns what
    the gates and the print need."""
    from deepspeed_tpu_torch.resilience import manager
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

    loader = lambda: _Recording(DeepSpeedDataLoader(data, batch_size=16, shuffle=True, seed=0),  # noqa: E731
                                key)
    out = {}
    a, rec_a = make(), loader()
    out["losses_a"], walls_a = _run_steps(a, a.prefetch_loader(rec_a), steps)
    out["step_ms_prefetch"] = [w * 1e3 for w in walls_a]
    out["data_wait_ms"] = a.timeline.summary()["data_wait_ms"]
    state_a = _optimizer_tensors(a)

    b, rec_b = make(), loader()
    out["losses_b"], _ = _run_steps(b, b.prefetch_loader(rec_b), cut)
    b.timeline.end_step()  # close the steps' record: the saves get their own
    t0 = time.perf_counter()
    tags = [b.save_checkpoint(os.path.join(root, "sync"), async_save=False)]
    out["sync_save_ms"] = (time.perf_counter() - t0) * 1e3
    b.timeline.end_step()
    out["sync_ckpt_stall_ms"] = b.timeline.summary(last_n=1)["ckpt_stall_ms"]
    if async_too:
        tags.append(b.save_checkpoint(os.path.join(root, "async"), async_save=True))
        b.timeline.end_step()
        out["async_ckpt_stall_ms"] = b.timeline.summary(last_n=1)["ckpt_stall_ms"]
        # a step while the commit runs: the masters and moments change in
        # place under it, so the async tag is the snapshot's only if the
        # snapshot was whole before save_checkpoint returned
        out["in_flight_during_step"] = b._async_writer.in_flight
        t0 = time.perf_counter()
        float(b.train_batch({k: v[:16] for k, v in data.items()}))
        out["step_ms_during_commit"] = (time.perf_counter() - t0) * 1e3
        pend = b._async_writer.drain()
        check(pend.ok, f"async save failed: {pend.error!r}")
        out["async_commit_ms"] = (pend.finished_at - pend.started_at) * 1e3
    del b
    sizes = [sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(t) for f in fs)
             for t in tags]
    out["tag_bytes"] = sizes[0]
    out["sync_save_gb_per_s"] = sizes[0] / out["sync_save_ms"] / 1e6
    digests = []
    for t in tags:
        ok, notes = manager.verify_tag(os.path.dirname(t), os.path.basename(t))
        check(ok, f"tag {t} does not verify: {notes}")
        with open(os.path.join(t, "manifest.json")) as f:
            digests.append(json.load(f)["files"]["state/state.pt"]["digest"])
    out["state_digests"] = digests

    out["resumed"] = {}
    for t in tags:
        c, rec_c = make(), loader()
        feed = c.prefetch_loader(rec_c)  # registered before the load: the cursor comes back
        t0 = time.perf_counter()
        path, _ = c.load_checkpoint(os.path.dirname(t))
        load_ms = (time.perf_counter() - t0) * 1e3
        losses, _ = _run_steps(c, feed, steps - cut)
        out["resumed"][os.path.basename(os.path.dirname(t))] = {
            "path": path, "load_ms": load_ms, "load_gb_per_s": out["tag_bytes"] / load_ms / 1e6,
            "losses": losses,
            "same_state": _same_tensors(torch, _optimizer_tensors(c), state_a),
            "same_batches": len(rec_c.seen) >= steps - cut and all(
                np.array_equal(x, y) for x, y in zip(rec_c.seen, rec_a.seen[cut:steps])),
            "global_steps": c.global_steps}
        del c
    out["b_batches_are_a_first"] = all(np.array_equal(x, y)
                                       for x, y in zip(rec_b.seen[:cut], rec_a.seen))
    del a, state_a
    torch.cuda.empty_cache()
    return out


def _resume_gates(label, out, steps, cut):
    want = out["losses_a"][cut:steps]
    check(all(np.isfinite(out["losses_a"])), f"{label}: non-finite loss {out['losses_a']}")
    check(out["losses_b"] == out["losses_a"][:cut],
          f"{label}: engine B's first steps {out['losses_b']} differ from A's {out['losses_a']}")
    check(out["b_batches_are_a_first"], f"{label}: engine B consumed other batches than A")
    for name, r in out["resumed"].items():
        check(r["losses"] == want,
              f"{label}: resumed from the {name} tag, losses {r['losses']} != A's {want}")
        check(r["same_state"], f"{label}: resumed from the {name} tag, masters or moments differ")
        check(r["same_batches"], f"{label}: resumed from the {name} tag, other batches than A's")
        check(r["global_steps"] == steps, f"{label}: {name} ends at step {r['global_steps']}")


def phase_train_resume_bf16(torch, params, train_step_ms):
    """GPT-2 124M, train_bf16's config, resumed from a sync and an async
    tag against 6 uninterrupted steps, bit for bit; and the same 6 steps
    fed without the prefetcher."""
    import tempfile
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    cfg = gpt2.PRESETS["gpt2"]
    mb, gas, steps, cut = 8, 2, 6, 3
    config = dict(_gpt2_bf16_config(mb, gas), overlap={"async_checkpoint": {"enabled": True}})
    model_fn = gpt2.make_model(cfg)[0]
    make = lambda: deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=params,  # noqa: E731
                                                  config=config)[0]
    data = {"input_ids": np.random.default_rng(13).integers(0, cfg.vocab_size, (RESUME_ROWS, 1024),
                                                            dtype=np.int32)}
    root = tempfile.mkdtemp()
    try:
        # -- the main path: counters zeroed just before, read just after ---
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = _resume_run(torch, make, data, "input_ids", steps, cut, root, async_too=True)
        e = make()
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

        plain, walls_e = _run_steps(e, DeepSpeedDataLoader(data, batch_size=16, shuffle=True,
                                                           seed=0), steps)
        launches = kernels.launches()
        variants = kernels.launch_variants()
        # ------------------------------------------------------------------
        del e
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    for name in ("flash_fwd", "flash_bwd", "fused_adam"):
        check(launches[name] > 0, f"train_resume_bf16: kernel {name} was not launched")
    for name in ("flash_fwd", "flash_bwd"):
        check(only_tc(variants[name]),
              f"train_resume_bf16: {name} ran {variants[name]}, not only the tensor-core body")
    _resume_gates("train_resume_bf16", out, steps, cut)
    check(plain == out["losses_a"],
          f"train_resume_bf16: losses without the prefetcher {plain} != with it {out['losses_a']}")
    check(out["state_digests"][0] == out["state_digests"][1],
          f"train_resume_bf16: the sync and async tags' state differ {out['state_digests']}")
    check(out["in_flight_during_step"], "train_resume_bf16: the async commit was not in flight")
    emit({"phase": "train_resume_bf16", "model": "gpt2", "micro_batch": mb, "gas": gas, "T": 1024,
          "steps": steps, "saved_after": cut, "dataset_rows": RESUME_ROWS,
          "losses": out["losses_a"], "losses_without_prefetch": plain,
          "resumed": out["resumed"], "state_digests": out["state_digests"],
          "tag_bytes": out["tag_bytes"], "sync_save_ms": out["sync_save_ms"],
          "sync_save_gb_per_s": out["sync_save_gb_per_s"],
          "sync_ckpt_stall_ms": out["sync_ckpt_stall_ms"],
          "async_ckpt_stall_ms": out["async_ckpt_stall_ms"],
          "async_commit_ms": out["async_commit_ms"],
          "step_ms_during_commit": out["step_ms_during_commit"],
          "step_ms_prefetch": out["step_ms_prefetch"],
          "step_ms_median_prefetch": float(np.median(out["step_ms_prefetch"][1:])),
          "data_wait_ms_mean_prefetch": out["data_wait_ms"],
          "step_ms_median_without_prefetch": float(np.median(walls_e[1:])) * 1e3,
          "step_ms_median_train_bf16": train_step_ms, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# ZeRO across ranks: the launcher environment, NCCL, stages 0-3 at world 1
# ---------------------------------------------------------------------------

def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_train_zero_bf16(torch, one_process, serve_tag):
    """``train_bf16``'s GPT-2 124M run (bf16 over f32 masters, micro 8 x
    gas 2 x T 1024, AdamW, WarmupDecayLR, clipping, remat, 4 steps on its
    batch) at ZeRO stages 0-3 on ``mesh: {data: 1, fsdp: 1}``, in a child
    process started under the launcher environment (world size 1) through
    ``tools/zero_worker.py``; first the collectives check on CUDA tensors
    through NCCL.  Gates: the NCCL backend; every stage's losses, masters,
    moments and scaler bit for bit those of stage 0 and of the one-process
    engine (train_bf16's); 0 bytes counted, as the models say; B1, B2 and
    B3 launched as in train_bf16, on the tensor-core bodies.  Returns the
    launches of the four stages' runs (the child zeroes the counts before
    each and reads them after) and what the same child ran for
    ``train_tp_seq_bf16`` (:data:`TP_SEQ_CASES`, the vocab-parallel ops'
    check), which that phase reads."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.ops import kernels

    mb, gas, T, steps = 8, 2, 1024, 4
    root = tempfile.mkdtemp()
    try:
        batches = os.path.join(root, "batches.npz")
        np.savez(batches, input_ids=np.repeat(one_process["batch"][None], steps, axis=0))
        cases = [{"name": f"stage{s}", "model": "gpt2", "preset": "gpt2", "init_seed": 0,
                  "config": dict(_gpt2_bf16_config(mb, gas), mesh={"data": 1, "fsdp": 1},
                                 zero_optimization={"stage": s}),
                  "batches": batches, "steps": steps, "record": "digest"} for s in range(4)]
        # train_tp_seq_bf16's part (b): vocab 50304 (model-divisible), mesh
        # {model: 1, seq: 1}, flash and the two sequence-parallel modes
        cases += [{"name": f"tp_seq_{mode}", "model": "gpt2", "preset": "gpt2", "init_seed": 0,
                   "model_cfg": {"vocab_size": TP_VOCAB, "attention_mode": mode},
                   "config": dict(_gpt2_bf16_config(mb, gas), mesh=TP_SEQ_MESH),
                   "batches": batches, "steps": steps, "record": "digest"}
                  for mode in TP_SEQ_CASES]
        # serve_tp_bf16's tag: the engine's initial state (init_params seed
        # 0, serve_bf16's weights), saved before any step
        cases.append({"name": "serve_tag", "model": "gpt2", "preset": "gpt2", "init_seed": 0,
                      "config": dict(_gpt2_bf16_config(mb, gas), mesh={"data": 1, "fsdp": 1}),
                      "batches": batches, "steps": 0, "record": "none",
                      "save": {"dir": serve_tag, "tag": "serve", "after": 0}})
        spec = os.path.join(root, "spec.json")
        with open(spec, "w") as f:
            json.dump({"device": "cuda", "deterministic": False, "threads": 4, "out": root,
                       "collectives_check": True, "tp_ops_check": True, "cases": cases}, f)
        env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.tools.zero_worker", spec],
                              env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
        wall_s = time.perf_counter() - t0
        check(proc.returncode == 0, "train_zero_bf16: the rank process failed "
              f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(root, "collectives.json")) as f:
            coll = json.load(f)
        stages = []
        for s in range(4):
            with open(os.path.join(root, f"stage{s}.json")) as f:
                stages.append(json.load(f))
        tp_seq = {}
        for mode in TP_SEQ_CASES:
            with open(os.path.join(root, f"tp_seq_{mode}.json")) as f:
                tp_seq[mode] = json.load(f)
        with open(os.path.join(root, "tp_ops.json")) as f:
            tp_seq["tp_ops"] = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    check(coll["backend"] == "nccl", f"train_zero_bf16: collectives ran on {coll['backend']}")
    bad = [r for r in coll["rows"] if not r["ok"]]
    check(coll["ok"] and not bad, f"train_zero_bf16: collectives check failed: {bad[:4]}")
    want = one_process["digests"]
    launches = {name: 0 for name in kernels.launches()}
    rows = {}
    for s, st in enumerate(stages):
        label = f"train_zero_bf16 stage {s}"
        check(st["backend"] == "nccl" and st["world_size"] == 1,
              f"{label}: backend {st['backend']}, world {st['world_size']}")
        check(st["losses"] == one_process["losses"],
              f"{label}: losses {st['losses']} != the one-process engine's {one_process['losses']}")
        differ = sorted(n for n in want if st["digests"].get(n) != want[n])
        check(set(st["digests"]) == set(want) and not differ,
              f"{label}: state differs from the one-process engine's in {differ[:6]}")
        check(st["digests"] == stages[0]["digests"], f"{label}: state differs from stage 0's")
        counted = sum(sum(c.values()) for c in st["comm"])
        check(counted == 0 and st["model"]["total"] == 0
              and st["extras"]["update-all-gather"] == 0,
              f"{label}: counted {st['comm']} bytes, model {st['model']} {st['extras']}")
        for name in ("flash_fwd", "flash_bwd", "fused_adam"):
            check(st["launches"][name] == one_process["launches"][name],
                  f"{label}: {name} launched {st['launches'][name]} times, "
                  f"train_bf16 {one_process['launches'][name]}")
        for name in ("flash_fwd", "flash_bwd"):
            check(only_tc(st["variants"][name]),
                  f"{label}: {name} ran {st['variants'][name]}, not only the tensor-core body")
        for name, n in st["launches"].items():
            launches[name] = launches.get(name, 0) + n
        rows[f"stage{s}"] = {"losses": st["losses"], "step_ms": st["ms"],
                             "step_ms_median_after_first": float(np.median(st["ms"][1:])),
                             "peak_gib": st["peak_bytes"] / 2**30,
                             "comm_bytes": st["comm"], "model": st["model"],
                             "extras": st["extras"], "launches": {
                                 n: st["launches"][n] for n in ("flash_fwd", "flash_bwd",
                                                                "fused_adam")}}
    emit({"phase": "train_zero_bf16", "model": "gpt2", "micro_batch": mb, "gas": gas, "T": T,
          "steps": steps, "mesh": {"data": 1, "fsdp": 1}, "backend": coll["backend"],
          "child_wall_s": wall_s, "collectives_rows": len(coll["rows"]),
          "collectives_max_err": max(r["max_err"] for r in coll["rows"]),
          "stages": rows, "step_ms_median_train_bf16": one_process["step_ms_median"],
          "peak_gib_train_bf16": one_process["peak_gib"],
          "same_bits_as_one_process": True})
    return launches, tp_seq


def phase_serve_tp_bf16(torch, serve_tag, served):
    """The tensor-parallel serving path at world size 1: a child process
    under the launcher environment runs ``tools/serve_worker.py`` over
    NCCL, ``init_serving(mp_size=1)`` (a ``model`` group of one) on GPT-2
    124M in bf16 with its parameters read through ``checkpoint=`` from the
    tag ``train_zero_bf16``'s child wrote (``init_params`` seed 0, the
    serving phases' weights).  Gates: the NCCL backend; the tokens of
    ``request_mix(seed=0)`` through the slot pool, of
    ``paged_request_mix(seed=0)`` through the paged pool and of
    ``serve_bf16``'s ``generate()`` bit for bit those of ``serve_bf16`` and
    ``serve_paged_bf16`` (``served``); 0 bytes counted; B1 (the prompt of
    ``generate()``, tc body), B4 and B5 launched (the child zeroes the
    counters before each drive and reads them after: ``serving_tp``); and
    an ``init_on_device`` engine's parameters of GPT-2 124M's shapes, bf16,
    finite.  Returns the launches."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.ops import kernels

    root = tempfile.mkdtemp()
    try:
        np.savez(os.path.join(root, "gen.npz"), input_ids=generate_ids())
        engine = {"model": "gpt2", "mp_size": 1, "dtype": "bfloat16", "max_out_tokens": 1024}
        cases = [
            {"name": "tp1", "engine": dict(engine, checkpoint=os.path.join(serve_tag, "serve")),
             "drives": [
                 {"kind": "serve", "serving": {"num_slots": 8, "prefill_chunk": 64},
                  "mix": "request", "mix_seed": 0},
                 {"kind": "serve", "serving": PAGED, "mix": "paged", "mix_seed": 0},
                 {"kind": "generate", "inputs": os.path.join(root, "gen.npz"),
                  "max_new_tokens": GEN_NEW},
                 {"kind": "tiers", "serving": {**TIER_SERVING, "kvcache": {
                     **TIER_SERVING["kvcache"], "tiers": TIER_KNOBS}},
                  "sessions": TIER_SESSIONS, "turns": TIER_TURNS, "seed": 0,
                  "new_tokens": TIER_TAIL[1], "max_new_tokens": TIER_NEW, "flush": True}]},
            {"name": "dev", "engine": dict(engine, init_on_device=True, seed=0),
             "drives": [{"kind": "shapes"}]},
        ]
        spec = os.path.join(root, "spec.json")
        with open(spec, "w") as f:
            json.dump({"device": "cuda", "deterministic": False, "threads": 4, "out": root,
                       "cases": cases}, f)
        env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.tools.serve_worker",
                               spec], env=env, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        wall_s = time.perf_counter() - t0
        check(proc.returncode == 0, "serve_tp_bf16: the rank process failed "
              f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(root, "tp1.r0.json")) as f:
            tp1 = json.load(f)
        with np.load(os.path.join(root, "tp1.r0.npz")) as z:
            gen = z["d2"]
        with open(os.path.join(root, "dev.r0.json")) as f:
            dev = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    slot, paged, gen_d, tiers = tp1["drives"]
    check(tp1["backend"] == "nccl" and tp1["world_size"] == 1 and tp1["mesh"]["model"] == 1,
          f"serve_tp_bf16: backend {tp1['backend']}, world {tp1['world_size']}, "
          f"mesh {tp1['mesh']}")
    for label, got, want in (("slot pool", slot["tokens"], served["slot"]),
                             ("paged pool", paged["tokens"], served["paged"]),
                             ("generate()", gen.tolist(), served["generate"])):
        differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        check(len(got) == len(want) and not differ,
              f"serve_tp_bf16 {label}: requests {differ[:8]} of {len(want)} differ from the "
              "one-process engine's tokens (bit for bit expected at a model group of one)")
    from deepspeed_tpu_torch.serving.engine import AGREE_KIND

    for d in tp1["drives"]:  # the tiers' agreements are the only collectives at one rank
        allowed = {AGREE_KIND} if d["kind"] == "tiers" else set()
        check(set(d["comm"]) <= allowed,
              f"serve_tp_bf16: {d['kind']} counted {d['comm']} bytes at one rank")
    turns = len(tiers["reference"])
    differ = [(t, s) for t in range(turns) for s in range(TIER_SESSIONS)
              if tiers["tokens"][t][s] != tiers["reference"][t][s]]
    check(not differ, f"serve_tp_bf16 tiers: turns {differ[:6]} of the tiered pool differ from "
                      "the all-device pool's (bit for bit expected)")
    tc = tiers["tier_counts"]
    check(tc["demote_t0_t1"] > 0 and tc["demote_t1_t2"] > 0
          and tc["hits_t1"] + tc["hits_t2"] + tc["promote_t2_t1"] > 0
          and tiers["comm"].get(AGREE_KIND, 0) > 0,
          f"serve_tp_bf16 tiers: {tc}, agreements {tiers['comm']}")
    check(tiers["launches"].get("flash_decode_paged", 0) > 0,
          f"serve_tp_bf16 tiers: {tiers['launches']}")
    launches = {name: 0 for name in kernels.launches()}
    for d in tp1["drives"]:
        for name, n in d["launches"].items():
            launches[name] = launches.get(name, 0) + n
    check(gen_d["launches"].get("flash_fwd", 0) > 0 and only_tc(gen_d["variants"]["flash_fwd"]),
          f"serve_tp_bf16: generate()'s prefill ran {gen_d['variants'].get('flash_fwd')}")
    check(slot["launches"].get("flash_decode", 0) > 0, f"serve_tp_bf16: slot {slot['launches']}")
    check(paged["launches"].get("flash_decode_paged", 0) > 0
          and not paged["launches"].get("flash_decode"),
          f"serve_tp_bf16: paged {paged['launches']}")
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime.engine import tree_items

    want = {p: list(spec.shape) for p, spec in tree_items(gpt2.param_specs(gpt2.PRESETS["gpt2"]))}
    shapes = dev["drives"][0]
    check(shapes["shapes"] == want and shapes["dtypes"] == ["torch.bfloat16"] and shapes["finite"],
          f"serve_tp_bf16: init_on_device parameters {shapes['dtypes']}, finite "
          f"{shapes['finite']}, shapes equal {shapes['shapes'] == want}")
    emit({"phase": "serve_tp_bf16", "mp_size": 1, "mesh": tp1["mesh"], "backend": tp1["backend"],
          "checkpoint": "serve", "child_wall_s": wall_s,
          "slot": {k: slot[k] for k in ("wall_s", "decode_tokens_per_s", "tokens_generated")},
          "paged": {k: paged[k] for k in ("wall_s", "decode_tokens_per_s", "tokens_generated")},
          "slot_ttft_ms_p50": _percentile(slot["ttft_ms"], 50),
          "paged_ttft_ms_p50": _percentile(paged["ttft_ms"], 50),
          "same_bits_as_one_process": True, "init_on_device_leaves": len(want),
          "tiers": {"sessions": TIER_SESSIONS, "turns": TIER_TURNS, "wall_s": tiers["wall_s"],
                    "tier_counts": tc, "moves": tiers["tier_moves"],
                    "agree_bytes": tiers["comm"].get(AGREE_KIND, 0),
                    "same_bits_as_all_device": True},
          "launches": {n: c for n, c in launches.items() if c}})
    return launches


# train_tp_seq_bf16: part (b)'s cases in train_zero_bf16's child (flash is
# the yardstick: at one seq rank ring and Ulysses fall back to it), GPT-2's
# vocabulary padded to a multiple of 64 (50257 is refused at a model axis
# of 2, as the JAX package refuses it), and part (a)'s virtual ring: P
# ranks in one process at GPT-2's training widths and T 8192 (the sparse
# slice's long sequence)
TP_SEQ_CASES = ("flash", "ring", "ulysses")
TP_SEQ_MESH = {"data": 1, "fsdp": 1, "model": 1, "seq": 1}
TP_VOCAB = 50304
RING_P, RING_SHAPE = 4, (1, 12, 8192, 64)
# the virtual ring's output against dense B1's, max-abs (an H100 reading at
# RING_SHAPE: 9.8e-4)
RING_VS_DENSE_TOL = 4e-3
# the ring's rms error against the float64 function, over each 16-row tile
# of each head, at most this many times dense B1's / B2's on the same tile:
# the ring rounds each block's output (its dq, dk, dv) to bf16 before the
# f32 merge (sum), about 1.2x dense's rms where rounding dominates; a tile
# of 16 rows keeps a wrong row visible (one row 10x the noise: ~2.7x)
RING_RMS_RATIO, RING_RMS_ROWS = 2.0, 16


def tile_rms_ratio(got, ref, exact, rows=RING_RMS_ROWS) -> float:
    """``max`` over (batch, head, ``rows``-row tile) of ``rms(got - exact)
    / rms(ref - exact)``: how far ``got`` strays from the float64 function
    ``exact``, tile by tile, beside another kernel ``ref`` on the same
    inputs.  A wrong share anywhere shows as a tile well above 1."""
    def tile_rms(x):
        d = (x.double() - exact)
        B, H, T, dd = d.shape
        return d.square().reshape(B, H, T // rows, rows * dd).mean(-1).sqrt()

    return float((tile_rms(got) / tile_rms(ref).clamp_min(1e-300)).max())


def _virtual_ring(torch, dev):
    """Part (a) of :func:`phase_train_tp_seq_bf16`: ``(row, launches)``,
    the counted pass's B1 and B2 launches."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa
    from deepspeed_tpu_torch.parallel import sequence as sq

    B, H, T, d = RING_SHAPE
    P = RING_P
    g = torch.Generator(device=dev).manual_seed(8192)
    q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5

    def ring_pass(plain=False):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = sq.ring_attention(*leaves, causal=True, ring=sq.VirtualRing(P), plain=plain)
        out.backward(do)
        return out.detach(), [t.grad for t in leaves]

    torch.cuda.synchronize()
    kernels.reset_launches()
    out, grads = ring_pass()
    torch.cuda.synchronize()
    launches = kernels.launches()
    variants = kernels.launch_variants()
    blocks = P * (P + 1) // 2
    check(launches["flash_fwd"] == blocks and launches["flash_bwd"] == blocks,
          f"train_tp_seq_bf16 ring: B1 {launches['flash_fwd']}, B2 {launches['flash_bwd']} "
          f"launches, {blocks} each expected")
    for name in ("flash_fwd", "flash_bwd"):
        check(only_tc(variants[name]), f"train_tp_seq_bf16 ring: {name} ran {variants[name]}")
    again = ring_pass()[1]
    check(all(bool(a.eq(b).all()) for a, b in zip(grads, again)),
          "train_tp_seq_bf16 ring: two backwards gave other bits")
    del again
    ring = sq.VirtualRing(P)

    def lse_delta(o, plain):
        """The merged lse and delta a ring's backward formed (its own
        forward's: the kernels' or the plain body's)."""
        _, lses = sq.ring_forward(ring.lanes(q), ring.lanes(k), ring.lanes(v), ring, True, scale,
                                  plain=plain)
        return ring.join(lses), (do.float() * o.float()).sum(-1)

    ring_lse, delta = lse_delta(out, False)
    dense, dense_lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
    dense_delta = (do.float() * dense.float()).sum(-1)
    dense_grads = fa.flash_bwd_cuda(q, k, v, do, dense_lse, dense_delta, True, scale)
    plain_out, plain_grads = ring_pass(plain=True)
    plain_lse, plain_delta = lse_delta(plain_out, True)
    torch.cuda.synchronize()
    out_err, lse_err = max_err(out, dense), max_err(ring_lse, dense_lse)
    check(out_err <= RING_VS_DENSE_TOL, f"train_tp_seq_bf16 ring: out {out_err} from dense B1")
    check(lse_err <= 1e-4, f"train_tp_seq_bf16 ring: lse {lse_err} from dense B1's")
    exact_out, exact_lse = fa.flash_fwd_float64(q, k, v, True, scale)
    f64 = _fwd_float64_fields(out, plain_out, (exact_out, exact_lse), "train_tp_seq_bf16 ring")
    # the gradients of the exact output: the ring's and dense B2's errors
    # beside each other, tile by tile, the output's first
    exact_grads = fa.flash_bwd_float64(q, k, v, do, exact_lse,
                                       (do.double() * exact_out).sum(-1), True, scale)[0]
    rms_ratio = {"out": tile_rms_ratio(out, dense, exact_out)}
    for grad, got, ref, x in zip(("dq", "dk", "dv"), grads, dense_grads, exact_grads):
        rms_ratio[grad] = tile_rms_ratio(got, ref, x)
    del exact_out, exact_lse, exact_grads
    for what, w in rms_ratio.items():
        check(w <= RING_RMS_RATIO, f"train_tp_seq_bf16 ring: the {what}'s error from the float64 "
                                   f"function is {w:.3g}x dense's in a {RING_RMS_ROWS}-row tile")
    # each ring against the float64 function of its own lse and delta;
    # for the record also against one pass's bound (B2's contract over the
    # whole sequence, without the ring's P roundings a row or column)
    over, over_single_pass = {}, {}
    for who, got, lse_, delta_ in (("ring", grads, ring_lse, delta),
                                   ("ring_plain", plain_grads, plain_lse, plain_delta)):
        over[who] = fa.float64_over_bound(
            got, sq.ring_bwd_float64(q, k, v, do, lse_, delta_, P, True, scale))
        over_single_pass[who] = fa.float64_over_bound(
            got, fa.flash_bwd_float64(q, k, v, do, lse_, delta_, True, scale))
    over["dense_b2"] = fa.float64_over_bound(
        dense_grads, fa.flash_bwd_float64(q, k, v, do, dense_lse, dense_delta, True, scale))
    for who, ratios in over.items():
        for grad, w in zip(("dq", "dk", "dv"), ratios):
            check(w <= 1.0, f"train_tp_seq_bf16 ring: the {who}'s {grad} is {w:.3g}x its "
                            "float64 bound")
    grad_errs = [max_err(a, b) for a, b in zip(grads, dense_grads)]

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def timed(fn, iters):  # a pass: clones of q, k, v, the forward and the backward
        return device_ms(torch, fn, flush, iters=iters, warmup=1)

    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(o, (ql, kl, vl), do)

    def dense_pass():  # dense B1 with its lse, delta, B2: the ring's work undivided
        o, lse_ = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
        fa.flash_bwd_cuda(q, k, v, do, lse_, (do.float() * o.float()).sum(-1), True, scale)

    def ring_fwd():
        sq.ring_forward(ring.lanes(q), ring.lanes(k), ring.lanes(v), ring, True, scale)

    # the bound of dense attention's forward and backward over the whole
    # sequence: q, k, v, out and dO, dq, dk, dv once each (bf16), lse and
    # delta (f32); the causal pairs' two forward and five backward dots
    pairs = T * (T + 1) / 2
    b_ms, b_by = bound_ms(11 * B * H * T * d * 2 + 3 * B * H * T * 4,
                          7 * 2 * d * pairs * B * H, "bfloat16")
    ring_row = {"B": B, "H": H, "T": T, "d": d, "P": P, "causal": True,
                "launches": {n: launches[n] for n in ("flash_fwd", "flash_bwd")},
                "out_max_err_vs_dense_b1": out_err, "out_tol_vs_dense_b1": RING_VS_DENSE_TOL,
                "lse_max_err_vs_dense_b1": lse_err, **f64,
                "tile_rms_ratio_vs_dense_out_dq_dk_dv": rms_ratio,
                "tile_rms_ratio_limit": RING_RMS_RATIO,
                "grad_max_err_vs_dense_b2_dq_dk_dv": grad_errs,
                "over_float64_bound_dq_dk_dv": over,
                "over_single_pass_float64_bound_dq_dk_dv": over_single_pass,
                "bitwise_repeatable": True,
                "fwd_bwd_ms": timed(ring_pass, 5),
                "dense_b1_b2_fwd_bwd_ms": timed(dense_pass, 5),
                "fwd_ms": timed(ring_fwd, 5),
                "dense_b1_fwd_ms": timed(
                    lambda: fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True), 5),
                "plain_fwd_bwd_ms": timed(lambda: ring_pass(plain=True), 2),
                "library_ms": timed(sdpa, 5), "bound_ms": b_ms, "bound_by": b_by}
    del q, k, v, do, out, grads, plain_out, plain_grads, dense_grads, ql, kl, vl, flush
    torch.cuda.empty_cache()

    return ring_row, launches


def phase_train_tp_seq_bf16(torch, dev, tp_seq):
    """Tensor and sequence parallelism on one card.  (a) Ring attention's
    schedule over ``RING_P`` virtual ranks (``parallel.sequence.VirtualRing``)
    at ``RING_SHAPE`` in bf16, causal, forward and backward through its
    autograd function: its blocks are B1 with its lse and B2 with the
    merged lse on the tensor-core bodies (P(P+1)/2 = 10 each way); the
    output within ``RING_VS_DENSE_TOL`` of dense B1 over the whole
    sequence and within the bf16 tolerance of the float64 function, the
    merged lse within 1e-4 of B1's; the output's and dq's, dk's and dv's
    error against the float64 function (the gradients' of the float64
    output's lse and delta, so an output error shows in them) at most
    ``RING_RMS_RATIO`` times dense B1's / B2's in every 16-row tile
    (:func:`tile_rms_ratio`); dq, dk and dv within the bound of the
    float64 function given the ring's own lse and delta
    (``parallel.sequence.ring_bwd_float64``: ``flash_bwd_float64`` on every
    block the ring runs, the blocks' bounds summed with the f32 sum's and
    the last rounding's), dense B2's within its own, and a second backward
    the same bits; the ring's plain body (the blocks' plain versions in
    the same schedule) beside it, its ms with dense B1 + B2's, the plain
    body's and SDPA's over the whole sequence.  (b) From ``train_zero_bf16``'s child (NCCL, world 1): GPT-2
    124M with vocab 50304 on ``mesh {model: 1, seq: 1}`` for 4 steps,
    ``ring`` and ``ulysses`` losses and state (sha256 each) bit for bit
    flash's; the vocab-parallel embedding and NLL over a group of one at
    GPT-2's widths against the plain embedding and ``token_nll``.  Returns
    the main path's launches: the counted virtual-ring pass and the child's
    ring and Ulysses runs (each zeroed before, read after)."""
    ring_row, launches = _virtual_ring(torch, dev)

    # (b): the child's runs at {model: 1, seq: 1}
    flash = tp_seq["flash"]
    for mode in ("ring", "ulysses"):
        run = tp_seq[mode]
        label = f"train_tp_seq_bf16 {mode}"
        check(run["backend"] == "nccl" and run["mesh"]["model"] == 1 and run["mesh"]["seq"] == 1,
              f"{label}: backend {run['backend']}, mesh {run['mesh']}")
        check(run["losses"] == flash["losses"],
              f"{label}: losses {run['losses']} != flash's {flash['losses']}")
        differ = sorted(n for n in flash["digests"] if run["digests"].get(n) != flash["digests"][n])
        check(set(run["digests"]) == set(flash["digests"]) and not differ,
              f"{label}: state differs from flash's in {differ[:6]}")
        check(all(np.isfinite(run["losses"])) and run["losses"][-1] < run["losses"][0],
              f"{label}: losses {run['losses']}")
        for name in ("flash_fwd", "flash_bwd"):
            check(run["launches"][name] == flash["launches"][name] > 0
                  and only_tc(run["variants"][name]),
                  f"{label}: {name} launched {run['launches'][name]} ({run['variants'][name]})")
        counted = sum(sum(c.values()) for c in run["comm"])
        check(counted == 0, f"{label}: {run['comm']} bytes counted at one rank")
    ops = tp_seq["tp_ops"]
    check(ops["ok"], f"train_tp_seq_bf16: vocab-parallel ops check failed: {ops['rows']}")
    for name, n in launches.items():
        launches[name] = n + sum(tp_seq[m]["launches"].get(name, 0) for m in ("ring", "ulysses"))
    emit({"phase": "train_tp_seq_bf16", "virtual_ring": ring_row,
          "gpt2": {m: {"vocab_size": TP_VOCAB, "mesh": tp_seq[m]["mesh"],
                       "losses": tp_seq[m]["losses"],
                       "step_ms_median_after_first": float(np.median(tp_seq[m]["ms"][1:])),
                       "peak_gib": tp_seq[m]["peak_bytes"] / 2**30}
                   for m in TP_SEQ_CASES},
          "same_bits_as_flash": True, "tp_ops": ops["rows"], "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phases 9 and 10: BERT-large pretraining with LAMB
# ---------------------------------------------------------------------------

def phase_train_bert_f32(torch, params):
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = bert.BERT_LARGE
    B, T, steps = 2, 512, 3
    config = {"train_micro_batch_size_per_gpu": B, "gradient_clipping": 1.0, "optimizer": BERT_LAMB}
    batch = synthetic_mlm_batch(cfg.vocab_size, B, T, seed=21)
    out = {}
    for name, c in (("kernels", cfg), ("plain_attention", dataclasses.replace(
            cfg, use_flash_attention=False))):
        kernels.reset_launches()
        engine, losses, walls = _train(torch, bert.make_model(c)[0], params, config, batch, steps)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": kernels.launches(), "variants": kernels.launch_variants()}
        del engine
        torch.cuda.empty_cache()
    kl, pl = out["kernels"]["launches"], out["plain_attention"]["launches"]
    check(kl["flash_fwd"] > 0 and kl["flash_bwd"] > 0 and pl["flash_bwd"] == 0,
          f"train_bert_f32: flash launches {kl} / {pl}")
    for name in ("flash_fwd", "flash_bwd"):
        check(out["kernels"]["variants"][name] == {"kbias/simt": kl[name]},
              f"train_bert_f32: {name} ran {out['kernels']['variants'][name]}")
    check(kl["fused_lamb_dir"] > 0 and kl["fused_lamb_apply"] > 0 and kl["fused_adam"] == 0,
          f"train_bert_f32: optimizer launches {kl}")
    k, p = out["kernels"]["losses"], out["plain_attention"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_bert_f32: non-finite loss {k} / {p}")
    check(max(rel) <= TRAIN_F32_LOSS_RTOL,
          f"train_bert_f32: kernel vs plain losses differ by {max(rel)} > {TRAIN_F32_LOSS_RTOL}")
    emit({"phase": "train_bert_f32", "model": "bert-large", "B": B, "T": T, "steps": steps,
          "keys_kept": batch["attention_mask"].sum(1).tolist(), "allow_tf32": False,
          "losses": out, "max_rel_diff": max(rel), "tol": TRAIN_F32_LOSS_RTOL})


def phase_train_bert_bf16(torch, params):
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = bert.BERT_LARGE
    mb, gas, T, steps = 8, 2, 512, 4
    config = {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": BERT_LAMB,
        # warmup_min_lr > 0: the log warmup's first step would otherwise run
        # at lr 0 and update nothing
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
            "warmup_max_lr": 2e-3}},
    }
    batch = synthetic_mlm_batch(cfg.vocab_size, mb * gas, T, seed=22)
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    engine, losses, walls = _train(torch, bert.make_model(cfg)[0], params, config, batch, steps)
    launches = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------

    for name in ("flash_fwd", "flash_bwd", "fused_lamb_dir", "fused_lamb_apply"):
        check(launches[name] > 0, f"kernel {name} was not launched on the BERT training main path")
    for name in ("flash_fwd", "flash_bwd"):
        check(variants[name] == {"kbias/tc": launches[name]},
              f"train_bert_bf16: {name} ran {variants[name]}, not only the tensor-core body")
    check(launches["fused_adam"] == 0, f"train_bert_bf16: fused_adam launched {launches}")
    check(all(np.isfinite(losses)), f"train_bert_bf16: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_bert_bf16: loss did not fall: {losses}")
    tokens = mb * gas * T
    step_s = float(sum(walls[1:])) / (steps - 1)
    # model FLOPs a step: 6 N per token for the weights (the tied decoder
    # included) and 12 L T d per token for non-causal attention, forward
    # and backward; remat's recompute is not counted.  Padded positions
    # are computed, so they count as tokens.
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    flops = tokens * (6 * cfg.num_params() + 12 * L * T * d)
    emit({"phase": "train_bert_bf16", "model": "bert-large", "optimizer": BERT_LAMB,
          "micro_batch": mb, "gas": gas, "T": T, "steps": steps,
          "real_tokens_per_step": int(batch["attention_mask"].sum()), "losses": losses,
          "step_ms": [w * 1e3 for w in walls], "step_ms_mean_after_first": step_s * 1e3,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "global_steps": engine.global_steps})
    del engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 11-13: BERT-large with its published dropout, the transformer layer
# ---------------------------------------------------------------------------

def _bert_drop_cfg(bert):
    """BERT-large as published: hidden and attention-probability dropout
    0.1 (google-research/bert's BERT-Large ``bert_config.json``)."""
    return dataclasses.replace(bert.BERT_LARGE, hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1)


def phase_train_bert_drop_f32(torch, params):
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = _bert_drop_cfg(bert)
    B, T, steps = 2, 512, 3
    config = {"train_micro_batch_size_per_gpu": B, "gradient_clipping": 1.0, "optimizer": BERT_LAMB}
    batch = synthetic_mlm_batch(cfg.vocab_size, B, T, seed=23)
    out = {}
    for name, c in (("kernels", cfg), ("plain_attention", dataclasses.replace(
            cfg, use_flash_attention=False))):
        kernels.reset_launches()
        engine, losses, walls = _train(torch, bert.make_model(c)[0], params, config, batch, steps)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": kernels.launches(), "variants": kernels.launch_variants()}
        del engine
        torch.cuda.empty_cache()
    kl, pl = out["kernels"], out["plain_attention"]
    for name in ("flash_fwd", "flash_bwd"):
        check(kl["launches"][name] > 0 and kl["variants"][name] == {
            "kbias+dropout/simt": kl["launches"][name]} and pl["launches"][name] == 0,
            f"train_bert_drop_f32: {name} launches {kl['variants'][name]} / {pl['launches'][name]}")
    k, p = kl["losses"], pl["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_bert_drop_f32: non-finite {k} / {p}")
    check(max(rel) <= TRAIN_DROP_F32_LOSS_RTOL,
          f"train_bert_drop_f32: kernel vs plain losses differ by {max(rel)} > "
          f"{TRAIN_DROP_F32_LOSS_RTOL}")
    emit({"phase": "train_bert_drop_f32", "model": "bert-large", "hidden_dropout": 0.1,
          "attention_dropout": 0.1, "B": B, "T": T, "steps": steps,
          "keys_kept": batch["attention_mask"].sum(1).tolist(), "allow_tf32": False,
          "losses": out, "max_rel_diff": max(rel), "tol": TRAIN_DROP_F32_LOSS_RTOL})


def phase_train_bert_drop_bf16(torch, params):
    """The main path of this slice: BERT-large with its published dropout,
    train_bert_bf16's phase-2 settings otherwise."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = _bert_drop_cfg(bert)
    mb, gas, T, steps = 8, 2, 512, 4
    config = {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": BERT_LAMB,
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
            "warmup_max_lr": 2e-3}},
    }
    batch = synthetic_mlm_batch(cfg.vocab_size, mb * gas, T, seed=22)
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    engine, losses, walls = _train(torch, bert.make_model(cfg)[0], params, config, batch, steps)
    launches = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------

    for name in ("flash_fwd", "flash_bwd", "fused_lamb_dir", "fused_lamb_apply"):
        check(launches[name] > 0, f"kernel {name} was not launched on the BERT dropout main path")
    for name in ("flash_fwd", "flash_bwd"):
        check(variants[name] == {"kbias+dropout/tc": launches[name]},
              f"train_bert_drop_bf16: {name} ran {variants[name]}, not all with bias and dropout "
              f"on the tensor-core body")
    for name in ("fused_adam", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 0, f"train_bert_drop_bf16: {name} launched {launches}")
    check(all(np.isfinite(losses)), f"train_bert_drop_bf16: non-finite loss {losses}")
    tokens = mb * gas * T
    step_s = float(sum(walls[1:])) / (steps - 1)
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    flops = tokens * (6 * cfg.num_params() + 12 * L * T * d)
    emit({"phase": "train_bert_drop_bf16", "model": "bert-large", "hidden_dropout": 0.1,
          "attention_dropout": 0.1, "optimizer": BERT_LAMB, "micro_batch": mb, "gas": gas,
          "T": T, "steps": steps, "real_tokens_per_step": int(batch["attention_mask"].sum()),
          "losses": losses, "step_ms": [w * 1e3 for w in walls],
          "step_ms_mean_after_first": step_s * 1e3, "tokens_per_step": tokens,
          "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "variants": variants, "global_steps": engine.global_steps})
    del engine
    torch.cuda.empty_cache()
    return launches


RESUME_BERT_LAYERS = 4


def phase_train_resume_bert_drop_bf16(torch):
    """BERT-large at full width with its published dropout, LAMB and
    train_bert_drop_bf16's batch, depth cut to 4 layers: 2 steps, a save,
    a fresh engine's load and 2 steps against 4 uninterrupted steps, bit
    for bit (the gate on the micro-step generator and the Threefry keys
    resuming)."""
    import tempfile
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = dataclasses.replace(_bert_drop_cfg(bert), num_hidden_layers=RESUME_BERT_LAYERS)
    params = bert.init_params(cfg, seed=0)
    mb, gas, T, steps, cut = 8, 2, 512, 4, 2
    config = {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": BERT_LAMB,
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
            "warmup_max_lr": 2e-3}},
    }
    model_fn = bert.make_model(cfg)[0]
    make = lambda: deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=params,  # noqa: E731
                                                  config=config)[0]
    data = synthetic_mlm_batch(cfg.vocab_size, steps * mb * gas, T, seed=22)
    root = tempfile.mkdtemp()
    try:
        # -- the main path: counters zeroed just before, read just after ---
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = _resume_run(torch, make, data, "input_ids", steps, cut, root, async_too=False)
        launches = kernels.launches()
        variants = kernels.launch_variants()
        # ------------------------------------------------------------------
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("flash_fwd", "flash_bwd", "fused_lamb_dir", "fused_lamb_apply"):
        check(launches[name] > 0, f"train_resume_bert_drop_bf16: kernel {name} was not launched")
    for name in ("flash_fwd", "flash_bwd"):
        check(variants[name] == {"kbias+dropout/tc": launches[name]},
              f"train_resume_bert_drop_bf16: {name} ran {variants[name]}")
    _resume_gates("train_resume_bert_drop_bf16", out, steps, cut)
    emit({"phase": "train_resume_bert_drop_bf16", "model": "bert-large",
          "reduced": {"n_layer": f"{bert.BERT_LARGE.num_hidden_layers} -> {RESUME_BERT_LAYERS}"},
          "hidden_dropout": 0.1, "attention_dropout": 0.1, "optimizer": BERT_LAMB,
          "micro_batch": mb, "gas": gas, "T": T, "steps": steps, "saved_after": cut,
          "losses": out["losses_a"], "resumed": out["resumed"], "tag_bytes": out["tag_bytes"],
          "sync_save_ms": out["sync_save_ms"], "sync_save_gb_per_s": out["sync_save_gb_per_s"],
          "step_ms_prefetch": out["step_ms_prefetch"],
          "data_wait_ms_mean_prefetch": out["data_wait_ms"], "launches": launches})
    torch.cuda.empty_cache()
    return launches


def _layer_stack(torch, cfg, n, dev):
    from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerLayer

    return [DeepSpeedTransformerLayer(cfg, seed=i, device=dev) for i in range(n)]


def _run_stack(torch, layers, x, mask, seed, w):
    """Forward through ``layers`` with per-layer seeds drawn from a CPU
    generator seeded ``seed``, then the backward of ``sum(out * w)``.
    Returns the output and the input's gradient."""
    from deepspeed_tpu_torch.ops.transformer.transformer import draw_seeds

    gen = torch.Generator().manual_seed(seed)
    x = x.detach().clone().requires_grad_()
    h = x
    for layer in layers:
        h = layer(h, attention_mask=mask, rng=draw_seeds(gen), training=True)
    (h.float() * w).sum().backward()
    return h.detach(), x.grad


def phase_transformer_layer(torch, dev):
    """DeepSpeedTransformerLayer at BERT-large width (d 1024, 16 heads of
    64, FFN 4096, pre-LN, dropout 0.1 and 0.1, the op's defaults): 24
    layers in bf16 at B 8, T 512, forward and backward, with a (B, T) mask
    (B1/B2 with the key-row bias) and with a (B, 1, T, T) seq2seq mask (the
    full bias); the same in f32 at B 2 against plain attention on the same
    seeds; and the 24-layer stack at B 1, T 9216 with a (B, T) mask keeping
    8,000 positions, whose backward is the two-pass B6a/B6b on their
    tensor-core bodies (24 launches each), timed as the median of three
    passes after a warm one."""
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerConfig
    from deepspeed_tpu_torch.tools.profile_training import seq2seq_mask

    cfg = DeepSpeedTransformerConfig(
        batch_size=8, hidden_size=1024, intermediate_size=4096, heads=16, attn_dropout_ratio=0.1,
        hidden_dropout_ratio=0.1, num_hidden_layers=24, pre_layer_norm=True,
        dtype=torch.bfloat16)
    L, B, T, D = 24, 8, 512, 1024
    layers = _layer_stack(torch, cfg, L, dev)
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(B, T, D, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(B, T, D, generator=g, device=dev)
    keep = torch.tensor([BIAS_KEEP[b % 4] for b in range(B)], device=dev)
    mask2 = (torch.arange(T, device=dev)[None, :] < keep[:, None]).long()
    kb = torch.where(mask2.bool(), 0.0, -1e9)
    mask4 = seq2seq_mask(kb, T)
    runs, launches = {}, {}
    total = {name: 0 for name in kernels.launches()}
    want = {"2d": "kbias+dropout/tc", "4d": "fbias+dropout/tc"}
    # one untimed pass of each form first (cuBLAS plans, the allocator):
    # the first timed pass read 413 ms against the second form's 139 ms
    for mask in (mask2, mask4):
        _run_stack(torch, layers, x, mask, 4, w)
    for form, mask in (("2d", mask2), ("4d", mask4)):
        for layer in layers:
            layer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        # -- the main path: counters zeroed just before, read just after ---
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, dx = _run_stack(torch, layers, x, mask, 5, w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[form] = kernels.launches()
        variants = kernels.launch_variants()
        # ------------------------------------------------------------------
        for name in ("flash_fwd", "flash_bwd"):
            check(variants[name] == {want[form]: L},
                  f"transformer_layer {form}: {name} ran {variants[name]}, want {L} {want[form]}")
        check(launches[form]["flash_bwd_dq"] == 0 and launches[form]["flash_bwd_dkv"] == 0,
              f"transformer_layer {form}: two-pass backward launched {launches[form]}")
        check(out.isfinite().all().item() and dx.isfinite().all().item(),
              f"transformer_layer {form}: non-finite output or gradient")
        for name, n in launches[form].items():
            total[name] += n
        # two more passes, after the counts were read: one pass's host
        # time moves with the host (a garbage collection, a slower core)
        passes = [wall * 1e3]
        for seed in (8, 9):
            for layer in layers:
                layer.zero_grad(set_to_none=True)
            t0 = time.perf_counter()
            _run_stack(torch, layers, x, mask, seed, w)
            torch.cuda.synchronize()
            passes.append((time.perf_counter() - t0) * 1e3)
        runs[form] = {"wall_ms": wall * 1e3, "passes_ms": passes,
                      "median_ms": sorted(passes)[1], "launches": launches[form],
                      "variants": variants, "out_rms": float(out.float().square().mean().sqrt())}
    del layers, x, w, out, dx
    torch.cuda.empty_cache()

    # -- f32 at B 2: the kernels against plain attention, the same seeds -----
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    layers = _layer_stack(torch, f32, L, dev)
    x = torch.randn(2, T, D, generator=g, device=dev)
    w = torch.randn(2, T, D, generator=g, device=dev)
    f32_err = {}
    for form, mask in (("2d", mask2[:2]), ("4d", mask4[:2])):
        res = {}
        for label, use_flash in (("kernels", True), ("plain", False)):
            for layer in layers:
                layer.config = dataclasses.replace(f32, use_flash_attention=use_flash)
                layer.zero_grad(set_to_none=True)
            res[label] = _run_stack(torch, layers, x, mask, 6, w)
        errs = [max_err(a, b) / float(b.abs().max()) for a, b in zip(res["kernels"], res["plain"])]
        check(max(errs) <= LAYER_F32_RTOL,
              f"transformer_layer f32 {form}: kernels vs plain attention differ by {errs} of the "
              f"largest entries > {LAYER_F32_RTOL}")
        f32_err[form] = {"out": errs[0], "dx": errs[1]}
    del layers, x, w, res
    torch.cuda.empty_cache()

    # -- the 24-layer stack at T 9216: the two-pass backward ---------------------
    layers = _layer_stack(torch, dataclasses.replace(cfg, batch_size=1), L, dev)
    x = torch.randn(1, LONG_T, D, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(1, LONG_T, D, generator=g, device=dev)
    mask = (torch.arange(LONG_T, device=dev) < LONG_KEEP).long()[None]
    torch.cuda.reset_peak_memory_stats()
    _run_stack(torch, layers, x, mask, 7, w)  # warm: the allocator, cuBLAS plans
    for layer in layers:
        layer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    # -- the main path: counters zeroed just before, read just after -------
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, dx = _run_stack(torch, layers, x, mask, 8, w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["long"] = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------
    check(launches["long"]["flash_bwd_dq"] == L and launches["long"]["flash_bwd_dkv"] == L
          and launches["long"]["flash_bwd"] == 0 and launches["long"]["flash_fwd"] == L,
          f"transformer_layer T={LONG_T}: launches {launches['long']}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(variants[name] == {"kbias+dropout/tc": L},
              f"transformer_layer T={LONG_T}: {name} ran {variants[name]}, want {L} "
              f"kbias+dropout/tc")
    check(out.isfinite().all().item() and dx.isfinite().all().item(),
          f"transformer_layer T={LONG_T}: non-finite output or gradient")
    for name, n in launches["long"].items():
        total[name] += n
    passes = [wall * 1e3]
    for seed in (10, 11):
        for layer in layers:
            layer.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        _run_stack(torch, layers, x, mask, seed, w)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) * 1e3)
    runs["long"] = {"layers": L, "B": 1, "T": LONG_T, "keys_kept": LONG_KEEP,
                    "wall_ms": wall * 1e3, "passes_ms": passes, "median_ms": sorted(passes)[1],
                    "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": launches["long"], "variants": variants}
    emit({"phase": "transformer_layer", "layers": L, "d": D, "heads": 16, "ffn": 4096,
          "pre_ln": True, "attn_dropout": 0.1, "hidden_dropout": 0.1, "B": B, "T": T,
          "dtype": "bfloat16", "runs": runs, "f32_B2_rel_err": f32_err, "f32_tol": LAYER_F32_RTOL})
    del layers, x, w, out, dx
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phases 14 and 15: block-sparse GPT-2 training at T 8192 and 16384
# ---------------------------------------------------------------------------

# the JAX package's long-context recipe (tools/bench_long_context.py):
# Adam at lr 1e-4, remat per block, cross-entropy in chunks of 512
def _sparse_cfg(T, mode="sparse"):
    from deepspeed_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.PRESETS["gpt2"], n_positions=T, n_layer=SPARSE_LAYERS,
                               attention_mode=mode, xent_chunk_size=512)


def phase_train_sparse_f32(torch):
    """train_sparse_f32: the sparse GPT-2 (124M width, 8 layers, T 8192, B
    1) in f32, 3 steps, TF32 off, through the splash kernels against the
    same steps with the sparse op on the gather path; per-step losses
    within TRAIN_F32_LOSS_RTOL."""
    import functools

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.attention import sparse as sp
    from deepspeed_tpu_torch.tools.profile_training import LONG_ADAM

    T = SPARSE_TS[0]
    cfg = _sparse_cfg(T)
    params = gpt2.init_params(cfg, seed=0)
    config = {"train_micro_batch_size_per_gpu": 1, "optimizer": LONG_ADAM}
    batch = {"input_ids": np.random.default_rng(13).integers(0, cfg.vocab_size, (1, T),
                                                             dtype=np.int32)}
    out = {}
    for name in ("kernels", "gather"):
        if name == "gather":  # the sparse op's plain route, for this run only
            gpt2.block_sparse_attention = functools.partial(sp.block_sparse_attention,
                                                            backend="gather")
        try:
            kernels.reset_launches()
            engine, losses, walls = _train(torch, gpt2.make_model(cfg)[0], params, config,
                                           batch, 3)
            out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                         "launches": kernels.launches(), "variants": kernels.launch_variants()}
        finally:
            gpt2.block_sparse_attention = sp.block_sparse_attention
        del engine
        torch.cuda.empty_cache()
    kl, gl = out["kernels"]["launches"], out["gather"]["launches"]
    check(kl["splash_fwd"] > 0 and kl["splash_bwd_dq"] > 0 and kl["splash_bwd_dkv"] > 0
          and gl["splash_fwd"] == 0, f"train_sparse_f32: splash launches {kl} / {gl}")
    for name in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):  # the CUDA-core bodies only
        ran = out["kernels"]["variants"][name]
        check(ran == {"none/simt": kl[name]}, f"train_sparse_f32: {name} ran {ran}")
    k, p = out["kernels"]["losses"], out["gather"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_sparse_f32: non-finite loss {k} / {p}")
    check(max(rel) <= TRAIN_F32_LOSS_RTOL,
          f"train_sparse_f32: kernel vs gather losses differ by {max(rel)} > {TRAIN_F32_LOSS_RTOL}")
    emit({"phase": "train_sparse_f32", "layers": SPARSE_LAYERS, "B": 1, "T": T, "steps": 3,
          "allow_tf32": False, "losses": out, "max_rel_diff": max(rel),
          "tol": TRAIN_F32_LOSS_RTOL})


def phase_train_sparse_bf16(torch):
    """train_sparse_bf16, this slice's main path: the sparse GPT-2 in bf16
    over f32 masters at T 8192 and 16384 (8 layers, B 1, Adam, remat,
    cross-entropy chunks of 512), 4 steps on one batch, beside the dense
    flash path at the same T and depth.  Counters zeroed just before each
    sparse run and read just after: per micro-step B8 16 launches (the
    forward and remat's recompute), B9a and B9b 8 each, all on their
    tensor-core bodies (``none/tc``), fused Adam launched, B1/B2 not;
    losses finite and falling.  Each step's garbage
    collector pauses and allocator calls are kept (``_train``'s probe), and
    tokens/s is given from the mean and the median of the steps after the
    first.  Model FLOPs a step:
    6 N a token for the weights, and 12 d for each score of each head and
    layer that the attention computes (4 d forward, 8 d backward; dense
    causal: T (T + 1) / 2 scores a head), recompute not counted."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import LONG_ADAM

    config = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True},
              "optimizer": LONG_ADAM}
    steps = 4
    total = None
    runs = {}
    for T in SPARSE_TS:
        batch = {"input_ids": np.random.default_rng(14).integers(0, 50257, (1, T),
                                                                 dtype=np.int32)}
        for mode in ("sparse", "flash"):
            cfg = _sparse_cfg(T, mode)
            params = gpt2.init_params(cfg, seed=0)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            # -- the main path (sparse): counters zeroed just before --------
            kernels.reset_launches()
            probe = []
            engine, losses, walls = _train(torch, gpt2.make_model(cfg)[0], params, config,
                                           batch, steps, probe)
            launches = kernels.launches()
            variants = kernels.launch_variants()
            # ----------------------------------------------------------------
            del params
            check(all(np.isfinite(losses)), f"train_sparse_bf16 T={T} {mode}: non-finite loss {losses}")
            check(losses[-1] < losses[0], f"train_sparse_bf16 T={T} {mode}: loss did not fall {losses}")
            H, d = cfg.n_head, cfg.head_dim
            if mode == "sparse":
                layout, block = gpt2.sparse_layout(cfg, T)
                scores = _splash_work(layout, block)
                want = {"splash_fwd": 2 * SPARSE_LAYERS * steps,
                        "splash_bwd_dq": SPARSE_LAYERS * steps,
                        "splash_bwd_dkv": SPARSE_LAYERS * steps}
                got = {n: launches[n] for n in want}
                check(got == want, f"train_sparse_bf16 T={T}: splash launches {got}, want {want}")
                for name in want:  # the tensor-core bodies only
                    check(variants[name] == {"none/tc": want[name]},
                          f"train_sparse_bf16 T={T}: {name} ran {variants[name]}")
                check(launches["fused_adam"] > 0 and launches["flash_fwd"] == 0
                      and launches["flash_bwd"] == 0,
                      f"train_sparse_bf16 T={T}: launches {launches}")
                total = launches if total is None else {n: total[n] + launches[n] for n in total}
            else:
                scores = H * T * (T + 1) // 2
                check(launches["flash_fwd"] > 0 and launches["splash_fwd"] == 0,
                      f"train_sparse_bf16 T={T} dense: launches {launches}")
            step_s = float(sum(walls[1:])) / (steps - 1)
            median_s = float(np.median(walls[1:]))
            flops = 6 * cfg.num_params() * T + 12 * d * scores * SPARSE_LAYERS
            runs[(T, mode)] = {
                "losses": losses, "step_ms": [w * 1e3 for w in walls], "host_per_step": probe,
                "step_ms_mean_after_first": step_s * 1e3, "tokens_per_s": T / step_s,
                "step_ms_median_after_first": median_s * 1e3,
                "tokens_per_s_median": T / median_s,
                "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                "attention_scores_per_layer": scores, "model_flops_per_step": flops,
                "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
                "launches": {n: c for n, c in launches.items() if c},
                "variants": {n: v for n, v in variants.items() if v},
                "global_steps": engine.global_steps}
            del engine
            torch.cuda.empty_cache()
        sp_run, dn_run = runs[(T, "sparse")], runs[(T, "flash")]
        emit({"phase": "train_sparse_bf16", "layers": SPARSE_LAYERS, "B": 1, "T": T,
              "steps": steps, "optimizer": LONG_ADAM, "xent_chunk_size": 512, "remat": True,
              "layout": "bigbird-uni, block %d" % gpt2.sparse_layout(_sparse_cfg(T), T)[1],
              "sparse": sp_run, "dense_flash": dn_run,
              "sparse_over_dense_tokens_per_s": sp_run["tokens_per_s"] / dn_run["tokens_per_s"],
              "sparse_over_dense_median": sp_run["tokens_per_s_median"]
              / dn_run["tokens_per_s_median"]})
    return total, runs[(SPARSE_TS[0], "sparse")]["losses"]


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# train_moe_bf16, serve_moe_bf16, train_pipe_bf16: MoE and the pipeline
# ---------------------------------------------------------------------------

# GPT-2 124M's widths with every FFN an 8-expert top-2 MoE layer (the JAX
# package's MoE defaults: capacity factor 1.25 in training, 2.0 in eval,
# aux weight 0.01), ~522M parameters
MOE_CFG = {"n_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 1.25, "moe_aux_weight": 0.01}
# kernel vs plain-attention losses of the bf16 MoE step (relative): the two
# round attention to bf16 at different points, and routing is not
# continuous (a token whose scores tie flips its expert), averaged over
# the step's 8,192 tokens; the card read 0.34 % at the fourth step
MOE_BF16_LOSS_RTOL = 5e-3
# moe_ffn (rows moved by index) against the JAX package's dense einsum form
# (dense_moe_ffn), both f32 on the card with TF32 off: the same products
# summed in another order (the card read 1.3e-7 to 7.2e-7)
MOE_FFN_RTOL = 1e-5
# the MoE engine's prefill logits against models/gpt2.apply over the same
# bf16 weights, in bf16 spacings at the largest |logit| (the card read
# the same bits at every position of the 8 prompts)
MOE_PREFILL_SPACINGS = 1.0
MOE_SLOT = {"num_slots": 8, "prefill_chunk": 64, "max_len": 1024}
MOE_PAGED = {**MOE_SLOT, "kvcache": {"enabled": True, "page_len": 128}}
# pipelined GPT-2 124M (two stage processes sharing the card, gloo
# between them) vs the same module at one stage in one process, bf16
# (relative), on one batch repeated: the same kernels on the same
# micro-batches, but the tied embedding's two gradients (the lookup's and
# the head's) are summed in f32 across the stages where one stage's
# autograd sums them in bf16.  Each limit is five to ten times the card's
# reading: losses 9.0e-6 ...
PIPE_BF16_LOSS_RTOL = 1e-4
# ... each leaf's gradient norm (a block's leaves block by block) at the
# first step (the same parameters; 4.4e-6, the tied embedding's) and at
# the later ones (the first update's differences carried through bf16;
# 9.8e-4) ...
PIPE_BF16_GRAD0_RTOL = 5e-5
PIPE_BF16_GRAD_RTOL = 1e-2
# ... and each leaf's (block's) change over the first step, |P_pipe -
# P_seq| / |P_seq - P_init|, in norm (9.8e-3, the tied embedding's: Adam
# turns an entry whose two halves nearly cancel into a whole step of
# either sign).  Without the stages' gradient sum every one of these
# reads about 1.
PIPE_BF16_PARAM_RTOL = 5e-2


def _moe_cfg():
    from deepspeed_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.PRESETS["gpt2"], **MOE_CFG)


def dense_moe_ffn(p, x, cfg, training):
    """The JAX package's ``moe_ffn`` (``deepspeed_tpu/moe/layer.py:151``)
    in its dense form: ``top_k_gating``'s (T, E, C) dispatch and combine
    contracted with the tokens and the expert rows by einsum."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.moe import layer as moe

    B, T, D = x.shape
    factor = cfg.capacity_factor if training else cfg.eval_capacity_factor
    C = moe._capacity(B * T, cfg.num_experts, factor, cfg.min_capacity)
    xt = x.reshape(B * T, D)
    dispatch, combine, aux = moe.top_k_gating(xt.float() @ p["gate_w"].float(), cfg.top_k, C)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    h = F.gelu(expert_in @ p["w1"] + p["b1"][:, None], approximate="tanh")
    out = (h @ p["w2"] + p["b2"][:, None]).float()
    return torch.einsum("tec,ecd->td", combine, out).reshape(B, T, D).to(x.dtype), aux


def moe_ffn_vs_dense(torch, leaves, shape, training, dev, seed=0):
    """The port's ``moe_ffn`` (rows moved by index) against
    :func:`dense_moe_ffn` on one block's MoE ``leaves``, f32 on ``dev``,
    random tokens of ``shape`` (B, T): the output, aux and the gradients
    of ``sum(y * r) + aux`` for ``x`` and every leaf, each as max |a - b|
    over max |b|; and whether the routing on ``dev`` equals the host's
    routing of the same logits."""
    from deepspeed_tpu_torch.moe import layer as moe

    E, D, Fd = np.asarray(leaves["w1"]).shape
    cfg = moe.MoEConfig(num_experts=E, d_model=D, d_ff=Fd, top_k=MOE_CFG["moe_top_k"],
                        capacity_factor=MOE_CFG["moe_capacity_factor"])
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((*shape, D), generator=g, device=dev)
    r = torch.randn((*shape, D), generator=g, device=dev)

    def run(fn):
        p = {k: torch.tensor(np.asarray(leaves[k]), device=dev, requires_grad=True)
             for k in moe.MOE_PARAM_KEYS}
        xi = x.clone().requires_grad_(True)
        y, aux = fn(p, xi)
        ((y.float() * r).sum() + aux).backward()
        return [y.detach(), aux.detach(), xi.grad] + [p[k].grad for k in moe.MOE_PARAM_KEYS]

    got = run(lambda p, xi: moe.moe_ffn(p, xi, cfg, training=training))
    want = run(lambda p, xi: dense_moe_ffn(p, xi, cfg, training))
    names = ["y", "aux", "dx"] + [f"d{k}" for k in moe.MOE_PARAM_KEYS]
    err = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for n, a, b in zip(names, got, want)}
    with torch.no_grad():
        logits = x.reshape(-1, D) @ torch.tensor(np.asarray(leaves["gate_w"]), device=dev)
    C = moe._capacity(logits.shape[0], E, cfg.capacity_factor if training
                      else cfg.eval_capacity_factor, cfg.min_capacity)
    here, host = moe.route(logits, cfg.top_k, C), moe.route(logits.cpu(), cfg.top_k, C)
    return {"shape": list(shape), "training": training, "capacity": C,
            "dropped": int((here.routed[None] & ~here.kept).sum()),
            "routing_equals_host": all(torch.equal(a.cpu(), b) for a, b in
                                       zip(here[:3], host[:3])),
            "max_rel_err": max(err.values()), "worst": max(err, key=err.get)}


def check_moe_witness(phase, w):
    check(w["routing_equals_host"], f"{phase}: moe_ffn's routing at {w['shape']} on the card "
                                    "differs from the host's")
    check(w["max_rel_err"] <= MOE_FFN_RTOL,
          f"{phase}: moe_ffn at {w['shape']} differs from the dense form by "
          f"{w['max_rel_err']} ({w['worst']}) > {MOE_FFN_RTOL}")


def _device_tree(torch, tree, dtype, dev):
    if isinstance(tree, dict):
        return {k: _device_tree(torch, v, dtype, dev) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).to(dev, dtype)


def prefill_vs_apply(torch, eng, params, cfg, prompts, dev):
    """The inference engine's prefill logits (``ops/transformer/inference.py``)
    against ``models/gpt2.apply``'s eval forward over the same weights
    (``params``, the training tree) for each prompt, every position: the
    largest |difference| in bf16 spacings at the prompt's largest |logit|
    (:func:`near_tie_tol`'s unit), and the share of positions whose
    argmax agrees.  Both route the whole prompt at the eval capacity."""
    from deepspeed_tpu_torch.models import gpt2

    out = []
    with torch.inference_mode():
        for p in prompts:
            ids = np.asarray(p)[None].astype(np.int64)
            got = eng.prefill(ids, *eng.init_cache(1, ids.shape[1]))[0].float()
            ids = torch.as_tensor(ids, device=dev)
            want = gpt2.apply(params, ids, cfg).float()
            unit = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
            out.append({"T": int(ids.shape[1]),
                        "max_abs_diff": float((got - want).abs().max()),
                        "spacings": float((got - want).abs().max()) / float(unit),
                        "argmax_agrees": float((got.argmax(-1) == want.argmax(-1))
                                               .double().mean())})
    return out


def phase_train_moe_bf16(torch, moe_params):
    """GPT-2-MoE (124M widths, 8 experts, top-2) in bf16 over f32 masters,
    micro 8 x T 1024, AdamW, through ``initialize`` → ``train_batch``, 4
    steps: the main path (counters zeroed just before, read just after:
    B1, B2, B3 launched), then the same steps with plain attention; losses
    finite and falling, the kernel run within MOE_BF16_LOSS_RTOL of the
    plain one; one block's ``moe_ffn`` at the step's shape, values and
    gradients, within MOE_FFN_RTOL of the dense form (:func:`moe_ffn_vs_dense`).
    Prints ms a step, tokens/s, peak GiB and the share of routed
    assignments dropped past capacity."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.moe import layer as moe
    from deepspeed_tpu_torch.ops import kernels

    cfg = _moe_cfg()
    mb, gas, T, steps = 8, 1, 1024, 4
    config = _gpt2_bf16_config(mb, gas)
    batch = {"input_ids": np.random.default_rng(21).integers(0, cfg.vocab_size, (mb * gas, T),
                                                             dtype=np.int32)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: counters zeroed just before, read just after -------
    kernels.reset_launches()
    with moe.record_drops() as rec:
        engine, losses, walls = _train(torch, gpt2.make_model(cfg)[0], moe_params, config,
                                       batch, steps)
    launches = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------
    drops = rec.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del engine
    torch.cuda.empty_cache()
    kernels.reset_launches()
    plain_engine, plain, _ = _train(torch, gpt2.make_model(dataclasses.replace(
        cfg, use_flash_attention=False))[0], moe_params, config, batch, steps)
    plain_launches = kernels.launches()
    del plain_engine
    torch.cuda.empty_cache()
    # a second witness: the layer itself against the JAX package's dense form
    witness = moe_ffn_vs_dense(torch, {k: moe_params["blocks"][k][0] for k in moe.MOE_PARAM_KEYS},
                               (mb, T), True, "cuda")
    check_moe_witness("train_moe_bf16", witness)
    for name in ("flash_fwd", "flash_bwd", "fused_adam"):
        check(launches[name] > 0, f"train_moe_bf16: kernel {name} was not launched")
    for name in ("flash_fwd", "flash_bwd"):
        check(only_tc(variants[name]), f"train_moe_bf16: {name} ran {variants[name]}")
        check(plain_launches[name] == 0, f"train_moe_bf16: plain run launched {name}")
    check(all(np.isfinite(losses)) and all(np.isfinite(plain)),
          f"train_moe_bf16: non-finite loss {losses} / {plain}")
    check(losses[-1] < losses[0], f"train_moe_bf16: loss did not fall: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    check(max(rel) <= MOE_BF16_LOSS_RTOL,
          f"train_moe_bf16: kernel vs plain losses differ by {max(rel)} > {MOE_BF16_LOSS_RTOL}")
    tokens = mb * gas * T
    step_s = float(sum(walls[1:])) / (steps - 1)
    emit({"phase": "train_moe_bf16", "model": "gpt2 124M widths, 8 experts top-2",
          "params": cfg.num_params(), "micro_batch": mb, "gas": gas, "T": T, "steps": steps,
          "losses": losses, "plain_attention_losses": plain, "max_rel_diff": max(rel),
          "tol": MOE_BF16_LOSS_RTOL, "step_ms": [w * 1e3 for w in walls],
          "step_ms_mean_after_first": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": peak, "routed_assignments": drops["assignments"],
          "dropped_assignments": drops["dropped"],
          "dropped_share": drops["dropped"] / max(1, drops["assignments"]),
          "moe_ffn_vs_dense": witness, "moe_ffn_tol": MOE_FFN_RTOL,
          "launches": {n: c for n, c in launches.items() if c}})
    return launches


def moe_requests(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 50257, int(n), dtype=np.int32), NEO_NEW)
            for n in rng.integers(NEO_PROMPTS[0], NEO_PROMPTS[1] + 1, 8)]


def watch_drops(srv):
    """Note, on ``srv``'s prefill and decode calls, the requests one of
    whose tokens lost an expert pick to capacity (``moe.record_drops``): a
    prefill chunk's real tokens are its request's; a decode row is its
    slot's.  Returns the set of request ids it fills and the routed and
    dropped assignments it sums."""
    import torch

    from deepspeed_tpu_torch.moe.layer import MOE_PARAM_KEYS, record_drops

    dropped, totals = set(), {"assignments": 0, "dropped": 0}
    prefill, decode = srv._run_prefill, srv._run_decode

    def add(rec):
        for k, v in rec.counts().items():
            totals[k] += v

    def run_prefill(job):
        with record_drops() as rec:
            prefill(job)
        add(rec)
        # the chunk's real tokens (its zero-padded tail routes too, but
        # feeds no real token: a pad's lost pick changes nothing)
        if rec.tokens and bool(torch.stack(rec.tokens)[:, :job.length].any()):
            dropped.add(job.req.request_id)

    def run_decode(toks, pos, decoding):
        with record_drops() as rec:
            decode(toks, pos, decoding)
        add(rec)
        lost = torch.stack(rec.tokens).any(0).cpu().numpy() if rec.tokens else None
        for r in decoding:
            if lost is not None and lost[r.slot]:
                dropped.add(r.request_id)

    srv._run_prefill, srv._run_decode = run_prefill, run_decode
    return dropped, totals


def _moe_serve(srv, reqs):
    dropped, totals = watch_drops(srv)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    res = srv.drain()
    return [res[r] for r in rids], dropped, totals


def phase_serve_moe_bf16(torch, moe_params):
    """The GPT-2-MoE of ``train_moe_bf16`` served in bf16 through
    ``init_serving``, on the slot pool and on the paged pool: 8 requests of
    64-256 prompt tokens, 48 new each, plus a ``generate()`` of 4 x 256
    prompts (counters zeroed just before, read just after: B1, and B4 on
    the slot pool, B5 on the paged pool).  At decode 8 slots route 16 picks
    over 8 experts at capacity max(ceil(8 / 8 * 2.0), 4) = 4, so some
    expert overflows at some step (free slots route too, as in the JAX
    package's decode); a request served alone never drops.  So a request
    none of whose steps (nor its solo ``generate()``'s) dropped a pick is
    held to solo ``generate()``; the rest to a replay of the same batches
    through the plain bodies (``use_flash_attention=False``); both under
    the near-tie rule.  The paged pool leaks no page.  Two witnesses
    outside the serving code: ``moe_ffn`` within MOE_FFN_RTOL of the dense
    form at the decode, chunk and prompt shapes, and every prompt's
    prefill logits within MOE_PREFILL_SPACINGS of ``models/gpt2.apply``.
    Prints the dropped count, decode tokens/s and TTFT p50."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.moe.layer import MOE_PARAM_KEYS, record_drops
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.tools.fleet_chaos import first_difference

    cfg = _moe_cfg()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eng = deepspeed_tpu_torch.init_inference(model_config=cfg, params=moe_params,
                                             dtype=torch.bfloat16)
    plain_eng = deepspeed_tpu_torch.init_inference(
        model_config=dataclasses.replace(cfg, use_flash_attention=False), params=eng.params,
        dtype=torch.bfloat16)
    reqs = moe_requests()
    ids = generate_ids()
    with torch.inference_mode():
        tie = near_tie_tol(eng.prefill(ids, *eng.init_cache(4, 256))[0])
    # witnesses outside the serving code: the layer against the dense form
    # at the decode step's, a prefill chunk's and a whole prompt's shapes,
    # and each prompt's prefill logits against models/gpt2.apply
    leaves = {k: moe_params["blocks"][k][0] for k in MOE_PARAM_KEYS}
    witnesses = [moe_ffn_vs_dense(torch, leaves, shape, False, "cuda")
                 for shape in ((MOE_SLOT["num_slots"], 1), (1, MOE_SLOT["prefill_chunk"]),
                               (1, 256))]
    for w in witnesses:
        check_moe_witness("serve_moe_bf16", w)
    dev_params = _device_tree(torch, moe_params, torch.bfloat16, "cuda")
    vs_apply = prefill_vs_apply(torch, eng, dev_params, cfg, [p for p, _ in reqs], "cuda")
    del dev_params
    torch.cuda.empty_cache()
    worst = max(v["spacings"] for v in vs_apply)
    check(worst <= MOE_PREFILL_SPACINGS,
          f"serve_moe_bf16: prefill logits differ from gpt2.apply's by {worst} bf16 spacings "
          f"> {MOE_PREFILL_SPACINGS}")
    solo, solo_dropped = [], set()
    for i, (p, n) in enumerate(reqs):
        with record_drops() as rec:
            solo.append(eng.generate(p[None], max_new_tokens=n)[0])
        if rec.counts()["dropped"]:
            solo_dropped.add(i)
    out, all_launches = {}, {}
    for pool, conf, decode in (("slot", MOE_SLOT, "flash_decode"),
                               ("paged", MOE_PAGED, "flash_decode_paged")):
        srv = ServingEngine(eng, config=conf)
        # -- the main path: counters zeroed just before, read just after ---
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        done, dropped, drops = _moe_serve(srv, reqs)
        gen = eng.generate(ids, max_new_tokens=GEN_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, variants = kernels.launches(), kernels.launch_variants()
        # ------------------------------------------------------------------
        _main_path_launches(f"serve_moe_bf16 {pool}", launches, variants, (decode,))
        check(gen.shape == (4, 256 + GEN_NEW), f"serve_moe_bf16: generate() gave {gen.shape}")
        replay, replay_dropped, _ = _moe_serve(ServingEngine(plain_eng, config=conf), reqs)
        flips, held = [], {"solo": 0, "replay": 0}
        # not a gate: how many served outputs equal solo generate() anyway
        same_as_solo = sum(np.array_equal(r.tokens(), want) for r, want in zip(done, solo))
        for i, (r, (p, n)) in enumerate(zip(done, reqs)):
            check(r.finish_reason == "length" and len(r.generated) == n,
                  f"serve_moe_bf16 {pool} request {i}: {r.finish_reason}, {len(r.generated)}")
            clean = (r.request_id not in dropped and replay[i].request_id not in replay_dropped
                     and i not in solo_dropped)
            want = solo[i] if clean else replay[i].tokens()
            held["solo" if clean else "replay"] += 1
            diff = first_difference(eng, len(p), r.tokens(), want, tie)
            if diff is not None:
                check(diff["ok"], f"serve_moe_bf16 {pool} request {i} differs from "
                                  f"{'solo generate()' if clean else 'the plain replay'} at "
                                  f"token {diff['at']}, gap {diff['gap']} above {tie}")
                flips.append({"request": i, "against": "solo" if clean else "replay", **diff})
        leaked = None
        if pool == "paged":
            live, acc = srv.pool.pages_live, accounted_pages(srv.pool)
            leaked = live - len(acc)
            check(leaked == 0, f"serve_moe_bf16: {live} pages live, {len(acc)} accounted")
        out[pool] = {**_serve_rates(srv, done, wall), "requests_with_drops": len(dropped),
                     "held_to": held, "near_tie_flips": flips, "leaked_pages": leaked,
                     "equal_to_solo_generate": int(same_as_solo),
                     "routed_assignments": drops["assignments"],
                     "dropped_assignments": drops["dropped"],
                     "launches": {n: c for n, c in launches.items() if c}}
        for n, c in launches.items():
            all_launches[n] = all_launches.get(n, 0) + c
        del srv
    emit({"phase": "serve_moe_bf16", "model": "gpt2 124M widths, 8 experts top-2",
          "params": cfg.num_params(), "served": len(reqs), "near_tie_tol": tie,
          "solo_requests_with_drops": len(solo_dropped), "moe_ffn_vs_dense": witnesses,
          "moe_ffn_tol": MOE_FFN_RTOL, "prefill_vs_apply": vs_apply,
          "prefill_vs_apply_tol_spacings": MOE_PREFILL_SPACINGS, **out})
    del eng, plain_eng
    torch.cuda.empty_cache()
    return all_launches


class PipeEmbed:
    """GPT-2's token and position embeddings as a pipeline layer (tied
    with :func:`pipe_head` under the key ``embed``)."""

    def __init__(self, vocab, positions, d):
        self.vocab, self.positions, self.d = vocab, positions, d

    def init(self, rng):
        return {"wte": (rng.standard_normal((self.vocab, self.d)) * 0.02).astype(np.float32),
                "wpe": (rng.standard_normal((self.positions, self.d)) * 0.01).astype(np.float32)}

    def num_params(self):
        return (self.vocab + self.positions) * self.d

    def apply(self, params, tokens, generator=None):
        T = tokens.shape[1]
        return params["wte"][tokens.long()] + params["wpe"][:T][None]


def pipe_head(params, x):
    return x @ params["wte"].t().to(x.dtype)


class PipeBlock:
    """One GPT-2 block of the port (``models/gpt2.py`` ``_block``)."""

    def __init__(self, **cfg):
        from deepspeed_tpu_torch.models import gpt2

        self.cfg = dataclasses.replace(gpt2.GPT2Config(**cfg), remat=False)

    def init(self, rng):
        d, std = self.cfg.n_embd, 0.02
        proj = std / np.sqrt(2 * self.cfg.n_layer)
        n = lambda *s, sc=std: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
        z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
        return {"ln1_g": np.ones(d, np.float32), "ln1_b": z(d), "qkv_w": n(d, 3 * d),
                "qkv_b": z(3 * d), "proj_w": n(d, d, sc=proj), "proj_b": z(d),
                "ln2_g": np.ones(d, np.float32), "ln2_b": z(d), "fc_w": n(d, 4 * d),
                "fc_b": z(4 * d), "fc_proj_w": n(4 * d, d, sc=proj), "fc_proj_b": z(d)}

    def num_params(self):
        d = self.cfg.n_embd
        return 12 * d * d + 13 * d

    def apply(self, params, x, generator=None):
        from deepspeed_tpu_torch.models import gpt2

        return gpt2._block(self.cfg, x, params, None, True)[0]


class PipeFinalLN:
    def __init__(self, d, eps=1e-5):
        self.d, self.eps = d, eps

    def init(self, rng):
        return {"g": np.ones(self.d, np.float32), "b": np.zeros(self.d, np.float32)}

    def num_params(self):
        return 2 * self.d

    def apply(self, params, x, generator=None):
        from deepspeed_tpu_torch.ops.normalize import layer_norm

        return layer_norm(x, params["g"], params["b"], self.eps)


def pipe_next_token_nll(logits, tokens):
    """GPT-2's loss: the next token's NLL over every position but the last."""
    import torch

    lg = logits[:, :-1].float()
    return torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                             tokens[:, 1:].reshape(-1).long())


def gpt2_pipe_module(n_layer=12, activation_checkpoint_interval=0):
    """GPT-2 124M as a ``PipelineModule``: the tied embedding, ``n_layer``
    blocks, the final LayerNorm and the tied head, the next-token NLL."""
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime.pipe import LayerSpec, PipelineModule, TiedLayerSpec

    c = dataclasses.replace(gpt2.PRESETS["gpt2"], n_layer=n_layer)
    cfg = {k: getattr(c, k) for k in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head")}
    layers = ([TiedLayerSpec("embed", PipeEmbed, c.vocab_size, c.n_positions, c.n_embd)]
              + [LayerSpec(PipeBlock, **cfg) for _ in range(n_layer)]
              + [LayerSpec(PipeFinalLN, c.n_embd),
                 TiedLayerSpec("embed", PipeEmbed, c.vocab_size, c.n_positions, c.n_embd,
                               forward_fn=pipe_head)])
    return PipelineModule(layers, loss_fn=pipe_next_token_nll, partition_method="parameters",
                          activation_checkpoint_interval=activation_checkpoint_interval), None


def _pipe_config(stages, gas):
    return {**_gpt2_bf16_config(8, gas), "mesh": {"pipe": stages},
            "pipeline": {"schedule": "1f1b"}}


def pipe_witness(init, seq, pipe, seq_norms, pipe_norms):
    """The pipelined run against one stage: by step, the worst relative
    gap of a gradient norm (every leaf, a stacked leaf block by block;
    :func:`tools.pipe_worker.record_grad_norms`), and the worst relative
    gap of a parameter's change over the steps ``seq`` and ``pipe`` were
    taken after, ``|P_pipe - P_seq| / |P_seq - P_init|`` (Frobenius, a
    stacked leaf block by block)."""
    grad = []
    for s, (want, got) in enumerate(zip(seq_norms, pipe_norms)):
        check(len(got) >= len(want), f"train_pipe_bf16: step {s} noted {len(got)} gradient "
                                     f"norms, one stage {len(want)}")
        gaps = {name: abs(g - want[name.split("@")[0]]) / max(want[name.split("@")[0]], 1e-30)
                for name, g in got.items()}
        worst = max(gaps, key=gaps.get)
        grad.append({"gap": gaps[worst], "leaf": worst, "compared": len(gaps)})
    param = {}
    for path, p0 in init.items():
        a, b = np.asarray(pipe[path], np.float64), np.asarray(seq[path], np.float64)
        d = b - np.asarray(p0, np.float64)
        rows = range(a.shape[0]) if path.startswith("blocks/") else [None]
        for j in rows:
            key = path if j is None else f"{path}#{j}"
            sl = slice(None) if j is None else j
            param[key] = float(np.linalg.norm(a[sl] - b[sl]) / max(np.linalg.norm(d[sl]), 1e-30))
    top = sorted(param, key=param.get, reverse=True)[:3]
    return {"grad_norm_gaps_by_step": grad, "param_change_rel_gap": param[top[0]],
            "param_change_worst": [[k, param[k]] for k in top],
            "param_blocks_compared": len(param)}


def _stage_norms(ranks):
    """The stages' gradient norms merged step by step; a leaf every stage
    holds (the reduction makes its norms equal) is kept once a stage,
    under ``<name>@stage<s>``."""
    return [{(name if "#" in name else f"{name}@stage{r['stage']}"): v
             for r in ranks for name, v in r["grad_norms"][s].items()}
            for s in range(len(ranks[0]["grad_norms"]))]


def phase_train_pipe_bf16(torch):
    """GPT-2 124M assembled as a ``PipelineModule`` (:func:`gpt2_pipe_module`)
    trained in bf16 over two stage processes sharing the card (gloo between
    them, activations and their gradients through pinned host memory;
    ``tools/pipe_worker.py``), ``1f1b`` over 4 micro-batches of 8 x 1024,
    3 steps on one repeated batch (so the loss moves): each stage's
    counters zeroed just before its steps and read just after (B1, B2 and
    B3 launched on each stage).  Held to the same module at one stage in
    this process: the losses within PIPE_BF16_LOSS_RTOL; every leaf's
    gradient norm (a block's leaves block by block, the tied embedding's
    after the stages' sum) within PIPE_BF16_GRAD0_RTOL at the first step
    and PIPE_BF16_GRAD_RTOL at the others; every leaf's (block's) change
    over the first step within PIPE_BF16_PARAM_RTOL (:func:`pipe_witness`).  Prints ms a step and, per stage, the share of
    the step's wall outside its own CUDA-event spans (with the stages on
    one card the spans take in the other stage's kernels too, so this is
    not the card's idle time) and peak GiB."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.runtime.engine import tree_items
    from deepspeed_tpu_torch.tools.pipe_worker import record_grad_norms

    steps, gas, T = 3, 4, 1024
    one = np.random.default_rng(31).integers(0, 50257, (gas * 8, T), dtype=np.int32)
    ids = np.stack([one] * steps)
    with tempfile.TemporaryDirectory() as root:
        np.savez(os.path.join(root, "b.npz"), x=ids, y=ids)
        case = {"name": "pipe2", "module": {"factory": os.path.join(REPO, "chip_smoke.py")
                                            + ":gpt2_pipe_module"},
                "config": _pipe_config(2, gas), "batches": os.path.join(root, "b.npz"),
                "steps": steps, "record": "full", "record_step": 1, "grad_norms": True}
        spec = {"device": "cuda", "backend": "gloo", "deterministic": False, "threads": 4,
                "init_method": f"file://{root}/store", "out": root, "cases": [case]}
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        procs = []
        t0 = time.perf_counter()
        for r in range(2):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       PYTHONPATH=REPO)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deepspeed_tpu_torch.tools.pipe_worker",
                 os.path.join(root, "spec.json")], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        wall = time.perf_counter() - t0
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"train_pipe_bf16: stage {r} exited {p.returncode}:\n"
                                     f"{o[-3000:]}")
        with open(os.path.join(root, "pipe2.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(root, "pipe2.npz")) as z:
            pipe_params = {k: z[k] for k in z.files}
    # the same module at one stage, in this process
    module, _ = gpt2_pipe_module()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    engine, *_ = deepspeed_tpu_torch.initialize(model=module, config=_pipe_config(1, gas))
    init = {p: t.cpu().numpy() for p, t in tree_items(engine.params)}
    seq_norms = record_grad_norms(engine)
    seq = [float(engine.train_batch(batch=(ids[0], ids[0])))]
    seq_params = {p: t.cpu().numpy() for p, t in tree_items(engine.params)}
    seq += [float(engine.train_batch(batch=(ids[s], ids[s]))) for s in range(1, steps)]
    del engine
    torch.cuda.empty_cache()
    witness = pipe_witness(init, seq_params, pipe_params, seq_norms,
                           _stage_norms(meta["ranks"]))
    del init, seq_params, pipe_params
    losses = meta["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, seq)]
    launches = {}
    for rank in meta["ranks"]:
        for n, c in rank["launches"].items():
            launches[n] = launches.get(n, 0) + c
    tokens = gas * 8 * T
    step_s = float(np.mean(meta["ms"][1:])) / 1e3
    emit({"phase": "train_pipe_bf16", "model": "gpt2 124M as a PipelineModule",
          "stages": 2, "schedule": "1f1b", "micro_batches": gas, "micro_batch": 8, "T": T,
          "batch": "one batch repeated each step",
          "transport": "gloo, pinned host copies (stage processes share the card)",
          "losses": losses, "one_stage_losses": seq, "max_rel_diff": max(rel),
          "tol": PIPE_BF16_LOSS_RTOL, **witness, "grad_tol_first_step": PIPE_BF16_GRAD0_RTOL,
          "grad_tol": PIPE_BF16_GRAD_RTOL, "param_tol": PIPE_BF16_PARAM_RTOL,
          "step_ms": meta["ms"],
          "step_ms_mean_after_first": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "outside_own_spans_by_stage": {r["stage"]: r["idle"] for r in meta["ranks"]},
          "peak_gib_by_stage": {r["stage"]: (r["peak"] or 0) / 2**30 for r in meta["ranks"]},
          "bytes_by_stage": {r["stage"]: r["comm"][-1] for r in meta["ranks"]},
          "model_bytes_by_stage": {r["stage"]: r["model"] for r in meta["ranks"]},
          "max_live_by_stage": {r["stage"]: r["max_live"] for r in meta["ranks"]},
          "wall_s": wall, "launches_by_stage": {r["stage"]: {n: c for n, c in r["launches"].items()
                                                             if c} for r in meta["ranks"]}})
    check(all(np.isfinite(losses)), f"train_pipe_bf16: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_pipe_bf16: loss did not fall: {losses}")
    check(max(rel) <= PIPE_BF16_LOSS_RTOL,
          f"train_pipe_bf16: pipelined vs one-stage losses differ by {max(rel)}")
    for s, g in enumerate(witness["grad_norm_gaps_by_step"]):
        tol = PIPE_BF16_GRAD0_RTOL if s == 0 else PIPE_BF16_GRAD_RTOL
        check(g["gap"] <= tol, f"train_pipe_bf16: step {s}'s gradient norm of {g['leaf']} "
                               f"differs from one stage's by {g['gap']} > {tol}")
    check(witness["param_change_rel_gap"] <= PIPE_BF16_PARAM_RTOL,
          f"train_pipe_bf16: parameter {witness['param_change_worst'][0][0]} moved "
          f"{witness['param_change_rel_gap']} (relative) away from one stage's > "
          f"{PIPE_BF16_PARAM_RTOL}")
    for rank in meta["ranks"]:
        for name in ("flash_fwd", "flash_bwd", "fused_adam"):
            check(rank["launches"].get(name, 0) > 0,
                  f"train_pipe_bf16: stage {rank['stage']} launched no {name}")
    return launches


# ---------------------------------------------------------------------------
# phases 19-22: ZeRO-Offload and ZeRO-Infinity (GPT-2 124M, train_bf16's
# config and batch)
# ---------------------------------------------------------------------------

# train_offload_bf16 vs train_bf16, losses after the first (relative): the
# same bf16 weights and kernels, the f32 Adam taken by the host kernel in
# another order than B3 (a few f32 roundings of the update), carried
# through bf16 weights; about five times the H100's reading, 5.4e-5
# (test_torch_offload.py's bf16 GPT2_TINY reads about 1e-5 on the CPU)
OFFLOAD_LOSS_RTOL = 3e-4
# the first step's masters, host Adam vs B3, per element: the two take the
# same gradients and round the update in other orders (a few f32 spacings
# of the update and one of the master), so |dp| <= 2**-20 |p| + 2**-20 lr;
# a gradient that differed would move an element up to 2 lr (Adam's first
# step is lr * sign(g)), far outside it
OFFLOAD_STEP1_REL = 2.0**-20
# the device peak must fall by at least this share of 10 bytes a parameter
# (f32 master and moments, 12, gone; bf16 parameters, 2, resident)
OFFLOAD_PEAK_SHARE = 0.8
# train_infinity_bf16 vs train_offload_bf16, losses (relative): the same
# bf16 weights, kernels and host Adam; the stream sums the tied wte's two
# gradients in f32 on the host (the in-memory engine in bf16 in autograd)
# and the global norm in f64; about seven times the H100's reading, 4.4e-5
INFINITY_LOSS_RTOL = 3e-4
# the stream's peak against train_offload_bf16's: it must fall by this
# share of what the device stops holding, the f32 accumulator (4 bytes a
# parameter) and the blocks' bf16 parameters, less the two group buffers.
# The H100 read 0.98 of it at 12 groups and 1.10 at 6; all 12 groups'
# parameters kept on the card would leave 0.76
INFINITY_PEAK_SHARE = 0.85


def _offload_run(torch, params, config, batch, steps, save_at=None, save_dir=None,
                 timing_step=None):
    """``steps`` train_batch calls on one batch through ``initialize``:
    ``(engine, losses, walls, breakdowns)``; a save after step ``save_at``
    (1-based) into ``save_dir``; step ``timing_step`` serialized with
    ``train_batch(timing=)`` (the streaming engine)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.make_model(gpt2.PRESETS["gpt2"])[0], model_parameters=params, config=config)
    losses, walls, rows = [], [], []
    for step in range(1, steps + 1):
        timing = {} if step == timing_step else None
        t0 = time.perf_counter()
        loss = (engine.train_batch(batch, timing=timing) if timing is not None
                else engine.train_batch(batch))
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        rows.append(timing if timing is not None else (
            engine.offload_breakdown() if hasattr(engine, "offload_breakdown") else None))
        if step == save_at:
            engine.save_checkpoint(save_dir, tag=f"step{step}")
    return engine, losses, walls, rows


def _host_state(engine):
    """The host masters and moments by name (copies)."""
    return {k: t.clone() for k, t in engine._host_opt.state_dict().items()}


def _offload_config(zero):
    config = _gpt2_bf16_config(8, 2)
    config["zero_optimization"] = zero
    return config


def _tc_only_b1_b2(label, launches, variants):
    for name in ("flash_fwd", "flash_bwd"):
        check(launches[name] > 0, f"{label}: kernel {name} was not launched")
        check(only_tc(variants[name]), f"{label}: {name} ran {variants[name]}, not only the "
                                       "tensor-core body")
    check(launches["fused_adam"] == 0, f"{label}: B3 launched {launches['fused_adam']} times; the "
                                       "host Adam owns the update")


def phase_train_offload_bf16(torch, params, ref, smi, root):
    """ZeRO-Offload (``offload_optimizer: {device: cpu}``), train_bf16's
    config and batch: its main path (counters zeroed before, read after),
    then a fresh engine resumed from the save after step 2."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.adam import cpu_adam

    t_phase = time.perf_counter()
    cfg = gpt2.PRESETS["gpt2"]
    n_params = cfg.num_params()
    config = _offload_config({"offload_optimizer": {"device": "cpu"}})
    batch, steps = {"input_ids": ref["batch"]}, 4
    from deepspeed_tpu_torch.tools.profile_offload import host_rates

    rates = host_rates(torch.device("cuda", 0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    kernels.reset_launches()
    cpu_adam.reset_counts()
    engine, losses, walls, rows = _offload_run(torch, params, config, batch, steps, save_at=2,
                                               save_dir=os.path.join(root, "ck"))
    launches, variants, host_calls = kernels.launches(), kernels.launch_variants(), cpu_adam.counts()
    # ----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    _tc_only_b1_b2("train_offload_bf16", launches, variants)
    check(host_calls["ds_cpu_adam_step"] >= steps * 16 and host_calls["ds_fp32_to_bf16"] >= steps * 16,
          f"train_offload_bf16: the host kernels ran {host_calls}")
    check(all(np.isfinite(losses)), f"train_offload_bf16: non-finite loss {losses}")
    check(losses[0] == ref["losses"][0],
          f"train_offload_bf16: first loss {losses[0]!r} != train_bf16's {ref['losses'][0]!r}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    check(max(rel) <= OFFLOAD_LOSS_RTOL,
          f"train_offload_bf16: losses {losses} vs train_bf16 {ref['losses']} (rel {max(rel)})")
    want_drop = OFFLOAD_PEAK_SHARE * 10 * n_params
    check(peak <= ref["peak_bytes"] - want_drop,
          f"train_offload_bf16: peak {peak} B, train_bf16's {ref['peak_bytes']} B: fell by "
          f"{ref['peak_bytes'] - peak}, less than {want_drop}")
    final = _host_state(engine)
    bf16_params = [p.detach().clone() for p in engine._params]
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # -- the first step against B3's (a fresh engine, one step) -------------
    one, _, _, _ = _offload_run(torch, params, config, batch, 1)
    lr1 = float(one.lr_schedule(0))
    worst, share = 0.0, 0
    for name, m in zip(one._host_opt.keys, one._host_opt.masters):
        want = ref["step1_masters"][name].float()
        diff = (m - want).abs()
        bound = OFFLOAD_STEP1_REL * (want.abs() + lr1)
        worst = max(worst, float((diff / bound).max()))
        share += int((diff > 0).sum())
    del one
    gc.collect()
    torch.cuda.empty_cache()
    check(worst <= 1.0, f"train_offload_bf16: step-1 masters {worst} x the bound from B3's")

    # -- resume: steps 3-4 from the tag saved after step 2 ------------------
    t0 = time.perf_counter()
    import deepspeed_tpu_torch

    resumed, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.make_model(cfg)[0], model_parameters=params, config=config)
    path, _ = resumed.load_checkpoint(os.path.join(root, "ck"), tag="step2")
    check(path is not None and resumed.global_steps == 2, "train_offload_bf16: no resume")
    tail = [float(resumed.train_batch(batch)) for _ in range(steps - 2)]
    load_s = time.perf_counter() - t0
    got = _host_state(resumed)
    same_state = set(got) == set(final) and all(torch.equal(got[k], final[k]) for k in final)
    same_params = all(torch.equal(a, b) for a, b in zip(resumed._params, bf16_params))
    del resumed, got, bf16_params
    gc.collect()
    torch.cuda.empty_cache()
    check(tail == losses[2:], f"train_offload_bf16: resumed losses {tail} != {losses[2:]}")
    check(same_state and same_params,
          f"train_offload_bf16: resumed host state equal {same_state}, device params {same_params}")

    brk = rows[1:]  # the steps after the first (its kernels' first load)
    mean = {k: float(np.mean([r[k] for r in brk])) for k in brk[0] if brk[0][k] is not None}
    step_ms = float(np.mean(walls[1:])) * 1e3
    device_ms = step_ms - mean["d2h_ms"] - mean["adam_ms"] - mean["cast_ms"] - mean["h2d_ms"]
    emit({"phase": "train_offload_bf16", "card": smi, "micro_batch": 8, "gas": 2, "T": 1024,
          "steps": steps, "losses": losses, "losses_train_bf16": ref["losses"],
          "max_rel_diff": max(rel), "tol": OFFLOAD_LOSS_RTOL,
          "step1_masters_worst_vs_bound": worst, "step1_elements_differing": share,
          "step1_bound": f"{OFFLOAD_STEP1_REL} * (|p| + lr)",
          "resumed_losses": tail, "resume_s": load_s, "step_ms": [w * 1e3 for w in walls],
          "step_ms_mean_after_first": step_ms,
          "split_ms": {"device_compute_and_rest": device_ms, **mean},
          "host_adam_gbps": ADAM_BYTES_PER_ELEM * n_params / (mean["adam_ms"] / 1e3) / 1e9,
          **rates, "torch_threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
          "host_adam_threads": cpu_adam.default_threads(),
          "peak_bytes": peak, "peak_bytes_train_bf16": ref["peak_bytes"],
          "peak_drop_bytes": ref["peak_bytes"] - peak, "peak_drop_needed": want_drop,
          "launches": launches, "host_calls": host_calls,
          "variants": {n: variants[n] for n in ("flash_fwd", "flash_bwd")},
          "wall_s": time.perf_counter() - t_phase})
    return launches, {"losses": losses, "final": {k: v for k, v in final.items()
                                                  if k.startswith("master/")},
                      "peak_bytes": peak}


def phase_train_offload_nvme_bf16(torch, params, off, smi, root):
    """``offload_optimizer: {device: nvme}``: the moments only through the
    disk; the losses and final masters train_offload_bf16's, bit for bit."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.aio import aio

    t_phase = time.perf_counter()
    config = _offload_config({"offload_optimizer": {"device": "nvme",
                                                    "nvme_path": os.path.join(root, "nvme")}})
    batch, steps = {"input_ids": off["batch"]}, 4
    kernels.reset_launches()
    aio.reset_counts()
    engine, losses, walls, rows = _offload_run(torch, params, config, batch, steps)
    launches, variants, io = kernels.launches(), kernels.launch_variants(), aio.counts()
    _tc_only_b1_b2("train_offload_nvme_bf16", launches, variants)
    check(losses == off["losses"], f"train_offload_nvme_bf16: losses {losses} != {off['losses']}")
    same = all(torch.equal(m, off["final"][f"master/{k}"])
               for k, m in zip(engine._host_opt.keys, engine._host_opt.masters))
    check(same, "train_offload_nvme_bf16: final masters differ from train_offload_bf16's")
    kernel_aio = engine._host_opt.swapper.swapper.used_kernel_aio
    n_params = sum(m.numel() for m in engine._host_opt.masters)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # step 1 only writes (the moments start as zeros); later steps read and write
    per_step = {"read_bytes": io["read_bytes"] / (steps - 1), "write_bytes": io["write_bytes"] / steps}
    adam_s = float(np.mean([r["adam_ms"] for r in rows[1:]])) / 1e3
    emit({"phase": "train_offload_nvme_bf16", "card": smi, "steps": steps, "losses": losses,
          "bytes_a_step": per_step, "bytes_a_step_model": 16 * n_params,
          "bytes_model_note": "m and v (8 B a parameter) read and written back: 16 x n_params",
          "disk_gbps_in_host_step": (per_step["read_bytes"] + per_step["write_bytes"]) / adam_s / 1e9,
          "host_step_ms": adam_s * 1e3, "used_kernel_aio": kernel_aio,
          "step_ms": [w * 1e3 for w in walls], "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    check(per_step["read_bytes"] == 8 * n_params and per_step["write_bytes"] == 8 * n_params,
          f"train_offload_nvme_bf16: {per_step} a step, not m and v of {n_params} each way")
    return launches


def phase_train_infinity_bf16(torch, params, off, smi, root, device="cpu", buffer_count=1,
                              ref_losses=None):
    """ZeRO-Infinity: ``offload_param`` (``cpu``: 12 one-layer groups;
    ``nvme``: 6 two-layer groups staged in files), train_bf16's batch."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.aio import aio

    label = "train_infinity_bf16" if device == "cpu" else "train_infinity_nvme_bf16"
    t_phase = time.perf_counter()
    cfg = gpt2.PRESETS["gpt2"]
    zero = {"offload_param": {"device": device, "buffer_count": buffer_count,
                              **({"nvme_path": os.path.join(root, "nvme_params")}
                                 if device == "nvme" else {})}}
    batch, steps, gas = {"input_ids": off["batch"]}, 4, 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    aio.reset_counts()
    engine, losses, walls, rows = _offload_run(torch, params, _offload_config(zero), batch, steps,
                                               timing_step=steps)
    launches, variants, io = kernels.launches(), kernels.launch_variants(), aio.counts()
    peak = torch.cuda.max_memory_allocated()
    stats, G, group_bytes = dict(engine.stats), engine.n_groups, engine.group_bytes
    grads_left = engine.live_group_grad_bytes
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _tc_only_b1_b2(label, launches, variants)
    want = off["losses"] if ref_losses is None else ref_losses
    # the same bf16 weights through the same kernels: the first loss is the
    # in-memory engine's bits (a copy racing the compute would show here)
    check(losses[0] == want[0], f"{label}: first loss {losses[0]!r} != {want[0]!r}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    check(all(np.isfinite(losses)) and max(rel) <= INFINITY_LOSS_RTOL,
          f"{label}: losses {losses} vs {want} (rel {max(rel)})")
    check(group_bytes < stats["max_live_group_grad_bytes"] <= 2 * group_bytes and grads_left == 0,
          f"{label}: {stats['max_live_group_grad_bytes']} B of group gradients live at most "
          f"({grads_left} B after the steps), not between one and two groups' {group_bytes} B")
    # what the device stops holding: the f32 accumulator and the blocks'
    # bf16 parameters, less the two group buffers
    blocks_bytes = G * group_bytes
    drop = 4 * cfg.num_params() + blocks_bytes - 2 * group_bytes
    check(off["peak_bytes"] - peak >= INFINITY_PEAK_SHARE * drop,
          f"{label}: peak {peak} B, train_offload_bf16's {off['peak_bytes']} B: fell by "
          f"{off['peak_bytes'] - peak}, less than {INFINITY_PEAK_SHARE} of {drop}")
    row = {"phase": label, "card": smi, "groups": G, "group_bytes": group_bytes, "steps": steps,
           "losses": losses, "losses_vs": want, "max_rel_diff": max(rel), "tol": INFINITY_LOSS_RTOL,
           "first_loss_same_bits": losses[0] == want[0], "peak_bytes": peak,
           "peak_bytes_offload": off["peak_bytes"], "peak_drop_bytes": off["peak_bytes"] - peak,
           "peak_drop_model": drop, "peak_drop_share": (off["peak_bytes"] - peak) / drop,
           "stats": stats, "aio": io,
           "step_ms": [w * 1e3 for w in walls[:-1]],
           "step_ms_mean_after_first": float(np.mean(walls[1:-1])) * 1e3,
           "serialized_step_s": rows[-1],
           "b1_launches_per_layer_micro": launches["flash_fwd"] / (steps * gas * cfg.n_layer),
           "launches": launches}
    if device == "nvme":
        want_read = steps * gas * 2 * blocks_bytes
        check(io["read_bytes"] == want_read and io["reads"] == steps * gas * 2 * G,
              f"{label}: the aio engine read {io['read_bytes']} B in {io['reads']} requests, "
              f"the sweeps need {want_read} B in {steps * gas * 2 * G}")
        row["disk_read_gbps_a_step"] = io["read_bytes"] / steps / float(np.mean(walls[1:-1])) / 1e9
        row["upload_gbps_serialized"] = blocks_bytes * gas * 2 / rows[-1]["upload_s"] / 1e9
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    return launches, losses


def run_offload_phases(torch, params, one_process, smi):
    """The four offload phases, train_bf16's references in ``one_process``."""
    import shutil
    import tempfile

    ref = {k: one_process[k] for k in ("losses", "peak_bytes", "step1_masters", "batch")}
    root = tempfile.mkdtemp()
    try:
        off_launches, off = phase_train_offload_bf16(torch, params, ref, smi, root)
        off["batch"] = ref["batch"]
        nvme_launches = phase_train_offload_nvme_bf16(torch, params, off, smi, root)
        inf_launches, inf_losses = phase_train_infinity_bf16(torch, params, off, smi, root)
        infn_launches, _ = phase_train_infinity_bf16(torch, params, off, smi, root, device="nvme",
                                                     buffer_count=2, ref_losses=inf_losses)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return ({"training_offload": off_launches, "training_offload_nvme": nvme_launches,
             "training_infinity": inf_launches, "training_infinity_nvme": infn_launches},
            off, inf_losses)



# ---------------------------------------------------------------------------
# phases 23-26: offload across ranks, the sparse stream, 1-bit optimizers
# and the compressed exchanges (GPT-2 124M, train_bf16's config)
# ---------------------------------------------------------------------------

# train_onebit_bf16: one exchange of fixed rows on the card's two ranks
# against the plain one-process rows function (absolute): a 1-bit output is
# a sign times a chunk's mean |x|, summed on the card in another order (a
# few f32 roundings of ~0.8); int8's codes and scales are order-free
ONEBIT_ROWS_ATOL = 1e-6
# the frozen-phase exchange moves 2 B a parameter against the dense
# all-reduce's 8 a micro-step (gas 2: 16)
ONEBIT_WIRE_FACTOR = 4.0
ONEBIT_FREEZE = 2


def _rank_batch(one_rank, gas, mb, dp):
    """A global batch whose every data-parallel rank's rows are
    ``one_rank``'s (``tools/zero_worker.py``'s row order: micro-batch i's
    rows ``i mb dp + r mb ...`` on rank r), so each rank computes the
    one-rank run's micro-batches."""
    T = one_rank.shape[-1]
    out = np.empty((gas * mb * dp, T), dtype=one_rank.dtype)
    for i in range(gas):
        for r in range(dp):
            out[i * mb * dp + r * mb:i * mb * dp + (r + 1) * mb] = one_rank[i * mb:(i + 1) * mb]
    return out


def spawn_ranks(root, cases, label, extra=None, world=2, timeout=600):
    """``world`` rank processes of ``tools/zero_worker.py`` sharing the card
    over gloo (CUDA tensors staged through pinned host memory where gloo
    needs it), every case of ``cases`` in that one spawn; every process is
    reaped.  Returns the wall seconds."""
    spec = {"device": "cuda", "backend": "gloo", "deterministic": False, "threads": 4,
            "init_method": f"file://{root}/store_{label}", "out": root, "cases": cases,
            **(extra or {})}
    path = os.path.join(root, f"spec_{label}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.zero_worker", path], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{label}: rank {r} exited {p.returncode}:\n{o[-3000:]}")
    return time.perf_counter() - t0


def _case_json(root, name):
    with open(os.path.join(root, f"{name}.json")) as f:
        return json.load(f)


def _sum_launches(meta):
    out = {}
    for rank in meta["launches_by_rank"]:
        for n, c in rank.items():
            out[n] = out.get(n, 0) + c
    return out


def _ranks_row(meta):
    """Step ms, each rank's profiled step (its kernels' busy time and the
    share of the step's window they leave idle: with both ranks on one card
    the window also holds the other rank's kernels, so this is not the
    card's idle time), host and device peaks."""
    return {"step_ms": meta["ms"], "step_ms_mean_after_first": float(np.mean(meta["ms"][1:]))
            if len(meta["ms"]) > 1 else meta["ms"][0],
            "profiled_step_by_rank": meta["profile_by_rank"],
            "device_peak_gib_by_rank": [(b or 0) / 2**30 for b in meta["peak_bytes_by_rank"]],
            "host_peak_gib_by_rank": [b / 2**30 for b in meta["host_peak_bytes_by_rank"]]}


def offload_ranks_cases(off, root):
    """train_offload_ranks_bf16's cases for the shared spawn."""
    mb, gas, steps = 8, 2, 4
    batches = os.path.join(root, "ranks_b.npz")
    np.savez(batches, input_ids=np.repeat(_rank_batch(off["batch"], gas, mb, 2)[None], steps,
                                          axis=0))

    def case(name, zero, **kw):
        config = dict(_gpt2_bf16_config(mb, gas), mesh={"data": 2})
        if zero:
            config["zero_optimization"] = zero
        return {"name": name, "preset": "gpt2", "init_seed": 0, "config": config,
                "batches": batches, "steps": steps, **kw}

    return [case("d2", None, steps=1),
            case("d2_off", {"offload_optimizer": {"device": "cpu"}}, steps=2, record_step=1,
                 profile_step=2),
            case("d2_off_nvme", {"offload_optimizer": {"device": "nvme",
                                                       "nvme_path": os.path.join(root, "nv")}},
                 steps=2, record="none")]


def phase_train_offload_ranks_bf16(torch, params, off, ref_losses, smi, root, spawn_wall):
    """ZeRO-Offload across ranks: train_bf16's model, config and batch at
    ``mesh: {data: 2}`` over two rank processes sharing the card (gloo;
    :func:`offload_ranks_cases`, run in the rank phases' one spawn), each
    rank's rows train_bf16's micro-batches: one step without offload, 2
    with ``offload_optimizer: cpu`` (each rank 1/2 of the packed masters
    and moments, the slices all-gathered as pinned f32 tensors), 2 with
    ``nvme``.  Gates: the first offload loss is the same two ranks' without
    offload bit for bit; the masters after step 1 within OFFLOAD_STEP1_REL
    (|p| + lr) of theirs (B3's); the later losses within OFFLOAD_LOSS_RTOL
    of train_bf16's (``ref_losses``); each rank's host master bytes half of the one-rank
    engine's, up to pack_flat's pad; nvme the cpu run's losses bit for bit;
    and in this process, ``DS_OFFLOAD_SHARDS=2`` gives train_offload_bf16's
    final masters bit for bit."""
    from deepspeed_tpu_torch.models import gpt2

    t_phase = time.perf_counter()
    steps = 4  # train_offload_bf16's, for the one-process run beside it
    n = gpt2.PRESETS["gpt2"].num_params()
    d2, d2_off, nvme = (_case_json(root, c) for c in ("d2", "d2_off", "d2_off_nvme"))
    lr1 = float(gpt2_lr(0))
    worst = 0.0
    with np.load(os.path.join(root, "d2.npz")) as a, np.load(os.path.join(root, "d2_off.npz")) as b:
        for k in a.files:
            if not k.startswith("params/"):
                continue
            want, got = a[k].astype(np.float64), b[k].astype(np.float64)
            bound = OFFLOAD_STEP1_REL * (np.abs(want) + lr1)
            worst = max(worst, float((np.abs(got - want) / bound).max()))
    rel = [abs(x - y) / abs(y) for x, y in zip(d2_off["losses"], ref_losses)]
    pad = n % 2
    host = [h["masters"] for h in d2_off["host_bytes_by_rank"]]
    # the sliced engine in one process (DS_OFFLOAD_SHARDS=2) against the
    # one-rank engine of train_offload_bf16, on its batch
    os.environ["DS_OFFLOAD_SHARDS"] = "2"
    try:
        eng, losses2, _, _ = _offload_run(torch, params, _offload_config(
            {"offload_optimizer": {"device": "cpu"}}), {"input_ids": off["batch"]}, steps)
    finally:
        del os.environ["DS_OFFLOAD_SHARDS"]
    same = all(torch.equal(m, off["final"][f"master/{k}"])
               for k, m in zip(eng._paths, eng._masters_full))
    shards, two_host = eng._offload_shards, eng.host_master_bytes()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches = _sum_launches(d2_off)
    emit({"phase": "train_offload_ranks_bf16", "card": smi, "ranks": 2, "mesh": {"data": 2},
          "transport": "gloo, pinned host copies (rank processes share the card)",
          "micro_batch": 8, "gas": 2, "T": 1024,
          "losses_no_offload": d2["losses"], "losses_offload": d2_off["losses"],
          "losses_train_bf16": ref_losses,
          "losses_nvme": nvme["losses"], "max_rel_diff": max(rel), "tol": OFFLOAD_LOSS_RTOL,
          "step1_masters_worst_vs_bound": worst,
          "step1_bound": f"{OFFLOAD_STEP1_REL} * (|p| + lr)",
          "host_master_bytes_by_rank": host, "host_master_bytes_one_rank": 4 * n,
          "one_process_shards2": {"shards": shards, "host_master_bytes": two_host,
                                  "losses": losses2, "final_masters_same_bits": same},
          "offload_breakdown_rank0": d2_off["offload_breakdown"],
          "bytes_a_step_rank0": d2_off["comm"][-1],
          "no_offload": _ranks_row(d2), **_ranks_row(d2_off), "launches": launches,
          "shared_spawn_wall_s": spawn_wall, "wall_s": time.perf_counter() - t_phase})
    check(all(np.isfinite(d2_off["losses"])), f"train_offload_ranks_bf16: losses {d2_off['losses']}")
    check(d2_off["losses"][0] == d2["losses"][0],
          f"train_offload_ranks_bf16: first loss {d2_off['losses'][0]!r} != without offload "
          f"{d2['losses'][0]!r}")
    # the second loss follows one update of each: nvme's moments through
    # the async-I/O engine give the cpu run's bits
    check(len(nvme["losses"]) == len(d2_off["losses"]) == 2,
          f"train_offload_ranks_bf16: {len(nvme['losses'])} nvme and {len(d2_off['losses'])} "
          "cpu steps, want 2 each")
    check(worst <= 1.0, f"train_offload_ranks_bf16: step-1 masters {worst} x the bound")
    check(max(rel) <= OFFLOAD_LOSS_RTOL, f"train_offload_ranks_bf16: losses rel {max(rel)}")
    check(host == [4 * (n + pad) // 2] * 2,
          f"train_offload_ranks_bf16: host master bytes {host}, not half of {4 * n} (+pad)")
    check(nvme["losses"] == d2_off["losses"][:len(nvme["losses"])],
          f"train_offload_ranks_bf16: nvme losses {nvme['losses']} != cpu {d2_off['losses']}")
    check(shards == 2 and same, "train_offload_ranks_bf16: DS_OFFLOAD_SHARDS=2 masters differ "
                                "from train_offload_bf16's")
    _tc_only_b1_b2("train_offload_ranks_bf16", launches, d2_off["variants"])
    return launches


def gpt2_lr(step):
    """train_bf16's learning rate at ``step`` (its WarmupDecayLR)."""
    from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule

    sched = _gpt2_bf16_config(8, 2)["scheduler"]
    return get_lr_schedule(sched["type"], sched["params"])(step)


def infinity_ranks_cases(torch, params, off, root):
    """train_infinity_ranks_bf16's cases for the shared spawn, after the
    one-rank stream's step and tag here (what 1 -> 2 restores): ``(cases,
    the tag's master digests, the one-rank block master bytes)``."""
    from deepspeed_tpu_torch.runtime.engine import tree_items

    mb, gas, steps = 8, 2, 2
    zero = {"offload_param": {"device": "cpu", "buffer_count": 1}}
    ck = os.path.join(root, "inf_ck")
    one, _, _, _ = _offload_run(torch, params, _offload_config(zero), {"input_ids": off["batch"]},
                                1, save_at=1, save_dir=ck)
    one_digest = _params_digest(torch, tree_items(one.params))
    one_block = sum(one._host_opt.masters[i].numel() * 4 for i in one._block_idx)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    batches = os.path.join(root, "inf_b.npz")
    np.savez(batches, input_ids=np.repeat(_rank_batch(off["batch"], gas, mb, 2)[None], steps,
                                          axis=0))
    config = dict(_offload_config(zero), mesh={"fsdp": 2})
    base = {"preset": "gpt2", "init_seed": 0, "config": config, "batches": batches}
    cases = [{"name": "inf2", **base, "steps": steps, "record": "digest", "profile_step": 2,
              "save": {"dir": ck, "tag": "two", "after": 2}},
             {"name": "inf2_tag", **base, "steps": 0, "record": "digest",
              "load": {"dir": ck, "tag": "two"}},
             {"name": "inf2_from_one", **base, "steps": 0, "record": "digest",
              "load": {"dir": ck, "tag": "step1"}}]
    return cases, one_digest, one_block


def phase_train_infinity_ranks_bf16(torch, params, inf_losses, smi, root, prep, spawn_wall):
    """ZeRO-Infinity across fsdp: ``offload_param: cpu`` (12 one-layer
    groups) at ``mesh: {fsdp: 2}`` over two rank processes sharing the card
    (:func:`infinity_ranks_cases`, in the rank phases' one spawn), each
    rank's rows train_bf16's micro-batches, 2 steps; each rank holds its
    fsdp part of every block leaf's masters and moments, a group's upload
    all-gathered over fsdp, its gradient reduce-scattered.  Gates: the
    first loss train_infinity_bf16's bit for bit; the later ones within
    INFINITY_LOSS_RTOL of it; each rank's block masters half of the
    one-rank engine's; a tag saved at 2 ranks restores into 1 rank and a
    1-rank tag into 2 ranks, the masters bit for bit."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime.engine import tree_items

    t_phase = time.perf_counter()
    _, one_digest, one_block = prep
    zero = {"offload_param": {"device": "cpu", "buffer_count": 1}}
    ck = os.path.join(root, "inf_ck")
    inf2, tag2, from_one = (_case_json(root, c) for c in ("inf2", "inf2_tag", "inf2_from_one"))
    # 2 -> 1: the two ranks' tag in one process
    eng, *_ = deepspeed_tpu_torch.initialize(model=gpt2.make_model(gpt2.PRESETS["gpt2"])[0],
                                             model_parameters=params,
                                             config=_offload_config(zero))
    eng.load_checkpoint(ck, tag="two")
    back_digest = _params_digest(torch, tree_items(eng.params))
    del eng
    gc.collect()
    rel = [abs(a - b) / abs(b) for a, b in zip(inf2["losses"], inf_losses)]
    blocks = [h["block_masters"] for h in inf2["host_bytes_by_rank"]]
    launches = _sum_launches(inf2)
    two_to_one = back_digest == _digests_of(tag2)
    one_to_two = _digests_of(from_one) == one_digest
    emit({"phase": "train_infinity_ranks_bf16", "card": smi, "ranks": 2, "mesh": {"fsdp": 2},
          "groups": 12, "micro_batch": 8, "gas": 2, "T": 1024, "steps": len(inf2["losses"]),
          "losses": inf2["losses"], "losses_train_infinity_bf16": inf_losses,
          "first_loss_same_bits": inf2["losses"][0] == inf_losses[0], "max_rel_diff": max(rel),
          "tol": INFINITY_LOSS_RTOL, "block_master_bytes_by_rank": blocks,
          "block_master_bytes_one_rank": one_block,
          "restore_two_to_one_same_bits": two_to_one, "restore_one_to_two_same_bits": one_to_two,
          "bytes_a_step_rank0": inf2["comm"][-1], **_ranks_row(inf2), "launches": launches,
          "shared_spawn_wall_s": spawn_wall, "wall_s": time.perf_counter() - t_phase})
    check(all(np.isfinite(inf2["losses"])), f"train_infinity_ranks_bf16: {inf2['losses']}")
    check(inf2["losses"][0] == inf_losses[0],
          f"train_infinity_ranks_bf16: first loss {inf2['losses'][0]!r} != {inf_losses[0]!r}")
    check(max(rel) <= INFINITY_LOSS_RTOL, f"train_infinity_ranks_bf16: losses rel {max(rel)}")
    check(blocks == [one_block // 2] * 2,
          f"train_infinity_ranks_bf16: block master bytes {blocks}, one rank {one_block}")
    check(two_to_one and one_to_two,
          f"train_infinity_ranks_bf16: restores 2->1 {two_to_one}, 1->2 {one_to_two}")
    _tc_only_b1_b2("train_infinity_ranks_bf16", launches, inf2["variants"])
    return launches


def _params_digest(torch, items):
    import hashlib

    return {f"params/{k}": hashlib.sha256(t.detach().cpu().reshape(-1).contiguous()
                                          .view(torch.uint8).numpy().tobytes()).hexdigest()
            for k, t in items}


def _digests_of(meta):
    return {k: v for k, v in meta["digests"].items() if k.startswith("params/")}


def phase_train_infinity_sparse_bf16(torch, sparse_losses, smi):
    """The block-sparse GPT-2 (124M widths, 8 layers, T 8192, B 1, Adam,
    cross-entropy chunks of 512) streamed one layer at a time
    (``offload_param: cpu``, 8 groups) on one rank, 2 steps on
    train_sparse_bf16's batch; counters zeroed just before, read just
    after: B8 twice a layer a step (the sweep and the group's recompute),
    B9a and B9b once, B1/B2 not.  Gate: the losses within
    INFINITY_LOSS_RTOL of the in-memory sparse engine's (train_sparse_bf16)."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import profile_summary
    from deepspeed_tpu_torch.tools.profile_training import LONG_ADAM

    t_phase = time.perf_counter()
    T, steps = SPARSE_TS[0], 2
    cfg = _sparse_cfg(T)
    params = gpt2.init_params(cfg, seed=0)
    config = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True},
              "optimizer": LONG_ADAM,
              "zero_optimization": {"offload_param": {"device": "cpu", "buffer_count": 1}}}
    batch = {"input_ids": np.random.default_rng(14).integers(0, 50257, (1, T), dtype=np.int32)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    import deepspeed_tpu_torch

    from deepspeed_tpu_torch.tools.zero_worker import HostPeak

    with HostPeak() as host_peak:
        kernels.reset_launches()
        engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.make_model(cfg)[0],
                                                    model_parameters=params, config=config)
        losses, walls = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            walls.append(time.perf_counter() - t0)
        launches, variants = kernels.launches(), kernels.launch_variants()
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.train_batch(batch)
        torch.cuda.synchronize()
    prof_row = profile_summary(prof)
    groups = engine.n_groups
    # the stream's host state: f32 masters, moments and gradients, the
    # groups' compute-type copies
    host_state = (sum(t.numel() * t.element_size() for t in engine._host_opt.state_dict().values())
                  + sum(t.numel() * t.element_size() for t in engine._host_grads)
                  + sum(t.numel() * t.element_size() for t in engine._host_groups))
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    want_losses = sparse_losses[:steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    want = {"splash_fwd": 2 * SPARSE_LAYERS * steps, "splash_bwd_dq": SPARSE_LAYERS * steps,
            "splash_bwd_dkv": SPARSE_LAYERS * steps}
    got = {k: launches[k] for k in want}
    emit({"phase": "train_infinity_sparse_bf16", "card": smi, "layers": SPARSE_LAYERS, "T": T,
          "B": 1, "groups": groups, "steps": steps, "losses": losses,
          "losses_in_memory": want_losses, "max_rel_diff": max(rel), "tol": INFINITY_LOSS_RTOL,
          "first_loss_same_bits": losses[0] == want_losses[0],
          "step_ms": [w * 1e3 for w in walls],
          "profiled_step": {k: prof_row[k] for k in ("window_ms", "device_busy_ms",
                                                     "device_idle_share")},
          "device_peak_gib": peak / 2**30,
          # the script process's resident peak during the steps (what earlier
          # phases left resident included)
          "host_peak_gib_script": host_peak.peak_bytes / 2**30,
          "host_stream_state_gib": host_state / 2**30,
          "launches": {k: v for k, v in launches.items() if v},
          "variants": {k: variants[k] for k in want}, "wall_s": time.perf_counter() - t_phase})
    check(all(np.isfinite(losses)) and max(rel) <= INFINITY_LOSS_RTOL,
          f"train_infinity_sparse_bf16: losses {losses} vs {want_losses} (rel {max(rel)})")
    check(got == want, f"train_infinity_sparse_bf16: splash launches {got}, want {want}")
    for name in want:
        check(variants[name] == {"none/tc": want[name]},
              f"train_infinity_sparse_bf16: {name} ran {variants[name]}")
    check(launches["flash_fwd"] == 0 and launches["flash_bwd"] == 0 and launches["fused_adam"] == 0,
          f"train_infinity_sparse_bf16: launches {launches}")
    return launches


def onebit_cases(off, root):
    """train_onebit_bf16's cases for the shared spawn, and the fixed rows
    of its exchange check (``compressed_check``)."""
    mb, gas = 8, 2
    batches = os.path.join(root, "onebit_b.npz")
    np.savez(batches, input_ids=np.repeat(_rank_batch(off["batch"], gas, mb, 2)[None], 4,
                                          axis=0))
    rng = np.random.default_rng(21)
    M = 1 << 20
    rows = os.path.join(root, "rows.npz")
    np.savez(rows, x=rng.standard_normal((2, M)).astype(np.float32),
             werr=(0.1 * rng.standard_normal((2, M))).astype(np.float32),
             serr=(0.1 * rng.standard_normal((2, M // 2))).astype(np.float32))

    def case(name, steps, optimizer=None, comm=None, **kw):
        config = dict(_gpt2_bf16_config(mb, gas), mesh={"data": 2})
        if optimizer is not None:
            config["optimizer"] = {"type": optimizer, "params": {
                "lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.1,
                "freeze_step": ONEBIT_FREEZE}}
        if comm is not None:
            config["comm"] = {"strategy": comm}
        return {"name": name, "preset": "gpt2", "init_seed": 0, "config": config,
                "batches": batches, "steps": steps, "record": "none", **kw}

    return [case("onebit_adam", 4, "OneBitAdam", profile_step=4),
            case("onebit_lamb", 3, "OneBitLamb"),
            case("comm_int8", 3, comm="int8"), case("comm_onebit", 3, comm="onebit")], rows


def phase_train_onebit_bf16(torch, smi, root, cases, rows, spawn_wall):
    """1-bit Adam (``freeze_step`` 2, 4 steps), 1-bit LAMB (3 steps) and
    AdamW with ``comm.strategy`` ``int8`` and ``onebit`` (3 steps: the
    second exchange carries the first's residuals, the third loss reads
    its update), train_bf16's model,
    config and batch at ``mesh: {data: 2}`` over two rank processes sharing
    the card (:func:`onebit_cases`, in the rank phases' one spawn), counters
    zeroed before each case and read after; first one exchange of fixed
    rows (2 x 2^20 entries on the card) through the group versions.  Gates:
    the losses finite, the last below the first; every compressed step's ``grad-exchange`` bytes, as
    ``comm/collectives.py`` counts them, equal ``step_comm_bytes``' onebit /
    int8 model and are at least ONEBIT_WIRE_FACTOR below the dense
    exchange; the warm steps dense; the rows within ONEBIT_ROWS_ATOL of the
    plain one-process rows function."""
    from deepspeed_tpu_torch.comm import collectives, compressed
    from deepspeed_tpu_torch.comm.strategy import step_comm_bytes
    from deepspeed_tpu_torch.models import gpt2

    t_phase = time.perf_counter()
    mb, gas, freeze = 8, 2, ONEBIT_FREEZE
    n = gpt2.PRESETS["gpt2"].num_params()
    metas = {c["name"]: _case_json(root, c["name"]) for c in cases}
    model = step_comm_bytes(n, {"data": 2, "fsdp": 1}, stage=0, gas=gas, strategy="onebit")
    dense = step_comm_bytes(n, {"data": 2, "fsdp": 1}, stage=0, gas=gas, strategy="dense")
    with np.load(rows) as z:
        x, werr, serr = (torch.from_numpy(z[k]) for k in ("x", "werr", "serr"))
    with np.load(os.path.join(root, "compressed.npz")) as z:
        got = {k: z[k] for k in z.files}
    out, w, e = compressed.compressed_allreduce_rows(x, werr, serr)
    errs = {"onebit": float(np.abs(got["onebit"] - out[0].numpy()).max()),
            "werr": float(np.abs(got["werr"] - w.numpy()).max()),
            "serr": float(np.abs(got["serr"] - e.numpy()).max()),
            "int8": float(np.abs(got["int8"] - collectives.quantized_allreduce_rows(x).numpy())
                          .max()),
            "dense": float(np.abs(got["dense"] - x.mean(0).numpy()).max())}
    launches = {}
    wire = {}
    for name, meta in metas.items():
        for k, v in _sum_launches(meta).items():
            launches[k] = launches.get(k, 0) + v
        frozen = meta["comm"][freeze:] if name.startswith("onebit_") else meta["comm"]
        wire[name] = [c.get("grad-exchange", 0) for c in frozen]
    emit({"phase": "train_onebit_bf16", "card": smi, "ranks": 2, "mesh": {"data": 2},
          "micro_batch": mb, "gas": gas, "T": 1024, "freeze_step": freeze,
          "losses": {k: m["losses"] for k, m in metas.items()},
          "frozen_at_end": {k: m["onebit_frozen"] for k, m in metas.items()},
          "grad_exchange_bytes_compressed_steps": wire,
          "model_grad_exchange_bytes": model["grad-exchange"],
          "dense_grad_exchange_bytes": dense["grad-exchange"],
          "rows_max_abs_err": errs, "rows_tol": ONEBIT_ROWS_ATOL,
          "rows_bytes": {"onebit": int(got["onebit_bytes"]), "int8": int(got["int8_bytes"])},
          # 1-bit Adam's variance-sharded layout on the same rows: the
          # exchange's bytes and its f32 master all-gather's
          "vsharded_rows_bytes": [int(b) for b in got["vsharded_bytes"]],
          **{f"{k}_row": _ranks_row(m) for k, m in metas.items()}, "launches": launches,
          "shared_spawn_wall_s": spawn_wall, "wall_s": time.perf_counter() - t_phase})
    for name, meta in metas.items():
        check(all(np.isfinite(meta["losses"])) and meta["losses"][-1] < meta["losses"][0],
              f"train_onebit_bf16 {name}: {meta['losses']}")
        check(all(b == model["grad-exchange"] for b in wire[name]),
              f"train_onebit_bf16 {name}: grad-exchange {wire[name]} B != the model's "
              f"{model['grad-exchange']}")
        check(all(ONEBIT_WIRE_FACTOR * b <= dense["grad-exchange"] for b in wire[name]),
              f"train_onebit_bf16 {name}: {wire[name]} not {ONEBIT_WIRE_FACTOR}x below dense")
    for name in ("onebit_adam", "onebit_lamb"):
        check(metas[name]["onebit_frozen"], f"train_onebit_bf16 {name}: never froze")
        check(all(c.get("grad-exchange") == dense["grad-exchange"]
                  for c in metas[name]["comm"][:freeze]),
              f"train_onebit_bf16 {name}: the warm steps' exchange is not dense")
    check(all(v <= ONEBIT_ROWS_ATOL for v in errs.values()),
          f"train_onebit_bf16: group rows vs the plain rows {errs}")
    for name in ("flash_fwd", "flash_bwd"):
        check(launches.get(name, 0) > 0, f"train_onebit_bf16: {name} not launched")
    return launches


# train_compose_bf16 (PR 23): the compositions of ZeRO, tensor parallelism,
# offload, the 8-bit state and the explicit exchanges, GPT-2 124M at full
# width and depth, two rank processes sharing the card (gloo)
COMPOSE_STEPS = {"m2_off": 3, "d2_s2_q8": 3, "d2_s2_q8_noclip": 2, "d2_s2_q8_sr": 2,
                 "f2_s2_onebit": 4, "f3_int8": 3}
# GPT-2's vocabulary padded to a multiple of 64, which a model axis of 2
# divides (50257 is refused, as the JAX package refuses it)
COMPOSE_VOCAB = 50304
# {model: 2} + offload against the one-rank offload engine on the same
# batch: each rank computes half the heads and the row-parallel products'
# two bf16 halves are summed by the all-reduce, where one rank's GEMM
# rounds its f32 sum once; every loss, relative.  The card read 1.3e-4;
# the bound about fifteen times that
COMPOSE_TP_LOSS_RTOL = 2e-3
# ZeRO's update slices against the same rows' stage-0 run: the global
# norm's squares are summed by slice, then over the ranks, where those sum
# each leaf whole (the clip factor's last bits), carried through bf16
# weights and, past freeze_step, through 1-bit signs of entries near zero;
# later losses, relative (the first is the same bits).  The card read
# 8.7e-5 (1-bit Adam at {fsdp: 2} stage 2, step 4); the bound about six
# times that
COMPOSE_ZERO_LOSS_RTOL = 5e-4
# the 8-bit state at {data: 2} stage 2 against one rank, rounding to
# nearest.  Without clipping the two are the same bits (losses, masters, m,
# codes and block scales: d2_s2_q8_noclip), which is what holds the block
# layout: a block scale taken over one rank's slice of a block changes its
# codes.  With clipping the clip factor's last bits differ: the first
# step's masters within OFFLOAD_STEP1_REL (|p| + lr) of one rank's (Adam's
# first step is lr * sign(g), the factor moves only its last bits; the
# update does not read the codes yet); from there every bf16 weight that
# rounds the other way moves every later gradient (on an H100 at 700 W
# the masters after step 3 read 99.95 % not the same bits, up to 1.02e-3
# apart), so later
# losses are held within COMPOSE_Q8_LOSS_RTOL (the card read 4.9e-6, about
# a tenth of it)
COMPOSE_Q8_LOSS_RTOL = 5e-5
# each rank's 8-bit state bytes against one rank's: half the m and codes,
# the block scales whole (about 1.6 % of m and codes' bytes)
COMPOSE_Q8_STATE_SHARE = 0.55


def compose_cases(off, root, preset="gpt2", vocab=COMPOSE_VOCAB):
    """train_compose_bf16's cases for the shared spawn: ``{data: 2}`` stage
    2 + the 8-bit state (rounding to nearest; again without clipping; and
    with stochastic rounding, 2 steps), ``{fsdp: 2}`` stage 2 + 1-bit
    Adam past ``freeze_step``, ``{fsdp: 2}`` stage 3 + the int8 exchange,
    and ``{model: 2}`` + offload (the vocabulary padded to ``vocab``, which
    the model axis divides); each rank's rows train_bf16's micro-batches."""
    mb, gas = 8, 2
    b1 = os.path.join(root, "compose_m2_b.npz")
    np.savez(b1, input_ids=np.repeat(off["batch"][None], COMPOSE_STEPS["m2_off"], axis=0))
    b2 = os.path.join(root, "compose_d2_b.npz")
    np.savez(b2, input_ids=np.repeat(_rank_batch(off["batch"], gas, mb, 2)[None], 4, axis=0))

    def case(name, mesh, batches, zero=None, optimizer=None, comm=None, clip=None, **kw):
        config = dict(_gpt2_bf16_config(mb, gas), mesh=mesh)
        if clip is not None:
            config["gradient_clipping"] = clip
        if zero is not None:
            config["zero_optimization"] = zero
        if optimizer is not None:
            kind = optimizer.pop("type", config["optimizer"]["type"])
            config["optimizer"] = {"type": kind,
                                   "params": {**config["optimizer"]["params"], **optimizer}}
        if comm is not None:
            config["comm"] = {"strategy": comm}
        return {"name": name, "preset": preset, "init_seed": 0, "config": config,
                "batches": batches, "steps": COMPOSE_STEPS[name], "record": "none", **kw}

    # the padded vocabulary's case last: the rank processes draw its
    # parameters once, after the earlier cases' (train_bf16's)
    return [case("d2_s2_q8", {"data": 2}, b2, {"stage": 2}, {"state_precision": "8bit"},
                 nearest_rounding=True, record="full", record_step=1),
            case("d2_s2_q8_noclip", {"data": 2}, b2, {"stage": 2}, {"state_precision": "8bit"},
                 clip=0.0, nearest_rounding=True, record="digest"),
            # the default stochastic rounding on the cut leaves
            case("d2_s2_q8_sr", {"data": 2}, b2, {"stage": 2}, {"state_precision": "8bit"},
                 record="digest"),
            case("f2_s2_onebit", {"fsdp": 2}, b2, {"stage": 2},
                 {"type": "OneBitAdam", "freeze_step": ONEBIT_FREEZE}),
            # every leaf sharded (no persistence threshold): stage 3's
            # gathers move what the byte model counts
            case("f3_int8", {"fsdp": 2}, b2, {"stage": 3, "stage3_param_persistence_threshold": 0},
                 comm="int8"),
            case("m2_off", {"model": 2}, b1, {"offload_optimizer": {"device": "cpu"}},
                 model_cfg={"vocab_size": vocab})]


def _compose_one_rank(torch, params, config, batch, steps, nearest=False, vocab=None,
                      masters_after=None):
    """One rank of a composition's reference in this process: ``(losses,
    engine)``, and with ``masters_after`` the f32 masters after that step
    on the host by checkpoint name; ``vocab``: GPT-2 with its vocabulary
    padded to it, drawn here (seed 0, as the rank processes draw it)."""
    from deepspeed_tpu_torch.runtime.engine import tree_items

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.PRESETS["gpt2"]
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
        params = gpt2.init_params(cfg, seed=0)
    engine, *_ = deepspeed_tpu_torch.initialize(model=gpt2.make_model(cfg)[0],
                                                model_parameters=params, config=config)
    if nearest:
        engine._rounding_generator = lambda: None
    losses, masters = [], None
    for s in range(steps):
        losses.append(float(engine.train_batch(batch)))
        if masters_after == s + 1:
            masters = {f"params/{k}": t.detach().to("cpu", torch.float32, copy=True).numpy()
                       for k, t in tree_items(engine.params)}
    return (losses, engine) if masters_after is None else (losses, engine, masters)


def _scale_bytes_model(torch, params, mesh, stage):
    """The 8-bit state's block-scale all-reduce a step (``state-scales``,
    2 x 4 bytes a block: sent and received) over the leaves ``mesh`` and
    ``stage`` cut: the engine's own layout of them, read off the rank-0
    layout in this process (no collective)."""
    from deepspeed_tpu_torch.comm.mesh import Mesh
    from deepspeed_tpu_torch.config.config import ZeroConfig
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
    from deepspeed_tpu_torch.runtime.engine import tree_items
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroLayout
    from deepspeed_tpu_torch.runtime.zero.stages import ZeroShardingRules

    m = Mesh(mesh, rank=0)
    rules = ZeroShardingRules(ZeroConfig.from_dict({"stage": stage}),
                              fsdp_size=m.sizes["fsdp"], data_size=m.sizes["data"])
    items = tree_items(params)
    layout = ZeroLayout(m, rules, [tuple(np.shape(x)) for _, x in items], [k for k, _ in items])
    opt, total = FusedAdam(state_precision="8bit"), 0
    for leaf in layout.leaves:
        n = int(np.prod(leaf.shape))
        b = opt._v_blocks(n)
        if b and (layout.sharded(leaf.opt_spec) or leaf.flat is not None):
            total += 2 * 4 * (n // b)
    return total


def _merge_variants(metas, name):
    out = {}
    for meta in metas.values():
        for k, v in meta["variants"].get(name, {}).items():
            out[k] = out.get(k, 0) + v
    return out


def phase_train_compose_bf16(torch, params, off, smi, root, cases, spawn_wall):
    """The compositions (:func:`compose_cases`, in the rank phases' one
    spawn), train_bf16's config and batch, counters zeroed before each case
    and read after, each against a reference on the same rows:

    * ``{model: 2}`` + ``offload_optimizer: cpu`` (each rank's host Adam
      over its block of every cut leaf, the replicated leaves whole): every
      loss within COMPOSE_TP_LOSS_RTOL of the one-rank offload engine's
      (this process, the same padded vocabulary); ``tp-all-reduce`` bytes
      the model's; each rank's host masters below one rank's, the two
      equal; every replicated leaf the same bits on both ranks; B1 24 and
      B2 12 a micro-step on each rank's 6 heads (the kernel rows ``h6``).
    * ``{data: 2}`` stage 2 + 8-bit state, rounding to nearest: the first
      loss the one-rank 8-bit engine's bits, the rest within
      COMPOSE_Q8_LOSS_RTOL, the masters after step 1 within
      OFFLOAD_STEP1_REL (|p| + lr) (the clip factor's last bits differ);
      without clipping the losses and the whole
      state (masters, m, codes, block scales) one rank's bits; with
      stochastic rounding the first two losses the nearest run's bits (the
      first update reads v before it is encoded) and the state finite;
      ``state-scales`` bytes the cut leaves' blocks a step; each rank's
      state bytes at most COMPOSE_Q8_STATE_SHARE of one rank's.
    * ``{fsdp: 2}`` stage 2 + 1-bit Adam (``freeze_step`` 2, 4 steps): the
      first loss train_onebit_bf16's ``{data: 2}`` stage-0 run's bits, the
      rest within COMPOSE_ZERO_LOSS_RTOL; the compressed steps'
      ``grad-exchange`` bytes the onebit model's.
    * ``{fsdp: 2}`` stage 3 + ``comm.strategy: int8``: the first loss
      train_onebit_bf16's int8 run's bits, the rest within
      COMPOSE_ZERO_LOSS_RTOL; ``grad-exchange`` and stage 3's
      ``all-gather`` bytes the models'; no reduce-scatter; B3 launched."""
    from deepspeed_tpu_torch.comm.strategy import step_comm_bytes
    from deepspeed_tpu_torch.tools.zero_worker import _digest, _record

    t_phase = time.perf_counter()
    metas = {c["name"]: _case_json(root, c["name"]) for c in cases}
    batch = {"input_ids": off["batch"]}
    # -- the references in this process ----------------------------------
    t_ref = time.perf_counter()
    m2_losses, eng = _compose_one_rank(
        torch, None, _offload_config({"offload_optimizer": {"device": "cpu"}}), batch,
        COMPOSE_STEPS["m2_off"], vocab=COMPOSE_VOCAB)
    one_host = eng.host_master_bytes()
    del eng
    q8_cfg = _gpt2_bf16_config(8, 2)
    q8_cfg["optimizer"]["params"] = {**q8_cfg["optimizer"]["params"], "state_precision": "8bit"}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    q8_losses, eng, q8_masters = _compose_one_rank(
        torch, params, q8_cfg, batch, COMPOSE_STEPS["d2_s2_q8"], nearest=True, masters_after=1)
    q8_one = {"state_bytes": eng.optimizer.state_bytes(eng.opt_state),
              "peak_gib_above_live": (torch.cuda.max_memory_allocated() - live) / 2**30}
    del eng
    nc_losses, eng = _compose_one_rank(torch, params, dict(q8_cfg, gradient_clipping=0.0),
                                       batch, COMPOSE_STEPS["d2_s2_q8_noclip"], nearest=True)
    nc_digests = {n: _digest(t) for n, t in _record(eng).items()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_ref
    bit = {c: _case_json(root, c) for c in ("onebit_adam", "comm_int8")}
    # -- gates ---------------------------------------------------------------
    m2, q8, ob, i8 = (metas[k] for k in ("m2_off", "d2_s2_q8", "f2_s2_onebit", "f3_int8"))
    nc, sr = metas["d2_s2_q8_noclip"], metas["d2_s2_q8_sr"]
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]  # noqa: E731
    m2_rel = rel(m2["losses"], m2_losses)
    q8_rel = rel(q8["losses"], q8_losses)
    lr1 = float(gpt2_lr(0))
    moved = counted = 0
    q8_worst = 0.0
    with np.load(os.path.join(root, "d2_s2_q8.npz")) as z:
        for k, want in q8_masters.items():
            want = want.astype(np.float64)
            d = np.abs(z[k].astype(np.float64) - want)
            moved += int((d > 0).sum())
            counted += d.size
            q8_worst = max(q8_worst, float((d / (OFFLOAD_STEP1_REL * (np.abs(want) + lr1))).max()))
    del q8_masters
    nc_same = {k: nc["digests"].get(k) == v for k, v in nc_digests.items()
               if k.startswith(("params/", "opt_state/"))}
    q8_state = q8["state_bytes_by_rank"]
    ob_rel = rel(ob["losses"], bit["onebit_adam"]["losses"])
    i8_rel = rel(i8["losses"], bit["comm_int8"]["losses"])
    n = ob["n_params"]
    grid = {"data": 1, "fsdp": 2}
    ob_model = step_comm_bytes(n, grid, stage=2, gas=2, strategy="onebit")["grad-exchange"]
    i8_model = step_comm_bytes(n, grid, stage=3, gas=2, strategy="int8")["grad-exchange"]
    pad = 2 * (n % 2)
    ob_wire = [c.get("grad-exchange", 0) for c in ob["comm"][ONEBIT_FREEZE:]]
    i8_wire = [c.get("grad-exchange", 0) for c in i8["comm"]]
    scales = _scale_bytes_model(torch, params, {"data": 2}, 2)
    q8_scales = [c.get("state-scales", 0) for c in q8["comm"]]
    sr_scales = [c.get("state-scales", 0) for c in sr["comm"]]
    host = [h["masters"] for h in m2["host_bytes_by_rank"]]
    tp_counted = [c.get("tp-all-reduce", 0) for c in m2["comm"]]
    gas = 2
    want_b1 = {"flash_fwd": 24 * gas * COMPOSE_STEPS["m2_off"],
               "flash_bwd": 12 * gas * COMPOSE_STEPS["m2_off"]}
    m2_b1 = [{k: r.get(k, 0) for k in want_b1} for r in m2["launches_by_rank"]]
    launches = {}
    for meta in metas.values():
        for k, v in _sum_launches(meta).items():
            launches[k] = launches.get(k, 0) + v
    emit({"phase": "train_compose_bf16", "card": smi, "ranks": 2, "micro_batch": 8, "gas": gas,
          "T": 1024, "steps": COMPOSE_STEPS,
          "m2_offload": {"mesh": {"model": 2}, "vocab": COMPOSE_VOCAB, "losses": m2["losses"],
                         "losses_one_rank": m2_losses, "max_rel_diff": max(m2_rel),
                         "tol": COMPOSE_TP_LOSS_RTOL, "first_loss_same_bits":
                         m2["losses"][0] == m2_losses[0],
                         "host_master_bytes_by_rank": host, "host_master_bytes_one_rank": one_host,
                         "tp_all_reduce_bytes": tp_counted,
                         "tp_all_reduce_model": m2["parallel"]["tp-all-reduce"],
                         "replicas_equal": all(m2["replicas_equal"].values()),
                         "b1_b2_launches_by_rank": m2_b1,
                         "offload_breakdown_rank0": m2["offload_breakdown"], **_ranks_row(m2)},
          "d2_s2_8bit": {"mesh": {"data": 2}, "stage": 2, "rounding": "nearest",
                         "losses": q8["losses"], "losses_one_rank": q8_losses,
                         "max_rel_diff": max(q8_rel), "tol": COMPOSE_Q8_LOSS_RTOL,
                         "step1_masters_worst_vs_bound": q8_worst,
                         "step1_bound": f"{OFFLOAD_STEP1_REL} * (|p| + lr)",
                         "step1_masters_moved_share": moved / counted,
                         "state_scales_bytes": q8_scales, "state_scales_model": scales,
                         "state_bytes_by_rank": q8_state,
                         "state_bytes_one_rank": q8_one["state_bytes"],
                         "state_share_tol": COMPOSE_Q8_STATE_SHARE,
                         "one_rank_peak_gib_above_live": q8_one["peak_gib_above_live"],
                         "bytes_a_step_rank0": q8["comm"][-1], **_ranks_row(q8),
                         "no_clipping": {"losses": nc["losses"], "losses_one_rank": nc_losses,
                                         "state_same_bits": all(nc_same.values()),
                                         "tensors_compared": len(nc_same),
                                         "differing": [k for k, v in nc_same.items() if not v]},
                         "stochastic_rounding": {"losses": sr["losses"],
                                                 "state_finite": sr.get("state_finite"),
                                                 "state_scales_bytes": sr_scales,
                                                 **_ranks_row(sr)}},
          "f2_s2_onebit_adam": {"mesh": {"fsdp": 2}, "stage": 2, "freeze_step": ONEBIT_FREEZE,
                                "losses": ob["losses"],
                                "losses_data2_stage0": bit["onebit_adam"]["losses"],
                                "max_rel_diff": max(ob_rel), "tol": COMPOSE_ZERO_LOSS_RTOL,
                                "frozen_at_end": ob["onebit_frozen"],
                                "grad_exchange_bytes_compressed_steps": ob_wire,
                                "model_grad_exchange_bytes": ob_model + pad,
                                "bytes_a_step_rank0": ob["comm"][-1], **_ranks_row(ob)},
          "f3_int8": {"mesh": {"fsdp": 2}, "stage": 3, "losses": i8["losses"],
                      "losses_data2_stage0": bit["comm_int8"]["losses"],
                      "max_rel_diff": max(i8_rel), "tol": COMPOSE_ZERO_LOSS_RTOL,
                      "grad_exchange_bytes": i8_wire, "model_grad_exchange_bytes": i8_model + pad,
                      "all_gather_bytes": [c.get("all-gather", 0) for c in i8["comm"]],
                      "all_gather_model": i8["model"]["all-gather"],
                      "bytes_a_step_rank0": i8["comm"][-1], **_ranks_row(i8)},
          "launches": launches, "references_s": ref_s,
          "shared_spawn_wall_s": spawn_wall, "wall_s": time.perf_counter() - t_phase})
    for name, meta in metas.items():
        check(all(np.isfinite(meta["losses"])), f"train_compose_bf16 {name}: {meta['losses']}")
    check(max(m2_rel) <= COMPOSE_TP_LOSS_RTOL,
          f"train_compose_bf16 m2_off: losses {m2['losses']} vs one rank {m2_losses}")
    check(all(b == m2["parallel"]["tp-all-reduce"] for b in tp_counted),
          f"train_compose_bf16 m2_off: tp-all-reduce {tp_counted} != the model's "
          f"{m2['parallel']['tp-all-reduce']}")
    check(host[0] == host[1] and one_host // 2 < host[0] < one_host,
          f"train_compose_bf16 m2_off: host master bytes {host}, one rank {one_host}")
    check(all(m2["replicas_equal"].values()),
          f"train_compose_bf16 m2_off: replicas differ {m2['replicas_equal']}")
    check(all(r == want_b1 for r in m2_b1),
          f"train_compose_bf16 m2_off: B1/B2 launches by rank {m2_b1}, want {want_b1} each")
    check(q8["losses"][0] == q8_losses[0] and max(q8_rel) <= COMPOSE_Q8_LOSS_RTOL,
          f"train_compose_bf16 d2_s2_q8: {q8['losses']} vs one rank {q8_losses}")
    check(q8_worst <= 1.0,
          f"train_compose_bf16 d2_s2_q8: step-1 masters {q8_worst} x the bound "
          f"({moved} of {counted} moved)")
    check(nc["losses"] == nc_losses and len(nc_same) > 0 and all(nc_same.values()),
          f"train_compose_bf16 d2_s2_q8_noclip: {nc['losses']} vs one rank {nc_losses}, "
          f"differing {[k for k, v in nc_same.items() if not v][:8]}")
    check(sr["losses"][:2] == q8["losses"][:2] and sr.get("state_finite") is True,
          f"train_compose_bf16 d2_s2_q8_sr: {sr['losses']} vs nearest {q8['losses']}, "
          f"finite {sr.get('state_finite')}")
    check(all(b == scales for b in q8_scales + sr_scales),
          f"train_compose_bf16 d2_s2_q8: state-scales {q8_scales} / {sr_scales} != {scales}")
    check(all(b <= COMPOSE_Q8_STATE_SHARE * q8_one["state_bytes"] for b in q8_state),
          f"train_compose_bf16 d2_s2_q8: state bytes {q8_state}, one rank "
          f"{q8_one['state_bytes']}")
    check(ob["losses"][0] == bit["onebit_adam"]["losses"][0] and max(ob_rel)
          <= COMPOSE_ZERO_LOSS_RTOL and ob["onebit_frozen"],
          f"train_compose_bf16 f2_s2_onebit: {ob['losses']} vs {bit['onebit_adam']['losses']}")
    check(all(b == ob_model + pad for b in ob_wire),
          f"train_compose_bf16 f2_s2_onebit: grad-exchange {ob_wire} != {ob_model + pad}")
    check(i8["losses"][0] == bit["comm_int8"]["losses"][0] and max(i8_rel)
          <= COMPOSE_ZERO_LOSS_RTOL,
          f"train_compose_bf16 f3_int8: {i8['losses']} vs {bit['comm_int8']['losses']}")
    check(all(b == i8_model + pad for b in i8_wire),
          f"train_compose_bf16 f3_int8: grad-exchange {i8_wire} != {i8_model + pad}")
    check(all(c.get("all-gather", 0) == i8["model"]["all-gather"] for c in i8["comm"])
          and not any(c.get("reduce-scatter") for c in i8["comm"]),
          f"train_compose_bf16 f3_int8: bytes {i8['comm']} vs {i8['model']}")
    check(_sum_launches(i8).get("fused_adam", 0) > 0,
          "train_compose_bf16 f3_int8: B3 not launched")
    for name in ("flash_fwd", "flash_bwd"):
        check(only_tc(_merge_variants(metas, name)),
              f"train_compose_bf16: {name} ran {_merge_variants(metas, name)}")
    return launches


def run_rank_phases(torch, params, offload_ref, off, inf_losses, sparse_losses, smi):
    """Offload across ranks, the sparse stream and the compressed exchanges:
    the three two-rank phases' cases in one spawn of two rank processes
    (one start-up and one first step's set-up for the three), then each
    phase's gates; the sparse stream in this process."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp()
    try:
        off = dict(off, batch=offload_ref["batch"])
        inf_prep = infinity_ranks_cases(torch, params, off, root)
        bit_cases, rows = onebit_cases(off, root)
        comp_cases = compose_cases(off, root)
        wall = spawn_ranks(root, offload_ranks_cases(off, root) + inf_prep[0] + bit_cases
                           + comp_cases, "rank_phases", extra={"compressed_check": rows},
                           timeout=1000)
        out = {"training_offload_ranks": phase_train_offload_ranks_bf16(
            torch, params, off, offload_ref["losses"], smi, root, wall)}
        out["training_infinity_ranks"] = phase_train_infinity_ranks_bf16(
            torch, params, inf_losses, smi, root, inf_prep, wall)
        out["training_onebit"] = phase_train_onebit_bf16(torch, smi, root, bit_cases, rows, wall)
        out["training_compose"] = phase_train_compose_bf16(torch, params, off, smi, root,
                                                           comp_cases, wall)
        out["training_infinity_sparse"] = phase_train_infinity_sparse_bf16(torch, sparse_losses,
                                                                           smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phases 23-24: the large-model memory recipe and the training extras
# ---------------------------------------------------------------------------

# the JAX package's selective remat for GPT-2 774M (tools/sweep_774m.py's
# SAVE_FLASH): the QKV and FFN projections and the attention kernel's output
# and lse are kept, so the backward runs B2 without relaunching B1
SAVE_FLASH = ("qkv", "ffn_pre", "attn_o", "attn_lse")
LARGE_MB, LARGE_T, LARGE_STEPS = 4, 1024, 3
# the 8-bit run's first-step masters against the f32-state run's: on the
# first step m = v = 0, so both are f32 Adam's update, B3's kernel against
# plain torch ops (each rounding its products and sums on its own)
LARGE_STEP1_BOUND = 2.0 ** -20
# steps 2-3: step 2 follows the one f32-equal update; step 3 the first
# update from the 8-bit v (codes of sqrt(v), 1/255 of a block's largest
# entry).  The card read 1.9e-7 (the same bits in two runs: the rounding
# generator is seeded); the bound is about 50 times that
LARGE_LOSS_RTOL = 1e-5
# train_extras_bf16 (c): bf16 m and stochastically rounded bf16 v against
# train_bf16's f32 state, steps 2-3; the card read 7.7e-6 (the same bits in
# two runs), the bound about 6 times that
EXTRAS_BF16_LOSS_RTOL = 5e-5
EXTRAS_STEPS = 3
# (d): progressive layer drop at train_bf16's model with hidden dropout 0.1
# (the JAX package applies PLD only to a non-deterministic forward)
PLD_THETA, PLD_GAMMA, PLD_DROPOUT = 0.5, 0.001, 0.1
# (e): MoQ from 16 to 8 bits, one bit a period from step 1; the period is
# scaled by an eigenvalue probe of micro 1 x T 256 with plain attention
MOQ = {"enabled": True, "quantize_bits_start": 16, "quantize_bits_target": 8,
       "quantize_schedule_offset": 1}
EIG_MAX_ITER, EIG_T = 10, 256
TILED_TOL = 2e-5  # TiledLinear vs F.linear, f32 (sums in another order)


def _timed_updates(torch, engine):
    """CUDA events around every call of ``engine._update`` (the step's
    optimizer update on the card): a list of event pairs to read later."""
    pairs, update = [], engine._update

    def timed(*args, **kwargs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = update(*args, **kwargs)
        e.record()
        pairs.append((s, e))
        return out

    engine._update = timed
    return pairs


def _large_run(torch, cfg, precision, step1=None):
    """One train_large_q8_bf16 run: GPT-2 774M drawn on the card (seed 0),
    the engine built and stepped LARGE_STEPS times on one batch, the
    counters zeroed before the steps and read after.  Returns the run's
    record and, after step 1, its masters on the host."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    config = _gpt2_bf16_config(LARGE_MB, 1)
    if precision:
        config["optimizer"] = {**config["optimizer"], "params": {
            **config["optimizer"]["params"], "state_precision": precision}}
    batch = {"input_ids": np.random.default_rng(21).integers(
        0, cfg.vocab_size, (LARGE_MB, LARGE_T), dtype=np.int32)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = gpt2.init_params_device(cfg, seed=0, dtype=torch.float32)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.make_model(cfg)[0], model_parameters=params, config=config)
    del params
    upd = _timed_updates(torch, engine)
    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, walls, masters1 = [], [], None
    for s in range(LARGE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        if s == 0:
            masters1 = [p.detach().cpu() for p in engine._params]
    launches, variants = kernels.launches(), kernels.launch_variants()
    # ----------------------------------------------------------------------
    torch.cuda.synchronize()
    rec = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
           "update_ms": [s.elapsed_time(e) for s, e in upd],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": engine.optimizer.state_bytes(engine.opt_state),
           "n_params": sum(p.numel() for p in engine._params),
           "launches": launches, "variants": {n: variants[n] for n in ("flash_fwd", "flash_bwd")},
           "lr_step1": float(engine.lr_schedule(0))}
    if precision == "8bit":
        opt = engine.optimizer
        want = 0
        for p in engine._params:
            n, b = p.numel(), opt._v_blocks(p.numel())
            want += 2 * n + (n + 4 * (n // b) if b else 4 * n + 4)
        rec["state_bytes_from_v_blocks"] = want
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return rec, masters1


def phase_train_large_q8_bf16(torch):
    """The JAX package's ``q8`` recipe (``tools/sweep_774m.py``) on the
    port: GPT-2 774M (36 layers, width 1280, 20 heads) at full depth, micro
    4 x T 1024, ``xent_chunk_size`` 512, AdamW, bf16 over f32 masters.  (a)
    f32 state under ``nothing_saveable``; (b) ``state_precision="8bit"``
    under ``remat_save_names=SAVE_FLASH``.  Gates: (b)'s first loss (a)'s
    bits; step-1 masters within LARGE_STEP1_BOUND * (|p| + lr); steps 2-3
    within LARGE_LOSS_RTOL, finite; B1 36 launches a micro-step in (b), 72
    in (a), B2 36 in both; B3 in (a) only; (b)'s state bytes the count from
    ``_v_blocks``; (b)'s peak below (a)'s."""
    from deepspeed_tpu_torch.models import gpt2

    t_phase = time.perf_counter()
    base = dataclasses.replace(gpt2.PRESETS["gpt2-large"], xent_chunk_size=512)
    runs = {}
    a, a_step1 = _large_run(torch, base, None)
    b, b_step1 = _large_run(torch, dataclasses.replace(base, remat_save_names=SAVE_FLASH),
                            "8bit")
    runs = {"f32_nothing_saveable": a, "8bit_save_flash": b}
    L = base.n_layer
    lr = a["lr_step1"]
    worst = 0.0
    for pa, pb in zip(a_step1, b_step1):
        share = ((pb - pa).abs() / (LARGE_STEP1_BOUND * (pa.abs() + lr))).max().item()
        worst = max(worst, share)
    del a_step1, b_step1
    check(worst <= 1.0, f"train_large_q8_bf16: step-1 masters {worst} of the bound apart")
    check(all(np.isfinite(r["losses"]).all() for r in runs.values()),
          f"train_large_q8_bf16: non-finite loss {a['losses']} / {b['losses']}")
    check(b["losses"][0] == a["losses"][0],
          f"train_large_q8_bf16: first losses differ {b['losses'][0]} / {a['losses'][0]}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"][1:], a["losses"][1:]))
    check(rel <= LARGE_LOSS_RTOL, f"train_large_q8_bf16: later losses {rel} > {LARGE_LOSS_RTOL}")
    micro = LARGE_STEPS  # gas 1
    for label, r, b1 in (("a", a, 2 * L), ("b", b, L)):
        got = (r["launches"]["flash_fwd"], r["launches"]["flash_bwd"])
        check(got == (b1 * micro, L * micro),
              f"train_large_q8_bf16 ({label}): B1/B2 launches {got}, want "
              f"{(b1 * micro, L * micro)}")
        for name in ("flash_fwd", "flash_bwd"):
            check(only_tc(r["variants"][name]),
                  f"train_large_q8_bf16 ({label}): {name} ran {r['variants'][name]}")
    check(a["launches"]["fused_adam"] > 0 and b["launches"]["fused_adam"] == 0,
          f"train_large_q8_bf16: B3 launches {a['launches']['fused_adam']} / "
          f"{b['launches']['fused_adam']} (f32 state / 8-bit state)")
    check(b["state_bytes"] == b["state_bytes_from_v_blocks"],
          f"train_large_q8_bf16: 8-bit state {b['state_bytes']} B, _v_blocks says "
          f"{b['state_bytes_from_v_blocks']}")
    check(a["state_bytes"] == 8 * a["n_params"], f"train_large_q8_bf16: f32 state {a['state_bytes']}")
    check(b["peak_bytes"] < a["peak_bytes"],
          f"train_large_q8_bf16: peak {b['peak_bytes']} not below {a['peak_bytes']}")
    tokens = LARGE_MB * LARGE_T
    emit({"phase": "train_large_q8_bf16", "model": "gpt2-large", "n_layer": L,
          "n_embd": base.n_embd, "micro_batch": LARGE_MB, "T": LARGE_T, "xent_chunk_size": 512,
          "steps": LARGE_STEPS, "save_names": list(SAVE_FLASH),
          "runs": {k: {**v, "peak_gib": v["peak_bytes"] / 2**30,
                       "state_bytes_per_param": v["state_bytes"] / v["n_params"],
                       "tokens_per_s_after_first": tokens / (np.mean(v["step_ms"][1:]) / 1e3)}
                   for k, v in runs.items()},
          "step1_masters_worst_share_of_bound": worst, "step1_bound": LARGE_STEP1_BOUND,
          "later_loss_max_rel": rel, "loss_rtol": LARGE_LOSS_RTOL,
          "phase_s": time.perf_counter() - t_phase})
    return {"training_large_f32": a["launches"], "training_large_q8": b["launches"]}


def _extras_run(torch, model_fn, params, config, batch, steps, count_blocks=False):
    """A train_extras_bf16 run: the counters zeroed before the engine is
    built and read after ``steps`` steps; the peak from before the build.
    ``count_blocks``: also count the blocks the forwards ran
    (``gpt2._run_block``: once a kept block a micro-step)."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks = [0]
    real = gpt2._run_block
    if count_blocks:
        def counted(*args, **kwargs):
            blocks[0] += 1
            return real(*args, **kwargs)
        gpt2._run_block = counted
    try:
        kernels.reset_launches()
        engine, losses, walls = _train(torch, model_fn, params, config, batch, steps)
        launches = kernels.launches()
    finally:
        gpt2._run_block = real
    torch.cuda.synchronize()
    return engine, {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                    "peak_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
                    "blocks_run": blocks[0]}


def phase_train_extras_bf16(torch, params, ref):
    """train_bf16's GPT-2 124M, config and batch (micro 8 x gas 2 x T 1024)
    with the training extras, EXTRAS_STEPS steps a run: (c) bf16 Adam
    state; (d) progressive layer drop (theta PLD_THETA, gamma PLD_GAMMA,
    hidden dropout PLD_DROPOUT), and one forward at theta 0.5; (e) MoQ
    (MOQ) after an eigenvalue probe scales its period, run until the
    updates reach the target bits; (f) ``activation_checkpointing`` with
    ``cpu_checkpointing``; and TiledLinear on the card against
    ``F.linear``."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
    from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = gpt2.PRESETS["gpt2"]
    mb, gas, T = 8, 2, 1024
    base = _gpt2_bf16_config(mb, gas)
    batch = {"input_ids": ref["batch"]}
    out, launches = {}, {}

    def with_opt(**kw):
        return {**base, "optimizer": {**base["optimizer"], "params": {
            **base["optimizer"]["params"], **kw}}}

    # (c) bf16 Adam state
    engine, c = _extras_run(torch, gpt2.make_model(cfg)[0], params, with_opt(
        state_precision="bf16"), batch, EXTRAS_STEPS)
    c["state_bytes_per_param"] = engine.optimizer.state_bytes(engine.opt_state) / cfg.num_params()
    del engine
    rel_c = max(abs(x - y) / abs(y) for x, y in zip(c["losses"][1:], ref["losses"][1:]))
    check(all(np.isfinite(c["losses"])) and c["losses"][0] == ref["losses"][0],
          f"train_extras_bf16 (c): losses {c['losses']} vs {ref['losses']}")
    check(rel_c <= EXTRAS_BF16_LOSS_RTOL,
          f"train_extras_bf16 (c): later losses {rel_c} > {EXTRAS_BF16_LOSS_RTOL}")
    check(c["launches"]["fused_adam"] == 0, "train_extras_bf16 (c): B3 ran on the bf16 state")
    c["later_loss_max_rel"] = rel_c
    out["c_bf16_state"], launches["c"] = c, c["launches"]

    # (d) progressive layer drop
    dcfg = dataclasses.replace(cfg, dropout=PLD_DROPOUT)
    engine, d = _extras_run(torch, gpt2.make_model(dcfg)[0], params, {
        **base, "progressive_layer_drop": {"enabled": True, "theta": PLD_THETA,
                                           "gamma": PLD_GAMMA}}, batch, EXTRAS_STEPS,
        count_blocks=True)
    host = ProgressiveLayerDrop(PLD_THETA, PLD_GAMMA)
    theta = engine.progressive_layer_drop.get_state()["pld_theta"]
    check(theta == host.theta_at(EXTRAS_STEPS)
          == (1 - PLD_THETA) * np.exp(-PLD_GAMMA * EXTRAS_STEPS) + PLD_THETA,
          f"train_extras_bf16 (d): theta {theta} is not the host formula's")
    del engine
    kept = d["blocks_run"]
    check(d["launches"]["flash_fwd"] == 2 * kept and d["launches"]["flash_bwd"] == kept,
          f"train_extras_bf16 (d): B1/B2 {d['launches']['flash_fwd']}/"
          f"{d['launches']['flash_bwd']} for {kept} blocks kept")
    check(all(np.isfinite(d["losses"])), f"train_extras_bf16 (d): losses {d['losses']}")
    # one forward at theta 0.5: B1 once a kept block, the dropped ones skipped
    tree = _device_tree(torch, params, torch.bfloat16, dev)
    kernels.reset_launches()
    counted = [0]
    real = gpt2._run_block

    def count_block(*args, **kwargs):
        counted[0] += 1
        return real(*args, **kwargs)

    gpt2._run_block = count_block
    try:
        with torch.no_grad():
            gpt2.apply(tree, torch.as_tensor(ref["batch"][:mb], device=dev), dcfg,
                       generator=torch.Generator().manual_seed(5), deterministic=False,
                       pld_theta=torch.tensor(0.5))
    finally:
        gpt2._run_block = real
    torch.cuda.synchronize()
    fwd_b1 = kernels.launches()["flash_fwd"]
    del tree
    check(fwd_b1 == counted[0] < cfg.n_layer,
          f"train_extras_bf16 (d): at theta 0.5 {fwd_b1} B1 launches for {counted[0]} kept of "
          f"{cfg.n_layer}")
    d.update({"theta_after": theta, "blocks_kept": kept,
              "blocks_offered": cfg.n_layer * gas * EXTRAS_STEPS,
              "forward_at_theta_0.5": {"blocks_kept": counted[0], "flash_fwd": fwd_b1}})
    out["d_pld"], launches["d"] = d, d["launches"]

    # (e) MoQ after an eigenvalue probe
    pcfg = dataclasses.replace(cfg, use_flash_attention=False, remat=False)
    probe_params = _device_tree(torch, params, torch.float32, dev)
    probe_ids = torch.as_tensor(ref["batch"][:1, :EIG_T], device=dev)
    kernels.reset_launches()
    t_eig = time.perf_counter()
    eig = Eigenvalue(max_iter=EIG_MAX_ITER, tol=1e-2).compute_eigenvalue(
        lambda p: gpt2.loss_fn(p, {"input_ids": probe_ids}, cfg=pcfg, deterministic=True),
        probe_params, generator=torch.Generator().manual_seed(0))
    eig_s = time.perf_counter() - t_eig
    check(np.isfinite(eig) and eig > 0 and sum(kernels.launches().values()) == 0,
          f"train_extras_bf16 (e): eigenvalue {eig}, launches {kernels.launches()}")
    del probe_params
    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.make_model(cfg)[0], model_parameters=params,
        config={**base, "quantize_training": MOQ})
    q = engine.quantizer
    q.scale_period_by_eigenvalue(eig, eig)  # one probe: it is the largest
    losses, walls = [], []
    while q.current_bits(engine.global_steps) > MOQ["quantize_bits_target"] or not losses:
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
    # the last update quantized at the target: one step more at it
    t0 = time.perf_counter()
    losses.append(float(engine.train_batch(batch)))
    walls.append(time.perf_counter() - t0)
    e_launches = kernels.launches()
    bits = q.current_bits(engine.global_steps - 1)
    levels = {}
    for name in ("qkv_w", "proj_w", "fc_w", "fc_proj_w"):
        w = engine.params["blocks"][name]
        levels[name] = max(int(torch.unique(layer).numel()) for layer in w)
    wte_levels = int(torch.unique(engine.params["wte"]).numel())
    del engine
    check(bits == MOQ["quantize_bits_target"] and all(np.isfinite(losses)),
          f"train_extras_bf16 (e): bits {bits}, losses {losses}")
    check(max(levels.values()) <= 2 ** bits,
          f"train_extras_bf16 (e): weights hold {levels} levels a group at {bits} bits")
    out["e_moq"] = {"eigenvalue": eig, "eigenvalue_s": eig_s, "q_period": q.q_period,
                    "steps": len(losses), "losses": losses, "step_ms": [w * 1e3 for w in walls],
                    "bits_last_update": bits, "levels_per_group_max": levels,
                    "wte_distinct": wte_levels, "launches": e_launches}
    launches["e"] = e_launches

    # (f) activation checkpointing with cpu_checkpointing
    engine, f = _extras_run(torch, gpt2.make_model(cfg)[0], params, {
        **base, "activation_checkpointing": {"cpu_checkpointing": True}}, batch, EXTRAS_STEPS)
    del engine
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as act_ckpt

    act_ckpt.configure(checkpoint_in_cpu=False)  # later phases build no engine to reset it
    check(f["losses"][0] == ref["losses"][0] and all(np.isfinite(f["losses"])),
          f"train_extras_bf16 (f): losses {f['losses']} vs {ref['losses']}")
    check(f["peak_bytes"] < ref["peak_bytes"],
          f"train_extras_bf16 (f): peak {f['peak_bytes']} not below train_bf16's "
          f"{ref['peak_bytes']}")
    f["peak_below_train_bf16_bytes"] = ref["peak_bytes"] - f["peak_bytes"]
    out["f_cpu_checkpointing"], launches["f"] = f, f["launches"]

    # TiledLinear on the card against F.linear
    gen = torch.Generator(device=dev).manual_seed(0)
    tl = TiledLinear(cfg.n_embd, 4 * cfg.n_embd, in_splits=3, out_splits=4, seed=0, device=dev)
    w = torch.randn(cfg.n_embd, 4 * cfg.n_embd, generator=gen, device=dev) * 0.02
    bias = torch.randn(4 * cfg.n_embd, generator=gen, device=dev)
    tl.copy_params_from(w, bias)
    x = torch.randn(mb * T // 2, cfg.n_embd, generator=gen, device=dev)
    tiled_err = (tl(x) - torch.nn.functional.linear(x, w.t(), bias)).abs().max().item()
    check(tiled_err <= TILED_TOL, f"train_extras_bf16: TiledLinear {tiled_err} > {TILED_TOL}")
    del tl, x

    for k in ("c_bf16_state", "d_pld", "f_cpu_checkpointing"):
        out[k]["peak_gib"] = out[k]["peak_bytes"] / 2**30
        out[k]["step_ms_mean_after_first"] = float(np.mean(out[k]["step_ms"][1:]))
    emit({"phase": "train_extras_bf16", "micro_batch": mb, "gas": gas, "T": T,
          "train_bf16_losses": ref["losses"], "train_bf16_peak_gib": ref["peak_bytes"] / 2**30,
          **out, "tiled_linear_max_err": tiled_err, "tiled_tol": TILED_TOL,
          "loss_rtol": EXTRAS_BF16_LOSS_RTOL, "phase_s": time.perf_counter() - t_phase})
    total = {}
    for lc in launches.values():
        for name, n in lc.items():
            total[name] = total.get(name, 0) + n
    return {"training_extras": total}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs the port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.models import bert, gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import paged_request_mix, request_mix

    # a reference states its float32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    # the serving phases need the forward and decode kernels only: they run
    # as soon as those are built, while the rest (the backward, optimizer
    # and block-sparse sources, the slowest) builds in the background,
    # joined before serve_paged_bf16 (whose telemetry comparison runs with
    # no compile beside it) and the kernel checks; each phase's line notes
    # its seconds beside the compile
    units = list(kernels.KERNELS) + list(kernels.BODIES)
    first = [n for n in units if n.startswith(("flash_fwd", "flash_decode"))]
    rest_build = BackgroundBuild(kernels, [n for n in units if n not in first])
    seconds = kernels.build(first, force=True)
    first_wall = time.perf_counter() - t0

    cfg = gpt2.PRESETS["gpt2"]
    params = gpt2.init_params(cfg, seed=0)
    reqs = request_mix(seed=0)
    phase_serve_f32(torch, params, reqs)
    serve_launches, served = phase_serve_bf16(torch, params, reqs)
    mix = paged_request_mix(seed=0)
    phase_serve_paged_f32(torch, params, mix)
    tiers_launches = phase_serve_tiers_bf16(torch)
    resilience_launches = phase_serve_resilience_bf16(torch)
    fleet_launches = phase_serve_fleet_bf16(torch)
    frontdoor_launches = phase_serve_frontdoor_bf16(torch)
    injected_launches, neo_bf16, neo_standin, neo_solo = phase_serve_injected_bf16(torch)
    int8_launches = phase_serve_int8_bf16(torch, neo_bf16, neo_standin, neo_solo)
    del neo_bf16, neo_standin, neo_solo
    gc.collect()
    torch.cuda.empty_cache()
    megatron_launches = phase_serve_megatron_bf16(torch)
    torch.cuda.empty_cache()

    seconds.update(rest_build.wait())
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in kernels.library().build_log.items()}
    emit({"phase": "build", "nvcc_s": seconds, "wall_s": first_wall,
          "rest_wall_s": rest_build.wall_s, "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False, "ptxas": ptxas})
    paged_launches, served["paged"] = phase_serve_paged_bf16(torch, params, mix)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    check_flash_fwd(torch, dev, flush)
    fwd_train = check_flash_fwd_training(torch, dev, flush)
    tc_rows = check_flash_tc_dims(torch, dev, flush)
    torch.cuda.empty_cache()
    dec_rows = check_flash_decode(torch, dev, flush)
    paged_rows = check_flash_decode_paged(torch, dev, flush)
    bwd_rows = check_flash_bwd(torch, dev, flush)
    adam_rows = check_fused_adam(torch, dev, flush)
    bias_rows = check_flash_bias(torch, dev, flush)
    lamb_rows = check_fused_lamb(torch, dev, flush)
    drop_rows = check_flash_dropout(torch, dev, flush)
    fbias_rows = check_flash_fbias(torch, dev, flush)
    torch.cuda.empty_cache()
    long_rows = check_flash_bwd2(torch, dev, flush)
    torch.cuda.empty_cache()
    splash_rows = check_splash(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    phase_train_f32(torch, params)
    train_launches, train_step_ms, one_process = phase_train_bf16(torch, params)
    resume_launches = phase_train_resume_bf16(torch, params, train_step_ms)
    import shutil
    import tempfile

    serve_tag = tempfile.mkdtemp()
    try:
        zero_launches, tp_seq = phase_train_zero_bf16(torch, one_process, serve_tag)
        offload_ref = {k: one_process[k] for k in ("losses", "peak_bytes", "step1_masters", "batch")}
        del one_process
        serve_tp_launches = phase_serve_tp_bf16(torch, serve_tag, served)
    finally:
        shutil.rmtree(serve_tag, ignore_errors=True)
    tp_seq_launches = phase_train_tp_seq_bf16(torch, dev, tp_seq)
    del params
    bert_params = bert.init_params(bert.BERT_LARGE, seed=0)
    phase_train_bert_f32(torch, bert_params)
    bert_launches = phase_train_bert_bf16(torch, bert_params)
    phase_train_bert_drop_f32(torch, bert_params)
    drop_launches = phase_train_bert_drop_bf16(torch, bert_params)
    del bert_params
    torch.cuda.empty_cache()
    resume_bert_launches = phase_train_resume_bert_drop_bf16(torch)
    layer_launches = phase_transformer_layer(torch, dev)
    torch.cuda.empty_cache()
    phase_train_sparse_f32(torch)
    sparse_launches, sparse_losses = phase_train_sparse_bf16(torch)
    torch.cuda.empty_cache()
    moe_params = gpt2.init_params(_moe_cfg(), seed=0)
    moe_train_launches = phase_train_moe_bf16(torch, moe_params)
    moe_serve_launches = phase_serve_moe_bf16(torch, moe_params)
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()
    pipe_launches = phase_train_pipe_bf16(torch)
    gc.collect()
    torch.cuda.empty_cache()
    offload_params = gpt2.init_params(cfg, seed=0)
    offload_launches, off, inf_losses = run_offload_phases(torch, offload_params, offload_ref, smi)
    gc.collect()
    torch.cuda.empty_cache()
    offload_launches.update(run_rank_phases(torch, offload_params, offload_ref, off, inf_losses,
                                            sparse_losses, smi))
    del off
    gc.collect()
    torch.cuda.empty_cache()
    offload_launches.update(phase_train_large_q8_bf16(torch))
    offload_launches.update(phase_train_extras_bf16(torch, offload_params, offload_ref))
    del offload_ref, offload_params
    by_path = {name: {"serving": serve_launches[name], "serving_paged": paged_launches[name],
                      "serving_tp": serve_tp_launches.get(name, 0),
                      "serving_tiers": tiers_launches[name],
                      "serving_resilience": resilience_launches.get(name, 0),
                      "serving_fleet": fleet_launches.get(name, 0),
                      "serving_frontdoor": frontdoor_launches.get(name, 0),
                      "serving_injected": injected_launches.get(name, 0),
                      "serving_int8": int8_launches.get(name, 0),
                      "serving_megatron": megatron_launches.get(name, 0),
                      "training": train_launches[name], "training_resume": resume_launches[name],
                      "training_zero": zero_launches.get(name, 0),
                      "training_tp_seq": tp_seq_launches.get(name, 0),
                      "training_bert": bert_launches[name],
                      "training_resume_bert": resume_bert_launches[name],
                      "training_bert_dropout": drop_launches[name],
                      "transformer_layer": layer_launches[name],
                      "training_sparse": sparse_launches[name],
                      "training_moe": moe_train_launches.get(name, 0),
                      "serving_moe": moe_serve_launches.get(name, 0),
                      "training_pipe": pipe_launches.get(name, 0),
                      **{path: launches.get(name, 0) for path, launches in offload_launches.items()}}
               for name in serve_launches}

    # the main-path shapes: the GPT-2 training step's bf16 attention (B=8,
    # H=12, T=1024, d=64: B1 with lse, B2), the bf16 pool's decode (8 slots
    # x 1024 positions), the bf16 paged pool's decode (8 slots x 8 pages of
    # 128), one step's fused Adam over GPT-2 124M's 16 leaves and one step's
    # fused LAMB over BERT-large's 26 leaves (no bias correction, as the
    # main path), B6a and B6b at one bf16 sequence of 9,216 (B=1, H=16, a
    # key-padding bias, dropout 0.1).  B1 and B2 also carry their rows at
    # the BERT main paths' shape (bf16, B=8, H=16, T=512): the key-padding
    # bias under "kbias", with dropout 0.1 under "kbias_dropout" (this
    # slice's main path), the (B, 1, T, T) mask with dropout under "fbias".
    bwd = next(r for r in bwd_rows if r["T"] == 1024 and r["dtype"] == "bfloat16")
    # d 64's tensor-core rows are the training shape's
    tc_rows.update({("flash_fwd", 64): fwd_train, ("flash_bwd", 64): bwd})
    dec = next(r for r in dec_rows if r["kv"] == "bfloat16" and not r["masked"])
    paged = next(r for r in paged_rows if r["kv"] == "bfloat16")
    adam = next(r for r in adam_rows if r["leaves"] == "step_16_leaves")
    lamb = {r["kernel"]: r for r in lamb_rows
            if r["leaves"] == "step_26_leaves" and not r["bias_correction"]}
    report = kernels.kernels_report()
    entries = []
    for name, row, replaces in (
        ("flash_fwd", fwd_train, "deepspeed_tpu/ops/attention/flash_attention.py:237"),
        ("flash_decode", dec, "deepspeed_tpu/ops/kernels/flash_decode.py:88"),
        ("flash_decode_paged", paged, "deepspeed_tpu/ops/kernels/flash_decode.py:277"),
        ("flash_bwd", bwd, "deepspeed_tpu/ops/attention/flash_attention.py:607"),
        ("fused_adam", adam, "deepspeed_tpu/ops/kernels/fused_update.py:125"),
        ("fused_lamb_dir", lamb["fused_lamb_dir"], "deepspeed_tpu/ops/kernels/fused_update.py:214"),
        ("fused_lamb_apply", lamb["fused_lamb_apply"],
         "deepspeed_tpu/ops/kernels/fused_update.py:231"),
        ("flash_bwd_dq", long_rows[("flash_bwd_dq", "bfloat16")],
         "deepspeed_tpu/ops/attention/flash_attention.py:480"),
        ("flash_bwd_dkv", long_rows[("flash_bwd_dkv", "bfloat16")],
         "deepspeed_tpu/ops/attention/flash_attention.py:538"),
        ("splash_fwd", splash_rows[("splash_fwd", SPARSE_TS[0], "bfloat16")],
         "deepspeed_tpu/ops/attention/sparse.py:581"),
        ("splash_bwd_dq", splash_rows[("splash_bwd_dq", SPARSE_TS[0], "bfloat16")],
         "deepspeed_tpu/ops/attention/sparse.py:726"),
        ("splash_bwd_dkv", splash_rows[("splash_bwd_dkv", SPARSE_TS[0], "bfloat16")],
         "deepspeed_tpu/ops/attention/sparse.py:836"),
    ):
        entry = {
            "name": name, "route": "cuda",
            # B1/B2/B6/B9: the main paths' bf16 body; the f32 body beside it
            "source": report[name].get("tc_source", report[name]["source"]),
            "replaces": replaces, "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name], "max_abs_err": row["max_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }
        if "tc_source" in report[name]:
            entry["f32_source"] = report[name]["source"]
        keys = ("B", "H", "T", "max_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        for label, rows_of in (("kbias", bias_rows), ("kbias_dropout", drop_rows),
                               ("fbias", fbias_rows)):
            row = rows_of.get((name, "bfloat16"))
            if row is not None:
                entry[label] = {key: row[key] for key in keys}
        for d in sorted((*TC_DIMS, 64)):  # B1/B2's tensor-core body at every head dim
            row = tc_rows.get((name, d))
            if row is not None:
                entry[f"d{d}"] = {key: row[key] for key in ("d", *keys)}
        row = tc_rows.get((name, f"h{TP_TRAIN_HEADS}"))
        if row is not None:  # a tensor-parallel rank's heads (train_compose_bf16)
            entry[f"h{TP_TRAIN_HEADS}"] = {key: row[key] for key in ("d", *keys)}
        if name in ("flash_bwd_dq", "flash_bwd_dkv"):  # the pair at GPT-2's shape, beside B2
            entry["gpt2_pair"] = {key: long_rows["gpt2"][key] for key in (
                "B", "H", "T", "max_err", "kernel_ms", "flash_bwd_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
        rank_rows = {"flash_decode": [r for r in dec_rows if r["H"] != 12],
                     "flash_decode_paged": [r for r in paged_rows if r["H"] != 12]}
        for row in rank_rows.get(name, []):  # a tensor-parallel rank's heads (serve_tp_bf16)
            entry[f"h{row['H']}"] = {key: row[key] for key in (
                "B", "H", "d", "max_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
        for T in SPARSE_TS[1:]:  # the splash kernels' rows at the longer length
            row = splash_rows.get((name, T, "bfloat16"))
            if row is not None:
                entry[f"T{T}"] = {key: row[key] for key in (
                    "B", "H", "T", "max_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
        entries.append(entry)
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
