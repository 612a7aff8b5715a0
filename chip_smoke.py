#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: compile every CUDA kernel of the serving and training paths
   from ``deepspeed_tpu_torch/csrc`` with ``nvcc`` (one process per source,
   all started together).
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
   memory and model-FLOPs utilization.
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
   and B5 launched (``serving_tp``); an ``init_on_device`` engine holds
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
   restored rows must equal the spilled ones bit for bit.
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
   slot-pool replicas, 24 requests, one replica killed mid-decode (rc -9,
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
16. ``kernels``: one entry per kernel with its launches on each main path
   (B1, B2, B6a, B6b, B8, B9a and B9b: the tensor-core body's source, the
   f32 body's beside it)
   (``launches_by_path``: serving, serving_paged, serving_tp, serving_tiers,
   serving_resilience, serving_fleet, serving_frontdoor, training,
   training_resume, training_zero, training_tp_seq, training_bert, training_resume_bert,
   training_bert_dropout, transformer_layer, training_sparse) and their
   sum.

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


def emit(obj) -> None:
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
        emit({"phase": "serve_paged_bf16", "requests": len(done) + len(turns),
              "paged": out["paged"], "slot": out["slot"], "kvcache": kv,
              "tokens_saved": kv["tokens_saved"],
              "prefill_chunks_saved": out["slot"]["prefill_chunks"] - out["paged"]["prefill_chunks"],
              "spill_restore": {"files": files, "restored_rows": hit, "leaves": sorted(before),
                                "dtype": str(before["k"].dtype)},
              "launches": launches})
        del srv, pool
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
    slot-pool replicas (4 slots x 1024 positions, chunks of 64), 24
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
    causal, at GPT-2's width and training shape: B 8, T 1024, H = 768 / d.
    Out within 2e-2 and lse within 1e-4 of the plain version, the
    gradients (the kernel's and the plain version's) within the float64
    bound (:func:`_bwd_fields`); each launch counted as ``tc``.  Library:
    SDPA (causal) and its backward by autograd."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, T = 8, 1024
    rows = {}
    for d in TC_DIMS:
        H = 768 // d
        g = torch.Generator(device=dev).manual_seed(2000 + d)
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
              f"d={d}: bf16 launches ran {variants['flash_fwd']} / {variants['flash_bwd']}")
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, True, scale)
        err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
        del ref
        check(torch.isfinite(out).all().item(), f"flash_fwd tc d={d}: non-finite output")
        check(err <= TOL["bfloat16"], f"flash_fwd tc d={d}: max_err {err}")
        check(lse_err <= 1e-4, f"flash_fwd tc d={d}: lse max_err {lse_err} > 1e-4")
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, True, scale)
        fields = _bwd_fields(fa, got, refb, (q, k, v, do, lse, delta, True, scale),
                             f"flash_bwd tc d={d}")
        del refb
        torch.cuda.empty_cache()
        pairs = T * (T + 1) / 2
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * 2 + B * H * T * 4, 4 * B * H * d * pairs,
                                "bfloat16")
        rows[("flash_fwd", d)] = {
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
        rows[("flash_bwd", d)] = {
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
        emit(rows[("flash_fwd", d)])
        emit(rows[("flash_bwd", d)])
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
    del runs, outs_a, outs_b
    torch.cuda.empty_cache()
    emit(row)
    return row


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
    _first_step_bits(torch, gpt2.make_model(cfg)[0], params, config, batch)
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
    emit({"phase": "train_bf16", "micro_batch": mb, "gas": gas, "T": T, "steps": steps,
          "losses": losses, "step_ms": [w * 1e3 for w in walls], "step_ms_mean_after_first": step_s * 1e3,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "variants": {n: variants[n] for n in ("flash_fwd", "flash_bwd")},
          "global_steps": engine.global_steps})
    one_process = {"losses": losses, "batch": batch["input_ids"],
                   "digests": _state_digests(torch, engine),
                   "launches": launches, "step_ms_median": float(np.median(walls[1:])) * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del engine
    torch.cuda.empty_cache()
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
                  "max_new_tokens": GEN_NEW}]},
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

    slot, paged, gen_d = tp1["drives"]
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
    for d in tp1["drives"]:
        check(not d["comm"], f"serve_tp_bf16: {d['kind']} counted {d['comm']} bytes at one rank")
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
    return total


# ---------------------------------------------------------------------------

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
    seconds = kernels.build(force=True)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in kernels.library().build_log.items()}
    emit({"phase": "build", "nvcc_s": seconds, "wall_s": time.perf_counter() - t0,
          "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False, "ptxas": ptxas})

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

    cfg = gpt2.PRESETS["gpt2"]
    params = gpt2.init_params(cfg, seed=0)
    reqs = request_mix(seed=0)
    phase_serve_f32(torch, params, reqs)
    serve_launches, served = phase_serve_bf16(torch, params, reqs)
    mix = paged_request_mix(seed=0)
    phase_serve_paged_f32(torch, params, mix)
    paged_launches, served["paged"] = phase_serve_paged_bf16(torch, params, mix)
    tiers_launches = phase_serve_tiers_bf16(torch)
    resilience_launches = phase_serve_resilience_bf16(torch)
    fleet_launches = phase_serve_fleet_bf16(torch)
    frontdoor_launches = phase_serve_frontdoor_bf16(torch)
    phase_train_f32(torch, params)
    train_launches, train_step_ms, one_process = phase_train_bf16(torch, params)
    resume_launches = phase_train_resume_bf16(torch, params, train_step_ms)
    import shutil
    import tempfile

    serve_tag = tempfile.mkdtemp()
    try:
        zero_launches, tp_seq = phase_train_zero_bf16(torch, one_process, serve_tag)
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
    sparse_launches = phase_train_sparse_bf16(torch)
    by_path = {name: {"serving": serve_launches[name], "serving_paged": paged_launches[name],
                      "serving_tp": serve_tp_launches.get(name, 0),
                      "serving_tiers": tiers_launches[name],
                      "serving_resilience": resilience_launches.get(name, 0),
                      "serving_fleet": fleet_launches.get(name, 0),
                      "serving_frontdoor": frontdoor_launches.get(name, 0),
                      "training": train_launches[name], "training_resume": resume_launches[name],
                      "training_zero": zero_launches.get(name, 0),
                      "training_tp_seq": tp_seq_launches.get(name, 0),
                      "training_bert": bert_launches[name],
                      "training_resume_bert": resume_bert_launches[name],
                      "training_bert_dropout": drop_launches[name],
                      "transformer_layer": layer_launches[name],
                      "training_sparse": sparse_launches[name]}
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
