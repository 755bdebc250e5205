#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``deepspeed_tpu_torch``) on one
NVIDIA GPU: builds the port's CUDA kernels and its host C++ Adam from
this checkout, holds each kernel against its plain PyTorch version,
times it, serves GPT-2 125M (ring, paged and speculative; from a
training checkpoint; through the replica fleet and disaggregated
tiers; at model 2), trains GPT-2 350M and BERT-Large with block-sparse
attention, GPT-2 1.5B under ZeRO-Offload, GPT-2 350M through a 4-stage
pipeline (also at ZeRO 3 and under offload) and at model 2, the TP
pipeline at pipe 2 x model 2, ring and Ulysses attention at seq 2, the
SP pipeline at pipe 2 x seq 2, GPT-2 MoE 350M at expert 2, the TP x
expert pipeline at pipe 2 x model 2 x expert 2, and the gradient
compressors (the int8 all-reduce and 1-bit Adam at data 2, 1-bit Adam
through the pipeline at pipe 2 x data 2 and pipe 2 x model 2 x data 2),
BERT-Large at model 2 on the sparse and flash cores, GPT-2 with
``scan_layers`` and ``loss_chunk`` at model 2 in training and serving,
the training engine's resilience (guards, the hot tier, preemption
and the restore ladder), and telemetry on the training step (spans, the
trace window, the hang watchdog and the kernel build cache), at full
width through the port's main paths.

    python3 chip_smoke.py                 # every phase (one GPU)
    python3 chip_smoke.py --kernels-only  # device, build, kernel checks
    python3 chip_smoke.py --offload-only  # device, build, phases 17-19
    python3 chip_smoke.py --zero-only     # device, build, phase 13
    python3 chip_smoke.py --features-only # device, build, phases 13a
                                          # and 16a
    python3 chip_smoke.py --pipe-only     # device, build, phase 20
    python3 chip_smoke.py --tp-only       # device, build, phases 21-24
    python3 chip_smoke.py --sp-moe-only   # device, build, phases 25-28
    python3 chip_smoke.py --moe-faults    # device, build, phase 27 with
                                          # planted faults
    python3 chip_smoke.py --comm-only     # device, build, phases 29-32
    python3 chip_smoke.py --f5-faults     # device, build, phases 31-32
                                          # with planted faults
    python3 chip_smoke.py --phases train_zero,train_tp
                                          # device, build, the named
                                          # phase_<name>(torch) phases
    python3 chip_smoke.py --phases train_bert_tp,train_tp_scan,serve_tp_scan,train_resilience
                                          # the F6 and resilience phases
                                          # (train_tp_scan runs in
                                          # train_tp's world, serve_tp_
                                          # scan in serve_tp's)
    python3 chip_smoke.py --phases train_telemetry
                                          # telemetry on the training
                                          # step (phase 35)
    python3 chip_smoke.py --serving-only  # device, build, phases 14
                                          # and 9a-9c
    python3 chip_smoke.py --turns DIR     # device, build, then K1-K8
                                          # against the checkout at DIR
                                          # (the parent commit's), in turns

Phases, each printing one JSON line:

1. ``device``  — ``nvidia-smi`` name and power limit (also printed as
   its own line), torch and CUDA versions.
2. ``build``   — every kernel built from ``deepspeed_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source and ``g++ -fopenmp`` for the host
   Adam ``cpu_adam.cpp``, all started together); seconds, the
   ``ptxas`` register/shared-memory report, and the count of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in the SASS of the
   bf16 K1, K2 and K3 functions (head dim 64 and 128): no ``HGMMA``
   fails; the count of ``HMMA`` (mma.sync TF32) instructions in the SASS
   of each of the 144 K7 / K8a / K8b instances (``block_sparse_hmma``: 3
   kinds x f32/bf16/fp16 x 4 blocks x head-dim bounds 64/128/256 and the
   256 one that holds the column chunks' code for heads past 256, from
   the block-sparse source's six builds, one per storage type and part:
   forward, backward), none fails, and their registers and spills from
   ``ptxas -v``
   (``block_sparse_ptxas``; a K7 instance that spills fails).
3. ``kernel_check`` — the CUDA ``flash_decode`` against
   ``flash_decode_reference`` on the card: B=8, S=512, H=12/D=64 and
   H=16/D=96 (plus H=4/D=256), positions {0, 63, 127, 128, 300, 511}
   and random ones, storage bf16/f32/int8/f8e4m3fn/f8e5m2 under bf16
   and f32 queries; a poisoned-tail bitwise check per storage dtype;
   head dims 320 and 512 (column chunks of 256) on bf16 and int8
   caches; then the serve CLI's ``gpt2_tiny`` engine's shape as the
   process fleet runs it (B=2, S=32, H=4/D=8, f32 storage and queries,
   block_k 32) at three position pairs, each with the poisoned tail.
4. ``paged_kernel_check`` — the CUDA ``flash_decode_paged`` (K6)
   against ``flash_decode_paged_reference`` on the card: B=8, page
   size 128, 4 pages a row (S=512), H=12/D=64 and H=16/D=96 (plus
   H=4/D=256, and D 320 / 512 on bf16 and int8 pools), positions {0,
   127, 128, 255, 300, 511} and random ones,
   shuffled page tables, the five storage dtypes under bf16 and f32
   queries; per storage dtype, table entries past each row's occupancy
   pointed at a poisoned trash page and then at an out-of-range id
   (both bitwise equal to the clean run), and K6 over an in-order table
   against K5 over the same bytes laid out as a ring (bitwise; a gate);
   then per storage dtype the same three checks at positions on the
   kernels' 128-key chunk edges (127, 128, 255, 256, 511), rows live in
   chunk 0 only, a negative position and one past S; then the serve
   CLI's ``gpt2_tiny`` paged engine's shape as the process tiers run it
   (B=2, H=4/D=8, f32, page size 8, 4 pages a row, block_k 8) at three
   position pairs, each with the poisoned tail.
5. ``kernel_timing`` — median CUDA-event time per call of the kernel,
   of its plain version and of ``F.scaled_dot_product_attention`` on
   the bf16 cache (a yardstick only; the port never calls it), against
   the bound of moving the occupied cache once at the card's HBM rate.
6. ``paged_kernel_timing`` — the same for K6 over 12 layer pools at
   the paged serve stream's positions, beside its plain version, its
   bound (the occupied keys' bytes, scales and table entries at the
   HBM rate) and ``F.scaled_dot_product_attention`` over the pool
   already gathered into a bf16 ring view (the gather not timed; a
   yardstick only).
7. ``serve``   — GPT-2 125M (bf16, seeded random params) served through
   ``InferenceEngine`` + ``ContinuousBatchingScheduler`` with flash
   decode, once with a bf16 and once with an int8 KV cache: a warmup
   request, then 24 requests (prompts 8-120 tokens, 32 new tokens,
   one arrival per decode step). Checks: every request completes,
   ``compile_counts() == {"prefill": 1, "decode": 1}``, the kernel ran
   n_layer times per decode step (K6 never), and teacher-forced decode
   logits of the flash engine match a dense engine on the same params;
   in f32 (bf16 row), 8 requests' greedy streams of the ``scan_layers``
   model (the same weights stacked, a stacked ring cache) equal the
   unrolled model's, with as many K5 launches.
8. ``serve_paged`` — the same model on the paged pool (page size 128,
   33 pages) with flash decode, bf16 and int8 KV: a warmup request, 24
   requests of a shared 256-token system prompt plus 8-120 tokens of
   their own (32 new tokens, one arrival per decode step), the first 4
   with a ``session_id``, then 4 follow-ups extending those sessions;
   host park threshold 0.9 sends every parked session to host RAM.
   Checks: every request completes, 2 programs, K6 n_layer times per
   decode step and K5 never, prefix hits, skipped prefill chunks and
   pages paged back in; teacher-forced logits of the paged flash engine
   against a paged dense and a ring flash engine; in f32, 8 requests'
   greedy streams paged == ring, and the ``scan_layers`` model's paged
   streams == the unrolled one's (as many K6 launches). Reports tokens/s, latency, peak memory
   and cache bytes per session, paged against ring.
9. ``serve_speculative`` — the paged flash engine with self-speculative
   decoding (k 4, 6 draft layers, greedy): 3 programs with decode at 0,
   K6 6 times per draft call, at least one token per live row per round;
   in f32, 8 requests' streams equal the plain paged engine's, and the
   ``scan_layers`` model's (its draft the stack's first 6 layers) equal
   them too, with 3 programs. Reports rounds, mean accepted tokens per
   row-round and tokens/s.
9a. ``serve_checkpoint`` — GPT-2 125M trained one step through
   ``initialize`` (bf16), saved with ``save_checkpoint``, served by
   ``serve --checkpoint --n-head 12`` (ring, int8 KV, flash decode K5,
   the serving row's batch, buckets and chunk): the greedy streams equal
   an engine's built straight from the training engine's fp32 params,
   bit for bit; 2 programs; K5 n_layer times a decode step, K6 never.
9b. ``serve_fleet`` — the fleet router over two thread replicas (one
   CUDA stream each) of GPT-2 125M in the serving row's paged
   configuration (int8 KV, flash decode K6), replica 0 killed after its
   4th decode step; then two ``fleet_worker.py`` processes at the serve
   CLI's width (``gpt2_tiny``, n_embd 32, flash decode K5) on the card,
   worker 0 SIGKILLed at decode step 3. Checks: one replica dead,
   requests redispatched, every stream equal to the one-engine stream
   of the same weights bit for bit, each survivor holding 2 programs,
   K6 n_layer times a thread replica's decode call, the surviving
   worker's K5 n_layer times its decode step (its counts from its
   ``stats``). Reports the router's latency percentiles and tokens/s
   per replica.
9c. ``serve_disagg`` — ``DisaggCoordinator`` with the device handoff
   store at GPT-2 125M (paged, int8 KV, flash decode K6 on the decode
   tier), each park and install timed on the card; then the same tiers
   as two ``TierThreadReplica`` threads (a CUDA stream each, so each
   handoff crosses streams) under ``DisaggRouter``; then ``serve
   --disaggregate`` with a prefill and a decode process at the CLI's
   width and the file store. Checks: streams equal the colocated
   engine's, each tier holds its one program, K6 n_layer times a decode
   step. Reports the handoff's bytes and ms per request.
10. ``train_kernel_check`` — first one 64 x N x K bf16 product through
   the tensor-core kernels' TMA loads and wgmma forms (K-major and
   MN-major B, N and K 64 and 128) against ``torch.matmul`` in fp32;
   then flash attention K1 (out, lse), K2 (dq) and K3 (dk, dv, dbias
   partials) against their plain versions on the card: B 2-8, T
   128/1000/1024, H 16, D 64 and 128, bf16 (on the tensor cores) and
   f32, causal and not, the offload phases' shapes (B 4, T 1024, D 64,
   bf16, causal: H 25 for GPT-2 1.5B, H 12 for 125M), with and without a key bias, dropout 0 and 0.1
   at a nonzero head offset, q/k/v as views of one fused tensor and
   once as three tensors; bf16 off TMA's rule (D 36, and views one
   element into their storage) on the FMA kernels; head dims 160 and 256
   in f32, bf16 and fp16 (causal, key bias, dropout 0.1) on the FMA
   kernels, and 320 and 512 (column chunks of 256; causal with a key
   bias and dropout, and plain); every case checks the route each
   kernel took; the K1 dropout mask read back
   bitwise against ``dropout_multiplier`` (f32; on bf16 its zeros);
   fused Adam K4 against its plain version over 3 steps and a skipped
   one, both modes, leaves of odd sizes.
11. ``train_kernel_timing`` — CUDA-event ms per call of K1, K2, K3 at the
   training shape (B 8, T 1024, H 16, D 64, bf16, causal) and of K4
   over GPT-2 350M's 292 leaves, beside their plain versions, their
   bounds and the library yardsticks (``F.scaled_dot_product_attention``
   forward and backward, ``torch.optim.AdamW(fused=True)``; the port
   never calls them). Before K4 is timed, one K4 step over those 292
   leaves is held against its plain version on copies of them.
12. ``train`` — GPT-2 350M (n_positions 1024, bf16 over fp32 masters,
   flash attention, seeded random params) through ``initialize`` with
   the JAX bench's config (train_batch_size 8, bf16, Adam lr 1e-4 with
   ``pallas: true``): 2 warmup and 10 timed ``train_batch`` steps on a
   fixed batch. Reports tokens/s, step p50, MFU, peak memory and a
   profiler window. Then 3 steps with gradient_accumulation_steps 2
   from the same params, once with flash and once with dense attention.
   Checks: finite, falling loss; K1, K2, K3 launched n_layer times per
   micro-batch, every launch on the tensor-core route, and K4 once per
   step; flash and dense losses within a
   bf16 tolerance at every step, and their first micro-batch's c_attn
   weight gradients (the q, k and v rows) within a relative tolerance.
13. ``train_zero`` — the same model at ``ZERO_LAYERS`` blocks (its
   widths), config and fixed batch through the data-parallel path in an
   NCCL group of one process (the port's ``initialize_distributed`` on
   a file store), at ZeRO stages 0, 1, 2
   and 3 (world 1 is a partition into one piece: every collective is
   issued), 2 warmup and 5 timed steps each, then stage 0 again. One
   line per stage (losses, step p50, tokens/s, MFU, peak memory, K1-K4
   launches, the collectives' calls and bytes a step from the engine's
   ``Comm``, stage 3's plan and gathers, then a profile window of 2
   more steps), then the summary. Checks:
   finite, falling losses; K1-K3 n_layer launches a step and K4 one;
   the collective bytes a step at each stage's formula (P the fp32
   param bytes: all-reduce P; reduce-scatter P and all-gather P; the
   same at accumulation 1; all-gathers of P/2 in the forward and again
   in the backward and a reduce-scatter of P); stage 3 gathers every
   leaf twice a step; losses and fp32 masters equal stage 0's bit for
   bit (when stage 0 repeats itself bit for bit; else losses within
   the ``train`` phase's 5e-3). Then stage 3 with the fp8 wire
   (``fp8.wire``, f8e4m3fn in chunks of 512): the gathered params equal
   the exact gather (world 1: the rank's own piece, placed exactly), each
   piece's codec round trip within its bound, all-gather bytes a step 2
   x the wire's ``wire_nbytes``; and stage 0 with ``sparse_gradients``:
   the tied ``wte``'s dense fallback counted. Both equal their stage's
   losses and masters bit for bit. The group is destroyed after it.
13a. ``train_features`` — the ``train`` row at ``FEATURE_LAYERS`` blocks
   (GPT-2 350M's widths, 8 x 1024, bf16,
   flash), 4 steps a run from the same seeded params: the unrolled
   baseline; ``scan_layers`` (losses and fp32 masters equal bit for
   bit); progressive layer drop (theta 0.5 from step 1: K1-K3 launches
   a step equal to the kept attention sublayers, below 24; the kept
   share); LAMB (falling losses; one step through forward / backward /
   step against the plain ``lamb_update`` on host copies, rtol 1e-6 plus
   1e-7 of the largest master); fp8 (4 state keys a layer, the discovery
   forward on step 1, history slots filling one a step); GPT-2's blocks
   checkpointed through the activation checkpointing module: remat
   ``dots`` (the module's ``dots`` policy), and a loss that runs each
   block under ``checkpoint(..., policy="offload")`` (losses equal the
   baseline's bit for bit, peak memory below it). Reports each run's
   step p50, peak memory and launches against the baseline.

14. ``sparse_kernel_check`` (also under ``--kernels-only``) — block-sparse
   K7 (out, lse), K8a (dq) and K8b (dk, dv) against their plain versions:
   blocks 16/32/64/128 at T = 8 blocks, D 64 and 128, bf16 and f32,
   causal and not, dropout 0 and 0.1, over a Fixed layout with an empty
   q-block row; fp16 at D 64 for blocks 16 and 64; head dims 320
   (block 16) and 512 (block 32) in f32, bf16 and fp16 (column chunks of
   256); the same at D 256 for blocks 16 and 64; then all five layout
   families (per-head where they allow it) and a hand-made layout with
   an empty row and an unvisited k-block at T 512; the shape
   ``train_bert_sparse`` gives the kernels (B 32, T 512, H 16, D 64,
   block 64, the bench's Fixed layout, dropout 0.1) in f32, bf16 and
   fp16; a data-parallel rank's rows (B 4 at ``dropout_head_offset``
   r * B * H: rank 1 in f32, rank 3 in bf16, causal and not, dropout
   0.1); K7's dropout mask read back bitwise (q = k = 0, v = I, also at
   a nonzero head offset); a dense layout through K7 against K1.
15. ``sparse_kernel_timing`` — CUDA-event ms per call of K7, K8a, K8b at
   the BERT bench shape (B 32, T 512, H 16, D 64, block 64, the Fixed
   layout of density 0.625) in f32, the dtype the encoder gives them,
   and in bf16 and fp16, and at the causal long-context shape in bf16 (B 1,
   T 4096, block 128, unidirectional Fixed), beside their plain
   versions, their bounds and ``F.scaled_dot_product_attention`` with
   the layout as a boolean mask, forward and backward (a yardstick
   only; the port never calls it). K7 / K8a / K8b rows add
   ``tf32x3_ops_ms`` (their operations at 495 / 3 TFLOP/s, the TF32
   tensor cores in three passes); on f32 rows their bound is read at
   that rate (``fp32_ops_ms`` keeps the CUDA-core figure beside it).
   Then ``wide_head_timing``: one row at head dim 512 for each kernel
   the column chunks reach (K1-K3, K7/K8, K5/K6), beside its plain
   version, its bound and SDPA where it runs at that head dim.
16. ``train_bert_sparse`` — BERT-Large's widths at ``BERT_LAYERS`` layers
   (cut from 24 to keep the script within its time; seq 512, bf16 over
   fp32 masters
   with the encoder layers in fp32 as in the JAX model, dropout 0.1, the bench's Fixed block-sparse layout, seeded random
   params) through ``initialize`` with the JAX bench's config
   (``bench.py:142-199``: train_batch_size 32, bf16, Adam lr 1e-4) on a
   fixed MLM batch (labels every 7th token): 2 warmup and 10 timed
   steps; micro-batch 16 with accumulation 2 if 32 x 512 does not fit.
   Reports tokens/s, samples/s, step p50, MFU (``bench.py:51-62`` at the
   layout's density), peak memory and a profiler window. Checks: finite,
   falling loss; K7, K8a, K8b n_layer times per micro-batch, K1-K3 and the
   gather route never, K4 once per step; then at dropout 0, 3 steps with
   accumulation 2 on the kernels and again on ``masked_dense_attention``:
   losses within a bf16 tolerance, first micro-batch attn_qkvw
   gradients within a relative tolerance.
16a. ``train_bert_ckpt`` — the same BERT-Large (dropout 0.1,
   accumulation 2) for 2 steps with ``normalize_invertible``,
   ``gelu_checkpoint`` and ``attn_dropout_checkpoint`` on every layer,
   against the same 2 steps without them: losses, the first
   micro-batch's gradients and the masters equal bit for bit; K7 twice a
   layer and micro-batch (the attention recompute), K8a/K8b once; peak
   memory of both.

17. ``train_offload`` — GPT-2 1.5B's widths (n_embd 1600, 25 heads) at
   ``OFFLOAD_LAYERS`` of its 48 layers (cut to keep the script within
   its time;
   vocab 50257, n_positions 1024; seeded random weights built on the
   host) through ``initialize`` with the JAX bench's offload row
   (``bench.py:343-398``: train_batch_size 4 x 1024, bf16,
   ``zero_optimization: {stage: 2, cpu_offload: true,
   offload_16bit_grads: true}``, Adam lr 1e-4, remat "full",
   ``loss_chunk`` 512, flash attention, dropout 0), the batch fed by
   ``training_data`` (4 rows made from the seed: a fixed batch, as the
   bench's): 1 warmup and 3 timed steps, then a profile of 2. First the
   host's CPU model, cores and MemTotal (too little RAM fails, with the
   numbers) and the C++ Adam's SIMD width. Reports tokens/s, step p50,
   MFU (no recompute counted), peak memory, the host phase's share of
   the step, D2H and H2D GB/s, the C++ Adam's and the bf16 convert's ms
   a step. Checks: finite, falling loss; after step 1 the host masters
   equal the plain host Adam on the same gradient (rtol 1e-6, plus 1e-7
   of the largest master), the gradient it read equals the device's bf16
   wire widened and the device params equal bf16(masters), both bit
   for bit; K1 2 x 48 (forward and remat recompute), K2 and K3 48 launches
   a step and K4 none; the host buffers pinned, no fp32 param on the card.
18. ``train_dense_yardstick`` — the same model, batch and remat on the
   dense engine (fp32 masters, K4 on the card): 1 warmup and 3 timed
   steps, step p50 and peak memory; checks a finite loss only.
19. ``offload_resume`` — GPT-2 125M, bf16 offload (the same config), a
   24-row dataset: 6 steps with ``save_checkpoint`` after step 3, then a
   fresh engine (other weights, another seed) loads it and runs steps
   4-6. Checks: its losses and final masters equal the uninterrupted
   run's bit for bit, and the data cursor is restored. Reports save and
   load GB/s.
20. ``train_pipe`` — GPT-2 350M's widths at ``PIPE_LAYERS`` blocks (the
   ``train`` row otherwise: 8 x 1024, bf16 over fp32 masters, flash,
   Adam lr 1e-4, dropout 0) as a ``PipelineModule`` through
   ``initialize``: S = 4 stages of 3 layers, M = 4 micro-batches
   of 2 rows, every stage on ``cuda:0`` (the in-process transport: NCCL
   refuses two ranks on one device), 2 warmup and 5 timed steps. Gates:
   step 1's loss sums and every raw stage gradient equal the sequential
   oracle on the same stage modules bit for bit, at 350M bf16 and at
   125M f32 with S = 2; stage 0's and stage 3's tied ``wte`` equal bit
   for bit after every step; K1, K2 and K3 launch 12 x M times a step
   and K4 once a stage; the p2p messages and bytes a step are 2 (S-1) M
   of 2 x 1024 x 1024 x 2 B; at M = 16 (batch 32) as many micro-batches
   are in flight as at M = 4 and the peak memory exceeds M = 4's by at
   most the stage inputs of the buffers ``num_pipe_buffers`` adds (one,
   on stage 0) and the larger batch (both peaks, taken with the same
   tensors alive, and the allowance printed); activation checkpoint
   interval 1 changes no gradient bit and doubles K1's launches; S = 1
   (``DataParallelSchedule``) against the unpipelined engine over 3
   steps (first loss rtol 1e-5, later losses 2e-3, the masters' updates
   within 10% in L2). Reports step p50, tokens/s, MFU
   (``bench.py:39-48`` over 989 TFLOP/s), peak memory, a 2-step
   profile, and the same row unpipelined (accumulation 4) as the
   yardstick.

21. ``train_pipe_zero`` (run before 22-24) — the ``train_pipe`` row
   (GPT-2 350M, S = 4 stages of 6 layers, M = 4 micro-batches of 2 rows,
   bf16, flash, Adam lr 1e-4, every stage on ``cuda:0``) at ZeRO stage
   0, at stage 3 and under ZeRO-Offload (stage 2, ``cpu_offload``), 1
   warmup and 3 timed steps each from the same seeded weights. Gates:
   stage 3's losses and pipe-layout fp32 masters equal stage 0's bit for
   bit (when stage 0 repeats itself bit for bit; else losses within the
   ``train`` phase's 5e-3), its backwards regathered leaves with S
   micro-batches in flight on stage 0; offload's device params equal
   bf16(host masters) bit for bit and its losses are within 5e-3 of
   stage 0's; K1-K3 24 x M launches a step, K4 once a stage (none under
   offload). Reports each run's step p50 and peak memory.
22. ``train_tp`` — GPT-2 350M's widths at ``TP_LAYERS`` blocks (the
   ``train`` row otherwise: 8 x 1024, bf16 over
   fp32 masters, flash, Adam lr 1e-4, dropout 0) at ``{"mesh":
   {"model": 2}}``: two processes of this script (``--tp-worker``) on
   ``cuda:0``, joined by gloo on CUDA tensors (NCCL refuses two ranks on
   one device; the port allows gloo there only because both ranks' CUDA
   UUIDs agree), each holding its shard, 2 warmup and 5 timed steps;
   the model-1 run of the same seed first, in this process. Gates: the
   first loss within rtol 1e-3 of model 1's, the same on both ranks; the
   fp32 masters after 7 steps within 5e-3 relative L2 of model 1's; K1,
   K2, K3 n_layer launches a step a rank at 8 local heads and K4 one; then one
   step at dropout 0.1: every K1 call's dropout coordinates are model
   1's at the rank's heads, and K1's masks at them, read back, equal
   model 1's masks at those heads bit for bit. Reports p50, tokens/s,
   peak memory a rank, the collectives' calls and bytes a step and which
   ones were staged through host memory. In the same world,
   ``train_tp_scan``: the model stacked (``scan_layers``, through
   ``with_layout``) for 3 steps, then stacked with ``loss_chunk`` 256.
   Gates: the stacked losses and masters after 3 steps equal the
   unrolled run's bit for bit on both ranks (sha256 of each leaf by its
   unrolled name); the chunked first loss within rtol 1e-3 of the
   whole-vocab one; K1-K3 n_layer launches a step a rank, K4 one. Its
   own row reports both runs' p50s and peak memory.
23. ``serve_tp`` — GPT-2 125M served at model 2 by two such processes,
   each over its shard with 6 of the 12 heads in its cache: the
   ``serve`` row's engine (max_batch 8, buckets 128 / 512, prefill chunk
   64, flash decode) and its requests (8-120 prompt tokens, 32 new): the
   first 8 in f32 on the ring (K5) and the paged pool (K6), the first 12
   in bf16 on the ring and int8 on the pool; model 1 of the same seed in
   this process first. Gates:
   f32 greedy streams equal model 1's bit for bit and equal on both
   ranks; teacher-forced logits within ``TEACHER_FORCED_ATOL`` of model
   1's (every dtype); 2 programs; K5 (ring) or K6 (paged) n_layer times
   a decode step and the other never. Reports tokens/s beside model 1's.
   In the same world, ``serve_tp_scan``: the f32 runs again with the
   weights stacked (``--scan-layers``'s model, a stacked cache of 6 heads
   a rank). Gates: its streams equal the unrolled model-2 streams and
   model 1's bit for bit, as many K5 / K6 launches, the other kernel
   never, 2 programs.
24. ``train_pipe_tp`` — JAX's collective-matmul bench row
   (``bench.py:450-500``): ``tp_pipeline_module`` (vocab 32000, d_model
   1024, 16 heads, 4 blocks, 2 stages, flash) at pipe 2 x model 2, f32,
   8 x 512 tokens in 4 micro-batches, each process holding both stages
   of its model rank; 3 steps each with ``tensor_parallel.overlap`` off,
   at chunks 4 and at chunks 1. Gates: chunks 4's losses within rtol
   1e-5 of off's, chunks 1's equal off's bit for bit, the ranks agree,
   the chunked run's rings ran (ppermutes), K1-K3 16 launches a step and
   K4 one a stage. Reports p50 and tokens/s of each.

Phases 25-28 run sequence and expert parallelism on ``cuda:0``: every
rank a process of this script (``--tp-worker``) joined by gloo on CUDA
tensors through host memory, as phases 22-24. Their collective times
are host-staged ones on one card, not NVLink times.

25. ``seq_attention`` — causal q, k, v ``[2, 8192, 16, 64]`` bf16 (seeded)
   at seq 2, each rank its half of the sequence; the references in this
   process first: dense f32 attention of the whole sequence (per head),
   without and with dropout 0.1 at seed 1234 (the ring's hash
   coordinates), and K1-K3 on all 16 heads. Gates: the ring's output and
   gradients (of ``sum(out * w)``, w seeded) within ``SEQ_REL_TOL`` (max
   |diff| / max |ref|) of the dense ones at the rank's slice, with and
   without dropout; Ulysses (K1-K3 at 8 heads a rank) bit for bit equal
   to K1-K3 on 16 heads (output and gradients); K1-K3 once a call
   and never in the ring; Ulysses' K1 seed at dropout 0.1 is
   ``fold_in_seed(1234, seq rank)``. Reports each call's ms, the
   collectives a call and peak memory a rank.
26. ``train_pipe_sp`` — ``sp_pipeline_module(50257, 1024, 16, 1024,
   n_blocks=SP_BLOCKS)`` (4) at pipe 2 (every stage in a process) x seq 2 (two
   processes), 8 x 1024 tokens as 4 micro-batches, Adam lr 1e-4,
   dropout 0; seq 1 in this process first at the same (seeded) weights.
   Gates: f32 value-and-grad at seq 2 against seq 1's: loss rtol 1e-5,
   no gradient element outside rtol 3e-4 / atol 1e-6 (JAX's bounds);
   bf16 over f32 masters, 2 + 3 steps: the losses within 5e-3 of seq
   1's and equal on both ranks; K1-K3 32 launches a step a rank at 8
   heads on the tensor cores, K4 two (one a stage). Reports step p50,
   tokens/s, peak memory, the collectives a step, and seq 1's p50.
27. ``train_moe`` — ``GPT2MoELMHead`` at GPT-2 350M (24 layers, 1024
   positions; ``GPT2MoEConfig`` defaults: 8 experts, top 2, capacity
   1.25, MoE every 2nd block, aux 0.01: 12 MoE blocks, 1.06 B params),
   8 x 1024 tokens, bf16 over f32 masters, ZeRO 1, Adam lr 1e-4,
   dropout 0, 2 + 3 steps: expert 1 in this process, then expert 2 in two
   processes. Gates (``MOE_LIMITS``; each limit lies between the sound
   run's reading and the planted faults' of ``--moe-faults``): losses
   equal on the ranks, the first within rtol 1e-4 of expert 1's; each
   step's gradient norm (the engine's, each expert shard counted once)
   relative to expert 1's; the first step's ``gate`` gradients by
   relative L2; the update of the masters (after minus before the 5
   steps) by relative L2 over the gate, expert and other leaves apart;
   the first step's tokens kept and dropped per expert equal to expert
   1's in the first MoE block (its input is the same bits) and within
   ``MOE_ROUTE_GAP`` of the routed tokens in the others (bf16 partial
   sums reassociate); K1-K3 24 launches a step a rank, K4 one. Reports
   the dropped-token share. ``--moe-faults`` runs expert 2 again with
   each of ``MOE_FAULTS`` planted and fails unless some gate catches
   each.
28. ``train_pipe_tp_moe`` — JAX's collective-matmul bench row (vocab
   32000, d 1024, 16 heads, 4 blocks, 2 stages, 8 x 512 tokens in 4
   micro-batches, f32, flash) with ``TPMoEBlockLayer`` blocks
   (``MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0)``, the aux
   carried) at pipe 2 x model 2 x expert 2 (four processes); model 1 x
   expert 1 in this process first. Gates: value-and-grad loss rtol 1e-5
   and no gradient element outside rtol 3e-4 / atol 1e-6 of the
   replicated run's, 2 steps' losses rtol 1e-5; the ``expert_combine``
   overlap site at chunks 4 within rtol 1e-5 of off (its rings ran);
   K1-K3 16 launches a step, K4 two.

Phases 29-32 run the gradient compressors, every rank a process on
``cuda:0`` over gloo (CUDA tensors, one device; 29-31 in one world of two
processes, started once); every bitwise gate compares host copies
(sha256 of the bytes). The codecs and the 1-bit
update are plain PyTorch on the card (JAX computes them with ``jnp``
outside any kernel): these phases add no kernel, and K1-K4 run in them.

29. ``train_qcomm`` — JAX's ``bench.py:405-450`` row at ``F5_LAYERS``
   blocks: GPT-2 125M's widths, 8 x
   1024 tokens, bf16, flash, Adam lr 1e-4, at data 2: the fp32 gradient
   sync, ``comm_quantization`` at its defaults (chunk 512, 4 MB
   buckets) at ZeRO 0, and at ZeRO 2 with accumulation 2 and error
   feedback, 3 steps each. Gates: losses within 5e-3 relative of the
   fp32 run's (JAX's pin), both ranks' params bit for bit equal after
   every step, an int8 exchange ran, K1-K3 12 launches a micro-batch a
   rank, K4 one a step. Reports each run's exchange bytes a step by
   dtype, the send-basis ratio against fp32 (JAX's formula predicts
   4 / (1 + 4/512) = 3.97) and the step p50.
30. ``train_onebit`` — the same row under 1-bit Adam (``freeze_step`` 2,
   6 steps, eps ``OB_EPS``), and under Adam without bias correction (K4)
   for 3 steps. Gates: the warmup losses within rtol 1e-4 of K4's and
   the first update within 1e-4 relative L2 (``OB_WARMUP_*``); both
   ranks' params bit for bit equal after every step; the error buffers
   zero through the warmup and nonzero after; ``pack_signs`` /
   ``unpack_signs`` on the card bit for bit their host run, and the
   worker's scale within ``OB_SCALE_RTOL`` of float64, over seeded
   values of the model's size; K1-K3 launched, K4 not. Reports the
   compressed step's bytes against the warmup's dense step.
31. ``train_pipe_onebit`` — GPT-2 350M widths cut to 4 blocks (bf16,
   flash, 8 x 1024 tokens in 4 micro-batches) at pipe 2 x data 2, every
   stage of a replica in one process: Adam without bias correction for
   3 steps, then 1-bit Adam (``freeze_step`` 2) for 4. Gates: the
   warmup within JAX's rtol 2e-4, the tied leaves bit for bit equal on
   the first and the last stage after every step, finite losses that
   fall, nonzero error buffers, K1-K3 launched.
32. ``train_pipe_tp_onebit`` — the ``train_pipe_tp`` row (vocab 32000,
   d 1024, 16 heads, 2 blocks, f32, 8 x 512 tokens in 4 micro-batches)
   at pipe 2 x model 2 x data 2, eight processes, one a stage rank; the
   same runs and gates, plus every leaf not split over the model axis
   bit for bit equal on the two model ranks of its stage and data rank
   after every step. ``--f5-faults`` runs 31 and 32 with
   ``F5_FAULTS`` planted (the tied leaves compressed in the body's
   buffer; the model-replicated body leaves with the model-sharded
   ones) and fails unless each breaks its equality gate.
33. ``train_bert_tp`` — ``train_bert_sparse``'s row (BERT-Large widths:
   d 1024, 16 heads, 4096 intermediate, vocab 30522; MLM at 512, the
   Fixed layout at block 64, bf16 with the encoder and K7/K8 in fp32)
   at 8 x 512 and ``BERT_TP_LAYERS`` layers, at model 2 (two
   ``--tp-worker`` processes on ``cuda:0`` over gloo), 1 warmup and 3
   timed steps, the model-1 run of the same seed first. Gates: the first
   loss within rtol 1e-3 of model 1's, the same on both ranks; the fp32
   masters after 4 steps within 5e-3 relative L2 of model 1's; K7, K8a,
   K8b n_layer launches a step a rank at 8 heads, K1-K3 none, no
   gather-route call, K4 one a step; one step at dropout 0.1 whose first
   loss is model 1's within 1e-3 and whose sparse calls hash each rank's
   heads at their global coordinates (offset 8 r, 16 heads); K7/K8 at a
   rank's shape against their plain versions, and bit for bit equal to
   the 16-head launch at those heads. Then the flash core (K1-K3 with
   the padding mask as a key bias) at 2 layers: the same loss and
   master gates, K1-K3 2 launches a step a rank. Reports p50 beside
   model 1's, peak memory a rank and the collectives a step.
34. ``train_resilience`` — GPT-2 125M (8 x 512, bf16, flash) through
   ``initialize`` with the ``resilience`` block, in a child process of
   this script (``--resilience-worker``), so the SIGTERM stays there.
   Gates: a NaN gradient planted at step 1 under ``skip_step`` leaves the
   masters bit for bit those of a clean run of the other batches; under
   ``rollback_to_checkpoint`` with the hot tier a NaN step restores the
   step-2 snapshot from RAM, and a fresh engine (another seed) with
   ``auto_resume`` restores it from the mirror, both bit for bit;
   ``simulate_preemption`` at step 3 gives ``PreemptedError`` (code 0)
   with its checkpoint; a fresh engine (seed 123) with ``auto_resume``
   continues the clean loss curve bit for bit; with the newest disk
   checkpoint torn the ladder loads the step-2 one, bit for bit the
   clean masters at step 2; K1-K3 12 launches and K4 one a step.
   Reports the hot snapshot's ms and bytes, a disk save's ms and bytes
   and each rung's restore ms.
35. ``train_telemetry`` — the ``train`` row (GPT-2 350M, 24 layers, 8 x
   1024, bf16, flash, K4 Adam), ``TEL_STEPS`` steps from seed 0 without
   and then with the ``telemetry`` block (a JSONL log,
   ``flops_per_token``) and a 2-step ``profiling`` window. Gates: the
   losses equal bit for bit; K1-K3 24 launches and K4 one a step in both
   runs; every step event has ``dispatch`` and ``device_wait`` and its
   top-level phases sum to no more than its ``wall_s``; the window's
   Chrome trace holds ``ds_tpu/dispatch`` and ``ds_tpu/device_wait``
   once a step and, by kernel name, as many K1-K4 kernels as the
   wrappers counted over the window. Then, in ``--telemetry-worker``
   children of this script at GPT-2 125M (8 x 512): the hang watchdog
   (floor ``WD_MIN_DEADLINE_S``, a ``WD_HANG_S`` hang injected inside
   dispatch) fires once, ``this_host_stuck``, with one flight dump that
   the port's ``postmortem`` renders with ``dispatch/injected_hang``;
   with ``action: abort`` the child dies by SIGABRT after its dump; and
   ``compilation_cache_dir``: a cold child (dense attention, so only K4's
   library builds) counts misses and leaves the library in the
   directory, a warm one on the same directory counts hits, no miss, no
   build and a smaller ``compile_seconds``. Reports both runs' step p50,
   the log's ``summary`` (MFU at 989 TFLOP/s) on a line of its own, and
   the children's walls.

Then the phases' walls, the ``kernels`` summary line (K7/K8 entries name
their design; K1-K4 count the ``train`` path's launches and give the
``train_zero`` path's as ``zero_launches``, the ``train_features``
path's as ``features_launches``, the ``train_offload`` path's as
``offload_launches``, the ``train_pipe`` path's as
``pipe_launches``, ``train_pipe_zero``'s (stage 0, 3, offload) as
``pipe_zero_launches``, ``train_tp``'s a rank as ``tp_launches_by_rank``
and ``train_pipe_tp``'s as ``pipe_tp_launches``; K7/K8 add ``train_bert_ckpt``'s as
``bert_ckpt_launches``; K1-K4 add phases 25-28's a rank as
``seq_attention_launches_by_rank`` (Ulysses), ``pipe_sp_launches_by_rank``,
``moe_launches_by_rank`` and ``pipe_tp_moe_launches_by_rank``, and
phases 29-32's as ``qcomm_launches_by_rank`` (by run),
``onebit_launches_by_rank``, ``pipe_onebit_launches_by_rank`` and
``pipe_tp_onebit_launches_by_rank``, ``train_tp_scan``'s as
``tp_scan_launches_by_rank``, phase 33's flash run's as
``bert_tp_flash_launches_by_rank``, phase 34's as
``resilience_launches`` and phase 35's (both runs) as
``telemetry_launches``; K7/K8 add phase 33's as
``bert_tp_launches_by_rank``; K5 and K6
count every serving path's,
each also given apart: ``serve_launches``, ``scan_layers_launches``,
``checkpoint_launches``,
``process_fleet_launches``, ``thread_fleet_launches``,
``disagg_launches``, ``thread_tier_launches``,
``process_tier_launches``, and ``serve_tp``'s summed over its ranks as
``tp_launches``, ``serve_tp_scan``'s as ``tp_scan_launches``),
the ``host_ops`` line (the C++ Adam's ms a step over the 1.56 G masters
beside its plain version and ``probe_ms``: the 28 bytes an element it
must read and write at the best host memory rate that torch probes with
its pattern measure in the same phase (a copy, in-place ``a += b`` and
``a += b * c``, at torch's and OpenMP's thread counts); ``bound_ms`` is
that time where the Adam did not beat it, else null), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before the last line; without a CUDA device it exits 1 at once.
"""

import argparse
import concurrent.futures
import dataclasses
import gc
import math
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and ops/s by the
# operand type the kernel computes on.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 67e12, "int8": 1979e12,
                  "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12}
# fp32 precision on the TF32 tensor cores (495 TFLOP/s dense) takes three
# passes a product (hi.hi + hi.lo + lo.hi): the rate K8a / K8b compute at
TF32X3_OPS_PER_S = 495e12 / 3

B, S = 8, 512
FIXED_POSITIONS = (0, 63, 127, 128, 300, 511)
SERVE_BLOCK_K = 128     # the engine's default attention_block_k
N_LAYER = 12
PAGE_SIZE, PAGES_PER_ROW = 128, 4       # the paged engine's auto geometry
N_PAGES = B * PAGES_PER_ROW + 1         # ... and its auto pool (+ trash)
PAGED_FIXED_POSITIONS = (0, 127, 128, 255, 300, 511)
# the decode kernels' 128-key chunks: last / first keys of a chunk, rows
# whose live keys all fall in chunk 0, a negative position (zeros) and
# one past S (every slot admitted)
CHUNK_EDGE_POSITIONS = (127, 128, 255, 256, 511, 60, -1, 900)
OUT_OF_RANGE_PAGE = 10 ** 9
SYSTEM_PROMPT = 256


def emit(obj):
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device(torch):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    smi = proc.stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    return smi


# the bf16 K1 / K2 / K3 instantiations (head dim 64 and 128) and the SASS
# instructions that show they run on the tensor cores and are fed by TMA
TENSOR_CORE_FUNCTIONS = ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                         "dkv_wgmma_kernel")
SASS_OPS = ("HGMMA", "UTMALDG")


def _sass_by_function(lib_path, nvcc):
    """{mangled function name: [SASS lines]} of a built library, from
    ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib_path} failed: {proc.stderr.strip()}")
    functions, current = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            functions[current] = []
        elif current is not None:
            functions[current].append(line)
    return functions


def _sass_counts(lib_path, nvcc):
    """{"<function><<head dim>>": {op: count}} for the tensor-core
    functions of a built library."""
    counts = {}
    for name, lines in _sass_by_function(lib_path, nvcc).items():
        dim = re.search(r"ILi(\d+)E", name)
        for fn in TENSOR_CORE_FUNCTIONS:
            if fn in name and dim:
                counts[f"{fn}<{dim.group(1)}>"] = {
                    op: sum(op in ln for ln in lines) for op in SASS_OPS}
    return counts


# the K7 / K8a / K8b instances (dtype, layout block, head-dim bound, and
# whether it holds the column chunks' code past 256) and the SASS
# instruction that shows they run on the tensor cores (mma.sync TF32)
SPARSE_MMA = re.compile(
    r"(fwd|dq|dkv)_mma_kernelI(f|13__nv_bfloat16|6__half)Li(\d+)ELi(\d+)E"
    r"Lb([01])E")
SPARSE_KINDS = {"fwd": "K7", "dq": "K8a", "dkv": "K8b"}
SPARSE_DTYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16",
                 "6__half": "float16"}
# 3 kinds x 3 dtypes x 4 blocks x (3 head-dim bounds + the wide 256)
SPARSE_INSTANCES = 144


def _sparse_instance(name):
    m = SPARSE_MMA.search(name)
    if m is None:
        return None
    return (f"{SPARSE_KINDS[m.group(1)]}<{SPARSE_DTYPES[m.group(2)]},"
            f"{m.group(3)},{m.group(4)}{',wide' * (m.group(5) == '1')}>")


def _sparse_sass_counts(lib_path, nvcc):
    """{"K7<dtype,block,dmax>": HMMA count} for the K7 / K8 instances of
    a built library."""
    return {_sparse_instance(name): sum("HMMA" in ln for ln in lines)
            for name, lines in _sass_by_function(lib_path, nvcc).items()
            if _sparse_instance(name) is not None}


def _sparse_ptxas(lines):
    """{"K7<dtype,block,dmax>": {"registers", "spill_stores",
    "spill_loads"}} from the ``ptxas -v`` lines of a block-sparse
    build."""
    out, current = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _sparse_instance(m.group(1))
            if current is not None:
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def _build_all():
    """Every kernel library of the importable package built from its
    sources, one ``nvcc`` per library, all started together (a package
    without ``libraries()`` builds each of its ``KERNELS`` once); returns
    the wall seconds."""
    from deepspeed_tpu_torch.ops import _build
    libs = _build.libraries() if hasattr(_build, "libraries") else \
        [(name,) for name in _build.KERNELS]
    # the host ops (g++), where the package has them, alongside
    hosts = getattr(_build, "HOST_KERNELS", ())
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs) + len(hosts)) as ex:
        futures = [ex.submit(_build.load_library, *lib) for lib in libs]
        futures += [ex.submit(_build.load_host_library, name)
                     for name in hosts]
        for fut in futures:
            fut.result()            # raises with the compiler output
    return time.perf_counter() - t0


def phase_build():
    from deepspeed_tpu_torch.ops import _build
    libs = _build.libraries()
    seconds = _build_all()
    nvcc = _build._nvcc()
    sass = _sass_counts(_build.load_library("flash_attention")._name, nvcc)
    sparse_sass, sparse_ptxas = {}, {}
    for name, variant in libs:
        if name == "block_sparse_attention":
            sparse_sass.update(_sparse_sass_counts(
                _build.load_library(name, variant)._name, nvcc))
            sparse_ptxas.update(_sparse_ptxas(_build.build_info[
                _build.library_key(name, variant)]["ptxas"]))
    emit({"phase": "build", "seconds": seconds,
          "kernels": {_build.library_key(*lib):
                      _build.build_info[_build.library_key(*lib)]
                      for lib in libs},
          "host_kernels": {name: dict(_build.build_info[name],
                                      flags=list(_build.HOST_FLAGS +
                                                 _build.host_simd_flags()))
                           for name in _build.HOST_KERNELS},
          "flash_attention_sass": sass,
          "block_sparse_hmma": sparse_sass,
          "block_sparse_ptxas": sparse_ptxas})
    want = [f"{fn}<{d}>" for fn in TENSOR_CORE_FUNCTIONS for d in (64, 128)]
    for fn in want:
        if sass.get(fn, {}).get("HGMMA", 0) == 0:
            fail(f"{fn} has no HGMMA instruction in its SASS ({sass}): the "
                 f"bf16 attention kernels must run on the tensor cores")
    if len(sparse_sass) != SPARSE_INSTANCES or not all(sparse_sass.values()):
        fail(f"the K7 / K8a / K8b instances must all run mma.sync on the "
             f"tensor cores (HMMA in their SASS): {sparse_sass}")
    # the K7 instances (new in their tensor-core form) must not spill; a
    # library reused from an earlier build in this checkout has no ptxas
    # report to read
    if not sparse_ptxas:
        return
    spills = {k: v for k, v in sparse_ptxas.items() if k.startswith("K7")
              and (v.get("spill_stores", 0) or v.get("spill_loads", 0))}
    if spills or sum(k.startswith("K7") for k in sparse_ptxas) != \
            SPARSE_INSTANCES // 3:
        fail(f"K7 instances spill registers or lack a ptxas report: "
             f"{spills or sparse_ptxas}")


def _positions(torch, rng):
    extra = rng.integers(0, S, B - len(FIXED_POSITIONS))
    pos = np.concatenate([FIXED_POSITIONS, extra]).astype(np.int32)
    return torch.from_numpy(pos).cuda()


def _cache(torch, storage, shape, gen):
    """k or v in ``storage`` (+ f32 scales for a codec) from N(0, 1)."""
    from deepspeed_tpu_torch.inference.cache import _quantize
    from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
    x = torch.randn(shape, generator=gen, device="cuda")
    if storage in CODECS:
        return _quantize(x, storage)
    return x.to(getattr(torch, storage)), None


# a bf16 / f16 output is one rounding of an fp32 value the kernel and the
# plain version each compute to ~1e-6: they may differ by one unit in
# the last place, which is at most 2^-7 (bf16) / 2^-10 (f16) of |out|
RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}
ATOL = 2e-5
STORAGES = ("bfloat16", "float32", "int8", "f8e4m3fn", "f8e5m2")


def phase_kernel_check(torch):
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_reference)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases, worst = [], 0.0
    for b, h, d, storage, qdt in _decode_specs():
        k, ks = _cache(torch, storage, (b, S, h, d), gen)
        v, vs = _cache(torch, storage, (b, S, h, d), gen)
        q = torch.randn((b, 1, h, d), generator=gen,
                        device="cuda").to(getattr(torch, qdt))
        pos = _positions(torch, rng)[:b]
        scales = (ks, vs) if ks is not None else ()
        out = flash_decode(q, k, v, pos, *scales,
                           block_k=SERVE_BLOCK_K)
        ref = flash_decode_reference(q, k, v, pos, *scales,
                                     block_k=SERVE_BLOCK_K)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        allowed = ATOL + RTOL[qdt] * ref.float().abs()
        ok = bool(torch.isfinite(out.float()).all()) and \
            bool((diff <= allowed).all())
        err = float(diff.max())
        worst = max(worst, err)
        case = {"B": b, "H": h, "D": d, "storage": storage,
                "q": qdt, "max_abs_err": err, "atol": ATOL,
                "rtol": RTOL[qdt], "ok": ok}
        if qdt == "bfloat16" and d == 64:
            case["poison_bitwise"] = _poison_check(
                torch, flash_decode, q, k, v, pos, ks, vs, out)
            ok = ok and case["poison_bitwise"]
        cases.append(case)
        if not ok:
            emit({"phase": "kernel_check", "failed": case})
            fail(f"flash_decode disagrees with its plain "
                 f"version: {case}")
    for case in _tiny_decode_cases(torch, "ring", gen, rng):
        worst = max(worst, case["max_abs_err"])
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "kernel_check", "failed": case})
            fail(f"flash_decode at the tiny serving shape disagrees with "
                 f"its plain version: {case}")
    emit({"phase": "kernel_check", "cases": len(cases),
          "max_abs_err": worst, "results": cases})
    return worst


def _decode_specs():
    """(B, H, D, storage, query dtype) of the decode kernel checks: the
    serving shapes in every storage, D 256, and head dims past 256 (the
    kernels' column chunks of 256) on bf16 and int8 caches."""
    specs = [(b, h, d, storage, qdt)
             for b, h, d in [(8, 12, 64), (8, 16, 96), (4, 4, 256)]
             for storage in STORAGES for qdt in ("bfloat16", "float32")
             if not (d == 256 and qdt == "float32")]
    return specs + [(4, 4, d, storage, "bfloat16") for d in (320, 512)
                    for storage in ("bfloat16", "int8")]


def _fill(torch, x, mask, value):
    """``x`` with the [B, S] ``mask`` slots set to ``value`` (fp8
    storage is written through its bytes)."""
    y = x.clone()
    if y.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        bits = torch.tensor(value).to(y.dtype).view(torch.uint8).item()
        y.view(torch.uint8)[mask] = bits
    else:
        y[mask] = value
    return y


def _poison_check(torch, flash_decode, q, k, v, pos, ks, vs, clean,
                  block_k=SERVE_BLOCK_K):
    """Slots past each row's position hold huge garbage (a recycled
    ring row's previous tenant): the output must not change a bit."""
    dead = torch.arange(k.shape[1], device="cuda")[None, :] > \
        pos[:, None].long()
    big = 100.0 if k.dtype == torch.int8 else 1e4 if ks is None else 400.0
    scales = ()
    if ks is not None:
        scales = (_fill(torch, ks, dead, 1e4), _fill(torch, vs, dead, 1e4))
    out = flash_decode(q, _fill(torch, k, dead, big),
                       _fill(torch, v, dead, -big), pos, *scales,
                       block_k=block_k)
    torch.cuda.synchronize()
    return bool(torch.equal(out, clean))


def _events_ms(torch, fn, n_calls, sleep_cycles=0):
    """CUDA-event ms per call over ``fn(i)`` for i in range(n_calls);
    with ``sleep_cycles`` the device first spins that long, so the host
    has queued every call before the first one runs. Returns the ms and
    whether the device was still spinning when the host finished."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for i in range(n_calls):
        fn(i)
    end.record()
    host_ahead = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / n_calls, host_ahead


def _span_ms(torch, fn, n_calls):
    """Mean CUDA-event span of each call on its own (start and end
    recorded around every call)."""
    spans = []
    for i in range(n_calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / n_calls


def _time_ms(torch, fn, n_calls, reps=5):
    """``(device_ms, host_paced_ms, host_syncs)`` per call, medians
    over ``reps``.

    ``host_paced_ms``: calls issued back to back as a caller issues
    them, so host launch overhead shows when it exceeds the device
    time. ``device_ms``: the same calls queued behind a device-side
    spin long enough for the host to get ahead, so the events time the
    device work alone (checked: the spin must outlast the enqueue). A
    call that waits on the device inside (``host_syncs``) cannot be
    queued ahead; its device_ms is then the mean event span of each
    call on its own, which includes the host's re-launch gaps."""
    _events_ms(torch, fn, n_calls)                      # warmup
    paced = statistics.median(
        _events_ms(torch, fn, n_calls)[0] for _ in range(reps))
    # spin for twice the host-paced time at up to 2 GHz clocks
    cycles = int(2 * paced * n_calls * 1e-3 * 2e9)
    device, misses = [], 0
    while len(device) < reps:
        ms, ahead = _events_ms(torch, fn, n_calls, cycles)
        if ahead:
            device.append(ms)
            continue
        misses += 1
        cycles *= 2
        if misses == 3:
            spans = [_span_ms(torch, fn, n_calls) for _ in range(reps)]
            return statistics.median(spans), paced, True
    return statistics.median(device), paced, False


def _bound(torch, pos, H, D, storage, qbytes):
    """Least time for one call: bytes it must move (q, occupied k/v and
    scales, positions read once; out written once) at the HBM rate, or
    its flops at the peak for the storage type, whichever is larger."""
    from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
    keys = int((pos.long().clamp(max=S - 1) + 1).sum())
    quant = storage in CODECS
    dtype = CODECS[storage].dtype if quant else getattr(torch, storage)
    nbytes = 2 * keys * H * D * dtype.itemsize + 2 * B * H * D * qbytes \
        + 4 * B
    if quant:
        nbytes += 2 * keys * H * 4
    flops = 4 * keys * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_kernel_timing(torch):
    """Time the kernel on the 125M decode shape over N_LAYER separate
    layer caches in turn (150+ MB, past the 50 MB L2: each call finds
    its layer cold, as the decode step does)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_reference)
    H, D = 12, 64
    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    # positions the serve stream's decode steps see: prompts of 8-120
    # tokens plus up to 32 generated ones
    mixes = {"serve_mix": torch.from_numpy(
        rng.integers(8, 152, B).astype(np.int32)).cuda(),
        "full": torch.full((B,), S - 1, dtype=torch.int32, device="cuda")}
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    results = {}
    for storage in ("bfloat16", "int8"):
        layers = [(_cache(torch, storage, (B, S, H, D), gen),
                   _cache(torch, storage, (B, S, H, D), gen))
                  for _ in range(N_LAYER)]

        def args(i):
            (k, ks), (v, vs) = layers[i % N_LAYER]
            return (q, k, v), (ks, vs) if ks is not None else ()

        for mix, pos in mixes.items():
            def kern(i):
                base, sc = args(i)
                flash_decode(*base, pos, *sc, block_k=SERVE_BLOCK_K)

            def plain(i):
                base, sc = args(i)
                flash_decode_reference(*base, pos, *sc,
                                       block_k=SERVE_BLOCK_K)

            ms, paced, kern_sync = _time_ms(torch, kern, 10 * N_LAYER)
            plain_ms, plain_paced, plain_sync = _time_ms(torch, plain,
                                                         2 * N_LAYER)
            bound, by, nbytes = _bound(torch, pos, H, D, storage, 2)
            row = {"ms": ms, "host_paced_ms": paced, "host_syncs": kern_sync,
                   "plain_ms": plain_ms,
                   "plain_host_paced_ms": plain_paced,
                   "plain_host_syncs": plain_sync, "bound_ms": bound,
                   "bound_by": by, "bytes": nbytes,
                   "roofline_share": bound / ms, "positions": pos.tolist(),
                   "library_ms": None}
            if storage == "bfloat16":
                mask = (torch.arange(S, device="cuda")[None, :]
                        <= pos[:, None].long())[:, None, None, :]

                def lib(i):
                    (k, _), (v, _) = layers[i % N_LAYER]
                    F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), attn_mask=mask)

                (row["library_ms"], row["library_host_paced_ms"],
                 row["library_host_syncs"]) = _time_ms(torch, lib,
                                                       10 * N_LAYER)
            results[f"{storage}/{mix}"] = row
    emit({"phase": "kernel_timing", "shape": [B, S, H, D],
          "results": results})
    return results


# ---------------------------------------------------------------------------
# paged serving slice: flash_decode_paged (K6)
# ---------------------------------------------------------------------------

def _tiny_geometry(torch, layout):
    """(KV spec, attention block_k) of the serve CLI's ``gpt2_tiny``
    engine as the process fleet (ring) and the process tiers (paged)
    build it: head dim 8, f32 storage and queries."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.serve import seeded_tiny_model
    engine = InferenceEngine(seeded_tiny_model(0, "cuda"),
                             config=dict(TINY_SPEC, kv_layout=layout),
                             device="cuda")
    return engine.spec, engine.attention_block_k


def _tiny_decode_cases(torch, layout, gen, rng):
    """K5 (``layout`` "ring") or K6 ("paged") against its plain version
    at the tiny engine's shapes, over a few position pairs (the first
    and last slot, a block / page edge, random), each with the poisoned
    tail that must not change a bit."""
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_reference,
        flash_decode_reference)
    spec, block_k = _tiny_geometry(torch, layout)
    b, s, h, d = spec.max_batch, spec.max_seq, spec.n_head, spec.head_dim
    storage = str(spec.dtype).split(".")[-1]
    qdt = storage                           # f32 model: f32 queries
    edge = spec.page_size or s // 2
    pairs = [(0, s - 1), (edge - 1, edge),
             tuple(int(x) for x in rng.integers(0, s, 2))]
    cases = []
    for pair in pairs:
        pos = torch.tensor(pair[:b], dtype=torch.int32, device="cuda")
        if layout == "paged":
            n_pages = spec.n_pages + 3          # spare pages: unused ids
            shape = (n_pages, spec.page_size, h, d)
            table = _shuffled_table(torch, rng, b, n_pages,
                                    spec.pages_per_row)
        else:
            shape = (b, s, h, d)
        k, ks = _cache(torch, storage, shape, gen)
        v, vs = _cache(torch, storage, shape, gen)
        q = torch.randn((b, 1, h, d), generator=gen,
                        device="cuda").to(getattr(torch, qdt))
        scales = (ks, vs) if ks is not None else ()
        if layout == "paged":
            out = flash_decode_paged(q, k, v, pos, table, *scales,
                                     block_k=block_k)
            ref = flash_decode_paged_reference(q, k, v, pos, table,
                                               *scales, block_k=block_k)
            poison = _paged_poison_check(torch, flash_decode_paged, q, k,
                                         v, pos, table, ks, vs, out,
                                         block_k=block_k)
        else:
            out = flash_decode(q, k, v, pos, *scales, block_k=block_k)
            ref = flash_decode_reference(q, k, v, pos, *scales,
                                         block_k=block_k)
            poison = _poison_check(torch, flash_decode, q, k, v, pos, ks,
                                   vs, out, block_k=block_k)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        ok = bool(torch.isfinite(out.float()).all()) and bool(
            (diff <= ATOL + RTOL[qdt] * ref.float().abs()).all())
        case = {"model": "gpt2_tiny", "B": b, "H": h, "D": d, "S": s,
                "block_k": block_k, "storage": storage, "q": qdt,
                "positions": list(pair[:b]),
                "max_abs_err": float(diff.max()), "atol": ATOL,
                "rtol": RTOL[qdt], "poison_bitwise": poison,
                "ok": ok and poison}
        if layout == "paged":
            case.update(page_size=spec.page_size,
                        pages_per_row=spec.pages_per_row)
        cases.append(case)
    return cases


def _paged_positions(torch, rng):
    extra = rng.integers(0, S, B - len(PAGED_FIXED_POSITIONS))
    pos = np.concatenate([PAGED_FIXED_POSITIONS, extra]).astype(np.int32)
    return torch.from_numpy(pos).cuda()


def _shuffled_table(torch, rng, b, n_pages, pages_per_row=PAGES_PER_ROW):
    """``[b, pages_per_row]`` distinct physical ids in shuffled order,
    none of them the trash page."""
    ids = rng.permutation(np.arange(1, n_pages))[:b * pages_per_row]
    return torch.from_numpy(ids.reshape(b, pages_per_row).astype(
        np.int32)).cuda()


def _tail_mask(torch, pos, page_size, pages_per_row):
    """``[b, pages_per_row]``: table entries past each row's occupancy."""
    used = pos.long().clamp(max=page_size * pages_per_row - 1) // page_size
    return torch.arange(pages_per_row, device="cuda")[None, :] > \
        used[:, None]


def _paged_poison_check(torch, kern, q, k, v, pos, table, ks, vs, clean,
                        block_k=SERVE_BLOCK_K):
    """Entries past each row's occupancy pointed first at a trash page
    (page 0) holding huge values, then at an out-of-range id: the
    output must not change a bit either way."""
    big = 100.0 if k.dtype == torch.int8 else 1e4 if ks is None else 400.0
    trash = torch.arange(k.shape[0], device="cuda") == 0
    scales = ()
    if ks is not None:
        scales = (_fill(torch, ks, trash, 1e4), _fill(torch, vs, trash, 1e4))
    kp, vp = _fill(torch, k, trash, big), _fill(torch, v, trash, -big)
    tail = _tail_mask(torch, pos, k.shape[1], table.shape[1])
    same = True
    for entry in (0, OUT_OF_RANGE_PAGE):
        bad = table.masked_fill(tail, entry)
        out = kern(q, kp, vp, pos, bad, *scales, block_k=block_k)
        torch.cuda.synchronize()
        same = same and bool(torch.equal(out, clean))
    return same


def _ring_equivalence(torch, paged_kern, ring_kern, storage, h, d, gen, rng,
                      pos=None):
    """K6 over an in-order table onto the bytes of a ring cache against
    K5 over that ring: (bitwise equal, max abs err)."""
    k, ks = _cache(torch, storage, (B, S, h, d), gen)
    v, vs = _cache(torch, storage, (B, S, h, d), gen)
    q = torch.randn((B, 1, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    if pos is None:
        pos = _paged_positions(torch, rng)
    pool = (B * PAGES_PER_ROW, PAGE_SIZE, h, d)
    table = torch.arange(B * PAGES_PER_ROW, dtype=torch.int32,
                         device="cuda").reshape(B, PAGES_PER_ROW)
    ring_scales = (ks, vs) if ks is not None else ()
    pool_scales = tuple(x.view(pool[:3]) for x in ring_scales)
    paged = paged_kern(q, k.view(pool), v.view(pool), pos, table,
                       *pool_scales, block_k=SERVE_BLOCK_K)
    ring = ring_kern(q, k, v, pos, *ring_scales, block_k=SERVE_BLOCK_K)
    torch.cuda.synchronize()
    return (bool(torch.equal(paged, ring)),
            float((paged.float() - ring.float()).abs().max()))


def phase_paged_kernel_check(torch):
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_reference)
    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    cases, worst = [], 0.0
    n_pages = N_PAGES + 3                   # spare pages: unused ids exist
    for b, h, d, storage, qdt in _decode_specs():
        shape = (n_pages, PAGE_SIZE, h, d)
        k, ks = _cache(torch, storage, shape, gen)
        v, vs = _cache(torch, storage, shape, gen)
        q = torch.randn((b, 1, h, d), generator=gen,
                        device="cuda").to(getattr(torch, qdt))
        pos = _paged_positions(torch, rng)[:b]
        table = _shuffled_table(torch, rng, b, n_pages)
        scales = (ks, vs) if ks is not None else ()
        out = flash_decode_paged(q, k, v, pos, table, *scales,
                                 block_k=SERVE_BLOCK_K)
        ref = flash_decode_paged_reference(q, k, v, pos, table,
                                           *scales,
                                           block_k=SERVE_BLOCK_K)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        allowed = ATOL + RTOL[qdt] * ref.float().abs()
        ok = bool(torch.isfinite(out.float()).all()) and \
            bool((diff <= allowed).all())
        err = float(diff.max())
        worst = max(worst, err)
        case = {"B": b, "H": h, "D": d, "storage": storage,
                "q": qdt, "max_abs_err": err, "atol": ATOL,
                "rtol": RTOL[qdt], "ok": ok}
        if qdt == "bfloat16" and d == 64:
            case["poison_bitwise"] = _paged_poison_check(
                torch, flash_decode_paged, q, k, v, pos, table, ks,
                vs, out)
            case["ring_bitwise"], case["ring_max_abs_err"] = \
                _ring_equivalence(torch, flash_decode_paged,
                                  flash_decode, storage, h, d, gen,
                                  rng)
            ok = ok and case["poison_bitwise"] and \
                case["ring_bitwise"]
        cases.append(case)
        if not ok:
            emit({"phase": "paged_kernel_check", "failed": case})
            fail(f"flash_decode_paged disagrees with its plain "
                 f"version: {case}")
    # chunk edges, per storage: K6 against its plain version, the
    # poisoned tail, and K5 over the same bytes as a ring (bitwise)
    edges = torch.tensor(CHUNK_EDGE_POSITIONS, dtype=torch.int32,
                         device="cuda")
    h, d = 12, 64
    for storage in STORAGES:
        shape = (n_pages, PAGE_SIZE, h, d)
        k, ks = _cache(torch, storage, shape, gen)
        v, vs = _cache(torch, storage, shape, gen)
        q = torch.randn((B, 1, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        table = _shuffled_table(torch, rng, B, n_pages)
        scales = (ks, vs) if ks is not None else ()
        out = flash_decode_paged(q, k, v, edges, table, *scales,
                                 block_k=SERVE_BLOCK_K)
        ref = flash_decode_paged_reference(q, k, v, edges, table, *scales,
                                           block_k=SERVE_BLOCK_K)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        ok = bool(torch.isfinite(out.float()).all()) and bool(
            (diff <= ATOL + RTOL["bfloat16"] * ref.float().abs()).all())
        err = float(diff.max())
        worst = max(worst, err)
        case = {"B": B, "H": h, "D": d, "storage": storage, "q": "bfloat16",
                "positions": list(CHUNK_EDGE_POSITIONS), "max_abs_err": err,
                "atol": ATOL, "rtol": RTOL["bfloat16"],
                "poison_bitwise": _paged_poison_check(
                    torch, flash_decode_paged, q, k, v, edges, table, ks, vs,
                    out)}
        case["ring_bitwise"], case["ring_max_abs_err"] = _ring_equivalence(
            torch, flash_decode_paged, flash_decode, storage, h, d, gen, rng,
            edges)
        case["ok"] = ok and case["poison_bitwise"] and case["ring_bitwise"]
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "paged_kernel_check", "failed": case})
            fail(f"flash_decode_paged at the chunk edges: {case}")
    for case in _tiny_decode_cases(torch, "paged", gen, rng):
        worst = max(worst, case["max_abs_err"])
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "paged_kernel_check", "failed": case})
            fail(f"flash_decode_paged at the tiny serving shape disagrees "
                 f"with its plain version: {case}")
    ring = [c for c in cases if "ring_bitwise" in c]
    emit({"phase": "paged_kernel_check", "cases": len(cases),
          "max_abs_err": worst, "page_size": PAGE_SIZE,
          "pages_per_row": PAGES_PER_ROW,
          "ring_bitwise": all(c["ring_bitwise"] for c in ring),
          "ring_max_abs_err": max(c["ring_max_abs_err"] for c in ring),
          "results": cases})
    return worst


def _paged_bound(torch, pos, H, D, storage, qbytes):
    """Least time for one K6 call: the occupied keys' k/v (and scales),
    the table entries covering them, q, positions and out moved once at
    the HBM rate, or its flops at the storage type's peak."""
    from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
    occupied = pos.long().clamp(max=S - 1) + 1
    keys = int(occupied.sum())
    entries = int(((occupied + PAGE_SIZE - 1) // PAGE_SIZE).sum())
    quant = storage in CODECS
    dtype = CODECS[storage].dtype if quant else getattr(torch, storage)
    nbytes = 2 * keys * H * D * dtype.itemsize + 2 * B * H * D * qbytes \
        + 4 * B + 4 * entries
    if quant:
        nbytes += 2 * keys * H * 4
    flops = 4 * keys * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_paged_kernel_timing(torch):
    """Time K6 at the paged serve stream's decode shape over N_LAYER
    separate pools in turn (past the 50 MB L2, as in the decode step)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode_paged, flash_decode_paged_reference)
    H, D = 12, 64
    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    # positions the paged serve stream's decode steps see: a 256-token
    # system prompt, 8-120 own tokens, up to 32 generated ones
    mixes = {"serve_mix": torch.from_numpy(rng.integers(
        SYSTEM_PROMPT + 8, SYSTEM_PROMPT + 152, B).astype(np.int32)).cuda(),
        "full": torch.full((B,), S - 1, dtype=torch.int32, device="cuda"),
        # kernel_timing's serve_mix positions (its first draw from
        # seed 1), so K6 and K5 compare at the same occupancy
        "ring_serve_mix": torch.from_numpy(np.random.default_rng(1).integers(
            8, 152, B).astype(np.int32)).cuda()}
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    shape = (N_PAGES, PAGE_SIZE, H, D)
    results = {}
    for storage in ("bfloat16", "int8"):
        layers = [(_cache(torch, storage, shape, gen),
                   _cache(torch, storage, shape, gen),
                   _shuffled_table(torch, rng, B, N_PAGES))
                  for _ in range(N_LAYER)]

        def args(i):
            (k, ks), (v, vs), table = layers[i % N_LAYER]
            return (q, k, v), table, (ks, vs) if ks is not None else ()

        for mix, pos in mixes.items():
            def kern(i):
                base, table, sc = args(i)
                flash_decode_paged(*base, pos, table, *sc,
                                   block_k=SERVE_BLOCK_K)

            def plain(i):
                base, table, sc = args(i)
                flash_decode_paged_reference(*base, pos, table, *sc,
                                             block_k=SERVE_BLOCK_K)

            ms, paced, kern_sync = _time_ms(torch, kern, 10 * N_LAYER)
            plain_ms, plain_paced, plain_sync = _time_ms(torch, plain,
                                                         2 * N_LAYER)
            bound, by, nbytes = _paged_bound(torch, pos, H, D, storage, 2)
            row = {"ms": ms, "host_paced_ms": paced, "host_syncs": kern_sync,
                   "plain_ms": plain_ms,
                   "plain_host_paced_ms": plain_paced,
                   "plain_host_syncs": plain_sync, "bound_ms": bound,
                   "bound_by": by, "bytes": nbytes,
                   "roofline_share": bound / ms, "positions": pos.tolist(),
                   "library_ms": None}
            if storage == "bfloat16":
                mask = (torch.arange(S, device="cuda")[None, :]
                        <= pos[:, None].long())[:, None, None, :]
                gathered = []
                for (k, _), (v, _), table in layers:
                    idx = table.long()
                    gathered.append(tuple(
                        x[idx].reshape(B, S, H, D).transpose(1, 2)
                        for x in (k, v)))

                def lib(i):
                    k, v = gathered[i % N_LAYER]
                    F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                                   attn_mask=mask)

                (row["library_ms"], row["library_host_paced_ms"],
                 row["library_host_syncs"]) = _time_ms(torch, lib,
                                                       10 * N_LAYER)
                row["library_note"] = ("scaled_dot_product_attention over "
                                       "the pool pre-gathered into a bf16 "
                                       "[B, H, S, D] view; gather not timed")
                del gathered
            results[f"{storage}/{mix}"] = row
    emit({"phase": "paged_kernel_timing", "pool": list(shape),
          "pages_per_row": PAGES_PER_ROW, "batch": B, "results": results})
    return results


def _make_model(torch, seed, dtype=None, scan_layers=False):
    """GPT-2 125M from ``seed``; with ``scan_layers`` the same weights
    stacked (``models/gpt2.py:with_layout``)."""
    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2LMHead, gpt2_125m, with_layout)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cfg = gpt2_125m() if dtype is None else gpt2_125m(dtype=dtype)
    return with_layout(GPT2LMHead(cfg, device="cuda", generator=gen),
                       scan_layers)


def _engine(torch, kv, impl, session=None, dtype=None, scan_layers=False,
            **extra):
    """GPT-2 125M at the repo's serving row (max_batch 8, buckets 128 /
    512, prefill chunk 64) from seed 0; ``extra`` adds config keys
    (``kv_layout``, ``host_park_threshold``, ``speculative``)."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(
        _make_model(torch, 0, dtype, scan_layers), session=session,
        device="cuda",
        config={"max_batch": B, "seq_buckets": (128, 512),
                "prefill_chunk": 64, "kv_cache_dtype": kv,
                "attention_impl": impl, **extra})


def _step_stats(evts):
    """Decode tokens/s (tokens over the sum of step walls) and
    per-token latency percentiles over ``decode_step`` events."""
    walls = [float(e["wall_s"]) for e in evts]
    tokens = sum(int(e["tokens"]) for e in evts)
    lat = [w for e in evts for w in [float(e["wall_s"])] * int(e["tokens"])]
    return {"tokens": tokens,
            "tokens_per_s": tokens / max(sum(walls), 1e-9),
            "p50_ms": _percentile(lat, 0.50) * 1e3,
            "p99_ms": _percentile(lat, 0.99) * 1e3,
            "latency_samples": len(lat)}


def _reset_peak(torch):
    """The peak allocation so far (the engine build: fp32 params made,
    then cast), then reset, so the serve phases' ``max_memory_allocated``
    is the serving peak alone."""
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


# teacher-forced flash vs dense logits, bf16 compute: the dense path
# rounds scores and probabilities to bf16, the kernel keeps them fp32;
# over 12 random-init layers that stays well under 0.05 on logits of
# magnitude ~1
TEACHER_FORCED_ATOL = 0.05


def _in_order_tables(engine):
    """Row r on pages 1 + 4r .. 4 + 4r (None for a ring engine)."""
    if engine.kv_layout != "paged":
        return None
    ppr = engine.pages_per_row
    return (1 + np.arange(B * ppr, dtype=np.int32)).reshape(B, ppr)


def _forced_logits(engine, prompts, forced):
    """Prefill ``prompts`` into rows 0..B-1 (paged engines: row r on
    pages 1 + 4r .. 4 + 4r, in order), then decode the ``forced`` tokens
    [steps, B]: the decode logits [steps, B, vocab]."""
    tables = _in_order_tables(engine)
    for i, p in enumerate(prompts):
        engine.prefill(i, p, **({} if tables is None
                                else {"page_table": tables[i]}))
    pos = np.asarray([len(p) for p in prompts], np.int32)
    out = []
    for toks in forced:
        _, logits = engine.decode(toks, pos, page_tables=tables)
        if not (np.isfinite(logits).all() and logits.shape == (B, 50257)):
            fail(f"decode logits not finite / wrong shape {logits.shape}")
        out.append(logits)
        pos = pos + 1
    return np.stack(out)


def _teacher_forced_diff(torch, kv, engine=None, oracles=(("dense", {}),),
                         min_len=8):
    """Same params, same prompts, same forced tokens through a flash
    engine and each oracle engine (``(impl, extra config)``): the max
    |logit difference| against each oracle over every decode step and
    row, and the oracles' largest |logit|."""
    rng = np.random.default_rng(2)
    lens = rng.integers(min_len, min_len + 142, B)
    prompts = [rng.integers(0, 50257, n).tolist() for n in lens]
    forced = rng.integers(0, 50257, (8, B)).astype(np.int32)
    flash = engine if engine is not None else _engine(torch, kv, "flash")
    got = _forced_logits(flash, prompts, forced)
    del flash
    diffs, scale = [], 0.0
    for impl, extra in oracles:
        want = _forced_logits(_engine(torch, kv, impl, **extra), prompts,
                              forced)
        diffs.append(float(np.abs(got - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    return diffs, scale


def _profile_decode(torch, engine, first=8, steps=10):
    """Where a decode step's time goes: ``torch.profiler`` over
    ``steps`` full-batch decode steps (positions ``first`` to
    ``first + 143``, mid-stream; a paged engine's rows on in-order
    pages) — host wall, device busy time (sum of kernel self times) and
    its share of the wall, and the kernels that take most of it. Device
    fields are None when the profiler records no device time."""
    rng = np.random.default_rng(3)
    vocab = engine.model.config.vocab_size
    pos = rng.integers(first, first + 144, B).astype(np.int32)
    toks = rng.integers(0, vocab, B).astype(np.int32)
    tables = _in_order_tables(engine)
    engine.decode(toks, pos, page_tables=tables)
    return _profile(torch, lambda: engine.decode(toks, pos,
                                                 page_tables=tables), steps)


# the __global__ functions of ops/csrc/*.cu, all in an anonymous
# namespace at file scope
PORT_KERNELS = ("fwd_kernel", "dq_kernel", "dkv_kernel", "fwd_wgmma_kernel",
                "dq_wgmma_kernel", "dkv_wgmma_kernel", "adam_kernel",
                "flash_decode_kernel", "fwd_mma_kernel", "dq_mma_kernel",
                "dkv_mma_kernel")


def _port_kernel(name):
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", name)
    return m is not None and m.group(1) in PORT_KERNELS


def _profile(torch, step, steps):
    """``torch.profiler`` over ``steps`` calls of ``step()``: host wall
    per step, device busy time (sum of kernel self times), its share of
    the wall, the kernels that take most of it, and every kernel of the
    port's own sources (``PORT_KERNELS``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((us / steps / 1e3, e.count // steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy if kernels else None,
            "device_busy_share": busy / wall_ms if kernels else None,
            "kernels_per_step": sum(k[1] for k in kernels),
            "top_kernels": [{"name": name[:80], "ms_per_step": ms,
                             "calls_per_step": n}
                            for ms, n, name in kernels[:8]],
            "port_kernels": [{"name": name[:80], "ms_per_step": ms,
                              "calls_per_step": n}
                             for ms, n, name in kernels
                             if _port_kernel(name)]}


def phase_serve(torch, kv):
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler, Request)
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from deepspeed_tpu_torch.telemetry.session import TelemetrySession

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    session = TelemetrySession(history=1_000_000)
    engine = _engine(torch, kv, "flash", session=session)
    build_peak = _reset_peak(torch)
    sched = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(0)
    vocab = engine.model.config.vocab_size
    warmup = Request("warmup", rng.integers(0, vocab, 8).tolist(),
                     max_new_tokens=4)
    reqs = [Request(f"r{i}",
                    rng.integers(0, vocab,
                                 int(rng.integers(8, 120))).tolist(),
                    max_new_tokens=32, arrival_step=i)
            for i in range(24)]
    flash_decode.launches = 0
    flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    sched.run([warmup])
    n0 = len(session.events.recent(event="decode_step"))
    t1 = time.perf_counter()
    completions = sched.run(reqs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_decode.launches
    paged_launches = flash_decode_paged.launches
    steps = session.events.recent(event="decode_step")
    evts = steps[n0:]
    stats = _step_stats(evts)
    counts = engine.compile_counts()
    done = [c for c in completions if c.rid != "warmup"]
    row = {"phase": "serve", "model": "gpt2_125m", "kv_cache_dtype": kv,
           "attention": "flash", "requests": len(reqs),
           "completed": len(done),
           "finish_reasons": sorted({c.finish_reason for c in done}),
           "decode_steps": len(steps), "kernel_launches": launches,
           "launches_per_step": launches / max(len(steps), 1),
           **stats,
           "tokens_per_s_wall": stats["tokens"] / (t2 - t1),
           "warmup_s": t1 - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "build_max_memory_allocated": build_peak,
           "compile_counts": counts,
           "cache_bytes": engine.cache_facts()["bytes"]}
    row["decode_profile"] = _profile_decode(torch, engine)
    row["paged_kernel_launches"] = paged_launches
    del engine, sched
    if kv is None:
        equal, plain_l, scan_l, scan_counts = _scan_layers_streams(
            torch, Request, ContinuousBatchingScheduler, flash_decode)
        row.update(f32_greedy_scan_layers_equals_unrolled=equal,
                   scan_layers_kernel_launches=scan_l,
                   unrolled_stream_kernel_launches=plain_l,
                   scan_layers_compile_counts=scan_counts)
    (diff,), scale = _teacher_forced_diff(torch, kv)
    row.update(teacher_forced_max_abs_diff=diff,
               teacher_forced_logit_scale=scale,
               teacher_forced_atol=TEACHER_FORCED_ATOL)
    emit(row)
    if len(done) != len(reqs) or \
            row["finish_reasons"] != ["max_new_tokens"]:
        fail(f"not every request completed: {row}")
    if counts != {"prefill": 1, "decode": 1}:
        fail(f"compile_counts {counts} != {{'prefill': 1, 'decode': 1}}")
    if launches != N_LAYER * len(steps) or not steps or \
            row["paged_kernel_launches"]:
        fail(f"flash_decode launched {launches} times over {len(steps)} "
             f"decode steps; expected {N_LAYER} per step (and "
             f"flash_decode_paged {row['paged_kernel_launches']}, expected 0)")
    if not diff <= TEACHER_FORCED_ATOL:
        fail(f"flash vs dense teacher-forced logits differ by {diff} > "
             f"{TEACHER_FORCED_ATOL}")
    if kv is None:
        _check_scan_layers(row, "serve (ring)")
    return row


def _check_scan_layers(row, where):
    """The ``scan_layers`` streams equal the unrolled ones, and the
    stacked model launched the decode kernel as often."""
    if not row["f32_greedy_scan_layers_equals_unrolled"]:
        fail(f"{where}: f32 greedy streams of the scan_layers engine "
             f"differ from the unrolled engine's")
    if not row["scan_layers_kernel_launches"] or \
            row["scan_layers_kernel_launches"] != \
            row["unrolled_stream_kernel_launches"]:
        fail(f"{where}: the scan_layers engine launched the decode kernel "
             f"{row['scan_layers_kernel_launches']} times, the unrolled "
             f"{row['unrolled_stream_kernel_launches']}")


def _paged_stream(rng, vocab, Request, n=24, sessions=4):
    """A shared 256-token system prompt plus 8-120 tokens of each
    request's own, 32 new tokens, one arrival per decode step; the
    first ``sessions`` requests carry a session id."""
    system = rng.integers(0, vocab, SYSTEM_PROMPT).tolist()
    return [Request(f"r{i}",
                    system + rng.integers(
                        0, vocab, int(rng.integers(8, 120))).tolist(),
                    max_new_tokens=32, arrival_step=i,
                    session_id=f"s{i}" if i < sessions else None)
            for i in range(n)]


def _follow_ups(Request, first, done, step):
    """One follow-up per session: the earlier request's prompt plus
    every token it generated, so the parked KV covers all but the last."""
    return [Request(f"f{r.session_id}", list(r.prompt) + done[r.rid].tokens,
                    max_new_tokens=32, arrival_step=step + i,
                    session_id=r.session_id)
            for i, r in enumerate(x for x in first if x.session_id)]


def _greedy_streams(torch, Request, ContinuousBatchingScheduler,
                    scan_layers=False, **extra):
    """8 requests of the paged stream, f32, greedy: {rid: tokens}; with
    ``scan_layers`` on the stacked model (and its stacked cache)."""
    rng = np.random.default_rng(5)
    reqs = _paged_stream(rng, 50257, Request, n=8, sessions=0)
    eng = _engine(torch, None, "flash", dtype=torch.float32,
                  scan_layers=scan_layers, **extra)
    if scan_layers and not (eng.spec.stacked and set(eng.cache) == {"h"}):
        fail("the scan_layers engine does not hold a stacked cache")
    done = ContinuousBatchingScheduler(eng).run(reqs)
    counts = eng.compile_counts()
    del eng
    return {c.rid: c.tokens for c in done}, counts


def _scan_layers_streams(torch, Request, ContinuousBatchingScheduler,
                         kernel, **extra):
    """The f32 greedy streams of the unrolled and the ``scan_layers``
    engine, and the decode kernel's launches in each: ``(equal,
    unrolled_launches, scan_launches, scan_counts)``."""
    kernel.launches = 0
    plain, _ = _greedy_streams(torch, Request, ContinuousBatchingScheduler,
                               **extra)
    plain_launches, kernel.launches = kernel.launches, 0
    scan, counts = _greedy_streams(torch, Request,
                                   ContinuousBatchingScheduler,
                                   scan_layers=True, **extra)
    return plain == scan, plain_launches, kernel.launches, counts


def phase_serve_paged(torch, kv):
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler, Request)
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from deepspeed_tpu_torch.telemetry.session import TelemetrySession

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    session = TelemetrySession(history=1_000_000)
    engine = _engine(torch, kv, "flash", session=session, kv_layout="paged",
                     host_park_threshold=0.9)
    build_peak = _reset_peak(torch)
    sched = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(0)
    vocab = engine.model.config.vocab_size
    warmup = Request("warmup", rng.integers(0, vocab, 8).tolist(),
                     max_new_tokens=4)
    reqs = _paged_stream(rng, vocab, Request)
    flash_decode.launches = 0
    flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    sched.run([warmup])
    n0 = len(session.events.recent(event="decode_step"))
    t1 = time.perf_counter()
    done = {c.rid: c for c in sched.run(reqs)}
    follow = _follow_ups(Request, reqs, done, sched.step_count)
    done = {c.rid: c for c in sched.run(follow)}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_decode_paged.launches
    ring_launches = flash_decode.launches
    steps = session.events.recent(event="decode_step")
    evts = steps[n0:]
    stats = _step_stats(evts)
    counts = engine.compile_counts()
    facts = sched.paging.facts()
    served = [done[r.rid] for r in reqs + follow]
    kv_lens = [c.prompt_len + len(c.tokens) - 1 for c in served]
    pages = [-(-n // facts["page_size"]) for n in kv_lens]
    paged_bps = facts["page_bytes"] * sum(pages) / len(pages)
    ring_bps = _ring_cache_bytes(engine) / B
    row = {"phase": "serve_paged", "model": "gpt2_125m",
           "kv_cache_dtype": kv, "attention": "flash",
           "requests": len(reqs) + len(follow),
           "completed": len(served),
           "finish_reasons": sorted({c.finish_reason for c in served}),
           "decode_steps": len(steps), "kernel_launches": launches,
           "launches_per_step": launches / max(len(steps), 1),
           "ring_kernel_launches": ring_launches,
           **stats,
           "tokens_per_s_wall": stats["tokens"] / (t2 - t1),
           "warmup_s": t1 - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "build_max_memory_allocated": build_peak,
           "compile_counts": counts, "paging": facts,
           "prefix_hit_requests": sum(c.prefix_hit for c in served),
           "resumed_requests": sum(c.resumed for c in served),
           "prefill_chunks_run": sum(c.prefill_chunks for c in served),
           "prefill_chunks_skipped": sum(c.prefill_chunks_skipped
                                         for c in served),
           "cache_bytes": engine.cache_facts()["bytes"],
           "paged_cache_bytes_per_session": paged_bps,
           "ring_cache_bytes_per_session": ring_bps,
           "cache_bytes_ratio": paged_bps / ring_bps}
    row["decode_profile"] = _profile_decode(torch, engine,
                                            first=SYSTEM_PROMPT + 8)
    del engine, sched
    diffs, scale = _teacher_forced_diff(
        torch, kv, engine=_engine(torch, kv, "flash", kv_layout="paged"),
        oracles=(("dense", {"kv_layout": "paged"}), ("flash", {})),
        min_len=SYSTEM_PROMPT)
    row.update(teacher_forced_vs_paged_dense=diffs[0],
               teacher_forced_vs_ring_flash=diffs[1],
               teacher_forced_logit_scale=scale,
               teacher_forced_atol=TEACHER_FORCED_ATOL)
    if kv is None:
        paged, paged_counts = _greedy_streams(
            torch, Request, ContinuousBatchingScheduler, kv_layout="paged")
        ring, _ = _greedy_streams(torch, Request,
                                  ContinuousBatchingScheduler)
        row["f32_greedy_paged_equals_ring"] = paged == ring
        row["f32_greedy_compile_counts"] = paged_counts
        equal, plain_l, scan_l, scan_counts = _scan_layers_streams(
            torch, Request, ContinuousBatchingScheduler,
            flash_decode_paged, kv_layout="paged")
        row.update(f32_greedy_scan_layers_equals_unrolled=equal,
                   scan_layers_kernel_launches=scan_l,
                   unrolled_stream_kernel_launches=plain_l,
                   scan_layers_compile_counts=scan_counts)
    emit(row)
    if len(served) != len(reqs) + len(follow) or \
            row["finish_reasons"] != ["max_new_tokens"]:
        fail(f"not every paged request completed: {row}")
    if counts != {"prefill": 1, "decode": 1}:
        fail(f"paged compile_counts {counts} != "
             f"{{'prefill': 1, 'decode': 1}}")
    if launches != N_LAYER * len(steps) or not steps or ring_launches:
        fail(f"flash_decode_paged launched {launches} times over "
             f"{len(steps)} decode steps (expected {N_LAYER} per step), "
             f"flash_decode {ring_launches} (expected 0)")
    if not (facts["prefix_hits"] >= 1 and row["prefill_chunks_skipped"] > 0
            and facts["pages_paged_in"] > 0
            and row["resumed_requests"] == len(follow)):
        fail(f"paging did not share, skip and page back in: {facts}")
    if not max(diffs) <= TEACHER_FORCED_ATOL:
        fail(f"paged flash teacher-forced logits differ from paged dense / "
             f"ring flash by {diffs} > {TEACHER_FORCED_ATOL}")
    if kv is None and not row["f32_greedy_paged_equals_ring"]:
        fail("f32 greedy streams differ between the paged and ring engines")
    if kv is None:
        _check_scan_layers(row, "serve_paged")
    return row


def _ring_cache_bytes(engine):
    """Bytes of the ring cache the same engine config would hold
    (max_batch rows of max_seq)."""
    spec = engine.spec
    item = spec.dtype.itemsize
    per_layer = 2 * B * spec.max_seq * spec.n_head * spec.head_dim * item
    if spec.codec is not None:
        per_layer += 2 * B * spec.max_seq * spec.n_head * 4
    return spec.n_layer * per_layer


SPEC_K, DRAFT_LAYERS = 4, 6             # k 4, the auto n_layer // 2


def phase_serve_speculative(torch):
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler, Request)
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from deepspeed_tpu_torch.telemetry.session import TelemetrySession

    spec_cfg = {"enabled": True, "k": SPEC_K, "draft_layers": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    session = TelemetrySession(history=1_000_000)
    engine = _engine(torch, None, "flash", session=session,
                     kv_layout="paged", speculative=spec_cfg)
    build_peak = _reset_peak(torch)
    sched = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(0)
    vocab = engine.model.config.vocab_size
    warmup = Request("warmup", rng.integers(0, vocab, 8).tolist(),
                     max_new_tokens=4)
    reqs = _paged_stream(rng, vocab, Request, sessions=0)
    sched.run([warmup])
    spec = engine.speculative
    rounds0, emitted0, row_rounds0 = (spec.rounds, spec.emitted_total,
                                      spec.row_rounds)
    n0 = len(session.events.recent(event="decode_step"))
    flash_decode.launches = 0
    flash_decode_paged.launches = 0
    t1 = time.perf_counter()
    done = [c for c in sched.run(reqs) if c.rid != "warmup"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_decode_paged.launches
    ring_launches = flash_decode.launches
    evts = session.events.recent(event="decode_step")[n0:]
    draft_calls = sum(int(e["draft_len"]) for e in evts)
    stats = _step_stats(evts)
    short = [e for e in evts if int(e["tokens"]) < int(e["batch"])]
    counts = engine.compile_counts()
    facts = spec.facts()
    row = {"phase": "serve_speculative", "model": "gpt2_125m",
           "kv_layout": "paged", "attention": "flash", "k": spec.k,
           "draft_layers": spec.draft_layers,
           "requests": len(reqs), "completed": len(done),
           "finish_reasons": sorted({c.finish_reason for c in done}),
           "rounds": facts["rounds"] - rounds0,
           "mean_accepted": ((facts["emitted_total"] - emitted0)
                             / max(facts["row_rounds"] - row_rounds0, 1)),
           "draft_efficiency": facts["draft_efficiency"],
           "draft_calls": draft_calls, "kernel_launches": launches,
           "launches_per_draft_call": launches / max(draft_calls, 1),
           "ring_kernel_launches": ring_launches,
           "rounds_short_of_one_token_per_row": len(short),
           **stats,
           "tokens_per_s_wall": stats["tokens"] / (t2 - t1),
           "draft_wall_s": sum(float(e["draft_wall_s"]) for e in evts),
           "verify_wall_s": sum(float(e["verify_wall_s"]) for e in evts),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "build_max_memory_allocated": build_peak,
           "compile_counts": counts}
    del engine, sched
    spec_streams, spec_counts = _greedy_streams(
        torch, Request, ContinuousBatchingScheduler, kv_layout="paged",
        speculative=spec_cfg)
    plain_streams, _ = _greedy_streams(
        torch, Request, ContinuousBatchingScheduler, kv_layout="paged")
    row["f32_greedy_equals_plain_paged"] = spec_streams == plain_streams
    row["f32_compile_counts"] = spec_counts
    flash_decode_paged.launches = 0
    scan_streams, scan_counts = _greedy_streams(
        torch, Request, ContinuousBatchingScheduler, scan_layers=True,
        kv_layout="paged", speculative=spec_cfg)
    row.update(f32_greedy_scan_layers_equals_unrolled=(
        scan_streams == spec_streams),
        scan_layers_kernel_launches=flash_decode_paged.launches,
        scan_layers_compile_counts=scan_counts)
    emit(row)
    want = {"prefill": 1, "decode": 0, "draft": 1, "verify": 1}
    if len(done) != len(reqs) or not set(row["finish_reasons"]) <= \
            {"max_new_tokens", "length"}:
        fail(f"not every speculative request completed: {row}")
    if counts != want or spec_counts != want:
        fail(f"speculative compile_counts {counts} / {spec_counts} != {want}")
    if launches != DRAFT_LAYERS * draft_calls or not draft_calls or \
            ring_launches:
        fail(f"flash_decode_paged launched {launches} times over "
             f"{draft_calls} draft calls (expected {DRAFT_LAYERS} per "
             f"call), flash_decode {ring_launches} (expected 0)")
    if short:
        fail(f"{len(short)} speculative rounds emitted fewer tokens than "
             f"live rows")
    if not row["f32_greedy_equals_plain_paged"]:
        fail("f32 speculative greedy streams differ from the plain paged "
             "engine's")
    if not row["f32_greedy_scan_layers_equals_unrolled"] or \
            scan_counts != want or not row["scan_layers_kernel_launches"]:
        fail(f"speculative scan_layers streams differ from the unrolled "
             f"engine's, or programs {scan_counts} != {want}, or no K6 "
             f"launch ({row['scan_layers_kernel_launches']})")
    return row


# ---------------------------------------------------------------------------
# serving from a checkpoint, the replica fleet and disaggregated tiers
# ---------------------------------------------------------------------------

FLEET_REQUESTS = 16
FLEET_KILL_AFTER = 4      # decode steps replica 0 runs before it is killed
TINY_SPEC = {"max_batch": 2, "seq_buckets": [16, 32], "prefill_chunk": 4,
             "attention_impl": "flash"}


def _serve_cli(argv):
    """``inference/serve.py``'s ``main`` in this process: (exit code, the
    JSON it printed)."""
    import contextlib
    import io

    from deepspeed_tpu_torch.inference import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--device", "cuda", "--json", *argv])
    return rc, json.loads(buf.getvalue())


def _decode_counters():
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    flash_decode.launches = 0
    flash_decode_paged.launches = 0
    return flash_decode, flash_decode_paged


def _tokens(completions):
    return {c["rid"]: list(c["tokens"]) for c in completions}


def _one_engine_stream(torch, build, reqs):
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler)
    engine = build()
    done = ContinuousBatchingScheduler(engine).run(reqs)
    del engine
    torch.cuda.empty_cache()
    return {c.rid: list(c.tokens) for c in done}


def _fleet_stream(Request, vocab, n, seed):
    """The paged serve stream without sessions (a shared 256-token system
    prompt plus 8-120 tokens of each request's own, 32 new tokens)."""
    return _paged_stream(np.random.default_rng(seed), vocab, Request, n=n,
                         sessions=0)


def _tiny_stream(Request, n, seed):
    rng = np.random.default_rng(seed)
    return [Request(f"t{i}", rng.integers(0, 256, int(rng.integers(2, 24)))
                    .tolist(), max_new_tokens=8) for i in range(n)]


def _per_replica_tokens_per_s(completions, wall):
    out = {}
    for c in completions:
        key = str(c["replica"])
        out[key] = out.get(key, 0) + len(c["tokens"])
    return {k: v / wall for k, v in sorted(out.items())}


def phase_serve_checkpoint(torch):
    """GPT-2 125M trained one step through ``initialize`` (bf16 over fp32
    masters), saved with ``save_checkpoint``, then served with ``serve
    --checkpoint`` (ring layout, int8 KV, flash decode K5). The greedy
    streams must equal those of an engine built straight from the
    training engine's fp32 params, bit for bit."""
    import tempfile

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_125m

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    train_cfg = gpt2_125m(use_flash_attention=True)
    model = GPT2LMHead(train_cfg, device="cuda", generator=gen)
    engine, _, _, _ = initialize(
        model=model,
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}})
    rng = np.random.default_rng(3)
    loss = float(engine.train_batch(
        {"input_ids": rng.integers(0, train_cfg.vocab_size, (2, 128))}))
    params = {n: t.detach().float().clone()
              for n, t in engine._checkpoint_state_tree()["params"].items()}
    serve_cfg = {"max_batch": B, "seq_buckets": (128, 512),
                 "prefill_chunk": 64, "kv_cache_dtype": "int8",
                 "attention_impl": "flash"}
    reqs = [Request(f"c{i}", rng.integers(0, train_cfg.vocab_size,
                                          int(rng.integers(8, 120)))
                    .tolist(), max_new_tokens=32) for i in range(8)]
    with tempfile.TemporaryDirectory(prefix="serve_ckpt_") as root:
        ckpt = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        engine.save_checkpoint(ckpt, tag="step1")
        save_s = time.perf_counter() - t0
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()

        def direct():
            m = GPT2LMHead(gpt2_125m(dtype=torch.float32), device="cuda")
            return InferenceEngine(m, params, config=serve_cfg,
                                   device="cuda")

        want = _one_engine_stream(torch, direct, reqs)
        requests = os.path.join(root, "requests.jsonl")
        with open(requests, "w") as f:
            for r in reqs:
                f.write(json.dumps({"rid": r.rid, "prompt": r.prompt,
                                    "max_new_tokens": 32}) + "\n")
        fd, fdp = _decode_counters()
        t1 = time.perf_counter()
        rc, out = _serve_cli(
            ["--checkpoint", ckpt, "--n-head", str(train_cfg.n_head),
             "--requests", requests, "--max-batch", str(B),
             "--seq-buckets", "128,512", "--prefill-chunk", "64",
             "--kv-cache-dtype", "int8", "--attention", "flash",
             "--expect-compiles", "2"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        launches, paged = fd.launches, fdp.launches
    got = _tokens(out["completions"])
    row = {"phase": "serve_checkpoint", "model": "gpt2_125m",
           "train_loss": loss, "checkpoint": out.get("checkpoint"),
           "requests": len(reqs), "completed": len(got),
           "streams_equal_training_params": got == want,
           "decode_steps": out["decode_steps"],
           "compile_counts": out["compile_counts"],
           "kernel_launches": launches, "paged_kernel_launches": paged,
           "save_s": save_s, "load_and_serve_s": serve_s, "exit": rc}
    emit(row)
    if rc != 0 or got != want:
        fail(f"serve --checkpoint: exit {rc}; streams equal to the "
             f"training params' engine: {got == want}")
    if launches != N_LAYER * out["decode_steps"] or paged:
        fail(f"serve --checkpoint launched K5 {launches} times over "
             f"{out['decode_steps']} decode steps (expected {N_LAYER} a "
             f"step) and K6 {paged} (expected 0)")
    return row


def phase_serve_fleet(torch):
    """The fleet router over two thread replicas of GPT-2 125M in the
    serving row's paged configuration (int8 KV, flash decode K6), one
    killed mid-flight; then two ``fleet_worker.py`` processes at the
    serve CLI's width (``gpt2_tiny``, flash decode K5) on the card, one
    SIGKILLed at decode step 3. Every stream must equal the one-engine
    stream of the same weights, bit for bit."""
    import tempfile
    import threading

    from deepspeed_tpu_torch.inference import fleet
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.router import FleetRouter
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.inference.serve import seeded_tiny_model

    torch.cuda.empty_cache()
    vocab = 50257

    def build():
        return _engine(torch, "int8", "flash", kv_layout="paged")

    want = _one_engine_stream(
        torch, build, _fleet_stream(Request, vocab, FLEET_REQUESTS, 6))
    # decode calls per replica: each launches K6 once a layer (a
    # scheduler step that admits nothing runs no decode, so the
    # replicas' step counts are not the measure)
    steps = [0, 0]

    def counted(index):
        engine = build()
        real = engine.decode

        def decode(*a, **kw):
            steps[index] += 1
            if index == 0 and steps[0] == FLEET_KILL_AFTER:
                reps[0].kill()
            return real(*a, **kw)
        engine.decode = decode
        return engine

    reps = [fleet.ThreadReplica(0, lambda: counted(0)),
            fleet.ThreadReplica(1, lambda: counted(1))]
    fd, fdp = _decode_counters()
    for r in reps:
        r.start()
    t0 = time.perf_counter()
    thread_router = FleetRouter(reps, backoff_base_s=0.0)
    fr = thread_router.run(_fleet_stream(Request, vocab, FLEET_REQUESTS, 6),
                           timeout_s=300.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    thread_launches, thread_ring = fdp.launches, fd.launches
    got = _tokens(fr.completions)
    thread = {"replicas": fr.replicas, "replicas_dead": fr.replicas_dead,
              "dead_causes": {str(k): v
                              for k, v in thread_router.dead.items()},
              "redispatched": fr.redispatched_total,
              "latency_s": fr.latency_s, "wall_s": wall,
              "tokens_per_s_per_replica": _per_replica_tokens_per_s(
                  fr.completions, wall),
              "streams_equal_one_engine": got == want,
              "stats": fr.stats, "decode_calls": list(steps),
              "kernel_launches": thread_launches,
              "ring_kernel_launches": thread_ring}
    gc.collect()
    torch.cuda.empty_cache()

    # the process fleet: two workers, replica 0 SIGKILLs itself
    spec = {"inf_cfg": dict(TINY_SPEC), "seed": 0, "device": "cuda"}
    want_tiny = _one_engine_stream(
        torch, lambda: InferenceEngine(seeded_tiny_model(0, "cuda"),
                                       config=dict(TINY_SPEC),
                                       device="cuda"),
        _tiny_stream(Request, 12, 7))
    with tempfile.TemporaryDirectory(prefix="serve_fleet_") as workdir:
        t1 = time.perf_counter()
        procs = fleet.build_process_fleet(
            2, spec, workdir, inject={"kill": {"op": "decode_step",
                                               "at_step": 3}})
        ready_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        router = FleetRouter(procs, backoff_base_s=0.0)
        try:
            pr = router.run(_tiny_stream(Request, 12, 7), timeout_s=300.0)
        finally:
            for r in procs:
                if r.proc.poll() is None:
                    r.kill()
                r.reap()
        pwall = time.perf_counter() - t2
    tiny_got = _tokens(pr.completions)
    proc_launches = sum(st.get("launches", {}).get("flash_decode", 0)
                        for st in pr.stats)
    proc_steps = sum(st["steps"] for st in pr.stats)
    process = {"replicas": pr.replicas, "replicas_dead": pr.replicas_dead,
               "dead_causes": {str(k): v for k, v in router.dead.items()},
               "redispatched": pr.redispatched_total,
               "latency_s": pr.latency_s, "ready_s": ready_s,
               "wall_s": pwall,
               "tokens_per_s_per_replica": _per_replica_tokens_per_s(
                   pr.completions, pwall),
               "streams_equal_one_engine": tiny_got == want_tiny,
               "stats": pr.stats, "decode_steps": proc_steps,
               "kernel_launches": proc_launches}
    row = {"phase": "serve_fleet", "thread_fleet": dict(
        thread, model="gpt2_125m", kv_layout="paged",
        kv_cache_dtype="int8", attention="flash"),
        "process_fleet": dict(process, model="gpt2_tiny",
                              inf_cfg=TINY_SPEC)}
    emit(row)
    for name, part, ok in (("thread", thread, fr.ok),
                           ("process", process, pr.ok)):
        if not ok or not part["streams_equal_one_engine"]:
            fail(f"{name} fleet: ok {ok}, streams equal to one engine's: "
                 f"{part['streams_equal_one_engine']}")
        if part["replicas_dead"] != 1 or part["redispatched"] < 1:
            fail(f"{name} fleet: {part['replicas_dead']} replicas died and "
                 f"{part['redispatched']} requests were redispatched "
                 f"(expected 1 and >= 1)")
    if thread_launches != N_LAYER * sum(steps) or not thread_launches or \
            thread_ring:
        fail(f"the thread fleet launched K6 {thread_launches} times over "
             f"{steps} decode calls (expected {N_LAYER} a call) and K5 "
             f"{thread_ring} (expected 0)")
    tiny_layers = _tiny_geometry(torch, "ring")[0].n_layer
    if proc_launches != tiny_layers * proc_steps or not proc_launches:
        fail(f"the surviving fleet worker launched K5 {proc_launches} "
             f"times over {proc_steps} decode steps (expected "
             f"{tiny_layers} a step)")
    for st in fr.stats + pr.stats:
        if st["compile_counts"] != {"prefill": 1, "decode": 1}:
            fail(f"a surviving replica holds {st['compile_counts']}")
    return row


def phase_serve_disagg(torch):
    """Disaggregated serving: ``DisaggCoordinator`` with the device store
    at GPT-2 125M in the serving row's paged configuration (int8 KV,
    flash decode K6 on the decode tier), then ``serve --disaggregate``
    with a prefill and a decode process at the serve CLI's width and the
    file store. Streams equal the colocated engine's; each tier holds
    one program."""
    import tempfile

    from deepspeed_tpu_torch.inference.disagg import (
        DecodeWorker, DeviceHandoffStore, DisaggCoordinator, PrefillWorker)
    from deepspeed_tpu_torch.inference.fleet import TierThreadReplica
    from deepspeed_tpu_torch.inference.router import DisaggRouter
    from deepspeed_tpu_torch.inference.scheduler import Request

    class TimedStore(DeviceHandoffStore):
        """The device store with each park and install timed on the
        card (synchronized at both ends)."""

        def __init__(self):
            super().__init__()
            self.park_s, self.install_s = [], []

        def _timed(self, out, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*args)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            return got

        def park(self, rid, engine, page_ids, meta):
            return self._timed(self.park_s, super().park, rid, engine,
                               page_ids, meta)

        def install(self, rid, engine, page_ids):
            return self._timed(self.install_s, super().install, rid,
                               engine, page_ids)

    torch.cuda.empty_cache()
    vocab = 50257

    def build(**extra):
        return _engine(torch, "int8", "flash", kv_layout="paged", **extra)

    want = _one_engine_stream(
        torch, build, _fleet_stream(Request, vocab, FLEET_REQUESTS, 8))
    store = TimedStore()
    coord = DisaggCoordinator([build(tier="prefill")],
                              [build(tier="decode")], store=store)
    fd, fdp = _decode_counters()
    t0 = time.perf_counter()
    comps = coord.run(_fleet_stream(Request, vocab, FLEET_REQUESTS, 8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ring = fdp.launches, fd.launches
    stats = coord.tier_stats()
    decode_steps = sum(w["steps"] for w in stats["decode"]["per_worker"])
    got = _tokens(comps)
    coordinator = {
        "model": "gpt2_125m", "kv_layout": "paged",
        "kv_cache_dtype": "int8", "attention": "flash",
        "requests": FLEET_REQUESTS, "completed": len(comps),
        "streams_equal_colocated": got == want, "wall_s": wall,
        "handoffs": stats["handoffs"],
        "handoff_bytes": stats["handoff_bytes"],
        "handoff_bytes_per_session": stats["handoff_bytes_per_session"],
        "park_ms_p50": _percentile(store.park_s, 0.5) * 1e3,
        "install_ms_p50": _percentile(store.install_s, 0.5) * 1e3,
        "handoff_ms_per_request": (sum(store.park_s) + sum(
            store.install_s)) / max(stats["handoffs"], 1) * 1e3,
        "compile_counts": {"prefill": stats["prefill"]["compile_counts"],
                           "decode": stats["decode"]["compile_counts"]},
        "decode_steps": decode_steps, "kernel_launches": launches,
        "ring_kernel_launches": ring}
    del coord, store
    gc.collect()
    torch.cuda.empty_cache()

    # thread tiers: the router over a prefill and a decode tier thread,
    # each on a CUDA stream of its own, so every handoff's copy is queued
    # on the prefill stream and its install on the decode stream
    tstore = DeviceHandoffStore()
    decode_calls = [0]

    def counted_decode():
        engine = build(tier="decode")
        real = engine.decode

        def decode(*a, **kw):
            decode_calls[0] += 1
            return real(*a, **kw)
        engine.decode = decode
        return DecodeWorker(engine, tstore)

    tiers = [TierThreadReplica(
        0, lambda: PrefillWorker(build(tier="prefill"), tstore)),
        TierThreadReplica(1, counted_decode)]
    fd, fdp = _decode_counters()
    for r in tiers:
        r.start()
    t2 = time.perf_counter()
    tr = DisaggRouter(tiers[:1], tiers[1:], tstore).run(
        _fleet_stream(Request, vocab, FLEET_REQUESTS, 8), timeout_s=300.0)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t2
    thread = {
        "model": "gpt2_125m", "ok": tr.ok, "completed": len(tr.completions),
        "streams_equal_colocated": _tokens(tr.completions) == want,
        "wall_s": twall, "handoffs": tr.handoffs,
        "handoff_bytes": tr.handoff_bytes, "ttft_s": tr.ttft_s,
        "latency_s": tr.latency_s,
        "tiers": {st["tier"]: st["compile_counts"] for st in tr.stats},
        "decode_calls": decode_calls[0], "kernel_launches": fdp.launches,
        "ring_kernel_launches": fd.launches}
    del tiers, tstore
    gc.collect()
    torch.cuda.empty_cache()

    base = ["--synthetic", "8", "--max-new", "8", "--seed", "9",
            "--kv-layout", "paged", "--attention", "flash"]
    _, colocated = _serve_cli(base)
    with tempfile.TemporaryDirectory(prefix="serve_disagg_") as workdir:
        t1 = time.perf_counter()
        rc, tiers = _serve_cli(base + ["--disaggregate", "--workdir",
                                       workdir, "--expect-compiles", "2"])
        pwall = time.perf_counter() - t1
    dg = tiers["disagg"]
    proc_launches = sum(st.get("launches", {}).get("flash_decode_paged", 0)
                        for st in dg["stats"])
    proc_steps = sum(st["steps"] for st in dg["stats"]
                     if st["tier"] == "decode")
    process = {
        "model": "gpt2_tiny", "exit": rc,
        "streams_equal_colocated": _tokens(tiers["completions"])
        == _tokens(colocated["completions"]),
        "handoffs": dg["handoffs"], "handoff_bytes": dg["handoff_bytes"],
        "handoff_bytes_per_session": dg["handoff_bytes_per_session"],
        "ttft_s": dg["ttft_s"], "latency_s": dg["latency_s"],
        "total_compiles": dg["total_compiles"], "wall_s": pwall,
        "tiers": {st["tier"]: st["compile_counts"] for st in dg["stats"]},
        "decode_steps": proc_steps, "kernel_launches": proc_launches}
    row = {"phase": "serve_disagg", "coordinator": coordinator,
           "thread_tiers": thread, "process_tiers": process}
    emit(row)
    pins = {"prefill": {"prefill": 1, "decode": 0},
            "decode": {"prefill": 0, "decode": 1}}
    if not coordinator["streams_equal_colocated"] or \
            len(comps) != FLEET_REQUESTS:
        fail("disaggregated 125M streams differ from the colocated "
             "engine's")
    if not thread["ok"] or not thread["streams_equal_colocated"] or \
            thread["completed"] != FLEET_REQUESTS:
        fail("disaggregated 125M thread tiers: streams differ from the "
             "colocated engine's")
    if coordinator["compile_counts"] != pins or process["tiers"] != pins \
            or thread["tiers"] != pins:
        fail(f"tier program pins: coordinator "
             f"{coordinator['compile_counts']}, thread {thread['tiers']}, "
             f"process {process['tiers']}")
    if launches != N_LAYER * decode_steps or not launches or ring:
        fail(f"the decode tier launched K6 {launches} times over "
             f"{decode_steps} steps (expected {N_LAYER} a step), K5 {ring}")
    if thread["kernel_launches"] != N_LAYER * thread["decode_calls"] or \
            not thread["kernel_launches"] or thread["ring_kernel_launches"]:
        fail(f"the decode tier thread launched K6 "
             f"{thread['kernel_launches']} times over "
             f"{thread['decode_calls']} decode calls (expected {N_LAYER} a "
             f"call), K5 {thread['ring_kernel_launches']}")
    tiny_layers = _tiny_geometry(torch, "paged")[0].n_layer
    if rc != 0 or not process["streams_equal_colocated"] or \
            proc_launches != tiny_layers * proc_steps or not proc_launches:
        fail(f"serve --disaggregate: exit {rc}, streams equal "
             f"{process['streams_equal_colocated']}, K6 launches "
             f"{proc_launches} over {proc_steps} decode steps (expected "
             f"{tiny_layers} a step)")
    return row


# ---------------------------------------------------------------------------
# training slice: flash attention K1-K3, fused Adam K4, GPT-2 350M
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D = 8, 1024, 16, 64
TRAIN_LAYERS = 24
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
HEAD_OFFSET, NUM_HEADS = 3, 24      # a head shard's global coordinates
BF16_PEAK_FLOPS = 989e12             # H100 SXM dense bf16
# K1-K3 outputs are one rounding of fp32 sums that the kernel and the
# plain version take in different orders: up to one unit in the last
# place of the output type (relative), plus fp32 summation noise of
# ~1e-5 of the largest value
TRAIN_RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10,
              "float32": 1e-4}
TRAIN_ATOL_REL = 1e-5
# flash vs dense engines on the same params and batch, bf16: the dense
# route rounds scores, probabilities and their gradients to bf16, the
# kernels keep them in fp32. Losses (~11 nats) over 3 steps: the gap
# measured at step 1 is ~1e-4, so 5e-3 leaves 50x. The c_attn weight
# gradients of the first micro-batch (the q, k and v rows: what dq, dk
# and dv feed), as ||flash - dense|| / ||dense|| over the 24 layers:
# bf16 rounding of each value (2^-9 to 2^-8) puts the honest gap at a
# few percent at most; a wrong K2 or K3 gives ~1.
TRAIN_LOSS_ATOL = 5e-3
TRAIN_GRAD_RTOL = 0.05
# K4 against its plain version, relative to the leaf's largest value
ADAM_RTOL = 1e-6


def _off_by_one(torch, x):
    """``x`` copied into a view one element into its storage (2 bytes off
    a 16-byte boundary for bf16)."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = base[1:].view(x.shape)
    view.copy_(x)
    return view


def _attn_inputs(torch, b, t, h, d, dtype, bias, gen, fused=True):
    """q, k, v as strided views of one fused [B, T, 3, H, D] tensor (as
    the model's c_attn output gives them; with ``fused`` False, three
    contiguous tensors; with ``fused`` "misaligned", q, k, v and dO each
    one element into its storage), dO, and a key bias with every 7th key
    hard-masked."""
    if fused is True:
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q, k, v = (torch.randn((b, t, h, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
    g = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    if fused == "misaligned":
        q, k, v, g = (_off_by_one(torch, x) for x in (q, k, v, g))
    kb = None
    if bias:
        from deepspeed_tpu_torch.ops.flash_attention import MASK_BIAS
        kb = torch.randn((b, t), generator=gen, device="cuda")
        kb[:, 3::7] = MASK_BIAS
    return q, k, v, g, kb


def _close(torch, got, want, rtol):
    """(max |diff|, within atol + rtol * |want|) for one output."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allowed = TRAIN_ATOL_REL * float(want.abs().max()) + rtol * want.abs()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= allowed).all())
    return float(diff.max()), ok


def _routes(fa):
    """{K: {route: launches}} of the three attention wrappers."""
    return {key: dict(w.routes) for key, w in (
        ("K1", fa.flash_attention_fwd), ("K2", fa.flash_attention_bwd_dq),
        ("K3", fa.flash_attention_bwd_dkv))}


def _route_taken(before, after):
    """{K: the one route launched between two ``_routes`` readings}."""
    taken = {}
    for key in before:
        moved = [r for r in before[key] if after[key][r] != before[key][r]]
        taken[key] = moved[0] if len(moved) == 1 else moved
    return taken


def _attn_case(torch, fa, gen, b, t, h, d, dtype, causal, bias, rate,
               fused=True):
    """K1, K2, K3 against their plain versions on one input set; the case
    also records the route each kernel took and the route the rule
    names: bf16 with 16-byte rows of at most 128 elements on an aligned
    base takes the tensor cores, anything else the FMA kernels."""
    q, k, v, g, kb = _attn_inputs(torch, b, t, h, d, getattr(torch, dtype),
                                  bias, gen, fused)
    # the head shard's global coordinates; a case with more heads than
    # NUM_HEADS - HEAD_OFFSET (GPT-2 1.5B's 25) widens the global count
    kw = dict(key_bias=kb, causal=causal, dropout_rate=rate,
              dropout_seed=-123456789, dropout_head_offset=HEAD_OFFSET,
              dropout_num_heads=max(NUM_HEADS, HEAD_OFFSET + h))
    routes_before = _routes(fa)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * ref_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, ref_lse, delta, **kw)
    ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, ref_lse, delta,
                                                 **kw)
    dk, dv, db = fa.flash_attention_bwd_dkv(q, k, v, g, ref_lse, delta, **kw)
    ref_dk, ref_dv, ref_db = fa.flash_attention_bwd_dkv_reference(
        q, k, v, g, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    taken = _route_taken(routes_before, _routes(fa))
    want_route = "tensor_core" if (dtype == "bfloat16" and d % 8 == 0 and
                                   d <= 128 and fused != "misaligned") \
        else "fma"
    rtol = TRAIN_RTOL[dtype]
    checks = {"out": _close(torch, out, ref_out, rtol),
              "lse": _close(torch, lse, ref_lse, TRAIN_RTOL["float32"]),
              "dq": _close(torch, dq, ref_dq, rtol),
              "dk": _close(torch, dk, ref_dk, rtol),
              "dv": _close(torch, dv, ref_dv, rtol)}
    if bias:
        checks["dbias"] = _close(torch, db, ref_db, TRAIN_RTOL["float32"])
    case = {"B": b, "T": t, "H": h, "D": d, "dtype": dtype,
            "causal": causal, "bias": bias, "dropout": rate, "fused": fused,
            "routes": taken, "want_route": want_route,
            "max_abs_err": {n: c[0] for n, c in checks.items()},
            "ok": all(c[1] for c in checks.values()) and all(
                r == want_route for r in taken.values())}
    return case


def _dropout_bitwise(torch, fa):
    """K1's dropout mask, read back: with q = k = 0 every probability is
    1/S and v = I (S = D = 64) makes out[t, d] = mult(t, d) / S, so on
    f32 inputs ``out * S`` must equal ``dropout_multiplier`` bit for bit.
    On bf16 inputs (the tensor-core kernel) the zeros of ``out`` must be
    exactly the dropped keys."""
    b, t, h, s = 2, 128, TRAIN_H, 64
    q = torch.zeros((b, t, h, s), device="cuda")
    k = torch.zeros((b, s, h, s), device="cuda")
    v = torch.eye(s, device="cuda")[None, :, None, :].expand(
        b, s, h, s).contiguous()
    ok = True
    for seed, rate in ((-123456789, 0.1), (7, 0.5), (2 ** 31 - 1, 0.25)):
        kw = dict(causal=False, dropout_rate=rate, dropout_seed=seed,
                  dropout_head_offset=HEAD_OFFSET, dropout_num_heads=NUM_HEADS)
        out, _ = fa.flash_attention_fwd(q, k, v, **kw)
        mult = fa._dropout_multiplier_full(b, h, t, s, rate, seed,
                                           HEAD_OFFSET, NUM_HEADS,
                                           device="cuda")
        ok = ok and bool(torch.equal(out.permute(0, 2, 1, 3) * s, mult))
        out16, _ = fa.flash_attention_fwd(*(x.bfloat16() for x in (q, k, v)),
                                          **kw)
        ok = ok and bool(torch.equal(out16.permute(0, 2, 1, 3) != 0,
                                     mult != 0))
    return ok


def _tile_check(torch, fa):
    """The tensor-core kernels' TMA loads and wgmma forms on one 64 x N x
    K bf16 product each, against ``torch.matmul`` in fp32: K-major B
    (A from shared memory, as S = Q.K^T) and MN-major B (A in registers,
    as O += P.V), N and K in {64, 128}. bf16 products are exact in fp32,
    so both sides differ only in the order of K fp32 additions: at most
    2 K 2^-24 sum_k |a b| per element (each sum's rounding bound)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    results, ok = [], True
    for mn in (False, True):
        for n in (64, 128):
            for kd in (64, 128):
                a = torch.randn((64, kd), generator=gen,
                                device="cuda").bfloat16()
                b = torch.randn((kd, n) if mn else (n, kd), generator=gen,
                                device="cuda").bfloat16()
                got = fa.wgmma_tile_product(a, b, mn)
                bf = b.float() if mn else b.float().T
                want = a.float() @ bf
                bound = 2 * kd * 2.0 ** -24 * (a.float().abs() @ bf.abs())
                err = float((got - want).abs().max())
                case_ok = bool(((got - want).abs() <= bound).all())
                results.append({"b_mn_major": mn, "N": n, "K": kd,
                                "max_abs_err": err, "ok": case_ok})
                ok = ok and case_ok
    return results, ok


ADAM_SIZES = (1, 3, 517, 4099, 65536 + 5, 300001)


def _adam_leaves(torch, gen, misaligned):
    leaves = []
    for i, n in enumerate(ADAM_SIZES):
        group = []
        for _ in range(4):
            base = torch.empty(n + 1, device="cuda")
            x = base[1:] if (misaligned and i % 2) else base[:n]
            group.append(x)
        p, g, m, v = group
        p.copy_(torch.randn(n, generator=gen, device="cuda"))
        g.copy_(torch.randn(n, generator=gen, device="cuda"))
        m.zero_()
        v.zero_()
        leaves.append(group)
    return leaves


def _adam_compare(kern, plain):
    """(max |diff|, all within ADAM_RTOL) over paired K4 / plain
    tensors."""
    worst, ok = 0.0, True
    for a, b in zip(kern, plain):
        err = float((a - b).abs().max())
        worst = max(worst, err)
        ok = ok and err <= ADAM_RTOL * (1.0 + float(b.abs().max()))
    return worst, ok


def _adam_check(torch):
    """K4 against its plain version: 3 steps then a skipped one, both
    modes, odd leaf sizes, some leaves 4 bytes off 16-byte alignment."""
    from deepspeed_tpu_torch.ops.fused_adam import (
        adam_hyperparams, fused_adam, fused_adam_reference)
    worst, ok = 0.0, True
    for adam_w in (True, False):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        kern = _adam_leaves(torch, gen, misaligned=True)
        plain = [[x.clone() for x in group] for group in kern]
        for step in range(1, 5):
            skip = 1.0 if step == 4 else 0.0
            hyper = adam_hyperparams(1e-3, 0.9, 0.999, 1e-8, 0.01,
                                     1.0 - 0.9 ** step, 1.0 - 0.999 ** step,
                                     skip, "cuda")
            before = [x.clone() for group in kern for x in group]
            for leaves, fn in ((kern, fused_adam),
                               (plain, fused_adam_reference)):
                p, g, m, v = (list(c) for c in zip(*leaves))
                fn(p, g, m, v, hyper, adam_w_mode=adam_w)
            torch.cuda.synchronize()
            err, step_ok = _adam_compare((x for gr in kern for x in gr),
                                         (x for gr in plain for x in gr))
            worst, ok = max(worst, err), ok and step_ok
            if skip:
                after = [x for group in kern for x in group]
                ok = ok and all(torch.equal(a, b)
                                for a, b in zip(before, after))
    return worst, ok


def phase_train_kernel_check(torch):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    tiles, tiles_ok = _tile_check(torch, fa)
    emit({"phase": "train_kernel_check", "wgmma_tile_check": tiles})
    if not tiles_ok:
        fail(f"the wgmma tile product disagrees with torch.matmul: {tiles}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    grid = [(2, 128, TRAIN_H, 64, dt, c, bias, r)
            for dt in ("bfloat16", "float32") for c in (True, False)
            for bias in (False, True) for r in (0.0, 0.1)]
    grid += [(2, 1000, TRAIN_H, 64, "bfloat16", True, True, 0.1),
             (2, 1000, TRAIN_H, 64, "float32", False, False, 0.1),
             (TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D, "bfloat16", True, False,
              0.0),
             (2, 1000, TRAIN_H, 128, "bfloat16", True, True, 0.1),
             (2, 128, TRAIN_H, 128, "float32", False, True, 0.0),
             (2, 1000, TRAIN_H, 64, "bfloat16", False, True, 0.1, False),
             # off TMA's rule: the FMA kernels (72-byte rows; a view 2
             # bytes off its boundary)
             (2, 1000, TRAIN_H, 36, "bfloat16", True, True, 0.1),
             (2, 100, 4, 36, "bfloat16", False, False, 0.0, False),
             (2, 1000, TRAIN_H, 64, "bfloat16", True, True, 0.1,
              "misaligned"),
             (2, 128, TRAIN_H, 128, "bfloat16", False, False, 0.0,
              "misaligned"),
             # what the offload slice's paths give K1-K3: GPT-2 1.5B
             # (train_offload, 25 heads) and 125M (offload_resume, 12)
             (OFFLOAD_B, OFFLOAD_T, OFFLOAD_HEADS, 64, "bfloat16", True,
              False, 0.0),
             (RESUME_B, RESUME_T, RESUME_HEADS, 64, "bfloat16", True, False,
              0.0)]
    # head dims past 128: the FMA kernels in every dtype (K2 / K3 on
    # 32-row tiles past 128)
    grid += [(2, 300, TRAIN_H, d, dt, True, True, 0.1)
             for d in (160, 256)
             for dt in ("float32", "bfloat16", "float16")]
    # past 256: column chunks of 256 a CTA, the scores streamed over D
    grid += [(2, 300, 4, d, dt, causal, causal, 0.1 if causal else 0.0)
             for d in (320, 512) for causal in (True, False)
             for dt in ("float32", "bfloat16", "float16")]
    cases = []
    for spec in grid:
        case = _attn_case(torch, fa, gen, *spec)
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "train_kernel_check", "failed": case})
            fail(f"flash attention kernels disagree with their plain "
                 f"versions: {case}")
    bitwise = _dropout_bitwise(torch, fa)
    adam_err, adam_ok = _adam_check(torch)
    errs = {
        "K1": max(max(c["max_abs_err"]["out"], c["max_abs_err"]["lse"])
                  for c in cases),
        "K2": max(c["max_abs_err"]["dq"] for c in cases),
        "K3": max(max(v for n, v in c["max_abs_err"].items()
                      if n in ("dk", "dv", "dbias")) for c in cases),
        "K4": adam_err}
    emit({"phase": "train_kernel_check", "cases": len(cases),
          "dropout_mask_bitwise": bitwise, "adam_ok": adam_ok,
          "max_abs_err": errs, "rtol": TRAIN_RTOL,
          "atol_rel": TRAIN_ATOL_REL, "results": cases})
    if not bitwise:
        fail("K1's dropout mask differs from dropout_multiplier")
    if not adam_ok:
        fail(f"fused_adam disagrees with its plain version ({adam_err})")
    return errs


def _causal_pairs(b, h, t):
    return b * h * t * (t + 1) // 2


def _gpt2_shapes(cfg):
    """The 292 param shapes of GPT-2 (wte, wpe, 12 per layer, ln_f)."""
    c = cfg.n_embd
    layer = [(c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,), (c,), (c,),
             (4 * c, c), (4 * c,), (c, 4 * c), (c,)]
    return ([(cfg.vocab_size, c), (cfg.n_positions, c)]
            + layer * cfg.n_layer + [(c,), (c,)])


def _timing_row(torch, kern, plain, flops, nbytes, dtype, lib=None,
                ops_per_s=None):
    """One kernel's timing row. The bound takes the operations at the
    peak for the inputs' type (bf16 tensor cores for the attention
    kernels), or at ``ops_per_s`` where the caller names the rate the
    kernel's precision allows, the least time the card could take;
    ``fp32_ops_ms`` is the same count at the fp32 (CUDA-core) peak, the
    rate the FMA kernels multiply at."""
    ms, paced, _ = _time_ms(torch, kern, 10)
    plain_ms, _, plain_sync = _time_ms(torch, plain, 3)
    t_ops = flops / (ops_per_s or PEAK_OPS_PER_S[dtype]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    r = {"ms": ms, "host_paced_ms": paced, "plain_ms": plain_ms,
         "plain_host_syncs": plain_sync, "flops": flops,
         "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "fp32_ops_ms": flops / PEAK_OPS_PER_S["float32"] * 1e3,
         "library_ms": None}
    if lib is not None:
        r["library_ms"] = _time_ms(torch, lib, 10)[0]
    r["roofline_share"] = r["bound_ms"] / ms
    return r


def phase_train_kernel_timing(torch):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models.gpt2 import gpt2_350m
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import (
        adam_hyperparams, fused_adam, fused_adam_reference)
    b, t, h, d = TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v, g, _ = _attn_inputs(torch, b, t, h, d, torch.bfloat16, False,
                                 gen)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    pairs = _causal_pairs(b, h, t)
    io = 2 * b * t * h * d                     # bytes of one bf16 tensor
    rows = {}

    def row(name, *args, **kw):
        rows[name] = _timing_row(torch, *args, **kw)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    g_t = g.transpose(1, 2)
    row("K1", lambda i: fa.flash_attention_fwd(q, k, v),
        lambda i: fa.flash_attention_fwd_reference(q, k, v),
        4 * pairs * d, 4 * io + 4 * b * h * t, "bfloat16",
        lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))

    def sdpa_bwd(i):
        torch.autograd.grad(sdpa_out, sdpa_in, g_t, retain_graph=True)

    row("K2", lambda i: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),
        lambda i: fa.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                       delta),
        6 * pairs * d, 5 * io + 8 * b * h * t, "bfloat16", sdpa_bwd)
    row("K3", lambda i: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta),
        lambda i: fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                       delta),
        8 * pairs * d, 6 * io + 8 * b * h * t, "bfloat16", sdpa_bwd)
    del sdpa_out, sdpa_in

    # K4 over GPT-2 350M's leaves (354.8 M fp32 elements) with the main
    # path's hyperparameters (Adam, lr 1e-4, step 1, so L2 mode): one
    # step against the plain version on copies of the same leaves, then
    # the timing
    shapes = _gpt2_shapes(gpt2_350m())
    p, gr, m, vv = ([torch.randn(s, generator=gen, device="cuda") * 0.02
                     for s in shapes] for _ in range(4))
    for x in vv:
        x.abs_()
    n = sum(x.numel() for x in p)
    hyper = adam_hyperparams(1e-4, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001, 0.0,
                             "cuda")
    plain = [[x.clone() for x in xs] for xs in (p, m, vv)]
    fused_adam(p, gr, m, vv, hyper, adam_w_mode=False)
    fused_adam_reference(plain[0], gr, plain[1], plain[2], hyper,
                         adam_w_mode=False)
    torch.cuda.synchronize()
    k4_err, k4_ok = _adam_compare(p + m + vv, sum(plain, []))
    del plain
    if not k4_ok:
        fail(f"fused_adam disagrees with its plain version over the 350M "
             f"leaves ({k4_err})")
    lib_params = [torch.nn.Parameter(x.clone()) for x in p]
    for lp, x in zip(lib_params, gr):
        lp.grad = x.clone()
    adamw = torch.optim.AdamW(lib_params, lr=1e-4, fused=True)
    row("K4", lambda i: fused_adam(p, gr, m, vv, hyper, adam_w_mode=False),
        lambda i: fused_adam_reference(p, gr, m, vv, hyper,
                                       adam_w_mode=False),
        15 * n, 28 * n, "float32", lambda i: adamw.step())
    rows["K4"].update(leaves=len(p), elements=n, max_abs_err=k4_err)
    del p, gr, m, vv, lib_params, adamw
    torch.cuda.empty_cache()
    emit({"phase": "train_kernel_timing", "shape": [b, t, h, d],
          "dtype": "bfloat16", "causal": True, "results": rows})
    return rows


def _train_engine(torch, flash, extra=None, n_layer=TRAIN_LAYERS):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # gpt2_350m's widths at n_layer blocks
    model = GPT2LMHead(GPT2Config(n_embd=1024, n_layer=n_layer, n_head=16,
                                  n_positions=TRAIN_T, dropout=0.0,
                                  use_flash_attention=flash, loss_chunk=0),
                       device="cuda", generator=gen)
    config = {"train_batch_size": TRAIN_B, "bf16": {"enabled": True},
              "optimizer": {"type": "Adam",
                            "params": {"lr": 1e-4, "pallas": True}},
              "steps_per_print": 10 ** 9, **(extra or {})}
    engine, _, _, _ = initialize(model=model, config=config)
    return engine


def _flash_counters():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    return {"K1": fa.flash_attention_fwd, "K2": fa.flash_attention_bwd_dq,
            "K3": fa.flash_attention_bwd_dkv, "K4": fused_adam}


def model_flops_per_token(cfg, seq_len):
    """Matmul FLOPs per token, fwd + bwd (the JAX bench's formula,
    ``bench.py:39-48``): 6x the block and tied-head weights plus the
    attention score/value matmuls."""
    block_params = cfg.n_layer * (12 * cfg.n_embd ** 2 + 13 * cfg.n_embd)
    lm_head = cfg.vocab_size * cfg.n_embd
    attention = 12 * cfg.n_layer * cfg.n_embd * seq_len
    return 6 * (block_params + 2 * cfg.n_embd + lm_head) + attention


def _accum_run(torch, engine, batch, counters, grads_of):
    """3 steps of ``engine`` (built with gradient accumulation 2) from its
    seeded params. Step 1 goes through forward / backward / step, so the
    gradients ``grads_of(module)`` of its first micro-batch are read
    before the update. Returns the losses, those gradients, the kernel
    launches of the 3 steps and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    half = len(next(iter(batch.values()))) // 2
    micro_losses, grads = [], None
    for i in range(2):
        loss = engine.forward({k: x[i * half:(i + 1) * half]
                               for k, x in batch.items()})
        engine.backward(loss)
        micro_losses.append(float(loss.detach()))
        if grads is None:
            grads = [g.clone() for g in grads_of(engine.module)]
    engine.step()
    losses = [sum(micro_losses) / 2] + \
        [float(engine.train_batch(batch)) for _ in range(2)]
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del engine
    torch.cuda.empty_cache()
    return losses, grads, launches, peak


def _c_attn_grads(module):
    return [blk.attn.c_attn.weight.grad for blk in module.h]


def _grad_rel_err(torch, got, want, c):
    """||got - want|| / ||want|| over the layers, for each of the q, k
    and v row blocks of the c_attn weight gradient."""
    out = {}
    for i, part in enumerate("qkv"):
        a = torch.cat([g[i * c:(i + 1) * c].flatten() for g in got])
        b = torch.cat([w[i * c:(i + 1) * c].flatten() for w in want])
        out[part] = float((a - b).norm() / b.norm())
    return out


def phase_train(torch):
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 50257, (TRAIN_B, TRAIN_T))
             .astype(np.int32)}
    counters = _flash_counters()

    engine = _train_engine(torch, flash=True)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "routes"):
            c.routes = dict.fromkeys(c.routes, 0)
    losses, walls = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
    launches = {n: c.launches for n, c in counters.items()}
    routes = {n: dict(c.routes) for n, c in counters.items()
              if hasattr(c, "routes")}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    timed = walls[TRAIN_WARMUP:]
    tokens = TRAIN_B * TRAIN_T
    cfg = engine.module.config
    fpt = model_flops_per_token(cfg, TRAIN_T)
    tps = tokens * len(timed) / sum(timed)
    profile = _profile(torch, lambda: engine.train_batch(batch), 2)
    del engine
    torch.cuda.empty_cache()

    accum2 = {"gradient_accumulation_steps": 2}
    accum_losses, flash_grads, accum_launches, _ = _accum_run(
        torch, _train_engine(torch, True, accum2), batch, counters,
        _c_attn_grads)
    # the same params and micro-batches through dense attention
    dense_losses, dense_grads, _, dense_peak = _accum_run(
        torch, _train_engine(torch, False, accum2), batch, counters,
        _c_attn_grads)
    grad_err = _grad_rel_err(torch, flash_grads, dense_grads, cfg.n_embd)
    loss_gap = max(abs(a - b) for a, b in
                   zip([losses[0]] + accum_losses, dense_losses[:1]
                       + dense_losses))
    del flash_grads, dense_grads

    row = {"phase": "train", "model": "gpt2_350m", "batch": TRAIN_B,
           "seq": TRAIN_T, "dtype": "bfloat16", "attention": "flash",
           "optimizer": "adam (fused K4)", "losses": losses,
           "step_wall_s": walls, "tokens_per_s": tps,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "model_flops_per_token": fpt,
           "mfu": tps * fpt / BF16_PEAK_FLOPS,
           "max_memory_allocated": peak, "launches": launches,
           "routes": routes, "steps": steps, "profile": profile,
           "accum2_losses": accum_losses, "accum2_launches": accum_launches,
           "dense_accum2_losses": dense_losses,
           "dense_accum2_max_memory_allocated": dense_peak,
           "flash_vs_dense_loss_gap": loss_gap,
           "loss_atol": TRAIN_LOSS_ATOL,
           "flash_vs_dense_c_attn_grad_rel_err": grad_err,
           "grad_rtol": TRAIN_GRAD_RTOL}
    emit(row)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training loss not finite and falling: {losses}")
    want = {"K1": TRAIN_LAYERS * steps, "K2": TRAIN_LAYERS * steps,
            "K3": TRAIN_LAYERS * steps, "K4": steps}
    if launches != want:
        fail(f"kernel launches {launches} != {want} over {steps} steps")
    tensor_core = {key: routes[key]["tensor_core"] for key in routes}
    if any(tensor_core[key] != want[key] for key in tensor_core):
        fail(f"attention launches by route {routes}: every bf16 launch of "
             f"the main path must take the tensor cores ({want})")
    want2 = {"K1": 2 * TRAIN_LAYERS * 3, "K2": 2 * TRAIN_LAYERS * 3,
             "K3": 2 * TRAIN_LAYERS * 3, "K4": 3}
    if accum_launches != want2 or not all(np.isfinite(accum_losses)):
        fail(f"accumulation run: launches {accum_launches} != {want2} or "
             f"losses {accum_losses}")
    if not loss_gap <= TRAIN_LOSS_ATOL:
        fail(f"flash losses {losses[0]}, {accum_losses} vs dense "
             f"{dense_losses}: gap {loss_gap} > {TRAIN_LOSS_ATOL}")
    if not all(e <= TRAIN_GRAD_RTOL for e in grad_err.values()):
        fail(f"flash vs dense c_attn gradients differ by {grad_err} > "
             f"{TRAIN_GRAD_RTOL} (relative)")
    return row



ZERO_STAGES = (0, 1, 2, 3)
ZERO_WARMUP, ZERO_STEPS = 2, 5
# depth cut from 24 (widths kept): the script's 1200 s holds every phase
ZERO_LAYERS = 6


def _zero_group(torch):
    """An NCCL group of one process on a file store in a new temporary
    directory (the port's ``initialize_distributed`` with explicit
    arguments); returns the directory."""
    import tempfile
    from deepspeed_tpu_torch.parallel import initialize_distributed
    root = tempfile.mkdtemp(prefix="zero_store_")
    world = initialize_distributed(
        coordinator_address=f"file://{os.path.join(root, 'store')}",
        num_processes=1, process_id=0, device="cuda")
    import torch.distributed as dist
    if world != 1 or dist.get_backend() != "nccl":
        fail(f"train_zero: group of {world} on {dist.get_backend()}, "
             f"expected one process on nccl")
    return root


def _zero_formula(stage, p):
    """Collective bytes a step at world 1 and accumulation 1, P the fp32
    param bytes (whole tensors: the all-reduce's operand, the
    reduce-scatter's input, the all-gather's output; stage 3's gathers
    move bf16, once in the forward and once in the backward)."""
    return {0: {"all_reduce": p, "reduce_scatter": 0, "all_gather": 0},
            1: {"all_reduce": 0, "reduce_scatter": p, "all_gather": p},
            2: {"all_reduce": 0, "reduce_scatter": p, "all_gather": p},
            3: {"all_reduce": 0, "reduce_scatter": p,
                "all_gather": 2 * (p // 2)}}[stage]


def _zero_run(torch, stage, batch, counters, more=None):
    """One stage: 2 warmup and 5 timed steps of GPT-2 350M's widths at
    ``ZERO_LAYERS`` blocks through the data-parallel path (``more``:
    config keys added). Returns the row and the fp32 masters (host)."""
    extra = {"zero_optimization": {"stage": stage}} if stage else {}
    extra.update(more or {})
    gc.collect()            # nothing of an earlier phase in the peak
    torch.cuda.empty_cache()
    engine = _train_engine(torch, flash=True, extra=extra,
                           n_layer=ZERO_LAYERS)
    if not engine.comm.active:
        fail("train_zero: the engine did not join the process group")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, walls, counts = [], [], None
    for _ in range(ZERO_WARMUP + ZERO_STEPS):
        engine.comm.reset()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        counts = engine.comm.snapshot()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in counters.items()}
    masters = [m.detach().to("cpu", copy=True) for m in engine._masters]
    p_bytes = sum(4 * m.numel() for m in masters)
    plan = engine.zero3_plan
    timed = walls[ZERO_WARMUP:]
    tokens = TRAIN_B * TRAIN_T
    fpt = model_flops_per_token(engine.module.config, TRAIN_T)
    tps = tokens * len(timed) / sum(timed)
    row = {"stage": stage, "losses": losses, "step_wall_s": walls,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "tokens_per_s": tps, "mfu": tps * fpt / BF16_PEAK_FLOPS,
           "max_memory_allocated": peak, "launches": launches,
           "collectives_per_step": counts, "param_bytes": p_bytes,
           "zero3_plan": plan.to_dict() if plan is not None else None}
    if stage == 3:
        inst = engine._installer
        row["gathers"], row["regathers"] = inst.gathers, inst.regathers
        if inst.wire_dtype is not None:
            row["wire"] = _wire_check(torch, engine)
    if engine._sparse:
        m = engine._last_metrics
        row["sparse_grad_dropped"] = float(m["sparse_grad_dropped"])
        row["sparse_grad_dense_fallbacks"] = int(
            m["sparse_grad_dense_fallbacks"])
    # after every count and the masters are read: 2 more steps, profiled
    row["profile"] = _profile(torch, lambda: engine.train_batch(batch), 2)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return row, masters


def _wire_check(torch, engine):
    """Stage 3's fp8 wire: every gathered leaf against the exact gather
    (the compute-dtype master), each rank piece's round trip through the
    codec against its bound (per chunk, half an fp8 step at the chunk's
    largest value, 2^-4 relative for e4m3, plus the chunk scale's
    subnormal step and the bf16 rounding of the decode), and the bytes
    the wire moves a gather."""
    from deepspeed_tpu_torch.runtime.comm.codecs import (
        decode_wire, encode_wire, get_codec, wire_nbytes)
    inst = engine._installer
    codec, chunk = inst.wire_dtype, inst.wire_chunk
    qmax = get_codec(codec).qmax
    worst_exact, worst_ratio, nbytes = 0.0, 0.0, 0
    with torch.no_grad():
        for i, leaf in enumerate(inst.leaves):
            exact = leaf.master.detach().to(inst.dtype)
            if not leaf.part.sharded:
                continue
            got = inst._gather(i)
            worst_exact = max(worst_exact, float(
                (got.float() - leaf.part.from_gathered(
                    exact.reshape(-1)).float()).abs().max()))
            piece = exact.reshape(-1)
            dec = decode_wire(encode_wire(piece, codec, chunk), codec,
                              piece.shape, inst.dtype, chunk)
            n = piece.numel()
            c = max(1, min(chunk, n))
            pad = (-n) % c
            x = torch.cat([piece.float(), piece.new_zeros(pad).float()])
            absmax = x.view(-1, c).abs().amax(1, keepdim=True)
            bound = (2.0 ** -4 + 2.0 ** -8) * x.view(-1, c).abs() + \
                absmax / qmax * 2.0 ** -9
            err = torch.cat([(dec.float() - piece.float()).abs(),
                             piece.new_zeros(pad).float()]).view(-1, c)
            worst_ratio = max(worst_ratio, float(
                (err / bound.clamp_min(1e-30)).max()))
            nbytes += wire_nbytes(tuple(leaf.part.piece_shape), codec,
                                  chunk)
    return {"codec": codec, "chunk": chunk,
            "gathered_vs_exact_max_abs": worst_exact,
            "round_trip_err_over_bound_max": worst_ratio,
            "wire_bytes_per_gather": nbytes}


def phase_train_zero(torch):
    """GPT-2 350M in the ``train`` phase's configuration through the
    data-parallel path at ZeRO stages 0-3, in an NCCL group of one."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import destroy_distributed
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 50257, (TRAIN_B, TRAIN_T))
             .astype(np.int32)}
    import shutil
    counters = _flash_counters()
    store_dir = _zero_group(torch)
    rows, masters = {}, {}
    try:
        for stage in ZERO_STAGES:
            rows[stage], masters[stage] = _zero_run(torch, stage, batch,
                                                    counters)
        # stage 0 again: does the path repeat itself bit for bit?
        again, masters_again = _zero_run(torch, 0, batch, counters)
        # stage 3 with the fp8 wire, and stage 0 with sparse gradients
        wire, masters_wire = _zero_run(
            torch, 3, batch, counters,
            {"fp8": {"wire": {"enabled": True}}})
        csr, masters_csr = _zero_run(torch, 0, batch, counters,
                                     {"sparse_gradients": True})
    finally:
        if dist.is_initialized():
            destroy_distributed()
        shutil.rmtree(store_dir, ignore_errors=True)
    steps = ZERO_WARMUP + ZERO_STEPS
    stage0_repeats = again["losses"] == rows[0]["losses"] and all(
        torch.equal(a, b) for a, b in zip(masters_again, masters[0]))
    out = {"phase": "train_zero", "model": "gpt2_350m",
           "layers": ZERO_LAYERS, "world": 1,
           "backend": "nccl", "batch": TRAIN_B, "seq": TRAIN_T,
           "dtype": "bfloat16", "attention": "flash",
           "warmup": ZERO_WARMUP, "steps": ZERO_STEPS,
           "stage0_repeats_bitwise": stage0_repeats}
    for stage in ZERO_STAGES:
        r = rows[stage]
        r["losses_equal_stage0"] = r["losses"] == rows[0]["losses"]
        r["masters_equal_stage0"] = all(
            torch.equal(a, b) for a, b in zip(masters[stage], masters[0]))
        emit({"phase": "train_zero_stage", **r})
        out[f"stage{stage}"] = {
            k: r[k] for k in ("step_p50_ms", "tokens_per_s", "mfu",
                              "max_memory_allocated",
                              "losses_equal_stage0",
                              "masters_equal_stage0")}
    out["launches"] = {n: sum(rows[s]["launches"][n] for s in ZERO_STAGES)
                       + wire["launches"][n] + csr["launches"][n]
                       for n in counters}
    for name, r, m, ref in (("stage3_fp8_wire", wire, masters_wire, 3),
                            ("stage0_sparse_gradients", csr, masters_csr,
                             0)):
        r["losses_equal_stage"] = r["losses"] == rows[ref]["losses"]
        r["masters_equal_stage"] = all(
            torch.equal(a, b) for a, b in zip(m, masters[ref]))
        emit({"phase": f"train_zero_{name}", **r})
        out[name] = {k: r[k] for k in (
            "step_p50_ms", "max_memory_allocated", "losses_equal_stage",
            "masters_equal_stage")}
    out["stage3_fp8_wire"]["wire"] = wire["wire"]
    emit(out)
    for stage in ZERO_STAGES:
        r = rows[stage]
        losses = r["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"train_zero stage {stage}: loss not finite and falling: "
                 f"{losses}")
        want = {"K1": ZERO_LAYERS * steps, "K2": ZERO_LAYERS * steps,
                "K3": ZERO_LAYERS * steps, "K4": steps}
        if r["launches"] != want:
            fail(f"train_zero stage {stage}: launches {r['launches']} != "
                 f"{want}")
        got = {k: r["collectives_per_step"][k]["bytes"]
               for k in ("all_reduce", "reduce_scatter", "all_gather")}
        formula = _zero_formula(stage, r["param_bytes"])
        if got != formula:
            fail(f"train_zero stage {stage}: collective bytes a step {got} "
                 f"!= {formula}")
        if stage == 3:
            leaves = r["zero3_plan"]["gather_leaves"]
            if r["gathers"] != leaves * steps or \
                    r["regathers"] != leaves * steps:
                fail(f"train_zero stage 3: {r['gathers']} forward and "
                     f"{r['regathers']} backward gathers over {steps} "
                     f"steps, expected {leaves * steps} each")
        if stage0_repeats:
            if not (r["losses_equal_stage0"] and r["masters_equal_stage0"]):
                fail(f"train_zero stage {stage}: losses or fp32 masters "
                     f"differ from stage 0's ({losses} vs "
                     f"{rows[0]['losses']})")
        else:
            gap = max(abs(a - b) for a, b in zip(losses, rows[0]["losses"]))
            if not gap <= TRAIN_LOSS_ATOL:
                fail(f"train_zero stage {stage}: losses {gap} from stage "
                     f"0's (stage 0 does not repeat itself bit for bit)")
    w = wire["wire"]
    leaves = wire["zero3_plan"]["gather_leaves"]
    if wire["zero3_plan"]["wire_dtype"] != "f8e4m3fn" or \
            wire["gathers"] != leaves * steps or \
            wire["regathers"] != leaves * steps:
        fail(f"train_zero fp8 wire: plan {wire['zero3_plan']}, gathers "
             f"{wire['gathers']} / {wire['regathers']}")
    # world 1: the one piece is the rank's own, placed exactly
    if w["gathered_vs_exact_max_abs"] != 0.0 or \
            not w["round_trip_err_over_bound_max"] <= 1.0:
        fail(f"train_zero fp8 wire: gathered vs exact "
             f"{w['gathered_vs_exact_max_abs']}, round trip at "
             f"{w['round_trip_err_over_bound_max']} of the codec's bound")
    if wire["collectives_per_step"]["all_gather"]["bytes"] != \
            2 * w["wire_bytes_per_gather"]:
        fail(f"train_zero fp8 wire: all-gather bytes a step "
             f"{wire['collectives_per_step']['all_gather']['bytes']} != 2 x "
             f"wire_nbytes {w['wire_bytes_per_gather']}")
    if csr["sparse_grad_dense_fallbacks"] != 1 or \
            not csr["sparse_grad_dropped"] > 0:
        fail(f"train_zero sparse gradients: the tied wte's fallback not "
             f"counted ({csr['sparse_grad_dense_fallbacks']}, dropped "
             f"{csr['sparse_grad_dropped']})")
    for name, r, ref in (("fp8 wire", wire, 3), ("sparse gradients", csr,
                                                 0)):
        if not all(np.isfinite(r["losses"])) or \
                r["launches"] != {"K1": ZERO_LAYERS * steps,
                                  "K2": ZERO_LAYERS * steps,
                                  "K3": ZERO_LAYERS * steps, "K4": steps}:
            fail(f"train_zero {name}: losses {r['losses']}, launches "
                 f"{r['launches']}")
        if stage0_repeats and not (r["losses_equal_stage"] and
                                   r["masters_equal_stage"]):
            fail(f"train_zero {name}: losses or fp32 masters differ from "
                 f"stage {ref}'s ({r['losses']} vs {rows[ref]['losses']})")
    return out


# ---------------------------------------------------------------------------
# training features: scan_layers, progressive layer drop, LAMB, fp8 and
# activation checkpointing on the train row; BERT's checkpoint flags
# ---------------------------------------------------------------------------

FEATURE_STEPS = 4                 # a run's steps; the first is not timed
PLD_THETA, PLD_GAMMA = 0.5, 1000.0   # theta 1 at step 0, 0.5 from step 1
LAMB_LR = 1e-3
# the plain LAMB on the host against the card's step: rtol 1e-6, plus
# 1e-7 of the masters' largest magnitude where an update cancels a
# master to near 0 (the host Adam check's floor)
LAMB_RTOL, LAMB_ATOL_REL = 1e-6, 1e-7
AC_POLICIES = ("dots", "offload")
BERT_FLAGS = ("normalize_invertible", "gelu_checkpoint",
              "attn_dropout_checkpoint")


FEATURE_LAYERS = 12                # train_features' depth (350M widths)


def _seeded_state(torch):
    """The ``train`` row's widths at ``FEATURE_LAYERS`` blocks (cut from
    24 to keep the script within its time), seeded params as an fp32
    state dict on the card: every feature run starts from it."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_350m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = dataclasses.replace(
        gpt2_350m(n_positions=TRAIN_T, dropout=0.0, use_flash_attention=True,
                  loss_chunk=0), n_layer=FEATURE_LAYERS)
    model = GPT2LMHead(cfg, device="cuda", generator=gen)
    return {k: v.detach() for k, v in model.state_dict().items()}


def _feature_engine(torch, state, extra=None, optimizer=None, **model_kw):
    """GPT-2 350M on the ``train`` row's config (``extra`` added) from
    ``state``, stacked under ``scan_layers``, through ``initialize``."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2LMHead, gpt2_350m, stack_gpt2_state_dict)
    cfg = dataclasses.replace(
        gpt2_350m(n_positions=TRAIN_T, dropout=0.0, use_flash_attention=True,
                  loss_chunk=0, **model_kw), n_layer=FEATURE_LAYERS)
    model = GPT2LMHead(cfg, device="meta")
    sd = stack_gpt2_state_dict(state) if cfg.scan_layers else state
    model.load_state_dict({k: v.clone() for k, v in sd.items()},
                          assign=True)
    config = {"train_batch_size": TRAIN_B, "bf16": {"enabled": True},
              "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
              "steps_per_print": 10 ** 9, **(extra or {})}
    if optimizer is not None:
        del config["optimizer"]
    engine, _, _, _ = initialize(model=model, config=config,
                                 optimizer=optimizer)
    return engine


def _fresh(torch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _feature_run(torch, engine, batch, counters, steps=FEATURE_STEPS,
                 after_step=None):
    """``steps`` train steps: losses, walls, step p50 (the first step
    not timed), launches a step, peak memory."""
    _fresh(torch)
    for c in counters.values():
        c.launches = 0
    losses, walls, launches = [], [], []
    for _ in range(steps):
        before = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        launches.append({n: c.launches - before[n]
                         for n, c in counters.items()})
        if after_step is not None:
            after_step(engine)
    return {"losses": losses, "step_wall_s": walls,
            "step_p50_ms": statistics.median(walls[1:]) * 1e3,
            "launches_per_step": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _masters_by_name(engine):
    return {n: m.detach().to("cpu", copy=True)
            for n, m in zip(engine._param_names(), engine._masters)}


def _drop(torch, engine):
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def _lamb_plain_check(torch, engine, batch):
    """One LAMB step through forward / backward / step against the plain
    ``lamb_update`` on host copies of the same masters, gradients and
    moments (fp32). Returns (the step's loss, max relative error, its
    tolerance's atol, within)."""
    from deepspeed_tpu_torch.ops.lamb import LambState, lamb_update
    loss = float(engine.forward(batch))
    engine.backward()
    def host(ts):
        return [t.detach().to("cpu", copy=True) for t in ts]

    masters, grads = host(engine._masters), host(engine._grads)
    s = engine.opt_state
    state = LambState(m=host(s.m), v=host(s.v),
                      step=s.step.to("cpu", copy=True))
    engine.step()
    want, _ = lamb_update(masters, grads, state, lr=LAMB_LR,
                          beta1=engine._betas[0], beta2=engine._betas[1],
                          eps=engine._eps, weight_decay=engine._weight_decay,
                          bias_correction=engine._bias_correction,
                          max_coeff=engine._lamb_coeffs[0],
                          min_coeff=engine._lamb_coeffs[1])
    atol = LAMB_ATOL_REL * max(float(w.abs().max()) for w in want)
    worst, ok = 0.0, True
    for m, w in zip(engine._masters, want):
        got = m.detach().cpu()
        err = (got - w).abs()
        worst = max(worst, float((err / w.abs().clamp_min(1e-30)).max()))
        ok = ok and bool((err <= LAMB_RTOL * w.abs() + atol).all())
    return loss, worst, atol, ok


def _offload_checkpointed_loss(torch, engine):
    """A user's loss over the engine's GPT-2 with every block run through
    the activation checkpointing module's ``checkpoint(..., policy=
    "offload")`` (its residuals kept in pinned host memory): the model's
    own forward and loss otherwise, so the losses are the baseline's."""
    from deepspeed_tpu_torch.models.gpt2 import cross_entropy_loss
    from deepspeed_tpu_torch.runtime.activation_checkpointing.\
        checkpointing import checkpoint
    model = engine.module
    cfg = model.config

    def loss_fn(batch, rng=None):
        ids = batch["input_ids"]
        labels = torch.cat([ids[:, 1:], torch.full(
            (ids.shape[0], 1), -100, dtype=ids.dtype, device=ids.device)],
            dim=1)
        x = model.wte[ids].to(cfg.dtype) + \
            model.wpe[:ids.shape[1]][None].to(cfg.dtype)
        for block in model.h:
            x = checkpoint(block, x, policy="offload")
        logits = torch.matmul(model.ln_f(x), model.wte.to(cfg.dtype).t())
        return cross_entropy_loss(logits, labels)

    return loss_fn


def phase_train_features(torch):
    """GPT-2 350M on the ``train`` row (8 x 1024, bf16 over fp32 masters,
    flash attention), each run 4 steps from the same seeded params."""
    from deepspeed_tpu_torch.models.gpt2 import unstack_gpt2_state_dict
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 50257, (TRAIN_B, TRAIN_T))
             .astype(np.int32)}
    counters = _flash_counters()
    state = _seeded_state(torch)
    L = FEATURE_LAYERS
    row = {"phase": "train_features", "model": "gpt2_350m",
           "batch": TRAIN_B, "seq": TRAIN_T, "dtype": "bfloat16",
           "attention": "flash", "steps": FEATURE_STEPS}
    launches = dict.fromkeys(counters, 0)

    def count(run):
        for step in run["launches_per_step"]:
            for n, v in step.items():
                launches[n] += v

    # the baseline: unrolled, Adam (K4), no checkpointing
    engine = _feature_engine(torch, state)
    base = _feature_run(torch, engine, batch, counters)
    base_masters = _masters_by_name(engine)
    _drop(torch, engine)
    count(base)
    row["baseline"] = base

    # scan_layers: the same weights stacked
    engine = _feature_engine(torch, state, scan_layers=True)
    scan = _feature_run(torch, engine, batch, counters)
    scan_masters = unstack_gpt2_state_dict(_masters_by_name(engine))
    _drop(torch, engine)
    count(scan)
    scan["losses_equal_unrolled"] = scan["losses"] == base["losses"]
    scan["masters_equal_unrolled"] = set(scan_masters) == set(
        base_masters) and all(torch.equal(scan_masters[n], m)
                              for n, m in base_masters.items())
    row["scan_layers"] = scan
    del scan_masters

    # progressive layer drop
    coins = []
    engine = _feature_engine(torch, state, {"progressive_layer_drop": {
        "enabled": True, "theta": PLD_THETA, "gamma": PLD_GAMMA}})
    pld = _feature_run(torch, engine, batch, counters, after_step=lambda e:
                       coins.append(e.module.last_pld_coins))
    _drop(torch, engine)
    count(pld)
    kept = [[int(sum(c[0] for c in cs)), int(sum(c[1] for c in cs))]
            for cs in coins]
    pld.update(theta=PLD_THETA, gamma=PLD_GAMMA,
               kept_sublayers_per_step=kept,
               kept_share=sum(a + m for a, m in kept[1:]) /
               (2 * L * (FEATURE_STEPS - 1)),
               step_p50_vs_baseline=pld["step_p50_ms"] / base["step_p50_ms"])
    row["pld"] = pld

    # LAMB: 2 steps, then one held against the plain LAMB on the host
    engine = _feature_engine(torch, state, {"optimizer": {
        "type": "Lamb", "params": {"lr": LAMB_LR}}})
    lamb = _feature_run(torch, engine, batch, counters, steps=2)
    loss3, lamb_err, lamb_atol, lamb_ok = _lamb_plain_check(torch, engine,
                                                            batch)
    _drop(torch, engine)
    count(lamb)
    lamb["losses"].append(loss3)
    lamb.update(plain_step_max_rel_err=lamb_err, plain_step_rtol=LAMB_RTOL,
                plain_step_atol=lamb_atol, plain_step_within=lamb_ok)
    row["lamb"] = lamb

    # fp8 delayed scaling
    warm = []
    engine = _feature_engine(torch, state, {"fp8": {"enabled": True}})
    f8 = _feature_run(torch, engine, batch, counters, after_step=lambda e:
                      warm.append(int((e._fp8_flat > 0).sum(-1).min())))
    f8.update(sites=len(engine._fp8_keys),
              filled_history_slots_per_step=warm,
              history_len=int(engine._fp8_flat.shape[-1]),
              step_p50_vs_bf16=f8["step_p50_ms"] / base["step_p50_ms"])
    _drop(torch, engine)
    count(f8)
    row["fp8"] = f8

    # activation checkpointing through the module: GPT-2's remat "dots"
    # (its blocks under the module's ``dots`` policy), and a user's loss
    # checkpointing each block with ``offload``
    for policy in AC_POLICIES:
        if policy == "dots":
            engine = _feature_engine(torch, state, remat=True,
                                     remat_policy="dots")
        else:
            engine = _feature_engine(torch, state)
            engine.loss_fn = _offload_checkpointed_loss(torch, engine)
        ac = _feature_run(torch, engine, batch, counters)
        _drop(torch, engine)
        count(ac)
        ac["losses_equal_baseline"] = ac["losses"] == base["losses"]
        ac["peak_vs_baseline"] = ac["max_memory_allocated"] / \
            base["max_memory_allocated"]
        ac["step_p50_vs_baseline"] = ac["step_p50_ms"] / base["step_p50_ms"]
        row[f"checkpoint_{policy}"] = ac
    del state
    torch.cuda.empty_cache()
    row["launches"] = launches
    emit(row)

    def each_step(run, want):
        return all(s == want for s in run["launches_per_step"])

    plain_step = {"K1": L, "K2": L, "K3": L, "K4": 1}
    for name in ("baseline", "scan_layers", "checkpoint_dots",
                 "checkpoint_offload"):
        r = row[name]
        if not all(np.isfinite(r["losses"])) or \
                not r["losses"][-1] < r["losses"][0]:
            fail(f"train_features {name}: losses not finite and falling: "
                 f"{r['losses']}")
        # dots recomputes each block (K1 again); offload keeps every
        # residual, on the host
        ac_step = dict(plain_step, K1=2 * L) if name == "checkpoint_dots" \
            else plain_step
        if not each_step(r, ac_step):
            fail(f"train_features {name}: launches {r['launches_per_step']}"
                 f" != {ac_step} a step")
    if not (scan["losses_equal_unrolled"] and scan["masters_equal_unrolled"]):
        fail(f"train_features: scan_layers losses {scan['losses']} or fp32 "
             f"masters differ from the unrolled run's {base['losses']}")
    for policy in AC_POLICIES:
        ac = row[f"checkpoint_{policy}"]
        if not ac["losses_equal_baseline"] or not ac["peak_vs_baseline"] < 1:
            fail(f"train_features checkpoint {policy}: losses "
                 f"{ac['losses']} vs {base['losses']}, peak ratio "
                 f"{ac['peak_vs_baseline']}")
    for k, (step, (attn, mlp)) in enumerate(zip(pld["launches_per_step"],
                                                kept)):
        want = {"K1": attn, "K2": attn, "K3": attn, "K4": 1}
        if step != want:
            fail(f"train_features pld step {k}: launches {step} != {want} "
                 f"(kept attention sublayers)")
    later = [s["K1"] for s in pld["launches_per_step"][1:]]
    if not all(np.isfinite(pld["losses"])) or \
            not sum(later) / len(later) < L or kept[0] != [L, L]:
        fail(f"train_features pld: K1 launches {later} a step not below {L} "
             f"at theta {PLD_THETA}, or step 0 dropped a sublayer ({kept[0]})"
             f", or losses {pld['losses']}")
    if not lamb_ok or not all(np.isfinite(lamb["losses"])) or \
            not lamb["losses"][-1] < lamb["losses"][0]:
        fail(f"train_features lamb: losses {lamb['losses']}, plain step "
             f"within {lamb_ok} (max rel err {lamb_err})")
    if not each_step(lamb, dict(plain_step, K4=0)):
        fail(f"train_features lamb: launches {lamb['launches_per_step']}")
    f8_first = dict(plain_step, K1=2 * L)     # the discovery forward
    if f8["launches_per_step"][0] != f8_first or \
            not all(s == plain_step for s in f8["launches_per_step"][1:]):
        fail(f"train_features fp8: launches {f8['launches_per_step']}")
    if not all(np.isfinite(f8["losses"])) or \
            not f8["losses"][-1] < f8["losses"][0]:
        fail(f"train_features fp8: losses {f8['losses']}")
    if f8["sites"] != 4 * L:
        fail(f"train_features fp8: {f8['sites']} state keys, not 4 a layer")
    if warm != list(range(1, FEATURE_STEPS + 1)):
        fail(f"train_features fp8: history slots filled {warm}, expected "
             f"one more a step")
    return row


def _bert_flag_run(torch, flags, batch, counters):
    """BERT-Large (dropout 0.1, accumulation 2) with the layers'
    ``flags``: step 1 through forward / backward / step, reading every
    gradient after the first micro-batch, then one ``train_batch``."""
    engine = _bert_engine(torch, 0.1, 2)
    for layer in engine.module.bert.layer:
        for flag in BERT_FLAGS:
            setattr(layer.config, flag, flag in flags)
    _fresh(torch)
    for c in counters.values():
        c.launches = 0
    half = BERT_B // 2
    micro, grads = [], None
    t0 = time.perf_counter()
    for i in range(2):
        loss = engine.forward({k: x[i * half:(i + 1) * half]
                               for k, x in batch.items()})
        engine.backward(loss)
        micro.append(float(loss.detach()))
        if grads is None:
            grads = [p.grad.detach().clone() for p in engine.params]
    engine.step()
    t1 = time.perf_counter()
    losses = [sum(micro) / 2, float(engine.train_batch(batch))]
    t2 = time.perf_counter()
    out = {"losses": losses, "micro_losses": micro,
           "step_wall_s": [t1 - t0, t2 - t1],
           "launches": {n: c.launches for n, c in counters.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    masters = [m.detach().clone() for m in engine._masters]
    _drop(torch, engine)
    return out, grads, masters


def phase_train_bert_ckpt(torch):
    """BERT-Large, 32 x 512, block-sparse, dropout 0.1: 2 steps with
    the three checkpoint flags on every layer against the same 2 steps
    without them."""
    batch = _bert_batch(BERT_VOCAB)
    counters = _sparse_counters()
    plain, plain_g, plain_m = _bert_flag_run(torch, (), batch, counters)
    flags, flag_g, flag_m = _bert_flag_run(torch, BERT_FLAGS, batch,
                                           counters)
    grads_equal = all(torch.equal(a, b) for a, b in zip(flag_g, plain_g))
    masters_equal = all(torch.equal(a, b) for a, b in zip(flag_m, plain_m))
    del plain_g, flag_g, plain_m, flag_m
    torch.cuda.empty_cache()
    row = {"phase": "train_bert_ckpt", "model": "bert_large",
           "batch": BERT_B, "seq": BERT_T, "micro_batch": BERT_B // 2,
           "dtype": "bfloat16", "encoder_dtype": "float32",
           "dropout": 0.1, "attention": "block-sparse (K7/K8)",
           "flags": list(BERT_FLAGS), "plain": plain, "flagged": flags,
           "losses_equal": flags["losses"] == plain["losses"],
           "first_micro_grads_equal": grads_equal,
           "masters_equal_after_2_steps": masters_equal,
           "peak_vs_plain": flags["max_memory_allocated"] /
           plain["max_memory_allocated"],
           "launches": flags["launches"]}
    emit(row)
    micro = 4                      # 2 steps of 2 micro-batches
    want = {"K7": BERT_LAYERS * micro, "K8a": BERT_LAYERS * micro,
            "K8b": BERT_LAYERS * micro, "K1": 0, "K2": 0, "K3": 0, "K4": 2}
    if plain["launches"] != want:
        fail(f"train_bert_ckpt: plain launches {plain['launches']} != {want}")
    want_flags = dict(want, K7=2 * BERT_LAYERS * micro)
    if flags["launches"] != want_flags:
        fail(f"train_bert_ckpt: launches with the flags {flags['launches']} "
             f"!= {want_flags} (K7 again in each attention recompute)")
    if not (row["losses_equal"] and grads_equal and masters_equal) or \
            not all(np.isfinite(flags["losses"])):
        fail(f"train_bert_ckpt: the flags changed the run: losses "
             f"{flags['losses']} vs {plain['losses']}, grads equal "
             f"{grads_equal}, masters equal {masters_equal}")
    return row


# ---------------------------------------------------------------------------
# sparse-attention slice: block-sparse K7, K8a, K8b, BERT-Large MLM
# ---------------------------------------------------------------------------

BERT_B, BERT_T, BERT_H, BERT_D, BERT_BLOCK = 32, 512, 16, 64, 64
BERT_LAYERS = 12                   # BERT-Large widths, depth cut
BERT_VOCAB = 30522
LONG_B, LONG_T, LONG_BLOCK = 1, 4096, 128   # benchmarks/long_context.py
SPARSE_SEED = -123456789


def _bsa():
    """The kernel module (the package re-exports its entry function
    under the module's own name)."""
    import importlib
    return importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")


def _bert_sparsity(torch_cfg_module, causal=False, block=BERT_BLOCK,
                   heads=BERT_H):
    """The bench's Fixed layout (``bench.py:173-177``): 4 local blocks, 1
    global, bidirectional (or the unidirectional long-context one)."""
    return torch_cfg_module.FixedSparsityConfig(
        num_heads=heads, block=block, num_local_blocks=4,
        num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional")


def _sparse_layouts(sc, block, t, heads):
    """(name, layout) of all five layout families at ``block`` / ``t``,
    and a hand-made one whose head 1 has an empty q-block row and whose
    last k-block no q-block of head 0 visits."""
    fams = [
        ("dense", sc.DenseSparsityConfig(heads, block=block)),
        ("fixed_per_head", sc.FixedSparsityConfig(
            heads, block=block, different_layout_per_head=True,
            num_local_blocks=4, num_global_blocks=1,
            num_different_global_patterns=4)),
        ("variable", sc.VariableSparsityConfig(
            heads, block=block, different_layout_per_head=True,
            num_random_blocks=1, local_window_blocks=[2, 4],
            global_block_indices=[0], seed=3)),
        ("bigbird", sc.BigBirdSparsityConfig(
            heads, block=block, different_layout_per_head=True,
            num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1, seed=5)),
        ("bslongformer", sc.BSLongformerSparsityConfig(
            heads, block=block, num_sliding_window_blocks=3,
            global_block_indices=[0, 5], global_block_end_indices=[1, 6]))]
    out = [(name, cfg.make_layout(t)) for name, cfg in fams]
    hand = sc.FixedSparsityConfig(heads, block=block, num_local_blocks=2,
                                  num_global_blocks=1).make_layout(t)
    hand[1, 2, :] = 0
    hand[0, :, -1] = 0
    out.append(("empty_row", hand))
    return out


def _sparse_case(torch, bsa, b, t, h, d, dtype, block, layout, causal, rate,
                 gen, head_offset=0, num_heads=None):
    """K7, K8a and K8b against their plain versions on one input set
    (``head_offset``: the dropout hash's, as a data-parallel rank's;
    ``num_heads``: the unsharded head count of a model rank's heads)."""
    q, k, v, g, _ = _attn_inputs(torch, b, t, h, d, getattr(torch, dtype),
                                 False, gen)
    lut, nnz, lut_t, nnz_t = bsa.layout_tables(layout, "cuda")
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=SPARSE_SEED,
              dropout_head_offset=head_offset, dropout_num_heads=num_heads)
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, nnz, block, **kw)
    ref_out, ref_lse = bsa.block_sparse_attention_fwd_reference(
        q, k, v, lut, nnz, block, **kw)
    delta = (g.float() * ref_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, g, ref_lse, delta, lut,
                                           nnz, block, **kw)
    ref_dq = bsa.block_sparse_attention_bwd_dq_reference(
        q, k, v, g, ref_lse, delta, lut, nnz, block, **kw)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, g, ref_lse, delta,
                                                lut_t, nnz_t, block, **kw)
    ref_dk, ref_dv = bsa.block_sparse_attention_bwd_dkv_reference(
        q, k, v, g, ref_lse, delta, lut_t, nnz_t, block, **kw)
    torch.cuda.synchronize()
    rtol = TRAIN_RTOL[dtype]
    # an empty row's lse is -inf on both sides; compare the rest
    empty = torch.isinf(ref_lse)
    lse_same_inf = bool(torch.equal(torch.isinf(lse), empty))
    checks = {"out": _close(torch, out, ref_out, rtol),
              "lse": _close(torch, lse.masked_fill(empty, 0.0),
                            ref_lse.masked_fill(empty, 0.0),
                            TRAIN_RTOL["float32"]),
              "dq": _close(torch, dq, ref_dq, rtol),
              "dk": _close(torch, dk, ref_dk, rtol),
              "dv": _close(torch, dv, ref_dv, rtol)}
    return {"B": b, "T": t, "H": h, "D": d, "dtype": dtype, "block": block,
            "causal": causal, "dropout": rate, "head_offset": head_offset,
            "num_heads": num_heads,
            "density": float(np.asarray(layout).mean()),
            "empty_rows": int(empty.any(-1).sum()),
            "max_abs_err": {n: c[0] for n, c in checks.items()},
            "ok": lse_same_inf and all(c[1] for c in checks.values())}


def _sparse_dropout_bitwise(torch, bsa, sc):
    """K7's dropout mask, read back: with q = k = 0 every visited key of
    a row gets probability 1/n and v = I (T = D = 64) makes out[t, d] =
    mult(t, d) / n for a visited key d, else 0; n is 64 (dense layout) or
    32 (2 of 4 blocks a row), so ``out * n`` is exact. A row with no
    block must come out 0."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        _dropout_multiplier_full)
    b, t, h = 2, 64, BERT_H
    q = torch.zeros((b, t, h, t), device="cuda")
    v = torch.eye(t, device="cuda")[None, :, None, :].expand(
        b, t, h, t).contiguous()
    ok = True
    for block in (16, 32):
        nb = t // block
        dense = sc.DenseSparsityConfig(h, block=block).make_layout(t)
        half = np.zeros_like(dense)
        for i in range(nb):
            half[:, i, [i, (i + 1) % nb]] = 1
        half[3 % h, 1, :] = 0                 # an empty row
        for layout, n in ((dense, t), (half, 2 * block)):
            lut, nnz, _, _ = bsa.layout_tables(layout, "cuda")
            allowed = torch.from_numpy(layout != 0).cuda().float() \
                .repeat_interleave(block, 1).repeat_interleave(block, 2)
            for seed, rate, off in ((SPARSE_SEED, 0.1, 0), (7, 0.5, 0),
                                    (SPARSE_SEED, 0.1, 3 * b * h)):
                out, _ = bsa.block_sparse_attention_fwd(
                    q, q, v, lut, nnz, block, dropout_rate=rate,
                    dropout_seed=seed, dropout_head_offset=off)
                mult = _dropout_multiplier_full(b, h, t, t, rate, seed,
                                                head_offset=off,
                                                device="cuda")
                ok = ok and bool(torch.equal(out.permute(0, 2, 1, 3) * n,
                                             mult * allowed[None]))
    return ok


def _dense_layout_vs_k1(torch, bsa, sc):
    """A dense layout through K7 (non-causal) equals K1 on the same
    inputs within the bf16 tolerance."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    b, t, h, d = 2, BERT_T, BERT_H, BERT_D
    q, k, v, _, _ = _attn_inputs(torch, b, t, h, d, torch.bfloat16, False,
                                 gen)
    layout = sc.DenseSparsityConfig(h, block=BERT_BLOCK).make_layout(t)
    lut, nnz, _, _ = bsa.layout_tables(layout, "cuda")
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, nnz, BERT_BLOCK)
    k1_out, k1_lse = fa.flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    checks = {"out": _close(torch, out, k1_out, TRAIN_RTOL["bfloat16"]),
              "lse": _close(torch, lse, k1_lse, TRAIN_RTOL["float32"])}
    return {n: c[0] for n, c in checks.items()}, \
        all(c[1] for c in checks.values())


def phase_sparse_kernel_check(torch):
    from deepspeed_tpu_torch.ops import sparse_attention as sc
    bsa = _bsa()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    h = 4
    cases = []
    for block in bsa.BLOCKS:
        t = 8 * block
        for d in (64, 128):
            for dtype in ("bfloat16", "float32"):
                for causal in (False, True):
                    layout = _bert_sparsity(sc, causal, block, h) \
                        .make_layout(t)
                    layout[1, 2, :] = 0        # an empty q-block row
                    for rate in (0.0, 0.1):
                        cases.append(_sparse_case(
                            torch, bsa, 2, t, h, d, dtype, block, layout,
                            causal, rate, gen))
    # fp16 (exact in TF32: the bf16 path)
    for block in (16, 64):
        t = 8 * block
        for causal in (False, True):
            layout = _bert_sparsity(sc, causal, block, h).make_layout(t)
            layout[1, 2, :] = 0
            for rate in (0.0, 0.1):
                cases.append(_sparse_case(
                    torch, bsa, 2, t, h, 64, "float16", block, layout,
                    causal, rate, gen))
    # head dims past 256: column chunks of 256 a CTA, the scores streamed
    # over D in windows of 256
    for d, block in ((320, 16), (512, 32)):
        t = 8 * block
        for dtype in ("float32", "bfloat16", "float16"):
            for causal in (False, True):
                layout = _bert_sparsity(sc, causal, block, h).make_layout(t)
                layout[1, 2, :] = 0
                cases.append(_sparse_case(
                    torch, bsa, 2, t, h, d, dtype, block, layout, causal,
                    0.1 if causal else 0.0, gen))
    # head dim 256 (K8 on 32-row tiles with the head split over warps)
    for block in (16, 64):
        t = 8 * block
        for dtype in ("bfloat16", "float32"):
            for causal in (False, True):
                layout = _bert_sparsity(sc, causal, block, h).make_layout(t)
                layout[1, 2, :] = 0
                for rate in (0.0, 0.1):
                    cases.append(_sparse_case(
                        torch, bsa, 2, t, h, 256, dtype, block, layout,
                        causal, rate, gen))
    for name, layout in _sparse_layouts(sc, BERT_BLOCK, BERT_T, h):
        for causal in (False, True):
            case = _sparse_case(torch, bsa, 2, BERT_T, h, BERT_D, "bfloat16",
                                BERT_BLOCK, layout, causal, 0.1, gen)
            case["layout"] = name
            cases.append(case)
    # the shape train_bert_sparse gives the kernels: its micro-batch, the
    # bench's Fixed layout, dropout 0.1, in the encoder's fp32 (and bf16,
    # fp16)
    layout = _bert_sparsity(sc).make_layout(BERT_T)
    for dtype in ("float32", "bfloat16", "float16"):
        case = _sparse_case(torch, bsa, BERT_B, BERT_T, BERT_H, BERT_D, dtype,
                            BERT_BLOCK, layout, False, 0.1, gen)
        case["layout"] = "bert_bench"
        cases.append(case)
    # a data-parallel rank's rows: the same shape at rank 1 of 2 and rank
    # 3 of 4 (the dropout hash's head coordinate starts at r * B * H),
    # the only place one card shows the offset (NCCL refuses two ranks
    # on one device)
    offset_cases = []
    for rank, dtype in ((1, "float32"), (3, "bfloat16")):
        for causal in (False, True):
            lay = _bert_sparsity(sc, causal).make_layout(BERT_T)
            case = _sparse_case(torch, bsa, 4, BERT_T, BERT_H, BERT_D, dtype,
                                BERT_BLOCK, lay, causal, 0.1, gen,
                                head_offset=rank * 4 * BERT_H)
            case["layout"] = "bert_bench_rank"
            offset_cases.append(case)
    cases.extend(offset_cases)
    for case in cases:
        if not case["ok"]:
            emit({"phase": "sparse_kernel_check", "failed": case})
            fail(f"block-sparse kernels disagree with their plain "
                 f"versions: {case}")
    bitwise = _sparse_dropout_bitwise(torch, bsa, sc)
    k1_err, k1_ok = _dense_layout_vs_k1(torch, bsa, sc)
    errs = {
        "K7": max(max(c["max_abs_err"]["out"], c["max_abs_err"]["lse"])
                  for c in cases),
        "K8a": max(c["max_abs_err"]["dq"] for c in cases),
        "K8b": max(max(c["max_abs_err"]["dk"], c["max_abs_err"]["dv"])
                   for c in cases)}
    emit({"phase": "sparse_kernel_check", "cases": len(cases),
          "empty_row_cases": sum(c["empty_rows"] > 0 for c in cases),
          "head_offset_cases": len(offset_cases),
          "head_offset_max_abs_err": {
              "K7": max(max(c["max_abs_err"]["out"], c["max_abs_err"]["lse"])
                        for c in offset_cases),
              "K8a": max(c["max_abs_err"]["dq"] for c in offset_cases),
              "K8b": max(max(c["max_abs_err"]["dk"], c["max_abs_err"]["dv"])
                         for c in offset_cases)},
          "dropout_mask_bitwise": bitwise,
          "dense_layout_vs_k1_max_abs_err": k1_err,
          "dense_layout_vs_k1_ok": k1_ok, "max_abs_err": errs,
          "rtol": TRAIN_RTOL, "atol_rel": TRAIN_ATOL_REL, "results": cases})
    if not bitwise:
        fail("K7's dropout mask differs from dropout_multiplier")
    if not k1_ok:
        fail(f"a dense layout through K7 differs from K1: {k1_err}")
    return errs


def _visited_pairs(layout, block, causal):
    """(q, k) pairs per batch row the function needs: every pair of a
    nonzero block, minus the causally masked ones."""
    layout = np.asarray(layout)
    if not causal:
        return int(layout.sum()) * block * block
    nb = layout.shape[1]
    qi, kj = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    per = np.where(kj < qi, block * block,
                   np.where(kj == qi, block * (block + 1) // 2, 0))
    return int((layout * per[None]).sum())


def _sparse_timing(torch, bsa, sc, b, t, block, causal, dtype, shape_name,
                   h=BERT_H, d=BERT_D):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    q, k, v, g, _ = _attn_inputs(torch, b, t, h, d, getattr(torch, dtype),
                                 False, gen)
    layout = _bert_sparsity(sc, causal, block, h).make_layout(t)
    lut, nnz, lut_t, nnz_t = bsa.layout_tables(layout, "cuda")
    kw = dict(causal=causal)
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, nnz, block, **kw)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    pairs = b * _visited_pairs(layout, block, causal)
    io = q.element_size() * b * t * h * d      # bytes of one q/k/v/dO
    lut_bytes = 4 * (lut.numel() + nnz.numel())
    lut_t_bytes = 4 * (lut_t.numel() + nnz_t.numel())
    allowed = torch.from_numpy(layout != 0).cuda() \
        .repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        allowed &= torch.ones((t, t), dtype=torch.bool,
                              device="cuda").tril()[None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in,
                                              attn_mask=allowed[None])
    g_t = g.transpose(1, 2)
    rows = {}

    def row(name, kern, plain, flops, nbytes, lib):
        # K7 / K8a / K8b multiply on the TF32 tensor cores in 3 passes: on
        # f32 their bound is read at that rate (bf16 and fp16 keep their
        # tensor-core peak)
        tf32x3 = name in ("K7", "K8a", "K8b")
        rows[name] = _timing_row(
            torch, kern, plain, flops, nbytes, dtype, lib,
            TF32X3_OPS_PER_S if tf32x3 and dtype == "float32" else None)
        if tf32x3:
            rows[name]["tf32x3_ops_ms"] = flops / TF32X3_OPS_PER_S * 1e3

    def sdpa_bwd(i):
        torch.autograd.grad(sdpa_out, sdpa_in, g_t, retain_graph=True)

    row("K7", lambda i: bsa.block_sparse_attention_fwd(q, k, v, lut, nnz,
                                                       block, **kw),
        lambda i: bsa.block_sparse_attention_fwd_reference(
            q, k, v, lut, nnz, block, **kw),
        4 * pairs * d, 4 * io + 4 * b * h * t + lut_bytes,
        lambda i: F.scaled_dot_product_attention(qt, kt, vt,
                                                 attn_mask=allowed[None]))
    row("K8a", lambda i: bsa.block_sparse_attention_bwd_dq(
        q, k, v, g, lse, delta, lut, nnz, block, **kw),
        lambda i: bsa.block_sparse_attention_bwd_dq_reference(
            q, k, v, g, lse, delta, lut, nnz, block, **kw),
        6 * pairs * d, 5 * io + 8 * b * h * t + lut_bytes, sdpa_bwd)
    row("K8b", lambda i: bsa.block_sparse_attention_bwd_dkv(
        q, k, v, g, lse, delta, lut_t, nnz_t, block, **kw),
        lambda i: bsa.block_sparse_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, lut_t, nnz_t, block, **kw),
        8 * pairs * d, 6 * io + 8 * b * h * t + lut_t_bytes, sdpa_bwd)
    del sdpa_out, sdpa_in
    torch.cuda.empty_cache()
    return {"shape": shape_name, "B": b, "T": t, "H": h, "D": d,
            "dtype": dtype, "block": block, "causal": causal,
            "density": float(layout.mean()), "pairs": pairs,
            "library": "scaled_dot_product_attention with the layout as a "
                       "boolean attn_mask (K8a and K8b: its backward)",
            "results": rows}


def phase_sparse_kernel_timing(torch):
    """K7, K8a and K8b timed at three shapes (see the module docstring).
    Each row's ``bound_ms`` is the larger of its bytes at the HBM rate and
    its operations at the rate its precision allows: the bf16 tensor-core
    peak on bf16 rows; on f32 rows the fp32 peak for K7 (fp32 FMA) and,
    for K8a and K8b, which keep fp32 precision on the TF32 tensor cores
    in three passes, 495 / 3 TFLOP/s (``tf32x3_ops_ms``, beside
    ``fp32_ops_ms`` at the CUDA-core peak), so ``roofline_share`` stays a
    share of what the card can do at that precision."""
    from deepspeed_tpu_torch.ops import sparse_attention as sc
    bsa = _bsa()
    # the BERT bench shape in the encoder's fp32 (what the main path gives
    # the kernels) and in bf16; the long-context study in its bf16
    shapes = {
        "bert_bench": _sparse_timing(torch, bsa, sc, BERT_B, BERT_T,
                                     BERT_BLOCK, False, "float32",
                                     "bert_bench"),
        "bert_bench_bf16": _sparse_timing(torch, bsa, sc, BERT_B, BERT_T,
                                          BERT_BLOCK, False, "bfloat16",
                                          "bert_bench_bf16"),
        "bert_bench_fp16": _sparse_timing(torch, bsa, sc, BERT_B, BERT_T,
                                          BERT_BLOCK, False, "float16",
                                          "bert_bench_fp16"),
        "long_context": _sparse_timing(torch, bsa, sc, LONG_B, LONG_T,
                                       LONG_BLOCK, True, "bfloat16",
                                       "long_context")}
    emit({"phase": "sparse_kernel_timing", "shapes": shapes})
    return shapes


# ``--turns``: the rows of the ``kernels`` line at the shapes their timing
# phases give them (K7 / K8 also in bf16 and fp16), and the instances
# that also hold the code for head dims past 256: the FMA route of K1-K3
# at head dims 160 and 256 in f32 and fp16, K7 / K8 at 256 in f32 and
# bf16; as groups that share their inputs: group -> (kernel keys,
# n_calls a timing)
TURN_FMA_SHAPE = (2, 1024, 8)           # B, T, H of the FMA-route groups
TURN_GROUPS = {
    "attention/bfloat16/D64": (("K1", "K2", "K3"), 20),
    **{f"attention/{dt}/D{d}": (("K1", "K2", "K3"), 10)
       for dt in ("float32", "float16") for d in (160, 256)},
    "adam/float32": (("K4",), 10),
    "decode/bfloat16/D64": (("K5", "K6"), 50),
    **{f"sparse/{dt}/D64": (("K7", "K8a", "K8b"), 20)
       for dt in ("float32", "bfloat16", "float16")},
    **{f"sparse/{dt}/D256": (("K7", "K8a", "K8b"), 10)
       for dt in ("float32", "bfloat16")},
}


def _turn_group(torch, group):
    """One group of ``TURN_GROUPS`` built on the card from fixed seeds
    through the importable package's public wrappers (this checkout's, or
    another's in the turns worker): ``{key: (run, (max |diff|, ok))}``,
    ``run(i)`` one call of the kernel, the pair its output held to the
    plain version at the kernel checks' gate."""
    import importlib
    kind, dtype = group.split("/")[:2]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    first = (lambda x: x[0] if isinstance(x, tuple) else x)
    if kind == "attention":
        fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
        d = int(group.rsplit("D", 1)[1])
        b, t, h = (TRAIN_B, TRAIN_T, TRAIN_H) if d == TRAIN_D \
            else TURN_FMA_SHAPE
        q, k, v, g, _ = _attn_inputs(torch, b, t, h, d, getattr(torch, dtype),
                                     False, gen)
        out, lse = fa.flash_attention_fwd_reference(q, k, v)
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(b * h, t).contiguous()
        fns = {"K1": (lambda i: fa.flash_attention_fwd(q, k, v), out),
               "K2": (lambda i: fa.flash_attention_bwd_dq(q, k, v, g, lse,
                                                          delta),
                      fa.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                          delta)),
               "K3": (lambda i: fa.flash_attention_bwd_dkv(q, k, v, g, lse,
                                                           delta),
                      fa.flash_attention_bwd_dkv_reference(
                          q, k, v, g, lse, delta)[0])}
        rtol = TRAIN_RTOL[dtype]
    elif kind == "sparse":
        from deepspeed_tpu_torch.ops import sparse_attention as sc
        bsa = _bsa()
        q, k, v, g, _ = _attn_inputs(torch, BERT_B, BERT_T, BERT_H,
                                     int(group.rsplit("D", 1)[1]),
                                     getattr(torch, dtype), False, gen)
        layout = _bert_sparsity(sc).make_layout(BERT_T)
        lut, nnz, lut_t, nnz_t = bsa.layout_tables(layout, "cuda")
        out, lse = bsa.block_sparse_attention_fwd_reference(
            q, k, v, lut, nnz, BERT_BLOCK)
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(BERT_B * BERT_H, BERT_T).contiguous()
        fns = {"K7": (lambda i: bsa.block_sparse_attention_fwd(
                   q, k, v, lut, nnz, BERT_BLOCK), out),
               "K8a": (lambda i: bsa.block_sparse_attention_bwd_dq(
                   q, k, v, g, lse, delta, lut, nnz, BERT_BLOCK),
                   bsa.block_sparse_attention_bwd_dq_reference(
                       q, k, v, g, lse, delta, lut, nnz, BERT_BLOCK)),
               "K8b": (lambda i: bsa.block_sparse_attention_bwd_dkv(
                   q, k, v, g, lse, delta, lut_t, nnz_t, BERT_BLOCK),
                   bsa.block_sparse_attention_bwd_dkv_reference(
                       q, k, v, g, lse, delta, lut_t, nnz_t,
                       BERT_BLOCK)[0])}
        rtol = TRAIN_RTOL[dtype]
    elif kind == "decode":
        fd = importlib.import_module("deepspeed_tpu_torch.ops.flash_decode")
        h, d = 12, 64
        rng = np.random.default_rng(1)
        pos = torch.from_numpy(rng.integers(8, 152, B).astype(np.int32)) \
            .cuda()
        q = torch.randn((B, 1, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        kc, _ = _cache(torch, "bfloat16", (B, S, h, d), gen)
        vc, _ = _cache(torch, "bfloat16", (B, S, h, d), gen)
        pool_k, pool_v = (torch.cat([torch.zeros_like(x[:1, :PAGE_SIZE]),
                                     x.reshape(B * PAGES_PER_ROW, PAGE_SIZE,
                                               h, d)]) for x in (kc, vc))
        table = torch.arange(1, B * PAGES_PER_ROW + 1, dtype=torch.int32,
                             device="cuda").reshape(B, PAGES_PER_ROW)
        want = fd.flash_decode_reference(q, kc, vc, pos,
                                         block_k=SERVE_BLOCK_K)
        fns = {"K5": (lambda i: fd.flash_decode(q, kc, vc, pos,
                                                block_k=SERVE_BLOCK_K), want),
               "K6": (lambda i: fd.flash_decode_paged(
                   q, pool_k, pool_v, pos, table, block_k=SERVE_BLOCK_K),
                   want)}
        rtol = RTOL[dtype]
    else:
        # K4 over GPT-2 350M's leaves with the main path's hyperparameters,
        # one step first held against the plain version on copies
        from deepspeed_tpu_torch.models.gpt2 import gpt2_350m
        from deepspeed_tpu_torch.ops.fused_adam import (
            adam_hyperparams, fused_adam, fused_adam_reference)
        p, gr, m, vv = ([torch.randn(sh, generator=gen, device="cuda") * 0.02
                         for sh in _gpt2_shapes(gpt2_350m())]
                        for _ in range(4))
        for x in vv:
            x.abs_()
        hyper = adam_hyperparams(1e-4, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001,
                                 0.0, "cuda")
        kern = [[x.clone() for x in xs] for xs in (p, m, vv)]
        plain = [[x.clone() for x in xs] for xs in (p, m, vv)]
        fused_adam(kern[0], gr, kern[1], kern[2], hyper, adam_w_mode=False)
        fused_adam_reference(plain[0], gr, plain[1], plain[2], hyper,
                             adam_w_mode=False)
        torch.cuda.synchronize()
        checked = _adam_compare(sum(kern, []), sum(plain, []))
        del kern, plain
        return {"K4": (lambda i: fused_adam(p, gr, m, vv, hyper,
                                            adam_w_mode=False), checked)}
    return {key: (run, _close(torch, first(run(0)), want, rtol))
            for key, (run, want) in fns.items()}


TURN_REPLY = "TURN "       # a worker's reply line starts so


class _TurnsWorker:
    """The turns' other side: this script in a process of its own with
    another checkout's package first on its path, building that
    package's kernels and timing its wrappers on request (one JSON line
    each way). It waits on its pipe while this process times, so the two
    never share the card."""

    def __init__(self, root):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--turns-worker",
             root], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ask(self, **req):
        """The reply to ``req`` (with none, the worker's first line)."""
        if req:
            self.proc.stdin.write(json.dumps(req) + "\n")
            self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith(TURN_REPLY):
                return json.loads(line[len(TURN_REPLY):])
            print(line, end="", file=sys.stderr)
        fail(f"turns worker exited ({self.proc.wait()})")

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _turns_serve(torch):
    """The worker's loop: builds its package's kernels, then for each
    request ``{"group", "key", "n_calls"}`` times that kernel (building
    the group's inputs when the group changes) and replies with its ms
    and check, or with the error its package raised."""
    reply = (lambda obj: print(TURN_REPLY + json.dumps(obj), flush=True))
    try:
        reply({"build_s": _build_all()})
    except Exception as e:          # an unbuildable package: say so
        reply({"error": f"build: {e}"})
    name, cases = None, {}
    for line in sys.stdin:
        req = json.loads(line)
        try:
            if req["group"] != name:
                name, cases = None, {}
                torch.cuda.empty_cache()
                cases, name = _turn_group(torch, req["group"]), req["group"]
            run, (err, ok) = cases[req["key"]]
            reply({"ms": _time_ms(torch, run, req["n_calls"])[0],
                   "max_abs_err": err, "ok": ok})
        except Exception as e:      # what that package cannot run
            reply({"error": f"{type(e).__name__}: {e}"})
    return 0


def phase_turns(torch, parent):
    """Every group of ``TURN_GROUPS`` timed in turns on one card, this
    checkout's wrappers against those of the checkout at ``parent`` (the
    parent commit's, each built from its own source), parent, this,
    this, parent per kernel. This side's output must pass the plain
    version's gate; the other side's check and any error it raises (a
    kernel or dtype it lacks) are reported."""
    worker = _TurnsWorker(os.path.abspath(parent))
    out = {}
    try:
        built = worker.ask()
        for group, (keys, n_calls) in TURN_GROUPS.items():
            mine = _turn_group(torch, group)
            for key in keys:
                run, (err, ok) = mine[key]
                if not ok:
                    fail(f"turns: {key} {group} disagrees with its plain "
                         f"version ({err})")
                turns, theirs = [], {}
                for side in ("parent", "this", "this", "parent"):
                    if side == "this":
                        turns.append([side, _time_ms(torch, run,
                                                     n_calls)[0]])
                    elif "error" not in theirs:
                        theirs = worker.ask(group=group, key=key,
                                            n_calls=n_calls)
                        if "error" not in theirs:
                            turns.append([side, theirs["ms"]])
                median = {w: statistics.median(t for v, t in turns if v == w)
                          for w in {v for v, _ in turns}}
                out[f"{key}/{group.split('/', 1)[1]}"] = {
                    "group": group, "turns": turns, "median_ms": median,
                    "max_abs_err": {"this": err,
                                    "parent": theirs.get("max_abs_err")},
                    "parent_ok": theirs.get("ok"),
                    "parent_error": theirs.get("error")}
            del mine
            torch.cuda.empty_cache()
    finally:
        worker.close()
    emit({"phase": "turns", "parent": parent, "parent_build": built,
          "fma_shape": TURN_FMA_SHAPE,
          "attention_shape": [TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D],
          "sparse_shape": [BERT_B, BERT_T, BERT_H],   # D: the group's
          "block": BERT_BLOCK, "decode_shape": [B, S, 12, 64],
          "results": out})
    return out


WIDE_D = 512


def phase_wide_head_timing(torch):
    """One row at head dim 512 for each kernel the column-chunk repair
    reaches: K1-K3 (B 2, T 1024, H 4, bf16, causal: the FMA route), K7 /
    K8a / K8b (the same B, T, H, the bench's Fixed layout at block 64,
    bf16) and K5 / K6 (the decode timing's B 8, S 512, serve-mix
    positions, H 4, bf16 cache; K6 over the same bytes in pages of 128),
    each beside its plain version, its bound and
    ``F.scaled_dot_product_attention`` where it runs at this head dim
    (else ``library_ms`` is null and ``library_error`` says why)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sc
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_reference,
        flash_decode_reference)
    b, t, h, d = 2, 1024, 4, WIDE_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    rows = {}

    def with_library(name, lib, run):
        """``run(lib)``, or with no yardstick where SDPA refuses."""
        try:
            lib(0)
            torch.cuda.synchronize()
        except RuntimeError as e:
            rows[name] = run(None)
            rows[name]["library_error"] = str(e).splitlines()[0][:200]
            return
        rows[name] = run(lib)

    q, k, v, g, _ = _attn_inputs(torch, b, t, h, d, torch.bfloat16, False,
                                 gen)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    pairs = _causal_pairs(b, h, t)
    io = 2 * b * t * h * d
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    g_t = g.transpose(1, 2)

    def sdpa(i):
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_bwd(i):
        o = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
        torch.autograd.grad(o, sdpa_in, g_t)

    with_library("K1", sdpa, lambda lib: _timing_row(
        torch, lambda i: fa.flash_attention_fwd(q, k, v),
        lambda i: fa.flash_attention_fwd_reference(q, k, v),
        4 * pairs * d, 4 * io + 4 * b * h * t, "bfloat16", lib))
    with_library("K2", sdpa_bwd, lambda lib: _timing_row(
        torch, lambda i: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),
        lambda i: fa.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                       delta),
        6 * pairs * d, 5 * io + 8 * b * h * t, "bfloat16", lib))
    with_library("K3", sdpa_bwd, lambda lib: _timing_row(
        torch, lambda i: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta),
        lambda i: fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                        delta),
        8 * pairs * d, 6 * io + 8 * b * h * t, "bfloat16", lib))
    del sdpa_in, q, k, v, g, out
    sparse = _sparse_timing(torch, _bsa(), sc, b, t, BERT_BLOCK, False,
                            "bfloat16", "wide_512", h=h, d=d)
    rows.update(sparse["results"])

    # decode: one query token a row over a bf16 cache
    rng = np.random.default_rng(12)
    pos = torch.from_numpy(rng.integers(8, 152, B).astype(np.int32)).cuda()
    qd = torch.randn((B, 1, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kc, _ = _cache(torch, "bfloat16", (B, S, h, d), gen)
    vc, _ = _cache(torch, "bfloat16", (B, S, h, d), gen)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]

    def decode_lib(i):
        F.scaled_dot_product_attention(
            qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask)

    def decode_row(kern, plain, bound):
        def run(lib):
            ms, paced, _ = _time_ms(torch, kern, 50)
            r = {"ms": ms, "host_paced_ms": paced,
                 "plain_ms": _time_ms(torch, plain, 3)[0],
                 "bound_ms": bound[0], "bound_by": bound[1],
                 "bytes": bound[2], "roofline_share": bound[0] / ms,
                 "library_ms": None}
            if lib is not None:
                r["library_ms"] = _time_ms(torch, lib, 50)[0]
            return r
        return run

    with_library("K5", decode_lib, decode_row(
        lambda i: flash_decode(qd, kc, vc, pos, block_k=SERVE_BLOCK_K),
        lambda i: flash_decode_reference(qd, kc, vc, pos,
                                         block_k=SERVE_BLOCK_K),
        _bound(torch, pos, h, d, "bfloat16", 2)))
    # the same bytes as pages of 128 behind the trash page, in order
    pool_k, pool_v = (torch.cat([torch.zeros_like(x[:1, :PAGE_SIZE]),
                                 x.reshape(B * PAGES_PER_ROW, PAGE_SIZE, h,
                                           d)]) for x in (kc, vc))
    table = torch.arange(1, B * PAGES_PER_ROW + 1, dtype=torch.int32,
                         device="cuda").reshape(B, PAGES_PER_ROW)
    with_library("K6", decode_lib, decode_row(
        lambda i: flash_decode_paged(qd, pool_k, pool_v, pos, table,
                                     block_k=SERVE_BLOCK_K),
        lambda i: flash_decode_paged_reference(qd, pool_k, pool_v, pos,
                                               table, block_k=SERVE_BLOCK_K),
        _paged_bound(torch, pos, h, d, "bfloat16", 2)))
    emit({"phase": "wide_head_timing", "D": d,
          "attention_shape": [b, t, h, d], "decode_shape": [B, S, h, d],
          "dtype": "bfloat16", "results": rows})
    return rows


def bert_flops_per_token(cfg, seq_len, attn_density=1.0):
    """Matmul FLOPs per token for BERT MLM, fwd + bwd (the JAX bench's
    formula, ``bench.py:51-62``): 6x the encoder and head weights plus
    the attention matmuls at the layout's density."""
    d = cfg.hidden_size
    block_params = cfg.num_hidden_layers * (
        4 * d * d + 2 * d * cfg.intermediate_size)
    head = d * d + d * cfg.vocab_size
    attention = 12 * cfg.num_hidden_layers * d * seq_len * attn_density
    return 6 * (block_params + head) + attention


def _bert_batch(vocab):
    """The bench's fixed batch (``bench.py:190-194``): random ids, MLM
    labels at every 7th position."""
    rng = np.random.default_rng(0)
    labels = np.full((BERT_B, BERT_T), -100, np.int64)
    labels[:, ::7] = rng.integers(0, vocab, labels[:, ::7].shape)
    return {"input_ids": rng.integers(0, vocab, (BERT_B, BERT_T))
            .astype(np.int32), "labels": labels}


def _bert_engine(torch, dropout, accum):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.bert import BertForMaskedLM, bert_large
    from deepspeed_tpu_torch.ops import sparse_attention as sc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # as the bench builds it: the sparse core wins over flash attention
    cfg = bert_large(dtype=torch.bfloat16, use_flash_attention=True,
                     sparse_attention=_bert_sparsity(sc),
                     num_hidden_layers=BERT_LAYERS,
                     hidden_dropout_prob=dropout,
                     attention_probs_dropout_prob=dropout)
    model = BertForMaskedLM(cfg, device="cuda", generator=gen)
    config = {"train_batch_size": BERT_B, "bf16": {"enabled": True},
              "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
              "gradient_accumulation_steps": accum,
              "steps_per_print": 10 ** 9}
    engine, _, _, _ = initialize(model=model, config=config)
    return engine


def _sparse_counters():
    bsa = _bsa()
    return {"K7": bsa.block_sparse_attention_fwd,
            "K8a": bsa.block_sparse_attention_bwd_dq,
            "K8b": bsa.block_sparse_attention_bwd_dkv, **_flash_counters()}


class _MaskedDenseCore:
    """The sparse core's call to ``block_sparse_attention`` replaced by
    ``masked_dense_attention`` (the parity oracle) while inside."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.sparse_attention import (
            sparse_self_attention as ssa)
        bsa = _bsa()
        self._ssa, self._orig = ssa, ssa.block_sparse_attention

        def dense(*args, implementation=None, **kw):
            return bsa.masked_dense_attention(*args, **kw)

        ssa.block_sparse_attention = dense
        return self

    def __exit__(self, *exc):
        self._ssa.block_sparse_attention = self._orig


def _qkvw_grads(module):
    """attn_qkvw gradients as [3 * hidden, hidden] (q, k, v row blocks)."""
    return [layer.attn_qkvw.grad.t() for layer in module.bert.layer]


def phase_train_bert_sparse(torch):
    bsa = _bsa()
    batch = _bert_batch(BERT_VOCAB)
    counters = _sparse_counters()
    accum, engine = 1, None
    try:
        engine = _bert_engine(torch, 0.1, accum)
        engine.train_batch(batch)
        fits = True
    except torch.cuda.OutOfMemoryError:
        fits = False
    if not fits:
        # 32 x 512 beside the fp32 masters and Adam state: split the
        # same 32-sample step into 2 micro-batches of 16 (outside the
        # handler, so the failed step's tensors are free)
        engine = None
        gc.collect()
        torch.cuda.empty_cache()
        accum = 2
        engine = _bert_engine(torch, 0.1, accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    bsa._xla_impl.calls = 0
    losses, walls = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
    launches = {n: c.launches for n, c in counters.items()}
    gather_calls = bsa._xla_impl.calls
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    timed = walls[TRAIN_WARMUP:]
    cfg = engine.module.config
    layout = cfg.sparse_attention.make_layout(BERT_T)
    density = float(layout.sum()) / layout.size
    fpt = bert_flops_per_token(cfg, BERT_T, density)
    tps = BERT_B * BERT_T * len(timed) / sum(timed)
    profile = _profile(torch, lambda: engine.train_batch(batch), 2)
    del engine
    torch.cuda.empty_cache()

    # at dropout 0 with accumulation 2 (micro-batch 16), on the kernels
    # and again on the masked-dense oracle
    kern_losses, kern_grads, accum_launches, _ = _accum_run(
        torch, _bert_engine(torch, 0.0, 2), batch, counters, _qkvw_grads)
    with _MaskedDenseCore():
        dense_losses, dense_grads, dense_launches, dense_peak = _accum_run(
            torch, _bert_engine(torch, 0.0, 2), batch, counters,
            _qkvw_grads)
    grad_err = _grad_rel_err(torch, kern_grads, dense_grads, cfg.hidden_size)
    loss_gap = max(abs(a - b) for a, b in zip(kern_losses, dense_losses))
    del kern_grads, dense_grads

    row = {"phase": "train_bert_sparse", "model": "bert_large",
           "batch": BERT_B, "seq": BERT_T, "micro_batch": BERT_B // accum,
           "gradient_accumulation_steps": accum, "dtype": "bfloat16",
           "encoder_dtype": "float32", "dropout": 0.1,
           "attention": "block-sparse (K7/K8)",
           "layout_density": density, "optimizer": "adam (fused K4)",
           "losses": losses, "step_wall_s": walls, "tokens_per_s": tps,
           "samples_per_s": tps / BERT_T,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "model_flops_per_token": fpt,
           "mfu": tps * fpt / BF16_PEAK_FLOPS,
           "max_memory_allocated": peak, "launches": launches,
           "gather_route_calls": gather_calls, "steps": steps,
           "profile": profile, "accum2_losses": kern_losses,
           "accum2_launches": accum_launches,
           "masked_dense_accum2_losses": dense_losses,
           "masked_dense_accum2_launches": dense_launches,
           "masked_dense_accum2_max_memory_allocated": dense_peak,
           "kernel_vs_masked_dense_loss_gap": loss_gap,
           "loss_atol": TRAIN_LOSS_ATOL,
           "kernel_vs_masked_dense_qkvw_grad_rel_err": grad_err,
           "grad_rtol": TRAIN_GRAD_RTOL}
    emit(row)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"BERT training loss not finite and falling: {losses}")
    micro = steps * accum
    want = {"K7": BERT_LAYERS * micro, "K8a": BERT_LAYERS * micro,
            "K8b": BERT_LAYERS * micro, "K1": 0, "K2": 0, "K3": 0,
            "K4": steps}
    if launches != want or gather_calls != 0:
        fail(f"kernel launches {launches} != {want} over {steps} steps of "
             f"{accum} micro-batches, or gather-route calls "
             f"{gather_calls} != 0")
    want2 = dict(want, K7=2 * BERT_LAYERS * 3, K8a=2 * BERT_LAYERS * 3,
                 K8b=2 * BERT_LAYERS * 3, K4=3)
    if accum_launches != want2 or not all(np.isfinite(kern_losses)):
        fail(f"accumulation run: launches {accum_launches} != {want2} or "
             f"losses {kern_losses}")
    if dense_launches["K7"] or dense_launches["K8a"] or \
            dense_launches["K8b"]:
        fail(f"the masked-dense oracle run launched sparse kernels: "
             f"{dense_launches}")
    if not loss_gap <= TRAIN_LOSS_ATOL:
        fail(f"kernel losses {kern_losses} vs masked dense {dense_losses}: "
             f"gap {loss_gap} > {TRAIN_LOSS_ATOL}")
    if not all(e <= TRAIN_GRAD_RTOL for e in grad_err.values()):
        fail(f"kernel vs masked-dense attn_qkvw gradients differ by "
             f"{grad_err} > {TRAIN_GRAD_RTOL} (relative)")
    return row


# ---------------------------------------------------------------------------
# ZeRO-Offload slice: GPT-2 1.5B on one card, the host C++ Adam, remat, the
# data loader and checkpoints
# ---------------------------------------------------------------------------

OFFLOAD_B, OFFLOAD_T = 4, 1024        # bench.py's offload row: bs 4 x 1024
OFFLOAD_WARMUP, OFFLOAD_STEPS = 1, 3  # bench.py's BENCH_STEPS default
OFFLOAD_LAYERS, OFFLOAD_HEADS = 24, 25   # 1.5B widths, depth cut from 48
OFFLOAD_CHUNK = 512                   # loss_chunk
# host RAM the offload phase needs at 1.5B: masters, both moments and the
# fp32 gradient (16 B an element), the bf16 landing and copy-back buffers
# (4 B), one pinned block rounded up to a power of two; the host model's
# fp32 init (4 B, freed once the engine has the masters) and the plain
# check's master snapshot (4 B)
OFFLOAD_HOST_BYTES_PER_PARAM = 28
# the C++ Adam against its plain version: one unit in the last place of
# fp32 (the SIMD body's FMAs and reciprocal against separate mul-adds and
# a division), so rtol 1e-6, plus 1e-7 of the masters' largest magnitude
# where an update cancels a master to near 0
HOST_ADAM_RTOL, HOST_ADAM_ATOL_REL = 1e-6, 1e-7
PLAIN_CHUNK = 1 << 26                 # elements a plain-check slice
RESUME_STEPS, RESUME_SAVE_AT = 6, 3
RESUME_B, RESUME_T, RESUME_HEADS = 4, 1024, 12
RESUME_SAMPLES = 24                   # 6 batches an epoch


def _host_info():
    """The host's CPU model (``/proc/cpuinfo``'s ``model name``, else
    ``lscpu``'s, else its vendor / family / model fields), core count and
    MemTotal (bytes)."""
    model, fields, mem = None, {}, None
    try:
        for line in open("/proc/cpuinfo"):
            key, _, value = line.partition(":")
            key = key.strip()
            if key == "model name" and model is None and \
                    value.strip() not in ("", "unknown"):
                model = value.strip()
            elif key in ("vendor_id", "cpu family", "model", "flags") and \
                    key not in fields:
                fields[key] = value.strip()
        for line in open("/proc/meminfo"):
            if line.startswith("MemTotal"):
                mem = int(line.split()[1]) * 1024
                break
    except OSError:
        pass
    if model is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            for line in out.splitlines():
                name = line.split(":", 1)[-1].strip()
                if line.startswith("Model name") and \
                        name not in ("", "unknown", "-"):
                    model = name
        except (OSError, subprocess.SubprocessError):
            pass
    if model is None and fields:
        model = " ".join(f"{k}={fields[k]}" for k in
                         ("vendor_id", "cpu family", "model") if k in fields)
    simd = [f for f in ("avx512f", "avx2", "fma")
            if f in fields.get("flags", "").split()]
    return {"cpu_model": model, "cpu_count": os.cpu_count(),
            "cpu_simd_flags": simd, "mem_total_bytes": mem,
            "cpuinfo": {k: v for k, v in fields.items() if k != "flags"}}


def _host_rates_gbps(torch, n=1 << 28, reps=3):
    """Host memory rates, GB/s, each the best of ``reps`` calls over
    buffers of ``n`` fp32 elements, at torch's thread count and at one
    thread a core (OpenMP's default, the C++ Adam's): a copy (bytes read
    and written), and in-place updates with the C++ Adam's pattern of
    streams read and written back where they lie (``a += b``: 12 bytes an
    element; ``a += b * c``: 16)."""
    bufs = [torch.full((n,), 1.0 + i) for i in range(4)]
    a, b, c, d = bufs
    probes = {"copy": (lambda: d.copy_(a), 8),
              "add_inplace": (lambda: a.add_(b), 12),
              "addcmul_inplace": (lambda: a.addcmul_(b, c), 16)}
    threads = torch.get_num_threads()
    rates = {}
    for nt in sorted({threads, os.cpu_count() or threads}):
        torch.set_num_threads(nt)
        for name, (fn, per_elem) in probes.items():
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            rates[f"{name}@{nt}"] = per_elem * n / best / 1e9
    torch.set_num_threads(threads)
    del a, b, c, d, bufs
    return rates


def _token_dataset(rng, n, t, vocab):
    """``n`` samples of ``t`` random token ids (the bench's synthetic
    batch), as a list of dicts the loader collates."""
    ids = rng.integers(0, vocab, (n, t)).astype(np.int32)
    return [{"input_ids": ids[i]} for i in range(n)]


def _offload_config(extra=None):
    return {"train_batch_size": OFFLOAD_B, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2, "cpu_offload": True,
                                  "offload_16bit_grads": True},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
            "steps_per_print": 10 ** 9, **(extra or {})}


def _plain_check(torch, engine, master0, lr, beta1):
    """The masters after step 1 against the plain host Adam from
    ``master0`` on the gradient the C++ kernel read (moments 0 before
    step 1), slice by slice; returns (max abs err, max err past the
    tolerance, the plain version's seconds over the whole buffer)."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam import adam_plain
    opt = engine.cpu_optimizer
    worst = worst_excess = plain_s = 0.0
    atol = HOST_ADAM_ATOL_REL * float(master0.abs().max())
    for a in range(0, opt.total, PLAIN_CHUNK):
        b = min(a + PLAIN_CHUNK, opt.total)
        m = master0[a:b].clone()
        ea = torch.zeros(b - a)
        es = torch.zeros(b - a)
        t0 = time.perf_counter()
        adam_plain(m, opt._grad_buf[a:b], ea, es, 1, lr, beta1,
                   opt.betas[1], opt.eps, opt.weight_decay)
        plain_s += time.perf_counter() - t0
        d = (m - opt.master[a:b]).abs()
        worst = max(worst, float(d.max()))
        excess = d - (atol + HOST_ADAM_RTOL * m.abs())
        worst_excess = max(worst_excess, float(excess.max()))
    return worst, worst_excess, plain_s


def _host_grads_equal_wire(torch, engine):
    """The fp32 gradient the C++ Adam read equals the device's 16-bit
    wire widened, bit for bit (slice by slice): the per-chunk D2H, the
    landing buffer and the widen lost or moved nothing."""
    opt = engine.cpu_optimizer
    torch.cuda.synchronize()
    for a in range(0, opt.total, PLAIN_CHUNK):
        b = min(a + PLAIN_CHUNK, opt.total)
        if not torch.equal(opt._grad_buf[a:b], engine._wire[a:b].cpu()
                           .float()):
            return False
    return True


def _device_equals_bf16_masters(torch, engine):
    """The device params equal bf16(masters), bit for bit (compared on
    the card, slice by slice)."""
    opt = engine.cpu_optimizer
    torch.cuda.synchronize()
    for a in range(0, opt.total, PLAIN_CHUNK):
        b = min(a + PLAIN_CHUNK, opt.total)
        want = opt.master[a:b].to("cuda").to(torch.bfloat16)
        if not torch.equal(engine._dev_flat[a:b], want):
            return False
    return True


def phase_train_offload(torch):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_1_5b
    from deepspeed_tpu_torch.ops._build import build_info
    from deepspeed_tpu_torch.ops.adam.cpu_adam import load_cpu_adam

    host = _host_info()
    cfg = dataclasses.replace(
        gpt2_1_5b(n_positions=OFFLOAD_T, dropout=0.0,
                  use_flash_attention=True, loss_chunk=OFFLOAD_CHUNK,
                  remat=True, remat_policy="full"), n_layer=OFFLOAD_LAYERS)
    if (cfg.n_layer, cfg.n_head) != (OFFLOAD_LAYERS, OFFLOAD_HEADS):
        fail(f"gpt2_1_5b has {cfg.n_layer} layers of {cfg.n_head} heads; "
             f"the gates and train_kernel_check's shape assume "
             f"{OFFLOAD_LAYERS} of {OFFLOAD_HEADS}")
    n_params = OFFLOAD_LAYERS * (12 * cfg.n_embd ** 2 + 13 * cfg.n_embd) \
        + (cfg.vocab_size + cfg.n_positions + 2) * cfg.n_embd
    need = n_params * OFFLOAD_HOST_BYTES_PER_PARAM
    emit({"phase": "train_offload_host", **host, "params": n_params,
          "host_bytes_needed": need})
    if host["mem_total_bytes"] is None or host["mem_total_bytes"] < need:
        fail(f"the host holds {host['mem_total_bytes']} bytes of RAM, the "
             f"1.5B offload phase needs about {need}")
    simd = load_cpu_adam().ds_simd_width()
    counters = _flash_counters()
    gen = torch.Generator()
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = GPT2LMHead(cfg, device="cpu", generator=gen)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    data = _token_dataset(rng, OFFLOAD_B, OFFLOAD_T, cfg.vocab_size)
    t0 = time.perf_counter()
    engine, _, loader, _ = initialize(model=model, config=_offload_config(),
                                      training_data=data)
    engine_s = time.perf_counter() - t0
    opt = engine.cpu_optimizer
    if opt.total != n_params:
        fail(f"the offload optimizer holds {opt.total} elements, the model "
             f"{n_params}")
    fp32_on_card = [n for n, p in model.named_parameters()
                    if p.device.type == "cuda" and p.dtype != torch.bfloat16]
    pinned = all(b.is_pinned() for b in (opt.master, opt.exp_avg,
                                         opt.exp_avg_sq, opt._grad_buf,
                                         opt._landing, opt._bf16_buf))
    master0 = opt.master.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, walls, host_phase, stats = [], [], [], []
    for i in range(OFFLOAD_WARMUP + OFFLOAD_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        host_phase.append(engine.last_host_phase_s)
        stats.append(engine.host_phase_stats())
        if i == 0:
            lr = float(engine._last_metrics["lr"])
            worst, excess, plain_s = _plain_check(torch, engine, master0,
                                                  lr, engine._betas[0])
            bitwise = _device_equals_bf16_masters(torch, engine)
            wire_ok = _host_grads_equal_wire(torch, engine)
            del master0
    launches = {n: c.launches for n, c in counters.items()}
    steps = OFFLOAD_WARMUP + OFFLOAD_STEPS
    peak = torch.cuda.max_memory_allocated()
    timed = walls[OFFLOAD_WARMUP:]
    tokens = OFFLOAD_B * OFFLOAD_T
    fpt = model_flops_per_token(cfg, OFFLOAD_T)
    tps = tokens * len(timed) / sum(timed)
    tstats = stats[OFFLOAD_WARMUP:]
    adam_ms = statistics.median(s["adam_s"] for s in tstats) * 1e3
    convert_ms = statistics.median(s["convert_s"] for s in tstats) * 1e3
    d2h = statistics.median(s["d2h_bytes"] / s["d2h_s"] for s in tstats)
    h2d = statistics.median(s["h2d_bytes"] / s["h2d_s"] for s in tstats)
    profile = _profile(torch, lambda: engine.train_batch(), 2)
    host_bw = _host_rates_gbps(torch)
    adam_bytes = 28 * opt.total
    probe_ms = adam_bytes / (max(host_bw.values()) * 1e9) * 1e3
    row = {"phase": "train_offload", "model": "gpt2_1_5b",
           "batch": OFFLOAD_B, "seq": OFFLOAD_T, "dtype": "bfloat16",
           "remat": "full", "loss_chunk": OFFLOAD_CHUNK,
           "zero_optimization": _offload_config()["zero_optimization"],
           "optimizer": "adam (host C++)", **host, "simd_width": simd,
           "host_adam_build_s": build_info.get("cpu_adam", {}).get(
               "seconds"),
           "host_init_s": init_s, "initialize_s": engine_s,
           "losses": losses, "step_wall_s": walls,
           "host_phase_s": host_phase, "tokens_per_s": tps,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "model_flops_per_token": fpt,
           "model_flops_per_step": fpt * tokens,
           "mfu": tps * fpt / BF16_PEAK_FLOPS,
           "host_phase_share": sum(host_phase[OFFLOAD_WARMUP:]) / sum(timed),
           "d2h_gb_per_s": d2h / 1e9, "h2d_gb_per_s": h2d / 1e9,
           "d2h_bytes": tstats[-1]["d2h_bytes"],
           "h2d_bytes": tstats[-1]["h2d_bytes"],
           "cpu_adam_ms": adam_ms, "bf16_convert_ms": convert_ms,
           "max_memory_allocated": peak, "launches": launches,
           "launches_per_step": {n: v / steps for n, v in launches.items()},
           "pinned": pinned, "fp32_params_on_card": fp32_on_card,
           "plain_check": {"max_abs_err": worst, "excess": excess,
                           "rtol": HOST_ADAM_RTOL,
                           "atol_rel": HOST_ADAM_ATOL_REL},
           "device_params_equal_bf16_masters": bitwise,
           "host_grads_equal_wire": wire_ok,
           "loader_samples_served": engine._data_iter.samples_served,
           "profile": profile}
    emit(row)
    host_op = {"name": "cpu_adam", "route": "c++ (g++ -fopenmp, "
               f"SIMD width {simd})",
               "source": "deepspeed_tpu_torch/ops/csrc/cpu_adam.cpp",
               "elements": opt.total, "ms": adam_ms,
               "plain_ms": plain_s * 1e3,
               # the Adam's bytes at the best probed rate; a bound only
               # where the Adam did not beat it (the probes are torch
               # ops, not a measured roof)
               "probe_ms": probe_ms,
               "bound_ms": probe_ms if adam_ms >= probe_ms else None,
               "bound_by": "bytes", "bytes": adam_bytes,
               "host_gb_per_s": host_bw,
               "bf16_convert_ms": convert_ms,
               "max_abs_err": worst, **host}
    del engine, model, loader, opt
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"offload loss not finite and falling: {losses}")
    if excess > 0:
        fail(f"the C++ Adam's masters after step 1 differ from the plain "
             f"host Adam by {worst} (rtol {HOST_ADAM_RTOL}, atol "
             f"{HOST_ADAM_ATOL_REL} of the largest master)")
    if not bitwise:
        fail("the device params differ from bf16(host masters) after step 1")
    if not wire_ok:
        fail("the host's fp32 gradient differs from the device's bf16 wire "
             "after step 1")
    want = {"K1": 2 * OFFLOAD_LAYERS * steps, "K2": OFFLOAD_LAYERS * steps,
            "K3": OFFLOAD_LAYERS * steps, "K4": 0}
    if launches != want:
        fail(f"offload launches {launches} != {want} over {steps} steps "
             f"(remat 'full' runs K1 again in each block's recompute; the "
             f"update is the host Adam's, so K4 never)")
    if not pinned or fp32_on_card:
        fail(f"offload buffers pinned: {pinned}; fp32 params on the card: "
             f"{fp32_on_card[:4]}")
    return row, host_op


def phase_train_dense_yardstick(torch):
    """The same 1.5B model, batch and remat on the dense engine (fp32
    masters and K4's moments on the card): what offload costs here."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_1_5b
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = dataclasses.replace(
        gpt2_1_5b(n_positions=OFFLOAD_T, dropout=0.0,
                  use_flash_attention=True, loss_chunk=OFFLOAD_CHUNK,
                  remat=True, remat_policy="full"), n_layer=OFFLOAD_LAYERS)
    model = GPT2LMHead(cfg, device="cuda", generator=gen)
    config = {"train_batch_size": OFFLOAD_B, "bf16": {"enabled": True},
              "optimizer": {"type": "Adam",
                            "params": {"lr": 1e-4, "pallas": True}},
              "steps_per_print": 10 ** 9}
    rng = np.random.default_rng(0)
    engine, _, _, _ = initialize(
        model=model, config=config,
        training_data=_token_dataset(rng, OFFLOAD_B, OFFLOAD_T,
                                     cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(OFFLOAD_WARMUP + OFFLOAD_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    timed = walls[OFFLOAD_WARMUP:]
    tps = OFFLOAD_B * OFFLOAD_T * len(timed) / sum(timed)
    row = {"phase": "train_dense_yardstick", "model": "gpt2_1_5b",
           "batch": OFFLOAD_B, "seq": OFFLOAD_T, "dtype": "bfloat16",
           "remat": "full", "optimizer": "adam (fused K4)",
           "losses": losses, "step_wall_s": walls,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "tokens_per_s": tps,
           "mfu": tps * model_flops_per_token(cfg, OFFLOAD_T)
           / BF16_PEAK_FLOPS,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(row)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        fail(f"dense yardstick loss not finite: {losses}")
    return row


def _resume_engine(torch, seed, data):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_125m
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = GPT2LMHead(gpt2_125m(n_positions=RESUME_T, dropout=0.0,
                                 use_flash_attention=True,
                                 loss_chunk=OFFLOAD_CHUNK, remat=True),
                       device="cpu", generator=gen)
    config = dict(_offload_config(), train_batch_size=RESUME_B)
    engine, _, _, _ = initialize(model=model, config=config, seed=seed,
                                 training_data=data)
    return engine


def phase_offload_resume(torch):
    """GPT-2 125M bf16 offload: 6 steps with a checkpoint after step 3,
    then a fresh engine (another seed) loads it and runs steps 4-6; its
    losses and final masters must equal the uninterrupted run's, bit for
    bit, and its data cursor must be restored."""
    import tempfile

    from deepspeed_tpu_torch.models.gpt2 import gpt2_125m
    if gpt2_125m().n_head != RESUME_HEADS:
        fail(f"gpt2_125m has {gpt2_125m().n_head} heads; "
             f"train_kernel_check's shape assumes {RESUME_HEADS}")
    rng = np.random.default_rng(0)
    data = _token_dataset(rng, RESUME_SAMPLES, RESUME_T, 50257)
    with tempfile.TemporaryDirectory(prefix="offload_resume_") as root:
        a = _resume_engine(torch, 0, data)
        losses = []
        for step in range(RESUME_STEPS):
            losses.append(float(a.train_batch()))
            if step + 1 == RESUME_SAVE_AT:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.save_checkpoint(root, tag="step3")
                save_s = time.perf_counter() - t0
                cursor = a._data_iter.samples_served
        final = a.cpu_optimizer.master.clone()
        state_bytes = 12 * a.cpu_optimizer.total
        del a
        b = _resume_engine(torch, 123, data)
        t0 = time.perf_counter()
        path, _ = b.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        restored_cursor = b._data_iter.samples_served
        resumed = [float(b.train_batch())
                   for _ in range(RESUME_STEPS - RESUME_SAVE_AT)]
        same_masters = torch.equal(b.cpu_optimizer.master, final)
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(path) for f in fs)
        del b
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "offload_resume", "model": "gpt2_125m",
           "batch": RESUME_B, "seq": RESUME_T, "dtype": "bfloat16",
           "losses": losses, "resumed_losses": resumed,
           "saved_at_step": RESUME_SAVE_AT, "cursor": cursor,
           "restored_cursor": restored_cursor,
           "final_masters_equal": same_masters,
           "state_bytes": state_bytes, "checkpoint_bytes": ckpt_bytes,
           "save_s": save_s, "load_s": load_s,
           "save_gb_per_s": ckpt_bytes / save_s / 1e9,
           "load_gb_per_s": ckpt_bytes / load_s / 1e9}
    emit(row)
    if resumed != losses[RESUME_SAVE_AT:] or not same_masters:
        fail(f"resume is not bit-exact: losses {losses[RESUME_SAVE_AT:]} "
             f"uninterrupted, {resumed} resumed; masters equal: "
             f"{same_masters}")
    if restored_cursor != cursor or cursor != RESUME_SAVE_AT * RESUME_B:
        fail(f"data cursor {restored_cursor} restored, {cursor} saved")
    if not all(np.isfinite(losses)):
        fail(f"resume losses not finite: {losses}")
    return row


PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 4, 8   # S, M, train batch
PIPE_WARMUP, PIPE_STEPS = 2, 5
PIPE_LAYERS = 8                    # train_pipe's depth (350M widths)


def _pipe_350m(**kw):
    """GPT-2 350M's widths at ``PIPE_LAYERS`` blocks."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    return GPT2Config(n_embd=1024, n_layer=PIPE_LAYERS, n_head=16, **kw)


PIPE_MICRO_LONG = 16          # the 1F1B memory check's M (batch 32)
PIPE_ONE_STAGE_STEPS = 3
# S = 1 against the unpipelined engine (bf16, the same micro-batches): the
# first loss within 1e-5 (one forward, the loss reduced in another
# order); later losses within 2e-3, and the masters' 3-step updates
# within 10% of the plain engine's in L2 over the model (the two
# normalise the loss in another order, so their bf16 gradients round
# apart, and Adam turns a gradient near 0 into a step of lr times its
# sign)
PIPE_FIRST_LOSS_RTOL, PIPE_LOSS_RTOL, PIPE_UPDATE_RTOL = 1e-5, 2e-3, 0.1
PIPE_LR = 1e-4


def _pipe_engine(torch, stages, micro, rows, state=None, interval=0,
                 cfg=None, dtype="bfloat16"):
    """GPT-2 350M (or ``cfg``) as a PipelineModule through
    ``initialize``: every stage in this process on ``cuda:0``."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
    cfg = cfg or _pipe_350m(n_positions=TRAIN_T, dropout=0.0,
                            use_flash_attention=True, loss_chunk=0)
    module = gpt2_pipeline_module(cfg, seq_len=TRAIN_T,
                                  activation_checkpoint_interval=interval)
    config = {"train_batch_size": rows, "gradient_accumulation_steps": micro,
              "optimizer": {"type": "Adam", "params": {"lr": PIPE_LR}},
              "mesh": {"pipe": stages}, "steps_per_print": 10 ** 9}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
    engine, _, _, _ = initialize(model=module, config=config,
                                 model_parameters=state)
    return engine


def _pipe_batch(rows, seed=0):
    import torch
    rng = np.random.default_rng(seed)
    return {"input_ids": torch.from_numpy(
        rng.integers(0, 50257, (rows, TRAIN_T)).astype(np.int64))}


def _sequential_gate(torch, engine, what):
    """Step 1's loss sums and every raw stage gradient of the 1F1B
    executor against the sequential oracle on the same stage modules:
    bit for bit. Returns the row; fails on any difference."""
    got = engine.sequential_check(_pipe_batch(engine._config.
                                              train_batch_size))
    (en, ed, eg), (on, od, og) = got["executor"], got["oracle"]
    diff = [int(not torch.equal(a, b)) for a, b in zip(eg, og)]
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(eg, og))
    row = {"what": what, "loss": float(en / ed),
           "oracle_loss": float(on / od),
           "loss_bitwise": bool(torch.equal(en, on) and torch.equal(ed, od)),
           "leaves": len(eg), "leaves_not_bitwise": sum(diff),
           "max_abs_grad_diff": worst}
    if not row["loss_bitwise"] or sum(diff):
        emit(dict(row, phase="train_pipe_sequential"))
        fail(f"pipeline {what}: the 1F1B executor differs from the "
             f"sequential oracle ({row})")
    return row


def _tied_equal(torch, engine):
    first = dict(engine.parts.stages[0].tied.named_parameters())
    last = dict(engine.parts.stages[engine.num_stages - 1].tied
                .named_parameters())
    return all(torch.equal(first[n], last[n]) for n in first)


def _pipe_grads(torch, engine, counters):
    """One ``value_and_grad`` of the phase's batch: the gradients (pipe
    layout, on the host) and the K1-K4 launches it made."""
    for c in counters.values():
        c.launches = 0
    _, grads = engine.value_and_grad(_pipe_batch(PIPE_ROWS))
    torch.cuda.synchronize()
    return grads, {n: c.launches for n, c in counters.items()}


def phase_train_pipe(torch):
    """GPT-2 350M through the pipeline with every stage on ``cuda:0``
    (module docstring, phase 20)."""
    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2LMHead, gpt2_125m)
    from deepspeed_tpu_torch.models.gpt2_pipe import pipe_state_to_lm
    from deepspeed_tpu_torch.runtime.pipe.schedule import TrainSchedule
    counters = _flash_counters()
    S, M = PIPE_STAGES, PIPE_MICRO
    row = {"phase": "train_pipe", "model": "gpt2_350m widths",
           "layers": PIPE_LAYERS, "stages": S, "micro_batches": M,
           "rows": PIPE_ROWS, "seq": TRAIN_T,
           "dtype": "bfloat16", "transport": "in-process (cuda:0 x 4)"}

    # the bitwise gate at 125M f32, S = 2, then at 350M bf16, S = 4
    small = _pipe_engine(torch, 2, M, PIPE_ROWS, dtype="float32",
                         cfg=gpt2_125m(n_positions=TRAIN_T, dropout=0.0,
                                       dtype=torch.float32,
                                       use_flash_attention=True))
    row["sequential_125m_f32"] = _sequential_gate(torch, small,
                                                  "125M f32, S = 2")
    del small
    torch.cuda.empty_cache()
    engine = _pipe_engine(torch, S, M, PIPE_ROWS)
    row["sequential_350m_bf16"] = _sequential_gate(torch, engine,
                                                   "350M bf16, S = 4")
    state = engine.pipe_state()

    # the timed run: every count zeroed just before it
    batch = _pipe_batch(PIPE_ROWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, walls, tied = [], [], []
    for _ in range(PIPE_WARMUP + PIPE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        tied.append(_tied_equal(torch, engine))
    steps = PIPE_WARMUP + PIPE_STEPS
    launches = {n: c.launches for n, c in counters.items()}
    peak4 = torch.cuda.max_memory_allocated()
    p2p = engine.p2p_counts()
    act_bytes = (PIPE_ROWS // M) * TRAIN_T * 1024 * 2
    timed = walls[PIPE_WARMUP:]
    fpt = model_flops_per_token(_pipe_350m(n_positions=TRAIN_T), TRAIN_T)
    tps = PIPE_ROWS * TRAIN_T * len(timed) / sum(timed)
    in_flight = dict(engine.executor.max_in_flight)
    profile = _profile(torch, lambda: engine.train_batch(batch), 2)
    row["tied_equal_after_profile"] = _tied_equal(torch, engine)
    del engine
    torch.cuda.empty_cache()
    row.update({
        "losses": losses, "step_wall_s": walls,
        "step_p50_ms": statistics.median(timed) * 1e3,
        "tokens_per_s": tps, "model_flops_per_token": fpt,
        "mfu": tps * fpt / BF16_PEAK_FLOPS,
        "max_memory_allocated": peak4, "launches": launches,
        "launches_per_step": {n: v / steps for n, v in launches.items()},
        "tied_equal_after_each_step": tied,
        "p2p_per_step": p2p,
        "p2p_predicted": {"messages": 2 * (S - 1) * M,
                          "bytes": 2 * (S - 1) * M * act_bytes},
        "max_in_flight": in_flight, "profile": profile})

    # the 1F1B memory property: M = 16 against M = 4
    long = _pipe_engine(torch, S, PIPE_MICRO_LONG, 2 * PIPE_MICRO_LONG,
                        state=state)
    long_batch = _pipe_batch(2 * PIPE_MICRO_LONG)
    long.train_batch(long_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    long.train_batch(long_batch)
    peak16 = torch.cuda.max_memory_allocated()
    bufs = {m: sum(TrainSchedule(m, S, s).num_pipe_buffers()
                   for s in range(S)) for m in (M, PIPE_MICRO_LONG)}
    # the stage inputs of the buffers M = 16 adds over M = 4 (one, on
    # stage 0), and the larger batch's token ids and labels
    extra = bufs[PIPE_MICRO_LONG] - bufs[M]
    allowance = extra * act_bytes + 2 * (
        long_batch["input_ids"].numel() - batch["input_ids"].numel()) * 8
    row["memory_1f1b"] = {
        "peak_m4": peak4, "peak_m16": peak16,
        "growth": peak16 - peak4, "allowance": allowance,
        "num_pipe_buffers": {"m4": bufs[M],
                             "m16": bufs[PIPE_MICRO_LONG]},
        "stage_input_bytes": act_bytes,
        "max_in_flight_m16": dict(long.executor.max_in_flight)}
    del long
    torch.cuda.empty_cache()

    # activation checkpointing every layer: no bit changes, K1 doubles
    plain_engine = _pipe_engine(torch, S, M, PIPE_ROWS, state=state)
    g0, l0 = _pipe_grads(torch, plain_engine, counters)
    del plain_engine
    ck_engine = _pipe_engine(torch, S, M, PIPE_ROWS, state=state,
                             interval=1)
    g1, l1 = _pipe_grads(torch, ck_engine, counters)
    del ck_engine
    ck_diff = sorted(n for n in g0 if not torch.equal(g0[n], g1[n]))
    row["checkpoint_interval_1"] = {"launches": l1, "launches_none": l0,
                                    "leaves_not_bitwise": len(ck_diff)}
    del g0, g1
    torch.cuda.empty_cache()

    # S = 1 against the unpipelined engine, then the yardstick's time
    one = _pipe_engine(torch, 1, M, PIPE_ROWS, state=_restack(state, 1))
    lm = GPT2LMHead(_pipe_350m(n_positions=TRAIN_T, dropout=0.0,
                              use_flash_attention=True, loss_chunk=0),
                    device="meta")
    lm.load_state_dict({k: v.detach().to("cuda").clone()
                        for k, v in pipe_state_to_lm(state).items()},
                       assign=True)
    from deepspeed_tpu_torch import initialize
    ref, _, _, _ = initialize(model=lm, config={
        "train_batch_size": PIPE_ROWS, "gradient_accumulation_steps": M,
        "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": PIPE_LR}},
        "steps_per_print": 10 ** 9})
    one_losses, ref_losses = [], []
    for i in range(PIPE_ONE_STAGE_STEPS):
        b = _pipe_batch(PIPE_ROWS, seed=i)
        one_losses.append(float(one.train_batch(b)))
        ref_losses.append(float(ref.train_batch(b)))
    got = pipe_state_to_lm(one.pipe_state())
    init = pipe_state_to_lm(state)
    master_diff, num, den = 0.0, 0.0, 0.0
    for n, p in lm.named_parameters():
        d_ref = p.detach() - init[n].to(p.device)
        d_one = got[n].to(p.device) - init[n].to(p.device)
        master_diff = max(master_diff, float((d_one - d_ref).abs().max()))
        num += float(((d_one - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
    update_rel = (num / den) ** 0.5
    del one
    torch.cuda.empty_cache()
    ref_walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PIPE_WARMUP + PIPE_STEPS):
        t0 = time.perf_counter()
        float(ref.train_batch(batch))
        ref_walls.append(time.perf_counter() - t0)
    ref_timed = ref_walls[PIPE_WARMUP:]
    ref_peak = torch.cuda.max_memory_allocated()
    ref_tps = PIPE_ROWS * TRAIN_T * len(ref_timed) / sum(ref_timed)
    del ref, lm
    torch.cuda.empty_cache()
    row["one_stage_vs_plain"] = {
        "losses": one_losses, "plain_losses": ref_losses,
        "max_abs_master_diff": master_diff,
        "update_rel_l2": update_rel, "update_rtol": PIPE_UPDATE_RTOL,
        "first_loss_rtol": PIPE_FIRST_LOSS_RTOL, "loss_rtol": PIPE_LOSS_RTOL}
    row["yardstick_unpipelined"] = {
        "step_p50_ms": statistics.median(ref_timed) * 1e3,
        "tokens_per_s": ref_tps, "mfu": ref_tps * fpt / BF16_PEAK_FLOPS,
        "max_memory_allocated": ref_peak,
        "gradient_accumulation_steps": M}
    emit(row)

    # the gates
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"pipeline training loss not finite and falling: {losses}")
    if not all(tied) or not row["tied_equal_after_profile"]:
        fail(f"the tied wte copies of stages 0 and {S - 1} differ after "
             f"a step: {tied}")
    want = {"K1": PIPE_LAYERS * M * steps, "K2": PIPE_LAYERS * M * steps,
            "K3": PIPE_LAYERS * M * steps, "K4": S * steps}
    if launches != want:
        fail(f"pipeline launches {launches} != {want} over {steps} steps")
    if p2p != {"messages": 2 * (S - 1) * M,
               "bytes": 2 * (S - 1) * M * act_bytes, "meta_messages": 0}:
        fail(f"p2p a step {p2p} != the predicted {row['p2p_predicted']}")
    mem = row["memory_1f1b"]
    if mem["growth"] > allowance or \
            mem["max_in_flight_m16"] != row["max_in_flight"]:
        fail(f"peak memory grew by {mem['growth']} B from M = {M} to "
             f"{PIPE_MICRO_LONG}, past the {allowance} B of the stage "
             f"inputs num_pipe_buffers adds and the batch, or more micro-batches were in "
             f"flight: {mem}")
    ck = row["checkpoint_interval_1"]
    if ck["leaves_not_bitwise"] or ck["launches"]["K1"] != \
            2 * ck["launches_none"]["K1"] or \
            ck["launches_none"]["K1"] != PIPE_LAYERS * M:
        fail(f"activation_checkpoint_interval 1 changed bits or K1's "
             f"launches are not doubled: {ck}")
    one_row = row["one_stage_vs_plain"]
    if not (abs(one_losses[0] - ref_losses[0]) <=
            PIPE_FIRST_LOSS_RTOL * abs(ref_losses[0]) and
            np.allclose(one_losses, ref_losses, rtol=PIPE_LOSS_RTOL,
                        atol=0) and
            update_rel <= PIPE_UPDATE_RTOL):
        fail(f"S = 1 differs from the unpipelined engine: {one_row}")
    return row


def _restack(state, stages):
    """The pipe layout ``state`` restacked over ``stages`` stages."""
    out = {}
    for name, t in state.items():
        if name.startswith("body."):
            t = t.reshape((stages, -1) + tuple(t.shape[2:]))
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# tensor parallelism on one card (phases 21-23) and the pipeline's ZeRO
# compositions (phase 24)
# ---------------------------------------------------------------------------

TP_WORLD = 2                       # model-parallel processes on cuda:0
TP_WARMUP, TP_STEPS = 2, 5
TP_LAYERS = 6                      # train_tp's depth (350M widths)
TP_LOSS_RTOL = 1e-3                # bf16 losses (test_torch_gpt2_train)
TP_MASTER_REL_L2 = 5e-3            # masters after 7 steps, relative L2
TP_SPAWN_TIMEOUT_S = 420
TP_HEADS = TRAIN_H // TP_WORLD     # each rank's heads at 350M
PIPE_TP_VOCAB, PIPE_TP_D, PIPE_TP_H, PIPE_TP_BLOCKS = 32000, 1024, 16, 4
PIPE_TP_ROWS, PIPE_TP_T, PIPE_TP_MICRO = 8, 512, 4
PIPE_TP_STEPS = 3
PIPE_TP_LOSS_RTOL = 1e-5           # chunks 4 vs off, f32
PIPE_ZERO_WARMUP, PIPE_ZERO_STEPS = 1, 3


def _spawn_tp(torch, phase, spec, world=TP_WORLD):
    """Run ``phase`` in ``world`` processes of this script
    (``--tp-worker``) on ``cuda:0``, joined by gloo on a file store; they
    share the build in ``.torch_ext``. Returns each rank's result dict
    and the phase's directory; every process is killed when one fails or
    runs out of time."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix=f"tp_{phase}_")
    spec = dict(spec, phase=phase, world=world,
                store=os.path.join(tmp, "store"), out=tmp)
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    logs = [open(os.path.join(tmp, f"{r}.err"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", path,
         str(r)], stdout=subprocess.DEVNULL, stderr=logs[r], text=True)
        for r in range(world)]

    def tail(r):
        logs[r].flush()
        logs[r].seek(0)
        return logs[r].read()[-3000:]

    try:
        # a rank that fails stops the others at once (they would wait
        # for it in a collective until the deadline)
        deadline = time.monotonic() + TP_SPAWN_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                fail(f"{phase}: rank {bad[0]} exited "
                     f"{procs[bad[0]].returncode}:\n{tail(bad[0])}")
            if time.monotonic() > deadline:
                fail(f"{phase}: ranks ran past {TP_SPAWN_TIMEOUT_S} s:\n" +
                     "\n".join(f"rank {r}: {tail(r)}"
                               for r in range(world)))
            time.sleep(0.2)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            fail(f"{phase}: rank {bad[0]} exited "
                 f"{procs[bad[0]].returncode}:\n{tail(bad[0])}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{r}.json")) as f:
            out.append(json.load(f))
    return out, tmp


def _tp_worker(torch, spec_path, rank):
    """One model-parallel rank of a TP phase (``_spawn_tp``)."""
    from deepspeed_tpu_torch.parallel import mesh
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh.initialize_distributed(
        coordinator_address="file://" + spec["store"],
        num_processes=spec["world"], process_id=rank, device="cuda:0",
        backend="gloo")
    try:
        groups = mesh.MeshGroups(spec["mesh"], in_process_pipe=bool(
            spec.get("in_process_pipe")))
        res = _TP_WORKERS[spec["phase"]](torch, spec, groups, rank)
        with open(os.path.join(spec["out"], f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        gc.collect()
        mesh.destroy_distributed()
    return 0


def _tp_350m(torch, dropout, mpu=None):
    """The ``train`` row's GPT-2 350M widths at ``TP_LAYERS`` blocks from
    seed 0 (a TP shard with ``mpu``: each leaf drawn whole, in the same
    order, then cut)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return GPT2LMHead(GPT2Config(n_embd=1024, n_layer=TP_LAYERS, n_head=16,
                                 n_positions=TRAIN_T, dropout=dropout,
                                 use_flash_attention=True, loss_chunk=0),
                      device="cuda", generator=gen, mpu=mpu)


def _tp_config(mesh_shape=None):
    cfg = {"train_batch_size": TRAIN_B, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-4, "pallas": True}},
           "steps_per_print": 10 ** 9}
    if mesh_shape:
        cfg["mesh"] = mesh_shape
    return cfg


def _train_batch_350m():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 50257, (TRAIN_B, TRAIN_T))
            .astype(np.int32)}


def _recorded_k1_calls(fa):
    """Wrap the models' flash-attention entry (the one that launches K1
    forward) to note each call's dropout coordinates; returns
    ``(calls, restore)``."""
    calls = []
    orig = fa.flash_attention

    def rec(q, *args, **kw):
        if kw.get("dropout_rate", 0.0) > 0.0:
            B_, T_, H_, _ = q.shape
            calls.append([B_, H_, T_, int(kw["dropout_seed"]),
                          int(kw.get("dropout_head_offset", 0)),
                          kw.get("dropout_num_heads")])
        return orig(q, *args, **kw)

    fa.flash_attention = rec

    def restore():
        fa.flash_attention = orig
    return calls, restore


def _tp_train_run(torch, engine, batch, steps, counters, comm=None,
                  after_step=None):
    """``steps`` train steps: losses, step walls, the K1-K4 launches and
    (TP) the collectives' calls and bytes of the last step;
    ``after_step(i)`` runs after step i, outside its wall."""
    for c in counters.values():
        c.launches = 0
    losses, walls, last = [], [], {}
    for i in range(steps):
        if comm is not None:
            comm.reset_collective_counts()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        if comm is not None:
            last = comm.collective_counts()
        if after_step is not None:
            after_step(i)
    return losses, walls, {n: c.launches for n, c in counters.items()}, last


def _tp_train_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel.tensor_parallel import shard_tensor
    tp = groups.axis("model")
    counters = _flash_counters()
    torch.cuda.reset_peak_memory_stats()
    model = _tp_350m(torch, 0.0, groups)
    engine, _, _, _ = initialize(model=model, config=_tp_config(
        {"model": TP_WORLD}), mpu=groups)
    batch = _train_batch_350m()
    digests = {}

    def after_step(i):
        # the unrolled masters after train_tp_scan's steps
        if spec.get("scan") and i == TP_SCAN_STEPS - 1:
            digests.update(_tp_unrolled_digests(torch, engine))

    losses, walls, launches, counts = _tp_train_run(
        torch, engine, batch, TP_WARMUP + TP_STEPS, counters, C, after_step)
    routes = {n: dict(c.routes) for n, c in counters.items()
              if hasattr(c, "routes")}
    peak = torch.cuda.max_memory_allocated()
    staged = sorted(C.STAGED)
    # the masters against the model-1 run's (split leaves summed over the
    # group, a replicated leaf counted on rank 0)
    ref = torch.load(spec["ref_masters"])
    specs = engine._tp_specs
    sq = torch.zeros(2, dtype=torch.float64, device="cuda")
    for name, p, s in zip(engine._param_names(), engine.params, specs):
        if s is None and tp.rank != 0:
            continue
        want = shard_tensor(ref[name], s, tp.rank, tp.size).cuda()
        sq[0] += (p.detach().double() - want.double()).square().sum()
        sq[1] += want.double().square().sum()
    del ref
    C.all_reduce(sq, tp)
    heads = engine.module.h[0].attn.c_attn.weight.shape[0] // 3 // TRAIN_D
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    scan = _tp_scan_runs(torch, groups, batch, counters, losses, digests) \
        if spec.get("scan") else None
    # one step at dropout 0.1: the K1 calls' dropout coordinates
    calls, restore = _recorded_k1_calls(fa)
    try:
        model = _tp_350m(torch, 0.1, groups)
        engine, _, _, _ = initialize(model=model, config=_tp_config(
            {"model": TP_WORLD}), mpu=groups)
        drop_loss = float(engine.train_batch(batch))
    finally:
        restore()
    del engine, model
    torch.cuda.empty_cache()
    return {"rank": rank, "losses": losses, "walls": walls,
            "launches": launches, "routes": routes, "peak": peak,
            "collectives_last_step": counts, "staged": staged,
            "master_rel_l2": float((sq[0] / sq[1]).sqrt()),
            "local_heads": heads, "dropout_loss": drop_loss,
            "dropout_calls": calls, "scan": scan}


def _k1_mask(torch, fa, h, seed, offset, heads, rate=0.1):
    """K1's dropout keep-mask at these coordinates, read back (q = k = 0,
    v = I; bf16 on the tensor-core route: its zeros are the drops)."""
    b, t, s = 2, 128, 64
    q = torch.zeros((b, t, h, s), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((b, s, h, s), device="cuda", dtype=torch.bfloat16)
    v = torch.eye(s, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :].expand(b, s, h, s).contiguous()
    out, _ = fa.flash_attention_fwd(
        q, k, v, causal=False, dropout_rate=rate, dropout_seed=seed,
        dropout_head_offset=offset, dropout_num_heads=heads)
    return out.permute(0, 2, 1, 3) != 0


def phase_train_tp(torch):
    """GPT-2 350M at model 2: two processes on ``cuda:0`` over gloo
    (module docstring, phase 21)."""
    import tempfile
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import flash_attention as fa
    counters = _flash_counters()
    batch = _train_batch_350m()
    # the model-1 run: the reference losses and masters
    engine, _, _, _ = initialize(model=_tp_350m(torch, 0.0),
                                 config=_tp_config())
    ref_losses, ref_walls, _, _ = _tp_train_run(
        torch, engine, batch, TP_WARMUP + TP_STEPS, counters)
    tmp = tempfile.mkdtemp(prefix="tp_ref_")
    ref_path = os.path.join(tmp, "masters.pt")
    torch.save({n: p.detach().float().cpu() for n, p in
                zip(engine._param_names(), engine.params)}, ref_path)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    calls1, restore = _recorded_k1_calls(fa)
    try:
        engine, _, _, _ = initialize(model=_tp_350m(torch, 0.1),
                                     config=_tp_config())
        ref_drop_loss = float(engine.train_batch(batch))
    finally:
        restore()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_tp(torch, "train_tp", {"mesh": {"model": TP_WORLD},
                                             "ref_masters": ref_path,
                                             "scan": True})
    os.remove(ref_path)
    # the masks: each rank's K1 calls at its heads' coordinates against
    # the model-1 call's heads, read back from K1 at the recorded seeds
    masks_equal = True
    for r, res in enumerate(ranks):
        calls = res["dropout_calls"]
        if len(calls) != len(calls1):
            masks_equal = False
            continue
        for i, (got, want) in enumerate(zip(calls, calls1)):
            Bq, Hq, Tq, seed, off, heads = got
            if seed != want[3] or heads != TRAIN_H or Hq != TP_HEADS or \
                    off != want[4] + r * TP_HEADS:
                masks_equal = False
                continue
            if i < 2:       # the kernel's masks at these coordinates
                mine = _k1_mask(torch, fa, Hq, seed, off, heads)
                full = _k1_mask(torch, fa, TRAIN_H, want[3], want[4],
                                TRAIN_H)
                masks_equal = masks_equal and bool(torch.equal(
                    mine, full[:, r * TP_HEADS:(r + 1) * TP_HEADS]))
    steps = TP_WARMUP + TP_STEPS
    timed = [max(r["walls"][i] for r in ranks)
             for i in range(TP_WARMUP, steps)]
    tokens = TRAIN_B * TRAIN_T
    row = {"phase": "train_tp", "model": "gpt2_350m", "mesh": {
        "model": TP_WORLD}, "processes": TP_WORLD, "device": "cuda:0",
        "backend": "gloo (CUDA tensors, one device)",
        "model1_losses": ref_losses, "losses": ranks[0]["losses"],
        "losses_by_rank_equal": all(r["losses"] == ranks[0]["losses"]
                                    for r in ranks),
        "first_loss_rtol": TP_LOSS_RTOL,
        "master_rel_l2": ranks[0]["master_rel_l2"],
        "master_rel_l2_limit": TP_MASTER_REL_L2,
        "step_p50_ms": statistics.median(timed) * 1e3,
        "model1_step_p50_ms": statistics.median(
            ref_walls[TP_WARMUP:]) * 1e3,
        "tokens_per_s": tokens * len(timed) / sum(timed),
        "peak_memory_by_rank": [r["peak"] for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "routes_by_rank": [r["routes"] for r in ranks],
        "local_heads": [r["local_heads"] for r in ranks],
        "collectives_a_step": ranks[0]["collectives_last_step"],
        "staged_through_host": ranks[0]["staged"],
        "dropout_loss_model1": ref_drop_loss,
        "dropout_loss": ranks[0]["dropout_loss"],
        "dropout_calls": len(calls1),
        "dropout_masks_equal_model1": masks_equal}
    emit(row)
    if not all(np.isfinite(row["losses"])) or not row["losses_by_rank_equal"]:
        fail(f"train_tp losses not finite or not the same on every rank: "
             f"{[r['losses'] for r in ranks]}")
    if not abs(row["losses"][0] - ref_losses[0]) <= \
            TP_LOSS_RTOL * abs(ref_losses[0]):
        fail(f"train_tp first loss {row['losses'][0]} vs model 1 "
             f"{ref_losses[0]}: beyond rtol {TP_LOSS_RTOL}")
    if not row["master_rel_l2"] <= TP_MASTER_REL_L2:
        fail(f"train_tp masters after {steps} steps differ from model 1's "
             f"by {row['master_rel_l2']} (relative L2) > {TP_MASTER_REL_L2}")
    want = {"K1": TP_LAYERS * steps, "K2": TP_LAYERS * steps,
            "K3": TP_LAYERS * steps, "K4": steps}
    if any(r["launches"] != want for r in ranks) or \
            any(h != TP_HEADS for h in row["local_heads"]):
        fail(f"train_tp launches {row['launches_by_rank']} != {want} a rank "
             f"or local heads {row['local_heads']} != {TP_HEADS}")
    if not masks_equal or len(calls1) != TP_LAYERS:
        fail("train_tp at dropout 0.1: a rank's attention masks differ from "
             "the model-1 run's at its heads")
    row["tp_scan"] = _tp_scan_row(torch, ranks, ref_losses,
                                  row["model1_step_p50_ms"])
    return row


def _tp_serve_engine(torch, kv, layout, dtype, mpu=None, scan=False):
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2LMHead, gpt2_125m, with_layout)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = GPT2LMHead(gpt2_125m(dtype=dtype), device="cuda", generator=gen,
                       mpu=mpu)
    if scan:            # the same weights stacked, a stacked cache
        model = with_layout(model, True)
    extra = {"kv_layout": "paged"} if layout == "paged" else {}
    return InferenceEngine(model, device="cuda", config={
        "max_batch": B, "seq_buckets": (128, 512), "prefill_chunk": 64,
        "kv_cache_dtype": kv, "attention_impl": "flash", **extra})


def _tp_serve_requests(Request, n, vocab=50257):
    rng = np.random.default_rng(0)
    return [Request(f"r{i}", rng.integers(0, vocab,
                                          int(rng.integers(8, 120))).tolist(),
                    max_new_tokens=32, arrival_step=i) for i in range(n)]


def _tp_serve_run(torch, kv, layout, dtype, n, mpu=None, scan=False):
    """``n`` of the serve row's requests through one engine: greedy tokens,
    decode steps, the decode kernels' launches, the step wall, and the
    teacher-forced logits of ``_teacher_forced_diff``'s prompts."""
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler, Request)
    k5, k6 = _decode_counters()
    engine = _tp_serve_engine(torch, kv, layout, dtype, mpu, scan)
    sched = ContinuousBatchingScheduler(engine)
    sched.run([Request("warmup", [1, 2, 3, 4, 5, 6, 7, 8],
                       max_new_tokens=4)])
    k5.launches = k6.launches = 0
    t0 = time.perf_counter()
    done = sched.run(_tp_serve_requests(Request, n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = {c.rid: list(map(int, c.tokens)) for c in done}
    out = {"tokens": tokens, "wall_s": wall,
           "generated": sum(len(t) for t in tokens.values()),
           "k5": k5.launches, "k6": k6.launches,
           "counts": engine.compile_counts(),
           "cache_heads": engine.spec.n_head,
           "peak": torch.cuda.max_memory_allocated()}
    engine.reset()
    rng = np.random.default_rng(2)
    lens = rng.integers(8, 150, B)
    prompts = [rng.integers(0, 50257, k).tolist() for k in lens]
    steps = rng.integers(0, 50257, (4, B)).astype(np.int32)
    if layout == "paged":
        engine = _tp_serve_engine(torch, kv, layout, dtype, mpu, scan)
    out["forced"] = _forced_logits(engine, prompts, steps)
    del engine, sched
    torch.cuda.empty_cache()
    return out


def _tp_serve_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch.parallel import collectives as C
    out = {}
    for name, kv, layout, dtype, n in spec["runs"]:
        C.reset_collective_counts()
        # every rank runs every program (their collectives pair up);
        # rank 0 keeps the logits
        res = _tp_serve_run(torch, kv, layout, getattr(torch, dtype), n,
                            groups)
        forced = res.pop("forced")
        if rank == 0:
            np.save(os.path.join(spec["out"], f"{name}.npy"), forced)
        res["collectives"] = C.collective_counts()
        res["staged"] = sorted(C.STAGED)
        out[name] = res
    for name, kv, layout, dtype, n in spec.get("scan_runs", ()):
        C.reset_collective_counts()
        res = _tp_serve_run(torch, kv, layout, getattr(torch, dtype), n,
                            groups, scan=True)
        res.pop("forced")
        res["collectives"] = C.collective_counts()
        res["staged"] = sorted(C.STAGED)
        out[name] = res
    return out


# the f32 streams (the bitwise gate) take the first 8 requests, as the
# serve phases' f32 stream checks do; bf16 and int8 the serve row's first
# 12 (of 24: cut to keep the script within its time)
TP_SERVE_RUNS = [("f32_ring", None, "ring", "float32", 8),
                 ("f32_paged", None, "paged", "float32", 8),
                 ("bf16_ring", "bf16", "ring", "bfloat16", 12),
                 ("int8_paged", "int8", "paged", "bfloat16", 12)]
# serve_tp_scan: the f32 streams of the stacked model (its f32 run's twin)
TP_SERVE_SCAN_RUNS = [("f32_ring_scan", None, "ring", "float32", 8),
                      ("f32_paged_scan", None, "paged", "float32", 8)]


def phase_serve_tp(torch):
    """GPT-2 125M served at model 2 (module docstring, phase 22)."""
    ref = {name: _tp_serve_run(torch, kv, layout, getattr(torch, dtype), n)
           for name, kv, layout, dtype, n in TP_SERVE_RUNS}
    ranks, tmp = _spawn_tp(torch, "serve_tp", {
        "mesh": {"model": TP_WORLD}, "runs": TP_SERVE_RUNS,
        "scan_runs": TP_SERVE_SCAN_RUNS})
    row = {"phase": "serve_tp", "model": "gpt2_125m",
           "mesh": {"model": TP_WORLD}, "processes": TP_WORLD,
           "device": "cuda:0", "runs": {}}
    ok = True
    for name, kv, layout, dtype, n in TP_SERVE_RUNS:
        mine = [r[name] for r in ranks]
        forced = np.load(os.path.join(tmp, f"{name}.npy"))
        diff = float(np.abs(forced - ref[name]["forced"]).max())
        scale = float(np.abs(ref[name]["forced"]).max())
        kernel = "k6" if layout == "paged" else "k5"
        other = "k5" if layout == "paged" else "k6"
        steps1 = ref[name][kernel] / N_LAYER
        r = {"kv_cache_dtype": kv, "layout": layout, "dtype": dtype,
             "requests": n,
             "streams_equal_model1": all(m["tokens"] == ref[name]["tokens"]
                                         for m in mine),
             "streams_equal_across_ranks": all(
                 m["tokens"] == mine[0]["tokens"] for m in mine),
             "teacher_forced_max_abs_diff": diff,
             "teacher_forced_logit_scale": scale,
             "tokens_per_s": mine[0]["generated"] / max(
                 m["wall_s"] for m in mine),
             "model1_tokens_per_s": ref[name]["generated"] /
             ref[name]["wall_s"],
             "decode_launches_by_rank": [m[kernel] for m in mine],
             "model1_decode_launches": ref[name][kernel],
             "other_kernel_launches": [m[other] for m in mine],
             "cache_heads": [m["cache_heads"] for m in mine],
             "compile_counts": [m["counts"] for m in mine],
             "peak_memory_by_rank": [m["peak"] for m in mine],
             "collectives": mine[0]["collectives"]}
        row["runs"][name] = r
        good = r["streams_equal_across_ranks"] and \
            all(h == 6 for h in r["cache_heads"]) and \
            all(c == {"prefill": 1, "decode": 1}
                for c in r["compile_counts"]) and \
            not any(r["other_kernel_launches"]) and \
            all(n > 0 and n % N_LAYER == 0
                for n in r["decode_launches_by_rank"]) and steps1 > 0
        if dtype == "float32":
            good = good and r["streams_equal_model1"] and \
                diff <= TEACHER_FORCED_ATOL
        else:
            good = good and diff <= TEACHER_FORCED_ATOL
        ok = ok and good
        r["ok"] = good
    row["staged_through_host"] = sorted({k for m in ranks for r in m.values()
                                         for k in r["staged"]})
    emit(row)
    if not ok:
        fail(f"serve_tp: a gate failed ({[(n, r['ok']) for n, r in row['runs'].items()]})")
    row["tp_scan"] = _serve_tp_scan_row(ranks, ref)
    return row


def _serve_tp_scan_row(ranks, ref):
    """serve_tp_scan: the stacked model's f32 greedy streams at model 2
    against the unrolled model's at model 2 and at model 1."""
    row = {"phase": "serve_tp_scan", "model": "gpt2_125m",
           "mesh": {"model": TP_WORLD}, "processes": TP_WORLD,
           "device": "cuda:0", "world": "serve_tp's", "runs": {}}
    ok = True
    for name, kv, layout, dtype, n in TP_SERVE_SCAN_RUNS:
        base = name[:-len("_scan")]
        mine = [r[name] for r in ranks]
        kernel = "k6" if layout == "paged" else "k5"
        other = "k5" if layout == "paged" else "k6"
        r = {"layout": layout, "dtype": dtype, "requests": n,
             "streams_equal_unrolled_model2": all(
                 m["tokens"] == u[base]["tokens"]
                 for m, u in zip(mine, ranks)),
             "streams_equal_model1": all(m["tokens"] == ref[base]["tokens"]
                                         for m in mine),
             "decode_launches_by_rank": [m[kernel] for m in mine],
             "unrolled_decode_launches_by_rank": [u[base][kernel]
                                                  for u in ranks],
             "other_kernel_launches": [m[other] for m in mine],
             "cache_heads": [m["cache_heads"] for m in mine],
             "compile_counts": [m["counts"] for m in mine],
             "tokens_per_s": mine[0]["generated"] / max(
                 m["wall_s"] for m in mine)}
        r["ok"] = r["streams_equal_unrolled_model2"] and \
            r["streams_equal_model1"] and \
            r["decode_launches_by_rank"] == \
            r["unrolled_decode_launches_by_rank"] and \
            all(x > 0 for x in r["decode_launches_by_rank"]) and \
            not any(r["other_kernel_launches"]) and \
            all(h == 6 for h in r["cache_heads"]) and \
            all(c == {"prefill": 1, "decode": 1}
                for c in r["compile_counts"])
        ok = ok and r["ok"]
        row["runs"][name] = r
    emit(row)
    if not ok:
        fail(f"serve_tp_scan: a gate failed "
             f"({[(n, r['ok']) for n, r in row['runs'].items()]})")
    return row


def _pipe_tp_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel.pipe_tp import tp_pipeline_module
    counters = _flash_counters()
    out = {}
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(
        0, PIPE_TP_VOCAB, (PIPE_TP_ROWS, PIPE_TP_T)).astype(np.int64))}
    for name, overlap in spec["runs"]:
        module = tp_pipeline_module(PIPE_TP_VOCAB, PIPE_TP_D, PIPE_TP_H,
                                    PIPE_TP_T, n_blocks=PIPE_TP_BLOCKS,
                                    num_stages=2, use_flash=True)
        cfg = {"train_batch_size": PIPE_TP_ROWS,
               "gradient_accumulation_steps": PIPE_TP_MICRO,
               "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
               "steps_per_print": 10 ** 9,
               "mesh": {"pipe": 2, "model": TP_WORLD},
               "tensor_parallel": {"overlap": overlap}}
        engine, _, _, _ = initialize(model=module, config=cfg, mpu=groups)
        for c in counters.values():
            c.launches = 0
        losses, walls, counts = [], [], {}
        for _ in range(PIPE_TP_STEPS):
            C.reset_collective_counts()
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            walls.append(time.perf_counter() - t0)
            counts = C.collective_counts()
        out[name] = {"losses": losses, "walls": walls,
                     "launches": {n: c.launches
                                  for n, c in counters.items()},
                     "collectives": counts, "staged": sorted(C.STAGED),
                     "peak": torch.cuda.max_memory_allocated()}
        del engine, module
        torch.cuda.empty_cache()
    return out


PIPE_TP_RUNS = [("off", {"enabled": False}),
                ("chunks4", {"enabled": True, "chunks": 4}),
                ("chunks1", {"enabled": True, "chunks": 1})]


def phase_train_pipe_tp(torch):
    """The collective-matmul row: pipe 2 x model 2 (module docstring,
    phase 23)."""
    ranks, _ = _spawn_tp(torch, "train_pipe_tp", {
        "mesh": {"pipe": 2, "model": TP_WORLD}, "in_process_pipe": True,
        "runs": PIPE_TP_RUNS})
    res = ranks[0]
    tokens = PIPE_TP_ROWS * PIPE_TP_T
    runs = {}
    for name, _ in PIPE_TP_RUNS:
        timed = [max(r[name]["walls"][i] for r in ranks)
                 for i in range(1, PIPE_TP_STEPS)]
        runs[name] = {"losses": res[name]["losses"],
                      "step_p50_ms": statistics.median(timed) * 1e3,
                      "tokens_per_s": tokens * len(timed) / sum(timed),
                      "launches": res[name]["launches"],
                      "collectives_a_step": res[name]["collectives"],
                      "staged_through_host": res[name]["staged"],
                      "peak_memory_by_rank": [r[name]["peak"]
                                              for r in ranks]}
    off, c4, c1 = (runs[n]["losses"] for n in ("off", "chunks4", "chunks1"))
    gap = max(abs(a - b) / abs(b) for a, b in zip(c4, off))
    row = {"phase": "train_pipe_tp", "model": "tp_pipeline_module",
           "vocab": PIPE_TP_VOCAB, "d_model": PIPE_TP_D,
           "n_head": PIPE_TP_H, "blocks": PIPE_TP_BLOCKS, "stages": 2,
           "mesh": {"pipe": 2, "model": TP_WORLD}, "rows": PIPE_TP_ROWS,
           "seq": PIPE_TP_T, "micro_batches": PIPE_TP_MICRO,
           "dtype": "float32", "runs": runs,
           "chunks4_vs_off_max_rel": gap, "loss_rtol": PIPE_TP_LOSS_RTOL,
           "chunks1_bitwise_off": c1 == off,
           "ranks_agree": all(r[n]["losses"] == res[n]["losses"]
                              for r in ranks for n, _ in PIPE_TP_RUNS)}
    emit(row)
    per_step = PIPE_TP_BLOCKS * PIPE_TP_MICRO * PIPE_TP_STEPS
    want = {"K1": per_step, "K2": per_step, "K3": per_step,
            "K4": 2 * PIPE_TP_STEPS}
    if not all(np.isfinite(off)) or not row["ranks_agree"]:
        fail(f"train_pipe_tp losses not finite or not equal on the ranks")
    if not gap <= PIPE_TP_LOSS_RTOL or not row["chunks1_bitwise_off"]:
        fail(f"train_pipe_tp: overlap chunks 4 vs off {gap} > "
             f"{PIPE_TP_LOSS_RTOL}, or chunks 1 not bitwise off")
    if any(r[n]["launches"] != want for r in ranks for n, _ in PIPE_TP_RUNS):
        fail(f"train_pipe_tp launches {[r['off']['launches'] for r in ranks]}"
             f" != {want}")
    if not runs["chunks4"]["collectives_a_step"].get("ppermute"):
        fail("train_pipe_tp: the chunks-4 plan issued no ring")
    return row


def _pipe_zero_engine(torch, zero):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import gpt2_350m
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
    cfg = gpt2_350m(n_positions=TRAIN_T, dropout=0.0,
                    use_flash_attention=True, loss_chunk=0)
    config = {"train_batch_size": PIPE_ROWS,
              "gradient_accumulation_steps": PIPE_MICRO,
              "optimizer": {"type": "Adam", "params": {"lr": PIPE_LR}},
              "mesh": {"pipe": PIPE_STAGES}, "steps_per_print": 10 ** 9,
              "bf16": {"enabled": True}}
    if zero:
        config["zero_optimization"] = zero
    engine, _, _, _ = initialize(
        model=gpt2_pipeline_module(cfg, seq_len=TRAIN_T), config=config)
    return engine


def _pipe_zero_run(torch, zero, counters):
    torch.cuda.reset_peak_memory_stats()
    engine = _pipe_zero_engine(torch, zero)
    batch = _pipe_batch(PIPE_ROWS)
    for c in counters.values():
        c.launches = 0
    losses, walls = [], []
    for _ in range(PIPE_ZERO_WARMUP + PIPE_ZERO_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {"losses": losses,
           "step_p50_ms": statistics.median(walls[PIPE_ZERO_WARMUP:]) * 1e3,
           "launches": {n: c.launches for n, c in counters.items()},
           "peak": torch.cuda.max_memory_allocated(),
           "masters": {n: t.cpu() for n, t in engine.pipe_state().items()}}
    if engine._stage_offload:
        out["device_equals_bf16_masters"] = all(
            torch.equal(p.data, m.to(torch.bfloat16).to(p.device))
            for se in engine.stage_engines
            for p, m in zip(se.params, se.cpu_optimizer.params()))
        out["host_phase_s"] = [se.last_host_phase_s
                               for se in engine.stage_engines]
    else:
        inst = engine.stage_engines[0]._installer
        out["regathers"] = inst.regathers if inst is not None and \
            inst.gather else 0
        out["max_in_flight"] = dict(engine.executor.max_in_flight)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_pipe_zero(torch):
    """The ``train_pipe`` row at ZeRO stage 3 and under ZeRO-Offload
    (module docstring, phase 24)."""
    counters = _flash_counters()
    s0 = _pipe_zero_run(torch, None, counters)
    s3 = _pipe_zero_run(torch, {"stage": 3}, counters)
    off = _pipe_zero_run(torch, {"stage": 2, "cpu_offload": True}, counters)
    bitwise = s3["losses"] == s0["losses"] and all(
        torch.equal(s3["masters"][n], s0["masters"][n]) for n in s0["masters"])
    repeat = None
    if not bitwise:       # does stage 0 repeat itself bit for bit?
        again = _pipe_zero_run(torch, None, counters)
        repeat = again["losses"] == s0["losses"]
    steps = PIPE_ZERO_WARMUP + PIPE_ZERO_STEPS
    off_gap = max(abs(a - b) for a, b in zip(off["losses"], s0["losses"]))
    row = {"phase": "train_pipe_zero", "model": "gpt2_350m",
           "stages": PIPE_STAGES, "micro_batches": PIPE_MICRO,
           "rows": PIPE_ROWS, "dtype": "bfloat16",
           "stage0": {k: v for k, v in s0.items() if k != "masters"},
           "stage3": {k: v for k, v in s3.items() if k != "masters"},
           "offload": {k: v for k, v in off.items() if k != "masters"},
           "stage3_equals_stage0_bitwise": bitwise,
           "stage0_repeats_bitwise": repeat,
           "offload_vs_stage0_max_loss_gap": off_gap,
           "loss_atol": TRAIN_LOSS_ATOL}
    emit(row)
    want = {"K1": TRAIN_LAYERS * PIPE_MICRO * steps,
            "K2": TRAIN_LAYERS * PIPE_MICRO * steps,
            "K3": TRAIN_LAYERS * PIPE_MICRO * steps,
            "K4": PIPE_STAGES * steps}
    if s0["launches"] != want or s3["launches"] != want or \
            off["launches"] != dict(want, K4=0):
        fail(f"train_pipe_zero launches {s0['launches']}, "
             f"{s3['launches']}, {off['launches']} != {want} (offload: K4 0)")
    if not bitwise and (repeat or any(
            abs(a - b) > TRAIN_LOSS_ATOL
            for a, b in zip(s3["losses"], s0["losses"]))):
        fail(f"train_pipe_zero: stage 3 {s3['losses']} != stage 0 "
             f"{s0['losses']} bit for bit")
    if not s3["regathers"] or s3["max_in_flight"].get(0) != PIPE_STAGES:
        fail(f"train_pipe_zero: stage 3 regathered {s3['regathers']} "
             f"leaves with {s3['max_in_flight']} micro-batches in flight")
    if not off["device_equals_bf16_masters"] or not off_gap <= \
            TRAIN_LOSS_ATOL or not all(np.isfinite(off["losses"])):
        fail(f"train_pipe_zero offload: device params == bf16(masters) "
             f"{off['device_equals_bf16_masters']}, loss gap {off_gap}")
    return row


# ---------------------------------------------------------------------------
# sequence and expert parallelism on one card (phases 25-28)
# ---------------------------------------------------------------------------

SEQ_B, SEQ_T, SEQ_H, SEQ_D = 2, 8192, 16, 64
SEQ_WORLD = 2                      # seq ranks on cuda:0
SEQ_RATE, SEQ_SEED = 0.1, 1234
SEQ_REL_TOL = 1e-2                 # bf16 ring vs dense f32: max|d| / max|ref|
SEQ_REPS = 3
SP_VOCAB, SP_D, SP_H, SP_T, SP_BLOCKS = 50257, 1024, 16, 1024, 4
SP_ROWS, SP_MICRO, SP_LR = 8, 4, 1e-4
SP_WARMUP, SP_STEPS = 2, 3
SP_LOSS_RTOL, SP_GRAD_RTOL, SP_GRAD_ATOL = 1e-5, 3e-4, 1e-6   # JAX's
SP_BF16_LOSS_ATOL = 5e-3           # bf16 seq 2 vs bf16 seq 1, every step
MOE_WARMUP, MOE_STEPS = 2, 3
# expert 2 against expert 1, bf16 (phase 27): each limit lies between
# the sound run's reading and the planted faults' (--moe-faults) on one
# H100 80GB HBM3 at 700 W; comments: sound / aux, bank, scale ("=": the
# sound reading)
MOE_LIMITS = {
    "first_loss_rel": 1e-4,                 # 5.4e-6 / =, =, =
    "grad_norm_rel": 1.4e-2,                # 9.1e-3 / 1.87, 3.7e-3, 2.0e-2
    "first_grad_norm_rel/gate": 1e-2,       # 9.6e-5 / 0.995, =, =
    "first_grad_norm_rel/expert": 1e-2,     # 3.1e-4 / 0.53, 0.13, 0.59
    "first_grad_norm_rel/other": 1e-2,      # 1.7e-4 / 0.64, =, =
    "gate_grad_rel_l2": 0.1,                # 1.1e-2 / 0.998, =, =
    "update_rel_l2/gate": 0.1,              # 0.067 / 0.42, 0.12, 0.071
    "update_rel_l2/expert": 0.4,            # 0.26 / 0.61, 0.56, 0.27
    "update_rel_l2/other": 0.15}            # 0.075 / 0.50, 0.10, 0.076
MOE_ROUTE_GAP = 0.005              # later MoE layers: routed tokens apart
# planted in expert 2's ranks: the aux loss's gradient not pre-scaled by
# 1/ep; rank 1's expert_w1 banks left unchanged (zero gradients); rank
# 1's expert gradients doubled
MOE_FAULTS = ("aux", "bank", "scale")
PTM_VOCAB, PTM_D, PTM_H, PTM_BLOCKS = 32000, 1024, 16, 4
PTM_ROWS, PTM_T, PTM_MICRO, PTM_STEPS = 8, 512, 4, 2
PTM_WORLD = 4                      # model 2 x expert 2 processes on cuda:0
PTM_LOSS_RTOL, PTM_GRAD_RTOL, PTM_GRAD_ATOL = 1e-5, 3e-4, 1e-6  # JAX's
PTM_OVERLAP_RTOL = 1e-5            # expert_combine chunks 4 vs off


def _rel_err(got, want):
    """max |got - want| / max |want| (f32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _allclose_share(got, want, rtol, atol):
    """The share of elements outside ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    bad = (got - want).abs() > atol + rtol * want.abs()
    return float(bad.float().mean())


def _seq_inputs(torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return [torch.randn((SEQ_B, SEQ_T, SEQ_H, SEQ_D), generator=gen,
                        device="cuda").to(torch.bfloat16)
            for _ in range(4)]


def _seq_references(torch, path):
    """The dense f32 attention of the whole sequence (per head, so the
    scores fit), plain and at the ring's dropout (its hash coordinates),
    and K1-K3 on all 16 heads: outputs and the gradients of ``sum(out *
    w)``, saved for the ranks."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, w = _seq_inputs(torch)
    refs = {}
    for tag, rate in (("dense", 0.0), ("dense_drop", SEQ_RATE)):
        parts = {n: [] for n in ("out", "dq", "dk", "dv")}
        for h in range(SEQ_H):
            xs = [t[:, :, h:h + 1].float().requires_grad_(True)
                  for t in (q, k, v)]
            o = fa.dense_attention(*xs, causal=True, dropout_rate=rate,
                                   dropout_seed=SEQ_SEED,
                                   dropout_head_offset=h,
                                   dropout_num_heads=SEQ_H)
            grads = torch.autograd.grad(o, xs, w[:, :, h:h + 1].float())
            for n, t in zip(parts, (o.detach(),) + tuple(grads)):
                parts[n].append(t)
        for n, ts in parts.items():
            refs[f"{tag}/{n}"] = torch.cat(ts, dim=2).cpu()
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*xs, causal=True)
    o.backward(w)
    for n, t in zip(("out", "dq", "dk", "dv"),
                    (o.detach(),) + tuple(x.grad for x in xs)):
        refs[f"flash/{n}"] = t.cpu()
    torch.save(refs, path)


def _seq_attention_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, fold_in_seed)
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel import sequence as sp
    seq = groups.axis("seq")
    q, k, v, w = _seq_inputs(torch)
    t = SEQ_T // seq.size
    sl = slice(seq.rank * t, (seq.rank + 1) * t)
    refs = torch.load(spec["refs"])
    counters = _flash_counters()
    calls = []

    def flash(qq, *a, **kw):
        calls.append([int(qq.shape[2]), kw.get("dropout_seed")])
        return flash_attention(qq, *a, **kw)

    def run(fn, backward=True, **kw):
        xs = [x[:, sl].contiguous().requires_grad_(True) for x in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*xs, seq, causal=True, **kw)
        if backward:
            o.backward(w[:, sl].contiguous())
        torch.cuda.synchronize()
        return o.detach(), [x.grad for x in xs], time.perf_counter() - t0

    def errors(out, grads, tag):
        return {n: _rel_err(got, refs[f"{tag}/{n}"][:, sl].cuda())
                for n, got in zip(("out", "dq", "dk", "dv"),
                                  [out] + grads)}

    res = {"rank": rank}
    torch.cuda.reset_peak_memory_stats()
    for name, fn, kw, tag in (
            ("ring", sp.ring_attention_local, {}, "dense"),
            ("ring_dropout", sp.ring_attention_local,
             {"dropout_rate": SEQ_RATE, "dropout_seed": SEQ_SEED},
             "dense_drop"),
            ("ulysses", sp.ulysses_attention_local, {"attn_fn": flash},
             "flash")):
        walls, counts = [], {}
        for c in counters.values():
            c.launches = 0
        for _ in range(SEQ_REPS):
            C.reset_collective_counts()
            out, grads, wall = run(fn, **kw)
            walls.append(wall)
            counts = C.collective_counts()
        res[name] = {"rel_err": errors(out, grads, tag),
                     "ms": statistics.median(walls) * 1e3,
                     "launches": {n: c.launches
                                  for n, c in counters.items()},
                     "collectives_a_call": counts}
        if name == "ulysses":
            res[name]["bitwise_k1_16_heads"] = all(
                torch.equal(got, refs[f"flash/{n}"][:, sl].cuda())
                for n, got in zip(("out", "dq", "dk", "dv"),
                                  [out] + grads))
        del out, grads
    res["ulysses_local_heads"] = sorted({c[0] for c in calls})
    calls.clear()
    run(sp.ulysses_attention_local, backward=False, attn_fn=flash,
        dropout_rate=SEQ_RATE, dropout_seed=SEQ_SEED)
    res["ulysses_dropout_seeds"] = [c[1] for c in calls]
    res["ulysses_dropout_seeds_want"] = [fold_in_seed(SEQ_SEED, seq.rank)]
    res["peak"] = torch.cuda.max_memory_allocated()
    res["staged"] = sorted(C.STAGED)
    return res


def phase_seq_attention(torch):
    """Ring and Ulysses at seq 2 on ``cuda:0`` (module docstring, phase
    25)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="seq_ref_")
    refs = os.path.join(tmp, "refs.pt")
    _seq_references(torch, refs)
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_tp(torch, "seq_attention",
                         {"mesh": {"seq": SEQ_WORLD}, "refs": refs},
                         world=SEQ_WORLD)
    os.remove(refs)
    row = {"phase": "seq_attention", "shape": [SEQ_B, SEQ_T, SEQ_H, SEQ_D],
           "dtype": "bfloat16", "causal": True, "mesh": {"seq": SEQ_WORLD},
           "processes": SEQ_WORLD, "device": "cuda:0",
           "backend": "gloo (CUDA tensors, one device)",
           "rel_tol": SEQ_REL_TOL, "dropout": SEQ_RATE, "seed": SEQ_SEED}
    for name in ("ring", "ring_dropout", "ulysses"):
        row[name] = {
            "rel_err_by_rank": [r[name]["rel_err"] for r in ranks],
            "ms_by_rank": [r[name]["ms"] for r in ranks],
            "tokens_per_s": SEQ_B * SEQ_T * 1e3 / max(
                r[name]["ms"] for r in ranks),
            "launches_by_rank": [r[name]["launches"] for r in ranks],
            "collectives_a_call": ranks[0][name]["collectives_a_call"]}
    row["ulysses"]["bitwise_k1_16_heads"] = [
        r["ulysses"]["bitwise_k1_16_heads"] for r in ranks]
    row["ulysses_local_heads"] = [r["ulysses_local_heads"] for r in ranks]
    row["ulysses_dropout_seeds"] = [r["ulysses_dropout_seeds"]
                                    for r in ranks]
    row["peak_memory_by_rank"] = [r["peak"] for r in ranks]
    row["staged_through_host"] = ranks[0]["staged"]
    emit(row)
    worst = max(e for n in ("ring", "ring_dropout", "ulysses")
                for r in ranks for e in r[n]["rel_err"].values())
    if not worst <= SEQ_REL_TOL:
        fail(f"seq_attention: a rank's output or gradient is {worst} "
             f"(max |diff| / max |ref|) from its reference > {SEQ_REL_TOL}")
    want = {"K1": SEQ_REPS, "K2": SEQ_REPS, "K3": SEQ_REPS, "K4": 0}
    if any(r["ulysses"]["launches"] != want for r in ranks) or \
            any(h != [SEQ_H // SEQ_WORLD] for h in row["ulysses_local_heads"]):
        fail(f"seq_attention: Ulysses launches {row['ulysses']} != {want} "
             f"or local heads {row['ulysses_local_heads']}")
    if not all(row["ulysses"]["bitwise_k1_16_heads"]):
        fail(f"seq_attention: Ulysses is not K1-K3 on 16 heads bit for bit "
             f"({row['ulysses']['bitwise_k1_16_heads']} by rank)")
    if any(r["ring"]["launches"]["K1"] for r in ranks):
        fail("seq_attention: the ring launched an attention kernel")
    if any(r["ulysses_dropout_seeds"] != r["ulysses_dropout_seeds_want"]
           for r in ranks):
        fail(f"seq_attention: Ulysses' K1 seeds {row['ulysses_dropout_seeds']}"
             f" are not fold_in_seed({SEQ_SEED}, seq rank)")
    return row


def _sp_engine(torch, dtype, mpu=None):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.parallel.pipe_sp import sp_pipeline_module
    cfg = {"train_batch_size": SP_ROWS,
           "gradient_accumulation_steps": SP_MICRO,
           "optimizer": {"type": "Adam", "params": {"lr": SP_LR}},
           "steps_per_print": 10 ** 9,
           "mesh": {"pipe": 2, "seq": mpu.axis("seq").size if mpu else 1}}
    if dtype == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    engine, _, _, _ = initialize(
        model=sp_pipeline_module(SP_VOCAB, SP_D, SP_H, SP_T,
                                 n_blocks=SP_BLOCKS, num_stages=2),
        config=cfg, mpu=mpu)
    return engine


def _sp_batch(torch):
    rng = np.random.default_rng(0)
    return {"input_ids": torch.from_numpy(rng.integers(
        0, SP_VOCAB, (SP_ROWS, SP_T)).astype(np.int64))}


def _sp_steps(torch, engine, counters, comm=None):
    """2 + 3 steps of the batch: losses, walls, K1-K4 launches of the
    timed steps, the last step's collectives."""
    batch = _sp_batch(torch)
    losses, walls, counts = [], [], {}
    for i in range(SP_WARMUP + SP_STEPS):
        if i == SP_WARMUP:
            for c in counters.values():
                c.launches = 0
        if comm is not None:
            comm.reset_collective_counts()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        if comm is not None:
            counts = comm.collective_counts()
    return {"losses": losses, "walls": walls,
            "launches": {n: c.launches for n, c in counters.items()},
            "routes": {n: dict(c.routes) for n, c in counters.items()
                       if hasattr(c, "routes")},
            "collectives_last_step": counts}


def _sp_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel import sequence as sp
    counters = _flash_counters()
    engine = _sp_engine(torch, "float32", groups)
    loss, grads = engine.value_and_grad(_sp_batch(torch), 1.0)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ref = torch.load(spec["ref"])
    out = {"rank": rank, "f32_loss": float(loss),
           "f32_grad_violations": {
               n: _allclose_share(g, ref["grads"][n], SP_GRAD_RTOL,
                                  SP_GRAD_ATOL) for n, g in grads.items()},
           "f32_grad_rel_err": max(_rel_err(g, ref["grads"][n])
                                   for n, g in grads.items())}
    del ref, grads
    heads = []
    orig = sp.flash_attention

    def flash(q, *a, **kw):
        heads.append(int(q.shape[2]))
        return orig(q, *a, **kw)

    sp.flash_attention = flash
    try:
        torch.cuda.reset_peak_memory_stats()
        engine = _sp_engine(torch, "bfloat16", groups)
        out["bf16"] = _sp_steps(torch, engine, counters, C)
        out["peak"] = torch.cuda.max_memory_allocated()
    finally:
        sp.flash_attention = orig
    out["local_heads"] = sorted(set(heads))
    out["staged"] = sorted(C.STAGED)
    del engine
    torch.cuda.empty_cache()
    return out


def phase_train_pipe_sp(torch):
    """``sp_pipeline_module`` at pipe 2 x seq 2 (module docstring, phase
    26)."""
    import tempfile
    counters = _flash_counters()
    engine = _sp_engine(torch, "float32")
    loss1, grads1 = engine.value_and_grad(_sp_batch(torch), 1.0)
    tmp = tempfile.mkdtemp(prefix="sp_ref_")
    ref = os.path.join(tmp, "grads.pt")
    torch.save({"grads": grads1}, ref)
    n_params = sum(int(g.numel()) for g in grads1.values())
    del engine, grads1
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = _sp_engine(torch, "bfloat16")
    seq1 = _sp_steps(torch, engine, counters)
    seq1_peak = torch.cuda.max_memory_allocated()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_tp(torch, "train_pipe_sp", {
        "mesh": {"pipe": 2, "seq": 2}, "in_process_pipe": True,
        "ref": ref})
    os.remove(ref)
    tokens = SP_ROWS * SP_T
    timed = [max(r["bf16"]["walls"][i] for r in ranks)
             for i in range(SP_WARMUP, SP_WARMUP + SP_STEPS)]
    row = {"phase": "train_pipe_sp", "model": "sp_pipeline_module",
           "vocab": SP_VOCAB, "d_model": SP_D, "n_head": SP_H,
           "blocks": SP_BLOCKS, "seq": SP_T, "rows": SP_ROWS,
           "micro_batches": SP_MICRO, "params": n_params,
           "mesh": {"pipe": 2, "seq": 2}, "processes": 2,
           "device": "cuda:0", "backend": "gloo (CUDA tensors, one device)",
           "f32_seq1_loss": float(loss1),
           "f32_loss_by_rank": [r["f32_loss"] for r in ranks],
           "loss_rtol": SP_LOSS_RTOL, "grad_rtol": SP_GRAD_RTOL,
           "grad_atol": SP_GRAD_ATOL,
           "f32_grad_violation_share": max(
               v for r in ranks for v in r["f32_grad_violations"].values()),
           "f32_grad_max_rel_err": max(r["f32_grad_rel_err"] for r in ranks),
           "bf16_losses": ranks[0]["bf16"]["losses"],
           "bf16_seq1_losses": seq1["losses"],
           "bf16_loss_atol": SP_BF16_LOSS_ATOL,
           "losses_by_rank_equal": all(
               r["bf16"]["losses"] == ranks[0]["bf16"]["losses"]
               for r in ranks),
           "step_p50_ms": statistics.median(timed) * 1e3,
           "tokens_per_s": tokens * len(timed) / sum(timed),
           "seq1_step_p50_ms": statistics.median(
               seq1["walls"][SP_WARMUP:]) * 1e3,
           "seq1_peak_memory": seq1_peak,
           "peak_memory_by_rank": [r["peak"] for r in ranks],
           "launches_by_rank": [r["bf16"]["launches"] for r in ranks],
           "seq1_launches": seq1["launches"],
           "routes_by_rank": [r["bf16"]["routes"] for r in ranks],
           "local_heads": [r["local_heads"] for r in ranks],
           "collectives_a_step": ranks[0]["bf16"]["collectives_last_step"],
           "staged_through_host": ranks[0]["staged"]}
    emit(row)
    if any(abs(r["f32_loss"] - loss1) > SP_LOSS_RTOL * abs(loss1)
           for r in ranks) or row["f32_grad_violation_share"] > 0:
        fail(f"train_pipe_sp f32: seq 2 vs seq 1 loss "
             f"{row['f32_loss_by_rank']} / {loss1} (rtol {SP_LOSS_RTOL}) or "
             f"{row['f32_grad_violation_share']} of a leaf's gradient "
             f"outside rtol {SP_GRAD_RTOL} / atol {SP_GRAD_ATOL}")
    if not row["losses_by_rank_equal"] or not all(np.isfinite(
            row["bf16_losses"])) or any(
            abs(a - b) > SP_BF16_LOSS_ATOL
            for a, b in zip(row["bf16_losses"], seq1["losses"])):
        fail(f"train_pipe_sp bf16 losses {row['bf16_losses']} vs seq 1 "
             f"{seq1['losses']} (atol {SP_BF16_LOSS_ATOL}) or not equal "
             f"on the ranks")
    per = SP_BLOCKS * SP_MICRO * SP_STEPS
    want = {"K1": per, "K2": per, "K3": per, "K4": 2 * SP_STEPS}
    if any(r["bf16"]["launches"] != want for r in ranks) or any(
            h != [SP_H // 2] for h in row["local_heads"]) or any(
            r["bf16"]["routes"].get("K1", {}).get("tensor_core", 0) == 0
            for r in ranks):
        fail(f"train_pipe_sp launches {row['launches_by_rank']} != {want}, "
             f"local heads {row['local_heads']} != {SP_H // 2} or K1 off "
             f"the tensor cores ({row['routes_by_rank']})")
    return row


def _moe_model(torch, mpu=None):
    from deepspeed_tpu_torch.models.gpt2_moe import (
        GPT2MoEConfig, GPT2MoELMHead)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = GPT2MoEConfig(n_embd=1024, n_layer=24, n_head=16,
                        n_positions=TRAIN_T, dropout=0.0,
                        use_flash_attention=True)
    return GPT2MoELMHead(cfg, device="cuda", generator=gen, mpu=mpu)


def _moe_config(mesh_shape=None):
    cfg = {"train_batch_size": TRAIN_B, "bf16": {"enabled": True},
           "zero_optimization": {"stage": 1},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                                    "pallas": True}},
           "steps_per_print": 10 ** 9}
    if mesh_shape:
        cfg["mesh"] = mesh_shape
    return cfg


def _moe_leaf_kind(name):
    """The group of a GPT-2 MoE leaf the update is compared over."""
    if name.endswith(".moe.gate"):
        return "gate"
    return "expert" if ".expert_" in name else "other"


def _moe_run(torch, engine, model, counters, comm=None):
    """2 + 3 steps; the first step's gradients as the params receive them
    (``gate``: the whole gradient, summed over the expert group; the
    rest: its squared L2 norm) and the masters before the first step
    (CPU) come back too."""
    batch = _train_batch_350m()
    for c in counters.values():
        c.launches = 0
    first = {}

    def keep(g, n):
        if _moe_leaf_kind(n) == "gate":
            first.setdefault(n, g.detach().float().cpu())
        else:
            first.setdefault(n, float(g.detach().double().square().sum()))

    hooks = [p.register_hook(lambda g, n=n: keep(g, n))
             for n, p in model.named_parameters()]
    init = [p.detach().float().cpu().clone() for p in engine.params]
    losses, walls, norms, routing, counts = [], [], [], None, {}
    for i in range(MOE_WARMUP + MOE_STEPS):
        if comm is not None:
            comm.reset_collective_counts()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        norms.append(float(engine._last_metrics["grad_norm"]))
        if i == 0:
            routing = {str(n): [k.tolist(), r.tolist()]
                       for n, (k, r) in model.routing().items()}
            for h in hooks:
                h.remove()
        if comm is not None:
            counts = comm.collective_counts()
    return {"losses": losses, "walls": walls, "grad_norms": norms,
            "routing": routing,
            "launches": {n: c.launches for n, c in counters.items()},
            "collectives_last_step": counts}, first, init


def _plant_moe_fault(torch, fault, model, rank):
    """Plant ``fault`` (``MOE_FAULTS``) in this expert rank's model."""
    if fault == "aux":
        from deepspeed_tpu_torch.moe import layer
        layer.prescale_aux = lambda aux, group: aux
    elif rank == 1:
        for n, p in model.named_parameters():
            if fault == "bank" and n.endswith(".expert_w1"):
                p.register_hook(torch.zeros_like)
            elif fault == "scale" and ".expert_" in n:
                p.register_hook(lambda g: g * 2.0)


def _moe_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel.tensor_parallel import shard_tensor
    ep = groups.axis("expert")
    counters = _flash_counters()
    torch.cuda.reset_peak_memory_stats()
    model = _moe_model(torch, groups)
    if spec.get("fault"):
        _plant_moe_fault(torch, spec["fault"], model, ep.rank)
    engine, _, _, _ = initialize(model=model, config=_moe_config(
        {"expert": ep.size}), mpu=groups)
    out, first, init = _moe_run(torch, engine, model, counters, C)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["staged"] = sorted(C.STAGED)
    out["rank"] = rank
    out["expert_params"] = int(sum(p.numel() for n, p in
                                   model.named_parameters()
                                   if ".expert_" in n))
    ref = torch.load(spec["ref"])
    kinds = ("gate", "expert", "other")
    # [kind, (|update - update'|^2, |update'|^2, |grad|^2)] and the gate
    # gradients' (|grad - grad'|^2, |grad'|^2), each leaf counted once
    sq = torch.zeros(len(kinds), 3, dtype=torch.float64)
    gate_sq = torch.zeros(2, dtype=torch.float64)
    for i, (name, p) in enumerate(zip(engine._param_names(), engine.params)):
        s = engine._tp_specs[i]
        if s is None and ep.rank != 0:
            continue
        want = ref["update"][name] if s is None else shard_tensor(
            ref["update"][name], s, ep.rank, ep.size)
        got = p.detach().float().cpu() - init[i]
        kind = _moe_leaf_kind(name)
        g = first[name]
        if kind == "gate":
            w = ref["first_grads"][name].double()
            gate_sq += torch.stack([(g.double() - w).square().sum(),
                                    w.square().sum()])
            g = float(g.double().square().sum())
        sq[kinds.index(kind)] += torch.tensor(
            [float((got.double() - want.double()).square().sum()),
             float(want.double().square().sum()), g], dtype=torch.float64)
    del ref, init
    C.all_reduce(sq, ep)
    C.all_reduce(gate_sq, ep)
    out["update_rel_l2"] = {k: float((sq[j, 0] / sq[j, 1]).sqrt())
                            for j, k in enumerate(kinds)}
    out["first_grad_norm"] = {k: float(sq[j, 2].sqrt())
                              for j, k in enumerate(kinds)}
    out["gate_grad_rel_l2"] = float((gate_sq[0] / gate_sq[1]).sqrt())
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _route_gap(got, want):
    """Per MoE layer: the largest |kept - kept'| and |dropped - dropped'|
    over the experts, as a share of the layer's routed tokens."""
    gaps = {}
    for layer, (kept, routed) in want.items():
        k2, r2 = got[layer]
        drop, drop2 = np.subtract(routed, kept), np.subtract(r2, k2)
        gaps[layer] = float(max(np.abs(np.subtract(kept, k2)).max(),
                                np.abs(drop - drop2).max()) / sum(routed))
    return gaps


def _moe_readings(ref, ranks):
    """An expert 2 world's readings against expert 1 (``MOE_LIMITS``'
    keys), the route gaps by rank, and the gates it breaks."""
    first = min(ref["routing"], key=int)
    got = ranks[0]
    read = {"first_loss_rel": abs(got["losses"][0] - ref["losses"][0]) /
            abs(ref["losses"][0]),
            "grad_norm_rel": max(abs(a - b) / b for a, b in zip(
                got["grad_norms"], ref["grad_norms"])),
            "gate_grad_rel_l2": got["gate_grad_rel_l2"]}
    for k, v in got["first_grad_norm"].items():
        read[f"first_grad_norm_rel/{k}"] = abs(
            v - ref["first_grad_norm"][k]) / ref["first_grad_norm"][k]
    for k, v in got["update_rel_l2"].items():
        read[f"update_rel_l2/{k}"] = v
    gaps = [_route_gap(r["routing"], ref["routing"]) for r in ranks]
    broken = [k for k, lim in MOE_LIMITS.items() if not read[k] <= lim]
    if any(g[first] != 0.0 for g in gaps) or any(
            v > MOE_ROUTE_GAP for g in gaps for v in g.values()):
        broken.append("route_gap")
    if any(r["losses"] != got["losses"] for r in ranks) or not all(
            np.isfinite(got["losses"])):
        broken.append("losses_by_rank")
    return read, gaps, broken


def phase_train_moe(torch, faults=()):
    """GPT-2 MoE 350M at expert 1, then expert 2 (module docstring, phase
    27); with ``faults``, expert 2 again with each planted."""
    import tempfile
    from deepspeed_tpu_torch import initialize
    counters = _flash_counters()
    torch.cuda.reset_peak_memory_stats()
    model = _moe_model(torch)
    n_params = int(sum(p.numel() for p in model.parameters()))
    engine, _, _, _ = initialize(model=model, config=_moe_config())
    ref, first, init = _moe_run(torch, engine, model, counters)
    ref_peak = torch.cuda.max_memory_allocated()
    ref["first_grad_norm"] = {
        k: math.sqrt(sum(float(v.double().square().sum()) if k == "gate"
                         else v for n, v in first.items()
                         if _moe_leaf_kind(n) == k))
        for k in ("gate", "expert", "other")}
    tmp = tempfile.mkdtemp(prefix="moe_ref_")
    path = os.path.join(tmp, "ref.pt")
    torch.save({"update": {n: p.detach().float().cpu() - p0 for n, p, p0 in
                           zip(engine._param_names(), engine.params, init)},
                "first_grads": {n: v for n, v in first.items()
                                if _moe_leaf_kind(n) == "gate"}}, path)
    del engine, model, init
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_tp(torch, "train_moe", {"mesh": {"expert": 2},
                                              "ref": path})
    planted = {}
    for fault in faults:
        franks, _ = _spawn_tp(torch, "train_moe", {
            "mesh": {"expert": 2}, "ref": path, "fault": fault})
        read, _, broken = _moe_readings(ref, franks)
        planted[fault] = {"readings": read, "gates_broken": broken}
    os.remove(path)
    steps = MOE_WARMUP + MOE_STEPS
    timed = [max(r["walls"][i] for r in ranks)
             for i in range(MOE_WARMUP, steps)]
    tokens = TRAIN_B * TRAIN_T
    read, gaps, broken = _moe_readings(ref, ranks)
    kept = sum(sum(k) for k, _ in ref["routing"].values())
    routed = sum(sum(r) for _, r in ref["routing"].values())
    row = {"phase": "train_moe", "model": "gpt2_moe_350m", "params": n_params,
           "experts": 8, "top_k": 2, "capacity_factor": 1.25,
           "moe_layers": len(ref["routing"]), "zero_stage": 1,
           "dtype": "bfloat16", "mesh": {"expert": 2}, "processes": 2,
           "device": "cuda:0", "backend": "gloo (CUDA tensors, one device)",
           "expert1_losses": ref["losses"], "losses": ranks[0]["losses"],
           "losses_by_rank_equal": all(r["losses"] == ranks[0]["losses"]
                                       for r in ranks),
           "expert1_grad_norms": ref["grad_norms"],
           "grad_norms": ranks[0]["grad_norms"],
           "readings": read, "limits": MOE_LIMITS,
           "route_gap_by_rank": gaps, "route_gap_limit": MOE_ROUTE_GAP,
           "gates_broken": broken, "planted_faults": planted,
           "dropped_token_share": 1.0 - kept / routed,
           "expert1_routing_step1": ref["routing"],
           "step_p50_ms": statistics.median(timed) * 1e3,
           "tokens_per_s": tokens * len(timed) / sum(timed),
           "expert1_step_p50_ms": statistics.median(
               ref["walls"][MOE_WARMUP:]) * 1e3,
           "expert1_peak_memory": ref_peak,
           "peak_memory_by_rank": [r["peak"] for r in ranks],
           "expert_params_by_rank": [r["expert_params"] for r in ranks],
           "launches_by_rank": [r["launches"] for r in ranks],
           "expert1_launches": ref["launches"],
           "collectives_a_step": ranks[0]["collectives_last_step"],
           "staged_through_host": ranks[0]["staged"]}
    emit(row)
    if broken:
        fail(f"train_moe: expert 2 against expert 1 breaks {broken}: "
             f"readings {read} (limits {MOE_LIMITS}), route gaps {gaps} "
             f"(limit {MOE_ROUTE_GAP}; the first MoE layer must be equal)")
    missed = [f for f, p in planted.items() if not p["gates_broken"]]
    if missed:
        fail(f"train_moe: no gate caught the planted faults {missed}: "
             f"{planted}")
    want = {"K1": TRAIN_LAYERS * steps, "K2": TRAIN_LAYERS * steps,
            "K3": TRAIN_LAYERS * steps, "K4": steps}
    if any(r["launches"] != want for r in ranks) or ref["launches"] != want:
        fail(f"train_moe launches {row['launches_by_rank']} / expert 1 "
             f"{ref['launches']} != {want}")
    return row


def _ptm_engine(torch, mpu=None, overlap=None):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.moe.layer import MoEConfig
    from deepspeed_tpu_torch.parallel.pipe_tp import tp_pipeline_module
    from deepspeed_tpu_torch.parallel.pipe_tp_moe import TPMoEBlockLayer
    module = tp_pipeline_module(
        PTM_VOCAB, PTM_D, PTM_H, PTM_T, n_blocks=PTM_BLOCKS, num_stages=2,
        block_cls=TPMoEBlockLayer, carry_aux=True, use_flash=True,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0))
    mesh_shape = {"pipe": 2, "model": 2, "expert": 2} if mpu else \
        {"pipe": 2}
    cfg = {"train_batch_size": PTM_ROWS,
           "gradient_accumulation_steps": PTM_MICRO,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
           "steps_per_print": 10 ** 9, "mesh": mesh_shape}
    if overlap:
        cfg["tensor_parallel"] = {"overlap": overlap}
    engine, _, _, _ = initialize(model=module, config=cfg, mpu=mpu)
    return engine


def _ptm_batch(torch):
    rng = np.random.default_rng(0)
    return {"input_ids": torch.from_numpy(rng.integers(
        0, PTM_VOCAB, (PTM_ROWS, PTM_T)).astype(np.int64))}


# the expert_combine site alone (row and column parallel stay monolithic)
PTM_OVERLAP = {"enabled": True, "chunks": 4,
               "sites": {"row_parallel": {"enabled": False},
                         "column_parallel": {"enabled": False}}}


def _ptm_steps(torch, engine, counters, comm=None):
    batch = _ptm_batch(torch)
    for c in counters.values():
        c.launches = 0
    losses, walls, counts = [], [], {}
    for _ in range(PTM_STEPS):
        if comm is not None:
            comm.reset_collective_counts()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        if comm is not None:
            counts = comm.collective_counts()
    return {"losses": losses, "walls": walls,
            "launches": {n: c.launches for n, c in counters.items()},
            "collectives": counts}


def _ptm_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel.tensor_parallel import Shard, unshard
    counters = _flash_counters()
    out = {"rank": rank}
    torch.cuda.reset_peak_memory_stats()
    engine = _ptm_engine(torch, groups)
    loss, grads = engine.value_and_grad(_ptm_batch(torch), 1.0)
    ref = torch.load(spec["ref"])
    viol, worst = 0.0, 0.0
    for name, g in grads.items():
        leaf = name.split(".")[-1]
        for prefix, axis in (("mp_", "model"), ("expert_", "expert")):
            if leaf.startswith(prefix):
                pieces = C.all_gather(g.cuda().contiguous()[None],
                                      groups.axis(axis), dim=0)
                g = unshard(list(pieces.unbind(0)), Shard(2)).cpu()
        viol = max(viol, _allclose_share(g, ref["grads"][name],
                                         PTM_GRAD_RTOL, PTM_GRAD_ATOL))
        worst = max(worst, _rel_err(g, ref["grads"][name]))
    del ref, grads
    out.update(vag_loss=float(loss), grad_violation_share=viol,
               grad_max_rel_err=worst)
    out["off"] = _ptm_steps(torch, engine, counters, C)
    out["peak"] = torch.cuda.max_memory_allocated()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = _ptm_engine(torch, groups, overlap=PTM_OVERLAP)
    out["chunks4"] = _ptm_steps(torch, engine, counters, C)
    out["staged"] = sorted(C.STAGED)
    del engine
    torch.cuda.empty_cache()
    return out


def phase_train_pipe_tp_moe(torch):
    """TP x expert blocks at pipe 2 x model 2 x expert 2 (module
    docstring, phase 28)."""
    import tempfile
    counters = _flash_counters()
    engine = _ptm_engine(torch)
    loss1, grads1 = engine.value_and_grad(_ptm_batch(torch), 1.0)
    rep = _ptm_steps(torch, engine, counters)
    tmp = tempfile.mkdtemp(prefix="ptm_ref_")
    ref = os.path.join(tmp, "grads.pt")
    torch.save({"grads": grads1}, ref)
    del engine, grads1
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_tp(torch, "train_pipe_tp_moe", {
        "mesh": {"pipe": 2, "model": 2, "expert": 2},
        "in_process_pipe": True, "ref": ref}, world=PTM_WORLD)
    os.remove(ref)
    tokens = PTM_ROWS * PTM_T
    runs = {}
    for name in ("off", "chunks4"):
        timed = [max(r[name]["walls"][i] for r in ranks)
                 for i in range(1, PTM_STEPS)]
        runs[name] = {"losses": ranks[0][name]["losses"],
                      "step_p50_ms": statistics.median(timed) * 1e3,
                      "tokens_per_s": tokens * len(timed) / sum(timed),
                      "launches_by_rank": [r[name]["launches"]
                                           for r in ranks],
                      "collectives_a_step": ranks[0][name]["collectives"]}
    off, c4 = runs["off"]["losses"], runs["chunks4"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(c4, off))
    row = {"phase": "train_pipe_tp_moe", "model": "tp_pipeline_module",
           "block": "TPMoEBlockLayer", "vocab": PTM_VOCAB, "d_model": PTM_D,
           "n_head": PTM_H, "blocks": PTM_BLOCKS, "experts": 4, "top_k": 2,
           "capacity_factor": 2.0, "aux_carried": True, "stages": 2,
           "mesh": {"pipe": 2, "model": 2, "expert": 2},
           "processes": PTM_WORLD, "device": "cuda:0",
           "backend": "gloo (CUDA tensors, one device)", "rows": PTM_ROWS,
           "seq": PTM_T, "micro_batches": PTM_MICRO, "dtype": "float32",
           "replicated_vag_loss": float(loss1),
           "vag_loss_by_rank": [r["vag_loss"] for r in ranks],
           "loss_rtol": PTM_LOSS_RTOL, "grad_rtol": PTM_GRAD_RTOL,
           "grad_atol": PTM_GRAD_ATOL,
           "grad_violation_share": max(r["grad_violation_share"]
                                       for r in ranks),
           "grad_max_rel_err": max(r["grad_max_rel_err"] for r in ranks),
           "replicated_losses": rep["losses"],
           "replicated_step_p50_ms": statistics.median(
               rep["walls"][1:]) * 1e3,
           "runs": runs, "chunks4_vs_off_max_rel": gap,
           "overlap_rtol": PTM_OVERLAP_RTOL,
           "ranks_agree": all(r[n]["losses"] == ranks[0][n]["losses"]
                              for r in ranks for n in ("off", "chunks4")),
           "peak_memory_by_rank": [r["peak"] for r in ranks],
           "staged_through_host": ranks[0]["staged"]}
    emit(row)
    if any(abs(r["vag_loss"] - loss1) > PTM_LOSS_RTOL * abs(loss1)
           for r in ranks) or row["grad_violation_share"] > 0 or any(
            abs(a - b) > PTM_LOSS_RTOL * abs(b)
            for a, b in zip(off, rep["losses"])):
        fail(f"train_pipe_tp_moe vs model 1 x expert 1: losses "
             f"{row['vag_loss_by_rank']} {off} / {loss1} {rep['losses']} "
             f"or {row['grad_violation_share']} of a gradient outside "
             f"rtol {PTM_GRAD_RTOL} / atol {PTM_GRAD_ATOL}")
    if not gap <= PTM_OVERLAP_RTOL or not row["ranks_agree"] or \
            not runs["chunks4"]["collectives_a_step"].get("ppermute"):
        fail(f"train_pipe_tp_moe: expert_combine chunks 4 vs off {gap} > "
             f"{PTM_OVERLAP_RTOL}, ranks disagree or no ring ran")
    per = PTM_BLOCKS * PTM_MICRO * PTM_STEPS
    want = {"K1": per, "K2": per, "K3": per, "K4": 2 * PTM_STEPS}
    if any(r[n]["launches"] != want for r in ranks
           for n in ("off", "chunks4")):
        fail(f"train_pipe_tp_moe launches "
             f"{runs['off']['launches_by_rank']} != {want}")
    return row


# ---------------------------------------------------------------------------
# the gradient compressors (phases 29-32): the int8 quantized all-reduce,
# the 1-bit compressed all-reduce and 1-bit Adam
# ---------------------------------------------------------------------------

F5_WORLD = 2                       # data ranks on cuda:0 (phases 29-31)
F5_PTP_WORLD = 8                   # pipe 2 x model 2 x data 2 (phase 32)
QC_B, QC_LR = 8, 1e-4              # the bench.py:405-450 row: GPT-2 125M
QC_STEPS = 3                       # a run's steps; the first is not timed
QC_LOSS_RTOL = 5e-3                # JAX's pin (test_quantized_parity)
QC_RUNS = [("fp32", {}),
           ("q0", {"comm_quantization": {"enabled": True}}),
           ("q2", {"comm_quantization": {"enabled": True,
                                         "error_feedback": True},
                   "zero_optimization": {"stage": 2},
                   "gradient_accumulation_steps": 2})]
OB_STEPS, OB_FREEZE = 6, 2
# Adam's eps in phases 30-32: the vocabulary rows no token of the batch
# touches keep v = 0 through the warmup, and after the freeze their
# compressed momentum is +-scale (the 1-bit image of 0 is +scale), a
# step of lr x scale / eps: at eps 1e-8 the loss blows up within 2 steps
OB_EPS = 1e-4
# 1-bit Adam's warmup against K4 without bias correction: the first
# step's update is the same formula of the same gradient, but K4 takes
# 1 - beta2 in fp32 (0.0010000467) and the 1-bit update, as JAX's,
# rounds 1 - 0.999 once (0.001): v is 4.7e-5 apart, the update at most
# half that (1e-4 relative L2 leaves 4x); the warmup losses read masters
# that close through bf16 casts: rtol 1e-4. (The step-2 update is
# reported, not gated: where a gradient near 0 flips its sign between
# the runs, Adam's step is lr x sign.)
OB_WARMUP_LOSS_RTOL, OB_WARMUP_UPDATE_RTOL = 1e-4, 1e-4
# the 1-bit scale ||x|| / sqrt(n) in fp32 on the card against float64
# over the model's 1.2e8 elements: torch's reduction sums a few hundred
# terms serially per thread, then a tree, so the sum of squares errs by
# about (256 + log2 n) 2^-24 ~ 1.7e-5 at worst and the norm by half;
# 1e-4 leaves over 10x
OB_SCALE_RTOL = 1e-4
# phase 31 cuts 350M's depth to 4 blocks, phase 32 the train_pipe_tp
# row's to 2 (one a stage): the script's 1200 s holds every phase
PO_BLOCKS, PTO_BLOCKS, PO_STEPS, PO_FREEZE = 4, 2, 4, 2
PO_WARMUP_RTOL = 2e-4              # JAX test_onebit_pipeline.py's
F5_FAULTS = {"train_pipe_onebit": "tied_in_body",
             "train_pipe_tp_onebit": "rep_with_mp"}


def _f5_rows(x, accum, data, d):
    """Data rank ``d``'s rows of a global batch (JAX ``_shard_batch``:
    global micro-batch k's rows ``[d*m, (d+1)*m)``)."""
    per = x.shape[0] // accum
    m = per // data
    return x.reshape((accum, per) + x.shape[1:])[:, d * m:(d + 1) * m] \
        .reshape((accum * m,) + x.shape[1:])


def _host_digest(tensors):
    """sha256 of the tensors' bytes, copied to the host (a bitwise gate's
    operand)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).numpy().tobytes())
    return h.hexdigest()


F5_LAYERS = 6                      # phases 29-30's depth (125M widths)


def _f5_gpt2_125m(torch):
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_125m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = dataclasses.replace(
        gpt2_125m(n_positions=TRAIN_T, dropout=0.0, use_flash_attention=True,
                  loss_chunk=0), n_layer=F5_LAYERS)
    return GPT2LMHead(cfg, device="cuda", generator=gen)


def _f5_dp_run(torch, extra, steps, counters, rank, keep=None):
    """``steps`` steps of GPT-2 125M at data 2 under ``extra`` config
    keys: losses, walls, each step's params digest, K1-K4 launches, the
    last step's collectives (the port's counts by kind and dtype, and the
    engine's data-group counts). ``keep`` (step numbers) also returns the
    masters after those steps, by step."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.parallel import collectives as C
    cfg = {"train_batch_size": QC_B, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": QC_LR}},
           "steps_per_print": 10 ** 9}
    cfg.update(extra)
    accum = int(cfg.get("gradient_accumulation_steps", 1))
    engine, _, _, _ = initialize(model=_f5_gpt2_125m(torch), config=cfg)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50257, (QC_B, TRAIN_T)).astype(np.int64)
    batch = {"input_ids": torch.from_numpy(_f5_rows(x, accum, F5_WORLD,
                                                    rank))}
    start = [p.detach().clone() for p in engine.params]
    for c in counters.values():
        c.launches = 0
    out = {"losses": [], "walls": [], "digests": [], "errors": [],
           "step_bytes": []}
    kept = {}
    for i in range(steps):
        C.reset_collective_counts()
        engine.comm.reset()
        t0 = time.perf_counter()
        out["losses"].append(float(engine.train_batch(batch)))
        out["walls"].append(time.perf_counter() - t0)
        counts, comm = C.collective_counts(), engine.comm.snapshot()
        out["step_bytes"].append({
            "collectives": counts,
            "data_group": {k: v for k, v in comm.items()
                           if v["calls"]}})
        out["digests"].append(_host_digest(engine.params))
        s = engine.opt_state
        if hasattr(s, "worker_error"):
            out["errors"].append(float(s.worker_error.abs().sum()))
        if i + 1 in (keep or ()):
            kept[i + 1] = [p.detach().clone() for p in engine.params]
    out["launches"] = {n: c.launches for n, c in counters.items()}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out, start, kept


def _qcomm_worker(torch, spec, groups, rank):
    counters = _flash_counters()
    out = {"rank": rank}
    for name, extra in QC_RUNS:
        out[name] = _f5_dp_run(torch, extra, QC_STEPS, counters, rank)[0]
    return out


def _wire_bytes(step):
    """A step's gradient-exchange bytes by dtype: the quantized
    exchange's all-to-all and all-gather (the port's counts), else the
    data group's dense all-reduce (the engine's counts, scalar votes
    apart)."""
    out = {}
    for kind in ("all_to_all", "all_gather", "all_reduce"):
        for dt, n in step["collectives"].get(kind, {}).get(
                "dtypes", {}).items():
            out[f"{kind}/{dt}"] = out.get(f"{kind}/{dt}", 0) + n
    dense = step["data_group"].get("all_reduce", {}).get("bytes", 0)
    if dense:
        out["all_reduce/float32"] = out.get("all_reduce/float32", 0) + dense
    return out


def _send_bytes(wire, world):
    """Bytes a rank sends on a ring (the counted operands: an
    all-reduce's tensor sends 2 (N-1)/N of it, an all-to-all's stack and
    an all-gather's output (N-1)/N)."""
    f = (world - 1) / world
    return sum((2 * f if k.startswith("all_reduce") else f) * n
               for k, n in wire.items())


def phase_train_qcomm(torch, ranks):
    """The int8 gradient all-reduce at data 2 (module docstring, phase
    29), from its ranks' results (``_f5_data_worker``)."""
    r0 = ranks[0]
    base = r0["fp32"]["losses"]
    runs = {}
    for name, extra in QC_RUNS:
        run = r0[name]
        wire = _wire_bytes(run["step_bytes"][-1])
        timed = [max(r[name]["walls"][i] for r in ranks)
                 for i in range(1, QC_STEPS)]
        runs[name] = {
            "config": extra, "losses": run["losses"],
            "max_rel_vs_fp32": max(abs(a - b) / abs(b) for a, b in
                                   zip(run["losses"], base)),
            "ranks_bitwise_every_step": all(
                r[name]["digests"] == run["digests"] for r in ranks),
            "step_p50_ms": statistics.median(timed) * 1e3,
            "wire_bytes_a_step": wire,
            "send_bytes_a_step": _send_bytes(wire, F5_WORLD),
            "launches_by_rank": [r[name]["launches"] for r in ranks]}
    fp32_send = runs["fp32"]["send_bytes_a_step"]
    for name in ("q0", "q2"):
        runs[name]["wire_ratio_vs_fp32"] = \
            fp32_send / runs[name]["send_bytes_a_step"]
    c = 512
    row = {"phase": "train_qcomm", "model": "gpt2_125m", "rows": QC_B,
           "seq": TRAIN_T, "dtype": "bfloat16", "data": F5_WORLD,
           "processes": F5_WORLD, "device": "cuda:0",
           "backend": "gloo (CUDA tensors, one device)",
           "chunk_size": c, "bucket_mb": 4, "runs": runs,
           "loss_rtol": QC_LOSS_RTOL,
           "predicted_wire_ratio": 4 / (1 + 4 / c)}
    emit(row)
    for name, run in runs.items():
        if not run["ranks_bitwise_every_step"]:
            fail(f"train_qcomm {name}: the ranks' params differ")
        if not all(np.isfinite(run["losses"])) or \
                run["max_rel_vs_fp32"] > QC_LOSS_RTOL:
            fail(f"train_qcomm {name}: losses {run['losses']} vs fp32 "
                 f"{base} beyond rtol {QC_LOSS_RTOL}")
        accum = int(QC_RUNS[[n for n, _ in QC_RUNS].index(name)][1].get(
            "gradient_accumulation_steps", 1))
        want = {"K1": F5_LAYERS * accum * QC_STEPS,
                "K2": F5_LAYERS * accum * QC_STEPS,
                "K3": F5_LAYERS * accum * QC_STEPS, "K4": QC_STEPS}
        if any(lr != want for lr in run["launches_by_rank"]):
            fail(f"train_qcomm {name} launches {run['launches_by_rank']} "
                 f"!= {want}")
    for name in ("q0", "q2"):
        if "all_to_all/int8" not in runs[name]["wire_bytes_a_step"]:
            fail(f"train_qcomm {name}: no int8 exchange ran")
    return row


def _onebit_worker(torch, spec, groups, rank):
    counters = _flash_counters()
    out = {"rank": rank}
    nobias = {"optimizer": {"type": "Adam", "params": {
        "lr": QC_LR, "eps": OB_EPS, "bias_correction": False}}}
    onebit = {"optimizer": {"type": "OneBitAdam", "params": {
        "lr": QC_LR, "eps": OB_EPS, "freeze_step": OB_FREEZE}}}
    steps = (1, OB_FREEZE)
    out["nobias"], start, adam = _f5_dp_run(
        torch, nobias, OB_FREEZE + 1, counters, rank, keep=steps)
    out["onebit"], _, ob = _f5_dp_run(torch, onebit, OB_STEPS, counters,
                                      rank, keep=steps)
    for step in steps:
        num = sum(float(((x - y).double() ** 2).sum())
                  for x, y in zip(ob[step], adam[step]))
        den = sum(float(((y - s).double() ** 2).sum())
                  for y, s in zip(adam[step], start))
        out[f"update_rel_l2_step{step}"] = math.sqrt(num / den)
    del start, adam, ob
    torch.cuda.empty_cache()
    return out


def _codec_check(torch, n):
    """``pack_signs`` / ``unpack_signs`` and the worker's 1-bit scale on
    the card against the same functions on the host (seeded values of
    the model's size): the bits equal, the scale within
    ``OB_SCALE_RTOL`` of float64."""
    from deepspeed_tpu_torch.runtime.comm import compressed as pc
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, generator=gen)
    padded, _ = pc.error_feedback_sizes(n, F5_WORLD)
    x = torch.cat([x, torch.zeros(padded - n)])
    zeros = torch.zeros(padded)
    dev = pc.compressed_worker(x.cuda(), zeros.cuda(), F5_WORLD, n)
    host = pc.compressed_worker(x, zeros, F5_WORLD, n)
    bits_equal = torch.equal(dev[0].cpu(), host[0])
    unpacked_equal = torch.equal(pc.unpack_signs(dev[0]).cpu(),
                                 pc.unpack_signs(host[0]))
    want = float(np.linalg.norm(x.numpy().astype(np.float64)) /
                 math.sqrt(n))
    rel = abs(float(dev[1]) - want) / want
    return {"elements": n, "bits_equal": bits_equal,
            "unpack_equal": unpacked_equal, "scale_rel_err": rel,
            "scale_rtol": OB_SCALE_RTOL}


def phase_train_onebit(torch, ranks):
    """1-bit Adam at data 2 (module docstring, phase 30), from its ranks'
    results (``_f5_data_worker``)."""
    r0 = ranks[0]
    ob, nb = r0["onebit"], r0["nobias"]
    warm = max(abs(a - b) / abs(b) for a, b in
               zip(ob["losses"][:OB_FREEZE + 1], nb["losses"]))
    dense = _send_bytes(_wire_bytes(ob["step_bytes"][0]), F5_WORLD)
    comp = _send_bytes(_wire_bytes(ob["step_bytes"][-1]), F5_WORLD)
    walls = [max(r["onebit"]["walls"][i] for r in ranks)
             for i in range(OB_STEPS)]
    n = sum(p.numel() for p in _f5_gpt2_125m(torch).parameters())
    gc.collect()
    torch.cuda.empty_cache()
    codec = _codec_check(torch, n)
    row = {"phase": "train_onebit", "model": "gpt2_125m", "rows": QC_B,
           "seq": TRAIN_T, "dtype": "bfloat16", "data": F5_WORLD,
           "freeze_step": OB_FREEZE, "steps": OB_STEPS,
           "losses": ob["losses"], "nobias_losses": nb["losses"],
           "warmup_loss_max_rel": warm,
           "warmup_loss_rtol": OB_WARMUP_LOSS_RTOL,
           "warmup_update_rel_l2": max(r["update_rel_l2_step1"]
                                       for r in ranks),
           "warmup_update_rel_l2_step2": max(
               r[f"update_rel_l2_step{OB_FREEZE}"] for r in ranks),
           "warmup_update_rtol": OB_WARMUP_UPDATE_RTOL, "eps": OB_EPS,
           "ranks_bitwise_every_step": all(
               r["onebit"]["digests"] == ob["digests"] for r in ranks),
           "worker_error_abs_by_step": ob["errors"],
           "dense_step_send_bytes": dense,
           "compressed_step_send_bytes": comp,
           "compression_ratio": dense / comp,
           "wire_warmup_step": _wire_bytes(ob["step_bytes"][0]),
           "wire_compressed_step": _wire_bytes(ob["step_bytes"][-1]),
           "warmup_step_ms": walls[OB_FREEZE - 1] * 1e3,
           "compressed_step_p50_ms": statistics.median(
               walls[OB_FREEZE:]) * 1e3,
           "launches_by_rank": [r["onebit"]["launches"] for r in ranks],
           "codec": codec}
    emit(row)
    if warm > OB_WARMUP_LOSS_RTOL or \
            row["warmup_update_rel_l2"] > OB_WARMUP_UPDATE_RTOL:
        fail(f"train_onebit: the warmup is not Adam without bias "
             f"correction ({warm}, {row['warmup_update_rel_l2']})")
    if not row["ranks_bitwise_every_step"] or \
            not all(np.isfinite(ob["losses"])):
        fail("train_onebit: the ranks' params differ or a loss is not "
             "finite")
    if any(e != 0 for e in ob["errors"][:OB_FREEZE]) or \
            not all(e > 0 for e in ob["errors"][OB_FREEZE:]):
        fail(f"train_onebit: error buffers {ob['errors']}: zero through "
             f"the warmup, nonzero after the freeze expected")
    if not (codec["bits_equal"] and codec["unpack_equal"]) or \
            codec["scale_rel_err"] > OB_SCALE_RTOL:
        fail(f"train_onebit: the codec on the card differs from the "
             f"host's ({codec})")
    want = {"K1": F5_LAYERS * OB_STEPS, "K2": F5_LAYERS * OB_STEPS,
            "K3": F5_LAYERS * OB_STEPS, "K4": 0}
    if any(lr != want for lr in row["launches_by_rank"]):
        fail(f"train_onebit launches {row['launches_by_rank']} != {want}")
    if "all_to_all/uint8" not in row["wire_compressed_step"]:
        fail("train_onebit: no packed signs crossed after the freeze")
    return row


def _plant_group_fault(fault):
    """Replace ``pipeline_onebit_groups`` with a faulty grouping:
    ``tied_in_body`` compresses the tied leaves in the body's buffer,
    ``rep_with_mp`` the model-replicated body leaves with the
    model-sharded ones."""
    from deepspeed_tpu_torch.runtime.fp16 import onebit_adam as po
    right = po.pipeline_onebit_groups

    def faulty(names, model_sharded, model=1, reference=None):
        kinds = dict(right(names, model_sharded, model, reference))
        if fault == "tied_in_body" and "tied" in kinds:
            kinds["body"] = kinds["body"] + kinds.pop("tied")
        if fault == "rep_with_mp" and "body_rep" in kinds:
            kinds["body_mp"] = kinds["body_mp"] + kinds.pop("body_rep")
        return [(k, sorted(v)) for k, v in kinds.items()]

    po.pipeline_onebit_groups = faulty


def _f5_pipe_engine(torch, spec, opt, mpu=None):
    """Phase 31's GPT-2 350M widths (``PO_BLOCKS`` blocks, bf16) at
    pipe 2 x data 2, every stage of a replica here; phase 32's
    ``tp_pipeline_module`` row (f32) at pipe 2 x model 2 x data 2, one
    process a stage rank."""
    from deepspeed_tpu_torch import initialize
    cfg = {"train_batch_size": PIPE_TP_ROWS if spec["tp"] else PIPE_ROWS,
           "gradient_accumulation_steps": PIPE_TP_MICRO if spec["tp"]
           else PIPE_MICRO, "steps_per_print": 10 ** 9,
           "mesh": spec["mesh"], "optimizer": opt}
    if spec["tp"]:
        from deepspeed_tpu_torch.parallel.pipe_tp import tp_pipeline_module
        module = tp_pipeline_module(PIPE_TP_VOCAB, PIPE_TP_D, PIPE_TP_H,
                                    PIPE_TP_T, n_blocks=PTO_BLOCKS,
                                    num_stages=2, use_flash=True)
    else:
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config
        from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
        # gpt2_350m's widths, depth cut to PO_BLOCKS
        module = gpt2_pipeline_module(GPT2Config(
            n_embd=1024, n_layer=PO_BLOCKS, n_head=16,
            n_positions=TRAIN_T, dropout=0.0, use_flash_attention=True,
            loss_chunk=0), seq_len=TRAIN_T)
        cfg["bf16"] = {"enabled": True}
    engine, _, _, _ = initialize(model=module, config=cfg, mpu=mpu)
    return engine


def _f5_pipe_batch(torch, spec, engine):
    rows, micro, vocab, t = (PIPE_TP_ROWS, PIPE_TP_MICRO, PIPE_TP_VOCAB,
                             PIPE_TP_T) if spec["tp"] else \
        (PIPE_ROWS, PIPE_MICRO, 50257, TRAIN_T)
    rng = np.random.default_rng(0)
    x = rng.integers(0, vocab, (rows, t)).astype(np.int64)
    return {"input_ids": torch.from_numpy(_f5_rows(
        x, micro, engine.dp_world_size, engine.dp_rank))}


def _pipe_onebit_worker(torch, spec, groups, rank):
    """One rank of phases 31-32: Adam without bias correction, then 1-bit
    Adam (with ``spec["fault"]``: only 1-bit Adam, frozen at once, under
    the planted grouping). Each step: the loss, the wall, whether this
    process's tied copies agree, and the digest of its leaves not split
    over the model axis (their copies on the other model ranks must be
    equal)."""
    from deepspeed_tpu_torch.parallel import collectives as C
    counters = _flash_counters()
    out = {"rank": rank}
    runs = [("onebit", {"type": "OneBitAdam", "params": {
        "lr": 1e-4, "eps": OB_EPS, "freeze_step": 0}}, 2)] \
        if spec.get("fault") else [
        ("nobias", {"type": "Adam", "params": {
            "lr": 1e-4, "eps": OB_EPS, "bias_correction": False}},
         PO_FREEZE + 1),
        ("onebit", {"type": "OneBitAdam", "params": {
            "lr": 1e-4, "eps": OB_EPS, "freeze_step": PO_FREEZE}},
         PO_STEPS)]
    if spec.get("fault"):
        _plant_group_fault(spec["fault"])
    mpu = groups if spec.get("in_process_pipe") else None
    for name, opt, steps in runs:
        engine = _f5_pipe_engine(torch, spec, opt, mpu)
        batch = _f5_pipe_batch(torch, spec, engine)
        for c in counters.values():
            c.launches = 0
        run = {"losses": [], "walls": [], "tied_equal": [],
               "replicated_digest": [], "bytes": []}
        for _ in range(steps):
            C.reset_collective_counts()
            t0 = time.perf_counter()
            run["losses"].append(float(engine.train_batch(batch)))
            run["walls"].append(time.perf_counter() - t0)
            run["bytes"].append(C.collective_counts())
            held = {}
            rep = []
            for se in engine.stage_engines:
                for n, p, sh in zip(se._param_names(), se.params,
                                    se._tp_specs):
                    if n.startswith("tied."):
                        held.setdefault(n, []).append(p.detach().cpu())
                    if sh is None or sh.axis != "model":
                        rep.append(p)
            run["tied_equal"].append(all(
                torch.equal(ts[0], t) for ts in held.values() for t in ts))
            run["replicated_digest"].append(_host_digest(rep))
        run["launches"] = {n: c.launches for n, c in counters.items()}
        run["groups"] = {se.module.stage_id: [
            [k, len(i)] for k, i in getattr(se, "_onebit_groups", [])]
            for se in engine.stage_engines}
        run["errors"] = [float(se.opt_state.worker_error.abs().sum())
                         for se in engine.stage_engines
                         if hasattr(se.opt_state, "worker_error")]
        run["stages"] = [se.module.stage_id for se in engine.stage_engines]
        run["data_rank"] = engine.dp_rank
        run["model_rank"] = engine._axes["model"].rank
        run["tied_holders"] = {k: engine.parts.tied_holders(k)
                               for k in engine.parts.tied_keys()}
        out[name] = run
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tied_digests_agree(ranks, name):
    """Every step, in every process: the tied copies of its stages equal
    (phase 31 holds both end stages in one process; phase 32's module
    ties no layer)."""
    return all(all(r[name]["tied_equal"]) for r in ranks)


def _replicated_agree(ranks, name):
    """Every step: the leaves not split over the model axis hash equal
    on the model ranks of each (stage, data) coordinate."""
    by = {}
    for r in ranks:
        run = r[name]
        key = (tuple(run["stages"]), run["data_rank"])
        by.setdefault(key, []).append(run["replicated_digest"])
    return all(all(d == ds[0] for d in ds) for ds in by.values())


def _f5_spec(tp=False, fault=None):
    return {"tp": tp, "fault": fault,
            "mesh": {"pipe": 2, "model": 2, "data": 2} if tp else
            {"pipe": 2, "data": F5_WORLD}, "in_process_pipe": not tp}


def _f5_data_worker(torch, spec, groups, rank):
    """Phases 29-31's ranks in one world of two processes (one start-up
    for the three; the data-parallel engines see the same data group of
    two as the pipeline's in-process stages): each part's result by
    phase."""
    return {name: worker(torch, spec, groups, rank) for name, worker in (
        ("train_qcomm", _qcomm_worker), ("train_onebit", _onebit_worker),
        ("train_pipe_onebit", _pipe_onebit_worker))}


def phase_train_pipe_onebit(torch, fault=None, tp=False, ranks=None):
    """1-bit Adam through the pipeline (module docstring, phases 31 and
    32; with ``fault`` the planted grouping, which must break its
    equality gate), from ``ranks`` (phase 31's, ``_f5_data_worker``) or
    a world of its own."""
    name = "train_pipe_tp_onebit" if tp else "train_pipe_onebit"
    spec = _f5_spec(tp, fault)
    if ranks is None:
        ranks, _ = _spawn_tp(torch, name, spec,
                             world=F5_PTP_WORLD if tp else F5_WORLD)
    r0 = ranks[0]
    row = {"phase": name, "mesh": spec["mesh"], "processes": len(ranks),
           "device": "cuda:0", "backend": "gloo (CUDA tensors, one device)",
           "layout": "one process a stage rank" if tp else
           "every stage of a data replica in one process",
           "fault": fault}
    if tp:
        row.update(model="tp_pipeline_module", vocab=PIPE_TP_VOCAB,
                   d_model=PIPE_TP_D, n_head=PIPE_TP_H,
                   blocks=PTO_BLOCKS, rows=PIPE_TP_ROWS, seq=PIPE_TP_T,
                   micro_batches=PIPE_TP_MICRO, dtype="float32")
    else:
        row.update(model="gpt2_350m widths", blocks=PO_BLOCKS,
                   rows=PIPE_ROWS, seq=TRAIN_T, micro_batches=PIPE_MICRO,
                   dtype="bfloat16")
    ob = r0["onebit"]
    tied_ok = _tied_digests_agree(ranks, "onebit")
    rep_ok = _replicated_agree(ranks, "onebit")
    row.update(losses=ob["losses"], groups=ob["groups"],
               tied_equal_every_step=tied_ok,
               replicated_equal_every_step=rep_ok,
               tied_holders=ob["tied_holders"],
               errors_by_rank=[r["onebit"]["errors"] for r in ranks])
    if fault:
        emit(row)
        broken = not tied_ok if fault == "tied_in_body" else not rep_ok
        row["fault_caught"] = broken
        return row
    nb = r0["nobias"]
    warm = max(abs(a - b) / abs(b) for a, b in
               zip(ob["losses"][:PO_FREEZE + 1], nb["losses"]))
    walls = [max(r["onebit"]["walls"][i] for r in ranks)
             for i in range(PO_STEPS)]
    row.update(nobias_losses=nb["losses"], warmup_loss_max_rel=warm,
               warmup_rtol=PO_WARMUP_RTOL, freeze_step=PO_FREEZE,
               eps=OB_EPS, warmup_step_ms=walls[PO_FREEZE - 1] * 1e3,
               compressed_step_p50_ms=statistics.median(
                   walls[PO_FREEZE:]) * 1e3,
               wire_compressed_step=ob["bytes"][-1],
               wire_warmup_step=ob["bytes"][0],
               launches_by_rank=[r["onebit"]["launches"] for r in ranks])
    emit(row)
    if warm > PO_WARMUP_RTOL:
        fail(f"{name}: warmup {ob['losses'][:PO_FREEZE + 1]} vs Adam "
             f"without bias correction {nb['losses']} beyond rtol "
             f"{PO_WARMUP_RTOL}")
    if not all(np.isfinite(ob["losses"])) or \
            not ob["losses"][-1] < ob["losses"][0]:
        fail(f"{name}: losses {ob['losses']} not finite and falling")
    if not tied_ok or (tp and not rep_ok):
        fail(f"{name}: shared copies diverged (tied {tied_ok}, "
             f"model-replicated {rep_ok})")
    if not all(e > 0 for r in ranks for e in r["onebit"]["errors"]):
        fail(f"{name}: an error buffer is zero after the freeze")
    blocks = (PTO_BLOCKS if tp else PO_BLOCKS) // 2
    micro = PIPE_TP_MICRO if tp else PIPE_MICRO
    for r in ranks:
        per = blocks * micro * PO_STEPS * len(r["onebit"]["stages"])
        want = {"K1": per, "K2": per, "K3": per, "K4": 0}
        if r["onebit"]["launches"] != want:
            fail(f"{name} launches {r['onebit']['launches']} != {want}")
    return row


def phase_train_pipe_tp_onebit(torch, fault=None):
    return phase_train_pipe_onebit(torch, fault=fault, tp=True)


def phase_f5(torch, lap):
    """Phases 29-32: 29-31 from one world of two processes
    (``_f5_data_worker``), then 32; ``lap`` names each world's wall.
    Returns the rows by phase."""
    ranks, _ = _spawn_tp(torch, "f5_data", _f5_spec(), world=F5_WORLD)
    rows = {"train_qcomm": phase_train_qcomm(
        torch, [r["train_qcomm"] for r in ranks]),
        "train_onebit": phase_train_onebit(
            torch, [r["train_onebit"] for r in ranks]),
        "train_pipe_onebit": phase_train_pipe_onebit(
            torch, ranks=[r["train_pipe_onebit"] for r in ranks])}
    lap("train_qcomm+onebit+pipe_onebit")
    rows["train_pipe_tp_onebit"] = phase_train_pipe_tp_onebit(torch)
    lap("train_pipe_tp_onebit")
    return rows


def phase_f5_faults(torch):
    """Phases 31 and 32 under their planted faults: each must break its
    equality gate (``--f5-faults``)."""
    rows = [phase_train_pipe_onebit(torch, fault=F5_FAULTS[
                "train_pipe_onebit"]),
            phase_train_pipe_tp_onebit(torch, fault=F5_FAULTS[
                "train_pipe_tp_onebit"])]
    emit({"phase": "f5_faults", "caught": {r["phase"]: r["fault_caught"]
                                           for r in rows}})
    if not all(r["fault_caught"] for r in rows):
        fail(f"f5_faults: a planted fault passed its gate: "
             f"{[(r['phase'], r['fault']) for r in rows]}")


# ---------------------------------------------------------------------------
# F6: BERT at a model axis; GPT-2's scan_layers and loss_chunk at model 2
# (the latter two in train_tp's and serve_tp's worlds)
# ---------------------------------------------------------------------------

BERT_TP_B = 8                      # train_bert_sparse's row at 8 x 512
BERT_TP_LAYERS = 6                 # depth cut from 24 (PERF.md section 4)
BERT_TP_FLASH_LAYERS = 2
BERT_TP_WARMUP, BERT_TP_STEPS = 1, 3
BERT_TP_HEADS = BERT_H // TP_WORLD
TP_SCAN_STEPS = 3                  # the scan_layers / loss_chunk runs
TP_SCAN_CHUNK = 256                # loss_chunk: 4 chunks of a 1024 row


def _bert_tp_model(torch, dropout, mpu=None, sparse=True,
                   layers=BERT_TP_LAYERS):
    """BERT-Large's widths at ``layers`` layers from seed 0 (bf16, the
    encoder and its attention in fp32): the Fixed sparse core of
    ``train_bert_sparse`` (K7/K8), or the flash core (K1-K3 with the
    padding mask as a key bias); with ``mpu`` this rank's shard."""
    from deepspeed_tpu_torch.models.bert import BertForMaskedLM, bert_large
    from deepspeed_tpu_torch.ops import sparse_attention as sc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cfg = bert_large(dtype=torch.bfloat16, use_flash_attention=not sparse,
                     sparse_attention=_bert_sparsity(sc) if sparse else None,
                     num_hidden_layers=layers, hidden_dropout_prob=dropout,
                     attention_probs_dropout_prob=dropout)
    return BertForMaskedLM(cfg, device="cuda", generator=gen, mpu=mpu)


def _bert_tp_config(mesh_shape=None):
    cfg = {"train_batch_size": BERT_TP_B, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
           "steps_per_print": 10 ** 9}
    if mesh_shape:
        cfg["mesh"] = mesh_shape
    return cfg


def _bert_tp_batch(masked):
    """The first 8 rows of ``train_bert_sparse``'s batch; ``masked`` adds
    a key padding mask (each row keeps at least half its keys)."""
    batch = {k: v[:BERT_TP_B] for k, v in _bert_batch(BERT_VOCAB).items()}
    if masked:
        rng = np.random.default_rng(1)
        batch["attention_mask"] = (np.arange(BERT_T)[None] < rng.integers(
            BERT_T // 2, BERT_T + 1, (BERT_TP_B, 1))).astype(np.int32)
    return batch


def _rel_l2_to(torch, engine, ref, tp):
    """Relative L2 of the engine's masters against the whole ``ref``
    masters (split leaves summed over the model group, a replicated leaf
    counted on rank 0)."""
    from deepspeed_tpu_torch.parallel import collectives as C
    from deepspeed_tpu_torch.parallel.tensor_parallel import shard_tensor
    sq = torch.zeros(2, dtype=torch.float64, device="cuda")
    for name, p, s in zip(engine._param_names(), engine.params,
                          engine._tp_specs):
        if tp is not None and s is None and tp.rank != 0:
            continue
        want = ref[name] if tp is None else \
            shard_tensor(ref[name], s, tp.rank, tp.size)
        want = want.cuda()
        sq[0] += (p.detach().double() - want.double()).square().sum()
        sq[1] += want.double().square().sum()
    if tp is not None:
        C.all_reduce(sq, tp)
    return float((sq[0] / sq[1]).sqrt())


def _recorded_sparse_calls():
    """Note each call of the sparse core's kernel entry (its dropout
    coordinates); returns ``(calls, restore)``."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        sparse_self_attention as ssa)
    calls = []
    orig = ssa.block_sparse_attention

    def rec(q, *args, **kw):
        if kw.get("dropout_rate", 0.0) > 0.0:
            calls.append([q.shape[0], q.shape[2], q.shape[1],
                          int(kw["dropout_seed"]),
                          int(kw.get("dropout_head_offset", 0)),
                          kw.get("dropout_num_heads")])
        return orig(q, *args, **kw)

    ssa.block_sparse_attention = rec

    def restore():
        ssa.block_sparse_attention = orig
    return calls, restore


def _bert_tp_worker(torch, spec, groups, rank):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.parallel import collectives as C
    tp = groups.axis("model")
    counters = _sparse_counters()
    mesh_shape = {"model": TP_WORLD}
    steps = BERT_TP_WARMUP + BERT_TP_STEPS
    out = {"rank": rank}
    torch.cuda.reset_peak_memory_stats()
    model = _bert_tp_model(torch, 0.0, groups)
    engine, _, _, _ = initialize(model=model, config=_bert_tp_config(
        mesh_shape), mpu=groups)
    bsa = _bsa()
    bsa._xla_impl.calls = 0
    losses, walls, launches, counts = _tp_train_run(
        torch, engine, _bert_tp_batch(False), steps, counters, C)
    out.update(losses=losses, walls=walls, launches=launches,
               collectives_last_step=counts, gather_calls=bsa._xla_impl.calls,
               peak=torch.cuda.max_memory_allocated(),
               local_heads=engine.module.bert.layer[0].local_heads,
               master_rel_l2=_rel_l2_to(torch, engine, torch.load(
                   spec["ref_sparse"]), tp))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    # one step at dropout 0.1: the sparse core's dropout coordinates
    calls, restore = _recorded_sparse_calls()
    try:
        model = _bert_tp_model(torch, 0.1, groups)
        engine, _, _, _ = initialize(model=model, config=_bert_tp_config(
            mesh_shape), mpu=groups)
        out["dropout_loss"] = float(engine.train_batch(_bert_tp_batch(
            False)))
    finally:
        restore()
    out["dropout_calls"] = calls
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    # the flash core (K1-K3 with the key bias) at 2 layers
    model = _bert_tp_model(torch, 0.0, groups, sparse=False,
                           layers=BERT_TP_FLASH_LAYERS)
    engine, _, _, _ = initialize(model=model, config=_bert_tp_config(
        mesh_shape), mpu=groups)
    f_losses, f_walls, f_launches, _ = _tp_train_run(
        torch, engine, _bert_tp_batch(True), steps, counters)
    out.update(flash_losses=f_losses, flash_walls=f_walls,
               flash_launches=f_launches,
               flash_master_rel_l2=_rel_l2_to(torch, engine, torch.load(
                   spec["ref_flash"]), tp))
    del engine, model
    torch.cuda.empty_cache()
    return out


def _bert_tp_kernel_checks(torch):
    """K7, K8a and K8b at a model rank's shape (8 of 16 heads, the
    global head count 16, the rank's first head as the offset, dropout
    0.1): against their plain versions, and bit for bit equal to the
    16-head launches at those heads."""
    from deepspeed_tpu_torch.ops import sparse_attention as sc
    bsa = _bsa()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    layout = _bert_sparsity(sc).make_layout(BERT_T)
    hl = BERT_TP_HEADS
    cases = [_sparse_case(torch, bsa, BERT_TP_B, BERT_T, hl, BERT_D,
                          "float32", BERT_BLOCK, layout[r * hl:(r + 1) * hl],
                          False, 0.1, gen, head_offset=r * hl,
                          num_heads=BERT_H) for r in range(TP_WORLD)]
    q, k, v, g, _ = _attn_inputs(torch, BERT_TP_B, BERT_T, BERT_H, BERT_D,
                                 torch.float32, False, gen)
    kw = dict(dropout_rate=0.1, dropout_seed=SPARSE_SEED)

    def launch(qq, kk, vv, gg, lay, **extra):
        lut, nnz, lut_t, nnz_t = bsa.layout_tables(lay, "cuda")
        out, lse = bsa.block_sparse_attention_fwd(qq, kk, vv, lut, nnz,
                                                  BERT_BLOCK, **kw, **extra)
        delta = (gg * out).sum(-1).permute(0, 2, 1).reshape(
            -1, BERT_T).contiguous()
        dq = bsa.block_sparse_attention_bwd_dq(
            qq, kk, vv, gg, lse, delta, lut, nnz, BERT_BLOCK, **kw, **extra)
        dk, dv = bsa.block_sparse_attention_bwd_dkv(
            qq, kk, vv, gg, lse, delta, lut_t, nnz_t, BERT_BLOCK, **kw,
            **extra)
        return out, dq, dk, dv

    whole = launch(q, k, v, g, layout)
    sliced_equal = True
    for r in range(TP_WORLD):
        sl = slice(r * hl, (r + 1) * hl)
        mine = launch(*(x[:, :, sl].contiguous() for x in (q, k, v, g)),
                      layout[sl], dropout_head_offset=r * hl,
                      dropout_num_heads=BERT_H)
        sliced_equal = sliced_equal and all(
            bool(torch.equal(a, b[:, :, sl])) for a, b in zip(mine, whole))
    torch.cuda.synchronize()
    return cases, sliced_equal


def phase_train_bert_tp(torch):
    """BERT-Large's widths at model 2: two processes on ``cuda:0`` over
    gloo (module docstring, phase 33)."""
    import tempfile
    from deepspeed_tpu_torch import initialize
    counters = _sparse_counters()
    steps = BERT_TP_WARMUP + BERT_TP_STEPS
    cases, sliced_equal = _bert_tp_kernel_checks(torch)
    tmp = tempfile.mkdtemp(prefix="bert_tp_ref_")
    ref = {}
    for name, sparse, layers, masked in (
            ("sparse", True, BERT_TP_LAYERS, False),
            ("flash", False, BERT_TP_FLASH_LAYERS, True)):
        torch.cuda.reset_peak_memory_stats()
        engine, _, _, _ = initialize(
            model=_bert_tp_model(torch, 0.0, sparse=sparse, layers=layers),
            config=_bert_tp_config())
        losses, walls, launches, _ = _tp_train_run(
            torch, engine, _bert_tp_batch(masked), steps, counters)
        path = os.path.join(tmp, f"{name}.pt")
        torch.save({n: p.detach().float().cpu() for n, p in
                    zip(engine._param_names(), engine.params)}, path)
        ref[name] = {"losses": losses, "walls": walls, "launches": launches,
                     "peak": torch.cuda.max_memory_allocated(),
                     "path": path}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    calls1, restore = _recorded_sparse_calls()
    try:
        engine, _, _, _ = initialize(model=_bert_tp_model(torch, 0.1),
                                     config=_bert_tp_config())
        ref_drop_loss = float(engine.train_batch(_bert_tp_batch(False)))
    finally:
        restore()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = _spawn_tp(torch, "train_bert_tp", {
        "mesh": {"model": TP_WORLD}, "ref_sparse": ref["sparse"]["path"],
        "ref_flash": ref["flash"]["path"]})
    for r in ref.values():
        os.remove(r["path"])
    coords_ok = len(calls1) == BERT_TP_LAYERS
    for r, res in enumerate(ranks):
        calls = res["dropout_calls"]
        coords_ok = coords_ok and len(calls) == len(calls1) and all(
            got[1] == BERT_TP_HEADS and got[3] == want[3] and
            got[4] == want[4] + r * BERT_TP_HEADS and got[5] == BERT_H
            for got, want in zip(calls, calls1))
    timed = [max(r["walls"][i] for r in ranks)
             for i in range(BERT_TP_WARMUP, steps)]
    row = {"phase": "train_bert_tp", "model": "bert_large",
           "layers": BERT_TP_LAYERS, "layers_cut_from": 24,
           "batch": BERT_TP_B, "seq": BERT_T, "dtype": "bfloat16",
           "encoder_dtype": "float32", "attention": "block-sparse (K7/K8)",
           "mesh": {"model": TP_WORLD}, "processes": TP_WORLD,
           "device": "cuda:0", "backend": "gloo (CUDA tensors, one device)",
           "model1_losses": ref["sparse"]["losses"],
           "losses": ranks[0]["losses"],
           "losses_by_rank_equal": all(r["losses"] == ranks[0]["losses"]
                                       for r in ranks),
           "first_loss_rtol": TP_LOSS_RTOL,
           "master_rel_l2": ranks[0]["master_rel_l2"],
           "master_rel_l2_limit": TP_MASTER_REL_L2,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "model1_step_p50_ms": statistics.median(
               ref["sparse"]["walls"][BERT_TP_WARMUP:]) * 1e3,
           "peak_memory_by_rank": [r["peak"] for r in ranks],
           "model1_peak_memory": ref["sparse"]["peak"],
           "launches_by_rank": [r["launches"] for r in ranks],
           "model1_launches": ref["sparse"]["launches"],
           "gather_route_calls": [r["gather_calls"] for r in ranks],
           "local_heads": [r["local_heads"] for r in ranks],
           "collectives_a_step": ranks[0]["collectives_last_step"],
           "dropout_loss_model1": ref_drop_loss,
           "dropout_loss": ranks[0]["dropout_loss"],
           "dropout_coordinates_global": coords_ok,
           "kernels_at_rank_shape": cases,
           "rank_heads_equal_whole_launch_bitwise": sliced_equal,
           "flash": {"layers": BERT_TP_FLASH_LAYERS,
                     "attention": "flash (K1-K3, key bias)",
                     "model1_losses": ref["flash"]["losses"],
                     "losses": ranks[0]["flash_losses"],
                     "master_rel_l2": ranks[0]["flash_master_rel_l2"],
                     "launches_by_rank": [r["flash_launches"]
                                          for r in ranks]}}
    emit(row)
    fl = row["flash"]
    for what, got, want in (
            ("sparse", row["losses"], row["model1_losses"]),
            ("flash", fl["losses"], fl["model1_losses"]),
            ("dropout", [row["dropout_loss"]], [ref_drop_loss])):
        if not all(np.isfinite(got)) or not abs(got[0] - want[0]) <= \
                TP_LOSS_RTOL * abs(want[0]):
            fail(f"train_bert_tp {what}: first loss {got} vs model 1 "
                 f"{want}: beyond rtol {TP_LOSS_RTOL}")
    if not row["losses_by_rank_equal"]:
        fail("train_bert_tp: the ranks' losses differ")
    for what, err in (("sparse", row["master_rel_l2"]),
                      ("flash", fl["master_rel_l2"])):
        if not err <= TP_MASTER_REL_L2:
            fail(f"train_bert_tp {what}: masters after {steps} steps "
                 f"{err} (relative L2) from model 1's > {TP_MASTER_REL_L2}")
    n = BERT_TP_LAYERS * steps
    want = {"K7": n, "K8a": n, "K8b": n, "K1": 0, "K2": 0, "K3": 0,
            "K4": steps}
    nf = BERT_TP_FLASH_LAYERS * steps
    want_f = {"K7": 0, "K8a": 0, "K8b": 0, "K1": nf, "K2": nf, "K3": nf,
              "K4": steps}
    if any(r["launches"] != want for r in ranks) or \
            any(r["flash_launches"] != want_f for r in ranks) or \
            any(h != BERT_TP_HEADS for h in row["local_heads"]) or \
            any(row["gather_route_calls"]):
        fail(f"train_bert_tp launches {row['launches_by_rank']} != {want} "
             f"/ flash {fl['launches_by_rank']} != {want_f} a rank, local "
             f"heads {row['local_heads']} or gather-route calls "
             f"{row['gather_route_calls']}")
    if not coords_ok:
        fail("train_bert_tp at dropout 0.1: a rank's sparse calls are not "
             "at its heads' global coordinates")
    if not sliced_equal or not all(c["ok"] for c in cases):
        fail(f"train_bert_tp: K7/K8 at a rank's heads differ from their "
             f"plain versions or from the whole launch "
             f"({[c['max_abs_err'] for c in cases]}, {sliced_equal})")
    return row


def _tp_unrolled_digests(torch, engine):
    """sha256 of each master leaf under its unrolled name (a stacked
    leaf taken apart by layer)."""
    import re as _re
    out = {}
    for name, p in zip(engine._param_names(), engine.params):
        if name.startswith("h.") and not _re.match(r"^h\.\d+\.", name):
            for i, t in enumerate(p.detach().unbind(0)):
                out[f"h.{i}.{name[2:]}"] = _host_digest([t])
        else:
            out[name] = _host_digest([p])
    return out


def _tp_scan_runs(torch, groups, batch, counters, base_losses, base_digests):
    """``train_tp_scan`` in train_tp's world: the 350M row stacked
    (``scan_layers``) for ``TP_SCAN_STEPS`` steps against the unrolled
    run's first steps, then stacked with ``loss_chunk``."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import with_layout
    from deepspeed_tpu_torch.parallel import collectives as C
    out = {}
    for name, chunk in (("scan", 0), ("scan_chunk", TP_SCAN_CHUNK)):
        model = with_layout(_tp_350m(torch, 0.0, groups), True)
        model.config = dataclasses.replace(model.config, loss_chunk=chunk)
        torch.cuda.reset_peak_memory_stats()
        engine, _, _, _ = initialize(model=model, config=_tp_config(
            {"model": TP_WORLD}), mpu=groups)
        losses, walls, launches, counts = _tp_train_run(
            torch, engine, batch, TP_SCAN_STEPS, counters, C)
        out[name] = {"losses": losses, "walls": walls, "launches": launches,
                     "peak": torch.cuda.max_memory_allocated(),
                     "collectives_last_step": counts}
        if name == "scan":
            out[name]["losses_equal_unrolled"] = \
                losses == base_losses[:TP_SCAN_STEPS]
            out[name]["masters_equal_unrolled"] = \
                _tp_unrolled_digests(torch, engine) == base_digests
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_scan_row(torch, ranks, ref_losses, ref_p50_ms):
    res = [r["scan"] for r in ranks]
    row = {"phase": "train_tp_scan", "model": "gpt2_350m",
           "layers": TP_LAYERS, "mesh": {"model": TP_WORLD},
           "processes": TP_WORLD, "device": "cuda:0", "world": "train_tp's",
           "steps": TP_SCAN_STEPS, "loss_chunk": TP_SCAN_CHUNK,
           "scan_losses": res[0]["scan"]["losses"],
           "unrolled_losses": ranks[0]["losses"][:TP_SCAN_STEPS],
           "model1_losses": ref_losses[:TP_SCAN_STEPS],
           "scan_losses_equal_unrolled_by_rank": [
               r["scan"]["losses_equal_unrolled"] for r in res],
           "scan_masters_equal_unrolled_by_rank": [
               r["scan"]["masters_equal_unrolled"] for r in res],
           "chunked_losses": res[0]["scan_chunk"]["losses"],
           "chunked_first_loss_rtol": TP_LOSS_RTOL,
           "model1_unrolled_step_p50_ms": ref_p50_ms,
           "scan_step_p50_ms": statistics.median(
               max(r["scan"]["walls"][i] for r in res)
               for i in range(1, TP_SCAN_STEPS)) * 1e3,
           "chunked_step_p50_ms": statistics.median(
               max(r["scan_chunk"]["walls"][i] for r in res)
               for i in range(1, TP_SCAN_STEPS)) * 1e3,
           "peak_memory_by_rank": {n: [r[n]["peak"] for r in res]
                                   for n in ("scan", "scan_chunk")},
           "collectives_a_step": {n: res[0][n]["collectives_last_step"]
                                  for n in ("scan", "scan_chunk")},
           "launches_by_rank": [{n: r[n]["launches"] for n in
                                 ("scan", "scan_chunk")} for r in res]}
    emit(row)
    if not all(row["scan_losses_equal_unrolled_by_rank"]) or \
            not all(row["scan_masters_equal_unrolled_by_rank"]):
        fail("train_tp_scan: the stacked model's losses or masters differ "
             "from the unrolled model's at model 2")
    chunked, whole = row["chunked_losses"], row["unrolled_losses"]
    if not all(np.isfinite(chunked)) or not abs(chunked[0] - whole[0]) <= \
            TP_LOSS_RTOL * abs(whole[0]):
        fail(f"train_tp_scan: chunked losses {chunked} vs whole-vocab "
             f"{whole}: first beyond rtol {TP_LOSS_RTOL}")
    want = {"K1": TP_LAYERS * TP_SCAN_STEPS, "K2": TP_LAYERS * TP_SCAN_STEPS,
            "K3": TP_LAYERS * TP_SCAN_STEPS, "K4": TP_SCAN_STEPS}
    if any(lr[n] != want for lr in row["launches_by_rank"]
           for n in ("scan", "scan_chunk")):
        fail(f"train_tp_scan launches {row['launches_by_rank']} != {want}")
    return row


def phase_train_tp_scan(torch):
    """``train_tp``'s world, which also runs the stacked and chunked
    models (its row and ``train_tp_scan``'s)."""
    return phase_train_tp(torch)


def phase_serve_tp_scan(torch):
    """``serve_tp``'s world, which also serves the stacked model (its row
    and ``serve_tp_scan``'s)."""
    return phase_serve_tp(torch)


# ---------------------------------------------------------------------------
# resilience in the training engine: guards, the hot tier, preemption and
# the restore ladder (GPT-2 125M, in a child process)
# ---------------------------------------------------------------------------

RES_B, RES_T = 8, 512
RES_STEPS = 5                      # the clean loss curve
RES_PREEMPT_AT = 3


def _res_engine(torch, seed, rz, extra=None):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_125m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = GPT2LMHead(gpt2_125m(n_positions=RES_T, dropout=0.0,
                                 use_flash_attention=True),
                       device="cuda", generator=gen)
    engine, _, _, _ = initialize(model=model, seed=seed, config={
        "train_batch_size": RES_B, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
        "steps_per_print": 10 ** 9, "resilience": rz, **(extra or {})})
    return engine


def _res_batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 50257, (RES_B, RES_T))
             .astype(np.int32)} for _ in range(RES_STEPS)]


def _resilience_child(torch, out_path):
    """Every resilience gate's readings, in this (child) process: the
    SIGTERM that ``simulate_preemption`` delivers stays here."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.runtime.resilience import (
        PreemptedError, fault_injection as fi)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="resilience_")
    bs = _res_batches()
    counters = _flash_counters()
    for c in counters.values():
        c.launches = 0
    res = {}

    def digest(engine):
        return _host_digest(engine.params)

    def run(engine, idx):
        return [float(engine.train_batch(bs[i])) for i in idx]

    # the clean curve, and its masters after 2 steps
    clean = _res_engine(torch, 0, {})
    res["clean_losses"] = run(clean, [0, 1])
    clean2 = digest(clean)
    res["clean_losses"] += run(clean, range(2, RES_STEPS))
    del clean
    # a planted NaN gradient at step 1, skipped; a clean run of 0, 2
    fi.clear_faults()
    eng = _res_engine(torch, 0, {
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "skip_step"}}})
    fi.inject_nan_grads([1])
    res["nan_losses"] = run(eng, [0, 1, 2])
    res["nan_skipped"] = int(eng._last_metrics["skipped_steps"])
    res["nan_trips"] = eng._last_metrics["health/nan_trips"]
    nan_digest = digest(eng)
    del eng
    eng = _res_engine(torch, 0, {})
    run(eng, [0, 2])
    res["nan_skip_equals_clean_skipping_it"] = digest(eng) == nan_digest
    del eng
    # the hot tier: a rollback from RAM, then a fresh engine from the mirror
    hot_dir, mirror = os.path.join(root, "hot_disk"), \
        os.path.join(root, "mirror")
    hot = {"enabled": True, "interval_steps": 2, "mirror_dir": mirror}
    fi.clear_faults()
    eng = _res_engine(torch, 0, {
        "save_dir": hot_dir, "hot_checkpoint": hot,
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "rollback_to_checkpoint"}}})
    run(eng, [0, 1])
    res["hot_snapshot"] = dict(eng.last_hot_snapshot)
    at2 = digest(eng)
    fi.inject_nan_grads([2])
    run(eng, [2])
    res["rollback"] = {"global_steps": eng.global_steps,
                       **eng.last_recovery,
                       "masters_equal_snapshot": digest(eng) == at2}
    eng._hot_store.wait()
    eng._hot_store.close()
    del eng
    fi.clear_faults()
    eng = _res_engine(torch, 5, {"save_dir": hot_dir, "auto_resume": True,
                                 "hot_checkpoint": hot})
    res["mirror"] = {"global_steps": eng.global_steps,
                     **(eng.last_recovery or {}),
                     "masters_equal_snapshot": digest(eng) == at2}
    eng._hot_store.close()
    del eng
    # preemption: a real SIGTERM at step 3, the checkpoint, the raise
    ckpt = os.path.join(root, "ckpt")
    eng = _res_engine(torch, 0, {
        "save_dir": ckpt, "save_interval_steps": 2,
        "preemption": {"save_on_sigterm": True},
        "fault_injection": {"enabled": True}})
    fi.simulate_preemption(RES_PREEMPT_AT)
    losses = []
    res["preempted"] = None
    try:
        for i in range(RES_STEPS):
            losses.append(float(eng.train_batch(bs[i])))
    except PreemptedError as e:
        res["preempted"] = {"global_steps": eng.global_steps,
                            "path": e.checkpoint_path, "code": e.code,
                            "isdir": os.path.isdir(e.checkpoint_path or "")}
    eng._preemption.uninstall()
    t0 = time.perf_counter()
    eng.save_checkpoint(os.path.join(root, "timed"))
    res["disk_save_ms"] = (time.perf_counter() - t0) * 1e3
    res["disk_bytes"] = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in
        os.walk(os.path.join(root, "timed")) for f in fs)
    del eng
    # a fresh engine, another seed, auto_resume: the curve goes on
    eng = _res_engine(torch, 123, {"save_dir": ckpt, "auto_resume": True})
    res["resume"] = {"global_steps": eng.global_steps,
                     **(eng.last_recovery or {})}
    losses += run(eng, range(eng.global_steps, RES_STEPS))
    res["preempt_resume_losses"] = losses
    del eng
    # the newest checkpoint torn: the ladder loads the one before it
    newest = os.path.join(ckpt, f"global_step{RES_PREEMPT_AT}", "state",
                          "params")
    victim = sorted(os.path.join(d, f) for d, _, fs in os.walk(newest)
                    for f in fs)[0]
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    eng = _res_engine(torch, 9, {"save_dir": ckpt, "auto_resume": True})
    res["fallback"] = {"global_steps": eng.global_steps,
                       **(eng.last_recovery or {}),
                       "masters_equal_clean": digest(eng) == clean2}
    del eng
    res["launches"] = {n: c.launches for n, c in counters.items()}
    shutil.rmtree(root, ignore_errors=True)
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def phase_train_resilience(torch):
    """The training engine's resilience (module docstring, phase 34), in
    a child process of this script."""
    import tempfile
    out = os.path.join(tempfile.mkdtemp(prefix="res_"), "res.json")
    with open(out + ".err", "w+") as err:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--resilience-worker", out], stdout=subprocess.DEVNULL,
            stderr=err, timeout=TP_SPAWN_TIMEOUT_S)
        if proc.returncode != 0:
            err.seek(0)
            fail(f"train_resilience: the child exited {proc.returncode}:\n"
                 f"{err.read()[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    # the steps that ran a forward and backward: 5 clean, 3 + 2 NaN, 3 hot,
    # 3 preempted, 2 resumed
    steps = RES_STEPS + 5 + 3 + RES_PREEMPT_AT + (RES_STEPS - RES_PREEMPT_AT)
    row = {"phase": "train_resilience", "model": "gpt2_125m",
           "batch": RES_B, "seq": RES_T, "dtype": "bfloat16",
           "attention": "flash (K1-K3)", "process": "child", **res}
    emit(row)
    pre, back = res["preempted"], res["rollback"]
    checks = {
        "nan skipped and equal to a clean run without that batch":
            res["nan_skip_equals_clean_skipping_it"] and
            res["nan_skipped"] == 1 and res["nan_trips"] == 1,
        "rollback from hot RAM bit for bit":
            back["tier"] == "hot_ram" and back["global_steps"] == 2 and
            back["masters_equal_snapshot"],
        "auto_resume from the hot mirror bit for bit":
            res["mirror"].get("tier") == "hot_mirror" and
            res["mirror"]["global_steps"] == 2 and
            res["mirror"]["masters_equal_snapshot"],
        "SIGTERM: PreemptedError with a checkpoint":
            pre is not None and pre["global_steps"] == RES_PREEMPT_AT and
            pre["isdir"] and pre["code"] == 0,
        "auto_resume continues the loss curve bit for bit":
            res["resume"].get("tier") == "disk" and
            res["resume"]["global_steps"] == RES_PREEMPT_AT and
            res["preempt_resume_losses"] == res["clean_losses"],
        "a torn newest checkpoint falls back to the one before":
            res["fallback"].get("tier") == "disk" and
            res["fallback"]["global_steps"] == 2 and
            res["fallback"]["masters_equal_clean"],
        "K1-K4 launched every step":
            res["launches"] == {"K1": 12 * steps, "K2": 12 * steps,
                                "K3": 12 * steps, "K4": steps}}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"train_resilience: {bad}")
    return row


# ---------------------------------------------------------------------------
# phase 35: telemetry on the training step
# ---------------------------------------------------------------------------

TEL_STEPS = 8                      # a run's steps: 2 warmup, 2 timed, the
TEL_WINDOW = (4, 2)                # 2-step trace window, 2 timed
TEL_TIMED = (2, 3, 6, 7)           # the steps whose walls give the p50
WD_MIN_DEADLINE_S = 1.0            # the watchdog child's deadline floor
WD_HANG_S = 3.0                    # its injected hang: 3 deadlines
WD_STEPS = 4                       # fast steps before the hang
# the kernels each wrapper launches, by their __global__ names
TEL_KERNELS = {"K1": ("fwd_wgmma_kernel", "fwd_kernel"),
               "K2": ("dq_wgmma_kernel", "dq_kernel"),
               "K3": ("dkv_wgmma_kernel", "dkv_kernel"),
               "K4": ("adam_kernel",)}


def _tel_run(torch, tele, counters, trace_dir=None):
    """``TEL_STEPS`` steps of GPT-2 350M (the ``train`` row) from seed 0,
    with the ``telemetry`` block (and a trace window) when ``tele`` is a
    path, without when it is None. Returns the losses, the step walls,
    the launches of the run and those of the trace window."""
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 50257, (TRAIN_B, TRAIN_T))
             .astype(np.int32)}
    extra = {}
    if tele is not None:
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config
        fpt = model_flops_per_token(GPT2Config(
            n_embd=1024, n_layer=TRAIN_LAYERS, n_head=16,
            n_positions=TRAIN_T), TRAIN_T)
        extra = {"telemetry": {"enabled": True, "jsonl_path": tele,
                               "flops_per_token": fpt},
                 "profiling": {"trace_dir": trace_dir,
                               "trace_start_step": TEL_WINDOW[0],
                               "trace_num_steps": TEL_WINDOW[1]}}
    engine = _train_engine(torch, True, extra)
    for c in counters.values():
        c.launches = 0
    losses, walls, window = [], [], {}
    for i in range(TEL_STEPS):
        if i == TEL_WINDOW[0]:
            window = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
        if i == sum(TEL_WINDOW) - 1:
            window = {n: c.launches - window[n] for n, c in counters.items()}
    launches = {n: c.launches for n, c in counters.items()}
    traces = list(engine.trace_profiler.traces)
    history = list(engine.metrics_history)
    if engine.telemetry is not None:
        engine.telemetry.close()
    del engine
    torch.cuda.empty_cache()
    return losses, walls, launches, window, traces, history


def _trace_readings(path):
    """{K: kernels of the K's wrapper} and the span ranges in a Chrome
    trace written by ``TraceProfiler``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = dict.fromkeys(TEL_KERNELS, 0)
    spans = {}
    for e in events:
        name = e.get("name") or ""
        if e.get("cat") == "kernel":
            m = re.search(r"\(anonymous namespace\)::(\w+)", name)
            for key, fns in TEL_KERNELS.items():
                if m is not None and m.group(1) in fns:
                    kernels[key] += 1
        elif name.startswith("ds_tpu/") and \
                e.get("cat") != "gpu_user_annotation":
            spans[name] = spans.get(name, 0) + 1
    return kernels, spans, len(events)


def _telemetry_child(torch, mode, out_path):
    """The watchdog and cache readings, in this (child) process: ``dump``
    and ``abort`` train GPT-2 125M (8 x 512, bf16, flash) with the
    watchdog armed and a hang injected at step ``WD_STEPS``; ``cold`` /
    ``warm`` train it with dense attention (only K4's library to build)
    one step with ``compilation_cache_dir`` at the directory in
    ``out_path``'s."""
    import contextlib
    import io
    import resource
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.runtime.resilience import fault_injection as fi
    from deepspeed_tpu_torch.telemetry import cli, uninstall_crash_hooks
    from deepspeed_tpu_torch.telemetry.flight import read_dump
    # the abort ends this process by SIGABRT: no core file
    resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = json.loads(open(out_path + ".spec").read())
    root = spec["dir"]
    res = {}
    if mode in ("cold", "warm"):
        from deepspeed_tpu_torch import initialize
        from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_125m
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        model = GPT2LMHead(gpt2_125m(n_positions=RES_T, dropout=0.0,
                                     use_flash_attention=False),
                           device="cuda", generator=gen)
        engine, _, _, _ = initialize(model=model, config={
            "train_batch_size": RES_B, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
            "steps_per_print": 10 ** 9, "compilation_cache_dir": root,
            "telemetry": {"enabled": True}})
        loss = float(engine.train_batch(_res_batches()[0]))
        comp = engine.telemetry.events.recent(event="compile")[0]
        res = {"loss": loss, "compile": comp,
               "build_info": {k: v["seconds"]
                              for k, v in _build.build_info.items()},
               "files": sorted(os.listdir(root))}
        engine.telemetry.close()
    else:
        log = os.path.join(root, "run.jsonl")
        fi.clear_faults()
        engine = _res_engine(
            torch, 0, {"fault_injection": {"enabled": True}}, extra={
                "telemetry": {
                    "enabled": True, "jsonl_path": log,
                    "crash_dump_dir": root,
                    "watchdog": {"enabled": True, "deadline_factor": 3.0,
                                 "min_deadline_s": WD_MIN_DEADLINE_S,
                                 "action": mode}}})
        bs = _res_batches()
        for i in range(WD_STEPS):
            engine.train_batch(bs[i % len(bs)])
        fi.inject_hang(at_step=WD_STEPS, seconds=WD_HANG_S)
        t0 = time.perf_counter()
        engine.train_batch(bs[0])
        res["hang_step_s"] = time.perf_counter() - t0
        wd = engine.telemetry.watchdog
        res["fired"] = list(wd.fired)
        engine.telemetry.close()
        uninstall_crash_hooks()
        with open(log) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
        res["watchdog_events"] = [e for e in events
                                  if e["event"] == "watchdog"]
        dumps = sorted(f for f in os.listdir(root)
                       if f.startswith("flight-") and "watchdog" in f)
        res["dumps"] = dumps
        if dumps:
            dump = read_dump(os.path.join(root, dumps[0]))
            res["in_flight"] = dump["in_flight_phases"]
            res["collectives"] = dump["collectives"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res["postmortem_rc"] = cli.main(
                    ["postmortem", os.path.join(root, dumps[0])])
            res["postmortem"] = buf.getvalue()
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def _spawn_telemetry_child(mode, root):
    """One ``--telemetry-worker`` child on ``root``: (exit code, its
    readings or None, the tail of its stderr, wall seconds)."""
    import tempfile
    out = os.path.join(tempfile.mkdtemp(prefix="tel_"), "res.json")
    with open(out + ".spec", "w") as f:
        json.dump({"dir": root}, f)
    t0 = time.perf_counter()
    with open(out + ".err", "w+") as err:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--telemetry-worker", mode, out], stdout=subprocess.DEVNULL,
            stderr=err, timeout=TP_SPAWN_TIMEOUT_S)
        err.seek(0)
        tail = err.read()[-3000:]
    wall = time.perf_counter() - t0
    res = None
    if os.path.exists(out):
        with open(out) as f:
            res = json.load(f)
    return proc.returncode, res, tail, wall


def phase_train_telemetry(torch):
    """Telemetry on the training step (module docstring, phase 35)."""
    import shutil
    import signal
    import tempfile
    from deepspeed_tpu_torch.telemetry import cli
    root = tempfile.mkdtemp(prefix="telemetry_")
    log = os.path.join(root, "run.jsonl")
    counters = _flash_counters()
    t_phase = time.perf_counter()
    # (a) telemetry off, then on (with the trace window), same seed
    off = _tel_run(torch, None, counters)
    on = _tel_run(torch, log, counters,
                  trace_dir=os.path.join(root, "trace"))
    off_losses, off_walls, off_launches = off[:3]
    on_losses, on_walls, on_launches, window, traces, history = on
    events = cli.read_events(log)
    steps = [e for e in events if e["event"] == "step"]
    phases_ok = len(steps) == TEL_STEPS and all(
        "dispatch" in e["phases"] and "device_wait" in e["phases"] and
        sum(e["phases"].get(k, 0.0) for k in
            ("data_load", "dispatch", "device_wait")) <= e["wall_s"]
        for e in steps)
    summary = cli.summarize(events, peak_tflops=BF16_PEAK_FLOPS / 1e12)
    emit({"phase": "train_telemetry_summary", "log": "telemetry on",
          **summary})
    # (b) the trace window's kernels and spans
    kernels, spans, n_events = _trace_readings(traces[0]) if traces \
        else ({}, {}, 0)
    # (c) the watchdog, in children: dump, then abort
    wd_root = os.path.join(root, "wd_dump")
    os.makedirs(wd_root)
    rc, dump, dump_err, dump_wall = _spawn_telemetry_child("dump", wd_root)
    ab_root = os.path.join(root, "wd_abort")
    os.makedirs(ab_root)
    ab_rc, _, ab_err, ab_wall = _spawn_telemetry_child("abort", ab_root)
    ab_dumps = [f for f in os.listdir(ab_root)
                if f.startswith("flight-") and "watchdog" in f]
    # (d) compilation_cache_dir: a cold child, then a warm one, one dir
    cache = os.path.join(root, "kernel_cache")
    os.makedirs(cache)
    cold_rc, cold, cold_err, cold_wall = _spawn_telemetry_child(
        "cold", cache)
    warm_rc, warm, warm_err, warm_wall = _spawn_telemetry_child(
        "warm", cache)
    wall = time.perf_counter() - t_phase

    def p50(walls):
        return statistics.median(walls[i] for i in TEL_TIMED) * 1e3

    fired = (dump or {}).get("fired") or []
    row = {"phase": "train_telemetry", "model": "gpt2_350m",
           "batch": TRAIN_B, "seq": TRAIN_T, "dtype": "bfloat16",
           "attention": "flash (K1-K3)", "optimizer": "adam (fused K4)",
           "steps": TEL_STEPS, "off_losses": off_losses,
           "on_losses": on_losses,
           "off_step_p50_ms": p50(off_walls), "on_step_p50_ms": p50(on_walls),
           "off_step_wall_s": off_walls, "on_step_wall_s": on_walls,
           "step_events": len(steps),
           "phases_last_step": steps[-1]["phases"] if steps else None,
           "launches": {n: off_launches[n] + on_launches[n]
                        for n in counters},
           "off_launches": off_launches, "on_launches": on_launches,
           "trace": {"window_steps": list(TEL_WINDOW), "events": n_events,
                     "kernels": kernels, "window_launches": window,
                     "spans": spans},
           "watchdog": {"rc": rc, "wall_s": dump_wall,
                        "min_deadline_s": WD_MIN_DEADLINE_S,
                        "hang_s": WD_HANG_S, "fired": fired,
                        **{k: (dump or {}).get(k) for k in (
                            "hang_step_s", "dumps", "in_flight",
                            "collectives", "postmortem_rc")},
                        "watchdog_events": len(
                            (dump or {}).get("watchdog_events") or []),
                        "abort_rc": ab_rc, "abort_wall_s": ab_wall,
                        "abort_dumps": len(ab_dumps)},
           "cache": {"cold_rc": cold_rc, "warm_rc": warm_rc,
                     "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
                     "cold": cold, "warm": warm},
           "wall_s": wall}
    emit(row)
    postmortem = (dump or {}).get("postmortem") or ""
    want = {"K1": TRAIN_LAYERS * TEL_STEPS, "K2": TRAIN_LAYERS * TEL_STEPS,
            "K3": TRAIN_LAYERS * TEL_STEPS, "K4": TEL_STEPS}
    cc = lambda r: (r or {}).get("compile") or {}   # noqa: E731
    checks = {
        "losses equal bit for bit with telemetry on and off":
            off_losses == on_losses and all(np.isfinite(on_losses)),
        "K1-K4 launched every step of both runs":
            off_launches == want and on_launches == want,
        "every step event has dispatch and device_wait, phases <= wall":
            phases_ok,
        "the trace window's K1-K4 kernels equal the wrappers' launches":
            bool(traces) and kernels == window and all(window.values()),
        "the trace holds the dispatch and device_wait spans":
            spans.get("ds_tpu/dispatch", 0) == TEL_WINDOW[1] and
            spans.get("ds_tpu/device_wait", 0) == TEL_WINDOW[1],
        "the watchdog fired once: this_host_stuck, one dump":
            rc == 0 and len(fired) == 1 and
            fired[0]["verdict"] == "this_host_stuck" and
            len(dump["watchdog_events"]) == 1 and len(dump["dumps"]) == 1,
        "postmortem renders the in-flight dispatch/injected_hang":
            (dump or {}).get("postmortem_rc") == 0 and
            "dispatch/injected_hang" in postmortem and
            (dump or {}).get("in_flight", {}).get("MainThread") ==
            "dispatch/injected_hang",
        "action abort: the child dies by SIGABRT after its dump":
            ab_rc == -signal.SIGABRT and len(ab_dumps) == 1,
        "cold cache: misses >= 1, the libraries in the directory":
            cold_rc == 0 and cc(cold).get("compile_cache_misses", 0) >= 1
            and any(f.endswith(".so") for f in cold["files"]),
        "warm cache: hits, 0 misses, no build, a smaller compile_seconds":
            warm_rc == 0 and cc(warm).get("compile_cache_misses") == 0 and
            cc(warm).get("compile_cache_hits", 0) >= 1 and
            not any(warm["build_info"].values()) and
            cc(warm)["compile_seconds"] < cc(cold)["compile_seconds"]}
    shutil.rmtree(root, ignore_errors=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"train_telemetry: {bad}; children's stderr: "
             f"{dump_err[-800:]} | {ab_err[-400:]} | {cold_err[-400:]} | "
             f"{warm_err[-400:]}")
    row["history"] = len(history)
    return row


SP_MOE_PHASES = [("seq_attention", phase_seq_attention),
                 ("train_pipe_sp", phase_train_pipe_sp),
                 ("train_moe", phase_train_moe),
                 ("train_pipe_tp_moe", phase_train_pipe_tp_moe)]

_TP_WORKERS = {"train_tp": _tp_train_worker, "serve_tp": _tp_serve_worker,
               "train_pipe_tp": _pipe_tp_worker,
               "seq_attention": _seq_attention_worker,
               "train_pipe_sp": _sp_worker, "train_moe": _moe_worker,
               "train_pipe_tp_moe": _ptm_worker,
               "f5_data": _f5_data_worker,
               "train_pipe_onebit": _pipe_onebit_worker,
               "train_pipe_tp_onebit": _pipe_onebit_worker,
               "train_bert_tp": _bert_tp_worker}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel checks")
    parser.add_argument("--turns", metavar="PARENT_CHECKOUT",
                        help="only time every kernel in turns against the "
                             "checkout at this path (the parent commit's; "
                             "its deepspeed_tpu_torch/ is enough)")
    parser.add_argument("--turns-worker", metavar="CHECKOUT",
                        help=argparse.SUPPRESS)   # --turns' other side
    parser.add_argument("--offload-only", action="store_true",
                        help="device, build, then only the ZeRO-Offload "
                             "slice's phases")
    parser.add_argument("--zero-only", action="store_true",
                        help="device, build, then only the train_zero "
                             "phase")
    parser.add_argument("--features-only", action="store_true",
                        help="device, build, then only the training "
                             "features' phases (train_features, "
                             "train_bert_ckpt)")
    parser.add_argument("--pipe-only", action="store_true",
                        help="device, build, then only the pipeline "
                             "phase (train_pipe)")
    parser.add_argument("--tp-only", action="store_true",
                        help="device, build, then only the tensor-"
                             "parallel phases and the pipeline's ZeRO "
                             "compositions (train_tp, serve_tp, "
                             "train_pipe_tp, train_pipe_zero)")
    parser.add_argument("--sp-moe-only", action="store_true",
                        help="device, build, then only the sequence- and "
                             "expert-parallel phases (seq_attention, "
                             "train_pipe_sp, train_moe, "
                             "train_pipe_tp_moe)")
    parser.add_argument("--moe-faults", action="store_true",
                        help="device, build, then only train_moe, with "
                             "expert 2 run again under each planted "
                             "fault (MOE_FAULTS): fails unless a gate "
                             "catches each")
    parser.add_argument("--comm-only", action="store_true",
                        help="device, build, then only the gradient "
                             "compressors' phases (train_qcomm, "
                             "train_onebit, train_pipe_onebit, "
                             "train_pipe_tp_onebit)")
    parser.add_argument("--f5-faults", action="store_true",
                        help="device, build, then train_pipe_onebit and "
                             "train_pipe_tp_onebit each under a planted "
                             "buffer-grouping fault (F5_FAULTS): fails "
                             "unless each breaks its equality gate")
    parser.add_argument("--phases", metavar="NAMES",
                        help="device, build, then only the named "
                             "phases (comma-separated; each a "
                             "phase_<name>(torch) of this script, e.g. "
                             "train_zero,train_pipe,train_tp), with "
                             "their walls")
    parser.add_argument("--tp-worker", nargs=2, metavar=("SPEC", "RANK"),
                        help=argparse.SUPPRESS)   # a TP phase's rank
    parser.add_argument("--resilience-worker", metavar="OUT",
                        help=argparse.SUPPRESS)   # train_resilience's child
    parser.add_argument("--telemetry-worker", nargs=2,
                        metavar=("MODE", "OUT"),
                        help=argparse.SUPPRESS)   # train_telemetry's child
    parser.add_argument("--serving-only", action="store_true",
                        help="device, build, the decode and sparse "
                             "kernel checks, then only the checkpoint, "
                             "fleet and disaggregated serving phases")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    if args.turns_worker:
        sys.path.insert(0, args.turns_worker)
        torch.backends.cuda.matmul.allow_tf32 = False
        return _turns_serve(torch)
    if args.tp_worker:
        return _tp_worker(torch, args.tp_worker[0], int(args.tp_worker[1]))
    if args.resilience_worker:
        return _resilience_child(torch, args.resilience_worker)
    if args.telemetry_worker:
        return _telemetry_child(torch, *args.telemetry_worker)
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the deepspeed_tpu_torch package must sit beside this "
             f"script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device(torch)
    walls = {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        walls[name] = now - t_phase
        t_phase = now

    phase_build()
    lap("build")
    if args.turns:
        phase_turns(torch, args.turns)
        print(smi, flush=True)
        return 0
    if args.zero_only:
        phase_train_zero(torch)
        print(smi, flush=True)
        return 0
    if args.pipe_only:
        phase_train_pipe(torch)
        lap("train_pipe")
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.tp_only:
        phase_train_pipe_zero(torch)
        lap("train_pipe_zero")
        phase_train_tp(torch)
        lap("train_tp")
        phase_serve_tp(torch)
        lap("serve_tp")
        phase_train_pipe_tp(torch)
        lap("train_pipe_tp")
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.moe_faults:
        phase_train_moe(torch, faults=MOE_FAULTS)
        lap("train_moe")
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.phases:
        for name in args.phases.split(","):
            globals()[f"phase_{name}"](torch)
            lap(name)
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.comm_only:
        phase_f5(torch, lap)
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.f5_faults:
        phase_f5_faults(torch)
        lap("f5_faults")
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.sp_moe_only:
        for name, phase in SP_MOE_PHASES:
            phase(torch)
            lap(name)
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.features_only:
        phase_train_features(torch)
        lap("train_features")
        phase_train_bert_ckpt(torch)
        lap("train_bert_ckpt")
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.serving_only:
        phase_kernel_check(torch)
        phase_paged_kernel_check(torch)
        phase_sparse_kernel_check(torch)
        lap("sparse_kernel_check")
        phase_serve_checkpoint(torch)
        lap("serve_checkpoint")
        phase_serve_fleet(torch)
        lap("serve_fleet")
        phase_serve_disagg(torch)
        lap("serve_disagg")
        emit({"phase": "walls", "seconds": walls})
        print(smi, flush=True)
        return 0
    if args.offload_only:
        _, host_op = phase_train_offload(torch)
        phase_train_dense_yardstick(torch)
        phase_offload_resume(torch)
        emit({"host_ops": [host_op]})
        print(smi, flush=True)
        return 0
    worst = phase_kernel_check(torch)
    paged_worst = phase_paged_kernel_check(torch)
    train_errs = phase_train_kernel_check(torch)
    sparse_errs = phase_sparse_kernel_check(torch)
    if args.kernels_only:
        print(smi, flush=True)
        return 0
    timing = phase_kernel_timing(torch)
    paged_timing = phase_paged_kernel_timing(torch)
    serves = [phase_serve(torch, kv) for kv in (None, "int8")]
    paged_serves = [phase_serve_paged(torch, kv) for kv in (None, "int8")]
    speculative = phase_serve_speculative(torch)
    lap("until_serve_checkpoint")
    checkpoint = phase_serve_checkpoint(torch)
    lap("serve_checkpoint")
    fleet_row = phase_serve_fleet(torch)
    lap("serve_fleet")
    disagg = phase_serve_disagg(torch)
    lap("serve_disagg")
    train_timing = phase_train_kernel_timing(torch)
    train = phase_train(torch)
    lap("until_train")
    zero = phase_train_zero(torch)
    lap("train_zero")
    features = phase_train_features(torch)
    lap("train_features")
    sparse_timing = phase_sparse_kernel_timing(torch)
    phase_wide_head_timing(torch)
    bert = phase_train_bert_sparse(torch)
    lap("until_train_bert_sparse")
    bert_ckpt = phase_train_bert_ckpt(torch)
    lap("train_bert_ckpt")
    offload, host_op = phase_train_offload(torch)
    lap("train_offload")
    phase_train_dense_yardstick(torch)
    lap("train_dense_yardstick")
    phase_offload_resume(torch)
    lap("offload_resume")
    pipe = phase_train_pipe(torch)
    lap("train_pipe")
    pipe_zero = phase_train_pipe_zero(torch)
    lap("train_pipe_zero")
    train_tp = phase_train_tp(torch)
    lap("train_tp")
    serve_tp = phase_serve_tp(torch)
    lap("serve_tp")
    pipe_tp = phase_train_pipe_tp(torch)
    lap("train_pipe_tp")
    sp_moe = {}
    for name, phase in SP_MOE_PHASES:
        sp_moe[name] = phase(torch)
        lap(name)
    f5 = phase_f5(torch, lap)
    bert_tp = phase_train_bert_tp(torch)
    lap("train_bert_tp")
    resilience = phase_train_resilience(torch)
    lap("train_resilience")
    telemetry = phase_train_telemetry(torch)
    lap("train_telemetry")
    emit({"phase": "walls", "seconds": walls})
    t = timing["bfloat16/serve_mix"]
    kernels = [{
        "name": "flash_decode", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_decode.py:193",
        "launches": sum(s["kernel_launches"] for s in serves)
        + checkpoint["kernel_launches"]
        + fleet_row["process_fleet"]["kernel_launches"]
        + serves[0]["scan_layers_kernel_launches"],
        "serve_launches": sum(s["kernel_launches"] for s in serves),
        "scan_layers_launches": serves[0]["scan_layers_kernel_launches"],
        "checkpoint_launches": checkpoint["kernel_launches"],
        "process_fleet_launches":
            fleet_row["process_fleet"]["kernel_launches"],
        "tp_launches": [sum(serve_tp["runs"][n]["decode_launches_by_rank"])
                        for n in ("f32_ring", "bf16_ring")],
        "tp_scan_launches": sum(serve_tp["tp_scan"]["runs"]["f32_ring_scan"][
            "decode_launches_by_rank"]),
        "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]
    t = paged_timing["bfloat16/serve_mix"]
    kernels.append({
        "name": "flash_decode_paged", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_decode.py:269",
        "launches": sum(s["kernel_launches"] for s in paged_serves)
        + speculative["kernel_launches"]
        + paged_serves[0]["scan_layers_kernel_launches"]
        + speculative["scan_layers_kernel_launches"]
        + fleet_row["thread_fleet"]["kernel_launches"]
        + disagg["coordinator"]["kernel_launches"]
        + disagg["thread_tiers"]["kernel_launches"]
        + disagg["process_tiers"]["kernel_launches"],
        "serve_launches": sum(s["kernel_launches"] for s in paged_serves)
        + speculative["kernel_launches"],
        "scan_layers_launches": paged_serves[0]["scan_layers_kernel_launches"]
        + speculative["scan_layers_kernel_launches"],
        "thread_fleet_launches": fleet_row["thread_fleet"]["kernel_launches"],
        "disagg_launches": disagg["coordinator"]["kernel_launches"],
        "thread_tier_launches": disagg["thread_tiers"]["kernel_launches"],
        "process_tier_launches":
            disagg["process_tiers"]["kernel_launches"],
        "tp_launches": [sum(serve_tp["runs"][n]["decode_launches_by_rank"])
                        for n in ("f32_paged", "int8_paged")],
        "tp_scan_launches": sum(serve_tp["tp_scan"]["runs"][
            "f32_paged_scan"]["decode_launches_by_rank"]),
        "max_abs_err": paged_worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]})
    train_src = {
        "K1": ("flash_attention_fwd", "flash_attention.cu",
               "deepspeed_tpu/ops/pallas/flash_attention.py:275"),
        "K2": ("flash_attention_bwd_dq", "flash_attention.cu",
               "deepspeed_tpu/ops/pallas/flash_attention.py:489"),
        "K3": ("flash_attention_bwd_dkv", "flash_attention.cu",
               "deepspeed_tpu/ops/pallas/flash_attention.py:556"),
        "K4": ("fused_adam", "fused_adam.cu",
               "deepspeed_tpu/ops/pallas/fused_adam.py:30")}
    for key, (name, src, replaces) in train_src.items():
        r = train_timing[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": train["launches"][key],
            "zero_launches": zero["launches"][key],
            "features_launches": features["launches"][key],
            "offload_launches": offload["launches"][key],
            "pipe_launches": pipe["launches"][key],
            "pipe_zero_launches": [pipe_zero[s]["launches"][key] for s in
                                   ("stage0", "stage3", "offload")],
            "tp_launches_by_rank": [lr[key] for lr in
                                    train_tp["launches_by_rank"]],
            "pipe_tp_launches": pipe_tp["runs"]["off"]["launches"][key],
            "seq_attention_launches_by_rank": [
                lr[key] for lr in
                sp_moe["seq_attention"]["ulysses"]["launches_by_rank"]],
            "pipe_sp_launches_by_rank": [
                lr[key] for lr in sp_moe["train_pipe_sp"]["launches_by_rank"]],
            "moe_launches_by_rank": [
                lr[key] for lr in sp_moe["train_moe"]["launches_by_rank"]],
            "pipe_tp_moe_launches_by_rank": [
                lr[key] for lr in sp_moe["train_pipe_tp_moe"]["runs"]["off"][
                    "launches_by_rank"]],
            "qcomm_launches_by_rank": {
                n: [lr[key] for lr in run["launches_by_rank"]]
                for n, run in f5["train_qcomm"]["runs"].items()},
            "onebit_launches_by_rank": [
                lr[key] for lr in f5["train_onebit"]["launches_by_rank"]],
            "pipe_onebit_launches_by_rank": [
                lr[key] for lr in f5["train_pipe_onebit"][
                    "launches_by_rank"]],
            "pipe_tp_onebit_launches_by_rank": [
                lr[key] for lr in f5["train_pipe_tp_onebit"][
                    "launches_by_rank"]],
            "tp_scan_launches_by_rank": {
                n: [lr[n][key] for lr in train_tp["tp_scan"][
                    "launches_by_rank"]] for n in ("scan", "scan_chunk")},
            "bert_tp_flash_launches_by_rank": [
                lr[key] for lr in bert_tp["flash"]["launches_by_rank"]],
            "resilience_launches": resilience["launches"][key],
            "telemetry_launches": telemetry["launches"][key],
            "max_abs_err": max(train_errs[key], r.get("max_abs_err", 0.0)),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    sparse_src = {
        "K7": ("block_sparse_attention_fwd",
               "deepspeed_tpu/ops/sparse_attention/"
               "block_sparse_attention.py:217"),
        "K8a": ("block_sparse_attention_bwd_dq",
                "deepspeed_tpu/ops/sparse_attention/"
                "block_sparse_attention.py:381"),
        "K8b": ("block_sparse_attention_bwd_dkv",
                "deepspeed_tpu/ops/sparse_attention/"
                "block_sparse_attention.py:450")}
    sparse_design = {
        "K7": "mma.sync m16n8k8 TF32 x3 (hi/lo split, fp32 precision), "
              "online softmax in the fragment; f32: q and the visited "
              "tiles split once at staging; 2-byte: cp.async double "
              "buffer",
        "K8a": "mma.sync m16n8k8 TF32 x3 (hi/lo split, fp32 precision); "
               "f32: visited tiles split once at staging, the next one "
               "prefetched in registers; bf16: cp.async double buffer",
        "K8b": "mma.sync m16n8k8 TF32 x3 (hi/lo split, fp32 precision), "
               "cp.async double buffer"}
    for key, (name, replaces) in sparse_src.items():
        r = sparse_timing["bert_bench"]["results"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/ops/csrc/"
                      "block_sparse_attention.cu",
            "replaces": replaces, "launches": bert["launches"][key],
            "bert_ckpt_launches": bert_ckpt["launches"][key],
            "bert_tp_launches_by_rank": [lr[key] for lr in
                                         bert_tp["launches_by_rank"]],
            "max_abs_err": sparse_errs[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "design": sparse_design[key]})
    emit({"kernels": kernels})
    emit({"host_ops": [host_op]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
