#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases:
  1. environment: torch, CUDA, nvcc, triton, each card's name and power
     limit; builds the port's CUDA kernels from this checkout (one nvcc per
     source, all started together, into build/) and prints the build's
     seconds, each flash and TBE kernel's ptxas registers and spills, and
     the HGMMA and UTMALDG instructions in the wgmma flash library's SASS
     (cuobjdump; fails if either is absent);
  2. each kernel wrapper against its plain PyTorch version at the main
     path's shapes: the TBE wrappers at T=26 tables, B=2048, L=32, D=128,
     uniform ids over R=1,000,000 rows, random lengths including 0, -1
     padding, in f32 and bf16, plus D=10 (the scalar path) and D=96, and
     one table (T=1, B=2048) at L in {0, 1, 31, 32, 33, 64} with bags of
     live ids and zero weights; stacked, flat (offsets as an array) and
     one table alone bitwise-equal, and stacked and flat over a copy of
     the same rows; the SHA-256 of those outputs (equal digests from two
     checkouts mean bitwise-equal kernels); under torch.profiler, each
     call of gather_pool, gather_pool_tbe, gather_pool_tbe_flat and
     onesided_ring_permute one device kernel; the row fetch's one-sided
     exchange (the chunk-put kernel) on 4 simulated
     hosts' contributions of 2**18 rows (the padded fetch of every flush
     of phase 6) at D=128 and of 1000 rows at D=10, f32 and bf16, bitwise;
     (2b) the flash-attention wrapper at tests/test_kernels.py's four
     shapes in f32 and bf16, and at granite-8b's layer (1, 16384, 32/8,
     128) causal and (1, 9000, 32/8, 128) under a 4096 window, bf16,
     each case on the route the wrapper chose: bf16 at hd 64/128 on the
     wgmma kernel, f32 and hd 16/32 on the SIMT kernel;
  2c. every attached kernel contract (repro_torch.analysis.fixtures) on
     the card: each fixture's one call under set_sync_debug_mode("error")
     and a dispatch-mode census, its wrapper calls, LAUNCH_COUNTS deltas
     and the profiler's TBE device kernels within the contract's launch
     bounds (one TBE kernel for the fused, flat and device_lookup
     contracts), no collective, no host transfer, no f64, the scatter in
     place;
  3. the uncached engine at full width (CONFIG: 26 x 1,000,000 x 128 fp32
     tables) serving 8192 requests in flushes of 2048: scores against a
     plain score on the card, one TBE launch per flush, and 26
     single-table launches for one flush under fused=False; one flush
     profiled each way: the TBE device time as one launch and as 26;
  4. the cached engine (65,536 slots per table, LFU, host cold tier) on
     the same requests: scores and pooled lookups bitwise-equal to phase 3;
  5. kernel, plain-version and library times: the TBE wrappers at the
     phase-2 shapes, the row fetch's puts at the padded fetch of a
     steady-state flush of phase 4, the flash kernel at granite-8b's layer
     (SDPA the library call; the SIMT kernel timed beside it at the same
     shapes), beside each kernel's bound;
  6. the cached engine over the REMOTE cold tier (the same cache, the
     tables row-split over 4 simulated hosts on the card), once with the
     bulk and once with the one-sided transport, on the same requests:
     scores and pooled lookups bitwise-equal to phase 3, the one-sided run
     one put launch per non-empty fetch and the bulk run none;
  6b. pipelined serving (depth 2: two slot pools, the next micro-batch's
     prefetch on a side CUDA stream) through make_dlrm_engine, on the same
     requests: (a) over the host tier, (b) over the remote tier with the
     one-sided transport, (c) with pools that half of the micro-batches
     overflow (the head-of-line fallback): scores bitwise-equal to phase
     3, one TBE launch per micro-batch (and one put launch per non-empty
     fetch), at least one fallback in (c), the port's check_timeline and
     check_scheduler_source clean; wall time beside phases 4 and 6,
     overlap, stage totals, hit rate, pool bytes, peak device memory;
     (d) one profiled run: the streams of the scatters and of the TBE
     launches, and the side-stream device time under forward kernels;
  6p. (run after phase 7p, while phase 3's tables live) the remote tier
     with one host per process: phase 3's tables handed to 4 rank
     processes sharing the card in a gloo group (run_ranks), each a host
     of the remote tier that copies only its own row shard (26 x 250,000
     x 128 f32, 3.33 GB) and drops the tables; on each rank an engine of
     make_dlrm_engine(..., remote_ctx=ctx) with phase 6's cache serves
     phase 3's requests in lockstep: (a) cached on bulk (the requests
     all-gathered, the contributions over the group's reduce-scatter)
     and on one-sided (one put launch a fetch into the peers' CUDA IPC
     buffers, then the local sum), (b) pipelined at depth 2, one-sided:
     scores bitwise phase 3's on every rank, the counters of phase 6 (and
     its fetches, padded alike) or phase 6b (b)'s fallbacks, one flat TBE
     launch per flush and one put launch per non-empty fetch per rank,
     each from the side stream in (b); (c) comm.permute_ring(ctx=) at
     row 7's shape, a (13,312, 128) f32 block a rank, on both backends:
     bitwise torch.roll of the stacked blocks, one ring launch per rank
     on one-sided; per rank the median flush (host clock), the fetches'
     ms, the fences' share and peak memory; no rank process left after
     it; with 2 or more cards, the same over NCCL, one process a card
     (4 hosts, or 2 on 2 or 3 cards);
  6c. the planner -> engine round trip with telemetry, on the same
     requests: sharding_plan.plan over CONFIG's 26 tables (H100_DGX, Zipf
     1.05, host tier, 2048 a shard); (a) plan A (2 shards, 0.5 GB: 8 pools
     of 200,000 slots, 2 of 100,000, 16 "row" tables at phase 4's 65,536)
     on the serialized engine over the host tier: S_t the config's vector,
     the pool's bytes exactly slot_pool_bytes (1,458,470,912), scores and
     pooled lookups bitwise phase 3's, one TBE launch per flush; (b) plan B
     (16 shards, 0.2 GB: all 26 cached) with cache.rows = 0 on the
     pipelined engine over the remote tier, one-sided: two pools of
     2,150,400,000 B, scores bitwise phase 3's, 4 TBE launches, one put
     launch per non-empty fetch from the side stream, check_timeline
     clean; both with a Telemetry: request latency p50/p99, each Chrome
     trace exported to chiprun_out/ and validated, its lanes checked,
     hit_rate_t beside est_hit_rate, and the spans fitted back into the
     perf model (calibrate; constants beside H100_DGX's, stage_time_error);
  7. the distributed embedding bag over 4 simulated ranks on the card
     (table-wise over 2), on phase 3's tables: the chunk kernels'
     all-to-all, reduce-scatter (the pull-sum kernel) and ring permute
     (one launch per call)
     bitwise against their plain versions at the a2a pipeline's shapes, and
     at 1, 2, 3 and 8 ranks (the pull-sum also at 9, 16, 32 and 63 =
     MAX_RANKS at a ragged chunk of 67 elements, f32, bf16 and int32, and
     at 63 on rows of 4-element multiples), with
     int32 sums that wrap, -0.0 sources and exact cancellations; phase
     3's requests
     served by DLRMEngine with a ParallelContext for row/allgather (within
     tolerance of phase 3), row/a2a on both backends (dropped lookups per
     flush, 3 all-to-all launches and 1 reduce-scatter launch per
     one-sided flush) and column / table
     (bitwise phase 3); a no-drop traffic (uniform ids, every length 32)
     where a2a drops nothing and agrees with uncached; flush medians, one
     profiled a2a flush, the kernels' times beside their bounds;
  7p. ranks as processes: phase 3's tables handed to 4 rank processes
     sharing the card (table-wise 2) through CUDA IPC, each in a gloo
     group (run_ranks) copying its own shard (3.33 GB, table-wise 6.65
     GB) and building its symmetric buffers (cudaMalloc'd, opened by the
     peers through CUDA IPC); each rank's DLRMEngine under its
     ProcessContext serves phase 3's requests in flushes of 2048, in
     lockstep, for row/allgather on both backends (the one-sided
     all-reduce a pull-sum over the peers' buffers), row/a2a on both
     (the one-sided puts into the peers' receive buffers), column and
     table: every rank's scores alike; bitwise phase 7's simulated ones
     where every collective moves or adds in rank order, and for the
     bulk sums (gloo's order) the first batch's pooled rows within E *
     2**-24 * sum_s |partial_s| of the simulated sum and pCTR within
     tolerance; each rank's a2a drops those of its simulated rank; one
     TBE launch per rank per flush (3 put + 1 pull-sum launches per
     one-sided a2a flush), counted in each process and summed here; each
     rank's peak memory about its shard; the median flush per rank on the
     host clock with its fences' share (processes time-slicing one card:
     no interconnect's time), each bulk collective's route; with 2 or
     more cards, the row-wise strategies again over NCCL, one process a
     card (else logged as needing them);
  7t. DLRM training at full width (phase 3's tables freed first; fresh
     tables from a seed): at a small size, the fused, unfused and flat
     ops' gradients (tables and weights) against autograd of the plain
     versions; then the test_dlrm flow on one Zipf batch of 2048 from
     dlrm_batches (-1 past each length), the flow's 20 steps of row-wise
     Adagrad on the tables and SGD on the MLPs at lr 0.05: the forward's pooled
     output bitwise the wrapper's, each forward one gather_pool_tbe launch
     and the backward and update none, d tables within n * 2**-24 *
     sum|c| of a float64 host sum of the same contributions and zero
     elsewhere (also through fused=False: 26 launches), the two-run
     backward difference, untouched rows bitwise unchanged and accum
     zero there, the loss down; stage times (CUDA events), a profiled
     step's TBE kernels and idle share, peak device memory;
  7tp. DLRM training with each rank a process: fresh CONFIG tables from
     a seed handed to 4 gloo processes sharing the card (table-wise 2)
     through CUDA IPC, each cutting its shard; 2 steps of phase 7t's flow
     on one Zipf batch of 2048 (dlrm.bce_loss under the rank's
     ProcessContext, the shard's and the MLPs' gradients, row-wise
     Adagrad on the shard, SGD) for row/allgather on both backends,
     row/a2a/bulk, column and table, against the one-device flow (the
     simulated ranks' for the pull-sum and the a2a pipeline) on the same
     tables and batch: step 1's loss within 1e-5, step 2's within 1e-3,
     the gradient of the pooled vectors against a fixed cotangent on the
     touched rows (fetched to the host) within 1e-5 relative L2; every
     rank's losses alike; per rank per forward one TBE launch and, for
     the one-sided all-reduce, one pull-sum, none in the backward or the
     update; step times on the host clock and peak memory per rank; the
     a2a pipeline over the one-sided puts under grad raises on every
     rank; with 4 cards, the same over NCCL, one process a card;
  8. LM serving: granite-8b at full width in bf16 (random weights from a
     seed) through ContinuousBatcher (4 slots of 16,416 positions) over 8
     requests, 2 prompts of 16,384 tokens (the flash kernel: 36 launches
     each, all on the wgmma route) and 6 of 256-2,048 (full attention:
     none), 32 new tokens each: launches per step and per route, the
     kernel against its plain version on layer 0's real q/k/v,
     decode-matches-forward at full width (on a long and a short
     prompt), prefill and decode times, tokens/s, peak device memory,
     and a profiled decode step, short prefill and 16,384-token prefill;
     the ctx leg: the long and the first short request (16 new tokens
     each, 2 slots) without a context and under make_context(4) (4
     simulated ranks): each admission's logits bitwise the local run's
     (the vocabulary through the row-wise sharded bag), decode steps
     with equal inputs within 2e-2 of the local run's hidden rows (the
     sequence-sharded flash-decode), greedy tokens that differ logged, 4
     TBE launches per prefill and per decode step, 36 flash launches;
  8m. MoE serving, after phase 8's weights and cache are freed (checked):
     moonshot-v1-16b-a3b at full width in bf16 (28,325,838,848
     parameters, random from a seed): the flash kernel against its plain
     version on the dense layer 0's real q/k/v at (1, 16384, 16/16, 128)
     (group size 1, wgmma); layer 1's moe_ffn on 2,048 real hidden rows
     against a dense masked scan over all 64 experts in f32, the expert
     loads, moe_dropped 0; ContinuousBatcher (2 slots of 16,416
     positions) over 4 requests, 1 prompt of 16,384 tokens (48 flash
     launches, wgmma) and 3 of 256-2,048 (none), 32 new tokens each,
     one moe_ffn call per MoE layer per prefill and decode step, one
     host sync per 4,096 tokens of it; prefill and decode times,
     tokens/s, peak device memory, a profiled decode step and
     16,384-token prefill; decode against forward on a short prompt,
     free-running (logged: each MoE layer's routing flips between the
     two paths, per-layer divergence) and on the forward's expert
     choices (held to 2e-2); the ctx leg: layer 1's moe_ffn_ep over 4
     ranks (16 experts each) on the 2,048 real rows, the card against
     the CPU (relative L2 1e-2, drops equal), then the long prompt's
     prefill and 16 greedy decode steps under make_context(4): moe_dropped
     per prefill and per step, 4 TBE launches per prefill and per step,
     48 flash launches, the prefill's time, decode tokens/s;
  8d. MLA serving, after phase 8m's weights and cache are freed (checked):
     deepseek-v3-671b at its published widths in bf16, cut to 5 layers (3
     dense MLA layers, 2 MoE layers of 256 experts top-8 + 1 shared;
     26,618,298,368 parameters and the MTP head, random from a seed):
     (a) layer 0's mla_attention on the 16,384 real hidden rows of the
     long prompt takes chunked_attention once by shape (q/k at hd 192, v
     at 128) and launches no flash kernel, its last 512 rows within
     relative L2 2e-3 of an explicit f32 softmax over all keys, a bound
     that the same softmax at a planted wrong scale (128 ** -0.5) must
     exceed; (b) layer
     3's moe_ffn on 2,048 real rows against the dense f32 scan over all
     256 experts, the expert loads, moe_dropped 0; (c) ContinuousBatcher
     (2 slots of 16,416 positions) over 4 requests, 1 prompt of 16,384
     tokens (5 chunked_attention calls, no flash launch) and 3 of
     256-2,048 (full attention), 16 new tokens each, one moe_ffn call per
     MoE layer per prefill and decode step; prefill and decode times,
     tokens/s, peak device memory (the draw's, the checks', serving's), a
     profiled decode step and 16,384-token prefill; (d) decode against
     forward on the 1,354-token prompt, free-running (logged with its
     routing flips) and on the forward's expert choices (held to 2e-2);
     (e) the latent cache exactly 189,112,320 B, and the phase's memory
     freed after it; the ctx leg: 16 decode steps after the long prompt
     under make_context(4) over the latent cache sharded along its
     16,416 positions, on the local decode's tokens: each MLA layer's
     sharded decode attention within 2e-2 of the whole cache's on the
     same inputs, the hidden rows against the local decode's logged with
     each step's moe_dropped (held to 2e-2 when nothing is dropped), 4
     TBE launches a step;
  8h. hybrid serving, after phase 8d's memory is freed (checked):
     hymba-1.5b at CONFIG, all 32 layers, bf16 (1,662,264,000 parameters,
     random from a seed): (a) the flash kernel against its plain version
     on the real q/k/v of layer 0 (global: window 1 << 30) and layer 1
     (window 1024) of the 16,384-token prompt, (1, 16384, 25/5, 64) on
     the wgmma route; (b) layer 0's mamba_forward on 2,048 real rows
     against the recurrence stepped token by token on its own
     projections (h_final within relative L2 1e-5, the output within
     1e-2) and against a loop of mamba_decode_step (the output within
     1e-2), and that loop with a planted fault (the carried conv state
     rotated by one row) above the bound; (c) ContinuousBatcher (4 slots of 16,416 positions) over 1
     prompt of 16,384 tokens (32 flash launches, wgmma) and 3 of
     256-2,048 (none), 32 new tokens each: the cache's row and state
     bytes, prefill and decode times, tokens/s, peak device memory, a
     profiled decode step and 16,384-token prefill; (d) decode against
     forward on the short and the long prompt (the states' handoff);
  8r. ssm serving, after phase 8h's memory is freed (checked):
     rwkv6-1.6b at CONFIG, all 24 layers, bf16 (1,584,091,136
     parameters): (a) layer 0's rwkv_time_mix_chunked (chunk 1024)
     against rwkv_time_mix on 4,096 real rows in f32, output and final
     state within 1e-4 (the reference's bound), finite, the chunks'
     largest -log P logged; (b) the same batcher run, no flash launch;
     (c) decode against forward on the short and the long prompt; times,
     tokens/s, peak memory and profiles as in 8h; the phase's memory
     freed after it;
  8w. audio serving, after phase 8r's memory is freed (checked):
     whisper-base at CONFIG, 6 encoder + 6 decoder layers, bf16
     (97,950,720 parameters, random from a seed; N(0, 1) frames):
     (a) serving.engine.generate(frames=) over 16 clips of 1,500 frames,
     4-token prompts, 224 new tokens each (228 positions): no kernel
     launch and no chunked_attention call (every attention is at most
     1,500 keys); tokens/s, the encoder's, the prefill's and 32 decode
     steps' times, the cross K/V projections each decode step recomputes
     (CUDA events) beside a profiled decode step's device busy time,
     peak device memory; (b) prefill's cache["enc"] bitwise forward's
     aux["encoder_out"] on one clip; (c) decode against forward on that
     clip's 228 tokens, in bf16 (2e-2) and in f32 on the same weights
     cast (1e-4);
  8v. vlm, after phase 8w's memory is freed (checked): internvl2-2b at
     CONFIG, 24 layers, bf16 (1,895,440,384 parameters): (a) the flash
     kernel against its plain version on layer 0's real q/k/v of 256
     projected patches and 16,128 tokens (1, 16384, 16/8, 128), the
     projector in f32 against a float64 numpy evaluation of the
     reference's formula (1e-5 relative L2), then lm.forward(patches=)
     over the 16,384 positions: 24 flash launches, all wgmma, nothing
     else; the last row's logits, time, peak memory, a profile; (b)
     text-only serving through ContinuousBatcher (4 slots of 16,416
     positions), 1 prompt of 16,384 tokens (24 flash launches) and 3 of
     256-2,048 (none), 32 new tokens each, as in 8h; (c) decode against
     prefill on the 1,354-token prompt (the forward needs patches, which
     prefill refuses in both packages), bf16 (2e-2) and f32 (1e-4);
  8t. LM training, after phase 8v's memory is freed (checked): (a)
     granite-8b at CONFIG, all 36 layers, bf16 (8,254,689,280 parameters,
     random from tc.seed), Trainer(device=None).run(4) with
     TrainConfig(optimizer_state_dtype="int8", remat=True,
     warmup_steps=1) on 1 x 4,096 tokens a step from lm_batches through
     Prefetcher: the state's bytes exactly (parameters and gradients
     16,509,378,560 B each, each int8 moment 8,254,689,280 B and
     257,959,040 B of f32 scales), finite losses and gradient norms, no
     kernel launch and no chunked_attention call (4,096 keys take
     full_attention), step times, tokens/s, peak device memory, one more
     step split by CUDA events into forward + backward and the update,
     and a profiled step's idle share; (b) two f32 train steps of 2
     layers at granite width with int8 moments on 128 tokens each (TF32
     off), each against the CPU from a copy of the card's state before
     it: each loss and global gradient norm (the clip) within 1e-5
     relative, every gradient leaf within relative L2 1e-4, and after
     the second update (which reads int8 moments) the parameters within
     1e-4, the moments' codes differing on under 1 % of each leaf and
     the decoded moments within 2e-3 (m) and 2.5e-2 (v); (c) 1 layer,
     bf16, int8 moments: 3 steps with checkpoints every 2 into a temporary
     directory, resumed from step 2 for 1 step, the state bitwise the
     uninterrupted run's, the checkpoint's bytes on disk; (d) 2 layers,
     bf16, one step over 16,384 tokens: chunked_attention in each
     layer's forward and recompute (4 calls), no flash launch (the
     kernel has no backward; the wrapper refuses a tensor that needs a
     gradient), peak memory; and chunked_attention's q/k/v gradients
     against full_attention's at (1, 4096, 32/8, 128) f32 causal, within
     relative L2 1e-4; (a') one step of (a)'s run under make_context(4),
     a Trainer from the same seed: the loss bitwise (a)'s step 1, 4 TBE
     launches, peak device memory; (c') (c) under make_context(4);
  8tp. LM training with each rank a process (4 gloo processes sharing the
     card): (a) granite-8b at its published widths cut to 2 layers, 4,096
     tokens a step, and (b) moonshot-v1-16b-a3b cut to 4 layers, 2,048
     tokens a step (the depths and tokens that four ranks' activations
     fit beside each other), bf16, int8 moments, 2 Trainer(ctx=
     ProcessContext) steps (each rank drawing only its share of the state
     from the seed), against Trainer(ctx=make_context(4)) run on the card
     first: step 1's loss and gradient norm within 1e-5, the later ones
     within 1e-5 (a) or 2e-4 (b, where step 2 routes a token or two
     otherwise), step 1's router gradients (b) within 2 (E - 1) 2**-24
     ||sum_r |g_r||| and its shared experts' bf16 ones equal or adjacent
     bf16 values, each parameter leaf's change over the 2 steps (a) or
     step 1 (b) within 1e-3 of the simulated change, moe_dropped of step
     1 equal, every rank's metrics alike, one
     TBE launch a step per rank and nothing else; (c) moonshot at 2
     layers (1 MoE): 2 steps against 1, a checkpoint (rank 0 receiving the
     cut leaves' shares on the host and writing the whole state), a
     restart and 1 more, bitwise; step times and peak memory per rank;
     with 4 cards, (a)-(c) again over NCCL, one process a card;
  8dp. a data axis with each rank a process (4 gloo processes sharing the
     card as the mesh (2, 2), each data group half of each batch): (a)
     CONFIG's flushes for three row-wise strategies and (b) two DLRM
     training steps, table-wise, tables cut to 2**18 rows, against the
     simulated make_context(2, dp_size=2) ranks (pCTR within PCTR_TOL,
     losses within 1e-5, both data groups' leaves bitwise equal); with 4
     cards again over NCCL;
  8lr. the launchers over the reference's debug mesh (2, 2), after 8dp
     (4 gloo processes sharing the card): (a) the serve launcher's rank
     function serves granite-8b at all 36 layers, bf16, each rank drawing
     only its share from the seed, 4 requests in 4 slots (a prompt of
     8,448 tokens and one of 256 a data group, 9 tokens each), against
     ContinuousBatcher(ctx=make_context(2, dp_size=2)) run by the parent
     on the whole draw after the ranks end: each head call's logits
     within 2e-2, greedy tokens equal up to the first near-tie (printed),
     each rank's parameters lm_params_for_rank's cut of the whole draw
     leaf for leaf, per rank one TBE launch an embedding call and 36 flash
     launches; (b) the train launcher's rank function at 2 layers, int8
     moments, 2 x 2,048 tokens, under the reference's state placement
     (launch/specs.state_spec_tree: FSDP over the data axis, dense cuts
     over the model axis; each rank's parameter, gradient and moment
     bytes exactly the specs'): 2 steps with a checkpoint a step written
     by global rank 0, then the same command again, which resumes from
     step 2 and runs 2 more from batch 0 as the reference's launcher does,
     bitwise the run's Trainer gone on in memory, the leaves the data
     axis does not cut bitwise equal in both data groups; and a tied
     head's f32 step; against the simulated (2, 2) Trainer (step 1's loss
     and norm within 1e-5, step 2's loss within 2.5e-4); with 4 cards,
     (c) (a) again and training at all 36 layers over NCCL, one process a
     card, each rank's peak memory logged;
  9. the examples (examples/*_torch.py), after 8t: each TBE launch of
     the path (this process's and each rank's) held against the
     wrapper's plain version on its own inputs, once a shape, and every
     launch seen by that hold; (a)
     dlrm_inference's one-device part (the oracle, the tiered engine
     over the host tier within 1e-5 of the uncached forward, hit rate
     over 0.5); (b) one spawn of a (1, 4) mesh of processes (gloo on one
     card, NCCL with 4) running quickstart's rank function (each rank
     drawing the 256 MiB tables and keeping its rows; the a2a pipeline
     within 1e-4 of rank 0's oracle) and dlrm_inference's four
     strategies (each within 1e-4 of the oracle, the traffic the
     reference's example prints at 4 devices); (c) serve_batched (the LM
     batcher, depth 1 against depth 2 under an SLO monitor); (d)
     dlrm_sharding_plan on the H100 model; (e) lm_train: 300 steps of
     the 100M model, 8 x 128 tokens, int8 moments, checkpoints every 100
     into a temporary directory: the loss at steps 1, 10, 100 and 300,
     the last under the first; the last, and the mean of the last 50,
     over lm_batches' unigram entropy (5.0586 nats) less 3 standard
     deviations of a batch's (of 50 batches') mean -log p; no kernel
     launch; TBE launches counted per part and per rank;
  10. the card line, one JSON line of the kernels (the flash kernel's
     launches_by_path records LM training's 0; the ctx legs' launches are
     paths of their own), and last the result line.

A profile whose device records a check or a DLRM idle share reads traces
the host and the card (``contracts.profile_complete``): it opens with 16
device spins of its own, since the profiler now and then drops a
profile's first device records, and it is read only when each of the
call's kernel launches has its record, or misses the same ones as an
earlier profile of the call; else it is taken again, up to 5 times, each
one logged.  The LM profiles trace the card alone, which cannot be
checked so.

Any failed check raises: the script exits non-zero and prints no result
line.  It also fails without a CUDA card, and without the port's sources
beside it.
"""
import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# one cuBLAS workspace layout, so equal GEMMs stay bitwise-equal
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
TBE_SOURCE = "src/repro_torch/csrc/tbe_gather_pool.cu"
A2A_SOURCE = "src/repro_torch/csrc/onesided_a2a.cu"
# the flash wrapper's two kernels: bf16 at hd 64/128 (every call of the
# main path) on the tensor cores; f32 and hd 16/32 on the CUDA cores
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention_wgmma.cu"
FLASH_SIMT_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
SOURCES = {"gather_pool_tbe_flat": TBE_SOURCE, "gather_pool_tbe": TBE_SOURCE,
           "gather_pool": TBE_SOURCE, "onesided_put_rows": A2A_SOURCE,
           "onesided_all_to_all": A2A_SOURCE,
           "onesided_reduce_scatter": A2A_SOURCE,
           "onesided_ring_permute": A2A_SOURCE,
           "flash_attention": FLASH_SOURCE}
REPLACES = {"gather_pool_tbe_flat":
            "src/repro/kernels/embedding_gather.py:150",
            "gather_pool_tbe": "src/repro/kernels/embedding_gather.py:215",
            "gather_pool": "src/repro/kernels/embedding_gather.py:95",
            "onesided_put_rows": "src/repro/kernels/onesided_a2a.py:116",
            "onesided_all_to_all": "src/repro/kernels/onesided_a2a.py:57",
            "onesided_reduce_scatter": "src/repro/kernels/onesided_a2a.py:77",
            "onesided_ring_permute": "src/repro/kernels/onesided_a2a.py:145",
            "flash_attention": "src/repro/kernels/flash_attention.py:103"}
# H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12      # dense tensor cores
# kernel vs plain pooling: two f32 summation orders of <= 32 terms differ by
# at most 32 * 2**-24 * sum|w * x| ~ 2e-6 * sum|w * x|, and sum|w * x| < 2
# here (rows ~ N(0, 1/128), weights in [0, 1)), so 1e-5 holds with margin
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
# pCTR: the pooled vectors' f32 differences carried through the MLPs
PCTR_TOL = dict(rtol=1e-4, atol=1e-5)
# flash kernel vs its plain version: in f32 (the SIMT kernel) two orders of
# the same f32 softmax sums (tests/test_kernels.py's bound for the Pallas
# kernel); in bf16 the wgmma kernel rounds the probabilities to bf16 before
# P.V, as SDPA does, where the plain version keeps them in f32, and both
# round the output to bf16: about one bf16 ulp (2**-8 relative) of the
# output (tests/test_torch_flash.py emulates the rounding on the CPU)
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# SDPA (the library yardstick) against the plain version: its flash
# backend rounds the probabilities to bf16 before P.V, as the wgmma kernel
# does, and sums in its own order: a few bf16 ulps
SDPA_TOL = dict(rtol=3e-2, atol=3e-2)
# decode-matches-forward at full width in bf16: relative L2 of the last
# hidden state (the check of tests/test_models.py, at the working type)
DECODE_REL_L2 = 2e-2

DEV = "cuda"
T, B, L, D, R = 26, 2048, 32, 128, 1_000_000
REQUESTS, BATCH = 8192, 2048
HOSTS = 4                  # simulated hosts of the remote cold tier
PUT_ROWS = 2 ** 18         # the padded rows of each of phase 6's fetches
RANKS = 4                  # simulated ranks of phase 7's model axis
T1_POOLINGS = (0, 1, 31, 32, 33, 64)   # phase 2's one-table lengths
T1_ROWS = 100_000          # rows of phase 2's one-table checks
CAPACITY_FACTOR = 2.0      # the a2a buckets' (DLRMConfig passes none)
SPIN_CYCLES = 2_000_000    # ~1 ms of the card's clock before a timed launch
# flash checks: tests/test_kernels.py's four (B, S, H, KH, hd, causal,
# window); then granite-8b's layer at the long prompt and at a 9000-token
# prompt under a 4096 window (neither a multiple of the 64-row tiles)
FLASH_SHAPES = ((2, 128, 4, 2, 32, True, None), (1, 256, 4, 4, 64, True, 64),
                (2, 96, 2, 1, 16, False, None), (1, 64, 8, 2, 128, True, None))
LONG_PROMPT = 16_384       # over attn_chunk_threshold: the flash kernel runs
SHORT_PROMPTS = (256, 2048)  # the short prompts' lengths: full attention
WINDOWED = (9000, 4096)
LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 4, 16_416, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _launches(**nonzero) -> dict:
    """Every kernel's launch count: 0 but for ``nonzero``."""
    return {name: nonzero.get(name, 0) for name in SOURCES}


def compare(name, got, want, tol) -> float:
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **tol))
    log(f"  {name}: max_abs_err {err:.3e} (allclose rtol={tol['rtol']} "
        f"atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} within tolerance")
    return err


# ---------------------------------------------------------------------------
# 1. environment and build
# ---------------------------------------------------------------------------

def phase_environment(build) -> str:
    log("== 1. environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  numpy {np.__version__}")
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}: importable")
    except ImportError as e:
        log(f"triton: not importable ({e})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    for line in cards:           # every card's name and power limit
        log(line)
    card = cards[0]
    log(f"torch.cuda: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    names = list(build.SOURCES)
    recs = build.build(names)          # one nvcc per source, in parallel
    for name in names:
        build.load(name)
    log(f"build + load of {len(names)} sources: "
        f"{time.perf_counter() - t0:.2f} s")
    for rec in recs.values():
        log(f"  {rec.path.name}: nvcc {rec.seconds:.2f} s")
        for line in rec.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    for name, source in (("tbe_gather_pool", TBE_SOURCE),
                         ("flash_attention_wgmma", FLASH_SOURCE),
                         ("flash_attention", FLASH_SIMT_SOURCE)):
        kernels = _ptxas_kernels(recs[name].log)
        check(bool(kernels) or recs[name].seconds == 0.0,
              f"ptxas reported the kernels of {source}")
        for kernel, regs, stores, loads in kernels:
            log(f"  ptxas {kernel} ({source}): {regs} registers, {stores} "
                f"bytes spill stores, {loads} bytes spill loads")
    sass = _sass(recs["flash_attention_wgmma"].path)
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG")}
    log(f"  {recs['flash_attention_wgmma'].path.name} SASS: "
        f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
    check(all(counts.values()), "the wgmma flash library holds HGMMA and "
                                "UTMALDG instructions")
    return card


def _ptxas_kernels(ptxas_log: str) -> list:
    """(kernel, registers, spill-store bytes, spill-load bytes) of each
    flash and TBE entry function in an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], None, (0, 0)
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for \S*\d(flash_[a-z]+_kernel|"
                      r"tbe_gather_pool_kernel)I(\w*)", line)
        if m:
            dtype = "f32" if m.group(2).startswith("f") else "bf16"
            num = re.search(r"Li(\d+)E", m.group(2)).group(1)
            kind = (f"hd {num}" if m.group(1).startswith("flash")
                    else f"vector, {num} rows a group" if "Lb1E"
                    in m.group(2) else "scalar")
            name = f"{m.group(1)}<{dtype}, {kind}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def _sass(path) -> str:
    """``cuobjdump -sass`` of a built library (cuobjdump on the PATH or
    under CUDA_HOME/bin)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                      "cuobjdump")
    check(os.path.exists(tool), "cuobjdump found (PATH or CUDA_HOME/bin)")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(g, t, b, lp, r, d, dev):
    """Tables ~ N(0, 1/d), lengths in [0, lp], uniform ids, -1 padding,
    weights in [0, 1) zeroed on padding."""
    tables = torch.randn((t, r, d), generator=g, device=dev).mul_(d ** -0.5)
    lens = torch.randint(0, lp + 1, (t, b), generator=g, device=dev,
                         dtype=torch.int32)
    mask = torch.arange(lp, device=dev) < lens[..., None]
    ids = torch.randint(0, r, (t, b, lp), generator=g, device=dev,
                        dtype=torch.int32)
    idx = torch.where(mask, ids, -1).to(torch.int32)
    w = torch.rand((t, b, lp), generator=g, device=dev) * mask
    # ragged per-table row counts in the same flat row space
    rows_t = r - torch.randint(0, r // 2, (t,), generator=g, device=dev)
    off = (torch.cumsum(rows_t, 0) - rows_t).to(torch.int32)
    ids_r = torch.minimum(
        (torch.rand((t, b, lp), generator=g, device=dev)
         * rows_t[:, None, None]).long(), rows_t[:, None, None] - 1)
    idx_r = torch.where(mask, ids_r, -1).to(torch.int32)
    return dict(tables=tables, idx=idx, w=w, mask=mask, off=off, idx_r=idx_r)


def _check_all(eg, x, tag, digest, one=5) -> dict:
    """The three wrappers against their plain versions, and the layouts of
    the same rows bitwise-equal: the stacked tables (table t at row t * R,
    passed as a stride), the flat view with the same offsets passed as an
    array, and one table alone.  Every output goes into ``digest``; returns
    the errors."""
    tables, idx, w = x["tables"], x["idx"], x["w"]
    t_, r_, d_ = tables.shape
    flat = tables.view(t_ * r_, d_)
    errs = {}
    stacked = eg.gather_pool_tbe(tables, idx, w)
    errs["gather_pool_tbe"] = compare(
        f"gather_pool_tbe {tag}", stacked,
        eg.gather_pool_tbe_ref(tables, idx, w), POOL_TOL)
    ragged = eg.gather_pool_tbe_flat(flat, x["off"], x["idx_r"], w)
    errs["gather_pool_tbe_flat"] = compare(
        f"gather_pool_tbe_flat ragged {tag}", ragged,
        eg.gather_pool_tbe_flat_ref(flat, x["off"], x["idx_r"], w), POOL_TOL)
    starts = (torch.arange(t_, device=flat.device) * r_).to(torch.int32)
    check(torch.equal(eg.gather_pool_tbe_flat(flat, starts, idx, w), stacked),
          f"flat with offsets t * R bitwise == stacked {tag}")
    one = min(one, t_ - 1)
    single = eg.gather_pool(tables[one], idx[one], w[one])
    errs["gather_pool"] = compare(
        f"gather_pool table {one} {tag}", single,
        eg.gather_pool_ref(tables[one], idx[one], w[one]), POOL_TOL)
    check(torch.equal(single, stacked[one]),
          f"single-table launch bitwise == fused TBE table {one} {tag}")
    for out in (stacked, ragged, single):
        digest.update(out.cpu().numpy().tobytes())
    return errs


def _profiled(fn, label):
    """``fn()`` under torch.profiler until a profile of it can be read
    (``contracts.profile_complete``: a lead-in of device spins, then the
    call, whose kernel launches must each have their record, or miss the
    same ones as an earlier profile of it, with no stray record and not
    all of them); logs
    each profile taken before it, the lead-in records the profiler
    dropped and the call's records the one read lacks.  Fails if none
    could be read."""
    from repro_torch.analysis.contracts import profile_complete

    try:
        prof, gaps, earlier = profile_complete(fn)
    except RuntimeError as e:
        check(False, f"a readable profile of {label}: {e}")
    for g in earlier:
        log(f"  {label}: a profile taken again ({g.launches} kernel "
            f"launches, {g.lost} without a record, in {list(g.lost_in)}; "
            f"{g.stray} records without a launch)")
    dropped = [g.lead_in_lost for g in earlier + [gaps]]
    if any(dropped):
        log(f"  {label}: lead-in records the profiler dropped, by profile: "
            f"{dropped}")
    if gaps.lost:
        log(f"  {label}: {gaps.lost} of {gaps.launches} kernel launches "
            f"without a record in this profile and an earlier one, in "
            f"{list(gaps.lost_in)}")
    return prof


def _device_events(prof) -> list:
    """A profile's device-side rows (kernels, copies, fills): the CPU ops'
    rows repeat their kernels' time, and neither the profiler's own buffer
    requests nor a profile's lead-in spins are work of the profiled
    call."""
    from torch.autograd import DeviceType
    from repro_torch.analysis.contracts import LEAD_IN_KERNEL

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")
            and LEAD_IN_KERNEL not in e.key]


def _one_kernel_per_call(calls) -> None:
    """Each call under torch.profiler (a complete profile): the device
    kernels it ran.  Each must be exactly one launch of the named
    kernel."""
    for label, kernel, fn in calls:
        ran = [(e.key, e.count) for e in _device_events(_profiled(fn, label))]
        ok = len(ran) == 1 and ran[0][1] == 1 and kernel in ran[0][0]
        log(f"  {label}: {sum(n for _, n in ran)} device kernel(s) "
            f"{[(k[:60], n) for k, n in ran]} {'ok' if ok else 'NOT ONE'}")
        check(ok, f"{label} is one {kernel} launch and nothing else")


def _contribs(g, h, m, d, dtype, dev):
    """(H_src, H_dst, M, D) contributions of a row fetch: N(0, 1) rows,
    each (requester, row) owned by one rank, ``0 * row`` (so -0.0 for half
    of them) at the other ranks."""
    rows = torch.randn((h, h, m, d), generator=g, device=dev)
    owner = torch.randint(0, h, (h, m), generator=g, device=dev)
    mine = owner[None] == torch.arange(h, device=dev)[:, None, None]
    return (rows * mine[..., None]).to(dtype)


def _bits(x):
    """The raw bits of a float tensor, so -0.0 and 0.0 differ."""
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def _check_puts(oa, c, tag) -> float:
    """The row fetch's exchange and fetched rows against their plain versions
    on the same contributions: bitwise; returns the max abs error."""
    exch = oa.onesided_put_rows(c)
    want = oa.onesided_put_rows_ref(c)
    fetched = oa.onesided_fetch_rows(c)
    want_f = oa.onesided_fetch_rows_ref(c)
    torch.cuda.synchronize()
    err = max(float((exch.float() - want.float()).abs().max()),
              float((fetched.float() - want_f.float()).abs().max()))
    ok = torch.equal(_bits(exch), _bits(want)) and \
        torch.equal(_bits(fetched), _bits(want_f))
    log(f"  onesided_put_rows {tag}: exchange and fetched rows "
        f"{'bitwise equal' if ok else 'DIFFER'} (max_abs_err {err:.3e})")
    check(ok, f"onesided_put_rows {tag} bitwise == plain version")
    return err


def phase_kernels(eg, oa) -> dict:
    log("== 2. kernels against their plain versions")
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(0)
    digest = hashlib.sha256()
    x = _inputs(g, T, B, L, R, D, dev)
    log(f"  T={T} B={B} L={L} D={D} R={R}: "
        f"{int(x['mask'].sum())} valid lookups of {T * B * L}")
    errs = _check_all(eg, x, "f32", digest)
    bf = dict(x, tables=x["tables"].to(torch.bfloat16))
    for k, v in _check_all(eg, bf, "bf16", digest).items():
        errs[k] = max(errs[k], v)
    del bf
    for d_small in (10, 96):
        small = _inputs(g, 3, 64, 7, 1000, d_small, dev)
        _check_all(eg, small, f"D={d_small} f32", digest, one=1)
        _check_all(eg, dict(small, tables=small["tables"].to(
            torch.bfloat16)), f"D={d_small} bf16", digest, one=1)
    # one table (the unfused baseline's launch) at the pooling lengths
    # around the kernel's 32-slot windows and 8-row groups, with bags whose
    # ids are live and weights all zero
    for lp in T1_POOLINGS:
        one = _inputs(g, 1, B, lp, T1_ROWS, D, dev)
        one["w"][:, ::5] = 0.0          # live ids, no weight: +0.0, no read
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"T=1 L={lp} {str(dtype)[6:]}"
            y = dict(one, tables=one["tables"].to(dtype))
            _check_all(eg, y, tag, digest, one=0)
            zeros = eg.gather_pool(y["tables"][0], y["idx"][0],
                                   y["w"][0])[::5]
            check(torch.equal(_bits(zeros), torch.zeros_like(_bits(zeros))),
                  f"zero-weight bags pool to +0.0 {tag}")
    x["digest"] = digest.hexdigest()
    log(f"  phase-2 TBE digest (sha256 of every output above, f32 and "
        f"bf16, all three wrappers): {x['digest']}")

    # stacked tables and a compact flat pool holding the same rows (the
    # slot-pool layout): the same kernel pools them bitwise-equal
    tables, idx, w, mask = x["tables"], x["idx"], x["w"], x["mask"]
    rows, counts = [], []
    slots = torch.zeros_like(idx)
    for t in range(T):
        uniq, inv = torch.unique(idx[t][mask[t]].long(), return_inverse=True)
        rows.append(tables[t, uniq])
        counts.append(uniq.numel())
        slots[t][mask[t]] = inv.to(torch.int32)
    pool = torch.cat(rows)
    off_p = torch.tensor([0] + counts[:-1], device=dev).cumsum(0).to(
        torch.int32)
    same = torch.equal(eg.gather_pool_tbe_flat(pool, off_p, slots, w),
                       eg.gather_pool_tbe(tables, idx, w))
    log(f"  stacked vs flat pool of the same {pool.shape[0]} rows: "
        f"{'bitwise equal' if same else 'DIFFER'}")
    check(same, "stacked and flat pool bitwise-equal")
    del pool, rows

    # no device work beside the kernel: each wrapper call is one launch
    ring = torch.randn((RANKS, 1000, D), generator=g, device=dev)
    _one_kernel_per_call((
        ("gather_pool", "tbe_gather_pool_kernel",
         lambda: eg.gather_pool(tables[5], idx[5], w[5])),
        ("gather_pool_tbe", "tbe_gather_pool_kernel",
         lambda: eg.gather_pool_tbe(tables, idx, w)),
        ("gather_pool_tbe_flat", "tbe_gather_pool_kernel",
         lambda: eg.gather_pool_tbe_flat(tables.view(T * R, D), x["off"],
                                         x["idx_r"], w)),
        ("onesided_ring_permute", "put_chunks_kernel",
         lambda: oa.onesided_ring_permute(ring, 1))))

    # the row fetch's puts: 4 simulated hosts, D=128 and D=10, f32 and
    # bf16
    put_err = 0.0
    for m, d in ((PUT_ROWS, D), (1000, 10)):
        for dtype in (torch.float32, torch.bfloat16):
            c = _contribs(g, HOSTS, m, d, dtype, dev)
            put_err = max(put_err, _check_puts(
                oa, c, f"H={HOSTS} M={m} D={d} {str(dtype)[6:]}"))
            del c
    errs["onesided_put_rows"] = put_err
    x["errs"] = errs
    return x


def _qkv(g, b, s, h, kh, hd, dtype):
    """N(0, 1) q (b, s, h, hd), k and v (b, s, kh, hd) of ``dtype``."""
    return tuple(torch.randn((b, s, n, hd), generator=g, device=DEV).to(dtype)
                 for n in (h, kh, kh))


def _flash_route(dtype, hd) -> str:
    """The kernel the wrapper must choose: the tensor-core one for bf16 at
    hd 64 and 128, the SIMT one for the rest."""
    return "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "simt"


def _flash_case(fa, q, k, v, causal, window, tag) -> float:
    """The flash wrapper against its plain version on the same inputs, and
    the one launch it made on the route that dtype and hd choose."""
    want_route = _flash_route(q.dtype, q.shape[-1])
    before = dict(fa.ROUTE_COUNTS)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {r: n - before[r] for r, n in fa.ROUTE_COUNTS.items()}
    check(ran == {r: int(r == want_route) for r in ran},
          f"flash_attention {tag}: one launch on the {want_route} route "
          f"(got {ran})")
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"flash_attention {tag}: output of q's dtype and shape")
    return compare(f"flash_attention {tag} [{want_route}]", got.float(),
                   want.float(), FLASH_TOL[q.dtype])


def check_flash(pt) -> float:
    """The flash wrapper against its plain version at the test shapes (f32
    and bf16) and at granite-8b's layer, causal and windowed (bf16), each
    case on its route; returns the largest error."""
    log("== 2b. flash attention against its plain version")
    cfg = pt.LM_CONFIG
    g = torch.Generator(device=DEV).manual_seed(9)
    err = 0.0
    for b, s, h, kh, hd, causal, window in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(g, b, s, h, kh, hd, dtype)
            err = max(err, _flash_case(
                pt.fa, q, k, v, causal, window,
                f"({b}, {s}, {h}/{kh}, {hd}) causal={causal} "
                f"window={window} {str(dtype)[6:]}"))
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for s, window in ((LONG_PROMPT, None), WINDOWED):
        q, k, v = _qkv(g, 1, s, H, KH, hd, torch.bfloat16)
        err = max(err, _flash_case(
            pt.fa, q, k, v, True, window,
            f"granite (1, {s}, {H}/{KH}, {hd}) causal window={window} bf16"))
    return err


# ---------------------------------------------------------------------------
# 2c. kernel contracts on the card
# ---------------------------------------------------------------------------

# the contracts whose fixture must show one TBE kernel in its profile
ONE_TBE_KERNEL = ("kernels.ops.embedding_bag_batched[fused]",
                  "kernels.ops.embedding_bag_batched_flat",
                  "cache.cached_bag.device_lookup")


def phase_contracts(pt) -> dict:
    """Every attached kernel contract against its fixture on the card
    (``repro_torch.analysis.fixtures.run_all``): each fixture's one call
    runs under set_sync_debug_mode("error") and a dispatch-mode census,
    with its kernel-wrapper calls, LAUNCH_COUNTS deltas and the profiler's
    TBE device kernels held to the contract's launch bounds."""
    log("== 2c. kernel contracts on the card (fixtures at the reference's "
        "shapes; sync debug mode 'error'; TBE kernels by the profiler)")
    t0 = time.perf_counter()
    reports = pt.fixtures.run_all(device=DEV, device_kernel=pt.TBE_KERNEL)
    check(len(reports) == len(pt.repo_contracts()),
          "a fixture for every attached contract")
    out = {}
    for r in reports:
        c = r.census
        log(f"  {r.contract.name}: {'ok' if r.ok else 'FAIL'}; wrapper "
            f"calls {c.calls}, launches {c.launches}, TBE device kernels "
            f"{c.device_kernels}, collectives {c.collectives or 'none'}, "
            f"host transfers {c.host_transfers or 'none'}, float dtypes "
            f"{sorted(c.float_dtypes)}")
        for v in r.violations:
            log(f"    - {v}")
        check(r.ok, f"contract {r.contract.name} holds on the card")
        out[r.contract.name] = c.device_kernels
    for name in ONE_TBE_KERNEL:
        check(out[name] == 1, f"{name}: one TBE device kernel per call")
    # injected faults on the card: a .item() (the dispatch census and the
    # sync mode both see it), and a pageable host-to-device copy inside
    # torch.as_tensor, which no dispatch mode sees
    contract = pt.kops.KERNEL_CONTRACTS["tbe_fused"]
    x = torch.randn(64, 16, device=DEV)
    faults = {
        ".item()": lambda v: v * float(v.abs().max().item()),
        "torch.as_tensor(numpy, device=cuda)": lambda v: v + torch.as_tensor(
            np.arange(16, dtype=np.float32), device=v.device),
    }
    for label, fn in faults.items():
        r = pt.audit(fn, (x,), dataclasses.replace(contract, min_launches=0,
                                                   max_launches=0))
        # caught as a host transfer and as nothing else
        caught = bool(r.census.host_transfers) and bool(r.violations) and \
            all(v.startswith("host transfer ") for v in r.violations)
        log(f"  injected {label}: {'caught' if caught else 'NOT CAUGHT'} "
            f"{r.census.host_transfers}; violations {r.violations}")
        check(caught, f"the audit on the card catches an injected {label} "
                      f"as a host transfer")
    log(f"  phase 2c: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 3. / 4. the engine at full width
# ---------------------------------------------------------------------------

def _requests(cfg, CTRRequest, n, seed):
    """Zipf(1.05) ids, lengths in [1, L], -1 padding beyond lengths."""
    from repro_torch.core.jagged import zipf_ranks

    rng = np.random.default_rng(seed)
    t_, l_ = cfg.num_sparse_features, cfg.pooling
    ids = zipf_ranks(rng, 1.05, cfg.rows_per_table,
                     (n, t_, l_)).astype(np.int32)
    lengths = rng.integers(1, l_ + 1, (n, t_)).astype(np.int32)
    ids[np.arange(l_) >= lengths[..., None]] = -1
    dense = rng.standard_normal(
        (n, cfg.num_dense_features)).astype(np.float32)
    return [CTRRequest(rid=i, dense=dense[i], indices=ids[i],
                       lengths=lengths[i]) for i in range(n)]


def _fetched_rows(eng) -> int:
    st = eng.cache_stats()
    return 0 if st is None else st.fetch_host + st.fetch_remote


def _serve(eng, kmods):
    """Flush the whole queue, each flush timed by CUDA events; every
    kernel module's launch counts are set to 0 just before and read just
    after.  Also returns the rows each flush fetched from the cold tier."""
    scores, heads, ms, splits, fetched = {}, [], [], 0, []
    for mod in kmods:
        mod.reset_launch_counts()
    while eng.queue:
        before = _fetched_rows(eng)
        head = eng.queue[: eng.batch_size]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eng.flush()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        fetched.append(_fetched_rows(eng) - before)
        splits += len(out) < len(head)
        heads.append(head)
        scores.update(out)
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    return scores, heads, ms, splits, counts, fetched


def _profile_flush(eng, heads, median_ms, label,
                   kernels=("tbe_gather_pool_kernel",)):
    """One more flush under torch.profiler (after the launch counts were
    read), of the next requests of the iterator ``heads`` each time a
    profile is taken (``_profiled``): device time by kernel and the
    device's busy share of the median unprofiled flush; checks that each
    of ``kernels`` ran.  Returns the idle share in percent and, for each
    of ``kernels``, its device ms and launches."""

    def flush():
        for r in next(heads):
            eng.submit(r)
        eng.flush()

    events = _device_events(_profiled(flush, f"the {label} flush"))
    ran = {}
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        check(bool(mine), f"the profiled {label} flush ran {kernel}")
        ran[kernel] = (sum(e.self_device_time_total for e in mine) / 1e3,
                       sum(e.count for e in mine))
        log(f"  profiled {label} flush: {kernel} {ran[kernel][0]:.4f} ms of "
            f"device time over {ran[kernel][1]} launch(es)")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled {label} flush: device busy {busy_ms:.3f} ms = "
        f"{100 * busy_ms / median_ms:.1f}% of the median flush "
        f"({median_ms:.3f} ms); idle {100 - 100 * busy_ms / median_ms:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} "
            f"{e.key[:90]}")
    return 100 - 100 * busy_ms / median_ms, ran


def _padded(eng, head):
    dense, idx, lens = eng._pad_batch(head)
    dev = torch.device(DEV)
    return (torch.as_tensor(dense, device=dev),
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(lens, device=dev))


def phase_uncached(pt, eg, oa) -> dict:
    log("== 3. uncached engine at full width (CONFIG)")
    cfg = pt.CONFIG
    t0 = time.perf_counter()
    params = pt.init_params(torch.Generator(device=DEV).manual_seed(1),
                            cfg, device=DEV)
    torch.cuda.synchronize()
    log(f"  init_params: {cfg.num_sparse_features} x {cfg.rows_per_table} x "
        f"{cfg.embedding_dim} {cfg.dtype} tables "
        f"({cfg.embedding_config().table_bytes / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = _requests(cfg, pt.CTRRequest, REQUESTS, seed=2)
    eng = pt.DLRMEngine(params, cfg, batch_size=BATCH, device=DEV)
    for r in reqs:
        eng.submit(r)
    scores, heads, ms, _, counts, _ = _serve(eng, (eg, oa, pt.fa))
    log(f"  {len(scores)} requests in {len(heads)} flushes; launches "
        f"{counts}; flush ms {[round(m, 3) for m in ms]}, median "
        f"{statistics.median(ms):.3f} ms (CUDA events)")
    vals = np.array(list(scores.values()))
    check(len(scores) == REQUESTS and np.isfinite(vals).all()
          and ((vals > 0) & (vals < 1)).all(), "8192 finite pCTRs in (0, 1)")
    check(counts == _launches(gather_pool_tbe=len(heads)),
          "one fused TBE launch per flush")

    # the plain score on the card: ref.py pooling + the model's own
    # interaction and MLPs
    err = 0.0
    with torch.no_grad():
        for head in heads:
            dense, idx, lens = _padded(eng, head)
            pooled = pt.ref.embedding_bag_batched_ref(
                params["tables"], idx, lens).transpose(0, 1)
            bot = pt.dlrm._mlp_apply(params["bottom"], dense, final_act=True)
            logit = pt.dlrm._mlp_apply(
                params["top"], pt.dlrm.dot_interaction(bot, pooled))[:, 0]
            want = torch.sigmoid(logit)[: len(head)].double().cpu()
            got = torch.tensor([scores[r.rid] for r in head],
                               dtype=torch.float64)
            err = max(err, float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, **PCTR_TOL)),
                  "engine pCTR vs plain score")
    log(f"  engine vs plain score on the card: max_abs_err {err:.3e} "
        f"(rtol={PCTR_TOL['rtol']} atol={PCTR_TOL['atol']}) ok")

    # fused=False: one flush is T single-table launches, same scores
    eng_u = pt.DLRMEngine(params, dataclasses.replace(cfg, fused=False),
                          batch_size=BATCH, device=DEV)
    for r in heads[0]:
        eng_u.submit(r)
    scores_u, _, ms_u, _, counts_u, _ = _serve(eng_u, (eg, oa, pt.fa))
    log(f"  fused=False flush: launches {counts_u}, {ms_u[0]:.3f} ms")
    check(counts_u == _launches(gather_pool=cfg.num_sparse_features),
          "fused=False flush is 26 single-table launches")
    check(all(scores_u[r.rid] == scores[r.rid] for r in heads[0]),
          "fused=False scores bitwise == fused")
    log("  fused=False scores bitwise equal to fused")
    # the paper's fused-against-per-table comparison on the card: the same
    # flush's TBE device time as one launch and as T launches
    tbe = "tbe_gather_pool_kernel"
    _, fused = _profile_flush(eng, itertools.repeat(heads[1]),
                              statistics.median(ms), "uncached")
    _, per_table = _profile_flush(eng_u, itertools.repeat(heads[1]),
                                  ms_u[0], "fused=False")
    check(fused[tbe][1] == 1 and per_table[tbe][1] == cfg.num_sparse_features,
          "the profiled flushes: 1 fused launch, 26 single-table launches")
    log(f"  TBE device time of one flush: fused {fused[tbe][0]:.4f} ms "
        f"(1 launch), fused=False {per_table[tbe][0]:.4f} ms "
        f"({per_table[tbe][1]} gather_pool launches)")
    return dict(params=params, reqs=reqs, scores=scores, heads=heads,
                flush_ms=ms, unfused_ms=ms_u[0],
                tbe_device_ms=dict(fused=fused[tbe][0],
                                   unfused=per_table[tbe][0]),
                launches={"gather_pool_tbe": counts["gather_pool_tbe"],
                          "gather_pool": counts_u["gather_pool"]})


COUNTERS = ("hits", "misses", "misses_host", "misses_remote", "evictions",
            "fetch_host", "fetch_remote", "bytes_h2d", "bytes_remote")


def _check_pooled(pt, eng, unc, label) -> None:
    """The cached engine's pooled lookups bitwise-equal to the uncached
    ``pooled_lookup_local`` over the full tables, batch by batch."""
    ecfg = pt.CONFIG.embedding_config()
    with torch.no_grad():
        for head in unc["heads"]:
            _, idx, lens = _padded(eng, head)
            slots = eng.cache.prefetch_arrays(idx.cpu().numpy(),
                                              lens.cpu().numpy())
            got = eng.cache.device_lookup(
                eng.cache.pool, torch.as_tensor(slots, device=idx.device),
                lens, None)
            want = pt.eb.pooled_lookup_local(
                unc["params"]["tables"], pt.JaggedBatch(idx, lens), ecfg)
            check(torch.equal(got, want),
                  f"{label} pooled bitwise == uncached")
    log(f"  {label} pooled lookups bitwise equal to uncached "
        f"({len(unc['heads'])} batches)")


def phase_cached(pt, eg, oa, unc) -> dict:
    log("== 4. cached engine at full width (65,536 slots/table, LFU, host "
        "cold tier)")
    cache = pt.CacheConfig(rows=65536, policy="lfu", cold_tier="host")
    cfg = dataclasses.replace(pt.CONFIG, cache=cache)
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH, device=DEV)
    torch.cuda.synchronize()
    log(f"  cache built in {time.perf_counter() - t0:.1f} s: pool "
        f"{eng.cache.pool_bytes / 1e6:.0f} MB on the card, host cold tier "
        f"{eng.cache.cold.tables.numel() * 4 / 1e9:.1f} GB")
    for r in unc["reqs"]:
        eng.submit(r)
    scores, heads, ms, splits, counts, fetched = _serve(eng, (eg, oa, pt.fa))
    st = eng.cache_stats()
    counters = {k: getattr(st, k) for k in COUNTERS}
    log(f"  {len(scores)} requests in {len(heads)} flushes, {splits} "
        f"half-split(s); launches {counts}; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms")
    log(f"  hit rate {st.hit_rate:.4f} ({st.hits} hits, {st.misses} misses),"
        f" {st.evictions} evictions, {st.bytes_h2d / 1e6:.1f} MB h2d; "
        f"prefetch {st.prefetch_s:.3f} s, scatter {st.scatter_s:.3f} s, "
        f"forward {st.forward_s:.3f} s")
    hit_rate = st.hit_rate
    check(counts == _launches(gather_pool_tbe_flat=len(heads)),
          "one fused flat TBE launch per cached flush")
    log(f"  rows fetched from the cold tier per flush: {fetched}")
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          "cached scores bitwise == uncached")
    log("  cached scores bitwise equal to uncached")
    _check_pooled(pt, eng, unc, "cached")
    _profile_flush(eng, itertools.repeat(unc["heads"][1]),
                   statistics.median(ms), "cached")
    return dict(launches=counts["gather_pool_tbe_flat"], flush_ms=ms,
                splits=splits, hit_rate=hit_rate, fetched=fetched,
                counters=counters)


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def _times(fn, reps, scratch):
    """Per-launch CUDA-event times (ms), L2 evicted before each launch by
    writing a buffer five times its size.  The card spins for about a
    millisecond before each timed region, so that the host has enqueued
    all of ``fn``'s launches before the card reaches them: the time is the
    card's, not the rate at which the host issues launches."""
    evs = []
    for _ in range(reps):
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in evs]


def _bound(addr, w, t_, d_, itemsize):
    """Least time: the unique rows this data reads plus ids, weights,
    offsets and output, once each, over HBM; or 2 flops per valid
    element over the fp32 rate; whichever is larger."""
    live = w != 0
    rows = torch.unique(addr[live]).numel()
    n = w.numel()
    nbytes = rows * d_ * itemsize + n * 8 + t_ * 4 + (n // w.shape[-1]) \
        * d_ * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * int(live.sum()) * d_ / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _pow2(m: int) -> int:
    return 1 << (m - 1).bit_length()


def _times_puts(oa, m_pad, scratch) -> dict:
    """The puts of one row fetch (one launch for the 4 simulated hosts) at
    ``m_pad`` padded rows, against the plain exchange and the one PyTorch
    call that computes it; checked bitwise first."""
    g = torch.Generator(device=DEV).manual_seed(5)
    c = _contribs(g, HOSTS, m_pad, D, torch.float32, torch.device(DEV))
    err = _check_puts(oa, c, f"H={HOSTS} M_pad={m_pad} D={D} f32")
    kern = lambda: oa.onesided_put_rows(c)
    plain = lambda: oa.onesided_put_rows_ref(c)
    lib = lambda: c.transpose(0, 1).contiguous()
    check(torch.equal(_bits(lib()), _bits(plain())),
          "onesided_put_rows: library yardstick computes the same exchange")
    p1 = _times(plain, 10, scratch)
    k1 = _times(kern, 10, scratch)
    l1 = _times(lib, 20, scratch)
    k2 = _times(kern, 10, scratch)
    p2 = _times(plain, 10, scratch)
    # each put reads one row and writes it once: 2 * H * (H * M_pad * D)
    # elements; no arithmetic
    bound_ms = 2 * HOSTS * HOSTS * m_pad * D * 4 / HBM_BYTES_PER_S * 1e3
    out = dict(ms=statistics.median(k1 + k2),
               plain_ms=statistics.median(p1 + p2),
               library_ms=statistics.median(l1), bound_ms=bound_ms,
               bound_by="bytes", max_abs_err=err)
    log(f"  onesided_put_rows (H={HOSTS}, M_pad={m_pad}, D={D}, one fetch = "
        f"one launch): kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes); kernel at "
        f"{100 * bound_ms / out['ms']:.1f}% of the bound")
    return out


def phase_times(eg, oa, x, m_pad) -> dict:
    """The TBE wrappers' times at the phase-2 shapes and the row fetch's
    puts' at ``m_pad`` padded rows."""
    log("== 5. times (f32; median of 20 launches per version, in turns "
        "plain, kernel, library, library, kernel, plain; the card's time, "
        "the host's launches enqueued ahead)")
    F = torch.nn.functional
    tables, idx, w, mask = x["tables"], x["idx"], x["w"], x["mask"]
    flat = tables.view(T * R, D)
    off, idx_r = x["off"], x["idx_r"]
    ar = (torch.arange(T, device=tables.device) * R)[:, None, None]
    g_flat = (off.long()[:, None, None] + torch.where(mask, idx_r, 0)).view(
        T * B, L)
    g_stack = (ar + torch.where(mask, idx, 0)).view(T * B, L)
    one = min(5, T - 1)
    g_one = torch.where(mask[one], idx[one], 0).long()
    cases = {
        "gather_pool_tbe_flat": (
            lambda: eg.gather_pool_tbe_flat(flat, off, idx_r, w),
            lambda: eg.gather_pool_tbe_flat_ref(flat, off, idx_r, w),
            lambda: F.embedding_bag(g_flat, flat, mode="sum",
                                    per_sample_weights=w.view(T * B, L)),
            (g_flat.view(T, B, L), w, T)),
        "gather_pool_tbe": (
            lambda: eg.gather_pool_tbe(tables, idx, w),
            lambda: eg.gather_pool_tbe_ref(tables, idx, w),
            lambda: F.embedding_bag(g_stack, flat, mode="sum",
                                    per_sample_weights=w.view(T * B, L)),
            (g_stack.view(T, B, L), w, T)),
        "gather_pool": (
            lambda: eg.gather_pool(tables[one], idx[one], w[one]),
            lambda: eg.gather_pool_ref(tables[one], idx[one], w[one]),
            lambda: F.embedding_bag(g_one, tables[one], mode="sum",
                                    per_sample_weights=w[one]),
            (g_one[None], w[one][None], 1)),
    }
    scratch = torch.empty(256 * 2 ** 20 // 4, device=tables.device)
    out = {}
    for name, (kern, plain, lib, (addr, ww, t_)) in cases.items():
        want = plain().reshape(-1, D)
        check(bool(torch.allclose(lib().reshape(-1, D), want, **POOL_TOL)),
              f"{name}: library yardstick computes the same function")
        kern()
        p1 = _times(plain, 10, scratch)
        k1 = _times(kern, 10, scratch)
        l1 = _times(lib, 20, scratch)
        k2 = _times(kern, 10, scratch)
        p2 = _times(plain, 10, scratch)
        bound_ms, bound_by = _bound(addr, ww, t_, D, 4)
        out[name] = dict(ms=statistics.median(k1 + k2),
                         plain_ms=statistics.median(p1 + p2),
                         library_ms=statistics.median(l1),
                         bound_ms=bound_ms, bound_by=bound_by)
        log(f"  {name}: kernel {out[name]['ms']:.4f} ms, plain "
            f"{out[name]['plain_ms']:.4f} ms, library "
            f"{out[name]['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); kernel at {100 * bound_ms / out[name]['ms']:.1f}%"
            f" of the bound")
    out["onesided_put_rows"] = _times_puts(oa, m_pad, scratch)
    return out


def _attn_pairs(s, causal, window) -> int:
    """(query, key) pairs that the masks leave at sequence length s."""
    pos = torch.arange(s)
    hi = pos + 1 if causal else torch.full_like(pos, s)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    return int((hi - lo).sum())


def times_flash(pt) -> dict:
    """The flash kernel at granite-8b's layer (1, 16,384, 32/8, 128) bf16
    causal, against its plain version, SDPA (the one PyTorch call that
    computes the same function), the SIMT kernel (the other route, forced
    through ``_launch``, which counts nothing, so that both kernels are
    timed on one card) and the bound: the products QK^T and P.V of the
    live (query, key) pairs over the bf16 tensor-core peak, or q, k, v
    read and o written once over HBM.  The windowed shape is timed too
    (logged; SDPA has no window)."""
    fa, cfg = pt.fa, pt.LM_CONFIG
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=DEV).manual_seed(10)
    scratch = torch.empty(256 * 2 ** 20 // 4, device=DEV)
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {}
    for s, window in ((LONG_PROMPT, None), WINDOWED):
        q, k, v = _qkv(g, 1, s, H, KH, hd, torch.bfloat16)
        kern = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
        simt = lambda: fa._launch(q, k, v, True, window, route="simt")
        plain = lambda: fa.flash_attention_ref(q, k, v, causal=True,
                                               window=window)
        lib = lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), is_causal=True,
                           enable_gqa=True)
        kern()
        compare(f"flash_attention SIMT kernel (1, {s}, {H}/{KH}, {hd}) "
                f"window={window}", simt().float(), plain().float(),
                FLASH_TOL[torch.bfloat16])
        p1 = _times(plain, 1, scratch)
        k1 = _times(kern, 10, scratch)
        s1 = _times(simt, 1, scratch)
        l1 = []
        if window is None:
            check(bool(torch.allclose(lib().transpose(1, 2).float(),
                                      plain().float(), **SDPA_TOL)),
                  "flash_attention: SDPA computes the same function")
            l1 = _times(lib, 10, scratch)
        s2 = _times(simt, 1, scratch)
        k2 = _times(kern, 10, scratch)
        p2 = _times(plain, 1, scratch)
        flops = 4 * _attn_pairs(s, True, window) * H * hd
        t_ops = flops / BF16_FLOPS_PER_S
        t_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) / HBM_BYTES_PER_S
        r = dict(ms=statistics.median(k1 + k2),
                 plain_ms=statistics.median(p1 + p2),
                 library_ms=statistics.median(l1) if l1 else None,
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 simt_ms=statistics.median(s1 + s2))
        lib_txt = (f"SDPA {r['library_ms']:.4f} ms, " if l1 else "")
        log(f"  flash_attention (1, {s}, {H}/{KH}, {hd}) bf16 causal "
            f"window={window} (medians of 20 kernel, 2 SIMT, 2 plain, 10 "
            f"SDPA launches): kernel {r['ms']:.4f} ms, SIMT kernel "
            f"{r['simt_ms']:.3f} ms ({r['simt_ms'] / r['ms']:.1f}x the "
            f"kernel), plain {r['plain_ms']:.3f} ms, {lib_txt}bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of the bound, "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s")
        if window is None:
            out["flash_attention"] = r
    return out


# ---------------------------------------------------------------------------
# 6. the remote cold tier
# ---------------------------------------------------------------------------

def _serve_remote(pt, eg, oa, unc, cached, backend) -> dict:
    """The phase-4 cache over the remote tier on ``backend``: serve the
    phase-3 requests, check them, profile one flush of fresh requests."""
    cache = pt.CacheConfig(rows=65536, policy="lfu", cold_tier="remote",
                           remote_hosts=HOSTS, remote_backend=backend)
    cfg = dataclasses.replace(pt.CONFIG, cache=cache)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH, device=DEV)
    torch.cuda.synchronize()
    cold = eng.cache.cold
    check(isinstance(cold, pt.RemoteStore) and cold.hosts == HOSTS
          and cold.shards.device.type == "cuda"
          and eng.params["tables"] is None,
          "the engine holds only the slot pool and the shards on the card")
    log(f"  [{backend}] cache built in {time.perf_counter() - t0:.1f} s: "
        f"pool {eng.cache.pool_bytes / 1e6:.0f} MB and {HOSTS} shards of "
        f"{cold.shards.shape[1]} x {cold.shards.shape[2]} rows "
        f"({cold.shards.numel() * 4 / 1e9:.1f} GB) on the card")
    for r in unc["reqs"]:
        eng.submit(r)
    fetches = []
    prev = pt.comm.set_event_sink(fetches.append)
    try:
        scores, heads, ms, splits, counts, fetched = _serve(
            eng, (eg, oa, pt.fa))
    finally:
        pt.comm.set_event_sink(prev)
    st = eng.cache_stats()
    counters = {k: getattr(st, k) for k in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m_pads = [ev.bytes_in // (HOSTS * D * 4) for ev in fetches]
    fetch_ms = [1e3 * (ev.t1 - ev.t0) for ev in fetches]
    log(f"  [{backend}] {len(scores)} requests in {len(heads)} flushes, "
        f"{splits} half-split(s); launches {counts}; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms")
    log(f"  [{backend}] {len(fetches)} fetches: rows {fetched}, padded "
        f"{m_pads}, fetch ms {[round(m, 3) for m in fetch_ms]} (host clock, "
        f"to the payloads on the host); misses host {st.misses_host} / "
        f"remote {st.misses_remote}, {st.bytes_h2d / 1e6:.1f} MB h2d, "
        f"{st.bytes_remote / 1e6:.1f} MB remote; prefetch "
        f"{st.prefetch_s:.3f} s, scatter {st.scatter_s:.3f} s, forward "
        f"{st.forward_s:.3f} s; peak device memory {peak_gb:.1f} GB")
    check(counts["gather_pool_tbe_flat"] == len(heads)
          and counts["gather_pool"] == counts["gather_pool_tbe"] == 0,
          f"[{backend}] one fused flat TBE launch per flush")
    check(len(fetches) == sum(f > 0 for f in fetched) > 0,
          f"[{backend}] one fetch per flush that missed")
    want_puts = len(fetches) if backend == "onesided" else 0
    check(counts["onesided_put_rows"] == want_puts,
          f"[{backend}] {want_puts} put launches (1 per non-empty fetch)")
    # the same admission decisions as the host tier: the same fetches
    check(fetched == cached["fetched"]
          and m_pads == [_pow2(f) for f in fetched if f],
          f"[{backend}] the host tier's fetches, padded to powers of two")
    host = cached["counters"]
    check(all(counters[k] == host[k] for k in
              ("hits", "misses", "evictions"))
          and st.misses_host + st.misses_remote == host["misses"]
          and st.fetch_host + st.fetch_remote == host["fetch_host"],
          f"[{backend}] the host tier's counters, split by owner")
    row_bytes = eng.cache.row_bytes
    check(st.misses_remote > 0
          and st.bytes_remote == st.fetch_remote * row_bytes
          and st.bytes_h2d == st.fetch_host * row_bytes,
          f"[{backend}] remote misses, bytes == fetched rows x row bytes")
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          f"[{backend}] remote-tier scores bitwise == uncached")
    log(f"  [{backend}] scores bitwise equal to uncached")
    _check_pooled(pt, eng, unc, f"[{backend}] remote-tier")
    # a flush of fresh requests, so that the profiled flush fetches (new
    # ones for each profile taken)
    fresh = (_requests(pt.CONFIG, pt.CTRRequest, BATCH, seed=seed)
             for seed in itertools.count(3))
    idle, _ = _profile_flush(
        eng, fresh, statistics.median(ms), f"remote {backend}",
        ("tbe_gather_pool_kernel",) + (
            ("put_chunks_kernel",) if backend == "onesided" else ()))
    return dict(flush_ms=ms, launches=counts["onesided_put_rows"],
                fetches=len(fetches), m_pads=m_pads, fetch_ms=fetch_ms,
                counters=counters, idle=idle, peak_gb=peak_gb)


def phase_remote(pt, eg, oa, unc, cached) -> dict:
    log(f"== 6. cached engine over the remote cold tier (65,536 slots/table,"
        f" LFU, tables row-split over {HOSTS} simulated hosts on the card)")
    out = {}
    for backend in ("bulk", "onesided"):
        out[backend] = _serve_remote(pt, eg, oa, unc, cached, backend)
        torch.cuda.empty_cache()        # the shards of this engine go
    return out


# ---------------------------------------------------------------------------
# 6b. pipelined serving
# ---------------------------------------------------------------------------

def _serve_pipelined(pt, kmods, eng, reqs):
    """``run_to_completion`` of ``reqs`` on a pipelined engine, every
    kernel module's launch counts set to 0 just before and read just
    after.  Wall time on the host clock, up to the last scores on the host
    (the drain's copy waits for the main stream, which waited on the side
    stream's events).  Also returns the remote fetches it made."""
    for r in reqs:
        eng.submit(r)
    fetches = []
    prev = pt.comm.set_event_sink(fetches.append)
    for mod in kmods:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        scores = eng.run_to_completion()
    finally:
        pt.comm.set_event_sink(prev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    return scores, wall_ms, counts, fetches


def _pipelined_engine(pt, unc, label, **cache):
    cfg = dataclasses.replace(pt.CONFIG, cache=pt.CacheConfig(
        policy="lfu", pipeline_depth=2, **cache))
    t0 = time.perf_counter()
    eng = pt.make_dlrm_engine(unc["params"], cfg, BATCH, device=DEV)
    torch.cuda.synchronize()
    ring = eng.cache
    check(isinstance(eng, pt.PipelinedDLRMEngine) and ring.depth == 2
          and isinstance(eng.scheduler.side, torch.cuda.Stream)
          and all(b.cold is ring.buffers[0].cold for b in ring.buffers)
          and all(b.stats is ring.stats for b in ring.buffers),
          f"[{label}] make_dlrm_engine built a depth-2 ring over one cold "
          f"tier, with a side stream")
    log(f"  [{label}] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{ring.depth} pools of {ring.buffers[0].pool_bytes / 1e6:.0f} MB "
        f"({ring.pool_bytes / 1e9:.3f} GB) on the card, one "
        f"{type(ring.buffers[0].cold).__name__} cold tier")
    return eng


def _check_pipelined(pt, eng, unc, scores, label) -> None:
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          f"[{label}] depth-2 scores bitwise == uncached")
    log(f"  [{label}] {len(scores)} scores bitwise equal to phase 3")
    spans = eng.trace.spans
    race = pt.check_timeline(spans, depth=2)
    static = pt.check_scheduler_source()
    log(f"  [{label}] check_timeline over {len(spans)} spans: "
        f"{[str(v) for v in race] or 'clean'}; check_scheduler_source: "
        f"{[str(v) for v in static] or 'clean'}")
    check(not race and not static, f"[{label}] the epoch protocol holds")


def _stage_log(pt, eng, label) -> dict:
    st, tr = eng.cache_stats(), eng.trace
    stages = {s: tr.total(s) for s in pt.STAGES}
    prefetch_ms = [round(1e3 * sum(s.seconds for s in tr.spans
                                   if s.batch == k
                                   and s.stage in ("admit", "fetch")), 3)
                   for k in sorted({s.batch for s in tr.spans})]
    log(f"  [{label}] stage totals (s, host clock): "
        + ", ".join(f"{s} {t:.4f}" for s, t in stages.items())
        + f"; overlap_s {tr.overlap_s():.4f}, overlap_fraction "
        f"{tr.overlap_fraction():.4f}; hit rate {st.hit_rate:.4f} "
        f"({st.misses} misses), {st.fetch_host + st.fetch_remote} rows "
        f"fetched, {st.evictions} evictions, fallbacks "
        f"{eng.scheduler.fallbacks}; admit + fetch ms by batch "
        f"{prefetch_ms}")
    return dict(stages=stages, overlap_s=tr.overlap_s(),
                overlap_fraction=tr.overlap_fraction(),
                hit_rate=st.hit_rate, misses=st.misses,
                fetched=st.fetch_host + st.fetch_remote)


def _stream_overlap(pt_prof) -> dict:
    """Device kernels and copies of a profiled pipelined run, by stream:
    the streams of the scatter's ``index_copy_`` kernels and of the TBE
    launches, and the device time in which a side-stream kernel or copy
    ran while a kernel of the TBE's (main) stream ran."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        pt_prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy")
           and "stream" in e.get("args", {})]
    streams = lambda key: sorted({e["args"]["stream"] for e in dev
                                  if key in e.get("name", "")})
    scatter, tbe = streams("index_copy"), streams("tbe_gather_pool_kernel")
    main = set(tbe)
    fwd = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev
                 if e["args"]["stream"] in main and e["cat"] == "kernel")
    side = [e for e in dev if e["args"]["stream"] not in main]
    both_us, hits = 0.0, 0
    for e in side:
        s0, s1 = e["ts"], e["ts"] + e["dur"]
        inside = sum(max(0.0, min(s1, f1) - max(s0, f0)) for f0, f1 in fwd)
        both_us += inside
        hits += inside > 0
    return dict(scatter_streams=scatter, tbe_streams=tbe,
                side_events=len(side), side_overlapping=hits,
                overlap_ms=both_us / 1e3)


def phase_pipelined(pt, eg, oa, unc, cached, remote) -> dict:
    log("== 6b. pipelined serving (depth 2: two slot pools, prefetch on a "
        "side CUDA stream), phase 3's requests")
    kmods = (eg, oa, pt.fa)
    n_batches = -(-REQUESTS // BATCH)
    out = {}
    # (a) the host cold tier, as phase 4
    eng = _pipelined_engine(pt, unc, "host", rows=65536, cold_tier="host")
    scores, wall, counts, _ = _serve_pipelined(pt, kmods, eng, unc["reqs"])
    serial_ms = sum(cached["flush_ms"])
    log(f"  [host] run_to_completion {wall:.3f} ms (host clock) against "
        f"phase 4's flushes summed {serial_ms:.3f} ms "
        f"({wall / serial_ms:.3f}x); launches {counts}")
    check(counts == _launches(gather_pool_tbe_flat=n_batches),
          "[host] one fused flat TBE launch per micro-batch")
    _check_pipelined(pt, eng, unc, scores, "host")
    out["host"] = dict(wall_ms=wall, serial_ms=serial_ms,
                       pool_bytes=eng.cache.pool_bytes,
                       **_stage_log(pt, eng, "host"))
    log(f"  [host] hit rate {out['host']['hit_rate']:.4f} against phase 4's "
        f"{cached['hit_rate']:.4f} (each pool sees every other batch); "
        f"misses {out['host']['misses']} against "
        f"{cached['counters']['misses']}, rows fetched "
        f"{out['host']['fetched']} against {sum(cached['fetched'])} "
        f"({cached['fetched']} by flush)")
    # (d) one profiled depth-2 run of fresh requests on the same engine
    from torch.profiler import ProfilerActivity, profile

    for r in _requests(pt.CONFIG, pt.CTRRequest, REQUESTS, seed=3):
        eng.submit(r)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_to_completion()
    ov = _stream_overlap(prof)
    log(f"  [profiled] index_copy_ (scatter) kernels on stream(s) "
        f"{ov['scatter_streams']}, TBE launches on stream(s) "
        f"{ov['tbe_streams']}; {ov['side_events']} kernels/copies off the "
        f"TBE's stream, {ov['side_overlapping']} of them ran while a "
        f"kernel of that stream ran ({ov['overlap_ms']:.3f} ms of device "
        f"time)")
    out["profile"] = ov
    del eng, scores
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the remote tier, one-sided, as phase 6
    torch.cuda.reset_peak_memory_stats()
    eng = _pipelined_engine(pt, unc, "remote onesided", rows=65536,
                            cold_tier="remote", remote_hosts=HOSTS,
                            remote_backend="onesided")
    scores, wall, counts, fetches = _serve_pipelined(pt, kmods, eng,
                                                     unc["reqs"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serial_ms = sum(remote["onesided"]["flush_ms"])
    log(f"  [remote onesided] run_to_completion {wall:.3f} ms against "
        f"phase 6's one-sided flushes summed {serial_ms:.3f} ms "
        f"({wall / serial_ms:.3f}x); launches {counts}; {len(fetches)} "
        f"fetches; peak device memory {peak_gb:.1f} GB (phase 6: "
        f"{remote['onesided']['peak_gb']:.1f} GB)")
    check(counts["gather_pool_tbe_flat"] == n_batches
          and counts["onesided_put_rows"] == len(fetches) > 0,
          "[remote onesided] one TBE launch per micro-batch, one put launch "
          "per non-empty fetch")
    _check_pipelined(pt, eng, unc, scores, "remote onesided")
    out["remote"] = dict(wall_ms=wall, serial_ms=serial_ms, peak_gb=peak_gb,
                         puts=counts["onesided_put_rows"],
                         tbe=counts["gather_pool_tbe_flat"],
                         fallbacks=eng.scheduler.fallbacks,
                         **_stage_log(pt, eng, "remote onesided"))
    del eng, scores
    gc.collect()
    torch.cuda.empty_cache()
    # (c) a pool that half of the micro-batches overflow: the largest
    # per-table working set of each batch, the pool one of the smaller ones
    ws = []
    for head in unc["heads"]:
        idx = np.stack([r.indices for r in head])        # (B, T, L)
        ws.append(max(len(np.unique(idx[:, t][idx[:, t] >= 0]))
                      for t in range(idx.shape[1])))
    slots = sorted(ws)[(len(ws) - 1) // 2]
    eng = _pipelined_engine(pt, unc, "overflow", rows=slots,
                            cold_tier="host")
    scores, wall, counts, _ = _serve_pipelined(pt, kmods, eng, unc["reqs"])
    fallbacks = eng.scheduler.fallbacks
    log(f"  [overflow] {slots} slots a table against the micro-batches' "
        f"largest per-table working sets {ws} (numpy {np.__version__}'s "
        f"draws): {fallbacks} fallback(s), "
        f"{counts['gather_pool_tbe_flat']} TBE launches, run_to_completion "
        f"{wall:.3f} ms")
    check(len(scores) == REQUESTS and not eng.queue and fallbacks >= 1,
          "[overflow] every request scored, at least one fallback")
    _check_pipelined(pt, eng, unc, scores, "overflow")
    out["overflow"] = dict(slots=slots, working_sets=ws, fallbacks=fallbacks,
                           wall_ms=wall,
                           launches=counts["gather_pool_tbe_flat"],
                           **_stage_log(pt, eng, "overflow"))
    del eng, scores
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 6c. the planner -> engine round trip, with telemetry
# ---------------------------------------------------------------------------

PLAN_ZIPF = 1.05             # the traffic skew the planner prices
PLAN_A = dict(num_shards=2, hbm_budget_bytes=0.5e9)   # 10 cached, 16 row
PLAN_B = dict(num_shards=16, hbm_budget_bytes=0.2e9)  # all 26 cached
PLAN_FALLBACK_ROWS = 65_536  # plan A's "row" tables: phase 4's pool


def _plan(pt, **kw):
    """sharding_plan.plan over CONFIG's 26 tables (H100_DGX, Zipf 1.05,
    host tier, flushes of 2048 a shard); returns the plan and its log."""
    cfg = pt.CONFIG
    specs = [pt.sp.TableSpec(f"t{i}", rows=cfg.rows_per_table,
                             dim=cfg.embedding_dim, pooling=cfg.pooling)
             for i in range(cfg.num_sparse_features)]
    t0 = time.perf_counter()
    p = pt.sp.plan(specs, batch_per_shard=BATCH, hw=pt.pm.H100_DGX,
                   zipf_a=PLAN_ZIPF, **kw)
    took = time.perf_counter() - t0
    pools = {}
    for pl in p.placements:
        key = (pl.strategy, pl.cache_rows, round(pl.est_hit_rate, 4))
        pools[key] = pools.get(key, 0) + 1
    return p, (f"planned in {took:.2f} s (host CPU): "
               + ", ".join(f"{n} x {k[0]}" + (f" {k[1]} slots est_hit_rate "
                                              f"{k[2]}" if k[1] else "")
                           for k, n in sorted(pools.items())))


def _hit_gaps(p, stats) -> list:
    """(table, est_hit_rate, measured hit_rate_t) of each cached table."""
    hr = stats.hit_rate_t
    return [(pl.index, pl.est_hit_rate, float(hr[pl.index]))
            for pl in sorted(p.placements, key=lambda q: q.index)
            if pl.strategy == "cached"]


def _log_gaps(label, gaps) -> None:
    err = [m - e for _, e, m in gaps]
    log(f"  [{label}] hit_rate_t against est_hit_rate (logged, not gated): "
        + ", ".join(f"t{t} {m:.4f}/{e:.4f}" for t, e, m in gaps))
    log(f"  [{label}] measured - est: mean {statistics.mean(err):+.4f}, "
        f"min {min(err):+.4f}, max {max(err):+.4f}")


def _telemetry_readout(pt, tel, name, label, lanes) -> dict:
    """Latency quantiles, the Chrome trace (exported to chiprun_out/ and
    validated) and its lanes; each of ``lanes`` must hold spans."""
    h = tel.request_latency(name)
    log(f"  [{label}] request latency (enqueue -> score, host clock): "
        f"{h.count} requests, p50 {1e3 * h.p50:.3f} ms, p99 "
        f"{1e3 * h.p99:.3f} ms, max {1e3 * h.max:.3f} ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = tel.export_trace(
        str(out / f"trace_6c_{label.replace(' ', '_')}.json"))
    with open(path) as fh:
        n = pt.obs.validate_chrome_trace(json.load(fh))
    by_lane = {lane: len(tel.tracer.spans(lane=lane))
               for lane in pt.obs.LANES}
    log(f"  [{label}] Chrome trace {os.path.relpath(path, ROOT)}: {n} "
        f"events, valid; spans by lane {by_lane}")
    check(all(by_lane[lane] > 0 for lane in lanes),
          f"[{label}] the {', '.join(lanes)} lanes hold spans")
    return dict(count=h.count, p50=h.p50, p99=h.p99, lanes=by_lane)


def _fit_log(pt, label, res, samples) -> dict:
    """The fitted constants beside H100_DGX's, and stage_time_error for the
    base and the fitted model, on the run's own samples."""
    base, hw = res.base, res.hw
    t_name = "onesided" if res.onesided else "bulk"
    bt, ft = getattr(base, t_name), getattr(hw, t_name)
    err_base = pt.pm.stage_time_error(samples, base, onesided=res.onesided)
    err_fit = res.error(samples)
    log(f"  [{label}] calibrate: {res.n_h2d} h2d and {res.n_remote} "
        f"fetch_remote samples; gather_overhead_s {hw.gather_overhead_s:.6g}"
        f" (H100_DGX {base.gather_overhead_s:.6g}), host_Bps "
        f"{hw.host_Bps:.6g} ({base.host_Bps:.6g}); {t_name} alpha_s "
        f"{ft.alpha_s:.6g} ({bt.alpha_s:.6g}), beta_Bps {ft.beta_Bps:.6g} "
        f"({bt.beta_Bps:.6g})")
    log(f"  [{label}] stage_time_error: H100_DGX "
        f"{ {k: round(v, 4) for k, v in err_base.items()} }, fitted "
        f"{ {k: round(v, 4) for k, v in err_fit.items()} }")
    for name, v in (("gather_overhead_s", hw.gather_overhead_s),
                    ("alpha_s", ft.alpha_s)):
        # a negative intercept is clamped to 0 (the reference's rule)
        check(v >= 0 and np.isfinite(v), f"[{label}] fitted {name} >= 0")
    for name, v in (("host_Bps", hw.host_Bps), ("beta_Bps", ft.beta_Bps)):
        # a zero slope pins the rate to inf (the reference's rule)
        check(v > 0, f"[{label}] fitted {name} > 0 or inf")
    return dict(gather_overhead_s=hw.gather_overhead_s, host_Bps=hw.host_Bps,
                alpha_s=ft.alpha_s, beta_Bps=ft.beta_Bps, n_h2d=res.n_h2d,
                n_remote=res.n_remote, err_base=err_base, err_fit=err_fit)


def phase_planned(pt, eg, oa, unc, cached) -> dict:
    log("== 6c. planner -> engine round trip (sharding_plan.plan at full "
        "width) with telemetry, phase 3's requests")
    t_phase = time.perf_counter()
    kmods = (eg, oa, pt.fa)
    n_batches = -(-REQUESTS // BATCH)
    out = {}
    # (a) plan A on the serialized engine, host tier
    p, msg = _plan(pt, **PLAN_A)
    log(f"  [plan A] {PLAN_A}: {msg}")
    cfg = dataclasses.replace(pt.CONFIG, sharding_plan=p, cache=pt.CacheConfig(
        rows=PLAN_FALLBACK_ROWS, policy="lfu", cold_tier="host"))
    vec = cfg.cache_rows_vector()
    tel = pt.Telemetry()
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH, device=DEV,
                        telemetry=tel)
    torch.cuda.synchronize()
    pool = eng.cache.pool
    want_bytes = (8 * 200_000 + 2 * 100_000 + 16 * PLAN_FALLBACK_ROWS) * D * 4
    log(f"  [plan A] engine built in {time.perf_counter() - t0:.1f} s: S_t "
        f"{eng.cache.mgr.slots_per_table.tolist()}; pool "
        f"{tuple(pool.shape)}, "
        f"{pool.numel() * pool.element_size()} B")
    check(type(eng) is pt.DLRMEngine
          and list(eng.cache.mgr.slots_per_table) == list(vec)
          and eng.params["tables"] is None,
          "[plan A] a serialized engine whose S_t is cfg.cache_rows_vector()")
    check(pool.numel() * pool.element_size() == want_bytes == 1_458_470_912
          == pt.pm.slot_pool_bytes(vec, D) == eng.cache.pool_bytes,
          "[plan A] pool bytes == slot_pool_bytes == 1,458,470,912")
    for r in unc["reqs"]:
        eng.submit(r)
    scores, heads, ms, splits, counts, fetched = _serve(eng, kmods)
    st = eng.cache_stats()
    hit_rate = st.hit_rate
    log(f"  [plan A] {len(scores)} requests in {len(heads)} flushes, "
        f"{splits} half-split(s); launches {counts}; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms "
        f"(phase 4, same run: {statistics.median(cached['flush_ms']):.3f} "
        f"ms); hit rate {st.hit_rate:.4f} (phase 4 {cached['hit_rate']:.4f}),"
        f" rows fetched {fetched}")
    check(counts == _launches(gather_pool_tbe_flat=len(heads)),
          "[plan A] one fused flat TBE launch per flush")
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          "[plan A] scores bitwise == phase 3")
    log("  [plan A] scores bitwise equal to phase 3")
    gaps = _hit_gaps(p, st)
    _log_gaps("plan A", gaps)
    lat = _telemetry_readout(pt, tel, eng.obs_name, "plan A serialized",
                             ("engine", "cache", "request"))
    samples = tel.tracer.stage_samples()
    res = pt.pm.calibrate(samples)
    check(res.n_h2d >= 4, "[plan A] at least 4 h2d samples")
    fit = _fit_log(pt, "plan A", res, samples)
    _check_pooled(pt, eng, unc, "[plan A]")
    out["a"] = dict(flush_ms=ms, launches=counts["gather_pool_tbe_flat"],
                    splits=splits, hit_rate=hit_rate, gaps=gaps,
                    latency=lat, fit=fit, pool_bytes=want_bytes)
    del eng, pool, scores
    gc.collect()
    torch.cuda.empty_cache()

    # (b) plan B (no cache.rows) on the pipelined engine, remote one-sided
    p, msg = _plan(pt, **PLAN_B)
    log(f"  [plan B] {PLAN_B}: {msg}")
    log("  [plan B] priced for the host tier: under 4 one-sided hosts the "
        "planner caches nothing at this width, and the hit-rate prices do "
        "not depend on the tier")
    cfg = dataclasses.replace(pt.CONFIG, sharding_plan=p, cache=pt.CacheConfig(
        rows=0, pipeline_depth=2, cold_tier="remote", remote_hosts=HOSTS,
        remote_backend="onesided"))
    vec = cfg.cache_rows_vector()
    tel = pt.Telemetry()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = pt.make_dlrm_engine(unc["params"], cfg, BATCH, device=DEV,
                              telemetry=tel)
    torch.cuda.synchronize()
    ring = eng.cache
    log(f"  [plan B] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{ring.depth} pools of {ring.buffers[0].pool_bytes} B, S_t "
        f"{sorted(set(vec))} ({sum(vec)} slots a pool)")
    check(isinstance(eng, pt.PipelinedDLRMEngine) and ring.depth == 2
          and cfg.cache.rows == 0
          and all(list(b.mgr.slots_per_table) == list(vec)
                  for b in ring.buffers)
          and all(b.pool_bytes == pt.pm.slot_pool_bytes(vec, D)
                  == 2_150_400_000 for b in ring.buffers),
          "[plan B] make_dlrm_engine built the pipelined engine, both pools "
          "of the plan's S_t (2 x 2,150,400,000 B)")
    for r in unc["reqs"]:
        eng.submit(r)
    # each put launch's stream, read by a wrapper of the chunk-put launcher
    # (it launches nothing itself)
    put_streams, launch = [], oa._launch_all_to_all

    def _recording(x, counter, *args, **kw):
        if counter == "onesided_put_rows":
            put_streams.append(torch.cuda.current_stream(x.device).cuda_stream)
        return launch(x, counter, *args, **kw)

    oa._launch_all_to_all = _recording
    tel.tracer.install_comm_sink()
    for mod in kmods:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        scores = eng.run_to_completion()
    finally:
        tel.tracer.remove_comm_sink()
        oa._launch_all_to_all = launch
    wall = 1e3 * (time.perf_counter() - t0)
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fetches = tel.tracer.spans(lane="comm", name="fetch_rows")
    side = getattr(eng.scheduler.side, "cuda_stream", None)
    log(f"  [plan B] run_to_completion {wall:.3f} ms (host clock); launches "
        f"{counts}; {len(fetches)} fetches, fetch ms "
        f"{[round(1e3 * f.seconds, 3) for f in fetches]}; put launches on "
        f"stream(s) {sorted(set(put_streams))}, the side stream {side}; peak "
        f"device memory {peak_gb:.1f} GB")
    check(counts == _launches(gather_pool_tbe_flat=n_batches,
                              onesided_put_rows=len(fetches))
          and len(fetches) > 0,
          "[plan B] one TBE launch per micro-batch, one put launch per "
          "non-empty fetch")
    check(len(put_streams) == len(fetches)
          and set(put_streams) == {side},
          "[plan B] every put launch issued from the side stream")
    _check_pipelined(pt, eng, unc, scores, "plan B")
    st = eng.cache_stats()
    stages = _stage_log(pt, eng, "plan B")
    gaps = _hit_gaps(p, st)
    _log_gaps("plan B", gaps)
    lat = _telemetry_readout(pt, tel, eng.obs_name, "plan B pipelined",
                             ("request", "pipeline", "comm"))
    samples = tel.tracer.stage_samples()
    res = pt.pm.calibrate(samples, onesided=True)
    check(res.n_remote >= 1, "[plan B] at least 1 fetch_remote sample")
    fit = _fit_log(pt, "plan B", res, samples)
    out["b"] = dict(wall_ms=wall, launches=counts, fetches=len(fetches),
                    hit_rate=st.hit_rate, gaps=gaps, latency=lat, fit=fit,
                    peak_gb=peak_gb, pool_bytes=ring.pool_bytes,
                    stages=stages)
    del eng, ring, scores
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 6c took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 7. the distributed embedding bag
# ---------------------------------------------------------------------------

# (label, DLRMConfig fields, ranks of the model axis); table-wise over 2
# ranks because 26 % 4 != 0
STRATEGIES = (
    ("row/allgather/bulk", dict(sharding="row"), RANKS),
    ("row/a2a/bulk", dict(sharding="row", rw_impl="a2a"), RANKS),
    ("row/a2a/onesided", dict(sharding="row", rw_impl="a2a",
                              rw_backend="onesided"), RANKS),
    ("column", dict(sharding="column"), RANKS),
    ("table", dict(sharding="table"), 2),
)


# the pull-sum's rank counts past 8, up to the kernels' MAX_RANKS (63:
# from 64 ranks PyTorch's x.sum(0) takes another order, csrc/onesided_a2a.cu)
PULL_SUM_RANKS = (9, 16, 32, 63)


def _a2a_shapes():
    """The a2a pipeline's per-flush shapes at full width: the phase-1
    bucket capacity C and the phase-3 rows Bl * T."""
    bl = BATCH // RANKS
    n = bl * T * L
    return min(max(1, int(n / RANKS * CAPACITY_FACTOR)), n), bl * T


def _same_bits(got, want) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape \
        and torch.equal(_bits(got), _bits(want))


def _check_chunk(name, got, want, tag) -> float:
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    ok = _same_bits(got, want)
    log(f"  {name} {tag}: {'bitwise equal' if ok else 'DIFFER'} "
        f"(max_abs_err {err:.3e})")
    check(ok, f"{name} {tag} bitwise == plain version")
    return err


def _check_chunk_kernels(pt, oa) -> dict:
    """The chunk kernels' three wrappers against their plain versions at
    the a2a pipeline's shapes (phase 1 int32, phase 3 f32 and bf16), at
    shapes that are not 16-byte aligned, at 1, 2, 3 and 8 ranks (the
    pull-sum also at PULL_SUM_RANKS, up to ``oa.MAX_RANKS``), on int32
    sums that overflow and on f32 sources of -0.0 and exact cancellations,
    bitwise; the bulk routes launch nothing.  Returns each wrapper's
    largest error."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(7)
    cap, rows = _a2a_shapes()
    ids = torch.randint(-T, R * T, (RANKS, RANKS, cap), generator=g,
                        device=dev, dtype=torch.int32)
    part = torch.randn((RANKS, RANKS, rows, D), generator=g, device=dev)
    odd = torch.randn((RANKS, RANKS, 1001), generator=g, device=dev)
    errs = dict.fromkeys(("onesided_all_to_all", "onesided_reduce_scatter",
                          "onesided_ring_permute"), 0.0)
    for tag, x in ((f"phase 1 int32 {tuple(ids.shape)}", ids),
                   (f"phase 3 f32 {tuple(part.shape)}", part),
                   (f"phase 3 bf16 {tuple(part.shape)}",
                    part.to(torch.bfloat16)),
                   ("unaligned bf16 (4, 4, 1001)", odd.to(torch.bfloat16)),
                   ("unaligned int32 (4, 4, 7, 3)", ids[..., :21].reshape(
                       RANKS, RANKS, 7, 3).contiguous())):
        errs["onesided_all_to_all"] = max(
            errs["onesided_all_to_all"], _check_chunk(
                "onesided_all_to_all", oa.onesided_all_to_all(x),
                oa.onesided_all_to_all_ref(x), tag))
    for tag, x in ((f"phase 3 f32 {tuple(part.shape)}", part),
                   (f"phase 3 bf16 {tuple(part.shape)}",
                    part.to(torch.bfloat16)),
                   ("unaligned f32 (4, 4, 1001)", odd)):
        got = oa.onesided_reduce_scatter(x)
        errs["onesided_reduce_scatter"] = max(
            errs["onesided_reduce_scatter"], _check_chunk(
                "onesided_reduce_scatter", got,
                oa.onesided_reduce_scatter_ref(x), tag))
        _check_chunk("onesided_reduce_scatter", got, x.sum(0),
                     tag + " vs the bulk route x.sum(0)")
    # other rank counts at a ragged chunk, every dtype: bitwise at any E,
    # since the pull-sum keeps PyTorch's four partial sums
    for e in (1, 2, 3, 8):
        f = torch.randn((e, e, 1001), generator=g, device=dev)
        i32 = torch.randint(-2**31, 2**31 - 1, (e, e, 1001), generator=g,
                            device=dev, dtype=torch.int32)
        for x in (f, f.to(torch.bfloat16), i32):
            tag = f"E={e} {str(x.dtype)[6:]} {tuple(x.shape)}"
            errs["onesided_all_to_all"] = max(
                errs["onesided_all_to_all"], _check_chunk(
                    "onesided_all_to_all", oa.onesided_all_to_all(x),
                    oa.onesided_all_to_all_ref(x), tag))
            got = oa.onesided_reduce_scatter(x)
            errs["onesided_reduce_scatter"] = max(
                errs["onesided_reduce_scatter"], _check_chunk(
                    "onesided_reduce_scatter", got,
                    oa.onesided_reduce_scatter_ref(x), tag))
            _check_chunk("onesided_reduce_scatter", got,
                         x.sum(0, dtype=x.dtype), tag + " vs x.sum(0)")
    # the pull-sum beyond 8 ranks, up to MAX_RANKS, at a ragged chunk of
    # 67 elements, and at MAX_RANKS on rows of 4-element multiples (chunk
    # 68), where PyTorch's sum would split the sources first: its order
    # stays x.sum(0)'s
    check(PULL_SUM_RANKS[-1] == oa.MAX_RANKS,
          f"the pull-sum checked up to MAX_RANKS ({oa.MAX_RANKS})")
    for e, c in [(e, 67) for e in PULL_SUM_RANKS] + [(oa.MAX_RANKS, 68)]:
        f = torch.randn((e, e, c), generator=g, device=dev)
        i32 = torch.randint(-2**31, 2**31 - 1, (e, e, c), generator=g,
                            device=dev, dtype=torch.int32)
        for x in (f, f.to(torch.bfloat16), i32):
            tag = f"E={e} {str(x.dtype)[6:]} {tuple(x.shape)}"
            got = oa.onesided_reduce_scatter(x)
            errs["onesided_reduce_scatter"] = max(
                errs["onesided_reduce_scatter"], _check_chunk(
                    "onesided_reduce_scatter", got,
                    oa.onesided_reduce_scatter_ref(x), tag))
            _check_chunk("onesided_reduce_scatter", got,
                         x.sum(0, dtype=x.dtype), tag + " vs x.sum(0)")
    # int32 partials over the whole range at phase 1's shape: the sums wrap
    wrap = torch.randint(-2**31, 2**31 - 1, tuple(ids.shape), generator=g,
                         device=dev, dtype=torch.int32)
    wide = wrap.long().sum(0)
    check(bool((wide != wide.int().long()).any()), "the int32 sums overflow")
    got = oa.onesided_reduce_scatter(wrap)
    _check_chunk("onesided_reduce_scatter", got,
                 oa.onesided_reduce_scatter_ref(wrap),
                 f"int32 {tuple(wrap.shape)} that wraps")
    check(torch.equal(got.long(), (wide + 2**31) % 2**32 - 2**31),
          "the int32 reduce-scatter wraps modulo 2**32")
    # f32 sources: rank 1 cancels rank 0 exactly, ranks 2 and 3 hold -0.0;
    # in the first 64 elements every source is -0.0
    zeros = torch.full((RANKS, RANKS, 4096), -0.0, device=dev)
    zeros[0] = torch.randn((RANKS, 4096), generator=g, device=dev)
    zeros[1] = -zeros[0]
    zeros[..., :64] = -0.0
    got = oa.onesided_reduce_scatter(zeros)
    _check_chunk("onesided_reduce_scatter", got,
                 oa.onesided_reduce_scatter_ref(zeros),
                 "f32 -0.0 and cancellations")
    _check_chunk("onesided_reduce_scatter", got, zeros.sum(0),
                 "f32 -0.0 and cancellations vs x.sum(0)")
    check(_same_bits(got, torch.zeros_like(got)),
          "-0.0 sources and exact cancellations sum to +0.0")
    ring = part[0]
    for tag, x in ((f"f32 {tuple(ring.shape)}", ring),
                   ("unaligned bf16 (4, 1001)", odd[0].to(torch.bfloat16))):
        for shift in (1, 3):
            got = oa.onesided_ring_permute(x, shift)
            errs["onesided_ring_permute"] = max(
                errs["onesided_ring_permute"], _check_chunk(
                    "onesided_ring_permute", got,
                    oa.onesided_ring_permute_ref(x, shift),
                    f"{tag} shift {shift}"))
            _check_chunk("onesided_ring_permute", got,
                         torch.roll(x, shift, 0),
                         f"{tag} shift {shift} vs torch.roll")
    oa.reset_launch_counts()
    pt.comm.all_to_all(ids, backend="bulk")
    pt.comm.reduce_scatter(part, backend="bulk")
    pt.comm.reduce_scatter(part, backend="bulk", emulate_with_a2a=True)
    pt.comm.permute_ring(ring, backend="bulk")
    torch.cuda.synchronize()
    check(set(oa.LAUNCH_COUNTS.values()) == {0},
          "the bulk routes launch no put kernel")
    log("  bulk all_to_all / reduce_scatter / permute_ring: 0 put launches")
    return errs


def _uniform_requests(cfg, CTRRequest, n, seed):
    """The no-drop traffic: uniform ids, every length L."""
    rng = np.random.default_rng(seed)
    t_, l_ = cfg.num_sparse_features, cfg.pooling
    ids = rng.integers(0, cfg.rows_per_table, (n, t_, l_)).astype(np.int32)
    dense = rng.standard_normal(
        (n, cfg.num_dense_features)).astype(np.float32)
    lengths = np.full((n, t_), l_, np.int32)
    return [CTRRequest(rid=i, dense=dense[i], indices=ids[i],
                       lengths=lengths[i]) for i in range(n)]


def _pooled_pairs(pt, eng, unc, heads, ecfg):
    """(sharded, uncached) pooled vectors of each head, batch by batch."""
    with torch.no_grad():
        for head in heads:
            _, idx, lens = _padded(eng, head)
            batch = pt.JaggedBatch(idx, lens)
            yield (pt.eb.pooled_lookup_sharded(eng.params["tables"], batch,
                                               ecfg),
                   pt.eb.pooled_lookup_local(unc["params"]["tables"], batch,
                                             pt.CONFIG.embedding_config()))


def _dropped(pt, eng, heads, ecfg):
    """Dropped lookups per rank of each flush's batch."""
    out = []
    with torch.no_grad():
        for head in heads:
            _, idx, lens = _padded(eng, head)
            _, d = pt.eb.pooled_lookup_rw_a2a_with_stats(
                eng.params["tables"], pt.JaggedBatch(idx, lens), ecfg)
            out.append(d.tolist())
    return out


def _serve_strategy(pt, eg, oa, unc, label, fields, ranks, nodrop) -> dict:
    cfg = dataclasses.replace(pt.CONFIG, **fields)
    ecfg = cfg.embedding_config()
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH,
                        ctx=pt.make_context(tp_size=ranks), device=DEV)
    torch.cuda.synchronize()
    log(f"  [{label}] {ranks} ranks; tables sharded in "
        f"{time.perf_counter() - t0:.2f} s")
    for r in unc["reqs"]:
        eng.submit(r)
    scores, heads, ms, _, counts, _ = _serve(eng, (eg, oa, pt.fa))
    n = len(heads)
    log(f"  [{label}] {len(scores)} requests in {n} flushes; launches "
        f"{ {k: v for k, v in counts.items() if v} }; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms")
    vals = np.array([scores[k] for k in sorted(scores)])
    check(sorted(scores) == sorted(unc["scores"]) and np.isfinite(vals).all()
          and ((vals > 0) & (vals < 1)).all(),
          f"[{label}] 8192 finite pCTRs in (0, 1)")
    want = np.array([unc["scores"][k] for k in sorted(scores)])
    out = dict(flush_ms=ms, counts=counts, scores=scores, heads=heads,
               pctr_err=float(np.abs(vals - want).max()))
    if label == "row/allgather/bulk":
        check(counts == _launches(gather_pool_tbe_flat=ranks * n),
              f"[{label}] one fused flat TBE launch per rank per flush")
        check(bool(np.allclose(vals, want, **PCTR_TOL)),
              f"[{label}] pCTR within tolerance of uncached")
        err = 0.0
        for got, ref in _pooled_pairs(pt, eng, unc, heads, ecfg):
            err = max(err, compare(f"[{label}] pooled vs uncached", got, ref,
                                   POOL_TOL))
        log(f"  [{label}] pCTR vs uncached max_abs_err "
            f"{out['pctr_err']:.3e} (rtol={PCTR_TOL['rtol']} "
            f"atol={PCTR_TOL['atol']}); pooled max_abs_err {err:.3e}")
    elif label.startswith("row/a2a"):
        # one launch per collective call: 3 all-to-alls, 1 reduce-scatter
        puts = dict(onesided_all_to_all=3 * n, onesided_reduce_scatter=n) \
            if label.endswith("onesided") else {}
        check(counts == _launches(**puts),
              f"[{label}] {sum(puts.values()) // n} chunk-kernel launches "
              f"per flush, no TBE launch")
        out["dropped"] = _dropped(pt, eng, heads, ecfg)
        live = [int(lens.sum()) for lens in (
            _padded(eng, h)[2] for h in heads)]
        log(f"  [{label}] dropped lookups per flush (per rank): "
            f"{out['dropped']}; of {live} live lookups")
        # the no-drop traffic: nothing dropped, and uncached's scores
        for r in nodrop["reqs"]:
            eng.submit(r)
        s_nd, h_nd, _, _, c_nd, _ = _serve(eng, (eg, oa, pt.fa))
        d_nd = _dropped(pt, eng, h_nd, ecfg)
        check(all(v == 0 for d in d_nd for v in d),
              f"[{label}] no lookup dropped on the no-drop traffic")
        check(c_nd == _launches(**{k: v // n for k, v in puts.items()}),
              f"[{label}] the no-drop flush's launches")
        got = np.array([s_nd[k] for k in sorted(s_nd)])
        ref = np.array([nodrop["scores"][k] for k in sorted(s_nd)])
        check(bool(np.allclose(got, ref, **PCTR_TOL)),
              f"[{label}] no-drop pCTR within tolerance of uncached")
        err = 0.0
        for g_, w_ in _pooled_pairs(pt, eng, unc, h_nd, ecfg):
            err = max(err, compare(f"[{label}] no-drop pooled vs uncached",
                                   g_, w_, POOL_TOL))
        log(f"  [{label}] no-drop traffic: dropped {d_nd}; pCTR vs "
            f"uncached max_abs_err {float(np.abs(got - ref).max()):.3e}; "
            f"pooled max_abs_err {err:.3e}")
        out["nodrop_err"] = float(np.abs(got - ref).max())
        out["eng"] = eng
    else:
        check(counts == _launches(gather_pool_tbe=ranks * n),
              f"[{label}] one fused TBE launch per rank per flush")
        check(all(scores[k] == unc["scores"][k] for k in scores),
              f"[{label}] scores bitwise == uncached")
        for got, ref in _pooled_pairs(pt, eng, unc, heads, ecfg):
            check(torch.equal(got, ref), f"[{label}] pooled bitwise == "
                                         f"uncached")
        log(f"  [{label}] scores and pooled lookups bitwise equal to "
            f"uncached")
    return out


def _times_chunks(pt, oa) -> dict:
    """The three wrappers at the shapes the a2a pipeline gives them (one
    launch each): the all-to-all at phase 1's int32 buckets, the
    reduce-scatter at phase 3's f32 partials, the ring at a rank's block of
    them; against the plain version, the one PyTorch call that computes the
    same function, and the bytes bound.  The all-to-all alone at phase 3's
    shape is timed too (logged, not in the kernels line)."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(8)
    cap, rows = _a2a_shapes()
    part = torch.randn((RANKS, RANKS, rows, D), generator=g, device=dev)
    ids = torch.randint(0, R * T, (RANKS, RANKS, cap), generator=g,
                        device=dev, dtype=torch.int32)
    ring = part[0]
    scratch = torch.empty(256 * 2 ** 20 // 4, device=dev)
    nbytes = part.numel() * 4
    cases = {
        "onesided_all_to_all": (
            lambda: oa.onesided_all_to_all(ids),
            lambda: oa.onesided_all_to_all_ref(ids),
            lambda: ids.transpose(0, 1).contiguous(),
            2 * ids.numel() * 4, 0),
        "onesided_reduce_scatter": (
            lambda: oa.onesided_reduce_scatter(part),
            lambda: oa.onesided_reduce_scatter_ref(part),
            lambda: part.sum(0),
            nbytes + nbytes // RANKS, part.numel() - part[0].numel()),
        "onesided_ring_permute": (
            lambda: oa.onesided_ring_permute(ring, 1),
            lambda: oa.onesided_ring_permute_ref(ring, 1),
            lambda: torch.roll(ring, 1, 0),
            2 * ring.numel() * 4, 0),
        "phase-3 all-to-all alone (f32)": (
            lambda: oa.onesided_all_to_all(part),
            lambda: oa.onesided_all_to_all_ref(part),
            lambda: part.transpose(0, 1).contiguous(),
            2 * nbytes, 0),
    }
    out = {}
    for name, (kern, plain, lib, moved, flops) in cases.items():
        check(_same_bits(lib(), plain()),
              f"{name}: library yardstick computes the same function")
        kern()
        p1 = _times(plain, 10, scratch)
        k1 = _times(kern, 10, scratch)
        l1 = _times(lib, 20, scratch)
        k2 = _times(kern, 10, scratch)
        p2 = _times(plain, 10, scratch)
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = flops / FP32_FLOPS_PER_S
        out[name] = dict(ms=statistics.median(k1 + k2),
                         plain_ms=statistics.median(p1 + p2),
                         library_ms=statistics.median(l1),
                         bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
        r = out[name]
        log(f"  {name} ({moved / 1e6:.1f} MB moved): kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound")
    return out


def _check_onesided_grad_refused(pt) -> str:
    """``dlrm.bce_loss`` under make_context(RANKS) through the a2a pipeline
    over the one-sided puts, with tables that need a gradient, on the card
    (CONFIG's widths at 1,024 rows a table): it raises, as on the CPU,
    where before the kernels' outputs carried no gradient and the tables
    silently got none; without grad the same call scores."""
    cfg = dataclasses.replace(pt.CONFIG, rows_per_table=1024, rw_impl="a2a",
                              rw_backend="onesided")
    dev = torch.device(DEV)
    params = pt.init_params(torch.Generator(device=dev).manual_seed(3), cfg,
                            device=dev)
    inputs = _train_batches(pt, cfg, 1, 3, dev)[0]
    ctx = pt.make_context(RANKS)
    with torch.no_grad():
        loss = float(pt.dlrm.bce_loss(params, *inputs, cfg, ctx))
    params["tables"].requires_grad_()
    msg = "no error"
    try:
        pt.dlrm.bce_loss(params, *inputs, cfg, ctx).backward()
    except RuntimeError as e:
        msg = str(e)
    log(f"  dlrm.bce_loss through row/a2a/onesided with tables that need a "
        f"gradient: {msg[:110]}...; without grad the loss {loss:.6f}")
    check(msg.startswith("reduce_scatter: the value needs a gradient, and "
                         "the one-sided route has no derivative")
          and np.isfinite(loss),
          "row/a2a/onesided under grad raises on the card (no silent loss "
          "of the tables' gradient)")
    del params
    return msg


def phase_distributed(pt, eg, oa, unc) -> dict:
    log(f"== 7. the distributed embedding bag ({RANKS} simulated ranks on "
        f"the card, table-wise over 2; phase 3's tables)")
    torch.cuda.reset_peak_memory_stats()
    errs = _check_chunk_kernels(pt, oa)
    # the no-drop traffic's uncached scores
    nd_reqs = _uniform_requests(pt.CONFIG, pt.CTRRequest, BATCH, seed=4)
    eng = pt.DLRMEngine(unc["params"], pt.CONFIG, batch_size=BATCH,
                        device=DEV)
    for r in nd_reqs:
        eng.submit(r)
    nodrop = dict(reqs=nd_reqs, scores=eng.run_to_completion())
    del eng
    out = {}
    for label, fields, ranks in STRATEGIES:
        out[label] = _serve_strategy(pt, eg, oa, unc, label, fields, ranks,
                                     nodrop)
        torch.cuda.empty_cache()            # the column copy goes
    bulk, ones = out["row/a2a/bulk"], out["row/a2a/onesided"]
    check(bulk["dropped"] == ones["dropped"],
          "both backends drop the same lookups")
    same = all(bulk["scores"][k] == ones["scores"][k]
               for k in bulk["scores"])
    err = max(abs(bulk["scores"][k] - ones["scores"][k])
              for k in bulk["scores"])
    log(f"  row/a2a onesided vs bulk scores: "
        f"{'bitwise equal' if same else 'not bitwise'} (max_abs_err "
        f"{err:.3e})")
    check(same or err <= PCTR_TOL["atol"],
          "onesided a2a scores within tolerance of bulk")
    out["a2a_bitwise"] = same
    out["idle"], _ = _profile_flush(
        ones["eng"], itertools.repeat(unc["heads"][1]),
        statistics.median(ones["flush_ms"]), "row/a2a/onesided",
        ("put_chunks_kernel", "sum_chunks_kernel"))
    del bulk["eng"], ones["eng"]
    times = _times_chunks(pt, oa)
    # the ring collective through its comm entry point (no serving path
    # calls it, in the reference either): one put launch for all ranks
    oa.reset_launch_counts()
    x = torch.randn((RANKS, _a2a_shapes()[1], D), device=DEV)
    got = pt.comm.permute_ring(x, shift=1, backend="onesided")
    ring_launches = oa.LAUNCH_COUNTS["onesided_ring_permute"]
    check(ring_launches == 1 and _same_bits(got, torch.roll(x, 1, 0)),
          "comm.permute_ring(backend='onesided'): one launch per call")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  comm.permute_ring(backend='onesided'): {ring_launches} launches;"
        f" peak device memory in this phase {out['peak_gb']:.1f} GB")
    out["refusal"] = _check_onesided_grad_refused(pt)
    out["errs"], out["times"] = errs, times
    out["launches"] = dict(
        onesided_all_to_all=ones["counts"]["onesided_all_to_all"],
        onesided_reduce_scatter=ones["counts"]["onesided_reduce_scatter"],
        onesided_ring_permute=ring_launches)
    return out


# ---------------------------------------------------------------------------
# 7p. ranks as processes
# ---------------------------------------------------------------------------

# phase 7's strategies and row/allgather/onesided (the all-reduce through
# the pull-sum), each rank a process of a gloo group sharing the card
PROC_STRATEGIES = (
    ("row/allgather/bulk", dict(sharding="row"), RANKS),
    ("row/allgather/onesided", dict(sharding="row", rw_backend="onesided"),
     RANKS),
    ("row/a2a/bulk", dict(sharding="row", rw_impl="a2a"), RANKS),
    ("row/a2a/onesided", dict(sharding="row", rw_impl="a2a",
                              rw_backend="onesided"), RANKS),
    ("column", dict(sharding="column"), RANKS),
    ("table", dict(sharding="table"), 2),
)
PROC_STRATEGIES_BY_LABEL = {label: fields
                            for label, fields, _ in PROC_STRATEGIES}
RANKS_OF = {label: ranks for label, _, ranks in PROC_STRATEGIES}
# phase 7's simulated strategy each is held to: the simulated all-reduce is
# one sum over the stacked ranks on either backend
SIMULATED = {"row/allgather/onesided": "row/allgather/bulk"}
# bitwise phase 7's scores: every collective moves, or adds in rank order
PROC_BITWISE = ("row/allgather/onesided", "row/a2a/onesided", "column",
                "table")
# the bulk sums take gloo's (NCCL's) order: pooled rows within ULPS_OF[leg]
# * 2**-24 * sum_s |partial_s| of the simulated sum, pCTR within PCTR_TOL
PROC_BULK_SUMS = ("row/allgather/bulk", "row/a2a/bulk")
# the bound's multiple of 2**-24 per leg, at E ranks: gloo's order, fixed
# for given inputs, is held to E (0.952 of it in PR 27's runs); NCCL's
# order, untried, to the proven 2 (E - 1) -- two f32 sums of E terms in
# any orders are each within (E - 1) * 2**-24 * sum_s |partial_s| of the
# exact sum (to first order)
ULPS_OF = {"gloo": lambda e: e, "nccl": lambda e: 2 * (e - 1)}
# per rank per flush: (kernel, launches)
PROC_LAUNCHES = {
    "row/allgather/bulk": dict(gather_pool_tbe_flat=1),
    "row/allgather/onesided": dict(gather_pool_tbe_flat=1,
                                   onesided_reduce_scatter=1),
    "row/a2a/bulk": {},
    "row/a2a/onesided": dict(onesided_all_to_all=3,
                             onesided_reduce_scatter=1),
    "column": dict(gather_pool_tbe=1),
    "table": dict(gather_pool_tbe=1),
}
PROC_FLUSHES = REQUESTS // BATCH     # the requests of phases 3 and 7
PROC_TIMEOUT_S = 300.0
RANK_PATH = "7p ranks as processes"
# a rank's device memory beyond its shard: a flush's working tensors (the
# a2a's gathered rows are the largest, ~0.2 GB) and the symmetric buffers
PROC_MEM_SLACK = 2 ** 31


def _rank_device() -> str:
    return "cpu" if DEV == "cpu" else "cuda:0"


def _rank_requests(reqs):
    """The requests as three arrays, cheap to hand to the rank processes."""
    return (np.stack([r.dense for r in reqs]),
            np.stack([r.indices for r in reqs]),
            np.stack([r.lengths for r in reqs]))


def _rank_bound_rows(ctx, eb, comm, rs, batch, ecfg):
    """This rank's pooled rows of ``batch`` through the bulk sums, and
    sum_s |partial_s| of each: the bound's measure."""
    mass = eb.row_partials(rs, batch, ecfg).abs()
    if ecfg.rw_impl == "allgather":
        mass = comm.all_reduce(mass, ctx=ctx)
    else:
        mass = comm.reduce_scatter(mass, ctx=ctx)
        mass = comm.all_gather(mass.reshape(-1, ecfg.num_tables, ecfg.dim),
                               axis=0, tiled=True, ctx=ctx)
    return eb.pooled_lookup_sharded(rs, batch, ecfg), mass


def _rank_serve(ctx, base, tables, mlp, reqs, strategies, batch):
    """One rank of phase 7p: for each strategy, a DLRMEngine under the
    rank's ProcessContext (its shard copied from the parent's tables,
    which reach it through CUDA IPC) serves the requests in flushes of
    BATCH, in lockstep with the other ranks.  Each flush is timed on the
    host clock beside its fences' seconds; the launch counts are set to
    0 just before the flushes and read just after.  Then the checks'
    extras: the a2a's dropped lookups of each flush's batch, and for the
    bulk sums the first batch's pooled rows and their bound's measure.
    Every rank's record is gathered to rank 0, which returns them."""
    import torch.distributed as tdist

    from repro_torch.core import comm
    from repro_torch.core import embedding_bag as eb
    from repro_torch.core.jagged import JaggedBatch
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import onesided_a2a as oa
    from repro_torch.serving.engine import CTRRequest, DLRMEngine

    cuda = ctx.device.type == "cuda"
    dense, idx, lens = reqs
    requests = [CTRRequest(rid=i, dense=dense[i], indices=idx[i],
                           lengths=lens[i]) for i in range(len(dense))]
    params = {part: [{k: v.to(ctx.device, copy=True)
                      for k, v in layer.items()} for layer in mlp[part]]
              for part in ("bottom", "top")}
    params["tables"] = tables
    out = {}
    for label, fields in strategies:
        cfg = dataclasses.replace(base, **fields)
        ecfg = cfg.embedding_config()
        if cuda:
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        t0 = time.perf_counter()
        eng = DLRMEngine(params, cfg, batch, ctx)
        shard = eng.params["tables"].local
        rec = dict(shard_bytes=shard.numel() * shard.element_size(),
                   shard_s=time.perf_counter() - t0,
                   shard_ptr_own=shard.data_ptr() != tables.data_ptr())
        for r in requests:
            eng.submit(r)
        heads = [requests[i:i + batch] for i in range(0, len(requests),
                                                      batch)]
        scores, flush_ms, fence_ms = {}, [], []
        eg.reset_launch_counts()
        oa.reset_launch_counts()
        while eng.queue:
            f0 = oa.FENCE_STATS["seconds"]
            t = time.perf_counter()
            scores.update(eng.flush())      # ends in .cpu(): synchronous
            flush_ms.append(1e3 * (time.perf_counter() - t))
            fence_ms.append(1e3 * (oa.FENCE_STATS["seconds"] - f0))
        rec["counts"] = {**eg.LAUNCH_COUNTS, **oa.LAUNCH_COUNTS}
        rec.update(scores=np.array([scores[i] for i in sorted(scores)]),
                   flush_ms=flush_ms, fence_ms=fence_ms)
        rs = eng.params["tables"]
        batches = []
        for head in heads:
            _, i_, l_ = eng._pad_batch(head)
            batches.append(JaggedBatch(
                torch.as_tensor(i_, device=ctx.device),
                torch.as_tensor(l_, device=ctx.device)))
        with torch.no_grad():
            if ecfg.rw_impl == "a2a" and ecfg.sharding == "row":
                rec["dropped"] = [int(eb.pooled_lookup_rw_a2a_with_stats(
                    rs, b, ecfg)[1]) for b in batches]
            if label in PROC_BULK_SUMS:
                pooled, mass = _rank_bound_rows(ctx, eb, comm, rs,
                                                batches[0], ecfg)
                if ctx.rank == 0:
                    rec["pooled"], rec["mass"] = pooled.cpu(), mass.cpu()
        if cuda:
            torch.cuda.synchronize(ctx.device)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
        rec["symmetric_bytes"] = sum(b.nbytes for b in ctx._buffers.values())
        del eng, rs, shard
        gathered = [None] * ctx.world
        tdist.all_gather_object(gathered, rec, group=ctx.group)
        if ctx.rank == 0:
            out[label] = gathered
        if cuda:
            torch.cuda.empty_cache()
    return out


def _check_rank_leg(pt, unc, dist, got, leg) -> dict:
    """Phase 7p's checks of one leg's ranks against phase 7's simulated
    ranks (and phase 3): scores, pooled rows, drops, launches, memory.
    Returns each strategy's per-rank medians for the log."""
    summary = {}
    n = PROC_FLUSHES
    for label, ranks_ in got.items():
        e = len(ranks_)
        other_e = e != RANKS_OF[label]
        if other_e and "a2a" in label:
            # another rank count: the a2a's buckets, and so its drops,
            # differ from phase 7's; a simulated run at e ranks instead
            sim = _simulated_at(pt, unc, label, e)
        else:
            sim = dist[SIMULATED.get(label, label)]
        want = np.array([sim["scores"][k] for k in sorted(sim["scores"])])
        vals = ranks_[0]["scores"]
        check(all(np.array_equal(r["scores"], vals) for r in ranks_),
              f"[{leg} {label}] every rank returns the same scores")
        check(len(vals) == REQUESTS and np.isfinite(vals).all()
              and ((vals > 0) & (vals < 1)).all(),
              f"[{leg} {label}] {REQUESTS} finite pCTRs in (0, 1)")
        err = float(np.abs(vals - want).max())
        same = bool(np.array_equal(vals, want))
        # the all-reduce over other ranks adds other partials
        if label in PROC_BITWISE and (not other_e or "a2a" in label):
            check(same, f"[{leg} {label}] scores bitwise the simulated "
                        f"ranks'")
        else:
            check(bool(np.allclose(vals, want, **PCTR_TOL)),
                  f"[{leg} {label}] pCTR within tolerance of the simulated "
                  f"ranks'")
        per = {k: v * n for k, v in PROC_LAUNCHES[label].items()}
        for r, rec in enumerate(ranks_):
            check({k: rec["counts"].get(k, 0) for k in SOURCES}
                  == _launches(**per),
                  f"[{leg} {label}] rank {r}: launches {per} in {n} flushes")
            check(rec["shard_ptr_own"], f"[{leg} {label}] rank {r} holds its "
                                        f"shard in memory of its own")
        launches = {k: sum(rec["counts"].get(k, 0) for rec in ranks_)
                    for k in SOURCES}
        line = (f"  [{leg} {label}] {e} ranks: scores "
                f"{'bitwise' if same else 'not bitwise'} phase 7's "
                f"(max_abs_err {err:.3e}); launches summed over ranks "
                f"{ {k: v for k, v in launches.items() if v} }")
        log(line)
        if "dropped" in ranks_[0]:
            drops = [[rec["dropped"][f] for rec in ranks_] for f in range(n)]
            check(drops == sim["dropped"],
                  f"[{leg} {label}] each rank's drops == the simulated "
                  f"rank's at {e} ranks")
            log(f"  [{leg} {label}] dropped per flush (per rank) {drops}")
        if label in PROC_BULK_SUMS:
            rec0 = ranks_[0]
            ecfg = dataclasses.replace(
                pt.CONFIG, **dict(PROC_STRATEGIES_BY_LABEL[label])
            ).embedding_config()
            _, i_, l_ = _padded_arrays(pt, unc["heads"][0])
            with torch.no_grad():
                ref = pt.eb.pooled_lookup_sharded(
                    pt.eb.shard_tables(unc["params"]["tables"], ecfg, e),
                    pt.JaggedBatch(i_, l_), ecfg).cpu()
            diff = (rec0["pooled"] - ref).abs()
            ulps = ULPS_OF[leg](e)
            bound = ulps * 2.0 ** -24 * rec0["mass"]
            check(bool((diff <= bound).all()),
                  f"[{leg} {label}] pooled rows within {ulps} * 2**-24 * "
                  f"sum_s |partial_s| of the simulated sum")
            log(f"  [{leg} {label}] pooled vs simulated: max_abs_err "
                f"{float(diff.max()):.3e}, largest share of the bound "
                f"{float((diff / bound.clamp_min(1e-30)).max()):.3f}, "
                f"bitwise {bool(torch.equal(rec0['pooled'], ref))}")
        med = [statistics.median(rec["flush_ms"]) for rec in ranks_]
        fence = [sum(rec["fence_ms"]) / sum(rec["flush_ms"]) for rec in ranks_]
        peak = [(rec.get("peak_bytes", 0) + rec["symmetric_bytes"]) / 1e9
                for rec in ranks_]
        shard_gb = ranks_[0]["shard_bytes"] / 1e9
        if DEV != "cpu":
            check(all(p * 1e9 <= ranks_[0]["shard_bytes"] + PROC_MEM_SLACK
                      for p in peak),
                  f"[{leg} {label}] each rank's peak memory about its shard")
        log(f"  [{leg} {label}] median flush ms per rank "
            f"{[round(m, 3) for m in med]} (host clock), fences "
            f"{[round(100 * f, 1) for f in fence]}% of it; shard "
            f"{shard_gb:.2f} GB a rank (copied in "
            f"{max(r['shard_s'] for r in ranks_):.2f} s), peak "
            f"{[round(p, 2) for p in peak]} GB a rank (allocator peak + "
            f"symmetric buffers)")
        summary[label] = dict(median_ms=med, fence_share=fence, peak_gb=peak,
                              launches=launches, bitwise=same, err=err)
    return summary


def _simulated_at(pt, unc, label, world) -> dict:
    """``label`` served on ``world`` simulated ranks, as phase 7 serves it
    on its own count: the scores, and the a2a's drops per flush (per
    rank)."""
    cfg = dataclasses.replace(pt.CONFIG, **PROC_STRATEGIES_BY_LABEL[label])
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH,
                        ctx=pt.make_context(tp_size=world), device=DEV)
    reqs = unc["reqs"][:PROC_FLUSHES * BATCH]
    for r in reqs:
        eng.submit(r)
    heads = [reqs[i:i + BATCH] for i in range(0, len(reqs), BATCH)]
    out = dict(scores=eng.run_to_completion(),
               dropped=_dropped(pt, eng, heads, cfg.embedding_config()))
    del eng
    torch.cuda.empty_cache()
    return out


def _padded_arrays(pt, head):
    """A head's padded (dense, indices, lengths) on the card, as the engine
    pads them."""
    F, T_, L_ = (pt.CONFIG.num_dense_features, pt.CONFIG.num_sparse_features,
                 pt.CONFIG.pooling)
    dense = np.zeros((BATCH, F), np.float32)
    idx = np.zeros((T_, BATCH, L_), np.int32)
    lens = np.zeros((T_, BATCH), np.int32)
    for i, r in enumerate(head):
        dense[i], idx[:, i, :], lens[:, i] = r.dense, r.indices, r.lengths
    dev = torch.device(DEV)
    return (torch.as_tensor(dense, device=dev),
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(lens, device=dev))


def phase_ranks(pt, unc, dist) -> dict:
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 7p. ranks as processes ({RANKS} processes sharing the card in "
        f"a gloo group, table-wise 2; phase 3's tables through CUDA IPC; "
        f"torch.cuda.device_count() {n_cards})")
    for (op, be), route in pt.comm.RANK_ROUTES.items():
        log(f"  route {op} {be}: {route}")
    t0 = time.perf_counter()
    tables = unc["params"]["tables"]
    mlp = {part: unc["params"][part] for part in ("bottom", "top")}
    reqs = _rank_requests(unc["reqs"][:PROC_FLUSHES * BATCH])
    got = {}
    for world in sorted({r for _, _, r in PROC_STRATEGIES}, reverse=True):
        strategies = [(label, fields) for label, fields, r in PROC_STRATEGIES
                      if r == world]
        t1 = time.perf_counter()
        got.update(pt.run_ranks(
            _rank_serve, world, backend="gloo", device=_rank_device(),
            args=(pt.CONFIG, tables, mlp, reqs, strategies, BATCH),
            timeout_s=PROC_TIMEOUT_S))
        log(f"  gloo, {world} processes: {len(strategies)} strategies in "
            f"{time.perf_counter() - t1:.1f} s (spawn, shard copies, "
            f"flushes, checks' extras)")
    out = dict(gloo=_check_rank_leg(pt, unc, dist, got, "gloo"))
    if n_cards >= 2:
        world = RANKS if n_cards >= RANKS else 2
        rows = [(label, fields) for label, fields, r in PROC_STRATEGIES
                if label.startswith("row/")]
        t1 = time.perf_counter()
        got = pt.run_ranks(_rank_serve, world, backend="nccl",
                           args=(pt.CONFIG, tables, mlp, reqs, rows, BATCH),
                           timeout_s=PROC_TIMEOUT_S)
        log(f"  nccl, {world} processes, one a card: {len(rows)} strategies "
            f"in {time.perf_counter() - t1:.1f} s")
        out["nccl"] = _check_rank_leg(pt, unc, dist, got, "nccl")
    else:
        log("  the NCCL leg needs two or more cards (NCCL refuses two ranks "
            "on one device): not run on this machine")
    # the per-rank path's launches, summed over its ranks and strategies
    out["launches"] = {k: sum(s["launches"][k]
                              for s in out["gloo"].values())
                       for k in SOURCES}
    out["secs"] = time.perf_counter() - t0
    import multiprocessing

    alive = multiprocessing.active_children()
    nccl = "; the NCCL leg's are one process a card" if "nccl" in out \
        else ""
    log(f"  phase 7p: {out['secs']:.1f} s; the gloo leg's flush times are "
        f"processes time-slicing one card, not an interconnect's{nccl}; "
        f"rank processes alive after it: {len(alive)}; device memory "
        f"reserved {torch.cuda.memory_reserved() / 1e9:.3f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    check(not alive, "phase 7p's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 6p. the remote tier with one host per process
# ---------------------------------------------------------------------------

REMOTE_RANK_PATH = "6p remote tier, ranks as processes"
# each leg of 6p, all in one spawn of HOSTS rank processes: (label, the
# remote tier's transport, pipeline_depth)
REMOTE_LEGS = (("cached bulk", "bulk", 1),
               ("cached onesided", "onesided", 1),
               ("pipelined onesided", "onesided", 2))
RING_BLOCK = (13_312, 128)   # row 7's block a rank: (4, 13,312, 128) stacked
RING_SEED = 5
# a rank's device memory beyond its shard and its slot pools: a fetch's
# contributions and its receive buffer (0.54 GB each at M_pad 2**18), the
# gathered requests, the fetched rows, the forward's working tensors
REMOTE_MEM_SLACK = 2 ** 31


def _remote_leg(ctx, eng, requests, depth, comm, eg, oa) -> dict:
    """One leg's serving on this rank: flushes one by one on the host
    clock (depth 1) or one ``run_to_completion`` (depth 2), the launch
    counts set to 0 just before and read just after, the fetches' events
    and, for each put launch, the stream it was issued on."""
    for r in requests:
        eng.submit(r)
    fetches, put_streams = [], []
    put = oa._put_rank

    def _recording(x, rank, group, recv, counter):
        if counter == "onesided_put_rows" and x.is_cuda:
            put_streams.append(torch.cuda.current_stream(x.device).cuda_stream)
        return put(x, rank, group, recv, counter)

    prev = comm.set_event_sink(fetches.append)
    oa._put_rank = _recording
    eg.reset_launch_counts()
    oa.reset_launch_counts()
    rec = dict(flush_ms=[], fence_ms=[])
    try:
        if depth == 1:
            scores = {}
            while eng.queue:
                f0 = oa.FENCE_STATS["seconds"]
                t = time.perf_counter()
                scores.update(eng.flush())      # ends in .cpu(): synchronous
                rec["flush_ms"].append(1e3 * (time.perf_counter() - t))
                rec["fence_ms"].append(
                    1e3 * (oa.FENCE_STATS["seconds"] - f0))
        else:
            t = time.perf_counter()
            scores = eng.run_to_completion()    # ends in the last drain
            rec["flush_ms"].append(1e3 * (time.perf_counter() - t))
            rec["fence_ms"].append(1e3 * oa.FENCE_STATS["seconds"])
    finally:
        comm.set_event_sink(prev)
        oa._put_rank = put
    rec["counts"] = {**eg.LAUNCH_COUNTS, **oa.LAUNCH_COUNTS}
    rec["fences"] = oa.FENCE_STATS["fences"]
    rec["scores"] = np.array([scores[i] for i in sorted(scores)])
    # the store's timed event of each fetch, and comm's untimed one
    timed = [ev for ev in fetches if ev.op == "fetch_rows" and ev.t1 > ev.t0]
    rec["comm_events"] = sum(ev.op == "fetch_rows" and ev.t1 == ev.t0
                             for ev in fetches)
    row_bytes = eng.cfg.embedding_dim * 4
    rec["m_pads"] = [ev.bytes_in // (ctx.world * row_bytes) for ev in timed]
    rec["fetch_ms"] = [1e3 * (ev.t1 - ev.t0) for ev in timed]
    rec["put_streams"] = put_streams
    return rec


def _remote_rank_serve(ctx, base, tables, mlp, reqs, batch):
    """One rank of phase 6p, one host of the remote tier: for each leg of
    REMOTE_LEGS an engine built by ``make_dlrm_engine(..., remote_ctx=
    ctx)`` over phase 3's tables (which reach the rank through CUDA IPC;
    it copies only its own row shard) serves phase 3's requests in
    lockstep with the other ranks.  Then ``comm.permute_ring(ctx=)`` on
    both backends at row 7's shape.  Every rank's records are gathered to
    rank 0, which returns them."""
    import torch.distributed as tdist

    from repro_torch.core import comm
    from repro_torch.core.cache_config import CacheConfig
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import onesided_a2a as oa
    from repro_torch.serving.engine import CTRRequest, make_dlrm_engine

    cuda = ctx.device.type == "cuda"
    dense, idx, lens = reqs
    requests = [CTRRequest(rid=i, dense=dense[i], indices=idx[i],
                           lengths=lens[i]) for i in range(len(dense))]
    params = {part: [{k: v.to(ctx.device, copy=True)
                      for k, v in layer.items()} for layer in mlp[part]]
              for part in ("bottom", "top")}
    params["tables"] = tables
    out = {}
    for label, backend, depth in REMOTE_LEGS:
        cfg = dataclasses.replace(base, cache=CacheConfig(
            rows=65536, policy="lfu", cold_tier="remote",
            remote_hosts=ctx.world, remote_backend=backend,
            pipeline_depth=depth))
        if cuda:
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        t0 = time.perf_counter()
        eng = make_dlrm_engine(params, cfg, batch, remote_ctx=ctx)
        bags = getattr(eng.cache, "buffers", [eng.cache])
        shard = bags[0].cold.shards
        rec = dict(
            kind=type(eng).__name__, shard_shape=tuple(shard.shape),
            shard_bytes=shard.numel() * shard.element_size(),
            shard_s=time.perf_counter() - t0,
            shard_own=shard.untyped_storage().nbytes()
            == shard.numel() * shard.element_size()
            and shard.data_ptr() != tables.data_ptr(),
            one_store=all(b.cold is bags[0].cold for b in bags),
            tables_dropped=eng.params["tables"] is None,
            pool_bytes=eng.cache.pool_bytes)
        rec.update(_remote_leg(ctx, eng, requests, depth, comm, eg, oa))
        st = eng.cache_stats()
        rec["counters"] = {k: getattr(st, k) for k in COUNTERS}
        if depth > 1:
            rec["fallbacks"] = eng.scheduler.fallbacks
            rec["side"] = getattr(eng.scheduler.side, "cuda_stream", None)
        if cuda:
            torch.cuda.synchronize(ctx.device)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
        rec["symmetric_bytes"] = sum(b.nbytes for b in ctx._buffers.values())
        del eng, bags, shard, st
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        gathered = [None] * ctx.world
        tdist.all_gather_object(gathered, rec, group=ctx.group)
        if ctx.rank == 0:
            out[label] = gathered
    # (c) the ring permute at row 7's shape, one block a rank
    g = torch.Generator().manual_seed(RING_SEED)
    blocks = torch.randn((ctx.world,) + RING_BLOCK, generator=g)
    want = torch.roll(blocks, 1, dims=0)[ctx.rank].view(torch.int32)
    mine = blocks[ctx.rank].to(ctx.device)
    for backend in ("bulk", "onesided"):
        oa.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize(ctx.device)
        t = time.perf_counter()
        got = comm.permute_ring(mine, shift=1, backend=backend, ctx=ctx)
        got = got.cpu()
        rec = dict(ms=1e3 * (time.perf_counter() - t),
                   bitwise=torch.equal(got.view(torch.int32), want),
                   launches=oa.LAUNCH_COUNTS["onesided_ring_permute"])
        gathered = [None] * ctx.world
        tdist.all_gather_object(gathered, rec, group=ctx.group)
        if ctx.rank == 0:
            out[f"ring {backend}"] = gathered
    return out


def _check_remote_legs(pt, unc, remote, piped, got, leg) -> dict:
    """Phase 6p's checks of one group's ranks against phase 3's scores,
    phase 6's counters and fetches and phase 6b's fallbacks: scores,
    counters, launches, streams, memory.  Returns the per-rank numbers
    for the log and the path's launches."""
    want = np.array([unc["scores"][k] for k in sorted(unc["scores"])])
    summary = {}
    for label, backend, depth in REMOTE_LEGS:
        ranks_ = got[label]
        world = len(ranks_)
        rows_local = T * (R // world)
        tag = f"[{leg} {label}]"
        vals = ranks_[0]["scores"]
        check(len(vals) == REQUESTS
              and all(np.array_equal(r["scores"], vals) for r in ranks_),
              f"{tag} every rank returns the same {REQUESTS} scores")
        check(bool(np.array_equal(vals, want)),
              f"{tag} scores bitwise phase 3's")
        for r, rec in enumerate(ranks_):
            check(rec["shard_shape"] == (rows_local, D) and rec["shard_own"]
                  and rec["tables_dropped"] and rec["one_store"],
                  f"{tag} rank {r} holds only its ({rows_local}, {D}) shard, "
                  f"in memory of its own, and no tables")
        counters = ranks_[0]["counters"]
        check(all(r["counters"] == counters for r in ranks_),
              f"{tag} every rank keeps the same counters")
        puts_want = [len(r["m_pads"]) if backend == "onesided" else 0
                     for r in ranks_]
        if depth == 1:
            ph6 = remote[backend]
            if world == HOSTS:
                check(counters == ph6["counters"],
                      f"{tag} the counters of phase 6 [{backend}]")
            else:
                # other hosts split the misses otherwise by owner
                check(all(counters[k] == ph6["counters"][k]
                          for k in ("hits", "misses", "evictions"))
                      and all(counters[a] + counters[b]
                              == ph6["counters"][a] + ph6["counters"][b]
                              for a, b in (("misses_host", "misses_remote"),
                                           ("fetch_host", "fetch_remote"),
                                           ("bytes_h2d", "bytes_remote"))),
                      f"{tag} phase 6 [{backend}]'s counters, split over "
                      f"{world} hosts")
            check(all(r["m_pads"] == ph6["m_pads"] for r in ranks_),
                  f"{tag} phase 6's {ph6['fetches']} fetches, padded "
                  f"{ph6['m_pads']}, on every rank")
            tbe_want = len(ph6["flush_ms"])
        else:
            ph6b = piped["remote"]
            check(all(r["fallbacks"] == ph6b["fallbacks"] for r in ranks_),
                  f"{tag} phase 6b (b)'s {ph6b['fallbacks']} fallback(s) on "
                  f"every rank")
            check(counters["misses"] == ph6b["misses"]
                  and counters["fetch_host"] + counters["fetch_remote"]
                  == ph6b["fetched"],
                  f"{tag} phase 6b (b)'s misses and rows fetched")
            check(all(r["kind"] == "PipelinedDLRMEngine" for r in ranks_),
                  f"{tag} make_dlrm_engine built the pipelined engine")
            check(all(len(r["put_streams"]) == len(r["m_pads"])
                      and set(r["put_streams"]) <= {r["side"]}
                      for r in ranks_) or DEV == "cpu",
                  f"{tag} every put launch issued from the side stream")
            tbe_want = ph6b["tbe"]
        for r, rec in enumerate(ranks_):
            want_counts = _launches(gather_pool_tbe_flat=tbe_want,
                                    onesided_put_rows=puts_want[r])
            check({k: rec["counts"].get(k, 0) for k in SOURCES}
                  == want_counts and len(rec["m_pads"]) > 0
                  and rec["comm_events"] == len(rec["m_pads"]),
                  f"{tag} rank {r}: launches {want_counts}, one fetch_rows "
                  f"event of comm's beside each of the store's")
        med = [statistics.median(r["flush_ms"]) for r in ranks_]
        fence = [sum(r["fence_ms"]) / sum(r["flush_ms"]) for r in ranks_]
        peak = [(r.get("peak_bytes", 0) + r["symmetric_bytes"]) / 1e9
                for r in ranks_]
        if DEV != "cpu":
            check(all(p * 1e9 <= r["shard_bytes"] + r["pool_bytes"]
                      + REMOTE_MEM_SLACK for p, r in zip(peak, ranks_)),
                  f"{tag} each rank's peak memory about its shard and pools")
        fetch_ms = [[round(m, 3) for m in r["fetch_ms"]] for r in ranks_]
        log(f"  {tag} scores bitwise phase 3's on {len(ranks_)} ranks; "
            f"launches per rank {ranks_[0]['counts']}; m_pads "
            f"{ranks_[0]['m_pads']}; counters {counters}"
            + (f"; fallbacks {ranks_[0]['fallbacks']}" if depth > 1 else ""))
        log(f"  {tag} {'median flush' if depth == 1 else 'run_to_completion'}"
            f" ms per rank {[round(m, 3) for m in med]} (host clock), fences "
            f"{[round(100 * f, 1) for f in fence]}% of it "
            f"({ranks_[0]['fences']} a rank); fetch ms per rank {fetch_ms}; "
            f"shard {ranks_[0]['shard_bytes'] / 1e9:.2f} GB a rank (copied "
            f"in {max(r['shard_s'] for r in ranks_):.2f} s), pools "
            f"{ranks_[0]['pool_bytes'] / 1e9:.3f} GB, peak "
            f"{[round(p, 2) for p in peak]} GB a rank (allocator peak + "
            f"symmetric buffers)")
        summary[label] = dict(median_ms=med, fence_share=fence, peak_gb=peak,
                              fetch_ms=fetch_ms,
                              launches={k: sum(r["counts"].get(k, 0)
                                               for r in ranks_)
                                        for k in SOURCES})
    for backend in ("bulk", "onesided"):
        ranks_ = got[f"ring {backend}"]
        want_n = 1 if backend == "onesided" else 0
        check(all(r["bitwise"] for r in ranks_),
              f"[{leg} ring {backend}] every rank's block bitwise torch.roll "
              f"of the stacked blocks")
        check(all(r["launches"] == want_n for r in ranks_),
              f"[{leg} ring {backend}] {want_n} ring launch(es) per rank")
        log(f"  [{leg} ring {backend}] {RING_BLOCK} f32 a rank, shift 1: "
            f"bitwise on every rank, ms per rank "
            f"{[round(r['ms'], 3) for r in ranks_]} (host clock, to the "
            f"block on the host), launches per rank "
            f"{[r['launches'] for r in ranks_]}")
        summary[f"ring {backend}"] = dict(
            ms=[r["ms"] for r in ranks_],
            launches=sum(r["launches"] for r in ranks_))
    summary["launches"] = {
        k: sum(summary[label]["launches"][k] for label, _, _ in REMOTE_LEGS)
        for k in SOURCES}
    summary["launches"]["onesided_ring_permute"] += \
        summary["ring onesided"]["launches"]
    return summary


def phase_remote_ranks(pt, unc, remote, piped) -> dict:
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 6p. the remote tier with one host per process ({HOSTS} "
        f"processes sharing the card in a gloo group, each holding its row "
        f"shard of phase 3's tables, handed over through CUDA IPC; "
        f"torch.cuda.device_count() {n_cards})")
    for (op, be), route in pt.comm.RANK_ROUTES.items():
        if op in ("fetch_rows", "permute"):
            log(f"  route {op} {be}: {route}")
    t0 = time.perf_counter()
    tables = unc["params"]["tables"]
    mlp = {part: unc["params"][part] for part in ("bottom", "top")}
    reqs = _rank_requests(unc["reqs"])
    got = pt.run_ranks(_remote_rank_serve, HOSTS, backend="gloo",
                       device=_rank_device(),
                       args=(pt.CONFIG, tables, mlp, reqs, BATCH),
                       timeout_s=PROC_TIMEOUT_S)
    log(f"  gloo, {HOSTS} processes: {len(REMOTE_LEGS)} legs and the ring in "
        f"{time.perf_counter() - t0:.1f} s (spawn, shard copies, flushes)")
    out = dict(gloo=_check_remote_legs(pt, unc, remote, piped, got, "gloo"))
    if n_cards >= 2:
        world = HOSTS if n_cards >= HOSTS else 2
        t1 = time.perf_counter()
        got = pt.run_ranks(_remote_rank_serve, world, backend="nccl",
                           args=(pt.CONFIG, tables, mlp, reqs, BATCH),
                           timeout_s=PROC_TIMEOUT_S)
        log(f"  nccl, {world} processes, one a card: in "
            f"{time.perf_counter() - t1:.1f} s")
        out["nccl"] = _check_remote_legs(pt, unc, remote, piped, got, "nccl")
    else:
        log("  the NCCL leg needs two or more cards (NCCL refuses two ranks "
            "on one device): not run on this machine")
    out["launches"] = out["gloo"]["launches"]
    out["secs"] = time.perf_counter() - t0
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 6p: {out['secs']:.1f} s; the gloo leg's times are "
        f"processes time-slicing one card, not an interconnect's; rank "
        f"processes alive after it: {len(alive)}; device memory reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB, allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    check(not alive, "phase 6p's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 7t. DLRM training at full width
# ---------------------------------------------------------------------------

# the test_dlrm flow's steps on its one batch: at CONFIG's width and lr
# 0.05 the loss first rises (the first row-wise Adagrad step moves each
# touched element by about lr), in the reference as well
# (tests/test_torch_train.py), and falls under its start by step 20
TRAIN_STEPS = 20
TRAIN_LR = 0.05
TRAIN_SEED = 11
# the card's gradient against a float64 sum of the same f32 contributions
# on the host: n terms summed in f32 in any order are within
# n * 2**-24 * sum|c| of the exact sum (each of the n - 1 additions rounds
# once; the host sum's own error is ~1e-16 relative)
SEGSUM_ULP = 2.0 ** -24
# small-size backwards on the card against autograd of the plain versions:
# two f32 orders of a few terms
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp_leaves(params) -> list:
    return [layer[k] for group in ("bottom", "top")
            for layer in params[group] for k in ("w", "b")]


def _all_counts(kmods) -> dict:
    return {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}


def _find_node(root, name):
    """The autograd node named ``name`` in the graph under ``root``."""
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node.name() == name:
            return node
        todo.extend(n for n, _ in node.next_functions)
    raise RuntimeError(f"no {name} node in the graph")


def _segsum_host(g, flat_ids, live):
    """The float64 segment sum on the host of the live slots' f32
    contributions ``g[t, b]`` (weight 1) into their flat rows: (rows,
    sums, |terms| sums, term counts), rows sorted."""
    t_i, b_i, _ = torch.nonzero(live, as_tuple=True)
    contrib = g[t_i, b_i].double().cpu().numpy()           # (n_live, D)
    ids = flat_ids[live].cpu().numpy()
    order = np.argsort(ids, kind="stable")
    ids, contrib = ids[order], contrib[order]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    rows = ids[starts]
    sums = np.add.reduceat(contrib, starts, axis=0)
    abs_sums = np.add.reduceat(np.abs(contrib), starts, axis=0)
    counts = np.diff(np.r_[starts, ids.size])
    return rows, sums, abs_sums, counts


def _check_segsum(label, d_flat, host) -> float:
    """The card's gradient rows against the host's float64 sums, each
    element within ``n * 2**-24 * sum|c|``; returns the largest error."""
    rows, sums, abs_sums, counts = host
    got = d_flat[torch.as_tensor(rows, device=d_flat.device)].double(
        ).cpu().numpy()
    err = np.abs(got - sums)
    bound = counts[:, None] * SEGSUM_ULP * abs_sums
    ok = bool((err <= bound).all())
    log(f"  {label}: {rows.size} live rows (up to {int(counts.max())} "
        f"terms a row) against the float64 host sum: max_abs_err "
        f"{err.max():.3e}, largest share of its bound "
        f"{float((err / np.maximum(bound, 1e-300)).max()):.3f} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label} within n * 2**-24 * sum|c| of the float64 sum")
    return float(err.max())


def _small_backwards(pt, eg) -> None:
    """At a small size on the card: the fused, unfused and flat ops'
    gradients (tables and weights) against autograd of the plain
    versions on the same inputs."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
    t_, r_, d_, b_, l_ = 4, 1000, D, 64, 8
    tables = torch.randn((t_, r_, d_), generator=g, device=dev)
    lens = torch.randint(0, l_ + 1, (t_, b_), generator=g, device=dev,
                         dtype=torch.int32)
    live = torch.arange(l_, device=dev) < lens[..., None]
    idx = torch.where(live, torch.randint(0, r_, (t_, b_, l_), generator=g,
                                          device=dev, dtype=torch.int32), -1)
    w = torch.rand((t_, b_, l_), generator=g, device=dev)
    flat = tables.view(t_ * r_, d_)
    off = (torch.arange(t_, device=dev) * r_).to(torch.int32)
    cases = {
        "fused": (lambda tb, ww: pt.kops.embedding_bag_batched(
            tb, idx, lens, ww, fused=True), tables),
        "unfused": (lambda tb, ww: pt.kops.embedding_bag_batched(
            tb, idx, lens, ww, fused=False), tables),
        "flat": (lambda tb, ww: pt.kops.embedding_bag_batched_flat(
            tb, off, idx, lens, ww), flat),
    }
    plain = {
        "fused": lambda tb, ww: pt.ref.embedding_bag_batched_ref(
            tb, torch.where(live, idx, 0), lens, ww),
        "unfused": lambda tb, ww: torch.stack([
            pt.ref.embedding_bag_ref(tb[t], torch.where(live[t], idx[t], 0),
                                     lens[t], ww[t]) for t in range(t_)]),
        "flat": lambda tb, ww: pt.ref.embedding_bag_batched_flat_ref(
            tb, off, torch.where(live, idx, 0), lens, ww),
    }
    expect = {"fused": {"gather_pool_tbe": 1}, "unfused": {"gather_pool": t_},
              "flat": {"gather_pool_tbe_flat": 1}}
    for name, (fn, base) in cases.items():
        grads = []
        for f in (fn, plain[name]):
            tb = base.clone().requires_grad_()
            ww = w.clone().requires_grad_()
            eg.reset_launch_counts()
            out = f(tb, ww)
            grads.append(torch.autograd.grad((out ** 2).sum(), (tb, ww)))
            if f is fn:
                launches = {k: v for k, v in eg.LAUNCH_COUNTS.items() if v}
        for what, got, want in zip(("d tables", "d eff_w"), *grads):
            compare(f"{name} backward {what} (T={t_}, R={r_}, B={b_}, "
                    f"L={l_})", got, want, GRAD_TOL)
        log(f"    {name}: launches of the forward and backward {launches}")
        check(launches == expect[name],
              f"{name}: the forward's launches, none in the backward")


class _GradProbe:
    """Step 0's checks, between its backward and its update: the upstream
    gradient of the TBE forward (taken by a prehook on its backward node)
    summed per row in float64 on the host against the card's d tables;
    zero rows; a second backward on the same graph; and the same step's
    gradient through the unfused path (26 single-table launches)."""

    def __init__(self, pt, kmods, params, flat_ids, live, touched, inputs):
        self.pt, self.kmods, self.params = pt, kmods, params
        self.flat_ids, self.live, self.touched = flat_ids, live, touched
        self.inputs = inputs
        self.g, self.out = [], {}

    def attach(self, loss) -> None:
        node = _find_node(loss.grad_fn, "_PooledLookupTBEBackward")
        node.register_prehook(lambda grad_out: self.g.append(grad_out[0]))

    def check(self, loss, leaves, grads) -> None:
        pt, out = self.pt, self.out
        T_, R_, D_ = leaves[0].shape
        d_flat = grads[0].view(T_ * R_, D_)
        host = _segsum_host(self.g[0], self.flat_ids, self.live)
        out["max_abs_err"] = _check_segsum("d tables (fused)", d_flat, host)
        check(not bool(((d_flat != 0).any(-1) & ~self.touched).any()),
              "d tables exactly zero on every untouched row")
        log("  d tables: exactly zero on every untouched row")
        # the same backward again on the same graph: the atomic adds land
        # in another order
        (again,) = torch.autograd.grad(loss, [leaves[0]])
        rows = torch.as_tensor(host[0], device=d_flat.device)
        out["run_diff"] = float((again.view(T_ * R_, D_)[rows]
                                 - d_flat[rows]).abs().max())
        log(f"  two backward runs on identical inputs: max_abs_diff "
            f"{out['run_diff']:.3e} over the live rows "
            f"({'bitwise equal' if out['run_diff'] == 0 else 'not bitwise'})")
        del again
        # the unfused path at full width: T single-table launches forward,
        # none backward, the same gradient within the same bound
        dense, batch, labels, cfg = self.inputs
        for mod in self.kmods:
            mod.reset_launch_counts()
        loss_u = pt.dlrm.bce_loss(self.params, dense, batch, labels,
                                  dataclasses.replace(cfg, fused=False))
        fwd = _all_counts(self.kmods)
        (d_u,) = torch.autograd.grad(loss_u, [leaves[0]])
        check(fwd == _launches(gather_pool=T_)
              and _all_counts(self.kmods) == fwd,
              "fused=False training: T gather_pool launches forward, none "
              "backward")
        out["unfused_launches"] = fwd["gather_pool"]
        out["unfused_err"] = _check_segsum("d tables (fused=False)",
                                           d_u.view(T_ * R_, D_), host)
        del d_u, loss_u


def _train_step(pt, kmods, params, accum, inputs, probe=None):
    """One step of the flow: the loss (``dlrm.bce_loss``), the gradients of
    the tables and every MLP leaf (``torch.autograd.grad``), row-wise
    Adagrad on the tables and SGD on the MLPs.  Returns the loss, the new
    tables, accum and MLP leaves (the caller commits them), the stages'
    CUDA-event times and each stage's own launches (forward, backward,
    update).  ``probe`` runs between the backward and the update, outside
    the timed stages and the counts."""
    leaves = [params["tables"]] + _mlp_leaves(params)
    for p in leaves:
        p.requires_grad_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for mod in kmods:
        mod.reset_launch_counts()
    ev[0].record()
    loss = pt.dlrm.bce_loss(params, *inputs)
    ev[1].record()
    marks = [_all_counts(kmods)]
    if probe is not None:
        probe.attach(loss)
    grads = torch.autograd.grad(loss, leaves,
                                retain_graph=probe is not None)
    ev[2].record()
    marks.append(_all_counts(kmods))
    if probe is not None:
        probe.check(loss, leaves, grads)
    value = loss.detach()
    del loss
    marks.append(_all_counts(kmods))
    ev[3].record()
    with torch.no_grad():
        new, accum = pt.rowwise_adagrad_update(
            params["tables"].detach(), accum, grads[0], lr=TRAIN_LR)
        mlp = [p.detach() - TRAIN_LR * gg
               for p, gg in zip(leaves[1:], grads[1:])]
    ev[4].record()
    marks.append(_all_counts(kmods))
    counts = [marks[0]] + [{k: b[k] - a[k] for k in a}
                           for a, b in ((marks[0], marks[1]),
                                        (marks[2], marks[3]))]
    del grads
    torch.cuda.synchronize()
    ms = dict(forward=ev[0].elapsed_time(ev[1]),
              backward=ev[1].elapsed_time(ev[2]),
              update=ev[3].elapsed_time(ev[4]))
    return value, new, accum, mlp, ms, counts


def _commit(params, new, mlp) -> None:
    params["tables"] = new
    for layer, (w, b) in zip([layer for group in ("bottom", "top")
                              for layer in params[group]],
                             zip(mlp[0::2], mlp[1::2])):
        layer["w"], layer["b"] = w, b


def _profile_step(pt, kmods, params, accum, inputs, step_ms) -> dict:
    """One more step under torch.profiler (a complete profile,
    ``_profiled``), its results dropped: the TBE device kernels it ran,
    the device's busy time and its idle share of the median unprofiled
    step."""
    events = _device_events(_profiled(
        lambda: _train_step(pt, kmods, params, accum, inputs),
        "the training step"))
    tbe = sum(e.count for e in events if "tbe_gather_pool_kernel" in e.key)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    idle = 100 - 100 * busy / step_ms
    log(f"  profiled step: {tbe} TBE device kernel(s); device busy "
        f"{busy:.3f} ms of the median step's {step_ms:.3f} ms; idle "
        f"{idle:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    check(tbe == 1, "the profiled step ran one TBE device kernel")
    return dict(tbe_kernels=tbe, busy_ms=busy, idle=idle)


def phase_train(pt, eg, oa) -> dict:
    """The test_dlrm training flow at CONFIG's full width on the card:
    fresh tables from a seed (phase 3's are freed before; no later check
    reads the trained ones), one Zipf(1.05) batch of B=2048 from
    dlrm_batches with -1 past each length, TRAIN_STEPS steps of row-wise
    Adagrad on the tables and SGD on the MLPs at lr 0.05."""
    cfg = pt.CONFIG
    T_, R_, D_, L_ = (cfg.num_sparse_features, cfg.rows_per_table,
                      cfg.embedding_dim, cfg.pooling)
    log(f"== 7t. DLRM training at full width ({T_} x {R_} x {D_} "
        f"{cfg.dtype}, B={BATCH}, {TRAIN_STEPS} steps, lr {TRAIN_LR})")
    kmods = (eg, oa, pt.fa)
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    _small_backwards(pt, eg)
    torch.cuda.empty_cache()
    log(f"  device memory held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    params = pt.init_params(torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), cfg, device=dev)
    data = next(pt.dlrm_batches(cfg, BATCH, seed=TRAIN_SEED, zipf_a=1.05,
                                fixed_pooling=False, device=dev))
    lens = data["batch"].lengths
    live = torch.arange(L_, device=dev) < lens[..., None]
    batch = pt.JaggedBatch(torch.where(live, data["batch"].indices, -1)
                           .to(torch.int32), lens)
    inputs = (data["dense"], batch, data["labels"], cfg)
    flat_ids = (torch.where(live, batch.indices, 0).long()
                + torch.arange(T_, device=dev)[:, None, None] * R_)
    touched = torch.zeros(T_ * R_, dtype=torch.bool, device=dev)
    touched[flat_ids[live]] = True
    log(f"  {int(live.sum())} live lookups of {T_ * BATCH * L_}, "
        f"{int(touched.sum())} touched rows of {T_ * R_}")

    # the forward with the tables requiring grad: bitwise the wrapper's
    ecfg = cfg.embedding_config()
    tables = params["tables"].requires_grad_()
    trained = pt.eb.pooled_lookup_local(tables, batch, ecfg)
    with torch.no_grad():
        served = pt.eb.pooled_lookup_local(tables, batch, ecfg)
        wrapper = eg.gather_pool_tbe(
            tables, pt.kops._safe_ids(batch.indices, lens),
            pt.kops._effective_weights(batch.indices, lens, None))
    check(trained.requires_grad and torch.equal(trained.detach(), served)
          and torch.equal(served, wrapper.transpose(0, 1)),
          "the training forward's pooled output bitwise == the wrapper's")
    log("  pooled output with grad, without, and the wrapper's: bitwise "
        "equal")
    del trained, served, wrapper, tables

    accum = pt.rowwise_adagrad_init(params["tables"])
    probe = _GradProbe(pt, kmods, params, flat_ids, live, touched, inputs)
    losses, stages, fwd_launches = [], [], 0
    for step in range(TRAIN_STEPS):
        loss, new, accum, mlp, ms, counts = _train_step(
            pt, kmods, params, accum, inputs,
            probe=probe if step == 0 else None)
        old = params["tables"].detach()
        moved = (new.view(torch.int32) != old.view(torch.int32)).any(-1)
        check(not bool((moved.view(-1) & ~touched).any()),
              f"step {step}: every untouched row bitwise unchanged")
        check(not bool(((accum != 0).view(-1) & ~touched).any()),
              f"step {step}: accum non-zero only on touched rows")
        del moved, old
        _commit(params, new, mlp)
        del new, mlp
        fwd, bwd, upd = counts
        check(fwd == _launches(gather_pool_tbe=1),
              f"step {step}: the forward is one gather_pool_tbe launch")
        check(bwd == upd == _launches(),
              f"step {step}: the backward and the update launch nothing")
        fwd_launches += fwd["gather_pool_tbe"]
        losses.append(float(loss.detach()))
        stages.append(ms)
        log(f"  step {step}: loss {losses[-1]:.6f}; forward "
            f"{ms['forward']:.3f} ms, backward {ms['backward']:.3f} ms, "
            f"update {ms['update']:.3f} ms (CUDA events); launches: "
            f"forward 1 gather_pool_tbe, backward +0, update +0")
    with torch.no_grad():
        last = float(pt.dlrm.bce_loss(params, *inputs))
    log(f"  loss before the first step {losses[0]:.6f}, after the last "
        f"{last:.6f}")
    check(np.isfinite(losses + [last]).all() and last < losses[0],
          "the loss after the last step is under the loss before the first")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(sum(s.values()) for s in stages)
    prof = _profile_step(pt, kmods, params, accum, inputs, step_ms)
    med = {k: statistics.median(s[k] for s in stages)
           for k in ("forward", "backward", "update")}
    log(f"  median stage ms over {TRAIN_STEPS} steps: forward "
        f"{med['forward']:.3f}, backward {med['backward']:.3f}, update "
        f"{med['update']:.3f}; peak device memory {peak_gb:.1f} GB; phase "
        f"7t: {time.perf_counter() - t0:.1f} s")
    out = dict(probe.out, losses=losses + [last], stages=stages,
               median=med, peak_gb=peak_gb, prof=prof, launches=fwd_launches)
    del params, accum, probe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 7tp. DLRM training with each rank a process
# ---------------------------------------------------------------------------

TRAIN_RANK_PATH = "7tp DLRM training, ranks as processes"
# the flow's steps a strategy, on one batch of BATCH as phase 7t's: the
# losses of both, and the gradient of step 1, on the same tables on both
# sides.  At lr 0.05 the third step's loss reaches 48-74 on this seed
# (on an H100), where the trajectories' rounding grows without bound
TRP_STEPS = 2
# the backward on a fixed cotangent: the gradient of <pooled, c> (c from
# a seed, the same on both sides) on the touched rows, against the
# reference's, element by element.  Each row's gradient adds its n
# lookups' w * c, products both sides form alike: by index_add_'s
# atomics for the TBE's backward, in an order that varies from run to
# run (on an H100 3.4e-6-5.1e-6 in relative L2 on the ranks that hold hot
# rows, 0 on the others), in sorted order for the a2a pipeline's (bitwise
# there).  Two orders of n terms differ by at most 2 (n - 1) 2**-24
# sum |w c| (to first order), the measure taken on the reference's side
# as the gradient of <pooled, |c|> (the weights are 0 or 1), and n from
# the batch; each element is held to it.  The flow's own step-1 gradient
# carries the forward's pooled rounding in its cotangent as well (the bulk
# sums' order, 2 (E - 1) 2**-24 sum_s |partial_s| at most), and a hot row
# whose lookups' contributions cancel magnifies it: on H100 runs (gloo on
# one card, NCCL on four) the rows' gradients read at most 5.0e-6 apart
# in relative L2 for every strategy but row/a2a/bulk, whose read 3.0e-4-
# 4.4e-4 with its step-1 loss bitwise the simulated ranks'.  Each is held
# to about 5-20x its readings: TRP_GRAD_REL, TRP_A2A_GRAD_REL
TRP_GRAD_REL = 1e-4
TRP_A2A_GRAD_REL = 2e-3


def _order_bound(n):
    """2 (n - 1) 2**-24: two f32 sums of n terms, to first order."""
    return 2 * (n - 1) * 2.0 ** -24


# the touched rows' change at step 1 and the losses after it: row-wise
# Adagrad's first step is lr g / rms(g) for each row, so a row whose
# lookups' contributions cancel to near 0 takes a step its sum's last bits
# decide.  On H100 runs (gloo and NCCL) row/a2a/bulk's rows' change read
# 4.2e-4-7.2e-4 apart in relative L2 and its step-2 loss 5.6e-6-5.7e-6;
# every other strategy's rows at most 7.4e-7 and its step-2 loss 3.6e-7.
# Each is held to 3-30x its readings: the rows to TRP_ROWS_REL (row/a2a/
# bulk TRP_A2A_ROWS_REL), the later losses to TRP_LATER_REL (row/a2a/bulk
# TRP_A2A_LATER_REL), step 1's to TRP_LOSS_REL
TRP_ROWS_REL = 1e-5
TRP_A2A_ROWS_REL = 2e-3
TRP_LATER_REL = 1e-5
TRP_A2A_LATER_REL = 1e-4
TRP_SEED = 23
TRP_TIMEOUT_S = 600.0
# the strategies trained, with their ranks: table-wise over 2, as the
# other phases serve CONFIG's 26 tables
TRP_STRATEGIES = (
    ("row/allgather/bulk", dict(sharding="row"), RANKS),
    ("row/allgather/onesided", dict(sharding="row", rw_backend="onesided"),
     RANKS),
    ("row/a2a/bulk", dict(sharding="row", rw_impl="a2a"), RANKS),
    ("column", dict(sharding="column"), RANKS),
    ("table", dict(sharding="table"), 2),
)
# per rank per forward: (kernel, launches); the backward and the update
# launch none (their zero-fill and index_add_ are stock ops).  The a2a
# pipeline's phase 2 gathers with stock ops, as the reference's is XLA
TRP_LAUNCHES = {
    "row/allgather/bulk": dict(gather_pool_tbe_flat=1),
    "row/allgather/onesided": dict(gather_pool_tbe_flat=1,
                                   onesided_reduce_scatter=1),
    "row/a2a/bulk": {},
    "column": dict(gather_pool_tbe=1),
    "table": dict(gather_pool_tbe=1),
}
# the strategies held to the simulated ranks' flow (make_context(RANKS))
# in place of the one-device flow: the a2a pipeline drops the lookups past
# its buckets' capacity (skewed ids overflow them), so it computes another
# function than the local lookup, the one the simulated ranks compute; the
# pull-sum adds the ranks' partials in rank order, bitwise the simulated
# ranks' sum, where the local lookup adds a bag's rows in slot order
TRP_SIMULATED = ("row/allgather/onesided", "row/a2a/bulk")
# step 1's loss against the reference flow's on the same tables and
# batch: the ranks' pooled vectors differ from its by the sums' order (at
# most 2 (E - 1) 2**-24 sum_s |partial_s|, ~1e-7 of their size, for the
# bulk sums; none for the others), carried through the MLPs and the
# mean over 2048 samples: 1e-5 relative is ~100 f32 ulps of the loss
TRP_LOSS_REL = 1e-5


def _held_rows(shard, ecfg, ids, ref_rows, init_rows, r, E) -> dict:
    """The rows of ``ids`` (flat ``t * R + row``) that this rank's shard
    holds (its columns of each, for a column shard), fetched to the host
    beside the reference's and the initial ones: the relative L2 of the
    change's difference, its largest element, and the change's."""
    with torch.no_grad():
        got, own, cols = _owned_rows(shard, ecfg, ids, r, E)
        g = got.cpu().double()
        w = ref_rows[own][:, cols].cpu().double()
        i0 = init_rows[own][:, cols].cpu().double()
    moved = w - i0
    return dict(rows=int(g.shape[0]),
                rows_rel=float((g - w).norm() / moved.norm()),
                rows_max_abs=float((g - w).abs().max()),
                moved_max=float(moved.abs().max()))


def _owned_rows(shard, ecfg, ids, r, E):
    """(this rank's part of the rows ``ids`` of the tables, from its
    shard; the mask of ``ids`` it holds and the columns, to cut the
    reference's rows alike)."""
    T_, R_, D_ = shard.shape
    t_, row = ids // R_, ids % R_
    if ecfg.sharding == "row":
        rps = R_ // E
        own = (row >= r * rps) & (row < (r + 1) * rps)
        return shard.local[t_[own], row[own] - r * rps], own, slice(None)
    if ecfg.sharding == "column":
        d = D_ // E
        return (shard.local[t_, row], torch.ones_like(ids, dtype=torch.bool),
                slice(r * d, (r + 1) * d))
    tl = T_ // E
    own = (t_ >= r * tl) & (t_ < (r + 1) * tl)
    return shard.local[t_[own] - r * tl, row[own]], own, slice(None)


def _held_grads(grad, ecfg, ids, ref_grads, r, E, mass=None,
                counts=None) -> dict:
    """A gradient on the rank's touched rows (``grad`` a RankShard of the
    shard's gradient) against the reference's, on the host; with the
    rows' ``mass`` (sum |w c| per element) and lookup ``counts``, the
    largest ratio of an element's difference to _order_bound(n) x its
    mass (a difference where the bound is 0 counts as infinite)."""
    out = {}
    with torch.no_grad():
        got, own, cols = _owned_rows(grad, ecfg, ids, r, E)
        g = got.cpu().double()
        w = ref_grads[own][:, cols].cpu().double()
        if mass is not None:
            bound = (_order_bound(counts[own].double())[:, None].cpu()
                     * mass[own][:, cols].cpu().double())
            diff = (g - w).abs()
            ratio = torch.where(bound > 0, diff / bound.clamp_min(1e-300),
                                torch.where(diff > 0, float("inf"), 0.0))
            out["ratio"] = float(ratio.max())
    out.update(grad_rel=float((g - w).norm() / w.norm()),
               grad_max_abs=float((g - w).abs().max()))
    return out


def _train_rank(ctx, base, tables, mlp, batches, strategies, ids, counts,
                init_rows, cot, refusal):
    """One rank of phase 7tp (``base`` the DLRM config), for each of
    ``strategies`` (label, fields, and the reference's rows of ``ids``
    after step 1, its step-1 gradient and its gradient on ``cot`` there)
    in turn: cut its shard of the parent's tables (through CUDA IPC) and
    copy the MLPs; the gradient of ``<pooled, cot>`` on the shard; then
    the flow of phase 7t over ``batches`` under its ProcessContext
    (``dlrm.bce_loss``, ``torch.autograd.grad`` of the shard and the MLP
    leaves, row-wise Adagrad on the shard, SGD on the MLPs), each step's
    launches from counts at 0 and its seconds on the host clock.  The
    rows of ``ids`` (flat ``t * R + row``) the rank holds are fetched to
    the host beside the reference's; the peak device memory.  Last, with
    ``refusal``, the a2a/onesided pipeline under grad, whose refusal is
    recorded.  Every rank's records go to rank 0."""
    import torch.distributed as tdist

    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import onesided_a2a as oa

    pt = port_namespace()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, r, E = ctx.device, ctx.rank, ctx.world
    cuda = dev.type == "cuda"
    out = {}
    # the parent's tensors live on its card; a rank of another card (the
    # NCCL leg) takes copies of what it reads
    batches = [(d.to(dev), pt.JaggedBatch(b.indices.to(dev),
                                          b.lengths.to(dev)), y.to(dev))
               for d, b, y in batches]
    ids, counts, init_rows, cot = (t.to(dev) for t in (ids, counts,
                                                       init_rows, cot))

    def launched():
        return {**eg.LAUNCH_COUNTS, **oa.LAUNCH_COUNTS}

    for label, fields, refs in strategies:
        ref_rows, ref_grads, ref_cot, ref_mass = (t.to(dev) for t in refs)
        cfg = dataclasses.replace(base, **fields)
        ecfg = cfg.embedding_config()
        if cuda:
            _sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        shard = pt.eb.shard_for_rank(tables, ecfg, ctx)
        _sync(dev)
        rec = dict(shard_bytes=shard.local.numel() * 4,
                   shard_s=time.perf_counter() - t0, losses=[], step_ms=[],
                   fwd=[], quiet=[])
        # the backward on the fixed cotangent, from the initial shard
        leaf = shard.local.requires_grad_()
        pooled = pt.dlrm._pooled_sharded(shard, batches[0][1], ecfg, ctx)
        (g,) = torch.autograd.grad((pooled * cot).sum(), [leaf])
        held = _held_grads(dataclasses.replace(shard, local=g), ecfg, ids,
                           ref_cot, r, E, ref_mass, counts)
        rec.update(cot_rel=held["grad_rel"], cot_max_abs=held["grad_max_abs"],
                   cot_ratio=held["ratio"])
        shard = dataclasses.replace(shard, local=leaf.detach())
        del leaf, pooled, g
        accum = pt.rowwise_adagrad_init(shard)
        layers_ = {part: [{k: v.to(dev, copy=True) for k, v in layer.items()}
                          for layer in mlp[part]]
                   for part in ("bottom", "top")}
        for dense, batch, labels in batches:
            leaf = shard.local.requires_grad_()
            mlp_leaves = [p.requires_grad_() for p in _mlp_leaves(layers_)]
            params = dict(layers_, tables=shard)
            eg.reset_launch_counts()
            oa.reset_launch_counts()
            _sync(dev)
            t0 = time.perf_counter()
            loss = pt.dlrm.bce_loss(params, dense, batch, labels, cfg, ctx)
            fwd = launched()
            grads = torch.autograd.grad(loss, [leaf] + mlp_leaves)
            bwd = launched()
            if not rec["losses"]:         # step 1's gradient rows
                rec.update(_held_grads(dataclasses.replace(
                    shard, local=grads[0]), ecfg, ids, ref_grads, r, E))
            with torch.no_grad():
                shard, accum = pt.rowwise_adagrad_update(
                    dataclasses.replace(shard, local=leaf.detach()), accum,
                    grads[0], lr=TRAIN_LR)
                new = [p.detach() - TRAIN_LR * g
                       for p, g in zip(mlp_leaves, grads[1:])]
            _sync(dev)
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["fwd"].append({k: v for k, v in fwd.items() if v})
            rec["quiet"].append(bwd == fwd == launched())
            rec["losses"].append(float(loss.detach()))
            del loss, grads, leaf, params, mlp_leaves
            for layer, (w, b) in zip(layers_["bottom"] + layers_["top"],
                                     zip(new[0::2], new[1::2])):
                layer["w"], layer["b"] = w, b
            del new
            if len(rec["losses"]) == 1:
                rec.update(_held_rows(shard, ecfg, ids, ref_rows, init_rows,
                                      r, E))
        if cuda:
            _sync(dev)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        del shard, accum, layers_, ref_rows, ref_grads, ref_cot, ref_mass
        if cuda:
            torch.cuda.empty_cache()
        gathered = [None] * E
        tdist.all_gather_object(gathered, rec, group=ctx.group)
        if r == 0:
            out[label] = gathered
    # the a2a pipeline over the one-sided puts has no derivative: under
    # grad it raises, on every rank alike
    cfg = dataclasses.replace(base, sharding="row", rw_impl="a2a",
                              rw_backend="onesided")
    msg = "no error"
    if refusal:
        shard = pt.eb.shard_for_rank(tables, cfg.embedding_config(), ctx)
        shard.local.requires_grad_()
        params = dict({part: [{k: v.to(dev, copy=True)
                               for k, v in layer.items()}
                              for layer in mlp[part]]
                       for part in ("bottom", "top")}, tables=shard)
        try:
            pt.dlrm.bce_loss(params, *batches[0], cfg, ctx).backward()
        except RuntimeError as e:
            msg = f"RuntimeError: {e}"
        del shard, params
        if cuda:
            torch.cuda.empty_cache()
    gathered = [None] * E
    tdist.all_gather_object(gathered, msg, group=ctx.group)
    out["refusal"] = gathered
    return out


def _train_batches(pt, cfg, n, seed, dev) -> list:
    """``n`` Zipf(1.05) batches of BATCH from dlrm_batches, -1 past each
    length, as (dense, JaggedBatch, labels)."""
    it = pt.dlrm_batches(cfg, BATCH, seed=seed, zipf_a=1.05,
                         fixed_pooling=False, device=dev)
    out = []
    for _ in range(n):
        data = next(it)
        lens = data["batch"].lengths
        live = torch.arange(cfg.pooling, device=dev) < lens[..., None]
        out.append((data["dense"], pt.JaggedBatch(
            torch.where(live, data["batch"].indices, -1).to(torch.int32),
            lens), data["labels"]))
    return out


def _train_reference(pt, kmods, params, batches, ids, label, cot):
    """(losses, the rows ``ids`` after step 1, step 1's table gradient on
    them, and for a fixed cotangent ``cot`` of the pooled vectors the
    gradients of ``<pooled, cot>`` and ``<pooled, |cot|>`` on them) of
    phase 7t's flow
    (``_train_step``) on a copy of ``params`` over ``batches``: on one
    device (``label`` None), or under make_context(RANKS) with strategy
    ``label``'s fields."""
    cfg = pt.CONFIG
    ctx = None
    if label is not None:
        fields = next(f for lb, f, _ in TRP_STRATEGIES if lb == label)
        cfg, ctx = dataclasses.replace(cfg, **fields), pt.make_context(RANKS)
    ref = {"tables": params["tables"].clone(),
           **{part: [{k: v.clone() for k, v in layer.items()}
                     for layer in params[part]] for part in ("bottom",
                                                             "top")}}
    dense, batch, _ = batches[0]
    ref["tables"].requires_grad_()
    pooled = pt.dlrm._pooled_sharded(ref["tables"], batch,
                                     cfg.embedding_config(), ctx) \
        if ctx is not None else pt.eb.pooled_lookup_local(
            ref["tables"], batch, cfg.embedding_config())
    (g,) = torch.autograd.grad((pooled * cot).sum(), [ref["tables"]],
                               retain_graph=True)
    cot_rows = g.view(-1, g.shape[-1])[ids]
    del g
    (g,) = torch.autograd.grad((pooled * cot.abs()).sum(), [ref["tables"]])
    mass_rows = g.view(-1, g.shape[-1])[ids]
    ref["tables"] = ref["tables"].detach()
    del pooled, g
    accum = pt.rowwise_adagrad_init(ref["tables"])
    losses = []
    probe = _RowsProbe(ids)
    for dense, batch, labels in batches:
        loss, new, accum, mlp, _, _ = _train_step(
            pt, kmods, ref, accum, (dense, batch, labels, cfg, ctx),
            probe=probe if not losses else None)
        _commit(ref, new, mlp)
        losses.append(float(loss.detach()))
        del new, mlp
        if len(losses) == 1:
            with torch.no_grad():
                rows = ref["tables"].view(-1, ref["tables"].shape[-1])[ids]
    del ref, accum
    torch.cuda.empty_cache()
    return losses, rows, probe.rows, cot_rows, mass_rows


class _RowsProbe:
    """Keeps step 1's table gradient on the rows ``ids``."""

    def __init__(self, ids):
        self.ids, self.rows = ids, None

    def attach(self, loss) -> None:
        pass

    def check(self, loss, leaves, grads) -> None:
        self.rows = grads[0].view(-1, grads[0].shape[-1])[self.ids]


def _train_ranks_leg(pt, cfg, params, batches, ids, counts, init_rows, cot,
                     refs, backend) -> tuple:
    """Phase 7tp's ranks over ``backend``: one spawn per world size
    (gloo: every rank on the card; nccl: one rank a card), each strategy
    with its reference's rows.  Returns (each strategy's rank records,
    the refusal's messages)."""
    mlp = {part: params[part] for part in ("bottom", "top")}
    got = {}
    for world in sorted({n for _, _, n in TRP_STRATEGIES}, reverse=True):
        # each strategy with its reference's rows after step 1, its step-1
        # gradient rows and its fixed-cotangent gradient and mass rows
        strategies = [(lb, fields, refs[lb if lb in TRP_SIMULATED
                                         else None][1:])
                      for lb, fields, n in TRP_STRATEGIES if n == world]
        t0 = time.perf_counter()
        res = pt.run_ranks(
            _train_rank, world, backend=backend,
            device=_rank_device() if backend == "gloo" else None,
            args=(cfg, params["tables"], mlp, batches, strategies, ids,
                  counts, init_rows, cot, world == RANKS),
            timeout_s=TRP_TIMEOUT_S)
        log(f"  {backend}, {world} processes, "
            f"{[s for s, _, _ in strategies]}: "
            f"{time.perf_counter() - t0:.1f} s (spawn, the shards' copies, "
            f"the steps, the records' gather)")
        msgs = res.pop("refusal")
        if world == RANKS:
            refusal = msgs
        got.update(res)
    return got, refusal


def _check_train_ranks(got, refusal, ref_losses, tag) -> tuple:
    """Phase 7tp's checks of one leg; returns (each strategy's summary,
    the kernels' launches summed over its ranks and steps)."""
    launches = dict(gather_pool_tbe_flat=0, gather_pool_tbe=0,
                    onesided_reduce_scatter=0)
    summary = {}
    for label, _, world in TRP_STRATEGIES:
        ranks_ = got[label]
        want = TRP_LAUNCHES[label]
        a2a = label == "row/a2a/bulk"
        later_rel = TRP_A2A_LATER_REL if a2a else TRP_LATER_REL
        grad_rel = TRP_A2A_GRAD_REL if a2a else TRP_GRAD_REL
        rows_rel = TRP_A2A_ROWS_REL if a2a else TRP_ROWS_REL
        rels = [[abs(a - b) / abs(b) for a, b in zip(
            rec["losses"], ref_losses[label])] for rec in ranks_]
        flow = ("the simulated ranks' flow" if label in TRP_SIMULATED
                else "the one-device flow")
        peak = [rec.get("peak_bytes", 0) / 1e9 for rec in ranks_]
        med = [statistics.median(rec["step_ms"]) for rec in ranks_]
        log(f"  [{label}{tag}] {world} ranks: losses {ranks_[0]['losses']} "
            f"({flow}'s within {[f'{v:.3e}' for v in rels[0]]} relative, "
            f"bounds {TRP_LOSS_REL} at step 1, {later_rel} after); the "
            f"gradient on a fixed cotangent vs {flow}'s on the touched rows, "
            f"relative L2 per rank "
            f"{[f'{rec['cot_rel']:.3e}' for rec in ranks_]} over "
            f"{[rec['rows'] for rec in ranks_]} rows (max abs "
            f"{max(rec['cot_max_abs'] for rec in ranks_):.3e}; each "
            f"element's difference at most "
            f"{max(rec['cot_ratio'] for rec in ranks_):.3f} of its bound "
            f"2 (n - 1) 2**-24 sum |w c|); the flow's step-1 gradient "
            f"{[f'{rec['grad_rel']:.3e}' for rec in ranks_]} (max abs "
            f"{max(rec['grad_max_abs'] for rec in ranks_):.3e}; bound "
            f"{grad_rel}) and the rows' change at step 1 "
            f"{[f'{rec['rows_rel']:.3e}' for rec in ranks_]} (max abs "
            f"{max(rec['rows_max_abs'] for rec in ranks_):.3e} of changes "
            f"up to {max(rec['moved_max'] for rec in ranks_):.3e}; bound "
            f"{rows_rel}); median "
            f"step per rank {[round(m, 1) for m in med]} ms (host clock; the "
            f"shard cut in {max(rec['shard_s'] for rec in ranks_):.2f} s); "
            f"peak device memory {[round(p, 2) for p in peak]} GB a rank "
            f"(shard {ranks_[0]['shard_bytes'] / 1e9:.2f} GB); launches a "
            f"forward per rank {ranks_[0]['fwd'][0]}")
        for r, rec in enumerate(ranks_):
            check(rec["losses"] == ranks_[0]["losses"],
                  f"7tp {label}{tag} rank {r}: its losses bitwise rank 0's")
            check(rels[r][0] <= TRP_LOSS_REL
                  and max(rels[r]) <= later_rel,
                  f"7tp {label}{tag} rank {r}: step 1's loss within "
                  f"{TRP_LOSS_REL} of {flow}'s, the later within "
                  f"{later_rel} ({rels[r]})")
            check(rec["grad_rel"] <= grad_rel and rec["rows_rel"] <= rows_rel,
                  f"7tp {label}{tag} rank {r}: the flow's step-1 gradient on "
                  f"its touched rows within {grad_rel} of {flow}'s "
                  f"({rec['grad_rel']:.3e}), the rows' change at step 1 "
                  f"within {rows_rel} ({rec['rows_rel']:.3e})")
            check(rec["cot_ratio"] <= 1.0 and rec["rows"] > 0,
                  f"7tp {label}{tag} rank {r}: the gradient on a fixed "
                  f"cotangent on its touched rows, each element within 2 (n "
                  f"- 1) 2**-24 sum |w c| of {flow}'s (at most "
                  f"{rec['cot_ratio']:.3f} of it)")
            check(all(f == want for f in rec["fwd"]) and all(rec["quiet"]),
                  f"7tp {label}{tag} rank {r}: each forward launches {want}, "
                  f"the backward and the update nothing ({rec['fwd']})")
            for k, n in want.items():
                launches[k] += n * len(rec["fwd"])
        summary[label] = dict(
            loss_rel=max(max(v) for v in rels),
            cot_rel=max(rec["cot_rel"] for rec in ranks_),
            cot_ratio=max(rec["cot_ratio"] for rec in ranks_),
            grad_rel=max(rec["grad_rel"] for rec in ranks_),
            rows_rel=max(rec["rows_rel"] for rec in ranks_), step_ms=med,
            peak_gb=peak)
    for r, msg in enumerate(refusal):
        check(msg.startswith("RuntimeError: reduce_scatter: the value needs "
                             "a gradient, and the one-sided route has no "
                             "derivative"),
              f"7tp{tag} rank {r}: the a2a/onesided pipeline under grad "
              f"raises ({msg[:80]})")
    log(f"  [{tag.strip(' ()') or 'gloo'}] the a2a/onesided pipeline under "
        f"grad raised on every rank: {refusal[0][:100]}...")
    return summary, launches


def phase_train_ranks(pt, eg, oa, backends=("gloo", "nccl")) -> dict:
    """Phase 7tp: the flow of phase 7t at CONFIG's full width with each
    rank a process (4 sharing the card over gloo, table-wise 2; where
    there are RANKS cards the NCCL leg, one rank a card): fresh tables
    from TRP_SEED, TRP_STEPS steps on one batch of BATCH, each strategy's
    losses and gradients held to phase 7t's one-device flow (or the
    simulated ranks') on the same tables and batch.  ``backends`` picks
    the legs."""
    cfg = pt.CONFIG
    T_, R_, D_ = cfg.num_sparse_features, cfg.rows_per_table, \
        cfg.embedding_dim
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 7tp. DLRM training with each rank a process ({T_} x {R_} x "
        f"{D_} {cfg.dtype}; {RANKS} processes sharing the card over gloo, "
        f"table-wise 2; {TRP_STEPS} steps on one batch of B={BATCH} a "
        f"strategy, lr {TRAIN_LR}; torch.cuda.device_count() {n_cards})")
    t_phase = time.perf_counter()
    kmods = (eg, oa, pt.fa)
    dev = torch.device(DEV)
    params = pt.init_params(torch.Generator(device=dev).manual_seed(
        TRP_SEED), cfg, device=dev)
    batches = _train_batches(pt, cfg, 1, TRP_SEED, dev) * TRP_STEPS
    flat = []
    for _, b, _ in batches:
        live = b.indices >= 0
        flat.append((b.indices.long() + torch.arange(
            T_, device=dev)[:, None, None] * R_)[live])
    ids, counts = torch.unique(torch.cat(flat), return_counts=True)
    del flat
    with torch.no_grad():
        init_rows = params["tables"].view(-1, D_)[ids]
    cot = torch.randn((BATCH, T_, D_), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          TRP_SEED + 1))
    refs = {}
    for label in (None,) + TRP_SIMULATED:
        refs[label] = _train_reference(pt, kmods, params, batches, ids,
                                       label, cot)
        log(f"  {ids.numel():,} rows touched by the batch; the "
            f"{label or 'one-device'} flow's losses "
            f"{[round(v, 6) for v in refs[label][0]]}")
    ref_losses = {label: refs[label if label in TRP_SIMULATED else None][0]
                  for label, _, _ in TRP_STRATEGIES}
    out = dict(ref_losses=ref_losses)
    for backend in backends:
        if backend == "nccl" and n_cards < RANKS:
            log(f"  the NCCL leg needs {RANKS} cards (one process a card; "
                f"NCCL refuses two ranks on one device): not run on this "
                f"machine")
            continue
        got, refusal = _train_ranks_leg(pt, cfg, params, batches, ids,
                                        counts, init_rows, cot, refs,
                                        backend)
        tag = "" if backend == "gloo" else " (nccl)"
        summary, launches = _check_train_ranks(got, refusal, ref_losses,
                                               tag)
        if backend == "gloo":
            out.update(summary=summary, launches=launches)
        else:
            out["nccl"] = summary
    del params, batches, ids, counts, refs, init_rows, cot
    torch.cuda.empty_cache()
    out["secs"] = time.perf_counter() - t_phase
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 7tp: {out['secs']:.1f} s; rank processes alive after it: "
        f"{len(alive)}")
    check(not alive, "phase 7tp's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 8. LM serving
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The ctx legs of phases 8, 8m, 8d and 8t: the LM under a ParallelContext
# of CTX_RANKS simulated ranks on the card, on the phase's own weights
# ---------------------------------------------------------------------------

CTX_RANKS = 4                # simulated ranks of the model axis
CTX_SLOTS = 2                # the ctx legs' batchers: 2 slots x LM_MAX_LEN
CTX_NEW = 16                 # new tokens a request; decode steps a leg
TBE_FLAT = "gather_pool_tbe_flat"  # the row-wise partial lookup's wrapper


def _greedy(pt, params, cfg, hidden, ctx):
    """The head's greedy tokens (B,) of hidden (B, d) under ``ctx``."""
    logits = pt.lm.lm_logits(params, hidden[:, None], cfg, ctx)[:, 0]
    return torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)


def _record_batcher(pt, eng, reqs, new, kmods) -> dict:
    """Serve ``reqs`` ((rid, prompt) pairs, ``new`` new tokens each)
    through the batcher ``eng`` from launch counts at 0, recording the
    head's input and output at each call: an admission's last hidden row
    (1, d) and logits, a decode step's rows (slots, d) and logits.
    Returns them with each step's admissions and launches, the flash
    routes, the timings, the tokens and the run's counts."""
    heads, real = [], eng._head

    def head(hidden):
        logits = real(hidden)
        heads.append((hidden.float(), logits))
        return logits
    eng._head = head
    for rid, prompt in reqs:
        eng.submit(pt.Request(rid=rid, prompt=prompt, max_new=new))
    _reset_counts(pt, kmods)
    steps = []
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        n0, c0 = len(eng.timings["prefill"]), _counts(pt, kmods)
        eng.step()
        c1 = _counts(pt, kmods)
        steps.append((len(eng.timings["prefill"]) - n0,
                      {k: c1[k] - c0[k] for k in c1}))
    serve_s = time.perf_counter() - t0
    # the recorder holds the engine's bound method: a cycle that would
    # keep the engine's cache (and the weights) alive until a collection
    del eng._head
    return dict(heads=heads, steps=steps, counts=_counts(pt, kmods),
                routes=dict(pt.fa.ROUTE_COUNTS), serve_s=serve_s,
                prefill=list(eng.timings["prefill"]),
                decode=list(eng.timings["decode"]),
                tokens={rid: r.generated for rid, r in eng.done.items()})


def _ctx_batcher_run(pt, params, cfg, reqs, kmods, ctx) -> dict:
    """Serve ``reqs`` (CTX_NEW new tokens each) through
    ContinuousBatcher(CTX_SLOTS x LM_MAX_LEN, ctx), recording the head's
    calls (:func:`_record_batcher`), then one more decode step
    profiled."""
    eng = pt.ContinuousBatcher(params, cfg, num_slots=CTX_SLOTS,
                               max_len=LM_MAX_LEN, ctx=ctx, eos_id=-1,
                               device=DEV)
    out = _record_batcher(pt, eng, [(r.rid, r.prompt) for r in reqs],
                          CTX_NEW, kmods)
    # one more decode step profiled, into the finished slots (scratch)
    out["prof"] = _profile_lm(
        lambda: pt.dec.decode_step(params, eng.cache, eng.tokens, cfg, ctx),
        f"decode step ({'local' if ctx is None else 'ctx'})",
        statistics.median(out["decode"]) * 1e3)
    del eng
    torch.cuda.empty_cache()
    return out


def _lm_ctx_leg(pt, params, cfg, reqs, kmods) -> dict:
    """Phase 8's ctx leg: ``reqs`` (the long prompt and a short one)
    through ContinuousBatcher without a context and with
    make_context(CTX_RANKS), CTX_NEW new tokens each.  Each admission's
    logits bitwise the local run's (the vocabulary through the row-wise
    sharded bag is exact, nothing else changes before decode); each
    decode step whose inputs agree (every earlier greedy token equal)
    within DECODE_REL_L2 of the local run's hidden rows (the
    sequence-sharded flash-decode combine); CTX_RANKS TBE launches per
    prefill and per decode step under the context, none without, and
    the flash kernel once a layer per long prefill in both.  Logs greedy
    tokens that differ, the times and tokens/s."""
    ctx = pt.make_context(CTX_RANKS)
    runs = {label: _ctx_batcher_run(pt, params, cfg, reqs, kmods, c)
            for label, c in (("local", None), ("ctx", ctx))}
    loc, par = runs["local"], runs["ctx"]
    n_long = sum(len(r.prompt) > cfg.attn_chunk_threshold for r in reqs)
    n_flash = cfg.num_layers * n_long
    for label, run in runs.items():
        per = CTX_RANKS if label == "ctx" else 0
        n_steps = len(run["steps"])
        check(all(d[TBE_FLAT] == per * (adm + 1) for adm, d in run["steps"])
              and run["counts"] == dict(_launches(
                  flash_attention=n_flash,
                  **{TBE_FLAT: per * (len(reqs) + n_steps)}), chunked=0),
              f"8 {label}: {per} TBE launches per prefill and per decode "
              f"step, {cfg.num_layers} flash launches per long prefill, "
              f"nothing else ({run['counts']})")
    adm = {label: [lg for h, lg in run["heads"] if h.shape[0] == 1]
           for label, run in runs.items()}
    check(len(adm["ctx"]) == len(reqs) and all(
        torch.equal(a, b) for a, b in zip(adm["ctx"], adm["local"])),
        "8 ctx: every admission's logits bitwise the local run's")
    steps = {label: [(h, lg) for h, lg in run["heads"]
                     if h.shape[0] == CTX_SLOTS]
             for label, run in runs.items()}
    rels, agree = [], True
    for (hp, lp), (hl, ll) in zip(steps["ctx"], steps["local"]):
        if not agree:
            break
        rels.append(float((hp - hl).norm() / hl.norm()))
        agree = torch.equal(lp[:, :cfg.vocab_size].argmax(-1),
                            ll[:, :cfg.vocab_size].argmax(-1))
    differ = {rid: [i for i, (a, b) in enumerate(zip(
        par["tokens"][rid], loc["tokens"][rid])) if a != b]
        for rid in loc["tokens"]}
    log(f"  ctx leg (make_context({CTX_RANKS}), {CTX_SLOTS} slots x "
        f"{LM_MAX_LEN}, {len(reqs)} requests of "
        f"{[len(r.prompt) for r in reqs]} tokens, {CTX_NEW} new each): "
        f"admission logits bitwise the local run's; decode hidden rows "
        f"relative L2 to the local run over the {len(rels)} steps with "
        f"equal inputs: max {max(rels):.3e} (bound {DECODE_REL_L2}), "
        f"per step " + " ".join(f"{r:.2e}" for r in rels)
        + f"; greedy tokens that differ (index per request): {differ}")
    for label, run in runs.items():
        ntok = sum(len(t) for t in run["tokens"].values())
        log(f"  ctx leg, {label}: prefill ms by length "
            f"{[(n, round(1e3 * t, 1)) for n, t in run['prefill']]}, median "
            f"decode step {1e3 * statistics.median(run['decode']):.3f} ms "
            f"over {len(run['decode'])} steps, {ntok} tokens in "
            f"{run['serve_s']:.3f} s ({ntok / run['serve_s']:.2f} tokens/s),"
            f" launches {TBE_FLAT} {run['counts'][TBE_FLAT]}, "
            f"flash_attention {run['counts']['flash_attention']}")
    check(rels and max(rels) < DECODE_REL_L2,
          "8 ctx: the sequence-sharded decode within the decode bound of "
          "the local one")
    return dict(launches=par["counts"][TBE_FLAT],
                flash=par["counts"]["flash_attention"], rel=max(rels),
                rel_steps=len(rels), differ=differ,
                prefill={label: run["prefill"] for label, run in
                         runs.items()},
                decode={label: statistics.median(run["decode"])
                        for label, run in runs.items()},
                idle={label: run["prof"]["idle"] for label, run in
                      runs.items()})


def _moe_ep_vs_cpu(pt, params, cfg, prompt) -> dict:
    """The first MoE layer's moe_ffn_ep over CTX_RANKS ranks on the
    MOE_ROWS real hidden rows of ``prompt`` (MOE_ROWS / CTX_RANKS a
    rank), on the card against the same function on the CPU on copies of
    the same bf16 rows and weights: relative L2 within MOE_REL_L2 and
    the drops equal."""
    lm, moe = pt.lm, pt.moe
    x = _moe_layer_rows(pt, params, cfg, prompt)
    xe = x.reshape(CTX_RANKS, -1, cfg.d_model)
    p = lm.layer(params["moe_blocks"], 0)["moe"]
    t0 = time.perf_counter()
    out, aux = moe.moe_ffn_ep(p, xe, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    p_cpu = _copy_to(p, "cpu")
    t0 = time.perf_counter()
    want, aux_cpu = moe.moe_ffn_ep(p_cpu, xe.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    got = out.cpu().float()
    rel = float((got - want.float()).norm() / want.float().norm())
    err = float((got - want.float()).abs().max())
    drops = (int(aux["moe_dropped"]), int(aux_cpu["moe_dropped"]))
    log(f"  ctx leg: layer {cfg.first_k_dense} moe_ffn_ep over {CTX_RANKS} "
        f"ranks ({cfg.num_experts // CTX_RANKS} experts each) on "
        f"{MOE_ROWS} real rows ({MOE_ROWS // CTX_RANKS} a rank), bf16, the "
        f"card against the CPU: relative L2 {rel:.3e} (bound {MOE_REL_L2}),"
        f" max_abs_err {err:.3e}; moe_dropped {drops[0]} on the card, "
        f"{drops[1]} on the CPU; moe_aux {float(aux['moe_aux']):.6f} / "
        f"{float(aux_cpu['moe_aux']):.6f}; {card_s:.3f} s on the card "
        f"(first call), {cpu_s:.1f} s on the CPU")
    check(rel < MOE_REL_L2 and drops[0] == drops[1],
          "moe_ffn_ep on the card within its bound of the CPU, drops equal")
    del p_cpu
    return dict(rel=rel, err=err, dropped=drops[0])


def _moe_ctx_decode(pt, params, cfg, prompt, kmods) -> dict:
    """Phase 8m's ctx leg: ``prompt`` (the long one) prefilled under
    make_context(CTX_RANKS) into a cache of LM_MAX_LEN positions, then
    CTX_NEW greedy decode steps under it, from launch counts at 0:
    moe_dropped per prefill and per step (summed over the MoE layers),
    CTX_RANKS TBE launches per prefill and per step, the flash kernel
    once a layer in the prefill, the prefill's time and the decode
    tokens/s."""
    dec, moe = pt.dec, pt.moe
    ctx = pt.make_context(CTX_RANKS)
    n_moe = cfg.num_layers - cfg.first_k_dense
    tokens = torch.as_tensor(prompt[None], device=DEV)
    drops = []
    restore = _patched(moe, "moe_ffn_ep", lambda r: _recording(
        r, drops, lambda out: out[1]["moe_dropped"]))
    try:
        _reset_counts(pt, kmods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, h = dec.prefill(params, tokens, cfg, ctx, max_len=LM_MAX_LEN)
        tok = _greedy(pt, params, cfg, h[:, -1], ctx)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step_s, out = [], [int(tok[0])]
        for _ in range(CTX_NEW):
            t0 = time.perf_counter()
            cache, h = dec.decode_step(params, cache, tok, cfg, ctx)
            tok = _greedy(pt, params, cfg, h, ctx)
            out.append(int(tok[0]))
            step_s.append(time.perf_counter() - t0)
        counts = _counts(pt, kmods)
    finally:
        restore()
    del cache, h
    torch.cuda.empty_cache()
    per_call = [int(d) for d in drops]
    check(len(per_call) == n_moe * (1 + CTX_NEW),
          f"{len(per_call)} moe_ffn_ep calls: want {n_moe} x "
          f"{1 + CTX_NEW}")
    by_run = [sum(per_call[i * n_moe:(i + 1) * n_moe])
              for i in range(1 + CTX_NEW)]
    n_flash = cfg.num_layers * (len(prompt) > cfg.attn_chunk_threshold)
    check(counts == dict(_launches(
        flash_attention=n_flash,
        **{TBE_FLAT: CTX_RANKS * (1 + CTX_NEW)}), chunked=0),
        f"8m ctx: {CTX_RANKS} TBE launches per prefill and decode step, "
        f"{n_flash} flash launches, nothing else ({counts})")
    check(all(0 <= t < cfg.vocab_size for t in out),
          "8m ctx: greedy tokens in the vocabulary")
    log(f"  ctx leg: prefill of {len(prompt)} tokens under expert "
        f"parallelism over {CTX_RANKS} ranks: {1e3 * prefill_s:.1f} ms, "
        f"moe_dropped {by_run[0]} of {len(prompt) * cfg.experts_per_token}"
        f" x {n_moe} assignments; {CTX_NEW} decode steps: median "
        f"{1e3 * statistics.median(step_s):.3f} ms, "
        f"{CTX_NEW / sum(step_s):.2f} tokens/s, moe_dropped per step "
        f"{by_run[1:]} (of {cfg.experts_per_token} x {n_moe}); launches "
        f"{TBE_FLAT} {counts[TBE_FLAT]}, flash_attention "
        f"{counts['flash_attention']}")
    return dict(launches=counts[TBE_FLAT], flash=counts["flash_attention"],
                prefill_s=prefill_s, step_s=step_s,
                tokens_s=CTX_NEW / sum(step_s), dropped=by_run)


def _mla_ctx_decode(pt, params, cfg, prompt, kmods) -> dict:
    """Phase 8d's ctx leg: ``prompt`` (the long one) prefilled without a
    context into a cache of LM_MAX_LEN positions (CTX_RANKS slices of
    LM_MAX_LEN / CTX_RANKS, all holding rows), then CTX_NEW decode steps
    from a copy of it without a context (greedy) and under
    make_context(CTX_RANKS) on the same tokens.  Every MLA layer's decode
    attention under the context (the ranks' partials over their slices,
    combined) against the whole-cache attention on the same inputs,
    within DECODE_REL_L2; the context's hidden rows against the local
    run's, logged with each step's moe_dropped (expert parallelism at
    the config's capacity drops assignments of the one token that the
    local MoE keeps: another function); CTX_RANKS TBE launches a step."""
    lm, dec, moe = pt.lm, pt.dec, pt.moe
    ctx = pt.make_context(CTX_RANKS)
    n_moe = cfg.num_layers - cfg.first_k_dense
    tokens = torch.as_tensor(prompt[None], device=DEV)
    cache, h = dec.prefill(params, tokens, cfg, max_len=LM_MAX_LEN)
    base = _copy_to(cache, DEV)
    tok = _greedy(pt, params, cfg, h[:, -1], None)
    feed, hid = [], []
    for _ in range(CTX_NEW):
        feed.append(tok)
        cache, h = dec.decode_step(params, cache, tok, cfg)
        hid.append(h.float())
        tok = _greedy(pt, params, cfg, h, None)
    del cache
    attn_rel, drops = [], []

    def attn(real):
        def wrapper(p, x, c_kv, k_rope, length, cfg_, ctx_=None):
            out = real(p, x, c_kv, k_rope, length, cfg_, ctx_)
            whole = real(p, x, c_kv, k_rope, length, cfg_, None)
            attn_rel.append(((out.float() - whole.float()).norm()
                             / whole.float().norm()))
            return out
        return wrapper
    restore = [_patched(dec, "_mla_decode_attn", attn),
               _patched(moe, "moe_ffn_ep", lambda r: _recording(
                   r, drops, lambda out: out[1]["moe_dropped"]))]
    rels, step_s = [], []
    try:
        _reset_counts(pt, kmods)
        for t, want in zip(feed, hid):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            base, h = dec.decode_step(params, base, t, cfg, ctx)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            rels.append(float((h.float() - want).norm() / want.norm()))
        counts = _counts(pt, kmods)
    finally:
        for undo in restore:
            undo()
    del base
    torch.cuda.empty_cache()
    attn_rel = [float(r) for r in attn_rel]
    by_step = [sum(int(d) for d in drops[i * n_moe:(i + 1) * n_moe])
               for i in range(CTX_NEW)]
    check(len(attn_rel) == cfg.num_layers * CTX_NEW
          and len(drops) == n_moe * CTX_NEW,
          f"{len(attn_rel)} sharded MLA decode attentions and {len(drops)} "
          f"moe_ffn_ep calls: want {cfg.num_layers} and {n_moe} x {CTX_NEW}")
    check(counts == dict(_launches(**{TBE_FLAT: CTX_RANKS * CTX_NEW}),
                         chunked=0),
          f"8d ctx: {CTX_RANKS} TBE launches per decode step, nothing else "
          f"({counts})")
    log(f"  ctx leg: {CTX_NEW} decode steps after the {len(prompt)}-token "
        f"prompt over the cache of {LM_MAX_LEN} positions sharded over "
        f"{CTX_RANKS} ranks: each MLA layer's sharded decode attention "
        f"against the whole cache's on the same inputs, relative L2 max "
        f"{max(attn_rel):.3e} (bound {DECODE_REL_L2}); hidden rows against "
        f"the local decode on the same tokens, per step "
        + " ".join(f"{r:.2e}" for r in rels)
        + f"; moe_dropped per step {by_step} (of {cfg.experts_per_token} x "
        f"{n_moe}); median step {1e3 * statistics.median(step_s):.3f} ms "
        f"(the whole-cache attentions computed beside); launches "
        f"{TBE_FLAT} {counts[TBE_FLAT]}")
    check(max(attn_rel) < DECODE_REL_L2 and all(np.isfinite(rels)),
          "8d ctx: the sequence-sharded MLA decode within the decode bound "
          "of the local one, finite hidden rows")
    if not any(by_step):
        check(max(rels) < DECODE_REL_L2, "8d ctx: with nothing dropped, the "
              "decode within its bound of the local one")
    return dict(launches=counts[TBE_FLAT], attn_rel=max(attn_rel),
                rel=rels, dropped=by_step,
                step_ms=1e3 * statistics.median(step_s))


def _lm_requests(pt, cfg, n=8, max_new=LM_MAX_NEW) -> list:
    """The first ``n`` of phase 8's 8 requests (uniform ids over the
    vocabulary, ``max_new`` new tokens each): two long prompts (the flash
    kernel), each followed by three of 256-2,048 tokens (full
    attention)."""
    rng = np.random.default_rng(12)
    short = rng.integers(SHORT_PROMPTS[0], SHORT_PROMPTS[1] + 1, 6).tolist()
    lens = [LONG_PROMPT] + short[:3] + [LONG_PROMPT] + short[3:]
    return [pt.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, s)
                       .astype(np.int32), max_new=max_new)
            for i, s in enumerate(lens)][:n]


def _layer0_flash(pt, params, stack, cfg, prompt) -> float:
    """The flash wrapper against its plain version on layer 0's real
    q/k/v of ``prompt``."""
    lm, S = pt.lm, len(prompt)
    tokens = torch.as_tensor(prompt[None], device=DEV)
    pl = lm.layer(params[stack], 0)
    x = lm._norm(lm.embed_tokens(params, tokens, cfg), pl["ln1"], cfg)
    q, k, v = lm._gqa_qkv(pl["attn"], x, torch.arange(S, device=DEV)[None],
                          cfg)
    return _flash_case(pt.fa, q, k, v, True, cfg.window,
                       f"layer 0 of a {S}-token prompt (real q/k/v, "
                       f"{cfg.num_heads}/{cfg.num_kv_heads} heads)")


def _serve_lm(pt, eng, reqs, kmods, cfg, slots) -> dict:
    """Drive ``eng`` over ``reqs`` to the end from launch counts at 0:
    each step's long attentions are the layers times the prompts over the
    threshold it admitted, flash launches all on the wgmma route for GQA,
    ``chunked_attention`` calls for MLA (by shape), and nothing else
    launches.  Logs and returns the counts, timings and throughput."""
    fa, nl = pt.fa, cfg.num_layers
    chunked = pt.layers.CALL_COUNTS
    mla = cfg.attention == "mla"
    # long attentions per long prefill: one a layer, none without attention
    per = 0 if cfg.attention == "none" else nl
    for r in reqs:
        eng.submit(r)
    for mod in kmods:
        mod.reset_launch_counts()
    pt.layers.reset_call_counts()
    steps = []
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slots):
        n0 = len(eng.timings["prefill"])
        c0 = fa.LAUNCH_COUNTS["flash_attention"]
        k0 = chunked["chunked_attention"]
        eng.step()
        steps.append(([n for n, _ in eng.timings["prefill"][n0:]],
                      fa.LAUNCH_COUNTS["flash_attention"] - c0,
                      chunked["chunked_attention"] - k0))
    serve_s = time.perf_counter() - t0
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    thr = cfg.attn_chunk_threshold
    for lens, n, k in steps:
        want = per * sum(s > thr for s in lens)
        got = (0, want) if mla else (want, 0)
        check((n, k) == got,
              f"{n} flash launches and {k} chunked_attention calls in a "
              f"step admitting prompts of {lens} tokens: want {got} ({per} "
              f"per prompt over {thr}, none per short prefill or decode "
              f"step)")
    n_long = sum(len(r.prompt) > thr for r in reqs)
    n_flash = 0 if mla else per * n_long
    check(counts == _launches(flash_attention=n_flash)
          and chunked["chunked_attention"] == per * n_long - n_flash,
          f"the LM path launched the flash kernel {n_flash} times and "
          f"nothing else, and called chunked_attention "
          f"{chunked['chunked_attention']} times")
    check(fa.ROUTE_COUNTS == {"wgmma": n_flash, "simt": 0},
          f"every flash launch of the LM path on the wgmma route "
          f"({fa.ROUTE_COUNTS})")
    done = eng.done
    check(sorted(done) == [r.rid for r in reqs]
          and all(len(r.generated) == r.max_new
                  and 0 <= min(r.generated)
                  and max(r.generated) < cfg.vocab_size
                  for r in done.values()),
          f"{len(reqs)} requests served, each its max_new ids, in the "
          f"vocabulary")
    tokens_out = sum(len(r.generated) for r in done.values())
    prefill, decode = eng.timings["prefill"], eng.timings["decode"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {len(done)} requests, {tokens_out} tokens in {len(steps)} steps,"
        f" {serve_s:.3f} s: {tokens_out / serve_s:.2f} tokens/s; flash "
        f"launches {counts['flash_attention']} (per step "
        f"{[n for _, n, _ in steps if n]}; by route {fa.ROUTE_COUNTS}), "
        f"chunked_attention calls {chunked['chunked_attention']} (per step "
        f"{[k for _, _, k in steps if k]}); {n_long} long prefills of {nl} "
        f"layers")
    for n, sec in prefill:
        log(f"  prefill of {n} tokens: {1e3 * sec:.1f} ms")
    log(f"  decode step ({slots} slots): median "
        f"{1e3 * statistics.median(decode):.3f} ms, min "
        f"{1e3 * min(decode):.3f}, max {1e3 * max(decode):.3f} over "
        f"{len(decode)} steps; peak device memory {peak_gb:.1f} GB")
    return dict(launches=counts["flash_attention"],
                chunked=chunked["chunked_attention"], prefill=prefill,
                decode=decode, serve_s=serve_s, tokens=tokens_out,
                peak_gb=peak_gb)


def _slot0(pt, cache) -> dict:
    """Slot 0 of every layer stack of a batcher's cache (scratch rows)."""
    return {name: {k: v[:, :1] for k, v in st.items()}
            for name, st in pt.dec.kv_stacks(cache).items()}


def phase_lm(pt, kmods) -> dict:
    cfg = pt.LM_CONFIG
    log(f"== 8. LM serving: {cfg.name} at full width ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads,"
        f" d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), "
        f"ContinuousBatcher({LM_SLOTS} slots x {LM_MAX_LEN} positions)")
    lm, dec = pt.lm, pt.dec
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(11), cfg,
                            device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  init_params: {n_params / 1e9:.3f} B parameters "
        f"({n_params * 2 / 1e9:.1f} GB bf16) in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = _lm_requests(pt, cfg)
    # layer 0's real q/k/v of the first long prompt: kernel vs plain
    err = _layer0_flash(pt, params, "blocks", cfg, reqs[0].prompt)
    tokens = torch.as_tensor(reqs[0].prompt[None], device=DEV)

    eng = pt.ContinuousBatcher(params, cfg, num_slots=LM_SLOTS,
                               max_len=LM_MAX_LEN, eos_id=-1, device=DEV)
    out = _serve_lm(pt, eng, reqs, kmods, cfg, LM_SLOTS)
    prefill, decode = out["prefill"], out["decode"]
    # where the time goes: one decode step, one short and one long prefill
    # profiled (the slots' cache as the loop left it; its rows are scratch
    # now)
    kv = _slot0(pt, eng.cache)
    short = torch.as_tensor(reqs[1].prompt[None], device=DEV)
    prof = dict(
        decode=_profile_lm(lambda: dec.decode_step(
            params, eng.cache, eng.tokens, cfg), "decode step",
            statistics.median(decode) * 1e3),
        prefill=_profile_lm(lambda: dec._prefill_into(
            params, short, cfg, kv), f"prefill of {short.shape[1]} tokens",
            prefill[1][1] * 1e3),
        long_prefill=_profile_lm(lambda: dec._prefill_into(
            params, tokens, cfg, kv), f"prefill of {LONG_PROMPT} tokens",
            prefill[0][1] * 1e3))
    del eng, kv
    torch.cuda.empty_cache()
    # the long and the first short request under a context of 4 ranks
    ctx_leg = _lm_ctx_leg(pt, params, cfg, reqs[:2], kmods)

    # decode matches forward at full width: prefill(prompt[:-1]) +
    # decode_step(prompt[-1]) against the forward's last hidden state
    rel = _decode_vs_forward(pt, params, cfg, tokens)
    # and on the short prompt phase 8m compares (the dense yardstick)
    rel_short = _decode_vs_forward(pt, params, cfg, short)
    check(max(rel, rel_short) < DECODE_REL_L2,
          "decode_step after prefill matches forward")
    del params
    torch.cuda.empty_cache()
    return dict(out, err=err, rel=rel, rel_short=rel_short,
                short_len=short.shape[1], prof=prof, ctx=ctx_leg)


def _forward_last(pt, params, cfg, tokens):
    """The forward's last hidden state (d,) in f32."""
    h_full, _ = pt.lm.forward(params, tokens, cfg)
    return h_full[0, -1].float()


def _decoded_last(pt, params, cfg, tokens):
    """prefill(tokens[:, :-1]) + decode_step(tokens[:, -1]): the decoded
    hidden state (d,) in f32."""
    dec = pt.dec
    cache, _ = dec.prefill(params, tokens[:, :-1], cfg,
                           max_len=tokens.shape[1])
    cache, h_dec = dec.decode_step(params, cache, tokens[:, -1], cfg)
    return h_dec[0].float()


def _rel_l2(got, want, label, bound=DECODE_REL_L2) -> float:
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          f"{label}: finite hidden states")
    rel = float((got - want).norm() / want.norm())
    log(f"  {label}: relative L2 {rel:.3e} (bound {bound})")
    return rel


def _decode_vs_forward(pt, params, cfg, tokens, bound=DECODE_REL_L2,
                       what="") -> float:
    """prefill(tokens[:, :-1]) + decode_step(tokens[:, -1]) against the
    forward's last hidden state: relative L2 (the caller holds it to
    ``bound``)."""
    last = _forward_last(pt, params, cfg, tokens)
    return _rel_l2(_decoded_last(pt, params, cfg, tokens), last,
                   f"decode matches forward ({tokens.shape[1]} tokens"
                   f"{', ' + what if what else ''})", bound)


# ---------------------------------------------------------------------------
# 8m. MoE serving
# ---------------------------------------------------------------------------

# layer 1's moe_ffn (bf16, routed) against a dense masked scan over all
# experts in f32 on the same rows and routing: the output passes through
# about seven bf16 roundings (gate and up products, the activation, their
# product, the down product, the weight's product, the running sum), about
# 2.5-3 unit roundoffs (2**-9) in quadrature; 1e-2 is five (a CPU run at
# full width with 12 experts gave 4.6e-3)
MOE_REL_L2 = 1e-2
MOE_ROWS = 2048              # the hidden rows of the layer-1 check
MOE_SLOTS = 2                # 2 x 16,416 positions: 12.91 GB of KV cache
MOE_PARAMS = 28_325_838_848  # the reference's param_count()


def _moe_dense_scan(pt, p, x, cfg):
    """The reference's moe_ffn in f32: every expert on every row, the
    outputs combined through the (N, k) routing mask, in expert order,
    then the shared experts.  Routing as the port's router_topk (f32
    logits of the same rows)."""
    w, topi, _ = pt.moe.router_topk(x, p["router"], cfg.experts_per_token)
    xf = x.float()
    act = pt.layers.activation_fn(cfg.activation)
    out = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        h = act(xf @ p["gate"][e].float()) * (xf @ p["up"][e].float())
        sel = ((topi == e).float() * w).sum(-1, keepdim=True)
        out += (h @ p["down"][e].float()) * sel
    s = p["shared"]
    out += (act(xf @ s["gate"].float()) * (xf @ s["up"].float())) \
        @ s["down"].float()
    return out, topi


def _moe_layer_rows(pt, params, cfg, prompt):
    """The first MoE layer's input rows (MOE_ROWS, d) for the first
    MOE_ROWS tokens of ``prompt``: through the dense layers and the
    layer's own attention, normed."""
    lm = pt.lm
    tokens = torch.as_tensor(prompt[None, :MOE_ROWS], device=DEV)
    pos = torch.arange(MOE_ROWS, device=DEV)[None]
    h = lm.embed_tokens(params, tokens, cfg)
    for i in range(cfg.first_k_dense):
        h, _, _ = lm._block(lm.layer(params["dense_blocks"], i), h, pos, cfg)
    pl = lm.layer(params["moe_blocks"], 0)
    a, _ = lm._attention(pl["attn"], lm._norm(h, pl["ln1"], cfg), pos, cfg)
    return lm._norm(h + a, pl["ln2"], cfg).reshape(-1, cfg.d_model)


def _check_moe_layer(pt, params, cfg, prompt) -> dict:
    """The first MoE layer's moe_ffn on the real hidden rows of a
    MOE_ROWS-token prompt (through the dense layers and the layer's own
    attention) against the dense f32 scan; the expert loads; its time."""
    moe = pt.moe
    x = _moe_layer_rows(pt, params, cfg, prompt)
    pl = pt.lm.layer(params["moe_blocks"], 0)
    out, aux = moe.moe_ffn(pl["moe"], x, cfg)
    want, topi = _moe_dense_scan(pt, pl["moe"], x, cfg)
    rel = float((out.float() - want).norm() / want.norm())
    err = float((out.float() - want).abs().max())
    load = torch.bincount(topi.reshape(-1).long(),
                          minlength=cfg.num_experts)
    ms = _times(lambda: moe.moe_ffn(pl["moe"], x, cfg), 5,
                torch.empty(64 * 2 ** 20 // 4, device=DEV))
    log(f"  layer {cfg.first_k_dense} moe_ffn on {MOE_ROWS} real hidden rows "
        f"(bf16) against "
        f"the dense f32 scan over {cfg.num_experts} experts: relative L2 "
        f"{rel:.3e} (bound {MOE_REL_L2}), max_abs_err {err:.3e}; expert "
        f"load max {int(load.max())} (the buckets' cap), mean "
        f"{float(load.float().mean()):.1f}, min {int(load.min())}; "
        f"moe_dropped {int(aux['moe_dropped'])}, moe_aux "
        f"{float(aux['moe_aux']):.4f}; moe_ffn {statistics.median(ms):.3f} "
        f"ms (median of 5, CUDA events)")
    check(out.dtype == torch.bfloat16 and out.shape == x.shape
          and bool(torch.isfinite(out).all()), "moe_ffn: finite, x's shape")
    check(rel < MOE_REL_L2, "moe_ffn within its bound of the dense f32 scan")
    check(int(aux["moe_dropped"]) == 0, "moe_ffn dropped nothing")
    return dict(rel=rel, err=err, cap=int(load.max()),
                mean_load=float(load.float().mean()),
                ms=statistics.median(ms))


def _patched(obj, name, make):
    """Replace ``obj.name`` by ``make(original)``; returns a restorer."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    return lambda: setattr(obj, name, real)


def _recording(real, log_to, pick):
    def wrapper(*args, **kw):
        out = real(*args, **kw)
        log_to.append(pick(out))
        return out
    return wrapper


def _forced_router(real, ids):
    """router_topk with the expert choice taken from ``ids`` (one (N, k)
    tensor per call, in call order) and the weights the softmax of this
    call's own f32 logits at those experts: the same routed function on
    another path's discrete decisions."""
    queue = list(ids)

    def router_topk(x, router_w, k):
        _, _, stats = real(x, router_w, k)
        forced = queue.pop(0).long()
        logits = x.float() @ router_w
        w = torch.softmax(logits.gather(1, forced), dim=-1)
        return w, forced.to(torch.int32), stats
    return router_topk


def _moe_decode_vs_forward(pt, params, cfg, tokens, ctx=None, steps=1,
                           max_len=None) -> dict:
    """Decode against forward for the MoE, recorded: each MoE layer's
    expert choices and each layer's last hidden row on both paths.
    ``tokens`` (1, S): the forward runs over all S of them; prefill over
    the first P = S - ``steps`` and decode_step over each of the others,
    into a cache of ``max_len`` positions (S by default).  Under ``ctx``
    (a model axis of processes) every rank runs it, routing its slice of
    the sequence (or every token of a decode step) as lm._moe_apply
    splits them; the choices are gathered into the sequence's.  The
    free-running decode (its own routing) may pick another top-k on a
    near-tie of the router's logits, and then it computes another
    function; so the same decode runs again with every token's experts
    forced to the forward's choice (weights from its own logits), and
    that run is held to DECODE_REL_L2.  Logs per MoE layer how many of
    the tokens chose another expert set, the MoE layers where each
    decoded token did, each call's relative L2 (the prefill's last row,
    then each step's) and the per-layer relative L2 of the last row, for
    both runs (under ``ctx`` model rank 0 logs).  ``rel`` is the aligned
    run's largest over the decode steps; ``hidden`` holds each run's rows
    and the forward's at those positions, on the host."""
    lm, dec, moe = pt.lm, pt.dec, pt.moe
    n = cfg.num_layers - cfg.first_k_dense
    S = tokens.shape[1]
    P = S - steps
    E = 1 if ctx is None else ctx.world
    say = log if E == 1 or ctx.rank == 0 else (lambda line: None)

    def whole(t, rows):           # this rank's router rows -> the sequence's
        return t if E == 1 or rows % E else pt.comm.all_gather(
            t, axis=0, tiled=True, ctx=ctx)

    def mine(t, rows):            # the sequence's rows -> this rank's
        c = rows // E
        return t if E == 1 or rows % E else t[ctx.rank * c:(ctx.rank + 1) * c]

    ids, rows = {"fwd": [], "free": []}, {"fwd": [], "free": [],
                                          "aligned": []}
    row = lambda out: out[0][0, -1].float()
    restore = [_patched(moe, "router_topk", lambda r: _recording(
                   r, ids["fwd"], lambda out: out[1])),
               _patched(lm, "_block", lambda r: _recording(
                   r, rows["fwd"], row))]
    try:
        h_fwd, _ = lm.forward(params, tokens, cfg, ctx)
    finally:
        for undo in restore:
            undo()
    want = h_fwd[0, P - 1:]
    del h_fwd
    fwd_ids = [whole(t, S) for t in ids["fwd"]]
    # the forward's choices: the prefill's P rows (this rank's), then each
    # step's one
    forced = [mine(t[:P], P) for t in fwd_ids] + [
        t[P + j:P + j + 1] for j in range(steps) for t in fwd_ids]
    hidden = {"fwd": want.cpu()}
    for run in ("free", "aligned"):
        if run == "free":
            make = lambda r: _recording(r, ids["free"], lambda out: out[1])
        else:
            make = lambda r: _forced_router(r, forced)
        restore = [_patched(moe, "router_topk", make),
                   _patched(dec, "_ffn_or_moe", lambda r: _recording(
                       r, rows[run], row))]
        try:
            cache, h = dec.prefill(params, tokens[:, :P], cfg, ctx,
                                   max_len=max_len or S)
            got = [h[0, -1]]
            for j in range(steps):
                cache, h = dec.decode_step(params, cache, tokens[:, P + j],
                                           cfg, ctx)
                got.append(h[0])
            del cache
        finally:
            for undo in restore:
                undo()
        hidden[run] = torch.stack(got).cpu()
    check(len(ids["fwd"]) == n and len(ids["free"]) == (1 + steps) * n,
          f"router calls: {len(ids['fwd'])} forward, {len(ids['free'])} "
          f"prefill + decode; want {n} and {1 + steps} x {n}")
    check(len(rows["fwd"]) == cfg.num_layers
          and all(len(rows[run]) == steps * cfg.num_layers
                  for run in ("free", "aligned")),
          "one recorded row per layer and path (and decode step)")
    flips, step_flips = [], [[] for _ in range(steps)]
    for i in range(n):
        fwd = fwd_ids[i].sort(-1).values
        inc = torch.cat([whole(ids["free"][i], P)] + [
            ids["free"][n * (1 + j) + i] for j in range(steps)]
        ).sort(-1).values
        differ = (fwd != inc).any(-1).cpu()
        flips.append(int(differ.sum()))
        for j in range(steps):
            if bool(differ[P + j]):
                step_flips[j].append(i + cfg.first_k_dense)
    last = {run: rows[run][-cfg.num_layers:] for run in ("free", "aligned")}
    per_layer = {run: [float((d - f).norm() / f.norm())
                       for f, d in zip(rows["fwd"], last[run])]
                 for run in ("free", "aligned")}
    say(f"  routing: tokens of the {S}-token sequence whose expert set "
        f"differs between forward and prefill + decode_step, per MoE "
        f"layer: {flips} (total {sum(flips)}; the decoded tokens in layers "
        f"{step_flips})")
    want = hidden["fwd"].float()
    check(all(bool(torch.isfinite(t).all()) for t in hidden.values()),
          f"decode against forward ({S} tokens): finite hidden states")
    calls = {run: [float((g - w).norm() / w.norm()) for g, w in
                   zip(hidden[run].float(), want)]
             for run in ("free", "aligned")}
    for run in ("free", "aligned"):
        say(f"  last row, relative L2 to the forward after each layer "
            f"({run} routing): "
            + " ".join(f"{r:.2e}" for r in per_layer[run]))
        say(f"  decode ({run} routing) against forward ({S} tokens, "
            f"{steps} decode steps): relative L2 per call (the prefill's "
            f"last row, then each step's) "
            + " ".join(f"{r:.3e}" for r in calls[run])
            + f" (bound {DECODE_REL_L2})")
    return dict(rel=max(calls["aligned"][1:]), rel_free=max(calls["free"][1:]),
                calls=calls, flips=flips, step_flips=step_flips,
                last_flips=step_flips[-1], layer_rel=per_layer, hidden=hidden)


def _init_moe_lm(pt, cfg, seed, want) -> dict:
    """Random bf16 parameters of ``cfg`` from ``seed`` on the card: their
    count less the norms (the stacks' 2-D leaves and the final norm) and
    the MTP head is ``cfg.param_count()`` and ``want``; bf16 but the f32
    routers.  Logs and returns them with their count, bytes, seconds and
    the peak device memory of the draw."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = pt.lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                               cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    norms = [t for name in ("dense_blocks", "moe_blocks")
             for t in _leaves(params[name]) if t.dim() == 2]
    norms += list(_leaves(params["final_norm"]))
    n_norms = sum(t.numel() for t in norms)
    n_mtp = sum(t.numel() for t in _leaves(params.get("mtp", {})))
    n_params = sum(t.numel() for t in leaves) - n_norms - n_mtp
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    routers = params["moe_blocks"]["moe"]["router"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  init_params: {n_params:,} parameters (param_count "
        f"{cfg.param_count():,}; norms {n_norms:,} and the MTP head "
        f"{n_mtp:,} more), {nbytes / 1e9:.2f} GB on the card, in "
        f"{init_s:.1f} s, peak device memory of the draw {peak_gb:.1f} GB")
    check(n_params == cfg.param_count() == want, f"{want:,} parameters")
    check(routers.dtype == torch.float32
          and all(t.dtype == torch.bfloat16 for t in leaves
                  if t is not routers), "bf16 weights, the routers f32")
    return dict(params=params, n_params=n_params, n_mtp=n_mtp,
                nbytes=nbytes, init_s=init_s, init_peak_gb=peak_gb)


def phase_moe(pt, kmods) -> dict:
    cfg = pt.MOE_CONFIG
    log(f"== 8m. MoE serving: {cfg.name} at full width ({cfg.num_layers} "
        f"layers, {cfg.first_k_dense} dense, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} "
        f"experts top-{cfg.experts_per_token} + {cfg.num_shared_experts} "
        f"shared, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}), ContinuousBatcher({MOE_SLOTS} slots x {LM_MAX_LEN} "
        f"positions)")
    init = _init_moe_lm(pt, cfg, 13, MOE_PARAMS)
    params = init.pop("params")
    reqs = _lm_requests(pt, cfg, 4)

    # the flash kernel at group size 1 on the dense layer's real q/k/v
    err = _layer0_flash(pt, params, "dense_blocks", cfg, reqs[0].prompt)
    layer = _check_moe_layer(pt, params, cfg, reqs[0].prompt)

    out = _serve_moe(pt, params, cfg, reqs, kmods)
    # expert parallelism over 4 ranks: layer 1 on the card against the
    # CPU; the long prompt's prefill and 16 decode steps under the context
    ep = _moe_ep_vs_cpu(pt, params, cfg, reqs[0].prompt)
    ctx_leg = dict(_moe_ctx_decode(pt, params, cfg, reqs[0].prompt, kmods),
                   ep=ep)

    # decode matches forward at full width on a short prompt: on the
    # forward's routing within the bound; free-running with the flips
    short = torch.as_tensor(reqs[1].prompt[None], device=DEV)
    dvf = _moe_decode_vs_forward(pt, params, cfg, short)
    check(dvf["rel"] < DECODE_REL_L2, "decode_step after prefill matches "
                                      "forward on the forward's routing")
    del params
    torch.cuda.empty_cache()
    return dict(out, **dvf, **init, err=err, layer=layer, ctx=ctx_leg)


def _serve_moe(pt, params, cfg, reqs, kmods) -> dict:
    """Serve ``reqs`` through ContinuousBatcher(MOE_SLOTS slots x
    LM_MAX_LEN positions) (:func:`_serve_lm`), counting moe_ffn calls and
    their dispatches, one host sync each: one call per MoE layer per
    prefill and decode step, one dispatch per CHUNK_ROWS tokens of each.
    Then one decode step and the long prefill profiled (the slots' cache
    as the loop left it; its rows are scratch now).  Returns
    :func:`_serve_lm`'s dict with the profiles, the cache's bytes and
    the syncs."""
    dec, moe = pt.dec, pt.moe
    n_moe = cfg.num_layers - cfg.first_k_dense
    eng = pt.ContinuousBatcher(params, cfg, num_slots=MOE_SLOTS,
                               max_len=LM_MAX_LEN, eos_id=-1, device=DEV)
    cache_bytes = sum(t.numel() * t.element_size()
                      for st in dec.kv_stacks(eng.cache).values()
                      for t in st.values())
    calls, syncs = [], []
    restore = [_patched(moe, "moe_ffn", lambda r: _recording(
                   r, calls, lambda out: 1)),
               _patched(moe.routing, "fixed_capacity_bucket",
                        lambda r: _recording(r, syncs, lambda out: 1))]
    try:
        out = _serve_lm(pt, eng, reqs, kmods, cfg, MOE_SLOTS)
    finally:
        for undo in restore:
            undo()
    runs = len(out["prefill"]) + len(out["decode"])
    chunks = sum(-(-n // moe.CHUNK_ROWS) for n, _ in out["prefill"]) \
        + len(out["decode"])
    check(len(calls) == n_moe * runs and len(syncs) == n_moe * chunks,
          f"{len(calls)} moe_ffn calls and {len(syncs)} dispatches (one "
          f"host sync each): want {n_moe} x {runs} and {n_moe} x {chunks}")
    log(f"  host syncs for the buckets' capacity: {len(syncs)} in "
        f"{len(calls)} moe_ffn calls: {n_moe} per decode step, {n_moe} x "
        f"{-(-LONG_PROMPT // moe.CHUNK_ROWS)} per {LONG_PROMPT}-token "
        f"prefill ({moe.CHUNK_ROWS} tokens a dispatch)")
    prof = _profile_served(pt, params, cfg, eng, out, reqs[0].prompt)
    del eng
    torch.cuda.empty_cache()
    return dict(out, prof=prof, cache_bytes=cache_bytes, syncs=len(syncs))


def _profile_served(pt, params, cfg, eng, out, prompt) -> dict:
    """One decode step of ``eng`` and the prefill of ``prompt`` (the
    long one, the first admitted) profiled, into slot 0 of the cache as
    the loop left it (its rows and states are scratch now); beside the
    unprofiled times in ``out`` (:func:`_serve_lm`'s)."""
    dec = pt.dec
    kv = _slot0(pt, eng.cache)
    tokens = torch.as_tensor(prompt[None], device=DEV)
    return dict(
        decode=_profile_lm(lambda: dec.decode_step(
            params, eng.cache, eng.tokens, cfg), "decode step",
            statistics.median(out["decode"]) * 1e3),
        long_prefill=_profile_lm(lambda: dec._prefill_into(
            params, tokens, cfg, kv), f"prefill of {len(prompt)} tokens",
            out["prefill"][0][1] * 1e3))


# ---------------------------------------------------------------------------
# 8p. LM serving with each rank a process
# ---------------------------------------------------------------------------

LM_RANK_PATH = "8p LM serving, ranks as processes"
LMP_RANKS = 4
# the depth cuts: four rank processes share the card beside the parent's
# copy of every leg's weights (the legs run in one spawn, and the parent
# keeps what it sent through CUDA IPC until the spawn ends) and its
# simulated runs.  The ranks take the replicated weights through CUDA IPC
# and copy only their shares.  granite-8b: 0.436 GB a layer and 0.81 GB
# of embedding and head, 2.6 GB at 4 layers (the batcher over processes
# runs deeper in phase 8lr (a))
LMP_GRANITE_LAYERS = 4
# moonshot-v1-16b-a3b: 1.14 GB a layer and 1.8 GB of embedding and head,
# 11.0 GB at 8 layers; a rank copies its 16 experts and vocabulary rows
# (2.2 GB at 8 layers).  At all 48 layers 17.6 GB a rank, which four
# processes on one card cannot hold beside the parent's 56.7 GB.  The
# NCCL leg (one process a card, where there are 4 cards) serves all 48
LMP_MOE_LAYERS = 8
# deepseek-v3-671b at its published widths: 3 dense MLA layers, then 1
# MoE layer of 256 experts top-8 (the published first_k_dense), 15.80e9
# parameters and the MTP head, 31.60 GB beside moonshot's and granite's
# 13.6 GB in the parent; a rank copies its 64 experts (5.64 GB) and its
# vocabulary rows (0.46 GB).  A 5th layer (a 2nd MoE) would add 23.0 GB
# to the parent and 5.6 GB to each rank, past the card.  One prompt of
# LMP_DS_PROMPT tokens, under attn_chunk_threshold: MLA's full branch,
# whose (1, 128, S, S) f32 scores a rank holds at S = 1,024 in 0.54 GB
LMP_DS_LAYERS = 4
LMP_DS_PROMPT = 1_024
LMP_DS_MAX_LEN = 1_056       # the prompt and CTX_NEW steps, 264 a rank
LMP_DS_SEED = 17
LMP_TIMEOUT_S = 600.0
# moonshot's logits through the per-rank dispatch against the simulated
# ranks' where they are not bitwise: the simulation runs each rank's
# GEMMs at a rank's shapes, so only another cuBLAS kernel for the same
# shape would part them, and a router near-tie then moves assignments
# past the capacities (phase 8m's bound for moe_ffn_ep on the card
# against the CPU, MOE_REL_L2)
LMP_EP_REL = 1e-2


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_mods() -> tuple:
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import onesided_a2a as oa
    return eg, oa, fa


def _greedy_run(pt, params, cfg, prompt, ctx, new, max_len, dev, kmods,
                ep) -> dict:
    """``prompt`` prefilled under ``ctx`` into a cache of ``max_len``
    positions, then ``new`` greedy decode steps, from launch counts at 0:
    each head call's logits and greedy token, each call of the MoE
    function ``pt.moe.<ep>``'s ``moe_dropped`` (one a MoE layer a run),
    the prefill's and each step's seconds (host clock, the device
    synchronised), the counts and the flash routes."""
    tokens = torch.as_tensor(prompt[None], device=dev)
    drops, logits, step_s = [], [], []

    def head(h):
        lg = pt.lm.lm_logits(params, h[:, None], cfg, ctx)[:, 0]
        logits.append(lg)
        return torch.argmax(lg[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    restore = _patched(pt.moe, ep, lambda r: _recording(
        r, drops, lambda out: out[1]["moe_dropped"]))
    try:
        _reset_counts(pt, kmods)
        _sync(dev)
        t0 = time.perf_counter()
        cache, h = pt.dec.prefill(params, tokens, cfg, ctx, max_len=max_len)
        tok = head(h[:, -1])
        out = [int(tok[0])]
        prefill_s = time.perf_counter() - t0
        for _ in range(new):
            t0 = time.perf_counter()
            cache, h = pt.dec.decode_step(params, cache, tok, cfg, ctx)
            tok = head(h)
            out.append(int(tok[0]))
            step_s.append(time.perf_counter() - t0)
        counts = _counts(pt, kmods)
    finally:
        restore()
    cache_bytes = sum(t.numel() * t.element_size()
                      for st in pt.dec.kv_stacks(cache).values()
                      for t in st.values())
    return dict(logits=[lg.cpu() for lg in logits], tokens=out,
                drops=[int(d) for d in drops], prefill_s=prefill_s,
                step_s=step_s, counts=counts,
                routes=dict(pt.fa.ROUTE_COUNTS), cache_bytes=cache_bytes)


def _lm_rank_serve(ctx, legs):
    """One rank of phase 8p, for each of ``legs`` in turn (dicts: label,
    kind, cfg, params, prompts, new, slots, max_len): cut the parent's
    weights (through CUDA IPC) to this rank's share
    (``lm_params_for_rank``: its rows of the vocabulary and its experts
    copied, the rest as given), then serve under its ProcessContext from
    launch counts at 0: kind "batcher" runs ``prompts`` through
    ContinuousBatcher(slots x max_len), "decode" the first prompt's
    prefill and ``new`` greedy steps.  Every rank's records (the head's
    calls, tokens, counts, times, its own bytes and peak memory) are
    gathered to rank 0, which returns them by leg."""
    import torch.distributed as tdist

    from repro_torch.utils.convert import lm_params_for_rank

    pt = port_namespace()
    kmods = _kernel_mods()
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for leg in legs:
        cfg = leg["cfg"]
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        mine = lm_params_for_rank(leg.pop("params"), cfg, ctx)
        _sync(dev)
        own = [mine["embed"].local] + [
            mine["moe_blocks"]["moe"][k] for k in ("gate", "up", "down")
            if "moe_blocks" in mine]
        rec = dict(cut_s=time.perf_counter() - t0,
                   own_bytes=sum(t.numel() * t.element_size() for t in own))
        held, restore = _hold_tbe(pt)
        try:
            with torch.no_grad():
                if leg["kind"] == "batcher":
                    eng = pt.ContinuousBatcher(
                        mine, cfg, num_slots=leg["slots"],
                        max_len=leg["max_len"], ctx=ctx, eos_id=-1)
                    rec.update(_record_batcher(pt, eng, leg["prompts"],
                                               leg["new"], kmods))
                    rec["heads"] = [(h.cpu(), lg.cpu())
                                    for h, lg in rec["heads"]]
                    rec["cache"] = {
                        name: {k: tuple(v.shape) for k, v in st.items()}
                        for name, st in pt.dec.kv_stacks(eng.cache).items()}
                    del eng
                else:
                    rec.update(_greedy_run(
                        pt, mine, cfg, leg["prompts"][0][1], ctx, leg["new"],
                        leg["max_len"], dev, kmods, "moe_ffn_ep_rank"))
        finally:
            restore()
        rec["tbe_held"] = _held(held)
        if cuda:
            _sync(dev)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        del mine, own
        if cuda:
            torch.cuda.empty_cache()
        gathered = [None] * ctx.world
        tdist.all_gather_object(gathered, rec, group=ctx.group)
        out[leg["label"]] = gathered
    return out


def _run_lm_ranks(pt, backend, legs) -> dict:
    t0 = time.perf_counter()
    got = pt.run_ranks(_lm_rank_serve, LMP_RANKS, backend=backend,
                       device=_rank_device() if backend == "gloo" else None,
                       args=(legs,), timeout_s=LMP_TIMEOUT_S)
    log(f"  {backend}, {LMP_RANKS} processes"
        f"{' sharing the card' if backend == 'gloo' else ', one a card'}, "
        f"legs {[leg['label'] for leg in legs]}: "
        f"{time.perf_counter() - t0:.1f} s (spawn, the shares' copies, "
        f"serving, the records' gather)")
    return got


def _log_rank_memory(label, ranks) -> list:
    peak = [r.get("peak_bytes", 0) / 1e9 for r in ranks]
    log(f"  [{label}] each rank's own copies {ranks[0]['own_bytes'] / 1e9:.3f}"
        f" GB (its vocabulary rows and experts; cut in "
        f"{max(r['cut_s'] for r in ranks):.2f} s), peak device memory "
        f"{[round(p, 2) for p in peak]} GB a rank (its own allocations; the "
        f"replicated weights are the parent's, through CUDA IPC)")
    return peak


def _granite_leg(pt, kmods) -> tuple:
    """(a)'s weights and requests, and its simulated run: granite-8b at
    full width, LMP_GRANITE_LAYERS layers; phase 8's ctx-leg requests
    (the long prompt and a short one, CTX_NEW new tokens each) through
    ContinuousBatcher(CTX_SLOTS x LM_MAX_LEN) under
    make_context(LMP_RANKS), the head's calls recorded."""
    cfg = dataclasses.replace(pt.LM_CONFIG, num_layers=LMP_GRANITE_LAYERS)
    params = pt.lm.init_params(torch.Generator(device=DEV).manual_seed(11),
                               cfg, tp_size=LMP_RANKS, device=DEV)
    reqs = [(r.rid, r.prompt) for r in _lm_requests(pt, cfg)[:2]]
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  (a) {cfg.name}, {cfg.num_layers} of {pt.LM_CONFIG.num_layers} "
        f"layers: {nbytes / 1e9:.2f} GB of weights; {len(reqs)} requests of "
        f"{[len(p) for _, p in reqs]} tokens, {CTX_NEW} new each, "
        f"{CTX_SLOTS} slots x {LM_MAX_LEN} positions "
        f"({LM_MAX_LEN // LMP_RANKS} a rank)")
    with torch.no_grad():
        eng = pt.ContinuousBatcher(params, cfg, num_slots=CTX_SLOTS,
                                   max_len=LM_MAX_LEN,
                                   ctx=pt.make_context(LMP_RANKS), eos_id=-1,
                                   device=DEV)
        sim = _record_batcher(pt, eng, reqs, CTX_NEW, kmods)
    del eng
    sim["heads"] = [(h.cpu(), lg.cpu()) for h, lg in sim["heads"]]
    torch.cuda.empty_cache()
    return dict(label="(a)", kind="batcher", cfg=cfg, params=params,
                prompts=reqs, new=CTX_NEW, slots=CTX_SLOTS,
                max_len=LM_MAX_LEN), sim


def _check_granite(sim, leg, ranks) -> dict:
    """(a)'s checks: every rank's head inputs and logits bitwise the
    simulated run's at every call; its tokens rank 0's and the simulated
    run's; per rank one TBE launch an embedding call and the flash
    kernel once a layer per long prefill, all on wgmma; each rank's
    cache LM_MAX_LEN / LMP_RANKS positions."""
    cfg, reqs = leg["cfg"], leg["prompts"]
    n_long = sum(len(p) > cfg.attn_chunk_threshold for _, p in reqs)
    n_flash = cfg.num_layers * n_long
    positions = LM_MAX_LEN // LMP_RANKS
    peak = _log_rank_memory("(a)", ranks)
    prefill = [[(n, round(1e3 * t, 1)) for n, t in r["prefill"]]
               for r in ranks]
    med = [1e3 * statistics.median(r["decode"]) for r in ranks]
    ntok = sum(len(t) for t in ranks[0]["tokens"].values())
    same = [len(r["heads"]) == len(sim["heads"]) and all(
        torch.equal(h, hs) and torch.equal(lg, ls)
        for (h, lg), (hs, ls) in zip(r["heads"], sim["heads"]))
        for r in ranks]
    log(f"  [(a)] heads bitwise the simulated ranks' at all "
        f"{len(sim['heads'])} calls per rank: {same}; tokens equal "
        f"{[r['tokens'] == sim['tokens'] for r in ranks]}; prefill ms by "
        f"length per rank {prefill} (simulated "
        f"{[(n, round(1e3 * t, 1)) for n, t in sim['prefill']]}); median "
        f"decode step per rank {[round(m, 3) for m in med]} ms (simulated "
        f"{1e3 * statistics.median(sim['decode']):.3f}; host clock, four "
        f"processes time-slicing the card); {ntok} tokens in "
        f"{max(r['serve_s'] for r in ranks):.3f} s (slowest rank); "
        f"launches per rank {TBE_FLAT} {ranks[0]['counts'][TBE_FLAT]}, "
        f"flash_attention {ranks[0]['counts']['flash_attention']}")
    for r, rec in enumerate(ranks):
        n_steps = len(rec["decode"])
        check(same[r], f"8p (a) rank {r}: the head's inputs and logits "
                       f"bitwise the simulated ranks' at every call")
        check(rec["tokens"] == ranks[0]["tokens"] == sim["tokens"],
              f"8p (a) rank {r}: tokens rank 0's and the simulated run's")
        check(all(d[TBE_FLAT] == adm + 1 for adm, d in rec["steps"])
              and rec["counts"] == dict(_launches(
                  flash_attention=n_flash,
                  **{TBE_FLAT: len(reqs) + n_steps}), chunked=0)
              and rec["routes"] == {"wgmma": n_flash, "simt": 0},
              f"8p (a) rank {r}: one TBE launch per embedding call, "
              f"{cfg.num_layers} flash launches on wgmma per long prefill, "
              f"nothing else ({rec['counts']}, {rec['routes']})")
        check(all(shape[2] == positions for st in rec["cache"].values()
                  for shape in st.values()),
              f"8p (a) rank {r}: its cache holds {positions} positions")
    return dict(prefill=[r["prefill"] for r in ranks], decode_ms=med,
                peak_gb=peak, sim_prefill=sim["prefill"],
                sim_decode_ms=1e3 * statistics.median(sim["decode"]),
                launches={k: sum(r["counts"][k] for r in ranks)
                          for k in SOURCES})


def _moe_leg(pt, kmods, n_layers, label, base=None, seed=13,
             prompt_len=None, max_len=LM_MAX_LEN) -> tuple:
    """(b)'s (or the NCCL leg's, or (d)'s) weights and prompt, and its
    simulated run: ``base`` (moonshot-v1-16b-a3b by default) at full
    width, ``n_layers`` layers; the long prompt (or ``prompt_len``
    uniform ids from ``seed``) prefilled and CTX_NEW greedy decode steps
    into a cache of ``max_len`` positions under
    make_context(LMP_RANKS)."""
    base = pt.MOE_CONFIG if base is None else base
    cfg = dataclasses.replace(base, num_layers=n_layers)
    t0 = time.perf_counter()
    params = pt.lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                               cfg, tp_size=LMP_RANKS, device=DEV)
    _sync(DEV)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompt = _lm_requests(pt, cfg, 1)[0].prompt if prompt_len is None \
        else np.random.default_rng(seed).integers(
            0, cfg.vocab_size, prompt_len).astype(np.int32)
    log(f"  {label} {cfg.name}, {cfg.num_layers} of "
        f"{base.num_layers} layers "
        f"({cfg.num_layers - cfg.first_k_dense} MoE, "
        f"{cfg.num_experts // LMP_RANKS} experts a rank): "
        f"{nbytes / 1e9:.2f} GB of weights drawn in "
        f"{time.perf_counter() - t0:.1f} s; the {len(prompt)}-token prompt "
        f"and {CTX_NEW} greedy decode steps, {max_len} positions "
        f"({max_len // LMP_RANKS} a rank)")
    with torch.no_grad():
        sim = _greedy_run(pt, params, cfg, prompt,
                          pt.make_context(LMP_RANKS), CTX_NEW, max_len,
                          DEV, kmods, "moe_ffn_ep")
    if DEV != "cpu":
        torch.cuda.empty_cache()
    return dict(label=label, kind="decode", cfg=cfg, params=params,
                prompts=[(0, prompt)], new=CTX_NEW, slots=1,
                max_len=max_len), sim


def _check_moe(sim, leg, ranks) -> dict:
    """(b)'s checks (and the NCCL leg's): every rank's tokens, logits and
    drops rank 0's; against the simulated run, over the calls whose
    inputs agree (every earlier greedy token equal): the logits bitwise,
    else within LMP_EP_REL relative L2, logged; the first greedy token
    that differs is logged, not failed (a router near-tie); with the
    logits bitwise, moe_dropped equal at every layer.  Per rank one TBE
    launch an embedding call and the flash kernel once a layer in the
    prefill, on wgmma."""
    cfg, label = leg["cfg"], leg["label"]
    prompt = leg["prompts"][0][1]
    n_moe = cfg.num_layers - cfg.first_k_dense
    n_flash = cfg.num_layers * (len(prompt) > cfg.attn_chunk_threshold)
    rec0 = ranks[0]
    flip = next((i for i, (a, b) in enumerate(zip(rec0["tokens"],
                                                  sim["tokens"])) if a != b),
                len(sim["tokens"]))
    # call j (the prefill, then step j) saw equal inputs while j <= flip
    same = min(flip + 1, len(sim["logits"]))
    rels, bitwise = [], True
    for a, b in zip(rec0["logits"][:same], sim["logits"][:same]):
        bitwise &= torch.equal(a, b)
        rels.append(float((a.float() - b.float()).norm()
                          / b.float().norm()))
    runs = 1 + CTX_NEW
    drops = [rec0["drops"][j * n_moe:(j + 1) * n_moe] for j in range(runs)]
    sim_drops = [sim["drops"][j * n_moe:(j + 1) * n_moe]
                 for j in range(runs)]
    differ = [j for j in range(same) if drops[j] != sim_drops[j]]
    peak = _log_rank_memory(label, ranks)
    med = [1e3 * statistics.median(r["step_s"]) for r in ranks]
    log(f"  [{label}] logits {'bitwise' if bitwise else 'not bitwise'} the "
        f"simulated ranks' over the {same} calls with equal inputs "
        f"(relative L2 per call {' '.join(f'{v:.2e}' for v in rels)}; bound "
        f"{LMP_EP_REL}); greedy tokens "
        f"{'equal' if flip == len(sim['tokens']) else f'differ first at {flip}'}"
        f"; moe_dropped per run {[sum(d) for d in drops]} (simulated "
        f"{[sum(d) for d in sim_drops]}; runs with a layer that differs "
        f"{differ}, prefill's by layer {drops[0]} / {sim_drops[0]}); prefill "
        f"ms per rank {[round(1e3 * r['prefill_s'], 1) for r in ranks]} "
        f"(simulated {1e3 * sim['prefill_s']:.1f}); median decode step per "
        f"rank {[round(m, 3) for m in med]} ms (simulated "
        f"{1e3 * statistics.median(sim['step_s']):.3f}; host clock); cache "
        f"{rec0['cache_bytes'] / 1e9:.3f} GB a rank; launches per rank "
        f"{TBE_FLAT} {[r['counts'][TBE_FLAT] for r in ranks]}, "
        f"flash_attention {[r['counts']['flash_attention'] for r in ranks]}"
        f", chunked_attention calls {[r['counts']['chunked'] for r in ranks]}")
    for r, rec in enumerate(ranks):
        check(rec["tokens"] == rec0["tokens"] and all(
            torch.equal(a, b) for a, b in zip(rec["logits"], rec0["logits"]))
            and rec["drops"] == rec0["drops"],
            f"8p {label} rank {r}: tokens, logits and drops rank 0's")
        check(rec["counts"] == dict(_launches(
                  flash_attention=n_flash, **{TBE_FLAT: runs}), chunked=0)
              and rec["routes"] == {"wgmma": n_flash, "simt": 0},
              f"8p {label} rank {r}: one TBE launch per embedding call, "
              f"{n_flash} flash launches on wgmma, nothing else "
              f"({rec['counts']}, {rec['routes']})")
        check(len(rec["drops"]) == n_moe * runs,
              f"8p {label} rank {r}: {len(rec['drops'])} moe_ffn_ep_rank "
              f"calls, want {n_moe} x {runs}")
    check(max(rels) < LMP_EP_REL,
          f"8p {label}: logits within {LMP_EP_REL} of the simulated ranks' "
          f"over the {same} calls with equal inputs (max {max(rels):.3e})")
    if bitwise:
        check(not differ, f"8p {label}: with the logits bitwise, "
                          f"moe_dropped equal at every layer of every call")
    return dict(bitwise=bitwise, rel=max(rels), flip=flip, differ=differ,
                prefill_ms=[1e3 * r["prefill_s"] for r in ranks],
                decode_ms=med, peak_gb=peak,
                sim_prefill_ms=1e3 * sim["prefill_s"],
                sim_decode_ms=1e3 * statistics.median(sim["step_s"]),
                launches={k: sum(r["counts"][k] for r in ranks)
                          for k in SOURCES})


def phase_lm_ranks(pt, kmods, backends=("gloo", "nccl")) -> dict:
    """Phase 8p: (a) granite-8b, (b) moonshot-v1-16b-a3b and (d)
    deepseek-v3-671b over gloo in one spawn, 4 processes sharing the
    card, and where there are LMP_RANKS cards (c), the NCCL leg;
    ``backends`` picks the legs (``tools/rank_phases.py 8p-nccl`` runs
    (c) alone)."""
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 8p. LM serving with each rank a process ({LMP_RANKS} processes "
        f"sharing the card in a gloo group; the vocabulary's rows, the "
        f"experts and the cache's positions sharded over them; "
        f"torch.cuda.device_count() {n_cards})")
    t0 = time.perf_counter()
    out = {}
    if "gloo" in backends:
        granite, granite_sim = _granite_leg(pt, kmods)
        moe, moe_sim = _moe_leg(pt, kmods, LMP_MOE_LAYERS, "(b)")
        ds, ds_sim = _moe_leg(pt, kmods, LMP_DS_LAYERS, "(d)",
                              base=pt.deepseek_v3_671b.CONFIG,
                              seed=LMP_DS_SEED, prompt_len=LMP_DS_PROMPT,
                              max_len=LMP_DS_MAX_LEN)
        if DEV != "cpu":
            log(f"  the parent holds {torch.cuda.memory_allocated() / 1e9:.2f}"
                f" GB on the card (the three legs' weights) as the ranks "
                f"start")
        legs = [granite, moe, ds]
        ranks = _run_lm_ranks(pt, "gloo", legs)
        del legs, granite["params"], moe["params"], ds["params"]
        if DEV != "cpu":
            torch.cuda.empty_cache()
        out["granite"] = _check_granite(granite_sim, granite, ranks["(a)"])
        out["moe"] = _check_moe(moe_sim, moe, ranks["(b)"])
        out["ds"] = _check_moe(ds_sim, ds, ranks["(d)"])
        # each rank's TBE launch shapes against the plain version on the
        # legs' own inputs
        for key, label in (("granite", "(a)"), ("moe", "(b)"), ("ds", "(d)")):
            out[key]["tbe_err"] = _check_held(f"8p {label}", ranks[label])
        out["launches"] = {k: sum(out[leg]["launches"][k] for leg in
                                  ("granite", "moe", "ds")) for k in SOURCES}
    if "nccl" in backends and n_cards >= LMP_RANKS:
        leg, sim = _moe_leg(pt, kmods, pt.MOE_CONFIG.num_layers, "(c)")
        ranks = _run_lm_ranks(pt, "nccl", [leg])
        del leg["params"]
        torch.cuda.empty_cache()
        out["nccl"] = _check_moe(sim, leg, ranks["(c)"])
        out["nccl"]["tbe_err"] = _check_held("8p (c)", ranks["(c)"])
    elif "nccl" in backends:
        log(f"  the NCCL leg needs {LMP_RANKS} cards (one process a card; "
            f"NCCL refuses two ranks on one device): not run on this "
            f"machine")
    out["secs"] = time.perf_counter() - t0
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 8p: {out['secs']:.1f} s; rank processes alive after it: "
        f"{len(alive)}")
    check(not alive, "phase 8p's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 8tp. LM training with each rank a process
# ---------------------------------------------------------------------------

LMT_RANK_PATH = "8tp LM training, ranks as processes"
LMTP_RANKS = 4
# the depths and tokens, reckoned before the runs and cut after a run on
# an H100 where a granite rank at 4 layers ran out of the card's memory in
# its backward (13.26 GB allocated, 1.53 reserved, beside three more and
# the parent's 7.5 GB of simulated weights).  What a rank holds at the
# peak of a step, every rank alike: its state (bf16 weights and
# gradients, int8 moments: granite-8b ~1.32 GB a layer, phase 8t's 50.04 GB
# over 8.25 B parameters, and the head's 1.22 GB with its state; the
# vocabulary's rows and the experts a quarter), plus the step's
# activations, which no rank shares: attention's f32 (1, H, S, S) scores,
# probabilities and their gradients (4 x 2.1 GB for granite's 32 heads at
# 4,096 tokens) and the loss's f32 (S, Vp) logits with their recompute and
# gradient (~4 x 0.8 GB for granite's 49,152 rows; ~4 x 2.7 GB for
# moonshot's 163,840 at 4,096 tokens).  granite-8b at 2 layers and 4,096
# tokens: ~3.4 GB of state and ~12 of activations, ~15 GB a rank;
# moonshot-v1-16b-a3b at 4 layers (1 dense, 3 MoE; a rank's 16 of 64
# experts) needs ~20 GB a rank at 4,096 tokens, which four ranks cannot
# hold on one card, and ~12 GB at 2,048, the tokens its leg takes
LMTP_GRANITE_LAYERS = 2
LMTP_MOE_LAYERS = 4
LMTP_MOE_SEQ = 2048
LMTP_STEPS = 2
LMTP_SEED = 5                # the batches' seed
LMTP_RESUME_LAYERS = 2       # (c): moonshot, 1 dense + 1 MoE layer
LMTP_TIMEOUT_S = 600.0
# the gradient norm (the clip factor is grad_clip over it) against the
# simulated ranks': one rank's sum of squares of its vocabulary rows (and
# experts) is added over the ranks in gloo's order where one device sums
# the whole leaf, the embedding's gradient adds with index_add_'s atomics
# on either side, and the routers' and shared experts' gradients are
# summed over the ranks; each is a few f32 roundings of sums of ~1e8
# squares (~1e-7 relative), so 1e-5 relative holds with a margin
LMTP_NORM_REL = 1e-5
# the losses: step 1 is a forward of the same weights, bitwise the
# simulated ranks' but for moe_aux's load statistics (summed in gloo's
# order, 1e-5 relative in tests/test_torch_lm_ranks.py); step 2 follows
# an update scaled by the clip factor above
LMTP_LOSS_REL = 1e-5
# a MoE model's routers and shared experts: each rank's gradient covers
# its tokens, and the ranks' are summed in f32 -- over processes by the
# group's all-reduce, on one device in rank order (models/moe._FanOut) --
# and rounded once to the leaf's dtype.  A token's cotangents from the
# router, the dispatch and the shared experts add in one order on both
# sides (_FanOut again), so every rank's partial is the simulated rank's
# bit for bit.  Two f32 sums of E terms differ by at most 2 (E - 1)
# 2**-24 sum_r |g_r| per element, to first order: the f32 routers are held
# to that in L2 (each rank's |g_r| all-reduced before the sum, after step
# 1, the same weights on both sides); a bf16 leaf rounds those two sums
# once each, to equal or adjacent bf16 values, which each element is held
# to
LMTP_SUM_REL = 2 * (LMTP_RANKS - 1) * 2.0 ** -24
# each parameter leaf's change against the simulated run's: the
# relative L2 of the difference of the two changes (both from the same
# initial weights), so that an update wrong or missing reads ~1.  Held
# after the steps for a dense leg (an H100 read 9.3e-5 for granite: the
# clip's 1e-7 moves a few int8 codes, and with them a few elements'
# updates), after step 1 for a MoE leg (below)
LMTP_CHANGE_REL = 1e-3
# a MoE leg after step 1: its routers' f32 sums (LMTP_SUM_REL) move its
# weights by a few int8 codes, and step 2 then routes a token or two
# otherwise (moe_dropped 29,089 against 29,088 on an H100), whose loss and
# gradient move discretely: there the loss read 1.8e-5 and the gradient
# norm 1.1e-5 apart, and the leaves' changes after step 2 up to 1.9e-2.
# So a MoE leg's parameters are held after step 1, and its later losses
# and norms to about 10x their readings
LMTP_MOE_LATER_REL = 2e-4


def _lm_train_rank(ctx, legs):
    """One rank of phase 8tp, for each of ``legs`` in turn (dicts: label,
    kind, cfg, tc, steps, seq, seed, and for kind "steps" the simulated
    run's parameters through CUDA IPC, for kind "resume" a shared
    directory): "steps" runs ``Trainer(ctx=ctx)`` (the rank's share of
    the state drawn from the seed) for ``steps`` steps from launch
    counts at 0 and holds each leaf's change to the simulated run's
    change of the rank's share; "resume" runs 2 steps straight, then 1
    step with a
    checkpoint (rank 0 writes the whole state), a restart from it and 1
    more, and compares the two states bitwise.  Every rank's records go
    to rank 0."""
    import torch.distributed as tdist

    pt = port_namespace()
    kmods = _kernel_mods()
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for leg in legs:
        cfg, tc = leg["cfg"], leg["tc"]

        def data(start=0):
            return pt.lm_batches(cfg, LMT_BATCH, leg["seq"],
                                 seed=leg["seed"], start_step=start)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        rec = {}
        if leg["kind"] == "steps":
            t0 = time.perf_counter()
            tr = pt.Trainer(cfg, tc, data(), ctx=ctx)
            _sync(dev)
            rec["init_s"] = time.perf_counter() - t0
            init = {path: t.detach().to("cpu", copy=True) for path, t in
                    pt.flatten_with_paths(pt.tstep.rank_tensors(
                        tr.state["params"]))}
            _reset_counts(pt, kmods)
            # step 1's sum_r |g_r| of the token-sliced leaves, before the
            # step sums them: the measure of the sum's rounding
            mass, cls = {}, type(tr.step_fn)
            real = cls._sum_token_slices

            def recording(step):
                if not mass:
                    with torch.no_grad():
                        for path, g in pt.flatten_with_paths(step.grads):
                            if pt.token_slice_leaf(path):
                                mass[path] = pt.comm.all_reduce(
                                    g.float().abs(), ctx=step.ranks)
                real(step)
            cls._sum_token_slices = recording
            try:
                tr.run(1)
            finally:
                cls._sum_token_slices = real
            # the token-sliced leaves' gradients of step 1 (the same
            # weights as the simulated run's) against its: (relative L2;
            # an f32 leaf's bound 2 (E - 1) 2**-24 ||sum_r |g_r||| over its
            # norm, or for a bf16 leaf the most bf16 values between an
            # element and the simulated one's, at most 1)
            sim_g = leg.pop("sim_grads")
            with torch.no_grad():
                rec["slice_rels"] = {}
                for path, g in pt.flatten_with_paths(tr.step_fn.grads):
                    if pt.token_slice_leaf(path):
                        w = sim_g[path].to(dev)
                        rel = float((g.float() - w.float()).norm()
                                    / w.float().norm())
                        rec["slice_rels"][path] = (
                            (rel, float(LMTP_SUM_REL * mass[path].norm()
                                        / w.float().norm()))
                            if g.dtype == torch.float32 else
                            (rel, _bf16_steps_apart(g, w)))
            del sim_g, mass

            def changes():
                """Each leaf's change so far against the simulated run's
                after as many steps (the same initial weights); the
                comparison's f32 temporaries left out of the peak."""
                if cuda:
                    _sync(dev)
                    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
                sim = dict(pt.flatten_with_paths(leg.pop("sim_params")))
                mine = dict(pt.flatten_with_paths(
                    pt.tstep.rank_tensors(tr.state["params"])))
                rels, same = {}, 0
                with torch.no_grad():
                    for path, p in mine.items():
                        w = sim.pop(path).to(dev)
                        if w.shape != p.shape:        # this rank's share
                            n = p.shape[1]
                            w = w.narrow(1, ctx.rank * n, n)
                        same += torch.equal(p, w)
                        moved = w.float() - init.pop(path).to(dev).float()
                        rels[path] = float((p.float() - w.float()).norm()
                                           / moved.norm().clamp_min(1e-30))
                rec.update(rels=rels, bitwise=same, leaves=len(mine),
                           own_bytes=sum(
                               t.numel() * t.element_size()
                               for path, t in mine.items()
                               if pt.rank_sharded(path, cfg)))
                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
            if leg["held_step"] == 1:
                changes()
            tr.run(leg["steps"] - 1)
            if leg["held_step"] == leg["steps"]:
                changes()
            rec["counts"] = _counts(pt, kmods)
            rec["metrics"] = [m for _, m in tr.metrics_log]
            del tr
        else:
            t0 = time.perf_counter()
            whole = pt.Trainer(cfg, tc, data(), ctx=ctx)
            whole.run(2)
            first = pt.Trainer(cfg, tc, data(), ckpt_dir=leg["dir"],
                               ctx=ctx)
            first.run(1)
            del first
            resumed = pt.Trainer(cfg, tc, data(1), ckpt_dir=leg["dir"],
                                 ctx=ctx)
            rec["start"] = resumed.start_step
            resumed.ckpt_dir = None       # no checkpoint of its own
            resumed.run(1)
            pairs = zip(pt.flatten_with_paths(
                pt.tstep.rank_tensors(whole.state["params"])),
                pt.flatten_with_paths(
                pt.tstep.rank_tensors(resumed.state["params"])))
            same = [torch.equal(a, b) for (_, a), (_, b) in pairs]
            same += [torch.equal(a, b) for (_, a), (_, b) in zip(
                pt.flatten_with_paths(whole.state["opt"]),
                pt.flatten_with_paths(resumed.state["opt"]))]
            rec.update(same=sum(same), leaves=len(same),
                       secs=time.perf_counter() - t0)
            if ctx.rank == 0:
                step1 = os.path.join(leg["dir"], "step_00000001")
                rec["ckpt_bytes"] = sum(
                    os.path.getsize(os.path.join(step1, f))
                    for f in os.listdir(step1))
            del whole, resumed
        if cuda:
            _sync(dev)
            rec["peak_bytes"] = max(rec.get("peak_bytes", 0),
                                    torch.cuda.max_memory_allocated(dev))
            torch.cuda.empty_cache()
        gathered = [None] * ctx.world
        tdist.all_gather_object(gathered, rec, group=ctx.group)
        out[leg["label"]] = gathered
    return out


def _bf16_steps_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """The most bf16 values between an element of ``got`` and of ``want``
    (both bf16): the distance of their 16-bit patterns' orders."""
    def order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((order(got) - order(want)).abs().max())


def _lm_train_leg(pt, base, n_layers, seq, label, held_step) -> tuple:
    """A leg of phase 8tp and its simulated run: ``base`` at its
    published widths cut to ``n_layers``, bf16, int8 moments;
    ``Trainer(ctx=make_context(LMTP_RANKS))`` for LMTP_STEPS steps of
    LMT_BATCH x ``seq`` tokens on the card, before the ranks; its
    metrics, and its parameters after ``held_step`` steps for the ranks
    (the moments and gradients freed)."""
    cfg = dataclasses.replace(base, num_layers=n_layers)
    tc = pt.TrainConfig(optimizer_state_dtype="int8", remat=True,
                        warmup_steps=1, total_steps=LMTP_STEPS + 2,
                        checkpoint_every=100)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = pt.Trainer(cfg, tc, pt.lm_batches(cfg, LMT_BATCH, seq,
                                           seed=LMTP_SEED),
                    ctx=pt.make_context(LMTP_RANKS), device=DEV)
    tr.run(1)
    grads = {path: g.clone() for path, g in pt.flatten_with_paths(
        tr.step_fn.grads) if pt.token_slice_leaf(path)}
    spread = {}
    if grads:
        # the same step again from the seed: how far the card's own runs
        # of these gradients lie apart
        again = pt.Trainer(cfg, tc, pt.lm_batches(cfg, LMT_BATCH, seq,
                                                  seed=LMTP_SEED),
                           ctx=pt.make_context(LMTP_RANKS), device=DEV)
        again.run(1)
        spread = {path: float((g.float() - grads[path].float()).norm()
                              / grads[path].float().norm())
                  for path, g in pt.flatten_with_paths(again.step_fn.grads)
                  if path in grads}
        del again
        torch.cuda.empty_cache()
    if held_step == 1:
        params = pt.map_leaves(torch.clone, tr.state["params"])
    tr.run(LMTP_STEPS - 1)
    sim = [m for _, m in tr.metrics_log]
    if held_step == LMTP_STEPS:
        params = tr.state["params"]
    nbytes = _tree_bytes(pt, params)
    log(f"  {label} {cfg.name}, {n_layers} of {base.num_layers} layers, "
        f"{nbytes / 1e9:.2f} GB of bf16 weights: the simulated run under "
        f"make_context({LMTP_RANKS}), {LMTP_STEPS} steps of "
        f"{LMT_BATCH} x {seq} tokens, losses "
        f"{[m['loss'] for m in sim]}, grad norms "
        f"{[m['grad_norm'] for m in sim]}, steps "
        f"{[round(m['step_time_s'], 3) for m in sim]} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, in "
        f"{time.perf_counter() - t0:.1f} s; two simulated runs' step-1 "
        f"router and shared-expert gradients apart by "
        f"{ {p: f'{v:.3e}' for p, v in spread.items()} } relative L2")
    del tr
    torch.cuda.empty_cache()
    return dict(label=label, kind="steps", cfg=cfg, tc=tc, spread=spread,
                steps=LMTP_STEPS, seq=seq, seed=LMTP_SEED,
                held_step=held_step, sim_params=params,
                sim_grads=grads), sim


def _check_lm_train(pt, leg, sim, ranks, tag="") -> dict:
    """A leg's checks: every rank's metrics rank 0's; against the
    simulated run step 1's loss within LMTP_LOSS_REL and its gradient
    norm within LMTP_NORM_REL, the later ones within those (a dense leg)
    or LMTP_MOE_LATER_REL, moe_dropped equal at step 1 (the forward of
    the same weights), step 1's router and shared-expert gradients as
    LMTP_SUM_REL states; each leaf's change over the leg's held steps
    within LMTP_CHANGE_REL of the simulated run's; per rank one TBE
    launch a step (the vocabulary's lookup), nothing else."""
    label, cfg = leg["label"] + tag, leg["cfg"]
    m0 = ranks[0]["metrics"]
    loss_rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(m0, sim)]
    loss_rel = max(loss_rels)
    norm_rels = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(m0, sim)]
    norm_rel = max(norm_rels)
    later = LMTP_MOE_LATER_REL if cfg.is_moe else LMTP_LOSS_REL
    worst = max(max(rec["rels"].values()) for rec in ranks)
    slice0 = ranks[0]["slice_rels"]
    slices = {p: max(rec["slice_rels"][p][0] for rec in ranks)
              for p in slice0}
    peak = [rec.get("peak_bytes", 0) / 1e9 for rec in ranks]
    step_s = [[round(m["step_time_s"], 3) for m in rec["metrics"]]
              for rec in ranks]
    drops = [m.get("moe_dropped") for m in m0]
    f32_bounds = {p: f"{b:.3e}" for p, (_, b) in slice0.items()
                  if isinstance(b, float)}
    bf16_apart = {p: max(rec["slice_rels"][p][1] for rec in ranks)
                  for p, (_, b) in slice0.items() if isinstance(b, int)}
    log(f"  [{label}] losses {[m['loss'] for m in m0]} (simulated within "
        f"{[f'{v:.3e}' for v in loss_rels]} relative, bounds "
        f"{LMTP_LOSS_REL} at step 1, {later} after); grad norms "
        f"{[m['grad_norm'] for m in m0]} (within "
        f"{[f'{v:.3e}' for v in norm_rels]}, bounds {LMTP_NORM_REL} at "
        f"step 1, {later} after); step 1's token-sliced gradients within "
        f"{ {p: f'{v:.3e}' for p, v in slices.items()} } relative L2 (f32: "
        f"bound 2 (E - 1) 2**-24 ||sum_r |g_r||| {f32_bounds}; bf16: "
        f"bf16 values apart at most {bf16_apart}, bound 1); parameters "
        f"after {leg['held_step']} of {len(m0)} steps: "
        f"{[rec['bitwise'] for rec in ranks]} of {ranks[0]['leaves']} "
        f"leaves bitwise per rank, the rest's change within {worst:.3e} "
        f"relative L2 of the simulated change (bound {LMTP_CHANGE_REL}); "
        f"moe_dropped per step {drops} "
        f"(simulated {[m.get('moe_dropped') for m in sim]}); steps per rank "
        f"{step_s} s (host clock; the Trainer's init "
        f"{max(rec['init_s'] for rec in ranks):.1f} s); peak device "
        f"memory {[round(p, 2) for p in peak]} GB a rank (its own shares "
        f"{ranks[0]['own_bytes'] / 1e9:.2f} GB); launches per rank "
        f"{ {k: v for k, v in ranks[0]['counts'].items() if v} }")
    n = leg["steps"]
    for r, rec in enumerate(ranks):
        check(rec["metrics"] == [dict(m, step_time_s=s["step_time_s"])
                                 for m, s in zip(m0, rec["metrics"])],
              f"8tp {label} rank {r}: its metrics rank 0's")
        check(max(rec["rels"].values()) <= LMTP_CHANGE_REL,
              f"8tp {label} rank {r}: every parameter leaf's change over "
              f"{leg['held_step']} steps within {LMTP_CHANGE_REL} of the "
              f"simulated run's (the worst "
              f"{max(rec['rels'], key=rec['rels'].get)})")
        check(all(v <= b if isinstance(b, float) else b <= 1
                  for v, b in rec["slice_rels"].values()),
              f"8tp {label} rank {r}: step 1's router gradients within 2 (E "
              f"- 1) 2**-24 ||sum_r |g_r||| and its shared experts' bf16 "
              f"gradients equal or adjacent to the simulated run's "
              f"({rec['slice_rels']})")
        check(rec["counts"] == dict(_launches(**{TBE_FLAT: n}), chunked=0),
              f"8tp {label} rank {r}: one TBE launch a step, nothing else "
              f"({rec['counts']})")
    check(all(np.isfinite([m["loss"] for m in m0])),
          f"8tp {label}: finite losses")
    check(loss_rels[0] <= LMTP_LOSS_REL and loss_rel <= later,
          f"8tp {label}: step 1's loss within {LMTP_LOSS_REL} of the "
          f"simulated run's, the later ones within {later} ({loss_rels})")
    check(norm_rels[0] <= LMTP_NORM_REL and norm_rel <= later,
          f"8tp {label}: gradient norms (the clip factor's divisor) within "
          f"{LMTP_NORM_REL} of the simulated run's at step 1, {later} "
          f"after ({norm_rels})")
    if cfg.is_moe:
        check(m0[0]["moe_dropped"] == sim[0]["moe_dropped"],
              f"8tp {label}: moe_dropped of step 1 the simulated run's")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, param_rel=worst,
                slice_rel=max(slices.values(), default=0.0),
                peak_gb=peak, step_s=step_s, losses=[m["loss"] for m in m0],
                launches=sum(rec["counts"][TBE_FLAT] for rec in ranks))


@contextlib.contextmanager
def _expandable_segments():
    """Rank processes spawned inside allocate in expandable segments: a
    step's activations come and go in sizes that fragment fixed ones (on
    an H100, 1.53 GB reserved but unallocated in the rank that ran out);
    nothing they allocate crosses processes."""
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def _run_lm_train_ranks(pt, legs, backend) -> dict:
    """Phase 8tp's ranks over ``backend`` (gloo: every rank on the card;
    nccl: one rank a card), the legs in one spawn."""
    with _expandable_segments():
        t0 = time.perf_counter()
        ranks = pt.run_ranks(
            _lm_train_rank, LMTP_RANKS, backend=backend,
            device=_rank_device() if backend == "gloo" else None,
            args=(legs,), timeout_s=LMTP_TIMEOUT_S)
        log(f"  {backend}, {LMTP_RANKS} processes, legs "
            f"{[leg['label'] for leg in legs]}: "
            f"{time.perf_counter() - t0:.1f} s (spawn, the draws and cuts, "
            f"the steps, the checkpoint, the records' gather)")
        return ranks


def _check_resume(pt, rc, tag) -> None:
    log(f"  [(c){tag}] {pt.MOE_CONFIG.name} at {LMTP_RESUME_LAYERS} layers "
        f"(1 MoE), {RESUME_TOKENS} tokens: 2 steps against 1, a checkpoint "
        f"of {rc[0]['ckpt_bytes']:,} B (the whole state, rank 0 receiving "
        f"the cut leaves' shares on the host and writing), a restart at "
        f"step {rc[0]['start']} and 1 more: "
        f"{[rec['same'] for rec in rc]} of {rc[0]['leaves']} leaves bitwise "
        f"per rank, in {max(rec['secs'] for rec in rc):.1f} s; peak device "
        f"memory {[round(rec.get('peak_bytes', 0) / 1e9, 2) for rec in rc]}"
        f" GB a rank")
    for r, rec in enumerate(rc):
        check(rec["start"] == 1 and rec["same"] == rec["leaves"],
              f"8tp (c){tag} rank {r}: resumed at step 1, the state bitwise "
              f"the uninterrupted run's")


def phase_lm_train_ranks(pt, kmods, backends=("gloo", "nccl")) -> dict:
    """Phase 8tp: LM training with each rank a process, 4 sharing the card
    over gloo (and where there are LMTP_RANKS cards the NCCL leg, one rank
    a card): (a) granite-8b and (b) moonshot-v1-16b-a3b at their
    published widths cut in depth, Trainer steps held to the simulated
    ranks' run of the same seed; (c) a resume of moonshot on the ranks,
    bitwise.
    ``backends`` picks the legs."""
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 8tp. LM training with each rank a process ({LMTP_RANKS} "
        f"processes sharing the card over gloo; the vocabulary's rows and "
        f"the experts sharded over them; bf16, int8 moments, remat; "
        f"granite-8b at {LMTP_GRANITE_LAYERS} layers and {LMT_SEQ} tokens, "
        f"moonshot-v1-16b-a3b at {LMTP_MOE_LAYERS} layers and "
        f"{LMTP_MOE_SEQ} tokens; torch.cuda.device_count() {n_cards})")
    t_phase = time.perf_counter()
    granite, g_sim = _lm_train_leg(pt, pt.LMT_CONFIG, LMTP_GRANITE_LAYERS,
                                   LMT_SEQ, "(a)", LMTP_STEPS)
    moe, m_sim = _lm_train_leg(pt, pt.MOE_CONFIG, LMTP_MOE_LAYERS,
                               LMTP_MOE_SEQ, "(b)", 1)
    out = {}
    for backend in backends:
        if backend == "nccl" and n_cards < LMTP_RANKS:
            log(f"  the NCCL leg needs {LMTP_RANKS} cards (one process a "
                f"card): not run on this machine")
            continue
        tmp = tempfile.mkdtemp(prefix="chip_smoke_8tp_")
        resume = dict(label="(c)", kind="resume", cfg=dataclasses.replace(
            pt.MOE_CONFIG, num_layers=LMTP_RESUME_LAYERS),
            tc=pt.TrainConfig(optimizer_state_dtype="int8", remat=True,
                              warmup_steps=1, total_steps=4,
                              checkpoint_every=100),
            seq=RESUME_TOKENS, seed=LMTP_SEED, dir=tmp)
        try:
            ranks = _run_lm_train_ranks(pt, [granite, moe, resume], backend)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tag = "" if backend == "gloo" else " (nccl)"
        res = {"granite": _check_lm_train(pt, granite, g_sim, ranks["(a)"],
                                          tag),
               "moe": _check_lm_train(pt, moe, m_sim, ranks["(b)"], tag)}
        _check_resume(pt, ranks["(c)"], tag)
        if backend == "gloo":
            out.update(res, launches={TBE_FLAT: res["granite"]["launches"]
                                      + res["moe"]["launches"]})
        else:
            out["nccl"] = res
    del granite["sim_params"], moe["sim_params"], moe["sim_grads"]
    torch.cuda.empty_cache()
    out["secs"] = time.perf_counter() - t_phase
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 8tp: {out['secs']:.1f} s; rank processes alive after it: "
        f"{len(alive)}")
    check(not alive, "phase 8tp's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 8dp. a data axis with each rank a process
# ---------------------------------------------------------------------------

DP_RANK_PATH = "8dp (dp, tp) meshes, ranks as processes"
DPP_DP, DPP_TP = 2, 2          # 2 data groups of 2 model-axis ranks
DPP_WORLD = DPP_DP * DPP_TP
# the flushes: CONFIG at full width, phase 7p's strategies whose kernels
# the model axis launches, each group scoring half of each batch of BATCH
DPP_STRATEGIES = (
    ("row/allgather/onesided", dict(sharding="row", rw_backend="onesided")),
    ("row/a2a/bulk", dict(sharding="row", rw_impl="a2a")),
    ("row/a2a/onesided", dict(sharding="row", rw_impl="a2a",
                              rw_backend="onesided")),
)
DPP_FLUSHES = 2
# DLRM training: table-wise (13 of CONFIG's 26 tables a rank, the TBE
# kernel over its stacked tables), CONFIG's widths with each table cut to
# 2**18 rows: a rank's dense gradient is its shard's size and is summed
# over the data axis through the host (gloo), so four processes hold four
# shards, four gradients and their sums (~7 GB at 2**18 rows; ~27 GB at
# CONFIG's 10**6, beside the parent's tables)
DPP_TRAIN = ("table", dict(sharding="table"))
DPP_TRAIN_ROWS = 2 ** 18
DPP_TRAIN_STEPS = 2
DPP_TIMEOUT_S = 600.0
# per rank per flush (each group's half batch): (kernel, launches)
DPP_LAUNCHES = {label: PROC_LAUNCHES[label] for label, _ in DPP_STRATEGIES}
# a group scores half a batch, so its MLPs' GEMMs take other shapes than
# the simulated ranks' whole batch (cuBLAS picks other kernels): pCTR
# within PCTR_TOL, bitwise logged (2.682e-7 apart on an H100).  The DLRM
# flow's losses: phase 7tp's bound.  The LM over a (2, 2) mesh of
# processes is phase 8lr's: granite served at all 36 layers and trained
# through the launchers
DPP_LOSS_REL = TRP_LOSS_REL


def _bit_sums(t: torch.Tensor) -> tuple:
    """Two sums of ``t``'s bit patterns, plain and weighted by position
    (mod 1021), by slices: equal tensors give equal sums, and a flipped
    bit changes both."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({4: torch.int32, 2: torch.int16,
                      1: torch.int8}[flat.element_size()])
    plain = weighted = 0
    step = 1 << 24
    for a in range(0, bits.numel(), step):
        b = bits[a:a + step].to(torch.int64)
        w = torch.arange(a, a + b.numel(), device=b.device) % 1021 + 1
        plain += int(b.sum())
        weighted += int((b * w).sum())
    return plain, weighted


def _dp_flow(pt, kmods, mlp, tables, inputs, cfg, ctx, ranks):
    """DPP_TRAIN_STEPS steps of the flow on one batch, from the MLP layers
    ``mlp`` (``{"bottom", "top"}``) and ``tables``: row-wise Adagrad on
    the tables (a rank's shard), SGD on the MLPs, the gradients summed
    over the data axis (``dlrm.sum_over_data``).  The losses, each step's
    seconds (host clock, synchronised), the forwards' launches, and after
    each step the bit sums of the tables (shard) and the MLP leaves."""
    dev = inputs[0].device
    if ranks:
        tables = pt.eb.shard_for_rank(tables, cfg.embedding_config(), ctx)
    accum = pt.rowwise_adagrad_init(tables)
    layers = {part: len(mlp[part]) for part in ("bottom", "top")}
    mlp = [t.detach().to(dev, copy=True) for t in _mlp_leaves(mlp)]
    losses, step_s, sums = [], [], []
    _reset_counts(pt, kmods)
    for _ in range(DPP_TRAIN_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        leaf = getattr(tables, "local", tables).detach().requires_grad_()
        p = {"tables": dataclasses.replace(tables, local=leaf) if ranks
             else leaf}
        leaves = [t.requires_grad_() for t in mlp]
        it = iter(leaves)
        for part in ("bottom", "top"):
            p[part] = [{"w": next(it), "b": next(it)}
                       for _ in range(layers[part])]
        with torch.enable_grad():
            loss = pt.dlrm.bce_loss(p, *inputs, cfg, ctx)
            grads = torch.autograd.grad(loss, [leaf] + leaves)
        grads = pt.dlrm.sum_over_data(grads, BATCH, ctx)
        tables, accum = pt.rowwise_adagrad_update(
            dataclasses.replace(tables, local=leaf.detach()) if ranks
            else leaf.detach(), accum, grads[0], lr=TRAIN_LR)
        with torch.no_grad():
            mlp = [m.detach() - TRAIN_LR * g
                   for m, g in zip(leaves, grads[1:])]
        losses.append(float(loss.detach()))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        del grads, leaf, p, leaves
        sums.append([_bit_sums(getattr(tables, "local", tables))]
                    + [_bit_sums(m) for m in mlp])
    return dict(losses=losses, step_s=step_s, sums=sums,
                counts=_counts(pt, kmods))


def _dp_rank(ctx, base, tables, mlp, reqs, train):
    """One rank of phase 8dp, a (DPP_DP, DPP_TP) mesh: (a) for each of
    DPP_STRATEGIES a DLRMEngine under the rank's ProcessContext (its
    shard copied from the parent's tables, through CUDA IPC) serves the
    requests in flushes of BATCH, from launch counts at 0, and records
    its symmetric buffers' IPC handles; (b) the DLRM flow on ``train``'s
    tables.  Every rank's records go to global rank 0, in global rank
    order."""
    import torch.distributed as tdist

    pt = port_namespace()
    kmods = _kernel_mods()
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    dense, idx, lens = reqs
    requests = [pt.CTRRequest(rid=i, dense=dense[i], indices=idx[i],
                              lengths=lens[i]) for i in range(len(dense))]
    params = {part: [{k: v.to(dev, copy=True) for k, v in layer.items()}
                     for layer in mlp[part]] for part in ("bottom", "top")}
    params["tables"] = tables
    out = {"place": (tdist.get_rank(), ctx.dp_rank, ctx.rank),
           "flush": {}}
    for label, fields in DPP_STRATEGIES:
        cfg = dataclasses.replace(base, **fields)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        eng = pt.DLRMEngine(params, cfg, BATCH, ctx)
        for r in requests:
            eng.submit(r)
        scores, flush_ms = {}, []
        _reset_counts(pt, kmods)
        while eng.queue:
            t = time.perf_counter()
            scores.update(eng.flush())      # ends in .cpu(): synchronous
            flush_ms.append(1e3 * (time.perf_counter() - t))
        rec = dict(scores=np.array([scores[i] for i in sorted(scores)]),
                   flush_ms=flush_ms, counts=_counts(pt, kmods),
                   handles={k: b.handles for k, b in ctx._buffers.items()})
        if cuda:
            _sync(dev)
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        del eng
        if cuda:
            torch.cuda.empty_cache()
        out["flush"][label] = rec
    del params["tables"]
    tcfg = dataclasses.replace(base, rows_per_table=DPP_TRAIN_ROWS,
                               **DPP_TRAIN[1])
    inputs = tuple(t.to(dev) if torch.is_tensor(t) else
                   pt.JaggedBatch(t.indices.to(dev), t.lengths.to(dev))
                   for t in train["inputs"])
    out["train"] = _dp_flow(pt, kmods, train["mlp"], train.pop("tables"),
                            inputs, tcfg, ctx, True)
    del inputs
    gathered = [None] * DPP_WORLD
    tdist.all_gather_object(gathered, out)
    return gathered


def _dp_check_flush(label, sim, ranks, tag) -> dict:
    """(a)'s checks of one strategy: every rank's scores rank 0's and
    within PCTR_TOL of the simulated (2, 2) ranks' (bitwise logged); the
    strategy's launches per rank; each rank's symmetric buffers' handles
    its own data group's, in model-rank order."""
    vals = ranks[0]["flush"][label]["scores"]
    want = np.array([sim[k] for k in sorted(sim)])
    check(all(np.array_equal(r["flush"][label]["scores"], vals)
              for r in ranks), f"8dp{tag} {label}: every rank's scores")
    check(len(vals) == DPP_FLUSHES * BATCH and np.isfinite(vals).all()
          and bool(np.allclose(vals, want, **PCTR_TOL)),
          f"8dp{tag} {label}: {len(want)} finite pCTRs within PCTR_TOL of "
          f"the simulated (2, 2) ranks'")
    per = {k: v * DPP_FLUSHES for k, v in DPP_LAUNCHES[label].items()}
    for r in ranks:
        got = {k: r["flush"][label]["counts"].get(k, 0) for k in SOURCES}
        check(got == _launches(**per), f"8dp{tag} {label} global rank "
              f"{r['place'][0]}: launches {per} in {DPP_FLUSHES} flushes "
              f"({got})")
    own = {r["place"][1:]: {k: h[r["place"][2]] for k, h in
                            r["flush"][label]["handles"].items()}
           for r in ranks}
    for r in ranks:
        d, m = r["place"][1:]
        for name, table in r["flush"][label]["handles"].items():
            check(list(table) == [own[(d, j)][name] for j in range(DPP_TP)]
                  and not set(table) & {own[(e, j)][name]
                                        for e in range(DPP_DP) if e != d
                                        for j in range(DPP_TP)},
                  f"8dp{tag} {label} global rank {r['place'][0]}: its "
                  f"'{name}' buffers' handles are its data group's ranks' "
                  f"only")
    err = float(np.abs(vals - want).max())
    med = [statistics.median(r["flush"][label]["flush_ms"]) for r in ranks]
    launches = {k: sum(r["flush"][label]["counts"].get(k, 0) for r in ranks)
                for k in SOURCES}
    log(f"  [(a){tag} {label}] scores "
        f"{'bitwise' if np.array_equal(vals, want) else 'not bitwise'} the "
        f"simulated (2, 2) ranks' (max_abs_err {err:.3e}); median flush "
        f"{[round(m, 3) for m in med]} ms per rank (host clock); peak "
        f"{[round(r['flush'][label].get('peak_bytes', 0) / 1e9, 2) for r in ranks]}"
        f" GB a rank; symmetric buffers "
        f"{sorted(ranks[0]['flush'][label]['handles'])} opened within each "
        f"data group; launches summed over ranks "
        f"{ {k: v for k, v in launches.items() if v} }")
    return dict(median_ms=med, err=err, launches=launches)


def _dp_check_groups(what, sums, tag) -> None:
    """Rank m of data group 0 and of data group 1 hold bitwise the same
    ``what`` (their bit sums equal)."""
    for m in range(DPP_TP):
        check(all(sums[d * DPP_TP + m] == sums[m] for d in range(DPP_DP)),
              f"8dp{tag} model rank {m}: {what} bitwise equal in every data "
              f"group")


def _dp_check(pt, sims, ranks, tag) -> dict:
    out = {"flush": {label: _dp_check_flush(label, sims["flush"][label],
                                            ranks, tag)
                     for label, _ in DPP_STRATEGIES}}
    check([r["place"] for r in ranks] == [
        (g, g // DPP_TP, g % DPP_TP) for g in range(DPP_WORLD)],
        f"8dp{tag}: global rank g is model rank g % {DPP_TP} of data group "
        f"g // {DPP_TP}")
    # (b) DLRM training
    st, t0 = sims["train"], ranks[0]["train"]
    rels = [abs(a - b) / abs(b) for a, b in zip(t0["losses"], st["losses"])]
    for r in ranks:
        check(r["train"]["losses"] == t0["losses"],
              f"8dp{tag} (b) global rank {r['place'][0]}: losses rank 0's")
        check(r["train"]["counts"] == dict(_launches(gather_pool_tbe=
                                                     DPP_TRAIN_STEPS),
                                           chunked=0),
              f"8dp{tag} (b): one TBE launch a forward, nothing else "
              f"({r['train']['counts']})")
    check(max(rels) <= DPP_LOSS_REL, f"8dp{tag} (b): losses within "
          f"{DPP_LOSS_REL} of the simulated (2, 2) flow's ({rels})")
    for s in range(DPP_TRAIN_STEPS):
        _dp_check_groups(f"(b) the shard and MLP leaves after step {s + 1}",
                         [r["train"]["sums"][s] for r in ranks], tag)
    log(f"  [(b){tag} DLRM training, {DPP_TRAIN[0]}, {DPP_TRAIN_ROWS} rows a "
        f"table] losses {t0['losses']} (simulated {st['losses']}, within "
        f"{[f'{v:.3e}' for v in rels]}); steps "
        f"{[[round(1e3 * v, 1) for v in r['train']['step_s']] for r in ranks]}"
        f" ms per rank (simulated "
        f"{[round(1e3 * v, 1) for v in st['step_s']]}); both data groups' "
        f"shards and MLP leaves bitwise equal after each step")
    out["train"] = dict(loss_rel=max(rels), step_s=[r["train"]["step_s"]
                                                    for r in ranks])
    out["launches"] = {k: sum(f["launches"][k] for f in out["flush"].values())
                       + sum(r["train"]["counts"].get(k, 0) for r in ranks)
                       for k in SOURCES}
    return out


def phase_dp_ranks(pt, kmods, backends=("gloo", "nccl")) -> dict:
    """Phase 8dp: 4 processes sharing the card over gloo as a (2, 2)
    mesh (and where there are 4 cards the NCCL leg, one rank a card):
    (a) DLRM flushes at CONFIG's width, (b) two DLRM training steps, each
    held to the simulated make_context(2, dp_size=2) ranks on the card
    (the LM's legs over this mesh are phase 8lr's)."""
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 8dp. (dp, tp) = ({DPP_DP}, {DPP_TP}) meshes with each rank a "
        f"process ({DPP_WORLD} processes sharing the card over gloo: a data "
        f"group's half of each batch over its model axis, the results "
        f"gathered over the data axis; torch.cuda.device_count() "
        f"{n_cards})")
    t_phase = time.perf_counter()
    sim_ctx = pt.make_context(DPP_TP, dp_size=DPP_DP)
    dev = torch.device(DEV)
    sims = {"flush": {}}
    # (a) CONFIG's tables and phase 3's requests' first DPP_FLUSHES batches
    cfg = pt.CONFIG
    params = pt.init_params(torch.Generator(device=DEV).manual_seed(3), cfg,
                            device=DEV)
    reqs = _requests(cfg, pt.CTRRequest, DPP_FLUSHES * BATCH, seed=5)
    for label, fields in DPP_STRATEGIES:
        eng = pt.DLRMEngine(params, dataclasses.replace(cfg, **fields),
                            batch_size=BATCH, ctx=sim_ctx, device=DEV)
        for r in reqs:
            eng.submit(r)
        sims["flush"][label] = eng.run_to_completion()
        del eng
    # (b) the training tables: CONFIG cut to DPP_TRAIN_ROWS rows a table
    tcfg = dataclasses.replace(cfg, rows_per_table=DPP_TRAIN_ROWS,
                               **DPP_TRAIN[1])
    tparams = pt.init_params(torch.Generator(device=DEV).manual_seed(4),
                             tcfg, device=DEV)
    inputs = _train_batches(pt, tcfg, 1, TRP_SEED, dev)[0]
    sims["train"] = _dp_flow(pt, kmods, tparams, tparams["tables"], inputs,
                             tcfg, sim_ctx, False)
    torch.cuda.empty_cache()
    log(f"  the simulated (2, 2) ranks on the card: "
        f"{time.perf_counter() - t_phase:.1f} s")
    mlp = {part: params[part] for part in ("bottom", "top")}
    tmlp = {part: tparams[part] for part in ("bottom", "top")}
    out = {}
    for backend in backends:
        if backend == "nccl" and n_cards < DPP_WORLD:
            log(f"  the NCCL leg needs {DPP_WORLD} cards (one process a "
                f"card): not run on this machine")
            continue
        t0 = time.perf_counter()
        ranks = pt.run_ranks(
            _dp_rank, DPP_WORLD, backend=backend, dp_size=DPP_DP,
            device=_rank_device() if backend == "gloo" else None,
            args=(cfg, params["tables"], mlp, _rank_requests(reqs),
                  {"tables": tparams["tables"], "inputs": inputs,
                   "mlp": tmlp}),
            timeout_s=DPP_TIMEOUT_S)
        log(f"  {backend}, {DPP_WORLD} processes as ({DPP_DP}, {DPP_TP}): "
            f"{time.perf_counter() - t0:.1f} s (spawn, shard copies, the "
            f"legs, the records' gather)")
        tag = "" if backend == "gloo" else " (nccl)"
        res = _dp_check(pt, sims, ranks, tag)
        if backend == "gloo":
            out.update(res)
        else:
            out["nccl"] = res
    del params, tparams, inputs, mlp, tmlp
    torch.cuda.empty_cache()
    out["secs"] = time.perf_counter() - t_phase
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 8dp: {out['secs']:.1f} s; rank processes alive after it: "
        f"{len(alive)}")
    check(not alive, "phase 8dp's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 8lr. the launchers over a (2, 2) mesh of processes
# ---------------------------------------------------------------------------

LR_PATH = "8lr the launchers, ranks as processes"
LR_DP, LR_TP = 2, 2            # the reference's debug mesh at 4 devices
LR_WORLD = LR_DP * LR_TP
# (a) granite-8b at its published widths, bf16, through the serve
# launcher's rank function: each rank draws its own share from the seed
# (everything but the other half of the vocabulary table), LR_SERVE_LAYERS
# layers over gloo on one card (5.5 GB a rank; the depth cut keeps the
# phase's time: the NCCL leg (c) serves all 36, 16.3 GB a rank).  4
# requests in 4 slots, a data group's 2 each: a long prompt in each
# group's first slot (over attn_chunk_threshold 8,192: the flash kernel on
# every rank) and a short one in its second; LR_NEW tokens each, the
# prefill's and 8 greedy steps.  A rank's cache: its group's 2 slots x
# LR_MAX_LEN / 2 positions
LR_SERVE_LAYERS = 12
LR_LONG = 8_448
LR_SHORT = 256
LR_PROMPTS = (LR_LONG, LR_SHORT, LR_LONG, LR_SHORT)     # by rid
LR_NEW = 9
LR_SLOTS = 4
LR_MAX_LEN = 8_464             # LR_LONG + LR_NEW up to a multiple of 16
LR_SEED = 23
# (b) through the train launcher's rank function: granite-8b's widths at
# LR_TRAIN_LAYERS layers, int8 moments, batches of 2 x 2,048 tokens
# (a data group's sample each): LR_TRAIN_STEPS steps with a checkpoint of
# the whole state each step, written by global rank 0; the run's Trainer
# going on in memory for LR_TRAIN_STEPS more from batch 0, and the same
# command again, which resumes from the checkpoint of the last step and
# runs LR_TRAIN_STEPS more from batch 0 as the reference's launcher does;
# and a tied head for 1 step, in f32.  The launcher places the state by
# the reference's specs (each rank its cut of every leaf, a layer's
# weights gathered whole while it runs).  Depth cut: a rank keeps a
# step's activations of its sample beside its state (~3.4 GB at 2
# layers)
LR_TRAIN_LAYERS = 2
LR_TRAIN = ["--arch", "granite-8b", "--batch", "2", "--seq", "2048",
            "--opt-state-dtype", "int8"]
LR_TRAIN_STEPS = 2
# (c) the NCCL leg, one process a card: (a) again, and the train launcher
# at all 36 layers, 3 steps of 4 x 2,048 tokens (phase 8t fits the whole
# state and a step on one card; a rank holds its share of it)
LR_NCCL_TRAIN = ["--arch", "granite-8b", "--batch", "4", "--seq", "2048",
                 "--steps", "3", "--opt-state-dtype", "int8"]
LR_TIMEOUT_S = 900.0
# (d) deepseek-v3-671b at its published widths over NCCL, one process a
# card (where there are 4 cards).  Serving through the serve launcher's
# rank function at LR_DS_SERVE_LAYERS layers (3 dense MLA layers, then 4
# MoE of 256 experts): a rank draws its share, 128 experts of each MoE
# layer, 54.68 GB.  The draw keeps one f32 temporary of a MoE leaf's whole
# layer (256 x 7,168 x 2,048: 15.0 GB) beside what the rank holds, so an
# 8th layer (66.37 GB held) would peak near 81.4 GB and leave under 6 GB
# of the card free.  4 requests of LR_DS_PROMPTS tokens (MLA's full
# branch) in 4 slots, LR_DS_NEW tokens each
LR_DS_SERVE_LAYERS = 7
LR_DS_PROMPTS = (512, 128, 512, 128)
LR_DS_NEW = 9
LR_DS_MAX_LEN = 528            # 512 + LR_DS_NEW up to a multiple of 16
LR_DS_SEED = 29
# decode against the forward on each data group's long request (the
# served tokens fed back, one sequence, under the group's model axis) at
# a capacity factor under which no assignment can drop: a rank's local
# expert may receive every token of both model ranks (2 x 128 / 8), so
# both paths compute the same function; the served run keeps the
# config's 1.25, as the launcher does
LR_DS_CAPACITY = 32.0
# training through the train launcher's rank function at
# LR_DS_TRAIN_LAYERS layers (3 dense, 1 MoE), int8 moments, under the
# reference's placement: a rank's state 29.23 GB by the specs (8.41 of
# parameters, 10.25 of gradients, 10.57 of moments); while the MoE layer
# runs it also holds its data-gathered 128 experts (11.3 GB) and, in the
# backward, their cotangent and each one's f32 sum in turn.  A data
# group's sample a step, 1 x 2,048 tokens: at 2 x 2,048 step 2's
# attention backward asked for 4 GiB more than the card had (its
# (2, 128, 2,048, 2,048) f32 scores).  A 2nd MoE layer would add 22.5 GB
# of state a rank: past the card
LR_DS_TRAIN_LAYERS = 4
LR_DS_TRAIN = ["--arch", "deepseek-v3-671b", "--batch", "2", "--seq",
               "2048", "--steps", "3", "--opt-state-dtype", "int8"]
# the launcher's step-1 loss against a no-grad lm_loss of the same drawn
# parameters in serving's layout on the same ranks: the same forward
# (each layer's weights whole), so bitwise but for a sum's order
LR_DS_LOSS_REL = 1e-5
# the placed backward's buckets held on the card: the same launcher run
# again for LR_DS_PIECE_STEPS steps with comm.GATHER_BUCKET_ELEMS at 1,
# each piece through its own collectives, its losses and gradient norms
# within LR_DS_LOSS_REL of the bucketed run's (each element's sum over
# two ranks is the same in any order, so bitwise but for an atomic add's
# order in the backward)
LR_DS_PIECE_STEPS = 2
# the losses after step 1 against the simulated Trainer's: where a data
# group takes half the batch its bf16 gradients round otherwise than the
# whole batch's (step 1's norm read 3.2e-6 apart on an H100), and AdamW's
# first step moves each weight by about lr whatever its gradient's size,
# so a weight whose gradient nears 0 may move the other way.  The sound
# runs read 5.4e-5 ((b) step 2) to 8.3e-5 ((c) steps 2 and 3 at 36
# layers) apart on H100s: held to 3x the largest.  A leaf left out of the
# data axis's sum may read as sound here (tools/later_loss_fault.py); the
# data groups' states, held bitwise equal, catch it
LR_LATER_REL = 2.5e-4


def _lr_serve_leg(pt, layers) -> dict:
    """(a)'s config at ``layers`` layers and the serve launcher's
    arguments."""
    cfg = dataclasses.replace(pt.LM_CONFIG, num_layers=layers)
    argv = ["--arch", "granite-8b", "--requests", str(len(LR_PROMPTS)),
            "--slots", str(LR_SLOTS), "--max-new", str(LR_NEW),
            "--max-len", str(LR_MAX_LEN), "--seed", str(LR_SEED)]
    return dict(cfg=cfg, args=pt.tserve.parser().parse_args(argv),
                prompts=LR_PROMPTS)


def _lr_requests(pt, leg) -> list:
    """A serve leg's requests, fresh: its prompts' lengths of uniform ids
    from the launcher's seed, the same on every rank and in the
    parent."""
    cfg, args = leg["cfg"], leg["args"]
    rng = np.random.default_rng(args.seed)
    return [pt.Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n
                                                    ).astype(np.int32),
                       max_new=args.max_new)
            for rid, n in enumerate(leg["prompts"])]


def _lr_train_legs(pt, tmp) -> list:
    """(b)'s legs: the launcher's 2 steps with a checkpoint a step and
    the resume, and a tied head's f32 step."""
    cfg = dataclasses.replace(pt.LMT_CONFIG, num_layers=LR_TRAIN_LAYERS)
    argv = LR_TRAIN + ["--steps", str(LR_TRAIN_STEPS), "--ckpt-every", "1",
                       "--ckpt-dir", os.path.join(tmp, "b")]
    tied = LR_TRAIN + ["--steps", "1"]
    return [dict(label="(b)", cfg=cfg, resume=True,
                 args=pt.tlaunch.parser().parse_args(argv)),
            dict(label="(b) tied", resume=False,
                 cfg=dataclasses.replace(cfg, tie_embeddings=True,
                                         dtype="float32"),
                 args=pt.tlaunch.parser().parse_args(tied))]


def _param_summary(pt, params) -> dict:
    """Per leaf: (shape, dtype, bytes, bit sums)."""
    return {p: (tuple(t.shape), str(t.dtype), t.numel() * t.element_size(),
                _bit_sums(t)) for p, t in pt.flatten_with_paths(params)}


def _lr_state_sums(pt, tr, cfg) -> dict:
    return {p: _bit_sums(t) for p, t in pt.flatten_with_paths(
        {"params": pt.tstep.rank_tensors(tr.state["params"], cfg),
         "opt": tr.state["opt"]})}


def _lr_state_bytes(pt, tr, cfg, ctx) -> dict:
    """This rank's parameter, gradient and moment bytes as held, and as
    the launcher's specs (launch/specs.state_spec_tree under the rank's
    context) give them: each leaf's whole shape (the state on the meta
    device) cut by its spec, a gradient at its moments' layout; and the
    paths of the leaves the data axis cuts."""
    specs = pt.tspecs.state_spec_tree(cfg, tr.tc, ctx)[1]
    flat = pt.tspecs.flatten_specs(specs)
    moments = pt.tspecs.moment_specs(specs["opt"]["m"])
    meta = pt.tstep.init_train_state(None, cfg, tr.tc, tp_size=ctx.world,
                                     device="meta")
    whole = pt.flatten_with_paths({"params": pt.tstep.rank_tensors(
        meta["params"], cfg), "opt": meta["opt"]})
    held = dict(pt.flatten_with_paths(
        {"params": pt.tstep.rank_tensors(tr.state["params"], cfg),
         "opt": tr.state["opt"]}))
    grads = dict(pt.flatten_with_paths(tr.step_fn.grads))

    def nbytes(spec, t):
        return math.prod(pt.cut_shape(spec, tuple(t.shape), ctx)) * \
            t.element_size()

    want = dict.fromkeys(("params", "grads", "opt"), 0)
    have = dict(want)
    for path, t in whole:
        part = "params" if path.startswith("params/") else "opt"
        want[part] += nbytes(flat[path], t)
        have[part] += held[path].numel() * held[path].element_size()
        if part == "params":
            q = path[len("params/"):]
            want["grads"] += nbytes(pt.tspecs.grad_spec(moments[q]), t)
            have["grads"] += grads[q].numel() * grads[q].element_size()
    return dict(held=have, spec=want, whole=sum(
        t.numel() * t.element_size() for _, t in whole),
        data_cut=sorted(p for p, sp in flat.items() if ("data",) in sp))


def _lr_train(pt, kmods, ctx, leg) -> dict:
    """One train leg on this rank through the train launcher's rank
    function, from launch counts at 0: the metrics, launches and peak
    memory.  With ``resume``: the checkpoints written, then the run's
    Trainer going on in memory for ``--steps`` more on the seeded batches
    from batch 0 (writing nothing), then the same command again, which
    resumes from the run's last checkpoint; the two states' bit sums and
    steps.  With a tied head: whether the head holds this rank's rows."""
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    cfg, args = leg["cfg"], leg["args"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(pt, kmods)
    tr = pt.tlaunch.train(ctx, cfg, args)
    rec = dict(metrics=[m for _, m in tr.metrics_log],
               counts=_counts(pt, kmods),
               state_bytes=_lr_state_bytes(pt, tr, cfg, ctx))
    if cuda:
        _sync(dev)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if leg["resume"]:
        # train() returns after the world's barrier on the last checkpoint
        rec["written"] = sorted(os.listdir(args.ckpt_dir))
        tr.ckpt_dir = None
        tr.data = pt.lm_batches(cfg, args.batch, args.seq, seed=tr.tc.seed)
        tr.run(args.steps)
        rec.update(continued_steps=[s for s, _ in
                                    tr.metrics_log[-args.steps:]],
                   sums=_lr_state_sums(pt, tr, cfg))
    if cfg.tie_embeddings:
        p = tr.state["params"]
        n = p["embed"].local.shape[1]
        rec["rows_in_head"] = bool(torch.equal(
            p["head"].T[ctx.rank * n:(ctx.rank + 1) * n], p["embed"].local[0]))
        rec["head_sums"] = _bit_sums(p["head"])
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if leg["resume"]:
        _reset_counts(pt, kmods)
        tr = pt.tlaunch.train(ctx, cfg, args)
        rec.update(resumed_steps=[s for s, _ in tr.metrics_log],
                   resumed=_lr_state_sums(pt, tr, cfg),
                   resume_counts=_counts(pt, kmods))
        del tr
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return rec


def _lr_rank(ctx, serve_leg, train_legs):
    """One rank of phase 8lr, a (2, 2) mesh: (a) the serve launcher's rank
    function on ``serve_leg``'s config and arguments, from launch counts
    at 0, with this process's batcher recording each head call's f32
    logits (by kind and index) and a summary of the parameters it is
    given; then each of ``train_legs`` (:func:`_lr_train`).  Every rank's
    records go to global rank 0, in global rank order."""
    import torch.distributed as tdist

    pt = port_namespace()
    kmods = _kernel_mods()
    dev, cuda = ctx.device, ctx.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"place": (tdist.get_rank(), ctx.dp_rank, ctx.rank)}
    heads, summary = [], {}
    batcher = pt.ContinuousBatcher
    real_head, real_init = batcher._head, batcher.__init__

    def head(self, hidden):
        lg = real_head(self, hidden)
        kind = "prefill" if hidden.shape[0] == 1 else "decode"
        heads.append((kind, len(self.timings[kind]), lg.float().cpu()))
        return lg

    def init(self, params, cfg, *a, **kw):
        summary.update(_param_summary(pt, params))
        real_init(self, params, cfg, *a, **kw)
    batcher._head, batcher.__init__ = head, init
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts(pt, kmods)
        served = pt.tserve.serve(ctx, serve_leg["cfg"], serve_leg["args"],
                                 reqs=_lr_requests(pt, serve_leg))
        out["serve"] = dict(served, heads=heads, params=summary,
                            counts=_counts(pt, kmods),
                            routes=dict(pt.fa.ROUTE_COUNTS))
    finally:
        batcher._head, batcher.__init__ = real_head, real_init
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["train"] = {leg["label"]: _lr_train(pt, kmods, ctx, leg)
                    for leg in train_legs}
    gathered = [None] * LR_WORLD
    tdist.all_gather_object(gathered, out)
    return gathered


def _lr_simulated_serve(pt, leg) -> dict:
    """(a) on the simulated (2, 2) ranks on the card: the whole model
    drawn from the seed, the same requests through ContinuousBatcher(
    ctx=make_context(2, dp_size=2)), each head call's f32 logits by kind
    and index; and each model rank's parameters cut from the whole ones
    by lm_params_for_rank, summarised."""
    cfg, args = leg["cfg"], leg["args"]
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    whole = pt.lm.init_params(torch.Generator(device=DEV).manual_seed(
        args.seed), cfg, tp_size=LR_TP, device=DEV)
    nbytes = _tree_bytes(pt, whole)
    cuts = []
    for m in range(LR_TP):
        rank = pt.ProcessContext(group=None, rank=m, world=LR_TP, device=dev)
        cut = pt.lm_params_for_rank(whole, cfg, rank)
        cuts.append(_param_summary(pt, cut))
        del cut
    heads = []
    with torch.no_grad():
        eng = pt.ContinuousBatcher(whole, cfg, num_slots=args.slots,
                                   max_len=pt.tserve.max_len(args),
                                   ctx=pt.make_context(LR_TP, dp_size=LR_DP),
                                   eos_id=-1, device=DEV)
        real = eng._head

        def head(hidden):
            lg = real(hidden)
            kind = "prefill" if hidden.shape[0] == 1 else "decode"
            heads.append((kind, len(eng.timings[kind]), lg.float().cpu()))
            return lg
        eng._head = head
        for req in _lr_requests(pt, leg):
            eng.submit(req)
        done = eng.run_to_completion()
        del eng._head
    out = dict(heads=heads, cuts=cuts, nbytes=nbytes,
               tokens={rid: r.generated for rid, r in done.items()},
               prefill=list(eng.timings["prefill"]),
               decode=list(eng.timings["decode"]))
    del eng, whole
    gc.collect()
    if DEV != "cpu":
        torch.cuda.empty_cache()
    log(f"  (a) the simulated (2, 2) ranks on the card: {cfg.name} at "
        f"{cfg.num_layers} layers, {nbytes / 1e9:.2f} GB of weights; "
        f"prefill ms {[(n, round(1e3 * t, 1)) for n, t in out['prefill']]},"
        f" median decode step "
        f"{1e3 * statistics.median(out['decode']):.3f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def _lr_simulated_train(pt, leg) -> list:
    """A train leg's Trainer under make_context(2, dp_size=2) on the card,
    with the launcher's TrainConfig and batches: its metrics."""
    cfg, args = leg["cfg"], leg["args"]
    tc = pt.tlaunch.train_config(args)
    t0 = time.perf_counter()
    tr = pt.Trainer(cfg, tc, pt.lm_batches(cfg, args.batch, args.seq,
                                           seed=tc.seed),
                    ctx=pt.make_context(LR_TP, dp_size=LR_DP), device=DEV)
    tr.run(args.steps)
    sim = [m for _, m in tr.metrics_log]
    del tr
    gc.collect()
    if DEV != "cpu":
        torch.cuda.empty_cache()
    log(f"  {leg['label']} the simulated (2, 2) Trainer: {cfg.name} at "
        f"{cfg.num_layers} layers{', tied head' if cfg.tie_embeddings else ''}"
        f", losses {[m['loss'] for m in sim]}, grad norms "
        f"{[m['grad_norm'] for m in sim]}, steps "
        f"{[round(m['step_time_s'], 3) for m in sim]} s; "
        f"{time.perf_counter() - t0:.1f} s")
    return sim


def _lr_check_serve(pt, leg, sim, ranks, tag) -> dict:
    """(a)'s checks: every rank's tokens rank 0's; each head call's logits
    within DECODE_REL_L2 of the simulated run's and its greedy tokens the
    same, up to the first near-tie (a call whose simulated top-two margin
    is under twice the two runs' largest logit difference: a swap of the
    top two moves both); the parameters each rank was given
    lm_params_for_rank's cut, leaf for leaf; per rank one TBE launch an
    embedding call and the flash kernel once a layer per long prefill,
    on wgmma."""
    cfg, args = leg["cfg"], leg["args"]
    V = cfg.vocab_size
    want = {(k, i): lg[:, :V] for k, i, lg in sim["heads"]}
    order = [(k, i) for k, i, _ in sim["heads"]]
    diff, rel, same = {}, {}, {}
    for out in ranks:
        for k, i, lg in out["serve"]["heads"]:
            s, g = want[(k, i)], lg[:, :V]
            diff[(k, i)] = max(diff.get((k, i), 0.0),
                               float((g - s).abs().max()))
            rel[(k, i)] = max(rel.get((k, i), 0.0),
                              float((g - s).norm() / s.norm()))
            same[(k, i)] = same.get((k, i), True) and bool(torch.equal(
                g.argmax(-1), s.argmax(-1)))
    margin = {}
    for key, s in want.items():
        top = s.topk(2, dim=-1).values
        margin[key] = float((top[:, 0] - top[:, 1]).min())
    first_flip = next((j for j, key in enumerate(order) if not same[key]),
                      len(order))
    D = max(diff[key] for key in order[:first_flip + 1])
    tie = next((j for j, key in enumerate(order) if margin[key] < 2 * D),
               None)
    upto = len(order) if tie is None else tie + 1
    held = order[:upto]
    tie_text = "none" if tie is None else \
        f"call {tie} ({order[tie][0]} {order[tie][1]}, margin " \
        f"{margin[order[tie]]:.4f})"
    n_long = sum(n > cfg.attn_chunk_threshold for n in LR_PROMPTS)
    n_flash = cfg.num_layers * n_long // LR_DP
    toks = ranks[0]["serve"]["tokens"]
    for g, out in enumerate(ranks):
        sv = out["serve"]
        n_steps = len(sv["ranks"][g]["decode"])
        n_adm = sum(k == "prefill" for k, _, _ in sv["heads"])
        check(sv["tokens"] == toks, f"8lr{tag} (a) global rank {g}: tokens "
                                    f"rank 0's")
        check(sv["counts"] == dict(_launches(
            flash_attention=n_flash, **{TBE_FLAT: n_adm + n_steps}),
            chunked=0) and sv["routes"] == {"wgmma": n_flash, "simt": 0},
            f"8lr{tag} (a) global rank {g}: one TBE launch per embedding "
            f"call ({n_adm} admissions, {n_steps} decode steps), "
            f"{cfg.num_layers} flash launches on wgmma per long prefill "
            f"({sv['counts']}, {sv['routes']})")
        cut = sim["cuts"][g % LR_TP]
        check(sv["params"] == cut, f"8lr{tag} (a) global rank {g}: its "
              f"parameters lm_params_for_rank's cut of the whole draw, leaf "
              f"for leaf (bytes and bits)")
        mine = sum(v[2] for v in sv["params"].values())
        check(mine < sim["nbytes"], f"8lr{tag} (a) global rank {g}: "
              f"{mine / 1e9:.3f} GB of parameters, under the whole model's "
              f"{sim['nbytes'] / 1e9:.3f}")
    check(max(rel[key] for key in held) < DECODE_REL_L2,
          f"8lr{tag} (a): logits within {DECODE_REL_L2} of the simulated "
          f"(2, 2) run's over the {len(held)} calls up to the near-tie "
          f"({max(rel[key] for key in held):.3e})")
    check(all(same[key] for key in order[:upto - (tie is not None)]),
          f"8lr{tag} (a): greedy tokens the simulated run's before the "
          f"near-tie ({tie_text})")
    if tie is None:
        check(toks == sim["tokens"], f"8lr{tag} (a): the served tokens the "
              f"simulated run's")
    timings = ranks[0]["serve"]["ranks"]
    prefill = [1e3 * statistics.median(t["prefill"]) for t in timings]
    decode = [1e3 * statistics.median(t["decode"]) for t in timings]
    peak = [t["peak_bytes"] / 1e9 for t in timings]
    counts = [out["serve"]["counts"] for out in ranks]
    own = [sum(v[2] for v in out["serve"]["params"].values()) / 1e9
           for out in ranks]
    log(f"  [(a){tag} {cfg.name}, {cfg.num_layers} layers, 4 requests of "
        f"{list(LR_PROMPTS)} tokens] logits within "
        f"{max(rel[key] for key in held):.3e} relative L2 of the simulated "
        f"(2, 2) run over {len(held)} of {len(order)} calls (largest "
        f"|difference| {D:.4f}); near-tie: {tie_text}; tokens "
        f"{'equal' if toks == sim['tokens'] else 'differ'}; per rank "
        f"{TBE_FLAT} {[c[TBE_FLAT] for c in counts]}, flash_attention "
        f"{[c['flash_attention'] for c in counts]}; median prefill ms per "
        f"rank {[round(v, 1) for v in prefill]}, median decode step ms "
        f"{[round(v, 3) for v in decode]} (simulated "
        f"{1e3 * statistics.median(sim['decode']):.3f}; host clock), peak "
        f"{[round(v, 2) for v in peak]} GB a rank, parameters "
        f"{[round(v, 3) for v in own]} GB a rank (the whole model "
        f"{sim['nbytes'] / 1e9:.3f})")
    return dict(rel=max(rel[key] for key in held), tie=tie_text,
                prefill_ms=prefill, decode_ms=decode, peak_gb=peak,
                launches={k: sum(c.get(k, 0) for c in counts)
                          for k in SOURCES})


def _lr_check_train(leg, sim, ranks, tag) -> dict:
    """A train leg's checks: every rank's metrics rank 0's; the losses
    within LMTP_LOSS_REL of the simulated Trainer's at step 1 and within
    LR_LATER_REL after, the step-1 gradient norm within LMTP_NORM_REL;
    one TBE launch a step, nothing else; each rank's parameter, gradient
    and moment bytes exactly the launcher's placement's arithmetic; with
    ``resume`` the checkpoint of each step written, and the same command
    again resumed at the last step, its steps and state bitwise those of
    the run's Trainer gone on in memory, on every rank, and that state's
    leaves the data axis does not cut bitwise equal in both data groups;
    a tied head holding the table its model axis holds."""
    label, cfg = leg["label"], leg["cfg"]
    recs = [out["train"][label] for out in ranks]
    m0 = recs[0]["metrics"]
    steps = len(sim)
    for g, rec in enumerate(recs):
        check([m["loss"] for m in rec["metrics"]] == [m["loss"] for m in m0]
              and [m["grad_norm"] for m in rec["metrics"]] ==
              [m["grad_norm"] for m in m0],
              f"8lr{tag} {label} global rank {g}: losses and norms rank 0's")
        check(rec["counts"] == dict(_launches(**{TBE_FLAT: steps}),
                                    chunked=0),
              f"8lr{tag} {label} global rank {g}: one TBE launch a step, "
              f"nothing else ({rec['counts']})")
    rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(m0, sim)]
    norm_rel = abs(m0[0]["grad_norm"] - sim[0]["grad_norm"]) / \
        sim[0]["grad_norm"]
    check(len(m0) == steps and all(np.isfinite(m["loss"]) for m in m0)
          and rels[0] <= LMTP_LOSS_REL and max(rels) <= LR_LATER_REL
          and norm_rel <= LMTP_NORM_REL,
          f"8lr{tag} {label}: losses within {LMTP_LOSS_REL} of the simulated"
          f" (2, 2) Trainer's at step 1 ({rels[0]:.3e}) and {LR_LATER_REL} "
          f"after ({[f'{v:.3e}' for v in rels]}), the step-1 gradient norm "
          f"within {LMTP_NORM_REL} ({norm_rel:.3e})")
    extra = ""
    if leg["resume"]:
        want = [f"step_{s:08d}" for s in range(1, steps + 1)]
        more = list(range(steps + 1, 2 * steps + 1))
        for g, rec in enumerate(recs):
            check(rec["written"] == want, f"8lr{tag} {label} global rank "
                  f"{g}: global rank 0 wrote a checkpoint each step "
                  f"({rec['written']})")
            check(rec["continued_steps"] == more
                  and rec["resumed_steps"] == more
                  and rec["resumed"] == rec["sums"],
                  f"8lr{tag} {label} global rank {g}: the same command "
                  f"again resumed at step {steps}, ran steps {more} from "
                  f"batch 0 and reached bitwise the state of the run's "
                  f"Trainer gone on in memory ({len(rec['sums'])} leaves)")
            check(rec["resume_counts"] == dict(_launches(
                **{TBE_FLAT: steps}), chunked=0),
                f"8lr{tag} {label} global rank {g}: the resumed run's "
                f"one TBE launch a step, nothing else "
                f"({rec['resume_counts']})")
        cut = set(recs[0]["state_bytes"]["data_cut"])
        for m in range(LR_TP):
            check(all({p: v for p, v in recs[d * LR_TP + m]["sums"].items()
                       if p not in cut} ==
                      {p: v for p, v in recs[m]["sums"].items()
                       if p not in cut} for d in range(LR_DP)),
                  f"8lr{tag} {label} model rank {m}: every leaf the data "
                  f"axis does not cut bitwise equal in every data group "
                  f"({len(cut)} leaves cut over it)")
        extra = (f"; the same command again, resumed from the checkpoint "
                 f"of step {steps}: every rank's {len(recs[0]['sums'])} "
                 f"state leaves after {steps} more steps bitwise the run's "
                 f"Trainer gone on in memory")
    for g, rec in enumerate(recs):
        b = rec["state_bytes"]
        check(b["held"] == b["spec"] and sum(b["held"].values()) > 0,
              f"8lr{tag} {label} global rank {g}: its parameter, gradient "
              f"and moment bytes the placement's arithmetic ({b['held']}; "
              f"the specs {b['spec']})")
    if cfg.tie_embeddings:
        for g, rec in enumerate(recs):
            check(rec["rows_in_head"] and rec["head_sums"] ==
                  recs[0]["head_sums"],
                  f"8lr{tag} {label} global rank {g}: the head holds this "
                  f"rank's updated rows, the same table on every rank")
        extra = "; every rank's head the table of its updated rows"
    step_s = [[m["step_time_s"] for m in rec["metrics"]] for rec in recs]
    peak = [rec.get("peak_bytes", 0) / 1e9 for rec in recs]
    held = [{k: round(v / 1e9, 3) for k, v in rec["state_bytes"][
        "held"].items()} for rec in recs]
    extra += (f"; state a rank (GB, parameters / gradients / moments) "
              f"{held}, the whole state "
              f"{recs[0]['state_bytes']['whole'] / 1e9:.3f} GB")
    log(f"  [{label}{tag} {cfg.name}, {cfg.num_layers} layers"
        f"{', tied head' if cfg.tie_embeddings else ''}, "
        f"{leg['args'].batch} x {leg['args'].seq} tokens] losses "
        f"{[m['loss'] for m in m0]} (simulated {[m['loss'] for m in sim]}, "
        f"within {[f'{v:.3e}' for v in rels]}), step-1 norm within "
        f"{norm_rel:.3e}; steps {[[round(v, 3) for v in s] for s in step_s]}"
        f" s per rank (host clock), peak {[round(v, 2) for v in peak]} GB a "
        f"rank{extra}")
    return dict(loss_rel=max(rels), norm_rel=norm_rel, step_s=step_s,
                peak_gb=peak, state_gb=held,
                tbe=sum(rec["counts"][TBE_FLAT] + rec.get(
                    "resume_counts", {}).get(TBE_FLAT, 0) for rec in recs))


def _peak_reader(dev):
    """Resets the peak memory statistic of ``dev`` and returns a reader of
    it in bytes (0 on the CPU)."""
    if dev.type != "cuda":
        return lambda: 0
    torch.cuda.reset_peak_memory_stats(dev)
    return lambda: torch.cuda.max_memory_allocated(dev)


def _lr_ds_legs(pt) -> tuple:
    """(d)'s serve and train legs: deepseek-v3-671b's config cut in depth
    and the launchers' arguments."""
    base = pt.deepseek_v3_671b.CONFIG
    argv = ["--arch", "deepseek-v3-671b",
            "--requests", str(len(LR_DS_PROMPTS)),
            "--slots", str(len(LR_DS_PROMPTS)), "--max-new", str(LR_DS_NEW),
            "--max-len", str(LR_DS_MAX_LEN), "--seed", str(LR_DS_SEED)]
    serve = dict(cfg=dataclasses.replace(base, num_layers=LR_DS_SERVE_LAYERS),
                 args=pt.tserve.parser().parse_args(argv),
                 prompts=LR_DS_PROMPTS, capacity=LR_DS_CAPACITY)
    train = dict(cfg=dataclasses.replace(base, num_layers=LR_DS_TRAIN_LAYERS),
                 args=pt.tlaunch.parser().parse_args(LR_DS_TRAIN))
    return serve, train


def _serving_param_bytes(pt, cfg, ctx) -> int:
    """A rank's serving parameter bytes by the arithmetic: each leaf's
    whole shape cut by the cuts every rank holds (its vocabulary rows and
    its experts: launch/specs.rank_cut_tree)."""
    meta = pt.lm.init_params(None, cfg, tp_size=ctx.world, device="meta")
    cuts = pt.tspecs.flatten_specs(pt.tspecs.rank_cut_tree(
        pt.tspecs.param_spec_tree(meta, cfg, ctx), cfg))
    return sum(math.prod(pt.cut_shape(cuts[p], tuple(t.shape), ctx))
               * t.element_size() for p, t in pt.flatten_with_paths(meta))


def _lr_ds_serve(pt, kmods, ctx, leg) -> dict:
    """(d)'s serving on this rank: its share drawn from the seed
    (lm.init_params(ctx=)), its bytes, the serve launcher's rank function
    on the requests from launch counts at 0 (moe_dropped recorded, each
    TBE launch shape held against its plain version: :func:`_hold_tbe`),
    then decode against the forward on its data group's long request with
    the served tokens fed back, under the group's model axis at ``leg``'s
    capacity factor (:func:`_moe_decode_vs_forward`), and both runs'
    logits and the forward's at the same positions."""
    dev, cfg, args = ctx.device, leg["cfg"], leg["args"]
    peak = _peak_reader(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = pt.lm.init_params(torch.Generator(device=dev).manual_seed(
            args.seed), cfg, ctx=ctx)
    _sync(dev)
    rec = dict(draw_s=time.perf_counter() - t0, draw_peak=peak(),
               held=sum(t.numel() * t.element_size() for _, t in
                        pt.flatten_with_paths(pt.tstep.rank_tensors(
                            params, cfg))),
               want=_serving_param_bytes(pt, cfg, ctx))
    drops = []
    reqs = _lr_requests(pt, leg)
    held, restore_tbe = _hold_tbe(pt)
    restore = _patched(pt.moe, "moe_ffn_ep_rank", lambda r: _recording(
        r, drops, lambda out: int(out[1]["moe_dropped"])))
    try:
        _reset_counts(pt, kmods)
        served = pt.tserve.serve(ctx, cfg, args, params=params, reqs=reqs)
        rec["counts"] = _counts(pt, kmods)
    finally:
        restore()
        restore_tbe()
    rec.update(tokens=served["tokens"], timings=served["ranks"], drops=drops,
               serve_peak=peak(), tbe_held=_held(held))
    long = 2 * ctx.dp_rank              # the group's first slot's request
    gen, mctx = served["tokens"][long], ctx.model_axis()
    seq = np.concatenate([reqs[long].prompt, np.asarray(gen[:-1], np.int32)])
    check_drops = []
    restore = _patched(pt.moe, "moe_ffn_ep_rank", lambda r: _recording(
        r, check_drops, lambda out: int(out[1]["moe_dropped"])))
    try:
        with torch.no_grad():
            dvf = _moe_decode_vs_forward(
                pt, params, dataclasses.replace(
                    cfg, moe_capacity_factor=leg["capacity"]),
                torch.as_tensor(seq[None], device=dev), ctx=mctx,
                steps=len(gen) - 1, max_len=args.max_len)
            hid = dvf.pop("hidden")
            rows = torch.cat([hid[run] for run in ("fwd", "aligned", "free")])
            logits = pt.lm.lm_logits(params, rows.to(dev), cfg, mctx)
    finally:
        restore()
    lg = logits.float()[:, :cfg.vocab_size].cpu().split(len(gen))
    rec["check"] = dict(dvf, rid=long, P=len(reqs[long].prompt), n=len(gen),
                        fwd=lg[0], aligned=lg[1], free=lg[2],
                        drops=check_drops)
    rec["peak_bytes"] = peak()
    del params, logits
    return rec


def _lr_ds_train(pt, kmods, ctx, leg) -> dict:
    """(d)'s training on this rank through the train launcher's rank
    function (the state placed by the launcher's specs), from launch
    counts at 0, each TBE launch shape held against its plain version:
    the metrics, each rank's bytes against the specs' and its peak; then
    a no-grad lm_loss of the same drawn parameters in serving's layout
    (lm.init_params(ctx=) from the TrainConfig's seed) on the first batch;
    then the same launcher run for LR_DS_PIECE_STEPS steps with each
    piece of the placed backward in a bucket of its own."""
    dev, cfg, args = ctx.device, leg["cfg"], leg["args"]
    peak = _peak_reader(dev)
    held, restore = _hold_tbe(pt)
    try:
        _reset_counts(pt, kmods)
        tr = pt.tlaunch.train(ctx, cfg, args)
        counts = _counts(pt, kmods)
    finally:
        restore()
    rec = dict(metrics=[m for _, m in tr.metrics_log], counts=counts,
               tbe_held=_held(held),
               state_bytes=_lr_state_bytes(pt, tr, cfg, ctx),
               peak_bytes=peak())
    tc = tr.tc
    del tr
    _free(dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(
        pt.lm_batches(cfg, args.batch, args.seq, seed=tc.seed)).items()}
    with torch.no_grad():
        params = pt.lm.init_params(torch.Generator(device=dev).manual_seed(
            tc.seed), cfg, ctx=ctx)
        _, ref = pt.tstep.lm_loss(params, batch, cfg, ctx, tc)
    rec["no_grad"] = {k: float(v) for k, v in ref.items()}
    del params, batch
    _free(dev)
    real = pt.comm.GATHER_BUCKET_ELEMS
    pt.comm.GATHER_BUCKET_ELEMS = 1
    try:
        t0 = time.perf_counter()
        tr = pt.tlaunch.train(ctx, cfg, type(args)(
            **dict(vars(args), steps=LR_DS_PIECE_STEPS)))
        rec["per_piece_s"] = time.perf_counter() - t0
    finally:
        pt.comm.GATHER_BUCKET_ELEMS = real
    rec["per_piece"] = [m for _, m in tr.metrics_log]
    del tr
    _free(dev)
    return rec


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _lr_ds_rank(ctx, serve_leg, train_leg):
    """One rank of (d), a (2, 2) mesh over NCCL: deepseek-v3-671b through
    the serve launcher's rank function (:func:`_lr_ds_serve`), then the
    train launcher's (:func:`_lr_ds_train`).  Every rank's records go to
    global rank 0, in global rank order."""
    import torch.distributed as tdist

    pt = port_namespace()
    kmods = _kernel_mods()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"place": (tdist.get_rank(), ctx.dp_rank, ctx.rank),
           "serve": _lr_ds_serve(pt, kmods, ctx, serve_leg)}
    _free(ctx.device)
    out["train"] = _lr_ds_train(pt, kmods, ctx, train_leg)
    gathered = [None] * LR_WORLD
    tdist.all_gather_object(gathered, out)
    return gathered


def _check_held(label, recs, hold=None) -> float:
    """Each rank's :func:`_hold_tbe` record (``rec["tbe_held"]``: the TBE
    wrapper's launch shapes on the path's own inputs): every shape within
    POOL_TOL of the plain version, and every launch that the rank counted
    among those held.  Logs each rank's shapes; returns the largest
    error."""
    hold = hold or check
    errs = []
    for r, rec in enumerate(recs):
        shapes = rec["tbe_held"]
        errs += [err for _, err, _, _ in shapes]
        log(f"  [{label}] rank {r}: TBE launch shapes held against the "
            f"plain version (allclose rtol={POOL_TOL['rtol']} "
            f"atol={POOL_TOL['atol']}): " + "; ".join(
                f"{key[0]} {key[2:]} x {n}: max_abs_err {err:.3e}"
                for key, err, _, n in shapes))
        hold(all(excess <= 0 for _, _, excess, _ in shapes),
             f"{label} rank {r}: every TBE launch shape within POOL_TOL of "
             f"its plain version")
        seen = sum(n for *_, n in shapes)
        hold(seen == rec["counts"][TBE_FLAT],
             f"{label} rank {r}: every TBE launch went through the held "
             f"wrapper ({seen} of {rec['counts'][TBE_FLAT]})")
    return max(errs, default=0.0)


def _lr_ds_check_serve(pt, leg, ranks, hold) -> dict:
    """(d)'s serving checks: every rank's tokens rank 0's; each rank's
    parameter bytes the arithmetic's, under the whole model's; per rank
    one TBE launch an embedding call, each shape within POOL_TOL of the
    plain version, and no flash launch (MLA's head dims 192/128: full
    attention at these lengths); decode against the forward on each data
    group's long request, on the forward's routing (the aligned run), at
    every call (the prefill's last row, then each decode step): the
    hidden row and the logits within DECODE_REL_L2, the greedy token the
    forward's argmax but at a near-tie of its top two logits (under twice
    the largest logit difference; named); the free-running decode's
    routing flips and relative L2 logged; nothing dropped at
    LR_DS_CAPACITY.  ``hold(ok, what)`` takes each check."""
    cfg = leg["cfg"]
    n_moe = cfg.num_layers - cfg.first_k_dense
    toks = ranks[0]["serve"]["tokens"]
    whole = pt.lm.init_params(None, cfg, tp_size=LR_TP, device="meta")
    whole_b = sum(t.numel() * t.element_size() for t in _leaves(whole))
    for g, out in enumerate(ranks):
        sv = out["serve"]
        # a rank prefills its own data group's admissions
        n_adm = len(leg["prompts"]) // LR_DP
        n_steps = len(sv["timings"][g]["decode"])
        hold(sv["tokens"] == toks, f"8lr (nccl) (d) global rank {g}: tokens "
                                    f"rank 0's")
        hold(sv["held"] == sv["want"] and sv["held"] < whole_b,
             f"8lr (nccl) (d) global rank {g}: {sv['held']:,} B of "
             f"parameters, the arithmetic's {sv['want']:,} (the whole "
             f"model {whole_b:,})")
        hold(sv["counts"] == dict(_launches(**{TBE_FLAT: n_adm + n_steps}),
                                  chunked=0),
             f"8lr (nccl) (d) global rank {g}: one TBE launch per embedding "
             f"call ({n_adm} admissions, {n_steps} decode steps), no flash "
             f"launch, no chunked_attention call ({sv['counts']})")
    tbe_err = _check_held("8lr (nccl) (d) serving",
                          [out["serve"] for out in ranks], hold)
    rels, named, agree, calls = [], [], 0, 0
    for d in range(LR_DP):
        c = ranks[d * LR_TP]["serve"]["check"]
        drops = sum(sum(ranks[d * LR_TP + m]["serve"]["check"]["drops"])
                    for m in range(LR_TP))
        hold(drops == 0, f"8lr (nccl) (d) data group {d}: nothing dropped "
                         f"at capacity {leg['capacity']} ({drops})")
        hold(c["n"] == LR_DS_NEW and len(c["calls"]["aligned"]) == c["n"],
             f"8lr (nccl) (d) request {c['rid']}: the aligned decode held at "
             f"all {c['n']} calls, the prefill's and {c['n'] - 1} decode "
             f"steps")
        for j, (a, b) in enumerate(zip(c["aligned"], c["fwd"])):
            calls += 1
            h_rel = c["calls"]["aligned"][j]
            rel = float((a - b).norm() / b.norm())
            rels.append(max(rel, h_rel))
            hold(h_rel < DECODE_REL_L2 and rel < DECODE_REL_L2,
                 f"8lr (nccl) (d) request {c['rid']} call {j}: on the "
                 f"forward's routing, the hidden row ({h_rel:.3e}) and the "
                 f"logits ({rel:.3e}) within {DECODE_REL_L2} of the "
                 f"forward's")
            top = b.topk(2).values
            if float(top[0] - top[1]) < 2 * float((a - b).abs().max()):
                named.append((c["rid"], j, "near-tie"))
            else:
                hold(int(a.argmax()) == int(b.argmax()),
                     f"8lr (nccl) (d) request {c['rid']} call {j}: the "
                     f"greedy token the forward's argmax")
            # the served run's token (its admission at the config's
            # capacity, which drops) against the dropless forward's
            agree += toks[c["rid"]][j] == int(b.argmax())
        free = [float((a - b).norm() / b.norm())
                for a, b in zip(c["free"], c["fwd"])]
        log(f"  [(d) (nccl) request {c['rid']}, {c['P']} tokens] decode "
            f"against the forward at capacity {leg['capacity']}: logits' "
            f"relative L2 per call on the forward's routing "
            f"{' '.join(f'{v:.2e}' for v in rels[-c['n']:])}, free-running "
            f"{' '.join(f'{v:.2e}' for v in free)}; the free run's MoE "
            f"layers whose expert set differs per decode step "
            f"{c['step_flips']}, tokens per MoE layer {c['flips']}")
    timings = ranks[0]["serve"]["timings"]
    sv = [out["serve"] for out in ranks]
    dropped = [sum(s["drops"]) for s in sv]
    log(f"  [(d) (nccl) {cfg.name}, {cfg.num_layers} layers "
        f"({n_moe} MoE), 4 requests of {list(leg['prompts'])} tokens] tokens "
        f"{toks}; decode against the forward on its routing held at all "
        f"{calls} calls, max relative L2 {max(rels):.3e}; near-ties named "
        f"{named}; the served tokens the dropless forward's argmax at "
        f"{agree} of {calls} calls; served moe_dropped a "
        f"rank {dropped} (capacity {cfg.moe_capacity_factor}); parameters "
        f"{[round(s['held'] / 1e9, 3) for s in sv]} GB a rank (the whole "
        f"model {whole_b / 1e9:.3f}); drawn in "
        f"{[round(s['draw_s'], 1) for s in sv]} s (peak "
        f"{[round(s['draw_peak'] / 1e9, 2) for s in sv]} GB); median prefill "
        f"ms {[round(1e3 * statistics.median(t['prefill']), 1) for t in timings]}"
        f", median decode step ms "
        f"{[round(1e3 * statistics.median(t['decode']), 3) for t in timings]}"
        f" (host clock); peak serving "
        f"{[round(s['serve_peak'] / 1e9, 2) for s in sv]} GB, with the check "
        f"{[round(s['peak_bytes'] / 1e9, 2) for s in sv]} GB a rank; per "
        f"rank {TBE_FLAT} {[s['counts'][TBE_FLAT] for s in sv]} (max_abs_err "
        f"{tbe_err:.3e} against the plain version), chunked_attention "
        f"{[s['counts']['chunked'] for s in sv]}")
    return dict(rel=max(rels), calls=calls, named=named, tbe_err=tbe_err,
                prefill_ms=[1e3 * statistics.median(t["prefill"])
                            for t in timings],
                decode_ms=[1e3 * statistics.median(t["decode"])
                           for t in timings],
                param_gb=[s["held"] / 1e9 for s in sv],
                peak_gb=[s["peak_bytes"] / 1e9 for s in sv])


def _lr_ds_check_train(pt, leg, ranks, hold) -> dict:
    """(d)'s training checks: every rank's metrics rank 0's, finite; two
    TBE launches a step (the embedding of the tokens and, for the MTP
    head, of the labels), each shape within POOL_TOL of the plain
    version, nothing else; step 1's loss, ce and mtp_ce within
    LR_DS_LOSS_REL of the no-grad lm_loss (bitwise logged); each rank's
    parameter, gradient and moment bytes the specs' arithmetic; the run
    with a bucket a piece: its losses and gradient norms within
    LR_DS_LOSS_REL of the bucketed run's (bitwise logged).  ``hold(ok,
    what)`` takes each check."""
    cfg, args = leg["cfg"], leg["args"]
    recs = [out["train"] for out in ranks]
    m0 = recs[0]["metrics"]
    per_step = 1 + bool(cfg.mtp_depth)
    keys = ("loss", "grad_norm")
    for g, rec in enumerate(recs):
        hold([[m[k] for k in keys] for m in rec["metrics"]] ==
             [[m[k] for k in keys] for m in m0]
             and [[m[k] for k in keys] for m in rec["per_piece"]] ==
             [[m[k] for k in keys] for m in recs[0]["per_piece"]]
             and len(m0) == args.steps
             and all(np.isfinite(m["loss"]) for m in m0),
             f"8lr (nccl) (d) train global rank {g}: {args.steps} finite "
             f"losses and norms, rank 0's, and the per-piece run's rank 0's")
        hold(rec["counts"] == dict(_launches(**{TBE_FLAT: per_step
                                                * args.steps}), chunked=0),
             f"8lr (nccl) (d) train global rank {g}: {per_step} TBE launches "
             f"a step (the forward's embedding and the MTP head's), nothing "
             f"else ({rec['counts']})")
        b = rec["state_bytes"]
        hold(b["held"] == b["spec"] and sum(b["held"].values()) > 0,
             f"8lr (nccl) (d) train global rank {g}: its parameter, "
             f"gradient and moment bytes the placement's arithmetic "
             f"({b['held']}; the specs {b['spec']})")
    tbe_err = _check_held("8lr (nccl) (d) train", recs, hold)
    ref = recs[0]["no_grad"]
    rel = {k: abs(m0[0][k] - ref[k]) / abs(ref[k])
           for k in ("loss", "ce", "mtp_ce")}
    bitwise = all(m0[0][k] == ref[k] for k in rel)
    for g, rec in enumerate(recs):
        hold(rec["no_grad"] == ref, f"8lr (nccl) (d) train global rank {g}:"
                                    f" the no-grad loss rank 0's")
    hold(all(v <= LR_DS_LOSS_REL for v in rel.values()),
         f"8lr (nccl) (d) train: step 1's loss, ce and mtp_ce within "
         f"{LR_DS_LOSS_REL} of a no-grad lm_loss of the same drawn "
         f"parameters in serving's layout ({rel})")
    pp = recs[0]["per_piece"]
    pp_rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in keys}
              for a, b in zip(pp, m0)]
    pp_bitwise = all(a[k] == b[k] for a, b in zip(pp, m0) for k in keys)
    hold(len(pp) == LR_DS_PIECE_STEPS
         and all(v <= LR_DS_LOSS_REL for r in pp_rel for v in r.values()),
         f"8lr (nccl) (d) train: with a bucket a piece, {LR_DS_PIECE_STEPS} "
         f"steps' losses and gradient norms within {LR_DS_LOSS_REL} of the "
         f"bucketed run's ({pp_rel})")
    step_s = [[m["step_time_s"] for m in rec["metrics"]] for rec in recs]
    peak = [rec["peak_bytes"] / 1e9 for rec in recs]
    state = [{k: round(v / 1e9, 3) for k, v in rec["state_bytes"][
        "held"].items()} for rec in recs]
    log(f"  [(d) (nccl) train {cfg.name}, {cfg.num_layers} layers "
        f"({cfg.num_layers - cfg.first_k_dense} MoE), {args.batch} x "
        f"{args.seq} tokens a step ({args.batch // LR_DP} a data group), "
        f"int8 moments, placed] losses "
        f"{[m['loss'] for m in m0]}, ce {[m['ce'] for m in m0]}, mtp_ce "
        f"{[m['mtp_ce'] for m in m0]}, grad norms "
        f"{[m['grad_norm'] for m in m0]}, moe_dropped "
        f"{[m.get('moe_dropped') for m in m0]}; step 1 "
        f"{'bitwise' if bitwise else 'not bitwise'} the no-grad lm_loss "
        f"({', '.join(f'{k} {v:.3e}' for k, v in rel.items())}); a bucket a "
        f"piece: losses {[m['loss'] for m in pp]}, grad norms "
        f"{[m['grad_norm'] for m in pp]}, "
        f"{'bitwise' if pp_bitwise else 'not bitwise'} the bucketed run's "
        f"({pp_rel}; {max(r['per_piece_s'] for r in recs):.1f} s); steps "
        f"{[[round(v, 3) for v in s] for s in step_s]} s per rank (host "
        f"clock), peak {[round(v, 2) for v in peak]} GB a rank; state a "
        f"rank (GB, parameters / gradients / moments) {state}, the whole "
        f"state {recs[0]['state_bytes']['whole'] / 1e9:.3f} GB; "
        f"{len(recs[0]['state_bytes']['data_cut'])} leaves cut over the "
        f"data axis; TBE max_abs_err {tbe_err:.3e} against the plain "
        f"version")
    return dict(losses=[m["loss"] for m in m0], rel=max(rel.values()),
                bitwise=bitwise, per_piece_bitwise=pp_bitwise,
                tbe_err=tbe_err, step_s=step_s, peak_gb=peak,
                state_gb=state)


def _lr_run(pt, backend, serve_leg, train_legs, fn=None) -> list:
    t0 = time.perf_counter()
    ranks = pt.run_ranks(
        fn or _lr_rank, LR_WORLD, backend=backend, dp_size=LR_DP,
        device=_rank_device() if backend == "gloo" else None,
        args=(serve_leg, train_legs), timeout_s=LR_TIMEOUT_S)
    check([r["place"] for r in ranks] == [
        (g, g // LR_TP, g % LR_TP) for g in range(LR_WORLD)],
        f"8lr ({backend}): global rank g is model rank g % {LR_TP} of data "
        f"group g // {LR_TP}")
    log(f"  {backend}, {LR_WORLD} processes as ({LR_DP}, {LR_TP})"
        f"{' sharing the card' if backend == 'gloo' else ', one a card'}: "
        f"{time.perf_counter() - t0:.1f} s (spawn, each rank's draws, "
        f"serving, the train legs, the records' gather)")
    return ranks


def phase_launch_ranks(pt, kmods, backends=("gloo", "nccl")) -> dict:
    """Phase 8lr: the serve and train launchers' rank functions on 4
    processes as the reference's debug mesh (2, 2), sharing the card over
    gloo (and where there are 4 cards over NCCL, one a card): (a)
    granite-8b served at LR_SERVE_LAYERS layers, each rank drawing only
    its share; (b) training at 2 layers with a checkpoint, its resume and
    a tied head; each held to the simulated make_context(2, dp_size=2)
    on the card; on 4 cards (c) both at granite-8b's full depth, held
    the same way, and (d) deepseek-v3-671b served at LR_DS_SERVE_LAYERS
    layers (decode against the forward) and trained under the placement
    at LR_DS_TRAIN_LAYERS (step 1 against a no-grad loss, each rank's
    state bytes the specs').  ``backends`` picks the legs: "gloo" (a),
    (b); "nccl" (c) and (d); "ds" (d) alone (``tools/rank_phases.py
    8lr-nccl`` and ``8lr-ds``)."""
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    log(f"== 8lr. the launchers over ({LR_DP}, {LR_TP}) meshes of processes"
        f" ({LR_WORLD} processes sharing the card over gloo: the serve and "
        f"train launchers' rank functions, each rank drawing its own share;"
        f" torch.cuda.device_count() {n_cards})")
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() if DEV != "cpu" else 0
    log(f"  the parent holds {held / 1e9:.3f} GB on the card while the ranks"
        f" run (no weights)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_8lr_")
    out = {}
    try:
        if "gloo" in backends:
            serve_leg = _lr_serve_leg(pt, LR_SERVE_LAYERS)
            legs = _lr_train_legs(pt, tmp)
            ranks = _lr_run(pt, "gloo", serve_leg, legs)
            sim = _lr_simulated_serve(pt, serve_leg)
            out["serve"] = _lr_check_serve(pt, serve_leg, sim, ranks, "")
            out["train"] = {leg["label"]: _lr_check_train(
                leg, _lr_simulated_train(pt, leg), ranks, "")
                for leg in legs}
            out["launches"] = dict(out["serve"]["launches"])
            out["launches"][TBE_FLAT] += sum(t["tbe"]
                                             for t in out["train"].values())
            del ranks, sim
        nccl = {"nccl", "ds"} & set(backends)
        if nccl and n_cards >= LR_WORLD:
            nc = {}
            if "nccl" in backends:
                serve_leg = _lr_serve_leg(pt, pt.LM_CONFIG.num_layers)
                cfg = pt.LMT_CONFIG
                leg = dict(label="(c)", cfg=cfg, resume=False,
                           args=pt.tlaunch.parser().parse_args(LR_NCCL_TRAIN))
                ranks = _lr_run(pt, "nccl", serve_leg, [leg])
                sim = _lr_simulated_serve(pt, serve_leg)
                nc["serve"] = _lr_check_serve(pt, serve_leg, sim, ranks,
                                              " (nccl)")
                nc["train"] = _lr_check_train(
                    leg, _lr_simulated_train(pt, leg), ranks, " (nccl)")
                del ranks, sim
            ds_serve, ds_train = _lr_ds_legs(pt)
            with _expandable_segments():
                ranks = _lr_run(pt, "nccl", ds_serve, ds_train,
                                fn=_lr_ds_rank)
            # every reading of (d) is logged before a failed check raises
            fails = []

            def hold(ok, what):
                if not ok:
                    fails.append(what)
                    log(f"  check failed: {what}")
            nc["ds"] = {"serve": _lr_ds_check_serve(pt, ds_serve, ranks, hold),
                        "train": _lr_ds_check_train(pt, ds_train, ranks, hold)}
            check(not fails, f"8lr (nccl) (d): {len(fails)} checks failed")
            out["nccl"] = nc
            del ranks
        elif nccl:
            log(f"  (c), (d) the NCCL legs need {LR_WORLD} cards (one process "
                f"a card): not run on this machine")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if DEV != "cpu":
        torch.cuda.empty_cache()
    out["secs"] = time.perf_counter() - t_phase
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 8lr: {out['secs']:.1f} s; rank processes alive after it: "
        f"{len(alive)}")
    check(not alive, "phase 8lr's rank processes all ended")
    return out


# ---------------------------------------------------------------------------
# 8d. MLA serving
# ---------------------------------------------------------------------------

# deepseek-v3-671b at its published widths, cut to 5 layers (3 dense MLA
# layers, then 2 MoE): 26,618,298,368 parameters (param_count) and the MTP
# head, 54.6 GB in bf16; a 6th layer would not fit on an 80 GB card
DS_LAYERS = 5
DS_PARAMS = 26_618_298_368
DS_MAX_NEW = 16
# 2 slots x 16,416 positions x 5 layers x (512 + 64) latent values x 2 B
DS_CACHE_BYTES = 189_112_320
DS_CHECK_ROWS = 512          # the last query rows held to the f32 softmax
# the chunked route (f32 scores, online softmax) against one explicit f32
# softmax over all keys: both round the same f32 context to bf16 before
# w_o, and their f32 sums differ in order only, so the bf16 output rows,
# its GEMM and that rounding set the bound (a few 1e-4).  With random
# weights over 16K keys the attention is nearly uniform, so a fault moves
# the output little: the bound sits under the reading of a planted fault,
# the softmax scaled by hd_v ** -0.5 (128) in place of hd ** -0.5 (192),
# and the phase checks that this fault lands above it
MLA_REL_L2 = 2e-3
MLA_FAULT_SCALE = 128 ** -0.5


def _check_mla_layer(pt, params, cfg, prompt) -> dict:
    """Layer 0's mla_attention on the real hidden rows of ``prompt`` (over
    the threshold): one chunked_attention call and no flash launch, and
    its last DS_CHECK_ROWS output rows against an explicit f32 softmax
    over all keys from the same projections, through the same w_o."""
    lm, mla, layers, fa = pt.lm, pt.mla, pt.layers, pt.fa
    S, R = len(prompt), DS_CHECK_ROWS
    m, H = cfg.mla, cfg.num_heads
    tokens = torch.as_tensor(prompt[None], device=DEV)
    pos = torch.arange(S, device=DEV)[None]
    pl = lm.layer(params["dense_blocks"], 0)
    p = pl["attn"]
    x = lm._norm(lm.embed_tokens(params, tokens, cfg), pl["ln1"], cfg)
    fa.reset_launch_counts()
    layers.reset_call_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = mla.mla_attention(p, x, pos, cfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    calls = (fa.LAUNCH_COUNTS["flash_attention"],
             layers.CALL_COUNTS["chunked_attention"])
    got = out[0, -R:].float()
    del out
    q_nope, q_rope = mla._project_q(p, x, cfg, pos)
    c_kv, k_rope = mla.latent_kv(p, x, cfg, pos)
    k_nope = torch.einsum("bsk,khn->bshn", c_kv, p["w_uk"])
    v = torch.einsum("bsk,khv->bshv", c_kv, p["w_uv"])
    s = torch.einsum("bqhn,bkhn->bhqk", q_nope[:, -R:].float(),
                     k_nope.float())
    s += torch.einsum("bqhr,bkr->bhqk", q_rope[:, -R:].float(),
                      k_rope.float())
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s *= scale
    qpos = torch.arange(S - R, S, device=DEV)
    s.masked_fill_(pos[0][None, :] > qpos[:, None], -1e30)

    def softmax_rows(s):
        o = torch.einsum("bhqk,bkhv->bqhv", torch.softmax(s, dim=-1),
                         v.float())
        return (o.to(x.dtype).reshape(1, R, H * m.v_head_dim)
                @ p["w_o"])[0].float()

    want = softmax_rows(s)
    s *= MLA_FAULT_SCALE / scale
    fault = softmax_rows(s)
    del s
    rel = float((got - want).norm() / want.norm())
    err = float((got - want).abs().max())
    rel_fault = float((fault - want).norm() / want.norm())
    log(f"  layer 0 mla_attention on {S} real hidden rows: {ms:.1f} ms (host"
        f" clock, one call); flash launches {calls[0]}, chunked_attention "
        f"calls {calls[1]}; its last {R} rows against an explicit f32 "
        f"softmax over all keys: relative L2 {rel:.3e} (bound {MLA_REL_L2}),"
        f" max_abs_err {err:.3e}; a planted fault (scale "
        f"{MLA_FAULT_SCALE:.5f} for {scale:.5f}) reads {rel_fault:.3e}")
    check(calls == (0, 1), "the long MLA attention took chunked_attention "
                           "once and launched no flash kernel")
    check(bool(torch.isfinite(got).all()), "mla_attention: finite rows")
    check(rel < MLA_REL_L2, "chunked MLA attention within its bound of the "
                            "f32 softmax")
    check(rel_fault > MLA_REL_L2, "the planted scale fault lands above the "
                                  "bound")
    return dict(rel=rel, err=err, ms=ms, rel_fault=rel_fault)


def phase_mla(pt, kmods) -> dict:
    cfg = pt.MLA_CONFIG
    m = cfg.mla
    log(f"== 8d. MLA serving: {cfg.name} at full width, {cfg.num_layers} "
        f"layers ({cfg.first_k_dense} dense, then MoE), d {cfg.d_model}, "
        f"{cfg.num_heads} heads, q_lora {m.q_lora_rank}, kv_lora "
        f"{m.kv_lora_rank}, nope {m.qk_nope_head_dim} + rope "
        f"{m.qk_rope_head_dim}, v {m.v_head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token} + "
        f"{cfg.num_shared_experts} shared of {cfg.moe_d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; ContinuousBatcher({MOE_SLOTS} "
        f"slots x {LM_MAX_LEN} positions)")
    init = _init_moe_lm(pt, cfg, 17, DS_PARAMS)
    params = init.pop("params")
    reqs = _lm_requests(pt, cfg, 4, DS_MAX_NEW)
    # (a) the chunked route on layer 0's real rows; (b) the first MoE
    # layer against the dense f32 scan over all its experts
    attn = _check_mla_layer(pt, params, cfg, reqs[0].prompt)
    layer = _check_moe_layer(pt, params, cfg, reqs[0].prompt)
    # (c) serving; (e) the latent cache's bytes
    checks_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out = _serve_moe(pt, params, cfg, reqs, kmods)
    gqa = 2 * 2 * MOE_SLOTS * LM_MAX_LEN * cfg.num_layers * cfg.num_heads \
        * cfg.head_dim
    log(f"  latent cache: {out['cache_bytes']:,} B (want {DS_CACHE_BYTES:,};"
        f" a bf16 GQA K/V cache of {cfg.num_heads} heads of {cfg.head_dim} "
        f"would take {gqa:,} B); peak device memory of checks (a)-(b) "
        f"{checks_peak_gb:.1f} GB, of serving {out['peak_gb']:.1f} GB")
    check(out["cache_bytes"] == DS_CACHE_BYTES, "the latent cache's bytes")
    # the sequence-sharded latent cache over 4 ranks, 16 decode steps
    ctx_leg = _mla_ctx_decode(pt, params, cfg, reqs[0].prompt, kmods)
    # (d) decode matches forward on a short prompt, on the forward's
    # routing; free-running with the flips
    short = torch.as_tensor(reqs[1].prompt[None], device=DEV)
    dvf = _moe_decode_vs_forward(pt, params, cfg, short)
    check(dvf["rel"] < DECODE_REL_L2, "decode_step after prefill matches "
                                      "forward on the forward's routing")
    del params
    torch.cuda.empty_cache()
    return dict(out, **dvf, **init, attn=attn, layer=layer,
                checks_peak_gb=checks_peak_gb, ctx=ctx_leg)


# ---------------------------------------------------------------------------
# 8h. hybrid serving and 8r. ssm serving
# ---------------------------------------------------------------------------

# hymba-1.5b and rwkv6-1.6b at CONFIG, nothing cut: every parameter of
# lm.init_params (param_count counts the attention, the FFNs and the
# embeddings, not the Mamba heads, the RWKV time mix or the norms)
HYMBA_PARAMS = 1_662_264_000
RWKV_PARAMS = 1_584_091_136
SSM_SLOTS = 4                # 4 x 16,416 positions, as phase 8
MAMBA_ROWS = 2048            # the real rows of the layer-0 Mamba check
RWKV_ROWS = 4096             # the real rows of the layer-0 RWKV check
# layer 0's mamba_forward (chunked doubling scan) against the recurrence
# stepped one token at a time on the forward's own projections, as
# mamba_decode_step computes it: the same f32 products in another order,
# so h_final (f32) is held to 1e-5 relative L2 and the output (rounded to
# bf16, gated, through out_proj) to 1e-2, a few bf16 roundings.  Then
# mamba_decode_step itself over the same rows (the conv state carried):
# its output is held to the same 1e-2.  Its h_final is logged only: its
# projections run over one row where the forward's run over 2,048, and
# the bf16 GEMM outputs round to neighbouring values now and then (on an
# H100, h_final read 3.169e-3 and the output 3.532e-3).
# The planted fault, the carried conv state rotated by one row each
# step, read ~1.
MAMBA_H_REL, MAMBA_Y_REL = 1e-5, 1e-2
# layer 0's rwkv_time_mix_chunked against rwkv_time_mix on 4,096 rows in
# f32: the reference's bound for the two forms (tests/test_models.py),
# largest absolute difference of the output and of the final state
RWKV_ABS = 1e-4
# decode against forward in f32, the same weights cast: f32 products in
# other orders (the flash kernel's online softmax or the full softmax
# against decode's, the doubling scan against the steps, the chunked time
# mix against the scan) carried through every layer.  On an H100
# hymba-1.5b read 2.663e-6 and 4.021e-6 (1,354 and 16,384 tokens); a
# handoff fault reads ~1 (phase 8h's planted conv-state fault), bf16
# noise ~1e-2
DECODE_F32_REL = 1e-4
# hymba-1.5b's bf16 decode leaves its bf16 forward by 2.2-2.4e-2 on an
# H100, over the DECODE_REL_L2 that holds granite, moonshot and rwkv6,
# where the f32 run reads 2.7e-6: the Mamba branch takes the drift in
# from layer 0 (4.4e-3, the attention branch 9e-5), since a dt that the
# one-row decode GEMMs round to a neighbouring bf16 value moves exp(dt A)
# by up to ~4 % at |A| = 16.  Phase 8h holds its f32 run and logs the bf16
# one with each branch's per-layer drift.


@contextlib.contextmanager
def _timed(laps: dict, name: str):
    """Host seconds of the block, into ``laps[name]``."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    laps[name] = time.perf_counter() - t0


def _log_laps(phase, laps) -> float:
    secs = sum(laps.values())
    log(f"  phase {phase}: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    return secs


def _init_state_lm(pt, cfg, seed, want) -> dict:
    """Random bf16 parameters of ``cfg`` from ``seed`` on the card, every
    one of ``want``.  Logs and returns them with their count, bytes and
    seconds."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = pt.lm.init_params(torch.Generator(device=DEV).manual_seed(seed),
                               cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"  init_params: {n_params:,} parameters (param_count "
        f"{cfg.param_count():,}), {nbytes / 1e9:.2f} GB on the card, in "
        f"{init_s:.1f} s")
    check(n_params == want, f"{want:,} parameters")
    check(all(t.dtype == torch.bfloat16 for t in leaves), "bf16 weights")
    return dict(params=params, n_params=n_params, nbytes=nbytes,
                init_s=init_s)


def _serve_states(pt, params, cfg, reqs, kmods) -> dict:
    """Serve ``reqs`` through ContinuousBatcher(SSM_SLOTS slots x
    LM_MAX_LEN positions) (:func:`_serve_lm`), then profile one decode
    step and the long prefill (the slots' cache as the loop left it; its
    rows and states are scratch now).  Returns :func:`_serve_lm`'s dict
    with the profiles and the cache's bytes, rows and states apart."""
    dec = pt.dec
    eng = pt.ContinuousBatcher(params, cfg, num_slots=SSM_SLOTS,
                               max_len=LM_MAX_LEN, eos_id=-1, device=DEV)
    entries = [(k, t) for st in dec.kv_stacks(eng.cache).values()
               for k, t in st.items()]
    state_bytes = sum(t.numel() * t.element_size() for k, t in entries
                      if k in dec.STATE_KEYS)
    row_bytes = sum(t.numel() * t.element_size() for k, t in entries
                    if k not in dec.STATE_KEYS)
    log(f"  cache: {row_bytes:,} B of positional rows, {state_bytes:,} B "
        f"of states ({sorted(k for k, _ in entries)})")
    out = _serve_lm(pt, eng, reqs, kmods, cfg, SSM_SLOTS)
    t0 = time.perf_counter()
    prof = _profile_served(pt, params, cfg, eng, out, reqs[0].prompt)
    prof_s = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    return dict(out, prof=prof, prof_s=prof_s, row_bytes=row_bytes,
                state_bytes=state_bytes)


def _decode_both(pt, params, cfg, reqs, *, hold=True) -> dict:
    """Decode against forward on the first short prompt and on the long
    one: the check on the states' handoff.  In the serving dtype (held to
    DECODE_REL_L2 with ``hold``, else logged) and in f32 on the same
    weights cast (held to DECODE_F32_REL).  Returns {"bf16": {length:
    rel}, "f32": {length: rel}}."""
    p32 = _cast(params, torch.float32)
    rel = {"bf16": {}, "f32": {}}
    for r in (reqs[1], reqs[0]):
        tokens = torch.as_tensor(r.prompt[None], device=DEV)
        rel["bf16"][len(r.prompt)] = _decode_vs_forward(pt, params, cfg,
                                                        tokens)
        rel["f32"][len(r.prompt)] = _decode_vs_forward(
            pt, p32, cfg, tokens, bound=DECODE_F32_REL, what="in f32")
    del p32
    torch.cuda.empty_cache()
    check(max(rel["f32"].values()) < DECODE_F32_REL,
          "decode_step after prefill matches forward in f32")
    if hold:
        check(max(rel["bf16"].values()) < DECODE_REL_L2,
              "decode_step after prefill matches forward")
    return rel


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def _hybrid_drift(pt, params, cfg, tokens) -> dict:
    """Where hymba's bf16 decode leaves the forward: per layer, the last
    token's relative L2 between the forward and prefill + decode_step of
    the residual row after the layer, of the attention branch's output
    (before ``wo``) and of the Mamba branch's output.  Logs and returns
    the three lists."""
    lm, dec, ssm, layers = pt.lm, pt.dec, pt.ssm, pt.layers
    keys = ("residual", "attention", "mamba")
    fwd, dcd = ({k: [] for k in keys} for _ in range(2))

    def last(o):
        return o[0, -1].float().reshape(-1).clone()

    restore = [
        _patched(lm, "_block", lambda r: _recording(
            r, fwd["residual"], lambda o: last(o[0]))),
        _patched(layers, "attention", lambda r: _recording(
            r, fwd["attention"], last)),
        _patched(ssm, "mamba_forward", lambda r: _recording(
            r, fwd["mamba"], lambda o: last(o[0])))]
    try:
        lm.forward(params, tokens, cfg)
    finally:
        for undo in restore:
            undo()
    cache, _ = dec.prefill(params, tokens[:, :-1], cfg,
                           max_len=tokens.shape[1])
    restore = [
        _patched(dec, "_hybrid_decode_block", lambda r: _recording(
            r, dcd["residual"], last)),
        _patched(dec, "_decode_attn", lambda r: _recording(
            r, dcd["attention"], last)),
        _patched(ssm, "mamba_decode_step", lambda r: _recording(
            r, dcd["mamba"], lambda o: last(o[0])))]
    try:
        dec.decode_step(params, cache, tokens[:, -1], cfg)
    finally:
        for undo in restore:
            undo()
    del cache
    drift = {k: [float((d - f).norm() / f.norm())
                 for f, d in zip(fwd[k], dcd[k])] for k in keys}
    check(all(len(fwd[k]) == len(dcd[k]) == cfg.num_layers for k in keys),
          "one recorded row per layer, branch and path")
    for k in keys:
        log(f"  bf16 decode against forward ({tokens.shape[1]} tokens), "
            f"the last token's {k} per layer: "
            + " ".join(f"{v:.2e}" for v in drift[k]))
    return drift


def _hybrid_flash(pt, params, cfg, prompt) -> dict:
    """The flash wrapper against its plain version on the real q/k/v of
    layer 0 (global, window 1 << 30) and layer 1 (the sliding window) of
    ``prompt``: layer 1's input is layer 0's output."""
    lm = pt.lm
    S = len(prompt)
    tokens = torch.as_tensor(prompt[None], device=DEV)
    pos = torch.arange(S, device=DEV)[None]
    (_, _, windows), = lm.block_stacks(cfg)
    h = lm.embed_tokens(params, tokens, cfg)
    errs = {}
    for i in (0, 1):
        pl = lm.layer(params["blocks"], i)
        q, k, v = lm._gqa_qkv(pl["attn"], lm._norm(h, pl["ln1"], cfg), pos,
                              cfg)
        errs[windows[i]] = _flash_case(
            pt.fa, q, k, v, True, windows[i],
            f"hymba layer {i} of a {S}-token prompt (real q/k/v, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
            f"window {windows[i]})")
        del q, k, v
        if i == 0:
            h, _, _ = lm._block(pl, h, pos, cfg, window=windows[0])
    check(windows[0] == 1 << 30 and windows[1] == cfg.window,
          "layer 0 global, layer 1 windowed")
    return errs


def _check_mamba_layer(pt, params, cfg, prompt) -> dict:
    """Layer 0's mamba_forward on the real normed rows of MAMBA_ROWS
    tokens (a) against the recurrence stepped token by token on the
    forward's own projections (h_final within MAMBA_H_REL, the output
    within MAMBA_Y_REL) and (b) against a loop of mamba_decode_step over
    the same rows from zero states (h carried in f32, the conv state in
    bf16; the output within MAMBA_Y_REL); then (b) with a planted fault,
    the carried conv state rotated by one row each step, which must land
    above the bound."""
    lm, ssm = pt.lm, pt.ssm
    R = MAMBA_ROWS
    tokens = torch.as_tensor(prompt[None, :R], device=DEV)
    pl = lm.layer(params["blocks"], 0)
    p = pl["mamba"]
    x = lm._norm(lm.embed_tokens(params, tokens, cfg), pl["ln1"], cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, h = ssm.mamba_forward(p, x, cfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    di = cfg.ssm_expand * cfg.d_model

    def rel(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    # (a) the recurrence on the forward's projections, one step at a time
    xs, z = ssm._mamba_gates(p, x, cfg)
    xs, _ = ssm._causal_conv(xs, p["conv_w"], p["conv_b"])
    dt, Bc, Cc, A = ssm._mamba_ssm_inputs(p, xs, cfg)
    hs = torch.zeros((1, di, cfg.ssm_state), device=DEV)
    ys = []
    for t in range(R):
        a = torch.exp(dt[:, t, :, None].float() * A)
        bx = (dt * xs)[:, t, :, None].float() * Bc[:, t, None, :].float()
        hs = a * hs + bx
        ys.append(torch.einsum("bdn,bn->bd", hs, Cc[:, t].float()))
    ya = ((torch.stack(ys, dim=1) + xs * p["D"]).to(x.dtype) * F.silu(z)
          ) @ p["out_proj"]

    # (b) mamba_decode_step itself, with and without the planted fault
    def steps(fault):
        hd = torch.zeros((1, di, cfg.ssm_state), device=DEV)
        conv = torch.zeros((1, cfg.ssm_conv - 1, di), dtype=x.dtype,
                           device=DEV)
        outs = []
        for t in range(R):
            o, hd, conv = ssm.mamba_decode_step(p, x[:, t:t + 1], cfg, hd,
                                                conv)
            if fault:
                conv = conv.roll(1, dims=1)
            outs.append(o)
        return torch.cat(outs, dim=1), hd

    t0 = time.perf_counter()
    yb, hb = steps(False)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    yf, hf = steps(True)
    out = dict(rel_h=rel(hs, h), rel_y=rel(ya, y), dec_h=rel(hb, h),
               dec_y=rel(yb, y), fault_h=rel(hf, h), fault_y=rel(yf, y),
               ms=ms, step_ms=step_ms)
    log(f"  layer 0 mamba_forward on {R} real rows: {ms:.1f} ms (host "
        f"clock, one call, {-(-R // 128)} chunks); (a) against the "
        f"recurrence stepped on its projections: h_final relative L2 "
        f"{out['rel_h']:.3e} (bound {MAMBA_H_REL}), output "
        f"{out['rel_y']:.3e} (bound {MAMBA_Y_REL}); (b) against {R} "
        f"mamba_decode_step calls ({step_ms:.1f} ms): output "
        f"{out['dec_y']:.3e} (bound {MAMBA_Y_REL}), h_final "
        f"{out['dec_h']:.3e}; the planted fault (conv state rotated by one "
        f"row) reads {out['fault_y']:.3e} and {out['fault_h']:.3e}")
    check(h.dtype == torch.float32 and y.dtype == x.dtype
          and bool(torch.isfinite(h).all() and torch.isfinite(y).all()),
          "mamba_forward: finite, h_final f32")
    check(out["rel_h"] < MAMBA_H_REL and out["rel_y"] < MAMBA_Y_REL,
          "mamba_forward within its bounds of the stepped recurrence")
    check(out["dec_y"] < MAMBA_Y_REL,
          "mamba_forward within its bound of the decode steps")
    check(not out["fault_y"] <= MAMBA_Y_REL,
          "the planted conv-state fault lands above the bound")
    return out


def phase_hybrid(pt, kmods) -> dict:
    cfg = pt.HYBRID_CONFIG
    log(f"== 8h. hybrid serving: {cfg.name} at full width and depth "
        f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, window {cfg.window} "
        f"but layers {cfg.global_attn_layers}, Mamba d_inner "
        f"{cfg.ssm_expand * cfg.d_model} state {cfg.ssm_state} conv "
        f"{cfg.ssm_conv}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}), ContinuousBatcher({SSM_SLOTS} slots x {LM_MAX_LEN} "
        f"positions)")
    laps = {}
    with _timed(laps, "init"):
        init = _init_state_lm(pt, cfg, 19, HYMBA_PARAMS)
    params = init.pop("params")
    reqs = _lm_requests(pt, cfg, 4)
    # (a) the flash kernel at hd 64, group 5, global and windowed
    with _timed(laps, "(a) flash"):
        flash = _hybrid_flash(pt, params, cfg, reqs[0].prompt)
    # (b) the chunked scan against the decode steps
    with _timed(laps, "(b) mamba"):
        mamba = _check_mamba_layer(pt, params, cfg, reqs[0].prompt)
    checks_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    # (c) serving
    with _timed(laps, "(c) serving and profiles"):
        out = _serve_states(pt, params, cfg, reqs, kmods)
    # (d) decode against forward, short and long: held in f32; in bf16
    # logged, with each branch's per-layer drift (DECODE_F32_REL's note)
    with _timed(laps, "(d) decode vs forward"):
        rel = _decode_both(pt, params, cfg, reqs, hold=False)
        drift = _hybrid_drift(pt, params, cfg, torch.as_tensor(
            reqs[1].prompt[None], device=DEV))
    del params
    torch.cuda.empty_cache()
    log(f"  profiles: {out['prof_s']:.1f} s of (c)")
    secs = _log_laps("8h", laps)
    return dict(out, **init, flash=flash, mamba=mamba, rel=rel,
                drift=drift, err=max(flash.values()),
                checks_peak_gb=checks_peak_gb, secs=secs)


def _check_rwkv_layer(pt, params, cfg, prompt) -> dict:
    """Layer 0's rwkv_time_mix_chunked (chunk cfg.rwkv_chunk) against
    rwkv_time_mix (the per-step scan) on the real normed rows of
    RWKV_ROWS tokens, both in f32 (the layer's weights cast): output and
    final state within RWKV_ABS, finite; the chunks' largest -log P (the
    exponent exp(-log P) takes)."""
    lm, ssm = pt.lm, pt.ssm
    R = RWKV_ROWS
    tokens = torch.as_tensor(prompt[None, :R], device=DEV)
    pl = lm.layer(params["blocks"], 0)
    p = {k: v.float() for k, v in pl["rwkv"].items()}
    x = lm._norm(lm.embed_tokens(params, tokens, cfg), pl["ln1"],
                 cfg).float()
    C = cfg.rwkv_chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y1, (s1, _) = ssm.rwkv_time_mix_chunked(p, x, cfg, chunk=C)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0)
    y2, (s2, _) = ssm.rwkv_time_mix(p, x, cfg)
    torch.cuda.synchronize()
    scan_ms = 1e3 * (time.perf_counter() - t0) - chunk_ms
    w = ssm._rwkv_mix_inputs(p, x, ssm._shifted(x, None), cfg)[4]
    nlogp = float(-torch.log(w.float()).reshape(1, -1, C, w.shape[2],
                                                w.shape[3]).sum(2).max())
    out = dict(err_y=float((y1 - y2).abs().max()),
               err_s=float((s1 - s2).abs().max()), chunk_ms=chunk_ms,
               scan_ms=scan_ms, nlogp=nlogp,
               y_max=float(y2.abs().max()), s_max=float(s2.abs().max()))
    log(f"  layer 0 rwkv_time_mix_chunked (chunk {C}) on {R} real rows in "
        f"f32: {chunk_ms:.1f} ms; rwkv_time_mix (the scan): {scan_ms:.1f} "
        f"ms (host clock, one call each); max_abs_err output "
        f"{out['err_y']:.3e} (max |y| {out['y_max']:.3f}), final state "
        f"{out['err_s']:.3e} (max |S| {out['s_max']:.3f}), bound {RWKV_ABS}; "
        f"largest -log P over a chunk {nlogp:.3f}")
    check(all(bool(torch.isfinite(t).all()) for t in (y1, s1, y2, s2)),
          "rwkv time mix: finite outputs and states")
    check(out["err_y"] < RWKV_ABS and out["err_s"] < RWKV_ABS,
          "the chunked time mix within the reference's bound of the scan")
    return out


def phase_ssm(pt, kmods) -> dict:
    cfg = pt.SSM_CONFIG
    hs = cfg.rwkv_head_size
    log(f"== 8r. ssm serving: {cfg.name} at full width and depth "
        f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.d_model // hs} "
        f"heads of {hs}, no attention, "
        f"time-mix chunk {cfg.rwkv_chunk}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), ContinuousBatcher({SSM_SLOTS} "
        f"slots x {LM_MAX_LEN} positions)")
    laps = {}
    with _timed(laps, "init"):
        init = _init_state_lm(pt, cfg, 23, RWKV_PARAMS)
    params = init.pop("params")
    reqs = _lm_requests(pt, cfg, 4)
    # (a) the chunk-parallel time mix against the scan
    with _timed(laps, "(a) rwkv"):
        layer = _check_rwkv_layer(pt, params, cfg, reqs[0].prompt)
    checks_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    # (b) serving: no attention, no flash launch
    with _timed(laps, "(b) serving and profiles"):
        out = _serve_states(pt, params, cfg, reqs, kmods)
    # (c) decode against forward, short and long
    with _timed(laps, "(c) decode vs forward"):
        rel = _decode_both(pt, params, cfg, reqs)
    del params
    torch.cuda.empty_cache()
    log(f"  profiles: {out['prof_s']:.1f} s of (b)")
    secs = _log_laps("8r", laps)
    return dict(out, **init, layer=layer, rel=rel,
                checks_peak_gb=checks_peak_gb, secs=secs)


# ---------------------------------------------------------------------------
# 8w. audio serving, 8v. vlm forward and serving
# ---------------------------------------------------------------------------

# whisper-base and internvl2-2b at CONFIG, nothing cut: every parameter of
# lm.init_params, as the reference's init_params tree counts them
# (param_count leaves out cross attention, enc_pos, the norms and the
# projector: 71,984,128 and 1,889,046,528)
WHISPER_PARAMS = 97_950_720
INTERNVL_PARAMS = 1_895_440_384
# whisper's traffic: 16 clips of encoder_seq_len (1,500) frames, each a
# 4-token prompt and 224 new tokens: 228 positions, within the 448 of
# real whisper's decoder
CLIPS, CLIP_PROMPT, CLIP_NEW = 16, 4, 224
DECODE_STEPS = 32            # the decode steps timed one by one in 8w
# the vlm projector in f32 against a float64 numpy evaluation of the
# reference's formula: f32 products of width <= 2048 in other orders, a
# few f32 roundings (2**-24) times sqrt(width); 1e-5 leaves a wide margin
# and is far below the planted faults' (tests/test_torch_audio_vlm.py)
PROJ_REL_L2 = 1e-5


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _cross_kv_ms(pt, params, cfg, enc) -> float:
    """Device ms of what a decode step recomputes for cross attention:
    each decoder layer's K and V projections of the encoder output
    (2 x layers GEMMs of (B * S_enc, d) x (d, d)), CUDA events, median
    of 5 behind the spin."""
    lm = pt.lm
    ws = [lm.layer(params["blocks"], i)["cross"] for i in
          range(cfg.num_layers)]

    def run():
        for w in ws:
            enc @ w["wk"]
            enc @ w["wv"]

    run()
    scratch = torch.empty(2 ** 26, dtype=torch.float32, device=DEV)
    ms = statistics.median(_times(run, 5, scratch))
    del scratch
    return ms


def _audio_decode_vs_forward(pt, params, cfg, tokens, frames, bound,
                             what) -> dict:
    """forward(tokens, frames=) against prefill(tokens[:, :-1], frames=)
    + decode_step(tokens[:, -1]): the encoder outputs (prefill's
    ``cache["enc"]`` and forward's ``aux["encoder_out"]``, the same ops on
    the same shapes) bitwise equal, and the last hidden state's relative
    L2 (the caller holds it to ``bound``)."""
    lm, dec = pt.lm, pt.dec
    h_full, aux = lm.forward(params, tokens, cfg, frames=frames)
    cache, _ = dec.prefill(params, tokens[:, :-1], cfg,
                           max_len=tokens.shape[1], frames=frames)
    enc_equal = torch.equal(cache["enc"], aux["encoder_out"])
    enc_err = float((cache["enc"].float()
                     - aux["encoder_out"].float()).abs().max())
    cache, h_dec = dec.decode_step(params, cache, tokens[:, -1], cfg)
    rel = _rel_l2(h_dec[0].float(), h_full[0, -1].float(),
                  f"decode matches forward ({tokens.shape[1]} tokens, "
                  f"{what})", bound)
    log(f"  prefill's cache['enc'] against forward's "
        f"aux['encoder_out'] ({what}): "
        f"{'bitwise equal' if enc_equal else 'DIFFER'} (max_abs_err "
        f"{enc_err:.3e})")
    return dict(rel=rel, enc_equal=enc_equal)


def phase_audio(pt, kmods) -> dict:
    cfg = pt.AUDIO_CONFIG
    lm, dec = pt.lm, pt.dec
    log(f"== 8w. audio serving: {cfg.name} at full width and depth "
        f"({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
        f"d {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, {cfg.encoder_seq_len} frames, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), generate(frames=) over {CLIPS} "
        f"clips, {CLIP_PROMPT}-token prompts, {CLIP_NEW} new tokens each")
    laps = {}
    with _timed(laps, "init"):
        init = _init_state_lm(pt, cfg, 29, WHISPER_PARAMS)
    params = init.pop("params")
    rng = np.random.default_rng(31)
    frames = torch.as_tensor(rng.standard_normal(
        (CLIPS, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32),
        device=DEV)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (CLIPS, CLIP_PROMPT)), device=DEV)
    torch.cuda.reset_peak_memory_stats()

    # (a) the main path: generate(frames=), from counts at 0
    with _timed(laps, "(a) generate"):
        for mod in kmods:
            mod.reset_launch_counts()
        pt.layers.reset_call_counts()
        t0 = time.perf_counter()
        out = pt.generate(params, cfg, prompts, CLIP_NEW, frames=frames,
                          device=DEV)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    chunked = pt.layers.CALL_COUNTS["chunked_attention"]
    check(counts == _launches() and chunked == 0,
          f"generate(frames=) launched no kernel and called "
          f"chunked_attention {chunked} times ({counts})")
    check(tuple(out.shape) == (CLIPS, CLIP_NEW) and 0 <= int(out.min())
          and int(out.max()) < cfg.vocab_size,
          f"{CLIPS} x {CLIP_NEW} ids in the vocabulary")
    gen_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens_out = out.numel()
    log(f"  generate(frames=): {tokens_out} tokens in {gen_s:.3f} s "
        f"({tokens_out / gen_s:.2f} tokens/s, host clock, the encoder and "
        f"the prefill included); flash launches 0, chunked_attention calls "
        f"0; peak device memory {gen_peak_gb:.2f} GB")

    # where the time goes: the encoder, the prefill (encoder included)
    # and decode steps one by one (host clock to a synchronize), the
    # cross K/V projections each step recomputes, one profiled step
    with _timed(laps, "(a) times and profile"):
        def host_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0), r

        enc_ms = statistics.median(
            host_ms(lambda: lm.encode(params, frames, cfg))[0]
            for _ in range(3))
        prefill_ms, (cache, hidden) = host_ms(lambda: dec.prefill(
            params, prompts, cfg, max_len=CLIP_PROMPT + CLIP_NEW,
            frames=frames))
        tok = out[:, 0]
        step_ms = []
        for i in range(DECODE_STEPS):
            ms, _ = host_ms(lambda: dec.decode_step(params, cache, tok, cfg))
            step_ms.append(ms)
            tok = out[:, i + 1]
        step = statistics.median(step_ms)
        cross_ms = _cross_kv_ms(pt, params, cfg, cache["enc"])
        prof = _profile_lm(lambda: dec.decode_step(params, cache, tok, cfg),
                           "decode step", step)
        del cache, hidden
    share = cross_ms / prof["busy_ms"] if prof["busy_ms"] else 0.0
    log(f"  encoder ({CLIPS} x {cfg.encoder_seq_len} frames): {enc_ms:.3f} "
        f"ms; prefill ({CLIP_PROMPT} tokens, encoder included): "
        f"{prefill_ms:.3f} ms; decode step ({CLIPS} clips): median "
        f"{step:.3f} ms, min {min(step_ms):.3f}, max {max(step_ms):.3f} "
        f"over {DECODE_STEPS} steps (host clock)")
    log(f"  the cross K/V projections a decode step recomputes "
        f"({2 * cfg.num_layers} GEMMs of ({CLIPS * cfg.encoder_seq_len}, "
        f"{cfg.d_model}) x ({cfg.d_model}, {cfg.d_model})): {cross_ms:.3f} "
        f"ms of device time, {100 * share:.1f}% of a decode step's device "
        f"busy {prof['busy_ms']:.3f} ms, {100 * cross_ms / step:.1f}% of its "
        f"host-clock {step:.3f} ms")

    # (b) and (c): one clip's whole sequence, prompt and generated tokens
    with _timed(laps, "(b, c) decode vs forward"):
        tokens = torch.cat([prompts[:1], out[:1]], dim=1)
        bf = _audio_decode_vs_forward(pt, params, cfg, tokens, frames[:1],
                                      DECODE_REL_L2, "bf16")
        p32 = _cast(params, torch.float32)
        f32 = _audio_decode_vs_forward(pt, p32, cfg, tokens, frames[:1],
                                       DECODE_F32_REL, "f32")
        del p32
    check(bf["enc_equal"] and f32["enc_equal"],
          "prefill's cache['enc'] bitwise forward's aux['encoder_out']")
    check(bf["rel"] < DECODE_REL_L2 and f32["rel"] < DECODE_F32_REL,
          "decode_step after prefill matches forward (bf16 and f32)")
    del params, frames
    torch.cuda.empty_cache()
    secs = _log_laps("8w", laps)
    return dict(init, tokens=tokens_out, gen_s=gen_s, enc_ms=enc_ms,
                prefill_ms=prefill_ms, step_ms=step, cross_ms=cross_ms,
                cross_share=share, prof=prof, rel=bf["rel"],
                rel_f32=f32["rel"], peak_gb=gen_peak_gb, secs=secs,
                seq=tokens.shape[1])


def _projector_f64(pj, patches) -> np.ndarray:
    """The reference's projector formula (repro/models/lm.py) in float64
    numpy: LayerNorm with the population variance and eps 1e-6, fc1, the
    tanh GELU, fc2."""
    w = {k: v.double().cpu().numpy() for k, v in pj.items()}
    x = patches.double().cpu().numpy()
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    x = (x - mu) / np.sqrt(var + 1e-6) * w["ln_w"] + w["ln_b"]
    y = x @ w["fc1"]
    y = 0.5 * y * (1 + np.tanh(np.sqrt(2 / np.pi) * (y + 0.044715 * y ** 3)))
    return y @ w["fc2"]


def _vlm_layer0_flash(pt, params, cfg, tokens, patches) -> float:
    """The flash wrapper against its plain version on layer 0's real
    q/k/v of the prefixed sequence (the projected patches, then the
    text; rotary positions over the whole sequence)."""
    lm = pt.lm
    h = lm.embed_tokens(params, tokens, cfg)
    h = torch.cat([lm.project_patches(params["projector"], patches,
                                      h.dtype), h], dim=1)
    S = h.shape[1]
    pl = lm.layer(params["blocks"], 0)
    q, k, v = lm._gqa_qkv(pl["attn"], lm._norm(h, pl["ln1"], cfg),
                          torch.arange(S, device=DEV)[None], cfg)
    return _flash_case(pt.fa, q, k, v, True, cfg.window,
                       f"internvl2 layer 0 of {cfg.vision_tokens} patches + "
                       f"{tokens.shape[1]} tokens (real q/k/v, "
                       f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                       f"{cfg.head_dim}, rope theta {cfg.rope_theta:g})")


def _vlm_decode_vs_prefill(pt, params, cfg, tokens, bound, what) -> float:
    """prefill(tokens[:, :-1]) + decode_step(tokens[:, -1]) against
    prefill(tokens)'s last hidden state, text only (the vlm forward needs
    patches, which prefill refuses in both packages)."""
    dec = pt.dec
    _, h = dec.prefill(params, tokens, cfg)
    return _rel_l2(_decoded_last(pt, params, cfg, tokens), h[0, -1].float(),
                   f"decode matches prefill ({tokens.shape[1]} text tokens, "
                   f"{what})", bound)


def phase_vlm(pt, kmods) -> dict:
    cfg = pt.VLM_CONFIG
    lm, fa = pt.lm, pt.fa
    log(f"== 8v. vlm: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.vision_tokens} patches of {cfg.vision_dim}, {cfg.dtype}): "
        f"lm.forward(patches=) over {LONG_PROMPT} positions, then text "
        f"serving through ContinuousBatcher({SSM_SLOTS} slots x "
        f"{LM_MAX_LEN} positions)")
    laps = {}
    with _timed(laps, "init"):
        init = _init_state_lm(pt, cfg, 37, INTERNVL_PARAMS)
    params = init.pop("params")
    rng = np.random.default_rng(41)
    patches = torch.as_tensor(rng.standard_normal(
        (1, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32),
        device=DEV)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, LONG_PROMPT - cfg.vision_tokens)), device=DEV)

    # (a) the checks, then the prefixed forward from counts at 0
    with _timed(laps, "(a) checks"):
        err = _vlm_layer0_flash(pt, params, cfg, tokens, patches)
        pj32 = {k: v.float() for k, v in params["projector"].items()}
        proj = _rel(lm.project_patches(pj32, patches, torch.float32),
                    torch.as_tensor(_projector_f64(pj32, patches),
                                    device=DEV))
        del pj32
    log(f"  projector in f32 against float64 numpy on the real patches: "
        f"relative L2 {proj:.3e} (bound {PROJ_REL_L2})")
    check(proj < PROJ_REL_L2, "the projector matches the reference's formula")
    torch.cuda.reset_peak_memory_stats()
    with _timed(laps, "(a) forward and profile"):
        for mod in kmods:
            mod.reset_launch_counts()
        pt.layers.reset_call_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _ = lm.forward(params, tokens, cfg, patches=patches)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
        routes = dict(fa.ROUTE_COUNTS)
        chunked = pt.layers.CALL_COUNTS["chunked_attention"]
        logits = lm.lm_logits(params, h[:, -1], cfg)[0, : cfg.vocab_size]
        fwd_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(tuple(h.shape) == (1, LONG_PROMPT, cfg.d_model)
              and bool(torch.isfinite(h).all())
              and bool(torch.isfinite(logits).all()),
              "the prefixed forward: finite hidden states and logits of "
              "the whole sequence's shape")
        del h
        prof = _profile_lm(lambda: lm.forward(params, tokens, cfg,
                                              patches=patches),
                           f"forward of {LONG_PROMPT} positions", fwd_ms)
    n = cfg.num_layers
    check(counts == _launches(flash_attention=n) and chunked == 0
          and routes == {"wgmma": n, "simt": 0},
          f"the prefixed forward launched the flash kernel {n} times on "
          f"the wgmma route and nothing else ({counts}, {routes}, "
          f"chunked_attention {chunked})")
    top = torch.topk(logits.float(), 3)
    log(f"  forward ({cfg.vision_tokens} patches + {tokens.shape[1]} "
        f"tokens): {fwd_ms:.3f} ms (host clock), flash launches "
        f"{counts['flash_attention']} ({routes}); the last row's logits: "
        f"top ids {top.indices.tolist()} at "
        f"{[round(v, 4) for v in top.values.tolist()]}, mean "
        f"{float(logits.float().mean()):.4f}; peak device memory "
        f"{fwd_peak_gb:.2f} GB")
    del patches, tokens

    # (b) text-only serving
    reqs = _lm_requests(pt, cfg, 4)
    torch.cuda.reset_peak_memory_stats()
    with _timed(laps, "(b) serving and profiles"):
        out = _serve_states(pt, params, cfg, reqs, kmods)
    # (c) decode against prefill on a short text prompt
    with _timed(laps, "(c) decode vs prefill"):
        short = torch.as_tensor(reqs[1].prompt[None], device=DEV)
        rel = _vlm_decode_vs_prefill(pt, params, cfg, short, DECODE_REL_L2,
                                     "bf16")
        p32 = _cast(params, torch.float32)
        rel32 = _vlm_decode_vs_prefill(pt, p32, cfg, short, DECODE_F32_REL,
                                       "f32")
        del p32
    check(rel < DECODE_REL_L2 and rel32 < DECODE_F32_REL,
          "decode_step after prefill matches prefill (bf16 and f32)")
    del params
    torch.cuda.empty_cache()
    secs = _log_laps("8v", laps)
    return dict(out, **init, err=err, proj=proj, fwd_ms=fwd_ms,
                fwd_launches=counts["flash_attention"], fwd_prof=prof,
                fwd_peak_gb=fwd_peak_gb, rel=rel, rel_f32=rel32,
                short_len=short.shape[1], secs=secs)


# ---------------------------------------------------------------------------
# 8t. LM training
# ---------------------------------------------------------------------------

TRAIN_PATH = "8t LM training"
LMT_STEPS = 4                # (a): the Trainer's steps at full depth
LMT_BATCH, LMT_SEQ = 1, 4096  # (a): tokens a step
LMT_PARAMS = 8_254_689_280   # granite-8b's parameters (param_count)
LMT_SCALE_BYTES = 257_959_040  # one int8 moment's f32 scales: params / 128 x 4
GRAD_LAYERS, GRAD_STEPS = 2, 2  # (b): f32, int8 moments, card vs CPU
GRAD_TOKENS = 128            # (b): tokens a step
RESUME_TOKENS = 1024         # (c): 3 steps, resumed at 2
LONG_TRAIN_TOKENS = 16_384   # (d): one step of 2 layers
# (b) the same f32 steps on the card (TF32 off) and on the CPU: f32
# products of width <= 49,152 in other orders; the CPU tests hold the
# port to the reference at these bounds (tests/test_torch_lm_train.py)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
# (b) after the steps, per leaf.  Parameters: an element whose gradient
# lies within the two devices' difference of 0 may take the other sign
# and move 2 lr apart, the rest agree to the gradients' order.  int8
# moments: the codes may differ by a rounding on under 1 % of the
# entries (the quantizer's bound in the CPU tests), so the decoded
# moments are held to sqrt(1 %) x one code's step against the block's
# rms: 0.1 x 2.6 / 127 for m ("sym", a block of 128 normals peaks near
# 2.6 rms), 0.1 x (e**(27.631 / 127) - 1) for v ("log")
TRAIN_PARAM_REL = 1e-4
TRAIN_CODES_DIFFER = 0.01
TRAIN_MOMENT_REL = {"m": 2e-3, "v": 2.5e-2}
# (d) chunked_attention's q/k/v gradients against full_attention's, f32,
# at granite's layer over 4,096 keys (B, S, H, KH, hd): two softmax orders
CHUNKED_GRAD_SHAPE = (1, 4096, 32, 8, 128)
CHUNKED_GRAD_REL = 1e-4
# (e) deepseek-v3-671b's first training on the card, at its published
# widths cut in depth to its first dense MLA layer and the MTP head
# (num_layers and first_k_dense cut together to 1: the MoE stack is empty;
# a MoE layer's training state alone, ~8 B a parameter over its 11.27e9
# routed-expert parameters, is ~92 GB, so no MoE layer trains on one
# card).  3,123,106,816 parameters: 6.25 GB each of bf16 parameters and
# gradients and 6.44 GB of int8 moments with their scales
DS_TRAIN_PARAMS = 3_123_106_816
DS_TRAIN_STEPS = 2
DS_TRAIN_BATCH, DS_TRAIN_SEQ = 1, 2048
# (e) step 1's update against the warmup's learning rate, per element:
# AdamW's first step moves a weight by lr (|m / sqrt(v)| <= 1 at step 1)
# plus lr wd |w|, and the bf16 store rounds the new value x by up to
# 2**-8 |x| <= 2**-8 / (1 - 2**-8) of the stored one; the bound's own f32
# arithmetic takes 1e-6 more
DS_TRAIN_ROUND = 2.0 ** -8 / (1 - 2.0 ** -8)
DS_TRAIN_SLACK = 1 + 1e-6


def _tree_bytes(pt, tree) -> int:
    return sum(t.numel() * t.element_size() for t in pt.leaves(tree)
               if isinstance(t, torch.Tensor))


def _moment_bytes(pt, tree) -> tuple:
    """(int8 payload bytes, f32 scale bytes) of a tree of QuantizedTensor."""
    qs = pt.leaves(tree)
    return (sum(m.q.numel() * m.q.element_size() for m in qs),
            sum(m.scale.numel() * m.scale.element_size() for m in qs))


def _reset_counts(pt, kmods) -> None:
    for mod in kmods:
        mod.reset_launch_counts()
    pt.layers.reset_call_counts()


def _counts(pt, kmods) -> dict:
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    return dict(counts, chunked=pt.layers.CALL_COUNTS["chunked_attention"])


def _train_full(pt, kmods, cfg) -> dict:
    """(a): Trainer(device=None).run(LMT_STEPS) at CONFIG, int8 moments."""
    tc = pt.TrainConfig(optimizer_state_dtype="int8", remat=True,
                        warmup_steps=1, total_steps=LMT_STEPS + 2)
    data = pt.Prefetcher(pt.lm_batches(cfg, LMT_BATCH, LMT_SEQ, seed=0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = pt.Trainer(cfg, tc, data)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, opt = tr.state["params"], tr.state["opt"]
    n_params = sum(t.numel() for t in pt.leaves(params))
    pbytes = _tree_bytes(pt, params)
    mq, ms = _moment_bytes(pt, opt["m"])
    vq, vs = _moment_bytes(pt, opt["v"])
    log(f"  Trainer init: {n_params:,} parameters, {pbytes:,} B bf16, "
        f"moments m {mq:,} + {ms:,} B, v {vq:,} + {vs:,} B (int8 + f32 "
        f"scales), in {init_s:.1f} s")
    check(n_params == LMT_PARAMS and pbytes == 2 * LMT_PARAMS
          and all(t.dtype == torch.bfloat16 for t in pt.leaves(params)),
          f"{LMT_PARAMS:,} bf16 parameters, {2 * LMT_PARAMS:,} B")
    check((mq, ms, vq, vs) == (LMT_PARAMS, LMT_SCALE_BYTES) * 2,
          "the int8 moments' payloads and scales to the byte")

    _reset_counts(pt, kmods)
    losses, gnorms = [], []
    tr.run(LMT_STEPS, on_metrics=lambda s, m: log(
        f"  step {s}: loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, "
        f"lr {m['lr']:.3e}, {m['step_time_s']:.3f} s"))
    counts = _counts(pt, kmods)
    for _, m in tr.metrics_log:
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
    step_s = [m["step_time_s"] for _, m in tr.metrics_log]
    gbytes = _tree_bytes(pt, tr.step_fn.grads)
    check(gbytes == 2 * LMT_PARAMS, f"gradients {2 * LMT_PARAMS:,} B")
    state_bytes = pbytes + gbytes + mq + ms + vq + vs
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          "finite losses and gradient norms")
    check(counts == dict(_launches(), chunked=0),
          f"no kernel launch and no chunked_attention call in training at "
          f"{LMT_SEQ} tokens ({counts})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med_s = statistics.median(step_s[1:])
    tokens_s = LMT_BATCH * LMT_SEQ / med_s
    log(f"  {LMT_STEPS} steps: median {med_s:.3f} s after the first "
        f"({step_s[0]:.3f} s), {tokens_s:.1f} tokens/s; state "
        f"{state_bytes / 1e9:.2f} GB, peak device memory {peak_gb:.2f} GB")

    # one more step split by CUDA events: forward + backward, the update
    batch = {k: torch.as_tensor(v, device=DEV)
             for k, v in next(data).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    tr.step_fn.grad(params, batch)
    ev[1].record()
    pt.adamw_update(tr.step_fn.grads, opt, params, tc)
    ev[2].record()
    torch.cuda.synchronize()
    fb_ms, upd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    log(f"  a step split (CUDA events): forward + backward {fb_ms:.1f} ms, "
        f"update {upd_ms:.1f} ms ({100 * upd_ms / (fb_ms + upd_ms):.1f} % "
        f"of the step)")
    prof = _profile_lm(lambda: tr.step_fn(tr.state, batch),
                       "train step", fb_ms + upd_ms)
    data.close()
    del tr, params, opt, batch
    torch.cuda.empty_cache()
    return dict(n_params=n_params, init_s=init_s, losses=losses,
                gnorms=gnorms, step_s=step_s, med_s=med_s, tokens_s=tokens_s,
                peak_gb=peak_gb, state_bytes=state_bytes, fb_ms=fb_ms,
                upd_ms=upd_ms, prof=prof, launches=counts["flash_attention"],
                chunked=counts["chunked"])


def _copy_to(tree, device):
    """A copy on ``device`` of a tree of tensors and QuantizedTensors."""
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, q=_copy_to(tree.q, device),
                                   scale=_copy_to(tree.scale, device))
    return tree.to(device, copy=True)


def _train_grad_vs_cpu(pt, cfg) -> dict:
    """(b): GRAD_STEPS train steps of GRAD_LAYERS layers at granite width
    in f32 with int8 moments on the card; each from a copy on the CPU of
    the card's state before it, so that no difference carries over from
    one step to the next.  Each step's loss and gradients against the
    CPU's; at the last step (its moments int8 codes of the first's) the
    CPU updates too: the parameters and the moments (codes and decoded)
    against the CPU's.  The comparisons run on the card."""
    cfg2 = dataclasses.replace(cfg, num_layers=GRAD_LAYERS, dtype="float32")
    tc = pt.TrainConfig(optimizer_state_dtype="int8", warmup_steps=1)
    params = pt.lm.init_params(torch.Generator(device=DEV).manual_seed(21),
                               cfg2, device=DEV)
    state = {"params": params, "opt": pt.adamw_init(params, tc)}
    paths = [p for p, _ in pt.flatten_with_paths(params)]
    card, cpu = (pt.tstep.make_train_step(cfg2, tc) for _ in range(2))
    losses, norms, grel, secs = [], [], {}, [0.0, 0.0]
    for s, batch in enumerate(itertools.islice(
            pt.lm_batches(cfg2, 1, GRAD_TOKENS, seed=1), GRAD_STEPS)):
        host = _copy_to(state, "cpu")
        t0 = time.perf_counter()
        state, m = card(state, {k: torch.as_tensor(v, device=DEV)
                                for k, v in batch.items()})
        loss = float(m["loss"])
        t1 = time.perf_counter()
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        if s == GRAD_STEPS - 1:
            host, mc = cpu(host, tb)
        else:
            mc = cpu.grad(host["params"], tb)
        secs[0] += t1 - t0
        secs[1] += time.perf_counter() - t1
        losses.append((loss, float(mc["loss"])))
        norms.append((float(m["grad_norm"]), float(
            mc["grad_norm"] if "grad_norm" in mc else
            pt.global_norm(cpu.grads))))
        grel.update({(s, p): _rel(g, gc.to(DEV)) for p, g, gc in zip(
            paths, pt.leaves(card.grads), pt.leaves(cpu.grads))})
    loss_rel = max(abs(a - b) / abs(b) for a, b in losses)
    norm_rel = max(abs(a - b) / abs(b) for a, b in norms)
    host = _copy_to(host, DEV)
    prel = {p: _rel(a, b) for p, a, b in zip(
        paths, pt.leaves(state["params"]), pt.leaves(host["params"]))}
    mrel, differ = {}, {}
    for name in ("m", "v"):
        for p, a, b in zip(paths, pt.leaves(state["opt"][name]),
                           pt.leaves(host["opt"][name])):
            differ[name, p] = float((a.q != b.q).float().mean())
            mrel[name, p] = _rel(pt.dequantize_blockwise(a),
                                 pt.dequantize_blockwise(b))
    worst = {k: max(d, key=d.get) for k, d in (
        ("grad", grel), ("param", prel), ("m", {k: v for k, v in mrel.items()
                                                if k[0] == "m"}),
        ("v", {k: v for k, v in mrel.items() if k[0] == "v"}),
        ("codes", differ))}
    log(f"  (b) {GRAD_LAYERS} layers f32, int8 moments, {GRAD_STEPS} steps of"
        f" {GRAD_TOKENS} tokens, each from the card's state: losses (card, "
        f"CPU) {losses} (worst relative {loss_rel:.3e}, bound "
        f"{TRAIN_LOSS_REL}); global gradient norms (card, CPU) {norms} "
        f"(worst relative {norm_rel:.3e}, bound {TRAIN_LOSS_REL}); "
        f"{len(paths)} leaves: gradients' worst relative "
        f"L2 {grel[worst['grad']]:.3e} at step {worst['grad'][0] + 1} "
        f"{worst['grad'][1]} (bound {TRAIN_GRAD_REL}); after step "
        f"{GRAD_STEPS}'s update, parameters {prel[worst['param']]:.3e} at "
        f"{worst['param']} (bound {TRAIN_PARAM_REL}), decoded m "
        f"{mrel[worst['m']]:.3e} at {worst['m'][1]} (bound "
        f"{TRAIN_MOMENT_REL['m']}), v {mrel[worst['v']]:.3e} at "
        f"{worst['v'][1]} (bound {TRAIN_MOMENT_REL['v']}), int8 codes that "
        f"differ at most {differ[worst['codes']]:.3e} of a leaf "
        f"({worst['codes'][0]} {worst['codes'][1]}, bound "
        f"{TRAIN_CODES_DIFFER}); {secs[0]:.2f} s on the card, {secs[1]:.2f} "
        f"s on the CPU")
    check(loss_rel < TRAIN_LOSS_REL, "the card's losses are the CPU's")
    check(norm_rel < TRAIN_LOSS_REL,
          "the card's global gradient norms (the clip) are the CPU's")
    check(grel[worst["grad"]] < TRAIN_GRAD_REL,
          "every gradient leaf the CPU's, at every step")
    check(prel[worst["param"]] < TRAIN_PARAM_REL,
          "every updated parameter leaf the CPU's")
    check(all(mrel[k] < TRAIN_MOMENT_REL[k[0]] for k in mrel)
          and differ[worst["codes"]] < TRAIN_CODES_DIFFER,
          "the int8 moments the CPU's")
    del params, state, host, card, cpu
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, norm_rel=norm_rel,
                grad_rel=grel[worst["grad"]],
                param_rel=prel[worst["param"]],
                m_rel=mrel[worst["m"]], v_rel=mrel[worst["v"]],
                codes_differ=differ[worst["codes"]])


def _train_ctx_step(pt, kmods, cfg, want_loss) -> dict:
    """(a'): one step of (a)'s run under make_context(CTX_RANKS): a
    Trainer from the same seed (the vocabulary padded alike) on the same
    first batch; its loss finite and bitwise (a)'s step 1 (a dense model,
    the embedding through the sharded bag exact), CTX_RANKS TBE launches
    (the forward's lookup; the backward and the update launch none),
    peak device memory."""
    check(pt.lm.padded_vocab(cfg, CTX_RANKS) == pt.lm.padded_vocab(cfg, 1),
          "the vocabulary pads alike at 1 and 4 ranks: the same draws")
    tc = pt.TrainConfig(optimizer_state_dtype="int8", remat=True,
                        warmup_steps=1, total_steps=LMT_STEPS + 2)
    torch.cuda.reset_peak_memory_stats()
    tr = pt.Trainer(cfg, tc, pt.lm_batches(cfg, LMT_BATCH, LMT_SEQ, seed=0),
                    ctx=pt.make_context(CTX_RANKS))
    _reset_counts(pt, kmods)
    tr.run(1)
    counts = _counts(pt, kmods)
    (_, m), = tr.metrics_log
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  (a') 1 step under make_context({CTX_RANKS}): loss "
        f"{m['loss']!r} ((a)'s step 1 {want_loss!r}), grad_norm "
        f"{m['grad_norm']:.4f}, {m['step_time_s']:.3f} s, launches "
        f"{TBE_FLAT} {counts[TBE_FLAT]}, peak device memory {peak_gb:.2f} "
        f"GB")
    check(np.isfinite(m["loss"]) and m["loss"] == want_loss,
          "the ctx step's loss bitwise the local step 1's")
    check(counts == dict(_launches(**{TBE_FLAT: CTX_RANKS}), chunked=0),
          f"the ctx step: {CTX_RANKS} TBE launches, nothing else ({counts})")
    del tr
    torch.cuda.empty_cache()
    return dict(loss=m["loss"], step_s=m["step_time_s"], peak_gb=peak_gb,
                launches=counts[TBE_FLAT])


def _train_resume(pt, cfg, ctx=None) -> dict:
    """(c): 3 steps with checkpoints every 2, resumed at 2 for 1 step:
    the state bitwise the uninterrupted run's; (c') the same under
    ``ctx``."""
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    tc = pt.TrainConfig(optimizer_state_dtype="int8", warmup_steps=1,
                        total_steps=3, checkpoint_every=2)
    tag = "(c)" if ctx is None else f"(c') under make_context({CTX_RANKS})"
    with tempfile.TemporaryDirectory() as d:
        tr = pt.Trainer(cfg1, tc, pt.lm_batches(cfg1, 1, RESUME_TOKENS,
                                                seed=2), ckpt_dir=d, ctx=ctx)
        t0 = time.perf_counter()
        tr.run(3)
        run_s = time.perf_counter() - t0
        step2 = os.path.join(d, "step_00000002")
        disk = sum(os.path.getsize(os.path.join(step2, f))
                   for f in os.listdir(step2))
        check(sorted(os.listdir(d)) == ["step_00000002", "step_00000003"],
              "checkpoints at steps 2 and 3")
        shutil.rmtree(os.path.join(d, "step_00000003"))
        tr2 = pt.Trainer(cfg1, tc, pt.lm_batches(cfg1, 1, RESUME_TOKENS,
                                                 seed=2, start_step=2),
                         ckpt_dir=d, ctx=ctx)
        check(tr2.start_step == 2, "resumed at step 2")
        tr2.run(1)
        same = [torch.equal(a, b) for (_, a), (_, b) in zip(
            pt.flatten_with_paths(tr.state),
            pt.flatten_with_paths(tr2.state))]
    log(f"  {tag} 1 layer bf16, int8 moments, {RESUME_TOKENS} tokens: 3 steps "
        f"with 2 checkpoints in {run_s:.2f} s; the checkpoint of step 2 "
        f"{disk:,} B on disk; resumed at 2 for 1 step: {sum(same)} of "
        f"{len(same)} state leaves bitwise the uninterrupted run's")
    check(all(same), "the resumed state bitwise the uninterrupted one")
    del tr, tr2
    torch.cuda.empty_cache()
    return dict(ckpt_bytes=disk)


def _train_long(pt, kmods, cfg) -> dict:
    """(d): one step of 2 layers over LONG_TRAIN_TOKENS (chunked_attention
    under grad), then chunked_attention's gradients against
    full_attention's."""
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    tc = pt.TrainConfig(optimizer_state_dtype="int8", warmup_steps=1)
    tr = pt.Trainer(cfg2, tc, pt.lm_batches(cfg2, 1, LONG_TRAIN_TOKENS,
                                            seed=3))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(pt, kmods)
    tr.run(1)
    counts = _counts(pt, kmods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (_, m), = tr.metrics_log
    log(f"  (d) 2 layers bf16, {LONG_TRAIN_TOKENS} tokens: loss "
        f"{m['loss']:.4f}, {m['step_time_s']:.3f} s, chunked_attention "
        f"calls {counts['chunked']} (2 layers, forward and recompute), "
        f"flash launches {counts['flash_attention']}, peak device memory "
        f"{peak_gb:.2f} GB")
    check(np.isfinite(m["loss"]) and counts == dict(_launches(), chunked=4),
          "the long step: finite, chunked_attention in each layer's forward"
          " and recompute, no kernel launch")
    del tr
    torch.cuda.empty_cache()

    g = torch.Generator(device=DEV).manual_seed(23)
    q, k, v = _qkv(g, *CHUNKED_GRAD_SHAPE, torch.float32)
    w = torch.randn(q.shape, generator=g, device=DEV)
    grads = []
    for fn in (pt.fa.chunked_attention, pt.layers.full_attention):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*ts, causal=True) * w).sum().backward()
        grads.append([t.grad for t in ts])
    rels = [_rel(a, b) for a, b in zip(*grads)]
    log(f"  (d) chunked_attention's q/k/v gradients against full_attention's "
        f"at {CHUNKED_GRAD_SHAPE} (B, S, H, KH, hd) f32 causal: relative L2 "
        + ", ".join(f"{r:.3e}" for r in rels) + f" (bound {CHUNKED_GRAD_REL})")
    check(max(rels) < CHUNKED_GRAD_REL,
          "chunked_attention's gradients are full_attention's")
    del q, k, v, w, grads
    torch.cuda.empty_cache()
    return dict(peak_gb=peak_gb, chunked=counts["chunked"],
                launches=counts["flash_attention"], step_s=m["step_time_s"],
                grad_rel=max(rels))


def _update_ratio(before, after, lr, wd) -> tuple:
    """(the largest |after - before| over its bound lr (1 + wd |before|)
    + DS_TRAIN_ROUND |after|, whether every value of ``after`` is finite,
    the largest |after - before|), in slices of 2**26 elements."""
    worst, finite, moved = 0.0, True, 0.0
    if not after.numel():           # the empty MoE stack's leaves
        return worst, finite, moved
    for a, b in zip(after.reshape(-1).split(2 ** 26),
                    before.reshape(-1).split(2 ** 26)):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        bound = (lr * (1 + wd * b.abs()) + DS_TRAIN_ROUND * a.abs()) \
            * DS_TRAIN_SLACK
        worst = max(worst, float((d / bound).max()))
        finite &= bool(torch.isfinite(a).all())
        moved = max(moved, float(d.max()))
    return worst, finite, moved


def _train_mla(pt, kmods) -> dict:
    """(e): deepseek-v3-671b at its published widths, 1 dense layer and
    the MTP head, bf16, int8 moments, DS_TRAIN_STEPS Trainer steps of
    DS_TRAIN_BATCH x DS_TRAIN_SEQ tokens: the state's bytes against the
    meta state's, step 1's loss, ce and mtp_ce against a no-grad lm_loss
    of the same parameters and batch, step 1's update finite and within
    the warmup's learning rate, no kernel launch."""
    cfg = dataclasses.replace(pt.deepseek_v3_671b.CONFIG, num_layers=1,
                              first_k_dense=1)
    tc = pt.TrainConfig(optimizer_state_dtype="int8", remat=True,
                        warmup_steps=1, total_steps=DS_TRAIN_STEPS + 2)
    stream = pt.lm_batches(cfg, DS_TRAIN_BATCH, DS_TRAIN_SEQ, seed=0)
    batches = [next(stream) for _ in range(DS_TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = pt.Trainer(cfg, tc, iter(batches))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, opt = tr.state["params"], tr.state["opt"]
    meta = pt.tstep.init_train_state(None, cfg, tc, device="meta")
    n_params = sum(t.numel() for t in pt.leaves(params))
    pbytes = _tree_bytes(pt, params)
    moments = _moment_bytes(pt, opt["m"]) + _moment_bytes(pt, opt["v"])
    want = _moment_bytes(pt, meta["opt"]["m"]) + \
        _moment_bytes(pt, meta["opt"]["v"])
    log(f"  (e) {cfg.name}, {cfg.num_layers} dense layer and the MTP head "
        f"(first_k_dense {cfg.first_k_dense}: no MoE layer), {n_params:,} "
        f"parameters: {pbytes:,} B bf16, moments {sum(moments):,} B (int8 "
        f"and f32 scales), drawn in {init_s:.1f} s")
    check(n_params == DS_TRAIN_PARAMS and pbytes == 2 * DS_TRAIN_PARAMS
          and moments == want,
          f"8t (e): {DS_TRAIN_PARAMS:,} bf16 parameters and the int8 moments "
          f"to the byte of the state's arithmetic ({moments}, want {want})")
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in batches[0].items()}
    with torch.no_grad():
        _, ref = pt.tstep.lm_loss(params, batch, cfg, None, tc)
    ref = {k: float(v) for k, v in ref.items()}
    before = {p: t.clone() for p, t in pt.flatten_with_paths(params)}
    _reset_counts(pt, kmods)
    on = (lambda s, m: log(
        f"  (e) step {s}: loss {m['loss']:.4f} (ce {m['ce']:.4f}, mtp_ce "
        f"{m['mtp_ce']:.4f}), grad_norm {m['grad_norm']:.4f}, lr "
        f"{m['lr']:.3e}, {m['step_time_s']:.3f} s"))
    tr.run(1, on_metrics=on)
    m1 = tr.metrics_log[0][1]
    upd = {p: _update_ratio(before[p], t, m1["lr"], tc.weight_decay)
           for p, t in pt.flatten_with_paths(tr.state["params"])}
    del before
    tr.run(DS_TRAIN_STEPS - 1, on_metrics=on)
    counts = _counts(pt, kmods)
    gbytes = _tree_bytes(pt, tr.step_fn.grads)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = [m for _, m in tr.metrics_log]
    rel = {k: abs(m1[k] - ref[k]) / abs(ref[k])
           for k in ("loss", "ce", "mtp_ce")}
    bitwise = all(m1[k] == ref[k] for k in rel)
    worst = max(upd, key=lambda p: upd[p][0])
    log(f"  (e) step 1 against a no-grad lm_loss of the same parameters and "
        f"batch: {'bitwise' if bitwise else 'not bitwise'} (relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f"); step 1's update at most {upd[worst][0]:.4f} of its bound lr "
        f"(1 + wd |w|) + 2**-8 |w'| / (1 - 2**-8) ({worst}; the largest move "
        f"{max(u[2] for u in upd.values()):.3e}, lr {m1['lr']:.3e}); state "
        f"{(pbytes + gbytes + sum(moments)) / 1e9:.2f} GB, peak "
        f"{peak_gb:.2f} GB; steps "
        f"{[round(m['step_time_s'], 3) for m in metrics]} s; {counts}")
    check(all(v <= LMTP_LOSS_REL for v in rel.values()),
          f"8t (e): step 1's loss, ce and mtp_ce within {LMTP_LOSS_REL} of "
          f"the no-grad lm_loss ({rel})")
    check(all(u[1] for u in upd.values())
          and all(u[0] <= 1.0 for u in upd.values())
          and max(u[2] for u in upd.values()) > 0
          and 0 < m1["lr"] <= tc.learning_rate * DS_TRAIN_SLACK,
          f"8t (e): step 1's update finite, nonzero and within the warmup's "
          f"learning rate {m1['lr']:.3e} on every leaf (worst {worst} at "
          f"{upd[worst][0]:.4f} of its bound)")
    check(len(metrics) == DS_TRAIN_STEPS and all(
        np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        for m in metrics), "8t (e): finite losses and gradient norms")
    check(gbytes == 2 * DS_TRAIN_PARAMS
          and counts == dict(_launches(), chunked=0),
          f"8t (e): bf16 gradients to the byte, no kernel launch and no "
          f"chunked_attention call at {DS_TRAIN_SEQ} tokens ({counts})")
    del tr, params, opt, batch
    torch.cuda.empty_cache()
    return dict(losses=[m["loss"] for m in metrics], bitwise=bitwise,
                rel=max(rel.values()), update=upd[worst][0],
                step_s=[m["step_time_s"] for m in metrics], peak_gb=peak_gb,
                state_gb=(pbytes + gbytes + sum(moments)) / 1e9,
                launches=counts["flash_attention"])


def phase_lm_train(pt, kmods) -> dict:
    cfg = pt.LMT_CONFIG
    log(f"== 8t. LM training: {cfg.name} at full width and depth "
        f"({cfg.num_layers} layers, d {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), AdamW with int8 moments, remat, "
        f"{LMT_BATCH} x {LMT_SEQ} tokens a step from lm_batches; (e) "
        f"deepseek-v3-671b at its published widths cut in depth to 1 dense "
        f"layer and the MTP head (num_layers = first_k_dense = 1: a MoE "
        f"layer's training state, ~92 GB, fits on no card), "
        f"{DS_TRAIN_BATCH} x {DS_TRAIN_SEQ} tokens a step")
    laps = {}
    with _timed(laps, "(a) train"):
        full = _train_full(pt, kmods, cfg)
    with _timed(laps, "(a') ctx step"):
        ctx_step = _train_ctx_step(pt, kmods, cfg, full["losses"][0])
    with _timed(laps, "(b) card vs CPU"):
        grad = _train_grad_vs_cpu(pt, cfg)
    with _timed(laps, "(c) resume"):
        resume = _train_resume(pt, cfg)
    with _timed(laps, "(c') resume under ctx"):
        _train_resume(pt, cfg, pt.make_context(CTX_RANKS))
    with _timed(laps, "(d) long"):
        long = _train_long(pt, kmods, cfg)
    with _timed(laps, "(e) deepseek"):
        mla = _train_mla(pt, kmods)
    secs = _log_laps("8t", laps)
    return dict(full, grad=grad, resume=resume, long=long, mla=mla,
                secs=secs, ctx=ctx_step,
                launches=full["launches"] + long["launches"]
                + mla["launches"])


def _profile_lm(fn, label, unprofiled_ms) -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy time by
    kernel, and its busy share of the same work's unprofiled time.  The
    device's activity only: tracing the host's ops too gives the same
    device times and takes several times as long on hymba-1.5b's 16K
    prefill (~300,000 launches).  Such a profile records no host call, so
    its completeness cannot be checked (``contracts.profile_gaps``): where
    the profiler dropped records, the busy time falls short."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    idle = 100 - 100 * busy_ms / unprofiled_ms
    log(f"  profiled {label}: device busy {busy_ms:.3f} ms of "
        f"{unprofiled_ms:.3f} ms unprofiled (host clock); idle {idle:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    return dict(busy_ms=busy_ms, idle=idle)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# 9. the examples
# ---------------------------------------------------------------------------

EXAMPLES_PATH = "9 the examples"
EX_RANKS = 4                 # the reference's examples at 4 devices
EX_TIMEOUT_S = 300.0
EX_ERR = 1e-4                # quickstart's and each strategy's bound
# the traffic the reference's dlrm_inference.py prints at 4 devices: one
# rank's bytes_in summed by op (B=32, T=8, D=64 f32; the a2a's three
# (4, 512) int32/f32 exchanges, its (4, 64, 64) reduce-scatter, its
# (8, 8, 64) all-gather; column (32, 8, 16), table (32, 2, 64))
EX_TRAFFIC = {"row/allgather": {"all_reduce": 65536},
              "row/a2a": {"all_to_all": 24576, "reduce_scatter": 65536,
                          "all_gather": 16384},
              "column": {"all_gather": 16384},
              "table": {"all_gather": 16384}}
# per-launch counts of the one-device parts: the oracle and the 24
# single-request forwards (gather_pool_tbe), the tiered engine's 3
# flushes (gather_pool_tbe_flat); per rank: quickstart's oracle on rank
# 0, 2 forwards each of row/allgather (flat) and of column and table
EX_LOCAL = {"gather_pool_tbe": 25, "gather_pool_tbe_flat": 3}
EX_RANK = {"gather_pool_tbe": 4, "gather_pool_tbe_flat": 2}
EX_LOSS_STEPS = (1, 10, 100, 300)
# lm_batches' labels are independent Zipf(1.2) draws over 32,768 ids:
# no model's EXPECTED loss goes under their entropy H (5.0586 nats), but
# one batch's loss, the mean of -log p over its 1,024 labels, spreads
# about it by sqrt(V / 1,024) = 0.104 nats (V = 11.08, the variance of
# -log p; a sound run read 4.9621 at step 60 and 5.0002 at step 260).
# The last loss is held over H less EX_LOSS_SDS such spreads, the mean
# of the last EX_LOSS_TAIL losses over H less EX_LOSS_SDS of its own
# spread, sqrt(V / (1,024 x 50)): a loss under them is a fault (a label
# shift, a leak between batches), not learning
EX_LOSS_SDS = 3
EX_LOSS_TAIL = 50
EX_STEPS, EX_BATCH, EX_SEQ = 300, 8, 128
EX_TRAIN = ["--steps", str(EX_STEPS), "--batch", str(EX_BATCH), "--seq",
            str(EX_SEQ)]


def _zipf_law(a: float, ids: int) -> tuple:
    """``(H, V)``: the entropy in nats of ``min(Zipf(a), ids) - 1``,
    lm_batches' token law, and the variance of -log p under it.  p_k =
    k^-a / zeta(a) for k < ids, the tail's mass on the last id; zeta(a)
    by Euler-Maclaurin after 10**6 terms."""
    n = 10 ** 6
    zeta = float((np.arange(1, n, dtype=np.float64) ** -a).sum()
                 + n ** (1 - a) / (a - 1) + n ** -a / 2
                 + a * n ** (-a - 1) / 12)
    p = np.arange(1, ids, dtype=np.float64) ** -a / zeta
    p = np.append(p, 1.0 - p.sum())
    nats = -np.log(p)
    h = float((p * nats).sum())
    return h, float((p * (nats - h) ** 2).sum())


def _examples():
    """The five examples' modules (``examples/`` on the path)."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    import dlrm_inference_torch
    import dlrm_sharding_plan_torch
    import lm_train_torch
    import quickstart_torch
    import serve_batched_torch

    class ex:   # one namespace
        qs, di, plan = quickstart_torch, dlrm_inference_torch, \
            dlrm_sharding_plan_torch
        sb, lt = serve_batched_torch, lm_train_torch
    return ex


def _ex_rank(ctx, di_args):
    """One rank of phase 9's (1, 4) mesh: quickstart's rank function,
    then dlrm_inference's strategies, each from launch counts at 0, each
    TBE launch shape held against its plain version (:func:`_hold_tbe`).
    Every rank's counts and held shapes go to rank 0, which returns them
    with its results."""
    from repro_torch.launch.mesh import gather_world

    pt = port_namespace()
    kmods = _kernel_mods()
    ex = _examples()
    torch.backends.cuda.matmul.allow_tf32 = False
    held, restore = _hold_tbe(pt)
    try:
        _reset_counts(pt, kmods)
        t0 = time.perf_counter()
        qs_out = ex.qs.quickstart(ctx)
        _sync(ctx.device)
        qs_s = time.perf_counter() - t0
        counts = {"qs": _counts(pt, kmods)}
        _reset_counts(pt, kmods)
        t0 = time.perf_counter()
        di_out = ex.di.strategies(ctx, *di_args)
        counts["di"] = _counts(pt, kmods)
    finally:
        restore()
    counts["secs"] = {"qs": qs_s, "di": time.perf_counter() - t0}
    counts["held"] = _held(held)
    counts = gather_world(counts)
    if ctx.rank == 0:
        return {"qs": qs_out, "di": di_out, "ranks": counts}
    return None


def _hold_tbe(pt):
    """Holds each TBE launch of phase 9's path against the wrapper's
    plain version on the same inputs, once a shape: ``kernels.ops``'
    ``gather_pool_tbe`` and ``gather_pool_tbe_flat`` are wrapped so that
    the first launch at each (wrapper, argument shapes, table dtype) key
    is compared, on its own stream just after it, with the plain version
    (``embedding_gather.*_ref``; ids of zero-weight slots, which the
    kernel never reads, taken as row 0 of the table).  No launch is
    added and nothing syncs inside the path.  Returns ``(held,
    restore)``: ``held`` maps each key to ``[device pair (max |kernel -
    plain|, the largest excess over POOL_TOL), launches at the key]``,
    which :func:`_held` reads after the path."""
    from repro_torch.kernels import embedding_gather as eg

    plain = {"gather_pool_tbe": eg.gather_pool_tbe_ref,
             "gather_pool_tbe_flat": eg.gather_pool_tbe_flat_ref}
    held = {}

    def make(name):
        def wrap(real):
            def launch(*args):
                out = real(*args)
                key = (name, str(args[0].dtype)) + tuple(
                    tuple(a.shape) for a in args)
                if not out.is_cuda:
                    return out
                if key not in held:
                    idx, w = args[-2:]
                    want = plain[name](*args[:-2], idx.where(w != 0, 0), w)
                    d = (out - want).abs()
                    held[key] = [torch.stack([
                        d.max(), (d - POOL_TOL["atol"]
                                  - POOL_TOL["rtol"] * want.abs()).max()]),
                        0]
                held[key][1] += 1
                return out
            return launch
        return wrap
    restore = [_patched(pt.kops, name, make(name)) for name in plain]
    return held, lambda: [r() for r in restore]


def _held(held) -> list:
    """:func:`_hold_tbe`'s record read: ``[(key, err, excess, launches),
    ...]``."""
    return [(key, *pair.tolist(), n) for key, (pair, n) in held.items()]


def phase_examples(pt, kmods) -> dict:
    """Phase 9: the five examples through their entry points on the card;
    quickstart's and dlrm_inference's rank functions in one spawn of a
    (1, 4) mesh (gloo on one card, NCCL with 4)."""
    n_cards = torch.cuda.device_count() if DEV != "cpu" else 0
    device = None if n_cards >= EX_RANKS else _rank_device()
    backend = pt.tmesh.backend_for(EX_RANKS, device)
    log(f"== 9. the examples (examples/*_torch.py on the card; quickstart "
        f"and dlrm_inference's strategies on a (1, {EX_RANKS}) mesh of "
        f"processes over {backend}, torch.cuda.device_count() {n_cards})")
    ex = _examples()
    t_phase = time.perf_counter()
    out = {"secs": {}}
    held, restore = _hold_tbe(pt)

    # dlrm_inference: the oracle and the tiered engine in this process
    _reset_counts(pt, kmods)
    t0 = time.perf_counter()
    loc = ex.di.local(DEV)
    _sync(DEV)
    out["secs"]["dlrm_inference local"] = time.perf_counter() - t0
    local = _counts(pt, kmods)
    tiered = loc["tiered"]
    check(tiered["err"] < 1e-5 and tiered["stats"].hit_rate > 0.5,
          f"9 dlrm_inference: tiered scores within 1e-5 of the uncached "
          f"forward ({tiered['err']:.3e}), hit rate "
          f"{tiered['stats'].hit_rate:.4f} > 0.5")
    check(all(local[k] == EX_LOCAL.get(k, 0) for k in
              ("gather_pool", "gather_pool_tbe", "gather_pool_tbe_flat",
               "flash_attention")),
          f"9 dlrm_inference local: {local['gather_pool_tbe']} TBE and "
          f"{local['gather_pool_tbe_flat']} flat launches == {EX_LOCAL}")

    # quickstart and the strategies: one spawn
    t0 = time.perf_counter()
    ranks = pt.tmesh.run_model_mesh(
        _ex_rank, EX_RANKS, device,
        args=(ex.di.strategy_args(loc),),
        timeout_s=EX_TIMEOUT_S)
    out["secs"]["ranks (spawn, quickstart, strategies)"] = \
        time.perf_counter() - t0
    del loc
    qs_err = ranks["qs"]["err"]
    check(qs_err < EX_ERR, f"9 quickstart: max |distributed - local oracle| "
                           f"{qs_err:.3e} < {EX_ERR}")
    rows = {r["label"]: r for r in ranks["di"]}
    for label, want in EX_TRAFFIC.items():
        r = rows[label]
        check(r["err"] < EX_ERR and r["traffic"] == want,
              f"9 dlrm_inference {label}: err {r['err']:.3e} < {EX_ERR}, "
              f"traffic {r['traffic']} == the reference's")
    rc = ranks["ranks"]
    check(rc[0]["qs"]["gather_pool_tbe"] == 1
          and all(c["qs"]["gather_pool_tbe"] == 0 for c in rc[1:])
          and all(c["di"][k] == EX_RANK[k] for c in rc for k in EX_RANK)
          and all(c[part][k] == 0 for c in rc for part in ("qs", "di")
                  for k in ("gather_pool", "flash_attention")),
          f"9 ranks: quickstart's oracle 1 TBE launch on rank 0, the "
          f"strategies {EX_RANK} a rank")

    # serve_batched and the plan in this process
    _reset_counts(pt, kmods)
    t0 = time.perf_counter()
    try:
        served = ex.sb.main(["--device", DEV])
        _sync(DEV)
    finally:
        restore()
    out["secs"]["serve_batched"] = time.perf_counter() - t0
    sbc = _counts(pt, kmods)
    check(len(served["lm"]) == 10 and sbc["gather_pool_tbe_flat"] >= 6
          and sbc["flash_attention"] == 0,
          f"9 serve_batched: 10 requests served, "
          f"{sbc['gather_pool_tbe_flat']} flat TBE launches (>= 6: 3 "
          f"flushes, 3 micro-batches), no flash launch (prompts under "
          f"the chunk threshold)")
    # every TBE launch shape of the path, this process's and each rank's,
    # held against the wrapper's plain version on the path's own inputs
    shapes = [("this process",) + h for h in _held(held)] + [
        (f"rank {r}",) + h for r, c in enumerate(rc) for h in c["held"]]
    for where, key, err, excess, n in shapes:
        log(f"  held {key[0]} ({where}, {n} launches): {key[1]} {key[2:]}: "
            f"max_abs_err {err:.3e} (allclose rtol={POOL_TOL['rtol']} "
            f"atol={POOL_TOL['atol']}) {'ok' if excess <= 0 else 'FAIL'}")
    check(all(excess <= 0 for *_, excess, _ in shapes),
          "9: every TBE launch shape within POOL_TOL of its plain version")
    names = ("gather_pool_tbe", "gather_pool_tbe_flat")
    out["launches"] = {k: local[k] + sbc[k] + sum(
        c[part][k] for c in rc for part in ("qs", "di")) for k in names}
    seen = {k: sum(n for _, key, _, _, n in shapes if key[0] == k)
            for k in names}
    check(seen == out["launches"],
          f"9: every TBE launch of the path went through the held "
          f"wrappers ({seen} of {out['launches']})")
    out["err"] = {k: max(err for _, key, err, _, _ in shapes
                         if key[0] == k) for k in names}
    t0 = time.perf_counter()
    ex.plan.main([])
    out["secs"]["dlrm_sharding_plan"] = time.perf_counter() - t0

    # lm_train: 300 steps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_9_")
    try:
        _reset_counts(pt, kmods)
        t0 = time.perf_counter()
        tr = ex.lt.main(EX_TRAIN + ["--device", DEV, "--ckpt-dir", tmp])
        out["secs"]["lm_train"] = time.perf_counter() - t0
        ltc = _counts(pt, kmods)
        written = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [m["loss"] for _, m in tr.metrics_log]
    step_s = [m["step_time_s"] for _, m in tr.metrics_log]
    del tr
    out["losses"] = {s: losses[s - 1] for s in EX_LOSS_STEPS}
    out["step_ms"] = 1e3 * statistics.median(step_s)
    h, v = _zipf_law(1.2, ex.lt.make_100m().vocab_size)
    spread = math.sqrt(v / (EX_BATCH * EX_SEQ))
    tail = statistics.fmean(losses[-EX_LOSS_TAIL:])
    floors = (h - EX_LOSS_SDS * spread,
              h - EX_LOSS_SDS * spread / math.sqrt(EX_LOSS_TAIL))
    out.update(entropy=h, spread=spread, tail=tail, floors=floors,
               tail_sd=statistics.stdev(losses[-EX_LOSS_TAIL:]))
    log(f"  lm_train: loss at steps {', '.join(str(s) for s in EX_LOSS_STEPS)}"
        f" {[round(v, 4) for v in out['losses'].values()]}, mean of the "
        f"last {EX_LOSS_TAIL} {tail:.4f} (their sd {out['tail_sd']:.4f}); "
        f"the stream's unigram entropy {h:.4f} nats, a batch's spread "
        f"{spread:.4f}, floors {floors[0]:.4f} (one step) and "
        f"{floors[1]:.4f} (the mean); median step {out['step_ms']:.1f} ms; "
        f"checkpoints {written}; launches "
        f"{ {k: v for k, v in ltc.items() if v} or 'none'}")
    check(floors[0] < losses[-1] < losses[0] and floors[1] < tail
          and len(losses) == EX_STEPS and all(np.isfinite(losses)),
          f"9 lm_train: {EX_STEPS} finite losses, the last "
          f"({losses[-1]:.4f}) under the first ({losses[0]:.4f}) and over "
          f"{floors[0]:.4f}, the last {EX_LOSS_TAIL}'s mean ({tail:.4f}) "
          f"over {floors[1]:.4f}")
    check(all(v == 0 for k, v in ltc.items() if k != "chunked"),
          "9 lm_train: no kernel launch (no vocabulary bag without a "
          "context; the flash wrapper refuses a tensor that needs a "
          "gradient)")
    if DEV != "cpu":
        torch.cuda.empty_cache()
    log(f"  TBE launches on the path: {out['launches']} (dlrm_inference "
        f"local {[local[k] for k in out['launches']]}, serve_batched "
        f"{[sbc[k] for k in out['launches']]}, each rank's quickstart + "
        f"strategies "
        f"{[[c['qs'][k] + c['di'][k] for k in out['launches']] for c in rc]})")
    out["strategies"] = {label: dict(err=r["err"], first_ms=r["first_ms"],
                                     second_ms=r["second_ms"])
                         for label, r in rows.items()}
    out["qs_err"], out["tiered_err"] = qs_err, tiered["err"]
    out["rank_secs"] = [c["secs"] for c in rc]
    out["secs"]["phase"] = time.perf_counter() - t_phase
    import multiprocessing

    alive = multiprocessing.active_children()
    log(f"  phase 9: {out['secs']}; rank processes alive after it: "
        f"{len(alive)}")
    check(not alive, "phase 9's rank processes all ended")
    return out


def port_namespace():
    """The port's entry points, one namespace (``src/`` on the path)."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))

    class pt:   # the port's entry points, one namespace
        from repro_torch.cache import RemoteStore
        from repro_torch.configs.dlrm import CONFIG
        from repro_torch.core import comm
        from repro_torch.core import embedding_bag as eb
        from repro_torch.core.cache_config import CacheConfig
        from repro_torch.core.jagged import JaggedBatch
        from repro_torch.core.parallel import (ProcessContext, make_context,
                                               run_ranks)
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ref
        from repro_torch.models import decode as dec
        from repro_torch.models import dlrm, layers, lm, moe
        from repro_torch.models.dlrm import init_params
        from repro_torch.analysis import (check_scheduler_source,
                                          check_timeline)
        from repro_torch.pipeline import STAGES
        from repro_torch.serving.engine import (ContinuousBatcher,
                                                CTRRequest, DLRMEngine,
                                                PipelinedDLRMEngine, Request,
                                                make_dlrm_engine)
        from repro_torch.configs.granite_8b import CONFIG as LM_CONFIG
        from repro_torch.configs.moonshot_v1_16b_a3b import \
            CONFIG as MOE_CONFIG
        from repro_torch.configs import deepseek_v3_671b
        from repro_torch.configs.hymba_1_5b import CONFIG as HYBRID_CONFIG
        from repro_torch.configs.rwkv6_1_6b import CONFIG as SSM_CONFIG
        from repro_torch.configs.whisper_base import CONFIG as AUDIO_CONFIG
        from repro_torch.configs.internvl2_2b import CONFIG as VLM_CONFIG
        from repro_torch.serving.engine import generate
        from repro_torch.models import mla, ssm
        from repro_torch import obs
        from repro_torch.obs import Telemetry
        from repro_torch.core import perf_model as pm
        from repro_torch.core import sharding_plan as sp
        from repro_torch.analysis import audit, fixtures, repo_contracts
        from repro_torch.analysis.contracts import TBE_KERNEL
        from repro_torch.data.synthetic import dlrm_batches
        from repro_torch.kernels import ops as kops
        from repro_torch.optim import (adamw_init, adamw_update,
                                       dequantize_blockwise, global_norm,
                                       rowwise_adagrad_init,
                                       rowwise_adagrad_update)
        from repro_torch.configs.base import TrainConfig
        from repro_torch.configs.granite_8b import CONFIG as LMT_CONFIG
        from repro_torch.data import Prefetcher, lm_batches
        from repro_torch.train import step as tstep
        from repro_torch.train.loop import Trainer
        from repro_torch.utils.tree import (flatten_with_paths, leaves,
                                            map_leaves)
        from repro_torch.utils.convert import (lm_params_for_rank,
                                               rank_sharded, token_slice_leaf)
        from repro_torch.launch import serve as tserve
        from repro_torch.launch import train as tlaunch
        from repro_torch.launch import mesh as tmesh
        from repro_torch.launch import specs as tspecs
        from repro_torch.core.parallel import cut_shape
        from repro_torch.core.jagged import random_jagged_batch

    return pt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import onesided_a2a as oa

    pt = port_namespace()

    # full fp32 products on the card, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_environment(build)
    x = phase_kernels(eg, oa)
    flash_err = check_flash(pt)
    contracts = phase_contracts(pt)
    unc = phase_uncached(pt, eg, oa)
    cached = phase_cached(pt, eg, oa, unc)
    # the rows of the last flush's fetch, padded: a steady-state flush
    times = phase_times(eg, oa, x, _pow2(cached["fetched"][-1]))
    times.update(times_flash(pt))
    errs, digest = x["errs"], x["digest"]
    del x                       # phase 2's tables: 13.3 GB
    torch.cuda.empty_cache()
    remote = phase_remote(pt, eg, oa, unc, cached)
    piped = phase_pipelined(pt, eg, oa, unc, cached, remote)
    planned = phase_planned(pt, eg, oa, unc, cached)
    dist = phase_distributed(pt, eg, oa, unc)
    procs = phase_ranks(pt, unc, dist)
    rprocs = phase_remote_ranks(pt, unc, remote, piped)
    held = torch.cuda.memory_allocated()
    del unc["params"]           # phase 3's tables: 13.3 GB
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_allocated()
    log(f"== phase 3's tables freed after phases 7p and 6p: "
        f"{freed / 1e9:.3f} GB")
    check(freed >= pt.CONFIG.embedding_config().table_bytes,
          "phase 3's tables freed: the rank processes released what they "
          "were sent through CUDA IPC")
    train = phase_train(pt, eg, oa)
    held = torch.cuda.memory_allocated()
    tprocs = phase_train_ranks(pt, eg, oa)
    after = torch.cuda.memory_allocated()
    log(f"== phase 7tp freed: {after / 1e9:.3f} GB allocated after it, "
        f"{held / 1e9:.3f} GB before it")
    check(after <= held + 2 ** 26, "phase 7tp's tables freed: the rank "
          "processes released what they were sent through CUDA IPC")
    lm = phase_lm(pt, (eg, oa, pt.fa))
    # phase 8's granite weights and cache are freed before phase 8m
    after = torch.cuda.memory_allocated()
    log(f"== phase 8 freed: {after / 1e9:.3f} GB allocated after it, "
        f"{held / 1e9:.3f} GB before it (peak {lm['peak_gb']:.1f} GB in it)")
    check(after <= held + 2 ** 26, "phase 8's weights and cache freed")
    held = torch.cuda.memory_allocated()
    moe = phase_moe(pt, (eg, oa, pt.fa))
    # phase 8m's moonshot weights are freed before phase 8d
    after = torch.cuda.memory_allocated()
    log(f"== phase 8m freed: {after / 1e9:.3f} GB allocated after it, "
        f"{held / 1e9:.3f} GB before it (peak {moe['peak_gb']:.1f} GB in it)")
    check(after <= held + 2 ** 26, "phase 8m's weights and cache freed")
    lprocs = phase_lm_ranks(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8p freed: {after / 1e9:.3f} GB allocated after it")
    check(after <= held + 2 ** 26, "phase 8p's weights freed: the rank "
          "processes released what they were sent through CUDA IPC")
    ltprocs = phase_lm_train_ranks(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8tp freed: {after / 1e9:.3f} GB allocated after it")
    check(after <= held + 2 ** 26, "phase 8tp's weights freed: the rank "
          "processes released what they were sent through CUDA IPC")
    dprocs = phase_dp_ranks(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8dp freed: {after / 1e9:.3f} GB allocated after it")
    check(after <= held + 2 ** 26, "phase 8dp's tables and weights freed: "
          "the rank processes released what they were sent through CUDA IPC")
    lrprocs = phase_launch_ranks(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8lr freed: {after / 1e9:.3f} GB allocated after it")
    check(after <= held + 2 ** 26, "phase 8lr's simulated weights and "
          "states freed")
    pt.MLA_CONFIG = dataclasses.replace(pt.deepseek_v3_671b.CONFIG,
                                        num_layers=DS_LAYERS)
    ds = phase_mla(pt, (eg, oa, pt.fa))
    after_ds = torch.cuda.memory_allocated()
    log(f"== phase 8d freed: {after_ds / 1e9:.3f} GB allocated after it "
        f"(peak {ds['peak_gb']:.1f} GB in it)")
    check(after_ds <= held + 2 ** 26, "phase 8d's weights and cache freed")
    hy = phase_hybrid(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8h freed: {after / 1e9:.3f} GB allocated after it "
        f"(peak {hy['peak_gb']:.1f} GB in it)")
    check(after <= held + 2 ** 26, "phase 8h's weights and cache freed")
    rw = phase_ssm(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8r freed: {after / 1e9:.3f} GB allocated after it "
        f"(peak {rw['peak_gb']:.1f} GB in it)")
    check(after <= held + 2 ** 26, "phase 8r's weights and cache freed")
    wh = phase_audio(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8w freed: {after / 1e9:.3f} GB allocated after it "
        f"(peak {wh['peak_gb']:.1f} GB in it)")
    check(after <= held + 2 ** 26, "phase 8w's weights and cache freed")
    vl = phase_vlm(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8v freed: {after / 1e9:.3f} GB allocated after it "
        f"(peak {vl['peak_gb']:.1f} GB in it)")
    check(after <= held + 2 ** 26, "phase 8v's weights and cache freed")
    lt = phase_lm_train(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 8t freed: {after / 1e9:.3f} GB allocated after it "
        f"(peak {lt['peak_gb']:.1f} GB in it)")
    # held counts the two 32 MiB cuBLAS workspaces, the main thread's and
    # the autograd engine's device thread's (phase 7t's backward made it)
    check(after <= held + 2 ** 26, "phase 8t's state freed")
    exs = phase_examples(pt, (eg, oa, pt.fa))
    after = torch.cuda.memory_allocated()
    log(f"== phase 9 freed: {after / 1e9:.3f} GB allocated after it")
    check(after <= held + 2 ** 26, "phase 9's tables, weights and state "
          "freed")

    log("== 10. summary")
    # each main path's launches, read from its own run with the counts
    # at 0 just before it; a kernel's `launches` is their sum over the
    # paths that run it, `launches_by_path` keeps each path's own count
    by_path = {
        "gather_pool_tbe": {
            "3 serving uncached": unc["launches"]["gather_pool_tbe"],
            RANK_PATH: procs["launches"]["gather_pool_tbe"],
            "7t training": train["launches"],
            TRAIN_RANK_PATH: tprocs["launches"]["gather_pool_tbe"]},
        "gather_pool": {
            "3 serving uncached, fused=False":
                unc["launches"]["gather_pool"],
            "7t training, fused=False": train["unfused_launches"]},
        "gather_pool_tbe_flat": {
            "4 serving cached": cached["launches"],
            RANK_PATH: procs["launches"]["gather_pool_tbe_flat"],
            REMOTE_RANK_PATH: rprocs["launches"]["gather_pool_tbe_flat"],
            "8 LM serving, ctx": lm["ctx"]["launches"],
            "8m MoE serving, ctx": moe["ctx"]["launches"],
            "8d MLA decode, ctx": ds["ctx"]["launches"],
            "8t LM training, ctx": lt["ctx"]["launches"],
            LM_RANK_PATH: lprocs["launches"][TBE_FLAT],
            TRAIN_RANK_PATH: tprocs["launches"][TBE_FLAT],
            LMT_RANK_PATH: ltprocs["launches"][TBE_FLAT]},
        "onesided_put_rows": {
            "6 serving remote": remote["onesided"]["launches"],
            REMOTE_RANK_PATH: rprocs["launches"]["onesided_put_rows"]},
        **{name: {"7 distributed": n} for name, n in dist["launches"].items()},
        "onesided_ring_permute": {
            "7 distributed": dist["launches"]["onesided_ring_permute"],
            REMOTE_RANK_PATH: rprocs["launches"]["onesided_ring_permute"]},
        **{name: {"7 distributed": dist["launches"][name],
                  RANK_PATH: procs["launches"][name]}
           for name in ("onesided_all_to_all", "onesided_reduce_scatter")},
        "flash_attention": {"8 LM serving": lm["launches"],
                            "8 LM serving, ctx": lm["ctx"]["flash"],
                            "8m MoE serving": moe["launches"],
                            "8m MoE serving, ctx": moe["ctx"]["flash"],
                            LM_RANK_PATH: lprocs["launches"]["flash_attention"],
                            "8h hybrid serving": hy["launches"],
                            "8v vlm forward": vl["fwd_launches"],
                            "8v vlm serving": vl["launches"],
                            TRAIN_PATH: lt["launches"]},
    }
    by_path["onesided_reduce_scatter"][TRAIN_RANK_PATH] = \
        tprocs["launches"]["onesided_reduce_scatter"]
    for name in ("gather_pool_tbe_flat", "gather_pool_tbe",
                 "onesided_all_to_all", "onesided_reduce_scatter"):
        by_path[name][DP_RANK_PATH] = dprocs["launches"][name]
    for name in ("gather_pool_tbe_flat", "flash_attention"):
        by_path[name][LR_PATH] = lrprocs["launches"][name]
    for name, n in exs["launches"].items():
        by_path[name][EXAMPLES_PATH] = n
    # LM training runs no kernel: the flash kernel has no backward, and
    # under grad attention takes chunked_attention (phase 8t checks 0)
    check(all(n > 0 for paths in by_path.values()
              for path, n in paths.items() if path != TRAIN_PATH),
          "every kernel launched on each main path that runs it")
    times.update(dist["times"])
    errs.update(dist["errs"])
    errs["flash_attention"] = max(flash_err, lm["err"], moe["err"],
                                  hy["err"], vl["err"])
    for name, err in exs["err"].items():
        errs[name] = max(errs[name], err)
    kernels = []
    for name in SOURCES:
        t = dict(times[name])
        err = max(errs[name], t.pop("max_abs_err", 0.0))
        kernels.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name],
                            launches=sum(by_path[name].values()),
                            launches_by_path=by_path[name],
                            max_abs_err=err, **t))
    log(f"uncached median flush {statistics.median(unc['flush_ms']):.3f} ms,"
        f" cached median flush {statistics.median(cached['flush_ms']):.3f} "
        f"ms, cached hit rate {cached['hit_rate']:.4f}; fused=False flush "
        f"{unc['unfused_ms']:.3f} ms; TBE device time of a flush "
        f"{unc['tbe_device_ms']['fused']:.4f} ms fused, "
        f"{unc['tbe_device_ms']['unfused']:.4f} ms in "
        f"{unc['launches']['gather_pool']} launches")
    log(f"phase-2 TBE digest {digest}")
    for backend, r in remote.items():
        log(f"remote {backend}: median flush "
            f"{statistics.median(r['flush_ms']):.3f} ms, profiled flush idle "
            f"{r['idle']:.1f}%, {r['fetches']} fetches, median fetch "
            f"{statistics.median(r['fetch_ms']):.3f} ms, put launches "
            f"{r['launches']}, peak device memory {r['peak_gb']:.1f} GB")
    for label, r in (("host", piped["host"]),
                     ("remote onesided", piped["remote"])):
        log(f"pipelined depth 2, {label}: run_to_completion "
            f"{r['wall_ms']:.3f} ms against {r['serial_ms']:.3f} ms of "
            f"serialized flushes, overlap_fraction "
            f"{r['overlap_fraction']:.4f}, hit rate {r['hit_rate']:.4f}")
    log(f"pipelined depth 2: pools {piped['host']['pool_bytes'] / 1e9:.3f} "
        f"GB, remote peak device memory {piped['remote']['peak_gb']:.1f} GB,"
        f" {piped['overflow']['fallbacks']} fallback(s) at "
        f"{piped['overflow']['slots']} slots, profiled scatter streams "
        f"{piped['profile']['scatter_streams']} vs TBE streams "
        f"{piped['profile']['tbe_streams']}, "
        f"{piped['profile']['overlap_ms']:.3f} ms of side work under forward"
        f" kernels")
    pa, pb = planned["a"], planned["b"]
    log(f"planned (6c): A serialized median flush "
        f"{statistics.median(pa['flush_ms']):.3f} ms (phase 4 "
        f"{statistics.median(cached['flush_ms']):.3f}), hit rate "
        f"{pa['hit_rate']:.4f}, latency p50/p99 "
        f"{1e3 * pa['latency']['p50']:.3f}/{1e3 * pa['latency']['p99']:.3f} "
        f"ms; B pipelined run {pb['wall_ms']:.3f} ms, hit rate "
        f"{pb['hit_rate']:.4f}, latency p50/p99 "
        f"{1e3 * pb['latency']['p50']:.3f}/{1e3 * pb['latency']['p99']:.3f} "
        f"ms, {pb['fetches']} fetches, peak {pb['peak_gb']:.1f} GB")
    log(f"planned (6c) fit: A gather_overhead_s "
        f"{pa['fit']['gather_overhead_s']:.6g}, host_Bps "
        f"{pa['fit']['host_Bps']:.6g}; B one-sided alpha_s "
        f"{pb['fit']['alpha_s']:.6g}, beta_Bps {pb['fit']['beta_Bps']:.6g}")
    log("distributed (median flush ms): " + ", ".join(
        f"{label} {statistics.median(dist[label]['flush_ms']):.3f}"
        for label, _, _ in STRATEGIES))
    log(f"distributed: row/a2a dropped per flush {dist['row/a2a/bulk']['dropped']}"
        f", onesided vs bulk {'bitwise' if dist['a2a_bitwise'] else 'within tolerance'}, "
        f"profiled a2a flush idle {dist['idle']:.1f}%, peak device memory "
        f"{dist['peak_gb']:.1f} GB")
    log("ranks as processes (7p, gloo, one card; host clock, four "
        "processes time-slicing the card): " + "; ".join(
            f"{label} median flush {max(s['median_ms']):.3f} ms (slowest "
            f"rank), fences {100 * max(s['fence_share']):.1f}%, peak "
            f"{max(s['peak_gb']):.2f} GB a rank, scores "
            + ("bitwise" if s["bitwise"] else f"max_abs_err {s['err']:.3e}")
            for label, s in procs["gloo"].items())
        + f"; NCCL leg {'run' if 'nccl' in procs else 'needs 2+ cards'}; "
        f"phase {procs['secs']:.1f} s")
    rg = rprocs["gloo"]
    log("remote tier, one host per process (6p, gloo, one card; host clock, "
        "four processes time-slicing the card): " + "; ".join(
            f"{label} {'median flush' if depth == 1 else 'run'} "
            f"{max(rg[label]['median_ms']):.3f} ms (slowest rank), median "
            f"fetch {max(statistics.median(f) for f in rg[label]['fetch_ms']):.3f}"
            f" ms, fences {100 * max(rg[label]['fence_share']):.1f}%, peak "
            f"{max(rg[label]['peak_gb']):.2f} GB a rank"
            for label, _, depth in REMOTE_LEGS)
        + f"; ring bulk/onesided {max(rg['ring bulk']['ms']):.3f}/"
        f"{max(rg['ring onesided']['ms']):.3f} ms; NCCL leg "
        f"{'run' if 'nccl' in rprocs else 'needs 2+ cards'}; phase "
        f"{rprocs['secs']:.1f} s")
    log(f"contracts (2c): all {len(contracts)} hold on the card; TBE device "
        f"kernels per fixture {contracts}")
    med = train["median"]
    log(f"training (7t): losses {[round(v, 6) for v in train['losses']]}, "
        f"median forward {med['forward']:.3f} ms, backward "
        f"{med['backward']:.3f} ms, update {med['update']:.3f} ms, device "
        f"idle {train['prof']['idle']:.1f}% of a step, peak device memory "
        f"{train['peak_gb']:.1f} GB, d tables vs float64 max_abs_err "
        f"{train['max_abs_err']:.3e} (fused=False "
        f"{train['unfused_err']:.3e}), two-run backward difference "
        f"{train['run_diff']:.3e}")
    log(f"LM serving ({pt.LM_CONFIG.name}): {lm['tokens']} tokens in "
        f"{lm['serve_s']:.3f} s ({lm['tokens'] / lm['serve_s']:.2f} tokens/s),"
        f" prefill ms by length "
        f"{[(n, round(1e3 * t, 1)) for n, t in lm['prefill']]}, median "
        f"decode step {1e3 * statistics.median(lm['decode']):.3f} ms, "
        f"flash launches {lm['launches']}, decode vs forward relative L2 "
        f"{lm['rel']:.3e} ({LONG_PROMPT} tokens), {lm['rel_short']:.3e} "
        f"({lm['short_len']} tokens), peak device memory "
        f"{lm['peak_gb']:.1f} GB, "
        f"device idle {lm['prof']['decode']['idle']:.1f}% of a decode step, "
        f"{lm['prof']['prefill']['idle']:.1f}% of a short prefill, "
        f"{lm['prof']['long_prefill']['idle']:.1f}% of a "
        f"{LONG_PROMPT}-token prefill")
    ml = moe["layer"]
    log(f"MoE serving ({pt.MOE_CONFIG.name}, {moe['n_params']:,} parameters, "
        f"{moe['nbytes'] / 1e9:.2f} GB): {moe['tokens']} tokens in "
        f"{moe['serve_s']:.3f} s ({moe['tokens'] / moe['serve_s']:.2f} "
        f"tokens/s), prefill ms by length "
        f"{[(n, round(1e3 * t, 1)) for n, t in moe['prefill']]}, median "
        f"decode step {1e3 * statistics.median(moe['decode']):.3f} ms, "
        f"flash launches {moe['launches']}, layer-1 moe_ffn relative L2 "
        f"{ml['rel']:.3e} (cap {ml['cap']}, {ml['ms']:.3f} ms at "
        f"{MOE_ROWS} rows), decode vs forward relative L2 {moe['rel']:.3e} "
        f"on the forward's routing, {moe['rel_free']:.3e} free-running "
        f"with {sum(moe['flips'])} routing flips (the decoded token in "
        f"layers {moe['last_flips']}), peak device memory "
        f"{moe['peak_gb']:.1f} GB, device idle "
        f"{moe['prof']['decode']['idle']:.1f}% of a decode step, "
        f"{moe['prof']['long_prefill']['idle']:.1f}% of a {LONG_PROMPT}-token"
        f" prefill")
    dl, da = ds["layer"], ds["attn"]
    log(f"MLA serving ({ds['n_params']:,} parameters and the MTP head's "
        f"{ds['n_mtp']:,}, {ds['nbytes'] / 1e9:.2f} GB): {ds['tokens']} "
        f"tokens in {ds['serve_s']:.3f} s ({ds['tokens'] / ds['serve_s']:.2f}"
        f" tokens/s), prefill ms by length "
        f"{[(n, round(1e3 * t, 1)) for n, t in ds['prefill']]}, median "
        f"decode step {1e3 * statistics.median(ds['decode']):.3f} ms, "
        f"chunked_attention calls {ds['chunked']}, flash launches "
        f"{ds['launches']}, layer-0 chunked route relative L2 "
        f"{da['rel']:.3e} (planted scale fault {da['rel_fault']:.3e}), "
        f"layer-{pt.MLA_CONFIG.first_k_dense} moe_ffn "
        f"relative L2 {dl['rel']:.3e} (cap {dl['cap']}, {dl['ms']:.3f} ms "
        f"at {MOE_ROWS} rows), decode vs forward relative L2 "
        f"{ds['rel']:.3e} on the forward's routing, {ds['rel_free']:.3e} "
        f"free-running with {sum(ds['flips'])} routing flips (the decoded "
        f"token in layers {ds['last_flips']}), latent cache "
        f"{ds['cache_bytes']:,} B, peak device memory {ds['init_peak_gb']:.1f}"
        f" GB in init, {ds['checks_peak_gb']:.1f} in checks, "
        f"{ds['peak_gb']:.1f} serving, device idle "
        f"{ds['prof']['decode']['idle']:.1f}% of a decode step, "
        f"{ds['prof']['long_prefill']['idle']:.1f}% of a {LONG_PROMPT}-token"
        f" prefill")
    for label, r in (("hybrid", hy), ("ssm", rw)):
        cfg = pt.HYBRID_CONFIG if label == "hybrid" else pt.SSM_CONFIG
        log(f"{label} serving ({cfg.name}, {r['n_params']:,} parameters, "
            f"{r['nbytes'] / 1e9:.2f} GB): {r['tokens']} tokens in "
            f"{r['serve_s']:.3f} s ({r['tokens'] / r['serve_s']:.2f} "
            f"tokens/s), prefill ms by length "
            f"{[(n, round(1e3 * t, 1)) for n, t in r['prefill']]}, median "
            f"decode step {1e3 * statistics.median(r['decode']):.3f} ms, "
            f"flash launches {r['launches']}, decode vs forward relative L2 "
            + ", ".join(f"{v:.3e} ({n} tokens)"
                        for n, v in r["rel"]["bf16"].items())
            + " (f32: " + ", ".join(f"{v:.3e}"
                                    for v in r["rel"]["f32"].values())
            + f"), cache {r['row_bytes']:,} B of rows and {r['state_bytes']:,}"
            f" B of states, peak device memory {r['checks_peak_gb']:.1f} GB "
            f"in checks, {r['peak_gb']:.1f} serving, device idle "
            f"{r['prof']['decode']['idle']:.1f}% of a decode step, "
            f"{r['prof']['long_prefill']['idle']:.1f}% of a {LONG_PROMPT}-"
            f"token prefill; phase {r['secs']:.1f} s")
    mb, rl = hy["mamba"], rw["layer"]
    log(f"hybrid checks: flash on real q/k/v max_abs_err "
        + ", ".join(f"{e:.3e} (window {w})" for w, e in hy["flash"].items())
        + f"; layer-0 mamba_forward vs the stepped recurrence relative L2 "
        f"h_final {mb['rel_h']:.3e}, output {mb['rel_y']:.3e}; vs "
        f"mamba_decode_step output {mb['dec_y']:.3e}, h_final "
        f"{mb['dec_h']:.3e} (planted fault {mb['fault_y']:.3e}, "
        f"{mb['fault_h']:.3e}); ssm check: layer-0 "
        f"chunked vs scan max_abs_err output {rl['err_y']:.3e}, state "
        f"{rl['err_s']:.3e}, largest -log P {rl['nlogp']:.3f}")
    log(f"audio serving ({pt.AUDIO_CONFIG.name}, {wh['n_params']:,} "
        f"parameters, {wh['nbytes'] / 1e9:.3f} GB): generate(frames=) "
        f"{wh['tokens']} tokens in {wh['gen_s']:.3f} s "
        f"({wh['tokens'] / wh['gen_s']:.2f} tokens/s), encoder "
        f"{wh['enc_ms']:.3f} ms, prefill {wh['prefill_ms']:.3f} ms, median "
        f"decode step {wh['step_ms']:.3f} ms ({CLIPS} clips), the cross K/V "
        f"projections {wh['cross_ms']:.3f} ms ({100 * wh['cross_share']:.1f}%"
        f" of a step's device busy time), flash launches 0, decode vs "
        f"forward relative L2 {wh['rel']:.3e} ({wh['seq']} tokens; f32 "
        f"{wh['rel_f32']:.3e}), prefill's enc bitwise forward's, peak "
        f"device memory {wh['peak_gb']:.2f} GB, device idle "
        f"{wh['prof']['idle']:.1f}% of a decode step; phase "
        f"{wh['secs']:.1f} s")
    log(f"vlm ({pt.VLM_CONFIG.name}, {vl['n_params']:,} parameters, "
        f"{vl['nbytes'] / 1e9:.2f} GB): forward(patches=) of {LONG_PROMPT} "
        f"positions {vl['fwd_ms']:.3f} ms ({vl['fwd_launches']} flash "
        f"launches, layer-0 kernel vs plain max_abs_err {vl['err']:.3e}, "
        f"device idle {vl['fwd_prof']['idle']:.1f}%, peak "
        f"{vl['fwd_peak_gb']:.2f} GB), projector vs float64 relative L2 "
        f"{vl['proj']:.3e}; text serving {vl['tokens']} tokens in "
        f"{vl['serve_s']:.3f} s ({vl['tokens'] / vl['serve_s']:.2f} "
        f"tokens/s), prefill ms by length "
        f"{[(n, round(1e3 * t, 1)) for n, t in vl['prefill']]}, median "
        f"decode step {1e3 * statistics.median(vl['decode']):.3f} ms, "
        f"flash launches {vl['launches']}, decode vs prefill relative L2 "
        f"{vl['rel']:.3e} ({vl['short_len']} tokens; f32 "
        f"{vl['rel_f32']:.3e}), peak device memory {vl['peak_gb']:.1f} GB "
        f"serving, device idle {vl['prof']['decode']['idle']:.1f}% of a "
        f"decode step, {vl['prof']['long_prefill']['idle']:.1f}% of a "
        f"{LONG_PROMPT}-token prefill; phase {vl['secs']:.1f} s")
    lg, lr_, ll = lt["grad"], lt["resume"], lt["long"]
    log(f"LM training ({pt.LMT_CONFIG.name}, {lt['n_params']:,} parameters,"
        f" int8 moments, state {lt['state_bytes'] / 1e9:.2f} GB): losses "
        f"{[round(v, 4) for v in lt['losses']]}, grad norms "
        f"{[round(v, 4) for v in lt['gnorms']]}, median step "
        f"{lt['med_s']:.3f} s ({lt['tokens_s']:.1f} tokens/s at "
        f"{LMT_BATCH} x {LMT_SEQ}), forward + backward {lt['fb_ms']:.1f} ms,"
        f" update {lt['upd_ms']:.1f} ms, device idle "
        f"{lt['prof']['idle']:.1f}% of a step, peak device memory "
        f"{lt['peak_gb']:.2f} GB, flash launches {lt['launches']}; card vs "
        f"CPU loss {lg['loss_rel']:.3e}, gradient norm "
        f"{lg['norm_rel']:.3e}, gradients {lg['grad_rel']:.3e}, "
        f"parameters {lg['param_rel']:.3e}, moments m {lg['m_rel']:.3e} v "
        f"{lg['v_rel']:.3e}, codes differing {lg['codes_differ']:.3e}; "
        f"resume bitwise, checkpoint {lr_['ckpt_bytes']:,} B; "
        f"{LONG_TRAIN_TOKENS} tokens: {ll['step_s']:.3f} s, chunked_attention"
        f" calls {ll['chunked']}, flash launches {ll['launches']}, peak "
        f"{ll['peak_gb']:.2f} GB, chunked vs full gradients "
        f"{ll['grad_rel']:.3e}; deepseek-v3-671b at 1 dense layer and the "
        f"MTP head, losses {[round(v, 4) for v in lt['mla']['losses']]}, "
        f"step 1 {'bitwise' if lt['mla']['bitwise'] else 'within'} "
        f"{lt['mla']['rel']:.3e} of the no-grad loss, the update at most "
        f"{lt['mla']['update']:.4f} of its bound, state "
        f"{lt['mla']['state_gb']:.2f} GB, peak {lt['mla']['peak_gb']:.2f} GB"
        f"; phase {lt['secs']:.1f} s")
    lc, mc, dc, tcx = lm["ctx"], moe["ctx"], ds["ctx"], lt["ctx"]
    log(f"LM under make_context({CTX_RANKS}): granite prefill logits bitwise"
        f" the local run's, decode relative L2 {lc['rel']:.3e} over "
        f"{lc['rel_steps']} steps, greedy tokens that differ "
        f"{lc['differ']}, prefill ms local/ctx "
        f"{[round(1e3 * t, 1) for _, t in lc['prefill']['local']]}/"
        f"{[round(1e3 * t, 1) for _, t in lc['prefill']['ctx']]}, median "
        f"decode step local/ctx {1e3 * lc['decode']['local']:.3f}/"
        f"{1e3 * lc['decode']['ctx']:.3f} ms (idle {lc['idle']['local']:.1f}"
        f"/{lc['idle']['ctx']:.1f}%); moonshot moe_ffn_ep card vs "
        f"CPU {mc['ep']['rel']:.3e} (drops {mc['ep']['dropped']}), "
        f"{LONG_PROMPT}-token prefill {1e3 * mc['prefill_s']:.1f} ms "
        f"(moe_dropped {mc['dropped'][0]}), decode {mc['tokens_s']:.2f} "
        f"tokens/s (moe_dropped per step {mc['dropped'][1:]}); deepseek "
        f"sharded MLA decode attention vs whole {dc['attn_rel']:.3e}, "
        f"moe_dropped per step {dc['dropped']}; granite train step loss "
        f"{tcx['loss']!r} bitwise, {tcx['step_s']:.3f} s, peak "
        f"{tcx['peak_gb']:.2f} GB; resume under the context bitwise")
    lg_, lm_, ld_ = lprocs["granite"], lprocs["moe"], lprocs["ds"]
    moe_logits = "bitwise" if lm_["bitwise"] else f"within {lm_['rel']:.3e}"
    ds_logits = "bitwise" if ld_["bitwise"] else f"within {ld_['rel']:.3e}"
    ds_tokens = "equal" if ld_["flip"] > CTX_NEW else \
        f"differ first at {ld_['flip']}"
    log(f"LM serving with each rank a process (8p, gloo, {LMP_RANKS} "
        f"processes on one card; host clock): granite-8b at "
        f"{LMP_GRANITE_LAYERS} layers bitwise the simulated ranks, median "
        f"decode step {max(lg_['decode_ms']):.3f} ms (slowest rank; "
        f"simulated {lg_['sim_decode_ms']:.3f}), long prefill "
        f"{max(max(t for n, t in p if n == LONG_PROMPT) for p in lg_['prefill']) * 1e3:.1f}"
        f" ms, peak {max(lg_['peak_gb']):.2f} GB a rank; moonshot at "
        f"{LMP_MOE_LAYERS} layers logits {moe_logits}, "
        f"prefill {max(lm_['prefill_ms']):.1f} ms, median decode step "
        f"{max(lm_['decode_ms']):.3f} ms (simulated "
        f"{lm_['sim_decode_ms']:.3f}), peak {max(lm_['peak_gb']):.2f} GB a "
        f"rank; deepseek-v3-671b at {LMP_DS_LAYERS} layers logits "
        f"{ds_logits}, greedy tokens {ds_tokens}, prefill {max(ld_['prefill_ms']):.1f} ms, median decode step "
        f"{max(ld_['decode_ms']):.3f} ms (simulated "
        f"{ld_['sim_decode_ms']:.3f}), peak {max(ld_['peak_gb']):.2f} GB a "
        f"rank; NCCL leg {'run' if 'nccl' in lprocs else 'needs 4 cards'}; "
        f"phase {lprocs['secs']:.1f} s")
    log("DLRM training with each rank a process (7tp, gloo, one card; host "
        "clock, the processes time-slicing the card): " + "; ".join(
            f"{label} losses within {v['loss_rel']:.3e} of the reference "
            f"flow's, the gradient on a fixed cotangent within "
            f"{v['cot_rel']:.3e} ({v['cot_ratio']:.3f} of its bound; the "
            f"flow's step 1 {v['grad_rel']:.3e}, the "
            f"rows' change {v['rows_rel']:.3e}), "
            f"median step "
            f"{max(v['step_ms']):.1f} ms (slowest rank), peak "
            f"{max(v['peak_gb']):.2f} GB a rank"
            for label, v in tprocs["summary"].items())
        + f"; phase {tprocs['secs']:.1f} s")
    tg, tm = ltprocs["granite"], ltprocs["moe"]
    log(f"LM training with each rank a process (8tp, gloo, {LMTP_RANKS} "
        f"processes on one card; host clock): granite-8b at "
        f"{LMTP_GRANITE_LAYERS} layers, {LMT_SEQ} tokens, losses "
        f"{tg['losses']} (simulated "
        f"within {tg['loss_rel']:.3e}), grad norms within "
        f"{tg['norm_rel']:.3e}, parameters within {tg['param_rel']:.3e}, "
        f"steps {max(max(s) for s in tg['step_s']):.3f} s (slowest), peak "
        f"{max(tg['peak_gb']):.2f} GB a rank; moonshot at {LMTP_MOE_LAYERS} "
        f"layers, {LMTP_MOE_SEQ} tokens, losses {tm['losses']} (within "
        f"{tm['loss_rel']:.3e}), grad "
        f"norms within {tm['norm_rel']:.3e}, parameters within "
        f"{tm['param_rel']:.3e}, steps "
        f"{max(max(s) for s in tm['step_s']):.3f} s, peak "
        f"{max(tm['peak_gb']):.2f} GB a rank; resume bitwise; phase "
        f"{ltprocs['secs']:.1f} s")
    df = dprocs["flush"]
    log(f"(dp, tp) = ({DPP_DP}, {DPP_TP}) meshes with each rank a process "
        f"(8dp, gloo, {DPP_WORLD} processes on one card; host clock): "
        + "; ".join(f"{label} median flush {max(v['median_ms']):.3f} ms "
                    f"(slowest rank), pCTR within {v['err']:.3e}"
                    for label, v in df.items())
        + f"; DLRM training losses within {dprocs['train']['loss_rel']:.3e},"
        f" steps {max(max(s) for s in dprocs['train']['step_s']):.3f} s "
        f"(slowest); NCCL leg "
        f"{'run' if 'nccl' in dprocs else f'needs {DPP_WORLD} cards'}; "
        f"phase {dprocs['secs']:.1f} s")
    ls, lt8 = lrprocs["serve"], lrprocs["train"]
    log(f"the launchers over a ({LR_DP}, {LR_TP}) mesh of processes (8lr, "
        f"gloo, {LR_WORLD} processes on one card; host clock): "
        f"{pt.LM_CONFIG.name} served at {LR_SERVE_LAYERS} layers, "
        f"logits within {ls['rel']:.3e} of the simulated ranks' (near-tie: "
        f"{ls['tie']}), median prefill {[round(v, 1) for v in ls['prefill_ms']]}"
        f" ms and decode step {[round(v, 3) for v in ls['decode_ms']]} ms a "
        f"rank, peak {[round(v, 2) for v in ls['peak_gb']]} GB a rank; "
        + "; ".join(f"train {label} losses within {v['loss_rel']:.3e}, "
                    f"steps up to {max(max(x) for x in v['step_s']):.3f} s, "
                    f"peak {max(v['peak_gb']):.2f} GB a rank"
                    for label, v in lt8.items())
        + f"; NCCL leg {'run' if 'nccl' in lrprocs else f'needs {LR_WORLD} cards'}"
        f"; phase {lrprocs['secs']:.1f} s")
    exl = exs["losses"]
    log(f"the examples (9; strategies on a (1, {EX_RANKS}) mesh of "
        f"processes, host clock): quickstart max |distributed - oracle| "
        f"{exs['qs_err']:.3e}; tiered engine {exs['tiered_err']:.3e} off "
        f"the uncached forward; "
        + ", ".join(f"{label} err {v['err']:.3e} first/second forward "
                    f"{v['first_ms']:.1f}/{v['second_ms']:.1f} ms"
                    for label, v in exs["strategies"].items())
        + "; lm_train loss " + ", ".join(f"step {k} {v:.4f}"
                                          for k, v in exl.items())
        + f", mean of the last {EX_LOSS_TAIL} {exs['tail']:.4f} (unigram "
        f"entropy {exs['entropy']:.4f}, floors {exs['floors'][0]:.4f} and "
        f"{exs['floors'][1]:.4f}), "
        f"median step {exs['step_ms']:.1f} ms; "
        f"phase {exs['secs']['phase']:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
