#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device and builds the
kernels from horovod_tpu_torch/csrc/ at first use. Phases, each fatal
on failure:

  1. the card's name and power limit, then the build of every kernel
     source (flash_fwd.cu, flash_fwd_sm90.cu, flash_fwd_sm90_dyn.cu,
     flash_bwd.cu, flash_bwd_sm90.cu, flash_dyn.cu, batch_norm.cu,
     segment_stats.cu) and its time, and beside it the wgmma/TMA sources
     (forward B1, B2, B3: 30 instantiations, d 16-256; the run-time-d
     forward above 256: 12, slice width x walk x warpgroups; backward B4,
     B5: 14, d 16-256), the fp32 CUDA-core forward (15, d x walk), the
     run-time-d
     kernels and the stats kernel each alone through nvcc -Xptxas -v: each
     instantiation's registers and spills, where any spill fails the run,
     and ptxas's performance warnings (C7514/C7520, "wgmma serialized"),
     printed (any of C7514/C7515/C7520 fails the run);
  2. every flash-attention forward kernel (online, lazy, twopass) held
     against its plain PyTorch version walking the same tiles on the card,
     on O and lse, in bf16 and fp32, causal and not, on unit-scale inputs
     at the serving shape (b=1, h=6, d=128, s=128 and 1024), at b=2 h=12
     d=64 s=512, on a ragged causal s=1000 (unpadded) and on rising-max
     adversaries (b=1 h=6 d=128 s=512, keys ramped so every k tile raises
     the row max in lazy's diagonal-first walk, or in the ascending one);
     then the bf16 wgmma/TMA kernel (online, lazy, twopass) at every head
     dim (16/32/64/128, b·h 3, s 192), at s 960 and 192 (multiples of 64,
     not of 128) with b·h >= 2, non-causal sk != sq, both CTA shapes
     forced (64 and 128 query rows) with the adversaries at its 128-key
     tiles, at s 16, 64, 100 and 1000 and sq 100 x sk 300 (partial last
     tiles; causal and not, both CTA shapes), and at the training shape
     (b=16 h=6 d=128 s=1024, causal), and at d 256 (64-key tiles, both
     CTA shapes, causal and not, s 192, the partial last tiles of sq 200,
     sq 1000 and sq 100 x sk 300, the rising-max adversaries for each walk
     order); then the fp32 CUDA-core forward and
     backward at partial-tile lengths (s 100, sq 100 x sk 300), and both
     dtypes at head dims 80 and 96 (zero-padded to 128 on the host) through
     the public autograd path against the plain walks at the true head
     dim; then head dims 160, 192, 224 and 256 (bf16 forward and backward
     on the wgmma kernels, fp32 forward and backward on the CUDA-core
     kernels), forward and backward, at partial-tile lengths, every
     forward walk at d 256, and a ring pair's call patterns (non-causal
     forward; the backward under a merged lse with +1e30 rows, those
     rows' dq exactly 0; a wholly future pair with 1e3-offset keys
     exactly 0) at b4 h6 d128 s1024 bf16, fp32 and d 256. fp32 is held to
     2e-5;
     bf16 O to two bf16 ulps plus 1 % of its largest value, bf16 lse to
     1e-3. Then the backward kernels (dq, dk/dv: bf16 on wgmma/TMA, fp32
     on the CUDA cores) on dq, dk and dv against their plain versions at
     the kernels' own tiles (fa.bwd_kernel_blocks), on unit-scale inputs
     and dO, in bf16 and fp32, causal and not, at the same shapes, a
     partial tile (s=48), the rising-max adversaries, the training shape
     (b=16 h=6 d=128 s=1024, bf16, causal), and the ragged s=1000
     (unpadded) through the autograd path; then the bf16 wgmma/TMA pair
     alone at every head dim, both dq CTA shapes forced (with the
     adversaries), partial last
     tiles with b·h >= 2 (s 960, 1000), non-causal sq != sk both ways and
     the training shape, and at d 256 (64 x 64 walks: s 192, the partial
     last tiles of s 1000 and sq 192 x sk 320 and 320 x 200, the
     rising-max adversaries for each walk order, causal and not, and b4
     h6 s1024); fp32 to rtol 1e-4 / atol 1e-5, bf16 to two ulps
     plus 1 % of that gradient's largest magnitude. Then the fp32
     register-blocked forward (flash_fwd.cu) at every compiled head dim
     (16, 32, 64, 128, 256), every walk, at s 192, partial last tiles,
     sq != sk and (d 128, 256) the rising-max adversaries. Then the head
     dims above 256: d 288, 384, 512 and 1024, fp32 and bf16, every
     forward walk, dq and dk/dv at partial last tiles, sq != sk, causal
     and not, with the rising-max adversaries: the bf16 forward on the
     run-time-d wgmma kernel (flash_fwd_sm90_dyn.cu, 64-key tiles, both
     CTA shapes where 128 rows fit), the fp32 forward and the backward on
     flash_dyn.cu with the accumulators in shared memory and in the
     device workspace (the forward's for fp32 only); bf16 d 1088, above
     the wgmma kernel's ceiling, on flash_dyn.cu's forward; d 288 (and
     bf16 d 300, zero-padded to 304) through the public autograd path.
     Then the
     BatchNorm statistics kernels (B6 moments, B7 moments2) against their
     plain versions, both held to a float64 sum on the card within 1e-5
     of the per-channel sum of magnitudes, in bf16 and fp32, on
     unit-scale and 1e3-offset inputs (never zeros), at every (rows, C)
     of a ResNet-50 step at batch 32 x 224 and at ragged shapes. Then the
     numerics plane's stats kernel (segment_stats.cu) against float64 and
     its plain version, fp32 and bf16: each of the flagship's fusion
     buckets with NaN, +-inf and zeros planted (aligned and one element
     in), a layout with empty and sub-chunk slices, and one 607.6 MB
     slice; counts exact, L2, max-abs and checksum within 1e-6 relative;
  3. the serving path: ServeEngine over GPT-2-small (gpt2_small_tpu, 6 x
     128 heads, full width, bf16, seeded weights) answers requests with
     prompts of 16-960 tokens, so prefill runs both the one-tile (online)
     and the multi-tile (lazy) walk of the wgmma kernel; a second short
     run under
     HVD_FLASH_VARIANT=twopass drives the twopass kernel. Launch counts
     are zeroed just before each run and read just after. Every request
     must complete with no KV block leaked; first-token logits of the
     kernel path must match the plain path; in fp32 the cached greedy
     tokens must equal no-cache greedy;
  3b. training: init() on NCCL (an allreduce, a broadcast and an
     allgather of CUDA tensors must be exact), then the flagship
     (gpt2_small_tpu, flash, tied embeddings, bf16 logits) at batch 16 x
     seq 1024, full width and depth, fp32 master weights,
     DistributedOptimizer(AdamW(3e-4, mu_dtype=bf16)): 10 steps on one
     repeated batch, launch counts zeroed before and read after each step
     (exactly 12 lazy forwards, 12 wgmma dq and 12 wgmma dk/dv launches),
     the loss
     finite and falling; then one step's gradients at batch 2 on the
     kernel path against the same step with every launch replaced by its
     plain version (bf16 against each gradient's scale, and fp32 under
     each forward walk: lazy, online and twopass);
  3c. the vision path: ResNet-50 with norm_impl="tpu" (bf16, fp32
     masters, seeded weights) trained through synthetic_benchmark's
     build_step (DistributedOptimizer(SGD(0.01, momentum=0.9)),
     make_data_parallel_step) for 10 steps at batch 32 x 224 on one
     seeded random batch with random labels: the loss finite and falling,
     exactly 53 moments and 53 moments2 launches and no layout copy every
     step; then a batch-2 step's gradients on the kernel path against the
     plain path (bf16: the loss within 5 %, each gradient within 0.25 of
     its L2 norm; fp32: every element within 1e-4 of that gradient's
     largest magnitude, TF32 off, cuDNN deterministic);
  3d. the parallel path on one card: the flagship through
     make_gspmd_multi_step on a one-card mesh (its DeviceMesh over NCCL,
     parameters placed by param_specs), 10 steps on phase 3b's batch from
     the same seed: 12+12+12 launches every step, the loss falling and
     equal to make_multi_step's within 2^-8; ring_flash_attention at the
     model's attention width (h 6, d 128, bf16, causal), global s 4096
     over W = 4 ranks as threads of this process on the one card (NCCL
     refuses two ranks on one device), b 4, forward and backward, against
     flash_attention on the whole sequence and the plain ring;
     ring_attention (W = 4) and ulysses_attention (W = 2: 6 heads do not
     split over 4, which is refused) forward against exact attention;
     chunked_softmax_cross_entropy (vocab 50304, chunk 8192) against the
     full loss, value and gradients;
  3e. head dim 256 through the user's entry points: the flagship's
     width (d_model 768, vocab 50304) over 3 heads of 256 serves, at the
     full depth of 12 layers, four requests (prompts 16-100: the online
     and lazy walks) and one more under HVD_FLASH_VARIANT=twopass, then,
     depth cut to 2 layers, trains 4 steps at batch 16 x seq 1024 through
     make_gspmd_multi_step on the one-card mesh. Launch counts are zeroed
     just before and read just after: each of the wgmma forward's walks
     (flash_fwd_{online,lazy,twopass}) and the wgmma backward
     (flash_bwd_sm90_{dq,dkv}) must have launched and nothing else (no
     CUDA-core kernel); the same requests served again by the 2-layer
     model in fp32, and one batch-2 gradient of its loss, must launch each
     CUDA-core forward walk (flash_fwd_cc_*) and the CUDA-core backward
     (flash_bwd_cc_{dq,dkv}) and nothing else; the loss must fall, and the first
     batch's loss on the kernel path at 12 layers must equal the plain
     path's within 2^-8; then the same over 2 heads of 384, served and
     trained at 2 layers, on the run-time-d kernels (the bf16 forward on
     wgmma, flash_fwd_sm90dyn_*; the backward flash_bwd_dyn_*);
  3f. serving on the tensor-parallel mesh: GPT-2-small (bf16, full width
     and depth) served by tp engines of 2, 3 and 4 ranks, the ranks
     threads of this process on the one card (at tp 4 the 6 heads do not
     split: every rank computes all of them, the KV cache replicated),
     the phase-3 requests (each cut to its first 16 tokens, for time)
     and a twopass run, held to the unsharded
     engine: prefill logits of every request within two bf16 ulps plus
     1 % of the largest |logit|, token agreement printed, KV bytes per
     rank (at least 1.9x below at tp 2), resharding_report empty, a
     decode step's collectives exactly 2 · layers activation all-reduces
     and one logits gather, the prefill kernels each rank launched; the
     tiny fp32 model at tp 2 token for token;
  3g. the collective backends on 4 thread ranks as slices 2 x chips 2:
     hierarchical_allreduce, ring_all_reduce and the flat sum of the
     flagship's gradient set (151.9M fp32 elements), exact on
     integer-valued inputs and within 1e-6 of the magnitudes' sum on
     unit-scale ones, each timed; one DistributedOptimizer(AdamW)
     flagship step per rank under no flag, HOROVOD_RING_ALLREDUCE and
     HOROVOD_HIERARCHICAL_ALLREDUCE, the operation manager's selections
     counted, the averaged gradients and parameters equal to the
     flag-less route's;
  3h. the eager coordination core: (a) at world 1 over NCCL, two bursts
     of 64 named allreduces (fp32/bf16/int32, integer valued) produced
     on a side stream behind a chain of matmuls, fused into exactly the
     groups plan_buckets predicts, every sum exact, bucket_stats of the
     fused results equal to the per-tensor stats; allgather, broadcast,
     broadcast_object, a duplicate name refused, a stalled collective
     warned and failed at its deadline, a timeline with the NEGOTIATE
     and ALLREDUCE spans; (b) 2 processes on the one card (gloo data
     plane over CUDA tensors, HMAC control plane): 16 names submitted in
     opposite orders, a subset submission reported stalled, a rank that
     exits unannounced failing the other's pending handle with
     RanksLostError, every join under a deadline (on a track of its own
     in the process lane, see 3j); (c) the --eager-allreduce
     paths of train_lm (the flagship) and synthetic_benchmark (ResNet-50,
     norm_impl tpu) 10 steps each: losses falling, 12+12+12 and 53+53
     launches a step, the parameters after 3 steps equal to the
     DistributedOptimizer route's within 2e-5 of each tensor's largest
     magnitude, ms/step, device ms and busy share against that route at
     HOROVOD_CYCLE_TIME 5 and 0;
  3i. the quantized and sparse wire, the checkpoint plane and the elastic
     drill, each part under its own deadline: (a) int8 and fp8
     encode/decode over the flagship's fp32 gradient buckets (607.6 MB)
     and ragged lengths (a pad tail, an all-zero block, a block at
     +-448), payload bytes and scales bit-equal to the same functions on
     the CPU, device ms per bucket and in all; (b) `python -m
     horovod_tpu_torch.run -np 2` on the one card (gloo between two
     processes, over CUDA tensors) with train_lm --eager-allreduce, the
     flagship at full width with its depth cut to 4 layers, 8 steps
     (a warm-up window of 4 and a timed one) under
     HOROVOD_COMPRESSION none, bf16, int8 and fp8: 4+4+4 launches a
     step on each rank, losses falling, encoded wire bytes a step at
     most 0.26 of the fp32 gradient bytes, rank 0's last quantized bucket
     (error feedback applied on both ranks) equal to
     stacked_wire_allreduce of both ranks' compensated inputs, ms/step
     per codec and the four runs' seconds; (c) word2vec --eager on 2
     ranks through hvdrun, in (b)'s launch, 200 steps: the loss falls, to_dense of the grouped sparse allreduce
     within 1e-6 of the dense allreduce of the densified gradients, 2
     fused allgather groups a step; (d) the flagship's full-depth state
     (1.5 GB) through CheckpointManager (blocking part and whole save,
     restore, bit-equal), and the elastic drill (run/drill.py: the
     supervisor over hvdrun over train_lm's GSPMD step at the flagship's
     width, depth cut to 2 layers): SIGTERM after step 3 -> exit 45 ->
     same-slot resume, SIGKILL of rank 1 after step 6 -> the liveness
     ledger confirms the loss -> exit 44 -> shrink to one
     rank -> resume of the 2-rank checkpoint, to step 10, every restore
     crc-verified and equal to the saving ranks' digest, each restart's
     recovery time printed; the drill runs in the process lane (see
     3j), so its recovery times are taken beside the untimed checks;
  3j. the collectives' op and axis_name, the launch plane, the overlap
     plane and checkpointing on the tp mesh, each part under its own
     deadline: (a) at world 1 over NCCL allreduce with op sum, average,
     min and max (over 'dp'; sum and average over every worker too),
     allgather and broadcast over 'dp', each exact; (a, b) run(fn,
     num_proc=2) on the one card (gloo between two processes): min, max
     and sum over 'dp' exact on int32, results in rank order, 3 flagship
     steps at depth 2 with losses equal on both ranks, a worker's
     exception reported at the launcher with its rank, and whether
     cloudpickle imports; (c) two train_lm --steps processes with only
     mpirun's env and HVD_RENDEZVOUS_DIR: both finish with equal losses,
     the rendezvous file removed, whether mpirun is on PATH, whether their
     losses equal (a, b)'s; (d) the
     flagship eager step at full size at world 1 with
     HOROVOD_OVERLAP_EAGER 0 and 1: fp32 masters bit-equal after 3
     steps, ready flushes only with it on, ms/step (best of 3 windows of
     10), enqueue and exposed drain ms; then 2 ranks on the card at depth
     2, masters bit-equal to the barrier run's, ms/step; (e) train_lm
     --tp 2 --steps 6 at depth 2 on 2 ranks, SIGTERM during step 3
     (emergency save, exit 45) beside an uninterrupted tp-2 run, resumed
     at tp 2 (the later losses bit-equal) and at dp 2 (within 2^-8),
     save (blocking, whole) and restore ms; the phase's seconds.
     The process lane: 3i's drill, (c) and (a, b)'s two ranks, in that
     order, on a thread (each started once the card has 30 GB free), and
     3h (b)'s two small processes on another, run beside the checks that
     record no time (3b-3d, 3g, 3h (a), 3i (a), (a) at world 1, 3k (b,
     c)), which therefore run after 3e and 3f (these set
     HVD_FLASH_VARIANT for a while, and the lane's ranks take this
     process's environment); the lane is joined before 3h (c), and 3h
     (c), the checkpoint of 3i, 3i (b, c), (d), (e), 3k (a) and (d) run
     after it, each with the card and the host alone; the lane's seconds
     by job, the free memory at each job's start and the lowest free
     memory while it ran are printed;
  3k. the observability planes: (a) the flagship eager step at full size
     at world 1 over NCCL, 10 steps with the metrics, tracing, history
     and alert planes on: the port's MetricsServer scraped over localhost
     and parsed (flush cycles and fusion totals above 0, the tensors the
     flushes drained equal to the gradients enqueued, the fusion
     planner's tensors equal to the gradients times the plan misses),
     every gradient of the last step with a closed enqueue -> negotiate
     -> fusion -> execute -> callback span tree (each stage's median and
     p99 ms, and first enqueue to last callback), the history segments
     read back; then the same 10 steps from the same seed with every
     plane off (fp32 masters bit-equal) and ms/step both ways over
     interleaved windows (on, off, off, on); (b) run(fn, num_proc=2) on
     the one card over gloo at depth 2 with HVD_METRICS_PORT: rank 0's
     /metrics.json aggregate covers both ranks, and a stall forced on
     rank 1 leaves rank 0's own flight dump and rank 1's dump solicited
     over the negotiation wire; (c) the same two ranks under
     HVD_CHAOS_SPEC (a 20 % response loss, a fixed seed): 3 steps with
     masters bit-equal to (b)'s and injections above 0; (d) GPT-2 small
     serving 8 requests at prompt 960 with request tracing: each result's
     trace id and phase_ms summing to its total, the phases' p50 and
     p99; the phase's seconds;
  3l. (run after phase 4's timings: its loader and RPC threads touch
     the card, and the profiler's readings are left alone) the fleet and
     router planes on GPT-2 small (tied embeddings, bf16, full width and
     depth), 2 replicas of 4 slots, max_len 1024, kv block 16: (a)
     route_lm.route_workload under least_loaded, then round_robin, on
     route_lm's seeded workload (12 requests, prompts
     16-960, 8 or 40 new tokens): every request completes, no KV block
     leaks, the split between replicas, every temperature-0 request's
     tokens equal to one engine serving it alone (where they part, the
     top-2 logit gap at the first differing step within 2 bf16 ulps of
     the top logit: a tie, printed), TTFT and inter-token p50/p99,
     tokens/s, each arm's wall time; (b) trainer.Checkpointer(publish=
     True) publishes the served tree as generation 1, each replica boots
     through WeightSubscriber.load_initial, and phase 3b's trained
     weights in bf16 are published as generation 2 with requests in
     flight; the replicas load it in the background (pinned memory, a
     copy stream of their own, a CUDA event the engine waits on) and a
     CanaryController (50 %, a window of 4) gates the swaps, fed only
     requests submitted once every loader has finished and each replica
     decodes one generation: its decision and evidence, every fleet_swap
     with inflight >= 1, each
     swapped replica's requests that crossed its swap equal to
     generation 1 served alone and its first generation-2 requests equal
     to generation 2 served alone, both prefill kernels launched on both
     generations, every engine back to one generation; the swap phases
     (detect -> loaded -> armed -> swapped) in ms, router step ms while a
     loader runs against before the publish, device memory with one and
     with two generations resident; (c) replica 1 declared lost
     (Router.on_ranks_lost, twice) with requests in flight: its orphans
     rerouted exactly once, completed on the survivor with the tokens of
     serving them alone; one SpawnReplicaRequest sent twice over
     ReplicaSupervisorClient under a chaos rule that also duplicates its
     delivery spawns exactly one replica, which then serves; the flash
     launches of the routed runs alone (the counts set to 0 before each
     and read after it; the solo references and tie checks count
     nowhere), added to the kernels line's B1 and B2 counts, and the
     phase's seconds;
  4. timings, each printed with the card's name and power limit: the
     kernels against their bounds, plain versions and the library call
     (SDPA forward and backward; the backward pair, its sum and SDPA's
     backward by CUDA events over 50 back-to-back calls and by profiler,
     the event figure kept where the profiler reads under 0.8 of it; the
     lazy and online forwards also at the training shape, the online one
     at s 16 and 960 too; an empty kernel launched back to back, the
     floor under every launch; the cost of a head dim padded on the host,
     d 96 against d 128 at the training shape, forward and backward; and
     the host time of a forward launch;
     batch_norm_stats and
     batch_norm_backward_reduce for B6 and B7), the training step
     (ms/step, tokens/s, MFU, and where its device time goes), the
     synthetic-benchmark protocol on ResNet-50 at batch 32 for both norm
     impls (img/s, device time, busy share, top kernels), prefill (at
     prompts 16, 40, 64, 128, 512 and 960) and decode; the GSPMD step's
     ms/step beside make_multi_step's, the flagship's peak memory with
     vocab_chunk 0 and 8192 and with remat off and on (with ms/step over
     20 steps after 3 warm-up steps, each setting timed twice, in turn),
     ring_flash W = 4 forward and backward beside flash on the whole
     sequence, and the d-256 and d-384 kernels beside d 128 (the fp32
     forward and backward at d 128 and 256, bf16 at d 256 and 384).
  3n. (run after 3k, before phase 4) the numerics, memory and compile,
     cost-model, attribution and autotuner planes on the flagship eager step
     (gpt2_small_tpu, flash, tied, bf16 logits, b16 x s1024) at world 1
     over NCCL: (a) HOROVOD_AUTOTUNE with a log on the live core until
     the tuner has scored 5 windows, the log's rows and the adopted
     threshold and cycle inside the tuner's bounds, ms/step before and
     after adoption, fp32 masters after 3 steps with a tuner moving the
     knobs bit-equal to a run without it; (b) clean steps flag no
     anomaly, a gradient hook planting 3 NaNs in ln_f.scale's gradient
     raises hvd_nonfinite_total by 3 a side with one numerics_anomaly
     event, one flight dump, and the nonfinite alert firing; the
     reference's <=2 % contract as bench.py holds it (numerics off and on
     over interleaved windows of the flagship eager step, every other
     plane at its default, the side that runs first alternating by round,
     the best window of each side, more rounds only while over budget, up
     to 3; fatal above 2 %), then the stats kernels' share of the step's
     device ms from torch.profiler, fatal above 2 %; and the plane's cost
     split for the stats kernel and for its plain version (the stats'
     device ms a step, their host ms to queue, their scratch bytes, the
     policy's host ms); (c) (inside
     phase 3k (b)'s 2-rank launch, HOROVOD_AUTOTUNE=1) rank 1's reduced
     copy of one named tensor scaled by 1 + 1e-2 and rank 0's
     coordinator naming rank 1 in hvd_numerics_divergent_rank, both ranks
     on identical tuned values after rank 0 freezes the tuner; (d) the
     HBM ledger's params, optimizer and gradient bytes beside
     torch.cuda.memory_allocated, hvd_step_peak_hbm_bytes equal to
     max_memory_allocated for the same step, hbm_headroom_low firing at
     frac 0.99, a churning compile site raising
     hvd_recompile_storms_total; (e) trainer.instrument_step with
     attrib_every 5 over 10 steps: hvd_mfu (beside phase 4's MFU), each
     capture's op-class breakdown summing to within 10 % of the
     profiler's own device tally, its device intervals inside the step's
     span by CUDA events, "other" at most 10 % of it; and one
     merged_timeline.capture of an eager allreduce at world 1, in a
     fresh process of its own (``--merged-capture``): every launch call
     with its device record, the device events merge() takes from the
     live profiler on the exported trace's clock (host events of both
     within 2 us; the device times anchored on their launch calls, the
     timeline on the wall clock), and the ALLREDUCE span
     overlapping the collective's device events (a one-rank NCCL
     allreduce launches no kernel: the bf16 wire's casts are its device
     work there); (f) phase 3k (a)'s on/off
     windows now switch the numerics and memory planes too. Its B2, B4
     and B5 launches ((a)'s tuning run, (e)'s steps) join the kernels
     line.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
there is no CUDA device or the port is not beside this script.
"""

import collections
import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

# the port beside this script, never an installed copy
ROOT = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(ROOT, "horovod_tpu_torch")):
    sys.exit("chip_smoke: horovod_tpu_torch/ is not beside this script; "
             "run it from a checkout")
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import models, synthetic_benchmark  # noqa: E402
from horovod_tpu_torch import train_lm, trainer  # noqa: E402
from horovod_tpu_torch.models import transformer as tr  # noqa: E402
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import batch_norm as bn  # noqa: E402
from horovod_tpu_torch.ops import batch_norm_ref as bn_ref  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.ops import flash_attention_ref as ref  # noqa: E402
from horovod_tpu_torch.ops import flash_fwd_ab as fwd_ab  # noqa: E402
from horovod_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from horovod_tpu_torch.parallel import ring  # noqa: E402
from horovod_tpu_torch.router import CanaryController  # noqa: E402
from horovod_tpu_torch.serving.decode import (  # noqa: E402
    decode_step, prefill_forward)
from horovod_tpu_torch.serving.engine import ServeEngine  # noqa: E402
from horovod_tpu_torch.serving.queue import (  # noqa: E402
    AdmissionQueue, Request)
from horovod_tpu_torch.utils import profiling  # noqa: E402

# H100 SXM published peaks (dense bf16 tensor cores, HBM3), NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_KV_BLOCK = 4, 1024, 16
SM90_SOURCE = "horovod_tpu_torch/csrc/flash_fwd_sm90.cu"
SM90DYN_SOURCE = "horovod_tpu_torch/csrc/flash_fwd_sm90_dyn.cu"
BWD_SOURCE = "horovod_tpu_torch/csrc/flash_bwd_sm90.cu"
CC_FWD_SOURCE = "horovod_tpu_torch/csrc/flash_fwd.cu"
CC_BWD_SOURCE = "horovod_tpu_torch/csrc/flash_bwd.cu"
BN_SOURCE = "horovod_tpu_torch/csrc/batch_norm.cu"
STATS_SOURCE = "horovod_tpu_torch/csrc/segment_stats.cu"
REPLACES = {"online": "horovod_tpu/ops/flash_attention.py:129",
            "lazy": "horovod_tpu/ops/flash_attention.py:220",
            "twopass": "horovod_tpu/ops/flash_attention.py:312",
            "dq": "horovod_tpu/ops/flash_attention.py:467",
            "dkv": "horovod_tpu/ops/flash_attention.py:531",
            "bn_moments": "horovod_tpu/ops/batch_norm.py:78",
            "bn_moments2": "horovod_tpu/ops/batch_norm.py:95",
            # no Pallas kernel: the reference's one compiled pass per
            # slice layout
            "segment_stats": "horovod_tpu/utils/numerics.py:228"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
# phase 3e: the flagship's d_model 768 over 3 heads of 256: served at full
# depth, trained at depth WIDE_LAYERS; bf16 on the wgmma kernels, fp32 on
# the CUDA cores
WIDE_HEADS, WIDE_LAYERS, WIDE_STEPS = 3, 2, 4
WIDE_SERVE_LAYERS = 12
WIDE_NAMES = tuple(f"flash_fwd_{v}" for v in ("online", "lazy", "twopass")
                   ) + ("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv")
CC_FWD_NAMES = tuple(f"flash_fwd_cc_{v}" for v in ("online", "lazy",
                                                    "twopass"))
CC_BWD_NAMES = ("flash_bwd_cc_dq", "flash_bwd_cc_dkv")
# phase 3e again: the flagship's width over 2 heads of 384, on the
# run-time-d kernels (the bf16 forward on wgmma)
DYN_HEADS = 2
DYN_NAMES = tuple(f"flash_fwd_sm90dyn_{v}" for v in ("online", "lazy",
                                                      "twopass")
                  ) + ("flash_bwd_dyn_dq", "flash_bwd_dyn_dkv")
DYN_SOURCE = "horovod_tpu_torch/csrc/flash_dyn.cu"
VISION_BATCH, VISION_SIZE, VISION_STEPS = 32, 224, 10
BN_PER_STEP = 53   # BatchNorm layers of ResNet-50
# phase 1's register reports: (source, its kernel instantiations). The
# wgmma forward: d 16-256 x walk x warpgroups; the run-time-d wgmma
# forward: slice width (3 or 4 boxes) x walk x warpgroups; the fp32
# forward: d x walk; the wgmma backward: dq at d 16-128 x warpgroups and
# d 256 at one, dk/dv at d 16-128 and d 256's split-column kernel; the
# run-time-d CUDA-core kernels: 6 forward (dtype x walk), 4 backward; the
# stats kernel's first pass (3 dtypes) and its reduction
PTXAS_SOURCES = (("flash_fwd_sm90", 30), ("flash_fwd_sm90_dyn", 12),
                 ("flash_fwd", 15), ("flash_bwd_sm90", 14), ("flash_dyn", 10),
                 ("segment_stats", 4))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(card, msg):
    print(f"[{card}] {msg}", flush=True)


def stamp(card, what, t_main):
    """The seconds since the build began, at the end of ``what``."""
    log(card, f"{what} done at {time.perf_counter() - t_main:.1f} s from "
              f"the build")


# calls of a plain walk under torch.profiler: each records thousands of
# small kernels, whose trace takes seconds to process (9 s for two calls
# at d 384), and one call's device time is that of every call
PLAIN_ITERS = 1


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters=20, events_if_empty=True):
    """Device time per call from torch.profiler over ``iters`` calls,
    counting each event that ran on the card once: (total ms; {kernel
    name: ms}). A trace that recorded no device event is taken again, up
    to three times (the profiler has lost whole traces on this card);
    after that the total is CUDA events' span per call, with a line that
    says so and an empty dict, or None with ``events_if_empty`` off."""
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # the port's own trace reader (utils/profiling.py)
        by_name = {r.name: r.total_ms / iters
                   for r in profiling.summarize_profile(prof).rows}
        if by_name:
            return sum(by_name.values()), by_name
    if not events_if_empty:
        return None, by_name
    ms = time_ms(fn, iters, 1)
    print(f"device_profile: torch.profiler recorded no device event in 3 "
          f"traces of {iters} calls of "
          f"{getattr(fn, '__qualname__', repr(fn))}; CUDA events' "
          f"{ms:.4f} ms per call stand in for its device ms", flush=True)
    return ms, by_name


def device_ms(fn, iters=20, events_if_empty=True):
    return device_profile(fn, iters, events_if_empty)[0]


def kernel_class(name):
    """A device kernel's family, from its name."""
    if "flash_" in name:
        return "flash"
    if "bn_partial" in name or "bn_finalize" in name:
        return "bn_stats (B6/B7)"
    if "batch_norm" in name:
        return "torch batch_norm"
    if "conv" in name.lower() or "dgrad" in name or "wgrad" in name:
        return "conv"
    if any(k in name for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "gemm"
    if "elementwise" in name or "copy" in name.lower():
        return "elementwise"
    if "reduce" in name.lower():
        return "reduction"
    return "other"


def device_by_op(fn, iters=1):
    """Device ms per call by the aten operator that launched it (each
    operator's self device time, from torch.profiler with CPU and CUDA
    activity), largest first. Only ``aten::`` keys: the profiler also
    lists the kernels themselves and user ranges, which would count the
    same time twice."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.key.startswith("aten::"):
            rows.append((e.key, us / 1e3 / iters))
    return sorted(rows, key=lambda kv: -kv[1])


def top_kernels(by_name, n=6):
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top)


def qkv(seed, b, s, h, d, dtype, device, k_ramp=None):
    """Unit-scale q, k, v [b, s, h, d]; ``k_ramp`` [s] scales each key."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g) for _ in range(3))
    if k_ramp is not None:
        k = k * k_ramp[None, :, None, None]
    return [t.to(device, dtype) for t in (q, k, v)]


def kernel_tol(what, dtype, want):
    """(rtol, atol) for a kernel against its plain version on the same
    inputs. fp32: 2e-5. bf16 O: two bf16 ulps of each value plus 1 % of
    the largest |O|, which a P element rounded the other way stays under
    and O = 0 or a skipped rescale does not; lse is fp32 from fp32 logits
    in both dtypes: 1e-3."""
    if dtype == torch.float32:
        return 2e-5, 2e-5
    if what == "lse":
        return 0.0, 1e-3
    return 1.6e-2, 1e-2 * want.abs().max().item()


def hold(got, want, what, dtype, label):
    """Assert the kernel's ``got`` matches the plain ``want``; return
    (max |error|, that error's share of what the tolerance allows)."""
    got, want_f = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label} {what}: not finite")
    rtol, atol = kernel_tol(what, dtype, want_f)
    torch.testing.assert_close(got, want_f, rtol=rtol, atol=atol,
                               msg=lambda m: f"{label} {what}: {m}")
    err = (got - want_f).abs()
    return err.max().item(), (err / (atol + rtol * want_f.abs())).max().item()


def attention_work(bh, s, d, causal, itemsize):
    """(operations, bytes) the forward needs: 4·d per visible (q, k)
    pair; q, k, v read once, O and lse written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * d * pairs * bh, (4 * s * d * itemsize + 4 * s) * bh


def bound(ops, nbytes, peak_flops):
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_work(bh, s, d, causal, itemsize, kernel):
    """(operations, bytes) a backward kernel needs: dq does 6·d per
    visible (q, k) pair (three products) and moves q, dO, k, v and dq
    once; dk/dv does 8·d (four) and moves k, v, q, dO, dk and dv once;
    both read lse and delta once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    per_pair, tensors = (6, 5) if kernel == "dq" else (8, 6)
    return (per_pair * d * pairs * bh,
            (tensors * s * d * itemsize + 2 * s * 4) * bh)


def bwd_tol(dtype, want):
    """(rtol, atol) for a backward kernel's gradient against its plain
    version on the same inputs: fp32 rtol 1e-4 / atol 1e-5; bf16 two bf16
    ulps of each value plus 1 % of that gradient's largest magnitude."""
    if dtype == torch.float32:
        return 1e-4, 1e-5
    return 1.6e-2, 1e-2 * want.abs().max().item()


def hold_grad(got, want, dtype, label):
    """Assert a kernel gradient matches the plain one; return (max
    |error|, that error's share of what the tolerance allows)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: not finite")
    rtol, atol = bwd_tol(dtype, want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{label}: {m}")
    err = (got - want).abs()
    return err.max().item(), (err / (atol + rtol * want.abs())).max().item()


def plain_fwd(qf, kf, vf, causal, scale, variant):
    return ref.FWD[variant](qf, kf, vf, causal,
                            *fa.kernel_blocks(qf, kf, variant), scale)


def plain_bwd(qf, kf, vf, dof, lse, delta, causal, scale, cta_rows=None):
    dq_walk, dkv_walk = fa.bwd_kernel_blocks(qf, kf, cta_rows)
    dq = ref.flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal, *dq_walk,
                          scale)
    return (dq, *ref.flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal,
                                   *dkv_walk, scale))


def plain_bn(af, bf=None):
    return bn_ref.moments(af) if bf is None else bn_ref.moments2(af, bf)


@contextlib.contextmanager
def plain_path():
    """Every kernel launch of the port replaced by its plain PyTorch
    version (the same tile walk for flash attention), on the card."""
    saved = fa._kernel_fwd, fa._kernel_bwd, bn._kernel
    fa._kernel_fwd, fa._kernel_bwd, bn._kernel = plain_fwd, plain_bwd, \
        plain_bn
    try:
        yield
    finally:
        fa._kernel_fwd, fa._kernel_bwd, bn._kernel = saved


def flat(t):
    """[b, s, h, d] -> contiguous [b·h, s, d]."""
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d).contiguous()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_kernels(card, dev):
    """Every kernel against its plain version: the serving shapes, a
    wider batch, and the rising-max adversary (keys scaled by a ramp, so
    every k tile raises the row max in one walk order: ``down`` for lazy's
    diagonal-first walk, ``up`` for the ascending one)."""
    errs = {v: 0.0 for v in fa.VARIANTS}
    share = {"bfloat16": 0.0, "float32": 0.0}
    lse_err = dict(share)
    ramps = {"down": torch.linspace(4.0, 0.5, 512),
             "up": torch.linspace(0.5, 4.0, 512)}
    cases = []
    for dt in ("bfloat16", "float32"):
        for causal in (True, False):
            for s in (128, 1024):
                cases.append((dict(b=1, s=s, h=6, d=128), dt, causal, None))
            cases.append((dict(b=2, s=512, h=12, d=64), dt, causal, None))
            for ramp in ramps:
                cases.append((dict(b=1, s=512, h=6, d=128), dt, causal,
                              ramp))
    n_cmp = 0
    for n, (shape, dt, causal, ramp) in enumerate(cases):
        dtype = getattr(torch, dt)
        q, k, v = qkv(n, dtype=dtype, device=dev, k_ramp=ramps.get(ramp),
                      **shape)
        qf, kf, vf = (t.transpose(1, 2).reshape(-1, shape["s"], shape["d"])
                      for t in (q, k, v))
        for variant in fa.VARIANTS:
            out, lse = fa.flash_fwd(q, k, v, causal, variant=variant)
            p_out, p_lse = ref.FWD[variant](
                qf, kf, vf, causal, *fa.kernel_blocks(qf, kf, variant))
            p_out = p_out.reshape(shape["b"], shape["h"], shape["s"],
                                  shape["d"]).transpose(1, 2)
            label = f"{variant} {dt} {shape} causal={causal} ramp={ramp}"
            for got, want, what in ((out, p_out, "O"), (lse, p_lse, "lse")):
                err, frac = hold(got, want, what, dtype, label)
                errs[variant] = max(errs[variant], err)
                share[dt] = max(share[dt], frac)
                if what == "lse":
                    lse_err[dt] = max(lse_err[dt], err)
                n_cmp += 1
    # ragged causal tail: the public entry runs 1000 unpadded, the kernels
    # masking their partial last tiles
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q, k, v = qkv(50, b=1, s=1000, h=6, d=128, dtype=dtype, device=dev)
        qf, kf, vf = (t.transpose(1, 2).reshape(6, 1000, 128)
                      for t in (q, k, v))
        for variant in fa.VARIANTS:
            out = fa.flash_attention(q, k, v, causal=True, variant=variant,
                                     device=dev)
            p_out, _ = ref.FWD[variant](qf, kf, vf, True,
                                        *fa.kernel_blocks(qf, kf, variant))
            p_out = p_out.reshape(1, 6, 1000, 128).transpose(1, 2)
            err, frac = hold(out, p_out, "O", dtype,
                             f"{variant} {dt} ragged s=1000")
            errs[variant] = max(errs[variant], err)
            share[dt] = max(share[dt], frac)
            n_cmp += 1
    log(card, f"phase 2: {n_cmp} kernel/plain comparisons (O and lse) "
              f"passed; max |err| by kernel {errs}; max lse |err| by "
              f"dtype {lse_err}; largest error as a share of its "
              f"tolerance by dtype {share}")
    return errs


def check_sm90_kernel(card, dev, errs):
    """The bf16 wgmma/TMA forward (online, lazy, twopass) on ``[b·h, s,
    d]`` operands against its plain version at the kernel's own tiles:
    every head dim, sequences that are multiples of 64 but not of 128 with
    b·h >= 2 (where a flat tensor map would read the next head's keys),
    non-causal sk != sq, both CTA shapes forced with the rising-max
    adversaries at 128-key tiles, one partial tile (s 16, 64, 100: the
    serving prompts' nk = 1), partial last tiles (s 1000, sq 100 x sk 300)
    at both CTA shapes, causal and not, and the training shape; then head
    dim 256 (64-key tiles): both CTA shapes, causal and not, at s 192, the
    partial last tiles of sq 200 x sk 200, sq 1000 and sq 100 x sk 300,
    and the rising-max adversaries for each walk order. Folds the largest
    O error into ``errs`` (``fwd_d256`` for d 256)."""
    ramp = {"down": torch.linspace(4.0, 0.5, 512),
            "up": torch.linspace(0.5, 4.0, 512)}
    errs.setdefault("fwd_d256", 0.0)
    cases = []   # (bh, sq, sk, d, causal, cta_rows, ramp)
    for causal in (True, False):
        for d in (16, 32, 64, 128):
            cases.append((3, 192, 192, d, causal, None, None))
        cases.append((6, 960, 960, 128, causal, None, None))
        for rows in (64, 128):
            cases.append((2, 384, 384, 128, causal, rows, None))
            for name in ramp:
                cases.append((6, 512, 512, 128, causal, rows, name))
    for rows in (64, 128):
        cases.append((4, 192, 320, 64, False, rows, None))
        for causal in (True, False):
            for s in (16, 64, 100, 1000):
                cases.append((6, s, s, 128, causal, rows, None))
            cases.append((4, 100, 300, 128, causal, rows, None))
    cases.append((TRAIN_BATCH * 6, TRAIN_SEQ, TRAIN_SEQ, 128, True, None,
                  None))
    for rows in (64, 128):
        for causal in (True, False):
            for sq, sk in ((192, 192), (200, 200), (1000, 1000), (100, 300)):
                cases.append((4, sq, sk, 256, causal, rows, None))
            for name in ramp:
                cases.append((6, 512, 512, 256, causal, rows, name))
    share = 0.0
    n_cmp = 0
    for n, (bh, sq, sk, d, causal, rows, name) in enumerate(cases):
        g = torch.Generator().manual_seed(500 + n)
        qf = torch.randn(bh, sq, d, generator=g)
        kf, vf = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
        if name:
            kf = kf * ramp[name][None, :, None]
        qf, kf, vf = (t.to(dev, torch.bfloat16) for t in (qf, kf, vf))
        for variant in fa.VARIANTS:
            blocks = fa.kernel_blocks(qf, kf, variant, rows)
            before = fa.launch_counts[f"flash_fwd_{variant}"]
            out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, variant,
                                      cta_rows=rows)
            if fa.launch_counts[f"flash_fwd_{variant}"] != before + 1:
                raise AssertionError(f"{variant} did not launch")
            p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal, *blocks)
            label = (f"sm90 {variant} bh={bh} sq={sq} sk={sk} d={d} "
                     f"causal={causal} blocks={blocks} ramp={name}")
            for got, want, what in ((out, p_out, "O"), (lse, p_lse, "lse")):
                err, frac = hold(got, want, what, torch.bfloat16, label)
                share = max(share, frac)
                if what == "O":
                    key = "fwd_d256" if d == 256 else variant
                    errs[key] = max(errs[key], err)
                n_cmp += 1
    log(card, f"phase 2: {n_cmp} wgmma/TMA forward kernel/plain comparisons "
              f"(bf16 online, lazy and twopass, O and lse; d 16/32/64/128, s "
              f"192 and 960 at b·h >= 2, sq 192 x sk 320, CTA rows 64 and "
              f"128, rising-max adversaries, s 16/64/100/1000 and sq 100 x sk "
              f"300 causal and not, the training shape; d 256 at 64-key "
              f"tiles, CTA rows 64 and 128, causal and not, s 192, sq 200, "
              f"1000 and 100 x sk 300, the adversaries) passed; largest "
              f"error as a share of its tolerance {share:.3f}; largest d-256 "
              f"|error| {errs['fwd_d256']:.3e}")


def check_bwd_kernels(card, dev):
    """The backward kernels against their plain versions on dq, dk and
    dv: the forward checks' shapes, a partial tile, the rising-max
    adversaries, the training shape, and the ragged causal s=1000
    through the autograd path (unpadded). Returns the largest errors:
    ``dq``, ``dkv`` of bf16 (the wgmma/TMA kernels), ``dq_fp32``,
    ``dkv_fp32`` of fp32 (the CUDA-core ones)."""
    errs = {"dq": 0.0, "dkv": 0.0, "dq_fp32": 0.0, "dkv_fp32": 0.0}
    share = {f"{k} {dt}": 0.0 for k in errs
             for dt in ("bfloat16", "float32")}
    ramps = {"down": torch.linspace(4.0, 0.5, 512),
             "up": torch.linspace(0.5, 4.0, 512)}
    cases = []
    for dt in ("bfloat16", "float32"):
        for causal in (True, False):
            for s in (48, 128, 1024):
                cases.append((dict(b=1, s=s, h=6, d=128), dt, causal, None))
            cases.append((dict(b=2, s=512, h=12, d=64), dt, causal, None))
            for ramp in ramps:
                cases.append((dict(b=1, s=512, h=6, d=128), dt, causal,
                              ramp))
    cases.append((dict(b=TRAIN_BATCH, s=TRAIN_SEQ, h=6, d=128), "bfloat16",
                  True, None))

    def record(name, got, want, dtype, label):
        kernel = "dq" if name == "dq" else "dkv"
        err, frac = hold_grad(got, want, dtype, f"{name} {label}")
        err_key = kernel if dtype == torch.bfloat16 else f"{kernel}_fp32"
        errs[err_key] = max(errs[err_key], err)
        key = f"{kernel} {str(dtype).split('.')[1]}"
        share[key] = max(share[key], frac)

    n_cmp = 0
    for n, (shape, dt, causal, ramp) in enumerate(cases):
        dtype = getattr(torch, dt)
        q, k, v = qkv(100 + n, dtype=dtype, device=dev,
                      k_ramp=ramps.get(ramp), **shape)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            300 + n)).to(dev, dtype)
        qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
        scale = shape["d"] ** -0.5
        out, lse = fa._kernel_fwd(qf, kf, vf, causal, scale, "online")
        delta = ref.flash_delta(out, gf)
        got = fa._kernel_bwd(qf, kf, vf, gf, lse, delta, causal, scale)
        want = plain_bwd(qf, kf, vf, gf, lse, delta, causal, scale)
        label = f"{dt} {shape} causal={causal} ramp={ramp}"
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            record(name, a, w, dtype, label)
            n_cmp += 1
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q, k, v = qkv(60, b=1, s=1000, h=6, d=128, dtype=dtype, device=dev)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            61)).to(dev, dtype)

        def grads():
            ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            fa.flash_attention(*ts, causal=True, device=dev).backward(g)
            return [t.grad for t in ts]
        got = grads()
        with plain_path():
            want = grads()
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            record(name, a, w, dtype, f"{dt} ragged s=1000 (autograd)")
            n_cmp += 1
    log(card, f"phase 2: {n_cmp} backward kernel/plain comparisons (dq, dk, "
              f"dv) passed; max bf16 |err| by kernel {errs}; largest error "
              f"as a share of its tolerance by kernel and dtype {share}")
    return errs


def check_sm90_bwd(card, dev, errs):
    """The bf16 wgmma/TMA backward pair (dq, dk/dv) on ``[b·h, s, d]``
    operands against the plain walks at the kernels' own tiles: every head
    dim, both dq CTA shapes forced with the rising-max adversaries,
    sequences that end in a partial tile of the kernels (s 960: 128-key
    tiles; s 1000: 64-query tiles too) with b·h >= 2, where a flat tensor
    map would read the next head's rows, non-causal sq != sk both ways,
    and the training shape; at d 256 (64 x 64 walks, one dq CTA shape)
    s 192, s 1000, the adversaries, sq != sk both ways and phase 4's b4 h6
    s1024. lse and delta come from the plain forward. Folds the largest
    errors into ``errs`` (``dq``, ``dkv``; ``dq_d256``, ``dkv_d256`` at
    d 256)."""
    ramp = {"down": torch.linspace(4.0, 0.5, 512),
            "up": torch.linspace(0.5, 4.0, 512)}
    cases = []   # (bh, sq, sk, d, causal, cta_rows, ramp)
    for causal in (True, False):
        for d in (16, 32, 64, 128):
            cases.append((3, 192, 192, d, causal, None, None))
        cases.append((6, 960, 960, 128, causal, None, None))
        cases.append((2, 1000, 1000, 64, causal, None, None))
        for rows in (64, 128):
            cases.append((2, 384, 384, 128, causal, rows, None))
            for name in ramp:
                cases.append((6, 512, 512, 128, causal, rows, name))
    for rows in (64, 128):
        cases.append((4, 192, 320, 64, False, rows, None))
        cases.append((4, 320, 200, 32, False, rows, None))
    cases.append((TRAIN_BATCH * 6, TRAIN_SEQ, TRAIN_SEQ, 128, True, None,
                  None))
    # head dim 256: dq over 64 rows x 64 keys, dk/dv over 64 keys x 64
    # queries, with its two consumer warpgroups splitting the columns
    for causal in (True, False):
        cases.append((3, 192, 192, 256, causal, None, None))
        cases.append((2, 1000, 1000, 256, causal, None, None))
        for name in ramp:
            cases.append((6, 512, 512, 256, causal, None, name))
    cases.append((4, 192, 320, 256, False, None, None))
    cases.append((4, 320, 200, 256, False, None, None))
    cases.append((24, 1024, 1024, 256, True, None, None))
    for key in ("dq_d256", "dkv_d256"):
        errs.setdefault(key, 0.0)
    share = 0.0
    n_cmp = 0
    for n, (bh, sq, sk, d, causal, rows, name) in enumerate(cases):
        g = torch.Generator().manual_seed(900 + n)
        qf, dof = (torch.randn(bh, sq, d, generator=g) for _ in range(2))
        kf, vf = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
        if name:
            kf = kf * ramp[name][None, :, None]
        qf, kf, vf, dof = (t.to(dev, torch.bfloat16)
                           for t in (qf, kf, vf, dof))
        scale = d ** -0.5
        out, lse = ref.flash_fwd_online(qf, kf, vf, causal, 64, 64, scale)
        delta = ref.flash_delta(out, dof)
        fa.reset_launch_counts()
        got = fa._kernel_bwd(qf, kf, vf, dof, lse, delta, causal, scale,
                             cta_rows=rows)
        if dict(fa.launch_counts) != {"flash_bwd_sm90_dq": 1,
                                      "flash_bwd_sm90_dkv": 1}:
            raise AssertionError(f"the bf16 backward launched "
                                 f"{dict(fa.launch_counts)}")
        want = plain_bwd(qf, kf, vf, dof, lse, delta, causal, scale, rows)
        label = (f"sm90 bwd bh={bh} sq={sq} sk={sk} d={d} causal={causal} "
                 f"walks={fa.bwd_kernel_blocks(qf, kf, rows)} ramp={name}")
        for grad, a, w in zip(("dq", "dk", "dv"), got, want):
            err, frac = hold_grad(a, w, torch.bfloat16, f"{grad} {label}")
            kernel = "dq" if grad == "dq" else "dkv"
            if d == 256:
                kernel += "_d256"
            errs[kernel] = max(errs[kernel], err)
            share = max(share, frac)
            n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} wgmma/TMA backward kernel/plain comparisons "
              f"(bf16 dq, dk, dv; d 16/32/64/128/256, s 960 and 1000 at b·h "
              f">= 2, sq 192 x sk 320 and 320 x 200, dq CTA rows 64 and 128 "
              f"up to d 128, rising-max adversaries, the training shape, "
              f"b4 h6 s1024 d256) passed; largest error as a share of its "
              f"tolerance {share:.3f}; largest |error| at d 256: dq "
              f"{errs['dq_d256']:.3e}, dk/dv {errs['dkv_d256']:.3e}")


def check_partial_tiles_and_head_dims(card, dev, errs):
    """The repaired lengths and head dims: the fp32 CUDA-core forward (each
    variant) and backward at partial-tile lengths (s 100, sq 100 x sk 300,
    causal and not) against the plain walks at their 64-row tiles; then
    both dtypes at head dims 80 and 96 through the public autograd path
    (zero-padded to 128 on the host, the true d's scale) against the plain
    walks at the true d and the kernels' tiles, forward and gradients.
    Folds the largest bf16 errors into ``errs``."""
    share = {"fp32 partial": 0.0, "float32 d": 0.0, "bfloat16 d": 0.0}
    n_cmp = 0
    for n, (sq, sk, causal) in enumerate(((100, 100, True),
                                          (100, 100, False),
                                          (100, 300, True),
                                          (100, 300, False))):
        g = torch.Generator().manual_seed(1300 + n)
        qf, dof = (torch.randn(6, sq, 128, generator=g) for _ in range(2))
        kf, vf = (torch.randn(6, sk, 128, generator=g) for _ in range(2))
        qf, kf, vf, dof = (t.to(dev) for t in (qf, kf, vf, dof))
        scale = 128 ** -0.5
        label = f"fp32 sq={sq} sk={sk} causal={causal}"
        for variant in fa.VARIANTS:
            out, lse = fa._kernel_fwd(qf, kf, vf, causal, scale, variant)
            p_out, p_lse = plain_fwd(qf, kf, vf, causal, scale, variant)
            for got, want, what in ((out, p_out, "O"), (lse, p_lse, "lse")):
                share["fp32 partial"] = max(share["fp32 partial"], hold(
                    got, want, what, torch.float32, f"{variant} {label}")[1])
                n_cmp += 1
        delta = ref.flash_delta(p_out, dof)
        got = fa._kernel_bwd(qf, kf, vf, dof, p_lse, delta, causal, scale)
        want = plain_bwd(qf, kf, vf, dof, p_lse, delta, causal, scale)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            share["fp32 partial"] = max(share["fp32 partial"], hold_grad(
                a, w, torch.float32, f"{name} {label}")[1])
            n_cmp += 1
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for d in (80, 96):
            for causal in (True, False):
                q, k, v = qkv(1310 + d, b=2, s=300, h=3, d=d, dtype=dtype,
                              device=dev)
                g = torch.randn(q.shape, generator=torch.Generator()
                                .manual_seed(d)).to(dev, dtype)
                ts = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
                fa.reset_launch_counts()
                out = fa.flash_attention(*ts, causal=causal, device=dev)
                out.backward(g)
                if sum(fa.launch_counts.values()) != 3:
                    raise AssertionError(f"d={d} {dt} launched "
                                         f"{dict(fa.launch_counts)}")
                variant = fa.resolve_variant("auto", nk=-(-300 // fa.BLOCK))
                qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
                p_out, p_lse = plain_fwd(qf, kf, vf, causal, d ** -0.5,
                                         variant)
                delta = ref.flash_delta(p_out, gf)
                want = (p_out, *plain_bwd(qf, kf, vf, gf, p_lse, delta,
                                          causal, d ** -0.5))
                label = f"{dt} d={d} causal={causal} (padded to 128)"
                err, frac = hold(flat(out.detach()), want[0], "O", dtype,
                                 f"{variant} {label}")
                share[f"{dt} d"] = max(share[f"{dt} d"], frac)
                if dtype == torch.bfloat16:
                    errs[variant] = max(errs[variant], err)
                n_cmp += 1
                for name, t, w in zip(("dq", "dk", "dv"), ts, want[1:]):
                    err, frac = hold_grad(flat(t.grad), w, dtype,
                                          f"{name} {label}")
                    share[f"{dt} d"] = max(share[f"{dt} d"], frac)
                    kernel = "dq" if name == "dq" else "dkv"
                    if dtype == torch.bfloat16:
                        errs[kernel] = max(errs[kernel], err)
                    n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} comparisons of the repaired lengths and "
              f"head dims (fp32 forward and backward at s 100 and sq 100 x "
              f"sk 300; bf16 and fp32 at d 80 and 96 through the public "
              f"autograd path) passed; largest error as a share of its "
              f"tolerance {share}")


WIDE_DIMS = (160, 192, 224, 256)


def check_wide_head_dims(card, dev, errs):
    """Head dims above 128: d 160, 192, 224 and 256 (zero-padded to 256 on
    the host below it) through the public autograd path at s 200 (partial
    q and k tiles), fp32 and bf16, causal and not, against the plain walks
    at the true d and the kernels' tiles, O and dq, dk, dv: bf16 on the
    wgmma kernels, fp32 on the CUDA cores; then every forward walk at
    d 256 through the launch wrapper at sq 130 causal and sq 64 x sk 200,
    O and lse. Folds the largest errors into ``errs`` (fwd_d256 bf16,
    fwd_d256_fp32, dq_d256 and dkv_d256 bf16, dq_d256_fp32 and
    dkv_d256_fp32)."""
    for key in ("fwd_d256", "fwd_d256_fp32", "dq_d256", "dkv_d256",
                "dq_d256_fp32", "dkv_d256_fp32"):
        errs.setdefault(key, 0.0)
    share, n_cmp = {"bfloat16": 0.0, "float32": 0.0}, 0
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        bf16 = dtype == torch.bfloat16
        fwd_key = "fwd_d256" if bf16 else "fwd_d256_fp32"
        family = "sm90" if bf16 else "cc"
        want_launches = {"flash_fwd_online" if bf16
                         else "flash_fwd_cc_online": 1,
                         f"flash_bwd_{family}_dq": 1,
                         f"flash_bwd_{family}_dkv": 1}
        for d in WIDE_DIMS:
            for causal in (True, False):
                q, k, v = qkv(1400 + d, b=2, s=200, h=3, d=d, dtype=dtype,
                              device=dev)
                g = torch.randn(q.shape, generator=torch.Generator()
                                .manual_seed(d + 1)).to(dev, dtype)
                ts = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
                fa.reset_launch_counts()
                out = fa.flash_attention(*ts, causal=causal,
                                         variant="online", device=dev)
                out.backward(g)
                if dict(fa.launch_counts) != want_launches:
                    raise AssertionError(f"d={d} {dt} launched "
                                         f"{dict(fa.launch_counts)}")
                qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
                p_out, p_lse = plain_fwd(qf, kf, vf, causal, d ** -0.5,
                                         "online")
                delta = ref.flash_delta(p_out, gf)
                want = (p_out, *plain_bwd(qf, kf, vf, gf, p_lse, delta,
                                          causal, d ** -0.5))
                label = f"{dt} d={d} causal={causal}"
                err, frac = hold(flat(out.detach()), want[0], "O", dtype,
                                 label)
                share[dt] = max(share[dt], frac)
                errs[fwd_key] = max(errs[fwd_key], err)
                n_cmp += 1
                for name, t, w in zip(("dq", "dk", "dv"), ts, want[1:]):
                    err, frac = hold_grad(flat(t.grad), w, dtype,
                                          f"{name} {label}")
                    share[dt] = max(share[dt], frac)
                    key = ("dq_d256" if name == "dq" else "dkv_d256") + (
                        "" if bf16 else "_fp32")
                    errs[key] = max(errs[key], err)
                    n_cmp += 1
        for variant in fa.VARIANTS:
            for sq, sk, causal in ((130, 130, True), (64, 200, False)):
                g = torch.Generator().manual_seed(sq + sk)
                qf = torch.randn(2, sq, 256, generator=g).to(dev, dtype)
                kf, vf = (torch.randn(2, sk, 256, generator=g).to(dev, dtype)
                          for _ in range(2))
                out, lse = fa._kernel_fwd(qf, kf, vf, causal, 256 ** -0.5,
                                          variant)
                p_out, p_lse = plain_fwd(qf, kf, vf, causal, 256 ** -0.5,
                                         variant)
                for got, w, what in ((out, p_out, "O"), (lse, p_lse, "lse")):
                    err, frac = hold(got, w, what, dtype,
                                     f"{variant} {dt} d=256 sq={sq} sk={sk}")
                    share[dt] = max(share[dt], frac)
                    if what == "O":
                        errs[fwd_key] = max(errs[fwd_key], err)
                    n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} comparisons of head dims 160/192/224/256 "
              f"(bf16 forward and backward on the wgmma kernels; fp32 on "
              f"the CUDA cores; public autograd path at s 200, fp32 and "
              f"bf16, causal and not; each walk at d 256 at partial tiles) "
              f"passed; largest error as a share of its tolerance {share}; "
              f"largest |error| fwd bf16 {errs['fwd_d256']:.3e}, fp32 "
              f"{errs['fwd_d256_fp32']:.3e}, bf16 dq {errs['dq_d256']:.3e}, "
              f"dk/dv {errs['dkv_d256']:.3e}, fp32 dq "
              f"{errs['dq_d256_fp32']:.3e}, dk/dv "
              f"{errs['dkv_d256_fp32']:.3e}")


def check_cc_fwd(card, dev, errs):
    """The fp32 register-blocked forward (``flash_fwd.cu``) at every
    compiled head dim (16, 32, 64, 128, 256), every walk, against its plain
    version at its 64 x 128 tiles: s 192 causal and not, the partial last
    tiles of sq 130 causal and sq 100 x sk 300 non-causal, and at d 128 and
    256 the rising-max adversaries (s 512, keys ramped down causal: every
    tile of lazy's diagonal-first walk raises the row max; ramped up,
    non-causal: every tile of the ascending walks does); O and lse to
    2e-5. Folds the largest O error into ``errs`` (``fwd_fp32``)."""
    errs.setdefault("fwd_fp32", 0.0)
    ramp = torch.linspace(4.0, 0.5, 512)
    cases = []   # (bh, sq, sk, d, causal, ramp)
    for d in fa.KERNEL_HEAD_DIMS:
        cases += [(3, 192, 192, d, True, None), (3, 192, 192, d, False, None),
                  (2, 130, 130, d, True, None), (4, 100, 300, d, False, None)]
    for d in (128, 256):
        cases += [(6, 512, 512, d, True, "down"),
                  (6, 512, 512, d, False, "up")]
    share, n_cmp = 0.0, 0
    for n, (bh, sq, sk, d, causal, r) in enumerate(cases):
        g = torch.Generator().manual_seed(2400 + n)
        qf = torch.randn(bh, sq, d, generator=g)
        kf, vf = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
        if r:
            kf = kf * (ramp if r == "down" else ramp.flip(0))[None, :, None]
        qf, kf, vf = (t.to(dev) for t in (qf, kf, vf))
        for variant in fa.VARIANTS:
            name = f"flash_fwd_cc_{variant}"
            before = fa.launch_counts[name]
            out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, variant)
            if fa.launch_counts[name] != before + 1:
                raise AssertionError(f"fp32 d={d} {variant} did not launch "
                                     f"{name}")
            p_out, p_lse = plain_fwd(qf, kf, vf, causal, d ** -0.5, variant)
            label = (f"fp32 {variant} bh={bh} sq={sq} sk={sk} d={d} "
                     f"causal={causal} ramp={r}")
            for got, want, what in ((out, p_out, "O"), (lse, p_lse, "lse")):
                err, frac = hold(got, want, what, torch.float32, label)
                share = max(share, frac)
                if what == "O":
                    errs["fwd_fp32"] = max(errs["fwd_fp32"], err)
                n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} comparisons of the fp32 register-blocked "
              f"forward (every walk at d {list(fa.KERNEL_HEAD_DIMS)}: s 192 "
              f"causal and not, sq 130, sq 100 x sk 300, the adversaries at "
              f"d 128 and 256; O and lse) passed; largest error as a share "
              f"of its tolerance {share:.3f}; largest O |error| "
              f"{errs['fwd_fp32']:.3e}")


BEYOND_DIMS = (288, 384, 512, 1024)
# a bf16 head dim above the run-time-d wgmma forward's ceiling
# (fa.SM90_DYN_MAX_HEAD_DIM): its forward stays on flash_dyn.cu
ABOVE_CEILING_DIM = 1088


def check_beyond_256(card, dev, errs):
    """Head dims above 256: at d 288, 384, 512 and 1024, fp32 and bf16,
    every forward walk and dq and dk/dv (from the plain forward's lse)
    against the plain walks at the kernels' tiles, at sq 130 causal (a
    partial last tile), sq 100 x sk 300 non-causal, and sq = sk 256 with
    the rising-max adversaries (keys ramped down, causal: every tile of
    lazy's diagonal-first walk raises the row max; ramped up, non-causal:
    every tile of the ascending walks does). The bf16 forward runs on the
    run-time-d wgmma kernel (``flash_fwd_sm90_dyn.cu``: 64-key tiles; 64
    query rows, and 128 where they fit, d <= 576), the fp32 forward and
    every backward on ``flash_dyn.cu`` (32-row tiles) with the fp32
    accumulators in shared memory and, forced, in the device workspace at
    d 288 and 512 (the forward's for fp32 only: the wgmma forward keeps
    none; at d 1024 dk/dv's are there anyway); bf16 at d 1088, above the
    wgmma kernel's ceiling, every forward walk on ``flash_dyn.cu``; then
    d 288 through the public autograd path at s 200, causal and not, and
    bf16 d 300 (zero-padded to 304 for the wgmma forward). Folds the
    largest bf16 errors into ``errs`` (fwd_sm90dyn; fwd_dyn, bf16 above
    the ceiling; dq_dyn, dkv_dyn)."""
    for key in ("fwd_sm90dyn", "fwd_dyn", "dq_dyn", "dkv_dyn"):
        errs.setdefault(key, 0.0)
    share, n_cmp = {"bfloat16": 0.0, "float32": 0.0}, 0
    cases = ((130, 130, True, None), (100, 300, False, None),
             (256, 256, True, "down"), (256, 256, False, "up"))
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        bf16 = dtype == torch.bfloat16
        for d in BEYOND_DIMS + ((ABOVE_CEILING_DIM,) if bf16 else ()):
            scale = d ** -0.5
            spaces = (False, True) if d in (288, 512) else (False,)
            for sq, sk, causal, ramp in cases:
                g = torch.Generator().manual_seed(2000 + d + sq + sk)
                qf, dof = (torch.randn(2, sq, d, generator=g)
                           for _ in range(2))
                kf, vf = (torch.randn(2, sk, d, generator=g)
                          for _ in range(2))
                if ramp:
                    r_ = torch.linspace(4.0, 0.5, sk)
                    kf = kf * (r_ if ramp == "down" else r_.flip(0))[
                        None, :, None]
                qf, kf, vf, dof = (t.to(dev, dtype) for t in (qf, kf, vf,
                                                               dof))
                label = f"{dt} d={d} sq={sq} sk={sk} causal={causal}"
                wgmma = fa.on_sm90dyn_fwd(qf)
                err_key = ("fwd_sm90dyn" if wgmma else "fwd_dyn")
                runs = ([{"cta_rows": r} for r in (64, 128)
                         if fa.sm90dyn_fits(d, r)] if wgmma else
                        [{"workspace": ws} for ws in spaces])
                for variant in fa.VARIANTS:
                    name = fa.fwd_launch_name(qf, variant)
                    for kw in runs:
                        blocks = fa.kernel_blocks(qf, kf, variant,
                                                  kw.get("cta_rows"))
                        p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal,
                                                        *blocks, scale)
                        before = fa.launch_counts[name]
                        out, lse = fa._kernel_fwd(qf, kf, vf, causal, scale,
                                                  variant, **kw)
                        if fa.launch_counts[name] != before + 1:
                            raise AssertionError(f"{variant} {label} did not "
                                                 f"launch {name}")
                        for got, w, what in ((out, p_out, "O"),
                                             (lse, p_lse, "lse")):
                            err, frac = hold(got, w, what, dtype,
                                             f"{variant} {label} {kw} "
                                             f"blocks={blocks}")
                            share[dt] = max(share[dt], frac)
                            if bf16 and what == "O":
                                errs[err_key] = max(errs[err_key], err)
                            n_cmp += 1
                if d == ABOVE_CEILING_DIM:
                    continue   # the backward there is d 1024's kernel
                delta = ref.flash_delta(p_out, dof)
                want = plain_bwd(qf, kf, vf, dof, p_lse, delta, causal,
                                 scale)
                for ws in spaces:
                    got = fa._kernel_bwd(qf, kf, vf, dof, p_lse, delta,
                                         causal, scale, workspace=ws)
                    for name, a, w in zip(("dq", "dk", "dv"), got, want):
                        err, frac = hold_grad(a, w, dtype,
                                              f"{name} {label} ws={ws}")
                        share[dt] = max(share[dt], frac)
                        key = "dq_dyn" if name == "dq" else "dkv_dyn"
                        if bf16:
                            errs[key] = max(errs[key], err)
                        n_cmp += 1
        for d, causal in ((288, True), (288, False), (300, True)):
            if d == 300 and not bf16:
                continue   # fp32 takes any d unpadded: d 288 says it
            q, k, v = qkv(2012 + d, b=2, s=200, h=3, d=d, dtype=dtype,
                          device=dev)
            g = torch.randn(q.shape, generator=torch.Generator()
                            .manual_seed(2301)).to(dev, dtype)
            ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            fa.reset_launch_counts()
            out = fa.flash_attention(*ts, causal=causal, variant="online",
                                     device=dev)
            out.backward(g)
            qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
            want_launches = {fa.fwd_launch_name(qf, "online"): 1,
                             "flash_bwd_dyn_dq": 1, "flash_bwd_dyn_dkv": 1}
            if dict(fa.launch_counts) != want_launches:
                raise AssertionError(f"d={d} {dt} launched "
                                     f"{dict(fa.launch_counts)}")
            p_out, p_lse = plain_fwd(qf, kf, vf, causal, d ** -0.5,
                                     "online")
            delta = ref.flash_delta(p_out, gf)
            want = (p_out, *plain_bwd(qf, kf, vf, gf, p_lse, delta, causal,
                                      d ** -0.5))
            label = f"public {dt} d={d} causal={causal}"
            err, frac = hold(flat(out.detach()), want[0], "O", dtype, label)
            share[dt] = max(share[dt], frac)
            if bf16:
                errs["fwd_sm90dyn"] = max(errs["fwd_sm90dyn"], err)
            n_cmp += 1
            for name, t, w in zip(("dq", "dk", "dv"), ts, want[1:]):
                err, frac = hold_grad(flat(t.grad), w, dtype,
                                      f"{name} {label}")
                share[dt] = max(share[dt], frac)
                n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} comparisons of head dims "
              f"{list(BEYOND_DIMS)} (every walk, dq and dk/dv; partial last "
              f"tiles, sq != sk, rising-max adversaries; the bf16 forward on "
              f"the run-time-d wgmma kernel at both CTA shapes where they "
              f"fit, the fp32 forward and the backward on flash_dyn.cu with "
              f"the accumulators in shared memory and in the device "
              f"workspace; bf16 d {ABOVE_CEILING_DIM} on flash_dyn.cu's "
              f"forward; d 288 and bf16 d 300 through the public autograd "
              f"path) passed; largest error as a share of its tolerance "
              f"{share}; largest bf16 |error| fwd (wgmma) "
              f"{errs['fwd_sm90dyn']:.3e}, fwd above the ceiling "
              f"{errs['fwd_dyn']:.3e}, dq {errs['dq_dyn']:.3e}, dk/dv "
              f"{errs['dkv_dyn']:.3e}")


def check_ring_pairs(card, dev, errs):
    """The call patterns of a ring_flash pair after the first: at the
    model's attention width (b 4, h 6, d 128, s 1024, bf16, the wgmma
    kernels), at fp32 (b 1) and at d 256 (b 1, bf16; the wgmma forward
    and the CUDA-core backward). The forward non-causal at sq = sk
    against the plain walk; the backward under a merged lse (the pair's
    own plus another block of equal mass) whose odd rows are +1e30 (a
    future pair for those rows),
    against the plain walks, those rows' dq exactly 0; and a wholly future
    pair whose keys are offset by 1e3 (logits in the thousands): dq, dk
    and dv exactly 0."""
    n_cmp, share = 0, 0.0
    for dt, b, d in (("bfloat16", 4, 128), ("float32", 1, 128),
                     ("bfloat16", 1, 256)):
        dtype = getattr(torch, dt)
        q, k, v = qkv(1500 + d + b, b=b, s=1024, h=6, d=d, dtype=dtype,
                      device=dev)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            1501)).to(dev, dtype)
        qf, kf, vf, dof = (flat(t) for t in (q, k, v, g))
        scale = d ** -0.5
        label = f"ring pair {dt} b={b} d={d}"
        out, lse = fa._kernel_fwd(qf, kf, vf, False, scale, "online")
        p_out, p_lse = plain_fwd(qf, kf, vf, False, scale, "online")
        for got, w, what in ((out, p_out, "O"), (lse, p_lse, "lse")):
            share = max(share, hold(got, w, what, dtype, label)[1])
            n_cmp += 1
        future = torch.arange(1024, device=dev) % 2 == 1
        merged = torch.where(future, torch.full_like(lse, 1e30),
                             lse + math.log(2.0)).contiguous()
        delta = ref.flash_delta(out, dof)
        got = fa._kernel_bwd(qf, kf, vf, dof, merged, delta, False, scale)
        want = plain_bwd(qf, kf, vf, dof, merged, delta, False, scale)
        if torch.count_nonzero(got[0][:, future]):
            raise AssertionError(f"{label}: a +1e30 row's dq is not 0")
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err, frac = hold_grad(a, w, dtype, f"{name} {label} merged lse")
            share = max(share, frac)
            if dt == "bfloat16" and d == 128:
                kernel = "dq" if name == "dq" else "dkv"
                errs[kernel] = max(errs[kernel], err)
            n_cmp += 1
        kbig = (kf.float() + 1e3).to(dtype)
        for name, t in zip(("dq", "dk", "dv"), fa._kernel_bwd(
                qf, kbig, vf, dof, torch.full_like(lse, 1e30), delta, False,
                scale)):
            if torch.count_nonzero(t):
                raise AssertionError(f"{label}: a wholly future pair with "
                                     f"1e3-offset keys gives {name} != 0")
            n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} ring-pair comparisons (non-causal forward; "
              f"backward under a merged lse with +1e30 rows; a wholly future "
              f"pair with 1e3-offset keys exactly 0) at b4 h6 d128 s1024 "
              f"bf16, fp32 and d 256 passed; largest error as a share of its "
              f"tolerance {share:.3f}")


def vision_bn_shapes(model, images):
    """The (rows, C) each BatchNorm of ``model`` reduces in one training
    forward on ``images`` (one entry per layer, in call order)."""
    shapes = []

    def record(module, args):
        x = args[0]
        shapes.append((x.numel() // x.shape[1], x.shape[1]))
    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, bn.BatchNormBase)]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def check_bn_kernels(card, dev, step_shapes):
    """B6 (moments) and B7 (moments2) against their plain versions, and
    both against a float64 sum on the card, at every distinct (rows, C)
    of the ResNet-50 step and at ragged shapes, in bf16 and fp32, on
    unit-scale and 1e3-offset inputs. The tolerance is 1e-5 of the
    per-channel sum of magnitudes (Σ|x|, Σx², Σ|a·b|): relative to Σx
    itself it would mean nothing where Σx cancels. Returns the largest
    |kernel − plain| per kernel on unit-scale inputs."""
    cases = sorted(set(step_shapes), reverse=True) + [(21, 24), (1000, 3),
                                                      (1, 2048)]
    errs = {"bn_moments": 0.0, "bn_moments2": 0.0}
    share = {}
    n_cmp = 0
    for dt in (torch.bfloat16, torch.float32):
        for n, (rows, c) in enumerate(cases):
            for offset in (0.0, 1e3):
                g = torch.Generator(device=dev).manual_seed(1000 + n)
                a = (torch.randn(rows, c, generator=g, device=dev) +
                     offset).to(dt)
                b = (torch.randn(rows, c, generator=g, device=dev) * 0.5 +
                     offset).to(dt)
                a64, b64 = a.double(), b.double()
                runs = {"bn_moments": (bn._kernel(a), bn_ref.moments(a),
                                       (a64.sum(0), (a64 * a64).sum(0)),
                                       (a64.abs().sum(0), (a64 * a64).sum(0))),
                        "bn_moments2": (bn._kernel(a, b),
                                        bn_ref.moments2(a, b),
                                        (a64.sum(0), (a64 * b64).sum(0)),
                                        (a64.abs().sum(0),
                                         (a64 * b64).abs().sum(0)))}
                for name, (got, plain, exact, mags) in runs.items():
                    for i in range(2):
                        label = (f"{name}[{i}] {dt} rows={rows} C={c} "
                                 f"offset={offset}")
                        if not torch.isfinite(got[i]).all():
                            raise AssertionError(f"{label}: not finite")
                        tol = 1e-5 * mags[i] + 1e-30
                        frac = max(
                            ((got[i].double() - exact[i]).abs() / tol).max(),
                            ((plain[i].double() - exact[i]).abs() / tol).max(),
                            ((got[i] - plain[i]).double().abs() / tol).max()
                        ).item()
                        if frac > 1.0:
                            raise AssertionError(
                                f"{label}: error {frac:.3f} of the "
                                f"tolerance (1e-5 of the sum of magnitudes)")
                        key = f"{name} {str(dt).split('.')[1]}"
                        share[key] = max(share.get(key, 0.0), frac)
                        if offset == 0.0:
                            errs[name] = max(errs[name], (got[i] - plain[i])
                                             .abs().max().item())
                        n_cmp += 1
    log(card, f"phase 2: {n_cmp} BatchNorm statistics comparisons (kernel, "
              f"plain and float64; {len(cases)} shapes x bf16/fp32 x "
              f"unit/offset inputs) passed; max |kernel - plain| on "
              f"unit-scale inputs {errs}; largest error as a share of its "
              f"tolerance by kernel and dtype {share}")
    return errs


# ---------------------------------------------------------------------------
# phase 3: the serving path


def serving_workload():
    prompts = [16, 40, 64, 100, 200, 300, 480, 512, 640, 777, 900, 960]
    new = [16, 64, 32, 48, 16, 24, 64, 40, 16, 32, 20, 16]
    out = []
    for i, (plen, n_new) in enumerate(zip(prompts, new)):
        toks = tuple(int(x) for x in
                     (((i + 1) * 7919 + 104729 * j) % 50000 + 1
                      for j in range(plen)))
        temp = 0.8 if i in (3, 9) else 0.0
        out.append(Request(f"req-{i}", toks, max_new_tokens=n_new,
                           temperature=temp))
    return out


def serve(cfg, model, requests, dev, mesh=None, max_len=SERVE_MAX_LEN):
    """An engine (on ``mesh``'s tp ranks when given) answering
    ``requests``; returns (results, steps, wall seconds, the engine)."""
    queue = AdmissionQueue(max_depth=len(requests) + 1,
                           admission_timeout_s=1e9)
    engine = ServeEngine(cfg, model, num_slots=SERVE_SLOTS,
                        max_len=max_len, kv_block=SERVE_KV_BLOCK,
                        queue=queue, seed=0, device=dev, mesh=mesh)
    for r in requests:
        if not engine.submit(r):
            raise AssertionError(f"{r.request_id} refused at submit")
    t0 = time.perf_counter()
    steps = 0
    results = []
    while engine.active_count or len(engine.queue):
        results.extend(engine.step())
        steps += 1
        if steps > 5000:
            raise AssertionError("serving never drained")
    wall = time.perf_counter() - t0
    bad = [(r.request_id, r.outcome, r.reason) for r in results
           if r.outcome != "completed"]
    if bad or len(results) != len(requests):
        raise AssertionError(f"serving: {len(results)}/{len(requests)} "
                             f"returned, failures {bad}")
    for r in results:
        want = next(q.max_new_tokens for q in requests
                    if q.request_id == r.request_id)
        if len(r.tokens) != want or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"{r.request_id}: bad tokens {r.tokens}")
    if engine.kv.ledger.blocks_in_use:
        raise AssertionError(f"{engine.kv.ledger.blocks_in_use} KV blocks "
                             f"leaked")
    return results, steps, wall, engine


# ---------------------------------------------------------------------------
# phase 3b: the training path


def check_nccl(card, dev):
    """One allreduce (sum and average), broadcast and allgather of CUDA
    tensors over the one-card NCCL group: each must return its input
    exactly."""
    from horovod_tpu_torch.common import state
    if state.backend() != "nccl" or hvd.size() != 1:
        raise AssertionError(f"expected a one-card NCCL group, got "
                             f"{state.backend()} x {hvd.size()}")
    x = torch.linspace(-3.3, 7.7, 4097, device=dev)
    outs = {"allreduce sum": hvd.allreduce(x, average=False),
            "allreduce average": hvd.allreduce(x),
            "broadcast": hvd.broadcast(x, root_rank=0),
            "allgather": hvd.allgather(x)}
    for name, out in outs.items():
        if out.device != x.device or not torch.equal(out, x):
            raise AssertionError(f"NCCL {name} is not exact")
    log(card, f"phase 3b: NCCL {sorted(outs)} of a CUDA tensor exact")


def train_flagship(card, dev, cfg):
    """10 steps of the flagship on one repeated batch through the kernels;
    returns (model, optimizer, batch, launches of the run, losses)."""
    model, opt, _, toks = train_lm.build_transformer_step(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)
    batch = toks[0]
    step = trainer.make_train_step(model, opt, tr.lm_loss_fn(model))
    per_step = {"flash_fwd_lazy": cfg.num_layers,
                "flash_bwd_sm90_dq": cfg.num_layers,
                "flash_bwd_sm90_dkv": cfg.num_layers}
    losses = []
    fa.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = dict(fa.launch_counts)
        losses.append(step(batch).item())
        got = {k: v - before.get(k, 0) for k, v in fa.launch_counts.items()}
        if got != per_step:
            raise AssertionError(f"training step {i} launched {got}, "
                                 f"expected {per_step}")
    launches = dict(fa.launch_counts)
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"training losses {losses}")
    log(card, f"phase 3b: trained gpt2_small_tpu (flash, tied, bf16 logits, "
              f"fp32 masters, AdamW mu bf16) at batch {TRAIN_BATCH} x seq "
              f"{TRAIN_SEQ} for {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} ({[round(x, 4) for x in losses]}); "
              f"launches {launches} ({per_step} every step)")
    return model, opt, batch, launches, losses


def check_train_grads(card, dev, cfg, batch):
    """One step's gradients at batch 2 on the kernel path against the same
    step with every launch replaced by its plain version: in bf16 against
    each gradient's scale (one rounding flip moves every later layer, as
    for the serving logits), in fp32 to 1e-4 of it, under each forward
    walk (the default lazy, then the config's flash_variant online and
    twopass: not the environment, which the process lane's ranks share).
    Returns the fp32 kernel path's launches (the CUDA-core forward walks
    and backward at the flagship's head dim 128)."""
    fp32_launches = collections.Counter()
    for dtype, tol, walk in ((torch.bfloat16, 5e-2, None),
                             (torch.float32, 1e-4, None),
                             (torch.float32, 1e-4, "online"),
                             (torch.float32, 1e-4, "twopass")):
        fp32_launches.update(_grads_against_plain(card, dev, cfg, batch,
                                                  dtype, tol, walk))
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    want = CC_BWD_NAMES + CC_FWD_NAMES
    if not all(fp32_launches.get(n) for n in want):
        raise AssertionError(f"the fp32 batch-2 steps launched "
                             f"{dict(fp32_launches)}; want each of {want}")
    log(card, f"phase 3b: the fp32 batch-2 steps on the kernel path (one "
              f"under each forward walk) launched {dict(fp32_launches)}")
    return dict(fp32_launches)


def _grads_against_plain(card, dev, cfg, batch, dtype, tol, walk):
    """check_train_grads' step in ``dtype`` under forward walk ``walk``
    (None: the default); returns the kernel path's launches in fp32."""
    fp32_launches = {}
    c = dataclasses.replace(cfg, dtype=dtype,
                            flash_variant=walk or cfg.flash_variant)
    model = tr.init_params(c, torch.Generator().manual_seed(1),
                           device=dev, train=True)
    loss_fn = tr.lm_loss_fn(model)

    def grads():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch[:2])
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}
    fa.reset_launch_counts()
    got_loss, got = grads()
    if dtype == torch.float32:
        fp32_launches = dict(fa.launch_counts)
    with plain_path():
        want_loss, want = grads()
    if not math.isclose(got_loss, want_loss, rel_tol=tol):
        raise AssertionError(f"{dtype} loss {got_loss} vs plain "
                             f"{want_loss}")
    worst = 0.0
    for name, w in want.items():
        scale = w.abs().max().item()
        if not torch.isfinite(got[name]).all():
            raise AssertionError(f"{dtype} grad {name} not finite")
        torch.testing.assert_close(
            got[name], w, rtol=tol, atol=tol * scale,
            msg=lambda m, name=name: f"{dtype} grad {name}: {m}")
        worst = max(worst, (got[name] - w).abs().max().item() / scale)
    log(card, f"phase 3b: {dtype} batch-2 step (forward walk "
              f"{walk or 'auto'}), kernel vs plain path: "
              f"loss {got_loss:.6f} vs {want_loss:.6f}; largest grad "
              f"|diff| / that grad's max |value| {worst:.3e} over "
              f"{len(want)} parameters (tolerance {tol})")
    del model, got, want
    return fp32_launches


# ---------------------------------------------------------------------------
# phase 3c: the vision path


def vision_batch(dev, batch, seed=0):
    """Seeded random images [batch, 3, 224, 224] (bf16, channels_last)
    and labels."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(batch, 3, VISION_SIZE, VISION_SIZE, generator=g)
    labels = torch.randint(0, 1000, (batch,), generator=g)
    return (images.to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last), labels.to(dev))


def train_vision(card, dev):
    """10 steps of ResNet-50 (tpu norms) on one random batch through the
    synthetic benchmark's step; returns the launches of the run."""
    step, _, _, _ = synthetic_benchmark.build_step(
        "resnet50", VISION_BATCH, VISION_SIZE, dev, norm_impl="tpu")
    batch = vision_batch(dev, VISION_BATCH)
    per_step = {"bn_moments": BN_PER_STEP, "bn_moments2": BN_PER_STEP}
    losses = []
    bn.reset_counts()
    for i in range(VISION_STEPS):
        before = dict(bn.launch_counts)
        losses.append(step(batch).item())
        got = {k: v - before.get(k, 0) for k, v in bn.launch_counts.items()}
        if got != per_step:
            raise AssertionError(f"vision step {i} launched {got}, "
                                 f"expected {per_step}")
    launches, copies = dict(bn.launch_counts), dict(bn.layout_copies)
    if copies:
        raise AssertionError(f"layout copies in the ResNet-50 step: {copies}")
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"vision losses {losses}")
    log(card, f"phase 3c: trained ResNet-50 (norm_impl tpu, bf16, fp32 "
              f"masters, SGD 0.01 momentum 0.9) at batch {VISION_BATCH} x "
              f"{VISION_SIZE} for {VISION_STEPS} steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({[round(x, 4) for x in losses]}); launches {launches} "
              f"({per_step} every step); layout copies 0")
    return launches


def check_vision_grads(card, dev):
    """A batch-2 ResNet-50 (tpu) step's gradients on the kernel path
    against the plain path, where the two differ only in the statistics'
    order of summation. fp32 (TF32 off; cuDNN deterministic, so that the
    convolutions do not differ between the runs): every element within
    1e-4 of that gradient's largest magnitude. bf16: the loss within 5 %
    and each gradient within 0.25 of its L2 norm. A bf16 output rounded
    the other way in one layer moves every layer below it: two correct
    summation orders move bn_init's gradients by 7.0e-2 in L2 and single
    elements by 0.23 of the largest on the CPU
    (tests/test_torch_port_batch_norm.py), so 5 % of each gradient's scale
    cannot hold in bf16, and single elements are printed, not held."""
    images, labels = vision_batch(dev, 2, seed=1)
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, tol in ((torch.bfloat16, 0.25), (torch.float32, 1e-4)):
            model = models.build("resnet50", dtype=dtype, norm_impl="tpu",
                                 device=dev).train()

            def grads():
                model.zero_grad(set_to_none=True)
                loss = trainer.softmax_cross_entropy(model(images), labels)
                loss.backward()
                return loss.item(), {n: p.grad.clone()
                                     for n, p in model.named_parameters()}
            bn.reset_counts()
            got_loss, got = grads()
            if dict(bn.launch_counts) != {"bn_moments": BN_PER_STEP,
                                          "bn_moments2": BN_PER_STEP}:
                raise AssertionError(f"kernel path launched "
                                     f"{dict(bn.launch_counts)}")
            with plain_path():
                want_loss, want = grads()
            if not math.isclose(got_loss, want_loss, rel_tol=min(tol, 5e-2)):
                raise AssertionError(f"{dtype} loss {got_loss} vs plain "
                                     f"{want_loss}")
            worst_elem = worst_norm = 0.0
            for name, w in want.items():
                g = got[name]
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{dtype} grad {name} not finite")
                scale = max(w.abs().max().item(), 1e-30)
                elem = (g - w).abs().max().item() / scale
                norm = ((g - w).norm() / max(w.norm().item(), 1e-30)).item()
                worst_elem, worst_norm = max(worst_elem, elem), max(
                    worst_norm, norm)
                if dtype == torch.float32:
                    torch.testing.assert_close(
                        g, w, rtol=tol, atol=tol * scale,
                        msg=lambda m, name=name: f"{dtype} grad {name}: {m}")
                elif norm > tol:
                    raise AssertionError(f"{dtype} grad {name}: relative L2 "
                                         f"difference {norm:.3e} > {tol}")
            log(card, f"phase 3c: {dtype} ResNet-50 batch-2 step, kernel vs "
                      f"plain path: loss {got_loss:.6f} vs {want_loss:.6f}; "
                      f"over {len(want)} parameters the largest grad |diff| "
                      f"/ that grad's max |value| {worst_elem:.3e} and "
                      f"relative L2 difference {worst_norm:.3e} (held: "
                      f"{'elementwise' if dtype == torch.float32 else 'L2'} "
                      f"to {tol})")
            del model, got, want
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3d: the parallel path on one card

RING_W, RING_S_LOC, RING_B = 4, 1024, 4


def train_gspmd(card, dev, cfg, batch, want_losses):
    """The flagship through ``trainer.make_gspmd_multi_step`` on a one-card
    mesh (dp = pp = tp = sp = ep = 1, its DeviceMesh over NCCL), its
    parameters placed by ``param_specs``: 10 calls of one step each on the
    batch of phase 3b, from the same seed, launch counts read at every
    step (12 lazy forwards, 12 dq, 12 dk/dv). The loss must fall and equal
    ``make_multi_step``'s (phase 3b) within 2^-8 of its value, one bf16
    rounding. Returns (model, optimizer, multi-step, launches)."""
    mesh = mesh_lib.build_mesh(dp=1)
    model, opt, step, toks = train_lm.build_gspmd_step(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev, mesh)
    if not torch.equal(toks[0], batch):
        raise AssertionError("the GSPMD run's batch is not phase 3b's")
    groups = {a: torch.distributed.get_backend(mesh.group(a))
              for a in mesh.axis_names}
    per_step = {"flash_fwd_lazy": cfg.num_layers,
                "flash_bwd_sm90_dq": cfg.num_layers,
                "flash_bwd_sm90_dkv": cfg.num_layers}
    losses = []
    fa.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = dict(fa.launch_counts)
        losses.append(step(model, opt, toks)[2].item())
        got = {k: v - before.get(k, 0) for k, v in fa.launch_counts.items()}
        if got != per_step:
            raise AssertionError(f"GSPMD step {i} launched {got}, expected "
                                 f"{per_step}")
    launches = dict(fa.launch_counts)
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"GSPMD losses {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    if max(rel) > 2 ** -8:
        raise AssertionError(f"GSPMD losses {losses} differ from "
                             f"make_multi_step's {want_losses}")
    log(card, f"phase 3d: trained gpt2_small_tpu (flash, tied, bf16 logits) "
              f"through make_gspmd_multi_step on a one-card mesh "
              f"{mesh_lib.mesh_layout(mesh)} (process groups {groups}), "
              f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; largest |loss - "
              f"make_multi_step's| / loss {max(rel):.3e} (bound 2^-8); "
              f"launches {launches} ({per_step} every step)")
    return model, opt, step, launches


def run_thread_ranks(world_size, job):
    """``job(r, ring)`` for every rank r of a ThreadRing, each on its own
    thread against this one card; returns the results in rank order and
    raises the first failure."""
    world = ring.ThreadRing(world_size)
    out, errors = [None] * world_size, []

    def rank(r):
        try:
            out[r] = job(r, world.rank(r))
        except Exception:  # noqa: BLE001 — re-raised below
            import traceback
            errors.append(traceback.format_exc())
            world._barrier.abort()
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(world_size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"a thread rank failed: {errors[:1]}")
    return out


def ring_operands(dev, seed=1600):
    """The ring's operands at the model's attention width: q, k, v and dO
    [b 4, global s 4096, h 6, d 128], bf16, unit scale."""
    s = RING_W * RING_S_LOC
    q, k, v = qkv(seed, b=RING_B, s=s, h=6, d=128, dtype=torch.bfloat16,
                  device=dev)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(dev, torch.bfloat16)
    return q, k, v, g


def ring_flash_ranks(q, k, v, g, backward=True):
    """ring_flash forward (and backward) of every rank's shard, each rank
    a thread driving ``ring_flash_fwd``/``ring_flash_bwd`` itself; the
    whole-sequence out (and dq, dk, dv), shards concatenated."""
    d = q.shape[-1]
    blocks = (ring._fit_block(512, RING_S_LOC),) * 2

    def job(r, rk):
        sl = slice(r * RING_S_LOC, (r + 1) * RING_S_LOC)
        qr, kr, vr, gr = (t[:, sl].contiguous() for t in (q, k, v, g))
        out, lse = ring.ring_flash_fwd(qr, kr, vr, rk, True, d ** -0.5,
                                       blocks)
        if not backward:
            return (out,)
        return (out, *ring.ring_flash_bwd(qr, kr, vr, out, lse, gr, rk,
                                          True, d ** -0.5, blocks))
    parts = run_thread_ranks(RING_W, job)
    return [torch.cat([p[i] for p in parts], dim=1)
            for i in range(len(parts[0]))]


def check_ring_flash(card, dev):
    """ring_flash_attention at the model's attention width (h 6, d 128,
    bf16, causal), global s 4096 over W = 4 thread ranks of 1024, b 4,
    forward and backward through the kernels (B1 per pair, causal on the
    diagonal pair and non-causal after; B4/B5 per pair against the merged
    lse, +1e30 on future pairs): held against flash_attention on the whole
    sequence on the card and against the same ring on the plain walks,
    O to two bf16 ulps + 1 % of its largest value, each gradient to two
    ulps + 1 % of its largest magnitude. Returns the run's launches."""
    q, k, v, g = ring_operands(dev)
    fa.reset_launch_counts()
    got = ring_flash_ranks(q, k, v, g)
    launches = dict(fa.launch_counts)
    pairs = RING_W * RING_W
    want_launches = {"flash_fwd_online": pairs, "flash_bwd_sm90_dq": pairs,
                     "flash_bwd_sm90_dkv": pairs}
    if launches != want_launches:
        raise AssertionError(f"ring_flash launched {launches}, expected "
                             f"{want_launches}")
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    whole = fa.flash_attention(*ts, causal=True, device=dev)
    whole.backward(g)
    with plain_path():
        plain = ring_flash_ranks(q, k, v, g)
    fa.reset_launch_counts()
    share = {}
    for label, want in (("whole-sequence flash",
                         [whole.detach()] + [t.grad for t in ts]),
                        ("plain ring", plain)):
        frac = hold(flat(got[0]), flat(want[0]), "O", torch.bfloat16,
                    f"ring_flash vs {label}")[1]
        for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            frac = max(frac, hold_grad(flat(a), flat(w), torch.bfloat16,
                                       f"ring_flash {name} vs {label}")[1])
        share[label] = round(frac, 4)
    log(card, f"phase 3d: ring_flash_attention W={RING_W} thread ranks x "
              f"s {RING_S_LOC} (global 4096), b {RING_B} h 6 d 128 bf16 "
              f"causal, forward and backward: launches {launches}; O, dq, "
              f"dk, dv agree with the whole sequence's flash_attention and "
              f"with the plain ring (largest error as a share of its "
              f"tolerance {share})")
    return launches


def check_seq_parallel_fwd(card, dev):
    """ring_attention over W = 4 thread ranks and ulysses_attention over
    W = 2 (6 heads do not split over 4: that W is refused, as the
    reference refuses it) at the same shapes, forward, against exact
    attention over the whole sequence (bf16 O tolerance)."""
    q, k, v, _ = ring_operands(dev, 1610)
    want = ring.full_attention(q, k, v, causal=True)
    share = {}
    for name, w in (("ring", RING_W), ("ulysses", 2)):
        s_loc = q.shape[1] // w
        fn = getattr(ring, f"{name}_attention")

        def job(r, rk, fn=fn, s_loc=s_loc):
            sl = slice(r * s_loc, (r + 1) * s_loc)
            with torch.no_grad():
                return fn(*(t[:, sl].contiguous() for t in (q, k, v)),
                          axis_name=rk, causal=True)
        got = torch.cat(run_thread_ranks(w, job), dim=1)
        share[f"{name} W={w}"] = round(hold(
            flat(got), flat(want), "O", torch.bfloat16, name)[1], 4)
    try:
        ring.ulysses_attention(q, q, q, axis_name=ring.ThreadRing(4).rank(0))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("ulysses took 6 heads over 4 ranks")
    log(card, f"phase 3d: ring_attention (W=4) and ulysses_attention (W=2) "
              f"at b {RING_B} s 4096 h 6 d 128 bf16 causal, forward, agree "
              f"with exact attention over the whole sequence (largest error "
              f"as a share of its tolerance {share}); W=4 refused: "
              f"{refused!r}")


def check_chunked_ce(card, dev, cfg):
    """chunked_softmax_cross_entropy at the flagship's head (vocab 50304,
    d_model 768, bf16 hidden states, fp32 head weight) at b16 x s1024,
    chunk 8192, against the full loss (bf16 logits, the port's
    softmax_cross_entropy): the value within 2^-8 of it (the full loss
    rounds every logit, and logit - max, to bf16), the gradients of the
    hidden states and the head weight within two bf16 ulps + 1 % of each
    one's largest magnitude."""
    g = torch.Generator().manual_seed(1700)
    hidden = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model,
                         generator=g).to(dev, cfg.dtype)
    weight = (torch.randn(cfg.vocab_size, cfg.d_model, generator=g) *
              cfg.d_model ** -0.5).to(dev)
    targets = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                            generator=g).to(dev)
    weights = torch.ones(targets.shape, device=dev)
    weights[:, -1] = 0.0
    out = {}
    for name in ("full", "chunked"):
        h, w = (t.detach().clone().requires_grad_(True)
                for t in (hidden, weight))
        if name == "full":
            loss = trainer.softmax_cross_entropy(
                tr.head_logits(cfg, h, w), targets, weights)
        else:
            loss = tr.chunked_softmax_cross_entropy(h, w.t(), targets, 8192,
                                                    weights)
        loss.backward()
        out[name] = (loss.item(), h.grad, w.grad)
    rel = abs(out["chunked"][0] - out["full"][0]) / abs(out["full"][0])
    if rel > 2 ** -8:
        raise AssertionError(f"chunked loss {out['chunked'][0]} vs full "
                             f"{out['full'][0]}")
    share = max(hold_grad(a, w, torch.bfloat16, f"chunked CE d{name}")[1]
                for name, a, w in zip(("hidden", "weight"),
                                      out["chunked"][1:], out["full"][1:]))
    log(card, f"phase 3d: chunked_softmax_cross_entropy vocab "
              f"{cfg.vocab_size} chunk 8192 at b{TRAIN_BATCH} x "
              f"s{TRAIN_SEQ}: loss {out['chunked'][0]:.6f} vs full "
              f"{out['full'][0]:.6f} (|diff| / loss {rel:.3e}, bound 2^-8); "
              f"gradients agree (largest error as a share of its tolerance "
              f"{share:.4f})")


# ---------------------------------------------------------------------------
# phase 3e: head dim 256 through the user's entry points


def serve_all_walks(cfg, model, requests, dev):
    """requests[:4] (prompts 16-100: the online and lazy walks), then
    requests[3] again under HVD_FLASH_VARIANT=twopass."""
    serve(cfg, model, requests[:4], dev)
    os.environ["HVD_FLASH_VARIANT"] = "twopass"
    try:
        serve(cfg, model, requests[3:4], dev)
    finally:
        del os.environ["HVD_FLASH_VARIANT"]


def hold_launches(launches, names, what):
    missing = [n for n in names if not launches.get(n)]
    if missing or set(launches) - set(names):
        raise AssertionError(f"{what} launched {launches}; missing "
                             f"{missing}")


def run_wide_heads(card, dev, train_cfg, requests, heads=WIDE_HEADS,
                   names=WIDE_NAMES, phase="3e",
                   serve_layers=WIDE_SERVE_LAYERS,
                   fp32_names=CC_FWD_NAMES + CC_BWD_NAMES):
    """The flagship's width (d_model 768, vocab 50304, d_ff 3072) over
    ``heads`` heads (WIDE_HEADS: 256 each, bf16 on the wgmma kernels;
    DYN_HEADS: 384 each, on the run-time-d kernels): the serving engine,
    at ``serve_layers``
    layers, answers requests[:4] (prompts 16-100: the online and lazy
    walks) and requests[3] again under HVD_FLASH_VARIANT=twopass, then
    the model, depth cut to WIDE_LAYERS, trains WIDE_STEPS steps on one
    batch of TRAIN_BATCH x TRAIN_SEQ through make_gspmd_multi_step on a
    one-card mesh. The counts are zeroed just before and read just
    after: each of the five kernels ``names`` must have launched, and no
    other kernel. With ``fp32_names`` the same requests are served again
    by the WIDE_LAYERS model in fp32, and the training model of that seed
    takes one gradient of its loss on a batch of 2 x TRAIN_SEQ tokens,
    counted apart: each of those kernels (the CUDA-core forward walks and
    backward) must launch, and no other. The loss must fall, and the
    training batch's loss through the kernels must equal the plain
    path's within 2^-8 (launches of that comparison not counted).
    Returns the runs' launches."""
    cfg = dataclasses.replace(train_cfg, num_heads=heads,
                              num_layers=WIDE_LAYERS)
    serve_cfg = dataclasses.replace(cfg, num_layers=serve_layers)
    serve_model = tr.init_params(serve_cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    mesh = mesh_lib.build_mesh(dp=1)
    model, opt, step, toks = train_lm.build_gspmd_step(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev, mesh)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    serve_all_walks(serve_cfg, serve_model, requests, dev)
    serve_s = time.perf_counter() - t0
    losses = [step(model, opt, toks)[2].item() for _ in range(WIDE_STEPS)]
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    hold_launches(launches, names, f"the head-dim-{cfg.head_dim} run")
    fp32 = {}
    if fp32_names:
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        model32 = tr.init_params(cfg32, torch.Generator().manual_seed(0),
                                 device=dev)
        train32 = tr.init_params(cfg32, torch.Generator().manual_seed(0),
                                 device=dev, train=True)
        batch32 = torch.randint(cfg.vocab_size, (2, TRAIN_SEQ),
                                generator=torch.Generator().manual_seed(7)
                                ).to(dev)
        fa.reset_launch_counts()
        serve_all_walks(cfg32, model32, requests, dev)
        tr.lm_loss_fn(train32)(train32, batch32).backward()
        torch.cuda.synchronize()
        fp32 = dict(fa.launch_counts)
        hold_launches(fp32, fp32_names,
                      f"the head-dim-{cfg.head_dim} fp32 serving run and "
                      f"gradient")
        del model32, train32
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"head-dim-{cfg.head_dim} losses {losses}")
    loss_fn = tr.lm_loss_fn(serve_model)
    with torch.no_grad():
        got = loss_fn(serve_model, toks[0]).item()
        with plain_path():
            want = loss_fn(serve_model, toks[0]).item()
    rel = abs(got - want) / abs(want)
    if not math.isfinite(got) or rel > 2 ** -8:
        raise AssertionError(f"head-dim-{cfg.head_dim} loss {got} vs plain "
                             f"{want}")
    fa.reset_launch_counts()
    fp32_note = (f"; fp32 serving and a batch-2 gradient at "
                 f"{cfg.num_layers} layers launched {fp32}" if fp32 else "")
    log(card, f"phase {phase}: d_model {cfg.d_model} over {cfg.num_heads} "
              f"heads of {cfg.head_dim}: served 5 requests (one under "
              f"twopass) at {serve_layers} layers in {serve_s:.2f} s, "
              f"trained {WIDE_STEPS} GSPMD steps at {cfg.num_layers} layers "
              f"at b{TRAIN_BATCH} x s{TRAIN_SEQ}: loss "
              f"{[round(x, 4) for x in losses]}; launches {launches}"
              f"{fp32_note}; loss at {serve_layers} layers through the "
              f"kernels "
              f"{got:.6f} vs plain path {want:.6f} (|diff| / loss "
              f"{rel:.3e}, bound 2^-8)")
    return {**launches, **fp32}


# ---------------------------------------------------------------------------
# phase 3f: serving on the tensor-parallel mesh, phase 3g: the collective
# backends; the ranks of both are threads of this process on the one card
# (NCCL refuses two ranks on one device)

TP_SIZES = (2, 3, 4)
HIER_SLICES = 2
BACKEND_RANKS = 4
BACKEND_BATCH = 2   # rows of TRAIN_SEQ tokens each thread rank trains on
ODD_SHAPES = ((1,), (5,), (7, 3), (1001,), (2 ** 20 + 3,))
# prefill logits under tp against the unsharded engine's: two bf16 ulps
# of each logit (2 · 2^(floor(log2 |logit|) - 7)) plus 1 % of the largest
# |logit|. The tp ranks' row-parallel partial sums are added in fp32 and
# rounded once, as the unsharded product rounds its accumulator, but in
# another order: an element now and then rounds the other way, and the
# flip is carried through the 12 layers into the fp32 head
TP_LOGITS_ATOL_SHARE = 1e-2
# The prefill logits are held to that bound on the model at full width
# cut to TP_CHECK_LAYERS layers: at the full 12 layers the bf16 roundings
# that any change of a product's summation order flips are carried into
# deviations above the bound, in the unsharded engine itself as much as
# under tp, so there the tp engine is held to TP_FLOOR_FACTOR times the
# unsharded engine's own deviation when every product's fp32 sum is taken
# in another order (both printed)
TP_CHECK_LAYERS = 2
TP_FLOOR_FACTOR = 2.0
# phase 3f serves each request's first TP_NEW_TOKENS tokens, a cut of its
# decode depth for time (the thread ranks' decode steps were most of the
# phase: tp 4 took 43 s for the 388 tokens of the phase-3 requests);
# every check is per prefill or per decode step
TP_NEW_TOKENS = 16
# an fp32 sum of 4 values taken in another order: each element within
# 1e-6 of the sum of the values' magnitudes (3 roundings of 2^-24 each)
SUM_ORDER_TOL = 1e-6


def bf16_ulps(w, n):
    """``n`` bf16 ulps of each value of ``w``: n · 2^(floor(log2 |w|) - 7)
    (8 significant bits)."""
    e = torch.floor(torch.log2(w.abs().clamp(min=1e-30)))
    return n * torch.exp2(e - 7)


def logit_deviation(cfg, weights, requests, want, dev):
    """(largest |diff|, largest share of the bound) of every request's
    prefill logits, all positions, through ``weights`` against ``want``
    (request id -> (logits, 1 % of their largest |value|))."""
    worst, share = 0.0, 0.0
    for q in requests:
        got = prefill_forward(cfg, weights, torch.tensor([q.prompt],
                                                         device=dev))[0][0]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{q.request_id}: logits not finite")
        w, atol = want[q.request_id]
        err = (got - w).abs()
        worst = max(worst, err.max().item())
        share = max(share, (err / (atol + bf16_ulps(w, 2))).max().item())
    return worst, share


def unsharded_logits(cfg, model, requests, dev):
    """Request id -> (prefill logits, 1 % of their largest |value|)."""
    out = {}
    for q in requests:
        logits = prefill_forward(cfg, model, torch.tensor([q.prompt],
                                                          device=dev))[0][0]
        out[q.request_id] = (logits, TP_LOGITS_ATOL_SHARE *
                             logits.abs().max().item())
    return out


def run_mesh_ranks(views, job):
    """``job(r, view)`` for every rank of a mesh of thread ranks
    (``mesh_lib.thread_meshes``), each on its own thread with its view as
    its global mesh (``use_mesh``), against this one card; returns the
    results in rank order and raises the first failure, aborting every
    rank's exchanges."""
    out, errors = [None] * len(views), []

    def rank(r):
        try:
            with mesh_lib.use_mesh(views[r]):
                out[r] = job(r, views[r])
        except Exception:  # noqa: BLE001 — re-raised below
            import traceback
            errors.append(traceback.format_exc())
            for v in views:
                for c in list(v._comms.values()) + [v._world]:
                    c.world._barrier.abort()
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(len(views))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"a thread rank failed: {errors[:1]}")
    return out


def serve_on(cfg, model, requests, dev, mesh=None, max_len=SERVE_MAX_LEN):
    """``serve``'s engine and its tokens by request id."""
    results, _, _, engine = serve(cfg, model, requests, dev, mesh, max_len)
    return engine, {r.request_id: list(r.tokens) for r in results}


def tp_views(tp):
    return mesh_lib.thread_meshes(mesh_lib.build_mesh(
        tp=tp, devices=list(range(tp))))


def check_serving_mesh(card, dev, cfg, model, requests):
    """GPT-2-small (bf16, 6 heads of 128, full width and depth) served by
    tp engines of 2, 3 and 4 thread ranks (at tp 4 the heads do not split:
    every rank computes all of them, the KV cache replicated) on the
    phase-3 requests, then requests[6:9] again under
    HVD_FLASH_VARIANT=twopass; each held to the unsharded engine: every
    request's prefill logits (all positions) within two bf16 ulps plus 1 %
    of the largest |logit|, the generated tokens' agreement printed, KV
    bytes per rank (at least 1.9x below at tp 2), ``resharding_report``
    empty, one decode step's collectives exactly 2 · layers activation
    all-reduces and one logits gather (no weight collective), and the
    prefill kernels each rank launched (online and lazy; twopass in its
    run). The logits bound is asserted on the model cut to
    TP_CHECK_LAYERS layers at full width; at full depth the tp logits are
    held to TP_FLOOR_FACTOR times the unsharded engine's deviation under
    another summation order of every product (see TP_CHECK_LAYERS). Then
    the tiny fp32 model at tp 2, token for token equal to the unsharded
    engine. Each request is cut to its first TP_NEW_TOKENS tokens."""
    from horovod_tpu_torch.serving.decode import ServingWeights
    requests = [dataclasses.replace(q, max_new_tokens=min(
        q.max_new_tokens, TP_NEW_TOKENS)) for q in requests]
    base_engine, base = serve_on(cfg, model, requests, dev)
    base_bytes = base_engine.kv.per_chip_bytes()
    del base_engine
    want = unsharded_logits(cfg, model, requests, dev)
    # the noise floor: every dense product's fp32 sum in another order
    # (the exact products of the bf16 operands through an fp32 GEMM)
    reordered = ServingWeights(cfg, model)
    reordered.dense = lambda x, w: torch.nn.functional.linear(
        x.to(cfg.dtype).float(), w.to(cfg.dtype).float()).to(cfg.dtype)
    floor = logit_deviation(cfg, reordered, requests, want, dev)
    cut = dataclasses.replace(cfg, num_layers=TP_CHECK_LAYERS)
    cut_model = tr.init_params(cut, torch.Generator().manual_seed(0),
                               device=dev)
    cut_want = unsharded_logits(cut, cut_model, requests, dev)
    log(card, f"phase 3f: the unsharded engine's own prefill logits with "
              f"every product's fp32 sum in another order: max |diff| "
              f"{floor[0]:.3e}, {floor[1]:.3f} of the bound (two bf16 ulps "
              f"+ 1 % of the largest |logit|) at {cfg.num_layers} layers")
    expect_counts = {"activation_all_reduce": 2 * cfg.num_layers,
                     "logits_gather": 1}
    n_tokens = sum(len(t) for t in base.values())
    for tp in TP_SIZES:
        def job(r, view):
            fa.thread_launch_counts().clear()
            t0 = time.perf_counter()
            engine, tokens = serve_on(cfg, model, requests, dev, view)
            wall = time.perf_counter() - t0
            launches = dict(fa.thread_launch_counts())
            engine.params.counts.clear()
            report = engine.resharding_report()
            counts = dict(engine.params.counts)
            worst, share = logit_deviation(cfg, engine.params, requests,
                                           want, dev)
            cut_worst, cut_share = logit_deviation(
                cut, ServingWeights(cut, cut_model, view), requests,
                cut_want, dev)
            return {"tokens": tokens, "wall": wall, "launches": launches,
                    "report": report, "counts": counts,
                    "kv_bytes": engine.kv.per_chip_bytes(),
                    "worst": worst, "share": share, "cut_worst": cut_worst,
                    "cut_share": cut_share}
        views = tp_views(tp)
        ranks = run_mesh_ranks(views, job)
        os.environ["HVD_FLASH_VARIANT"] = "twopass"
        try:
            def twopass(r, view):
                fa.thread_launch_counts().clear()
                serve_on(cfg, model, requests[6:9], dev, view)
                return dict(fa.thread_launch_counts())
            tp_twopass = run_mesh_ranks(tp_views(tp), twopass)
        finally:
            del os.environ["HVD_FLASH_VARIANT"]
        for r, got in enumerate(ranks):
            where = f"tp {tp} rank {r}"
            if got["tokens"] != ranks[0]["tokens"]:
                raise AssertionError(f"{where}: tokens differ from rank 0's")
            if got["report"]:
                raise AssertionError(f"{where}: resharding {got['report']}")
            if got["counts"] != expect_counts:
                raise AssertionError(f"{where}: a decode step's collectives "
                                     f"{got['counts']}, want {expect_counts}")
            if set(got["launches"]) != {"flash_fwd_online",
                                        "flash_fwd_lazy"} or \
                    set(tp_twopass[r]) != {"flash_fwd_twopass"}:
                raise AssertionError(f"{where}: launched {got['launches']}, "
                                     f"under twopass {tp_twopass[r]}")
            if got["cut_share"] > 1.0:
                raise AssertionError(f"{where}: prefill logits at "
                                     f"{TP_CHECK_LAYERS} layers off by "
                                     f"{got['cut_worst']:.3e}, "
                                     f"{got['cut_share']:.2f} of the bound")
            if got["share"] > TP_FLOOR_FACTOR * floor[1]:
                raise AssertionError(f"{where}: prefill logits off by "
                                     f"{got['worst']:.3e}, {got['share']:.2f}"
                                     f" of the bound, over {TP_FLOOR_FACTOR}"
                                     f" x the floor {floor[1]:.2f}")
        ratio = base_bytes / ranks[0]["kv_bytes"]
        if tp == 2 and ratio < 1.9:
            raise AssertionError(f"tp 2 KV bytes per rank only {ratio:.2f}x "
                                 f"below the unsharded engine's")
        agree = sum(a == b for rid, toks in ranks[0]["tokens"].items()
                    for a, b in zip(toks, base[rid]))
        log(card, f"phase 3f: tp {tp} ({len(views)} thread ranks, "
                  f"{cfg.num_heads} heads: "
                  f"{'split' if cfg.num_heads % tp == 0 else 'replicated'}"
                  f"): served {len(requests)} requests in "
                  f"{max(g['wall'] for g in ranks):.3f} s; KV bytes per rank "
                  f"{ranks[0]['kv_bytes']} ({ratio:.2f}x below the "
                  f"unsharded {base_bytes}); prefill logits of every request "
                  f"(all positions) at {TP_CHECK_LAYERS} layers max |diff| "
                  f"{max(g['cut_worst'] for g in ranks):.3e} "
                  f"({max(g['cut_share'] for g in ranks):.3f} of the bound), "
                  f"at {cfg.num_layers} layers "
                  f"{max(g['worst'] for g in ranks):.3e} "
                  f"({max(g['share'] for g in ranks):.3f} of the bound, "
                  f"the floor {floor[1]:.3f}); "
                  f"generated tokens equal to the unsharded engine's "
                  f"{agree}/{n_tokens}; resharding_report empty on every "
                  f"rank; one decode step's collectives {expect_counts}, no "
                  f"weight collective; launches per rank "
                  f"{[g['launches'] for g in ranks]}, under twopass "
                  f"{tp_twopass}")
    # fp32: token for token at tp 2
    cfg32 = tr.TransformerConfig.tiny(dtype=torch.float32,
                                      attention_impl="flash")
    model32 = tr.init_params(cfg32, torch.Generator().manual_seed(0),
                             device=dev)
    short = [Request(f"t{i}", tuple((7 * i + 13 * j) % 256 for j in
                                    range(plen)), max_new_tokens=16)
             for i, plen in enumerate((5, 17, 40, 70))]
    _, want32 = serve_on(cfg32, model32, short, dev, max_len=128)
    got32 = run_mesh_ranks(tp_views(2), lambda r, view: serve_on(
        cfg32, model32, short, dev, view, max_len=128)[1])
    if any(g != want32 for g in got32):
        raise AssertionError(f"tiny fp32 at tp 2: {got32} != {want32}")
    log(card, f"phase 3f: tiny fp32 at tp 2: {len(short)} requests, "
              f"{sum(len(t) for t in want32.values())} tokens equal to the "
              f"unsharded engine's on both ranks")


def _rank_inputs(shapes, r, integer, dev):
    g = torch.Generator(device=dev).manual_seed(3100 + r + 10 * integer)
    if integer:
        return [torch.randint(-64, 64, s, generator=g, device=dev).float()
                for s in shapes]
    return [torch.randn(s, generator=g, device=dev) for s in shapes]


def check_collective_backends(card, dev, base_model, vocab):
    """4 thread ranks as slices 2 x chips 2. ``hierarchical_allreduce``,
    ``ring_all_reduce`` and the flat sum (the world group's own
    all-reduce) of the flagship's whole gradient set (one tensor per
    parameter, 151.9M fp32 elements) and ODD_SHAPES (sizes 4 does not
    divide), each rank's own values: exactly the sum taken on one rank of
    integer-valued inputs, and within SUM_ORDER_TOL of the magnitudes'
    sum on unit-scale ones; each timed (the slowest rank, host clock
    after a device sync). Then one DistributedOptimizer(AdamW(3e-4,
    mu_dtype=bf16)) flagship step per rank (its own batch of
    BACKEND_BATCH x TRAIN_SEQ) with no flag, HOROVOD_RING_ALLREDUCE and
    HOROVOD_HIERARCHICAL_ALLREDUCE: the manager's selections counted
    (only the flag's backend), the averaged gradients equal the flag-less
    route's within SUM_ORDER_TOL of the ranks' gradient magnitudes, and
    the parameters equal too, except where the averaged gradient is so
    near 0 that Adam's first, sign-like update turns a rounding into a
    step."""
    import copy
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.common import state as state_mod
    from horovod_tpu_torch.ops import collective_ops as cops
    from horovod_tpu_torch.ops import operation_manager as om
    from horovod_tpu_torch.parallel import hierarchical, ring_collectives
    views = mesh_lib.thread_meshes(mesh_lib.build_hierarchical_mesh(
        HIER_SLICES, devices=list(range(BACKEND_RANKS))))
    # the flagship's gradients all have sizes 4 divides: a few more that
    # it does not, as a model with odd widths gives
    shapes = [tuple(p.shape) for p in base_model.parameters()] + list(
        ODD_SHAPES)
    n_el = sum(math.prod(s) for s in shapes)
    odd = sum(math.prod(s) % BACKEND_RANKS != 0 for s in shapes)
    routes = {"hierarchical": hierarchical.hierarchical_allreduce,
              "ring": ring_collectives.ring_all_reduce,
              "flat": lambda t: cops.comm_of("hvd").all_reduce(t)}
    timing = {}
    for integer in (True, False):
        inputs = [_rank_inputs(shapes, r, integer, dev)
                  for r in range(BACKEND_RANKS)]
        total = [sum(x[i] for x in inputs) for i in range(len(shapes))]
        mags = None if integer else [
            sum(x[i].abs() for x in inputs) for i in range(len(shapes))]
        for name, fn in routes.items():
            def job(r, view, fn=fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = [fn(x) for x in inputs[r]]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                share = 0.0
                for i, o in enumerate(outs):
                    if integer:
                        if not torch.equal(o, total[i]):
                            raise AssertionError(
                                f"{name} rank {r} tensor {i}: not exact")
                    else:
                        share = max(share, ((o - total[i]).abs() / (
                            SUM_ORDER_TOL * mags[i] + 1e-30)).max().item())
                return ms, share
            got = run_mesh_ranks(views, job)
            share = max(g[1] for g in got)
            if share > 1.0:
                raise AssertionError(f"{name}: unit-scale sum off by "
                                     f"{share:.2f} of the tolerance")
            timing[(name, integer)] = (max(g[0] for g in got), share)
        del inputs, total, mags
        torch.cuda.empty_cache()
    shares = {k[0]: round(v[1], 4) for k, v in timing.items() if not k[1]}
    ms = {k[0] + ("/int" if k[1] else "/unit"): round(v[0], 3)
          for k, v in timing.items()}
    log(card, f"phase 3g: slices {HIER_SLICES} x chips "
              f"{BACKEND_RANKS // HIER_SLICES} thread ranks, the flagship's "
              f"gradient tensors and {len(ODD_SHAPES)} more ({len(shapes)} "
              f"tensors, {n_el} fp32 elements, {odd} of sizes 4 does not "
              f"divide): hierarchical, ring and flat "
              f"sums exact on integer-valued inputs; on unit-scale inputs "
              f"the largest error as a share of its tolerance {shares}; ms "
              f"per pass over the set (slowest rank; thread ranks on one "
              f"card share its stream and the interpreter lock) {ms}")

    # one flagship step per route through DistributedOptimizer
    rng = torch.Generator().manual_seed(3200)
    toks = torch.randint(0, vocab, (BACKEND_RANKS, BACKEND_BATCH, TRAIN_SEQ),
                         generator=rng).to(dev)
    config = state_mod.global_state().config
    manager = om.get_operation_manager()
    want, mags, report = None, None, {}
    for flag in (None, "ring_allreduce", "hierarchical_allreduce"):
        if flag:
            setattr(config, flag, True)
        manager.selected.clear()
        try:
            def job(r, view):
                model = copy.deepcopy(base_model)
                params = [p for p in model.parameters()]
                for p in params:
                    p.grad = None
                opt = optim.DistributedOptimizer(
                    optim.AdamW(params, 3e-4, mu_dtype=torch.bfloat16),
                    named_parameters=model.named_parameters(),
                    process_group=view.world_comm())
                loss = tr.lm_loss_fn(model)(model, toks[r])
                loss.backward()
                local = torch.cat([p.grad.reshape(-1) for p in params])
                opt.step()
                out = (loss.item(),
                       torch.cat([p.grad.reshape(-1) for p in params]),
                       torch.cat([p.detach().reshape(-1) for p in params]),
                       local.abs() if flag is None else None)
                del model, opt, params
                return out
            got = run_mesh_ranks(views, job)
        finally:
            if flag:
                setattr(config, flag, False)
        selected = dict(manager.selected)
        backend = {None: "nccl", "ring_allreduce": "ring",
                   "hierarchical_allreduce": "hierarchical"}[flag]
        if set(selected) != {backend}:
            raise AssertionError(f"flag {flag}: manager selected {selected}")
        if flag is None:
            want = [(g[1], g[2]) for g in got]
            mags = sum(g[3] for g in got) / BACKEND_RANKS
            report[backend] = (selected, [round(g[0], 6) for g in got])
            continue
        worst, moved, moved_g = 0.0, 0, 0.0
        for r, (loss, grads, params, _) in enumerate(got):
            w_g, w_p = want[r]
            worst = max(worst, ((grads - w_g).abs() / (
                SUM_ORDER_TOL * mags + 1e-30)).max().item())
            off = (params - w_p).abs() > 1e-6 * w_p.abs().max()
            moved += int(off.sum())
            if off.any():
                moved_g = max(moved_g, w_g[off].abs().max().item())
        if worst > 1.0 or moved_g > 1e-6 * mags.max().item():
            raise AssertionError(f"flag {flag}: averaged gradients off by "
                                 f"{worst:.2f} of the tolerance; {moved} "
                                 f"parameters moved, their |grad| up to "
                                 f"{moved_g:.3e}")
        report[backend] = (selected, [round(g[0], 6) for g in got],
                           round(worst, 4), moved)
        del got
        # free the ranks' models and optimizers before the next route (and
        # phase 4, whose peak-memory readings count every live allocation)
        gc.collect()
        torch.cuda.empty_cache()
    log(card, f"phase 3g: one DistributedOptimizer(AdamW) flagship step per "
              f"rank (b{BACKEND_BATCH} x s{TRAIN_SEQ} each) under each route "
              f"(selections, losses per rank, then the averaged gradients' "
              f"largest error as a share of the tolerance and the count of "
              f"parameters differing from the NCCL route's by more than "
              f"1e-6 of their largest): {report}")


# ---------------------------------------------------------------------------
# phase 4: timings of the training path


def time_pair(fn, iters=50):
    """(event ms, profiler ms, kept ms, which) per call: CUDA events over
    ``iters`` back-to-back calls, and torch.profiler's device time beside
    it; the profiler's figure is kept unless it reads under 0.8 of the
    event figure (the profiler has lost events on this card), then the
    event figure is."""
    ev, dvc = time_ms(fn, iters, 5), device_ms(fn, iters, False)
    if dvc is None or dvc < 0.8 * ev:
        return ev, dvc, ev, "event"
    return ev, dvc, dvc, "profiler"


def time_bwd_kernels(card, dev, launches, errs):
    """The wgmma/TMA dq and dk/dv (B4, B5) at the training shape (b=16,
    h=6, d=128, causal s=1024, bf16): device ms against the bound, their
    plain versions at the kernels' tiles, their sum, and SDPA's backward
    (one call computing dq, dk and dv) as the library figure, all timed the
    same way (``time_pair``); returns the kernels' JSON entries."""
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 6, 128
    q, k, v = qkv(80, b=b, s=s, h=h, d=d, dtype=torch.bfloat16, device=dev)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(81)).to(
        dev, torch.bfloat16)
    qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
    scale = d ** -0.5
    out, lse = fa._kernel_fwd(qf, kf, vf, True, scale, "lazy")
    delta = ref.flash_delta(out, gf)
    ext = fa.extension()
    args = (True, float(scale * fa.LOG2E), float(scale))
    dq_walk, dkv_walk = fa.bwd_kernel_blocks(qf, kf)
    rows = dq_walk[0]
    dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))

    def k_dq():
        ext.flash_bwd_sm90_dq(qf, kf, vf, gf, lse, delta, dq, *args, rows)

    def k_dkv():
        ext.flash_bwd_sm90_dkv(qf, kf, vf, gf, lse, delta, dk, dv, *args)
    calls = {
        "dq": (k_dq, lambda: ref.flash_bwd_dq(qf, kf, vf, gf, lse, delta,
                                              True, *dq_walk, scale)),
        "dkv": (k_dkv, lambda: ref.flash_bwd_dkv(qf, kf, vf, gf, lse, delta,
                                                 True, *dkv_walk, scale))}
    # SDPA on [b, h, s, d]; its backward graph is kept, so each call
    # times the backward alone
    qs, ks, vs = (t.reshape(b, h, s, d).detach().requires_grad_(True)
                  for t in (qf, kf, vf))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                         is_causal=True)
    go = gf.reshape(b, h, s, d)

    def library():
        return torch.autograd.grad(o, (qs, ks, vs), go, retain_graph=True)
    lib = time_pair(library)
    pair = time_pair(lambda: (k_dq(), k_dkv()))
    entries = []
    for name, (kernel, plain) in calls.items():
        kt = time_pair(kernel)
        plain_ms = device_ms(plain, PLAIN_ITERS) or time_ms(plain, 2, 1)
        ops, nbytes = bwd_work(b * h, s, d, True, 2, name)
        b_ms, b_by = bound(ops, nbytes, PEAK_BF16_FLOPS)
        entries.append({
            "name": f"flash_bwd_sm90_{name}", "route": "cuda",
            "source": BWD_SOURCE, "replaces": REPLACES[name],
            "launches": launches.get(f"flash_bwd_sm90_{name}", 0),
            "max_abs_err": errs[name], "ms": kt[2],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib[2]})
        log(card, f"phase 4: flash_bwd_sm90_{name} bf16 causal b={b} h={h} "
                  f"d={d} s={s} (walk {dq_walk if name == 'dq' else dkv_walk}"
                  f"): event ms {kt[0]:.5f}, profiler ms {kt[1]}, kept "
                  f"{kt[2]:.5f} ({kt[3]}); plain {plain_ms:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by}; {ops} operations, {nbytes} bytes), "
                  f"{b_ms / kt[2]:.1%} of it; {kt[2] / lib[2]:.2f}x SDPA's "
                  f"backward")
    ops = sum(bwd_work(b * h, s, d, True, 2, n_)[0] for n_ in calls)
    log(card, f"phase 4: at the training shape, dq + dk/dv back to back: "
              f"event ms {pair[0]:.5f}, profiler ms {pair[1]}, kept "
              f"{pair[2]:.5f} ({pair[3]}), {ops / PEAK_BF16_FLOPS * 1e3 / pair[2]:.1%} "
              f"of the pair's operations bound, {pair[2] / lib[2]:.2f}x SDPA's "
              f"backward; SDPA backward (dq, dk, dv in one call): event ms "
              f"{lib[0]:.5f}, profiler ms {lib[1]}, kept {lib[2]:.5f} "
              f"({lib[3]})")
    return entries


def time_fwd(card, dev, variant, b, s, h, d, seed):
    """One causal bf16 forward shape: device ms per call (profiler; the
    CUDA-event figure where it records nothing) of the kernel, its plain
    version at the kernel's tiles and SDPA's forward, and the bound;
    returns (ms by call, bound ms, what bounds it)."""
    qf, kf, vf = (flat(t) for t in qkv(seed, b=b, s=s, h=h, d=d,
                                       dtype=torch.bfloat16, device=dev))
    scale = d ** -0.5
    blocks = fa.kernel_blocks(qf, kf, variant)
    calls = {
        "kernel": lambda: fa._kernel_fwd(qf, kf, vf, True, scale, variant),
        "plain": lambda: ref.FWD[variant](qf, kf, vf, True, *blocks, scale),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            *(t.view(b, h, s, d) for t in (qf, kf, vf)), is_causal=True)}
    ev = {k_: time_ms(fn, *((2, 1) if k_ == "plain" else ()))
          for k_, fn in calls.items()}
    dvc = {k_: device_ms(fn, PLAIN_ITERS if k_ == "plain" else 20, False)
           for k_, fn in calls.items()}
    ms = {k_: dvc[k_] if dvc[k_] is not None else ev[k_] for k_ in ev}
    ops, nbytes = attention_work(b * h, s, d, True, 2)
    b_ms, b_by = bound(ops, nbytes, PEAK_BF16_FLOPS)
    log(card, f"phase 4: {variant} bf16 causal b={b} h={h} d={d} s={s} "
              f"(CTA {blocks[0]} query rows, {blocks[1]}-key tiles): device "
              f"ms (profiler) {dvc}, event ms per call {ev}, bound "
              f"{b_ms:.6f} ms ({b_by}; {ops} operations, {nbytes} bytes); "
              f"{b_ms / ms['kernel']:.1%} of the bound, "
              f"{ms['kernel'] / ms['library']:.2f}x SDPA's forward")
    return ms, b_ms, b_by


def time_fwd_training(card, dev, variant):
    """A forward variant at the training shape (b=16, h=6, d=128, causal
    s=1024, bf16); returns the keys added to its JSON entry."""
    ms, b_ms, _ = time_fwd(card, dev, variant, TRAIN_BATCH, TRAIN_SEQ, 6,
                           128, 82)
    return {"train_ms": ms["kernel"], "train_plain_ms": ms["plain"],
            "train_bound_ms": b_ms, "train_library_ms": ms["library"]}


def time_fwd_host(card, dev, h, d):
    """Host time per forward launch (no synchronisation) of the online and
    lazy walks, both on the wgmma/TMA kernel, which encodes three TMA
    tensor maps per launch, at a shape whose device time is a few
    microseconds."""
    qf, kf, vf = (flat(t) for t in qkv(83, b=1, s=128, h=h, d=d,
                                       dtype=torch.bfloat16, device=dev))
    us = {}
    for variant in ("lazy", "online"):
        for _ in range(20):
            fa._kernel_fwd(qf, kf, vf, True, d ** -0.5, variant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fa._kernel_fwd(qf, kf, vf, True, d ** -0.5, variant)
        us[variant] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    log(card, f"phase 4: host us per forward launch through _kernel_fwd "
              f"(b=1 h={h} d={d} s=128, 500 launches, no sync): "
              f"{ {k_: round(v_, 2) for k_, v_ in us.items()} } (both walks "
              f"on the wgmma kernel)")


def time_launch_floor(card):
    """An empty kernel launched back to back: the floor under any launch's
    device time per call."""
    ev, prof = fwd_ab.launch_floor()
    log(card, f"phase 4: empty kernel launched back to back (200 launches): "
              f"event ms per launch {ev:.6f}, profiler ms per launch "
              f"{prof:.6f}")


def time_head_dim_cost(card, dev):
    """What a head dim between the compiled ones costs: the public
    flash_attention at d 96 (zero-padded to 128 on the host, and the
    output and gradients sliced back) against d 128, at the training shape
    (b=16, h=6, causal s=1024, bf16), forward alone and forward with
    backward, device ms by profiler and by CUDA events."""
    row = {}
    for d in (128, 96):
        q, k, v = (t.requires_grad_(True) for t in qkv(
            84, b=TRAIN_BATCH, s=TRAIN_SEQ, h=6, d=d, dtype=torch.bfloat16,
            device=dev))
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            85)).to(dev, torch.bfloat16)

        def fwd():
            with torch.no_grad():
                return fa.flash_attention(q, k, v, causal=True, device=dev)

        def fwd_bwd():
            torch.autograd.grad(fa.flash_attention(q, k, v, causal=True,
                                                   device=dev), (q, k, v), g)
        for name, fn in (("fwd", fwd), ("fwd+bwd", fwd_bwd)):
            row[f"d{d} {name}"] = (device_ms(fn, 10), time_ms(fn, 10))
    # the ratio of profiler figures, of event figures where the profiler
    # recorded nothing for either
    ratio = {n: (row[f"d96 {n}"][0] / row[f"d128 {n}"][0]
                 if row[f"d96 {n}"][0] and row[f"d128 {n}"][0]
                 else row[f"d96 {n}"][1] / row[f"d128 {n}"][1])
             for n in ("fwd", "fwd+bwd")}
    log(card, f"phase 4: flash_attention bf16 causal b={TRAIN_BATCH} h=6 "
              f"s={TRAIN_SEQ}, d 96 padded to 128 against d 128, (device ms "
              f"by profiler, event ms) per call: {row}; d 96 / d 128: fwd "
              f"{ratio['fwd']:.3f}, fwd+bwd {ratio['fwd+bwd']:.3f}")


def time_training(card, dev, model, opt, batch, cfg):
    """ms/step, tokens/s and MFU of the flagship step, make_multi_step
    over 10 steps per window (one warm-up, three timed, each ending in a
    read of the loss), and where one step's device time goes."""
    loss_fn = tr.lm_loss_fn(model)
    multi = trainer.make_multi_step(model, opt, loss_fn)
    stacked = batch.expand(TRAIN_STEPS, *batch.shape)
    multi(stacked).item()
    window_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        multi(stacked).item()
        window_s.append((time.perf_counter() - t0) / TRAIN_STEPS)
    meta = {"batch_per_chip": TRAIN_BATCH, "seq": TRAIN_SEQ, "cfg": cfg,
            "model": "gpt2-small-tpu-flash"}
    m = train_lm.transformer_lm_metrics(window_s, meta,
                                        train_lm.peak_bf16_flops(dev))
    step = trainer.make_train_step(model, opt, loss_fn)
    busy, by_name = device_profile(lambda: step(batch), iters=2)
    by_class = {}
    for name, ms in by_name.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name),
                                                    0.0) + ms
    by_op = device_by_op(lambda: step(batch))
    # the two parts the layers' operators do not show apart: the loss
    # over the [b, s, vocab] logits (forward and backward) and the update
    logits = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size),
                         generator=torch.Generator(dev).manual_seed(2),
                         device=dev, dtype=cfg.dtype).requires_grad_(True)
    targets = torch.roll(batch, -1, dims=1)
    weights = torch.ones(batch.shape, device=dev)
    weights[:, -1] = 0.0

    def loss_part():
        logits.grad = None
        trainer.softmax_cross_entropy(logits, targets, weights).backward()
    loss_ms = device_ms(loss_part, iters=2)
    del logits
    opt_ms = device_ms(opt.step, iters=2)
    mfu = f"{m['mfu']:.4f}" if m["mfu"] is not None else "n/a"
    log(card, f"phase 4: training gpt2_small_tpu b={TRAIN_BATCH} "
              f"s={TRAIN_SEQ}: {m['ms_per_step']:.3f} ms/step best of 3 "
              f"windows (mean {m['ms_per_step_mean']:.3f}, +- "
              f"{m['ms_per_step_pm']:.3f}), {m['tokens_per_sec_per_chip']:.1f} "
              f"tokens/s, MFU {mfu} (dense bf16 peak of this card); one step "
              f"{busy:.3f} ms device (busy {busy / m['ms_per_step']:.1%} of "
              f"the best ms/step); device ms by kernel family "
              f"{ {k: round(v, 3) for k, v in sorted(by_class.items())} }; "
              f"top device ms: {top_kernels(by_name, 10)}")
    log(card, f"phase 4: of one training step's {busy:.3f} device ms, the "
              f"loss (cross entropy forward and backward over the "
              f"{cfg.dtype} logits) takes {loss_ms:.3f}, the optimizer "
              f"update (AdamW, mu bf16, {sum(p.numel() for p in model.parameters())} "
              f"parameters) {opt_ms:.3f}, the rest (embedding, "
              f"{cfg.num_layers} layers, head) {busy - loss_ms - opt_ms:.3f}; "
              f"by aten operator (self time): " +
        "; ".join(f"{k} {v:.3f}" for k, v in by_op[:12]))
    return m


def time_gspmd(card, dev, model, opt, step, batch, multi):
    """ms/step of the GSPMD flagship step (``make_gspmd_multi_step``, one
    call of 10 steps per window, one warm-up window and three timed ones,
    each ending in a read of the loss), beside ``make_multi_step``'s
    figures from ``time_training`` (``multi``)."""
    stacked = batch.expand(TRAIN_STEPS, *batch.shape)
    step(model, opt, stacked)[2].item()
    window_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(model, opt, stacked)[2].item()
        window_s.append((time.perf_counter() - t0) / TRAIN_STEPS)
    meta = {"batch_per_chip": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "cfg": model.cfg, "model": "gpt2-small-tpu-flash"}
    m = train_lm.transformer_lm_metrics(window_s, meta,
                                        train_lm.peak_bf16_flops(dev))
    busy = device_ms(lambda: step(model, opt, batch[None]), iters=2)
    log(card, f"phase 4: GSPMD step (make_gspmd_multi_step, one-card mesh) "
              f"b={TRAIN_BATCH} s={TRAIN_SEQ}: {m['ms_per_step']:.3f} "
              f"ms/step best of 3 windows (mean {m['ms_per_step_mean']:.3f}, "
              f"+- {m['ms_per_step_pm']:.3f}), "
              f"{m['tokens_per_sec_per_chip']:.1f} tokens/s, one step "
              f"{busy:.3f} ms device; make_multi_step in this run: "
              f"{multi['ms_per_step']:.3f} ms/step (mean "
              f"{multi['ms_per_step_mean']:.3f}), GSPMD / make_multi_step "
              f"{m['ms_per_step'] / multi['ms_per_step']:.3f}")


def time_ring(card, dev):
    """ring_flash W = 4 on thread ranks (global s 4096, b 4, h 6, d 128,
    bf16, causal), forward alone and forward + backward, beside
    flash_attention on the whole sequence: the device ms of every kernel
    the call runs (profiler) and the events' span over the call. The ring
    runs every pair, the future ones too (as the reference does): 14 of
    its 16 pairs carry work against the whole sequence's 8 causal
    blocks' worth."""
    q, k, v, g = ring_operands(dev, 1620)
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def whole_fwd():
        with torch.no_grad():
            return fa.flash_attention(q, k, v, causal=True, device=dev)

    def whole_fwd_bwd():
        torch.autograd.grad(fa.flash_attention(*ts, causal=True,
                                               device=dev), ts, g)
    calls = {"ring fwd": lambda: ring_flash_ranks(q, k, v, g, False),
             "ring fwd+bwd": lambda: ring_flash_ranks(q, k, v, g),
             "whole fwd": whole_fwd, "whole fwd+bwd": whole_fwd_bwd}
    row, families = {}, {}
    for name, fn in calls.items():
        busy, by_name = device_profile(fn, 3)
        row[name] = (busy, time_ms(fn, 3, 1))
        families[name] = {}
        for kname, ms in by_name.items():
            fam = kernel_class(kname)
            families[name][fam] = round(families[name].get(fam, 0.0) + ms, 4)
    fa.reset_launch_counts()
    log(card, f"phase 4: ring_flash W={RING_W} thread ranks, b {RING_B} "
              f"global s 4096 h 6 d 128 bf16 causal, (device ms by profiler, "
              f"event span ms) per call: "
              f"{ {k_: (round(a, 4), round(b, 4)) for k_, (a, b) in row.items()} }; "
              f"ring / whole: fwd {row['ring fwd'][0] / row['whole fwd'][0]:.3f}, "
              f"fwd+bwd {row['ring fwd+bwd'][0] / row['whole fwd+bwd'][0]:.3f}; "
              f"device ms by kernel family {families}")


def time_memory_and_remat(card, dev, model, opt, cfg, batch):
    """The flagship's peak device memory (torch.cuda.max_memory_allocated
    over one loss forward and backward, the weights, their gradients and
    the optimizer's state included) with vocab_chunk 0 and 8192; then
    ms/step (CUDA events over 5 steps after one warm-up step) and the
    peak of a training step with remat off and on (cfg.remat, no policy:
    every block recomputed in the backward)."""
    peak = {}
    for chunk in (0, 8192):
        loss_fn = tr.lm_loss_fn(model, vocab_chunk=chunk)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss_fn(model, batch).backward()
        torch.cuda.synchronize()
        peak[f"vocab_chunk {chunk}"] = torch.cuda.max_memory_allocated() / 2**30
    model.zero_grad(set_to_none=True)
    rows = {}
    for window in (1, 2):
        for remat in (False, True):
            model.cfg = dataclasses.replace(cfg, remat=remat)
            step = trainer.make_train_step(model, opt, tr.lm_loss_fn(model))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: step(batch), iters=20, warmup=3)
            rows[f"remat {remat} #{window}"] = (round(ms, 3), round(
                torch.cuda.max_memory_allocated() / 2**30, 3))
    model.cfg = cfg
    ratios = [rows[f"remat True #{w}"][0] / rows[f"remat False #{w}"][0]
              for w in (1, 2)]
    log(card, f"phase 4: flagship b={TRAIN_BATCH} s={TRAIN_SEQ} peak device "
              f"memory of a loss forward+backward (GiB): "
              f"{ {k_: round(v_, 3) for k_, v_ in peak.items()} }; training "
              f"step (ms/step by events over 20 steps after 3 warm-up "
              f"steps, peak GiB; two windows each, in turn): {rows}; remat "
              f"on / off: {ratios[0]:.3f}, {ratios[1]:.3f}")


def time_wide_kernels(card, dev, errs, launches, fp32_launches):
    """The head dims above 128 beside the wgmma kernels at d 128 (causal,
    b 4 h 6 s 1024): at d 256 the bf16 forward and backward on the wgmma
    kernels and the fp32 forward and backward on the CUDA cores; at d 384
    the run-time-d kernels, bf16 (the forward on wgmma); at d 128 the fp32
    forward and backward on the CUDA cores too. Device ms per call of each
    forward walk (online, lazy, twopass), dq and dk/dv, against the bound
    (operations at the dtype's peak, or the bytes), their plain versions
    at the kernels' tiles (the fp32 forward's plain walk timed once, at
    the online walk, and given for all three: its trace is what this
    phase spends its time on) and SDPA's forward and backward in the same
    dtype (whichever backend SDPA takes there); returns the d-256 and
    d-384 entries, each with its launches in phase 3e's runs
    (``launches``), and the d-128 fp32 forward's and backward's, with
    their launches in phase 3b's fp32 steps (``fp32_launches``)."""
    b, s, h = 4, 1024, 6
    dyn_d = 768 // DYN_HEADS
    entries, rows, kept = [], {}, {}
    t0, plain_s = time.perf_counter(), 0.0
    for d, dtype in ((128, torch.bfloat16), (128, torch.float32),
                     (256, torch.bfloat16), (256, torch.float32),
                     (dyn_d, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        tag = f"d{d}" + ("" if bf16 else " fp32")
        q, k, v = qkv(1800 + d, b=b, s=s, h=h, d=d, dtype=dtype, device=dev)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            d)).to(dev, dtype)
        qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
        scale = d ** -0.5
        out, lse = fa._kernel_fwd(qf, kf, vf, True, scale, "online")
        delta = ref.flash_delta(out, gf)
        ext = fa.extension()
        args = (True, float(scale * fa.LOG2E), float(scale))
        dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
        dq_walk, dkv_walk = fa.bwd_kernel_blocks(qf, kf)
        if fa.on_sm90_bwd(qf):
            k_dq = lambda: ext.flash_bwd_sm90_dq(qf, kf, vf, gf, lse, delta,
                                                 dq, *args, dq_walk[0])
            k_dkv = lambda: ext.flash_bwd_sm90_dkv(qf, kf, vf, gf, lse,
                                                   delta, dk, dv, *args)
        elif fa.on_dyn(d):
            ws_q = fa._workspace("dq", qf, s, False)
            ws_k = fa._workspace("dkv", qf, s, False)
            k_dq = lambda: ext.flash_bwd_dyn_dq(qf, kf, vf, gf, lse, delta,
                                                dq, ws_q, *args)
            k_dkv = lambda: ext.flash_bwd_dyn_dkv(qf, kf, vf, gf, lse, delta,
                                                  dk, dv, ws_k, *args)
        else:
            k_dq = lambda: ext.flash_bwd_dq(qf, kf, vf, gf, lse, delta, dq,
                                            *args)
            k_dkv = lambda: ext.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, dk,
                                              dv, *args)
        qs, ks, vs = (t.reshape(b, h, s, d).detach().requires_grad_(True)
                      for t in (qf, kf, vf))
        o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                             is_causal=True)
        go = gf.reshape(b, h, s, d)
        library = {
            "fwd": lambda: torch.nn.functional.scaled_dot_product_attention(
                qs.detach(), ks.detach(), vs.detach(), is_causal=True),
            "bwd": lambda: torch.autograd.grad(o, (qs, ks, vs), go,
                                               retain_graph=True)}
        lib = {n_: time_pair(fn) for n_, fn in library.items()}
        item = dtype.itemsize
        calls = {
            variant: (lambda variant=variant: fa._kernel_fwd(
                qf, kf, vf, True, scale, variant),
                lambda variant=variant: plain_fwd(qf, kf, vf, True, scale,
                                                  variant),
                attention_work(b * h, s, d, True, item), lib["fwd"])
            for variant in fa.VARIANTS}
        calls.update({
            "dq": (k_dq, lambda: ref.flash_bwd_dq(
                qf, kf, vf, gf, lse, delta, True, *dq_walk, scale),
                bwd_work(b * h, s, d, True, item, "dq"), lib["bwd"]),
            "dkv": (k_dkv, lambda: ref.flash_bwd_dkv(
                qf, kf, vf, gf, lse, delta, True, *dkv_walk, scale),
                bwd_work(b * h, s, d, True, item, "dkv"), lib["bwd"])})
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
        for name, (kernel, plain, (ops, nbytes), lib_t) in calls.items():
            kt = time_pair(kernel, iters=20)
            fwd = name in fa.VARIANTS
            if bf16 or not fwd or name == "online":
                t_plain = time.perf_counter()
                plain_ms = (device_ms(plain, PLAIN_ITERS) or
                            time_ms(plain, 2, 1))
                plain_s += time.perf_counter() - t_plain
            b_ms, b_by = bound(ops, nbytes, peak)
            rows[f"{tag} {name}"] = (round(kt[2], 5), round(b_ms, 5),
                                     round(plain_ms, 3), round(lib_t[2], 5))
            kept[f"{tag} {name}"] = (kt[3], lib_t[3])
            if d == 128 and bf16:
                continue
            extra = {}
            if fwd:
                counter = fa.fwd_launch_name(qf, name)
                source = (SM90_SOURCE if fa.on_sm90_fwd(qf) else
                          SM90DYN_SOURCE if fa.on_sm90dyn_fwd(qf) else
                          DYN_SOURCE if fa.on_dyn(d) else CC_FWD_SOURCE)
                err = (errs["fwd_sm90dyn"] if fa.on_sm90dyn_fwd(qf) else
                       errs["fwd_d256"] if bf16 else
                       max(errs["fwd_fp32"], errs["fwd_d256_fp32"])
                       if d == 256 else errs["fwd_fp32"])
                if not bf16:
                    extra = {"plain_walk": "online"}
            else:
                counter = fa.bwd_launch_names(qf)[name == "dkv"]
                source = (DYN_SOURCE if fa.on_dyn(d) else BWD_SOURCE
                          if fa.on_sm90_bwd(qf) else CC_BWD_SOURCE)
                err = errs[name + ("_dyn" if fa.on_dyn(d) else
                                   "_d256" if d == 256 else "") + (
                    "" if bf16 else "_fp32")]
            entries.append({
                "name": counter, "head_dim": d, "dtype": str(dtype)[6:],
                "route": "cuda", "source": source,
                "replaces": REPLACES[name],
                "launches": (launches if d != 128 else fp32_launches).get(
                    counter, 0),
                "max_abs_err": err,
                "ms": kt[2], "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_t[2], **extra})
        del o, qs, ks, vs
    fa.reset_launch_counts()
    log(card, f"phase 4: causal b={b} h={h} s={s}, d 256 (bf16 on the wgmma "
              f"kernels, fp32 on the CUDA cores) and d {dyn_d} on the "
              f"run-time-d kernels (the bf16 forward on wgmma) beside d 128 "
              f"(bf16 on the wgmma kernels, fp32 on the CUDA cores), "
              f"(kernel ms, bound ms, plain ms, SDPA ms in the same dtype; "
              f"bwd: SDPA's whole backward; the fp32 forward's plain ms the "
              f"online walk's): {rows}; the figure kept by time_pair "
              f"(kernel's, SDPA's): {kept}; fp32 forward / SDPA's fp32 "
              f"forward: "
              + ", ".join(f"d{d_} {v} {_ratio(rows, f'd{d_} fp32 {v}'):.2f}"
                          for d_ in (128, 256) for v in fa.VARIANTS) +
              f"; d{dyn_d} bf16 forward / SDPA's: " + ", ".join(
                  f"{v} {_ratio(rows, f'd{dyn_d} {v}'):.2f}"
                  for v in fa.VARIANTS) +
              f"; d256 bf16 backward / SDPA's: dq "
              f"{rows['d256 dq'][0] / rows['d256 dq'][3]:.2f}, dk/dv "
              f"{rows['d256 dkv'][0] / rows['d256 dkv'][3]:.2f}; fp32 "
              f"backward / SDPA's: d128 dq "
              f"{rows['d128 fp32 dq'][0] / rows['d128 fp32 dq'][3]:.2f}, "
              f"dk/dv {rows['d128 fp32 dkv'][0] / rows['d128 fp32 dkv'][3]:.2f}"
              f", d256 dq "
              f"{rows['d256 fp32 dq'][0] / rows['d256 fp32 dq'][3]:.2f}, "
              f"dk/dv {rows['d256 fp32 dkv'][0] / rows['d256 fp32 dkv'][3]:.2f}"
              f"; d{dyn_d} / d256: online "
              f"{rows[f'd{dyn_d} online'][0] / rows['d256 online'][0]:.2f}, "
              f"dq {rows[f'd{dyn_d} dq'][0] / rows['d256 dq'][0]:.2f}, dk/dv "
              f"{rows[f'd{dyn_d} dkv'][0] / rows['d256 dkv'][0]:.2f}; "
              f"d256 / d128: online "
              f"{rows['d256 online'][0] / rows['d128 online'][0]:.2f}, lazy "
              f"{rows['d256 lazy'][0] / rows['d128 lazy'][0]:.2f}, twopass "
              f"{rows['d256 twopass'][0] / rows['d128 twopass'][0]:.2f}, dq "
              f"{rows['d256 dq'][0] / rows['d128 dq'][0]:.2f}, dk/dv "
              f"{rows['d256 dkv'][0] / rows['d128 dkv'][0]:.2f}; d256 / "
              f"SDPA: " + ", ".join(
                  f"{v} {rows[f'd256 {v}'][0] / rows[f'd256 {v}'][3]:.2f}"
                  for v in fa.VARIANTS) +
        f"; {time.perf_counter() - t0:.1f} s, {plain_s:.1f} of it timing "
        f"the plain walks")
    return entries


def _ratio(rows, key):
    """A timed row's kernel ms over its library (SDPA) ms."""
    return rows[key][0] / rows[key][3]


def bn_work(rows, c, inputs, itemsize):
    """(operations, bytes) of one statistics call: an addition and a
    multiply-add per element (three operations), each input read once,
    two fp32 [C] outputs written once."""
    return 3 * rows * c, inputs * rows * c * itemsize + 2 * c * 4


def time_bn_kernels(card, dev, step_shapes, launches, errs):
    """B6 and B7 per call at the step's largest shape (bf16), with the
    plain version and the library yardstick (torch.batch_norm_stats and
    torch.batch_norm_backward_reduce on the same channels-last tensor,
    never on the port's path), and their sums over one step's 53 shapes
    against the step's bound; returns the kernels' JSON entries."""
    rows, c = max(step_shapes)
    g = torch.Generator(device=dev).manual_seed(90)
    x = torch.randn(rows, c, generator=g, device=dev).bfloat16()
    dy = torch.randn(rows, c, generator=g, device=dev).bfloat16()
    # the same memory as NCHW-shaped channels-last [32, C, rows/32, 1]
    xs = x.view(VISION_BATCH, -1, 1, c).permute(0, 3, 1, 2)
    dys = dy.view(VISION_BATCH, -1, 1, c).permute(0, 3, 1, 2)
    mean, invstd = torch.batch_norm_stats(xs, 1e-5)
    weight = torch.ones(c, device=dev)
    operands = {shape: [torch.randn(*shape, generator=g, device=dev)
                        .bfloat16() for _ in range(2)]
                for shape in set(step_shapes)}
    calls = {
        "bn_moments": (lambda: bn._kernel(x), lambda: bn_ref.moments(x),
                       lambda: torch.batch_norm_stats(xs, 1e-5), 1),
        "bn_moments2": (lambda: bn._kernel(dy, x),
                        lambda: bn_ref.moments2(dy, x),
                        lambda: torch.batch_norm_backward_reduce(
                            dys, xs, mean, invstd, weight, True, False,
                            False), 2)}
    entries = []
    for name, (kernel, plain, library, inputs) in calls.items():
        ev = {"kernel": time_ms(kernel), "plain": time_ms(plain),
              "library": time_ms(library)}
        dvc = {k: device_ms(fn, events_if_empty=False) for k, fn in
               (("kernel", kernel), ("plain", plain), ("library", library))}
        ms = {k: dvc[k] if dvc[k] is not None else ev[k] for k in ev}
        ops, nbytes = bn_work(rows, c, inputs, 2)
        b_ms, b_by = bound(ops, nbytes, PEAK_FP32_FLOPS)
        # one step: every BN layer's call, in the step's order
        step_args = [operands[shape][:inputs] for shape in step_shapes]

        def step_calls():
            for args in step_args:
                bn._kernel(*args)
        step_ms = device_ms(step_calls, iters=5) or time_ms(step_calls)
        step_bound = sum(bound(*bn_work(*shape, inputs, 2),
                               PEAK_FP32_FLOPS)[0] for shape in step_shapes)
        entries.append({
            "name": name, "route": "cuda", "source": BN_SOURCE,
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": errs[name], "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": ms["library"]})
        log(card, f"phase 4: {name} bf16 rows={rows} C={c}: device ms "
                  f"(profiler) {dvc}, event ms per call {ev}, bound "
                  f"{b_ms:.5f} ms ({b_by}; {ops} operations, {nbytes} "
                  f"bytes); over one ResNet-50 step's {len(step_shapes)} "
                  f"calls {step_ms:.4f} device ms against a bound of "
                  f"{step_bound:.4f} ms")
    return entries


def time_vision(card, dev, step_shapes):
    """The synthetic-benchmark protocol (10 warm-up steps, 10 iterations
    of 10 steps, zero images as the JAX harness feeds) on ResNet-50 at
    batch 32 for both norm impls: img/s, ms/step, device ms per step,
    busy share and the top device kernels."""
    for norm_impl in ("flax", "tpu"):
        step, model, opt, data = synthetic_benchmark.build_step(
            "resnet50", VISION_BATCH, VISION_SIZE, dev, norm_impl=norm_impl)
        rates = synthetic_benchmark.timed_rates(step, data, VISION_BATCH,
                                                10, 10, 10)
        mean = sum(rates) / len(rates)
        wall = VISION_BATCH / mean * 1e3
        busy, by_name = device_profile(lambda: step(data), iters=3)
        by_class = {}
        for name, ms in by_name.items():
            by_class[kernel_class(name)] = by_class.get(kernel_class(name),
                                                        0.0) + ms
        log(card, f"phase 4: synthetic benchmark ResNet-50 norm_impl "
                  f"{norm_impl} b={VISION_BATCH} x {VISION_SIZE} bf16: "
                  f"{mean:.1f} img/s (per-iteration {[round(r, 1) for r in rates]}), "
                  f"{wall:.3f} ms/step; one step {busy:.3f} ms device (busy "
                  f"{busy / wall:.1%}); device ms by kernel family "
                  f"{ {k: round(v, 3) for k, v in sorted(by_class.items())} }; "
                  f"top device ms: {top_kernels(by_name, 10)}")
        del step, model, opt, data
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3h: the eager coordination core on the card (ops/eager.py): (a)
# world 1 over NCCL, (b) 2 processes on the one card over gloo (NCCL
# refuses two ranks on one device), (c) the two entry points'
# --eager-allreduce steps

EAGER_NAMES = 64
EAGER_STEPS = 10
EAGER_PARITY_STEPS = 3
EAGER_PROCS = 2
EAGER_JOIN_S = 120
EAGER_LOST_S = 6.0


def _stats_of(tensors):
    """Per-tensor health stats one at a time (the yardstick of
    fusion.bucket_stats over a fused buffer)."""
    from horovod_tpu_torch.ops import fusion
    return torch.cat([fusion.bucket_stats(t.reshape(-1), [t.numel()])
                      for t in tensors])


def check_eager_core(card, dev):
    """Phase 3h (a): the eager core at world 1 on its NCCL group."""
    from horovod_tpu_torch.common import hvd_logging, state
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.utils import timeline as timeline_mod
    coord = state.global_state().coordinator
    cfg = coord._config
    # bursts of 64 named allreduces of mixed sizes and dtypes, integer
    # valued (exact in every dtype), each produced on a side stream behind
    # a chain of matmuls: a collective that did not wait on it would read
    # the zeros it was allocated with
    side = torch.cuda.Stream(dev)
    g = torch.Generator().manual_seed(7)
    sizes = torch.randint(1, 300_000, (EAGER_NAMES,), generator=g).tolist()
    dtypes = [torch.float32, torch.bfloat16, torch.int32] * EAGER_NAMES
    threshold = 1 << 20
    prev_threshold, cfg.fusion_threshold = cfg.fusion_threshold, threshold
    try:
        for burst in range(2):
            tensors = [torch.zeros(n, device=dev, dtype=dt)
                       for n, dt in zip(sizes, dtypes)]
            with torch.cuda.stream(side):
                x = torch.randn(4096, 4096, device=dev)
                for _ in range(20):
                    x = (x @ x) * 1e-3
                for i, t in enumerate(tensors):
                    t.copy_(torch.full_like(t, (i % 50) + 1 + burst) +
                            (0 * x[0, 0]).to(t.dtype))
                before = coord.executed_groups
                with coord.hold_cycle():
                    handles = [hvd.allreduce_async(
                        t, average=False, name=f"burst{burst}.{i}")
                        for i, t in enumerate(tensors)]
            outs = [hvd.synchronize(h) for h in handles]
            torch.cuda.synchronize()
            groups = coord.executed_groups - before
            want = sum(len(fusion.plan_buckets(
                [t for t in tensors if t.dtype == dt], threshold))
                for dt in (torch.float32, torch.bfloat16, torch.int32))
            if groups != want:
                raise AssertionError(f"burst {burst}: {groups} fused "
                                     f"groups, plan_buckets predicts {want}")
            for i, (t, o) in enumerate(zip(tensors, outs)):
                if o.dtype != t.dtype or not torch.equal(
                        o, torch.full_like(t, (i % 50) + 1 + burst)):
                    raise AssertionError(f"burst {burst} tensor {i} "
                                         f"({t.dtype}) is not its sum")
        # the fused buffer's per-slice stats against each tensor's own
        fp32 = [o for o in outs if o.dtype == torch.float32]
        got = fusion.bucket_stats(torch.cat([o.reshape(-1) for o in fp32]),
                                  [o.numel() for o in fp32])
        torch.testing.assert_close(got, _stats_of(fp32), rtol=1e-5,
                                   atol=1e-5)
    finally:
        cfg.fusion_threshold = prev_threshold
    # allgather (first dims ragged across calls), broadcast, objects, and
    # a duplicate name
    for rows in (1, 7, 300):
        x = torch.randn(rows, 5, device=dev)
        if not torch.equal(hvd.allgather(x, name=f"ag.{rows}"), x):
            raise AssertionError(f"allgather of {rows} rows")
    x = torch.randn(64, device=dev)
    if not torch.equal(hvd.broadcast(x, root_rank=0, name="bc"), x):
        raise AssertionError("broadcast")
    obj = {"epoch": 3, "ranks": list(range(9))}
    if hvd.broadcast_object(obj) != obj:
        raise AssertionError("broadcast_object")
    with coord.hold_cycle():
        h = hvd.allreduce_async(x, name="dup")
        try:
            hvd.allreduce_async(x, name="dup")
            raise AssertionError("a duplicate name was accepted")
        except hvd.DuplicateNameError:
            pass
    hvd.synchronize(h)
    # a stalled submission warns, then raises at the shutdown deadline
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = Capture()
    hvd_logging.get_logger().addHandler(handler)
    saved = (cfg.stall_warning_time_seconds, cfg.stall_shutdown_time_seconds)
    cfg.stall_warning_time_seconds, cfg.stall_shutdown_time_seconds = 0.2, 1.0
    t0 = time.perf_counter()
    try:
        with coord.hold_cycle():
            h = hvd.allreduce_async(x, name="stalled")
            time.sleep(0.4)
            coord._check_stalled()
            try:
                hvd.synchronize(h)
                raise AssertionError("a stalled collective completed")
            except hvd.StalledError:
                pass
    finally:
        cfg.stall_warning_time_seconds, cfg.stall_shutdown_time_seconds = \
            saved
        hvd_logging.get_logger().removeHandler(handler)
    stall_s = time.perf_counter() - t0
    if not any("stalled" in m and "subset of ranks" in m for m in records):
        raise AssertionError(f"no stall warning: {records}")
    # the timeline: NEGOTIATE_ALLREDUCE and ALLREDUCE spans of a cycle
    path = os.path.join(ROOT, "build", "chip_smoke_timeline.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prev_tl, coord.timeline = coord.timeline, timeline_mod.NativeTimeline(
        path, mark_cycles=True)
    try:
        hvd.grouped_allreduce([torch.ones(8, device=dev),
                               torch.ones(3, device=dev)])
    finally:
        tl, coord.timeline = coord.timeline, prev_tl
        tl.close()
    names = {e.get("name") for e in json.load(open(path))}
    if not {"NEGOTIATE_ALLREDUCE", "ALLREDUCE",
            "MEMCPY_IN_FUSION_BUFFER"} <= names:
        raise AssertionError(f"timeline spans {sorted(filter(None, names))}")
    log(card, f"phase 3h (a): world 1 over NCCL: 2 bursts of "
              f"{EAGER_NAMES} allreduces (fp32/bf16/int32, 1-300k "
              f"elements, produced on a side stream behind 20 matmuls) "
              f"fused into {want} groups each at a 1 MiB threshold, as "
              f"plan_buckets predicts, every sum exact; bucket_stats of "
              f"the fused fp32 results equal the per-tensor stats; "
              f"allgather, broadcast, broadcast_object exact; duplicate "
              f"name refused; a stalled collective warned and raised "
              f"StalledError after {stall_s:.2f} s (1.0 s deadline); the "
              f"timeline holds {sorted(n for n in names if n and n.isupper())}")


def _eager_rank(r, port, cport, results):
    """Phase 3h (b): one of two processes on the one card; its core's data
    plane is gloo (over CUDA tensors), its control plane the
    authenticated TCP wire."""
    import base64
    import torch.distributed as dist
    os.environ["HVD_CONTROL_ADDR"] = f"localhost:{cport}"
    os.environ["HVD_SECRET_KEY"] = base64.b64encode(b"chip" * 8).decode()
    os.environ["HOROVOD_STALL_CHECK_TIME_SECONDS"] = "0.5"
    os.environ["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = "2.0"
    # the liveness deadline outlasts any collective the background thread
    # blocks in (gloo over CUDA tensors blocks it, and blocked it sends
    # no heartbeat)
    os.environ["HOROVOD_RANK_LOST_TIMEOUT_SECONDS"] = str(EAGER_LOST_S)
    report = {}

    def say(msg):
        print(f"phase 3h (b) rank {r}: {msg}", file=sys.stderr, flush=True)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=r, world_size=EAGER_PROCS)
        hvd.init(device="cuda")
        from horovod_tpu_torch.common import hvd_logging, state
        coord = state.global_state().coordinator
        report["negotiated"] = coord.negotiated
        say("initialized")
        hvd.allreduce(torch.ones(4, device=dev), name="warmup")
        say("warm-up allreduce done")
        # the same 16 names, in opposite orders
        names = [f"t{i}" for i in range(16)]
        order = names if r == 0 else names[::-1]
        handles = {n: hvd.allreduce_async(
            torch.full((1000 + 37 * int(n[1:]),), float(int(n[1:]) + 10 * r),
                       device=dev), average=False, name=n) for n in order}
        report["opposite"] = {n: hvd.synchronize(h).unique().tolist()
                              for n, h in handles.items()}
        say("opposite orders done")
        # a subset submission is reported stalled rather than hanging
        records = []

        class Capture(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())
        hvd_logging.get_logger().addHandler(Capture())
        hvd.allreduce(torch.ones(4, device=dev), name="common")
        if r == 0:
            try:
                hvd.allreduce(torch.ones(4, device=dev), name="only0")
                report["subset"] = "completed"
            except hvd.StalledError:
                report["subset"] = "stalled"
            report["warned"] = any("only0" in m and "missing ranks" in m
                                   for m in records)
        else:
            time.sleep(3.0)
        hvd.allreduce(torch.ones(4, device=dev), name="after")
        say("subset done")
        # rank 1 leaves without a word; rank 0's pending handle fails
        # with RanksLostError when the coordinator's liveness ledger
        # declares it lost
        if r == 1:
            results.put((r, report))
            results.close()
            results.join_thread()   # the report is in the pipe
            os._exit(0)
        coord._config.stall_shutdown_time_seconds = 0.0   # liveness only
        t0 = time.perf_counter()
        try:
            hvd.allreduce(torch.ones(4, device=dev), name="orphan")
            report["lost"] = "completed"
        except hvd.RanksLostError as exc:
            report["lost"] = list(exc.ranks)
        report["lost_s"] = time.perf_counter() - t0
        hvd.shutdown()
    except Exception:  # noqa: BLE001 — reported to the parent, fatal there
        import traceback
        report["error"] = traceback.format_exc()
    results.put((r, report))


def check_eager_processes(card):
    """Phase 3h (b): 2 processes on the one card through the eager core,
    every join under a deadline."""
    import multiprocessing
    import socket
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()

    def free():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]
    port, cport = free(), free()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_eager_rank, args=(r, port, cport, results))
             for r in range(EAGER_PROCS)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(EAGER_PROCS):
            r, report = results.get(timeout=EAGER_JOIN_S)
            got[r] = report
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    wall = time.perf_counter() - t0
    for r in range(EAGER_PROCS):
        if "error" in got.get(r, {"error": "no report"}):
            raise AssertionError(f"eager rank {r}:\n{got.get(r)}")
        if got[r]["negotiated"] is not True:
            raise AssertionError(f"rank {r} ran without negotiation")
        want = {f"t{i}": [float(2 * i + 10)] for i in range(16)}
        if got[r]["opposite"] != want:
            raise AssertionError(f"rank {r} opposite-order sums "
                                 f"{got[r]['opposite']}")
    if got[0]["subset"] != "stalled" or not got[0]["warned"]:
        raise AssertionError(f"subset submission: {got[0]}")
    if got[0]["lost"] != [1]:
        raise AssertionError(f"rank 1's exit: {got[0]['lost']}")
    log(card, f"phase 3h (b): {EAGER_PROCS} processes on the one card "
              f"(gloo data plane over CUDA tensors, HMAC control plane): "
              f"16 names submitted in opposite orders, every result the "
              f"sum over ranks; a rank-0-only submission warned with its "
              f"missing rank and raised StalledError; rank 1 exited "
              f"unannounced and rank 0's pending allreduce failed with "
              f"RanksLostError([1]) after {got[0]['lost_s']:.2f} s "
              f"({EAGER_LOST_S:g} s liveness deadline); {wall:.1f} s wall "
              f"in all")


def _max_rel(a_params, b_params):
    worst = 0.0
    for a, b in zip(a_params, b_params):
        scale = b.detach().float().abs().max().item() or 1.0
        worst = max(worst, (a.detach().float() - b.detach().float())
                    .abs().max().item() / scale)
    return worst


def _groups_per_step(coord, one_step, model, threshold):
    """The fused groups one eager step executes (the gradients' grouped
    allreduce at world 1), held to plan_buckets over the model's
    gradients."""
    from horovod_tpu_torch.ops import fusion
    before = coord.executed_groups
    one_step().item()
    got = coord.executed_groups - before
    want = len(fusion.plan_buckets(
        [p for p in model.parameters() if p.requires_grad], threshold))
    if got != want:
        raise AssertionError(f"an eager step ran {got} fused groups, "
                             f"plan_buckets predicts {want}")
    return got


def _timed(step, batch, steps, sync):
    """(ms/step over ``steps`` steps on ``batch``, ending in a read of the
    loss; device ms of one step; busy share)."""
    step(batch)
    sync(step(batch))
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(batch)
    sync(loss)
    ms = (time.perf_counter() - t0) / steps * 1e3
    dev_ms = device_ms(lambda: step(batch), iters=2)
    return ms, dev_ms, (dev_ms / ms if dev_ms else None)


def run_eager_entry_points(card, dev, train_cfg):
    """Phase 3h (c): both entry points' --eager-allreduce paths at world
    1: 10 steps each through B2/B4/B5 and B6/B7, the parameters after 3
    steps against the DistributedOptimizer route's, and ms/step against
    that route at HOROVOD_CYCLE_TIME 5 and 0."""
    from horovod_tpu_torch.common import state
    coord = state.global_state().coordinator
    cfg = coord._config
    out = {}
    sync = (lambda loss: loss.item())
    # ---- the flagship through train_lm --eager-allreduce
    args = train_lm.parse_args(["--device", "cuda", "--eager-allreduce"])
    window, _ = train_lm.build_eager(args, train_cfg, TRAIN_BATCH, TRAIN_SEQ,
                                     1, dev)
    per_step = {"flash_fwd_lazy": train_cfg.num_layers,
                "flash_bwd_sm90_dq": train_cfg.num_layers,
                "flash_bwd_sm90_dkv": train_cfg.num_layers}
    losses = []
    fa.reset_launch_counts()
    for i in range(EAGER_STEPS):
        before = dict(fa.launch_counts)
        losses.append(window().item())
        got = {k: v - before.get(k, 0) for k, v in fa.launch_counts.items()}
        if got != per_step:
            raise AssertionError(f"eager LM step {i} launched {got}")
    lm_launches = dict(fa.launch_counts)
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"eager LM losses {losses}")
    # 3 steps against DistributedOptimizer's, same seed and batch
    e_step, e_model, _, e_toks = trainer.build_eager_lm_step(
        train_cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    d_model, d_opt, _, d_toks = train_lm.build_transformer_step(
        train_cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)
    d_step = trainer.make_train_step(d_model, d_opt, tr.lm_loss_fn(d_model))
    for _ in range(EAGER_PARITY_STEPS):
        e_step(e_toks[0])
        d_step(d_toks[0])
    lm_dev = _max_rel(e_model.parameters(), d_model.parameters())
    lm_groups = _groups_per_step(coord, lambda: e_step(e_toks[0]),
                                 e_model, cfg.fusion_threshold)
    if lm_dev > 2e-5:
        raise AssertionError(f"eager LM parameters after 3 steps differ "
                             f"from DistributedOptimizer's by {lm_dev:.3e} "
                             f"of their largest magnitude")
    timing = {}
    for label, step, batch in (("pr8", d_step, d_toks[0]),
                               ("eager", e_step, e_toks[0])):
        for cycle in ((5.0, 0.0) if label == "eager" else (None,)):
            prev = cfg.cycle_time_ms
            if cycle is not None:
                cfg.cycle_time_ms = cycle
            try:
                timing[(label, cycle)] = _timed(step, batch, EAGER_STEPS,
                                                sync)
            finally:
                cfg.cycle_time_ms = prev
    del e_model, d_model, d_opt, e_step, d_step
    out["lm"] = timing
    log(card, f"phase 3h (c): train_lm --eager-allreduce (gpt2_small_tpu "
              f"flash, b{TRAIN_BATCH} x s{TRAIN_SEQ}, AdamW mu bf16, "
              f"world 1) {EAGER_STEPS} steps: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; launches {lm_launches} ({per_step} every "
              f"step); after {EAGER_PARITY_STEPS} steps the parameters "
              f"within {lm_dev:.2e} of the DistributedOptimizer route's "
              f"(largest magnitude; bound 2e-5); {lm_groups} fused groups "
              f"a step at the {cfg.fusion_threshold}-byte threshold, as "
              f"plan_buckets predicts; " + "; ".join(
                  f"{k[0]}{'' if k[1] is None else f' cycle {k[1]:g} ms'}: "
                  f"{v[0]:.3f} ms/step, device {v[1]:.3f} ms, busy "
                  f"{v[2]:.1%}" for k, v in timing.items()))
    # ---- ResNet-50 through synthetic_benchmark --eager-allreduce
    step, _, _, _ = synthetic_benchmark.build_eager_step(
        "resnet50", VISION_BATCH, VISION_SIZE, dev, norm_impl="tpu")
    batch = vision_batch(dev, VISION_BATCH)
    per_step = {"bn_moments": BN_PER_STEP, "bn_moments2": BN_PER_STEP}
    losses = []
    bn.reset_counts()
    for i in range(EAGER_STEPS):
        before = dict(bn.launch_counts)
        losses.append(step(batch).item())
        got = {k: v - before.get(k, 0) for k, v in bn.launch_counts.items()}
        if got != per_step:
            raise AssertionError(f"eager ResNet-50 step {i} launched {got}")
    bn_launches = dict(bn.launch_counts)
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"eager ResNet-50 losses {losses}")
    e_step, e_model, _, _ = synthetic_benchmark.build_eager_step(
        "resnet50", VISION_BATCH, VISION_SIZE, dev, norm_impl="tpu")
    d_step, d_model, _, _ = synthetic_benchmark.build_step(
        "resnet50", VISION_BATCH, VISION_SIZE, dev, norm_impl="tpu")
    for _ in range(EAGER_PARITY_STEPS):
        e_step(batch)
        d_step(batch)
    vis_dev = _max_rel(e_model.parameters(), d_model.parameters())
    vis_groups = _groups_per_step(coord, lambda: e_step(batch), e_model,
                                  cfg.fusion_threshold)
    if vis_dev > 2e-5:
        raise AssertionError(f"eager ResNet-50 parameters after 3 steps "
                             f"differ from DistributedOptimizer's by "
                             f"{vis_dev:.3e}")
    timing = {}
    for label, st in (("pr8", d_step), ("eager", e_step)):
        for cycle in ((5.0, 0.0) if label == "eager" else (None,)):
            prev = cfg.cycle_time_ms
            if cycle is not None:
                cfg.cycle_time_ms = cycle
            try:
                timing[(label, cycle)] = _timed(st, batch, EAGER_STEPS, sync)
            finally:
                cfg.cycle_time_ms = prev
    out["vision"] = timing
    log(card, f"phase 3h (c): synthetic_benchmark --eager-allreduce "
              f"(ResNet-50 norm_impl tpu, b{VISION_BATCH} x {VISION_SIZE}, "
              f"bf16, SGD, world 1) {EAGER_STEPS} steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {bn_launches} "
              f"({per_step} every step); after {EAGER_PARITY_STEPS} steps "
              f"the parameters within {vis_dev:.2e} of the "
              f"DistributedOptimizer route's; {vis_groups} fused groups a "
              f"step, as plan_buckets predicts; " + "; ".join(
                  f"{k[0]}{'' if k[1] is None else f' cycle {k[1]:g} ms'}: "
                  f"{v[0]:.3f} ms/step ({VISION_BATCH / v[0] * 1e3:.1f} "
                  f"img/s), device {v[1]:.3f} ms, busy {v[2]:.1%}"
                  for k, v in timing.items()))
    return out


# ---------------------------------------------------------------------------
# phase 3i: the quantized and sparse wire, the checkpoint plane and the
# elastic drill (hvdrun and the supervisor over processes on the one card)


WIRE_CODECS = ("none", "bf16", "int8", "fp8")
# train_lm on the card at the flagship's width with its depth cut, for
# time: a warm-up window and a timed one of WIRE_INNER steps each
WIRE_LAYERS = 4
WIRE_INNER = 4
WIRE_STEPS = 2 * WIRE_INNER
WIRE_RATIO_MAX = 0.26
WIRE_RUN_S = 240
W2V_STEPS = 200
DRILL_LAYERS = 2     # the flagship's width, depth cut for time
DRILL_STEPS, DRILL_EVERY, DRILL_PREEMPT, DRILL_KILL = 10, 2, 3, 6
DRILL_RUN_S = 420
RAGGED = (1, 255, 1000, 4097, 65537)
P3I_DIR = os.path.join(ROOT, "build", "phase3i")


def _module_run(args, env, timeout, name, meanwhile=None):
    """``python -m`` + ``args`` from the checkout with ``env``; stderr to
    build/phase3i/<name>.err. ``meanwhile()`` runs here while the
    processes start (it must print nothing to their pipe). Returns the
    JSON lines of stdout; raises, with the end of stderr, on a nonzero
    exit or the deadline."""
    os.makedirs(P3I_DIR, exist_ok=True)
    err_path = os.path.join(P3I_DIR, f"{name}.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m"] + args, cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True,
                                start_new_session=True)
        try:
            if meanwhile is not None:
                meanwhile()
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise AssertionError(f"{name}: no result within {timeout} s; "
                                 f"stderr: {open(err_path).read()[-3000:]}")
        except BaseException:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise
    if proc.returncode:
        raise AssertionError(f"{name} exited {proc.returncode}; stderr: "
                             f"{open(err_path).read()[-3000:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _ragged(n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 30
    x[:min(n, 256)] = 0.0          # an all-zero block
    if n > 300:
        x[260], x[261] = 448.0, -448.0   # a block at exactly +-448
    return x


def check_codecs(card, dev, model):
    """Phase 3i (a): int8 and fp8 encode/decode on the card over the
    flagship's gradient set as the eager core fuses it (fp32 buckets of
    HOROVOD_FUSION_THRESHOLD) and over ragged lengths, bit-equal to the
    same functions on the CPU; device ms per bucket and in all."""
    from horovod_tpu_torch.common import state
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops import quantization as q
    threshold = state.global_state().config.fusion_threshold
    g = torch.Generator(device=dev).manual_seed(1)
    grads = [p.grad.detach().float() if p.grad is not None else
             torch.randn(p.shape, device=dev, generator=g) * 1e-3
             for p in model.parameters() if p.requires_grad]
    buckets = fusion.plan_buckets(grads, threshold)
    total_bytes = sum(t.numel() * 4 for t in grads)
    report = {}
    for codec in q.QUANTIZED_CODECS:
        enc_ms, dec_ms, wire = [], [], 0
        for b in buckets:
            fused = fusion.fuse(grads, b)
            qg, sg = q.encode(fused, 256, codec)
            dg = q.decode(qg, sg, 256, fused.numel())
            cpu = fused.cpu()
            qc, sc = q.encode(cpu, 256, codec)
            if not (torch.equal(qg.view(torch.uint8).cpu(),
                                qc.view(torch.uint8)) and
                    torch.equal(sg.cpu().view(torch.int32),
                                sc.view(torch.int32)) and
                    torch.equal(dg.cpu().view(torch.int32),
                                q.decode(qc, sc, 256, cpu.numel())
                                .view(torch.int32))):
                raise AssertionError(f"{codec} bucket of {fused.numel()} "
                                     f"elements: card != CPU")
            wire += q.wire_nbytes(qg, sg)
            enc_ms.append(time_ms(lambda: q.encode(fused, 256, codec),
                                  iters=5, warmup=1))
            dec_ms.append(time_ms(lambda: q.decode(qg, sg, 256,
                                                   fused.numel()),
                                  iters=5, warmup=1))
            del fused, qg, sg, dg, cpu, qc, sc
        for n in RAGGED:
            x = _ragged(n, n)
            for multiple in (None, 512):
                qc, sc = q.encode(x, 256, codec, multiple=multiple)
                qg, sg = q.encode(x.to(dev), 256, codec, multiple=multiple)
                if not (torch.equal(qg.view(torch.uint8).cpu(),
                                    qc.view(torch.uint8)) and
                        torch.equal(sg.cpu().view(torch.int32),
                                    sc.view(torch.int32))):
                    raise AssertionError(f"{codec} ragged {n}: card != CPU")
        report[codec] = (enc_ms, dec_ms, wire)
        log(card, f"phase 3i (a): {codec} encode/decode of the flagship's "
                  f"{len(grads)} fp32 gradients in {len(buckets)} fused "
                  f"buckets ({total_bytes / 1e6:.1f} MB, "
                  f"{wire / 1e6:.1f} MB encoded, ratio "
                  f"{wire / total_bytes:.4f}) and {len(RAGGED)} ragged "
                  f"lengths (a pad tail, an all-zero block, a block at "
                  f"+-448): payload bytes and scales bit-equal to the CPU; "
                  f"device ms per bucket encode "
                  f"{[round(v, 3) for v in enc_ms]}, decode "
                  f"{[round(v, 3) for v in dec_ms]}; in all encode "
                  f"{sum(enc_ms):.3f} ms, decode {sum(dec_ms):.3f} ms")
    return report


def wire_ranks(directory):
    """The command hvdrun starts on each rank in phase 3i (b)
    (``chip_smoke.py --wire-ranks DIR``): per codec of WIRE_CODECS,
    ``train_lm.main`` (``--eager-allreduce --windows 1`` at the flagship's
    width, depth WIRE_LAYERS, WIRE_INNER inner steps, and for a quantized
    codec ``--wire-check DIR/wire-<codec>``) under
    HOROVOD_COMPRESSION=<codec>: what one train_lm process per codec does,
    main's own init and shutdown included, in one process. Each call after
    the first takes a rendezvous and a control port of its own (hvdrun's
    port + 3000 + 2·index and the one after it, or as far below it where
    that would pass the last port): a rank that joins first
    must not reach the store or the coordinator of the run before. After
    main's JSON line, rank 0 prints the codec and the call's wall seconds
    on a line of their own. Then phase 3i (c) in the same two processes:
    ``word2vec.main`` (``--eager --check-dense``, W2V_STEPS steps) under
    the launch's own HOROVOD_COMPRESSION, its JSON line the last."""
    from horovod_tpu_torch import word2vec
    from horovod_tpu_torch.ops import quantization as q
    host, _, port = os.environ["HVD_COORDINATOR_ADDR"].rpartition(":")
    rank = int(os.environ.get("HVD_PROCESS_ID", "0"))
    codec_env = os.environ.get("HOROVOD_COMPRESSION")

    def next_world(i):
        # below hvdrun's port where above it would pass 65535
        step = 3000 + 2 * i
        rendezvous = int(port) + step if int(port) + step < 65535 \
            else int(port) - step
        os.environ["HVD_COORDINATOR_ADDR"] = f"{host}:{rendezvous}"
        os.environ["HVD_CONTROL_ADDR"] = f"{host}:{rendezvous + 1}"
    for i, codec in enumerate(WIRE_CODECS):
        os.environ["HOROVOD_COMPRESSION"] = codec
        if i:
            next_world(i)
        argv = ["--device", "cuda", "--eager-allreduce", "--windows", "1",
                "--num-layers", str(WIRE_LAYERS),
                "--inner-steps", str(WIRE_INNER)]
        if q.is_quantized(codec):
            argv += ["--wire-check", os.path.join(directory, f"wire-{codec}")]
        t0 = time.perf_counter()
        train_lm.main(argv)
        if rank == 0:
            print(json.dumps({"codec": codec,
                              "wall_s": time.perf_counter() - t0}),
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if codec_env is None:
        os.environ.pop("HOROVOD_COMPRESSION")
    else:
        os.environ["HOROVOD_COMPRESSION"] = codec_env
    next_world(len(WIRE_CODECS))
    word2vec.main(["--device", "cuda", "--eager", "--check-dense",
                   "--steps", str(W2V_STEPS)])
    return 0


def run_quantized_wire(card, grad_bytes, layers):
    """Phase 3i (b): ONE hvdrun -np 2 on the one card (``wire_ranks``):
    train_lm's entry point, --eager-allreduce, at the flagship's width
    (b16 x s1024) with its depth cut to ``layers`` blocks, WIRE_STEPS
    steps a codec, the codecs one after another in the same two
    processes, one ``train_lm.main`` call each. Per
    rank layers+layers+layers launches a step; losses finite and falling;
    encoded wire bytes per step at most WIRE_RATIO_MAX of the fp32
    gradient bytes (``grad_bytes``, of the cut model); rank 0's last
    quantized bucket, error feedback applied, equal to
    stacked_wire_allreduce of both ranks' compensated inputs. Returns
    the ms/step by codec and the word2vec line the same launch printed
    last (phase 3i (c))."""
    from horovod_tpu_torch.ops import quantization as q
    per_step = {"flash_fwd_lazy": float(layers),
                "flash_bwd_sm90_dq": float(layers),
                "flash_bwd_sm90_dkv": float(layers)}
    ms = {}
    t_wire = time.perf_counter()
    args = ["horovod_tpu_torch.run", "-np", "2", "-H", "localhost:2",
            sys.executable, os.path.join(ROOT, "chip_smoke.py"),
            "--wire-ranks", P3I_DIR]
    lines = _module_run(args, dict(os.environ), WIRE_RUN_S, "wire")
    w2v = lines.pop()
    # each train_lm.main line, then wire_ranks' line of its codec
    tags = [i for i, o in enumerate(lines) if "codec" in o]
    outs = {lines[i]["codec"]: (lines[i - 1], lines[i]["wall_s"])
            for i in tags if i and "codec" not in lines[i - 1]}
    if [lines[i]["codec"] for i in tags] != list(WIRE_CODECS) or \
            len(outs) != len(WIRE_CODECS):
        raise AssertionError(f"the wire ranks reported {lines}")
    for codec in WIRE_CODECS:
        check = os.path.join(P3I_DIR, f"wire-{codec}")
        out, wall = outs[codec]
        if not (math.isfinite(out["loss_first"]) and
                math.isfinite(out["loss_last"]) and
                out["loss_last"] < out["loss_first"]):
            raise AssertionError(f"{codec}: losses {out}")
        if out["launches_per_step"] != per_step:
            raise AssertionError(f"{codec}: rank 0 launched "
                                 f"{out['launches_per_step']} a step")
        ms[codec] = out["ms_per_step"]
        note = ""
        if q.is_quantized(codec):
            ranks = [torch.load(os.path.join(check, f"rank{r}.pt"))
                     for r in range(2)]
            for r, rec in enumerate(ranks):
                if rec["launches_per_step"] != per_step:
                    raise AssertionError(f"{codec}: rank {r} launched "
                                         f"{rec['launches_per_step']}")
                # the gradients keep their names, so the last step's
                # bucket carries the residual of the step before
                if not rec["compensated"]:
                    raise AssertionError(f"{codec}: rank {r}'s last bucket "
                                         f"took no error feedback")
            ratio = out["wire"]["bytes"] / grad_bytes
            if ratio > WIRE_RATIO_MAX:
                raise AssertionError(f"{codec}: {out['wire']} is {ratio:.4f}"
                                     f" of the gradient bytes")
            n = ranks[0]["comp"].numel() // 256 * 256
            want, _ = q.stacked_wire_allreduce(
                torch.stack([r["comp"][:n] for r in ranks]), 256, codec,
                True, n)
            if not (torch.equal(want[0], ranks[0]["out"][:n]) and
                    torch.equal(ranks[0]["out"], ranks[1]["out"])):
                raise AssertionError(f"{codec}: rank 0's bucket "
                                     f"{ranks[0]['names'][:2]}... != "
                                     f"stacked_wire_allreduce")
            note = (f"; wire {out['wire']['bytes'] / 1e6:.2f} MB a step = "
                    f"{ratio:.4f} of the {grad_bytes / 1e6:.1f} MB fp32 "
                    f"gradients (bound {WIRE_RATIO_MAX}); rank 0's last "
                    f"bucket ({len(ranks[0]['names'])} tensors, first {n} "
                    f"elements, error feedback applied on both ranks) "
                    f"equals stacked_wire_allreduce of both ranks' "
                    f"compensated inputs bit for bit")
        log(card, f"phase 3i (b): HOROVOD_COMPRESSION={codec}, 2 ranks on "
                  f"one card (gloo between two processes on one card: not "
                  f"an interconnect figure), flagship width, depth cut to "
                  f"{layers} layers, b{TRAIN_BATCH} x s{TRAIN_SEQ}, "
                  f"{WIRE_STEPS} steps: loss "
                  f"{out['loss_first']:.4f} -> {out['loss_last']:.4f}, "
                  f"{out['ms_per_step']:.1f} ms/step, launches "
                  f"{out['launches_per_step']} a step on every rank"
                  f"{note}; {wall:.1f} s in the ranks")
    log(card, "phase 3i (b): ms/step, gloo between two processes on one "
              "card: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    log(card, f"phase 3i (b): {time.perf_counter() - t_wire:.1f} s in all "
              f"(one hvdrun launch, {len(WIRE_CODECS)} codecs at {layers} "
              f"layers, {WIRE_STEPS} steps each, then word2vec)")
    return ms, w2v


def run_word2vec(card, out):
    """Phase 3i (c): word2vec --eager on 2 ranks through hvdrun at the
    example's defaults, in phase 3i (b)'s launch (``out``, its line): the
    loss falls, one step's to_dense of the reduced slices equals the
    dense allreduce of the densified gradients, two fused allgather
    groups a step."""
    if out.get("vocab") is None or "loss_first" not in out:
        raise AssertionError(f"word2vec printed {out}")
    if not out["loss_last"] < out["loss_first"]:
        raise AssertionError(f"word2vec loss {out}")
    # the sums of duplicate rows run in another order (index_add on the
    # card): fp32 rounding of the order, not a difference of rows
    if out["dense_check_max_rel"] > 1e-6:
        raise AssertionError(f"word2vec dense check {out}")
    if out["allgather_groups_per_step"] != 2:
        raise AssertionError(f"word2vec fused {out} allgather groups")
    log(card, f"phase 3i (c): word2vec --eager, 2 ranks through hvdrun, "
              f"vocab {out['vocab']} dim {out['dim']}, {W2V_STEPS} steps: "
              f"loss {out['loss_first']:.4f} -> {out['loss_last']:.4f}; "
              f"to_dense(grouped_sparse_allreduce) vs the dense allreduce "
              f"of the densified gradients {out['dense_check_max_rel']:.2e} "
              f"of the largest magnitude (bound 1e-6); "
              f"{out['allgather_groups_per_step']:g} fused allgather groups "
              f"a step; {out['ms_per_step']:.2f} ms/step")
    return out


def time_checkpoint(card, model, opt):
    """Phase 3i (d): the flagship's full-depth state (fp32 masters, bf16
    mu, fp32 nu) through CheckpointManager: the blocking part of an async
    save, the whole save, and the crc-verified restore, bit-equal."""
    from horovod_tpu_torch.utils import checkpoint as ck
    state = train_lm.state_tree(model, opt)
    nbytes = sum(t.numel() * t.element_size() for t in
                 ck._flatten_with_names(state)[1])
    digest = ck.tree_digest(state)
    path = os.path.join(P3I_DIR, "flagship-ckpt")
    mgr = ck.CheckpointManager(path, keep=1)
    t0 = time.perf_counter()
    mgr.save(state, 1, extra={"step": 1})
    block = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    whole = (time.perf_counter() - t0) * 1e3
    mgr.close()
    t0 = time.perf_counter()
    tree, step, _ = ck.CheckpointManager(path).restore(like=state)
    torch.cuda.synchronize()
    restore = (time.perf_counter() - t0) * 1e3
    if step != 1 or ck.tree_digest(tree) != digest:
        raise AssertionError("the flagship's restored state differs")
    log(card, f"phase 3i (d): the flagship's full-depth state "
              f"({nbytes / 1e9:.3f} GB: fp32 masters, bf16 mu, fp32 nu) "
              f"through CheckpointManager: blocking part of the async save "
              f"{block:.1f} ms, whole save {whole:.1f} ms, crc-verified "
              f"restore to the card {restore:.1f} ms, bit-equal")
    return block, whole, restore


def run_drill(card):
    """Phase 3i (d): the elastic drill (horovod_tpu_torch.run.drill) on
    the one card: preempt after step 3 -> exit 45 -> same-slot resume;
    SIGKILL rank 1 after step 6 -> exit 44 -> shrink to 1 rank -> resume a
    2-rank checkpoint; run to step 10."""
    from horovod_tpu_torch.run import drill
    path = os.path.join(P3I_DIR, "drill")
    import shutil
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(P3I_DIR, exist_ok=True)
    with open(os.path.join(P3I_DIR, "drill.log"), "w") as logf:
        report = drill.run_drill(
            path, np_=2, steps=DRILL_STEPS, every=DRILL_EVERY,
            preempt_after=DRILL_PREEMPT, kill_after=DRILL_KILL,
            device="cuda", train_args=["--num-layers", str(DRILL_LAYERS)],
            timeout=DRILL_RUN_S, log=logf)
    losses = [l for _, l, _ in report["losses"]]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"drill losses {losses}")
    r1, r2 = report["resumes"]
    log(card, f"phase 3i (d): drill (flagship width, depth cut to "
              f"{DRILL_LAYERS} layers, b{TRAIN_BATCH} x s{TRAIN_SEQ}, "
              f"checkpoint every {DRILL_EVERY}): SIGTERM after step "
              f"{DRILL_PREEMPT} -> exit 45 -> resumed step {r1['step']} on "
              f"{r1['workers']} ranks ({r1['ms']:.1f} ms restore); SIGKILL "
              f"rank 1 after step {DRILL_KILL} -> exit 44 -> shrink -> "
              f"resumed step {r2['step']} on {r2['workers']} rank from "
              f"{r2['saved_layout']} ({r2['ms']:.1f} ms restore); every "
              f"restore crc-verified and equal to the saving ranks' digest, "
              f"extra {r2['extra']}; final step {report['done']['step']}; "
              f"RTO (exit to first step, in the process lane beside the "
              f"untimed checks) "
              f"{[round(v, 2) for v in report['rto_s']]} s; losses "
              f"{[round(v, 4) for v in losses]}")
    return report


def in_background(fn, *args):
    """Start ``fn(*args)`` on a thread; returns a join() that waits for it
    and returns its result or raises its exception (``quiet``: returns
    None instead). The process lane's tracks run this way."""
    box = {}

    def body():
        try:
            box["result"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 — re-raised by join
            box["error"] = exc
    th = threading.Thread(target=body, daemon=True)
    th.start()

    def join(quiet=False):
        th.join()
        if "error" in box and not quiet:
            raise box["error"]
        return box.get("result")
    return join


def run_phase_3i(card, dev, model, opt, cfg):
    """Phase 3i's timed parts, each fatal and under its own deadline, with
    the card and the host to themselves: the checkpoint's save and
    restore, then (b) and (c) in one launch. (a), the codecs, runs beside
    the process lane, and (d), the drill, in it."""
    t0 = time.perf_counter()
    # the fp32 gradient bytes of the depth-cut model phase 3i (b) trains
    cut = tr.TransformerLM(dataclasses.replace(cfg, num_layers=WIRE_LAYERS),
                           "meta", torch.float32)
    grad_bytes = sum(p.numel() * 4 for p in cut.parameters())
    ckpt = time_checkpoint(card, model, opt)
    torch.cuda.empty_cache()
    log(card, f"phase 3i: this process holds "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card "
              f"while the ranks run")
    ms, w2v_line = run_quantized_wire(card, grad_bytes, WIRE_LAYERS)
    w2v = run_word2vec(card, w2v_line)
    log(card, f"phase 3i (b), (c) and the checkpoint: "
              f"{time.perf_counter() - t0:.1f} s in all")
    return {"ms": ms, "w2v": w2v, "ckpt": ckpt}


LANE_FREE_GB = 30.0      # card memory free before a lane job starts: two
                         # ranks of the flagship's width at depth 2
LANE_FREE_WAIT_S = 300   # for the main thread's phase to give it back
LANE_SAMPLE_S = 0.5


def card_free_gb():
    return torch.cuda.mem_get_info(0)[0] / 1e9


class ProcessLane:
    """The checks that are mostly process starts and waits, on threads
    beside the main thread's checks that record no time: 3i (d)'s elastic
    drill, 3j (c)'s mpirun ranks and 3j (a, b)'s run(fn) ranks one after
    another (two ranks of the flagship's width at depth 2 each), and 3h
    (b)'s two small eager-core processes on a track of their own. Before
    each job of the first track the card must have LANE_FREE_GB free
    (waited for up to LANE_FREE_WAIT_S, then fatal); a sampler records
    the card's lowest free memory while the lane is open. Each job is
    fatal and under its own deadline."""

    def __init__(self, card):
        self.card = card
        self.jobs = (("3i (d)", run_drill), ("3j (c)", run_mpirun),
                     ("3j (a, b)", run_fn_ranks))
        self.t0 = time.perf_counter()
        os.makedirs(P3J_DIR, exist_ok=True)
        self.stop = threading.Event()
        self.low_free = card_free_gb()
        self.starts, self.seconds = {}, {}
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()
        self._main = in_background(self._run)
        self._small = in_background(self._timed, "3h (b)",
                                    check_eager_processes)

    def _sample(self):
        while not self.stop.wait(LANE_SAMPLE_S):
            self.low_free = min(self.low_free, card_free_gb())

    def _timed(self, name, fn):
        t = time.perf_counter()
        out = fn(self.card)
        self.seconds[name] = round(time.perf_counter() - t, 1)
        return out

    def _run(self):
        results = {}
        for name, fn in self.jobs:
            if self.stop.is_set():
                break
            deadline = time.monotonic() + LANE_FREE_WAIT_S
            free = card_free_gb()
            while free < LANE_FREE_GB:
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"the process lane's {name}: {free:.2f} GB of the "
                        f"card free after {LANE_FREE_WAIT_S} s, below "
                        f"{LANE_FREE_GB} GB")
                time.sleep(1.0)
                free = card_free_gb()
            self.starts[name] = round(free, 2)
            results[name] = self._timed(name, fn)
        return results

    def join(self, quiet=False):
        """Wait for both tracks; returns the first track's results by job.
        ``quiet`` (after a failure elsewhere): start no further job and
        return None whatever the lane raised."""
        if quiet:
            self.stop.set()
        results, errors = None, []
        for i, track in enumerate((self._main, self._small)):
            try:   # both tracks end before this returns or raises
                out = track(quiet)
                results = out if i == 0 else results
            except BaseException as exc:  # noqa: BLE001 — raised below
                errors.append(exc)
        self.stop.set()
        self._sampler.join()
        if errors:
            raise errors[0]
        if not quiet:
            log(self.card, f"the process lane: "
                           f"{time.perf_counter() - self.t0:.1f} s; seconds "
                           f"by job {self.seconds}; the card's free GB at "
                           f"each job's start {self.starts} (at least "
                           f"{LANE_FREE_GB} needed); the lowest free while "
                           f"the lane was open {self.low_free:.2f} GB "
                           f"(sampled every {LANE_SAMPLE_S} s)")
        return results


# ---------------------------------------------------------------------------
# phase 3j: the collectives' op and axis_name, the rest of the launch
# plane (run(fn), mpirun with nothing else set), the overlap plane and
# checkpointing on the tp mesh


P3J_DIR = os.path.join(ROOT, "build", "phase3j")
P3J_LAYERS = 2        # the flagship's width, depth cut for time
P3J_STEPS = 3
P3J_ROWS = 2 * TRAIN_BATCH   # two ranks' rows of the --steps loop
P3J_RUN_S = 300
OVERLAP_WINDOWS, OVERLAP_WINDOW = 3, 10
CKPT_STEPS, CKPT_STOP = 6, 3
# environment of a launcher: none of it reaches the mpirun drill
LAUNCH_ENV = ("HVD_", "OMPI_", "PMI_", "PMIX_", "SLURM_", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "_HVD_")


def _p3j_cfg(layers=P3J_LAYERS):
    return dataclasses.replace(train_lm.flagship_config(True),
                               num_layers=layers)


def check_op_axis(card, dev):
    """Phase 3j (a), world 1 over NCCL: allreduce with op sum, average,
    min and max (over the 'dp' axis; sum and average over every worker
    too), allgather and broadcast over 'dp'; each returns its input
    exactly."""
    had_mesh = mesh_lib.global_mesh_if_set()
    mesh = hvd.mesh()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(4097, generator=g, device=dev)
    ints = torch.randint(-1000, 1000, (513,), generator=g, device=dev,
                         dtype=torch.int32)
    outs = {}
    for t in (x, ints):
        for op in ("sum", "average", "min", "max"):
            outs[f"allreduce op={op} axis=dp {t.dtype}"] = hvd.allreduce(
                t, op=op, axis_name="dp")
        for op in ("sum", "average"):
            outs[f"allreduce op={op} {t.dtype}"] = hvd.allreduce(t, op=op)
        outs[f"allgather axis=dp {t.dtype}"] = hvd.allgather(
            t, axis_name="dp")
        outs[f"broadcast axis=dp {t.dtype}"] = hvd.broadcast(
            t, 0, axis_name="dp")
        for name in [k for k in outs if str(t.dtype) in k]:
            if not (outs[name].device == t.device and
                    torch.equal(outs[name], t)):
                raise AssertionError(f"NCCL world 1: {name} is not exact")
    if had_mesh is None:
        mesh_lib.reset_global_mesh()
    log(card, f"phase 3j (a): NCCL world 1 on mesh "
              f"{mesh_lib.mesh_layout(mesh)}: {len(outs)} calls exact "
              f"({sorted(outs)})")


def _p3j_ranks_job():
    """run(fn)'s worker: min/max/sum over 'dp' of a dp-2 mesh on
    integers, an allgather over it, then P3J_STEPS steps of the flagship
    (depth cut) through the GSPMD step on the loop's data."""
    def fn(layers, steps, rows):
        import dataclasses
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import train_lm
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.parallel import mesh as mesh_lib
        hvd.init(device="cuda")
        r = hvd.rank()
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = mesh_lib.set_global_mesh(mesh_lib.build_mesh(dp=2))
        ints = torch.arange(-300, 213, dtype=torch.int32, device=dev)
        ints = ints * (3 if r == 0 else -2) + 7 * r
        out = {"rank": r, "backend": state.backend(),
               "mine": ints.cpu().tolist()}
        for op in ("min", "max", "sum"):
            out[op] = hvd.allreduce(ints, op=op,
                                    axis_name="dp").cpu().tolist()
        out["gather"] = hvd.allgather(ints, axis_name="dp").cpu().tolist()
        cfg = dataclasses.replace(train_lm.flagship_config(True),
                                  num_layers=layers)
        model, opt, step, _ = train_lm.build_gspmd_step(
            cfg, rows // 2, 1024, 1, dev, mesh)
        out["losses"] = []
        for i in range(steps):
            toks = train_lm.batch_at(0, i, cfg.vocab_size, rows, 1024)
            out["losses"].append(step(model, opt, toks.to(dev))[2].item())
        out["launches"] = dict(fa.launch_counts)
        mesh_lib.reset_global_mesh()
        hvd.shutdown()
        return out
    return fn


def _p3j_raise_job():
    def fn():
        import os
        if os.environ["HVD_PROCESS_ID"] == "1":
            raise ValueError("rank 1 raised on purpose")
        return os.environ["HVD_PROCESS_ID"]
    return fn


def run_fn_ranks(card):
    """Phase 3j (a) on two ranks and (b): run(fn, num_proc=2) on the one
    card (gloo between two processes, over CUDA tensors): min and max
    exact on integers, results in rank order, a worker's exception
    reported at the launcher with its rank, and each worker's
    P3J_STEPS flagship steps (depth P3J_LAYERS) with losses equal across
    ranks."""
    from horovod_tpu_torch.run.launch import run
    t0 = time.perf_counter()
    res = run(_p3j_ranks_job(), args=(P3J_LAYERS, P3J_STEPS, P3J_ROWS),
              num_proc=2, start_timeout_s=P3J_RUN_S)
    wall = time.perf_counter() - t0
    if [r["rank"] for r in res] != [0, 1]:
        raise AssertionError(f"run(fn) results out of rank order: "
                             f"{[r['rank'] for r in res]}")
    a, b = (torch.tensor(r["mine"]) for r in res)
    want = {"min": torch.minimum(a, b), "max": torch.maximum(a, b),
            "sum": a + b}
    for r in res:
        for op, w in want.items():
            if r[op] != w.tolist():
                raise AssertionError(f"rank {r['rank']}: {op} over dp is "
                                     f"not exact")
        if r["gather"] != torch.cat([a, b]).tolist():
            raise AssertionError(f"rank {r['rank']}: allgather over dp")
        if not all(map(math.isfinite, r["losses"])):
            raise AssertionError(f"rank {r['rank']} losses {r['losses']}")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError(f"run(fn) ranks' losses differ: "
                             f"{[r['losses'] for r in res]}")
    t1 = time.perf_counter()
    try:
        run(_p3j_raise_job(), num_proc=2, start_timeout_s=P3J_RUN_S)
    except RuntimeError as exc:
        if "Worker rank 1 raised" not in str(exc) or \
                "rank 1 raised on purpose" not in str(exc):
            raise AssertionError(f"a worker's exception was reported as "
                                 f"{exc}") from exc
    else:
        raise AssertionError("a worker's exception was not reported")
    log(card, f"phase 3j (a, b): run(fn, num_proc=2) on one card "
              f"({res[0]['backend']} between two processes, over CUDA "
              f"tensors): min/max/sum and allgather over 'dp' exact on "
              f"int32; results in rank order; {P3J_STEPS} flagship steps "
              f"(width 768, depth {P3J_LAYERS}, {P3J_ROWS} x {TRAIN_SEQ} "
              f"rows a step over dp 2), losses equal on both ranks "
              f"{[round(v, 6) for v in res[0]['losses']]}, launches per "
              f"rank {res[0]['launches']}; {wall:.1f} s; "
              f"rank 1's exception reported at the launcher with its rank "
              f"({time.perf_counter() - t1:.1f} s)")
    try:
        import cloudpickle
        pickled = f"cloudpickle {cloudpickle.__version__} imports"
    except ImportError:
        pickled = "cloudpickle does not import: fn travels by reference"
    log(card, f"phase 3j (b): {pickled}")
    return res[0]["losses"]


def _launch_env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(LAUNCH_ENV)}
    env.update(extra)
    return env


def run_mpirun(card):
    """Phase 3j (c): two train_lm processes with only the env mpirun
    exports (OMPI_COMM_WORLD_*, its job id) and HVD_RENDEZVOUS_DIR: rank
    0 publishes the rendezvous through the filesystem; both finish, with
    the same losses, which it returns."""
    import shutil
    rdzv = os.path.join(P3J_DIR, "rdzv")
    shutil.rmtree(rdzv, ignore_errors=True)
    os.makedirs(rdzv)
    base = _launch_env({"HVD_RENDEZVOUS_DIR": rdzv,
                        "OMPI_MCA_orte_hnp_uri": f"p3j.{os.getpid()};tcp://"
                                                 f"127.0.0.1:1",
                        "OMPI_COMM_WORLD_SIZE": "2",
                        "OMPI_COMM_WORLD_LOCAL_SIZE": "2"})
    args = [sys.executable, "-m", "horovod_tpu_torch.train_lm", "--device",
            "cuda", "--steps", str(P3J_STEPS), "--num-layers",
            str(P3J_LAYERS)]
    t0 = time.perf_counter()
    procs, errs = [], []
    for r in range(2):
        env = dict(base, OMPI_COMM_WORLD_RANK=str(r),
                   OMPI_COMM_WORLD_LOCAL_RANK=str(r))
        errs.append(open(os.path.join(P3J_DIR, f"mpirun.{r}.err"), "w"))
        procs.append(subprocess.Popen(args, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=errs[r],
                                      text=True, start_new_session=True))
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=P3J_RUN_S)
            if p.returncode:
                raise AssertionError(
                    f"mpirun rank {r} exited {p.returncode}: "
                    f"{open(errs[r].name).read()[-3000:]}")
            outs.append([json.loads(ln) for ln in out.splitlines()
                         if ln.startswith("{")])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.communicate()
        for f in errs:
            f.close()
    done = [[e for e in o if e["event"] == "done"][-1] for o in outs]
    if [d["rank"] for d in done] != [0, 1] or \
            done[0]["losses"] != done[1]["losses"]:
        raise AssertionError(f"mpirun ranks' losses differ: {done}")
    if os.listdir(rdzv):
        raise AssertionError(f"rendezvous file left behind: "
                             f"{os.listdir(rdzv)}")
    log(card, f"phase 3j (c): mpirun on PATH: "
              f"{shutil.which('mpirun') is not None} (the drill sets only "
              f"its env, the same either way); two train_lm --steps "
              f"{P3J_STEPS} --num-layers {P3J_LAYERS} processes with "
              f"OMPI_COMM_WORLD_* and HVD_RENDEZVOUS_DIR only formed their "
              f"world through run/mpi.py, both finished, losses equal "
              f"{[round(v, 6) for v in done[0]['losses']]}; launches per "
              f"rank "
              f"{done[0]['launches']}; the rendezvous file removed; "
              f"{time.perf_counter() - t0:.1f} s")
    return done[0]["losses"]


def _overlap_run(dev, cfg, on, layers_cfg):
    """The eager step with HOROVOD_OVERLAP_EAGER ``on``: P3J_STEPS steps
    from seed 0, the fp32 masters after them, then OVERLAP_WINDOWS
    windows of OVERLAP_WINDOW steps timed with the overlap tally."""
    from horovod_tpu_torch.ops import eager as eager_mod
    cfg.overlap_eager = on
    step, model, opt, toks = trainer.build_eager_lm_step(
        layers_cfg, TRAIN_BATCH, TRAIN_SEQ, dev, inner=P3J_STEPS)
    for i in range(P3J_STEPS):
        step(toks[i])
    params = [p.detach().clone() for p in model.parameters()]
    eager_mod.reset_tally()
    windows = []
    for _ in range(OVERLAP_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(OVERLAP_WINDOW):
            loss = step(toks[i % P3J_STEPS])
        loss.item()
        windows.append((time.perf_counter() - t0) / OVERLAP_WINDOW * 1e3)
    t = eager_mod.tally()
    mode = "overlap" if on else "barrier"
    n = OVERLAP_WINDOWS * OVERLAP_WINDOW
    out = {"params": params, "ms": min(windows), "windows": windows,
           "enqueue_ms": t.get(("hvd_grad_enqueue_ms_total", mode), 0) / n,
           "exposed_ms": t.get(("hvd_grad_exposed_ms_total", mode), 0) / n,
           "flushes": t.get(("hvd_overlap_ready_flushes_total",), 0),
           "tensors": t.get(("hvd_overlap_ready_tensors_total",), 0),
           "wakes": t.get(("hvd_overlap_wakes_total",), 0)}
    del step, model, opt, toks
    cfg.overlap_eager = False
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _p3j_overlap_job():
    """run(fn)'s worker: the eager step (depth cut) with overlap off then
    on, P3J_STEPS steps each from seed 0; whether the fp32 masters are
    bit-equal, and ms/step over ``timed`` steps of each."""
    def fn(layers, steps, timed):
        import dataclasses
        import time
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import train_lm, trainer
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.ops import eager
        from horovod_tpu_torch.ops import flash_attention as fa
        hvd.init(device="cuda")
        dev = torch.device("cuda", torch.cuda.current_device())
        config = state.global_state().config
        cfg = dataclasses.replace(train_lm.flagship_config(True),
                                  num_layers=layers)
        out = {"rank": hvd.rank()}
        params = {}
        for on in (False, True):
            config.overlap_eager = on
            step, model, _, toks = trainer.build_eager_lm_step(
                cfg, 16, 1024, dev, inner=steps)
            for i in range(steps):
                step(toks[i])
            params[on] = [p.detach().clone() for p in model.parameters()]
            eager.reset_tally()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(timed):
                loss = step(toks[i % steps])
            loss.item()
            out[f"ms_{on}"] = (time.perf_counter() - t0) / timed * 1e3
            out[f"tally_{on}"] = {"/".join(map(str, k)): v
                                  for k, v in eager.tally().items()}
            del step, model, toks
        out["equal"] = all(torch.equal(a, b) for a, b in
                           zip(params[False], params[True]))
        out["launches"] = dict(fa.launch_counts)
        out["negotiated"] = state.global_state().coordinator.negotiated
        config.overlap_eager = False
        hvd.shutdown()
        return out
    return fn


def run_overlap(card, dev):
    """Phase 3j (d): the flagship eager step at full size at world 1 over
    NCCL with HOROVOD_OVERLAP_EAGER 0 and 1: fp32 masters bit-equal
    after P3J_STEPS steps, ready flushes only with it on, ms/step (best
    of OVERLAP_WINDOWS windows of OVERLAP_WINDOW), enqueue and exposed
    drain ms; then two ranks on the card over gloo at depth P3J_LAYERS,
    masters bit-equal to the barrier run's, ms/step."""
    from horovod_tpu_torch.common import state
    from horovod_tpu_torch.run.launch import run
    cfg = state.global_state().config
    flagship = train_lm.flagship_config(True)
    before = dict(fa.launch_counts)
    res = {on: _overlap_run(dev, cfg, on, flagship) for on in (False, True)}
    launches = {k: v - before.get(k, 0) for k, v in fa.launch_counts.items()
                if v != before.get(k, 0)}
    same = all(torch.equal(a, b) for a, b in
               zip(res[False]["params"], res[True]["params"]))
    if not same:
        raise AssertionError("overlap on/off: fp32 masters differ after "
                             f"{P3J_STEPS} steps")
    if res[True]["flushes"] <= 0 or res[False]["flushes"] != 0:
        raise AssertionError(f"ready flushes: on {res[True]['flushes']}, "
                             f"off {res[False]['flushes']}")
    for on in (False, True):
        r = res[on]
        log(card, f"phase 3j (d): flagship eager step b{TRAIN_BATCH} x "
                  f"s{TRAIN_SEQ}, world 1 over NCCL, HOROVOD_OVERLAP_EAGER="
                  f"{int(on)}: {r['ms']:.3f} ms/step (windows "
                  f"{[round(w, 3) for w in r['windows']]}), enqueue "
                  f"{r['enqueue_ms']:.3f} ms and exposed drain "
                  f"{r['exposed_ms']:.3f} ms a step; ready flushes "
                  f"{r['flushes']} ({r['tensors']} tensors), wakes "
                  f"{r['wakes']}")
    log(card, f"phase 3j (d): fp32 masters after {P3J_STEPS} steps "
              f"bit-equal with overlap on and off; launches of both runs "
              f"{launches}")
    t0 = time.perf_counter()
    two = run(_p3j_overlap_job(), args=(P3J_LAYERS, P3J_STEPS, 5),
              num_proc=2, start_timeout_s=P3J_RUN_S)
    for r in two:
        if not r["equal"]:
            raise AssertionError(f"rank {r['rank']}: overlap masters "
                                 f"differ from the barrier run's")
    log(card, f"phase 3j (d): 2 ranks on one card (gloo between two "
              f"processes; negotiated: {two[0]['negotiated']}), eager "
              f"step depth {P3J_LAYERS}: fp32 masters after {P3J_STEPS} "
              f"steps bit-equal to the barrier run's on both ranks; "
              f"ms/step barrier "
              f"{[round(r['ms_False'], 2) for r in two]}, overlap "
              f"{[round(r['ms_True'], 2) for r in two]}; rank 0's overlap "
              f"tally {two[0]['tally_True']}; launches per rank "
              f"{two[0]['launches']}; "
              f"{time.perf_counter() - t0:.1f} s")
    return {on: {k: v for k, v in res[on].items() if k != "params"}
            for on in res}, two


def _hvdrun_lm(layout, directory, steps, every, name):
    """hvdrun -np 2 on the one card: train_lm's --steps loop at
    ``layout`` (e.g. ["--tp", "2"]), depth P3J_LAYERS, checkpointing to
    ``directory``; a Popen with stdout piped, hvdrun's stderr to
    ``<name>.err`` and each rank's to ``<name>.rank<r>.err``. The ranks
    run under PYTHONFAULTHANDLER, with no core file: a SIGABRT prints
    every thread's Python stack (``_dump_rank_stacks``)."""
    base = os.path.join(P3J_DIR, name)
    # the rank's stderr to a file of its own; its stdout (the JSON
    # events) stays hvdrun's
    wrap = ["sh", "-c",
            'ulimit -c 0; exec "$@" 2>"$0.rank$HVD_PROCESS_ID.err"', base]
    args = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "-H",
            "localhost:2"] + wrap + [
            sys.executable, "-m",
            "horovod_tpu_torch.train_lm", "--device", "cuda", "--steps",
            str(steps), "--num-layers", str(P3J_LAYERS),
            "--checkpoint-dir", directory, "--checkpoint-every",
            str(every)] + layout
    err = open(base + ".err", "w")
    proc = subprocess.Popen(args, cwd=ROOT,
                            env=dict(os.environ, PYTHONFAULTHANDLER="1"),
                            stdout=subprocess.PIPE, stderr=err, text=True,
                            start_new_session=True)
    proc.err_path = err.name
    proc.rank_err = [f"{base}.rank{r}.err" for r in range(2)]
    err.close()
    return proc


def _stderr_tails(proc, n=2000):
    """hvdrun's stderr tail and each rank's, for an error message."""
    out = []
    for label, path in [("hvdrun", proc.err_path)] + [
            (f"rank {r}", p) for r, p in enumerate(proc.rank_err)]:
        try:
            with open(path, errors="replace") as f:
                text = f.read()[-n:]
        except OSError as exc:
            text = f"<{exc}>"
        out.append(f"--- {label} stderr ---\n{text}")
    return "\n".join(out)


def _children(pid):
    """The pids of ``pid``'s children (read from /proc)."""
    kids = []
    try:
        for tid in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids += [int(k) for k in f.read().split()]
    except OSError:
        pass
    return kids


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _dump_rank_stacks(proc, wait_s=10.0):
    """At a run's deadline: SIGABRT to each rank of the hvdrun ``proc``
    (faulthandler writes every thread's stack to the rank's stderr),
    then SIGKILL to what is left, hvdrun's group and the ranks' own
    (hvdrun starts each rank in a session of its own)."""
    ranks = _children(proc.pid)
    for pid in ranks:
        try:
            os.kill(pid, signal.SIGABRT)
        except OSError:
            pass
    deadline = time.monotonic() + wait_s
    while any(_alive(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    for pid in ranks:
        try:
            os.killpg(pid, signal.SIGKILL)
        except OSError:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        pass
    proc.wait()
    return ranks


def _events(proc, on_event=None, timeout=P3J_RUN_S):
    """The JSON events of ``proc``'s stdout until it exits (or the
    deadline: then every rank's stacks are dumped and the job killed),
    ``on_event`` called on each. Returns (events, exit code)."""
    import queue as queue_mod
    lines = queue_mod.Queue()

    def read():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)
    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + timeout
    events = []
    while True:
        try:
            ln = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue_mod.Empty:
            ln = ""
        if ln is None:
            break
        if time.monotonic() > deadline:
            ranks = _dump_rank_stacks(proc)
            raise AssertionError(
                f"no end within {timeout} s; stacks of ranks (pids "
                f"{ranks}) dumped by SIGABRT:\n"
                f"{_stderr_tails(proc, 6000)}")
        for ev in _json_objects(ln):
            events.append(ev)
            if on_event is not None:
                on_event(ev)
    return events, proc.wait(timeout=60)


def _json_objects(line):
    """The JSON objects on one line of output (none for another line)."""
    dec, out, i = json.JSONDecoder(), [], 0
    line = line.strip()
    while line.startswith("{", i):
        obj, i = dec.raw_decode(line, i)
        out.append(obj)
    return out


def run_mesh_checkpoint(card):
    """Phase 3j (e): train_lm --tp 2 --steps CKPT_STEPS on two ranks on
    the card, stopped by SIGTERM after step CKPT_STOP (emergency save,
    exit 45), beside an uninterrupted tp 2 run; the save resumed at tp 2
    (the later losses bit-equal to the uninterrupted run's) and at dp 2
    (within 2^-8). Save (blocking, whole) and restore ms recorded."""
    import shutil
    from horovod_tpu_torch.common.exceptions import PREEMPTED_EXIT_CODE
    base = os.path.join(P3J_DIR, "ckpt")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t0 = time.perf_counter()
    stopped = _hvdrun_lm(["--tp", "2"], os.path.join(base, "stopped"),
                         CKPT_STEPS, 100, "ckpt-stopped")
    full = _hvdrun_lm(["--tp", "2"], os.path.join(base, "full"),
                      CKPT_STEPS, CKPT_STOP, "ckpt-full")

    def stop(ev):
        # the signal lands while step CKPT_STOP runs: its step_end takes
        # the emergency save (a slow forward could let it land later,
        # and the checks below take the step the save names)
        if ev.get("event") == "step" and ev["step"] == CKPT_STOP - 1:
            stopped.send_signal(signal.SIGTERM)
    ev_stop, rc = _events(stopped, stop)
    if rc != PREEMPTED_EXIT_CODE:
        raise AssertionError(f"the stopped tp 2 run exited {rc}: "
                             f"{_stderr_tails(stopped)}")
    pre = [e for e in ev_stop if e["event"] == "preempted"]
    saved = pre[0]["step"]
    # the resumes start while the uninterrupted run still runs (a cut
    # for time: the two rounds of launches overlap)
    runs = {}
    for layout in ("tp", "dp"):
        d = os.path.join(base, f"resume-{layout}")
        shutil.copytree(os.path.join(base, "stopped"), d)
        runs[layout] = _hvdrun_lm([f"--{layout}", "2"], d, CKPT_STEPS, 100,
                                  f"ckpt-resume-{layout}")
    ev_full, rc_full = _events(full)
    if rc_full:
        raise AssertionError(f"the uninterrupted tp 2 run exited "
                             f"{rc_full}: {_stderr_tails(full)}")
    full_losses = {e["step"]: e["loss"] for e in ev_full
                   if e["event"] == "step"}
    got = {}
    for layout, proc in runs.items():
        events, rc = _events(proc)
        if rc:
            raise AssertionError(f"resume at {layout} 2 exited {rc}: "
                                 f"{_stderr_tails(proc, 3000)}")
        res = [e for e in events if e["event"] == "resume"][0]
        if res["step"] != saved or res["saved_layout"]["tp"] != 2:
            raise AssertionError(f"resume at {layout} 2: {res}")
        got[layout] = ({e["step"]: e["loss"] for e in events
                        if e["event"] == "step"}, res["ms"])
    later = range(saved + 1, CKPT_STEPS + 1)
    tp_losses, dp_losses = got["tp"][0], got["dp"][0]
    if [tp_losses.get(s) for s in later] != [full_losses[s] for s in later]:
        raise AssertionError(f"tp 2 resume {tp_losses} != uninterrupted "
                             f"{full_losses}")
    worst = max(abs(dp_losses[s] - full_losses[s]) for s in later)
    if worst > 2 ** -8:
        raise AssertionError(f"dp 2 resume {dp_losses} vs {full_losses}: "
                             f"{worst}")
    done_full = [e for e in ev_full if e["event"] == "done"][0]
    whole = done_full["ckpt"]
    log(card, f"phase 3j (e): train_lm --tp 2 (width 768, depth "
              f"{P3J_LAYERS}, {P3J_ROWS} x {TRAIN_SEQ} rows a step; 2 ranks "
              f"on one card over gloo) sent SIGTERM during step "
              f"{CKPT_STOP}: emergency save at step {saved} (blocking "
              f"{pre[0]['ckpt']['block_ms']:.1f} ms), exit "
              f"{PREEMPTED_EXIT_CODE}; uninterrupted tp 2 async save at step "
              f"{CKPT_STEPS}: blocking {whole['block_ms']:.1f} ms, whole "
              f"{whole['save_ms']:.1f} ms; resumed at tp 2 (restore "
              f"{got['tp'][1]:.1f} ms): losses of steps {list(later)} "
              f"bit-equal to the uninterrupted run's "
              f"{[round(full_losses[s], 6) for s in later]}; resumed at dp 2 "
              f"(restore {got['dp'][1]:.1f} ms): within {worst:.2e} (bound "
              f"2^-8); launches per rank of the uninterrupted run "
              f"{done_full['launches']}; {time.perf_counter() - t0:.1f} s")
    return {"block_ms": pre[0]["ckpt"]["block_ms"], "whole": whole,
            "restore_ms": {k: v[1] for k, v in got.items()}}


def run_phase_3j(card, dev):
    """Phase 3j (d) and (e), each part fatal and under its own deadline,
    with the card and the host to themselves; (a) at world 1 runs beside
    the process lane, and (a, b)'s ranks and (c) in it."""
    t0 = time.perf_counter()
    run_overlap(card, dev)
    run_mesh_checkpoint(card)
    log(card, f"phase 3j (d), (e): {time.perf_counter() - t0:.1f} s in all")


# ---------------------------------------------------------------------------
# phase 3k: the observability path on the card: (a) the flagship eager
# step at world 1 over NCCL with the metrics, tracing, history and alert
# planes on (the exposition server scraped over localhost, every
# gradient's span tree, the history read back), then with them off;
# (b) two ranks on the card over gloo: rank 0's aggregate covers both
# ranks, and a stall forced on rank 1 yields rank 0's own flight dump and
# the solicited remote one; (c) the same two ranks under a chaos spec;
# (d) GPT-2 small serving 8 requests at prompt 960 with request tracing


P3K_DIR = os.path.join(ROOT, "build", "phase3k")
P3K_STEPS = 10
P3K_ROUNDS, P3K_WINDOW = 4, 5   # rounds of on, off, off, on windows
P3K_CHAOS = "hvd.negotiation:*:drop_response:0.2"
P3K_STAGES = ("enqueue", "negotiate", "fusion", "execute", "callback")


def _planes(on, rank=0, history_dir=None):
    """Every observability plane of this process on (fresh) or off: the
    metrics, tracing, history and alert planes, and (phase 3n (f)) the
    numerics and memory planes."""
    from horovod_tpu_torch.utils import (alerts, history, memory, metrics,
                                         numerics, tracing)
    metrics.reset(enabled=on)
    tracing.reset(enabled=on, rank=rank)
    numerics.reset(enabled=on)
    memory.reset(enabled=on)
    if on:
        # the writer's own interval (HVD_HISTORY_INTERVAL_S, 30 s by
        # default): the checks flush it
        history.reset(enabled=True, dirpath=history_dir, rank=rank)
    else:
        history.reset(enabled=False)
    alerts.reset(enabled=on)


def _observed_step(step, toks, i):
    """One eager step with the per-step work of the memory plane around
    it (the compile tracker's key, the allocator peak reset and read) and
    the ticks of the history and alert planes after it: what
    ``trainer.instrument_step`` does each step, without its sync."""
    from horovod_tpu_torch.utils import alerts, history, memory
    batch = toks[i % toks.shape[0]]
    mem = memory.enabled()
    if mem:
        memory.get_tracker().observe("train:p3k", (batch,))
        memory.reset_step_peak()
    loss = step(batch)
    if mem:
        memory.step_peak_bytes()
    now = time.monotonic()
    history.poke(now)
    alerts.tick(now)
    return loss


def _percentile(vals, q):
    return float(torch.quantile(torch.tensor(vals, dtype=torch.float64),
                                q)) if vals else float("nan")


def _span_trees(spans, names):
    """{name: the stage-ordered spans of its newest trace} of ``names``."""
    by_name = {}
    for s in spans:
        if s.get("tensor") in names and s["stage"] in P3K_STAGES:
            by_name.setdefault(s["tensor"], []).append(s)
    trees = {}
    for name in names:
        spans_of = by_name.get(name, [])
        if not spans_of:
            raise AssertionError(f"no spans for {name}")
        last = spans_of[-1]["trace_id"]
        trees[name] = sorted((s for s in spans_of if s["trace_id"] == last),
                             key=lambda s: (s["start_us"], s["span_id"]))
    return trees


def check_observed_eager(card, dev):
    """Phase 3k (a): the flagship eager step (GPT-2 small, full width and
    depth, b16 x s1024) at world 1 over NCCL, P3K_STEPS steps with every
    plane on, then from the same seed with every plane off: fp32 masters
    bit-equal; ms/step of both, interleaved windows."""
    import shutil
    import urllib.request
    from horovod_tpu_torch.common import state
    from horovod_tpu_torch.ops import eager as eager_mod
    from horovod_tpu_torch.utils import history, metrics, tracing
    t0 = time.perf_counter()
    hist_dir = os.path.join(P3K_DIR, "history")
    shutil.rmtree(hist_dir, ignore_errors=True)
    coord = state.global_state().coordinator
    # phase 3j ran this step's gradient set: plan it afresh here, so the
    # fusion planner's totals count this run's plan
    coord.plan_cache.clear()
    flagship = train_lm.flagship_config(True)
    _planes(True, history_dir=hist_dir)
    server = metrics.MetricsServer(
        0, lambda: metrics.get_registry().snapshot(),
        remote_snapshots_fn=coord._remote_metrics_snapshots,
        host="127.0.0.1")
    try:
        step_on, model_on, _, toks = trainer.build_eager_lm_step(
            flagship, TRAIN_BATCH, TRAIN_SEQ, dev, inner=P3K_STEPS)
        n_grads = sum(1 for p in model_on.parameters() if p.requires_grad)
        names = [f"hvd.eager_grads.{i}" for i in range(n_grads)]
        fa.reset_launch_counts()
        for i in range(P3K_STEPS):
            loss = _observed_step(step_on, toks, i)
        loss.item()
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        spans = tracing.get_tracer().spans()
        history.flush(wait=True)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            parsed = metrics.parse_prometheus(r.read().decode())
    finally:
        server.close()

    def sample(name, series=None):
        out = 0.0
        for labels, v in parsed.get(name, {"samples": []})["samples"]:
            if labels.get("__series__") == series:
                out += v
        return out
    flushes = sample("hvd_flush_tensors", "count")
    drained = sample("hvd_flush_tensors", "sum")
    fused = sample("hvd_fusion_tensors_total")
    misses = sample("hvd_plan_cache_misses_total")
    hits = sample("hvd_plan_cache_hits_total")
    if not (flushes > 0 and fused > 0 and sample("hvd_fusion_bytes_total")
            > 0 and sample("hvd_fusion_buckets_total") > 0):
        raise AssertionError(f"cycles or fusion totals not above 0: "
                             f"{sorted(parsed)}")
    if drained != P3K_STEPS * n_grads or fused != n_grads * misses or \
            misses + hits != flushes:
        raise AssertionError(
            f"flushes drained {drained} tensors of {P3K_STEPS} x {n_grads} "
            f"gradients enqueued; fusion planned {fused} ({misses} plan "
            f"misses, {hits} hits, {flushes} flushes)")
    trees = _span_trees(spans, set(names))
    stage_ms = {s: [] for s in P3K_STAGES}
    first, last = None, None
    for name, tree in trees.items():
        if [s["stage"] for s in tree] != list(P3K_STAGES) or \
                any(s["status"] != "ok" for s in tree) or \
                any(c["parent_id"] != p["span_id"]
                    for p, c in zip(tree, tree[1:])):
            raise AssertionError(f"{name}: span tree {tree}")
        for s in tree:
            stage_ms[s["stage"]].append((s["end_us"] - s["start_us"]) / 1e3)
        first = min(first or tree[0]["start_us"], tree[0]["start_us"])
        last = max(last or tree[-1]["end_us"], tree[-1]["end_us"])
    records, torn = history.read_records(hist_dir, rank=0)
    flush_series = history.series(records, "hvd_flush_tensors")
    if torn or not records or not flush_series:
        raise AssertionError(f"history: {len(records)} records, {torn} "
                             f"torn, series {flush_series}")
    params_on = [p.detach().clone() for p in model_on.parameters()]

    # the same steps from the same seed with every plane off
    _planes(False)
    step_off, model_off, _, _ = trainer.build_eager_lm_step(
        flagship, TRAIN_BATCH, TRAIN_SEQ, dev, inner=P3K_STEPS)
    for i in range(P3K_STEPS):
        loss = _observed_step(step_off, toks, i)
    loss.item()
    same = all(torch.equal(a, b.detach()) for a, b in
               zip(params_on, model_off.parameters()))
    if not same:
        raise AssertionError("planes on/off: fp32 masters differ")
    del params_on
    # interleaved timing windows: on, off, off, on in every round
    windows = {True: [], False: []}
    for _ in range(P3K_ROUNDS):
        for on, step in ((True, step_on), (False, step_off),
                         (False, step_off), (True, step_on)):
            _planes(on, history_dir=hist_dir)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(P3K_WINDOW):
                loss = _observed_step(step, toks, i)
            loss.item()
            windows[on].append((time.perf_counter() - t1) / P3K_WINDOW
                               * 1e3)
    _planes(True)
    ms_on, ms_off = min(windows[True]), min(windows[False])
    med_on = _percentile(windows[True], 0.5)
    med_off = _percentile(windows[False], 0.5)
    med = {s: round(_percentile(v, 0.5), 4) for s, v in stage_ms.items()}
    p99 = {s: round(_percentile(v, 0.99), 4) for s, v in stage_ms.items()}
    log(card, f"phase 3k (a): flagship eager step (gpt2_small_tpu, "
              f"b{TRAIN_BATCH} x s{TRAIN_SEQ}, world 1 over NCCL, "
              f"{n_grads} gradients a step), {P3K_STEPS} steps with "
              f"metrics, tracing, history and alerts on: the port's "
              f"MetricsServer scraped over localhost ({len(parsed)} "
              f"families): {int(flushes)} flush cycles drained "
              f"{int(drained)} tensors (= {P3K_STEPS} x {n_grads} "
              f"enqueued), fusion planned {int(fused)} tensors "
              f"{int(sample('hvd_fusion_bytes_total'))} bytes in "
              f"{int(sample('hvd_fusion_buckets_total'))} buckets "
              f"({int(misses)} plan miss, {int(hits)} hits); wire bytes "
              f"{int(sample('hvd_wire_bytes_total'))}; every gradient of "
              f"the last step has a closed enqueue -> negotiate -> fusion "
              f"-> execute -> callback tree; history {len(records)} "
              f"records read back; launches {launches}")
    log(card, f"phase 3k (a): the last step's spans, ms per gradient "
              f"median {med}, p99 {p99}; first enqueue to last callback "
              f"{(last - first) / 1e3:.3f} ms (the host's wait at the "
              f"gradient sync: execute closes at the bucket's CUDA "
              f"completion event)")
    log(card, f"phase 3k (a): fp32 masters after {P3K_STEPS} steps "
              f"bit-equal with every plane off; ms/step over "
              f"{2 * P3K_ROUNDS} windows of {P3K_WINDOW} steps each way "
              f"(on, off, off, on), best / median: planes on "
              f"{ms_on:.3f} / {med_on:.3f}, off {ms_off:.3f} / "
              f"{med_off:.3f}, overhead {(ms_on / ms_off - 1) * 100:+.2f} "
              f"/ {(med_on / med_off - 1) * 100:+.2f} %; windows on "
              f"{[round(w, 3) for w in windows[True]]}, off "
              f"{[round(w, 3) for w in windows[False]]}; "
              f"{time.perf_counter() - t0:.1f} s")
    del step_on, model_on, step_off, model_off, toks
    eager_mod.reset_tally()
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms_on": ms_on, "ms_off": ms_off, "med_on": med_on,
            "med_off": med_off, "stage_ms_median": med,
            "stage_ms_p99": p99, "sync_ms": (last - first) / 1e3,
            "n_grads": n_grads}


def _p3k_ranks_job():
    """run(fn)'s worker of phase 3k (b) and (c): the eager step at depth
    P3J_LAYERS, P3J_STEPS steps; rank 0 scrapes its aggregate until it
    covers both ranks; then, with ``stall``, rank 1 holds back one
    allreduce past the stall deadline and rank 0 reports the flight dumps
    its coordinator wrote. With ``tune`` (phase 3n (c), HOROVOD_AUTOTUNE=1
    in the launch's env) the autotuner scores every negotiated cycle
    while the steps run; at the end rank 1 scales its reduced copy of
    P3N_DIV_NAME by 1 + P3N_DIV_REL (the core's test hook) through
    P3N_DIV_ROUNDS grouped allreduces, rank 0 waits for its coordinator's
    divergence verdict, then freezes the tuner, and both ranks report the
    tuned values they hold after the collectives ordered since."""
    def fn(layers, steps, stall, tune=False):
        import dataclasses
        import hashlib
        import json
        import os
        import time
        import urllib.request
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import train_lm, trainer
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.utils import metrics
        from horovod_tpu_torch.utils import autotune
        if tune:
            # one scored window a negotiated cycle, so the knobs move in
            # a short run
            autotune.CYCLES_PER_SAMPLE = autotune.SAMPLES_PER_STEP = 1
        hvd.init(device="cuda")
        r = hvd.rank()
        dev = torch.device("cuda", torch.cuda.current_device())
        cfg = dataclasses.replace(train_lm.flagship_config(True),
                                  num_layers=layers)
        step, model, _, toks = trainer.build_eager_lm_step(
            cfg, 16, 1024, dev, inner=steps)
        losses = [float(step(toks[i])) for i in range(steps)]
        masters = [hashlib.sha256(p.detach().cpu().numpy().tobytes())
                   .hexdigest() for p in model.parameters()]
        out = {"rank": r, "losses": losses, "masters": masters}
        # one more allreduce after the interval, so the worker's
        # snapshot rides a cycle
        time.sleep(float(os.environ["HVD_METRICS_INTERVAL"]) * 2)
        hvd.allreduce(torch.ones(4, device=dev), name="p3k.late")
        if r == 0:
            port = int(os.environ["HVD_METRICS_PORT"])
            deadline = time.monotonic() + 30
            while True:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics.json",
                        timeout=10) as resp:
                    data = json.loads(resp.read().decode())
                agg = data["aggregate"]
                if agg.get("ranks") == [0, 1] or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            out["agg_ranks"] = agg.get("ranks")
            out["ranks_in_view"] = sorted(data["ranks"])
            vals = {}
            for name in ("hvd_negotiation_cycles_total",
                         "hvd_coordinator_cycles_total",
                         "hvd_fusion_tensors_total",
                         "hvd_chaos_injections_total"):
                fam = agg["metrics"].get(name, {"values": []})
                vals[name] = sum(v["value"] for v in fam["values"])
            out["agg"] = vals
        if stall:
            cfg_live = state.global_state().config
            cfg_live.stall_warning_time_seconds = 0.5
            if r == 1:
                time.sleep(2.5)  # held back past the stall deadline
            hvd.allreduce(torch.ones(4, device=dev), name="p3k.stall")
            if r == 0:
                # rank 1's background cycles keep heartbeating; the
                # first after the solicitation carries its dump
                svc = state.global_state().coordinator._negotiator.service
                deadline = time.monotonic() + 20
                while 1 not in svc.flight_dump_view() and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                dumps = dict(svc.flight_dump_view())
                dumps[0] = os.path.join(os.environ["HVD_FLIGHT_DIR"],
                                        "flight-rank0.json")
                out["dumps"] = {}
                for rank, path in dumps.items():
                    if os.path.exists(path):
                        with open(path) as f:
                            d = json.load(f)
                        out["dumps"][rank] = {
                            "reason": d["reason"], "spans": len(d["spans"]),
                            "held": sum(s.get("tensor") == "p3k.stall"
                                        for s in d["spans"] +
                                        d["open_spans"]),
                            "stall_events": sum(
                                e["event"] == "stall"
                                for e in d["events"])}
            else:
                time.sleep(1.0)
        if tune:
            # after the stall's dumps: the sentinel's escalation solicits
            # dumps too, once a job
            out.update(_p3n_divergence_and_tuning(hvd, state, dev, r))
        hvd.shutdown()
        return out
    return fn


P3N_DIV_NAME = "p3n.div.0"
P3N_DIV_REL = 1e-2
P3N_DIV_ROUNDS = 3


def _p3n_divergence_and_tuning(hvd, state, dev, r):
    """Phase 3n (c) inside phase 3k (b)'s 2-rank launch (see
    ``_p3k_ranks_job``); returns what this rank saw."""
    import time
    coord = state.global_state().coordinator
    cfg = state.global_state().config
    gen = torch.Generator(device=dev).manual_seed(100 + r)
    if r == 1:
        coord.test_perturb = {P3N_DIV_NAME: P3N_DIV_REL}
    for _ in range(P3N_DIV_ROUNDS):
        hs = hvd.grouped_allreduce_async(
            [torch.randn(4096, generator=gen, device=dev),
             torch.randn(512, generator=gen, device=dev)], name="p3n.div")
        for h in hs:
            hvd.synchronize(h)
    coord.test_perturb = {}
    out = {}
    if r == 0:
        from horovod_tpu_torch.utils import metrics
        svc = coord._negotiator.service
        deadline = time.monotonic() + 20
        while True:
            flagged, first = svc.numerics_view()
            if any(k[2] == "divergence" for k in flagged) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
        snap = metrics.get_registry().snapshot()["metrics"]
        out["div"] = {f"{c}|{t}|{k}": b for (c, t, k), b in flagged.items()
                      if k == "divergence"}
        out["div_first_bad"] = first
        out["divergent_rank"] = snap["hvd_numerics_divergent_rank"][
            "values"][0]["value"]
        out["tuned_best"] = coord.freeze_autotune()
    # collectives ordered after the freeze carry the frozen values
    for i in range(3):
        hvd.allreduce(torch.ones(2, device=dev), name=f"p3n.after{i}")
    out["tuned"] = (int(cfg.fusion_threshold),
                    round(float(cfg.cycle_time_ms), 6))
    return out


def run_observed_ranks(card):
    """Phase 3k (b) and (c): two ranks on the one card over gloo, the
    clean run with a stall forced on rank 1, then the same steps under
    HVD_CHAOS_SPEC (fp32 masters bit-equal to the clean run's)."""
    import shutil
    from horovod_tpu_torch.run.launch import run
    flight = os.path.join(P3K_DIR, "flight")
    shutil.rmtree(flight, ignore_errors=True)
    port = 20000 + os.getpid() % 20000
    # the launcher's SIGTERM to exiting workers must not overwrite the
    # stall's dumps
    base = {"HVD_METRICS_PORT": str(port), "HVD_METRICS_INTERVAL": "0.2",
            "HVD_FLIGHT_DIR": flight, "HVD_FLIGHT_SIGTERM": "0"}
    t0 = time.perf_counter()
    # phase 3n (c) rides this launch: HOROVOD_AUTOTUNE=1, and the
    # divergence drill after the steps
    clean = run(_p3k_ranks_job(), args=(P3J_LAYERS, P3J_STEPS, True, True),
                num_proc=2, env=dict(base, HOROVOD_AUTOTUNE="1"),
                start_timeout_s=P3J_RUN_S)
    t1 = time.perf_counter()
    r0 = clean[0]
    check_divergence_and_tuning(card, clean)
    if r0["agg_ranks"] != [0, 1] or r0["agg"][
            "hvd_negotiation_cycles_total"] <= 0:
        raise AssertionError(f"rank 0's aggregate: {r0['agg_ranks']} "
                             f"{r0['agg']}")
    dumps = r0["dumps"]
    if sorted(dumps) != [0, 1] or not dumps[0]["held"] or \
            not dumps[0]["stall_events"]:
        raise AssertionError(f"the stall's flight dumps: {dumps}")
    log(card, f"phase 3k (b): 2 ranks on one card (gloo), eager step "
              f"width 768 depth {P3J_LAYERS}, {P3J_STEPS} steps: rank 0's "
              f"/metrics.json aggregate covers ranks {r0['agg_ranks']} "
              f"(per-rank views {r0['ranks_in_view']}; aggregate "
              f"{r0['agg']}); a stall forced on rank 1 (held 2.5 s past a "
              f"0.5 s deadline): rank 0's own flight dump {dumps[0]} and "
              f"the solicited dump of rank 1 its coordinator wrote "
              f"{dumps[1]}; {t1 - t0:.1f} s")
    env = dict(base, HVD_CHAOS_SPEC=P3K_CHAOS, HVD_CHAOS_SEED="1234",
               HVD_METRICS_PORT=str(port + 2),
               HVD_FLIGHT_DIR=os.path.join(P3K_DIR, "flight-chaos"))
    chaos = run(_p3k_ranks_job(), args=(P3J_LAYERS, P3J_STEPS, False),
                num_proc=2, env=env, start_timeout_s=P3J_RUN_S)
    injected = chaos[0]["agg"]["hvd_chaos_injections_total"]
    same = all(c["masters"] == k["masters"] for c, k in zip(clean, chaos))
    if not same or injected <= 0:
        raise AssertionError(f"chaos run: masters equal {same}, "
                             f"injections {injected}")
    log(card, f"phase 3k (c): the same 2 ranks under HVD_CHAOS_SPEC="
              f"{P3K_CHAOS!r} (seed 1234): {int(injected)} injections "
              f"(hvd_chaos_injections_total in rank 0's aggregate), "
              f"{P3J_STEPS} steps finished with fp32 masters bit-equal to "
              f"(b)'s clean run on both ranks (sha256 of every "
              f"parameter's bytes), losses "
              f"{[round(v, 6) for v in chaos[0]['losses']]}; "
              f"{time.perf_counter() - t1:.1f} s")
    return {"injected": injected}


def check_divergence_and_tuning(card, ranks):
    """Phase 3n (c): rank 0's coordinator named rank 1, the rank whose
    reduced copy of P3N_DIV_NAME was scaled, in
    ``hvd_numerics_divergent_rank``, for that tensor only; both ranks
    hold identical tuned values after rank 0 froze the tuner."""
    from horovod_tpu_torch.utils import autotune
    r0, r1 = ranks
    div = r0["div"]
    if not div or {k.split("|")[1] for k in div} != {P3N_DIV_NAME} or \
            set(div.values()) != {1} or r0["divergent_rank"] != 1.0:
        raise AssertionError(f"phase 3n (c): the sentinel's verdicts {div}, "
                             f"divergent rank {r0['divergent_rank']}")
    thr, ct = r0["tuned"]
    if r0["tuned"] != r1["tuned"] or r0["tuned_best"] is None or not (
            autotune.THRESHOLD_BOUNDS[0] <= thr <=
            autotune.THRESHOLD_BOUNDS[1] and
            autotune.CYCLE_BOUNDS_MS[0] <= ct <= autotune.CYCLE_BOUNDS_MS[1]):
        raise AssertionError(f"phase 3n (c): tuned values {r0['tuned']} "
                             f"(rank 0, best {r0['tuned_best']}) vs "
                             f"{r1['tuned']} (rank 1)")
    log(card, f"phase 3n (c): 2 ranks on one card (gloo, negotiated), rank "
              f"1 scaled its reduced copy of {P3N_DIV_NAME} by "
              f"1 + {P3N_DIV_REL} in {P3N_DIV_ROUNDS} grouped allreduces: "
              f"rank 0's coordinator flagged divergence {div} (cycle|tensor"
              f"|kind: blamed rank), first bad cycle {r0['div_first_bad']}, "
              f"hvd_numerics_divergent_rank {r0['divergent_rank']:.0f}; "
              f"HOROVOD_AUTOTUNE=1: rank 0's frozen best (threshold, cycle "
              f"ms, bytes/us) {r0['tuned_best']}, both ranks hold "
              f"(threshold, cycle ms) {r0['tuned']} after the collectives "
              f"ordered since")


def check_observed_serving(card, dev, cfg, model):
    """Phase 3k (d): GPT-2 small serves 8 requests at prompt 960 (prefill
    through B2; decode attention is the plain one, as in the JAX engine)
    with request tracing on: every result
    carries a trace id and phase_ms summing to its request's total; the
    p50 and p99 of each phase."""
    from horovod_tpu_torch.utils import tracing
    _planes(True, history_dir=os.path.join(P3K_DIR, "serve-history"))
    requests = [Request(f"p3k-{i}", tuple(
        int(x) for x in (((i + 3) * 7919 + 104729 * j) % 50000 + 1
                         for j in range(960))), max_new_tokens=16)
        for i in range(8)]
    fa.reset_launch_counts()
    results, steps, wall, _ = serve(cfg, model, requests, dev)
    launches = dict(fa.launch_counts)
    if set(launches) != {"flash_fwd_lazy"}:
        raise AssertionError(f"serving at prompt 960 launched {launches}")
    roots = {(s["tensor"], s["trace_id"]): s
             for s in tracing.get_tracer().spans()
             if s["stage"] == tracing.REQUEST}
    phases = {}
    worst = 0.0
    for r in results:
        root = roots.get((r.request_id, r.trace_id))
        if not r.trace_id or root is None or not r.phase_ms:
            raise AssertionError(f"{r.request_id}: trace {r.trace_id}, "
                                 f"phases {r.phase_ms}")
        gap = (root["end_us"] - root["start_us"]) / 1e3 - \
            sum(r.phase_ms.values())
        if not -0.003 <= gap < 1.0:
            raise AssertionError(f"{r.request_id}: phases {r.phase_ms} "
                                 f"do not sum to the total ({gap} ms off)")
        worst = max(worst, abs(gap))
        for k, v in r.phase_ms.items():
            phases.setdefault(k, []).append(v)
    pct = {k: (round(_percentile(v, 0.5), 3), round(_percentile(v, 0.99),
                                                    3))
           for k, v in phases.items()}
    log(card, f"phase 3k (d): served {len(results)} requests at prompt 960 "
              f"(16 new tokens each, {SERVE_SLOTS} slots) in {steps} steps, "
              f"{wall:.3f} s; every result carries a trace id and phase_ms "
              f"summing to its root span's duration (largest gap "
              f"{worst:.3f} ms); phase ms (p50, p99): {pct}; launches "
              f"{launches}")
    return pct


def run_phase_3k(card, dev, cfg, model, ranks):
    """Phase 3k (a) and (d), each part fatal; (b) and (c), whose result is
    ``ranks``, ran beside the process lane."""
    t0 = time.perf_counter()
    eager = check_observed_eager(card, dev)
    serving = check_observed_serving(card, dev, cfg, model)
    # phase 4 times kernels and steps with every plane off (the history
    # writer's thread closed)
    _planes(False)
    log(card, f"phase 3k (a), (d): {time.perf_counter() - t0:.1f} s in all")
    return {"eager": eager, "ranks": ranks, "serving": serving}


# ---------------------------------------------------------------------------
# phase 3l: the fleet and router planes: GPT-2 small (tied embeddings,
# bf16, full width and depth) behind a Router of P3L_REPLICAS engines,
# hot-swapped to a newly published weight generation under a canary


P3L_DIR = os.path.join(ROOT, "build", "phase3l")
P3L_REPLICAS, P3L_SLOTS = 2, 4
# (a): route_lm's workload on the card (prompts 16-960, 8 or 40 new
# tokens); seed 6's 12 requests hold two prompts of one 64-key tile (B1)
P3L_SEED, P3L_REQUESTS, P3L_RATE = 6, 12, 0.5
# (b): traffic at 0.4 arrivals a step (6.4 of the 8 slots' tokens a step
# at 16 new tokens a request on average), so the replicas stay busy and
# no queue grows without bound while the canary waits for requests that
# arrive after the loads; generation 2 is published after
# P3L_PUBLISH_STEP router steps with requests in flight
P3L_SWAP_SEED, P3L_SWAP_REQUESTS, P3L_SWAP_RATE = 4, 160, 0.4
P3L_PUBLISH_STEP = 8
P3L_CANARY_PCT, P3L_CANARY_WINDOW = 50.0, 4
P3L_POLL_S = 0.05
P3L_MIN_GEN2 = 8      # after a promote, generation-2 admissions before
#                       (b)'s traffic stops
# (c): requests behind two replicas when replica 1 is declared lost
P3L_LOST_REQUESTS, P3L_LOST_AFTER = 8, 3
P3L_SPAWN_CHAOS = ("hvd elastic replica supervisor:SpawnReplicaRequest:"
                   "dup_request:1.0:1")


def p3l_cfg():
    """The served model: gpt2_small_tpu with tied embeddings (the
    training flagship's parameters, so phase 3b's weights publish into
    it), bf16, flash prefill."""
    return tr.TransformerConfig.gpt2_small_tpu(attention_impl="flash",
                                               tie_embeddings=True)


def p3l_engine(cfg, weights, dev, queue_depth=256, **kw):
    return ServeEngine(cfg, weights, num_slots=P3L_SLOTS,
                       max_len=SERVE_MAX_LEN, kv_block=SERVE_KV_BLOCK,
                       queue=AdmissionQueue(max_depth=queue_depth,
                                            admission_timeout_s=1e9),
                       seed=0, device=dev, **kw)


def fresh(req, request_id=None):
    """A copy of ``req`` as a client would submit it anew (no arrival
    time, no trace)."""
    return dataclasses.replace(req, request_id=request_id or req.request_id,
                               arrival_ts=0.0, trace=None)


@contextlib.contextmanager
def routed_launches(into):
    """One routed run of phase 3l: the launch counts set to 0 just before
    it and added to ``into`` just after, so that the kernels line counts
    the router's own traffic and never a solo reference or a tie check
    run between two routed runs."""
    fa.reset_launch_counts()
    yield
    for k, v in fa.launch_counts.items():
        into[k] = into.get(k, 0) + v


class SettledCanary(CanaryController):
    """Phase 3l (b)'s CanaryController, fed only the results of requests
    submitted at or after ``settled_step``: the router step after which
    every replica's loader has finished, the canary cohort decodes the
    new generation alone and the held replicas the old one alone. The
    loader's host work slows every replica's step while it runs (ROADMAP
    section C), so a result that met it would judge the swap's own stall,
    not the weights. ``submitted`` maps request ids to the router step of
    their submission; ``counted`` and ``skipped`` list what the windows
    took and left."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.settled_step = None
        self.submitted, self.counted, self.skipped = {}, [], []

    def observe(self, result, replica_id):
        if self.state == "canary":
            at = self.submitted[result.request_id]
            if self.settled_step is None or at < self.settled_step:
                self.skipped.append(result.request_id)
                return
            self.counted.append(result.request_id)
        super().observe(result, replica_id)


def solo_tokens(cfg, weights, requests, dev):
    """Each request served alone, one after another, by one engine of
    phase 3l's shape: {request id: tokens}."""
    eng = p3l_engine(cfg, weights, dev)
    out = {}
    for r in requests:
        eng.submit(fresh(r))
        got = eng.run_to_completion()
        if len(got) != 1 or got[0].outcome != "completed":
            raise AssertionError(f"solo {r.request_id}: {got}")
        out[r.request_id] = list(got[0].tokens)
    return out


def hold_tokens(cfg, weights, prompts, got, want, dev, where):
    """``got`` against ``want`` ({id: tokens}, temperature 0). Where they
    part, the logits at the first differing step (a prefill over the
    prompt and the common tokens) must have their top two within two bf16
    ulps of the top logit, a tie; returns those ties."""
    ties = []
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        if len(g) != len(w):
            raise AssertionError(f"{where} {rid}: {len(g)} tokens, want "
                                 f"{len(w)}")
        k = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        toks = torch.tensor([list(prompts[rid]) + w[:k]], device=dev)
        logits = prefill_forward(cfg, weights, toks)[0][0, -1].float()
        top = torch.topk(logits, 2)
        gap = (top.values[0] - top.values[1]).item()
        limit = bf16_ulps(top.values[0], 2).item()
        tie = {"request": rid, "step": k, "got": g[k], "want": w[k],
               "top2": top.indices.tolist(), "gap": gap, "limit": limit}
        if gap > limit:
            raise AssertionError(f"{where}: tokens part at a non-tie {tie}")
        ties.append(tie)
    return ties


def count_prefills_by_generation(engine, into, admitted):
    """Wrap ``engine._prefill`` to add each prefill's kernel launches to
    ``into[generation]`` (the generation the request is admitted on) and
    one to ``admitted[generation]``, this engine's admissions."""
    inner = engine._prefill

    def prefill(req, prompt_len, final_len):
        before = dict(fa.launch_counts)
        inner(req, prompt_len, final_len)
        admitted[engine.generation] = admitted.get(engine.generation, 0) + 1
        gen = into.setdefault(engine.generation, {})
        for k, v in fa.launch_counts.items():
            if v - before.get(k, 0):
                gen[k] = gen.get(k, 0) + v - before.get(k, 0)
    engine._prefill = prefill


def run_routed_arms(card, dev, cfg, model, launches):
    """Phase 3l (a): route_lm's ``route_workload`` under least_loaded,
    then round_robin, each arm fresh engines behind a fresh Router on the
    same weights: every request completes, no KV block leaks (checked by
    route_lm), the split between replicas; every temperature-0 request's
    tokens equal to one engine serving it alone (or parted at a tie);
    TTFT, per-request inter-token gap, tokens/s, wall time. ``launches``
    takes the arms' flash launches."""
    from horovod_tpu_torch import route_lm, serve_lm
    workload = serve_lm.make_workload(P3L_SEED, P3L_REQUESTS, P3L_RATE,
                                      prompt_lens=(16, 960))
    requests = [r for _, r in workload]
    prompts = {r.request_id: r.prompt for r in requests}
    t0 = time.perf_counter()
    solo = solo_tokens(cfg, model, requests, dev)
    solo_s = time.perf_counter() - t0
    arms = {}
    for policy in ("least_loaded", "round_robin"):
        results = []
        with routed_launches(launches):
            arm = route_lm.route_workload(
                cfg, model, workload, policy, P3L_REPLICAS, P3L_SLOTS,
                SERVE_MAX_LEN, kv_block=SERVE_KV_BLOCK, seed=0, device=dev,
                results=results)
        if (arm["completed"], arm["failed"]) != (len(requests), 0):
            raise AssertionError(f"{policy}: {arm}")
        got = {r.request_id: list(r.tokens) for r in results}
        ties = hold_tokens(cfg, model, prompts, got, solo, dev,
                           f"phase 3l (a) {policy}")
        arms[policy] = dict(arm, ties=ties)
        log(card, f"phase 3l (a): {policy}, {P3L_REPLICAS} replicas x "
                  f"{P3L_SLOTS} slots, max_len {SERVE_MAX_LEN}, "
                  f"{len(requests)} requests (seed {P3L_SEED}, prompts "
                  f"{min(map(len, prompts.values()))}-"
                  f"{max(map(len, prompts.values()))}): all completed in "
                  f"{arm['steps']} router steps, {arm['wall_s']:.3f} s wall, "
                  f"split {arm['by_replica']}, {arm['tokens_per_s']:.1f} "
                  f"tokens/s, TTFT p50/p99 (of {len(requests)} requests) "
                  f"{arm['ttft_p50_s'] * 1e3:.1f}/"
                  f"{arm['ttft_p99_s'] * 1e3:.1f} ms, inter-token p50/p99 "
                  f"{arm['intertoken_p50_s'] * 1e3:.2f}/"
                  f"{arm['intertoken_p99_s'] * 1e3:.2f} ms (per-request "
                  f"mean gaps); tokens equal to the engine serving each "
                  f"alone for {len(requests) - len(ties)}/{len(requests)}, "
                  f"ties {ties}; no KV block leaked")
    log(card, f"phase 3l (a): the solo reference (each request alone, one "
              f"engine) took {solo_s:.1f} s")
    return arms, workload, solo


def mixed_swap_workload():
    """(b)'s traffic: route_lm's workload on the card, every other prompt
    of each canary cohort (the request id's stable hash, as the canary
    splits traffic) cut to 16-63 tokens (one 64-key tile, B1), so that
    both prefill kernels run on both generations whatever the verdict."""
    from horovod_tpu_torch import serve_lm
    from horovod_tpu_torch.router.canary import _hash_pct
    out, seen = [], {True: 0, False: 0}
    for i, (t, r) in enumerate(serve_lm.make_workload(
            P3L_SWAP_SEED, P3L_SWAP_REQUESTS, P3L_SWAP_RATE,
            prompt_lens=(16, 960))):
        rid = f"swap-{i}"
        cohort = _hash_pct(rid) < P3L_CANARY_PCT
        if seen[cohort] % 2 == 0:
            r = dataclasses.replace(r, prompt=r.prompt[:16 + (i * 7) % 48])
        seen[cohort] += 1
        out.append((t, dataclasses.replace(r, request_id=rid)))
    return out


def run_fleet_swap(card, dev, cfg, model, trained, launches):
    """Phase 3l (b): a rank-0 Checkpointer(publish=True) publishes the
    serving tree as generation 1 and ``trained`` (phase 3b's weights by
    name, in the serving dtype) as generation 2 while requests are in
    flight; each
    replica boots through WeightSubscriber.load_initial and loads
    generation 2 in the background (pinned host memory, its own stream,
    a CUDA event the engine waits on); a CanaryController gates the
    swaps, its windows fed only requests submitted once the loads and the
    canary replica's transition are over (``SettledCanary``). Checks: the
    canary's decision, and evidence made of those requests alone; every
    fleet_swap
    with inflight >= 1; each swapped replica's old-generation requests in
    flight across its swap equal to generation 1 served alone, and its
    first generation-2 requests equal to generation 2 served alone;
    every generation's prefills launching both B1 and B2; each engine
    back to one generation. Prints the swap phases, router step ms while
    a loader runs against before the publish, and the device memory with
    two generations resident. ``launches`` takes the routed steps' flash
    launches."""
    import shutil

    from horovod_tpu_torch.fleet import WeightSubscriber
    from horovod_tpu_torch.router import Router
    from horovod_tpu_torch.serving.decode import (model_from_tree,
                                                  serving_tree)
    from horovod_tpu_torch.utils import metrics
    directory = os.path.join(P3L_DIR, "fleet")
    shutil.rmtree(directory, ignore_errors=True)
    tree1 = serving_tree(model)
    if set(trained) != set(tree1):
        raise AssertionError(f"trained and served trees differ: "
                             f"{sorted(set(trained) ^ set(tree1))}")
    tree2 = {n: trained[n].to(device=t.device, dtype=t.dtype)
             for n, t in tree1.items()}
    ckpt = trainer.Checkpointer(directory, publish=True, preemption=False)
    ckpt.manager.save(tree1, 1, block=True)
    canary = SettledCanary(pct=P3L_CANARY_PCT, window=P3L_CANARY_WINDOW,
                           max_canary_replicas=1)
    subs, engines, by_gen, admitted = {}, {}, {}, {}
    t0 = time.perf_counter()
    for rid in range(P3L_REPLICAS):
        subs[rid] = WeightSubscriber(directory, like=tree1, replica=rid,
                                     poll_interval_s=P3L_POLL_S)
        init = subs[rid].load_initial()
        where = init.params["embed.weight"].device
        if init.generation != 1 or where.type != dev.type:
            raise AssertionError(f"replica {rid} booted generation "
                                 f"{init.generation} on {where}")
        engines[rid] = p3l_engine(cfg, model_from_tree(cfg, init.params,
                                                       dev), dev,
                                  subscriber=subs[rid],
                                  generation=init.generation,
                                  swap_gate=canary.gate(rid))
        admitted[rid] = {}
        count_prefills_by_generation(engines[rid], by_gen, admitted[rid])
    boot_s = time.perf_counter() - t0
    router = Router(engines, policy="least_loaded", canary=canary)
    workload = mixed_swap_workload()
    prompts = {r.request_id: r.prompt for _, r in workload}
    step_ms = {"steady": [], "loading": [], "two_generations": []}
    mem = {"one_generation": None, "two_generations": 0}
    swap_step, results, returned_at = {}, [], {}
    published = stop = False
    i = steps = 0
    t0 = time.perf_counter()
    with routed_launches(launches):
        while (not stop and i < len(workload)) or router.pending():
            while not stop and i < len(workload) and workload[i][0] <= steps:
                req = workload[i][1]
                canary.submitted[req.request_id] = steps
                if not router.submit(req):
                    raise AssertionError(f"phase 3l (b): shed "
                                         f"{router.last_shed}")
                i += 1
            loading = published and not all(s.wait(0) for s in subs.values())
            t1 = time.perf_counter()
            done = router.step()
            dt = (time.perf_counter() - t1) * 1e3
            if not published:
                step_ms["steady"].append(dt)
            elif loading:
                step_ms["loading"].append(dt)
            elif any(len(e._params_by_gen) > 1 for e in engines.values()):
                # a transition step: one more decode pass on that replica
                step_ms["two_generations"].append(dt)
            for r in done:
                returned_at[r.request_id] = steps
            results.extend(done)
            for rid, eng in engines.items():
                if eng.last_swap is not None and rid not in swap_step:
                    swap_step[rid] = steps
                if len(eng._params_by_gen) > 1:
                    mem["two_generations"] = max(mem["two_generations"],
                                                 torch.cuda.memory_allocated())
            steps += 1
            if canary.state == "canary" and canary.settled_step is None and \
                    all(s.wait(0) for s in subs.values()) and \
                    all(len(e._params_by_gen) == 1 for e in engines.values()) \
                    and all(engines[r].generation == canary.canary_generation
                            for r in canary.canary_replicas):
                canary.settled_step = steps
            if not published and steps >= P3L_PUBLISH_STEP and \
                    all(e.active_count for e in engines.values()):
                mem["one_generation"] = torch.cuda.memory_allocated()
                ckpt.manager.save(tree2, 2)   # async: the step loop goes on
                published = True
            gen2 = by_gen.get(2, {})
            # every swapped replica has admitted a request on generation 2
            # (the checks below hold its first ones to generation 2 alone)
            took = all(admitted[r].get(2) for r in swap_step)
            if canary.state == "promoted":
                # every replica on generation 2, and enough traffic on it
                stop = took and \
                    all(e.generation == 2 for e in engines.values()) \
                    and sum(gen2.values()) >= P3L_MIN_GEN2 * cfg.num_layers \
                    and {"flash_fwd_online", "flash_fwd_lazy"} <= set(gen2)
            elif canary.state == "rolled_back":
                stop = took   # a quarantined generation gets no new traffic

            if steps > 5000:
                raise AssertionError("phase 3l (b): traffic never drained")
    wall = time.perf_counter() - t0
    ckpt.close()
    if not published or canary.state not in ("promoted", "rolled_back"):
        raise AssertionError(f"phase 3l (b): published {published}, canary "
                             f"{canary.state} after {steps} steps (settled "
                             f"at {canary.settled_step}, counted "
                             f"{len(canary.counted)}, skipped "
                             f"{len(canary.skipped)}, generations "
                             f"{[e.generation for e in engines.values()]})")
    bad = [(r.request_id, r.outcome, r.reason) for r in results
           if r.outcome != "completed"]
    if bad or len({r.request_id for r in results}) != len(results):
        raise AssertionError(f"phase 3l (b): failures {bad}")
    snap = metrics.get_registry().snapshot()
    swaps = [e for e in snap["events"] if e["event"] == "fleet_swap"]
    if not swaps or any(e["inflight"] < 1 for e in swaps) or \
            sorted(e["replica"] for e in swaps) != sorted(swap_step):
        raise AssertionError(f"phase 3l (b): fleet_swap events {swaps}")
    verdict, evidence = canary.decisions[-1]
    late = [q for q in canary.counted
            if canary.submitted[q] < canary.settled_step]
    if late or len(canary.counted) != \
            evidence["canary_n"] + evidence["baseline_n"]:
        raise AssertionError(f"phase 3l (b): the canary counted "
                             f"{len(canary.counted)} results for "
                             f"{evidence}, {late} submitted before step "
                             f"{canary.settled_step}")
    if verdict == "promote" and sorted(swap_step) != list(engines):
        raise AssertionError(f"promoted, but swapped {sorted(swap_step)}")
    for rid, eng in engines.items():
        if len(eng._params_by_gen) != 1 or eng.kv.ledger.blocks_in_use:
            raise AssertionError(f"replica {rid}: generations "
                                 f"{sorted(eng._params_by_gen)}, KV blocks "
                                 f"{eng.kv.ledger.blocks_in_use}")
        if subs[rid].refusals:
            raise AssertionError(f"replica {rid} refused "
                                 f"{subs[rid].refusals}")
    for gen in (1, 2):
        if not {"flash_fwd_online", "flash_fwd_lazy"} <= set(
                by_gen.get(gen, {})):
            raise AssertionError(f"generation {gen}'s prefills launched "
                                 f"{by_gen.get(gen)}")
    # each swapped replica: the old-generation requests in flight across
    # its swap, and its first generation-2 requests, each against the
    # weights it decoded on, served alone
    old, new = [], []
    for rid, at in sorted(swap_step.items()):
        mine = [r for r in results if r.replica == rid]
        crossed = [r for r in mine if r.generation == 1 and
                   returned_at[r.request_id] >= at]
        after = [r for r in mine if r.generation == 2][:2]
        if not crossed or not after:
            raise AssertionError(f"replica {rid}: {len(crossed)} requests "
                                 f"crossed its swap, {len(after)} on "
                                 f"generation 2")
        old += crossed
        new += after
    model2 = model_from_tree(cfg, tree2, dev)
    ties = []
    for gen, group, weights in ((1, old, model), (2, new, model2)):
        reqs = [next(q for _, q in workload if q.request_id == r.request_id)
                for r in group]
        want = solo_tokens(cfg, weights, reqs, dev)
        ties += hold_tokens(cfg, weights, prompts,
                            {r.request_id: list(r.tokens) for r in group},
                            want, dev, f"phase 3l (b) generation {gen}")
    del model2
    phases = {rid: {k: v for k, v in eng.last_swap.items()
                    if k.endswith("_ms")}
              for rid, eng in engines.items() if eng.last_swap}
    p = {k: (round(_percentile(v, 0.5), 3), round(_percentile(v, 0.99), 3),
             len(v)) for k, v in step_ms.items()}
    tree_gb = sum(t.numel() * t.element_size() for t in tree1.values()) / 1e9
    log(card, f"phase 3l (b): generation 1 published ({tree_gb:.3f} GB, "
              f"bf16) and each of {P3L_REPLICAS} replicas booted through "
              f"load_initial in {boot_s:.2f} s; generation 2 (phase 3b's "
              f"trained weights in bf16) published after {P3L_PUBLISH_STEP} "
              f"router steps with requests in flight; canary "
              f"(pct {P3L_CANARY_PCT}, window {P3L_CANARY_WINDOW}; its "
              f"windows fed only the {len(canary.counted)} requests "
              f"submitted from router step {canary.settled_step}, once "
              f"every loader had finished and the canary replica decoded "
              f"generation 2 alone, {len(canary.skipped)} earlier results "
              f"left out): {verdict} {evidence}")
    keys = ("replica", "generation", "from_generation", "inflight")
    log(card, f"phase 3l (b): swaps {[{k: e[k] for k in keys} for e in swaps]}"
              f" at router steps {swap_step}; swap phases ms {phases}; "
              f"router step ms (p50, p99, steps) while a loader runs "
              f"{p['loading']}, before the publish {p['steady']}, with "
              f"two generations decoding (no loader) "
              f"{p['two_generations']}; device "
              f"memory allocated {mem['one_generation'] / 1e9:.3f} GB with "
              f"one generation, {mem['two_generations'] / 1e9:.3f} GB at "
              f"most with two resident")
    log(card, f"phase 3l (b): {len(results)} requests completed in {steps} "
              f"router steps, {wall:.3f} s; {len(old)} crossed a swap on "
              f"generation 1 and {len(new)} ran on generation 2, each equal "
              f"to its generation served alone (ties {ties}); prefill "
              f"launches by generation {by_gen}; every engine back to one "
              f"generation, no refusal, no KV block leaked")
    return {"verdict": verdict, "phases": phases, "step_ms": p,
            "memory": mem, "by_generation": by_gen,
            "settled_step": canary.settled_step}


def run_replica_loss(card, dev, cfg, model, workload, solo, launches):
    """Phase 3l (c): replica 1 of two declared lost with requests in
    flight (``Router.on_ranks_lost``, twice): its orphans are rerouted
    exactly once and complete on the survivor, their tokens equal to
    serving them alone. Then one SpawnReplicaRequest sent twice over
    ReplicaSupervisorClient, under a chaos rule that also duplicates its
    delivery: exactly one replica is spawned, and it serves. ``launches``
    takes the routed runs' flash launches."""
    from horovod_tpu_torch.router import Router
    from horovod_tpu_torch.run.elastic import (ReplicaSupervisorClient,
                                               ReplicaSupervisorService)
    from horovod_tpu_torch.utils import metrics
    reg = metrics.get_registry()

    def rerouted_total():
        fam = reg.snapshot()["metrics"].get("hvd_route_rerouted_total")
        return fam["values"][0]["value"] if fam and fam["values"] else 0

    engines = {rid: p3l_engine(cfg, model, dev)
               for rid in range(P3L_REPLICAS)}
    router = Router(engines, policy="round_robin")
    requests = [r for _, r in workload[:P3L_LOST_REQUESTS]]
    results = []
    with routed_launches(launches):
        for r in requests:
            if not router.submit(fresh(r)):
                raise AssertionError(f"{r.request_id} refused")
        for _ in range(P3L_LOST_AFTER):
            results.extend(router.step())
        orphans = sorted(q for q, rid in router.inflight.items() if rid == 1)
        if not orphans:
            raise AssertionError("replica 1 held no request when lost")
        before = rerouted_total()
        router.on_ranks_lost({1})
        router.on_ranks_lost({1})   # a second notice reroutes nothing
        results.extend(router.run_to_completion())
    by_id = {}
    for r in results:
        if r.request_id in by_id:
            raise AssertionError(f"{r.request_id} returned twice")
        by_id[r.request_id] = r
    if sorted(by_id) != sorted(r.request_id for r in requests):
        raise AssertionError(f"returned {sorted(by_id)}")
    for q in orphans:
        r = by_id[q]
        if (r.outcome, r.replica, r.rerouted) != ("completed", 0, True):
            raise AssertionError(f"orphan {q}: {r}")
    if rerouted_total() - before != len(orphans):
        raise AssertionError(f"rerouted {rerouted_total() - before}, "
                             f"orphans {orphans}")
    # the replica supervisor door under a chaos rule that duplicates the
    # spawn's delivery; the client sends the same change id twice more
    spawned = []

    def spawn():
        rid = P3L_REPLICAS + len(spawned)
        router.add_replica(rid, p3l_engine(cfg, model, dev))
        spawned.append(rid)
        return rid
    key = os.urandom(32)
    os.environ["HVD_CHAOS_SPEC"] = P3L_SPAWN_CHAOS
    try:
        svc = ReplicaSupervisorService(key, on_spawn=spawn)
    finally:
        del os.environ["HVD_CHAOS_SPEC"]
    try:
        client = ReplicaSupervisorClient(
            {"lo": [("127.0.0.1", svc.port)]}, key)
        first = client.spawn_replica("phase-3l-spawn")
        again = client.spawn_replica("phase-3l-spawn")
        client.close()
        injected = sum(svc._chaos.stats().values())
    finally:
        svc.shutdown()
    if not (first.ok and again.duplicate and spawned == [P3L_REPLICAS] and
            first.replica_id == again.replica_id == P3L_REPLICAS and
            injected >= 1):
        raise AssertionError(f"spawn: {vars(first)}, {vars(again)}, "
                             f"spawned {spawned}, chaos {injected}")
    if router.live_replicas() != [0, P3L_REPLICAS]:
        raise AssertionError(f"live {router.live_replicas()}")
    late = [r for _, r in workload[P3L_LOST_REQUESTS:P3L_LOST_REQUESTS + 2]]
    with routed_launches(launches):
        for r in late:
            router.submit(fresh(r))
        served = {r.request_id: r for r in router.run_to_completion()}
    if sorted(r.replica for r in served.values()) != [0, P3L_REPLICAS] or \
            any(list(served[r.request_id].tokens) != solo[r.request_id]
                for r in late):
        raise AssertionError(f"after the spawn: {served}")
    prompts = {r.request_id: r.prompt for r in requests}
    ties = hold_tokens(cfg, model, prompts,
                       {q: list(r.tokens) for q, r in by_id.items()},
                       {q: solo[q] for q in by_id}, dev, "phase 3l (c)")
    log(card, f"phase 3l (c): replica 1 lost after {P3L_LOST_AFTER} router "
              f"steps holding {len(orphans)} of {len(requests)} requests "
              f"{orphans}: rerouted exactly once (hvd_route_rerouted_total "
              f"+{len(orphans)}, a second loss notice rerouted nothing), all "
              f"completed on replica 0, tokens equal to each served alone "
              f"(ties {ties}); SpawnReplicaRequest sent twice under "
              f"{P3L_SPAWN_CHAOS!r} ({injected} injection): one replica "
              f"spawned (id {spawned[0]}), the repeat answered from the "
              f"ledger, and the new replica served a request")
    return {"orphans": orphans, "spawned": spawned}


def run_phase_3l(card, dev, trained):
    """Phase 3l, each part fatal: the routed arms, the fleet hot swap
    under a canary (``trained``: phase 3b's weights by name, generation
    2), a replica lost mid-stream and one spawned over RPC. Returns the
    flash launches of its routed runs alone (``routed_launches``), by
    part and in all. It runs after phase 4's timings, whose profiler
    readings it leaves alone: its loader and RPC threads touch the
    card."""
    t0 = time.perf_counter()
    os.makedirs(P3L_DIR, exist_ok=True)
    _planes(True, history_dir=os.path.join(P3L_DIR, "history"))
    cfg = p3l_cfg()
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    parts = {"a": {}, "b": {}, "c": {}}
    arms, workload, solo = run_routed_arms(card, dev, cfg, model,
                                           parts["a"])
    swap = run_fleet_swap(card, dev, cfg, model, trained, parts["b"])
    loss = run_replica_loss(card, dev, cfg, model, workload, solo,
                            parts["c"])
    launches = {}
    for part in parts.values():
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    if set(launches) != {"flash_fwd_online", "flash_fwd_lazy"} or \
            not all(parts.values()):
        raise AssertionError(f"phase 3l launched {parts}")
    _planes(False)
    del model
    torch.cuda.empty_cache()
    log(card, f"phase 3l: launches of the routed runs alone {launches} "
              f"((a) {parts['a']}, (b) {parts['b']}, (c) {parts['c']}; "
              f"prefills on both generations); "
              f"{time.perf_counter() - t0:.1f} s in all")
    return launches, {"arms": arms, "swap": swap, "loss": loss}


# ---------------------------------------------------------------------------
# phase 3m: Mixture-of-Experts on the 'ep' axis and the GPipe pipeline on
# 'pp': (a) gpt2_small_tpu with 8 experts trained on the card, its
# gradients against the plain path; (b) ep 2 through hvdrun and train_lm;
# (c) pp 2 through run(fn) and make_pipeline_step


MOE_EXPERTS = 8
MOE_STEPS = 10
MOE_WINDOW = 4          # ms/step: the best of the windows after 2 steps
EP_LAYERS, EP_STEPS = 4, 4
EP_ROWS = 2 * TRAIN_BATCH    # two ranks' rows of train_lm's --steps loop
PP_LAYERS, PP_MICRO, PP_STEPS = 4, 4, 3
P3M_RUN_S = 300
P3M_DIR = os.path.join(ROOT, "build", "phase3m")
# a leaf's update on 2 ranks against one process's, |d_got - d_want| over
# |d_want| in the 2-norm. Measured on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6): ep 2 0.179 (bf16 routing flips move tokens between
# experts), pp 2 0.0688; a stage that got no gradient reads 1.000 (a
# zeroed backward hop, at the tiny config on the CPU)
EP_GAP_MAX = 3 * 2 ** -3
PP_GAP_MAX = 2 ** -2


def moe_config(**kw):
    """The flagship (flash, tied, bf16 logits) with MOE_EXPERTS experts,
    top 2, capacity factor 1.25: ``train_lm --num-experts 8``'s model."""
    return train_lm.flagship_config(True, num_experts=MOE_EXPERTS, **kw)


def kernel_steps(layers, steps=1):
    """B2, B4 and B5 launches of ``steps`` steps over ``layers`` layers."""
    return {"flash_fwd_lazy": layers * steps,
            "flash_bwd_sm90_dq": layers * steps,
            "flash_bwd_sm90_dkv": layers * steps}


def update_gaps(got, want, init):
    """Per leaf name: (|d_got - d_want|_2 / |d_want|_2, max |d_got -
    d_want| / max |d_want|), with d the leaf's change from ``init``, in
    fp32 on the card. The first is held: AdamW moves an element whose
    gradient is rounding noise by about lr whatever its sign, so the
    second can read near 1 on an element of no weight."""
    gaps = {}
    for name, w in want.items():
        g = got[name].to(w.device, torch.float32)
        d_want = w.float() - init[name].float()
        diff = g - init[name].float() - d_want
        gaps[name] = ((diff.norm() / d_want.norm()).item(),
                      (diff.abs().max() / d_want.abs().max()).item())
    return gaps


def hold_gaps(gaps, what, bound):
    """Raise unless every leaf's update gap is finite and within
    ``bound``; returns the worst leaf of each measure."""
    worst = max(gaps, key=lambda n: gaps[n][0])
    worst_max = max(gaps, key=lambda n: gaps[n][1])
    bad = {n: v for n, v in gaps.items()
           if not (math.isfinite(v[0]) and v[0] <= bound)}
    if bad:
        raise AssertionError(f"{what}: updates off the reference's "
                             f"(2-norm gap, max gap): {bad}")
    return (f"every one of {len(gaps)} leaves' update within "
            f"{gaps[worst][0]:.3e} of the reference's in the 2-norm "
            f"(worst {worst}; bound {bound:g}), largest element "
            f"gap / largest update {gaps[worst_max][1]:.3e} ({worst_max})")


def train_moe(card, dev):
    """Phase 3m (a): MOE_STEPS steps of the MoE flagship on one repeated
    batch (b16 x s1024) through train_lm.build_transformer_step (fp32
    masters, DistributedOptimizer(AdamW(3e-4, mu bf16))); 12+12+12
    launches a step, the loss finite and falling. Returns (launches, batch)."""
    from horovod_tpu_torch.models import moe
    cfg = moe_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, opt, _, toks = train_lm.build_transformer_step(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev)
    batch = toks[0]
    n_params = sum(p.numel() for p in model.parameters())
    step = trainer.make_train_step(model, opt, tr.lm_loss_fn(model))
    per_step = kernel_steps(cfg.num_layers)
    losses, step_s = [], []
    fa.reset_launch_counts()
    for i in range(MOE_STEPS):
        before = dict(fa.launch_counts)
        t0 = time.perf_counter()
        losses.append(step(batch).item())     # the sync point
        step_s.append(time.perf_counter() - t0)
        got = {k: v - before.get(k, 0) for k, v in fa.launch_counts.items()}
        if got != per_step:
            raise AssertionError(f"MoE step {i} launched {got}, expected "
                                 f"{per_step}")
    launches = dict(fa.launch_counts)
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"MoE training losses {losses}")
    peak = torch.cuda.max_memory_allocated() - base
    windows = [sum(step_s[i:i + MOE_WINDOW]) / MOE_WINDOW
               for i in range(2, MOE_STEPS - MOE_WINDOW + 1, MOE_WINDOW)]
    best = min(windows)
    # where a step's device time goes: two more steps, the second traced
    by_op = device_by_op(lambda: step(batch))
    device = sum(ms for _, ms in by_op)
    cap = moe.capacity_of(cfg, TRAIN_SEQ)
    log(card, f"phase 3m (a): trained gpt2_small_tpu with {MOE_EXPERTS} "
              f"experts top {cfg.num_experts_per_tok}, capacity "
              f"{cap} a row (cf {cfg.expert_capacity_factor}), "
              f"{n_params / 1e6:.1f} M parameters (flash, tied, bf16 "
              f"logits, fp32 masters, AdamW mu bf16) at batch {TRAIN_BATCH} "
              f"x seq {TRAIN_SEQ} for {MOE_STEPS} steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({[round(x, 4) for x in losses]}); launches {launches} "
              f"({per_step} every step); ms/step by window of "
              f"{MOE_WINDOW} after 2 steps "
              f"{[round(w * 1e3, 3) for w in windows]}, best "
              f"{best * 1e3:.3f} ({TRAIN_BATCH * TRAIN_SEQ / best:.0f} "
              f"tokens/s); peak memory {peak / 1e9:.2f} GB above the "
              f"{base / 1e9:.2f} GB held before")
    log(card, f"phase 3m (a): one more MoE step traced: {device:.3f} device "
              f"ms (busy {device / (best * 1e3):.1%} of the best window's "
              f"step); by aten operator, largest first: "
              + "; ".join(f"{k} {v:.3f}" for k, v in by_op[:10]))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches, batch


def check_moe_grads(card, dev, batch):
    """Phase 3m (a): one MoE step at batch 2 on the kernel path against the
    plain path (every launch replaced by its plain version): at fp32 the
    gradients within 1e-4 of each gradient's largest magnitude; at bf16
    the losses within 2^-6 relative. Both print how many of the b·s·k
    routing decisions differ between the two paths (a near tie in the
    router flips with one rounding of an attention output). The bf16
    kernels this path launches (B2, B4, B5 on wgmma) are held at the
    training shape by phase 2 and by phase 3b's batch-2 gradients; the
    fp32 check here runs the CUDA-core kernels."""
    from horovod_tpu_torch.models import moe
    for dtype in (torch.float32, torch.bfloat16):
        cfg = moe_config(dtype=dtype)
        # drawn on the device: 746.5 M draws on the host take seconds
        model = tr.init_params(cfg, torch.Generator(dev).manual_seed(1),
                               device=dev, train=True)
        loss_fn = tr.lm_loss_fn(model)
        routes = []

        def keep(module, inputs, logits):
            routes.append(moe.top_k(torch.softmax(logits, dim=-1),
                                    cfg.num_experts_per_tok)[1])
        hooks = [b.mlp.router.register_forward_hook(keep)
                 for b in model.layers]

        def grads():
            routes.clear()
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch[:2])
            loss.backward()
            return loss.item(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()}, \
                list(routes)
        try:
            got_loss, got, got_routes = grads()
            with plain_path():
                want_loss, want, want_routes = grads()
        finally:
            for h in hooks:
                h.remove()
        flips = sum(int((a != b).sum()) for a, b in zip(got_routes,
                                                         want_routes))
        total = sum(a.numel() for a in got_routes)
        worst = 0.0
        for name, w in want.items():
            if not torch.isfinite(got[name]).all():
                raise AssertionError(f"{dtype} MoE grad {name} not finite")
            scale = w.abs().max().item()
            worst = max(worst, (got[name] - w).abs().max().item() / scale)
        rel = abs(got_loss - want_loss) / abs(want_loss)
        if dtype == torch.float32 and worst > 1e-4:
            raise AssertionError(f"fp32 MoE grads: largest |diff| / max "
                                 f"{worst:.3e} > 1e-4 ({flips} of {total} "
                                 f"routing decisions differ)")
        if rel > (1e-4 if dtype == torch.float32 else 2 ** -6):
            raise AssertionError(f"{dtype} MoE loss {got_loss} vs plain "
                                 f"{want_loss}")
        log(card, f"phase 3m (a): {dtype} MoE batch-2 step, kernel vs plain "
                  f"path: loss {got_loss:.6f} vs {want_loss:.6f} (relative "
                  f"{rel:.3e}); largest grad |diff| / that grad's max "
                  f"|value| {worst:.3e} over {len(want)} parameters; "
                  f"{flips} of {total} routing decisions differ")
        del model, got, want
        gc.collect()
        torch.cuda.empty_cache()


def run_moe_ep(card, dev):
    """Phase 3m (b): hvdrun -np 2 on the one card, train_lm --device cuda
    --num-experts 8 --ep 2 --num-layers EP_LAYERS --steps EP_STEPS
    --checkpoint-dir (the flagship's width, the experts split over the two
    ranks, both ranks routing the same EP_ROWS rows, the state saved after
    the last step); the losses equal on both ranks and within 2^-8 of the
    same config at ep 1 in this process on the same batches; the saved
    state's every leaf (each expert stack gathered whole over 'ep' by the
    save) moved from the seeded init within EP_GAP_MAX of the ep-1 run's
    update (``update_gaps``); EP_LAYERS+EP_LAYERS+EP_LAYERS launches a
    step per rank. The ep-1 reference runs here while the ranks start;
    ms/step counts only the steps that began after it ended."""
    import shutil
    from horovod_tpu_torch.parallel import tensor_parallel as tpl
    from horovod_tpu_torch.utils import checkpoint as tckpt
    ckpt = os.path.join(P3M_DIR, "ep2-ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["horovod_tpu_torch.run", "-np", "2", "-H", "localhost:2",
            sys.executable, "-m", "horovod_tpu_torch.train_lm", "--device",
            dev.type, "--num-experts", str(MOE_EXPERTS), "--ep", "2",
            "--num-layers", str(EP_LAYERS), "--steps", str(EP_STEPS),
            "--checkpoint-dir", ckpt, "--checkpoint-every", str(EP_STEPS)]
    want, ref_ms, ref = [], [], {}

    def reference():
        """The same config at ep 1 here, on the same rows of the same
        batches, while the ranks start."""
        cfg = dataclasses.replace(moe_config(), num_layers=EP_LAYERS)
        mesh = mesh_lib.build_mesh(dp=1)
        model, opt, step, _ = train_lm.build_gspmd_step(
            cfg, EP_ROWS, TRAIN_SEQ, 1, dev, mesh)
        ref["init"] = {n: tpl.local(p).detach().clone()
                       for n, p in model.named_parameters()}
        for i in range(EP_STEPS):
            toks = train_lm.batch_at(0, i, cfg.vocab_size, EP_ROWS,
                                     TRAIN_SEQ).to(dev)
            t1 = time.perf_counter()
            want.append(step(model, opt, toks)[2].item())
            ref_ms.append((time.perf_counter() - t1) * 1e3)
        ref["params"] = {n: tpl.local(p).detach()
                         for n, p in model.named_parameters()}
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        ref["free_at"] = time.time()
    t0 = time.perf_counter()
    events = _module_run(args, dict(os.environ), P3M_RUN_S, "moe-ep2",
                         meanwhile=reference)
    wall = time.perf_counter() - t0
    done = sorted((e for e in events if e.get("event") == "done"),
                  key=lambda e: e["rank"])
    if [e["rank"] for e in done] != [0, 1]:
        raise AssertionError(f"ep 2: done events {done}")
    if done[0]["losses"] != done[1]["losses"]:
        raise AssertionError(f"ep 2 ranks' losses differ: "
                             f"{[e['losses'] for e in done]}")
    want_launches = kernel_steps(EP_LAYERS, EP_STEPS)
    for e in done:
        if e["launches"] != want_launches:
            raise AssertionError(f"ep 2 rank {e['rank']} launched "
                                 f"{e['launches']}, expected "
                                 f"{want_launches}")
    got = done[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not all(map(math.isfinite, got)) or max(rel) > 2 ** -8:
        raise AssertionError(f"ep 2 losses {got} vs ep 1 {want}")
    if tckpt.latest_step(ckpt) != EP_STEPS or \
            tckpt.saved_layout(ckpt, EP_STEPS)["ep"] != 2:
        raise AssertionError(f"ep 2: no step-{EP_STEPS} save of the ep-2 "
                             f"layout in {ckpt}")
    flat, _ = tckpt.restore(ckpt, step=EP_STEPS)
    saved = {k[len("['params']['"):-2]: v for k, v in flat.items()
             if k.startswith("['params']")}
    del flat
    if sorted(saved) != sorted(ref["params"]):
        raise AssertionError(f"ep 2 saved leaves {sorted(saved)}")
    gaps = hold_gaps(update_gaps(saved, ref["params"], ref["init"]),
                     f"ep 2 after {EP_STEPS} steps", EP_GAP_MAX)
    del saved, ref["params"], ref["init"]
    shutil.rmtree(ckpt, ignore_errors=True)
    # rank 0's step events carry the time each step's loss was read; a
    # step counts when it began after this process's reference ended
    t = sorted((e["step"], e["t"]) for e in events
               if e.get("event") == "step")
    ep_ms = [(b - a) * 1e3 for (_, a), (_, b) in zip(t, t[1:])]
    clean = [(b - a) * 1e3 for (_, a), (_, b) in zip(t, t[1:])
             if a >= ref["free_at"]]
    start = [e["t"] for e in events if e.get("event") == "start"]
    log(card, f"phase 3m (b): hvdrun -np 2, train_lm --num-experts "
              f"{MOE_EXPERTS} --ep 2 --num-layers {EP_LAYERS} --steps "
              f"{EP_STEPS} --checkpoint-dir on one card (gloo between two "
              f"processes on one card: not an interconnect figure), "
              f"{EP_ROWS} x {TRAIN_SEQ} rows a step on both ranks, "
              f"{MOE_EXPERTS // 2} experts each: losses "
              f"{[round(v, 6) for v in got]} equal on both ranks, largest "
              f"relative difference from ep 1 in this process "
              f"{max(rel):.3e} (bound 2^-8); the step-{EP_STEPS} save "
              f"(ep-2 layout), {gaps}; ms/step after the first on rank 0 "
              f"{[round(v, 1) for v in ep_ms]}, of them begun after this "
              f"process's reference ended {[round(v, 1) for v in clean]} "
              f"(the reference ended {ref['free_at'] - min(start):+.1f} s "
              f"from the ranks' loop start, their first step's loss read "
              f"at {t[0][1] - min(start):+.1f} s; the loop's mean "
              f"with the first {done[0]['ms_per_step']:.1f}), ep 1 here "
              f"{[round(v, 1) for v in ref_ms[1:]]} (first "
              f"{ref_ms[0]:.1f}); launches {done[0]['launches']} per "
              f"rank; {wall:.1f} s wall")
    return done[0]["launches"]


def pipeline_config(**kw):
    """Untied gpt2_small_tpu (flash, bf16 logits) at depth PP_LAYERS: the
    pipeline keeps the embedding on stage 0 and the head on the last."""
    return dataclasses.replace(
        train_lm.flagship_config(True, tie_embeddings=False, **kw),
        num_layers=PP_LAYERS)


def pipeline_batches(cfg):
    """PP_STEPS batches of TRAIN_BATCH rows of TRAIN_SEQ + 1 tokens (the
    inputs and their shifted targets)."""
    return [train_lm.batch_at(0, i, cfg.vocab_size, TRAIN_BATCH,
                              TRAIN_SEQ + 1)[0] for i in range(PP_STEPS)]


def _p3m_pipe_job():
    """run(fn)'s worker of phase 3m (c): the pipeline step of ``cfg`` on a
    pp-2 mesh over ``batches``, ``micro`` microbatches, on ``device``
    ("cuda", or "cpu" for a rehearsal). After the first step it waits for
    the file ``go`` (the caller's own work on the card is done), so the
    steps it times share the card with nothing else; at the end each rank
    saves its leaves' local values (its stage's layers, the replicated
    rest) to ``out_dir``/pp-rank<r>.pt."""
    def fn(cfg, batches, micro, device, go, out_dir):
        import os
        import time
        import torch
        import torch.distributed as dist
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import optim
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.models import transformer as tr
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.parallel import mesh as mesh_lib
        from horovod_tpu_torch.parallel import pipeline as pl
        from horovod_tpu_torch.parallel import tensor_parallel as tpl
        hvd.init(device=device)
        dev = state.device()
        on_card = dev.type == "cuda"
        model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev, train=True)
        whole = pl.stack_pipeline_params(model, cfg.num_layers)
        del model
        mesh = mesh_lib.build_mesh(pp=2)
        placed = pl.place_pipeline_params(whole, mesh_lib.tree_shardings(
            pl.pipeline_param_specs(whole), mesh))
        del whole
        opt = optim.AdamW(pl.pipeline_leaves(placed), 3e-4,
                          mu_dtype=torch.bfloat16)
        step, _, _ = pl.make_pipeline_step(cfg, opt, mesh, micro, placed)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        losses, step_ms, launches, waited = [], [], [], 0.0
        for i, toks in enumerate(batches):
            if i == 1:
                t0 = time.perf_counter()
                while not os.path.exists(go):
                    if time.perf_counter() - t0 > 600:
                        raise RuntimeError(f"no {go} in 600 s")
                    time.sleep(0.01)
                waited = time.perf_counter() - t0
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            placed, opt, loss = step(placed, opt, toks.to(dev))
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(fa.launch_counts))
        torch.save({"layers": {n: tpl.local(t).detach().cpu()
                               for n, t in placed["layers"].items()},
                    "rest": {n: tpl.local(t).detach().cpu()
                             for n, t in placed.items() if n != "layers"}},
                   os.path.join(out_dir, f"pp-rank{hvd.rank()}.pt"))
        out = {"rank": hvd.rank(), "losses": losses, "step_ms": step_ms,
               "launches": launches, "backend": dist.get_backend(),
               "stage": mesh.coordinate("pp"), "waited_s": waited,
               "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if on_card else 0.0)}
        mesh_lib.reset_global_mesh()
        hvd.shutdown()
        return out
    return fn


def run_pipeline(card, dev, meanwhile=None):
    """Phase 3m (c): run(fn, num_proc=2) on the one card,
    make_pipeline_step on a pp-2 mesh (gloo between the two processes; the
    hop stages the activation through host memory), untied gpt2_small_tpu
    at depth PP_LAYERS, PP_MICRO microbatches of b16 x s1024, AdamW,
    PP_STEPS steps; the losses equal on both ranks and within 2^-8 of the
    unpipelined GSPMD step in this process on the same batches; after the
    steps every leaf's update (both stages' layers, the embedding, final
    norm and head, the same on both ranks) within PP_GAP_MAX of the
    unpipelined step's (``update_gaps``): a lost or zeroed cotangent on
    the backward hop leaves stage 0 and the embedding unmoved; per rank
    and step (M + P - 1) · L / P launches of each of B2, B4, B5. The
    unpipelined reference, and ``meanwhile()`` before it, run here while
    the ranks start; they time their steps after the first only once both
    are done."""
    import shutil
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.parallel import tensor_parallel as tpl
    from horovod_tpu_torch.run.launch import run
    import torch.nn.functional as F
    cfg = pipeline_config()
    batches = pipeline_batches(cfg)
    shutil.rmtree(P3M_DIR, ignore_errors=True)
    os.makedirs(P3M_DIR)
    go = os.path.join(P3M_DIR, "pp-go")
    ranks = {}

    def launch():
        try:
            ranks["res"] = run(_p3m_pipe_job(),
                               args=(cfg, batches, PP_MICRO, dev.type, go,
                                     P3M_DIR),
                               num_proc=2, start_timeout_s=P3M_RUN_S)
        except BaseException as exc:  # noqa: BLE001 — raised below
            ranks["error"] = exc
    t0 = time.perf_counter()
    launcher = threading.Thread(target=launch, daemon=True)
    launcher.start()
    if meanwhile is not None:
        meanwhile()
    # while the ranks start: the unpipelined GSPMD step on a one-card
    # mesh, the same weights, optimizer, loss (the shifted split, logits
    # as the last stage takes them) and batches
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev, train=True)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh = mesh_lib.build_mesh(dp=1)
    specs = tr.param_specs(model)
    trainer.place(model, mesh, specs)
    opt = optim.AdamW(model.parameters(), 3e-4, mu_dtype=torch.bfloat16)
    trainer.init_opt_state(opt, model)

    def loss_fn(m, toks):
        toks = toks.to_local()
        hidden, head = m.hidden_and_head(toks[:, :-1])
        logits = F.linear(hidden.to(cfg.dtype), head.to(cfg.dtype)).float()
        return trainer.softmax_cross_entropy(logits, toks[:, 1:])
    step, _, _ = trainer.make_gspmd_step(loss_fn, opt, mesh, specs,
                                         mesh_lib.P("dp", None))
    want = [step(model, opt, t.to(dev))[2].item() for t in batches]
    want_params = {n: tpl.local(p).detach()
                   for n, p in model.named_parameters()}
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    open(go, "w").close()
    launcher.join(P3M_RUN_S + 60)
    if "error" in ranks or "res" not in ranks:
        raise AssertionError(f"pp 2 ranks: {ranks.get('error')!r}")
    res = ranks["res"]
    wall = time.perf_counter() - t0
    saved = [torch.load(os.path.join(P3M_DIR, f"pp-rank{r}.pt"))
             for r in range(2)]
    for n, t in saved[0]["rest"].items():
        if not torch.equal(t, saved[1]["rest"][n]):
            raise AssertionError(f"pp 2: {n} differs between the ranks")
    got_params = dict(saved[0]["rest"])
    per_stage = PP_LAYERS // 2
    for r, rank_leaves in enumerate(saved):
        for n, t in rank_leaves["layers"].items():
            for j in range(per_stage):
                got_params[f"layers.{r * per_stage + j}.{n}"] = t[j]
    if sorted(got_params) != sorted(want_params):
        raise AssertionError(f"pp 2 leaves {sorted(got_params)}")
    gaps = hold_gaps(update_gaps(got_params, want_params, init),
                     "pp 2 after the steps", PP_GAP_MAX)
    del saved, got_params, want_params, init
    ticks = PP_MICRO + 2 - 1
    per_step = kernel_steps(ticks * PP_LAYERS // 2)
    for r in res:
        if any(got != per_step for got in r["launches"]):
            raise AssertionError(f"pp 2 rank {r['rank']} launched "
                                 f"{r['launches']}, expected {per_step} a "
                                 f"step")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError(f"pp 2 ranks' losses differ: "
                             f"{[r['losses'] for r in res]}")
    got = res[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not all(map(math.isfinite, got)) or max(rel) > 2 ** -8:
        raise AssertionError(f"pp 2 losses {got} vs unpipelined {want}")
    best = min(min(r["step_ms"][1:]) for r in res)
    log(card, f"phase 3m (c): run(fn, num_proc=2), make_pipeline_step on "
              f"pp 2 ({res[0]['backend']} between two processes on one "
              f"card, the hop through host memory: not an interconnect "
              f"figure), untied gpt2_small_tpu depth {PP_LAYERS}, "
              f"{PP_MICRO} microbatches of {TRAIN_BATCH // PP_MICRO} x "
              f"{TRAIN_SEQ}, {PP_STEPS} AdamW steps: losses "
              f"{[round(v, 6) for v in got]} equal on both ranks, largest "
              f"relative difference from the unpipelined GSPMD step "
              f"{max(rel):.3e} (bound 2^-8); embedding, final norm and "
              f"head bit-equal on both ranks, {gaps}; ms/step by rank "
              f"{[[round(v, 1) for v in r['step_ms']] for r in res]} "
              f"(best after the first {best:.1f}; the steps after the "
              f"first alone on the card, the ranks having waited "
              f"{[round(r['waited_s'], 1) for r in res]} s for this "
              f"process's reference to end); launches per rank "
              f"{per_step} a step (bubble {1 / ticks:.2f} of the ticks"
              f" a stage computes); peak memory by rank "
              f"{[round(r['peak_gb'], 2) for r in res]} GB; {wall:.1f} s "
              f"wall")
    return {k: v * PP_STEPS for k, v in per_step.items()}


def run_phase_3m(card, dev):
    """Phase 3m, each part fatal; returns the launches of its paths (the
    MoE steps of (a), rank 0's of (b) and (c))."""
    t0 = time.perf_counter()
    launches = {}
    moe_launches, batch = train_moe(card, dev)
    ep_launches = run_moe_ep(card, dev)
    # (a)'s gradient check runs while (c)'s ranks start
    pp_launches = run_pipeline(card, dev, meanwhile=lambda: check_moe_grads(
        card, dev, batch))
    for part in (moe_launches, ep_launches, pp_launches):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    log(card, f"phase 3m: launches of its paths {launches}; "
              f"{time.perf_counter() - t0:.1f} s in all")
    return launches


# ---------------------------------------------------------------------------
# phase 3n: the numerics sentinel, the memory and compile plane, the H100
# cost model, device-trace attribution and the autotuner on the flagship
# eager step (gpt2_small_tpu, flash, tied, bf16 logits, b16 x s1024) at
# world 1 over NCCL: (a) the autotuner, (b) numerics, (d) the memory
# plane, (e) instrument_step and one merged timeline. (c), two ranks,
# rides phase 3k (b)'s launch; (f), the planes' overhead, is phase 3k
# (a)'s on/off windows with the numerics and memory planes in "on".


P3N_DIR = os.path.join(ROOT, "build", "phase3n")
P3N_WINDOW = 5                 # steps a timing window
P3N_TUNE_WINDOWS = 5           # scored windows the tuner must reach
P3N_CYCLES, P3N_SAMPLES = 2, 2  # flushes a sample, samples a scored window
P3N_TUNE_MAX_STEPS = 120
P3N_PARITY_STEPS = 3
P3N_NANS = 3
P3N_ATTRIB_EVERY, P3N_ATTRIB_STEPS = 5, 10
P3N_GATE_WINDOW = 10           # steps a window of the numerics gate
P3N_GATE_ROUNDS = 3            # the cap on its rounds (bench.py's)
P3N_GATE_BUDGET = 2.0          # % (the reference's contract)
P3N_BREAKDOWN_TOL = 0.10       # the classes' sum against the profiler's
P3N_OTHER_MAX = 0.10           # the largest share "other" may take
P3N_CLOCK_US = 2.0             # the live profiler's clock against the trace's


def _eager_flagship(dev, inner=P3N_WINDOW, seed=0):
    return trainer.build_eager_lm_step(
        train_lm.flagship_config(True), TRAIN_BATCH, TRAIN_SEQ, dev,
        inner=inner, seed=seed)


def _window_ms(step, toks, n=P3N_WINDOW):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        loss = step(toks[i % toks.shape[0]])
    loss.item()
    return (time.perf_counter() - t0) / n * 1e3


def _log_rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().splitlines()


def check_autotune_world1(card, dev):
    """Phase 3n (a): HOROVOD_AUTOTUNE with a log on the live world-1 core
    (init parsed the knobs at phase 3b; the core builds its tuner from
    them), the flagship eager step driven until the tuner has scored
    P3N_TUNE_WINDOWS windows of P3N_CYCLES x P3N_SAMPLES flushes; the
    log's rows well formed, the adopted threshold and cycle inside the
    bounds; ms/step before and after adoption; fp32 masters after
    P3N_PARITY_STEPS steps with the tuner moving the knobs bit-equal to a
    run without it at the threshold it ended on. Returns the tuning run's
    launches."""
    from horovod_tpu_torch.common import state
    from horovod_tpu_torch.utils import autotune
    t0 = time.perf_counter()
    coord = state.global_state().coordinator
    cfg = state.global_state().config
    default = (cfg.fusion_threshold, cfg.cycle_time_ms)
    log_path = os.path.join(P3N_DIR, "autotune.csv")
    if os.path.exists(log_path):
        os.remove(log_path)
    step, model, _, toks = _eager_flagship(dev)
    step(toks[0]).item()
    before = [_window_ms(step, toks) for _ in range(2)]
    saved = (autotune.CYCLES_PER_SAMPLE, autotune.SAMPLES_PER_STEP)

    def tune(log_file):
        cfg.autotune, cfg.autotune_log = True, log_file or ""
        coord._init_autotune()
    try:
        autotune.CYCLES_PER_SAMPLE = P3N_CYCLES
        autotune.SAMPLES_PER_STEP = P3N_SAMPLES
        tune(log_path)
        fa.reset_launch_counts()
        n = 0
        while len(_log_rows(log_path)) < 1 + P3N_TUNE_WINDOWS and \
                n < P3N_TUNE_MAX_STEPS:
            loss = step(toks[n % toks.shape[0]])
            n += 1
        loss.item()
        launches = dict(fa.launch_counts)
        best = coord.freeze_autotune()
        coord.autotuner.close()
        adopted = (cfg.fusion_threshold, cfg.cycle_time_ms)
        after = [_window_ms(step, toks) for _ in range(2)]
        rows = _log_rows(log_path)
        if len(rows) < 1 + P3N_TUNE_WINDOWS or best is None or \
                rows[0] != "threshold_bytes,cycle_time_ms,score_bytes_per_us":
            raise AssertionError(f"phase 3n (a): {len(rows) - 1} scored "
                                 f"windows in {n} steps, best {best}")
        for row in rows[1:]:
            thr, ct, score = (float(v) for v in row.split(","))
            if not (autotune.THRESHOLD_BOUNDS[0] <= thr <=
                    autotune.THRESHOLD_BOUNDS[1] and
                    autotune.CYCLE_BOUNDS_MS[0] <= ct <=
                    autotune.CYCLE_BOUNDS_MS[1] and score > 0):
                raise AssertionError(f"phase 3n (a): log row {row}")
        if not (autotune.THRESHOLD_BOUNDS[0] <= adopted[0] <=
                autotune.THRESHOLD_BOUNDS[1] and
                autotune.CYCLE_BOUNDS_MS[0] <= adopted[1] <=
                autotune.CYCLE_BOUNDS_MS[1]):
            raise AssertionError(f"phase 3n (a): adopted {adopted}")
        del step, model, toks
        # the tuner changes the schedule, not the math: a fresh tuner that
        # moves the knobs every flush, against no tuner at the threshold
        # it ended on
        autotune.CYCLES_PER_SAMPLE = autotune.SAMPLES_PER_STEP = 1
        cfg.fusion_threshold, cfg.cycle_time_ms = default
        tune(None)
        step_a, model_a, _, toks_a = _eager_flagship(
            dev, inner=P3N_PARITY_STEPS)
        knobs = set()
        for i in range(P3N_PARITY_STEPS):
            step_a(toks_a[i])
            knobs.add((cfg.fusion_threshold, round(cfg.cycle_time_ms, 3)))
        torch.cuda.synchronize()
        ended = cfg.fusion_threshold
        coord.autotuner = None
        cfg.autotune = False
        cfg.fusion_threshold, cfg.cycle_time_ms = ended, default[1]
        step_b, model_b, _, _ = _eager_flagship(dev,
                                                inner=P3N_PARITY_STEPS)
        for i in range(P3N_PARITY_STEPS):
            step_b(toks_a[i])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in
                   zip(model_a.parameters(), model_b.parameters()))
        if not same:
            raise AssertionError("phase 3n (a): masters with the tuner "
                                 "differ from the run without it")
    finally:
        autotune.CYCLES_PER_SAMPLE, autotune.SAMPLES_PER_STEP = saved
        coord.autotuner = None
        cfg.autotune, cfg.autotune_log = False, ""
        cfg.fusion_threshold, cfg.cycle_time_ms = default
        coord._init_autotune()
    log(card, f"phase 3n (a): HOROVOD_AUTOTUNE=1 on the flagship eager step "
              f"(world 1 over NCCL): {len(rows) - 1} scored windows of "
              f"{P3N_CYCLES} x {P3N_SAMPLES} flushes in {n} steps, log rows "
              f"(threshold bytes, cycle ms, bytes/us) {rows[1:]}; adopted "
              f"(threshold, cycle ms) {adopted} (best {best}, inside "
              f"{autotune.THRESHOLD_BOUNDS} x {autotune.CYCLE_BOUNDS_MS}); "
              f"ms/step (windows of {P3N_WINDOW}) before "
              f"{[round(w, 3) for w in before]}, after adoption "
              f"{[round(w, 3) for w in after]} (best {min(before):.3f} -> "
              f"{min(after):.3f}); fp32 masters after {P3N_PARITY_STEPS} "
              f"steps with a tuner moving the knobs ({sorted(knobs)}) "
              f"bit-equal to a run without it at threshold {ended}; "
              f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    del step_a, model_a, step_b, model_b
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _counter(reg, name, **labels):
    fam = reg.snapshot()["metrics"].get(name, {"values": []})
    return sum(v["value"] for v in fam["values"]
               if all(v["labels"].get(k) == lv for k, lv in labels.items()))


def _p3n_alerts(names=None, **knobs):
    """A fresh alert manager ticking on demand over the stock rules (those
    of ``names``, else all), built with their breaches firing at once
    (HOROVOD_ALERT_FOR_S=0) and with ``knobs`` (HOROVOD_ALERT_<KEY>)
    set."""
    from horovod_tpu_torch.utils import alerts, history
    os.makedirs(os.path.join(P3N_DIR, "incidents"), exist_ok=True)
    env = {"HOROVOD_ALERT_FOR_S": "0"}
    env.update({f"HOROVOD_ALERT_{k.upper()}": str(v)
                for k, v in knobs.items()})
    os.environ.update(env)
    try:
        rules = [r for r in alerts.default_rules()
                 if names is None or r.name in names]
        return alerts.reset(enabled=True, interval_s=0.0, rules=rules,
                            incident_dir=os.path.join(P3N_DIR, "incidents"),
                            history_writer=history.NullHistoryWriter())
    finally:
        for k in env:
            del os.environ[k]


def check_numerics_world1(card, dev):
    """Phase 3n (b): clean flagship eager steps flag no anomaly; a
    gradient hook on the final norm's scale makes its gradient hold
    exactly P3N_NANS NaNs: hvd_nonfinite_total rises by that many on each
    side (one rank's reduced copy is its contribution, as in the JAX
    core), one numerics_anomaly event, one flight dump, and the
    nonfinite alert rule fires on its next tick."""
    import shutil
    from horovod_tpu_torch.utils import alerts, metrics, numerics, tracing
    t0 = time.perf_counter()
    flight = os.path.join(P3N_DIR, "flight")
    shutil.rmtree(flight, ignore_errors=True)
    os.environ["HVD_FLIGHT_DIR"] = flight
    reg = metrics.reset(enabled=True)
    tracing.reset(enabled=True)
    mon = numerics.reset(enabled=True)
    mgr = _p3n_alerts()
    try:
        step, model, _, toks = _eager_flagship(dev, inner=4)
        for i in range(3):
            loss = step(toks[i])
        loss.item()
        mon.drain()
        clean = [e for e in reg.events() if e["event"] == "numerics_anomaly"]
        if clean or _counter(reg, "hvd_numerics_anomalies_total"):
            raise AssertionError(f"phase 3n (b): clean steps flagged {clean}")
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        idx = names.index("ln_f.scale")
        grad_name = f"hvd.eager_grads.{idx}"
        param = dict(model.named_parameters())["ln_f.scale"]
        n_el = param.numel()
        where = torch.tensor([1, n_el // 2, n_el - 2], device=dev)

        def plant(g):
            return g.index_fill(0, where, float("nan"))
        mgr.tick(0.0)
        hook = param.register_hook(plant)
        step(toks[3]).item()
        hook.remove()
        mon.drain()
        local = _counter(reg, "hvd_nonfinite_total", tensor=grad_name,
                         where="local")
        reduced = _counter(reg, "hvd_nonfinite_total", tensor=grad_name,
                           where="reduced")
        others = _counter(reg, "hvd_nonfinite_total") - local - reduced
        evs = [e for e in reg.events() if e["event"] == "numerics_anomaly"]
        dumps = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
        reason = None
        if dumps == ["flight-rank0.json"]:
            with open(os.path.join(flight, dumps[0])) as f:
                reason = json.load(f)["reason"]
        # the firing alert dumps the flight recorder again, after the check
        for now in (1.0, 2.0):
            mgr.tick(now)
        firing = mgr.firing()
        if (local, reduced, others) != (P3N_NANS, P3N_NANS, 0) or \
                len(evs) != 1 or evs[0]["tensor"] != grad_name or \
                reason != "numerics_anomaly" or \
                "nonfinite_burst" not in firing:
            raise AssertionError(
                f"phase 3n (b): nonfinite local {local}, reduced {reduced}, "
                f"elsewhere {others}; events {evs}; dumps {dumps} (reason "
                f"{reason}); firing {firing}")
    finally:
        del os.environ["HVD_FLIGHT_DIR"]
        alerts.reset(enabled=False)
    log(card, f"phase 3n (b): 3 clean flagship eager steps: no anomaly "
              f"(hvd_numerics_tensors_observed_total "
              f"{_counter(reg, 'hvd_numerics_tensors_observed_total'):.0f});"
              f" {P3N_NANS} NaNs planted in {grad_name} (ln_f.scale) by a "
              f"gradient hook: hvd_nonfinite_total local {local:.0f}, "
              f"reduced {reduced:.0f}, elsewhere {others:.0f}; one "
              f"numerics_anomaly event {evs[0]['anomaly']!r}; flight dumps "
              f"{dumps} (reason {reason!r}); alerts firing on the next tick "
              f"{firing}; {time.perf_counter() - t0:.1f} s")
    del step, model, toks
    gc.collect()
    torch.cuda.empty_cache()


def check_numerics_cost(card, dev, stats_fn=None, reps=5, label="kernel"):
    """Phase 3n (b): the numerics plane's cost on the flagship's
    gradients, split: the stats' device ms a step (``segment_stats`` over
    each fusion bucket, the 86 gradients laid out in buckets of the
    default 64 MiB threshold, by CUDA events, median of ``reps``), the
    host ms to queue them, the scratch bytes above the buffers (allocator
    peak), and the host ms of the policy (``ingest`` of the 86 rows);
    ``stats_fn`` (the stats kernel's wrapper by default) names what is
    timed, ``label`` what the line calls it. The plane's step overhead is
    the gate's (``check_numerics_gate``) and phase 3k (f)'s on/off
    windows. Returns the four figures and the bytes a step reads."""
    from horovod_tpu_torch.utils import numerics
    stats_fn = stats_fn or numerics.segment_stats
    buckets = flagship_buckets()
    sizes = [n for b in buckets for n in b]
    gen = torch.Generator(device=dev).manual_seed(0)
    flats = [torch.randn(sum(b), generator=gen, device=dev) for b in buckets]
    for fl, b in zip(flats, buckets):
        stats_fn(fl, b)
    torch.cuda.synchronize()
    device_ms, host_ms = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        h0 = time.perf_counter()
        mats = [stats_fn(fl, b) for fl, b in zip(flats, buckets)]
        host_ms.append((time.perf_counter() - h0) * 1e3)
        ev[1].record()
        ev[1].synchronize()
        device_ms.append(ev[0].elapsed_time(ev[1]))
    big = max(range(len(flats)), key=lambda i: flats[i].numel())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats_fn(flats[big], buckets[big])
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    mon = numerics.NumericsMonitor()
    names = [f"p3n.cost.{i}" for i in range(len(sizes))]
    rows = torch.cat(mats).cpu()
    policy_ms = []
    for _ in range(reps):
        h0 = time.perf_counter()
        mon.ingest(names, rows)
        policy_ms.append((time.perf_counter() - h0) * 1e3)
    out = {"device_ms": statistics.median(device_ms),
           "host_queue_ms": statistics.median(host_ms),
           "scratch_bytes": scratch,
           "policy_host_ms": statistics.median(policy_ms),
           "bytes": sum(sizes) * 4}
    log(card, f"phase 3n (b): the numerics plane's cost ({label}) on the "
              f"flagship's {len(sizes)} gradients "
              f"({sum(sizes) * 4 / 1e6:.1f} MB fp32) "
              f"in {len(buckets)} buckets of at most 64 MiB, a step "
              f"(median of {reps}): stats {out['device_ms']:.3f} device ms "
              f"(by CUDA events), {out['host_queue_ms']:.3f} host ms to "
              f"queue; scratch of the largest bucket "
              f"({flats[big].numel() * 4 / 1e6:.1f} MB) "
              f"{scratch / 1e6:.1f} MB; the policy over the "
              f"{len(sizes)} rows {out['policy_host_ms']:.3f} host ms")
    del flats, mats
    torch.cuda.empty_cache()
    return out


def flagship_buckets():
    """The flagship's gradient sizes in reverse (the eager core's order)
    laid out in fusion buckets of the default 64 MiB threshold."""
    cfg = train_lm.flagship_config(True)
    sizes = [p.numel() for p in tr.TransformerLM(cfg, "meta", torch.float32)
             .parameters()][::-1]
    buckets, cur = [], []
    for n in sizes:
        if cur and (sum(cur) + n) * 4 > 64 * 1024 * 1024:
            buckets.append(cur)
            cur = []
        cur.append(n)
    buckets.append(cur)
    return buckets


def _f64_stats(x, sizes):
    """S_* rows of each slice of ``x`` in float64 on the card."""
    rows, off = [], 0
    f = x.double()
    for n in sizes:
        seg = f[off:off + n]
        fin = torch.isfinite(seg)
        safe = torch.where(fin, seg, 0.0)
        rows.append(torch.stack([
            safe.square().sum().sqrt(),
            safe.abs().max() if n else safe.new_zeros(()),
            (~fin).sum().double(), (seg == 0).sum().double() / max(n, 1),
            safe.sum()]))
        off += n
    return torch.stack(rows).cpu()


def check_stats_kernel(card, dev):
    """The numerics plane's stats kernel (csrc/segment_stats.cu) against
    its plain version and float64 on the card, fp32 and bf16: each of the
    flagship's fusion buckets with NaN, +inf, -inf and zeros planted (and
    the same buffer one element in, unaligned), a layout with empty
    slices and slices shorter than a chunk, and one slice of 607.6 MB
    (the flagship's gradients in one). Counts exact and equal
    to the plain version's; L2, max-abs and checksum within 1e-6 of
    float64, relative. Returns the largest |kernel - plain| over the
    float columns."""
    from horovod_tpu_torch.utils import numerics
    t0 = time.perf_counter()
    buckets = flagship_buckets()
    total = sum(sum(b) for b in buckets)
    layouts = {f"flagship bucket {i}": b for i, b in enumerate(buckets)}
    layouts.update({
        "empty slices": [0, 5, 0, 0, 70000, 1, 0, 16384, 16385, 0, 3],
        "one slice of 607.6 MB": [total]})
    gen = torch.Generator(device=dev).manual_seed(16)
    worst, n_cmp = 0.0, 0
    for label, sizes in layouts.items():
        for dt in (torch.float32, torch.bfloat16):
            n = sum(sizes)
            x = torch.randn(n, generator=gen, device=dev).to(dt)
            plant = torch.tensor([1, n // 3, n // 2, n - 2, 3, 4, 7],
                                 device=dev)
            x[plant] = torch.tensor([float("nan"), float("inf"),
                                     -float("inf"), float("nan"), 0.0, -0.0,
                                     0.0], device=dev).to(dt)
            cases = [(x, sizes)]
            if sizes[0] > 1:
                cases.append((x[1:], [sizes[0] - 1] + list(sizes[1:])))
            for buf, sz in cases:
                numerics.reset_launch_counts()
                got = numerics.segment_stats(buf, sz)
                if numerics.launch_counts["segment_stats"] != 1:
                    raise AssertionError(f"stats {label}: the kernel did not "
                                         f"launch")
                got = got.double().cpu()
                plain = numerics.segment_stats_plain(buf, sz).double().cpu()
                want = _f64_stats(buf, sz)
                if not torch.equal(got[:, 2], want[:, 2]) or \
                        not torch.equal(got[:, 2], plain[:, 2]):
                    raise AssertionError(f"stats {label} {dt}: nonfinite "
                                         f"counts {got[:, 2].tolist()} vs "
                                         f"{want[:, 2].tolist()}")
                torch.testing.assert_close(got[:, 3], want[:, 3], rtol=0,
                                           atol=1e-7)
                for c in (0, 1, 4):
                    torch.testing.assert_close(
                        got[:, c], want[:, c], rtol=1e-6, atol=1e-30,
                        msg=lambda m: f"stats {label} {dt} column {c}: {m}")
                worst = max(worst, (got - plain)[:, [0, 1, 3, 4]].abs()
                            .max().item())
                n_cmp += 1
            del x, cases
    numerics.reset_launch_counts()
    torch.cuda.empty_cache()
    log(card, f"phase 2: {n_cmp} stats kernel comparisons (segment_stats.cu "
              f"against float64 and the plain version; fp32 and bf16; the "
              f"flagship's {len(buckets)} buckets with NaN, +-inf and zeros "
              f"planted, aligned and one element in; empty and sub-chunk "
              f"slices; one "
              f"slice of {total * 4 / 1e6:.1f} MB) passed: counts exact, L2, "
              f"max-abs and checksum within 1e-6 of float64; largest "
              f"|kernel - plain| {worst:.3e}; "
              f"{time.perf_counter() - t0:.1f} s")
    return worst


def check_numerics_gate(card, dev):
    """Phase 3n (b): the reference's <=2 % contract on the flagship eager
    step at world 1 over NCCL (phase 3k (a)'s step, every other plane at
    its default), by bench.py's protocol (numerics.overhead_gate): an off
    and an on window of P3N_GATE_WINDOW steps each after an untimed step,
    the side that runs first alternating by round; the best window of
    each side; more rounds only while over budget, up to P3N_GATE_ROUNDS;
    fatal above P3N_GATE_BUDGET %. Then the same budget on the card's own
    clock, where host noise cannot hide a cost: one profiled on window
    of two steps, the stats kernels' device ms against every device ms
    of the step (``device_share``; None when torch.profiler recorded no
    device event, and run_phase_3n then holds the stats' CUDA-event ms
    against the best on window's ms). Returns the gate's figures and the
    stats kernel's launches in it."""
    from horovod_tpu_torch.utils import (alerts, history, memory, metrics,
                                         numerics, tracing)
    t0 = time.perf_counter()
    for plane in (metrics, tracing, memory, history, alerts):
        plane.reset(enabled=None)
    step, model, _, toks = _eager_flagship(dev, inner=P3N_GATE_WINDOW)
    for i in range(3):
        loss = _observed_step(step, toks, i)
    loss.item()
    numerics.reset_launch_counts()

    def window(enabled):
        numerics.reset(enabled=enabled)
        _observed_step(step, toks, 0).item()   # the toggle's own step
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(P3N_GATE_WINDOW):
            loss = _observed_step(step, toks, i)
        loss.item()
        numerics.get_monitor().drain()
        return (time.perf_counter() - t1) / P3N_GATE_WINDOW * 1e3
    try:
        out = numerics.overhead_gate(window, budget_pct=P3N_GATE_BUDGET,
                                     rounds=P3N_GATE_ROUNDS)
        out["launches"] = numerics.launch_counts["segment_stats"]
        numerics.reset(enabled=True)

        def two_steps():
            for i in range(2):
                _observed_step(step, toks, i)
            numerics.get_monitor().drain()
        busy, by_name = device_profile(two_steps, iters=1,
                                       events_if_empty=False)
    finally:
        numerics.reset()
    if not out["launches"]:
        raise AssertionError("the numerics gate's on windows never launched "
                             "the stats kernel")
    out["device_share"] = None
    if by_name:
        stats_ms = sum(ms for name, ms in by_name.items()
                       if "seg_partial_kernel" in name
                       or "seg_final_kernel" in name) / 2
        if not stats_ms:
            raise AssertionError(f"the profiled on steps ran no stats "
                                 f"kernel: {top_kernels(by_name)}")
        out["device_share"] = {"stats_ms": stats_ms, "step_ms": busy / 2,
                               "pct": stats_ms / busy * 2 * 100}
        if out["device_share"]["pct"] > P3N_GATE_BUDGET:
            raise AssertionError(f"the stats kernels take "
                                 f"{out['device_share']} of the step's "
                                 f"device time, over {P3N_GATE_BUDGET} %")
    n_buckets = len(flagship_buckets())
    log(card, f"phase 3n (b): numerics gate (bench.py's protocol: off and "
              f"on windows of {P3N_GATE_WINDOW} flagship eager steps a "
              f"round, the first side alternating, best of each side, at "
              f"most {P3N_GATE_ROUNDS} rounds) over "
              f"{out['rounds']} round(s): best off {out['off_best_ms']:.3f} "
              f"ms/step, best on {out['on_best_ms']:.3f}, overhead "
              f"{out['overhead_pct']:+.2f} % (budget {P3N_GATE_BUDGET} %); "
              f"windows off {[round(w, 3) for w in out['off_ms']]}, on "
              f"{[round(w, 3) for w in out['on_ms']]}; stats kernel launches "
              f"{out['launches']} (one a bucket, two kernels each; the "
              f"flagship's {n_buckets} buckets a step); on the card's clock "
              + (f"the stats kernels {out['device_share']['stats_ms']:.3f} "
                 f"of the step's {out['device_share']['step_ms']:.3f} device "
                 f"ms (torch.profiler, 2 steps), "
                 f"{out['device_share']['pct']:.3f} % (budget "
                 f"{P3N_GATE_BUDGET} %)" if out["device_share"] else
                 "not measured (torch.profiler recorded no device event)")
              + f"; {time.perf_counter() - t0:.1f} s")
    del step, model, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_memory_plane(card, dev):
    """Phase 3n (d): the ledger's params, optimizer and gradient
    components after one flagship eager step beside the allocator's
    bytes; hvd_step_peak_hbm_bytes of an instrumented step equal to
    torch.cuda.max_memory_allocated() for that step; hbm_headroom_low
    fires at HOROVOD_ALERT_HBM_HEADROOM_FRAC=0.99; a new shape at each
    call of a compile site raises hvd_recompile_storms_total."""
    from horovod_tpu_torch.utils import alerts, memory, metrics
    t0 = time.perf_counter()
    reg = metrics.reset(enabled=True)
    memory.reset(enabled=True)
    step, model, opt, toks = _eager_flagship(dev, inner=2)
    step(toks[0]).item()
    torch.cuda.synchronize()
    ledger = memory.get_ledger()
    ledger.account_tree("params", model)
    ledger.account_tree("opt_state", opt)
    ledger.account_tree("grads", [p.grad for p in model.parameters()])
    snap = ledger.snapshot()
    allocated = torch.cuda.memory_allocated(dev)
    timed = trainer.instrument_step(step, name="p3n_mem", device=dev)
    timed(toks[1])
    peak = torch.cuda.max_memory_allocated(dev)
    gauge = _counter(reg, "hvd_step_peak_hbm_bytes", loop="p3n_mem")
    if gauge != peak:
        raise AssertionError(f"phase 3n (d): hvd_step_peak_hbm_bytes "
                             f"{gauge} != max_memory_allocated {peak}")
    mgr = _p3n_alerts(("hbm_headroom_low",), hbm_headroom_frac=0.99)
    ledger.publish()
    for now in (0.0, 1.0):
        mgr.tick(now)
    firing = mgr.firing()
    alerts.reset(enabled=False)
    tracker = memory.get_tracker()
    fed = 0
    while not _counter(reg, "hvd_recompile_storms_total") and fed < 4 * \
            tracker.min_misses:
        fed += 1
        tracker.observe("p3n:storm", (torch.zeros(fed, device=dev),))
    storms = _counter(reg, "hvd_recompile_storms_total", site="p3n:storm")
    if "hbm_headroom_low" not in firing or storms != 1:
        raise AssertionError(f"phase 3n (d): firing {firing}, storms "
                             f"{storms} after {fed} new shapes")
    gib = 2 ** 30
    log(card, f"phase 3n (d): the ledger after one flagship eager step: "
              f"params {snap['components']['params'] / gib:.3f} GiB, "
              f"opt_state {snap['components']['opt_state'] / gib:.3f}, "
              f"grads {snap['components']['grads'] / gib:.3f} (total "
              f"{snap['total_bytes'] / gib:.3f} GiB of capacity "
              f"{snap['capacity_bytes'] / gib:.3f}) beside "
              f"torch.cuda.memory_allocated {allocated / gib:.3f} GiB; "
              f"hvd_step_peak_hbm_bytes {gauge:.0f} = max_memory_allocated "
              f"{peak} of the same step; hbm_headroom_low firing at frac "
              f"0.99 ({firing}); hvd_recompile_storms_total {storms:.0f} "
              f"after {fed} new shapes (min misses {tracker.min_misses}); "
              f"{time.perf_counter() - t0:.1f} s")
    memory.reset(enabled=False)
    del step, model, opt, toks, timed
    gc.collect()
    torch.cuda.empty_cache()


def _profiler_device_ms(prof):
    """The device ms of a finished capture by the profiler's own tally
    (``key_averages``' self device time of the card's events), beside the
    port's reading of the same events (``profiling.summarize_profile``)."""
    from torch.autograd import DeviceType
    return sum(a.self_device_time_total for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA) / 1e3


def _host_clock_offsets(trace, prof):
    """µs by which the live profiler's host events (its start plus each
    event's offset) lie after the same events of the exported trace
    (``baseTimeNanoseconds`` plus their ``ts``), paired by name and order
    where both hold a name equally often: the check that the device
    events merge() takes from the profiler sit on the trace's clock."""
    from torch.autograd import DeviceType
    base = trace["baseTimeNanoseconds"] / 1e3
    exported, live = collections.defaultdict(list), \
        collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and \
                e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation"):
            exported[e["name"]].append(base + float(e["ts"]))
    t0 = profiling.trace_start_us(prof)
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            live[e.name].append(t0 + float(e.time_range.start))
    out = []
    for name, ts in exported.items():
        if len(live.get(name, ())) == len(ts):
            out += [b - a for a, b in zip(sorted(ts), sorted(live[name]))]
    return out


P3N_MERGED_DIR = os.path.join(P3N_DIR, "merged")
P3N_MERGED_TIMEOUT_S = 180
# the launcher's and the port's variables a fresh world-1 process drops
P3N_MERGED_DROP_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                       "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def merged_capture(directory):
    """Phase 3n (e)'s merged timeline (``chip_smoke.py --merged-capture
    DIR``), in a process of its own at world 1 over NCCL: late in this
    script's long process torch.profiler has kept every host call of such
    a capture and dropped all but the last of its device records
    (PERF.md §7), which merged_timeline.capture reports in its file. The
    timeline is set up as a user sets it (HOROVOD_TIMELINE before init),
    the collective rides the bf16 wire, and a long cycle leaves it to
    synchronize on this thread. One allreduce of 2^24 floats warms the
    communicator; one merged_timeline.capture holds the next. Checks:
    every launch call of the capture has its device record; the device
    events merge() takes from the live profiler sit on the exported
    trace's clock (host events of both within P3N_CLOCK_US); the
    captured ALLREDUCE span overlaps the collective's device events in
    the merged file (a one-rank NCCL allreduce launches no kernel of its
    own: the casts to and from the wire dtype are its device work at
    world 1; the nccl events found are counted). Prints one JSON line of
    what it found; raises on a failed check."""
    from horovod_tpu_torch.utils import merged_timeline, metrics
    os.makedirs(directory, exist_ok=True)
    tl_path, merged_path, trace_path = (
        os.path.join(directory, n)
        for n in ("timeline.json", "merged.json", "trace.json"))
    os.environ.update(HOROVOD_TIMELINE=tl_path, HOROVOD_COMPRESSION="bf16",
                      HOROVOD_CYCLE_TIME="60000")
    dev = torch.device("cuda", 0)
    hvd.init()
    try:
        x = torch.randn(1 << 24, device=dev)
        hvd.synchronize(hvd.allreduce_async(x, name="p3n.warm",
                                            average=False))
        torch.cuda.synchronize()
        drift_us = time.time_ns() / 1e3 - metrics.shared_clock().epoch_us()
        with merged_timeline.capture(merged_path,
                                     trace_path=trace_path) as prof:
            hvd.synchronize(hvd.allreduce_async(
                x, name="p3n.merged", average=False))
            torch.cuda.synchronize()
    finally:
        hvd.shutdown()
    with open(merged_path) as f:
        events = json.load(f)["traceEvents"]
    with open(trace_path) as f:
        trace = json.load(f)
    exported_device = sum(1 for e in trace.get("traceEvents", [])
                          if e.get("cat") in profiling.DEVICE_CATEGORIES)
    offsets = _host_clock_offsets(trace, prof) \
        if "baseTimeNanoseconds" in trace else []
    gap_us = profiling.launch_gap_us(prof)
    launched, unrecorded = profiling.unrecorded_launches(prof)
    del prof
    if not launched or unrecorded:
        raise AssertionError(
            f"phase 3n (e): {len(unrecorded)} of the capture's {launched} "
            f"launch calls have no device record: {unrecorded[:12]}")
    if not offsets or max(map(abs, offsets)) > P3N_CLOCK_US:
        raise AssertionError(
            f"phase 3n (e): the live profiler's host events against the "
            f"exported trace's: {len(offsets)} paired, offsets "
            f"{sorted(offsets)[:3]}..{sorted(offsets)[-3:]} us "
            f"(baseTimeNanoseconds "
            f"{'present' if 'baseTimeNanoseconds' in trace else 'absent'})")

    def hvd_lane(e):
        pid = e.get("pid", 0)
        return isinstance(pid, int) and pid >= merged_timeline._HVD_PID_BASE
    spans, open_at = [], {}
    for e in events:
        if not hvd_lane(e) or "ts" not in e:
            continue
        if e.get("ph") == "B":
            open_at.setdefault(e["pid"], []).append((e["name"], e["ts"]))
        elif e.get("ph") == "E" and open_at.get(e["pid"]):
            name, ts = open_at[e["pid"]].pop()
            spans.append((name, ts, e["ts"]))
    # the captured allreduce's span: the later of the two
    allreduce = sorted((b, e) for name, b, e in spans
                       if name == "ALLREDUCE")[-1:]
    device = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if not hvd_lane(e) and e.get("ph") == "X" and
              e.get("cat") in profiling.DEVICE_CATEGORIES]
    nccl = [k for k in device if "nccl" in k[2].lower()]
    hits = [(k, s) for k in device for s in allreduce
            if k[0] < s[1] and k[1] > s[0]]
    if not hits:
        raise AssertionError(f"phase 3n (e): ALLREDUCE spans {allreduce}, "
                             f"device events {device[:6]}: no overlap "
                             f"({len(device)} device events from the live "
                             f"profiler, {exported_device} in the exported "
                             f"trace; launch gap {gap_us} us, the shared "
                             f"clock's drift {drift_us:.1f} us)")
    records = [e["args"] for e in events if e.get("name") == "device_records"]
    print(json.dumps({
        "launch_calls": launched, "device_records": records,
        "device_events": len(device), "exported_device_events":
        exported_device, "host_events_paired": len(offsets),
        "host_offset_max_us": round(max(map(abs, offsets)), 3),
        "launch_gap_us": None if gap_us is None else round(gap_us, 1),
        "clock_drift_us": round(drift_us, 1),
        "allreduce_us": round(allreduce[0][1] - allreduce[0][0], 1),
        "overlapping": sorted({k[2][:60] for k, _ in hits}),
        "nccl_kernels": len(nccl)}), flush=True)
    return 0


def run_merged_capture():
    """merged_capture in a fresh process at world 1 (the launcher's and
    the port's variables left out of its environment); returns the JSON
    it printed, raises with its output when it fails."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_")) and
           k not in P3N_MERGED_DROP_ENV}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--merged-capture",
         P3N_MERGED_DIR], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=P3N_MERGED_TIMEOUT_S)
    if proc.returncode:
        raise AssertionError(
            f"phase 3n (e): the merged-timeline process exited "
            f"{proc.returncode}\n{proc.stdout[-3000:]}\n"
            f"{proc.stderr[-6000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_instrument_step(card, dev):
    """Phase 3n (e): the flagship eager step under
    trainer.instrument_step with attrib_every=P3N_ATTRIB_EVERY over
    P3N_ATTRIB_STEPS steps: hvd_mfu (phase 4 prints it beside its MFU);
    each capture's hvd_step_breakdown_ms classes summing to within
    P3N_BREAKDOWN_TOL of the profiler's own device tally of the capture,
    the union of its device intervals inside the step's span by CUDA
    events, and "other" at most P3N_OTHER_MAX of it (its top kernels
    printed, and its launch calls without a device record counted). Then
    the merged timeline of an eager allreduce (merged_capture, in a
    process of its own). Returns the instrumented steps' launches and
    hvd_mfu."""
    from horovod_tpu_torch.utils import costmodel, memory, metrics
    t0 = time.perf_counter()
    reg = metrics.reset(enabled=True)
    memory.reset(enabled=True)
    cfg = train_lm.flagship_config(True)
    step, model, _, toks = _eager_flagship(dev, inner=P3N_ATTRIB_STEPS)
    step(toks[0]).item()
    spans = []

    def marked(t):
        # CUDA events around the step: its device span, a clock of its
        # own (the end behind every stream's work, the numerics side pass
        # on the collective stream included)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(t)
        torch.cuda.synchronize()
        ev[1].record()
        spans.append(ev)
        return out
    timed = trainer.instrument_step(
        marked, tokens_per_step=TRAIN_BATCH * TRAIN_SEQ, name="p3n",
        flops_per_token=tr.matmul_flops_per_token(cfg, TRAIN_SEQ),
        attrib_every=P3N_ATTRIB_EVERY, device=dev)
    caps = []
    fa.reset_launch_counts()
    for i in range(P3N_ATTRIB_STEPS):
        timed(toks[i])
        if (i + 1) % P3N_ATTRIB_EVERY == 0:
            prof = timed.last_profile
            caps.append((timed.last_decomposition,
                         spans[-1][0].elapsed_time(spans[-1][1]),
                         _profiler_device_ms(prof) if prof else None,
                         profiling.summarize_profile(prof) if prof
                         else None))
    launches = dict(fa.launch_counts)
    mfu = _counter(reg, "hvd_mfu", loop="p3n")
    spec = costmodel.chip_spec(dev)
    errs = [e for e in reg.events() if e["event"] == "perf_attrib_error"]
    seen = [c for c in caps if c[0] and c[0]["device_ms_per_step"] > 0]
    if errs or len(seen) != len(caps) or not caps or not mfu or \
            spec is None:
        raise AssertionError(f"phase 3n (e): attribution errors {errs}, "
                             f"captures {[c[0] for c in caps]}, hvd_mfu "
                             f"{mfu}, spec {spec}")
    checks = []
    for dec, span_ms, tally_ms, summary in seen:
        classes = {c["class"]: c for c in dec["classes"]}
        total = sum(c["ms_per_step"] for c in dec["classes"])
        union = profiling._span_ms(profiling._merge_intervals(
            [(e.start_ms, e.end_ms) for e in summary.events]))
        other = classes.get("other", {"ms_per_step": 0.0, "top_ops": []})
        others = sorted((r for r in summary.rows
                         if profiling.classify_op(r) == "other"),
                        key=lambda r: -r.total_ms)[:8]
        checks.append({
            "classes_ms": round(total, 3), "profiler_ms": round(tally_ms, 3),
            "gap": abs(total - tally_ms) / tally_ms,
            "union_ms": round(union, 3), "span_ms": round(span_ms, 3),
            "other_frac": other["ms_per_step"] / total,
            "unrecorded": (dec["launch_calls"],
                           dec["unrecorded_launches"]),
            "other_top": [(r.name[:90], round(r.total_ms, 3))
                          for r in others]})
    bad = [c for c in checks if c["gap"] > P3N_BREAKDOWN_TOL or
           c["union_ms"] > c["span_ms"] * 1.01 or
           c["other_frac"] > P3N_OTHER_MAX]
    if bad:
        raise AssertionError(f"phase 3n (e): captures {bad}")
    last = seen[-1][0]
    breakdown = {c["class"]: c["ms_per_step"] for c in last["classes"]}
    del step, model, toks, timed, caps, seen
    gc.collect()
    torch.cuda.empty_cache()

    # one merged timeline of an eager allreduce at world 1, in a process
    # of its own (merged_capture)
    merged = run_merged_capture()
    worst = max(checks, key=lambda c: c["other_frac"])
    log(card, f"phase 3n (e): instrument_step over {P3N_ATTRIB_STEPS} "
              f"flagship eager steps, attrib_every {P3N_ATTRIB_EVERY}: "
              f"hvd_mfu {mfu:.4f} (against {spec.kind} "
              f"{spec.peak_flops:.3g} FLOP/s); hvd_steps_total "
              f"{_counter(reg, 'hvd_steps_total', loop='p3n'):.0f}; "
              f"captures: classes' sum ms / the profiler's own tally / "
              f"union of the device intervals / the step's span by CUDA "
              f"events {[(c['classes_ms'], c['profiler_ms'], c['union_ms'], c['span_ms']) for c in checks]}"
              f" (gaps within {max(c['gap'] for c in checks):.2e}), "
              f"launch calls / those without their device record "
              f"{[c['unrecorded'] for c in checks]}, busy "
              f"{last.get('device_busy_frac')}; last breakdown ms "
              f"{breakdown}; 'other' at most {worst['other_frac']:.4f} of "
              f"the device ms, its top kernels {worst['other_top'][:4]}; "
              f"overlap {last.get('overlap', {}).get('lanes')}; merged "
              f"timeline of a fresh process: {merged}; launches "
              f"{launches}; {time.perf_counter() - t0:.1f} s")
    memory.reset(enabled=False)
    return launches, mfu


def run_phase_3n(card, dev):
    """Phase 3n at world 1, each part fatal; returns the launches of its
    flagship eager runs ((a)'s tuning run, (e)'s instrumented steps),
    (e)'s hvd_mfu, and (b)'s numerics gate and stats cost."""
    from horovod_tpu_torch.utils import metrics, numerics, tracing
    t0 = time.perf_counter()
    os.makedirs(P3N_DIR, exist_ok=True)
    launches = check_autotune_world1(card, dev)
    check_numerics_world1(card, dev)
    gate = check_numerics_gate(card, dev)
    cost = check_numerics_cost(card, dev)
    plain = check_numerics_cost(card, dev, numerics.segment_stats_plain,
                                label="plain version")
    if gate["device_share"] is None:
        # the stats' CUDA-event ms of a step against the step's best wall
        # ms: the wall ms is at least the device ms, so this share is a
        # lower bound of the device one
        pct = cost["device_ms"] / gate["on_best_ms"] * 100
        log(card, f"phase 3n (b): the stats' {cost['device_ms']:.3f} device "
                  f"ms a step (CUDA events) against the best on window's "
                  f"{gate['on_best_ms']:.3f} ms/step: {pct:.3f} % (budget "
                  f"{P3N_GATE_BUDGET} %)")
        if pct > P3N_GATE_BUDGET:
            raise AssertionError(f"the stats take {pct:.3f} % of the step")
    stats = {"gate": gate, "cost": cost, "plain_ms": plain["device_ms"]}
    check_memory_plane(card, dev)
    e_launches, mfu = check_instrument_step(card, dev)
    for k, v in e_launches.items():
        launches[k] = launches.get(k, 0) + v
    metrics.reset(enabled=False)
    tracing.reset(enabled=False)
    numerics.reset(enabled=False)
    log(card, f"phase 3n: launches of its paths {launches}; "
              f"{time.perf_counter() - t0:.1f} s in all")
    return launches, mfu, stats


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t_main = time.perf_counter()

    # ---- phase 1: build
    t0 = time.perf_counter()
    _build.extension()
    log(card, f"phase 1: built {list(_build.SOURCES)} for sm_90a in "
              f"{time.perf_counter() - t0:.1f} s")
    # the register reports of the wgmma/TMA sources, the fp32 forward, the
    # run-time-d kernels and the stats kernel: each alone through nvcc
    # -Xptxas -v, all started once the build has the cores back, read
    # after phase 2
    ptxas = {}
    for name, _ in PTXAS_SOURCES:
        cubin = os.path.join(ROOT, "build", "flash_fwd_ab", f"{name}.cubin")
        os.makedirs(os.path.dirname(cubin), exist_ok=True)
        ptxas[name] = subprocess.Popen(
            fwd_ab.nvcc_cmd([os.path.join(_build.CSRC, f"{name}.cu")], cubin,
                            cubin=True),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # ---- phase 2: kernels vs plain versions
    try:
        errs = check_kernels(card, dev)
        check_sm90_kernel(card, dev, errs)
        errs.update(check_bwd_kernels(card, dev))
        check_sm90_bwd(card, dev, errs)
        check_partial_tiles_and_head_dims(card, dev, errs)
        check_wide_head_dims(card, dev, errs)
        check_cc_fwd(card, dev, errs)
        check_beyond_256(card, dev, errs)
        check_ring_pairs(card, dev, errs)
        # the (rows, C) of every BatchNorm of a ResNet-50 step at batch 32
        step_shapes = vision_bn_shapes(
            models.build("resnet50", norm_impl="tpu", device=dev).train(),
            vision_batch(dev, VISION_BATCH)[0])
        if len(step_shapes) != BN_PER_STEP:
            raise AssertionError(f"ResNet-50 has {len(step_shapes)} "
                                 f"BatchNorms")
        errs.update(check_bn_kernels(card, dev, step_shapes))
        errs["segment_stats"] = check_stats_kernel(card, dev)
    except BaseException:
        for proc in ptxas.values():
            proc.kill()
            proc.communicate()
        raise

    # ---- phase 1's register reports
    for name, n_kernels in PTXAS_SOURCES:
        out, _ = ptxas[name].communicate(timeout=900)
        report = fwd_ab.ptxas_report(out)
        if ptxas[name].returncode or len(report) != n_kernels:
            raise AssertionError(f"nvcc -Xptxas -v on {name}.cu: rc "
                                 f"{ptxas[name].returncode}, {len(report)} "
                                 f"kernels\n{out[-3000:]}")
        spilled = {k_: v_ for k_, v_ in report.items() if v_[1] or v_[2]}
        if spilled:
            raise AssertionError(f"{name}.cu spills: {spilled}")
        serialized = [ln.strip() for ln in out.splitlines()
                      if any(c in ln for c in ("C7514", "C7515", "C7520"))]
        if serialized:
            raise AssertionError(f"{name}.cu: ptxas serialized wgmma: "
                                 f"{serialized}")
        note = ("CTAs of 384 threads then move registers to the consumers "
                "with setmaxnreg (producer 24, consumers 240); "
                if "sm90" in name else "")
        log(card, f"phase 1: nvcc -Xptxas -v, {name}.cu: (registers at "
                  f"entry, spill store bytes, spill load bytes) {report}; "
                  f"{note}ptxas 'wgmma serialized' warnings: "
                  f"{serialized or 'none'}")
    stamp(card, "phases 1-2", t_main)

    # ---- phase 3: serve GPT-2-small through the kernels
    cfg = tr.TransformerConfig.gpt2_small_tpu(attention_impl="flash")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    requests = serving_workload()
    fa.reset_launch_counts()
    results, steps, wall, _ = serve(cfg, model, requests, dev)
    launches = dict(fa.launch_counts)
    for name in ("flash_fwd_online", "flash_fwd_lazy"):
        if not launches.get(name):
            raise AssertionError(f"the serving run never launched {name}: "
                                 f"{launches}")
    if set(launches) - {"flash_fwd_online", "flash_fwd_lazy"}:
        raise AssertionError(f"unexpected launches {launches}")
    n_tokens = sum(len(r.tokens) for r in results)
    log(card, f"phase 3: served {len(results)} requests (prompts 16-960, "
              f"{n_tokens} generated tokens) in {steps} steps, {wall:.3f} s "
              f"({n_tokens / wall:.1f} tokens/s end to end incl. prefill); "
              f"launches {launches}; no KV block leaked")

    os.environ["HVD_FLASH_VARIANT"] = "twopass"
    try:
        fa.reset_launch_counts()
        serve(cfg, model, requests[6:9], dev)
        tp_launches = dict(fa.launch_counts)
    finally:
        del os.environ["HVD_FLASH_VARIANT"]
    if set(tp_launches) != {"flash_fwd_twopass"}:
        raise AssertionError(f"HVD_FLASH_VARIANT=twopass run launched "
                             f"{tp_launches}")
    launches.update(tp_launches)
    log(card, f"phase 3: twopass serving run launched {tp_launches}")

    # first-token logits: the kernel path against the plain path, where
    # the plain path is the same model with each kernel launch replaced
    # by its plain PyTorch version (the same tile walk) on the card. One
    # bf16 rounding flip in an attention output moves the logits of the
    # 11 layers after it, so in bf16 the 5e-2 tolerance is taken against
    # the logits' scale; in fp32 the per-kernel agreement carries through
    # the depth and the logits must agree to 1e-4.
    def first_logits(c, m, toks):
        got = prefill_forward(c, m, toks)[0][0, -1]
        with plain_path():
            want = prefill_forward(c, m, toks)[0][0, -1]
        if not torch.isfinite(got).all() or got.shape != (c.vocab_size,):
            raise AssertionError(f"prefill logits bad at {toks.shape}")
        return got, want

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = tr.init_params(cfg32, torch.Generator().manual_seed(0),
                             device=dev)
    for plen in (40, 512, 960):
        toks = torch.tensor((requests[0].prompt * 60)[:plen],
                            device=dev)[None]
        got, want = first_logits(cfg, model, toks)
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2 * scale)
        got32, want32 = first_logits(cfg32, model32, toks)
        torch.testing.assert_close(got32, want32, rtol=1e-4, atol=1e-4)
        if torch.argmax(got32) != torch.argmax(want32):
            raise AssertionError(f"fp32 first token differs at {plen}")
        log(card, f"phase 3: prompt {plen}: first-token logits, kernel vs "
                  f"plain path, bf16 max |diff| "
                  f"{(got - want).abs().max().item():.3e} (max |logit| "
                  f"{scale:.3f}), fp32 max |diff| "
                  f"{(got32 - want32).abs().max().item():.3e}")

    short = [Request("g0", (5, 9, 17, 4, 8), max_new_tokens=8),
             Request("g1", tuple(range(100, 170)), max_new_tokens=8)]
    cached = {r.request_id: list(r.tokens) for r in
              serve(cfg32, model32, short, dev)[0]}
    for r in short:
        toks = list(r.prompt)
        for _ in range(r.max_new_tokens):
            with torch.no_grad():
                logits = model32(torch.tensor([toks], device=dev))
            toks.append(int(torch.argmax(logits[0, -1])))
        if toks[len(r.prompt):] != cached[r.request_id]:
            raise AssertionError(f"{r.request_id}: cached greedy "
                                 f"{cached[r.request_id]} != no-cache "
                                 f"{toks[len(r.prompt):]}")
    log(card, "phase 3: fp32 cached greedy == no-cache greedy on 2 requests")
    del model32

    # ---- phase 3b's world (NCCL at world 1), then the phases that set
    # HVD_FLASH_VARIANT for a while (3e, 3f): they run before the process
    # lane starts, whose ranks take this process's environment
    hvd.init()
    check_nccl(card, dev)
    train_cfg = train_lm.flagship_config(True)

    # ---- phase 3e: head dim 256 (bf16 on the wgmma kernels, fp32 on the
    # CUDA cores), 384 on the run-time-d ones
    wide_launches = run_wide_heads(card, dev, train_cfg, requests)
    wide_launches.update(run_wide_heads(card, dev, train_cfg, requests,
                                        heads=DYN_HEADS, names=DYN_NAMES,
                                        serve_layers=WIDE_LAYERS,
                                        fp32_names=()))

    # ---- phase 3f: serving on the tensor-parallel mesh
    check_serving_mesh(card, dev, cfg, model, requests)
    stamp(card, "phases 3, 3e, 3f", t_main)

    # the process lane (3i (d)'s drill, 3j (c)'s mpirun ranks, 3j (a, b)'s
    # run(fn) ranks; 3h (b)'s two small processes on a track of their
    # own) beside the checks that record no time: 3b-3d, 3g, 3h (a),
    # 3i (a), 3j (a) at world 1 and 3k (b, c). It is joined before the
    # first timed phase, which then has the card and the host alone.
    torch.cuda.empty_cache()
    lane = ProcessLane(card)
    try:
        # ---- phase 3b: train the flagship through the kernels
        t_model, t_opt, t_batch, train_launches, train_losses = \
            train_flagship(card, dev, train_cfg)
        launches.update({k: train_launches[k]
                         for k in ("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv")})
        fp32_launches = check_train_grads(card, dev, train_cfg, t_batch)
        torch.cuda.empty_cache()

        # ---- phase 3c: train ResNet-50 through the BatchNorm kernels
        launches.update(train_vision(card, dev))
        check_vision_grads(card, dev)
        torch.cuda.empty_cache()

        # ---- phase 3d: the parallel path on one card
        g_model, g_opt, g_step, gspmd_launches = train_gspmd(
            card, dev, train_cfg, t_batch, train_losses)
        ring_launches = check_ring_flash(card, dev)
        check_seq_parallel_fwd(card, dev)
        check_chunked_ce(card, dev, train_cfg)
        log(card, f"phase 3d: launches of this slice's paths: GSPMD "
                  f"flagship {gspmd_launches}, ring_flash W={RING_W} "
                  f"{ring_launches}")
        torch.cuda.empty_cache()

        # ---- phase 3g: the collective backends
        check_collective_backends(card, dev, t_model, cfg.vocab_size)
        # ---- phase 3h (a): the eager coordination core at world 1
        check_eager_core(card, dev)
        # ---- phase 3i (a): the wire codecs
        check_codecs(card, dev, t_model)
        # ---- phase 3j (a) at world 1: op and axis_name
        check_op_axis(card, dev)
        torch.cuda.empty_cache()
        # ---- phase 3k (b, c): two ranks over gloo, a stall, chaos
        os.makedirs(P3K_DIR, exist_ok=True)
        p3k_ranks = run_observed_ranks(card)
    except BaseException:
        lane.join(quiet=True)   # its processes end before this one does
        raise
    lane_out = lane.join()
    log(card, f"phase 3j (c): the mpirun ranks' losses equal to the run(fn) "
              f"ranks': {lane_out['3j (c)'] == lane_out['3j (a, b)']}")
    stamp(card, "phases 3b-3d, 3g-3k (c) beside the process lane", t_main)

    # ---- the timed phases, each alone on the card and the host
    # ---- phase 3h (c): the eager entry points
    t3h = time.perf_counter()
    run_eager_entry_points(card, dev, train_cfg)
    log(card, f"phase 3h (c): {time.perf_counter() - t3h:.1f} s")

    # ---- phase 3i (b), (c): the quantized and sparse wire; checkpoint
    run_phase_3i(card, dev, t_model, t_opt, train_cfg)

    # ---- phase 3j (d), (e): overlap, tp checkpoint
    run_phase_3j(card, dev)
    stamp(card, "phases 3h (c), 3i (b, c), 3j (d, e)", t_main)

    # ---- phase 3k (a), (d): the observability planes on the eager core
    # and serving
    run_phase_3k(card, dev, cfg, model, p3k_ranks)
    stamp(card, "phase 3k", t_main)

    # ---- phase 3n: the numerics, memory and compile, cost-model,
    # attribution and autotuner planes on the flagship eager step; B2, B4
    # and B5 launch in (a)'s tuning run and (e)'s instrumented steps. Run
    # before phase 4: late in the script torch.profiler's exported traces
    # came back without device events (two whole runs), and it leaves
    # every plane off for the timings
    p3n_launches, p3n_mfu, p3n_stats = run_phase_3n(card, dev)
    stamp(card, "phase 3n", t_main)

    # phase 3b's weights, generation 2 of phase 3l (after phase 4), kept
    # on the host so that phase 4's memory readings do not count them
    trained = {n: p.detach().cpu() for n, p in t_model.named_parameters()}

    # ---- phase 4: timings
    kernels = []
    # each kernel at the largest shape the serving runs gave it
    plen_pad = [min(-(-len(r.prompt) // SERVE_KV_BLOCK) * SERVE_KV_BLOCK,
                    SERVE_MAX_LEN) for r in requests]
    main_s = {"online": max(s for s in plen_pad if s <= fa.BLOCK),
              "lazy": -(-max(plen_pad) // fa.BLOCK) * fa.BLOCK,
              "twopass": -(-max(plen_pad[6:9]) // fa.BLOCK) * fa.BLOCK}
    h, d = cfg.num_heads, cfg.head_dim
    for variant in fa.VARIANTS:
        ms, b_ms, b_by = time_fwd(card, dev, variant, 1, main_s[variant], h,
                                  d, 70)
        kernels.append({
            "name": f"flash_fwd_{variant}", "route": "cuda",
            "source": SM90_SOURCE, "replaces": REPLACES[variant],
            "launches": launches.get(f"flash_fwd_{variant}", 0),
            "max_abs_err": errs[variant], "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": ms["library"]})
    # B1 also at the shortest prompt, the longest one and the training
    # shape (variant="online")
    for s in (16, 960):
        time_fwd(card, dev, "online", 1, s, h, d, 70)
    for variant in ("lazy", "online"):
        kernels[fa.VARIANTS.index(variant)].update(
            time_fwd_training(card, dev, variant),
            train_launches=train_launches.get(f"flash_fwd_{variant}", 0))
    time_launch_floor(card)
    time_fwd_host(card, dev, h, d)
    time_head_dim_cost(card, dev)
    kernels.extend(time_bwd_kernels(card, dev, launches, errs))
    multi = time_training(card, dev, t_model, t_opt, t_batch, train_cfg)
    log(card, f"phase 4: make_multi_step MFU {multi['mfu']:.4f} beside "
              f"phase 3n (e)'s hvd_mfu {p3n_mfu:.4f} of the instrumented "
              f"eager step")
    time_gspmd(card, dev, g_model, g_opt, g_step, t_batch, multi)
    del g_model, g_opt, g_step
    time_memory_and_remat(card, dev, t_model, t_opt, train_cfg, t_batch)
    kernels.extend(time_bn_kernels(card, dev, step_shapes, launches, errs))
    del t_model, t_opt
    torch.cuda.empty_cache()
    time_ring(card, dev)
    kernels.extend(time_wide_kernels(card, dev, errs, wide_launches,
                                     fp32_launches))
    # the three variants side by side at the serving max_len
    for dt in (torch.bfloat16, torch.float32):
        qf, kf, vf = (t[0].transpose(0, 1).contiguous() for t in qkv(
            71, b=1, s=1024, h=h, d=d, dtype=dt, device=dev))
        calls = {var: (lambda var=var: fa._kernel_fwd(
            qf, kf, vf, True, d ** -0.5, var)) for var in fa.VARIANTS}
        calls["sdpa"] = lambda: torch.nn.functional \
            .scaled_dot_product_attention(qf[None], kf[None], vf[None],
                                          is_causal=True)
        row = {}
        for name, fn in calls.items():
            row[name] = device_ms(fn)
            if row[name] is None:
                row[name + " (event)"] = time_ms(fn)
        ops, nbytes = attention_work(h, 1024, d, True, dt.itemsize)
        row["bound"] = bound(ops, nbytes, PEAK_BF16_FLOPS if dt ==
                             torch.bfloat16 else PEAK_FP32_FLOPS)[0]
        log(card, f"phase 4: causal b=1 h={h} d={d} s=1024 {dt} device "
                  f"ms: {row}")
    # prefill and decode: wall time per call (host-driven, CUDA events)
    # beside the device's kernel time; their ratio is the busy share
    for s in (16, 40, 64, 128, 512, 960):
        toks = torch.arange(1, s + 1, device=dev)[None] % cfg.vocab_size

        def prefill():
            return prefill_forward(cfg, model, toks)
        wall = time_ms(prefill, iters=10)
        busy, by_name = device_profile(prefill, iters=5)
        log(card, f"phase 4: prefill gpt2_small_tpu bf16 prompt {s}: "
                  f"{wall:.3f} ms wall, {busy:.3f} ms device "
                  f"(busy {busy / wall:.1%}), {s / wall * 1e3:.0f} prompt "
                  f"tokens/s; top device ms: {top_kernels(by_name)}")
    kv_shape = (cfg.num_layers, SERVE_SLOTS, SERVE_MAX_LEN, h, d)
    kv_k = torch.zeros(kv_shape, dtype=cfg.dtype, device=dev)
    kv_v = torch.zeros_like(kv_k)
    tokens = torch.tensor([11, 22, 33, 44], device=dev)
    positions = torch.tensor([512, 300, 900, 100], device=dev)

    def decode():
        return decode_step(cfg, model, tokens, positions, kv_k, kv_v)
    wall = time_ms(decode, iters=20)
    busy, by_name = device_profile(decode, iters=10)
    log(card, f"phase 4: decode_step gpt2_small_tpu bf16 {SERVE_SLOTS} "
              f"slots, max_len {SERVE_MAX_LEN}: {wall:.3f} ms/step wall, "
              f"{busy:.3f} ms device (busy {busy / wall:.1%}), "
              f"{SERVE_SLOTS / wall * 1e3:.1f} tokens/s; top device ms: "
              f"{top_kernels(by_name)}")

    time_vision(card, dev, step_shapes)
    stamp(card, "phase 4", t_main)

    # ---- phase 3l: the fleet and router planes; its B1/B2 launches go
    # into the kernels line
    p3l_launches, _ = run_phase_3l(card, dev, trained)
    stamp(card, "phase 3l", t_main)
    for k in kernels[:len(fa.VARIANTS)]:
        k["routed_launches"] = p3l_launches.get(k["name"], 0)
        k["launches"] += k["routed_launches"]

    # ---- phase 3m: MoE on ep, the pipeline on pp; B2, B4 and B5 launch
    # in all three of its paths
    p3m_launches = run_phase_3m(card, dev)
    # their launches are at the flagship's head dim 128: not the d-256
    # and d-384 entries, which carry phase 3e's
    for k in kernels:
        if k["name"] in p3m_launches and "head_dim" not in k:
            k["moe_pipeline_launches"] = p3m_launches[k["name"]]
            k["launches"] += k["moe_pipeline_launches"]
    for k in kernels:
        if k["name"] in p3n_launches and "head_dim" not in k:
            k["p3n_launches"] = p3n_launches[k["name"]]
            k["launches"] += k["p3n_launches"]
    # the stats kernel over the flagship's buckets of a step (one count a
    # bucket, two kernels each): its launches in phase 3n (b)'s gate (the eager step with
    # numerics on by default), its time and the plain version's a step,
    # the bound of reading the 607.6 MB once
    cost = p3n_stats["cost"]
    kernels.append({
        "name": "segment_stats", "route": "cuda", "source": STATS_SOURCE,
        "replaces": REPLACES["segment_stats"],
        "launches": p3n_stats["gate"]["launches"],
        "max_abs_err": errs["segment_stats"], "ms": cost["device_ms"],
        "plain_ms": p3n_stats["plain_ms"],
        "bound_ms": cost["bytes"] / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "per": f"the flagship's {len(flagship_buckets())} buckets of one "
               f"step"})
    log(card, f"chip_smoke: {time.perf_counter() - t_main:.1f} s from the "
              f"build to the result")

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--wire-ranks"]:
        sys.exit(wire_ranks(sys.argv[2]))
    if sys.argv[1:2] == ["--merged-capture"]:
        sys.exit(merged_capture(sys.argv[2]))
    sys.exit(main())
