#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device and builds the
kernels from horovod_tpu_torch/csrc/ at first use. Phases, each fatal
on failure:

  1. the card's name and power limit, then the build of every kernel
     source (flash_fwd.cu, flash_fwd_sm90.cu, flash_bwd.cu,
     flash_bwd_sm90.cu, batch_norm.cu) and its time, and beside it the
     wgmma/TMA sources (forward B1, B2, B3: 24 instantiations; backward
     B4, B5: 12) each alone through nvcc -Xptxas -v: each instantiation's
     registers and spills, where any spill fails the run, and ptxas's
     performance warnings (C7514/C7520, "wgmma serialized"), printed;
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
     (b=16 h=6 d=128 s=1024, causal); then the fp32 CUDA-core forward and
     backward at partial-tile lengths (s 100, sq 100 x sk 300), and both
     dtypes at head dims 80 and 96 (zero-padded to 128 on the host) through
     the public autograd path against the plain walks at the true head
     dim; then head dims 160, 192 and 256 on the CUDA-core kernels, fp32
     and bf16, forward and backward, at partial-tile lengths, every
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
     the training shape; fp32 to rtol 1e-4 / atol 1e-5, bf16 to two ulps
     plus 1 % of that gradient's largest magnitude. Then the
     head dims above 256 on the run-time-d kernels (flash_dyn.cu): d 288,
     384, 512 and 1024, fp32 and bf16, every forward walk, dq and dk/dv
     at partial last tiles, sq != sk, causal and not, with the rising-max
     adversaries, the accumulators in shared memory and in the device
     workspace, and d 288 through the public autograd path. Then the
     BatchNorm statistics kernels (B6 moments, B7 moments2) against their
     plain versions, both held to a float64 sum on the card within 1e-5
     of the per-channel sum of magnitudes, in bf16 and fp32, on
     unit-scale and 1e3-offset inputs (never zeros), at every (rows, C)
     of a ResNet-50 step at batch 32 x 224 and at ragged shapes;
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
     plain version (bf16 against each gradient's scale, and fp32);
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
  3e. head dim 256 on the CUDA-core kernels through the user's entry
     points: the flagship's width (d_model 768, vocab 50304) over 3 heads
     of 256, depth cut to 2 layers, serves four requests (prompts 16-100:
     the online and lazy walks) and one more under
     HVD_FLASH_VARIANT=twopass, then trains 4 steps at batch 16 x seq 1024
     through make_gspmd_multi_step on the one-card mesh. Launch counts
     are zeroed just before and read just after: each of the five
     CUDA-core kernels (flash_fwd_cc_{online,lazy,twopass},
     flash_bwd_cc_{dq,dkv}) must have launched and nothing else; the
     loss must fall, and the first batch's loss on the kernel path must
     equal the plain path's within 2^-8; then the same over 2 heads of
     384 on the run-time-d kernels (flash_fwd_dyn_*, flash_bwd_dyn_*);
  3f. serving on the tensor-parallel mesh: GPT-2-small (bf16, full width
     and depth) served by tp engines of 2, 3 and 4 ranks, the ranks
     threads of this process on the one card (at tp 4 the 6 heads do not
     split: every rank computes all of them, the KV cache replicated),
     the phase-3 requests and a twopass run, held to the unsharded
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
     RanksLostError, every join under a deadline; (c) the --eager-allreduce
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
     flagship at full width and depth, 20 steps under
     HOROVOD_COMPRESSION none, bf16, int8 and fp8: 12+12+12 launches a
     step on each rank, losses falling, encoded wire bytes a step at
     most 0.26 of the fp32 gradient bytes, rank 0's last quantized bucket
     (error feedback applied on both ranks) equal to
     stacked_wire_allreduce of both ranks' compensated inputs, ms/step
     per codec; (c) word2vec --eager on 2 ranks through hvdrun,
     200 steps: the loss falls, to_dense of the grouped sparse allreduce
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
     recovery time printed;
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
     sequence, and the d-256 and d-384 kernels beside d 128.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
there is no CUDA device or the port is not beside this script.
"""

import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
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
from torch.autograd import DeviceType  # noqa: E402
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
from horovod_tpu_torch.serving.decode import (  # noqa: E402
    decode_step, prefill_forward)
from horovod_tpu_torch.serving.engine import ServeEngine  # noqa: E402
from horovod_tpu_torch.serving.queue import (  # noqa: E402
    AdmissionQueue, Request)

# H100 SXM published peaks (dense bf16 tensor cores, HBM3), NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_KV_BLOCK = 4, 1024, 16
SM90_SOURCE = "horovod_tpu_torch/csrc/flash_fwd_sm90.cu"
BWD_SOURCE = "horovod_tpu_torch/csrc/flash_bwd_sm90.cu"
CC_FWD_SOURCE = "horovod_tpu_torch/csrc/flash_fwd.cu"
CC_BWD_SOURCE = "horovod_tpu_torch/csrc/flash_bwd.cu"
BN_SOURCE = "horovod_tpu_torch/csrc/batch_norm.cu"
REPLACES = {"online": "horovod_tpu/ops/flash_attention.py:129",
            "lazy": "horovod_tpu/ops/flash_attention.py:220",
            "twopass": "horovod_tpu/ops/flash_attention.py:312",
            "dq": "horovod_tpu/ops/flash_attention.py:467",
            "dkv": "horovod_tpu/ops/flash_attention.py:531",
            "bn_moments": "horovod_tpu/ops/batch_norm.py:78",
            "bn_moments2": "horovod_tpu/ops/batch_norm.py:95"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
# phase 3e: the flagship's d_model 768 over 3 heads of 256, depth cut
WIDE_HEADS, WIDE_LAYERS, WIDE_STEPS = 3, 2, 4
CC_NAMES = tuple(f"flash_fwd_cc_{v}" for v in ("online", "lazy", "twopass")
                 ) + ("flash_bwd_cc_dq", "flash_bwd_cc_dkv")
# phase 3e again: the flagship's width over 2 heads of 384, on the
# run-time-d kernels
DYN_HEADS = 2
DYN_NAMES = tuple(f"flash_fwd_dyn_{v}" for v in ("online", "lazy", "twopass")
                  ) + ("flash_bwd_dyn_dq", "flash_bwd_dyn_dkv")
DYN_SOURCE = "horovod_tpu_torch/csrc/flash_dyn.cu"
VISION_BATCH, VISION_SIZE, VISION_STEPS = 32, 224, 10
BN_PER_STEP = 53   # BatchNorm layers of ResNet-50


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(card, msg):
    print(f"[{card}] {msg}", flush=True)


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


def device_profile(fn, iters=20):
    """Device time per call from torch.profiler over ``iters`` calls,
    counting each event that ran on the card once: (total ms, None when
    nothing was recorded; {kernel name: ms})."""
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(2):   # a trace that recorded nothing is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0) +
                                   e.time_range.elapsed_us() / 1e3 / iters)
        if by_name:
            break
    return sum(by_name.values()) or None, by_name


def device_ms(fn, iters=20):
    return device_profile(fn, iters)[0]


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
    at both CTA shapes, causal and not, and the training shape. Folds the
    largest O error into ``errs``."""
    ramp = {"down": torch.linspace(4.0, 0.5, 512),
            "up": torch.linspace(0.5, 4.0, 512)}
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
                    errs[variant] = max(errs[variant], err)
                n_cmp += 1
    log(card, f"phase 2: {n_cmp} wgmma/TMA forward kernel/plain comparisons "
              f"(bf16 online, lazy and twopass, O and lse; d 16/32/64/128, s "
              f"192 and 960 at b·h >= 2, sq 192 x sk 320, CTA rows 64 and "
              f"128, rising-max adversaries, s 16/64/100/1000 and sq 100 x sk "
              f"300 causal and not, the training shape) passed; largest "
              f"error as a share of its tolerance {share:.3f}")


def check_bwd_kernels(card, dev):
    """The backward kernels against their plain versions on dq, dk and
    dv: the forward checks' shapes, a partial tile, the rising-max
    adversaries, the training shape, and the ragged causal s=1000
    through the autograd path (unpadded)."""
    errs = {"dq": 0.0, "dkv": 0.0}   # bf16, the wgmma/TMA kernels
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
        if dtype == torch.bfloat16:
            errs[kernel] = max(errs[kernel], err)
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
    and the training shape. lse and delta come from the plain forward.
    Folds the largest errors into ``errs``."""
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
            errs[kernel] = max(errs[kernel], err)
            share = max(share, frac)
            n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} wgmma/TMA backward kernel/plain comparisons "
              f"(bf16 dq, dk, dv; d 16/32/64/128, s 960 and 1000 at b·h >= "
              f"2, sq 192 x sk 320 and 320 x 200, dq CTA rows 64 and 128, "
              f"rising-max adversaries, the training shape) passed; largest "
              f"error as a share of its tolerance {share:.3f}")


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


WIDE_DIMS = (160, 192, 256)


def check_wide_head_dims(card, dev, errs):
    """Head dims above 128 on the CUDA-core kernels: d 160, 192 and 256
    (zero-padded to 256 on the host below it) through the public autograd
    path at s 200 (a partial 64-row tile and a partial 32-key tile), fp32
    and bf16, causal and not, against the plain walks at the true d and
    the kernels' tiles, O and dq, dk, dv; then every forward walk at d 256
    through the launch wrapper at sq 130 causal and sq 64 x sk 200, O and
    lse. Folds the largest bf16 errors into ``errs`` (fwd_d256, dq_d256,
    dkv_d256)."""
    for key in ("fwd_d256", "dq_d256", "dkv_d256"):
        errs.setdefault(key, 0.0)
    share, n_cmp = {"bfloat16": 0.0, "float32": 0.0}, 0
    want_launches = {"flash_fwd_cc_online": 1, "flash_bwd_cc_dq": 1,
                     "flash_bwd_cc_dkv": 1}
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
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
                if dtype == torch.bfloat16:
                    errs["fwd_d256"] = max(errs["fwd_d256"], err)
                n_cmp += 1
                for name, t, w in zip(("dq", "dk", "dv"), ts, want[1:]):
                    err, frac = hold_grad(flat(t.grad), w, dtype,
                                          f"{name} {label}")
                    share[dt] = max(share[dt], frac)
                    key = "dq_d256" if name == "dq" else "dkv_d256"
                    if dtype == torch.bfloat16:
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
                    if dtype == torch.bfloat16 and what == "O":
                        errs["fwd_d256"] = max(errs["fwd_d256"], err)
                    n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} comparisons of head dims 160/192/256 on the "
              f"CUDA-core kernels (public autograd path at s 200, fp32 and "
              f"bf16, causal and not; each walk at d 256 at partial tiles) "
              f"passed; largest error as a share of its tolerance {share}; "
              f"largest bf16 |error| fwd {errs['fwd_d256']:.3e}, dq "
              f"{errs['dq_d256']:.3e}, dk/dv {errs['dkv_d256']:.3e}")


BEYOND_DIMS = (288, 384, 512, 1024)


def check_beyond_256(card, dev, errs):
    """Head dims above 256 on the run-time-d kernels (``flash_dyn.cu``):
    at d 288, 384, 512 and 1024, fp32 and bf16, every forward walk and dq
    and dk/dv (from the plain forward's lse) against the plain walks at
    the kernels' 32-row tiles, at sq 130 causal (a partial last tile),
    sq 100 x sk 300 non-causal, and sq = sk 256 with the rising-max
    adversaries (keys ramped down, causal: every tile of lazy's
    diagonal-first walk raises the row max; ramped up, non-causal: every
    tile of the ascending walks does); the fp32 accumulators in shared
    memory and, forced, in the device workspace at d 288 and 512 (at
    d 1024 dk/dv's are there anyway); then d 288 through the public
    autograd path at s 200, causal and not. Folds the largest bf16
    errors into ``errs`` (fwd_dyn, dq_dyn, dkv_dyn)."""
    for key in ("fwd_dyn", "dq_dyn", "dkv_dyn"):
        errs.setdefault(key, 0.0)
    share, n_cmp = {"bfloat16": 0.0, "float32": 0.0}, 0
    cases = ((130, 130, True, None), (100, 300, False, None),
             (256, 256, True, "down"), (256, 256, False, "up"))
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for d in BEYOND_DIMS:
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
                for variant in fa.VARIANTS:
                    p_out, p_lse = plain_fwd(qf, kf, vf, causal, scale,
                                             variant)
                    for ws in spaces:
                        out, lse = fa._kernel_fwd(qf, kf, vf, causal, scale,
                                                  variant, workspace=ws)
                        for got, w, what in ((out, p_out, "O"),
                                             (lse, p_lse, "lse")):
                            err, frac = hold(got, w, what, dtype,
                                             f"{variant} {label} ws={ws}")
                            share[dt] = max(share[dt], frac)
                            if dtype == torch.bfloat16 and what == "O":
                                errs["fwd_dyn"] = max(errs["fwd_dyn"], err)
                            n_cmp += 1
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
                        if dtype == torch.bfloat16:
                            errs[key] = max(errs[key], err)
                        n_cmp += 1
        for causal in (True, False):
            q, k, v = qkv(2300, b=2, s=200, h=3, d=288, dtype=dtype,
                          device=dev)
            g = torch.randn(q.shape, generator=torch.Generator()
                            .manual_seed(2301)).to(dev, dtype)
            ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            fa.reset_launch_counts()
            out = fa.flash_attention(*ts, causal=causal, variant="online",
                                     device=dev)
            out.backward(g)
            want_launches = {"flash_fwd_dyn_online": 1, "flash_bwd_dyn_dq": 1,
                             "flash_bwd_dyn_dkv": 1}
            if dict(fa.launch_counts) != want_launches:
                raise AssertionError(f"d=288 {dt} launched "
                                     f"{dict(fa.launch_counts)}")
            qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
            p_out, p_lse = plain_fwd(qf, kf, vf, causal, 288 ** -0.5,
                                     "online")
            delta = ref.flash_delta(p_out, gf)
            want = (p_out, *plain_bwd(qf, kf, vf, gf, p_lse, delta, causal,
                                      288 ** -0.5))
            label = f"public {dt} d=288 causal={causal}"
            err, frac = hold(flat(out.detach()), want[0], "O", dtype, label)
            share[dt] = max(share[dt], frac)
            n_cmp += 1
            for name, t, w in zip(("dq", "dk", "dv"), ts, want[1:]):
                err, frac = hold_grad(flat(t.grad), w, dtype,
                                      f"{name} {label}")
                share[dt] = max(share[dt], frac)
                n_cmp += 1
    fa.reset_launch_counts()
    log(card, f"phase 2: {n_cmp} comparisons of head dims "
              f"{list(BEYOND_DIMS)} on the run-time-d kernels (every walk, "
              f"dq and dk/dv; partial last tiles, sq != sk, rising-max "
              f"adversaries; accumulators in shared memory and in the device "
              f"workspace; d 288 through the public autograd path) passed; "
              f"largest error as a share of its tolerance {share}; largest "
              f"bf16 |error| fwd {errs['fwd_dyn']:.3e}, dq "
              f"{errs['dq_dyn']:.3e}, dk/dv {errs['dkv_dyn']:.3e}")


def check_ring_pairs(card, dev, errs):
    """The call patterns of a ring_flash pair after the first: at the
    model's attention width (b 4, h 6, d 128, s 1024, bf16, the wgmma
    kernels), at fp32 (b 1) and at d 256 (b 1, bf16; the CUDA-core
    kernels). The forward non-causal at sq = sk against the plain walk;
    the backward under a merged lse (the pair's own plus another block of
    equal mass) whose odd rows are +1e30 (a future pair for those rows),
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
    for the serving logits), in fp32 to 1e-4 of it."""
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = tr.init_params(c, torch.Generator().manual_seed(1),
                               device=dev, train=True)
        loss_fn = tr.lm_loss_fn(model)

        def grads():
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model, batch[:2])
            loss.backward()
            return loss.item(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()}
        got_loss, got = grads()
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
        log(card, f"phase 3b: {dtype} batch-2 step, kernel vs plain path: "
                  f"loss {got_loss:.6f} vs {want_loss:.6f}; largest grad "
                  f"|diff| / that grad's max |value| {worst:.3e} over "
                  f"{len(want)} parameters (tolerance {tol})")
        del model, got, want
    torch.cuda.empty_cache()


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


def run_wide_heads(card, dev, train_cfg, requests, heads=WIDE_HEADS,
                   names=CC_NAMES, phase="3e"):
    """The flagship's width (d_model 768, vocab 50304, d_ff 3072) over
    ``heads`` heads (WIDE_HEADS: 256 each, on the CUDA-core kernels;
    DYN_HEADS: 384 each, on the run-time-d ones), depth cut to
    WIDE_LAYERS: the serving engine answers requests[:4] (prompts 16-100:
    the online and lazy walks) and requests[3] again under
    HVD_FLASH_VARIANT=twopass, then the model trains WIDE_STEPS steps on
    one batch of TRAIN_BATCH x TRAIN_SEQ through make_gspmd_multi_step on
    a one-card mesh. The counts are zeroed just before and read just
    after: each of the five kernels ``names`` must have launched, and no
    other kernel. The loss must fall, and the training batch's loss
    through the kernels must equal the plain path's within 2^-8
    (launches of that comparison not counted). Returns the run's
    launches."""
    cfg = dataclasses.replace(train_cfg, num_heads=heads,
                              num_layers=WIDE_LAYERS)
    serve_model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    mesh = mesh_lib.build_mesh(dp=1)
    model, opt, step, toks = train_lm.build_gspmd_step(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 1, dev, mesh)
    fa.reset_launch_counts()
    serve(cfg, serve_model, requests[:4], dev)
    os.environ["HVD_FLASH_VARIANT"] = "twopass"
    try:
        serve(cfg, serve_model, requests[3:4], dev)
    finally:
        del os.environ["HVD_FLASH_VARIANT"]
    losses = [step(model, opt, toks)[2].item() for _ in range(WIDE_STEPS)]
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    missing = [n for n in names if not launches.get(n)]
    if missing or set(launches) - set(names):
        raise AssertionError(f"the head-dim-{cfg.head_dim} run launched "
                             f"{launches}; missing {missing}")
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
    log(card, f"phase {phase}: d_model {cfg.d_model} over {cfg.num_heads} "
              f"heads "
              f"of {cfg.head_dim}, {cfg.num_layers} layers: served 5 "
              f"requests (one under twopass), trained {WIDE_STEPS} GSPMD "
              f"steps at b{TRAIN_BATCH} x s{TRAIN_SEQ}: loss "
              f"{[round(x, 4) for x in losses]}; launches {launches}; loss "
              f"through the kernels {got:.6f} vs plain path {want:.6f} "
              f"(|diff| / loss {rel:.3e}, bound 2^-8)")
    return launches


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
    engine."""
    from horovod_tpu_torch.serving.decode import ServingWeights
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
    ev, dvc = time_ms(fn, iters, 5), device_ms(fn, iters)
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
        plain_ms = device_ms(plain, 2) or time_ms(plain, 2, 1)
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
    dvc = {k_: device_ms(fn, 2 if k_ == "plain" else 20)
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


def time_wide_kernels(card, dev, errs, launches):
    """The CUDA-core kernels at d 256 and the run-time-d ones at d 384
    beside the wgmma ones at d 128 (bf16, causal, b 4 h 6 s 1024): device
    ms per call of each forward walk (online, lazy, twopass), dq and
    dk/dv, against the bound (operations at the bf16 peak, or the bytes),
    their plain versions at the kernels' tiles and SDPA's forward and
    backward (whichever backend SDPA takes at that d); returns the
    CUDA-core and run-time-d kernels' JSON entries, each with its
    launches in phase 3e's runs (``launches``)."""
    b, s, h = 4, 1024, 6
    dyn_d = 768 // DYN_HEADS
    entries, rows = [], {}
    for d in (128, 256, dyn_d):
        q, k, v = qkv(1800 + d, b=b, s=s, h=h, d=d, dtype=torch.bfloat16,
                      device=dev)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            d)).to(dev, torch.bfloat16)
        qf, kf, vf, gf = (flat(t) for t in (q, k, v, g))
        scale = d ** -0.5
        out, lse = fa._kernel_fwd(qf, kf, vf, True, scale, "online")
        delta = ref.flash_delta(out, gf)
        ext = fa.extension()
        args = (True, float(scale * fa.LOG2E), float(scale))
        dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
        dq_walk, dkv_walk = fa.bwd_kernel_blocks(qf, kf)
        if fa.on_sm90(qf):
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
        calls = {
            variant: (lambda variant=variant: fa._kernel_fwd(
                qf, kf, vf, True, scale, variant),
                lambda variant=variant: plain_fwd(qf, kf, vf, True, scale,
                                                  variant),
                attention_work(b * h, s, d, True, 2), lib["fwd"])
            for variant in fa.VARIANTS}
        calls.update({
            "dq": (k_dq, lambda: ref.flash_bwd_dq(qf, kf, vf, gf, lse, delta,
                                                  True, *dq_walk, scale),
                   bwd_work(b * h, s, d, True, 2, "dq"), lib["bwd"]),
            "dkv": (k_dkv, lambda: ref.flash_bwd_dkv(
                qf, kf, vf, gf, lse, delta, True, *dkv_walk, scale),
                bwd_work(b * h, s, d, True, 2, "dkv"), lib["bwd"])})
        for name, (kernel, plain, (ops, nbytes), lib_t) in calls.items():
            kt = time_pair(kernel, iters=20)
            plain_ms = device_ms(plain, 2) or time_ms(plain, 2, 1)
            b_ms, b_by = bound(ops, nbytes, PEAK_BF16_FLOPS)
            rows[f"d{d} {name}"] = (round(kt[2], 5), round(b_ms, 5),
                                    round(plain_ms, 3), round(lib_t[2], 5))
            if d > 128:
                fwd = name in fa.VARIANTS
                family = "dyn" if d == dyn_d else "cc"
                counter = f"flash_{'fwd' if fwd else 'bwd'}_{family}_{name}"
                suffix = "dyn" if d == dyn_d else "d256"
                entries.append({
                    "name": counter, "head_dim": d,
                    "route": "cuda",
                    "source": DYN_SOURCE if d == dyn_d else (
                        CC_FWD_SOURCE if fwd else CC_BWD_SOURCE),
                    "replaces": REPLACES[name],
                    "launches": launches.get(counter, 0),
                    "max_abs_err": errs[f"fwd_{suffix}" if fwd else
                                        f"{name}_{suffix}"],
                    "ms": kt[2], "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_t[2]})
        del o, qs, ks, vs
    fa.reset_launch_counts()
    log(card, f"phase 4: bf16 causal b={b} h={h} s={s}, d 256 on the "
              f"CUDA-core kernels and d {dyn_d} on the run-time-d ones "
              f"beside d 128 on the wgmma ones, (kernel "
              f"ms, bound ms, plain ms, SDPA ms; bwd: SDPA's whole "
              f"backward): {rows}; d{dyn_d} / d256: online "
              f"{rows[f'd{dyn_d} online'][0] / rows['d256 online'][0]:.2f}, "
              f"dq {rows[f'd{dyn_d} dq'][0] / rows['d256 dq'][0]:.2f}, dk/dv "
              f"{rows[f'd{dyn_d} dkv'][0] / rows['d256 dkv'][0]:.2f}; "
              f"d256 / d128: online "
              f"{rows['d256 online'][0] / rows['d128 online'][0]:.2f}, lazy "
              f"{rows['d256 lazy'][0] / rows['d128 lazy'][0]:.2f}, twopass "
              f"{rows['d256 twopass'][0] / rows['d128 twopass'][0]:.2f}, dq "
              f"{rows['d256 dq'][0] / rows['d128 dq'][0]:.2f}, dk/dv "
              f"{rows['d256 dkv'][0] / rows['d128 dkv'][0]:.2f}")
    return entries


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
        dvc = {"kernel": device_ms(kernel), "plain": device_ms(plain),
               "library": device_ms(library)}
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
# train_lm's inner steps on the card: a warm-up window and a timed one
WIRE_STEPS = 2 * train_lm.DEFAULTS["cuda"][2]
WIRE_RATIO_MAX = 0.26
WIRE_RUN_S = 240
W2V_STEPS = 200
W2V_RUN_S = 180
DRILL_LAYERS = 2     # the flagship's width, depth cut for time
DRILL_STEPS, DRILL_EVERY, DRILL_PREEMPT, DRILL_KILL = 10, 2, 3, 6
DRILL_RUN_S = 420
RAGGED = (1, 255, 1000, 4097, 65537)
P3I_DIR = os.path.join(ROOT, "build", "phase3i")


def _module_run(args, env, timeout, name):
    """``python -m`` + ``args`` from the checkout with ``env``; stderr to
    build/phase3i/<name>.err. Returns the JSON lines of stdout; raises,
    with the end of stderr, on a nonzero exit or the deadline."""
    os.makedirs(P3I_DIR, exist_ok=True)
    err_path = os.path.join(P3I_DIR, f"{name}.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m"] + args, cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise AssertionError(f"{name}: no result within {timeout} s; "
                                 f"stderr: {open(err_path).read()[-3000:]}")
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


def run_quantized_wire(card, grad_bytes, layers):
    """Phase 3i (b): hvdrun -np 2 on the one card, train_lm
    --eager-allreduce at full width and depth (b16 x s1024), WIRE_STEPS
    steps a codec. Per rank 12+12+12 launches a step; losses finite and
    falling; encoded wire bytes per step at most WIRE_RATIO_MAX of the
    fp32 gradient bytes; rank 0's last quantized bucket, error feedback
    applied, equal to stacked_wire_allreduce of both ranks' compensated
    inputs."""
    from horovod_tpu_torch.ops import quantization as q
    per_step = {"flash_fwd_lazy": float(layers),
                "flash_bwd_sm90_dq": float(layers),
                "flash_bwd_sm90_dkv": float(layers)}
    ms = {}
    for codec in WIRE_CODECS:
        check = os.path.join(P3I_DIR, f"wire-{codec}")
        args = ["horovod_tpu_torch.run", "-np", "2", "-H", "localhost:2",
                sys.executable, "-m", "horovod_tpu_torch.train_lm",
                "--device", "cuda", "--eager-allreduce", "--windows", "1"]
        if q.is_quantized(codec):
            args += ["--wire-check", check]
        env = dict(os.environ, HOROVOD_COMPRESSION=codec)
        t0 = time.perf_counter()
        out = _module_run(args, env, WIRE_RUN_S, f"wire-{codec}")[-1]
        wall = time.perf_counter() - t0
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
                  f"an interconnect figure), flagship b{TRAIN_BATCH} x "
                  f"s{TRAIN_SEQ}, {WIRE_STEPS} steps: loss "
                  f"{out['loss_first']:.4f} -> {out['loss_last']:.4f}, "
                  f"{out['ms_per_step']:.1f} ms/step, launches "
                  f"{out['launches_per_step']} a step on every rank"
                  f"{note}; {wall:.1f} s wall")
    log(card, "phase 3i (b): ms/step, gloo between two processes on one "
              "card: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return ms


def run_word2vec(card):
    """Phase 3i (c): word2vec --eager on 2 ranks through hvdrun at the
    example's defaults: the loss falls, one step's to_dense of the reduced
    slices equals the dense allreduce of the densified gradients, two
    fused allgather groups a step."""
    out = _module_run(
        ["horovod_tpu_torch.run", "-np", "2", "-H", "localhost:2",
         sys.executable, "-m", "horovod_tpu_torch.word2vec", "--device",
         "cuda", "--eager", "--check-dense", "--steps", str(W2V_STEPS)],
        dict(os.environ), W2V_RUN_S, "word2vec")[-1]
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
              f"RTO (exit to first step) "
              f"{[round(v, 2) for v in report['rto_s']]} s; losses "
              f"{[round(v, 4) for v in losses]}")
    return report


def run_phase_3i(card, dev, model, opt, cfg):
    """Phase 3i, each part fatal and under its own deadline."""
    t0 = time.perf_counter()
    grads = [p for p in model.parameters() if p.requires_grad]
    grad_bytes = sum(p.numel() * 4 for p in grads)
    check_codecs(card, dev, model)
    ckpt = time_checkpoint(card, model, opt)
    torch.cuda.empty_cache()
    log(card, f"phase 3i: this process holds "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card "
              f"while the ranks run")
    ms = run_quantized_wire(card, grad_bytes, cfg.num_layers)
    w2v = run_word2vec(card)
    drill = run_drill(card)
    log(card, f"phase 3i: {time.perf_counter() - t0:.1f} s in all")
    return {"ms": ms, "w2v": w2v, "ckpt": ckpt, "drill": drill}


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

    # ---- phase 1: build
    # the register reports of the wgmma/TMA sources: each alone through
    # nvcc -Xptxas -v, all started beside the extension's build
    ptxas = {}
    for name in ("flash_fwd_sm90", "flash_bwd_sm90", "flash_dyn"):
        cubin = os.path.join(ROOT, "build", "flash_fwd_ab", f"{name}.cubin")
        os.makedirs(os.path.dirname(cubin), exist_ok=True)
        ptxas[name] = subprocess.Popen(
            fwd_ab.nvcc_cmd([os.path.join(_build.CSRC, f"{name}.cu")], cubin,
                            cubin=True),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    _build.extension()
    log(card, f"phase 1: built {list(_build.SOURCES)} for sm_90a in "
              f"{time.perf_counter() - t0:.1f} s")
    # 24 forward instantiations (d x walk x warpgroups), 12 backward (dq:
    # d x warpgroups; dk/dv: d); the run-time-d kernels: 6 forward (dtype
    # x walk), 4 backward
    for name, n_kernels in (("flash_fwd_sm90", 24), ("flash_bwd_sm90", 12),
                            ("flash_dyn", 10)):
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
                      if "C7514" in ln or "C7520" in ln]
        note = ("CTAs of 384 threads then move registers to the consumers "
                "with setmaxnreg (producer 24, consumers 240); "
                if "sm90" in name else "")
        log(card, f"phase 1: nvcc -Xptxas -v, {name}.cu: (registers at "
                  f"entry, spill store bytes, spill load bytes) {report}; "
                  f"{note}ptxas 'wgmma serialized' warnings: "
                  f"{serialized or 'none'}")

    # ---- phase 2: kernels vs plain versions
    errs = check_kernels(card, dev)
    check_sm90_kernel(card, dev, errs)
    errs.update(check_bwd_kernels(card, dev))
    check_sm90_bwd(card, dev, errs)
    check_partial_tiles_and_head_dims(card, dev, errs)
    check_wide_head_dims(card, dev, errs)
    check_beyond_256(card, dev, errs)
    check_ring_pairs(card, dev, errs)
    # the (rows, C) of every BatchNorm of a ResNet-50 step at batch 32
    step_shapes = vision_bn_shapes(
        models.build("resnet50", norm_impl="tpu", device=dev).train(),
        vision_batch(dev, VISION_BATCH)[0])
    if len(step_shapes) != BN_PER_STEP:
        raise AssertionError(f"ResNet-50 has {len(step_shapes)} BatchNorms")
    errs.update(check_bn_kernels(card, dev, step_shapes))

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

    # ---- phase 3b: train the flagship through the kernels
    hvd.init()
    check_nccl(card, dev)
    train_cfg = train_lm.flagship_config(True)
    t_model, t_opt, t_batch, train_launches, train_losses = train_flagship(
        card, dev, train_cfg)
    launches.update({k: train_launches[k]
                     for k in ("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv")})
    check_train_grads(card, dev, train_cfg, t_batch)

    # ---- phase 3c: train ResNet-50 through the BatchNorm kernels
    launches.update(train_vision(card, dev))
    check_vision_grads(card, dev)

    # ---- phase 3d: the parallel path on one card
    g_model, g_opt, g_step, gspmd_launches = train_gspmd(
        card, dev, train_cfg, t_batch, train_losses)
    ring_launches = check_ring_flash(card, dev)
    check_seq_parallel_fwd(card, dev)
    check_chunked_ce(card, dev, train_cfg)
    log(card, f"phase 3d: launches of this slice's paths: GSPMD flagship "
              f"{gspmd_launches}, ring_flash W={RING_W} {ring_launches}")

    # ---- phase 3e: head dim 256 on the CUDA-core kernels, 384 on the
    # run-time-d ones
    wide_launches = run_wide_heads(card, dev, train_cfg, requests)
    wide_launches.update(run_wide_heads(card, dev, train_cfg, requests,
                                        heads=DYN_HEADS, names=DYN_NAMES))

    # ---- phase 3f: serving on the tensor-parallel mesh
    check_serving_mesh(card, dev, cfg, model, requests)

    # ---- phase 3g: the collective backends
    check_collective_backends(card, dev, t_model, cfg.vocab_size)

    # ---- phase 3h: the eager coordination core
    t3h = time.perf_counter()
    check_eager_core(card, dev)
    check_eager_processes(card)
    run_eager_entry_points(card, dev, train_cfg)
    log(card, f"phase 3h: {time.perf_counter() - t3h:.1f} s in all")

    # ---- phase 3i: the quantized and sparse wire, checkpoint, the drill
    run_phase_3i(card, dev, t_model, t_opt, train_cfg)

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
    time_gspmd(card, dev, g_model, g_opt, g_step, t_batch, multi)
    del g_model, g_opt, g_step
    time_memory_and_remat(card, dev, t_model, t_opt, train_cfg, t_batch)
    kernels.extend(time_bn_kernels(card, dev, step_shapes, launches, errs))
    del t_model, t_opt
    torch.cuda.empty_cache()
    time_ring(card, dev)
    kernels.extend(time_wide_kernels(card, dev, errs, wide_launches))
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

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
