#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device and builds the
kernels from horovod_tpu_torch/csrc/ at first use. Phases, each fatal
on failure:

  1. the card's name and power limit, then the build of both kernel
     sources (flash_fwd.cu, flash_bwd.cu) and its time;
  2. every flash-attention forward kernel (online, lazy, twopass) held
     against its plain PyTorch version on the card, on O and lse, in bf16
     and fp32, causal and not, on unit-scale inputs at the serving shape
     (b=1, h=6, d=128, s=128 and 1024), at b=2 h=12 d=64 s=512, on a
     ragged causal s=1000 and on rising-max adversaries (b=1 h=6 d=128
     s=512, keys ramped so every k tile raises the row max in lazy's
     diagonal-first walk, or in the ascending one). fp32 is held to 2e-5;
     bf16 O to two bf16 ulps plus 1 % of its largest value, bf16 lse to
     1e-3. Then the backward kernels (dq, dk/dv) on dq, dk and dv, on
     unit-scale inputs and dO, in bf16 and fp32, causal and not, at the
     same shapes, a partial tile (s=48), the rising-max adversaries, the
     training shape (b=16 h=6 d=128 s=1024, bf16, causal), and the ragged
     s=1000 through the autograd path; fp32 to rtol 1e-4 / atol 1e-5, bf16
     to two ulps plus 1 % of that gradient's largest magnitude;
  3. the serving path: ServeEngine over GPT-2-small (gpt2_small_tpu, 6 x
     128 heads, full width, bf16, seeded weights) answers requests with
     prompts of 16-960 tokens, so prefill runs both the one-tile (online)
     and the multi-tile (lazy) kernel; a second short run under
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
     (exactly 12 lazy forwards, 12 dq and 12 dk/dv launches), the loss
     finite and falling; then one step's gradients at batch 2 on the
     kernel path against the same step with every launch replaced by its
     plain version (bf16 against each gradient's scale, and fp32);
  4. timings, each printed with the card's name and power limit: the
     kernels against their bounds, plain versions and the library call
     (SDPA, forward and backward), the training step (ms/step, tokens/s,
     MFU, and where its device time goes), prefill and decode.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
there is no CUDA device or the port is not beside this script.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
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
from horovod_tpu_torch import train_lm, trainer  # noqa: E402
from horovod_tpu_torch.models import transformer as tr  # noqa: E402
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.ops import flash_attention_ref as ref  # noqa: E402
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
SOURCE = "horovod_tpu_torch/csrc/flash_fwd.cu"
BWD_SOURCE = "horovod_tpu_torch/csrc/flash_bwd.cu"
REPLACES = {"online": "horovod_tpu/ops/flash_attention.py:129",
            "lazy": "horovod_tpu/ops/flash_attention.py:220",
            "twopass": "horovod_tpu/ops/flash_attention.py:312",
            "dq": "horovod_tpu/ops/flash_attention.py:467",
            "dkv": "horovod_tpu/ops/flash_attention.py:531"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0) +
                               e.time_range.elapsed_us() / 1e3 / iters)
    return sum(by_name.values()) or None, by_name


def device_ms(fn, iters=20):
    return device_profile(fn, iters)[0]


def kernel_class(name):
    """A device kernel's family, from its name."""
    if "flash_" in name:
        return "flash"
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
    return ref.FWD[variant](qf, kf, vf, causal, fa.fit_block(qf.shape[1]),
                            fa.fit_block(kf.shape[1]), scale)


def plain_bwd(qf, kf, vf, dof, lse, delta, causal, scale):
    bq, bk = fa.fit_block(qf.shape[1]), fa.fit_block(kf.shape[1])
    dq = ref.flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal, bq, bk, scale)
    return (dq, *ref.flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal, bq,
                                   bk, scale))


@contextlib.contextmanager
def plain_path():
    """Every kernel launch of the port replaced by its plain PyTorch
    version (the same tile walk), on the card."""
    saved = fa._kernel_fwd, fa._kernel_bwd
    fa._kernel_fwd, fa._kernel_bwd = plain_fwd, plain_bwd
    try:
        yield
    finally:
        fa._kernel_fwd, fa._kernel_bwd = saved


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
        bq = fa.fit_block(shape["s"])
        for variant in fa.VARIANTS:
            out, lse = fa.flash_fwd(q, k, v, causal, variant=variant)
            p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal, bq, bq)
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
    # ragged causal tail: the public entry end-pads 1000 -> 1024
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q, k, v = qkv(50, b=1, s=1000, h=6, d=128, dtype=dtype, device=dev)
        qf, kf, vf = (t.transpose(1, 2).reshape(6, 1000, 128)
                      for t in (q, k, v))
        for variant in fa.VARIANTS:
            out = fa.flash_attention(q, k, v, causal=True, variant=variant,
                                     device=dev)
            p_out, _ = ref.FWD[variant](qf, kf, vf, True, 64, 64)
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


def check_bwd_kernels(card, dev):
    """The backward kernels against their plain versions on dq, dk and
    dv: the forward checks' shapes, a partial tile, the rising-max
    adversaries, the training shape, and the ragged causal s=1000
    through the autograd path (end-padded to 1024, the pad rows' dO 0)."""
    errs = {"dq": 0.0, "dkv": 0.0}
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
              f"dv) passed; max |err| by kernel {errs}; largest error as a "
              f"share of its tolerance by kernel and dtype {share}")
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


def serve(cfg, model, requests, dev):
    queue = AdmissionQueue(max_depth=len(requests) + 1,
                           admission_timeout_s=1e9)
    engine = ServeEngine(cfg, model, num_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, kv_block=SERVE_KV_BLOCK,
                        queue=queue, seed=0, device=dev)
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
    return results, steps, wall


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
                "flash_bwd_dq": cfg.num_layers,
                "flash_bwd_dkv": cfg.num_layers}
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
# phase 4: timings of the training path


def time_bwd_kernels(card, dev, launches, errs):
    """dq and dk/dv at the training shape (b=16, h=6, d=128, causal
    s=1024, bf16): device ms against the bound, their plain versions, and
    SDPA's backward (one call computing dq, dk and dv) as the library
    figure; returns the kernels' JSON entries."""
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
    dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
    calls = {
        "dq": (lambda: ext.flash_bwd_dq(qf, kf, vf, gf, lse, delta, dq,
                                        *args),
               lambda: ref.flash_bwd_dq(qf, kf, vf, gf, lse, delta, True,
                                        fa.BLOCK, fa.BLOCK, scale)),
        "dkv": (lambda: ext.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, dk, dv,
                                          *args),
                lambda: ref.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, True,
                                          fa.BLOCK, fa.BLOCK, scale))}
    # SDPA on [b, h, s, d]; its backward graph is kept, so each call
    # times the backward alone
    qs, ks, vs = (t.reshape(b, h, s, d).detach().requires_grad_(True)
                  for t in (qf, kf, vf))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                         is_causal=True)
    go = gf.reshape(b, h, s, d)

    def library():
        return torch.autograd.grad(o, (qs, ks, vs), go, retain_graph=True)
    lib_dev, lib_ev = device_ms(library), time_ms(library)
    lib_ms = lib_dev if lib_dev is not None else lib_ev
    entries = []
    for name, (kernel, plain) in calls.items():
        ev = {"kernel": time_ms(kernel), "plain": time_ms(plain, 2, 1)}
        dvc = {"kernel": device_ms(kernel), "plain": device_ms(plain, 2)}
        ms = {k_: dvc[k_] if dvc[k_] is not None else ev[k_] for k_ in ev}
        ops, nbytes = bwd_work(b * h, s, d, True, 2, name)
        b_ms, b_by = bound(ops, nbytes, PEAK_BF16_FLOPS)
        entries.append({
            "name": f"flash_bwd_{name}", "route": "cuda",
            "source": BWD_SOURCE, "replaces": REPLACES[name],
            "launches": launches.get(f"flash_bwd_{name}", 0),
            "max_abs_err": errs[name], "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
        log(card, f"phase 4: flash_bwd_{name} bf16 causal b={b} h={h} d={d} "
                  f"s={s}: device ms (profiler) {dvc}, event ms per call "
                  f"{ev}, bound {b_ms:.5f} ms ({b_by}; {ops} operations, "
                  f"{nbytes} bytes)")
    fwd_ms = device_ms(lambda: fa._kernel_fwd(qf, kf, vf, True, scale,
                                              "lazy"))
    sdpa_fwd = device_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True))
    log(card, f"phase 4: at the training shape, SDPA backward (dq, dk, dv in "
              f"one call) device ms {lib_dev} (event {lib_ev:.4f}); the "
              f"lazy forward {fwd_ms} against SDPA's forward {sdpa_fwd}")
    return entries


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
    t0 = time.perf_counter()
    _build.extension()
    log(card, f"phase 1: built {list(_build.SOURCES)} for sm_90a in "
              f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 2: kernels vs plain versions
    errs = check_kernels(card, dev)
    errs.update(check_bwd_kernels(card, dev))

    # ---- phase 3: serve GPT-2-small through the kernels
    cfg = tr.TransformerConfig.gpt2_small_tpu(attention_impl="flash")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    requests = serving_workload()
    fa.reset_launch_counts()
    results, steps, wall = serve(cfg, model, requests, dev)
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
    t_model, t_opt, t_batch, train_launches, _ = train_flagship(
        card, dev, train_cfg)
    launches.update({k: train_launches[k]
                     for k in ("flash_bwd_dq", "flash_bwd_dkv")})
    check_train_grads(card, dev, train_cfg, t_batch)

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
        s = main_s[variant]
        qf, kf, vf = (t[0].transpose(0, 1).contiguous() for t in qkv(
            70, b=1, s=s, h=h, d=d, dtype=torch.bfloat16, device=dev))
        bq = fa.fit_block(s)
        scale = d ** -0.5

        def kernel():
            return fa._kernel_fwd(qf, kf, vf, True, scale, variant)

        def plain():
            return ref.FWD[variant](qf, kf, vf, True, bq, bq, scale)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qf[None], kf[None], vf[None], is_causal=True)
        ev = {"kernel": time_ms(kernel), "plain": time_ms(plain, 3, 1),
              "library": time_ms(library)}
        dv = {"kernel": device_ms(kernel), "plain": device_ms(plain, 3),
              "library": device_ms(library)}
        ms = {k_: dv[k_] if dv[k_] is not None else ev[k_] for k_ in ev}
        ops, nbytes = attention_work(h, s, d, True, 2)
        b_ms, b_by = bound(ops, nbytes, PEAK_BF16_FLOPS)
        kernels.append({
            "name": f"flash_fwd_{variant}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[variant],
            "launches": launches.get(f"flash_fwd_{variant}", 0),
            "max_abs_err": errs[variant], "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": ms["library"]})
        log(card, f"phase 4: {variant} bf16 causal b=1 h={h} d={d} s={s}: "
                  f"device ms (profiler) {dv}, event ms per call {ev}, "
                  f"bound {b_ms:.5f} ms ({b_by}; {ops} operations, "
                  f"{nbytes} bytes)")
    kernels.extend(time_bwd_kernels(card, dev, launches, errs))
    time_training(card, dev, t_model, t_opt, t_batch, train_cfg)
    del t_model, t_opt
    torch.cuda.empty_cache()
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
    for s in (16, 128, 512, 960):
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

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
