#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device and builds the
kernels from horovod_tpu_torch/csrc/ at first use. Phases, each fatal
on failure:

  1. the card's name and power limit, then the kernel build and its time;
  2. every flash-attention forward kernel (online, lazy, twopass) held
     against its plain PyTorch version on the card, on O and lse, in bf16
     and fp32, causal and not, on unit-scale inputs at the serving shape
     (b=1, h=6, d=128, s=128 and 1024), at b=2 h=12 d=64 s=512, on a
     ragged causal s=1000 and on rising-max adversaries (b=1 h=6 d=128
     s=512, keys ramped so every k tile raises the row max in lazy's
     diagonal-first walk, or in the ascending one). fp32 is held to 2e-5;
     bf16 O to two bf16 ulps plus 1 % of its largest value, bf16 lse to
     1e-3;
  3. the serving path: ServeEngine over GPT-2-small (gpt2_small_tpu, 6 x
     128 heads, full width, bf16, seeded weights) answers requests with
     prompts of 16-960 tokens, so prefill runs both the one-tile (online)
     and the multi-tile (lazy) kernel; a second short run under
     HVD_FLASH_VARIANT=twopass drives the twopass kernel. Launch counts
     are zeroed just before each run and read just after. Every request
     must complete with no KV block leaked; first-token logits of the
     kernel path must match the plain path; in fp32 the cached greedy
     tokens must equal no-cache greedy;
  4. timings, each printed with the card's name and power limit.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
there is no CUDA device or the port is not beside this script.
"""

import dataclasses
import json
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
REPLACES = {"online": "horovod_tpu/ops/flash_attention.py:129",
            "lazy": "horovod_tpu/ops/flash_attention.py:220",
            "twopass": "horovod_tpu/ops/flash_attention.py:312"}


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
    def plain_fwd(qf, kf, vf, causal, scale, variant):
        return ref.FWD[variant](qf, kf, vf, causal, fa.fit_block(
            qf.shape[1]), fa.fit_block(kf.shape[1]), scale)

    def first_logits(c, m, toks):
        got = prefill_forward(c, m, toks)[0][0, -1]
        kernel_fwd, fa._kernel_fwd = fa._kernel_fwd, plain_fwd
        try:
            want = prefill_forward(c, m, toks)[0][0, -1]
        finally:
            fa._kernel_fwd = kernel_fwd
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
            logits = model32(torch.tensor([toks], device=dev))
            toks.append(int(torch.argmax(logits[0, -1])))
        if toks[len(r.prompt):] != cached[r.request_id]:
            raise AssertionError(f"{r.request_id}: cached greedy "
                                 f"{cached[r.request_id]} != no-cache "
                                 f"{toks[len(r.prompt):]}")
    log(card, "phase 3: fp32 cached greedy == no-cache greedy on 2 requests")
    del model32

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
