"""Build the flash kernels alone and compare them across trees.

    python -m horovod_tpu_torch.ops.flash_fwd_ab [--bwd] [--against DIR ...]
        [--check] [--time]

Needs a CUDA card and nvcc. Compiles the forward sources, ``csrc/flash_fwd.cu``
and, where the tree has it, ``csrc/flash_fwd_sm90.cu`` (or with ``--bwd``
the backward's, ``csrc/flash_bwd.cu`` and, where the tree has it,
``csrc/flash_bwd_sm90.cu``) of this checkout and of each ``--against``
checkout (e.g. the parent commit unpacked with ``git archive``) into one
shared library per tree with ``nvcc -Xptxas -v``, loaded with ctypes, and
prints each kernel's registers and spills: seconds per tree instead of
the full extension build.

Forward: ``--check`` holds each tree's bf16 online, lazy and twopass
kernels against the plain walks (``flash_attention_ref``) at the kernel's
tiles (bf16 O two ulps + 1 % of its largest value, lse 1e-3), partial
last tiles and sq != sk among the cases; ``--time`` prints device ms per
call by torch.profiler and by CUDA events over 50 back-to-back calls,
side by side in one process, at the training shape (b16 h6 s1024 d128
causal) and serving shapes (b1 h6 s16/64/640/960/1024), beside the bound,
SDPA's forward and (for the online walk) its plain version; then an empty
kernel's time launched back to back (the launch floor) and the host µs
per launch. A tree whose ``flash_fwd_sm90.cu`` has no online walk runs
bf16 online on its ``flash_fwd.cu`` (mma.sync), and a tree without
``flash_fwd_sm90.cu`` runs every bf16 walk there.

Backward (``--bwd``): ``--check`` holds each tree's bf16 dq and dk/dv
against the plain walks at the kernels' tiles (two bf16 ulps + 1 % of each
gradient's largest magnitude) at every head dim, both dq CTA shapes,
partial tiles with b·h >= 2, non-causal sq != sk, the rising-max
adversaries and the training shape; ``--time`` prints dq, dk/dv, their
sum and SDPA's whole backward at the training shape, by CUDA events over
50 back-to-back calls and by torch.profiler. A tree without
``flash_bwd_sm90.cu`` runs bf16 on its ``flash_bwd.cu``.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import torch

from . import flash_attention_ref as ref

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")
LOG2E = 1.4426950408889634
WALKS = {"online": 0, "lazy": 1, "twopass": 2}
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
H100_SMS = 132

# An empty kernel and its launcher: the floor under any launch's device time
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void hvd_empty_kernel() {}
extern "C" cudaError_t hvd_launch_empty(cudaStream_t stream) {
  hvd_empty_kernel<<<1, 32, 0, stream>>>();
  return cudaGetLastError();
}
"""


def nvcc_cmd(sources, out, cubin=False):
    """nvcc for sm_90a with the register report (-Xptxas -v)."""
    kind = ["-cubin"] if cubin else ["-shared", "-Xcompiler", "-fPIC"]
    return [NVCC, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
            "-Xptxas", "-v", *kind, "-o", out, *sources]


# mangled type arguments of the kernels' templates
_TYPE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}


def ptxas_report(text):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    nvcc -Xptxas -v output, named by the kernel's template arguments."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            spills = None
            m2 = re.match(r"(flash_\w*?_kernel)I(\w+?)EEv",
                          name[name.rfind("flash_"):])
            if m2:
                targs = [t.group(1) or _TYPE_ARGS[t.group(0)]
                         for t in re.finditer(
                             r"Li(\d+)E|13__nv_bfloat16|f",
                             m2.group(2) + "E")]
                name = f"{m2.group(1)}<{','.join(targs)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), *spills)
            name = None
    return report


def build(sources, label):
    """nvcc of ``sources`` into build/flash_fwd_ab/lib_<label>.so: (the
    loaded library, seconds, ptxas report, ptxas warnings)."""
    out_dir = os.path.join(_ROOT, "build", "flash_fwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib_{label}.so")
    t0 = time.perf_counter()
    r = subprocess.run(nvcc_cmd(sources, so), capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{r.stderr[-4000:]}")
    text = r.stdout + r.stderr
    warnings = sorted({ln.strip() for ln in text.splitlines()
                       if "warning" in ln.lower() or "Performance" in ln})
    return (ctypes.CDLL(so), time.perf_counter() - t0, ptxas_report(text),
            warnings)


class Tree:
    """One checkout's forward kernels, built into build/flash_fwd_ab/."""

    def __init__(self, root, label):
        self.label = label
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        sources = [os.path.join(csrc, "flash_fwd.cu")]
        sm90 = os.path.join(csrc, "flash_fwd_sm90.cu")
        # the bf16 walks this tree runs on the wgmma kernel; the others run
        # on its flash_fwd.cu (mma.sync, 64-row tiles)
        self.sm90_walks = ()
        if os.path.exists(sm90):
            sources.append(sm90)
            with open(sm90) as f:
                online = "kOnlineWalk" in f.read()
            self.sm90_walks = (("online",) if online else ()) + (
                "lazy", "twopass")
        lib, self.build_s, self.report, self.warnings = build(sources, label)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if len(self.sm90_walks) < len(WALKS):
            # bf16 (dtype 1) on flash_fwd.cu
            lib.hvd_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [f, p]
            lib.hvd_flash_fwd.restype = i
        if self.sm90_walks:
            lib.hvd_flash_fwd_sm90.argtypes = [p] * 5 + [i] * 6 + [f, i, p]
            lib.hvd_flash_fwd_sm90.restype = i
        self.lib = lib

    def cta_rows(self, variant, rows):
        """The CTA rows a call walks: ``rows`` on the wgmma kernel (the
        host's pick when None), 64 on the mma.sync one."""
        return (rows or 64) if variant in self.sm90_walks else 64

    def forward(self, q, k, v, causal, variant, cta_rows=64):
        """(O, lse) of bf16 ``[b·h, s, d]`` operands."""
        bh, sq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(bh, sq, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, sq, k.shape[1], d)
        stream = torch.cuda.current_stream().cuda_stream
        scale2 = d ** -0.5 * LOG2E
        if variant in self.sm90_walks:
            err = self.lib.hvd_flash_fwd_sm90(*args, WALKS[variant],
                                              int(causal), scale2, cta_rows,
                                              stream)
        else:
            err = self.lib.hvd_flash_fwd(*args, 1, WALKS[variant],
                                         int(causal), scale2, stream)
        if err:
            raise RuntimeError(f"{self.label} {variant}: configuration error "
                               f"{err}")
        return o, lse

    def blocks(self, variant, cta_rows):
        return (cta_rows, 128) if variant in self.sm90_walks else (64, 64)


def operands(seed, bh, sq, sk, d, k_ramp=None):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(bh, sq, d, generator=g)
    k, v = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
    if k_ramp is not None:
        k = k * k_ramp[None, :, None]
    return [t.cuda().bfloat16() for t in (q, k, v)]


def check(tree):
    """Every case against the plain walk; returns the failures."""
    ramps = {"down": torch.linspace(4.0, 0.5, 512),
             "up": torch.linspace(0.5, 4.0, 512)}
    cases = [(3, 192, 192, d, c, None) for d in (16, 32, 64, 128)
             for c in (True, False)]
    cases += [(6, s, s, 128, c, None) for s in (16, 64, 100, 960, 1000)
              for c in (True, False)]
    cases += [(4, 100, 300, 128, c, None) for c in (True, False)]
    cases += [(4, 192, 320, 128, False, None), (2, 40, 40, 128, True, None)]
    cases += [(6, 512, 512, 128, c, r) for c in (True, False) for r in ramps]
    bad = []
    for n, (bh, sq, sk, d, causal, ramp) in enumerate(cases):
        q, k, v = operands(n, bh, sq, sk, d, ramps.get(ramp))
        for variant in WALKS:
            for rows in ((64, 128) if variant in tree.sm90_walks else (64,)):
                o, lse = tree.forward(q, k, v, causal, variant, rows)
                torch.cuda.synchronize()
                p_o, p_lse = ref.FWD[variant](q, k, v, causal,
                                              *tree.blocks(variant, rows))
                p_o = p_o.float()
                atol = 1e-2 * p_o.abs().max().item()
                o_ok = torch.isfinite(o).all() and (
                    (o.float() - p_o).abs() <= atol + 1.6e-2 * p_o.abs()).all()
                lse_err = (lse - p_lse).abs().max().item()
                if not (o_ok and lse_err <= 1e-3):
                    bad.append((bh, sq, sk, d, causal, ramp, variant, rows,
                                lse_err))
    print(f"{tree.label}: {len(WALKS) * len(cases)} cases x CTA shapes "
          f"checked, failures {bad}", flush=True)
    return bad


def device_ms(fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def forward_bound_ms(bh, s, d):
    """The least time of a causal bf16 forward on the card: 4·d operations
    per visible (q, k) pair at the dense bf16 peak, or q, k, v read and O
    and lse written once at the memory rate, whichever is longer."""
    ops = 4 * d * s * (s + 1) // 2 * bh
    nbytes = (4 * s * d * 2 + 4 * s) * bh
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def launch_floor():
    """(event ms, profiler ms) per launch of an empty kernel launched back
    to back through ctypes: the floor under any kernel's time per call."""
    out_dir = os.path.join(_ROOT, "build", "flash_fwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "empty.cu")
    with open(src, "w") as f:
        f.write(EMPTY_KERNEL)
    so = os.path.join(out_dir, "lib_empty.so")
    r = subprocess.run(nvcc_cmd([src], so), capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"empty kernel: nvcc failed\n{r.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    lib.hvd_launch_empty.argtypes = [ctypes.c_void_p]
    lib.hvd_launch_empty.restype = ctypes.c_int

    def launch():
        if lib.hvd_launch_empty(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the empty kernel did not launch")
    return event_ms(launch, 200, 20), device_ms(launch, 200)


def timings(trees):
    """Device ms per call of each tree's bf16 walks (causal, d 128), by
    profiler and by CUDA events, beside the bound, SDPA's forward and the
    plain online walk at the wgmma kernel's tiles."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, s in ((16, 1024), (1, 16), (1, 64), (1, 640), (1, 960), (1, 1024)):
        bh = b * 6
        q, k, v = operands(9, bh, s, s, 128)
        rows = 128 if bh * -(-s // 128) >= sms else 64
        sdpa = torch.nn.functional.scaled_dot_product_attention
        calls = {"sdpa": lambda: sdpa(
            *(t.view(b, 6, s, 128) for t in (q, k, v)), is_causal=True)}
        for tree in trees:
            for variant in WALKS:
                r = tree.cta_rows(variant, rows)
                calls[f"{tree.label} {variant} ({r} rows)"] = (
                    lambda tree=tree, variant=variant, r=r:
                    tree.forward(q, k, v, True, variant, r))
        row = {name: (round(device_ms(fn), 6), round(event_ms(fn), 6))
               for name, fn in calls.items()}
        plain = (lambda: ref.flash_fwd_online(q, k, v, True, rows, 128))
        row["plain online"] = (round(device_ms(plain, 3), 5),
                               round(event_ms(plain, 3, 1), 5))
        print(f"device ms (profiler, events) b{b} h6 s{s} d128 causal bf16, "
              f"bound {forward_bound_ms(bh, s, 128):.6f} ms: "
              f"{json.dumps(row)}", flush=True)
    ev, prof = launch_floor()
    print(f"empty kernel launched back to back: event ms {ev:.6f}, profiler "
          f"ms {prof:.6f}", flush=True)
    q, k, v = operands(10, 6, 128, 128, 128)
    for tree in trees:
        for variant in ("online", "lazy"):
            for _ in range(20):
                tree.forward(q, k, v, True, variant)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                tree.forward(q, k, v, True, variant)
            us = (time.perf_counter() - t0) / 500 * 1e6
            torch.cuda.synchronize()
            print(f"host us per launch through ctypes, {tree.label} "
                  f"{variant} (b1 h6 s128): {us:.2f}", flush=True)


class BwdTree:
    """One checkout's backward kernels, built into build/flash_fwd_ab/."""

    def __init__(self, root, label):
        self.label = label
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        sources = [os.path.join(csrc, "flash_bwd.cu")]
        self.sm90 = os.path.exists(os.path.join(csrc, "flash_bwd_sm90.cu"))
        if self.sm90:
            sources.append(os.path.join(csrc, "flash_bwd_sm90.cu"))
        lib, self.build_s, self.report, self.warnings = build(
            sources, f"{label}_bwd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if self.sm90:
            lib.hvd_flash_bwd_sm90_dq.argtypes = [p] * 7 + [i] * 5 + [
                f, f, i, p]
            lib.hvd_flash_bwd_sm90_dkv.argtypes = [p] * 8 + [i] * 5 + [
                f, f, p]
            self.fns = (lib.hvd_flash_bwd_sm90_dq, lib.hvd_flash_bwd_sm90_dkv)
        else:   # an older tree: bf16 (dtype 1) on its mma.sync kernels
            lib.hvd_flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [f, f, p]
            lib.hvd_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [f, f, p]
            self.fns = (lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv)
        for fn in self.fns:
            fn.restype = i
        self.lib = lib

    def blocks(self, cta_rows):
        """(dq walk, dk/dv walk) of this tree's bf16 kernels."""
        if self.sm90:
            return (cta_rows, 128), (64, 128)
        return (64, 64), (64, 64)

    def _call(self, fn, ptrs, q, k, causal, cta_rows):
        bh, sq, d = q.shape
        scale = d ** -0.5
        shape = (bh, sq, k.shape[1], d)
        stream = torch.cuda.current_stream().cuda_stream
        if self.sm90:
            tail = (*shape, int(causal), scale * LOG2E, scale)
            tail += (cta_rows,) if fn is self.fns[0] else ()
        else:
            tail = (*shape, 1, int(causal), scale * LOG2E, scale)
        err = fn(*ptrs, *tail, stream)
        if err:
            raise RuntimeError(f"{self.label}: configuration error {err}")

    def dq(self, q, k, v, do, lse, delta, causal, cta_rows=64, out=None):
        dq = torch.empty_like(q) if out is None else out
        self._call(self.fns[0], [t.data_ptr() for t in
                                 (q, k, v, do, lse, delta, dq)],
                   q, k, causal, cta_rows)
        return dq

    def dkv(self, q, k, v, do, lse, delta, causal, out=None):
        dk, dv = (torch.empty_like(k), torch.empty_like(v)) if out is None \
            else out
        self._call(self.fns[1], [t.data_ptr() for t in
                                 (q, k, v, do, lse, delta, dk, dv)],
                   q, k, causal, None)
        return dk, dv


def bwd_operands(seed, bh, sq, sk, d, causal, k_ramp=None):
    """bf16 q, k, v, dO on the card with the plain forward's lse and
    delta = rowsum(dO∘O)."""
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(bh, sq, d, generator=g) for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
    if k_ramp is not None:
        k = k * k_ramp[None, :, None]
    q, k, v, do = (t.cuda().bfloat16() for t in (q, k, v, do))
    out, lse = ref.flash_fwd_online(q, k, v, causal, 64, 64)
    return q, k, v, do, lse, ref.flash_delta(out, do)


def grad_close(got, want):
    """Two bf16 ulps of each value plus 1 % of the gradient's largest
    magnitude; returns the largest error as a share of that."""
    got, want = got.float(), want.float()
    tol = 1e-2 * want.abs().max().item() + 1.6e-2 * want.abs()
    if not torch.isfinite(got).all():
        return float("inf")
    return ((got - want).abs() / tol).max().item()


def bwd_cases():
    """(bh, sq, sk, d, causal, cta_rows, ramp) of the backward checks."""
    cases = []
    for causal in (True, False):
        for d in (16, 32, 64, 128):
            cases.append((3, 192, 192, d, causal, None, None))
        cases.append((6, 960, 960, 128, causal, None, None))
        cases.append((2, 1000, 1000, 64, causal, None, None))
        for rows in (64, 128):
            cases.append((2, 384, 384, 128, causal, rows, None))
            for ramp in ("down", "up"):
                cases.append((6, 512, 512, 128, causal, rows, ramp))
    for rows in (64, 128):
        cases.append((4, 192, 320, 64, False, rows, None))
        cases.append((4, 320, 200, 32, False, rows, None))
    cases.append((96, 1024, 1024, 128, True, None, None))
    return cases


def check_bwd(tree):
    """Every backward case against the plain walks; returns the failures."""
    ramps = {"down": torch.linspace(4.0, 0.5, 512),
             "up": torch.linspace(0.5, 4.0, 512)}
    bad, worst = [], 0.0
    for n, (bh, sq, sk, d, causal, rows, ramp) in enumerate(bwd_cases()):
        q, k, v, do, lse, delta = bwd_operands(700 + n, bh, sq, sk, d, causal,
                                               ramps.get(ramp))
        rows = rows or (128 if bh * -(-sq // 128) >= 132 else 64)
        dq = tree.dq(q, k, v, do, lse, delta, causal, rows)
        dk, dv = tree.dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        dq_walk, dkv_walk = tree.blocks(rows)
        want = (ref.flash_bwd_dq(q, k, v, do, lse, delta, causal, *dq_walk),
                *ref.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                   *dkv_walk))
        shares = [grad_close(a, w) for a, w in zip((dq, dk, dv), want)]
        worst = max(worst, *shares)
        if max(shares) > 1.0:
            bad.append((bh, sq, sk, d, causal, rows, ramp,
                        [round(s_, 3) for s_ in shares]))
    print(f"{tree.label}: {len(bwd_cases())} backward cases (dq, dk, dv) "
          f"checked, largest error as a share of its tolerance "
          f"{worst:.3f}, failures {bad}", flush=True)
    return bad


def event_ms(fn, iters=50, warmup=5):
    """Device ms per call by CUDA events over ``iters`` back-to-back
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bwd_timings(trees):
    b, h, s, d = 16, 6, 1024, 128
    q, k, v, do, lse, delta = bwd_operands(9, b * h, s, s, d, True)
    qs, ks, vs = (t.view(b, h, s, d).detach().requires_grad_(True)
                  for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                         is_causal=True)
    go = do.view(b, h, s, d)
    calls = {"sdpa_bwd": lambda: torch.autograd.grad(
        o, (qs, ks, vs), go, retain_graph=True)}
    for tree in trees:
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rows = 128 if tree.sm90 else 64

        def f_dq(tree=tree, dq=dq, rows=rows):
            tree.dq(q, k, v, do, lse, delta, True, rows, out=dq)

        def f_dkv(tree=tree, dk=dk, dv=dv):
            tree.dkv(q, k, v, do, lse, delta, True, out=(dk, dv))
        calls[f"{tree.label} dq"] = f_dq
        calls[f"{tree.label} dkv"] = f_dkv
        calls[f"{tree.label} dq+dkv"] = lambda f_dq=f_dq, f_dkv=f_dkv: (
            f_dq(), f_dkv())
    for name, fn in calls.items():
        ev, prof = event_ms(fn), device_ms(fn, 50)
        print(f"bwd b{b} h{h} s{s} d{d} causal bf16 {name}: event ms "
              f"{ev:.5f}, profiler ms {prof:.5f}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", nargs="*", default=[],
                        help="other checkouts to build and compare")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--bwd", action="store_true",
                        help="the backward kernels instead of the forward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    kind = BwdTree if args.bwd else Tree
    trees = [kind(_ROOT, "this")]
    trees += [kind(os.path.abspath(d), os.path.basename(os.path.normpath(d)))
              for d in args.against]
    for tree in trees:
        print(f"{tree.label}: built in {tree.build_s:.1f} s; (registers, "
              f"spill store bytes, spill load bytes): {tree.report}; "
              f"compiler warnings {tree.warnings}", flush=True)
    failures = 0
    if args.check:
        failures = sum(len((check_bwd if args.bwd else check)(t))
                       for t in trees)
    if args.time:
        (bwd_timings if args.bwd else timings)(trees)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
