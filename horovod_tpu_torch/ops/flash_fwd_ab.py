"""Build the flash forward kernels alone and compare them across trees.

    python -m horovod_tpu_torch.ops.flash_fwd_ab [--against DIR ...]
        [--check] [--time]

Needs a CUDA card and nvcc. Compiles ``csrc/flash_fwd.cu`` and, where
the tree has it, ``csrc/flash_fwd_sm90.cu`` of this checkout (and of each
``--against`` checkout, e.g. the parent commit unpacked with ``git
archive``) into one shared library per tree with ``nvcc -Xptxas -v``,
loaded with ctypes, and prints each kernel's registers and spills:
seconds per tree instead of the full extension build. ``--check`` holds
each tree's bf16 lazy and twopass kernel against the plain walks
(``flash_attention_ref``) at the kernel's tiles (bf16 O two ulps + 1 % of
its largest value, lse 1e-3); ``--time`` prints torch.profiler device ms
per call, side by side in one process, at the training shape (b16 h6
s1024 d128 causal) and serving shapes (b1 h6 s640/960/1024), beside
SDPA's forward, and the host µs per launch. A tree without
``flash_fwd_sm90.cu`` runs bf16 lazy and twopass on its ``flash_fwd.cu``.
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


def nvcc_cmd(sources, out, cubin=False):
    """nvcc for sm_90a with the register report (-Xptxas -v)."""
    kind = ["-cubin"] if cubin else ["-shared", "-Xcompiler", "-fPIC"]
    return [NVCC, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
            "-Xptxas", "-v", *kind, "-o", out, *sources]


def ptxas_report(text):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    nvcc -Xptxas -v output, named by the kernel's template arguments."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            spills = None
            m2 = re.match(r"(flash_fwd\w*?_kernel)I(\w+?)EEv",
                          name[name.rfind("flash_fwd"):])
            if m2:
                targs = re.findall(r"Li(\d+)E", m2.group(2) + "E")
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


class Tree:
    """One checkout's forward kernels, built into build/flash_fwd_ab/."""

    def __init__(self, root, label):
        self.label = label
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        sources = [os.path.join(csrc, "flash_fwd.cu")]
        self.sm90 = os.path.exists(os.path.join(csrc, "flash_fwd_sm90.cu"))
        if self.sm90:
            sources.append(os.path.join(csrc, "flash_fwd_sm90.cu"))
        out_dir = os.path.join(_ROOT, "build", "flash_fwd_ab")
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"lib_{label}.so")
        t0 = time.perf_counter()
        r = subprocess.run(nvcc_cmd(sources, so), capture_output=True,
                           text=True)
        if r.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{r.stderr[-4000:]}")
        self.build_s = time.perf_counter() - t0
        self.report = ptxas_report(r.stdout + r.stderr)
        self.warnings = sorted({ln.strip() for ln in
                                (r.stdout + r.stderr).splitlines()
                                if "warning" in ln.lower() or
                                "Performance" in ln})
        lib = ctypes.CDLL(so)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hvd_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [f, p]
        lib.hvd_flash_fwd.restype = i
        if self.sm90:
            lib.hvd_flash_fwd_sm90.argtypes = [p] * 5 + [i] * 6 + [f, i, p]
            lib.hvd_flash_fwd_sm90.restype = i
        self.lib = lib

    def forward(self, q, k, v, causal, variant, cta_rows=64):
        """(O, lse) of bf16 ``[b·h, s, d]`` operands."""
        bh, sq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(bh, sq, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, sq, k.shape[1], d)
        stream = torch.cuda.current_stream().cuda_stream
        scale2 = d ** -0.5 * LOG2E
        if self.sm90 and variant != "online":
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
        return (cta_rows, 128) if self.sm90 and variant != "online" else \
            (64, 64)


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
    cases += [(6, 960, 960, 128, c, None) for c in (True, False)]
    cases += [(4, 192, 320, 128, False, None), (2, 40, 40, 128, True, None)]
    cases += [(6, 512, 512, 128, c, r) for c in (True, False) for r in ramps]
    bad = []
    for n, (bh, sq, sk, d, causal, ramp) in enumerate(cases):
        q, k, v = operands(n, bh, sq, sk, d, ramps.get(ramp))
        for variant in ("lazy", "twopass"):
            for rows in ((64, 128) if tree.sm90 else (64,)):
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
    print(f"{tree.label}: {2 * len(cases)} cases x CTA shapes checked, "
          f"failures {bad}", flush=True)
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


def timings(trees):
    for b, s in ((16, 1024), (1, 960), (1, 640), (1, 1024)):
        q, k, v = operands(9, b * 6, s, s, 128)
        row = {"sdpa": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *(t.view(b, 6, s, 128) for t in (q, k, v)), is_causal=True))}
        for tree in trees:
            for variant in ("lazy", "twopass"):
                for rows in ((64, 128) if tree.sm90 else (64,)):
                    row[f"{tree.label} {variant} {rows}"] = device_ms(
                        lambda: tree.forward(q, k, v, True, variant, rows))
        print(f"device ms b{b} h6 s{s} d128 causal bf16: "
              f"{json.dumps({k_: round(x, 5) for k_, x in row.items()})}",
              flush=True)
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", nargs="*", default=[],
                        help="other checkouts to build and compare")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--time", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    trees = [Tree(_ROOT, "this")]
    trees += [Tree(os.path.abspath(d), os.path.basename(os.path.normpath(d)))
              for d in args.against]
    for tree in trees:
        print(f"{tree.label}: built in {tree.build_s:.1f} s; (registers, "
              f"spill store bytes, spill load bytes): {tree.report}; "
              f"compiler warnings {tree.warnings}", flush=True)
    failures = sum(len(check(t)) for t in trees) if args.check else 0
    if args.time:
        timings(trees)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
