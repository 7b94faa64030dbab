"""Build the flash kernels alone and compare them across trees.

    python -m horovod_tpu_torch.ops.flash_fwd_ab [--bwd] [--against DIR ...]
        [--check] [--time] [--wide] [--probe]

Needs a CUDA card and nvcc. Compiles the forward sources,
``csrc/flash_fwd.cu``, ``csrc/flash_dyn.cu`` and, where the tree has them,
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_fwd_sm90_dyn.cu`` (or with ``--bwd``
the backward's, ``csrc/flash_bwd.cu`` and, where the tree has it,
``csrc/flash_bwd_sm90.cu``) of this checkout and of each ``--against``
checkout (e.g. the parent commit unpacked with ``git archive``) into one
shared library per tree with ``nvcc -Xptxas -v`` (every source of every
tree its own nvcc, all started together), loaded with ctypes, and prints
each kernel's registers and spills: a minute or two instead of the full
extension build.

Forward: ``--check`` holds each tree's bf16 online, lazy and twopass
kernels against the plain walks (``flash_attention_ref``) at the kernel's
tiles (bf16 O two ulps + 1 % of its largest value, lse 1e-3), partial
last tiles and sq != sk among the cases, at head dims 16-128, 256 and
288/384/512 (both CTA shapes where they fit, the rising-max adversaries),
and its fp32 walks at d 128 and 256 (2e-5; partial tiles, sq != sk, the
adversaries); ``--time`` prints device ms per call by torch.profiler and
by CUDA events over 50 back-to-back calls, side by side in one process,
at the training shape (b16 h6 s1024 d128 causal), serving shapes (b1 h6
s16/64/640/960/1024) and b4 h6 s1024 causal at bf16 d 256 and 384 and
fp32 d 128 and 256 (``--wide``: those four alone), beside the bound,
SDPA's forward in the same dtype and (for the online walk) its plain
version; then an empty kernel's time launched back to back (the launch
floor) and the host µs per launch. A tree whose ``flash_fwd_sm90.cu`` has
no online walk runs bf16 online on its ``flash_fwd.cu`` (mma.sync), a
tree without ``flash_fwd_sm90.cu`` runs every bf16 walk there, a tree
whose ``flash_fwd_sm90.cu`` stops at head dim 128 runs bf16 d 256 on its
``flash_fwd.cu`` (the CUDA cores), and a tree without
``flash_fwd_sm90_dyn.cu`` runs bf16 above 256 on its ``flash_dyn.cu``.

``--probe`` first times 16-byte shared loads in the lane patterns of the
fp32 forward's loops, and FFMA, in cycles per warp instruction per SM,
and prints each loop's loads against its FMAs per step.

Backward (``--bwd``): ``--check`` holds each tree's bf16 dq and dk/dv
against the plain walks at the kernels' tiles (two bf16 ulps + 1 % of each
gradient's largest magnitude) at every head dim, both dq CTA shapes,
partial tiles with b·h >= 2, non-causal sq != sk, the rising-max
adversaries and the training shape, and at head dim 256; ``--time``
prints dq, dk/dv, their sum and SDPA's whole backward at the training
shape and at head dim 256 (b4 h6 s1024 causal), by CUDA events over 50
back-to-back calls and by torch.profiler. A tree without
``flash_bwd_sm90.cu`` runs bf16 on its ``flash_bwd.cu``, and a tree whose
``flash_bwd_sm90.cu`` stops at head dim 128 runs bf16 d 256 there.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import torch

from . import flash_attention as fa
from . import flash_attention_ref as ref

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")
LOG2E = 1.4426950408889634
WALKS = {"online": 0, "lazy": 1, "twopass": 2}
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12    # and fp32 on the CUDA cores
PEAK_BYTES = 3.35e12
H100_SMS = 132
CUDA_ERROR_INVALID_VALUE = 1

# An empty kernel and its launcher: the floor under any launch's device time
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void hvd_empty_kernel() {}
extern "C" cudaError_t hvd_launch_empty(cudaStream_t stream) {
  hvd_empty_kernel<<<1, 32, 0, stream>>>();
  return cudaGetLastError();
}
"""


# Shared-memory loads by the lanes' access pattern, and FFMA beside them:
# cycles per warp instruction per SM, by clock64 in one block of 32 warps
# on every SM
SMEM_PROBE = r"""
#include <cuda_runtime.h>
// a lane's float offset in one warp-wide 16-byte load of pattern pat
__device__ int lane_base(int pat, int lane) {
  switch (pat) {
    case 0: return 4 * lane;           // 32 neighbouring float4s
    case 1: return 36 * (lane & 15);   // 16 rows 36 floats apart, 2 lanes each
    case 2: return 68 * (lane >> 4);   // 2 addresses
    default: return 0;                 // 1 address
  }
}
__global__ void __launch_bounds__(1024) hvd_lds_probe(int pat, float* out,
                                                      long long* cyc,
                                                      int iters) {
  __shared__ __align__(16) float sm[12288];
  for (int i = threadIdx.x; i < 12288; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  const int base = lane_base(pat, threadIdx.x & 31) +
                   ((threadIdx.x >> 5) & 7) * 1024;
  float acc[8] = {0};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(sm + base + u * 128);
      acc[u] += v.x + v.y + v.z + v.w;
    }
    __syncwarp();
  }
  const long long t1 = clock64();
  float s = 0;
  for (int u = 0; u < 8; ++u) s += acc[u];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
__global__ void __launch_bounds__(1024) hvd_ffma_probe(int, float* out,
                                                       long long* cyc,
                                                       int iters) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 1e-3f + i;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = fmaf(a[i], 0.999f, 0.001f);
  }
  const long long t1 = clock64();
  float s = 0;
  for (int i = 0; i < 16; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
// cycles per warp instruction per SM of pattern pat (-1: FFMA), over
// iters iterations on one block of 1024 threads per SM
extern "C" cudaError_t hvd_smem_probe(int pat, int iters, double* result) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms,
                                           cudaDevAttrMultiProcessorCount, 0);
  if (err != cudaSuccess) return err;
  float* out;
  long long* cyc;
  if ((err = cudaMalloc(&out, sms * 1024 * sizeof(float))) != cudaSuccess)
    return err;
  if ((err = cudaMalloc(&cyc, sms * sizeof(long long))) != cudaSuccess)
    return err;
  auto kernel = pat < 0 ? hvd_ffma_probe : hvd_lds_probe;
  kernel<<<sms, 1024>>>(pat, out, cyc, 16);   // warm-up
  kernel<<<sms, 1024>>>(pat, out, cyc, iters);
  long long* host = new long long[sms];
  err = cudaMemcpy(host, cyc, sms * sizeof(long long),
                   cudaMemcpyDeviceToHost);
  double mean = 0;
  for (int i = 0; i < sms; ++i) mean += host[i];
  delete[] host;
  cudaFree(out);
  cudaFree(cyc);
  // warp instructions per SM: 32 warps x iters x (16 FFMA or 8 loads)
  *result = mean / sms / (32.0 * iters * (pat < 0 ? 16 : 8));
  return err != cudaSuccess ? err : cudaGetLastError();
}
"""
PROBE_PATTERNS = {"32 neighbouring float4s": 0,
                  "16 rows 36 floats apart": 1, "2 addresses": 2,
                  "1 address": 3, "FFMA": -1}


def smem_probe(iters=4096):
    """{pattern: cycles per warp instruction per SM} of 16-byte shared
    loads (LDS.128) in the lane patterns of the fp32 forward's loops, and
    of FFMA; then those loops' loads against their FMAs per step."""
    out_dir = os.path.join(_ROOT, "build", "flash_fwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "smem_probe.cu")
    with open(src, "w") as f:
        f.write(SMEM_PROBE)
    so = os.path.join(out_dir, "lib_smem_probe.so")
    r = subprocess.run(nvcc_cmd([src], so), capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"smem probe: nvcc failed\n{r.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    lib.hvd_smem_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_double)]
    lib.hvd_smem_probe.restype = ctypes.c_int
    cycles = {}
    for name, pat in PROBE_PATTERNS.items():
        x = ctypes.c_double()
        err = lib.hvd_smem_probe(pat, iters, ctypes.byref(x))
        if err:
            raise RuntimeError(f"smem probe {name}: CUDA error {err}")
        cycles[name] = round(x.value, 4)
    c = cycles
    # flash_fwd.cu's S = Q K^T per 4 columns of d: 4 loads of Q rows (the
    # 16 lanes of a half-warp share a row), 8 of K rows (16 a warp, rows
    # 36 floats apart), 128 FFMA; its O += P V at d 256 per 4 keys: 8
    # loads of P (one row a warp), 8 of V (32 neighbouring), 256 FFMA
    s_lds = 4 * c["2 addresses"] + 8 * c["16 rows 36 floats apart"]
    o_lds = 8 * c["1 address"] + 8 * c["32 neighbouring float4s"]
    print(f"smem probe, cycles per warp instruction per SM: {cycles}; "
          f"fp32 forward S step: 12 LDS.128 {s_lds:.2f} cycles against 128 "
          f"FFMA {128 * c['FFMA']:.2f} ({s_lds / (128 * c['FFMA']):.2f}); "
          f"P V step at d 256: 16 LDS.128 {o_lds:.2f} against 256 FFMA "
          f"{256 * c['FFMA']:.2f} ({o_lds / (256 * c['FFMA']):.2f})",
          flush=True)
    return cycles

def nvcc_cmd(sources, out, cubin=False, obj=False):
    """nvcc for sm_90a with the register report (-Xptxas -v): a shared
    library, a cubin or (``obj``) one relocatable object."""
    kind = (["-cubin"] if cubin else ["-c", "-Xcompiler", "-fPIC"] if obj
            else ["-shared", "-Xcompiler", "-fPIC"])
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


def build_many(jobs):
    """nvcc of every (label, sources) job into
    build/flash_fwd_ab/lib_<label>.so: one process per source, all started
    together, then one link per job. {label: (the loaded library, seconds
    to its link, ptxas report, ptxas warnings)}."""
    out_dir = os.path.join(_ROOT, "build", "flash_fwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = [(label, obj, subprocess.Popen(
        nvcc_cmd([src], obj, obj=True), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for label, sources in jobs
        for obj, src in ((os.path.join(out_dir, f"{label}_{i}.o"), src)
                         for i, src in enumerate(sources))]
    texts = {label: "" for label, _ in jobs}
    objs = {label: [] for label, _ in jobs}
    failed = []
    for label, obj, proc in procs:
        out, _ = proc.communicate()
        texts[label] += out
        objs[label].append(obj)
        if proc.returncode:
            failed.append(f"{label}: nvcc failed on {obj}\n{out[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    built = {}
    for label, _ in jobs:
        so = os.path.join(out_dir, f"lib_{label}.so")
        r = subprocess.run([NVCC, "-shared", "-o", so, *objs[label]],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"{label}: link failed\n{r.stderr[-4000:]}")
        text = texts[label]
        warnings = sorted({ln.strip() for ln in text.splitlines()
                           if "warning" in ln.lower() or "Performance" in ln})
        built[label] = (ctypes.CDLL(so), time.perf_counter() - t0,
                        ptxas_report(text), warnings)
    return built


class Tree:
    """One checkout's forward kernels, built into build/flash_fwd_ab/."""

    suffix = ""

    @staticmethod
    def sources(root):
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        return [p for p in (os.path.join(csrc, f) for f in (
            "flash_fwd.cu", "flash_dyn.cu", "flash_fwd_sm90.cu",
            "flash_fwd_sm90_dyn.cu")) if os.path.exists(p)]

    def __init__(self, root, label, built):
        self.label = label
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        sm90 = os.path.join(csrc, "flash_fwd_sm90.cu")
        self.sm90dyn = os.path.exists(os.path.join(csrc,
                                                   "flash_fwd_sm90_dyn.cu"))
        # the bf16 walks this tree runs on the wgmma kernel; the others run
        # on its flash_fwd.cu (mma.sync, 64-row tiles)
        self.sm90_walks = ()
        self.sm90_max_d = 128
        if os.path.exists(sm90):
            with open(sm90) as f:
                online = "kOnlineWalk" in f.read()
            self.sm90_walks = (("online",) if online else ()) + (
                "lazy", "twopass")
        lib, self.build_s, self.report, self.warnings = built
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # keys per k tile of the fp32 forward, as the built library reports
        # them; a library without the symbol predates the register-blocked
        # kernel and walks 64
        try:
            block_k = lib.hvd_flash_fwd_block_k
        except AttributeError:
            self.cc_block_k = 64
        else:
            block_k.argtypes, block_k.restype = [], i
            self.cc_block_k = block_k()
        if self.sm90_walks:
            lib.hvd_flash_fwd_sm90.argtypes = [p] * 5 + [i] * 6 + [f, i, p]
            lib.hvd_flash_fwd_sm90.restype = i
            self.sm90_max_d = self._sm90_max_d(lib)
        # fp32 (dtype 0), and bf16 (1) where a tree runs it there
        lib.hvd_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [f, p]
        lib.hvd_flash_fwd.restype = i
        lib.hvd_flash_fwd_dyn.argtypes = [p] * 6 + [i] * 7 + [f, p]
        lib.hvd_flash_fwd_dyn.restype = i
        if self.sm90dyn:
            lib.hvd_flash_fwd_sm90_dyn.argtypes = [p] * 5 + [i] * 6 + [
                f, i, p]
            lib.hvd_flash_fwd_sm90_dyn.restype = i
        self.lib = lib

    def _sm90_max_d(self, lib):
        """The largest head dim the built wgmma forward takes: a d-256
        call on a tiny input either runs (256) or is refused with
        cudaErrorInvalidValue (128)."""
        q = torch.zeros(1, 64, 256, dtype=torch.bfloat16, device="cuda")
        o = torch.empty_like(q)
        lse = torch.empty(1, 64, device="cuda")
        err = lib.hvd_flash_fwd_sm90(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 1, 64, 64, 256, WALKS["lazy"], 1, LOG2E / 16, 64,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err not in (0, CUDA_ERROR_INVALID_VALUE):
            raise RuntimeError(f"{self.label}: the d-256 probe of "
                               f"hvd_flash_fwd_sm90 returned {err}")
        return 256 if err == 0 else 128

    def on_sm90(self, variant, d):
        return variant in self.sm90_walks and d <= self.sm90_max_d

    def on_sm90dyn(self, d, dtype=torch.bfloat16):
        return (self.sm90dyn and dtype == torch.bfloat16 and
                256 < d <= fa.SM90_DYN_MAX_HEAD_DIM)

    def cta_rows(self, variant, rows, d=128, dtype=torch.bfloat16):
        """The CTA rows a call walks: ``rows`` on a wgmma kernel (the
        host's pick when None), 64 on the mma.sync and CUDA-core ones,
        32 on flash_dyn.cu's."""
        if dtype == torch.bfloat16 and (self.on_sm90(variant, d) or
                                        self.on_sm90dyn(d)):
            return rows or 64
        return 32 if d > 256 else 64

    def forward(self, q, k, v, causal, variant, cta_rows=64):
        """(O, lse) of bf16 or fp32 ``[b·h, s, d]`` operands."""
        bh, sq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(bh, sq, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, sq, k.shape[1], d)
        stream = torch.cuda.current_stream().cuda_stream
        scale2 = d ** -0.5 * LOG2E
        walk = (WALKS[variant], int(causal), scale2)
        dtype = 0 if q.dtype == torch.float32 else 1
        if self.on_sm90dyn(d, q.dtype):
            err = self.lib.hvd_flash_fwd_sm90_dyn(*args, *walk, cta_rows,
                                                  stream)
        elif d > 256:
            err = self.lib.hvd_flash_fwd_dyn(*args[:5], None, *args[5:],
                                             dtype, *walk, stream)
        elif dtype == 1 and self.on_sm90(variant, d):
            err = self.lib.hvd_flash_fwd_sm90(*args, *walk, cta_rows,
                                              stream)
        else:
            err = self.lib.hvd_flash_fwd(*args, dtype, *walk, stream)
        if err:
            raise RuntimeError(f"{self.label} {variant}: configuration error "
                               f"{err}")
        return o, lse

    def blocks(self, variant, cta_rows, d=128, dtype=torch.bfloat16):
        rows = self.cta_rows(variant, cta_rows, d, dtype)
        if dtype == torch.bfloat16 and self.on_sm90(variant, d):
            return rows, (128 if d <= 128 else 64)
        if self.on_sm90dyn(d, dtype):
            return rows, 64
        if dtype == torch.float32 and d <= 256:
            return rows, self.cc_block_k
        return rows, rows


def operands(seed, bh, sq, sk, d, k_ramp=None, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(bh, sq, d, generator=g)
    k, v = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
    if k_ramp is not None:
        k = k * k_ramp[None, :, None]
    return [t.cuda().to(dtype) for t in (q, k, v)]


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
    # head dim 256: 64-key tiles on the wgmma kernel
    cases += [(3, 192, 192, 256, c, None) for c in (True, False)]
    cases += [(2, s, s, 256, c, None) for s in (64, 200, 1000)
              for c in (True, False)]
    cases += [(4, 100, 300, 256, c, None) for c in (True, False)]
    cases += [(6, 512, 512, 256, c, r) for c in (True, False) for r in ramps]
    cases = [(*c, torch.bfloat16) for c in cases]
    # above 256: the run-time-d wgmma kernel's slices (d 288 ends in a
    # partial box), partial tiles, sq != sk, the adversaries; fp32 on the
    # CUDA cores at d 128 and 256
    for d, dtype in ((288, torch.bfloat16), (384, torch.bfloat16),
                     (512, torch.bfloat16), (128, torch.float32),
                     (256, torch.float32)):
        cases += [(2, 130, 130, d, True, None, dtype),
                  (2, 64, 200, d, False, None, dtype),
                  (4, 100, 300, d, True, None, dtype)]
        cases += [(6, 512, 512, d, c, r, dtype) for c in (True, False)
                  for r in ramps]
    bad, n_cmp = [], 0
    for n, (bh, sq, sk, d, causal, ramp, dtype) in enumerate(cases):
        q, k, v = operands(n, bh, sq, sk, d, ramps.get(ramp), dtype)
        for variant in WALKS:
            shapes = ((64, 128) if dtype == torch.bfloat16 and (
                tree.on_sm90(variant, d) or (tree.on_sm90dyn(d) and
                                             fa.sm90dyn_fits(d, 128)))
                else (64,))
            for rows in shapes:
                o, lse = tree.forward(q, k, v, causal, variant, rows)
                torch.cuda.synchronize()
                blocks = tree.blocks(variant, rows, d, dtype)
                p_o, p_lse = ref.FWD[variant](q, k, v, causal, *blocks)
                p_o = p_o.float()
                if dtype == torch.float32:
                    atol = rtol = lse_tol = 2e-5
                else:
                    atol, rtol = 1e-2 * p_o.abs().max().item(), 1.6e-2
                    lse_tol = 1e-3
                o_ok = torch.isfinite(o).all() and (
                    (o.float() - p_o).abs() <= atol + rtol * p_o.abs()).all()
                lse_err = (lse - p_lse).abs().max().item()
                lse_rtol = rtol if dtype == torch.float32 else 0.0
                lse_ok = ((lse - p_lse).abs() <=
                          lse_tol + lse_rtol * p_lse.abs()).all()
                n_cmp += 1
                if not (o_ok and lse_ok):
                    bad.append((bh, sq, sk, d, str(dtype)[6:], causal, ramp,
                                variant, blocks, lse_err))
    print(f"{tree.label}: {n_cmp} forward cases (walk x CTA shape) checked, "
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


def forward_bound_ms(bh, s, d, dtype=torch.bfloat16):
    """The least time of a causal forward on the card: 4·d operations per
    visible (q, k) pair at the dtype's peak (dense bf16 tensor cores, or
    fp32 on the CUDA cores), or q, k, v read and O and lse written once at
    the memory rate, whichever is longer."""
    ops = 4 * d * s * (s + 1) // 2 * bh
    nbytes = (4 * s * d * dtype.itemsize + 4 * s) * bh
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    return max(ops / peak, nbytes / PEAK_BYTES) * 1e3


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


WIDE_SHAPES = ((4, 1024, 256, torch.bfloat16), (4, 1024, 384, torch.bfloat16),
               (4, 1024, 128, torch.float32), (4, 1024, 256, torch.float32))


def timings(trees, wide_only=False):
    """Device ms per call of each tree's walks (causal), by profiler and by
    CUDA events, beside the bound, SDPA's forward in the same dtype and
    the plain online walk at the first tree's tiles."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = WIDE_SHAPES if wide_only else tuple(
        (b, s, 128, torch.bfloat16) for b, s in (
            (16, 1024), (1, 16), (1, 64), (1, 640), (1, 960), (1, 1024))
    ) + WIDE_SHAPES
    for b, s, d, dtype in shapes:
        bh = b * 6
        q, k, v = operands(9, bh, s, s, d, dtype=dtype)
        rows = (fa.sm90dyn_cta_rows(bh, s, d, sms) if d > 256 else
                128 if bh * -(-s // 128) >= sms else 64)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        calls = {"sdpa": lambda: sdpa(
            *(t.view(b, 6, s, d) for t in (q, k, v)), is_causal=True)}
        for tree in trees:
            for variant in WALKS:
                r = tree.cta_rows(variant, rows, d, dtype)
                calls[f"{tree.label} {variant} ({r} rows)"] = (
                    lambda tree=tree, variant=variant, r=r:
                    tree.forward(q, k, v, True, variant, r))
        row = {name: (round(device_ms(fn), 6), round(event_ms(fn), 6))
               for name, fn in calls.items()}
        blocks = trees[0].blocks("online", rows, d, dtype)
        plain = (lambda: ref.flash_fwd_online(q, k, v, True, *blocks))
        row["plain online"] = (round(device_ms(plain, 3), 5),
                               round(event_ms(plain, 3, 1), 5))
        print(f"device ms (profiler, events) b{b} h6 s{s} d{d} causal "
              f"{str(dtype)[6:]}, bound "
              f"{forward_bound_ms(bh, s, d, dtype):.6f} ms: "
              f"{json.dumps(row)}", flush=True)
    if wide_only:
        return
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

    suffix = "_bwd"

    @staticmethod
    def sources(root):
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        return [p for p in (os.path.join(csrc, f) for f in (
            "flash_bwd.cu", "flash_bwd_sm90.cu")) if os.path.exists(p)]

    def __init__(self, root, label, built):
        self.label = label
        csrc = os.path.join(root, "horovod_tpu_torch", "csrc")
        self.sm90 = os.path.exists(os.path.join(csrc, "flash_bwd_sm90.cu"))
        lib, self.build_s, self.report, self.warnings = built
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.sm90_max_d = 0
        self.fns = self.cc_fns = None
        if self.sm90:
            lib.hvd_flash_bwd_sm90_dq.argtypes = [p] * 7 + [i] * 5 + [
                f, f, i, p]
            lib.hvd_flash_bwd_sm90_dkv.argtypes = [p] * 8 + [i] * 5 + [
                f, f, p]
            self.fns = (lib.hvd_flash_bwd_sm90_dq, lib.hvd_flash_bwd_sm90_dkv)
            for fn in self.fns:
                fn.restype = i
            self.sm90_max_d = self._sm90_max_d()
        if self.sm90_max_d < 256:
            # bf16 (dtype 1) on its CUDA-core (once mma.sync) kernels
            lib.hvd_flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [f, f, p]
            lib.hvd_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [f, f, p]
            self.cc_fns = (lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv)
            for fn in self.cc_fns:
                fn.restype = i
        self.lib = lib

    def _sm90_max_d(self):
        """The largest head dim the built wgmma dk/dv takes: a d-256 call
        on a tiny input either runs (256) or is refused with
        cudaErrorInvalidValue (128)."""
        q = torch.zeros(1, 64, 256, dtype=torch.bfloat16, device="cuda")
        lse = torch.zeros(1, 64, device="cuda")
        grads = [torch.empty_like(q) for _ in range(2)]
        err = self.fns[1](*[t.data_ptr() for t in (q, q, q, q, lse, lse,
                                                     *grads)],
                          1, 64, 64, 256, 1, LOG2E / 16, 1 / 16,
                          torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err not in (0, CUDA_ERROR_INVALID_VALUE):
            raise RuntimeError(f"{self.label}: the d-256 probe of "
                               f"hvd_flash_bwd_sm90_dkv returned {err}")
        return 256 if err == 0 else 128

    def on_sm90(self, d):
        return d <= self.sm90_max_d

    def blocks(self, cta_rows, d=128):
        """(dq walk, dk/dv walk) of this tree's bf16 kernels."""
        if self.on_sm90(d):
            if d > 128:
                return (64, 64), (64, 64)
            return (cta_rows, 128), (64, 128)
        walk = (64, 32 if d > 128 else 64)
        return walk, walk

    def _call(self, which, ptrs, q, k, causal, cta_rows):
        bh, sq, d = q.shape
        scale = d ** -0.5
        shape = (bh, sq, k.shape[1], d)
        stream = torch.cuda.current_stream().cuda_stream
        if self.on_sm90(d):
            fn = self.fns[which]
            tail = (*shape, int(causal), scale * LOG2E, scale)
            tail += ((64 if d > 128 else cta_rows),) if which == 0 else ()
        else:
            fn = self.cc_fns[which]
            tail = (*shape, 1, int(causal), scale * LOG2E, scale)
        err = fn(*ptrs, *tail, stream)
        if err:
            raise RuntimeError(f"{self.label}: configuration error {err}")

    def dq(self, q, k, v, do, lse, delta, causal, cta_rows=64, out=None):
        dq = torch.empty_like(q) if out is None else out
        self._call(0, [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
                   q, k, causal, cta_rows)
        return dq

    def dkv(self, q, k, v, do, lse, delta, causal, out=None):
        dk, dv = (torch.empty_like(k), torch.empty_like(v)) if out is None \
            else out
        self._call(1, [t.data_ptr() for t in
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
    # head dim 256
    for causal in (True, False):
        cases.append((3, 192, 192, 256, causal, None, None))
        cases.append((2, 1000, 1000, 256, causal, None, None))
        for ramp in ("down", "up"):
            cases.append((6, 512, 512, 256, causal, None, ramp))
    cases.append((4, 192, 320, 256, False, None, None))
    cases.append((4, 320, 200, 256, False, None, None))
    cases.append((24, 1024, 1024, 256, True, None, None))
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
        dq_walk, dkv_walk = tree.blocks(rows, d)
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
    for b, h, s, d in ((16, 6, 1024, 128), (4, 6, 1024, 256)):
        bwd_timings_at(trees, b, h, s, d)


def bwd_timings_at(trees, b, h, s, d):
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
        rows = 128 if tree.on_sm90(d) and d <= 128 else 64

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
    parser.add_argument("--probe", action="store_true",
                        help="shared-load and FFMA cycles in the fp32 "
                             "forward's access patterns, first")
    parser.add_argument("--wide", action="store_true",
                        help="--time only b4 h6 s1024 at bf16 d 256/384 "
                             "and fp32 d 128/256 (forward)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if args.probe:
        smem_probe()
    kind = BwdTree if args.bwd else Tree
    roots = [(_ROOT, "this")] + [
        (os.path.abspath(d), os.path.basename(os.path.normpath(d)))
        for d in args.against]
    built = build_many([(label + kind.suffix, kind.sources(root))
                        for root, label in roots])
    trees = [kind(root, label, built[label + kind.suffix])
             for root, label in roots]
    for tree in trees:
        print(f"{tree.label}: built in {tree.build_s:.1f} s; (registers, "
              f"spill store bytes, spill load bytes): {tree.report}; "
              f"compiler warnings {tree.warnings}", flush=True)
    failures = 0
    if args.check:
        failures = sum(len((check_bwd if args.bwd else check)(t))
                       for t in trees)
    if args.time:
        if args.bwd:
            bwd_timings(trees)
        else:
            timings(trees, args.wide)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
