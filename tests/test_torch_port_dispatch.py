"""Which hand-written kernel each flash call of horovod_tpu_torch reaches.

The compiled extension is replaced by a stub that records its calls, so
the dispatch in ``ops/flash_attention.py`` runs here on the CPU. Forward:
every bf16 variant up to head dim 128 goes to the wgmma/TMA entry point
(``flash_fwd_sm90``, with the CTA shape the host picks or the caller
forces), every fp32 variant and bf16 above d 128 to ``flash_fwd``, and
the launch counts keep one name per variant; a head dim between the
compiled ones reaches the kernel zero-padded, with the true d's scale. Backward: bf16 goes to the wgmma/TMA pair
(``flash_bwd_sm90_dq`` with the dq CTA shape the host picks or the caller
forces, ``flash_bwd_sm90_dkv``), fp32 to ``flash_bwd_dq`` and
``flash_bwd_dkv``, each counted under its own name. Every head dim above
256 reaches the run-time-d entry points (``flash_fwd_dyn``,
``flash_bwd_dyn_dq``, ``flash_bwd_dyn_dkv``) unpadded, with a device
workspace only where the accumulators do not fit shared memory. The
stub's outputs
are never read: on the card the kernels
themselves are held against their plain versions
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import os

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa

H100_SMS = 132


class _Recorder:
    """Stands in for the compiled extension: records (entry point, args)."""

    def __init__(self):
        self.calls = []
        self.head_dims = []   # (q's d, scale2) of each forward call

    def flash_fwd(self, q, k, v, out, lse, variant, causal, scale2):
        self.calls.append(("flash_fwd", variant, causal, None))
        self.head_dims.append((q.shape[2], scale2))

    def flash_fwd_sm90(self, q, k, v, out, lse, variant, causal, scale2,
                       cta_rows):
        self.calls.append(("flash_fwd_sm90", variant, causal, cta_rows))
        self.head_dims.append((q.shape[2], scale2))

    def flash_bwd_dq(self, q, k, v, dout, lse, delta, dq, causal, scale2,
                     scale):
        self.calls.append(("flash_bwd_dq", causal, scale2, scale, None))

    def flash_bwd_dkv(self, q, k, v, dout, lse, delta, dk, dv, causal,
                      scale2, scale):
        self.calls.append(("flash_bwd_dkv", causal, scale2, scale, None))

    def flash_bwd_sm90_dq(self, q, k, v, dout, lse, delta, dq, causal,
                          scale2, scale, cta_rows):
        self.calls.append(("flash_bwd_sm90_dq", causal, scale2, scale,
                           cta_rows))

    def flash_bwd_sm90_dkv(self, q, k, v, dout, lse, delta, dk, dv, causal,
                           scale2, scale):
        self.calls.append(("flash_bwd_sm90_dkv", causal, scale2, scale,
                           None))

    def flash_fwd_dyn(self, q, k, v, out, lse, ws, variant, causal, scale2):
        self.calls.append(("flash_fwd_dyn", variant, causal, ws.numel()))
        self.head_dims.append((q.shape[2], scale2))

    def flash_bwd_dyn_dq(self, q, k, v, dout, lse, delta, dq, ws, causal,
                         scale2, scale):
        self.calls.append(("flash_bwd_dyn_dq", causal, scale2, scale,
                           ws.numel()))

    def flash_bwd_dyn_dkv(self, q, k, v, dout, lse, delta, dk, dv, ws,
                          causal, scale2, scale):
        self.calls.append(("flash_bwd_dyn_dkv", causal, scale2, scale,
                           ws.numel()))


@pytest.fixture
def stub(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(fa, "extension", lambda: rec)
    monkeypatch.setattr(fa, "_sm_count", lambda device: H100_SMS)
    fa.reset_launch_counts()
    yield rec
    fa.reset_launch_counts()


def _flat(bh, s, d, dtype):
    g = torch.Generator().manual_seed(bh * s + d)
    return [torch.randn(bh, s, d, generator=g).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_each_variant_reaches_its_entry_point(stub, variant, dtype, causal):
    qf, kf, vf = _flat(6, 192, 64, dtype)
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, 0.125, variant)
    sm90 = dtype == torch.bfloat16
    entry, code, got_causal, rows = stub.calls[0]
    assert len(stub.calls) == 1
    assert entry == ("flash_fwd_sm90" if sm90 else "flash_fwd")
    assert (code, got_causal) == (fa.VARIANTS.index(variant), causal)
    assert rows == (64 if sm90 else None)
    name = f"flash_fwd_{variant}" if sm90 else f"flash_fwd_cc_{variant}"
    assert fa.fwd_launch_name(qf, variant) == name
    assert dict(fa.launch_counts) == {name: 1}
    assert out.shape == qf.shape and out.dtype == dtype
    assert lse.shape == (6, 192) and lse.dtype == torch.float32


@pytest.mark.parametrize("bh,sq,rows", [(96, 1024, 128), (6, 960, 64),
                                        (6, 640, 64), (132, 128, 128),
                                        (131, 128, 64), (66, 256, 128)])
def test_host_picks_the_cta_shape_from_the_grid(stub, bh, sq, rows):
    """Two consumer warpgroups (128 rows) only when bh·⌈sq/128⌉ CTAs fill
    the 132 SMs: the flagship's b16 h6 s1024 does, serving's b1 h6 does
    not."""
    assert fa.sm90_cta_rows(bh, sq, H100_SMS) == rows
    qf, kf, vf = _flat(bh, sq, 16, torch.bfloat16)
    for variant in fa.VARIANTS:
        assert fa.kernel_blocks(qf, kf, variant) == (rows, fa.SM90_BLOCK_K)
    assert fa.kernel_blocks(qf.float(), kf.float(), "online") == (
        fa.fit_block(sq), fa.fit_block(sq))
    fa._kernel_fwd(qf, kf, vf, True, 0.25, "lazy")
    assert stub.calls[-1][-1] == rows


@pytest.mark.parametrize("rows", [64, 128])
def test_caller_may_force_either_cta_shape(stub, rows):
    qf, kf, vf = _flat(2, 192, 32, torch.bfloat16)
    fa._kernel_fwd(qf, kf, vf, False, 0.2, "twopass", cta_rows=rows)
    assert stub.calls == [("flash_fwd_sm90", 2, False, rows)]
    assert fa.kernel_blocks(qf, kf, "twopass", rows) == (rows, 128)


def test_unsupported_operands_raise_before_any_launch(stub):
    qf, kf, vf = _flat(2, 64, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa._kernel_fwd(qf, kf, vf, True, 0.1, "lazy")
    qf, kf, vf = _flat(2, 64, 64, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._kernel_fwd(qf, kf, vf, True, 0.1, "lazy")
    assert stub.calls == [] and not fa.launch_counts


def _bwd_operands(bh, s, d, dtype):
    qf, kf, vf = _flat(bh, s, d, dtype)
    stat = torch.zeros(bh, s)
    return qf, kf, vf, qf.clone(), stat, stat.clone()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_reaches_its_entry_points(stub, dtype, causal):
    ops = _bwd_operands(6, 192, 64, dtype)
    dq, dk, dv = fa._kernel_bwd(*ops, causal, 0.125)
    sm90 = dtype == torch.bfloat16
    names = (("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv") if sm90
             else ("flash_bwd_dq", "flash_bwd_dkv"))
    counted = (names if sm90 else ("flash_bwd_cc_dq", "flash_bwd_cc_dkv"))
    assert fa.bwd_launch_names(ops[0]) == counted
    assert [c[0] for c in stub.calls] == list(names)
    for call in stub.calls:
        assert call[1:4] == (causal, 0.125 * fa.LOG2E, 0.125)
    # b·h 6 x ⌈192/128⌉ = 12 CTAs leave SMs idle: one consumer warpgroup
    assert stub.calls[0][4] == (64 if sm90 else None)
    assert dict(fa.launch_counts) == {counted[0]: 1, counted[1]: 1}
    for got, like in zip((dq, dk, dv), ops[:3]):
        assert got.shape == like.shape and got.dtype == dtype


@pytest.mark.parametrize("bh,sq,rows", [(96, 1024, 128), (6, 1024, 64),
                                        (66, 256, 128), (131, 128, 64)])
def test_backward_host_picks_the_dq_cta_shape(stub, bh, sq, rows):
    """The flagship's b16 h6 s1024 fills the SMs with 128-row dq CTAs; the
    walks name the dq CTA shape and dk/dv's fixed 64 x 128."""
    ops = _bwd_operands(bh, sq, 16, torch.bfloat16)
    assert fa.bwd_kernel_blocks(ops[0], ops[1]) == (
        (rows, fa.SM90_BLOCK_K), (fa.SM90_DKV_BLOCK_Q, fa.SM90_BLOCK_K))
    fa._kernel_bwd(*ops, True, 0.25)
    assert stub.calls[0] == ("flash_bwd_sm90_dq", True, 0.25 * fa.LOG2E,
                             0.25, rows)


@pytest.mark.parametrize("rows", [64, 128])
def test_caller_may_force_the_dq_cta_shape(stub, rows):
    ops = _bwd_operands(2, 192, 32, torch.bfloat16)
    fa._kernel_bwd(*ops, False, 0.2, cta_rows=rows)
    assert stub.calls[0][-1] == rows
    assert fa.bwd_kernel_blocks(ops[0], ops[1], rows)[0] == (rows, 128)


def test_unsupported_backward_operands_raise_before_any_launch(stub):
    with pytest.raises(ValueError, match="head_dim"):
        fa._kernel_bwd(*_bwd_operands(2, 64, 96, torch.bfloat16), True, 0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._kernel_bwd(*_bwd_operands(2, 64, 64, torch.float16), True, 0.1)
    qf, kf, vf, dof, lse, delta = _bwd_operands(2, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="dO"):
        fa._kernel_bwd(qf, kf, vf, dof.float(), lse, delta, True, 0.1)
    with pytest.raises(ValueError, match="lse and delta"):
        fa._kernel_bwd(qf, kf, vf, dof, lse[:, :32], delta, True, 0.1)
    assert stub.calls == [] and not fa.launch_counts


@pytest.mark.parametrize("d,padded", [(80, 128), (96, 128), (24, 32),
                                      (64, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_reaches_the_kernel_padded(stub, d, padded, dtype):
    """The card path's helper around the launch: q, k, v zero-padded to
    the compiled head dim, the scale of the true d, O sliced back."""
    qf, kf, vf = _flat(2, 192, d, dtype)
    scale = d ** -0.5
    out, lse = fa.pad_head_dim(
        lambda q, k, v: fa._kernel_fwd(q, k, v, True, scale, "online"),
        (qf, kf, vf), 1)
    assert stub.head_dims == [(padded, pytest.approx(scale * fa.LOG2E))]
    assert out.shape == qf.shape and out.is_contiguous()
    assert lse.shape == (2, 192)
    assert dict(fa.launch_counts) == {
        "flash_fwd_online" if dtype == torch.bfloat16 else
        "flash_fwd_cc_online": 1}


def test_head_dim_beyond_128_raises_before_any_launch(stub):
    """No head dim is refused any more: d 288 passes the padding helper
    unpadded and reaches the run-time-d forward, nothing raising."""
    qf, kf, vf = _flat(2, 64, 288, torch.bfloat16)
    out, lse = fa.pad_head_dim(
        lambda *t: fa._kernel_fwd(*t, True, 0.1, "lazy"), (qf, kf, vf), 1)
    assert stub.calls == [("flash_fwd_dyn", 1, True, 0)]
    assert stub.head_dims == [(288, pytest.approx(0.1 * fa.LOG2E))]
    assert out.shape == qf.shape and lse.shape == (2, 64)
    assert dict(fa.launch_counts) == {"flash_fwd_dyn_lazy": 1}


@pytest.mark.parametrize("d", [257, 288, 384, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", fa.VARIANTS)
def test_beyond_256_reaches_the_run_time_d_kernels(stub, d, dtype, variant):
    """d > 256 goes to the run-time-d kernels with no padding (the true d
    reaches them, and so does its scale), forward and backward, counted
    under ``flash_fwd_dyn_{variant}`` and ``flash_bwd_dyn_{dq,dkv}``, and
    the walks are their 32-row tiles."""
    qf, kf, vf = _flat(2, 100, d, dtype)
    scale = d ** -0.5
    assert fa.kernel_head_dim(d) == d and fa.on_dyn(d)
    out, lse = fa.pad_head_dim(
        lambda q, k, v: fa._kernel_fwd(q, k, v, True, scale, variant),
        (qf, kf, vf), 1)
    assert stub.head_dims == [(d, pytest.approx(scale * fa.LOG2E))]
    assert stub.calls[0][:3] == ("flash_fwd_dyn", fa.VARIANTS.index(variant),
                                 True)
    delta = torch.zeros(2, 100)
    dq, dk, dv = fa.pad_head_dim(
        lambda q, k, v, do: fa._kernel_bwd(q, k, v, do, lse, delta, True,
                                           scale), (qf, kf, vf, qf), 3)
    assert [c[0] for c in stub.calls[1:]] == ["flash_bwd_dyn_dq",
                                              "flash_bwd_dyn_dkv"]
    for call in stub.calls[1:]:
        assert call[1:4] == (True, pytest.approx(scale * fa.LOG2E), scale)
    assert out.shape == dq.shape == dk.shape == dv.shape == qf.shape
    assert fa.kernel_blocks(qf, kf, variant) == (32, 32)
    assert fa.bwd_kernel_blocks(qf, kf) == ((32, 32), (32, 32))
    assert dict(fa.launch_counts) == {f"flash_fwd_dyn_{variant}": 1,
                                      "flash_bwd_dyn_dq": 1,
                                      "flash_bwd_dyn_dkv": 1}


@pytest.mark.parametrize("d,fwd,dkv", [(288, 0, 0), (512, 0, 0),
                                       (1024, 0, 2 * 32 * 1024),
                                       (2048, 32 * 2048, 2 * 32 * 2048)])
def test_run_time_d_accumulators_leave_shared_memory_only_when_full(
        stub, d, fwd, dkv):
    """The fp32 accumulators [32, d] (two in dk/dv) stay in shared memory
    while they fit 227 KB beside the chunk tiles (the forward and dq up to
    d 1653, dk/dv up to 826), and otherwise go to a device workspace of
    one slice per CTA; a caller may force the workspace."""
    assert fa.dyn_workspace("fwd", 1, 32, d) == fwd
    assert fa.dyn_workspace("dq", 1, 32, d) == fwd
    assert fa.dyn_workspace("dkv", 1, 32, d) == dkv
    assert fa.dyn_workspace("fwd", 3, 100, d) == 3 * 4 * fwd
    qf, kf, vf = _flat(3, 100, d, torch.bfloat16)
    fa._kernel_fwd(qf, kf, vf, False, 0.1, "online")
    fa._kernel_fwd(qf, kf, vf, False, 0.1, "online", workspace=True)
    assert stub.calls[0][-1] == 3 * 4 * fwd
    assert stub.calls[1][-1] == 3 * 4 * 32 * d


@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_head_dims_reach_the_cuda_core_kernels(stub, d, dtype):
    """d in (128, 256] is zero-padded to 256 with the true d's scale and
    runs on the CUDA-core kernels in both dtypes (the wgmma ones stop at
    128): forward on ``flash_fwd``, backward on ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` over 32-key tiles, each counted under its own
    ``_cc_`` name."""
    qf, kf, vf = _flat(2, 200, d, dtype)
    scale = d ** -0.5
    out, lse = fa.pad_head_dim(
        lambda q, k, v: fa._kernel_fwd(q, k, v, True, scale, "online"),
        (qf, kf, vf), 1)
    assert stub.calls == [("flash_fwd", 0, True, None)]
    assert stub.head_dims == [(256, pytest.approx(scale * fa.LOG2E))]
    assert out.shape == qf.shape
    delta = torch.zeros(2, 200)
    dq, dk, dv = fa.pad_head_dim(
        lambda q, k, v, do: fa._kernel_bwd(q, k, v, do, lse, delta, True,
                                           scale), (qf, kf, vf, qf), 3)
    assert [c[0] for c in stub.calls[1:]] == ["flash_bwd_dq",
                                              "flash_bwd_dkv"]
    assert dq.shape == dk.shape == dv.shape == qf.shape
    assert fa.bwd_kernel_blocks(qf, kf) == ((64, 32), (64, 32))
    assert fa.kernel_blocks(qf, kf, "online") == (64, 64)
    assert dict(fa.launch_counts) == {"flash_fwd_cc_online": 1,
                                      "flash_bwd_cc_dq": 1,
                                      "flash_bwd_cc_dkv": 1}


def test_build_lists_every_cuda_source():
    on_disk = {f for f in os.listdir(_build.CSRC) if f.endswith(".cu")}
    listed = set(_build.SOURCES)
    assert on_disk <= listed
    assert {f for f in listed if f.endswith(".cu")} == on_disk
    assert {"bindings.cpp", "flash_bwd_sm90.cu", "flash_fwd_sm90.cu"} <= \
        listed


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__1a2b_17_flash_fwd_sm90_cu_3f6ff79121flash_fwd_sm90_kernelILi128ELi1ELi2EEEv14CUtensorMap_S1_S1_NS_10Sm90ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__1a2b
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__3c4d_12flash_fwd_cu_3f6ff79120flash_fwd_f32_kernelILi64ELi0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__3c4d
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 100 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__5e6f_17_flash_bwd_sm90_cu_74caf55f24flash_bwd_sm90_dq_kernelILi128ELi2EEEv14CUtensorMap_stS1_S1_S1_NS_13BwdSm90ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__5e6f
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 576 bytes cmem[0]
"""


def test_ptxas_report_names_kernels_and_reads_spills():
    """chip_smoke.py fails the run on any spill this report shows."""
    from horovod_tpu_torch.ops import flash_fwd_ab
    assert flash_fwd_ab.ptxas_report(_PTXAS) == {
        "flash_fwd_sm90_kernel<128,1,2>": (168, 0, 0),
        "flash_fwd_f32_kernel<64,0>": (100, 8, 4),
        "flash_bwd_sm90_dq_kernel<128,2>": (168, 0, 0)}
    cmd = flash_fwd_ab.nvcc_cmd(["a.cu"], "a.cubin", cubin=True)
    assert "-cubin" in cmd and "-v" in cmd and cmd[-1] == "a.cu"
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd


def test_ptxas_report_names_type_arguments():
    """The run-time-d kernels are templates on the element type too: fp32
    and bf16 instantiations get names of their own."""
    from horovod_tpu_torch.ops import flash_fwd_ab
    text = "".join(
        f"ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__9_"
        f"12flash_dyn_cu_0a{k}' for 'sm_90a'\n"
        f"    64 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {r} registers, used 1 barriers\n"
        for k, r in (("20flash_fwd_dyn_kernelIfLi2EEEvNS_9DynParamsE", 56),
                     ("20flash_fwd_dyn_kernelI13__nv_bfloat16Li2EEEvNS_9"
                      "DynParamsE", 56),
                     ("23flash_bwd_dq_dyn_kernelIfEEvNS_9DynParamsE", 64)))
    assert flash_fwd_ab.ptxas_report(text) == {
        "flash_fwd_dyn_kernel<float,2>": (56, 0, 0),
        "flash_fwd_dyn_kernel<bf16,2>": (56, 0, 0),
        "flash_bwd_dq_dyn_kernel<float>": (64, 0, 0)}
