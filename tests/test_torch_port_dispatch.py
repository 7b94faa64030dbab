"""Which hand-written kernel each flash call of horovod_tpu_torch reaches.

The compiled extension is replaced by a stub that records its calls, so
the dispatch in ``ops/flash_attention.py`` runs here on the CPU. Forward:
every bf16 variant up to head dim 256 goes to the wgmma/TMA entry point
(``flash_fwd_sm90``, with the CTA shape the host picks or the caller
forces; 64-key tiles at d 256), every fp32 variant to ``flash_fwd``, and
the launch counts keep one name per variant; a head dim between the
compiled ones reaches the kernel zero-padded, with the true d's scale.
The bf16 forward above 256 up to 1024 goes to the run-time-d wgmma/TMA
entry point (``flash_fwd_sm90_dyn``, counted as
``flash_fwd_sm90dyn_{variant}``), with the CTA rows the host picks from
the grid of column slices.
Backward: bf16 up to d 128 goes to the wgmma/TMA pair
(``flash_bwd_sm90_dq`` with the dq CTA shape the host picks or the caller
forces, ``flash_bwd_sm90_dkv``), fp32 and bf16 above 128 to
``flash_bwd_dq`` and ``flash_bwd_dkv``, each counted under its own name. Every head dim above
256 reaches the run-time-d CUDA-core entry points (the fp32 and above-1024
bf16 forward ``flash_fwd_dyn``, ``flash_bwd_dyn_dq``,
``flash_bwd_dyn_dkv``) unpadded, with a device workspace only where the
accumulators do not fit shared memory. The
stub's outputs
are never read: on the card the kernels
themselves are held against their plain versions
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import os
import re

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

    def flash_fwd_sm90_dyn(self, q, k, v, out, lse, variant, causal, scale2,
                           cta_rows):
        self.calls.append(("flash_fwd_sm90_dyn", variant, causal, cta_rows))
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
        fa.fit_block(sq), fa.fit_block(sq, fa.CC_BLOCK_K))
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
    """No head dim is refused any more: bf16 d 288 passes the padding
    helper unpadded and reaches the run-time-d wgmma forward (64 query
    rows: 2 x 1 x 2 slices of CTAs leave the SMs idle), nothing raising."""
    qf, kf, vf = _flat(2, 64, 288, torch.bfloat16)
    out, lse = fa.pad_head_dim(
        lambda *t: fa._kernel_fwd(*t, True, 0.1, "lazy"), (qf, kf, vf), 1,
        fa.fwd_head_dim(qf))
    assert stub.calls == [("flash_fwd_sm90_dyn", 1, True, 64)]
    assert stub.head_dims == [(288, pytest.approx(0.1 * fa.LOG2E))]
    assert out.shape == qf.shape and lse.shape == (2, 64)
    assert dict(fa.launch_counts) == {"flash_fwd_sm90dyn_lazy": 1}


@pytest.mark.parametrize("d", [257, 288, 384, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", fa.VARIANTS)
def test_beyond_256_reaches_the_run_time_d_kernels(stub, d, dtype, variant):
    """d > 256 goes to the run-time-d kernels, forward and backward, with
    the true d's scale: the fp32 forward to ``flash_fwd_dyn`` unpadded
    (counted as ``flash_fwd_dyn_{variant}``, 32-row tiles), the bf16 one to
    the wgmma ``flash_fwd_sm90_dyn`` (``flash_fwd_sm90dyn_{variant}``,
    64-key tiles, d padded to a multiple of 8: 257 reaches it as 264);
    the backward of both to ``flash_bwd_dyn_{dq,dkv}`` unpadded at 32-row
    tiles."""
    qf, kf, vf = _flat(2, 100, d, dtype)
    scale = d ** -0.5
    bf16 = dtype == torch.bfloat16
    assert fa.kernel_head_dim(d) == d and fa.on_dyn(d)
    assert fa.on_sm90dyn_fwd(qf) == bf16
    fwd_d = -(-d // 8) * 8 if bf16 else d
    assert fa.fwd_head_dim(qf) == fwd_d
    out, lse = fa._card_fwd(qf, kf, vf, True, d ** -0.5, variant)
    assert stub.head_dims == [(fwd_d, pytest.approx(scale * fa.LOG2E))]
    assert stub.calls[0][:3] == (
        "flash_fwd_sm90_dyn" if bf16 else "flash_fwd_dyn",
        fa.VARIANTS.index(variant), True)
    delta = torch.zeros(2, 100)
    dq, dk, dv = fa.pad_head_dim(
        lambda q, k, v, do: fa._kernel_bwd(q, k, v, do, lse, delta, True,
                                           scale), (qf, kf, vf, qf), 3)
    assert [c[0] for c in stub.calls[1:]] == ["flash_bwd_dyn_dq",
                                              "flash_bwd_dyn_dkv"]
    for call in stub.calls[1:]:
        assert call[1:4] == (True, pytest.approx(scale * fa.LOG2E), scale)
    assert out.shape == dq.shape == dk.shape == dv.shape == qf.shape
    assert fa.kernel_blocks(qf, kf, variant) == ((64, 64) if bf16
                                                 else (32, 32))
    assert fa.bwd_kernel_blocks(qf, kf) == ((32, 32), (32, 32))
    family = "sm90dyn" if bf16 else "dyn"
    assert dict(fa.launch_counts) == {f"flash_fwd_{family}_{variant}": 1,
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
    # fp32: the run-time-d CUDA-core forward (bf16 up to 1024 is wgmma's)
    qf, kf, vf = _flat(3, 100, d, torch.float32)
    fa._kernel_fwd(qf, kf, vf, False, 0.1, "online")
    fa._kernel_fwd(qf, kf, vf, False, 0.1, "online", workspace=True)
    assert stub.calls[0][-1] == 3 * 4 * fwd
    assert stub.calls[1][-1] == 3 * 4 * 32 * d


@pytest.mark.parametrize("d,plan", [(264, (5, 2, 3)), (288, (5, 2, 3)),
                                    (384, (6, 2, 3)), (448, (7, 2, 4)),
                                    (512, (8, 2, 4)), (576, (9, 3, 3)),
                                    (640, (10, 3, 4)), (1024, (16, 4, 4))])
def test_run_time_d_wgmma_forward_plan(d, plan):
    """d in 64-column boxes, the boxes in slices of at most four (one CTA
    each, O at most m64n256), each slice 3 or 4 boxes wide; two consumer
    warpgroups fit up to d 576, one up to the ceiling of 1024."""
    assert fa.sm90dyn_plan(d) == plan
    assert fa.sm90dyn_fits(d, 64)
    assert fa.sm90dyn_fits(d, 128) == (d <= 576)
    assert not fa.sm90dyn_fits(1088, 64)


def _cxx_constants(source):
    """The integer ``constexpr int`` literals of a CUDA source, by name."""
    with open(os.path.join(_build.CSRC, source)) as f:
        return {name: int(value) for name, value in re.findall(
            r"constexpr int (\w+) = (\d+);", f.read())}


@pytest.mark.parametrize("rows", [64, 128])
def test_run_time_d_wgmma_plan_mirrors_the_kernel_source(rows):
    """The host's copy of the run-time-d wgmma forward's plan (the boxes,
    the rings, the ceiling, and so which CTA shapes fit at each d) agrees
    with the constants of ``flash_fwd_sm90_dyn.cu``, which refuses a
    launch whose shared memory does not fit: a drift would refuse launches
    the host picks, or have the plain walk take tiles the kernel does not."""
    c = _cxx_constants("flash_fwd_sm90_dyn.cu")
    assert c["kBoxCols"] == fa._SM90_DYN_BOX
    assert c["kKeys"] == fa.SM90_DYN_BLOCK_K
    assert (c["kKStages"], c["kVStages"]) == (fa._SM90_DYN_K_STAGES,
                                              fa._SM90_DYN_V_STAGES)
    assert c["kMaxSmem"] == fa.MAX_SMEM
    assert c["kMaxBoxes"] * c["kBoxCols"] == fa.SM90_DYN_MAX_HEAD_DIM
    assert c["kWgRows"] == 64
    box = c["kKeys"] * 2 * c["kBoxCols"]   # bytes of one bf16 box
    for d in range(264, 1160, 8):
        nbox = -(-d // c["kBoxCols"])
        slices = -(-nbox // 4)
        nb = -(-nbox // slices)
        smem = (nbox * rows * 2 * c["kBoxCols"] + c["kKStages"] * box +
                c["kVStages"] * nb * box + 128 + 1024)
        fits = nbox <= c["kMaxBoxes"] and smem <= c["kMaxSmem"]
        assert fa.sm90dyn_plan(d) == (nbox, slices, nb), d
        assert fa.sm90dyn_fits(d, rows) == fits, d


@pytest.mark.parametrize("d,bh,sq,rows", [(288, 24, 1024, 128),
                                          (384, 24, 1024, 128),
                                          (384, 2, 1024, 64),
                                          (512, 24, 1024, 128),
                                          (512, 6, 200, 64),
                                          (1024, 24, 1024, 64)])
@pytest.mark.parametrize("variant", fa.VARIANTS)
def test_bf16_beyond_256_reaches_the_wgmma_forward(stub, d, bh, sq, rows,
                                                   variant):
    """bf16 d 288/384/512/1024 reach ``flash_fwd_sm90_dyn`` unpadded under
    ``flash_fwd_sm90dyn_{variant}``, with the CTA rows the host picks from
    the grid (128 when bh·⌈sq/128⌉·slices CTAs fill the 132 SMs and Q for
    128 rows fits, else 64) and 64-key tiles; the kernel cuts d into the
    slices ``sm90dyn_plan`` names. A caller may force 64 rows anywhere,
    128 where it fits; fp32 at the same d stays on ``flash_fwd_dyn``."""
    qf, kf, vf = _flat(bh, sq, d, torch.bfloat16)
    slices = fa.sm90dyn_plan(d)[1]
    assert fa.sm90dyn_cta_rows(bh, sq, d, H100_SMS) == rows
    assert rows == (128 if bh * -(-sq // 128) * slices >= H100_SMS and
                    d <= 576 else 64)
    assert fa.kernel_blocks(qf, kf, variant) == (rows, fa.SM90_DYN_BLOCK_K)
    assert fa.fwd_launch_name(qf, variant) == f"flash_fwd_sm90dyn_{variant}"
    out, lse = fa._card_fwd(qf, kf, vf, True, d ** -0.5, variant)
    fa._kernel_fwd(qf, kf, vf, False, 0.1, variant, cta_rows=64)
    code = fa.VARIANTS.index(variant)
    assert stub.calls == [("flash_fwd_sm90_dyn", code, True, rows),
                          ("flash_fwd_sm90_dyn", code, False, 64)]
    assert stub.head_dims[0] == (d, pytest.approx(d ** -0.5 * fa.LOG2E))
    assert out.shape == qf.shape and out.dtype == torch.bfloat16
    assert lse.shape == (bh, sq) and lse.dtype == torch.float32
    assert dict(fa.launch_counts) == {f"flash_fwd_sm90dyn_{variant}": 2}
    if d > 576:
        with pytest.raises(ValueError, match="fits 128 query rows"):
            fa._kernel_fwd(qf, kf, vf, True, 0.1, variant, cta_rows=128)
    fa._kernel_fwd(qf.float(), kf.float(), vf.float(), True, 0.1, variant)
    assert stub.calls[-1][0] == "flash_fwd_dyn"
    assert fa.fwd_launch_name(qf.float(), variant) == \
        f"flash_fwd_dyn_{variant}"


@pytest.mark.parametrize("d", [300, 1020])
def test_bf16_head_dim_off_the_8_grid_is_padded_to_it(stub, d):
    """A bf16 d above 256 that is not a multiple of 8 reaches the wgmma
    forward zero-padded to the next multiple (the tensor maps' rows must
    be multiples of 16 bytes), with the true d's scale and O sliced back;
    unpadded, the launch wrapper refuses it."""
    qf, kf, vf = _flat(2, 100, d, torch.bfloat16)
    out, lse = fa._card_fwd(qf, kf, vf, True, d ** -0.5, "online")
    assert stub.head_dims == [(-(-d // 8) * 8,
                               pytest.approx(d ** -0.5 * fa.LOG2E))]
    assert out.shape == qf.shape and out.is_contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._kernel_fwd(qf, kf, vf, True, 0.1, "online")
    assert len(stub.calls) == 1


@pytest.mark.parametrize("d", [1032, 1088, 2048])
@pytest.mark.parametrize("variant", fa.VARIANTS)
def test_bf16_above_the_wgmma_ceiling_stays_on_the_cuda_cores(stub, d,
                                                              variant):
    """Above 1024 Q of one 64-row CTA no longer fits beside the wgmma
    kernel's rings: bf16 stays on the run-time-d CUDA-core forward,
    unpadded, at its 32-row tiles."""
    qf, kf, vf = _flat(2, 100, d, torch.bfloat16)
    assert not fa.on_sm90dyn_fwd(qf) and fa.fwd_head_dim(qf) == d
    fa._card_fwd(qf, kf, vf, True, 0.1, variant)
    assert stub.calls[0][:3] == ("flash_fwd_dyn", fa.VARIANTS.index(variant),
                                 True)
    assert fa.kernel_blocks(qf, kf, variant) == (32, 32)
    assert dict(fa.launch_counts) == {f"flash_fwd_dyn_{variant}": 1}


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("variant", fa.VARIANTS)
def test_fp32_up_to_256_reaches_the_cuda_core_forward(stub, d, variant):
    """fp32 at every compiled head dim goes to the register-blocked
    ``flash_fwd`` at its 64-row q tiles and 128-key k tiles, counted as
    ``flash_fwd_cc_{variant}``."""
    qf, kf, vf = _flat(3, 150, d, torch.float32)
    fa._kernel_fwd(qf, kf, vf, True, 0.2, variant)
    assert stub.calls == [("flash_fwd", fa.VARIANTS.index(variant), True,
                           None)]
    assert fa.kernel_blocks(qf, kf, variant) == (fa.BLOCK, fa.CC_BLOCK_K)
    assert dict(fa.launch_counts) == {f"flash_fwd_cc_{variant}": 1}


@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_head_dims_reach_the_cuda_core_kernels(stub, d, dtype):
    """d in (128, 256] is zero-padded to 256 with the true d's scale. The
    bf16 forward runs on the wgmma/TMA kernel (``flash_fwd_sm90``, 64-key
    tiles at d 256, the CTA rows the host picks), counted as
    ``flash_fwd_{variant}``; the fp32 forward on the CUDA-core
    ``flash_fwd``. The bf16 backward runs on the wgmma/TMA
    ``flash_bwd_sm90_dq`` (64 query rows x 64 keys) and
    ``flash_bwd_sm90_dkv`` (64 keys x 64 queries); the fp32 backward on
    the CUDA-core ``flash_bwd_dq`` and ``flash_bwd_dkv`` over 32-key
    tiles, each counted under its own ``_cc_`` name."""
    qf, kf, vf = _flat(2, 200, d, dtype)
    scale = d ** -0.5
    out, lse = fa.pad_head_dim(
        lambda q, k, v: fa._kernel_fwd(q, k, v, True, scale, "online"),
        (qf, kf, vf), 1)
    bf16 = dtype == torch.bfloat16
    rows = fa.sm90_cta_rows(2, 200, H100_SMS)
    assert stub.calls == [("flash_fwd_sm90", 0, True, rows) if bf16
                          else ("flash_fwd", 0, True, None)]
    assert stub.head_dims == [(256, pytest.approx(scale * fa.LOG2E))]
    assert out.shape == qf.shape
    delta = torch.zeros(2, 200)
    dq, dk, dv = fa.pad_head_dim(
        lambda q, k, v, do: fa._kernel_bwd(q, k, v, do, lse, delta, True,
                                           scale), (qf, kf, vf, qf), 3)
    bwd = (["flash_bwd_sm90_dq", "flash_bwd_sm90_dkv"] if bf16
           else ["flash_bwd_dq", "flash_bwd_dkv"])
    assert [c[0] for c in stub.calls[1:]] == bwd
    # the d-256 dq CTA holds 64 query rows whatever the grid
    assert stub.calls[1][-1] == (64 if bf16 else None)
    assert dq.shape == dk.shape == dv.shape == qf.shape
    assert fa.bwd_kernel_blocks(qf, kf) == (
        ((64, 64), (64, 64)) if bf16 else ((64, 32), (64, 32)))
    assert fa.bwd_kernel_blocks(qf, kf, 128) == fa.bwd_kernel_blocks(qf, kf)
    assert fa.kernel_blocks(qf, kf, "online") == (
        (rows, fa.SM90_BLOCK_K_WIDE) if bf16 else (64, 128))
    assert fa.kernel_blocks(qf, kf, "lazy", 128) == (
        (128, 64) if bf16 else (64, 128))
    family = "sm90" if bf16 else "cc"
    assert dict(fa.launch_counts) == {
        "flash_fwd_online" if bf16 else "flash_fwd_cc_online": 1,
        f"flash_bwd_{family}_dq": 1, f"flash_bwd_{family}_dkv": 1}


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
