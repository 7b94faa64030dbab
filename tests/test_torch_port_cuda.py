"""horovod_tpu_torch's CUDA kernels on the card.

Every case needs a CUDA device and skips without one: the hand-written
kernels have no CPU mode (their CPU counterparts, the plain tile walks,
are held to the JAX package by the other test_torch_port_* files). This
file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_cuda.py
"""

import pytest
import torch

from horovod_tpu_torch import models, mpi_ops, optim, trainer
from horovod_tpu_torch.models import transformer as tr
from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.ops import batch_norm_ref as bn_ref
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import flash_attention_ref as ref
from horovod_tpu_torch.serving.engine import ServeEngine
from horovod_tpu_torch.serving.queue import AdmissionQueue, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, s, h, d, dtype, device, k_ramp=None):
    """Unit-scale q, k, v [b, s, h, d]; ``k_ramp`` [s] scales each key."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g) for _ in range(3))
    if k_ramp is not None:
        k = k * k_ramp[None, :, None, None]
    return [t.to(device, dtype) for t in (q, k, v)]


def _assert_kernel_close(got, want, what, dtype):
    """fp32: 2e-5. bf16 O: two bf16 ulps of each value plus 1 % of the
    largest |O|, so O = 0 or a skipped rescale fails; lse is fp32 from
    fp32 logits in both dtypes: 1e-3."""
    want = want.float()
    if dtype == torch.float32:
        rtol, atol = 2e-5, 2e-5
    elif what == "lse":
        rtol, atol = 0.0, 1e-3
    else:
        rtol, atol = 1.6e-2, 1e-2 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def _check(q, k, v, causal, variant, dtype):
    """The public entry against the plain version walking the tiles of
    the kernel the call reaches."""
    b, s, h, d = q.shape
    out, lse = fa.flash_fwd(q, k, v, causal, variant=variant)
    flat = [t.transpose(1, 2).reshape(b * h, s, d) for t in (q, k, v)]
    p_out, p_lse = ref.FWD[variant](*flat, causal,
                                    *fa.kernel_blocks(flat[0], flat[1],
                                                      variant))
    _assert_kernel_close(out.transpose(1, 2).reshape(b * h, s, d), p_out,
                         "O", dtype)
    _assert_kernel_close(lse, p_lse, "lse", dtype)


def _check_sm90(seed, bh, sq, sk, d, causal, variant, device, cta_rows=None,
                k_ramp=None):
    """The bf16 wgmma/TMA kernel on ``[b·h, s, d]`` operands (CTA shape
    forced when ``cta_rows`` is given) against its plain version at the
    same tiles."""
    g = torch.Generator().manual_seed(seed)
    qf = torch.randn(bh, sq, d, generator=g)
    kf, vf = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
    if k_ramp is not None:
        kf = kf * k_ramp[None, :, None]
    qf, kf, vf = (t.to(device, torch.bfloat16) for t in (qf, kf, vf))
    fa.reset_launch_counts()
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, variant,
                              cta_rows=cta_rows)
    assert dict(fa.launch_counts) == {f"flash_fwd_{variant}": 1}
    p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, variant,
                                                      cta_rows))
    _assert_kernel_close(out, p_out, "O", torch.bfloat16)
    _assert_kernel_close(lse, p_lse, "lse", torch.bfloat16)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [40, 256])
def test_kernel_matches_plain(card, variant, dtype, s):
    _check(*_qkv(12, 1, s, 6, 128, dtype, card), True, variant, dtype)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("ramp", ["down", "up"])
def test_kernel_matches_plain_on_rising_max(card, variant, dtype, causal,
                                            ramp):
    """Keys ramped so every k tile raises the row max in one walk order:
    ``down`` in lazy's diagonal-first walk, ``up`` in the ascending one."""
    k_ramp = torch.linspace(4.0, 0.5, 512)
    if ramp == "up":
        k_ramp = k_ramp.flip(0)
    _check(*_qkv(14, 1, 512, 6, 128, dtype, card, k_ramp), causal, variant,
           dtype)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_sm90_kernel_every_head_dim(card, variant, causal, d):
    """Each head dim's swizzle (32, 64, 128 B and two 128 B boxes) at
    s 192: a 128-key tile and a partial one, b·h = 3."""
    _check_sm90(40 + d, 3, 192, 192, d, causal, variant, card)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_kernel_partial_last_tile_per_head(card, variant, causal):
    """s 960 (a multiple of 64, not of 128) at b·h 6: a tensor map over the
    flat [b·h·s, d] would read 64 keys of the next head into each head's
    last tile."""
    _check_sm90(41, 6, 960, 960, 128, causal, variant, card)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("cta_rows", [64, 128])
def test_sm90_kernel_non_causal_sk_not_sq(card, variant, cta_rows):
    _check_sm90(42, 4, 192, 320, 64, False, variant, card, cta_rows)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cta_rows", [64, 128])
def test_sm90_kernel_both_cta_shapes(card, variant, causal, cta_rows):
    """One and two consumer warpgroups, forced, at s 384: with 128 query
    rows the causal diagonal splits the CTA's tile between the two."""
    _check_sm90(43, 2, 384, 384, 128, causal, variant, card, cta_rows)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("ramp", ["down", "up"])
@pytest.mark.parametrize("cta_rows", [64, 128])
def test_sm90_kernel_rising_max_at_its_tiles(card, variant, causal, ramp,
                                             cta_rows):
    """The rising-max adversaries at the kernel's 128-key tiles: ``down``
    raises the max on every tile of lazy's diagonal-first walk, ``up`` on
    every tile of twopass's ascending passes."""
    k_ramp = torch.linspace(4.0, 0.5, 512)
    if ramp == "up":
        k_ramp = k_ramp.flip(0)
    _check_sm90(44, 6, 512, 512, 128, causal, variant, card, cta_rows,
                k_ramp)


def test_kernel_refuses_what_it_cannot_take(card):
    """fp16 is refused; a head dim above 256 no longer is: bf16 d 288 runs
    on the run-time-d wgmma kernel and agrees with the plain walk."""
    q, k, v = _qkv(13, 1, 64, 2, 128, torch.float16, card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, k, v, True)
    q, k, v = _qkv(13, 1, 64, 2, 288, torch.bfloat16, card)
    fa.reset_launch_counts()
    _check(q, k, v, True, "online", torch.bfloat16)
    assert dict(fa.launch_counts) == {"flash_fwd_sm90dyn_online": 1}


def _flat_bshd(t):
    b, s, h, d = t.shape
    return t.transpose(1, 2).reshape(b * h, s, d)


def _public_fwd_bwd(q, k, v, g, causal, device, variant="auto", **kw):
    """(out, dq, dk, dv) of the public flash_attention and its backward,
    flattened to [b·h, s, d]."""
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, variant=variant,
                             device=device, **kw)
    out.backward(g)
    return [_flat_bshd(t) for t in (out.detach(), *(t.grad for t in ts))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 96])
def test_head_dims_between_the_compiled_ones(card, dtype, causal, d):
    """d 80 and 96 run through the kernels zero-padded to 128, forward and
    backward, and agree with the plain walks at the true d (its scale,
    the kernels' tiles)."""
    q, k, v = _qkv(15 + d, 1, 200, 3, d, dtype, card)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(
        card, dtype)
    fa.reset_launch_counts()
    got = _public_fwd_bwd(q, k, v, g, causal, card, variant="online")
    assert dict(fa.launch_counts) == {_fwd_name(dtype, "online"): 1,
                                      **dict.fromkeys(_bwd_names(dtype), 1)}
    qf, kf, vf, gf = (_flat_bshd(t) for t in (q, k, v, g))
    out, lse = ref.flash_fwd_online(qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, "online"))
    delta = ref.flash_delta(out, gf)
    _assert_kernel_close(got[0], out, "O", dtype)
    for a, w in zip(got[1:], _plain_grads(qf, kf, vf, gf, lse, delta,
                                          causal)):
        assert a.shape == w.shape
        _assert_grad_close(a, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interpret_runs_the_plain_walk_on_the_card(card, dtype):
    """interpret=True: the plain walks at the caller's blocks on the card's
    tensors, forward and backward, and no kernel launch."""
    q, k, v = _qkv(16, 1, 192, 2, 64, dtype, card)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(17)).to(
        card, dtype)
    fa.reset_launch_counts()
    got = _public_fwd_bwd(q, k, v, g, True, card, variant="lazy",
                          block_q=64, block_k=64, interpret=True)
    assert not fa.launch_counts
    qf, kf, vf, gf = (_flat_bshd(t) for t in (q, k, v, g))
    out, lse = ref.flash_fwd_lazy(qf, kf, vf, True, 64, 64)
    delta = ref.flash_delta(out, gf)
    want = (out, ref.flash_bwd_dq(qf, kf, vf, gf, lse, delta, True, 64, 64),
            *ref.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, True, 64, 64))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True),
                                          (100, 100, False),
                                          (100, 300, True),
                                          (100, 300, False),
                                          (1000, 1000, True),
                                          (16, 16, False)])
def test_partial_tiles_forward_and_backward(card, dtype, sq, sk, causal):
    """Lengths that end in a partial q tile and a partial k tile of every
    kernel (64-row tiles in fp32, 128-key tiles and 64/128-row CTAs in
    bf16), run unpadded: each forward variant and the backward pair
    against the plain walks at the kernels' tiles."""
    g = torch.Generator().manual_seed(sq + sk)
    qf, gf = (torch.randn(2, sq, 64, generator=g) for _ in range(2))
    kf, vf = (torch.randn(2, sk, 64, generator=g) for _ in range(2))
    qf, kf, vf, gf = (t.to(card, dtype) for t in (qf, kf, vf, gf))
    for variant in fa.VARIANTS:
        out, lse = fa._kernel_fwd(qf, kf, vf, causal, 0.125, variant)
        p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal,
                                        *fa.kernel_blocks(qf, kf, variant))
        _assert_kernel_close(out, p_out, "O", dtype)
        _assert_kernel_close(lse, p_lse, "lse", dtype)
    delta = ref.flash_delta(p_out, gf)
    got = fa._kernel_bwd(qf, kf, vf, gf, p_lse, delta, causal, 0.125)
    for a, w in zip(got, _plain_grads(qf, kf, vf, gf, p_lse, delta,
                                      causal)):
        _assert_grad_close(a, w, dtype)


def test_engine_prefills_through_the_kernels(card):
    cfg = tr.TransformerConfig.tiny(attention_impl="flash")
    model = tr.init_params(cfg, device=card)
    engine = ServeEngine(cfg, model, num_slots=2, max_len=128, kv_block=16,
                         queue=AdmissionQueue(max_depth=8,
                                              admission_timeout_s=1e9),
                         device=card)
    fa.reset_launch_counts()
    engine.submit(Request("short", tuple(range(1, 20)), max_new_tokens=4))
    engine.submit(Request("long", tuple(range(1, 100)), max_new_tokens=4))
    results = engine.run_to_completion()
    assert sorted(r.request_id for r in results) == ["long", "short"]
    assert all(r.outcome == "completed" for r in results)
    assert engine.kv.ledger.blocks_in_use == 0
    layers = cfg.num_layers
    assert dict(fa.launch_counts) == {"flash_fwd_online": layers,
                                      "flash_fwd_lazy": layers}


def _assert_grad_close(got, want, dtype):
    """fp32: rtol 1e-4 / atol 1e-5. bf16: two bf16 ulps of each value plus
    1 % of the gradient's largest magnitude."""
    want = want.float()
    if dtype == torch.float32:
        rtol, atol = 1e-4, 1e-5
    else:
        rtol, atol = 1.6e-2, 1e-2 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def _plain_grads(qf, kf, vf, gf, lse, delta, causal, cta_rows=None):
    """The plain backward at the tiles the kernels walk (the wgmma/TMA
    pair's own in bf16, the public tile in fp32)."""
    dq_walk, dkv_walk = fa.bwd_kernel_blocks(qf, kf, cta_rows)
    dq = ref.flash_bwd_dq(qf, kf, vf, gf, lse, delta, causal, *dq_walk)
    return (dq, *ref.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, causal,
                                   *dkv_walk))


def _on_sm90(dtype, d, forward=False):
    """Whether a call runs on the wgmma kernels: the bf16 forward and
    backward up to d 256."""
    top = fa.SM90_FWD_MAX_HEAD_DIM if forward else fa.SM90_MAX_HEAD_DIM
    return dtype == torch.bfloat16 and d <= top


def _family(d):
    return "dyn" if fa.on_dyn(d) else "cc"


def _fwd_name(dtype, variant, d=128):
    """The launch count of a forward: the wgmma kernel's (up to d 256),
    the run-time-d wgmma kernel's (bf16 above 256 up to 1024), or the
    CUDA-core or run-time-d CUDA-core kernel's own."""
    if _on_sm90(dtype, d, forward=True):
        return f"flash_fwd_{variant}"
    if dtype == torch.bfloat16 and d <= fa.SM90_DYN_MAX_HEAD_DIM:
        return f"flash_fwd_sm90dyn_{variant}"
    return f"flash_fwd_{_family(d)}_{variant}"


def _bwd_names(dtype, d=128):
    if _on_sm90(dtype, d):
        return "flash_bwd_sm90_dq", "flash_bwd_sm90_dkv"
    return f"flash_bwd_{_family(d)}_dq", f"flash_bwd_{_family(d)}_dkv"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(40, 128), (256, 128), (192, 64), (64, 16),
                                 (130, 32)])
def test_backward_kernels_match_plain(card, dtype, causal, s, d):
    q, k, v = _qkv(20 + s, 2, s, 3, d, dtype, card)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(s)).to(
        card, dtype)
    qf, kf, vf, gf = (t.transpose(1, 2).reshape(6, s, d).contiguous()
                      for t in (q, k, v, g))
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, "online")
    delta = ref.flash_delta(out, gf)
    fa.reset_launch_counts()
    got = fa._kernel_bwd(qf, kf, vf, gf, lse, delta, causal, d ** -0.5)
    assert dict(fa.launch_counts) == dict.fromkeys(_bwd_names(dtype), 1)
    for a, w in zip(got, _plain_grads(qf, kf, vf, gf, lse, delta, causal)):
        assert a.dtype == dtype
        _assert_grad_close(a, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [100, 48])
def test_autograd_through_the_kernels_matches_plain_path(card, dtype, s):
    q, k, v = _qkv(30, 1, s, 6, 128, dtype, card)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(31)).to(
        card, dtype)

    def grads():
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fa.flash_attention(*ts, causal=True, device=card).backward(g)
        return [t.grad for t in ts]
    fa.reset_launch_counts()
    got = grads()
    assert [fa.launch_counts[n] for n in _bwd_names(dtype)] == [1, 1]

    def plain_fwd(qf, kf, vf, causal, scale, variant):
        return ref.FWD[variant](qf, kf, vf, causal,
                                *fa.kernel_blocks(qf, kf, variant), scale)

    def plain_bwd(qf, kf, vf, dof, lse, delta, causal, scale):
        return _plain_grads(qf, kf, vf, dof, lse, delta, causal)
    saved = fa._kernel_fwd, fa._kernel_bwd
    fa._kernel_fwd, fa._kernel_bwd = plain_fwd, plain_bwd
    try:
        want = grads()
    finally:
        fa._kernel_fwd, fa._kernel_bwd = saved
    for a, w in zip(got, want):
        _assert_grad_close(a, w, dtype)


def _check_sm90_bwd(seed, bh, sq, sk, d, causal, device, cta_rows=None,
                    k_ramp=None):
    """The bf16 wgmma/TMA backward pair on ``[b·h, s, d]`` operands (dq's
    CTA shape forced when ``cta_rows`` is given) against the plain walks
    at the kernels' own tiles; lse and delta from the plain forward."""
    g = torch.Generator().manual_seed(seed)
    qf, gf = (torch.randn(bh, sq, d, generator=g) for _ in range(2))
    kf, vf = (torch.randn(bh, sk, d, generator=g) for _ in range(2))
    if k_ramp is not None:
        kf = kf * k_ramp[None, :, None]
    qf, kf, vf, gf = (t.to(device, torch.bfloat16) for t in (qf, kf, vf, gf))
    out, lse = ref.flash_fwd_online(qf, kf, vf, causal, 64, 64)
    delta = ref.flash_delta(out, gf)
    fa.reset_launch_counts()
    got = fa._kernel_bwd(qf, kf, vf, gf, lse, delta, causal, d ** -0.5,
                         cta_rows=cta_rows)
    assert dict(fa.launch_counts) == {"flash_bwd_sm90_dq": 1,
                                      "flash_bwd_sm90_dkv": 1}
    for a, w in zip(got, _plain_grads(qf, kf, vf, gf, lse, delta, causal,
                                      cta_rows)):
        assert a.dtype == torch.bfloat16
        _assert_grad_close(a, w, torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_sm90_backward_every_head_dim(card, causal, d):
    """Each head dim's swizzle at s 192: a 128-key tile and a partial one,
    three 64-query tiles, b·h = 3."""
    _check_sm90_bwd(60 + d, 3, 192, 192, d, causal, card)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cta_rows", [64, 128])
def test_sm90_backward_both_dq_cta_shapes(card, causal, cta_rows):
    """One and two dq consumer warpgroups, forced, at s 384: with 128 query
    rows the causal diagonal splits the CTA's tile between the two."""
    _check_sm90_bwd(61, 2, 384, 384, 128, causal, card, cta_rows)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(960, 128), (1000, 64)])
def test_sm90_backward_partial_last_tile_per_head(card, causal, s, d):
    """s 960 ends in half a 128-key tile, s 1000 in partial 128-key and
    64-query tiles, at b·h >= 2: a flat tensor map would read the next
    head's rows, and a padded query's lse must not leak into dk."""
    _check_sm90_bwd(62, 6 if s == 960 else 2, s, s, d, causal, card)


@pytest.mark.parametrize("cta_rows", [64, 128])
@pytest.mark.parametrize("sq,sk,d", [(192, 320, 64), (320, 200, 32)])
def test_sm90_backward_non_causal_sq_not_sk(card, cta_rows, sq, sk, d):
    _check_sm90_bwd(63, 4, sq, sk, d, False, card, cta_rows)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("ramp", ["down", "up"])
@pytest.mark.parametrize("cta_rows", [64, 128])
def test_sm90_backward_rising_max(card, causal, ramp, cta_rows):
    """Keys ramped so the logits' scale changes across every k tile, in
    either order."""
    k_ramp = torch.linspace(4.0, 0.5, 512)
    if ramp == "up":
        k_ramp = k_ramp.flip(0)
    _check_sm90_bwd(64, 6, 512, 512, 128, causal, card, cta_rows, k_ramp)


def test_sm90_backward_training_shape(card):
    """The flagship's b16 h6 s1024 d128 causal, at the CTA shape the host
    picks there (128 query rows)."""
    _check_sm90_bwd(65, 96, 1024, 1024, 128, True, card)


def test_backward_refuses_what_it_cannot_take(card):
    q, k, v = _qkv(32, 1, 64, 2, 64, torch.bfloat16, card)
    qf, kf, vf = (t.transpose(1, 2).reshape(2, 64, 64).contiguous()
                  for t in (q, k, v))
    lse = torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="dO"):
        fa._kernel_bwd(qf, kf, vf, qf.float(), lse, lse, True, 0.125)
    with pytest.raises(ValueError, match="lse and delta"):
        fa._kernel_bwd(qf, kf, vf, qf, lse.double(), lse, True, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 192, 224, 256])
def test_wide_head_dims_through_the_kernels(card, dtype, causal, d):
    """Head dims above 128 (zero-padded to 256 on the host below it): bf16
    on the wgmma kernels (64-key tiles forward, 64 x 64 walks backward),
    fp32 on the CUDA-core kernels (64-row tiles; 32-key tiles in the
    backward), at a partial-tile length, agree with the plain walks at the
    true d and the kernels' tiles."""
    q, k, v = _qkv(70 + d, 1, 200, 3, d, dtype, card)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(
        card, dtype)
    fa.reset_launch_counts()
    got = _public_fwd_bwd(q, k, v, g, causal, card, variant="online")
    assert dict(fa.launch_counts) == {_fwd_name(dtype, "online", d): 1,
                                      **dict.fromkeys(_bwd_names(dtype, d),
                                                      1)}
    qf, kf, vf, gf = (_flat_bshd(t) for t in (q, k, v, g))
    assert fa.bwd_kernel_blocks(qf, kf) == (
        ((64, 64), (64, 64)) if dtype == torch.bfloat16
        else ((64, 32), (64, 32)))
    out, lse = ref.flash_fwd_online(qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, "online"))
    delta = ref.flash_delta(out, gf)
    _assert_kernel_close(got[0], out, "O", dtype)
    for a, w in zip(got[1:], _plain_grads(qf, kf, vf, gf, lse, delta,
                                          causal)):
        assert a.shape == w.shape
        _assert_grad_close(a, w, dtype)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(130, 130, True), (64, 200, False)])
def test_d256_forward_every_walk(card, variant, dtype, sq, sk, causal):
    """Each forward walk at d 256 against its plain version at the
    kernel's tiles: bf16 on the wgmma kernel (64-key tiles), fp32 on the
    CUDA-core one (64-row tiles)."""
    g = torch.Generator().manual_seed(sq + sk)
    qf = torch.randn(2, sq, 256, generator=g)
    kf, vf = (torch.randn(2, sk, 256, generator=g) for _ in range(2))
    qf, kf, vf = (t.to(card, dtype) for t in (qf, kf, vf))
    fa.reset_launch_counts()
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, 256 ** -0.5, variant)
    assert dict(fa.launch_counts) == {_fwd_name(dtype, variant, 256): 1}
    p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, variant))
    _assert_kernel_close(out, p_out, "O", dtype)
    _assert_kernel_close(lse, p_lse, "lse", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [288, 384, 512, 1024])
def test_beyond_256_through_the_kernels(card, dtype, causal, d):
    """Head dims above 256 run on the run-time-d kernels through the public
    autograd path, forward and backward, at a partial-tile length (s 200
    = 6 · 32 + 8 = 3 · 64 + 8), and agree with the plain walks at the
    kernels' tiles (the bf16 forward's 64-key wgmma tiles, the rest 32-row
    tiles); at d 1024 the dk/dv accumulators are in the device
    workspace."""
    q, k, v = _qkv(90 + d, 1, 200, 3, d, dtype, card)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(
        card, dtype)
    fa.reset_launch_counts()
    got = _public_fwd_bwd(q, k, v, g, causal, card, variant="online")
    assert dict(fa.launch_counts) == {_fwd_name(dtype, "online", d): 1,
                                      **dict.fromkeys(_bwd_names(dtype, d),
                                                      1)}
    qf, kf, vf, gf = (_flat_bshd(t) for t in (q, k, v, g))
    assert fa.bwd_kernel_blocks(qf, kf) == ((32, 32), (32, 32))
    out, lse = ref.flash_fwd_online(qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, "online"))
    delta = ref.flash_delta(out, gf)
    _assert_kernel_close(got[0], out, "O", dtype)
    for a, w in zip(got[1:], _plain_grads(qf, kf, vf, gf, lse, delta,
                                          causal)):
        assert a.shape == w.shape
        _assert_grad_close(a, w, dtype)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [288, 512])
@pytest.mark.parametrize("sq,sk,causal", [(130, 130, True), (64, 200, False)])
@pytest.mark.parametrize("workspace", [False, True])
def test_beyond_256_every_walk(card, variant, dtype, d, sq, sk, causal,
                               workspace):
    """Each forward walk, and dq and dk/dv, on the run-time-d kernels with
    their accumulators in shared memory and forced into the device
    workspace (the bf16 forward, on wgmma, keeps none), against the plain
    walks at the kernels' tiles; sq != sk, partial last tiles."""
    g = torch.Generator().manual_seed(sq + sk + d)
    qf, dof = (torch.randn(2, sq, d, generator=g) for _ in range(2))
    kf, vf = (torch.randn(2, sk, d, generator=g) for _ in range(2))
    qf, kf, vf, dof = (t.to(card, dtype) for t in (qf, kf, vf, dof))
    fa.reset_launch_counts()
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, variant,
                              workspace=workspace)
    assert dict(fa.launch_counts) == {_fwd_name(dtype, variant, d): 1}
    p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, variant))
    _assert_kernel_close(out, p_out, "O", dtype)
    _assert_kernel_close(lse, p_lse, "lse", dtype)
    delta = ref.flash_delta(p_out, dof)
    got = fa._kernel_bwd(qf, kf, vf, dof, p_lse, delta, causal, d ** -0.5,
                         workspace=workspace)
    for a, w in zip(got, _plain_grads(qf, kf, vf, dof, p_lse, delta,
                                      causal)):
        _assert_grad_close(a, w, dtype)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("d,cta_rows", [(288, 64), (288, 128), (384, 64),
                                        (384, 128), (512, 64), (512, 128),
                                        (1024, 64)])
@pytest.mark.parametrize("sq,sk,causal,ramp", [(130, 130, True, None),
                                               (64, 200, False, None),
                                               (256, 256, True, "down"),
                                               (256, 256, False, "up")])
def test_sm90dyn_forward_every_walk(card, variant, d, cta_rows, sq, sk,
                                    causal, ramp):
    """The bf16 forward above 256 on the run-time-d wgmma kernel
    (flash_fwd_sm90_dyn.cu), each walk at both CTA shapes where 128 query
    rows fit (d <= 576), against the plain walk at its 64-key tiles:
    partial last tiles, sq != sk, the rising-max adversaries (keys ramped
    down, causal; up, non-causal)."""
    assert fa.sm90dyn_fits(d, cta_rows)
    g = torch.Generator().manual_seed(sq + sk + d + cta_rows)
    qf = torch.randn(2, sq, d, generator=g)
    kf, vf = (torch.randn(2, sk, d, generator=g) for _ in range(2))
    if ramp:
        r = torch.linspace(4.0, 0.5, sk)
        kf = kf * (r if ramp == "down" else r.flip(0))[None, :, None]
    qf, kf, vf = (t.to(card, torch.bfloat16) for t in (qf, kf, vf))
    fa.reset_launch_counts()
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, variant,
                              cta_rows=cta_rows)
    assert dict(fa.launch_counts) == {f"flash_fwd_sm90dyn_{variant}": 1}
    p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal, cta_rows,
                                    fa.SM90_DYN_BLOCK_K)
    _assert_kernel_close(out, p_out, "O", torch.bfloat16)
    _assert_kernel_close(lse, p_lse, "lse", torch.bfloat16)


@pytest.mark.parametrize("variant", fa.VARIANTS)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("sq,sk,causal,ramp", [(192, 192, True, None),
                                               (130, 130, True, None),
                                               (100, 300, False, None),
                                               (512, 512, True, "down"),
                                               (512, 512, False, "up")])
def test_cc_forward_every_head_dim(card, variant, d, sq, sk, causal, ramp):
    """The fp32 register-blocked forward (flash_fwd.cu) at every compiled
    head dim, each walk, against the plain walk at its 64-row tiles to
    2e-5: partial last tiles, sq != sk, the rising-max adversaries."""
    g = torch.Generator().manual_seed(sq + sk + d)
    qf = torch.randn(3, sq, d, generator=g)
    kf, vf = (torch.randn(3, sk, d, generator=g) for _ in range(2))
    if ramp:
        r = torch.linspace(4.0, 0.5, sk)
        kf = kf * (r if ramp == "down" else r.flip(0))[None, :, None]
    qf, kf, vf = (t.to(card) for t in (qf, kf, vf))
    fa.reset_launch_counts()
    out, lse = fa._kernel_fwd(qf, kf, vf, causal, d ** -0.5, variant)
    assert dict(fa.launch_counts) == {f"flash_fwd_cc_{variant}": 1}
    p_out, p_lse = ref.FWD[variant](qf, kf, vf, causal,
                                    *fa.kernel_blocks(qf, kf, variant))
    _assert_kernel_close(out, p_out, "O", torch.float32)
    _assert_kernel_close(lse, p_lse, "lse", torch.float32)


def _ring_pair(dtype, d, card, offset=0.0, seed=90, bh=6, s=256):
    """A ring's later pair as the backward sees it: q against a non-causal
    K/V block (keys offset by ``offset``), a merged lse that includes the
    block's mass for the even rows and is +1e30 (a future pair) for the
    odd ones, and the merged O and dO."""
    g = torch.Generator().manual_seed(seed)
    qf, kf, vf, of, dof = (torch.randn(bh, s, d, generator=g)
                           for _ in range(5))
    qf, kf, vf, of, dof = (t.to(card, dtype) for t in (qf, kf + offset, vf,
                                                       of, dof))
    logits = torch.matmul(qf.float(), kf.float().transpose(1, 2)) * d ** -0.5
    lse = torch.logsumexp(logits, dim=-1) + 1.0   # other blocks' mass
    future = torch.arange(s, device=card) % 2 == 1
    lse = torch.where(future, torch.full_like(lse, 1e30), lse)
    return qf, kf, vf, of, dof, lse.contiguous(), future


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256, 288])
def test_ring_pair_merged_lse_backward(card, dtype, d):
    """The backward kernels under a caller's merged lse with +1e30 rows:
    those rows' p is exactly 0 (their dq exactly 0, nothing from them in
    dk/dv), and every gradient agrees with the plain walks."""
    qf, kf, vf, of, dof, lse, future = _ring_pair(dtype, d, card)
    delta = ref.flash_delta(of, dof)
    dq, dk, dv = fa._kernel_bwd(qf, kf, vf, dof, lse, delta, False,
                                d ** -0.5)
    assert torch.count_nonzero(dq[:, future]) == 0
    for a, w in zip((dq, dk, dv), _plain_grads(qf, kf, vf, dof, lse, delta,
                                               False)):
        _assert_grad_close(a, w, dtype)
    keep = ~future
    want = _plain_grads(qf[:, keep].contiguous(), kf, vf,
                        dof[:, keep].contiguous(),
                        lse[:, keep].contiguous(),
                        delta[:, keep].contiguous(), False)
    for a, w in zip((dk, dv), want[1:]):
        _assert_grad_close(a, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256, 288])
def test_ring_future_pair_with_large_logits_is_exactly_zero(card, dtype, d):
    """A wholly future pair (every row's lse +1e30) whose keys are offset
    by 1e3, so its logits reach the thousands: p underflows to exactly 0
    inside the kernels, with no inf or NaN, and dq, dk and dv are exactly
    zero."""
    qf, kf, vf, of, dof, lse, _ = _ring_pair(dtype, d, card, offset=1e3)
    lse = torch.full_like(lse, 1e30)
    delta = ref.flash_delta(of, dof)
    for t in fa._kernel_bwd(qf, kf, vf, dof, lse, delta, False, d ** -0.5):
        assert torch.count_nonzero(t) == 0


def test_training_step_launches_the_kernels(card):
    mpi_ops.init()
    try:
        cfg = tr.TransformerConfig.tiny(attention_impl="flash",
                                        tie_embeddings=True,
                                        logits_fp32=False)
        model = tr.init_params(cfg, device=card, train=True)
        opt = optim.DistributedOptimizer(
            optim.AdamW(model.parameters(), 3e-3, mu_dtype=torch.bfloat16))
        step = trainer.make_train_step(model, opt, tr.lm_loss_fn(model))
        tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                               generator=torch.Generator().manual_seed(0)
                               ).to(card)
        fa.reset_launch_counts()
        losses = [step(tokens).item() for _ in range(4)]
        assert losses[-1] < losses[0]
        n = 4 * cfg.num_layers
        assert dict(fa.launch_counts) == {"flash_fwd_lazy": n,
                                          "flash_bwd_sm90_dq": n,
                                          "flash_bwd_sm90_dkv": n}
        x = torch.arange(5.0, device=card)
        assert torch.equal(mpi_ops.allreduce(x, average=False), x)
    finally:
        mpi_ops.shutdown()


def _bn_operands(seed, rows, c, dtype, device, offset=0.0, misalign=False):
    """a, b [rows, C]; ``misalign`` starts both one element past an
    allocation's start, so no vector load is aligned."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for scale in (1.0, 0.5):
        t = (torch.randn(rows, c, generator=g) * scale + offset).to(
            device, dtype)
        if misalign:
            buf = torch.empty(rows * c + 1, dtype=dtype, device=device)
            buf[1:].copy_(t.reshape(-1))
            t = buf[1:].view(rows, c)
        out.append(t)
    return out


def _assert_sums_close(got, a, b=None):
    """Within 1e-5 of the per-channel sum of magnitudes of a float64
    reference (the plain version is held to the same)."""
    a64 = a.double()
    b64 = a64 if b is None else b.double()
    exact = (a64.sum(0), (a64 * b64).sum(0))
    mags = (a64.abs().sum(0), (a64 * b64).abs().sum(0))
    for g_, e, m in zip(got, exact, mags):
        assert g_.dtype == torch.float32
        assert ((g_.double() - e).abs() <= 1e-5 * m + 1e-30).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(401408, 64), (6272, 1024), (1568, 2048),
                                    (21, 24), (1000, 3), (1, 2048), (7, 1000),
                                    (0, 5)])
@pytest.mark.parametrize("offset", [0.0, 1e3])
def test_bn_kernels_match_float64_and_plain(card, dtype, rows, c, offset):
    a, b = _bn_operands(rows + c, rows, c, dtype, card, offset)
    bn.reset_counts()
    got1, got2 = bn._kernel(a), bn._kernel(a, b)
    assert dict(bn.launch_counts) == {"bn_moments": 1, "bn_moments2": 1}
    _assert_sums_close(got1, a)
    _assert_sums_close(got2, a, b)
    _assert_sums_close(bn_ref.moments(a), a)
    _assert_sums_close(bn_ref.moments2(a, b), a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernels_take_unaligned_rows(card, dtype):
    a, b = _bn_operands(3, 300, 64, dtype, card, misalign=True)
    assert a.data_ptr() % 16
    _assert_sums_close(bn._kernel(a), a)
    _assert_sums_close(bn._kernel(a, b), a, b)


def test_bn_kernel_refuses_what_it_cannot_take(card):
    a = torch.ones(8, 4, dtype=torch.float16, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn._kernel(a)
    b = torch.ones(8, 4, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="does not fit"):
        bn._kernel(b, b.float())


def test_tpu_batchnorm_through_the_kernels_matches_plain_path(card):
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(4, 24, 5, 5, generator=g) * 2 + 0.5).to(card)
    x = x.contiguous(memory_format=torch.channels_last)

    def run():
        mod = bn.TpuBatchNorm(24, momentum=0.9, device=card).train()
        xt = x.detach().clone().requires_grad_(True)
        y = mod(xt)
        (y ** 2 + 0.3 * y).sum().backward()
        return y, xt.grad, mod.scale.grad, mod.bias.grad, mod.mean, mod.var
    bn.reset_counts()
    got = run()
    assert dict(bn.launch_counts) == {"bn_moments": 1, "bn_moments2": 1}
    saved = bn._kernel
    bn._kernel = lambda af, bf=None: (bn_ref.moments(af) if bf is None
                                      else bn_ref.moments2(af, bf))
    try:
        want = run()
    finally:
        bn._kernel = saved
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-5, atol=2e-5)


def test_resnet_step_launches_the_bn_kernels(card):
    mpi_ops.init()
    try:
        model = models.build("resnet18", num_classes=10, norm_impl="tpu",
                             device=card).train()
        opt = optim.DistributedOptimizer(
            optim.SGD(model.parameters(), 0.01, momentum=0.9))
        step = trainer.make_data_parallel_step(
            model, opt,
            lambda m, b: trainer.softmax_cross_entropy(m(b[0]), b[1]))
        g = torch.Generator().manual_seed(0)
        images = torch.randn(8, 3, 64, 64, generator=g).to(
            card, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        labels = torch.randint(0, 10, (8,), generator=g).to(card)
        bn.reset_counts()
        losses = [step((images, labels)).item() for _ in range(4)]
        assert losses[-1] < losses[0]
        # 20 BatchNorms in ResNet-18: the stem, 2 per block, 3 projections
        assert dict(bn.launch_counts) == {"bn_moments": 80,
                                          "bn_moments2": 80}
        assert not bn.layout_copies
    finally:
        mpi_ops.shutdown()


# ---------------------------------------------------------------------------
# the eager core's CUDA completion machinery (ops/process_collectives.py
# StreamSync): ready events on the producer's stream, record_stream on
# inputs and fusion buffers, completion events handed to the caller


@pytest.fixture
def core(card):
    mpi_ops.init()
    from horovod_tpu_torch.common import state
    yield state.global_state().coordinator
    mpi_ops.shutdown()


def _slow_fill(t, value, side):
    """Fill ``t`` with ``value`` on ``side`` behind a long chain of
    kernels, so a reader that does not wait on ``side`` sees stale
    data."""
    with torch.cuda.stream(side):
        x = torch.randn(2048, 2048, device=t.device)
        for _ in range(30):
            x = x @ x * 1e-3
        t.copy_(torch.full_like(t, value) + 0 * x[0, 0])


def test_eager_allreduce_waits_on_the_producer_stream(core):
    side = torch.cuda.Stream()
    tensors = [torch.zeros(1000 + i, device="cuda", dtype=dt)
               for i, dt in enumerate([torch.float32, torch.bfloat16,
                                       torch.int32] * 8)]
    for i, t in enumerate(tensors):
        _slow_fill(t, i + 1, side)
    with torch.cuda.stream(side):
        handles = mpi_ops.grouped_allreduce_async(tensors, average=False)
    outs = [mpi_ops.synchronize(h) for h in handles]
    for i, o in enumerate(outs):
        assert torch.equal(o.cpu(), torch.full((1000 + i,), i + 1,
                                               dtype=o.dtype))


def test_freed_inputs_in_flight_keep_their_memory(core):
    side = torch.cuda.Stream()
    handles = []
    with core.hold_cycle():
        for i in range(16):
            t = torch.empty(1 << 16, device="cuda")
            _slow_fill(t, float(i), side)
            with torch.cuda.stream(side):
                handles.append(mpi_ops.allreduce_async(t, average=False))
            del t
            # allocations that would reuse a freed input's block
            junk = torch.full((1 << 16,), -1.0, device="cuda")
            del junk
    for i, h in enumerate(handles):
        out = mpi_ops.synchronize(h)
        assert torch.equal(out.cpu(), torch.full((1 << 16,), float(i)))


def test_poll_reports_completion_on_the_device(core):
    h = mpi_ops.allreduce_async(torch.ones(1 << 20, device="cuda"))
    deadline = __import__("time").monotonic() + 30
    while not mpi_ops.poll(h):
        assert __import__("time").monotonic() < deadline
    assert mpi_ops.synchronize(h).sum().item() == float(1 << 20)


def test_eager_lm_step_on_the_card(core):
    cfg = tr.TransformerConfig.tiny(attention_impl="flash")
    step, model, opt, toks = trainer.build_eager_lm_step(
        cfg, 2, 128, torch.device("cuda"), inner=3)
    fa.reset_launch_counts()
    losses = [step(toks[i]).item() for i in range(3)]
    assert all(map(lambda v: v == v, losses)) and losses[-1] < losses[0]
    assert fa.launch_counts.get("flash_bwd_sm90_dq", 0) == \
        3 * cfg.num_layers


# -- the quantized wire on the card


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097, 1 << 20])
def test_codecs_on_the_card_equal_the_cpu(card, codec, n):
    """Every operation of the codec is IEEE f32 arithmetic, so the card's
    payload bytes and scales equal the CPU's."""
    from horovod_tpu_torch.ops import quantization as q
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=g) * 30
    x[:min(n, 256)] = 0.0
    if n > 300:
        x[260], x[261] = 448.0, -448.0
    for multiple in (None, 512):
        qc, sc = q.encode(x, 256, codec, multiple=multiple)
        qg, sg = q.encode(x.to(card), 256, codec, multiple=multiple)
        assert torch.equal(qg.view(torch.uint8).cpu(), qc.view(torch.uint8))
        assert torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))
        dc, dg = q.decode(qc, sc, 256, n), q.decode(qg, sg, 256, n)
        assert torch.equal(dg.cpu().view(torch.int32), dc.view(torch.int32))


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_quantized_allreduce_world_one_on_nccl(card, codec, monkeypatch):
    """The eager core's quantized leg at world 1 over NCCL: the requantized
    decode of the rank's own contribution, as on the CPU."""
    from horovod_tpu_torch.ops import quantization as q
    monkeypatch.setenv("HOROVOD_COMPRESSION", codec)
    mpi_ops.init()
    try:
        from horovod_tpu_torch.common import state
        assert state.global_state().backend == "nccl"
        x = torch.randn(10_000, generator=torch.Generator().manual_seed(1))
        out = mpi_ops.allreduce(x.to(card), average=False)
    finally:
        mpi_ops.shutdown()
    want, _ = q.stacked_wire_allreduce(x[None], 256, codec, False, 10_000)
    assert torch.equal(out.cpu().view(torch.int32),
                       want[0].contiguous().view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sizes", [[5, 0, 70000, 1, 0, 16384, 16385],
                                   [3 * 16384 + 7], [0]])
def test_segment_stats_kernel_matches_plain(card, dtype, sizes):
    """The stats kernel (csrc/segment_stats.cu) against its plain version
    on the same buffer: counts exact, L2, max-abs and checksum within
    1e-6, the zero fraction within 1e-7; NaN, +-inf and zeros planted,
    and the same buffer one element in (an unaligned start)."""
    from horovod_tpu_torch.utils import numerics
    n = sum(sizes)
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(dtype)
    if n > 8:
        x[[1, n // 2, n - 2, 4]] = torch.tensor(
            [float("nan"), float("inf"), -float("inf"), 0.0]).to(dtype)
    x = x.to(card)
    cases = [(x, sizes)]
    if sizes[0] > 1:
        cases.append((x[1:], [sizes[0] - 1] + sizes[1:]))
    for buf, sz in cases:
        numerics.reset_launch_counts()
        got = numerics.segment_stats(buf, sz).double().cpu()
        assert numerics.launch_counts["segment_stats"] == 1
        want = numerics.segment_stats_plain(buf, sz).double().cpu()
        assert torch.equal(got[:, 2], want[:, 2])
        torch.testing.assert_close(got[:, 3], want[:, 3], rtol=0, atol=1e-7)
        for c in (0, 1, 4):
            torch.testing.assert_close(got[:, c], want[:, c], rtol=1e-6,
                                       atol=1e-6)
