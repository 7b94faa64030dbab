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

from horovod_tpu_torch import mpi_ops, optim, trainer
from horovod_tpu_torch.models import transformer as tr
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
    b, s, h, d = q.shape
    out, lse = fa.flash_fwd(q, k, v, causal, variant=variant)
    flat = [t.transpose(1, 2).reshape(b * h, s, d) for t in (q, k, v)]
    block = fa.fit_block(s)
    p_out, p_lse = ref.FWD[variant](*flat, causal, block, block)
    _assert_kernel_close(out.transpose(1, 2).reshape(b * h, s, d), p_out,
                         "O", dtype)
    _assert_kernel_close(lse, p_lse, "lse", dtype)


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


def test_kernel_refuses_what_it_cannot_take(card):
    q, k, v = _qkv(13, 1, 64, 2, 128, torch.float16, card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, k, v, True)
    q, k, v = _qkv(13, 1, 64, 2, 96, torch.bfloat16, card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, k, v, True)
    q, k, v = _qkv(13, 1, 128, 2, 64, torch.bfloat16, card)
    with pytest.raises(ValueError, match="64-row tiles"):
        fa.flash_fwd(q, k, v, True, block_q=32, block_k=32)


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


def _plain_grads(qf, kf, vf, gf, lse, delta, causal):
    block = fa.fit_block(qf.shape[1])
    dq = ref.flash_bwd_dq(qf, kf, vf, gf, lse, delta, causal, block, block)
    return (dq, *ref.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, causal, block,
                                   block))


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
    assert dict(fa.launch_counts) == {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}
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
    assert fa.launch_counts["flash_bwd_dq"] == 1
    block = fa.fit_block(s)

    def plain_fwd(qf, kf, vf, causal, scale, variant):
        return ref.FWD[variant](qf, kf, vf, causal, block, block, scale)

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


def test_backward_refuses_what_it_cannot_take(card):
    q, k, v = _qkv(32, 1, 64, 2, 64, torch.bfloat16, card)
    qf, kf, vf = (t.transpose(1, 2).reshape(2, 64, 64).contiguous()
                  for t in (q, k, v))
    lse = torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="dO"):
        fa._kernel_bwd(qf, kf, vf, qf.float(), lse, lse, True, 0.125)
    with pytest.raises(ValueError, match="lse and delta"):
        fa._kernel_bwd(qf, kf, vf, qf, lse.double(), lse, True, 0.125)


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
                                          "flash_bwd_dq": n,
                                          "flash_bwd_dkv": n}
        x = torch.arange(5.0, device=card)
        assert torch.equal(mpi_ops.allreduce(x, average=False), x)
    finally:
        mpi_ops.shutdown()
