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
