"""horovod_tpu_torch's flash-attention backward against the JAX package.

The port's plain versions of the backward kernels (``flash_bwd_dq`` and
``flash_bwd_dkv``, the CPU path of its flash entry points) are fed the
same numpy-seeded inputs as ``horovod_tpu.ops.flash_attention._flash_bwd``,
whose Pallas kernels run in interpret mode, with the lse of the JAX
forward (``lse[:, 0, :]``: the port drops the TPU's 8-row replication).
Then the port's differentiable ``flash_attention`` is held to ``jax.grad``
of the JAX one, per forward variant, on a ragged causal tail and on one
partial tile, and to finite differences. Tolerances are the JAX
package's own: fp32 rtol 1e-4 / atol 1e-5 (tests/test_flash_attention.py),
bf16 5e-2 (tests/test_flash_variants.py). The CUDA kernels are held to
the same plain versions on the card by ``chip_smoke.py`` and
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import flash_attention_ref as tref

VARIANTS = ("online", "lazy", "twopass")
_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _arrays(seed, n=4, b=2, s=128, h=2, d=32, scale=0.3):
    r = np.random.RandomState(seed)
    return [(r.randn(b, s, h, d) * scale).astype(np.float32)
            for _ in range(n)]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **_TOL[dtype])


class TestPlainBackwardAgainstPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_dq_dk_dv(self, hvd, dtype, causal):
        from horovod_tpu.ops import flash_attention as jfa
        arrs = _arrays(0, scale=1.0)
        jq, jk, jv, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, 64, 64, True)
        want = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, 64, 64,
                              True)
        tq, tk, tv, tg = (torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in arrs)
        t_out = torch.from_numpy(np.array(j_out, np.float32)).to(tq.dtype)
        t_lse = torch.from_numpy(np.asarray(j_lse)[:, 0, :].copy())
        got = tfa.flash_bwd(tq, tk, tv, t_out, t_lse, tg, causal, 64, 64)
        for g, w in zip(got, want):
            assert g.dtype == tq.dtype and g.shape == tq.shape
            _close(g, w, dtype)

    def test_delta_is_rowsum_of_do_times_o(self):
        r = np.random.RandomState(1)
        o, do = (torch.from_numpy(r.randn(3, 7, 16).astype(np.float32))
                 for _ in range(2))
        torch.testing.assert_close(tref.flash_delta(o, do),
                                   (o * do).sum(-1), rtol=1e-6, atol=1e-6)

    def test_causal_dkv_starts_at_the_diagonal(self):
        """Keys of the last tile are seen only by queries of the last
        tile: their gradients must not change when the earlier queries'
        dO changes."""
        arrs = _arrays(2, b=1, h=1, s=128, d=16)
        q, k, v, g = (torch.from_numpy(a)[0].transpose(0, 1).contiguous()
                      for a in arrs)
        out, lse = tref.flash_fwd_online(q, k, v, True, 64, 64)
        base = tref.flash_bwd_dkv(q, k, v, g, lse, tref.flash_delta(out, g),
                                  True, 64, 64)
        g2 = g.clone()
        g2[:, :64] = 7.0
        moved = tref.flash_bwd_dkv(q, k, v, g2, lse,
                                   tref.flash_delta(out, g2), True, 64, 64)
        for a, b in zip(base, moved):
            torch.testing.assert_close(a[:, 64:], b[:, 64:], rtol=0, atol=0)
            assert not torch.equal(a[:, :64], b[:, :64])


def _jax_grads(arrs, dtype, causal=True):
    from horovod_tpu.ops.flash_attention import flash_attention
    jq, jk, jv, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)

    def loss(q, k, v):
        out = flash_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))
    return jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)


def _port_grads(arrs, dtype, causal=True, variant="auto"):
    tq, tk, tv, tg = (torch.from_numpy(a).to(getattr(torch, dtype))
                      for a in arrs)
    ts = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention(*ts, causal=causal, variant=variant,
                              device="cpu")
    (out.float() * tg.float()).sum().backward()
    return [t.grad for t in ts]


class TestAutogradAgainstJaxGrad:
    @pytest.mark.parametrize("variant", VARIANTS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_per_variant(self, hvd, variant, dtype):
        arrs = _arrays(3)
        want = _jax_grads(arrs, dtype)
        got = _port_grads(arrs, dtype, variant=variant)
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            _close(g, w, dtype)

    def test_gradients_are_variant_independent(self):
        arrs = _arrays(4)
        grads = [_port_grads(arrs, "float32", variant=v) for v in VARIANTS]
        for other in grads[1:]:
            for a, b in zip(grads[0], other):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("s", [100, 48])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ragged_and_partial_tiles(self, hvd, s, dtype):
        """s=100: causal end-padding to 128, whose padded rows get dO = 0
        and must add nothing to dk/dv; s=48: one partial tile."""
        arrs = _arrays(7, s=s)
        want = _jax_grads(arrs, dtype)
        got = _port_grads(arrs, dtype)
        for g, w in zip(got, want):
            assert g.shape == (2, s, 2, 32)
            _close(g, w, dtype)

    def test_non_causal(self, hvd):
        arrs = _arrays(8)
        for g, w in zip(_port_grads(arrs, "float32", causal=False),
                        _jax_grads(arrs, "float32", causal=False)):
            _close(g, w, "float32")

    def test_bhsd_layout_matches_bshd(self):
        arrs = _arrays(9, s=64)
        want = _port_grads(arrs, "float32")
        tq, tk, tv, tg = (torch.from_numpy(a).transpose(1, 2).contiguous()
                          for a in arrs)
        ts = [t.requires_grad_(True) for t in (tq, tk, tv)]
        (tfa.flash_attention(*ts, layout="bhsd", device="cpu") * tg).sum() \
            .backward()
        for t, w in zip(ts, want):
            torch.testing.assert_close(t.grad.transpose(1, 2), w, rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.filterwarnings("ignore:Input #:UserWarning")
def test_finite_differences():
    """gradcheck of the plain path in fp32 at a loose tolerance (the tile
    walk computes in fp32 whatever the input dtype, so fp64 would not be
    tighter), on one 64-row tile."""
    arrs = _arrays(10, n=3, b=1, s=64, h=1, d=16, scale=1.0)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    w = torch.from_numpy(_arrays(11, n=1, b=1, s=64, h=1, d=16)[0])

    def f(q, k, v):
        return (tfa.flash_attention(q, k, v, device="cpu") * w).sum()
    assert torch.autograd.gradcheck(f, ts, eps=1e-2, atol=5e-3, rtol=5e-2,
                                    fast_mode=True)
