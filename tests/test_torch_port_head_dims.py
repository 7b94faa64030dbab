"""Head dims above 256: the port against the JAX package.

On the card every d > 256 runs unpadded on the run-time-d kernels
(``csrc/flash_dyn.cu``), which walk 32-row q and k tiles
(``flash_attention.DYN_BLOCK``). Here their plain versions at those
tiles, and the port's differentiable ``flash_attention`` on the CPU, are
fed the same numpy-seeded inputs as the JAX package's ``flash_attention``
(Pallas in interpret mode; it takes any d), at d 288 and 512 and a short
sequence with a partial last tile of the kernels' walk (s 40 = 32 + 8):
O, lse and the gradients of a seeded loss. Tolerances are the JAX
package's own: fp32 forward 2e-5, gradients rtol 1e-4 / atol 1e-5
(tests/test_flash_attention.py). The kernels themselves are held to the
same plain walks on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import flash_attention_ref as tref

B, S, H = 1, 40, 2


def _inputs(seed, d, s=S):
    r = np.random.RandomState(seed)
    arrs = [r.randn(B, s, H, d).astype(np.float32) for _ in range(4)]
    return arrs


def _flat(a):
    """[b, s, h, d] numpy -> the kernels' [b·h, s, d] torch."""
    t = torch.from_numpy(a)
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]).contiguous()


def _jax_fwd_and_grads(q, k, v, g, causal):
    from horovod_tpu.ops import flash_attention as jfa
    s = q.shape[1]

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=s,
                                  block_k=s, interpret=True,
                                  variant="online")
        return jnp.sum(out * g), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _to_bshd(t):
    return t.reshape(B, H, t.shape[1], t.shape[2]).transpose(1, 2).numpy()


@pytest.mark.parametrize("d", [288, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("variant", tfa.VARIANTS)
def test_plain_walk_at_the_kernel_tiles_matches_jax(hvd, d, causal,
                                                    variant):
    """The plain forward walk of ``variant`` and the dq and dk/dv walks at
    the run-time-d kernels' 32-row tiles against JAX's O and gradients."""
    q, k, v, g = _inputs(d + causal, d)
    want_out, want_grads = _jax_fwd_and_grads(q, k, v, g, causal)
    qf, kf, vf, gf = (_flat(a) for a in (q, k, v, g))
    blocks = tfa.kernel_blocks(qf, kf, variant)
    assert blocks == (tfa.DYN_BLOCK, tfa.DYN_BLOCK)
    out, lse = tref.FWD[variant](qf, kf, vf, causal, *blocks)
    np.testing.assert_allclose(_to_bshd(out), want_out, rtol=2e-5,
                               atol=2e-5)
    delta = tref.flash_delta(out, gf)
    (dq_walk, dkv_walk) = tfa.bwd_kernel_blocks(qf, kf)
    dq = tref.flash_bwd_dq(qf, kf, vf, gf, lse, delta, causal, *dq_walk)
    dk, dv = tref.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, causal,
                                *dkv_walk)
    for got, want in zip((dq, dk, dv), want_grads):
        np.testing.assert_allclose(_to_bshd(got), want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("d", [288, 512])
def test_public_autograd_path_matches_jax(hvd, d):
    """``flash_attention`` on CPU tensors (its plain walks at the fitted
    reference blocks) and its backward against ``jax.grad``."""
    q, k, v, g = _inputs(d, d)
    want_out, want_grads = _jax_fwd_and_grads(q, k, v, g, True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, variant="online",
                              device="cpu")
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=2e-5,
                               atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
