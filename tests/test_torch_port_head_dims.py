"""Head dims above 256: the port against the JAX package.

On the card every d > 256 runs on the run-time-d kernels: the bf16
forward up to 1024 on wgmma and TMA (``csrc/flash_fwd_sm90_dyn.cu``),
which walks 64-key tiles and 64 or 128 query rows per CTA, and the fp32
forward and every backward on ``csrc/flash_dyn.cu``, which walks 32-row q
and k tiles (``flash_attention.DYN_BLOCK``). Here their plain versions at
those tiles, and the port's differentiable ``flash_attention`` on the
CPU, are fed the same numpy-seeded inputs as the JAX package's
``flash_attention`` (Pallas in interpret mode; it takes any d): at d 288
and 512 and a short sequence with a partial last tile of the 32-row walk
(s 40 = 32 + 8), O, lse and the gradients of a seeded loss; at d 288 and
384 the forward walks at the wgmma kernel's tiles over s 200 (a partial
last tile at 64 and at 128 rows), every walk, causal and not, in fp32
and bf16, and under the two rising-max adversaries; and the fp32 forward
of d 64-256 at its 64 x 128 tiles. Tolerances are the
JAX package's own: fp32 forward 2e-5, gradients rtol 1e-4 / atol 1e-5
(tests/test_flash_attention.py); bf16 O two bf16 ulps plus 1 % of its
largest value, lse 1e-3. The kernels themselves are held to the same
plain walks on the card (tests/test_torch_port_cuda.py, chip_smoke.py
phase 2).
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
    # the walk of the forward kernel the dtype reaches: fp32 (these
    # inputs) on flash_dyn.cu's 32-row tiles, bf16 on the wgmma kernel's
    assert blocks == (tfa.DYN_BLOCK, tfa.DYN_BLOCK)
    assert tfa.kernel_blocks(qf.bfloat16(), kf.bfloat16(), variant, 64) == (
        64, tfa.SM90_DYN_BLOCK_K)
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


S_WIDE = 200   # 3 x 64 + 8 and 128 + 72: a partial last tile at either CTA


def _hold(got, want, what, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        rtol, atol = 2e-5, 2e-5
    elif what == "lse":
        rtol, atol = 0.0, 1e-3
    else:
        rtol, atol = 1.6e-2, 1e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _jax_fwd_at(d, dtype, causal, variant, seed, ramp=None):
    """Numpy-seeded q, k, v [1, S_WIDE, 2, d] (keys ramped when asked)
    through the JAX package's ``_flash_fwd`` (interpret mode, one block
    over the sequence), and the port's flat torch operands."""
    import jax.numpy as jnp
    from horovod_tpu.ops import flash_attention as jfa
    r = np.random.RandomState(seed)
    arrs = [r.randn(B, S_WIDE, H, d).astype(np.float32) for _ in range(3)]
    if ramp:
        lin = np.linspace(4.0, 0.5, S_WIDE, dtype=np.float32)
        arrs[1] = arrs[1] * (lin if ramp == "down" else lin[::-1])[
            None, :, None, None]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_out, j_lse = jfa._flash_fwd(*(jnp.asarray(a, jdt) for a in arrs),
                                  causal, S_WIDE, S_WIDE, True,
                                  variant=variant)
    want_o = np.asarray(j_out.astype(jnp.float32)).transpose(
        0, 2, 1, 3).reshape(B * H, S_WIDE, d)
    flat = [_flat(a).to(tdt) for a in arrs]
    return flat, want_o, np.asarray(j_lse)[:, 0, :]


@pytest.mark.parametrize("d", [288, 384])
@pytest.mark.parametrize("variant", tfa.VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_walk_at_the_wgmma_tiles_matches_jax(hvd, d, variant, dtype,
                                                   causal):
    """The plain forward walks at the run-time-d wgmma kernel's tiles (64
    or 128 query rows, 64 keys: what the kernel is held to on the card)
    against the reference's O and lse."""
    (qf, kf, vf), want_o, want_lse = _jax_fwd_at(
        d, dtype, causal, variant, d + 7 * causal + tfa.VARIANTS.index(
            variant))
    for rows in (64, 128):
        blocks = tfa.kernel_blocks(qf.bfloat16(), kf.bfloat16(), variant,
                                   rows)
        assert blocks == (rows, tfa.SM90_DYN_BLOCK_K)
        out, lse = tref.FWD[variant](qf, kf, vf, causal, *blocks)
        _hold(out, want_o, f"O {blocks}", dtype)
        _hold(lse, want_lse, f"lse {blocks}", dtype)


@pytest.mark.parametrize("d", [288, 384])
@pytest.mark.parametrize("variant", tfa.VARIANTS)
@pytest.mark.parametrize("ramp,causal", [("down", True), ("up", False)])
def test_wgmma_tiles_under_the_rising_max_adversaries(hvd, d, variant, ramp,
                                                      causal):
    """Keys ramped so that every 64-key tile raises the row max in one
    walk order (down, causal: lazy's diagonal-first walk; up, non-causal:
    the ascending ones): the plain walks at the wgmma kernel's tiles still
    equal the reference at 2e-5."""
    (qf, kf, vf), want_o, want_lse = _jax_fwd_at(
        d, "float32", causal, variant, 3 * d + 1, ramp)
    for rows in (64, 128):
        out, lse = tref.FWD[variant](qf, kf, vf, causal, rows,
                                     tfa.SM90_DYN_BLOCK_K)
        _hold(out, want_o, f"O {rows} rows {ramp}", "float32")
        _hold(lse, want_lse, f"lse {rows} rows {ramp}", "float32")


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("variant", tfa.VARIANTS)
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_plain_walk_at_the_cc_tiles_matches_jax(hvd, d, variant,
                                                     causal):
    """The fp32 register-blocked forward (``csrc/flash_fwd.cu``) walks 64
    query rows x 128 keys: its plain walk at those tiles (s 200 ends in a
    partial q tile and a partial k tile) against the reference at 2e-5."""
    (qf, kf, vf), want_o, want_lse = _jax_fwd_at(
        d, "float32", causal, variant, 5 * d + causal)
    blocks = tfa.kernel_blocks(qf, kf, variant)
    assert blocks == (tfa.BLOCK, tfa.CC_BLOCK_K)
    out, lse = tref.FWD[variant](qf, kf, vf, causal, *blocks)
    _hold(out, want_o, f"O {blocks}", "float32")
    _hold(lse, want_lse, f"lse {blocks}", "float32")
