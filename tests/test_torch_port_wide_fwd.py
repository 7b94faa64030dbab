"""The bf16 head-dim-256 forward's tile walk against the JAX package.

At d 256 the wgmma/TMA forward (``csrc/flash_fwd_sm90.cu``) walks 64 keys
per k tile and 64 or 128 query rows per CTA (``fa.kernel_blocks``). Its
plain versions at exactly those tiles — what ``chip_smoke.py`` holds the
kernel against on the card — are fed the same numpy-seeded inputs as the
reference's Pallas kernels (``horovod_tpu.ops.flash_attention._flash_fwd``
in interpret mode, one block over the whole sequence) at b1 h2 s200 d256,
where 200 ends in a partial q tile and a partial k tile. Every walk,
causal and not: fp32 within 2e-5; bf16 O within two bf16 ulps plus 1 % of
its largest value, lse within 1e-3. Head dims 160 and 192, zero-padded to
256 on the card, walk the same tiles.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import flash_attention_ref as tref

VARIANTS = ("online", "lazy", "twopass")
B, S, H, D = 1, 200, 2, 256


def _inputs(seed, dtype, d=D):
    r = np.random.RandomState(seed)
    arrs = [r.randn(B, S, H, d).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _flat(t):
    return t.transpose(1, 2).reshape(B * H, S, t.shape[-1]).contiguous()


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


def test_the_d256_forward_walks_64_keys_per_tile():
    q = torch.zeros(B * H, S, D, dtype=torch.bfloat16)
    for rows in (64, 128):
        for variant in VARIANTS:
            assert tfa.kernel_blocks(q, q, variant, rows) == (rows, 64)
    for d in (160, 192):
        assert tfa.sm90_block_k(d) == tfa.SM90_BLOCK_K_WIDE == 64
    assert tfa.sm90_block_k(128) == tfa.SM90_BLOCK_K == 128
    assert tfa.on_sm90_fwd(q) and tfa.on_sm90_bwd(q)
    assert not tfa.on_sm90_fwd(q.float()) and not tfa.on_sm90_bwd(q.float())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_walk_at_the_kernel_tiles_matches_jax(hvd, variant, dtype,
                                                    causal):
    from horovod_tpu.ops import flash_attention as jfa
    (jq, jk, jv), (tq, tk, tv) = _inputs(256 + VARIANTS.index(variant),
                                         dtype)
    j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, S, S, True,
                                  variant=variant)
    want_o = np.asarray(j_out.astype(jnp.float32)).transpose(
        0, 2, 1, 3).reshape(B * H, S, D)
    want_lse = np.asarray(j_lse)[:, 0, :]
    qf, kf, vf = (_flat(t) for t in (tq, tk, tv))
    for rows in (64, 128):
        blocks = (rows, tfa.SM90_BLOCK_K_WIDE)
        out, lse = tref.FWD[variant](qf, kf, vf, causal, *blocks)
        _hold(out, want_o, f"O {blocks}", dtype)
        _hold(lse, want_lse, f"lse {blocks}", dtype)


@pytest.mark.parametrize("d", [160, 192])
def test_padded_head_dims_walk_the_same_tiles(hvd, d):
    """d 160 and 192 reach the d-256 kernel zero-padded with the true d's
    scale: the plain walk of the padded operands at the kernel's tiles
    equals the reference's at the true d."""
    from horovod_tpu.ops import flash_attention as jfa
    (jq, jk, jv), (tq, tk, tv) = _inputs(d, "float32", d)
    j_out, j_lse = jfa._flash_fwd(jq, jk, jv, True, S, S, True,
                                  variant="lazy")
    qf, kf, vf = (_flat(t) for t in (tq, tk, tv))
    blocks = tfa.kernel_blocks(qf.bfloat16(), kf.bfloat16(), "lazy", 64)
    assert blocks == (64, 64)
    out, lse = tfa.pad_head_dim(
        lambda q, k, v: tref.flash_fwd_lazy(q, k, v, True, *blocks,
                                            d ** -0.5), (qf, kf, vf), 1)
    _hold(out, np.asarray(j_out).transpose(0, 2, 1, 3).reshape(
        B * H, S, d), "O", "float32")
    _hold(lse, np.asarray(j_lse)[:, 0, :], "lse", "float32")
