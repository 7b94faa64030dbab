"""The bf16 head-dim-256 backward's tile walks against the JAX package.

At d 256 the wgmma/TMA backward (``csrc/flash_bwd_sm90.cu``) walks dq
over 64 query rows x 64 keys and dk/dv over 64 keys x 64 queries
(``fa.bwd_kernel_blocks``); the fp32 backward stays on the CUDA-core
kernels' 64 x 32 walks. The plain versions at exactly the wgmma walks —
what ``chip_smoke.py`` holds the kernels against on the card — are fed the
same numpy-seeded inputs as the reference's Pallas kernels
(``horovod_tpu.ops.flash_attention._flash_bwd`` in interpret mode, one
block over the whole sequence) at b1 h2 s200, where 200 ends in a partial
tile of every walk, with the JAX forward's out and lse. Head dims 160,
192 and 224 run as they do on the card: zero-padded to 256 with the true
d's softmax scale. Tolerances: fp32 2e-5; bf16 two bf16 ulps of each
value plus 1 % of that gradient's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import flash_attention_ref as tref

B, S, H = 1, 200, 2


def _inputs(seed, dtype, d):
    r = np.random.RandomState(seed)
    arrs = [r.randn(B, S, H, d).astype(np.float32) for _ in range(4)]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _flat(t):
    return t.transpose(1, 2).reshape(B * H, S, t.shape[-1]).contiguous()


def _hold(got, want, what, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        rtol, atol = 2e-5, 2e-5
    else:
        rtol, atol = 1.6e-2, 1e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("d", [160, 192, 224, 256])
def test_the_d256_backward_walks_64_by_64(d):
    bf = torch.zeros(3, 1024, d, dtype=torch.bfloat16)
    assert tfa.on_sm90_bwd(bf)
    assert tfa.bwd_launch_names(bf) == ("flash_bwd_sm90_dq",
                                        "flash_bwd_sm90_dkv")
    # the dq CTA holds 64 query rows at d 256 whatever the caller forces
    for rows in (None, 64, 128):
        assert tfa.bwd_kernel_blocks(bf, bf, rows) == ((64, 64), (64, 64))
    assert tfa.sm90_dq_rows(bf, 128) == 64
    f32 = bf.float()
    assert not tfa.on_sm90_bwd(f32)
    assert tfa.bwd_launch_names(f32) == ("flash_bwd_cc_dq",
                                         "flash_bwd_cc_dkv")
    assert tfa.bwd_kernel_blocks(f32, f32) == ((64, 32), (64, 32))
    beyond = torch.zeros(3, 64, 288, dtype=torch.bfloat16)
    assert not tfa.on_sm90_bwd(beyond)
    assert tfa.bwd_launch_names(beyond)[0] == "flash_bwd_dyn_dq"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,causal", [(256, True), (256, False),
                                      (224, True), (192, False),
                                      (160, True)])
def test_plain_walks_at_the_kernel_tiles_match_jax(hvd, dtype, d, causal):
    from horovod_tpu.ops import flash_attention as jfa
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(d + causal, dtype, d)
    j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, S, S, True)
    want = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, S, S, True)
    qf, kf, vf, gf = (_flat(t) for t in (tq, tk, tv, tg))
    out = _flat(torch.from_numpy(np.array(j_out, np.float32)).to(qf.dtype))
    lse = torch.from_numpy(np.asarray(j_lse)[:, 0, :].copy())
    delta = tref.flash_delta(out, gf)
    dq_walk, dkv_walk = tfa.bwd_kernel_blocks(qf.bfloat16(), kf.bfloat16())
    assert dq_walk == dkv_walk == (64, tfa.SM90_BLOCK_K_WIDE)
    scale = d ** -0.5

    def walks(q, k, v, g):
        return (tref.flash_bwd_dq(q, k, v, g, lse, delta, causal, *dq_walk,
                                  scale),
                *tref.flash_bwd_dkv(q, k, v, g, lse, delta, causal,
                                    *dkv_walk, scale))
    got = tfa.pad_head_dim(walks, (qf, kf, vf, gf), 3)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == qf.dtype and t.shape == qf.shape
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(
            t.shape)
        _hold(t, w, f"{name} d={d} causal={causal}", dtype)
