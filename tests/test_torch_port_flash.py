"""horovod_tpu_torch flash attention against the JAX package.

The port's plain versions of the three forward variants (online, lazy,
twopass — the CPU path of its flash entry points) are fed the same
numpy-seeded inputs as ``horovod_tpu.ops.flash_attention``'s Pallas
kernels, which run in interpret mode on the CPU, and must agree on O
and on the natural-log lse (the reference's ``lse[:, 0, :]``: the port
drops the TPU's 8-row replication). Tolerances are
tests/test_flash_variants.py's: fp32 2e-5, bf16 5e-2. The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py`` and tests/test_torch_port_cuda.py.

The public ``flash_attention`` is held to the reference's on what it
accepts and refuses (the reference's ``fit_block`` on the caller's
blocks), on forward and gradients at lengths no tile divides, and on its
signature; the head-dim padding of the card path (``pad_head_dim``) is
held to the unpadded plain walk.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import flash_attention_ref as tref

VARIANTS = ("online", "lazy", "twopass")
_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-2, 5e-2)}


def _inputs(seed, b=2, s=128, h=2, d=32, dtype="float32"):
    r = np.random.RandomState(seed)
    arrs = [(r.randn(b, s, h, d) * 0.3).astype(np.float32)
            for _ in range(3)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got, want, dtype):
    rtol, atol = _TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


class TestVariantsAgainstJax:
    @pytest.mark.parametrize("variant", VARIANTS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_seq128_out_and_lse(self, hvd, variant, dtype, causal):
        from horovod_tpu.ops import flash_attention as jfa
        (jq, jk, jv), (tq, tk, tv) = _inputs(0, dtype=dtype)
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, 64, 64, True,
                                      variant=variant)
        t_out, t_lse = tfa.flash_fwd(tq, tk, tv, causal, 64, 64,
                                     variant=variant)
        assert t_out.dtype == getattr(torch, dtype)
        assert t_lse.dtype == torch.float32 and t_lse.shape == (4, 128)
        _close(t_out, j_out, dtype)
        _close(t_lse, np.asarray(j_lse)[:, 0, :], dtype)

    @pytest.mark.parametrize("variant", ("lazy", "twopass"))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_seq256_128_row_blocks(self, hvd, variant, dtype, causal):
        """The walks at the wgmma kernel's 128-row tiles, each walk
        crossing two of them: the plain version it is held to on the card
        against the TPU kernel at the same blocks."""
        from horovod_tpu.ops import flash_attention as jfa
        (jq, jk, jv), (tq, tk, tv) = _inputs(10, s=256, dtype=dtype)
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True,
                                      variant=variant)
        t_out, t_lse = tfa.flash_fwd(tq, tk, tv, causal, 128, 128,
                                     variant=variant)
        assert t_out.dtype == getattr(torch, dtype)
        assert t_lse.shape == (4, 256)
        _close(t_out, j_out, dtype)
        _close(t_lse, np.asarray(j_lse)[:, 0, :], dtype)

    @pytest.mark.parametrize("variant", VARIANTS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ragged_tail(self, hvd, variant, dtype):
        """seq 100, causal: the reference at 64-row blocks end-pads it to
        128; the port runs it unpadded, one 100-row tile."""
        from horovod_tpu.ops.flash_attention import flash_attention
        (jq, jk, jv), (tq, tk, tv) = _inputs(4, s=100, dtype=dtype)
        want = flash_attention(jq, jk, jv, causal=True, block_q=64,
                               block_k=64, variant=variant)
        got = tfa.flash_attention(tq, tk, tv, causal=True, variant=variant,
                                  device="cpu")
        assert got.shape == tq.shape
        _close(got, want, dtype)

    @pytest.mark.parametrize("variant", ("lazy", "twopass"))
    def test_adversarial_rising_max(self, hvd, variant):
        """Keys ramped so each later k tile raises the row max: the lazy
        gate fires on every tile."""
        from horovod_tpu.ops import flash_attention as jfa
        (jq, jk, jv), (tq, tk, tv) = _inputs(9, b=1, s=128, h=1, d=32)
        ramp = np.linspace(0.5, 8.0, 128, dtype=np.float32)
        jk = (jk * ramp[None, :, None, None]).astype(jk.dtype)
        tk = tk * torch.from_numpy(ramp)[None, :, None, None]
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, False, 32, 32, True,
                                      variant=variant)
        t_out, t_lse = tfa.flash_fwd(tq, tk, tv, False, 32, 32,
                                     variant=variant)
        _close(t_out, j_out, "float32")
        _close(t_lse, np.asarray(j_lse)[:, 0, :], "float32")

    def test_short_sequence_is_one_partial_tile(self, hvd):
        from horovod_tpu.ops.flash_attention import flash_attention
        (jq, jk, jv), (tq, tk, tv) = _inputs(3, s=16)
        want = flash_attention(jq, jk, jv, causal=True)
        got = tfa.flash_attention(tq, tk, tv, causal=True, device="cpu")
        _close(got, want, "float32")

    @pytest.mark.parametrize("layout", ["bshd", "bhsd"])
    def test_layouts_agree(self, layout):
        _, (tq, tk, tv) = _inputs(5, s=64)
        want = tfa.flash_attention(tq, tk, tv, device="cpu")
        if layout == "bhsd":
            got = tfa.flash_attention(*(t.transpose(1, 2) for t in
                                        (tq, tk, tv)), layout="bhsd",
                                      device="cpu").transpose(1, 2)
        else:
            got = want
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_lse_identical_across_variants(self):
        _, (tq, tk, tv) = _inputs(6, s=128)
        lses = [tfa.flash_fwd(tq, tk, tv, True, 32, 32, variant=v)[1]
                for v in VARIANTS]
        for other in lses[1:]:
            torch.testing.assert_close(lses[0], other, rtol=1e-6,
                                       atol=1e-6)

    def test_non_causal_indivisible_raises(self, hvd):
        """Non-causal s 100, which no 64-row tile divides: the reference
        takes it as one 100-row block, and so does the port now (it used
        to refuse it); forward and gradients agree."""
        _check_against_jax(7, 100, 100, False)


def _jax_attention(arrs, causal, **kw):
    """(out, (dq, dk, dv)) of the JAX package's flash_attention in
    interpret mode, the gradients of sum(out·g)."""
    from horovod_tpu.ops.flash_attention import flash_attention
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrs)

    def loss(q, k, v):
        out = flash_attention(q, k, v, causal=causal, interpret=True, **kw)
        return jnp.sum(out * jg), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    return out, grads


def _port_attention(arrs, causal, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in arrs[:3])
    out = tfa.flash_attention(tq, tk, tv, causal=causal, device="cpu", **kw)
    (out * torch.from_numpy(arrs[3])).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad)


def _check_against_jax(seed, sq, sk, causal, b=1, h=2, d=64):
    """The port's flash_attention against the JAX package's in interpret
    mode at fp32 2e-5, forward and gradients, at the default blocks."""
    r = np.random.RandomState(seed)
    arrs = [r.randn(b, s, h, d).astype(np.float32) * 0.5
            for s in (sq, sk, sk, sq)]
    want_out, want_grads = _jax_attention(arrs, causal)
    got_out, got_grads = _port_attention(arrs, causal)
    assert got_out.shape == (b, sq, h, d)
    _close(got_out.detach(), want_out, "float32")
    for g, w in zip(got_grads, want_grads):
        _close(g, w, "float32")


class TestLengthsAsTheReference:
    """C1: the lengths the reference accepts, forward and gradients."""

    @pytest.mark.parametrize("sq,sk", [(100, 300), (640, 640)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_and_grads_match_jax(self, hvd, sq, sk, causal):
        """sq 100 × sk 300 (one block each, no 64-row tile divides 100)
        and s 640 (the reference's 512 halves to 128); causal and not."""
        _check_against_jax(20, sq, sk, causal)

    def test_refused_by_both_with_one_message(self, hvd):
        """Non-causal s 600: 512 halves to 128, which does not divide it."""
        from horovod_tpu.ops.flash_attention import flash_attention
        x = np.zeros((1, 600, 1, 16), np.float32)
        with pytest.raises(ValueError) as want:
            flash_attention(*(jnp.asarray(x),) * 3, causal=False,
                            interpret=True)
        with pytest.raises(ValueError) as got:
            tfa.flash_attention(*(torch.from_numpy(x),) * 3, causal=False,
                                device="cpu")
        assert str(got.value) == str(want.value)
        assert "600%128" in str(got.value)

    @pytest.mark.parametrize("sq,sk,causal,blocks", [
        (100, 100, False, (512, 512)), (100, 300, True, (512, 512)),
        (600, 600, False, (512, 512)), (600, 600, True, (512, 512)),
        (600, 640, True, (512, 512)), (640, 640, False, (512, 512)),
        (1000, 1000, True, (512, 512)), (1000, 1000, False, (512, 512)),
        (384, 1024, False, (512, 512)), (300, 300, False, (256, 256)),
        (100, 100, False, (64, 64)), (100, 100, True, (64, 64)),
        (192, 256, False, (64, 128)), (200, 200, False, (128, 128)),
        (1536, 1536, False, (1024, 1024)), (16, 48, True, (512, 512))])
    def test_accepts_and_refuses_as_the_reference(self, hvd, sq, sk, causal,
                                                  blocks):
        """The reference traced abstractly (``jax.eval_shape``: its check
        raises before any kernel) against the port's acceptance."""
        from horovod_tpu.ops.flash_attention import flash_attention
        bq, bk = blocks

        def ref(q, k, v):
            return flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk, interpret=True)
        spec = [jax.ShapeDtypeStruct((1, s, 1, 16), jnp.float32)
                for s in (sq, sk, sk)]
        try:
            jax.eval_shape(ref, *spec)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            tfa.accepted_blocks(sq, sk, causal, bq, bk)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want

    def test_fit_block_ref_is_the_reference(self, hvd):
        from horovod_tpu.ops.flash_attention import fit_block
        for block in (64, 128, 256, 512, 1024):
            for s in range(1, 1100, 7):
                assert tfa.fit_block_ref(block, s) == fit_block(block, s)

    def test_dkv_blocks_fall_back_as_the_reference(self):
        assert tfa.dkv_blocks(640, 640, (128, 128)) == (128, 128)
        assert tfa.dkv_blocks(640, 640, (128, 128), 256, 512) == (128, 128)
        assert tfa.dkv_blocks(1024, 1024, (512, 512), 256, 128) == (256, 128)
        assert tfa.dkv_blocks(100, 300, (100, 300), 64, 64) == (100, 300)

    def test_plain_online_at_the_kernel_tiles_matches_jax(self, hvd):
        """The plain online walk over 128-key tiles with a partial last
        tile (s 200 = 128 + 72), at both CTA shapes of the wgmma kernel,
        against the reference's one 200-row block."""
        from horovod_tpu.ops import flash_attention as jfa
        (jq, jk, jv), (tq, tk, tv) = _inputs(21, b=1, s=200, h=2, d=32)
        flat = [t.transpose(1, 2).reshape(2, 200, 32) for t in (tq, tk, tv)]
        for causal in (True, False):
            j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, 200, 200, True,
                                          variant="online")
            want = np.asarray(j_out).transpose(0, 2, 1, 3).reshape(2, 200, 32)
            for rows in (64, 128):
                out, lse = tref.flash_fwd_online(*flat, causal, rows,
                                                 tfa.SM90_BLOCK_K)
                _close(out, want, "float32")
                _close(lse, np.asarray(j_lse)[:, 0, :], "float32")


class TestHeadDimPadding:
    """C2: on the card, d is zero-padded to a compiled head dim with the
    true d's scale. Here the helper runs the plain walks at the padded d
    and must give the unpadded walks' result."""

    @pytest.mark.parametrize("d,padded", [(24, 32), (80, 128), (96, 128),
                                          (120, 128), (64, 64), (8, 16),
                                          (160, 256), (192, 256),
                                          (256, 256)])
    def test_kernel_head_dim(self, d, padded):
        assert tfa.kernel_head_dim(d) == padded

    def test_beyond_128_is_refused(self, hvd):
        """No head dim is refused on the card any more: up to 256 it is
        padded to a compiled one (the CUDA-core kernels above 128), above
        256 it runs as it is on the run-time-d kernels, whose plain walk
        at their 32-row tiles equals the reference's at d 260."""
        from horovod_tpu.ops import flash_attention as jfa
        assert tfa.kernel_head_dim(160) == 256
        assert tfa.kernel_head_dim(260) == 260 and tfa.on_dyn(260)
        (jq, jk, jv), (tq, tk, tv) = _inputs(260, b=1, s=40, h=2, d=260)
        flat = [t.transpose(1, 2).reshape(2, 40, 260) for t in (tq, tk, tv)]
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, True, 40, 40, True,
                                      variant="online")
        out, lse = tref.flash_fwd_online(*flat, True, tfa.DYN_BLOCK,
                                         tfa.DYN_BLOCK)
        _close(out, np.asarray(j_out).transpose(0, 2, 1, 3).reshape(
            2, 40, 260), "float32")
        _close(lse, np.asarray(j_lse)[:, 0, :], "float32")

    @pytest.mark.parametrize("d", [24, 80, 96, 120])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_and_backward_equal_the_unpadded_walk(self, d, dtype,
                                                          causal):
        g = torch.Generator().manual_seed(d)
        q, k, v, do = (torch.randn(3, 200, d, generator=g).to(
            getattr(torch, dtype)) for _ in range(4))
        scale = d ** -0.5
        blocks = (64, 128)
        want = tref.flash_fwd_online(q, k, v, causal, *blocks, scale)
        got = tfa.pad_head_dim(
            lambda *t: tref.flash_fwd_online(*t, causal, *blocks, scale),
            (q, k, v), 1)
        assert got[0].shape == (3, 200, d)
        for a, w in zip(got, want):
            _close(a, w.float().numpy(), dtype)
        lse, delta = want[1], tref.flash_delta(want[0], do)

        def bwd(q, k, v, do):
            return (tref.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                      *blocks, scale),
                    *tref.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        *blocks, scale))
        for a, w in zip(tfa.pad_head_dim(bwd, (q, k, v, do), 3),
                        bwd(q, k, v, do)):
            assert a.shape == w.shape
            _close(a, w.float().numpy(), dtype)


class TestReferenceSignatures:
    """C4: the reference's keywords, in its order."""

    def test_flash_attention_takes_every_reference_keyword(self, hvd):
        from horovod_tpu.ops import flash_attention as jfa
        want = list(inspect.signature(jfa.flash_attention).parameters)
        got = list(inspect.signature(tfa.flash_attention).parameters)
        assert got == want + ["device"]
        for name in ("causal", "block_q", "block_k", "interpret",
                     "block_q_dkv", "block_k_dkv", "layout", "variant"):
            assert (inspect.signature(tfa.flash_attention)
                    .parameters[name].default ==
                    inspect.signature(jfa.flash_attention)
                    .parameters[name].default), name

    def test_every_keyword_is_accepted_and_matches_jax(self, hvd):
        """All of them passed at once, bhsd layout: 256 at blocks 128
        (dk/dv at 64 × 128) on both sides."""
        from horovod_tpu.ops.flash_attention import flash_attention
        (jq, jk, jv), (tq, tk, tv) = _inputs(22, b=1, s=256, h=2, d=32)
        kw = dict(causal=True, block_q=128, block_k=128, interpret=True,
                  block_q_dkv=64, block_k_dkv=128, layout="bhsd",
                  variant="lazy")
        want = flash_attention(*(t.transpose(0, 2, 1, 3)
                                 for t in (jq, jk, jv)), **kw)
        got = tfa.flash_attention(*(t.transpose(1, 2) for t in
                                    (tq, tk, tv)), device="cpu", **kw)
        _close(got, want, "float32")

    def test_interpret_runs_the_plain_walk_at_the_callers_blocks(self):
        (_, (tq, tk, tv)) = _inputs(23, b=1, s=96, h=2, d=32)
        tfa.reset_launch_counts()
        got = tfa.flash_attention(tq, tk, tv, causal=False, block_q=32,
                                  block_k=32, interpret=True,
                                  variant="online", device="cpu")
        flat = [t.transpose(1, 2).reshape(2, 96, 32) for t in (tq, tk, tv)]
        want, _ = tref.flash_fwd_online(*flat, False, 32, 32)
        torch.testing.assert_close(
            got.transpose(1, 2).reshape(2, 96, 32), want, rtol=0, atol=0)
        assert not tfa.launch_counts

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_attention_scale_matches_jax(self, hvd, dtype):
        from horovod_tpu.ops.flash_attention import decode_attention
        r = np.random.RandomState(24)
        q = r.randn(2, 1, 2, 16).astype(np.float32)
        k, v = (r.randn(2, 30, 2, 16).astype(np.float32) for _ in range(2))
        lengths = np.array([5, 30], np.int32)
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        want = decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                jnp.asarray(v, jd), jnp.asarray(lengths),
                                scale=0.7)
        got = tfa.decode_attention(
            torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
            torch.from_numpy(v).to(td), torch.from_numpy(lengths), scale=0.7)
        _close(got, want, dtype)
        default = tfa.decode_attention(
            *(torch.from_numpy(a).to(td) for a in (q, k, v)),
            torch.from_numpy(lengths))
        assert not torch.equal(got, default)


class TestVariantSelection:
    def test_explicit_names(self):
        for v in VARIANTS:
            assert tfa.resolve_variant(v, nk=4) == v

    def test_auto_heuristic(self):
        assert tfa.resolve_variant("auto", nk=1) == "online"
        assert tfa.resolve_variant("auto", nk=2) == "lazy"
        assert tfa.resolve_variant("auto", nk=16) == "lazy"

    def test_unknown_raises(self):
        with pytest.raises(ValueError, match="unknown flash variant"):
            tfa.resolve_variant("eager", nk=2)

    def test_env_overrides_everything(self, monkeypatch):
        monkeypatch.setenv("HVD_FLASH_VARIANT", "twopass")
        assert tfa.resolve_variant("online", nk=4) == "twopass"
        assert tfa.resolve_variant("auto", nk=1) == "twopass"
        monkeypatch.setenv("HVD_FLASH_VARIANT", "nonsense")
        with pytest.raises(ValueError, match="unknown flash variant"):
            tfa.resolve_variant("online", nk=4)

    def test_env_empty_is_ignored(self, monkeypatch):
        monkeypatch.setenv("HVD_FLASH_VARIANT", "")
        assert tfa.resolve_variant("auto", nk=4) == "lazy"

    def test_matches_jax_resolution(self, hvd, monkeypatch):
        from horovod_tpu.ops.flash_attention import resolve_variant
        monkeypatch.delenv("HVD_FLASH_VARIANT", raising=False)
        for name in VARIANTS + ("auto",):
            for nk in (1, 2, 8):
                assert tfa.resolve_variant(name, nk=nk) == \
                    resolve_variant(name, nk=nk)

    def test_fit_block_is_one_tile_or_block(self):
        assert tfa.fit_block(16) == 16
        assert tfa.fit_block(64) == 64
        assert tfa.fit_block(1000) == tfa.BLOCK


class TestDecodeAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, hvd, dtype):
        from horovod_tpu.ops.flash_attention import decode_attention
        r = np.random.RandomState(11)
        b, s_max, h, d = 3, 40, 2, 16
        q = (r.randn(b, 1, h, d) * 0.3).astype(np.float32)
        k = (r.randn(b, s_max, h, d) * 0.3).astype(np.float32)
        v = (r.randn(b, s_max, h, d) * 0.3).astype(np.float32)
        lengths = np.array([1, 17, 40], np.int32)
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        want = decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                jnp.asarray(v, jd), jnp.asarray(lengths))
        got = tfa.decode_attention(
            torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
            torch.from_numpy(v).to(td), torch.from_numpy(lengths))
        assert got.dtype == td and got.shape == (b, 1, h, d)
        _close(got, want, dtype)

    def test_rejects_multi_token_query(self):
        x = torch.zeros(1, 2, 1, 8)
        with pytest.raises(ValueError, match="decode_attention"):
            tfa.decode_attention(x, x, x, torch.tensor([2]))


class TestWideHeadDims:
    """Head dims above 128 are taken on the API (the card pads d up to
    256 for its CUDA-core kernels; the CPU runs the plain walks at the
    true d): forward and gradients against the JAX package's
    ``flash_attention`` in interpret mode, fp32 2e-5 forward and rtol
    1e-4 / atol 1e-5 gradients, and the scale of the true d."""

    @pytest.mark.parametrize("d", [160, 256])
    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_path_matches_jax_interpret(self, hvd, d, causal):
        from horovod_tpu.ops import flash_attention as jfa
        (jq, jk, jv), (tq, tk, tv) = _inputs(40 + d, b=1, s=128, h=2, d=d)
        g = np.random.RandomState(d).randn(1, 128, 2, d).astype(np.float32)

        def jloss(q, k, v):
            out = jfa.flash_attention(q, k, v, causal=causal, block_q=64,
                                      block_k=64, interpret=True)
            return jnp.sum(out * g), out
        (_, j_out), j_grads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
        ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        out = tfa.flash_attention(*ts, causal=causal, block_q=64,
                                  block_k=64, device="cpu")
        out.backward(torch.from_numpy(g))
        assert out.shape == (1, 128, 2, d)
        _close(out.detach(), j_out, "float32")
        for t, w in zip(ts, j_grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)
