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
"""

import numpy as np
import pytest
import torch

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
        """seq 100 with 64-row tiles: causal end-padding to 128."""
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

    def test_non_causal_indivisible_raises(self):
        _, (tq, tk, tv) = _inputs(7, s=100)
        with pytest.raises(ValueError, match="divisible"):
            tfa.flash_attention(tq, tk, tv, causal=False, device="cpu")


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
