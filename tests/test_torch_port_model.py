"""horovod_tpu_torch's transformer LM and serving forwards against flax.

The same flax checkpoint (``horovod_tpu.models.transformer.init_params``,
brought over by ``params_from_flax``) and the same numpy-seeded tokens
go through the JAX package and the port; logits, prefill K/V and the
decode step's cache update must agree within fp32 1e-4 on the tiny
config. Both attention paths are covered: "full", and "flash" (the
port's plain tile walk against the Pallas kernel in interpret mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving import decode as tdecode

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(impl="full", tie=False, logits_fp32=True, seed=0):
    """(jax cfg, flax params, port cfg, port model) on the tiny config."""
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32,
                                      attention_impl=impl,
                                      tie_embeddings=tie,
                                      logits_fp32=logits_fp32)
    _, params = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      attention_impl=impl,
                                      tie_embeddings=tie,
                                      logits_fp32=logits_fp32)
    model = params_from_flax(jax.device_get(params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _tokens(seed, b=2, s=64, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


class TestConvert:
    @pytest.mark.parametrize("tie", [False, True])
    def test_round_trip_is_exact(self, tie):
        _, params, _, model = _pair(tie=tie)
        tree = jax.device_get(params)
        got = dict(model.named_parameters())
        assert ("lm_head.weight" in got) == (not tie)
        np.testing.assert_array_equal(got["embed.weight"].numpy(),
                                      tree["embed"]["embedding"])
        np.testing.assert_array_equal(got["ln_f.scale"].numpy(),
                                      tree["ln_f"]["scale"])
        for i in range(2):
            layer = tree[f"layer_{i}"]
            np.testing.assert_array_equal(
                got[f"layers.{i}.attn.qkv.weight"].numpy(),
                layer["attn"]["qkv"]["kernel"].T)
            np.testing.assert_array_equal(
                got[f"layers.{i}.mlp.down.weight"].numpy(),
                layer["mlp"]["down"]["kernel"].T)
            np.testing.assert_array_equal(
                got[f"layers.{i}.ln_mlp.scale"].numpy(),
                layer["ln_mlp"]["scale"])
        if not tie:
            np.testing.assert_array_equal(got["lm_head.weight"].numpy(),
                                          tree["lm_head"]["kernel"].T)

    def test_shape_mismatch_raises(self):
        _, params, tcfg, _ = _pair()
        wrong = dataclasses.replace(tcfg, d_ff=128)
        with pytest.raises(ValueError, match="does not fit"):
            params_from_flax(jax.device_get(params), wrong, device="cpu")


class TestLogitsMatchFlax:
    @pytest.mark.parametrize("impl", ["full", "flash"])
    @pytest.mark.parametrize("tie", [False, True])
    @pytest.mark.parametrize("logits_fp32", [True, False])
    def test_logits(self, impl, tie, logits_fp32):
        jcfg, params, _, model = _pair(impl, tie, logits_fp32)
        tokens = _tokens(1)
        want = jtr.TransformerLM(jcfg).apply({"params": params},
                                             jnp.asarray(tokens))
        got = model(torch.from_numpy(tokens).long())
        assert got.shape == (2, 64, 256) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class TestLayers:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rmsnorm_matches_flax(self, dtype):
        import flax.linen as nn
        r = np.random.RandomState(3)
        x = (r.randn(2, 5, 64) * 2.0).astype(np.float32)
        scale = (1.0 + 0.1 * r.randn(64)).astype(np.float32)
        want = nn.RMSNorm(dtype=getattr(jnp, dtype)).apply(
            {"params": {"scale": scale}}, jnp.asarray(x, getattr(jnp, dtype)))
        norm = ttr.RMSNorm(64, getattr(torch, dtype))
        with torch.no_grad():
            norm.scale.copy_(torch.from_numpy(scale))
            got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rope_matches_jax(self, dtype):
        r = np.random.RandomState(4)
        x = r.randn(2, 33, 4, 16).astype(np.float32)
        pos = np.arange(33)[None]
        want = jtr._rope(jnp.asarray(x, getattr(jnp, dtype)),
                         jnp.asarray(pos))
        got = ttr._rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos))
        tol = TOL if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)

    def test_moe_config_raises(self):
        cfg = ttr.TransformerConfig.tiny(num_experts=4)
        with pytest.raises(NotImplementedError, match="Mixture-of-Experts"):
            ttr.TransformerLM(cfg, device="cpu")

    @pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses"])
    def test_sequence_parallel_impls_name_their_slice(self, impl):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                         attention_impl=impl)
        model = ttr.init_params(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="sequence-parallel"):
            model(torch.zeros((1, 8), dtype=torch.long))

    def test_unknown_impl_raises(self):
        cfg = ttr.TransformerConfig.tiny(attention_impl="sparse")
        model = ttr.init_params(cfg, device="cpu")
        with pytest.raises(ValueError, match="Unknown attention_impl"):
            model(torch.zeros((1, 8), dtype=torch.long))

    def test_init_params_is_seeded(self):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
        a = ttr.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        b = ttr.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        c = ttr.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
        for (name, pa), pb, pc in zip(a.named_parameters(),
                                      b.parameters(), c.parameters()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=0)
            if not name.endswith(".scale"):
                assert not torch.equal(pa, pc), name
        assert a.layers[0].attn.qkv.weight.std().item() == pytest.approx(
            64 ** -0.5, rel=0.1)


class TestServingForwards:
    @pytest.mark.parametrize("impl", ["full", "flash"])
    def test_prefill_forward_matches_jax(self, impl):
        from horovod_tpu.serving import decode as jdecode
        jcfg, params, tcfg, model = _pair(impl)
        tokens = _tokens(5, b=1, s=48)
        j_logits, j_k, j_v = jdecode.prefill_forward(jcfg, params,
                                                     jnp.asarray(tokens))
        t_logits, t_k, t_v = tdecode.prefill_forward(
            tcfg, model, torch.from_numpy(tokens).long())
        assert t_k.shape == (2, 1, 48, 4, 16)
        for got, want in ((t_logits, j_logits), (t_k, j_k), (t_v, j_v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_prefill_equals_forward(self):
        _, _, tcfg, model = _pair("flash")
        tokens = torch.from_numpy(_tokens(6)).long()
        torch.testing.assert_close(
            tdecode.prefill_forward(tcfg, model, tokens)[0], model(tokens),
            rtol=0, atol=0)

    def test_decode_step_matches_jax(self):
        from horovod_tpu.serving import decode as jdecode
        jcfg, params, tcfg, model = _pair()
        r = np.random.RandomState(7)
        shape = (2, 3, 24, 4, 16)  # layers, slots, max_len, heads, dim
        kv_k = (r.randn(*shape) * 0.3).astype(np.float32)
        kv_v = (r.randn(*shape) * 0.3).astype(np.float32)
        tokens = np.array([7, 100, 255], np.int32)
        positions = np.array([0, 11, 23], np.int32)
        j_logits, j_k, j_v = jdecode.decode_step(
            jcfg, params, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(kv_k), jnp.asarray(kv_v))
        t_k, t_v = torch.from_numpy(kv_k.copy()), torch.from_numpy(
            kv_v.copy())
        t_logits, t_k2, t_v2 = tdecode.decode_step(
            tcfg, model, torch.from_numpy(tokens).long(),
            torch.from_numpy(positions).long(), t_k, t_v)
        assert t_k2 is t_k  # updated in place
        for got, want in ((t_logits, j_logits), (t_k, j_k), (t_v, j_v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
