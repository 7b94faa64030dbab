"""horovod_tpu_torch's training path against the JAX package.

The same flax checkpoint (``params_from_flax(..., train=True)``, fp32
masters) and the same numpy-seeded tokens go through both packages: the
LM loss and every parameter's gradient must agree with
``jax.value_and_grad(lm_loss_fn(model))`` on the tiny fp32 flash config
(the port's plain tile walks against the Pallas kernels in interpret
mode), the port's ``AdamW(mu_dtype=bfloat16)`` must track
``optax.adamw(3e-4, mu_dtype=bfloat16)``, and three ``make_multi_step``
updates must land where three JAX updates land.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch import optim as toptim
from horovod_tpu_torch import trainer as ttrainer
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import _dense_names, params_from_flax


def _pair(tie=True, logits_fp32=False, seed=0, seq=64):
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32,
                                      attention_impl="flash",
                                      tie_embeddings=tie,
                                      logits_fp32=logits_fp32)
    _, params = jtr.init_params(jcfg, jax.random.PRNGKey(seed), seq_len=seq)
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      attention_impl="flash",
                                      tie_embeddings=tie,
                                      logits_fp32=logits_fp32)
    model = params_from_flax(jax.device_get(params), tcfg, device="cpu",
                             train=True)
    return jcfg, params, model


def _tokens(seed, shape, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _flax_path(name, num_layers=2):
    """The flax param path of a port parameter name, and whether the
    port stores it transposed."""
    for i in range(num_layers):
        dense = _dense_names(i)
        if name in dense:
            return dense[name], True
        for ln in ("ln_attn", "ln_mlp"):
            if name == f"layers.{i}.{ln}.scale":
                return (f"layer_{i}", ln, "scale"), False
    return {"embed.weight": (("embed", "embedding"), False),
            "ln_f.scale": (("ln_f", "scale"), False),
            "lm_head.weight": (("lm_head", "kernel"), True)}[name]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


class TestLossAndGrads:
    @pytest.mark.parametrize("tie", [True, False])
    @pytest.mark.parametrize("logits_fp32", [True, False])
    def test_match_jax_value_and_grad(self, hvd, tie, logits_fp32):
        jcfg, params, model = _pair(tie, logits_fp32)
        tokens = _tokens(1, (2, 64))
        jloss, jgrads = jax.value_and_grad(
            jtr.lm_loss_fn(jtr.TransformerLM(jcfg)))(params,
                                                     jnp.asarray(tokens))
        loss = ttr.lm_loss_fn(model)(model, torch.from_numpy(tokens).long())
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                                   atol=1e-5)
        names = dict(model.named_parameters())
        assert ("lm_head.weight" in names) == (not tie)
        for name, p in names.items():
            path, transposed = _flax_path(name)
            want = _leaf(jgrads, path)
            got = p.grad.numpy()
            np.testing.assert_allclose(got.T if transposed else got, want,
                                       rtol=1e-4, atol=1e-5, err_msg=name)

    def test_training_model_keeps_fp32_masters(self):
        cfg = ttr.TransformerConfig.tiny()   # bf16 compute
        model = ttr.init_params(cfg, device="cpu", train=True)
        serving = ttr.init_params(cfg, device="cpu")
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for p in model.parameters())
        assert serving.embed.weight.dtype == torch.bfloat16
        assert not any(p.requires_grad for p in serving.parameters())
        tokens = torch.from_numpy(_tokens(2, (1, 16))).long()
        with torch.no_grad():
            torch.testing.assert_close(model(tokens), serving(tokens),
                                       rtol=0, atol=0)

    def test_vocab_chunk_is_not_ported(self):
        model = ttr.init_params(ttr.TransformerConfig.tiny(), device="cpu",
                                train=True)
        with pytest.raises(NotImplementedError, match="vocab_chunk"):
            ttr.lm_loss_fn(model, vocab_chunk=64)

    def test_return_hidden(self):
        _, _, model = _pair()
        tokens = torch.from_numpy(_tokens(3, (1, 16))).long()
        hidden = model(tokens, return_hidden=True)
        assert hidden.shape == (1, 16, 64)
        logits = ttr.head_logits(model.cfg, hidden, model.head_weight())
        torch.testing.assert_close(logits, model(tokens), rtol=0, atol=0)


class TestCrossEntropy:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, hvd, dtype):
        from horovod_tpu import trainer as jtrainer
        r = np.random.RandomState(4)
        logits = (r.randn(2, 5, 33) * 3).astype(np.float32)
        labels = r.randint(0, 33, (2, 5)).astype(np.int32)
        weights = (r.rand(2, 5) > 0.3).astype(np.float32)
        for w in (None, weights):
            want = jtrainer.softmax_cross_entropy(
                jnp.asarray(logits, getattr(jnp, dtype)), jnp.asarray(labels),
                None if w is None else jnp.asarray(w))
            got = ttrainer.softmax_cross_entropy(
                torch.from_numpy(logits).to(getattr(torch, dtype)),
                torch.from_numpy(labels),
                None if w is None else torch.from_numpy(w))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


class TestAdamW:
    def test_matches_optax_adamw_bf16_mu(self):
        r = np.random.RandomState(0)
        shapes = [(64, 32), (128,), (7, 5, 3)]
        params = [r.randn(*s).astype(np.float32) for s in shapes]
        grads = [[(r.randn(*s) * 10 ** r.uniform(-3, 1)).astype(np.float32)
                  for s in shapes] for _ in range(3)]
        tx = optax.adamw(3e-4, mu_dtype=jnp.bfloat16)
        jp = [jnp.asarray(p) for p in params]
        state = tx.init(jp)
        tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
        opt = toptim.AdamW(tp, 3e-4, mu_dtype=torch.bfloat16)
        for g in grads:
            updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, updates)
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x)
            opt.step()
        adam = state[0]
        for i, p in enumerate(tp):
            st = opt.state[p]
            assert st["mu"].dtype == torch.bfloat16
            assert st["nu"].dtype == torch.float32
            for got, want in ((p.detach(), jp[i]), (st["mu"], adam.mu[i]),
                              (st["nu"], adam.nu[i])):
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           rtol=1e-6, atol=0)

    def test_skips_parameters_without_grad(self):
        a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(
            torch.ones(3))
        opt = toptim.AdamW([a, b], 1e-2)
        a.grad = torch.ones(3)
        opt.step()
        assert torch.equal(b.detach(), torch.ones(3)) and b not in opt.state
        assert (a.detach() < 1).all()


class TestTrainSteps:
    def test_three_multi_steps_match_jax(self, hvd):
        jcfg, params, model = _pair(tie=False, logits_fp32=True)
        # one repeated batch, as the JAX package's test_flash_model_trains
        tokens = np.stack([_tokens(0, (4, 65))] * 3)
        jmodel = jtr.TransformerLM(jcfg)
        loss_fn = jtr.lm_loss_fn(jmodel)
        tx = optax.adamw(3e-3)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state, tokens):
            loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        jlosses = []
        for batch in tokens:
            params, opt_state, loss = step(params, opt_state,
                                           jnp.asarray(batch))
            jlosses.append(float(loss))

        opt = toptim.AdamW(model.parameters(), 3e-3)
        tloss_fn = ttr.lm_loss_fn(model)
        one = ttrainer.make_train_step(model, opt, tloss_fn)
        multi = ttrainer.make_multi_step(model, opt, tloss_fn)
        tokens_t = torch.from_numpy(tokens).long()
        first = one(tokens_t[0]).item()
        last = multi(tokens_t[1:]).item()
        np.testing.assert_allclose([first, last], [jlosses[0], jlosses[-1]],
                                   rtol=1e-5)
        assert last < first
        for name, p in model.named_parameters():
            path, transposed = _flax_path(name)
            got = p.detach().numpy()
            np.testing.assert_allclose(got.T if transposed else got,
                                       _leaf(params, path), rtol=1e-4,
                                       atol=1e-5, err_msg=name)

    def test_flagship_loss_falls_on_cpu(self):
        cfg = ttr.TransformerConfig.tiny(attention_impl="flash",
                                         tie_embeddings=True,
                                         logits_fp32=False)
        model = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", train=True)
        opt = toptim.AdamW(model.parameters(), 3e-3, mu_dtype=torch.bfloat16)
        multi = ttrainer.make_multi_step(model, opt, ttr.lm_loss_fn(model))
        batch = torch.from_numpy(_tokens(5, (1, 2, 64))).long()
        first = multi(batch).item()
        last = multi(batch.repeat(4, 1, 1)).item()
        assert np.isfinite([first, last]).all() and last < first


@pytest.mark.parametrize("size", ["tiny", "gpt2_small_tpu", "llama_1b"])
@pytest.mark.parametrize("seq", [64, 1024])
def test_matmul_flops_per_token_matches_jax(size, seq):
    jcfg = getattr(jtr.TransformerConfig, size)()
    tcfg = getattr(ttr.TransformerConfig, size)()
    assert ttr.matmul_flops_per_token(tcfg, seq) == \
        jtr.matmul_flops_per_token(jcfg, seq)
