"""horovod_tpu_torch's chunked-vocab cross entropy and remat against the
JAX package.

The cases of ``tests/test_chunked_ce.py`` (chunk sizes that do and do not
divide the vocab, targets on chunk edges, a non-positive chunk), each fed
the same numpy-seeded inputs and the same flax checkpoint in both
packages: the loss to fp32 1e-5 and every gradient to rtol 2e-4 / atol
1e-6 (the JAX file's tolerances). Remat: a block recomputed in the
backward (``cfg.remat``, each ``remat_policy``) gives the gradients of the
plain backward exactly, as recomputing the same arithmetic must.
"""

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax


def _tokens(shape, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


@pytest.fixture
def pair(hvd):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32)
    tokens = _tokens((4, 33))
    params = jtr.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:, :-1]))["params"]
    model = params_from_flax(jax.device_get(params),
                             ttr.TransformerConfig.tiny(dtype=torch.float32),
                             device="cpu", train=True)
    return jtr, jcfg, params, model, tokens


def _flax_grads(model, grads):
    """The port's gradients in the flax tree's layout, by flax path."""
    from horovod_tpu_torch.models.convert import _dense_names
    out = {}
    dense = {}
    for i in range(model.cfg.num_layers):
        dense.update(_dense_names(i))
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        if name in dense:
            out["/".join(dense[name])] = g.T
        elif name == "lm_head.weight":
            out["lm_head/kernel"] = g.T
        elif name == "embed.weight":
            out["embed/embedding"] = g
        else:
            parts = name.split(".")
            if parts[0] == "layers":
                out[f"layer_{parts[1]}/{parts[2]}/scale"] = g
            else:
                out[f"{parts[0]}/scale"] = g
    return out


def _jax_flat(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


class TestChunkedCE:
    @pytest.mark.parametrize("chunk", [7, 64, 100, 10_000])
    def test_matches_jax_chunked_loss(self, pair, chunk):
        import jax.numpy as jnp
        jtr, jcfg, params, model, tokens = pair
        want = jtr.lm_loss_fn(jtr.TransformerLM(jcfg), vocab_chunk=chunk)(
            params, jnp.asarray(tokens))
        toks = torch.from_numpy(tokens).long()
        got = ttr.lm_loss_fn(model, vocab_chunk=chunk)(model, toks)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        direct = ttr.lm_loss_fn(model)(model, toks)
        np.testing.assert_allclose(got.item(), direct.item(), rtol=1e-5)

    def test_gradients_match_jax(self, pair):
        import jax
        import jax.numpy as jnp
        jtr, jcfg, params, model, tokens = pair
        want = _jax_flat(jax.grad(jtr.lm_loss_fn(
            jtr.TransformerLM(jcfg), vocab_chunk=50))(
                params, jnp.asarray(tokens)))
        loss = ttr.lm_loss_fn(model, vocab_chunk=50)(
            model, torch.from_numpy(tokens).long())
        loss.backward()
        got = _flax_grads(model, {n: p.grad for n, p in
                                  model.named_parameters()})
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=1e-6,
                                       err_msg=path)

    def test_gradients_match_the_direct_loss(self, pair):
        _, _, _, model, tokens = pair
        toks = torch.from_numpy(tokens).long()
        grads = []
        for chunk in (0, 50):
            model.zero_grad(set_to_none=True)
            ttr.lm_loss_fn(model, vocab_chunk=chunk)(model, toks).backward()
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
        for name, g in grads[0].items():
            torch.testing.assert_close(grads[1][name], g, rtol=2e-4,
                                       atol=1e-6, msg=name)

    def test_boundary_targets(self, hvd):
        """Every target sits on a chunk edge (first/last id of a chunk):
        the loss and the gradients of hidden and kernel against JAX's."""
        import jax
        import jax.numpy as jnp
        from horovod_tpu.models import transformer as jtr
        hidden = np.random.RandomState(1).randn(2, 6, 8).astype(np.float32)
        kernel = np.random.RandomState(2).randn(8, 20).astype(np.float32)
        targets = np.asarray([[0, 4, 5, 9, 10, 19],
                              [19, 15, 14, 10, 5, 0]], np.int32)
        want, want_grads = jax.value_and_grad(
            lambda h, k: jtr.chunked_softmax_cross_entropy(
                h, k, jnp.asarray(targets), chunk=5), argnums=(0, 1))(
                    jnp.asarray(hidden), jnp.asarray(kernel))
        h, k = (torch.from_numpy(a).requires_grad_(True)
                for a in (hidden, kernel))
        got = ttr.chunked_softmax_cross_entropy(
            h, k, torch.from_numpy(targets).long(), chunk=5)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        for t, w in zip((h, k), want_grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=2e-4, atol=1e-6)

    def test_rejects_nonpositive_chunk(self):
        with pytest.raises(ValueError, match="positive"):
            ttr.chunked_softmax_cross_entropy(
                torch.ones(1, 2, 4), torch.ones(4, 8),
                torch.zeros(1, 2, dtype=torch.long), chunk=0)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_weights_and_norm(self, dtype):
        """Masked positions drop out of the mean; ``norm`` replaces the
        weights' sum as its denominator (a sequence shard's mean)."""
        g = torch.Generator().manual_seed(3)
        hidden = torch.randn(2, 5, 8, generator=g).to(getattr(torch, dtype))
        kernel = torch.randn(8, 30, generator=g)
        targets = torch.randint(0, 30, (2, 5), generator=g)
        weights = torch.ones(2, 5)
        weights[:, -1] = 0
        nll = torch.nn.functional.cross_entropy(
            (hidden @ kernel.to(hidden.dtype)).float().reshape(-1, 30),
            targets.reshape(-1), reduction="none").reshape(2, 5)
        got = ttr.chunked_softmax_cross_entropy(hidden, kernel, targets,
                                                chunk=7, weights=weights)
        torch.testing.assert_close(got, (nll * weights).sum() / 8,
                                   rtol=1e-5, atol=1e-6)
        got = ttr.chunked_softmax_cross_entropy(hidden, kernel, targets,
                                                chunk=7, weights=weights,
                                                norm=torch.tensor(16.0))
        torch.testing.assert_close(got, (nll * weights).sum() / 16,
                                   rtol=1e-5, atol=1e-6)


class TestRemat:
    @pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
    @pytest.mark.parametrize("impl", ["full", "flash"])
    def test_remat_gradients_equal_no_remat(self, policy, impl):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                         attention_impl=impl)
        toks = torch.from_numpy(_tokens((2, 32), seed=5)).long()
        grads = []
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
            model = ttr.init_params(c, device="cpu", train=True)
            loss = ttr.lm_loss_fn(model)(model, toks)
            loss.backward()
            grads.append((loss.item(), {n: p.grad for n, p in
                                        model.named_parameters()}))
        assert grads[0][0] == grads[1][0]
        for name, g in grads[0][1].items():
            torch.testing.assert_close(grads[1][1][name], g, rtol=0, atol=0,
                                       msg=name)

    def test_unknown_policy_raises(self):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=True,
                                         remat_policy="everything")
        model = ttr.init_params(cfg, device="cpu", train=True)
        with pytest.raises(ValueError, match="remat_policy"):
            model(torch.zeros(1, 8, dtype=torch.long))

    def test_remat_matches_jax_remat(self, hvd):
        """cfg.remat with the "dots" policy in both packages: the loss and
        the gradients agree as without remat (fp32 1e-5 / 1e-4)."""
        import jax
        import jax.numpy as jnp
        from horovod_tpu.models import transformer as jtr
        jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, remat=True,
                                          remat_policy="dots")
        tokens = _tokens((2, 32), seed=6)
        params = jtr.TransformerLM(jcfg).init(
            jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
        jloss, jgrads = jax.value_and_grad(jtr.lm_loss_fn(
            jtr.TransformerLM(jcfg)))(params, jnp.asarray(tokens))
        model = params_from_flax(
            jax.device_get(params), ttr.TransformerConfig.tiny(
                dtype=torch.float32, remat=True, remat_policy="dots"),
            device="cpu", train=True)
        loss = ttr.lm_loss_fn(model)(model, torch.from_numpy(tokens).long())
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        got = _flax_grads(model, {n: p.grad for n, p in
                                  model.named_parameters()})
        for path, w in _jax_flat(jgrads).items():
            np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-5,
                                       err_msg=path)
