"""horovod_tpu_torch's Mixture-of-Experts against the JAX package's.

In this process, from one flax init each:

  * ``MoEMLP`` against the JAX ``MoEMLP`` at fp32: one expert top-1 (the
    dense SwiGLU math, as ``test_single_expert_matches_dense_math``), E 4
    k 2 cf 1.25, cf 0.25 (tokens dropped), k = E, and a zero router (every
    probability equal: the tie order decides the routing). The output
    within 2e-5, the load-balance loss within 1e-6, the gradients of the
    router, the stacks and the input against ``jax.grad`` within 1e-5 of
    each leaf's largest magnitude; and one bf16 case within 5e-2;
  * ``TransformerLM`` with experts: the logits, and ``lm_loss_fn`` at
    aux_weight 0.01 and 0, full and vocab-chunked, value and gradients;
  * ``param_specs``' expert rows against the JAX spec tree, leaf by leaf.

The expert-parallel steps on four gloo ranks are in
``test_torch_port_moe_gspmd.py``, ``train_lm`` with experts in
``test_torch_port_moe_train.py``.
"""

import functools

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (flax_from_params, flax_mapping,
                                              params_from_flax)
from horovod_tpu_torch.parallel.mesh import P

SEQ = 32
EXPERTS = 4
# MoEMLP cases: (num_experts, top k, capacity factor, zero router)
LAYER_CASES = {"one_expert": (1, 1, 1.5, False),
               "e4_k2": (4, 2, 1.25, False),
               "dropping": (4, 2, 0.25, False),
               "k_equals_e": (4, 4, 1.25, False),
               "zero_router": (4, 2, 1.25, True)}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _layer_cfgs(experts, k, cf, jdtype=None, tdtype=torch.float32):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    kw = dict(vocab_size=128, num_layers=1, num_heads=2, d_model=16,
              d_ff=32, max_seq_len=64, num_experts=experts,
              num_experts_per_tok=k, expert_capacity_factor=cf)
    return (jtr.TransformerConfig(dtype=jdtype or jnp.float32, **kw),
            ttr.TransformerConfig(dtype=tdtype, **kw))


def _layer_pair(case, jdtype=None, tdtype=torch.float32, seed=0):
    """(JAX layer, its params, the port's layer holding them, input)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models.moe import MoEMLP as JMoE
    experts, k, cf, zero = LAYER_CASES[case]
    jcfg, tcfg = _layer_cfgs(experts, k, cf, jdtype, tdtype)
    x = np.random.RandomState(seed).randn(2, 8, 16).astype(np.float32)
    layer = JMoE(jcfg)
    params = jax.device_get(jax.jit(layer.init)(jax.random.PRNGKey(seed),
                                                jnp.asarray(x))["params"])
    if zero:
        params["router"]["kernel"] = np.zeros_like(
            params["router"]["kernel"])
    mine = tmoe.MoEMLP(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        mine.router.weight.copy_(torch.from_numpy(
            np.asarray(params["router"]["kernel"]).T.copy()))
        for n in ("w_gate", "w_up", "w_down"):
            getattr(mine, n).copy_(torch.from_numpy(np.array(params[n])))
    return layer, params, mine, x


def _jax_layer_grads(layer, params, x):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models.moe import aux_loss_from

    def loss(p, x):
        out, mut = layer.apply({"params": p}, x, mutable=["losses"])
        aux = aux_loss_from(mut, weight=1.0)
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux, (out, aux)
    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(out, np.float32), float(aux), jax.device_get(grads)


def _hold(got, want, label, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=label)


# ---------------------------------------------------------------------------
# the layer


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(hvd, case):
    layer, params, mine, x = _layer_pair(case)
    want_out, want_aux, (jg, jgx) = _jax_layer_grads(layer, params, x)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = mine(tx)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=2e-5,
                               atol=2e-5)
    assert abs(aux.item() - want_aux) <= 1e-6
    assert np.all(np.isfinite(out.detach().numpy()))
    ((out ** 2).sum() + aux).backward()
    _hold(mine.router.weight.grad.numpy().T, jg["router"]["kernel"],
          "router")
    for n in ("w_gate", "w_up", "w_down"):
        _hold(getattr(mine, n).grad.numpy(), jg[n], n)
    _hold(tx.grad.numpy(), jgx, "input")
    if case == "one_expert":    # the dense SwiGLU math
        import torch.nn.functional as F
        w = {n: getattr(mine, n).detach()[0] for n in ("w_gate", "w_up",
                                                        "w_down")}
        xt = torch.from_numpy(x)
        dense = (F.silu(xt @ w["w_gate"]) * (xt @ w["w_up"])) @ w["w_down"]
        np.testing.assert_allclose(out.detach().numpy(), dense.numpy(),
                                   rtol=2e-5, atol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = tmoe.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    assert torch.equal(vals, probs.gather(-1, idx))


def test_moe_layer_bf16_matches_jax(hvd):
    import jax.numpy as jnp
    layer, params, mine, x = _layer_pair("e4_k2", jnp.bfloat16,
                                         torch.bfloat16)
    want_out, want_aux, _ = _jax_layer_grads(layer, params, x)
    out, aux = mine(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    scale = np.abs(want_out).max()
    np.testing.assert_allclose(out.float().detach().numpy(), want_out,
                               rtol=5e-2, atol=5e-2 * scale)
    assert abs(aux.item() - want_aux) <= 5e-2 * abs(want_aux)


# ---------------------------------------------------------------------------
# the model


def _model_cfgs(tie=False):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    return (jtr.TransformerConfig.tiny(dtype=jnp.float32, num_experts=EXPERTS,
                                       tie_embeddings=tie),
            ttr.TransformerConfig.tiny(dtype=torch.float32,
                                       num_experts=EXPERTS,
                                       tie_embeddings=tie))


@functools.lru_cache(maxsize=None)
def _jax_model_params(tie=False, seed=3):
    """The flax init (numpy leaves; callers do not write into it)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    jcfg, _ = _model_cfgs(tie)
    return jax.device_get(jax.jit(jtr.TransformerLM(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((2, SEQ), jnp.int32))["params"])


def _model_tokens(seed=5):
    return np.random.RandomState(seed).randint(0, 256, (2, SEQ)).astype(
        np.int32)


def test_model_logits_and_aux_match_jax(hvd):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.models.moe import aux_loss_from
    jcfg, tcfg = _model_cfgs()
    tree = _jax_model_params()
    toks = _model_tokens()
    want, mut = jax.jit(lambda p, t: jtr.TransformerLM(jcfg).apply(
        {"params": p}, t, mutable=["losses"]))(tree, jnp.asarray(toks))
    model = params_from_flax(tree, tcfg, device="cpu")
    with torch.no_grad():
        got, auxes = model(torch.from_numpy(toks).long(), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert len(auxes) == tcfg.num_layers
    assert abs(tmoe.aux_loss_from(auxes, 1.0).item() -
               float(aux_loss_from(mut, 1.0))) <= 1e-6
    # the round trip of the converter
    back = flax_from_params(model, tcfg)
    for name, (path, _) in flax_mapping(tcfg).items():
        np.testing.assert_array_equal(_leaf(back, path), _leaf(tree, path),
                                      err_msg=name)


@pytest.mark.parametrize("aux_weight", [0.01, 0.0])
@pytest.mark.parametrize("chunk", [0, 96])
def test_lm_loss_fn_matches_jax(hvd, aux_weight, chunk):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    jcfg, tcfg = _model_cfgs()
    tree = _jax_model_params()
    toks = _model_tokens()
    jloss, jgrads = jax.jit(jax.value_and_grad(jtr.lm_loss_fn(
        jtr.TransformerLM(jcfg), aux_weight=aux_weight, vocab_chunk=chunk)))(
        tree, jnp.asarray(toks))
    model = params_from_flax(tree, tcfg, device="cpu", train=True)
    loss = ttr.lm_loss_fn(model, aux_weight, vocab_chunk=chunk)(
        model, torch.from_numpy(toks).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for name, (path, transposed) in flax_mapping(tcfg).items():
        w = np.asarray(_leaf(jgrads, path))
        _hold(grads[name].T if transposed else grads[name], w, name)


@pytest.mark.parametrize("tie", [False, True])
def test_param_specs_expert_rows_match_jax(hvd, tie):
    from horovod_tpu.models import transformer as jtr
    _, tcfg = _model_cfgs(tie)
    tree = _jax_model_params(tie)
    jspecs = jtr.param_specs(tree)
    model = params_from_flax(tree, tcfg, device="cpu")
    got = ttr.param_specs(model)
    assert set(got) == set(flax_mapping(tcfg))
    assert got["layers.0.mlp.w_gate"] == P("ep", None, "tp")
    for name, spec in got.items():
        path, transposed = flax_mapping(tcfg)[name]
        ndim = dict(model.named_parameters())[name].dim()

        def pad(t):
            return (tuple(t) + (None,) * ndim)[:ndim]
        want = pad(_leaf(jspecs, path))
        assert pad(spec) == (want[::-1] if transposed else want), name


def test_decode_refuses_experts(hvd):
    from horovod_tpu_torch.serving import decode
    _, tcfg = _model_cfgs()
    with pytest.raises(NotImplementedError, match="dense configs only"):
        decode._check_dense(tcfg)
