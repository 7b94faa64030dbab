"""horovod_tpu_torch's BatchNorm against the JAX package.

The port's ``moments``/``moments2`` (on the CPU: the plain versions of the
B6/B7 kernels) against ``horovod_tpu.ops.batch_norm.moments``/``moments2``
(Pallas in interpret mode) and float64 numpy; the port's ``TpuBatchNorm``
against the JAX one, and its flax-semantics ``BatchNorm`` against
``flax.linen.BatchNorm``, on the same weights and seeded numpy inputs:
forward, running statistics, dx/dscale/dbias, eval mode and bf16 I/O, at
the tolerances of ``tests/test_batch_norm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from horovod_tpu.ops import batch_norm as jbn
from horovod_tpu_torch.models import layers
from horovod_tpu_torch.models.convert import vision_from_flax
from horovod_tpu_torch.ops import batch_norm as tbn


def _x(seed=0, shape=(4, 5, 5, 24), scale=2.0, offset=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale +
            offset).astype(np.float32)


def _nchw(x, channels_last=True):
    """NHWC numpy -> NCHW torch, channels_last memory unless asked not."""
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return t.contiguous(memory_format=torch.channels_last) if channels_last \
        else t


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


CASES = {
    "unit": lambda: _x(),
    "rows21": lambda: _x(1, (7, 3, 24)),
    "offset": lambda: _x(2, scale=1.0, offset=1e3),
    "c3": lambda: _x(3, (10, 10, 10, 3)),
}


class TestMoments:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_moments_match_jax_and_float64(self, case):
        x = CASES[case]()
        s, ss = tbn.moments(torch.from_numpy(x))
        js, jss = jbn.moments(jnp.asarray(x))
        xf = x.astype(np.float64).reshape(-1, x.shape[-1])
        for got, want_jax, exact in ((s, js, xf.sum(0)),
                                     (ss, jss, (xf * xf).sum(0))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(want_jax),
                                       rtol=1e-5)

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_moments2_match_jax_and_float64(self, case):
        x = CASES[case]()
        y = x * 0.3 - 1.0
        sa, sab = tbn.moments2(torch.from_numpy(y), torch.from_numpy(x))
        jsa, jsab = jbn.moments2(jnp.asarray(y), jnp.asarray(x))
        xf = x.astype(np.float64).reshape(-1, x.shape[-1])
        yf = y.astype(np.float64).reshape(-1, x.shape[-1])
        for got, want_jax, exact in ((sa, jsa, yf.sum(0)),
                                     (sab, jsab, (yf * xf).sum(0))):
            np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(want_jax),
                                       rtol=1e-5)

    def test_bf16_input_accumulates_in_fp32(self):
        x = torch.from_numpy(_x(4)).bfloat16()
        s, ss = tbn.moments(x)
        xf = x.double().reshape(-1, 24)
        assert s.dtype == ss.dtype == torch.float32
        np.testing.assert_allclose(s.numpy(), xf.sum(0).numpy(), rtol=1e-5)
        np.testing.assert_allclose(ss.numpy(), (xf * xf).sum(0).numpy(),
                                   rtol=1e-5)

    @pytest.mark.parametrize("channels_last", [True, False])
    def test_nchw_input_through_its_nhwc_view(self, channels_last):
        """An NCHW-contiguous tensor's NHWC view is copied (and counted)
        before the reduction; a channels_last one is not. A plain reshape
        of the NCHW tensor would give other sums."""
        x = _x(5)
        t = _nchw(x, channels_last)
        tbn.reset_counts()
        s, ss = tbn.moments(t.movedim(1, -1))
        sa, sab = tbn.moments2(t.movedim(1, -1), t.movedim(1, -1))
        xf = x.astype(np.float64).reshape(-1, 24)
        np.testing.assert_allclose(s.numpy(), xf.sum(0), rtol=1e-5)
        np.testing.assert_allclose(sab.numpy(), (xf * xf).sum(0), rtol=1e-5)
        want = {} if channels_last else {"moments": 1, "moments2": 2}
        assert dict(tbn.layout_copies) == want
        assert not tbn.launch_counts   # the CPU runs no kernel
        if not channels_last:
            naive = t.reshape(-1, 24).sum(0).numpy()
            assert not np.allclose(naive, xf.sum(0), rtol=1e-3)

    def test_moments2_refuses_shape_mismatch(self):
        with pytest.raises(ValueError, match="differ"):
            tbn.moments2(torch.zeros(4, 3), torch.zeros(3, 4))


def _jax_pair(kind, momentum=0.9, eps=1e-5):
    if kind == "tpu":
        return jbn.TpuBatchNorm(use_running_average=False, momentum=momentum,
                                epsilon=eps)
    return nn.BatchNorm(use_running_average=False, momentum=momentum,
                        epsilon=eps)


def _port(kind, c, momentum=0.9, eps=1e-5, **kw):
    cls = tbn.TpuBatchNorm if kind == "tpu" else layers.BatchNorm
    return cls(c, momentum=momentum, epsilon=eps, device="cpu", **kw)


def _variables(x, seed=7):
    """Variables of the module (flax's tree) with a random scale and bias
    and running statistics, as numpy."""
    r = np.random.RandomState(seed)
    c = x.shape[-1]
    return {"params": {"scale": r.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": r.randn(c).astype(np.float32)},
            "batch_stats": {"mean": r.randn(c).astype(np.float32) * 0.1,
                            "var": r.uniform(0.5, 2, c).astype(np.float32)}}


@pytest.mark.parametrize("kind", ["tpu", "flax"])
class TestAgainstJax:
    def test_forward_and_running_stats(self, kind):
        x = _x()
        variables = _variables(x)
        yj, sj = _jax_pair(kind).apply(variables, jnp.asarray(x),
                                       mutable=["batch_stats"])
        mod = vision_from_flax(variables, _port(kind, 24)).train()
        y = mod(_nchw(x))
        assert y.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj), atol=2e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(mod, k).numpy(),
                                       np.asarray(sj["batch_stats"][k]),
                                       atol=2e-5)

    @pytest.mark.parametrize("channels_last", [True, False])
    def test_backward_matches(self, kind, channels_last):
        x = _x()
        variables = _variables(x)
        jmod = _jax_pair(kind)

        def loss(params, x):
            y, _ = jmod.apply({**variables, "params": params}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y ** 2 + 0.3 * y)

        gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                                jnp.asarray(x))
        mod = vision_from_flax(variables, _port(kind, 24)).train()
        xt = _nchw(x, channels_last).requires_grad_(True)
        y = mod(xt)
        (y ** 2 + 0.3 * y).sum().backward()
        tol = dict(rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(mod.scale.grad.numpy(),
                                   np.asarray(gp["scale"]), **tol)
        np.testing.assert_allclose(mod.bias.grad.numpy(),
                                   np.asarray(gp["bias"]), **tol)
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), **tol)

    def test_eval_mode_uses_running_stats(self, kind):
        x = _x(8)
        variables = _variables(x)
        eval_j = (jbn.TpuBatchNorm(use_running_average=True) if kind == "tpu"
                  else nn.BatchNorm(use_running_average=True))
        yj = eval_j.apply(variables, jnp.asarray(x))
        mod = vision_from_flax(variables, _port(kind, 24)).eval()
        y = mod(_nchw(x))
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj), atol=2e-5)
        # eval leaves the running statistics alone; use_running_average
        # overrides the training flag
        np.testing.assert_array_equal(mod.mean.numpy(),
                                      variables["batch_stats"]["mean"])
        mod.train()
        y2 = mod(_nchw(x), use_running_average=True)
        torch.testing.assert_close(y2, y, rtol=0, atol=0)

    def test_bf16_io_fp32_stats(self, kind):
        x = np.random.RandomState(1).randn(2, 4, 4, 16).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        variables = jax.device_get(_jax_pair(kind).init(
            jax.random.PRNGKey(0), xb))
        yj, sj = _jax_pair(kind).apply(variables, xb,
                                       mutable=["batch_stats"])
        mod = vision_from_flax(variables, _port(kind, 16)).train()
        y = mod(_nchw(x).bfloat16())
        assert y.dtype == torch.bfloat16
        assert mod.mean.dtype == mod.var.dtype == torch.float32
        assert abs(y.float().mean().item()) < 0.05
        # one bf16 rounding of the same fp32 value, up to an ulp
        np.testing.assert_allclose(_nhwc(y), np.asarray(yj, np.float32),
                                   rtol=1e-2, atol=1e-2)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(mod, k).numpy(),
                                       np.asarray(sj["batch_stats"][k]),
                                       atol=2e-5)

    def test_momentum_is_flax_convention(self, kind):
        x = _x(9)
        mod = _port(kind, 24, momentum=0.5).train()
        mod(_nchw(x))
        xf = x.reshape(-1, 24).astype(np.float64)
        np.testing.assert_allclose(mod.mean.numpy(), 0.5 * xf.mean(0),
                                   atol=2e-5)
        # biased batch variance, as flax keeps it (torch's own BatchNorm
        # would store the unbiased one)
        np.testing.assert_allclose(mod.var.numpy(), 0.5 + 0.5 * xf.var(0),
                                   rtol=1e-5)


def test_port_norms_agree_with_each_other():
    """The kernel-backed TpuBatchNorm and the torch-backed BatchNorm are
    the same function, as the JAX package's two are."""
    x = _x(10)
    a, b = _port("tpu", 24).train(), _port("flax", 24).train()
    xa = _nchw(x).requires_grad_(True)
    xb = _nchw(x).requires_grad_(True)
    ya, yb = a(xa), b(xb)
    np.testing.assert_allclose(_nhwc(ya), _nhwc(yb), atol=2e-5)
    ya.pow(3).sum().backward()
    yb.pow(3).sum().backward()
    np.testing.assert_allclose(_nhwc(xa.grad), _nhwc(xb.grad), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 0.25), ("float32", 1e-4)])
def test_resnet50_grads_under_reordered_statistics(dtype, tol):
    """What the card's kernel-vs-plain gradient check (chip_smoke.py,
    phase 3c) can hold: the statistics summed in float64 and rounded once,
    in place of the fp32 sums, move a batch-2 ResNet-50 (tpu) step's
    gradients by as much as two correct summation orders can. In fp32 that
    is 4.3e-6 of each gradient's largest magnitude (measured); in bf16 a
    rounding flip in one layer moves every layer below it, so bn_init's
    gradients move by 7.0e-2 in L2 and single elements by 0.23 of the
    largest (measured): the card holds bf16 gradients by their L2 norm to
    0.25, fp32 ones elementwise to 1e-4."""
    from horovod_tpu_torch import models, trainer
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    images = torch.randn(2, 3, 224, 224, generator=g).to(dt).contiguous(
        memory_format=torch.channels_last)
    labels = torch.randint(0, 1000, (2,), generator=g)
    model = models.build("resnet50", dtype=dt, norm_impl="tpu",
                         device="cpu").train()

    def grads():
        model.zero_grad(set_to_none=True)
        trainer.softmax_cross_entropy(model(images), labels).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    def moments64(xf):
        x = xf.double()
        return x.sum(0).float(), (x * x).sum(0).float()

    def moments2_64(af, bf):
        a = af.double()
        return a.sum(0).float(), (a * bf.double()).sum(0).float()

    want = grads()
    saved = tbn.ref.moments, tbn.ref.moments2
    tbn.ref.moments, tbn.ref.moments2 = moments64, moments2_64
    try:
        got = grads()
    finally:
        tbn.ref.moments, tbn.ref.moments2 = saved
    for name, w in want.items():
        diff = got[name] - w
        if dtype == "float32":
            assert diff.abs().max() <= tol * w.abs().max(), name
        else:
            assert diff.norm() <= tol * w.norm(), name
