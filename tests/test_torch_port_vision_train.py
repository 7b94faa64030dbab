"""horovod_tpu_torch's vision training path against the JAX package.

One ``make_data_parallel_step`` update of ResNet-18 (tpu) with
``DistributedOptimizer(SGD(0.01, momentum=0.9))`` against the JAX
harness's loss, ``jax.value_and_grad`` and ``optax.sgd`` on the same
seeded weights and batch (through ``models.convert.vision_from_flax``);
InceptionV3's logits in train mode; ``steps_per_call``; ``SGD`` against
``optax.sgd`` over three steps; the layout of a ResNet-50 step's BatchNorm
statistics; and ``synthetic_benchmark --device cpu``. Helpers come from
test_torch_port_vision.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu import trainer as jtrainer
from horovod_tpu_torch import mpi_ops, optim, synthetic_benchmark, trainer
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models.convert import _child, vision_from_flax
from horovod_tpu_torch.ops import batch_norm as tbn
from test_torch_port_vision import (_images, _nchw, _port, _random_variables,
                                    check_logits)


def test_inception_train_mode_logits_match_jax():
    """Train mode at 107x107, where InceptionE's maps are 2x2; at 75x75
    they are 1x1 and the BatchNorms' two values per channel make flax's
    variance ill-conditioned (5e-2 of logit measured between the
    packages). Measured max |diff| 3.7e-4."""
    check_logits("inception3", {}, {}, (2, 107, 107, 3), True, 1e-3)


def _flax_leaf(tree, name):
    """The flax array a port parameter name stands for, in the port's
    layout."""
    *mods, leaf = name.split(".")
    for key in mods:
        _, tree = _child(tree, key)
    arr = np.asarray(tree["kernel" if leaf == "weight" else leaf])
    if leaf == "weight":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return arr


@pytest.fixture
def hvd_cpu():
    mpi_ops.init(device="cpu")
    yield
    mpi_ops.shutdown()


def test_data_parallel_step_matches_jax_sgd(hvd_cpu):
    """One update of ResNet-18 (tpu) through make_data_parallel_step and
    DistributedOptimizer(SGD(0.01, momentum=0.9)) against the JAX
    harness's loss_fn, jax.value_and_grad and optax.sgd: the loss, every
    gradient (to 1e-4 of that gradient's largest magnitude; measured
    1.7e-5) and every parameter after the step."""
    jmodel = jmodels.build("resnet18", num_classes=10, dtype=jnp.float32,
                           norm_impl="tpu")
    variables = _random_variables(jmodel, (2, 48, 48, 3), seed=11)
    params, stats = variables["params"], variables["batch_stats"]
    x = _images(12, (2, 48, 48, 3))
    labels = np.random.RandomState(13).randint(0, 10, 2).astype(np.int32)

    def loss_fn(p, imgs, lbls):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, imgs,
                                 train=True, mutable=["batch_stats"])
        return jtrainer.softmax_cross_entropy(logits, lbls)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(x), jnp.asarray(labels))
    tx = optax.sgd(0.01, momentum=0.9)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = jax.device_get(optax.apply_updates(params, updates))
    jgrads = jax.device_get(jgrads)

    model = vision_from_flax(variables, _port("resnet18", norm_impl="tpu"))
    model.train()
    opt = optim.DistributedOptimizer(
        optim.SGD(model.parameters(), 0.01, momentum=0.9),
        named_parameters=model.named_parameters())

    def tloss(model, batch):
        return trainer.softmax_cross_entropy(model(batch[0]), batch[1])

    step = trainer.make_data_parallel_step(model, opt, tloss)
    loss = step((_nchw(x), torch.from_numpy(labels)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, p in model.named_parameters():
        g = _flax_leaf(jgrads, name)
        scale = np.abs(g).max()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        # the step moves each parameter by lr x its gradient, so the
        # gradients' tolerance carries over scaled by lr
        np.testing.assert_allclose(p.detach().numpy(), _flax_leaf(jnew, name),
                                   rtol=1e-6, atol=0.01 * 1e-4 * scale,
                                   err_msg=name)


def test_steps_per_call_repeats_the_batch(hvd_cpu):
    """steps_per_call=3 on one batch lands where three single steps do."""
    x = _nchw(_images(14, (4, 28, 28, 1)))
    labels = torch.from_numpy(np.random.RandomState(15).randint(0, 10, 4))
    out = []
    for steps_per_call, calls in ((3, 1), (1, 3)):
        model = tmnist.MnistCNN(device="cpu").eval()   # no dropout draws
        opt = optim.DistributedOptimizer(
            optim.SGD(model.parameters(), 0.05, momentum=0.9))
        step = trainer.make_data_parallel_step(
            model, opt,
            lambda m, b: trainer.softmax_cross_entropy(m(b[0]), b[1]),
            steps_per_call=steps_per_call)
        for _ in range(calls):
            loss = step((x, labels))
        out.append((loss.item(), [p.detach().clone()
                                  for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sgd_matches_optax_over_three_steps():
    r = np.random.RandomState(0)
    shapes = [(64, 32), (128,), (7, 5, 3, 3)]
    params = [r.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(r.randn(*s) * 10 ** r.uniform(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = optax.sgd(0.01, momentum=0.9)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.SGD(tp, 0.01, momentum=0.9)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(opt.state[p]["trace"].numpy(),
                                   np.asarray(state[0].trace[i]), rtol=1e-6,
                                   atol=0)


def test_synthetic_benchmark_on_cpu(capsys):
    rates = synthetic_benchmark.main([
        "--device", "cpu", "--model", "resnet18", "--batch-size", "2",
        "--image-size", "32", "--num-warmup-batches", "1", "--num-iters",
        "2", "--num-batches-per-iter", "1", "--norm-impl", "tpu"])
    out = capsys.readouterr().out
    assert len(rates) == 2 and all(r > 0 for r in rates)
    for line in ("Model: resnet18", "Batch size: 2 per worker x 1 workers",
                 "Iter #1:", "Img/sec per worker:",
                 "Total img/sec on 1 worker(s):"):
        assert line in out


def test_synthetic_benchmark_eager_allreduce_names_its_slice(capsys):
    """``--eager-allreduce`` runs (it raised before the eager core was
    ported): the protocol's lines, plus the gradient-averaging line, and
    one eager step (``build_eager_step``: gradients through the eager
    core, a plain SGD) equals one step of ``build_step``'s
    ``DistributedOptimizer`` route, which test_data_parallel_step_
    matches_jax_sgd holds to the JAX harness, on the same seeded model
    and batch."""
    rates = synthetic_benchmark.main([
        "--device", "cpu", "--model", "resnet18", "--batch-size", "2",
        "--image-size", "32", "--num-warmup-batches", "1", "--num-iters",
        "2", "--num-batches-per-iter", "1", "--norm-impl", "tpu",
        "--eager-allreduce"])
    out = capsys.readouterr().out
    assert len(rates) == 2 and all(r > 0 for r in rates)
    for line in ("Gradient averaging: eager fused allreduce",
                 "Img/sec per worker:", "Total img/sec on 1 worker(s):"):
        assert line in out
    mpi_ops.init(device="cpu")
    try:
        params = []
        for build in (synthetic_benchmark.build_step,
                      synthetic_benchmark.build_eager_step):
            step, model, _, (images, labels) = build(
                "resnet18", 2, 32, torch.device("cpu"), norm_impl="tpu")
            g = torch.Generator().manual_seed(4)
            images.copy_(torch.randn(images.shape, generator=g))
            labels.copy_(torch.randint(0, 1000, labels.shape, generator=g))
            step((images, labels))
            params.append({n: p.detach().float().clone()
                           for n, p in model.named_parameters()})
        for n, p in params[0].items():
            torch.testing.assert_close(params[1][n], p, rtol=0, atol=0,
                                       msg=n)
    finally:
        mpi_ops.shutdown()


def test_resnet50_step_makes_no_layout_copy(hvd_cpu):
    """A ResNet-50 (tpu) train step in channels_last hands every BN
    statistics call a contiguous [rows, C] view: 53 moments and 53
    moments2 calls, no copy."""
    step, model, _, _ = synthetic_benchmark.build_step(
        "resnet50", 2, 32, torch.device("cpu"), norm_impl="tpu")
    calls = {"moments": 0, "moments2": 0}
    saved = tbn.ref.moments, tbn.ref.moments2

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped
    tbn.ref.moments = count("moments", saved[0])
    tbn.ref.moments2 = count("moments2", saved[1])
    try:
        tbn.reset_counts()
        x = _nchw(_images(16, (2, 32, 32, 3))).bfloat16()
        loss = step((x, torch.tensor([3, 7])))
    finally:
        tbn.ref.moments, tbn.ref.moments2 = saved
    assert math.isfinite(loss.item())
    assert calls == {"moments": 53, "moments2": 53}
    assert not tbn.layout_copies
