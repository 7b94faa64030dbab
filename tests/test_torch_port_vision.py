"""horovod_tpu_torch's vision path against the JAX package.

Each zoo model of the port runs the same seeded numpy weights (random
kernels, BatchNorm scales, biases and running statistics, loaded through
``models.convert.vision_from_flax``) and the same seeded numpy images as
the flax model, in fp32: ResNet-18 with both norm impls, ResNet-50
(bottleneck and projection), VGG-11, InceptionV3 at its smallest size
(75×75) and MnistCNN. The logits must agree to the tolerance of
``tests/test_batch_norm.py``'s ResNet check (1e-3) or a tighter one
where it holds; the largest difference measured on the CPU is written
beside each case. Also the
SAME padding helper against lax's and flax's, and the converter's
refusals. The training side is in test_torch_port_vision_train.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jmodels
from horovod_tpu.models import mnist as jmnist
from horovod_tpu_torch import models
from horovod_tpu_torch.models import layers
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models.convert import vision_from_flax


def _random_variables(jmodel, shape, seed, takes_train=True):
    """Seeded numpy variables of the flax model's tree: kernels normal
    with std 1/sqrt(fan_in), biases and BN statistics and scales away
    from their initial values, so every leaf matters."""
    init_kw = {"train": False} if takes_train else {}
    tree = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32), **init_kw))
    r = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        s = leaf.shape
        if name == "kernel":
            out = r.randn(*s) / math.sqrt(math.prod(s[:-1]))
        elif name in ("bias", "mean"):
            out = r.randn(*s) * 0.1
        elif name == "scale":
            out = r.uniform(0.5, 1.5, s)
        else:   # var
            out = r.uniform(0.5, 2.0, s)
        return out.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def _images(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).contiguous(memory_format=torch.channels_last)


def _port(name, **kw):
    return models.build(name, num_classes=10, dtype=torch.float32,
                        device="cpu", **kw)


# name, JAX kwargs, port kwargs, image shape (NHWC), train mode, the
# tolerance (rtol = atol) and beside it the largest |logit difference|
# measured on the CPU: 1e-3, tests/test_batch_norm.py's, where no tighter
# one holds. Train mode runs where the last stage's maps hold 8 values per
# channel: over 2 (1x1 maps at batch 2), flax's variance E[x²] − E[x]²
# cancels, the two packages' different summation orders are amplified by
# mean²/var, and their logits differed by up to 1.37 (ResNet-50 tpu,
# 32x32, measured) with every layer equal in eval mode.
MODEL_CASES = {
    "resnet18-tpu": ("resnet18", {"norm_impl": "tpu"}, {"norm_impl": "tpu"},
                     (2, 64, 64, 3), True, 1e-4),             # 7.4e-6
    "resnet18-flax": ("resnet18", {}, {"norm_impl": "flax"},
                      (2, 64, 64, 3), True, 1e-4),            # 9.3e-6
    "resnet18-flax-tree-into-tpu": ("resnet18", {}, {"norm_impl": "tpu"},
                                    (2, 64, 64, 3), True, 1e-4),  # 9.7e-6
    "resnet18-eval": ("resnet18", {"norm_impl": "tpu"}, {"norm_impl": "tpu"},
                      (2, 32, 32, 3), False, 1e-4),           # 1.8e-6
    "resnet50-eval": ("resnet50", {}, {}, (2, 32, 32, 3), False,
                      1e-4),                                  # 2.1e-6
    "resnet50-tpu": ("resnet50", {"norm_impl": "tpu"}, {"norm_impl": "tpu"},
                     (2, 64, 64, 3), True, 1e-3),             # 2.0e-4
    "vgg11": ("vgg11", {"dropout_rate": 0.0},
              {"dropout_rate": 0.0, "image_size": 32}, (2, 32, 32, 3), False,
              1e-5),                                          # 3.3e-7
    # train mode: test_torch_port_vision_train.py
    "inception3": ("inception3", {}, {}, (2, 75, 75, 3), False,
                   1e-5),                                     # 1.0e-7
}


def check_logits(name, jkw, tkw, shape, train, tol=1e-3):
    """The port's logits against the flax model's on the same seeded
    weights and images, to ``tol``."""
    jmodel = jmodels.build(name, num_classes=10, dtype=jnp.float32, **jkw)
    variables = _random_variables(jmodel, shape, seed=1)
    x = _images(2, shape)
    if train:
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = vision_from_flax(variables, _port(name, **tkw)).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_logits_match_jax(case):
    check_logits(*MODEL_CASES[case])


def test_mnist_logits_match_jax():
    jmodel = jmnist.MnistCNN()
    variables = _random_variables(jmodel, (2, 28, 28, 1), seed=3)
    x = _images(4, (2, 28, 28, 1))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = vision_from_flax(variables, tmnist.MnistCNN(device="cpu")).eval()
    with torch.no_grad():
        got = model(_nchw(x))
    # measured max |diff| 4.8e-7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("size", [7, 8, 15, 16, 55, 56, 112, 224])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                           (7, 2)])
def test_same_pads_match_lax(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert layers.same_pads(size, kernel, stride) == tuple(want[0])


@pytest.mark.parametrize("size", [9, 10])
def test_same_conv_and_pool_match_flax(size):
    """SAME at stride 2 pads (0, 1) on even sizes and (1, 1) on odd: the
    explicit-pad path and the symmetric one, against flax's Conv and
    max_pool (−inf padding)."""
    from flax import linen as nn
    x = _images(5, (2, size, size, 4))
    conv = nn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False)
    variables = _random_variables(conv, x.shape, seed=6,
                                  takes_train=False)
    want = conv.apply(variables, jnp.asarray(x))
    tconv = vision_from_flax(variables, layers.Conv(
        4, 6, (3, 3), (2, 2), "SAME", use_bias=False))
    with torch.no_grad():
        got = tconv(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    neg = -np.abs(x) - 1.0   # every real value below the pad's zero
    want = nn.max_pool(jnp.asarray(neg), (3, 3), (2, 2), padding="SAME")
    got = layers.max_pool(_nchw(neg), (3, 3), (2, 2), "SAME")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_converter_refuses_what_does_not_fit():
    jmodel = jmnist.MnistCNN()
    variables = _random_variables(jmodel, (2, 28, 28, 1), seed=3)
    bad = {"params": dict(variables["params"])}
    bad["params"]["Dense_1"] = {"kernel": np.zeros((50, 11), np.float32),
                                "bias": np.zeros(11, np.float32)}
    with pytest.raises(ValueError, match="Dense_1/kernel"):
        vision_from_flax(bad, tmnist.MnistCNN(device="cpu"))
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "Conv_1"}}
    with pytest.raises(KeyError, match="Conv_1"):
        vision_from_flax(missing, tmnist.MnistCNN(device="cpu"))
    extra = {"params": {**variables["params"],
                        "Dense_9": {"bias": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="Dense_9"):
        vision_from_flax(extra, tmnist.MnistCNN(device="cpu"))
