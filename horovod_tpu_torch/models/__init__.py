"""Model zoo of the port: the flagship transformer LM and the reference's
benchmark families (ResNet, Inception V3, VGG), as in
``horovod_tpu/models``.

``build(name)`` instantiates a vision model on its device (CUDA unless
given ``device="cpu"``) with seeded weights, ``names()`` lists the
benchmark names (the ``--model`` choices of ``synthetic_benchmark``) and
``image_size(name)`` gives the canonical benchmark input resolution.
"""

from . import convert, transformer  # noqa: F401


def _registry():
    from . import inception, resnet, vgg
    registry = dict(resnet.MODELS)
    registry.update({
        "vgg11": vgg.VGG11, "vgg16": vgg.VGG16, "vgg19": vgg.VGG19,
        "inception3": inception.InceptionV3,
    })
    return registry


def build(name, **kwargs):
    """Instantiate a zoo model by benchmark name."""
    registry = _registry()
    if name not in registry:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(registry)}")
    return registry[name](**kwargs)


def names():
    """All benchmark model names."""
    return tuple(sorted(_registry()))


def image_size(name):
    """Canonical benchmark input resolution for a zoo model."""
    return 299 if name == "inception3" else 224
