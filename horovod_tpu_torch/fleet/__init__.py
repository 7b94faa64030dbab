"""Fleet plane of the port: train -> serve weight publication.

The port of ``horovod_tpu/fleet``. It closes the loop between the
checkpoint plane and the serving plane: a ``WeightPublisher`` on the
trainer side turns every atomic manifest commit into a published weight
generation (monotonic generation id + step + checksum set, carried by one
atomically renamed publication pointer), and a ``WeightSubscriber`` on each
serving replica watches the pointer, loads new generations in the
background (on the card: pinned host memory, a copy stream of its own and
a CUDA event the engine waits on), checksum-verifies before arming, and
hands complete trees to the ``ServeEngine`` for a zero-drain swap at a step
boundary.

Imports are lazy, as in the JAX package: the subscriber pulls in the
checkpoint plane, which process-launch helpers must not pay for.
"""

_LAZY = {
    "WeightPublisher": "publisher",
    "WeightSubscriber": "subscriber",
    "ArmedGeneration": "subscriber",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
