"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one, which stays the reference. It
imports torch and never jax, flax, optax or anything of ``horovod_tpu``.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``; each TPU kernel on a ported path is a hand-written
Hopper kernel under ``csrc/``, built at first use.

Ported so far: the serving path (``serving.ServeEngine`` over
``models.transformer.TransformerLM``) with the flash-attention forward
kernels (``ops.flash_attention``). See ROADMAP.md for what comes next.
"""

from . import common, models, ops, parallel, serving  # noqa: F401
