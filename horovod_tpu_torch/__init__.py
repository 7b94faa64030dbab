"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one, which stays the reference. It
imports torch and never jax, flax, optax or anything of ``horovod_tpu``.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``; each TPU kernel on a ported path is a hand-written
Hopper kernel under ``csrc/``, built at first use.

Ported so far: the serving path (``serving.ServeEngine`` over
``models.transformer.TransformerLM``) with the flash-attention forward
kernels, and the training path — the Horovod API below over
``torch.distributed`` (NCCL on the card, gloo on the CPU), ``AdamW`` with
a bf16 first moment, and ``trainer``'s steps — with the flash-attention
backward kernels (``ops.flash_attention``). See ROADMAP.md for what comes
next.

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(hvd.AdamW(model.parameters(), 3e-4,
                                             mu_dtype=torch.bfloat16))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
"""

from . import common, models, ops, parallel, serving  # noqa: F401
from .mpi_ops import (  # noqa: F401
    init, shutdown, is_initialized, mpi_threads_supported,
    size, local_size, rank, local_rank, process_rank, process_count,
    allreduce, allreduce_, allreduce_async, allreduce_async_,
    grouped_allreduce, allgather, allgather_async,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    poll, synchronize)
from .ops.compression import Compression  # noqa: F401
from .optim import (  # noqa: F401
    AdamW, DistributedOptimizer, allreduce_gradients, broadcast_object,
    broadcast_optimizer_state, broadcast_parameters)
