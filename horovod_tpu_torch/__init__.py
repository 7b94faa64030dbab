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
backward kernels (``ops.flash_attention``), and the vision path — the
model zoo (``models.build``: ResNet-18/34/50/101/152, VGG-11/16/19,
InceptionV3; ``models.mnist.MnistCNN``), ``SGD`` with momentum,
``trainer.make_data_parallel_step`` and ``synthetic_benchmark`` — whose
``norm_impl="tpu"`` BatchNorm reduces through the statistics kernels
(``ops.batch_norm``). Every Pallas kernel of the JAX package now has a
hand-written Hopper counterpart. Tensor and sequence parallelism:
``parallel.mesh`` (the dp/pp/tp/sp/ep mesh, PartitionSpecs placed as
DTensors), ``parallel.ring`` (ring, ring-flash and Ulysses attention),
Megatron tensor parallelism in ``models.transformer`` (``param_specs``,
``batch_spec``) and ``trainer.make_gspmd_step`` /
``make_gspmd_multi_step``. The eager coordination core (``ops.eager``:
the tensor table, rank-0 negotiation over the authenticated TCP wire of
``ops.negotiation`` and ``run.network``, fusion and the plan cache in
the native host core, CUDA stream/event completion) carries every
collective over the workers, ``allreduce_gradients`` and the
``--eager-allreduce`` steps. See ROADMAP.md for what comes next.

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
    grouped_allreduce, grouped_allreduce_async, allgather, allgather_async,
    reducescatter, alltoall,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    poll, synchronize)
from .ops.compression import Compression  # noqa: F401
from .optim import (  # noqa: F401
    SGD, AdamW, DistributedOptimizer, allreduce_gradients, broadcast_object,
    broadcast_optimizer_state, broadcast_parameters, distributed_grad)
from .common.exceptions import (  # noqa: F401
    DuplicateNameError, MismatchError, NotInitializedError, RanksLostError,
    ShutdownError, StalledError)
