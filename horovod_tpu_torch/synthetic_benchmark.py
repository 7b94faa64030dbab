"""Synthetic image benchmark through the port: the vision training path.

    python -m horovod_tpu_torch.synthetic_benchmark [--device cuda|cpu]
        [--model resnet50] [--batch-size 32] [--norm-impl flax|tpu] ...

The port of the JAX package's ``examples/synthetic_benchmark.py`` and its
harness (``examples/bench_common.py``: ``build_step``, ``timed_rates``),
itself parity with the reference's pytorch_synthetic_benchmark.py: the
same flags and printed lines (``Img/sec per worker``, ``Total img/sec``).
A zoo model at bf16 with seeded fp32 master weights, all-zero images and
labels (the JAX harness's data), ``DistributedOptimizer(SGD(0.01,
momentum=0.9))`` (bf16 gradient compression with ``--fp16-allreduce``),
``broadcast_parameters``, and ``trainer.make_data_parallel_step``. The
protocol: ``--num-warmup-batches`` steps (at least one: the kernels and
cuDNN's algorithm search run there), then ``--num-iters`` timed
iterations of ``--num-batches-per-iter`` steps, each ending in a read of
the loss.

``--eager-allreduce`` averages the gradients through the eager core
instead (``build_eager_step``: a plain ``SGD``, one grouped allreduce
submission per step), the JAX harness's ``build_eager_image_step``.

Added to the JAX CLI: ``--device`` (CUDA unless ``cpu`` is asked for)
and ``--norm-impl``: "flax" (PyTorch's batch norm, the JAX model's
default) or "tpu" (the fused statistics kernels, B6/B7). Each worker
drives one card; launch several with torchrun or hvdrun.
"""

import argparse
import time

import numpy as np
import torch

from . import models, mpi_ops, optim, trainer
from .common import state as state_mod
from .ops.compression import Compression


def positive_int(value):
    v = int(value)
    if v < 1:
        raise ValueError(f"expected a positive count, got {value}")
    return v


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="horovod_tpu_torch synthetic image benchmark")
    p.add_argument("--model", default="resnet50", choices=models.names())
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-worker batch size (reference default 32)")
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-iters", type=positive_int, default=10)
    p.add_argument("--num-batches-per-iter", type=positive_int, default=10)
    p.add_argument("--image-size", type=int, default=None,
                   help="default: the model's canonical size (224; "
                        "inception3 299)")
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="bf16 compression on gradient allreduce")
    p.add_argument("--eager-allreduce", action="store_true",
                   help="average gradients through the eager collective "
                        "core (one fused allreduce submission per step) "
                        "instead of DistributedOptimizer's hooks")
    p.add_argument("--norm-impl", default="flax", choices=["flax", "tpu"],
                   help="BatchNorm of the ResNets: PyTorch's ('flax') or "
                        "the fused statistics kernels ('tpu')")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.image_size is None:
        args.image_size = models.image_size(args.model)
    return args


def build_step(model_name, batch, image_size, device, fp16_allreduce=False,
               steps_per_call=1, norm_impl="flax", seed=0):
    """The data-parallel train step of a zoo model on zero images and
    labels: returns (step, model, optimizer, (images, labels)) with
    ``step((images, labels)) -> loss``. ``batch`` is this worker's."""
    kwargs = {}
    if model_name.startswith("vgg"):
        kwargs = {"dropout_rate": 0.0, "image_size": image_size}
    elif model_name.startswith("resnet"):
        kwargs = {"norm_impl": norm_impl}
    model = models.build(model_name, num_classes=1000, dtype=torch.bfloat16,
                         device=device,
                         generator=torch.Generator().manual_seed(seed),
                         **kwargs)
    model.train()
    images = torch.zeros((batch, 3, image_size, image_size),
                         dtype=torch.bfloat16, device=device).to(
        memory_format=torch.channels_last)
    labels = torch.zeros((batch,), dtype=torch.int64, device=device)
    compression = Compression.bf16 if fp16_allreduce else Compression.none
    opt = optim.DistributedOptimizer(
        optim.SGD(model.parameters(), 0.01, momentum=0.9),
        named_parameters=model.named_parameters(), compression=compression)
    optim.broadcast_parameters(model.state_dict(), root_rank=0)

    def loss_fn(model, batch):
        imgs, lbls = batch
        return trainer.softmax_cross_entropy(model(imgs), lbls)

    step = trainer.make_data_parallel_step(model, opt, loss_fn,
                                           steps_per_call=steps_per_call)
    return step, model, opt, (images, labels)


def timed_rates(step, batch_data, batch, num_warmup_batches, num_iters,
                num_batches_per_iter, on_iter=None, updates_per_step=1,
                losses=None):
    """The reference timing protocol; returns per-iteration img/sec of
    this worker's ``batch``. At least one warm-up step always runs, so the
    kernels' build and cuDNN's algorithm search never land in the timed
    region; reading the loss is the sync point (each iteration's loss is
    appended to ``losses`` when a list is given)."""
    for _ in range(max(1, num_warmup_batches)):
        loss = step(batch_data)
    loss.item()
    rates = []
    for i in range(num_iters):
        t0 = time.perf_counter()
        for _ in range(num_batches_per_iter):
            loss = step(batch_data)
        value = loss.item()
        dt = time.perf_counter() - t0
        if losses is not None:
            losses.append(value)
        rate = batch * num_batches_per_iter * updates_per_step / dt
        rates.append(rate)
        if on_iter is not None:
            on_iter(i, rate)
    return rates


def build_eager_step(model_name, batch, image_size, device,
                     fp16_allreduce=False, norm_impl="flax", seed=0):
    """``build_step`` with the gradients averaged by the eager core
    (``trainer.build_eager_image_step``) instead of a
    ``DistributedOptimizer``: returns (step, model, optimizer, (images,
    labels)), ``step`` returning the loss averaged over the workers."""
    compression = Compression.bf16 if fp16_allreduce else Compression.none
    one, model, opt, data = trainer.build_eager_image_step(
        model_name, batch, image_size, device, compression=compression,
        norm_impl=norm_impl, seed=seed)
    optim.broadcast_parameters(model.state_dict(), root_rank=0)

    def step(batch_data):
        loss = one(batch_data)
        if mpi_ops.size() > 1:
            loss = mpi_ops.allreduce(loss, average=True)
        return loss
    return step, model, opt, data


def main(argv=None):
    args = parse_args(argv)
    mpi_ops.init(device=args.device)
    device = state_mod.device()
    world = mpi_ops.size()
    build = build_eager_step if args.eager_allreduce else build_step
    step, _, _, batch_data = build(
        args.model, args.batch_size, args.image_size, device,
        fp16_allreduce=args.fp16_allreduce, norm_impl=args.norm_impl)
    root = mpi_ops.rank() == 0
    if root:
        print(f"Model: {args.model}")
        print(f"Batch size: {args.batch_size} per worker x {world} workers")
        if args.eager_allreduce:
            print("Gradient averaging: eager fused allreduce (the eager "
                  "coordination core)")

    def on_iter(i, rate):
        if root:
            print(f"Iter #{i}: {rate:.1f} img/sec per worker", flush=True)

    losses = []
    rates = timed_rates(step, batch_data, args.batch_size,
                        args.num_warmup_batches, args.num_iters,
                        args.num_batches_per_iter, on_iter=on_iter,
                        losses=losses)
    if root:
        mean, conf = np.mean(rates), 1.96 * np.std(rates)
        print(f"Img/sec per worker: {mean:.1f} +-{conf:.1f}")
        print(f"Total img/sec on {world} worker(s): "
              f"{mean * world:.1f} +-{conf * world:.1f}")
        print(f"Loss after each iteration: "
              f"{' '.join(f'{x:.6f}' for x in losses)}", flush=True)
    mpi_ops.shutdown()
    return rates


if __name__ == "__main__":
    main()
