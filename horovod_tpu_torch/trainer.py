"""Train steps and the loss, port of ``horovod_tpu/trainer.py``.

PyTorch runs eagerly, so a train step is a Python function over a model
that owns its parameters and an optimizer that owns its state: zero the
gradients, run the loss forward and backward, step. With a
``DistributedOptimizer`` the gradients are averaged across workers
during the backward, which is what the JAX package's data-parallel and
GSPMD steps do inside one compiled program.
"""

import torch

from . import mpi_ops


def softmax_cross_entropy(logits, labels, weights=None):
    """Mean token-level cross entropy (labels are int ids). ``weights``
    (same shape as labels) masks positions out of the mean.

    As the JAX package computes it: ``nll = lse(logits) - logits[label]``
    with the row max detached (it cancels in the gradient), ``logits - max``
    in the logits' dtype and the sum of exponentials in fp32, so bf16
    logits round only where they are stored."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    sumexp = torch.exp((logits - m).float()).sum(dim=-1)
    lse = m[..., 0].float() + torch.log(sumexp)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - tgt.float()
    if weights is None:
        return nll.mean()
    weights = weights.to(nll.dtype)
    return (nll * weights).sum() / weights.sum()


def make_train_step(model, optimizer, loss_fn):
    """``step(batch) -> loss``: one optimizer update of ``model`` on
    ``loss_fn(model, batch)``; the returned loss is detached and stays on
    the device (reading it is the caller's sync point)."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def make_multi_step(model, optimizer, loss_fn):
    """``multi_step(batches) -> loss``: one update per entry of a stacked
    ``[n_steps, ...]`` batch, returning the last step's loss — the eager
    counterpart of ``make_gspmd_multi_step``, as a host loop."""
    step = make_train_step(model, optimizer, loss_fn)

    def multi_step(batches):
        loss = None
        for batch in batches:
            loss = step(batch)
        return loss
    return multi_step


def make_data_parallel_step(model, optimizer, loss_fn, steps_per_call=1):
    """``step(batch) -> loss``: the port of the JAX package's
    ``make_data_parallel_step``. Each worker passes its own shard of the
    batch; ``optimizer`` is a ``DistributedOptimizer``, which averages the
    gradients across workers during the backward (with its compression
    and fusion threshold) before it applies them. ``steps_per_call``
    updates run on the SAME batch per call, the synthetic-benchmark loop.
    Returns the last update's loss averaged over the workers, detached and
    on the device."""
    one = make_train_step(model, optimizer, loss_fn)

    def step(batch):
        for _ in range(steps_per_call):
            loss = one(batch)
        if mpi_ops.size() > 1:
            loss = mpi_ops.allreduce(loss, average=True)
        return loss
    return step
