"""Explicit ring collectives: N−1 neighbour exchanges, port of
``horovod_tpu/parallel/ring_collectives.py``.

The literal Baidu/Horovod ring: a reduce-scatter of N−1 steps, each rank
adding its own copy of the chunk its left neighbour's accumulator stands
for, then an all-gather of N−1 steps, with the reference's flattened,
padded chunking (nccl_operations.cc:210-216). Cost per rank:
2·(N−1)/N · |tensor| on the wire.

``axis_name`` is anything ``ops.collective_ops.comm_of`` takes: the
worker axis 'hvd', an axis of the global mesh, a process group or a group
object of ``parallel.ring``. Each step is the group object's ``shift``
(send to the next rank, receive from the previous one): over NCCL one
``batch_isend_irecv`` of a send and a receive; for ranks that are threads
of one process (``ThreadRing``), an exchange of references on the one
card. Tensors are each rank's own values.
"""

import torch
import torch.nn.functional as F

from ..ops.collective_ops import comm_of


def _pad_and_chunk(tensor, n):
    """Flatten to ``[n, padded / n]``; returns (chunks, size, shape)."""
    flat = tensor.reshape(-1)
    size = flat.numel()
    padded = -(-size // n) * n
    if padded != size:
        flat = F.pad(flat, (0, padded - size))
    return flat.reshape(n, padded // n), size, tensor.shape


def ring_reduce_scatter(tensor, axis_name="hvd", average=False):
    """Ring reduce-scatter: N−1 steps; rank i ends with chunk i of the sum.

    Rank i starts with chunk i−1 and at step s receives its left
    neighbour's accumulator (chunk i−2−s), adding its own copy of that
    chunk. Returns the flat padded chunk (``[padded_size / N]``)."""
    ring = comm_of(axis_name)
    n, idx = ring.size, ring.rank
    chunks, _, _ = _pad_and_chunk(tensor, n)
    acc = chunks[(idx - 1) % n].clone()
    for s in range(n - 1):
        recv, = ring.shift(acc)
        acc = chunks[(idx - s - 2) % n] + recv
    if average:
        acc = acc / n
    return acc


def ring_all_gather(chunk, axis_name="hvd"):
    """Ring all-gather: N−1 neighbour exchanges; every rank ends with all
    chunks in rank order. ``chunk`` is this rank's ``[chunk_size]``
    piece; returns ``[N, chunk_size]``."""
    ring = comm_of(axis_name)
    n, idx = ring.size, ring.rank
    out = [None] * n
    out[idx] = cur = chunk
    for s in range(n - 1):
        cur, = ring.shift(cur)
        out[(idx - s - 1) % n] = cur
    return torch.stack(out)


def ring_all_reduce(tensor, axis_name="hvd", average=False):
    """Ring allreduce = ring reduce-scatter + ring all-gather, the
    algorithm of the reference's backends; the result has ``tensor``'s
    shape."""
    chunk = ring_reduce_scatter(tensor, axis_name, average=average)
    gathered = ring_all_gather(chunk, axis_name)
    return gathered.reshape(-1)[:tensor.numel()].reshape(tensor.shape)


def ring_all_reduce_overlapped(tensor, fn, axis_name="hvd", average=False):
    """Ring allreduce with a per-chunk hook: ``fn(chunk)`` (an elementwise
    map: cast, scale, clip) is applied to this rank's chunk the moment it
    is fully reduced, before the all-gather carries it to the others."""
    chunk = fn(ring_reduce_scatter(tensor, axis_name, average=average))
    gathered = ring_all_gather(chunk, axis_name)
    return gathered.reshape(-1)[:tensor.numel()].reshape(tensor.shape)
