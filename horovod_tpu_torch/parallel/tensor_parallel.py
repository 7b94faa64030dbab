"""Megatron-style tensor parallelism on local shards.

The JAX package expresses tensor parallelism as GSPMD shardings and XLA
inserts the collectives. In the port a parameter placed on a mesh is a
DTensor (``parallel.mesh``); the model computes on this rank's shard
(``local``) with the tp collectives written out, the conjugate pair of
Megatron-LM:

  ``copy_to``     identity forward, all-reduce of the gradient backward:
                  the input of a column-parallel product;
  ``reduce_from`` all-reduce forward, identity backward: the partial sums
                  of a row-parallel product (and of a vocab-parallel
                  lookup or softmax);
  ``gather_rows`` the whole weight from its row shards, then the rows
                  this rank uses (all-gather forward, the rows' gradient
                  scattered and reduce-scattered back).

Every collective here runs over a *group object* (``parallel.ring``): a
``GroupRing`` over the mesh's tp process group in training, or, in
serving, whatever the engine's mesh gives for its tp axis: a process
group's ring, or a thread rank of a ``ThreadRing`` where the tp ranks are
threads sharing one card (NCCL refuses two ranks on one device).

Only plain tensors reach the kernels: ``local`` is the one place a
parameter leaves its DTensor.
"""

import torch
import torch.distributed as dist


def local(t):
    """This rank's shard of a DTensor (differentiable when grad is on;
    the DTensor's own storage under no_grad); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def tp_of(weight):
    """The tp group object (a ``GroupRing``) a weight is sharded over, or
    None: a DTensor on a mesh whose 'tp' axis has more than one rank and
    splits the weight."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(weight, DTensor):
        return None
    mesh = weight.device_mesh
    names = mesh.mesh_dim_names or ()
    if "tp" not in names:
        return None
    i = names.index("tp")
    if mesh.size(i) == 1 or not isinstance(weight.placements[i], Shard):
        return None
    from .ring import GroupRing
    return GroupRing(mesh.get_group("tp"))


def _all_reduce(t, tp, op=dist.ReduceOp.SUM):
    return tp.all_reduce(t, op)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, tp):
    return _CopyTo.apply(x, tp)


def reduce_from(x, tp):
    return _ReduceFrom.apply(x, tp)


def all_reduce_max(x, tp):
    """The elementwise max over the tp ranks (no gradient)."""
    return _all_reduce(x.detach(), tp, dist.ReduceOp.MAX)


def _all_gather_rows(w, tp):
    return tp.all_gather(w.contiguous(), 0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, tp, rows):
        full = _all_gather_rows(w, tp)
        ctx.args = tp, rows, full.shape
        return full[rows]

    @staticmethod
    def backward(ctx, g):
        tp, rows, shape = ctx.args
        g_full = g.new_zeros(shape)
        g_full[rows] = g
        return tp.reduce_scatter(g_full.contiguous(), 0), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, tp):
        ctx.args = tp, w.shape[0]
        return _all_gather_rows(w, tp)

    @staticmethod
    def backward(ctx, g):
        tp, n = ctx.args
        return g[tp.rank * n:(tp.rank + 1) * n], None


def gather_rows(w, tp, rows):
    """Rows ``rows`` (an index tensor) of the whole weight whose row shard
    ``w`` this rank holds. The backward sums every rank's gradient of the
    rows it took, then keeps this rank's shard: the rows each rank takes
    may differ (a fused qkv's heads)."""
    return _GatherRows.apply(w, tp, rows)


def gather_replicated(w, tp):
    """The whole weight from its row shards, for a computation that every
    tp rank repeats identically (its gradient is then the same on every
    rank, and this rank keeps its shard of it)."""
    return _GatherReplicated.apply(w, tp)
