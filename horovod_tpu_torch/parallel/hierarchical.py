"""Two-level (hierarchical) allreduce, port of
``horovod_tpu/parallel/hierarchical.py``.

The reference's NCCLHierarchicalAllreduce (nccl_operations.cc:162-379):
an intra-node reduce-scatter, a cross-node allreduce of the scattered
piece, an intra-node all-gather, with the tensor padded to a multiple of
the ranks per node (:210-216). Here the axes are those of a
``("slices", "chips")`` mesh (``parallel.mesh.build_hierarchical_mesh``):
``chips`` the fast axis within a host (NVLink), ``slices`` the slow one
across hosts, each a group object of ``parallel.ring`` (a process
group's, or a thread rank's on one card). The slow axis moves only
1/chips of the data per rank.
"""

import torch.nn.functional as F

from ..ops.collective_ops import comm_of


def hierarchical_allreduce(tensor, fast_axis="chips", slow_axis="slices",
                           average=False):
    """reduce_scatter(fast) → all_reduce(slow) → all_gather(fast) of any
    tensor, through a flattened view padded to a multiple of the fast
    axis's size."""
    fast, slow = comm_of(fast_axis), comm_of(slow_axis)
    flat = tensor.reshape(-1)
    n = flat.numel()
    padded = -(-n // fast.size) * fast.size
    if padded != n:
        flat = F.pad(flat, (0, padded - n))
    # each rank owns 1/fast of its slice's sum
    shard = fast.reduce_scatter(flat, 0)
    # the small shard across the slices
    shard = slow.all_reduce(shard)
    full = fast.all_gather(shard, 0)[:n]
    out = full.reshape(tensor.shape)
    if average:
        out = out / (fast.size * slow.size)
    return out
