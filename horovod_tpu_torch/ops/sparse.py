"""Sparse gradients: a values + indices allgather instead of a dense sum.

The port of ``horovod_tpu/ops/sparse.py``. The reference allreduces a
``tf.IndexedSlices`` by allgathering its values and its indices across
workers instead of summing a dense tensor
(horovod/tensorflow/__init__.py:62-73), and offers ``sparse_as_dense``
to densify first (horovod/_keras/__init__.py:20-46). Embedding-style
updates touch few rows, which is where the gather wins:

  * ``sparse_allreduce(slices)`` — allgather(values) / n and
    allgather(indices) through the eager core: every worker ends up
    with the union of all workers' rows, the reference's semantics;
  * ``to_dense`` / ``from_dense`` — the conversions; ``sparse_as_dense``
    in ``optim.allreduce_gradients`` and ``DistributedOptimizer``
    densifies before the dense allreduce.

The torch idiom of the same leaf is a sparse COO gradient
(``nn.Embedding(sparse=True)``): ``from_coo`` and ``to_coo`` convert
between the two.

Every tensor a rank submits to the eager core is its own contribution
(the JAX package's ``kind="replicated"``), and an allgather takes
unequal first dims (Allgatherv), so ranks may contribute unequal nnz.
Over a mesh axis or a process group (a ``DistributedOptimizer``'s dp
group under tp/sp), or over ranks that are threads, which the eager core
does not span, the gathers run on that axis's group object instead:
each rank's nnz first, then values and indices padded to the largest.
"""

import torch


class IndexedSlices:
    """A sparse slab of a larger tensor: ``values[i]`` is the slice of the
    dense tensor at first-dim index ``indices[i]`` (tf.IndexedSlices'
    contract)."""

    def __init__(self, values, indices, dense_shape):
        self.values = values
        self.indices = indices
        self.dense_shape = tuple(dense_shape)

    def __repr__(self):
        return (f"IndexedSlices(values={tuple(self.values.shape)}, "
                f"indices={tuple(self.indices.shape)}, "
                f"dense_shape={self.dense_shape})")


def is_indexed_slices(x):
    return isinstance(x, IndexedSlices)


def is_sparse_coo(x):
    return isinstance(x, torch.Tensor) and x.layout == torch.sparse_coo


def to_dense(slices):
    """Scatter-add the values into a dense tensor of ``dense_shape``;
    duplicate indices accumulate, as tf.convert_to_tensor(IndexedSlices)
    does."""
    dense = torch.zeros(slices.dense_shape, dtype=slices.values.dtype,
                        device=slices.values.device)
    return dense.index_add_(0, slices.indices.to(torch.int64),
                            slices.values)


def from_dense(dense, indices):
    """The rows of ``dense`` at ``indices`` as an IndexedSlices."""
    indices = torch.as_tensor(indices, device=dense.device)
    return IndexedSlices(dense[indices], indices, dense.shape)


def from_coo(grad):
    """A sparse COO tensor sparse in its first dim (``nn.Embedding(
    sparse=True)``'s gradient) as IndexedSlices; duplicates are kept."""
    if grad.sparse_dim() != 1:
        raise ValueError(f"a sparse gradient must be sparse in its first "
                         f"dim only, got sparse_dim {grad.sparse_dim()}")
    return IndexedSlices(grad._values(), grad._indices()[0], grad.shape)


def to_coo(slices):
    """IndexedSlices as an uncoalesced sparse COO tensor."""
    return torch.sparse_coo_tensor(slices.indices.to(torch.int64)[None],
                                   slices.values, slices.dense_shape,
                                   check_invariants=False)


def sparse_allreduce(slices, average=True, axis_name=None, name=None,
                     compression=None):
    """Allreduce an IndexedSlices by allgathering its values and indices
    (``allgather(values) / size`` + ``allgather(indices)``) over every
    worker, or over the ranks of ``axis_name`` (a mesh axis or a group).
    Returns an IndexedSlices whose entries are the union of every
    worker's; ``to_dense`` of it equals the dense allreduce of the
    per-worker densified gradients. Over every worker both gathers are
    one submission to the eager core, so the negotiated coordinator
    orders them in one response."""
    from .. import mpi_ops
    values, ctx = slices.values, None
    if compression is not None:
        values, ctx = compression.compress(values)
    if mpi_ops._core(axis_name) is None:
        values, indices, divisor = _axis_gather(values, slices.indices,
                                                axis_name)
    else:
        names = ([f"{name}.values", f"{name}.indices"] if name is not None
                 else [mpi_ops._auto_name("allgather", None)
                       for _ in "vi"])
        hv, hi = mpi_ops.grouped_allgather_async([values, slices.indices],
                                                 names)
        try:
            values = mpi_ops.synchronize(hv)
        except Exception:
            _drain_handles(mpi_ops, [hi])
            raise
        indices = mpi_ops.synchronize(hi)
        divisor = mpi_ops.process_count()
    # decompress before dividing, so that the average is taken in the
    # restored dtype; the divisor is the number of ranks reduced over, the
    # same on every worker whatever nnz each contributed
    if ctx is not None:
        values = compression.decompress(values, ctx)
    if average:
        values = values / divisor
    return IndexedSlices(values, indices, slices.dense_shape)


def _axis_gather(values, indices, axis_name):
    """Every rank's ``values`` and ``indices`` over the ranks of
    ``axis_name`` (None: every worker, here ranks that are threads), in
    rank order, and the number of those ranks: the nnz gathered first,
    then both padded to the largest and gathered through the axis's group
    object, the padding dropped."""
    from . import collective_ops as cops
    comm = cops.comm_of(cops.resolve_axis(axis_name))
    n = indices.shape[0]
    counts = comm.all_gather(torch.tensor([n], device=values.device),
                             0).tolist()
    top = max(counts)

    def gathered(t):
        pad = t.new_zeros((top - n,) + tuple(t.shape[1:]))
        return comm.all_gather(torch.cat([t, pad]), 0)
    keep = torch.cat([torch.arange(r * top, r * top + c)
                      for r, c in enumerate(counts)]).to(values.device)
    return gathered(values)[keep], gathered(indices)[keep], comm.size


def _drain_handles(mpi_ops, handles):
    """Synchronize in-flight handles on an error path, so that their
    entries are released."""
    for h in handles:
        try:
            mpi_ops.synchronize(h)
        except Exception:  # noqa: BLE001 — already propagating an error
            pass


def grouped_sparse_allreduce(slices_list, average=True, name=None,
                             axis_name=None):
    """Sparse allreduce of several IndexedSlices with every allgather in
    flight at once: the values and indices gathers of all of them are ONE
    submission to the eager core, so they drain in one cycle and the
    negotiated coordinator fuses the same-dtype gathers into single
    allgatherv collectives (2 for the whole group when the values are
    float and the indices int — Response::add_allgather_response,
    message.h:172). Gathers are named ``{name}.{i}.values`` and
    ``{name}.{i}.indices``. Over ``axis_name`` (a mesh axis or a group)
    each is gathered in turn on that axis's group object."""
    from .. import mpi_ops
    if mpi_ops._core(axis_name) is None:
        return [sparse_allreduce(s, average, axis_name)
                for s in slices_list]
    prefix = name or "grouped_sparse"
    tensors, names = [], []
    for i, s in enumerate(slices_list):
        tensors += [s.values, s.indices]
        names += [f"{prefix}.{i}.values", f"{prefix}.{i}.indices"]
    flat = mpi_ops.grouped_allgather_async(tensors, names)
    try:
        divisor = mpi_ops.process_count()
        out = []
        for i, s in enumerate(slices_list):
            values = mpi_ops.synchronize(flat[2 * i])
            indices = mpi_ops.synchronize(flat[2 * i + 1])
            flat[2 * i] = flat[2 * i + 1] = None
            if average:
                values = values / divisor
            out.append(IndexedSlices(values, indices, s.dense_shape))
        return out
    except Exception:
        _drain_handles(mpi_ops, [h for h in flat if h is not None])
        raise
