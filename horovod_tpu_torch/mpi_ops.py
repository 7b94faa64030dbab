"""Public collective API: init/rank/size + allreduce/allgather/broadcast.

The port of ``horovod_tpu/mpi_ops.py`` with the torch-facing surface of
``horovod_tpu/torch/mpi_ops.py`` (reference horovod/torch/mpi_ops.py):
handle-based async collectives on torch tensors, ``poll`` and
``synchronize``, and in-place (``_``-suffixed) variants that write the
result back into the submitted tensor at ``synchronize``.

The wire is a ``torch.distributed`` process group, one process per card:
NCCL when the worker runs on CUDA, gloo on the CPU.

A collective over every worker goes through the eager coordination core
(``ops/eager.py``), as the JAX package's eager API does: ``init`` starts
it on every rank with a process group of its own, and ``allreduce``,
``grouped_allreduce``, ``allgather``, ``broadcast``, ``reducescatter``,
``alltoall`` and ``broadcast_object`` enqueue there; its background
thread negotiates the order with rank 0 (when a control address and key
are set), fuses, and runs the collectives; ``poll`` and ``synchronize``
read the handle, and ``synchronize`` restores the dtype a compressor
changed and writes the in-place variants' result back.

A collective over one axis of a mesh (``axis_name``: an axis of
``parallel.mesh.global_mesh()``, a process group or a group object), and
any collective of ranks that are threads of one process
(``parallel.mesh.use_mesh`` of a ``ThreadMesh``), keeps the direct route:
allreduces through the operation manager (``ops/operation_manager.py``;
the process group's own all-reduce unless
``HOROVOD_HIERARCHICAL_ALLREDUCE`` or ``HOROVOD_RING_ALLREDUCE`` selects
the two-level or the explicit ring allreduce), launched at once on a
private copy of the input. ``DistributedOptimizer`` reduces on this
route too.
"""

import atexit
import dataclasses
import itertools
import threading
import time
from typing import Callable

import torch
import torch.distributed as dist

from .common import state as state_mod
from .common.config import HorovodConfig
from .common.device import resolve_device
from .common.exceptions import DuplicateNameError, NotInitializedError
from .ops import collective_ops as cops
from .ops import eager as eager_mod
from .ops import fusion
from .ops import operation_manager as om
from .ops.compression import Compression
from .ops.eager import EagerCoordinator

# re-exported identity API (reference common/basics.py)
size = state_mod.size
rank = state_mod.rank
local_size = state_mod.local_size
local_rank = state_mod.local_rank
process_rank = state_mod.process_rank
process_count = state_mod.process_count
is_initialized = state_mod.is_initialized

# launcher environments, first match wins: hvdrun, torchrun, Open MPI, Slurm
_RANK_ENV = ("HVD_PROCESS_ID", "RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK",
             "SLURM_PROCID")
_SIZE_ENV = ("HVD_NUM_PROC", "WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE",
             "SLURM_STEP_NUM_TASKS")
_LOCAL_RANK_ENV = ("HVD_LOCAL_RANK", "LOCAL_RANK",
                   "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID")
_LOCAL_SIZE_ENV = ("HVD_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                   "OMPI_COMM_WORLD_LOCAL_SIZE")


def _env_init_method():
    """The rendezvous the launcher exported, as an init_method URL."""
    import os
    if "HVD_COORDINATOR_ADDR" in os.environ:
        return f"tcp://{os.environ['HVD_COORDINATOR_ADDR']}"
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        return "env://"
    return None


def init(device=None, rank=None, size=None, init_method=None):
    """Initialize the port (reference hvd.init()).

    device       where this worker runs: CUDA (the default; raises without
                 a card) or "cpu". CUDA workers join an NCCL group and
                 drive card ``local_rank``; CPU workers join a gloo group.
    rank, size   this worker's rank and the world size; by default read
                 from the launcher's environment (hvdrun, torchrun, Open
                 MPI, Slurm), else a one-process group, as the JAX
                 package's init works single-process.
    init_method  the rendezvous URL for ``torch.distributed``, e.g.
                 ``tcp://localhost:29500``; by default the launcher's
                 (``HVD_COORDINATOR_ADDR``, or torchrun's MASTER_ADDR and
                 MASTER_PORT). A one-process group needs none.

    The rank within the host (the card a CUDA worker drives) and the
    workers per host come from the launcher's environment, or default to
    the rank and the world size (one host). When more workers share a
    host than it has cards, they share cards, and join gloo (over CUDA
    tensors) instead of NCCL, which refuses two ranks on one device.

    A process group the caller already set up is adopted as it is, and
    outlives ``shutdown()``. Calling ``init`` again is a no-op.
    """
    st = state_mod.global_state()
    with st.lock:
        if st.initialized:
            return
        dev = resolve_device(device)
        owns = not dist.is_initialized()
        if owns:
            size = state_mod.env_first(_SIZE_ENV, 1) if size is None else size
            rank = state_mod.env_first(_RANK_ENV, 0) if rank is None else rank
        else:
            size, rank = dist.get_world_size(), dist.get_rank()
        local_rank = state_mod.env_first(_LOCAL_RANK_ENV, rank)
        local_size = state_mod.env_first(_LOCAL_SIZE_ENV, size)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and local_size > torch.cuda.device_count():
            # NCCL refuses two ranks on one device: ranks that share a
            # card join gloo, whose collectives take CUDA tensors too
            backend = "gloo"
            if owns:
                import sys
                print(f"horovod_tpu_torch: {local_size} ranks share "
                      f"{torch.cuda.device_count()} card(s); joining gloo "
                      f"over CUDA tensors (NCCL refuses two ranks on one "
                      f"device)", file=sys.stderr, flush=True)
        if owns:
            init_method = init_method or _env_init_method()
            if init_method is None:
                if size != 1:
                    raise ValueError(
                        f"init: a world of {size} workers needs a "
                        f"rendezvous: pass init_method (tcp://host:port) "
                        f"or launch under hvdrun or torchrun")
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method=init_method,
                                        rank=rank, world_size=size)
        st.size, st.rank = size, rank
        st.local_rank, st.local_size = local_rank, local_size
        st.backend = dist.get_backend()
        st.device = dev
        st.owns_group = owns
        state_mod.init_state(config=HorovodConfig.from_env())
        try:
            st.coordinator = EagerCoordinator(st)
        except BaseException:
            _teardown(st)
            raise
    atexit.register(shutdown)


def shutdown():
    """Shut down (reference horovod_shutdown): the eager core drains what
    the coordinator already ordered and fails every other pending handle
    with ShutdownError; the process group goes if ``init`` created it.
    Safe to call twice."""
    st = state_mod.global_state()
    with st.lock:
        if not st.initialized:
            return
        if st.coordinator is not None:
            coord, st.coordinator = st.coordinator, None
            coord.shutdown()
        _teardown(st)


def _teardown(st):
    _pending.clear()
    if st.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    state_mod.shutdown_state()
    st.owns_group = False


def mpi_threads_supported():
    """Parity shim: there is no MPI; the process group is thread-safe."""
    if not state_mod.is_initialized():
        raise NotInitializedError()
    return True


# ---------------------------------------------------------------------------
# handles

@dataclasses.dataclass
class _Pending:
    """One collective in flight: its work object and how to turn its
    buffers into the result once it has completed."""
    work: object
    finish: Callable
    name: str


_pending = {}
# ranks that are threads of one process (ThreadRing) share the table
_pending_lock = threading.Lock()
_handle_ids = itertools.count(1)
_name_ids = itertools.count()


def _claim(name, op):
    """The name of a collective about to start: ``name``, or a generated
    one; raises if another collective in flight holds it."""
    name = _auto_name(op, name)
    with _pending_lock:
        if any(p.name == name for p in _pending.values()):
            raise DuplicateNameError(name)
    return name


def _submit(work, finish, name):
    handle = next(_handle_ids)
    with _pending_lock:
        _pending[handle] = _Pending(work, finish, name)
    return handle


def poll(handle):
    """True iff the collective behind ``handle`` has completed."""
    return _entry(handle).work.is_completed()


def synchronize(handle):
    """Wait for the collective behind ``handle``; returns its result (the
    submitted tensor itself, updated, for the in-place variants)."""
    entry = _entry(handle)
    entry.work.wait()
    with _pending_lock:
        del _pending[handle]
    return entry.finish()


def _entry(handle):
    with _pending_lock:
        entry = _pending.get(handle)
    if entry is None and not state_mod.is_initialized():
        raise NotInitializedError()
    if entry is None:
        raise ValueError(
            f"handle {handle} was not created by this API or has already "
            f"been synchronized")
    return entry


class _CoreWork:
    """The work object of a collective queued on the eager core."""

    def __init__(self, coord, handle):
        self.coord, self.handle = coord, handle

    def is_completed(self):
        return self.coord.poll(self.handle)

    def wait(self):
        """``synchronize`` waits through the core (``finish``)."""


def _core(axis_name=None):
    """The eager core a collective over ``axis_name`` goes through, or
    None when it keeps the direct route: an axis, or ranks that are
    threads of this process."""
    if axis_name is not None:
        return None
    from .parallel import mesh as mesh_lib
    if isinstance(mesh_lib.global_mesh_if_set(), mesh_lib.ThreadMesh):
        return None
    st = state_mod.global_state()
    if not st.initialized:
        raise NotInitializedError()
    return st.coordinator


def _auto_name(op, name):
    if name is not None:
        return name
    return f"{op}{eager_mod.AUTO_NAME_INFIX}{next(_name_ids)}"


_probe_ids = itertools.count()


def lost_ranks(timeout=None):
    """The control plane's verdict on the other workers, for a caller
    whose collective failed: a one-element allreduce through the eager
    core's negotiation, waited on for at most ``timeout`` seconds
    (default: ``HOROVOD_RANK_LOST_TIMEOUT_SECONDS`` plus the core's
    coordinator-lost grace and 5 s). Returns the ranks the coordinator's
    liveness ledger declared lost (``[0]`` when the coordinator itself
    is unreachable), or ``[]`` when every worker answered or none was
    declared lost in time: they live, whatever failed. Without
    negotiation, or with the ledger off (its timeout 0), only the
    coordinator's loss can be seen."""
    from .common.exceptions import RanksLostError
    coord = _core()
    if coord is None or size() == 1:
        return []
    if timeout is None:
        timeout = (coord._config.rank_lost_timeout_seconds +
                   coord._poison_grace_s + 5.0)
    deadline = time.monotonic() + timeout
    try:
        h = allreduce_async(torch.zeros(1, device=_device()),
                            name=f"hvd.liveness.{next(_probe_ids)}")
        while not poll(h):
            if time.monotonic() > deadline:
                return []
            time.sleep(0.05)
        synchronize(h)
    except RanksLostError as exc:
        return list(exc.ranks)
    return []


def _enqueue(coord, items, finish):
    """Queue ``items`` (name, op, tensor, root_rank, average) on the core
    as one submission; returns a handle per item, whose ``synchronize``
    gives ``finish(i, core_result)``."""
    handles = coord.enqueue_group([it + (None,) for it in items])
    return [_submit(_CoreWork(coord, h),
                    (lambda h=h, i=i: finish(i, coord.synchronize(h))),
                    None)
            for i, h in enumerate(handles)]


def _device():
    return state_mod.device()


def _check_tensor(tensor):
    if not isinstance(tensor, torch.Tensor):
        raise ValueError(f"expected a torch.Tensor, got {type(tensor)}")


def _wire(tensor):
    """A private copy of ``tensor`` on the group's device."""
    return tensor.detach().to(_device(), copy=True).contiguous()


def _write_back(target, result):
    """Copy ``result`` into ``target`` (or return it when there is none)."""
    if target is None:
        return result
    target.data.copy_(result)
    return target


def _reduced(buf, ctx, compression, average, like, n=None):
    """The result of a summed wire buffer: the caller's dtype and device,
    divided by ``n`` (the world size by default) for an average."""
    out = compression.decompress(buf, ctx)
    if average:
        out = _divide(out, size() if n is None else n)
    return out.to(like.device)


def _divide(t, n):
    if t.is_floating_point():
        return t / n
    return torch.div(t, n, rounding_mode="floor")


def process_group(axis_name=None):
    """The process group a collective runs over: None (every worker) for
    ``axis_name=None``, the group of that axis of the global mesh for an
    axis name, or ``axis_name`` itself when it is a process group."""
    if axis_name is None:
        return None
    if isinstance(axis_name, str):
        from .parallel import mesh as mesh_lib
        return mesh_lib.global_mesh().group(axis_name)
    return axis_name


def group_size(group=None):
    """Workers in ``group`` (every worker when None; a group object's
    ranks)."""
    if group is None:
        return size()
    if hasattr(group, "all_reduce"):
        return group.size
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# allreduce

def _route(axis_name):
    """(axis, backend) of an allreduce over ``axis_name`` (every worker
    for None): the axis resolved as ``ops.collective_ops`` resolves it,
    the backend the operation manager selects for it now."""
    axis = cops.resolve_axis(axis_name, prefer_hierarchy=True)
    return axis, om.get_operation_manager().select(axis)


def launches_async(axis_name=None):
    """Whether an allreduce over ``axis_name`` returns before it is done
    (the process group's own all-reduce over a process group); the
    others run on the caller's thread when started."""
    axis = cops.resolve_axis(axis_name, prefer_hierarchy=True)
    return om.get_operation_manager().select(axis, count=False) \
        .asynchronous(axis)


def _allreduce_async(tensor, average, name, compression, target):
    _check_tensor(tensor)
    coord = _core()
    if coord is not None:
        wire, ctx = compression.compress(tensor.detach())
        return _enqueue(
            coord, [(_auto_name("allreduce", name), eager_mod.ALLREDUCE,
                     _wire(wire), 0, average)],
            lambda _, out: _write_back(target, compression.decompress(
                out, ctx).to(tensor.device)))[0]
    name = _claim(name, "allreduce")
    wire, ctx = compression.compress(tensor.detach())
    buf = _wire(wire)
    axis, backend = _route(None)
    work = backend.start(buf, axis)
    return _submit(work, lambda: _write_back(target, _reduced(
        buf, ctx, compression, average, tensor, cops.axis_size(axis))),
        name)


def allreduce_async(tensor, average=True, name=None,
                    compression=Compression.none):
    """Start an allreduce of ``tensor`` across workers; returns a handle."""
    return _allreduce_async(tensor, average, name, compression, None)


def allreduce_async_(tensor, average=True, name=None,
                     compression=Compression.none):
    """In-place async allreduce: ``synchronize`` writes the result into
    ``tensor``."""
    return _allreduce_async(tensor, average, name, compression, tensor)


def allreduce(tensor, average=True, name=None, compression=Compression.none):
    """Allreduce ``tensor`` across workers. An ``IndexedSlices`` (or a
    sparse COO tensor) takes the sparse path instead: its values and
    indices are allgathered (``ops/sparse.py``), and the result has the
    input's form."""
    from .ops import sparse as sparse_mod
    if sparse_mod.is_sparse_coo(tensor):
        return sparse_mod.to_coo(allreduce(sparse_mod.from_coo(tensor),
                                           average, name, compression))
    if sparse_mod.is_indexed_slices(tensor):
        return sparse_mod.sparse_allreduce(tensor, average=average,
                                           name=name,
                                           compression=compression)
    return synchronize(allreduce_async(tensor, average, name, compression))


def allreduce_(tensor, average=True, name=None, compression=Compression.none):
    return synchronize(allreduce_async_(tensor, average, name, compression))


def _grouped_allreduce_async(tensors, average, compression,
                             fusion_threshold, group=None):
    """Start one allreduce per fusion bucket of ``tensors`` (each bucket
    fused into one flat buffer of the wire dtype) over ``group`` (every
    worker when None; an axis name, a process group or a group object),
    each on the backend the operation manager selects; returns
    ``[(bucket, handle)]``, where ``synchronize(handle)`` gives the
    bucket's reduced tensors in order, each in its own dtype."""
    for t in tensors:
        _check_tensor(t)
    packed = [compression.compress(t.detach()) for t in tensors]
    wires = [w for w, _ in packed]
    started = []
    for b in fusion.plan_buckets(wires, fusion_threshold):
        name = _claim(None, "grouped_allreduce")
        buf = fusion.fuse(wires, b).to(_device())
        axis, backend = _route(group)
        n = cops.axis_size(axis)
        work = backend.start(buf, axis)

        def finish(b=b, buf=buf, n=n):
            return [_reduced(part, packed[i][1], compression, average,
                             tensors[i], n)
                    for part, i in zip(fusion.unfuse(buf, wires, b),
                                       b.indices)]
        started.append((b, _submit(work, finish, name)))
    return started


def grouped_allreduce_async(tensors, average=True,
                            compression=Compression.none, name=None):
    """Queue an allreduce of each of ``tensors`` on the eager core as ONE
    submission (one negotiation announcement, one local plan), so that
    they fuse into buckets of at most ``HOROVOD_FUSION_THRESHOLD`` bytes
    as the coordinator plans them; returns a handle per tensor. Names are
    ``{name}.{i}`` when ``name`` is given."""
    tensors = list(tensors)
    for t in tensors:
        _check_tensor(t)
    coord = _core()
    packed = [compression.compress(t.detach()) for t in tensors]
    items = [(f"{name}.{i}" if name is not None
              else _auto_name("grouped_allreduce", None),
              eager_mod.ALLREDUCE, _wire(w), 0, average)
             for i, (w, _) in enumerate(packed)]
    return _enqueue(coord, items, lambda i, out: compression.decompress(
        out, packed[i][1]).to(tensors[i].device))


def grouped_allreduce(tensors, average=True, compression=Compression.none,
                      fusion_threshold=None, axis_name=None):
    """Allreduce many tensors at once, fused into buckets of at most
    ``fusion_threshold`` bytes (``HOROVOD_FUSION_THRESHOLD`` by default),
    one collective per bucket, over every worker or the workers of
    ``axis_name``. Returns the reduced tensors in order. Over every
    worker the eager core plans the buckets with its live threshold (as
    the JAX package's eager grouped allreduce does); ``fusion_threshold``
    applies to an axis's direct route. ``IndexedSlices`` and sparse COO
    leaves take the sparse path (``optim.allreduce_gradients``): their
    integer indices never enter a dense sum."""
    tensors = list(tensors)
    from .ops import sparse as sparse_mod
    if any(sparse_mod.is_indexed_slices(t) or sparse_mod.is_sparse_coo(t)
           for t in tensors):
        from . import optim
        return optim.allreduce_gradients(
            tensors, compression=compression, average=average,
            fusion_threshold=fusion_threshold, axis_name=axis_name)
    if _core(axis_name) is not None:
        return [synchronize(h) for h in grouped_allreduce_async(
            tensors, average, compression)]
    if fusion_threshold is None:
        fusion_threshold = state_mod.global_state().config.fusion_threshold
    out = [None] * len(tensors)
    for b, h in _grouped_allreduce_async(tensors, average, compression,
                                         fusion_threshold, axis_name):
        for i, r in zip(b.indices, synchronize(h)):
            out[i] = r
    return out


# ---------------------------------------------------------------------------
# allgather

def allgather_async(tensor, name=None):
    """Start a gather of every worker's ``tensor`` concatenated along dim 0
    (reference MPI_Allgatherv): first dims may differ between workers,
    the other dims must agree. The first dims are exchanged before the
    call returns."""
    _check_tensor(tensor)
    coord = _core()
    if coord is not None:
        return _enqueue(
            coord, [(_auto_name("allgather", name), eager_mod.ALLGATHER,
                     _wire(tensor), 0, False)],
            lambda _, out: out.to(tensor.device))[0]
    name = _claim(name, "allgather")
    buf = _wire(tensor)
    n = size()
    rows = torch.tensor([buf.shape[0]], dtype=torch.int64, device=_device())
    all_rows = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(all_rows, rows)
    counts = [int(r.item()) for r in all_rows]
    top = max(counts)
    if buf.shape[0] < top:
        pad = buf.new_zeros((top - buf.shape[0],) + tuple(buf.shape[1:]))
        buf = torch.cat([buf, pad])
    outs = [torch.empty_like(buf) for _ in range(n)]
    work = dist.all_gather(outs, buf, async_op=True)
    return _submit(work, lambda: torch.cat(
        [o[:c] for o, c in zip(outs, counts)]).to(tensor.device), name)


def allgather(tensor, name=None):
    return synchronize(allgather_async(tensor, name))


def grouped_allgather_async(tensors, names):
    """Queue an allgather of each of ``tensors`` (first dims may differ
    between workers) on the eager core as ONE submission, so that they
    drain in one cycle and the negotiated coordinator fuses those of one
    dtype into one allgatherv; returns a handle per tensor."""
    for t in tensors:
        _check_tensor(t)
    tensors = list(tensors)
    return _enqueue(_core(), [(n, eager_mod.ALLGATHER, _wire(t), 0, False)
                              for n, t in zip(names, tensors)],
                    lambda i, out: out.to(tensors[i].device))


# ---------------------------------------------------------------------------
# reducescatter / alltoall — the building blocks of hierarchical allreduce
# and sequence parallelism, over every worker or one mesh axis


def _all_gather_into(out, inp, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter_into(out, inp, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def reducescatter(tensor, average=False, axis_name=None, name=None):
    """Sum ``tensor`` across the workers (of ``axis_name`` when given) and
    return this worker's block of the sum along dim 0, which the group
    size must divide: ``lax.psum_scatter(..., tiled=True)`` of the JAX
    package. ``average`` divides by the group size."""
    _check_tensor(tensor)
    coord = _core(axis_name)
    if coord is not None:
        return synchronize(_enqueue(
            coord, [(_auto_name("reducescatter", name),
                     eager_mod.REDUCESCATTER, _wire(tensor), 0, average)],
            lambda _, out: out.to(tensor.device))[0])
    _claim(name, "reducescatter")
    group = process_group(axis_name)
    n = group_size(group)
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 of {tuple(tensor.shape)} "
                         f"does not divide over {n} workers")
    buf = _wire(tensor)
    out = buf.new_empty((buf.shape[0] // n,) + tuple(buf.shape[1:]))
    _reduce_scatter_into(out, buf, group)
    if average:
        out = _divide(out, n)
    return out.to(tensor.device)


def alltoall(tensor, axis_name=None, split_axis=0, concat_axis=0,
             name=None):
    """Split ``tensor`` along ``split_axis`` into one block per worker (of
    ``axis_name`` when given), send block j to worker j, and concatenate
    the blocks received, in worker order, along ``concat_axis``:
    ``lax.all_to_all(..., tiled=True)`` of the JAX package."""
    _check_tensor(tensor)
    if _core(axis_name) is None:
        _claim(name, "alltoall")
    group = process_group(axis_name)
    n = group_size(group)
    if tensor.shape[split_axis] % n:
        raise ValueError(f"alltoall: dim {split_axis} of "
                         f"{tuple(tensor.shape)} does not divide over {n} "
                         f"workers")
    # the blocks to send lead, one per worker, contiguous
    blocks = tensor.detach().to(_device())
    blocks = blocks.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
    blocks = blocks.contiguous()
    coord = _core(axis_name)
    if coord is not None:
        got = synchronize(_enqueue(
            coord, [(_auto_name("alltoall", name), eager_mod.ALLTOALL,
                     blocks, 0, False)], lambda _, out: out)[0])
    else:
        got = torch.empty_like(blocks)
        dist.all_to_all_single(got, blocks, group=group)
    # got[j] is worker j's block: concatenate them along concat_axis
    got = got.movedim(0, concat_axis)
    return got.flatten(concat_axis, concat_axis + 1).to(tensor.device)


# ---------------------------------------------------------------------------
# broadcast

def _check_root(root_rank):
    if not 0 <= root_rank < size():
        raise ValueError(f"Invalid root_rank {root_rank} for broadcast: "
                         f"must be in [0, {size()}).")


def _broadcast_async(tensor, root_rank, name, target):
    _check_tensor(tensor)
    _check_root(root_rank)
    coord = _core()
    if coord is not None:
        return _enqueue(
            coord, [(_auto_name("broadcast", name), eager_mod.BROADCAST,
                     _wire(tensor), root_rank, False)],
            lambda _, out: _write_back(target, out.to(tensor.device)))[0]
    name = _claim(name, "broadcast")
    buf = _wire(tensor)
    work = dist.broadcast(buf, src=root_rank, async_op=True)
    return _submit(work, lambda: _write_back(target, buf.to(tensor.device)),
                   name)


def broadcast_async(tensor, root_rank=0, name=None):
    """Start a broadcast of root_rank's ``tensor``; returns a handle."""
    return _broadcast_async(tensor, root_rank, name, None)


def broadcast_async_(tensor, root_rank=0, name=None):
    """In-place async broadcast into ``tensor``."""
    return _broadcast_async(tensor, root_rank, name, tensor)


def broadcast(tensor, root_rank=0, name=None):
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_(tensor, root_rank=0, name=None):
    return synchronize(broadcast_async_(tensor, root_rank, name))


_bcast_object_ids = itertools.count(1)


def broadcast_object(obj, root_rank=0):
    """Broadcast a picklable object from root_rank (identity on one
    worker): two broadcasts through the eager core, the payload's length
    and then its pickled bytes, as the JAX package's ``broadcast_object``
    (under negotiation every cross-process collective must originate
    from the core's background cycle). The names are matched across
    processes by call order."""
    import pickle
    _check_root(root_rank)
    if size() == 1:
        return obj
    k = next(_bcast_object_ids)
    is_root = rank() == root_rank
    payload = pickle.dumps(obj) if is_root else b""
    length = torch.tensor([len(payload)], dtype=torch.int64,
                          device=_device())
    length = broadcast(length, root_rank,
                       name=f"hvd.broadcast_object.{k}.len")
    buf = torch.zeros(int(length.item()), dtype=torch.uint8,
                      device=_device())
    if is_root:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    buf = broadcast(buf, root_rank, name=f"hvd.broadcast_object.{k}.payload")
    return pickle.loads(buf.cpu().numpy().tobytes())
