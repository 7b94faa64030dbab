"""Public collective API: init/rank/size + allreduce/allgather/broadcast.

The port of ``horovod_tpu/mpi_ops.py`` with the torch-facing surface of
``horovod_tpu/torch/mpi_ops.py`` (reference horovod/torch/mpi_ops.py):
handle-based async collectives on torch tensors, ``poll`` and
``synchronize``, and in-place (``_``-suffixed) variants that write the
result back into the submitted tensor at ``synchronize``.

The wire is a ``torch.distributed`` process group, one process per card:
NCCL when the worker runs on CUDA, gloo on the CPU. An async op launches
its collective at once (``async_op=True``) on a private copy of the input,
so the caller may reuse the tensor while it is in flight; ``synchronize``
waits for it, restores the dtype a compressor changed, and divides by the
world size for an average.
"""

import atexit
import dataclasses
import itertools
from typing import Callable

import torch
import torch.distributed as dist

from .common import state as state_mod
from .common.config import HorovodConfig
from .common.device import resolve_device
from .common.exceptions import DuplicateNameError, NotInitializedError
from .ops import fusion
from .ops.compression import Compression

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
    the rank and the world size (one host).

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
        st.config = HorovodConfig.from_env()
        st.owns_group = owns
        st.initialized = True
    atexit.register(shutdown)


def shutdown():
    """Shut down (reference horovod_shutdown). Collectives still in flight
    are dropped; the process group goes if ``init`` created it. Safe to
    call twice."""
    st = state_mod.global_state()
    with st.lock:
        if not st.initialized:
            return
        _pending.clear()
        if st.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        st.initialized = False
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
_handle_ids = itertools.count(1)
_name_ids = itertools.count()


def _claim(name, op):
    """The name of a collective about to start: ``name``, or a generated
    one; raises if another collective in flight holds it."""
    name = name if name is not None else f"{op}.noname.{next(_name_ids)}"
    if any(p.name == name for p in _pending.values()):
        raise DuplicateNameError(name)
    return name


def _submit(work, finish, name):
    handle = next(_handle_ids)
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
    del _pending[handle]
    return entry.finish()


def _entry(handle):
    if handle not in _pending:
        raise ValueError(
            f"handle {handle} was not created by this API or has already "
            f"been synchronized")
    return _pending[handle]


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


def _reduced(buf, ctx, compression, average, like):
    """The result of a summed wire buffer: the caller's dtype and device,
    divided by the world size for an average."""
    out = compression.decompress(buf, ctx)
    if average:
        if out.is_floating_point():
            out = out / size()
        else:
            out = torch.div(out, size(), rounding_mode="floor")
    return out.to(like.device)


# ---------------------------------------------------------------------------
# allreduce

def _allreduce_async(tensor, average, name, compression, target):
    _check_tensor(tensor)
    name = _claim(name, "allreduce")
    wire, ctx = compression.compress(tensor.detach())
    buf = _wire(wire)
    work = dist.all_reduce(buf, async_op=True)
    return _submit(work, lambda: _write_back(target, _reduced(
        buf, ctx, compression, average, tensor)), name)


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
    return synchronize(allreduce_async(tensor, average, name, compression))


def allreduce_(tensor, average=True, name=None, compression=Compression.none):
    return synchronize(allreduce_async_(tensor, average, name, compression))


def _grouped_allreduce_async(tensors, average, compression,
                             fusion_threshold):
    """Start one allreduce per fusion bucket of ``tensors`` (each bucket
    fused into one flat buffer of the wire dtype); returns ``[(bucket,
    handle)]``, where ``synchronize(handle)`` gives the bucket's reduced
    tensors in order, each in its own dtype."""
    for t in tensors:
        _check_tensor(t)
    packed = [compression.compress(t.detach()) for t in tensors]
    wires = [w for w, _ in packed]
    started = []
    for b in fusion.plan_buckets(wires, fusion_threshold):
        name = _claim(None, "grouped_allreduce")
        buf = fusion.fuse(wires, b).to(_device())
        work = dist.all_reduce(buf, async_op=True)

        def finish(b=b, buf=buf):
            return [_reduced(part, packed[i][1], compression, average,
                             tensors[i])
                    for part, i in zip(fusion.unfuse(buf, wires, b),
                                       b.indices)]
        started.append((b, _submit(work, finish, name)))
    return started


def grouped_allreduce(tensors, average=True, compression=Compression.none,
                      fusion_threshold=None):
    """Allreduce many tensors at once, fused into buckets of at most
    ``fusion_threshold`` bytes (``HOROVOD_FUSION_THRESHOLD`` by default),
    one collective per bucket. Returns the reduced tensors in order."""
    tensors = list(tensors)
    if fusion_threshold is None:
        fusion_threshold = state_mod.global_state().config.fusion_threshold
    out = [None] * len(tensors)
    for b, h in _grouped_allreduce_async(tensors, average, compression,
                                         fusion_threshold):
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


# ---------------------------------------------------------------------------
# broadcast

def _check_root(root_rank):
    if not 0 <= root_rank < size():
        raise ValueError(f"Invalid root_rank {root_rank} for broadcast: "
                         f"must be in [0, {size()}).")


def _broadcast_async(tensor, root_rank, name, target):
    _check_tensor(tensor)
    _check_root(root_rank)
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


def broadcast_object(obj, root_rank=0):
    """Broadcast a picklable object from root_rank (identity on one
    worker)."""
    _check_root(root_rank)
    if size() == 1:
        return obj
    box = [obj if rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]
