"""The eager data plane: cross-process collectives over the eager core's
own process group, and the CUDA completion machinery around them.

The port of ``horovod_tpu/ops/process_collectives.py``. The reference's
data plane is ONE bandwidth-optimal collective executed on the (fused)
buffer — ``MPI_Allreduce`` at mpi_operations.cc:48, ``ncclAllReduce`` at
nccl_operations.cc:85. Here it is the eager core's process group (NCCL
on the card, gloo on the CPU; ``dist.new_group`` over every rank at
``init``, so no other route shares its communicator), one collective per
call:

  * allreduce      → the operation manager's backend over the group (the
                     group's own all-reduce, or the explicit ring under
                     ``HOROVOD_RING_ALLREDUCE``)
  * broadcast      → ``dist.broadcast``
  * allgather      → ``dist.all_gather`` of equally shaped rows (the
                     eager core pads an allgatherv to them)
  * reducescatter  → ``dist.reduce_scatter_single``
  * alltoall       → ``dist.all_to_all_single``
  * quantized allreduce → two phases over the narrow wire
                     (``ops/quantization.py``): all_to_all the encoded
                     payload and scales, dequant the peer rows and sum
                     them in f32 in rank order, requant the owned chunk,
                     all_gather the narrow sum and decode it locally. The
                     payload moves as a ``uint8`` view (gloo, and NCCL by
                     version, do not move ``float8_e4m3fn``); every byte
                     that crosses the wire is int8/fp8 or an f32 scale.

``HierarchicalProcessEngine`` is the two-level allreduce of
``parallel/hierarchical.py`` over the world's hosts, on two-level groups
of the eager core's own, which the eager core takes under
``HOROVOD_HIERARCHICAL_ALLREDUCE``; its quantized leg encodes only the
inter-host hop.

Every process must invoke the same engine call in the same order — the
eager core guarantees that (coordinator-ordered under negotiation,
same-program-order otherwise). Inputs stay on the device end to end.

``StreamSync`` is the CUDA completion machinery the JAX package does not
need (the reference's cuda_operations.cc:128-179): a ready event
recorded on the caller's current stream at enqueue (autograd's stream
for the op inside a gradient hook), the core's collective stream waiting
on it, ``record_stream`` on every input and fusion buffer, and a
completion event recorded after the un-fuse slicing, which the
finalizer thread waits on and ``synchronize`` makes the caller's stream
wait on.
"""

import contextlib

import torch
import torch.distributed as dist

from ..parallel.ring import GroupRing
from . import operation_manager as om
from . import quantization


def _two_phase(q, s, codec, block, group):
    """The two-phase quantized sum over ``group`` of every rank's encoded
    (q [m], s [m // block]), m a multiple of block · group size. Returns
    the narrow sum (payload [m], scales [m // block]), the same on every
    rank. At one rank it is the same arithmetic without the wire."""
    n = dist.get_world_size(group)
    chunk = q.numel() // n
    wire = q.dtype
    qb = q.view(torch.uint8)
    if n > 1:
        qp, sp = torch.empty_like(qb), torch.empty_like(s)
        dist.all_to_all_single(qp, qb, group=group)
        dist.all_to_all_single(sp, s, group=group)
    else:
        qp, sp = qb, s
    # dequant each peer's rows of the owned chunk, sum in f32 in rank
    # order, requant the sum
    dec = quantization._block_decode(qp.view(wire).reshape(n, chunk),
                                     sp.reshape(n, chunk // block), block)
    total = dec[0]
    for row in dec[1:]:
        total = total + row
    q2, s2 = quantization._block_encode(total, block, codec)
    if n == 1:
        return q2, s2
    qg = torch.empty((n, chunk), dtype=torch.uint8, device=q.device)
    sg = torch.empty((n, chunk // block), dtype=s.dtype, device=s.device)
    dist.all_gather(list(qg.unbind(0)), q2.view(torch.uint8), group=group)
    dist.all_gather(list(sg.unbind(0)), s2, group=group)
    return qg.reshape(-1).view(wire), sg.reshape(-1)


class ProcessCollectiveEngine:
    """Collectives over ``group`` (every rank, the eager core's own)."""

    def __init__(self, group):
        self.group = group
        self.nproc = dist.get_world_size(group)

    def allreduce(self, buf):
        """Sum every process's ``buf`` into it, in place, through the
        backend the operation manager selects for the group."""
        backend = om.get_operation_manager().select(self.group)
        backend.start(buf, self.group).wait()
        return buf

    def allreduce_quantized(self, payload, scales, codec, block,
                            average=False):
        """Sum (or mean) across processes of the block-scaled encoded
        buffers, an f32 result of the padded length. ``payload``'s length
        must be a multiple of ``block * nproc``; each process passes its
        own (payload, scales) from ``quantization.encode``."""
        q, s = _two_phase(payload, scales, codec, int(block), self.group)
        out = quantization._block_decode(q, s, int(block))
        return out / self.nproc if average else out

    def broadcast(self, buf, root):
        """Process ``root``'s ``buf`` on every process, in place."""
        dist.broadcast(buf, src=dist.get_global_rank(self.group, root),
                       group=self.group)
        return buf

    def allgather_rows(self, x):
        """``[nproc, *x.shape]``: every process's equally shaped ``x``,
        row p from process p."""
        outs = [torch.empty_like(x) for _ in range(self.nproc)]
        dist.all_gather(outs, x, group=self.group)
        return torch.stack(outs)

    def reducescatter(self, x):
        """This process's 1/nproc block (dim 0) of the elementwise sum."""
        out = x.new_empty((x.shape[0] // self.nproc,) + tuple(x.shape[1:]))
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(out, x, group=self.group)
        return out

    def alltoall(self, x):
        """MPI_Alltoall along dim 0: block i of every process's ``x``
        lands on process i, concatenated in rank order."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out


class HierarchicalProcessEngine(ProcessCollectiveEngine):
    """The two-level allreduce (reduce-scatter within a host, allreduce
    across hosts, all-gather within a host; nccl_operations.cc:162-379)
    of ``parallel/hierarchical.py`` over groups of its own, carved out of
    ``group`` at construction: process p of ``group`` sits on host
    p // local_size at position p % local_size (the launcher's
    contiguous ranks-per-host layout, HVD_LOCAL_SIZE). The ``chips``
    group is this process's host, the ``slices`` group the processes at
    its position on every host. No other route issues on them, so the
    eager core's background thread never shares a communicator with the
    optimizer's hooks or the mesh collectives. ``dist.new_group`` is
    collective: construct on every rank at the same point."""

    def __init__(self, group, local_size):
        super().__init__(group)
        local_size = int(local_size)
        if local_size < 1 or self.nproc % local_size:
            raise ValueError(
                f"hierarchical local_size {local_size} must divide the "
                f"process count {self.nproc}")
        ranks = dist.get_process_group_ranks(group)
        me = dist.get_rank(group)
        for h in range(self.nproc // local_size):
            pg = dist.new_group(ranks[h * local_size:(h + 1) * local_size])
            if me // local_size == h:
                chips = GroupRing(pg)
        for pos in range(local_size):
            pg = dist.new_group(ranks[pos::local_size])
            if me % local_size == pos:
                slices = GroupRing(pg)
        #: the (fast, slow) pair the operation manager's hierarchical
        #: backend runs over
        self.axes = (chips, slices)

    def allreduce(self, buf):
        backend = om.get_operation_manager().select(self.axes)
        backend.start(buf, self.axes).wait()
        return buf

    def allreduce_quantized(self, fused, codec, block, average=False,
                            residual=None):
        """Two-level allreduce of a flat buffer with the quantized codec
        on the inter-host leg only: a full-width reduce-scatter within
        the host, the error-feedback-compensated encode of this
        process's shard, the two-phase schedule over the hosts, and a
        full-width all_gather within the host. ``residual`` is this
        process's carried EF residual for its shard (or None). Returns
        (f32 result of the padded length, compensated shard, own-wire
        decode of the shard)."""
        chips, slices = self.axes
        block = int(block)
        m = quantization.pad_to(fused.numel(), block * self.nproc)
        x = fused.to(torch.float32)
        if m != x.numel():
            x = torch.nn.functional.pad(x, (0, m - x.numel()))
        shard_len = m // chips.size
        if residual is None or tuple(residual.shape) != (shard_len,):
            residual = torch.zeros(shard_len, dtype=torch.float32,
                                   device=x.device)
        shard = chips.reduce_scatter(x, 0)
        comp = shard + residual
        q, s = quantization._block_encode(comp, block, codec)
        q2, s2 = _two_phase(q, s, codec, block, slices.group)
        red = quantization._block_decode(q2, s2, block)
        full = chips.all_gather(red, 0)
        if average:
            full = full / self.nproc
        return full, comp, quantization._block_decode(q, s, block)


class StreamSync:
    """The CUDA completion machinery of the eager data plane on
    ``device`` (see the module docstring); every method is a no-op for a
    CPU device, where a collective has completed when it returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def ready_event(self, tensor):
        """An event on the caller's current stream, recorded now: the
        point after which ``tensor`` holds the submitted values."""
        if not (self.cuda and tensor.is_cuda):
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(tensor.device))
        return ev

    @contextlib.contextmanager
    def collective_stream(self, ready_events):
        """Run the body on the collective stream, after it has waited on
        every entry's ready event."""
        if not self.cuda:
            yield
            return
        for ev in ready_events:
            if ev is not None:
                self.stream.wait_event(ev)
        with torch.cuda.stream(self.stream):
            yield

    def keep_alive(self, tensors):
        """Mark ``tensors`` in use by the collective stream, so the
        caching allocator cannot hand their memory out again until the
        stream's work queued so far has run."""
        if self.cuda:
            for t in tensors:
                if t.is_cuda:
                    t.record_stream(self.stream)

    def completion_event(self):
        """An event recorded on the collective stream after the work
        queued so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    @staticmethod
    def hand_over(done_event, tensors):
        """At ``synchronize``: the caller's current stream waits on the
        collective's completion event, and the results are marked in use
        by that stream."""
        if done_event is None:
            return
        stream = torch.cuda.current_stream()
        stream.wait_event(done_event)
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
