"""Priority-ordered collective-backend dispatch, port of
``horovod_tpu/ops/operation_manager.py`` (reference
operation_manager.cc:32-80: the first backend whose ``Enabled()`` holds
executes). The list, first enabled wins:

  1. ``hierarchical`` — the two-level allreduce
     (``parallel/hierarchical.py``). Enabled by
     ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` when both hierarchy axes are
     bound and the reduction spans both, or when the axis is a (fast,
     slow) pair of group objects, the eager core's own.
  2. ``ring`` — the explicit ring (``parallel/ring_collectives.py``).
     Enabled by ``HOROVOD_RING_ALLREDUCE=1`` over exactly one axis (a
     bound axis name, or a group).
  3. ``nccl`` — the process group's own ``all_reduce`` (NCCL on the card,
     gloo on the CPU): the port's name for the JAX package's ``xla``
     entry. Always enabled.

Selection is per call (``ops.collective_ops`` says what is bound), and
``selected`` counts the backends chosen. ``start`` is how the fused
buckets of ``mpi_ops`` and ``DistributedOptimizer`` reduce: only the
process group's own all-reduce is asynchronous; the others run to their
end before ``start`` returns.
"""

import collections
import threading

import torch.distributed as dist

from . import collective_ops as cops

HIER_FAST_AXIS = cops.HIER_FAST_AXIS
HIER_SLOW_AXIS = cops.HIER_SLOW_AXIS


class _Done:
    """The work object of a collective that ran to its end."""

    def wait(self):
        return True

    def is_completed(self):
        return True


class CollectiveBackend:
    """One entry in the priority list."""

    name = "base"

    def enabled(self, axis, bound_axes, config):
        raise NotImplementedError

    def allreduce(self, tensor, axis, average=False):
        """The sum (mean) of ``tensor`` over ``axis``, a new tensor."""
        raise NotImplementedError

    def asynchronous(self, axis):
        """Whether ``start`` returns before the reduction is done."""
        return False

    def start(self, buf, axis):
        """Sum ``buf`` over ``axis`` in place; returns a work object."""
        buf.copy_(self.allreduce(buf, axis))
        return _Done()


class HierarchicalBackend(CollectiveBackend):
    name = "hierarchical"

    def enabled(self, axis, bound_axes, config):
        if config is None or not config.hierarchical_allreduce:
            return False
        if _group_pair(axis):
            return True
        if HIER_FAST_AXIS not in bound_axes or \
                HIER_SLOW_AXIS not in bound_axes:
            return False
        # only reductions spanning the whole hierarchy; one over a single
        # axis keeps its exact semantics
        return (isinstance(axis, (tuple, list)) and
                set(axis) == {HIER_FAST_AXIS, HIER_SLOW_AXIS})

    def allreduce(self, tensor, axis, average=False):
        from ..parallel import hierarchical
        fast, slow = axis if _group_pair(axis) else (HIER_FAST_AXIS,
                                                     HIER_SLOW_AXIS)
        return hierarchical.hierarchical_allreduce(
            tensor, fast_axis=fast, slow_axis=slow, average=average)


def _group_pair(axis):
    """Whether ``axis`` is a (fast, slow) pair of group objects: the
    eager core's own two-level groups
    (``process_collectives.HierarchicalProcessEngine``)."""
    return (isinstance(axis, tuple) and len(axis) == 2
            and all(cops.is_group(a) for a in axis))


class RingBackend(CollectiveBackend):
    name = "ring"

    def enabled(self, axis, bound_axes, config):
        if config is None or not config.ring_allreduce:
            return False
        # the explicit ring runs over exactly one axis
        return (isinstance(axis, str) and axis in bound_axes) or \
            cops.is_group(axis)

    def allreduce(self, tensor, axis, average=False):
        from ..parallel import ring_collectives
        return ring_collectives.ring_all_reduce(tensor, axis,
                                                average=average)


class NcclBackend(CollectiveBackend):
    name = "nccl"

    def enabled(self, axis, bound_axes, config):
        return True

    def allreduce(self, tensor, axis, average=False):
        comm = cops.comm_of(axis)
        out = comm.all_reduce(tensor)
        return out / comm.size if average else out

    def asynchronous(self, axis):
        from ..parallel.ring import GroupRing
        return isinstance(cops.comm_of(axis), GroupRing)

    def start(self, buf, axis):
        comm = cops.comm_of(axis)
        if self.asynchronous(axis):
            return dist.all_reduce(buf, group=comm.group, async_op=True)
        return super().start(buf, axis)


class OperationManager:
    """First-enabled-wins dispatch; ``selected`` counts each backend
    chosen by ``select``."""

    def __init__(self, backends=None):
        self.backends = backends or [HierarchicalBackend(), RingBackend(),
                                     NcclBackend()]
        self.selected = collections.Counter()
        self._lock = threading.Lock()

    def _select(self, axis, bound_axes, config):
        for b in self.backends:
            if b.enabled(axis, bound_axes, config):
                return b
        raise RuntimeError("No collective backend enabled")  # unreachable

    def select(self, axis, count=True):
        """The backend a reduction over ``axis`` takes now."""
        backend = self._select(axis, cops.bound_axes(), cops._config())
        if count:
            with self._lock:
                self.selected[backend.name] += 1
        return backend

    def allreduce(self, tensor, axis, average=False):
        return self.select(axis).allreduce(tensor, axis, average=average)


_manager = OperationManager()


def get_operation_manager():
    return _manager
