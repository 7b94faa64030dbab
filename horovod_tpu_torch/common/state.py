"""Global per-process state of the port.

The counterpart of ``horovod_tpu/common/state.py``. Under PyTorch one
process drives one card, as in the reference (one MPI rank per GPU), so
the worker identity and the process identity are the same:
``rank() == process_rank()`` and ``size() == process_count()``. The
collectives run over a ``torch.distributed`` process group: NCCL for
CUDA tensors, gloo for CPU tensors.

The state also holds the worker mesh (``mesh()``): by default the 1-D
mesh of every rank on the axis ``HVD_AXIS``, the counterpart of the JAX
package's device mesh; the parallel layouts (dp/pp/tp/sp/ep) live in
``parallel.mesh``.
"""

import os
import threading

from .exceptions import NotInitializedError

# The default mesh axis name used for Horovod-style data parallelism.
HVD_AXIS = "hvd"


class HorovodState:
    def __init__(self):
        self.initialized = False
        self.size = 1
        self.rank = 0
        self.local_rank = 0
        self.local_size = 1
        self.backend = None
        self.device = None
        self.config = None
        # True when init() created the process group, so shutdown() may
        # destroy it; a group the caller set up outlives shutdown()
        self.owns_group = False
        self.mesh = None
        # the eager coordination core (ops/eager.py), from init to
        # shutdown
        self.coordinator = None
        self.lock = threading.RLock()


_state = HorovodState()


def global_state():
    return _state


def _check_initialized():
    if not _state.initialized:
        raise NotInitializedError()


def init_state(devices=None, mesh=None, axis_name=HVD_AXIS, config=None):
    """Populate the global state's mesh and config and mark it initialized
    (``mpi_ops.init`` calls it once the process group is up). ``mesh``
    defaults to the 1-D mesh of ``devices`` (every rank) on ``axis_name``.
    A second call is a no-op."""
    from ..parallel.mesh import Mesh
    from .config import HorovodConfig
    with _state.lock:
        if _state.initialized:
            return _state
        if mesh is None:
            if devices is None:
                devices = range(_state.size)
            mesh = Mesh(list(devices), (axis_name,),
                        _state.device.type if _state.device else None)
        _state.mesh = mesh
        _state.config = config or HorovodConfig.from_env()
        _state.initialized = True
        return _state


def shutdown_state():
    with _state.lock:
        _state.initialized = False
        _state.mesh = None


def mesh():
    """The worker mesh (see the module docstring)."""
    _check_initialized()
    return _state.mesh


def hvd_axis_name():
    """Name of the data-parallel (worker) axis of the current mesh: its
    first axis ('dp' for a mesh from ``parallel.mesh``, ``HVD_AXIS`` for
    the default one)."""
    _check_initialized()
    return _state.mesh.axis_names[0]


def size():
    """Number of workers (processes, one card each)."""
    _check_initialized()
    return _state.size


def rank():
    """This worker's rank."""
    _check_initialized()
    return _state.rank


def local_size():
    """Workers on this host."""
    _check_initialized()
    return _state.local_size


def local_rank():
    """This worker's rank within its host: the card it drives."""
    _check_initialized()
    return _state.local_rank


def process_rank():
    _check_initialized()
    return _state.rank


def process_count():
    _check_initialized()
    return _state.size


def process_local_rank():
    """This process's rank within its host. One process drives one card,
    so it is ``local_rank()``, which ``init`` resolved from the
    launcher's environment."""
    return local_rank()


def process_local_size():
    """Processes on this host: ``local_size()``."""
    return local_size()


def backend():
    """'nccl' or 'gloo'."""
    _check_initialized()
    return _state.backend


def device():
    """The device this worker's tensors and collectives live on."""
    _check_initialized()
    return _state.device


def is_initialized():
    return _state.initialized


def env_first(names, default):
    """The first of the environment variables ``names`` that is set, as an
    int; ``default`` when none is."""
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return default
