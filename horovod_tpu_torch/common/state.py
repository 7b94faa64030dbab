"""Global per-process state of the port.

The counterpart of ``horovod_tpu/common/state.py``. Under PyTorch one
process drives one card, as in the reference (one MPI rank per GPU), so
the worker identity and the process identity are the same:
``rank() == process_rank()`` and ``size() == process_count()``. The
collectives run over a ``torch.distributed`` process group: NCCL for
CUDA tensors, gloo for CPU tensors.
"""

import os
import threading

from .exceptions import NotInitializedError


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
        self.lock = threading.RLock()


_state = HorovodState()


def global_state():
    return _state


def _check_initialized():
    if not _state.initialized:
        raise NotInitializedError()


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
