"""The launch layer of the port: the port's copy of
``horovod_tpu/run/``.

``python -m horovod_tpu_torch.run`` (``cli``) is hvdrun: it discovers a
routable rendezvous address the way the reference discovers NICs (ssh
checks, task-service ring probing; ``hosts``, ``services``, ``task_fn``
over the authenticated wire of ``network``) and spawns every worker
with the ``HVD_*`` environment that ``mpi_ops.init`` reads.
``python -m horovod_tpu_torch.run.elastic`` is the restart-based elastic
supervisor (the reference fork's submitjob.py). ``secret`` and
``network`` also carry the eager core's negotiation wire.
"""

from .secret import make_secret_key  # noqa: F401
from .settings import Settings, Timeout  # noqa: F401
from .hosts import HostSlots, parse_hosts  # noqa: F401
