"""Error types for horovod_tpu.

Mirrors the error surface of the reference core (Status codes in
horovod/common/common.h:69-99 and the canned errors in
horovod/common/operations.cc:114-124) as Python exceptions, since on TPU the
enqueue path is Python/ctypes rather than a C++ background thread.
"""


class HorovodError(Exception):
    """Base class for all horovod_tpu errors."""


class NotInitializedError(HorovodError):
    """Raised when the API is used before ``hvd.init()``.

    Parity: basics.py returns -1 from the C core and raises ValueError
    (reference horovod/common/basics.py:66-71).
    """

    def __init__(self, what="Horovod"):
        super().__init__(
            f"{what} has not been initialized; use hvd.init().")


class ShutdownError(HorovodError):
    """Collective was submitted after shutdown.

    Parity: SHUT_DOWN_ERROR (reference horovod/common/operations.cc:114-118).
    """

    def __init__(self, reason=None):
        msg = (
            "Horovod has been shut down. This was caused by an exception on "
            "one of the ranks or an attempt to submit a collective after "
            "shutdown() was called.")
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)


class RanksLostError(ShutdownError):
    """The control plane declared one or more ranks dead.

    Raised when the coordinator's liveness ledger sees no heartbeat
    (negotiation cycle) from a rank for longer than
    ``HOROVOD_RANK_LOST_TIMEOUT_SECONDS``, or when a worker declares the
    coordinator itself unreachable past its grace window. Subclasses
    ``ShutdownError`` so existing handlers keep working; carries the dead
    ranks in ``.ranks`` so supervisors (run/elastic.py) can shrink around
    them. Workers exiting on this error use ``EXIT_CODE`` so the launcher
    propagates a machine-readable fail-fast signal.
    """

    # distinct from generic failure (1) and SIGTERM (143): the elastic
    # supervisor keys auto-shrink on exactly this code
    EXIT_CODE = 44

    def __init__(self, ranks, reason=None, trace_id=None):
        self.ranks = tuple(sorted({int(r) for r in ranks}))
        # trace id of the blocking tensor (utils/tracing.py) so the error
        # message alone is enough to find the span in a flight dump
        self.trace_id = trace_id
        msg = (f"Horovod ranks {list(self.ranks)} are lost: no "
               f"control-plane heartbeat within the deadline. Pending "
               f"collectives cannot complete and have been failed.")
        if reason:
            msg += f" ({reason})"
        if trace_id:
            msg += f" [trace {trace_id}]"
        # bypass ShutdownError.__init__'s canned message
        super(ShutdownError, self).__init__(msg)


# Exit code a worker uses after a preemption-safe exit (SIGTERM/SIGINT
# consumed by trainer.Checkpointer: finish the in-flight step, force an
# emergency durable checkpoint, then exit). Distinct from generic failure
# (1), RanksLostError fail-fast (44) and raw SIGTERM death (143): the
# elastic supervisor keys its graceful NO-SHRINK restart on exactly this
# code — the job is healthy, the machine is going away.
PREEMPTED_EXIT_CODE = 45


class CheckpointError(HorovodError):
    """A checkpoint operation failed (commit timeout, structure
    mismatch between the checkpoint and the ``like`` tree, background
    writer failure). Fail-loud by design: a half-restored or silently
    wrong train state is worse than a dead job."""


class CorruptCheckpointError(CheckpointError):
    """A committed checkpoint failed integrity verification on restore
    (missing file, size drift, crc32 mismatch, incomplete leaf
    coverage). The commit protocol guarantees interrupted saves never
    commit, so this means real corruption — bit rot, truncation, or
    concurrent mutation of the checkpoint directory."""


class DuplicateNameError(HorovodError):
    """Two outstanding collectives share a name.

    Parity: DUPLICATE_NAME_ERROR (reference horovod/common/operations.cc:121-124).
    """

    def __init__(self, name):
        super().__init__(
            f"Requested to collect a tensor with the same name as another "
            f"tensor that is currently being processed: {name}. If you want "
            f"to request another tensor, pass a different tensor name.")


class MismatchError(HorovodError):
    """Shape/type/op mismatch between ranks for the same tensor name.

    Parity: the coordinator-side error checking in ConstructResponse
    (reference horovod/common/operations.cc:209-371): mismatched ops,
    dtypes, shapes, or root ranks produce an error Response for that tensor.
    """


class StalledError(HorovodError):
    """A collective stalled past the shutdown deadline.

    Parity: stall shutdown (reference horovod/common/operations.cc:688-769).
    """
