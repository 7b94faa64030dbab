"""Horovod Timeline: Chrome-tracing JSON of collective activity.

The port of ``horovod_tpu/utils/timeline.py`` (reference
horovod/common/timeline.{h,cc}):
  * enabled by HOROVOD_TIMELINE=<file> on rank 0 (operations.cc:986-994)
  * per-tensor lifecycle: NEGOTIATE_<OP> phase, then top-level op span,
    then per-activity sub-spans (timeline.h:76)
  * writes happen on the native core's writer thread fed by a queue
    (``NativeTimeline``, ``csrc/host/timeline.cc``), so the hot path
    never blocks
  * optional cycle markers via HOROVOD_TIMELINE_MARK_CYCLES
    (operations.cc:996, 1258-1261)

Activity names (common.h:30-51): QUEUE, MEMCPY_IN_FUSION_BUFFER,
ALLREDUCE, MEMCPY_OUT_FUSION_BUFFER, ALLGATHER, BROADCAST, NEGOTIATE_*.
Events use the Chrome trace "ph" codes "M" metadata, "B"/"E"
begin/end, "i" instant. The writer takes the shared clock of
``utils/metrics.py``: its ``ts`` and ``clock_sync`` epoch are the ones
metric events and spans carry. ``profile(logdir)`` captures a
``torch.profiler`` device trace over a block (the JAX package's
``jax.profiler`` capture); ``utils/merged_timeline.py`` merges such a
trace with this timeline on one clock.
"""

import contextlib
import os

# Activity names (reference common.h:30-51).
QUEUE = "QUEUE"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
CYCLE_START = "CYCLE_START"


class NativeTimeline:
    """The Chrome-trace writer the eager core emits its spans to, backed
    by the native writer thread (``csrc/host/timeline.cc``)."""

    def __init__(self, filename, mark_cycles=False):
        from .. import _native
        from . import metrics as metrics_mod
        self._lib = _native.load()
        # the process-wide shared clock: trace ts and metric/event/span
        # ts_us ride one monotonic base, and the clock_sync epoch is the
        # one sampled with it
        clock = metrics_mod.shared_clock()
        self._ptr = self._lib.hvd_timeline_create(
            filename.encode(), 1 if mark_cycles else 0, clock.base_ns,
            clock.epoch_us_at_ts0)
        if not self._ptr:
            raise OSError(f"cannot open timeline file {filename}")

    @property
    def enabled(self):
        return self._ptr is not None

    def start_activity(self, tensor_name, activity):
        self._lib.hvd_timeline_event(self._ptr, tensor_name.encode(),
                                     activity.encode(), 0)

    def end_activity(self, tensor_name, activity=None):
        self._lib.hvd_timeline_event(self._ptr, tensor_name.encode(), b"", 1)

    def negotiate_start(self, tensor_name, op_name):
        self.start_activity(tensor_name, f"NEGOTIATE_{op_name.upper()}")

    def negotiate_end(self, tensor_name):
        self.end_activity(tensor_name)

    def mark_cycle_start(self):
        self._lib.hvd_timeline_cycle(self._ptr)

    def pending(self):
        return int(self._lib.hvd_timeline_pending(self._ptr))

    def close(self):
        if self._ptr:
            self._lib.hvd_timeline_destroy(self._ptr)
            self._ptr = None


def create_from_env(config, is_coordinator):
    """Rank-0-only creation (reference operations.cc:986-994), on the
    native writer. A file that cannot be opened raises."""
    if not (config.timeline_filename and is_coordinator):
        return None
    return NativeTimeline(config.timeline_filename,
                          mark_cycles=config.timeline_mark_cycles)


@contextlib.contextmanager
def profile(logdir):
    """Capture a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activity) over the context and export it as ``logdir/trace.json``
    (Chrome trace; ``utils/profiling.py`` summarizes it). Yields the
    profiler.

        with hvd.utils.timeline.profile("/tmp/torch-trace"):
            ... training steps / eager collectives ...
    """
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
