"""One merged Chrome trace: Horovod host spans + CUDA device events.

The port of ``horovod_tpu/utils/merged_timeline.py``. The Horovod
timeline (``utils/timeline.py``) records what the framework did:
NEGOTIATE_* phases, fusion-buffer memcpys, the collective's span. A
``torch.profiler`` capture records what the card did: the NCCL and
compute kernels that served those collectives. ``merge()`` puts both on
one clock, as the reference does by replaying comm-library activity into
its timeline (horovod/common/timeline.h:80-125):

  * the Horovod timeline stamps ``clock_sync`` metadata at creation: the
    wall-clock epoch (µs) at its ts=0, the shared clock of
    ``utils/metrics.py``;
  * the Chrome trace ``torch.profiler`` exports carries its own base,
    ``baseTimeNanoseconds``: every event's ``ts`` is in µs since that
    epoch base. Where the installed torch writes no such field, the
    epoch is the wall time sampled when ``capture`` started the
    profiler, standing for the trace's earliest ``ts``;
  * the device events come from the live profiler (``capture`` hands
    ``profiling.device_events`` to ``merge``), timed from the
    profiler's own start in epoch µs and anchored on their launch
    calls: an exported trace can come out without any device event
    while the profiler still holds them, so the trace's own device
    events are replaced by these. A capture that holds launch calls
    whose device record the profiler dropped (``profiling.
    unrecorded_launches``; late in a long process it has kept only the
    last few) says so: a warning, and a ``device_records`` metadata
    event in the merged file;
  * ``merge()`` re-times both event streams onto one epoch clock (the
    timeline's moved by ``timeline_shift_us``, the shared clock's drift
    from the wall clock when ``capture`` ran) and writes ONE
    Chrome-trace JSON.

Typical use (rank 0, ``HOROVOD_TIMELINE=<file>`` set before ``init``)::

    with merged_timeline.capture("/tmp/merged.json"):
        ... training steps / eager collectives ...

or post hoc, from a timeline file and an exported trace::

    merged_timeline.merge("/tmp/t.json", "/tmp/trace.json",
                          "/tmp/merged.json")
"""

import contextlib
import json
import logging
import os
import shutil
import tempfile
import time

from . import metrics as metrics_mod
from . import profiling

# Horovod lanes are re-numbered into this range so they never collide
# with the profiler's pids (a device index, or this process's pid)
_HVD_PID_BASE = 1_000_000

# seconds capture() keeps the profiler running on the card before and
# after the body, so that no device record of the body lies at an edge of
# the profiler's window (late in a long process on an H100 a capture of
# ~2 ms of device work kept only its last 2 records; the wait did not
# bring the others back, and unrecorded_launches counts such losses)
_SETTLE_S = 0.2

_log = logging.getLogger("horovod_tpu_torch")


def _load_timeline_events(path):
    """Parse a (possibly still-open) Horovod timeline file: one JSON
    object per line, tolerant of the trailing comma / unclosed array the
    streaming writer leaves behind."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]", "{}]"):
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue  # torn tail line of a live file
    return events


def _timeline_epoch_us(events):
    for e in events:
        if e.get("name") == "clock_sync":
            return float(e["args"]["epoch_us_at_ts0"])
    return None


def trace_epoch_us(trace):
    """The epoch µs at the exported trace's ts=0 (``baseTimeNanoseconds``
    / 1000), or None when the trace carries no base."""
    base = trace.get("baseTimeNanoseconds")
    return float(base) / 1e3 if base is not None else None


def merge(timeline_path, trace_path, out_path, profiler_epoch_us=None,
          profiler_epoch_us_fallback=None, device_events=None,
          timeline_shift_us=0.0, device_records=None):
    """Merge a Horovod timeline file and a ``torch.profiler`` Chrome trace
    (a file, or the directory ``profiling.find_trace_file`` searches)
    into one Chrome-trace JSON on a shared clock base.

    The profiler's epoch at its ts=0 is, in order: ``profiler_epoch_us``
    if given; the trace's ``baseTimeNanoseconds``; else the wall clock
    ``profiler_epoch_us_fallback`` (µs, taken when the profiler started)
    standing for the trace's earliest ``ts``. ``device_events`` (Chrome
    ``X`` events, ``ts`` in epoch µs, as ``profiling.device_events``
    gives them) take the place of the trace's own device events.
    ``timeline_shift_us`` is added to the timeline's epoch: the wall
    clock less the shared clock's reading, taken when the capture ran
    (the timeline rides the monotonic clock from its anchor at import,
    the profiler the wall clock, and the two drift apart over a long
    process). ``device_records`` (a dict: the capture's launch calls and
    those the profiler kept no device event for) goes into the file as a
    ``device_records`` metadata event. Returns the merged event count."""
    hvd_events = _load_timeline_events(timeline_path)
    hvd_epoch = _timeline_epoch_us(hvd_events)
    if hvd_epoch is None:
        raise ValueError(
            f"{timeline_path!r} has no clock_sync metadata; re-capture it")
    hvd_epoch += timeline_shift_us
    trace = profiling.load_trace(trace_path)
    prof_events = trace.get("traceEvents", [])
    if profiler_epoch_us is None:
        profiler_epoch_us = trace_epoch_us(trace)
    if profiler_epoch_us is None and profiler_epoch_us_fallback is not None:
        first = min((float(e["ts"]) for e in prof_events if "ts" in e),
                    default=0.0)
        profiler_epoch_us = profiler_epoch_us_fallback - first
    if profiler_epoch_us is None:
        raise ValueError(
            "cannot determine the profiler trace's epoch base: it has no "
            "baseTimeNanoseconds; pass profiler_epoch_us (capture() "
            "records a fallback)")

    base = min(hvd_epoch, profiler_epoch_us)
    merged = []
    for e in hvd_events:
        e = dict(e)
        e["pid"] = _HVD_PID_BASE + int(e.get("pid", 0))
        if e.get("ph") == "M" and e.get("name") == "process_name":
            e["args"] = {"name": "hvd: " + e["args"]["name"]}
        if "ts" in e:
            e["ts"] = e["ts"] + (hvd_epoch - base)
        merged.append(e)
    # one named lane for the framework clock_sync/cycle markers (pid 0)
    merged.insert(0, {"name": "process_name", "ph": "M",
                      "pid": _HVD_PID_BASE,
                      "args": {"name": "hvd: coordinator"}})
    shift = profiler_epoch_us - base
    for e in prof_events:
        if device_events is not None and \
                e.get("cat") in profiling.DEVICE_CATEGORIES:
            continue
        if "ts" in e:
            e = dict(e)
            e["ts"] = float(e["ts"]) + shift
        merged.append(e)
    for e in device_events or ():
        merged.append(dict(e, ts=float(e["ts"]) - base))
    if device_records is not None:
        merged.append({"name": "device_records", "ph": "M",
                       "pid": _HVD_PID_BASE, "args": dict(device_records)})
    with open(out_path, "w") as f:
        json.dump({"displayTimeUnit": "ns", "traceEvents": merged}, f)
    return len(merged)


def _drain_timeline(timeline, timeout_s=5.0):
    """Poll the writer thread's queue until it has drained (bounded)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if timeline.pending() == 0:
            break
        time.sleep(0.02)
    time.sleep(0.05)  # the final event's write+flush is not queue-visible


@contextlib.contextmanager
def capture(out_path, trace_path=None):
    """Run a ``torch.profiler`` capture (CPU and, with a card, CUDA
    activity) over the context and, on exit, merge it with the live
    Horovod timeline into ``out_path``, the device events taken from the
    profiler itself (``profiling.device_events``). ``trace_path`` keeps
    the exported trace there (else it goes to a temporary directory,
    removed after).

    On the card the profiler runs ``_SETTLE_S`` before and after the
    body, and the device events are anchored on their launch calls
    (``profiling.device_events``); the timeline is moved onto the wall
    clock by the shared clock's drift, read at the start. Launch calls
    the profiler holds without their device event are counted into the
    merged file (``device_records``) and warned of.

    Requires this process to own an active timeline (rank 0 with
    ``HOROVOD_TIMELINE=<file>`` at ``init``); raises otherwise. If the
    body raises, the profiler stops but no merge is attempted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..common import state

    st = state.global_state()
    timeline = getattr(st.coordinator, "timeline", None)
    if timeline is None:
        raise RuntimeError(
            "merged_timeline.capture needs an active timeline on THIS "
            "process: set HOROVOD_TIMELINE=<file> before init() and call "
            "capture() on rank 0 (the timeline is rank-0-only)")
    timeline_path = st.config.timeline_filename
    own_dir = None
    if trace_path is None:
        own_dir = tempfile.mkdtemp(prefix="hvd-merged-trace-")
        trace_path = os.path.join(own_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    on_card = torch.cuda.is_available()
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    epoch_us = time.time_ns() / 1e3
    shift_us = epoch_us - float(metrics_mod.shared_clock().epoch_us())
    prof = profile(activities=activities)
    prof.start()
    if on_card:
        torch.cuda.synchronize()
        time.sleep(_SETTLE_S)
    ok = False
    try:
        yield prof
        ok = True
    finally:
        if on_card:
            torch.cuda.synchronize()
            time.sleep(_SETTLE_S)
        prof.stop()
        try:
            if ok:
                prof.export_chrome_trace(trace_path)
                _drain_timeline(timeline)
                records = None
                if on_card:
                    launched, lost = profiling.unrecorded_launches(prof)
                    records = {"launches": launched, "unrecorded": len(lost)}
                    if lost:
                        _log.warning(
                            "merged timeline %s: the profiler kept no device "
                            "event for %d of the %d launches it saw (%s); "
                            "the merged file misses that device work",
                            out_path, len(lost), launched,
                            sorted(set(lost)))
                merge(timeline_path, trace_path, out_path,
                      profiler_epoch_us_fallback=epoch_us,
                      device_events=profiling.device_events(prof)
                      if on_card else None, timeline_shift_us=shift_us,
                      device_records=records)
        finally:
            if own_dir is not None:
                shutil.rmtree(own_dir, ignore_errors=True)
