"""Device-trace summarization for ``torch.profiler`` captures.

The port of ``horovod_tpu/utils/profiling.py``. The timeline
(``utils/timeline.py``) answers "what did the framework do"; this module
answers "where did the device time go", from the Chrome trace that
``torch.profiler`` exports::

    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    prof.export_chrome_trace("/tmp/prof/trace.json")
    from horovod_tpu_torch.utils.profiling import summarize_trace
    for row in summarize_trace("/tmp/prof").top(20):
        print(row)

or ``python -m horovod_tpu_torch.utils.profiling /tmp/prof
[--decompose|--overlap] [--wall-ms W] [--steps N]``.

Device events are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; host ops, runtime calls and annotations are left
out, so the durations are device time, not wall clock. Every device
event keeps its interval and its lane, one (device, stream) pair: the
trace's pid/tid of a device event (NCCL runs on a stream of its own).
``overlap_accounting`` turns those into the comm/compute overlap figures
(exposed vs hidden collective time, per-lane busy fractions) that
``profile_decomposition`` embeds: a collective interval either is or is
not covered by concurrent compute. ``summarize_profile`` builds the same
summary straight from a live profiler's events.
"""

import collections
import glob
import gzip
import json
import os


class OpRow:
    __slots__ = ("name", "group", "total_ms", "count", "long_name")

    def __init__(self, name, group, total_ms, count, long_name):
        self.name = name
        self.group = group
        self.total_ms = total_ms
        self.count = count
        self.long_name = long_name

    def __repr__(self):
        extra = f"  {self.long_name[:80]}" if self.long_name else ""
        return (f"{self.total_ms:9.3f} ms  x{self.count:<4d} "
                f"{self.name[:40]:40s}{extra}")


class OpEvent:
    """One device-op occurrence: name + lane + [start, end) in ms."""

    __slots__ = ("name", "lane", "start_ms", "end_ms")

    def __init__(self, name, lane, start_ms, end_ms):
        self.name = name
        self.lane = lane
        self.start_ms = start_ms
        self.end_ms = end_ms


class TraceSummary:
    def __init__(self, rows, events=None, lane_names=None):
        self.rows = sorted(rows, key=lambda r: -r.total_ms)
        # per-occurrence intervals (OpEvent), lane-keyed by "pid/tid"
        self.events = events or []
        self.lane_names = lane_names or {}

    @property
    def total_ms(self):
        return sum(r.total_ms for r in self.rows)

    def top(self, n=20):
        return self.rows[:n]

    def by_group(self):
        """Total ms per op family (the kernel name up to its first '<',
        '(' or '.'), the first place to look."""
        groups = collections.Counter()
        for r in self.rows:
            groups[r.group] += r.total_ms
        return groups.most_common()


#: the Chrome-trace categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _group_of(name):
    for sep in ("<", "(", "."):
        name = name.split(sep)[0]
    return name.strip() or name


def _summary(occurrences, lane_names=None):
    """TraceSummary of (name, lane, start_us, dur_us) occurrences."""
    total = collections.Counter()
    count = collections.Counter()
    events = []
    for name, lane, ts, dur in occurrences:
        total[name] += dur
        count[name] += 1
        events.append(OpEvent(name, lane, ts / 1e3, (ts + dur) / 1e3))
    rows = [OpRow(n, _group_of(n), total[n] / 1e3, count[n], "")
            for n in total]
    return TraceSummary(rows, events=events, lane_names=lane_names)


def find_trace_file(path):
    """``path`` may be a Chrome-trace file or a directory holding one or
    more (``*.json`` / ``*.json.gz``, newest taken)."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json*"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(
            f"no *.json(.gz) trace under {path!r}: pass the file "
            "torch.profiler's export_chrome_trace wrote, or its directory")
    return hits[-1]


def load_trace(path):
    """The parsed Chrome trace (a dict with ``traceEvents``)."""
    trace_file = find_trace_file(path)
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        return json.load(f)


def summarize_trace(path):
    """Aggregate device-event durations from an exported Chrome trace
    (a path, or the trace dict itself)."""
    trace = path if isinstance(path, dict) else load_trace(path)
    lane_names = {}
    occurrences = []
    for e in trace.get("traceEvents", []):
        lane = f"{e.get('pid', 0)}/{e.get('tid', 0)}"
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            lane_names[lane] = (e.get("args") or {}).get("name", "")
            continue
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        occurrences.append((e.get("name", ""), lane, float(e.get("ts", 0)),
                            float(e["dur"])))
    return _summary(occurrences, lane_names)


def summarize_profile(prof):
    """The same summary from a finished ``torch.profiler.profile``'s own
    events (no export): every event that ran on the card, its lane the
    (device, stream) pair."""
    from torch.autograd import DeviceType
    occurrences = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lane = f"{e.device_index}/{getattr(e, 'device_resource_id', 0)}"
        occurrences.append((e.name, lane, float(e.time_range.start),
                            float(e.time_range.elapsed_us())))
    return _summary(occurrences)


def trace_start_us(prof):
    """The epoch µs a finished ``torch.profiler.profile`` measures its
    events' ``time_range`` from (the profiler's own start)."""
    res = prof.profiler.kineto_results
    if hasattr(res, "trace_start_ns"):
        return res.trace_start_ns() / 1e3
    return float(res.trace_start_us())


def launch_gap_us(prof):
    """The least µs between a launch call on the host (``cuda*`` / ``cu*``
    runtime events) and the start the card recorded for the kernel, copy
    or set it launched, over the pairs a finished ``torch.profiler.profile``
    holds (a pair shares its correlation id, ``FunctionEvent.id``); None
    without a pair. On one clock it is the launch latency, a few µs."""
    from torch.autograd import DeviceType
    launched, started = {}, {}
    for e in prof.events():
        if not e.id:
            continue
        if e.device_type == DeviceType.CUDA:
            started.setdefault(e.id, float(e.time_range.start))
        elif e.name.startswith("cu"):
            launched.setdefault(e.id, float(e.time_range.start))
    gaps = [t - launched[i] for i, t in started.items() if i in launched]
    return min(gaps) if gaps else None


# host calls that queue work on the card: in a complete capture each one's
# correlation id also names the kernel, copy or set it queued
_LAUNCH_CALLS = ("launchkernel", "launchcooperativekernel", "memcpy",
                 "memset")


def unrecorded_launches(prof):
    """``(launched, unrecorded)`` of a finished ``torch.profiler.profile``:
    how many launch calls on the host (``cu*`` runtime or driver calls
    that queue a kernel, a copy or a set) it holds, and the names of
    those whose device event, under the same correlation id, it lacks.
    On the CPU both are empty. A capture with unrecorded launches misses
    device work it saw queued: late in a long process on an H100 the
    profiler has kept every host call of a capture and dropped all but
    its last device records."""
    from torch.autograd import DeviceType
    launches, recorded = {}, set()
    for e in prof.events():
        if not e.id:
            continue
        if e.device_type == DeviceType.CUDA:
            recorded.add(e.id)
        elif e.name.startswith("cu") and \
                any(k in e.name.lower() for k in _LAUNCH_CALLS):
            launches.setdefault(e.id, e.name)
    return len(launches), [n for i, n in launches.items()
                           if i not in recorded]


def device_events(prof, anchor=True):
    """Every event a finished ``torch.profiler.profile`` recorded on the
    card as a Chrome-trace ``X`` event (``cat`` kernel, gpu_memcpy or
    gpu_memset; pid the device, tid the stream), its ``ts`` in epoch µs.
    Read from the live profiler, which holds them where an exported
    trace can come out without any. With ``anchor`` the card's times are
    moved onto the host's by ``launch_gap_us``, the quickest launch then
    starting at its call, whatever offset the card's clock has from the
    host's (on an H100 the gap read 6-19 µs)."""
    from torch.autograd import DeviceType
    t0 = trace_start_us(prof)
    if anchor:
        t0 -= launch_gap_us(prof) or 0.0
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        cat = ("gpu_memcpy" if "memcpy" in low else
               "gpu_memset" if "memset" in low else "kernel")
        out.append({"name": e.name, "cat": cat, "ph": "X",
                    "pid": e.device_index,
                    "tid": getattr(e, "device_resource_id", 0),
                    "ts": t0 + float(e.time_range.start),
                    "dur": float(e.time_range.elapsed_us())})
    return out


# Op classes for profile_decomposition, first match wins (checked against
# the lowercased name). The class names are the JAX package's; each
# keeps the JAX package's needles (XLA op names) and adds the CUDA
# kernels that do that work on the card: the port's flash kernels
# (flash_fwd_sm90/_cc/_dyn, flash_bwd_*_dq, flash_bwd_*_dkv), NCCL,
# cuBLAS / CUTLASS products, copies, gathers and sorts ("copy"), and
# what XLA would fuse ("fusion"): PyTorch's elementwise and reduction
# kernels, the multi-tensor (foreach, fused optimizer) kernels, layer
# norm, softmax, the loss, scans and the embedding's scatter-add.
# Everything else lands in "other": the decomposition never drops time.
_OP_CLASSES = (
    ("flash_fwd", ("fwd_kernel", "flash_fwd")),
    ("flash_dq", ("dq_kernel", "flash_bwd_dq", "flash_bwd_sm90_dq")),
    ("flash_dkv", ("dkv_kernel", "flash_bwd_dkv", "flash_bwd_sm90_dkv")),
    ("collective", ("all-reduce", "allreduce", "all-gather", "allgather",
                    "reduce-scatter", "all-to-all", "collective",
                    "psum", "ppermute", "nccl", "reducescatter",
                    "sendrecv")),
    ("matmul", ("dot", "conv", "gemm", "matmul", "einsum", "xmma",
                "nvjet", "cutlass")),
    ("copy", ("copy", "transpose", "bitcast", "memset", "dynamic-slice",
              "dynamic-update", "pad", "reshape", "concatenate", "slice",
              "memcpy", "indexselect", "index_select", "gather",
              "radixsort", "sort_kernel")),
    ("fusion", ("fusion", "loop_", "input_", "output_", "elementwise",
                "reduce_kernel", "reduction", "multi_tensor_apply",
                "foreach", "lpnorm", "adam", "layer_norm", "layernorm",
                "gammabeta", "softmax", "nll_loss", "cross_entropy",
                "scan", "cumsum", "embedding_backward", "indexing_backward",
                "scatter", "reduce_1block")),
)

# the classes overlap_accounting treats as communication; every other
# device op counts as compute cover
_COMM_CLASSES = frozenset(("collective",))


def classify_op(row, classes=_OP_CLASSES):
    hay = (row.name + " " + (row.long_name or "")).lower()
    for cls, needles in classes:
        if any(n in hay for n in needles):
            return cls
    return "other"


def _merge_intervals(intervals):
    """Union of [start, end) intervals as a sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _span_ms(merged):
    return sum(e - s for s, e in merged)


def _intersect_ms(a, b):
    """Total overlap between two DISJOINT SORTED interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_accounting(summary, classes=_OP_CLASSES, steps=1,
                       comm_classes=_COMM_CLASSES):
    """Comm/compute overlap from a lane-aware capture: how much
    collective time was HIDDEN under concurrent compute (any compute lane
    busy at the same instant) vs EXPOSED, and how busy each lane was over
    the captured span. All ms divided by ``steps``; None when the summary
    carries no intervals."""
    summary = summary if isinstance(summary, TraceSummary) else \
        summarize_trace(summary)
    if not summary.events:
        return None
    class_of = {r.name: classify_op(r, classes) for r in summary.rows}
    comm_iv, compute_iv = [], []
    by_lane = collections.defaultdict(list)
    for ev in summary.events:
        iv = (ev.start_ms, ev.end_ms)
        (comm_iv if class_of.get(ev.name) in comm_classes
         else compute_iv).append(iv)
        by_lane[ev.lane].append(iv)
    comm = _merge_intervals(comm_iv)
    compute = _merge_intervals(compute_iv)
    comm_ms = _span_ms(comm)
    hidden = _intersect_ms(comm, compute)
    exposed = comm_ms - hidden
    span_start = min(s for s, _ in (comm + compute))
    span_end = max(e for _, e in (comm + compute))
    span = span_end - span_start
    lanes = []
    for lane in sorted(by_lane):
        busy = _span_ms(_merge_intervals(by_lane[lane]))
        lanes.append({
            "lane": lane,
            "name": summary.lane_names.get(lane, ""),
            "busy_ms_per_step": round(busy / steps, 3),
            "busy_frac": round(busy / span, 4) if span else None,
        })
    return {
        "comm_ms_per_step": round(comm_ms / steps, 3),
        "compute_ms_per_step": round(_span_ms(compute) / steps, 3),
        "hidden_comm_ms": round(hidden / steps, 3),
        "exposed_comm_ms": round(exposed / steps, 3),
        "overlap_frac": round(hidden / comm_ms, 4) if comm_ms else None,
        "span_ms_per_step": round(span / steps, 3),
        "lanes": lanes,
    }


def profile_decomposition(trace, wall_ms=None, steps=1,
                          classes=_OP_CLASSES, top_per_class=3):
    """Account for every millisecond of a step: a capture's device time
    by op class and, with the traced region's wall time PER STEP, the
    residual (wall minus device busy: host dispatch and gaps) and the
    device-busy fraction; the ``overlap`` block when the capture has
    intervals; the allocator peak (``peak_hbm_bytes``) on the card.
    ``trace``: a trace file or directory, a trace dict or a
    TraceSummary; all ms divided by ``steps``."""
    summary = trace if isinstance(trace, TraceSummary) else \
        summarize_trace(trace)
    buckets = {}
    for row in summary.rows:
        buckets.setdefault(classify_op(row, classes), []).append(row)
    device_ms = summary.total_ms / steps
    per_class = []
    for cls, rows in sorted(buckets.items(),
                            key=lambda kv: -sum(r.total_ms for r in kv[1])):
        ms = sum(r.total_ms for r in rows) / steps
        per_class.append({
            "class": cls,
            "ms_per_step": round(ms, 3),
            "pct_of_device": round(100 * ms / device_ms, 1)
            if device_ms else 0.0,
            "top_ops": [
                {"name": r.name, "ms_per_step": round(r.total_ms / steps, 3),
                 "count": r.count}
                for r in sorted(rows, key=lambda r: -r.total_ms)
                [:top_per_class]],
        })
    out = {"device_ms_per_step": round(device_ms, 3),
           "classes": per_class, "steps": steps}
    if wall_ms:
        out["wall_ms_per_step"] = round(wall_ms, 3)
        out["residual_ms_per_step"] = round(wall_ms - device_ms, 3)
        out["device_busy_frac"] = round(device_ms / wall_ms, 4)
    elif wall_ms is not None:
        out["wall_ms_per_step"] = 0.0
        out["residual_ms_per_step"] = None
        out["device_busy_frac"] = None
    overlap = overlap_accounting(summary, classes=classes, steps=steps)
    if overlap is not None:
        out["overlap"] = overlap
    from . import memory as memory_mod
    peak = memory_mod.step_peak_bytes()
    if peak is not None:
        out["peak_hbm_bytes"] = peak
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Summarize device time from a torch.profiler Chrome "
                    "trace")
    p.add_argument("path", help="exported trace file or its directory")
    p.add_argument("-n", type=int, default=20, help="rows to print")
    p.add_argument("--decompose", action="store_true",
                   help="print the op-class decomposition instead")
    p.add_argument("--overlap", action="store_true",
                   help="print the comm/compute overlap accounting")
    p.add_argument("--wall-ms", type=float, default=None,
                   help="wall ms/step of the traced region (residual row)")
    p.add_argument("--steps", type=int, default=1,
                   help="steps the capture spans (output is per step)")
    args = p.parse_args(argv)
    summary = summarize_trace(args.path)
    if args.decompose:
        dec = profile_decomposition(summary, wall_ms=args.wall_ms,
                                    steps=args.steps)
        print(json.dumps(dec, indent=2))
        return
    if args.overlap:
        print(json.dumps(overlap_accounting(summary, steps=args.steps),
                         indent=2))
        return
    print(f"device-op total: {summary.total_ms:.1f} ms "
          f"({len(summary.rows)} distinct ops)")
    print("-- by group")
    for group, ms in summary.by_group()[:10]:
        print(f"{ms:9.3f} ms  {group}")
    print("-- top ops")
    for row in summary.top(args.n):
        print(row)


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        import sys
        sys.exit(0)
