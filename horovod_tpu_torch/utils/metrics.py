"""Telemetry plane: per-rank metrics registry and exposition, the
port's copy of ``horovod_tpu/utils/metrics.py`` (stdlib only, so the
copy is the JAX package's line for line apart from the clock).

  * a registry of **counters**, **gauges** and **fixed-bucket
    histograms**, each optionally labeled, with explicit merge semantics
    so per-rank snapshots sum at rank 0;
  * a **structured JSON event ring** (stall declarations, lost ranks,
    chaos injections, ...) on the shared clock: every event carries
    ``ts_us`` on the process-wide monotonic base whose epoch anchor the
    native timeline writes as its ``clock_sync`` event
    (``utils/timeline.py``), so a metrics snapshot and a timeline trace
    correlate instant for instant;
  * **exposition**: Prometheus text and a JSON snapshot served by a
    background HTTP thread on ``HVD_METRICS_PORT`` (rank r binds port+r),
    rank 0 also serving the aggregate of every rank's snapshot (workers
    piggyback theirs on the negotiation cycle every
    ``HVD_METRICS_INTERVAL`` seconds: the control plane is the
    transport);
  * ``parse_prometheus`` / ``render_prometheus`` round-trip either
    endpoint.

Overhead: an instrument is a dict lookup and a locked add. With
``HVD_METRICS=0`` the registry is a null object whose methods do
nothing.
"""

import bisect
import collections
import json
import os
import threading
import time


# ---------------------------------------------------------------------------
# shared clock — the correlation anchor with utils/timeline.py
# ---------------------------------------------------------------------------

class Clock:
    """Monotonic microsecond clock with a wall-clock epoch anchor,
    sampled at the same instant. One process-wide instance is created at
    import; the native timeline takes its pair (``base_ns``, the base in
    nanoseconds of ``CLOCK_MONOTONIC``, which both ``time.monotonic_ns``
    and libstdc++'s ``steady_clock`` read on Linux, and
    ``epoch_us_at_ts0``), so trace ``ts`` values and metric/event
    ``ts_us`` values share a base."""

    def __init__(self):
        self.base_ns = time.monotonic_ns()
        self.base = self.base_ns / 1e9
        self.epoch_us_at_ts0 = time.time_ns() // 1000

    def ts_us(self):
        return (time.monotonic_ns() - self.base_ns) // 1000

    def epoch_us(self, ts_us=None):
        if ts_us is None:
            ts_us = self.ts_us()
        return self.epoch_us_at_ts0 + ts_us


_CLOCK = Clock()


def shared_clock():
    return _CLOCK


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

# Default latency buckets (seconds): spans the 5 ms cycle cadence down to
# sub-ms cache-hit cycles and up to multi-second stalls.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Fill-fraction buckets (fusion buffer utilization, 0..1+; >1 is an
# oversized single tensor in its own bucket).
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
# Small-count buckets (tensors per cycle / per bucket).
COUNT_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
# Serving request-phase buckets (seconds): like LATENCY_BUCKETS but
# extended past 10 s — queue_wait under overload legally runs up to the
# admission timeout (HVD_SERVE_ADMISSION_TIMEOUT_S, default 10 s), so
# the default buckets would saturate exactly where the p99 lives and
# histogram_quantile could only answer ">10s".
SERVE_PHASE_BUCKETS = LATENCY_BUCKETS + (30.0, 60.0)


class Counter:
    """Monotonic counter. Merge semantics: sum."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0  # guarded_by: _lock
        self._lock = threading.Lock()

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """Point-in-time value. Merge semantics: sum across ranks (a count
    of stalled/lost/pending things sums meaningfully; document any gauge
    for which a sum is not the right read in docs/metrics.md)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0  # guarded_by: _lock
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram. ``bounds`` are upper bounds (le); one
    implicit +Inf bucket is appended. Counts are stored per-bucket
    (non-cumulative); exposition renders Prometheus-style cumulative
    counts. Merge semantics: element-wise count sum — two histograms
    merge iff their bounds are identical (a silent resample would
    fabricate latencies), else ValueError."""

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds not sorted: {bounds}")
        self._counts = [0] * (len(self.bounds) + 1)  # guarded_by: _lock
        self._sum = 0.0    # guarded_by: _lock
        self._count = 0    # guarded_by: _lock
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        i = 0
        for b in self.bounds:
            if value <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def observe_many(self, values):
        """``observe`` each of ``values`` under one lock (the port's
        addition: the tracer closes a fused group's spans at once)."""
        values = [float(v) for v in values]
        idx = [bisect.bisect_left(self.bounds, v) for v in values]
        with self._lock:
            for i in idx:
                self._counts[i] += 1
            self._sum += sum(values)
            self._count += len(values)

    @property
    def counts(self):
        return list(self._counts)

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: a set of children keyed by label values. With no
    labels the family proxies its single ``()`` child, so
    ``reg.counter("x").inc()`` and
    ``reg.counter("x", labels=("op",)).labels(op="y").inc()`` both
    read naturally."""

    def __init__(self, name, help_text, kind, label_names, bounds=None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = tuple(label_names)
        self.bounds = bounds
        self._children = {}  # guarded_by: _lock
        self._lock = threading.Lock()

    def labels(self, **label_values):
        key = tuple(str(label_values.get(n, "")) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = (Histogram(self.bounds)
                             if self.kind == "histogram"
                             else _KINDS[self.kind]())
                    self._children[key] = child
        return child

    # no-label convenience proxies
    def inc(self, amount=1):
        self.labels().inc(amount)

    def set(self, value):
        self.labels().set(value)

    def observe(self, value):
        self.labels().observe(value)

    @property
    def value(self):
        return self.labels().value


class MetricsRegistry:
    """Per-rank registry + structured event ring.

    Instrument getters are idempotent (same name returns the existing
    family; a kind or label mismatch raises — two call sites silently
    disagreeing about a metric is a bug worth failing on).
    """

    EVENT_RING = 256

    def __init__(self, rank=None, clock=None):
        self.rank = rank
        self.clock = clock or _CLOCK
        self._families = collections.OrderedDict()  # guarded_by: _lock
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=self.EVENT_RING)  # guarded_by: _lock
        self._events_dropped = 0  # guarded_by: _lock
        # optional JSONL sink for the event log
        self._event_file = None
        path = _env("METRICS_EVENT_LOG")
        if path:
            try:
                self._event_file = open(path, "a")
            except OSError:
                self._event_file = None

    @property
    def enabled(self):
        return True

    def _family(self, name, help_text, kind, labels, bounds=None):
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, help_text, kind, labels,
                                  bounds=bounds)
                    self._families[name] = fam
        if fam.kind != kind or fam.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-registered as {kind}{tuple(labels)} "
                f"but exists as {fam.kind}{fam.label_names}")
        if kind == "histogram" and bounds is not None and \
                fam.bounds != tuple(float(b) for b in bounds):
            raise ValueError(
                f"histogram {name!r} re-registered with different buckets")
        return fam

    def counter(self, name, help_text="", labels=()):
        return self._family(name, help_text, "counter", labels)

    def gauge(self, name, help_text="", labels=()):
        return self._family(name, help_text, "gauge", labels)

    def histogram(self, name, help_text="", buckets=LATENCY_BUCKETS,
                  labels=()):
        return self._family(name, help_text, "histogram", labels,
                            bounds=buckets)

    # -- structured events --

    def event(self, kind, **fields):
        """Append a structured event: ``{"event": kind, "ts_us": ...,
        "epoch_us": ..., **fields}``. ``ts_us`` is on the shared
        timeline clock; ``epoch_us`` makes events mergeable across
        ranks (each rank's monotonic base differs)."""
        ts = self.clock.ts_us()
        ev = {"event": kind, "ts_us": ts,
              "epoch_us": self.clock.epoch_us(ts)}
        ev.update(fields)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._events_dropped += 1
            self._events.append(ev)
            f = self._event_file
        if f is not None:
            try:
                f.write(json.dumps(ev) + "\n")
                f.flush()
            except Exception:  # noqa: BLE001 — sink death must not raise
                self._event_file = None
        return ev

    def events(self):
        with self._lock:
            return list(self._events)

    # -- snapshot / exposition --

    def snapshot(self, max_events=None):
        """JSON-serializable view of every instrument + the event ring.
        The wire format for rank-0 aggregation and /metrics.json."""
        metrics = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            entry = {"type": fam.kind, "help": fam.help,
                     "labels": list(fam.label_names), "values": []}
            if fam.kind == "histogram":
                entry["buckets"] = list(fam.bounds)
            for key, child in sorted(fam._children.items()):
                lv = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    entry["values"].append(
                        {"labels": lv, "counts": child.counts,
                         "sum": child.sum, "count": child.count})
                else:
                    entry["values"].append(
                        {"labels": lv, "value": child.value})
            metrics[fam.name] = entry
        with self._lock:
            events = list(self._events)
            dropped = self._events_dropped
        if max_events is not None:
            events = events[-max_events:]
        return {
            "version": 1,
            "rank": self.rank,
            "ts_us": self.clock.ts_us(),
            "epoch_us_at_ts0": self.clock.epoch_us_at_ts0,
            "metrics": metrics,
            "events": events,
            "events_dropped": dropped,
        }

    def to_prometheus(self, extra_labels=None):
        return render_prometheus(self.snapshot(max_events=0),
                                 extra_labels=extra_labels)


class _NullInstrument:
    """Absorbs every instrument call when metrics are disabled."""

    def labels(self, **kw):
        return self

    def inc(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    value = 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """HVD_METRICS=0: every instrument is a shared no-op object, so the
    instrumentation sites cost one method call and nothing else."""

    rank = None
    enabled = False
    clock = _CLOCK

    def counter(self, *a, **kw):
        return _NULL_INSTRUMENT

    def gauge(self, *a, **kw):
        return _NULL_INSTRUMENT

    def histogram(self, *a, **kw):
        return _NULL_INSTRUMENT

    def event(self, kind, **fields):
        return None

    def events(self):
        return []

    def snapshot(self, max_events=None):
        return {"version": 1, "rank": None, "ts_us": self.clock.ts_us(),
                "epoch_us_at_ts0": self.clock.epoch_us_at_ts0,
                "metrics": {}, "events": [], "events_dropped": 0,
                "disabled": True}

    def to_prometheus(self, extra_labels=None):
        return ""


def _env(name, default=None):
    """HOROVOD_<name> / HVD_<name> lookup without importing
    common.config (this module stays import-cycle-free: chaos and network
    instrument through it)."""
    for prefix in ("HOROVOD_", "HVD_"):
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


_registry = None  # guarded_by: _registry_lock
_registry_lock = threading.Lock()


def get_registry():
    """The process-wide registry (created on first use; honors
    HVD_METRICS=0 with a no-op registry)."""
    global _registry
    reg = _registry
    if reg is None:
        with _registry_lock:
            if _registry is None:
                disabled = str(_env("METRICS", "1")).strip().lower() in (
                    "0", "false", "no", "off")
                _registry = (NullRegistry() if disabled
                             else MetricsRegistry())
            reg = _registry
    return reg


def reset(enabled=None):
    """Replace the process registry (tests; re-init after env changes).
    ``enabled``: None re-reads HVD_METRICS, True/False forces."""
    global _registry
    with _registry_lock:
        if enabled is None:
            _registry = None
        else:
            _registry = MetricsRegistry() if enabled else NullRegistry()
            return _registry
    return get_registry()


# ---------------------------------------------------------------------------
# tallies — the port's flat reads of a few families (``ops.eager.tally``,
# ``ops.quantization.tally``)
# ---------------------------------------------------------------------------

def flat_values(snapshot, names):
    """``{(name, *label values in label order): value}`` of the counter
    and gauge families ``names`` present in ``snapshot``."""
    out = {}
    metrics = snapshot.get("metrics", {})
    for name in names:
        entry = metrics.get(name)
        if entry is None or entry["type"] == "histogram":
            continue
        label_names = entry.get("labels", ())
        for v in entry.get("values", ()):
            key = (name,) + tuple(v["labels"].get(n, "")
                                  for n in label_names)
            out[key] = v["value"]
    return out


class Tally:
    """A flat read of some families of the process registry since the
    last ``reset()``: counters as their increase (children that did not
    move are left out), gauges as they stand. A registry replaced since
    the reset (``reset(enabled=...)``) counts from zero; a disabled one
    reads empty."""

    def __init__(self, counters, gauges=()):
        self._counters = tuple(counters)
        self._gauges = tuple(gauges)
        self._lock = threading.Lock()
        self._base = (None, {})  # guarded_by: _lock

    def reset(self):
        reg = get_registry()
        base = flat_values(reg.snapshot(max_events=0), self._counters)
        with self._lock:
            self._base = (reg, base)

    def read(self):
        reg = get_registry()
        snap = reg.snapshot(max_events=0)
        with self._lock:
            owner, base = self._base
        if owner is not reg:
            base = {}
        out = {}
        for key, value in flat_values(snap, self._counters).items():
            delta = value - base.get(key, 0.0)
            if delta:
                out[key] = delta
        out.update(flat_values(snap, self._gauges))
        return out


# ---------------------------------------------------------------------------
# merge — rank-0 aggregation semantics
# ---------------------------------------------------------------------------

def merge_snapshots(snapshots, max_events=None):
    """Sum per-rank snapshots into one aggregate snapshot.

    Counters and gauges sum; histograms sum counts element-wise (bounds
    must match exactly — ValueError otherwise, the explicit-merge
    contract); events concatenate ordered by ``epoch_us`` (the only
    cross-rank-comparable stamp). The result has the same schema as a
    single snapshot plus ``ranks`` (sorted list of contributing ranks).
    """
    snapshots = [s for s in snapshots if s]
    out_metrics = {}
    events = []
    ranks = []
    dropped = 0
    for snap in snapshots:
        if snap.get("rank") is not None:
            ranks.append(snap["rank"])
        dropped += snap.get("events_dropped", 0)
        events.extend(snap.get("events", ()))
        for name, entry in snap.get("metrics", {}).items():
            agg = out_metrics.get(name)
            if agg is None:
                agg = {"type": entry["type"], "help": entry.get("help", ""),
                       "labels": list(entry.get("labels", [])),
                       "values": []}
                if entry["type"] == "histogram":
                    agg["buckets"] = list(entry["buckets"])
                out_metrics[name] = agg
                by_label = agg["_by_label"] = {}
            else:
                if agg["type"] != entry["type"]:
                    raise ValueError(
                        f"metric {name!r}: type {entry['type']} vs "
                        f"{agg['type']} across ranks")
                if entry["type"] == "histogram" and \
                        list(entry["buckets"]) != agg["buckets"]:
                    raise ValueError(
                        f"histogram {name!r}: bucket bounds differ across "
                        f"ranks ({entry['buckets']} vs {agg['buckets']})")
                by_label = agg["_by_label"]
            for v in entry.get("values", ()):
                key = tuple(sorted(v.get("labels", {}).items()))
                cur = by_label.get(key)
                if cur is None:
                    cur = by_label[key] = {"labels": dict(key)}
                    if entry["type"] == "histogram":
                        cur["counts"] = [0] * len(v["counts"])
                        cur["sum"] = 0.0
                        cur["count"] = 0
                    else:
                        cur["value"] = 0.0
                if entry["type"] == "histogram":
                    if len(cur["counts"]) != len(v["counts"]):
                        raise ValueError(
                            f"histogram {name!r}: count vectors differ "
                            f"in length across ranks")
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], v["counts"])]
                    cur["sum"] += v["sum"]
                    cur["count"] += v["count"]
                else:
                    cur["value"] += v["value"]
    for agg in out_metrics.values():
        agg["values"] = list(agg.pop("_by_label").values())
    events.sort(key=lambda e: e.get("epoch_us", 0))
    if max_events is not None:
        events = events[-max_events:]
    return {"version": 1, "rank": None, "ranks": sorted(set(ranks)),
            "ts_us": _CLOCK.ts_us(),
            "epoch_us_at_ts0": _CLOCK.epoch_us_at_ts0,
            "metrics": out_metrics, "events": events,
            "events_dropped": dropped}


# ---------------------------------------------------------------------------
# Prometheus text exposition + parser
# ---------------------------------------------------------------------------

def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def render_prometheus(snapshot, extra_labels=None):
    """Snapshot (or merged aggregate) -> Prometheus text format 0.0.4."""
    extra = dict(extra_labels or {})
    lines = []
    for name, entry in snapshot.get("metrics", {}).items():
        kind = entry["type"]
        if entry.get("help"):
            lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for v in entry.get("values", ()):
            labels = dict(v.get("labels", {}))
            labels.update(extra)
            if kind == "histogram":
                cum = 0
                bounds = list(entry["buckets"]) + [float("inf")]
                for b, c in zip(bounds, v["counts"]):
                    cum += c
                    bl = dict(labels)
                    bl["le"] = _fmt_value(b)
                    lines.append(f"{name}_bucket{_fmt_labels(bl)} {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(v['sum'])}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {v['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} "
                    f"{_fmt_value(v['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text):
    """Parse Prometheus text format back into
    ``{name: {"type": ..., "samples": [(labels_dict, value)]}}`` —
    ``_bucket``/``_sum``/``_count`` series fold under their histogram's
    base name. Used by the round-trip tests and tools/hvd_top.py."""
    out = {}
    types = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            mname, _, mtype = rest.partition(" ")
            types[mname] = mtype.strip()
            out.setdefault(mname, {"type": mtype.strip(), "samples": []})
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value
        if "{" in line:
            name, _, rest = line.partition("{")
            labels_str, _, value_str = rest.rpartition("} ")
            labels = {}
            for part in _split_labels(labels_str):
                k, _, v = part.partition("=")
                labels[k] = v.strip('"').replace('\\"', '"') \
                    .replace("\\n", "\n").replace("\\\\", "\\")
        else:
            name, _, value_str = line.partition(" ")
            labels = {}
        value_str = value_str.strip()
        value = float("inf") if value_str == "+Inf" else float(value_str)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[:-len(suffix)] if name.endswith(suffix) else None
            if stem and types.get(stem) == "histogram":
                base = stem
                labels["__series__"] = suffix[1:]
                break
        out.setdefault(base, {"type": types.get(base, "untyped"),
                              "samples": []})
        out[base]["samples"].append((labels, value))
    return out


def _split_labels(s):
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    parts = []
    cur = []
    in_q = False
    prev = ""
    for ch in s:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p]


def histogram_quantile(bounds, counts, q):
    """Linear-interpolated quantile from (bounds, per-bucket counts) —
    the PromQL histogram_quantile, used by hvd_top for p50/p99 columns.
    Returns None for an empty histogram."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    edges = [0.0] + [float(b) for b in bounds]
    cum = 0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            lo = edges[i] if i < len(edges) else edges[-1]
            hi = (float(bounds[i]) if i < len(bounds)
                  else edges[-1] * 2 or 1.0)
            frac = (target - cum) / c
            return lo + (hi - lo) * frac
        cum += c
    return float(bounds[-1]) if bounds else None


# ---------------------------------------------------------------------------
# HTTP exposition server
# ---------------------------------------------------------------------------

class MetricsServer:
    """Background exposition thread on ``port``:

      * ``GET /metrics``       Prometheus text of the aggregate view
      * ``GET /metrics.json``  ``{"rank", "ranks": {r: snapshot},
                                  "aggregate": merged}``

    ``local_snapshot_fn()`` returns this rank's snapshot;
    ``remote_snapshots_fn()`` (rank 0 only) returns ``{rank: snapshot}``
    of the peers' piggybacked snapshots, or None/{} elsewhere. Serving
    runs entirely off the hot path — a scrape only reads instrument
    values under their own locks."""

    def __init__(self, port, local_snapshot_fn, remote_snapshots_fn=None,
                 host="0.0.0.0"):
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def do_GET(self):
                try:
                    if self.path.startswith("/metrics.json") or \
                            self.path == "/":
                        body = json.dumps(server._json_view()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = render_prometheus(
                            server._aggregate()).encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception:  # noqa: BLE001 — scrape must not kill
                    try:
                        self.send_error(500)
                    except Exception:  # noqa: BLE001
                        pass

        self._local_fn = local_snapshot_fn
        self._remote_fn = remote_snapshots_fn
        self._httpd = http.server.ThreadingHTTPServer((host, int(port)),
                                                      Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvd-metrics-http")
        self._thread.start()

    def _snapshots(self):
        local = self._local_fn()
        remotes = dict(self._remote_fn() or {}) if self._remote_fn else {}
        if local.get("rank") is not None:
            # the live local registry wins over any stale piggybacked
            # snapshot of the same rank
            remotes.pop(local["rank"], None)
        return local, remotes

    def _aggregate(self):
        local, remotes = self._snapshots()
        return merge_snapshots([local] + list(remotes.values()),
                               max_events=MetricsRegistry.EVENT_RING)

    def _json_view(self):
        local, remotes = self._snapshots()
        ranks = {str(local.get("rank", 0) or 0): local}
        for r, snap in remotes.items():
            ranks[str(r)] = snap
        return {"rank": local.get("rank"),
                "ranks": ranks,
                "aggregate": merge_snapshots(
                    [local] + list(remotes.values()),
                    max_events=MetricsRegistry.EVENT_RING)}

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


def serve_from_env(rank=0, remote_snapshots_fn=None):
    """Start a MetricsServer when HVD_METRICS_PORT is set: rank r binds
    base_port + r (every process of a local multi-process job gets its
    own endpoint). Returns the server, or None when unset/disabled."""
    port = _env("METRICS_PORT")
    if not port:
        return None
    reg = get_registry()
    if not reg.enabled:
        return None
    if reg.rank is None:
        reg.rank = rank
    try:
        return MetricsServer(int(port) + int(rank), reg.snapshot,
                             remote_snapshots_fn=remote_snapshots_fn)
    except OSError:
        return None


def metrics_interval():
    """Seconds between piggybacked snapshot pushes to rank 0
    (HVD_METRICS_INTERVAL, default 5.0; the negotiation cycle is the
    transport, so this bounds the aggregation staleness)."""
    try:
        return float(_env("METRICS_INTERVAL", "5.0"))
    except (TypeError, ValueError):
        return 5.0
