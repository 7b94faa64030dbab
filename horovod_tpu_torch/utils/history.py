"""Durable run history: an append-only on-disk WAL of the metrics
registry, the port's copy of ``horovod_tpu/utils/history.py``. The
on-disk format is the JAX package's, so either package's readers read
the other's segments.

A background thread, never the hot path, periodically appends a
delta-encoded snapshot of the registry plus the exact new slice of the
structured event ring to size-bounded rotating JSONL segments under
``HVD_HISTORY_DIR``:

* segment files ``history-rank<R>-<seq:06d>.jsonl``; each segment opens
  with a ``"t": "full"`` record (the complete ``metrics`` map) so any
  one segment stands alone; later records are ``"t": "delta"``, with
  only the families whose values changed since the previous record.
* each record carries ``events``, exactly the events appended to the
  registry ring since the previous record (recovered through the
  absolute index ``events_dropped + len(ring)``), and ``missed``, the
  count that rolled off the ring before capture.
* ``run-manifest.json`` (rank 0) carries the provenance block
  (``utils/provenance.py``).

A record is one ``write()`` of one line followed by flush and fsync, so
a crash tears at most the last line of the active segment; the readers
skip an unparseable line and keep everything before it.

Knobs: ``HVD_HISTORY`` (default on), ``HVD_HISTORY_DIR``,
``HVD_HISTORY_INTERVAL_S`` (default 30), ``HVD_HISTORY_MAX_MB`` (on-disk
budget per rank, default 64; segments rotate at a quarter of it and the
oldest is pruned).
"""

import atexit
import json
import os
import re
import tempfile
import threading
import time

from . import lockdep
from . import metrics as hvd_metrics
from . import provenance as hvd_provenance

HISTORY_VERSION = 1
SEGMENTS_KEPT = 4
MANIFEST_NAME = "run-manifest.json"
_SEGMENT_RE = re.compile(r"^history-rank(\d+)-(\d{6})\.jsonl$")


def history_dir():
    """Resolved history directory (HVD_HISTORY_DIR or a tmp default —
    the same resolution hvd_replay and the alert incident writer use)."""
    return hvd_metrics._env(
        "HISTORY_DIR", os.path.join(tempfile.gettempdir(), "hvd-history"))


def _history_enabled():
    return str(hvd_metrics._env("HISTORY", "1")).strip().lower() not in (
        "0", "false", "no", "off")


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class HistoryWriter:
    """Per-rank background history writer.

    Hot-path contract: ``poke(now)`` is a clock compare against a
    pre-computed deadline — no lock, no I/O, no snapshot — unless the
    interval elapsed, in which case it flips a flag under ``_cv`` and
    notifies the writer thread, which takes the registry snapshot and
    does all encoding and file I/O off-path. Errors never propagate to
    the instrumented caller: the first write failure marks the writer
    dead, bumps ``hvd_history_errors_total`` and emits a
    ``history_error`` event, and every later call is a no-op
    (observability must not take down the run it observes).

    ``now`` is whatever clock domain the caller ticks on —
    ``time.monotonic()`` in production, a virtual clock in drills —
    and must stay consistent per writer instance.
    """

    def __init__(self, dirpath, rank=None, interval_s=None, max_mb=None,
                 registry=None):
        self.dir = dirpath
        self.rank = 0 if rank is None else int(rank)
        if interval_s is None:
            interval_s = float(hvd_metrics._env("HISTORY_INTERVAL_S", 30.0))
        if max_mb is None:
            max_mb = float(hvd_metrics._env("HISTORY_MAX_MB", 64.0))
        self.interval_s = max(float(interval_s), 0.05)
        self.max_bytes = max(int(max_mb * 1e6), 1 << 16)
        self._registry = registry
        self._cv = threading.Condition()
        self._want = False       # guarded_by: _cv; a snapshot is due
        self._busy = False       # guarded_by: _cv; writer mid-record
        self._closed = False     # guarded_by: _cv
        self._dead = False       # guarded_by: _cv; permanent after error
        self._thread = None      # guarded_by: _cv; lazily started daemon
        self._next_due = 0.0     # caller-clock deadline; torn reads OK
        # Writer-thread-only state (no lock: single consumer).
        self._file = None
        self._seg = -1
        self._seg_bytes = 0
        self._seq = 0
        self._last_families = {}
        self._events_seen = 0
        self._manifest = None
        os.makedirs(self.dir, exist_ok=True)
        m = hvd_metrics.get_registry() if registry is None else registry
        self._m_snaps = m.counter(
            "hvd_history_records_total",
            "History records appended to the on-disk WAL.", labels=("kind",))
        self._m_bytes = m.counter(
            "hvd_history_bytes_total", "Bytes appended to history segments.")
        self._m_rot = m.counter(
            "hvd_history_rotations_total", "History segment rotations.")
        self._m_err = m.counter(
            "hvd_history_errors_total",
            "History write failures (the writer goes dead on the first).")
        if self.rank == 0:
            self._write_manifest()

    @property
    def enabled(self):
        return True

    # -- hot path --

    def poke(self, now=None):
        """Request a snapshot if the interval elapsed. Cheap enough for
        every instrumented step."""
        if now is None:
            now = time.monotonic()
        if now < self._next_due:
            return
        with self._cv:
            if self._dead or self._closed or now < self._next_due:
                return
            self._next_due = now + self.interval_s
            self._want = True
            self._ensure_thread()
            self._cv.notify_all()

    def flush(self, wait=True, timeout=10.0):
        """Force a snapshot now (fleet publish points, incident capture,
        process exit). With ``wait`` blocks until it is durably on disk."""
        with self._cv:
            if self._dead or self._closed:
                return
            self._want = True
            self._ensure_thread()
            self._cv.notify_all()
            if not wait:
                return
            deadline = time.monotonic() + timeout
            while (self._want or self._busy) and not self._dead:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._cv.wait(timeout=min(left, 0.1))

    def annotate(self, config=None, mesh=None, label=None, **extra):
        """Merge run context (mesh spec, config fingerprint, label,
        free-form fields) into the rank-0 manifest. Called once at
        setup time — not a hot path."""
        if self.rank != 0:
            return
        with self._cv:
            if self._dead or self._closed:
                return
        self._write_manifest(config=config, mesh=mesh, label=label, **extra)

    def close(self):
        """Final snapshot, then stop the writer thread and close the
        segment. Idempotent."""
        with self._cv:
            if self._closed:
                return
            if not self._dead and self._thread is not None:
                self._want = True
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10.0)
        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except Exception:  # noqa: BLE001 — best-effort shutdown
                pass

    # -- writer thread --

    def _ensure_thread(self):
        # guarded_by: _cv (callers hold it)
        if self._thread is None and not self._dead:
            self._thread = threading.Thread(
                target=self._writer_loop, name="hvd-history-writer",
                daemon=True)
            self._thread.start()

    def _writer_loop(self):
        while True:
            with self._cv:
                while not self._want and not self._closed:
                    self._cv.wait()
                if not self._want:
                    return  # closed with nothing pending
                self._want = False
                self._busy = True
            try:
                self._write_record()
            except Exception:  # noqa: BLE001 — writer goes dead, run survives
                self._m_err.inc()
                reg = (hvd_metrics.get_registry() if self._registry is None
                       else self._registry)
                reg.event("history_error", rank=self.rank)
                with self._cv:
                    self._dead = True
                    self._want = False
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()
                    if self._closed and not self._want:
                        return

    def _write_record(self):
        reg = (hvd_metrics.get_registry() if self._registry is None
               else self._registry)
        snap = reg.snapshot(max_events=hvd_metrics.MetricsRegistry.EVENT_RING)
        if self._file is None or self._seg_bytes >= \
                self.max_bytes // SEGMENTS_KEPT:
            self._rotate()
        # Delta-encode: a family is included iff its serialized entry
        # changed since the last record (counters monotone -> most
        # families change; gauges/histograms that sat still drop out).
        kind = "full" if self._seg_bytes == 0 else "delta"
        families = {}
        new_last = {}
        for name, entry in snap.get("metrics", {}).items():
            blob = json.dumps(entry, sort_keys=True)
            new_last[name] = blob
            if kind == "full" or self._last_families.get(name) != blob:
                families[name] = entry
        self._last_families = new_last
        # Exact-once event capture via the ring's absolute index:
        # total appended so far = events_dropped + len(ring).
        ring = snap.get("events", [])
        total = snap.get("events_dropped", 0) + len(ring)
        fresh = total - self._events_seen
        missed = max(fresh - len(ring), 0)
        events = ring[-min(fresh, len(ring)):] if fresh > 0 else []
        self._events_seen = total
        record = {"v": HISTORY_VERSION, "t": kind, "seq": self._seq,
                  "rank": self.rank, "ts_us": snap["ts_us"],
                  "epoch_us": reg.clock.epoch_us(snap["ts_us"]),
                  "metrics": families, "events": events, "missed": missed}
        line = json.dumps(record) + "\n"
        self._file.write(line)
        self._file.flush()
        os.fsync(self._file.fileno())
        self._seq += 1
        self._seg_bytes += len(line)
        self._m_snaps.labels(kind=kind).inc()
        self._m_bytes.inc(len(line))

    def _segment_path(self, seg):
        return os.path.join(
            self.dir, f"history-rank{self.rank}-{seg:06d}.jsonl")

    def _rotate(self):
        if self._file is not None:
            self._file.close()
            self._file = None
            self._m_rot.inc()
        self._seg += 1
        self._file = open(self._segment_path(self._seg), "w")
        self._seg_bytes = 0
        _fsync_dir(self.dir)
        # Prune beyond the keep budget (oldest first, this rank only).
        mine = sorted(
            seg for rank, seg in _scan_segments(self.dir)
            if rank == self.rank)
        for seg in mine[:-SEGMENTS_KEPT]:
            try:
                os.unlink(self._segment_path(seg))
            except OSError:
                pass

    def _write_manifest(self, config=None, mesh=None, label=None, **extra):
        prov = hvd_provenance.provenance_stamp(
            config=config, mesh=mesh, label=label)
        manifest = dict(self._manifest or {})
        manifest.setdefault("version", HISTORY_VERSION)
        manifest.setdefault(
            "run_id", f"{prov['unix_ms']:x}-{os.getpid()}")
        manifest.setdefault("interval_s", self.interval_s)
        merged = dict(manifest.get("provenance", ()))
        if merged.get("unix_ms"):
            # unix_ms stays the run start across annotate() rewrites.
            prov.pop("unix_ms", None)
        merged.update(prov)
        manifest["provenance"] = merged
        manifest.update(extra)
        self._manifest = manifest
        path = os.path.join(self.dir, MANIFEST_NAME)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(self.dir)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass


class NullHistoryWriter:
    """Absorbs every call when history is disabled (HVD_HISTORY=0)."""

    dir = None
    rank = None

    @property
    def enabled(self):
        return False

    def poke(self, now=None):
        pass

    def flush(self, wait=True, timeout=10.0):
        pass

    def annotate(self, **kw):
        pass

    def close(self):
        pass


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# module singleton
# ---------------------------------------------------------------------------

_writer = None  # guarded_by: _writer_lock
_writer_lock = lockdep.lock("history._writer_lock")


def get_writer():
    """The process-wide history writer (created on first use; honors
    HVD_HISTORY=0 with a no-op writer)."""
    global _writer
    w = _writer
    if w is None:
        with _writer_lock:
            if _writer is None:
                if _history_enabled():
                    rank = hvd_metrics.get_registry().rank
                    _writer = HistoryWriter(history_dir(), rank=rank)
                    atexit.register(_close_at_exit, _writer)
                else:
                    _writer = NullHistoryWriter()
            w = _writer
    return w


def _close_at_exit(writer):
    # Final flush+close so post-exit reconstruction sees the end state;
    # guarded per-instance so test resets don't double-close.
    writer.close()


def reset(enabled=None, dirpath=None, rank=None, **kw):
    """Replace the process writer (tests; re-init after env changes).
    ``enabled``: None re-reads HVD_HISTORY, True/False forces."""
    global _writer
    with _writer_lock:
        old, _writer = _writer, None
    if old is not None:
        old.close()
    if enabled is False:
        with _writer_lock:
            _writer = NullHistoryWriter()
            return _writer
    if enabled is True:
        with _writer_lock:
            _writer = HistoryWriter(
                dirpath or history_dir(), rank=rank, **kw)
            atexit.register(_close_at_exit, _writer)
            return _writer
    return get_writer()


def poke(now=None):
    get_writer().poke(now)


def flush(wait=True):
    get_writer().flush(wait=wait)


# ---------------------------------------------------------------------------
# reader — the JAX package's tools read the same files
# ---------------------------------------------------------------------------

def _scan_segments(dirpath):
    """-> sorted [(rank, seg), ...] for every segment file present."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    out = []
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2))))
    return sorted(out)


def list_ranks(dirpath):
    """Ranks with at least one history segment under ``dirpath``."""
    return sorted({rank for rank, _ in _scan_segments(dirpath)})


def load_manifest(dirpath):
    """The rank-0 run manifest, or None (absent / unreadable)."""
    try:
        with open(os.path.join(dirpath, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_records(dirpath, rank=0):
    """All records for ``rank`` in write order, torn-tail tolerant: an
    unparseable line (a crash mid-append) is skipped and counted in the
    returned ``(records, torn)`` pair."""
    records, torn = [], 0
    for seg_rank, seg in _scan_segments(dirpath):
        if seg_rank != rank:
            continue
        path = os.path.join(dirpath, f"history-rank{rank}-{seg:06d}.jsonl")
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if isinstance(rec, dict) and rec.get("t") in ("full", "delta"):
                records.append(rec)
    return records, torn


def iter_states(records):
    """Rematerialize full registry states from full+delta records.

    Yields ``{"seq", "ts_us", "epoch_us", "metrics"}`` with ``metrics``
    the complete family map as of that record (each record's families
    overlaid on the running state). Records before the first ``full``
    (possible when the opening segment was pruned) still accumulate —
    their families are simply all that survives of the earlier state.
    """
    state = {}
    for rec in records:
        if rec.get("t") == "full":
            state = dict(rec.get("metrics", {}))
        else:
            state.update(rec.get("metrics", {}))
        yield {"seq": rec.get("seq"), "ts_us": rec.get("ts_us"),
               "epoch_us": rec.get("epoch_us"), "metrics": dict(state)}


def read_events(records):
    """-> (events, missed_total): the exact concatenated event stream
    captured across records plus how many rolled off the ring uncaught."""
    events, missed = [], 0
    for rec in records:
        events.extend(rec.get("events", ()))
        missed += rec.get("missed", 0)
    return events, missed


def series(records, metric, labels=None):
    """Time series ``[(epoch_us, value), ...]`` for one metric family
    (sum across label children unless ``labels`` filters to matching
    children). Histogram families yield their ``sum`` field."""
    out = []
    want = dict(labels or {})
    for state in iter_states(records):
        entry = state["metrics"].get(metric)
        if entry is None:
            continue
        total = 0.0
        seen = False
        for val in entry.get("values", ()):
            lv = val.get("labels", {})
            if want and any(lv.get(k) != v for k, v in want.items()):
                continue
            seen = True
            total += val["sum"] if "counts" in val else val.get("value", 0.0)
        if seen:
            out.append((state["epoch_us"], total))
    return out
