"""Tracing plane: per-tensor spans and the always-on flight recorder,
the port's copy of ``horovod_tpu/utils/tracing.py``.

Every tensor's lifecycle through the eager coordination core
(``ops/eager.py``) becomes a span tree on the shared clock:

    enqueue -> negotiate (cycles waited, cache hit) -> fusion placement
            -> collective execute -> callback fire

Spans carry a readable ``trace_id`` minted at enqueue (``r<rank>.<seq>``)
and, once the coordinator has negotiated the collective, the negotiation
``cycle`` (the coordinator's response sequence number).
``(cycle, tensor)`` is the same on every rank for one collective, so the
per-rank span streams stitch into one cross-rank trace with no extra
wire traffic (``tools/hvd_postmortem.py`` reads the port's dumps as it
reads the JAX package's: the format is the same).

On top sits the **flight recorder**: fixed rings of finished spans
(``HVD_FLIGHT_SPANS``) and negotiation-cycle records
(``HVD_FLIGHT_CYCLES``). It is on unless ``HVD_TRACE=0``. On a lost
rank, a stall escalation, a lockdep finding or SIGTERM the rings dump
one JSON file per rank under ``HVD_FLIGHT_DIR``; the coordinator can
also solicit a remote rank's dump over the negotiation wire (the
``dump_requested`` response flag of ``ops/negotiation.py``).

Cost: a span open/close is two clock reads, a dict update and a deque
append under a lock. With ``HVD_TRACE=0`` every call lands on a shared
null object. Flight dumps also carry the memory plane's section
(``utils/memory.flight_section``: the HBM ledger and the compile
sites), None while nothing has been accounted.
"""

import atexit
import collections
import json
import os
import queue
import signal
import tempfile
import threading
import time

from ..common import hvd_logging as log
from ..common.config import env_bool, env_float, env_int, env_str
from . import lockdep
from . import metrics as metrics_mod

FLIGHT_VERSION = 1

# span stages, in lifecycle order (postmortem renders them in this order)
ENQUEUE = "enqueue"
NEGOTIATE = "negotiate"
FUSION = "fusion"
EXECUTE = "execute"
CALLBACK = "callback"
STEP = "step"
CYCLE = "cycle"          # coordinator-side: one _negotiate() pass
# serving-plane request-path stages (serving/tracing.py): every Request
# becomes one trace — a REQUEST root span from arrival to terminal
# outcome, QUEUE_WAIT children for each stay in the admission queue
# (re-queues under KV pressure open a fresh one), PREFILL for the
# prompt pass, DECODE for the slot residency (carries the slot attr the
# Perfetto export lanes on), one DECODE_TICK per fused engine step, and
# HEARTBEAT for the replica-liveness RPC. Span catalog: docs/tracing.md.
REQUEST = "request"
QUEUE_WAIT = "queue_wait"
PREFILL = "prefill"
DECODE = "decode"
DECODE_TICK = "decode_tick"
HEARTBEAT = "heartbeat"
# router plane (horovod_tpu/router/): one ROUTE span per dispatch
# decision — which replica won, under which policy, and whether the
# request was a reroute after a replica loss (docs/routing.md).
ROUTE = "route"
SERVE_STAGES = (REQUEST, QUEUE_WAIT, PREFILL, DECODE, DECODE_TICK,
                HEARTBEAT, ROUTE)
STAGES = (ENQUEUE, NEGOTIATE, FUSION, EXECUTE, CALLBACK, STEP,
          CYCLE) + SERVE_STAGES


class Span:
    """One timed stage of a tensor's lifecycle.

    Open spans are registered with the tracer; ``close()``/``abort()``
    moves them into the flight ring and feeds the ``hvd_span_seconds``
    histogram.  Both are idempotent (second call is a no-op), and the
    context-manager form closes on exit / aborts on exception.  Spans
    that must outlive a method (negotiate spans live across cycle RPCs)
    are stored on the owning object and closed explicitly.
    """

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "stage",
                 "tensor", "rank", "start_us", "end_us", "status", "attrs")

    def __init__(self, tracer, trace_id, span_id, parent_id, stage,
                 tensor, rank, start_us, attrs):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.stage = stage
        self.tensor = tensor
        self.rank = rank
        self.start_us = start_us
        self.end_us = None
        self.status = "open"
        self.attrs = attrs

    @property
    def open(self):
        return self.end_us is None

    def annotate(self, **attrs):
        self.attrs.update(attrs)
        return self

    def close(self, status="ok", **attrs):
        if self.end_us is not None:
            return self
        if attrs:
            self.attrs.update(attrs)
        self.status = status
        tracer = self._tracer
        self.end_us = tracer.clock.ts_us() if tracer is not None else \
            metrics_mod.shared_clock().ts_us()
        if tracer is not None:
            tracer._finish(self)
        return self

    def abort(self, reason=""):
        return self.close(status="error", error=str(reason))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort(f"{exc_type.__name__}: {exc}")
        else:
            self.close()
        return False

    def to_dict(self):
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "stage": self.stage, "rank": self.rank,
             "start_us": self.start_us, "end_us": self.end_us,
             "status": self.status}
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        if self.tensor is not None:
            d["tensor"] = self.tensor
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self):
        dur = "" if self.end_us is None else \
            f" {(self.end_us - self.start_us) / 1e3:.3f}ms"
        return (f"<Span {self.stage} {self.tensor or ''} "
                f"trace={self.trace_id} {self.status}{dur}>")


class _NullSpan:
    """Absorbs every span call when tracing is disabled."""

    trace_id = span_id = parent_id = tensor = None
    stage = status = ""
    rank = 0
    start_us = end_us = 0
    open = False

    def annotate(self, **attrs):
        return self

    def close(self, status="ok", **attrs):
        return self

    def abort(self, reason=""):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def to_dict(self):
        return {}


_NULL_SPAN = _NullSpan()


class Tracer:
    """Per-rank span factory + flight recorder.

    Mirrors the metrics registry's lifecycle (module singleton via
    ``get_tracer()``/``reset()``, null object when disabled).  Finished
    spans land in a fixed ring and feed the metrics plane: an
    ``hvd_span_seconds{stage=...}`` histogram on every close, plus a
    ``slow_span`` event when the duration crosses
    ``HVD_TRACE_SLOW_MS`` — which is how span data reaches hvd_top and
    rank-0 aggregation without new transport.
    """

    def __init__(self, rank=None, clock=None, span_ring=None,
                 cycle_ring=None, slow_ms=None, dump_dir=None):
        self.rank = rank
        self.clock = clock or metrics_mod.shared_clock()
        self._lock = lockdep.lock("Tracer._lock")
        self._seq = 0       # guarded_by: _lock
        self._span_seq = 0  # guarded_by: _lock
        # guarded_by: _lock (finished-span flight ring)
        self._spans = collections.deque(
            maxlen=span_ring or env_int("FLIGHT_SPANS", 2048))
        # guarded_by: _lock (coordinator cycle ring)
        self._cycles = collections.deque(
            maxlen=cycle_ring or env_int("FLIGHT_CYCLES", 64))
        self._open = collections.OrderedDict()  # guarded_by: _lock
        self._last_trace = {}     # guarded_by: _lock; tensor -> trace_id
        self._spans_dropped = 0   # guarded_by: _lock
        self._slow_us = (slow_ms if slow_ms is not None
                         else env_float("TRACE_SLOW_MS", 100.0)) * 1000.0
        self._dump_dir = dump_dir or env_str(
            "FLIGHT_DIR",
            os.path.join(tempfile.gettempdir(), "hvd-flight"))
        self._last_dump_path = None
        # (registry, hvd_span_seconds family, {stage: child}) of the
        # newest registry: a span's close observes without a lookup
        self._hist = None

    @property
    def enabled(self):
        return True

    # -- ids --

    def new_trace_id(self, tensor=None):
        """Mint a readable trace id: ``r<rank>.<seq>``.  The id is local
        (cross-rank identity is (cycle, tensor)); recording it per tensor
        lets the stall path name the blocking tensor's trace."""
        with self._lock:
            self._seq += 1
            tid = f"r{self.rank if self.rank is not None else '?'}.{self._seq}"
            if tensor is not None:
                self._last_trace[tensor] = tid
        return tid

    def new_trace_ids(self, tensors):
        """``new_trace_id`` for each of ``tensors``, under one lock."""
        rank = self.rank if self.rank is not None else "?"
        out = []
        with self._lock:
            for tensor in tensors:
                self._seq += 1
                tid = f"r{rank}.{self._seq}"
                self._last_trace[tensor] = tid
                out.append(tid)
        return out

    def trace_id_for(self, tensor):
        """Latest trace id minted for ``tensor`` (None if never traced)."""
        return self._last_trace.get(tensor)

    # -- spans --

    def span(self, stage, tensor=None, trace_id=None, parent=None, **attrs):
        """Open a span.  Every opened span must reach ``close()`` or
        ``abort()`` (use the context-manager form when the extent is
        lexical)."""
        if trace_id is None:
            if tensor is not None:
                # one atomic get (entries are append-only, so a stale
                # id is benign)
                trace_id = self._last_trace.get(tensor)
            if trace_id is None:
                trace_id = self.new_trace_id(tensor)
        parent_id = (parent.span_id if isinstance(parent, (Span, _NullSpan))
                     else parent)
        with self._lock:
            self._span_seq += 1
            span_id = self._span_seq
        s = Span(self, trace_id, span_id, parent_id, stage, tensor,
                 self.rank, self.clock.ts_us(), attrs)
        with self._lock:
            self._open[span_id] = s
        return s

    def open_many(self, stage, specs):
        """Open one span of ``stage`` for each ``(tensor, trace_id,
        parent, attrs)`` of ``specs`` (``attrs`` a dict the span keeps),
        on one clock read and one lock: the eager core's per-tensor
        spans of a fused group. Returns the spans in order."""
        start = self.clock.ts_us()
        out = []
        with self._lock:
            for tensor, trace_id, parent, attrs in specs:
                self._span_seq += 1
                parent_id = (parent.span_id
                             if isinstance(parent, (Span, _NullSpan))
                             else parent)
                s = Span(self, trace_id, self._span_seq, parent_id, stage,
                         tensor, self.rank, start, attrs)
                self._open[s.span_id] = s
                out.append(s)
        return out

    def close_many(self, spans, attrs_each=None, status="ok", **attrs):
        """Close ``spans`` on one clock read and one lock, as ``close``
        would each (already-closed ones are left alone); ``attrs_each``
        gives each span attrs of its own, ``attrs`` all of them."""
        end = self.clock.ts_us()
        done = []
        for i, s in enumerate(spans):
            if not isinstance(s, Span) or s.end_us is not None:
                continue
            if s._tracer is not self:
                s.close(status, **attrs)
                continue
            if attrs:
                s.attrs.update(attrs)
            if attrs_each is not None:
                s.attrs.update(attrs_each[i])
            s.status = status
            s.end_us = end
            done.append(s)
        if done:
            self._finish_many(done)

    def _finish(self, span):
        self._finish_many((span,))

    def _finish_many(self, spans):
        with self._lock:
            for span in spans:
                self._open.pop(span.span_id, None)
                if len(self._spans) == self._spans.maxlen:
                    self._spans_dropped += 1
                # the closed Span itself: it becomes a dict when read
                self._spans.append(span)
        reg = metrics_mod.get_registry()
        if not reg.enabled:
            return
        hist = self._hist
        if hist is None or hist[0] is not reg:
            hist = self._hist = (reg, reg.histogram(
                "hvd_span_seconds",
                "Duration of tracing-plane spans, by lifecycle stage.",
                labels=("stage",)), {})
        _, fam, children = hist
        by_stage = {}
        for span in spans:
            dur_us = span.end_us - span.start_us
            by_stage.setdefault(span.stage, []).append(dur_us / 1e6)
            if dur_us >= self._slow_us and span.status != "open":
                reg.event("slow_span", stage=span.stage,
                          tensor=span.tensor, trace_id=span.trace_id,
                          dur_ms=round(dur_us / 1e3, 3),
                          status=span.status)
        for stage, secs in by_stage.items():
            child = children.get(stage)
            if child is None:
                child = children[stage] = fam.labels(stage=stage)
            child.observe_many(secs)

    def open_spans(self):
        with self._lock:
            return list(self._open.values())

    def spans(self):
        with self._lock:
            spans = list(self._spans)
        return [s.to_dict() for s in spans]

    # -- negotiation-cycle records --

    def record_cycle(self, **fields):
        """Append one negotiation-cycle record (req_id, applied seq,
        metas/hits counts ...) to the cycle ring — the postmortem's 'last
        N cycles' reconstruction reads these."""
        rec = {"ts_us": self.clock.ts_us()}
        rec.update(fields)
        with self._lock:
            self._cycles.append(rec)
        return rec

    def cycles(self):
        with self._lock:
            return list(self._cycles)

    # -- flight dump --

    def flight_snapshot(self, reason=""):
        """JSON-serializable flight-recorder state: finished + still-open
        spans, cycle records, and the metrics event ring (stalls, chaos
        injections, lost ranks — the context the spans ran in)."""
        with self._lock:
            spans = list(self._spans)
            open_spans = [s.to_dict() for s in self._open.values()]
            cycles = list(self._cycles)
            dropped = self._spans_dropped
        spans = [s.to_dict() for s in spans]
        reg = metrics_mod.get_registry()
        from . import memory as memory_mod
        return {
            "version": FLIGHT_VERSION,
            "rank": self.rank,
            "reason": reason,
            "ts_us": self.clock.ts_us(),
            "epoch_us_at_ts0": self.clock.epoch_us_at_ts0,
            "spans": spans,
            "open_spans": open_spans,
            "cycles": cycles,
            "spans_dropped": dropped,
            "events": reg.events(),
            "memory": memory_mod.flight_section(),
        }

    def dump(self, reason="", path=None):
        """Write the flight snapshot to ``HVD_FLIGHT_DIR`` (one file per
        rank, later dumps supersede — the rings only grow).  Never raises:
        the dump runs on failure paths that must still propagate their
        original error."""
        snap = self.flight_snapshot(reason)
        if path is None:
            rank = self.rank if self.rank is not None else 0
            path = os.path.join(self._dump_dir, f"flight-rank{rank}.json")
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(snap, f)
        except OSError as exc:
            log.warning("flight recorder: dump to %s failed: %s", path, exc)
            return None
        self._last_dump_path = path
        reg = metrics_mod.get_registry()
        reg.counter(
            "hvd_flight_dumps_total",
            "Flight-recorder dumps written, by trigger.",
            labels=("reason",)).labels(reason=reason or "manual").inc()
        log.warning("flight recorder: dumped %d spans / %d cycles to %s "
                    "(reason: %s)", len(snap["spans"]), len(snap["cycles"]),
                    path, reason or "manual")
        return path


class NullTracer:
    """HVD_TRACE=0: every call is a no-op on shared null objects."""

    rank = None
    enabled = False
    clock = metrics_mod.shared_clock()

    def new_trace_id(self, tensor=None):
        return None

    def trace_id_for(self, tensor):
        return None

    def span(self, stage, tensor=None, trace_id=None, parent=None, **attrs):
        return _NULL_SPAN

    def new_trace_ids(self, tensors):
        return [None] * len(tensors)

    def open_many(self, stage, specs):
        return [_NULL_SPAN] * len(specs)

    def close_many(self, spans, attrs_each=None, status="ok", **attrs):
        pass

    def open_spans(self):
        return []

    def spans(self):
        return []

    def record_cycle(self, **fields):
        return None

    def cycles(self):
        return []

    def flight_snapshot(self, reason=""):
        return {"version": FLIGHT_VERSION, "rank": None, "reason": reason,
                "ts_us": self.clock.ts_us(),
                "epoch_us_at_ts0": self.clock.epoch_us_at_ts0,
                "spans": [], "open_spans": [], "cycles": [],
                "spans_dropped": 0, "events": [], "disabled": True}

    def dump(self, reason="", path=None):
        return None


_tracer = None  # guarded_by: _tracer_lock
_tracer_lock = lockdep.lock("tracing._tracer_lock")


def get_tracer():
    """The process-wide tracer (created on first use; ``HVD_TRACE=0``
    yields a no-op tracer).  Rank is adopted lazily via ``set_rank`` once
    hvd.init() knows it — spans minted before then carry rank None."""
    global _tracer
    t = _tracer
    if t is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer() if env_bool("TRACE", True) \
                    else NullTracer()
            t = _tracer
    return t


def reset(enabled=None, rank=None):
    """Replace the process tracer (tests; re-init after env changes).
    ``enabled``: None re-reads HVD_TRACE, True/False forces."""
    global _tracer
    with _tracer_lock:
        if enabled is None:
            _tracer = None
        else:
            _tracer = Tracer(rank=rank) if enabled else NullTracer()
            return _tracer
    t = get_tracer()
    if rank is not None:
        set_rank(rank)
    return t


def set_rank(rank):
    """Stamp the rank on the live tracer (idempotent; called from
    hvd.init once the rank is known)."""
    t = get_tracer()
    if t.enabled:
        t.rank = rank
    return t


_sigterm_prev = None
_sigterm_installed = False
# (signum, redeliver) from the SIGTERM handler to the dump thread. A
# handler runs on the main thread between two bytecodes, possibly inside
# a ``with self._lock:`` of the tracer, the registry or a metric family:
# it must take none of them. ``SimpleQueue.put`` is reentrant; the dump
# thread takes the locks as any other thread does, once the main thread
# leaves its critical section.
_dump_requests = None
_dumps_asked = 0   # written by the handler only
_dumps_done = 0    # written by the dump thread only


def _dump_worker():
    global _dumps_done
    while True:
        signum, redeliver = _dump_requests.get()
        try:
            get_tracer().dump("sigterm")
        except Exception as exc:  # noqa: BLE001 — the process must still die
            log.warning("flight recorder: SIGTERM dump failed: %s", exc)
        _dumps_done += 1
        if redeliver:
            # the handler restored SIG_DFL: the process dies with 143
            os.kill(os.getpid(), signum)


def _start_dump_thread():
    global _dump_requests, _dumps_asked, _dumps_done
    _dump_requests = queue.SimpleQueue()
    _dumps_asked = _dumps_done = 0
    threading.Thread(target=_dump_worker, name="hvd-sigterm-dump",
                     daemon=True).start()


def wait_signal_dumps(timeout=10.0):
    """Block until every dump a SIGTERM asked for is on disk (or
    ``timeout`` seconds). Runs at interpreter exit; call it only where
    the calling thread holds no tracer or metrics lock. Returns True
    when none is pending."""
    deadline = time.monotonic() + timeout
    while _dumps_done < _dumps_asked:
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.005)
    return True


def install_signal_dump():
    """Chain a SIGTERM handler that has the flight recorder dumped before
    the previous disposition runs — a preempted/killed worker leaves its
    last seconds on disk.  The handler takes no lock: it hands the dump
    to a daemon thread.  No-op off the main thread (signal.signal raises
    there) or under ``HVD_FLIGHT_SIGTERM=0``.  Returns True when
    (already) installed."""
    global _sigterm_prev, _sigterm_installed
    if _sigterm_installed:
        return True
    if not env_bool("FLIGHT_SIGTERM", True):
        return False
    if threading.current_thread() is not threading.main_thread():
        return False

    def _handler(signum, frame):
        global _dumps_asked
        prev = _sigterm_prev
        owner = not callable(prev) and signal.getsignal(signum) is _handler
        if owner:
            # outermost owner of the signal: the dump thread re-delivers
            # it under the default disposition, so the process still
            # dies with the conventional 143 status, after the dump
            signal.signal(signum, signal.SIG_DFL)
        _dumps_asked += 1
        _dump_requests.put((signum, owner))
        if callable(prev):
            prev(signum, frame)
        # else, when not the owner, a later-installed handler (the
        # Checkpointer's preemption flag) wrapped this one and owns
        # process fate — dump only

    try:
        prev = signal.getsignal(signal.SIGTERM)
        _start_dump_thread()
        # a forked child inherits the handler but not the thread
        os.register_at_fork(after_in_child=_start_dump_thread)
        atexit.register(wait_signal_dumps)
        _sigterm_prev = prev
        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):  # non-main thread / exotic runtime
        return False
    _sigterm_installed = True
    return True


def dump_on_failure(reason):
    """One-line hook for failure paths: dump the live tracer's flight
    ring, never raise.  Returns the dump path (None when disabled)."""
    return get_tracer().dump(reason)


def flight_dir():
    """The directory flight dumps land in (``HVD_FLIGHT_DIR``)."""
    t = get_tracer()
    if t.enabled:
        return t._dump_dir
    return env_str("FLIGHT_DIR",
                   os.path.join(tempfile.gettempdir(), "hvd-flight"))


def write_remote_dump(payload, rank=None):
    """Persist a flight snapshot solicited from a remote rank over the
    control plane (the coordinator side of the ``dump_requested``
    protocol — file I/O lives here, not in the wire modules).  Returns
    the path, or None on a malformed payload / IO failure; never
    raises."""
    if not isinstance(payload, dict):
        return None
    if rank is None:
        rank = payload.get("rank")
    name = f"flight-rank{rank if rank is not None else 'unknown'}.json"
    path = os.path.join(flight_dir(), name)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
    except (OSError, TypeError, ValueError) as exc:
        log.warning("flight recorder: persisting rank %s dump failed: %s",
                    rank, exc)
        return None
    log.warning("flight recorder: persisted remote dump from rank %s "
                "to %s", rank, path)
    return path
