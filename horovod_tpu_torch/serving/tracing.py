"""Request-path tracing for the serving plane, the port's copy of
``horovod_tpu/serving/tracing.py``.

Every ``Request`` the admission queue accepts becomes one trace on the
tracing plane's shared clock (``utils/tracing.py``): a ``request`` root
span from arrival to terminal outcome, with a child span for each phase
the request spent time in:

    arrive -> queue_wait -> admit -> prefill -> decode_tick* ->
        retire | reject | evict

``queue_wait`` reopens on every KV-pressure requeue (the reopened span
carries ``requeue=True`` and its time is accounted apart). The fused
decode step is one ``decode_tick`` span per engine step, not one per
slot, and its duration is credited to every request active during it.

On retire the trace closes with a per-request decomposition in
milliseconds::

    queue_wait  submit -> first admission pop
    requeue     every later KV-pressure wait in the queue
    prefill     prompt pass + first-token sample
    decode      sum of the decode ticks the request was active for
    scheduler_stall  the residual: total minus everything above

The phases sum to the total exactly. The decomposition lands in the
root span's ``phase_ms`` attrs (what ``tools/hvd_slo.py`` digests out of
a flight dump), the ``hvd_serve_phase_seconds{phase}`` histogram and the
engine's ``serve_retire`` event.

Default on; ``HVD_SERVE_TRACE=0`` (or ``HVD_TRACE=0``) reduces every
call here to a shared null object.
"""

from ..common import config
from ..utils import metrics as hvd_metrics
from ..utils import tracing as hvd_tracing

# phase keys of the per-request decomposition, reporting order
PHASES = ("queue_wait", "requeue", "prefill", "decode",
          "scheduler_stall")


def enabled():
    """Request tracing rides the tracing plane: both HVD_TRACE and
    HVD_SERVE_TRACE (default on) must be up."""
    return bool(hvd_tracing.get_tracer().enabled and
                config.env_bool("SERVE_TRACE", True))


def phase_histogram(reg=None):
    """The shared per-phase latency histogram (idempotent — the
    registry dedupes by name)."""
    reg = reg if reg is not None else hvd_metrics.get_registry()
    return reg.histogram(
        "hvd_serve_phase_seconds",
        "Per-request latency decomposition: seconds spent in each "
        "request-path phase (queue_wait/requeue/prefill/decode/"
        "scheduler_stall).", labels=("phase",),
        buckets=hvd_metrics.SERVE_PHASE_BUCKETS)


class RequestTrace:
    """Span lifecycle + phase accounting for one request.

    Created by ``begin()`` at submit; the queue drives the wait spans
    (pop/requeue/reject), the engine drives prefill/decode/retire.
    Spans are stored on the object and closed by the next lifecycle
    call; a crash mid-request leaves them open on purpose, which is how
    a flight dump shows in-flight work.
    """

    __slots__ = ("_tracer", "request_id", "trace_id", "root", "slot",
                 "requeues", "closed", "_wait", "_prefill", "_decode",
                 "_phase_us")

    def __init__(self, tracer, request_id):
        self._tracer = tracer
        self.request_id = request_id
        self.trace_id = tracer.new_trace_id(request_id)
        self.root = None
        self.slot = None
        self.requeues = 0
        self.closed = False
        self._wait = None
        self._prefill = None
        self._decode = None
        self._phase_us = {"queue_wait": 0.0, "requeue": 0.0,
                          "prefill": 0.0, "decode": 0.0,
                          "scheduler_stall": 0.0}

    # -- queue side --

    def on_submit(self):
        self.root = self._tracer.span(
            hvd_tracing.REQUEST, tensor=self.request_id,
            trace_id=self.trace_id)
        self._wait = self._tracer.span(
            hvd_tracing.QUEUE_WAIT, tensor=self.request_id,
            trace_id=self.trace_id, parent=self.root)
        return self

    def on_pop(self):
        """Admission pop: close the active wait span, crediting its
        duration to queue_wait (first wait) or requeue (later ones)."""
        w, self._wait = self._wait, None
        if w is not None:
            w.close()
            phase = "requeue" if w.attrs.get("requeue") else "queue_wait"
            self._phase_us[phase] += (w.end_us or 0) - w.start_us

    def on_requeue(self, reason="kv_pressure"):
        """KV pressure bounced the request back: reopen the wait lane,
        marked so its time is accounted as requeue, not queue_wait."""
        self.requeues += 1
        self._wait = self._tracer.span(
            hvd_tracing.QUEUE_WAIT, tensor=self.request_id,
            trace_id=self.trace_id, parent=self.root, requeue=True,
            reason=reason)

    def on_reject(self, reason):
        """Terminal rejection (queue_full / deadline / too_long):
        close out whatever is open and stamp the decomposition."""
        self.on_pop()
        return self._close("rejected", reason, status="error")

    # -- engine side --

    def on_prefill_start(self, slot, prompt_len):
        self.slot = slot
        self._prefill = self._tracer.span(
            hvd_tracing.PREFILL, tensor=self.request_id,
            trace_id=self.trace_id, parent=self.root, slot=slot,
            prompt_len=prompt_len)

    def on_prefill_end(self, ttft_s=None):
        """Prefill readback done: close the prefill span and open the
        slot-residency decode span (the Perfetto slot lane)."""
        p, self._prefill = self._prefill, None
        if p is not None:
            if ttft_s is not None:
                p.annotate(ttft_s=round(ttft_s, 6))
            p.close()
            self._phase_us["prefill"] += (p.end_us or 0) - p.start_us
        self._decode = self._tracer.span(
            hvd_tracing.DECODE, tensor=self.request_id,
            trace_id=self.trace_id, parent=self.root, slot=self.slot)

    def on_decode_tick(self, dur_us):
        """One fused engine step covered this request: attribute the
        tick's duration to its decode phase."""
        self._phase_us["decode"] += dur_us

    def annotate(self, **attrs):
        """Stamp attrs on the request's root span — e.g. the weight
        generation that admitted it."""
        if self.root is not None:
            self.root.annotate(**attrs)

    def on_retire(self, outcome, reason="", tokens=0):
        if self._decode is not None:
            self._decode.annotate(tokens=tokens)
        return self._close(outcome, reason,
                           status="ok" if outcome == "completed"
                           else "error")

    # -- close + decomposition --

    def _close(self, outcome, reason, status):
        if self.closed:
            return self.phase_ms()
        self.closed = True
        for s in (self._wait, self._prefill, self._decode):
            if s is not None and s.open:
                s.close()
        self._wait = self._prefill = self._decode = None
        if self.root is not None:
            total_us = max(
                (self._tracer.clock.ts_us() - self.root.start_us), 0.0)
            self._phase_us["scheduler_stall"] = max(
                total_us - sum(self._phase_us.values()), 0.0)
        phases = self.phase_ms()
        if self.root is not None:
            self.root.close(
                status=status, outcome=outcome, reason=reason,
                slot=self.slot, requeues=self.requeues,
                phase_ms=phases)
        hist = phase_histogram()
        for phase, ms in phases.items():
            hist.labels(phase=phase).observe(ms / 1e3)
        return phases

    def phase_ms(self):
        return {k: round(v / 1e3, 3) for k, v in self._phase_us.items()}


class _NullRequestTrace:
    """Absorbs the whole lifecycle when request tracing is off."""

    request_id = trace_id = slot = None
    requeues = 0
    closed = False

    def on_submit(self):
        return self

    def on_pop(self):
        pass

    def on_requeue(self, reason="kv_pressure"):
        pass

    def on_reject(self, reason):
        return {}

    def on_prefill_start(self, slot, prompt_len):
        pass

    def on_prefill_end(self, ttft_s=None):
        pass

    def on_decode_tick(self, dur_us):
        pass

    def annotate(self, **attrs):
        pass

    def on_retire(self, outcome, reason="", tokens=0):
        return {}

    def phase_ms(self):
        return {}


_NULL_TRACE = _NullRequestTrace()


def begin(request):
    """Mint the trace for a freshly submitted request. Idempotent for a
    live trace (a requeued request keeps its spans), but a CLOSED trace
    — the same Request object resubmitted, as the bench arms do — gets
    a fresh one: each submission is its own lifecycle. Called by
    AdmissionQueue.submit, so direct engine users get traced too."""
    trace = getattr(request, "trace", None)
    if trace is not None and trace is not _NULL_TRACE and \
            not trace.closed:
        return trace
    if not enabled():
        request.trace = _NULL_TRACE
        return _NULL_TRACE
    trace = RequestTrace(hvd_tracing.get_tracer(),
                         request.request_id).on_submit()
    request.trace = trace
    return trace


def trace_of(request):
    """The request's trace, or the shared null object — callers never
    branch on enablement."""
    trace = getattr(request, "trace", None)
    return trace if trace is not None else _NULL_TRACE


# -- engine-step spans ------------------------------------------------------

def heartbeat_span(**attrs):
    """One span per replica-liveness RPC (serving/replica.py): the
    heartbeat is a real per-step stall source — a slow control plane
    shows up here, not as mystery scheduler_stall."""
    if not enabled():
        return hvd_tracing._NULL_SPAN
    return hvd_tracing.get_tracer().span(hvd_tracing.HEARTBEAT, **attrs)


def route_span(**attrs):
    """One span per router dispatch decision (``router/core.py``): which
    replica won, under which policy or affinity path, and whether it was
    a reroute after a replica loss; closed at once, so the request's
    trace records where it was sent and why."""
    if not enabled():
        return hvd_tracing._NULL_SPAN
    return hvd_tracing.get_tracer().span(hvd_tracing.ROUTE, **attrs)


def tick_span(**attrs):
    """One span per fused decode step (the engine-wide lane)."""
    if not enabled():
        return hvd_tracing._NULL_SPAN
    return hvd_tracing.get_tracer().span(hvd_tracing.DECODE_TICK,
                                         **attrs)


def finish_tick(span, active_slots=0):
    """Close a decode-tick span; returns its duration in µs (0 when
    tracing is off) and emits a ``slow_decode_tick`` event past
    HVD_SERVE_TRACE_SLOW_TICK_MS — the per-step analogue of the
    tracer's slow_span escalation."""
    span.close(active=active_slots)
    if span.end_us is None:
        return 0.0
    dur_us = span.end_us - span.start_us
    slow_ms = config.env_float("SERVE_TRACE_SLOW_TICK_MS", 250.0)
    if dur_us >= slow_ms * 1e3:
        reg = hvd_metrics.get_registry()
        if reg.enabled:
            reg.event("slow_decode_tick", active=active_slots,
                      dur_ms=round(dur_us / 1e3, 3))
    return dur_us
