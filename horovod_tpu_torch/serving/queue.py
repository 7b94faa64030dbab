"""Admission control for the serving plane.

A bounded request queue in front of the engine, with the semantics of
``horovod_tpu/serving/queue.py``: requests carry their SLO tags
(deadline, temperature, token budget); ``submit`` refuses at a full
queue, ``pop`` rejects requests whose admission window passed while
they waited, and ``requeue`` puts cache-pressured work back at the head.
Rejections are counted on the queue (``rejected``, by reason) and, as in
the JAX package, in the registry (``hvd_serve_requests_total``, the
``hvd_serve_queue_depth`` gauge) and the event ring (``serve_reject``).
``submit`` opens the request's trace (``serving/tracing.py``); ``pop``,
``requeue`` and a rejection drive its queue-wait spans.
"""

import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Optional

from ..common import config
from ..utils import lockdep
from ..utils import metrics as hvd_metrics
from . import tracing as serve_tracing


@dataclass
class Request:
    """One generation request with its SLO tags.

    ``deadline_s`` is a relative budget from arrival: a request still
    queued past it is rejected (reason=deadline) instead of occupying a
    slot it can no longer use. None means the queue-wide admission
    timeout (HVD_SERVE_ADMISSION_TIMEOUT_S) applies alone.

    ``trace`` is the request-path trace (``serving/tracing.py``) the
    queue attaches at submit.
    """
    request_id: str
    prompt: tuple  # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    arrival_ts: float = field(default=0.0)
    trace: Optional[object] = field(default=None, repr=False,
                                    compare=False)


@dataclass
class RequestResult:
    """What the engine hands back per request."""
    request_id: str
    tokens: tuple  # generated token ids (prompt excluded)
    outcome: str  # completed | failed
    ttft_s: Optional[float] = None  # arrival -> first token
    finish_ts: float = 0.0
    reason: str = ""  # detail for outcome=failed
    trace_id: Optional[str] = None  # the request's trace
    phase_ms: Optional[dict] = None  # latency decomposition by phase
    generation: Optional[int] = None  # weight generation that decoded it
    # router plane: which replica served it, and whether it was
    # re-dispatched after its first replica was lost
    replica: Optional[int] = None
    rerouted: bool = False


class AdmissionQueue:
    """Bounded FIFO with deadline-aware pop."""

    def __init__(self, max_depth=None, admission_timeout_s=None,
                 clock=time.monotonic):
        self.max_depth = (config.env_int("SERVE_QUEUE_DEPTH", 64)
                          if max_depth is None else max_depth)
        self.admission_timeout_s = (
            config.env_float("SERVE_ADMISSION_TIMEOUT_S", 10.0)
            if admission_timeout_s is None else admission_timeout_s)
        self._clock = clock
        self._lock = lockdep.lock("AdmissionQueue._lock")
        self._q = deque()  # guarded_by: _lock
        self.rejected = Counter()  # guarded_by: _lock; reason -> count
        reg = hvd_metrics.get_registry()
        self._m_requests = reg.counter(
            "hvd_serve_requests_total",
            "Serving requests by terminal outcome "
            "(completed/rejected/failed).", labels=("outcome",))
        self._m_depth = reg.gauge(
            "hvd_serve_queue_depth",
            "Requests waiting for a batch slot right now.")
        self._metrics = reg

    def __len__(self):
        with self._lock:
            return len(self._q)

    def queued_work_tokens(self):
        """Decode tokens the queue still owes: the router's load-snapshot
        work term (a queued 40-token request is five times the backlog of
        a queued 8-token one, which queue depth cannot see)."""
        with self._lock:
            return sum(r.max_new_tokens for r in self._q)

    def submit(self, request):
        """Admit or reject; returns whether the request was queued."""
        now = self._clock()
        if not request.arrival_ts:
            request.arrival_ts = now
        serve_tracing.begin(request)  # root + queue_wait spans open here
        with self._lock:
            full = len(self._q) >= self.max_depth
            if not full:
                self._q.append(request)
                self._m_depth.set(len(self._q))
        if full:
            self._reject(request, "queue_full")
            return False
        return True

    def pop(self):
        """Next admissible request, or None. Requests whose admission
        window (own deadline_s, else the queue timeout) expired while
        waiting are rejected here, not handed to the engine."""
        now = self._clock()
        while True:
            with self._lock:
                if not self._q:
                    self._m_depth.set(0)
                    return None
                req = self._q.popleft()
                self._m_depth.set(len(self._q))
            budget = (req.deadline_s if req.deadline_s is not None
                      else self.admission_timeout_s)
            if now - req.arrival_ts > budget:
                self._reject(req, "deadline")
                continue
            serve_tracing.trace_of(req).on_pop()
            return req

    def requeue(self, request):
        """Put an already-admitted request back at the head — the
        engine's cache-pressure path. Not a new admission: depth may
        transiently exceed max_depth rather than drop accepted work."""
        serve_tracing.trace_of(request).on_requeue()
        with self._lock:
            self._q.appendleft(request)
            self._m_depth.set(len(self._q))

    def _reject(self, request, reason):
        with self._lock:
            self.rejected[reason] += 1
        trace = serve_tracing.trace_of(request)
        trace.on_reject(reason)
        self._m_requests.labels(outcome="rejected").inc()
        self._metrics.event("serve_reject", request_id=request.request_id,
                            reason=reason, trace_id=trace.trace_id,
                            waited_s=self._clock() - request.arrival_ts
                            if request.arrival_ts else 0.0)
