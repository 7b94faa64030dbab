"""Admission control for the serving plane.

A bounded request queue in front of the engine, with the semantics of
``horovod_tpu/serving/queue.py``: requests carry their SLO tags
(deadline, temperature, token budget); ``submit`` refuses at a full
queue, ``pop`` rejects requests whose admission window passed while
they waited, and ``requeue`` puts cache-pressured work back at the head.
Rejections are counted on the queue (``rejected``, by reason); the
metrics, lock-order and request-tracing planes of the JAX package come
with the observability slice of the port.
"""

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Optional

from ..common import config


@dataclass
class Request:
    """One generation request with its SLO tags.

    ``deadline_s`` is a relative budget from arrival: a request still
    queued past it is rejected (reason=deadline) instead of occupying a
    slot it can no longer use. None means the queue-wide admission
    timeout (HVD_SERVE_ADMISSION_TIMEOUT_S) applies alone.
    """
    request_id: str
    prompt: tuple  # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    arrival_ts: float = field(default=0.0)


@dataclass
class RequestResult:
    """What the engine hands back per request."""
    request_id: str
    tokens: tuple  # generated token ids (prompt excluded)
    outcome: str  # completed | failed
    ttft_s: Optional[float] = None  # arrival -> first token
    finish_ts: float = 0.0
    reason: str = ""  # detail for outcome=failed


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
        self._lock = threading.Lock()
        self._q = deque()  # guarded by _lock
        self.rejected = Counter()  # reason -> count; _lock

    def __len__(self):
        with self._lock:
            return len(self._q)

    def submit(self, request):
        """Admit or reject; returns whether the request was queued."""
        now = self._clock()
        if not request.arrival_ts:
            request.arrival_ts = now
        with self._lock:
            if len(self._q) >= self.max_depth:
                self.rejected["queue_full"] += 1
                return False
            self._q.append(request)
        return True

    def pop(self):
        """Next admissible request, or None. Requests whose admission
        window (own deadline_s, else the queue timeout) expired while
        waiting are rejected here, not handed to the engine."""
        now = self._clock()
        while True:
            with self._lock:
                if not self._q:
                    return None
                req = self._q.popleft()
                budget = (req.deadline_s if req.deadline_s is not None
                          else self.admission_timeout_s)
                if now - req.arrival_ts > budget:
                    self.rejected["deadline"] += 1
                    continue
            return req

    def requeue(self, request):
        """Put an already-admitted request back at the head — the
        engine's cache-pressure path. Not a new admission: depth may
        transiently exceed max_depth rather than drop accepted work."""
        with self._lock:
            self._q.appendleft(request)
