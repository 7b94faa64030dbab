"""Chaos plane: deterministic fault injection for the control-plane
transport (``run/network.py``), the port's copy of
``horovod_tpu/run/chaos.py``: one spec and seed give the same decision
sequence in both packages (the per-rule RNG is seeded alike).

The reference framework's only failure story is stall *warnings*; proving
bounded-time recovery (backoff + req_id dedup in the negotiation protocol,
the coordinator's liveness ledger, the elastic supervisor's auto-shrink)
requires faults that can be injected on demand and replayed exactly. This
module turns the HMAC-TCP transport into a drill range: every service can
drop, delay, duplicate or truncate messages and reset connections, keyed
by (service, message type) and driven by a seeded per-rule RNG so a drill
is reproducible bit-for-bit across runs and across the processes of one
job (every worker inherits the same ``HVD_CHAOS_*`` environment).

Spec grammar (``HVD_CHAOS_SPEC``, semicolon-separated rules)::

    service:message:fault:prob[:count]

- ``service``  fnmatch pattern on the service name ("hvd.negotiation",
  "*" for all services)
- ``message``  fnmatch pattern on the message CLASS name being considered
  (the request class for request-side faults, the response class for
  response-side faults)
- ``fault``    one of FAULTS below
- ``prob``     per-message injection probability in [0, 1]
- ``count``    optional cap on total injections for this rule (omitted =
  unlimited)

Fault matrix (docs/chaos.md has the recovery story for each):

    drop_request       connection severed before the handler runs — the
                       request is lost on the way in, no state applied
    delay_request      the handler runs ``HVD_CHAOS_DELAY_MS`` late
    dup_request        the handler runs TWICE (network-level duplicate
                       delivery) — only dedup'ing services survive this
    drop_response      handler runs (state applied!), response severed —
                       the lost-response class of bug
    delay_response     response written ``HVD_CHAOS_DELAY_MS`` late
    truncate_response  half the wire frame, then severed (mid-message
                       disconnect, exercises Wire's EOF handling)
    reset              connection reset (RST via SO_LINGER 0) instead of
                       a response — the peer sees ECONNRESET

Injection is entirely server-side (BasicService's handler loop): that is
where apply-then-lose vs lose-before-apply can be distinguished, which is
the distinction every recovery bug in this class hinges on. Determinism:
each rule gets its own ``random.Random`` seeded from
``HVD_CHAOS_SEED ^ crc32(rule text)`` — Python's ``hash()`` is
per-process randomized and must not be used here.
"""

import fnmatch
import random
import zlib

from ..common import hvd_logging as log
from ..common.config import env_float, env_int, env_str
from ..utils import metrics as hvd_metrics
from ..utils import tracing as hvd_tracing

FAULTS = ("drop_request", "delay_request", "dup_request",
          "drop_response", "delay_response", "truncate_response", "reset")

# faults evaluated before the handler runs vs. after
_REQUEST_FAULTS = ("drop_request", "delay_request", "dup_request")
_RESPONSE_FAULTS = ("drop_response", "delay_response",
                    "truncate_response", "reset")


class ChaosRule:
    """One parsed spec rule plus its private deterministic RNG."""

    __slots__ = ("service", "message", "fault", "prob", "count",
                 "injected", "_rng", "text")

    def __init__(self, service, message, fault, prob, count, seed, text):
        if fault not in FAULTS:
            raise ValueError(
                f"unknown chaos fault {fault!r} (valid: {', '.join(FAULTS)})")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"chaos probability {prob} outside [0, 1]")
        self.service = service
        self.message = message
        self.fault = fault
        self.prob = prob
        self.count = count          # None = unlimited
        self.injected = 0
        self.text = text
        # crc32, NOT hash(): decisions must replay identically in every
        # process of the job and across runs with the same seed
        self._rng = random.Random(seed ^ zlib.crc32(text.encode()))

    def fire(self):
        """Deterministic Bernoulli draw; counts an injection on True."""
        if self.count is not None and self.injected >= self.count:
            return False
        if self._rng.random() >= self.prob:
            return False
        self.injected += 1
        return True


def parse_spec(spec, seed):
    """Parse ``HVD_CHAOS_SPEC`` into ChaosRule objects. Raises ValueError
    on malformed rules — a silently ignored drill spec would make a chaos
    test pass by testing nothing."""
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (4, 5):
            raise ValueError(
                f"malformed chaos rule {part!r}: expected "
                f"service:message:fault:prob[:count]")
        service, message, fault = fields[0], fields[1], fields[2]
        prob = float(fields[3])
        count = int(fields[4]) if len(fields) == 5 else None
        rules.append(ChaosRule(service, message, fault, prob, count,
                               seed, part))
    return rules


class ChaosInjector:
    """The per-service decision point, attached to a BasicService.

    Thread-safety: BasicService handlers run on many threads, but rule
    state (RNG stream, injection count) is tiny and a torn update merely
    perturbs WHICH message gets the fault, never whether the stream is
    deterministic per-process under a single-connection drill — the
    configuration every test here uses. Multi-connection drills get
    best-effort probabilistic behavior, which is all chaos needs.
    """

    def __init__(self, service_name, rules, delay_ms):
        self._service_name = service_name
        self.delay_s = max(0.0, delay_ms) / 1000.0
        self._rules = [r for r in rules
                       if fnmatch.fnmatch(service_name, r.service)]
        if self._rules:
            log.warning(
                "CHAOS ACTIVE on service %r: %s", service_name,
                "; ".join(r.text for r in self._rules))

    def __bool__(self):
        return bool(self._rules)

    def decide(self, point, msg_type_name):
        """First matching rule that fires for this message, or None.

        point: "request" (before the handler, msg_type_name is the
        request class) or "response" (after, the response class).
        """
        wanted = _REQUEST_FAULTS if point == "request" else _RESPONSE_FAULTS
        for rule in self._rules:
            if rule.fault not in wanted:
                continue
            if not fnmatch.fnmatch(msg_type_name, rule.message):
                continue
            if rule.fire():
                reg = hvd_metrics.get_registry()
                reg.counter(
                    "hvd_chaos_injections_total",
                    "Chaos faults injected into the control-plane "
                    "transport, by fault kind.",
                    labels=("fault",)).labels(fault=rule.fault).inc()
                reg.event("chaos_injection", fault=rule.fault,
                          service=self._service_name,
                          message=msg_type_name, rule=rule.text,
                          count=rule.injected)
                # flight-recorder breadcrumb: the postmortem lines these
                # up against the negotiation history to call out a drill
                # (or a real network fault pattern) as the proximate cause
                hvd_tracing.get_tracer().record_cycle(
                    kind="chaos_injection", fault=rule.fault,
                    service=self._service_name, message=msg_type_name,
                    count=rule.injected)
                log.warning("CHAOS: injecting %s on %s/%s (rule %r, #%d)",
                            rule.fault, self._service_name, msg_type_name,
                            rule.text, rule.injected)
                return rule.fault
        return None

    def stats(self):
        """{rule text: injections so far} — drill assertions read this."""
        return {r.text: r.injected for r in self._rules}


def from_env(service_name):
    """The injector for ``service_name`` per ``HVD_CHAOS_*`` env (also
    HOROVOD_-prefixed), or None when no rule targets it. Called once per
    service construction, so a drill sets the env before the service
    starts and every process of a multi-process job inherits it."""
    spec = env_str("CHAOS_SPEC", "") or ""
    if not spec.strip():
        return None
    injector = ChaosInjector(
        service_name,
        parse_spec(spec, env_int("CHAOS_SEED", 0)),
        env_float("CHAOS_DELAY_MS", 50.0))
    return injector if injector else None
